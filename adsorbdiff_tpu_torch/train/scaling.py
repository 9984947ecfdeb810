"""ScaleFactor checks: port of :func:`adsorbdiff_tpu.train.scaling.ensure_fitted`.

Fitting the factors from data (``fit_scale_factors``) and reading reference
scale files (``load_scales_compat``, ``model.scale_file``) come with S2EF
training.
"""
from __future__ import annotations

import logging
from typing import Iterable, Mapping, Optional, Union

import torch


def ensure_fitted(scale_factors: Union[Mapping[str, torch.Tensor], Iterable[torch.Tensor]], warn: bool = False,
                  fitted: Optional[bool] = None) -> bool:
    """The reference's contract (``modules/scaling/util.py``): warn (``warn``)
    or raise ``ValueError`` when scale factors are not fitted; the trainers
    warn before training and raise before ``run_relaxations``.

    ``fitted`` is the trainer's explicit state: True once a checkpoint with
    scale factors was loaded, False for a fresh init.  With ``None`` every
    factor still at its init value 1.0 counts as unfitted (which can take a
    fitted factor of exactly 1.0 for an unfitted one).  A model without
    scale factors is always fitted.  Returns whether all are fitted.
    """
    leaves = list(scale_factors.values() if isinstance(scale_factors, Mapping) else scale_factors)
    if fitted is True or not leaves:
        return True
    if fitted is False:
        unfitted = leaves
    else:
        unfitted = [x for x in leaves if torch.allclose(x.detach().float().cpu(), torch.ones(()))]
    if unfitted:
        msg = (
            f"{len(unfitted)} scale factors are not fitted. Please load a checkpoint with fitted scale factors "
            "(scale files and fitting are not ported yet)."
        )
        if warn:
            logging.warning(msg)
        else:
            raise ValueError(msg)
    return not unfitted
