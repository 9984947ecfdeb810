"""ScaleFactors: the fitted check, fitting from data, and reference scale files.

Port of :mod:`adsorbdiff_tpu.train.scaling`.  The port's ScaleFactors are
buffers named ``<module path>.scale_factor`` (:class:`ScaleFactor`, the
reference's names), so a reference scale file's keys name them directly.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
from typing import Dict, Iterable, Mapping, Optional, Union

import numpy as np
import torch


def ensure_fitted(scale_factors: Union[Mapping[str, torch.Tensor], Iterable[torch.Tensor]], warn: bool = False,
                  fitted: Optional[bool] = None) -> bool:
    """The reference's contract (``modules/scaling/util.py``): warn (``warn``)
    or raise ``ValueError`` when scale factors are not fitted; the trainers
    warn before training and raise before ``run_relaxations``.

    ``fitted`` is the trainer's explicit state: True once a checkpoint with
    scale factors or a ``model.scale_file`` was loaded, False for a fresh
    init.  With ``None`` every factor still at its init value 1.0 counts as
    unfitted (which can take a fitted factor of exactly 1.0 for an unfitted
    one).  A model without scale factors is always fitted.  Returns whether
    all are fitted.
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
            f"{len(unfitted)} scale factors are not fitted. Please make sure that you either (1) load a checkpoint "
            "with fitted scale factors, (2) explicitly load scale factors using the model.scale_file attribute, or "
            "(3) fit them with adsorbdiff_tpu_torch.train.scaling.fit_scale_factors."
        )
        if warn:
            logging.warning(msg)
        else:
            raise ValueError(msg)
    return not unfitted


def _leaves(out) -> list:
    """A model output's tensors in ``jax.tree.leaves`` order (dicts by sorted
    key, sequences in order)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, Mapping):
        return [x for k in sorted(out) for x in _leaves(out[k])]
    return [x for v in out for x in _leaves(v)]


@torch.no_grad()
def fit_scale_factors(model: torch.nn.Module, batches: Iterable, num_batches: int = 16) -> Dict[str, torch.Tensor]:
    """Fit every ScaleFactor buffer of ``model`` so that its output RMS
    comes near 1, in place, and return them by name.

    The JAX package's fixed point: at most 4 passes over the first
    ``num_batches`` batches, each measuring the mean over batches of the
    mean over output tensors of ``sqrt(mean(x**2) + 1e-12)`` and multiplying
    every factor by ``clip(1 / rms, 0.25, 4) ** (1 / factors)``; the passes
    stop once a measured RMS is within 0.05 of 1 (that pass's correction
    still applied).
    """
    factors = {n: b for n, b in model.named_buffers() if n.endswith("scale_factor")}
    if not factors:
        return {}
    batches = list(itertools.islice(batches, num_batches))
    if not batches:
        raise ValueError("need at least one batch to fit scale factors")

    def output_rms(batch) -> float:
        leaves = _leaves(model(batch))
        return float(torch.mean(torch.stack([torch.sqrt(torch.mean(x ** 2) + 1e-12) for x in leaves])))

    for _ in range(4):
        rms = float(np.mean([output_rms(b) for b in batches]))
        if not np.isfinite(rms) or rms == 0:
            raise RuntimeError(f"non-finite activation RMS during scale fitting: {rms}")
        corr = np.float32(np.clip(1.0 / rms, 0.25, 4.0) ** (1.0 / len(factors)))  # JAX multiplies in f32
        for b in factors.values():
            b.mul_(torch.tensor(corr, dtype=b.dtype, device=b.device))
        if abs(rms - 1.0) < 0.05:
            break
    logging.info(f"fitted {len(factors)} scale factors (final output RMS {rms:.3f})")
    return dict(factors)


def load_scale_file(path: str) -> Dict[str, float]:
    """A reference scale file as ``{name: float}``: ``.pt`` through
    ``torch.load``, ``.json`` (its ``comment`` entry dropped), or ``.npz``."""
    ext = os.path.splitext(path)[1]
    if ext == ".pt":
        raw = torch.load(path, map_location="cpu", weights_only=False)
    elif ext == ".json":
        with open(path) as f:
            raw = json.load(f)
        raw.pop("comment", None)
    elif ext == ".npz":
        with np.load(path) as data:
            raw = {k: data[k] for k in data.files}
    else:
        raise ValueError(f"unsupported scale file '{path}' (use .pt/.json/.npz)")
    return {k: float(v.item() if hasattr(v, "item") else v) for k, v in raw.items()}


def load_scales_compat(scale_factors: Mapping[str, torch.Tensor], scale_file: Optional[str]) -> Dict[str, torch.Tensor]:
    """``scale_factors`` (buffer name -> tensor) with the values of
    ``scale_file`` where a key matches, as new f32 tensors on each buffer's
    device; the others as given (the reference's ``scaling/compat.py``).

    A file key matches a buffer ``<path>.scale_factor`` where it is the
    path or the buffer name, or one ends with the other (the JAX package's
    suffix rule; the first matching key in file order wins).  The reference
    GemNet-OC and PaiNN names are the port's own, so no table translates
    them.  Keys matched to no buffer are warned about.
    """
    if not scale_file:
        return dict(scale_factors)
    loaded = load_scale_file(scale_file)
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for key, val in scale_factors.items():
        base = key[: -len(".scale_factor")] if key.endswith(".scale_factor") else key
        match = next((k for k in loaded
                      if k in (base, key) or base.endswith(k) or k.endswith(base) or key.endswith(k)), None)
        if match is None:
            out[key] = val
            continue
        out[key] = torch.tensor(loaded[match], dtype=torch.float32, device=val.device)
        used.add(match)
    unused = set(loaded) - used
    if unused:
        logging.warning(f"scale file entries not matched to any ScaleFactor: {sorted(unused)}")
    return out
