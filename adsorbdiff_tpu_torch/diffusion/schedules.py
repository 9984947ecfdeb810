"""Noise-schedule helpers that sampling needs.

Port of part of :mod:`adsorbdiff_tpu.diffusion.schedules`; the training-time
forward noising (``tr_so3_schedule``, which needs ``ops/igso3.py``) comes with
training.
"""
from __future__ import annotations

import torch

from adsorbdiff_tpu_torch.data.schema import AtomsBatch
from adsorbdiff_tpu_torch.ops.segment import masked_mean


def geometric_sigma(t: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """sigma(t) = lo^(1-t) * hi^t."""
    return lo ** (1.0 - t) * hi**t


def ads_center(batch: AtomsBatch) -> torch.Tensor:
    """[B, 3] adsorbate centre of mass (tag-2 masked mean)."""
    return masked_mean(batch.pos, batch.ads_mask, dim=1)
