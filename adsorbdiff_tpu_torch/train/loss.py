"""Losses: the denoising score-matching loss and the masked S2EF losses.

Port of :mod:`adsorbdiff_tpu.train.loss`.  The denoising loss propagates a
NaN from the model, so that the trainer's non-finite guard can skip the
update; the S2EF losses zero non-finite predictions first.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from adsorbdiff_tpu_torch.data.schema import AtomsBatch
from adsorbdiff_tpu_torch.diffusion.schedules import NoiseTargets
from adsorbdiff_tpu_torch.ops import igso3
from adsorbdiff_tpu_torch.ops.segment import masked_mean


def denoising_loss(
    out_positions: torch.Tensor,  # [B, N, 3] translation-score head
    out_positions_free: Optional[torch.Tensor],  # [B, N, 3] rotation-score head (so3)
    batch: AtomsBatch,
    targets: NoiseTargets,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Translation head: the adsorbate mean / sigma_tr, z zeroed, squared
    error against tr_score weighted by sigma_tr^2.  Rotation head: the same
    mean / sigma_rot, squared error against rot_score over the IGSO(3)
    expected score norm.  Returns ``(loss, {"loss_tr", "loss_rot", "loss"})``."""
    pred_tr = masked_mean(out_positions, batch.ads_mask, dim=1) / targets.tr_sigma[:, None]
    pred_tr = torch.cat([pred_tr[:, :2], torch.zeros_like(pred_tr[:, 2:])], dim=1)
    loss_tr = torch.mean((pred_tr - targets.tr_score) ** 2 * targets.tr_sigma[:, None] ** 2)
    aux = {"loss_tr": loss_tr}
    loss = loss_tr
    if out_positions_free is not None:
        pred_rot = masked_mean(out_positions_free, batch.ads_mask, dim=1) / targets.rot_sigma[:, None]
        norm = igso3.score_norm(targets.rot_sigma)[:, None]
        loss_rot = torch.mean(((pred_rot - targets.rot_score) / norm) ** 2)
        aux["loss_rot"] = loss_rot
        loss = loss + loss_rot
    aux["loss"] = loss
    return loss, aux


def _masked_sum_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask
    while m.dim() < err.dim():
        m = m[..., None]
    m = m.expand_as(err)
    return torch.where(m, err, torch.zeros_like(err)).sum() / torch.clamp(m.sum(), min=1)


def l2mae(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the masked rows of the L2 norm of the row error."""
    return _masked_sum_mean(torch.linalg.norm(torch.nan_to_num(pred) - target, dim=-1), mask)


def mae(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _masked_sum_mean(torch.abs(torch.nan_to_num(pred) - target), mask)


def mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _masked_sum_mean((torch.nan_to_num(pred) - target) ** 2, mask)


def atomwise_l2(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, natoms: torch.Tensor) -> torch.Tensor:
    """natoms-weighted row L2 loss."""
    err = torch.linalg.norm(torch.nan_to_num(pred) - target, dim=-1)  # [B, N]
    w = torch.sqrt(natoms.to(err.dtype))[:, None]
    return torch.where(mask, w * err, torch.zeros_like(err)).sum() / torch.clamp(mask.sum(), min=1)
