"""Masked reductions for fixed-shape padded batches.

Port of :mod:`adsorbdiff_tpu.ops.segment`: in the dense ``[B, N]`` layout
"scatter over batch" is a masked reduction over the atom axis.
"""
from __future__ import annotations

import torch


def _expand_mask(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    while mask.dim() < ndim:
        mask = mask[..., None]
    return mask


def masked_mean(
    x: torch.Tensor, mask: torch.Tensor, dim: int, keepdim: bool = False, eps: float = 1e-12
) -> torch.Tensor:
    """Mean of ``x`` over ``dim`` counting only ``mask`` entries.

    ``mask`` is broadcast against ``x`` (trailing feature dims allowed).
    """
    m = _expand_mask(mask.to(x.dtype), x.dim())
    total = torch.sum(x * m, dim=dim, keepdim=keepdim)
    count = torch.sum(m, dim=dim, keepdim=keepdim)
    return total / torch.clamp(count, min=eps)


def masked_max(
    x: torch.Tensor, mask: torch.Tensor, dim: int, initial: float = 0.0, keepdim: bool = False
) -> torch.Tensor:
    m = _expand_mask(mask, x.dim())
    return torch.amax(torch.where(m, x, torch.full_like(x, initial)), dim=dim, keepdim=keepdim)
