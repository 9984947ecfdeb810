"""Noise schedules: the training-time forward diffusion, batched.

Port of :mod:`adsorbdiff_tpu.diffusion.schedules`:
- per-system t ~ U(0, 1); geometric sigma lo^(1-t) * hi^t;
- adsorbate centre from a tag-2 masked mean;
- translation noise N(0, sigma^2) in 3D, PBC-wrapped by the centred
  fractional double-mod, then z zeroed;
- a rigid IGSO(3) rotation of the adsorbate about its centre, then a +1 A
  z-lift;
- targets: tr_score = -noise / sigma_tr^2, rot_score from the IGSO(3) score
  table at the sampled rotation.

Each schedule takes its random numbers as :class:`ScheduleDraws` or draws
them from a ``torch.Generator``.  The JAX functions take a key and split it
(``k_t, k_tr, k_rot``; ``k_rot`` into the direction and the angle); the tests
hand both the same draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from adsorbdiff_tpu_torch.data.schema import AtomsBatch
from adsorbdiff_tpu_torch.ops import igso3
from adsorbdiff_tpu_torch.ops.pbc import frac_wrap_center, wrap_positions
from adsorbdiff_tpu_torch.ops.rotation import axis_angle_to_matrix
from adsorbdiff_tpu_torch.ops.segment import masked_mean


@dataclasses.dataclass(frozen=True)
class NoiseTargets:
    """Per-system diffusion targets attached to a noised batch."""

    tr_sigma: torch.Tensor  # [B]
    rot_sigma: torch.Tensor  # [B]
    tr_score: torch.Tensor  # [B, 3]
    rot_score: torch.Tensor  # [B, 3]
    noise_vec: torch.Tensor  # [B, 3] (the wrapped translation noise actually applied)


class ScheduleDraws(NamedTuple):
    """The random numbers of one schedule call."""

    t: torch.Tensor  # [B] uniform in [0, 1)
    tr_normal: torch.Tensor  # [B, 3] standard normal (translation)
    rot_normal: Optional[torch.Tensor] = None  # [B, 3] standard normal (IGSO(3) axis); so3 only
    rot_uniform: Optional[torch.Tensor] = None  # [B] uniform (IGSO(3) inverse CDF); so3 only


def draw(shape, kind: str, generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
    """Uniform or normal draws from ``generator`` (on its own device), moved to ``device``."""
    gen_device = generator.device if generator is not None else device
    fn = torch.rand if kind == "uniform" else torch.randn
    return fn(shape, generator=generator, device=gen_device).to(device)


def draw_schedule(
    batch_size: int, device: torch.device, generator: Optional[torch.Generator] = None, so3: bool = True
) -> ScheduleDraws:
    """Fresh draws for one schedule call, in the order of the JAX key split."""
    t = draw((batch_size,), "uniform", generator, device)
    tr_normal = draw((batch_size, 3), "normal", generator, device)
    if not so3:
        return ScheduleDraws(t, tr_normal)
    return ScheduleDraws(t, tr_normal, draw((batch_size, 3), "normal", generator, device),
                         draw((batch_size,), "uniform", generator, device))


def geometric_sigma(t: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """sigma(t) = lo^(1-t) * hi^t."""
    return lo ** (1.0 - t) * hi**t


def ads_center(batch: AtomsBatch) -> torch.Tensor:
    """[B, 3] adsorbate centre of mass (tag-2 masked mean)."""
    return masked_mean(batch.pos, batch.ads_mask, dim=1)


def _zero_z(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v[:, :2], torch.zeros_like(v[:, 2:])], dim=1)


def tr_so3_schedule(
    batch: AtomsBatch,
    params: dict,
    generator: Optional[torch.Generator] = None,
    *,
    draws: Optional[ScheduleDraws] = None,
) -> Tuple[AtomsBatch, NoiseTargets]:
    """Translation (2D torus) + rotation (SO(3)) forward noising.

    ``params``: ads_std_low/high, rot_std_low/high
    (``configs/denoising/base.yml``, ``denoising_pos_params``).
    """
    if draws is None:
        draws = draw_schedule(batch.batch_size, batch.device, generator, so3=True)
    t = draws.t
    tr_sigma = geometric_sigma(t, float(params["ads_std_low"]), float(params["ads_std_high"]))
    rot_sigma = geometric_sigma(t, float(params["rot_std_low"]), float(params["rot_std_high"]))

    center = ads_center(batch)  # [B, 3]
    noise = frac_wrap_center(draws.tr_normal * tr_sigma[:, None], batch.cell)  # wrap before zeroing z
    noise = _zero_z(noise)

    rot_update = igso3.sample_vec(rot_sigma, normals=draws.rot_normal, uniforms=draws.rot_uniform)
    rot_score = igso3.score_vec(rot_sigma, rot_update)
    rot_mat = axis_angle_to_matrix(rot_update)  # [B, 3, 3]

    rel = batch.pos - center[:, None, :]
    rotated = torch.einsum("bnd,bed->bne", rel, rot_mat)  # rel @ R^T per system
    new_ads = rotated + center[:, None, :] + noise[:, None, :]
    new_ads = new_ads + torch.tensor([0.0, 0.0, 1.0], dtype=new_ads.dtype, device=new_ads.device)  # +1 A z-lift

    noised = batch.replace(pos=torch.where(batch.ads_mask[..., None], new_ads, batch.pos))
    targets = NoiseTargets(
        tr_sigma=tr_sigma,
        rot_sigma=rot_sigma,
        tr_score=-noise / tr_sigma[:, None] ** 2,
        rot_score=rot_score,
        noise_vec=noise,
    )
    return noised, targets


def ads_com_gaussian_schedule(
    batch: AtomsBatch,
    params: dict,
    generator: Optional[torch.Generator] = None,
    *,
    draws: Optional[ScheduleDraws] = None,
) -> Tuple[AtomsBatch, NoiseTargets]:
    """Translation-only schedule that collapses the adsorbate to its centre.

    As the JAX function: the noise is not PBC-wrapped before the score
    target is built; the noised centre is wrapped into the home cell (row
    lattice); every adsorbate atom is placed at the centre.
    """
    if draws is None:
        draws = draw_schedule(batch.batch_size, batch.device, generator, so3=False)
    tr_sigma = geometric_sigma(draws.t, float(params["ads_std_low"]), float(params["ads_std_high"]))

    noise = _zero_z(draws.tr_normal * tr_sigma[:, None])
    new_center = wrap_positions(ads_center(batch) + noise, batch.cell)
    new_center = new_center + torch.tensor([0.0, 0.0, 1.0], dtype=new_center.dtype, device=new_center.device)

    noised = batch.replace(pos=torch.where(batch.ads_mask[..., None], new_center[:, None, :], batch.pos))
    targets = NoiseTargets(
        tr_sigma=tr_sigma,
        rot_sigma=torch.ones_like(tr_sigma),
        tr_score=-noise / tr_sigma[:, None] ** 2,
        rot_score=torch.zeros((batch.batch_size, 3), dtype=batch.pos.dtype, device=batch.device),
        noise_vec=noise,
    )
    return noised, targets
