"""Reverse-diffusion sampler (ODE and SDE), as a Python loop over steps.

Port of :mod:`adsorbdiff_tpu.diffusion.sampler` (``reverse_diffusion``,
``init_placement``); ``langevin_dynamics`` comes later.  The JAX version is
one ``lax.scan``; here each step is eager PyTorch, and the convergence freeze
stays in tensors, so the loop never waits on the device.  The random numbers
can be passed in (``frac``, ``noise``, ``rot_noise``), which is how the tests
feed both frameworks the same draws; otherwise they come from ``generator``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from adsorbdiff_tpu_torch.data.schema import AtomsBatch
from adsorbdiff_tpu_torch.diffusion.schedules import ads_center, draw
from adsorbdiff_tpu_torch.ops.pbc import wrap_positions
from adsorbdiff_tpu_torch.ops.rotation import axis_angle_to_matrix
from adsorbdiff_tpu_torch.ops.segment import masked_mean

ScoreFn = Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor]]]
# score_fn(batch[, static]) -> (tr_score [B,N,3], rot_score [B,N,3] | None)


class SampleResult(NamedTuple):
    batch: AtomsBatch  # final state
    traj_pos: torch.Tensor  # [T+1, B, N, 3] positions (frame 0 = initialised state)
    converged_at: torch.Tensor  # [] int32 step where updates froze (T if never)


def init_placement(
    batch: AtomsBatch, frac: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None
) -> AtomsBatch:
    """Random uniform fractional xy COM placement over the row lattice,
    keeping each system's initial COM z.  ``frac [B, 3]`` in [0, 1) replaces
    the draw."""
    if frac is None:
        frac = draw((batch.batch_size, 3), "uniform", generator, batch.device)
    com_noise = (frac.to(batch.pos)[:, None, :] @ batch.cell)[:, 0]  # row lattice
    com0 = ads_center(batch)
    com_noise = torch.cat([com_noise[:, :2], com0[:, 2:]], dim=1)
    new_pos = batch.pos - com0[:, None, :] + com_noise[:, None, :]
    return batch.replace(pos=torch.where(batch.ads_mask[..., None], new_pos, batch.pos))


def _schedule_consts(params: dict):
    lo, hi = float(params["ads_std_low"]), float(params["ads_std_high"])
    rlo, rhi = float(params.get("rot_std_low", 0.01)), float(params.get("rot_std_high", 1.55))
    return lo, hi, rlo, rhi, int(params["num_steps"])


def _f32_sqrt(x: float) -> float:
    """sqrt taken in float32, as ``jnp.sqrt`` of a Python float is."""
    return float(np.sqrt(np.float32(x)))


def reverse_diffusion(
    score_fn: ScoreFn,
    batch: AtomsBatch,
    params: dict,
    *,
    generator: Optional[torch.Generator] = None,
    with_rotation: bool = True,
    static_fn: Optional[Callable[[AtomsBatch], object]] = None,
    frac: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    rot_noise: Optional[torch.Tensor] = None,
) -> SampleResult:
    """reverse_sde_sampling_rot (``params["ode"]``, default True) over
    ``params["num_steps"]`` steps.

    ``static_fn``: optional ``batch -> static`` precomputation run once after
    the initial placement; ``score_fn`` is then called as
    ``score_fn(batch, static)``.  ``noise``/``rot_noise`` ``[T, B, 3]``: the
    SDE's translation and rotation normals per step.
    """
    lo, hi, rlo, rhi, num_steps = _schedule_consts(params)
    ode = bool(params.get("ode", True))
    device = batch.device
    batch = init_placement(batch, frac=frac, generator=generator)
    if static_fn is not None:
        static = static_fn(batch)
        base_score_fn = score_fn
        score_fn = lambda cur: base_score_fn(cur, static)  # noqa: E731
    if not ode:
        shape = (num_steps, batch.batch_size, 3)
        noise = draw(shape, "normal", generator, device) if noise is None else noise.to(batch.pos)
        rot_noise = draw(shape, "normal", generator, device) if rot_noise is None else rot_noise.to(batch.pos)

    # schedule built in float64 and rounded to float32, as the JAX sampler does
    s = np.linspace(1.0, 0.0, num_steps + 1)[:-1]
    dt_arr = np.empty(num_steps, np.float32)
    dt_arr[:-1] = s[:-1] - s[1:]
    dt_arr[-1] = s[-1]
    s = torch.as_tensor(s.astype(np.float32), device=device)
    dt_arr = torch.as_tensor(dt_arr, device=device)

    sqrt_log_tr = _f32_sqrt(2.0 * math.log(hi / lo))
    sqrt_log_rot = _f32_sqrt(math.log(rhi / rlo) if rhi > rlo else 0.0)
    ads = batch.ads_mask
    ads3 = ads[..., None]

    pos = batch.pos
    cvg_count = torch.zeros((), dtype=torch.int32, device=device)
    frozen_at = torch.full((), num_steps, dtype=torch.int32, device=device)
    traj = [pos]
    for it in range(num_steps):
        t_s, dt = s[it], dt_arr[it]
        cur = batch.replace(pos=pos)
        tr_g = (lo ** (1 - t_s) * hi**t_s) * sqrt_log_tr
        rot_g = 2.0 * (rlo ** (1 - t_s) * rhi**t_s) * sqrt_log_rot

        noise_pred, rot_pred = score_fn(cur)
        noise_pred = masked_mean(noise_pred, ads, dim=1)  # [B, 3]
        if ode:
            dx = 0.5 * tr_g**2 * dt * noise_pred
        else:
            dx = tr_g**2 * dt * noise_pred + tr_g * torch.sqrt(dt) * noise[it]

        # xy only + COM wrap into the home cell
        com = masked_mean(pos, ads, dim=1)
        dx = torch.cat([dx[:, :-1], torch.zeros_like(dx[:, -1:])], dim=1)
        dx = wrap_positions(com + dx, batch.cell) - com

        # convergence freeze: 10 steps with |dx| <= 1e-3 everywhere
        cvg_count = cvg_count + torch.all(torch.abs(dx) <= 1.0e-3).to(torch.int32)
        frozen = cvg_count >= 10
        frozen_at = torch.where(frozen & (frozen_at == num_steps), torch.full_like(frozen_at, it), frozen_at)
        scale = (~frozen).to(dx.dtype)
        dx = dx * scale

        if with_rotation:
            rot_mean = masked_mean(rot_pred, ads, dim=1)
            if ode:
                rot_vec = 0.5 * rot_mean * dt * rot_g**2
            else:
                rot_vec = rot_mean * dt * rot_g**2 + rot_g * torch.sqrt(dt) * rot_noise[it]
            rot_mat = axis_angle_to_matrix(rot_vec * scale)  # [B, 3, 3]
            rel = pos - com[:, None, :]
            new_ads = torch.einsum("bnd,bed->bne", rel, rot_mat) + com[:, None, :] + dx[:, None, :]
        else:
            new_ads = pos + dx[:, None, :]
        pos = torch.where(ads3, new_ads, pos)
        traj.append(pos)

    return SampleResult(batch=batch.replace(pos=pos), traj_pos=torch.stack(traj), converged_at=frozen_at)
