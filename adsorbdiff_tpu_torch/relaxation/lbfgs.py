"""Batched L-BFGS relaxation, the MLFF relaxer.

Port of :mod:`adsorbdiff_tpu.relaxation.lbfgs`.  The history is a fixed
``[memory, D]`` ring buffer over the flattened batch (D = B*N*3); converged
systems are frozen by per-system masks; every step moves each system by at
most ``maxstep`` per atom; fixed-atom forces are zeroed by the calculator
(:func:`make_mlff_energy_forces`).  The JAX ``lax.scan`` / ``while_loop``
becomes a Python loop with the same arithmetic:

- the two-loop recursion walks only the ``n_hist = min(it, memory)`` valid
  slots (a host integer), which is what the masked JAX loop computes: its
  invalid slots add exact zeros;
- masks select with ``torch.where`` as JAX does with ``jnp.where``, never by
  multiplying: ``rho = 1 / <y, s>`` can be ``inf`` on a step that is not
  pushed, and ``0 * inf`` is NaN;
- the loop reads the device once per step: one ``.tolist()`` of the
  all-converged flag and the Verlet rebuild test (``4 * disp >= margin``
  for the next step's positions).  That read is the loop's only host
  synchronisation.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from adsorbdiff_tpu_torch.data.schema import AtomsBatch
from adsorbdiff_tpu_torch.ops.pbc import CandidateTable
from adsorbdiff_tpu_torch.ops.segment import masked_max

EnergyForcesFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]
# fn(batch[, static_graph]) -> (energy [B], forces [B, N, 3]) with fixed-atom
# forces zeroed


class LBFGSResult(NamedTuple):
    batch: AtomsBatch  # final positions
    energy: torch.Tensor  # [B] final energy
    forces: torch.Tensor  # [B, N, 3] final forces (no constraint applied)
    traj_pos: torch.Tensor  # [T+1, B, N, 3] (last frame = final relaxed state)
    traj_energy: torch.Tensor  # [T+1, B]
    traj_forces: torch.Tensor  # [T+1, B, N, 3]
    nsteps: int  # steps before batch-wide convergence (the freeze point)
    converged: torch.Tensor  # [B] bool, per-system fmax reached
    rebuilds: int = 0  # Verlet candidate-table rebuilds after the first build


def _tables(cand) -> list:
    if isinstance(cand, CandidateTable):
        return [cand]
    if isinstance(cand, dict):
        return [t for v in cand.values() for t in _tables(v)]
    return []


def need_rebuild(pos: torch.Tensor, atom_mask: torch.Tensor, cand) -> torch.Tensor:
    """Device bool: whether any Verlet candidate table in ``cand`` has spent
    its displacement margin (``4 * max displacement >= margin`` in some
    system) at positions ``pos``."""
    need = torch.zeros((), dtype=torch.bool, device=pos.device)
    for t in _tables(cand):
        d2 = torch.sum((pos - t.pos0) ** 2, dim=-1)  # [B, N]
        disp = torch.sqrt(masked_max(d2, atom_mask, dim=1))  # [B]
        need = need | torch.any(4.0 * disp >= t.margin)
    return need


def lbfgs_relax(
    energy_forces_fn: EnergyForcesFn,
    batch: AtomsBatch,
    *,
    steps: int = 300,
    fmax: float = 0.01,
    maxstep: float = 0.04,
    memory: int = 50,
    damping: float = 1.0,
    alpha: float = 70.0,
    early_exit: bool = True,
    candidate_fn: Optional[Callable[[AtomsBatch], object]] = None,
) -> LBFGSResult:
    """Batched L-BFGS with the published relaxation defaults.

    ``early_exit`` stops calling the model once every system has converged;
    the frames from then on repeat the frozen state, with energy and forces
    from a full graph build, which is what the full loop would emit.  It is
    off for ``fmax <= 0`` (a fixed budget).  ``candidate_fn(batch)`` builds
    Verlet candidate tables (a :class:`CandidateTable` or a dict of them),
    passed to ``energy_forces_fn`` as its second argument and rebuilt once a
    table's displacement margin is spent.
    """
    b, n, _ = batch.pos.shape
    d = b * n * 3
    dtype, device = batch.pos.dtype, batch.pos.device
    h0 = 1.0 / float(alpha)
    atom3 = batch.atom_mask[..., None]
    early = early_exit and fmax > 0.0

    def ef(pos, cand=None):
        if candidate_fn is None:
            e, f = energy_forces_fn(batch.replace(pos=pos))
        else:
            e, f = energy_forces_fn(batch.replace(pos=pos), cand)
        return e, torch.where(atom3, f, 0.0)

    pos = batch.pos
    r0 = torch.zeros(d, dtype=dtype, device=device)
    f0 = torch.zeros(d, dtype=dtype, device=device)
    s_buf = torch.zeros((memory, d), dtype=dtype, device=device)
    y_buf = torch.zeros((memory, d), dtype=dtype, device=device)
    rho_buf = torch.zeros(memory, dtype=dtype, device=device)
    frozen_at = steps
    cand = candidate_fn(batch) if candidate_fn is not None else None
    rebuilds = 0
    traj_pos = torch.empty((steps + 1, b, n, 3), dtype=dtype, device=device)
    traj_e = torch.empty((steps + 1, b), dtype=dtype, device=device)
    traj_f = torch.empty((steps + 1, b, n, 3), dtype=dtype, device=device)

    it_end = steps
    for it in range(steps):
        energy, forces = ef(pos, cand)
        traj_pos[it], traj_e[it], traj_f[it] = pos, energy, forces

        fnorm = torch.linalg.norm(forces, dim=-1)  # [B, N]
        update_sys = masked_max(fnorm, batch.atom_mask, dim=1) >= fmax  # [B], True = keep moving
        all_converged = ~torch.any(update_sys)
        active = ~all_converged if frozen_at >= steps else torch.zeros_like(all_converged)

        r = pos.reshape(d)
        f = forces.reshape(d)
        if it > 0:  # push (s, y, rho): shift left, newest at slot memory-1
            s0 = r - r0
            y0 = -(f - f0)
            rho0 = 1.0 / torch.dot(y0, s0)
            s_buf = torch.where(active, torch.cat([s_buf[1:], s0[None]]), s_buf)
            y_buf = torch.where(active, torch.cat([y_buf[1:], y0[None]]), y_buf)
            rho_buf = torch.where(active, torch.cat([rho_buf[1:], rho0[None]]), rho_buf)
        n_hist = min(it, memory)

        # two-loop recursion over the n_hist newest slots
        q = -f
        alpha_vec = [None] * memory
        for j in range(n_hist):
            slot = memory - 1 - j  # newest -> oldest
            a_i = rho_buf[slot] * torch.dot(s_buf[slot], q)
            q = q - a_i * y_buf[slot]
            alpha_vec[slot] = a_i
        z = h0 * q
        for slot in range(memory - n_hist, memory):  # oldest -> newest
            beta = rho_buf[slot] * torch.dot(y_buf[slot], z)
            z = z + s_buf[slot] * (alpha_vec[slot] - beta)
        p = (-z).reshape(b, n, 3)

        # per-system maxstep clamp
        longest = masked_max(torch.linalg.norm(p, dim=-1), batch.atom_mask, dim=1)  # [B]
        scale = torch.clamp(longest, max=maxstep) / (longest + 1e-7)
        dr = p * scale[:, None, None] * damping

        # frozen systems, and the whole batch once converged, stay put; a step
        # below 1e-7 anywhere in the batch moves nothing and keeps r0/f0
        move = update_sys[:, None, None] & atom3 & active
        tiny = torch.amax(torch.abs(dr)) < 1e-7
        pos = torch.where(move & ~tiny, pos + dr, pos)
        keep = active & ~tiny
        r0 = torch.where(keep, r, r0)
        f0 = torch.where(keep, f, f0)

        # the step's one host read: convergence, and whether the candidate
        # tables must be rebuilt for the next positions
        converged_now, rebuild = torch.stack([all_converged, need_rebuild(pos, batch.atom_mask, cand)]).tolist()
        if converged_now and frozen_at >= steps:
            frozen_at = it
        if early and frozen_at < steps:
            it_end = it + 1
            break
        if rebuild and it + 1 < steps:
            cand = candidate_fn(batch.replace(pos=pos))
            rebuilds += 1

    if it_end < steps:
        # frames at and after the exit repeat the frozen state; energy and
        # forces from a full build, exact whatever the candidate margin
        e_fill, f_fill = ef(pos, None)
        traj_pos[it_end:steps] = pos
        traj_e[it_end:steps] = e_fill
        traj_f[it_end:steps] = f_fill

    final_e, final_f = energy_forces_fn(batch.replace(pos=pos))  # full build; no constraint applied
    fnorm = torch.linalg.norm(torch.where(atom3, final_f, 0.0), dim=-1)
    converged = masked_max(fnorm, batch.atom_mask, dim=1) < fmax
    traj_pos[steps], traj_e[steps], traj_f[steps] = pos, final_e, final_f
    return LBFGSResult(
        batch=batch.replace(pos=pos),
        energy=final_e,
        forces=final_f,
        traj_pos=traj_pos,
        traj_energy=traj_e,
        traj_forces=traj_f,
        nsteps=min(frozen_at, steps),
        converged=converged,
        rebuilds=rebuilds,
    )


def make_mlff_energy_forces(model: torch.nn.Module) -> EnergyForcesFn:
    """Wrap an s2ef model into the calculator contract: energy ``[B]``,
    forces ``[B, N, 3]`` with fixed-atom forces zeroed.  ``static_graph``
    (optional) carries Verlet candidate tables into the model's graph
    build.  Runs without autograd: the model's force head is direct."""

    def fn(batch: AtomsBatch, static_graph=None):
        with torch.no_grad():
            out = model(batch, static_graph)
        return out["energy"], torch.where(batch.fixed[..., None], 0.0, out["forces"])

    return fn


def candidate_fn_for(model: torch.nn.Module, relax_opt: Optional[dict] = None) -> Optional[Callable]:
    """The Verlet candidate-table builder that ``relax_opt`` asks of
    ``model``: ``relax_opt["verlet_graph"]`` (default True) keeps the
    neighbour tables as candidate lists (``model.prepare_candidates``)
    refreshed every step and rebuilt once the displacement margin is spent;
    ``relax_opt["k_cand"]`` (default 64) sizes the pool.  ``None`` when
    switched off or when the model builds no candidates."""
    opt = relax_opt or {}
    if not bool(opt.get("verlet_graph", True)) or not hasattr(model, "prepare_candidates"):
        return None
    k_cand = int(opt.get("k_cand", 64))
    return lambda batch: model.prepare_candidates(batch, k_cand)
