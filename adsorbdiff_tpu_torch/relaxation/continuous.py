"""Continuous-batching MLFF relaxation: retire converged systems, refill slots.

Port of :mod:`adsorbdiff_tpu.relaxation.continuous` for one device (the
mesh arguments are gone; several cards come with ``torch.distributed``).
:func:`~adsorbdiff_tpu_torch.relaxation.lbfgs.lbfgs_relax` runs a batch
until its slowest system converges; this engine runs L-BFGS in chunks of
``chunk_steps`` steps over ``slots`` systems, and at every chunk boundary the
converged or budget-exhausted systems retire (their trajectories drain
through the background writer) and pending systems take their slots.

Semantics: **per-system L-BFGS**.  Each slot has its own history ring
(``[memory, B, N*3]``, per-system ``rho``), so every system follows exactly
the trajectory it would follow alone in a batch of one, whichever systems
share the batch with it; a refilled slot starts from a clean H0.  A
trajectory holds the frames up to the converging (or last budgeted) step and
one final frame; its forces are fixed-atom-zeroed like every other frame.

The JAX ``lax.scan`` over a chunk is a Python loop with the same arithmetic.
Per-system history counts differ by slot: the two-loop walks the ring only up
to a host upper bound of the largest count (``it`` read at the last chunk
boundary, plus the steps since) and masks the rest per system to exact zeros,
which is what the JAX loop over all ``memory`` slots adds there.  Masks select
with ``torch.where``, never by multiplying (``rho`` can be ``inf``).  Host
reads of the device: one per step for the Verlet rebuild test (only with
candidate tables; JAX decides it on the device with ``lax.cond``) and one per
chunk for retirement; :attr:`ContinuousRelaxationEngine.host_reads` counts
them.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from adsorbdiff_tpu_torch.data.buckets import default_bucket_edges
from adsorbdiff_tpu_torch.data.schema import AtomsBatch, System, collate
from adsorbdiff_tpu_torch.device import DeviceLike, resolve_device
from adsorbdiff_tpu_torch.ops.segment import masked_max
from adsorbdiff_tpu_torch.relaxation.lbfgs import candidate_fn_for, make_mlff_energy_forces, need_rebuild
from adsorbdiff_tpu_torch.relaxation.ml_relaxation import _AsyncWriter
from adsorbdiff_tpu_torch.runtime.trajectory import Trajectory, check_traj_files


def resolve_continuous(relax_opt: Optional[dict], fmax: float,
                       num_relaxation_batches: Optional[int] = None) -> bool:
    """Resolve ``relax_opt["continuous"]`` (default ``"auto"``).

    ``True``/``False`` (or their YAML spellings) are explicit; ``"auto"``
    selects the continuous engine when convergence-based stopping
    (``fmax > 0``, ``relax_opt["fmax"]`` first) spreads per-system step
    counts, and keeps the batch engine for a fixed budget and when
    ``num_relaxation_batches`` caps the run (the continuous engine streams
    systems, not batches).
    """
    opt = relax_opt or {}
    choice = opt.get("continuous", "auto")
    if isinstance(choice, str) and choice != "auto":
        lowered = choice.strip().lower()
        if lowered in ("true", "on", "yes", "1"):
            return True
        if lowered in ("false", "off", "no", "0"):
            return False
        raise ValueError(f"relax_opt['continuous'] must be true/false/'auto', got {choice!r}")
    if choice != "auto":
        return bool(choice)
    if float(opt.get("fmax", fmax)) <= 0:
        return False
    if num_relaxation_batches is not None and num_relaxation_batches < int(1e9):
        logging.info("relax_opt.continuous=auto: task.num_relaxation_batches=%d caps the run; the continuous "
                     "engine streams systems, so the batch engine runs", num_relaxation_batches)
        return False
    return True


class RelaxedSystem(NamedTuple):
    """Per-system result (host)."""

    sid: int
    fid: int
    energy: float  # final (relaxed) energy
    pos: np.ndarray  # [natoms, 3] final positions
    forces: np.ndarray  # [natoms, 3] final forces (fixed-atom-zeroed)
    nsteps: int  # optimizer iterations executed
    converged: bool  # fmax reached (False = budget exhausted)


@dataclasses.dataclass
class _SlotState:
    """B slots on the device, each an independent L-BFGS instance."""

    batch: AtomsBatch  # slot systems; .pos = current positions
    r0: torch.Tensor  # [B, D] previous positions
    f0: torch.Tensor  # [B, D] previous forces
    s_buf: torch.Tensor  # [M, B, D] position-delta ring, newest at M-1
    y_buf: torch.Tensor  # [M, B, D] gradient-delta ring
    rho: torch.Tensor  # [M, B] 1 / <y, s>
    it: torch.Tensor  # [B] int32 iterations done by the occupant
    budget: torch.Tensor  # [B] int32 step budget
    done: torch.Tensor  # [B] bool converged or budget exhausted
    conv: torch.Tensor  # [B] bool converged (subset of done)
    finalized: torch.Tensor  # [B] bool final frame emitted
    it_hi: np.ndarray  # [B] host upper bound of ``it``
    cand: object = None  # Verlet candidate tables


def _two_loop_per_system(q, s_buf, y_buf, rho, n_hist, h0: float, walk: int):
    """The two-loop recursion with per-system dots over the ``walk`` newest
    slots; a slot past a system's ``n_hist`` adds exact zeros to it."""
    m = s_buf.shape[0]
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    alpha = {}
    for j in range(walk):
        slot = m - 1 - j  # newest -> oldest
        a = torch.where(j < n_hist, rho[slot] * torch.sum(s_buf[slot] * q, dim=-1), zero)
        q = q - a[:, None] * y_buf[slot]
        alpha[slot] = a
    z = h0 * q
    for slot in range(m - walk, m):  # oldest -> newest
        beta = rho[slot] * torch.sum(y_buf[slot] * z, dim=-1)
        z = z + torch.where((slot >= m - n_hist)[:, None], s_buf[slot] * (alpha[slot] - beta)[:, None], zero)
    return z


def _collect_chunk(arrays, occupied: List[int], retire: List[dict], buffers: Dict[int, list],
                   results: Dict[int, RelaxedSystem], traj_dir: Optional[str], save_full: bool) -> None:
    """Writer-thread task: copy a chunk's frames to the host, keep each
    occupied slot's emitted frames, and write the retiring systems' results
    and trajectories.  ``buffers`` and ``results`` change only on the writer
    thread (tasks run in order, so a retiring slot's frames are taken before
    the next occupant's arrive).  Without full trajectories only each
    retiree's final frame, which is always in this chunk, leaves the card."""
    dtp, dte, dtf, dem = arrays  # [R, B, N, 3], [R, B], [R, B, N, 3], [R, B]
    em = dem.cpu().numpy()
    full = traj_dir is not None and save_full
    if full:
        tp, te, tf = dtp.cpu().numpy(), dte.cpu().numpy(), dtf.cpu().numpy()
        for b in occupied:
            rows = np.nonzero(em[:, b])[0]
            if rows.size:
                buffers.setdefault(b, []).append((tp[rows, b], te[rows, b], tf[rows, b]))
    for rec in retire:
        b, sys_ = rec["slot"], rec["system"]
        n = sys_.natoms
        if full:
            chunks = buffers.pop(b, [])
            pos, e, f = (np.concatenate([c[i] for c in chunks], axis=0) for i in range(3))
        else:
            last = int(np.nonzero(em[:, b])[0][-1])
            pos, e, f = (t[last, b].cpu().numpy()[None] for t in (dtp, dte, dtf))
        results[sys_.sid] = RelaxedSystem(
            sid=sys_.sid, fid=sys_.fid, energy=float(e[-1]), pos=pos[-1, :n].copy(), forces=f[-1, :n].copy(),
            nsteps=rec["nsteps"], converged=rec["converged"],
        )
        if traj_dir is not None:
            frames = slice(None) if save_full else slice(-1, None)
            Trajectory(
                positions=pos[frames, :n], numbers=sys_.atomic_numbers, cell=sys_.cell, tags=sys_.tags,
                fixed=sys_.fixed, energy=e[frames], forces=f[frames, :n], sid=sys_.sid, fid=sys_.fid,
            ).save(os.path.join(traj_dir, str(sys_.sid)))


def _remap_buffers(buffers: Dict[int, list], mapping: Dict[int, int]) -> None:
    """Writer-thread task: renumber the slots' frame lists after a narrowing
    (old slot -> new slot)."""
    moved = {old: buffers.pop(old) for old in list(mapping) if old in buffers}
    for old, new in mapping.items():
        if old in moved:
            buffers[new] = moved[old]


class ContinuousRelaxationEngine:
    """Slot-refill batched L-BFGS over a stream of systems.

    The alternative to :class:`~adsorbdiff_tpu_torch.relaxation.ml_relaxation.
    RelaxationEngine` for relaxation sweeps (:func:`resolve_continuous`
    picks it).  ``relax_opt`` keys as the batch engine's, plus ``slots``,
    ``chunk_steps`` and ``drain_narrowing`` (once the pool is empty and at
    most half the slots are live, gather the survivors into a power-of-two
    batch).  All systems of one :meth:`run_systems` call share a pad shape;
    :meth:`run_dataset` buckets by atom count first.  ``device``: the CUDA
    card unless ``"cpu"`` is passed.
    """

    def __init__(
        self,
        energy_forces_fn: Callable,
        relax_opt: Optional[dict] = None,
        steps: int = 300,
        fmax: float = 0.01,
        candidate_fn: Optional[Callable] = None,
        slots: int = 8,
        chunk_steps: int = 32,
        device: DeviceLike = None,
    ) -> None:
        opt = dict(relax_opt or {})
        self.steps = int(opt.get("steps", steps))
        self.fmax = float(opt.get("fmax", fmax))
        self.slots = int(opt.get("slots", slots))
        self.chunk_steps = int(opt.get("chunk_steps", chunk_steps))
        self.maxstep = float(opt.get("maxstep", 0.04))
        self.memory = int(opt.get("memory", 50))
        self.damping = float(opt.get("damping", 1.0))
        self.h0 = 1.0 / float(opt.get("alpha", 70.0))
        self.drain_narrowing = bool(opt.get("drain_narrowing", False))
        self.energy_forces_fn = energy_forces_fn
        self.candidate_fn = candidate_fn
        self.device = resolve_device(device)
        self.narrow_events: list = []  # (live, new width)
        self.host_reads = 0  # device -> host reads of the control flow
        self._writer = _AsyncWriter()

    @classmethod
    def from_model(cls, model: torch.nn.Module, relax_opt: Optional[dict] = None,
                   **kw) -> "ContinuousRelaxationEngine":
        """Candidate tables as :func:`~adsorbdiff_tpu_torch.relaxation.lbfgs.
        candidate_fn_for` builds them (``verlet_graph``, ``k_cand``)."""
        return cls(make_mlff_energy_forces(model), relax_opt, candidate_fn=candidate_fn_for(model, relax_opt), **kw)

    def flush(self) -> None:
        """Join the queued trajectory writes (call before reading them)."""
        self._writer.flush()

    # ---------------------------------------------------------------- state
    def _init_state(self, batch: AtomsBatch, budgets: Sequence[int], dead: Sequence[int]) -> _SlotState:
        b, n, _ = batch.pos.shape
        d, m = n * 3, self.memory
        dt, dev = batch.pos.dtype, batch.pos.device
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        if dead:  # filler rows when there are fewer systems than slots
            done[list(dead)] = True
        return _SlotState(
            batch=batch,
            r0=torch.zeros((b, d), dtype=dt, device=dev),
            f0=torch.zeros((b, d), dtype=dt, device=dev),
            s_buf=torch.zeros((m, b, d), dtype=dt, device=dev),
            y_buf=torch.zeros((m, b, d), dtype=dt, device=dev),
            rho=torch.zeros((m, b), dtype=dt, device=dev),
            it=torch.zeros(b, dtype=torch.int32, device=dev),
            budget=torch.as_tensor(np.asarray(budgets, np.int32), device=dev),
            done=done,
            conv=torch.zeros(b, dtype=torch.bool, device=dev),
            finalized=done.clone(),
            it_hi=np.zeros(b, np.int64),
            cand=self.candidate_fn(batch) if self.candidate_fn is not None else None,
        )

    def _refill(self, st: _SlotState, slot: int, row: AtomsBatch, budget: int) -> None:
        """Put a fresh system in ``slot``, in place: its batch row, a zeroed
        history, it = 0.  The tensors changed here are the engine's own (the
        writer holds only the chunks' stacked copies)."""
        for f in dataclasses.fields(AtomsBatch):
            t = getattr(st.batch, f.name)
            if t is not None:
                t[slot] = getattr(row, f.name)[0]
        for t in (st.r0, st.f0):
            t[slot] = 0
        for t in (st.s_buf, st.y_buf, st.rho):
            t[:, slot] = 0
        st.it[slot] = 0
        st.budget[slot] = budget
        st.done[slot] = st.conv[slot] = st.finalized[slot] = False
        st.it_hi[slot] = 0

    def _gather_slots(self, st: _SlotState, idx: List[int], n_pad_rows: int) -> _SlotState:
        """Narrow the slot axis to ``idx``: row ``idx[j]`` of every per-slot
        tensor, ring buffers included, is system j's whole optimizer state.
        The last ``n_pad_rows`` entries repeat a live row and are marked done
        and finalized, so they never emit or retire.  Candidate tables are
        rebuilt by the caller."""
        ix = torch.as_tensor(idx, dtype=torch.long, device=st.it.device)
        b_new = len(idx)
        pad = torch.arange(b_new, device=ix.device) >= b_new - n_pad_rows

        def take(t, dim=0):
            return None if t is None else t.index_select(dim, ix)

        batch = AtomsBatch(**{f.name: take(getattr(st.batch, f.name)) for f in dataclasses.fields(AtomsBatch)})
        return _SlotState(
            batch=batch, r0=take(st.r0), f0=take(st.f0), s_buf=take(st.s_buf, 1), y_buf=take(st.y_buf, 1),
            rho=take(st.rho, 1), it=take(st.it), budget=take(st.budget), done=take(st.done) | pad,
            conv=take(st.conv) & ~pad, finalized=take(st.finalized) | pad, it_hi=st.it_hi[idx].copy(),
        )

    # ---------------------------------------------------------------- steps
    def _step(self, st: _SlotState) -> Tuple[torch.Tensor, ...]:
        """One per-system L-BFGS step on every slot, in place; returns the
        step's (positions, energy, forces, emit) frame."""
        batch = st.batch
        b, n, _ = batch.pos.shape
        atom3 = batch.atom_mask[..., None]
        if self.candidate_fn is not None:
            self.host_reads += 1
            if bool(need_rebuild(batch.pos, batch.atom_mask, st.cand)):
                st.cand = self.candidate_fn(batch)
            energy, forces = self.energy_forces_fn(batch, st.cand)
        else:
            energy, forces = self.energy_forces_fn(batch)
        forces = torch.where(atom3, forces, 0.0)

        max_f = masked_max(torch.linalg.norm(forces, dim=-1), batch.atom_mask, dim=1)  # [B]
        active = ~st.done
        # frames: every active system's, and one more for a freshly done
        # system (its final state, recomputed)
        emit = active | (st.done & ~st.finalized)
        now_conv = active & (max_f < self.fmax)

        r, f = batch.pos.reshape(b, n * 3), forces.reshape(b, n * 3)
        s0, y0 = r - st.r0, -(f - st.f0)
        rho0 = 1.0 / torch.sum(y0 * s0, dim=-1)  # [B]
        has_hist = (st.it > 0) & active
        hh = has_hist[None, :, None]
        st.s_buf = torch.where(hh, torch.cat([st.s_buf[1:], s0[None]]), st.s_buf)
        st.y_buf = torch.where(hh, torch.cat([st.y_buf[1:], y0[None]]), st.y_buf)
        st.rho = torch.where(has_hist[None, :], torch.cat([st.rho[1:], rho0[None]]), st.rho)
        n_hist = torch.clamp(st.it, max=self.memory)
        walk = min(int(st.it_hi.max()), self.memory)
        z = _two_loop_per_system(-f, st.s_buf, st.y_buf, st.rho, n_hist, self.h0, walk)
        p = (-z).reshape(b, n, 3)

        longest = masked_max(torch.linalg.norm(p, dim=-1), batch.atom_mask, dim=1)
        scale = torch.clamp(longest, max=self.maxstep) / (longest + 1e-7)
        dr = p * scale[:, None, None] * self.damping
        tiny = torch.amax(torch.abs(dr), dim=(1, 2)) < 1e-7
        move = (active & ~now_conv & ~tiny)[:, None, None] & atom3
        keep = (active & ~tiny)[:, None]
        it_new = st.it + active.to(torch.int32)
        hit_budget = active & ~now_conv & (it_new >= st.budget)

        st.batch = batch.replace(pos=torch.where(move, batch.pos + dr, batch.pos))
        st.r0, st.f0 = torch.where(keep, r, st.r0), torch.where(keep, f, st.f0)
        st.it = it_new
        st.it_hi += 1
        st.done, st.conv = st.done | now_conv | hit_budget, st.conv | now_conv
        st.finalized = st.finalized | ~active
        return batch.pos, energy, forces, emit

    def _chunk(self, st: _SlotState) -> Tuple[torch.Tensor, ...]:
        """``chunk_steps`` steps; the frames stacked into fresh tensors
        ``[R, B, ...]`` that nothing overwrites while the writer reads them."""
        frames = [self._step(st) for _ in range(self.chunk_steps)]
        return tuple(torch.stack(col) for col in zip(*frames))

    # ---------------------------------------------------------------- runs
    def run_systems(
        self,
        systems: Sequence[System],
        traj_dir: Optional[str] = None,
        save_full_traj: bool = True,
        skip_existing: bool = True,
        budgets: Optional[Sequence[int]] = None,
        max_atoms: Optional[int] = None,
    ) -> Dict[int, RelaxedSystem]:
        """Relax ``systems`` (each for at most ``steps`` optimizer steps, or
        its entry of ``budgets``); returns ``{sid: RelaxedSystem}`` for every
        system relaxed by this call (skipped ones are left out)."""
        systems = list(systems)
        budgets = [self.steps] * len(systems) if budgets is None else [int(x) for x in budgets]
        if len(budgets) != len(systems):
            raise ValueError("budgets must align with systems")
        if traj_dir is not None:
            os.makedirs(traj_dir, exist_ok=True)
            if skip_existing:
                kept = [(s, bd) for s, bd in zip(systems, budgets)
                        if not (self._writer.is_pending((traj_dir, s.sid)) or check_traj_files([s.sid], traj_dir))]
                if len(kept) < len(systems):
                    logging.info(f"Skipping {len(systems) - len(kept)} systems with existing trajectories")
                systems, budgets = [s for s, _ in kept], [bd for _, bd in kept]
        results: Dict[int, RelaxedSystem] = {}
        if not systems:
            return results
        n_pad = max(s.natoms for s in systems) if max_atoms is None else int(max_atoms)
        with torch.no_grad():
            self._run(systems, budgets, n_pad, results, traj_dir, save_full_traj)
        self.flush()
        return results

    def _run(self, systems, budgets, n_pad, results, traj_dir, save_full) -> None:
        b = self.slots
        pool = list(zip(systems, budgets))[::-1]  # pop() keeps the order
        first = [pool.pop() if pool else None for _ in range(b)]
        occupants: Dict[int, Optional[System]] = {i: e and e[0] for i, e in enumerate(first)}
        st = self._init_state(
            collate([(e or first[0])[0] for e in first], max_atoms=n_pad, device=self.device),
            [e[1] if e else 0 for e in first], [i for i, e in enumerate(first) if e is None])
        buffers: Dict[int, list] = {}  # frame lists per slot, owned by the writer thread
        while True:
            arrays = self._chunk(st)
            # the chunk's one read: retirement flags and iteration counts
            self.host_reads += 1
            flags = torch.stack([(st.done & st.finalized).to(torch.int32), st.conv.to(torch.int32), st.it]).cpu()
            flags = flags.numpy().astype(np.int64)
            its = st.it_hi = flags[2]
            retire = [dict(slot=i, system=occupants[i], nsteps=int(its[i]), converged=bool(flags[1, i]))
                      for i in range(b) if occupants[i] is not None and flags[0, i]]
            for r in retire:
                occupants[r["slot"]] = None
            self._writer.submit(
                _collect_chunk, arrays,
                [i for i in range(b) if occupants[i] is not None or any(r["slot"] == i for r in retire)],
                retire, buffers, results, traj_dir, save_full,
                pending_keys=[(traj_dir, r["system"].sid) for r in retire] if traj_dir is not None else (),
            )
            refilled = False
            for r in retire:
                if not pool:
                    break
                sys_, bd = pool.pop()
                self._refill(st, r["slot"], collate([sys_], max_atoms=n_pad, device=self.device), bd)
                occupants[r["slot"]] = sys_
                refilled = True
            if refilled and self.candidate_fn is not None:
                # a refilled slot's tables belong to its previous occupant:
                # rebuild now, so the margin test only sees current occupants
                st.cand = self.candidate_fn(st.batch)
            live = [i for i in range(b) if occupants[i] is not None]
            if self.drain_narrowing and not pool and live:
                b_new = 1 << (len(live) - 1).bit_length()
                if b_new <= b // 2:
                    # per-system history rows move with their system: exact
                    self._writer.submit(_remap_buffers, buffers, {old: new for new, old in enumerate(live)})
                    st = self._gather_slots(st, live + [live[0]] * (b_new - len(live)), b_new - len(live))
                    if self.candidate_fn is not None:
                        st.cand = self.candidate_fn(st.batch)
                    occupants = {new: occupants[old] for new, old in enumerate(live)}
                    occupants.update({j: None for j in range(len(live), b_new)})
                    self.narrow_events.append((len(live), b_new))
                    b = b_new
            if not live and not pool:
                break

    def run_dataset(self, dataset, traj_dir: Optional[str] = None, num_buckets: int = 4,
                    **kw) -> Dict[int, RelaxedSystem]:
        """Relax every system of a dataset (``__len__`` and ``__getitem__ ->
        System``), bucketed by atom count so pad shapes stay tight (the
        batcher's quantile edges)."""
        systems = [dataset[i] for i in range(len(dataset))]
        if not systems:
            return {}
        edges = default_bucket_edges(np.asarray([s.natoms for s in systems]), num_buckets)
        results: Dict[int, RelaxedSystem] = {}
        lo = 0
        for hi in edges:
            group = [s for s in systems if lo < s.natoms <= hi]
            lo = hi
            if group:
                results.update(self.run_systems(group, traj_dir=traj_dir, max_atoms=hi, **kw))
        return results
