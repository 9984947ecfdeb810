"""Batch runners for diffusion sampling and MLFF relaxation.

Port of ``DiffusionEngine`` and ``RelaxationEngine`` from
:mod:`adsorbdiff_tpu.relaxation.ml_relaxation`, plus :func:`make_score_fn`,
the score function that ``relaxation/calculator.py`` builds around a PaiNN.
With a ``traj_dir`` both engines write one ``<sid>.adtraj.npz`` per system
(:mod:`adsorbdiff_tpu_torch.runtime.trajectory`) on a background thread, so
the copy to the host and the file write overlap the next batch's work on the
card; ``engine.flush()`` joins them (call it before reading the directory)
and raises the first error a write met.  Systems whose trajectory exists or
is queued are skipped (``skip_existing``).  Langevin sampling comes later.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from adsorbdiff_tpu_torch.data.schema import AtomsBatch
from adsorbdiff_tpu_torch.device import DeviceLike, resolve_device
from adsorbdiff_tpu_torch.diffusion.sampler import SampleResult, langevin_dynamics, reverse_diffusion
from adsorbdiff_tpu_torch.relaxation.lbfgs import (LBFGSResult, candidate_fn_for, lbfgs_relax,
                                                   make_mlff_energy_forces)
from adsorbdiff_tpu_torch.runtime.trajectory import Trajectory, check_traj_files


class _AsyncWriter:
    """One background thread that runs trajectory writes in order.

    ``submit`` queues ``fn(*args)`` with the ``(traj_dir, sid)`` keys it will
    write, which count as present (:meth:`is_pending`) until it has run;
    ``flush`` joins the thread and raises the first error a task met.  A task
    given CUDA tensors copies them to the host on this thread: the caller must
    not overwrite them afterwards (the engines pass tensors that each run
    allocates afresh)."""

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self._pending: set = set()
        self._lock = threading.Lock()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, kwargs, keys = item
            try:
                fn(*args, **kwargs)
            except BaseException as e:  # raised again by flush()
                if self._err is None:
                    self._err = e
            finally:
                with self._lock:
                    self._pending.difference_update(keys)

    def submit(self, fn, *args, pending_keys=(), **kwargs) -> None:
        with self._lock:
            self._pending.update(pending_keys)
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        self._q.put((fn, args, kwargs, frozenset(pending_keys)))

    def is_pending(self, key) -> bool:
        with self._lock:
            return key in self._pending

    def flush(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def _sids(batch: AtomsBatch) -> list:
    return [int(s) for s in batch.sid.tolist()]


def _should_skip(writer: _AsyncWriter, batch: AtomsBatch, traj_dir: str) -> bool:
    """True when every system of the batch has its trajectory on disk or
    queued for writing."""
    missing = [s for s in _sids(batch) if not writer.is_pending((traj_dir, s))]
    return not missing or check_traj_files(missing, traj_dir)


def _write_trajs(
    batch: AtomsBatch,
    traj_pos: torch.Tensor,  # [T, B, N, 3]
    traj_dir: str,
    traj_energy: Optional[torch.Tensor] = None,  # [T, B]
    traj_forces: Optional[torch.Tensor] = None,  # [T, B, N, 3]
    save_full: bool = True,
) -> None:
    """One trajectory file per distinct sid of the batch (batch padding
    repeats the tail system); ``save_full=False`` keeps the last frame only.
    The copies to the host happen here, on the writer thread."""
    os.makedirs(traj_dir, exist_ok=True)
    frames = slice(None) if save_full else slice(-1, None)
    pos = traj_pos[frames].cpu().numpy()
    energy = None if traj_energy is None else traj_energy[frames].cpu().numpy()
    forces = None if traj_forces is None else traj_forces[frames].cpu().numpy()
    host = batch.to("cpu")
    natoms, sids, fids = host.natoms.numpy(), host.sid.numpy(), host.fid.numpy()
    written = set()
    for i in range(batch.batch_size):
        sid = int(sids[i])
        if sid in written:
            continue
        written.add(sid)
        n = int(natoms[i])
        Trajectory(
            positions=pos[:, i, :n],
            numbers=host.atomic_numbers[i, :n].numpy(),
            cell=host.cell[i].numpy(),
            tags=host.tags[i, :n].numpy(),
            fixed=host.fixed[i, :n].numpy(),
            energy=None if energy is None else energy[:, i],
            forces=None if forces is None else forces[:, i, :n],
            sid=sid,
            fid=int(fids[i]),
        ).save(os.path.join(traj_dir, str(sid)))


def make_score_fn(model: torch.nn.Module) -> Callable:
    """``score_fn(batch, static_graph=None) -> (tr_score, rot_score)`` for a
    denoising model, with the rotation score zeroed on fixed atoms (the
    reference's denoising_torch.py:496-499).  Runs without autograd."""

    def score_fn(cur: AtomsBatch, static_graph=None):
        with torch.no_grad():
            out = model(cur, static_graph)
        out1, out2 = out if isinstance(out, tuple) else (out, None)
        if out2 is not None:
            out2 = torch.where(cur.fixed[..., None], 0.0, out2)
        return out1, out2

    return score_fn


def batch_generator(seed: int, index: int, device: DeviceLike = None) -> torch.Generator:
    """The sampling generator of batch ``index`` of seed ``seed`` (the JAX
    package folds ``index`` into ``PRNGKey(seed)``; the two generators
    differ, so the samples differ by design)."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=resolve_device(device)).manual_seed(int(state))


class DiffusionEngine:
    """Sampling over batches (the reference's Denoiser + ml_diffuse).

    ``sampler``: ``"reverse_sde_rot"`` (:func:`reverse_diffusion`, with the
    rotation where the params set ``rot_std_low``) or ``"langevin"``
    (:func:`langevin_dynamics`); another name raises ``ValueError`` (the JAX
    engine runs reverse diffusion for any name but ``"langevin"``).
    ``static_fn``: optional ``batch -> static graph`` precomputation (e.g.
    ``model.prepare_static``) run once per trajectory; ``score_fn`` is then
    called as ``score_fn(batch, static)``.  Langevin sampling, as in JAX,
    calls ``score_fn(batch)`` and uses no static graph.  ``device``: where
    batches run, the CUDA card unless ``"cpu"`` is passed (raises without a
    card).
    """

    SAMPLERS = ("reverse_sde_rot", "langevin")

    def __init__(
        self,
        score_fn: Callable,
        denoising_pos_params: dict,
        sampler: str = "reverse_sde_rot",
        static_fn: Optional[Callable] = None,
        device: DeviceLike = None,
    ) -> None:
        if sampler not in self.SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r} (known: {', '.join(self.SAMPLERS)})")
        self.sampler = sampler
        self.score_fn = score_fn
        self.params = dict(denoising_pos_params)
        self.static_fn = static_fn
        self.device = resolve_device(device)
        self._writer = _AsyncWriter()

    def flush(self) -> None:
        """Join the queued trajectory writes (call before reading them)."""
        self._writer.flush()

    def run(
        self,
        batch: AtomsBatch,
        generator: Optional[torch.Generator] = None,
        traj_dir: Optional[str] = None,
        save_full_traj: bool = True,
        skip_existing: bool = True,
        *,
        frac: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        rot_noise: Optional[torch.Tensor] = None,
    ) -> Optional[SampleResult]:
        """Sample one batch; ``None`` when ``skip_existing`` finds every
        system's trajectory in ``traj_dir``.  ``frac``/``noise``/``rot_noise``
        replace the random draws (see :func:`reverse_diffusion` and
        :func:`langevin_dynamics`, which takes no ``rot_noise``)."""
        if traj_dir and skip_existing and _should_skip(self._writer, batch, traj_dir):
            logging.info(f"Skipping batch: {_sids(batch)}")
            return None
        with torch.no_grad():
            if self.sampler == "langevin":
                if rot_noise is not None:
                    raise ValueError("langevin sampling draws no rotation noise")
                result = langevin_dynamics(self.score_fn, batch.to(self.device), self.params, generator=generator,
                                           frac=frac, noise=noise)
            else:
                result = reverse_diffusion(
                    self.score_fn, batch.to(self.device), self.params,
                    generator=generator, with_rotation="rot_std_low" in self.params,
                    static_fn=self.static_fn, frac=frac, noise=noise, rot_noise=rot_noise,
                )
        if traj_dir:
            # traj_pos is stacked afresh by each run: nothing overwrites it
            # while the writer copies it
            self._writer.submit(_write_trajs, batch, result.traj_pos, traj_dir, save_full=save_full_traj,
                                pending_keys=[(traj_dir, s) for s in _sids(batch)])
        return result


class RelaxationEngine:
    """Batched L-BFGS over batches (the reference's ml_relax).

    ``relax_opt`` keys (defaults in brackets): ``steps`` [``steps``], ``fmax``
    [``fmax``], ``maxstep`` [0.04], ``memory`` [50], ``damping`` [1.0],
    ``alpha`` [70.0], ``early_exit`` [True].  ``device``: where batches run,
    the CUDA card unless ``"cpu"`` is passed (raises without a card).
    """

    def __init__(
        self,
        energy_forces_fn: Callable,
        relax_opt: Optional[dict] = None,
        steps: int = 300,
        fmax: float = 0.01,
        candidate_fn: Optional[Callable] = None,
        device: DeviceLike = None,
    ) -> None:
        opt = dict(relax_opt or {})
        self.kwargs = dict(
            steps=int(opt.get("steps", steps)),
            fmax=float(opt.get("fmax", fmax)),
            maxstep=float(opt.get("maxstep", 0.04)),
            memory=int(opt.get("memory", 50)),
            damping=float(opt.get("damping", 1.0)),
            alpha=float(opt.get("alpha", 70.0)),
            early_exit=bool(opt.get("early_exit", True)),
        )
        self.energy_forces_fn = energy_forces_fn
        self.candidate_fn = candidate_fn
        self.device = resolve_device(device)
        self._writer = _AsyncWriter()

    def flush(self) -> None:
        """Join the queued trajectory writes (call before reading them)."""
        self._writer.flush()

    @classmethod
    def from_model(cls, model: torch.nn.Module, relax_opt: Optional[dict] = None, **kw) -> "RelaxationEngine":
        """Candidate tables as :func:`~adsorbdiff_tpu_torch.relaxation.lbfgs.
        candidate_fn_for` builds them (``verlet_graph``, ``k_cand``)."""
        return cls(make_mlff_energy_forces(model), relax_opt, candidate_fn=candidate_fn_for(model, relax_opt), **kw)

    def run(self, batch: AtomsBatch, traj_dir: Optional[str] = None, save_full_traj: bool = True,
            skip_existing: bool = True) -> Optional[LBFGSResult]:
        """Relax one batch; ``None`` when ``skip_existing`` finds every
        system's trajectory in ``traj_dir``."""
        if traj_dir and skip_existing and _should_skip(self._writer, batch, traj_dir):
            logging.info(f"Skipping batch: {_sids(batch)}")
            return None
        with torch.no_grad():
            result = lbfgs_relax(self.energy_forces_fn, batch.to(self.device), candidate_fn=self.candidate_fn,
                                 **self.kwargs)
        if traj_dir:
            # lbfgs_relax allocates its traj_* buffers afresh for each run:
            # nothing overwrites them while the writer copies them
            self._writer.submit(_write_trajs, batch, result.traj_pos, traj_dir, traj_energy=result.traj_energy,
                                traj_forces=result.traj_forces, save_full=save_full_traj,
                                pending_keys=[(traj_dir, s) for s in _sids(batch)])
        return result
