"""End-to-end AdsorbDiff pipeline: sample -> convert -> MLFF relax -> evaluate.

Port of :mod:`adsorbdiff_tpu.pipeline` for one device.  Per sampling seed
(site), the stages hand off through files under ``out_dir/<seed>/``: the
sampled trajectories (``sampled/``), the relaxation-input shard
(``final_struct.adshard.npz``) and the relaxed trajectories
(``relaxations/``); the success rate reads the relaxed ones.

Random numbers: batch i of seed s samples from a ``torch.Generator`` seeded
from (s, i) (the JAX pipeline folds i into ``PRNGKey(s)``); the two packages'
generators differ, so their samples differ by design.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional

from adsorbdiff_tpu_torch.data.buckets import BucketedBatcher
from adsorbdiff_tpu_torch.data.schema import System
from adsorbdiff_tpu_torch.data.store import ShardDataset, write_shard
from adsorbdiff_tpu_torch.device import resolve_device
from adsorbdiff_tpu_torch.eval_tools import success_rate
from adsorbdiff_tpu_torch.relaxation.continuous import ContinuousRelaxationEngine, resolve_continuous
from adsorbdiff_tpu_torch.relaxation.ml_relaxation import DiffusionEngine, RelaxationEngine, batch_generator
from adsorbdiff_tpu_torch.runtime.trajectory import Trajectory, list_trajectories


def sampled_trajs_to_dataset(traj_dir: str, out_path: str, z_clearance: float = 0.1) -> int:
    """Final sampled structures -> one relaxation-input shard; returns the
    number of systems.  An adsorbate whose lowest atom is within
    ``z_clearance`` of the highest surface atom is lifted to exactly
    ``z_clearance`` above it (the reference's ``pred_traj_to_lmdb`` fix)."""
    systems = []
    for path in list_trajectories(traj_dir):
        traj = Trajectory.load(path)
        pos = traj.positions[-1].copy()
        ads, surf = traj.tags == 2, traj.tags == 1
        if ads.any() and surf.any():
            diff = pos[ads][:, 2].min() - pos[surf][:, 2].max()
            if diff < z_clearance:
                pos[ads, 2] += abs(diff) + z_clearance
        systems.append(System(pos=pos, atomic_numbers=traj.numbers, tags=traj.tags, fixed=traj.fixed,
                              cell=traj.cell, sid=traj.sid, fid=traj.fid))
    write_shard(out_path, systems)
    return len(systems)


def run_pipeline(
    diffusion_trainer,
    relax_trainer,
    relax_dataset_cfg: dict,
    out_dir: str,
    nsites: int = 1,
    denoising_pos_params: Optional[dict] = None,
    relax_opt: Optional[dict] = None,
    relaxation_steps: int = 300,
    relaxation_fmax: float = 0.01,
    dft_targets: Optional[Dict[str, float]] = None,
    batch_size: int = 8,
    atom_budget: Optional[int] = None,
) -> Optional[float]:
    """Per seed: diffusion sampling over the relax dataset -> shard
    conversion -> MLFF L-BFGS -> (with ``dft_targets``) the anomaly-filtered
    min-energy success rate, which is returned.

    ``diffusion_trainer`` is a :class:`~adsorbdiff_tpu_torch.train.trainer.
    DenoisingTrainer` with its state (``score_fn``, ``sampling_static_fn()``
    and ``denoising_pos_params`` are what it uses), ``relax_trainer`` an
    :class:`~adsorbdiff_tpu_torch.train.trainer.S2EFTrainer`
    (``energy_forces_fn(batch[, static])``, and ``relax_candidate_fn(
    relax_opt)`` for Verlet candidate tables where it has one);
    :mod:`adsorbdiff_tpu_torch.run_pipeline` builds both from configs and
    checkpoints.  ``relax_opt["continuous"]`` picks the engine
    (:func:`resolve_continuous`; ``relax_opt["slots"]`` defaults to
    ``batch_size``).  Every stage runs on the diffusion trainer's device (the
    CUDA card unless its config sets ``cpu``, which runs the plain
    versions); a relax trainer on another device raises.  ``atom_budget``
    gives the sampler's and the batch relaxer's batchers atom-balanced
    batches (``batch_size`` becomes the cap; see
    :class:`~adsorbdiff_tpu_torch.data.buckets.BucketedBatcher`).
    """
    device = resolve_device(getattr(diffusion_trainer, "device", None))
    relax_device = getattr(relax_trainer, "device", device)
    if relax_device != device:
        raise ValueError(f"the relax trainer runs on {relax_device} and the diffusion trainer on {device}: the "
                         f"pipeline runs every stage on one device")
    params = denoising_pos_params or diffusion_trainer.denoising_pos_params
    # one engine pair for every seed
    engine = DiffusionEngine(diffusion_trainer.score_fn, params, static_fn=diffusion_trainer.sampling_static_fn(),
                             device=device)
    cand_hook = getattr(relax_trainer, "relax_candidate_fn", None)
    candidate_fn = cand_hook(relax_opt) if cand_hook is not None else None
    continuous = resolve_continuous(relax_opt, relaxation_fmax)
    if continuous:
        # slot refill: converged systems retire at chunk boundaries and
        # pending ones take their slots
        rengine = ContinuousRelaxationEngine(
            relax_trainer.energy_forces_fn, relax_opt, steps=relaxation_steps, fmax=relaxation_fmax,
            candidate_fn=candidate_fn, slots=int((relax_opt or {}).get("slots", batch_size)), device=device)
    else:
        rengine = RelaxationEngine(relax_trainer.energy_forces_fn, relax_opt, steps=relaxation_steps,
                                   fmax=relaxation_fmax, candidate_fn=candidate_fn, device=device)
    relax_dirs = []
    for seed in range(nsites):
        step_dir = os.path.join(out_dir, str(seed))
        sample_dir = os.path.join(step_dir, "sampled")
        relax_dir = os.path.join(step_dir, "relaxations")

        # 1. diffusion sampling
        batcher = BucketedBatcher(ShardDataset(relax_dataset_cfg), batch_size, shuffle=False, seed=seed,
                                  atom_budget=atom_budget)
        for i, batch in enumerate(batcher):
            engine.run(batch, batch_generator(seed, i, device), traj_dir=sample_dir)
        engine.flush()  # stage 2 reads the trajectories

        # 2. sampled trajectories -> relaxation-input shard
        shard_path = os.path.join(step_dir, "final_struct")
        n = sampled_trajs_to_dataset(sample_dir, shard_path)
        logging.info(f"seed {seed}: converted {n} sampled structures")

        # 3. MLFF relaxation
        relax_ds = ShardDataset({"src": shard_path})
        if continuous:
            rengine.run_dataset(relax_ds, traj_dir=relax_dir)
        else:
            for batch in BucketedBatcher(relax_ds, batch_size, shuffle=False, seed=seed, atom_budget=atom_budget):
                rengine.run(batch, traj_dir=relax_dir)
        rengine.flush()  # stage 4 reads the trajectories
        relax_dirs.append(relax_dir)

    # 4. anomaly-filtered min-energy success rate
    if dft_targets is not None:
        rate, per_system = success_rate(relax_dirs, dft_targets)
        logging.info(f"Success rate: {rate * 100:.1f}%  ({per_system})")
        return rate
    return None
