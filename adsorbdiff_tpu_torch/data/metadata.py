"""Target metadata and per-system neighbour counts.

Port of :mod:`adsorbdiff_tpu.data.metadata`: samples items and guesses, per
target, its shape, level (atom or system) and whether it is extensive, to
configure output heads a config does not specify; and counts each system's
edges under a cutoff, the sizes the ``"neighbors"`` mode of
:class:`~adsorbdiff_tpu_torch.data.buckets.BucketedBatcher` balances on.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from adsorbdiff_tpu_torch.device import DeviceLike, resolve_device


def uses_extensive(targets: np.ndarray, natoms: np.ndarray) -> bool:
    """Extensive if the per-atom target has a lower relative spread than the
    raw target."""
    targets = np.asarray(targets, np.float64)
    natoms = np.asarray(natoms, np.float64)
    raw_cv = np.std(targets) / (np.abs(np.mean(targets)) + 1e-12)
    per_atom = targets / np.maximum(natoms, 1)
    pa_cv = np.std(per_atom) / (np.abs(np.mean(per_atom)) + 1e-12)
    return bool(pa_cv < raw_cv)


def neighbor_counts(
    dataset,
    cutoff: float = 12.0,
    max_neighbors: int = 50,
    reps=(2, 2, 0),
    limit: Optional[int] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Per-system neighbour (edge) counts under (cutoff, max_neighbors):
    each atom's partners within ``cutoff`` over the periodic images
    ``-reps..reps`` of every cell vector, capped at ``max_neighbors``,
    summed over the system.  A brute-force count on ``device`` (the card
    unless ``"cpu"`` is passed), all images of a system at once.

    Float64, each step the JAX package's numpy step in the same order (the
    image shift, the difference, the squares summed x, y, z), so the ``<=
    cutoff**2`` and ``> 1e-8`` tests give its integer counts exactly, on
    either device.  Run once and keep the result."""
    device = resolve_device(device)
    n = len(dataset) if limit is None else min(len(dataset), limit)
    offs = torch.tensor(
        [(i, j, k)
         for i in range(-reps[0], reps[0] + 1)
         for j in range(-reps[1], reps[1] + 1)
         for k in range(-reps[2], reps[2] + 1)],
        dtype=torch.float64, device=device,
    )
    counts = torch.zeros(n, dtype=torch.int64, device=device)
    for i in range(n):
        s = dataset[i]
        pos = torch.as_tensor(np.asarray(s.pos, np.float64), device=device)
        cell = torch.as_tensor(np.asarray(s.cell, np.float64), device=device)
        shift = offs[:, 0, None] * cell[0] + offs[:, 1, None] * cell[1] + offs[:, 2, None] * cell[2]  # [O, 3]
        d = pos[None, :, None, :] - (pos[None, None, :, :] + shift[:, None, None, :])  # [O, n, n, 3]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        per_target = ((d2 <= cutoff * cutoff) & (d2 > 1e-8)).sum((0, 2))
        counts[i] = per_target.clamp(max=max_neighbors).sum()
    return counts.cpu().numpy()


def guess_target_metadata(dataset, num_samples: int = 100) -> Dict[str, dict]:
    """Inspect up to ``num_samples`` systems and describe the targets."""
    n = min(len(dataset), num_samples)
    idx = np.linspace(0, len(dataset) - 1, n).astype(int)
    energies, natoms, has_forces = [], [], True
    for i in idx:
        s = dataset[int(i)]
        energies.append(0.0 if s.energy is None else s.energy)
        natoms.append(s.natoms)
        has_forces &= s.forces is not None
    energies = np.asarray(energies)
    natoms = np.asarray(natoms)

    meta: Dict[str, dict] = {}
    if np.any(energies != 0):
        meta["energy"] = {
            "shape": [1],
            "level": "system",
            "extensive": uses_extensive(energies, natoms),
            "mean": float(np.mean(energies)),
            "std": float(np.std(energies)),
        }
    if has_forces and n:
        meta["forces"] = {"shape": [3], "level": "atom", "extensive": False}
    return meta
