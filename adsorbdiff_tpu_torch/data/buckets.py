"""Atom-count bucketing batcher.

Port of :mod:`adsorbdiff_tpu.data.buckets`: systems are bucketed by padded
atom count (rounded up to a bucket edge), so each step sees one of a few
static ``[B, N]`` shapes; within a bucket, batches are drawn shuffled per
epoch from ``np.random.default_rng((seed, epoch))``, so for a seed and an
epoch the port yields the JAX package's batch plan, atom-balanced ones
(``atom_budget``) included.  The neighbour-count buckets (JAX's
``mode="neighbors"``) are not ported.  Batches are collated on the
host (CPU tensors), with ``forces`` where ``with_forces`` is set (an S2EF
trainer's training and validation batches);
:mod:`adsorbdiff_tpu_torch.data.prefetch` moves them to the card.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from adsorbdiff_tpu_torch.data.schema import AtomsBatch, collate


def default_bucket_edges(natoms: np.ndarray, num_buckets: int = 4) -> List[int]:
    """Quantile bucket edges, each rounded up to a multiple of 8."""
    if len(natoms) == 0:
        return [8]
    qs = np.quantile(natoms, np.linspace(1.0 / num_buckets, 1.0, num_buckets))
    edges = sorted({int(-(-int(q) // 8) * 8) for q in qs})
    if edges[-1] < int(natoms.max()):
        edges[-1] = int(-(-int(natoms.max()) // 8) * 8)
    return edges


class BucketedBatcher:
    """Iterates padded :class:`AtomsBatch` objects with bucket-static shapes.

    ``atom_budget``: each bucket's batch size is ``min(batch_size,
    atom_budget // edge)`` (at least 1), so every batch carries a similar
    padded-atom count; ``batch_size`` becomes the cap.  A bucket's short
    last batch repeats its tail system up to the bucket's batch size."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 with_forces: bool = False, atom_budget: Optional[int] = None) -> None:
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.with_forces = with_forces
        self.atom_budget = int(atom_budget) if atom_budget else None
        natoms = np.asarray(dataset.natoms_array())
        self.bucket_edges = default_bucket_edges(natoms)
        self._bucket_of = np.searchsorted(self.bucket_edges, natoms)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed shuffling per epoch."""
        self._epoch = int(epoch)

    def _plan(self) -> List[Tuple[int, np.ndarray]]:
        rng = np.random.default_rng((self.seed, self._epoch))
        plan: List[Tuple[int, np.ndarray]] = []
        for b, edge in enumerate(self.bucket_edges):
            idx = np.nonzero(self._bucket_of == b)[0]
            if len(idx) == 0:
                continue
            if self.shuffle:
                rng.shuffle(idx)
            bs = self._bucket_batch_size(edge)
            for lo in range(0, len(idx), bs):
                plan.append((edge, idx[lo : lo + bs]))
        if self.shuffle:
            rng.shuffle(plan)  # interleave buckets
        return plan

    def _bucket_batch_size(self, edge: int) -> int:
        if self.atom_budget:
            return max(1, min(self.batch_size, self.atom_budget // max(edge, 1)))
        return self.batch_size

    def __len__(self) -> int:
        return len(self._plan())

    def __iter__(self) -> Iterator[AtomsBatch]:
        for edge, chunk in self._plan():
            # Repeat the tail system so the batch axis stays static; repeats
            # carry the same sid and are deduped where results are gathered.
            idx = [int(i) for i in chunk]
            idx += [idx[-1]] * (self._bucket_batch_size(edge) - len(idx))
            yield collate([self.dataset[i] for i in idx], max_atoms=edge, with_forces=self.with_forces, device="cpu")
