"""Atom-count bucketing batcher.

Port of :mod:`adsorbdiff_tpu.data.buckets`: systems are bucketed by padded
atom count (rounded up to a bucket edge), so each step sees one of a few
static ``[B, N]`` shapes; within a bucket, batches are drawn shuffled per
epoch from ``np.random.default_rng((seed, epoch))``, so for a seed and an
epoch the port yields the JAX package's batch plan (atom buckets, without
its atom budget and neighbour-count modes).  Batches are collated on the
host (CPU tensors); :mod:`adsorbdiff_tpu_torch.data.prefetch` moves them to
the card.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

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
    """Iterates padded :class:`AtomsBatch` objects with bucket-static shapes."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0) -> None:
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
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
            for lo in range(0, len(idx), self.batch_size):
                plan.append((edge, idx[lo : lo + self.batch_size]))
        if self.shuffle:
            rng.shuffle(plan)  # interleave buckets
        return plan

    def __len__(self) -> int:
        return len(self._plan())

    def __iter__(self) -> Iterator[AtomsBatch]:
        for edge, chunk in self._plan():
            # Repeat the tail system so the batch axis stays static; repeats
            # carry the same sid and are deduped where results are gathered.
            idx = [int(i) for i in chunk]
            idx += [idx[-1]] * (self.batch_size - len(idx))
            yield collate([self.dataset[i] for i in idx], max_atoms=edge, device="cpu")
