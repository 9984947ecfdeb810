"""Atom-count bucketing batcher.

Port of :mod:`adsorbdiff_tpu.data.buckets`: systems are bucketed by padded
atom count (rounded up to a bucket edge), so each step sees one of a few
static ``[B, N]`` shapes; within a bucket, batches are drawn shuffled per
epoch from ``np.random.default_rng((seed, epoch))``, so for a seed and an
epoch the port yields the JAX package's batch plan, whatever the options.

``mode="neighbors"`` is the reference's second balancing metric: buckets are
formed on per-system neighbour counts (``sizes``, from
:func:`adsorbdiff_tpu_torch.data.metadata.neighbor_counts`), and each bucket
pads atoms to its own maximum.  Batches are collated on the host (CPU
tensors), through the dataset's own ``collate_indices`` where it has one
(the C++ collator of :class:`~adsorbdiff_tpu_torch.data.native.NativeShardDataset`),
with ``forces`` where ``with_forces`` is set;
:mod:`adsorbdiff_tpu_torch.data.prefetch` moves them to the card.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

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

    ``bucket_edges`` (atoms mode): the padded sizes, else ``num_buckets``
    quantile edges.  ``drop_last``: a bucket's short last batch is dropped,
    else it repeats its tail system up to the bucket's batch size.
    ``atom_budget``: each bucket's batch size is ``min(batch_size,
    atom_budget // edge)``, rounded down to a multiple of ``multiple_of``
    (at least ``multiple_of``), so every batch carries a similar padded-atom
    count; ``batch_size`` becomes the cap and must be a multiple of
    ``multiple_of`` (the rank count, so every batch splits evenly)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        bucket_edges: Optional[Sequence[int]] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        with_forces: bool = False,
        mode: str = "atoms",
        sizes: Optional[np.ndarray] = None,
        num_buckets: int = 4,
        atom_budget: Optional[int] = None,
        multiple_of: int = 1,
    ) -> None:
        if mode not in ("atoms", "neighbors"):
            raise ValueError(f"mode must be 'atoms' or 'neighbors', got {mode!r}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.with_forces = with_forces
        self.mode = mode
        self.atom_budget = int(atom_budget) if atom_budget else None
        self.multiple_of = max(1, int(multiple_of))
        if self.batch_size % self.multiple_of:
            raise ValueError(f"batch_size {batch_size} not a multiple of {multiple_of}")
        natoms = np.asarray(dataset.natoms_array())
        if mode == "neighbors":
            if sizes is None:
                raise ValueError(
                    "mode='neighbors' needs per-system neighbor counts; compute "
                    "them once with adsorbdiff_tpu_torch.data.metadata.neighbor_counts"
                )
            sizes = np.asarray(sizes)
            if len(sizes) != len(natoms):
                raise ValueError(f"sizes length {len(sizes)} != dataset length {len(natoms)}")
            if len(sizes):
                qs = np.quantile(sizes, np.linspace(1.0 / num_buckets, 1.0, num_buckets))
                size_edges = sorted(set(int(q) for q in qs))
                size_edges[-1] = max(size_edges[-1], int(sizes.max()))
            else:
                size_edges = [0]
            self._bucket_of = np.searchsorted(size_edges, sizes)
            # each neighbour bucket pads atoms to its own max, rounded up to 8
            self.bucket_edges = [
                int(-(-int(natoms[self._bucket_of == b].max()) // 8) * 8)
                if (self._bucket_of == b).any() else 8
                for b in range(len(size_edges))
            ]
        else:
            self.bucket_edges = (
                list(bucket_edges) if bucket_edges is not None
                else default_bucket_edges(natoms, num_buckets)
            )
            self._bucket_of = np.searchsorted(self.bucket_edges, natoms)
            if (self._bucket_of >= len(self.bucket_edges)).any():
                raise ValueError(
                    f"system with {natoms.max()} atoms exceeds largest bucket edge {self.bucket_edges[-1]}"
                )
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
                chunk = idx[lo : lo + bs]
                if self.drop_last and len(chunk) < bs:
                    continue
                plan.append((edge, chunk))
        if self.shuffle:
            rng.shuffle(plan)  # interleave buckets
        return plan

    def _bucket_batch_size(self, edge: int) -> int:
        if self.atom_budget:
            bs = min(self.batch_size, self.atom_budget // max(edge, 1))
            bs = (bs // self.multiple_of) * self.multiple_of
            return max(self.multiple_of, bs)
        return self.batch_size

    def __len__(self) -> int:
        return len(self._plan())

    def __iter__(self) -> Iterator[AtomsBatch]:
        native = hasattr(self.dataset, "collate_indices")
        for edge, chunk in self._plan():
            # Repeat the tail system so the batch axis stays static; repeats
            # carry the same sid and are deduped where results are gathered.
            idx = [int(i) for i in chunk]
            idx += [idx[-1]] * (self._bucket_batch_size(edge) - len(idx))
            if native:
                yield self.dataset.collate_indices(idx, max_atoms=edge, with_forces=self.with_forces)
            else:
                yield collate([self.dataset[i] for i in idx], max_atoms=edge, with_forces=self.with_forces,
                              device="cpu")
