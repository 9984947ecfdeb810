"""Model base helpers: on-the-fly graph generation for padded batches.

Port of :mod:`adsorbdiff_tpu.models.base`: ``generate_graph`` (full,
incremental or Verlet-candidate builds), ``prepare_static_graph``,
``prepare_candidate_graph`` and ``derive_subgraph``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from adsorbdiff_tpu_torch.data.schema import AtomsBatch
from adsorbdiff_tpu_torch.ops.pbc import (
    CandidateTable,
    NeighborList,
    StaticGraphPart,
    candidate_topk,
    radius_graph_pbc,
    radius_graph_pbc_incremental,
    refresh_from_candidates,
    slab_static_topk,
)


def prepare_static_graph(
    batch: AtomsBatch,
    *,
    cutoff: float,
    max_neighbors: int,
    cell_reps: Tuple[int, int, int],
) -> StaticGraphPart:
    """Slab-slab neighbour candidates, computed once per sampling trajectory
    (only adsorbate atoms move between steps)."""
    return slab_static_topk(
        batch.pos, batch.cell, batch.atom_mask, batch.ads_mask,
        radius=cutoff, max_neighbors=max_neighbors, reps=cell_reps,
    )


def prepare_candidate_graph(
    batch: AtomsBatch,
    *,
    max_neighbors: int,
    cell_reps: Tuple[int, int, int],
    k_cand: int = 64,
) -> CandidateTable:
    """Verlet candidate table for a relaxation loop; pass it as
    ``static_graph`` and :func:`generate_graph` refreshes from it."""
    return candidate_topk(
        batch.pos, batch.cell, batch.atom_mask,
        k_cand=k_cand, max_neighbors=max_neighbors, reps=cell_reps,
    )


def _edge_unit(nl: NeighborList) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distance clamped below at 1e-3, unit vector target -> source, zero on
    masked slots)."""
    dist = torch.clamp(nl.dist, min=1e-3)
    unit = nl.vec / dist[..., None]
    return dist, torch.where(nl.mask[..., None], unit, torch.zeros_like(unit))


def derive_subgraph(
    nl: NeighborList,
    *,
    max_neighbors: int,
    cutoff: Optional[float] = None,
) -> Tuple[NeighborList, torch.Tensor, torch.Tensor]:
    """A smaller graph as the first ``max_neighbors`` slots of a larger table,
    with edges past ``cutoff`` masked.  Slots are nearest-first, so for a
    smaller or equal cutoff and K this is the table an independent build
    gives.  Returns ``(nl, dist, unit)`` like :func:`generate_graph`."""
    k = max_neighbors
    d = nl.dist[..., :k]
    mask = nl.mask[..., :k]
    if cutoff is not None:
        mask = mask & (d <= cutoff)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    src = nl.src[..., :k]
    sub = NeighborList(
        src=torch.where(mask, src, torch.zeros_like(src)),
        cell_offsets=nl.cell_offsets[..., :k, :],
        vec=torch.where(mask[..., None], nl.vec[..., :k, :], zero),
        dist=torch.where(mask, d, zero),
        mask=mask,
    )
    return (sub,) + _edge_unit(sub)


def generate_graph(
    batch: AtomsBatch,
    *,
    cutoff: float,
    max_neighbors: int,
    cell_reps: Tuple[int, int, int],
    static_graph: Optional[Union[StaticGraphPart, CandidateTable]] = None,
    max_ads: int = 16,
) -> Tuple[NeighborList, torch.Tensor, torch.Tensor]:
    """PBC neighbour table plus unit edge vectors.

    Returns ``(nl, edge_dist, edge_unit)``; ``edge_unit[b, i, k]`` points from
    target i to (the periodic image of) source ``nl.src[b, i, k]``, and
    ``edge_dist`` is ``nl.dist`` clamped below at 1e-3 (zero-distance guard).
    With a :class:`StaticGraphPart` only the adsorbate-involving rows are
    recomputed; with a :class:`CandidateTable` the table is refreshed from the
    cached candidates.  Both give the full build's table.
    """
    if isinstance(static_graph, CandidateTable):
        nl = refresh_from_candidates(
            batch.pos, batch.cell, static_graph, radius=cutoff, max_neighbors=max_neighbors,
        )
    elif static_graph is not None:
        nl = radius_graph_pbc_incremental(
            batch.pos, batch.cell, batch.atom_mask, batch.ads_mask, static_graph,
            radius=cutoff, max_neighbors=max_neighbors, reps=cell_reps, max_ads=max_ads,
        )
    else:
        nl = radius_graph_pbc(
            batch.pos, batch.cell, batch.atom_mask,
            radius=cutoff, max_neighbors=max_neighbors, reps=cell_reps,
        )
    return (nl,) + _edge_unit(nl)
