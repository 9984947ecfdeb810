"""Model base helpers: on-the-fly graph generation for padded batches.

Port of :mod:`adsorbdiff_tpu.models.base` (``generate_graph`` and
``prepare_static_graph``; the Verlet candidate table comes with relaxation).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from adsorbdiff_tpu_torch.data.schema import AtomsBatch
from adsorbdiff_tpu_torch.ops.pbc import (
    NeighborList,
    StaticGraphPart,
    radius_graph_pbc,
    radius_graph_pbc_incremental,
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


def generate_graph(
    batch: AtomsBatch,
    *,
    cutoff: float,
    max_neighbors: int,
    cell_reps: Tuple[int, int, int],
    static_graph: Optional[StaticGraphPart] = None,
    max_ads: int = 16,
) -> Tuple[NeighborList, torch.Tensor, torch.Tensor]:
    """PBC neighbour table plus unit edge vectors.

    Returns ``(nl, edge_dist, edge_unit)``; ``edge_unit[b, i, k]`` points from
    target i to (the periodic image of) source ``nl.src[b, i, k]``, and
    ``edge_dist`` is ``nl.dist`` clamped below at 1e-3 (zero-distance guard).
    With ``static_graph`` only the adsorbate-involving rows are recomputed,
    giving the same table.
    """
    if static_graph is not None:
        nl = radius_graph_pbc_incremental(
            batch.pos, batch.cell, batch.atom_mask, batch.ads_mask, static_graph,
            radius=cutoff, max_neighbors=max_neighbors, reps=cell_reps, max_ads=max_ads,
        )
    else:
        nl = radius_graph_pbc(
            batch.pos, batch.cell, batch.atom_mask,
            radius=cutoff, max_neighbors=max_neighbors, reps=cell_reps,
        )
    dist = torch.clamp(nl.dist, min=1e-3)
    unit = nl.vec / dist[..., None]
    unit = torch.where(nl.mask[..., None], unit, torch.zeros_like(unit))
    return nl, dist, unit
