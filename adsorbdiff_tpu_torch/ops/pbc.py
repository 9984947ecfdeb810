"""Fixed-shape periodic-boundary neighbour tables, in PyTorch.

Port of :mod:`adsorbdiff_tpu.ops.pbc`.  Each target atom gets a fixed ``K``
slots of its nearest in-radius periodic images (strict top-K; see the JAX
module's docstring for why that is the reference's production semantics).

Every table function here takes a leading system axis (``pos [B, N, 3]``,
``cell [B, 3, 3]``), like the JAX ``*_batched`` functions, and also accepts a
single system (``pos [N, 3]``), like the unbatched ones.

Top-k order.  ``jax.lax.top_k`` breaks ties toward the lower index, and the
invalid slots (distance ``big``) are all ties, so their ``cell_offsets``
depend on that order.  ``torch.topk`` promises no order among ties, so the
selection here is a stable ascending sort of d^2, which reproduces
``lax.top_k(-d^2)`` slot for slot wherever the two frameworks compute the
same d^2.  ``_two_stage_top_k`` was a TPU workaround for a slow top-k and has
no counterpart.

The same stable sort picks the Verlet candidate tables
(:class:`CandidateTable`), so their slots come in ``lax.top_k``'s order too.

Cell convention: rows of ``cell`` are the lattice vectors (a1, a2, a3), so
cartesian = fractional @ cell.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch


class NeighborList(NamedTuple):
    """Fixed-shape PBC neighbour table, ``[B, N, K]``.

    For target ``i`` and slot ``k`` the source atom is ``src[..., i, k]``,
    displaced by the integer cell offset ``cell_offsets[..., i, k]``;
    ``vec = pos[src] + offsets @ cell - pos[i]`` points from the target to the
    (periodic image of the) source.
    """

    src: torch.Tensor  # [B, N, K] int32
    cell_offsets: torch.Tensor  # [B, N, K, 3] int32
    vec: torch.Tensor  # [B, N, K, 3] float
    dist: torch.Tensor  # [B, N, K] float
    mask: torch.Tensor  # [B, N, K] bool


class StaticGraphPart(NamedTuple):
    """Slab-target x slab-source candidates, computed once per sampling
    trajectory (only the adsorbate moves).  ``neg_d2``/``flat_idx`` hold each
    slab target's K nearest slab-source images in the full table's
    encoding (flat index = src * n_images + image); adsorbate rows are
    all-invalid (they are refreshed every step)."""

    neg_d2: torch.Tensor  # [B, N, K] -d^2 (-big = invalid)
    flat_idx: torch.Tensor  # [B, N, K] int32


def compute_cell_reps(
    cell: np.ndarray, radius: float, pbc: Sequence[bool] = (True, True, True)
) -> Tuple[int, int, int]:
    """Host-side per-axis image counts for a radius cutoff: the plane spacing
    along a1 is 1/||(a2 x a3)/V||, so ceil(radius / spacing) images are
    needed.  A ``[B, 3, 3]`` input gives the elementwise max."""
    cell = np.asarray(cell, dtype=np.float64)
    if cell.ndim == 3:
        return tuple(  # type: ignore[return-value]
            int(max(compute_cell_reps(c, radius, pbc)[i] for c in cell)) for i in range(3)
        )
    cross = [np.cross(cell[1], cell[2]), np.cross(cell[2], cell[0]), np.cross(cell[0], cell[1])]
    vol = abs(float(np.dot(cell[0], cross[0])))
    reps = []
    for axis in range(3):
        if pbc[axis]:
            inv_min_dist = float(np.linalg.norm(cross[axis] / vol))
            reps.append(int(np.ceil(radius * inv_min_dist)))
        else:
            reps.append(0)
    return tuple(reps)  # type: ignore[return-value]


def auto_cell_reps(
    positions: Sequence[np.ndarray], cells: Sequence[np.ndarray], radius: float
) -> Tuple[int, int, int]:
    """Host-side image counts with vacuum pruning: an axis is dropped when
    the occupied fractional band leaves a cross-image gap wider than
    ``radius`` along that axis' plane normal (an OC20 slab's z-vacuum).  The
    result is the elementwise max over systems."""
    reps = [0, 0, 0]
    for pos, cell in zip(positions, cells):
        cell = np.asarray(cell, np.float64)
        pos = np.asarray(pos, np.float64)
        r = list(compute_cell_reps(cell, radius))
        cross = [np.cross(cell[1], cell[2]), np.cross(cell[2], cell[0]), np.cross(cell[0], cell[1])]
        vol = abs(float(np.dot(cell[0], cross[0])))
        frac = np.linalg.solve(cell.T, pos.T).T % 1.0
        for ax in range(3):
            if r[ax] == 0 or len(pos) == 0:
                continue
            spacing = vol / float(np.linalg.norm(cross[ax]))
            extent = float(frac[:, ax].max() - frac[:, ax].min())
            if spacing * (1.0 - extent) > radius:
                r[ax] = 0
        reps = [max(a, b) for a, b in zip(reps, r)]
    return tuple(reps)  # type: ignore[return-value]


def _offset_grid(reps: Tuple[int, int, int]) -> np.ndarray:
    """Integer offset lattice [-r, r]^3 -> [C, 3], home cell (0,0,0) first."""
    axes = [np.arange(-r, r + 1, dtype=np.int32) for r in reps]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    home = np.all(grid == 0, axis=1)
    return np.concatenate([grid[home], grid[~home]], axis=0)


def _with_batch(pos: torch.Tensor, *others: torch.Tensor):
    """Add a leading system axis to a single system's tensors."""
    if pos.dim() == 2:
        return True, (pos[None],) + tuple(o[None] for o in others)
    return False, (pos,) + tuple(others)


def _strip_batch(squeeze: bool, tup):
    return type(tup)(*(t[0] for t in tup)) if squeeze else tup


def _offsets(reps, cell: torch.Tensor):
    """([C, 3] int32 offsets, [B, C, 3] cartesian offsets)."""
    offsets_int = torch.as_tensor(_offset_grid(reps), device=cell.device)
    return offsets_int, offsets_int.to(cell.dtype) @ cell


def _smallest_k(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest along the last axis, ties toward the lower index
    (the order of ``lax.top_k(-d2, k)``)."""
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a: [B, N, F], idx: [B, ...] -> a[b, idx[b, ...], :] as [B, ..., F]."""
    b = a.shape[0]
    flat = idx.reshape(b, -1).long()
    out = torch.gather(a, 1, flat[..., None].expand(-1, -1, a.shape[-1]))
    return out.reshape(idx.shape + (a.shape[-1],))


def _pair_d2(src_pos: torch.Tensor, tgt_pos: torch.Tensor, offsets_cart: torch.Tensor) -> torch.Tensor:
    """d^2 of (target t, source s, image c): [B, T, S, C]."""
    src_img = src_pos[:, None, :, None, :] + offsets_cart[:, None, None, :, :]  # [B, 1, S, C, 3]
    diff = src_img - tgt_pos[:, :, None, None, :]  # [B, T, S, C, 3]
    return torch.sum(diff * diff, dim=-1)


def exact_sqrt(d2: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(d2, 0))`` of f32 ``d2``, correctly rounded (the IEEE square
    root, which ``jnp.sqrt`` gives).  On the card this is ``torch.sqrt``:
    CUDA's f32 sqrt is the IEEE root.  On the CPU ``torch.sqrt`` of a float
    tensor runs MKL's vector math library, whose first call in a process
    computed one 2048-element chunk about 11 bits deep (errors ~2e-3 at 5 A)
    in 9 of 116 fresh processes on a card machine's host (ROADMAP C.1), and
    which rounds 0.6% of values one ulp off even when it is right; there
    rsqrt's estimate in f64 and one Newton step are exact to f64's rounding,
    so rounding to f32 gives the correctly rounded root, call after call."""
    x = torch.clamp(d2, min=0.0)
    if x.device.type != "cpu":
        return torch.sqrt(x)
    x = x.double()
    y = x * torch.rsqrt(x)
    y = 0.5 * (y + x / y)
    return torch.where(x > 0, y, torch.zeros_like(y)).to(d2.dtype)


def _decode(pos, cell, offsets_int, d2, fidx) -> NeighborList:
    """Selected candidates (d^2, flat index) -> :class:`NeighborList`."""
    c = offsets_int.shape[0]
    big = torch.finfo(d2.dtype).max
    src = torch.div(fidx, c, rounding_mode="floor").to(torch.int32)
    img = torch.remainder(fidx, c).long()
    mask = d2 < big
    cell_offsets = offsets_int[img]  # [B, N, K, 3]
    vec = _gather_rows(pos, src) + cell_offsets.to(pos.dtype) @ cell[:, None] - pos[:, :, None, :]
    dist = exact_sqrt(d2)
    # neutralise invalid slots (src=0 gathers are harmless; keep vec finite)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    return NeighborList(
        src=torch.where(mask, src, torch.zeros_like(src)),
        cell_offsets=cell_offsets,
        vec=torch.where(mask[..., None], vec, zero),
        dist=torch.where(mask, dist, zero),
        mask=mask,
    )


def radius_graph_pbc(
    pos: torch.Tensor,
    cell: torch.Tensor,
    atom_mask: torch.Tensor,
    *,
    radius: float,
    max_neighbors: int,
    reps: Tuple[int, int, int],
) -> NeighborList:
    """Full PBC radius graph: the ``max_neighbors`` nearest in-radius images
    per target, excluding pairs with d^2 <= 1e-4 (self images, coincident
    atoms) and padded atoms."""
    squeeze, (pos, cell, atom_mask) = _with_batch(pos, cell, atom_mask)
    b, n = pos.shape[:2]
    offsets_int, offsets_cart = _offsets(reps, cell)
    c = offsets_int.shape[0]
    d2 = _pair_d2(pos, pos, offsets_cart)  # [B, N, N, C]
    valid = atom_mask[:, :, None, None] & atom_mask[:, None, :, None]
    valid = valid & (d2 > 1.0e-4) & (d2 <= radius * radius)
    big = torch.finfo(d2.dtype).max
    d2_top, fidx = _smallest_k(torch.where(valid, d2, big).reshape(b, n, n * c), max_neighbors)
    return _strip_batch(squeeze, _decode(pos, cell, offsets_int, d2_top, fidx))


def slab_static_topk(
    pos: torch.Tensor,
    cell: torch.Tensor,
    atom_mask: torch.Tensor,
    ads_mask: torch.Tensor,
    *,
    radius: float,
    max_neighbors: int,
    reps: Tuple[int, int, int],
) -> StaticGraphPart:
    """Static part of the incremental graph: slab targets x slab sources."""
    squeeze, (pos, cell, atom_mask, ads_mask) = _with_batch(pos, cell, atom_mask, ads_mask)
    b, n = pos.shape[:2]
    offsets_int, offsets_cart = _offsets(reps, cell)
    c = offsets_int.shape[0]
    slab = atom_mask & ~ads_mask
    d2 = _pair_d2(pos, pos, offsets_cart)
    valid = slab[:, :, None, None] & slab[:, None, :, None]
    valid = valid & (d2 > 1.0e-4) & (d2 <= radius * radius)
    big = torch.finfo(d2.dtype).max
    d2_top, fidx = _smallest_k(torch.where(valid, d2, big).reshape(b, n, n * c), max_neighbors)
    return _strip_batch(squeeze, StaticGraphPart(neg_d2=-d2_top, flat_idx=fidx.to(torch.int32)))


def radius_graph_pbc_incremental(
    pos: torch.Tensor,
    cell: torch.Tensor,
    atom_mask: torch.Tensor,
    ads_mask: torch.Tensor,
    static: StaticGraphPart,
    *,
    radius: float,
    max_neighbors: int,
    reps: Tuple[int, int, int],
    max_ads: int,
) -> NeighborList:
    """Incremental PBC radius graph: merge the static slab-slab candidates
    with fresh adsorbate-source candidates, and fully refresh the (at most
    ``max_ads``) adsorbate-target rows.  Equals :func:`radius_graph_pbc`
    because the two candidate pools are disjoint and the static pool already
    keeps the K best slab sources.  Requires adsorbate count <= ``max_ads``."""
    squeeze, (pos, cell, atom_mask, ads_mask) = _with_batch(pos, cell, atom_mask, ads_mask)
    if squeeze:
        static = StaticGraphPart(*(t[None] for t in static))
    b, n = pos.shape[:2]
    k, a = max_neighbors, max_ads
    offsets_int, offsets_cart = _offsets(reps, cell)
    c = offsets_int.shape[0]
    big = torch.finfo(pos.dtype).max
    r2 = radius * radius

    # fixed-size adsorbate index set: adsorbate rows first, lowest index first
    ads_val, ads_idx = torch.sort(ads_mask.to(torch.int32), dim=-1, descending=True, stable=True)
    ads_valid, ads_idx = ads_val[:, :a] > 0, ads_idx[:, :a]  # [B, A]
    ads_pos = _gather_rows(pos, ads_idx)  # [B, A, 3]

    # 1) full refresh of adsorbate-target rows: all sources, all images
    d2_t = _pair_d2(pos, ads_pos, offsets_cart)  # [B, A, N, C]
    valid_t = ads_valid[:, :, None, None] & atom_mask[:, None, :, None]
    valid_t = valid_t & (d2_t > 1.0e-4) & (d2_t <= r2)
    d2_t, fidx_t = _smallest_k(torch.where(valid_t, d2_t, big).reshape(b, a, n * c), k)

    # 2) fresh adsorbate-source candidates for every target
    d2_d = _pair_d2(ads_pos, pos, offsets_cart)  # [B, N, A, C]
    valid_d = atom_mask[:, :, None, None] & ads_valid[:, None, :, None]
    valid_d = valid_d & (d2_d > 1.0e-4) & (d2_d <= r2)
    d2_d = torch.where(valid_d, d2_d, big).reshape(b, n, a * c)
    fidx_d = ads_idx[:, :, None] * c + torch.arange(c, device=pos.device)
    fidx_d = fidx_d.reshape(b, 1, a * c).expand(b, n, a * c)

    # 3) merge static + dynamic pools per target (K + A*C candidates)
    cand_d2 = torch.cat([-static.neg_d2, d2_d], dim=2)
    cand_idx = torch.cat([static.flat_idx.long(), fidx_d], dim=2)
    d2_m, sel = _smallest_k(cand_d2, k)
    fidx_m = torch.gather(cand_idx, 2, sel)

    # 4) overwrite adsorbate-target rows (padded A-slots point at a real
    # atom whose merged row must survive)
    rows = ads_idx[:, :, None].expand(b, a, k)
    keep = ads_valid[:, :, None]
    d2_rows = torch.where(keep, d2_t, torch.gather(d2_m, 1, rows))
    idx_rows = torch.where(keep, fidx_t, torch.gather(fidx_m, 1, rows))
    d2 = d2_m.scatter(1, rows, d2_rows)
    fidx = fidx_m.scatter(1, rows, idx_rows)
    return _strip_batch(squeeze, _decode(pos, cell, offsets_int, d2, fidx))


class CandidateTable(NamedTuple):
    """Verlet candidate list for relaxation loops, ``[B, N, Kc]``.

    Port of the JAX ``CandidateTable``.  Each target keeps its ``Kc`` nearest
    periodic-image candidates from build time.  While every atom has moved by
    at most ``disp`` since the build and ``4 * disp < margin`` (``margin`` =
    the smallest ``d_Kc - d_K`` over full rows), the K nearest in-radius
    images among the candidates equal the full build's
    (:func:`refresh_from_candidates`); the relax loop rebuilds otherwise.
    """

    src: torch.Tensor  # [B, N, Kc] int32 source atom per candidate
    cell_offsets: torch.Tensor  # [B, N, Kc, 3] int32
    valid: torch.Tensor  # [B, N, Kc] bool (build-time pair validity)
    pos0: torch.Tensor  # [B, N, 3] positions at build time
    margin: torch.Tensor  # [B] min over full rows of d_Kc - d_K (inf if the table holds all)


def candidate_topk(
    pos: torch.Tensor,
    cell: torch.Tensor,
    atom_mask: torch.Tensor,
    *,
    k_cand: int,
    max_neighbors: int,
    reps: Tuple[int, int, int],
) -> CandidateTable:
    """The ``k_cand`` nearest periodic-image candidates per target atom, with
    no radius cap (the cutoff is applied at refresh time)."""
    squeeze, (pos, cell, atom_mask) = _with_batch(pos, cell, atom_mask)
    b, n = pos.shape[:2]
    offsets_int, offsets_cart = _offsets(reps, cell)
    c = offsets_int.shape[0]
    # tiny systems: the table holds every candidate; refresh still needs
    # >= max_neighbors slots to select from
    k_cand = max(min(k_cand, n * c), max_neighbors)
    d2 = _pair_d2(pos, pos, offsets_cart)  # [B, N, N, C]
    valid = atom_mask[:, :, None, None] & atom_mask[:, None, :, None] & (d2 > 1.0e-4)
    big = torch.finfo(d2.dtype).max
    d2_top, fidx = _smallest_k(torch.where(valid, d2, big).reshape(b, n, n * c), k_cand)
    vmask = d2_top < big
    d = exact_sqrt(d2_top)
    inf = torch.full((), float("inf"), dtype=d.dtype, device=d.device)
    if k_cand < n * c:
        # only full rows can have left a candidate out; padded targets and
        # under-full rows do not bound the margin
        full = vmask[..., -1] & atom_mask
        margin = torch.where(full, d[..., -1] - d[..., max_neighbors - 1], inf).amin(dim=1)
    else:  # the table holds every candidate: nothing can ever be left out
        margin = inf.expand(b).clone()
    src = torch.div(fidx, c, rounding_mode="floor").to(torch.int32)
    table = CandidateTable(
        src=torch.where(vmask, src, torch.zeros_like(src)),
        cell_offsets=offsets_int[torch.remainder(fidx, c)],
        valid=vmask,
        pos0=pos,
        margin=margin,
    )
    return _strip_batch(squeeze, table)


def refresh_from_candidates(
    pos: torch.Tensor,
    cell: torch.Tensor,
    cand: CandidateTable,
    *,
    radius: float,
    max_neighbors: int,
) -> NeighborList:
    """Neighbour table at the current positions from cached candidates: the
    same displacement formula and top-k order as :func:`radius_graph_pbc`,
    restricted to the candidates, at O(N * Kc) cost."""
    squeeze, (pos, cell) = _with_batch(pos, cell)
    if squeeze:
        cand = CandidateTable(*(t[None] for t in cand))
    off_cart = cand.cell_offsets.to(pos.dtype) @ cell[:, None]  # [B, N, Kc, 3]
    vec = _gather_rows(pos, cand.src) + off_cart - pos[:, :, None, :]
    d2 = torch.sum(vec * vec, dim=-1)
    big = torch.finfo(d2.dtype).max
    ok = cand.valid & (d2 > 1.0e-4) & (d2 <= radius * radius)
    d2_top, sel = _smallest_k(torch.where(ok, d2, big), max_neighbors)  # [B, N, K]
    mask = d2_top < big
    src = torch.gather(cand.src, 2, sel)
    cell_offsets = torch.gather(cand.cell_offsets, 2, sel[..., None].expand(-1, -1, -1, 3))
    v = torch.gather(vec, 2, sel[..., None].expand(-1, -1, -1, 3))
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    nl = NeighborList(
        src=torch.where(mask, src, torch.zeros_like(src)),
        cell_offsets=cell_offsets,
        vec=torch.where(mask[..., None], v, zero),
        dist=torch.where(mask, exact_sqrt(d2_top), zero),
        mask=mask,
    )
    return _strip_batch(squeeze, nl)


def _to_frac(x: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """Fractional f with f @ cell = x (cell^T f^T = x^T)."""
    return torch.linalg.solve(cell.transpose(-1, -2), x[..., None])[..., 0]


def _to_cart(frac: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    return (frac[..., None, :] @ cell)[..., 0, :]


def frac_wrap_center(vec: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """Wrap displacement vectors into the centred unit cell (frac in
    (-0.5, 0.5]).  ``torch.remainder`` is ``jnp.mod`` (sign of the divisor);
    ``torch.fmod`` would keep negative fractions negative."""
    frac = torch.remainder(torch.remainder(_to_frac(vec, cell), 1.0), 1.0)
    frac = torch.where(frac > 0.5, frac - 1.0, frac)
    return _to_cart(frac, cell)


def wrap_positions(pos: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """Wrap absolute positions into the home cell (frac in [0, 1)) in the row
    lattice, as the JAX package does everywhere."""
    frac = torch.remainder(torch.remainder(_to_frac(pos, cell), 1.0), 1.0)
    return _to_cart(frac, cell)


def min_image_diff(pos_pred: torch.Tensor, pos_target: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement between predicted and target positions."""
    return frac_wrap_center(pos_pred - pos_target, cell)
