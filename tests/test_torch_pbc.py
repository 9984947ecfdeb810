"""PyTorch port: periodic neighbour tables and wraps against the JAX package.

Tables are compared as the port promises: equal masks, equal per-row sets of
(src, cell offset) where the mask is true, and dist/vec of each such edge to
1e-5.  The order of tied slots is not compared (see the port's ops/pbc.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adsorbdiff_tpu.ops import pbc as jpbc
from adsorbdiff_tpu_torch.ops import pbc
from tests.port_bridge import assert_same_neighbors, to_numpy
from tests.test_pbc import make_system
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bench_like_batch(b=2, seed=0):
    """The bench.py workload's systems: 74 slab + 6 adsorbate atoms in an
    11.4 x 11.4 x 36 A cell (cutoff 12 A, K = 50, cell_reps (2, 2, 0))."""
    rng = np.random.default_rng(seed)
    pos, cells, ads = [], [], []
    for _ in range(b):
        cell = np.diag([11.4, 11.4, 36.0]).astype(np.float32)
        slab = (rng.random((74, 3)) * [1, 1, 0.35]) @ cell
        a = rng.random((6, 3)) * 1.6 + np.array([5, 5, 14.5])
        pos.append(np.concatenate([slab, a]).astype(np.float32))
        cells.append(cell)
        ads.append(np.array([False] * 74 + [True] * 6))
    return np.stack(pos), np.stack(cells), np.ones((b, 80), bool), np.stack(ads)


@pytest.mark.parametrize("n,k", [(12, 64), (16, 4), (14, 10)], ids=["all-edges", "cap-binds", "mid"])
def test_radius_graph_matches_jax(rng, n, k):
    pos, cell = make_system(rng, n=n)
    mask = np.ones(n, bool)
    mask[-2:] = False  # padded atoms: no edges to or from them
    radius = 5.0
    reps = jpbc.compute_cell_reps(cell, radius)
    assert pbc.compute_cell_reps(cell, radius) == reps
    want = jpbc.radius_graph_pbc(jnp.asarray(pos), jnp.asarray(cell), jnp.asarray(mask),
                                 radius=radius, max_neighbors=k, reps=reps)
    got = pbc.radius_graph_pbc(_t(pos), _t(cell), _t(mask), radius=radius, max_neighbors=k, reps=reps)
    assert got.src.dtype == torch.int32 and got.src.shape == (n, k)
    assert_same_neighbors(got, want)
    assert not to_numpy(got.mask)[-2:].any()


def test_radius_graph_batched_matches_jax(rng):
    systems = [make_system(rng, n=12) for _ in range(3)]
    pos = np.stack([p for p, _ in systems])
    cell = np.stack([c for _, c in systems])
    mask = np.ones((3, 12), bool)
    reps = jpbc.compute_cell_reps(cell, 5.0)
    want = jpbc.radius_graph_pbc_batched(jnp.asarray(pos), jnp.asarray(cell), jnp.asarray(mask),
                                         radius=5.0, max_neighbors=16, reps=reps)
    got = pbc.radius_graph_pbc(_t(pos), _t(cell), _t(mask), radius=5.0, max_neighbors=16, reps=reps)
    assert_same_neighbors(got, want)


@pytest.mark.parametrize("max_ads", [4, 8])
def test_incremental_graph_matches_jax_and_full(rng, max_ads):
    """slab_static_topk -> radius_graph_pbc_incremental after the adsorbate
    moved, against JAX's incremental table and the port's full build
    (the layout of tests/test_pbc.py::test_incremental_graph_matches_full)."""
    pos, cell = make_system(rng, n=14)
    ads = np.zeros(14, bool)
    ads[-3:] = True
    pos[-3:] += np.array([0.5, 0.5, 3.0], np.float32)
    atom_mask = np.ones(14, bool)
    atom_mask[-1] = ads[-1] = False
    radius, k = 5.0, 10
    reps = jpbc.compute_cell_reps(cell, radius)
    kw = dict(radius=radius, max_neighbors=k, reps=reps)

    static_j = jpbc.slab_static_topk(jnp.asarray(pos), jnp.asarray(cell), jnp.asarray(atom_mask), jnp.asarray(ads), **kw)
    static_t = pbc.slab_static_topk(_t(pos), _t(cell), _t(atom_mask), _t(ads), **kw)
    valid = np.asarray(static_j.neg_d2) > -np.finfo(np.float32).max
    np.testing.assert_array_equal(to_numpy(static_t.neg_d2) > -np.finfo(np.float32).max, valid)
    np.testing.assert_allclose(to_numpy(static_t.neg_d2)[valid], np.asarray(static_j.neg_d2)[valid], atol=1e-5)
    for row in range(14):
        assert set(to_numpy(static_t.flat_idx)[row][valid[row]]) == set(np.asarray(static_j.flat_idx)[row][valid[row]])

    moved = pos.copy()
    moved[-3:-1] += np.asarray(rng.normal(0, 1.5, (2, 3)), np.float32)
    want = jpbc.radius_graph_pbc_incremental(
        jnp.asarray(moved), jnp.asarray(cell), jnp.asarray(atom_mask), jnp.asarray(ads), static_j, max_ads=max_ads, **kw)
    got = pbc.radius_graph_pbc_incremental(
        _t(moved), _t(cell), _t(atom_mask), _t(ads), static_t, max_ads=max_ads, **kw)
    assert_same_neighbors(got, want)
    full = pbc.radius_graph_pbc(_t(moved), _t(cell), _t(atom_mask), **kw)
    assert_same_neighbors(got, full, atol=0.0)


def test_bench_like_slab_graphs_match_jax():
    """The sampling workload's geometry: full and incremental tables, batched."""
    pos, cell, mask, ads = _bench_like_batch()
    kw = dict(radius=12.0, max_neighbors=50, reps=(2, 2, 0))
    want = jpbc.radius_graph_pbc_batched(jnp.asarray(pos), jnp.asarray(cell), jnp.asarray(mask), **kw)
    got = pbc.radius_graph_pbc(_t(pos), _t(cell), _t(mask), **kw)
    assert_same_neighbors(got, want)

    static_j = jpbc.slab_static_topk_batched(jnp.asarray(pos), jnp.asarray(cell), jnp.asarray(mask), jnp.asarray(ads), **kw)
    static_t = pbc.slab_static_topk(_t(pos), _t(cell), _t(mask), _t(ads), **kw)
    moved = pos.copy()
    moved[:, 74:, :2] += np.array([3.1, -2.2], np.float32)  # the adsorbate slides over the slab
    want = jpbc.radius_graph_pbc_incremental_batched(
        jnp.asarray(moved), jnp.asarray(cell), jnp.asarray(mask), jnp.asarray(ads), static_j, max_ads=8, **kw)
    got = pbc.radius_graph_pbc_incremental(_t(moved), _t(cell), _t(mask), _t(ads), static_t, max_ads=8, **kw)
    assert_same_neighbors(got, want)


def _skewed_cell(rng):
    return (np.diag([5.0, 6.0, 30.0]) + rng.normal(0, 0.3, (3, 3)) * np.tri(3, 3, -1)).astype(np.float32)


@pytest.mark.parametrize("fn", ["wrap_positions", "frac_wrap_center"])
def test_wraps_match_jax_with_negative_coordinates(rng, fn):
    cell = _skewed_cell(rng)
    x = rng.normal(0, 12, (32, 3)).astype(np.float32)
    x[:8] = -np.abs(x[:8])  # negative coordinates: remainder, not fmod
    got = getattr(pbc, fn)(_t(x), _t(cell)).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(jpbc, fn)(jnp.asarray(x), jnp.asarray(cell))), atol=1e-5)
    # batched cells broadcast like the JAX functions
    cells = np.stack([cell, _skewed_cell(rng)])
    xb = x[:2]
    got_b = getattr(pbc, fn)(_t(xb), _t(cells)).numpy()
    np.testing.assert_allclose(got_b, np.asarray(getattr(jpbc, fn)(jnp.asarray(xb), jnp.asarray(cells))), atol=1e-5)


def test_min_image_diff_matches_jax(rng):
    cell = _skewed_cell(rng)
    a = rng.normal(0, 6, (16, 3)).astype(np.float32)
    b = rng.normal(0, 6, (16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        pbc.min_image_diff(_t(a), _t(b), _t(cell)).numpy(),
        np.asarray(jpbc.min_image_diff(jnp.asarray(a), jnp.asarray(b), jnp.asarray(cell))), atol=1e-5,
    )


def test_cell_reps_match_jax():
    pos, cell, _, _ = _bench_like_batch()
    for radius in (6.0, 12.0):
        assert pbc.compute_cell_reps(cell, radius) == jpbc.compute_cell_reps(cell, radius)
        assert pbc.auto_cell_reps(list(pos), list(cell), radius) == jpbc.auto_cell_reps(list(pos), list(cell), radius)
    assert pbc.auto_cell_reps(list(pos), list(cell), 12.0) == (2, 2, 0)  # the z-vacuum is pruned
    np.testing.assert_array_equal(pbc._offset_grid((1, 2, 0)), jpbc._offset_grid((1, 2, 0)))


def _candidate_cases(rng):
    """(pos, cell, mask, radius, k, reps, k_cand): a bench-like slab batch at
    the relaxation graph's widths, and tests/test_pbc.py systems with padded
    atoms (one small enough that the table holds every candidate)."""
    pos, cell, mask, _ = _bench_like_batch()
    yield pos, cell, mask, 12.0, 30, (2, 2, 0), 64
    systems = [make_system(rng, n=14) for _ in range(2)]
    spos = np.stack([p for p, _ in systems])
    scell = np.stack([c for _, c in systems])
    smask = np.ones((2, 14), bool)
    smask[:, -2:] = False
    reps = jpbc.compute_cell_reps(scell, 5.0)
    yield spos, scell, smask, 5.0, 10, reps, 24
    yield spos, scell, smask, 5.0, 10, reps, 10_000  # the table holds everything


@pytest.mark.parametrize("case", [0, 1, 2], ids=["bench-slab", "small-systems", "all-candidates"])
def test_candidate_refresh_matches_full_build_and_jax(rng, case):
    """candidate_topk -> refresh_from_candidates after a move within the
    margin equals the port's full build and JAX's refresh; margins equal JAX's."""
    pos, cell, mask, radius, k, reps, k_cand = list(_candidate_cases(rng))[case]
    cand = pbc.candidate_topk(_t(pos), _t(cell), _t(mask), k_cand=k_cand, max_neighbors=k, reps=reps)
    cand_j = jpbc.candidate_topk_batched(jnp.asarray(pos), jnp.asarray(cell), jnp.asarray(mask),
                                         k_cand=k_cand, max_neighbors=k, reps=reps)
    margin = to_numpy(cand.margin)
    np.testing.assert_allclose(margin, np.asarray(cand_j.margin), atol=1e-5)
    assert (case == 2) == bool(np.isinf(margin).all())
    # move every real atom by just under a quarter of the smallest finite margin
    finite = margin[np.isfinite(margin)]
    step = 0.24 * (finite.min() if finite.size else 1.0)
    direction = rng.normal(size=pos.shape)
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    moved = (pos + step * direction * mask[..., None]).astype(np.float32)
    got = pbc.refresh_from_candidates(_t(moved), _t(cell), cand, radius=radius, max_neighbors=k)
    full = pbc.radius_graph_pbc(_t(moved), _t(cell), _t(mask), radius=radius, max_neighbors=k, reps=reps)
    assert_same_neighbors(got, full)
    want = jpbc.refresh_from_candidates_batched(jnp.asarray(moved), jnp.asarray(cell), cand_j,
                                                radius=radius, max_neighbors=k)
    assert_same_neighbors(got, want)


def test_candidate_table_single_system_and_graph_dispatch(rng):
    """An unbatched system gives the batched table's rows, and generate_graph
    refreshes from a CandidateTable."""
    from adsorbdiff_tpu_torch.data.schema import AtomsBatch
    from adsorbdiff_tpu_torch.models.base import generate_graph, prepare_candidate_graph

    pos, cell, mask, radius, k, reps, k_cand = list(_candidate_cases(rng))[1]
    one = pbc.candidate_topk(_t(pos[0]), _t(cell[0]), _t(mask[0]), k_cand=k_cand, max_neighbors=k, reps=reps)
    both = pbc.candidate_topk(_t(pos), _t(cell), _t(mask), k_cand=k_cand, max_neighbors=k, reps=reps)
    for a, b in zip(one, both):
        torch.testing.assert_close(a, b[0], rtol=0, atol=0)
    b, n = mask.shape
    zeros = torch.zeros((b, n), dtype=torch.int32)
    batch = AtomsBatch(pos=_t(pos), atomic_numbers=zeros + 1, tags=zeros, fixed=zeros.bool(), cell=_t(cell),
                       natoms=torch.from_numpy(mask.sum(1).astype(np.int32)), atom_mask=_t(mask),
                       sid=torch.arange(b, dtype=torch.int32), fid=torch.zeros(b, dtype=torch.int32),
                       energy=torch.zeros(b), y_relaxed=torch.zeros(b), pos_relaxed=_t(pos))
    table = prepare_candidate_graph(batch, max_neighbors=k, cell_reps=reps, k_cand=k_cand)
    nl, dist, unit = generate_graph(batch, cutoff=radius, max_neighbors=k, cell_reps=reps, static_graph=table)
    nl_full, dist_full, unit_full = generate_graph(batch, cutoff=radius, max_neighbors=k, cell_reps=reps)
    assert_same_neighbors(nl, nl_full, atol=0.0)
    torch.testing.assert_close(dist, dist_full, rtol=0, atol=0)


def test_table_distances_are_the_ieee_root_on_every_call():
    """ROADMAP C.1: the tables' distances are the correctly rounded square
    root of d^2 (numpy's float32 sqrt, as ``jnp.sqrt``), and a second call
    gives them again bit for bit; ``torch.sqrt`` on the CPU runs MKL's vector
    math library, whose first call in a process computed one chunk about 11
    bits deep on a card machine's host, and which rounds some values one ulp
    off even when it is right."""
    rng = np.random.default_rng(21)
    d2 = np.concatenate([rng.uniform(0, 150, 4000), rng.uniform(0, 1e-3, 100),
                         [0.0, -1e-7, 1e-30, 1e-4, 1.0, 2.0, np.finfo(np.float32).max]]).astype(np.float32)
    want = np.sqrt(np.maximum(d2, 0))
    for _ in range(2):
        np.testing.assert_array_equal(pbc.exact_sqrt(_t(d2)).numpy(), want)
    pos, cell, mask, _ = _bench_like_batch()
    offsets_int, offsets_cart = pbc._offsets((2, 2, 0), _t(cell))
    d2_all = pbc._pair_d2(_t(pos), _t(pos), offsets_cart)
    b, n, _, c = d2_all.shape
    top, fidx = pbc._smallest_k(torch.where(d2_all > 1e-4, d2_all, torch.finfo(torch.float32).max).reshape(b, n, -1),
                                50)
    for _ in range(2):
        nl = pbc._decode(_t(pos), _t(cell), offsets_int, top, fidx)
        np.testing.assert_array_equal(nl.dist.numpy(), np.where(nl.mask.numpy(), np.sqrt(top.numpy()), 0))
