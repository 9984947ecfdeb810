"""The port's transforms, irreps, target metadata, neighbour counts and batch
plans against the JAX package's.

Tolerances: the irreps matrices and tensor decompositions to 1e-12 (float64);
neighbour counts, metadata and batch plans exactly.
"""
import types

import numpy as np
import pytest

from adsorbdiff_tpu.common.irreps import cg_change_mat as jax_cg_change_mat
from adsorbdiff_tpu.common.irreps import irreps_sum as jax_irreps_sum
from adsorbdiff_tpu.data import metadata as jax_metadata
from adsorbdiff_tpu.data.buckets import BucketedBatcher as JaxBucketedBatcher
from adsorbdiff_tpu.data.schema import System as JaxSystem
from adsorbdiff_tpu.data.store import ShardDataset as JaxShardDataset
from adsorbdiff_tpu.data.transforms import DataTransforms as JaxDataTransforms
from adsorbdiff_tpu.data.transforms import decompose_tensor as jax_decompose_tensor
from adsorbdiff_tpu_torch.common.irreps import cg_change_mat, irreps_sum
from adsorbdiff_tpu_torch.data import metadata
from adsorbdiff_tpu_torch.data.buckets import BucketedBatcher
from adsorbdiff_tpu_torch.data.schema import System
from adsorbdiff_tpu_torch.data.store import ShardDataset, write_shard
from adsorbdiff_tpu_torch.data.transforms import TRANSFORM_FNS, DataTransforms, decompose_tensor
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-12
DECOMPOSE = {"tensor": "stress", "rank": 2,
             "decomposition": {"stress_iso": {"irrep_dim": 0}, "stress_anti": {"irrep_dim": 1},
                               "stress_aniso": {"irrep_dim": 2}}}


def test_irreps_equal_jax():
    np.testing.assert_allclose(cg_change_mat(2), jax_cg_change_mat(2), rtol=0, atol=TOL)
    assert cg_change_mat(2).dtype == np.float64
    assert [irreps_sum(l) for l in range(6)] == [jax_irreps_sum(l) for l in range(6)] == [1, 4, 9, 16, 25, 36]
    for fn in (cg_change_mat, jax_cg_change_mat):
        with pytest.raises(NotImplementedError):
            fn(3)
    # an orthogonal change of basis: a tensor's norm is its components' norm
    m = cg_change_mat(2)
    np.testing.assert_allclose(m.T @ m, np.eye(9), rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_decompose_tensor_equals_jax(seed):
    """On plain objects, as JAX's own test runs it: each irrep's components
    within 1e-12, through the function and through DataTransforms (whose
    normalizer entry is skipped)."""
    stress = np.random.default_rng(seed).normal(size=(3, 3))
    for via in ("function", "transforms"):
        ours, theirs = types.SimpleNamespace(stress=stress), types.SimpleNamespace(stress=stress)
        if via == "function":
            ours, theirs = decompose_tensor(ours, DECOMPOSE), jax_decompose_tensor(theirs, DECOMPOSE)
        else:
            cfg = {"normalizer": {"mean": 1.0}, "decompose_tensor": DECOMPOSE}
            ours, theirs = DataTransforms(cfg)(ours), JaxDataTransforms(cfg)(theirs)
        for key, size in (("stress_iso", 1), ("stress_anti", 3), ("stress_aniso", 5)):
            assert getattr(ours, key).shape == (size,) and getattr(ours, key).dtype == np.float64
            np.testing.assert_allclose(getattr(ours, key), getattr(theirs, key), rtol=0, atol=TOL)
    # the trace lands in the 0e component, the antisymmetric part in 1e
    np.testing.assert_allclose(ours.stress_iso[0], np.trace(stress) / np.sqrt(3), rtol=0, atol=TOL)
    sym = types.SimpleNamespace(stress=stress + stress.T)
    np.testing.assert_allclose(decompose_tensor(sym, DECOMPOSE).stress_anti, 0.0, rtol=0, atol=TOL)
    assert "decompose_tensor" in TRANSFORM_FNS


def test_decompose_tensor_raises_on_a_system_as_jax():
    """A System has __slots__: setting the irrep attributes of its cell, a
    3 x 3 tensor, raises in both."""
    kw = dict(pos=np.zeros((2, 3)), atomic_numbers=[1, 2], cell=np.eye(3))
    for fn, system in ((decompose_tensor, System(**kw)), (jax_decompose_tensor, JaxSystem(**kw))):
        with pytest.raises(AttributeError, match="stress_iso"):
            fn(system, dict(DECOMPOSE, tensor="cell"))
    bad = types.SimpleNamespace(stress=np.eye(3))
    with pytest.raises(NotImplementedError):
        decompose_tensor(bad, dict(DECOMPOSE, rank=1))


def make_systems(seed, sizes):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        cell = np.diag(rng.uniform(5, 10, 3)).astype(np.float32)
        cell[0, 1] = rng.uniform(-1, 1)  # a skewed cell
        out.append(dict(pos=rng.random((n, 3)).astype(np.float32) @ cell, atomic_numbers=rng.integers(1, 80, n),
                        cell=cell, tags=rng.integers(0, 3, n), fixed=rng.integers(0, 2, n).astype(bool), sid=i,
                        fid=i, energy=float(rng.normal(-2.0 * n, 0.3 * n)), y_relaxed=float(rng.normal()),
                        forces=rng.normal(0, 1, (n, 3)).astype(np.float32)))
    return [System(**kw) for kw in out], [JaxSystem(**kw) for kw in out]


def test_shard_dataset_applies_transforms_as_jax(tmp_path):
    """``transforms`` are callables applied in order to every system read."""
    port, jax = make_systems(4, [5, 9, 3])
    write_shard(str(tmp_path / "s"), port)

    def shift(s):
        s.pos = s.pos + 1.0
        return s

    def scale(s):
        s.energy = 2.0 * s.energy
        return s

    ours = ShardDataset({"src": str(tmp_path / "s"), "transforms": [shift, scale]})
    theirs = JaxShardDataset({"src": str(tmp_path / "s"), "transforms": [shift, scale]})
    plain = ShardDataset({"src": str(tmp_path / "s")})
    for i in range(3):
        np.testing.assert_array_equal(ours[i].pos, theirs[i].pos)
        np.testing.assert_array_equal(ours[i].pos, plain[i].pos + 1.0)
        assert ours[i].energy == theirs[i].energy == 2.0 * plain[i].energy


@pytest.mark.parametrize("cutoff,max_neighbors,reps,limit", (
    (6.0, 50, (2, 2, 0), None), (4.5, 7, (1, 1, 1), None), (12.0, 50, (2, 2, 0), 5), (3.0, 1000, (0, 0, 0), None)))
def test_neighbor_counts_equal_jax(cutoff, max_neighbors, reps, limit):
    """Integer counts equal exactly, and a system with two atoms at one
    position counts neither as the other's neighbour."""
    port, jax = make_systems(5, [1, 12, 30, 7, 40, 20, 2])
    port[6].pos[1] = port[6].pos[0]
    jax[6].pos[1] = jax[6].pos[0]
    got = metadata.neighbor_counts(port, cutoff, max_neighbors, reps, limit, device="cpu")
    want = jax_metadata.neighbor_counts(jax, cutoff, max_neighbors, reps, limit)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert len(got) == (limit or 7) and got.max() > 0


def test_neighbor_counts_need_a_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    port, _ = make_systems(6, [3])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        metadata.neighbor_counts(port)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_target_metadata_equals_jax(seed):
    port, jax = make_systems(seed, np.random.default_rng(seed).integers(3, 40, 25).tolist())
    assert metadata.guess_target_metadata(port, num_samples=10) == jax_metadata.guess_target_metadata(jax, 10)
    energies = np.asarray([s.energy for s in port])
    natoms = np.asarray([s.natoms for s in port])
    for e in (energies, energies / natoms, np.full(25, 3.0)):
        assert metadata.uses_extensive(e, natoms) == jax_metadata.uses_extensive(e, natoms)
    # no energies, one system without forces: neither target is described
    for s, t in zip(port[:4], jax[:4]):
        s.energy = t.energy = None
    port[2].forces = jax[2].forces = None
    assert metadata.guess_target_metadata(port[:4]) == jax_metadata.guess_target_metadata(jax[:4]) == {}


class _Sizes:
    """A dataset as the batchers see it: atom counts only."""

    def __init__(self, natoms):
        self._natoms = np.asarray(natoms)

    def natoms_array(self):
        return self._natoms

    def __len__(self):
        return len(self._natoms)


PLAN_CASES = {
    "default": dict(batch_size=4),
    "edges": dict(batch_size=5, bucket_edges=[16, 32, 48]),
    "unshuffled": dict(batch_size=4, shuffle=False),
    "drop_last": dict(batch_size=4, drop_last=True, num_buckets=3),
    "budget-multiple": dict(batch_size=8, atom_budget=120, multiple_of=2),
    "budget-drop": dict(batch_size=6, atom_budget=90, multiple_of=3, drop_last=True),
    "neighbors": dict(batch_size=4, mode="neighbors"),
    "neighbors-budget": dict(batch_size=6, mode="neighbors", num_buckets=2, atom_budget=100, multiple_of=2),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_batch_plans_equal_jax(case):
    """Three seeds x two epochs: the same (edge, indices) plan, the same
    edges, batch sizes and lengths."""
    rng = np.random.default_rng(8)
    ds = _Sizes(rng.integers(3, 48, 61))
    kw = dict(PLAN_CASES[case])
    if kw.get("mode") == "neighbors":
        kw["sizes"] = rng.integers(10, 900, 61)
    for seed in (0, 1, 2):
        ours, theirs = BucketedBatcher(ds, seed=seed, **kw), JaxBucketedBatcher(ds, seed=seed, **kw)
        assert ours.bucket_edges == theirs.bucket_edges
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = ours._plan(), theirs._plan()
            assert len(got) == len(want) == len(ours) > 0
            for (e1, c1), (e2, c2) in zip(got, want):
                assert e1 == e2
                np.testing.assert_array_equal(c1, c2)
            assert [ours._bucket_batch_size(e) for e in ours.bucket_edges] == [
                theirs._bucket_batch_size(e) for e in theirs.bucket_edges]


def test_batcher_options_raise_as_jax():
    ds = _Sizes([5, 9, 40])
    for kw, err in ((dict(mode="edges"), "mode"), (dict(batch_size=5, multiple_of=2), "multiple"),
                    (dict(mode="neighbors"), "neighbor counts"), (dict(mode="neighbors", sizes=[1, 2]), "length"),
                    (dict(bucket_edges=[8, 16]), "exceeds")):
        kw = dict(dict(batch_size=4), **kw)
        for cls in (BucketedBatcher, JaxBucketedBatcher):
            with pytest.raises(ValueError, match=err):
                cls(ds, **kw)


def test_neighbors_mode_batches_pad_to_their_bucket(tmp_path):
    """A neighbours-mode epoch over real systems: every system once (tails
    repeat), each batch padded to its bucket's own atom edge."""
    port, _ = make_systems(9, [4, 30, 11, 25, 6, 17, 40, 9])
    write_shard(str(tmp_path / "s"), port)
    ds = ShardDataset({"src": str(tmp_path / "s")})
    sizes = metadata.neighbor_counts(ds, 5.0, 20, device="cpu")
    batcher = BucketedBatcher(ds, 2, seed=3, mode="neighbors", sizes=sizes, num_buckets=2)
    seen = set()
    for batch in batcher:
        assert batch.pos.shape[1] in batcher.bucket_edges and batch.pos.shape[1] % 8 == 0
        assert int(batch.natoms.max()) <= batch.pos.shape[1]
        seen.update(batch.sid.tolist())
    assert seen == set(range(8))
