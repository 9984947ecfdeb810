"""The port's ``.adbin`` writer and C++ collator against the JAX package.

Exact comparisons throughout: the file bytes, and every batch tensor bit for
bit with its dtype.  JAX's side is its ``write_shard_bin`` (pure numpy) and
its pure ``ShardDataset`` + ``collate``: its native library is never built
from here.
"""
import numpy as np
import pytest
import torch

from adsorbdiff_tpu.data.native import write_shard_bin as jax_write_shard_bin
from adsorbdiff_tpu.data.schema import System as JaxSystem
from adsorbdiff_tpu.data.schema import collate as jax_collate
from adsorbdiff_tpu_torch.common.registry import registry
from adsorbdiff_tpu_torch.data import native
from adsorbdiff_tpu_torch.data.buckets import BucketedBatcher
from adsorbdiff_tpu_torch.data.native import NativeShardDataset, write_shard_bin
from adsorbdiff_tpu_torch.data.schema import System, collate
from adsorbdiff_tpu_torch.data.store import ShardDataset, write_shard
from tests.port_bridge import BATCH_FIELDS
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)


def make_systems(seed, sizes, forces=True):
    """The same random systems as the port's and JAX's System (the second
    without an energy)."""
    rng = np.random.default_rng(seed)
    port, jax = [], []
    for i, n in enumerate(sizes):
        kw = dict(pos=rng.random((n, 3)).astype(np.float32) * 9, atomic_numbers=rng.integers(1, 80, n),
                  cell=np.diag(rng.uniform(6, 12, 3)).astype(np.float32), tags=rng.integers(0, 3, n),
                  fixed=rng.integers(0, 2, n).astype(bool), sid=3 * i + 1, fid=-i,
                  energy=None if i == 1 else float(rng.normal()), y_relaxed=float(rng.normal()),
                  pos_relaxed=rng.random((n, 3)).astype(np.float32),
                  forces=rng.normal(0, 1, (n, 3)).astype(np.float32) if forces else None)
        port.append(System(**kw))
        jax.append(JaxSystem(**kw))
    return port, jax


@pytest.mark.parametrize("case", ("forces", "no-forces", "one", "empty"))
def test_adbin_bytes_equal_jax(tmp_path, case):
    sizes = {"forces": [5, 17, 40, 1, 23], "no-forces": [7, 3, 11], "one": [13], "empty": []}[case]
    port, jax = make_systems(1, sizes, forces=case != "no-forces")
    ours = write_shard_bin(str(tmp_path / "port"), port)
    theirs = jax_write_shard_bin(str(tmp_path / "jax"), jax)
    assert ours.endswith(".adbin")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    ds = NativeShardDataset({"src": str(tmp_path / "jax")})  # JAX's file, the suffix found
    assert len(ds) == len(sizes) and ds.has_forces == (case in ("forces", "one"))
    np.testing.assert_array_equal(ds.natoms_array(), np.asarray(sizes, np.int32))


@pytest.fixture
def shards(tmp_path):
    port, jax = make_systems(2, [5, 17, 40, 1, 23, 9, 31, 12])
    write_shard(str(tmp_path / "py"), port)
    write_shard_bin(str(tmp_path / "nat"), port)
    return NativeShardDataset({"src": str(tmp_path / "nat.adbin")}), ShardDataset({"src": str(tmp_path / "py")}), jax


def assert_same_batch(got, want):
    for name in BATCH_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.device.type == "cpu", name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("with_forces", (True, False))
# the last case pads past the collator's 1 MiB threshold, so its thread pool fills it
@pytest.mark.parametrize("idx,pad", (([0, 5, 7, 2], 3), ([3], 0), ([1, 1, 6, 0, 4, 2, 7, 3, 5], 8),
                                     (list(range(8)) * 4, 800)))
def test_collate_indices_equals_collate_and_jax(shards, idx, pad, with_forces):
    nat, py, jax = shards
    max_atoms = int(nat.natoms_array()[idx].max()) + pad
    got = nat.collate_indices(idx, max_atoms, with_forces=with_forces)
    assert_same_batch(got, collate([py[i] for i in idx], max_atoms=max_atoms, with_forces=with_forces,
                                   device="cpu"))
    theirs = jax_collate([jax[i] for i in idx], max_atoms=max_atoms, with_forces=with_forces)
    for name in BATCH_FIELDS:
        w = getattr(theirs, name)
        if w is None:
            assert getattr(got, name) is None, name
        else:
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(w), err_msg=name)


def test_collate_indices_raises_on_a_bad_index_or_too_many_atoms(shards):
    nat, _, _ = shards
    for bad in ([999], [-1], [0, 8]):
        with pytest.raises(ValueError):
            nat.collate_indices(bad, max_atoms=64)
    with pytest.raises(ValueError):
        nat.collate_indices([2], max_atoms=39)  # 40 atoms
    with pytest.raises(IndexError):
        nat[8]


def test_getitem_equals_shard_dataset(shards):
    nat, py, _ = shards
    for i in range(len(py)):
        a, b = nat[i], py[i]
        for name in ("pos", "atomic_numbers", "tags", "fixed", "cell", "pos_relaxed", "forces"):
            assert getattr(a, name).dtype == getattr(b, name).dtype
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert (a.sid, a.fid, a.energy, a.y_relaxed) == (b.sid, b.fid, b.energy, b.y_relaxed)


def test_shard_without_forces_gives_none(tmp_path):
    port, _ = make_systems(3, [4, 6], forces=False)
    ds = NativeShardDataset({"src": write_shard_bin(str(tmp_path / "x"), port)})
    assert not ds.has_forces
    assert ds.collate_indices([0, 1], 8, with_forces=True).forces is None
    assert ds[1].forces is None


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_batcher_over_native_equals_batcher_over_shards(shards, seed):
    nat, py, _ = shards
    for epoch in (0, 1):
        a = BucketedBatcher(nat, 3, seed=seed, with_forces=True)
        b = BucketedBatcher(py, 3, seed=seed, with_forces=True)
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        got, want = list(a), list(b)
        assert len(got) == len(want) > 0
        for x, y in zip(got, want):
            assert_same_batch(x, y)


def test_registry_names_the_datasets():
    assert registry.get_dataset_class("adbin") is NativeShardDataset
    assert registry.get_dataset_class("shards") is ShardDataset
    assert registry.get_dataset_class("lmdb") is ShardDataset  # config compatibility, as in JAX


def test_no_native_switch_raises(shards, monkeypatch):
    nat, _, _ = shards
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("ADSORBDIFF_TPU_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="unavailable"):
        NativeShardDataset({"src": nat.config["src"]})
