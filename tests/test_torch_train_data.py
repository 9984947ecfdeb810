"""PyTorch port: the training data pipeline against the JAX package.

Shards written by either package read back identically in both; for a seed
and an epoch both batchers yield the same batch plan (exact equality: the
same numpy draws and the same padding).  Also the prefetcher and the config
loader (``includes``, dotted overrides).
"""
import os
import threading

import numpy as np
import pytest
import torch

from adsorbdiff_tpu.common.config import load_config as jax_load_config
from adsorbdiff_tpu.data.buckets import BucketedBatcher as JaxBucketedBatcher
from adsorbdiff_tpu.data.schema import System as JaxSystem
from adsorbdiff_tpu.data.store import ShardDataset as JaxShardDataset
from adsorbdiff_tpu.data.store import write_shard as jax_write_shard
from adsorbdiff_tpu_torch.common.config import create_dict_from_args, load_config, merge_dicts
from adsorbdiff_tpu_torch.data.buckets import BucketedBatcher
from adsorbdiff_tpu_torch.data.prefetch import Prefetcher, to_device
from adsorbdiff_tpu_torch.data.schema import System
from adsorbdiff_tpu_torch.data.store import ShardDataset, write_shard
from tests.port_bridge import BATCH_FIELDS, to_numpy
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("pos", "atomic_numbers", "tags", "fixed", "pos_relaxed", "forces", "cell", "sid", "fid", "energy",
          "y_relaxed")


def _systems(cls, seed, n_sys=23, forces=True):
    """Ragged systems (5-30 atoms) so that the batchers use several buckets."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_sys):
        n = int(rng.integers(5, 31))
        cell = np.diag(rng.uniform(6, 12, 3)).astype(np.float32)
        out.append(cls(
            pos=rng.random((n, 3)).astype(np.float32) * 6, atomic_numbers=rng.integers(1, 80, n), cell=cell,
            tags=rng.integers(0, 3, n), fixed=rng.random(n) > 0.5, sid=100 + i, fid=i % 3,
            energy=float(rng.normal()), y_relaxed=float(rng.normal()),
            pos_relaxed=rng.random((n, 3)).astype(np.float32) * 6,
            forces=rng.normal(size=(n, 3)).astype(np.float32) if forces else None,
        ))
    return out


def _assert_same_systems(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        for f in FIELDS:
            x, y = getattr(a[i], f), getattr(b[i], f)
            if x is None or y is None:
                assert x is None and y is None, f
            elif f in ("energy", "y_relaxed"):  # stored as float32
                assert np.float32(x) == np.float32(y), (i, f)
            else:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{i} {f}")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shards_read_back_the_same_in_both(tmp_path, writer):
    systems = _systems(JaxSystem if writer == "jax" else System, 0)
    (jax_write_shard if writer == "jax" else write_shard)(str(tmp_path / "s"), systems)
    path = str(tmp_path / "s.adshard.npz")
    assert os.listdir(tmp_path) == ["s.adshard.npz"]  # no temporary file left behind
    port, jax_ds = ShardDataset({"src": path}), JaxShardDataset({"src": path})
    _assert_same_systems(port, jax_ds)
    _assert_same_systems(port, systems)
    np.testing.assert_array_equal(port.natoms_array(), jax_ds.natoms_array())


def test_directory_of_shards_and_manual_sharding(tmp_path):
    systems = _systems(System, 1, n_sys=10, forces=False)
    write_shard(str(tmp_path / "a"), systems[:4])
    write_shard(str(tmp_path / "b"), systems[4:])
    cfg = {"src": str(tmp_path), "shard": 1, "total_shards": 3}
    port, jax_ds = ShardDataset(cfg), JaxShardDataset(cfg)
    assert len(port) == 3
    _assert_same_systems(port, jax_ds)


@pytest.mark.parametrize("shuffle,batch_size", [(True, 4), (False, 4), (True, 5)])
def test_batch_plans_match_jax_for_two_epochs(tmp_path, shuffle, batch_size):
    write_shard(str(tmp_path / "s"), _systems(System, 2, n_sys=37))
    src = {"src": str(tmp_path / "s.adshard.npz")}
    kw = dict(batch_size=batch_size, seed=7, shuffle=shuffle)
    port, jax_b = BucketedBatcher(ShardDataset(src), **kw), JaxBucketedBatcher(JaxShardDataset(src), **kw)
    assert port.bucket_edges == jax_b.bucket_edges and len(port.bucket_edges) > 1
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_b.set_epoch(epoch)
        got, want = list(port), list(jax_b)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            assert g.device.type == "cpu"  # collated on the host; the prefetcher copies
            for name in BATCH_FIELDS:
                np.testing.assert_array_equal(to_numpy(getattr(g, name)), np.asarray(getattr(w, name)), err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(batch_size=6, shuffle=True, atom_budget=64),
    dict(batch_size=6, shuffle=False, atom_budget=64),
    dict(batch_size=8, shuffle=True, atom_budget=100),
    dict(batch_size=5, shuffle=True, atom_budget=90),
    dict(batch_size=4, shuffle=True, atom_budget=10),
], ids=["budget", "budget-unshuffled", "budget-100", "budget-90", "budget-below-edges"])
def test_atom_balanced_batch_plans_match_jax(tmp_path, kw):
    """Atom-balanced batches (each bucket's batch size min(batch_size,
    atom_budget // edge), at least 1; JAX's other options at their
    defaults): the port's plans equal JAX's index for index for two epochs,
    and so do the collated batches, the tail repeats up to each bucket's
    batch size included."""
    write_shard(str(tmp_path / "s"), _systems(System, 3, n_sys=41))
    src = {"src": str(tmp_path / "s.adshard.npz")}
    port = BucketedBatcher(ShardDataset(src), seed=5, **kw)
    jax_b = JaxBucketedBatcher(JaxShardDataset(src), seed=5, **kw)
    assert port.bucket_edges == jax_b.bucket_edges and len(port.bucket_edges) > 1
    sizes = {port._bucket_batch_size(e) for e in port.bucket_edges}
    assert sizes == {jax_b._bucket_batch_size(e) for e in jax_b.bucket_edges}
    assert len(sizes) > 1 or max(sizes) == 1  # the budget gives buckets different batch sizes
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_b.set_epoch(epoch)
        got_plan, want_plan = port._plan(), jax_b._plan()
        assert [(e, c.tolist()) for e, c in got_plan] == [(e, c.tolist()) for e, c in want_plan]
        got, want = list(port), list(jax_b)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            for name in BATCH_FIELDS:
                np.testing.assert_array_equal(to_numpy(getattr(g, name)), np.asarray(getattr(w, name)), err_msg=name)


def test_trainer_atom_budget_reaches_every_batcher(tmp_path):
    """``optim.atom_budget`` gives the training, validation and relax
    batchers of a trainer the JAX trainer's atom-balanced plans."""
    from adsorbdiff_tpu.train.trainer import DenoisingTrainer as JaxDenoisingTrainer
    from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer
    from tests.test_trainer import config_for

    for name, seed in (("train", 1), ("val", 2), ("relax", 3)):
        write_shard(str(tmp_path / name), _systems(System, seed, n_sys=19, forces=False))
    src = {name: str(tmp_path / f"{name}.adshard.npz") for name in ("train", "val", "relax")}
    cfg = config_for(src["train"], src["val"], run_dir=str(tmp_path), batch_size=6, eval_batch_size=6, atom_budget=70)
    cfg["task"]["relax_dataset"] = {"src": src["relax"]}
    port, jax_t = DenoisingTrainer(dict(cfg, cpu=True)), JaxDenoisingTrainer(cfg, mesh=None)
    for which in ("train_batcher", "val_batcher", "relax_batcher"):
        got, want = getattr(port, which), getattr(jax_t, which)
        assert got.atom_budget == want.atom_budget == 70, which
        assert [(e, c.tolist()) for e, c in got._plan()] == [(e, c.tolist()) for e, c in want._plan()], which
        assert min(got._bucket_batch_size(e) for e in got.bucket_edges) < 6, which  # the budget shrank a bucket


def test_prefetcher_yields_in_order_and_stops_early():
    assert list(Prefetcher(range(50), lambda x: x * 2, depth=3)) == [2 * i for i in range(50)]
    it = iter(Prefetcher(range(1000), depth=2))
    assert [next(it) for _ in range(5)] == list(range(5))
    it.close()  # the worker is released, not left parked on a full queue
    for t in threading.enumerate():
        if t.name == "batch-prefetch":
            t.join(timeout=5)
            assert not t.is_alive()


def test_prefetcher_reraises_worker_errors():
    def bad():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(Prefetcher(bad()))


def test_to_device_on_the_host_keeps_the_batch():
    write_batch = BucketedBatcher(_ListDataset(_systems(System, 3, n_sys=4)), 4, shuffle=False)
    batch = next(iter(write_batch))
    got = to_device(batch, torch.device("cpu")).get()
    for name in BATCH_FIELDS:
        a, b = getattr(got, name), getattr(batch, name)
        assert (a is None and b is None) or torch.equal(a, b)


class _ListDataset(list):
    def natoms_array(self):
        return np.asarray([s.natoms for s in self])


def test_config_includes_and_overrides_match_jax():
    path = os.path.join(REPO, "configs/denoising/painn_so3.yml")
    got, want = load_config(path), jax_load_config(path)
    assert got == want
    cfg, dups = merge_dicts(got[0], create_dict_from_args(["--dataset.1.src=/v", "--optim.batch_size=8"]))
    assert cfg["dataset"] == [{"src": "data/train"}, {"src": "/v"}] and cfg["optim"]["batch_size"] == 8
    assert cfg["optim"]["lr_initial"] == 1e-4 and cfg["model"]["cell_reps"] == "auto"
    assert dups == ["dataset.1.src", "optim.batch_size"]


def test_config_main_file_overrides_its_includes_with_a_warning(tmp_path):
    """eqv2_so3.yml sets optim keys that base.yml sets too: the main file
    wins with a warning (the reference's rule), so the port's CLI loads it
    and eqv2_conditional.yml; two includes that set one key are an error.
    The JAX package files the main file's overrides as errors and its
    build_config refuses these two configs."""
    for name in ("eqv2_so3.yml", "eqv2_conditional.yml"):
        path = os.path.join(REPO, "configs/denoising", name)
        cfg, warn, err = load_config(path)
        assert warn == ["optim.batch_size", "optim.eval_batch_size", "optim.lr_initial"] and err == []
        assert cfg["optim"]["batch_size"] == 12 and cfg["optim"]["lr_initial"] == 4e-4
        assert cfg["optim"]["clip_grad_norm"] == 100 and cfg["model"]["cell_reps"] == "auto"
        assert ("energy_encoding" in cfg["model"]) == (name == "eqv2_conditional.yml")
        assert jax_load_config(path)[2] == warn
    (tmp_path / "a.yml").write_text("optim:\n  lr: 0.1\n")
    (tmp_path / "b.yml").write_text("optim:\n  lr: 0.2\n")
    (tmp_path / "main.yml").write_text("includes:\n  - a.yml\n  - b.yml\n")
    cfg, warn, err = load_config(str(tmp_path / "main.yml"))
    assert cfg["optim"]["lr"] == 0.2 and err == ["optim.lr"] and warn == []
