"""The port's dataset builders against the JAX package's: each writes, from
the same trajectories or placements, shards equal column for column (every
array bit for bit, with its dtype), and the VASP writers the same text."""
import os

import numpy as np
import pytest

from adsorbdiff_tpu import dataset_prep as jax_prep
from adsorbdiff_tpu.data.store import ShardDataset as JaxShardDataset
from adsorbdiff_tpu.runtime.atoms import Atoms as JaxAtoms
from adsorbdiff_tpu_torch import dataset_prep
from adsorbdiff_tpu_torch.data.schema import System
from adsorbdiff_tpu_torch.data.store import ShardDataset, write_shard
from adsorbdiff_tpu_torch.runtime.atoms import Atoms
from adsorbdiff_tpu_torch.runtime.trajectory import Trajectory
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)


def assert_same_shard(ours, theirs):
    got, want = np.load(ours), np.load(theirs)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def traj_tree(root, seed, n_sids=6):
    """root/<sid>/site<k>.adtraj.npz, two or three sites a sid (one sid
    without energies, one with a bare surface trajectory), 8 atoms each."""
    rng = np.random.default_rng(seed)
    for sid in range(n_sids):
        d = os.path.join(root, str(100 + sid))
        os.makedirs(d)
        for site in range(int(rng.integers(2, 4))):
            n = 8
            energy = None if sid == 2 else np.asarray([0.0, rng.normal(-1.0, 1.0)], np.float32)
            Trajectory(positions=rng.random((2, n, 3)).astype(np.float32) * 5, numbers=rng.integers(1, 30, n),
                       cell=np.eye(3, dtype=np.float32) * 8, tags=np.array([0, 1, 1, 1, 1, 1, 2, 2]),
                       fixed=np.array([1, 0, 0, 0, 0, 0, 0, 0], bool), energy=energy, sid=100 + sid,
                       fid=site).save(os.path.join(d, f"site{site}"))
        if sid == 4:  # the bare slab: never a candidate of the sub-split
            Trajectory(positions=np.zeros((1, 8, 3), np.float32), numbers=np.ones(8), cell=np.eye(3) * 8,
                       tags=np.zeros(8), fixed=np.zeros(8, bool), energy=np.asarray([-99.0], np.float32),
                       sid=104).save(os.path.join(d, "surface"))
    return root


@pytest.mark.parametrize("relaxed_positions", (True, False))
def test_conditional_train_set_equals_jax(tmp_path, relaxed_positions):
    root = traj_tree(str(tmp_path / "trajs"), 0)
    n = dataset_prep.build_conditional_train_set(root, str(tmp_path / "port"), relaxed_positions)
    assert n == jax_prep.build_conditional_train_set(root, str(tmp_path / "jax"), relaxed_positions) > 0
    assert_same_shard(str(tmp_path / "port.adshard.npz"), str(tmp_path / "jax.adshard.npz"))
    ds = ShardDataset({"src": str(tmp_path / "port")})
    mins = [ds[i] for i in range(len(ds)) if ds[i].fid == -1]
    assert mins and all(s.energy == 0.0 for s in mins)  # the per-sid minimum is exactly 0


@pytest.mark.parametrize("skip_first,num_shards", ((0, 1), (2, 2), (1, 3)))
def test_min_energy_subsplit_equals_jax(tmp_path, skip_first, num_shards):
    root = traj_tree(str(tmp_path / "trajs"), 1)
    n = dataset_prep.build_min_energy_subsplit(root, str(tmp_path / "port"), skip_first=skip_first,
                                               num_shards=num_shards)
    assert n == jax_prep.build_min_energy_subsplit(root, str(tmp_path / "jax"), skip_first=skip_first,
                                                   num_shards=num_shards) > 0
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) and len(files) == min(num_shards, n)
    for f in files:
        assert_same_shard(str(tmp_path / "port" / f), str(tmp_path / "jax" / f))
    ds = ShardDataset({"src": str(tmp_path / "port")})
    assert all(ds[i].natoms == 8 and ds[i].atomic_numbers.sum() > 8 for i in range(len(ds)))  # no bare slab


def placements(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4):
        kw = dict(positions=rng.random((5, 3)) * 4, numbers=rng.integers(1, 20, 5), cell=np.eye(3) * 8,
                  tags=np.array([1, 1, 1, 2, 2]), fixed=np.array([1, 0, 0, 0, 0], bool), sid=i, fid=i)
        if i % 2:
            kw.update(energy=float(rng.normal()), forces=rng.normal(size=(5, 3)))
        out.append(kw)
    return [Atoms(**kw) for kw in out], [JaxAtoms(**kw) for kw in out]


@pytest.mark.parametrize("sids", (None, [40, 41, 42, 43]))
def test_placement_dataset_and_dedup_equal_jax(tmp_path, sids):
    ours, theirs = placements(2)
    assert dataset_prep.build_placement_dataset(ours, str(tmp_path / "port"), sids) == 4
    assert jax_prep.build_placement_dataset(theirs, str(tmp_path / "jax"), sids) == 4
    assert_same_shard(str(tmp_path / "port.adshard.npz"), str(tmp_path / "jax.adshard.npz"))
    # a shard with repeated sids: the first entry of each is kept, in order
    rng = np.random.default_rng(3)
    systems = [System(pos=rng.random((3, 3)), atomic_numbers=[1, 2, 3], cell=np.eye(3) * 5, sid=sid, fid=k)
               for k, sid in enumerate([7, 3, 7, 9, 3, 1])]
    write_shard(str(tmp_path / "dups"), systems)
    assert dataset_prep.dedup_sids(ShardDataset({"src": str(tmp_path / "dups")}), str(tmp_path / "port_u")) == 4
    assert jax_prep.dedup_sids(JaxShardDataset({"src": str(tmp_path / "dups")}), str(tmp_path / "jax_u")) == 4
    assert_same_shard(str(tmp_path / "port_u.adshard.npz"), str(tmp_path / "jax_u.adshard.npz"))
    ds = ShardDataset({"src": str(tmp_path / "port_u")})
    assert [(ds[i].sid, ds[i].fid) for i in range(4)] == [(7, 0), (3, 1), (9, 3), (1, 5)]


def test_vasp_inputs_equal_jax(tmp_path):
    ours, theirs = placements(4)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        flags = {"encut": 400.0, "lwave": True} if i else None
        dataset_prep.write_vasp_inputs(a, str(tmp_path / "port" / str(i)), flags)
        jax_prep.write_vasp_inputs(b, str(tmp_path / "jax" / str(i)), flags)
        for name in ("POSCAR", "INCAR"):
            with open(tmp_path / "port" / str(i) / name) as f, open(tmp_path / "jax" / str(i) / name) as g:
                assert f.read() == g.read(), name
    with open(tmp_path / "port" / "1" / "INCAR") as f:
        incar = f.read()
    assert "ENCUT = 400.0" in incar and "LWAVE = .TRUE." in incar
    dirs = [str(tmp_path / "port" / str(i)) for i in range(4)]
    assert dataset_prep.launch_vasp(dirs) == jax_prep.launch_vasp(dirs)
    assert dataset_prep.launch_vasp(dirs, "vasp_gam") == jax_prep.launch_vasp(dirs, "vasp_gam")
    assert dataset_prep.VASP_FLAGS == jax_prep.VASP_FLAGS
