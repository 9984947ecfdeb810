"""PyTorch port: trajectories, Atoms and the engines' trajectory writing.

Mirrors tests/test_relaxation.py:100-153 and :204 on the port, and checks
the file format across the packages: a trajectory written by either one
reads back in the other with equal arrays (exactly: the same npz keys and
dtypes).
"""
import os
import threading

import numpy as np
import pytest
import torch

from adsorbdiff_tpu_torch.data.schema import System, collate, uncollate
from adsorbdiff_tpu_torch.relaxation.ml_relaxation import DiffusionEngine, RelaxationEngine, _AsyncWriter
from adsorbdiff_tpu_torch.runtime.atoms import Atoms, atoms_to_system, batch_to_atoms
from adsorbdiff_tpu_torch.runtime.trajectory import SUFFIX, Trajectory, check_traj_files, list_trajectories
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("positions", "numbers", "cell", "tags", "fixed", "energy", "forces")


def make_batch(rng, b=2, n=6, n_pad=8, spread=1.0):
    """tests/test_relaxation.py:16-23 on the port's collate."""
    systems = []
    for i in range(b):
        cell = np.diag([10.0, 10.0, 20.0]).astype(np.float32)
        pos = (rng.random((n, 3)).astype(np.float32) - 0.5) * spread + np.array([5, 5, 10], np.float32)
        systems.append(System(pos=pos, atomic_numbers=rng.integers(1, 20, n), cell=cell,
                              tags=np.full(n, 2, np.int32), sid=i))
    return collate(systems, max_atoms=n_pad, device="cpu")


def harmonic_fn(target):
    def fn(batch):
        diff = (batch.pos - target) * batch.atom_mask[..., None]
        return 0.5 * torch.sum(diff**2, dim=(1, 2)), -diff

    return fn


def random_traj(rng, sid=42, fid=3):
    return Trajectory(
        positions=rng.normal(0, 1, (5, 7, 3)).astype(np.float32),
        numbers=rng.integers(1, 30, 7),
        cell=np.eye(3, dtype=np.float32) * 8,
        tags=rng.integers(0, 3, 7),
        fixed=rng.integers(0, 2, 7).astype(bool),
        energy=rng.normal(0, 1, 5).astype(np.float32),
        forces=rng.normal(0, 1, (5, 7, 3)).astype(np.float32),
        sid=sid,
        fid=fid,
    )


def test_trajectory_roundtrip(tmp_path, rng):
    traj = random_traj(rng)
    p = traj.save(str(tmp_path / "42"))
    assert p.endswith(SUFFIX) and not os.path.exists(p[: -len(".npz")] + ".tmp.npz")
    back = Trajectory.load(p)
    assert len(back) == 5 and back.sid == 42 and back.fid == 3
    np.testing.assert_allclose(back.positions, traj.positions)
    np.testing.assert_allclose(back.energy, traj.energy)
    atoms = back[2]
    assert isinstance(atoms, Atoms) and len(atoms) == 7
    assert atoms.get_potential_energy() == pytest.approx(float(traj.energy[2]))
    assert check_traj_files([42], str(tmp_path))
    assert not check_traj_files([42, 43], str(tmp_path))
    assert list_trajectories(str(tmp_path)) == [p]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trajectory_reads_across_packages(tmp_path, rng, writer):
    """A file from one package loads in the other with the same arrays and
    dtypes, and the same ids."""
    from adsorbdiff_tpu.runtime.trajectory import Trajectory as JaxTrajectory

    src = random_traj(rng, sid=7, fid=2)
    cls_w, cls_r = (JaxTrajectory, Trajectory) if writer == "jax" else (Trajectory, JaxTrajectory)
    path = cls_w(**{k: getattr(src, k) for k in FIELDS}, sid=7, fid=2).save(str(tmp_path / "7"))
    back, same = cls_r.load(path), cls_w.load(path)
    assert (back.sid, back.fid) == (same.sid, same.fid) == (7, 2)
    for k in FIELDS:
        got, want = getattr(back, k), getattr(same, k)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_relaxation_engine_writes_trajs(tmp_path, rng):
    batch = make_batch(rng)
    eng = RelaxationEngine(harmonic_fn(batch.pos + 0.3), {"maxstep": 0.04, "memory": 20}, steps=50, fmax=0.01,
                           device="cpu")
    traj_dir = str(tmp_path / "trajs")
    res = eng.run(batch, traj_dir=traj_dir)
    assert res is not None
    # resumability holds while the write is still queued
    assert eng.run(batch, traj_dir=traj_dir) is None
    eng.flush()
    for sid in (0, 1):
        t = Trajectory.load(os.path.join(traj_dir, f"{sid}{SUFFIX}"))
        assert len(t) == 51 and t.positions.shape == (51, 6, 3)
        np.testing.assert_array_equal(t.positions, res.traj_pos[:, sid, :6].numpy())
        np.testing.assert_array_equal(t.energy, res.traj_energy[:, sid].numpy())
        np.testing.assert_array_equal(t.forces[-1], res.forces[sid, :6].numpy())
    assert eng.run(batch, traj_dir=traj_dir) is None  # files on disk now
    last = eng.run(batch, traj_dir=str(tmp_path / "last"), save_full_traj=False)
    eng.flush()
    t = Trajectory.load(str(tmp_path / "last" / "1"))
    assert len(t) == 1
    np.testing.assert_array_equal(t.positions[0], last.batch.pos[1, :6].numpy())


def test_diffusion_engine_runs_and_writes(tmp_path, rng):
    batch = make_batch(rng)

    def score_fn(cur):
        return torch.ones_like(cur.pos), torch.zeros_like(cur.pos)

    eng = DiffusionEngine(score_fn, dict(num_steps=8, ads_std_low=0.1, ads_std_high=10, rot_std_low=0.01,
                                         rot_std_high=1.55), device="cpu")
    res = eng.run(batch, torch.Generator().manual_seed(0), traj_dir=str(tmp_path / "d"))
    assert res is not None and res.traj_pos.shape[0] == 9
    eng.flush()
    t = Trajectory.load(str(tmp_path / "d" / ("0" + SUFFIX)))
    assert len(t) == 9 and t.energy is None
    np.testing.assert_array_equal(t.positions[-1], res.batch.pos[0, :6].numpy())
    assert eng.run(batch, torch.Generator().manual_seed(0), traj_dir=str(tmp_path / "d")) is None


def test_batch_padding_repeats_write_one_file(tmp_path, rng):
    """A batch padded with a repeat of its tail system writes that sid once."""
    systems = uncollate(make_batch(rng, b=2))
    padded = collate(systems + systems[1:], max_atoms=8, device="cpu")
    eng = RelaxationEngine(harmonic_fn(padded.pos + 0.1), {"memory": 5}, steps=3, fmax=0.0, device="cpu")
    eng.run(padded, traj_dir=str(tmp_path / "p"))
    eng.flush()
    assert [os.path.basename(p) for p in list_trajectories(str(tmp_path / "p"))] == ["0" + SUFFIX, "1" + SUFFIX]


def test_atoms_roundtrip(rng):
    batch = make_batch(rng)
    atoms_list = batch_to_atoms(batch, energy=torch.tensor([1.0, 2.0]), forces=torch.zeros(batch.pos.shape))
    assert len(atoms_list) == 2 and atoms_list[1].get_potential_energy() == 2.0
    sys0 = atoms_to_system(atoms_list[0])
    np.testing.assert_allclose(sys0.pos, batch.pos[0, :6].numpy(), atol=1e-6)
    assert sys0.energy == 1.0 and sys0.forces.shape == (6, 3)


def test_async_writer_pending_and_error_surfacing():
    w = _AsyncWriter()
    gate = threading.Event()
    done = []

    def slow_write(x):
        gate.wait(timeout=10)
        done.append(x)

    w.submit(slow_write, 1, pending_keys=[("d", 1), ("d", 2)])
    assert w.is_pending(("d", 1)) and w.is_pending(("d", 2))
    assert not w.is_pending(("d", 3))
    gate.set()
    w.flush()
    assert done == [1]
    assert not w.is_pending(("d", 1))

    def boom():
        raise RuntimeError("disk full")

    w.submit(boom, pending_keys=[("d", 9)])
    with pytest.raises(RuntimeError, match="disk full"):
        w.flush()
    assert not w.is_pending(("d", 9))
    w.flush()  # the error was raised once; flushing again is a no-op
