"""PyTorch port: the continuous-batching relaxation engine (relaxation/continuous.py).

Mirrors tests/test_continuous.py on the port (not its mesh case, which waits
for several devices; its trainer case is in tests/test_torch_s2ef.py, with
the S2EF trainer), plus one case against the JAX engine.  Every system
must follow the trajectory that ``lbfgs_relax`` gives it alone in a batch of
one, whatever shares its slots.

Tolerances: positions and energies 1e-5 against the batch-of-one runs and
JAX (the per-system dots are f32 sums in another order than the flattened
batch's); 1e-6 between slot layouts and with Verlet tables or narrowing
(the same arithmetic on the same rows); step counts and convergence exactly.
"""
import os

import numpy as np
import pytest
import torch

from adsorbdiff_tpu_torch.data.schema import System, collate, uncollate
from adsorbdiff_tpu_torch.models.gemnet_oc import GemNetOC
from adsorbdiff_tpu_torch.relaxation.continuous import ContinuousRelaxationEngine, resolve_continuous
from adsorbdiff_tpu_torch.relaxation.lbfgs import lbfgs_relax, make_mlff_energy_forces
from adsorbdiff_tpu_torch.runtime.trajectory import Trajectory
from tests.port_bridge import to_torch_batch
from tests.test_painn import make_batch as slab_batch
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

KW = dict(fmax=1e-3, maxstep=0.1, memory=10)
SMALL_GEMNET = dict(num_blocks=1, emb_size_atom=16, emb_size_edge=24, cutoff=6.0, cutoff_aeaint=6.0,
                    cutoff_qint=6.0, max_neighbors=8, max_neighbors_aeaint=6, max_neighbors_qint=4,
                    cell_reps=(1, 1, 0))


def make_systems(rng, count=6, n=5, spread=2.0):
    """tests/test_continuous.py:21-34: harmonic wells with per-system
    stiffness, so convergence times spread."""
    systems, targets, ks = [], {}, {}
    for i in range(count):
        cell = np.diag([10.0, 10.0, 20.0]).astype(np.float32)
        pos = (rng.random((n, 3)).astype(np.float32) - 0.5) * spread + np.array([5, 5, 10], np.float32)
        systems.append(System(pos=pos, atomic_numbers=rng.integers(1, 20, n), cell=cell,
                              tags=np.full(n, 2, np.int32), sid=100 + i))
        targets[100 + i] = pos + rng.normal(0, 0.4, pos.shape).astype(np.float32)
        ks[100 + i] = float(0.5 + 2.0 * (i % 3))
    return systems, targets, ks


def harmonic_by_sid(targets, ks, n_pad):
    """A harmonic well per sid, for any slot layout (in torch)."""
    sids = sorted(targets)
    tgt = torch.stack([torch.from_numpy(np.pad(targets[s], ((0, n_pad - len(targets[s])), (0, 0)))) for s in sids])
    kvec = torch.tensor([ks[s] for s in sids], dtype=torch.float32)
    sid_arr = torch.tensor(sids, dtype=torch.int32)

    def fn(batch):
        idx = torch.argmax((batch.sid[:, None] == sid_arr[None, :]).to(torch.int32), dim=1)
        k = kvec[idx][:, None, None]
        diff = (batch.pos - tgt[idx][:, : batch.max_atoms]) * batch.atom_mask[..., None]
        return 0.5 * torch.sum(k * diff**2, dim=(1, 2)), -k * diff

    return fn


def single(fn, system, n_pad, **kw):
    return lbfgs_relax(fn, collate([system], max_atoms=n_pad, device="cpu"), **dict(KW, **kw))


def test_continuous_matches_single_system_lbfgs(rng, tmp_path):
    systems, targets, ks = make_systems(rng)
    fn = harmonic_by_sid(targets, ks, 6)
    eng = ContinuousRelaxationEngine(fn, dict(KW), steps=80, slots=3, chunk_steps=7, device="cpu")
    traj_dir = str(tmp_path / "trajs")
    results = eng.run_systems(systems, traj_dir=traj_dir, max_atoms=6)
    assert sorted(results) == [s.sid for s in systems]
    for s in systems:
        ref = single(fn, s, 6, steps=80)
        got = results[s.sid]
        assert got.converged == bool(ref.converged[0])
        np.testing.assert_allclose(got.pos, ref.batch.pos[0, : s.natoms].numpy(), atol=1e-5)
        np.testing.assert_allclose(got.energy, float(ref.energy[0]), atol=1e-5)
        assert got.nsteps == ref.nsteps + 1  # executed iterations vs the converging index
        traj = Trajectory.load(os.path.join(traj_dir, f"{s.sid}"))
        assert traj.positions.shape[0] == got.nsteps + 1
        np.testing.assert_allclose(traj.positions, ref.traj_pos[: got.nsteps + 1, 0, : s.natoms].numpy(), atol=1e-5)
        np.testing.assert_allclose(traj.energy, ref.traj_energy[: got.nsteps + 1, 0].numpy(), atol=1e-5)
    # one read per chunk (no candidate tables)
    assert eng.host_reads > 0


def test_continuous_slot_composition_invariance(rng):
    systems, targets, ks = make_systems(rng, count=4)
    fn = harmonic_by_sid(targets, ks, 6)
    r2 = ContinuousRelaxationEngine(fn, dict(KW), steps=60, slots=2, chunk_steps=5, device="cpu").run_systems(
        systems, max_atoms=6)
    r4 = ContinuousRelaxationEngine(fn, dict(KW), steps=60, slots=4, chunk_steps=13, device="cpu").run_systems(
        systems, max_atoms=6)
    for sid in r2:
        np.testing.assert_allclose(r2[sid].pos, r4[sid].pos, atol=1e-6)
        assert r2[sid].nsteps == r4[sid].nsteps and r2[sid].converged == r4[sid].converged


def test_continuous_budgets_and_more_systems_than_slots(rng, tmp_path):
    systems, targets, ks = make_systems(rng, count=7)
    fn = harmonic_by_sid(targets, ks, 6)
    budgets = [3, 80, 5, 80, 4, 80, 2]
    eng = ContinuousRelaxationEngine(fn, dict(KW), steps=80, slots=2, chunk_steps=6, device="cpu")
    traj_dir = str(tmp_path / "t")
    results = eng.run_systems(systems, traj_dir=traj_dir, budgets=budgets, max_atoms=6)
    assert len(results) == 7
    for s, bd in zip(systems, budgets):
        got = results[s.sid]
        assert got.nsteps <= bd
        if not got.converged:
            assert got.nsteps == bd
        traj = Trajectory.load(os.path.join(traj_dir, f"{s.sid}"))
        assert traj.positions.shape[0] == got.nsteps + 1
        np.testing.assert_allclose(traj.positions[-1], got.pos, atol=0)
    ref = single(fn, systems[0], 6, steps=3)
    np.testing.assert_allclose(results[systems[0].sid].pos, ref.batch.pos[0, :5].numpy(), atol=1e-5)


def test_continuous_skip_existing(rng, tmp_path):
    systems, targets, ks = make_systems(rng, count=3)
    fn = harmonic_by_sid(targets, ks, 6)
    traj_dir = str(tmp_path / "t")
    eng = ContinuousRelaxationEngine(fn, dict(KW), steps=40, slots=2, chunk_steps=5, device="cpu")
    assert len(eng.run_systems(systems[:2], traj_dir=traj_dir, max_atoms=6)) == 2
    assert sorted(eng.run_systems(systems, traj_dir=traj_dir, max_atoms=6)) == [systems[2].sid]


def test_continuous_fewer_systems_than_slots(rng):
    systems, targets, ks = make_systems(rng, count=2)
    fn = harmonic_by_sid(targets, ks, 6)
    results = ContinuousRelaxationEngine(fn, dict(KW), steps=60, slots=5, chunk_steps=8,
                                         device="cpu").run_systems(systems, max_atoms=6)
    assert len(results) == 2
    for s in systems:
        np.testing.assert_allclose(results[s.sid].pos, single(fn, s, 6, steps=60).batch.pos[0, :5].numpy(),
                                   atol=1e-5)


@pytest.fixture(scope="module")
def small_gemnet():
    """The small GemNet-OC of tests/test_torch_lbfgs.py (random weights from
    a seeded generator) and three slab systems."""
    batch = to_torch_batch(slab_batch(np.random.default_rng(7), b=3))
    model = GemNetOC(**SMALL_GEMNET, device="cpu", generator=torch.Generator().manual_seed(0))
    return uncollate(batch), batch.max_atoms, model


def test_continuous_verlet_candidates_parity(small_gemnet):
    """Candidate tables (rebuilt at refill) change no result."""
    systems, n_pad, model = small_gemnet
    ef = make_mlff_energy_forces(model)
    kw = dict(fmax=0.05, maxstep=0.2, memory=10)
    plain = ContinuousRelaxationEngine(ef, dict(kw), steps=8, slots=2, chunk_steps=3, device="cpu").run_systems(
        systems, max_atoms=n_pad)
    eng = ContinuousRelaxationEngine.from_model(model, dict(kw, k_cand=24), steps=8, slots=2, chunk_steps=3,
                                                device="cpu")
    verlet = eng.run_systems(systems, max_atoms=n_pad)
    for sid in plain:
        np.testing.assert_allclose(plain[sid].pos, verlet[sid].pos, atol=1e-6)
        np.testing.assert_allclose(plain[sid].energy, verlet[sid].energy, atol=1e-6)
        assert plain[sid].nsteps == verlet[sid].nsteps
    # one read per step for the rebuild test, one per chunk for retirement
    chunks = eng.host_reads // (eng.chunk_steps + 1)
    assert eng.host_reads == chunks * (eng.chunk_steps + 1)


def test_continuous_run_dataset_buckets(rng, tmp_path):
    systems, targets = [], {}
    for i, n in enumerate([4, 5, 9, 10, 11, 3]):
        cell = np.diag([10.0, 10.0, 20.0]).astype(np.float32)
        pos = (rng.random((n, 3)).astype(np.float32) - 0.5) * 2 + np.array([5, 5, 10], np.float32)
        systems.append(System(pos=pos, atomic_numbers=rng.integers(1, 20, n), cell=cell,
                              tags=np.full(n, 2, np.int32), sid=200 + i))
        targets[200 + i] = pos + rng.normal(0, 0.3, pos.shape).astype(np.float32)
    fn = harmonic_by_sid(targets, {sid: 1.0 for sid in targets}, 16)  # any pad width up to 16

    class DS:
        def __len__(self):
            return len(systems)

        def __getitem__(self, i):
            return systems[i]

    eng = ContinuousRelaxationEngine(fn, dict(KW), steps=60, slots=2, chunk_steps=6, device="cpu")
    results = eng.run_dataset(DS(), traj_dir=str(tmp_path / "t"), num_buckets=2)
    assert sorted(results) == [s.sid for s in systems]
    assert all(results[s.sid].converged for s in systems)


def test_continuous_drain_narrowing_parity(rng):
    systems, targets, ks = make_systems(rng, count=6)
    fn = harmonic_by_sid(targets, ks, 6)
    budgets = [5, 5, 40, 40, 5, 5]
    kw = dict(KW, fmax=1e-12)  # retirement by budget: the drain (2 live of 4) is certain
    base = ContinuousRelaxationEngine(fn, kw, steps=80, slots=4, chunk_steps=6, device="cpu").run_systems(
        systems, budgets=budgets, max_atoms=6)
    eng = ContinuousRelaxationEngine(fn, dict(kw, drain_narrowing=True), steps=80, slots=4, chunk_steps=6,
                                     device="cpu")
    narrow = eng.run_systems(systems, budgets=budgets, max_atoms=6)
    assert eng.narrow_events
    assert sorted(narrow) == sorted(base)
    for sid in base:
        np.testing.assert_allclose(base[sid].pos, narrow[sid].pos, atol=1e-6)
        np.testing.assert_allclose(base[sid].energy, narrow[sid].energy, atol=1e-6)
        assert base[sid].nsteps == narrow[sid].nsteps and base[sid].converged == narrow[sid].converged


def test_continuous_drain_narrowing_with_verlet(small_gemnet):
    """Narrowing with candidate tables rebuilt after the gather (1e-3, as the
    JAX test: a model forward is row-independent only up to roundoff across
    batch widths)."""
    systems, n_pad, model = small_gemnet
    kw = dict(fmax=1e-9, maxstep=0.2, memory=10, k_cand=24)
    budgets = [2, 2, 9]
    base = ContinuousRelaxationEngine.from_model(model, dict(kw), steps=9, slots=2, chunk_steps=3,
                                                 device="cpu").run_systems(systems, budgets=budgets, max_atoms=n_pad)
    eng = ContinuousRelaxationEngine.from_model(model, dict(kw, drain_narrowing=True), steps=9, slots=2,
                                                chunk_steps=3, device="cpu")
    narrow = eng.run_systems(systems, budgets=budgets, max_atoms=n_pad)
    assert eng.narrow_events
    for sid in base:
        np.testing.assert_allclose(base[sid].pos, narrow[sid].pos, atol=1e-3)
        assert base[sid].nsteps == narrow[sid].nsteps


def test_resolve_continuous_auto():
    assert resolve_continuous({"continuous": True}, fmax=0.0) is True
    assert resolve_continuous({"continuous": False}, fmax=0.01) is False
    assert resolve_continuous({}, fmax=0.01) is True
    assert resolve_continuous(None, fmax=0.01) is True
    assert resolve_continuous({}, fmax=0.0) is False
    assert resolve_continuous({"fmax": 0.0}, fmax=0.01) is False
    assert resolve_continuous({"fmax": 0.05}, fmax=0.0) is True
    assert resolve_continuous({}, fmax=0.01, num_relaxation_batches=2) is False
    assert resolve_continuous({}, fmax=0.01, num_relaxation_batches=int(1e9)) is True
    assert resolve_continuous({"continuous": True}, fmax=0.01, num_relaxation_batches=2) is True
    assert resolve_continuous({"continuous": "false"}, fmax=0.01) is False
    assert resolve_continuous({"continuous": "off"}, fmax=0.01) is False
    assert resolve_continuous({"continuous": "true"}, fmax=0.0) is True
    with pytest.raises(ValueError):
        resolve_continuous({"continuous": "maybe"}, fmax=0.01)


def test_published_relax_opt_selects_the_continuous_engine():
    """gemnet_relax.yml's relax_opt (``continuous`` unset) at the pipeline's
    relaxation_fmax resolves to the continuous engine."""
    import yaml

    with open(os.path.join(os.path.dirname(__file__), "..", "configs", "relaxation", "gemnet_oc",
                           "gemnet_relax.yml")) as f:
        relax_opt = yaml.safe_load(f)["task"]["relax_opt"]
    assert "continuous" not in relax_opt
    assert resolve_continuous(relax_opt, fmax=0.01) is True


def test_continuous_matches_jax_engine(rng, tmp_path):
    """The same systems through both packages' engines: per-sid positions,
    energies, step counts, convergence and trajectories."""
    import jax.numpy as jnp

    from adsorbdiff_tpu.data.schema import System as JaxSystem
    from adsorbdiff_tpu.relaxation.continuous import ContinuousRelaxationEngine as JaxEngine

    systems, targets, ks = make_systems(rng, count=5)
    sids = sorted(targets)
    tgt = jnp.stack([jnp.asarray(np.pad(targets[s], ((0, 1), (0, 0)))) for s in sids])
    kvec = jnp.asarray([ks[s] for s in sids], jnp.float32)

    def jfn(batch):
        idx = jnp.argmax(batch.sid[:, None] == jnp.asarray(sids, jnp.int32)[None, :], axis=1)
        diff = (batch.pos - tgt[idx]) * batch.atom_mask[..., None]
        k = kvec[idx][:, None, None]
        return 0.5 * jnp.sum(k * diff**2, axis=(1, 2)), -k * diff

    budgets = [80, 80, 6, 80, 80]
    jsys = [JaxSystem(pos=s.pos, atomic_numbers=s.atomic_numbers, cell=s.cell, tags=s.tags, sid=s.sid)
            for s in systems]
    want = JaxEngine(jfn, dict(KW), steps=80, slots=2, chunk_steps=7).run_systems(
        jsys, traj_dir=str(tmp_path / "jax"), budgets=budgets, max_atoms=6)
    got = ContinuousRelaxationEngine(harmonic_by_sid(targets, ks, 6), dict(KW), steps=80, slots=2, chunk_steps=7,
                                     device="cpu").run_systems(systems, traj_dir=str(tmp_path / "port"),
                                                               budgets=budgets, max_atoms=6)
    assert sorted(got) == sorted(want)
    for sid in want:
        np.testing.assert_allclose(got[sid].pos, want[sid].pos, atol=1e-5)
        np.testing.assert_allclose(got[sid].energy, want[sid].energy, atol=1e-5)
        assert got[sid].nsteps == want[sid].nsteps and got[sid].converged == want[sid].converged
        tg, tw = (Trajectory.load(str(tmp_path / d / str(sid))) for d in ("port", "jax"))
        np.testing.assert_allclose(tg.positions, tw.positions, atol=1e-5)
        np.testing.assert_allclose(tg.energy, tw.energy, atol=1e-5)
        np.testing.assert_allclose(tg.forces, tw.forces, atol=1e-5)
