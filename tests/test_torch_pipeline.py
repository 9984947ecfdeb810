"""PyTorch port: the end-to-end pipeline (sample -> convert -> relax -> score).

Mirrors tests/test_pipeline.py's first two tests on the port (a tiny PaiNN
trained for one epoch on the CPU, and as the relaxer an ``S2EFTrainer`` of a
small GemNet-OC loaded from a checkpoint), once with the batch engine and
once with ``continuous`` resolving to the slot-refill engine; its
success-rate regression is ``slow`` there and stays out.  Stages 2-4 are
held against the JAX package on one
sampled directory: the converted shards are equal, and the continuous
relaxations (a harmonic well per sid, written in both frameworks) and success
rates agree (positions and energies 1e-5, step counts and the per-system
success dict exactly).  Stage 1 differs by design: the two packages'
random generators differ.
"""
import os

import numpy as np
import pytest
import torch

from adsorbdiff_tpu_torch.data.store import ShardDataset
from adsorbdiff_tpu_torch.eval_tools import success_rate
from adsorbdiff_tpu_torch.pipeline import run_pipeline, sampled_trajs_to_dataset
from adsorbdiff_tpu_torch.relaxation.continuous import ContinuousRelaxationEngine
from adsorbdiff_tpu_torch.runtime.trajectory import SUFFIX, Trajectory
from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer, S2EFTrainer
from tests.test_s2ef_and_tasks import s2ef_config
from tests.test_trainer import config_for, make_dataset
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

SMALL_GEMNET = dict(num_blocks=1, emb_size_atom=16, emb_size_edge=24, cutoff=6.0, cutoff_aeaint=6.0,
                    cutoff_qint=6.0, max_neighbors=8, max_neighbors_aeaint=6, max_neighbors_qint=4,
                    cell_reps=(1, 1, 0))
RELAX_KW = dict(fmax=1e-3, maxstep=0.2, memory=10)


def test_sampled_trajs_to_dataset_z_clearance(tmp_path):
    cell = np.diag([8.0, 8.0, 25.0]).astype(np.float32)
    n = 8
    pos = np.zeros((2, n, 3), np.float32)
    pos[:, :6, 2] = 3.0  # surface at z=3
    pos[1, 6:, 2] = 2.5  # adsorbate sunk below the surface in the final frame
    tags = np.array([1] * 6 + [2] * 2, np.int32)
    Trajectory(positions=pos, numbers=np.full(n, 29), cell=cell, tags=tags, fixed=np.zeros(n, bool),
               sid=3).save(str(tmp_path / "3"))
    assert sampled_trajs_to_dataset(str(tmp_path), str(tmp_path / "out")) == 1
    sys0 = ShardDataset({"src": str(tmp_path / "out")})[0]
    assert sys0.pos[tags == 2][:, 2].min() - sys0.pos[tags == 1][:, 2].max() == pytest.approx(0.1, abs=1e-5)
    assert sys0.sid == 3


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    cfg = dict(config_for(make_dataset(tmp, rng, 8, "dtrain"), run_dir=str(tmp), max_epochs=1), cpu=True)
    cfg["optim"]["denoising_pos_params"]["num_steps"] = 8
    dtr = DenoisingTrainer(cfg)
    dtr.train()
    rcfg = dict(s2ef_config(None, run_dir=str(tmp)), cpu=True, identifier="relaxer",
                model=dict(name="gemnet_oc", **SMALL_GEMNET))
    saver = S2EFTrainer(rcfg)
    saver.init_state()
    relaxer = S2EFTrainer(rcfg)
    relaxer.load_checkpoint(saver.save("checkpoint"))
    return tmp, dtr, relaxer, make_dataset(tmp, rng, 6, "relaxds")


@pytest.mark.parametrize("continuous", [False, "auto"], ids=["batch-engine", "continuous-engine"])
def test_full_pipeline(trained, continuous):
    tmp, dtr, relaxer, relax_src = trained
    out_dir = str(tmp / f"out-{continuous}")
    relax_opt = {"maxstep": 0.04, "memory": 10, "k_cand": 24, "chunk_steps": 2}
    if continuous is False:
        relax_opt["continuous"] = False
    rate = run_pipeline(dtr, relaxer, {"src": relax_src}, out_dir, nsites=2, relax_opt=relax_opt,
                        relaxation_steps=5, relaxation_fmax=0.01, dft_targets={str(i): -1.0 for i in range(6)},
                        batch_size=4)
    assert rate is not None and 0.0 <= rate <= 1.0
    for seed in (0, 1):
        step = os.path.join(out_dir, str(seed))
        assert os.path.exists(os.path.join(step, "final_struct.adshard.npz"))
        for stage, frames in (("sampled", 9), ("relaxations", None)):
            files = sorted(os.listdir(os.path.join(step, stage)))
            assert files == sorted(f"{i}{SUFFIX}" for i in range(6))
            for name in files:
                traj = Trajectory.load(os.path.join(step, stage, name))
                assert np.isfinite(traj.positions).all()
                assert frames is None or len(traj) == frames
                if stage == "relaxations":
                    assert 2 <= len(traj) <= 6 and np.isfinite(traj.energy).all()
                    moved = traj.positions[:, traj.fixed] - traj.positions[:1, traj.fixed]
                    assert traj.fixed.any() and not moved.any()


def _harmonic(xp, targets, sids, n_pad):
    """A harmonic well per sid around ``targets`` (fixed atoms' forces zeroed),
    for JAX (``xp`` = jax.numpy) or the port (torch)."""
    tgt = np.stack([np.pad(targets[s], ((0, n_pad - len(targets[s])), (0, 0))) for s in sids])
    tgt, sid_arr = xp.asarray(tgt), xp.asarray(np.asarray(sids, np.int32))

    def fn(batch):
        hit = (batch.sid[:, None] == sid_arr[None, :]).astype(np.int32) if xp is not torch else \
            (batch.sid[:, None] == sid_arr[None, :]).to(torch.int32)
        idx = hit.argmax(1)
        diff = (batch.pos - tgt[idx][:, : batch.pos.shape[1]]) * batch.atom_mask[..., None]
        return 0.5 * (diff**2).sum((1, 2)), xp.where(batch.fixed[..., None], 0.0, -diff)

    return fn


def test_stages_2_to_4_match_jax(tmp_path):
    """Conversion, continuous relaxation and success rate from one sampled
    directory, through both packages."""
    import jax.numpy as jnp

    from adsorbdiff_tpu.data.store import ShardDataset as JaxShardDataset
    from adsorbdiff_tpu.eval_tools import success_rate as jax_success_rate
    from adsorbdiff_tpu.pipeline import sampled_trajs_to_dataset as jax_convert
    from adsorbdiff_tpu.relaxation.continuous import ContinuousRelaxationEngine as JaxEngine

    rng = np.random.default_rng(3)
    src = ShardDataset({"src": make_dataset(tmp_path, rng, 6, "src")})
    sampled = tmp_path / "sampled"
    targets = {}
    for i in range(len(src)):
        s = src[i]
        frames = np.stack([s.pos, s.pos]).copy()
        frames[1, s.tags == 2] += rng.normal(0, 0.3, (int((s.tags == 2).sum()), 3)).astype(np.float32)
        if i % 2:
            frames[1, s.tags == 2, 2] = 0.5  # sunk: the conversion lifts it
        Trajectory(positions=frames, numbers=s.atomic_numbers, cell=s.cell, tags=s.tags, fixed=s.fixed,
                   sid=s.sid).save(str(sampled / str(s.sid)))
        targets[s.sid] = s.pos + np.where((s.tags == 2)[:, None], rng.normal(0, 0.2, s.pos.shape), 0).astype(
            np.float32)
    # 2. conversion
    for name, convert in (("port", sampled_trajs_to_dataset), ("jax", jax_convert)):
        assert convert(str(sampled), str(tmp_path / f"shard-{name}")) == 6
    port_ds = ShardDataset({"src": str(tmp_path / "shard-port")})
    jax_ds = JaxShardDataset({"src": str(tmp_path / "shard-jax")})
    for i in range(6):
        for field in ("pos", "atomic_numbers", "tags", "fixed", "cell", "sid"):
            np.testing.assert_array_equal(getattr(port_ds[i], field), getattr(jax_ds[i], field), err_msg=field)
    # 3. continuous relaxation
    sids = sorted(targets)
    got = ContinuousRelaxationEngine(_harmonic(torch, targets, sids, 16), dict(RELAX_KW), steps=60, slots=4,
                                     chunk_steps=5, device="cpu").run_dataset(port_ds, traj_dir=str(tmp_path / "rp"))
    want = JaxEngine(_harmonic(jnp, targets, sids, 16), dict(RELAX_KW), steps=60, slots=4,
                     chunk_steps=5).run_dataset(jax_ds, traj_dir=str(tmp_path / "rj"))
    assert sorted(got) == sorted(want) == sids
    for sid in sids:
        np.testing.assert_allclose(got[sid].pos, want[sid].pos, atol=1e-5)
        np.testing.assert_allclose(got[sid].energy, want[sid].energy, atol=1e-5)
        assert got[sid].nsteps == want[sid].nsteps and got[sid].converged == want[sid].converged
        assert got[sid].converged
    # 4. success rate: half the targets within 0.1 eV of the relaxed energy
    dft = {str(sid): got[sid].energy + (-0.05 if sid % 2 else -0.5) for sid in sids}
    rate, per = success_rate([str(tmp_path / "rp")], dft)
    assert (rate, per) == jax_success_rate([str(tmp_path / "rj")], dft)
    assert rate == pytest.approx(0.5)


def test_atom_budget_batches_match_jax(tmp_path):
    """``run_pipeline(atom_budget=)`` with the batch relaxer on systems of
    9-23 atoms: the sampler's and the relaxer's batches take the
    atom-balanced batch sizes (2 and 1 a bucket against a cap of 4), and
    from the port's sampled directory JAX's stages 2-4 with the same budget
    (its conversion, batcher and RelaxationEngine, a harmonic well per sid)
    give the same relaxed trajectories (positions and energies 1e-4, as
    tests/test_torch_lbfgs.py holds L-BFGS, which carries the f32 roundoff
    of its two-loop sums into later steps; frame counts exactly) and
    success rate."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from adsorbdiff_tpu.data.buckets import BucketedBatcher as JaxBatcher
    from adsorbdiff_tpu.data.store import ShardDataset as JaxShardDataset
    from adsorbdiff_tpu.eval_tools import success_rate as jax_success_rate
    from adsorbdiff_tpu.pipeline import sampled_trajs_to_dataset as jax_convert
    from adsorbdiff_tpu.relaxation.ml_relaxation import RelaxationEngine as JaxRelaxationEngine
    from adsorbdiff_tpu_torch.data.schema import System
    from adsorbdiff_tpu_torch.data.store import write_shard

    rng = np.random.default_rng(21)
    systems = []
    for i in range(7):
        n_slab = int(rng.integers(6, 21))
        cell = np.diag([7.0, 7.0, 24.0]).astype(np.float32)
        slab = (rng.random((n_slab, 3)) * [1, 1, 0.3]) @ cell
        ads = rng.random((3, 3)) * 1.2 + [3, 3, 8.5]
        pos = np.concatenate([slab, ads]).astype(np.float32)
        tags = np.array([0] * n_slab + [2] * 3, np.int32)
        systems.append(System(pos=pos, atomic_numbers=rng.integers(1, 40, n_slab + 3), cell=cell, tags=tags,
                              fixed=tags == 0, sid=i))
    write_shard(str(tmp_path / "placements"), systems)
    targets = {s.sid: s.pos for s in systems}  # the wells sit where the systems were before sampling moved them
    sids = sorted(targets)
    shapes = {"sample": set(), "relax": set()}
    harmonic = _harmonic(torch, targets, sids, 24)

    def score_fn(b):
        shapes["sample"].add(tuple(b.pos.shape[:2]))
        return torch.zeros_like(b.pos), torch.zeros_like(b.pos)

    def energy_forces_fn(b):
        shapes["relax"].add(tuple(b.pos.shape[:2]))
        return harmonic(b)

    sampler = SimpleNamespace(score_fn=score_fn, denoising_pos_params=dict(num_steps=2, ads_std_low=0.1,
                                                                           ads_std_high=1.0),
                              sampling_static_fn=lambda: None, device=torch.device("cpu"))
    relaxer = SimpleNamespace(energy_forces_fn=energy_forces_fn, device=torch.device("cpu"))
    dft = {str(sid): -1.0 if sid % 2 else 5.0 for sid in sids}
    port_dir = tmp_path / "port" / "0"
    rate = run_pipeline(sampler, relaxer, {"src": str(tmp_path / "placements.adshard.npz")}, str(tmp_path / "port"),
                        relax_opt=dict(RELAX_KW, continuous=False), relaxation_steps=40, batch_size=4,
                        atom_budget=40, dft_targets=dft)
    assert shapes["sample"] == shapes["relax"] == {(2, 16), (1, 24)}
    # JAX's stages 2-4 from the port's sampled directory, with the same budget
    assert jax_convert(str(port_dir / "sampled"), str(tmp_path / "jax_struct")) == len(sids)
    batcher = JaxBatcher(JaxShardDataset({"src": str(tmp_path / "jax_struct")}), 4, shuffle=False, seed=0,
                         atom_budget=40)
    engine = JaxRelaxationEngine(_harmonic(jnp, targets, sids, 24), dict(RELAX_KW), steps=40)
    for batch in batcher:
        engine.run(batch, traj_dir=str(tmp_path / "jax"))
    engine.flush()
    for sid in sids:
        got = Trajectory.load(str(port_dir / "relaxations" / f"{sid}{SUFFIX}"))
        want = Trajectory.load(str(tmp_path / "jax" / f"{sid}{SUFFIX}"))
        assert len(got.positions) == len(want.positions) > 2
        np.testing.assert_allclose(got.positions, want.positions, atol=1e-4)
        np.testing.assert_allclose(got.energy, want.energy, atol=1e-4)
    got_rate = success_rate([str(port_dir / "relaxations")], dft)
    assert got_rate == jax_success_rate([str(tmp_path / "jax")], dft) and got_rate[0] == rate
