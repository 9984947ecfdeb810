"""PyTorch port: the predict and run-relaxations tasks, against the JAX package.

- ``predict``: the same weights on the same shard write the same
  ``predictions.npz`` ids, and outputs within one f16 step (2e-3 relative)
  plus 5e-5 absolute (the model parity tolerance of tests/test_torch_painn.py,
  before the f16 cast);
- the relaxation results: ``_relax_metrics`` within 1e-6 relative of JAX's
  on the same final positions, and ``_write_relaxed_positions`` the same ids,
  positions and offsets (exact);
- ``run-relaxations`` through ``new_trainer_context`` and the command line,
  from a saved checkpoint, on the host (the published gemnet_so3.yml and
  painn_conditional.yml cut to tiny widths by overrides), and the
  ``ensure_fitted`` raise/warn contract.
"""
import logging
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from adsorbdiff_tpu import tasks as jax_tasks  # noqa: F401  (registers the JAX tasks)
from adsorbdiff_tpu.common.registry import registry as jax_registry
from adsorbdiff_tpu.train.scaling import ensure_fitted as jax_ensure_fitted
from adsorbdiff_tpu.train.trainer import BaseTrainer as JaxBaseTrainer
from adsorbdiff_tpu.train.trainer import DenoisingTrainer as JaxDenoisingTrainer
from adsorbdiff_tpu_torch.common.config import build_config
from adsorbdiff_tpu_torch.common.registry import registry
from adsorbdiff_tpu_torch.common.flags import get_parser
from adsorbdiff_tpu_torch.data.schema import System, collate
from adsorbdiff_tpu_torch.data.store import write_shard
from adsorbdiff_tpu_torch.main import main
from adsorbdiff_tpu_torch.models.painn import painn_state_dict_from_jax
from adsorbdiff_tpu_torch.runtime.trajectory import Trajectory
from adsorbdiff_tpu_torch.tasks import PredictTask, new_trainer_context
from adsorbdiff_tpu_torch.train.scaling import ensure_fitted
from adsorbdiff_tpu_torch.train.trainer import BaseTrainer, DenoisingTrainer
from tests.test_gemnet_oc import TINY as GEMNET_TINY
from tests.test_trainer import config_for
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _systems(rng, count, sid0=0):
    """Slab + adsorbate systems of 12-14 atoms (tags 0/1/2), with relaxed
    positions and energies and conditioning energies."""
    systems = []
    for i in range(count):
        n_slab = 9 + i % 2
        cell = np.diag([7.0, 7.0, 24.0]).astype(np.float32)
        slab = (rng.random((n_slab, 3)) * [1, 1, 0.3]) @ cell
        ads = rng.random((3, 3)).astype(np.float32) * 1.2 + np.array([3, 3, 8.5], np.float32)
        pos = np.concatenate([slab, ads]).astype(np.float32)
        tags = np.array([0] * (n_slab - 4) + [1] * 4 + [2] * 3, np.int32)
        z = np.concatenate([rng.integers(20, 60, n_slab), rng.integers(1, 9, 3)])
        systems.append(System(pos=pos, atomic_numbers=z, cell=cell, tags=tags, fixed=tags == 0, sid=sid0 + i,
                              fid=i % 3, energy=float(rng.normal(0, 1)), y_relaxed=float(rng.normal(-1, 1)),
                              pos_relaxed=pos + rng.normal(0, 0.05, pos.shape).astype(np.float32)))
    return systems


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tasks")
    rng = np.random.default_rng(40)
    paths = {}
    for name, count, sid0 in (("train", 8, 0), ("val", 6, 100), ("relax", 5, 200)):
        write_shard(str(tmp / name), _systems(rng, count, sid0))
        paths[name] = str(tmp / (name + ".adshard.npz"))
    return paths


def test_predict_task_matches_jax(shards, tmp_path):
    """JAX's PredictTask and the port's on the same EMA weights and the same
    validation shard."""
    cfg = config_for(shards["train"], shards["val"], run_dir=str(tmp_path / "jax"), eval_batch_size=4)
    jt = JaxDenoisingTrainer(cfg, mesh=None)
    jt.init_state(next(iter(jt.val_batcher)))
    jtask = jax_registry.get_task_class("predict")(cfg)
    jtask.setup(jt)
    jtask.run()
    want = np.load(os.path.join(jt.results_dir, "predictions.npz"))

    pt = DenoisingTrainer(dict(cfg, run_dir=str(tmp_path / "port"), cpu=True))
    pt.model.load_state_dict(painn_state_dict_from_jax(
        jax.tree.map(np.asarray, {"params": jt.state.ema_params, "scale_factors": jt.state.scale_factors})))
    pt.init_state()  # EMA = params
    task = PredictTask(cfg)
    task.setup(pt)
    task.run()
    got = np.load(os.path.join(pt.results_dir, "predictions.npz"))
    np.testing.assert_array_equal(got["ids"], want["ids"])
    assert got["outputs"].dtype == np.float16 and got["outputs"].shape == want["outputs"].shape
    np.testing.assert_allclose(got["outputs"].astype(np.float32), want["outputs"].astype(np.float32),
                               atol=5e-5, rtol=2e-3)


def test_relax_metrics_match_jax():
    """IS2RS and IS2RE metrics on free atoms from the same final positions."""
    rng = np.random.default_rng(41)
    systems = _systems(rng, 4)
    batch = collate(systems, max_atoms=16, device="cpu")
    final = batch.pos.numpy() + rng.normal(0, 0.1, batch.pos.shape).astype(np.float32)
    energy = rng.normal(-1, 1, 4)
    # JAX's method reads these fields through np.asarray
    host = SimpleNamespace(**{k: getattr(batch, k).numpy() for k in ("free_mask", "cell", "y_relaxed", "pos_relaxed")})
    want = JaxBaseTrainer._relax_metrics(None, host, final, energy, {}, {})
    got = BaseTrainer._relax_metrics(None, batch, final, energy, {}, {})
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and len(g) == 3
        for key in w:
            np.testing.assert_allclose(g[key]["metric"], w[key]["metric"], rtol=1e-6, err_msg=key)
            assert g[key]["numel"] == w[key]["numel"]


@pytest.mark.parametrize("natoms", [(5, 7, 5, 6), (5, 5, 5, 5)], ids=["ragged", "equal"])
def test_write_relaxed_positions_matches_jax(tmp_path, natoms):
    """Repeated ids are written once (the first), in sorted id order, with
    the same offsets; equal atom counts too (where JAX's file holds an
    object array)."""
    rng = np.random.default_rng(42)
    ids = ["7", "3", "7", "12"]
    positions = [rng.normal(size=(n, 3)).astype(np.float32) for n in natoms]
    files = {}
    for name, cls in (("jax", JaxBaseTrainer), ("port", BaseTrainer)):
        owner = SimpleNamespace(results_dir=str(tmp_path / name))
        os.makedirs(owner.results_dir)
        cls._write_relaxed_positions(owner, ids, positions, list(natoms))
        files[name] = np.load(os.path.join(owner.results_dir, "relaxed_positions.npz"), allow_pickle=True)
    got, want = files["port"], files["jax"]
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_array_equal(got["chunk_idx"], want["chunk_idx"])
    assert got["pos"].dtype == np.float32
    np.testing.assert_array_equal(got["pos"], want["pos"].astype(np.float32))


def test_ensure_fitted_contract_matches_jax(caplog):
    ones, fitted = [torch.ones(()), torch.ones(())], [torch.ones(()), torch.tensor(0.7)]
    for leaves in (ones, fitted, []):
        for fitted_flag in (None, True, False):
            kw = dict(fitted=fitted_flag)
            want_raise = not jax_ensure_fitted([x.numpy() for x in leaves], warn=True, **kw)
            assert ensure_fitted(leaves, warn=True, **kw) == (not want_raise)
            if want_raise:
                with pytest.raises(ValueError, match="not fitted"):
                    ensure_fitted(leaves, **kw)
                with caplog.at_level(logging.WARNING):
                    ensure_fitted({"a": leaves[0]}, warn=True, **kw)
                assert "not fitted" in caplog.text
            else:
                assert ensure_fitted(leaves, **kw)


def _relax_config(shards, tmp_path, **task):
    cfg = config_for(shards["train"], run_dir=str(tmp_path), eval_batch_size=4,
                     denoising_pos_params=dict(num_steps=3, ads_std_low=0.1, ads_std_high=10, rot_std_low=0.01,
                                               rot_std_high=1.55))
    cfg["task"] = dict(relax_dataset={"src": shards["relax"]}, **task)
    return dict(cfg, cpu=True)


def test_run_relaxations_raises_on_unfitted_scale_factors_unless_debug(shards, tmp_path, caplog):
    """A fresh trainer's scale factors are not fitted: run_relaxations
    raises, and with is_debug it warns and samples; a loaded checkpoint's
    count as fitted (as in JAX)."""
    cfg = dict(_relax_config(shards, tmp_path, num_relaxation_batches=1), is_debug=False)
    with pytest.raises(ValueError, match="not fitted"):
        DenoisingTrainer(cfg).run_relaxations()
    with caplog.at_level(logging.WARNING):
        DenoisingTrainer(dict(cfg, is_debug=True)).run_relaxations()
    assert "not fitted" in caplog.text
    saved = DenoisingTrainer(cfg)
    saved.init_state()
    path = saved.save("checkpoint")
    loaded = DenoisingTrainer(cfg)
    assert loaded.scale_factors_fitted is None
    loaded.load_checkpoint(path)
    assert loaded.scale_factors_fitted
    loaded.run_relaxations()


def test_relaxation_task_needs_a_relax_dataset_and_a_checkpoint(shards, tmp_path):
    """The JAX task's two preconditions (tasks.py:79-86), as errors."""
    cfg = dict(_relax_config(shards, tmp_path), mode="run-relaxations")
    with new_trainer_context(cfg) as ctx:
        with pytest.raises(ValueError, match="checkpoint required"):
            ctx.task.run()
    no_relax = dict(cfg, task={}, checkpoint="unused")
    trainer = DenoisingTrainer(no_relax)
    task = registry.get_task_class("run-relaxations")(no_relax)
    task.trainer = trainer
    with pytest.raises(ValueError, match="Relax dataset is required"):
        task.run()


def test_run_relaxations_from_a_checkpoint_through_the_trainer_context(shards, tmp_path):
    """mode run-relaxations: the checkpoint's EMA model samples every system
    of the relax shard (two batches of 4 and 1), writes one trajectory per
    system and relaxed_positions.npz; fixed atoms stay, positions are
    finite; a run repeats itself from the seed."""
    traj_dir = str(tmp_path / "trajs")
    base = _relax_config(shards, tmp_path, write_pos=True, relax_opt={"traj_dir": traj_dir})
    trainer = DenoisingTrainer(base)
    trainer.init_state()
    path = trainer.save("checkpoint")
    results = []
    for run in range(2):
        cfg = dict(base, mode="run-relaxations", checkpoint=path, identifier=f"relax{run}",
                   task=dict(base["task"], relax_opt={"traj_dir": f"{traj_dir}{run}"}))
        with new_trainer_context(cfg) as ctx:
            assert type(ctx.task).__name__ == "RelaxationTask"
            ctx.task.run()
            results.append(np.load(os.path.join(ctx.trainer.results_dir, "relaxed_positions.npz")))
    got = results[0]
    sids = [str(200 + i) for i in range(5)]
    assert sorted(got["ids"].tolist()) == sorted(sids)
    assert np.isfinite(got["pos"]).all() and got["pos"].shape == (sum(12 + i % 2 for i in range(5)), 3)
    np.testing.assert_array_equal(got["pos"], results[1]["pos"])
    for sid in sids:
        traj = Trajectory.load(os.path.join(f"{traj_dir}0", f"{sid}.adtraj.npz"))
        assert len(traj) == 4 and np.isfinite(traj.positions).all()
        assert (traj.positions[:, traj.fixed] == traj.positions[0, traj.fixed]).all()


def _cli(config, tmp_path, shards, mode, *extra):
    return [
        "--mode", mode, "--config-yml", os.path.join(REPO, "configs/denoising", config), "--run-dir", str(tmp_path),
        "--identifier", "cli", "--debug", "--cpu", f"--dataset.0.src={shards['train']}",
        f"--dataset.1.src={shards['val']}", f"--task.relax_dataset.src={shards['relax']}",
        "--optim.batch_size=4", "--optim.eval_batch_size=4", "--optim.denoising_pos_params.num_steps=2", *extra,
    ]


@pytest.mark.parametrize("config,widths", [
    ("gemnet_so3.yml", {k: v for k, v in GEMNET_TINY.items() if k != "cell_reps"}),
    ("painn_conditional.yml", dict(hidden_channels=16, num_layers=1, num_rbf=8, cutoff=6.0, max_neighbors=12)),
], ids=["gemnet-so3", "painn-conditional"])
def test_main_runs_relaxations_and_predicts_from_the_published_config(shards, tmp_path, config, widths):
    """``main --mode run-relaxations`` and ``--mode predict`` on the published
    denoising configs (their base.yml include; cell_reps: auto from the
    data), cut to tiny widths by overrides, from a checkpoint saved by a
    trainer of the same config."""
    overrides = [f"--model.{k}={v}" for k, v in widths.items()]
    args, rest = get_parser().parse_known_args(_cli(config, tmp_path, shards, "train", *overrides))
    trainer = DenoisingTrainer(build_config(args, rest))
    assert trainer.model.__class__.__name__ == ("GemNetOC" if config.startswith("gemnet") else "PaiNN")
    assert hasattr(trainer.model, "energy_embedding") == (config == "painn_conditional.yml")
    trainer.init_state()
    path = trainer.save("checkpoint")
    main(_cli(config, tmp_path, shards, "run-relaxations", "--checkpoint", path, "--task.write_pos=True",
              *overrides))
    relaxed = np.load(os.path.join(trainer.results_dir, "relaxed_positions.npz"))
    assert sorted(relaxed["ids"].tolist()) == sorted(str(200 + i) for i in range(5))
    assert np.isfinite(relaxed["pos"]).all()
    main(_cli(config, tmp_path, shards, "predict", "--checkpoint", path, *overrides))
    pred = np.load(os.path.join(trainer.results_dir, "predictions.npz"))
    # two batches of 4, the second padded with repeats of its last system (as JAX writes them)
    assert len(pred["ids"]) == 8 and set(pred["ids"].tolist()) == {f"{100 + i}_{i % 3}" for i in range(6)}
    assert pred["outputs"].dtype == np.float16 and np.isfinite(pred["outputs"]).all()
