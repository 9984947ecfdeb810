"""PyTorch port: DenoisingTrainer against the JAX package's, on the CPU.

Three optimiser steps from the same weights and the same noise (the draws
JAX's schedule makes from its key): loss and grad_norm within 1e-5
relative, params within 1e-5 and EMA within 2e-6 absolute.  The limits
cover f32 sums taken in another order, which Adam's sign-like first steps
(|update| ~ lr) turn into ~1e-6 differences on parameters with
near-zero gradients.  The JAX side runs with the port's repaired IGSO(3)
expected score norm patched in: its own table is non-finite for some
rotation sigmas (see tests/test_torch_igso3.py), which would make both
losses NaN or far apart for reasons outside the training step.
"""
import math
import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adsorbdiff_tpu.ops import igso3 as jax_igso3
from adsorbdiff_tpu.train import loss as jax_loss
from adsorbdiff_tpu.train.evaluator import Evaluator as JaxEvaluator
from adsorbdiff_tpu.train.lr import build_lr_schedule as jax_build_lr_schedule
from adsorbdiff_tpu.train.trainer import DenoisingTrainer as JaxDenoisingTrainer
from adsorbdiff_tpu.data.schema import System
from adsorbdiff_tpu.data.store import write_shard
from adsorbdiff_tpu_torch.main import main
from adsorbdiff_tpu_torch.models.equiformer_v2 import eqv2_state_dict_from_jax
from adsorbdiff_tpu_torch.models.painn import painn_state_dict_from_jax
from adsorbdiff_tpu_torch.ops import igso3
from adsorbdiff_tpu_torch.train import loss
from adsorbdiff_tpu_torch.train.checkpoint import load_checkpoint
from adsorbdiff_tpu_torch.train.evaluator import Evaluator
from adsorbdiff_tpu_torch.train.lr import build_lr_schedule
from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer
from tests.port_bridge import jax_schedule_draws, to_torch_batch
from tests.test_equiformer_v2 import TINY as EQV2_TINY
from tests.test_trainer import config_for, make_dataset
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    return make_dataset(tmp, rng, 16, "train"), make_dataset(tmp, rng, 8, "val")


def _port_config(train, val=None, run_dir="./", **optim):
    return dict(config_for(train, val, run_dir=run_dir, **optim), cpu=True)


def _jax_state_dict(state, which="params"):
    tree = jax.tree.map(np.asarray, {"params": getattr(state, which), "scale_factors": state.scale_factors})
    return painn_state_dict_from_jax(tree)


@pytest.mark.parametrize("use_pallas,clip", [(False, 0.5), (True, 100.0)], ids=["jax-xla-clipped", "jax-pallas"])
def test_train_steps_match_jax(tiny_data, tmp_path, monkeypatch, use_pallas, clip):
    """Weight decay 1e-3 (base.yml's) on every parameter; with clip 0.5 the
    global-norm clip fires (grad norms ~0.2-1.1 here)."""
    repaired = jax_igso3.get_tables()._replace(exp_score_norms=igso3.get_tables().exp_score_norms)
    monkeypatch.setattr(jax_igso3, "get_tables", lambda: repaired)
    train, _ = tiny_data
    optim = dict(optimizer_params={"weight_decay": 1e-3}, clip_grad_norm=clip)
    cfg = config_for(train, run_dir=str(tmp_path), **optim)
    cfg["model"]["use_pallas"] = use_pallas
    jt = JaxDenoisingTrainer(cfg, mesh=None)
    first = next(iter(jt.train_batcher))
    jt.init_state(first)
    step_fn = jt._get_step_fn(first)

    pt = DenoisingTrainer(_port_config(train, run_dir=str(tmp_path), **optim))
    pt.model.load_state_dict(_jax_state_dict(jt.state))
    pt.init_state()  # zero moments, EMA = params, as JAX's init_state
    names = [n for n, _ in pt.model.named_parameters()]
    batch = to_torch_batch(first)
    clipped = 0
    for step in range(3):
        key = jax.random.PRNGKey(100 + step)
        jt.state, jaux = step_fn(jt.state, first, key)
        aux = pt.train_step(batch, draws=jax_schedule_draws(key, first.batch_size))
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(aux["grad_norm"]), float(jaux["grad_norm"]), rtol=1e-5)
        clipped += float(jaux["grad_norm"]) > clip
        want_p, want_e = _jax_state_dict(jt.state), _jax_state_dict(jt.state, "ema_params")
        params = dict(pt.model.named_parameters())
        for name, ema in zip(names, pt.ema):
            np.testing.assert_allclose(params[name].detach().numpy(), want_p[name].numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"step {step} {name}")
            np.testing.assert_allclose(ema.numpy(), want_e[name].numpy(), atol=2e-6, rtol=0,
                                       err_msg=f"step {step} ema {name}")
    assert int(pt.count) == 3
    assert (clipped > 0) == (clip < 1.0)
    want1, want2 = jt.predict_denoising(first)  # EMA weights
    got1, got2 = pt.predict_denoising(batch)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=5e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def energy_data(tmp_path_factory):
    """tests/test_trainer.py::make_dataset's systems with conditional energies."""
    tmp = tmp_path_factory.mktemp("energy")
    rng = np.random.default_rng(1)
    paths = []
    for name, count in (("train", 8), ("val", 4)):
        systems = []
        for i in range(count):
            cell = np.diag([7.0, 7.0, 24.0]).astype(np.float32)
            slab = (rng.random((10, 3)) * [1, 1, 0.3]) @ cell
            ads = rng.random((3, 3)).astype(np.float32) * 1.2 + np.array([3, 3, 8.5], np.float32)
            pos = np.concatenate([slab, ads]).astype(np.float32)
            tags = np.array([0] * 10 + [2] * 3, np.int32)
            z = np.concatenate([rng.integers(20, 60, 10), rng.integers(1, 9, 3)])
            systems.append(System(pos=pos, atomic_numbers=z, cell=cell, tags=tags, fixed=tags == 0, sid=i,
                                  pos_relaxed=pos, energy=float(rng.normal(0, 2))))
        write_shard(str(tmp / name), systems)
        paths.append(str(tmp / (name + ".adshard.npz")))
    return tuple(paths)


@pytest.mark.parametrize("conditional", [False, True], ids=["eqv2-so3", "eqv2-conditional"])
def test_eqv2_train_steps_match_jax(energy_data, tmp_path, monkeypatch, conditional):
    """Three DenoisingTrainer steps on the TINY EquiformerV2 (both so3 heads;
    with ``energy_encoding: scalar`` the shards' energies condition the
    model) against JAX's ``_make_train_step`` on its XLA path, at the
    tolerances of test_train_steps_match_jax; then the EMA score prediction
    (energy conditioning zeroed, as JAX's sampling model)."""
    repaired = jax_igso3.get_tables()._replace(exp_score_norms=igso3.get_tables().exp_score_norms)
    monkeypatch.setattr(jax_igso3, "get_tables", lambda: repaired)
    train, _ = energy_data
    optim = dict(optimizer_params={"weight_decay": 1e-3})
    cfg = config_for(train, run_dir=str(tmp_path), **optim)
    cfg["model"] = dict(EQV2_TINY, name="equiformer_v2", so3_denoising=True, for_denoising=True,
                        **({"energy_encoding": "scalar"} if conditional else {}))
    jt = JaxDenoisingTrainer(cfg, mesh=None)
    first = next(iter(jt.train_batcher))
    assert np.abs(np.asarray(first.energy)).max() > 0
    jt.init_state(first)
    step_fn = jt._get_step_fn(first)

    pt = DenoisingTrainer(dict(cfg, cpu=True))
    to_sd = lambda tree: eqv2_state_dict_from_jax({"params": jax.tree.map(np.asarray, tree)})  # noqa: E731
    pt.model.load_state_dict(to_sd(jt.state.params))
    pt.init_state()
    names = [n for n, _ in pt.model.named_parameters()]
    batch = to_torch_batch(first)
    for step in range(3):
        key = jax.random.PRNGKey(200 + step)
        jt.state, jaux = step_fn(jt.state, first, key)
        aux = pt.train_step(batch, draws=jax_schedule_draws(key, first.batch_size))
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(aux["grad_norm"]), float(jaux["grad_norm"]), rtol=1e-5)
        want_p, want_e = to_sd(jt.state.params), to_sd(jt.state.ema_params)
        params = dict(pt.model.named_parameters())
        for name, ema in zip(names, pt.ema):
            np.testing.assert_allclose(params[name].detach().numpy(), want_p[name].numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"step {step} {name}")
            np.testing.assert_allclose(ema.numpy(), want_e[name].numpy(), atol=2e-6, rtol=0,
                                       err_msg=f"step {step} ema {name}")
    want1, want2 = jt.predict_denoising(first)
    got1, got2 = pt.predict_denoising(batch)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=5e-5, rtol=1e-4)


def test_nan_loss_leaves_the_state_exactly_unchanged(tiny_data, tmp_path):
    train, _ = tiny_data
    pt = DenoisingTrainer(_port_config(train, run_dir=str(tmp_path)))
    batch = next(iter(pt.train_batcher))
    aux = pt.train_step(batch, generator=torch.Generator().manual_seed(0))
    assert math.isfinite(float(aux["loss"]))
    with torch.no_grad():
        for p in pt.params:
            p.mul_(float("nan"))
    before = [t.detach().clone() for t in pt.params + pt.mu + pt.nu + pt.ema] + [pt.count.clone()]
    aux = pt.train_step(batch, generator=torch.Generator().manual_seed(0))
    assert not math.isfinite(float(aux["loss"])) and float(aux["grad_norm"]) == 0.0
    after = [t.detach() for t in pt.params + pt.mu + pt.nu + pt.ema] + [pt.count]
    for a, b in zip(before, after):
        np.testing.assert_array_equal(b.numpy(), a.numpy())  # NaN where NaN, bit for bit elsewhere
    assert int(pt.count) == 1


def test_checkpoint_round_trip(tiny_data, tmp_path):
    train, _ = tiny_data
    cfg = _port_config(train, run_dir=str(tmp_path))
    t1 = DenoisingTrainer(cfg)
    batch = next(iter(t1.train_batcher))
    for i in range(3):
        t1.train_step(batch, generator=torch.Generator().manual_seed(i))
    t1.step = 3
    path = t1.save("ck")

    t2 = DenoisingTrainer(cfg)
    t2.load_checkpoint(path)
    assert t2.step == 3 and int(t2.count) == 3
    for a, b in zip(t1.params + t1.mu + t1.nu + t1.ema, t2.params + t2.mu + t2.nu + t2.ema):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    o1, r1 = t1.predict_denoising(batch)
    o2, r2 = t2.predict_denoising(batch)
    torch.testing.assert_close(o2, o1, rtol=0, atol=0)
    torch.testing.assert_close(r2, r1, rtol=0, atol=0)
    assert not r1[batch.fixed].any()  # rotation head zeroed on fixed atoms


def test_one_epoch_then_validate(tiny_data, tmp_path):
    train, val = tiny_data
    trainer = DenoisingTrainer(_port_config(train, val, run_dir=str(tmp_path), max_epochs=1))
    p0 = [p.detach().clone() for p in trainer.params]
    trainer.train()
    assert trainer.step == len(trainer.train_batcher) == int(trainer.count)
    assert any(not torch.equal(a, b) for a, b in zip(p0, trainer.params))
    metrics = trainer.validate("val")
    assert np.isfinite(metrics["loss"]["metric"]) and metrics["loss"]["numel"] == len(trainer.val_batcher)
    assert os.path.exists(os.path.join(trainer.ckpt_dir, "checkpoint"))  # checkpoint_every=-1: end of epoch


def test_main_trains_on_the_host_from_the_published_config(tiny_data, tmp_path):
    """``python -m adsorbdiff_tpu_torch.main --mode train`` on painn_so3.yml
    (and its base.yml include), cut to tiny widths by overrides, with
    ``cell_reps: auto`` resolved from the data."""
    train, val = tiny_data
    argv = [
        "--mode", "train", "--config-yml", os.path.join(REPO, "configs/denoising/painn_so3.yml"),
        "--run-dir", str(tmp_path), "--identifier", "cli", "--debug", "--cpu",
        f"--dataset.0.src={train}", f"--dataset.1.src={val}",
        "--model.hidden_channels=16", "--model.num_layers=1", "--model.num_rbf=8", "--model.cutoff=6.0",
        "--model.max_neighbors=12", "--optim.batch_size=8", "--optim.eval_batch_size=8", "--optim.max_epochs=1",
    ]
    main(argv)
    assert os.path.exists(os.path.join(tmp_path, "checkpoints", "cli", "checkpoint"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([a for a in argv if a != "--cpu"])


def test_eqv2_training_with_drops_repeats_from_the_seed(energy_data, tmp_path):
    """With drop rates the trainer hands the train-mode model a dropout
    generator per step, seeded from (seed, step): two runs give the same
    parameters (to 1e-6: the CPU's threaded sums may take another order;
    other masks would move them by ~1e-4)."""
    train, _ = energy_data
    params = []
    for i in range(2):
        cfg = dict(config_for(train, run_dir=str(tmp_path / str(i)), max_epochs=1, checkpoint_every=10**9), cpu=True)
        cfg["model"] = dict(EQV2_TINY, name="equiformer_v2", so3_denoising=True, alpha_drop=0.2, drop_path_rate=0.1,
                            proj_drop=0.1)
        trainer = DenoisingTrainer(cfg)
        assert trainer.model.has_drops and trainer.model.training
        p0 = [p.detach().clone() for p in trainer.params]
        trainer.train()
        params.append([p.detach().clone() for p in trainer.params])
    assert any(not torch.equal(a, b) for a, b in zip(p0, params[1]))
    for a, b in zip(params[0], params[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("config", ["eqv2_so3.yml", "eqv2_conditional.yml"])
def test_main_trains_eqv2_on_the_host_from_the_published_config(energy_data, tmp_path, config):
    """``main --mode train`` on configs/denoising/eqv2_so3.yml (and
    eqv2_conditional.yml -> eqv2_so3.yml -> base.yml), cut to the TINY test
    widths by overrides; ``cell_reps: auto`` and ``max_neighbors`` from the
    file; one epoch, then validation by the EMA weights."""
    train, val = energy_data
    widths = {k: v for k, v in EQV2_TINY.items() if k != "cell_reps"}
    argv = [
        "--mode", "train", "--config-yml", os.path.join(REPO, "configs/denoising", config),
        "--run-dir", str(tmp_path), "--identifier", "cli", "--debug", "--cpu",
        f"--dataset.0.src={train}", f"--dataset.1.src={val}", "--optim.batch_size=4", "--optim.eval_batch_size=4",
        "--optim.max_epochs=1", *(f"--model.{k}={v}" for k, v in widths.items()),
    ]
    main(argv)
    params = load_checkpoint(os.path.join(tmp_path, "checkpoints", "cli", "checkpoint"))[0]["params"]
    assert ("energy_embedding.weight" in params) == (config == "eqv2_conditional.yml")
    assert "blocks.0.attn.so2_conv_1.rad_func.dense_0.weight" in params


@pytest.mark.parametrize("name", ["l2mae", "mae", "mse", "atomwise_l2"])
def test_s2ef_losses_match_jax(name):
    """Masked, with NaN predictions zeroed, against the JAX losses (1e-6)."""
    rng = np.random.default_rng(30)
    pred = rng.normal(size=(3, 7, 3)).astype(np.float32)
    pred[0, 1, 2] = np.nan
    target = rng.normal(size=(3, 7, 3)).astype(np.float32)
    mask = rng.random((3, 7)) > 0.3
    natoms = np.array([7, 5, 6], np.int32)
    args = [pred, target, mask] + ([natoms] if name == "atomwise_l2" else [])
    want = float(getattr(jax_loss, name)(*map(jnp.asarray, args)))
    got = float(getattr(loss, name)(*map(torch.from_numpy, args)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("scheduler_params", [
    {"lambda_type": "cosine", "warmup_factor": 0.2, "warmup_epochs": 4, "lr_min_factor": 0.01, "epochs": 100},
    {"lambda_type": "multistep", "warmup_factor": 0.2, "warmup_epochs": 1, "decay_epochs": [3, 6], "decay_rate": 0.3},
], ids=["cosine", "multistep"])
def test_lr_schedules_match_jax(scheduler_params):
    cfg = {"lr_initial": 1e-4, "scheduler": "LambdaLR", "scheduler_params": scheduler_params}
    want, got = jax_build_lr_schedule(cfg, 31), build_lr_schedule(cfg, 31)
    for step in (0, 1, 30, 62, 124, 125, 200, 1550, 3100, 4000):
        np.testing.assert_allclose(float(got(step)), float(want(step)), rtol=1e-6, err_msg=str(step))
        np.testing.assert_allclose(float(got(torch.tensor(step, dtype=torch.int32))), float(want(step)), rtol=1e-6)


def test_evaluator_matches_jax():
    rng = np.random.default_rng(31)
    natoms = np.array([4, 6, 5])
    pred = {"energy": rng.normal(size=3), "forces": rng.normal(size=(15, 3)) * 0.02, "natoms": natoms}
    target = {"energy": pred["energy"] + rng.normal(size=3) * 0.02, "forces": rng.normal(size=(15, 3)) * 0.02,
              "natoms": natoms}
    got = Evaluator(task="s2ef").eval(pred, target)
    want = JaxEvaluator(task="s2ef").eval(pred, target)
    assert got.keys() == want.keys() and len(got) == 8
    for key in want:
        np.testing.assert_allclose(got[key]["metric"], want[key]["metric"], rtol=1e-12, err_msg=key)
