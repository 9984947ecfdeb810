"""PyTorch port: the S2EF ``forces`` trainer for inference and the
``run_pipeline`` command line, against the JAX package (its training:
tests/test_torch_s2ef_train.py).

The trainer predicts, validates and relaxes (batch engine and slot-refill
engine) with its EMA model; the predict and run-relaxations tasks and the
command lines run it from configs and checkpoints on the host (``cpu:
true``).  Inputs come from seeded numpy, weights from the JAX package's init
(``painn_state_dict_from_jax``, ``gemnet_state_dict_from_jax``).  JAX's
GemNet-OC runs with ``fused_quad`` and ``use_pallas`` (its Legendre kernels in
interpret mode), as tests/test_torch_gemnet.py runs it; the port's runs the
plain versions of its kernels on the CPU.

Tolerances:
- forwards (PaiNN s2ef, ``predict``, ``energy_forces_fn``): atol 5e-5,
  rtol 1e-4, the model parity tolerance of tests/test_torch_painn.py and
  tests/test_torch_gemnet.py (f32 sums in another order);
- ``validate`` metrics, means over those outputs: rtol 1e-4, atol 1e-6;
- relaxations over 8 L-BFGS steps: positions and energies 1e-4, as
  tests/test_torch_lbfgs.py holds 8 steps of the small GemNet-OC (L-BFGS
  carries the forces' roundoff into later steps); IS2RS/IS2RE metrics
  rtol 1e-3, atol 1e-4; ids, offsets and frame counts exactly;
- ``predictions.npz``: forces within one f16 step (rtol 2e-3) plus 5e-5, as
  tests/test_torch_tasks.py holds the denoising outputs.
"""
import functools
import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial.transform import Rotation

from adsorbdiff_tpu import tasks as jax_tasks  # noqa: F401  (registers the JAX tasks)
from adsorbdiff_tpu.common.registry import registry as jax_registry
from adsorbdiff_tpu.data.buckets import BucketedBatcher as JaxBatcher
from adsorbdiff_tpu.data.store import ShardDataset as JaxShardDataset
from adsorbdiff_tpu.models.painn import PaiNN as JaxPaiNN
from adsorbdiff_tpu.train.trainer import S2EFTrainer as JaxS2EFTrainer
from adsorbdiff_tpu_torch import run_pipeline as cli
from adsorbdiff_tpu_torch.common.config import build_config
from adsorbdiff_tpu_torch.common.flags import get_parser
from adsorbdiff_tpu_torch.main import main
from adsorbdiff_tpu_torch.models.gemnet_oc import gemnet_state_dict_from_jax
from adsorbdiff_tpu_torch.models.painn import PaiNN, painn_state_dict_from_jax
from adsorbdiff_tpu_torch.pipeline import run_pipeline
from adsorbdiff_tpu_torch.runtime.trajectory import SUFFIX, Trajectory
from adsorbdiff_tpu_torch.tasks import PredictTask
from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer, S2EFTrainer
from tests.port_bridge import to_numpy, to_torch_batch
from tests.test_gemnet_oc import TINY as GEMNET_TINY
from tests.test_painn import MODEL_KW, make_batch
from tests.test_s2ef_and_tasks import make_s2ef_dataset, s2ef_config
from tests.test_trainer import config_for, make_dataset
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = dict(atol=5e-5, rtol=1e-4)
# gemnet_relax.yml's dataset block: energies are denormalised, the forces normaliser is built and never applied
NORMALIZE = dict(normalize_labels=True, target_mean=-0.7554450631141663, target_std=2.887317180633545,
                 grad_target_mean=0.0, grad_target_std=2.887317180633545)
GEMNET_MODEL = dict(name="gemnet_oc", **GEMNET_TINY, fused_quad=True, use_pallas=True)
RELAX_STEPS = 8


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("s2ef")
    rng = np.random.default_rng(50)
    return {name: make_s2ef_dataset(tmp, rng, count, name) for name, count in
            (("train", 8), ("val", 6), ("relax", 6))} | {"tmp": tmp}


def _config(shards, run_dir, model=None, **task):
    cfg = s2ef_config(shards["train"], shards["val"], shards["relax"], run_dir=str(run_dir))
    cfg["dataset"][0].update(NORMALIZE)
    cfg["task"].update(relaxation_steps=RELAX_STEPS, **task)
    if model is not None:
        cfg["model"] = dict(model)
    return cfg


@pytest.fixture(scope="module")
def jax_legendre_interpret():
    """JAX's masked Legendre kernels in interpret mode while a JAX GemNet-OC
    with ``use_pallas`` traces (tests/test_torch_gemnet.py does the same)."""
    import adsorbdiff_tpu.ops.pallas_kernels as pk

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pk, "gemnet_quad_basis", functools.partial(pk.gemnet_quad_basis, interpret=True))
        mp.setattr(pk, "gemnet_cbf_basis", functools.partial(pk.gemnet_cbf_basis, interpret=True))
        yield


def _pair(cfg, port_run_dir):
    """A JAX S2EFTrainer with a fresh state and the port's on the same EMA
    weights (scale factors unfitted on both sides; the configs set is_debug)."""
    jt = JaxS2EFTrainer(cfg, mesh=None)
    # init_state's forward, jitted and without the kernels (the same variables): an eager GemNet-OC init takes ~35 s
    model = jt.model
    jt.model = SimpleNamespace(init=jax.jit(model.clone(use_pallas=False, **(
        {"fused_quad": False} if hasattr(model, "fused_quad") else {})).init))
    jt.init_state(next(iter(jt.train_batcher)))
    jt.model = model
    variables = jax.tree.map(np.asarray, {"params": jt.state.ema_params, "scale_factors": jt.state.scale_factors})
    convert = gemnet_state_dict_from_jax if cfg["model"]["name"] == "gemnet_oc" else painn_state_dict_from_jax
    pt = S2EFTrainer(dict(cfg, run_dir=str(port_run_dir), cpu=True))
    pt.model.load_state_dict(convert(variables), strict=True)
    pt.init_state()  # EMA = params
    return jt, pt


@pytest.fixture(scope="module")
def painn_pair(shards):
    return _pair(_config(shards, shards["tmp"] / "jax-painn"), shards["tmp"] / "port-painn")


@pytest.fixture(scope="module")
def gemnet_pair(shards, jax_legendre_interpret):
    return _pair(_config(shards, shards["tmp"] / "jax-gemnet", model=GEMNET_MODEL), shards["tmp"] / "port-gemnet")


# (a) the PaiNN s2ef head
@pytest.mark.parametrize("use_pallas", [True, False], ids=["jax-pallas", "jax-xla"])
def test_painn_s2ef_matches_jax(use_pallas):
    batch = make_batch(np.random.default_rng(3))
    jmodel = JaxPaiNN(**MODEL_KW, mode="s2ef", so3_denoising=False, use_pallas=use_pallas)
    variables = jax.tree.map(np.asarray, dict(jmodel.init(jax.random.PRNGKey(1), batch)))
    want = jmodel.apply(variables, batch)
    model = PaiNN(**MODEL_KW, mode="s2ef", device="cpu")
    model.load_state_dict(painn_state_dict_from_jax(variables), strict=True)
    assert "out_energy.0.weight" in model.state_dict() and not hasattr(model, "out_forces2")
    with torch.no_grad():
        got = model(to_torch_batch(batch))
    assert got["energy"].shape == (2,) and got["forces"].shape == (2, 24, 3)
    for key in ("energy", "forces"):
        np.testing.assert_allclose(to_numpy(got[key]), np.asarray(want[key]), **FWD, err_msg=key)
    assert not got["forces"][:, 20:].any()  # padded atoms


def test_s2ef_mode_energy_invariant(rng):
    """tests/test_painn.py::test_s2ef_mode_energy_invariant on the port: the
    energy is unchanged when positions and cell rotate (2e-4, f32 geometry)."""
    model = PaiNN(**MODEL_KW, mode="s2ef", device="cpu", generator=torch.Generator().manual_seed(1))
    batch = to_torch_batch(make_batch(rng))
    r = torch.from_numpy(Rotation.random(random_state=5).as_matrix().astype(np.float32))
    rotated = batch.replace(pos=torch.einsum("bnd,ed->bne", batch.pos, r),
                            cell=torch.einsum("bnd,ed->bne", batch.cell, r))
    with torch.no_grad():
        out, out_r = model(batch), model(rotated)
    assert out["energy"].shape == (2,) and out["forces"].shape == (2, 24, 3)
    np.testing.assert_allclose(out_r["energy"].numpy(), out["energy"].numpy(), atol=2e-4)


# (b) predict and energy_forces_fn
@pytest.mark.parametrize("which", ["painn", "gemnet"])
def test_predict_and_energy_forces_match_jax(request, which):
    jt, pt = request.getfixturevalue(f"{which}_pair")
    batch = next(iter(jt.val_batcher))
    tb = to_torch_batch(batch)
    assert pt.normalizers["energy"].std == NORMALIZE["target_std"] and "forces" in pt.normalizers
    with torch.no_grad():
        raw = pt.ema_module(tb)
    for name, got, want in (("predict", pt.predict(tb), jt.predict(batch)),
                            ("energy_forces_fn", pt.energy_forces_fn(tb), jax.jit(jt.energy_forces_fn)(batch))):
        np.testing.assert_allclose(to_numpy(got[0]), np.asarray(want[0]), **FWD, err_msg=f"{name} energy")
        np.testing.assert_allclose(to_numpy(got[1]), np.asarray(want[1]), **FWD, err_msg=f"{name} forces")
        # denormalised energy; forces not denormalised (the JAX trainer's contract)
        torch.testing.assert_close(got[0], raw["energy"] * NORMALIZE["target_std"] + NORMALIZE["target_mean"])
    forces = pt.energy_forces_fn(tb)[1]
    assert not forces[tb.fixed].any() and forces[tb.free_mask].abs().max() > 0
    torch.testing.assert_close(pt.predict(tb)[1], raw["forces"], rtol=0, atol=0)


# (c) validate
def test_validate_matches_jax(painn_pair):
    jt, pt = painn_pair
    want, got = jt.validate("val"), pt.validate("val")
    assert got.keys() == want.keys() and {"energy_mae", "forces_mae"} <= got.keys()
    for key in want:
        np.testing.assert_allclose(got[key]["metric"], want[key]["metric"], rtol=1e-4, atol=1e-6, err_msg=key)
        assert got[key]["numel"] == want[key]["numel"], key


# (d), (e) run_relaxations in both engines
def _capture_relax_metrics(trainer):
    captured = []
    trainer._log_relax_metrics = lambda is2rs, is2re, split="val": captured.append((is2rs, is2re))
    return captured


@pytest.mark.parametrize("continuous", [False, True], ids=["batch-engine", "continuous-engine"])
def test_run_relaxations_matches_jax(shards, painn_pair, continuous):
    """The same relaxations through both trainers: relaxed_positions.npz,
    one trajectory per sid (frames, energies), IS2RS/IS2RE metrics."""
    jt, pt = painn_pair
    outs = {}
    for name, trainer in (("jax", jt), ("port", pt)):
        traj_dir = str(shards["tmp"] / f"trajs-{name}-{continuous}")
        trainer.task_cfg["relax_opt"] = dict(trainer.task_cfg["relax_opt"], continuous=continuous, chunk_steps=4,
                                             slots=4, traj_dir=traj_dir)
        metrics = _capture_relax_metrics(trainer)
        trainer.run_relaxations()
        del trainer._log_relax_metrics
        outs[name] = (np.load(os.path.join(trainer.results_dir, "relaxed_positions.npz"), allow_pickle=True),
                      traj_dir, metrics)
    (got, got_dir, got_m), (want, want_dir, want_m) = outs["port"], outs["jax"]
    np.testing.assert_array_equal(got["ids"], want["ids"])
    assert sorted(got["ids"].tolist()) == [str(i) for i in range(6)]
    np.testing.assert_array_equal(got["chunk_idx"], want["chunk_idx"])
    np.testing.assert_allclose(got["pos"], np.asarray(want["pos"], np.float32).reshape(-1, 3), atol=1e-4)
    for sid in range(6):
        g, w = (Trajectory.load(os.path.join(d, f"{sid}{SUFFIX}")) for d in (got_dir, want_dir))
        assert len(g) == len(w) and 2 <= len(g) <= RELAX_STEPS + 1
        np.testing.assert_allclose(g.energy, w.energy, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(g.positions, w.positions, atol=1e-4)
        assert (g.positions[:, g.fixed] == g.positions[0, g.fixed]).all() and g.fixed.any()
    assert len(got_m) == len(want_m) == 1
    for g, w in zip(got_m[0], want_m[0]):
        assert g.keys() == w.keys() and len(g) == 3
        for key in w:
            np.testing.assert_allclose(g[key]["metric"], w[key]["metric"], rtol=1e-3, atol=1e-4, err_msg=key)


def test_trainer_run_relaxations_continuous(shards, tmp_path):
    """tests/test_continuous.py::test_trainer_run_relaxations_continuous on
    the port: relax_opt {continuous: true} drives run_relaxations end to end
    (engine, metrics, write_pos, trajectory files)."""
    cfg = dict(_config(shards, tmp_path), cpu=True)
    cfg["task"]["relax_opt"].update(continuous=True, chunk_steps=4, slots=4, traj_dir=str(tmp_path / "trajs"))
    tr = S2EFTrainer(cfg)
    tr.run_relaxations()
    out = np.load(os.path.join(tr.results_dir, "relaxed_positions.npz"), allow_pickle=True)
    assert len(out["ids"]) == 6
    assert len([f for f in os.listdir(tmp_path / "trajs") if f.endswith(SUFFIX)]) == 6


# (f) the predict task
def test_predict_task_matches_jax(painn_pair):
    jt, pt = painn_pair
    files = {}
    for name, trainer, task_cls in (("jax", jt, jax_registry.get_task_class("predict")), ("port", pt, PredictTask)):
        task = task_cls(trainer.config)
        task.setup(trainer)
        task.run()
        files[name] = np.load(os.path.join(trainer.results_dir, "predictions.npz"))
    got, want = files["port"], files["jax"]
    np.testing.assert_array_equal(got["ids"], want["ids"])
    assert len(got["ids"]) == 8  # two batches of 4; the second repeats its last system
    assert got["outputs"].dtype == np.float16 and got["outputs"].shape == want["outputs"].shape
    np.testing.assert_allclose(got["outputs"].astype(np.float32), want["outputs"].astype(np.float32),
                               atol=5e-5, rtol=2e-3)


# (g) the command line on gemnet_relax.yml
def _relax_cli(shards, tmp_path, mode, *extra):
    widths = [f"--model.{k}={v}" for k, v in GEMNET_TINY.items() if k != "cell_reps"]
    return ["--mode", mode, "--config-yml", os.path.join(REPO, "configs/relaxation/gemnet_oc/gemnet_relax.yml"),
            "--run-dir", str(tmp_path), "--identifier", "cli", "--debug", "--cpu",
            f"--dataset.0.src={shards['train']}", f"--dataset.1.src={shards['val']}",
            f"--task.relax_dataset.src={shards['relax']}", f"--task.relax_opt.traj_dir={tmp_path / 'trajs'}",
            f"--task.relaxation_steps={RELAX_STEPS}", "--task.write_pos=True", "--optim.eval_batch_size=4",
            *widths, *extra]


def test_main_runs_relaxations_from_gemnet_relax_yml(shards, tmp_path):
    """``main --mode run-relaxations`` on the published gemnet_relax.yml
    (trainer: forces; cell_reps auto from the data; continuous auto picks
    the slot-refill engine), cut to tiny widths by overrides, from a
    checkpoint saved by a trainer of the same config; then ``--mode
    validate``."""
    args, rest = get_parser().parse_known_args(_relax_cli(shards, tmp_path, "train"))
    saver = S2EFTrainer(build_config(args, rest))
    assert saver.model.__class__.__name__ == "GemNetOC" and saver.normalizers["energy"].std == NORMALIZE["target_std"]
    saver.init_state()
    path = saver.save("checkpoint")
    main(_relax_cli(shards, tmp_path, "run-relaxations", "--checkpoint", path))
    relaxed = np.load(os.path.join(saver.results_dir, "relaxed_positions.npz"))
    assert sorted(relaxed["ids"].tolist()) == [str(i) for i in range(6)]
    assert np.isfinite(relaxed["pos"]).all() and relaxed["pos"].shape == (6 * 12, 3)
    for sid in range(6):
        traj = Trajectory.load(str(tmp_path / "trajs" / f"{sid}{SUFFIX}"))
        assert 2 <= len(traj) <= RELAX_STEPS + 1 and np.isfinite(traj.energy).all()
        assert (traj.positions[:, traj.fixed] == traj.positions[0, traj.fixed]).all()
    main(_relax_cli(shards, tmp_path, "validate", "--checkpoint", path))


# (h) the pipeline's command line
def _yaml_config(cfg, path):
    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        return [plain(v) for v in x] if isinstance(x, (list, tuple)) else x

    with open(path, "w") as f:
        yaml.safe_dump(plain(cfg), f)
    return str(path)


def test_run_pipeline_command_line(shards, tmp_path):
    """``run_pipeline.main`` on two written configs (``cpu: true``) and their
    checkpoints: a PaiNN sampler and a GemNet-OC ``forces`` relaxer.  Its rate
    equals a direct ``run_pipeline`` call's on trainers built the same way,
    and every stage's files are there; with ``--atom-budget`` its rate and
    sampled trajectories equal a direct ``run_pipeline(atom_budget=)``
    call's."""
    rng = np.random.default_rng(51)
    dcfg = dict(config_for(make_dataset(tmp_path, rng, 4, "dtrain"), run_dir=str(tmp_path), identifier="sampler"),
                cpu=True)
    dcfg["optim"]["denoising_pos_params"]["num_steps"] = 3
    sampler = DenoisingTrainer(dcfg)
    sampler.init_state()
    dckpt = sampler.save("checkpoint")
    rcfg = dict(_config(shards, tmp_path, model=dict(GEMNET_MODEL, mode="s2ef")), trainer="forces", cpu=True,
                identifier="relaxer")
    relaxer = S2EFTrainer(rcfg)
    relaxer.init_state()
    rckpt = relaxer.save("checkpoint")
    dpath, rpath = _yaml_config(dcfg, tmp_path / "sampler.yml"), _yaml_config(rcfg, tmp_path / "relaxer.yml")
    placements = make_dataset(tmp_path, rng, 5, "placements")
    targets = tmp_path / "targets.pkl"
    with open(targets, "wb") as f:
        pickle.dump({i: [("cfg", 1e3 if i % 2 else -1e3)] for i in range(5)}, f)

    with pytest.raises(ValueError, match="S2EFTrainer"):
        cli.build_trainer(dpath, dckpt, "s2ef")
    argv = ["--diffusion-config", dpath, "--diffusion-ckpt", dckpt, "--relax-config", rpath, "--relax-ckpt", rckpt,
            "--relax-dataset", placements, "--out-dir", str(tmp_path / "cli"), "--batch-size", "4",
            "--relaxation-steps", "5", "--dft-targets", str(targets)]
    rate = cli.main(argv)
    direct = run_pipeline(cli.build_trainer(dpath, dckpt, "denoising"), cli.build_trainer(rpath, rckpt, "s2ef"),
                          {"src": placements}, str(tmp_path / "direct"), relaxation_steps=5,
                          dft_targets={str(i): 1e3 if i % 2 else -1e3 for i in range(5)}, batch_size=4)
    assert rate is not None and rate == direct and 0.0 <= rate <= 1.0
    for stage in ("sampled", "relaxations"):
        assert sorted(os.listdir(tmp_path / "cli" / "0" / stage)) == sorted(f"{i}{SUFFIX}" for i in range(5))
    # --atom-budget 32: batches of 2 of the 16-atom bucket instead of 4, in the command line and the direct call
    budget_argv = [str(tmp_path / "cli-budget") if a == str(tmp_path / "cli") else a for a in argv]
    budget_rate = cli.main(budget_argv + ["--atom-budget", "32"])
    budget_direct = run_pipeline(cli.build_trainer(dpath, dckpt, "denoising"), cli.build_trainer(rpath, rckpt, "s2ef"),
                                 {"src": placements}, str(tmp_path / "direct-budget"), relaxation_steps=5,
                                 dft_targets={str(i): 1e3 if i % 2 else -1e3 for i in range(5)}, batch_size=4,
                                 atom_budget=32)
    assert budget_rate == budget_direct
    for i in range(5):
        got, want, full = (Trajectory.load(str(tmp_path / d / "0" / "sampled" / f"{i}{SUFFIX}")).positions
                           for d in ("cli-budget", "direct-budget", "cli"))
        np.testing.assert_array_equal(got, want)
        assert i < 2 or not np.array_equal(got, full)  # batch 1 of 2 systems draws other numbers than of 4
    with pytest.raises(ValueError, match="one device"):  # every stage runs on the sampler's device
        run_pipeline(sampler, SimpleNamespace(device=torch.device("meta")), {"src": placements}, str(tmp_path / "x"))


# (j) forces in the training and validation batches, none in the relax batches
def test_s2ef_batches_carry_forces(shards, painn_pair):
    """The port's batchers give JAX's batch plans; the train and val batches
    carry the shards' forces, the relax batches none."""
    _, pt = painn_pair
    for batcher, src, shuffle, forces in ((pt.train_batcher, shards["train"], True, True),
                                          (pt.val_batcher, shards["val"], False, True),
                                          (pt.relax_batcher, shards["relax"], False, False)):
        want = JaxBatcher(JaxShardDataset({"src": src}), 4, seed=0, shuffle=shuffle, with_forces=forces)
        got_batches, want_batches = list(batcher), list(want)
        assert len(got_batches) == len(want_batches)
        for g, w in zip(got_batches, want_batches):
            np.testing.assert_array_equal(g.sid.numpy(), np.asarray(w.sid))
            if forces:
                np.testing.assert_array_equal(g.forces.numpy(), np.asarray(w.forces))
                assert g.forces[g.atom_mask].abs().max() > 0
            else:
                assert g.forces is None and w.forces is None
    denoising = DenoisingTrainer(dict(config_for(shards["train"], shards["val"], run_dir=str(shards["tmp"])), cpu=True))
    assert next(iter(denoising.train_batcher)).forces is None


def test_port_imports_nothing_of_jax():
    """The port's command lines, tasks and trainers in a fresh interpreter:
    no module of jax, flax, optax or the JAX package is loaded beyond those
    the interpreter starts with."""
    code = ("import sys; before = set(sys.modules); import adsorbdiff_tpu_torch.run_pipeline, "
            "adsorbdiff_tpu_torch.main, adsorbdiff_tpu_torch.tasks, adsorbdiff_tpu_torch.train.trainer; "
            "print(sorted(m for m in set(sys.modules) - before if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'adsorbdiff_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
