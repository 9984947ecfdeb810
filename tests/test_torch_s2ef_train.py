"""PyTorch port: S2EF training (the ``forces`` trainer of gemnet_relax.yml),
GemNet-OC so3 denoising training, and the scale factors (fitting and
reference scale files), against the JAX package.

Inputs come from seeded numpy, weights from the JAX package's init
(``painn_state_dict_from_jax``, ``gemnet_state_dict_from_jax``).  JAX's
GemNet-OC runs with ``fused_quad`` and ``use_pallas``: its Legendre kernels
and its quadruplet chain (whose custom VJP is an XLA recompute) in interpret
mode, as tests/test_torch_s2ef.py runs them.  The port's runs the plain
versions of its kernels on the CPU, and the quad chain's VJP
(``kernels.GemnetQuadChain``) recomputes the plain version.

Tolerances, those of tests/test_torch_trainer.py::test_train_steps_match_jax:
loss and grad_norm rtol 1e-5, params atol 1e-5, EMA atol 2e-6 (f32 sums in
another order, through three AdamW steps); scale factors rtol 1e-5 (the
fitted values are products of four f32 corrections of an RMS summed in
another order); scale files exactly (one f32 rounding of the same float).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

import adsorbdiff_tpu.ops.igso3 as jax_igso3
from adsorbdiff_tpu.models.painn import PaiNN as JaxPaiNN
from adsorbdiff_tpu.models.gemnet_oc import GemNetOC as JaxGemNetOC
from adsorbdiff_tpu.train import scaling as jax_scaling
from adsorbdiff_tpu.train.trainer import DenoisingTrainer as JaxDenoisingTrainer
from adsorbdiff_tpu_torch.main import main
from adsorbdiff_tpu_torch.models import gemnet_oc
from adsorbdiff_tpu_torch.models.gemnet_oc import GemNetOC, gemnet_state_dict_from_jax
from adsorbdiff_tpu_torch.models.painn import PaiNN, painn_state_dict_from_jax
from adsorbdiff_tpu_torch.ops import igso3
from adsorbdiff_tpu_torch.runtime.trajectory import SUFFIX, Trajectory
from adsorbdiff_tpu_torch.train import scaling
from adsorbdiff_tpu_torch.train.checkpoint import load_checkpoint
from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer, S2EFTrainer
from tests.port_bridge import jax_schedule_draws, to_torch_batch
from tests.test_gemnet_oc import TINY as GEMNET_TINY
from tests.test_painn import MODEL_KW, make_batch
from tests.test_s2ef_and_tasks import make_s2ef_dataset, s2ef_config
from tests.test_torch_s2ef import GEMNET_MODEL, NORMALIZE, _pair, jax_legendre_interpret  # noqa: F401
from tests.test_trainer import config_for, make_dataset
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELAX_YML = os.path.join(REPO, "configs/relaxation/gemnet_oc/gemnet_relax.yml")
STEP_TOL = dict(loss=1e-5, params=1e-5, ema=2e-6)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("s2ef_train")
    rng = np.random.default_rng(60)
    return {name: make_s2ef_dataset(tmp, rng, count, name) for name, count in
            (("train", 8), ("val", 6), ("relax", 6))} | {"tmp": tmp}


def _train_config(shards, run_dir, model=None):
    """tests/test_s2ef_and_tasks.py's S2EF config with gemnet_relax.yml's
    label normalisation, force coefficient and clip."""
    cfg = s2ef_config(shards["train"], shards["val"], shards["relax"], run_dir=str(run_dir), force_coefficient=100,
                      clip_grad_norm=10)
    cfg["dataset"][0].update(NORMALIZE)
    if model is not None:
        cfg["model"] = dict(model)
    return cfg


def _assert_steps_match(jt, pt, convert, steps, port_step, tol=STEP_TOL):
    """``steps`` (JAX key, port step arguments) through both trainers on
    ``jt``'s first batch; loss, grad_norm, params and EMA after each."""
    first = next(iter(jt.train_batcher))
    step_fn = jt._get_step_fn(first)
    names = [n for n, _ in pt.model.named_parameters()]
    batch = to_torch_batch(first)
    for step, key in enumerate(steps):
        jt.state, jaux = step_fn(jt.state, first, key)
        aux = port_step(batch, key)
        for k in jaux:
            if k in aux:
                np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=tol["loss"], err_msg=f"step {step} {k}")
        assert {"loss", "grad_norm"} <= aux.keys() & jaux.keys()
        tree = lambda which: convert(jax.tree.map(np.asarray, {  # noqa: E731
            "params": getattr(jt.state, which), "scale_factors": jt.state.scale_factors}))
        want_p, want_e = tree("params"), tree("ema_params")
        params = dict(pt.model.named_parameters())
        for name, ema in zip(names, pt.ema):
            np.testing.assert_allclose(params[name].detach().numpy(), want_p[name].numpy(), atol=tol["params"],
                                       rtol=0, err_msg=f"step {step} {name}")
            np.testing.assert_allclose(ema.numpy(), want_e[name].numpy(), atol=tol["ema"], rtol=0,
                                       err_msg=f"step {step} ema {name}")
    assert int(pt.count) == len(steps)


# (c) three S2EF train steps against JAX's
@pytest.mark.parametrize("model", ["painn-jax-pallas", "painn-jax-xla", "gemnet"])
def test_s2ef_train_steps_match_jax(request, shards, model):
    """Energy MAE of the normalised target + 100 x force L2MAE on free
    atoms, clip 10, weight decay 0, EMA 0.999: loss, loss_energy,
    loss_forces, grad_norm, params and EMA after each of three steps.  The
    PaiNN of tests/test_s2ef_and_tasks.py with JAX's message kernel (interpret
    mode) and without; GemNet-OC TINY with ``fused_quad`` and ``use_pallas``."""
    if model == "gemnet":
        request.getfixturevalue("jax_legendre_interpret")
        cfg = _train_config(shards, shards["tmp"] / "jax-gemnet", GEMNET_MODEL)
    else:
        cfg = _train_config(shards, shards["tmp"] / f"jax-{model}")
        cfg["model"]["use_pallas"] = model == "painn-jax-pallas"
    jt, pt = _pair(cfg, shards["tmp"] / f"port-{model}")
    convert = gemnet_state_dict_from_jax if model == "gemnet" else painn_state_dict_from_jax
    keys = [jax.random.PRNGKey(200 + i) for i in range(3)]
    _assert_steps_match(jt, pt, convert, keys, lambda batch, key: pt.train_step(batch))


# (b) no gradient reaches the triplet bases or the quad chain's geometry
def test_gemnet_train_step_differentiates_no_geometry(shards, tmp_path, monkeypatch):
    """During a GemNet-OC S2EF train step every input of
    ``gemnet_cbf_bases`` needs no gradient, nor do ``n1`` and ``n2`` of
    ``gemnet_quad_chain``; its ``xm`` and ``qp`` do, and the quad
    interaction's parameters get non-zero gradients through them."""
    seen = {"bases": [], "chain": []}
    bases, chain = gemnet_oc.gemnet_cbf_bases, gemnet_oc.gemnet_quad_chain

    def cbf_bases(problems, s, *out_dtype):
        seen["bases"].append([t.requires_grad for p in problems for t in p])
        return bases(problems, s, *out_dtype)

    def quad_chain(n1, n2, key1, key2, xm, qp, s, *out_dtype):
        seen["chain"].append({k: t.requires_grad for k, t in dict(n1=n1, n2=n2, xm=xm, qp=qp).items()})
        return chain(n1, n2, key1, key2, xm, qp, s, *out_dtype)

    monkeypatch.setattr(gemnet_oc, "gemnet_cbf_bases", cbf_bases)
    monkeypatch.setattr(gemnet_oc, "gemnet_quad_chain", quad_chain)
    pt = S2EFTrainer(dict(_train_config(shards, tmp_path, GEMNET_MODEL), cpu=True))
    pt.init_state()
    batch = next(iter(pt.train_batcher))
    loss, _ = pt._loss_and_aux(batch, None, None)
    params = dict(pt.model.named_parameters())
    quad = [n for n in params if ".quad_interaction." in n]
    grads = torch.autograd.grad(loss, [params[n] for n in quad])
    assert len(seen["bases"]) == 1 and len(seen["bases"][0]) == 9 and not any(seen["bases"][0])
    assert len(seen["chain"]) == GEMNET_TINY["num_blocks"]
    assert all(c == dict(n1=False, n2=False, xm=True, qp=True) for c in seen["chain"])
    assert quad and all(g.abs().max() > 0 for g in grads)


# (d) one epoch, then validate; the loss falls on one batch
def test_s2ef_train_and_validate(shards, tmp_path):
    """``train()`` for one epoch of GemNet-OC TINY (a checkpoint at its end),
    then ``validate()`` with finite metrics; then
    tests/test_s2ef_and_tasks.py::test_s2ef_train_and_validate's check on
    the port: its PaiNN and config, 30 steps on one batch bring the loss
    under 0.8 of its first value."""
    cfg = _train_config(shards, tmp_path, GEMNET_MODEL)
    cfg["optim"].update(max_epochs=1)
    pt = S2EFTrainer(dict(cfg, cpu=True))
    pt.train()
    assert pt.step == len(pt.train_batcher) and os.path.exists(os.path.join(pt.ckpt_dir, "checkpoint"))
    metrics = pt.validate("val")
    assert {"energy_mae", "forces_mae"} <= metrics.keys()
    assert all(np.isfinite(v["metric"]) for v in metrics.values())

    rng = np.random.default_rng(0)
    train = make_s2ef_dataset(tmp_path, rng, 12, "train")
    val = make_s2ef_dataset(tmp_path, rng, 8, "val")
    pt = S2EFTrainer(dict(s2ef_config(train, val, run_dir=str(tmp_path)), cpu=True))
    batch = next(iter(pt.train_batcher))
    assert batch.forces is not None
    losses = [float(pt.train_step(batch)["loss"]) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.8, losses[::10]
    metrics = pt.validate("val")
    assert "energy_mae" in metrics and "forces_mae" in metrics and np.isfinite(metrics["energy_mae"]["metric"])


def test_s2ef_loss_options(shards, tmp_path):
    """``loss_energy: mse``, ``loss_force: atomwise_l2`` and ``mae``, and
    ``train_on_free_atoms: false``, each against the losses of the port's
    loss module on the same outputs."""
    from adsorbdiff_tpu_torch.train import loss as L

    pt = S2EFTrainer(dict(_train_config(shards, tmp_path), cpu=True))
    pt.init_state()
    batch = next(iter(pt.train_batcher))
    with torch.no_grad():
        out = pt.model(batch)
    e_target = pt.normalizers["energy"].norm(batch.energy)
    ones = torch.ones_like(out["energy"], dtype=torch.bool)
    cases = [
        (dict(loss_energy="mse"), {}, L.mse(out["energy"], e_target, ones), L.l2mae(out["forces"], batch.forces,
                                                                                    batch.free_mask)),
        (dict(loss_force="atomwise_l2"), {}, L.mae(out["energy"], e_target, ones),
         L.atomwise_l2(out["forces"], batch.forces, batch.free_mask, batch.natoms)),
        (dict(loss_force="mae"), dict(train_on_free_atoms=False), L.mae(out["energy"], e_target, ones),
         L.mae(out["forces"], batch.forces, batch.atom_mask)),
    ]
    for optim, task, want_e, want_f in cases:
        pt.optim_cfg = dict(pt.config["optim"], **optim)
        pt.task_cfg = dict(pt.config["task"], **task)
        with torch.no_grad():
            loss, aux = pt._loss_and_aux(batch, None, None)
        torch.testing.assert_close(aux["loss_energy"], want_e, rtol=0, atol=0)
        torch.testing.assert_close(aux["loss_forces"], want_f, rtol=0, atol=0)
        torch.testing.assert_close(loss, want_e + 100.0 * want_f, rtol=0, atol=0)


# (e) the command line: train from a gemnet_relax.yml-derived YAML, then relax from its checkpoint
def test_main_trains_gemnet_relax_yml_then_relaxes(shards, tmp_path):
    """``main --mode train`` on gemnet_relax.yml with the TINY widths, one
    epoch and the shards written into the YAML, on the host (``--cpu``,
    which sets the config's ``cpu: true``); then ``--mode run-relaxations``
    from the checkpoint it wrote."""
    with open(RELAX_YML) as f:
        cfg = yaml.safe_load(f)
    cfg["model"].update({k: v for k, v in GEMNET_TINY.items() if k != "cell_reps"})
    cfg["dataset"][0]["src"], cfg["dataset"][1]["src"] = shards["train"], shards["val"]
    cfg["task"].update(relax_dataset={"src": shards["relax"]}, relaxation_steps=5, write_pos=True)
    cfg["task"]["relax_opt"]["traj_dir"] = str(tmp_path / "trajs")
    # checkpoint_every -1: a checkpoint at the end of each epoch
    cfg["optim"].update(batch_size=4, eval_batch_size=4, max_epochs=1, checkpoint_every=-1)
    path = tmp_path / "gemnet_relax_tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    common = ["--config-yml", str(path), "--run-dir", str(tmp_path), "--identifier", "cli", "--debug", "--cpu"]
    main(["--mode", "train", *common])
    ckpt = os.path.join(tmp_path, "checkpoints", "cli", "checkpoint")
    state, _ = load_checkpoint(ckpt)
    assert state["step"] == 2 and int(state["opt_state"]["count"]) == 2
    main(["--mode", "run-relaxations", *common, "--checkpoint", ckpt])
    relaxed = np.load(os.path.join(tmp_path, "results", "cli", "relaxed_positions.npz"))
    assert sorted(relaxed["ids"].tolist()) == [str(i) for i in range(6)] and np.isfinite(relaxed["pos"]).all()
    for sid in range(6):
        traj = Trajectory.load(str(tmp_path / "trajs" / f"{sid}{SUFFIX}"))
        assert 2 <= len(traj) <= 6 and np.isfinite(traj.energy).all()


# GemNet-OC so3 denoising training (gemnet_so3.yml's model at TINY widths)
def test_gemnet_so3_denoising_train_steps_match_jax(tmp_path, monkeypatch, jax_legendre_interpret):  # noqa: F811
    """Three DenoisingTrainer steps of GemNet-OC TINY with both so3 heads
    against JAX's, the schedule draws passed in from JAX's key as
    tests/test_torch_trainer.py::test_train_steps_match_jax passes them, at
    the tolerances of (c)."""
    repaired = jax_igso3.get_tables()._replace(exp_score_norms=igso3.get_tables().exp_score_norms)
    monkeypatch.setattr(jax_igso3, "get_tables", lambda: repaired)
    train = make_dataset(tmp_path, np.random.default_rng(61), 8, "train")
    cfg = config_for(train, run_dir=str(tmp_path), optimizer_params={"weight_decay": 1e-3})
    cfg["model"] = dict(GEMNET_MODEL, mode="denoising", so3_denoising=True)
    jt = JaxDenoisingTrainer(cfg, mesh=None)
    first = next(iter(jt.train_batcher))
    model = jt.model
    jt.model = type("Init", (), {"init": staticmethod(jax.jit(model.clone(use_pallas=False, fused_quad=False).init))})
    jt.init_state(first)
    jt.model = model
    pt = DenoisingTrainer(dict(cfg, cpu=True))
    variables = jax.tree.map(np.asarray, {"params": jt.state.params, "scale_factors": jt.state.scale_factors})
    pt.model.load_state_dict(gemnet_state_dict_from_jax(variables), strict=True)
    pt.init_state()
    keys = [jax.random.PRNGKey(300 + i) for i in range(3)]
    _assert_steps_match(jt, pt, gemnet_state_dict_from_jax, keys,
                        lambda batch, key: pt.train_step(batch, draws=jax_schedule_draws(key, batch.batch_size)))


# (f) scale factors: reference scale files and fitting
GEMNET_SCALES = {
    "int_blocks.0.trip_interaction.scale_rbf": 1.5,
    "int_blocks.1.atom_update.scale_sum.scale_factor": 2.5,
    "int_blocks.0.quad_interaction.scale_sbf_sum": 0.75,
    "int_blocks.1.atom_edge_interaction.scale_cbf_sum": 1.25,
    "out_blocks.0.scale_rbf_F": 0.25,
    "not.a.real.name": 9.0,
}
PAINN_SCALES = {"upd_out_scalar_scale_0": 2.5, "upd_out_scalar_scale_1": 0.5, "not.a.real.name": 9.0}


def _write_scales(path, scales):
    ext = os.path.splitext(str(path))[1]
    if ext == ".json":
        path.write_text(json.dumps(dict(scales, comment="reference scale factors")))
    elif ext == ".pt":
        torch.save({k: torch.tensor(v) for k, v in scales.items()}, str(path))
    else:
        np.savez(str(path), **scales)
    return str(path)


@pytest.fixture(scope="module")
def jax_gemnet_tiny():
    batch = make_batch(np.random.default_rng(62))
    return jax.tree.map(np.asarray, dict(jax.jit(JaxGemNetOC(**GEMNET_TINY).init)(jax.random.PRNGKey(3), batch)))


@pytest.mark.parametrize("ext", [".npz", ".json", ".pt"])
@pytest.mark.parametrize("which", ["gemnet", "painn"])
def test_load_scales_compat_matches_jax(tmp_path, jax_gemnet_tiny, which, ext):
    """The same file through both packages' ``load_scales_compat``: every
    ScaleFactor gets the same value (the port's buffers by the reference's
    names, JAX's collection through its translation table), the unmatched
    entry is left out on both sides."""
    if which == "gemnet":
        variables = jax_gemnet_tiny
        model = GemNetOC(**GEMNET_TINY, device="cpu")
        convert, scales = gemnet_state_dict_from_jax, GEMNET_SCALES
    else:
        variables = jax.tree.map(np.asarray, dict(JaxPaiNN(**MODEL_KW, so3_denoising=False).init(
            jax.random.PRNGKey(4), make_batch(np.random.default_rng(63)))))
        model = PaiNN(**MODEL_KW, so3_denoising=False, device="cpu")
        convert, scales = painn_state_dict_from_jax, PAINN_SCALES
    path = _write_scales(tmp_path / f"scales{ext}", scales)
    model.load_state_dict(convert(variables), strict=True)
    factors = {n: b for n, b in model.named_buffers() if n.endswith("scale_factor")}
    got = scaling.load_scales_compat(factors, path)
    loaded = jax_scaling.load_scales_compat(variables["scale_factors"], path)
    want = convert(dict(variables, scale_factors=jax.tree.map(np.asarray, loaded)))
    assert got.keys() == factors.keys()
    for name in factors:
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(), err_msg=name)
    changed = {n for n in factors if float(got[n]) != 1.0}
    assert len(changed) == len(scales) - 1


@pytest.mark.parametrize("so3", [False, True], ids=["painn-s2ef", "painn-so3"])
def test_fit_scale_factors_matches_jax(so3):
    """tests/test_misc_components.py::test_scale_factor_fitting's case (every
    factor x4, fitted on one batch) through both packages: the same fitted
    factors (rtol 1e-5), and the fitted output RMS nearer 1."""
    mode = dict(so3_denoising=True) if so3 else dict(so3_denoising=False, mode="s2ef")
    batches = [make_batch(np.random.default_rng(64 + i)) for i in range(2)]
    jmodel = JaxPaiNN(**MODEL_KW, **mode)
    variables = jax.tree.map(np.asarray, dict(jmodel.init(jax.random.PRNGKey(5), batches[0])))
    bad = jax.tree.map(lambda x: x * 4.0, variables["scale_factors"])
    want = painn_state_dict_from_jax({"params": variables["params"], "scale_factors": jax.tree.map(
        np.asarray, jax_scaling.fit_scale_factors(jmodel, {"params": variables["params"], "scale_factors": bad},
                                                  batches))})
    model = PaiNN(**MODEL_KW, **mode, device="cpu")
    model.load_state_dict(painn_state_dict_from_jax({"params": variables["params"], "scale_factors": bad}))
    torch_batches = [to_torch_batch(b) for b in batches]
    with torch.no_grad():
        before = model(torch_batches[0])
    got = scaling.fit_scale_factors(model, torch_batches)
    assert got and all(got[n] is b for n, b in model.named_buffers() if n.endswith("scale_factor"))
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-5, err_msg=name)
        assert float(value) < 4.0
    with torch.no_grad():
        after = model(torch_batches[0])
    rms = lambda out: float(np.mean([x.pow(2).mean().sqrt() for x in scaling._leaves(out)]))  # noqa: E731
    assert abs(np.log(rms(after))) < abs(np.log(rms(before)))


def test_trainer_scale_file(shards, tmp_path):
    """``model.scale_file`` in a GemNet-OC S2EF trainer: ``init_state``
    loads it into the model's buffers and the EMA copy's, and the factors
    count as fitted (``run_relaxations`` does not raise)."""
    path = _write_scales(tmp_path / "scales.json", GEMNET_SCALES)
    cfg = _train_config(shards, tmp_path, dict(GEMNET_MODEL, scale_file=path))
    cfg["task"].update(relaxation_steps=2, relax_opt=dict(cfg["task"]["relax_opt"], traj_dir=str(tmp_path / "t")))
    pt = S2EFTrainer(dict(cfg, cpu=True, is_debug=False))
    pt.init_state()
    assert pt.scale_factors_fitted is True
    buffers, ema = dict(pt.model.named_buffers()), dict(pt.ema_module.named_buffers())
    for name, value in GEMNET_SCALES.items():
        if name == "not.a.real.name":
            continue
        key = name if name.endswith(".scale_factor") else name + ".scale_factor"
        assert float(buffers[key]) == pytest.approx(value) and float(ema[key]) == float(buffers[key])
    pt.run_relaxations()
