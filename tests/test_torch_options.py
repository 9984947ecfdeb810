"""PyTorch port: the trainer options and model tables of ROADMAP A.7 against
the JAX package, on the CPU.

- Gradient accumulation (``optim.grad_accumulation_steps``, JAX's
  ``optax.MultiSteps`` with the gradient mean) and ``ReduceLROnPlateau``
  (JAX's ``optax.contrib.reduce_on_plateau`` after AdamW) through six S2EF
  steps of the PaiNN of tests/test_s2ef_and_tasks.py (JAX's XLA message),
  the two training batches taken in turn.  Tolerances, those of
  tests/test_torch_trainer.py::test_train_steps_match_jax: loss and
  grad_norm rtol 1e-5, params atol 1e-5, EMA atol 2e-6 (f32 sums in another
  order through AdamW); the Adam moments and the gradient mean within
  1e-4 x max|JAX's| of each tensor (the gradients they hold agree to ~1e-5
  relative); counters and the plateau's best loss, count and scale exactly
  (the best loss at rtol 1e-5, a loss).
- The radial bases against JAX's ``RadialBasis``, parameters and their
  gradients included: atol 1e-5 / rtol 1e-5, the gaussian case's
  tolerance in tests/test_torch_painn.py (f32 powers and sines evaluated
  by another library), gradients rtol 1e-4.
- The element tables key for key, exactly.
"""
import os

import jax
import numpy as np
import pytest
import torch
from optax import ScaleByAdamState
from optax.contrib import ReduceLROnPlateauState

from adsorbdiff_tpu.train.trainer import S2EFTrainer as JaxS2EFTrainer
from adsorbdiff_tpu_torch.models.painn import painn_state_dict_from_jax
from adsorbdiff_tpu_torch.train.trainer import S2EFTrainer
from tests.port_bridge import to_torch_batch
from tests.test_s2ef_and_tasks import make_s2ef_dataset, s2ef_config
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6
ACCUMULATE = dict(grad_accumulation_steps=3, clip_grad_norm=0.5, optimizer_params={"weight_decay": 1e-3})
# lr_initial 1e-7: the loss falls by about the plateau's relative 1e-4 a step, so the scale drops at steps 3 and 6
# (patience 2)
PLATEAU = dict(scheduler="ReduceLROnPlateau", factor=0.5, patience=2, lr_initial=1e-7)


@pytest.fixture(scope="module")
def train_shard(tmp_path_factory):
    return make_s2ef_dataset(tmp_path_factory.mktemp("options"), np.random.default_rng(70), 8, "train")


def _pair(train_shard, run_dir, **optim):
    """A JAX S2EFTrainer with a fresh state and the port's on its weights."""
    cfg = s2ef_config(train_shard, run_dir=str(run_dir), **optim)
    jt = JaxS2EFTrainer(cfg, mesh=None)
    batches = list(jt.train_batcher)
    jt.init_state(batches[0])
    pt = S2EFTrainer(dict(cfg, cpu=True))
    pt.model.load_state_dict(_convert(jt.state.params, jt.state.scale_factors), strict=True)
    pt.init_state()
    return jt, pt, batches


def _convert(tree, scale_factors=None):
    return painn_state_dict_from_jax(jax.tree.map(np.asarray, {"params": tree, "scale_factors": scale_factors or {}}))


def _find(tree, cls):
    """The ``cls`` nodes of an optax state, in order."""
    if isinstance(tree, cls):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _find(t, cls)]
    return []


def _assert_close_each(got, want, what):
    """Per tensor: |got - want| <= 1e-4 * max|want| (exact where want is 0)."""
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0,
                                   err_msg=f"{what} {name}")


def _run_both(jt, pt, batches, check):
    """``STEPS`` steps of both trainers, batch ``i % 2`` at step ``i``; after
    each, loss, grad_norm, params and EMA compared, then ``check(step)``."""
    step_fn = jt._get_step_fn(batches[0])
    names = [n for n, _ in pt.model.named_parameters()]
    for step in range(STEPS):
        batch = batches[step % len(batches)]
        jt.state, jaux = step_fn(jt.state, batch, jax.random.PRNGKey(300 + step))
        aux = pt.train_step(to_torch_batch(batch))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=f"step {step} {k}")
        want_p, want_e = _convert(jt.state.params), _convert(jt.state.ema_params)
        params = dict(pt.model.named_parameters())
        for name, ema in zip(names, pt.ema):
            np.testing.assert_allclose(params[name].detach().numpy(), want_p[name].numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"step {step} {name}")
            np.testing.assert_allclose(ema.numpy(), want_e[name].numpy(), atol=2e-6, rtol=0,
                                       err_msg=f"step {step} ema {name}")
        (adam,) = _find(jt.state.opt_state, ScaleByAdamState)
        _assert_close_each(dict(zip(names, pt.mu)), _convert(adam.mu), f"step {step} mu")
        _assert_close_each(dict(zip(names, pt.nu)), _convert(adam.nu), f"step {step} nu")
        assert int(pt.count) == int(adam.count)
        check(step)


def test_grad_accumulation_matches_jax(train_shard, tmp_path):
    """k = 3 micro-steps a step: params frozen until the k-th (as
    tests/test_optim_extras.py:11 holds JAX's), then moved; the Adam and
    schedule count once per k; the EMA decays toward the params at every
    micro-step, unchanged ones included (it moves from the first update on;
    before it, it equals them up to the decay's rounding); the gradient
    mean and mini-step as JAX's."""
    jt, pt, batches = _pair(train_shard, tmp_path, **ACCUMULATE)
    before = {"params": pt._flat.clone(), "ema": pt._ema_flat.clone()}
    d = float(np.float32(pt.ema_decay))

    def check(step):
        state = jt.state.opt_state
        assert int(pt.mini_step) == int(state.mini_step) == (step + 1) % 3
        names = [n for n, _ in pt.model.named_parameters()]
        _assert_close_each(dict(zip(names, pt.acc)), _convert(state.acc_grads), f"step {step} gradient mean")
        assert torch.equal(pt._flat, before["params"]) != (step % 3 == 2), f"step {step}"
        decayed = d * before["ema"] + float(np.float32(1) - np.float32(d)) * pt._flat
        assert torch.equal(pt._ema_flat, decayed), f"step {step}"
        if step >= 2:  # once params and EMA differ, decaying moves it
            assert not torch.equal(pt._ema_flat, before["ema"]), f"step {step}"
        before.update(params=pt._flat.clone(), ema=pt._ema_flat.clone())

    _run_both(jt, pt, batches, check)
    assert int(pt.count) == STEPS // 3


def test_reduce_on_plateau_matches_jax(train_shard, tmp_path):
    """Factor 0.5, patience 2, keyed on the training loss of one batch
    stepped six times at a learning rate too small to improve it by 1e-4:
    the scale halves at the third and sixth steps; best loss, plateau count
    and scale as JAX's; the state stays on the trainer's device.  A factor
    outside (0, 1) raises, as optax does."""
    jt, pt, batches = _pair(train_shard, tmp_path, **PLATEAU)
    scales = []

    def check(step):
        (plateau,) = _find(jt.state.opt_state, ReduceLROnPlateauState)
        np.testing.assert_allclose(float(pt.plateau_best), float(plateau.best_value), rtol=1e-5)
        assert int(pt.plateau_count) == int(plateau.plateau_count)
        assert float(pt.plateau_scale) == float(plateau.scale)
        scales.append(float(pt.plateau_scale))

    _run_both(jt, pt, batches[:1], check)
    assert scales == [1.0, 1.0, 0.5, 0.5, 0.5, 0.25]
    assert all(t.device.type == "cpu" and t.dim() == 0 for t in (pt.plateau_best, pt.plateau_count, pt.plateau_scale))
    with pytest.raises(ValueError, match="factor"):  # optax refuses it too
        S2EFTrainer(dict(s2ef_config(train_shard, run_dir=str(tmp_path), **dict(PLATEAU, factor=1.0)), cpu=True))


@pytest.mark.parametrize("optim", [ACCUMULATE, dict(ACCUMULATE, **PLATEAU)], ids=["accumulation", "with-plateau"])
def test_checkpoint_mid_accumulation_resumes_exactly(train_shard, tmp_path, optim):
    """Saved after 4 micro-steps (one into the second accumulation), loaded
    into a fresh trainer: 2 more steps give the uninterrupted run's params,
    moments, gradient mean, EMA and counters bit for bit."""
    cfg = dict(s2ef_config(train_shard, run_dir=str(tmp_path), **optim), cpu=True)
    t1 = S2EFTrainer(cfg)
    batches = list(t1.train_batcher)
    for step in range(4):
        t1.train_step(batches[step % 2])
    t1.step = 4
    t2 = S2EFTrainer(cfg)
    t2.load_checkpoint(t1.save("mid"))
    assert int(t2.mini_step) == 1
    for trainer in (t1, t2):
        for step in range(4, STEPS):
            trainer.train_step(batches[step % 2])
    for name in ("_flat", "_ema_flat", "_mu_flat", "_nu_flat", "_acc_flat", "count", "mini_step"):
        torch.testing.assert_close(getattr(t2, name), getattr(t1, name), rtol=0, atol=0, msg=name)
    for name in ("plateau_best", "plateau_count", "plateau_scale") if "scheduler" in optim else ():
        torch.testing.assert_close(getattr(t2, name), getattr(t1, name), rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("envelope", [{"name": "polynomial", "exponent": 5}, {"name": "exponential"}],
                         ids=["polynomial", "exponential"])
@pytest.mark.parametrize("rbf", [{"name": "spherical_bessel"}, {"name": "bernstein"},
                                 {"name": "bernstein", "pregamma_initial": 0.9}],
                         ids=["spherical-bessel", "bernstein", "bernstein-pregamma"])
def test_trainable_radial_bases_match_jax(rbf, envelope):
    """The initial parameters equal JAX's; with them moved off the init, the
    basis (d = 0 included: the Bessel basis clamps it) and the gradient of
    a weighted sum of it with respect to them as JAX's."""
    from adsorbdiff_tpu.models.layers import RadialBasis as JaxRadialBasis
    from adsorbdiff_tpu_torch.models.layers import RadialBasis

    d = np.random.default_rng(11).uniform(0, 7, (5, 9)).astype(np.float32)
    d[0, :2] = 0.0
    jrb = JaxRadialBasis(num_radial=16, cutoff=6.0, rbf=rbf, envelope=envelope)
    params = jax.tree.map(np.asarray, jrb.init(jax.random.PRNGKey(0), d)["params"])
    port = RadialBasis(16, 6.0, rbf=rbf, envelope=envelope)
    (name,) = params
    np.testing.assert_array_equal(getattr(port.rbf, name).detach().numpy(), params[name])
    params = {name: np.asarray(params[name] * np.float32(1.1) + np.float32(0.05))}
    with torch.no_grad():
        getattr(port.rbf, name).copy_(torch.from_numpy(params[name]))
    got = port(torch.from_numpy(d))
    want = jrb.apply({"params": params}, d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # a weighted sum: the Bernstein polynomials sum to 1, whose derivative is 0
    w = np.random.default_rng(12).normal(size=16).astype(np.float32)
    (grad,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), [getattr(port.rbf, name)])
    assert torch.isfinite(grad).all()
    want_grad = jax.grad(lambda p: (jrb.apply({"params": p}, d) * w).sum())(params)[name]
    # JAX's Bernstein gradient is NaN where d = 0 (the derivative of 0 ** 0); the port's is finite there
    # (ROADMAP §C), so the gradients are compared on d > 0
    assert np.isnan(want_grad).any() == (rbf["name"] == "bernstein")
    away = torch.from_numpy(d[1:])
    (grad,) = torch.autograd.grad((port(away) * torch.from_numpy(w)).sum(), [getattr(port.rbf, name)])
    want_grad = jax.grad(lambda p: (jrb.apply({"params": p}, d[1:]) * w).sum())(params)[name]
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-6)


def test_element_tables_match_jax():
    """``models/embeddings.py``: the radii and the three lazy tables equal
    JAX's key for key (NaN where JAX has NaN), read from the port's own
    byte-identical copy of the asset."""
    from adsorbdiff_tpu.models import embeddings as jax_embeddings
    from adsorbdiff_tpu_torch.models import embeddings

    assert embeddings.ATOMIC_RADII == jax_embeddings.ATOMIC_RADII
    for name in ("KHOT_EMBEDDINGS", "QMOF_KHOT_EMBEDDINGS", "CONTINUOUS_EMBEDDINGS"):
        got, want = getattr(embeddings, name), getattr(jax_embeddings, name)
        assert list(got) == list(want) and len(got) > 90, name
        for z in want:
            np.testing.assert_array_equal(np.asarray(got[z]), np.asarray(want[z]), err_msg=f"{name}[{z}]")
    assert embeddings.khot_embeddings() == jax_embeddings.khot_embeddings()
    assert os.path.abspath(embeddings._ASSET).startswith(os.path.join(REPO, "adsorbdiff_tpu_torch") + os.sep)
    with open(embeddings._ASSET, "rb") as a, open(jax_embeddings._ASSET, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(AttributeError):
        embeddings.NOT_A_TABLE  # noqa: B018
