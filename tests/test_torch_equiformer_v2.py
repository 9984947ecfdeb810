"""PyTorch port: the whole EquiformerV2 against the JAX model, the pinned
goldens, padding, equivariance, training (parameter gradients, the drop
regularisers, the JAX model's rotation kernel) and the options not ported yet.

The JAX model runs the S^2 activation through its Pallas kernel in interpret
mode (``use_pallas=True``, patched as ``tests/test_pallas_kernels.py:338-351``
does) and the first SO(2) conv on the XLA path (``use_pallas_conv1=False``,
the path ``tests/test_pallas_kernels.py:357-395`` holds the conv1 kernel to);
the port always runs its kernels' plain versions on the CPU.  Tolerance
atol 5e-5, rtol 1e-4: the one the JAX package uses between its own two paths
(``tests/test_pallas_kernels.py:352``); parameter gradients atol 1e-5, rtol
1e-3, its gradient test's (``tests/test_pallas_kernels.py:398-435``).
"""
import functools

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax.numpy as jnp

import adsorbdiff_tpu.ops.pallas_kernels as pk
from adsorbdiff_tpu.models.equiformer_v2 import EquiformerV2 as JaxEquiformerV2
from adsorbdiff_tpu_torch.common.registry import registry
from adsorbdiff_tpu_torch.models import equiformer_v2 as port_eqv2
from adsorbdiff_tpu_torch.models.equiformer_v2 import EquiformerV2, eqv2_state_dict_from_jax
from adsorbdiff_tpu_torch.ops import kernels
from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer
from tests.port_bridge import to_numpy, to_torch_batch
from tests.test_equiformer_v2 import TINY
from tests.test_model_goldens import GOLDEN
from tests.test_painn import make_batch
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=5e-5, rtol=1e-4)


def jax_apply(kw, variables, batch, static=None):
    """The JAX model with the S^2 kernel in interpret mode."""
    orig = pk.s2_grid_silu
    pk.s2_grid_silu = functools.partial(orig, interpret=True)
    try:
        return JaxEquiformerV2(**TINY, **kw, use_pallas=True, use_pallas_conv1=False).apply(variables, batch, static)
    finally:
        pk.s2_grid_silu = orig


def jax_init(kw, seed=0):
    variables = JaxEquiformerV2(**TINY, **kw).init(jax.random.PRNGKey(seed), make_batch(np.random.default_rng(3)))
    return jax.tree.map(np.asarray, dict(variables))


def port(kw, variables) -> EquiformerV2:
    model = EquiformerV2(**TINY, **kw, device="cpu")
    model.load_state_dict(eqv2_state_dict_from_jax(variables))  # strict: the names and shapes match
    return model


def _outputs(out):
    if isinstance(out, dict):
        return [out["energy"], out["forces"]]
    return list(out) if isinstance(out, tuple) else [out]


MODES = {
    "denoising-two-heads": dict(so3_denoising=True, for_denoising=True),
    "denoising-one-head": dict(so3_denoising=True, for_denoising=False),
    "denoising-no-so3": dict(so3_denoising=False, for_denoising=True),
    "s2ef": dict(mode="s2ef"),
    "energy-scalar": dict(so3_denoising=False, for_denoising=False, energy_encoding="scalar"),
    "energy-scalar-sampling": dict(so3_denoising=False, for_denoising=False, energy_encoding="scalar",
                                   sampling=True),
    "radii-pm-compat": dict(radii_pm_bug_compat=True),
    "no-radii": dict(subtract_atomic_radii=False),
}


@pytest.mark.parametrize("kw", list(MODES.values()), ids=list(MODES))
def test_eqv2_matches_jax(kw):
    variables = jax_init(kw)
    batch = make_batch(np.random.default_rng(7))
    want = _outputs(jax_apply(kw, variables, batch))
    with torch.no_grad():
        got = _outputs(port(kw, variables)(to_torch_batch(batch)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_energy_conditioning_is_zeroed_when_sampling():
    kw = MODES["energy-scalar"]
    variables = jax_init(kw)
    batch = to_torch_batch(make_batch(np.random.default_rng(8)))
    shifted = batch.replace(energy=batch.energy + 2.0)
    with torch.no_grad():
        train = port(kw, variables)
        assert (train(batch) - train(shifted)).abs().max() > 1e-7
        sample = port(dict(kw, sampling=True), variables)
        torch.testing.assert_close(sample(batch), sample(shifted), rtol=0, atol=0)


def test_eqv2_static_graph_matches_jax():
    """With the hoisted slab-slab graph, after the adsorbate moved."""
    kw = MODES["denoising-two-heads"]
    variables = jax_init(kw)
    rng = np.random.default_rng(9)
    batch = make_batch(rng)
    jmodel = JaxEquiformerV2(**TINY, **kw, max_ads=8)
    static = jmodel.prepare_static(batch)
    delta = np.zeros(batch.pos.shape, np.float32)
    ads = np.asarray(batch.ads_mask)
    delta[ads] = rng.normal(0, 0.8, (int(ads.sum()), 3))
    moved = batch.replace(pos=batch.pos + delta)
    want = jax_apply(dict(kw, max_ads=8), variables, moved, static)
    model = port(dict(kw, max_ads=8), variables)
    with torch.no_grad():
        got = model(to_torch_batch(moved), model.prepare_static(to_torch_batch(batch)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_eqv2_matches_pinned_golden():
    """tests/fixtures/model_goldens.npz (eqv2_f1, eqv2_f2) at the tolerance of
    tests/test_model_goldens.py."""
    golden = np.load(GOLDEN)
    batch = make_batch(np.random.default_rng(77))
    variables = jax.tree.map(np.asarray, dict(
        JaxEquiformerV2(**TINY, so3_denoising=True, for_denoising=True).init(jax.random.PRNGKey(7), batch)))
    with torch.no_grad():
        f1, f2 = port(MODES["denoising-two-heads"], variables)(to_torch_batch(batch))
    np.testing.assert_allclose(f1.numpy(), golden["eqv2_f1"], atol=2e-5)
    np.testing.assert_allclose(f2.numpy(), golden["eqv2_f2"], atol=2e-5)


def test_padding_rows_are_zero_and_padding_is_invariant():
    kw = dict(so3_denoising=False, for_denoising=False)
    model = EquiformerV2(**TINY, **kw, device="cpu", generator=torch.Generator().manual_seed(1))
    b24 = to_torch_batch(make_batch(np.random.default_rng(9)))
    b40 = to_torch_batch(make_batch(np.random.default_rng(9), n_pad=40))
    with torch.no_grad():
        f24, f40 = model(b24), model(b40)
    assert not f24[:, 20:].any() and not f40[:, 20:].any()  # padded rows are exactly zero
    np.testing.assert_allclose(f40[:, :24].numpy(), f24.numpy(), atol=2e-4)


def test_port_rotation_equivariance():
    model = EquiformerV2(**TINY, device="cpu", generator=torch.Generator().manual_seed(2))
    batch = to_torch_batch(make_batch(np.random.default_rng(10)))
    r = torch.from_numpy(Rotation.random(random_state=12).as_matrix().astype(np.float32))
    rot = batch.replace(pos=batch.pos @ r.T, pos_relaxed=batch.pos_relaxed @ r.T, cell=batch.cell @ r.T)
    with torch.no_grad():
        f1, f2 = model(batch)
        g1, g2 = model(rot)
    assert f1.abs().max() > 1e-6
    np.testing.assert_allclose(g1.numpy(), (f1 @ r.T).numpy(), atol=3e-4)
    np.testing.assert_allclose(g2.numpy(), (f2 @ r.T).numpy(), atol=3e-4)


def test_state_dict_names_follow_the_jax_tree():
    variables = jax_init(MODES["denoising-two-heads"])
    sd = eqv2_state_dict_from_jax(variables)
    assert set(sd) == set(EquiformerV2(**TINY, device="cpu").state_dict())
    flax = variables["params"]["attn_1"]["so2_conv_1"]["fc_m0"]["kernel"]
    np.testing.assert_array_equal(to_numpy(sd["blocks.1.attn.so2_conv_1.fc_m0.weight"]), flax.T)
    np.testing.assert_array_equal(to_numpy(sd["blocks.0.ffn.so3_linear_1.weight"]),
                                  variables["params"]["ffn_0"]["so3_linear_1"]["weight"])
    assert registry.get_model_class("equiformer_v2") is EquiformerV2
    assert registry.get_model_class("equiformer_v2_denoising") is EquiformerV2


@pytest.mark.parametrize("kw", [dict(grid_mode="e3nn")], ids=["e3nn-grid"])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EquiformerV2(**TINY, **kw, device="cpu")


def test_training_flag_without_drop_rates_is_the_eval_forward():
    variables = jax_init(MODES["denoising-two-heads"])
    batch = to_torch_batch(make_batch(np.random.default_rng(11)))
    train = port(dict(MODES["denoising-two-heads"], training=True), variables)
    assert train.training and not train.has_drops
    with torch.no_grad():
        for a, b in zip(train(batch), port(MODES["denoising-two-heads"], variables)(batch)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_denoising_trainer_on_equiformer_v2_raises(tmp_path):
    """DenoisingTrainer builds an EquiformerV2 (in train mode, its EMA copy in
    eval mode) and raises only for the options not ported yet."""
    config = {"model": dict(TINY, name="equiformer_v2", so3_denoising=True), "optim": {"lr_initial": 1e-4},
              "cpu": True, "run_dir": str(tmp_path)}
    trainer = DenoisingTrainer(config)
    assert isinstance(trainer.model, EquiformerV2) and trainer.model.training
    trainer.init_state()
    assert not trainer.ema_module.training
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DenoisingTrainer(dict(config, model=dict(config["model"], grid_mode="e3nn")))


# --------------------------------------------------------------------------
# training: parameter gradients, drops, the JAX model's rotation kernel
# --------------------------------------------------------------------------
def _jax_loss_grads(model, variables, batch, rngs=None):
    """(outputs, gradient tree) of sum over the heads of mean(f^2)."""
    def loss(params):
        out = model.apply({**variables, "params": params}, batch, rngs=rngs)
        return sum(jnp.mean(f**2) for f in _outputs(out)), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    return out, jax.tree.map(np.asarray, grads)


def _port_loss_grads(model, batch, **fwd):
    out = model(batch, **fwd)
    loss = sum(torch.mean(f**2) for f in _outputs(out))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return out, dict(zip(names, grads))


def _assert_grads_match(got, want_tree, **tol):
    want = eqv2_state_dict_from_jax({"params": want_tree})
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **tol)


def _interpret_kernels(monkeypatch, names):
    for name in names:
        monkeypatch.setattr(pk, name, functools.partial(getattr(pk, name), interpret=True))


GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
GRAD_CASES = {"xla": dict(), "conditional": dict(energy_encoding="scalar")}  # model options


@pytest.mark.parametrize("case", list(GRAD_CASES), ids=list(GRAD_CASES))
def test_eqv2_parameter_gradients_match_jax(case):
    """Both heads; the JAX model on its XLA path (its Pallas kernels'
    gradients are held to that path by ``tests/test_pallas_kernels.py:
    398-435``, its rotation kernel's against the port by the drops test
    below, every kernel's VJP against the port's by
    ``tests/test_torch_kernels.py``) and, for the conditional model,
    ``batch.energy`` feeding the energy embedding."""
    kw = dict(MODES["denoising-two-heads"], **GRAD_CASES[case])
    variables = jax_init(kw)
    batch = make_batch(np.random.default_rng(12))
    want_out, want = _jax_loss_grads(JaxEquiformerV2(**TINY, **kw), variables, batch)
    got_out, got = _port_loss_grads(port(kw, variables), to_torch_batch(batch))
    for g, w in zip(_outputs(got_out), _outputs(want_out)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    _assert_grads_match(got, want, **GRAD_TOL)
    if "energy_encoding" in kw:
        assert np.abs(want["energy_embedding"]["kernel"]).max() > 0  # the energies reach the loss


DROPS = dict(alpha_drop=0.3, drop_path_rate=0.25, proj_drop=0.2)


@pytest.mark.parametrize("rotate", [False, True], ids=["rotate-off", "rotate-on"])
def test_eqv2_drops_match_jax_with_injected_masks(monkeypatch, rotate):
    """A train-mode forward and its gradients with all three drop rates on:
    the same masks, made with numpy, go into both models in the order of
    their draws (per block: the attention's alpha drop, then drop path and
    projection drop on the attention branch, then on the FFN branch).  The
    JAX model rotates by its XLA chain or by its rotation kernel in
    interpret mode."""
    kw = dict(MODES["denoising-two-heads"], **DROPS)
    variables = jax_init(kw)
    batch = make_batch(np.random.default_rng(13))
    rng, masks = np.random.default_rng(14), []

    def jax_bernoulli(key, p, shape):
        masks.append((float(p), tuple(shape), rng.random(shape) < p))
        return jnp.asarray(masks[-1][2])

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    _interpret_kernels(monkeypatch, ("eqv2_edge_rotate", "eqv2_gather_rotate_to"))
    jmodel = JaxEquiformerV2(**TINY, **kw, training=True, use_pallas_rotate=rotate)
    want_out, want = _jax_loss_grads(jmodel, variables, batch, rngs={"dropout": jax.random.PRNGKey(3)})
    n_blocks = TINY["num_layers"]
    assert [m[1] for m in masks] == [(2, 24, 12, TINY["num_heads"]), (2, 1, 1, 1), (2, 24, 1, 16), (2, 1, 1, 1),
                                     (2, 24, 1, 16)] * n_blocks

    replay = iter(masks)

    def port_bernoulli(generator, keep, shape, device):
        p, want_shape, mask = next(replay)
        assert (keep, tuple(shape)) == (pytest.approx(p), want_shape) and isinstance(generator, torch.Generator)
        return torch.from_numpy(mask).to(device)

    monkeypatch.setattr(port_eqv2, "bernoulli_keep", port_bernoulli)
    model = port(dict(kw, training=True), variables)
    got_out, got = _port_loss_grads(model, to_torch_batch(batch), dropout_generator=torch.Generator().manual_seed(0))
    assert next(replay, None) is None
    for g, w in zip(_outputs(got_out), _outputs(want_out)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    _assert_grads_match(got, want, **GRAD_TOL)


@pytest.mark.parametrize("option", ["alpha_drop", "drop_path_rate", "proj_drop"])
def test_drop_rates_act_only_in_train_mode(option):
    """A train-mode forward draws its masks from the generator it is given
    (the same seed gives the same output, the eval forward differs from it
    and needs no generator); without a generator it raises rather than use
    the global RNG."""
    kw = dict(MODES["denoising-two-heads"], **{option: 0.5})
    model = EquiformerV2(**TINY, **kw, training=True, device="cpu", generator=torch.Generator().manual_seed(4))
    batch = to_torch_batch(make_batch(np.random.default_rng(15)))
    with torch.no_grad():
        a = model(batch, dropout_generator=torch.Generator().manual_seed(5))[0]
        b = model(batch, dropout_generator=torch.Generator().manual_seed(5))[0]
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        with pytest.raises(ValueError, match="dropout_generator"):
            model(batch)
        model.eval()
        assert (model(batch)[0] - a).abs().max() > 1e-6


def test_pallas_rotate_option_is_the_plain_chain_on_the_cpu():
    """``use_pallas_rotate`` (like ``use_pallas`` and ``use_pallas_conv1``)
    is accepted for config compatibility and changes nothing: no parameter
    name, no output.  On the CPU the rotations run the kernel's plain
    version, the decomposed chain; no launch is counted."""
    variables = jax_init(MODES["denoising-two-heads"])
    batch = to_torch_batch(make_batch(np.random.default_rng(16)))
    before = dict(kernels.launches)
    with torch.no_grad():
        on = port(dict(MODES["denoising-two-heads"], use_pallas_rotate=True), variables)(batch)
        off = port(dict(MODES["denoising-two-heads"], use_pallas_rotate=False), variables)(batch)
    for a, b in zip(on, off):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert dict(kernels.launches) == before
