"""PyTorch port: the whole EquiformerV2 against the JAX model, the pinned
goldens, padding, equivariance and the options not ported yet.

The JAX model runs the S^2 activation through its Pallas kernel in interpret
mode (``use_pallas=True``, patched as ``tests/test_pallas_kernels.py:338-351``
does) and the first SO(2) conv on the XLA path (``use_pallas_conv1=False``,
the path ``tests/test_pallas_kernels.py:357-395`` holds the conv1 kernel to);
the port always runs its two kernels' plain versions on the CPU.  Tolerance
atol 5e-5, rtol 1e-4: the one the JAX package uses between its own two paths
(``tests/test_pallas_kernels.py:352``).
"""
import functools

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import adsorbdiff_tpu.ops.pallas_kernels as pk
from adsorbdiff_tpu.models.equiformer_v2 import EquiformerV2 as JaxEquiformerV2
from adsorbdiff_tpu_torch.common.registry import registry
from adsorbdiff_tpu_torch.models.equiformer_v2 import EquiformerV2, eqv2_state_dict_from_jax
from adsorbdiff_tpu_torch.train.trainer import DenoisingTrainer
from tests.port_bridge import to_numpy, to_torch_batch
from tests.test_equiformer_v2 import TINY
from tests.test_model_goldens import GOLDEN
from tests.test_painn import make_batch

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


@pytest.mark.parametrize(
    "kw",
    [dict(use_pallas_rotate=True), dict(compute_dtype="bfloat16"), dict(grid_mode="e3nn"),
     dict(training=True, alpha_drop=0.1), dict(training=True, drop_path_rate=0.1), dict(training=True, proj_drop=0.1)],
    ids=["pallas-rotate", "bfloat16", "e3nn-grid", "alpha-drop", "drop-path", "proj-drop"],
)
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EquiformerV2(**TINY, **kw, device="cpu")


def test_training_flag_without_drop_rates_is_the_eval_forward():
    EquiformerV2(**TINY, training=True, device="cpu")


def test_denoising_trainer_on_equiformer_v2_raises():
    with pytest.raises(NotImplementedError, match="B.4"):
        DenoisingTrainer({"model": {"name": "equiformer_v2"}, "optim": {}, "cpu": True})
