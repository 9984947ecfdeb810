"""PyTorch port: reverse diffusion and DiffusionEngine against the JAX
package, with JAX's random numbers fed to the port.

The port's sampler takes its draws as tensors: ``frac`` from
``uniform(k_init, (B, 3))`` after ``k_init, k_noise = split(key)``, and per
step key ``k`` of ``split(k_noise, T)`` the SDE normals ``z`` from
``split(k)[0]`` and ``zr`` from ``split(k)[1]``, as
``adsorbdiff_tpu/diffusion/sampler.py`` draws them.  Positions agree to
1e-4 A after 10 steps: the model outputs agree to f32 roundoff and the
steps add them up.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adsorbdiff_tpu.diffusion.sampler import init_placement as jax_init_placement
from adsorbdiff_tpu.diffusion.sampler import reverse_diffusion as jax_reverse_diffusion
from adsorbdiff_tpu.models.equiformer_v2 import EquiformerV2 as JaxEquiformerV2
from adsorbdiff_tpu.models.painn import PaiNN as JaxPaiNN
from adsorbdiff_tpu.relaxation.ml_relaxation import DiffusionEngine as JaxDiffusionEngine
from adsorbdiff_tpu_torch.diffusion.sampler import init_placement, reverse_diffusion
from adsorbdiff_tpu_torch.models.equiformer_v2 import EquiformerV2, eqv2_state_dict_from_jax
from adsorbdiff_tpu_torch.models.painn import PaiNN, painn_state_dict_from_jax
from adsorbdiff_tpu_torch.relaxation.ml_relaxation import DiffusionEngine, make_score_fn
from tests.port_bridge import to_numpy, to_torch_batch
from tests.test_diffusion import make_batch
from tests.test_equiformer_v2 import TINY as EQV2_TINY
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(num_steps=10, ads_std_low=0.1, ads_std_high=10.0, rot_std_low=0.01, rot_std_high=1.55)
MODEL_KW = dict(hidden_channels=32, num_layers=2, num_rbf=8, cutoff=6.0, max_neighbors=20,
                cell_reps=(1, 1, 0), max_ads=8)


def jax_draws(key, batch_size, num_steps):
    """The random numbers JAX's reverse_diffusion draws from ``key``."""
    k_init, k_noise = jax.random.split(key)
    frac = jax.random.uniform(k_init, (batch_size, 3))
    keys = jax.random.split(k_noise, num_steps)
    z = jnp.stack([jax.random.normal(jax.random.split(k)[0], (batch_size, 3)) for k in keys])
    zr = jnp.stack([jax.random.normal(jax.random.split(k)[1], (batch_size, 3)) for k in keys])
    return {name: torch.from_numpy(np.array(v)) for name, v in dict(frac=frac, noise=z, rot_noise=zr).items()}


@pytest.fixture(scope="module")
def models():
    batch = make_batch(np.random.default_rng(0))
    jmodel = JaxPaiNN(**MODEL_KW, so3_denoising=True, sampling=True)
    variables = jax.tree.map(np.asarray, dict(jmodel.init(jax.random.PRNGKey(1), batch)))
    model = PaiNN(**MODEL_KW, sampling=True, device="cpu")
    model.load_state_dict(painn_state_dict_from_jax(variables))
    return jmodel, variables, model


def _jax_score_fn(jmodel, variables):
    def score_fn(cur, static=None):
        out1, out2 = jmodel.apply(variables, cur, static)
        return out1, jnp.where(cur.fixed[..., None], 0.0, out2)

    return score_fn


def test_init_placement_matches_jax():
    batch = make_batch(np.random.default_rng(1))
    key = jax.random.PRNGKey(3)
    draws = jax_draws(key, batch.batch_size, 1)
    want = jax_init_placement(jax.random.split(key)[0], batch)
    got = init_placement(to_torch_batch(batch), frac=draws["frac"])
    np.testing.assert_allclose(to_numpy(got.pos), np.asarray(want.pos), atol=1e-5)


@pytest.mark.parametrize("ode", [True, False], ids=["ode", "sde"])
def test_reverse_diffusion_matches_jax(models, ode):
    """10 steps of the tiny PaiNN with the hoisted static graph."""
    jmodel, variables, model = models
    params = dict(PARAMS, ode=ode)
    batch = make_batch(np.random.default_rng(2))
    key = jax.random.PRNGKey(4)
    want = jax.jit(lambda b, k: jax_reverse_diffusion(
        _jax_score_fn(jmodel, variables), b, params, k, static_fn=jmodel.prepare_static))(batch, key)
    got = reverse_diffusion(
        make_score_fn(model), to_torch_batch(batch), params, static_fn=model.prepare_static,
        **jax_draws(key, batch.batch_size, params["num_steps"]),
    )
    assert got.traj_pos.shape == (11, 3, 24, 3)
    np.testing.assert_allclose(to_numpy(got.traj_pos), np.asarray(want.traj_pos), atol=1e-4)
    assert int(got.converged_at) == int(want.converged_at)
    assert got.converged_at.dtype == torch.int32


def test_convergence_freeze_matches_jax():
    """A small constant score: the steps shrink with sigma until |dx| <= 1e-3
    for 10 steps and the updates freeze; the freeze step and the final
    positions match JAX."""
    batch = make_batch(np.random.default_rng(3))
    score = np.zeros(batch.pos.shape, np.float32)
    score[..., 0] = 0.01

    def jax_score_fn(cur):
        return jnp.asarray(score), jnp.zeros_like(cur.pos)

    def score_fn(cur):
        return torch.from_numpy(score), torch.zeros_like(cur.pos)

    params = dict(PARAMS, num_steps=40, ode=True)
    key = jax.random.PRNGKey(5)
    want = jax_reverse_diffusion(jax_score_fn, batch, params, key)
    got = reverse_diffusion(score_fn, to_torch_batch(batch), params, frac=jax_draws(key, 3, 1)["frac"])
    assert 10 < int(want.converged_at) < 40  # the freeze happened mid-run
    assert int(got.converged_at) == int(want.converged_at)
    np.testing.assert_allclose(to_numpy(got.traj_pos), np.asarray(want.traj_pos), atol=1e-4)


def test_diffusion_engine_matches_jax(models):
    """The slice end to end: DiffusionEngine(make_score_fn(model), ...,
    static_fn=model.prepare_static) against the JAX DiffusionEngine."""
    jmodel, variables, model = models
    batch = make_batch(np.random.default_rng(6))
    key = jax.random.PRNGKey(7)
    want = JaxDiffusionEngine(_jax_score_fn(jmodel, variables), PARAMS, static_fn=jmodel.prepare_static).run(batch, key)
    engine = DiffusionEngine(make_score_fn(model), PARAMS, static_fn=model.prepare_static, device="cpu")
    got = engine.run(to_torch_batch(batch), **jax_draws(key, batch.batch_size, PARAMS["num_steps"]))
    np.testing.assert_allclose(to_numpy(got.batch.pos), np.asarray(want.batch.pos), atol=1e-4)
    np.testing.assert_allclose(to_numpy(got.traj_pos), np.asarray(want.traj_pos), atol=1e-4)


@pytest.mark.parametrize("ode", [True, False], ids=["ode", "sde"])
def test_diffusion_engine_runs_eqv2_like_jax(ode):
    """The EquiformerV2 slice end to end: a few steps of the tiny EqV2 score
    model under DiffusionEngine, with the hoisted static graph and JAX's
    draws, against the JAX engine on the JAX model (XLA path).  atol 2e-4 A:
    with 3 steps from sigma 10 A a step moves the adsorbate by g^2 dt ~ 30
    A^2 times the score, so the models' f32 round-off (~5e-7 of their
    outputs) grows to ~1e-4 A in the positions."""
    kw = dict(EQV2_TINY, cell_reps=(1, 1, 0), max_ads=8, sampling=True)
    batch = make_batch(np.random.default_rng(10))
    jmodel = JaxEquiformerV2(**kw)
    variables = jax.tree.map(np.asarray, dict(jmodel.init(jax.random.PRNGKey(11), batch)))
    model = EquiformerV2(**kw, device="cpu")
    model.load_state_dict(eqv2_state_dict_from_jax(variables))
    params = dict(PARAMS, num_steps=3, ode=ode)
    key = jax.random.PRNGKey(12)
    want = JaxDiffusionEngine(_jax_score_fn(jmodel, variables), params, static_fn=jmodel.prepare_static).run(batch, key)
    engine = DiffusionEngine(make_score_fn(model), params, static_fn=model.prepare_static, device="cpu")
    got = engine.run(to_torch_batch(batch), **jax_draws(key, batch.batch_size, params["num_steps"]))
    assert got.traj_pos.shape == (4,) + tuple(batch.pos.shape)
    np.testing.assert_allclose(to_numpy(got.traj_pos), np.asarray(want.traj_pos), atol=2e-4)
    np.testing.assert_allclose(to_numpy(got.batch.pos), np.asarray(want.batch.pos), atol=2e-4)


def test_diffusion_engine_generator_draws_are_reproducible(models):
    _, _, model = models
    batch = to_torch_batch(make_batch(np.random.default_rng(8)))
    engine = DiffusionEngine(make_score_fn(model), dict(PARAMS, num_steps=3, ode=False), device="cpu")
    a = engine.run(batch, generator=torch.Generator().manual_seed(0))
    b = engine.run(batch, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a.traj_pos, b.traj_pos, rtol=0, atol=0)
    assert torch.isfinite(a.traj_pos).all()
    slab = ~to_numpy(batch.ads_mask)
    np.testing.assert_array_equal(to_numpy(a.batch.pos)[slab], to_numpy(batch.pos)[slab])


def test_diffusion_engine_unported_paths_raise(tmp_path):
    with pytest.raises(NotImplementedError):
        DiffusionEngine(lambda b: None, PARAMS, sampler="langevin", device="cpu")
    engine = DiffusionEngine(lambda b: None, PARAMS, device="cpu")
    with pytest.raises(NotImplementedError, match="trajectory"):
        engine.run(to_torch_batch(make_batch(np.random.default_rng(9))), traj_dir=str(tmp_path))
