"""PyTorch port: the training-time noise schedules against the JAX package,
with the draws the JAX functions make from their key.

Tolerance 1e-5 (abs and rel) on positions and targets: f32 fractional
coordinates (a 3x3 solve), Rodrigues rotations and the IGSO(3)
interpolation, taken by another library; the score targets divide by
sigma^2 >= 0.01, hence atol 1e-4 there.
"""
import jax
import numpy as np
import pytest
import torch

from adsorbdiff_tpu.diffusion.schedules import ads_com_gaussian_schedule as jax_ads_com
from adsorbdiff_tpu.diffusion.schedules import tr_so3_schedule as jax_tr_so3
from adsorbdiff_tpu_torch.diffusion.schedules import ads_com_gaussian_schedule, tr_so3_schedule
from tests.port_bridge import jax_schedule_draws, to_numpy, to_torch_batch
from tests.test_painn import make_batch
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(ads_std_low=0.1, ads_std_high=10.0, rot_std_low=0.01, rot_std_high=1.55)  # configs/denoising/base.yml


def _compare(got, want):
    (noised, targets), (jnoised, jtargets) = got, want
    np.testing.assert_allclose(to_numpy(noised.pos), np.asarray(jnoised.pos), atol=1e-5, rtol=1e-5)
    for name in ("tr_sigma", "rot_sigma", "noise_vec"):
        np.testing.assert_allclose(to_numpy(getattr(targets, name)), np.asarray(getattr(jtargets, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    for name in ("tr_score", "rot_score"):
        np.testing.assert_allclose(to_numpy(getattr(targets, name)), np.asarray(getattr(jtargets, name)),
                                   atol=1e-4, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tr_so3_schedule_matches_jax(seed):
    jbatch = make_batch(np.random.default_rng(seed), b=4)
    key = jax.random.PRNGKey(seed)
    want = jax_tr_so3(key, jbatch, PARAMS)
    batch = to_torch_batch(jbatch)
    got = tr_so3_schedule(batch, PARAMS, draws=jax_schedule_draws(key, 4, so3=True))
    _compare(got, want)
    slab = ~batch.ads_mask
    assert torch.equal(got[0].pos[slab], batch.pos[slab])  # only the adsorbate moves


@pytest.mark.parametrize("seed", [0, 1])
def test_ads_com_gaussian_schedule_matches_jax(seed):
    jbatch = make_batch(np.random.default_rng(10 + seed), b=3)
    key = jax.random.PRNGKey(10 + seed)
    want = jax_ads_com(key, jbatch, PARAMS)
    got = ads_com_gaussian_schedule(to_torch_batch(jbatch), PARAMS, draws=jax_schedule_draws(key, 3, so3=False))
    _compare(got, want)


def test_schedules_draw_from_a_generator():
    batch = to_torch_batch(make_batch(np.random.default_rng(20), b=3))
    for fn in (tr_so3_schedule, ads_com_gaussian_schedule):
        a = fn(batch, PARAMS, torch.Generator().manual_seed(1))
        b = fn(batch, PARAMS, torch.Generator().manual_seed(1))
        torch.testing.assert_close(a[0].pos, b[0].pos, rtol=0, atol=0)
        assert torch.isfinite(a[1].tr_score).all() and torch.isfinite(a[1].rot_score).all()
