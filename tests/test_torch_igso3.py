"""PyTorch port: IGSO(3) tables and lookups against the JAX package.

The omega grid, CDF and score tables are bitwise JAX's (the same float64
construction, cast to f32).  The expected score norm is JAX's bitwise where JAX's
series is resolved (eps grid rows below 115 and above 605) and finite and
smooth everywhere; JAX's is non-finite or far off in between (a deliberate
difference, ``adsorbdiff_tpu_torch/ops/igso3.py::_build_tables``).
Lookups: 1e-6 relative for interpolated values, from f32 log10 and division
taken by another library.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adsorbdiff_tpu.ops import igso3 as jax_igso3
from adsorbdiff_tpu_torch.ops import igso3
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

# eps 0.01 and 2.0 (the grid's ends), values inside the rows where both
# expected-score-norm tables agree, and random values across the range
EPS = np.concatenate([
    [0.01, 2.0, 0.012, 0.02, 0.3, 1.0, 1.55],
    10 ** np.random.default_rng(0).uniform(-2, np.log10(2.0), 60),
]).astype(np.float32)
RESOLVED_ROWS = np.r_[0:115, 606:1000]


@pytest.fixture(scope="module")
def tables():
    return jax_igso3.get_tables(), igso3.get_tables()


def test_tables_match_jax(tables):
    want, got = tables
    np.testing.assert_array_equal(got.omegas, want.omegas)
    np.testing.assert_array_equal(got.cdf, want.cdf)
    np.testing.assert_array_equal(got.score_norms, want.score_norms)  # NaN where JAX has NaN
    np.testing.assert_array_equal(got.exp_score_norms[RESOLVED_ROWS], want.exp_score_norms[RESOLVED_ROWS])


def test_expected_score_norm_is_finite_and_smooth(tables):
    """Everywhere ~0.69/eps at small eps and decreasing; JAX's table is not
    finite on this grid (the fault the port's tables repair)."""
    want, got = tables
    norms = got.exp_score_norms
    assert np.isfinite(norms).all() and (np.diff(norms) < 0).all()
    eps = 10.0 ** np.linspace(np.log10(igso3.MIN_EPS), np.log10(igso3.MAX_EPS), igso3.N_EPS)
    np.testing.assert_allclose((norms * eps)[:600], 0.69, rtol=0.02)
    assert not np.isfinite(want.exp_score_norms).all()


def test_eps_index_matches_jax():
    got = igso3.eps_index(torch.from_numpy(EPS)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_igso3.eps_index(jnp.asarray(EPS))))
    assert got[0] == 0 and got[1] == igso3.N_EPS - 1


def test_interp_follows_jnp_interp():
    """Repeated xp values (zero-width intervals), x below, on and above the
    ends, and x equal to a repeated value (side='right')."""
    xp = np.array([0.0, 0.1, 0.1, 0.1, 0.5, 0.5, 1.0], np.float32)
    fp = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0], np.float32)
    x = np.array([-1.0, 0.0, 0.05, 0.1, 0.3, 0.5, 0.75, 1.0, 2.0], np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    got = igso3.interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_omega_matches_jax_on_its_uniforms():
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_igso3.sample_omega(key, jnp.asarray(EPS)))
    u = torch.from_numpy(np.array(jax.random.uniform(key, EPS.shape)))  # sample_omega's own draw
    got = igso3.sample_omega(torch.from_numpy(EPS), uniforms=u).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got > 0).all() and (got <= np.pi).all()


def test_sample_vec_matches_jax_on_its_draws():
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_igso3.sample_vec(key, jnp.asarray(EPS)))
    k_dir, k_om = jax.random.split(key)
    normals = torch.from_numpy(np.array(jax.random.normal(k_dir, EPS.shape + (3,))))
    uniforms = torch.from_numpy(np.array(jax.random.uniform(k_om, EPS.shape)))
    got = igso3.sample_vec(torch.from_numpy(EPS), normals=normals, uniforms=uniforms).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_score_vec_and_score_norm_match_jax():
    rng = np.random.default_rng(5)
    vec = (rng.normal(size=EPS.shape + (3,)) * 0.5).astype(np.float32)
    vec[2] = 0.0  # zero rotation: the 1e-12 guard
    want = np.asarray(jax_igso3.score_vec(jnp.asarray(EPS), jnp.asarray(vec)))
    got = igso3.score_vec(torch.from_numpy(EPS), torch.from_numpy(vec)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    rows = igso3.eps_index(torch.from_numpy(EPS)).numpy()
    both = np.isin(rows, RESOLVED_ROWS)
    assert both[:2].all()  # eps 0.01 and 2.0
    norm = igso3.score_norm(torch.from_numpy(EPS)).numpy()
    np.testing.assert_array_equal(norm[both], np.asarray(jax_igso3.score_norm(jnp.asarray(EPS)))[both])
    assert np.isfinite(norm).all()


def test_sample_vec_is_its_angle_along_a_unit_axis():
    rng = np.random.default_rng(6)
    eps = torch.from_numpy(EPS)
    normals = torch.from_numpy(rng.normal(size=EPS.shape + (3,)).astype(np.float32))
    uniforms = torch.from_numpy(rng.random(EPS.shape).astype(np.float32))
    vec = igso3.sample_vec(eps, normals, uniforms)
    torch.testing.assert_close(torch.linalg.norm(vec, dim=-1), igso3.sample_omega(eps, uniforms))
    cos = (vec * normals).sum(-1) / (torch.linalg.norm(vec, dim=-1) * torch.linalg.norm(normals, dim=-1))
    torch.testing.assert_close(cos, torch.ones_like(cos))
