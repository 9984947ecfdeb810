"""PyTorch port: the SO(3) tables and the edge-frame rotation against
:mod:`adsorbdiff_tpu.models.so3`.

The numpy tables are the port's own copies and must equal JAX's bit for bit
(they are what trained weights mean).  The rotations are f32 chains of small
constant matmuls taken in another order: atol 2e-6, the tolerance of the JAX
package's own rotation-kernel test (``tests/test_pallas_kernels.py:287``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adsorbdiff_tpu.models import so3 as jso3
from adsorbdiff_tpu_torch.models import so3
from adsorbdiff_tpu_torch.ops.kernels import conv1_blocks
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

LM = [(4, 2), (2, 1), (3, 3)]


def _assert_tree_equal(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("lmax,mmax", LM)
def test_numpy_tables_equal_jax_bit_for_bit(lmax, mmax):
    pts = np.random.default_rng(0).normal(size=(17, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    n_act = so3.n_act_rows(lmax, mmax)
    assert n_act == jso3.n_act_rows(lmax, mmax)
    for name, args in [
        ("real_sph_harm", (lmax, pts)),
        ("get_J_matrix", (lmax,)),
        ("_zrot_indices", (lmax,)),
        ("zrot_swap_sign", (lmax,)),
        ("_rot_decomp_mats", (lmax, mmax, n_act)),
        ("_rot_decomp_mats", (lmax, mmax, lmax + 1)),
        ("l_expand_matrix", (lmax,)),
        ("s2_grid_matrices", (lmax, 18, 18)),
        ("s2_grid_matrices", (lmax, 18, 18, "e3nn")),
        ("soft_grid_weights", (18,)),
        ("m_primary_order", (lmax, mmax)),
        ("m_trunc_rescale", (lmax, mmax)),
    ]:
        _assert_tree_equal(getattr(so3, name)(*args), getattr(jso3, name)(*args))


def test_production_layout_has_19_active_rows():
    """19 rows in m-blocks of 5 (m=0), 4 (m=+-1) and 3 (m=+-2), as the
    attention kernel reads them."""
    assert so3.n_act_rows(4, 2) == 19
    ranges = so3.m_primary_order(4, 2)[1]
    assert tuple(b - a for a, b in ranges) == (5, 4, 4, 3, 3)
    assert conv1_blocks(4, 2) == (5, 4, 3)


def test_e3nn_grid_mode_raises():
    """The e3nn grid is ported (JAX's tables bit for bit, above); a mode that
    neither package knows still raises."""
    _assert_tree_equal(so3.s2_grid_matrices(2, 8, 8, mode="e3nn"), jso3.s2_grid_matrices(2, 8, 8, mode="e3nn"))
    with pytest.raises(ValueError, match="unknown s2 grid mode"):
        so3.s2_grid_matrices(2, 8, 8, mode="lebedev")


def _geometry(seed, b=2, n=5, k=4):
    rng = np.random.default_rng(seed)
    unit = rng.normal(size=(b, n, k, 3))
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    unit[0, 0, 0] = [0.0, 0.0, 1.0]  # on the pole
    unit[0, 0, 1] = [0.0, 0.0, -1.0]
    unit[1, -1] = 0.0  # masked slots carry a zero unit vector
    return unit.astype(np.float32)


def test_edge_euler_angles_match_jax():
    unit = _geometry(1)
    g_want, b_want = jso3.edge_euler_angles(jnp.asarray(unit))
    g_got, b_got = so3.edge_euler_angles(torch.from_numpy(unit))
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), atol=2e-6)
    np.testing.assert_allclose(b_got.numpy(), np.asarray(b_want), atol=2e-6)


@pytest.mark.parametrize("lmax,mmax", LM)
@pytest.mark.parametrize("node_level", [False, True], ids=["edge", "node-broadcast"])
def test_rotate_to_edge_m_matches_jax(lmax, mmax, node_level):
    """Edge-level input, or node-level input with a singleton neighbour axis
    broadcast against per-edge angles (the attention's target half)."""
    rng = np.random.default_rng(2)
    unit = _geometry(3)
    b, n, k, _ = unit.shape
    x = rng.normal(size=(b, n, 1 if node_level else k, (lmax + 1) ** 2, 6)).astype(np.float32)
    gamma, beta = jso3.edge_euler_angles(jnp.asarray(unit))
    want = jso3.rotate_to_edge_m(jnp.asarray(x), gamma, beta, lmax, mmax)
    tg, tb = so3.edge_euler_angles(torch.from_numpy(unit))
    got = so3.rotate_to_edge_m(torch.from_numpy(x), tg, tb, lmax, mmax)
    assert got.shape == (b, n, k, so3.n_act_rows(lmax, mmax), 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("lmax,mmax", LM)
@pytest.mark.parametrize("rows", ["n_act", "n0"])
def test_rotate_from_edge_m_matches_jax(lmax, mmax, rows):
    """All truncated rows (the attention) and only the m=0 block (the
    edge-degree embedding)."""
    n_rows = so3.n_act_rows(lmax, mmax) if rows == "n_act" else lmax + 1
    unit = _geometry(4)
    v = np.random.default_rng(5).normal(size=unit.shape[:3] + (n_rows, 7)).astype(np.float32)
    gamma, beta = jso3.edge_euler_angles(jnp.asarray(unit))
    want = jso3.rotate_from_edge_m(jnp.asarray(v), gamma, beta, lmax, mmax)
    tg, tb = so3.edge_euler_angles(torch.from_numpy(unit))
    got = so3.rotate_from_edge_m(torch.from_numpy(v), tg, tb, lmax, mmax)
    assert got.shape == unit.shape[:3] + ((lmax + 1) ** 2, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_rotation_round_trip_on_active_rows():
    """rotate_from(rotate_to(x)) keeps exactly the |m| <= mmax edge-frame
    content: applied twice it is a projection."""
    lmax, mmax = 4, 2
    unit = torch.from_numpy(_geometry(6)[:1, :2])
    g, b = so3.edge_euler_angles(unit)
    x = torch.randn(unit.shape[:3] + (25, 3), generator=torch.Generator().manual_seed(0))
    once = so3.rotate_from_edge_m(so3.rotate_to_edge_m(x, g, b, lmax, mmax), g, b, lmax, mmax)
    twice = so3.rotate_from_edge_m(so3.rotate_to_edge_m(once, g, b, lmax, mmax), g, b, lmax, mmax)
    torch.testing.assert_close(twice, once, atol=2e-5, rtol=0)


def test_l1_coeffs_to_vector_matches_jax():
    c = np.random.default_rng(7).normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_array_equal(so3.l1_coeffs_to_vector(torch.from_numpy(c)).numpy(),
                                  np.asarray(jso3.l1_coeffs_to_vector(jnp.asarray(c))))


def test_device_table_is_copied_once():
    table = so3.m_trunc_rescale(4, 2)
    a = so3.device_table(table, torch.device("cpu"))
    assert so3.device_table(table, torch.device("cpu")) is a
    assert so3.device_table(table, torch.device("cpu"), torch.float64).dtype == torch.float64


@pytest.mark.parametrize("lmax,mmax", LM)
@pytest.mark.parametrize("n_sel", ["n_act", "n0", "dim"])
def test_edge_rot_consts_hold_the_jax_kernel_constants(lmax, mmax, n_sel):
    """The rotation kernel's constants (J's diagonal blocks, the Dz signs,
    the P_sel row map) rebuild every matrix of the JAX package's
    ``_edge_rot_consts`` bit for bit, in both directions."""
    from adsorbdiff_tpu.ops.pallas_kernels import _edge_rot_consts

    dim = (lmax + 1) ** 2
    n_sel = {"n_act": so3.n_act_rows(lmax, mmax), "n0": lmax + 1, "dim": dim}[n_sel]
    j_blocks, sign, row = so3.edge_rot_consts(lmax, mmax, n_sel)
    j = np.zeros((dim, dim), np.float32)
    off = 0
    for l in range(lmax + 1):
        n = 2 * l + 1
        j[l * l:l * l + n, l * l:l * l + n] = j_blocks[off:off + n * n].reshape(n, n)
        off += n * n
    assert off == j_blocks.size
    l_of = np.concatenate([np.full(2 * l + 1, l) for l in range(lmax + 1)])
    m_of = np.concatenate([np.arange(-l, l + 1) for l in range(lmax + 1)])
    swap = l_of**2 + l_of - m_of
    psel = np.zeros((n_sel, dim), np.float32)
    psel[row[row >= 0], np.nonzero(row >= 0)[0]] = 1.0
    assert (row >= 0).sum() == n_sel
    for direction in ("to", "from"):
        s1, s2, s3, expc, exps, dp = _edge_rot_consts(lmax, mmax, n_sel, direction)
        np.testing.assert_array_equal(expc[:dim].argmax(1), np.abs(m_of))
        np.testing.assert_array_equal(exps[:dim].sum(1), sign if direction == "to" else -sign)
        if direction == "to":
            np.testing.assert_array_equal(s2[:dim, :dim], j.T)
            np.testing.assert_array_equal(s2[dp:dp + dim, :dim], j.T[swap])
            np.testing.assert_array_equal(s3[:n_sel, :dim], psel @ j)
        else:
            np.testing.assert_array_equal(s1[:dim, :n_sel], (psel @ j).T)
            np.testing.assert_array_equal(s2[:dim, :dim], j)
            np.testing.assert_array_equal(s2[dp:dp + dim, :dim], j[swap])
