"""PyTorch port: the Hopper kernels and their plain versions.

Each plain version is held against its JAX function (Pallas in interpret
mode on the CPU) and against the JAX package's own plain formulation.  Tests marked ``cuda`` hold the Hopper kernel
against the plain version and skip without a card; they import no JAX, so on
the card they run with ``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``.

Tolerances: 1e-5 (abs and rel, the JAX package's own test) for the S^2 grid
activation; 1e-5 + 1e-5 * max|JAX| (abs) for the EquiformerV2 attention front
half, whose 600-term basis products and ~1000-term conv sums are taken in
another order; 1e-4 (abs and rel) for the PaiNN message, whose R-term filter
sums and K-term reductions are taken in another order than the Pallas
kernel's f32 matmuls; 2e-4 (abs and rel, the JAX package's own VJP test) for
its gradients, whose dW and db sum over every edge of the batch; atol 2e-4 (the JAX package's own quad-chain test) and
rtol 1e-5 for the GemNet-OC quadruplet chain, whose outputs sum K2 x S x Q =
1680 products of O(1) terms in another order.
"""
import numpy as np
import pytest
import torch

from adsorbdiff_tpu_torch.ops import kernels
from adsorbdiff_tpu_torch.ops.kernels import (
    eqv2_attn_conv1,
    eqv2_attn_conv1_reference,
    gemnet_quad_chain,
    gemnet_quad_chain_reference,
    painn_message_fused,
    painn_message_fused_bwd,
    painn_message_fused_bwd_reference,
    painn_message_fused_reference,
    s2_grid_silu,
    s2_grid_silu_reference,
)

RAGGED = (2, 13, 10, 16, 64)  # b, n, k, r, h of tests/test_pallas_kernels.py:114 and :164
GRAD_NAMES = ("xh", "vec", "weight", "bias")
QUAD = (1, 4, 30, 8, 30, 7, 16, 16)  # b, n, u, q, k2, s, e, f of tests/test_pallas_kernels.py:561
QUAD_RAGGED = (2, 3, 12, 4, 13, 4, 8, 8)


def _inputs(seed, b, n, k, r, h, cutoff=6.0):
    """Masked slots (20%), distances past the cutoff, and a padded target
    row with an all-false mask."""
    rng = np.random.default_rng(seed)
    mask = rng.random((b, n, k)) > 0.2
    mask[:, -1] = False
    return dict(
        xh=rng.normal(0, 1, (b, n, 3 * h)).astype(np.float32),
        vec=rng.normal(0, 1, (b, n, 3 * h)).astype(np.float32),
        src=rng.integers(0, n, (b, n, k)).astype(np.int32),
        dist=rng.uniform(0, 1.2 * cutoff, (b, n, k)).astype(np.float32),
        mask=mask,
        unit=rng.normal(0, 1, (b, n, k, 3)).astype(np.float32),
        weight=rng.normal(0, 0.2, (r, 3 * h)).astype(np.float32),
        bias=rng.normal(0, 0.1, 3 * h).astype(np.float32),
    )


def _torch(inputs, device="cpu"):
    return {name: torch.from_numpy(v).to(device) for name, v in inputs.items()}


def _cotangents(seed, b, n, h):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, n, h)).astype(np.float32), rng.normal(0, 1, (b, n, 3, h)).astype(np.float32))


def _jax_vjp(inputs, cts, exponent=5):
    """Gradients of the JAX ``painn_message_fused`` (its Pallas backward
    kernel in interpret mode) for xh, vec, weight, bias."""
    import jax
    import jax.numpy as jnp

    from adsorbdiff_tpu.ops.pallas_kernels import painn_message_fused as jax_painn_message_fused

    fixed = {k: jnp.asarray(inputs[k]) for k in ("src", "dist", "mask", "unit")}

    def f(xh, vec, weight, bias):
        return jax_painn_message_fused(xh, vec, fixed["src"], fixed["dist"], fixed["mask"], fixed["unit"],
                                       weight, bias, cutoff=6.0, envelope_exponent=exponent, ti=4)

    _, vjp = jax.vjp(f, *(jnp.asarray(inputs[k]) for k in GRAD_NAMES))
    return [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cts))]


@pytest.mark.parametrize("exponent", [5, 6])
def test_bwd_reference_matches_jax_vjp(exponent):
    """The plain VJP against ``jax.vjp`` through the Pallas backward kernel."""
    inputs = _inputs(11, *RAGGED, cutoff=7.0 / 1.2)  # dist up to 7 A, as tests/test_pallas_kernels.py:164
    cts = _cotangents(12, *RAGGED[:2], RAGGED[4])
    want = _jax_vjp(inputs, cts, exponent)
    cx, cv = map(torch.from_numpy, cts)
    got = painn_message_fused_bwd_reference(**_torch(inputs), dx_ct=cx, dvec_ct=cv, cutoff=6.0,
                                            envelope_exponent=exponent)
    assert [tuple(g.shape) for g in got] == [(2, 13, 192), (2, 13, 192), (16, 192), (192,)]
    for g, w, name in zip(got, want, GRAD_NAMES):
        np.testing.assert_allclose(g.numpy(), w.reshape(g.shape), atol=2e-4, rtol=2e-4, err_msg=name)


def test_autograd_function_gradients_match_jax_and_plain_vjp():
    """Autograd through ``painn_message_fused`` (its Function on CPU tensors)
    gives the plain VJP exactly and JAX's gradients within 2e-4; the
    geometry inputs get no gradient (the JAX contract)."""
    inputs = _inputs(13, *RAGGED)
    cts = _cotangents(14, *RAGGED[:2], RAGGED[4])
    leaves = _torch(inputs)
    for name in GRAD_NAMES + ("dist", "unit"):
        leaves[name].requires_grad_(True)
    dx, dv = painn_message_fused(**leaves, cutoff=6.0)
    assert type(dx.grad_fn).__name__ == "PainnMessageFusedBackward"
    ((dx * torch.from_numpy(cts[0])).sum() + (dv * torch.from_numpy(cts[1])).sum()).backward()
    cx, cv = map(torch.from_numpy, cts)
    plain = painn_message_fused_bwd_reference(**_torch(inputs), dx_ct=cx, dvec_ct=cv, cutoff=6.0)
    want = _jax_vjp(inputs, cts)
    for name, p, w in zip(GRAD_NAMES, plain, want):
        got = leaves[name].grad
        torch.testing.assert_close(got, p.reshape(got.shape), rtol=0, atol=0)
        np.testing.assert_allclose(got.numpy(), w.reshape(got.shape), atol=2e-4, rtol=2e-4, err_msg=name)
    assert leaves["dist"].grad is None and leaves["unit"].grad is None


def test_autograd_reaches_the_linear_weight_through_its_transpose():
    """PaiNN passes ``rbf_proj.weight.t().contiguous()``: the weight gradient
    must arrive on the Linear's own ``[3H, R]`` weight."""
    b, n, k, r, h = RAGGED
    inputs = _torch(_inputs(15, *RAGGED))
    lin = torch.nn.Linear(r, 3 * h)
    dx, dv = painn_message_fused(**dict(inputs, weight=lin.weight.t().contiguous(), bias=lin.bias), cutoff=6.0)
    cx, cv = map(torch.from_numpy, _cotangents(16, b, n, h))
    ((dx * cx).sum() + (dv * cv).sum()).backward()
    _, _, dw, db = painn_message_fused_bwd_reference(
        **dict(inputs, weight=lin.weight.detach().t().contiguous(), bias=lin.bias.detach()), dx_ct=cx, dvec_ct=cv,
        cutoff=6.0)
    torch.testing.assert_close(lin.weight.grad, dw.t(), rtol=0, atol=0)
    torch.testing.assert_close(lin.bias.grad, db, rtol=0, atol=0)


def test_bwd_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    inputs = _torch(_inputs(17, *RAGGED))
    cx, cv = map(torch.from_numpy, _cotangents(18, *RAGGED[:2], RAGGED[4]))
    before = dict(kernels.launches)
    got = painn_message_fused_bwd(**inputs, dx_ct=cx, dvec_ct=cv, cutoff=6.0)
    want = painn_message_fused_bwd_reference(**inputs, dx_ct=cx, dvec_ct=cv, cutoff=6.0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert dict(kernels.launches) == before


@pytest.mark.parametrize("exponent", [5, 6])
def test_reference_matches_jax_fused_kernel(exponent):
    import jax.numpy as jnp

    from adsorbdiff_tpu.ops.pallas_kernels import painn_message_fused as jax_painn_message_fused

    inputs = _inputs(0, *RAGGED)
    want_dx, want_dv = jax_painn_message_fused(
        *(jnp.asarray(inputs[k]) for k in ("xh", "vec", "src", "dist", "mask", "unit", "weight", "bias")),
        cutoff=6.0, envelope_exponent=exponent, ti=8,
    )
    dx, dv = painn_message_fused_reference(**_torch(inputs), cutoff=6.0, envelope_exponent=exponent)
    assert dx.shape == (2, 13, 64) and dv.shape == (2, 13, 3, 64)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv), atol=1e-4, rtol=1e-4)


def test_reference_masked_slots_contribute_nothing():
    inputs = _inputs(1, *RAGGED)
    dx, dv = painn_message_fused_reference(**_torch(inputs), cutoff=6.0)
    assert not dx[:, -1].any() and not dv[:, -1].any()  # padded target
    # rewiring masked slots to other sources changes nothing
    rewired = dict(inputs, src=np.where(inputs["mask"], inputs["src"], (inputs["src"] + 5) % 13).astype(np.int32))
    dx2, dv2 = painn_message_fused_reference(**_torch(rewired), cutoff=6.0)
    torch.testing.assert_close(dx2, dx, rtol=0, atol=0)
    torch.testing.assert_close(dv2, dv, rtol=0, atol=0)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    inputs = _torch(_inputs(2, *RAGGED))
    before = kernels.launches["painn_message_fused"]
    dx, dv = painn_message_fused(**inputs, cutoff=6.0)
    want_dx, want_dv = painn_message_fused_reference(**inputs, cutoff=6.0)
    torch.testing.assert_close(dx, want_dx, rtol=0, atol=0)
    torch.testing.assert_close(dv, want_dv, rtol=0, atol=0)
    assert kernels.launches["painn_message_fused"] == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU or interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [RAGGED, (1, 7, 50, 128, 192), (3, 5, 3, 8, 128), (1, 5, 120, 128, 64), (2, 80, 50, 128, 512)],
    ids=["ragged", "k50-h192", "k3", "smem-over-48k", "sampling-width"],
)
def test_kernel_matches_plain_version_on_card(cuda_device, shape):
    """|kernel - plain| <= 1e-4 * max|plain| + 1e-5 (f32 sums in another order)."""
    inputs = _torch(_inputs(3, *shape), cuda_device)
    before = kernels.launches["painn_message_fused"]
    dx, dv = painn_message_fused(**inputs, cutoff=6.0)
    torch.cuda.synchronize()
    assert kernels.launches["painn_message_fused"] == before + 1
    want_dx, want_dv = painn_message_fused_reference(**inputs, cutoff=6.0)
    for got, want in ((dx, want_dx), (dv, want_dv)):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item() + 1e-5, err


@pytest.mark.cuda
def test_kernel_wrapper_raises_instead_of_falling_back(cuda_device):
    inputs = _torch(_inputs(4, *RAGGED), cuda_device)
    with pytest.raises(TypeError, match="src must be torch.int32"):
        painn_message_fused(**dict(inputs, src=inputs["src"].long()), cutoff=6.0)
    with pytest.raises(ValueError, match="contiguous"):
        painn_message_fused(**dict(inputs, xh=inputs["xh"].transpose(0, 1).contiguous().transpose(0, 1)), cutoff=6.0)
    with pytest.raises(ValueError, match="shape"):
        painn_message_fused(**dict(inputs, unit=inputs["unit"][..., :2].contiguous()), cutoff=6.0)
    with pytest.raises(ValueError, match="R <= 128"):
        painn_message_fused_bwd(**dict(inputs, weight=torch.zeros((129, 3 * RAGGED[4]), device=cuda_device)),
                                dx_ct=torch.zeros((2, 13, 64), device=cuda_device),
                                dvec_ct=torch.zeros((2, 13, 3, 64), device=cuda_device), cutoff=6.0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [RAGGED, (1, 7, 50, 128, 192), (3, 5, 3, 8, 128), (1, 5, 120, 128, 64), (48, 80, 50, 128, 512)],
    ids=["ragged", "k50-h192", "k3", "k120", "training-width"],
)
def test_bwd_kernel_matches_plain_version_on_card(cuda_device, shape):
    """|kernel - plain| <= 1e-4 * max|plain| + 1e-5 for dxh, dvec, dW and db
    (atomics sum in another order on every run)."""
    b, n, k, r, h = shape
    inputs = _torch(_inputs(19, *shape), cuda_device)
    cts = [torch.from_numpy(c).to(cuda_device) for c in _cotangents(20, b, n, h)]
    before = kernels.launches["painn_message_fused_bwd"]
    got = painn_message_fused_bwd(**inputs, dx_ct=cts[0], dvec_ct=cts[1], cutoff=6.0)
    torch.cuda.synchronize()
    assert kernels.launches["painn_message_fused_bwd"] == before + 1
    want = painn_message_fused_bwd_reference(**inputs, dx_ct=cts[0], dvec_ct=cts[1], cutoff=6.0)
    for name, g, w in zip(GRAD_NAMES, got, want):
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-5, (name, err)


@pytest.mark.cuda
def test_autograd_on_card_launches_forward_and_backward_kernels(cuda_device):
    """One backward through the Function: one launch of each kernel, and the
    gradients of the plain VJP within its tolerance."""
    b, n, k, r, h = RAGGED
    inputs = _torch(_inputs(21, *RAGGED), cuda_device)
    for name in GRAD_NAMES:
        inputs[name].requires_grad_(True)
    cx, cv = (torch.from_numpy(c).to(cuda_device) for c in _cotangents(22, b, n, h))
    before = dict(kernels.launches)
    dx, dv = painn_message_fused(**inputs, cutoff=6.0)
    ((dx * cx).sum() + (dv * cv).sum()).backward()
    torch.cuda.synchronize()
    assert kernels.launches["painn_message_fused"] == before.get("painn_message_fused", 0) + 1
    assert kernels.launches["painn_message_fused_bwd"] == before.get("painn_message_fused_bwd", 0) + 1
    plain = painn_message_fused_bwd_reference(**{k_: v.detach() for k_, v in inputs.items()}, dx_ct=cx, dvec_ct=cv,
                                              cutoff=6.0)
    for name, w in zip(GRAD_NAMES, plain):
        g = inputs[name].grad.reshape(w.shape)
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-5, name


def _quad_inputs(seed, b, n, u, q, k2, s, e, f, zero_rows=False):
    """Random chain inputs with -1 main-edge keys (never match), keys drawn
    from a small range so that c == d collisions are frequent, and, with
    ``zero_rows``, zero n1/n2 rows (masked edges have unit = 0)."""
    rng = np.random.default_rng(seed)
    n1 = rng.normal(size=(b, n, u, q, 3)).astype(np.float32)
    n2 = rng.normal(size=(b, n, q, k2, 3)).astype(np.float32)
    if zero_rows:
        n1[:, :, -2:] = 0.0
        n2[:, :, :, -3:] = 0.0
    key1 = rng.integers(0, 50, size=(b, n, u)).astype(np.int32)
    key1[..., -3:] = -1
    key2 = rng.integers(0, 50, size=(b, n, q, k2)).astype(np.int32)
    return dict(
        n1=n1, n2=n2, key1=key1, key2=key2,
        xm=rng.normal(size=(b, n, q, k2, e)).astype(np.float32),
        qp=rng.normal(size=(b, n, u, s, q, f)).astype(np.float32),
    )


@pytest.mark.parametrize("zero_rows", [False, True], ids=["random", "zero-rows"])
def test_quad_chain_reference_matches_jax(zero_rows):
    """Against JAX ``_quad_chain_ref`` and the Pallas kernel in interpret mode."""
    import jax.numpy as jnp

    from adsorbdiff_tpu.ops.pallas_kernels import _quad_chain_ref
    from adsorbdiff_tpu.ops.pallas_kernels import gemnet_quad_chain as jax_gemnet_quad_chain

    s = QUAD[5]
    inputs = _quad_inputs(5, *QUAD, zero_rows=zero_rows)
    args = [jnp.asarray(inputs[k]) for k in ("n1", "n2", "key1", "key2", "xm", "qp")]
    got = gemnet_quad_chain_reference(**_torch(inputs), num_spherical=s).numpy()
    assert got.shape == (1, 4, 30, 16, 16)
    np.testing.assert_allclose(got, np.asarray(_quad_chain_ref(*args, s)), atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_gemnet_quad_chain(*args, s, interpret=True)), atol=2e-4, rtol=1e-5)


def test_quad_chain_reference_exclusions():
    """-1 main keys give zero rows; equal keys drop exactly their (q, k) terms."""
    inputs = _quad_inputs(6, *QUAD_RAGGED)
    s = QUAD_RAGGED[5]
    out = gemnet_quad_chain_reference(**_torch(inputs), num_spherical=s)
    assert not out[:, :, -3:].any()
    # a main edge whose key equals every in-edge key is excluded everywhere
    collide = dict(inputs, key2=np.full_like(inputs["key2"], 7))
    collide["key1"] = inputs["key1"].copy()
    collide["key1"][:, :, 0] = 7
    out_c = gemnet_quad_chain_reference(**_torch(collide), num_spherical=s)
    assert not out_c[:, :, 0].any() and out_c[:, :, 1].abs().max() > 0


def test_quad_chain_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    inputs = _torch(_quad_inputs(7, *QUAD_RAGGED))
    before = kernels.launches["gemnet_quad_chain"]
    got = gemnet_quad_chain(**inputs, num_spherical=QUAD_RAGGED[5])
    torch.testing.assert_close(got, gemnet_quad_chain_reference(**inputs, num_spherical=QUAD_RAGGED[5]),
                               rtol=0, atol=0)
    assert kernels.launches["gemnet_quad_chain"] == before


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [QUAD, QUAD_RAGGED, (2, 80, 30, 8, 30, 7, 32, 32), (1, 2, 5, 1, 3, 3, 5, 7)],
    ids=["jax-test", "ragged", "relax-width", "q1-odd-f"],
)
def test_quad_chain_kernel_matches_plain_version_on_card(cuda_device, shape):
    """|kernel - plain| <= 1e-4 * max|plain| + 1e-5 (f32 sums in another order)."""
    inputs = _torch(_quad_inputs(8, *shape, zero_rows=True), cuda_device)
    s = shape[5]
    before = kernels.launches["gemnet_quad_chain"]
    got = gemnet_quad_chain(**inputs, num_spherical=s)
    torch.cuda.synchronize()
    assert kernels.launches["gemnet_quad_chain"] == before + 1
    want = gemnet_quad_chain_reference(**inputs, num_spherical=s)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item() + 1e-5, err


@pytest.mark.cuda
def test_quad_chain_wrapper_raises_instead_of_falling_back(cuda_device):
    inputs = _torch(_quad_inputs(9, *QUAD_RAGGED), cuda_device)
    s = QUAD_RAGGED[5]
    with pytest.raises(TypeError, match="key1 must be torch.int32"):
        gemnet_quad_chain(**dict(inputs, key1=inputs["key1"].long()), num_spherical=s)
    with pytest.raises(ValueError, match="contiguous"):
        gemnet_quad_chain(**dict(inputs, xm=inputs["xm"].transpose(3, 4).contiguous().transpose(3, 4)),
                          num_spherical=s)
    with pytest.raises(ValueError, match="shape"):
        gemnet_quad_chain(**inputs, num_spherical=s + 1)
    with pytest.raises(NotImplementedError, match="backward"):
        gemnet_quad_chain(**dict(inputs, qp=inputs["qp"].requires_grad_()), num_spherical=s)


@pytest.mark.cuda
def test_empty_outputs_launch_nothing(cuda_device):
    """A call whose output is empty returns it without a launch, so the
    launch counts rise only where a kernel runs."""
    before = dict(kernels.launches)
    dx, dvec = painn_message_fused(**_torch(_inputs(10, 0, 5, 4, 8, 16), cuda_device), cutoff=6.0)
    assert dx.shape == (0, 5, 16) and dvec.shape == (0, 5, 3, 16)
    shape = (1, 3, 0, 2, 4, 3, 5, 7)  # U = 0
    out = gemnet_quad_chain(**_torch(_quad_inputs(10, *shape), cuda_device), num_spherical=shape[5])
    assert out.shape == (1, 3, 0, 7, 5)
    assert dict(kernels.launches) == before


# --------------------------------------------------------------------------
# EquiformerV2: s2_grid_silu and eqv2_attn_conv1
# --------------------------------------------------------------------------
def _s2_tables(lmax=4, mmax=2, res=18):
    """The attention's effective grid matrices: m-primary columns, the
    m-truncation rescale folded in."""
    from adsorbdiff_tpu_torch.models.equiformer_v2 import s2_act_matrices

    return s2_act_matrices(lmax, mmax, res)


def test_s2_grid_silu_reference_matches_jax_kernel():
    """At the shapes of tests/test_pallas_kernels.py:238-247, against the
    Pallas kernel in interpret mode."""
    import jax.numpy as jnp

    from adsorbdiff_tpu.ops.pallas_kernels import s2_grid_silu as jax_s2_grid_silu

    to_m, from_m = _s2_tables()
    h = np.random.default_rng(0).normal(size=(3, 5, to_m.shape[1], 16)).astype(np.float32)
    want = jax_s2_grid_silu(jnp.asarray(h), jnp.asarray(to_m), jnp.asarray(from_m), tile_m=128, interpret=True)
    got = s2_grid_silu_reference(torch.from_numpy(h), torch.from_numpy(to_m), torch.from_numpy(from_m))
    assert got.shape == h.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_s2_grid_silu_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    to_m, from_m = (torch.from_numpy(t) for t in _s2_tables(2, 1, 8))
    h = torch.randn((2, 3, 4, to_m.shape[1], 5), generator=torch.Generator().manual_seed(1))
    before = dict(kernels.launches)
    torch.testing.assert_close(s2_grid_silu(h, to_m, from_m), s2_grid_silu_reference(h, to_m, from_m),
                               rtol=0, atol=0)
    assert dict(kernels.launches) == before


# (lmax, mmax, lead, C per half, c_out, extra, R, emb/trunk width, cutoff)
CONV1_TINY = (2, 1, (2, 5, 4), 16, 16, 32, 16, 16, 6.0)  # tests/test_equiformer_v2.py:11-29 widths
CONV1_L4 = (4, 2, (3, 13), 8, 8, 12, 40, 16, 6.0)  # the production block structure (5, 4, 3), narrow


def _conv1_inputs(seed, lmax, mmax, lead, c, c_out, extra, r, width, cutoff):
    """Edge inputs with masked slots and distances past the cutoff, and the
    RadialFunction / SO2Conv parameter trees (flax layouts) as numpy."""
    rng = np.random.default_rng(seed)
    nb = tuple(lmax + 1 - m for m in range(mmax + 1))
    n_act = nb[0] + 2 * sum(nb[1:])

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    edges = dict(
        dist=rng.uniform(0, 1.1 * cutoff, lead).astype(np.float32),
        mask=rng.random(lead) > 0.2,
        emb_s=normal(*lead, width), emb_t=normal(*lead, width),
        msg_s=normal(*lead, n_act, c), msg_t=normal(*lead, n_act, c),
    )
    n_rad = 2 * sum(nb) * c
    rad = {
        "dense_0": {"kernel": normal(r + 2 * width, width, scale=0.2), "bias": normal(width, scale=0.1)},
        "ln_0": {"scale": 1 + normal(width, scale=0.1), "bias": normal(width, scale=0.1)},
        "dense_1": {"kernel": normal(width, width, scale=0.25), "bias": normal(width, scale=0.1)},
        "ln_1": {"scale": 1 + normal(width, scale=0.1), "bias": normal(width, scale=0.1)},
        "dense_2": {"kernel": normal(width, n_rad, scale=0.25), "bias": normal(n_rad, scale=0.1)},
    }
    conv = {"fc_m0": {"kernel": normal(nb[0] * 2 * c, extra + nb[0] * c_out, scale=0.1),
                      "bias": normal(extra + nb[0] * c_out, scale=0.1)}}
    for mi in range(1, mmax + 1):
        for part in ("r", "i"):
            conv[f"fc_m{mi}_{part}"] = {"kernel": normal(nb[mi] * 2 * c, nb[mi] * c_out, scale=0.1)}
    kw = dict(lmax=lmax, mmax=mmax, c_out=c_out, extra=extra, num_gauss=r, cutoff=cutoff)
    return edges, rad, conv, kw


def _torch_tree(tree, device="cpu"):
    return {k: _torch_tree(v, device) if isinstance(v, dict) else torch.from_numpy(v).to(device)
            for k, v in tree.items()}


@pytest.mark.parametrize("case", [CONV1_TINY, CONV1_L4], ids=["tiny-l2m1", "l4m2"])
def test_attn_conv1_reference_matches_jax_kernel(case):
    """The plain version (weights repacked by the port) against the JAX
    ``eqv2_attn_conv1``'s Pallas kernel in interpret mode."""
    import jax.numpy as jnp

    from adsorbdiff_tpu.ops.pallas_kernels import eqv2_attn_conv1 as jax_eqv2_attn_conv1

    edges, rad, conv, kw = _conv1_inputs(30, *case)
    jtree = lambda t: {k: jtree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in t.items()}  # noqa: E731
    want_h, want_x = jax_eqv2_attn_conv1(*(jnp.asarray(edges[k]) for k in edges), jtree(rad), jtree(conv), **kw,
                                         interpret=True)
    got_h, got_x = eqv2_attn_conv1_reference(*(torch.from_numpy(edges[k]) for k in edges), _torch_tree(rad),
                                             _torch_tree(conv), **kw)
    assert got_h.shape == want_h.shape and got_x.shape == want_x.shape
    for got, want in ((got_h, want_h), (got_x, want_x)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 + 1e-5 * np.abs(want).max(), rtol=0)


def test_attn_conv1_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    edges, rad, conv, kw = _conv1_inputs(31, *CONV1_TINY)
    args = [torch.from_numpy(edges[k]) for k in edges] + [_torch_tree(rad), _torch_tree(conv)]
    before = dict(kernels.launches)
    got = eqv2_attn_conv1(*args, **kw)
    want = eqv2_attn_conv1_reference(*args, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert dict(kernels.launches) == before


def test_attn_conv1_masked_edges_still_get_outputs():
    """A padded edge (mask 0) has a zero gaussian basis but its embeddings and
    messages still flow: it gets the same output as any edge whose basis
    underflows, and the attention zeroes it later."""
    edges, rad, conv, kw = _conv1_inputs(32, *CONV1_TINY)
    t = {k: torch.from_numpy(v) for k, v in edges.items()}
    far = dict(t, dist=torch.full_like(t["dist"], 1e3), mask=torch.ones_like(t["mask"]))
    off = dict(t, mask=torch.zeros_like(t["mask"]))
    got_far = eqv2_attn_conv1_reference(**far, rad_params=_torch_tree(rad), conv_params=_torch_tree(conv), **kw)
    got_off = eqv2_attn_conv1_reference(**off, rad_params=_torch_tree(rad), conv_params=_torch_tree(conv), **kw)
    for a, b in zip(got_far, got_off):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert a.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "lmax,mmax,shape",
    [(4, 2, (3, 5, 19, 16)), (2, 1, (2, 24, 12, 7, 16)), (4, 2, (1, 80, 20, 19, 64)), (3, 3, (37, 16, 33)),
     (1, 1, (5, 4, 1))],
    ids=["jax-test", "tiny", "sampling-width", "ragged", "nc4-c1"],
)
def test_s2_grid_silu_kernel_matches_plain_version_on_card(cuda_device, lmax, mmax, shape):
    """|kernel - plain| <= 1e-4 * max|plain| + 1e-5 (f32 sums in another order)."""
    to_m, from_m = (torch.from_numpy(t).to(cuda_device) for t in _s2_tables(lmax, mmax, 18 if lmax == 4 else 8))
    assert to_m.shape[1] == shape[-2]
    h = torch.from_numpy(np.random.default_rng(33).normal(size=shape).astype(np.float32)).to(cuda_device)
    before = kernels.launches["s2_grid_silu"]
    got = s2_grid_silu(h, to_m, from_m)
    torch.cuda.synchronize()
    assert kernels.launches["s2_grid_silu"] == before + 1
    want = s2_grid_silu_reference(h, to_m, from_m)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case",
    [CONV1_TINY, CONV1_L4, (4, 2, (37,), 128, 64, 576, 600, 128, 12.0), (4, 2, (2, 40, 20), 128, 64, 576, 600, 128, 12.0),
     (3, 1, (19,), 5, 3, 7, 9, 6, 4.0)],
    ids=["tiny", "l4m2", "ragged-full-width", "sampling-width", "odd-widths"],
)
def test_attn_conv1_kernel_matches_plain_version_on_card(cuda_device, case):
    """|kernel - plain| <= 1e-4 * max|plain| + 1e-5 per output."""
    edges, rad, conv, kw = _conv1_inputs(34, *case)
    args = [torch.from_numpy(edges[k]).to(cuda_device) for k in edges]
    args += [_torch_tree(rad, cuda_device), _torch_tree(conv, cuda_device)]
    before = kernels.launches["eqv2_attn_conv1"]
    got = eqv2_attn_conv1(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["eqv2_attn_conv1"] == before + 1
    for g, w in zip(got, eqv2_attn_conv1_reference(*args, **kw)):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-5


@pytest.mark.cuda
def test_eqv2_kernel_wrappers_raise_instead_of_falling_back(cuda_device):
    edges, rad, conv, kw = _conv1_inputs(35, *CONV1_TINY)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in edges.items()}
    trees = dict(rad_params=_torch_tree(rad, cuda_device), conv_params=_torch_tree(conv, cuda_device))
    with pytest.raises(TypeError, match="mask must be torch.bool"):
        eqv2_attn_conv1(**dict(t, mask=t["mask"].float()), **trees, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        eqv2_attn_conv1(**dict(t, emb_t=t["emb_t"][:, :, :1].expand_as(t["emb_t"])), **trees, **kw)
    with pytest.raises(ValueError, match="rows"):
        eqv2_attn_conv1(**dict(t, msg_s=t["msg_s"][..., 1:, :].contiguous(), msg_t=t["msg_t"][..., 1:, :].contiguous()),
                        **trees, **kw)
    to_m, from_m = (torch.from_numpy(x).to(cuda_device) for x in _s2_tables(2, 1, 8))
    with pytest.raises(ValueError, match="shape"):
        s2_grid_silu(torch.zeros((4, 6, 3), device=cuda_device), to_m, from_m)
    with pytest.raises(ValueError, match="NC <= 32"):
        s2_grid_silu(torch.zeros((4, 33, 3), device=cuda_device), torch.zeros((10, 33), device=cuda_device),
                     torch.zeros((33, 10), device=cuda_device))
    with pytest.raises(NotImplementedError, match="backward"):
        s2_grid_silu(torch.zeros((4, 7, 3), device=cuda_device, requires_grad=True), to_m, from_m)


@pytest.mark.cuda
def test_eqv2_empty_outputs_launch_nothing(cuda_device):
    before = dict(kernels.launches)
    to_m, from_m = (torch.from_numpy(x).to(cuda_device) for x in _s2_tables(2, 1, 8))
    assert s2_grid_silu(torch.zeros((0, 7, 4), device=cuda_device), to_m, from_m).shape == (0, 7, 4)
    edges, rad, conv, kw = _conv1_inputs(36, *CONV1_TINY[:2], (0,), *CONV1_TINY[3:])
    h, x = eqv2_attn_conv1(*(torch.from_numpy(edges[k]).to(cuda_device) for k in edges),
                           _torch_tree(rad, cuda_device), _torch_tree(conv, cuda_device), **kw)
    assert h.shape == (0, 7, 16) and x.shape == (0, 32)
    assert dict(kernels.launches) == before
