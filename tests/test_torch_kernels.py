"""PyTorch port: the Hopper kernels and their plain versions.

Each plain version is held against its JAX function (Pallas in interpret
mode on the CPU) and against the JAX package's own plain formulation.  Tests marked ``cuda`` hold the Hopper kernel
against the plain version and skip without a card; they import no JAX, so on
the card they run with ``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``.

Tolerances: 1e-4 (abs and rel) for the PaiNN message, whose R-term filter
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
    gemnet_quad_chain,
    gemnet_quad_chain_reference,
    painn_message_fused,
    painn_message_fused_bwd,
    painn_message_fused_bwd_reference,
    painn_message_fused_reference,
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
