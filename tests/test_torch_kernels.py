"""PyTorch port: the Hopper kernels and their plain versions.

Each plain version is held against its JAX function (Pallas in interpret
mode on the CPU) and against the JAX package's own plain formulation.  Tests marked ``cuda`` hold the Hopper kernel
against the plain version and skip without a card; they import no JAX, so on
the card they run with ``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``.

Tolerances: 1e-5 (abs and rel, the JAX package's own test) for the S^2 grid
activation and 2e-5 (the JAX package's own VJP test) for its backward; 2e-6
(abs, the JAX package's own rotation test) for the edge-frame rotation and
its VJPs; 1e-5 + 1e-5 * max|JAX| (abs) for the EquiformerV2 attention front
half and its gradients, whose 600-term basis products and ~1000-term conv
sums are taken in another order; 1e-4 (abs and rel) for the PaiNN message, whose R-term filter
sums and K-term reductions are taken in another order than the Pallas
kernel's f32 matmuls; 2e-4 (abs and rel, the JAX package's own VJP test) for
its gradients, whose dW and db sum over every edge of the batch; atol 2e-4 (the JAX package's own quad-chain test) and
rtol 1e-5 for the GemNet-OC quadruplet chain, whose outputs sum K2 x S x Q =
1680 products of O(1) terms in another order; 1e-5 (abs and rel, the JAX
package's own quad-basis test) for the masked Legendre bases.
"""
import numpy as np
import pytest
import torch

from adsorbdiff_tpu_torch.ops import kernels
from adsorbdiff_tpu_torch.ops.kernels import (
    eqv2_attn_conv1,
    eqv2_attn_conv1_reference,
    eqv2_edge_rotate,
    eqv2_edge_rotate_reference,
    eqv2_gather_rotate_to,
    eqv2_gather_rotate_to_reference,
    gemnet_quad_chain,
    gemnet_quad_chain_reference,
    painn_message_fused,
    painn_message_fused_bwd,
    painn_message_fused_bwd_reference,
    painn_message_fused_reference,
    s2_grid_silu,
    s2_grid_silu_bwd,
    s2_grid_silu_bwd_reference,
    s2_grid_silu_reference,
)
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

RAGGED = (2, 13, 10, 16, 64)  # b, n, k, r, h of tests/test_pallas_kernels.py:114 and :164
GRAD_NAMES = ("xh", "vec", "weight", "bias")
QUAD = (1, 4, 30, 8, 30, 7, 16, 16)  # b, n, u, q, k2, s, e, f of tests/test_pallas_kernels.py:561
QUAD_RAGGED = (2, 3, 12, 4, 13, 4, 8, 8)
QUAD_RELAX = (8, 80, 30, 8, 30, 7, 32, 32)  # the relaxation path's shape (chip_smoke.py phase 3)
QUAD_E40_F48 = (2, 3, 7, 4, 13, 7, 40, 48)  # two passes of 32 columns e and of 32 columns f
QUAD_S9 = (1, 3, 9, 5, 11, 9, 16, 16)  # two passes of 8 levels
QUAD_S9_E40_F48 = (1, 3, 9, 5, 11, 9, 40, 48)
QUAD_UNALIGNED = (2, 4, 10, 3, 7, 5, 12, 9)  # S * Q * F = 135: 4-byte copies into padded rows
QUAD_U_SPLIT = (1, 1, 16, 8, 30, 7, 32, 32)  # one cell: its 16 main edges dealt over two blocks


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


def _bwd_case(seed, shape, fill):
    """Kernel inputs of :func:`_inputs` with ``fill``: "masked-system" (every
    slot of system 1 masked) or "bad-src" (sources -1 and N + 5 on unmasked
    slots), and the inputs the plain VJP takes for them (out-of-range sources
    as masked slots: the kernel's contract)."""
    inputs = _inputs(seed, *shape)
    n = shape[1]
    if fill == "masked-system":
        inputs["mask"][1] = False
    elif fill == "bad-src":
        inputs["src"][..., ::7] = -1
        inputs["src"][..., 3::11] = n + 5
    ok = (inputs["src"] >= 0) & (inputs["src"] < n)
    return inputs, dict(inputs, src=np.where(ok, inputs["src"], 0).astype(np.int32), mask=inputs["mask"] & ok)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,fill,cols,stage,glob", [
    ((3, 80, 50, 128, 512), None, 8, True, False), ((5, 80, 50, 128, 512), None, 16, True, False),
    ((9, 120, 50, 128, 512), None, 32, False, False), ((2, 300, 45, 128, 64), None, 8, True, False),
    ((9, 300, 20, 128, 512), None, 16, False, False), ((1, 1200, 20, 128, 64), None, 8, False, True),
    ((3, 80, 50, 128, 96), "masked-system", 8, True, False), ((2, 80, 50, 128, 64), "bad-src", 8, True, False),
    ((2, 80, 50, 128, 200), None, 8, True, False),
], ids=["n80-b3", "n80-b5", "n120-b9", "n300", "n300-b9", "n1200-global", "masked-system", "bad-src", "h200"])
def test_bwd_kernel_plans_match_plain_version_on_card(cuda_device, shape, fill, cols, stage, glob):
    """Each branch of the plan (column width, staged rows, global atomics),
    an all-masked system, sources outside [0, N) and H not a multiple of 32,
    against the plain VJP: |kernel - plain| <= 1e-4 * max|plain| + 1e-5 for
    dxh, dvec, dW and db (32 columns with staged rows: the training-width
    case above)."""
    b, n, k, r, h = shape
    plan = kernels.painn_bwd_plan(b, n, k, r, h, kernels._sm_count(cuda_device))
    assert (plan.cols, plan.stage_rows, plan.global_scatter) == (cols, stage, glob)
    raw, plain = _bwd_case(23, shape, fill)
    inputs, plain = _torch(raw, cuda_device), _torch(plain, cuda_device)
    cts = [torch.from_numpy(c).to(cuda_device) for c in _cotangents(24, b, n, h)]
    before = kernels.launches["painn_message_fused_bwd"]
    got = painn_message_fused_bwd(**inputs, dx_ct=cts[0], dvec_ct=cts[1], cutoff=6.0)
    torch.cuda.synchronize()
    assert kernels.launches["painn_message_fused_bwd"] == before + 1
    want = painn_message_fused_bwd_reference(**plain, dx_ct=cts[0], dvec_ct=cts[1], cutoff=6.0)
    for name, g, w in zip(GRAD_NAMES, got, want):
        err = (g - w).abs().max().item()
        assert torch.isfinite(g).all() and err <= 1e-4 * w.abs().max().item() + 1e-5, (name, err)


def _fwd_case(seed, shape, fill):
    """:func:`_bwd_case`'s fills plus "past-cutoff": every slot of system 0
    unmasked, half of them at or past the cutoff (they add xh * bias)."""
    if fill != "past-cutoff":
        return _bwd_case(seed, shape, fill)
    inputs = _inputs(seed, *shape)
    inputs["mask"][0] = True
    inputs["dist"][0, :, ::2] = np.linspace(6.0, 9.0, inputs["dist"][0, :, ::2].size).reshape(
        inputs["dist"][0, :, ::2].shape)
    return inputs, inputs


def _check_fwd(inputs, plain):
    before = kernels.launches["painn_message_fused"]
    got = painn_message_fused(**inputs, cutoff=6.0)
    torch.cuda.synchronize()
    assert kernels.launches["painn_message_fused"] == before + 1
    want = painn_message_fused_reference(**plain, cutoff=6.0)
    for g, w in zip(got, want):
        err = (g - w).abs().max().item()
        assert torch.isfinite(g).all() and err <= 1e-4 * w.abs().max().item() + 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("shape,fill,stage_w,stage_rows", [
    ((48, 80, 50, 128, 512), None, True, True), ((9, 300, 20, 128, 512), None, True, False),
    ((1, 1200, 20, 128, 64), None, True, False), ((3, 80, 50, 128, 96), "masked-system", True, True),
    ((2, 80, 50, 128, 64), "bad-src", True, True), ((2, 80, 50, 128, 64), "past-cutoff", True, True),
    ((2, 80, 50, 128, 200), None, True, True), ((2, 80, 50, 16, 512), None, True, True),
    ((2, 80, 3, 500, 64), None, False, True), ((1, 80, 50, 128, 512), None, True, True),
    ((2, 13, 120, 128, 31), None, True, True),
], ids=["training-width", "n300", "n1200", "masked-system", "bad-src", "past-cutoff", "h200", "r16", "r500",
        "b1", "k120-h31"])
def test_fwd_kernel_plans_match_plain_version_on_card(cuda_device, shape, fill, stage_w, stage_rows):
    """Each branch of the forward plan (W and rows staged or read through
    L1/L2), an all-masked system, sources outside [0, N), unmasked slots
    past the cutoff, H not a multiple of 32 and odd, R = 16, one system,
    against the plain version: |kernel - plain| <= 1e-4 * max|plain| + 1e-5."""
    b, n, k, r, h = shape
    plan = kernels.painn_fwd_plan(b, n, k, r, h, kernels._sm_count(cuda_device))
    assert (plan.stage_w, plan.stage_rows) == (stage_w, stage_rows)
    raw, plain = _fwd_case(25, shape, fill)
    _check_fwd(_torch(raw, cuda_device), _torch(plain, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_fwd_kernel_on_the_bench_graph_on_card(cuda_device, order):
    """The sampling shape (16, 80, 50, 128, 512) on the sampling path's
    neighbour table, its slots as the graph sorts them and shuffled within
    every target (wide windows), against the plain version."""
    src, dist, mask, unit = _bench_graph()
    if order == "shuffled":
        perm = torch.from_numpy(np.random.default_rng(6).permuted(np.tile(np.arange(50), (16, 80, 1)), axis=-1))
        src, dist, mask = (torch.gather(x, 2, perm) for x in (src, dist, mask))
        unit = torch.gather(unit, 2, perm[..., None].expand(-1, -1, -1, 3))
    inputs = _inputs(26, 16, 80, 50, 128, 512, cutoff=12.0)
    inputs = dict(_torch(inputs), src=src, dist=dist, mask=mask, unit=unit)
    inputs = {name: t.to(cuda_device).contiguous() for name, t in inputs.items()}
    before = kernels.launches["painn_message_fused"]
    got = painn_message_fused(**inputs, cutoff=12.0)
    torch.cuda.synchronize()
    assert kernels.launches["painn_message_fused"] == before + 1
    want = painn_message_fused_reference(**inputs, cutoff=12.0)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-5


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


@pytest.mark.parametrize("b,n", [(1, 1), (3, 13), (2, 300), (4, 80), (5, 80), (8, 80), (9, 80), (48, 80),
                                 (48, 83), (48, 165), (48, 166), (48, 394), (48, 395), (48, 853), (48, 854),
                                 (1, 2000)])
def test_bwd_plan_covers_every_system_and_column_once(b, n):
    """Every (system, column h) pair is one block's, once; a block fits in
    227 KB; the slices narrow as the systems get too few to fill a wave of
    32-column blocks (132 blocks at H = 512 from B = 9 on) and as N grows
    (the dxh/dvec accumulators of a system's rows must fit), then the
    scatter goes to global atomics; the xh/vec rows are staged where they
    fit."""
    k, r = 50, 128
    for h in (1, 31, 64, 200, 512):
        plan = kernels.painn_bwd_plan(b, n, k, r, h, sms=132)
        assert plan.smem_bytes + 16 * 16 * 5 * 4 <= 232448 and plan.threads == 512  # dynamic + static
        assert plan.blocks == b * plan.slices and plan.waves == plan.blocks / 132
        seen = np.zeros((b, h), np.int64)
        blocks = set()
        for blk, system, h0, cols in kernels.painn_bwd_work(plan, b, h):
            assert 1 <= cols <= plan.cols and blk not in blocks
            blocks.add(blk)
            seen[system, h0:h0 + cols] += 1
        assert (seen == 1).all() and len(blocks) == plan.blocks
        assert plan.scratch_ints == b * n * k + 17 * b
        assert not (plan.stage_rows and plan.global_scatter)
        if h == 512:  # the largest N each width holds at R = 128: accumulators, then staged rows too
            wide = 32 if b >= 9 else 16 if b >= 5 else 8
            fit = [c for c in (32, 16, 8) if c <= wide and n <= {32: 165, 16: 394, 8: 853}[c]]
            assert (plan.cols, plan.global_scatter) == ((fit[0], False) if fit else (wide, True))
            assert plan.stage_rows == (not plan.global_scatter and n <= {32: 82, 16: 197, 8: 426}[plan.cols])


def test_bwd_plan_refuses_nothing_the_wrapper_accepts():
    """Every R <= 128 at any N, K and H has a plan; R > 128 is refused, as the
    wrapper refuses it."""
    for n in (1, 2, 80, 300, 5000):
        for k in (1, 3, 50, 120):
            for r in (2, 16, 64, 127, 128):
                for h in (1, 8, 200, 512):
                    assert kernels.painn_bwd_plan(2, n, k, r, h, sms=132).smem_bytes <= 232448 - 5120
    with pytest.raises(ValueError, match="R <= 128"):
        kernels.painn_bwd_plan(2, 80, 50, 129, 512, sms=132)


def test_fwd_load_counts_the_busiest_scheduler():
    """The plan's closed form against the owners counted one by one: owner
    o = 16 * half + warp takes targets o, o + 32, ..; warp w runs its busier
    owner's targets on scheduler w % 4."""
    for tpb in range(1, 400):
        per = [0] * 4
        for w in range(16):
            per[w % 4] += max(len(range(o, tpb, 32)) for o in (w, w + 16))
        assert kernels._fwd_load(tpb) == max(per), tpb


def _fwd_work(plan, b, n, h):
    """The forward kernel's work as ``(block, owner, target, first column h,
    columns)``: block ``(x, y)`` (numbered ``y * ranges + x``) takes targets
    ``[x * tpb, (x + 1) * tpb)`` cut at ``B * N`` and columns ``y * 32 ..``
    cut at H; its owner ``o`` takes the block's targets ``o, o + 32, ..``
    (``csrc/painn_message_fused.cu``)."""
    t = b * n
    ranges = kernels._cdiv(t, plan.tpb)
    for y in range(plan.slices):
        h0 = y * 32
        for x in range(ranges):
            t0, t1 = x * plan.tpb, min(t, (x + 1) * plan.tpb)
            for j in range(t1 - t0):
                yield y * ranges + x, j % 32, t0 + j, h0, min(32, h - h0)


def _fwd_cost(t, slices, tpb, sms=132):
    return kernels._cdiv(kernels._cdiv(t, tpb) * slices, sms) * kernels._fwd_load(tpb)


@pytest.mark.parametrize("b", [1, 5, 16, 48])
@pytest.mark.parametrize("n", [1, 13, 80, 300, 2000])
def test_fwd_plan_covers_every_target_and_column_once(b, n):
    """Every (target, column h) pair is one block's and one owner's, once; a
    block fits in 232,448 B (the kernel has no static shared memory); the
    target range is the cheapest of every range up to 2048 targets and every
    multiple of 32 (it narrows while too few blocks fill a wave); W and the
    systems' xh/vec rows are staged only where they fit, the rows with room
    for every system a block's targets lie in."""
    t = b * n
    for h in (1, 31, 200, 512):
        slices = kernels._cdiv(h, 32)
        cheapest = min(_fwd_cost(t, slices, min(tpb, t))
                       for tpb in set(range(1, min(t, 2048) + 1)) | set(range(32, t + 32, 32)))
        for r in (2, 16, 128):
            for k in (1, 10, 50, 120):
                plan = kernels.painn_fwd_plan(b, n, k, r, h, sms=132)
                assert plan.smem_bytes <= 232448 and plan.threads == 512 and plan.slices == slices
                assert plan.smem_bytes == kernels._message_fwd_smem(r, plan.rows, plan.stage_w, plan.stage_rows)
                assert plan.stage_w == (kernels._message_fwd_smem(r, 0, True, False) <= 232448)
                assert plan.blocks == kernels._cdiv(t, plan.tpb) * slices and plan.waves == plan.blocks / 132
                if plan.stage_rows:
                    assert plan.rows >= kernels._fwd_staged_rows(t, n, plan.tpb) >= n
                else:
                    assert plan.rows == 0
                    assert kernels._message_fwd_smem(r, kernels._fwd_staged_rows(t, n, plan.tpb), plan.stage_w,
                                                     True) > 232448
                assert _fwd_cost(t, slices, plan.tpb) == cheapest
        if t * slices <= 20000:
            plan = kernels.painn_fwd_plan(b, n, 50, 128, h, sms=132)
            seen = np.zeros((t, h), np.int64)
            owners = {}
            for blk, owner, target, h0, cols in _fwd_work(plan, b, n, h):
                assert 1 <= cols <= 32 and 0 <= owner < 32 and blk < plan.blocks
                seen[target, h0:h0 + cols] += 1
                owners.setdefault((blk, owner), []).append(target)
            assert (seen == 1).all()
            per_owner = [len(v) for v in owners.values()]
            assert max(per_owner) - min(per_owner) <= 1 or plan.blocks > slices  # one block: balanced owners


def test_fwd_plan_takes_two_systems_a_block_at_the_sampling_and_training_shapes():
    """At N = 80, R = 128, H = 512 a block stages W and two systems' rows
    (227,200 B) and gives each half-warp 5 targets: one wave of 128 blocks
    at B = 16, three of 384 at B = 48."""
    for b, blocks in ((16, 128), (48, 384)):
        plan = kernels.painn_fwd_plan(b, 80, 50, 128, 512, sms=132)
        assert (plan.tpb, plan.blocks, plan.stage_w, plan.stage_rows, plan.rows) == (160, blocks, True, True, 160)
        assert plan.smem_bytes == 227200 and plan.load == 20


def _old_fwd_smem(k, r):
    """The shared bytes the old forward kernel (one block a target, the
    whole basis tile) needed: its wrapper took a shape where they fit."""
    padded = k // 16 * 16 + (k % 16 + 3) // 4 * 4
    return (r * padded + 5 * k) * 4 + (k + 2 * kernels._cdiv(k, 16)) * 4


def test_fwd_plan_refuses_nothing_the_old_wrapper_accepted():
    """Every shape whose old shared-memory tile fit 227 KB (at R = 128, K up
    to ~430; at K = 1, R up to ~14,500) has a plan that fits, W staged or
    read through L1/L2; a shape the kernel cannot take is refused by name."""
    for k in (1, 3, 50, 120, 430):
        for r in (2, 16, 128, 461, 462, 1100, 14000):
            if _old_fwd_smem(k, r) > 232448:
                continue
            for b, n in ((1, 1), (2, 80), (1, 2000), (48, 80)):
                for h in (1, 8, 200, 512):
                    plan = kernels.painn_fwd_plan(b, n, k, r, h, sms=132)
                    assert plan.smem_bytes <= 232448 and plan.stage_w == (r <= 461)
    with pytest.raises(ValueError, match=r"B, N, K, R, H = 2, 80, 50, 128, 2097153"):
        kernels.painn_fwd_plan(2, 80, 50, 128, 65536 * 32 + 1, sms=132)


def _bench_graph():
    """The neighbour table of chip_smoke.py's sampling batch: bench.py's 16
    systems (74 slab + 6 adsorbate atoms, 11.4 x 11.4 x 36 A), cutoff 12 A,
    K = 50, cell_reps (2, 2, 0)."""
    from adsorbdiff_tpu_torch.data.schema import System, collate
    from adsorbdiff_tpu_torch.models.base import generate_graph

    rng = np.random.default_rng(0)
    systems = []
    for i in range(16):
        cell = np.diag([11.4, 11.4, 36.0]).astype(np.float32)
        slab = (rng.random((74, 3)) * [1, 1, 0.35]) @ cell
        ads = rng.random((6, 3)).astype(np.float32) * 1.6 + np.array([5, 5, 14.5], np.float32)
        pos = np.concatenate([slab, ads]).astype(np.float32)
        tags = np.array([0] * 37 + [1] * 37 + [2] * 6, np.int32)
        z = np.concatenate([rng.integers(20, 80, 74), rng.integers(1, 9, 6)])
        systems.append(System(pos=pos, atomic_numbers=z, cell=cell, tags=tags, fixed=tags == 0, sid=i))
    batch = collate(systems, max_atoms=80, device="cpu")
    nl, _, unit = generate_graph(batch, cutoff=12.0, max_neighbors=50, cell_reps=(2, 2, 0))
    return nl.src, nl.dist, nl.mask, unit


def _window_products(src, dist, mask, r, cutoff):
    """(products the kernel runs over its groups' windows on valid slots,
    the non-zero basis values of the valid slots); asserts that every
    non-zero value lies inside its group's window."""
    b, n, k = src.shape
    lo, hi = kernels.painn_fwd_windows(dist, mask, src, r, cutoff)
    valid = mask & (src >= 0) & (src < n)
    nonzero = (kernels.message_basis(dist, r, cutoff, 5) != 0) & valid[..., None]
    group = torch.arange(k) // 8
    rows = torch.arange(r)
    inside = (rows >= lo[..., group, None]) & (rows <= hi[..., group, None])
    assert not (nonzero & ~inside).any()
    width = torch.clamp(hi - lo + 1, min=0)
    per_group = torch.nn.functional.pad(valid, (0, lo.shape[-1] * 8 - k)).reshape(b, n, -1, 8).sum(-1)
    return int((width * per_group).sum()), int(nonzero.sum())


def test_fwd_windows_hold_every_non_zero_basis_value_on_the_bench_graph():
    """On the sampling path's graph (slots sorted by distance) every non-zero
    basis value of a valid slot lies in its 8-slot group's rows, and the
    products run are at most 1.35x the ones needed (1.33x measured); with
    the slots of every target shuffled the windows widen but still hold
    every value."""
    src, dist, mask, _ = _bench_graph()
    ran, needed = _window_products(src, dist, mask, 128, 12.0)
    assert needed == 64000 * 28.7831875 and ran <= 1.35 * needed, ran / needed
    perm = torch.from_numpy(np.random.default_rng(5).permuted(np.tile(np.arange(50), (16, 80, 1)), axis=-1))
    shuffled = [torch.gather(x, 2, perm) for x in (src, dist, mask)]
    ran_shuffled, needed_shuffled = _window_products(*shuffled, 128, 12.0)
    assert needed_shuffled == needed and ran_shuffled > ran


@pytest.mark.parametrize("r", [2, 16, 128])
def test_fwd_windows_hold_every_non_zero_basis_value_on_random_slots(r):
    """Random distances up to 1.2 x the cutoff (centres at both ends of the
    rows and past the cutoff), masked slots and sources outside [0, N)."""
    rng = np.random.default_rng(r)
    b, n, k = 3, 20, 37
    src = torch.from_numpy(rng.integers(-2, n + 2, (b, n, k)).astype(np.int32))
    dist = torch.from_numpy(rng.uniform(0, 7.2, (b, n, k)).astype(np.float32))
    mask = torch.from_numpy(rng.random((b, n, k)) > 0.2)
    _window_products(src, dist, mask, r, 6.0)


def _quad_inputs(seed, b, n, u, q, k2, s, e, f, zero_rows=False, negative_keys=3):
    """Random chain inputs with -1 keys on the last ``negative_keys`` main
    edges (never match), keys drawn from a small range so that c == d
    collisions are frequent, and, with ``zero_rows``, zero n1/n2 rows (masked
    edges have unit = 0)."""
    rng = np.random.default_rng(seed)
    n1 = rng.normal(size=(b, n, u, q, 3)).astype(np.float32)
    n2 = rng.normal(size=(b, n, q, k2, 3)).astype(np.float32)
    if zero_rows:
        n1[:, :, -2:] = 0.0
        n2[:, :, :, -3:] = 0.0
    key1 = rng.integers(0, 50, size=(b, n, u)).astype(np.int32)
    if negative_keys:
        key1[..., -negative_keys:] = -1
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
    "shape", [QUAD, QUAD_RAGGED, (2, 80, 30, 8, 30, 7, 32, 32), (1, 2, 5, 1, 3, 3, 5, 7), QUAD_E40_F48, QUAD_S9,
              QUAD_S9_E40_F48, QUAD_UNALIGNED, QUAD_U_SPLIT, QUAD_RELAX],
    ids=["jax-test", "ragged", "relax-width", "q1-odd-f", "e40-f48", "s9", "s9-e40-f48", "unaligned-sqf", "u-split",
         "relax-shape"],
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
@pytest.mark.parametrize("shape,negative_keys", [((2, 5, 30, 8, 30, 7, 32, 32), 30), ((2, 5, 1, 8, 30, 7, 32, 32), 0)],
                         ids=["every-key1-negative", "u1"])
def test_quad_chain_kernel_main_key_cases_on_card(cuda_device, shape, negative_keys):
    """Every main edge excluded (exact zeros, as the plain version gives),
    and one main edge a cell, against the plain version."""
    inputs = _torch(_quad_inputs(11, *shape, zero_rows=True, negative_keys=negative_keys), cuda_device)
    s = shape[5]
    got = gemnet_quad_chain(**inputs, num_spherical=s)
    torch.cuda.synchronize()
    want = gemnet_quad_chain_reference(**inputs, num_spherical=s)
    if negative_keys == shape[2]:
        assert not got.any() and not want.any()
    else:
        assert want.abs().max().item() > 0
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item() + 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 80, 30, 8, 30, 7, 32, 32), QUAD_UNALIGNED, QUAD_S9_E40_F48],
                         ids=["relax-width", "unaligned-sqf", "s9-e40-f48"])
@pytest.mark.parametrize("warps,parts,qp_buffers", [(8, 1, 1), (8, 2, 1), (4, 2, 1), (16, 1, 1), (8, 1, 0),
                                                    (1, 1, 0), (3, 3, 1)])
def test_quad_chain_kernel_forced_plans_match_plain_version_on_card(cuda_device, shape, warps, parts, qp_buffers):
    """Every buffering (one qp buffer a warp, none: qp read from device
    memory), warps a block and blocks a cell the plan can choose gives the
    plain version's output; each call is one launch."""
    b, n, u, q, k2, s, e, f = shape
    inputs = _torch(_quad_inputs(12, *shape, zero_rows=True), cuda_device)
    plan = _forced_quad_plan(shape, kernels._sm_count(cuda_device), warps, parts, qp_buffers)
    before = kernels.launches["gemnet_quad_chain"]
    got = kernels._quad_chain_launch(inputs, s, plan)
    torch.cuda.synchronize()
    assert kernels.launches["gemnet_quad_chain"] == before + 1
    want = gemnet_quad_chain_reference(**inputs, num_spherical=s)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item() + 1e-5, err


@pytest.mark.cuda
def test_quad_chain_kernel_refuses_a_plan_that_disagrees_with_its_layout(cuda_device):
    inputs = _torch(_quad_inputs(13, *QUAD_RAGGED), cuda_device)
    b, n, u, q, k2, s, e, f = QUAD_RAGGED
    plan = kernels.quad_chain_plan(b * n, u, q, k2, s, e, f, kernels._sm_count(cuda_device))
    before = kernels.launches["gemnet_quad_chain"]
    with pytest.raises(RuntimeError, match="gemnet_quad_chain launch failed"):
        kernels._quad_chain_launch(inputs, s, plan._replace(smem_bytes=plan.smem_bytes + 4))
    assert kernels.launches["gemnet_quad_chain"] == before


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


def _forced_quad_plan(shape, sms, warps, parts, qp_buffers):
    """The plan for ``shape`` with its warps a block, blocks a cell and qp
    buffers replaced, and what follows from them."""
    b, n, u, q, k2, s, e, f = shape
    plan = kernels.quad_chain_plan(b * n, u, q, k2, s, e, f, sms)
    return plan._replace(warps=warps, parts=parts, blocks=b * n * parts, threads=32 * warps, qp_buffers=qp_buffers,
                         copy_bytes=(16 if f % 4 == 0 else 4) if qp_buffers else 0,
                         smem_bytes=kernels.quad_chain_smem(warps, qp_buffers, u, q, k2, s, e, f))


def _quad_chain_work(plan, cells, u):
    """The kernel's work as ``(block, warp, cell, main edges)``: block ``x``
    takes cell ``x // parts``; its warp ``w`` is the cell's warp ``g = (x %
    parts) * warps + w`` and takes ``u = g, g + parts * warps, ...``."""
    for x in range(cells * plan.parts):
        for w in range(plan.warps):
            g = (x % plan.parts) * plan.warps + w
            yield x, w, x // plan.parts, list(range(g, u, plan.parts * plan.warps))


def _old_quad_chain_smem(u, q, k2, s, e, f):
    """Shared bytes a block of the kernel this one replaced took: xm, n2h,
    n1h, the [Q*K2][S] basis, d2 [Q][S][E], qp[u] and both key tables."""
    qk = q * k2
    return 4 * (qk * e + qk * 3 + u * q * 3 + qk * s + q * s * e + s * q * f + qk + u)


QUAD_PLAN_SHAPES = [QUAD, QUAD_RAGGED, (2, 80, 30, 8, 30, 7, 32, 32), (1, 2, 5, 1, 3, 3, 5, 7), (2, 7, 12, 4, 13, 4, 8, 8),
                    QUAD_RELAX, QUAD_E40_F48, QUAD_S9, QUAD_S9_E40_F48, QUAD_UNALIGNED, QUAD_U_SPLIT,
                    (2, 5, 1, 8, 30, 7, 32, 32), (1, 1, 3, 0, 4, 7, 8, 8), (1, 2, 4, 2, 0, 7, 8, 8), (1, 2, 4, 2, 3, 0, 8, 8),
                    (3, 1, 200, 2, 70, 17, 65, 33), (1, 1, 30, 8, 180, 7, 32, 32)]


@pytest.mark.parametrize("shape", QUAD_PLAN_SHAPES)
def test_quad_chain_plan_covers_every_main_edge_once(shape):
    """Every (cell, u) is one warp's, once, in the cell's own block; a block
    fits in 227 KB and takes what the kernel's layout says; passes of 8
    levels and 32 columns e and f."""
    b, n, u, q, k2, s, e, f = shape
    cells = b * n
    for sms in (132, 1):
        plan = kernels.quad_chain_plan(cells, u, q, k2, s, e, f, sms=sms)
        assert plan.smem_bytes == kernels.quad_chain_smem(plan.warps, plan.qp_buffers, u, q, k2, s, e, f)
        assert plan.smem_bytes <= 232448 and plan.threads == 32 * plan.warps <= 512
        assert plan.blocks == cells * plan.parts and plan.waves == plan.blocks / (sms * plan.blocks_per_sm)
        assert (plan.level_passes, plan.e_passes, plan.f_passes) == (max(1, -(-s // 8)), -(-e // 32), -(-f // 32))
        seen = np.zeros((cells, u), np.int64)
        slots = set()
        for blk, w, cell, us in _quad_chain_work(plan, cells, u):
            assert blk // plan.parts == cell and (blk, w) not in slots
            slots.add((blk, w))
            seen[cell, us] += 1
        assert (seen == 1).all() and len(slots) == plan.blocks * plan.warps


def test_quad_chain_plan_takes_sixteen_warps_an_sm_at_the_relaxation_shape():
    """The relaxation shape: 8 warps a block of one qp buffer each, 16-byte
    copies, each cell's 30 main edges over two blocks (two rounds of u a
    warp), two blocks an SM: 1280 blocks in 4.85 waves.  A grid under one
    wave splits the cell's main edges over more blocks; a shape whose qp[u]
    leaves no room for one warp's buffer reads qp from device memory."""
    b, n, u, q, k2, s, e, f = QUAD_RELAX
    plan = kernels.quad_chain_plan(b * n, u, q, k2, s, e, f, sms=132)
    assert (plan.warps, plan.parts, plan.qp_buffers, plan.copy_bytes, plan.blocks) == (8, 2, 1, 16, 1280)
    assert plan.blocks_per_sm == 2 and plan.waves == pytest.approx(1280 / 264)
    assert kernels.quad_chain_plan(6, *QUAD_RAGGED[2:], sms=132).qp_buffers == 1
    b, n, u, q, k2, s, e, f = QUAD_U_SPLIT
    assert kernels.quad_chain_plan(b * n, u, q, k2, s, e, f, sms=132).parts == 2
    assert kernels.quad_chain_plan(1, 1, q, k2, s, e, f, sms=132)[:2] == (1, 1)  # U = 1: one warp
    wide = kernels.quad_chain_plan(640, 1, 1, 1, 1, 1, 58000, sms=132)
    assert (wide.warps, wide.parts, wide.qp_buffers, wide.copy_bytes, wide.blocks) == (1, 1, 0, 0, 640)
    assert kernels.quad_chain_smem(1, 1, 1, 1, 1, 1, 1, 58000) > 232448 >= _old_quad_chain_smem(1, 1, 1, 1, 1, 58000)


@pytest.mark.parametrize("f", [1, 7, 8, 9, 32, 48])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
def test_quad_chain_plan_copies_16_bytes_only_where_the_rows_allow(f, aligned):
    """16-byte qp copies need F % 4 == 0 (so S * Q * F % 4 == 0) and an
    aligned qp; else 4-byte copies into rows padded to a multiple of 4."""
    for s, q in ((7, 8), (3, 1), (9, 5)):
        plan = kernels.quad_chain_plan(4, 6, q, 5, s, 16, f, sms=132, qp_aligned=aligned)
        assert plan.qp_buffers == 1
        assert plan.copy_bytes == (16 if f % 4 == 0 and aligned else 4)
        if plan.copy_bytes == 16:
            assert s * q * f % 4 == 0
    unstaged = kernels.quad_chain_plan(4, 1, 1, 1, 1, 1, 58000 + f, sms=132, qp_aligned=aligned)
    assert (unstaged.qp_buffers, unstaged.copy_bytes) == (0, 0)  # no buffer fits: no copies


def test_quad_chain_plan_refuses_nothing_the_old_kernel_accepted():
    """Over 20,000 shapes drawn log-uniformly (U to 600, Q to 400, K2 to
    2000, S to 40, E to 3000, F to 60,000): every shape whose old layout fit
    227 KB has a plan; a refusal comes only where the old layout did not
    fit either.  The shapes the tests and chip_smoke.py launch have plans."""
    rng = np.random.default_rng(0)
    dims = np.exp(rng.uniform(0, np.log([600, 400, 2000, 40, 3000, 60000]), size=(20000, 6))).astype(int)
    accepted = 0
    for u, q, k2, s, e, f in dims.tolist():
        u, e, f = max(u, 1), max(e, 1), max(f, 1)
        try:
            plan = kernels.quad_chain_plan(640, u, q, k2, s, e, f, sms=132)
        except ValueError as err:
            assert "shared memory" in str(err)
            assert _old_quad_chain_smem(u, q, k2, s, e, f) > 232448, (u, q, k2, s, e, f)
        else:
            assert plan.smem_bytes <= 232448
            accepted += 1
    assert accepted > 5000
    for b, n, u, q, k2, s, e, f in QUAD_PLAN_SHAPES + [(1, 3, 9, 5, 11, 9, 40, 48)]:
        kernels.quad_chain_plan(b * n, u, q, k2, s, e, f, sms=132)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.quad_chain_plan(1, 30, 8, 300, 7, 32, 32, sms=132)


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
@pytest.mark.parametrize("lead", [(37,), (1200,), (3, 40, 20)], ids=["ragged", "e1200", "sampling-lead"])
def test_attn_conv1_wide_route_matches_plain_version_on_card(cuda_device, lead):
    """Trunk and embedding widths of 256 at the published conv widths: the
    wrapper takes the 16-edge kernel, counts it as eqv2_attn_conv1, and
    |kernel - plain| <= 1e-4 * max|plain| + 1e-5 per output."""
    edges, rad, conv, kw = _conv1_inputs(35, 4, 2, lead, 128, 64, 576, 600, 256, 12.0)
    assert kernels.attn_conv1_route(256, 256, 128, 64, 576, kernels.conv1_blocks(4, 2)) == "wide"
    args = [torch.from_numpy(edges[k]).to(cuda_device) for k in edges]
    args += [_torch_tree(rad, cuda_device), _torch_tree(conv, cuda_device)]
    before = dict(kernels.launches)
    got = eqv2_attn_conv1(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["eqv2_attn_conv1"] == before.get("eqv2_attn_conv1", 0) + 1
    assert kernels.launches["eqv2_attn_conv1_wide"] == before.get("eqv2_attn_conv1_wide", 0)
    for g, w in zip(got, eqv2_attn_conv1_reference(*args, **kw)):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-5


# The launch plans of the two EquiformerV2 forward kernels (plain Python, no card)
CONV1_PUBLISHED = dict(num_gauss=600, e_dim=128, hidden=128, c=128, c_out=64, extra=576, n_blocks=(5, 4, 3))


def _conv1_plan_kw(case):
    lmax, mmax, _, c, c_out, extra, r, width, _ = case
    return dict(num_gauss=r, e_dim=width, hidden=width, c=c, c_out=c_out, extra=extra,
                n_blocks=kernels.conv1_blocks(lmax, mmax))


@pytest.mark.parametrize("kw", [CONV1_PUBLISHED, _conv1_plan_kw(CONV1_TINY), _conv1_plan_kw(CONV1_L4),
                                _conv1_plan_kw((3, 1, (19,), 5, 3, 7, 9, 6, 4.0))],
                         ids=["published", "tiny", "l4m2", "odd-widths"])
def test_attn_conv1_plan_fits_one_block_per_sm(kw):
    """The plan fits in 227 KB, takes one block per SM (one per tile for
    fewer tiles) and adds FLOP within 10% of the bound's per-edge count at the
    sampling and training edge counts."""
    nb, c, h, ed = kw["n_blocks"], kw["c"], kw["hidden"], kw["e_dim"]
    ng = 2 * sum(nb) * c
    conv = 4 * nb[0] * c * (kw["extra"] + nb[0] * kw["c_out"]) + sum(16 * n * c * n * kw["c_out"] for n in nb[1:])
    per_edge = 2 * h * (2 * ed + h + ng) + 20 * h + ng + conv
    for e, blocks in ((25_600, 132), (19_200, 132), (64 * 132 + 1, 132), (65, 2), (1, 1)):
        plan = kernels.attn_conv1_plan(e, **kw, sms=132)
        assert plan.smem_bytes <= kernels.SMEM_PER_BLOCK and plan.smem_bytes > 48 * 1024
        assert (plan.tile, plan.cluster, plan.threads, plan.blocks) == (64, 1, 256, blocks)
        if e >= 19_200:
            assert plan.extra_flops_per_edge <= 0.1 * per_edge


def test_attn_conv1_plan_counts_the_m0_gate_recompute_and_refuses_wide_trunks():
    exact = kernels.attn_conv1_plan(64 * 132 * 3, **CONV1_PUBLISHED, sms=132)  # no tile left over
    assert exact.extra_flops_per_edge == 2 * 2 * 128 * 5 * 128  # the m0 output's second 448-column pass
    assert exact.smem_bytes == 216_960
    # 4 tiles left over at 25,600 edges: their units make the trunk 3 more times each
    plan = kernels.attn_conv1_plan(25_600, **CONV1_PUBLISHED, sms=132)
    trunk = 2 * 128 * (600 + 2 * 128 + 128)
    assert plan.extra_flops_per_edge == exact.extra_flops_per_edge + -(-(256 * 3 * trunk) // 25_600)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.attn_conv1_plan(100, **dict(CONV1_PUBLISHED, e_dim=256, hidden=256), sms=132)


@pytest.mark.parametrize("kw,route", [
    (CONV1_PUBLISHED, "tiled64"), (_conv1_plan_kw(CONV1_TINY), "tiled64"), (_conv1_plan_kw(CONV1_L4), "tiled64"),
    (dict(CONV1_PUBLISHED, e_dim=144, hidden=144), "tiled64"), (dict(CONV1_PUBLISHED, e_dim=152, hidden=152), "wide"),
    (dict(CONV1_PUBLISHED, e_dim=256, hidden=256), "wide"), (dict(CONV1_PUBLISHED, e_dim=128, hidden=512), "wide"),
], ids=["published", "tiny", "l4m2", "w144", "w152", "w256", "trunk512"])
def test_attn_conv1_route_takes_the_wide_kernel_only_where_the_64_edge_plan_does_not_fit(kw, route):
    """The route is decided from the widths alone: the 64-edge kernel wherever
    its plan fits, the 16-edge kernel (whose shared memory fits) elsewhere."""
    widths = {k: kw[k] for k in ("e_dim", "hidden", "c", "c_out", "extra", "n_blocks")}
    assert kernels.attn_conv1_route(**widths) == route
    if route == "tiled64":
        assert kernels.attn_conv1_plan(25_600, kw["num_gauss"], **widths, sms=132).smem_bytes <= kernels.SMEM_PER_BLOCK
    else:
        with pytest.raises(ValueError, match="shared memory"):
            kernels.attn_conv1_plan(25_600, kw["num_gauss"], **widths, sms=132)
        assert kernels.attn_conv1_wide_smem(kw["e_dim"], kw["hidden"], kw["c"], kw["n_blocks"]) <= \
            kernels.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="16-edge tiles"):
        kernels.attn_conv1_route(**dict(widths, hidden=2048))


@pytest.mark.parametrize("e", [1, 63, 64, 65, 193, 64 * 132 - 1, 64 * 132 + 1, 65 * 132, 19_200, 25_600])
def test_attn_conv1_tiles_cover_every_edge_once(e):
    """Every (edge, column pass) is computed by exactly one work item; every
    block takes the same whole tiles and at most one unit more than another."""
    kw = CONV1_PUBLISHED
    plan = kernels.attn_conv1_plan(e, **kw, sms=132)
    n_parts = sum(p for _, _, p in kernels._conv1_parts(kw["c"], kw["c_out"], kw["extra"], kw["n_blocks"]))
    assert n_parts == 4  # m0 in two passes of 448 columns, m+-1 and m+-2 in one each
    seen = np.zeros((e, n_parts), np.int64)
    whole = np.zeros(plan.blocks, np.int64)
    units = np.zeros(plan.blocks, np.int64)
    for b, e0, n, parts in kernels.attn_conv1_work(e, plan.blocks, n_parts):
        assert 1 <= n <= plan.tile and e0 % (plan.tile // 2) == 0
        for p in range(n_parts) if parts is None else parts:
            seen[e0:e0 + n, p] += 1
        if parts is None:
            whole[b] += 1
        else:
            units[b] += 1
    assert (seen == 1).all()
    assert whole.min() == whole.max() and units.max() - units.min() <= 1
    assert all(n <= plan.tile // 2 for b, e0, n, parts in kernels.attn_conv1_work(e, plan.blocks, n_parts) if parts)


@pytest.mark.parametrize("m,nc,c", [(25_600, 19, 64), (37, 5, 16), (3, 9, 7), (1, 19, 1)])
def test_s2_grid_silu_plan_covers_every_column(m, nc, c):
    plan = kernels.s2_grid_silu_plan(m, nc, c, 324)
    assert plan.blocks * plan.tile >= m * c > (plan.blocks - 1) * plan.tile
    assert plan.smem_bytes == 2 * 324 * ((nc + 3) // 4 * 4) * 4 <= kernels.SMEM_PER_BLOCK


@pytest.mark.parametrize("m,nc,c", [(19_200, 19, 64), (25_600, 19, 64), (37, 5, 16), (3, 9, 7), (1, 19, 1),
                                    (5, 32, 3)])
def test_s2_grid_silu_bwd_plan_covers_every_column(m, nc, c):
    """Every (edge, channel) column once: groups of 128 threads x 2 columns,
    block b taking groups b, b + blocks, ...; at most one block an SM slot
    and none without a group (the kernel refuses such a plan)."""
    plan = kernels.s2_grid_silu_bwd_plan(m, nc, c, 324, 132)
    assert (plan.threads, plan.tile, plan.cluster) == (128, 256, 1)
    groups = -(-m * c // plan.tile)
    assert groups * plan.tile >= m * c > (groups - 1) * plan.tile
    assert 1 <= plan.blocks <= min(groups, (3 if nc <= 19 else 2) * 132)
    taken = np.concatenate([np.arange(b, groups, plan.blocks) for b in range(plan.blocks)])
    np.testing.assert_array_equal(np.sort(taken), np.arange(groups))
    assert plan.smem_bytes == 2 * 324 * ((nc + 3) // 4 * 4) * 4 <= kernels.SMEM_PER_BLOCK


def test_s2_grid_silu_bwd_plan_takes_three_blocks_an_sm_at_the_training_shape():
    """h [12, 80, 20, 19, 64]: 4800 groups over 396 blocks (12 warps an SM,
    as the launch bound asks at NC <= 19), 12 or 13 groups each; three
    blocks' tables fit an SM's shared memory.  NC = 32 takes two an SM."""
    plan = kernels.s2_grid_silu_bwd_plan(19_200, 19, 64, 324, 132)
    assert plan.blocks == 3 * 132
    assert 3 * (plan.smem_bytes + 1024) <= kernels.SMEM_PER_SM
    assert {len(range(b, 4800, plan.blocks)) for b in range(plan.blocks)} == {12, 13}
    assert kernels.s2_grid_silu_bwd_plan(19_200, 32, 64, 324, 132).blocks == 2 * 132


def test_s2_grid_silu_bwd_plan_refuses_only_tables_that_do_not_fit():
    """Every NC the wrapper takes (1-32) fits at the 324-point grid; tables
    past one block's shared memory raise by name; a grid whose tables leave
    room for one block an SM gets one."""
    for nc in range(1, 33):
        assert kernels.s2_grid_silu_bwd_plan(19_200, nc, 64, 324, 132).smem_bytes <= kernels.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="s2_grid_silu_bwd: the tables need 522240 bytes"):
        kernels.s2_grid_silu_bwd_plan(100, 32, 64, 2040, 132)
    assert kernels.s2_grid_silu_bwd_plan(19_200, 32, 64, 900, 132).blocks == 132


# Kernel vs plain at the redesigned kernels' boundaries, at TINY and CONV1_L4
# widths (every plan takes more than 48 KB of shared memory; no clusters).
@pytest.mark.cuda
@pytest.mark.parametrize("base", [CONV1_TINY, CONV1_L4], ids=["tiny", "l4m2"])
@pytest.mark.parametrize("edges,fill", [(63, None), (-1, None), (-65, None), (129, "masked"), (129, "far")],
                         ids=["tile-1", "tiles+1", "leftover-tiles", "masked-tile", "past-cutoff-tile"])
def test_attn_conv1_kernel_at_tile_boundaries_on_card(cuda_device, base, edges, fill):
    """E one tile - 1; one 64-edge tile a block and 1 edge more (a 1-edge
    tile left over, split into units); 65 edges a block's worth (leftover
    tiles, one partial); a masked tile; a tile past the cutoff."""
    if edges < 0:  # -1: 64 edges a block + 1; -65: 65 edges a block, on every SM
        sms = kernels._sm_count(cuda_device)
        edges = 64 * sms + 1 if edges == -1 else 65 * sms
    case = base[:2] + ((edges,),) + base[3:]
    e_in, rad, conv, kw = _conv1_inputs(37, *case)
    if fill is not None:  # the kernel's second tile
        plan = kernels.attn_conv1_plan(edges, **_conv1_plan_kw(base), sms=kernels._sm_count(cuda_device))
        _, e0, n, _ = list(kernels.attn_conv1_work(edges, plan.blocks, 1))[1]
        if fill == "masked":
            e_in["mask"][e0:e0 + n] = False
        else:
            e_in["dist"][e0:e0 + n] = 1.5 * kw["cutoff"] + np.arange(n, dtype=np.float32)
    args = [torch.from_numpy(e_in[k]).to(cuda_device) for k in e_in]
    args += [_torch_tree(rad, cuda_device), _torch_tree(conv, cuda_device)]
    got = eqv2_attn_conv1(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, eqv2_attn_conv1_reference(*args, **kw)):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,mmax", [(4, 0), (2, 2), (4, 2)], ids=["nc5", "nc9", "nc19"])
@pytest.mark.parametrize("lead,c", [((1,), 3), ((37,), 16), ((129,), 5)], ids=["cols3", "cols592", "cols645"])
def test_s2_grid_silu_kernel_at_ragged_columns_on_card(cuda_device, lmax, mmax, lead, c):
    """Column counts that are not a multiple of a block's 512 or a thread's 4."""
    to_m, from_m = (torch.from_numpy(t).to(cuda_device) for t in _s2_tables(lmax, mmax, 18))
    h = torch.from_numpy(np.random.default_rng(38).normal(size=lead + (to_m.shape[1], c)).astype(np.float32))
    h = h.to(cuda_device)
    got = s2_grid_silu(h, to_m, from_m)
    torch.cuda.synchronize()
    want = s2_grid_silu_reference(h, to_m, from_m)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5


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
    with pytest.raises(ValueError, match="shape"):
        s2_grid_silu_bwd(torch.zeros((4, 7, 3), device=cuda_device), torch.zeros((4, 7, 2), device=cuda_device),
                         to_m, from_m)
    angles = torch.zeros((2, 3, 4), device=cuda_device)
    with pytest.raises(ValueError, match="lmax"):
        eqv2_edge_rotate(torch.zeros((2, 3, 4, 64, 5), device=cuda_device), angles, angles, 7, 1, direction="to")
    with pytest.raises(TypeError, match="src must be torch.int32"):
        eqv2_gather_rotate_to(torch.zeros((2, 3, 9, 5), device=cuda_device),
                              torch.zeros((2, 3, 4), dtype=torch.int64, device=cuda_device), angles, angles, 2, 1)
    with pytest.raises(ValueError, match="shape"):
        eqv2_edge_rotate(torch.zeros((2, 2, 4, 9, 5), device=cuda_device), angles, angles, 2, 1, direction="to")


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


# --------------------------------------------------------------------------
# EquiformerV2 training: the S^2 backward, the conv1 VJP, the edge rotation
# --------------------------------------------------------------------------
def test_s2_grid_silu_bwd_reference_matches_jax_grad():
    """dh of sum(s2_grid_silu(h) * w) against jax.grad through the Pallas
    kernel's custom VJP in interpret mode (tests/test_pallas_kernels.py:229-260)."""
    import jax
    import jax.numpy as jnp

    from adsorbdiff_tpu.ops.pallas_kernels import s2_grid_silu as jax_s2_grid_silu

    to_m, from_m = _s2_tables()
    rng = np.random.default_rng(40)
    h = rng.normal(size=(3, 5, to_m.shape[1], 16)).astype(np.float32)
    w = rng.normal(size=h.shape).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(jax_s2_grid_silu(x, jnp.asarray(to_m), jnp.asarray(from_m), tile_m=128,
                                                       interpret=True) * w))(jnp.asarray(h))
    got = s2_grid_silu_bwd_reference(*(torch.from_numpy(t) for t in (h, w, to_m, from_m)))
    assert got.shape == h.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_s2_grid_silu_autograd_on_cpu_runs_the_plain_backward():
    """The Function's backward on CPU tensors is the plain VJP, equal to
    autograd through the plain forward; the tables get no gradient and no
    launch is counted."""
    to_m, from_m = (torch.from_numpy(t) for t in _s2_tables(2, 1, 8))
    gen = torch.Generator().manual_seed(41)
    h = torch.randn((2, 3, 4, to_m.shape[1], 5), generator=gen, requires_grad=True)
    w = torch.randn(h.shape, generator=gen)
    before = dict(kernels.launches)
    (got,) = torch.autograd.grad((s2_grid_silu(h, to_m, from_m) * w).sum(), h)
    (want,) = torch.autograd.grad((s2_grid_silu_reference(h, to_m, from_m) * w).sum(), h)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, s2_grid_silu_bwd(h.detach(), w, to_m, from_m), rtol=0, atol=0)
    tables = [t.clone().requires_grad_(True) for t in (to_m, from_m)]
    out = kernels.S2GridSilu.apply(h, *tables)
    assert torch.autograd.grad(out.sum(), tables, allow_unused=True) == (None, None)
    assert dict(kernels.launches) == before


def _jax_tree(tree):
    import jax.numpy as jnp

    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("case", [CONV1_TINY, CONV1_L4], ids=["tiny-l2m1", "l4m2"])
def test_attn_conv1_vjp_matches_jax_grad(case):
    """Gradients of sum(h * wh) + sum(extra * wx) with respect to the
    embeddings, both message halves and every weight, through the Function's
    backward (the plain recompute) on the CPU, against jax.grad through the
    JAX eqv2_attn_conv1 (Pallas forward in interpret mode, its XLA-recompute
    VJP); dist gets a zero gradient."""
    import jax
    import jax.numpy as jnp

    from adsorbdiff_tpu.ops.pallas_kernels import eqv2_attn_conv1 as jax_eqv2_attn_conv1

    edges, rad, conv, kw = _conv1_inputs(42, *case)
    rng = np.random.default_rng(43)
    n_act = edges["msg_s"].shape[-2]
    wh = rng.normal(size=edges["dist"].shape + (n_act, kw["c_out"])).astype(np.float32)
    wx = rng.normal(size=edges["dist"].shape + (kw["extra"],)).astype(np.float32)
    names = ("emb_s", "emb_t", "msg_s", "msg_t")

    def jax_loss(diff):
        h, x = jax_eqv2_attn_conv1(jnp.asarray(edges["dist"]), jnp.asarray(edges["mask"]), *(diff[k] for k in names),
                                   diff["rad"], diff["conv"], **kw, interpret=True)
        return jnp.sum(h * wh) + jnp.sum(x * wx)

    want = jax.grad(jax_loss)({**{k: jnp.asarray(edges[k]) for k in names}, "rad": _jax_tree(rad),
                              "conv": _jax_tree(conv)})

    t = {k: torch.from_numpy(v).requires_grad_(k != "mask") for k, v in edges.items()}
    rad_t, conv_t = _torch_tree(rad), _torch_tree(conv)
    leaves = [v for tree in (rad_t, conv_t) for mod in tree.values() for v in mod.values()]
    for v in leaves:
        v.requires_grad_(True)
    h, x = eqv2_attn_conv1(*t.values(), rad_t, conv_t, **kw)
    loss = (h * torch.from_numpy(wh)).sum() + (x * torch.from_numpy(wx)).sum()
    grads = torch.autograd.grad(loss, [t[k] for k in ("dist",) + names] + leaves)
    assert not grads[0].any()  # dist: the geometry contract
    got = dict(zip(names, grads[1:5]))
    got.update({("rad", m, l): g for (m, l), g in zip(
        [(m, l) for m in rad_t for l in rad_t[m]], grads[5:5 + sum(len(v) for v in rad_t.values())])})
    got.update({("conv", m, l): g for (m, l), g in zip(
        [(m, l) for m in conv_t for l in conv_t[m]], grads[5 + sum(len(v) for v in rad_t.values()):])})
    pairs = [(got[k], want[k]) for k in names]
    pairs += [(got[("rad", m, l)], want["rad"][m][l]) for m in rad for l in rad[m]]
    pairs += [(got[("conv", m, l)], want["conv"][m][l]) for m in conv for l in conv[m]]
    for g, w in pairs:
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 + 1e-5 * np.abs(w).max(), rtol=0)


# (lmax, mmax): the production layout and the TINY test model's
ROTATE_LAYOUTS = [(4, 2), (2, 1)]
# (name, direction, input rows: "dim" or "n_act" or an int, node-level input)
ROTATE_CASES = [("to", "to", "dim", False), ("to-node", "to", "dim", True), ("from", "from", "n_act", False),
                ("from-n0", "from", "n0", False)]


def _rotate_inputs(seed, lmax, mmax, rows, node, b=2, n=5, k=4, c=16):
    """(x, gamma, beta, n_sel) as numpy: angles over their whole range."""
    from adsorbdiff_tpu_torch.models import so3

    rng = np.random.default_rng(seed)
    dim, n_act = (lmax + 1) ** 2, so3.n_act_rows(lmax, mmax)
    n_rows = {"dim": dim, "n_act": n_act, "n0": lmax + 1}[rows]
    x = rng.normal(size=(b, n, 1 if node else k, n_rows, c)).astype(np.float32)
    gamma = rng.uniform(-np.pi, np.pi, (b, n, k)).astype(np.float32)
    beta = rng.uniform(0, np.pi, (b, n, k)).astype(np.float32)
    return x, gamma, beta, (n_act if rows == "dim" else n_rows)


@pytest.mark.parametrize("lmax,mmax", ROTATE_LAYOUTS, ids=["l4m2", "l2m1"])
@pytest.mark.parametrize("name,direction,rows,node", ROTATE_CASES, ids=[c[0] for c in ROTATE_CASES])
def test_edge_rotate_reference_and_vjp_match_jax_kernel(lmax, mmax, name, direction, rows, node):
    """The plain version against the JAX eqv2_edge_rotate's Pallas kernel in
    interpret mode, and the Function's VJP (the dual direction, plain on the
    CPU) against jax.grad through the kernel's custom VJP
    (tests/test_pallas_kernels.py:263-320), atol 2e-6."""
    import jax
    import jax.numpy as jnp

    from adsorbdiff_tpu.ops.pallas_kernels import eqv2_edge_rotate as jax_rotate

    x, gamma, beta, n_sel = _rotate_inputs(44, lmax, mmax, rows, node)
    kw = dict(direction=direction, n_sel=n_sel)
    want = jax_rotate(jnp.asarray(x), gamma, beta, lmax, mmax, **kw, interpret=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    got = eqv2_edge_rotate(xt, tg, tb, lmax, mmax, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  eqv2_edge_rotate_reference(xt.detach(), tg, tb, lmax, mmax, **kw).numpy())

    w = np.random.default_rng(45).normal(size=want.shape).astype(np.float32)
    want_dx = jax.grad(lambda a: jnp.sum(jax_rotate(a, gamma, beta, lmax, mmax, **kw, interpret=True) * w))(
        jnp.asarray(x))
    (dx,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), xt)
    assert dx.shape == x.shape
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=2e-6)


@pytest.mark.parametrize("lmax,mmax", ROTATE_LAYOUTS, ids=["l4m2", "l2m1"])
@pytest.mark.parametrize("n_sel", ["n_act", 5], ids=["n_act", "n_sel5"])
def test_gather_rotate_to_reference_and_vjp_match_jax_kernel(lmax, mmax, n_sel):
    """The gather variant: plain version and VJP (the dual rotation, then
    index_add_ over src) against the JAX eqv2_gather_rotate_to in interpret
    mode, atol 2e-6."""
    import jax
    import jax.numpy as jnp

    from adsorbdiff_tpu.models.so3 import n_act_rows
    from adsorbdiff_tpu.ops.pallas_kernels import eqv2_gather_rotate_to as jax_gather_rotate

    rng = np.random.default_rng(46)
    b, n, k, c, dim = 2, 6, 4, 8, (lmax + 1) ** 2
    n_sel = n_act_rows(lmax, mmax) if n_sel == "n_act" else n_sel
    x = rng.normal(size=(b, n, dim, c)).astype(np.float32)
    src = rng.integers(0, n, (b, n, k)).astype(np.int32)
    gamma = rng.uniform(-np.pi, np.pi, (b, n, k)).astype(np.float32)
    beta = rng.uniform(0, np.pi, (b, n, k)).astype(np.float32)
    want = jax_gather_rotate(jnp.asarray(x), jnp.asarray(src), gamma, beta, lmax, mmax, n_sel=n_sel, interpret=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    args = (torch.from_numpy(src), torch.from_numpy(gamma), torch.from_numpy(beta), lmax, mmax)
    got = eqv2_gather_rotate_to(xt, *args, n_sel=n_sel)
    assert got.shape == want.shape == (b, n, k, n_sel, c)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  eqv2_gather_rotate_to_reference(xt.detach(), *args, n_sel=n_sel).numpy())
    w = rng.normal(size=want.shape).astype(np.float32)
    want_dx = jax.grad(lambda a: jnp.sum(jax_gather_rotate(a, jnp.asarray(src), gamma, beta, lmax, mmax,
                                                           n_sel=n_sel, interpret=True) * w))(jnp.asarray(x))
    (dx,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=2e-6)


def test_edge_rotate_wrappers_on_cpu_count_no_launch_and_give_angles_no_gradient():
    x, gamma, beta, n_sel = _rotate_inputs(47, 2, 1, "dim", False)
    xt, tg, tb = (torch.from_numpy(t).requires_grad_(True) for t in (x, gamma, beta))
    before = dict(kernels.launches)
    out = eqv2_edge_rotate(xt, tg, tb, 2, 1, direction="to")
    out = eqv2_edge_rotate(out, tg, tb, 2, 1, direction="from")
    assert out.shape == x.shape
    grads = torch.autograd.grad(out.sum(), (xt, tg, tb), allow_unused=True)
    assert grads[0] is not None and grads[1] is None and grads[2] is None
    assert dict(kernels.launches) == before
    with pytest.raises(ValueError, match="n_sel"):
        eqv2_edge_rotate(xt.detach(), tg, tb, 2, 1, direction="from")


# (lmax, mmax, grid resolution, h's shape, max |g| wanted or None): lmax None takes random [324, NC] tables
S2_BWD_CASES = {
    "jax-test": (4, 2, 18, (3, 5, 19, 16), None),
    "tiny": (2, 1, 8, (2, 24, 12, 7, 16), None),
    "training-width": (4, 2, 18, (12, 80, 20, 19, 64), None),
    "ragged": (3, 3, 8, (37, 16, 33), None),
    "nc4-c1": (1, 1, 8, (5, 4, 1), None),
    # column counts (M x C) that are not a multiple of a thread's 2 or a block's 256
    **{f"nc{nc}-cols{lead[0] * c}": (lmax, mmax, 18, lead + (nc, c), None)
       for lmax, mmax, nc in ((4, 0, 5), (2, 2, 9), (4, 2, 19)) for lead, c in (((1,), 3), ((37,), 16), ((129,), 5))},
    "nc32": (None, None, 18, (3, 37, 32, 16), None),
    # h scaled so that max |to_eff @ h| = 100: the fast sigmoid's e^-g overflows to inf where g < -88.7
    "large-g": (4, 2, 18, (2, 40, 19, 64), 100.0),
}


def _s2_bwd_case(case, device):
    """The tables, h and dy of an S2_BWD_CASES entry."""
    lmax, mmax, res, shape, g_max = case
    rng = np.random.default_rng(48)
    if lmax is None:
        nc = shape[-2]
        g = res * res
        to_m, from_m = ((rng.normal(size=s) / np.sqrt(nc)).astype(np.float32) for s in ((g, nc), (nc, g)))
    else:
        to_m, from_m = _s2_tables(lmax, mmax, res)
    assert to_m.shape[1] == shape[-2]
    h, dy = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    if g_max is not None:
        h *= np.float32(g_max / np.abs(to_m @ h).max())
    return [torch.from_numpy(t).to(device) for t in (h, dy, to_m, from_m)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(S2_BWD_CASES.values()), ids=list(S2_BWD_CASES))
def test_s2_grid_silu_bwd_kernel_matches_plain_version_on_card(cuda_device, case):
    """|kernel - plain| <= 1e-4 * max|plain| + 1e-5 (f32 sums in another
    order), finite where |g| reaches 100; the kernel's result repeats bit for
    bit."""
    h, dy, to_m, from_m = _s2_bwd_case(case, cuda_device)
    before = kernels.launches["s2_grid_silu_bwd"]
    got = s2_grid_silu_bwd(h, dy, to_m, from_m)
    torch.cuda.synchronize()
    assert kernels.launches["s2_grid_silu_bwd"] == before + 1
    want = s2_grid_silu_bwd_reference(h, dy, to_m, from_m)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5
    assert torch.equal(s2_grid_silu_bwd(h, dy, to_m, from_m), got)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 2, 7, "groups"])
def test_s2_grid_silu_bwd_kernel_forced_plans_match_plain_version_on_card(cuda_device, blocks):
    """One block taking every column group, 2 or 7 blocks taking uneven
    shares (at most one a group), and one block a group, at 645 columns (3
    groups, the last ragged) and at 333 x 16 = 5328 columns (21 groups):
    the same result bit for bit as the wrapper's plan, within the gate of
    the plain version."""
    for name in ("nc19-cols645", "nc9-cols592"):
        h, dy, to_m, from_m = _s2_bwd_case(S2_BWD_CASES[name], cuda_device)
        if name == "nc9-cols592":
            h, dy = (t.repeat(9, 1, 1) for t in (h, dy))
        nc, c = h.shape[-2:]
        plan = kernels.s2_grid_silu_bwd_plan(h.numel() // (nc * c), nc, c, to_m.shape[0],
                                             kernels._sm_count(cuda_device))
        groups = -(-h.numel() // nc // plan.tile)
        got = kernels._s2_grid_silu_bwd_launch(h, dy, to_m, from_m,
                                               plan._replace(blocks=groups if blocks == "groups" else
                                                             min(blocks, groups)))
        torch.cuda.synchronize()
        want = s2_grid_silu_bwd_reference(h, dy, to_m, from_m)
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5
        assert torch.equal(got, s2_grid_silu_bwd(h, dy, to_m, from_m))


@pytest.mark.cuda
def test_s2_grid_silu_bwd_kernel_refuses_a_plan_that_disagrees_with_its_layout(cuda_device):
    h, dy, to_m, from_m = _s2_bwd_case(S2_BWD_CASES["nc19-cols645"], cuda_device)
    nc, c = h.shape[-2:]
    plan = kernels.s2_grid_silu_bwd_plan(h.numel() // (nc * c), nc, c, to_m.shape[0], kernels._sm_count(cuda_device))
    before = kernels.launches["s2_grid_silu_bwd"]
    for bad in (plan._replace(smem_bytes=plan.smem_bytes + 16), plan._replace(blocks=0),
                plan._replace(blocks=plan.blocks + 1)):
        with pytest.raises(RuntimeError, match="s2_grid_silu_bwd launch failed at h"):
            kernels._s2_grid_silu_bwd_launch(h, dy, to_m, from_m, bad)
    assert kernels.launches["s2_grid_silu_bwd"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,mmax", ROTATE_LAYOUTS + [(3, 3), (6, 2)], ids=["l4m2", "l2m1", "l3m3", "l6m2"])
@pytest.mark.parametrize("name,direction,rows,node", ROTATE_CASES, ids=[c[0] for c in ROTATE_CASES])
def test_edge_rotate_kernel_matches_plain_version_on_card(cuda_device, lmax, mmax, name, direction, rows, node):
    """Forward and VJP, |kernel - plain| <= 1e-4 * max|plain| + 1e-5, the VJP
    against autograd of the plain chain."""
    x, gamma, beta, n_sel = _rotate_inputs(49, lmax, mmax, rows, node, b=3, n=7, k=5, c=33)
    xt, tg, tb = (torch.from_numpy(t).to(cuda_device) for t in (x, gamma, beta))
    kw = dict(direction=direction, n_sel=n_sel)
    before = kernels.launches["eqv2_edge_rotate"]
    xg = xt.clone().requires_grad_(True)
    got = eqv2_edge_rotate(xg, tg, tb, lmax, mmax, **kw)
    w = torch.randn(got.shape, generator=torch.Generator().manual_seed(50)).to(cuda_device)
    (dx,) = torch.autograd.grad((got * w).sum(), xg)
    torch.cuda.synchronize()
    assert kernels.launches["eqv2_edge_rotate"] == before + 2
    xr = xt.clone().requires_grad_(True)
    want = eqv2_edge_rotate_reference(xr, tg, tb, lmax, mmax, **kw)
    (want_dx,) = torch.autograd.grad((want * w).sum(), xr)
    for g, ref in ((got, want), (dx, want_dx)):
        assert g.shape == ref.shape
        assert (g - ref).abs().max().item() <= 1e-4 * ref.abs().max().item() + 1e-5


@pytest.mark.cuda
def test_gather_rotate_kernel_matches_plain_version_on_card(cuda_device):
    rng = np.random.default_rng(51)
    b, n, k, c, lmax, mmax = 2, 40, 20, 128, 4, 2
    x = torch.from_numpy(rng.normal(size=(b, n, 25, c)).astype(np.float32)).to(cuda_device)
    src = torch.from_numpy(rng.integers(0, n, (b, n, k)).astype(np.int32)).to(cuda_device)
    gamma = torch.from_numpy(rng.uniform(-np.pi, np.pi, (b, n, k)).astype(np.float32)).to(cuda_device)
    beta = torch.from_numpy(rng.uniform(0, np.pi, (b, n, k)).astype(np.float32)).to(cuda_device)
    xg = x.clone().requires_grad_(True)
    got = eqv2_gather_rotate_to(xg, src, gamma, beta, lmax, mmax)
    w = torch.randn(got.shape, generator=torch.Generator().manual_seed(52)).to(cuda_device)
    (dx,) = torch.autograd.grad((got * w).sum(), xg)
    xr = x.clone().requires_grad_(True)
    want = eqv2_gather_rotate_to_reference(xr, src, gamma, beta, lmax, mmax)
    (want_dx,) = torch.autograd.grad((want * w).sum(), xr)
    for g, ref in ((got, want), (dx, want_dx)):
        assert (g - ref).abs().max().item() <= 1e-4 * ref.abs().max().item() + 1e-5


@pytest.mark.cuda
def test_eqv2_autograd_on_card_launches_the_backward_kernels(cuda_device):
    """s2_grid_silu with a gradient: one forward and one backward launch;
    eqv2_attn_conv1: one forward launch, its VJP a plain recompute (no
    launch), gradients equal to autograd of the plain version."""
    to_m, from_m = (torch.from_numpy(t).to(cuda_device) for t in _s2_tables())
    h = torch.randn((40, 20, to_m.shape[1], 16), generator=torch.Generator().manual_seed(53)).to(cuda_device)
    h.requires_grad_(True)
    before = dict(kernels.launches)
    (dh,) = torch.autograd.grad(s2_grid_silu(h, to_m, from_m).square().sum(), h)
    torch.cuda.synchronize()
    assert kernels.launches["s2_grid_silu"] == before.get("s2_grid_silu", 0) + 1
    assert kernels.launches["s2_grid_silu_bwd"] == before.get("s2_grid_silu_bwd", 0) + 1
    (want,) = torch.autograd.grad(s2_grid_silu_reference(h, to_m, from_m).square().sum(), h)
    assert (dh - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5

    edges, rad, conv, kw = _conv1_inputs(54, *CONV1_L4)
    t = {k: torch.from_numpy(v).to(cuda_device).requires_grad_(k not in ("mask", "dist")) for k, v in edges.items()}
    trees = [_torch_tree(rad, cuda_device), _torch_tree(conv, cuda_device)]
    leaves = [v.requires_grad_(True) for tree in trees for mod in tree.values() for v in mod.values()]
    inputs = [t[k] for k in ("emb_s", "emb_t", "msg_s", "msg_t")] + leaves
    before = kernels.launches["eqv2_attn_conv1"]
    got = torch.autograd.grad(sum(o.square().sum() for o in eqv2_attn_conv1(*t.values(), *trees, **kw)), inputs)
    torch.cuda.synchronize()
    assert kernels.launches["eqv2_attn_conv1"] == before + 1
    want = torch.autograd.grad(sum(o.square().sum() for o in eqv2_attn_conv1_reference(*t.values(), *trees, **kw)),
                               inputs)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-3 * w.abs().max().item() + 1e-5


# --------------------------------------------------------------------------
# GemNet-OC: masked_legendre_cos (gemnet_cbf_basis, gemnet_quad_basis)
# --------------------------------------------------------------------------
QUAD_BASIS = (2, 4, 6, 3, 6, 7)  # b, n, k1, kq, k2, s of tests/test_pallas_kernels.py:448
CBF = (2, 4, 7, 5, 7)  # b, n, m, k, s


def _cbf_inputs(seed, b, n, m, k, s, keep_all=None):
    """Unit rows with a few exact-zero (padded) rows; ``keep_all`` forces the
    mask (False: all-false, as a row with no valid triplet)."""
    rng = np.random.default_rng(seed)

    def unit(*shape):
        x = rng.normal(size=shape + (3,))
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    u, v = unit(b, n, m), unit(b, n, k)
    u[0, 0, 0] = 0.0
    v[-1, -1, -2:] = 0.0
    keep = rng.random((b, n, m, k)) > 0.3 if keep_all is None else np.full((b, n, m, k), keep_all)
    return u, v, keep


def _quad_basis_inputs(seed, b, n, k1, kq, k2, s, keep_all=None):
    """Cross products (not unit) with exact-zero rows, as masked edges give."""
    rng = np.random.default_rng(seed)
    n1 = rng.normal(size=(b, n, k1, kq, 3)).astype(np.float32)
    n2 = rng.normal(size=(b, n, kq, k2, 3)).astype(np.float32)
    n1[0, 0, 0] = 0.0
    n2[-1, -1, 1, 3 % k2] = 0.0
    keep = rng.random((b, n, k1, kq, k2)) > 0.3 if keep_all is None else np.full((b, n, k1, kq, k2), keep_all)
    return n1, n2, keep


@pytest.mark.parametrize("keep_all", [None, False], ids=["random-keep", "all-false-keep"])
def test_legendre_bases_reference_match_jax_kernel(keep_all):
    """gemnet_cbf_basis_reference, gemnet_quad_basis_reference and
    masked_legendre_cos_reference against the JAX functions (Pallas in
    interpret mode), with zero rows, at atol 1e-5 / rtol 1e-5 (the JAX
    package's own test, tests/test_pallas_kernels.py:439-467)."""
    import jax.numpy as jnp

    from adsorbdiff_tpu.ops import pallas_kernels as pk

    b, n, m, k, s = CBF
    u, v, keep = _cbf_inputs(21, *CBF, keep_all=keep_all)
    got = kernels.gemnet_cbf_basis_reference(*(torch.from_numpy(x) for x in (u, v, keep)), s).numpy()
    assert got.shape == (b, n, s, m, k)
    want = np.asarray(pk.gemnet_cbf_basis(jnp.asarray(u), jnp.asarray(v), jnp.asarray(keep), s, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    a, bt, kg = u.reshape(b * n, m, 3), np.swapaxes(v.reshape(b * n, k, 3), 1, 2).copy(), keep.reshape(b * n, m, k)
    got = kernels.masked_legendre_cos_reference(*(torch.from_numpy(x) for x in (a, bt, kg)), s).numpy()
    want = np.asarray(pk.masked_legendre_cos(jnp.asarray(a), jnp.asarray(bt), jnp.asarray(kg), s, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    s = QUAD_BASIS[5]
    n1, n2, qkeep = _quad_basis_inputs(22, *QUAD_BASIS, keep_all=keep_all)
    got = kernels.gemnet_quad_basis_reference(*(torch.from_numpy(x) for x in (n1, n2, qkeep)), s).numpy()
    assert got.shape == (2, 4, s, 3, 6, 6)
    want = np.asarray(pk.gemnet_quad_basis(jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(qkeep), s, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if keep_all is False:
        assert not got.any()


def test_legendre_reference_matches_jax_legendre_y_l0():
    """The triplet basis against the JAX model's own XLA formulation
    (``legendre_y_l0`` of the clipped cosine, mask folded), moved to the
    kernel's [B, N, S, M, K] layout."""
    import jax.numpy as jnp

    from adsorbdiff_tpu.models.gemnet_oc import _cos_clamped, legendre_y_l0

    u, v, keep = _cbf_inputs(23, *CBF)
    s = CBF[4]
    cos = _cos_clamped(jnp.asarray(u)[:, :, :, None, :], jnp.asarray(v)[:, :, None, :, :])
    want = np.moveaxis(np.asarray(jnp.where(jnp.asarray(keep)[..., None], legendre_y_l0(cos, s), 0.0)), -1, 2)
    got = kernels.gemnet_cbf_basis_reference(*(torch.from_numpy(x) for x in (u, v, keep)), s).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_legendre_wrappers_on_cpu_run_the_plain_version_and_count_no_launch():
    u, v, keep = (torch.from_numpy(x) for x in _cbf_inputs(24, *CBF))
    n1, n2, qkeep = (torch.from_numpy(x) for x in _quad_basis_inputs(25, *QUAD_BASIS))
    before = kernels.launches["masked_legendre_cos"]
    torch.testing.assert_close(kernels.gemnet_cbf_basis(u, v, keep, 7),
                               kernels.gemnet_cbf_basis_reference(u, v, keep, 7), rtol=0, atol=0)
    torch.testing.assert_close(kernels.gemnet_quad_basis(n1, n2, qkeep, 7),
                               kernels.gemnet_quad_basis_reference(n1, n2, qkeep, 7), rtol=0, atol=0)
    assert kernels.launches["masked_legendre_cos"] == before


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,keep_all",
    [((8, 80, 30, 30, 7), None), ((8, 80, 30, 20, 7), None), ((3, 5, 29, 13, 7), None), ((2, 3, 33, 1, 4), False)],
    ids=["e2e-relax", "a2e-relax", "ragged", "ragged-all-false"],
)
def test_cbf_basis_kernel_matches_plain_version_on_card(cuda_device, shape, keep_all):
    """|kernel - plain| <= 1e-4 * max|plain| + 1e-5 (f32 dot and recurrence
    contracted into other FMAs); one launch per call."""
    u, v, keep = (torch.from_numpy(x).to(cuda_device) for x in _cbf_inputs(26, *shape, keep_all=keep_all))
    s = shape[4]
    before = kernels.launches["masked_legendre_cos"]
    got = kernels.gemnet_cbf_basis(u, v, keep, s)
    torch.cuda.synchronize()
    assert kernels.launches["masked_legendre_cos"] == before + 1
    want = kernels.gemnet_cbf_basis_reference(u, v, keep, s)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5
    a, bt = u.reshape(-1, shape[2], 3), v.reshape(-1, shape[3], 3).transpose(1, 2).contiguous()
    kg = keep.reshape(-1, shape[2], shape[3])
    torch.testing.assert_close(kernels.masked_legendre_cos(a, bt, kg, s), got.reshape(-1, s, shape[2], shape[3]),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 80, 30, 8, 30, 7), (2, 3, 13, 5, 29, 4), QUAD_BASIS],
                         ids=["relax", "ragged", "jax-test"])
def test_quad_basis_kernel_matches_plain_version_on_card(cuda_device, shape):
    n1, n2, keep = (torch.from_numpy(x).to(cuda_device) for x in _quad_basis_inputs(27, *shape))
    s = shape[5]
    got = kernels.gemnet_quad_basis(n1, n2, keep, s)
    torch.cuda.synchronize()
    want = kernels.gemnet_quad_basis_reference(n1, n2, keep, s)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5


@pytest.mark.cuda
def test_legendre_wrappers_raise_instead_of_falling_back(cuda_device):
    u, v, keep = (torch.from_numpy(x).to(cuda_device) for x in _cbf_inputs(28, *CBF))
    with pytest.raises(TypeError, match="keep must be torch.bool"):
        kernels.gemnet_cbf_basis(u, v, keep.float(), 7)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gemnet_cbf_basis(u, v, keep.transpose(2, 3).contiguous().transpose(2, 3), 7)
    with pytest.raises(NotImplementedError, match="backward"):
        kernels.gemnet_cbf_basis(u.clone().requires_grad_(), v, keep, 7)
    with pytest.raises(ValueError, match="levels"):
        kernels.gemnet_cbf_basis(u, v, keep, 17)
    before = kernels.launches["masked_legendre_cos"]
    empty = kernels.gemnet_cbf_basis(u[:, :, :0].contiguous(), v, keep[:, :, :0].contiguous(), 7)
    assert empty.shape == (2, 4, 7, 0, 5) and kernels.launches["masked_legendre_cos"] == before
