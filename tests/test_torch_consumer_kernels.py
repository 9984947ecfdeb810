"""PyTorch port: the PaiNN message consumers (one target per block and tiled)
and the fused radial filter, against JAX's Pallas functions.

Each plain version is held against its JAX function (Pallas in interpret
mode on the CPU, as tests/test_pallas_kernels.py:20-129 runs them); the
consumer is also held against JAX's fused-gather kernel fed the ungathered
features.  Tests marked ``cuda`` hold the Hopper kernels against the plain
versions and skip without a card; JAX is imported inside the JAX tests only,
so on the card they run with ``python -m pytest --noconftest
tests/test_torch_consumer_kernels.py -m cuda``.

Tolerances: 1e-5 abs and rel against JAX (R-term filter sums and K-term
reductions of O(1) values in another order); on the card
|kernel - plain| <= 1e-4 * max|plain| + 1e-5, the bound chip_smoke.py holds
every kernel to (f32 sums in another order over up to 128 radial terms).
"""
import numpy as np
import pytest
import torch

from adsorbdiff_tpu_torch.ops import kernels
from adsorbdiff_tpu_torch.ops.kernels import (
    fused_rbf_filter,
    fused_rbf_filter_reference,
    painn_message_consumer,
    painn_message_consumer_reference,
    painn_message_consumer_tiled,
    painn_message_fused_reference,
)
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)
CONSUMER = (13, 10, 16, 64)  # m, k, r, h of tests/test_pallas_kernels.py:92 (m not a multiple of ti)
NAMES = ("dist", "mask", "unit", "xh_gathered", "vec_gathered", "weights", "bias")


def _consumer_inputs(seed, m, k, r, h, cutoff=6.0):
    """Distances past the cutoff, 20% masked slots, and an all-false row."""
    rng = np.random.default_rng(seed)
    mask = rng.random((m, k)) > 0.2
    mask[-1] = False
    return dict(
        dist=rng.uniform(0, 1.2 * cutoff, (m, k)).astype(np.float32),
        mask=mask,
        unit=rng.normal(0, 1, (m, k, 3)).astype(np.float32),
        xh_gathered=rng.normal(0, 1, (m, k, 3 * h)).astype(np.float32),
        vec_gathered=rng.normal(0, 1, (m, k, 3 * h)).astype(np.float32),
        weights=rng.normal(0, 0.2, (r, 3 * h)).astype(np.float32),
        bias=rng.normal(0, 0.1, 3 * h).astype(np.float32),
    )


def _filter_inputs(seed, shape, r=16, f=128, cutoff=6.0):
    rng = np.random.default_rng(seed)
    return dict(
        dist=rng.uniform(0, 1.2 * cutoff, shape).astype(np.float32),
        mask=rng.random(shape) > 0.3,
        weights=rng.normal(0, 0.3, (r, f)).astype(np.float32),
        bias=rng.normal(0, 0.1, f).astype(np.float32),
    )


def _torch(arrays, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


# ----------------------------------------------------------------------------
# plain versions against JAX (Pallas in interpret mode)
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 10, 8), (127,), (2, 5, 50)], ids=["3x10x8", "127", "2x5x50"])
def test_rbf_filter_plain_matches_jax(shape):
    """Lead shapes of tests/test_pallas_kernels.py:20, past the cutoff
    included."""
    from adsorbdiff_tpu.ops.pallas_kernels import fused_rbf_filter as jax_fused_rbf_filter

    arrays = _filter_inputs(1, shape)
    want = np.asarray(jax_fused_rbf_filter(*(arrays[k] for k in ("dist", "mask", "weights", "bias")), cutoff=6.0,
                                           tile=128))
    got = fused_rbf_filter(**_torch(arrays), cutoff=6.0)
    assert got.shape == shape + (128,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_rbf_filter_beyond_cutoff_gives_the_bias_and_a_masked_edge_zero():
    """An unmasked edge past the cutoff has an all-zero basis, so its filter
    is the bias; a masked edge is 0, bias included (as JAX's kernel)."""
    from adsorbdiff_tpu.ops.pallas_kernels import fused_rbf_filter as jax_fused_rbf_filter

    cutoff = 5.0
    dist = np.asarray([[cutoff * 1.5, cutoff * 0.5, cutoff * 0.5]], np.float32)
    mask = np.asarray([[True, True, False]])
    w = np.ones((8, 128), np.float32)
    b = np.linspace(-1, 1, 128).astype(np.float32)
    want = np.asarray(jax_fused_rbf_filter(dist, mask, w, b, cutoff=cutoff, tile=128))
    got = fused_rbf_filter(*(torch.from_numpy(x) for x in (dist, mask, w, b)), cutoff=cutoff).numpy()
    np.testing.assert_array_equal(got[0, 0], b)
    assert np.abs(got[0, 1] - b).max() > 0.0
    np.testing.assert_array_equal(got[0, 2], 0.0)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("tiled", [False, True], ids=["one-target", "tiled-ti8"])
def test_consumer_plain_matches_jax(tiled):
    """M = 13 targets (not a multiple of ti = 8), K = 10, H = 64, an
    all-false row, against painn_message_consumer / _tiled in interpret
    mode."""
    from adsorbdiff_tpu.ops import pallas_kernels as pk

    arrays = _consumer_inputs(2, *CONSUMER)
    jax_fn = pk.painn_message_consumer_tiled if tiled else pk.painn_message_consumer
    want = jax_fn(*(arrays[k] for k in NAMES), cutoff=6.0, **({"ti": 8} if tiled else {}))
    port_fn = painn_message_consumer_tiled if tiled else painn_message_consumer
    got = port_fn(**_torch(arrays), cutoff=6.0)
    assert got[0].shape == (13, 64) and got[1].shape == (13, 3, 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert not got[0][-1].any() and not got[1][-1].any()  # the all-false row


def test_consumer_on_gathered_features_matches_the_fused_kernels():
    """The consumer on features gathered in torch equals JAX's fused-gather
    kernel (interpret mode) and the port's plain fused message, on a ragged
    neighbour table (tests/test_pallas_kernels.py:109)."""
    from adsorbdiff_tpu.ops.pallas_kernels import painn_message_fused as jax_painn_message_fused

    b, n, k, r, h = 2, 13, 10, 16, 64
    rng = np.random.default_rng(4)
    src = rng.integers(0, n, (b, n, k)).astype(np.int32)
    arrays = _consumer_inputs(5, b * n, k, r, h)
    xh = rng.normal(0, 1, (b, n, 3 * h)).astype(np.float32)
    vec = rng.normal(0, 1, (b, n, 3 * h)).astype(np.float32)
    geo = {name: arrays[name].reshape((b, n) + arrays[name].shape[1:]) for name in ("dist", "mask", "unit")}

    t = _torch(dict(xh=xh, vec=vec, src=src, **geo, weight=arrays["weights"], bias=arrays["bias"]))
    idx = t["src"].reshape(b, n * k, 1).long().expand(-1, -1, 3 * h)
    xh_g = torch.gather(t["xh"], 1, idx).reshape(b * n, k, 3 * h)
    vec_g = torch.gather(t["vec"], 1, idx).reshape(b * n, k, 3 * h)
    flat = {name: t[name].reshape((b * n,) + t[name].shape[2:]) for name in ("dist", "mask", "unit")}
    got = painn_message_consumer_tiled(**flat, xh_gathered=xh_g, vec_gathered=vec_g, weights=t["weight"],
                                       bias=t["bias"], cutoff=6.0, ti=8)

    want_jax = jax_painn_message_fused(xh, vec, src, geo["dist"], geo["mask"], geo["unit"], arrays["weights"],
                                       arrays["bias"], cutoff=6.0, ti=8)
    want_port = painn_message_fused_reference(**t, cutoff=6.0)
    for g, wj, wp in zip(got, want_jax, want_port):
        np.testing.assert_allclose(g.numpy(), np.asarray(wj).reshape(g.shape), **TOL)
        torch.testing.assert_close(g, wp.reshape(g.shape), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["painn_message_consumer", "painn_message_consumer_tiled", "fused_rbf_filter"])
def test_wrappers_on_cpu_run_the_plain_versions_and_count_no_launch(name):
    before = dict(kernels.launches)
    if name == "fused_rbf_filter":
        inputs = _torch(_filter_inputs(6, (2, 7, 9)))
        got = [fused_rbf_filter(**inputs, cutoff=6.0)]
        want = [fused_rbf_filter_reference(**inputs, cutoff=6.0)]
    else:
        inputs = _torch(_consumer_inputs(6, 11, 9, 16, 32))
        got = getattr(kernels, name)(**inputs, cutoff=6.0, ti=3)
        want = painn_message_consumer_reference(**inputs, cutoff=6.0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert dict(kernels.launches) == before


# ----------------------------------------------------------------------------
# the consumers' launch plan and row windows (plain Python, the kernel's mirror)
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("r", [2, 128, 600])
@pytest.mark.parametrize("h", [1, 33, 48, 100, 512, 5000])
@pytest.mark.parametrize("k,m", [(1, 1), (45, 13), (50, 1280), (120, 1283)])
def test_consumer_plan_covers_every_target_and_column_once(m, k, h, r):
    """Every (target, 64-column slice) pair is taken by exactly one owner of
    one block, and the slices cover every column once; the blocks of a chunk
    (one a slice) share its targets; owners of a block differ by at most one
    target; one wave of one block an SM where the slices are fewer than the
    SMs; W staged where it fits (R <= 215); float2 loads where H is even."""
    plan = kernels.consumer_plan(m, k, r, h, 132)
    assert plan.slices == -(-h // 64) and 1 <= plan.chunks <= m and plan.blocks == plan.chunks * plan.slices
    assert plan.blocks <= max(132, plan.slices) and plan.threads == 256
    assert plan.chunks == min(m, max(1, 132 // plan.slices))
    assert plan.stage_w == (r <= 215) and plan.vec == (h % 2 == 0)
    assert plan.smem_bytes == kernels.consumer_smem(r, plan.stage_w) <= 232448
    taken = np.zeros((m, plan.slices), np.int64)
    per_owner = {}
    for b, o, t, sl in kernels.consumer_work(plan, m):
        assert 0 <= o < 8 and sl == b % plan.slices
        taken[t, sl] += 1
        per_owner[b, o] = per_owner.get((b, o), 0) + 1
    assert (taken == 1).all()
    columns = np.concatenate([np.arange(64 * sl, min(h, 64 * sl + 64)) for sl in range(plan.slices)])
    assert np.array_equal(np.sort(columns), np.arange(h))
    for b in range(plan.blocks):
        counts = [per_owner.get((b, o), 0) for o in range(8)]
        assert max(counts) - min(counts) <= 1 and max(counts) <= plan.load
    assert plan.load == max(per_owner.values())
    if (m, k, r, h) == (1280, 50, 128, 512):  # the bench layer: 16 chunks of 80 targets x 8 slices
        assert plan.blocks == 128 and plan.chunks == 16 and plan.load == 10 and plan.smem_bytes == 165248


def test_consumer_plan_refuses_what_the_kernel_cannot_take():
    for m, k, r, h in ((0, 50, 128, 512), (13, 0, 16, 64), (13, 10, 1, 64), (13, 10, 16, 0), (2**24, 2**7, 16, 64)):
        with pytest.raises(ValueError, match=f"M, K, R, H = {m}, {k}, {r}, {h}"):
            kernels.consumer_plan(m, k, r, h, 132)


def _consumer_window_products(dist, mask, r, cutoff, h=512):
    """(products the consumer kernel runs over its groups' windows on their
    slots, the non-zero basis values of the unmasked slots) at the plan for
    ``h`` columns on 132 SMs (H = 512: 16 chunks); asserts that
    every unmasked slot is in exactly one group, that a group's slots belong
    to one owner's batch (targets of one chunk, 8 apart) and that every
    non-zero basis value of a slot lies inside its group's window."""
    m, k = dist.shape
    plan = kernels.consumer_plan(m, k, r, h, 132)
    lo, hi, slots = kernels.consumer_windows(dist, mask, r, cutoff, plan)
    flat = slots.reshape(-1)
    assert torch.equal(torch.sort(flat[flat >= 0]).values, torch.nonzero(mask.reshape(-1)).reshape(-1))
    targets = torch.where(slots >= 0, slots // k, slots[:, :1] // k)
    assert ((targets - targets[:, :1]) % 8 == 0).all() and (targets - targets[:, :1]).abs().max() < 8 * 4
    nonzero = (kernels.message_basis(dist.reshape(-1), r, cutoff, 5) != 0) & mask.reshape(-1, 1)
    rows = torch.arange(r)
    inside = (rows >= lo[:, None, None]) & (rows <= hi[:, None, None])  # [G, 1, R]
    held = nonzero[slots.clamp(min=0)] & (slots >= 0)[..., None]  # [G, 8, R]
    assert not (held & ~inside).any()
    return int((torch.clamp(hi - lo + 1, min=0) * (slots >= 0).sum(-1)).sum()), int(nonzero.sum())


def test_consumer_windows_hold_every_non_zero_basis_value_on_the_bench_graph():
    """At the bench layer (the sampling graph's [1280, 50] slots) every
    unmasked slot is in one group of 8 slots sorted by bin across a batch of
    an owner's targets (4, 4 and 2 of its 10), and every non-zero basis
    value lies in its group's rows: at most 1.2x the needed products (1.14x;
    8 consecutive slots of one target run 1.33x); with the slots of every
    target shuffled the same, as the sort undoes the order."""
    from tests.test_torch_kernels import _bench_graph

    _, dist, mask, _ = _bench_graph()
    ran, needed = _consumer_window_products(dist.reshape(1280, 50), mask.reshape(1280, 50), 128, 12.0)
    assert needed == 64000 * 28.7831875 and ran <= 1.2 * needed, ran / needed
    perm = torch.from_numpy(np.random.default_rng(5).permuted(np.tile(np.arange(50), (1280, 1)), axis=-1))
    ran_shuffled, _ = _consumer_window_products(torch.gather(dist.reshape(1280, 50), 1, perm),
                                                torch.gather(mask.reshape(1280, 50), 1, perm), 128, 12.0)
    assert ran_shuffled == ran, (ran_shuffled, ran)


@pytest.mark.parametrize("m,k,r", [(23, 37, 2), (23, 37, 16), (23, 37, 128), (23, 37, 600), (3, 700, 128), (90, 1, 16)])
def test_consumer_windows_hold_every_non_zero_basis_value_on_random_slots(m, k, r):
    """Random distances up to 1.2 x the cutoff (centres at both ends of the
    rows and past the cutoff), masked slots, runs ending in a partial group;
    K = 700 cuts each target in runs of 256 slots, K = 1 puts 4 targets in
    a batch."""
    inputs = _consumer_inputs(r + k, m, k, r, 1)
    _consumer_window_products(torch.from_numpy(inputs["dist"]), torch.from_numpy(inputs["mask"]), r, 6.0)


# ----------------------------------------------------------------------------
# fused_rbf_filter's launch plan and row windows (plain Python, the kernel's mirror)
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("r", [2, 128, 500])
@pytest.mark.parametrize("f", [1, 100, 1536, 1537])
@pytest.mark.parametrize("e", [1, 9, 64000])
def test_rbf_filter_plan_covers_every_edge_and_column_once(e, f, r):
    """Every (chunk of 384 edges, 128-column slice) pair is taken by exactly
    one block, so every (edge, column) once (a chunk's sort is a
    permutation: see the window tests); blocks a whole number a slice; W
    staged where it fits (R <= 398); float4 where F % 4 == 0; shared memory
    within 227 KB and two blocks an SM at R = 128."""
    plan = kernels.rbf_filter_plan(e, r, f, 132)
    assert plan.slices == -(-f // 128) and plan.chunks == -(-e // 384)
    assert plan.blocks % plan.slices == 0 and 1 <= plan.blocks // plan.slices <= plan.chunks
    assert plan.threads == 384 and plan.vec == (f % 4 == 0) and plan.stage_w == (r <= 398)
    assert plan.smem_bytes == kernels.rbf_filter_smem(r, plan.stage_w) <= 232448
    assert plan.blocks_per_sm == 2 and plan.blocks <= max(2 * 132, plan.slices)
    taken = np.zeros((plan.chunks, plan.slices), np.int64)
    for _, ch, sl in kernels.rbf_filter_work(plan):
        taken[ch, sl] += 1
    assert (taken == 1).all()
    if (e, r, f) == (64000, 128, 1536):  # the bench layer: 22 blocks a slice, 7.6 chunks each
        assert plan.blocks == 264 and plan.smem_bytes == 91652 and plan.spread < 1.06


def test_rbf_filter_plan_refuses_what_the_kernel_cannot_take():
    for e, r, f in ((0, 16, 8), (8, 1, 8), (8, 16, 0), (8, 30000, 8)):
        with pytest.raises(ValueError, match=f"E, R, F = {e}, {r}, {f}"):
            kernels.rbf_filter_plan(e, r, f, 132)


def _rbf_window_products(dist, mask, r, cutoff):
    """(products the kernel runs, 8 a row of each group's window; the
    non-zero basis values of the unmasked edges); asserts that every edge
    is in exactly one group and every non-zero basis value of an unmasked
    edge lies inside its group's window."""
    lo, hi, edges = kernels.rbf_filter_windows(dist, mask, r, cutoff)
    flat = edges.reshape(-1)
    assert torch.equal(torch.sort(flat[flat >= 0]).values, torch.arange(dist.numel()))
    nonzero = (kernels.message_basis(dist.reshape(-1), r, cutoff, 5) != 0) & mask.reshape(-1, 1)
    rows = torch.arange(r)
    inside = (rows >= lo[:, None, None]) & (rows <= hi[:, None, None])  # [G, 1, R]
    held = nonzero[edges.clamp(min=0)] & (edges >= 0)[..., None]  # [G, 8, R]
    assert not (held & ~inside).any()
    return int(torch.clamp(hi - lo + 1, min=0).sum()) * 8, int(nonzero.sum())


def test_rbf_filter_windows_hold_every_non_zero_basis_value_on_the_bench_graph():
    """On the bench layer's graph (PaiNN's sampling table, K = 50 slots
    sorted by distance) the sorted chunks' windows hold every non-zero
    basis value of an unmasked edge and run at most 1.35x the needed
    products (~1.09x; 8 consecutive slots would run ~1.51x); with the slots
    of every target shuffled they hold every value too and run about the
    same, as the sort undoes the order."""
    from tests.test_torch_kernels import _bench_graph

    _, dist, mask, _ = _bench_graph()
    ran, needed = _rbf_window_products(dist, mask, 128, 12.0)
    assert needed == 64000 * 28.7831875 and ran <= 1.35 * needed, ran / needed
    perm = torch.from_numpy(np.random.default_rng(5).permuted(np.tile(np.arange(50), (16, 80, 1)), axis=-1))
    ran_shuffled, needed_shuffled = _rbf_window_products(torch.gather(dist, 2, perm), torch.gather(mask, 2, perm),
                                                         128, 12.0)
    assert needed_shuffled == needed and ran_shuffled <= 1.35 * needed, ran_shuffled / needed


@pytest.mark.parametrize("r", [2, 16, 128, 500])
def test_rbf_filter_windows_hold_every_non_zero_basis_value_on_random_edges(r):
    """Random distances up to 1.2 x the cutoff (bins at both ends of the rows
    and past the cutoff), masked edges, a lead shape whose edges end in a
    partial chunk and a partial group."""
    rng = np.random.default_rng(r)
    dist = torch.from_numpy(rng.uniform(0, 7.2, (3, 7, 37)).astype(np.float32))
    mask = torch.from_numpy(rng.random((3, 7, 37)) > 0.2)
    _rbf_window_products(dist, mask, r, 6.0)


# ----------------------------------------------------------------------------
# the Hopper kernels against the plain versions (skipped without a card)
# ----------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU or interpret mode)")
    return torch.device("cuda")


def _close(got, want):
    for g, w in zip(got, want):
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,ti",
    [((13, 10, 16, 64), 1), ((13, 10, 16, 64), 8), ((37, 45, 128, 192), 8), ((9, 3, 8, 128), 4),
     ((5, 120, 128, 64), 3), ((160, 50, 128, 512), 8), ((29, 45, 128, 48), 8), ((11, 1, 16, 100), 1),
     ((9, 8, 16, 33), 1), ((6, 7, 16, 50), 3), ((7, 12, 600, 64), 2)],
    ids=["ragged", "ragged-ti8", "k45-h192-ti8", "k3-ti4", "smem-over-48k", "sampling-width", "h48-ti8", "k1-h100",
         "h33-scalar", "h50", "r600-through-l2"],
)
def test_consumer_kernel_matches_plain_version_on_card(cuda_device, shape, ti):
    inputs = _torch(_consumer_inputs(7, *shape), cuda_device)
    name = "painn_message_consumer_tiled" if ti > 1 else "painn_message_consumer"
    before = kernels.launches[name]
    got = getattr(kernels, name)(**inputs, cutoff=6.0, ti=ti)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    _close(got, painn_message_consumer_reference(**inputs, cutoff=6.0))
    assert not got[0][-1].any() and not got[1][-1].any()  # the all-false row


@pytest.mark.cuda
def test_consumer_refuses_a_plan_that_disagrees_with_its_layout(cuda_device, monkeypatch):
    """A shared-memory size other than the layout's, no chunks or more chunks
    than targets, or float2 loads at an odd H: cudaErrorInvalidValue (1),
    nothing written; through the wrapper the refusal raises and counts no
    launch."""
    import ctypes

    inputs = _torch(_consumer_inputs(13, 13, 10, 16, 33), cuda_device)
    plan = kernels.consumer_plan(13, 10, 16, 33, kernels._sm_count(cuda_device))
    dx = torch.zeros((13, 33), device=cuda_device)
    dvec = torch.zeros((13, 3, 33), device=cuda_device)
    lib = kernels._library("painn_message_consumer", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                           + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [inputs[name].data_ptr() for name in NAMES] + [dx.data_ptr(), dvec.data_ptr()]
    for chunks, vec2, smem in ((plan.chunks, 0, plan.smem_bytes + 4), (0, 0, plan.smem_bytes),
                               (14, 0, plan.smem_bytes), (plan.chunks, 1, plan.smem_bytes)):
        err = lib.painn_message_consumer_f32(*ptrs, 13, 10, 16, 33, 1.0 / 6.0, 5, chunks, int(plan.stage_w), vec2,
                                             smem, stream)
        assert err == 1
    torch.cuda.synchronize()
    assert not dx.any() and not dvec.any()
    before = kernels.launches["painn_message_consumer"]
    monkeypatch.setattr(kernels, "consumer_plan", lambda *args: plan._replace(smem_bytes=plan.smem_bytes + 4))
    with pytest.raises(RuntimeError, match="launch failed at M, K, R, H = 13, 10, 16, 33"):
        painn_message_consumer(**inputs, cutoff=6.0)
    assert kernels.launches["painn_message_consumer"] == before


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,r,f", [((3, 10, 8), 16, 128), ((127,), 16, 100), ((2, 5, 50), 128, 1536), ((1280, 50), 128, 1536)],
    ids=["3x10x8", "127-f100", "2x5x50-f1536", "sampling-width"],
)
def test_rbf_filter_kernel_matches_plain_version_on_card(cuda_device, shape, r, f):
    inputs = _torch(_filter_inputs(8, shape, r=r, f=f), cuda_device)
    inputs["dist"].view(-1)[0] = 7.5  # unmasked past the cutoff: the bias
    inputs["mask"].view(-1)[0] = True
    before = kernels.launches["fused_rbf_filter"]
    got = fused_rbf_filter(**inputs, cutoff=6.0)
    torch.cuda.synchronize()
    assert kernels.launches["fused_rbf_filter"] == before + 1
    _close([got], [fused_rbf_filter_reference(**inputs, cutoff=6.0)])
    torch.testing.assert_close(got.reshape(-1, f)[0], inputs["bias"], rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_wrappers_raise_instead_of_falling_back(cuda_device):
    inputs = _torch(_consumer_inputs(9, *CONSUMER), cuda_device)
    with pytest.raises(TypeError, match="mask must be torch.bool"):
        painn_message_consumer(**dict(inputs, mask=inputs["mask"].float()), cutoff=6.0)
    with pytest.raises(ValueError, match="contiguous"):
        painn_message_consumer_tiled(**dict(inputs, unit=inputs["unit"].transpose(0, 1).contiguous()
                                            .transpose(0, 1)), cutoff=6.0)
    with pytest.raises(ValueError, match="ti must be"):
        painn_message_consumer_tiled(**inputs, cutoff=6.0, ti=0)
    with pytest.raises(NotImplementedError):
        painn_message_consumer(**dict(inputs, weights=inputs["weights"].requires_grad_()), cutoff=6.0)
    f = _torch(_filter_inputs(10, (4, 5)), cuda_device)
    with pytest.raises(TypeError, match="dist must be torch.float32"):
        fused_rbf_filter(**dict(f, dist=f["dist"].double()), cutoff=6.0)
    with pytest.raises(ValueError, match="shape"):
        fused_rbf_filter(**dict(f, mask=f["mask"][:, :4].contiguous()), cutoff=6.0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,r,f,fill",
    [((9,), 16, 128, None), ((3, 7, 37), 128, 1537, None), ((2, 5, 50), 500, 256, None), ((2, 5, 50), 500, 99, None),
     ((1000,), 128, 1, None), ((4, 50), 128, 1536, "all-masked"), ((16, 80, 50), 128, 1536, "bench"),
     ((16, 80, 50), 128, 1536, "bench-shuffled")],
    ids=["tail-group", "f1537-guarded", "r500-through-l2", "r500-f99", "f1", "all-masked", "bench-graph",
         "bench-shuffled"],
)
def test_rbf_filter_kernel_plan_branches_on_card(cuda_device, shape, r, f, fill):
    """Every branch of rbf_filter_plan and the kernel against the plain
    version: a group narrower than 8, F % 4 != 0 (4-byte copies and scalar
    stores), W read through L1/L2 (R = 500), F = 1, every edge masked (all
    zero), and the bench layer's sorted and shuffled graph; an unmasked
    edge past the cutoff gives the bias bit for bit."""
    inputs = _filter_inputs(11, shape, r=r, f=f)
    if fill in ("bench", "bench-shuffled"):
        from tests.test_torch_kernels import _bench_graph

        _, dist, mask, _ = _bench_graph()
        if fill == "bench-shuffled":
            perm = torch.from_numpy(np.random.default_rng(5).permuted(np.tile(np.arange(50), (16, 80, 1)), axis=-1))
            dist, mask = torch.gather(dist, 2, perm), torch.gather(mask, 2, perm)
        inputs.update(dist=dist.numpy().copy(), mask=mask.numpy().copy())
    inputs = _torch(inputs, cuda_device)
    if fill == "all-masked":
        inputs["mask"].zero_()
    else:
        inputs["dist"].view(-1)[0], inputs["mask"].view(-1)[0] = 1e3, True  # unmasked past the cutoff: the bias
    before = kernels.launches["fused_rbf_filter"]
    got = fused_rbf_filter(**inputs, cutoff=6.0 if fill is None else 12.0)
    torch.cuda.synchronize()
    assert kernels.launches["fused_rbf_filter"] == before + 1
    _close([got], [fused_rbf_filter_reference(**inputs, cutoff=6.0 if fill is None else 12.0)])
    if fill == "all-masked":
        assert not got.any()
    else:
        torch.testing.assert_close(got.reshape(-1, f)[0], inputs["bias"], rtol=0, atol=0)


@pytest.mark.cuda
def test_rbf_filter_refuses_a_plan_that_disagrees_with_its_layout(cuda_device):
    """A shared-memory size other than the layout's, blocks not a multiple
    of the column slices, or float4 where F % 4 != 0: cudaErrorInvalidValue
    (1), nothing launched."""
    import ctypes

    f = _torch(_filter_inputs(12, (4, 50), r=16, f=130), cuda_device)
    out = torch.zeros((4, 50, 130), device=cuda_device)
    plan = kernels.rbf_filter_plan(200, 16, 130, kernels._sm_count(cuda_device))
    lib = kernels._library("fused_rbf_filter", [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 2
                           + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    for blocks, vec, smem in ((plan.blocks, 0, plan.smem_bytes + 4), (plan.blocks + 1, 0, plan.smem_bytes),
                              (plan.blocks, 1, plan.smem_bytes)):
        err = lib.fused_rbf_filter_f32(f["dist"].data_ptr(), f["mask"].data_ptr(), f["weights"].data_ptr(),
                                       f["bias"].data_ptr(), out.data_ptr(), 200, 16, 130, 1.0 / 6.0, 5, blocks,
                                       int(plan.stage_w), vec, smem, stream)
        assert err == 1
    torch.cuda.synchronize()
    assert not out.any()
