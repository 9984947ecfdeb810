"""PyTorch port: the layout, plan and dataflow of the bf16 PaiNN message kernel, on the CPU.

``csrc/painn_message_fused_bf16.cu`` runs PaiNN's filter product for bf16
``xh`` on the bf16 tensor cores: W^T (``kernels.pack_painn_message_bf16``,
W rounded to bf16, each 32-column slice's rows permuted so that a lane of an
m16n8k16 C fragment holds four consecutive columns of each H-block) against
basis fragments of 8 slots, over the 16-row chunks a tile's windows reach
(``kernels.painn_bf16_chunks``).  Here the pack is unpacked and held,
exactly, against ``W.to(bf16)``; the chunk rule is shown to leave out only
rows whose basis is 0; the kernel's dataflow (``emulate_painn_bf16``: its
rounded basis, its chunks, its unpacked W, f32 sums) is held against the
plain version ``painn_message_fused_reference`` within the gate of
``chip_smoke.py`` phase 25 (1e-3 * max|plain| + 1e-5: the sums run in
another order) and against the TPU kernel (interpret mode); and the plan is
held against one block's shared memory.  The kernel itself runs only on the
card (``tests/test_torch_kernels.py -m cuda -k bf16_message``, ``chip_smoke.py``
phase 25).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adsorbdiff_tpu.ops import pallas_kernels as pk
from adsorbdiff_tpu_torch.ops import kernels
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_kernels import _inputs

BF16 = torch.bfloat16
SMEM_PER_BLOCK = 232448
# b, n, k, r, h: phase 3's ragged shape; K = 1; K = 17 with R = 21 and H = 40; N = 1; K = 45 with H = 192
SHAPES = {"ragged": (2, 13, 10, 16, 64), "k1": (2, 13, 1, 16, 64), "k17-r21-h40": (2, 13, 17, 21, 40),
          "n1": (3, 1, 6, 16, 64), "k45-h192": (1, 37, 45, 128, 192)}
SAMPLING = (16, 80, 50, 128, 512)  # painn_so3.yml's widths, B=16 (the bf16 PaiNN sample)
NAMES = ("xh", "vec", "src", "dist", "mask", "unit", "weight", "bias")


def _bf16_inputs(seed, shape, vec_bf16, fill=None):
    """Kernel inputs with bf16 xh (and vec), and the plain version's inputs
    for them (``fill``: "bad-src", sources -1 and N + 5 on unmasked slots,
    which the plain version takes as masked; "past-cutoff", system 0's slots
    unmasked, every other one at or past the cutoff)."""
    t = {k: torch.from_numpy(v) for k, v in _inputs(seed, *shape).items()}
    t["xh"] = t["xh"].to(BF16)
    if vec_bf16:
        t["vec"] = t["vec"].to(BF16)
    n = shape[1]
    if fill == "bad-src":
        t["src"][..., ::7] = -1
        t["src"][..., 3::11] = n + 5
    elif fill == "past-cutoff":
        t["mask"][0] = True
        far = t["dist"][0, :, ::2]
        far.copy_(torch.linspace(1.0, 1.5, far.numel()).reshape(far.shape) * 6.0)
    ok = (t["src"] >= 0) & (t["src"] < n)
    return t, dict(t, src=torch.where(ok, t["src"], 0), mask=t["mask"] & ok)


def _unpack(wt, r, h):
    """W ``[R16, 3H]`` f32 from the pack, and a check that every other
    element of it is 0."""
    r16 = math.ceil(r / 16) * 16
    cols = kernels._bf16_w_columns(h, torch.device("cpu")).reshape(-1)
    rows = wt.reshape(cols.numel(), -1).float()
    assert torch.all(rows[cols == 3 * h] == 0) and torch.all(rows[:, r:] == 0)
    w = torch.zeros((r16, 3 * h))
    w[:, cols[cols < 3 * h]] = rows[cols < 3 * h, :r16].t()
    return w


def emulate_painn_bf16(xh, vec, src, dist, mask, unit, weight, bias, *, cutoff, envelope_exponent=5):
    """``csrc/painn_message_fused_bf16.cu``'s dataflow in plain PyTorch: the
    slots whose source lies in [0, N) and whose mask is set are valid (d =
    dist / cutoff, else 2); each basis value by the kernel's f32 steps
    (offset r / (R - 1), difference, square, times -(R-1)^2 / 2, exp, times
    the envelope of power terms) rounded to bf16; a tile of 8 slots takes
    only the rows of its chunks (``painn_bf16_chunks``); W from its pack;
    the filter starts from the bias and sums in f32; a valid slot's row
    times the filter, the rest adds nothing.  Returns (dx, dvec, basis)."""
    b, n, k = src.shape
    r, f3 = weight.shape
    h = f3 // 3
    r16 = math.ceil(r / 16) * 16
    valid = mask & (src >= 0) & (src < n)
    d = torch.where(valid, dist.float() * (1.0 / cutoff), torch.full_like(dist, 2.0))
    p = float(envelope_exponent)
    env = 1 + (-(p + 1) * (p + 2) / 2) * d**p + p * (p + 2) * d ** (p + 1) + (-p * (p + 1) / 2) * d ** (p + 2)
    env = torch.where(d < 1.0, env, torch.zeros_like(env))
    off = torch.where(torch.arange(r16) < r, torch.arange(r16, dtype=torch.float32) / (r - 1), torch.zeros(r16))
    basis = (torch.exp(-0.5 * (r - 1) ** 2 * (d[..., None] - off) ** 2) * env[..., None]).to(BF16).float()
    first, last = kernels.painn_bf16_chunks(dist, mask, src, r, cutoff)
    tile = torch.arange(k) // 8
    chunk = torch.arange(r16) // 16
    keep = (chunk >= first[..., tile, None]) & (chunk <= last[..., tile, None])  # [B, N, K, R16]
    basis = torch.where(keep, basis, torch.zeros_like(basis))
    filt = basis @ _unpack(kernels.pack_painn_message_bf16(weight), r, h) + bias.float()
    idx = torch.where(valid, src, 0).reshape(b, n * k, 1).long().expand(-1, -1, f3)
    rows = valid[..., None].float()
    xh_g = torch.gather(xh.float(), 1, idx).reshape(b, n, k, f3) * rows
    vec_g = torch.gather(vec.float(), 1, idx).reshape(b, n, k, f3) * rows
    dx, dvec = kernels._message_from_filter(filt, unit, xh_g, vec_g)
    return dx, dvec, basis


def _gate(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        err = (g - w).abs().max().item()
        assert err <= 1e-3 * w.abs().max().item() + 1e-5, err


@pytest.mark.parametrize("r, h", [(2, 4), (16, 64), (21, 40), (128, 512), (130, 36)])
def test_pack_unpacks_exactly_to_the_bf16_weights(r, h):
    w = torch.from_numpy(np.random.default_rng(r + h).normal(0, 1, (r, 3 * h)).astype(np.float32))
    wt = kernels.pack_painn_message_bf16(w)
    plan = kernels.painn_bf16_plan(1, 1, 1, r, h, 132)
    assert wt.dtype == BF16 and tuple(wt.shape) == (math.ceil(h / 32), 96, plan.w_stride)
    assert plan.w_stride >= math.ceil(r / 16) * 16 and (plan.w_stride // 8) % 2 == 1  # odd 16-byte chunks
    assert torch.equal(_unpack(wt, r, h)[:r], w.to(BF16).float())


def test_pack_gives_a_lane_four_consecutive_columns_of_each_h_block():
    """Rows g and g + 8 of m16 tiles 2j and 2j + 1 (a C fragment's rows of
    lane 4g + t) are W's columns jH + 32 s + 4g .. 4g + 3 of slice s."""
    h = 64
    cols = kernels._bf16_w_columns(h, torch.device("cpu"))
    for s in range(2):
        for j in range(3):
            for g in range(8):
                got = [int(cols[s, 16 * (2 * j + q) + i]) for q in range(2) for i in (g, g + 8)]
                assert got == [j * h + 32 * s + 4 * g + e for e in range(4)]


@pytest.mark.parametrize("r", [128, 21])
@pytest.mark.parametrize("order", ["random", "sorted"])
def test_chunk_rule_leaves_out_only_zero_basis_rows(r, order):
    """Every non-zero bf16 basis value of a valid slot lies in its tile's
    chunks; the chunks of a tile with a valid slot in reach start and end
    where its window does."""
    b, n, k = 3, 20, 50
    t = {x: torch.from_numpy(v) for x, v in _inputs(5, b, n, k, r, 8).items() if x in ("src", "dist", "mask")}
    if order == "sorted":  # a neighbour table's order: nearest first
        t["dist"] = torch.sort(t["dist"], dim=-1).values
    first, last = kernels.painn_bf16_chunks(t["dist"], t["mask"], t["src"], r, 6.0)
    lo, hi = kernels.painn_fwd_windows(t["dist"], t["mask"], t["src"], r, 6.0)
    basis = kernels.message_basis(t["dist"], r, 6.0, 5).to(BF16)
    valid = t["mask"] & (t["src"] >= 0) & (t["src"] < n)
    tile = torch.arange(k) // 8
    row_chunk = torch.arange(r) // 16
    inside = (row_chunk >= first[..., tile, None]) & (row_chunk <= last[..., tile, None])
    assert not torch.any((basis != 0) & valid[..., None] & ~inside)
    some = hi >= lo
    assert torch.equal(first[some], lo[some] // 16) and torch.equal(last[some], hi[some] // 16)
    assert torch.all(last[~some] < first[~some])


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("fill", [None, "bad-src", "past-cutoff"])
@pytest.mark.parametrize("vec_bf16", [True, False], ids=["vec-bf16", "vec-f32"])
def test_kernel_dataflow_matches_the_plain_version(shape, fill, vec_bf16):
    t, plain = _bf16_inputs(80, shape, vec_bf16, fill)
    dx, dvec, basis = emulate_painn_bf16(**t, cutoff=6.0)
    _gate((dx, dvec), kernels.painn_message_fused_reference(**plain, cutoff=6.0))
    # its basis is the plain version's rounded basis, bit for bit, wherever a slot is valid
    valid = plain["mask"]
    want = kernels.message_basis(t["dist"], shape[3], 6.0, 5).to(BF16).float()
    assert torch.equal(basis[..., :shape[3]][valid], want[valid])


@pytest.mark.parametrize("vec_bf16", [True, False], ids=["vec-bf16", "vec-f32"])
def test_kernel_dataflow_matches_the_tpu_kernel(vec_bf16):
    """The emulation against the TPU kernel in interpret mode, on the same
    bf16 values (its bf16 product, basis and W rounded, summed in f32)."""
    t, _ = _bf16_inputs(81, SHAPES["ragged"], vec_bf16)
    j = {x: jnp.asarray(v.float().numpy(), jnp.bfloat16) if v.dtype == BF16 else jnp.asarray(v.numpy())
         for x, v in t.items()}
    want = pk.painn_message_fused(*(j[x] for x in NAMES), cutoff=6.0, envelope_exponent=5, ti=8)
    got = emulate_painn_bf16(**t, cutoff=6.0)[:2]
    _gate(got, [torch.from_numpy(np.array(w)).reshape(g.shape) for g, w in zip(got, want)])


@pytest.mark.parametrize("shape", [SAMPLING, (48, 80, 50, 128, 512)] + list(SHAPES.values()),
                         ids=["sampling", "training"] + list(SHAPES))
def test_plan_fits_one_block_and_covers_every_target_and_column_once(shape):
    b, n, k, r, h = shape
    plan = kernels.painn_bf16_plan(b, n, k, r, h, 132)
    chunks, t, tiles = math.ceil(r / 16), b * n, math.ceil(k / 8)
    assert plan.smem_bytes == 2 * 96 * plan.w_stride and plan.w_stride >= 16 * chunks
    assert plan.smem_bytes <= SMEM_PER_BLOCK and plan.per_sm == 2 and plan.threads == 256
    # the scratch: a 256-byte B fragment a (target, tile, chunk), then a chunk range (8 bytes) and 8 slot records
    # (16 bytes each) a (target, tile), 16-byte aligned
    assert (plan.tiles, plan.chunks, plan.basis_blocks) == (tiles, chunks, math.ceil(t * tiles / 32))
    assert plan.range_off == t * tiles * chunks * 256 and plan.record_off >= plan.range_off + 8 * t * tiles
    assert plan.record_off % 16 == 0 and plan.scratch_bytes == plan.record_off + 128 * t * tiles
    assert plan.tpb == t or plan.tpb % 8 == 0
    ranges = math.ceil(t / plan.tpb)
    assert plan.slices == math.ceil(h / 32) and plan.blocks == ranges * plan.slices
    assert plan.load == math.ceil(plan.tpb / 8)
    covered = np.zeros((t, plan.slices * 32), np.int32)
    for x in range(ranges):
        for y in range(plan.slices):
            covered[x * plan.tpb:(x + 1) * plan.tpb, 32 * y:32 * y + 32] += 1
    assert np.all(covered[:, :h] == 1)


def test_plan_at_the_sampling_shape_takes_one_wave_of_two_blocks_an_sm():
    plan = kernels.painn_bf16_plan(*SAMPLING, 132)
    assert (plan.tpb, plan.blocks, plan.load) == (80, 256, 10) and plan.waves <= 1


def test_plan_refuses_what_the_kernel_cannot_take():
    for shape in [(2, 13, 0, 16, 64), (2, 13, 10, 1, 64), (2, 13, 10, 16, 42), (2, 13, 10, 1201, 64)]:
        with pytest.raises(ValueError, match="painn_message_fused.bf16"):
            kernels.painn_bf16_plan(*shape, 132)
    assert kernels.painn_bf16_plan(2, 13, 10, 1200, 64, 132).smem_bytes <= SMEM_PER_BLOCK
