"""PyTorch port: the layouts the bf16 tensor-core kernels take, on the CPU.

``csrc/eqv2_attn_conv1_bf16.cu`` reads its weights as
``kernels.pack_attn_conv1_mma`` packs them (bf16, zero-padded to k16 rows and
n8 columns, each m-block's gate columns padded to k16), and
``csrc/s2_grid_silu_bf16.cu`` its tables as ``kernels.s2_bf16_tables`` lays
them out.  Here each layout is unpacked and held, exactly, against the
values the plain versions use: ``pack_attn_conv1(..., dtype=bfloat16)``
(the weights rounded to bf16, as the TPU wrapper casts them) and the tables
rounded to bf16, with zeros in every pad.  The plans' shared memory is held
against one block's 227 KB at the eqv2_so3.yml widths and at the ragged
cases' widths of ``chip_smoke.py`` phase 25, and widths they cannot take are
refused with a ValueError.  The kernels themselves run only on the card
(``tests/test_torch_kernels.py -m cuda``, ``chip_smoke.py`` phase 25).
"""
import numpy as np
import pytest
import torch

from adsorbdiff_tpu_torch.models import equiformer_v2
from adsorbdiff_tpu_torch.ops import kernels
from tests.test_torch_kernels import CONV1_L4, CONV1_TINY, _conv1_inputs, _torch_tree
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16
# chip_smoke.py's EQV2_ODD widths with a lead: C 12, c_out 6, extra 11, 21 gaussians, trunk 24
CONV1_ODD = (2, 1, (37,), 12, 6, 11, 21, 24, 6.0)
# eqv2_so3.yml: lmax 4, mmax 2, C 128, c_out 64, extra 576, 600 gaussians, trunk and embedding 128
CONV1_SO3 = (4, 2, (3,), 128, 64, 576, 600, 128, 12.0)
CASES = [CONV1_TINY, CONV1_L4, CONV1_ODD, CONV1_SO3]
IDS = ["tiny", "l4m2", "odd", "eqv2_so3"]
SMEM_PER_BLOCK = 232448 - 1024


def _trees(case):
    edges, rad, conv, kw = _conv1_inputs(80, *case)
    return _torch_tree(rad), _torch_tree(conv), kw, edges["emb_s"].shape[-1], edges["msg_s"].shape[-1]


def _pads_zero(t, rows, cols):
    return not t[rows:].any() and not t[:, cols:].any()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_conv1_mma_packing_unpacks_to_the_bf16_weights(case):
    """Every matrix of pack_attn_conv1_mma holds pack_attn_conv1's bf16
    values bit for bit in its top-left corner and zeros elsewhere; w2's and
    b2's gate columns sit per half and m-block at k16-padded offsets; the
    vectors equal pack_attn_conv1's."""
    rad, conv, kw, _, c = _trees(case)
    args = dict(lmax=kw["lmax"], mmax=kw["mmax"], num_gauss=kw["num_gauss"], c_in=c)
    want = kernels.pack_attn_conv1(rad, conv, dtype=BF16, **args)
    got = kernels.pack_attn_conv1_mma(rad, conv, **args)
    assert got.flat.dtype == BF16 and all(m.dtype == BF16 for m in got.mats)
    assert all(v.dtype == torch.float32 for v in got.vecs)
    wg, ws, wt, b0, ln0s, ln0b, w1, b1, ln1s, ln1b, w2, b2, bm0 = want.trunk
    for m, w in zip(got.mats[:4] + got.mats[5:], (wg, ws, wt, w1) + want.conv):
        assert m.shape[0] % 16 == 0 and m.shape[1] % 8 == 0
        assert torch.equal(m[:w.shape[0], :w.shape[1]].float(), w) and _pads_zero(m, *w.shape)
    nb, hidden = want.n_blocks, w1.shape[0]
    kp = tuple(-(-n * c // 16) * 16 for n in nb)
    assert got.kp == kp and got.mats[4].shape == (-(-hidden // 16) * 16, 2 * sum(kp))
    assert not got.mats[4][hidden:].any()
    half, half_p = sum(nb) * c, sum(kp)
    for h in range(2):
        off = off_p = 0
        for n, k_pad in zip(nb, kp):
            k = n * c
            cols = slice(h * half_p + off_p, h * half_p + off_p + k)
            assert torch.equal(got.mats[4][:hidden, cols].float(), w2[:, h * half + off:h * half + off + k])
            assert torch.equal(got.vecs[6][cols], b2[h * half + off:h * half + off + k])
            pad = slice(h * half_p + off_p + k, h * half_p + off_p + k_pad)
            assert not got.mats[4][:, pad].any() and not got.vecs[6][pad].any()
            off, off_p = off + k, off_p + k_pad
    for v, w in zip(got.vecs[:6] + got.vecs[7:], (b0, ln0s, ln0b, b1, ln1s, ln1b, bm0)):
        assert torch.equal(v, w)
    # one flat buffer, the matrices in the kernel's order, back to back
    off = 0
    for m in got.mats:
        assert m.data_ptr() == got.flat.data_ptr() + 2 * off
        off += m.numel()
    assert off == got.flat.numel()


@pytest.mark.parametrize("lmax,mmax,res,nc", [(4, 0, 18, 5), (2, 2, 18, 9), (4, 2, 18, 19), (4, 4, 18, 25),
                                              (2, 1, 16, 7)])
def test_s2_bf16_tables_unpack_to_the_rounded_tables(lmax, mmax, res, nc):
    """The tables' flat bf16 layout: to_grid_m and from_grid_m rounded to
    bf16 in the corners, zeros in every pad, rows of an odd number of
    16-byte chunks."""
    to_m, from_m = (torch.from_numpy(t) for t in equiformer_v2.s2_act_matrices(lmax, mmax, res))
    g = to_m.shape[0]
    assert to_m.shape[1] == nc
    ks, nt, gp, ts, fs = kernels.s2_bf16_layout(nc, g)
    assert 16 * ks >= nc and 8 * nt >= nc and gp % 16 == 0 and gp >= g and (ts // 8) % 2 == 1 and (fs // 8) % 2 == 1
    blob = kernels.s2_bf16_tables(to_m, from_m)
    assert blob.dtype == BF16 and blob.numel() == gp * ts + nt * 8 * fs
    to_p, from_p = blob[:gp * ts].view(gp, ts), blob[gp * ts:].view(nt * 8, fs)
    assert torch.equal(to_p[:g, :nc].float(), to_m.to(BF16).float()) and _pads_zero(to_p, g, nc)
    assert torch.equal(from_p[:nc, :g].float(), from_m.to(BF16).float()) and _pads_zero(from_p, nc, g)


def test_s2_bf16_tables_at_nc_32():
    """Random NC = 32 tables (phase 25's case): two k16 steps, four n8 tiles."""
    rng = np.random.default_rng(81)
    to_m, from_m = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((324, 32), (32, 324)))
    assert kernels.s2_bf16_layout(32, 324)[:3] == (2, 4, 336)
    blob = kernels.s2_bf16_tables(to_m, from_m)
    assert torch.equal(blob[:336 * 40].view(336, 40)[:324, :32].float(), to_m.to(BF16).float())
    assert torch.equal(blob[336 * 40:].view(32, 344)[:, :324].float(), from_m.to(BF16).float())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_conv1_bf16_plan_fits_one_block(case):
    """The bf16 kernel's plan at each width fits 227 KB and launches the f32
    plan's grid of 64-edge tiles, 8 warps a block; it makes at least the f32
    plan's FLOP again (its |m| > 0 passes are at most 192 columns wide, so
    an m-block of 256 makes its gates twice).  At the eqv2_so3.yml widths
    198,624 bytes, 132 blocks on 132 SMs, and the m0 gates, the units'
    trunks and m1's second gates made again: 599,901 FLOP an edge at E =
    25,600; trunk and embedding widths of 144 (the f32 64-edge route's
    widest at C = 128) fit too."""
    lmax, mmax, _, c, c_out, extra, r, width, _ = case
    nb = kernels.conv1_blocks(lmax, mmax)
    for e in (25_600, 64 * 132 + 17, 16):
        plan = kernels.attn_conv1_bf16_plan(e, r, width, width, c, c_out, extra, nb, 132)
        f32 = kernels.attn_conv1_plan(e, r, width, width, c, c_out, extra, nb, 132)
        assert plan.smem_bytes <= SMEM_PER_BLOCK
        assert (plan.blocks, plan.tile, plan.threads) == (f32.blocks, f32.tile, 256)
        assert plan.extra_flops_per_edge >= f32.extra_flops_per_edge
    if case is CONV1_SO3:
        plan = kernels.attn_conv1_bf16_plan(25_600, r, width, width, c, c_out, extra, nb, 132)
        assert (plan.smem_bytes, plan.blocks, plan.extra_flops_per_edge) == (198_624, 132, 599_901)
        assert kernels.attn_conv1_bf16_plan(25_600, r, 144, 144, c, c_out, extra, nb, 132).smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.parametrize("nc,c", [(5, 3), (9, 16), (19, 64), (25, 9), (32, 16)])
def test_s2_bf16_plan_fits_two_blocks_an_sm(nc, c):
    """Persistent blocks of 8 warps, two an SM, each warp 32 columns; at the
    sampling shape 264 blocks and 59,776 bytes."""
    m = 25_600 if nc == 19 else 129
    plan = kernels.s2_grid_silu_bf16_plan(m, nc, c, 324, 132)
    assert plan.threads == 256 and plan.tile == 256 and 2 * (plan.smem_bytes + 1024) <= 233472
    assert plan.blocks == min(-(-m * c // 256), 264)
    if nc == 19:
        assert (plan.blocks, plan.smem_bytes) == (264, 59_776)


def test_bf16_plans_refuse_what_they_cannot_take():
    """Trunk and embedding widths of 256 overflow the bf16 conv1 block (the
    wide route takes them, in f32 only); NC 33 and a grid whose tables
    overflow a block are refused by the S^2 kernel's layout and plan."""
    nb = kernels.conv1_blocks(4, 2)
    with pytest.raises(ValueError, match="bf16 kernel"):
        kernels.attn_conv1_bf16_plan(25_600, 600, 256, 256, 128, 64, 576, nb, 132)
    with pytest.raises(ValueError, match="NC <= 32"):
        kernels.s2_bf16_layout(33, 324)
    with pytest.raises(ValueError, match="bf16 tables"):
        kernels.s2_grid_silu_bf16_plan(100, 32, 16, 64 * 64, 132)


def test_conv1_mma_packing_refuses_mismatched_weights():
    rad, conv, kw, _, c = _trees(CONV1_TINY)
    conv["fc_m1_i"]["kernel"] = conv["fc_m1_i"]["kernel"][:, :-1]
    with pytest.raises(ValueError, match="conv kernel"):
        kernels.pack_attn_conv1_mma(rad, conv, lmax=kw["lmax"], mmax=kw["mmax"], num_gauss=kw["num_gauss"], c_in=c)
