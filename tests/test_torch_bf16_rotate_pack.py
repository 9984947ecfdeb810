"""PyTorch port: the layouts of the bf16 tensor-core rotation and S^2 backward, on the CPU.

``csrc/eqv2_edge_rotate_bf16.cu`` runs the edge-frame rotation on permuted
coefficient slots (``kernels.rotate_bf16_layout``: each (l, +m) row and its
(l, -m) partner at slots (2j, 2j+1), so a Dz stage stays inside a lane) with
J as one permuted, zero-padded bf16 matrix (``kernels.rotate_bf16_consts``).
Here the blob is unpacked and held, exactly, against J rounded to bf16 in
natural order; the kernel's dataflow (``emulate_rotate_bf16``: the permuted
chain with the packed constants, rounded where the kernel rounds) is held
against the plain bf16 chain ``_edge_rotate_bf16_reference`` within one bf16
ulp of the largest element + 1e-5 (the gate of ``chip_smoke.py`` phase 25:
the products sum in f32 in another order, which can move a rounding by one
ulp), in both directions and all three input forms; and the plans of both
kernels are held against one block's shared memory.  The kernels themselves
run only on the card (``tests/test_torch_kernels.py -m cuda``, ``chip_smoke.py``
phase 25).
"""
import math

import numpy as np
import pytest
import torch

from adsorbdiff_tpu_torch.models import so3
from adsorbdiff_tpu_torch.ops import kernels
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16
SMEM_PER_BLOCK = 232448 - 1024
LAYOUTS = [(1, 1), (2, 1), (3, 3), (4, 2), (5, 2), (6, 2), (6, 6)]


def _r(t):
    return t.to(BF16).float()


def _unpack(blob, p):
    js = kernels._odd_stride(p)
    j = torch.from_numpy(np.ascontiguousarray(blob[:p * js])).view(BF16).float().reshape(p, js)
    maps = blob[p * js:]
    return j, maps[:p], maps[p:2 * p], maps[2 * p:5 * p // 2], maps[5 * p // 2:3 * p], maps[3 * p:]


def emulate_rotate_bf16(x, src, gamma, beta, lmax, mmax, n_sel, direction, blob=None):
    """``csrc/eqv2_edge_rotate_bf16.cu``'s dataflow in plain PyTorch (f32
    tensors of bf16 values): each edge's input rows copied into the slots of
    ``rotate_bf16_layout``, Dz on slot pairs (each product and the sum
    rounded; cos/sin(m t) rounded, the pair's and the direction's sign
    folded in), the products with the blob's J[pi, pi] summed in f32 and
    rounded once, the output rows stored from their slots.  ``blob``
    defaults to the kernel's constants.  Returns bf16."""
    layout = kernels.rotate_bf16_layout(lmax, mmax, n_sel, direction)
    p = layout.p
    blob = kernels._rotate_bf16_blob(lmax, mmax, n_sel, direction) if blob is None else blob
    j, in_row, out_row, pair_m, pair_sign, _ = _unpack(blob, p)
    j = j[:, :p]
    lead, c = tuple(gamma.shape), x.shape[-1]
    rows = kernels._gather_rows(x, src) if src is not None else x.expand(lead + tuple(x.shape[-2:]))
    rows = rows.reshape(-1, x.shape[-2], c).float()
    e = rows.shape[0]
    v = torch.zeros(e, p, c)
    live = torch.from_numpy(in_row >= 0)
    v[:, live] = rows[:, torch.from_numpy(in_row[in_row >= 0].astype(np.int64))]
    sign = (1.0 if direction == "to" else -1.0) * torch.from_numpy(pair_sign.astype(np.float32))
    m = torch.from_numpy(pair_m.astype(np.float32))

    def dz(v, t):
        a = t.reshape(-1, 1).float() * m
        cs, sn = _r(torch.cos(a))[..., None], (_r(torch.sin(a)) * sign)[..., None]
        lo, hi = v[:, 0::2], v[:, 1::2]
        return torch.stack([_r(_r(lo * cs) + _r(hi * sn)), _r(_r(hi * cs) + _r(lo * -sn))], dim=2).reshape(e, p, c)

    def jt(v):  # J^T v
        return _r(torch.einsum("kn,ekc->enc", j, v))

    def jn(v):  # J v
        return _r(torch.einsum("nk,ekc->enc", j, v))

    v = jn(dz(jt(dz(v, gamma)), beta)) if direction == "to" else dz(jn(dz(jt(v), beta)), gamma)
    n_out = n_sel if direction == "to" else (lmax + 1) ** 2
    out = torch.zeros(e, n_out, c)
    w = out_row >= 0
    out[:, torch.from_numpy(out_row[w].astype(np.int64))] = v[:, torch.from_numpy(w)]
    return out.reshape(lead + (n_out, c)).to(BF16)


def _within_one_ulp(got, want):
    top = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= math.ldexp(1.0, math.frexp(top)[1] - 8) + 1e-5, (err, top)


@pytest.mark.parametrize("lmax,mmax", LAYOUTS)
@pytest.mark.parametrize("direction", ["to", "from"])
def test_rotate_bf16_consts_unpack_to_the_bf16_j(lmax, mmax, direction):
    """The blob's J[pi, pi], put back in natural order, is J rounded to bf16
    bit for bit (J's blocks as the f32 kernel takes them, rounded as the TPU
    wrapper rounds them), zeros in every pad row, pad column and stride pad;
    its maps are the layout's."""
    n_sel = so3.n_act_rows(lmax, mmax)
    layout = kernels.rotate_bf16_layout(lmax, mmax, n_sel, direction)
    p, dim = layout.p, (lmax + 1) ** 2
    blob = kernels._rotate_bf16_blob(lmax, mmax, n_sel, direction)
    assert blob.dtype == np.int16 and blob.size * 2 % 16 == 0
    j, in_row, out_row, pair_m, pair_sign, tail = _unpack(blob, p)
    assert not j[:, p:].any() and not tail.any()
    live = layout.perm >= 0
    assert sorted(layout.perm[live]) == list(range(dim))
    assert not j[~torch.from_numpy(live)].any() and not j[:, :p][:, ~torch.from_numpy(live)].any()
    natural = torch.zeros(dim, dim)
    idx = torch.from_numpy(layout.perm[live])
    natural[idx[:, None], idx[None, :]] = j[:, :p][torch.from_numpy(live)][:, torch.from_numpy(live)]
    want = _r(torch.from_numpy(np.asarray(so3.get_J_matrix(lmax), np.float32)))
    assert torch.equal(natural, want)
    j_blocks = so3.edge_rot_consts(lmax, mmax, n_sel)[0]
    off = 0
    for l in range(lmax + 1):
        n = 2 * l + 1
        block = natural[l * l:(l + 1) ** 2, l * l:(l + 1) ** 2].reshape(-1)
        assert torch.equal(block, _r(torch.from_numpy(j_blocks[off:off + n * n])))
        off += n * n
    for got, field in ((in_row, layout.in_row), (out_row, layout.out_row), (pair_m, layout.pair_m),
                       (pair_sign, layout.pair_sign)):
        assert np.array_equal(got, field)


@pytest.mark.parametrize("lmax", range(1, 7))
def test_rotate_bf16_slot_groups_hold_whole_l_blocks(lmax):
    """Each 16-slot group holds whole l blocks of J (so J[perm, perm] is
    block diagonal over the groups), as few groups as J's sizes allow."""
    layout = kernels.rotate_bf16_layout(lmax, min(lmax, 2), so3.n_act_rows(lmax, min(lmax, 2)), "to")
    assert layout.p == 16 * {1: 1, 2: 1, 3: 1, 4: 2, 5: 3, 6: 4}[lmax]
    l_of = {i: math.isqrt(i) for i in range((lmax + 1) ** 2)}
    groups = [{l_of[int(i)] for i in layout.perm[16 * g:16 * g + 16] if i >= 0} for g in range(layout.p // 16)]
    assert sorted(l for gr in groups for l in gr) == list(range(lmax + 1))  # each l in one group only
    j = _unpack(kernels._rotate_bf16_blob(lmax, min(lmax, 2), so3.n_act_rows(lmax, min(lmax, 2)), "to"), layout.p)[0]
    for g in range(layout.p // 16):
        off = j[16 * g:16 * g + 16, :layout.p].clone()
        off[:, 16 * g:16 * g + 16] = 0
        assert not off.any()


@pytest.mark.parametrize("lmax,mmax", LAYOUTS)
def test_rotate_bf16_layout_pairs_each_row_with_its_partner(lmax, mmax):
    """Every (l, +m) row at an even slot 2j with its (l, -m) partner at
    2j + 1, the pair's |m| and the Dz sign of its first row recorded; the
    m = 0 rows (and one pad where their count is odd) in pairs of |m| 0;
    p a multiple of 16; the slots each direction reads and writes are
    the selection's."""
    n_sel = so3.n_act_rows(lmax, mmax)
    _, swap, sign = so3.zrot_swap_sign(lmax)
    row = so3.edge_rot_consts(lmax, mmax, n_sel)[2]
    to = kernels.rotate_bf16_layout(lmax, mmax, n_sel, "to")
    back = kernels.rotate_bf16_layout(lmax, mmax, n_sel, "from")
    assert to.p % 16 == 0 and (lmax + 1) ** 2 <= to.p
    for jj in range(to.p // 2):
        a, b = to.perm[2 * jj], to.perm[2 * jj + 1]
        if to.pair_m[jj] == 0:
            for i in (a, b):
                assert i == -1 or i == int(math.isqrt(i)) ** 2 + int(math.isqrt(i))  # an m = 0 row or a pad
        else:
            l = math.isqrt(a)
            assert a == l * l + l + to.pair_m[jj] and b == swap[a] == l * l + l - to.pair_m[jj]
            assert to.pair_sign[jj] == sign[a] == -sign[b]
    sel = np.where(to.perm >= 0, row[np.maximum(to.perm, 0)], -1)
    assert np.array_equal(to.in_row, to.perm) and np.array_equal(to.out_row, sel)
    assert np.array_equal(back.in_row, sel) and np.array_equal(back.out_row, to.perm)
    for lay in (to, back):  # the groups that hold input rows (the first product's) and output rows (the second's)
        for rows, mask in ((lay.in_row, lay.in_groups), (lay.out_row, lay.out_groups)):
            assert mask == sum(1 << g for g in range(lay.p // 16) if (rows[16 * g:16 * g + 16] >= 0).any()) > 0


def _rotate_case(seed, lmax, mmax, form, c, b=2, n=5, k=3):
    rng = np.random.default_rng(seed)
    dim, n_act = (lmax + 1) ** 2, so3.n_act_rows(lmax, mmax)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(BF16)

    gamma = torch.from_numpy(rng.uniform(-np.pi, np.pi, (b, n, k)).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(0, np.pi, (b, n, k)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, n, (b, n, k)).astype(np.int32))
    return {"to": (t(b, n, k, dim, c), None, "to", n_act),
            "to-node-row": (t(b, n, 1, dim, c), None, "to", n_act),
            "gather-to": (t(b, n, dim, c), src, "to", n_act),
            "from": (t(b, n, k, n_act, c), None, "from", n_act),
            "from-n0": (t(b, n, k, lmax + 1, c), None, "from", lmax + 1)}[form], gamma, beta


@pytest.mark.parametrize("lmax,mmax,c", [(2, 1, 5), (4, 2, 16), (6, 2, 3)], ids=["l2m1-c5", "l4m2-c16", "l6m2-c3"])
@pytest.mark.parametrize("form", ["to", "to-node-row", "gather-to", "from", "from-n0"])
def test_kernel_dataflow_matches_the_plain_bf16_chain(lmax, mmax, c, form):
    """The emulated kernel against _edge_rotate_bf16_reference (through the
    wrapper's plain versions), within one bf16 ulp of max + 1e-5."""
    (x, src, direction, n_sel), gamma, beta = _rotate_case(91, lmax, mmax, form, c)
    got = emulate_rotate_bf16(x, src, gamma, beta, lmax, mmax, n_sel, direction)
    if src is not None:
        want = kernels.eqv2_gather_rotate_to_reference(x, src, gamma, beta, lmax, mmax, n_sel=n_sel)
    else:
        want = kernels.eqv2_edge_rotate_reference(x, gamma, beta, lmax, mmax, direction=direction, n_sel=n_sel)
    assert got.shape == want.shape and got.dtype == want.dtype == BF16
    _within_one_ulp(got, want)


@pytest.mark.parametrize("lmax,c,e", [(4, 128, 25_600), (4, 128, 19_200), (2, 16, 37), (2, 16, 231), (6, 1, 5),
                                      (4, 33, 100), (5, 5, 1000)])
def test_rotate_bf16_plan_fits_one_block(lmax, c, e):
    """At the eqv2_so3.yml widths (C 128, lmax 4: 56,384 bytes, 264 blocks,
    two an SM), at phase 25's ragged TINY widths and at the widest table
    (C 1, lmax 6: 32 edges a tile), the plan fits one block and takes one
    block per 8 tiles up to two an SM (the kernel's launch bound)."""
    p = kernels.rotate_bf16_layout(lmax, 2, so3.n_act_rows(lmax, 2), "to").p
    plan = kernels.rotate_bf16_plan(e, c, p, 132, aligned=c % 32 == 0)
    assert plan.smem_bytes <= SMEM_PER_BLOCK and plan.threads == 256 and plan.tile == 256
    per_sm = min(2, 233472 // (plan.smem_bytes + 1024))
    tiles = -(-e * c // 32)
    assert plan.blocks == min(-(-tiles // 8), per_sm * 132)
    if (lmax, c, e) == (4, 128, 25_600):
        assert (plan.smem_bytes, plan.blocks) == (56_384, 264)


@pytest.mark.parametrize("nc,c,m", [(5, 3, 1), (9, 16, 37), (19, 64, 19_200), (19, 5, 129), (25, 9, 41), (32, 16, 111)])
def test_s2_bf16_bwd_plan_fits_two_blocks_an_sm(nc, c, m):
    """The backward's plan: the forward's tables and two tiles a warp (X^T
    and dY^T), two blocks an SM; at the training shape h [12,80,20,19,64]
    76,160 bytes and 264 blocks."""
    plan = kernels.s2_grid_silu_bf16_plan(m, nc, c, 324, 132, tiles=2)
    fwd = kernels.s2_grid_silu_bf16_plan(m, nc, c, 324, 132)
    ks = kernels.s2_bf16_layout(nc, 324)[0]
    assert plan.smem_bytes == fwd.smem_bytes + 8 * ks * 16 * 64
    assert plan.threads == 256 and 2 * (plan.smem_bytes + 1024) <= 233472
    assert plan.blocks == min(-(-m * c // 256), 264)
    if (nc, c, m) == (19, 64, 19_200):
        assert (plan.smem_bytes, plan.blocks) == (76_160, 264)


def test_bf16_plans_refuse_what_they_cannot_take():
    """lmax 7 and NC 33: ValueError from the layouts, before any launch."""
    with pytest.raises(ValueError, match="lmax <= 6"):
        kernels.rotate_bf16_layout(7, 2, 20, "to")
    with pytest.raises(ValueError, match="lmax <= 6"):
        kernels.rotate_bf16_layout(0, 0, 1, "from")
    with pytest.raises(ValueError, match="NC <= 32"):
        kernels.s2_grid_silu_bf16_plan(100, 33, 16, 324, 132, tiles=2)
