"""PyTorch port in bf16 (``compute_dtype: bfloat16``): the bf16 plain
versions of EquiformerV2's four kernels against the JAX package's Pallas
kernels on the CPU.

Inputs come from seeded numpy, rounded to bf16 once (the same values on both
sides); weights from the JAX package's init through
``eqv2_state_dict_from_jax``.  JAX runs its Pallas kernels in interpret mode
(``use_pallas``, ``use_pallas_conv1`` and ``use_pallas_rotate``: the kernel
forms, which the port's model always runs), patched as
``tests/test_torch_equiformer_v2.py`` patches them.

Tolerances:
- a kernel's plain version against the TPU kernel: 1e-3 * max|JAX| for f32
  outputs (conv1's weight and embedding gradients), 4e-3 * max|JAX| (one
  bf16 ulp of the largest element) for bf16 outputs.  Both round at the same
  points, and the sums are f32 in either; on these inputs the forwards agree
  bit for bit.  conv1's VJP differentiates ``_attn_conv1_ref`` (f32 weights
  and embeddings, where the forward kernel casts them to bf16), and a bf16
  piece that feeds two products gets two cotangents rounded apart before
  their bf16 sum, as JAX's;
- the model (``tests/test_torch_bf16_eqv2_model.py``) and the amp training
  step (``tests/test_torch_bf16_eqv2_train.py``) have files of their own:
  JAX compiles its bf16 kernel forms in interpret mode for 40 s to 2 min.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adsorbdiff_tpu.ops.pallas_kernels as pk
from adsorbdiff_tpu_torch.ops import kernels
from tests.test_torch_kernels import CONV1_L4, CONV1_TINY, _conv1_inputs, _s2_tables, _torch_tree
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16
KERNEL_NAMES = ("s2_grid_silu", "eqv2_edge_rotate", "eqv2_gather_rotate_to", "eqv2_attn_conv1")
KERNEL_FORMS = dict(use_pallas=True, use_pallas_conv1=True, use_pallas_rotate=True)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _limit(t) -> float:
    """The gate of an output of dtype ``t``'s: 4e-3 for bf16, 1e-3 for f32."""
    return 4e-3 if t in (BF16, jnp.bfloat16) else 1e-3


def _bf16(rng, *shape):
    """A seeded normal array rounded to bf16: (torch bf16, the same values for JAX)."""
    t = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _interpret(monkeypatch):
    for name in KERNEL_NAMES:
        monkeypatch.setattr(pk, name, functools.partial(getattr(pk, name), interpret=True))


def _f32(a) -> np.ndarray:
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def test_bf16_s2_grid_silu_and_backward_match_jax_kernel():
    """Forward and VJP (a bf16 cotangent) against the Pallas kernels: bf16
    in, bf16 out, the tables rounded to bf16, silu(g) and dg silu'(g) rounded
    before their second products."""
    to_m, from_m = _s2_tables(2, 1, 16)
    rng = np.random.default_rng(50)
    h, jh = _bf16(rng, 3, 5, to_m.shape[1], 16)
    dy, jdy = _bf16(rng, *h.shape)
    fwd = functools.partial(pk.s2_grid_silu, to_grid_m=jnp.asarray(to_m), from_grid_m=jnp.asarray(from_m), tile_m=128,
                            interpret=True)
    want, vjp = jax.vjp(fwd, jh)
    want_dh = vjp(jdy)[0]
    tables = torch.from_numpy(to_m), torch.from_numpy(from_m)
    got = kernels.s2_grid_silu_reference(h, *tables)
    got_dh = kernels.s2_grid_silu_bwd_reference(h, dy, *tables)
    for g, w in ((got, want), (got_dh, want_dh)):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16 and g.shape == w.shape
        assert _rel(_f32(g), _f32(w)) <= _limit(g.dtype)
    # the autograd Function's backward is the plain backward on the CPU
    leaf = h.clone().requires_grad_()
    (dh,) = torch.autograd.grad(kernels.s2_grid_silu(leaf, *tables), leaf, dy)
    torch.testing.assert_close(dh, got_dh, rtol=0, atol=0)
    # a bf16 variant, not the f32 kernel on bf16 values
    assert _rel(_f32(got), kernels.s2_grid_silu_reference(h.float(), *tables).numpy()) > 1e-4


LMAX, MMAX, B, N, K, C = 2, 1, 2, 6, 5, 16


def _rotation_inputs(seed):
    rng = np.random.default_rng(seed)
    x, jx = _bf16(rng, B, N, (LMAX + 1) ** 2, C)  # node rows
    xe, jxe = _bf16(rng, B, N, K, (LMAX + 1) ** 2, C)  # edge rows
    v, jv = _bf16(rng, B, N, K, 7, C)
    src = rng.integers(0, N, (B, N, K)).astype(np.int32)
    gamma = rng.uniform(-np.pi, np.pi, (B, N, K)).astype(np.float32)
    beta = rng.uniform(0, np.pi, (B, N, K)).astype(np.float32)
    torch_in = dict(x=x, xe=xe, v=v, src=torch.from_numpy(src), gamma=torch.from_numpy(gamma),
                    beta=torch.from_numpy(beta))
    jax_in = dict(x=jx, xe=jxe, v=jv, src=jnp.asarray(src), gamma=jnp.asarray(gamma), beta=jnp.asarray(beta))
    return torch_in, jax_in


def _rotation(form, rotate, gather, a, **kw):
    """(input name, x -> the rotation of ``form``) with the package's
    ``rotate``/``gather`` functions on the angles and sources of ``a``."""
    g, b = a["gamma"], a["beta"]
    return {
        "to": ("xe", lambda x: rotate(x, g, b, LMAX, MMAX, direction="to", **kw)),
        "to-node-row": ("x", lambda x: rotate(x[:, :, None], g, b, LMAX, MMAX, direction="to", **kw)),
        "from": ("v", lambda x: rotate(x, g, b, LMAX, MMAX, direction="from", n_sel=7, **kw)),
        "gather-to": ("x", lambda x: gather(x, a["src"], g, b, LMAX, MMAX, **kw)),
    }[form]


@pytest.mark.parametrize("form", ["to", "to-node-row", "from", "gather-to"])
def test_bf16_rotation_matches_jax_kernel(form):
    """Each form against the Pallas kernel, then its VJP (the dual rotation,
    then the gather's scatter or the node row's sum over K, outside the
    kernel in both packages) against ``jax.vjp``; all bit for bit here.  The
    node row's K cotangent rows are summed in f32 and rounded once, which is
    held against JAX's per-edge VJP summed so; JAX's own VJP of the
    broadcast adds the K bf16 rows one by one on the CPU, each sum rounded
    (4.2e-3 * max from the f32 sum on this input; ROADMAP section C)."""
    t_in, j_in = _rotation_inputs(51)
    name, plain = _rotation(form, kernels.eqv2_edge_rotate_reference, kernels.eqv2_gather_rotate_to_reference, t_in)
    _, wrapper = _rotation(form, kernels.eqv2_edge_rotate, kernels.eqv2_gather_rotate_to, t_in)
    _, jax_fn = _rotation(form, pk.eqv2_edge_rotate, pk.eqv2_gather_rotate_to, j_in, interpret=True)
    want, vjp = jax.vjp(jax_fn, j_in[name])
    got = plain(t_in[name])
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16 and got.shape == want.shape
    assert _rel(_f32(got), _f32(want)) <= _limit(got.dtype)
    ct, jct = _bf16(np.random.default_rng(52), *got.shape)
    leaf = t_in[name].clone().requires_grad_()
    (dx,) = torch.autograd.grad(wrapper(leaf), leaf, ct)
    if form == "to-node-row":  # the per-edge VJP (the dual rotation), its K rows summed in f32
        _, edge_vjp = jax.vjp(_rotation("to", pk.eqv2_edge_rotate, None, j_in, interpret=True)[1],
                              jnp.broadcast_to(j_in["x"][:, :, None], j_in["xe"].shape))
        want_dx = jnp.sum(edge_vjp(jct)[0].astype(jnp.float32), axis=2).astype(jnp.bfloat16)
    else:
        want_dx = vjp(jct)[0]
    assert dx.dtype == BF16 and want_dx.dtype == jnp.bfloat16 and dx.shape == want_dx.shape
    assert _rel(_f32(dx), _f32(want_dx)) <= _limit(dx.dtype)
    np.testing.assert_array_equal(_f32(dx), _f32(want_dx))
    # a bf16 variant, not the f32 chain on bf16 values
    f32 = plain(t_in[name].float())
    assert f32.dtype == torch.float32 and _rel(_f32(got), f32.numpy()) > 1e-4


@pytest.mark.parametrize("case", [CONV1_TINY, CONV1_L4], ids=["tiny-l2m1", "l4m2"])
def test_bf16_attn_conv1_and_vjp_match_jax_kernel(case):
    """conv1 with bf16 messages against the Pallas kernel (bf16 outputs), and
    its VJP against ``_attn_conv1_bwd`` for the embeddings (f32), both
    message halves (bf16) and every weight (f32)."""
    edges, rad, conv, kw = _conv1_inputs(53, *case)
    rng = np.random.default_rng(54)
    msgs = {k: _bf16(rng, *edges[k].shape) for k in ("msg_s", "msg_t")}
    jtree = lambda t: {k: jtree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in t.items()}  # noqa: E731
    j_fixed = [jnp.asarray(edges[k]) for k in ("dist", "mask")]

    def jax_fn(es, et, ms, mt, rad_t, conv_t):
        return pk.eqv2_attn_conv1(*j_fixed, es, et, ms, mt, rad_t, conv_t, **kw, interpret=True)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(edges["emb_s"]), jnp.asarray(edges["emb_t"]), msgs["msg_s"][1],
                        msgs["msg_t"][1], jtree(rad), jtree(conv))
    cts = [_bf16(rng, *w.shape) for w in want]
    want_grads = vjp(tuple(c[1] for c in cts))
    t_fixed = [torch.from_numpy(edges[k]) for k in ("dist", "mask")]
    leaves = [torch.from_numpy(edges["emb_s"]).requires_grad_(), torch.from_numpy(edges["emb_t"]).requires_grad_(),
              msgs["msg_s"][0].clone().requires_grad_(), msgs["msg_t"][0].clone().requires_grad_()]
    trees = [_torch_tree(rad), _torch_tree(conv)]
    for tree in trees:
        for mod in tree.values():
            for t in mod.values():
                t.requires_grad_()
    got = kernels.eqv2_attn_conv1(*t_fixed, *leaves, *trees, **kw)
    plain = kernels.eqv2_attn_conv1_reference(*t_fixed, *(t.detach() for t in leaves), *trees, **kw)
    for g, p, w in zip(got, plain, want):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16 and g.shape == w.shape
        torch.testing.assert_close(g, p, rtol=0, atol=0)
        assert _rel(_f32(g), _f32(w)) <= _limit(g.dtype)
    weights = [t for tree in trees for mod in tree.values() for t in mod.values()]
    grads = torch.autograd.grad(got, leaves + weights, [c[0] for c in cts])
    want_flat = list(want_grads[:4]) + [want_grads[4 + i][m][k] for i, tree in enumerate((rad, conv)) for m in tree
                                        for k in tree[m]]
    names = ["emb_s", "emb_t", "msg_s", "msg_t"] + [f"{m}.{k}" for tree in (rad, conv) for m in tree for k in tree[m]]
    for name, g, w in zip(names, grads, want_flat):
        assert g.dtype == {jnp.bfloat16: BF16, jnp.float32: torch.float32}[w.dtype.type], name
        assert _rel(_f32(g), _f32(w)) <= _limit(g.dtype), name
    # the kernel form rounds the weights and embeddings: the VJP's f32 form is another function
    ref = kernels._attn_conv1_reference(*t_fixed, *(t.detach() for t in leaves), *trees, **kw, width_scalar=2.0,
                                        kernel_form=False)
    assert max(_rel(_f32(r), _f32(p)) for r, p in zip(ref, plain)) > 1e-3


def test_bf16_wrappers_on_cpu_and_dtype_rules():
    """On the CPU each wrapper runs its plain version and counts no launch;
    a dtype no variant takes raises ``TypeError``."""
    to_m, from_m = (torch.from_numpy(t) for t in _s2_tables(2, 1, 16))
    h, _ = _bf16(np.random.default_rng(55), 2, 3, to_m.shape[1], 8)
    t_in, _ = _rotation_inputs(56)
    edges, rad, conv, kw = _conv1_inputs(57, *CONV1_TINY)
    args = [torch.from_numpy(edges[k]) for k in edges]
    args[4], args[5] = args[4].to(BF16), args[5].to(BF16)
    before = dict(kernels.launches)
    torch.testing.assert_close(kernels.s2_grid_silu(h, to_m, from_m), kernels.s2_grid_silu_reference(h, to_m, from_m),
                               rtol=0, atol=0)
    rot = (t_in["v"], t_in["gamma"], t_in["beta"], LMAX, MMAX)
    torch.testing.assert_close(kernels.eqv2_edge_rotate(*rot, direction="from", n_sel=7),
                               kernels.eqv2_edge_rotate_reference(*rot, direction="from", n_sel=7), rtol=0, atol=0)
    for g, w in zip(kernels.eqv2_attn_conv1(*args, _torch_tree(rad), _torch_tree(conv), **kw),
                    kernels.eqv2_attn_conv1_reference(*args, _torch_tree(rad), _torch_tree(conv), **kw)):
        assert g.dtype == BF16
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert dict(kernels.launches) == before
    with pytest.raises(TypeError, match="f32 or bf16"):
        kernels.s2_grid_silu(h.half(), to_m, from_m)
    with pytest.raises(TypeError, match="f32 or bf16"):
        kernels.eqv2_edge_rotate(t_in["v"].half(), *rot[1:], direction="from", n_sel=7)
    with pytest.raises(TypeError, match="both"):
        kernels.eqv2_attn_conv1(*args[:5], args[5].float(), _torch_tree(rad), _torch_tree(conv), **kw)
