"""Hopper kernels of the port and their plain PyTorch versions.

Counterpart of :mod:`adsorbdiff_tpu.ops.pallas_kernels`.  Each kernel has:

- a wrapper with the JAX function's name and signature, which checks its
  inputs, allocates the outputs and, on a CUDA tensor, launches the kernel
  (built from ``csrc/`` on first use) or raises.  On a CPU tensor it calls the
  plain version: that is the only way the plain version is reached;
- a plain PyTorch version (``*_reference``) with the same signature (less
  the consumers' ``ti``, which sets only the launch), for the CPU tests and for
  holding the kernel against on the card;
- a launch count in :data:`launches`, raised by one where the wrapper
  launches the kernel and nowhere else.

A kernel with a backward is wrapped in a ``torch.autograd.Function``
(:class:`PainnMessageFused`, :class:`S2GridSilu`, :class:`EqV2AttnConv1`,
:class:`EqV2EdgeRotate`), which the forward wrapper routes through only when
autograd needs a gradient.  On CPU tensors a Function's forward and backward
are the plain versions, so the CPU tests reach its backward too.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from adsorbdiff_tpu_torch.models import so3
from adsorbdiff_tpu_torch.ops import build

# kernel name -> launches in this process; reset with ``launches.clear()``
launches: "collections.Counter[str]" = collections.Counter()


def message_basis(dist: torch.Tensor, r: int, cutoff: float, envelope_exponent: int) -> torch.Tensor:
    """Gaussian radial basis x polynomial envelope ``[..., R]`` of the
    message kernels, from the raw distances.  In r it is a unit-width
    gaussian around ``d / cutoff * (R - 1)``, so at most 29 of the R values
    per edge are not exactly 0 in f32; the kernels skip the rest."""
    d = dist.float() * (1.0 / cutoff)
    p = float(envelope_exponent)
    env = 1 + (-(p + 1) * (p + 2) / 2) * d**p + p * (p + 2) * d ** (p + 1) + (-p * (p + 1) / 2) * d ** (p + 2)
    env = torch.where(d < 1.0, env, torch.zeros_like(env))
    offsets = torch.arange(r, device=d.device, dtype=torch.float32) / (r - 1)
    return torch.exp(-0.5 * (r - 1) ** 2 * (d[..., None] - offsets) ** 2) * env[..., None]


def fused_rbf_filter_reference(
    dist: torch.Tensor,  # [..., K]
    mask: torch.Tensor,  # [..., K] bool
    weights: torch.Tensor,  # [R, F]
    bias: torch.Tensor,  # [F]
    *,
    cutoff: float,
    envelope_exponent: int = 5,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_rbf_filter`: the masked edge
    filters ``(basis @ W + b) * mask`` ``[..., K, F]``, with the whole
    ``[..., K, R]`` basis materialised.  It is also the filter of the plain
    message versions."""
    basis = message_basis(dist, weights.shape[0], cutoff, envelope_exponent)
    return (basis @ weights.float() + bias.float()) * mask[..., None].float()


def painn_message_consumer_reference(
    dist: torch.Tensor,  # [..., K]
    mask: torch.Tensor,  # [..., K] bool
    unit: torch.Tensor,  # [..., K, 3]
    xh_gathered: torch.Tensor,  # [..., K, 3H]
    vec_gathered: torch.Tensor,  # [..., K, 3H] (vec [..., K, 3, H] flattened)
    weights: torch.Tensor,  # [R, 3H]
    bias: torch.Tensor,  # [3H]
    *,
    cutoff: float,
    envelope_exponent: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`painn_message_consumer` (and of its
    tiled form): ``(dx [..., H], dvec [..., 3, H])``, with the whole
    ``[..., K, 3H]`` filter materialised."""
    h = weights.shape[1] // 3
    filt = fused_rbf_filter_reference(dist, mask, weights, bias, cutoff=cutoff, envelope_exponent=envelope_exponent)
    g = xh_gathered.float() * filt
    g1, g2, g3 = g[..., :h], g[..., h : 2 * h] * (1.0 / math.sqrt(3.0)), g[..., 2 * h :]
    dx = torch.sum(g1, dim=-2)
    dvec = torch.einsum("...kd,...kh->...dh", unit.float(), g3) + torch.sum(
        vec_gathered.float().unflatten(-1, (3, h)) * g2[..., None, :], dim=-3
    )
    return dx, dvec


def painn_message_fused_reference(
    xh: torch.Tensor,  # [B, N, 3H]
    vec: torch.Tensor,  # [B, N, 3H] (vec [B, N, 3, H] flattened)
    src: torch.Tensor,  # [B, N, K] int
    dist: torch.Tensor,  # [B, N, K]
    mask: torch.Tensor,  # [B, N, K] bool
    unit: torch.Tensor,  # [B, N, K, 3]
    weight: torch.Tensor,  # [R, 3H]
    bias: torch.Tensor,  # [3H]
    *,
    cutoff: float,
    envelope_exponent: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`painn_message_fused`: the gather, then
    :func:`painn_message_consumer_reference` (the whole ``[B, N, K, 3H]``
    filter and gathered features are materialised)."""
    b, n, k = src.shape
    f3 = weight.shape[1]
    idx = src.reshape(b, n * k, 1).long().expand(-1, -1, f3)
    xh_g = torch.gather(xh.float(), 1, idx).reshape(b, n, k, f3)
    vec_g = torch.gather(vec.float(), 1, idx).reshape(b, n, k, f3)
    return painn_message_consumer_reference(dist, mask, unit, xh_g, vec_g, weight, bias, cutoff=cutoff,
                                            envelope_exponent=envelope_exponent)


def painn_message_fused_bwd_reference(
    xh: torch.Tensor,  # [B, N, 3H]
    vec: torch.Tensor,  # [B, N, 3H]
    src: torch.Tensor,  # [B, N, K] int
    dist: torch.Tensor,  # [B, N, K]
    mask: torch.Tensor,  # [B, N, K] bool
    unit: torch.Tensor,  # [B, N, K, 3]
    weight: torch.Tensor,  # [R, 3H]
    bias: torch.Tensor,  # [3H]
    dx_ct: torch.Tensor,  # [B, N, H] cotangent of dx
    dvec_ct: torch.Tensor,  # [B, N, 3, H] cotangent of dvec
    *,
    cutoff: float,
    envelope_exponent: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`painn_message_fused_bwd`, written out
    from the VJP formulas of the TPU kernel (``_painn_message_fused_bwd_kernel``),
    not by autograd.  Returns ``(dxh [B, N, 3H], dvec [B, N, 3H], dW [R, 3H],
    db [3H])``; the ``[B, N, K, 3H]`` edge tensors are materialised."""
    b, n, k = src.shape
    r, f3 = weight.shape
    h = f3 // 3
    inv_sqrt3 = 1.0 / math.sqrt(3.0)
    basis = message_basis(dist, r, cutoff, envelope_exponent)  # [B, N, K, R]
    m = mask[..., None].float()
    filt = (basis @ weight.float() + bias.float()) * m  # [B, N, K, 3H]
    idx = src.reshape(b, n * k, 1).long().expand(-1, -1, f3)
    xh_g = torch.gather(xh.float(), 1, idx).reshape(b, n, k, f3)
    vec_g = torch.gather(vec.float(), 1, idx).reshape(b, n, k, 3, h)
    gdv = dvec_ct.float().reshape(b, n, 1, 3, h)  # target cotangent, broadcast over K
    ghat = torch.cat([
        dx_ct.float()[:, :, None, :].expand(b, n, k, h),
        inv_sqrt3 * torch.sum(vec_g * gdv, dim=3),
        torch.einsum("bnkd,bnkdh->bnkh", unit.float(), gdv.expand(b, n, k, 3, h)),
    ], dim=-1)  # [B, N, K, 3H] cotangent of the gathered-times-filter product
    g2 = xh_g[..., h : 2 * h] * filt[..., h : 2 * h] * inv_sqrt3
    dvec_g = (g2[..., None, :] * gdv).reshape(b, n * k, f3)
    dxh_g = (ghat * filt).reshape(b, n * k, f3)
    dfil = ghat * xh_g * m  # cotangent of basis @ W + b
    dxh = torch.zeros((b, n, f3), dtype=torch.float32, device=xh.device).scatter_add_(1, idx, dxh_g)
    dvec = torch.zeros((b, n, f3), dtype=torch.float32, device=xh.device).scatter_add_(1, idx, dvec_g)
    dw = basis.reshape(-1, r).t() @ dfil.reshape(-1, f3)
    db = dfil.reshape(-1, f3).sum(0)
    return dxh, dvec, dw, db


def _library(name: str, argtypes) -> ctypes.CDLL:
    """Kernel ``name``'s library, built on first use; its C entry point is
    ``<name>_f32(..., stream)`` returning a cudaError code, and
    ``<name>_error_string(code)`` names the code."""
    lib = build.load(name)
    fn = getattr(lib, name + "_f32")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        msg = getattr(lib, name + "_error_string")
        msg.argtypes = [ctypes.c_int]
        msg.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(kernel: str, tensors: dict, dtypes: dict) -> None:
    """Raise unless every tensor is a contiguous tensor of ``dtypes`` (f32
    where unnamed) on the first tensor's CUDA device, and none needs a
    gradient (a kernel with a backward is called from its autograd Function,
    whose forward runs with autograd off)."""
    device = next(iter(tensors.values())).device
    if device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {device}")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        want = dtypes.get(name, torch.float32)
        if t.dtype != want:
            raise TypeError(f"{kernel}: {name} must be {want}, got {t.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise NotImplementedError(f"{kernel} has no backward kernel on CUDA yet")


def _check_shapes(kernel: str, tensors: dict, expected: dict) -> None:
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(tensors[name].shape)}, want {shape}")


def _launch(kernel: str, lib: ctypes.CDLL, device: torch.device, *args, count_as: Optional[str] = None,
            shape: Optional[str] = None) -> None:
    """Call ``<kernel>_f32(*args, stream)`` on the current stream of
    ``device``; raise on a non-zero cudaError (naming ``shape`` where given),
    else count the launch under ``count_as`` (default ``kernel``)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, kernel + "_f32")(*args, stream)
    if err != 0:
        msg = getattr(lib, kernel + "_error_string")(err).decode()
        raise RuntimeError(f"{kernel} launch failed{' at ' + shape if shape else ''}: {msg} (cudaError {err})")
    launches[count_as or kernel] += 1


def painn_message_fused(
    xh: torch.Tensor,
    vec: torch.Tensor,
    src: torch.Tensor,
    dist: torch.Tensor,
    mask: torch.Tensor,
    unit: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    cutoff: float,
    envelope_exponent: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused PaiNN message block: gather + radial filter + multiply +
    K-reduction + directional term (``csrc/painn_message_fused.cu``).

    Shapes as :func:`painn_message_fused_reference`; ``weight`` is ``[R, 3H]``
    (the transpose of a torch ``Linear(R, 3H).weight``).  Returns
    ``(dx [B, N, H] f32, dvec [B, N, 3, H] f32)`` before PaiNN's 1/sqrt(H)
    scale.  On the card: f32 only, contiguous inputs, ``src`` int32, ``mask``
    bool; the launch is :func:`painn_fwd_plan`'s.  When autograd needs a
    gradient the call goes through :class:`PainnMessageFused`, whose backward
    is :func:`painn_message_fused_bwd`; without one (sampling, ``no_grad``)
    it launches the forward kernel alone.
    """
    tensors = (xh, vec, src, dist, mask, unit, weight, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return PainnMessageFused.apply(*tensors, cutoff, envelope_exponent)
    return _painn_message_fused_forward(*tensors, cutoff=cutoff, envelope_exponent=envelope_exponent)


def _painn_message_fused_forward(
    xh, vec, src, dist, mask, unit, weight, bias, *, cutoff: float, envelope_exponent: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    if xh.device.type == "cpu":
        return painn_message_fused_reference(
            xh, vec, src, dist, mask, unit, weight, bias,
            cutoff=cutoff, envelope_exponent=envelope_exponent,
        )
    tensors = dict(xh=xh, vec=vec, src=src, dist=dist, mask=mask, unit=unit, weight=weight, bias=bias)
    _check_cuda_inputs("painn_message_fused", tensors, {"src": torch.int32, "mask": torch.bool})
    b, n, k, r, h = _message_shape("painn_message_fused", tensors)

    if b * n * h == 0:  # empty output: nothing to launch
        return xh.new_empty((b, n, h)), xh.new_empty((b, n, 3, h))
    if k == 0:  # no slots: the sums are empty
        return xh.new_zeros((b, n, h), dtype=torch.float32), xh.new_zeros((b, n, 3, h), dtype=torch.float32)
    plan = painn_fwd_plan(b, n, k, r, h, _sm_count(xh.device))
    dx = torch.empty((b, n, h), dtype=torch.float32, device=xh.device)
    dvec = torch.empty((b, n, 3, h), dtype=torch.float32, device=xh.device)
    lib = _library("painn_message_fused", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    _launch(
        "painn_message_fused", lib, xh.device,
        xh.data_ptr(), vec.data_ptr(), src.data_ptr(), dist.data_ptr(), mask.data_ptr(),
        unit.data_ptr(), weight.data_ptr(), bias.data_ptr(), dx.data_ptr(), dvec.data_ptr(),
        b, n, k, r, h, 1.0 / cutoff, int(envelope_exponent), plan.tpb, int(plan.stage_w), int(plan.stage_rows),
        plan.rows, plan.smem_bytes, shape=f"B, N, K, R, H = {b}, {n}, {k}, {r}, {h}",
    )
    return dx, dvec


# csrc/painn_message_fused.cu's constants: owners (half-warps) a block, columns h a block, basis rows a pass, slots
# a group; the floats of an owner's basis buffer and slot records and of the bias columns, and the most dynamic shared
# memory a block may take (the kernel has no static shared memory); the H100's schedulers an SM
_PF_OWNERS, _PF_COLS, _PF_WIN, _PF_GROUP = 32, 32, 48, 8
_PF_FIXED = 4 * (_PF_OWNERS * (_PF_WIN * _PF_GROUP + 8 + 4 * (_PF_GROUP + 1)) + 3 * _PF_COLS)
_PF_SMEM, _PF_SCHEDULERS = 232448, 4


class MessageFwdPlan(NamedTuple):
    """How :func:`painn_message_fused` is launched: block ``(x, y)`` of the
    grid takes targets ``[x * tpb, (x + 1) * tpb)`` of the ``B * N`` (any
    systems) and the 32 columns ``y * 32 ..`` (with their H + h and 2H + h);
    ``blocks`` = target ranges x ``slices`` of ``threads`` threads, one an
    SM; ``stage_w``: the block's W columns copied to shared memory (else
    read through L1/L2); ``stage_rows``: the xh/vec rows of every system its
    targets lie in too, ``rows`` of them at most; ``smem_bytes`` a block;
    ``waves`` = blocks / SMs; ``load``: targets a scheduler of a full block
    takes one after another (the plan's cost is ``ceil(waves) * load``)."""

    tpb: int
    slices: int
    blocks: int
    threads: int
    stage_w: bool
    stage_rows: bool
    rows: int
    smem_bytes: int
    waves: float
    load: int


def _message_fwd_smem(r: int, rows: int, stage_w: bool, stage_rows: bool) -> int:
    """The forward kernel's dynamic shared bytes: the owners' basis buffers
    and slot records and the bias columns, the W columns (``stage_w``) and
    the xh and vec rows of ``rows`` rows (``stage_rows``)."""
    return _PF_FIXED + 4 * (3 * r * _PF_COLS * stage_w + 6 * rows * _PF_COLS * stage_rows)


def _fwd_staged_rows(t: int, n: int, tpb: int) -> int:
    """The most rows of whole systems a block's targets lie in (the kernel's
    ``staged_rows``): the first ``n`` blocks show every offset of a block in
    its system."""
    most = 0
    for x in range(min(_cdiv(t, tpb), n)):
        t0, t1 = x * tpb, min(t, (x + 1) * tpb)
        most = max(most, ((t1 - 1) // n + 1) * n - t0 // n * n)
    return most


def _fwd_load(tpb: int) -> int:
    """Targets the busiest scheduler of a block of ``tpb`` targets takes one
    after another: owner ``o`` (half-warp ``o // 16`` of warp ``o % 16``)
    takes targets ``o, o + 32, ..``; a warp runs as long as its busier
    owner, and warp ``w`` issues on scheduler ``w % 4``.  With ``tpb = 32m
    + q``, warps ``w < q`` hold m + 1 targets (all 16 once q > 16), so the
    busiest scheduler, the first, takes ``4m + min(4, ceil(q / 4))``."""
    m, q = divmod(tpb, _PF_OWNERS)
    return _PF_SCHEDULERS * m + min(_PF_SCHEDULERS, _cdiv(q, 4))


@functools.lru_cache(maxsize=64)
def painn_fwd_plan(b: int, n: int, k: int, r: int, h: int, sms: int) -> MessageFwdPlan:
    """``csrc/painn_message_fused.cu``'s launch for ``b`` systems of ``n``
    targets, ``k`` slots, ``r`` radial functions and ``h`` columns on a card
    of ``sms`` SMs.  The target range ``tpb`` minimises ``ceil(waves) *
    load`` (ties: staged rows, then fewer blocks): it narrows while too few
    blocks fill a wave, and at N = 80 takes two whole systems (160 targets,
    5 a half-warp).  W's columns are staged where they fit (R <= 461), the
    systems' xh/vec rows where they fit beside W (at R = 128: 166 rows, two
    systems of N <= 83 or one of N <= 166).  Refuses nothing with ``k >=
    1``, ``r >= 2`` and ``h`` up to 65535 x 32 columns."""
    if k < 1 or r < 2 or _cdiv(h, _PF_COLS) > 65535:
        raise ValueError(f"painn_message_fused: no launch for B, N, K, R, H = {b}, {n}, {k}, {r}, {h} (the kernel "
                         f"takes K >= 1, R >= 2 and H <= {65535 * _PF_COLS})")
    t, slices = b * n, _cdiv(h, _PF_COLS)
    stage_w = _message_fwd_smem(r, 0, True, False) <= _PF_SMEM
    room = _PF_SMEM - _message_fwd_smem(r, 0, stage_w, False)  # for the staged rows
    best = None
    # the load is 4m + j for tpb in (32m + 4j - 4, 32m + 4j] (j <= 4), else 4m + 4: the widest tpb of each load
    steps = [m + q for m in range(_PF_OWNERS, t, _PF_OWNERS) for q in (4, 8, 12, 16, _PF_OWNERS)]
    for tpb in sorted({x for x in steps if x < t} | set(range(1, min(t, _PF_OWNERS) + 1)) | {t}):
        blocks = _cdiv(t, tpb) * slices
        load = _fwd_load(tpb)
        cost = _cdiv(blocks, sms) * load
        rows = _fwd_staged_rows(t, n, tpb) if _cdiv(tpb, n) * n * 6 * _PF_COLS * 4 <= room else 0
        stage_rows = 0 < rows and rows * 6 * _PF_COLS * 4 <= room
        key = (cost, not stage_rows, blocks)
        if best is None or key < best[0]:
            best = key, tpb, blocks, load, stage_rows, rows if stage_rows else 0
    _, tpb, blocks, load, stage_rows, rows = best
    return MessageFwdPlan(tpb=tpb, slices=slices, blocks=blocks, threads=32 * _PF_OWNERS // 2, stage_w=stage_w,
                          stage_rows=stage_rows, rows=rows,
                          smem_bytes=_message_fwd_smem(r, rows, stage_w, stage_rows), waves=blocks / sms, load=load)


def painn_fwd_windows(dist: torch.Tensor, mask: torch.Tensor, src: torch.Tensor, r: int,
                      cutoff: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's window rule, in Python: ``(lo, hi)`` ``[B, N,
    G]`` (G = ceil(K / 8)), the basis rows the kernel runs for each group of
    8 consecutive slots of a target: the union of ``[bin - 14, bin + 15]``
    (cut to ``[0, R)``) over its valid slots (mask set, source in ``[0,
    N)``) before the cutoff, ``bin = floor(dist * (1 / cutoff) * (R - 1))``
    in f32; ``hi < lo`` where no such slot."""
    b, n, k = dist.shape
    g = _cdiv(k, _PF_GROUP)
    d = dist.float() * (1.0 / cutoff)
    reach = mask & (src >= 0) & (src < n) & (d < 1.0)
    bins = torch.clamp((d * float(r - 1)).to(torch.int32), max=r - 1)
    pad = g * _PF_GROUP - k
    reach = torch.nn.functional.pad(reach, (0, pad)).reshape(b, n, g, _PF_GROUP)
    bins = torch.nn.functional.pad(bins, (0, pad)).reshape(b, n, g, _PF_GROUP)
    lo = torch.where(reach, torch.clamp(bins - 14, min=0), torch.full_like(bins, r)).amin(-1)
    hi = torch.where(reach, torch.clamp(bins + 15, max=r - 1), torch.full_like(bins, -1)).amax(-1)
    return lo, hi


def _message_shape(kernel: str, tensors: dict) -> Tuple[int, int, int, int, int]:
    """``(B, N, K, R, H)`` of the message kernels' inputs, or raise."""
    src, weight = tensors["src"], tensors["weight"]
    if src.dim() != 3:
        raise ValueError(f"{kernel}: src must be [B, N, K], got {tuple(src.shape)}")
    b, n, k = src.shape
    r, f3 = _filter_weights(kernel, weight)
    _check_shapes(kernel, tensors, dict(
        xh=(b, n, f3), vec=(b, n, f3), dist=(b, n, k), mask=(b, n, k), unit=(b, n, k, 3), bias=(f3,)))
    return b, n, k, r, f3 // 3


def painn_message_fused_bwd(
    xh: torch.Tensor,
    vec: torch.Tensor,
    src: torch.Tensor,
    dist: torch.Tensor,
    mask: torch.Tensor,
    unit: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    dx_ct: torch.Tensor,
    dvec_ct: torch.Tensor,
    *,
    cutoff: float,
    envelope_exponent: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """VJP of :func:`painn_message_fused` with respect to ``xh``, ``vec``,
    ``weight`` and ``bias`` (``csrc/painn_message_fused_bwd.cu``): the filter
    and the gathers are recomputed, the cotangents scattered to source rows.

    Inputs as :func:`painn_message_fused` plus the cotangents ``dx_ct
    [B, N, H]`` and ``dvec_ct [B, N, 3, H]``.  Returns ``(dxh [B, N, 3H],
    dvec [B, N, 3H], dW [R, 3H], db [3H])``, f32.  On the card: the forward's
    input rules, f32 contiguous cotangents and R <= 128; the launch is
    :func:`painn_bwd_plan`'s.  The kernel adds with atomics, so the order of
    its f32 sums changes from run to run.
    """
    if xh.device.type == "cpu":
        return painn_message_fused_bwd_reference(
            xh, vec, src, dist, mask, unit, weight, bias, dx_ct, dvec_ct,
            cutoff=cutoff, envelope_exponent=envelope_exponent,
        )
    tensors = dict(xh=xh, vec=vec, src=src, dist=dist, mask=mask, unit=unit, weight=weight, bias=bias,
                   dx_ct=dx_ct, dvec_ct=dvec_ct)
    _check_cuda_inputs("painn_message_fused_bwd", tensors, {"src": torch.int32, "mask": torch.bool})
    b, n, k, r, h = _message_shape("painn_message_fused_bwd", tensors)
    _check_shapes("painn_message_fused_bwd", tensors, dict(dx_ct=(b, n, h), dvec_ct=(b, n, 3, h)))
    if r > 128:
        raise ValueError(f"painn_message_fused_bwd: the kernel holds R <= 128 radial functions, got {r}")

    f3 = 3 * h
    dw = torch.zeros((r, f3), dtype=torch.float32, device=xh.device)
    db = torch.zeros((f3,), dtype=torch.float32, device=xh.device)
    if b * n * k * h == 0:  # nothing to add: zero gradients, no launch
        return (torch.zeros((b, n, f3), dtype=torch.float32, device=xh.device),
                torch.zeros((b, n, f3), dtype=torch.float32, device=xh.device), dw, db)
    plan = painn_bwd_plan(b, n, k, r, h, _sm_count(xh.device))
    # the kernel writes every element of dxh and dvec, except where it scatters with global atomics
    new = torch.zeros if plan.global_scatter else torch.empty
    dxh = new((b, n, f3), dtype=torch.float32, device=xh.device)
    dvec = new((b, n, f3), dtype=torch.float32, device=xh.device)
    scratch = torch.empty((plan.scratch_ints,), dtype=torch.int32, device=xh.device)
    lib = _library("painn_message_fused_bwd", [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    _launch(
        "painn_message_fused_bwd", lib, xh.device,
        xh.data_ptr(), vec.data_ptr(), src.data_ptr(), dist.data_ptr(), mask.data_ptr(), unit.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), dx_ct.data_ptr(), dvec_ct.data_ptr(),
        dxh.data_ptr(), dvec.data_ptr(), dw.data_ptr(), db.data_ptr(), scratch.data_ptr(),
        b, n, k, r, h, 1.0 / cutoff, int(envelope_exponent), plan.cols, int(plan.stage_rows),
        int(plan.global_scatter), plan.smem_bytes,
    )
    return dxh, dvec, dw, db


# csrc/painn_message_fused_bwd.cu's constants: warps a block (each owns some of the system's sources; one block an
# SM), floats of a warp's basis buffer (up to 16 edges x 40 rows, row stride 20), the column widths a block may
# take, widest first; the most dynamic shared memory a block may take beside the kernel's static 5,120 bytes (the
# tiles' edges)
_PB_WARPS, _PB_WARP_BUF, _PB_COLS = 16, 40 * 20, (32, 16, 8)
_PB_SMEM = 232448 - 16 * 16 * 5 * 4


class MessageBwdPlan(NamedTuple):
    """How :func:`painn_message_fused_bwd` is launched: ``cols`` feature
    columns h a block (each with its H + h and 2H + h), ``slices`` column
    slices a system, ``blocks`` = systems x slices of ``threads`` threads,
    one an SM; ``global_scatter``: dxh and dvec added with global atomics
    (else accumulated in shared memory and written once); ``stage_rows``: the
    system's xh and vec rows at the block's columns copied to shared memory
    (else read through L1/L2); ``smem_bytes`` a block, ``scratch_ints``
    int32s of scratch (the sorted slots and each warp's stream bounds), and
    ``waves`` = blocks / SMs."""

    cols: int
    slices: int
    blocks: int
    threads: int
    global_scatter: bool
    stage_rows: bool
    smem_bytes: int
    scratch_ints: int
    waves: float


def _message_bwd_smem(n: int, r: int, cols: int, stage_rows: bool, global_scatter: bool) -> int:
    """The backward kernel's dynamic shared bytes: the warps' basis buffers,
    the block's W columns, the dxh/dvec accumulators (none with global
    atomics) and the staged xh/vec rows."""
    acc = 0 if global_scatter else 6 * n * cols
    rows = 6 * n * cols if stage_rows else 0
    return 4 * (_PB_WARPS * _PB_WARP_BUF + 3 * r * cols + acc + rows)


def painn_bwd_plan(b: int, n: int, k: int, r: int, h: int, sms: int) -> MessageBwdPlan:
    """``csrc/painn_message_fused_bwd.cu``'s launch for ``b`` systems of
    ``n`` rows on a card of ``sms`` SMs.  The column slice: the widest (32,
    16 or 8 columns h) whose grid fills one wave of one block an SM (8 when
    the systems are too few), narrowed further while the system's dxh/dvec
    accumulators do not fit one block's shared memory beside W and the tile
    buffers (at R = 128: 32 columns up to N = 165, 16 up to 394, 8 up to
    853); past that, the wave's width with global atomics for the scatter.
    The xh/vec rows are staged where they fit too (N <= 82 at 32 columns).
    Refuses nothing with ``2 <= r <= 128``."""
    if not 2 <= r <= 128:
        raise ValueError(f"painn_message_fused_bwd: the kernel holds 2 <= R <= 128 radial functions, got {r}")
    widest = next((c for c in _PB_COLS if b * _cdiv(h, c) >= sms), _PB_COLS[-1])
    fits = [c for c in _PB_COLS if c <= widest and _message_bwd_smem(n, r, c, False, False) <= _PB_SMEM]
    cols, glob = (fits[0], False) if fits else (widest, True)
    stage = not glob and _message_bwd_smem(n, r, cols, True, False) <= _PB_SMEM
    slices = _cdiv(h, cols)
    return MessageBwdPlan(cols=cols, slices=slices, blocks=b * slices, threads=32 * _PB_WARPS, global_scatter=glob,
                          stage_rows=stage, smem_bytes=_message_bwd_smem(n, r, cols, stage, glob),
                          scratch_ints=b * n * k + (_PB_WARPS + 1) * b, waves=b * slices / sms)


def painn_bwd_work(plan: MessageBwdPlan, b: int, h: int):
    """The backward kernel's blocks as ``(block, system, first column h,
    columns)``: block ``(x, y)`` of the grid takes system ``y`` and columns
    ``x * cols ..`` (and their H + h, 2H + h), the last slice cut at H."""
    for y in range(b):
        for x in range(plan.slices):
            yield y * plan.slices + x, y, x * plan.cols, min(plan.cols, h - x * plan.cols)


class PainnMessageFused(torch.autograd.Function):
    """:func:`painn_message_fused` with its backward kernel.

    Gradients flow to ``xh``, ``vec``, ``weight`` and ``bias``.  ``src``,
    ``dist``, ``mask`` and ``unit`` get none (``None``): the JAX contract
    (``adsorbdiff_tpu/ops/pallas_kernels.py::_painn_fused_bwd``), under which
    no loss differentiates through atom positions, so the geometry's
    cotangents are zero by construction.  On CPU tensors forward and
    backward are the plain versions.
    """

    @staticmethod
    def forward(ctx, xh, vec, src, dist, mask, unit, weight, bias, cutoff, envelope_exponent):
        ctx.save_for_backward(xh, vec, src, dist, mask, unit, weight, bias)
        ctx.cutoff, ctx.envelope_exponent = cutoff, envelope_exponent
        return _painn_message_fused_forward(
            xh, vec, src, dist, mask, unit, weight, bias, cutoff=cutoff, envelope_exponent=envelope_exponent)

    @staticmethod
    def backward(ctx, dx_ct, dvec_ct):
        xh, vec, src, dist, mask, unit, weight, bias = ctx.saved_tensors
        dxh, dvec, dw, db = painn_message_fused_bwd(
            xh, vec, src, dist, mask, unit, weight, bias, dx_ct.contiguous(), dvec_ct.contiguous(),
            cutoff=ctx.cutoff, envelope_exponent=ctx.envelope_exponent,
        )
        return (dxh.to(xh.dtype), dvec.to(vec.dtype), None, None, None, None,
                dw.to(weight.dtype), db.to(bias.dtype), None, None)


def painn_message_consumer(
    dist: torch.Tensor,
    mask: torch.Tensor,
    unit: torch.Tensor,
    xh_gathered: torch.Tensor,
    vec_gathered: torch.Tensor,
    weights: torch.Tensor,
    bias: torch.Tensor,
    *,
    cutoff: float,
    envelope_exponent: int = 5,
    ti: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PaiNN message on features gathered beforehand
    (``csrc/painn_message_consumer.cu``): radial filter, multiply,
    K-reduction and directional term, as :func:`painn_message_fused` computes
    them after its gather.

    ``dist``, ``mask`` ``[M, K]``, ``unit`` ``[M, K, 3]``, ``xh_gathered``,
    ``vec_gathered`` ``[M, K, 3H]``, ``weights`` ``[R, 3H]``, ``bias``
    ``[3H]``.  Returns ``(dx [M, H], dvec [M, 3, H])`` f32, before PaiNN's
    1/sqrt(H) scale.  ``ti`` targets per block (M need not be a multiple).
    On the card: f32 contiguous inputs, ``mask`` bool, no gradient (the JAX
    function has no VJP either).  No model calls it.
    """
    return _consumer("painn_message_consumer", dist, mask, unit, xh_gathered, vec_gathered, weights, bias,
                     cutoff, envelope_exponent, ti)


def painn_message_consumer_tiled(
    dist: torch.Tensor,
    mask: torch.Tensor,
    unit: torch.Tensor,
    xh_gathered: torch.Tensor,
    vec_gathered: torch.Tensor,
    weights: torch.Tensor,
    bias: torch.Tensor,
    *,
    cutoff: float,
    envelope_exponent: int = 5,
    ti: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`painn_message_consumer` with ``ti`` targets per block (default
    8), the counterpart of the JAX multi-target kernel; one source serves
    both, and its launches count under this name."""
    return _consumer("painn_message_consumer_tiled", dist, mask, unit, xh_gathered, vec_gathered, weights, bias,
                     cutoff, envelope_exponent, ti)


def _consumer(name, dist, mask, unit, xh_gathered, vec_gathered, weights, bias, cutoff, envelope_exponent, ti):
    if dist.device.type == "cpu":
        return painn_message_consumer_reference(dist, mask, unit, xh_gathered, vec_gathered, weights, bias,
                                                cutoff=cutoff, envelope_exponent=envelope_exponent)
    tensors = dict(dist=dist, mask=mask, unit=unit, xh_gathered=xh_gathered, vec_gathered=vec_gathered,
                   weights=weights, bias=bias)
    _check_cuda_inputs(name, tensors, {"mask": torch.bool})
    if dist.dim() != 2:
        raise ValueError(f"{name}: dist must be [M, K], got {tuple(dist.shape)}")
    m, k = dist.shape
    r, f3 = _filter_weights(name, weights)
    _check_shapes(name, tensors, dict(mask=(m, k), unit=(m, k, 3), xh_gathered=(m, k, f3), vec_gathered=(m, k, f3),
                                      bias=(f3,)))
    if int(ti) < 1:
        raise ValueError(f"{name}: ti must be >= 1, got {ti}")
    h = f3 // 3
    dx = torch.empty((m, h), dtype=torch.float32, device=dist.device)
    dvec = torch.empty((m, 3, h), dtype=torch.float32, device=dist.device)
    if m * h == 0:  # empty output: nothing to launch
        return dx, dvec
    lib = _library("painn_message_consumer",
                   [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    _launch(
        "painn_message_consumer", lib, dist.device,
        dist.data_ptr(), mask.data_ptr(), unit.data_ptr(), xh_gathered.data_ptr(), vec_gathered.data_ptr(),
        weights.data_ptr(), bias.data_ptr(), dx.data_ptr(), dvec.data_ptr(),
        m, k, r, h, int(ti), 1.0 / cutoff, int(envelope_exponent), count_as=name,
    )
    return dx, dvec


def _filter_weights(kernel: str, weights: torch.Tensor) -> Tuple[int, int]:
    """``(R, 3H)`` of a message kernel's filter weights, or raise."""
    if weights.dim() != 2 or weights.shape[0] < 2 or weights.shape[1] % 3:
        raise ValueError(f"{kernel}: weight must be [R>=2, 3H], got {tuple(weights.shape)}")
    return weights.shape[0], weights.shape[1]


def fused_rbf_filter(
    dist: torch.Tensor,
    mask: torch.Tensor,
    weights: torch.Tensor,
    bias: torch.Tensor,
    *,
    cutoff: float,
    envelope_exponent: int = 5,
) -> torch.Tensor:
    """Masked radial edge filters ``(gauss_rbf(d) * envelope(d)) @ W + b``
    (``csrc/fused_rbf_filter.cu``): a GEMM whose basis operand the kernel
    computes from ``dist`` and never stores.

    ``dist``, ``mask`` ``[..., K]`` (any lead dims), ``weights`` ``[R, F]``,
    ``bias`` ``[F]``; returns ``[..., K, F]`` f32, 0 on masked edges (bias
    included) and the bias on an unmasked edge beyond the cutoff.  The JAX
    wrapper's ``tile`` (its edge padding) has no counterpart: the kernel
    guards the ends instead of padding.  On the card: f32 contiguous inputs,
    ``mask`` bool, no gradient.  No model calls it.
    """
    if dist.device.type == "cpu":
        return fused_rbf_filter_reference(dist, mask, weights, bias, cutoff=cutoff,
                                          envelope_exponent=envelope_exponent)
    tensors = dict(dist=dist, mask=mask, weights=weights, bias=bias)
    _check_cuda_inputs("fused_rbf_filter", tensors, {"mask": torch.bool})
    if weights.dim() != 2 or weights.shape[0] < 2:
        raise ValueError(f"fused_rbf_filter: weights must be [R>=2, F], got {tuple(weights.shape)}")
    r, f = weights.shape
    _check_shapes("fused_rbf_filter", tensors, dict(mask=tuple(dist.shape), bias=(f,)))
    out = torch.empty(tuple(dist.shape) + (f,), dtype=torch.float32, device=dist.device)
    e = dist.numel()
    if e * f == 0:  # empty output: nothing to launch
        return out
    lib = _library("fused_rbf_filter", [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 2
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    _launch("fused_rbf_filter", lib, dist.device, dist.data_ptr(), mask.data_ptr(), weights.data_ptr(),
            bias.data_ptr(), out.data_ptr(), e, r, f, 1.0 / cutoff, int(envelope_exponent))
    return out


def gemnet_quad_chain_reference(
    n1: torch.Tensor,  # [B, N, U, Q, 3]
    n2: torch.Tensor,  # [B, N, Q, K2, 3]
    key1: torch.Tensor,  # [B, N, U] int
    key2: torch.Tensor,  # [B, N, Q, K2] int
    xm: torch.Tensor,  # [B, N, Q, K2, E]
    qp: torch.Tensor,  # [B, N, U, S, Q, F]
    num_spherical: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemnet_quad_chain` (the JAX
    ``_quad_chain_ref``): the Legendre table ``[B, N, U, Q, K2, S]`` and
    ``d2 [B, N, U, Q, S, E]`` are materialised."""
    cos = torch.clamp(torch.einsum("bnuqc,bnqkc->bnuqk", _unit_rows(n1), _unit_rows(n2)), -1.0, 1.0)
    k1 = key1[:, :, :, None, None]
    keep = (k1 != key2[:, :, None, :, :]) & (k1 >= 0)
    y = _masked_legendre(cos, keep, num_spherical, dim=-1)
    d2 = torch.einsum("bnuqks,bnqke->bnuqse", y, xm)
    return torch.einsum("bnusqf,bnuqse->bnufe", qp, d2)


def gemnet_quad_chain(
    n1: torch.Tensor,
    n2: torch.Tensor,
    key1: torch.Tensor,
    key2: torch.Tensor,
    xm: torch.Tensor,
    qp: torch.Tensor,
    num_spherical: int,
) -> torch.Tensor:
    """GemNet-OC's quadruplet consumer, fused: dihedral cosine, Legendre
    basis, c==d exclusion from the integer image keys, the K2 contraction
    against ``xm`` and the (S, Q) contraction against ``qp``, in one kernel
    (``csrc/gemnet_quad_chain.cu``).

    Shapes as :func:`gemnet_quad_chain_reference`; ``qp`` has the true U (no
    padding).  Returns ``outer [B, N, U, F, E]`` f32 for the qint bilinear.
    On the card: f32 tensors, int32 keys, contiguous, and no autograd (the
    backward comes with training); the launch is :func:`quad_chain_plan`'s.
    """
    if n1.device.type == "cpu":
        return gemnet_quad_chain_reference(n1, n2, key1, key2, xm, qp, num_spherical)
    tensors = dict(n1=n1, n2=n2, key1=key1, key2=key2, xm=xm, qp=qp)
    _check_cuda_inputs("gemnet_quad_chain", tensors, {"key1": torch.int32, "key2": torch.int32})
    if n1.dim() != 5 or xm.dim() != 5 or qp.dim() != 6:
        raise ValueError("gemnet_quad_chain: n1, xm and qp must be 5-, 5- and 6-dimensional")
    b, n, u, q, _ = n1.shape
    k2, e = xm.shape[3], xm.shape[4]
    s, f = num_spherical, qp.shape[-1]
    _check_shapes("gemnet_quad_chain", tensors, dict(
        n1=(b, n, u, q, 3), n2=(b, n, q, k2, 3), key1=(b, n, u), key2=(b, n, q, k2), xm=(b, n, q, k2, e),
        qp=(b, n, u, s, q, f)))

    if b * n * u * f * e == 0:  # empty output: nothing to launch
        return n1.new_empty((b, n, u, f, e))
    plan = quad_chain_plan(b * n, u, q, k2, s, e, f, _sm_count(n1.device), qp_aligned=qp.data_ptr() % 16 == 0)
    return _quad_chain_launch(tensors, s, plan)


def _quad_chain_launch(tensors: dict, s: int, plan: "QuadChainPlan") -> torch.Tensor:
    """Launch ``csrc/gemnet_quad_chain.cu`` with ``plan`` on checked inputs
    (:func:`gemnet_quad_chain`'s) and return ``out``."""
    n1, xm, qp = tensors["n1"], tensors["xm"], tensors["qp"]
    b, n, u, q, _ = n1.shape
    k2, e = xm.shape[3], xm.shape[4]
    f = qp.shape[-1]
    out = torch.empty((b, n, u, f, e), dtype=torch.float32, device=n1.device)
    lib = _library("gemnet_quad_chain", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                   + [ctypes.c_longlong, ctypes.c_void_p])
    _launch(
        "gemnet_quad_chain", lib, n1.device,
        *(tensors[name].data_ptr() for name in ("n1", "n2", "key1", "key2", "xm", "qp")), out.data_ptr(),
        b * n, u, q, k2, s, e, f, plan.warps, plan.parts, plan.qp_buffers, int(plan.copy_bytes == 16),
        plan.smem_bytes,
    )
    return out


# csrc/gemnet_quad_chain.cu's constants: floats of a warp's basis buffer (32 in-edges x 8 levels), levels s and
# columns e or f a pass; the plan's starting point of 8 warps a block, and the warps an SM holds at the kernel's 128
# registers a thread
_QC_Y_FLOATS, _QC_LEVELS, _QC_COLS, _QC_WARPS, _QC_WARPS_PER_SM = 32 * 8, 8, 32, 8, 16
# H100: the most dynamic shared memory a block may take (227 KB), an SM's shared memory, the 1 KB reserved a block
_QC_SMEM, _SM_SMEM, _BLOCK_RESERVED = 232448, 233472, 1024


class QuadChainPlan(NamedTuple):
    """How :func:`gemnet_quad_chain` is launched: ``warps`` a block, each
    owning main edges u of one cell; ``parts`` blocks a cell (the cell's u
    dealt over ``parts * warps`` warps: block ``x`` takes cell ``x //
    parts``, its warp ``w`` is the cell's warp ``g = (x % parts) * warps +
    w`` and takes ``u = g, g + parts * warps, ...``); ``blocks`` = cells x
    parts of ``threads``; ``qp_buffers`` qp[u] buffers a warp in shared
    memory (1: the next u copied once this one is done; 0: qp read from
    device memory); ``copy_bytes`` a cp.async of qp (16 or 4; 0 when not
    staged); ``smem_bytes`` of dynamic shared memory a block;
    ``blocks_per_sm`` as shared memory and the registers allow; ``waves`` =
    blocks / (SMs x blocks an SM); passes of 8 levels s, 32 columns e and 32
    columns f."""

    warps: int
    parts: int
    blocks: int
    threads: int
    qp_buffers: int
    copy_bytes: int
    smem_bytes: int
    blocks_per_sm: int
    waves: float
    level_passes: int
    e_passes: int
    f_passes: int


def quad_chain_smem(warps: int, qp_buffers: int, u: int, q: int, k2: int, s: int, e: int, f: int) -> int:
    """Dynamic shared bytes of a block of ``csrc/gemnet_quad_chain.cu``: per
    warp the [32][8] basis buffer and its qp[u] buffer if any (rows of F
    rounded up to 4), then the cell's xm, normalised n2 and n1 rows and
    key2."""
    qk = q * k2
    return 4 * (warps * (_QC_Y_FLOATS + qp_buffers * s * q * _round4(f)) + qk * e + qk * 3 + u * q * 3 + qk)


def _quad_blocks_per_sm(warps: int, smem: int) -> int:
    return max(min(_SM_SMEM // (smem + _BLOCK_RESERVED), _QC_WARPS_PER_SM // warps, 32), 1)


def quad_chain_plan(cells: int, u: int, q: int, k2: int, s: int, e: int, f: int, sms: int, *,
                    qp_aligned: bool = True) -> QuadChainPlan:
    """``csrc/gemnet_quad_chain.cu``'s launch for ``cells`` cells of ``u``
    main edges on a card of ``sms`` SMs.  Of 8, 4, 2 or 1 warps a block (at
    most U), the layout with a qp[u] buffer a warp that fits 227 KB with the
    most warps an SM (16 at most, by the registers), then the most warps a
    block: at the relaxation shape 8 warps, two blocks an SM; where no
    buffer fits, none (qp read from device memory).  Blocks a cell: enough
    that a block's warps take at most two rounds of u, more while the grid
    fills less than one wave, at most one u a warp.  qp copies are 16 bytes
    where F % 4 == 0 and qp is 16-byte aligned (so S*Q*F % 4 == 0), else 4.
    Raises ValueError only where the cell's staged xm, n1, n2 and key2 with
    one warp's basis buffer exceed 227 KB, which the kernel this one
    replaced (it staged those and more) refused as well."""
    w0 = max(min(_QC_WARPS, u), 1)
    options = [(w, nb) for w in (w0, w0 // 2, w0 // 4, w0 // 8) if w >= 1 for nb in (1, 0)]
    smem = {o: quad_chain_smem(o[0], o[1], u, q, k2, s, e, f) for o in options}
    fits = [o for o in options if smem[o] <= _QC_SMEM]
    if not fits:
        raise ValueError(f"gemnet_quad_chain: U={u}, Q={q}, K2={k2}, S={s}, E={e}, F={f} need "
                         f"{min(smem.values())} bytes of shared memory a block, more than {_QC_SMEM}")
    w, nb = max(fits, key=lambda o: (o[1], o[0] * _quad_blocks_per_sm(o[0], smem[o]), o[0]))
    per_sm = _quad_blocks_per_sm(w, smem[w, nb])
    parts = min(max(_cdiv(u, 2 * w), sms * per_sm // max(cells, 1)), _cdiv(u, w))
    copy = 0 if nb == 0 else 16 if f % 4 == 0 and qp_aligned else 4
    return QuadChainPlan(warps=w, parts=parts, blocks=cells * parts, threads=32 * w, qp_buffers=nb,
                         copy_bytes=copy, smem_bytes=smem[w, nb], blocks_per_sm=per_sm,
                         waves=cells * parts / (sms * per_sm), level_passes=max(1, _cdiv(s, _QC_LEVELS)),
                         e_passes=_cdiv(e, _QC_COLS), f_passes=_cdiv(f, _QC_COLS))


@functools.lru_cache(maxsize=16)
def _legendre_coefs(num_spherical: int) -> np.ndarray:
    """``sqrt((2l+1)/4pi)``, l = 0..S-1, in double and rounded to f32 once,
    as ``math.sqrt`` times an f32 array is (cached: read-only)."""
    coef = np.array([math.sqrt((2 * l + 1) / (4 * math.pi)) for l in range(num_spherical)], np.float32)
    coef.setflags(write=False)
    return coef


def legendre_y_l0(cos: torch.Tensor, num_spherical: int, dim: int = -1) -> torch.Tensor:
    """Real spherical harmonics ``Y_l^0 = sqrt((2l+1)/4pi) P_l(cos)``, l =
    0..S-1, stacked on a new axis at ``dim`` (the recurrence of
    ``pallas_kernels.py:1630-1632``; the plain versions and GemNet-OC's
    quadruplet bases share it)."""
    ps = [torch.ones_like(cos), cos]
    for l in range(2, num_spherical):
        ps.append(((2 * l - 1) * cos * ps[l - 1] - (l - 1) * ps[l - 2]) / l)
    return torch.stack([float(c) * p for c, p in zip(_legendre_coefs(num_spherical), ps)], dim=dim)


def _masked_legendre(cos: torch.Tensor, keep: torch.Tensor, num_spherical: int, dim: int) -> torch.Tensor:
    """:func:`legendre_y_l0` at ``dim``, zero where ``keep`` is False."""
    y = legendre_y_l0(cos, num_spherical, dim)
    return torch.where(keep.unsqueeze(dim), y, torch.zeros((), dtype=y.dtype, device=y.device))


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows over ``v / max(|v|, 1e-9)`` (the dihedral bases' normalisation)."""
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-9)


def masked_legendre_cos_reference(a: torch.Tensor, bt: torch.Tensor, keep: torch.Tensor,
                                  num_spherical: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`masked_legendre_cos`: ``a [G, M, C]``,
    ``bt [G, C, K]``, ``keep [G, M, K]`` bool -> ``[G, S, M, K]``."""
    cos = torch.clamp(torch.matmul(a.float(), bt.float()), -1.0, 1.0)
    return _masked_legendre(cos, keep, num_spherical, dim=1)


def gemnet_cbf_basis_reference(u: torch.Tensor, v: torch.Tensor, keep: torch.Tensor,
                               num_spherical: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemnet_cbf_basis`: ``u [B, N, M, 3]``,
    ``v [B, N, K, 3]`` unit rows (zero rows give cos 0), ``keep [B, N, M, K]``
    -> ``[B, N, S, M, K]``."""
    cos = torch.clamp(torch.einsum("bnmc,bnkc->bnmk", u.float(), v.float()), -1.0, 1.0)
    return _masked_legendre(cos, keep, num_spherical, dim=2)


def gemnet_quad_basis_reference(n1: torch.Tensor, n2: torch.Tensor, keep: torch.Tensor,
                                num_spherical: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemnet_quad_basis`: ``n1 [B, N, K1,
    Kq, 3]``, ``n2 [B, N, Kq, K2, 3]`` (normalised here, eps 1e-9), ``keep
    [B, N, K1, Kq, K2]`` -> ``[B, N, S, Kq, K1, K2]``."""
    cos = torch.einsum("bnuqc,bnqkc->bnquk", _unit_rows(n1.float()), _unit_rows(n2.float()))
    return _masked_legendre(torch.clamp(cos, -1.0, 1.0), keep.permute(0, 1, 3, 2, 4), num_spherical, dim=2)


def _legendre_launch(tensors: dict, out: torch.Tensor, outer: int, q: int, m: int, k: int, s: int,
                     normalize: bool, strides: Tuple[int, ...]) -> None:
    """Launch ``csrc/masked_legendre_cos.cu`` on ``outer x q`` cells of
    ``m x k`` columns, every operand addressed through ``strides`` (a: outer,
    q, m; b: outer, q, k, component; keep: outer, q, m; y: outer, q, l, m)."""
    _check_cuda_inputs("masked_legendre_cos", tensors, {"keep": torch.bool})
    if not 1 <= s <= 16:
        raise ValueError(f"masked_legendre_cos: the kernel holds 1 <= S <= 16 levels, got {s}")
    if 12 * (m + k) > 227 * 1024:
        raise ValueError(f"masked_legendre_cos: M + K = {m + k} rows exceed the shared memory")
    if out.numel() == 0:  # empty output: nothing to launch
        return
    lib = _library("masked_legendre_cos", [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3)
    a, b, keep = tensors["a"], tensors["b"], tensors["keep"]
    strides_c = (ctypes.c_longlong * 14)(*strides)
    coef = _legendre_coefs(s)
    _launch("masked_legendre_cos", lib, a.device, a.data_ptr(), b.data_ptr(), keep.data_ptr(), out.data_ptr(),
            outer, q, m, k, s, int(normalize), ctypes.addressof(strides_c), coef.ctypes.data)


def masked_legendre_cos(a: torch.Tensor, bt: torch.Tensor, keep: torch.Tensor, num_spherical: int) -> torch.Tensor:
    """``y[g, l, m, k] = sqrt((2l+1)/4pi) P_l(clip(<a[g,m,:], bt[g,:,k]>, -1, 1))
    * keep[g, m, k]`` (``csrc/masked_legendre_cos.cu``), f32, forward only.

    ``a [G, M, C]``, ``bt [G, C, K]``, ``keep [G, M, K]`` -> ``[G, S, M, K]``.
    On the card: C = 3, f32 vectors, bool ``keep``, contiguous, S <= 16 and
    no autograd (the TPU kernel is forward-only too; GemNet-OC S2EF training
    will bring the VJP)."""
    if a.device.type == "cpu":
        return masked_legendre_cos_reference(a, bt, keep, num_spherical)
    g, m, c = a.shape
    k = bt.shape[2]
    if c != 3:
        raise ValueError(f"masked_legendre_cos: the kernel takes C = 3 components, got {c}")
    tensors = dict(a=a, b=bt, keep=keep)
    _check_shapes("masked_legendre_cos", tensors, dict(b=(g, 3, k), keep=(g, m, k)))
    s = num_spherical
    out = torch.empty((g, s, m, k), dtype=torch.float32, device=a.device)
    _legendre_launch(tensors, out, g, 1, m, k, s, False,
                     (m * 3, 0, 3, 3 * k, 0, 1, k, m * k, 0, k, s * m * k, 0, m * k, k))
    return out


def gemnet_cbf_basis(u: torch.Tensor, v: torch.Tensor, keep: torch.Tensor, num_spherical: int) -> torch.Tensor:
    """GemNet-OC's masked triplet basis over the angles between unit edge
    vectors (:func:`masked_legendre_cos` with one (b, n) row per cell).

    ``u [B, N, M, 3]``, ``v [B, N, K, 3]`` unit rows (zero rows, padded edges,
    give cos 0), ``keep [B, N, M, K]`` bool -> ``[B, N, S, M, K]`` f32.  On the
    card: as :func:`masked_legendre_cos`; launches counted under
    ``masked_legendre_cos``."""
    if u.device.type == "cpu":
        return gemnet_cbf_basis_reference(u, v, keep, num_spherical)
    b, n, m, _ = u.shape
    k = v.shape[2]
    tensors = dict(a=u, b=v, keep=keep)
    _check_shapes("gemnet_cbf_basis", tensors, dict(a=(b, n, m, 3), b=(b, n, k, 3), keep=(b, n, m, k)))
    s = num_spherical
    out = torch.empty((b, n, s, m, k), dtype=torch.float32, device=u.device)
    _legendre_launch(tensors, out, b * n, 1, m, k, s, False,
                     (m * 3, 0, 3, k * 3, 0, 3, 1, m * k, 0, k, s * m * k, 0, m * k, k))
    return out


def gemnet_quad_basis(n1: torch.Tensor, n2: torch.Tensor, keep: torch.Tensor, num_spherical: int) -> torch.Tensor:
    """GemNet-OC's masked dihedral basis (:func:`masked_legendre_cos` with one
    (b, n, q) row per cell): ``y[b, n, l, q, u, k] = coef[l] P_l(clip(<n1h[u, q],
    n2h[q, k]>)) keep[u, q, k]`` with ``n1h``/``n2h`` the cross products
    normalised in the kernel (eps 1e-9).

    ``n1 [B, N, K1, Kq, 3]``, ``n2 [B, N, Kq, K2, 3]``, ``keep [B, N, K1, Kq,
    K2]`` bool -> ``[B, N, S, Kq, K1, K2]`` f32, written in that layout by the
    kernel.  On the card: as :func:`masked_legendre_cos`."""
    if n1.device.type == "cpu":
        return gemnet_quad_basis_reference(n1, n2, keep, num_spherical)
    b, n, k1, kq, _ = n1.shape
    k2 = n2.shape[3]
    tensors = dict(a=n1, b=n2, keep=keep)
    _check_shapes("gemnet_quad_basis", tensors, dict(a=(b, n, k1, kq, 3), b=(b, n, kq, k2, 3),
                                                     keep=(b, n, k1, kq, k2)))
    s = num_spherical
    out = torch.empty((b, n, s, kq, k1, k2), dtype=torch.float32, device=n1.device)
    _legendre_launch(tensors, out, b * n, kq, k1, k2, s, True,
                     (k1 * kq * 3, 3, kq * 3, kq * k2 * 3, k2 * 3, 3, 1, k1 * kq * k2, k2, kq * k2,
                      s * kq * k1 * k2, k1 * k2, kq * k1 * k2, k2))
    return out


def s2_grid_silu_reference(h: torch.Tensor, to_grid_m: torch.Tensor, from_grid_m: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`s2_grid_silu`: the ``[..., G, C]``
    grid tensor is materialised."""
    g = torch.matmul(to_grid_m.float(), h.float())
    return torch.matmul(from_grid_m.float(), torch.nn.functional.silu(g))


def s2_grid_silu_bwd_reference(h: torch.Tensor, dy: torch.Tensor, to_grid_m: torch.Tensor,
                               from_grid_m: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`s2_grid_silu_bwd`: the ``[..., G, C]``
    grid tensors ``g`` and ``dg`` are materialised."""
    to_m, from_m = to_grid_m.float(), from_grid_m.float()
    g = torch.matmul(to_m, h.float())
    s = torch.sigmoid(g)
    dg = torch.matmul(from_m.t(), dy.float()) * (s * (1.0 + g * (1.0 - s)))
    return torch.matmul(to_m.t(), dg)


# H100 SXM: the most shared memory a block may take (227 KB), less 1 KB for
# the kernels' static shared variables; an SM's shared memory (228 KB), of
# which the card reserves 1 KB a block
SMEM_PER_BLOCK = 232448 - 1024
SMEM_PER_SM = 233472


class LaunchPlan(NamedTuple):
    """How a kernel is launched: ``tile`` edges (or columns) a block takes at
    a time, ``cluster`` blocks that share their weight slices (1: none),
    ``threads`` a block, ``blocks`` in the grid, dynamic shared-memory bytes a
    block, and the FLOP per edge the design adds to the function's count."""

    tile: int
    cluster: int
    threads: int
    blocks: int
    smem_bytes: int
    extra_flops_per_edge: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def s2_grid_silu_plan(m: int, nc: int, c: int, g: int) -> LaunchPlan:
    """``csrc/s2_grid_silu.cu``'s launch: 128 threads of 4 columns a block,
    one column group per thread over the ``m * c`` (edge, channel) columns,
    both ``[G, NC]`` tables (rows padded to 4) in shared memory."""
    threads, cols = 128, 4
    smem = 2 * g * _round4(nc) * 4
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"s2_grid_silu: the tables need {smem} bytes of shared memory, more than {SMEM_PER_BLOCK}")
    return LaunchPlan(tile=threads * cols, cluster=1, threads=threads,
                      blocks=max(_cdiv(m * c, threads * cols), 1), smem_bytes=smem)


def s2_grid_silu_bwd_plan(m: int, nc: int, c: int, g: int, sms: int) -> LaunchPlan:
    """``csrc/s2_grid_silu_bwd.cu``'s launch on a card of ``sms`` SMs: blocks
    of 128 threads of 2 columns, persistent, one per SM slot (3 an SM up to
    NC = 19, 2 past it, fewer where the tables leave no room; one per column
    group when there are fewer groups).  Block ``b`` takes the 256-column
    groups ``b, b + blocks, ...`` of the ``m * c`` (edge, channel) columns;
    both ``[G, NC]`` tables (rows padded to 4) sit in its shared memory,
    staged once.  The kernel refuses ``smem_bytes`` other than its layout's
    and ``blocks`` outside 1 .. the groups."""
    threads, cols = 128, 2
    smem = 2 * g * _round4(nc) * 4
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"s2_grid_silu_bwd: the tables need {smem} bytes of shared memory, more than "
                         f"{SMEM_PER_BLOCK}")
    groups = max(_cdiv(m * c, threads * cols), 1)
    per_sm = min(3 if nc <= 19 else 2, SMEM_PER_SM // (smem + 1024))
    return LaunchPlan(tile=threads * cols, cluster=1, threads=threads, blocks=min(groups, per_sm * sms),
                      smem_bytes=smem)


# csrc/eqv2_attn_conv1.cu's constants: edges a tile, threads, most weight
# rows a ring slice, ring slots, floats a slot, gate columns a chunk, trunk
# columns a pass, 64-column groups an m0 / |m| > 0 pass at most, bytes of one
# segment table entry (two pointers and seven ints)
_C1_TILE, _C1_THREADS, _C1_SLICE_ROWS, _C1_STAGES, _C1_SLOT, _C1_KC, _C1_TRUNK_N = 64, 256, 64, 3, 8192, 128, 128
_C1_M0_NJ, _C1_PAIR_NJ, _C1_SEG_BYTES, _C1_MAX_PARTS = 7, 4, 48, 32


def _pass_width(n: int, nj_max: int) -> int:
    """The kernel's column pass: the fewest passes of at most ``nj_max * 64``
    columns, each rounded up to whole 64-column groups."""
    return _cdiv(_cdiv(n, _cdiv(n, nj_max * 64)), 64) * 64


def _conv1_parts(c: int, c_out: int, extra: int, n_blocks: Tuple[int, ...]):
    """Per m-block ``(K, N, column passes)``, in the kernel's order."""
    out = []
    for g, nb in enumerate(n_blocks):
        n = extra + nb * c_out if g == 0 else nb * c_out
        out.append((nb * c, n, _cdiv(n, _pass_width(n, _C1_M0_NJ if g == 0 else _C1_PAIR_NJ))))
    return out


def _conv1_tile_budget(e_dim: int, hidden: int, c: int, c_out: int, extra: int,
                       n_blocks: Tuple[int, ...]) -> Tuple[int, int, list]:
    """(shared bytes a block, column passes, per-m-block parts) of the
    64-edge kernel at these widths."""
    hp, edp = _round4(hidden), _round4(e_dim)
    trunk_passes = _cdiv(hidden, _C1_TRUNK_N)
    parts = _conv1_parts(c, c_out, extra, n_blocks)
    n_parts = sum(p for _, _, p in parts)
    n_seg = 4 * trunk_passes + sum(p * 2 * _cdiv(k, _C1_KC) * 2 for k, _, p in parts)
    x_floats = _C1_TILE * max(2 * edp, hp, 2 * _C1_KC)
    floats = _C1_STAGES * _C1_SLOT + hp * _C1_TILE + x_floats + _C1_SLICE_ROWS * _C1_TILE + 2 * _C1_TILE
    return 4 * floats + _C1_SEG_BYTES * n_seg, n_parts, parts


# csrc/eqv2_attn_conv1_wide.cu's constants: edges a tile, gaussian rows a chunk
_C1W_TILE, _C1W_RC = 16, 32


def attn_conv1_wide_smem(e_dim: int, hidden: int, c: int, n_blocks: Tuple[int, ...]) -> int:
    """Shared bytes a block of ``csrc/eqv2_attn_conv1_wide.cu`` takes: the
    tile's distances and mask, a gaussian chunk, both trunk layers, and the
    embeddings or the two gated message slices of the widest m-block."""
    k_max = _round4(max(n_blocks) * c)
    return 4 * (2 * _C1W_TILE + _C1W_TILE * _C1W_RC + 2 * _C1W_TILE * _round4(hidden)
                + 2 * _C1W_TILE * max(_round4(e_dim), k_max))


def attn_conv1_route(e_dim: int, hidden: int, c: int, c_out: int, extra: int, n_blocks: Tuple[int, ...]) -> str:
    """Which kernel :func:`eqv2_attn_conv1` launches at these widths, from the
    widths alone: ``"tiled64"`` (``csrc/eqv2_attn_conv1.cu``, the 64-edge
    plan of :func:`attn_conv1_plan`) when that plan fits one block's shared
    memory and at most ``_C1_MAX_PARTS`` column passes, else ``"wide"``
    (``csrc/eqv2_attn_conv1_wide.cu``, 16-edge tiles: at C = 128 and equal
    trunk and embedding widths, those over 144).  Raises ValueError when
    neither fits."""
    smem, n_parts, _ = _conv1_tile_budget(e_dim, hidden, c, c_out, extra, n_blocks)
    if smem <= SMEM_PER_BLOCK and n_parts <= _C1_MAX_PARTS:
        return "tiled64"
    wide = attn_conv1_wide_smem(e_dim, hidden, c, n_blocks)
    if wide > SMEM_PER_BLOCK:
        raise ValueError(f"eqv2_attn_conv1: widths (hidden {hidden}, emb {e_dim}, C {c}) need {smem} bytes of "
                         f"shared memory a block in 64-edge tiles and {wide} in 16-edge tiles, more than "
                         f"{SMEM_PER_BLOCK}")
    return "wide"


def attn_conv1_plan(e: int, num_gauss: int, e_dim: int, hidden: int, c: int, c_out: int, extra: int,
                    n_blocks: Tuple[int, ...], sms: int) -> LaunchPlan:
    """``csrc/eqv2_attn_conv1.cu``'s launch for ``e`` edges on a card of
    ``sms`` SMs: one persistent block per SM (one per 64-edge tile when there
    are fewer), each taking whole tiles and then units, single column passes
    of 32-edge halves of the tiles left over (:func:`attn_conv1_work`).  The
    shared memory is the 3-slot weight ring, the trunk activations, the X
    region (embeddings, the second trunk layer, the gated message chunk), a
    gaussian slice, the tile's distances and mask, and the segment table (one
    entry per weight region a tile streams, counted as the kernel's
    ``for_each_segment`` walks them).  ``extra_flops_per_edge``: the
    gates that a second (or later) column pass of an m-block makes again, and
    the trunk that every unit of a leftover tile makes again.  Raises
    ValueError when the widths do not fit (:func:`attn_conv1_route` then
    picks the wide route)."""
    smem, n_parts, parts = _conv1_tile_budget(e_dim, hidden, c, c_out, extra, n_blocks)
    if smem > SMEM_PER_BLOCK or n_parts > _C1_MAX_PARTS:
        raise ValueError(f"eqv2_attn_conv1: widths (hidden {hidden}, emb {e_dim}, C {c}) need {smem} bytes of "
                         f"shared memory a block, more than {SMEM_PER_BLOCK}, or {n_parts} column passes (at most "
                         f"{_C1_MAX_PARTS})")
    tiles = max(_cdiv(e, _C1_TILE), 1)
    blocks = min(sms, tiles)
    leftover_edges = e - (tiles // blocks) * blocks * _C1_TILE
    trunk_flops = 2 * hidden * (num_gauss + 2 * e_dim + hidden)
    extra_flops = sum((p - 1) * 2 * 2 * hidden * k for k, _, p in parts)
    extra_flops += _cdiv(leftover_edges * (n_parts - 1) * trunk_flops, max(e, 1))
    return LaunchPlan(tile=_C1_TILE, cluster=1, threads=_C1_THREADS, blocks=blocks, smem_bytes=smem,
                      extra_flops_per_edge=extra_flops)


def attn_conv1_work(e: int, blocks: int, n_parts: int):
    """The kernel's work items, as ``(block, first edge, edges, parts)``
    (``parts``: the set of column passes, None for all): of the ``T`` 64-edge
    tiles, block ``b`` takes tiles ``b * q .. b * q + q - 1`` whole (``q = T //
    blocks``), then the units ``u = b, b + blocks, ...`` of the leftover tiles
    ``q * blocks ..``, unit ``u`` being column pass ``u % n_parts`` of the
    32-edge half ``u // n_parts`` of those tiles."""
    tiles = _cdiv(e, _C1_TILE)
    whole = tiles // blocks
    half = _C1_TILE // 2
    units = _cdiv(e - whole * blocks * _C1_TILE, half) * n_parts  # the non-empty halves
    for b in range(blocks):
        for i in range(whole):
            t = b * whole + i
            yield b, t * _C1_TILE, min(_C1_TILE, e - t * _C1_TILE), None
        for u in range(b, units, blocks):
            e0 = whole * blocks * _C1_TILE + (u // n_parts) * half
            yield b, e0, min(half, e - e0), {u % n_parts}


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _s2_shape(kernel: str, tensors: dict) -> Tuple[int, int, int, int]:
    """``(M, NC, C, G)`` of the S^2 kernels' inputs, or raise."""
    h, to_grid_m = tensors["h"], tensors["to_grid_m"]
    if h.dim() < 2 or to_grid_m.dim() != 2:
        raise ValueError(f"{kernel}: h must be [..., NC, C] and to_grid_m [G, NC]")
    nc, c = h.shape[-2:]
    g = to_grid_m.shape[0]
    _check_shapes(kernel, tensors, dict(to_grid_m=(g, nc), from_grid_m=(nc, g)))
    if nc > 32:
        raise ValueError(f"{kernel}: the kernel holds NC <= 32 coefficient rows, got {nc}")
    return h.numel() // max(nc * c, 1), nc, c, g


def s2_grid_silu(h: torch.Tensor, to_grid_m: torch.Tensor, from_grid_m: torch.Tensor) -> torch.Tensor:
    """EquiformerV2's S^2 grid activation ``from_grid_m @ silu(to_grid_m @ h)``
    over the coefficient axis, fused (``csrc/s2_grid_silu.cu``): the grid
    tensor never reaches device memory.

    ``h [..., NC, C]`` truncated m-primary coefficients (any leading dims);
    ``to_grid_m [G, NC]``, ``from_grid_m [NC, G]`` with the m-truncation
    rescale folded in by the caller.  Returns a tensor like ``h``, f32.  On
    the card: f32, contiguous, NC <= 32.  When autograd needs a gradient of
    ``h`` the call goes through :class:`S2GridSilu`, whose backward is
    :func:`s2_grid_silu_bwd`.
    """
    if torch.is_grad_enabled() and h.requires_grad:
        return S2GridSilu.apply(h, to_grid_m, from_grid_m)
    return _s2_grid_silu_forward(h, to_grid_m, from_grid_m)


def _s2_grid_silu_forward(h, to_grid_m, from_grid_m) -> torch.Tensor:
    if h.device.type == "cpu":
        return s2_grid_silu_reference(h, to_grid_m, from_grid_m)
    tensors = dict(h=h, to_grid_m=to_grid_m, from_grid_m=from_grid_m)
    _check_cuda_inputs("s2_grid_silu", tensors, {})
    m, nc, c, g = _s2_shape("s2_grid_silu", tensors)
    out = torch.empty_like(h)
    if h.numel() == 0:  # empty output: nothing to launch
        return out
    plan = s2_grid_silu_plan(m, nc, c, g)
    lib = _library("s2_grid_silu", [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    _launch("s2_grid_silu", lib, h.device, h.data_ptr(), to_grid_m.data_ptr(), from_grid_m.data_ptr(),
            out.data_ptr(), m, nc, c, g, plan.blocks, plan.smem_bytes)
    return out


def s2_grid_silu_bwd(h: torch.Tensor, dy: torch.Tensor, to_grid_m: torch.Tensor,
                     from_grid_m: torch.Tensor) -> torch.Tensor:
    """VJP of :func:`s2_grid_silu` with respect to ``h``
    (``csrc/s2_grid_silu_bwd.cu``): ``dh = to^T @ (silu'(g) * (from^T @ dy))``
    with ``g = to @ h`` recomputed; neither grid tensor reaches device memory.

    ``h`` and ``dy`` ``[..., NC, C]``, the tables as :func:`s2_grid_silu`
    takes them.  Returns ``dh`` like ``h``, f32.  On the card: the forward's
    input rules for both ``h`` and ``dy``, launched by
    :func:`s2_grid_silu_bwd_plan`.  Each column is written by one thread (no
    atomics): the result repeats bit for bit.
    """
    if h.device.type == "cpu":
        return s2_grid_silu_bwd_reference(h, dy, to_grid_m, from_grid_m)
    tensors = dict(h=h, dy=dy, to_grid_m=to_grid_m, from_grid_m=from_grid_m)
    _check_cuda_inputs("s2_grid_silu_bwd", tensors, {})
    m, nc, c, g = _s2_shape("s2_grid_silu_bwd", tensors)
    _check_shapes("s2_grid_silu_bwd", tensors, dict(dy=tuple(h.shape)))
    if h.numel() == 0:  # empty output: nothing to launch
        return torch.empty_like(h)
    return _s2_grid_silu_bwd_launch(h, dy, to_grid_m, from_grid_m, s2_grid_silu_bwd_plan(m, nc, c, g,
                                                                                           _sm_count(h.device)))


def _s2_grid_silu_bwd_launch(h, dy, to_grid_m, from_grid_m, plan: LaunchPlan) -> torch.Tensor:
    """Launch ``csrc/s2_grid_silu_bwd.cu`` with ``plan`` on checked, non-empty
    inputs (:func:`s2_grid_silu_bwd`'s) and return ``dh``."""
    nc, c = h.shape[-2:]
    dh = torch.empty_like(h)
    lib = _library("s2_grid_silu_bwd", [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    _launch("s2_grid_silu_bwd", lib, h.device, h.data_ptr(), dy.data_ptr(), to_grid_m.data_ptr(),
            from_grid_m.data_ptr(), dh.data_ptr(), h.numel() // (nc * c), nc, c, to_grid_m.shape[0], plan.blocks,
            plan.smem_bytes, shape=f"h{tuple(h.shape)}")
    return dh


class S2GridSilu(torch.autograd.Function):
    """:func:`s2_grid_silu` with its backward kernel :func:`s2_grid_silu_bwd`.

    The gradient flows to ``h`` only: the grid tables are static and get none
    (``None``), the JAX contract (``pallas_kernels.py::_s2_act_bwd``).
    """

    @staticmethod
    def forward(ctx, h, to_grid_m, from_grid_m):
        ctx.save_for_backward(h, to_grid_m, from_grid_m)
        return _s2_grid_silu_forward(h, to_grid_m, from_grid_m)

    @staticmethod
    def backward(ctx, dy):
        h, to_grid_m, from_grid_m = ctx.saved_tensors
        return s2_grid_silu_bwd(h, dy.contiguous(), to_grid_m, from_grid_m).to(h.dtype), None, None


class AttnConv1Weights(NamedTuple):
    """:func:`eqv2_attn_conv1`'s weights in the kernel's layout (the JAX
    package's ``eqv2_attn_conv1`` repack, ``[in, out]`` row-major).

    ``trunk``: ``wg [R, H]``, ``ws``, ``wt [Ed, H]`` (the gaussian, source and
    target rows of ``dense_0``), ``b0``, ``ln0_scale``, ``ln0_bias [H]``,
    ``w1 [H, H]``, ``b1``, ``ln1_scale``, ``ln1_bias [H]``, ``w2 [H, NG]`` and
    ``b2 [NG]`` (the gate columns reordered into [s-half | t-half], each
    half n-major per m-block), ``bm0 [extra + nb0 * c_out]`` (fc_m0's bias).
    ``conv``: ``km0_s``, ``km0_t [nb0 * C, extra + nb0 * c_out]``, then per
    |m| > 0 block ``kr_s``, ``ki_s``, ``kr_t``, ``ki_t [nb * C, nb * c_out]``
    (each fc kernel's rows split into the source (c < C) and target (c >= C)
    halves), all views of ``flat_conv``, the kernel's one buffer.
    """

    trunk: Tuple[torch.Tensor, ...]
    conv: Tuple[torch.Tensor, ...]
    flat_conv: torch.Tensor
    n_blocks: Tuple[int, ...]
    c_in: int
    num_gauss: int


def conv1_blocks(lmax: int, mmax: int) -> Tuple[int, ...]:
    """Rows per m-block of the truncated m-primary layout, m = 0..mmax."""
    return tuple(lmax + 1 - m for m in range(mmax + 1))


@functools.lru_cache(maxsize=16)
def _gate_perm(n_blocks: Tuple[int, ...], c: int, device: torch.device) -> torch.Tensor:
    """Gate column order [s-half | t-half] from the radial trunk's
    (block, n, 2C) interleaved columns, on ``device`` (copied once: a copy
    from host memory on every call would wait for the card each time)."""
    n_rad = 2 * sum(n_blocks) * c
    perm = np.zeros(n_rad, np.int64)
    half = n_rad // 2
    oldoff = newoff = 0
    for nb in n_blocks:
        idx = np.arange(nb * c)
        n_i, ch = idx // c, idx % c
        perm[newoff + idx] = oldoff + n_i * 2 * c + ch
        perm[half + newoff + idx] = oldoff + n_i * 2 * c + c + ch
        oldoff += nb * 2 * c
        newoff += nb * c
    return torch.from_numpy(perm).to(device)


def pack_attn_conv1(rad_params: Dict[str, Any], conv_params: Dict[str, Any], *, lmax: int, mmax: int,
                    num_gauss: int, c_in: int) -> AttnConv1Weights:
    """The repack of the JAX package's ``eqv2_attn_conv1``: ``rad_params``
    is the RadialFunction tree (``dense_{0,1,2}`` ``kernel [in, out]`` and
    ``bias``, ``ln_{0,1}`` ``scale`` and ``bias``), ``conv_params`` the SO2Conv
    tree (``fc_m0`` ``kernel``/``bias``, ``fc_m{i}_{r,i}`` ``kernel``), as
    tensors; ``c_in`` is the channel count of one message half."""
    n_blocks = conv1_blocks(lmax, mmax)
    w0 = rad_params["dense_0"]["kernel"]
    e_dim = (w0.shape[0] - num_gauss) // 2
    perm = _gate_perm(n_blocks, c_in, w0.device)
    w2 = rad_params["dense_2"]["kernel"]
    trunk = tuple(t.float().contiguous() for t in (
        w0[:num_gauss], w0[num_gauss:num_gauss + e_dim], w0[num_gauss + e_dim:],
        rad_params["dense_0"]["bias"], rad_params["ln_0"]["scale"], rad_params["ln_0"]["bias"],
        rad_params["dense_1"]["kernel"], rad_params["dense_1"]["bias"],
        rad_params["ln_1"]["scale"], rad_params["ln_1"]["bias"],
        w2[:, perm], rad_params["dense_2"]["bias"][perm], conv_params["fc_m0"]["bias"],
    ))

    def split_st(k, nb):
        k3 = k.reshape(nb, 2 * c_in, -1)
        return k3[:, :c_in].reshape(nb * c_in, -1), k3[:, c_in:].reshape(nb * c_in, -1)

    conv = list(split_st(conv_params["fc_m0"]["kernel"], n_blocks[0]))
    for mi in range(1, len(n_blocks)):
        kr_s, kr_t = split_st(conv_params[f"fc_m{mi}_r"]["kernel"], n_blocks[mi])
        ki_s, ki_t = split_st(conv_params[f"fc_m{mi}_i"]["kernel"], n_blocks[mi])
        conv += [kr_s, ki_s, kr_t, ki_t]
    flat = torch.cat([k.float().reshape(-1) for k in conv])
    views, off = [], 0
    for k in conv:
        views.append(flat[off:off + k.numel()].view(k.shape))
        off += k.numel()
    return AttnConv1Weights(trunk, tuple(views), flat, n_blocks, c_in, num_gauss)


def _attn_conv1_packed_reference(dist, mask, emb_s, emb_t, msg_s, msg_t, w: AttnConv1Weights, *, cutoff: float,
                                 width_scalar: float, c_out: int, extra: int) -> Tuple[torch.Tensor, ...]:
    """Port of the JAX ``_attn_conv1_ref`` on flat ``[E]`` / ``[E, ...]``
    inputs and packed weights.  Returns ``(extra [E, extra], m0 [E, nb0 *
    c_out], then yp, yn [E, nb * c_out] per |m| > 0 block)``."""
    wg, ws, wt, b0, ln0s, ln0b, w1, b1, ln1s, ln1b, w2, b2, bm0 = w.trunk
    c_in, n_blocks, num_gauss = w.c_in, w.n_blocks, w.num_gauss
    delta = cutoff / (num_gauss - 1)
    coeff = -0.5 / (width_scalar * delta) ** 2
    off = torch.arange(num_gauss, dtype=torch.float32, device=dist.device) * delta
    gauss = torch.exp(coeff * (dist.float()[:, None] - off) ** 2) * mask.float()[:, None]

    def ln_silu(h, s, b):
        mu = torch.mean(h, dim=1, keepdim=True)
        var = torch.mean((h - mu) ** 2, dim=1, keepdim=True)
        return torch.nn.functional.silu((h - mu) * torch.rsqrt(var + 1e-6) * s + b)

    y0 = ln_silu(gauss @ wg + emb_s.float() @ ws + emb_t.float() @ wt + b0, ln0s, ln0b)
    y1 = ln_silu(y0 @ w1 + b1, ln1s, ln1b)
    gates = y1 @ w2 + b2
    half = sum(n_blocks) * c_in
    goff = [0]
    for nb in n_blocks:
        goff.append(goff[-1] + nb * c_in)

    def gated(msg, base):
        msg = msg.float()
        pieces = [msg[:, : n_blocks[0] * c_in] * gates[:, base : base + goff[1]]]
        moff = n_blocks[0] * c_in
        for mi in range(1, len(n_blocks)):
            g = gates[:, base + goff[mi] : base + goff[mi + 1]]
            width = n_blocks[mi] * c_in
            pieces.append(msg[:, moff : moff + width] * g)
            pieces.append(msg[:, moff + width : moff + 2 * width] * g)
            moff += 2 * width
        return pieces

    gs, gt = gated(msg_s, 0), gated(msg_t, half)
    conv = w.conv
    y0c = gs[0] @ conv[0] + gt[0] @ conv[1] + bm0
    outs = [y0c[:, :extra], y0c[:, extra:]]
    wi = 2
    for mi in range(1, len(n_blocks)):
        xp_s, xn_s, xp_t, xn_t = gs[2 * mi - 1], gs[2 * mi], gt[2 * mi - 1], gt[2 * mi]
        kr_s, ki_s, kr_t, ki_t = conv[wi : wi + 4]
        wi += 4
        outs.append(xp_s @ kr_s + xp_t @ kr_t - xn_s @ ki_s - xn_t @ ki_t)
        outs.append(xp_s @ ki_s + xp_t @ ki_t + xn_s @ kr_s + xn_t @ kr_t)
    return tuple(outs)


def _attn_conv1_prepare(dist, emb_s, msg_s, rad_params, conv_params, *, lmax, mmax, num_gauss):
    """(packed weights, leading dims, edges, n_act, C, emb dim) of a call."""
    c = msg_s.shape[-1]
    packed = pack_attn_conv1(rad_params, conv_params, lmax=lmax, mmax=mmax, num_gauss=num_gauss, c_in=c)
    lead = tuple(dist.shape)
    return packed, lead, math.prod(lead), msg_s.shape[-2], c, emb_s.shape[-1]


def eqv2_attn_conv1_reference(
    dist: torch.Tensor,  # [...] radii-offset edge distances
    mask: torch.Tensor,  # [...] bool
    emb_s: torch.Tensor,  # [..., Ed]
    emb_t: torch.Tensor,  # [..., Ed]
    msg_s: torch.Tensor,  # [..., n_act, C]
    msg_t: torch.Tensor,  # [..., n_act, C]
    rad_params: Dict[str, Any],
    conv_params: Dict[str, Any],
    *,
    lmax: int,
    mmax: int,
    c_out: int,
    extra: int,
    num_gauss: int,
    cutoff: float,
    width_scalar: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`eqv2_attn_conv1`: the gaussian basis,
    the trunk activations and the ``[E, NG]`` gates are materialised."""
    packed, lead, m, n_act, c, e_dim = _attn_conv1_prepare(
        dist, emb_s, msg_s, rad_params, conv_params, lmax=lmax, mmax=mmax, num_gauss=num_gauss)
    outs = _attn_conv1_packed_reference(
        dist.reshape(m), mask.reshape(m), emb_s.reshape(m, e_dim), emb_t.reshape(m, e_dim),
        msg_s.reshape(m, n_act * c), msg_t.reshape(m, n_act * c), packed,
        cutoff=cutoff, width_scalar=width_scalar, c_out=c_out, extra=extra)
    h = torch.cat([o.reshape(lead + (-1, c_out)) for o in outs[1:]], dim=-2)
    return h, outs[0].reshape(lead + (extra,))


def eqv2_attn_conv1(
    dist: torch.Tensor,
    mask: torch.Tensor,
    emb_s: torch.Tensor,
    emb_t: torch.Tensor,
    msg_s: torch.Tensor,
    msg_t: torch.Tensor,
    rad_params: Dict[str, Any],
    conv_params: Dict[str, Any],
    *,
    lmax: int,
    mmax: int,
    c_out: int,
    extra: int,
    num_gauss: int,
    cutoff: float,
    width_scalar: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """EquiformerV2's attention front half, fused (``csrc/eqv2_attn_conv1.cu``):
    gaussian distance basis -> radial trunk (Dense-LN-SiLU x2 -> Dense) ->
    per-m gates -> the gated first SO(2) conv over the source and target
    message halves.  The basis, the trunk activations and the gates never
    reach device memory.

    Shapes as :func:`eqv2_attn_conv1_reference`; ``rad_params`` and
    ``conv_params`` as :func:`pack_attn_conv1` takes them (repacked on every
    call).  Returns ``(h [..., n_act, c_out], extra_out [...,
    extra])``, f32: h's rows in the truncated m-primary order, extra_out the
    fc_m0 columns that precede h's.  On the card: f32 contiguous inputs and
    ``mask`` bool.  :func:`attn_conv1_route` picks the kernel from the widths:
    the 64-edge kernel where its plan fits one block's shared memory (at
    C = 128, equal trunk and embedding widths up to 144), else the 16-edge
    ``csrc/eqv2_attn_conv1_wide.cu``; both count as ``eqv2_attn_conv1``.
    When autograd needs a gradient the call goes through
    :class:`EqV2AttnConv1`, whose backward recomputes the plain version.
    """
    kw = dict(lmax=lmax, mmax=mmax, c_out=c_out, extra=extra, num_gauss=num_gauss, cutoff=cutoff,
              width_scalar=width_scalar)
    keys, leaves = _flatten_trees(rad_params, conv_params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (emb_s, emb_t, msg_s, msg_t, *leaves)):
        return EqV2AttnConv1.apply(kw, keys, dist, mask, emb_s, emb_t, msg_s, msg_t, *leaves)
    return _eqv2_attn_conv1_forward(dist, mask, emb_s, emb_t, msg_s, msg_t, rad_params, conv_params, **kw)


def _flatten_trees(rad_params: Dict[str, Any], conv_params: Dict[str, Any]):
    """((tree, module, leaf) keys, tensors) of the two weight trees, in a fixed order."""
    keys = [(tree, mod, leaf) for tree, params in (("rad", rad_params), ("conv", conv_params))
            for mod in sorted(params) for leaf in sorted(params[mod])]
    trees = {"rad": rad_params, "conv": conv_params}
    return tuple(keys), [trees[tree][mod][leaf] for tree, mod, leaf in keys]


def _unflatten_trees(keys, leaves) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    trees: Dict[str, Dict[str, Any]] = {"rad": {}, "conv": {}}
    for (tree, mod, leaf), t in zip(keys, leaves):
        trees[tree].setdefault(mod, {})[leaf] = t
    return trees["rad"], trees["conv"]


class EqV2AttnConv1(torch.autograd.Function):
    """:func:`eqv2_attn_conv1` with its VJP.

    The backward recomputes the plain version (:func:`eqv2_attn_conv1_reference`)
    under autograd and differentiates it, as the JAX package's
    ``_attn_conv1_bwd`` differentiates ``_attn_conv1_ref``: the TPU kernel has
    no backward kernel of its own.  The recompute starts from the weight
    trees as the caller passed them (the module's parameters or views of
    them), so the gradients reach those and not the kernel's packed copy.
    Gradients flow to the embeddings, both message halves and every weight;
    ``dist`` gets zeros and ``mask`` none (the geometry contract of
    ``pallas_kernels.py::_attn_conv1_bwd``).  A half that the caller expanded
    over K gets its gradient per edge; autograd sums it back over K.
    """

    @staticmethod
    def forward(ctx, kw, keys, dist, mask, emb_s, emb_t, msg_s, msg_t, *leaves):
        ctx.kw, ctx.keys = kw, keys
        ctx.save_for_backward(dist, mask, emb_s, emb_t, msg_s, msg_t, *leaves)
        rad, conv = _unflatten_trees(keys, leaves)
        return _eqv2_attn_conv1_forward(dist, mask, emb_s, emb_t, msg_s, msg_t, rad, conv, **kw)

    @staticmethod
    def backward(ctx, dh, dx):
        dist, mask, *inputs = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(True) for t in inputs]
        with torch.enable_grad():
            rad, conv = _unflatten_trees(ctx.keys, inputs[4:])
            outs = eqv2_attn_conv1_reference(dist, mask, *inputs[:4], rad, conv, **ctx.kw)
            grads = torch.autograd.grad(outs, inputs, (dh, dx), allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(inputs, grads)]
        return (None, None, torch.zeros_like(dist), None, *grads)


def _eqv2_attn_conv1_forward(dist, mask, emb_s, emb_t, msg_s, msg_t, rad_params, conv_params, *, lmax, mmax, c_out,
                             extra, num_gauss, cutoff, width_scalar):
    if msg_s.device.type == "cpu":
        return eqv2_attn_conv1_reference(
            dist, mask, emb_s, emb_t, msg_s, msg_t, rad_params, conv_params, lmax=lmax, mmax=mmax, c_out=c_out,
            extra=extra, num_gauss=num_gauss, cutoff=cutoff, width_scalar=width_scalar)
    packed, lead, m, n_act, c, e_dim = _attn_conv1_prepare(
        dist, emb_s, msg_s, rad_params, conv_params, lmax=lmax, mmax=mmax, num_gauss=num_gauss)
    names = ("wg", "ws", "wt", "b0", "ln0_scale", "ln0_bias", "w1", "b1", "ln1_scale", "ln1_bias", "w2", "b2", "bm0")
    tensors = dict(dist=dist, mask=mask, emb_s=emb_s, emb_t=emb_t, msg_s=msg_s, msg_t=msg_t,
                   **dict(zip(names, packed.trunk)), wconv=packed.flat_conv)
    _check_cuda_inputs("eqv2_attn_conv1", tensors, {"mask": torch.bool})
    n_blocks = packed.n_blocks
    if n_act != n_blocks[0] + 2 * sum(n_blocks[1:]):
        raise ValueError(f"eqv2_attn_conv1: msg_s has {n_act} rows, lmax {lmax} / mmax {mmax} need "
                         f"{n_blocks[0] + 2 * sum(n_blocks[1:])}")
    hidden = packed.trunk[10].shape[0]
    vec = (hidden,)
    _check_shapes("eqv2_attn_conv1", tensors, dict(
        mask=lead, emb_s=lead + (e_dim,), emb_t=lead + (e_dim,), msg_s=lead + (n_act, c), msg_t=lead + (n_act, c),
        wg=(num_gauss, hidden), ws=(e_dim, hidden), wt=(e_dim, hidden), b0=vec, ln0_scale=vec, ln0_bias=vec,
        w1=(hidden, hidden), b1=vec, ln1_scale=vec, ln1_bias=vec, w2=(hidden, 2 * sum(n_blocks) * c),
        b2=(2 * sum(n_blocks) * c,), bm0=(extra + n_blocks[0] * c_out,)))
    conv_shapes = [(n_blocks[0] * c, extra + n_blocks[0] * c_out)] * 2
    for nb in n_blocks[1:]:
        conv_shapes += [(nb * c, nb * c_out)] * 4
    _check_shapes("eqv2_attn_conv1", {f"conv[{i}]": t for i, t in enumerate(packed.conv)},
                  {f"conv[{i}]": shape for i, shape in enumerate(conv_shapes)})
    extra_out = torch.empty(lead + (extra,), dtype=torch.float32, device=msg_s.device)
    h = torch.empty(lead + (n_act, c_out), dtype=torch.float32, device=msg_s.device)
    if m == 0:  # empty output: nothing to launch
        return h, extra_out
    common = (*(t.data_ptr() for t in (dist, mask, emb_s, emb_t, msg_s, msg_t)),
              *(t.data_ptr() for t in packed.trunk), packed.flat_conv.data_ptr(), extra_out.data_ptr(), h.data_ptr(),
              m, num_gauss, e_dim, hidden, c, c_out, extra, (ctypes.c_int * len(n_blocks))(*n_blocks), len(n_blocks),
              float(cutoff), float(width_scalar))
    if attn_conv1_route(e_dim, hidden, c, c_out, extra, n_blocks) == "wide":
        lib = _library("eqv2_attn_conv1_wide", [ctypes.c_void_p] * 22 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        _launch("eqv2_attn_conv1_wide", lib, msg_s.device, *common, count_as="eqv2_attn_conv1")
        return h, extra_out
    plan = attn_conv1_plan(m, num_gauss, e_dim, hidden, c, c_out, extra, n_blocks, _sm_count(msg_s.device))
    lib = _library("eqv2_attn_conv1", [ctypes.c_void_p] * 22 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float, ctypes.c_float]
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    _launch("eqv2_attn_conv1", lib, msg_s.device, *common, plan.blocks, plan.smem_bytes)
    return h, extra_out


def _gather_rows(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``x [B, N, ...]`` at ``src [B, N, K]`` -> ``[B, N, K, ...]``."""
    return x[torch.arange(src.shape[0], device=src.device)[:, None, None], src.long()]


def eqv2_edge_rotate_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, lmax: int, mmax: int, *,
                               direction: str, n_sel: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`eqv2_edge_rotate`: the decomposed chain
    of :mod:`adsorbdiff_tpu_torch.models.so3` (``rotate_to_edge_m`` /
    ``rotate_from_edge_m``), whose ``[..., 2 dim, C]`` stages are materialised."""
    n_sel = so3.n_act_rows(lmax, mmax) if n_sel is None else n_sel
    if direction == "to":
        return so3.rotate_to_edge_m(x, gamma, beta, lmax, mmax, n_rows=n_sel)
    if direction != "from":
        raise ValueError(f"unknown rotation direction {direction!r}")
    if x.shape[-2] != n_sel:
        raise ValueError(f"eqv2_edge_rotate: direction 'from' takes n_sel = {n_sel} rows, got {x.shape[-2]}")
    return so3.rotate_from_edge_m(x, gamma, beta, lmax, mmax)


def eqv2_gather_rotate_to_reference(x: torch.Tensor, src: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                                    lmax: int, mmax: int, *, n_sel: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`eqv2_gather_rotate_to`: the gathered
    ``[B, N, K, dim, C]`` rows, then :func:`eqv2_edge_rotate_reference`."""
    return eqv2_edge_rotate_reference(_gather_rows(x, src), gamma, beta, lmax, mmax, direction="to", n_sel=n_sel)


def eqv2_edge_rotate(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, lmax: int, mmax: int, *,
                     direction: str, n_sel: Optional[int] = None) -> torch.Tensor:
    """EquiformerV2's truncated edge-frame Wigner rotation, fused
    (``csrc/eqv2_edge_rotate.cu``): the chain's intermediates never reach
    device memory.

    ``direction="to"``: ``x [..., (lmax+1)^2, C]`` -> the first ``n_sel``
    truncated m-primary edge-frame rows ``[..., n_sel, C]`` (as
    ``so3.rotate_to_edge_m``); ``direction="from"``: ``x [..., n_sel, C]`` ->
    ``[..., (lmax+1)^2, C]`` (as ``so3.rotate_from_edge_m``).  ``n_sel``
    defaults to the active-row count.  ``gamma``/``beta`` are the per-edge
    angles ``[...]``; x's leading dims equal theirs, or equal them with a 1
    on the last axis (a node row shared by its K edges, read by index: the
    K-broadcast copy never exists).  Returns f32 with the angles' leading
    dims.  On the card: f32 contiguous x and angles, lmax <= 6.  When
    autograd needs a gradient the call goes through :class:`EqV2EdgeRotate`.
    """
    return _rotate(x, None, gamma, beta, lmax, mmax, direction, n_sel)


def eqv2_gather_rotate_to(x: torch.Tensor, src: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, lmax: int,
                          mmax: int, *, n_sel: Optional[int] = None) -> torch.Tensor:
    """The source-node gather fused into the rotation: ``x [B, N, dim, C]``
    node coefficients, ``src [B, N, K]`` int32 neighbour indices; returns
    ``eqv2_edge_rotate(x[b, src[b, n, k]], gamma, beta, ..., direction="to")``
    ``[B, N, K, n_sel, C]``, the kernel reading the source rows by index (no
    gathered copy exists).  Its VJP scatters the dual rotation's per-edge
    rows back to the source nodes (``index_add_``)."""
    return _rotate(x, src, gamma, beta, lmax, mmax, "to", n_sel)


def _rotate(x, src, gamma, beta, lmax, mmax, direction, n_sel):
    n_sel = so3.n_act_rows(lmax, mmax) if n_sel is None else int(n_sel)
    if torch.is_grad_enabled() and x.requires_grad:
        return EqV2EdgeRotate.apply(x, src, gamma, beta, lmax, mmax, direction, n_sel)
    return _rotate_forward(x, src, gamma, beta, lmax, mmax, direction, n_sel)


def _rotate_forward(x, src, gamma, beta, lmax, mmax, direction, n_sel) -> torch.Tensor:
    if x.device.type == "cpu":
        if src is not None:
            return eqv2_gather_rotate_to_reference(x, src, gamma, beta, lmax, mmax, n_sel=n_sel)
        return eqv2_edge_rotate_reference(x, gamma, beta, lmax, mmax, direction=direction, n_sel=n_sel)
    kernel = "eqv2_edge_rotate"
    tensors = dict(x=x, gamma=gamma, beta=beta, **({} if src is None else {"src": src}))
    _check_cuda_inputs(kernel, tensors, {"src": torch.int32})
    if direction not in ("to", "from"):
        raise ValueError(f"unknown rotation direction {direction!r}")
    dim = (lmax + 1) ** 2
    if not 1 <= lmax <= 6:
        raise ValueError(f"{kernel}: the kernel takes 1 <= lmax <= 6, got {lmax}")
    if not 0 < n_sel <= dim:
        raise ValueError(f"{kernel}: n_sel must be in [1, {dim}], got {n_sel}")
    n_in, n_out = (dim, n_sel) if direction == "to" else (n_sel, dim)
    lead = tuple(gamma.shape)
    c = x.shape[-1]
    _check_shapes(kernel, tensors, {"beta": lead})
    kdiv, nk, n_nodes = 1, 1, 1
    if src is not None:
        if len(lead) != 3 or x.dim() != 4:
            raise ValueError(f"{kernel}: the gather takes x [B, N, dim, C] and src [B, N, K]")
        b, n, k = lead
        _check_shapes(kernel, tensors, {"src": lead, "x": (b, x.shape[1], n_in, c)})
        nk, n_nodes = n * k, x.shape[1]
    elif tuple(x.shape[:-2]) == lead[:-1] + (1,) and lead[-1] != 1:
        kdiv = lead[-1]  # a node row shared by the K edges of its target
        _check_shapes(kernel, tensors, {"x": lead[:-1] + (1, n_in, c)})
    else:
        _check_shapes(kernel, tensors, {"x": lead + (n_in, c)})
    out = torch.empty(lead + (n_out, c), dtype=torch.float32, device=x.device)
    e = math.prod(lead)
    if e * c == 0:  # empty output: nothing to launch
        return out
    j_blocks, sign, row = so3.edge_rot_consts(lmax, mmax, n_sel)  # contiguous host arrays, cached
    lib = _library(kernel, [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    _launch(kernel, lib, x.device, x.data_ptr(), None if src is None else src.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr(), e, c, n_in, n_out, kdiv, nk, n_nodes, lmax, int(direction == "to"),
            j_blocks.ctypes.data, sign.ctypes.data, row.ctypes.data)
    return out


class EqV2EdgeRotate(torch.autograd.Function):
    """:func:`eqv2_edge_rotate` / :func:`eqv2_gather_rotate_to` with their VJP.

    The rotation is linear in x and Dz(t)^T = Dz(-t), so the VJP of one
    direction is the other direction at the same angles
    (``pallas_kernels.py::_edge_rot_bwd``): one launch of the same kernel on
    the per-edge cotangent.  A node row shared by K edges then sums its K
    rows; the gather variant adds each edge's row to its source node
    (``index_add_``, outside the kernel as the one-hot gather's transpose was
    outside the TPU kernel).  The angles get no gradient (the geometry
    contract: score losses never differentiate through positions).
    """

    @staticmethod
    def forward(ctx, x, src, gamma, beta, lmax, mmax, direction, n_sel):
        ctx.save_for_backward(src, gamma, beta)
        ctx.meta = (lmax, mmax, direction, n_sel, tuple(x.shape), x.dtype)
        return _rotate_forward(x, src, gamma, beta, lmax, mmax, direction, n_sel)

    @staticmethod
    def backward(ctx, ct):
        src, gamma, beta = ctx.saved_tensors
        lmax, mmax, direction, n_sel, x_shape, dtype = ctx.meta
        dual = "from" if direction == "to" else "to"
        d = _rotate_forward(ct.contiguous(), None, gamma, beta, lmax, mmax, dual, n_sel)
        if src is not None:
            b, n = x_shape[:2]
            idx = (torch.arange(b, device=src.device)[:, None, None] * n + src.long()).reshape(-1)
            dx = torch.zeros((b * n,) + x_shape[2:], dtype=d.dtype, device=d.device)
            dx = dx.index_add_(0, idx, d.reshape((-1,) + x_shape[2:])).reshape(x_shape)
        elif tuple(d.shape) != x_shape:
            dx = d.sum(dim=-3, keepdim=True)  # the K edges of a shared node row
        else:
            dx = d
        return dx.to(dtype), None, None, None, None, None, None, None
