"""Hopper kernels of the port and their plain PyTorch versions.

Counterpart of :mod:`adsorbdiff_tpu.ops.pallas_kernels`.  Each kernel has:

- a wrapper with the JAX function's name and signature, which checks its
  inputs, allocates the outputs and, on a CUDA tensor, launches the kernel
  (built from ``csrc/`` on first use) or raises.  On a CPU tensor it calls the
  plain version: that is the only way the plain version is reached;
- a plain PyTorch version (``*_reference``) with the same signature (less
  the consumers' ``ti``, which sets nothing), for the CPU tests and for
  holding the kernel against on the card;
- a launch count in :data:`launches`, raised by one where the wrapper
  launches the kernel and nowhere else.

Eight kernels also take bf16 (the models' ``compute_dtype: bfloat16``), each
rounding where its TPU kernel rounds: ``painn_message_fused`` and its
backward (bf16 ``xh``, ``vec`` bf16 or f32), ``masked_legendre_cos`` (a
bf16 output), ``gemnet_quad_chain`` (a bf16 output), ``s2_grid_silu`` and
its backward (bf16 ``h``, ``dy`` and output), ``eqv2_edge_rotate`` in all
three forms (bf16 ``x`` and output) and ``eqv2_attn_conv1`` (bf16 messages
and outputs).  Their plain versions take the same dtypes and round at the
same points; a launch of a bf16 variant counts under ``<kernel>.bf16``.  Five
bf16 forms are kernels of their own, whose products run on the bf16 tensor
cores: ``csrc/painn_message_fused_bf16.cu``, ``csrc/s2_grid_silu_bf16.cu``
(with the backward), ``csrc/eqv2_attn_conv1_bf16.cu`` and
``csrc/eqv2_edge_rotate_bf16.cu``; the others are entries of their f32
kernel's source.

A kernel with a backward is wrapped in a ``torch.autograd.Function``
(:class:`PainnMessageFused`, :class:`S2GridSilu`, :class:`EqV2AttnConv1`,
:class:`EqV2EdgeRotate`, :class:`GemnetQuadChain`), which the forward wrapper
routes through only when autograd needs a gradient.  On CPU tensors a
Function's forward and backward are the plain versions, so the CPU tests
reach its backward too.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

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
    filt = fused_rbf_filter_reference(dist, mask, weights, bias, cutoff=cutoff, envelope_exponent=envelope_exponent)
    return _message_from_filter(filt, unit, xh_gathered, vec_gathered)


def _message_from_filter(filt: torch.Tensor, unit: torch.Tensor, xh_gathered: torch.Tensor,
                         vec_gathered: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The message sums over K of the gathered rows times the filter
    ``[..., K, 3H]``, in f32."""
    h = filt.shape[-1] // 3
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
    filter and gathered features are materialised).  With bf16 ``xh`` the
    basis and W are rounded to bf16 before the filter product, which sums in
    f32 (the TPU kernel's ``basis.astype(cdt)`` against ``weights.astype(cdt)``);
    the gathers are exact and every later product is f32."""
    b, n, k = src.shape
    f3 = weight.shape[1]
    idx = src.reshape(b, n * k, 1).long().expand(-1, -1, f3)
    xh_g = torch.gather(xh.float(), 1, idx).reshape(b, n, k, f3)
    vec_g = torch.gather(vec.float(), 1, idx).reshape(b, n, k, f3)
    if xh.dtype == torch.float32:
        return painn_message_consumer_reference(dist, mask, unit, xh_g, vec_g, weight, bias, cutoff=cutoff,
                                                envelope_exponent=envelope_exponent)
    basis = message_basis(dist, weight.shape[0], cutoff, envelope_exponent).to(xh.dtype).float()
    filt = (basis @ weight.to(xh.dtype).float() + bias.float()) * mask[..., None].float()
    return _message_from_filter(filt, unit, xh_g, vec_g)


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
    db [3H])`` f32; the ``[B, N, K, 3H]`` edge tensors are materialised.
    bf16 ``xh``/``vec`` are widened exactly; the recomputed basis and W stay
    f32 (unlike the forward's: the TPU backward does not round them)."""
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


def _library(name: str, argtypes, variants: Tuple[str, ...] = ("f32",)) -> ctypes.CDLL:
    """Kernel ``name``'s library, built on first use; its C entry points are
    ``<name>_<variant>(..., stream)`` (one signature, ``argtypes``) returning
    a cudaError code, and ``<name>_error_string(code)`` names the code."""
    lib = build.load(name)
    for variant in variants:
        fn = getattr(lib, f"{name}_{variant}")
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    msg = getattr(lib, name + "_error_string")
    if msg.argtypes is None:
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
            shape: Optional[str] = None, variant: str = "f32") -> None:
    """Call ``<kernel>_<variant>(*args, stream)`` on the current stream of
    ``device`` (made the current device for the call where it is not);
    raise on a non-zero cudaError (naming ``shape`` where given), else count
    the launch under ``count_as`` (default ``kernel``)."""
    fn = getattr(lib, f"{kernel}_{variant}")
    if device.index == torch.cuda.current_device():
        err = fn(*args, _raw_stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _raw_stream(device))
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
    scale.  ``xh`` and ``vec`` are f32, or ``xh`` bf16 with ``vec`` bf16 or
    f32 (the bf16 variant: basis and W rounded to bf16 before the filter
    product, as the TPU kernel rounds them); everything else f32.  On the
    card: contiguous inputs, ``src`` int32, ``mask`` bool; f32 ``xh``
    launches :func:`painn_fwd_plan`'s f32 kernel, bf16 ``xh``
    ``csrc/painn_message_fused_bf16.cu`` (the filter product on the bf16
    tensor cores, W packed by :func:`pack_painn_message_bf16`, the launch
    :func:`painn_bf16_plan`'s, a pre-pass making the basis fragments once
    into a scratch tensor; H a multiple of 4), counted under
    ``painn_message_fused.bf16`` (one count a call).  When autograd needs a
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
    variant = _message_variant("painn_message_fused", xh, vec)
    _check_cuda_inputs("painn_message_fused", tensors,
                       {"src": torch.int32, "mask": torch.bool, "xh": xh.dtype, "vec": vec.dtype})
    b, n, k, r, h = _message_shape("painn_message_fused", tensors)

    if b * n * h == 0:  # empty output: nothing to launch
        return xh.new_empty((b, n, h)), xh.new_empty((b, n, 3, h))
    if k == 0:  # no slots: the sums are empty
        return xh.new_zeros((b, n, h), dtype=torch.float32), xh.new_zeros((b, n, 3, h), dtype=torch.float32)
    dx = torch.empty((b, n, h), dtype=torch.float32, device=xh.device)
    dvec = torch.empty((b, n, 3, h), dtype=torch.float32, device=xh.device)
    shape = f"B, N, K, R, H = {b}, {n}, {k}, {r}, {h}"
    if variant != "f32":
        plan16 = painn_bf16_plan(b, n, k, r, h, _sm_count(xh.device))
        scratch = torch.empty(plan16.scratch_bytes, dtype=torch.uint8, device=xh.device)
        lib = _library("painn_message_fused_bf16", [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float]
                       + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p], ("mma", "mma_vf32"))
        _launch(
            "painn_message_fused_bf16", lib, xh.device,
            xh.data_ptr(), vec.data_ptr(), src.data_ptr(), dist.data_ptr(), mask.data_ptr(), unit.data_ptr(),
            pack_painn_message_bf16(weight).data_ptr(), bias.data_ptr(), dx.data_ptr(), dvec.data_ptr(),
            scratch.data_ptr(), b, n, k, r, h, 1.0 / cutoff, int(envelope_exponent), plan16.tpb, plan16.w_stride,
            plan16.smem_bytes, plan16.range_off, plan16.record_off, plan16.scratch_bytes, shape=shape,
            variant="mma" if variant == "bf16" else "mma_vf32", count_as="painn_message_fused.bf16",
        )
        return dx, dvec
    plan = painn_fwd_plan(b, n, k, r, h, _sm_count(xh.device))
    lib = _library("painn_message_fused", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    _launch(
        "painn_message_fused", lib, xh.device,
        xh.data_ptr(), vec.data_ptr(), src.data_ptr(), dist.data_ptr(), mask.data_ptr(),
        unit.data_ptr(), weight.data_ptr(), bias.data_ptr(), dx.data_ptr(), dvec.data_ptr(),
        b, n, k, r, h, 1.0 / cutoff, int(envelope_exponent), plan.tpb, int(plan.stage_w), int(plan.stage_rows),
        plan.rows, plan.smem_bytes, shape=shape,
    )
    return dx, dvec


# the backward's C entry points (the forward's bf16 kernel has its own source): f32 rows; bf16 xh and vec rows; bf16
# xh with f32 vec rows (PaiNN's trunk in bf16 from its third layer on: the f32 scale factor widens the vector
# features there, as in JAX)
_MESSAGE_VARIANTS = ("f32", "bf16", "bf16_vf32")


def _message_variant(kernel: str, xh: torch.Tensor, vec: torch.Tensor) -> str:
    """The message kernels' entry for the dtypes of ``xh`` and ``vec``, or raise."""
    if xh.dtype == torch.float32 and vec.dtype == torch.float32:
        return "f32"
    if xh.dtype == torch.bfloat16 and vec.dtype in (torch.bfloat16, torch.float32):
        return "bf16" if vec.dtype == torch.bfloat16 else "bf16_vf32"
    raise TypeError(f"{kernel}: xh and vec must be f32, or xh bf16 with vec bf16 or f32; got {xh.dtype}, "
                    f"{vec.dtype}")


def _count_suffix(variant: str) -> str:
    """Launch-count suffix of a kernel variant: ``.bf16`` for any bf16 one."""
    return "" if variant == "f32" else ".bf16"


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


# csrc/painn_message_fused_bf16.cu's constants: warps a block (one a target), columns h a block (in each H-block),
# W^T rows a block (its six m16 tiles), slots a tile, blocks an SM its launch bounds ask for, tiles a warp of the
# pre-pass takes; the bytes of a chunk's B fragment (32 lanes x 8), of a chunk range and of a slot record; the most
# dynamic shared memory a block may take, and what an SM holds with its reservation
_PB16_WARPS, _PB16_COLS, _PB16_WROWS, _PB16_TILE, _PB16_PER_SM, _PB16_ITEMS = 8, 32, 96, 8, 2, 4
_PB16_FRAG, _PB16_RANGE, _PB16_RECORD = 256, 8, 16
_PB16_SMEM, _PB16_SMEM_SM, _PB16_RESERVED = 232448, 233472, 1024


class MessageBf16Plan(NamedTuple):
    """How :func:`painn_message_fused` with bf16 ``xh`` is launched
    (``csrc/painn_message_fused_bf16.cu``).  Its pre-pass takes one warp 4
    tiles of 8 slots (``tiles`` a target, ``basis_blocks`` blocks of 8
    warps).
    Block ``(x, y)`` of the main kernel takes targets ``[x * tpb, (x + 1) *
    tpb)`` of the ``B * N`` (any systems) and the 32 columns ``y * 32 ..``
    of each H-block; ``blocks`` = target ranges x ``slices`` of ``threads``
    threads, ``per_sm`` of them an SM (the kernel's launch bounds ask for
    two, where their shared memory fits), ``waves`` = blocks / (SMs x
    per_sm), ``load``: targets its busiest warp takes one after another.
    The layouts, which the C entry checks against what the kernels read and
    write: shared memory holds W^T's 96 rows of ``w_stride`` bf16,
    ``smem_bytes`` in all; the scratch (``scratch_bytes``) the B fragments
    (``chunks`` of 256 bytes a tile) from byte 0, the tiles' chunk ranges
    from ``range_off`` and their slot records from ``record_off``."""

    tpb: int
    slices: int
    blocks: int
    threads: int
    per_sm: int
    waves: float
    load: int
    w_stride: int
    smem_bytes: int
    tiles: int
    chunks: int
    basis_blocks: int
    range_off: int
    record_off: int
    scratch_bytes: int


@functools.lru_cache(maxsize=64)
def painn_bf16_plan(b: int, n: int, k: int, r: int, h: int, sms: int) -> MessageBf16Plan:
    """``csrc/painn_message_fused_bf16.cu``'s launch for ``b`` systems of
    ``n`` targets, ``k`` slots, ``r`` radial functions and ``h`` columns on
    a card of ``sms`` SMs.  The target range ``tpb`` (a multiple of the 8
    warps, or all targets) minimises ``ceil(waves) * (load + 1)`` (a block's
    W^T staging counted as one more target), ties to fewer blocks: at the
    sampling shape 80 targets, 10 a warp, 256 blocks in one wave of two an
    SM.  Refuses ``k < 1``, ``r < 2``, ``h`` not a multiple of 4 and an
    ``r`` whose W^T slice does not fit one block's shared memory (past
    1200)."""
    chunks = _cdiv(r, 16)
    w_stride = _odd_stride(16 * chunks)
    smem = 2 * _PB16_WROWS * w_stride
    slices = _cdiv(h, _PB16_COLS)
    if k < 1 or r < 2 or h % 4 or smem > _PB16_SMEM or slices > 65535:
        raise ValueError(f"painn_message_fused.bf16: no launch for B, N, K, R, H = {b}, {n}, {k}, {r}, {h} (the "
                         f"kernel takes K >= 1, 2 <= R <= 1200 and H a multiple of 4 up to {65535 * _PB16_COLS})")
    t, tiles = b * n, _cdiv(k, _PB16_TILE)
    items = t * tiles
    range_off = items * chunks * _PB16_FRAG
    record_off = _round_up(range_off + items * _PB16_RANGE, 16)
    per_sm = max(1, min(_PB16_PER_SM, _PB16_SMEM_SM // (smem + _PB16_RESERVED)))
    best = None
    for tpb in sorted(set(range(_PB16_WARPS, t, _PB16_WARPS)) | {t}):
        blocks = _cdiv(t, tpb) * slices
        load = _cdiv(tpb, _PB16_WARPS)
        key = (_cdiv(blocks, sms * per_sm) * (load + 1), blocks)
        if best is None or key < best[0]:
            best = key, tpb, blocks, load
    _, tpb, blocks, load = best
    return MessageBf16Plan(tpb=tpb, slices=slices, blocks=blocks, threads=32 * _PB16_WARPS, per_sm=per_sm,
                           waves=blocks / (sms * per_sm), load=load, w_stride=w_stride, smem_bytes=smem, tiles=tiles,
                           chunks=chunks, basis_blocks=_cdiv(items, _PB16_WARPS * _PB16_ITEMS), range_off=range_off,
                           record_off=record_off, scratch_bytes=record_off + items * _PB16_TILE * _PB16_RECORD)


@functools.lru_cache(maxsize=16)
def _bf16_w_columns(h: int, device: torch.device) -> torch.Tensor:
    """The W column of each of :func:`pack_painn_message_bf16`'s W^T rows,
    ``[slices, 96]``, ``3 H`` where the column is past H (a zero row)."""
    slices = _cdiv(h, _PB16_COLS)
    m = np.arange(_PB16_COLS)
    hh = 4 * (m % 8) + 2 * (m // 16) + (m // 8) % 2  # row 16 q + i of H-block j: column 4 (i % 8) + 2 q + i // 8
    cols = np.arange(slices)[:, None, None] * _PB16_COLS + hh[None, None, :]  # [slices, 1, 32]
    w_col = np.arange(3)[None, :, None] * h + cols
    return torch.from_numpy(np.where(cols < h, w_col, 3 * h).reshape(slices, _PB16_WROWS)).to(device)


def pack_painn_message_bf16(weight: torch.Tensor) -> torch.Tensor:
    """W ``[R, 3H]`` rounded to bf16 (the TPU kernel's ``weights.astype(cdt)``)
    as ``csrc/painn_message_fused_bf16.cu``'s W^T slices, ``[ceil(H / 32),
    96, w_stride]`` bf16: row ``32 j + 16 q + i`` of slice ``s`` is W's column
    ``j H + 32 s + 4 (i % 8) + 2 q + i // 8`` (so lane 4g + t of an m16n8k16
    C fragment holds four consecutive columns of each H-block), zero past R
    and past H; ``w_stride`` (:func:`painn_bf16_plan`) an odd number of
    16-byte chunks.  One gather of the padded, transposed W."""
    r, f3 = weight.shape
    h = f3 // 3
    w_stride = _odd_stride(_round_up(r, 16))
    wt = torch.zeros((f3 + 1, w_stride), dtype=torch.bfloat16, device=weight.device)
    wt[:f3, :r] = weight.t()
    return wt[_bf16_w_columns(h, weight.device)]


def painn_bf16_chunks(dist: torch.Tensor, mask: torch.Tensor, src: torch.Tensor, r: int,
                      cutoff: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 kernel's chunk rule, in Python: ``(first, last)`` ``[B, N,
    G]`` (G = ceil(K / 8)), the 16-row chunks of the basis each tile of 8
    consecutive slots multiplies: those that :func:`painn_fwd_windows`'s
    window of the tile (the union of its valid slots' reach) touches; ``last
    < first`` where no slot of the tile reaches a row."""
    lo, hi = painn_fwd_windows(dist, mask, src, r, cutoff)
    return lo // 16, torch.div(hi, 16, rounding_mode="floor")


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
    input rules (bf16 ``xh``, ``vec`` bf16 or f32: the bf16 variant, whose
    recomputed basis and W stay f32 as the TPU backward keeps them; counted
    under ``painn_message_fused_bwd.bf16``), f32 contiguous cotangents and R
    <= 128; the launch is :func:`painn_bwd_plan`'s.  The kernel adds with atomics, so the order of
    its f32 sums changes from run to run.
    """
    if xh.device.type == "cpu":
        return painn_message_fused_bwd_reference(
            xh, vec, src, dist, mask, unit, weight, bias, dx_ct, dvec_ct,
            cutoff=cutoff, envelope_exponent=envelope_exponent,
        )
    tensors = dict(xh=xh, vec=vec, src=src, dist=dist, mask=mask, unit=unit, weight=weight, bias=bias,
                   dx_ct=dx_ct, dvec_ct=dvec_ct)
    variant = _message_variant("painn_message_fused_bwd", xh, vec)
    _check_cuda_inputs("painn_message_fused_bwd", tensors,
                       {"src": torch.int32, "mask": torch.bool, "xh": xh.dtype, "vec": vec.dtype})
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
                   + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p], _MESSAGE_VARIANTS)
    _launch(
        "painn_message_fused_bwd", lib, xh.device,
        xh.data_ptr(), vec.data_ptr(), src.data_ptr(), dist.data_ptr(), mask.data_ptr(), unit.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), dx_ct.data_ptr(), dvec_ct.data_ptr(),
        dxh.data_ptr(), dvec.data_ptr(), dw.data_ptr(), db.data_ptr(), scratch.data_ptr(),
        b, n, k, r, h, 1.0 / cutoff, int(envelope_exponent), plan.cols, int(plan.stage_rows),
        int(plan.global_scatter), plan.smem_bytes, variant=variant,
        count_as="painn_message_fused_bwd" + _count_suffix(variant),
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
    1/sqrt(H) scale.  ``ti`` (>= 1) is kept for API stability, as JAX keeps
    it: the launch is :func:`consumer_plan`'s whatever ``ti`` is.  On the
    card: f32 contiguous inputs, ``mask`` bool, no gradient (the JAX
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
    """:func:`painn_message_consumer` under the name of the JAX multi-target
    kernel (``ti`` targets a program there, default 8).  One kernel serves
    both names and takes its launch from :func:`consumer_plan`; ``ti`` (>= 1)
    is checked and sets nothing.  Its launches count under this name."""
    return _consumer("painn_message_consumer_tiled", dist, mask, unit, xh_gathered, vec_gathered, weights, bias,
                     cutoff, envelope_exponent, ti)


def _consumer(name, dist, mask, unit, xh_gathered, vec_gathered, weights, bias, cutoff, envelope_exponent, ti):
    if int(ti) < 1:
        raise ValueError(f"{name}: ti must be >= 1, got {ti}")
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
    h = f3 // 3
    if m * h == 0:  # empty output: nothing to launch
        return dist.new_empty((m, h)), dist.new_empty((m, 3, h))
    if k == 0:  # no slots: the sums are empty
        return dist.new_zeros((m, h)), dist.new_zeros((m, 3, h))
    plan = consumer_plan(m, k, r, h, _sm_count(dist.device))
    dx = torch.empty((m, h), dtype=torch.float32, device=dist.device)
    dvec = torch.empty((m, 3, h), dtype=torch.float32, device=dist.device)
    vec2 = plan.vec and all(t.data_ptr() % 8 == 0 for t in (xh_gathered, vec_gathered))
    lib = _library("painn_message_consumer", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    _launch(
        "painn_message_consumer", lib, dist.device,
        dist.data_ptr(), mask.data_ptr(), unit.data_ptr(), xh_gathered.data_ptr(), vec_gathered.data_ptr(),
        weights.data_ptr(), bias.data_ptr(), dx.data_ptr(), dvec.data_ptr(),
        m, k, r, h, 1.0 / cutoff, int(envelope_exponent), plan.chunks, int(plan.stage_w), int(vec2),
        plan.smem_bytes, count_as=name, shape=f"M, K, R, H = {m}, {k}, {r}, {h}",
    )
    return dx, dvec


# csrc/painn_message_consumer.cu's constants: owners (warps) a block, columns h a block, slots a group, basis rows a
# pass, targets an owner sums at a time, slots it sorts at a time, sort keys; the most dynamic shared memory a block
# may take (the kernel has no static shared memory)
_CS_OWNERS, _CS_COLS, _CS_GROUP, _CS_WIN = 8, 64, 8, 48
_CS_BATCH, _CS_SLOTS, _CS_KEYS = 4, 256, 128
_CS_SMEM = 232448


class ConsumerPlan(NamedTuple):
    """How :func:`painn_message_consumer` is launched: ``blocks`` = ``chunks``
    x ``slices`` blocks of ``threads`` threads, one an SM; block ``b`` owns
    the 64 columns ``64 (b % slices) ..`` (with their H + h and 2H + h) and
    the targets ``[c M // chunks, (c + 1) M // chunks)`` of chunk ``c = b //
    slices``, owner (warp) ``o`` of it the targets ``o, o + 8, ..`` of the
    chunk; ``stage_w``: W's columns copied to shared memory (else read
    through L1/L2); ``vec``: H even, float2 loads and stores;
    ``smem_bytes`` a block; ``load``: the most targets an owner takes;
    ``waves`` = blocks / SMs."""

    slices: int
    chunks: int
    blocks: int
    threads: int
    stage_w: bool
    vec: bool
    smem_bytes: int
    load: int
    waves: float


def consumer_smem(r: int, stage_w: bool) -> int:
    """The consumer kernel's dynamic shared bytes: the owners' ``[48 x 8 +
    16]`` basis buffers and ``[4][4][64]`` sums, W's ``[R][3][64]`` columns
    (``stage_w``), the bias columns, the owners' sort counts (132 ints),
    slot distances (256 f32), sorted slots and keys (2 x 256 uint16)."""
    floats = _CS_OWNERS * (_CS_WIN * _CS_GROUP + 16 + _CS_BATCH * 4 * _CS_COLS) + 3 * r * _CS_COLS * stage_w \
        + 3 * _CS_COLS
    return 4 * floats + 4 * _CS_OWNERS * (_CS_KEYS + 4) + 8 * _CS_OWNERS * _CS_SLOTS


@functools.lru_cache(maxsize=64)
def consumer_plan(m: int, k: int, r: int, h: int, sms: int) -> ConsumerPlan:
    """``csrc/painn_message_consumer.cu``'s launch for ``m`` targets, ``k``
    slots, ``r`` radial functions and ``h`` columns on a card of ``sms`` SMs:
    ``slices = ceil(h / 64)`` column slices, each cut into the same
    ``chunks`` target chunks, so that the blocks of a chunk (one a slice) run
    side by side; ``chunks = sms // slices`` (at least 1, at most m): one
    wave of one block an SM where the slices are fewer than the SMs (at M =
    1280, H = 512: 16 chunks of 80 targets x 8 slices = 128 blocks, 10
    targets a warp).  W's columns are staged where they fit (R <= 215).
    Refuses ``m < 1``, ``k < 1``, ``h < 1``, ``r < 2``, ``m k >= 2^31`` and
    grids past 2^31 - 1 blocks."""
    slices = _cdiv(h, _CS_COLS)
    if m < 1 or k < 1 or h < 1 or r < 2 or m * k > 2**31 - 1 or slices > 2**31 - 1:
        raise ValueError(f"painn_message_consumer: no launch for M, K, R, H = {m}, {k}, {r}, {h} (the kernel takes "
                         f"M, K, H >= 1, R >= 2 and M K < 2^31)")
    chunks = max(1, min(m, sms // slices))
    stage_w = consumer_smem(r, True) <= _CS_SMEM
    return ConsumerPlan(slices=slices, chunks=chunks, blocks=chunks * slices, threads=32 * _CS_OWNERS,
                        stage_w=stage_w, vec=h % 2 == 0, smem_bytes=consumer_smem(r, stage_w),
                        load=_cdiv(_cdiv(m, chunks), _CS_OWNERS), waves=chunks * slices / sms)


def consumer_work(plan: ConsumerPlan, m: int):
    """The kernel's work in Python: ``(block, owner, target, slice)`` for
    every target an owner takes."""
    for b in range(plan.blocks):
        s, c = b % plan.slices, b // plan.slices
        t0, t1 = c * m // plan.chunks, (c + 1) * m // plan.chunks
        for t in range(t0, t1):
            yield b, (t - t0) % _CS_OWNERS, t, s


def consumer_windows(dist: torch.Tensor, mask: torch.Tensor, r: int, cutoff: float,
                     plan: ConsumerPlan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The consumer kernel's groups and windows, in Python: ``(lo, hi,
    slots)``, for each group ``g`` the basis rows ``[lo, hi]`` it runs
    (``hi < lo``: none) and its slots' flat indices ``t K + k`` ``[G, 8]``
    (-1 past the end of a run).  An owner takes the targets ``o, o + 8, ..``
    of its chunk in batches of at most 4 targets and 256 slots (a
    target cut in runs of 256 slots where K > 256), sorts each run's unmasked
    slots stably by key (``bin * 128 // R`` for a slot before the cutoff,
    ``bin = floor(dist * (1 / cutoff) * (R - 1))`` in f32 cut to R - 1; 128
    after it) and groups 8 consecutive sorted slots; a group's window is the
    union of ``[bin - 14, bin + 15]`` (cut to ``[0, R)``) over its slots
    before the cutoff."""
    m, k = dist.shape
    d = dist.reshape(-1).float() * (1.0 / cutoff)
    bins = torch.clamp((d * float(r - 1)).to(torch.int64), max=r - 1)
    reach = d < 1.0
    key = torch.where(reach, bins * _CS_KEYS // r, torch.full_like(bins, _CS_KEYS))
    key = torch.where(mask.reshape(-1), key, torch.full_like(key, -1))
    per_batch = max(1, min(_CS_BATCH, _CS_SLOTS // k))
    runs = []
    for c in range(plan.chunks):
        t0, t1 = c * m // plan.chunks, (c + 1) * m // plan.chunks
        for o in range(_CS_OWNERS):
            targets = list(range(t0 + o, t1, _CS_OWNERS))
            if not targets:
                continue
            bsize = _cdiv(len(targets), _cdiv(len(targets), per_batch))
            for i0 in range(0, len(targets), bsize):
                rows = (torch.tensor(targets[i0:i0 + bsize])[:, None] * k + torch.arange(k)).reshape(-1)
                runs += [rows[s0:s0 + _CS_SLOTS] for s0 in range(0, rows.numel(), _CS_SLOTS)]
    los, his, groups = [], [], []
    for run in runs:
        run = run[key[run] >= 0]
        run = run[torch.argsort(key[run], stable=True)]
        pad = -run.numel() % _CS_GROUP
        slots = torch.nn.functional.pad(run, (0, pad), value=-1).reshape(-1, _CS_GROUP)
        ok = (slots >= 0) & reach[slots.clamp(min=0)]
        b = bins[slots.clamp(min=0)]
        los.append(torch.where(ok, torch.clamp(b - 14, min=0), torch.full_like(b, r)).amin(-1))
        his.append(torch.where(ok, torch.clamp(b + 15, max=r - 1), torch.full_like(b, -1)).amax(-1))
        groups.append(slots)
    if not groups:
        empty = torch.zeros(0, dtype=torch.int64)
        return empty, empty, empty.reshape(0, _CS_GROUP)
    return torch.cat(los), torch.cat(his), torch.cat(groups)


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
    ``mask`` bool, no gradient; the launch is :func:`rbf_filter_plan`'s.
    No model calls it.
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
    plan = rbf_filter_plan(e, r, f, _sm_count(dist.device))
    lib = _library("fused_rbf_filter", [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    _launch("fused_rbf_filter", lib, dist.device, dist.data_ptr(), mask.data_ptr(), weights.data_ptr(),
            bias.data_ptr(), out.data_ptr(), e, r, f, 1.0 / cutoff, int(envelope_exponent), plan.blocks,
            int(plan.stage_w), int(plan.vec), plan.smem_bytes, shape=f"E, R, F = {e}, {r}, {f}")
    return out


# csrc/fused_rbf_filter.cu's constants: warps a block, edges a chunk (one a thread), output columns a block, edges
# a warp's tile, basis rows a pass, the rows [bin - 14, bin + 15] of an edge's non-zero basis values, the most
# shared memory a block may take, blocks an SM at most (its launch bounds)
_RF_WARPS, _RF_CHUNK, _RF_COLS, _RF_GROUP, _RF_PASS, _RF_REACH = 12, 384, 128, 8, 48, 14
_RF_SMEM, _RF_BLOCKS_PER_SM = 232448, 2


class RbfFilterPlan(NamedTuple):
    """How :func:`fused_rbf_filter` is launched: ``blocks`` persistent blocks
    of ``threads`` threads, ``blocks_per_sm`` an SM; block ``b`` owns the
    128-column slice ``b % slices`` (columns ``128 s ..``) and takes the
    chunks of 384 consecutive edges ``b // slices, b // slices + blocks /
    slices, ..`` of the ``chunks``; ``stage_w``: W's slice staged in shared
    memory (else read through L1/L2); ``vec``: F % 4 == 0, float4 loads and
    stores; ``smem_bytes`` a block; ``spread``: the most chunks a block
    takes over the mean."""

    slices: int
    chunks: int
    blocks: int
    threads: int
    blocks_per_sm: int
    stage_w: bool
    vec: bool
    smem_bytes: int
    spread: float


def rbf_filter_smem(r: int, stage_w: bool) -> int:
    """The kernel's dynamic shared bytes: W's ``[R][128]`` slice
    (``stage_w``), the bias columns, the warps' ``[48][8]`` basis buffers,
    the ``r / (R - 1)`` table, the ``R + 1`` counts of the sort and the
    chunk's sorted edge, keep, d and envelope."""
    return 4 * (_RF_COLS * r * stage_w + _RF_COLS + _RF_WARPS * _RF_PASS * _RF_GROUP + r + (r + 1) + 4 * _RF_CHUNK)


@functools.lru_cache(maxsize=64)
def rbf_filter_plan(e: int, r: int, f: int, sms: int) -> RbfFilterPlan:
    """``csrc/fused_rbf_filter.cu``'s launch for ``e`` edges, ``r`` radial
    functions and ``f`` columns on a card of ``sms`` SMs: W's slice is staged
    where it fits (R <= 398; 91,652 B at R = 128, two blocks an SM), blocks
    fill the SMs' block slots, a whole number a column slice, one a slice at
    least and at most one a chunk.  Refuses ``e < 1``, ``f < 1``, ``r < 2``
    and R past what even the unstaged layout holds."""
    if e < 1 or f < 1 or r < 2 or rbf_filter_smem(r, False) > _RF_SMEM:
        raise ValueError(f"fused_rbf_filter: no launch for E, R, F = {e}, {r}, {f} (the kernel takes E, F >= 1 and "
                         f"2 <= R with its tables within {_RF_SMEM} bytes of shared memory)")
    stage_w = rbf_filter_smem(r, True) <= _RF_SMEM
    smem = rbf_filter_smem(r, stage_w)
    per_sm = min(_RF_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024))
    slices, chunks = _cdiv(f, _RF_COLS), _cdiv(e, _RF_CHUNK)
    per_slice = max(1, min(chunks, per_sm * sms // slices))
    return RbfFilterPlan(slices=slices, chunks=chunks, blocks=slices * per_slice, threads=32 * _RF_WARPS,
                         blocks_per_sm=per_sm, stage_w=stage_w, vec=f % 4 == 0, smem_bytes=smem,
                         spread=_cdiv(chunks, per_slice) * per_slice / chunks)


def rbf_filter_work(plan: RbfFilterPlan):
    """The kernel's work in Python: ``(block, chunk, slice)`` for every
    chunk a block takes."""
    per_slice = plan.blocks // plan.slices
    for b in range(plan.blocks):
        for ch in range(b // plan.slices, plan.chunks, per_slice):
            yield b, ch, b % plan.slices


def rbf_filter_windows(dist: torch.Tensor, mask: torch.Tensor, r: int,
                       cutoff: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's groups and windows, in Python: ``(lo, hi, edges)``, for
    each group ``g`` of 8 edges the basis rows ``[lo, hi]`` the kernel runs
    (``hi < lo``: none) and the flattened indices of its edges ``[G, 8]``
    (-1 past the end).  Each chunk of 384 consecutive edges is sorted by key
    (``bin = floor(dist * (1 / cutoff) * (R - 1))`` in f32, cut to R - 1, for
    an unmasked edge before the cutoff, else R), stably (the kernel's order
    within a key is the atomics', which changes no group's keys); its groups
    are runs of 8 sorted edges, a group's window the union of ``[bin - 14,
    bin + 15]`` (cut to ``[0, R)``) over its edges with a bin."""
    d = dist.reshape(-1).float() * (1.0 / cutoff)
    e = d.numel()
    bins = torch.clamp((d * float(r - 1)).to(torch.int32), max=r - 1)
    key = torch.where(mask.reshape(-1) & (d < 1.0), bins, torch.full_like(bins, r))
    chunks = _cdiv(e, _RF_CHUNK)
    pad = chunks * _RF_CHUNK - e
    key = torch.nn.functional.pad(key, (0, pad), value=r + 1).reshape(chunks, _RF_CHUNK)  # r + 1: no edge
    order = torch.argsort(key, dim=1, stable=True)
    key = torch.gather(key, 1, order).reshape(-1, _RF_GROUP)
    edges = (order + torch.arange(chunks)[:, None] * _RF_CHUNK).reshape(-1, _RF_GROUP)
    edges = torch.where(key <= r, edges, torch.full_like(edges, -1))
    reach = key < r
    lo = torch.where(reach, torch.clamp(key - _RF_REACH, min=0), torch.full_like(key, r)).amin(-1)
    hi = torch.where(reach, torch.clamp(key + _RF_REACH + 1, max=r - 1), torch.full_like(key, -1)).amax(-1)
    live = (edges >= 0).any(-1)  # groups past a chunk's last edge do not exist
    return lo[live], hi[live], edges[live]


def gemnet_quad_chain_reference(
    n1: torch.Tensor,  # [B, N, U, Q, 3]
    n2: torch.Tensor,  # [B, N, Q, K2, 3]
    key1: torch.Tensor,  # [B, N, U] int
    key2: torch.Tensor,  # [B, N, Q, K2] int
    xm: torch.Tensor,  # [B, N, Q, K2, E]
    qp: torch.Tensor,  # [B, N, U, S, Q, F]
    num_spherical: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemnet_quad_chain` (the JAX
    ``_quad_chain_ref`` on f32 ``xm`` and ``qp``, then the kernel's cast to
    ``out_dtype``): the Legendre table ``[B, N, U, Q, K2, S]`` and ``d2 [B,
    N, U, Q, S, E]`` are materialised."""
    cos = torch.clamp(torch.einsum("bnuqc,bnqkc->bnuqk", _unit_rows(n1), _unit_rows(n2)), -1.0, 1.0)
    k1 = key1[:, :, :, None, None]
    keep = (k1 != key2[:, :, None, :, :]) & (k1 >= 0)
    d2 = torch.einsum("bnuqks,bnqke->bnuqse", _masked_legendre(cos, keep, num_spherical, dim=-1), xm)
    return torch.einsum("bnusqf,bnuqse->bnufe", qp, d2).to(out_dtype)


def gemnet_quad_chain(
    n1: torch.Tensor,
    n2: torch.Tensor,
    key1: torch.Tensor,
    key2: torch.Tensor,
    xm: torch.Tensor,
    qp: torch.Tensor,
    num_spherical: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """GemNet-OC's quadruplet consumer, fused: dihedral cosine, Legendre
    basis, c==d exclusion from the integer image keys, the K2 contraction
    against ``xm`` and the (S, Q) contraction against ``qp``, in one kernel
    (``csrc/gemnet_quad_chain.cu``).

    Shapes as :func:`gemnet_quad_chain_reference`; ``qp`` has the true U (no
    padding).  Returns ``outer [B, N, U, F, E]`` in ``out_dtype`` (f32 or
    bf16, rounded once from f32 sums) for the qint bilinear.  ``xm`` and
    ``qp`` are f32: GemNet-OC in bf16 passes f32 ones (its f32 scale factors
    widen them, as in the JAX model) and a bf16 ``out_dtype``.  On the card:
    f32 geometry, int32 keys, contiguous; the launch is
    :func:`quad_chain_plan`'s (a bf16 output takes S <= 8, one pass of
    levels), counted under ``gemnet_quad_chain.bf16`` for a bf16 output.
    When autograd needs a gradient of ``xm`` or
    ``qp`` the call goes through :class:`GemnetQuadChain`, whose backward
    recomputes the plain version (:func:`gemnet_quad_chain_vjp`).  The
    geometry ``n1``/``n2`` gets no gradient on the card: a CUDA call where
    either needs one raises (the JAX VJP returns zeros for them, which would
    drop a position gradient unseen); on the CPU the plain version's
    autograd gives it.
    """
    if torch.is_grad_enabled() and (n1.requires_grad or n2.requires_grad):
        if n1.device.type == "cpu":
            return gemnet_quad_chain_reference(n1, n2, key1, key2, xm, qp, num_spherical, out_dtype)
        raise NotImplementedError("gemnet_quad_chain: no gradient of the geometry n1/n2 on CUDA (the backward "
                                  "takes the cotangents of xm and qp only)")
    if torch.is_grad_enabled() and (xm.requires_grad or qp.requires_grad):
        return GemnetQuadChain.apply(n1, n2, key1, key2, xm, qp, num_spherical, out_dtype)
    return _gemnet_quad_chain_forward(n1, n2, key1, key2, xm, qp, num_spherical, out_dtype)


def _gemnet_quad_chain_forward(n1, n2, key1, key2, xm, qp, num_spherical: int,
                               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if n1.device.type == "cpu":
        return gemnet_quad_chain_reference(n1, n2, key1, key2, xm, qp, num_spherical, out_dtype)
    tensors = dict(n1=n1, n2=n2, key1=key1, key2=key2, xm=xm, qp=qp)
    if out_dtype not in _QUAD_VARIANTS:
        raise TypeError(f"gemnet_quad_chain: out_dtype must be f32 or bf16, got {out_dtype}")
    _check_cuda_inputs("gemnet_quad_chain", tensors, {"key1": torch.int32, "key2": torch.int32})
    if n1.dim() != 5 or xm.dim() != 5 or qp.dim() != 6:
        raise ValueError("gemnet_quad_chain: n1, xm and qp must be 5-, 5- and 6-dimensional")
    b, n, u, q, _ = n1.shape
    k2, e = xm.shape[3], xm.shape[4]
    s, f = num_spherical, qp.shape[-1]
    _check_shapes("gemnet_quad_chain", tensors, dict(
        n1=(b, n, u, q, 3), n2=(b, n, q, k2, 3), key1=(b, n, u), key2=(b, n, q, k2), xm=(b, n, q, k2, e),
        qp=(b, n, u, s, q, f)))

    if out_dtype == torch.bfloat16 and s > _QC_LEVELS:
        raise ValueError(f"gemnet_quad_chain: a bf16 output takes S <= {_QC_LEVELS} levels (one pass), got {s}")
    if b * n * u * f * e == 0:  # empty output: nothing to launch
        return n1.new_empty((b, n, u, f, e), dtype=out_dtype)
    plan = quad_chain_plan(b * n, u, q, k2, s, e, f, _sm_count(n1.device), qp_aligned=qp.data_ptr() % 16 == 0)
    return _quad_chain_launch(tensors, s, plan, out_dtype)


def gemnet_quad_chain_vjp(n1: torch.Tensor, n2: torch.Tensor, key1: torch.Tensor, key2: torch.Tensor,
                          xm: torch.Tensor, qp: torch.Tensor, num_spherical: int,
                          g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dxm, dqp)``, the cotangents of ``xm`` and ``qp`` for the output
    cotangent ``g [B, N, U, F, E]``: the JAX package's ``_quad_chain_bwd``,
    autograd of the plain version (:func:`gemnet_quad_chain_reference`, in
    f32, ``g`` cast to ``xm``'s dtype as JAX casts it) recomputed from
    detached ``xm`` and ``qp``.  No kernel is launched.
    ``qp`` may be padded along u past n1's U, as the JAX function allows: the
    recompute reads its first U rows, and ``dqp`` has qp's shape, zero in the
    padding."""
    xm_ = xm.detach().requires_grad_(True)
    qp_ = qp.detach().requires_grad_(True)
    with torch.enable_grad():
        out = gemnet_quad_chain_reference(n1.detach(), n2.detach(), key1, key2, xm_, qp_[:, :, : n1.shape[2]],
                                          num_spherical, xm.dtype)
        dxm, dqp = torch.autograd.grad(out, (xm_, qp_), g.to(xm.dtype))
    return dxm, dqp


class GemnetQuadChain(torch.autograd.Function):
    """:func:`gemnet_quad_chain` with its VJP.

    The forward launches the kernel once; the backward is
    :func:`gemnet_quad_chain_vjp`, a recompute of the plain version, as the
    JAX package's ``_quad_chain_bwd`` recomputes ``_quad_chain_ref`` in XLA
    (the TPU kernel has no backward kernel either).  Gradients flow to ``xm``
    and ``qp``; ``n1``, ``n2`` and the keys get none
    (:func:`gemnet_quad_chain` routes no call here whose ``n1`` or ``n2``
    needs one).  On CPU tensors the forward is the plain version.
    """

    @staticmethod
    def forward(ctx, n1, n2, key1, key2, xm, qp, num_spherical, out_dtype=torch.float32):
        ctx.save_for_backward(n1, n2, key1, key2, xm, qp)
        ctx.num_spherical = num_spherical
        return _gemnet_quad_chain_forward(n1, n2, key1, key2, xm, qp, num_spherical, out_dtype)

    @staticmethod
    def backward(ctx, g):
        n1, n2, key1, key2, xm, qp = ctx.saved_tensors
        dxm, dqp = gemnet_quad_chain_vjp(n1, n2, key1, key2, xm, qp, ctx.num_spherical, g)
        return None, None, None, None, dxm, dqp, None, None


# the quad chain's C entries by out dtype (xm and qp are f32)
_QUAD_VARIANTS = {torch.float32: "f32", torch.bfloat16: "f32_bf16"}


def _quad_chain_launch(tensors: dict, s: int, plan: "QuadChainPlan",
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch ``csrc/gemnet_quad_chain.cu`` with ``plan`` on checked inputs
    (:func:`gemnet_quad_chain`'s) and return ``out``."""
    n1, xm, qp = tensors["n1"], tensors["xm"], tensors["qp"]
    b, n, u, q, _ = n1.shape
    k2, e = xm.shape[3], xm.shape[4]
    f = qp.shape[-1]
    out = torch.empty((b, n, u, f, e), dtype=out_dtype, device=n1.device)
    variant = _QUAD_VARIANTS[out_dtype]
    lib = _library("gemnet_quad_chain", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                   + [ctypes.c_longlong, ctypes.c_void_p], tuple(_QUAD_VARIANTS.values()))
    _launch(
        "gemnet_quad_chain", lib, n1.device,
        *(tensors[name].data_ptr() for name in ("n1", "n2", "key1", "key2", "xm", "qp")), out.data_ptr(),
        b * n, u, q, k2, s, e, f, plan.warps, plan.parts, plan.qp_buffers, int(plan.copy_bytes == 16),
        plan.smem_bytes, variant=variant, count_as="gemnet_quad_chain" + _count_suffix(variant),
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
                                  num_spherical: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of :func:`masked_legendre_cos`: ``a [G, M, C]``,
    ``bt [G, C, K]``, ``keep [G, M, K]`` bool -> ``[G, S, M, K]``, computed
    in f32 and rounded once to ``out_dtype``."""
    cos = torch.clamp(torch.matmul(a.float(), bt.float()), -1.0, 1.0)
    return _masked_legendre(cos, keep, num_spherical, dim=1).to(out_dtype)


def gemnet_cbf_basis_reference(u: torch.Tensor, v: torch.Tensor, keep: torch.Tensor,
                               num_spherical: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemnet_cbf_basis`: ``u [B, N, M, 3]``,
    ``v [B, N, K, 3]`` unit rows (zero rows give cos 0), ``keep [B, N, M, K]``
    -> ``[B, N, S, M, K]`` in ``out_dtype``."""
    cos = torch.clamp(torch.einsum("bnmc,bnkc->bnmk", u.float(), v.float()), -1.0, 1.0)
    return _masked_legendre(cos, keep, num_spherical, dim=2).to(out_dtype)


def gemnet_quad_basis_reference(n1: torch.Tensor, n2: torch.Tensor, keep: torch.Tensor,
                                num_spherical: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemnet_quad_basis`: ``n1 [B, N, K1,
    Kq, 3]``, ``n2 [B, N, Kq, K2, 3]`` (normalised here, eps 1e-9), ``keep
    [B, N, K1, Kq, K2]`` -> ``[B, N, S, Kq, K1, K2]`` in ``out_dtype``."""
    cos = torch.einsum("bnuqc,bnqkc->bnquk", _unit_rows(n1.float()), _unit_rows(n2.float()))
    y = _masked_legendre(torch.clamp(cos, -1.0, 1.0), keep.permute(0, 1, 3, 2, 4), num_spherical, dim=2)
    return y.to(out_dtype)


# csrc/masked_legendre_cos.cu's constants: problems a group, threads a block, the most columns a block takes in
# whole cells (one cell where a cell has more; 1024 measured faster than 2048 and 4096 at the relaxation shape,
# scripts/variants_rbf_legendre.py)
_LG_PROBLEMS, _LG_THREADS, _LG_COLUMNS = 3, 256, 1024


class LegendreGroupPlan(NamedTuple):
    """How ``csrc/masked_legendre_cos.cu`` is launched for a group of
    problems: problem ``p`` takes blocks ``[first[p], first[p] + blocks_of[p])``,
    each of ``cpb[p]`` consecutive cells (the last one fewer), with four
    columns a thread where ``vec[p]`` (M K % 4 == 0), else one; ``blocks`` in
    all, of ``threads`` threads and ``smem_bytes`` of dynamic shared memory
    (the largest problem's staged a and b rows)."""

    first: Tuple[int, ...]
    blocks_of: Tuple[int, ...]
    cpb: Tuple[int, ...]
    vec: Tuple[bool, ...]
    blocks: int
    threads: int
    smem_bytes: int


@functools.lru_cache(maxsize=64)
def legendre_group_plan(shapes: Tuple[Tuple[int, int, int], ...]) -> LegendreGroupPlan:
    """The launch for a group of 1 to 3 problems, ``shapes`` one ``(cells, M,
    K)`` each: a block takes ``cpb = 1024 // (M K)`` cells (at least one, as
    far as their rows fit the shared memory), so that its 256 threads take
    up to 4 columns each (at the relaxation shape one cell a block: 3.5
    columns a thread for e2e at 30 x 30, 2.3 for a2e and e2a at 30 x 20);
    problems with no column take no block.  Raises where one cell's rows do
    not fit the shared memory."""
    if not 1 <= len(shapes) <= _LG_PROBLEMS:
        raise ValueError(f"masked_legendre_cos: a launch takes 1 to {_LG_PROBLEMS} problems, got {len(shapes)}")
    first, blocks_of, cpbs, vecs, smem, total = [], [], [], [], 0, 0
    for cells, m, k in shapes:
        row_bytes = 12 * (m + k)
        if row_bytes > SMEM_PER_BLOCK:
            raise ValueError(f"masked_legendre_cos: M + K = {m + k} rows exceed the shared memory")
        cpb = max(1, min(_LG_COLUMNS // max(m * k, 1), SMEM_PER_BLOCK // max(row_bytes, 1), max(cells, 1)))
        n_blocks = _cdiv(cells, cpb) if m * k > 0 else 0
        if n_blocks:
            smem = max(smem, cpb * row_bytes)
        first.append(total)
        blocks_of.append(n_blocks)
        cpbs.append(cpb)
        vecs.append(m * k % 4 == 0)
        total += n_blocks
    return LegendreGroupPlan(first=tuple(first), blocks_of=tuple(blocks_of), cpb=tuple(cpbs), vec=tuple(vecs),
                             blocks=total, threads=_LG_THREADS, smem_bytes=smem)


def legendre_group_work(plan: LegendreGroupPlan, shapes: Tuple[Tuple[int, int, int], ...]):
    """The kernel's work in Python: for each block ``(problem, first cell,
    cells, columns a unit)``; the block's threads take units ``tid, tid +
    256, ..`` of its cells' ``cells x M x K`` columns, flattened cell-major,
    ``m`` before ``k``."""
    for b in range(plan.blocks):
        p = max(i for i in range(len(shapes)) if plan.first[i] <= b and plan.blocks_of[i] > 0)
        cell0 = (b - plan.first[p]) * plan.cpb[p]
        yield p, cell0, min(plan.cpb[p], shapes[p][0] - cell0), 4 if plan.vec[p] else 1


def _legendre_problem(spec: Tuple, s: int) -> Tuple[int, int, int, int, bool, Tuple[int, ...]]:
    """``(outer, q, m, k, normalize, strides)`` of one problem from its
    ``spec``: ``("cbf", B, N, M, K)`` (a triplet basis, one (b, n) row a
    cell), ``("quad", B, N, K1, Kq, K2)`` (the dihedral basis, one (b, n, q)
    row a cell, its vectors normalised) or ``("flat", G, M, K)``
    (:func:`masked_legendre_cos`).  Strides: a: outer, q, m; b: outer, q, k,
    component; keep: outer, q, m; y: outer, q, l, m."""
    if spec[0] == "cbf":
        _, b, n, m, k = spec
        return b * n, 1, m, k, False, (m * 3, 0, 3, k * 3, 0, 3, 1, m * k, 0, k, s * m * k, 0, m * k, k)
    if spec[0] == "quad":
        _, b, n, k1, kq, k2 = spec
        return (b * n, kq, k1, k2, True, (k1 * kq * 3, 3, kq * 3, kq * k2 * 3, k2 * 3, 3, 1, k1 * kq * k2, k2,
                                          kq * k2, s * kq * k1 * k2, k1 * k2, kq * k1 * k2, k2))
    _, g, m, k = spec
    return g, 1, m, k, False, (m * 3, 0, 3, 3 * k, 0, 1, k, m * k, 0, k, s * m * k, 0, m * k, k)


@functools.lru_cache(maxsize=64)
def _legendre_table(specs: Tuple[Tuple, ...], s: int):
    """The launch's host part for the problems ``specs`` (cached): the plan,
    the table of ``csrc/masked_legendre_cos.cu`` (22 long longs a problem)
    and its address, the
    coefficients and their address (the arrays kept alive by the cache
    entry), and the pointer array's ctypes type."""
    problems = [_legendre_problem(spec, s) for spec in specs]
    plan = legendre_group_plan(tuple((outer * q, m, k) for outer, q, m, k, _, _ in problems))
    rows = []
    for i, (outer, q, m, k, normalize, strides) in enumerate(problems):
        rows += [*strides, outer * q, q, m, k, int(normalize), plan.first[i], plan.cpb[i], int(plan.vec[i])]
    table = (ctypes.c_longlong * len(rows))(*rows)
    coef = _legendre_coefs(s)
    return plan, table, ctypes.addressof(table), coef, coef.ctypes.data, ctypes.c_void_p * (4 * len(specs))


@functools.lru_cache(maxsize=None)
def _legendre_fn(variant: str = "f32"):
    """The kernel's C entry for f32 (``"f32"``) or bf16 (``"bf16"``) outputs,
    and its error-string function."""
    lib = _library("masked_legendre_cos", [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p], ("f32", "bf16"))
    return getattr(lib, "masked_legendre_cos_" + variant), lib.masked_legendre_cos_error_string


def _check_legendre_problem(kernel: str, a: torch.Tensor, b: torch.Tensor, keep: torch.Tensor,
                            device: torch.device, s: int, shapes: Tuple[Tuple[int, ...], ...]) -> None:
    """The checks that raise, for one problem on the card: device, dtype,
    contiguity, no gradient, S and the shapes of ``a``, ``b`` and ``keep``
    (all at once first: this is host time on every GemNet-OC forward)."""
    if (a.device == device and b.device == device and keep.device == device and a.dtype == torch.float32
            and b.dtype == torch.float32 and keep.dtype == torch.bool and a.shape == shapes[0]
            and b.shape == shapes[1] and keep.shape == shapes[2] and a.is_contiguous() and b.is_contiguous()
            and keep.is_contiguous() and 1 <= s <= 16
            and not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad))):
        return
    for name, t, dtype, shape in (("a", a, torch.float32, shapes[0]), ("b", b, torch.float32, shapes[1]),
                                  ("keep", keep, torch.bool, shapes[2])):
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, want {shape}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise NotImplementedError(f"{kernel} has no backward kernel on CUDA yet")
    if not 1 <= s <= 16:
        raise ValueError(f"{kernel}: the kernel holds 1 <= S <= 16 levels, got {s}")


def _raw_stream(device: torch.device) -> int:
    """The current stream of ``device``, the current device (no Stream
    object and no device context: the launch's host cost)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _legendre_launch(specs: Tuple[Tuple, ...], tensors, s: int) -> None:
    """One launch of ``csrc/masked_legendre_cos.cu`` for the problems
    ``specs`` (see :func:`_legendre_problem`), ``tensors`` their ``(a, b,
    keep, out)`` in turn (every out f32, or every out bf16: the bf16 entry,
    counted under ``masked_legendre_cos.bf16``), counted once; none where no
    problem has a column."""
    device = tensors[0].device
    plan, _, table, _, coef, ptr_type = _legendre_table(specs, s)
    if plan.blocks == 0:  # empty outputs: nothing to launch
        return
    ptrs = ptr_type(*[t.data_ptr() for t in tensors])
    variant = "f32" if tensors[3].dtype == torch.float32 else "bf16"
    fn, msg = _legendre_fn(variant)
    args = (len(specs), table, ctypes.addressof(ptrs), s, coef, plan.blocks, plan.threads, plan.smem_bytes)
    if device.index == torch.cuda.current_device():
        err = fn(*args, _raw_stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _raw_stream(device))
    if err != 0:
        raise RuntimeError(f"masked_legendre_cos launch failed at {specs}: {msg(err).decode()} (cudaError {err})")
    launches["masked_legendre_cos" + _count_suffix(variant)] += 1


def _legendre_out_dtype(kernel: str, out_dtype: torch.dtype) -> None:
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel}: out_dtype must be f32 or bf16, got {out_dtype}")


def masked_legendre_cos(a: torch.Tensor, bt: torch.Tensor, keep: torch.Tensor, num_spherical: int,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``y[g, l, m, k] = sqrt((2l+1)/4pi) P_l(clip(<a[g,m,:], bt[g,:,k]>, -1, 1))
    * keep[g, m, k]`` (``csrc/masked_legendre_cos.cu``), computed in f32 and
    rounded once to ``out_dtype`` (f32 or bf16), forward only.

    ``a [G, M, C]``, ``bt [G, C, K]``, ``keep [G, M, K]`` -> ``[G, S, M, K]``.
    On the card: C = 3, f32 vectors, bool ``keep``, contiguous, S <= 16 and
    no autograd: an input that needs a gradient raises.  The TPU kernel is
    forward-only too.  Training launches the forward as inference does:
    GemNet-OC's bases take only geometry (unit edge vectors and masks) and
    its force heads are direct, so no gradient flows through them."""
    if a.device.type == "cpu":
        return masked_legendre_cos_reference(a, bt, keep, num_spherical, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"masked_legendre_cos: unsupported device {a.device}")
    _legendre_out_dtype("masked_legendre_cos", out_dtype)
    g, m, c = a.shape
    k = bt.shape[2]
    if c != 3:
        raise ValueError(f"masked_legendre_cos: the kernel takes C = 3 components, got {c}")
    s = num_spherical
    _check_legendre_problem("masked_legendre_cos", a, bt, keep, a.device, s, ((g, m, 3), (g, 3, k), (g, m, k)))
    out = torch.empty((g, s, m, k), dtype=out_dtype, device=a.device)
    _legendre_launch((("flat", g, m, k),), (a, bt, keep, out), s)
    return out


def gemnet_cbf_basis(u: torch.Tensor, v: torch.Tensor, keep: torch.Tensor, num_spherical: int,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """GemNet-OC's masked triplet basis over the angles between unit edge
    vectors (:func:`masked_legendre_cos` with one (b, n) row per cell).

    ``u [B, N, M, 3]``, ``v [B, N, K, 3]`` unit rows (zero rows, padded edges,
    give cos 0), ``keep [B, N, M, K]`` bool -> ``[B, N, S, M, K]`` in
    ``out_dtype``.  On the card: as :func:`masked_legendre_cos`, a group of
    one of :func:`gemnet_cbf_bases`; launches counted under
    ``masked_legendre_cos``."""
    if u.device.type == "cpu":
        return gemnet_cbf_basis_reference(u, v, keep, num_spherical, out_dtype)
    return gemnet_cbf_bases([(u, v, keep)], num_spherical, out_dtype)[0]


def gemnet_cbf_bases(problems, num_spherical: int, out_dtype: torch.dtype = torch.float32):
    """Up to three triplet bases in one launch: ``problems`` a list of 1 to 3
    ``(u, v, keep)`` triples as :func:`gemnet_cbf_basis` takes them; returns
    one ``[B, N, S, M, K]`` tensor in ``out_dtype`` each (GemNet-OC in bf16
    asks for bf16, as the JAX model's ``out_dtype=compute_dtype()``).  GemNet-OC's forward passes the
    e2e, a2e and e2a bases of the interactions it runs.  On the CPU: each
    basis's plain version, no launch; on the card: one launch for the group
    (none where every output is empty), counted once under
    ``masked_legendre_cos``, after the checks of :func:`gemnet_cbf_basis`
    on every problem."""
    if not 1 <= len(problems) <= _LG_PROBLEMS:
        raise ValueError(f"gemnet_cbf_bases: takes 1 to {_LG_PROBLEMS} problems, got {len(problems)}")
    device = problems[0][0].device
    if device.type == "cpu":
        return [gemnet_cbf_basis_reference(u, v, keep, num_spherical, out_dtype) for u, v, keep in problems]
    if device.type != "cuda":
        raise ValueError(f"gemnet_cbf_basis: unsupported device {device}")
    _legendre_out_dtype("gemnet_cbf_basis", out_dtype)
    s, specs = num_spherical, []
    for u, v, keep in problems:
        b, n, m, _ = u.shape
        k = v.shape[2]
        _check_legendre_problem("gemnet_cbf_basis", u, v, keep, device, s, ((b, n, m, 3), (b, n, k, 3), (b, n, m, k)))
        specs.append(("cbf", b, n, m, k))
    specs = tuple(specs)
    # one allocation for the group (an allocation costs more host time than a view), each output at an offset of
    # whole units of four elements, as the kernel's four-column stores need
    offsets, total = _cbf_offsets(specs, s)
    buf = torch.empty(total, dtype=out_dtype, device=device)
    outs = [buf.as_strided((b, n, s, m, k), (s * m * k * n, s * m * k, m * k, k, 1), off)
            for (_, b, n, m, k), off in zip(specs, offsets)]
    _legendre_launch(specs, [t for p, out in zip(problems, outs) for t in (*p, out)], s)
    return outs


@functools.lru_cache(maxsize=64)
def _cbf_offsets(specs: Tuple[Tuple, ...], s: int) -> Tuple[Tuple[int, ...], int]:
    """Each triplet basis's offset in one buffer, in elements rounded up to
    multiples of 4, and the buffer's size."""
    offsets, total = [], 0
    for _, b, n, m, k in specs:
        offsets.append(total)
        total += _round4(b * n * s * m * k)
    return tuple(offsets), total


def gemnet_quad_basis(n1: torch.Tensor, n2: torch.Tensor, keep: torch.Tensor, num_spherical: int,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """GemNet-OC's masked dihedral basis (:func:`masked_legendre_cos` with one
    (b, n, q) row per cell): ``y[b, n, l, q, u, k] = coef[l] P_l(clip(<n1h[u, q],
    n2h[q, k]>)) keep[u, q, k]`` with ``n1h``/``n2h`` the cross products
    normalised in the kernel (eps 1e-9).

    ``n1 [B, N, K1, Kq, 3]``, ``n2 [B, N, Kq, K2, 3]``, ``keep [B, N, K1, Kq,
    K2]`` bool -> ``[B, N, S, Kq, K1, K2]`` in ``out_dtype``, written in that
    layout by the kernel.  On the card: as :func:`masked_legendre_cos`."""
    if n1.device.type == "cpu":
        return gemnet_quad_basis_reference(n1, n2, keep, num_spherical, out_dtype)
    if n1.device.type != "cuda":
        raise ValueError(f"gemnet_quad_basis: unsupported device {n1.device}")
    _legendre_out_dtype("gemnet_quad_basis", out_dtype)
    s = num_spherical
    b, n, k1, kq, _ = n1.shape
    k2 = n2.shape[3]
    _check_legendre_problem("gemnet_quad_basis", n1, n2, keep, n1.device, s,
                            ((b, n, k1, kq, 3), (b, n, kq, k2, 3), (b, n, k1, kq, k2)))
    out = torch.empty((b, n, s, kq, k1, k2), dtype=out_dtype, device=n1.device)
    _legendre_launch((("quad", b, n, k1, kq, k2),), (n1, n2, keep, out), s)
    return out


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and widened back to f32 (``t`` itself, as
    f32, for an f32 ``dtype``)."""
    return t.float() if dtype == torch.float32 else t.to(dtype).float()


def _s2_check_dtype(kernel: str, h: torch.Tensor) -> None:
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel}: h must be f32 or bf16, got {h.dtype}")


def s2_grid_silu_reference(h: torch.Tensor, to_grid_m: torch.Tensor, from_grid_m: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`s2_grid_silu`: the ``[..., G, C]``
    grid tensor is materialised.  With bf16 ``h`` the tables are rounded to
    bf16 (the TPU wrapper casts them to ``h``'s dtype), ``silu(g)`` is
    rounded to bf16 before the second product and the output is bf16; both
    products sum in f32, as the TPU kernel's dots do."""
    _s2_check_dtype("s2_grid_silu", h)
    g = torch.matmul(_rounded(to_grid_m, h.dtype), h.float())
    act = _rounded(torch.nn.functional.silu(g), h.dtype)
    return torch.matmul(_rounded(from_grid_m, h.dtype), act).to(h.dtype)


def s2_grid_silu_bwd_reference(h: torch.Tensor, dy: torch.Tensor, to_grid_m: torch.Tensor,
                               from_grid_m: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`s2_grid_silu_bwd`: the ``[..., G, C]``
    grid tensors ``g`` and ``dg`` are materialised.  With bf16 ``h`` (and
    its bf16 cotangent ``dy``) the tables are rounded to bf16, ``dg *
    silu'(g)`` is rounded to bf16 before the last product and ``dh`` is
    bf16, as the TPU backward rounds."""
    _s2_check_dtype("s2_grid_silu_bwd", h)
    to_m, from_m = _rounded(to_grid_m, h.dtype), _rounded(from_grid_m, h.dtype)
    g = torch.matmul(to_m, h.float())
    s = torch.sigmoid(g)
    dg = _rounded(torch.matmul(from_m.t(), dy.float()) * (s * (1.0 + g * (1.0 - s))), h.dtype)
    return torch.matmul(to_m.t(), dg).to(h.dtype)


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


# csrc/s2_grid_silu_bf16.cu: warps a block, columns a warp takes at a time, blocks an SM at most
_S2B_WARPS, _S2B_COLS, _S2B_PER_SM = 8, 32, 2


def s2_bf16_layout(nc: int, g: int) -> Tuple[int, int, int, int, int]:
    """``(KS, NT, GP, to stride, from stride)`` of ``csrc/s2_grid_silu_bf16.cu``'s
    tables: NC zero-padded to KS k16 steps for the first product and to NT n8
    tiles for the second, G to GP (a multiple of 16); the tables' rows (``to``
    by grid point, ``from`` by coefficient) hold an odd number of 16-byte
    chunks, so the eight rows of an ldmatrix fall on eight bank groups."""
    if not 1 <= nc <= 32:
        raise ValueError(f"s2_grid_silu: the bf16 kernel takes 1 <= NC <= 32 coefficient rows, got {nc}")
    ks = 1 if nc <= 16 else 2
    gp = _cdiv(g, 16) * 16
    return ks, _cdiv(nc, 8), gp, 16 * ks + 8, gp + 8


def s2_bf16_tables(to_grid_m: torch.Tensor, from_grid_m: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's tables in one flat bf16 tensor, as it copies them
    into shared memory: ``to_grid_m [G, NC]`` as ``[GP, to stride]`` then
    ``from_grid_m [NC, G]`` as ``[NT 8, from stride]`` (:func:`s2_bf16_layout`),
    each value rounded to bf16 (the TPU wrapper casts both tables to h's
    dtype), zeros elsewhere."""
    g, nc = to_grid_m.shape
    _, nt, gp, ts, fs = s2_bf16_layout(nc, g)
    blob = torch.zeros(gp * ts + nt * 8 * fs, dtype=torch.bfloat16, device=to_grid_m.device)
    blob[:gp * ts].view(gp, ts)[:g, :nc] = to_grid_m
    blob[gp * ts:].view(nt * 8, fs)[:nc, :g] = from_grid_m
    return blob


def s2_grid_silu_bf16_plan(m: int, nc: int, c: int, g: int, sms: int, tiles: int = 1) -> LaunchPlan:
    """``csrc/s2_grid_silu_bf16.cu``'s launch on a card of ``sms`` SMs:
    persistent blocks of 8 warps (2 an SM where the shared memory allows),
    each warp taking 32 columns at a time; shared memory holds the tables of
    :func:`s2_bf16_tables` and ``tiles`` x 2 KB (1 KB for NC <= 16) a warp
    for its columns (the backward's ``tiles=2``: X^T and dY^T).  Raises
    ValueError when the tables do not fit."""
    ks, nt, gp, ts, fs = s2_bf16_layout(nc, g)
    smem = 2 * (gp * ts + nt * 8 * fs) + _S2B_WARPS * tiles * ks * 16 * 64
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"s2_grid_silu: the bf16 tables (G {g}, NC {nc}) need {smem} bytes of shared memory a "
                         f"block, more than {SMEM_PER_BLOCK}")
    per_sm = min(_S2B_PER_SM, SMEM_PER_SM // (smem + 1024))
    blocks = max(1, min(_cdiv(_cdiv(m * c, _S2B_COLS), _S2B_WARPS), per_sm * sms))
    return LaunchPlan(tile=_S2B_WARPS * _S2B_COLS, cluster=1, threads=32 * _S2B_WARPS, blocks=blocks, smem_bytes=smem)


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


def _conv1_parts(c: int, c_out: int, extra: int, n_blocks: Tuple[int, ...], pair_nj: int = _C1_PAIR_NJ):
    """Per m-block ``(K, N, column passes)``, in the kernel's order (|m| > 0
    passes of at most ``pair_nj`` 64-column groups)."""
    out = []
    for g, nb in enumerate(n_blocks):
        n = extra + nb * c_out if g == 0 else nb * c_out
        out.append((nb * c, n, _cdiv(n, _pass_width(n, _C1_M0_NJ if g == 0 else pair_nj))))
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


# csrc/eqv2_attn_conv1_bf16.cu's constants: threads a block, bf16 a ring slot, weight rows a slice at most, bytes a
# segment table entry, 64-column groups an |m| > 0 pass at most (passes of 256 columns spilled)
_C1B_THREADS, _C1B_SLOT, _C1B_SLICE_ROWS, _C1B_SEG_BYTES, _C1B_PAIR_NJ = 256, 16384, 64, 40, 3


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def _odd_stride(n: int) -> int:
    """``csrc/mma_bf16.cuh``'s ``odd_stride``: a row of ``n`` bf16 (a
    multiple of 8) padded to an odd number of 16-byte chunks."""
    return ((n // 8) | 1) * 8


def _conv1_bf16_budget(e_dim: int, hidden: int, c: int, c_out: int, extra: int,
                       n_blocks: Tuple[int, ...]) -> Tuple[int, int, list]:
    """(shared bytes a block, column passes, per-m-block parts) of
    ``csrc/eqv2_attn_conv1_bf16.cu`` at these widths (its ``set_layout``): the
    ring, y0/y1, both embeddings, the region the trunk's f32 sums share with
    the gated message chunk, a gaussian slice, the distances and mask, the
    warps' votes and the segment table."""
    hp, edp = _round_up(hidden, 16), _round_up(e_dim, 16)
    parts = _conv1_parts(c, c_out, extra, n_blocks, _C1B_PAIR_NJ)
    n_parts = sum(p for _, _, p in parts)
    n_seg = 4 * _cdiv(hidden, _C1_TRUNK_N) + sum(p * 2 * _cdiv(k, _C1_KC) * 2 for k, _, p in parts)
    u = _round_up(max(2 * _C1_TILE * _odd_stride(_C1_KC) * 2, _C1_TILE * (_round_up(hidden, 32) + 4) * 4), 16)
    smem = (_C1_STAGES * _C1B_SLOT * 2 + _C1_TILE * _odd_stride(hp) * 2 + 2 * _C1_TILE * _odd_stride(edp) * 2 + u
            + _C1_TILE * _odd_stride(_C1B_SLICE_ROWS) * 2 + 2 * _C1_TILE * 4 + _C1B_THREADS // 32 * 4
            + _C1B_SEG_BYTES * n_seg)
    return smem, n_parts, parts


def _conv1_launch(e: int, num_gauss: int, e_dim: int, hidden: int, parts: list, n_parts: int, smem: int,
                  sms: int, threads: int = _C1_THREADS) -> LaunchPlan:
    """The 64-edge kernels' persistent grid (one block an SM, one a tile when
    there are fewer) and the FLOP a launch makes again."""
    tiles = max(_cdiv(e, _C1_TILE), 1)
    blocks = min(sms, tiles)
    leftover_edges = max(e - (tiles // blocks) * blocks * _C1_TILE, 0)
    trunk_flops = 2 * hidden * (num_gauss + 2 * e_dim + hidden)
    extra_flops = sum((p - 1) * 2 * 2 * hidden * k for k, _, p in parts)
    extra_flops += _cdiv(leftover_edges * (n_parts - 1) * trunk_flops, max(e, 1))
    return LaunchPlan(tile=_C1_TILE, cluster=1, threads=threads, blocks=blocks, smem_bytes=smem,
                      extra_flops_per_edge=extra_flops)


def attn_conv1_bf16_plan(e: int, num_gauss: int, e_dim: int, hidden: int, c: int, c_out: int, extra: int,
                         n_blocks: Tuple[int, ...], sms: int) -> LaunchPlan:
    """``csrc/eqv2_attn_conv1_bf16.cu``'s launch: the grid, work items
    (:func:`attn_conv1_work`) and FLOP made again of :func:`attn_conv1_plan`,
    with the bf16 kernel's shared memory (:func:`_conv1_bf16_budget`).
    Raises ValueError when the widths do not fit."""
    smem, n_parts, parts = _conv1_bf16_budget(e_dim, hidden, c, c_out, extra, n_blocks)
    if smem > SMEM_PER_BLOCK or n_parts > _C1_MAX_PARTS:
        raise ValueError(f"eqv2_attn_conv1: widths (hidden {hidden}, emb {e_dim}, C {c}) need {smem} bytes of "
                         f"shared memory a block in the bf16 kernel, more than {SMEM_PER_BLOCK}, or {n_parts} column "
                         f"passes (at most {_C1_MAX_PARTS})")
    return _conv1_launch(e, num_gauss, e_dim, hidden, parts, n_parts, smem, sms, _C1B_THREADS)


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
    return _conv1_launch(e, num_gauss, e_dim, hidden, parts, n_parts, smem, sms)


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
    rescale folded in by the caller.  Returns a tensor like ``h``: f32, or
    bf16 for bf16 ``h`` (the bf16 variant, counted under
    ``s2_grid_silu.bf16``: the tables rounded to bf16 as the kernel stages
    them, ``silu(g)`` rounded before the second product, as the TPU kernel
    rounds; on the card ``csrc/s2_grid_silu_bf16.cu``, both products on the
    bf16 tensor cores, its tables from :func:`s2_bf16_tables`).  On the
    card: f32 or bf16 ``h``, f32 tables, contiguous, NC <= 32.  When
    autograd needs a gradient of ``h`` the call goes through
    :class:`S2GridSilu`, whose backward is :func:`s2_grid_silu_bwd`.
    """
    if torch.is_grad_enabled() and h.requires_grad:
        return S2GridSilu.apply(h, to_grid_m, from_grid_m)
    return _s2_grid_silu_forward(h, to_grid_m, from_grid_m)


def _s2_grid_silu_forward(h, to_grid_m, from_grid_m) -> torch.Tensor:
    if h.device.type == "cpu":
        return s2_grid_silu_reference(h, to_grid_m, from_grid_m)
    tensors = dict(h=h, to_grid_m=to_grid_m, from_grid_m=from_grid_m)
    _s2_check_dtype("s2_grid_silu", h)
    _check_cuda_inputs("s2_grid_silu", tensors, {"h": h.dtype})
    m, nc, c, g = _s2_shape("s2_grid_silu", tensors)
    out = torch.empty_like(h)
    if h.numel() == 0:  # empty output: nothing to launch
        return out
    if h.dtype == torch.bfloat16:
        plan = s2_grid_silu_bf16_plan(m, nc, c, g, _sm_count(h.device))
        tables = s2_bf16_tables(to_grid_m, from_grid_m)
        lib = _library("s2_grid_silu_bf16", [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p], ("mma",))
        _launch("s2_grid_silu_bf16", lib, h.device, h.data_ptr(), tables.data_ptr(), out.data_ptr(), m, nc, c,
                s2_bf16_layout(nc, g)[2], plan.blocks, plan.smem_bytes, variant="mma", count_as="s2_grid_silu.bf16")
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
    takes them.  Returns ``dh`` like ``h``: f32, or bf16 for bf16 ``h`` and
    ``dy`` (the bf16 variant, counted under ``s2_grid_silu_bwd.bf16``: the
    tables rounded to bf16, ``dg * silu'(g)`` rounded once before its
    second product; on the card the backward entry of
    ``csrc/s2_grid_silu_bf16.cu``, its three products on the bf16 tensor
    cores, launched by ``s2_grid_silu_bf16_plan(..., tiles=2)``).  On the
    card: the forward's input rules, ``dy`` in ``h``'s dtype; f32 launched
    by :func:`s2_grid_silu_bwd_plan`.  Each column is written by one thread
    (no atomics): the result repeats bit for bit.
    """
    if h.device.type == "cpu":
        return s2_grid_silu_bwd_reference(h, dy, to_grid_m, from_grid_m)
    tensors = dict(h=h, dy=dy, to_grid_m=to_grid_m, from_grid_m=from_grid_m)
    _s2_check_dtype("s2_grid_silu_bwd", h)
    _check_cuda_inputs("s2_grid_silu_bwd", tensors, {"h": h.dtype, "dy": h.dtype})
    m, nc, c, g = _s2_shape("s2_grid_silu_bwd", tensors)
    _check_shapes("s2_grid_silu_bwd", tensors, dict(dy=tuple(h.shape)))
    if h.numel() == 0:  # empty output: nothing to launch
        return torch.empty_like(h)
    if h.dtype == torch.bfloat16:
        plan = s2_grid_silu_bf16_plan(m, nc, c, g, _sm_count(h.device), tiles=2)
    else:
        plan = s2_grid_silu_bwd_plan(m, nc, c, g, _sm_count(h.device))
    return _s2_grid_silu_bwd_launch(h, dy, to_grid_m, from_grid_m, plan)


def _s2_grid_silu_bwd_launch(h, dy, to_grid_m, from_grid_m, plan: LaunchPlan) -> torch.Tensor:
    """Launch the backward with ``plan`` on checked, non-empty inputs
    (:func:`s2_grid_silu_bwd`'s) and return ``dh``: ``csrc/s2_grid_silu_bwd.cu``
    for f32, the backward entry of ``csrc/s2_grid_silu_bf16.cu`` for bf16."""
    nc, c = h.shape[-2:]
    m, g = h.numel() // (nc * c), to_grid_m.shape[0]
    dh = torch.empty_like(h)
    if h.dtype == torch.bfloat16:
        tables = s2_bf16_tables(to_grid_m, from_grid_m)
        lib = _library("s2_grid_silu_bf16", [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p], ("bwd_mma",))
        _launch("s2_grid_silu_bf16", lib, h.device, h.data_ptr(), dy.data_ptr(), tables.data_ptr(), dh.data_ptr(), m,
                nc, c, s2_bf16_layout(nc, g)[2], plan.blocks, plan.smem_bytes, shape=f"h{tuple(h.shape)}",
                variant="bwd_mma", count_as="s2_grid_silu_bwd.bf16")
        return dh
    lib = _library("s2_grid_silu_bwd", [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    _launch("s2_grid_silu_bwd", lib, h.device, h.data_ptr(), dy.data_ptr(), to_grid_m.data_ptr(),
            from_grid_m.data_ptr(), dh.data_ptr(), m, nc, c, g, plan.blocks, plan.smem_bytes,
            shape=f"h{tuple(h.shape)}")
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
                    num_gauss: int, c_in: int, dtype: torch.dtype = torch.float32) -> AttnConv1Weights:
    """The repack of the JAX package's ``eqv2_attn_conv1``: ``rad_params``
    is the RadialFunction tree (``dense_{0,1,2}`` ``kernel [in, out]`` and
    ``bias``, ``ln_{0,1}`` ``scale`` and ``bias``), ``conv_params`` the SO2Conv
    tree (``fc_m0`` ``kernel``/``bias``, ``fc_m{i}_{r,i}`` ``kernel``), as
    tensors; ``c_in`` is the channel count of one message half.  Every packed
    tensor is f32; with ``dtype`` bf16 its values are rounded to bf16 first
    (the TPU wrapper casts every weight to the message dtype)."""
    n_blocks = conv1_blocks(lmax, mmax)
    w0 = rad_params["dense_0"]["kernel"]
    e_dim = (w0.shape[0] - num_gauss) // 2
    perm = _gate_perm(n_blocks, c_in, w0.device)
    w2 = rad_params["dense_2"]["kernel"]
    trunk = tuple(_rounded(t, dtype).contiguous() for t in (
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
    flat = torch.cat([_rounded(k, dtype).reshape(-1) for k in conv])
    views, off = [], 0
    for k in conv:
        views.append(flat[off:off + k.numel()].view(k.shape))
        off += k.numel()
    return AttnConv1Weights(trunk, tuple(views), flat, n_blocks, c_in, num_gauss)


class AttnConv1MmaWeights(NamedTuple):
    """``csrc/eqv2_attn_conv1_bf16.cu``'s weights: :func:`pack_attn_conv1`'s
    bf16 values as bf16 matrices, zero-padded to k16 rows and n8 columns.

    ``mats``: ``wg [Rp, H8]``, ``ws``, ``wt [Edp, H8]``, ``w1 [Hp, H8]``, ``w2
    [Hp, NGp]``, then the conv kernels in :func:`pack_attn_conv1`'s order,
    ``[kp_g, N_g rounded up to 8]`` (Rp, Edp, Hp: R, Ed, H rounded up to 16;
    H8: H rounded up to 8; ``kp_g = nb_g C`` rounded up to 16), all views of
    ``flat``.  ``w2``'s columns are [s-half | t-half], each half per m-block
    ``kp_g`` columns of which the first ``nb_g C`` are :func:`pack_attn_conv1`'s
    (its ``w2``'s columns of that half and m-block) and the rest zero.
    ``vecs``: ``b0``, ``ln0_scale``, ``ln0_bias``, ``b1``, ``ln1_scale``,
    ``ln1_bias [H]``, ``b2 [NGp]`` (``w2``'s column layout), ``bm0``: f32
    tensors of bf16 values.
    """

    mats: Tuple[torch.Tensor, ...]
    flat: torch.Tensor
    vecs: Tuple[torch.Tensor, ...]
    kp: Tuple[int, ...]


@functools.lru_cache(maxsize=16)
def _gate_perm_mma(n_blocks: Tuple[int, ...], c: int, device: torch.device) -> torch.Tensor:
    """:func:`_gate_perm` with each half's m-block padded to ``kp_g`` columns:
    the index ``n_rad`` (past the trunk's last column) marks a zero column."""
    perm = _gate_perm(n_blocks, c, torch.device("cpu")).numpy()
    n_rad = perm.size
    half = n_rad // 2
    out = []
    for h in range(2):
        off = 0
        for nb in n_blocks:
            k = nb * c
            out.append(perm[h * half + off:h * half + off + k])
            out.append(np.full(_round_up(k, 16) - k, n_rad, np.int64))
            off += k
    return torch.from_numpy(np.concatenate(out)).to(device)


def pack_attn_conv1_mma(rad_params: Dict[str, Any], conv_params: Dict[str, Any], *, lmax: int, mmax: int,
                        num_gauss: int, c_in: int) -> AttnConv1MmaWeights:
    """The bf16 kernel's repack of :func:`pack_attn_conv1`'s trees (same
    arguments): every value rounded to bf16 as :func:`pack_attn_conv1` with
    ``dtype`` bf16 rounds it, the matrices stored as bf16 in the padded
    layout of :class:`AttnConv1MmaWeights`.  Raises ValueError on a weight
    whose shape does not fit the widths."""
    n_blocks = conv1_blocks(lmax, mmax)
    w0 = rad_params["dense_0"]["kernel"]
    hidden = w0.shape[1]
    e_dim = (w0.shape[0] - num_gauss) // 2
    device = w0.device
    kp = tuple(_round_up(nb * c_in, 16) for nb in n_blocks)
    n_rad = 2 * sum(n_blocks) * c_in
    w2 = rad_params["dense_2"]["kernel"]
    b2 = rad_params["dense_2"]["bias"]
    if w0.shape[0] != num_gauss + 2 * e_dim or tuple(w2.shape) != (hidden, n_rad) or tuple(b2.shape) != (n_rad,):
        raise ValueError(f"eqv2_attn_conv1: dense_0 {tuple(w0.shape)} and dense_2 {tuple(w2.shape)} do not fit "
                         f"{num_gauss} gaussians, hidden {hidden} and {n_rad} gate columns")
    perm = _gate_perm_mma(n_blocks, c_in, device)
    zero_col = torch.zeros((hidden, 1), dtype=w2.dtype, device=device)
    w2p = torch.cat([w2, zero_col], dim=1)[:, perm]
    b2p = torch.cat([b2, zero_col[0]])[perm]

    def split_st(k, nb, n):
        if tuple(k.shape) != (nb * 2 * c_in, n):
            raise ValueError(f"eqv2_attn_conv1: a conv kernel has shape {tuple(k.shape)}, want {(nb * 2 * c_in, n)}")
        k3 = k.reshape(nb, 2 * c_in, -1)
        return k3[:, :c_in].reshape(nb * c_in, -1), k3[:, c_in:].reshape(nb * c_in, -1)

    h8, hp, edp = _round_up(hidden, 8), _round_up(hidden, 16), _round_up(e_dim, 16)
    mats = [(w0[:num_gauss], _round_up(num_gauss, 16), h8), (w0[num_gauss:num_gauss + e_dim], edp, h8),
            (w0[num_gauss + e_dim:], edp, h8), (rad_params["dense_1"]["kernel"], hp, h8), (w2p, hp, w2p.shape[1])]
    n0 = conv_params["fc_m0"]["bias"].shape[0]
    mats += [(k, kp[0], _round_up(n0, 8)) for k in split_st(conv_params["fc_m0"]["kernel"], n_blocks[0], n0)]
    for mi in range(1, len(n_blocks)):
        nb, n = n_blocks[mi], conv_params[f"fc_m{mi}_r"]["kernel"].shape[1]
        kr_s, kr_t = split_st(conv_params[f"fc_m{mi}_r"]["kernel"], nb, n)
        ki_s, ki_t = split_st(conv_params[f"fc_m{mi}_i"]["kernel"], nb, n)
        mats += [(k, kp[mi], _round_up(n, 8)) for k in (kr_s, ki_s, kr_t, ki_t)]
    flat = torch.zeros(sum(k * n for _, k, n in mats), dtype=torch.bfloat16, device=device)
    views, off = [], 0
    for src, k, n in mats:
        if src.shape[0] > k or src.shape[1] > n:
            raise ValueError(f"eqv2_attn_conv1: a weight of shape {tuple(src.shape)} does not fit [{k}, {n}]")
        view = flat[off:off + k * n].view(k, n)
        view[:src.shape[0], :src.shape[1]] = src
        views.append(view)
        off += k * n
    bf = torch.bfloat16
    vecs = tuple(_rounded(t, bf).contiguous() for t in (
        rad_params["dense_0"]["bias"], rad_params["ln_0"]["scale"], rad_params["ln_0"]["bias"],
        rad_params["dense_1"]["bias"], rad_params["ln_1"]["scale"], rad_params["ln_1"]["bias"], b2p,
        conv_params["fc_m0"]["bias"]))
    return AttnConv1MmaWeights(tuple(views), flat, vecs, kp)


def _attn_conv1_packed_reference(dist, mask, emb_s, emb_t, msg_s, msg_t, w: AttnConv1Weights, *, cutoff: float,
                                 width_scalar: float, c_out: int, extra: int) -> Tuple[torch.Tensor, ...]:
    """Port of the JAX ``_attn_conv1_ref`` on flat ``[E]`` / ``[E, ...]``
    inputs and packed weights.  Returns ``(extra [E, extra], m0 [E, nb0 *
    c_out], then yp, yn [E, nb * c_out] per |m| > 0 block)`` in the
    messages' dtype.  With bf16 messages it rounds where ``_attn_conv1_ref``
    rounds: the gaussians, both trunk activations before their products and
    the gates to bf16, each gated product in bf16, the outputs to bf16; every
    product and sum of products is f32 (the weights and embeddings as given)."""
    wg, ws, wt, b0, ln0s, ln0b, w1, b1, ln1s, ln1b, w2, b2, bm0 = w.trunk
    c_in, n_blocks, num_gauss = w.c_in, w.n_blocks, w.num_gauss
    dt = msg_s.dtype
    delta = cutoff / (num_gauss - 1)
    coeff = -0.5 / (width_scalar * delta) ** 2
    off = torch.arange(num_gauss, dtype=torch.float32, device=dist.device) * delta
    gauss = _rounded(torch.exp(coeff * (dist.float()[:, None] - off) ** 2) * mask.float()[:, None], dt)

    def ln_silu(h, s, b):
        mu = torch.mean(h, dim=1, keepdim=True)
        var = torch.mean((h - mu) ** 2, dim=1, keepdim=True)
        return torch.nn.functional.silu((h - mu) * torch.rsqrt(var + 1e-6) * s + b)

    y0 = _rounded(ln_silu(gauss @ wg + emb_s.float() @ ws + emb_t.float() @ wt + b0, ln0s, ln0b), dt)
    y1 = _rounded(ln_silu(y0 @ w1 + b1, ln1s, ln1b), dt)
    gates = (y1 @ w2 + b2).to(dt)
    half = sum(n_blocks) * c_in
    goff = [0]
    for nb in n_blocks:
        goff.append(goff[-1] + nb * c_in)

    def gated(msg, base):  # in the message dtype: a bf16 product is rounded, as the TPU kernel's
        pieces = [msg[:, : n_blocks[0] * c_in] * gates[:, base : base + goff[1]]]
        moff = n_blocks[0] * c_in
        for mi in range(1, len(n_blocks)):
            g = gates[:, base + goff[mi] : base + goff[mi + 1]]
            width = n_blocks[mi] * c_in
            pieces.append(msg[:, moff : moff + width] * g)
            pieces.append(msg[:, moff + width : moff + 2 * width] * g)
            moff += 2 * width
        return pieces

    def dot(a, k):  # widened at each use, as JAX promotes in each dot: a bf16 piece's cotangents round apart
        return a.float() @ k

    gs, gt = gated(msg_s, 0), gated(msg_t, half)
    conv = w.conv
    y0c = dot(gs[0], conv[0]) + dot(gt[0], conv[1]) + bm0
    outs = [y0c[:, :extra], y0c[:, extra:]]
    wi = 2
    for mi in range(1, len(n_blocks)):
        xp_s, xn_s, xp_t, xn_t = gs[2 * mi - 1], gs[2 * mi], gt[2 * mi - 1], gt[2 * mi]
        kr_s, ki_s, kr_t, ki_t = conv[wi : wi + 4]
        wi += 4
        outs.append(dot(xp_s, kr_s) + dot(xp_t, kr_t) - dot(xn_s, ki_s) - dot(xn_t, ki_t))
        outs.append(dot(xp_s, ki_s) + dot(xp_t, ki_t) + dot(xn_s, kr_s) + dot(xn_t, kr_t))
    return tuple(o.to(dt) for o in outs)


def _attn_conv1_check_dtypes(msg_s: torch.Tensor, msg_t: torch.Tensor) -> None:
    if msg_s.dtype not in (torch.float32, torch.bfloat16) or msg_t.dtype != msg_s.dtype:
        raise TypeError(f"eqv2_attn_conv1: msg_s and msg_t must both be f32 or both bf16, got {msg_s.dtype}, "
                        f"{msg_t.dtype}")


def _attn_conv1_prepare(dist, emb_s, msg_s, rad_params, conv_params, *, lmax, mmax, num_gauss,
                        weights_dtype=torch.float32):
    """(packed weights, leading dims, edges, n_act, C, emb dim) of a call."""
    c = msg_s.shape[-1]
    packed = pack_attn_conv1(rad_params, conv_params, lmax=lmax, mmax=mmax, num_gauss=num_gauss, c_in=c,
                             dtype=weights_dtype)
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
    the trunk activations and the ``[E, NG]`` gates are materialised.  With
    bf16 messages it is the TPU kernel's bf16 form (``_attn_conv1_call``
    casts the embeddings and every weight to bf16 before the kernel body
    rounds as :func:`_attn_conv1_packed_reference` says); the outputs are
    bf16."""
    return _attn_conv1_reference(dist, mask, emb_s, emb_t, msg_s, msg_t, rad_params, conv_params, lmax=lmax,
                                 mmax=mmax, c_out=c_out, extra=extra, num_gauss=num_gauss, cutoff=cutoff,
                                 width_scalar=width_scalar, kernel_form=True)


def _attn_conv1_reference(dist, mask, emb_s, emb_t, msg_s, msg_t, rad_params, conv_params, *, lmax, mmax, c_out,
                          extra, num_gauss, cutoff, width_scalar, kernel_form):
    """:func:`eqv2_attn_conv1_reference`, or with ``kernel_form`` False the
    JAX VJP's recompute (``_attn_conv1_bwd`` differentiates ``_attn_conv1_ref``
    with the f32 weights and embeddings, where the forward kernel had cast
    them to the message dtype; the two forms are one for f32 messages)."""
    _attn_conv1_check_dtypes(msg_s, msg_t)
    dt = msg_s.dtype if kernel_form else torch.float32
    packed, lead, m, n_act, c, e_dim = _attn_conv1_prepare(
        dist, emb_s, msg_s, rad_params, conv_params, lmax=lmax, mmax=mmax, num_gauss=num_gauss, weights_dtype=dt)
    outs = _attn_conv1_packed_reference(
        dist.reshape(m), mask.reshape(m), _rounded(emb_s, dt).reshape(m, e_dim),
        _rounded(emb_t, dt).reshape(m, e_dim), msg_s.reshape(m, n_act * c), msg_t.reshape(m, n_act * c), packed,
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
    extra])`` in the messages' dtype: h's rows in the truncated m-primary
    order, extra_out the fc_m0 columns that precede h's.  On the card: f32
    contiguous inputs and ``mask`` bool, or bf16 messages (the bf16 variant,
    counted under ``eqv2_attn_conv1.bf16``: ``csrc/eqv2_attn_conv1_bf16.cu``,
    every product on the bf16 tensor cores, the weights packed as bf16 by
    :func:`pack_attn_conv1_mma`, the embeddings rounded as the kernel
    stages them, then the roundings of :func:`_attn_conv1_packed_reference`;
    the embeddings, distances and weights stay f32 tensors).  :func:`attn_conv1_route`
    picks the kernel from the widths: the 64-edge kernel where its plan fits
    one block's shared memory (at C = 128, equal trunk and embedding widths
    up to 144), else the 16-edge ``csrc/eqv2_attn_conv1_wide.cu`` (f32 only:
    bf16 messages there raise ``TypeError``); both count as
    ``eqv2_attn_conv1``.  When autograd needs a gradient the call goes
    through :class:`EqV2AttnConv1`, whose backward recomputes the plain
    version in the JAX VJP's form.
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

    The backward recomputes the plain version (:func:`_attn_conv1_reference`
    with ``kernel_form`` False: with bf16 messages, the roundings of the
    forward on f32 weights and embeddings) under autograd and
    differentiates it, as the JAX package's ``_attn_conv1_bwd``
    differentiates ``_attn_conv1_ref``: the TPU kernel has no backward
    kernel of its own.  The recompute starts from the weight
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
            outs = _attn_conv1_reference(dist, mask, *inputs[:4], rad, conv, **ctx.kw, kernel_form=False)
            grads = torch.autograd.grad(outs, inputs, (dh, dx), allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(inputs, grads)]
        return (None, None, torch.zeros_like(dist), None, *grads)


def _eqv2_attn_conv1_forward(dist, mask, emb_s, emb_t, msg_s, msg_t, rad_params, conv_params, *, lmax, mmax, c_out,
                             extra, num_gauss, cutoff, width_scalar):
    if msg_s.device.type == "cpu":
        return eqv2_attn_conv1_reference(
            dist, mask, emb_s, emb_t, msg_s, msg_t, rad_params, conv_params, lmax=lmax, mmax=mmax, c_out=c_out,
            extra=extra, num_gauss=num_gauss, cutoff=cutoff, width_scalar=width_scalar)
    _attn_conv1_check_dtypes(msg_s, msg_t)
    if msg_s.dtype == torch.bfloat16:
        return _eqv2_attn_conv1_bf16_forward(dist, mask, emb_s, emb_t, msg_s, msg_t, rad_params, conv_params,
                                             lmax=lmax, mmax=mmax, c_out=c_out, extra=extra, num_gauss=num_gauss,
                                             cutoff=cutoff, width_scalar=width_scalar)
    packed, lead, m, n_act, c, e_dim = _attn_conv1_prepare(
        dist, emb_s, msg_s, rad_params, conv_params, lmax=lmax, mmax=mmax, num_gauss=num_gauss)
    names = ("wg", "ws", "wt", "b0", "ln0_scale", "ln0_bias", "w1", "b1", "ln1_scale", "ln1_bias", "w2", "b2", "bm0")
    tensors = dict(dist=dist, mask=mask, emb_s=emb_s, emb_t=emb_t, msg_s=msg_s, msg_t=msg_t,
                   **dict(zip(names, packed.trunk)), wconv=packed.flat_conv)
    _check_cuda_inputs("eqv2_attn_conv1", tensors, {"mask": torch.bool, "msg_s": msg_s.dtype, "msg_t": msg_s.dtype})
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
    extra_out = torch.empty(lead + (extra,), dtype=msg_s.dtype, device=msg_s.device)
    h = torch.empty(lead + (n_act, c_out), dtype=msg_s.dtype, device=msg_s.device)
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


def _eqv2_attn_conv1_bf16_forward(dist, mask, emb_s, emb_t, msg_s, msg_t, rad_params, conv_params, *, lmax, mmax,
                                  c_out, extra, num_gauss, cutoff, width_scalar):
    """The bf16 messages' launch (``csrc/eqv2_attn_conv1_bf16.cu``) on CUDA
    tensors, its weights packed by :func:`pack_attn_conv1_mma`; widths that
    take the wide route raise ``TypeError``."""
    c, lead, n_act, e_dim = msg_s.shape[-1], tuple(dist.shape), msg_s.shape[-2], emb_s.shape[-1]
    m = math.prod(lead)
    n_blocks = conv1_blocks(lmax, mmax)
    hidden = rad_params["dense_1"]["kernel"].shape[0]
    if attn_conv1_route(e_dim, hidden, c, c_out, extra, n_blocks) == "wide":
        raise TypeError(f"eqv2_attn_conv1: the wide route (hidden {hidden}, emb {e_dim}) takes f32 messages only, "
                        f"got {msg_s.dtype}")
    packed = pack_attn_conv1_mma(rad_params, conv_params, lmax=lmax, mmax=mmax, num_gauss=num_gauss, c_in=c)
    names = ("wg", "ws", "wt", "w1", "w2")
    vec_names = ("b0", "ln0_scale", "ln0_bias", "b1", "ln1_scale", "ln1_bias", "b2", "bm0")
    tensors = dict(dist=dist, mask=mask, emb_s=emb_s, emb_t=emb_t, msg_s=msg_s, msg_t=msg_t,
                   **dict(zip(vec_names, packed.vecs)))
    _check_cuda_inputs("eqv2_attn_conv1", tensors, {"mask": torch.bool, "msg_s": torch.bfloat16,
                                                    "msg_t": torch.bfloat16})
    if n_act != n_blocks[0] + 2 * sum(n_blocks[1:]):
        raise ValueError(f"eqv2_attn_conv1: msg_s has {n_act} rows, lmax {lmax} / mmax {mmax} need "
                         f"{n_blocks[0] + 2 * sum(n_blocks[1:])}")
    vec, h8, kp = (hidden,), _round_up(hidden, 8), packed.kp
    ngp = 2 * sum(kp)
    _check_shapes("eqv2_attn_conv1", tensors, dict(
        mask=lead, emb_s=lead + (e_dim,), emb_t=lead + (e_dim,), msg_s=lead + (n_act, c), msg_t=lead + (n_act, c),
        b0=vec, ln0_scale=vec, ln0_bias=vec, b1=vec, ln1_scale=vec, ln1_bias=vec, b2=(ngp,),
        bm0=(extra + n_blocks[0] * c_out,)))
    want = [(_round_up(num_gauss, 16), h8), (_round_up(e_dim, 16), h8), (_round_up(e_dim, 16), h8),
            (_round_up(hidden, 16), h8), (_round_up(hidden, 16), ngp)]
    want += [(kp[0], _round_up(extra + n_blocks[0] * c_out, 8))] * 2
    for g in range(1, len(n_blocks)):
        want += [(kp[g], _round_up(n_blocks[g] * c_out, 8))] * 4
    _check_shapes("eqv2_attn_conv1", dict(zip(names + tuple(f"conv[{i}]" for i in range(len(want) - 5)),
                                              packed.mats)),
                  dict(zip(names + tuple(f"conv[{i}]" for i in range(len(want) - 5)), want)))
    extra_out = torch.empty(lead + (extra,), dtype=msg_s.dtype, device=msg_s.device)
    h = torch.empty(lead + (n_act, c_out), dtype=msg_s.dtype, device=msg_s.device)
    if m == 0:  # empty output: nothing to launch
        return h, extra_out
    plan = attn_conv1_bf16_plan(m, num_gauss, e_dim, hidden, c, c_out, extra, n_blocks, _sm_count(msg_s.device))
    lib = _library("eqv2_attn_conv1_bf16", [ctypes.c_void_p] * 22 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float, ctypes.c_float]
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ("mma",))
    _launch("eqv2_attn_conv1_bf16", lib, msg_s.device,
            *(t.data_ptr() for t in (dist, mask, emb_s, emb_t, msg_s, msg_t)), *(t.data_ptr() for t in packed.mats[:5]),
            packed.mats[5].data_ptr(), *(t.data_ptr() for t in packed.vecs), extra_out.data_ptr(), h.data_ptr(), m,
            num_gauss, e_dim, hidden, c, c_out, extra, (ctypes.c_int * len(n_blocks))(*n_blocks), len(n_blocks),
            float(cutoff), float(width_scalar), plan.blocks, plan.smem_bytes, variant="mma",
            count_as="eqv2_attn_conv1.bf16")
    return h, extra_out


def _gather_rows(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``x [B, N, ...]`` at ``src [B, N, K]`` -> ``[B, N, K, ...]``."""
    return x[torch.arange(src.shape[0], device=src.device)[:, None, None], src.long()]


def eqv2_edge_rotate_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, lmax: int, mmax: int, *,
                               direction: str, n_sel: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`eqv2_edge_rotate`: the decomposed chain
    of :mod:`adsorbdiff_tpu_torch.models.so3` (``rotate_to_edge_m`` /
    ``rotate_from_edge_m``), whose ``[..., 2 dim, C]`` stages are
    materialised.  bf16 ``x`` takes :func:`_edge_rotate_bf16_reference`."""
    n_sel = so3.n_act_rows(lmax, mmax) if n_sel is None else n_sel
    if direction not in ("to", "from"):
        raise ValueError(f"unknown rotation direction {direction!r}")
    if direction == "from" and x.shape[-2] != n_sel:
        raise ValueError(f"eqv2_edge_rotate: direction 'from' takes n_sel = {n_sel} rows, got {x.shape[-2]}")
    if x.dtype == torch.bfloat16:
        return _edge_rotate_bf16_reference(x, gamma, beta, lmax, mmax, direction, n_sel)
    if x.dtype != torch.float32:
        raise TypeError(f"eqv2_edge_rotate: x must be f32 or bf16, got {x.dtype}")
    if direction == "to":
        return so3.rotate_to_edge_m(x, gamma, beta, lmax, mmax, n_rows=n_sel)
    return so3.rotate_from_edge_m(x, gamma, beta, lmax, mmax)


def _edge_rotate_bf16_reference(x, gamma, beta, lmax, mmax, direction, n_sel) -> torch.Tensor:
    """The TPU kernel's bf16 chain (``pallas_kernels.py::_edge_rot_kernel``
    with ``x_ref.dtype`` bf16): the constant matrices and the cos/sin(m t)
    tables rounded to bf16; each constant product summed in f32 and rounded
    to bf16; each Dz stage ``h c + h' s`` in bf16, both products and their
    sum rounded (what JAX's function returns: bit for bit against this chain
    on the CPU, where one rounding of the f32 sum parts from it).  Returns
    bf16."""
    bf = torch.bfloat16
    dim = (lmax + 1) ** 2

    def tables(angle, m_row, sign, negate):
        c, s = so3._cs(angle.float(), m_row, sign)
        return _rounded(c, bf), _rounded(-s if negate else s, bf)

    def dz(h, c, s):  # h [..., 2 dim, C]: the rows and their (l, -m) partners
        return _rounded(_rounded(h[..., :dim, :] * c, bf) + _rounded(h[..., dim:, :] * s, bf), bf)

    def product(table, t):
        return _rounded(torch.matmul(_rounded(so3.device_table(table, t.device), bf), t), bf)

    if direction == "to":
        _, jt2, _, _, (m_row, sign), _, _, _ = so3._rot_decomp_mats(lmax, mmax, so3.n_act_rows(lmax, mmax))
        swap = so3.device_table(so3.zrot_swap_sign(lmax)[1], x.device, torch.long)
        xf = x.float()
        t = dz(torch.cat([xf, xf[..., swap, :]], dim=-2), *tables(gamma, m_row, sign, False))
        t = dz(product(jt2, t), *tables(beta, m_row, sign, False))
        return product(so3._pj_rows(lmax, mmax, n_sel), t).to(bf)
    _, _, _, _, (m_row, sign), jtp2, j2, _ = so3._rot_decomp_mats(lmax, mmax, n_sel)
    t = dz(product(jtp2, x.float()), *tables(beta, m_row, sign, True))
    return dz(product(j2, t), *tables(gamma, m_row, sign, True)).to(bf)


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
    K-broadcast copy never exists).  Returns a tensor in x's dtype with the
    angles' leading dims: f32, or bf16 for bf16 x (the bf16 variant of every
    form, counted under ``eqv2_edge_rotate.bf16``: the TPU kernel's bf16
    chain, :func:`_edge_rotate_bf16_reference`; on the card
    ``csrc/eqv2_edge_rotate_bf16.cu``, both products on the bf16 tensor
    cores, its slots from :func:`rotate_bf16_layout`).  On the card: f32 or bf16
    contiguous x, f32 contiguous angles, lmax <= 6.  When autograd needs a
    gradient the call goes through :class:`EqV2EdgeRotate`.
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
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel}: x must be f32 or bf16, got {x.dtype}")
    _check_cuda_inputs(kernel, tensors, {"src": torch.int32, "x": x.dtype})
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
    out = torch.empty(lead + (n_out, c), dtype=x.dtype, device=x.device)
    e = math.prod(lead)
    if e * c == 0:  # empty output: nothing to launch
        return out
    geom = (e, c, n_in, n_out, kdiv, nk, n_nodes)
    if x.dtype == torch.bfloat16:
        layout = rotate_bf16_layout(lmax, mmax, n_sel, direction)
        blob = so3.device_table(_rotate_bf16_blob(lmax, mmax, n_sel, direction), x.device, torch.int16)
        _rotate_bf16_launch(x, src, gamma, beta, out, geom, layout, direction, blob)
        return out
    j_blocks, sign, row = so3.edge_rot_consts(lmax, mmax, n_sel)  # contiguous host arrays, cached
    lib = _library(kernel, [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    _launch(kernel, lib, x.device, x.data_ptr(), None if src is None else src.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr(), *geom, lmax, int(direction == "to"), j_blocks.ctypes.data,
            sign.ctypes.data, row.ctypes.data)
    return out


def _rotate_bf16_launch(x, src, gamma, beta, out, geom, layout: "RotateBf16Layout", direction: str,
                        blob: torch.Tensor) -> None:
    """Launch ``csrc/eqv2_edge_rotate_bf16.cu`` on checked inputs
    (:func:`_rotate_forward`'s; ``geom = (E, C, n_in, n_out, kdiv, nk,
    n_nodes)``) with ``layout``'s slots and the constants ``blob`` (a device
    tensor of :func:`rotate_bf16_consts`), writing ``out``."""
    e, c = geom[:2]
    aligned = c % _ROT_COLS == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    plan = rotate_bf16_plan(e, c, layout.p, _sm_count(x.device), aligned)
    lib = _library("eqv2_edge_rotate_bf16", [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
                   ("mma",))
    _launch("eqv2_edge_rotate_bf16", lib, x.device, x.data_ptr(), None if src is None else src.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), blob.data_ptr(), *geom, layout.p,
            int(direction == "to"), layout.in_groups, layout.out_groups, plan.blocks, plan.smem_bytes, variant="mma",
            count_as="eqv2_edge_rotate.bf16")


class RotateBf16Layout(NamedTuple):
    """The coefficient slots of ``csrc/eqv2_edge_rotate_bf16.cu`` for one
    rotation.  The slots come in groups of 16, each holding whole l blocks
    of J (so J[perm, perm] is block diagonal over the groups: each product
    is one 16 x 16 block a group); in a group, each (l, +m) row sits at an
    even slot with its (l, -m) partner after it, and the m = 0 rows pair
    with each other (a pad where their count is odd).  ``perm[s]``: the
    l-primary row in slot ``s`` (-1: a pad); ``p``: the slots, 16 a group.
    Per slot pair: its |m| (0 for the m = 0 pairs and pads) and the Dz sign
    of its first row.  Per slot: the input row copied into it and the
    output row stored from it (-1: none).  ``in_groups`` and
    ``out_groups``: bit g set where group g holds input rows (the first
    product's blocks to multiply) and output rows (the second's)."""

    p: int
    perm: np.ndarray
    pair_m: np.ndarray
    pair_sign: np.ndarray
    in_row: np.ndarray
    out_row: np.ndarray
    in_groups: int
    out_groups: int


def _slot_groups(lmax: int) -> List[List[int]]:
    """J's l blocks packed first-fit, largest first, into groups of at most
    16 slots (a group's m = 0 rows padded to an even count)."""
    groups: List[List[int]] = []
    for l in range(lmax, -1, -1):
        for g in groups:
            if len(g) + 1 + (len(g) + 1) % 2 + 2 * (sum(g) + l) <= 16:
                g.append(l)
                break
        else:
            groups.append([l])
    return groups


@functools.lru_cache(maxsize=64)
def rotate_bf16_layout(lmax: int, mmax: int, n_sel: int, direction: str) -> RotateBf16Layout:
    """:class:`RotateBf16Layout` of a rotation in ``direction`` ("to": input
    rows are x's l-primary rows, outputs the first ``n_sel`` truncated
    m-primary rows; "from": the reverse).  Raises ValueError past lmax 6."""
    if not 1 <= lmax <= 6:
        raise ValueError(f"eqv2_edge_rotate: the bf16 kernel takes 1 <= lmax <= 6, got {lmax}")
    sign = so3.zrot_swap_sign(lmax)[2]
    row = so3.edge_rot_consts(lmax, mmax, n_sel)[2]
    perm, pair_m, pair_sign = [], [], []
    for group in _slot_groups(lmax):
        slots = [l * l + l for l in sorted(group)]
        slots += [-1] * (len(slots) % 2)
        pair_m += [0] * (len(slots) // 2)
        pair_sign += [1] * (len(slots) // 2)
        for l in sorted(group):
            for m in range(1, l + 1):
                slots += [l * l + l + m, l * l + l - m]
                pair_m.append(m)
                pair_sign.append(int(sign[l * l + l + m]))
        pad = 16 - len(slots)
        perm += slots + [-1] * pad
        pair_m += [0] * (pad // 2)
        pair_sign += [1] * (pad // 2)
    perm = np.array(perm, np.int64)
    sel = np.where(perm >= 0, row[np.maximum(perm, 0)], -1)
    in_row, out_row = (perm, sel) if direction == "to" else (sel, perm)
    in_groups, out_groups = (sum(1 << g for g in range(len(perm) // 16) if (rows[16 * g:16 * g + 16] >= 0).any())
                             for rows in (in_row, out_row))
    return RotateBf16Layout(len(perm), perm, np.array(pair_m), np.array(pair_sign), in_row, out_row, in_groups,
                            out_groups)


def rotate_bf16_consts(layout: RotateBf16Layout, j: np.ndarray) -> np.ndarray:
    """The int16 blob ``csrc/eqv2_edge_rotate_bf16.cu`` copies into shared
    memory: ``j [D, D]`` permuted to ``J[perm, perm]`` and rounded to bf16
    (``[p, odd stride]`` rows, zeros in every pad), then ``in_row``,
    ``out_row``, ``pair_m`` and ``pair_sign``, zero-padded to 16 bytes."""
    p = layout.p
    live = np.flatnonzero(layout.perm >= 0)
    jp = np.zeros((p, _odd_stride(p)), np.float32)
    jp[np.ix_(live, live)] = j[np.ix_(layout.perm[live], layout.perm[live])]
    bits = torch.from_numpy(jp).to(torch.bfloat16).view(torch.int16).numpy().reshape(-1)
    maps = np.concatenate([layout.in_row, layout.out_row, layout.pair_m, layout.pair_sign]).astype(np.int16)
    blob = np.concatenate([bits, maps])
    return np.concatenate([blob, np.zeros(-blob.size % 8, np.int16)])


@functools.lru_cache(maxsize=64)
def _rotate_bf16_blob(lmax: int, mmax: int, n_sel: int, direction: str) -> np.ndarray:
    return rotate_bf16_consts(rotate_bf16_layout(lmax, mmax, n_sel, direction),
                              np.asarray(so3.get_J_matrix(lmax), np.float32))


# csrc/eqv2_edge_rotate_bf16.cu's kWarps, kWarpCols, kBlocksPerSM and kStages: warps a block, columns a warp takes
# at a time, blocks an SM at most (its launch bound), tile buffers a warp; its C entry refuses a plan whose shared
# bytes differ from its own layout's
_ROT_WARPS, _ROT_COLS, _ROT_PER_SM, _ROT_STAGES = 8, 32, 2, 3


def rotate_bf16_smem(p: int, c: int, aligned: bool) -> int:
    """Shared bytes of a ``csrc/eqv2_edge_rotate_bf16.cu`` block: the
    constants of :func:`rotate_bf16_consts`, and per warp its tile buffers
    (``p`` rows of 32 columns and 16 bytes for its edge's angles; 3, a ring
    of loads in flight, for ``aligned`` tiles: C % 32 == 0 and 16-byte
    aligned rows, else 1) and its angle table (2 angles x the edges 32
    columns of C channels can touch x ``p / 2`` pairs x 8 bytes)."""
    edges = min((c + 30) // c + 1, 32)
    return (_round_up(2 * (p * _odd_stride(p) + 3 * p), 16)
            + _ROT_WARPS * ((_ROT_STAGES if aligned else 1) * (64 * p + 16) + 8 * p * edges))


def rotate_bf16_plan(e: int, c: int, p: int, sms: int, aligned: bool) -> LaunchPlan:
    """``csrc/eqv2_edge_rotate_bf16.cu``'s launch on a card of ``sms`` SMs:
    persistent blocks of 8 warps (2 an SM, as the kernel's launch bound
    holds them, where the shared memory allows), warp w taking the w-th run
    of consecutive 32-column tiles of the ``e * c`` (edge, channel) columns,
    shared memory :func:`rotate_bf16_smem` (``aligned``: the kernel's tiles
    are whole, C % 32 == 0, and x and out 16-byte aligned)."""
    smem = rotate_bf16_smem(p, c, aligned)
    per_sm = min(_ROT_PER_SM, SMEM_PER_SM // (smem + 1024))
    blocks = max(1, min(_cdiv(_cdiv(e * c, _ROT_COLS), _ROT_WARPS), per_sm * sms))
    return LaunchPlan(tile=_ROT_WARPS * _ROT_COLS, cluster=1, threads=32 * _ROT_WARPS, blocks=blocks,
                      smem_bytes=smem)


class EqV2EdgeRotate(torch.autograd.Function):
    """:func:`eqv2_edge_rotate` / :func:`eqv2_gather_rotate_to` with their VJP.

    The rotation is linear in x and Dz(t)^T = Dz(-t), so the VJP of one
    direction is the other direction at the same angles
    (``pallas_kernels.py::_edge_rot_bwd``): one launch of the same kernel on
    the per-edge cotangent (bf16 for a bf16 x: the bf16 variant).  A node
    row shared by K edges then sums its K rows; the gather variant adds each
    edge's row to its source node (``index_add_``, outside the kernel as the
    one-hot gather's transpose was outside the TPU kernel); both sums run in
    f32 and round once to x's dtype.  The angles get no gradient (the
    geometry contract: score losses never differentiate through positions).
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
        d = _rotate_forward(ct.contiguous(), None, gamma, beta, lmax, mmax, _DUAL[direction], n_sel)
        return _rotate_vjp_rows(d, src, x_shape).to(dtype), None, None, None, None, None, None, None


_DUAL = {"to": "from", "from": "to"}


def _rotate_vjp_rows(d: torch.Tensor, src: Optional[torch.Tensor], x_shape: Tuple[int, ...]) -> torch.Tensor:
    """The per-edge rows ``d`` of the dual rotation back on x's rows: added to
    the source nodes (the gather), summed over the K edges of a shared node
    row, or as they are; the sums in f32."""
    if src is not None:
        b, n = x_shape[:2]
        idx = (torch.arange(b, device=src.device)[:, None, None] * n + src.long()).reshape(-1)
        dx = torch.zeros((b * n,) + tuple(x_shape[2:]), dtype=torch.float32, device=d.device)
        return dx.index_add_(0, idx, d.float().reshape((-1,) + tuple(x_shape[2:]))).reshape(x_shape)
    if tuple(d.shape) != tuple(x_shape):
        return d.float().sum(dim=-3, keepdim=True)  # the K edges of a shared node row
    return d


def eqv2_edge_rotate_vjp_reference(ct: torch.Tensor, src: Optional[torch.Tensor], gamma: torch.Tensor,
                                   beta: torch.Tensor, lmax: int, mmax: int, *, direction: str, n_sel: int,
                                   x_shape: Tuple[int, ...]) -> torch.Tensor:
    """Plain version of :class:`EqV2EdgeRotate`'s backward: the cotangent
    ``ct`` of a rotation of ``direction`` (of :func:`eqv2_gather_rotate_to`
    where ``src`` is given) -> x's cotangent ``x_shape``, in ct's dtype."""
    d = eqv2_edge_rotate_reference(ct, gamma, beta, lmax, mmax, direction=_DUAL[direction], n_sel=n_sel)
    return _rotate_vjp_rows(d, src, x_shape).to(ct.dtype)
