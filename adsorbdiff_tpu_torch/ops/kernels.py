"""Hopper kernels of the port and their plain PyTorch versions.

Counterpart of :mod:`adsorbdiff_tpu.ops.pallas_kernels`.  Each kernel has:

- a wrapper with the JAX function's name and signature, which checks its
  inputs, allocates the outputs and, on a CUDA tensor, launches the kernel
  (built from ``csrc/`` on first use) or raises.  On a CPU tensor it calls the
  plain version: that is the only way the plain version is reached;
- a plain PyTorch version (``*_reference``) with the same signature, for the
  CPU tests and for holding the kernel against on the card;
- a launch count in :data:`launches`, raised by one where the wrapper
  launches the kernel and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import Tuple

import torch

from adsorbdiff_tpu_torch.ops import build

# kernel name -> launches in this process; reset with ``launches.clear()``
launches: "collections.Counter[str]" = collections.Counter()


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
    """Plain PyTorch version of :func:`painn_message_fused`: the whole
    ``[B, N, K, 3H]`` filter and gathered features are materialised."""
    b, n, k = src.shape
    r, f3 = weight.shape
    h = f3 // 3
    d = dist.float() * (1.0 / cutoff)
    p = float(envelope_exponent)
    env = 1 + (-(p + 1) * (p + 2) / 2) * d**p + p * (p + 2) * d ** (p + 1) + (-p * (p + 1) / 2) * d ** (p + 2)
    env = torch.where(d < 1.0, env, torch.zeros_like(env))
    offsets = torch.arange(r, device=d.device, dtype=torch.float32) / (r - 1)
    basis = torch.exp(-0.5 * (r - 1) ** 2 * (d[..., None] - offsets) ** 2) * env[..., None]
    filt = (basis @ weight.float() + bias.float()) * mask[..., None].float()  # [B, N, K, 3H]
    idx = src.reshape(b, n * k, 1).long().expand(-1, -1, f3)
    xh_g = torch.gather(xh.float(), 1, idx).reshape(b, n, k, f3)
    vec_g = torch.gather(vec.float(), 1, idx).reshape(b, n, k, f3)
    g = xh_g * filt
    g1, g2, g3 = g[..., :h], g[..., h : 2 * h] * (1.0 / math.sqrt(3.0)), g[..., 2 * h :]
    dx = torch.sum(g1, dim=2)
    dvec = torch.einsum("bnkd,bnkh->bndh", unit.float(), g3) + torch.sum(
        vec_g.reshape(b, n, k, 3, h) * g2[..., None, :], dim=2
    )
    return dx, dvec


def _painn_message_fused_lib() -> ctypes.CDLL:
    lib = build.load("painn_message_fused")
    fn = lib.painn_message_fused_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.painn_message_fused_error_string.argtypes = [ctypes.c_int]
        lib.painn_message_fused_error_string.restype = ctypes.c_char_p
    return lib


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
    bool, and no autograd (the backward kernel comes with training).
    """
    if xh.device.type == "cpu":
        return painn_message_fused_reference(
            xh, vec, src, dist, mask, unit, weight, bias,
            cutoff=cutoff, envelope_exponent=envelope_exponent,
        )
    tensors = dict(xh=xh, vec=vec, src=src, dist=dist, mask=mask, unit=unit, weight=weight, bias=bias)
    if xh.device.type != "cuda":
        raise ValueError(f"painn_message_fused: unsupported device {xh.device}")
    for name, t in tensors.items():
        if t.device != xh.device:
            raise ValueError(f"painn_message_fused: {name} is on {t.device}, xh on {xh.device}")
        if not t.is_contiguous():
            raise ValueError(f"painn_message_fused: {name} must be contiguous")
        want = {"src": torch.int32, "mask": torch.bool}.get(name, torch.float32)
        if t.dtype != want:
            raise TypeError(f"painn_message_fused: {name} must be {want}, got {t.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise NotImplementedError("painn_message_fused has no backward kernel on CUDA yet")
    if src.dim() != 3:
        raise ValueError(f"painn_message_fused: src must be [B, N, K], got {tuple(src.shape)}")
    b, n, k = src.shape
    if weight.dim() != 2 or weight.shape[0] < 2 or weight.shape[1] % 3:
        raise ValueError(f"painn_message_fused: weight must be [R>=2, 3H], got {tuple(weight.shape)}")
    r, f3 = weight.shape
    h = f3 // 3
    expected = dict(xh=(b, n, f3), vec=(b, n, f3), dist=(b, n, k), mask=(b, n, k), unit=(b, n, k, 3), bias=(f3,))
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"painn_message_fused: {name} has shape {tuple(tensors[name].shape)}, want {shape}")

    dx = torch.empty((b, n, h), dtype=torch.float32, device=xh.device)
    dvec = torch.empty((b, n, 3, h), dtype=torch.float32, device=xh.device)
    lib = _painn_message_fused_lib()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = lib.painn_message_fused_f32(
            xh.data_ptr(), vec.data_ptr(), src.data_ptr(), dist.data_ptr(), mask.data_ptr(),
            unit.data_ptr(), weight.data_ptr(), bias.data_ptr(), dx.data_ptr(), dvec.data_ptr(),
            b, n, k, r, h, 1.0 / cutoff, int(envelope_exponent), stream,
        )
    if err != 0:
        msg = lib.painn_message_fused_error_string(err).decode()
        raise RuntimeError(f"painn_message_fused launch failed: {msg} (cudaError {err})")
    launches["painn_message_fused"] += 1
    return dx, dvec
