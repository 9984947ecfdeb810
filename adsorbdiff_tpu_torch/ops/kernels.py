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
    where unnamed) on the first tensor's CUDA device, with no autograd."""
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


def _launch(kernel: str, lib: ctypes.CDLL, device: torch.device, *args) -> None:
    """Call ``<kernel>_f32(*args, stream)`` on the current stream of
    ``device``; raise on a non-zero cudaError, else count the launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, kernel + "_f32")(*args, stream)
    if err != 0:
        msg = getattr(lib, kernel + "_error_string")(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cudaError {err})")
    launches[kernel] += 1


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
    _check_cuda_inputs("painn_message_fused", tensors, {"src": torch.int32, "mask": torch.bool})
    if src.dim() != 3:
        raise ValueError(f"painn_message_fused: src must be [B, N, K], got {tuple(src.shape)}")
    b, n, k = src.shape
    if weight.dim() != 2 or weight.shape[0] < 2 or weight.shape[1] % 3:
        raise ValueError(f"painn_message_fused: weight must be [R>=2, 3H], got {tuple(weight.shape)}")
    r, f3 = weight.shape
    h = f3 // 3
    _check_shapes("painn_message_fused", tensors, dict(
        xh=(b, n, f3), vec=(b, n, f3), dist=(b, n, k), mask=(b, n, k), unit=(b, n, k, 3), bias=(f3,)))

    if b * n * h == 0:  # empty output: nothing to launch
        return xh.new_empty((b, n, h)), xh.new_empty((b, n, 3, h))
    dx = torch.empty((b, n, h), dtype=torch.float32, device=xh.device)
    dvec = torch.empty((b, n, 3, h), dtype=torch.float32, device=xh.device)
    lib = _library("painn_message_fused",
                   [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    _launch(
        "painn_message_fused", lib, xh.device,
        xh.data_ptr(), vec.data_ptr(), src.data_ptr(), dist.data_ptr(), mask.data_ptr(),
        unit.data_ptr(), weight.data_ptr(), bias.data_ptr(), dx.data_ptr(), dvec.data_ptr(),
        b, n, k, r, h, 1.0 / cutoff, int(envelope_exponent),
    )
    return dx, dvec


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
    eps = 1e-9
    n1h = n1 / torch.clamp(torch.linalg.norm(n1, dim=-1, keepdim=True), min=eps)
    n2h = n2 / torch.clamp(torch.linalg.norm(n2, dim=-1, keepdim=True), min=eps)
    cos = torch.clamp(torch.einsum("bnuqc,bnqkc->bnuqk", n1h, n2h), -1.0, 1.0)
    k1 = key1[:, :, :, None, None]
    keep = (k1 != key2[:, :, None, :, :]) & (k1 >= 0)
    ps = [torch.ones_like(cos), cos]
    for l in range(2, num_spherical):
        ps.append(((2 * l - 1) * cos * ps[l - 1] - (l - 1) * ps[l - 2]) / l)
    y = torch.stack([math.sqrt((2 * l + 1) / (4 * math.pi)) * ps[l] for l in range(num_spherical)], dim=-1)
    y = torch.where(keep[..., None], y, torch.zeros_like(y))
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
    backward comes with training).
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
    out = torch.empty((b, n, u, f, e), dtype=torch.float32, device=n1.device)
    lib = _library("gemnet_quad_chain", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    _launch(
        "gemnet_quad_chain", lib, n1.device,
        n1.data_ptr(), n2.data_ptr(), key1.data_ptr(), key2.data_ptr(), xm.data_ptr(), qp.data_ptr(),
        out.data_ptr(), b * n, u, q, k2, s, e, f,
    )
    return out
