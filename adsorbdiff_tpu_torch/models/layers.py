"""Shared model layers: activation, atom embedding, radial basis, scale factor.

Port of :mod:`adsorbdiff_tpu.models.layers`: the gaussian basis (PaiNN's
and EquiformerV2's) and the trainable spherical-Bessel and Bernstein bases
(GemNet-OC's ``rbf`` options), and the compute dtype of ``compute_dtype:
bfloat16`` (:func:`resolve_compute_dtype`, :class:`Linear`).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn


def resolve_compute_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """A model's ``compute_dtype`` config value as a torch dtype: ``None``
    (full precision) or ``"bfloat16"``; anything else raises ``ValueError``.
    The port's counterpart of the JAX package's ``compute_dtype_scope``: a
    model resolves it once at construction and hands it to its layers."""
    if name is None:
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be None or 'bfloat16', got {name!r}")


class Linear(nn.Linear):
    """``nn.Linear`` that computes as flax's ``nn.Dense(dtype=cdt)``: with
    ``cdt`` set, input, weight and bias are cast to it (the f32 parameters
    get their gradient through the cast); with ``cdt=None``, in the
    promoted dtype of input and weight (a bf16 input meets an f32 layer as
    it does in JAX: widened)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 cdt: Optional[torch.dtype] = None) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.cdt = cdt

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cdt or torch.promote_types(x.dtype, self.weight.dtype)
        if dt == x.dtype == self.weight.dtype:  # nothing to cast (the f32 path)
            return torch.nn.functional.linear(x, self.weight, self.bias)
        bias = None if self.bias is None else self.bias.to(dt)
        return torch.nn.functional.linear(x.to(dt), self.weight.to(dt), bias)


@functools.lru_cache(maxsize=None)
def _rounded_scalar(c: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(c, dtype=dtype))


def mul(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x * c`` as JAX computes it for a Python float ``c``: ``c`` is weakly
    typed, so a bf16 ``x`` meets ``c`` rounded to bf16 (``1/sqrt(2)`` becomes
    0.70703125); torch would multiply by the unrounded ``c``.  For f32 ``x``
    it is ``x * c``."""
    return x * (c if x.dtype == torch.float32 else _rounded_scalar(c, x.dtype))


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as JAX computes it for a Python float ``c`` (rounded to a
    bf16 ``x``'s dtype first, as :func:`mul`)."""
    return x / (c if x.dtype == torch.float32 else _rounded_scalar(c, x.dtype))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: in bf16 it is ``x * 1 / (1 + exp(-x))`` with each step
    rounded to bf16, as XLA computes it; torch's fused SiLU would round once."""
    if x.dtype == torch.float32:
        return torch.nn.functional.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def scaled_silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU * 1/0.6 (GemNet-OC's ScaledSiLU).  In bf16 it rounds where JAX
    does: :func:`silu`'s steps, and 1/0.6 is the bf16 1.6640625 (a Python
    float, weakly typed); torch's fused SiLU would round once, and bias the
    result by ~0.2%."""
    if x.dtype == torch.float32:
        return torch.nn.functional.silu(x) * (1.0 / 0.6)
    return mul(silu(x), 1.0 / 0.6)


class ScaledSiLU(nn.Module):
    """Module form of :func:`scaled_silu`, so ``nn.Sequential`` indices match
    the reference's parameter names (``x_proj.0``, ``x_proj.2``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return scaled_silu(x)


class AtomEmbedding(nn.Module):
    """Element embedding looked up at Z-1.  ``z - 1`` is clipped into
    ``[0, num_elements - 1]``: padded slots carry Z=0 and would otherwise
    index -1; their features are junk by design and masked at every use."""

    def __init__(self, emb_size: int, num_elements: int = 83) -> None:
        super().__init__()
        self.num_elements = num_elements
        self.embeddings = nn.Embedding(num_elements, emb_size)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.embeddings(torch.clamp(z.long() - 1, 0, self.num_elements - 1))


def polynomial_envelope(d_scaled: torch.Tensor, exponent: int = 5) -> torch.Tensor:
    """Smooth-cutoff polynomial envelope."""
    p = float(exponent)
    a = -(p + 1) * (p + 2) / 2
    b = p * (p + 2)
    c = -p * (p + 1) / 2
    env = 1 + a * d_scaled**p + b * d_scaled ** (p + 1) + c * d_scaled ** (p + 2)
    return torch.where(d_scaled < 1, env, torch.zeros_like(env))


def exponential_envelope(d_scaled: torch.Tensor) -> torch.Tensor:
    """SpookyNet exponential envelope."""
    inside = torch.abs(d_scaled) < 1
    safe = torch.where(inside, d_scaled, torch.zeros_like(d_scaled))
    env = torch.exp(-(safe**2) / ((1 - safe) * (1 + safe)))
    return torch.where(inside, env, torch.zeros_like(env))


def gaussian_basis(d: torch.Tensor, start: float, stop: float, num: int) -> torch.Tensor:
    """Gaussian RBF grid over [start, stop]."""
    offset = torch.linspace(start, stop, num, dtype=d.dtype, device=d.device)
    coeff = -0.5 / ((stop - start) / (num - 1)) ** 2
    diff = d[..., None] - offset
    return torch.exp(coeff * diff * diff)


class SphericalBesselBasis(nn.Module):
    """``sqrt(2 / cutoff^3) sin(f_n d) / d`` of ``d = d / cutoff``, with the
    ``frequencies`` f trainable from ``pi * (1..R)``."""

    def __init__(self, num_radial: int, cutoff: float) -> None:
        super().__init__()
        self.norm_const = math.sqrt(2.0 / cutoff**3)
        self.frequencies = nn.Parameter(torch.from_numpy(np.pi * np.arange(1, num_radial + 1, dtype=np.float32)))

    def forward(self, d_scaled: torch.Tensor) -> torch.Tensor:
        safe = torch.clamp(d_scaled, min=1e-9)[..., None]
        return self.norm_const / safe * torch.sin(self.frequencies * safe)


class BernsteinBasis(nn.Module):
    """SpookyNet's Bernstein polynomials of ``exp(-gamma d)``, with ``gamma =
    softplus(pregamma)`` and the scalar ``pregamma`` trainable from
    ``pregamma_initial``."""

    def __init__(self, num_radial: int, pregamma_initial: float = 0.45264) -> None:
        from scipy.special import binom  # the JAX package's prefactor, in double and rounded to f32

        super().__init__()
        exp1 = np.arange(num_radial, dtype=np.float32)
        prefactor = binom(num_radial - 1, np.arange(num_radial)).astype(np.float32)
        self.register_buffer("prefactor", torch.from_numpy(prefactor), persistent=False)
        self.register_buffer("exp1", torch.from_numpy(exp1), persistent=False)
        self.register_buffer("exp2", torch.from_numpy((num_radial - 1) - exp1), persistent=False)
        self.pregamma = nn.Parameter(torch.tensor(float(pregamma_initial)))

    def forward(self, d_scaled: torch.Tensor) -> torch.Tensor:
        gamma = torch.nn.functional.softplus(self.pregamma)
        exp_d = torch.exp(-gamma * d_scaled)[..., None]
        return self.prefactor * exp_d**self.exp1 * (1 - exp_d) ** self.exp2


class RadialBasis(nn.Module):
    """Envelope(d/cutoff) * RBF(d/cutoff).  ``rbf["name"]``: ``gaussian``
    (fixed), ``spherical_bessel`` or ``bernstein`` (the module ``.rbf``,
    whose parameters train: ``rbf.frequencies``, ``rbf.pregamma``, the
    reference's names); envelopes ``polynomial`` (``exponent``) and
    ``exponential``."""

    def __init__(
        self,
        num_radial: int,
        cutoff: float,
        rbf: Optional[Dict[str, Union[str, int]]] = None,
        envelope: Optional[Dict[str, Union[str, int]]] = None,
    ) -> None:
        super().__init__()
        self.num_radial = num_radial
        self.cutoff = cutoff
        rbf = dict(rbf or {"name": "gaussian"})
        envelope = dict(envelope or {"name": "polynomial", "exponent": 5})
        self.rbf_name = str(rbf.pop("name")).lower()
        self.env_name = str(envelope.pop("name")).lower()
        self.env_exponent = int(envelope.get("exponent", 5))
        if self.env_name not in ("polynomial", "exponential"):
            raise ValueError(f"Unknown envelope function '{self.env_name}'.")
        if self.rbf_name == "spherical_bessel":
            self.rbf = SphericalBesselBasis(num_radial, cutoff)
        elif self.rbf_name == "bernstein":
            self.rbf = BernsteinBasis(num_radial, float(rbf.get("pregamma_initial", 0.45264)))
        elif self.rbf_name != "gaussian":
            raise ValueError(f"Unknown radial basis function '{self.rbf_name}'.")

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        d_scaled = d * (1.0 / self.cutoff)
        if self.env_name == "polynomial":
            env = polynomial_envelope(d_scaled, self.env_exponent)
        else:
            env = exponential_envelope(d_scaled)
        if self.rbf_name == "gaussian":
            return env[..., None] * gaussian_basis(d_scaled, 0.0, 1.0, self.num_radial)
        return env[..., None] * self.rbf(d_scaled)


class ScaleFactor(nn.Module):
    """Fitted, non-trainable scalar that equalises activation variance, kept
    as the buffer ``scale_factor`` (the reference checkpoint's name)."""

    def __init__(self, value: float = 1.0) -> None:
        super().__init__()
        self.register_buffer("scale_factor", torch.tensor(float(value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the product's dtype is JAX's: a bf16 x times the f32 factor is f32
        # (torch would keep a 0-dim factor's product in bf16)
        return x.to(torch.promote_types(x.dtype, self.scale_factor.dtype)) * self.scale_factor


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In-place N(0, 1/fan_in) init of a torch ``[out, in]`` weight, the
    variance of flax's default ``lecun_normal`` Dense init."""
    with torch.no_grad():
        fan_in = weight.shape[1]
        weight.copy_(torch.randn(weight.shape, generator=generator, dtype=weight.dtype) / math.sqrt(fan_in))
    return weight
