"""Shared model layers: activation, atom embedding, radial basis, scale factor.

Port of :mod:`adsorbdiff_tpu.models.layers` for the gaussian basis that PaiNN
uses.  The spherical-Bessel and Bernstein bases come with GemNet-OC.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
from torch import nn


def scaled_silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU * 1/0.6 (GemNet-OC's ScaledSiLU)."""
    return torch.nn.functional.silu(x) * (1.0 / 0.6)


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


class RadialBasis(nn.Module):
    """Envelope(d/cutoff) * RBF(d/cutoff), gaussian basis only."""

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
        if self.rbf_name in ("spherical_bessel", "bernstein"):
            raise NotImplementedError(f"radial basis '{self.rbf_name}' is not ported yet")
        if self.rbf_name != "gaussian":
            raise ValueError(f"Unknown radial basis function '{self.rbf_name}'.")

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        d_scaled = d * (1.0 / self.cutoff)
        if self.env_name == "polynomial":
            env = polynomial_envelope(d_scaled, self.env_exponent)
        else:
            env = exponential_envelope(d_scaled)
        return env[..., None] * gaussian_basis(d_scaled, 0.0, 1.0, self.num_radial)


class ScaleFactor(nn.Module):
    """Fitted, non-trainable scalar that equalises activation variance, kept
    as the buffer ``scale_factor`` (the reference checkpoint's name)."""

    def __init__(self, value: float = 1.0) -> None:
        super().__init__()
        self.register_buffer("scale_factor", torch.tensor(float(value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale_factor


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In-place N(0, 1/fan_in) init of a torch ``[out, in]`` weight, the
    variance of flax's default ``lecun_normal`` Dense init."""
    with torch.no_grad():
        fan_in = weight.shape[1]
        weight.copy_(torch.randn(weight.shape, generator=generator, dtype=weight.dtype) / math.sqrt(fan_in))
    return weight
