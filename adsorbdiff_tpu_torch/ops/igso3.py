"""IGSO(3) (isotropic Gaussian on SO(3)) sampling and score tables.

Port of :mod:`adsorbdiff_tpu.ops.igso3`.  The tables (the truncated series
f(w; eps) = sum_l (2l+1) e^{-l(l+1) eps^2} sin(w(l+1/2)) / sin(w/2) over a
log-spaced eps grid x an omega grid on (0, pi]: its CDF, its score d/dw log f
and the expected score norm) are built once in float64 numpy as the JAX
package builds them, and cached as an ``.npz`` in the port's git-ignored
``_cache/`` directory.  One deliberate difference: the expected score norm
leaves out the unresolved tail of the series (see :func:`_build_tables`),
where the JAX table is non-finite or far off.  Lookups are
``torch.searchsorted`` interpolations that follow ``jnp.interp``'s formula,
so both packages pick the same interval even where a CDF row repeats values
(small eps).

The samplers take their random numbers as arguments (``normals``,
``uniforms``; :func:`adsorbdiff_tpu_torch.diffusion.schedules.draw_schedule`
makes them), which is how the tests feed both frameworks the same numbers.
"""
from __future__ import annotations

import functools
import os
import tempfile
from typing import NamedTuple, Tuple

import numpy as np
import torch

MIN_EPS, MAX_EPS, N_EPS = 0.01, 2.0, 1000
X_N = 2000  # omega grid size
L_TRUNC = 2000  # series truncation

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_cache")
_LOG_MIN = np.float32(np.log10(MIN_EPS))
_LOG_SPAN = np.float32(np.log10(MAX_EPS) - np.log10(MIN_EPS))
# jnp.interp treats an interval narrower than this as having zero width
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def _build_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(omegas [X_N], cdf [N_EPS, X_N], score [N_EPS, X_N], exp_score_norm
    [N_EPS]) in float64, as two matmuls (exp-factors @ sin-basis).  The
    score table keeps the unresolved tail as it comes (inverse-CDF samples
    never land there: the CDF is flat over it)."""
    eps = 10.0 ** np.linspace(np.log10(MIN_EPS), np.log10(MAX_EPS), N_EPS)
    omegas = np.linspace(0, np.pi, X_N + 1)[1:]  # (0, pi]
    ls = np.arange(L_TRUNC, dtype=np.float64)

    exp_factors = (2 * ls + 1)[None, :] * np.exp(-ls[None, :] * (ls[None, :] + 1) * (eps**2)[:, None])
    lo = np.sin(omegas / 2)
    dlo = 0.5 * np.cos(omegas / 2)
    hi = np.sin(np.outer(ls + 0.5, omegas))
    dhi = (ls + 0.5)[:, None] * np.cos(np.outer(ls + 0.5, omegas))

    expansion = exp_factors @ (hi / lo[None, :])
    pdf = expansion * (1 - np.cos(omegas))[None, :] / np.pi
    cdf = pdf.cumsum(axis=1) / X_N * np.pi

    score_basis = (lo[None, :] * dhi - hi * dlo[None, :]) / (lo[None, :] ** 2)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        score = (exp_factors @ score_basis) / expansion
        # At small eps the density's tail lies below the float64 round-off of
        # the series (~1e-17 of the peak): there the expansion is noise of
        # either sign, or exactly 0, and the score noise / noise.  The expected
        # norm sums over the resolved points only.  The JAX package sums the
        # noise too, which leaves its norm non-finite or wrong by orders of
        # magnitude for eps in ~[0.03, 0.25]; elsewhere the two agree in f32.
        resolved = expansion > 1e-13 * expansion.max(axis=1, keepdims=True)
        weighted = np.where(resolved, score**2 * pdf, 0.0)
    exp_score_norm = np.sqrt(np.sum(weighted, axis=1) / np.sum(np.where(resolved, pdf, 0.0), axis=1) / np.pi)
    return omegas, cdf, score, exp_score_norm


class IGSO3Tables(NamedTuple):
    """float32 numpy tables."""

    omegas: np.ndarray  # [X_N]
    cdf: np.ndarray  # [N_EPS, X_N]
    score_norms: np.ndarray  # [N_EPS, X_N]
    exp_score_norms: np.ndarray  # [N_EPS]


@functools.lru_cache(maxsize=1)
def get_tables() -> IGSO3Tables:
    """The tables, built (a few seconds) and cached on first use."""
    path = os.path.join(CACHE_DIR, f"igso3_e{N_EPS}_w{X_N}_l{L_TRUNC}_resolved.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            arrs = (z["omegas"], z["cdf"], z["score"], z["exp_score_norm"])
    else:
        arrs = _build_tables()
        os.makedirs(CACHE_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".npz", dir=CACHE_DIR)  # one per writer: concurrent builds do not clash
        os.close(fd)
        omegas, cdf, score, exp_score_norm = arrs
        np.savez_compressed(tmp, omegas=omegas, cdf=cdf, score=score, exp_score_norm=exp_score_norm)
        os.replace(tmp, path)
    with np.errstate(over="ignore"):  # the score table's unresolved tail overflows f32
        return IGSO3Tables(*(np.asarray(a, dtype=np.float32) for a in arrs))


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The tables on ``device``, copied once per device."""
    return tuple(torch.from_numpy(a).to(device) for a in get_tables())


def _tables_for(t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    device = t.device
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _device_tables(device)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` batched over rows: ``x [...]``; ``xp`` and
    ``fp`` ``[..., X]`` (one row per element of ``x``) or ``[X]`` (shared).

    jnp's formula: ``i = clip(searchsorted(xp, x, side="right"), 1, X-1)``,
    ``f = fp[i-1] + (x - xp[i-1]) / dx * df`` with ``f = fp[i-1]`` on a
    zero-width interval (``|dx| <= spacing(eps_f32)``), and ``fp[0]`` /
    ``fp[-1]`` below ``xp[0]`` / above ``xp[-1]``.
    """
    n = xp.shape[-1]
    xp = xp.expand(x.shape + (n,)).contiguous()
    fp = fp.expand(x.shape + (n,))
    i = torch.searchsorted(xp, x[..., None].contiguous(), right=True).clamp(1, n - 1)

    def take(a, j):
        return torch.gather(a, -1, j)[..., 0]

    x_lo, f_lo = take(xp, i - 1), take(fp, i - 1)
    dx = take(xp, i) - x_lo
    df = take(fp, i) - f_lo
    zero = dx.abs() <= _INTERP_EPS
    f = torch.where(zero, f_lo, f_lo + ((x - x_lo) / torch.where(zero, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[..., 0], fp[..., 0], f)
    return torch.where(x > xp[..., -1], fp[..., -1], f)


def eps_index(eps: torch.Tensor) -> torch.Tensor:
    """Log-spaced grid index with the reference's rounding: ``round(log-relative
    * N_EPS)`` (N_EPS, not N_EPS - 1), clipped, in float32 as JAX takes it."""
    idx = (torch.log10(eps.float()) - float(_LOG_MIN)) / float(_LOG_SPAN) * N_EPS
    return torch.clamp(torch.round(idx).long(), 0, N_EPS - 1)


def sample_omega(eps: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sample of the rotation angle, batched over ``eps [...]``,
    at ``uniforms`` (shape of eps, in [0, 1))."""
    omegas, cdf, _, _ = _tables_for(eps)
    return interp(uniforms.float(), cdf[eps_index(eps)], omegas)


def sample_vec(eps: torch.Tensor, normals: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Axis-angle samples from IGSO(3), shape ``eps.shape + (3,)``: a uniform
    direction (``normals [..., 3]`` standard normal, normalised) times
    :func:`sample_omega` at ``uniforms``."""
    x = normals / torch.linalg.norm(normals, dim=-1, keepdim=True)
    return x * sample_omega(eps, uniforms)[..., None]


def score_vec(eps: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Score of IGSO(3) at axis-angle ``vec`` (``eps [...]``, ``vec [..., 3]``)."""
    omegas, _, score_norms, _ = _tables_for(eps)
    om = torch.linalg.norm(vec, dim=-1)
    mag = interp(om, omegas, score_norms[eps_index(eps)])
    return mag[..., None] * vec / torch.clamp(om, min=1e-12)[..., None]


def score_norm(eps: torch.Tensor) -> torch.Tensor:
    """Expected score norm sqrt(E[|score|^2]) at ``eps``."""
    return _tables_for(eps)[3][eps_index(eps)]
