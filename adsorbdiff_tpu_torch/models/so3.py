"""SO(3) machinery for EquiformerV2: real spherical harmonics, the decomposed
edge-frame Wigner rotation, S^2 grids and coefficient layouts.

Port of :mod:`adsorbdiff_tpu.models.so3`.  The numpy tables are this module's
own copies of the JAX package's (same code, so the same bits): the real-SH
basis (z-up, Condon-Shortley absorbed), the fixed change of frame ``J = D(Q)``
solved by least squares, the truncated m-primary layout (19 active rows at
lmax 4 / mmax 2), and the Gauss-Legendre S^2 grid.  These are what trained
weights mean, so nothing here may change them.

The torch functions apply the edge-frame rotation ``P D(R_e) = (P J) Dz(beta)
J^T Dz(gamma)`` (alpha = 0 gauge) as per-edge elementwise +-m mixing between
shared constant matmuls, never building per-edge Wigner matrices.  Their
constants live on the device in a cache keyed by table and device, so a
rotation copies nothing from the host after its first call.

``s2_grid_matrices(mode="e3nn")`` (the reference-checkpoint quadrature)
raises ``NotImplementedError``: it serves checkpoint imports, which are not
ported yet (ROADMAP item 13).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

try:  # scipy >= 1.15 renamed sph_harm (and swapped angle arguments)
    from scipy.special import sph_harm_y as _sph_harm_y

    def _sph_harm(m, l, phi, theta):
        return _sph_harm_y(l, m, theta, phi)

except ImportError:  # pragma: no cover
    from scipy.special import sph_harm as _sph_harm_legacy

    def _sph_harm(m, l, phi, theta):
        return _sph_harm_legacy(m, l, phi, theta)


# ------------------------------------------------------------------ host side
def real_sph_harm(lmax: int, vecs: np.ndarray) -> np.ndarray:
    """Real SH values Y[(l,m), point] for unit vectors [P, 3] (z-up,
    Condon-Shortley absorbed: m>0 ~ sqrt2 (-1)^m Re Y_l^m, m<0 ~ sqrt2 (-1)^m Im Y_l^|m|)."""
    vecs = np.asarray(vecs, np.float64)
    theta = np.arccos(np.clip(vecs[:, 2], -1, 1))  # polar from +z
    phi = np.arctan2(vecs[:, 1], vecs[:, 0])
    out = np.zeros(((lmax + 1) ** 2, len(vecs)))
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            idx = l * l + l + m
            y = _sph_harm(abs(m), l, phi, theta)  # (order m, degree l, azimuth, polar)
            if m > 0:
                out[idx] = math.sqrt(2.0) * (-1) ** m * y.real
            elif m < 0:
                out[idx] = math.sqrt(2.0) * (-1) ** m * y.imag
            else:
                out[idx] = y.real
    return out


def _rotation_matrix_to_D(lmax: int, rot: np.ndarray) -> np.ndarray:
    """Numerical block-diag D(R): solve Y(R v) = D Y(v) by least squares."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(4 * (lmax + 1) ** 2 + 16, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    y = real_sph_harm(lmax, pts)  # [(L)^2, P]
    y_rot = real_sph_harm(lmax, pts @ rot.T)
    d = np.zeros(((lmax + 1) ** 2, (lmax + 1) ** 2))
    for l in range(lmax + 1):
        sl = slice(l * l, (l + 1) * (l + 1))
        d[sl, sl] = np.linalg.lstsq(y[sl].T, y_rot[sl].T, rcond=None)[0].T
    return d


@functools.lru_cache(maxsize=8)
def get_J_matrix(lmax: int) -> np.ndarray:
    """J = D(Q) for Q = R_x(-pi/2) (maps the z-axis onto the y-axis),
    block-diagonal [(L)^2, (L)^2]."""
    q = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]])  # R_x(-pi/2): z -> +y
    return _rotation_matrix_to_D(lmax, q)


@functools.lru_cache(maxsize=8)
def _zrot_indices(lmax: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Static tables of the analytic z-rotation: R_z(t) acts on each
    (l, +-m) pair as [[cos mt, -s sin mt], [s sin mt, cos mt]], the sign s
    fixed numerically once.  Returns (|m| per row, +m rows, -m rows, s * m)."""
    dim = (lmax + 1) ** 2
    m_diag = np.zeros(dim)
    pair_i, pair_j, pair_m = [], [], []
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            idx = l * l + l + m
            m_diag[idx] = abs(m)
            if m > 0:
                i_pos, i_neg = l * l + l + m, l * l + l - m
                pair_i.append(i_pos)
                pair_j.append(i_neg)
                pair_m.append(m)
    t = 0.3
    rz = np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0], [0, 0, 1.0]])
    d = _rotation_matrix_to_D(lmax, rz)
    signs = []
    for i, j, m in zip(pair_i, pair_j, pair_m):
        signs.append(np.sign(d[i, j] / np.sin(m * t)))
    return m_diag, np.asarray(pair_i), np.asarray(pair_j), np.asarray(signs) * np.asarray(pair_m)


@functools.lru_cache(maxsize=8)
def zrot_swap_sign(lmax: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row tables for applying Dz(t) elementwise in the l-primary layout:
    ``(Dz(t) x)[i] = cos(m_i t) x[i] + sign_i sin(m_i t) x[swap_i]``, with swap
    the (l, m) <-> (l, -m) partner (self for m = 0, sign 0).

    Returns (m_row [dim] float32, swap [dim] int64, sign [dim] float32).
    """
    m_diag, pi, pj, signed_m = _zrot_indices(lmax)
    dim = (lmax + 1) ** 2
    swap = np.arange(dim)
    sign = np.zeros(dim, np.float32)
    swap[pi], swap[pj] = pj, pi
    sign[pi] = np.sign(signed_m)
    sign[pj] = -np.sign(signed_m)
    return m_diag.astype(np.float32), swap, sign


@functools.lru_cache(maxsize=8)
def _rot_decomp_mats(lmax: int, mmax: int, n_rows: int):
    """Constant matrices of the decomposed edge-frame rotation.

    Forward (global l-primary -> truncated m-primary edge frame), P J Dz(beta)
    J^T Dz(gamma): ``swap_mat [dim, dim]`` (row swap, for Dz(gamma)),
    ``jt2 [2 dim, dim] = [J^T; swap . J^T]`` (for Dz(beta)), ``pj2 [2 n_act,
    dim]`` (P J and its swap; the first n_act rows end the chain) and the Dz
    tables in both layouts.  Inverse (first ``n_rows`` truncated m-primary
    rows -> global), Dz(-gamma) J Dz(-beta) J^T P^T: ``jtp2 [2 dim, n_rows]``
    and ``j2 [2 dim, dim]``.
    """
    dim = (lmax + 1) ** 2
    m_row, swap, sign = zrot_swap_sign(lmax)
    order, ranges = m_primary_order(lmax, mmax)
    n_act = ranges[-1][1]
    j = np.asarray(get_J_matrix(lmax), np.float32)

    swap_mat = np.zeros((dim, dim), np.float32)
    swap_mat[np.arange(dim), swap] = 1.0
    jt = j.T
    jt2 = np.concatenate([jt, jt[swap]], axis=0)
    pj = j[order[:n_act], :]

    keep = order[:n_act]
    inv = {int(o): r for r, o in enumerate(keep)}
    m_row_m = m_row[keep]
    sign_m = sign[keep]
    swap_m = np.asarray([inv[int(swap[o])] for o in keep])
    pj2 = np.concatenate([pj, pj[swap_m]], axis=0)

    jtp = j[order[:n_rows], :].T
    jtp2 = np.concatenate([jtp, jtp[swap]], axis=0)
    j2 = np.concatenate([j, j[swap]], axis=0)
    return swap_mat, jt2, pj2, (m_row_m, sign_m), (m_row, sign), jtp2, j2, n_act


@functools.lru_cache(maxsize=8)
def n_act_rows(lmax: int, mmax: int) -> int:
    """Number of active rows in the truncated m-primary layout."""
    return int(m_primary_order(lmax, mmax)[1][-1][1])


@functools.lru_cache(maxsize=8)
def l_expand_matrix(lmax: int) -> np.ndarray:
    """[(lmax+1)^2, lmax+1] one-hot: row (l, m) selects column l."""
    dim = (lmax + 1) ** 2
    e = np.zeros((dim, lmax + 1), np.float32)
    for l in range(lmax + 1):
        e[l * l : (l + 1) * (l + 1), l] = 1.0
    return e


@functools.lru_cache(maxsize=16)
def s2_grid_matrices(lmax: int, res_beta: int, res_alpha: int,
                     mode: str = "gauss") -> Tuple[np.ndarray, np.ndarray]:
    """(to_grid [G, (L)^2], from_grid [(L)^2, G]) with from @ to == I:
    Gauss-Legendre nodes in cos(beta) x uniform alpha, 'integral'-normalised
    basis (the JAX package's ``mode="gauss"``, bit for bit)."""
    if mode == "e3nn":
        raise NotImplementedError(
            "s2_grid_matrices(mode='e3nn') serves reference-checkpoint imports, not ported yet (ROADMAP item 13)")
    if mode != "gauss":
        raise ValueError(f"unknown s2 grid mode {mode!r}")
    alphas = np.linspace(0, 2 * np.pi, res_alpha, endpoint=False)
    ct, w_beta = np.polynomial.legendre.leggauss(res_beta)
    st = np.sqrt(1 - ct**2)
    pts = np.stack(
        [
            np.outer(st, np.cos(alphas)).ravel(),
            np.outer(st, np.sin(alphas)).ravel(),
            np.outer(ct, np.ones_like(alphas)).ravel(),
        ],
        axis=-1,
    )
    y = real_sph_harm(lmax, pts)  # [(L)^2, G]
    w = (np.outer(w_beta, np.ones_like(alphas)) * (2 * np.pi / res_alpha)).ravel()
    to_grid = y.T
    from_grid = y * w  # quadrature: integral of Y_i Y_j over S^2 = delta_ij
    return to_grid.astype(np.float32), from_grid.astype(np.float32)


@functools.lru_cache(maxsize=8)
def m_primary_order(lmax: int, mmax: int) -> Tuple[np.ndarray, tuple]:
    """Row order of the m-primary layout and its block ranges: [m=0 block
    (l=0..lmax)], then for m=1..mmax [+m block (l=m..lmax), -m block], then
    the unused |m| > mmax rows.  Returns (perm [dim], perm[new_row] = old
    l-primary index; ranges, (start, stop) per block in the order m0, +1, -1,
    +2, -2, ...)."""
    order = []
    ranges = []
    start = 0
    idx0 = [l * l + l for l in range(lmax + 1)]
    order += idx0
    ranges.append((start, start + len(idx0)))
    start += len(idx0)
    for m in range(1, mmax + 1):
        pos = [l * l + l + m for l in range(m, lmax + 1)]
        neg = [l * l + l - m for l in range(m, lmax + 1)]
        order += pos
        ranges.append((start, start + len(pos)))
        start += len(pos)
        order += neg
        ranges.append((start, start + len(neg)))
        start += len(neg)
    used = set(order)
    tail = [i for i in range((lmax + 1) ** 2) if i not in used]
    order += tail
    return np.asarray(order, np.int64), tuple(ranges)


@functools.lru_cache(maxsize=8)
def m_trunc_rescale(lmax: int, mmax: int) -> np.ndarray:
    """Per-coefficient rescale for m-truncated rotate_inv / S^2 grids: rows
    with l > mmax scale by sqrt((2l+1)/(2mmax+1)).  Returns [(lmax+1)^2]."""
    scale = np.ones((lmax + 1) ** 2, np.float32)
    for l in range(mmax + 1, lmax + 1):
        scale[l * l : (l + 1) * (l + 1)] = math.sqrt((2 * l + 1) / (2 * mmax + 1))
    return scale


# ------------------------------------------------------------------ device side
_DEVICE_TABLES: Dict[tuple, Tuple[np.ndarray, torch.Tensor]] = {}


def device_table(table: np.ndarray, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``table`` (an array that a cached table function returned) as a tensor
    on ``device``, copied once per (table, device, dtype)."""
    key = (id(table), str(device), dtype)
    hit = _DEVICE_TABLES.get(key)
    if hit is None or hit[0] is not table:
        hit = (table, torch.as_tensor(np.ascontiguousarray(table), dtype=dtype, device=device))
        _DEVICE_TABLES[key] = hit  # keeps ``table`` alive, so its id is not reused
    return hit[1]


def edge_euler_angles(unit: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauge-fixed Euler angles (gamma, beta) of the edge frame that maps the
    unit vector onto e_z, ``R_e = Ry(beta) Rz(gamma)``: beta = arccos(u_z),
    gamma = atan2(u_y, -u_x)."""
    beta = torch.arccos(torch.clamp(unit[..., 2], -1.0, 1.0))
    gamma = torch.atan2(unit[..., 1], -unit[..., 0])
    return gamma, beta


def _cs(angle: torch.Tensor, m_row: np.ndarray, sign: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos(m t) and sign-folded sin(m t) row tables, [..., n_rows, 1]."""
    a = angle[..., None] * device_table(m_row, angle.device)
    return torch.cos(a)[..., None], (torch.sin(a) * device_table(sign, angle.device))[..., None]


def rotate_to_edge_m(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, lmax: int, mmax: int) -> torch.Tensor:
    """The truncated m-primary edge-frame rotation ``P D(R_e)`` of ``x [...,
    (L)^2, C]`` -> ``[..., n_act, C]``.  ``gamma``/``beta`` broadcast against
    x's leading dims; a node-level x with a singleton neighbour axis is
    broadcast to the edges at the first elementwise stage."""
    _, jt2, pj2, _, (m_row, sign), _, _, n_act = _rot_decomp_mats(lmax, mmax, n_act_rows(lmax, mmax))
    swap = zrot_swap_sign(lmax)[1]
    dev = x.device
    dim = x.shape[-2]
    cg, sg = _cs(gamma, m_row, sign)
    cb, sb = _cs(beta, m_row, sign)
    xs = x[..., device_table(swap, dev, torch.long), :]  # = swap_mat @ x
    t1 = x * cg + xs * sg  # Dz(gamma)
    t2 = torch.matmul(device_table(jt2, dev), t1)
    t3 = t2[..., :dim, :] * cb + t2[..., dim:, :] * sb  # Dz(beta)
    return torch.matmul(device_table(pj2, dev)[:n_act], t3)


def rotate_from_edge_m(v: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, lmax: int, mmax: int) -> torch.Tensor:
    """Inverse of :func:`rotate_to_edge_m` on the leading ``n_rows =
    v.shape[-2]`` truncated m-primary rows: ``D(R_e)^T P^T`` as Dz(-gamma) J
    Dz(-beta) (J^T P^T).  Returns ``[..., (L)^2, C]``."""
    n_rows = v.shape[-2]
    _, _, _, _, (m_row, sign), jtp2, j2, _ = _rot_decomp_mats(lmax, mmax, n_rows)
    dev = v.device
    dim = (lmax + 1) ** 2
    cb, sb = _cs(beta, m_row, sign)
    cg, sg = _cs(gamma, m_row, sign)
    t1 = torch.matmul(device_table(jtp2, dev), v)
    t2 = t1[..., :dim, :] * cb - t1[..., dim:, :] * sb  # Dz(-beta)
    t3 = torch.matmul(device_table(j2, dev), t2)
    return t3[..., :dim, :] * cg - t3[..., dim:, :] * sg  # Dz(-gamma)


def l1_coeffs_to_vector(coeffs: torch.Tensor) -> torch.Tensor:
    """Real-SH l=1 coefficients (m=-1, 0, 1) -> cartesian vector: Y_{1,-1} ~
    y, Y_{1,0} ~ z, Y_{1,1} ~ x (one common constant, which a learned head
    absorbs)."""
    return torch.stack([coeffs[..., 2], coeffs[..., 0], coeffs[..., 1]], dim=-1)
