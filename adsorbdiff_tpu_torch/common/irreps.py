"""Irreps helpers: rank-2 tensor <-> irreps change of basis.

The port's own copy of :mod:`adsorbdiff_tpu.common.irreps` (``cg_change_mat``
and ``irreps_sum`` of the reference's utils): a 3x3 tensor decomposes as 0e
(trace) + 1e (antisym) + 2e (sym traceless); the change-of-basis matrix maps
flattened [9] tensors to [1 + 3 + 5] irreps coefficients.
"""
from __future__ import annotations

import numpy as np


def irreps_sum(l: int) -> int:
    """Total dimension of irreps 0..l."""
    return sum(2 * k + 1 for k in range(l + 1))


def cg_change_mat(rank: int) -> np.ndarray:
    """[9, 9] change of basis for rank-2 tensors (float64)."""
    if rank != 2:
        raise NotImplementedError
    s2 = 1 / np.sqrt(2)
    s3 = 1 / np.sqrt(3)
    s6 = 1 / np.sqrt(6)
    # rows: flattened tensor index (xx,xy,xz,yx,yy,yz,zx,zy,zz)
    # cols: [trace(0e) | antisym y,z,x (1e) | sym-traceless 5 comps (2e)]
    m = np.zeros((9, 9))
    # 0e: (xx + yy + zz)/sqrt3
    for i in (0, 4, 8):
        m[i, 0] = s3
    # 1e: a_x=(zy-yz), a_y=(xz-zx), a_z=(yx-xy), each /sqrt2
    m[7, 1], m[5, 1] = s2, -s2  # x: zy - yz
    m[2, 2], m[6, 2] = s2, -s2  # y: xz - zx
    m[3, 3], m[1, 3] = s2, -s2  # z: yx - xy
    # 2e (real SH m=-2..2 order): xy+yx, yz+zy, (2zz-xx-yy)/sqrt3, xz+zx, xx-yy
    m[1, 4], m[3, 4] = s2, s2
    m[5, 5], m[7, 5] = s2, s2
    m[0, 6], m[4, 6], m[8, 6] = -s6, -s6, 2 * s6
    m[2, 7], m[6, 7] = s2, s2
    m[0, 8], m[4, 8] = s2, -s2
    return m
