"""SO(3) helpers: axis-angle / quaternion conversions.

Port of :mod:`adsorbdiff_tpu.ops.rotation` (itself after the pytorch3d-derived
converters of the AdsorbDiff reference, rot_utils.py:18-98).  Batched over
leading axes; the small-angle branch selects with ``torch.where`` on a safe
denominator so gradients stay finite at zero.
"""
from __future__ import annotations

import torch


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle -> [..., 4] quaternion (real part first), with the
    sin(x/2)/x ~ 1/2 - x^2/48 expansion below an angle of 1e-6."""
    n2 = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    small = n2 < 1e-12  # |angle| < 1e-6, reference threshold
    angles = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    ratio = torch.where(small, 0.5 - n2 / 48.0, torch.sin(0.5 * angles) / angles)
    cos_half = torch.where(small, 1.0 - n2 / 8.0, torch.cos(0.5 * angles))
    return torch.cat([cos_half, axis_angle * ratio], dim=-1)


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """[..., 4] quaternion (real first) -> [..., 3, 3] rotation matrix."""
    r, i, j, k = torch.unbind(quaternions, dim=-1)
    two_s = 2.0 / torch.sum(quaternions * quaternions, dim=-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle -> [..., 3, 3] rotation matrix."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))
