"""PyTorch port: axis-angle rotations against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adsorbdiff_tpu.ops.rotation import axis_angle_to_matrix as jax_axis_angle_to_matrix
from adsorbdiff_tpu.ops.rotation import axis_angle_to_quaternion as jax_axis_angle_to_quaternion
from adsorbdiff_tpu_torch.ops.rotation import axis_angle_to_matrix, axis_angle_to_quaternion


def _axis_angles(scale):
    rng = np.random.default_rng(0)
    v = rng.normal(0, 1, (64, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * rng.uniform(0.0, scale, (64, 1))).astype(np.float32)


@pytest.mark.parametrize("scale", [3.0, 1e-3, 5e-7, 0.0], ids=["large", "small", "below-1e-6", "zero"])
def test_axis_angle_to_matrix_matches_jax(scale):
    """Includes angles below 1e-6, where both take the series branch."""
    aa = _axis_angles(scale)
    got = axis_angle_to_matrix(torch.from_numpy(aa)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_axis_angle_to_matrix(jnp.asarray(aa))), atol=1e-6)
    np.testing.assert_allclose(
        axis_angle_to_quaternion(torch.from_numpy(aa)).numpy(),
        np.asarray(jax_axis_angle_to_quaternion(jnp.asarray(aa))), atol=1e-6,
    )
    # proper rotations
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2), np.broadcast_to(np.eye(3), got.shape), atol=2e-6)


def test_axis_angle_batched_leading_axes():
    aa = _axis_angles(2.0).reshape(4, 16, 3)
    flat = axis_angle_to_matrix(torch.from_numpy(aa.reshape(-1, 3))).reshape(4, 16, 3, 3)
    torch.testing.assert_close(axis_angle_to_matrix(torch.from_numpy(aa)), flat)
