"""PyTorch port: batch schema, masked reductions and device resolution
against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adsorbdiff_tpu.data.schema import System as JaxSystem
from adsorbdiff_tpu.data.schema import collate as jax_collate
from adsorbdiff_tpu.ops.segment import masked_max as jax_masked_max
from adsorbdiff_tpu.ops.segment import masked_mean as jax_masked_mean
from adsorbdiff_tpu_torch.data.schema import System, collate, uncollate
from adsorbdiff_tpu_torch.ops.segment import masked_max, masked_mean
from tests.port_bridge import BATCH_FIELDS, to_numpy
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)


def _systems(rng, cls, n_systems=3, with_forces=True):
    out = []
    for i in range(n_systems):
        n = 5 + 2 * i
        tags = rng.integers(0, 3, n)
        out.append(cls(
            pos=rng.normal(0, 3, (n, 3)), atomic_numbers=rng.integers(1, 80, n),
            cell=np.diag([7.0, 8.0, 20.0]) + rng.normal(0, 0.1, (3, 3)), tags=tags, fixed=tags == 0,
            sid=10 + i, fid=i, energy=None if i == 1 else 0.25 * i, y_relaxed=-1.5 * i,
            forces=rng.normal(0, 1, (n, 3)) if with_forces else None,
        ))
    return out


def test_collate_matches_jax_field_for_field():
    systems = _systems(np.random.default_rng(0), System)
    jax_systems = _systems(np.random.default_rng(0), JaxSystem)
    batch = collate(systems, max_atoms=12, with_forces=True, device="cpu")
    want = jax_collate(jax_systems, max_atoms=12, with_forces=True)
    for name in BATCH_FIELDS:
        got, exp = to_numpy(getattr(batch, name)), np.asarray(getattr(want, name))
        assert got.dtype == exp.dtype, name
        np.testing.assert_array_equal(got, exp, err_msg=name)
    np.testing.assert_array_equal(to_numpy(batch.ads_mask), np.asarray(want.ads_mask))
    np.testing.assert_array_equal(to_numpy(batch.free_mask), np.asarray(want.free_mask))
    assert (batch.batch_size, batch.max_atoms) == (3, 12)


def test_collate_uncollate_round_trip():
    systems = _systems(np.random.default_rng(1), System)
    back = uncollate(collate(systems, with_forces=True, device="cpu"))
    assert len(back) == len(systems)
    for a, b in zip(systems, back):
        for name in ("pos", "atomic_numbers", "tags", "fixed", "cell", "pos_relaxed", "forces"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert (a.sid, a.fid, a.y_relaxed) == (b.sid, b.fid, b.y_relaxed)
        assert b.energy == (0.0 if a.energy is None else a.energy)


def test_collate_rejects_oversized_system():
    with pytest.raises(ValueError, match="exceeds max_atoms"):
        collate(_systems(np.random.default_rng(2), System), max_atoms=4, device="cpu")


def test_batch_replace_and_to():
    batch = collate(_systems(np.random.default_rng(3), System, with_forces=False), device="cpu")
    moved = batch.replace(pos=batch.pos + 1.0)
    assert torch.equal(moved.pos, batch.pos + 1.0) and moved.tags is batch.tags
    same = batch.to("cpu")
    assert same.forces is None and torch.equal(same.cell, batch.cell)


@pytest.mark.parametrize("dim", [0, 1])
def test_masked_reductions_match_jax(dim):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (4, 6, 3)).astype(np.float32)
    mask = rng.random((4, 6)) > 0.4
    mask[0] = False  # an all-masked row: mean is 0, max is the initial value
    np.testing.assert_allclose(
        masked_mean(torch.from_numpy(x), torch.from_numpy(mask), dim=dim).numpy(),
        np.asarray(jax_masked_mean(jnp.asarray(x), jnp.asarray(mask), axis=dim)), atol=1e-6,
    )
    np.testing.assert_array_equal(
        masked_max(torch.from_numpy(x), torch.from_numpy(mask), dim=dim, initial=-5.0).numpy(),
        np.asarray(jax_masked_max(jnp.asarray(x), jnp.asarray(mask), axis=dim, initial=-5.0)),
    )


def test_entry_points_need_a_card_unless_told_cpu():
    """device=None means the CUDA card; without one the entry points raise
    instead of running on the host."""
    from adsorbdiff_tpu_torch.models.painn import PaiNN
    from adsorbdiff_tpu_torch.relaxation.ml_relaxation import DiffusionEngine

    systems = _systems(np.random.default_rng(5), System, with_forces=False)
    if torch.cuda.is_available():
        assert collate(systems).pos.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collate(systems)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PaiNN(hidden_channels=8, num_layers=1, num_rbf=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionEngine(lambda b: None, dict(num_steps=1, ads_std_low=0.1, ads_std_high=1.0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        collate(systems, device="cuda")
