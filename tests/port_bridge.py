"""Test-only bridge between the JAX package and its PyTorch port.

Batches and arrays cross as numpy; nothing here is imported by either
package.
"""
import dataclasses

import numpy as np
import pytest
import torch

from adsorbdiff_tpu_torch.data.schema import AtomsBatch as TorchAtomsBatch
from adsorbdiff_tpu_torch.diffusion.schedules import ScheduleDraws

BATCH_FIELDS = [f.name for f in dataclasses.fields(TorchAtomsBatch)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for each test of a module that imports this
    fixture.  The port's tests run tiny shapes, and test processes share the
    host's cores: with torch's default of one thread per core each, they
    wait on each other, and a test of a few seconds takes a minute."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_torch_batch(jax_batch, device="cpu") -> TorchAtomsBatch:
    """JAX ``AtomsBatch`` -> the port's ``AtomsBatch`` on ``device``."""
    fields = {}
    for name in BATCH_FIELDS:
        v = getattr(jax_batch, name)
        fields[name] = None if v is None else torch.from_numpy(np.array(v)).to(device)
    return TorchAtomsBatch(**fields)


def to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def keyed_edges(nl):
    """{(row, src, cell offset): (dist, vec)} over the valid slots of a
    neighbour table, so tables that differ only in the order of tied slots
    compare equal."""
    src, off, mask = to_numpy(nl.src), to_numpy(nl.cell_offsets), to_numpy(nl.mask)
    dist, vec = to_numpy(nl.dist), to_numpy(nl.vec)
    k = src.shape[-1]
    src, off, mask = src.reshape(-1, k), off.reshape(-1, k, 3), mask.reshape(-1, k)
    dist, vec = dist.reshape(-1, k), vec.reshape(-1, k, 3)
    return {
        (int(row), int(src[row, slot]), tuple(int(x) for x in off[row, slot])): (dist[row, slot], vec[row, slot])
        for row, slot in zip(*np.nonzero(mask))
    }


def assert_same_neighbors(nl_torch, nl_jax, atol=1e-5):
    """Equal masks, equal per-row (src, offset) sets where the mask is true,
    and dist/vec of each such edge within ``atol``."""
    np.testing.assert_array_equal(to_numpy(nl_torch.mask), to_numpy(nl_jax.mask))
    got, want = keyed_edges(nl_torch), keyed_edges(nl_jax)
    assert got.keys() == want.keys()
    for key, (dist, vec) in want.items():
        np.testing.assert_allclose(got[key][0], dist, atol=atol, err_msg=str(key))
        np.testing.assert_allclose(got[key][1], vec, atol=atol, err_msg=str(key))


def jax_schedule_draws(key, batch_size: int, so3: bool = True, device="cpu") -> ScheduleDraws:
    """The draws a JAX schedule makes from ``key``, with its splits:
    ``tr_so3_schedule`` (``k_t, k_tr, k_rot``; ``igso3.sample_vec`` splits
    ``k_rot`` into the axis and the angle) or ``ads_com_gaussian_schedule``
    (``k_t, k_tr``)."""
    import jax

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    if not so3:
        k_t, k_tr = jax.random.split(key)
        return ScheduleDraws(t(jax.random.uniform(k_t, (batch_size,))), t(jax.random.normal(k_tr, (batch_size, 3))))
    k_t, k_tr, k_rot = jax.random.split(key, 3)
    k_dir, k_om = jax.random.split(k_rot)
    return ScheduleDraws(
        t(jax.random.uniform(k_t, (batch_size,))),
        t(jax.random.normal(k_tr, (batch_size, 3))),
        t(jax.random.normal(k_dir, (batch_size, 3))),
        t(jax.random.uniform(k_om, (batch_size,))),
    )
