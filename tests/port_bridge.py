"""Test-only bridge between the JAX package and its PyTorch port.

Batches and arrays cross as numpy; nothing here is imported by either
package.
"""
import dataclasses

import numpy as np
import torch

from adsorbdiff_tpu_torch.data.schema import AtomsBatch as TorchAtomsBatch

BATCH_FIELDS = [f.name for f in dataclasses.fields(TorchAtomsBatch)]


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
