"""Static element data tables (port of :mod:`adsorbdiff_tpu.models.embeddings`).

``ATOMIC_RADII`` is the radii table the denoising models offset edge
distances with, as a dict ``Z -> pm``.  The CGCNN k-hot, QMOF k-hot and
continuous element-property tables are read lazily from the port's own copy
of the 5.5 kB asset, ``adsorbdiff_tpu_torch/assets/element_embeddings.npz``,
with the reference's ``dict[int, list]`` API; no AdsorbDiff model uses them.
"""
from __future__ import annotations

import functools
import os

import numpy as np

from adsorbdiff_tpu_torch.models.equiformer_v2 import ATOMIC_RADII_PM as _RADII_PM

ATOMIC_RADII: dict = {z: float(r) for z, r in enumerate(_RADII_PM) if z > 0}

_ASSET = os.path.join(os.path.dirname(__file__), "..", "assets", "element_embeddings.npz")


@functools.lru_cache(maxsize=None)
def _tables() -> dict:
    with np.load(_ASSET) as f:
        return {k: f[k] for k in f.files}


def _as_dict(name: str) -> dict:
    t = _tables()
    mat, zs = t[name], t[f"{name}_z"]
    return {int(z): mat[int(z)].tolist() for z in zs}


def khot_embeddings() -> dict:
    """CGCNN k-hot vectors, dict[Z] -> 92 floats."""
    return _as_dict("khot")


def qmof_khot_embeddings() -> dict:
    """QMOF k-hot vectors, dict[Z] -> 72 floats."""
    return _as_dict("qmof_khot")


def continuous_embeddings() -> dict:
    """Continuous element properties (group, period, electronegativity,
    covalent radius, valence electrons, first ionisation energy, electron
    affinity, block, atomic volume), NaN where unavailable: dict[Z] -> 9
    floats."""
    return _as_dict("continuous")


def __getattr__(name: str):
    lazy = {
        "KHOT_EMBEDDINGS": khot_embeddings,
        "QMOF_KHOT_EMBEDDINGS": qmof_khot_embeddings,
        "CONTINUOUS_EMBEDDINGS": continuous_embeddings,
    }
    if name in lazy:
        return lazy[name]()
    raise AttributeError(name)


__all__ = [
    "ATOMIC_RADII",
    "KHOT_EMBEDDINGS",
    "QMOF_KHOT_EMBEDDINGS",
    "CONTINUOUS_EMBEDDINGS",
]
