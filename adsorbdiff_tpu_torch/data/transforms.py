"""Per-item data transforms.

Port of :mod:`adsorbdiff_tpu.data.transforms`.  A transform config is
``{name: config}``; names resolve through :data:`TRANSFORM_FNS`, an explicit
registry (the reference dispatched them with ``eval``).  A
:class:`DataTransforms` is a callable, so it can stand in the ``transforms``
list of a :class:`~adsorbdiff_tpu_torch.data.store.ShardDataset` config.

:func:`decompose_tensor` sets new attributes on the item it is given, so it
needs an object that takes them: a :class:`System` has ``__slots__`` and
raises ``AttributeError``, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from adsorbdiff_tpu_torch.common.irreps import cg_change_mat, irreps_sum

TRANSFORM_FNS: Dict[str, Callable] = {}


def register_transform(name: str):
    def wrap(fn):
        TRANSFORM_FNS[name] = fn
        return fn

    return wrap


class DataTransforms:
    """Config: ``{name: config}``, applied in order; ``normalizer`` is
    skipped (the trainer normalizes targets)."""

    def __init__(self, config: dict) -> None:
        self.config = config or {}

    def __call__(self, system):
        for name, cfg in self.config.items():
            if name == "normalizer":
                continue
            system = TRANSFORM_FNS[name](system, cfg)
        return system


@register_transform("decompose_tensor")
def decompose_tensor(system, config: dict):
    """Rank-2 tensor target ``config["tensor"]`` -> its irreps components,
    one attribute for each key of ``config["decomposition"]`` (float64)."""
    tensor_key = config["tensor"]
    rank = config["rank"]
    if rank != 2:
        raise NotImplementedError
    value = np.asarray(getattr(system, tensor_key)).reshape(9)
    decomposition = value @ cg_change_mat(rank)
    for irrep_key, irrep_cfg in config["decomposition"].items():
        lo = irreps_sum(irrep_cfg["irrep_dim"] - 1) if irrep_cfg["irrep_dim"] > 0 else 0
        hi = irreps_sum(irrep_cfg["irrep_dim"])
        setattr(system, irrep_key, decomposition[lo:hi])
    return system
