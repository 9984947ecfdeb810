"""Columnar shard storage for atomic systems.

The port's own copy of :mod:`adsorbdiff_tpu.data.store` (which imports JAX
through its schema): the same ``*.adshard.npz`` format, so shards written by
either package read back the same in both.  Each shard holds the
concatenated ragged arrays of S systems plus offsets; a shard loads with two
``np.load`` calls and slicing is zero-copy numpy.
"""
from __future__ import annotations

import glob
import os
import tempfile
from bisect import bisect_right
from typing import Optional, Sequence

import numpy as np

from adsorbdiff_tpu_torch.common.registry import registry
from adsorbdiff_tpu_torch.data.schema import System

_FIELDS_ATOM = ("pos", "atomic_numbers", "tags", "fixed", "pos_relaxed", "forces")
_FIELDS_SYS = ("cell", "sid", "fid", "energy", "y_relaxed")
SUFFIX = ".adshard.npz"


def write_shard(path: str, systems: Sequence[System]) -> None:
    """Write systems to one columnar shard (atomic rename on completion)."""
    if not path.endswith(SUFFIX):
        path = path + SUFFIX
    natoms = np.asarray([s.natoms for s in systems], np.int32)
    offsets = np.zeros(len(systems) + 1, np.int64)
    np.cumsum(natoms, out=offsets[1:])
    cols = {
        "natoms": natoms,
        "offsets": offsets,
        "pos": np.concatenate([s.pos for s in systems]) if systems else np.zeros((0, 3), np.float32),
        "atomic_numbers": np.concatenate([s.atomic_numbers for s in systems]) if systems else np.zeros(0, np.int32),
        "tags": np.concatenate([s.tags for s in systems]) if systems else np.zeros(0, np.int32),
        "fixed": np.concatenate([s.fixed for s in systems]) if systems else np.zeros(0, bool),
        "pos_relaxed": np.concatenate([s.pos_relaxed for s in systems]) if systems else np.zeros((0, 3), np.float32),
        "cell": np.stack([s.cell for s in systems]) if systems else np.zeros((0, 3, 3), np.float32),
        "sid": np.asarray([s.sid for s in systems], np.int64),
        "fid": np.asarray([s.fid for s in systems], np.int64),
        "energy": np.asarray([0.0 if s.energy is None else s.energy for s in systems], np.float32),
        "y_relaxed": np.asarray([s.y_relaxed for s in systems], np.float32),
    }
    if systems and all(s.forces is not None for s in systems):
        cols["forces"] = np.concatenate([s.forces for s in systems])
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=os.path.dirname(os.path.abspath(path)))
    os.close(fd)
    np.savez_compressed(tmp, **cols)
    os.replace(tmp, path)


class _Shard:
    def __init__(self, path: str) -> None:
        self._z = np.load(path, allow_pickle=False)
        self.natoms = self._z["natoms"]
        self.offsets = self._z["offsets"]
        self._cols: Optional[dict] = None

    def __len__(self) -> int:
        return len(self.natoms)

    def _materialize(self) -> dict:
        # NpzFile.__getitem__ decompresses the whole column on every access:
        # decompress each column once per process; get() is then a zero-copy
        # numpy slice.  Memory = the decompressed shard (~2 MB per 512
        # published-size systems), kept for the dataset's life.
        if self._cols is None:
            self._cols = {k: self._z[k] for k in self._z.files}
        return self._cols

    def get(self, i: int) -> System:
        a, b = int(self.offsets[i]), int(self.offsets[i + 1])
        z = self._materialize()
        return System(
            pos=z["pos"][a:b],
            atomic_numbers=z["atomic_numbers"][a:b],
            tags=z["tags"][a:b],
            fixed=z["fixed"][a:b],
            pos_relaxed=z["pos_relaxed"][a:b],
            forces=z["forces"][a:b] if "forces" in z else None,
            cell=z["cell"][i],
            sid=int(z["sid"][i]),
            fid=int(z["fid"][i]),
            energy=float(z["energy"][i]),
            y_relaxed=float(z["y_relaxed"][i]),
        )


@registry.register_dataset("shards")
@registry.register_dataset("lmdb")  # config compatibility: `task.dataset: lmdb` resolves here
class ShardDataset:
    """Dataset over a single shard file or a directory of shards.

    A single file or a directory of shards, with the reference LmdbDataset's
    ``shard/total_shards`` contiguous subsetting.  Config:
    ``{"src": path, "shard": i, "total_shards": n, "transforms": [f, ...]}``;
    each transform is a callable applied in order to every system read
    (e.g. a :class:`~adsorbdiff_tpu_torch.data.transforms.DataTransforms`).
    A reference LMDB converts to shards with
    :func:`adsorbdiff_tpu_torch.data.lmdb_compat.convert_lmdb_to_shards`.
    """

    def __init__(self, config: dict) -> None:
        self.config = dict(config)
        src = str(config["src"])
        if os.path.isdir(src):
            paths = sorted(glob.glob(os.path.join(src, f"*{SUFFIX}")))
            if not paths:
                raise FileNotFoundError(f"No *{SUFFIX} shards found in '{src}'")
        else:
            if not os.path.exists(src) and os.path.exists(src + SUFFIX):
                src = src + SUFFIX
            paths = [src]
        self._shards = [_Shard(p) for p in paths]
        lens = [len(s) for s in self._shards]
        self._cum = np.cumsum(lens)
        self._len = int(self._cum[-1]) if len(lens) else 0

        self.indices = np.arange(self._len)
        if "shard" in config and "total_shards" in config:
            # mimic reference manual sharding: contiguous split, drop remainder
            per = self._len // int(config["total_shards"])
            lo = per * int(config["shard"])
            self.indices = self.indices[lo : lo + per]

        self.transforms = list(config.get("transforms", []) or [])

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int) -> System:
        gi = int(self.indices[idx])
        shard_i = int(bisect_right(self._cum, gi))
        local = gi - (int(self._cum[shard_i - 1]) if shard_i else 0)
        system = self._shards[shard_i].get(local)
        for t in self.transforms:
            system = t(system)
        return system

    def natoms_array(self) -> np.ndarray:
        """[len] atom counts without materializing systems (for bucketing)."""
        all_natoms = np.concatenate([s.natoms for s in self._shards]) if self._shards else np.zeros(0, np.int32)
        return all_natoms[self.indices]


