"""Native (C++) shard reader + batch collator bindings.

Port of :mod:`adsorbdiff_tpu.data.native`.  A ``.adbin`` shard is a raw
columnar file (the layout is in ``runtime/native/adshard.cc``; the bytes are
the JAX package's for the same systems) that ``adshard.cc`` mmaps; batch
assembly (gather ragged systems -> padded ``[B, N, ...]`` buffers) runs in
C++ with a thread pool, bound via ctypes, and fills torch CPU tensors in
place.  :class:`~adsorbdiff_tpu_torch.data.buckets.BucketedBatcher` takes
that path for any dataset with ``collate_indices``.  The library is built on
first use by :mod:`adsorbdiff_tpu_torch.ops.host_build`; with
``ADSORBDIFF_TPU_NO_NATIVE`` set, or where it does not build, the dataset
raises.
"""
from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np
import torch

from adsorbdiff_tpu_torch.common.registry import registry
from adsorbdiff_tpu_torch.data.schema import AtomsBatch, System, uncollate
from adsorbdiff_tpu_torch.ops import host_build

MAGIC = b"ADSB"
SUFFIX = ".adbin"
_LIB = None


def _load_lib() -> ctypes.CDLL:
    """The bound collator; raises ``RuntimeError`` where it is switched off
    or does not build."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if os.environ.get("ADSORBDIFF_TPU_NO_NATIVE"):
        raise RuntimeError("native adshard library unavailable (ADSORBDIFF_TPU_NO_NATIVE is set)")
    try:
        lib = host_build.load("adshard")
    except (RuntimeError, OSError) as e:
        raise RuntimeError(f"native adshard library unavailable: {e}") from e
    lib.adb_open.restype = ctypes.c_void_p
    lib.adb_open.argtypes = [ctypes.c_char_p]
    lib.adb_close.argtypes = [ctypes.c_void_p]
    lib.adb_num_systems.restype = ctypes.c_int64
    lib.adb_num_systems.argtypes = [ctypes.c_void_p]
    lib.adb_natoms.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.adb_has_forces.restype = ctypes.c_int
    lib.adb_has_forces.argtypes = [ctypes.c_void_p]
    lib.adb_fill_batch.restype = ctypes.c_int
    lib.adb_fill_batch.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int64] * 2
                                   + [ctypes.c_void_p] * 13 + [ctypes.c_int])
    _LIB = lib
    return lib


def write_shard_bin(path: str, systems: Sequence[System]) -> str:
    """Write the raw ``.adbin`` format (host-side numpy, atomic rename);
    returns the path written, ``.adbin`` appended where missing."""
    if not path.endswith(SUFFIX):
        path = path + SUFFIX
    n = len(systems)
    natoms = np.asarray([s.natoms for s in systems], np.int32)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(natoms, out=offsets[1:])
    has_forces = bool(systems) and all(s.forces is not None for s in systems)

    def cat(fn, dtype, shape_tail=()):
        if not systems:
            return np.zeros((0,) + shape_tail, dtype)
        return np.ascontiguousarray(np.concatenate(
            [np.asarray(fn(s), dtype).reshape((-1,) + shape_tail) for s in systems]))

    cells = np.stack([s.cell for s in systems]) if systems else np.zeros((0, 3, 3), np.float32)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        np.uint32(1).tofile(f)
        np.uint64(n).tofile(f)
        np.uint64(int(offsets[-1])).tofile(f)
        offsets.tofile(f)
        natoms.tofile(f)
        np.ascontiguousarray(cells).astype(np.float32).tofile(f)
        np.asarray([s.sid for s in systems], np.int64).tofile(f)
        np.asarray([s.fid for s in systems], np.int64).tofile(f)
        np.asarray([0.0 if s.energy is None else s.energy for s in systems], np.float32).tofile(f)
        np.asarray([s.y_relaxed for s in systems], np.float32).tofile(f)
        np.uint8(1 if has_forces else 0).tofile(f)
        cat(lambda s: s.pos, np.float32, (3,)).tofile(f)
        cat(lambda s: s.atomic_numbers, np.int32).tofile(f)
        cat(lambda s: s.tags, np.int32).tofile(f)
        cat(lambda s: s.fixed, np.uint8).tofile(f)
        cat(lambda s: s.pos_relaxed, np.float32, (3,)).tofile(f)
        if has_forces:
            cat(lambda s: s.forces, np.float32, (3,)).tofile(f)
    os.replace(tmp, path)
    return path


@registry.register_dataset("adbin")
class NativeShardDataset:
    """mmap'd ``.adbin`` shard with C++ padded-batch collation.
    Config: ``{"src": path}``."""

    def __init__(self, config: dict) -> None:
        self.config = dict(config)
        src = str(config["src"])
        if not os.path.exists(src) and os.path.exists(src + SUFFIX):
            src = src + SUFFIX
        self._lib = _load_lib()
        self._h = self._lib.adb_open(src.encode())
        if not self._h:
            raise OSError(f"failed to open adbin shard '{src}'")
        self._n = int(self._lib.adb_num_systems(self._h))
        self._natoms = np.zeros(self._n, np.int32)
        self._lib.adb_natoms(self._h, self._natoms.ctypes.data_as(ctypes.c_void_p))
        self.has_forces = bool(self._lib.adb_has_forces(self._h))

    def __len__(self) -> int:
        return self._n

    def natoms_array(self) -> np.ndarray:
        return self._natoms

    def close_db(self) -> None:
        if self._h:
            self._lib.adb_close(self._h)
            self._h = None

    def collate_indices(self, indices: Sequence[int], max_atoms: int, with_forces: bool = False,
                        n_threads: int = 4) -> AtomsBatch:
        """A padded batch straight from the mmap: the C++ collator fills
        zeroed torch CPU tensors in place, with the dtypes of
        ``collate(..., device="cpu")``.  ``forces`` only where asked for and
        the shard has them; up to ``n_threads`` threads, none for a batch of
        under ~1 MB.  Raises ``ValueError`` on an index out of range or a
        system over ``max_atoms``."""
        b = len(indices)
        idx = np.asarray(indices, np.int64)

        def zeros(shape, dtype):
            return torch.zeros((b,) + shape, dtype=dtype)

        out = dict(
            pos=zeros((max_atoms, 3), torch.float32),
            atomic_numbers=zeros((max_atoms,), torch.int32),
            tags=zeros((max_atoms,), torch.int32),
            fixed=zeros((max_atoms,), torch.bool),  # one byte a value, written 0/1
            cell=zeros((3, 3), torch.float32),
            natoms=zeros((), torch.int32),
            atom_mask=zeros((max_atoms,), torch.bool),
            sid=zeros((), torch.int32),
            fid=zeros((), torch.int32),
            energy=zeros((), torch.float32),
            y_relaxed=zeros((), torch.float32),
            pos_relaxed=zeros((max_atoms, 3), torch.float32),
        )
        forces = zeros((max_atoms, 3), torch.float32) if (with_forces and self.has_forces) else None
        ret = self._lib.adb_fill_batch(
            self._h, idx.ctypes.data_as(ctypes.c_void_p), b, max_atoms,
            *(out[k].data_ptr() for k in ("pos", "atomic_numbers", "tags", "fixed", "cell", "natoms", "atom_mask",
                                          "sid", "fid", "energy", "y_relaxed", "pos_relaxed")),
            None if forces is None else forces.data_ptr(), n_threads,
        )
        if ret != 0:
            raise ValueError("adb_fill_batch failed (index out of range or natoms > max_atoms)")
        return AtomsBatch(forces=forces, **out)

    def __getitem__(self, i: int) -> System:
        """One system (through the collator, for API parity with
        :class:`~adsorbdiff_tpu_torch.data.store.ShardDataset`)."""
        i = int(i)
        batch = self.collate_indices([i], max_atoms=int(self._natoms[i]), with_forces=True, n_threads=1)
        return uncollate(batch)[0]
