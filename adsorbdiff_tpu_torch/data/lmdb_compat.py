"""OC20 LMDB interop.

Port of :mod:`adsorbdiff_tpu.data.lmdb_compat`: reads the reference's
pickled-PyG LMDB datasets (single-file environments, keys ``b"0"`` ..
``b"<n-1>"`` plus a pickled ``b"length"``), converts them to
:class:`System` objects and ``*.adshard.npz`` shards, and writes systems
back in that format.  Two read backends:

- the ``lmdb`` package when importable (liblmdb itself);
- otherwise :func:`adsorbdiff_tpu_torch.data.lmdb_native.open_best_reader`:
  the C++ reader where it builds, else the Python B+tree walker of
  :mod:`adsorbdiff_tpu_torch.data.lmdbio`.

Unpickling does not need torch_geometric: :class:`_PyGShim` absorbs any
``torch_geometric.*`` class in the stream (old-style ``Data.__dict__``
pickles and PyG >= 2 ``_store``-based ones), and torch tensors unpickle with
the installed torch.
"""
from __future__ import annotations

import contextlib
import io
import os
import pickle
import sys
import types
from typing import Iterator, List, Tuple

import numpy as np
import torch

from adsorbdiff_tpu_torch.data.schema import System


class _PyGShim:
    """Stand-in for torch_geometric classes inside OC20 pickles: keeps the
    pickled attributes, resolves PyG >= 2 ``_store._mapping`` indirection."""

    def __init__(self, *args, **kwargs) -> None:
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, tuple) and len(state) == 2 and isinstance(state[1], dict):
            state = {**(state[0] or {}), **state[1]}
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:  # pragma: no cover - exotic reduce protocols
            self.__dict__["_state"] = state

    def __getattr__(self, name):
        # PyG >= 2 Data: attributes live in _store (itself a shim) -> _mapping
        d = self.__dict__
        holder = d.get("_store")
        if holder is not None:
            mapping = getattr(holder, "_mapping", None) or holder.__dict__.get("_mapping")
            if isinstance(mapping, dict) and name in mapping:
                return mapping[name]
            if name in getattr(holder, "__dict__", {}):
                return holder.__dict__[name]
        mapping = d.get("_mapping")
        if isinstance(mapping, dict) and name in mapping:
            return mapping[name]
        raise AttributeError(name)


class _ShimUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("torch_geometric", "torch_sparse", "torch_scatter"):
            return _PyGShim
        return super().find_class(module, name)


def loads_pyg(raw: bytes):
    """Unpickle an OC20 record without torch_geometric installed.

    This runs ``pickle`` on whatever the file holds: only torch_geometric's
    classes are replaced, every other class the stream names is imported
    and called as pickle does, so read only files you trust."""
    return _ShimUnpickler(io.BytesIO(raw)).load()


def _data_to_system(data) -> System:
    """Pickled PyG ``Data`` -> System: float ``atomic_numbers`` to int32,
    ``cell [1, 3, 3]`` to ``[3, 3]``, float ``fixed`` to bool, int64 ``tags``
    to int32, ``force`` to ``forces``; no ``y`` gives ``energy=None`` (a
    ``y`` of 0.0 stays 0.0)."""

    def get(name, default=None):
        v = getattr(data, name, default)
        if v is None:
            return None
        return v.numpy() if hasattr(v, "numpy") else np.asarray(v)

    def scalar(name, default=0.0):
        v = getattr(data, name, None)
        if v is None:
            return float(default)
        return float(np.asarray(v).reshape(-1)[0])

    pos = get("pos")
    return System(
        pos=pos,
        atomic_numbers=get("atomic_numbers").astype(np.int32),
        tags=get("tags", np.zeros(len(pos))).astype(np.int32),
        fixed=get("fixed", np.zeros(len(pos))).astype(bool),
        cell=get("cell").reshape(3, 3),
        sid=int(np.asarray(getattr(data, "sid", 0)).reshape(-1)[0]),
        fid=int(np.asarray(getattr(data, "fid", 0)).reshape(-1)[0]),
        energy=None if getattr(data, "y", None) is None else scalar("y"),
        y_relaxed=scalar("y_relaxed"),
        pos_relaxed=get("pos_relaxed"),
        forces=get("force"),
    )


def iter_lmdb_systems(src: str) -> Iterator[System]:
    """Systems of a single .lmdb file or a directory of them, each file's
    records in numeric key order (metadata keys such as ``b"length"`` are
    dropped).

    Streams one value at a time: only the key list is buffered and sorted;
    each record's bytes are looked up as it is yielded, so a multi-GB file
    needs no file-sized memory."""
    paths = (
        sorted(os.path.join(src, f) for f in os.listdir(src) if f.endswith(".lmdb"))
        if os.path.isdir(src)
        else [src]
    )
    for path in paths:
        try:
            import lmdb
        except ImportError:
            from adsorbdiff_tpu_torch.data.lmdb_native import open_best_reader

            with open_best_reader(path) as reader:
                for key in _sorted_record_keys(reader.keys()):
                    yield _data_to_system(loads_pyg(reader.get(key)))
            continue
        env = lmdb.open(path, subdir=False, readonly=True, lock=False, readahead=False, meminit=False)
        try:
            with env.begin() as txn:
                keys = _sorted_record_keys(bytes(k) for k in txn.cursor().iternext(keys=True, values=False))
                for key in keys:
                    yield _data_to_system(loads_pyg(bytes(txn.get(key))))
        finally:
            env.close()


def _sorted_record_keys(keys) -> List[bytes]:
    """Record keys (ascii ints) in numeric order; metadata keys dropped."""
    out: List[Tuple[int, bytes]] = []
    for key in keys:
        try:
            out.append((int(key.decode("ascii")), key))
        except (UnicodeDecodeError, ValueError):
            continue  # metadata keys: length, metadata, ...
    return [k for _, k in sorted(out)]


_FAKE_PYG = ("torch_geometric", "torch_geometric.data", "torch_geometric.data.data")


@contextlib.contextmanager
def _fake_pyg_modules():
    """Register a minimal ``torch_geometric.data.data.Data`` for the body of
    the ``with``, so the pickles written there name the real PyG import path
    and the reference stack (which has PyG) unpickles them directly.  The
    ``sys.modules`` entries it adds are taken back out on every exit,
    errors included.  Yields the real class where torch_geometric is
    installed."""
    try:
        import torch_geometric  # noqa: F401
    except ImportError:
        pass
    else:
        yield __import__("torch_geometric.data.data", fromlist=["Data"]).Data
        return

    class Data:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    Data.__module__ = "torch_geometric.data.data"
    Data.__qualname__ = "Data"
    pkg, dpkg, dmod = (types.ModuleType(name) for name in _FAKE_PYG)
    dmod.Data = Data
    dpkg.data = dmod
    dpkg.Data = Data
    pkg.data = dpkg
    try:
        sys.modules.update(zip(_FAKE_PYG, (pkg, dpkg, dmod)))
        yield Data
    finally:
        for name in _FAKE_PYG:
            sys.modules.pop(name, None)


def export_systems_to_lmdb(systems, path: str) -> int:
    """Write systems as a reference-format LMDB: keys ``b"0"`` ..
    ``b"<n-1>"`` of pickled torch_geometric ``Data`` records of torch
    tensors, plus a pickled ``b"length"``.  Uses the dependency-free writer
    of :mod:`adsorbdiff_tpu_torch.data.lmdbio`.  Returns the record count."""
    from adsorbdiff_tpu_torch.data.lmdbio import write_lmdb

    items = []
    with _fake_pyg_modules() as Data:
        for i, s in enumerate(systems):
            rec = dict(
                pos=torch.from_numpy(np.asarray(s.pos, np.float32)),
                atomic_numbers=torch.from_numpy(np.asarray(s.atomic_numbers, np.float32)),
                cell=torch.from_numpy(np.asarray(s.cell, np.float32))[None],
                tags=torch.from_numpy(np.asarray(s.tags, np.int64)),
                fixed=torch.from_numpy(np.asarray(s.fixed, np.float32)),
                sid=int(s.sid),
                fid=int(s.fid),
                natoms=int(len(s.pos)),
                y_relaxed=float(s.y_relaxed),
            )
            if s.pos_relaxed is not None:
                rec["pos_relaxed"] = torch.from_numpy(np.asarray(s.pos_relaxed, np.float32))
            if s.forces is not None:
                rec["force"] = torch.from_numpy(np.asarray(s.forces, np.float32))
            if s.energy is not None:  # a legitimate y of exactly 0.0 must export
                rec["y"] = float(s.energy)
            items.append((str(i).encode("ascii"), pickle.dumps(Data(**rec), protocol=2)))
        count = len(items)
        items.append((b"length", pickle.dumps(count, protocol=2)))
    write_lmdb(path, items)
    return count


def convert_lmdb_to_shards(src: str, out_path: str, shard_size: int = 5000) -> int:
    """LMDB -> ``<out_path>_00000.adshard.npz``, ``_00001`` .. of at most
    ``shard_size`` systems each.  Returns the system count."""
    from adsorbdiff_tpu_torch.data.store import write_shard

    buf, shard_i, total = [], 0, 0
    for system in iter_lmdb_systems(src):
        buf.append(system)
        total += 1
        if len(buf) >= shard_size:
            write_shard(f"{out_path}_{shard_i:05d}", buf)
            buf, shard_i = [], shard_i + 1
    if buf:
        write_shard(f"{out_path}_{shard_i:05d}", buf)
    return total
