"""ctypes binding for the native LMDB reader (``runtime/native/lmdbread.cc``).

Port of :mod:`adsorbdiff_tpu.data.lmdb_native`.  The same read surface as
:class:`adsorbdiff_tpu_torch.data.lmdbio.LmdbReader` (``items`` / ``keys`` /
``get`` / ``entries``), but the B+tree walk, record index and byte copies
run in C++ over the mmap; the Python walker spends its time in
``struct.unpack`` per node, which matters at OC20 scale (~10^6 records per
file).  Values stream in bounded chunks, so multi-GB files never
materialize at once.  The library is built on first use by
:mod:`adsorbdiff_tpu_torch.ops.host_build`; :func:`open_best_reader` falls
back to the Python reader where it does not build, or where
``ADSORBDIFF_TPU_NO_NATIVE`` is set.
"""
from __future__ import annotations

import ctypes
import logging
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from adsorbdiff_tpu_torch.ops import host_build

_LIB: Optional[ctypes.CDLL] = None
_LIB_ERROR: Optional[str] = None  # a failed build, kept for the process as JAX keeps it


def _load_lib() -> ctypes.CDLL:
    """The bound library; raises ``OSError`` where it is switched off or
    does not build (once a process: a failed build is not retried)."""
    global _LIB, _LIB_ERROR
    if _LIB is not None:
        return _LIB
    if os.environ.get("ADSORBDIFF_TPU_NO_NATIVE"):
        raise OSError("native lmdbread switched off (ADSORBDIFF_TPU_NO_NATIVE)")
    if _LIB_ERROR is not None:
        raise OSError(_LIB_ERROR)
    try:
        lib = host_build.load("lmdbread")
    except (RuntimeError, OSError) as e:
        _LIB_ERROR = f"native lmdbread unavailable: {e}"
        raise OSError(_LIB_ERROR) from e
    lib.lmr_open.restype = ctypes.c_void_p
    lib.lmr_open.argtypes = [ctypes.c_char_p]
    lib.lmr_close.argtypes = [ctypes.c_void_p]
    lib.lmr_count.restype = ctypes.c_longlong
    lib.lmr_count.argtypes = [ctypes.c_void_p]
    lib.lmr_psize.restype = ctypes.c_longlong
    lib.lmr_psize.argtypes = [ctypes.c_void_p]
    lib.lmr_sizes.restype = ctypes.c_int
    lib.lmr_sizes.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                              ctypes.c_void_p, ctypes.c_void_p]
    lib.lmr_read.restype = ctypes.c_int
    lib.lmr_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_void_p]
    lib.lmr_read_keys.restype = ctypes.c_int
    lib.lmr_read_keys.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_longlong, ctypes.c_void_p]
    lib.lmr_get.restype = ctypes.c_longlong
    lib.lmr_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
                            ctypes.c_void_p, ctypes.c_longlong]
    _LIB = lib
    return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeLmdbReader:
    """Read-only native LMDB environment; raises ``OSError`` if the native
    library is unavailable or the file fails to parse."""

    backend = "native"  # what :func:`open_best_reader` took

    def __init__(self, path: str, chunk_records: int = 512) -> None:
        self._lib = _load_lib()
        self._h = self._lib.lmr_open(os.fspath(path).encode())
        if not self._h:
            raise OSError(f"native lmdbread failed to open '{path}'")
        self.entries = int(self._lib.lmr_count(self._h))
        self.psize = int(self._lib.lmr_psize(self._h))
        self._chunk = max(1, int(chunk_records))

    def _sizes(self, start: int, count: int) -> Tuple[np.ndarray, np.ndarray]:
        ks = np.zeros(count, np.int64)
        vs = np.zeros(count, np.int64)
        if self._lib.lmr_sizes(self._h, start, count, _ptr(ks), _ptr(vs)) != 0:
            raise OSError("lmr_sizes failed")
        return ks, vs

    def _read_chunk(self, start: int, count: int) -> Iterator[Tuple[bytes, bytes]]:
        ks, vs = self._sizes(start, count)
        kbuf = np.empty(int(ks.sum()), np.uint8)
        vbuf = np.empty(int(vs.sum()), np.uint8)
        if self._lib.lmr_read(self._h, start, count, _ptr(kbuf), _ptr(vbuf)) != 0:
            raise OSError("lmr_read failed")
        ko = vo = 0
        for k, v in zip(ks.tolist(), vs.tolist()):  # one copy out of the chunk a record
            yield kbuf[ko : ko + k].tobytes(), vbuf[vo : vo + v].tobytes()
            ko += k
            vo += v

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """All (key, value) pairs in key order, ``chunk_records`` at a time."""
        for start in range(0, self.entries, self._chunk):
            yield from self._read_chunk(start, min(self._chunk, self.entries - start))

    def keys(self) -> Iterator[bytes]:
        """All keys in key order, without touching value bytes."""
        for start in range(0, self.entries, self._chunk):
            count = min(self._chunk, self.entries - start)
            ks, _ = self._sizes(start, count)
            kbuf = np.empty(int(ks.sum()), np.uint8)
            if self._lib.lmr_read_keys(self._h, start, count, _ptr(kbuf)) != 0:
                raise OSError("lmr_read_keys failed")
            kb = kbuf.tobytes()
            off = 0
            for k in ks.tolist():
                yield kb[off : off + k]
                off += k

    def get(self, key: bytes) -> Optional[bytes]:
        """Point lookup (binary search over the record index)."""
        cap = 1 << 20
        while True:
            out = np.empty(cap, np.uint8)
            n = self._lib.lmr_get(self._h, key, len(key), _ptr(out), cap)
            if n == -3:  # the value is larger than the buffer
                cap *= 8
                continue
            if n < 0:
                return None
            return out[:n].tobytes()

    def close(self) -> None:
        if self._h:
            self._lib.lmr_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def open_best_reader(path: str):
    """The native reader where it builds, else the Python
    :class:`~adsorbdiff_tpu_torch.data.lmdbio.LmdbReader`; the reader's
    ``backend`` (``"native"`` or ``"python"``) says which was taken."""
    try:
        return NativeLmdbReader(path)
    except OSError as e:
        from adsorbdiff_tpu_torch.data.lmdbio import LmdbReader

        logging.warning(f"{e}; reading '{path}' with the Python LMDB reader")
        return LmdbReader(path)
