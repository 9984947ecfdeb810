"""Build the port's host (CPU) libraries with ``g++`` on first use and load them.

The data layer's C++ sources, ``runtime/native/<name>.cc`` (the LMDB reader
``lmdbread`` and the ``.adbin`` collator ``adshard``), export plain C
functions bound with ``ctypes``.  Each compiles on its own into
``lib<name>-<hash>.so`` in the CUDA kernels' build directory (by default
the git-ignored ``adsorbdiff_tpu_torch/_build/``, else the one
:mod:`adsorbdiff_tpu_torch.common.compile_cache` picks), the hash over
the source and the flags, so an edited source is rebuilt and a stale library
is never loaded.  The compiles run as the kernels' do
(:func:`~adsorbdiff_tpu_torch.ops.build.compile_libraries`): processes that
build at once each load a whole library, and a failed build raises with the
compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
from typing import Dict, Iterable, Optional

from adsorbdiff_tpu_torch.common import compile_cache
from adsorbdiff_tpu_torch.ops.build import BUILD_DIR, PKG_DIR, compile_libraries

NATIVE_DIR = os.path.join(PKG_DIR, "runtime", "native")
# name -> extra flags; the collator's thread pool needs -pthread
LIBRARIES = {"lmdbread": (), "adshard": ("-pthread",)}
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # name -> compiler output of this process's build


def cxx_path() -> str:
    path = shutil.which(os.environ.get("CXX", "g++"))
    if path is None:
        raise RuntimeError("g++ not found (set CXX or put g++ on PATH)")
    return path


def flags(name: str) -> tuple:
    return CXX_FLAGS + LIBRARIES[name]


def build_dir() -> str:
    """Where the host libraries are built and loaded from (the compile
    cache's directory, by default :data:`BUILD_DIR`)."""
    return compile_cache.cache_dir(BUILD_DIR)


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    with open(os.path.join(NATIVE_DIR, name + ".cc"), "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(flags(name)).encode())
    return os.path.join(build_dir(), f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named library that has no up-to-date build, one
    compiler process per source, all started together.  Returns ``{name:
    library path}``."""
    names = tuple(LIBRARIES if names is None else names)
    os.makedirs(build_dir(), exist_ok=True)
    paths = {n: library_path(n) for n in names}
    compile_libraries({n: ([cxx_path(), *flags(n), os.path.join(NATIVE_DIR, n + ".cc")], path)
                       for n, path in paths.items() if not os.path.exists(path)}, build_logs)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build([name])[name])
    return _loaded[name]
