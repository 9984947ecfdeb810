"""The directory where the port's compiled libraries persist.

Port of :mod:`adsorbdiff_tpu.common.compile_cache`.  The JAX package persists
XLA executables across processes; the port compiles no graphs, and its
counterpart of that cost is building its CUDA kernels (``nvcc``,
:mod:`adsorbdiff_tpu_torch.ops.build`) and host libraries (``g++``,
:mod:`adsorbdiff_tpu_torch.ops.host_build`).  Both keep each library under a
name hashed over its source and flags in one directory, and every later
process loads it from there.  :func:`setup_compilation_cache` picks that
directory; both build modules read it (:func:`cache_dir`) each time they
build or look a library up.

Resolution order for the directory:

1. explicit ``path`` argument (config key ``compilation_cache_dir``),
2. ``$ADSORBDIFF_TPU_COMPILE_CACHE``,
3. the package's ``_build/`` (``ops/build.py::BUILD_DIR``).

``path=""`` returns None and leaves the directory as it is: the port cannot
run without building its libraries, so nothing is switched off.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

ENV = "ADSORBDIFF_TPU_COMPILE_CACHE"
_DIR: Optional[str] = None  # set by the first call of setup_compilation_cache


def setup_compilation_cache(path: Optional[str] = None) -> Optional[str]:
    """Fix the build directory for this process; returns it (None for
    ``path=""``).  Idempotent: the first call that picks a directory fixes
    it, and later calls return it."""
    global _DIR
    if path == "":
        return None
    if _DIR is None:
        if path is None:
            from adsorbdiff_tpu_torch.ops.build import BUILD_DIR

            path = os.environ.get(ENV) or BUILD_DIR
        os.makedirs(path, exist_ok=True)
        _DIR = os.path.abspath(path)
        logging.info(f"compiled libraries persist in {_DIR}")
    return _DIR


def cache_dir(default: str) -> str:
    """The directory a build module writes to and loads from: the one
    :func:`setup_compilation_cache` fixed, else ``$ADSORBDIFF_TPU_COMPILE_CACHE``,
    else the module's ``default``."""
    return _DIR or os.environ.get(ENV) or default
