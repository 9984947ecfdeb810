"""Build the port's CUDA kernels with ``nvcc`` on first use and load them.

Each ``csrc/<name>.cu`` exports a plain C function and is compiled on its own
into ``lib<name>-<hash>.so`` in the build directory (:func:`build_dir`: by
default the git-ignored ``adsorbdiff_tpu_torch/_build/``), then loaded with
``ctypes``: no PyTorch headers, so a build takes seconds.  A source may
include the shared headers ``csrc/*.cuh``.  The hash covers the source,
every shared header and the flags, so an edited source or header is rebuilt
and a stale library is never loaded.  Nothing is built at import: only when
a CUDA tensor reaches a kernel wrapper, or when a caller asks for
:func:`build`.  A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

from adsorbdiff_tpu_torch.common import compile_cache

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
KERNELS = ("painn_message_fused", "painn_message_fused_bwd", "gemnet_quad_chain", "s2_grid_silu",
           "eqv2_attn_conv1", "s2_grid_silu_bwd", "eqv2_edge_rotate", "masked_legendre_cos",
           "painn_message_consumer", "fused_rbf_filter", "eqv2_attn_conv1_wide", "s2_grid_silu_bf16",
           "eqv2_attn_conv1_bf16", "eqv2_edge_rotate_bf16", "painn_message_fused_bf16")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # name -> nvcc/ptxas output of this process's build


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_dir() -> str:
    """Where libraries are built and loaded from
    (:func:`adsorbdiff_tpu_torch.common.compile_cache.cache_dir`, by default
    :data:`BUILD_DIR`)."""
    return compile_cache.cache_dir(BUILD_DIR)


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, name + ".cu")] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"lib{name}-{digest.hexdigest()[:16]}.so")


def compile_libraries(commands: Dict[str, Tuple[List[str], str]], logs: Dict[str, str]) -> None:
    """Run every ``name: (command, library path)`` at once, each command
    given ``-o`` and a ``tempfile.mkstemp`` name beside its library, which
    ``os.replace`` then moves onto the path: a reader never sees half a
    library, and processes that build at once each load a whole one.  Each
    compiler's output goes into ``logs``; a failure raises with it."""
    procs = {}
    for n, (cmd, path) in commands.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
        os.close(fd)
        procs[n] = (tmp, path, subprocess.Popen([*cmd, "-o", tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                text=True))
    errors = []
    for n, (tmp, path, proc) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"{os.path.basename(proc.args[0])} failed for {n} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, path)  # atomic
    if errors:
        raise RuntimeError("\n".join(errors))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named kernel that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: library path}``."""
    names = tuple(KERNELS if names is None else names)
    os.makedirs(build_dir(), exist_ok=True)
    paths = {n: library_path(n) for n in names}
    compile_libraries({n: ([nvcc_path(), *NVCC_FLAGS, os.path.join(CSRC_DIR, n + ".cu")], path)
                       for n, path in paths.items() if not os.path.exists(path)}, build_logs)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build([name])[name])
    return _loaded[name]
