"""Build the port's CUDA kernels with ``nvcc`` on first use and load them.

Each ``csrc/<name>.cu`` exports a plain C function and is compiled on its own
into ``adsorbdiff_tpu_torch/_build/lib<name>-<hash>.so`` (the directory is
git-ignored), then loaded with ``ctypes``: no PyTorch headers, so a build
takes seconds.  A source may include the shared headers ``csrc/*.cuh``.  The
hash covers the source, every shared header and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.  Nothing is
built at import: only when a CUDA tensor reaches a kernel wrapper, or when a
caller asks for :func:`build`.  A failed build raises with the compiler's
output.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
KERNELS = ("painn_message_fused", "painn_message_fused_bwd", "gemnet_quad_chain", "s2_grid_silu",
           "eqv2_attn_conv1", "s2_grid_silu_bwd", "eqv2_edge_rotate", "masked_legendre_cos",
           "painn_message_consumer", "fused_rbf_filter", "eqv2_attn_conv1_wide")
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


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, name + ".cu")] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named kernel that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: library path}``."""
    names = tuple(KERNELS if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, n + ".cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {n} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[n])  # atomic: a reader never sees half a library
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build([name])[name])
    return _loaded[name]
