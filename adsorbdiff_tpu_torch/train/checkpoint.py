"""Checkpoints: the port's own single-file ``torch.save`` format.

One file holds the trainer state: ``params`` (the model's state dict without
its ScaleFactor buffers), ``ema_params``, ``opt_state`` (``count``, ``mu``,
``nu``), ``step``, ``scale_factors`` and ``config``.  A reference AdsorbDiff/OCP
``.pt`` checkpoint converts into this format with
:func:`adsorbdiff_tpu_torch.train.torch_import.convert_torch_checkpoint`
(``python -m adsorbdiff_tpu_torch.scripts.convert_checkpoint``); JAX (orbax)
checkpoints do not load.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Optional, Tuple

import torch


def save_checkpoint(run_dir: str, name: str, state: dict, config: Optional[dict] = None) -> str:
    """Write ``state`` (tensors moved to the CPU) and ``config`` to
    ``run_dir/name``, replacing it atomically.  Returns the path."""
    path = os.path.abspath(os.path.join(run_dir, name))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = dict(_to_cpu(state), config=_plain(config) if config is not None else None)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    os.close(fd)
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Tuple[dict, Optional[dict]]:
    """``(state, config)`` from a file written by :func:`save_checkpoint`;
    tensors are on the CPU."""
    payload = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    config = payload.pop("config", None)
    return payload, config


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _plain(obj: Any) -> Any:
    """The config as plain dicts, lists and scalars (what ``weights_only``
    loading accepts)."""
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)
