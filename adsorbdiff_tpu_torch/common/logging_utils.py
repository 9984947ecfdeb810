"""Logging: split-stream root logger (INFO to stdout, WARNING and above to
stderr) and the experiment loggers, as :mod:`adsorbdiff_tpu.common.logging_utils`.

The TensorBoard logger writes through ``tensorboardX`` where it is installed
and otherwise logs nothing, as the JAX package's does.
"""
from __future__ import annotations

import logging
import sys
from typing import Any, Dict, Optional

from adsorbdiff_tpu_torch.common.registry import registry


def setup_logging(level: int = logging.INFO) -> None:
    root = logging.getLogger()
    if getattr(root, "_adsorbdiff_tpu_torch_configured", False):
        return
    root.setLevel(level)
    fmt = logging.Formatter("%(asctime)s (%(levelname)s): %(message)s", datefmt="%Y-%m-%d %H:%M:%S")

    out = logging.StreamHandler(stream=sys.stdout)
    out.setLevel(level)
    out.addFilter(lambda rec: rec.levelno < logging.WARNING)
    out.setFormatter(fmt)
    root.addHandler(out)

    err = logging.StreamHandler(stream=sys.stderr)
    err.setLevel(logging.WARNING)
    err.setFormatter(fmt)
    root.addHandler(err)
    root._adsorbdiff_tpu_torch_configured = True  # type: ignore[attr-defined]


class Logger:
    """Experiment logger interface."""

    def __init__(self, config: Optional[dict] = None) -> None:
        self.config = config or {}

    def log(self, update_dict: Dict[str, Any], step: Optional[int] = None, split: str = "") -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


@registry.register_logger("tensorboard")
class TensorboardLogger(Logger):
    def __init__(self, config: Optional[dict] = None) -> None:
        super().__init__(config)
        logdir = (self.config.get("cmd", {}) or {}).get("logs_dir", "./logs")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self.writer: Optional[Any] = None
        else:
            self.writer = SummaryWriter(logdir)

    def log(self, update_dict: Dict[str, Any], step: Optional[int] = None, split: str = "") -> None:
        if self.writer is None:
            return
        for k, v in update_dict.items():
            tag = f"{split}/{k}" if split else k
            try:
                self.writer.add_scalar(tag, float(v), step or 0)
            except (TypeError, ValueError):
                pass

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()

