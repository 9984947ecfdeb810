"""Profiling and tracing hooks.

Port of :mod:`adsorbdiff_tpu.common.profiling`.  The reference has no tracing
at all, just a CUDA-memory print helper (ref: adsorbdiff/utils/utils.py:119-126,
SURVEY.md §5).  Here: a ``torch.profiler`` trace around any block, and a
stage timer whose times include the device's work when the stage names a
CUDA tensor to fence on (the card runs asynchronously to the host, as the
TPU does to JAX).
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str = "./profile"):
    """Capture a ``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity where a card is present) into ``logdir`` as a
    ``*.pt.trace.json`` file that Perfetto and TensorBoard open.  Yields the
    profiler, whose ``key_averages()`` summarise the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof
    logging.info(f"profiler trace written to {logdir}")


class StageTimer:
    """Accumulates wall time per named stage; ``fence_on`` a CUDA tensor
    waits for its device before the stage's clock stops."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, fence_on: Optional[torch.Tensor] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if isinstance(fence_on, torch.Tensor) and fence_on.is_cuda:
                torch.cuda.synchronize(fence_on.device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = [
            f"{k}: {v:.3f}s total, {v / max(self.counts[k], 1) * 1000:.1f}ms avg ({self.counts[k]}x)"
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)
