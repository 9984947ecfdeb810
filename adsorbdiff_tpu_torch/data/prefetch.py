"""Background batch prefetcher: collation and the host-to-card copy of batch
t+1 overlap the step on batch t.

Port of :mod:`adsorbdiff_tpu.data.prefetch`.  A worker thread runs the
iterable and the transform (usually :func:`to_device`) ``depth`` items ahead.
:func:`to_device` copies from pinned host memory with ``non_blocking=True``
on a side stream and makes the consumer's current stream wait for that copy
(and records the tensors on it), so the copy runs beside the step and the
caching allocator does not reuse the batch's memory early.  Abandoning the
iterator early signals the worker and drains the queue.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import torch

from adsorbdiff_tpu_torch.data.schema import AtomsBatch


class Prefetcher:
    """Iterate ``iterable`` on a worker thread, applying ``transform`` ahead
    of the consumer."""

    def __init__(self, iterable: Iterable, transform: Optional[Callable[[Any], Any]] = None, depth: int = 2) -> None:
        self._iterable = iterable
        self._transform = transform
        self._depth = max(1, int(depth))

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = object()
        cancel = threading.Event()
        err: list = []

        def put(item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker() -> None:
            try:
                for item in self._iterable:
                    if not put(self._transform(item) if self._transform else item):
                        return
            except BaseException as e:  # re-raised on the consumer thread
                err.append(e)
            finally:
                put(stop)

        thread = threading.Thread(target=worker, daemon=True, name="batch-prefetch")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            cancel.set()  # early exit: release the worker and drop queued batches
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


class _Ready:
    """A batch copied on a side stream; :meth:`get` makes the caller's
    current stream wait for the copy before the batch is used."""

    def __init__(self, batch: AtomsBatch, event: Optional[torch.cuda.Event]) -> None:
        self.batch, self.event = batch, event

    def get(self) -> AtomsBatch:
        if self.event is not None:
            stream = torch.cuda.current_stream(self.batch.device)
            stream.wait_event(self.event)
            for f in dataclasses.fields(self.batch):
                t = getattr(self.batch, f.name)
                if t is not None:
                    t.record_stream(stream)
        return self.batch


def to_device(batch: AtomsBatch, device: torch.device, stream: Optional["torch.cuda.Stream"] = None) -> _Ready:
    """Copy a host batch to ``device``: on a CUDA device from pinned memory,
    asynchronously on ``stream``; on the CPU as it is."""
    if device.type != "cuda":
        return _Ready(batch.to(device), None)
    with torch.cuda.stream(stream):
        fields = {
            f.name: None if getattr(batch, f.name) is None
            else getattr(batch, f.name).pin_memory().to(device, non_blocking=True)
            for f in dataclasses.fields(batch)
        }
        event = torch.cuda.Event()
        event.record()
    return _Ready(AtomsBatch(**fields), event)
