"""Chunk streamer: overlap device compute with the host-side drain of
finished chunks (double buffering).

PyTorch on a CUDA card returns from a kernel launch before the kernel
runs.  :meth:`ChunkStreamer.submit` starts a non-blocking copy of the
chunk's result into pinned host memory and records an event behind it;
the chunk is drained (event synchronized, ``drain(tag, ndarray)``
called) only once ``depth`` chunks are in flight, so with depth = 2 the
next chunk is already queued on the card while the previous one is
copied out and written.  Drains run in submission order, which the
store's resume manifest needs.  CPU tensors and numpy arrays pass
through without a copy.  A chunk computed on several devices is
submitted as the list of its parts, each copied out from its own card
and joined on the host along ``axis`` before the drain.

:func:`upload_source` is the other direction: a host array from which
slices go to the card as asynchronous copies (a copy from pageable host
memory would wait for the stream's queued work first).
"""
from __future__ import annotations

import collections
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.runtime import telemetry


def upload_source(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` as a host tensor whose slices ``.to(device,
    non_blocking=True)`` upload asynchronously: in pinned memory when
    ``device`` is a card, else ``a`` itself (the slices are views)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if device.type == "cuda" else t


class _HostCopy:
    """A device tensor on its way to host memory."""

    def __init__(self, value: Any):
        self._src = value
        self._event = None
        if isinstance(value, torch.Tensor) and value.is_cuda:
            self._host = torch.empty(value.shape, dtype=value.dtype,
                                     pin_memory=True)
            self._host.copy_(value, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(value.device))

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            return self._host.numpy()
        if isinstance(self._src, torch.Tensor):
            return self._src.numpy()
        return np.asarray(self._src)


class _PartsCopy:
    """The parts of one chunk, each from its own device, joined on the
    host along ``axis``; every part's copy is started before any is
    waited for."""

    def __init__(self, parts, axis: int):
        self._copies = [_HostCopy(p) for p in parts]
        self._axis = axis

    def wait(self) -> np.ndarray:
        arrs = [c.wait() for c in self._copies]
        return arrs[0] if len(arrs) == 1 else np.concatenate(arrs, axis=self._axis)


class ChunkStreamer:
    """Bounded queue of in-flight chunks with ordered drains; each drain
    is a telemetry span (``stage``, "drain") whose ``gather_s`` is the
    wait for the chunk's result, ``tag`` the repr of the chunk's tag (a
    trace joins the drain to its unit by the row0 in it) and ``bytes``
    the result's size."""

    def __init__(self, drain: Callable[[Any, np.ndarray], None], depth: int = 2,
                 stage: str = "stream"):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.drain = drain
        self.depth = depth
        self.stage = stage  # telemetry label only
        self._pending: collections.deque[tuple[Any, _HostCopy]] = collections.deque()

    def submit(self, tag: Any, value: Any, axis: int = 0) -> None:
        """Enqueue a dispatched chunk result — a tensor, or a list of the
        parts that several devices computed, joined along ``axis`` — and
        drain the oldest chunk(s) once ``depth`` are in flight (depth 1 =
        synchronous)."""
        copy = (_PartsCopy(value, axis) if isinstance(value, (list, tuple))
                else _HostCopy(value))
        self._pending.append((tag, copy))
        while len(self._pending) >= self.depth:
            self._drain_one()

    def _drain_one(self) -> None:
        tag, copy = self._pending.popleft()
        with telemetry.span(self.stage, "drain", tag=repr(tag),
                            in_flight=len(self._pending), depth=self.depth) as t:
            t0 = time.perf_counter()
            host = copy.wait()  # the chunk's compute and copy-out
            t["gather_s"] = time.perf_counter() - t0
            t["bytes"] = int(host.nbytes)
            self.drain(tag, host)

    def flush(self) -> None:
        """Drain everything still in flight."""
        while self._pending:
            self._drain_one()

    def __enter__(self) -> "ChunkStreamer":
        return self

    def __exit__(self, exc_type, *_exc) -> None:
        # Don't mask an in-loop exception with a drain of stale chunks.
        if exc_type is None:
            self.flush()
        else:
            self._pending.clear()
