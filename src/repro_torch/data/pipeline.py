"""Deterministic synthetic token batches for the port's LM side, with a
host-side prefetch.

``TokenStream`` is the JAX package's (``data/pipeline.py``): batch(step)
is a pure function of (seed, step) drawn with numpy, so both packages
see the same tokens and a restarted run replays the same stream.
``Prefetcher`` keeps ``prefetch`` batches ready on the device in a
background thread: placed by a sharding policy's batch specs
(``sharding/place.py::shard_batch``), or moved whole to a device.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


class TokenStream:
    """Deterministic synthetic LM batches: batch(step) = f(seed, step)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 extra_specs: Optional[dict] = None):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.extra_specs = extra_specs or {}

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        out = {
            "tokens": rng.integers(
                0, self.vocab, size=(self.batch, self.seq), dtype=np.int32
            )
        }
        for name, (shape, dtype) in self.extra_specs.items():
            out[name] = (0.1 * rng.standard_normal(size=shape)).astype(dtype)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a stream's batches onto the device.

    ``policy``: a ``ShardingPolicy`` -- each batch becomes DTensors placed
    by its batch specs (every rank draws the same host batch and keeps its
    slice); else each array goes whole to ``device`` (default the card;
    ``"cpu"`` on a machine without one).  ``n_steps`` bounds the batches;
    ``stop()`` ends the thread after the batch in hand.  Iterating yields
    the batches in stream order and ends with the stream."""

    def __init__(self, stream, policy=None, prefetch: int = 2,
                 n_steps: Optional[int] = None, device=None):
        from repro_torch.runtime.device import resolve_device

        self.stream = stream
        self.policy = policy
        self.device = None if policy is not None else resolve_device(device)
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self.n_steps = n_steps
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch: dict) -> dict:
        if self.policy is not None:
            from repro_torch.sharding.place import shard_batch

            return shard_batch(batch, self.policy)
        return {k: torch.as_tensor(v).to(self.device) if k != "pos" else v
                for k, v in batch.items()}

    def _worker(self):
        for i, batch in enumerate(self.stream):
            if self._stop.is_set() or (self.n_steps is not None and i >= self.n_steps):
                break
            self.q.put(self._place(batch))
        self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                break
            yield item

    def stop(self):
        self._stop.set()
