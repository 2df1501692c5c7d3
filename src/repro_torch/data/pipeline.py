"""Deterministic synthetic token batches for the port's LM side.

``TokenStream`` is the JAX package's (``data/pipeline.py``): batch(step)
is a pure function of (seed, step) drawn with numpy, so both packages
see the same tokens.  The JAX ``Prefetcher`` places batches by sharding
and comes with the sharded paths.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


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
