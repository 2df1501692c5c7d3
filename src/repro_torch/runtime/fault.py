"""Fault-tolerant training: resilient step loop + straggler telemetry.

The counterpart of the JAX package's ``runtime/fault.py``: a
bounded-retry loop around the step, restore-from-checkpoint on failure,
and per-step timing telemetry that flags outliers.  The ``straggler``
and ``step_retry`` counters go through the port's
``runtime/telemetry.py`` spine, so they land in the same sinks as every
other signal.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

from repro_torch.runtime import telemetry

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class StepTelemetry:
    """EMA-based straggler detector: a step slower than `threshold` x the
    EMA is flagged -- logged AND emitted as a ``straggler`` counter."""

    ema: float = 0.0
    alpha: float = 0.1
    threshold: float = 3.0
    n_stragglers: int = 0
    n_steps: int = 0
    stage: str = "engine"

    def record(self, dt: float) -> bool:
        self.n_steps += 1
        is_straggler = self.ema > 0 and dt > self.threshold * self.ema
        if is_straggler:
            self.n_stragglers += 1
            log.warning("straggler step: %.3fs vs EMA %.3fs", dt, self.ema)
            telemetry.counter(self.stage, "straggler", dt_s=dt,
                              ema_s=self.ema, step=self.n_steps)
        self.ema = dt if self.ema == 0 else (1 - self.alpha) * self.ema + self.alpha * dt
        return is_straggler


class HostSnapshot:
    """A host copy of a training state's tensors, taken before each step
    and copied back in place after a failure: the port's step updates the
    parameters and moments in place, so, with no checkpoint to restore, a
    retry must start from this copy (JAX's state is immutable and its
    retry reads the pre-step state as it is).  Holds every leaf of
    ``checkpoint.manager._flatten`` (parameters, optimizer tensors,
    count, step); a DTensor leaf's local shard.  The buffers are made
    once, pinned where the leaves are on a card, and each ``take`` copies
    into them on the current stream, ahead of the step's own kernels."""

    def __init__(self):
        self.bufs: dict | None = None
        self.takes = 0

    @staticmethod
    def _leaves(state) -> dict:
        from repro_torch.checkpoint.manager import _flatten

        return {k: (t.to_local() if hasattr(t, "to_local") else t).detach()
                for k, t in _flatten(state).items()}

    def take(self, state) -> None:
        import torch

        leaves = self._leaves(state)
        if self.bufs is None or set(self.bufs) != set(leaves):
            self.bufs = {k: torch.empty(t.shape, dtype=t.dtype, device="cpu",
                                        pin_memory=t.is_cuda)
                         for k, t in leaves.items()}
        for k, t in leaves.items():
            self.bufs[k].copy_(t, non_blocking=t.is_cuda)
        self.takes += 1

    def restore(self, state) -> None:
        import torch

        with torch.no_grad():
            for k, t in self._leaves(state).items():
                t.copy_(self.bufs[k])
        for t in self._leaves(state).values():
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
                break

    def bytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in (self.bufs or {}).values())


class ResilientLoop:
    """Run `step_fn(state, batch) -> (state, metrics)` with checkpoint/restart.

    On any exception: restore the last checkpoint and replay; while no
    checkpoint exists, copy the pre-step snapshot (:class:`HostSnapshot`)
    back and retry the same step, bit for bit as JAX's retry.
    `max_retries` consecutive failures abort.  ``snapshot`` is the last
    run's :class:`HostSnapshot`.
    """

    def __init__(
        self,
        step_fn: Callable,
        ckpt,  # CheckpointManager
        save_every: int = 100,
        max_retries: int = 3,
    ):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.save_every = save_every
        self.max_retries = max_retries
        self.telemetry = StepTelemetry()

    def run(self, state, batch_at, n_steps: int, start_step: int = 0, device=None):
        """batch_at: step -> batch (a deterministic stream, so a restore
        also REWINDS THE DATA -- replay is bit-exact).  A restore goes to
        ``device`` (default the state's own).  Returns (state, final_step,
        last_metrics as floats)."""
        step = start_step
        retries = 0
        metrics = None
        self.ckpt.wait()
        have_ckpt = self.ckpt.latest_step() is not None
        self.snapshot = HostSnapshot()
        while step < n_steps:
            try:
                batch = batch_at(step)
                if not have_ckpt and retries == 0:
                    self.snapshot.take(state)
                t0 = time.time()
                state, metrics = self.step_fn(state, batch)
                # materialize before declaring success (asynchronous launches)
                metrics = {k: float(v) for k, v in metrics.items()}
                self.telemetry.record(time.time() - t0)
                step += 1
                retries = 0
                if step % self.save_every == 0:
                    self.ckpt.save(step, state)
                    have_ckpt = True  # the snapshot is no longer needed
                    self.snapshot.bufs = None
            except Exception as e:  # noqa: BLE001 -- the whole point
                retries += 1
                log.error("step %d failed (%s); retry %d/%d", step, e, retries,
                          self.max_retries)
                telemetry.counter("engine", "step_retry", step=step,
                                  retry=retries, max_retries=self.max_retries,
                                  error=repr(e)[:200])
                if retries > self.max_retries:
                    raise
                if not have_ckpt:  # the same step, from its pre-step state
                    self.snapshot.restore(state)
                    continue
                self.ckpt.wait()
                restored = self.ckpt.restore_latest(state, device)
                if restored[0] is not None:
                    step, state = restored
        self.ckpt.save(step, state, blocking=True)
        return state, step, metrics
