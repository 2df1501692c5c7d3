"""Deterministic fault injection of the port — named crash/error/delay
points, with the grammar and point names of ``repro.runtime.faultpoints``.

The fleet's crash-safety story (DESIGN.md SS10) rests on specific
ordering windows: tile temp-write -> fsync -> rename, store commit ->
done marker, lease steal readback.  Coarse SIGKILL testing hits those
windows only by luck; this module makes them addressable.  Production
code threads *named points* through the store, the work queue, and the
fleet stage loop via :func:`fire`; a fault SPEC (the ``EDM_FAULTS`` env
var, or :func:`configure` in-process) arms any subset of them:

    EDM_FAULTS="tile_pre_rename:crash@3,chunk_pre:delay=0.5"

Spec grammar (comma-separated arms)::

    <point>:<action>[@<n>]
    action   crash          SIGKILL self (no finally/atexit — the honest
                            crash the atomic-rename discipline must survive)
             exit=<code>    os._exit(code) (a non-signal hard death)
             error          raise InjectedFault (exercises bounded retries)
             delay=<secs>   time.sleep (exercises TTL / lease-age windows)
    @<n>     fire only on the n-th hit of the point in THIS process
             (1-based); omitted = fire on every hit.

Unarmed, :func:`fire` is a dict lookup on an empty table — cheap enough
for hot paths.  Hit counts are per-process, so a relaunched worker (new
process, typically spawned WITHOUT the spec) starts clean: one armed
crash kills one process generation, deterministically.

The point names are those of ``repro.runtime.faultpoints`` (the JAX
package's DESIGN.md SS12 catalogs them), so one ``EDM_FAULTS`` spec arms
the same windows in either package's workers; grep ``faultpoints.fire``
for the ground truth.
"""
from __future__ import annotations

import os
import signal
import threading
import time

from repro_torch.runtime import telemetry


class InjectedFault(RuntimeError):
    """Raised by an ``error``-armed fault point (a synthetic compute
    failure the bounded-retry machinery must absorb)."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at point {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


class FaultSpecError(ValueError):
    """Malformed ``EDM_FAULTS`` spec (fail loudly at parse time — a typo
    silently disarming a chaos schedule would void the test)."""


_lock = threading.Lock()
_arms: dict[str, tuple[str, float, int]] | None = None  # point -> (action, arg, nth)
_hits: dict[str, int] = {}


def parse_spec(spec: str) -> dict[str, tuple[str, float, int]]:
    """``"a:crash@3,b:delay=0.5"`` -> {point: (action, arg, nth)};
    nth=0 means every hit."""
    arms: dict[str, tuple[str, float, int]] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            point, action = part.split(":", 1)
        except ValueError:
            raise FaultSpecError(f"fault arm {part!r}: expected point:action")
        nth = 0
        if "@" in action:
            action, n = action.split("@", 1)
            nth = int(n)
            if nth < 1:
                raise FaultSpecError(f"fault arm {part!r}: @n must be >= 1")
        arg = 0.0
        if "=" in action:
            action, raw = action.split("=", 1)
            arg = float(raw)
        if action not in ("crash", "exit", "error", "delay"):
            raise FaultSpecError(
                f"fault arm {part!r}: unknown action {action!r}"
            )
        if action == "delay" and arg <= 0:
            raise FaultSpecError(f"fault arm {part!r}: delay needs =<secs>")
        arms[point.strip()] = (action, arg, nth)
    return arms


def configure(spec: str | None) -> None:
    """Arm (or with None/"" disarm) fault points in-process, resetting
    hit counts.  Subprocess workers are armed via the EDM_FAULTS env
    instead (see :func:`_load`)."""
    global _arms
    with _lock:
        _arms = parse_spec(spec) if spec else {}
        _hits.clear()


def _load() -> dict[str, tuple[str, float, int]]:
    global _arms
    if _arms is None:
        with _lock:
            if _arms is None:
                _arms = parse_spec(os.environ.get("EDM_FAULTS", ""))
    return _arms


def fire(point: str) -> None:
    """Hit a named fault point.  No-op unless a spec arms this point
    (and, with ``@n``, unless this is the n-th hit in this process)."""
    arms = _load()
    if not arms:
        return
    arm = arms.get(point)
    if arm is None:
        return
    with _lock:
        _hits[point] = hit = _hits.get(point, 0) + 1
    action, arg, nth = arm
    if nth and hit != nth:
        return
    telemetry.counter("fleet", "fault_fired", point=point, action=action,
                      hit=hit)
    if action == "delay":
        time.sleep(arg)
    elif action == "error":
        raise InjectedFault(point, hit)
    elif action == "exit":
        telemetry.flush()
        os._exit(int(arg))
    else:  # crash: the honest SIGKILL — no finally blocks, no atexit
        os.kill(os.getpid(), signal.SIGKILL)


def env_spec(*arms: str) -> dict[str, str]:
    """{"EDM_FAULTS": "<joined arms>"} — convenience for spawning one
    armed worker (chaos harness / spawn_worker(env=...))."""
    return {"EDM_FAULTS": ",".join(arms)}
