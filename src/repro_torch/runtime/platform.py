"""Execution tiers, the run's device list and the EDM_* process-group
contract of the port — the counterpart of the JAX package's
``runtime/platform.py``.

  * :data:`TIERS` — ``cpu`` (the CPU, the ``torch-reference`` engine) and
    ``gpu`` (the card, the ``cuda`` engine).  ``tpu`` is listed so that
    the names match the JAX package's, and refused: the port has no TPU
    tier.  XLA flags have no counterpart here: PyTorch runs eagerly and
    reads no flag set before its first operation, so a tier is only the
    device and the engine an entry point defaults to.
  * :func:`local_devices` — the run's device slots, the counterpart of
    the JAX package's ``default_mesh()``: every visible card, or the
    cards ``EDM_LOCAL_DEVICE_IDS`` names (a repeated id puts several
    slots on one card).  Phase 1, phase 2 and the significance stage
    take chunks of ``len(devices) x lib_block`` rows and give slot d
    the rows ``[row0 + d * lib_block, ...)``.  :func:`spoof_cpu_devices`
    is the counterpart of XLA's host-device spoof: n CPU slots.
  * :func:`init_distributed` — ``torch.distributed.init_process_group``
    from ``EDM_COORDINATOR`` / ``EDM_NUM_PROCESSES`` / ``EDM_PROCESS_ID``
    (``tcp://<coordinator>``), on NCCL where the ranks use cards and on
    gloo on the CPU or when asked.  The group carries the library-sharded
    kNN's collective merge (``core/knn.py::merge_topk_collective``) and,
    joined on gloo, rows across ranks (``runtime/ranks.py``: one
    ``edm_run`` a rank on :func:`rank_devices`).

Nothing here changes a value of any output: the tables and maps are the
same on every tier and for every device count.
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from datetime import timedelta

import torch

from repro_torch.runtime.device import resolve_device

#: the EDM_* contract, the JAX package's names
ENV_COORDINATOR = "EDM_COORDINATOR"      # host:port of rank 0
ENV_NUM_PROCESSES = "EDM_NUM_PROCESSES"  # world size
ENV_PROCESS_ID = "EDM_PROCESS_ID"        # this process's rank
ENV_LOCAL_DEVICE_IDS = "EDM_LOCAL_DEVICE_IDS"  # e.g. "0,1"; "0,0": two slots on card 0
RANK_ENV = (ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID)

#: how long a rank waits for the others to join the group
INIT_TIMEOUT = timedelta(seconds=120)


@dataclass(frozen=True)
class Tier:
    name: str
    device: str | None  # None: the tier is refused
    engine: str | None
    notes: str = ""


TIERS: dict[str, Tier] = {
    t.name: t
    for t in (
        Tier("cpu", "cpu", "torch-reference",
             "the plain PyTorch versions on the CPU"),
        Tier("gpu", "cuda", "cuda",
             "the hand-written CUDA kernels on every visible card"),
        Tier("tpu", None, None, "the port has no TPU tier"),
    )
}


def available_tiers() -> tuple[str, ...]:
    return tuple(sorted(TIERS))


def _tier(name: str) -> Tier:
    if name not in TIERS:
        raise KeyError(f"unknown platform tier {name!r}; available: "
                       f"{available_tiers()}")
    t = TIERS[name]
    if t.device is None:
        raise ValueError(
            f"platform tier {name!r}: the port has no TPU tier (it runs on "
            "CUDA cards and the CPU); run the JAX package (python -m "
            "repro.launch.edm_run --platform tpu) on a TPU"
        )
    return t


def default_engine(tier: str) -> str:
    """The engine a tier selects (``edm_run --platform``)."""
    return _tier(tier).engine


_APPLIED: dict | None = None


def apply_platform(tier: str) -> dict:
    """Select a tier: returns and records {tier, device, engine}, which
    ``edm_run --platform`` and the fleet's workers use as their device
    and engine.  ``tpu`` raises."""
    global _APPLIED
    t = _tier(tier)
    _APPLIED = {"tier": t.name, "device": t.device, "engine": t.engine}
    return dict(_APPLIED)


def current() -> dict | None:
    """The record of the last :func:`apply_platform`, or None."""
    return dict(_APPLIED) if _APPLIED is not None else None


# ----------------------------------------------------------- the devices
def _parse_ids(text: str | None) -> tuple[int, ...] | None:
    if not text:
        return None
    try:
        return tuple(int(i) for i in text.split(","))
    except ValueError:
        raise ValueError(f"{ENV_LOCAL_DEVICE_IDS}={text!r}: want comma-"
                         "separated device ids, e.g. 0,1") from None


def spoof_cpu_devices(n: int) -> list[torch.device]:
    """``n`` CPU slots: the multi-device paths on a machine without a
    card, as XLA's host-device spoof gives the JAX package ``n`` CPU
    devices.  Pass the list as an entry point's ``device``."""
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    return [torch.device("cpu")] * n


def local_devices(device=None, env=None) -> list[torch.device]:
    """The run's device slots.

    ``device`` a list or tuple: those devices, in that order.  None or
    ``"cuda"``: every visible card, ``cuda:0 ... cuda:{n-1}``, or the cards
    ``EDM_LOCAL_DEVICE_IDS`` names (``env``, default ``os.environ``); a
    repeated id puts several slots on one card.  ``"cuda:i"``: that card.
    ``"cpu"``: one CPU slot, or one per entry of ``EDM_LOCAL_DEVICE_IDS``
    (every entry 0, the one CPU).  Without a card a CUDA request raises:
    nothing falls back to the CPU."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("empty device list")
        return [resolve_device(d) for d in device]
    env = os.environ if env is None else env
    ids = _parse_ids(env.get(ENV_LOCAL_DEVICE_IDS))
    if ids == ():
        raise ValueError(f"{ENV_LOCAL_DEVICE_IDS} names no device")
    dev = resolve_device(device)
    if dev.type == "cpu":
        if ids is not None and any(i != 0 for i in ids):
            raise ValueError(f"{ENV_LOCAL_DEVICE_IDS}={ids}: on the CPU every "
                             "id is 0 (the one CPU; one slot per entry)")
        return [torch.device("cpu")] * (len(ids) if ids else 1)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    n = torch.cuda.device_count()
    if ids is None:
        ids = tuple(range(n))
    bad = [i for i in ids if not 0 <= i < n]
    if bad:
        raise ValueError(f"{ENV_LOCAL_DEVICE_IDS}: ids {bad} outside the {n} "
                         "visible card(s)")
    return [torch.device("cuda", i) for i in ids]


# ------------------------------------------------------- the process group
def distributed_spec_from_env(env=None) -> dict | None:
    """The EDM_* contract from ``env`` (default ``os.environ``):
    {coordinator, num_processes, process_id [, local_device_ids]}, or None
    where EDM_COORDINATOR is unset (one process).  Partial settings and a
    rank outside the world raise: a rank guessed would hang every other."""
    env = os.environ if env is None else env
    coord = env.get(ENV_COORDINATOR)
    if not coord:
        return None
    missing = [v for v in (ENV_NUM_PROCESSES, ENV_PROCESS_ID) if not env.get(v)]
    if missing:
        raise ValueError(
            f"{ENV_COORDINATOR} is set but {missing} missing: a multi-host "
            "mesh needs coordinator, world size AND rank"
        )
    spec = {
        "coordinator": coord,
        "num_processes": int(env[ENV_NUM_PROCESSES]),
        "process_id": int(env[ENV_PROCESS_ID]),
    }
    if not 0 <= spec["process_id"] < spec["num_processes"]:
        raise ValueError(f"process_id {spec['process_id']} outside world "
                         f"size {spec['num_processes']}")
    ids = _parse_ids(env.get(ENV_LOCAL_DEVICE_IDS))
    if ids:
        spec["local_device_ids"] = ids
    return spec


def rank_devices(spec: dict, device=None) -> list[torch.device]:
    """A rank's device slots: those its ``local_device_ids`` name (two
    ids, two slots); without them, where ``device`` is the card (None or
    ``"cuda"``), card ``process_id % device_count`` — one rank a card on
    one host — else ``device``."""
    ids = spec.get("local_device_ids")
    if ids:
        return local_devices(device, {ENV_LOCAL_DEVICE_IDS:
                                      ",".join(map(str, ids))})
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    return [torch.device("cuda", spec["process_id"] % torch.cuda.device_count())]


def rank_device(spec: dict, device=None) -> torch.device:
    """The device a rank computes on: the first of :func:`rank_devices`."""
    return rank_devices(spec, device)[0]


_DISTRIBUTED: dict | None = None


def init_distributed(spec: dict | None = None, *, device=None,
                     backend: str | None = None) -> dict | None:
    """Join (or form) the process group of the EDM_* contract.

    ``spec`` defaults to :func:`distributed_spec_from_env`; None (no
    EDM_COORDINATOR) is the one-process no-op.  ``backend`` None takes
    ``nccl`` where the rank computes on a card (:func:`rank_device`) and
    ``gloo`` on the CPU; ``gloo`` may be asked for on cards, and then the
    merge stages its tables through host memory.  NCCL rejects two ranks
    on one card: after the group forms, the ranks compare their cards
    over a gloo subgroup and, where two share one, tear the group down and
    raise, naming the gloo route.  Idempotent: the same spec again returns
    the first record; a conflicting one raises (one process, one group)."""
    global _DISTRIBUTED
    spec = distributed_spec_from_env() if spec is None else dict(spec)
    if spec is None:
        return None
    card = rank_device(spec, device)
    backend = backend or ("nccl" if card.type == "cuda" else "gloo")
    want = {**spec, "backend": backend, "device": str(card)}
    if _DISTRIBUTED is not None:
        if _DISTRIBUTED == want:
            return dict(_DISTRIBUTED)
        raise RuntimeError(
            f"torch.distributed already initialized with {_DISTRIBUTED}; "
            f"conflicting spec {want}"
        )
    import torch.distributed as dist

    if card.type == "cuda":
        torch.cuda.set_device(card)
    dist.init_process_group(
        backend, init_method=f"tcp://{spec['coordinator']}",
        world_size=spec["num_processes"], rank=spec["process_id"],
        timeout=INIT_TIMEOUT,
    )
    if backend == "nccl":
        _refuse_shared_cards(dist, card)
    _DISTRIBUTED = want
    return dict(_DISTRIBUTED)


def _refuse_shared_cards(dist, card: torch.device) -> None:
    """Raise (after tearing the group down) where two ranks of this NCCL
    group compute on one card."""
    props = torch.cuda.get_device_properties(card)
    mine = f"{socket.gethostname()}:{getattr(props, 'uuid', card.index)}"
    cards = [None] * dist.get_world_size()
    dist.all_gather_object(cards, mine, group=dist.new_group(backend="gloo"))
    if len(set(cards)) < len(cards):
        dist.destroy_process_group()
        raise RuntimeError(
            f"NCCL rejects two ranks on one card (ranks' cards: {cards}); "
            "give each rank its own card (EDM_LOCAL_DEVICE_IDS) or run the "
            "ranks on the gloo backend (init_distributed(backend='gloo'): "
            "the merge then stages its tables through host memory)"
        )


def distributed_info() -> dict | None:
    """The record this process joined its group with, or None."""
    return dict(_DISTRIBUTED) if _DISTRIBUTED is not None else None


def describe() -> dict:
    """Tier, group membership and the device census (never raises
    without a card)."""
    cuda = torch.cuda.is_available()
    return {
        "tier": current(),
        "distributed": distributed_info(),
        "devices": {
            "cuda_available": cuda,
            "visible_cards": torch.cuda.device_count() if cuda else 0,
            ENV_LOCAL_DEVICE_IDS: os.environ.get(ENV_LOCAL_DEVICE_IDS),
        },
    }
