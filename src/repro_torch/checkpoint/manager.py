"""Asynchronous checkpointing of the port's training state.

The counterpart of the JAX package's ``checkpoint/manager.py``, same
design and layout:
  * each checkpoint is a directory ``step_<n>/`` of one .npy per leaf
    (flat key = path joined with '.': ``params.blocks.3.attn.wq.w``,
    ``opt.m.embed.tok``, ``opt.count``, ``step``) and ``manifest.json``;
  * writes happen on a background thread, at most one in flight
    (``wait()`` joins before the next save or at exit);
  * commits are atomic: write to ``tmp_step_<n>/``, then rename;
  * ``keep_last`` garbage-collects old steps.

Two things differ from JAX's arrays.  The snapshot COPIES every leaf to
host memory before ``save`` returns: on the CPU ``t.cpu()`` and
``t.numpy()`` alias the live tensor, which the in-place optimizer step
would change while the thread writes it.  numpy has no bfloat16: a
bfloat16 leaf is stored as its 16-bit patterns (uint16) and the
manifest records every leaf's dtype (``dtypes``), so a restore is bit
for bit.

A tree is a ``TrainState`` (its ``params``, ``opt``, ``step``), an
``LM`` module (its parameters), a dict, or a tensor.  ``restore`` builds
a new tree shaped like ``like`` (the module anew from its ``cfg``, so
the live one can be dropped) on ``device`` (default each leaf's own).

Sharded (JAX's "elastic: any mesh"): a DTensor leaf is gathered whole
on save (a collective: every rank calls ``save``), rank 0 writes, and
``wait`` meets every rank after the write; ``restore`` places each leaf
as ``like``'s is placed (a sharded module is built again shard by shard
by its policy, ``place.build_sharded``; the expert-parallel weights and
Adafactor's accumulators by their specs), reading each leaf from disk
when it is placed, so a checkpoint written at one world size resumes at
another.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading
from typing import Optional

import numpy as np
import torch
from torch import nn

_SEP = "."


def _flatten(tree, prefix: str = "") -> dict:
    """{flat key: tensor} of a tree (module docstring)."""
    pre = prefix + _SEP if prefix else ""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, nn.Module):
        return {pre + k: p for k, p in tree.named_parameters()}
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, pre + str(k)))
        return out
    raise TypeError(f"checkpoint leaf {prefix!r}: {type(tree).__name__} is not a tensor")


def _world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _snapshot(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` (never an alias; a DTensor gathered whole) and
    its dtype's name."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    host = t.detach().to("cpu", copy=True)
    name = str(host.dtype).removeprefix("torch.")
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16), name
    return host.numpy(), name


def _load(path: pathlib.Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class _Leaves:
    """{flat key: tensor} of a checkpoint directory, each leaf read from
    disk when it is asked for (a sharded restore holds one whole leaf at a
    time)."""

    def __init__(self, d: pathlib.Path, dtypes: dict):
        self.d, self.dtypes = d, dtypes

    def __getitem__(self, key: str) -> torch.Tensor:
        return _load(self.d / (key + ".npy"), self.dtypes[key])


def _rebuild(like, loaded: dict, device, prefix: str = ""):
    pre = prefix + _SEP if prefix else ""
    if isinstance(like, torch.Tensor):
        if hasattr(like, "device_mesh"):  # a DTensor: placed as ``like`` is
            from repro_torch.sharding.place import place

            return place(loaded[prefix].to(like.dtype), like.device_mesh, like.placements)
        return loaded[prefix].to(device=like.device if device is None else device,
                                 dtype=like.dtype)
    if isinstance(like, nn.Module):
        policy = getattr(like, "sharding_policy", None)
        if policy is not None:  # shard by shard: each leaf whole only while placed
            from repro_torch.sharding.place import build_sharded

            return build_sharded(like.cfg, policy, lambda k, p: loaded[pre + k].to(p.dtype))
        dev = next(like.parameters()).device if device is None else torch.device(device)
        fresh = type(like)(like.cfg, dev)
        with torch.no_grad():
            for k, p in fresh.named_parameters():
                p.copy_(loaded[pre + k])
        return fresh
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), loaded, device, pre + f.name)
            for f in dataclasses.fields(like)})
    return {k: _rebuild(v, loaded, device, pre + str(k)) for k, v in like.items()}


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep_last: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False) -> None:
        self.wait()  # at most one in-flight save
        # snapshot to host (copies) before handing to the writer thread
        host, dtypes = {}, {}
        for key, t in _flatten(tree).items():
            host[key], dtypes[key] = _snapshot(t)

        def _write():
            tmp = self.dir / f"tmp_step_{step:08d}"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for key, arr in host.items():
                np.save(tmp / (key + ".npy"), arr)
            (tmp / "manifest.json").write_text(json.dumps(
                {"step": step, "keys": sorted(host), "dtypes": dtypes}))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if _world()[0] != 0:  # rank 0 writes the gathered tree
            if blocking:
                self.wait()
            return
        if blocking:
            _write()
            self.wait()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _world()[1] > 1:  # every rank sees rank 0's last write
            import torch.distributed as dist

            dist.barrier()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if (p / "manifest.json").exists()
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, device=None):
        """A new tree shaped like ``like`` with the leaves of ``step``, bit
        for bit, on ``device`` (default each ``like`` leaf's device)."""
        d = self.dir / f"step_{step:08d}"
        dtypes = json.loads((d / "manifest.json").read_text())["dtypes"]
        keys = _flatten(like)
        missing = sorted(set(keys) - set(dtypes))
        if missing:
            raise KeyError(f"checkpoint step {step} lacks {missing[:5]}")
        return _rebuild(like, _Leaves(d, dtypes), device)

    def restore_latest(self, like, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, device)
