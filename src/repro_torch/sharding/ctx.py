"""Ambient sharding context: lets layer code redistribute internal
activations (sequence-parallel attention) without threading the mesh and
the policy through every call signature.

The counterpart of the JAX package's ``sharding/ctx.py``.  Set around a
sharded run:

    with sharding_ctx(mesh, policy):
        step(state, batch)

``constrain(x, spec)`` is a no-op outside the context, and on a tensor
that is not a DTensor, so model code stays runnable on one device and in
tests.  Inside it, a DTensor is redistributed to the spec's placements
(``place.placements``): the counterpart of ``with_sharding_constraint``.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_CTX = contextvars.ContextVar("repro_torch_shard_ctx", default=None)


@contextlib.contextmanager
def sharding_ctx(mesh, policy):
    tok = _CTX.set((mesh, policy))
    try:
        yield
    finally:
        _CTX.reset(tok)


def current_policy():
    ctx = _CTX.get()
    return ctx[1] if ctx else None


def _redistribute(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.place import placements

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(spec, mesh))


def constrain(x: torch.Tensor, spec) -> torch.Tensor:
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, _ = ctx
    return _redistribute(x, mesh, tuple(spec))


def constrain_seq_parallel(x: torch.Tensor, seq_axis: int) -> torch.Tensor:
    """Shard dim ``seq_axis`` on the model axis, batch dim 0 on the dp axes
    (divisibility-checked), as sequence-parallel attention wants."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, policy = ctx
    if policy.dp_only:
        return x  # model axis already consumed by batch parallelism
    spec = [None] * x.ndim
    spec[0] = policy._fit(policy.dp, x.shape[0])
    if x.shape[seq_axis] % policy.axis_size("model") == 0:
        spec[seq_axis] = "model"
    return _redistribute(x, mesh, tuple(spec))
