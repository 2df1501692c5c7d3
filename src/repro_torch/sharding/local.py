"""Blocks that run on each rank's local tensors under a DTensor activation.

The MoE dispatch (``models/moe.py``) and the Mamba2 block
(``models/ssm.py``) have no DTensor strategy: index dispatch, a
sequential scan, a gated norm over a head-sharded width.  They run on
plain local tensors between two DTensor boundaries, and :class:`Local`
says what each mesh dim of the activation x is to them:

  * "tokens": x's batch is sharded on it (``Shard(0)``): each rank holds
    its own tokens;
  * "split": the block's work is divided on it ("model": experts, or f
    inside each expert; the SSD heads): each rank computes a partial sum
    of the block's output;
  * "dup": neither: every rank computes the same thing.

The boundaries carry the gradient: x's local gradient is ``Shard(0)`` on
tokens dims, a partial sum on split dims (each rank's share of the
work), replicated on dup dims; a parameter's local gradient is a partial
sum on tokens dims (each rank's tokens), its own shard (or a partial sum
where a replicated weight is sliced) on split dims, replicated on dup
dims; the output leaves as a ``Partial`` DTensor on split dims.  On a
plain tensor (one device) every method is the identity.
"""
from __future__ import annotations

import torch


def _dt():
    from torch.distributed import tensor as dtensor

    return dtensor


def _meta_stride(shape):
    return torch.empty(shape, device="meta").stride()


class Local:
    """The roles of x's mesh dims (module docstring).  ``split``: whether
    the block divides its work on the "model" mesh dim."""

    def __init__(self, x: torch.Tensor, split: bool):
        from repro_torch.models.layers import _is_dt

        self.sharded = _is_dt(x)
        if not self.sharded:
            self.roles = []
            return
        dt = _dt()
        self.mesh = x.device_mesh
        names = self.mesh.mesh_dim_names
        self.roles = []
        for m, p in enumerate(x.placements):
            if isinstance(p, dt.Shard) and p.dim == 0:
                self.roles.append("tokens")
            elif split and names[m] == "model":
                self.roles.append("split")
            elif isinstance(p, dt.Replicate):
                self.roles.append("dup")
            else:
                raise ValueError(f"activation placement {p} on mesh dim {names[m]}: "
                                 "batch shard or replicated expected")

    # -- coordinates ------------------------------------------------------
    def _coord(self, role: str) -> tuple[int, int]:
        """(this rank's index, the count) over the mesh dims of ``role``,
        the first mesh dim outermost (DTensor's layout of a dim sharded on
        several mesh dims)."""
        if not self.sharded:
            return 0, 1
        coord = self.mesh.get_coordinate()
        idx, n = 0, 1
        for m, r in enumerate(self.roles):
            if r == role:
                idx, n = idx * self.mesh.size(m) + coord[m], n * self.mesh.size(m)
        return idx, n

    def token_rank(self) -> tuple[int, int]:
        return self._coord("tokens")

    def split_rank(self) -> tuple[int, int]:
        return self._coord("split")

    def counts(self) -> bool:
        """True on the one rank of each token shard that counts its tokens
        (index 0 on every split and dup dim)."""
        if not self.sharded:
            return True
        coord = self.mesh.get_coordinate()
        return all(c == 0 for c, r in zip(coord, self.roles) if r != "tokens")

    # -- boundaries -------------------------------------------------------
    def _plc(self, tokens, split, dup) -> list:
        return [{"tokens": tokens, "split": split, "dup": dup}[r] for r in self.roles]

    def x_local(self, x: torch.Tensor) -> torch.Tensor:
        if not self.sharded:
            return x
        dt = _dt()
        return x.to_local(grad_placements=self._plc(dt.Shard(0), dt.Partial(),
                                                    dt.Replicate()))

    def param(self, w: torch.Tensor, keep_shard: bool = True) -> torch.Tensor:
        """The local tensor of parameter ``w``: its data-parallel dims
        gathered (FSDP), its dup dims gathered; on split dims its shard
        kept (``keep_shard``, the caller uses the local block as it is) or
        gathered (the caller slices what it needs)."""
        if not self.sharded:
            return w
        dt = _dt()
        plc, grad = [], []
        for r, p in zip(self.roles, w.placements):
            if r == "split" and keep_shard and isinstance(p, dt.Shard):
                plc.append(p)
                grad.append(p)
            else:
                plc.append(dt.Replicate())
                grad.append(dt.Replicate() if r == "dup" else dt.Partial())
        if plc != list(w.placements):
            from repro_torch.models.layers import redistribute

            w = redistribute(w, plc)
        return w.to_local(grad_placements=grad)

    def out(self, yl: torch.Tensor, shape) -> torch.Tensor:
        """The rank's output share as a DTensor of global ``shape``: batch
        shard on tokens dims, a partial sum on split dims."""
        if not self.sharded:
            return yl
        dt = _dt()
        shape = torch.Size(shape)
        return dt.DTensor.from_local(
            yl, self.mesh, self._plc(dt.Shard(0), dt.Partial(), dt.Replicate()),
            run_check=False, shape=shape, stride=_meta_stride(shape))

    def scalar_sum(self, al: torch.Tensor) -> torch.Tensor:
        """The sum of a scalar's shares over tokens and split dims, on every
        rank (a plain tensor)."""
        if not self.sharded:
            return al
        dt = _dt()
        return dt.DTensor.from_local(
            al, self.mesh, self._plc(dt.Partial(), dt.Partial(), dt.Replicate()),
            run_check=False, shape=al.shape, stride=al.stride()).full_tensor()

    def sum_split(self, tl: torch.Tensor) -> torch.Tensor:
        """``tl`` (batch first) summed over the split dims, on every rank of
        them; its gradient is the sum of the ranks' gradients."""
        if "split" not in self.roles:
            return tl
        dt = _dt()
        shape = (tl.shape[0] * self.token_rank()[1],) + tuple(tl.shape[1:])
        part = self._plc(dt.Shard(0), dt.Partial(), dt.Replicate())
        whole = self._plc(dt.Shard(0), dt.Replicate(), dt.Replicate())
        d = dt.DTensor.from_local(tl, self.mesh, part, run_check=False,
                                  shape=torch.Size(shape), stride=_meta_stride(shape))
        return d.redistribute(self.mesh, whole).to_local(grad_placements=part)

    def gather_tokens(self, tl: torch.Tensor) -> torch.Tensor:
        """Every rank's ``tl`` (batch first) concatenated over the tokens
        dims, in batch order (no gradient)."""
        if "tokens" not in self.roles:
            return tl
        dt = _dt()
        shape = (tl.shape[0] * self.token_rank()[1],) + tuple(tl.shape[1:])
        d = dt.DTensor.from_local(tl.contiguous(), self.mesh,
                                  self._plc(dt.Shard(0), dt.Replicate(), dt.Replicate()),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_meta_stride(shape))
        return d.full_tensor()

    def gather_split(self, tl: torch.Tensor, dim: int) -> torch.Tensor:
        """Every split rank's ``tl`` concatenated along ``dim`` (no
        gradient)."""
        if "split" not in self.roles:
            return tl
        dt = _dt()
        n_tok, n_split = self.token_rank()[1], self.split_rank()[1]
        shape = list(tl.shape)
        shape[0] *= n_tok
        shape[dim] *= n_split
        plc = self._plc(dt.Shard(0), dt.Shard(dim), dt.Replicate())
        d = dt.DTensor.from_local(tl.contiguous(), self.mesh, plc, run_check=False,
                                  shape=torch.Size(shape), stride=_meta_stride(shape))
        whole = self._plc(dt.Shard(0), dt.Replicate(), dt.Replicate())
        return d.redistribute(self.mesh, whole).to_local()

    def state(self, tl: torch.Tensor, split_dim=None) -> torch.Tensor:
        """A decode state as a DTensor: batch shard on tokens dims, sharded
        on ``split_dim`` over split dims (None: the same on every split
        rank)."""
        if not self.sharded:
            return tl
        dt = _dt()
        shape = list(tl.shape)
        shape[0] *= self.token_rank()[1]
        split = dt.Replicate()
        if split_dim is not None:
            split = dt.Shard(split_dim)
            shape[split_dim] *= self.split_rank()[1]
        shape = torch.Size(shape)
        return dt.DTensor.from_local(tl.contiguous(), self.mesh,
                                     self._plc(dt.Shard(0), split, dt.Replicate()),
                                     run_check=False, shape=shape,
                                     stride=_meta_stride(shape))

    def local_state(self, st: torch.Tensor, split_dim=None) -> torch.Tensor:
        """A DTensor decode state's local tensor: batch shard on tokens dims,
        on split dims sharded on ``split_dim`` (None: gathered whole)."""
        if not self.sharded:
            return st
        dt = _dt()
        split = dt.Replicate() if split_dim is None else dt.Shard(split_dim)
        plc = self._plc(dt.Shard(0), split, dt.Replicate())
        if list(st.placements) != plc:
            st = st.redistribute(st.device_mesh, plc)
        return st.to_local()
