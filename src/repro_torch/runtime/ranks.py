"""Rows across ranks: this process's place in a group of processes that
split each chunk of a run's rows, and the exchanges between them.

The JAX package runs one global mesh over every process's devices; its
phase 1, phase 2 and significance ``shard_map`` give device slot ``s``
of each chunk of ``slots x lib_block`` rows the rows ``[row0 + s *
lib_block, ...)``, process-major.  The port does the same with one
process a rank: a world of ``W`` ranks of ``n`` local slots each takes
chunks of ``W x n x lib_block`` rows, and rank ``r`` computes global
slots ``r*n .. r*n + n - 1`` of each (``core/pipeline.py::rank_plan``).

Every exchange is of host arrays (optE and phase-1 rho, chunk plans,
rows of a map, p-value counts), so :class:`Ranks` runs them on a gloo
group (``edm_run`` joins its ranks on gloo: the path runs no card-tensor
collective).  Each exchange starts with ``monitored_barrier``, and each
stage meets the ranks at up to :data:`CHECKS` of its chunks as well
(:meth:`Ranks.chunk_checks`).  A rank that died or raised makes the
others raise, naming the exchange, at their next meeting: at once where
its process is gone and gloo sees the connection closed, else after
:data:`WAIT_TIMEOUT`.  So a survivor exits within about 1/CHECKS of its
share of the stage (its rest of the stage where it has chunks the dead
rank lacks, at most one chunk in a fresh run) plus WAIT_TIMEOUT, and no
rank hangs at a barrier or a collective.  ``Ranks(None)`` is the
one-process world: every exchange is a no-op.
"""
from __future__ import annotations

import itertools
from datetime import timedelta

import numpy as np

#: how long a rank waits at an exchange for the others: it covers rank
#: 0's kernel build, its assembly and finalization of the store, and the
#: slowest rank's share of a stage
WAIT_TIMEOUT = timedelta(seconds=900)
#: the most meetings of the ranks within one stage's chunks
CHECKS = 64


class RanksError(RuntimeError):
    """An exchange between ranks failed: another rank died, raised, or
    did not arrive within :data:`WAIT_TIMEOUT`."""


class Ranks:
    """Rank, world size and the host-array exchanges of one group.

    ``group``: a gloo ``torch.distributed`` process group (e.g.
    ``dist.group.WORLD`` of a world joined on gloo) or None for one
    process.  The exchanges are collective: every rank calls them in one
    order."""

    def __init__(self, group=None):
        self.rank, self.world = 0, 1
        #: the gloo group the exchanges run on (None for one process)
        self.host = group
        if group is None:
            return
        import torch.distributed as dist

        if dist.get_backend(group) != "gloo":
            raise ValueError(
                f"rows across ranks exchange host arrays on a gloo group, not "
                f"{dist.get_backend(group)}: join on gloo "
                "(init_distributed(backend='gloo')) or pass a gloo subgroup")
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        if self.rank < 0:
            raise ValueError("this process is not a member of the group")
        self._src = dist.get_global_rank(group, 0)

    @property
    def lead(self) -> bool:
        """Rank 0: the one rank that writes the store's shared files."""
        return self.rank == 0

    @property
    def writer_id(self) -> str | None:
        """This rank's manifest shard, ``blocks.rank<r>.json``; one
        process writes ``blocks.json``."""
        return None if self.world == 1 else f"rank{self.rank}"

    def __repr__(self) -> str:
        return f"rank {self.rank}/{self.world}"

    def barrier(self, what: str) -> None:
        """Wait until every rank reached ``what``; raise where one did
        not (a dead or hung rank) within :data:`WAIT_TIMEOUT`."""
        if self.world == 1:
            return
        import torch.distributed as dist

        try:
            dist.monitored_barrier(group=self.host, timeout=WAIT_TIMEOUT,
                                   wait_all_ranks=True)
        except RuntimeError as e:
            raise RanksError(
                f"{self}: another rank failed before '{what}' (it died, "
                f"raised, or did not arrive within {WAIT_TIMEOUT}): {e}"
            ) from e

    def share(self, obj, what: str):
        """Rank 0's ``obj`` on every rank."""
        if self.world == 1:
            return obj
        import torch.distributed as dist

        self.barrier(what)
        box = [obj if self.lead else None]
        dist.broadcast_object_list(box, src=self._src, group=self.host)
        return box[0]

    def sum(self, counts: np.ndarray, what: str) -> np.ndarray:
        """Integer ``counts`` summed over the ranks (exact: int64)."""
        if self.world == 1:
            return counts
        import torch
        import torch.distributed as dist

        self.barrier(what)
        t = torch.from_numpy(np.ascontiguousarray(counts, np.int64)).clone()
        dist.all_reduce(t, group=self.host)
        return t.numpy()

    def gather_rows(self, maps: list[np.ndarray], spans, what: str) -> None:
        """Fill every rank's ``maps`` (host arrays of all N rows) with the
        rows each rank computed: ``spans`` are this rank's (r0, r1)."""
        if self.world == 1:
            return
        import torch.distributed as dist

        self.barrier(what)
        theirs = [None] * self.world
        dist.all_gather_object(
            theirs, [(r0, r1, [m[r0:r1] for m in maps]) for r0, r1 in spans],
            group=self.host)
        for r, blocks in enumerate(theirs):
            if r == self.rank:
                continue
            for r0, r1, parts in blocks:
                for m, p in zip(maps, parts):
                    m[r0:r1] = p

    def chunk_checks(self, n_common: int, what: str):
        """An ``on_chunk(row0)`` hook for a stage in which every rank has
        at least ``n_common`` chunks: it meets the other ranks
        (:meth:`barrier`) before up to :data:`CHECKS` of those chunks,
        evenly spaced, so a rank that died is noticed within the stage
        rather than at its end.  None for one process."""
        if self.world == 1 or n_common == 0:
            return None
        step = -(-n_common // CHECKS)
        seen = itertools.count()

        def check(row0: int) -> None:
            i = next(seen)
            if i < n_common and i % step == 0:
                self.barrier(f"{what}, rows from {row0}")

        return check
