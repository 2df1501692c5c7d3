"""'zarr-lite' memmap store of the port, in the JAX package's on-disk
format: ``<name>/meta.json`` + ``<name>/data.npy``, blocks listed with
their crc32 in a self-checksummed ``blocks.json`` manifest — full-width
causal-map row blocks ``rows_<row0>.npy`` (``"row0": [nrows, crc32]``)
and the column tiles ``tile_<row0>_<col0>.npy`` of the tiled phase 2 and
the significance stage (``"row0,col0": [nrows, ncols, crc32]``, columns
in the bucket-sorted order recorded in ``col_order.npy``, or natural
where there is none) — and a ``.crc32`` sidecar beside
every standalone array, so ``repro``'s ``edm_fleet fsck`` verifies a
port store.

Every write is write-temp + fsync + os.replace: a process killed at any
point leaves the old file or the new one, never a torn mix.  The
manifest doubles as the resume record: a rerun recomputes only the rows
it does not cover.  Fleet workers each commit to a manifest shard of
their own (``blocks.<writer>.json``), and every reader merges all
shards, so no two processes ever write one file.  The writes carry the
JAX package's named fault points (``runtime/faultpoints.py``:
``tile_pre_fsync``, ``tile_pre_rename``, ``manifest_pre_rename``, ...)
and telemetry spans (``write_tile``, ``write_block``,
``manifest_commit``).
"""
from __future__ import annotations

import errno
import json
import os
import pathlib
import time

import numpy as np

# telemetry and faultpoints import nothing of the store at module scope
# (the JSONL sink borrows atomic_write_text lazily), so this is acyclic.
from repro_torch.runtime import faultpoints, telemetry
from repro_torch.runtime.integrity import (
    Crc32,
    IntegrityError,
    checksum_file,
    manifest_with_crc,
    read_manifest_shard,
    write_sidecar,
)

FATAL_WRITE_ERRNOS = (errno.ENOSPC, errno.EDQUOT, errno.EROFS)


def _fsync_dir(path: pathlib.Path) -> None:
    """Best-effort directory fsync after a rename."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _unique_tmp(path: pathlib.Path) -> pathlib.Path:
    return path.parent / f"{path.name}.tmp-{os.getpid()}-{os.urandom(4).hex()}"


def _classify_write_error(e: OSError, path: pathlib.Path,
                          tmp: pathlib.Path) -> OSError:
    try:
        tmp.unlink()
    except OSError:
        pass
    if e.errno in FATAL_WRITE_ERRNOS:
        return OSError(e.errno, f"out of space at {path} "
                                f"({os.strerror(e.errno)})")
    return e


def atomic_write_text(
    path: str | pathlib.Path, text: str, fault: str | None = None
) -> None:
    """write-temp + fsync + os.replace, the one durability primitive of
    the store and the work queue.  ``fault`` names the write's fault
    point prefix: ``<fault>_pre_rename`` fires with the temp durable and
    not yet visible."""
    path = pathlib.Path(path)
    tmp = _unique_tmp(path)
    try:
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
    except OSError as e:
        raise _classify_write_error(e, path, tmp) from e
    if fault is not None:
        faultpoints.fire(f"{fault}_pre_rename")
    os.replace(tmp, path)
    _fsync_dir(path.parent)


def atomic_save_npy(
    path: pathlib.Path, arr: np.ndarray, fault: str | None = None
) -> dict:
    """Atomic np.save; the crc32 is accumulated while the bytes stream
    out.  Duplicate writers of one block (a stolen lease) replace each
    other with the same bytes.  ``fault`` arms ``<fault>_pre_fsync`` and
    ``<fault>_pre_rename``.  Returns {bytes, fsync_s, crc32}."""
    tmp = _unique_tmp(path)
    try:
        with open(tmp, "wb") as f:
            tee = Crc32(f)
            np.save(tee, arr)
            f.flush()
            if fault is not None:
                faultpoints.fire(f"{fault}_pre_fsync")
            t0 = time.perf_counter()
            os.fsync(f.fileno())
            fsync_s = time.perf_counter() - t0
    except OSError as e:
        raise _classify_write_error(e, path, tmp) from e
    if fault is not None:
        faultpoints.fire(f"{fault}_pre_rename")
    os.replace(tmp, path)
    _fsync_dir(path.parent)
    return {"bytes": int(arr.nbytes), "fsync_s": fsync_s, "crc32": tee.hex}


def save_npy_checksummed(
    path: pathlib.Path, arr: np.ndarray, fault: str | None = None
) -> dict:
    """atomic_save_npy + ``<path>.crc32`` sidecar, for standalone .npy
    artifacts with no manifest to carry their checksum (dataset,
    col_order, phase-1 outputs, edges).  The sidecar lands after the
    data."""
    stats = atomic_save_npy(path, arr, fault=fault)
    write_sidecar(path, stats["crc32"])
    return stats


def save_meta(path: str | pathlib.Path, shape, dtype, meta: dict | None = None) -> None:
    """Write just the zarr-lite meta.json."""
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    atomic_write_text(
        p / "meta.json",
        json.dumps({"shape": list(shape), "dtype": str(dtype), **(meta or {})}),
    )


def save_dataset(path: str | pathlib.Path, ts: np.ndarray,
                 meta: dict | None = None) -> None:
    """A zarr-lite dataset (``data.npy`` with its sidecar, then
    ``meta.json``), atomic, so a driver killed mid-save leaves nothing a
    resume would trust."""
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    save_npy_checksummed(p / "data.npy", ts, fault="dataset")
    save_meta(p, ts.shape, ts.dtype, meta)


def load_dataset(path: str | pathlib.Path, mmap: bool = True) -> np.ndarray:
    return np.load(pathlib.Path(path) / "data.npy", mmap_mode="r" if mmap else None)


def _union_covers(intervals: list[tuple[int, int]], width: int) -> bool:
    """True when the union of [a, b) intervals covers [0, width)."""
    reach = 0
    for a, b in sorted(intervals):
        if a > reach:
            return False
        reach = max(reach, b)
        if reach >= width:
            return True
    return reach >= width


class TileWriter:
    """Streamed (N, N) output in blocks + the ``blocks.json`` manifest,
    the resume unit of the pipeline: full-width row blocks in natural
    column order (:meth:`write_block`, the untiled phase 2) and
    (row-chunk x col-tile) tiles (:meth:`write_tile`, the tiled phase 2
    and the significance stage), in the column order declared by
    :meth:`ensure_col_order` (the bucket-sorted one, or natural), undone
    at :meth:`assemble`.  Coverage is per row: a row is covered once its
    blocks union to the full width, so a rerun with another ``lib_block``
    or ``target_tile`` resumes exactly where the last run stopped.

    ``writer_id``: a fleet worker commits its entries to a shard of its
    own, ``blocks.<writer_id>.json``; every writer (and a reader, with
    ``writer_id=None``) loads the union of all shards, so coverage,
    chunk plans and assembly see every durable block whoever wrote it."""

    def __init__(self, path: str | pathlib.Path, N: int,
                 writer_id: str | None = None, stage: str = "store"):
        self.dir = pathlib.Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.N = N
        # telemetry label only: the pipeline stage of this writer's blocks
        self.stage = stage
        if writer_id is not None and not writer_id.isidentifier():
            raise ValueError(f"writer_id={writer_id!r} must be identifier-like")
        self.writer_id = writer_id
        self.manifest = self.dir / (
            "blocks.json" if writer_id is None else f"blocks.{writer_id}.json"
        )
        # _own: the entries this writer commits (its shard); done: the
        # merge of every shard, for coverage and assembly.  A torn own
        # shard reads as {}: its blocks are recomputed.
        self._own: dict[str, list] = (
            read_manifest_shard(self.manifest) or {}
            if self.manifest.exists() else {}
        )
        self.done: dict[str, list] = {}
        self.refresh()
        co = self.dir / "col_order.npy"
        self._col_order: np.ndarray | None = np.load(co) if co.exists() else None

    def _manifest_shards(self):
        """blocks.json and every blocks.<writer>.json (the .tmp residue
        of a killed writer does not count)."""
        for p in sorted(self.dir.glob("blocks*.json")):
            if p.suffix == ".json":
                yield p

    def refresh(self) -> "TileWriter":
        """Re-merge every manifest shard from disk (a fleet worker sees
        the blocks other processes committed); this writer's uncommitted
        entries are kept.  A torn or corrupt shard is skipped: its blocks
        read as uncovered and are recomputed."""
        merged: dict[str, list] = {}
        for p in self._manifest_shards():
            merged.update(read_manifest_shard(p) or {})
        merged.update(self._own)
        self.done = merged
        return self

    @property
    def has_tiles(self) -> bool:
        return any("," in key for key in self.done)

    def _blocks(self):
        """Yield (tiled, row0, col0, nrows, ncols, crc|None) per manifest
        entry (legacy entries without a crc read as unverified)."""
        for key, val in self.done.items():
            if "," in key:
                row0, col0 = (int(v) for v in key.split(","))
                yield (True, row0, col0, int(val[0]), int(val[1]),
                       val[2] if len(val) > 2 else None)
            elif isinstance(val, list):
                yield False, int(key), 0, int(val[0]), self.N, val[1]
            else:
                yield False, int(key), 0, int(val), self.N, None

    def covered(self) -> np.ndarray:
        """(N,) bool: rows whose blocks union to the full column width
        (a row missing one tile is recomputed whole).  Tiles are grouped
        by their (row0, nrows) span, whose column intervals are merged
        once for all its rows; only rows under spans that do not cover on
        their own (tiles of two geometries, from a resume with another
        chunk or tile size) fall back to a per-row union."""
        cov = np.zeros(self.N, bool)
        spans: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for _tiled, row0, col0, nr, nc, _crc in self._blocks():
            if col0 == 0 and nc >= self.N:
                cov[row0 : row0 + nr] = True
            else:
                spans.setdefault((row0, nr), []).append((col0, col0 + nc))
        per_row: dict[int, list[tuple[int, int]]] = {}
        for (row0, nr), ivals in spans.items():
            if _union_covers(ivals, self.N):
                cov[row0 : row0 + nr] = True
                continue
            for r in range(row0, min(row0 + nr, self.N)):
                per_row.setdefault(r, []).extend(ivals)
        for r, ivals in per_row.items():
            if not cov[r] and _union_covers(ivals, self.N):
                cov[r] = True
        return cov

    def next_uncovered(self, start: int = 0) -> int | None:
        idx = np.nonzero(~self.covered()[start:])[0]
        return int(idx[0]) + start if idx.size else None

    def chunk_plan(
        self, chunk: int, covered: np.ndarray | None = None
    ) -> list[tuple[int, int]]:
        """Ordered (row0, nrows) work list: each run of uncovered rows
        split into at-most-``chunk`` spans.  ``covered`` overrides this
        writer's own coverage (the significance stage passes the AND of
        its artifacts' coverages, so a chunk missing from any of them is
        recomputed for all)."""
        if covered is None:
            covered = self.covered()
        uncovered = np.nonzero(~np.asarray(covered))[0]
        if uncovered.size == 0:
            return []
        run_starts = np.nonzero(np.diff(uncovered) > 1)[0] + 1
        plan: list[tuple[int, int]] = []
        for run in np.split(uncovered, run_starts):
            s, e = int(run[0]), int(run[-1]) + 1
            for row0 in range(s, e, chunk):
                plan.append((row0, min(chunk, e - row0)))
        return plan

    def commit(self) -> None:
        """Rewrite this writer's manifest shard (atomic) with its own
        entries only; flushes deferred tile entries."""
        with telemetry.span(self.stage, "manifest_commit",
                            entries=len(self._own)):
            atomic_write_text(self.manifest, manifest_with_crc(self._own),
                              fault="manifest")

    def ensure_col_order(self, order: np.ndarray | None) -> None:
        """Declare (and persist, checksummed) the on-disk column
        permutation of tile writes, ``None`` for natural order (which
        needs no file); raises if it conflicts with a prior run's
        layout."""
        want = np.arange(self.N) if order is None else np.asarray(order)
        f = self.dir / "col_order.npy"
        if f.exists():
            have = np.load(f)
            if not np.array_equal(have, want):
                raise ValueError(
                    f"resume column-order mismatch in {self.dir}: the store "
                    "was written under a different target permutation "
                    "(different optE/bucketing?); use a fresh --out dir"
                )
            self._col_order = None if order is None else have
            return
        if order is None:
            return
        # full-width row blocks are natural order and mix with any tile
        # order; only tiles already on disk pin the layout
        if self.has_tiles and not np.array_equal(want, np.arange(self.N)):
            raise ValueError(
                f"store {self.dir} already holds natural-order tiles; "
                "cannot add column-permuted tiles (use a fresh --out dir)"
            )
        # workers race this benignly: all derive the same permutation
        save_npy_checksummed(f, want, fault="col_order")
        self._col_order = want

    def write_block(self, row0: int, rho_rows: np.ndarray) -> None:
        """One full-width row block, then the manifest entry."""
        rho_rows = rho_rows[: max(0, self.N - row0)]
        with telemetry.span(self.stage, "write_block", row0=row0) as t:
            stats = atomic_save_npy(self.dir / f"rows_{row0:08d}.npy",
                                    rho_rows, fault="tile")
            t.update(stats)
        entry = [int(rho_rows.shape[0]), stats["crc32"]]
        self.done[str(row0)] = self._own[str(row0)] = entry
        self.commit()

    def write_tile(self, row0: int, col0: int, block: np.ndarray,
                   commit: bool = True) -> None:
        """One (row-chunk x col-tile) block, columns in on-disk order.
        ``commit=False`` defers the manifest rewrite to :meth:`commit`
        (an uncommitted tile is merely recomputed on resume)."""
        block = block[: max(0, self.N - row0), : max(0, self.N - col0)]
        with telemetry.span(self.stage, "write_tile", row0=row0,
                            col0=col0) as t:
            stats = atomic_save_npy(
                self.dir / f"tile_{row0:08d}_{col0:08d}.npy", block,
                fault="tile",
            )
            t.update(stats)
        entry = [int(block.shape[0]), int(block.shape[1]), stats["crc32"]]
        self.done[f"{row0},{col0}"] = self._own[f"{row0},{col0}"] = entry
        if commit:
            self.commit()

    def assemble(self, mmap_path: str | pathlib.Path | None = None) -> np.ndarray:
        """Gather every block into the (N, N) map, undoing col_order and
        verifying each block's crc first.  With ``mmap_path`` the map is a
        .npy memmap there (given its own sidecar); else a dense host
        array."""
        if mmap_path is None:
            rho = np.zeros((self.N, self.N), np.float32)
        else:
            p = pathlib.Path(mmap_path)
            p.parent.mkdir(parents=True, exist_ok=True)
            rho = np.lib.format.open_memmap(
                p, mode="w+", dtype=np.float32, shape=(self.N, self.N)
            )
        colmap = self._col_order
        for tiled, row0, col0, _nr, _nc, crc in self._blocks():
            f = (self.dir / f"tile_{row0:08d}_{col0:08d}.npy" if tiled
                 else self.dir / f"rows_{row0:08d}.npy")
            if crc is not None and checksum_file(f) != crc:
                raise IntegrityError(
                    f"{f}: content does not match the manifest checksum "
                    f"{crc} — the store is corrupt; remove the block and its "
                    "manifest entry and rerun to recompute it"
                )
            block = np.load(f)
            if not tiled:
                block = block[:, : self.N]
            nr, nc = block.shape
            if tiled and colmap is not None:
                rho[row0 : row0 + nr, colmap[col0 : col0 + nc]] = block
            else:
                rho[row0 : row0 + nr, col0 : col0 + nc] = block
        if mmap_path is not None:
            rho.flush()
            write_sidecar(p, checksum_file(p))
        return rho
