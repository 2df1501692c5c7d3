"""Store integrity, the subset the port's main path needs: crc32 content
checksums, ``.crc32`` sidecars, self-checksummed manifest shards, and
the run fingerprint.

The formats are those of ``repro.runtime.integrity``, so the JAX
package's ``edm_fleet fsck`` reads a store the port wrote.  One
deliberate difference: the port adds ``"framework": "torch"`` to the
config it hashes into the fingerprint, so a port run never stamps a JAX
run's fingerprint and can never resume into (and mix tiles with) a JAX
store, or the other way round.  The two frameworks agree within a
tolerance, not to the byte.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import zlib
from typing import Optional

import numpy as np

#: value of the ``framework`` key hashed into every port fingerprint
FRAMEWORK = "torch"
FINGERPRINT_NAME = "fingerprint.json"


class IntegrityError(RuntimeError):
    """A store artifact failed its recorded checksum, or a fingerprint
    mismatch: the bytes on disk are not the bytes this run would write."""


class Crc32:
    """Incremental crc32 with the store's hex rendering; ``write`` tees
    np.save's output stream."""

    def __init__(self, inner=None):
        self.value = 0
        self._inner = inner

    def write(self, data) -> int:
        self.value = zlib.crc32(data, self.value)
        return self._inner.write(data) if self._inner is not None else len(data)

    def update(self, data) -> "Crc32":
        self.value = zlib.crc32(data, self.value)
        return self

    @property
    def hex(self) -> str:
        return f"{self.value & 0xFFFFFFFF:08x}"


def checksum_bytes(data: bytes) -> str:
    return Crc32().update(data).hex


def checksum_file(path: str | pathlib.Path, bufsize: int = 1 << 20) -> str:
    c = Crc32()
    with open(path, "rb") as f:
        while True:
            buf = f.read(bufsize)
            if not buf:
                return c.hex
            c.update(buf)


def checksum_ndarray(a: np.ndarray, rows_per_step: int = 4096) -> str:
    """crc32 over an array's raw C-order bytes, in row slabs."""
    c = Crc32()
    if a.ndim == 0 or a.shape[0] == 0:
        return c.update(np.ascontiguousarray(a).tobytes()).hex
    for r in range(0, a.shape[0], rows_per_step):
        c.update(np.ascontiguousarray(a[r : r + rows_per_step]).tobytes())
    return c.hex


def sidecar_path(path: str | pathlib.Path) -> pathlib.Path:
    p = pathlib.Path(path)
    return p.parent / (p.name + ".crc32")


def write_sidecar(path: str | pathlib.Path, crc: str) -> None:
    """Record a file's checksum beside it, after the file itself."""
    from repro_torch.data.store import atomic_write_text  # lazy: no cycle

    atomic_write_text(sidecar_path(path), crc + "\n")


def read_manifest_shard(path: pathlib.Path) -> Optional[dict]:
    """Parse a blocks*.json shard, verifying its embedded ``__crc__``.
    None = torn or corrupt."""
    try:
        raw = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    want = raw.pop("__crc__", None)
    if want is not None:
        if checksum_bytes(json.dumps(raw, sort_keys=True).encode()) != want:
            return None
    return raw


def manifest_with_crc(entries: dict) -> str:
    """Serialize a manifest shard with its self-checksum embedded."""
    crc = checksum_bytes(json.dumps(entries, sort_keys=True).encode())
    return json.dumps({"__crc__": crc, **entries})


def run_fingerprint(dataset_crc: str, shape, dtype, cfg_dict: dict) -> str:
    """sha256 over the canonical JSON of (dataset content, config).
    Geometry knobs that never change the bytes are canonicalized out, as
    in the JAX package."""
    cfg = dict(cfg_dict)
    for knob in ("lib_block", "target_tile", "knn_tile_c", "stream_depth",
                 "engine"):
        cfg.pop(knob, None)
    canon = json.dumps(
        {"dataset_crc32": dataset_crc, "shape": list(shape),
         "dtype": str(dtype), "cfg": cfg},
        sort_keys=True,
    )
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def fingerprint_of(ts: np.ndarray, cfg) -> dict:
    """The full stamp of a port run over in-memory series ``ts``; the
    hashed config carries ``"framework": "torch"``."""
    cfg_dict = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) \
        else dict(cfg)
    cfg_dict["framework"] = FRAMEWORK
    crc = checksum_ndarray(np.ascontiguousarray(ts))
    return {
        "fingerprint": run_fingerprint(crc, ts.shape, ts.dtype, cfg_dict),
        "dataset_crc32": crc,
        "shape": list(ts.shape),
        "dtype": str(ts.dtype),
        "framework": FRAMEWORK,
    }


def stamp_fingerprint(out_dir: str | pathlib.Path, fp: dict) -> None:
    """Write (first run) or verify (resume) the store's fingerprint; a
    mismatch refuses the run."""
    from repro_torch.data.store import atomic_write_text  # lazy: no cycle

    f = pathlib.Path(out_dir) / FINGERPRINT_NAME
    if f.exists():
        try:
            have = json.loads(f.read_text())
        except ValueError:
            have = {}
        if have.get("fingerprint") != fp["fingerprint"]:
            raise IntegrityError(
                f"run fingerprint mismatch in {out_dir}: store holds "
                f"{have.get('fingerprint')} (framework "
                f"{have.get('framework', 'jax')}, dataset crc "
                f"{have.get('dataset_crc32')}, shape {have.get('shape')}) but "
                f"this run derives {fp['fingerprint']} (framework "
                f"{fp['framework']}, dataset crc {fp['dataset_crc32']}, shape "
                f"{fp['shape']}); the store was written from different data, "
                "a different config or the other framework — use a fresh "
                "--out dir"
            )
        return
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    atomic_write_text(f, json.dumps(fp, sort_keys=True))
