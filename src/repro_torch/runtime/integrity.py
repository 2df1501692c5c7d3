"""Store integrity of the port: crc32 content checksums, ``.crc32``
sidecars, self-checksummed manifest shards, the run fingerprint, and
:func:`fsck_store` — the eager verification of a whole store from files
alone, which with ``heal=True`` revokes exactly the damaged units
(manifest entries and queue done markers) so one fleet pass recomputes
what was lost (``edm_fleet fsck [--heal]``).

The formats are those of ``repro.runtime.integrity``, so the JAX
package's ``edm_fleet fsck`` reads a store the port wrote, and the
port's reads one the JAX package wrote.  One
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

from repro_torch.runtime import telemetry

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


def read_sidecar(path: str | pathlib.Path) -> Optional[str]:
    try:
        return sidecar_path(path).read_text().strip() or None
    except OSError:
        return None


def verify_file(path: str | pathlib.Path) -> str:
    """"ok" | "corrupt" | "unverified" (no sidecar) | "missing"."""
    p = pathlib.Path(path)
    if not p.exists():
        return "missing"
    want = read_sidecar(p)
    if want is None:
        return "unverified"
    return "ok" if checksum_file(p) == want else "corrupt"


def load_npy_verified(path: str | pathlib.Path) -> np.ndarray:
    """np.load with lazy sidecar verification (the read-side integrity
    check for standalone artifacts like phase-1 optE)."""
    status = verify_file(path)
    if status == "corrupt":
        raise IntegrityError(
            f"{path}: content does not match its recorded checksum "
            f"(run `edm_fleet fsck --heal` on the store)"
        )
    return np.load(path)


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


# -------------------------------------------------------------------- fsck
#: tiled artifact dirs relative to the store root -> (stage whose units
#: cover its rows, downstream singleton stages stale after a heal).
TILED_ARTIFACTS = {
    ".": ("phase2", ("assemble", "finalize")),
    "rho_conv": ("sig", ("finalize",)),
    "rho_trend": ("sig", ("finalize",)),
    "pvals": ("sig", ("finalize",)),
}
#: assembled / standalone artifacts -> singleton stages to revoke on heal.
ASSEMBLED_ARTIFACTS = {
    "causal_map": ("assemble", "finalize"),
    "rho_conv": ("finalize",),
    "rho_trend": ("finalize",),
    "pvals": ("finalize",),
    "edges": ("finalize",),
}


def _tile_file(d: pathlib.Path, key: str) -> pathlib.Path:
    if "," in key:
        row0, col0 = (int(s) for s in key.split(","))
        return d / f"tile_{row0:08d}_{col0:08d}.npy"
    return d / f"rows_{int(key):08d}.npy"


def _entry_fields(val) -> tuple[int, Optional[int], Optional[str]]:
    """Manifest entry -> (nrows, ncols|None full-width, crc|None legacy)."""
    if isinstance(val, list):
        if len(val) >= 2 and isinstance(val[1], str):  # [nrows, crc] block
            return int(val[0]), None, val[1]
        nr = int(val[0])
        nc = int(val[1]) if len(val) > 1 else None
        crc = val[2] if len(val) > 2 else None
        return nr, nc, crc
    return int(val), None, None  # legacy bare-int row block


def _scan_tiled_dir(d: pathlib.Path) -> dict:
    """Verify one tiled artifact dir: every manifest entry's file exists,
    matches its recorded crc (or at least its recorded shape, for
    pre-checksum legacy entries), no orphans, no torn shards."""
    rep = {
        "entries": 0, "ok": 0, "unverified": 0,
        "missing": [], "corrupt": [], "orphaned": [], "torn_shards": [],
        "damaged_rows": [],  # (row0, nrows) spans needing recompute
    }
    entries: dict[str, object] = {}
    for shard in sorted(d.glob("blocks*.json")):
        if shard.suffix != ".json":
            continue
        parsed = read_manifest_shard(shard)
        if parsed is None:
            rep["torn_shards"].append(shard.name)
            # a torn shard's row spans are unknowable — every row this
            # artifact covers is suspect (heal revokes the whole stage;
            # still-covered rows are re-certified from the OTHER shards
            # by the fleet's coverage check, so only real losses recompute)
            rep["damaged_rows"].append((0, 1 << 62))
            continue
        entries.update(parsed)
    rep["entries"] = len(entries)
    for key, val in sorted(entries.items()):
        nr, nc, crc = _entry_fields(val)
        f = _tile_file(d, key)
        if not f.exists():
            rep["missing"].append(f.name)
            rep["damaged_rows"].append((int(key.split(",")[0]), nr))
            continue
        if crc is not None:
            good = checksum_file(f) == crc
        else:
            try:  # legacy entry: header-only shape check
                shape = np.load(f, mmap_mode="r").shape
                good = shape[0] == nr and (nc is None or shape[1] == nc)
            except ValueError:
                good = False
            if good:
                rep["unverified"] += 1
                continue
        if good:
            rep["ok"] += 1
        else:
            rep["corrupt"].append(f.name)
            rep["damaged_rows"].append((int(key.split(",")[0]), nr))
    known = {_tile_file(d, k).name for k in entries}
    for f in sorted(d.glob("tile_*.npy")) + sorted(d.glob("rows_*.npy")):
        if f.name not in known:
            rep["orphaned"].append(f.name)
    co = d / "col_order.npy"
    if co.exists() and verify_file(co) == "corrupt":
        rep["corrupt"].append(co.name)
        # col_order pins the layout of EVERY tile — all rows suspect
        rep["damaged_rows"].append((0, 1 << 62))
    return rep


def _scan_assembled(d: pathlib.Path) -> Optional[dict]:
    """Verify one assembled artifact dir (<d>/data.npy + meta.json)."""
    data, meta_f = d / "data.npy", d / "meta.json"
    if not d.exists() or not (data.exists() or meta_f.exists()):
        return None
    rep = {"status": verify_file(data)}
    if rep["status"] in ("ok", "unverified") and meta_f.exists():
        try:
            meta = json.loads(meta_f.read_text())
            shape = tuple(np.load(data, mmap_mode="r").shape)
            if tuple(meta.get("shape", shape)) != shape:
                rep["status"] = "corrupt"
                rep["detail"] = f"shape {shape} != meta {meta.get('shape')}"
        except ValueError:
            rep["status"] = "corrupt"
            rep["detail"] = "unparseable data.npy or meta.json"
    return rep


def _tmp_residue(out: pathlib.Path) -> list[pathlib.Path]:
    return [p for p in out.rglob("*.tmp-*") if p.is_file()]


def fsck_store(
    out_dir: str | pathlib.Path, heal: bool = False
) -> dict:
    """Eagerly verify a whole run store from files alone; optionally
    revoke whatever is damaged so the normal fleet recomputes it.

    The report is JSON-safe.  ``clean`` is True when nothing is missing,
    corrupt, orphaned, or fingerprint-stale (``unverified`` legacy
    artifacts do not dirty a store).  With ``heal=True`` the report
    gains a ``healed`` section; a corrupt DATASET is never healed (the
    inputs are not ours to recompute — the report flags it fatal).
    """
    out = pathlib.Path(out_dir)
    if not out.exists():
        raise FileNotFoundError(f"store {out} does not exist")
    report: dict = {"out": str(out), "artifacts": {}, "problems": 0}

    # ---- fingerprint / dataset ----------------------------------------
    spec = None
    spec_f = out / "fleet.json"
    if spec_f.exists():
        spec = json.loads(spec_f.read_text())
    fp_f = out / FINGERPRINT_NAME
    stamped = json.loads(fp_f.read_text()) if fp_f.exists() else {}
    want_crc = (spec or {}).get("dataset_crc32") or stamped.get("dataset_crc32")
    ds_path = (spec or {}).get("dataset")
    if ds_path is None and (out / "dataset" / "data.npy").exists():
        ds_path = out / "dataset"
    fp_rep = {"status": "unverified"}
    if ds_path is not None and pathlib.Path(ds_path, "data.npy").exists():
        data_f = pathlib.Path(ds_path) / "data.npy"
        fp_rep["dataset"] = str(ds_path)
        # float32 view matches what init_fleet/workers hash (no-copy when
        # the dataset is already float32, the normal case).
        have_crc = checksum_ndarray(
            np.asarray(np.load(data_f, mmap_mode="r"), np.float32))
        fp_rep["dataset_crc32"] = have_crc
        if want_crc is None:
            fp_rep["status"] = "unverified"  # pre-integrity store
        elif have_crc == want_crc:
            fp_rep["status"] = "ok"
        else:
            fp_rep["status"] = "stale"
            fp_rep["detail"] = (
                f"dataset content crc {have_crc} != recorded {want_crc}: "
                "the store's tiles were computed from different data "
                "(NOT healable — recompute into a fresh --out)"
            )
    elif ds_path is not None:
        fp_rep["status"] = "missing"
        fp_rep["dataset"] = str(ds_path)
    report["fingerprint"] = fp_rep

    # ---- tiled artifacts ----------------------------------------------
    damaged_units: dict[str, list[tuple[int, int]]] = {}
    stale_downstream: set[str] = set()
    for rel, (stage, downstream) in TILED_ARTIFACTS.items():
        d = out if rel == "." else out / rel
        if not d.exists() or not any(d.glob("blocks*.json")):
            continue
        rep = _scan_tiled_dir(d)
        name = "phase2" if rel == "." else rel
        report["artifacts"][name] = rep
        if rep["missing"] or rep["corrupt"] or rep["torn_shards"]:
            damaged_units.setdefault(stage, []).extend(rep["damaged_rows"])
            stale_downstream.update(downstream)
        report["problems"] += (
            len(rep["missing"]) + len(rep["corrupt"])
            + len(rep["orphaned"]) + len(rep["torn_shards"])
        )

    # ---- assembled / standalone artifacts ------------------------------
    for rel, downstream in ASSEMBLED_ARTIFACTS.items():
        rep = _scan_assembled(out / rel)
        if rep is None:
            continue
        key = rel if rel not in report["artifacts"] else rel + "/assembled"
        report["artifacts"][key] = rep
        if rep["status"] in ("corrupt", "missing"):
            stale_downstream.update(downstream)
            report["problems"] += 1

    p1 = out / "phase1"
    if p1.exists():
        statuses = {f: verify_file(p1 / f)
                    for f in ("optE.npy", "simplex_rho.npy")}
        bad = [f for f, s in statuses.items() if s in ("corrupt", "missing")]
        report["artifacts"]["phase1"] = {"files": statuses}
        if bad:
            damaged_units.setdefault("phase1", []).append((0, 1 << 62))
            report["problems"] += len(bad)

    tmp = _tmp_residue(out)
    report["tmp_residue"] = len(tmp)

    fatal = fp_rep["status"] == "stale"
    report["clean"] = report["problems"] == 0 and not fatal
    if not report["clean"]:
        telemetry.counter("store", "fsck_problems", float(report["problems"]),
                          fatal=fatal)
    if heal and not fatal:
        report["healed"] = _heal(out, spec, report, damaged_units,
                                 stale_downstream, tmp)
    elif heal:
        report["healed"] = {"refused": fp_rep.get("detail", "stale fingerprint")}
    return report


def _heal(
    out: pathlib.Path,
    spec: Optional[dict],
    report: dict,
    damaged_units: dict[str, list[tuple[int, int]]],
    stale_downstream: set[str],
    tmp: list[pathlib.Path],
) -> dict:
    """Revoke exactly the damaged state: drop manifest entries for
    missing/corrupt tiles, delete corrupt/orphaned files, and clear the
    queue done markers of every unit whose rows are no longer covered —
    the normal fleet then recomputes precisely those units (bit-identical
    by DESIGN.md SS10), and a follow-up fsck is clean."""
    from repro_torch.data.store import atomic_write_text  # lazy: no cycle

    healed = {"files_deleted": [], "entries_revoked": 0,
              "done_revoked": [], "tmp_removed": len(tmp)}
    for p in tmp:
        p.unlink(missing_ok=True)

    for rel in TILED_ARTIFACTS:
        name = "phase2" if rel == "." else rel
        rep = report["artifacts"].get(name)
        if rep is None:
            continue
        d = out if rel == "." else out / rel
        bad_files = set(rep["missing"]) | set(rep["corrupt"]) \
            | set(rep["orphaned"])
        for fname in set(rep["corrupt"]) | set(rep["orphaned"]):
            f = d / fname
            if f.exists():
                f.unlink()
                healed["files_deleted"].append(str(f.relative_to(out)))
            sc = sidecar_path(f)
            if sc.exists():
                sc.unlink()
        for shard in sorted(d.glob("blocks*.json")):
            if shard.suffix != ".json":
                continue
            parsed = read_manifest_shard(shard)
            if parsed is None:  # torn/corrupt shard: drop it whole
                shard.unlink()
                healed["files_deleted"].append(str(shard.relative_to(out)))
                continue
            keep = {k: v for k, v in parsed.items()
                    if _tile_file(d, k).name not in bad_files}
            if len(keep) != len(parsed):
                healed["entries_revoked"] += len(parsed) - len(keep)
                atomic_write_text(shard, manifest_with_crc(keep))
        if (d / "col_order.npy").name in rep["corrupt"]:
            (d / "col_order.npy").unlink(missing_ok=True)

    # Assembled artifacts: delete corrupt/half-gone ones WHOLE (data +
    # sidecar + meta) so the store reads as "not yet assembled" — clean
    # but incomplete — and the idempotent assemble/finalize stages
    # rebuild them from the (now healed) tiles.
    for rel in ASSEMBLED_ARTIFACTS:
        for key in (rel, rel + "/assembled"):
            rep = report["artifacts"].get(key)
            if rep is not None and isinstance(rep, dict) \
                    and rep.get("status") in ("corrupt", "missing"):
                f = out / rel / "data.npy"
                f.unlink(missing_ok=True)
                sidecar_path(f).unlink(missing_ok=True)
                (out / rel / "meta.json").unlink(missing_ok=True)
                healed["files_deleted"].append(str(f.relative_to(out)))
    p1rep = report["artifacts"].get("phase1", {}).get("files", {})
    for fname, status in p1rep.items():
        if status == "corrupt":
            (out / "phase1" / fname).unlink(missing_ok=True)
            sidecar_path(out / "phase1" / fname).unlink(missing_ok=True)
            healed["files_deleted"].append(f"phase1/{fname}")
    if any(s in ("corrupt", "missing") for s in p1rep.values()):
        # optE.npy is the phase-1 completion witness — dropping any
        # phase-1 file without it would leave a witnessed-but-partial
        # stage, so drop the witness too.
        (out / "phase1" / "optE.npy").unlink(missing_ok=True)

    # Queue done markers: a fleet store's durable "skip this unit"
    # records must not outlive the artifacts they certify.
    qdir = out / "queue"
    if spec is not None and qdir.exists():
        from repro_torch.runtime.workqueue import plan_units

        N, unit_rows = int(spec["N"]), int(spec["unit_rows"])
        revoke: set[str] = set(stale_downstream)
        for stage, spans in damaged_units.items():
            for u in plan_units(stage, N, unit_rows):
                if any(u.row0 < r0 + nr and r0 < u.row0 + u.nrows
                       for r0, nr in spans):
                    revoke.add(u.uid)
        if "assemble" in stale_downstream or "phase1" in damaged_units \
                or damaged_units:
            revoke.add("assemble")
            if (qdir / "finalize.done").exists():
                revoke.add("finalize")
        for uid in sorted(revoke):
            for suffix in (".done", ".fail", ".poison", ".lease"):
                f = qdir / (uid + suffix)
                if f.exists():
                    f.unlink()
                    if suffix == ".done":
                        healed["done_revoked"].append(uid)
    telemetry.counter(
        "store", "fsck_healed",
        float(healed["entries_revoked"] + len(healed["files_deleted"])),
        done_revoked=len(healed["done_revoked"]),
    )
    return healed


def render_fsck(report: dict) -> str:
    verdict = ("CLEAN" if report["clean"]
               else f"{report['problems']} problem(s)" if report["problems"]
               else "NOT CLEAN (stale fingerprint)")
    lines = [f"fsck {report['out']}: {verdict}"]
    fp = report["fingerprint"]
    lines.append(f"fingerprint: {fp['status']}"
                 + (f" — {fp['detail']}" if "detail" in fp else ""))
    for name, rep in report["artifacts"].items():
        if "entries" in rep:
            parts = [f"{rep['ok']} ok"]
            if rep["unverified"]:
                parts.append(f"{rep['unverified']} unverified(legacy)")
            for k in ("missing", "corrupt", "orphaned", "torn_shards"):
                if rep[k]:
                    parts.append(f"{len(rep[k])} {k}: "
                                 + ", ".join(rep[k][:4])
                                 + ("…" if len(rep[k]) > 4 else ""))
            lines.append(f"  {name:<12} {rep['entries']} tiles — "
                         + "; ".join(parts))
        elif "files" in rep:
            lines.append(f"  {name:<12} " + ", ".join(
                f"{f}:{s}" for f, s in rep["files"].items()))
        else:
            lines.append(f"  {name:<12} {rep['status']}"
                         + (f" — {rep['detail']}" if "detail" in rep else ""))
    if report.get("tmp_residue"):
        lines.append(f"  tmp residue: {report['tmp_residue']} file(s)")
    if "healed" in report:
        h = report["healed"]
        if "refused" in h:
            lines.append(f"heal REFUSED: {h['refused']}")
        else:
            lines.append(
                f"healed: {h['entries_revoked']} manifest entr(ies) revoked, "
                f"{len(h['files_deleted'])} file(s) deleted, "
                f"{len(h['done_revoked'])} done marker(s) revoked, "
                f"{h['tmp_removed']} tmp file(s) removed — rerun the fleet "
                "to recompute"
            )
    return "\n".join(lines)
