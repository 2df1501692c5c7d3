"""The dry-run tables of the port, from the JSONs of ``launch/dryrun.py``
(and the EDM rows from ``launch/edm_dryrun.py``'s):

  PYTHONPATH=src python -m repro_torch.bench.make_experiments [--dir build/dryrun] > tables.md

The counterpart of the JAX package's ``benchmarks/make_experiments.py``:
the baseline table of each production mesh (16 x 16 and 2 x 16 x 16),
the baseline against the optimized configs at 16 x 16, and the EDM dry
run's rows (one card, measured).  The LM terms are the H100 model's of
``launch/roofline.py`` (bf16 or fp32 peak, HBM, NVLink inside a node and
InfiniBand across nodes by mesh axis), from fake-tensor runs: bounds, not
measurements.  A cell whose JSON is missing is left out; a skipped or
failed one is listed with its reason.
"""
from __future__ import annotations

import argparse
import json
import pathlib

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
DRY = REPO_ROOT / "build" / "dryrun"

ARCH_ORDER = [
    "llama-3.2-vision-11b", "zamba2-7b", "whisper-medium", "qwen2-1.5b",
    "minicpm-2b", "smollm-135m", "qwen2.5-3b", "mamba2-2.7b", "dbrx-132b",
    "grok-1-314b",
]
CELLS = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
EDM = ["edm-fish1_normo", "edm-subject6", "edm-subject11"]


def load_all(d: pathlib.Path) -> dict:
    """{(arch, cell, mesh, optimized): result} of every JSON in ``d``; an EDM
    result under (arch, "", "1 card", False)."""
    out = {}
    for p in sorted(pathlib.Path(d).glob("*.json")):
        try:
            r = json.loads(p.read_text())
        except (OSError, ValueError):
            continue
        if not isinstance(r, dict) or "arch" not in r:
            continue
        if r["arch"].startswith("edm-"):
            out[(r["arch"], "", "1 card", False)] = r
            continue
        opt = r.get("variant") == "optimized" or p.name.endswith("__opt.json")
        out[(r["arch"], r.get("cell"), r.get("mesh"), opt)] = r
    return out


def fmt_bytes(b) -> str:
    return "not measured" if b is None else f"{b / 2**30:.2f}"


def improvement_hint(r: dict) -> str:
    rl = r["roofline"]
    bn = rl["bottleneck"]
    if bn == "memory":
        return "cut materialized activation slabs (chunked attention / fused kernels)"
    if bn == "collective":
        kinds = rl["coll_by_kind"]
        top = max(kinds, key=kinds.get)
        return f"reduce {top} traffic (sharding layout / compression)"
    return "already compute-bound: raise MFU via larger per-chip tiles"


def _t_max(r: dict) -> float:
    rl = r["roofline"]
    return max(rl["t_compute_s"], rl["t_memory_s"], rl.get("t_collective_s", 0.0))


def table(res: dict, mesh: str) -> str:
    rows = [
        "| arch | cell | t_comp (s) | t_mem (s) | t_coll (s) | bottleneck | "
        "roofline frac | peak GiB/dev | model/counted flops | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for cell in CELLS:
            r = res.get((arch, cell, mesh, False))
            if r is None:
                continue
            if "skipped" in r or "failed" in r:
                why = r.get("skipped") or f"FAILED: {r['failed']}"
                rows.append(f"| {arch} | {cell} | — | — | — | "
                            f"{'SKIP' if 'skipped' in r else 'FAIL'} | — | — | — | {why} |")
                continue
            rl = r["roofline"]
            rows.append(
                f"| {arch} | {cell} | {rl['t_compute_s']:.4f} | {rl['t_memory_s']:.4f} | "
                f"{rl['t_collective_s']:.4f} | {rl['bottleneck']} | "
                f"{rl['roofline_fraction']:.3f} | "
                f"{fmt_bytes(r['memory']['peak_bytes_per_device'])} | "
                f"{r.get('useful_flops_ratio', 0.0):.3f} | {improvement_hint(r)} |")
    return "\n".join(rows)


def opt_table(res: dict, mesh: str) -> str:
    """Baseline against the optimized configs, per cell (step = the
    largest term)."""
    rows = [
        "| arch | cell | baseline step (s) | optimized step (s) | speedup | "
        "peak GiB base→opt | bottleneck base→opt |",
        "|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for cell in CELLS:
            b = res.get((arch, cell, mesh, False))
            o = res.get((arch, cell, mesh, True))
            if not b or not o or any(k in x for x in (b, o) for k in ("skipped", "failed")):
                continue
            tb, to = _t_max(b), _t_max(o)
            rows.append(
                f"| {arch} | {cell} | {tb:.4f} | {to:.4f} | **{tb / max(to, 1e-9):.1f}×** | "
                f"{fmt_bytes(b['memory']['peak_bytes_per_device'])}→"
                f"{fmt_bytes(o['memory']['peak_bytes_per_device'])} | "
                f"{b['roofline']['bottleneck']}→{o['roofline']['bottleneck']} |")
    return "\n".join(rows)


def edm_table(res: dict) -> str:
    rows = [
        "| dataset | cell | chunk s (measured) | t_comp (s) | t_mem (s) | bottleneck | "
        "share of bound | peak GiB | card |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in EDM:
        r = res.get((arch, "", "1 card", False))
        if r is None:
            continue
        rl = r["roofline"]
        share = r.get("chunk_share_of_bound")
        rows.append(
            f"| {arch} | {r['cell']} | {r['chunk_s']['total']:.4f} | "
            f"{rl['t_compute_s']:.6f} | {rl['t_memory_s']:.6f} | {rl['bottleneck']} | "
            f"{'not measured' if share is None else f'{share:.4f}'} | "
            f"{fmt_bytes(r['memory']['peak_bytes_per_device'])} | {r.get('card')} |")
    return "\n".join(rows)


def render(d: pathlib.Path) -> str:
    res = load_all(d)
    return "\n".join([
        "## Single-pod mesh 16x16 (256 cards) — baseline\n", table(res, "16x16"),
        "\n## Multi-pod mesh 2x16x16 (512 cards) — baseline\n", table(res, "2x16x16"),
        "\n## Baseline vs optimized (16x16)\n", opt_table(res, "16x16"),
        "\n## EDM dry run (one card, one chunk measured)\n", edm_table(res),
    ])


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=str(DRY), help="the dry-run JSONs (default build/dryrun)")
    args = ap.parse_args(argv)
    text = render(pathlib.Path(args.dir))
    print(text)
    return text


if __name__ == "__main__":
    main()
