"""EDM dry run of the port: one chunk of the pipeline at a paper dataset's
own shape (Table I), measured on the card.

  PYTHONPATH=src python -m repro_torch.launch.edm_dryrun --dataset subject11
  PYTHONPATH=src python -m repro_torch.launch.edm_dryrun \\
      --dataset fish1_normo --chunks 2 --out build/dryrun

The JAX package's dry run compiles its chunk function for a TPU mesh and
reads memory and cost from XLA; PyTorch compiles nothing ahead, so here
the chunk runs.  Random series of the dataset's (N, L) are made on the
device from ``--seed``; the targets' futures stay there, in bucket
order, as in the untiled pipeline.  Then one warm-up chunk and
``--chunks`` timed chunks of ``lib_block`` library series each: phase 1
(simplex) for the chunk and bucketed phase 2 (CCM) of the chunk against
all N targets.  The targets' optE is drawn uniformly from [1, E_max]
(seeded), so every bucket is present: the most tables a chunk can need.

Reported, as the JAX dry run's JSON: peak device memory
(``torch.cuda.max_memory_allocated`` over the timed chunks, the resident
futures included: the counterpart of XLA's ``memory_analysis``), the
chunk's measured seconds, its analytical operations and bytes
(``launch/roofline.py``), the roofline terms per chunk and for the whole
run (x ``n_chunks``), and the whole run extrapolated from the measured
chunk.  Nothing is written to a store: Subject11's (N, N) map alone would
be 41 GB of host float32.  ``--out`` takes the JSON (default:
``build/dryrun/<dataset>.json``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch.configs.edm_datasets import DATASETS, EDMDatasetConfig
from repro_torch.core import ccm, simplex
from repro_torch.launch import roofline as RL
from repro_torch.runtime.device import card_line, resolve_device

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
#: series generated per device call while the futures are filled in
GEN_ROWS = 4096


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_data(ds: EDMDatasetConfig, dev: torch.device, seed: int, rows: int):
    """(library rows (rows, L), bucket-sorted futures (N, Lp), optE (N,),
    plan, order): standard-normal series made on ``dev``."""
    cfg = ds.edm
    N, L = ds.n_time_series, ds.n_time_steps
    optE = np.random.default_rng(seed).integers(1, cfg.E_max + 1, N).astype(np.int32)
    plan, order = ccm.make_bucket_plan(optE)
    sorted_pos = torch.as_tensor(np.argsort(order)).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    fut = torch.empty((N, cfg.n_points(L)), dtype=torch.float32, device=dev)
    lib = None
    for r0 in range(0, N, GEN_ROWS):
        x = torch.randn((min(GEN_ROWS, N - r0), L), generator=g, device=dev)
        fut[sorted_pos[r0 : r0 + x.shape[0]]] = ccm.all_futures(x, cfg)
        if lib is None:
            lib = x[:rows].clone()
        del x
    return lib, fut, optE, plan, order


def run_chunk(rows: torch.Tensor, fut_sorted: torch.Tensor, cfg, plan,
              inv: torch.Tensor) -> tuple[float, float, np.ndarray]:
    """(phase-1 s, phase-2 s, the chunk's rho rows in natural column
    order on the host), each phase ended by a synchronise."""
    dev = rows.device
    t0 = time.perf_counter()
    simplex.simplex_batch(rows, cfg)
    _sync(dev)
    t1 = time.perf_counter()
    rho = ccm.ccm_block_bucketed(rows, fut_sorted, cfg, plan)[:, inv].cpu().numpy()
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1, rho


def dryrun(ds: EDMDatasetConfig, device=None, chunks: int = 1,
           seed: int = 0) -> dict:
    """One dataset's dry run; the JSON-ready report."""
    if chunks < 1:
        raise ValueError(f"chunks={chunks} must be >= 1")
    dev = resolve_device(device)
    cfg = ds.edm
    S = cfg.lib_block
    N, L = ds.n_time_series, ds.n_time_steps
    Lp = cfg.n_points(L)
    if (chunks + 1) * S > min(N, GEN_ROWS):
        raise ValueError(f"{chunks} timed chunks of {S} rows (and a warm-up) "
                         f"need more than N={N} series")
    t0 = time.perf_counter()
    lib, fut, optE, plan, order = make_data(ds, dev, seed, (chunks + 1) * S)
    inv = torch.as_tensor(np.argsort(order)).to(dev)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    run_chunk(lib[:S], fut, cfg, plan, inv)  # warm-up: kernel builds, caches
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    p1 = p2 = 0.0
    finite = True
    for c in range(1, chunks + 1):
        a, b, rho = run_chunk(lib[c * S : (c + 1) * S], fut, cfg, plan, inv)
        p1, p2 = p1 + a, p2 + b
        finite = finite and rho.shape == (S, N) and bool(np.isfinite(rho).all())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    p1, p2 = p1 / chunks, p2 / chunks
    blocks = ccm.target_blocks(tuple(enumerate(plan.counts)), cfg.target_block)
    counts = RL.edm_chunk_counts(S, N, L, cfg.E_max, plan.buckets, blocks)
    rl = RL.roofline_of(counts)
    n_chunks = -(-N // S)
    return {
        "arch": f"edm-{ds.name.lower()}",
        "cell": f"ccm_N{N}_L{L}",
        "mesh": "1 card",
        "n_chips": 1,
        "device": str(dev),
        "card": card_line(dev),
        "seed": seed,
        "N": N, "L": L, "Lp": Lp, "E_max": cfg.E_max,
        "chunk_rows": S,
        "n_chunks": n_chunks,
        "target_block": cfg.target_block,
        "target_optE": "uniform on [1, E_max], seeded",
        "n_buckets": len(plan.buckets),
        "lookup_launches_per_chunk": len(blocks),
        "setup_s": setup_s,
        "chunks_timed": chunks,
        "chunk_s": {"phase1": p1, "phase2": p2, "total": p1 + p2},
        "rho_finite": finite,
        "memory": {
            "futures_bytes": fut.numel() * fut.element_size(),
            "peak_bytes_per_device": peak,
        },
        "counts": {k: {"flops": f, "bytes": b} for k, (f, b) in counts.items()},
        "roofline": rl.to_dict(),
        "roofline_whole_run": {
            "t_compute_s": rl.t_compute * n_chunks,
            "t_memory_s": rl.t_memory * n_chunks,
        },
        "whole_run_extrapolated_s": {
            "phase1": p1 * n_chunks, "phase2": p2 * n_chunks,
            "total": (p1 + p2) * n_chunks,
        },
        # the card's share of the H100 bound: not a CPU number
        "chunk_share_of_bound": (rl.t_bound / (p1 + p2) if dev.type == "cuda"
                                 else None),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", required=True, choices=sorted(DATASETS))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--chunks", type=int, default=1,
                    help="timed chunks after the warm-up one (default 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="JSON path (default build/dryrun/<dataset>.json)")
    args = ap.parse_args(argv)
    rep = dryrun(DATASETS[args.dataset], args.device, args.chunks, args.seed)
    out = pathlib.Path(args.out or REPO_ROOT / "build" / "dryrun"
                       / f"{args.dataset}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rep, indent=1))
    print(json.dumps(rep), flush=True)
    return rep


if __name__ == "__main__":
    main()
