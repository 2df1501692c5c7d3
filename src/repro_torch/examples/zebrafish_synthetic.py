"""End-to-end example: the paper's workflow on a synthetic 'brain'.

    PYTHONPATH=src python -m repro_torch.examples.zebrafish_synthetic \\
        [--neurons 48] [--device cpu]

1. Generate a sparse directed network of coupled logistic neurons with a
   known ground-truth adjacency, the stand-in for the light-sheet
   recordings of the paper's Table I.
2. Store it in the zarr-lite dataset format.
3. Run the causal-inference pipeline (simplex projection -> optimal E
   per neuron -> all-to-all CCM), streaming row blocks to the store with
   resume support (kill it and re-invoke with the same --out: it
   continues from the last completed block).
4. Score the causal map against the ground truth (edge-recovery AUC).
5. Cut the rho map into a significance-masked graph (convergence CCM,
   phase-randomized surrogate nulls, BH-FDR) and score its edges.

Runs on the card, or with ``--device cpu`` on the CPU.
"""
import argparse
import pathlib
import tempfile
import time

import numpy as np

from repro_torch.core.pipeline import run_causal_inference
from repro_torch.core.types import EDMConfig
from repro_torch.data import store
from repro_torch.data.synthetic import logistic_network
from repro_torch.inference import SignificanceConfig, run_significance


def edge_auc(rho: np.ndarray, adj: np.ndarray) -> float:
    """AUC of rho[dst, src]-ranked edges src -> dst against adj (ties
    broken by position, as a rank of a stable argsort)."""
    r = rho.T  # r[src, dst]: the skill of src's influence on dst
    mask = ~np.eye(adj.shape[0], dtype=bool)
    pos, neg = r[adj], r[(~adj) & mask]
    order = np.concatenate([pos, neg]).argsort().argsort()
    return float((order[: len(pos)].mean() + 1 - (len(pos) + 1) / 2) / len(neg))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--neurons", type=int, default=48)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--out", default=None)
    ap.add_argument("--surrogates", type=int, default=99)
    ap.add_argument("--fdr", type=float, default=0.1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    out = args.out or tempfile.mkdtemp(prefix="zebrafish_")
    print(f"[1/5] generating {args.neurons}-neuron synthetic brain "
          f"({args.steps} steps @ 2 Hz equivalent)")
    ts, adj = logistic_network(args.neurons, args.steps, density=0.12,
                               strength=0.3, seed=7)
    store.save_dataset(pathlib.Path(out) / "recording", ts,
                       {"species": "synthetic zebrafish", "hz": 2})

    print(f"[2/5] running causal inference pipeline on {args.device} -> {out}")
    cfg = EDMConfig(E_max=8)
    t0 = time.time()
    result = run_causal_inference(ts, cfg, device=args.device,
                                  out_dir=str(pathlib.Path(out) / "causal_map"),
                                  progress=True)
    dt = time.time() - t0
    n = args.neurons
    print(f"[3/5] {n}x{n} causal map in {dt:.1f}s ({n * n / dt:.0f} "
          f"cross-maps/s); mean optimal E = {result.optE.mean():.1f}")

    rho = np.array(result.rho)
    auc = edge_auc(rho, adj)
    print(f"[4/5] edge-recovery AUC = {auc:.3f} (true-edge mean rho "
          f"{rho.T[adj].mean():.3f} vs non-edge "
          f"{rho.T[(~adj) & ~np.eye(n, dtype=bool)].mean():.3f})")

    Lp = cfg.n_points(ts.shape[1])
    # an ascending, distinct grid for any --steps: fixed small sizes
    # strictly below the near-full top size
    lib_sizes = tuple(s for s in (40, 100, 250) if s < Lp - 20) + (Lp - 20,)
    sig = SignificanceConfig(lib_sizes=lib_sizes, n_surrogates=args.surrogates,
                             alpha=args.fdr, surrogate="phase", seed=7)
    t0 = time.time()
    graph = run_significance(ts, np.asarray(result.optE), rho, cfg, sig,
                             device=args.device, out_dir=out, progress=False)
    e = graph.edges
    hits = adj[e["src"], e["dst"]]
    n_true = int(adj.sum())
    prec = hits.mean() if len(e) else float("nan")
    print(f"[5/5] significance-masked graph in {time.time() - t0:.1f}s: "
          f"{len(e)} edges at FDR {args.fdr} ({args.surrogates} phase "
          f"surrogates, p* = {graph.p_threshold:.4g}); precision {prec:.2f}, "
          f"recall {hits.sum() / n_true:.2f} vs {n_true} true edges -> "
          f"{out}/edges")
    return {"ts": ts, "adj": adj, "rho": rho, "optE": np.asarray(result.optE),
            "auc": auc, "edges": len(e), "out": out}


if __name__ == "__main__":
    main()
