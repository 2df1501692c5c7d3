"""Oracle check of the port's engines: every engine op against the
``torch-reference`` engine (the engine-layer contract of the JAX
package's ``repro.engine.check``, with its tolerances and ops).

    PYTHONPATH=src python -m repro_torch.engine.check    # every engine, the card
    PYTHONPATH=src python -m repro_torch.engine.check --engine cuda
    PYTHONPATH=src python -m repro_torch.engine.check --device cpu

Random EDM-shaped inputs (a batch of series, as the port's ops take
them), max-abs deviation per op, a hard failure past each op's
tolerance: kNN indices must match exactly, the prefix tables bit for
bit, distances and lookups to float32 round-off.  Both engines run on
one device; the card by default, and without one the check raises
(``device="cpu"`` runs the ``cuda`` engine's wrappers on their plain
versions).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import knn
from repro_torch.core.types import EDMConfig
from repro_torch.engine import available_engines, get_engine
from repro_torch.runtime.device import resolve_device

REFERENCE = "torch-reference"

# op name -> atol on values (the JAX package's); kNN indices are
# compared exactly.
TOLERANCES = {
    "knn_tables": 1e-5,
    "knn_tables_bucketed": 1e-5,
    "knn_tables_prefix": 0.0,  # one sweep vs the plain sweep: bit for bit
    "ccm_lookup": 1e-5,
}


def check_engine(
    name: str,
    E_max: int = 6,
    Lq: int = 120,
    Lc: int = 120,
    n_targets: int = 7,
    seed: int = 0,
    cfg: EDMConfig | None = None,
    device=None,
    series: int = 2,
) -> dict[str, float]:
    """Run every op of engine ``name`` against ``torch-reference`` on
    ``device`` (default the card) over ``series`` random series.

    Returns {op: max_abs_err}; raises AssertionError on any index
    mismatch or tolerance violation."""
    cfg = cfg or EDMConfig(E_max=E_max, engine=name)
    dev = resolve_device(device)
    ref, eng = get_engine(REFERENCE), get_engine(name)
    eng.check_limits(cfg, dev)
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device=dev)

    Vq = rand(series, E_max, Lq)
    Vc = Vq if Lq == Lc else rand(series, E_max, Lc)
    k = E_max + 1
    exclude = Lq == Lc
    errs: dict[str, float] = {}

    def cmp(op, got, want):
        gi, gd = (t.cpu().numpy() for t in got)
        wi, wd = (t.cpu().numpy() for t in want)
        np.testing.assert_array_equal(gi, wi, err_msg=f"{name}.{op}: indices")
        err = float(np.max(np.abs(gd - wd))) if gd.size else 0.0
        if not err <= TOLERANCES[op]:  # NaN fails too
            raise AssertionError(f"{name}.{op}: max err {err} > {TOLERANCES[op]}")
        errs[op] = err
        return got

    cmp("knn_tables",
        eng.knn_tables(Vq, Vc, k, exclude_self=exclude, cfg=cfg),
        ref.knn_tables(Vq, Vc, k, exclude_self=exclude, cfg=cfg))

    buckets = tuple(sorted({1, max(1, E_max // 2), E_max}))
    idx, sqd = cmp(
        "knn_tables_bucketed",
        eng.knn_tables_bucketed(Vq, Vc, k, buckets=buckets, exclude_self=exclude,
                                cfg=cfg),
        ref.knn_tables_bucketed(Vq, Vc, k, buckets=buckets, exclude_self=exclude,
                                cfg=cfg))

    # the significance path's sweep: a permutation of the candidates
    lib_sizes = tuple(sorted({max(k + 2, Lc // 4), max(k + 3, Lc // 2), Lc}))
    col_ids = torch.as_tensor(rng.permutation(Lc), dtype=torch.int32, device=dev)
    cmp("knn_tables_prefix",
        eng.knn_tables_prefix(Vq, Vc, k, buckets=buckets, lib_sizes=lib_sizes,
                              exclude_self=exclude, cfg=cfg, col_ids=col_ids),
        ref.knn_tables_prefix(Vq, Vc, k, buckets=buckets, lib_sizes=lib_sizes,
                              exclude_self=exclude, cfg=cfg, col_ids=col_ids))

    # every bucket's table serves a segment of the targets
    idx, w = knn.tables_with_weights_bucketed(idx, sqd, buckets)
    Y = rand(n_targets, Lc)
    cuts = np.linspace(0, n_targets, len(buckets) + 1).astype(int)
    segs = tuple((b, int(cuts[b + 1] - cuts[b])) for b in range(len(buckets)))
    got = eng.ccm_lookup(idx, w, Y, segs).cpu().numpy()
    want = ref.ccm_lookup(idx, w, Y, segs).cpu().numpy()
    err = float(np.max(np.abs(got - want)))
    if not err <= TOLERANCES["ccm_lookup"]:
        raise AssertionError(f"{name}.ccm_lookup: max err {err} > "
                             f"{TOLERANCES['ccm_lookup']}")
    errs["ccm_lookup"] = err
    return errs


def main(argv=None) -> dict[str, dict[str, float]]:
    ap = argparse.ArgumentParser(prog="repro_torch.engine.check",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--engine", choices=available_engines(), default=None,
                    help="the engine to check (default: every engine)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda (default; exits with an error without a card) "
                    "or cpu")
    args = ap.parse_args(argv)
    out = {}
    for name in [args.engine] if args.engine else available_engines():
        out[name] = errs = check_engine(name, device=args.device)
        print(name, {k: f"{v:.2e}" for k, v in errs.items()}, flush=True)
    return out


if __name__ == "__main__":
    main()
