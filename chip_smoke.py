#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from the sources in the checkout.  First
the LM serving path: the flash-attention kernel against its plain
version and timed, qwen2.5-3b at full width (random init) served through
``repro_torch.launch.steps`` — four prompts of 2048 tokens through
``make_prefill_step`` (the flash launch count set to 0 just before it),
32 greedy decode steps — and the float32 gate of the kernel route
against the plain route.  Then it holds each EDM kernel against its
plain PyTorch version on the card at the shapes of the paths that run
it, drives two paths of ``repro_torch.launch.edm_run`` at
the series length and E_max of the paper's Fish1_Normo recording — the
main path (the causal map) and the significance path (map, convergence
statistics, surrogate p-values and BH-FDR edges) — and then each again
in column tiles (``--target-tile``: the tiled map and store byte for
byte the untiled ones, with peak device memory beside them), the all-E
phase 2 (``--no-bucketed``, untiled and tiled) and the map with the
bfloat16 distance accumulator — each path with the kernel launch counts
set to 0 just before it and read just after, checks them against the
plain-version engine, and times every kernel (both accumulators of the
kNN kernels) with CUDA events beside its bound, its plain version and
(where one exists) one PyTorch library call computing the same
function.

Before the fleet, the kNN selection bench's path: the slab kernel
(``kernels/knn_slab``, the port of the bench's dense-slab Pallas kernel)
against its plain version bit for bit (ragged Lq and Lc, both
``exclude_self`` settings, tied and constant series, k above the valid
candidates with its 3.0e38 entries, k 64) and against ``knn_topk``
where k fits; phase ``bench_knn``, the port's ``knn`` bench
(``repro_torch.bench.run``) at Lq 128, E_max 20, k 21 and Lc up to
64,000 on both engines, every launch count set to 0 just before it, with
each kernel's CUDA-event time beside the slab's plain version and bound;
and phase ``dryrun``, ``repro_torch.launch.edm_dryrun`` for Fish1_Normo
and Subject11 at their own N and L (one chunk each: peak device memory,
seconds, roofline terms, the whole run extrapolated; JSONs in
``build/dryrun/``).

Last, the fleet (``edm_run --workers``, ``launch/edm_fleet.py``): W
worker processes share the card, each with its own CUDA context (the
card's compute mode is printed; what this process holds on the card is
released first).  Phases ``fleet_main`` (the main path with two
workers, its map byte-equal to the single-process map of
``end_to_end``, the card's busy share sampled beside the single
process's), ``fleet_significance`` (two workers at the significance
path's N, all five artifacts byte-equal to the single-process store),
``fleet_kill`` (three workers, units of 5 rows, ``w0`` SIGKILLed once a
block is durable and relaunched under its id) and ``fleet_faults``
(``--workers 3 --unit-rows 5`` with ``EDM_FAULTS=tile_pre_rename:crash@2``
armed in every first-generation worker; the supervisor relaunches each
without it): each store byte-equal to the single-process one, complete
by ``edm_fleet status``, clean by ``fsck``, no lease left.  The launch
counts are per process: each worker's last line carries its own, and
the summed counts must equal the single-process ones where no process
died; each worker's phase-2 seconds and peak device memory are printed
beside them.  The kernels line's ``launches_fleet`` holds each run's sum,
the kill and fault runs' under ``kill_survivors`` / ``faults_survivors``:
the sums of the processes that finished, since one that was killed or
crashed prints no done line.  The fleets' logs go to ``build/smoke_fleet_logs/``.

Every phase prints one JSON line; the line before the last is the card's
name and power limit as nvidia-smi gives them, the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
so does a machine without a CUDA card, or a directory holding this file
and nothing else of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# Fish1_Normo (the paper's smallest recording): L = 1450, E_max = 20.
FISH1_L, E_MAX = 1450, 20
# Subject11: the paper's longest library, L = 8528.
SUBJECT11_L = 8528
LIB_BLOCK = 8
TARGET_BLOCK = 2048
CHECK_N = 256  # series of the cuda vs torch-reference engine checks
PROFILE_N = 512  # series of the profiled runs of both paths
# The significance path: the repo's default library sizes up to Lp = 1430
# and surrogate count, the surrogates' null model and the FDR level.
SIG_LIB_SIZES = (100, 200, 400, 800, 1430)
SIG_M, SIG_CHECK_M = 20, 9
NEAR_TIE = 1e-6  # |difference| below which a comparison may round either way
# The tiled and all-E phase 2 and the tiled significance stage: the main
# path's map again in column tiles of 4,096 targets; the all-E layout
# (--no-bucketed) at N = 2,048, untiled and in tiles of 512; the
# significance path in tiles of 512; the bfloat16 accumulator's map at
# N = 2,048.  Subject11: N = 101,729 series.
MAIN_TILE, SIG_TILE = 4096, 512
ALL_E_N, ALL_E_TILE, BF16_N = 2048, 512, 2048
SUBJECT11_N = 101729

# The LM serving path: qwen2.5-3b at full width (36 layers, d 2048, 16 / 2
# heads of 128, d_ff 11008, vocab 151,936 padded to 152,064), random
# init; four requests of 2048 prompt tokens, 32 greedy decode steps.
LM_ARCH = "qwen2.5-3b"
SERVE_B, SERVE_S, DECODE_STEPS = 4, 2048, 32
# Flash kernel vs its plain version.  float32 (the CUDA-core route),
# |got - want| <= atol + rtol |want|: sums in another order (softmax over
# up to 2048 keys).  bfloat16 on the CUDA-core route: within one bf16 step
# of the plain version's bf16 output, |got - want| <= 1e-6 + 2^-7 |want|.
# bfloat16 on the tensor-core route: it rounds p to bf16 before p v, as
# every such kernel does, so it is held to the plain version's float32
# result (before its final rounding): its max abs error within twice that
# of one library call (F.scaled_dot_product_attention) on the same inputs
# and within an absolute ceiling for unit-normal inputs; and element by
# element within one bf16 step of |want| plus twice the library's max abs
# error in the same (batch, query, head) row, so that a row with a small
# output (late causal rows, ~2048 keys) is held to its own error level.
FLASH_TOL_F32 = (2e-5, 2e-5)
FLASH_TOL_BF16_CUDA_CORE = (1e-6, 2.0 ** -7)
FLASH_BF16_LIBRARY_FACTOR, FLASH_BF16_CEILING = 2.0, 0.04
FLASH_BF16_STEP = 2.0 ** -7
# The full-width float32 gate, kernel route vs plain route: max |logit
# difference| (logits are O(1); an attention fault moves them O(0.1)).
LM_GATE_TOL = 1e-3


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def same_bits(torch, a, b) -> bool:
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def finite_max_abs(torch, a, b) -> float:
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool(torch.equal(torch.isfinite(a), torch.isfinite(b))):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def lag_batch(torch, ts_np, Lp, dev):
    from repro_torch.core import embedding

    x = torch.as_tensor(ts_np).to(dev)
    return embedding.lag_matrix(x, E_MAX, 1, Lp).contiguous()


def check_knn(torch, name, Vq, Vc, k, exclude_self, select_Es,
              dist_dtype="float32"):
    """Kernel vs plain version on the card: idx equal, dist bit-equal
    (both with the float32 or the bfloat16 accumulator)."""
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_topk.ref import knn_topk_ref

    ki, kd = knn_topk(Vq, Vc, k, exclude_self, select_Es, dist_dtype=dist_dtype)
    torch.cuda.synchronize()
    ri, rd = knn_topk_ref(Vq, Vc, k, exclude_self, select_Es, dist_dtype=dist_dtype)
    idx_eq = bool(torch.equal(ki, ri))
    bits_eq = same_bits(torch, kd, rd)
    err = finite_max_abs(torch, kd, rd)
    emit("check_knn", case=name, shape=list(Vq.shape) + [Vc.shape[-1]], k=k,
         exclude_self=exclude_self, select_Es=list(select_Es),
         dist_dtype=dist_dtype, idx_equal=idx_eq, dist_bits_equal=bits_eq,
         max_abs_err=err)
    if not (idx_eq and bits_eq):
        bad = (ki != ri).nonzero()[:5].tolist()
        raise AssertionError(f"knn_topk kernel != plain version ({name}); first "
                             f"differing idx positions {bad}")
    return err


def check_knn_prefix(torch, name, Vq, Vc, k, exclude_self, buckets, lib_sizes,
                     col_ids, dist_dtype="float32"):
    """Prefix kernel vs plain version on the card: idx equal, dist
    bit-equal (float32 or bfloat16 accumulator)."""
    from repro_torch.kernels.knn_topk.ops import knn_topk_prefix
    from repro_torch.kernels.knn_topk.ref import knn_topk_prefix_ref

    ki, kd = knn_topk_prefix(Vq, Vc, k, exclude_self, buckets, lib_sizes,
                             col_ids=col_ids, dist_dtype=dist_dtype)
    torch.cuda.synchronize()
    ri, rd = knn_topk_prefix_ref(Vq, Vc, k, exclude_self, buckets, lib_sizes,
                                 col_ids=col_ids, dist_dtype=dist_dtype)
    idx_eq = bool(torch.equal(ki, ri))
    bits_eq = same_bits(torch, kd, rd)
    err = finite_max_abs(torch, kd, rd)
    emit("check_knn_prefix", case=name, shape=list(Vq.shape) + [Vc.shape[-1]],
         k=k, exclude_self=exclude_self, buckets=list(buckets),
         lib_sizes=list(lib_sizes), permuted=col_ids is not None,
         dist_dtype=dist_dtype, idx_equal=idx_eq, dist_bits_equal=bits_eq,
         max_abs_err=err)
    if not (idx_eq and bits_eq):
        bad = (ki != ri).nonzero()[:5].tolist()
        raise AssertionError(f"knn_topk_prefix kernel != plain version ({name}); "
                             f"first differing idx positions {bad}")
    return err


def check_slab(torch, name, Vq, Vc, k, exclude_self, against_topk=False,
               expect_big=None):
    """Slab kernel vs its plain version on the card: idx equal, dist bit-equal,
    the 3.0e38 entries of a k above the valid candidates and their padding
    and self ids included; with ``against_topk`` also against the knn_topk
    kernel at every E (k <= the valid candidates there).  ``expect_big``:
    the number of 3.0e38 entries the case must return."""
    from repro_torch.kernels.knn_slab.ops import knn_slab
    from repro_torch.kernels.knn_slab.ref import BIG, knn_slab_ref
    from repro_torch.kernels.knn_topk.ops import knn_topk

    ki, kd = knn_slab(Vq, Vc, k, exclude_self)
    torch.cuda.synchronize()
    ri, rd = knn_slab_ref(Vq, Vc, k, exclude_self)
    idx_eq = bool(torch.equal(ki, ri))
    bits_eq = same_bits(torch, kd, rd)
    err = finite_max_abs(torch, kd, rd)
    n_big = int((kd == BIG).sum())
    topk_eq = None
    if against_topk:
        ti, td = knn_topk(Vq[None], Vc[None], k, exclude_self,
                          tuple(range(1, Vq.shape[0] + 1)))
        topk_eq = bool(torch.equal(ki, ti[0])) and same_bits(torch, kd, td[0])
    emit("check_slab", case=name, E_max=Vq.shape[0], Lq=Vq.shape[1],
         Lc=Vc.shape[1], k=k, exclude_self=exclude_self, idx_equal=idx_eq,
         dist_bits_equal=bits_eq, max_abs_err=err, big_entries=n_big,
         padding_ids=int((ki >= Vc.shape[1]).sum()), equal_to_knn_topk=topk_eq)
    if not (idx_eq and bits_eq and topk_eq in (None, True)
            and expect_big in (None, n_big)):
        raise AssertionError(f"knn_slab kernel != plain version or knn_topk "
                             f"({name})")
    return err


def reset_launches():
    """Every kernel's launch count to 0."""
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.flash_attn.ops import flash_attn
    from repro_torch.kernels.knn_slab.ops import knn_slab
    from repro_torch.kernels.knn_topk.ops import knn_topk, knn_topk_prefix

    knn_topk.LAUNCHES = knn_topk_prefix.LAUNCHES = ccm_lookup.LAUNCHES = 0
    knn_slab.LAUNCHES = 0
    flash_attn.ROUTE_LAUNCHES = dict.fromkeys(flash_attn.ROUTE_LAUNCHES, 0)


def read_launches() -> dict:
    from repro_torch.kernels.knn_slab.ops import knn_slab
    from repro_torch.launch.edm_fleet import launch_counts

    return {**launch_counts(), "knn_slab": knn_slab.LAUNCHES}


def bench_knn(torch, dev, smi):
    """The port's kNN selection bench (``python -m repro_torch.bench.run
    knn``) at its card sizes, every launch count set to 0 just before it
    and read just after: both engines' streaming and slab tables at each
    Lc, paired repetitions, the slab == stream spot checks, the working
    sets.  Then at each Lc the slab kernel against its plain version
    (bit-equal) and, with CUDA events, both kernels' times beside the
    slab's plain version and bound."""
    from repro_torch.bench import run as brun
    from repro_torch.core import embedding
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.kernels.knn_slab.ops import knn_slab
    from repro_torch.kernels.knn_slab.ref import knn_slab_ref
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.launch.roofline import bound_ms, knn_counts, slab_counts

    sizes = brun.SIZES["knn"]["card"]
    reset_launches()
    t0 = time.perf_counter()
    log = io.StringIO()  # the bench's CSV rows
    with contextlib.redirect_stdout(log):
        res = brun.knn_selection_bench(brun.Bench(dev, ROOT / "build" / "bench"),
                                       **sizes)
    wall = time.perf_counter() - t0
    launches = read_launches()
    if not (launches["knn_slab"] > 0 and launches["knn_topk"] > 0):
        raise AssertionError(f"the knn bench missed a kernel: {launches}")
    if not (res["spot_check_cuda"] and res["spot_check_torch_reference"]):
        raise AssertionError("knn bench: slab == stream spot check missing")
    E, Lq, k = sizes["E_max"], sizes["Lq"], sizes["k"]
    pair = torch.as_tensor(dummy_brain(2, max(sizes["Lc_sweep"]) + E + 1,
                                       seed=3)).to(dev)
    Vq = embedding.lag_matrix(pair[0], E, 1, Lq).contiguous()
    all_E = tuple(range(1, E + 1))
    kernel_times = {}
    err = 0.0
    for Lc in sizes["Lc_sweep"]:
        Vc = embedding.lag_matrix(pair[1], E, 1, Lc).contiguous()
        err = max(err, check_slab(torch, f"bench_Lc{Lc}", Vq, Vc, k, False))
        ms = time_ms(torch, lambda: knn_slab(Vq, Vc, k, False), 10)
        plain = time_ms(torch, lambda: knn_slab_ref(Vq, Vc, k, False), 3)
        stream = time_ms(torch, lambda: knn_topk(Vq[None], Vc[None], k, False,
                                                 all_E), 10)
        bound, by = bound_ms(*slab_counts(E, Lq, Lc, k))
        kernel_times[str(Lc)] = dict(
            kernel_ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
            share_of_bound=bound / ms, knn_topk_ms=stream,
            knn_topk_bound_ms=bound_ms(*knn_counts(1, E, E, Lq, Lc, k))[0])
    out = dict(wall_s=wall, launches=launches, E_max=E, Lq=Lq, k=k,
               engines=res["engines"], phase1=res["phase1"],
               kernel_times=kernel_times, max_abs_err=err)
    emit("bench_knn", smi=smi, **out)
    return out


def dryrun_phase(torch, dev, smi):
    """``python -m repro_torch.launch.edm_dryrun`` for Fish1_Normo and
    Subject11 at their own N and L, one timed chunk each, the launch
    counts set to 0 just before each and read just after; the JSONs go to
    build/dryrun/ (the ``roofline`` bench reads them there)."""
    from repro_torch.configs.edm_datasets import DATASETS
    from repro_torch.launch import edm_dryrun

    out = {}
    d = ROOT / "build" / "dryrun"
    d.mkdir(parents=True, exist_ok=True)
    for name in ("fish1_normo", "subject11"):
        reset_launches()
        t0 = time.perf_counter()
        rep = edm_dryrun.dryrun(DATASETS[name], dev, chunks=1, seed=0)
        wall = time.perf_counter() - t0
        launches = read_launches()
        (d / f"{name}.json").write_text(json.dumps(rep, indent=1))
        keep = {k: rep[k] for k in (
            "N", "L", "chunk_rows", "n_chunks", "n_buckets",
            "lookup_launches_per_chunk", "setup_s", "chunk_s", "memory",
            "roofline", "roofline_whole_run", "whole_run_extrapolated_s",
            "chunk_share_of_bound", "rho_finite")}
        emit("dryrun", dataset=name, smi=smi, wall_s=wall, launches=launches,
             **keep)
        if not (rep["rho_finite"] and launches["knn_topk"] > 0
                and launches["ccm_lookup"] > 0):
            raise AssertionError(f"dry run of {name}: rho finite "
                                 f"{rep['rho_finite']}, launches {launches}")
        out[name] = dict(rep, launches=launches)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def same_npy_bits(a_path, b_path, rows=1024) -> bool:
    """Two stored float arrays (memmapped) equal bit for bit."""
    import numpy as np

    a, b = np.load(a_path, mmap_mode="r"), np.load(b_path, mmap_mode="r")
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.names is not None:  # the edge list: a structured array
        return a.tobytes() == b.tobytes()
    return all(np.array_equal(a[r : r + rows].view(np.uint32),
                              b[r : r + rows].view(np.uint32))
               for r in range(0, a.shape[0], rows))


def tied_lags(torch, dev, S, L, seed):
    """(S, E_MAX, L) lags quantised to quarter steps: many equal
    distances, and more once bfloat16 rounds them."""
    import numpy as np

    x = np.random.default_rng(seed).standard_normal((S, E_MAX, L))
    return torch.as_tensor((np.round(x * 4) / 4).astype(np.float32)).to(dev)


def run_cli(torch, dev, argv):
    """One run of the port's CLI with its progress lines kept off
    stdout (their last two are printed): (summary, launches by kernel,
    peak device bytes), the launch counts and the peak set to 0 just
    before it."""
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.knn_topk.ops import knn_topk, knn_topk_prefix
    from repro_torch.launch import edm_run

    knn_topk.LAUNCHES = knn_topk_prefix.LAUNCHES = ccm_lookup.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        summary = edm_run.main(argv)
    for ln in log.getvalue().strip().splitlines()[-2:]:
        print(ln, flush=True)
    launches = {"knn_topk": knn_topk.LAUNCHES,
                "knn_topk_prefix": knn_topk_prefix.LAUNCHES,
                "ccm_lookup": ccm_lookup.LAUNCHES}
    return summary, launches, torch.cuda.max_memory_allocated(dev)


def phase_walls(summary) -> dict:
    return {k: summary[k] for k in ("wall_s", "phase1_s", "phase2_s", "assemble_s")}


def check_prng(torch, dev):
    """The port's threefry draws on the card equal the CPU's bit for bit
    (integer ops only; the uniforms compared as bits)."""
    from repro_torch.inference import prng

    n_cmp = 0
    for seed in (0, 1, 2**31 - 1):
        kc, kd = prng.prng_key(seed), prng.prng_key(seed, dev)
        ids = torch.arange(2048)
        pairs = {
            "split": (prng.split(kc, 20), prng.split(kd, 20)),
            "fold_in": (prng.fold_in(kc, ids), prng.fold_in(kd, ids.to(dev))),
            "bits": (prng.random_bits(kc, 8508), prng.random_bits(kd, 8508)),
            "uniform": (prng.uniform(prng.split(kc, 20), 726, 0.0, prng.TWO_PI_F32),
                        prng.uniform(prng.split(kd, 20), 726, 0.0, prng.TWO_PI_F32)),
            "permutation_1430": (prng.permutation(kc, 1430), prng.permutation(kd, 1430)),
            "permutation_8508": (prng.permutation(kc, 8508), prng.permutation(kd, 8508)),
        }
        for what, (a, b) in pairs.items():
            b = b.cpu()
            same = (same_bits(torch, a, b) if a.dtype == torch.float32
                    else bool(torch.equal(a, b)))
            if not same:
                raise AssertionError(f"prng {what} (seed {seed}) differs between "
                                     "the card and the CPU")
            n_cmp += a.numel()
    emit("check_prng", seeds=[0, 1, 2**31 - 1], values_compared=n_cmp, equal=True)


def sig_near_ties(torch, ts, optE, rho, cfg, sig, dev):
    """(trend, p) near-tie masks (N, N) of a significance run: pairs whose
    rho curve has two sizes within NEAR_TIE, or whose null rho lies
    within NEAR_TIE of the observed rho for some surrogate — computed in
    chunks with the plain engine."""
    import numpy as np

    from repro_torch.core import ccm
    from repro_torch.inference import convergence
    from repro_torch.inference.pipeline import SignificanceChunkRunner

    r = SignificanceChunkRunner(ts, optE, cfg, sig, device=dev)
    inv = np.argsort(r.order)
    seg = tuple(enumerate(r.plan.counts))
    seg_m = tuple((b, c * r.m) for b, c in seg)
    S = len(sig.lib_sizes)
    iu = np.triu_indices(S, 1)
    trend_tie = np.zeros((r.N, r.N), bool)
    p_tie = np.zeros((r.N, r.N), bool)
    for row0 in range(0, r.N, cfg.lib_block):
        rows = r.rows(row0, cfg.lib_block)
        cidx, cw = convergence.conv_block_tables(rows, cfg, r.plan, sig.lib_sizes,
                                                 r.col_ids)
        curves = torch.stack([
            ccm.ccm_row_lookup_bucketed(cidx[:, s], cw[:, s], r.fut_sorted, cfg, seg)
            for s in range(S)
        ]).cpu().numpy()[..., inv]
        gaps = np.abs(curves[iu[1]] - curves[iu[0]])
        trend_tie[row0 : row0 + rows.shape[0]] = (gaps <= NEAR_TIE).any(0)
        fidx, fw = ccm.ccm_row_tables_bucketed(rows, cfg, r.plan)
        null = ccm.ccm_row_lookup_bucketed(fidx, fw, r.fut_surr, cfg, seg_m)
        null = null.cpu().numpy().reshape(rows.shape[0], r.N, r.m)[:, inv]
        obs = np.asarray(rho[row0 : row0 + rows.shape[0]])
        p_tie[row0 : row0 + rows.shape[0]] = (
            np.abs(null - obs[..., None]) <= NEAR_TIE).any(-1)
    return trend_tie, p_tie


def check_lookup(torch, name, idx, w, Y, segs=None):
    """Kernel vs plain version: |diff| <= 1e-6 * max|Y| (see docs/PORT.md);
    ``segs`` ((table_row, count), ...) for the segmented form."""
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref

    got = ccm_lookup(idx, w, Y, segs)
    torch.cuda.synchronize()
    want = ccm_lookup_ref(idx, w, Y, segs)
    err = float((got - want).abs().max())
    tol = 1e-6 * float(Y.abs().max())
    emit("check_lookup", case=name, idx_shape=list(idx.shape), B=Y.shape[0],
         Lp=Y.shape[1], segments=None if segs is None else len(segs),
         max_abs_err=err, tol=tol, bit_equal=same_bits(torch, got, want))
    if not err <= tol:
        raise AssertionError(f"ccm_lookup kernel != plain version ({name}): "
                             f"{err} > {tol}")
    return err


def _device_time_by_kernel(prof):
    """[(device us, kernel name, calls)] from a finished profile, largest
    first.  Kernels run on one stream, so their device times add up
    without overlap."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # CPU ops also carry their kernels' device time
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, ev.key, ev.count))
    return sorted(rows, reverse=True)


def profile_busy(torch, run, top=8):
    """Wall time, device-busy share and the ``top`` device kernels of one
    traced call of ``run``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_time_by_kernel(prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    return dict(wall_s=wall, device_busy_s=busy_s, device_busy_share=busy_s / wall,
                top=[{"name": k[:90], "device_s": us / 1e6, "calls": c}
                     for us, k, c in rows[:top]])


def profile_paths(torch, dev, n, smi):
    """Trace one in-process run of each path (no store) with
    torch.profiler: the main path (the map), then the significance stage
    on that map.  Emits per path the device's busy share of the wall
    time and the device time by kernel."""
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.inference import SignificanceConfig, run_significance

    ts = dummy_brain(n, FISH1_L, seed=5)
    cfg = EDMConfig(E_max=E_MAX)
    sig = SignificanceConfig(lib_sizes=SIG_LIB_SIZES, n_surrogates=SIG_M,
                             alpha=0.05, seed=0)
    warm = run_causal_inference(ts[: 2 * LIB_BLOCK], cfg, device=dev)
    run_significance(ts[: 2 * LIB_BLOCK], warm.optE, warm.rho, cfg, sig, device=dev)
    torch.cuda.synchronize()
    timings: dict = {}
    out = {}
    for phase, run in (
        ("profile", lambda: out.update(
            cmap=run_causal_inference(ts, cfg, device=dev, timings=timings))),
        ("profile_significance", lambda: run_significance(
            ts, out["cmap"].optE, out["cmap"].rho, cfg, sig, device=dev)),
    ):
        busy = profile_busy(torch, run, top=12)
        extra = timings if phase == "profile" else {
            "surrogates": SIG_M, "lib_sizes": list(SIG_LIB_SIZES)}
        emit(phase, N=n, L=FISH1_L, **extra, **busy, smi=smi)


def profile_phase2(torch, dev, ts, optE, smi):
    """Phase 2 of the main path at the smoke's N, traced with
    torch.profiler (device activity only, so the host keeps its pace):
    the device time of the lookup launches summed from the trace, beside
    the kNN launches and everything else (the Pearson after each lookup
    leads the rest), and the device's busy share of phase 2."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ccm
    from repro_torch.core.pipeline import Phase2Runner
    from repro_torch.core.types import EDMConfig

    cfg = EDMConfig(E_max=E_MAX)
    N = ts.shape[0]
    ts_fut = ccm.all_futures(torch.as_tensor(ts), cfg).numpy()
    rho = np.zeros((N, N), np.float32)
    plan = [(r, min(cfg.lib_block, N - r)) for r in range(0, N, cfg.lib_block)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        Phase2Runner(ts, ts_fut, optE, cfg, dev).run(plan, rho=rho)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = {"ccm_lookup": [0.0, 0], "knn_topk": [0.0, 0], "other": [0.0, 0]}
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        g = ("ccm_lookup" if "ccm_lookup_kernel" in ev.key else
             "knn_topk" if "knn_topk_kernel" in ev.key else "other")
        groups[g][0] += us / 1e6
        groups[g][1] += ev.count
        rows.append((us, ev.key, ev.count))
    busy = sum(v[0] for v in groups.values())
    if not (np.isfinite(rho).all() and groups["ccm_lookup"][1] > 0):
        raise AssertionError("traced phase 2 ran no lookup or gave non-finite rho")
    emit("profile_phase2", N=N, L=ts.shape[1], wall_s=wall, device_busy_s=busy,
         device_busy_share=busy / wall,
         device_s={g: v[0] for g, v in groups.items()},
         kernels={g: v[1] for g, v in groups.items()},
         top=[{"name": k[:90], "device_s": us / 1e6, "calls": c}
              for us, k, c in sorted(rows, reverse=True)[:12]], smi=smi)


def all_e_phase(torch, dev, smi):
    """The all-E phase 2 (--no-bucketed) at ALL_E_N x 1450, E_max 20,
    through the CLI untiled and in tiles of ALL_E_TILE (each with its
    launch counts set to 0 just before it): tiled == untiled byte for
    byte, and the cuda engine's map against torch-reference's on the
    card (optE equal, rho within 1e-5)."""
    import numpy as np

    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain

    n = ALL_E_N
    base = ["--synthetic", f"{n}x{FISH1_L}", "--e-max", str(E_MAX), "--no-bucketed"]
    runs = {}
    for name, extra in (("untiled", []), ("tiled", ["--target-tile", str(ALL_E_TILE)])):
        d = ROOT / "build" / f"smoke_all_e_{name}"
        shutil.rmtree(d, ignore_errors=True)
        summary, launches, peak = run_cli(torch, dev, base + extra + ["--out", str(d)])
        runs[name] = dict(dir=d, launches=launches, peak_device_bytes=peak,
                          **phase_walls(summary))
        if min(launches["knn_topk"], launches["ccm_lookup"]) < 1:
            raise AssertionError(f"all-E {name} run missed a kernel: {launches}")
    got = np.load(runs["untiled"]["dir"] / "causal_map" / "data.npy")
    byte_equal = same_npy_bits(runs["untiled"]["dir"] / "causal_map" / "data.npy",
                               runs["tiled"]["dir"] / "causal_map" / "data.npy")
    t0 = time.perf_counter()
    want = run_causal_inference(dummy_brain(n, FISH1_L),
                                EDMConfig(E_max=E_MAX, bucketed=False,
                                          engine="torch-reference"), device=dev)
    ref_s = time.perf_counter() - t0
    optE = json.loads((runs["untiled"]["dir"] / "causal_map" / "meta.json")
                      .read_text())["optE"]
    optE_eq = optE == want.optE.tolist()
    err = float(np.abs(got - want.rho).max())
    for r in runs.values():
        shutil.rmtree(r.pop("dir"), ignore_errors=True)
    out = dict(N=n, L=FISH1_L, E_max=E_MAX, tile=ALL_E_TILE, runs=runs,
               tiled_byte_equal=byte_equal, reference_device=str(dev),
               reference_wall_s=ref_s, optE_equal=optE_eq, rho_max_abs_err=err,
               tol=1e-5, smi=smi)
    emit("all_e", **out)
    if not (byte_equal and optE_eq and err <= 1e-5 and np.isfinite(got).all()):
        raise AssertionError("all-E phase 2: tiled != untiled or cuda != "
                             f"torch-reference ({byte_equal}, {optE_eq}, {err})")
    return out


def bf16_map_phase(torch, dev, smi):
    """The map with the bfloat16 accumulator (EDMConfig(dist_dtype=
    "bfloat16")) at BF16_N x 1450, E_max 20: the cuda engine (its launch
    counts set to 0 just before it; the kNN kernel must run) against
    torch-reference on the card — the first chunk's phase-1 and phase-2
    kNN tables bit-equal, optE equal, rho within 1e-5."""
    import dataclasses as dc

    import numpy as np

    from repro_torch import engine
    from repro_torch.core import ccm, embedding
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.knn_topk.ops import knn_topk

    ts = dummy_brain(BF16_N, FISH1_L, seed=14)
    cfg = EDMConfig(E_max=E_MAX, dist_dtype="bfloat16")
    ref_cfg = dc.replace(cfg, engine="torch-reference")
    knn_topk.LAUNCHES = ccm_lookup.LAUNCHES = 0
    t0 = time.perf_counter()
    got = run_causal_inference(ts, cfg, device=dev)
    wall = time.perf_counter() - t0
    launches = {"knn_topk": knn_topk.LAUNCHES, "ccm_lookup": ccm_lookup.LAUNCHES}
    want = run_causal_inference(ts, ref_cfg, device=dev)
    optE_eq = bool(np.array_equal(got.optE, want.optE))
    err = float(np.abs(got.rho - want.rho).max())
    f32 = run_causal_inference(ts, EDMConfig(E_max=E_MAX), device=dev)
    # the first chunk's tables from both engines
    rows = torch.as_tensor(ts[:LIB_BLOCK]).to(dev)
    Lp = cfg.n_points(FISH1_L)
    V = embedding.lag_matrix(rows, E_MAX, 1, Lp).contiguous()
    plan, _ = ccm.make_bucket_plan(got.optE)
    kb = plan.buckets[-1] + 1
    Lh = Lp // 2
    tables_equal = {}
    for name, args, kw in (
        ("phase1", (V[..., Lh:].contiguous(), V[..., :Lh].contiguous(), E_MAX + 1),
         dict(exclude_self=False)),
        ("phase2", (V, V, kb), dict(buckets=plan.buckets, exclude_self=True)),
    ):
        pair = []
        for c in (cfg, ref_cfg):
            eng = engine.get_engine(c.engine)
            fn = eng.knn_tables if name == "phase1" else eng.knn_tables_bucketed
            pair.append(fn(*args, cfg=c, **kw))
        (ki, kd), (ri, rd) = pair
        tables_equal[name] = bool(torch.equal(ki, ri)) and same_bits(torch, kd, rd)
    out = dict(N=BF16_N, L=FISH1_L, E_max=E_MAX, dist_dtype="bfloat16", wall_s=wall,
               launches=launches, tables_bit_equal=tables_equal,
               optE_equal=optE_eq, rho_max_abs_err=err, tol=1e-5,
               optE_equal_f32=bool(np.array_equal(got.optE, f32.optE)),
               rho_max_abs_diff_f32=float(np.abs(got.rho - f32.rho).max()), smi=smi)
    emit("bf16_map", **out)
    if not (all(tables_equal.values()) and optE_eq and err <= 1e-5
            and launches["knn_topk"] > 0 and np.isfinite(got.rho).all()):
        raise AssertionError(f"bf16 map: cuda != torch-reference ({out})")
    return out


# ---- the LM serving path --------------------------------------------------
FLASH_CASES = (
    # name, B, Sq, Sk, H, K, dh, causal, dtype
    ("serve_qwen2.5-3b", 4, 2048, 2048, 16, 2, 128, True, "bfloat16"),
    ("smollm-135m_dh64_rep3", 2, 1024, 1024, 9, 3, 64, True, "bfloat16"),
    ("minicpm-2b_mha_dh64", 1, 512, 512, 36, 36, 64, True, "bfloat16"),
    ("float32_dh128", 2, 1024, 1024, 16, 2, 128, True, "float32"),
    ("sq_not_tile_multiple", 1, 2049, 2049, 16, 2, 128, True, "bfloat16"),
    ("noncausal_sk_not_tile_multiple_f32", 2, 300, 333, 8, 2, 128, False, "float32"),
    ("noncausal_sk_not_tile_multiple_bf16", 2, 300, 333, 8, 2, 128, False, "bfloat16"),
    ("test_kernels_1", 2, 128, 128, 4, 2, 64, True, "float32"),
    ("test_kernels_2", 1, 256, 256, 6, 6, 32, True, "float32"),
    ("test_kernels_3", 2, 64, 64, 8, 4, 16, False, "float32"),
    ("test_kernels_4", 1, 96, 96, 2, 1, 8, True, "float32"),
    ("bf16_dh16", 2, 300, 300, 4, 2, 16, True, "bfloat16"),
    ("zamba2-7b_dh112_mha", 1, 1024, 1024, 32, 32, 112, True, "bfloat16"),
    ("sq1_below_tile", 4, 1, 2048, 16, 2, 128, False, "bfloat16"),
    ("rep8_h32_k4", 1, 1000, 1000, 32, 4, 128, True, "bfloat16"),
    ("bf16_dh8_cuda_core", 1, 96, 96, 2, 1, 8, True, "bfloat16"),
)


def qkv(torch, dev, B, Sq, Sk, H, K, dh, dtype, seed):
    g = torch.Generator(dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dt)
                 for shape in ((B, Sq, H, dh), (B, Sk, K, dh), (B, Sk, K, dh)))


def sdpa(torch, q, k, v, causal):
    """One library call computing flash_attn's function: SDPA in
    (B, H, S, dh), GQA, top-left causal; back in (B, S, H, dh)."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                          enable_gqa=True).transpose(1, 2)


def check_flash(torch, dev):
    """Kernel vs plain version on the card at every case of FLASH_CASES,
    within the tolerance of its dtype and route (FLASH_TOL_F32,
    FLASH_TOL_BF16_CUDA_CORE, or the tensor-core rule).  Returns the
    largest error."""
    from repro_torch.kernels.flash_attn.ops import flash_attn, flash_route
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref

    worst = 0.0
    for i, (name, B, Sq, Sk, H, K, dh, causal, dtype) in enumerate(FLASH_CASES):
        q, k, v = qkv(torch, dev, B, Sq, Sk, H, K, dh, dtype, seed=100 + i)
        route = flash_route(q.device.type, q.dtype, dh)
        got = flash_attn(q, k, v, causal)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(got).all())
        if route == "tensor_core":
            want = flash_attn_ref(q.float(), k.float(), v.float(), causal)
            diff = (got.float() - want).abs()
            lib_row = (sdpa(torch, q, k, v, causal).float() - want).abs().amax(-1)
            lib_err = float(lib_row.max())
            limit = min(FLASH_BF16_LIBRARY_FACTOR * lib_err, FLASH_BF16_CEILING)
            elem = (FLASH_BF16_STEP * want.abs()
                    + FLASH_BF16_LIBRARY_FACTOR * lib_row[..., None])
            # largest share of the element limit taken; <= 1 passes
            elem_share = float((diff / elem.clamp_min(1e-30)).max())
            err = float(diff.max())
            ok = finite and err <= limit and elem_share <= 1.0
            tol = dict(library_max_abs_err=lib_err, tol=limit,
                       elem_limit_share=elem_share)
        else:
            want = flash_attn_ref(q, k, v, causal)
            atol, rtol = FLASH_TOL_F32 if dtype == "float32" else FLASH_TOL_BF16_CUDA_CORE
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            ok = finite and bool((diff <= atol + rtol * want.float().abs()).all())
            tol = dict(atol=atol, rtol=rtol)
        emit("check_flash", case=name, B=B, Sq=Sq, Sk=Sk, H=H, K=K, dh=dh,
             causal=causal, dtype=dtype, route=route, max_abs_err=err, **tol,
             ok=ok)
        if not ok:
            raise AssertionError(f"flash_attn kernel != plain version ({name}): "
                                 f"max abs error {err}, {tol}")
        worst = max(worst, err)
    return worst


def time_flash(torch, dev, smi):
    """CUDA-event means at the serve shape: kernel (the tensor-core
    route), plain version, and one library call (SDPA in (B, H, S, dh),
    transposed outside the timing)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn.ops import flash_attn, flash_route
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref
    from repro_torch.launch.roofline import PEAK_BF16_FLOPS, bound_ms, flash_counts

    cfg = lm_config()
    B, S, H, K, dh = SERVE_B, SERVE_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = qkv(torch, dev, B, S, S, H, K, dh, "bfloat16", seed=7)
    ms = time_ms(torch, lambda: flash_attn(q, k, v, True), 20)
    plain = time_ms(torch, lambda: flash_attn_ref(q, k, v, True), 3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    want = flash_attn_ref(q.float(), k.float(), v.float(), True)
    lib_err = float((sdpa().transpose(1, 2).float() - want).abs().max())
    err = float((flash_attn(q, k, v, True).float() - want).abs().max())
    lib = time_ms(torch, sdpa, 20)
    bound, by = bound_ms(*flash_counts(B, S, H, K, dh, 2), PEAK_BF16_FLOPS)
    out = dict(kernel_ms=ms, plain_ms=plain,
               library_ms=lib, max_abs_err=err, library_max_abs_err=lib_err,
               bound_ms=bound, bound_by=by, share_of_bound=bound / ms,
               route=flash_route(q.device.type, q.dtype, dh), B=B, S=S, H=H,
               K=K, dh=dh, dtype="bfloat16", causal=True)
    emit("time_flash", smi=smi, **out)
    return out


def lm_config(**kw):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(LM_ARCH), attn_impl="chunked", **kw)


def top1_mismatches(torch, got, want, vocab, tol):
    """(mismatching positions outside near-ties, near-ties): a near-tie is
    a position whose plain-route top-2 logits lie within 2 tol."""
    g = got[..., :vocab].reshape(-1, vocab)
    w = want[..., :vocab].reshape(-1, vocab)
    top2 = w.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= 2 * tol
    bad = g.argmax(-1) != w.argmax(-1)
    return int((bad & ~tie).sum()), int(tie.sum())


def lm_serve(torch, dev, smi):
    """qwen2.5-3b at full width in bf16 through make_prefill_step (four
    requests of 2048 tokens, the flash kernel in each layer) and 32 greedy
    decode steps; the flash launch count starts at 0 just before the
    prefill.  Then the kernel route vs the plain route on one request,
    reported, not gated."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.flash_attn.ops import ROUTES, flash_attn
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as T

    cfg = lm_config()
    V = cfg.vocab_size
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    tokens = torch.as_tensor(TokenStream(V, SERVE_B, SERVE_S, seed=0).batch_at(0)["tokens"])
    prefill_step = make_prefill_step(cfg, device=dev)
    decode = make_decode_step(cfg, device=dev)
    with torch.inference_mode():
        # warm-up at a short prompt: cuBLAS handles, the kernel's library
        _, c = prefill_step(params, {"tokens": tokens[:, :128]})
        warm = T.init_cache(cfg, SERVE_B, 130, device=dev)
        warm["k"][:, :, :128], warm["v"][:, :, :128] = c["k"], c["v"]
        decode(params, {"token": tokens[:, 128:129], "pos": 128}, warm)
        del c, warm
        torch.cuda.synchronize()

        flash_attn.ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        if tuple(logits.shape) != (SERVE_B, SERVE_S, cfg.padded_vocab):
            raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
        prefill_finite = bool(torch.isfinite(logits).all())
        tok = logits[:, -1, :V].argmax(-1)
        del logits
        big = T.init_cache(cfg, SERVE_B, SERVE_S + DECODE_STEPS, device=dev)
        big["k"][:, :, :SERVE_S], big["v"][:, :, :SERVE_S] = cache["k"], cache["v"]
        del cache
        out_tokens, finite = [tok], torch.ones((), dtype=torch.bool, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(DECODE_STEPS):
            ld, big = decode(params, {"token": tok[:, None], "pos": SERVE_S + t}, big)
            tok = ld[:, 0, :V].argmax(-1)
            finite &= torch.isfinite(ld).all()
            out_tokens.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        by_route = dict(flash_attn.ROUTE_LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)

        # where the time goes: one traced prefill, and four decode steps
        # that rewrite the last four slots of the cache
        last = SERVE_S + DECODE_STEPS - 4
        busy = {
            "prefill": profile_busy(torch, lambda: prefill_step(params, {"tokens": tokens})),
            "decode_4_steps": profile_busy(torch, lambda: [
                decode(params, {"token": tok[:, None], "pos": last + i}, big)
                for i in range(4)]),
        }
        del big, ld
        if not (prefill_finite and bool(finite)):
            raise AssertionError("non-finite logits on the serving path")
        if by_route != {**dict.fromkeys(ROUTES, 0), "tensor_core": cfg.n_layers}:
            raise AssertionError(f"prefill launched the flash kernels {by_route}, "
                                 f"not the tensor-core route once per layer "
                                 f"({cfg.n_layers})")

        # bf16: the kernel route against the plain route on one request
        one = {"tokens": tokens[:1]}
        fk, _ = T.forward(params, one, cfg)
        fp, _ = T.forward(params, one, dataclasses.replace(cfg, attn_impl="xla"))
        bf16_err = float((fk - fp).abs().max())
        bf16_bad, bf16_ties = top1_mismatches(torch, fk, fp, V, LM_GATE_TOL)
        bf16_logit_absmax = float(fp.abs().max())
        del fk, fp
    del params
    torch.cuda.empty_cache()
    gen = torch.stack(out_tokens, 1).cpu()
    out = dict(arch=LM_ARCH, params=n_params, dtype=cfg.dtype,
               attn_impl=cfg.attn_impl, B=SERVE_B, prompt=SERVE_S,
               decode_steps=DECODE_STEPS, init_s=init_s, prefill_s=prefill_s,
               prefill_tokens_per_s=SERVE_B * SERVE_S / prefill_s,
               decode_ms_per_step=decode_s / DECODE_STEPS * 1e3,
               decode_tokens_per_s=SERVE_B * DECODE_STEPS / decode_s,
               peak_device_bytes=peak,
               launches={"flash_attn": sum(by_route.values())},
               launches_by_route=by_route,
               generated_distinct=int(gen.unique().numel()),
               bf16_kernel_vs_plain_max_abs=bf16_err,
               bf16_logit_absmax=bf16_logit_absmax,
               bf16_top1_mismatches=bf16_bad, bf16_top1_near_ties=bf16_ties,
               profile=busy, smi=smi)
    emit("lm_serve", **out)
    return out


def lm_check(torch, dev, smi):
    """The gate: the same model in float32 (TF32 off), one request of 2049
    tokens, the kernel route (chunked) against the plain route (xla):
    every position's logits within LM_GATE_TOL and top-1 equal outside
    near-ties.  Then prefill (2048 tokens) against forward, and the decode
    of token 2048 against forward at that position."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as T

    cfg = lm_config(dtype="float32")
    V, S = cfg.vocab_size, SERVE_S
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    toks = torch.as_tensor(TokenStream(V, 1, S + 1, seed=0).batch_at(0)["tokens"])
    with torch.inference_mode():
        fk, _ = T.forward(params, {"tokens": toks}, cfg)
        fp, _ = T.forward(params, {"tokens": toks},
                          dataclasses.replace(cfg, attn_impl="xla"))
        route_err = float((fk - fp).abs().max())
        last_err = float((fk[:, S - 1] - fp[:, S - 1]).abs().max())
        bad, ties = top1_mismatches(torch, fk, fp, V, LM_GATE_TOL)
        logit_absmax = float(fp.abs().max())
        del fp
        pl, cache = make_prefill_step(cfg, device=dev)(params, {"tokens": toks[:, :S]})
        prefill_err = float((pl - fk[:, :S]).abs().max())
        del pl
        big = T.init_cache(cfg, 1, S + 1, device=dev)
        big["k"][:, :, :S], big["v"][:, :, :S] = cache["k"], cache["v"]
        del cache
        ld, _ = make_decode_step(cfg, device=dev)(
            params, {"token": toks[:, S : S + 1], "pos": S}, big)
        decode_err = float((ld[:, 0] - fk[:, S]).abs().max())
        decode_top1 = bool(ld[0, 0, :V].argmax() == fk[0, S, :V].argmax())
        del big, ld, fk
    del params
    torch.cuda.empty_cache()
    ok = (route_err <= LM_GATE_TOL and bad == 0 and prefill_err <= LM_GATE_TOL
          and decode_err <= LM_GATE_TOL)
    out = dict(arch=LM_ARCH, dtype="float32", tf32=False, B=1, positions=S + 1,
               tol=LM_GATE_TOL, kernel_vs_plain_max_abs=route_err,
               kernel_vs_plain_last_prompt_position=last_err,
               logit_absmax=logit_absmax, top1_mismatches=bad, top1_near_ties=ties,
               prefill_vs_forward_max_abs=prefill_err,
               decode_vs_forward_max_abs=decode_err, decode_top1_equal=decode_top1,
               ok=ok, smi=smi)
    emit("lm_check", **out)
    if not ok:
        raise AssertionError(f"LM float32 gate failed: {out}")
    return out


# ------------------------------------------------------------------ fleet
FLEET_ARTIFACTS = ("causal_map", "rho_conv", "rho_trend", "pvals", "edges")
FLEET_TIMEOUT_S = 900  # the limit of every wait on a fleet or a worker


def compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


class BusySampler:
    """The card's busy share over a run, sampled: ``nvidia-smi``'s
    utilization.gpu (the share of each sample period in which a kernel
    ran) every 200 ms in a process of its own; ``stop()`` returns the
    mean and the sample count."""

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> dict:
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        vals = [float(v) for v in out.split() if v.strip().isdigit()]
        return {"mean_pct": sum(vals) / len(vals) if vals else None,
                "samples": len(vals), "period_ms": 200}


def worker_done_lines(text: str) -> dict:
    """{worker: its ``[wid] done in <s>s {json}`` records} from a fleet's
    log: launches, peak device bytes and stage seconds of each process
    that finished (a killed process prints none).  Found wherever they
    sit in the log, since several processes write to it."""
    import re

    done, dec = {}, json.JSONDecoder()
    for m in re.finditer(r"\] done in [0-9.]+s ", text):
        rec, _ = dec.raw_decode(text, m.end())
        done.setdefault(rec["worker"], []).append(rec)
    return done


def summed_launches(done: dict) -> dict:
    total: dict = {}
    for recs in done.values():
        for rec in recs:
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
    return total


def per_worker(done: dict) -> dict:
    return {wid: [{"phase2_s": r["stages_s"].get("phase2"),
                   "sig_s": r["stages_s"].get("sig"),
                   "stages_s": r["stages_s"],
                   "peak_device_bytes": r["peak_device_bytes"],
                   "launches": r["launches"]} for r in recs]
            for wid, recs in sorted(done.items())}


def run_fleet_cli(argv, log_path, env_extra=None):
    """``python -m repro_torch.launch.edm_run ... --workers W`` in a
    process group of its own (on a timeout the whole group, workers
    included, is killed), its log (the supervisor's and every worker's
    lines) kept in ``log_path``: (wall s, log text)."""
    import os
    import signal

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.edm_run",
                             *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=FLEET_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    wall = time.perf_counter() - t0
    log_path.write_text(out)
    if proc.returncode != 0:
        raise AssertionError(f"fleet run {argv} exited {proc.returncode}:\n"
                             f"{out[-4000:]}")
    return wall, out


def supervisor_line(text: str) -> dict:
    """restarts / failed of the supervisor's ``fleet[W] ...`` line."""
    for ln in text.splitlines():
        if ln.startswith("fleet[") and "restarts " in ln:
            rest = ln.split("restarts ", 1)[1]
            restarts, failed = rest.split("; failed ")
            wall = float(ln.split(" in ", 1)[1].split("s ", 1)[0])
            return {"line": ln, "wall_s": wall, "restarts": json.loads(restarts),
                    "failed": json.loads(failed)}
    raise AssertionError("no supervisor summary line in the fleet log")


def span_split(out) -> dict:
    """Seconds and count of every (stage, span name) in the workers'
    telemetry, summed over workers, with the waits the spans record
    (``gather_s``: a drain's wait for the chunk's result; ``fsync_s``: a
    block write's fsync): where a fleet's time went.  ``chunk`` spans
    dispatch the kernels; ``drain`` spans wait for a result and write it
    (``write_block`` / ``write_tile``, ``manifest_commit``); the
    ``queue_*`` spans are the queue's claims, lease renewals, done
    markers and barrier waits.  ``<stage>/unattributed`` is each stage
    span less the union of the spans inside it (nested spans counted
    once), summed over workers: time no span covers."""
    from repro_torch.runtime import telemetry

    split: dict = {}
    # (worker, stage) -> stage spans and inner spans as (start, end)
    stage_iv: dict = {}
    inner_iv: dict = {}
    for stem, rec in telemetry.iter_store_records(out):
        if rec.get("kind") != "span":
            continue
        acc = split.setdefault(f"{rec['stage']}/{rec['name']}", {"s": 0.0, "n": 0})
        acc["s"] += rec["dur_s"]
        acc["n"] += 1
        for attr in ("gather_s", "fsync_s"):
            if attr in rec["attrs"]:
                acc[attr] = acc.get(attr, 0.0) + rec["attrs"][attr]
        iv = (rec["mono"] - rec["dur_s"], rec["mono"])
        key = (stem, rec["pid"], rec["stage"])
        (stage_iv if rec["name"] == "stage" else inner_iv).setdefault(
            key, []).append(iv)
    for key, stages in stage_iv.items():
        inner = sorted(inner_iv.get(key, []))
        for lo, hi in stages:
            covered, end = 0.0, lo
            for a, b in inner:
                a, b = max(a, end), min(b, hi)
                if b > a:
                    covered += b - a
                    end = b
            acc = split.setdefault(f"{key[2]}/unattributed", {"s": 0.0, "n": 0})
            acc["s"] += (hi - lo) - covered
            acc["n"] += 1
    return dict(sorted(split.items()))


def check_fleet_store(out, ref, artifacts, expect_complete=True):
    """Byte equality with the single-process store, status, fsck, leases."""
    from repro_torch.launch import edm_fleet
    from repro_torch.runtime import integrity

    equal = {a: same_npy_bits(ref / a / "data.npy", out / a / "data.npy")
             for a in artifacts}
    st = edm_fleet.fleet_status(out)
    rep = integrity.fsck_store(out)
    leases = sorted(p.name for p in (out / "queue").glob("*.lease"))
    res = {"byte_equal": equal, "status_complete": st["complete"],
           "fsck_clean": rep["clean"], "fsck_problems": rep["problems"],
           "stale_leases": leases,
           "telemetry_violations": st["telemetry"]["violations"]}
    if not all(equal.values()):
        raise AssertionError(f"fleet store {out} != single-process: {equal}")
    if not (st["complete"] == expect_complete and rep["clean"] and not leases):
        raise AssertionError(f"fleet store {out}: {res}")
    return res


@contextlib.contextmanager
def stdout_fd_to(path):
    """Point file descriptor 1 at ``path`` (processes started inside
    inherit it), then back."""
    import os

    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "ab") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def fleet_phases(torch, smi, n, sig_n, main_dir, main_launches, sig_dir,
                 sig_launches, wall_single, busy_single):
    """The fleet on the card: W worker processes, each with its own CUDA
    context, over one store.  main (--workers 2 at n), significance
    (--workers 2 at sig_n), kill (3 workers, units of 5 rows, w0
    SIGKILLed once a block is durable and relaunched under its id) and
    faults (--workers 3 --unit-rows 5 with EDM_FAULTS armed in the first
    generation of every worker; the supervisor relaunches each without
    it).  Each store byte-equal to the single-process one; the summed
    launches equal the single-process counts where no process died."""
    import os
    import signal

    from repro_torch.core.types import EDMConfig
    from repro_torch.data import store
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.inference import SignificanceConfig
    from repro_torch.launch import edm_fleet

    mode = compute_mode()
    emit("fleet_card", compute_mode=mode, smi=smi,
         device_bytes_held_by_smoke=torch.cuda.memory_allocated(),
         device_bytes_reserved_by_smoke=torch.cuda.memory_reserved())
    logs = ROOT / "build" / "smoke_fleet_logs"
    logs.mkdir(parents=True, exist_ok=True)
    sig_argv = ["--lib-sizes", ",".join(map(str, SIG_LIB_SIZES)),
                "--surrogates", str(SIG_M), "--surrogate-kind", "phase",
                "--fdr", "0.05", "--seed", "0"]
    results = {}

    # ---- main path, two workers ------------------------------------------
    out = ROOT / "build" / "smoke_fleet_main"
    shutil.rmtree(out, ignore_errors=True)
    busy = BusySampler()
    try:
        wall, text = run_fleet_cli(["--synthetic", f"{n}x{FISH1_L}", "--e-max",
                                    str(E_MAX), "--workers", "2", "--out",
                                    str(out)], logs / "main.log")
    finally:
        busy = busy.stop()
    done = worker_done_lines(text)
    sums = summed_launches(done)
    chk = check_fleet_store(out, main_dir, ("causal_map",))
    sup = supervisor_line(text)
    equal_counts = all(sums.get(k) == v for k, v in main_launches.items())
    emit("fleet_main", N=n, L=FISH1_L, E_max=E_MAX, workers=2, wall_s=wall,
         supervisor_wall_s=sup["wall_s"], supervisor=sup["line"],
         card_busy_sampled=busy, single_process_card_busy_sampled=busy_single,
         restarts=sup["restarts"], failed=sup["failed"],
         workers_done=per_worker(done), launches_summed=sums,
         launches_single_process=main_launches,
         launches_equal_single_process=equal_counts,
         single_process_wall_s=wall_single["main"], spans=span_split(out),
         smi=smi, **chk)
    if not equal_counts or sup["failed"] or any(sup["restarts"].values()):
        raise AssertionError(f"fleet main path: launches {sums} vs "
                             f"{main_launches}, supervisor {sup}")
    results["main"] = sums
    shutil.rmtree(out, ignore_errors=True)

    # ---- significance path, two workers ----------------------------------
    out = ROOT / "build" / "smoke_fleet_sig"
    shutil.rmtree(out, ignore_errors=True)
    wall, text = run_fleet_cli(["--synthetic", f"{sig_n}x{FISH1_L}", "--e-max",
                                str(E_MAX), *sig_argv, "--workers", "2",
                                "--out", str(out)], logs / "significance.log")
    done = worker_done_lines(text)
    sums = summed_launches(done)
    chk = check_fleet_store(out, sig_dir, FLEET_ARTIFACTS)
    sup = supervisor_line(text)
    equal_counts = all(sums.get(k) == v for k, v in sig_launches.items())
    emit("fleet_significance", N=sig_n, L=FISH1_L, workers=2, wall_s=wall,
         supervisor_wall_s=sup["wall_s"], supervisor=sup["line"],
         restarts=sup["restarts"], failed=sup["failed"],
         workers_done=per_worker(done), launches_summed=sums,
         launches_single_process=sig_launches,
         launches_equal_single_process=equal_counts,
         single_process_wall_s=wall_single["significance"],
         spans=span_split(out), smi=smi, **chk)
    if not equal_counts or sup["failed"] or any(sup["restarts"].values()):
        raise AssertionError(f"fleet significance: launches {sums} vs "
                             f"{sig_launches}, supervisor {sup}")
    results["significance"] = sums
    shutil.rmtree(out, ignore_errors=True)

    # ---- kill: three workers by hand, w0 SIGKILLed and relaunched --------
    out = ROOT / "build" / "smoke_fleet_kill"
    shutil.rmtree(out, ignore_errors=True)
    store.save_dataset(out / "dataset", dummy_brain(sig_n, FISH1_L),
                       {"synthetic": f"{sig_n}x{FISH1_L}"})
    sig = SignificanceConfig(lib_sizes=SIG_LIB_SIZES, n_surrogates=SIG_M,
                             alpha=0.05, surrogate="phase", seed=0)
    edm_fleet.init_fleet(out, out / "dataset", EDMConfig(E_max=E_MAX), sig,
                         unit_rows=5)
    log = logs / "kill.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("EDM_FAULTS", None)
    t0 = time.perf_counter()
    with stdout_fd_to(log):
        procs = {f"w{i}": edm_fleet.spawn_worker(out, f"w{i}", env=env)
                 for i in range(3)}
    try:
        while not list(out.glob("rows_*.npy")):
            if time.perf_counter() - t0 > FLEET_TIMEOUT_S:
                raise AssertionError("kill run: no phase-2 block became durable")
            if any(p.poll() is not None for p in procs.values()):
                raise AssertionError("kill run: a worker exited before the kill")
            time.sleep(0.05)
        victim = procs["w0"]
        os.kill(victim.pid, signal.SIGKILL)
        rc_killed = victim.wait(timeout=60)
        t_kill = time.perf_counter() - t0
        blocks_at_kill = len(list(out.glob("rows_*.npy")))
        with stdout_fd_to(log):
            procs["w0"] = edm_fleet.spawn_worker(out, "w0", env=env)
        rcs = {wid: p.wait(timeout=max(1.0, FLEET_TIMEOUT_S
                                       - (time.perf_counter() - t0)))
               for wid, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(rcs.values()) or rc_killed != -signal.SIGKILL:
        raise AssertionError(f"kill run: exit codes {rcs}, killed {rc_killed}")
    done = worker_done_lines(log.read_text())
    chk = check_fleet_store(out, sig_dir, FLEET_ARTIFACTS)
    sums = summed_launches(done)
    emit("fleet_kill", N=sig_n, workers=3, unit_rows=5, wall_s=wall,
         killed="w0", killed_at_s=t_kill, killed_rc=rc_killed,
         blocks_durable_at_kill=blocks_at_kill, exit_codes=rcs,
         workers_done=per_worker(done), launches_summed_done_lines=sums,
         launches_single_process=sig_launches,
         note="the killed process printed no done line: its launches are "
         "in no sum", smi=smi, **chk)
    results["kill_survivors"] = sums
    shutil.rmtree(out, ignore_errors=True)

    # ---- faults: the supervisor absorbs an armed crash -------------------
    out = ROOT / "build" / "smoke_fleet_faults"
    shutil.rmtree(out, ignore_errors=True)
    fault = "tile_pre_rename:crash@2"
    wall, text = run_fleet_cli(["--synthetic", f"{sig_n}x{FISH1_L}", "--e-max",
                                str(E_MAX), *sig_argv, "--workers", "3",
                                "--unit-rows", "5", "--out", str(out)],
                               logs / "faults.log", {"EDM_FAULTS": fault})
    done = worker_done_lines(text)
    sup = supervisor_line(text)
    chk = check_fleet_store(out, sig_dir, FLEET_ARTIFACTS)
    sums = summed_launches(done)
    emit("fleet_faults", N=sig_n, workers=3, unit_rows=5, faults=fault,
         wall_s=wall, supervisor_wall_s=sup["wall_s"], supervisor=sup["line"],
         restarts=sup["restarts"], failed=sup["failed"],
         workers_done=per_worker(done), launches_summed_done_lines=sums,
         launches_single_process=sig_launches,
         note="a crashed process printed no done line: its launches are "
         "in no sum", smi=smi, **chk)
    if sup["failed"] or not any(sup["restarts"].values()):
        raise AssertionError(f"fault run: the armed crash was not absorbed "
                             f"by a restart: {sup}")
    results["faults_survivors"] = sums
    shutil.rmtree(out, ignore_errors=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=16384,
                    help="series in the main-path run (Fish1_Normo has 53,053)")
    ap.add_argument("--sig-n", type=int, default=2048,
                    help="series in the significance-path run")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print(f"chip_smoke: {ROOT}/src/repro_torch not found; run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no CUDA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---- the card --------------------------------------------------------
    from repro_torch.runtime.device import card_line

    smi = card_line(dev)
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # ---- build -----------------------------------------------------------
    from repro_torch import kernels

    t0 = time.perf_counter()
    report = kernels.build_all()
    emit("build", seconds=time.perf_counter() - t0, kernels=report)

    # ---- the LM serving path: flash kernel checks and times, qwen2.5-3b ---
    # first, in a fresh process: after the EDM paths have run, the same
    # decode steps take about twice as long (PERF.md, open questions)
    flash_err = check_flash(torch, dev)
    ftimes = time_flash(torch, dev, smi)
    serve = lm_serve(torch, dev, smi)
    lm_check(torch, dev, smi)

    from repro_torch.core import knn as tknn
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref
    from repro_torch.inference import prng
    from repro_torch.inference.convergence import subsample_permutation
    from repro_torch.kernels.knn_topk.ops import knn_topk, knn_topk_prefix
    from repro_torch.kernels.knn_topk.ref import knn_topk_prefix_ref, knn_topk_ref
    from repro_torch.launch import edm_run
    from repro_torch.launch.roofline import (
        bound_ms,
        knn_counts,
        lookup_counts,
        prefix_counts,
        segmented_counts,
    )

    # ---- kernels against their plain versions, main-path shapes ---------
    Lp = FISH1_L - (E_MAX - 1) - 1  # 1430
    Lh = Lp // 2  # 715
    ts8 = dummy_brain(LIB_BLOCK, FISH1_L, seed=1)
    V8 = lag_batch(torch, ts8, Lp, dev)  # (8, 20, 1430)
    all_E = tuple(range(1, E_MAX + 1))
    knn_err = max(
        check_knn(torch, "phase1", V8[..., Lh:].contiguous(),
                  V8[..., :Lh].contiguous(), E_MAX + 1, False, all_E),
        check_knn(torch, "phase2_buckets", V8, V8, 13, True, (3, 5, 8, 12)),
        check_knn(torch, "phase2_all_E", V8, V8, E_MAX + 1, True, all_E),
    )
    small = V8[:2, :5, :21].contiguous()
    knn_err = max(knn_err, check_knn(torch, "k_eq_Lc", small, small, 21, True,
                                     (1, 2, 3, 4, 5)))
    tied = np.zeros((3, 300), np.float32)  # a dead (constant) series ...
    tied[1] = np.tile(np.sin(np.arange(50, dtype=np.float32)), 6)  # ... and
    tied[2, :150] = tied[2, 150:] = ts8[0, :150]  # series with repeated points
    Vt = lag_batch(torch, tied, 300 - E_MAX, dev)
    knn_err = max(knn_err, check_knn(torch, "tied_rows", Vt, Vt, E_MAX + 1,
                                     True, all_E))
    # the warp-parallel selection's edges: a ragged or partial last group
    # of 32 candidates, k at the warp width, k == Lc, one list, E = 1, and
    # a constant series (every distance ties at 0)
    v20, v77 = V8[:3, :, :20].contiguous(), V8[:3, :, :77].contiguous()
    v32 = V8[:2, :, :32].contiguous()
    Vconst = lag_batch(torch, np.full((2, 300), 0.25, np.float32), 300 - E_MAX, dev)
    for name, Vq, Vc, k, excl, sel in (
        ("Lc_below_32", v20, v20, 7, True, all_E),
        ("Lc_below_32_k_eq_Lc", v20, v20, 20, True, (2, 9)),
        ("Lc_not_multiple_of_32", V8[:3, :, 100:290].contiguous(), v77, 9, False,
         all_E),
        ("k_32", V8[:2], V8[:2], 32, True, (4, 11, 20)),
        ("k_eq_Lc_32", v32, v32, 32, True, all_E),
        ("one_list_E20", V8, V8, E_MAX + 1, True, (E_MAX,)),
        ("lone_E1", V8, V8, 2, True, (1,)),
        ("constant_series", Vconst, Vconst, E_MAX + 1, True, all_E),
        ("constant_series_k32", Vconst[..., :100].contiguous(), Vconst, 32, False,
         (1, 7, 20)),
    ):
        knn_err = max(knn_err, check_knn(torch, name, Vq, Vc, k, excl, sel))

    idx8, sqd8 = knn_topk(V8, V8, E_MAX + 1, True, (E_MAX,))
    idx8, w8 = tknn.tables_with_weights_bucketed(idx8, sqd8, (E_MAX,))
    idx8, w8 = idx8[:, 0].contiguous(), w8[:, 0].contiguous()  # (8, 1430, 21)
    ts_targets = dummy_brain(TARGET_BLOCK, FISH1_L, seed=2)
    Y = torch.as_tensor(ts_targets[:, E_MAX : E_MAX + Lp]).to(dev).contiguous()
    lookup_err = max(
        check_lookup(torch, "one_table", idx8[0], w8[0], Y),
        check_lookup(torch, "chunk_tables", idx8, w8, Y),
        check_lookup(torch, "ragged", idx8[:3, :1000].contiguous(),
                     w8[:3, :1000].contiguous(), Y[:777]),
    )
    # the segmented form: a chunk's table sets at four buckets, segments of
    # 1, G - 1, G and G + 1 targets for every group width G (8, 4, 2) and
    # one long segment; ragged Lq; k = 1 and 32 with idx at 0 and Lp - 1;
    # Subject11's series length and Lp = 16,384 (the stream kernel)
    bsel = (3, 5, 8, 12)
    idxb, sqdb = knn_topk(V8, V8, 13, True, bsel)
    idxb, wb = tknn.tables_with_weights_bucketed(idxb, sqdb, bsel)  # (8, 4, 1430, 13)
    counts = (1, 7, 8, 9, 0, 3, 4, 5, 2, 1, 17)
    segs = tuple((i % 4, c) for i, c in enumerate(counts))
    segs += ((3, TARGET_BLOCK - sum(counts)),)
    lookup_err = max(
        lookup_err,
        check_lookup(torch, "segmented", idxb, wb, Y, segs),
        check_lookup(torch, "segmented_ragged_Lq", idxb[:3, :, :1000].contiguous(),
                     wb[:3, :, :1000].contiguous(), Y[:sum(counts)],
                     tuple((i % 4, c) for i, c in enumerate(counts))),
    )
    rng = np.random.default_rng(7)
    seg_small = tuple((i % 2, c) for i, c in enumerate(counts))
    B_small = sum(counts)
    for name, S_, Lq_, k_, Lp_ in (("k1", 8, 1430, 1, Lp), ("k32", 8, 1430, 32, Lp),
                                   ("subject11_Lp", 2, 8508, 21, SUBJECT11_L),
                                   ("Lp_16384", 2, 1430, 21, 16384),
                                   ("stream_k1", 3, 8508, 1, SUBJECT11_L),
                                   ("stream_k32_Lp_9001", 2, 1000, 32, 9001)):
        ri = rng.integers(0, Lp_, (S_, 2, Lq_, k_)).astype(np.int32)
        ri[:, :, 0], ri[:, :, -1] = 0, Lp_ - 1
        rw = rng.uniform(0, 1, (S_, 2, Lq_, k_)).astype(np.float32)
        rY = rng.standard_normal((B_small, Lp_)).astype(np.float32)
        lookup_err = max(lookup_err, check_lookup(
            torch, name, torch.as_tensor(ri).to(dev), torch.as_tensor(rw).to(dev),
            torch.as_tensor(rY).to(dev), seg_small))
    from repro_torch.kernels.ccm_lookup.ops import _lib as lookup_lib

    max_lp = lookup_lib().ccm_lookup_max_lp()
    try:
        ccm_lookup(idxb[:1], wb[:1], torch.zeros((1, max_lp + 1), device=dev),
                   ((0, 1),))
    except ValueError as e:
        emit("check_lookup", case="Lp_past_limit_refused", max_lp=max_lp,
             refused=str(e))
    else:
        raise AssertionError(f"ccm_lookup took Lp = {max_lp + 1} past its limit")

    # ---- the prefix kernel against its plain version, significance shapes
    # col_ids: the pipeline's subsampling permutation at seed 0
    perm_key = prng.split(prng.prng_key(0, dev), 2)[0]
    col_ids = subsample_permutation(perm_key, Lp)
    prefix_err = max(
        check_knn_prefix(torch, "sig_buckets", V8, V8, 13, True, bsel,
                         SIG_LIB_SIZES, col_ids),
        check_knn_prefix(torch, "sig_all_E", V8, V8, E_MAX + 1, True, all_E,
                         SIG_LIB_SIZES, col_ids),
        check_knn_prefix(torch, "natural_order", V8, V8, 13, True, bsel,
                         SIG_LIB_SIZES, None),
        check_knn_prefix(torch, "lib0_is_k_plus_1", V8, V8, 13, True, bsel,
                         (14, 700, Lp), col_ids),
        check_knn_prefix(torch, "tied_rows", Vt, Vt, E_MAX + 1, True, all_E,
                         (E_MAX + 2, 100, Vt.shape[-1]),
                         subsample_permutation(perm_key, Vt.shape[-1])),
    )
    # the warp-parallel selection's snapshot edges: library sizes ending
    # inside a 32-wide group (1430 = 44 * 32 + 22), several in one group,
    # few query rows, a constant series under the permuted sweep (every
    # distance ties: the earliest position wins); with exclude_self the
    # self column of some query lies on either side of each snapshot
    Vc_const = lag_batch(torch, np.full((2, FISH1_L), 0.25, np.float32), Lp, dev)
    for name, Vq, Vc, k, excl, sel, sizes, cids in (
        ("mid_group_sizes", V8, V8, 13, True, bsel, (45, 100, Lp), col_ids),
        ("sizes_in_one_group", V8, V8, 13, True, bsel, (40, 45, 60, Lp), col_ids),
        ("mid_group_natural", V8, V8, 13, True, bsel, (45, 100, Lp), None),
        ("Lq_5", V8[..., 700:705].contiguous(), V8, 13, False, bsel, (45, 100, Lp),
         col_ids),
        ("Lq_1", V8[..., 7:8].contiguous(), V8, E_MAX + 1, False, all_E,
         (E_MAX + 1, 333, Lp), col_ids),
        ("constant_permuted", Vc_const, Vc_const, E_MAX + 1, True, all_E,
         (E_MAX + 2, 100, Lp), col_ids),
    ):
        prefix_err = max(prefix_err, check_knn_prefix(torch, name, Vq, Vc, k, excl,
                                                      sel, sizes, cids))
    check_prng(torch, dev)

    # ---- the bfloat16 accumulator: both kernels against the plain bf16
    # version, bit for bit, at the paths' shapes and on tie-heavy lags
    Vq1, Vc1 = V8[..., Lh:].contiguous(), V8[..., :Lh].contiguous()
    Vtie = tied_lags(torch, dev, 3, 400, 12)
    perm400 = subsample_permutation(perm_key, 400)
    b13 = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16)
    knn_bf16_err = max(
        check_knn(torch, "phase2_17E_bf16", V8, V8, 18, True, tuple(range(1, 18)),
                  "bfloat16"),
        check_knn(torch, "phase1_bf16", Vq1, Vc1, E_MAX + 1, False, all_E,
                  "bfloat16"),
        check_knn(torch, "tied_bf16", Vtie, Vtie, E_MAX + 1, True, all_E,
                  "bfloat16"),
        check_knn(torch, "tied_k32_bf16", Vtie, Vtie, 32, True, (4, 11, 20),
                  "bfloat16"),
    )
    prefix_bf16_err = max(
        check_knn_prefix(torch, "sig_shape_bf16", V8, V8, 17, True, b13,
                         SIG_LIB_SIZES, col_ids, "bfloat16"),
        check_knn_prefix(torch, "tied_mid_group_bf16", Vtie, Vtie, 13, True, bsel,
                         (40, 45, 60, 400), perm400, "bfloat16"),
        check_knn_prefix(torch, "tied_natural_bf16", Vtie, Vtie, E_MAX + 1, True,
                         all_E, (22, 100, 400), None, "bfloat16"),
    )

    # ---- the slab kernel of the kNN bench against its plain version ------
    # ragged Lq (130) and Lc (777), both exclude_self settings (self =
    # column q), the tied and constant series above, k above the valid
    # candidates (3.0e38 entries, self and padding ids), k 64 > 32; and
    # the knn_topk kernel's tables wherever k fits the valid candidates
    v = [V8[i] for i in range(LIB_BLOCK)]  # (20, 1430) each
    slab_err = max(
        check_slab(torch, "Lq128_Lc1000", v[0][:, :128].contiguous(),
                   v[1][:, :1000].contiguous(), E_MAX + 1, False, True),
        check_slab(torch, "Lq130_Lc1430_self", v[2][:, :130].contiguous(), v[2],
                   E_MAX + 1, True),
        check_slab(torch, "Lq1430_Lc1430_self", v[3], v[3], E_MAX + 1, True, True),
        check_slab(torch, "Lq128_Lc777_self", v[4][:, :128].contiguous(),
                   v[4][:, :777].contiguous(), E_MAX + 1, True),
        check_slab(torch, "Lq130_Lc777", v[5][:, :130].contiguous(),
                   v[5][:, :777].contiguous(), E_MAX + 1, False, True),
        check_slab(torch, "tied_rows", Vt[1], Vt[1], E_MAX + 1, True, True),
        check_slab(torch, "repeated_points", Vt[2], Vt[2], E_MAX + 1, True, True),
        check_slab(torch, "constant_series", Vconst[0], Vconst[0], E_MAX + 1,
                   True, True),
        check_slab(torch, "constant_series_k32", Vconst[0][:, :100].contiguous(),
                   Vconst[1], 32, False, True),
        check_slab(torch, "k_above_valid", v[6][:2, :10].contiguous(),
                   v[6][:2, :10].contiguous(), 12, True, expect_big=2 * 10 * 3),
        check_slab(torch, "k64", v[7][:, :128].contiguous(),
                   v[7][:, :1000].contiguous(), 64, False),
        check_slab(torch, "k64_self", v[7], v[7], 64, True),
    )
    del v

    # ---- the main path; the launch counts start at 0 here ---------------
    out_dir = ROOT / "build" / "smoke_out"
    shutil.rmtree(out_dir, ignore_errors=True)
    knn_topk.LAUNCHES = 0
    ccm_lookup.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    log = io.StringIO()  # one progress line per chunk: keep it off stdout
    busy_single = BusySampler()
    try:
        with contextlib.redirect_stdout(log):
            summary = edm_run.main(["--synthetic", f"{args.n}x{FISH1_L}",
                                    "--e-max", str(E_MAX), "--out", str(out_dir)])
    finally:
        busy_single = busy_single.stop()
    print(log.getvalue().strip().splitlines()[-1], flush=True)
    launches = {"knn_topk": knn_topk.LAUNCHES, "ccm_lookup": ccm_lookup.LAUNCHES}
    peak_mem = torch.cuda.max_memory_allocated(dev)
    result = summary["result"]
    rho = np.asarray(result.rho)
    if rho.shape != (args.n, args.n) or not np.isfinite(rho).all():
        raise AssertionError(f"causal map shape {rho.shape} / finite "
                             f"{np.isfinite(rho).all()}")
    if not (launches["knn_topk"] > 0 and launches["ccm_lookup"] > 0):
        raise AssertionError(f"main path missed a kernel: {launches}")
    buckets = tuple(int(b) for b in np.unique(result.optE))
    main_optE = np.asarray(result.optE)
    emit("end_to_end", N=args.n, L=FISH1_L, E_max=E_MAX, lib_block=LIB_BLOCK,
         n_cut_from=53053, wall_s=summary["wall_s"],
         phase1_s=summary["phase1_s"], phase2_s=summary["phase2_s"],
         assemble_s=summary["assemble_s"],
         cross_maps_per_s=summary["cross_maps_per_s"],
         peak_device_bytes=peak_mem, buckets=list(buckets),
         launches=launches, card_busy_sampled=busy_single,
         rho_mean=float(rho.mean()),
         rho_absmax=float(np.abs(rho).max()), smi=smi)
    del result, rho

    # ---- the tiled main path: the same map in column tiles ---------------
    tiled_dir = ROOT / "build" / "smoke_tiled"
    shutil.rmtree(tiled_dir, ignore_errors=True)
    tsum, tiled_launches, peak_tiled = run_cli(torch, dev, [
        "--synthetic", f"{args.n}x{FISH1_L}", "--e-max", str(E_MAX),
        "--target-tile", str(MAIN_TILE), "--out", str(tiled_dir)])
    tiled_equal = same_npy_bits(out_dir / "causal_map" / "data.npy",
                                tiled_dir / "causal_map" / "data.npy")
    emit("tiled_main_path", N=args.n, L=FISH1_L, E_max=E_MAX, tile=MAIN_TILE,
         **phase_walls(tsum), launches=tiled_launches,
         peak_device_bytes=peak_tiled,
         tiles_written=len(list(tiled_dir.glob("tile_*.npy"))),
         untiled={"wall_s": summary["wall_s"], "phase1_s": summary["phase1_s"],
                  "phase2_s": summary["phase2_s"],
                  "assemble_s": summary["assemble_s"], "launches": launches,
                  "peak_device_bytes": peak_mem},
         byte_equal_to_untiled=tiled_equal, smi=smi)
    if not tiled_equal:
        raise AssertionError("tiled main-path map != untiled map")
    if min(tiled_launches["knn_topk"], tiled_launches["ccm_lookup"]) < 1:
        raise AssertionError(f"tiled main path missed a kernel: {tiled_launches}")
    wall_single = {"main": summary["wall_s"]}
    del summary, tsum
    shutil.rmtree(tiled_dir, ignore_errors=True)  # out_dir: the fleet's reference
    profile_phase2(torch, dev, dummy_brain(args.n, FISH1_L), main_optE, smi)

    # ---- the significance path; the launch counts start at 0 here -------
    sig_dir = ROOT / "build" / "smoke_sig"
    shutil.rmtree(sig_dir, ignore_errors=True)
    knn_topk.LAUNCHES = knn_topk_prefix.LAUNCHES = ccm_lookup.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        summary = edm_run.main([
            "--synthetic", f"{args.sig_n}x{FISH1_L}", "--e-max", str(E_MAX),
            "--lib-sizes", ",".join(map(str, SIG_LIB_SIZES)),
            "--surrogates", str(SIG_M), "--surrogate-kind", "phase",
            "--fdr", "0.05", "--seed", "0", "--out", str(sig_dir)])
    sig_launches = {"knn_topk": knn_topk.LAUNCHES,
                    "knn_topk_prefix": knn_topk_prefix.LAUNCHES,
                    "ccm_lookup": ccm_lookup.LAUNCHES}
    peak_sig = torch.cuda.max_memory_allocated(dev)
    for ln in log.getvalue().strip().splitlines()[-2:]:
        print(ln, flush=True)
    out = summary["significance"]
    n = args.sig_n
    maps = {"rho": summary["result"].rho, "drho": out.drho, "trend": out.trend,
            "pvals": out.pvals}
    for name, a in maps.items():
        a = np.asarray(a)
        if a.shape != (n, n) or not np.isfinite(a).all():
            raise AssertionError(f"significance map {name}: shape {a.shape}, "
                                 f"finite {np.isfinite(a).all()}")
    j = np.asarray(out.pvals, np.float64) * (SIG_M + 1)
    if not (np.abs(j - np.rint(j)).max() <= 1e-4
            and np.rint(j).min() >= 1 and np.rint(j).max() <= SIG_M + 1):
        raise AssertionError("p-values outside {j / (m + 1)}")
    if min(sig_launches.values()) < 1:
        raise AssertionError(f"significance path missed a kernel: {sig_launches}")
    sig_buckets = tuple(int(b) for b in np.unique(summary["result"].optE))
    wall_single["significance"] = summary["wall_s"] + summary["significance_s"]
    emit("significance", N=n, L=FISH1_L, E_max=E_MAX, lib_block=LIB_BLOCK,
         lib_sizes=list(SIG_LIB_SIZES), surrogates=SIG_M, surrogate="phase",
         fdr=0.05, seed=0, n_cut_from=53053, wall_s=summary["wall_s"]
         + summary["significance_s"], phase1_s=summary["phase1_s"],
         phase2_s=summary["phase2_s"], assemble_s=summary["assemble_s"],
         significance_s=summary["significance_s"], peak_device_bytes=peak_sig,
         buckets=list(sig_buckets), launches=sig_launches, edges=summary["edges"],
         p_threshold=out.p_threshold, n_tests=out.n_tests,
         drho_mean=float(np.asarray(out.drho).mean()),
         trend_mean=float(np.asarray(out.trend).mean()), smi=smi)
    del summary, out, maps

    # ---- the tiled significance stage: the same store in column tiles ----
    sig_tiled_dir = ROOT / "build" / "smoke_sig_tiled"
    shutil.rmtree(sig_tiled_dir, ignore_errors=True)
    stsum, sig_tiled_launches, peak_sig_tiled = run_cli(torch, dev, [
        "--synthetic", f"{args.sig_n}x{FISH1_L}", "--e-max", str(E_MAX),
        "--lib-sizes", ",".join(map(str, SIG_LIB_SIZES)),
        "--surrogates", str(SIG_M), "--surrogate-kind", "phase",
        "--fdr", "0.05", "--seed", "0", "--target-tile", str(SIG_TILE),
        "--out", str(sig_tiled_dir)])
    sig_equal = {a: same_npy_bits(sig_dir / a / "data.npy",
                                  sig_tiled_dir / a / "data.npy")
                 for a in ("causal_map", "rho_conv", "rho_trend", "pvals", "edges")}
    Lp11 = SUBJECT11_L - (E_MAX - 1) - 1  # 8508
    emit("significance_tiled", N=args.sig_n, L=FISH1_L, tile=SIG_TILE,
         surrogates=SIG_M, wall_s=stsum["wall_s"] + stsum["significance_s"],
         significance_s=stsum["significance_s"], launches=sig_tiled_launches,
         peak_device_bytes=peak_sig_tiled, peak_device_bytes_untiled=peak_sig,
         byte_equal_to_untiled=sig_equal,
         surrogate_bytes={"untiled": args.sig_n * SIG_M * Lp * 4,
                          "tiled": SIG_TILE * SIG_M * Lp * 4},
         subject11_surrogate_bytes_arithmetic={
             "untiled": SUBJECT11_N * SIG_M * Lp11 * 4,
             "tiled": SIG_TILE * SIG_M * Lp11 * 4},
         edges=stsum["edges"], smi=smi)
    if not all(sig_equal.values()):
        raise AssertionError(f"tiled significance != untiled: {sig_equal}")
    if min(sig_tiled_launches.values()) < 1:
        raise AssertionError(f"tiled significance missed a kernel: "
                             f"{sig_tiled_launches}")
    if not peak_sig_tiled < peak_sig:
        raise AssertionError(f"tiled significance peak {peak_sig_tiled} B not "
                             f"below the untiled {peak_sig} B")
    del stsum
    shutil.rmtree(sig_tiled_dir, ignore_errors=True)  # sig_dir: the fleet's

    # ---- the all-E phase 2 and the bfloat16 map, each path's counts at 0
    all_e = all_e_phase(torch, dev, smi)
    bf16_map = bf16_map_phase(torch, dev, smi)

    # ---- times with CUDA events at the main path's shapes ---------------
    kb = buckets[-1] + 1
    times = {}
    for case, (Vq, Vc, k, excl, sel, it, it_plain) in {
        "phase2": (V8, V8, kb, True, buckets, 20, 2),
        "phase1": (Vq1, Vc1, E_MAX + 1, False, all_E, 20, 2),
    }.items():
        ms = time_ms(torch, lambda: knn_topk(Vq, Vc, k, excl, sel), it)
        plain = time_ms(torch, lambda: knn_topk_ref(Vq, Vc, k, excl, sel), it_plain)
        # the bfloat16 accumulator at the same shape, checked there first
        knn_bf16_err = max(knn_bf16_err, check_knn(
            torch, f"{case}_path_buckets_bf16", Vq, Vc, k, excl, sel, "bfloat16"))
        ms_bf16 = time_ms(torch, lambda: knn_topk(Vq, Vc, k, excl, sel,
                                                  dist_dtype="bfloat16"), it)
        plain_bf16 = time_ms(torch, lambda: knn_topk_ref(
            Vq, Vc, k, excl, sel, dist_dtype="bfloat16"), it_plain)
        bound, by = bound_ms(*knn_counts(Vq.shape[0], sel[-1], len(sel),
                                         Vq.shape[-1], Vc.shape[-1], k))
        times[case] = dict(kernel_ms=ms, plain_ms=plain, kernel_ms_bf16=ms_bf16,
                           plain_ms_bf16=plain_bf16,
                           bound_us=bound * 1e3, bound_by=by, S=Vq.shape[0],
                           Lq=Vq.shape[-1], Lc=Vc.shape[-1], k=k,
                           select_Es=list(sel))
    Lp11 = SUBJECT11_L - (E_MAX - 1) - 1  # 8508
    V11 = lag_batch(torch, dummy_brain(1, SUBJECT11_L, seed=3), Lp11, dev)
    ms = time_ms(torch, lambda: knn_topk(V11, V11, E_MAX + 1, True, all_E), 3)
    plain = time_ms(torch, lambda: knn_topk_ref(V11, V11, E_MAX + 1, True,
                                                all_E, tile_c=2048), 1, warmup=0)
    bound, by = bound_ms(*knn_counts(1, E_MAX, E_MAX, Lp11, Lp11, E_MAX + 1))
    times["subject11_one_series"] = dict(kernel_ms=ms, plain_ms=plain,
                                         bound_us=bound * 1e3, bound_by=by, S=1,
                                         Lq=Lp11, Lc=Lp11, k=E_MAX + 1,
                                         select_Es=list(all_E))
    emit("time_knn_topk", smi=smi, **times)

    # the significance path's prefix build: one chunk, its bucket set
    kp = sig_buckets[-1] + 1
    prefix_err = max(prefix_err, check_knn_prefix(
        torch, "sig_path_buckets", V8, V8, kp, True, sig_buckets, SIG_LIB_SIZES,
        col_ids))
    ms = time_ms(torch, lambda: knn_topk_prefix(V8, V8, kp, True, sig_buckets,
                                                SIG_LIB_SIZES, col_ids=col_ids), 20)
    plain = time_ms(torch, lambda: knn_topk_prefix_ref(
        V8, V8, kp, True, sig_buckets, SIG_LIB_SIZES, col_ids=col_ids), 2)
    prefix_bf16_err = max(prefix_bf16_err, check_knn_prefix(
        torch, "sig_path_buckets_bf16", V8, V8, kp, True, sig_buckets,
        SIG_LIB_SIZES, col_ids, "bfloat16"))
    ms_bf16 = time_ms(torch, lambda: knn_topk_prefix(
        V8, V8, kp, True, sig_buckets, SIG_LIB_SIZES, col_ids=col_ids,
        dist_dtype="bfloat16"), 20)
    plain_bf16 = time_ms(torch, lambda: knn_topk_prefix_ref(
        V8, V8, kp, True, sig_buckets, SIG_LIB_SIZES, col_ids=col_ids,
        dist_dtype="bfloat16"), 2)
    bound, by = bound_ms(*prefix_counts(V8.shape[0], sig_buckets[-1],
                                        len(sig_buckets), Lp, SIG_LIB_SIZES[-1],
                                        len(SIG_LIB_SIZES), kp))
    ptimes = dict(kernel_ms=ms, plain_ms=plain, kernel_ms_bf16=ms_bf16,
                  plain_ms_bf16=plain_bf16, bound_us=bound * 1e3, bound_by=by,
                  B=V8.shape[0], Lq=Lp, P=SIG_LIB_SIZES[-1],
                  lib_sizes=list(SIG_LIB_SIZES), k=kp, buckets=list(sig_buckets))
    emit("time_knn_topk_prefix", smi=smi, **ptimes)

    import torch.nn.functional as F

    # the chunk's 8 tables at Subject11's Lp, where the stream kernel
    # runs: real tables of Subject11-length series
    V11x8 = lag_batch(torch, dummy_brain(LIB_BLOCK, SUBJECT11_L, seed=3), Lp11, dev)
    idx11, sqd11 = knn_topk(V11x8, V11x8, E_MAX + 1, True, (E_MAX,))
    idx11, w11 = tknn.tables_with_weights_bucketed(idx11, sqd11, (E_MAX,))
    idx11, w11 = idx11[:, 0].contiguous(), w11[:, 0].contiguous()  # (8, 8508, 21)
    Y11 = torch.as_tensor(dummy_brain(TARGET_BLOCK, SUBJECT11_L, seed=9)
                          [:, E_MAX : E_MAX + Lp11]).to(dev).contiguous()
    del V11x8, sqd11
    lookup_err = max(lookup_err, check_lookup(torch, "subject11_chunk_tables",
                                              idx11, w11, Y11))
    ltimes = {}
    for case, (idx, w, Yc) in {"chunk_tables": (idx8, w8, Y),
                               "one_table": (idx8[0], w8[0], Y),
                               "subject11_chunk_tables": (idx11, w11, Y11)}.items():
        S, Lq = (1, idx.shape[0]) if idx.dim() == 2 else idx.shape[:2]
        ms = time_ms(torch, lambda: ccm_lookup(idx, w, Yc), 50)
        plain = time_ms(torch, lambda: ccm_lookup_ref(idx, w, Yc), 5)
        # one library call computing the same function: embedding_bag
        # over the transposed targets (the transpose is set-up, untimed)
        YT = Yc.t().contiguous()
        il, wl = idx.reshape(-1, idx.shape[-1]).long(), w.reshape(-1, w.shape[-1])
        lib_out = F.embedding_bag(il, YT, per_sample_weights=wl, mode="sum")
        want = ccm_lookup_ref(idx, w, Yc)
        lib_pred = lib_out.reshape(S, Lq, -1).transpose(1, 2).reshape(want.shape)
        lib_err = float((lib_pred - want).abs().max())
        del lib_out, want, lib_pred
        lib = time_ms(torch, lambda: F.embedding_bag(il, YT, per_sample_weights=wl,
                                                     mode="sum"), 50)
        bound, by = bound_ms(*lookup_counts(S, Yc.shape[0], Lq, Yc.shape[1],
                                            idx.shape[-1]))
        ltimes[case] = dict(kernel_ms=ms, plain_ms=plain, library_ms=lib,
                            library_max_abs_diff=lib_err, bound_us=bound * 1e3,
                            bound_by=by, S=S, B=Yc.shape[0], Lq=Lq, Lp=Yc.shape[1],
                            k=idx.shape[-1])
    del idx11, w11, Y11
    # the segmented launches of one phase-2 chunk at the main path's real
    # segment mix: the run's bucket plan cut into target blocks, the
    # chunk's tables at its bucket set
    from repro_torch.core import ccm as tccm

    bplan, _ = tccm.make_bucket_plan(main_optE)
    blocks = tccm.target_blocks(tuple(enumerate(bplan.counts)), TARGET_BLOCK)
    idxm, sqdm = knn_topk(V8, V8, kb, True, buckets)
    idxm, wm = tknn.tables_with_weights_bucketed(idxm, sqdm, buckets)
    Ym = torch.as_tensor(dummy_brain(bplan.n_targets, FISH1_L, seed=8)
                         [:, E_MAX : E_MAX + Lp]).to(dev).contiguous()

    def chunk_lookups(fn):
        return [fn(idxm, wm, Ym[b0:b1], segs) for b0, b1, segs in blocks]

    # the kernel against its plain version on these very launches
    got, want = chunk_lookups(ccm_lookup), chunk_lookups(ccm_lookup_ref)
    seg_err = max(float((g - r).abs().max()) for g, r in zip(got, want))
    seg_tol = 1e-6 * float(Ym.abs().max())
    emit("check_lookup", case="segmented_chunk_main_mix", idx_shape=list(idxm.shape),
         B=Ym.shape[0], Lp=Ym.shape[1], launches=len(blocks),
         segments=[len(sg) for _, _, sg in blocks], max_abs_err=seg_err, tol=seg_tol,
         bit_equal=all(same_bits(torch, g, r) for g, r in zip(got, want)))
    if not seg_err <= seg_tol:
        raise AssertionError(f"ccm_lookup kernel != plain version "
                             f"(segmented_chunk_main_mix): {seg_err} > {seg_tol}")
    lookup_err = max(lookup_err, seg_err)
    del got, want
    ms = time_ms(torch, lambda: chunk_lookups(ccm_lookup), 10)
    plain = time_ms(torch, lambda: chunk_lookups(ccm_lookup_ref), 1)
    bound, by = bound_ms(*segmented_counts(LIB_BLOCK, blocks, Lp, Lp, kb))
    ltimes["segmented_chunk"] = dict(
        kernel_ms=ms, launches=len(blocks), kernel_ms_per_launch=ms / len(blocks),
        plain_ms=plain, library_ms=None, bound_us=bound * 1e3, bound_by=by,
        S=LIB_BLOCK, n_buckets=len(buckets), B=bplan.n_targets, Lq=Lp, k=kb,
        segments_per_launch=[len(sg) for _, _, sg in blocks])
    emit("time_ccm_lookup", smi=smi, **ltimes)

    profile_paths(torch, dev, PROFILE_N, smi)

    # ---- engine check: cuda vs torch-reference ---------------------------
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig

    for case, n, L, ref_dev in (("card", CHECK_N, FISH1_L, dev),
                                ("cpu_reference", 24, 400, "cpu")):
        ts = dummy_brain(n, L, seed=4)
        got = run_causal_inference(ts, EDMConfig(E_max=E_MAX, engine="cuda"),
                                   device=dev)
        want = run_causal_inference(ts, EDMConfig(E_max=E_MAX,
                                                  engine="torch-reference"),
                                    device=ref_dev)
        optE_eq = bool(np.array_equal(got.optE, want.optE))
        err = float(np.abs(got.rho - want.rho).max())
        emit("engine_check", case=case, N=n, L=L, reference_device=str(ref_dev),
             optE_equal=optE_eq, rho_max_abs_err=err, tol=1e-5,
             simplex_rho_max_abs_err=float(np.abs(got.simplex_rho
                                                  - want.simplex_rho).max()))
        if not (optE_eq and err <= 1e-5):
            raise AssertionError(f"cuda engine != torch-reference ({case})")

    # ---- significance engine check: cuda vs torch-reference --------------
    from repro_torch.inference import SignificanceConfig, run_significance

    ts = dummy_brain(CHECK_N, FISH1_L, seed=6)
    cmap = run_causal_inference(ts, EDMConfig(E_max=E_MAX), device=dev)
    sig = SignificanceConfig(lib_sizes=SIG_LIB_SIZES, n_surrogates=SIG_CHECK_M,
                             alpha=0.05, seed=0)
    ref_cfg = EDMConfig(E_max=E_MAX, engine="torch-reference")
    got = run_significance(ts, cmap.optE, cmap.rho, EDMConfig(E_max=E_MAX), sig,
                           device=dev)
    want = run_significance(ts, cmap.optE, cmap.rho, ref_cfg, sig, device=dev)
    trend_tie, p_tie = sig_near_ties(torch, ts, cmap.optE, cmap.rho, ref_cfg, sig,
                                     dev)
    drho_err = float(np.abs(got.drho - want.drho).max())
    trend_bad = int((got.trend != want.trend)[~trend_tie].sum())
    p_bad = int((got.pvals != want.pvals)[~p_tie].sum())
    emit("sig_engine_check", N=CHECK_N, L=FISH1_L, m=SIG_CHECK_M,
         drho_max_abs_err=drho_err, tol=1e-5, near_tie=NEAR_TIE,
         trend_near_ties_skipped=int(trend_tie.sum()),
         p_near_ties_skipped=int(p_tie.sum()), trend_mismatches=trend_bad,
         p_mismatches=p_bad, trend_equal_all=bool(np.array_equal(got.trend,
                                                                 want.trend)),
         pvals_equal_all=bool(np.array_equal(got.pvals, want.pvals)),
         edges=[len(got.edges), len(want.edges)])
    if not (drho_err <= 1e-5 and trend_bad == 0 and p_bad == 0):
        raise AssertionError("cuda engine != torch-reference (significance)")

    # ---- the port's kNN bench (the slab kernel's path) and the dry runs
    # of Fish1_Normo and Subject11 at their own N and L
    bknn = bench_knn(torch, dev, smi)
    dry = dryrun_phase(torch, dev, smi)

    # ---- the fleet: W worker processes on the card, each with its own
    # context; what this process still holds on the card is released first
    del V8, V11, idx8, w8, Y, idxb, wb, Ym, idxm, wm, Vt, Vq1, Vc1, Vtie, Vconst
    del Vc_const, ts8, got, want, cmap
    gc.collect()
    torch.cuda.empty_cache()
    fleet = fleet_phases(torch, smi, args.n, args.sig_n, out_dir, launches,
                         sig_dir, sig_launches, wall_single, busy_single)
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(sig_dir, ignore_errors=True)

    # ---- the kernels line --------------------------------------------------
    k2, k1 = times["phase2"], times["phase1"]
    l8 = ltimes["chunk_tables"]
    slab64 = bknn["kernel_times"][str(max(int(lc) for lc in bknn["kernel_times"]))]
    dry_launches = {name: r["launches"] for name, r in dry.items()}
    line = {"kernels": [
        {"name": "knn_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/knn_topk/csrc/knn_topk.cu",
         "replaces": "src/repro/kernels/knn_topk/knn_topk.py:211",
         "launches": launches["knn_topk"],
         "launches_significance": sig_launches["knn_topk"], "max_abs_err": knn_err,
         "ms": k2["kernel_ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_us"] / 1e3,
         "bound_by": k2["bound_by"], "library_ms": None,
         "ms_phase1": k1["kernel_ms"],
         "plain_ms_phase1": k1["plain_ms"], "bound_ms_phase1": k1["bound_us"] / 1e3,
         "ms_bf16": k2["kernel_ms_bf16"], "plain_ms_bf16": k2["plain_ms_bf16"],
         "ms_phase1_bf16": k1["kernel_ms_bf16"],
         "plain_ms_phase1_bf16": k1["plain_ms_bf16"],
         "max_abs_err_bf16": knn_bf16_err,
         "launches_tiled_main_path": tiled_launches["knn_topk"],
         "launches_significance_tiled": sig_tiled_launches["knn_topk"],
         "launches_all_e": {k: v["launches"]["knn_topk"]
                            for k, v in all_e["runs"].items()},
         "launches_bf16_map": bf16_map["launches"]["knn_topk"],
         "launches_fleet": {k: v["knn_topk"] for k, v in fleet.items()},
         "launches_dryrun": {k: v["knn_topk"] for k, v in dry_launches.items()},
         "launches_bench_knn": bknn["launches"]["knn_topk"],
         "checked": True, "checked_bf16": True},
        {"name": "ccm_lookup", "route": "cuda",
         "source": "src/repro_torch/kernels/ccm_lookup/csrc/ccm_lookup.cu",
         "replaces": "src/repro/kernels/ccm_lookup/ccm_lookup.py:24",
         "launches": launches["ccm_lookup"],
         "launches_significance": sig_launches["ccm_lookup"],
         "max_abs_err": lookup_err,
         "ms": l8["kernel_ms"], "plain_ms": l8["plain_ms"],
         "bound_ms": l8["bound_us"] / 1e3,
         "bound_by": l8["bound_by"], "library_ms": l8["library_ms"],
         "ms_segmented_chunk": ltimes["segmented_chunk"]["kernel_ms"],
         "bound_ms_segmented_chunk": ltimes["segmented_chunk"]["bound_us"] / 1e3,
         "ms_subject11_Lp": ltimes["subject11_chunk_tables"]["kernel_ms"],
         "bound_ms_subject11_Lp":
             ltimes["subject11_chunk_tables"]["bound_us"] / 1e3,
         "launches_tiled_main_path": tiled_launches["ccm_lookup"],
         "launches_significance_tiled": sig_tiled_launches["ccm_lookup"],
         "launches_all_e": {k: v["launches"]["ccm_lookup"]
                            for k, v in all_e["runs"].items()},
         "launches_fleet": {k: v["ccm_lookup"] for k, v in fleet.items()},
         "launches_dryrun": {k: v["ccm_lookup"] for k, v in dry_launches.items()},
         "checked": True},
        {"name": "knn_topk_prefix", "route": "cuda",
         "source": "src/repro_torch/kernels/knn_topk/csrc/knn_topk_prefix.cu",
         "replaces": "src/repro/kernels/knn_topk/knn_topk.py:398",
         "launches": sig_launches["knn_topk_prefix"],
         "launches_significance": sig_launches["knn_topk_prefix"],
         "max_abs_err": prefix_err, "ms": ptimes["kernel_ms"],
         "plain_ms": ptimes["plain_ms"], "bound_ms": ptimes["bound_us"] / 1e3,
         "bound_by": ptimes["bound_by"], "library_ms": None,
         "ms_bf16": ptimes["kernel_ms_bf16"], "plain_ms_bf16": ptimes["plain_ms_bf16"],
         "max_abs_err_bf16": prefix_bf16_err,
         "launches_significance_tiled": sig_tiled_launches["knn_topk_prefix"],
         "launches_fleet": {k: v["knn_topk_prefix"] for k, v in fleet.items()},
         "checked": True, "checked_bf16": True},
        {"name": "flash_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn/flash_attn.py:26",
         "launches": serve["launches"]["flash_attn"],
         "launches_by_route": serve["launches_by_route"], "max_abs_err": flash_err,
         "ms": ftimes["kernel_ms"],
         "plain_ms": ftimes["plain_ms"],
         "bound_ms": ftimes["bound_ms"], "bound_by": ftimes["bound_by"],
         "library_ms": ftimes["library_ms"],
         "launches_fleet": {k: v["flash_attn"] for k, v in fleet.items()},
         "checked": True},
        {"name": "knn_slab", "route": "cuda",
         "source": "src/repro_torch/kernels/knn_slab/csrc/knn_slab.cu",
         "replaces": "benchmarks/run.py:476",
         "launches": bknn["launches"]["knn_slab"],
         "max_abs_err": max(slab_err, bknn["max_abs_err"]),
         "ms": slab64["kernel_ms"], "plain_ms": slab64["plain_ms"],
         "bound_ms": slab64["bound_ms"], "bound_by": slab64["bound_by"],
         "library_ms": None,
         "ms_by_Lc": {lc: t["kernel_ms"] for lc, t in bknn["kernel_times"].items()},
         "checked": True},
    ]}
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps(line), flush=True)
    print(card_line(dev), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
