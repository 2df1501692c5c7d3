#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card at the main path's
shapes, drives the main path (``repro_torch.launch.edm_run``) at the
series length and E_max of the paper's Fish1_Normo recording, checks the
map against the plain-version engine, and times every kernel with CUDA
events beside its bound, its plain version and (where one exists) one
PyTorch library call computing the same function.

Every phase prints one JSON line; the line before the last is the card's
name and power limit as nvidia-smi gives them, the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
so does a machine without a CUDA card, or a directory holding this file
and nothing else of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet): fp32 outside the
# tensor cores and HBM3 bandwidth.  The card's power limit is printed
# beside every number, since a card set below 700 W runs slower.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Fish1_Normo (the paper's smallest recording): L = 1450, E_max = 20.
FISH1_L, E_MAX = 1450, 20
# Subject11: the paper's longest library, L = 8528.
SUBJECT11_L = 8528
LIB_BLOCK = 8
TARGET_BLOCK = 2048
CHECK_N = 256  # series of the cuda vs torch-reference engine check
PROFILE_N = 512  # series of the profiled main-path run


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


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


def knn_bound_ms(S, E_hi, n_sel, Lq, Lc, k):
    """Least time on the card: 3 fp32 operations per (query, candidate,
    lag) against the fp32 peak, or the input + output bytes against the
    memory rate, whichever is larger."""
    ops = 3.0 * S * Lq * Lc * E_hi
    nbytes = 4.0 * S * E_hi * (Lq + Lc) + 8.0 * S * n_sel * Lq * k
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def lookup_bound_ms(S, B, Lq, Lp, k):
    """2 operations per (table, target, point, neighbour); bytes = idx + w
    read once, Y read once, the predictions written once."""
    ops = 2.0 * S * B * Lq * k
    nbytes = 8.0 * S * Lq * k + 4.0 * B * Lp + 4.0 * S * B * Lq
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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


def check_knn(torch, name, Vq, Vc, k, exclude_self, select_Es):
    """Kernel vs plain version on the card: idx equal, dist bit-equal."""
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_topk.ref import knn_topk_ref

    ki, kd = knn_topk(Vq, Vc, k, exclude_self, select_Es)
    torch.cuda.synchronize()
    ri, rd = knn_topk_ref(Vq, Vc, k, exclude_self, select_Es)
    idx_eq = bool(torch.equal(ki, ri))
    bits_eq = same_bits(torch, kd, rd)
    err = finite_max_abs(torch, kd, rd)
    emit("check_knn", case=name, shape=list(Vq.shape) + [Vc.shape[-1]], k=k,
         exclude_self=exclude_self, select_Es=list(select_Es),
         idx_equal=idx_eq, dist_bits_equal=bits_eq, max_abs_err=err)
    if not (idx_eq and bits_eq):
        bad = (ki != ri).nonzero()[:5].tolist()
        raise AssertionError(f"knn_topk kernel != plain version ({name}); first "
                             f"differing idx positions {bad}")
    return err


def check_lookup(torch, name, idx, w, Y):
    """Kernel vs plain version: |diff| <= 1e-6 * max|Y| (see docs/PORT.md)."""
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref

    got = ccm_lookup(idx, w, Y)
    torch.cuda.synchronize()
    want = ccm_lookup_ref(idx, w, Y)
    err = float((got - want).abs().max())
    tol = 1e-6 * float(Y.abs().max())
    emit("check_lookup", case=name, idx_shape=list(idx.shape), B=Y.shape[0],
         Lp=Y.shape[1], max_abs_err=err, tol=tol,
         bit_equal=same_bits(torch, got, want))
    if not err <= tol:
        raise AssertionError(f"ccm_lookup kernel != plain version ({name}): "
                             f"{err} > {tol}")
    return err


def profile_main_path(torch, dev, n, smi):
    """Trace one in-process main-path run (no store) with torch.profiler:
    the device's busy share of the wall time and device time by kernel.
    Kernels run on one stream, so their device times add up without
    overlap."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain

    ts = dummy_brain(n, FISH1_L, seed=5)
    cfg = EDMConfig(E_max=E_MAX)
    run_causal_inference(ts[: 2 * LIB_BLOCK], cfg, device=dev)  # warm-up
    torch.cuda.synchronize()
    timings: dict = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_causal_inference(ts, cfg, device=dev, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    emit("profile", N=n, L=FISH1_L, wall_s=wall, **timings,
         device_busy_s=busy_s, device_busy_share=busy_s / wall,
         top=[{"name": k[:90], "device_s": us / 1e6, "calls": c}
              for us, k, c in rows[:12]], smi=smi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=16384,
                    help="series in the end-to-end run (Fish1_Normo has 53,053)")
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
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # ---- build -----------------------------------------------------------
    from repro_torch import kernels

    t0 = time.perf_counter()
    report = kernels.build_all()
    emit("build", seconds=time.perf_counter() - t0, kernels=report)

    from repro_torch.core import knn as tknn
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref
    from repro_torch.kernels.knn_topk.ops import knn_topk
    from repro_torch.kernels.knn_topk.ref import knn_topk_ref
    from repro_torch.launch import edm_run

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

    # ---- the main path; the launch counts start at 0 here ---------------
    out_dir = ROOT / "build" / "smoke_out"
    shutil.rmtree(out_dir, ignore_errors=True)
    knn_topk.LAUNCHES = 0
    ccm_lookup.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    log = io.StringIO()  # one progress line per chunk: keep it off stdout
    with contextlib.redirect_stdout(log):
        summary = edm_run.main(["--synthetic", f"{args.n}x{FISH1_L}", "--e-max",
                                str(E_MAX), "--out", str(out_dir)])
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
    emit("end_to_end", N=args.n, L=FISH1_L, E_max=E_MAX, lib_block=LIB_BLOCK,
         n_cut_from=53053, wall_s=summary["wall_s"],
         phase1_s=summary["phase1_s"], phase2_s=summary["phase2_s"],
         assemble_s=summary["assemble_s"],
         cross_maps_per_s=summary["cross_maps_per_s"],
         peak_device_bytes=peak_mem, buckets=list(buckets),
         launches=launches, rho_mean=float(rho.mean()),
         rho_absmax=float(np.abs(rho).max()), smi=smi)
    del result, rho
    shutil.rmtree(out_dir, ignore_errors=True)

    # ---- times with CUDA events at the main path's shapes ---------------
    kb = buckets[-1] + 1
    Vq1, Vc1 = V8[..., Lh:].contiguous(), V8[..., :Lh].contiguous()
    times = {}
    for case, (Vq, Vc, k, excl, sel, it, it_plain) in {
        "phase2": (V8, V8, kb, True, buckets, 20, 2),
        "phase1": (Vq1, Vc1, E_MAX + 1, False, all_E, 20, 2),
    }.items():
        ms = time_ms(torch, lambda: knn_topk(Vq, Vc, k, excl, sel), it)
        plain = time_ms(torch, lambda: knn_topk_ref(Vq, Vc, k, excl, sel), it_plain)
        bound, by = knn_bound_ms(Vq.shape[0], sel[-1], len(sel), Vq.shape[-1],
                                 Vc.shape[-1], k)
        times[case] = dict(kernel_ms=ms, plain_ms=plain, bound_us=bound * 1e3,
                           bound_by=by, S=Vq.shape[0], Lq=Vq.shape[-1],
                           Lc=Vc.shape[-1], k=k, select_Es=list(sel))
    Lp11 = SUBJECT11_L - (E_MAX - 1) - 1  # 8508
    V11 = lag_batch(torch, dummy_brain(1, SUBJECT11_L, seed=3), Lp11, dev)
    ms = time_ms(torch, lambda: knn_topk(V11, V11, E_MAX + 1, True, all_E), 3)
    plain = time_ms(torch, lambda: knn_topk_ref(V11, V11, E_MAX + 1, True,
                                                all_E, tile_c=2048), 1, warmup=0)
    bound, by = knn_bound_ms(1, E_MAX, E_MAX, Lp11, Lp11, E_MAX + 1)
    times["subject11_one_series"] = dict(kernel_ms=ms, plain_ms=plain,
                                         bound_us=bound * 1e3, bound_by=by, S=1,
                                         Lq=Lp11, Lc=Lp11, k=E_MAX + 1,
                                         select_Es=list(all_E))
    emit("time_knn_topk", smi=smi, **times)

    import torch.nn.functional as F

    ltimes = {}
    for case, (idx, w) in {"chunk_tables": (idx8, w8),
                           "one_table": (idx8[0], w8[0])}.items():
        S = 1 if idx.dim() == 2 else idx.shape[0]
        ms = time_ms(torch, lambda: ccm_lookup(idx, w, Y), 50)
        plain = time_ms(torch, lambda: ccm_lookup_ref(idx, w, Y), 5)
        # one library call computing the same function: embedding_bag
        # over the transposed targets (the transpose is set-up, untimed)
        YT = Y.t().contiguous()
        il, wl = idx.reshape(-1, idx.shape[-1]).long(), w.reshape(-1, w.shape[-1])
        lib_out = F.embedding_bag(il, YT, per_sample_weights=wl, mode="sum")
        want = ccm_lookup_ref(idx, w, Y)
        lib_pred = lib_out.reshape(S, Lp, -1).transpose(1, 2).reshape(want.shape)
        lib_err = float((lib_pred - want).abs().max())
        lib = time_ms(torch, lambda: F.embedding_bag(il, YT, per_sample_weights=wl,
                                                     mode="sum"), 50)
        bound, by = lookup_bound_ms(S, Y.shape[0], Lp, Lp, idx.shape[-1])
        ltimes[case] = dict(kernel_ms=ms, plain_ms=plain, library_ms=lib,
                            library_max_abs_diff=lib_err, bound_us=bound * 1e3,
                            bound_by=by, S=S, B=Y.shape[0], Lq=Lp, k=idx.shape[-1])
    emit("time_ccm_lookup", smi=smi, **ltimes)

    profile_main_path(torch, dev, PROFILE_N, smi)

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

    # ---- the kernels line --------------------------------------------------
    k2 = times["phase2"]
    l8 = ltimes["chunk_tables"]
    line = {"kernels": [
        {"name": "knn_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/knn_topk/csrc/knn_topk.cu",
         "replaces": "src/repro/kernels/knn_topk/knn_topk.py:211",
         "launches": launches["knn_topk"], "max_abs_err": knn_err,
         "ms": k2["kernel_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_us"] / 1e3,
         "bound_by": k2["bound_by"], "library_ms": None, "checked": True},
        {"name": "ccm_lookup", "route": "cuda",
         "source": "src/repro_torch/kernels/ccm_lookup/csrc/ccm_lookup.cu",
         "replaces": "src/repro/kernels/ccm_lookup/ccm_lookup.py:24",
         "launches": launches["ccm_lookup"], "max_abs_err": lookup_err,
         "ms": l8["kernel_ms"], "plain_ms": l8["plain_ms"],
         "bound_ms": l8["bound_us"] / 1e3,
         "bound_by": l8["bound_by"], "library_ms": l8["library_ms"],
         "checked": True},
    ]}
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps(line), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
