"""The knn_slab kernel against an earlier design of it, in turns on one card.

    git show <commit>:src/repro_torch/kernels/knn_slab/csrc/knn_slab.cu \\
        > build/parent/knn_slab.cu
    PYTHONPATH=src python -m repro_torch.bench.slab_ab \\
        --parent-source build/parent/knn_slab.cu

``--parent-source`` is a ``knn_slab.cu`` with the first design's C entry
point, ``knn_slab_launch(vq, vc, slab, idx, dist, E_max, Lq, Lc, k,
exclude_self, stream)`` with ``slab`` an (Lq, Lc_pad) float32 workspace.
It is built with the port's flags (``kernels.NVCC_FLAGS``) into
``build/kernels/``.  At each library length of the ``knn`` bench (its
card sizes: Lq 128, E_max 20, k 21, the bench's series) both kernels run
once and must agree bit for bit with each other and with the plain
version; then each is timed with CUDA events, ``--iters`` launches a
turn, in the order parent, current, current, parent.  Prints one JSON
line per library length and a summary with the card's ``nvidia-smi``
name and power limit, and writes the summary to ``--out``.  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

import torch

from repro_torch import kernels
from repro_torch.kernels.knn_slab.ref import padded_width

_PARENT_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def build_parent(source: pathlib.Path) -> ctypes.CDLL:
    """Compile ``source`` with the port's flags (cached by content)."""
    nvcc = kernels.nvcc_path()
    if nvcc is None:
        raise RuntimeError("slab_ab: no nvcc (set CUDA_HOME or put nvcc on PATH)")
    h = hashlib.sha256(source.read_bytes()
                       + " ".join(kernels.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = kernels.BUILD_DIR / f"libknn_slab_parent-{h}.so"
    if not out.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-o", str(out), str(source)],
                       check=True)
    lib = ctypes.CDLL(str(out))
    lib.knn_slab_launch.argtypes = _PARENT_ARGTYPES
    lib.knn_slab_launch.restype = ctypes.c_int
    return lib


def parent_slab(lib, Vq, Vc, k, exclude_self):
    E_max, Lq = Vq.shape
    Lc = Vc.shape[1]
    slab = torch.empty((Lq, padded_width(Lc)), dtype=torch.float32, device=Vq.device)
    idx = torch.empty((E_max, Lq, k), dtype=torch.int32, device=Vq.device)
    dist = torch.empty((E_max, Lq, k), dtype=torch.float32, device=Vq.device)
    rc = lib.knn_slab_launch(Vq.data_ptr(), Vc.data_ptr(), slab.data_ptr(),
                             idx.data_ptr(), dist.data_ptr(), E_max, Lq, Lc, k,
                             int(exclude_self), kernels.current_stream(Vq.device))
    if rc != 0:
        raise RuntimeError(f"slab_ab: the parent kernel returned {rc}")
    return idx, dist


def events_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-source", type=pathlib.Path, required=True)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", type=pathlib.Path,
                    default=kernels.REPO_ROOT / "build" / "bench" / "slab_ab.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("slab_ab: needs a CUDA card (the kernels have no CPU mode)")

    from repro_torch.bench import run as brun
    from repro_torch.core import embedding
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.kernels.knn_slab.ops import knn_slab, reset_route_counts, route_counts
    from repro_torch.kernels.knn_slab.ref import knn_slab_ref
    from repro_torch.runtime.device import card_line

    dev = torch.device("cuda", 0)
    smi = card_line(dev)
    parent = build_parent(args.parent_source)
    sizes = brun.SIZES["knn"]["card"]
    E, Lq, k = sizes["E_max"], sizes["Lq"], sizes["k"]
    pair = torch.as_tensor(dummy_brain(2, max(sizes["Lc_sweep"]) + E + 1,
                                       seed=3)).to(dev)
    Vq = embedding.lag_matrix(pair[0], E, 1, Lq).contiguous()
    rows = {}
    for Lc in sizes["Lc_sweep"]:
        Vc = embedding.lag_matrix(pair[1], E, 1, Lc).contiguous()
        reset_route_counts()
        ni, nd = knn_slab(Vq, Vc, k, False)
        routes = route_counts()
        pi, pd = parent_slab(parent, Vq, Vc, k, False)
        ri, rd = knn_slab_ref(Vq, Vc, k, False)
        equal = all(torch.equal(a, b) for a, b in (
            (ni, pi), (ni, ri), (nd.view(torch.int32), pd.view(torch.int32)),
            (nd.view(torch.int32), rd.view(torch.int32))))
        if not equal:
            raise AssertionError(f"slab_ab: the two designs or the plain version "
                                 f"disagree at Lc={Lc}")
        turns = {"parent": [], "current": []}
        for who in ("parent", "current", "current", "parent"):
            fn = ((lambda: parent_slab(parent, Vq, Vc, k, False)) if who == "parent"
                  else (lambda: knn_slab(Vq, Vc, k, False)))
            turns[who].append(events_ms(fn, args.iters))
        rows[str(Lc)] = dict(Lc=Lc, parent_ms=turns["parent"],
                             current_ms=turns["current"], routes=routes,
                             bit_equal=True)
        print(json.dumps({"Lc": Lc, **rows[str(Lc)]}), flush=True)
    out = dict(bench="knn_slab_ab", card=smi, device=torch.cuda.get_device_name(0),
               E_max=E, Lq=Lq, k=k, iters=args.iters,
               parent_source=str(args.parent_source), order="parent, current, "
               "current, parent", rows=rows)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
