"""Hand-written CUDA kernels of the port, built at first use.

Each kernel lives in ``kernels/<name>/csrc/<name>.cu`` with a plain C
entry point.  :func:`load_library` compiles it with ``nvcc`` for
``sm_90a`` into ``<repo>/build/kernels/`` (git-ignored) and loads it
with ``ctypes``; the library file name carries a hash of the source and
the flags, so an edited source rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them.  Nothing here runs at import time: the CPU tests import
every module of the port on a machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
_HERE = pathlib.Path(__file__).resolve().parent

#: kernel name -> CUDA source
KERNEL_SOURCES = {
    "knn_topk": _HERE / "knn_topk" / "csrc" / "knn_topk.cu",
    "knn_topk_prefix": _HERE / "knn_topk" / "csrc" / "knn_topk_prefix.cu",
    "ccm_lookup": _HERE / "ccm_lookup" / "csrc" / "ccm_lookup.cu",
    "flash_attn": _HERE / "flash_attn" / "csrc" / "flash_attn.cu",
    "knn_slab": _HERE / "knn_slab" / "csrc" / "knn_slab.cu",
}

#: ``--fmad=false`` keeps every multiply and add rounded on its own, the
#: float sequence the bit-identity contract of the kNN distances rests on.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str | None:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    return None


def kernels_available() -> bool:
    """True where the kernels can run: a CUDA card and a compiler (or
    libraries already built for the current sources)."""
    if not torch.cuda.is_available():
        return False
    return nvcc_path() is not None or all(
        library_path(n).exists() for n in KERNEL_SOURCES
    )


def library_path(name: str) -> pathlib.Path:
    src = KERNEL_SOURCES[name].read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start_build(name: str):
    """Start nvcc for one kernel; None when its library is current."""
    out = library_path(name)
    if out.exists():
        return None
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build the {name} kernel: no nvcc (set CUDA_HOME or put "
            "nvcc on PATH)"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp-{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_SOURCES[name])]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def build_all() -> dict[str, dict]:
    """Build every kernel library in parallel (one nvcc per source).
    Returns {name: {"seconds", "cached", "ptxas"}}."""
    t0 = time.perf_counter()
    jobs = {name: _start_build(name) for name in KERNEL_SOURCES}
    report = {}
    for name, job in jobs.items():
        log = _finish_build(name, job) if job is not None else None
        if log is None:
            lp = library_path(name).with_suffix(".log")
            log = lp.read_text() if lp.exists() else ""
        report[name] = {
            "seconds": time.perf_counter() - t0,
            "cached": job is None,
            "ptxas": [ln.strip() for ln in log.splitlines() if "ptxas info" in ln],
        }
    return report


def load_library(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        job = _start_build(name)
        if job is not None:
            _finish_build(name, job)
        lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, rc: int, lib: ctypes.CDLL) -> None:
    """Raise on a non-zero return of a kernel's C entry point: negative
    codes are argument checks of the entry point, positive ones CUDA
    errors (``cudaGetLastError()`` right after the launch)."""
    if rc == 0:
        return
    if rc > 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")
    raise RuntimeError(f"{name} kernel refused its arguments (code {rc})")
