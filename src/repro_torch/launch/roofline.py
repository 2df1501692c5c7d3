"""Roofline terms of the port on one NVIDIA H100, from analytical counts.

The JAX package's ``launch/roofline.py`` reads FLOPs and bytes from XLA's
``cost_analysis`` of a compiled TPU program.  PyTorch has no such
analysis, so here every count is analytical, from each kernel's shapes:
the operations it must do and the bytes it must move, each input read
once and each output written once.  Where the work depends on the data
(the slab skips its padding columns) the count follows this call's
inputs.

  compute term = operations / peak rate of their type
  memory term  = bytes / HBM rate

One card, so no interconnect term.  Peaks: NVIDIA's H100 SXM data sheet
(dense rates, at the full 700 W power limit; a card set lower runs
slower, so every measurement prints the card's limit beside it).
"""
from __future__ import annotations

import dataclasses

#: fp32 outside the tensor cores (the kNN, slab and lookup kernels' type)
PEAK_FP32_FLOPS = 67e12
#: bf16 dense on the tensor cores (the flash-attention kernel's)
PEAK_BF16_FLOPS = 989e12
#: HBM3
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass
class Roofline:
    """The least time of ``flops`` operations at ``peak_flops`` and
    ``bytes`` moved at the HBM rate, and which of the two bounds it."""

    flops: float
    bytes: float
    peak_flops: float = PEAK_FP32_FLOPS

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes / HBM_BYTES_PER_S

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory)

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def roofline_fraction(self) -> float:
        """t_compute / the larger term: 1.0 where compute bounds it."""
        return self.t_compute / max(self.t_bound, 1e-30)

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "peak_flops": self.peak_flops,
            "hbm_bytes_per_s": HBM_BYTES_PER_S,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
        }


def bound_ms(ops: float, nbytes: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """(least time in ms, "operations" or "bytes": the term that sets it),
    as ``bound_ms(*knn_counts(...))``."""
    rl = Roofline(ops, nbytes, peak_flops)
    return rl.t_bound * 1e3, ("operations" if rl.bottleneck == "compute"
                              else "bytes")


# ------------------------------------------------------- per-kernel counts
def knn_counts(S, E_hi, n_sel, Lq, Lc, k) -> tuple[float, float]:
    """``knn_topk``: 3 fp32 operations per (query, candidate, lag); the
    lag rows read once, the n_sel tables (int32 id + float32 distance)
    written once."""
    ops = 3.0 * S * Lq * Lc * E_hi
    nbytes = 4.0 * S * E_hi * (Lq + Lc) + 8.0 * S * n_sel * Lq * k
    return ops, nbytes


def lookup_counts(S, B, Lq, Lp, k) -> tuple[float, float]:
    """``ccm_lookup``: 2 operations per (table, target, point, neighbour);
    idx + w read once, the targets once, the predictions written once."""
    ops = 2.0 * S * B * Lq * k
    nbytes = 8.0 * S * Lq * k + 4.0 * B * Lp + 4.0 * S * B * Lq
    return ops, nbytes


def segmented_counts(S, blocks, Lq, Lp, k) -> tuple[float, float]:
    """A run of segmented ``ccm_lookup`` launches, blocks ((b0, b1, segs),
    ...): per launch the idx and w rows of the distinct table rows it
    reads, its targets and its output."""
    ops = nbytes = 0.0
    for _, _, segs in blocks:
        B = sum(c for _, c in segs)
        ops += 2.0 * S * B * Lq * k
        nbytes += (8.0 * S * Lq * k * len({r for r, _ in segs}) + 4.0 * B * Lp
                   + 4.0 * S * B * Lq)
    return ops, nbytes


def prefix_counts(B, E_hi, n_sel, Lq, P, S, k) -> tuple[float, float]:
    """``knn_topk_prefix``: 3 fp32 operations per (query, swept position,
    lag); the swept columns and the queries read once, col_ids once, the
    S table snapshots written once."""
    ops = 3.0 * B * Lq * P * E_hi
    nbytes = 4.0 * B * E_hi * (Lq + P) + 4.0 * P + 8.0 * B * S * n_sel * Lq * k
    return ops, nbytes


def slab_counts(E_max, Lq, Lc, k) -> tuple[float, float]:
    """``knn_slab``: 3 fp32 operations per (query, real column, lag) --
    the padding columns need no distance --; the lag rows read once, the
    E_max tables written once."""
    ops = 3.0 * Lq * Lc * E_max
    nbytes = 4.0 * E_max * (Lq + Lc) + 8.0 * E_max * Lq * k
    return ops, nbytes


def flash_counts(B, S, H, K, dh, nbytes_el) -> tuple[float, float]:
    """Causal ``flash_attn``: 4 dh operations per (query, key <= query,
    head) -- q k and p v --; q, k, v read and o written once."""
    ops = 4.0 * B * H * dh * S * (S + 1) / 2
    nbytes = nbytes_el * B * S * dh * (2 * H + 2 * K)
    return ops, nbytes


def pearson_counts(S, N, Lq) -> tuple[float, float]:
    """Pearson of (S, N, Lq) predictions against (N, Lq) targets: 8
    operations per (row, target, point) (two centrings, three products,
    three sums); both read once, the (S, N) rho written once."""
    return 8.0 * S * N * Lq, 4.0 * (N * Lq + S * N * Lq + S * N)


# ------------------------------------------------------ one pipeline chunk
def edm_chunk_counts(S, N, L, E_max, buckets, blocks) -> dict[str, tuple[float, float]]:
    """(operations, bytes) of each kernel-sized step of one chunk of S
    library series: phase 1 (all-E tables of the second half of each
    series against its first half, the forecasts, their Pearson) and
    bucketed phase 2 against N targets (one ``knn_topk`` over the bucket
    set, the segmented lookups of ``blocks`` -- ``core/ccm.py::
    target_blocks`` of the bucket plan --, their Pearson).  ``buckets``
    is the ascending bucket E set; L the series length."""
    Lp = L - (E_max - 1) - 1
    Lh = Lp // 2
    Lq1 = Lp - Lh
    k1, kb = E_max + 1, buckets[-1] + 1
    return {
        "phase1_knn": knn_counts(S, E_max, E_max, Lq1, Lh, k1),
        "phase1_forecast": (2.0 * S * E_max * Lq1 * k1,
                            8.0 * S * E_max * Lq1 * k1 + 4.0 * S * Lh
                            + 4.0 * S * E_max * Lq1),
        "phase1_pearson": (8.0 * S * E_max * Lq1,
                           4.0 * (S * Lq1 + S * E_max * Lq1 + S * E_max)),
        "phase2_knn": knn_counts(S, buckets[-1], len(buckets), Lp, Lp, kb),
        "phase2_lookup": segmented_counts(S, blocks, Lp, Lp, kb),
        "phase2_pearson": pearson_counts(S, N, Lp),
    }


def roofline_of(counts: dict[str, tuple[float, float]]) -> Roofline:
    """The summed counts as one fp32 roofline."""
    return Roofline(sum(c[0] for c in counts.values()),
                    sum(c[1] for c in counts.values()))
