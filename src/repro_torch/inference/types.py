"""Configuration and result types of the port's significance stage.

The fields, defaults and validation are those of
``repro.inference.types``; :func:`sig_config_from_jax` carries a JAX
config across, as ``core.types.config_from_jax`` does for ``EDMConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

SURROGATE_KINDS = ("phase", "shuffle")


@dataclasses.dataclass(frozen=True)
class SignificanceConfig:
    """One significance pass over a causal map.

    Attributes:
      lib_sizes: ascending library sizes of the convergence diagnostic —
        nested prefixes of a seeded random permutation of the library
        points.  Empty = skip the convergence stage.
      n_surrogates: null-model surrogates per target series.  0 = skip
        the surrogate/p-value stage.
      alpha: Benjamini–Hochberg FDR level for the edge mask.
      surrogate: null model — "phase" (FFT phase-randomized: preserves
        the power spectrum, destroys nonlinear coupling) or "shuffle"
        (random permutation: preserves only the amplitude distribution).
      seed: single root seed; one threefry key derived from it
        (``inference/prng.py``) drives BOTH the convergence subsampling
        permutation and every surrogate draw (per-target ``fold_in``, so
        results are independent of chunk geometry).
    """

    lib_sizes: tuple[int, ...] = ()
    n_surrogates: int = 20
    alpha: float = 0.05
    surrogate: str = "phase"
    seed: int = 0

    def __post_init__(self):
        if list(self.lib_sizes) != sorted(set(self.lib_sizes)):
            raise ValueError(
                f"lib_sizes must be ascending and distinct: {self.lib_sizes}"
            )
        if self.n_surrogates < 0:
            raise ValueError("n_surrogates must be >= 0")
        if not (0.0 < self.alpha <= 1.0):
            raise ValueError(f"alpha={self.alpha} must be in (0, 1]")
        if self.surrogate not in SURROGATE_KINDS:
            raise ValueError(
                f"surrogate={self.surrogate!r}; known: {SURROGATE_KINDS}"
            )


#: dtype of one row of the persisted edge list (edges/data.npy): src
#: CCM-causes dst (src = target/column axis, dst = library/row axis of
#: the rho map — rho[dst, src] is the cross-map skill backing the edge).
EDGE_DTYPE = np.dtype(
    [
        ("src", np.int32),
        ("dst", np.int32),
        ("rho", np.float32),
        ("drho", np.float32),
        ("trend", np.float32),
        ("pval", np.float32),
    ]
)


@dataclasses.dataclass
class SignificanceResult:
    """Output of :func:`repro_torch.inference.pipeline.run_significance`.

    drho/trend are the convergence statistic maps (rho_max - rho_min and
    the Kendall-style monotonic-trend score of the rho-vs-library-size
    curve); pvals the per-pair surrogate p-values; edges the
    FDR-surviving edge list (EDGE_DTYPE).  Maps may be disk-backed
    memmaps when an output store was used; entries are None when the
    corresponding stage was skipped.
    """

    drho: Optional[np.ndarray]
    trend: Optional[np.ndarray]
    pvals: Optional[np.ndarray]
    edges: Optional[np.ndarray]
    p_threshold: float = 0.0
    n_tests: int = 0


def sig_config_from_jax(d: dict) -> SignificanceConfig:
    """Port config from ``dataclasses.asdict`` of a JAX
    ``SignificanceConfig``; every field is kept (``lib_sizes`` as a
    tuple)."""
    fields = {f.name for f in dataclasses.fields(SignificanceConfig)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(
            f"config fields not in the port's SignificanceConfig: {sorted(unknown)}"
        )
    kw = dict(d)
    if "lib_sizes" in kw:
        kw["lib_sizes"] = tuple(int(s) for s in kw["lib_sizes"])
    return SignificanceConfig(**kw)
