"""EDM configuration and result types of the port.

The fields, defaults and validation are those of ``repro.core.types``;
only ``engine`` names the port's engines (``repro_torch.engine``):
``"cuda"`` (the default: hand-written kernels for CUDA tensors) or
``"torch-reference"`` (the plain PyTorch versions on any device).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

#: JAX engine name -> port engine name (see :func:`config_from_jax`).
_ENGINE_FROM_JAX = {
    "reference": "torch-reference",
    "pallas-interpret": "cuda",
    "pallas-compiled": "cuda",
}


@dataclasses.dataclass(frozen=True)
class EDMConfig:
    """Configuration of one causal-inference run (paper §III).

    Attributes (as in the JAX package unless noted):
      E_max: maximum embedding dimension swept in simplex projection.
      tau: delay-embedding lag.
      Tp: prediction horizon in time steps.
      exclude_self: mask the zero-distance self neighbour when library ==
        target (cppEDM exclusionRadius semantics).
      lib_block: library series per chunk in phase 1 and phase 2.
      target_block: targets per CCM lookup call.
      engine: port engine key: "cuda" (default) or "torch-reference".
      bucketed: phase-2 CCM with optE-bucketed tables.
      stream_depth: phase-2 chunks in flight (2 = double buffering).
      target_tile: phase-2 and significance column tile width (0 = untiled).
      use_kernels: DEPRECATED alias — True selects engine="cuda", False
        engine="torch-reference".
      knn_impl: accumulation variant of the JAX dense oracle; kept so the
        two configs carry the same fields (the port's dense oracle has one
        cumulative form).
      dist_dtype: distance accumulator of the kNN tables, "float32" or
        "bfloat16" (both kNN kernels take either).
      knn_tile_c: candidate-tile width of the plain streaming kNN
        table functions: 0 = calibrated (``core/knn.py``), > 0 = forced.  Every
        width gives the same tables.
      k_override: pins the neighbour-table width (None = unset).
    """

    E_max: int = 20
    tau: int = 1
    Tp: int = 1
    exclude_self: bool = True
    lib_block: int = 8
    target_block: int = 2048
    engine: str = "cuda"
    bucketed: bool = True
    stream_depth: int = 2
    target_tile: int = 0
    use_kernels: Optional[bool] = None
    knn_impl: str = "blocked:4"
    dist_dtype: str = "float32"
    knn_tile_c: int = 0
    k_override: Optional[int] = None

    def __post_init__(self):
        if self.use_kernels is not None:
            warnings.warn(
                "EDMConfig.use_kernels is deprecated; pass engine='cuda' "
                "(True) or engine='torch-reference' (False) instead",
                DeprecationWarning,
                stacklevel=3,
            )
            want = "cuda" if self.use_kernels else "torch-reference"
            if self.engine not in ("cuda", want):
                raise ValueError(
                    f"conflicting config: use_kernels={self.use_kernels} "
                    f"implies engine={want!r} but engine={self.engine!r} "
                    "was passed; drop use_kernels"
                )
            object.__setattr__(self, "engine", want)
            object.__setattr__(self, "use_kernels", None)
        if self.stream_depth < 1:
            raise ValueError("stream_depth must be >= 1")
        if self.target_tile < 0:
            raise ValueError("target_tile must be >= 0 (0 = untiled)")
        if self.knn_tile_c == -1:
            raise ValueError(
                "knn_tile_c=-1 (the removed dense distance-matrix "
                "selection path) is deprecated: selection is always "
                "streaming; pass 0 (auto-calibrated tile width) or a "
                "positive tile width"
            )
        if self.knn_tile_c < 0:
            raise ValueError(
                f"knn_tile_c={self.knn_tile_c} is invalid: 0 = "
                "auto-calibrated tile width, > 0 = forced tile width"
            )
        if self.k_override is not None and self.k_override < 1:
            raise ValueError(
                f"k_override={self.k_override} is invalid: pass None (unset; "
                "k tracks E_max / the bucket set) or a positive table width"
            )

    @property
    def k_max(self) -> int:
        # Simplex uses E+1 neighbours for embedding dimension E.
        return self.k_override if self.k_override is not None else self.E_max + 1

    def n_points(self, L: int) -> int:
        """Embeddable points of a length-L series (aligned present-time
        indexing shared by every E)."""
        return L - (self.E_max - 1) * self.tau - self.Tp


@dataclasses.dataclass
class CausalMap:
    """Output of the pipeline: rho[i, j] = skill of cross-mapping target j
    from library i's reconstructed manifold (j "CCM-causes" i when high)."""

    rho: "numpy.ndarray"  # (N, N) float32
    optE: "numpy.ndarray"  # (N,) int32
    simplex_rho: Optional["numpy.ndarray"] = None  # (N, E_max)


def config_from_jax(d: dict) -> EDMConfig:
    """Port config from ``dataclasses.asdict`` of a JAX ``EDMConfig``.

    Every field is kept; the engine is mapped: ``reference`` ->
    ``torch-reference``, ``pallas-*`` -> ``cuda``.  A name that is
    already a port engine passes through.
    """
    fields = {f.name for f in dataclasses.fields(EDMConfig)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"config fields not in the port's EDMConfig: {sorted(unknown)}")
    kw = dict(d)
    if "engine" in kw:
        kw["engine"] = _ENGINE_FROM_JAX.get(kw["engine"], kw["engine"])
    return EDMConfig(**kw)
