"""Causal significance stage of the port: turns raw rho maps into
statistically validated causal graphs — one-sweep convergence CCM over
prefix-snapshot kNN tables, batched surrogate null models, and
FDR-controlled significance masking — on one device.  The counterpart of
``repro.inference``; ``finalize_significance`` is the fleet's finalize
unit."""
from repro_torch.inference.convergence import (
    ccm_convergence_pair,
    convergence_stats,
    subsample_permutation,
)
from repro_torch.inference.pipeline import (
    SignificanceChunkRunner,
    finalize_significance,
    run_significance,
)
from repro_torch.inference.significance import (
    assemble_edges,
    bh_adjust,
    bh_threshold,
    bh_threshold_discrete,
)
from repro_torch.inference.surrogates import (
    phase_randomized,
    random_shuffle,
    surrogate_futures,
)
from repro_torch.inference.types import (
    EDGE_DTYPE,
    SignificanceConfig,
    SignificanceResult,
)

__all__ = [
    "EDGE_DTYPE",
    "SignificanceChunkRunner",
    "SignificanceConfig",
    "SignificanceResult",
    "assemble_edges",
    "bh_adjust",
    "bh_threshold",
    "bh_threshold_discrete",
    "ccm_convergence_pair",
    "convergence_stats",
    "finalize_significance",
    "phase_randomized",
    "random_shuffle",
    "run_significance",
    "subsample_permutation",
    "surrogate_futures",
]
