"""Engine registry of the port.

    from repro_torch import engine
    eng = engine.get_engine(cfg.engine)   # "cuda" or "torch-reference"
    idx, sqd = eng.knn_tables(Vq, Vc, k, exclude_self=True, cfg=cfg)
"""
from __future__ import annotations

from repro_torch.engine.base import Engine
from repro_torch.engine.cuda import CudaEngine
from repro_torch.engine.reference import ReferenceEngine

_REGISTRY: dict[str, Engine] = {}


def register(eng: Engine) -> Engine:
    """Register an engine instance under its ``name`` (last one wins)."""
    if not eng.name or eng.name == "base":
        raise ValueError("engine must define a unique non-default .name")
    _REGISTRY[eng.name] = eng
    return eng


def get_engine(name: str) -> Engine:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown engine {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available_engines() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register(ReferenceEngine())
register(CudaEngine())

__all__ = [
    "CudaEngine",
    "Engine",
    "ReferenceEngine",
    "available_engines",
    "get_engine",
    "register",
]
