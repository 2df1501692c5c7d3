"""Device meshes of the port's sharded LM paths.

The counterpart of the JAX package's ``launch/mesh.py``.
:func:`make_local_mesh` (JAX: ``make_cpu_mesh``) is a ``("data",
"model")`` ``init_device_mesh`` over the world the EDM_* contract joined
(``runtime/platform.py::init_distributed``): on the cards where the
ranks compute on cards, on the CPU (gloo) where they were asked to.
Defined as functions, so importing this module touches no device.

:func:`make_production_mesh` builds JAX's production mesh, 16 x 16
("data", "model") or 2 x 16 x 16 ("pod", "data", "model"), only over a
world of exactly 256 (512) ranks, one a card; any other world is
refused with the shape it needs -- it is never folded onto fewer cards.
"""
from __future__ import annotations

import torch


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _mesh_device_type(device) -> str:
    """'cuda' or 'cpu': the ranks' device (default: the card where the
    group was joined on one, else the CPU)."""
    if device is not None:
        return torch.device(device).type
    from repro_torch.runtime.platform import distributed_info

    info = distributed_info()
    if info is not None:
        return torch.device(info["device"]).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _init(shape: tuple, names: tuple, device):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_mesh_device_type(device), shape, mesh_dim_names=names)


def make_local_mesh(n: int | None = None, model: int = 1, device=None):
    """A (n // model, model) ("data", "model") mesh over the joined world
    (``n`` default the world size, which it must equal)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_local_mesh needs a joined process group "
                           "(runtime.platform.init_distributed)")
    world = _world()
    n = n or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks over a world of {world}")
    if n % model:
        raise ValueError(f"model axis {model} does not divide {n} ranks")
    return _init((n // model, model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = _world()
    if world != need:
        raise ValueError(
            f"the production mesh is {'x'.join(map(str, shape))} {names}: it "
            f"needs a world of exactly {need} ranks, one a card, joined "
            f"through EDM_COORDINATOR / EDM_NUM_PROCESSES / EDM_PROCESS_ID; this "
            f"world has {world}.  It is not folded onto fewer cards: use "
            "make_local_mesh (the train CLI without --production-mesh)"
        )
    return _init(shape, names, device)


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes that shard the batch."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"


def flat_axes(mesh) -> tuple[str, ...]:
    """All axes: the EDM pipeline's flat worker grid."""
    return tuple(mesh.mesh_dim_names)
