"""Process groups and one-axis device meshes over ``torch.distributed``.

Port of ``paddle_tpu/distributed/mesh.py`` (``build_mesh``,
``hybrid_mesh``, ``axis_size``, ``set_global_mesh``/``get_global_mesh``) in
PyTorch's idiom: one process per device, every rank running the same
program (SPMD, as ``torchrun`` starts it).  A serving mesh is a
``DeviceMesh`` with one dim, ``"model"``, whose ``get_group("model")``
carries the collectives; :func:`hybrid_mesh` is the five-axis training
mesh ``[data, pipe, sharding, sep, model]`` over the whole world.

``dist.new_group`` is collective over the whole world: every rank must
ask for the same groups in the same order, members or not.
:func:`process_group` does that and caches each group by its ranks, so a
later :func:`build_mesh` over the same ranks makes no new group.  Every
group is made with a timeout (:data:`GROUP_TIMEOUT`): a rank that
diverges ends the others' wait with an error instead of a hang.

Where no default group exists, :func:`ensure_world` makes a world of one
on a ``HashStore``: NCCL for a card, gloo for the CPU.  A world of more
ranks is the caller's to make (``dist.init_process_group`` with its
address, world size and rank).
"""
from __future__ import annotations

from datetime import timedelta
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from .sharding_spec import MODEL_AXIS

__all__ = ["GROUP_TIMEOUT", "HYBRID_AXES", "backend_for", "ensure_world",
           "process_group", "build_mesh", "hybrid_mesh", "axis_size",
           "mesh_ranks", "set_global_mesh", "get_global_mesh"]

#: the axes of the hybrid training mesh, outermost first
HYBRID_AXES = ("data", "pipe", "sharding", "sep", "model")

#: the timeout of every group this module makes
GROUP_TIMEOUT = timedelta(seconds=60)

#: groups made by process_group, by their (sorted) global ranks, for the
#: default group whose id is under "world"
_groups: Dict[object, object] = {}
_global_mesh = None


def backend_for(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def ensure_world(device="cuda") -> None:
    """Make the default group a world of one on a ``HashStore`` when none
    exists (NCCL on ``cuda``, gloo on ``cpu``); an existing one is kept.
    Asking for ``cuda`` without a card raises."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on 'cuda' was asked for, but no CUDA "
                           "device is available (pass device='cpu')")
    dist.init_process_group(backend_for(dev), store=dist.HashStore(),
                            rank=0, world_size=1, timeout=GROUP_TIMEOUT)


def process_group(ranks: Sequence[int]):
    """The process group over global ``ranks``, made once (collective over
    the whole world: every rank calls this with the same ranks in the same
    order).  A rank outside ``ranks`` gets ``GroupMember.NON_GROUP_MEMBER``
    back.  The whole world is the default group."""
    key = tuple(sorted(int(r) for r in ranks))
    if key == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    world = id(dist.group.WORLD)
    if _groups.get("world") != world:
        # a new default group (the last one destroyed): its groups are new
        _groups.clear()
        _groups["world"] = world
    if key not in _groups:
        _groups[key] = dist.new_group(list(key), timeout=GROUP_TIMEOUT)
    return _groups[key]


def build_mesh(ranks: Sequence[int], device_type: str):
    """A one-axis ``DeviceMesh`` ``{"model": len(ranks)}`` over global
    ``ranks`` (its group from :func:`process_group`: collective over the
    world), or ``None`` on a rank outside ``ranks``."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = sorted(int(r) for r in ranks)
    group = process_group(ranks)
    if dist.get_rank() not in ranks:
        return None
    return DeviceMesh.from_group(group, device_type, mesh=ranks,
                                 mesh_dim_names=(MODEL_AXIS,))


def hybrid_mesh(dp: int = 1, pp: int = 1, sharding: int = 1, sep: int = 1,
                mp: int = 1, device_type: str = "cpu"):
    """The five-axis ``DeviceMesh`` ``[data, pipe, sharding, sep, model]``
    over the whole world, rank ``r`` at row-major position ``r``.  Degrees
    of 1 keep their axis, so a spec may name any hybrid axis whatever the
    strategy.  The degrees must multiply to the world's size (collective
    over the world: every rank makes it)."""
    import numpy as np
    from torch.distributed.device_mesh import DeviceMesh

    dims = (dp, pp, sharding, sep, mp)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if int(np.prod(dims)) != world:
        raise ValueError(f"hybrid_mesh: degrees {dims} multiply to "
                         f"{int(np.prod(dims))}, the world has {world}")
    if not dist.is_initialized():
        ensure_world(device_type)
    return DeviceMesh(device_type, np.arange(world).reshape(dims),
                      mesh_dim_names=HYBRID_AXES)


def axis_size(name: str, mesh=None) -> int:
    """The size of axis ``name`` on ``mesh`` (default the global mesh); 1
    when there is no mesh or it has no such axis."""
    from .sharding_spec import mesh_axes

    m = mesh if mesh is not None else _global_mesh
    return int(mesh_axes(m).get(name, 1)) if m is not None else 1


def mesh_ranks(mesh) -> list:
    """The global ranks of a mesh, in the order of its group."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def set_global_mesh(mesh) -> None:
    global _global_mesh
    _global_mesh = mesh


def get_global_mesh() -> Optional[object]:
    return _global_mesh
