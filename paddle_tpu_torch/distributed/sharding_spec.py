"""Parameter and activation sharding annotations over ``DeviceMesh`` and
DTensor placements.

Port of ``paddle_tpu/distributed/sharding_spec.py``.  A spec is a tuple
with one entry a tensor dim: an axis name, a tuple of axis names (the dim
split over several mesh axes, the first outermost), or ``None`` (that dim
whole on every rank).  A mesh is a ``DeviceMesh`` described by its axis
sizes, ``{name: size}`` (:func:`mesh_axes`); a spec becomes DTensor
placements (:func:`to_placements`: ``Shard(d)`` on each mesh dim that
splits tensor dim ``d``, ``Replicate()`` on the others) and back
(:func:`spec_of`).

- A parameter may carry ``_pspec`` (:func:`set_param_spec`,
  :func:`shard_parameter`); one without is replicated.
- :func:`mark_sharding` constrains an activation: a differentiable
  redistribution of a ``DTensor`` (a plain tensor is taken as the same
  value on every rank of the mesh).  With no mesh, a spec the mesh does
  not split, or a shape the spec does not divide, the tensor comes back
  as it is, so parallel layers run unsharded on one device.
- The batch dim of data shards over ``("data", "sharding")`` (ZeRO's axis
  is a second batch axis), a sequence dim over ``"sep"``
  (:func:`batch_spec`); :func:`zero_spec` adds ZeRO's axis to the first
  free dim a parameter's spec leaves.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["MODEL_AXIS", "SEQ_AXIS", "BATCH_AXES", "mesh_axes",
           "to_placements", "spec_of", "set_param_spec", "get_param_spec",
           "batch_spec", "mark_sharding", "shard_parameter", "zero_spec",
           "placement_of", "_filter_spec", "_divisible"]

#: the tensor-parallel axis of a mesh
MODEL_AXIS = "model"
#: the sequence (context-parallel) axis
SEQ_AXIS = "sep"
#: the axes a batch dim shards over
BATCH_AXES = ("data", "sharding")

Spec = Tuple[object, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of anything with
    ``mesh_dim_names`` and ``shape``); ``{}`` for anything else."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    shape = tuple(getattr(mesh, "shape", ()) or ())
    return dict(zip(names, shape))


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _filter_spec(spec: Spec, mesh) -> Spec:
    """Drop the axis names the mesh does not have, or has at size 1: on a
    mesh of one, every spec is whole."""
    axes = mesh_axes(mesh)
    out = []
    for entry in spec:
        kept = tuple(a for a in _names(entry) if axes.get(a, 1) > 1)
        if not kept:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            out.append(kept)
        else:
            out.append(kept[0])
    return tuple(out)


def _divisible(shape: Sequence[int], spec: Spec, mesh) -> bool:
    """Whether every dim of ``shape`` split by ``spec`` divides by the
    product of its axes' sizes on ``mesh``."""
    axes = mesh_axes(mesh)
    for dim, entry in zip(shape, spec):
        n = 1
        for a in _names(entry):
            n *= axes.get(a, 1)
        if n > 1 and int(dim) % n != 0:
            return False
    return True


def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that splits tensor dim ``d``, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names or ())
    placements: List[object] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for a in _names(entry):
            if a in names:
                placements[names.index(a)] = Shard(dim)
    return placements


def spec_of(placements, mesh, ndim: int) -> Spec:
    """The spec of DTensor ``placements`` on ``mesh`` for a tensor of
    ``ndim`` dims (the inverse of :func:`to_placements`)."""
    entries: List[list] = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names or (), placements):
        if p.is_shard():
            entries[p.dim].append(name)
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e))
                 for e in entries)


def set_param_spec(param, spec: Spec):
    param._pspec = tuple(spec)
    return param


def get_param_spec(param) -> Optional[Spec]:
    return getattr(param, "_pspec", None)


def batch_spec(ndim: int, last=None, seq_dim: Optional[int] = 1) -> Spec:
    """Activation spec: dim 0 over ``BATCH_AXES``, ``seq_dim`` over
    ``"sep"``, the last dim as given."""
    entries: List[object] = [None] * ndim
    entries[0] = BATCH_AXES
    if seq_dim is not None and 0 < seq_dim < ndim - 1:
        entries[seq_dim] = SEQ_AXIS
    if last is not None and ndim > 1:
        entries[-1] = last
    return tuple(entries)


def _global_mesh(mesh):
    if mesh is not None:
        return mesh
    from .mesh import get_global_mesh

    return get_global_mesh()


def mark_sharding(t: torch.Tensor, spec: Spec, mesh=None) -> torch.Tensor:
    """``t`` as a ``DTensor`` placed by ``spec`` on ``mesh`` (default the
    global mesh), through a differentiable redistribution; ``t`` itself
    when there is no mesh, nothing of ``spec`` splits on it, or the shape
    does not divide (see the module)."""
    from torch.distributed.tensor import DTensor, Replicate

    m = _global_mesh(mesh)
    if m is None:
        return t
    spec = _filter_spec(tuple(spec), m)
    if all(e is None for e in spec) or not _divisible(t.shape, spec, m):
        return t
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, m, [Replicate()] * m.ndim,
                               run_check=False)
    return t.redistribute(m, to_placements(spec, m))


def shard_parameter(param, spec: Spec, mesh=None):
    """Annotate ``param`` with ``spec`` and place it on ``mesh`` (default
    the global mesh): a new ``nn.Parameter`` over the ``DTensor`` of its
    value (a spec that does not divide it places it whole), which the
    caller puts where the old one was.  Without a mesh, ``param``
    annotated."""
    from torch.distributed.tensor import distribute_tensor

    set_param_spec(param, spec)
    m = _global_mesh(mesh)
    if m is None:
        return param
    placed = _filter_spec(tuple(spec), m)
    if not _divisible(param.shape, placed, m):
        placed = (None,) * param.dim()
    out = torch.nn.Parameter(
        distribute_tensor(param.detach(), m, to_placements(placed, m)),
        requires_grad=param.requires_grad)
    return set_param_spec(out, spec)


def zero_spec(shape, spec: Optional[Spec], mesh, axis: str = "sharding"
              ) -> Spec:
    """ZeRO's shard on a parameter's (or an optimizer state's) spec: the
    first dim the spec leaves free, and that divides, split over ``axis``
    (reference: group_sharded_optimizer_stage2.py:48)."""
    axes = mesh_axes(mesh)
    if axes.get(axis, 1) <= 1:
        return tuple(spec) if spec is not None else ()
    entries = list(spec) if spec is not None else [None] * len(shape)
    while len(entries) < len(shape):
        entries.append(None)
    n = axes[axis]
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % n == 0 and dim >= n:
            entries[i] = axis
            return tuple(entries)
    return tuple(entries)


def placement_of(t) -> Optional[Spec]:
    """The spec ``t`` is placed by: a ``DTensor``'s, from its placements;
    else the annotation it carries (None without one)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return spec_of(t.placements, t.device_mesh, t.dim())
    return get_param_spec(t)
