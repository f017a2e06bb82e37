"""What serving needs of ``paddle_tpu/distributed/sharding_spec.py``: the
model axis's name, the size-1 filter and the divisibility check.

A spec here is a tuple with one entry a tensor dim: an axis name or
``None`` (that dim whole on every rank).  A mesh is described by its axis
sizes, ``{name: size}`` (:func:`mesh_axes`).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

__all__ = ["MODEL_AXIS", "mesh_axes", "_filter_spec", "_divisible"]

#: the tensor-parallel axis of a serving mesh
MODEL_AXIS = "model"

Spec = Tuple[Optional[str], ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of anything with
    ``mesh_dim_names`` and ``shape``); ``{}`` for anything else."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    shape = tuple(getattr(mesh, "shape", ()) or ())
    return dict(zip(names, shape))


def _filter_spec(spec: Spec, mesh) -> Spec:
    """Drop the axis names the mesh does not have, or has at size 1: on a
    mesh of one, every spec is whole."""
    axes = mesh_axes(mesh)
    return tuple(a if a is not None and axes.get(a, 1) > 1 else None
                 for a in spec)


def _divisible(shape: Sequence[int], spec: Spec, mesh) -> bool:
    """Whether every dim of ``shape`` split by ``spec`` divides by its
    axis's size on ``mesh``."""
    axes = mesh_axes(mesh)
    for dim, a in zip(shape, spec):
        n = 1 if a is None else axes.get(a, 1)
        if n > 1 and int(dim) % n != 0:
            return False
    return True
