"""Tensor-parallel sharded serving: the mesh, the viability ladder and
each engine's shard.

Port of ``paddle_tpu/serving/sharding.py``.  The JAX engine is one
process driving a mesh through GSPMD; here every rank of the mesh is a
process (SPMD over ``torch.distributed``, as ``torchrun`` starts it),
builds the same :class:`~.engine.Engine`, holds its own shard and is fed
the same calls:

- **Weights**: the model's projections are the tensor-parallel layers of
  :mod:`..distributed.fleet.meta_parallel.mp_layers` at the rank's share
  (:meth:`ServingShard.place_model`, :func:`..models.convert.shard_model`
  for a whole model): ``H/mp`` query heads and ``Hkv/mp`` whole kv heads,
  one ``all_reduce`` after each row-parallel layer, the logits
  all-gathered over the vocabulary before the sampler.
- **KV pools** are allocated at ``Hkv/mp`` heads (both layouts keep kv
  heads at dim 3), so paged and contiguous attention are shard-local:
  the kernels K4/K5 and K1 run on the rank's heads, ``G = H/Hkv`` the
  same at every mp.  ``Hkv % mp == 0`` and ``H % mp == 0`` are checked
  up front.
- **Everything on the host is one decision stream.**  The lanes, block
  tables and lengths are whole on every rank, and so are the allocator,
  prefix cache, scheduler and journal: every rank makes the same
  decisions, or the ranks issue different collectives and the world
  hangs.  A decision that reads a clock or a thread (deadlines, reaping,
  shedding, aging, the prefix lookup's budget, the watchdog) reads the
  values rank 0 of the mesh had at the last :meth:`ServingShard.agree`;
  each step's scheduling digest rides the same exchange, and a rank
  whose digest differs raises instead of hanging.
- **Placement allocates.**  Each rank allocates its shard; a placement
  never slices a whole tensor on the device.  The JAX ``place_*`` calls
  map so: ``place_model`` is :meth:`ServingShard.place_model`;
  ``place_cache`` is the pools' allocation at
  :meth:`ServingShard.local_heads`; ``place_adapters`` is
  :class:`~.adapters.AdapterPool` sizing each bank from its layer's
  shard; ``place_sampler`` and ``place_state`` have nothing to do, the
  lanes, tables and lengths being whole on every rank.

A mesh of one runs the same code: its collectives are over one rank (the
identity), the row layers add their bias inside the matmul, and no
decision exchange is made, so ``Engine(mesh=serving_mesh(1))`` serves
the plain engine's streams bitwise.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..distributed import mesh as mesh_mod
from ..distributed.sharding_spec import (
    MODEL_AXIS, _divisible, _filter_spec, mesh_axes,
)

__all__ = ["ServingShard", "serving_mesh", "mesh_shape_key",
           "viable_ladder", "degrade_step", "KV_POOL_SPEC"]

#: KV pools are 5-D with kv_heads at dim 3 in both layouts: contiguous
#: ``[slots, layers, max_seq, kv_heads, head_dim]`` and paged ``[blocks,
#: layers, block_size, kv_heads, head_dim]``
KV_POOL_SPEC = (None, None, None, MODEL_AXIS, None)


def serving_mesh(model_parallel: int, ranks: Optional[Sequence[int]] = None,
                 device="cuda"):
    """A one-axis serving mesh ``{"model": mp}`` over global ``ranks``
    (default the first ``mp``), a ``DeviceMesh`` on ``device``'s type.

    With no default process group and ``mp == 1`` it first makes a world
    of one (:func:`..distributed.mesh.ensure_world`: NCCL on ``cuda``,
    gloo on ``cpu``); a world of more ranks is the caller's to make.
    Making the mesh's group is collective over the whole world: every
    rank calls this with the same arguments, and a rank outside ``ranks``
    gets ``None``.  The mesh carries only the model axis: a fleet gives
    data parallelism as shard groups, one engine a group."""
    mp = int(model_parallel)
    if mp < 1:
        raise ValueError(f"serving_mesh: model_parallel must be >= 1, "
                         f"got {model_parallel}")
    if mp == 1 and not dist.is_initialized():
        mesh_mod.ensure_world(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if ranks is None:
        ranks = list(range(mp))
    ranks = sorted(int(r) for r in ranks)
    if len(ranks) < mp or world < mp or any(r >= world for r in ranks):
        raise ValueError(
            f"serving_mesh: model_parallel={mp} needs {mp} devices "
            f"(ranks {ranks[:mp]}), the world has {world} (launch one "
            f"process a device and init_process_group first)")
    return mesh_mod.build_mesh(ranks[:mp], torch.device(device).type)


def viable_ladder(kv_heads: int, num_heads: int,
                  max_mp: Optional[int] = None) -> List[int]:
    """The ascending viable model-parallel degrees of a model: every
    ``mp`` dividing both ``kv_heads`` and ``num_heads`` (the two rules
    :class:`ServingShard` checks), up to ``max_mp``.  1 is always on it
    (within the cap): the degraded floor is the unsharded engine."""
    kv, nh = int(kv_heads), int(num_heads)
    if kv < 1 or nh < 1:
        raise ValueError(f"viable_ladder: kv_heads={kv_heads} and "
                         f"num_heads={num_heads} must be >= 1")
    top = min(kv, nh) if max_mp is None else int(max_mp)
    return [mp for mp in range(1, top + 1)
            if kv % mp == 0 and nh % mp == 0]


def degrade_step(kv_heads: int, num_heads: int,
                 survivors: int) -> Optional[int]:
    """The largest viable ``mp`` that fits on ``survivors`` devices (the
    degraded rebuild's target), or None when not even 1 fits."""
    ladder = viable_ladder(kv_heads, num_heads, max_mp=survivors)
    return ladder[-1] if ladder else None


def mesh_shape_key(mesh) -> Optional[str]:
    """The mesh's shape as a string (``"model=2"``), the key the journal
    records per admission and recovery checks; the ranks are not part of
    it (a restart rarely gets the same devices)."""
    if mesh is None:
        return None
    return ",".join(f"{n}={s}" for n, s in mesh_axes(mesh).items())


class ServingShard:
    """One engine's sharding: its mesh, shape key, group and rank, the
    placement of its state, and the decision exchange of its ranks."""

    def __init__(self, mesh, *, kv_heads: int, num_heads: int):
        axes = mesh_axes(mesh)
        if MODEL_AXIS not in axes:
            raise ValueError(
                f"Engine(mesh=...) needs a '{MODEL_AXIS}' axis, got axes "
                f"{tuple(axes)} (build it with serving.sharding."
                f"serving_mesh)")
        if len(axes) != 1:
            raise ValueError(f"a serving mesh has the '{MODEL_AXIS}' axis "
                             f"only, got {tuple(axes)}")
        self.mesh = mesh
        self.mp = int(axes[MODEL_AXIS])
        self.key = mesh_shape_key(mesh)
        if self.mp > 1 and int(kv_heads) % self.mp != 0:
            raise ValueError(
                f"model axis size {self.mp} must divide kv_heads "
                f"{kv_heads}: the KV pool shards whole GQA groups so "
                f"decode attention stays shard-local")
        if self.mp > 1 and int(num_heads) % self.mp != 0:
            raise ValueError(
                f"model axis size {self.mp} must divide "
                f"num_attention_heads {num_heads}")
        self.group = mesh.get_group(MODEL_AXIS)
        self.ranks = mesh_mod.mesh_ranks(mesh)
        self.rank = self.ranks.index(dist.get_rank())
        self.device_type = mesh.device_type

    @contextmanager
    def context(self):
        """Install this mesh as the global mesh for a scope and restore
        what was there (co-resident engines of a fleet hold different
        meshes)."""
        prev = mesh_mod.get_global_mesh()
        mesh_mod.set_global_mesh(self.mesh)
        try:
            yield
        finally:
            mesh_mod.set_global_mesh(prev)

    # -- the decision exchange -------------------------------------------

    def agree(self, obj) -> list:
        """Every rank's ``obj``, in mesh order (an ``all_gather_object``
        over the mesh's group; a mesh of one makes no exchange)."""
        if self.mp == 1:
            return [obj]
        out = [None] * self.mp
        dist.all_gather_object(out, obj, group=self.group)
        return out

    # -- placement ---------------------------------------------------------

    def local_heads(self, heads: int) -> int:
        """A head count's share on this rank (whole when the mesh does
        not divide it)."""
        spec = _filter_spec((MODEL_AXIS,), self.mesh)
        return heads // self.mp if _divisible((heads,), spec, self.mesh) \
            else heads

    def divides(self, *counts: int) -> bool:
        """Whether the model axis divides every one of ``counts``."""
        return all(int(c) % self.mp == 0 for c in counts)

    def place_model(self, model):
        """The model as this rank's shard: a model built with this mesh is
        taken as it is; a whole model is cut into its shard
        (:func:`..models.convert.shard_model`; on a mesh of one it shares
        the whole model's tensors)."""
        from ..models.convert import shard_model

        own = getattr(model, "mesh", None)
        if own is not None:
            if mesh_mod.mesh_ranks(own) != self.ranks:
                raise ValueError(f"the model is sharded over ranks "
                                 f"{mesh_mod.mesh_ranks(own)}, the engine's "
                                 f"mesh is over {self.ranks}")
            return model
        with self.context():
            return shard_model(model, self.mesh)

    def shard_weights(self, state: dict) -> dict:
        """This rank's shard of a whole port state dict (an
        ``update_weights`` on a sharded engine)."""
        from ..models.convert import shard_state_dict

        return shard_state_dict(state, self.rank, self.mp)
