"""``HybridParallelOptimizer`` and the ZeRO partition of optimizer state,
gradients and parameters.

Port of ``paddle_tpu/distributed/fleet/hybrid_optimizer.py``
(``HybridParallelOptimizer`` :66, ``_shard_accumulators`` :32) for one
process per rank.  The JAX package places ZeRO as a sharding of the
accumulators on the mesh; here, as in Paddle's
``DygraphShardingOptimizer``, each parameter has one owner in the sharding
group (:func:`partition`: greedy by size, in parameter order), and only
its owner keeps its optimizer state and runs its update.  A step:

1. averages the gradients over the batch ranks: over data x sharding
   (stage 1), or over data and then, to the owner only, over sharding
   (stages 2 and 3: the other ranks drop the gradient);
2. with a ``ClipGradByGlobalNorm`` on the inner optimizer, computes the
   global norm over the model, pipe and sharding groups: a parameter split
   over the model group (``is_distributed``) counts on every model rank,
   one whole on every model rank counts once, a parameter counts on the
   stage that holds it (a tied copy on a later stage,
   ``_pp_shared_copy``, not at all), and under a sharding degree each
   rank counts the parameters it owns; the inner optimizer then scales by
   that norm;
3. runs the inner optimizer on the parameters this rank owns;
4. broadcasts each parameter from its owner (stages 1 and 2), or, at
   stage 3, releases the parameters it does not own (their storage
   becomes empty until :func:`gather_params`, which the model wrappers
   call before a forward, brings them back from their owners).

On one rank in every group the step is the inner optimizer's step: no
collective, no other work.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .. import collective
from ..parallel import average_gradients
from .meta_parallel.mp_layers import is_split

__all__ = ["HybridParallelOptimizer", "partition", "gather_params"]


def partition(params: List[torch.Tensor], n: int) -> List[int]:
    """The owner (a position in a group of ``n``) of each parameter: the
    least loaded so far, by element count, in parameter order."""
    sizes = [0] * n
    owners = []
    for p in params:
        o = sizes.index(min(sizes))
        owners.append(o)
        sizes[o] += int(p.numel())
    return owners


@torch.no_grad()
def gather_params(params) -> None:
    """Bring back every parameter a ZeRO stage-3 step released, from its
    owner (collective over each one's sharding group; every rank calls it
    for the same parameters)."""
    for p in params:
        if not getattr(p, "_zero_released", False):
            continue
        if p.numel() == 0 and len(p._zero_shape):
            p.data = torch.empty(p._zero_shape, dtype=p.dtype,
                                 device=p.device)
        collective.broadcast(p.data, p._zero_owner, p._zero_group)
        p._zero_released = False


class _Scale:
    """A clip that multiplies every clipped gradient by one precomputed
    factor (the hybrid global norm's)."""

    def __init__(self, scale: torch.Tensor):
        self.scale = scale

    def __call__(self, params_grads):
        return [(p, g.float() * self.scale
                 if g is not None and getattr(p, "need_clip", True) else g)
                for p, g in params_grads]


def _size(group) -> int:
    return group.nranks if group is not None else 1


class HybridParallelOptimizer:
    """Wraps an optimizer of :mod:`....optimizer` for the topology
    ``hcg``; ``dp_group`` and ``sharding_group`` replace its data and
    sharding groups (``group_sharded_parallel``'s choice, also without a
    topology); ``sharding_stage`` (1, 2 or 3; default the strategy's
    ``sharding_configs.stage``) applies when the sharding group has more
    than one rank."""

    def __init__(self, optimizer, hcg=None, strategy=None, *,
                 sharding_stage: Optional[int] = None, dp_group=None,
                 sharding_group=None):
        self.__dict__["_inner_opt"] = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._mp = self._pp = None
        if hcg is not None:
            dp_group = dp_group or hcg.get_data_parallel_group()
            sharding_group = sharding_group or \
                hcg.get_sharding_parallel_group()
            self._mp = hcg.get_model_parallel_group()
            self._pp = hcg.get_pipe_parallel_group()
        self._dp, self._sharding = dp_group, sharding_group
        if sharding_stage is None:
            sharding_stage = strategy.sharding_configs.stage \
                if strategy is not None else 1
        self._stage = int(sharding_stage) if _size(sharding_group) > 1 else 0
        # the batch ranks: data x sharding
        self._batch = hcg.get_check_parallel_group() if hcg is not None \
            else (sharding_group if self._stage else dp_group)
        self._params = [p for g in optimizer.param_groups
                        for p in g["params"]]
        self._owners = partition(self._params, _size(sharding_group)) \
            if self._stage else None
        #: the wire dtype of f32 gradients in the data average (None:
        #: their own); FP16AllReduceOptimizer sets float16
        self._comm_dtype: Optional[torch.dtype] = None

    # -- the step --------------------------------------------------------------

    def _mine(self, i: int) -> bool:
        return self._owners is None or \
            self._owners[i] == self._sharding.rank

    def _sync_grads(self) -> None:
        if self._stage <= 1:
            if _size(self._batch) > 1:
                average_gradients(self._params, self._batch,
                                  self._comm_dtype)
            return
        if _size(self._dp) > 1:
            average_gradients(self._params, self._dp, self._comm_dtype)
        for i, p in enumerate(self._params):
            if p.grad is None:
                continue
            owner = self._sharding.ranks[self._owners[i]]
            collective.reduce(p.grad, owner, collective.ReduceOp.AVG,
                              self._sharding)
            if not self._mine(i):
                p.grad = None

    def _hybrid_clip(self, clip) -> Optional[_Scale]:
        """The factor of a global-norm clip over every group (see the
        module), or None when no group spreads the parameters."""
        from ...nn.clip import ClipGradByGlobalNorm

        if not isinstance(clip, ClipGradByGlobalNorm) or (
                _size(self._mp) == 1 and _size(self._pp) == 1
                and self._owners is None):
            return None
        split = whole = None
        for i, p in enumerate(self._params):
            g = p.grad
            if g is None or not getattr(p, "need_clip", True) or \
                    getattr(p, "_pp_shared_copy", False) or not self._mine(i):
                continue
            s = g.float().square().sum()
            if is_split(p):
                split = s if split is None else split + s
            else:
                whole = s if whole is None else whole + s
        dev = self._params[0].device
        split = split if split is not None else torch.zeros((), device=dev)
        whole = whole if whole is not None else torch.zeros((), device=dev)
        collective.all_reduce(split, group=self._mp)
        total = split + whole
        for g in (self._pp, self._sharding if self._owners else None):
            if _size(g) > 1:
                collective.all_reduce(total, group=g)
        norm = total.sqrt()
        return _Scale(torch.clamp(clip.clip_norm
                                  / torch.clamp(norm, min=1e-12), max=1.0))

    @torch.no_grad()
    def step(self):
        inner = self._inner_opt
        self._sync_grads()
        clip = getattr(inner, "_grad_clip", None)
        scale = self._hybrid_clip(clip)
        if self._owners is not None:
            for i, p in enumerate(self._params):
                if not self._mine(i):
                    p.grad = None
        if scale is not None:
            inner._grad_clip = scale
        try:
            inner.step()
        finally:
            if scale is not None:
                inner._grad_clip = clip
        if self._owners is None:
            return
        group = self._sharding
        for i, p in enumerate(self._params):
            owner = group.ranks[self._owners[i]]
            if self._stage < 3:
                collective.broadcast(p.data, owner, group)
                continue
            p._zero_owner, p._zero_group = owner, group
            p._zero_shape = tuple(p.shape) if p.numel() else \
                getattr(p, "_zero_shape", tuple(p.shape))
            p._zero_released = True
            if not self._mine(i):
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    # -- the inner optimizer's surface -----------------------------------------

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, *a, **k):
        return self._inner_opt.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner_opt.state_dict()

    def load_state_dict(self, sd):
        return self._inner_opt.load_state_dict(sd)

    set_state_dict = load_state_dict

    @property
    def inner_opt(self):
        return self._inner_opt

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner_opt"], name)

    def __setattr__(self, name, value):
        # what a loss scaler sets (``_found_inf``) belongs to the inner one
        if name == "_found_inf":
            setattr(self._inner_opt, name, value)
        else:
            object.__setattr__(self, name, value)
