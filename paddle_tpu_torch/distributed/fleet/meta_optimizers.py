"""Meta-optimizers: gradient merge, LocalSGD, DGC momentum and the fp16
all-reduce.

Port of ``paddle_tpu/distributed/fleet/meta_optimizers.py``
(``GradientMergeOptimizer`` :29, ``LocalSGDOptimizer`` :116,
``DGCMomentumOptimizer`` :190, ``FP16AllReduceOptimizer`` :319) over the
optimizers of :mod:`...optimizer`, one process per rank:

- ``GradientMergeOptimizer``: ``backward`` k times accumulates into
  ``.grad``; ``step`` applies the inner optimizer every k-th call (the
  sum divided by k when ``avg``) and is a no-op otherwise; ``clear_grad``
  clears only after an apply.  A python step counter cannot be a part of
  a compiled step, so ``step`` raises inside a ``jit.to_static`` body, as
  the JAX wrapper raises under tracing.
- ``LocalSGDOptimizer``: ``k_steps`` purely local steps (an int, or a
  callable of the step count), then the parameters (their f32 masters
  where they have them) are averaged over the data-parallel group.
- ``DGCMomentumOptimizer``: Deep Gradient Compression momentum
  (arXiv:1712.01887): dense momentum until ``rampup_begin_step``, then
  per-parameter residuals ``u`` (velocity) and ``v`` (accumulated update)
  of which only the top ``1 - sparsity`` by magnitude are applied; the
  warm-up's velocity seeds ``u``.  Residuals are kept, and saved, by
  parameter position.
- ``FP16AllReduceOptimizer``: f32 gradients cross the data-parallel
  average of the hybrid optimizer it wraps as float16 (cast, summed in
  float16, cast back); with no such average to run, each rank rounds its
  f32 gradients to float16, the JAX wrapper's numerics.
"""
from __future__ import annotations

import warnings
from typing import Dict

import torch
import torch.distributed as dist

from ...optimizer import Momentum
from .. import collective

__all__ = ["GradientMergeOptimizer", "LocalSGDOptimizer",
           "DGCMomentumOptimizer", "FP16AllReduceOptimizer"]

_LOW = (torch.bfloat16, torch.float16)


class _Wrapper:
    """Delegates the optimizer surface to ``inner``."""

    def __init__(self, inner):
        self.__dict__["_inner_opt"] = inner

    @property
    def inner_opt(self):
        return self._inner_opt

    def _params(self):
        return [p for g in self._inner_opt.param_groups for p in g["params"]]

    def clear_grad(self, *a, **k):
        return self._inner_opt.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner_opt.state_dict()

    def load_state_dict(self, sd):
        return self._inner_opt.load_state_dict(sd)

    set_state_dict = load_state_dict

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        return None, None

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner_opt"], name)

    def __setattr__(self, name, value):
        if name == "_found_inf":
            setattr(self._inner_opt, name, value)
        else:
            object.__setattr__(self, name, value)


class GradientMergeOptimizer(_Wrapper):
    """``GradientMergeOptimizer(inner, k_steps=1, avg=True)``: see the
    module."""

    def __init__(self, inner, k_steps: int = 1, avg: bool = True):
        if k_steps < 1:
            raise ValueError("k_steps must be >= 1")
        super().__init__(inner)
        self._k = int(k_steps)
        self._avg = avg
        self._count = 0

    @torch.no_grad()
    def step(self):
        from ... import jit

        if jit.in_to_static() or torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "GradientMergeOptimizer.step under jit.to_static: the "
                "python step counter cannot be compiled into the step; "
                "compile the k-microbatch accumulation into one step "
                "instead")
        self._count += 1
        if self._count % self._k:
            return
        if self._avg and self._k > 1:
            for p in self._params():
                if p.grad is not None:
                    p.grad.mul_(1.0 / self._k)
        self._inner_opt.step()

    def clear_grad(self, *a, **k):
        if self._count % self._k == 0:
            self._inner_opt.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def state_dict(self):
        sd = self._inner_opt.state_dict()
        sd["@gradient_merge_count"] = self._count % self._k
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        saved = int(state_dict.pop("@gradient_merge_count", 0))
        if saved:
            # the partial gradients died with the saving process: a
            # restored mid-cycle count would apply a truncated sum
            warnings.warn(
                f"gradient-merge checkpoint was taken mid-cycle "
                f"({saved}/{self._k} micro-steps); restarting the "
                f"accumulation window (partial gradients were not saved)")
        self._count = 0
        self._inner_opt.load_state_dict(state_dict)

    set_state_dict = load_state_dict


def _data_group():
    from .topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        return hcg.get_data_parallel_group()
    if dist.is_initialized() and dist.get_world_size() > 1:
        return collective.get_group(0)
    return None


class LocalSGDOptimizer(_Wrapper):
    """``LocalSGDOptimizer(inner, k_steps=1, group=None)``: see the
    module (``group`` defaults to the data-parallel group)."""

    def __init__(self, inner_optimizer, k_steps=1, group=None):
        super().__init__(inner_optimizer)
        self._k = k_steps
        self._group = group
        self._local_steps = 0
        self._global_step = 0

    def _cur_k(self) -> int:
        return self._k(self._global_step) if callable(self._k) \
            else int(self._k)

    def step(self):
        self._inner_opt.step()
        self._global_step += 1
        self._local_steps += 1
        if self._local_steps >= max(self._cur_k(), 1):
            self._sync_params()
            self._local_steps = 0

    @torch.no_grad()
    def _sync_params(self) -> None:
        """Average the parameters (their f32 masters where they have
        them) over the group."""
        group = self._group or _data_group()
        if group is None or group.nranks == 1:
            return
        for p in self._params():
            if not p.requires_grad or p.numel() == 0:
                continue
            master = self._inner_opt.state.get(p, {}).get("master_weight")
            src = master if master is not None else p.data
            avg = src.float().clone()
            collective.all_reduce(avg, collective.ReduceOp.AVG, group)
            if master is not None:
                master.copy_(avg)
            p.data.copy_(avg)

    def load_state_dict(self, sd):
        self._local_steps = 0
        return self._inner_opt.load_state_dict(sd)

    set_state_dict = load_state_dict


class DGCMomentumOptimizer(_Wrapper):
    """``DGCMomentumOptimizer(learning_rate, momentum=0.9,
    rampup_begin_step=0, rampup_step=1, sparsity=(0.999,),
    parameters=None, use_nesterov=False, grad_clip=None)``: see the
    module."""

    def __init__(self, learning_rate, momentum: float = 0.9,
                 rampup_begin_step: int = 0, rampup_step: int = 1,
                 sparsity=(0.999,), parameters=None,
                 use_nesterov: bool = False, grad_clip=None, name=None):
        super().__init__(Momentum(parameters, lr=learning_rate,
                                  momentum=momentum,
                                  use_nesterov=use_nesterov,
                                  grad_clip=grad_clip))
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(int(rampup_step), 1)
        self._sparsity = list(sparsity)
        self._step_count = 0
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)
        #: by parameter position: the velocity and the unsent update
        self._u: Dict[int, torch.Tensor] = {}
        self._v: Dict[int, torch.Tensor] = {}

    def _cur_sparsity(self) -> float:
        if self._step_count < self._rampup_begin:
            return 0.0
        i = (self._step_count - self._rampup_begin) \
            * len(self._sparsity) // self._rampup_step
        return self._sparsity[min(i, len(self._sparsity) - 1)]

    @torch.no_grad()
    def step(self):
        opt = self._inner_opt
        sparsity = self._cur_sparsity()
        self._step_count += 1
        if sparsity <= 0.0:
            opt.step()
            return
        pairs = opt._params_grads()
        if opt._grad_clip is not None:
            pairs = opt._grad_clip(pairs)
        grads = {id(p): g for p, g in pairs}
        m = self._momentum
        pos = 0
        for group in opt.param_groups:
            for p in group["params"]:
                i, pos = pos, pos + 1
                g = grads.get(id(p))
                if g is None:
                    continue
                g = g.float()
                st = opt.state[p]
                u, v = self._u.get(i), self._v.get(i)
                if u is None:
                    # the warm-up's velocity carries over (the reference's
                    # dgc_momentum shares one velocity)
                    vel = st.pop("velocity", None)
                    u = vel.float() if vel is not None else \
                        torch.zeros_like(g)
                    v = torch.zeros_like(g)
                if self._use_nesterov:
                    u = m * (u + g)
                    v = v + u + g
                else:
                    u = m * u + g
                    v = v + u
                k = max(int(v.numel() * (1.0 - sparsity)), 1)
                thresh = torch.topk(v.abs().reshape(-1), k).values[-1]
                mask = v.abs() >= thresh
                applied = torch.where(mask, v, torch.zeros_like(v))
                self._v[i] = torch.where(mask, torch.zeros_like(v), v)
                self._u[i] = torch.where(mask, torch.zeros_like(u), u)
                if p.dtype in _LOW and "master_weight" not in st:
                    st["master_weight"] = p.detach().float()
                opt._apply(p, st, opt._param32(p, st)
                           - opt._lr(p, group) * applied)

    def state_dict(self):
        sd = self._inner_opt.state_dict()
        for i, t in self._u.items():
            sd[f"@dgc_u/{i}"] = t.clone()
        for i, t in self._v.items():
            sd[f"@dgc_v/{i}"] = t.clone()
        sd["@dgc_step"] = self._step_count
        return sd

    def load_state_dict(self, sd):
        sd = dict(sd)
        self._u, self._v = {}, {}
        n = len(self._params())
        for k in list(sd):
            for prefix, store in (("@dgc_u/", self._u), ("@dgc_v/", self._v)):
                if k.startswith(prefix):
                    t = sd.pop(k)
                    i = int(k[len(prefix):])
                    if i < n:
                        store[i] = torch.as_tensor(t).float()
        self._step_count = int(sd.pop("@dgc_step", 0))
        return self._inner_opt.load_state_dict(sd)

    set_state_dict = load_state_dict


def _hybrid_in(opt):
    from .hybrid_optimizer import HybridParallelOptimizer

    while opt is not None:
        if isinstance(opt, HybridParallelOptimizer):
            return opt
        opt = opt.__dict__.get("_inner_opt")
    return None


class FP16AllReduceOptimizer(_Wrapper):
    """``FP16AllReduceOptimizer(inner)``: see the module."""

    @torch.no_grad()
    def step(self):
        hybrid = _hybrid_in(self._inner_opt)
        group = hybrid._batch if hybrid is not None else None
        if group is not None and group.nranks > 1:
            hybrid._comm_dtype = torch.float16
            try:
                self._inner_opt.step()
            finally:
                hybrid._comm_dtype = None
            return
        for p in self._params():
            if p.grad is not None and p.grad.dtype == torch.float32:
                p.grad.copy_(p.grad.half().float())
        self._inner_opt.step()
