"""``MoELayer``: mixture of experts, with expert parallelism.

Port of ``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``, the
GShard capacity dispatch of the JAX layer with Paddle's process model for
expert parallelism (``moe_group``, ``global_scatter``):

1. The gate picks ``k`` experts a token.  Every choice gets a position in
   its expert's queue by one cumulative count over the **whole** batch:
   all first choices before any second choice, tokens in order, rank 0's
   shard before rank 1's (:154-167).  The capacity is the whole batch's,
   ``C = ceil(k N / E * capacity_factor)``.  A choice at position ``C`` or
   beyond is dropped: its slot is the trash slot ``E C`` and its combine
   weight 0.
2. Under a ``moe_group`` of ``ep`` ranks, each rank holds a shard of the
   batch (the same token count on every rank) and its ``E / ep`` experts
   (``experts`` is the rank's own list, as in Paddle; the gate scores
   all ``E``).  The per-expert counts of each choice are exchanged first
   (an all-gather of ``[k, E]`` ints, Paddle's count exchange), so each
   rank places its choices at their whole-batch positions: a per-rank
   capacity or priority would drop a different set of tokens.  The rank
   scatters its tokens into a ``[E C + 1, H]`` buffer, and an all-to-all
   (:func:`....distributed.collective.alltoall_autograd`) sends each
   owner its experts' rows; every slot is filled by at most one rank, so
   the owner sums what it received.  The experts' outputs go back by a
   second all-to-all, each rank gathers its choices' rows and combines
   them with the gate weights.
3. Shapes are static and nothing is read on the host, so the layer is
   captured into a CUDA graph as it stands.

The experts are structurally identical layers (checked at construction,
as :129-136 checks), run as one batched computation: each parameter of
the experts lives in one stacked ``[E_local, ...]`` tensor, and every
expert's parameter is a view of its row of it (made at the first
forward, made again if something gave a parameter new storage, such as
``amp.decorate``), so the stack is never copied per step (the JAX layer
stacks the leaves at every call, :179-186).  The template expert's
forward runs under ``torch.vmap`` over the stacks
(``torch.func.functional_call``); an autograd ``Function`` hands each
expert its row of the stacked gradients.  The state-dict names stay
``experts.<i>.<name>``, the JAX ones, so
``models.port_state_dict_from_jax`` carries them as they are.

``dropped_tokens`` is a device scalar: the choices this rank dropped at
the last forward (read it after the step; the layer itself never reads
it).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from .....distributed import collective
from .....nn.layer.container import LayerList
from .....nn.layer_base import Layer
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate

__all__ = ["MoELayer"]


def _signature(layer: nn.Module) -> tuple:
    mods = tuple((n, type(m).__name__) for n, m in layer.named_modules())
    leaves = tuple((n, tuple(t.shape), t.dtype) for n, t in
                   list(layer.named_parameters())
                   + list(layer.named_buffers()))
    return mods, leaves


class _Experts(torch.autograd.Function):
    """``apply(moe, x [E, C, H], *params)``: the experts over their rows
    of ``x``; ``params`` are every expert's parameters, leaf by leaf, so
    autograd gives each one its gradient (its row of the stack's)."""

    @staticmethod
    def forward(ctx, moe, x, *params):
        stacks = moe._stacks
        with torch.enable_grad():
            xs = x.detach().requires_grad_(x.requires_grad)
            leaves = {n: s.detach().requires_grad_(True)
                      for n, s in stacks.items()}
            out = torch.vmap(moe._one_expert)(leaves, xs)
        ctx.graph = (out, xs, leaves)
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        out, xs, leaves = ctx.graph
        ctx.graph = None
        inputs = list(leaves.values())
        want_x = xs.requires_grad
        if want_x:
            inputs = [xs] + inputs
        grads = torch.autograd.grad(out, inputs, grad)
        dx = grads[0] if want_x else None
        dstacks = grads[1:] if want_x else grads
        e = dstacks[0].shape[0] if dstacks else 0
        dparams = [ds[i] for ds in dstacks for i in range(e)]
        return (None, dx) + tuple(dparams)


class MoELayer(Layer):
    """``MoELayer(d_model, experts, gate=None, moe_group=None,
    mp_group=None, capacity_factor=None)`` (module docstring).

    ``experts``: this rank's structurally identical experts (all of them
    without a ``moe_group``); ``gate``: a :class:`.gate.BaseGate` or a
    config ``{"type": "gshard" | "switch" | "naive", "top_k": k}``
    (default GShard top-2), built for the group's total expert count;
    ``capacity_factor``: overrides the gate's (train, eval) pair, else
    1.2.  ``mp_group`` is taken for Paddle's signature and not used."""

    def __init__(self, d_model: int, experts, gate=None, moe_group=None,
                 mp_group=None, capacity_factor: Optional[float] = None,
                 **kwargs):
        super().__init__()
        self.d_model = d_model
        self.experts = experts if isinstance(experts, LayerList) \
            else LayerList(list(experts))
        self.group = moe_group if moe_group is not None \
            and moe_group.nranks > 1 else None
        self.ep = self.group.nranks if self.group is not None else 1
        self.num_local_expert = len(self.experts)
        self.num_expert = self.num_local_expert * self.ep
        self.capacity_factor = (float(capacity_factor)
                                if capacity_factor is not None else None)
        if gate is None:
            gate = {"type": "gshard", "top_k": 2}
        if isinstance(gate, dict):
            kind = gate.get("type", "gshard")
            if kind == "naive":
                gate = NaiveGate(d_model, self.num_expert,
                                 top_k=gate.get("top_k", 2))
            elif kind == "gshard":
                gate = GShardGate(d_model, self.num_expert, top_k=2)
            elif kind == "switch":
                gate = SwitchGate(d_model, self.num_expert, top_k=1)
            else:
                raise ValueError(f"unknown gate type {kind!r}")
        if not isinstance(gate, BaseGate):
            raise TypeError("gate must be a BaseGate or config dict")
        if gate.num_expert != self.num_expert:
            raise ValueError(f"gate scores {gate.num_expert} experts, the "
                             f"group holds {self.num_expert}")
        gate.group = self.group
        self.gate = gate
        self.top_k = gate.top_k
        sig0 = _signature(self.experts[0])
        for e in self.experts:
            if _signature(e) != sig0:
                raise ValueError("experts must be structurally identical")
        self._leaf_names = [n for n, _ in self.experts[0].named_parameters()]
        self._stacks: Dict[str, torch.Tensor] = {}
        self.dropped_tokens: Optional[torch.Tensor] = None

    @property
    def l_aux(self):
        return self.gate.get_loss()

    # -- the stacked experts ----------------------------------------------

    def _expert_params(self) -> List[List[nn.Parameter]]:
        """``[leaf][expert]`` parameters."""
        per = [dict(e.named_parameters()) for e in self.experts]
        return [[p[n] for p in per] for n in self._leaf_names]

    def _stacked(self) -> bool:
        for name, ps in zip(self._leaf_names, self._expert_params()):
            s = self._stacks.get(name)
            if s is None or s.dtype != ps[0].dtype \
                    or s.device != ps[0].device:
                return False
            step = s.stride(0) * s.element_size()
            base = s.data_ptr()
            for i, p in enumerate(ps):
                if p.data_ptr() != base + i * step \
                        or p.shape != s.shape[1:]:
                    return False
        return True

    @torch.no_grad()
    def _stack(self) -> None:
        """Give every expert parameter a row of one stack per leaf."""
        if self._stacked():
            return
        first = next(iter(self.experts[0].parameters()), None)
        if first is not None and first.is_cuda \
                and torch.cuda.is_current_stream_capturing():
            from .....jit import CaptureError

            raise CaptureError(
                "MoELayer: its experts' parameters were given new storage "
                "since the last forward outside the capture; run a step "
                "eagerly before capturing it")
        for name, ps in zip(self._leaf_names, self._expert_params()):
            s = torch.stack([p.detach() for p in ps])
            for i, p in enumerate(ps):
                p.data = s[i]
            self._stacks[name] = s

    def _one_expert(self, leaves, x):
        return functional_call(self.experts[0], leaves, (x,))

    # -- forward ------------------------------------------------------------

    def _capacity(self, n_total: int) -> int:
        cf = self.capacity_factor
        if cf is None:
            cf = (self.gate.capacity_factor(self.training)
                  if hasattr(self.gate, "capacity_factor") else 1.2)
        return int(math.ceil(self.top_k * n_total / self.num_expert * cf))

    def _positions(self, idx_f: torch.Tensor, n: int) -> torch.Tensor:
        """Each choice's position in its expert's whole-batch queue
        (``idx_f``: ``[k n]`` expert ids, choice-major)."""
        E, K = self.num_expert, self.top_k
        # [K, E, n]: the token axis innermost, where a scan is fast
        per_k = (idx_f.view(K, 1, n) == torch.arange(
            E, device=idx_f.device).view(1, E, 1)).to(torch.int32)
        within = per_k.cumsum(dim=-1, dtype=torch.int32) - 1   # [K, E, n]
        counts = per_k.sum(dim=-1, dtype=torch.int32)          # [K, E]
        if self.group is None:
            before = counts.cumsum(dim=0, dtype=torch.int32) - counts
        else:
            every = torch.empty((self.ep * K, E), dtype=counts.dtype,
                                device=counts.device)
            dist.all_gather_into_tensor(every, counts.contiguous(),
                                        group=self.group.process_group)
            every = every.view(self.ep, K, E)
            me = self.group.rank
            total = every.sum(dim=0, dtype=torch.int32)        # [K, E]
            before = (total.cumsum(dim=0, dtype=torch.int32) - total) \
                + every[:me].sum(dim=0, dtype=torch.int32)
        pos = within + before[:, :, None]
        return (pos * per_k).sum(dim=1).reshape(-1).long()     # [K n]

    def forward(self, x):
        orig_shape = x.shape
        H = orig_shape[-1]
        x2 = x.reshape(-1, H)
        n = x2.shape[0]
        E, K, ep = self.num_expert, self.top_k, self.ep
        C = self._capacity(n * ep)
        self._stack()
        val, idx = self.gate(x2)                          # [n, K] f32, int
        idx_f = idx.t().reshape(-1)
        pos = self._positions(idx_f, n)
        keep = pos < C
        slot = torch.where(keep, idx_f * C + pos, torch.full_like(pos, E * C))
        if self.dropped_tokens is None \
                or self.dropped_tokens.device != x.device:
            self.dropped_tokens = torch.zeros((), dtype=torch.int64,
                                              device=x.device)
        self.dropped_tokens.copy_((~keep).sum())
        # choice-major rows: every token once a choice (x2.repeat, not an
        # index, whose backward would sort)
        buf = x2.new_zeros((E * C + 1, H)).index_add(0, slot, x2.repeat(K, 1))
        el = self.num_local_expert
        if self.group is None:
            ebuf = buf[:E * C].view(E, C, H)
        else:
            recv = collective.alltoall_autograd(
                buf[:E * C].view(ep, el * C, H), self.group)
            ebuf = recv.sum(dim=0).view(el, C, H)
        if torch.is_grad_enabled():
            params = [p for ps in self._expert_params() for p in ps]
            eout = _Experts.apply(self, ebuf, *params)    # [el, C, H]
        else:
            eout = torch.vmap(self._one_expert)(self._stacks, ebuf)
        if self.group is not None:
            eout = collective.alltoall_autograd(
                eout.reshape(1, el * C, H).expand(ep, el * C, H)
                .contiguous(), self.group)
        flat_out = torch.cat([eout.reshape(E * C, H),
                              eout.new_zeros((1, H))], dim=0)
        w_f = val.float().t().reshape(-1) * keep.float()
        y = (flat_out.index_select(0, slot).float() * w_f[:, None]) \
            .view(K, n, H).sum(0)
        return y.to(x.dtype).reshape(orig_shape)
