"""MoE gates (port of ``paddle_tpu/incubate/distributed/models/moe/
gate.py``).

A gate maps tokens ``[N, H]`` to ``(combine weights [N, k] f32, expert ids
[N, k] int64)`` and records its load-balancing loss in ``self.loss``
(``get_loss()``).  The scores are an f32 softmax over the gate's
projection.  Under expert parallelism (``group`` of more than one rank,
set by :class:`.moe_layer.MoELayer`) the loss is the whole batch's: its
per-expert sums are all-reduced over the group, differentiably, so every
rank holds the same value.

``GShardGate``'s random second-expert routing (GShard §3.2: the second
expert is kept with probability ``min(1, 2 w2)``, its weight zeroed
otherwise) draws its uniforms from the port's Philox generator
(:mod:`....ops.random`), not ``jax.random``: the law carries over, not
the bits.  Parity with the JAX gate therefore turns it off, or runs in
evaluation mode, where it never routes randomly.
"""
from __future__ import annotations

import torch

from .....distributed import collective
from .....nn import functional as F
from .....nn import initializer as I
from .....nn.layer.common import Linear
from .....nn.layer_base import Layer
from .....ops.random import rand_like

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]


class BaseGate(Layer):
    def __init__(self, num_expert: int, top_k: int):
        super().__init__()
        self.num_expert = num_expert
        self.top_k = top_k
        self.loss = None
        #: the expert-parallel group (None: one rank holds every expert)
        self.group = None

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self):
        return self.loss


class NaiveGate(BaseGate):
    """Softmax top-k routing, no auxiliary loss."""

    def __init__(self, d_model: int, num_expert: int, top_k: int = 2):
        super().__init__(num_expert, top_k)
        self.gate = Linear(d_model, num_expert,
                           weight_attr=I.Normal(std=0.02))

    def _scores(self, x):
        return F.softmax(self.gate(x).float(), axis=-1)

    def forward(self, x):
        val, idx = torch.topk(self._scores(x), self.top_k, dim=-1)
        self.set_loss(None)
        return val, idx


def _aux_load_balance(scores, top1_idx, num_expert: int, group=None):
    """The GShard/Switch balance loss ``E * sum_e mean_prob_e *
    frac_e``, ``frac_e`` the share of tokens whose first choice is ``e``,
    both over the whole batch (summed over ``group``, whose ranks hold
    equal shards)."""
    prob = scores.sum(dim=0)
    frac = (top1_idx[:, None] == torch.arange(
        num_expert, device=top1_idx.device)).float().sum(0)
    n = scores.shape[0]
    if group is not None:
        both = collective.all_reduce_autograd(
            torch.cat([prob, frac]), group)
        prob, frac = both[:num_expert], both[num_expert:].detach()
        n *= group.nranks
    return ((prob / n) * (frac / n)).sum() * num_expert


class GShardGate(NaiveGate):
    """Top-2 routing with the balance loss, a (train, eval) capacity
    factor pair and random second-expert routing (module docstring)."""

    def __init__(self, d_model: int, num_expert: int, top_k: int = 2,
                 capacity=(1.2, 2.4), random_routing: bool = True):
        if top_k != 2:
            raise ValueError("GShardGate works with top_k=2")
        super().__init__(d_model, num_expert, top_k)
        self.capacity = tuple(capacity)
        self.random_routing = random_routing

    def capacity_factor(self, training: bool) -> float:
        return self.capacity[0] if training else self.capacity[1]

    def forward(self, x):
        scores = self._scores(x)
        val, idx = torch.topk(scores, 2, dim=-1)
        self.set_loss(_aux_load_balance(scores, idx[:, 0], self.num_expert,
                                        self.group))
        if self.random_routing and self.training:
            keep2 = (2.0 * val[:, 1:2] > rand_like(val[:, 1:2])).to(
                val.dtype)
            val = torch.cat([val[:, 0:1], val[:, 1:2] * keep2], dim=-1)
        return val, idx


class SwitchGate(NaiveGate):
    """Top-1 routing with the balance loss and a (train, eval) capacity
    factor pair."""

    def __init__(self, d_model: int, num_expert: int, top_k: int = 1,
                 capacity=(1.2, 2.4)):
        if top_k != 1:
            raise ValueError("SwitchGate is top-1")
        super().__init__(d_model, num_expert, top_k)
        self.capacity = tuple(capacity)

    def capacity_factor(self, training: bool) -> float:
        return self.capacity[0] if training else self.capacity[1]

    def forward(self, x):
        scores = self._scores(x)
        val, idx = torch.topk(scores, 1, dim=-1)
        self.set_loss(_aux_load_balance(scores, idx[:, 0], self.num_expert,
                                        self.group))
        return val, idx
