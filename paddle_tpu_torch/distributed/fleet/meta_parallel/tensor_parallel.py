"""The model wrappers of hybrid parallelism: ``TensorParallel`` and
``ShardingParallel``.

Port of ``paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py``
(``place_parameters`` :27, ``shard_batch`` :48, ``TensorParallel`` :125,
``ShardingParallel`` :143) for one process per rank:

- :func:`place_parameters` makes the ranks agree when the wrapper is made:
  every parameter and buffer is broadcast from the first rank of its
  data x sharding (x sep) group, and one that is whole on every model
  rank (not ``is_distributed``) from the first rank of its model group
  too.
- Each data-parallel rank keeps its own slice of the batch: a wrapper
  runs the model on what it is given, the rank's local batch;
  :func:`shard_batch` cuts that slice (over data, then sharding, as the
  JAX package's ``("data", "sharding")`` batch axes order it) out of a
  global batch for a caller that holds the whole one.  While the wrapped
  model runs, dropout draws at the slice's place in the global batch
  (:func:`....rng.shard_coordinates`).  Under a sep degree each rank
  keeps its chunk of the sequence (dim 1), which :func:`shard_sequence`
  cuts out of a whole one; the model places it at its global positions
  and attention runs the ring over the sep group.
- At ZeRO stage 3 each rank keeps its own parameters between steps (the
  hybrid optimizer releases the others after its update); the wrapper's
  forward gathers them back from their owners first.

``state_dict`` and ``load_state_dict`` are the wrapped model's (no
``_layers.`` prefix), and its attributes, ``compute_loss`` included,
read through.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from .... import rng as rng_mod
from ... import collective
from ..topology import get_hybrid_communicate_group
from .mp_layers import is_split

__all__ = ["place_parameters", "shard_batch", "shard_sequence",
           "TensorParallel", "ShardingParallel"]


@torch.no_grad()
def place_parameters(model: nn.Module, hcg=None) -> nn.Module:
    """Broadcast ``model``'s parameters and buffers so the ranks agree
    (see the module)."""
    hcg = hcg or get_hybrid_communicate_group()
    if hcg is None:
        return model
    check = hcg.get_dp_sep_parallel_group()
    mp = hcg.get_model_parallel_group()
    for t in list(model.parameters()) + list(model.buffers()):
        if check.nranks > 1:
            collective.broadcast(t.data, check.ranks[0], check)
        if mp.nranks > 1 and not is_split(t):
            collective.broadcast(t.data, mp.ranks[0], mp)
    return model


def shard_batch(t, hcg=None):
    """This rank's slice of the global batch ``t`` (its dim 0, data-major
    over the data and sharding axes); ``t`` itself when the batch axes
    have one rank, or ``t`` is not a tensor."""
    hcg = hcg or get_hybrid_communicate_group()
    if not isinstance(t, torch.Tensor) or hcg is None or t.dim() == 0:
        return t
    n = hcg.get_data_parallel_world_size() * \
        hcg.get_sharding_parallel_world_size()
    if n == 1:
        return t
    size = t.shape[0]
    if size % n:
        raise ValueError(f"shard_batch: batch {size} does not split over "
                         f"{n} data x sharding ranks")
    local = size // n
    return t.narrow(0, hcg.get_batch_rank() * local, local)


def shard_sequence(t, hcg=None, dim: int = 1):
    """This rank's chunk of the sequence dim of ``t`` (sep rank ``r`` of
    ``p`` takes the ``r``-th of ``p`` equal chunks); ``t`` itself when
    the sep axis has one rank, or ``t`` is not a tensor."""
    hcg = hcg or get_hybrid_communicate_group()
    if not isinstance(t, torch.Tensor) or hcg is None or t.dim() <= dim:
        return t
    p = hcg.get_sep_parallel_world_size()
    if p == 1:
        return t
    size = t.shape[dim]
    if size % p:
        raise ValueError(f"shard_sequence: sequence {size} does not split "
                         f"over {p} sep ranks")
    s = size // p
    return t.narrow(dim, hcg.get_sep_parallel_rank() * s, s)


class _ParallelWrapperBase(nn.Module):
    def __init__(self, layers: nn.Module, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg or get_hybrid_communicate_group()
        self._strategy = strategy
        place_parameters(layers, self._hcg)

    def _batch_coordinates(self, args):
        """Dropout at this rank's place in the global batch."""
        hcg = self._hcg
        first = next((a for a in args if isinstance(a, torch.Tensor)
                      and a.dim()), None)
        if hcg is None or first is None or hcg.get_batch_rank() == 0:
            return contextlib.nullcontext()
        return rng_mod.shard_coordinates(
            batch_start=hcg.get_batch_rank() * first.shape[0])

    def _prepare(self) -> None:
        from ..hybrid_optimizer import gather_params

        gather_params(self._layers.parameters())

    def forward(self, *inputs, **kwargs):
        self._prepare()
        with self._batch_coordinates(inputs):
            return self._layers(*inputs, **kwargs)

    def compute_loss(self, *args, **kwargs):
        """The wrapped model's ``compute_loss``, run as ``forward`` runs
        the model."""
        self._prepare()
        with self._batch_coordinates(args):
            return self._layers.compute_loss(*args, **kwargs)

    def state_dict(self, *a, **k):
        self._prepare()
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, *a, **k):
        self._prepare()
        return self._layers.load_state_dict(*a, **k)

    set_state_dict = load_state_dict

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)


class TensorParallel(_ParallelWrapperBase):
    """The wrapper of a model with tensor-parallel layers (and of any
    model under a data or sharding degree above 1)."""


class ShardingParallel(_ParallelWrapperBase):
    """The wrapper :func:`..sharding.group_sharded_parallel` gives a
    ZeRO stage-3 model."""
