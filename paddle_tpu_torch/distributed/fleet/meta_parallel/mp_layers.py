"""Megatron tensor-parallel layers on a ``torch.distributed`` group.

Port of ``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/
mp_layers.py`` (``VocabParallelEmbedding`` :42, ``ColumnParallelLinear``
:71, ``RowParallelLinear`` :114).  The JAX layers annotate their
parameters and let GSPMD place the collectives; here each rank holds its
shard and issues them itself:

- :class:`ColumnParallelLinear`: the rank's out-features, ``x @ W_r^T +
  b_r``; ``gather_output`` all-gathers them along the last dim.  A fused
  projection of ``parts`` equal blocks (Llama's ``[gate | up]``) holds the
  rank's slice of each block, so that the split after it stays local.
- :class:`RowParallelLinear`: the rank's in-features, a partial product,
  an ``all_reduce``; the bias is added once, after the reduce.  On a group
  of one the bias goes into the matmul (the reduce is the identity), so a
  mesh of one computes exactly what ``nn.Linear`` does.
- :class:`VocabParallelEmbedding`: the rank's rows of the vocabulary, a
  masked local lookup, an ``all_reduce``.

Both linears subclass ``nn.Linear`` (their ``in_features`` and
``out_features`` are the rank's), so a state dict names them as it names
the plain layers.  A LoRA adapter reaches them through ``lora``: a
``(module, (x,), out)`` callable applied to the rank's output before the
gather or the reduce (:mod:`...serving.adapters`).

The layers serve: they run forward only (under ``no_grad``), and no
gradient flows through their collectives; training through them, with
``ParallelCrossEntropy``, is ROADMAP.md A.5 step 6.

:func:`shard_layout` gives the global shape and index ranges of a
layer's sharded parameter (or a tensor sharing its memory, as
``state_dict()`` gives it): what a checkpoint records for the rank's
blocks (:mod:`paddle_tpu_torch.distributed.checkpoint`).

Every collective adds one to :data:`COLLECTIVES` (host side, where it is
issued).  The step programs capture these calls in CUDA graphs: a capture
moves its counts to the replays, as they do with the kernels' launches.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

__all__ = ["COLLECTIVES", "collective_counts", "add_collectives",
           "reset_collectives", "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "gather_last", "shard_index",
           "shard_layout"]

#: every live tensor-parallel layer, for :func:`shard_layout`
_LAYERS: "weakref.WeakSet" = weakref.WeakSet()

#: a sharded tensor's ``(global shape, [box, ...], spec)``: each box a
#: ``[lo, hi)`` range per dim, in the order the rank's tensor holds them
Layout = Tuple[List[int], List[List[List[int]]], List[Optional[str]]]


def _blocks(full: int, rank: int, mp: int, parts: int, dim: int,
            other: Optional[int]) -> List[List[List[int]]]:
    """The boxes of a rank's ``1/mp`` of each of ``parts`` equal blocks
    along ``dim`` of a 2-D (``other`` the other dim's size) or 1-D
    tensor."""
    part, n = full // parts, full // (parts * mp)
    boxes = []
    for p in range(parts):
        rng = [p * part + rank * n, p * part + (rank + 1) * n]
        box = [rng] if other is None else \
            ([rng, [0, other]] if dim == 0 else [[0, other], rng])
        boxes.append(box)
    return boxes


def shard_layout(t: torch.Tensor) -> Optional[Layout]:
    """``(global shape, boxes, spec)`` of ``t`` if it is (or shares the
    memory of) a sharded parameter of a tensor-parallel layer on a group
    of more than one rank; else None."""
    if t.device.type == "meta":
        return None
    ptr, shape = t.data_ptr(), tuple(t.shape)
    for layer in list(_LAYERS):
        if layer.mp == 1:
            continue
        for pname in ("weight", "bias"):
            p = getattr(layer, pname, None)
            if p is not None and p.data_ptr() == ptr \
                    and tuple(p.shape) == shape:
                return layer._layout(pname)
    return None


#: collectives issued, by kind
COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}


def collective_counts() -> Dict[str, int]:
    return dict(COLLECTIVES)


def add_collectives(counts: Dict[str, int]) -> None:
    for k, c in counts.items():
        COLLECTIVES[k] += c


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


#: ``all_gather_single`` where this torch has it (its older name is
#: deprecated there), else ``all_gather_into_tensor``
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, group=group)
    return t


def gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """All-gather ``t`` over ``group`` along its last dim, ranks in group
    order."""
    n = dist.get_world_size(group)
    lead = tuple(t.shape[:-1])
    t = t.contiguous().view(-1, t.shape[-1])
    rows, cols = t.shape
    # the ranks' blocks along dim 0 (the layout both gloo and NCCL take)
    buf = torch.empty((n * rows, cols), dtype=t.dtype, device=t.device)
    COLLECTIVES["all_gather"] += 1
    _all_gather_single(buf, t, group=group)
    return buf.view(n, rows, cols).transpose(0, 1).reshape(*lead, n * cols)


def shard_index(size: int, rank: int, mp: int, parts: int = 1
                ) -> torch.Tensor:
    """The indices along a dim of ``size`` that rank ``rank`` of ``mp``
    holds: its contiguous ``1/mp`` of each of ``parts`` equal blocks."""
    if size % (parts * mp) != 0:
        raise ValueError(f"dim {size} does not split into {parts} part(s) "
                         f"over {mp} ranks")
    part, n = size // parts, size // (parts * mp)
    return torch.cat([torch.arange(p * part + rank * n,
                                   p * part + (rank + 1) * n)
                      for p in range(parts)])


def _group_of(group):
    mp = dist.get_world_size(group)
    return mp, dist.get_rank(group)


class ColumnParallelLinear(nn.Linear):
    """``nn.Linear(in, out)`` with the out-features split over ``group``
    (``out % (parts * mp) == 0``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, group, gather_output: bool = False,
                 parts: int = 1, device=None, dtype=None):
        mp, rank = _group_of(group)
        if out_features % (parts * mp) != 0:
            raise ValueError(f"ColumnParallelLinear: {out_features} "
                             f"out-features in {parts} part(s) do not "
                             f"split over {mp} ranks")
        super().__init__(in_features, out_features // mp, bias,
                         device=device, dtype=dtype)
        self.group, self.mp, self.rank = group, mp, rank
        self.full_out_features = out_features
        self.parts = int(parts)
        self.gather_output = gather_output
        self.lora = None
        _LAYERS.add(self)

    def local_index(self) -> torch.Tensor:
        return shard_index(self.full_out_features, self.rank, self.mp,
                           self.parts)

    def _layout(self, pname: str) -> Layout:
        full = self.full_out_features
        if pname == "weight":
            return ([full, self.in_features],
                    _blocks(full, self.rank, self.mp, self.parts, 0,
                            self.in_features),
                    ["model", None])
        return ([full], _blocks(full, self.rank, self.mp, self.parts, 0,
                                None), ["model"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.linear(x, self.weight, self.bias)
        if self.lora is not None:
            out = self.lora(self, (x,), out)
        if self.gather_output:
            out = gather_last(out, self.group)
        return out


class RowParallelLinear(nn.Linear):
    """``nn.Linear(in, out)`` with the in-features split over ``group``:
    its input is the rank's slice (a column layer's local output)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, group, device=None, dtype=None):
        mp, rank = _group_of(group)
        if in_features % mp != 0:
            raise ValueError(f"RowParallelLinear: {in_features} "
                             f"in-features do not split over {mp} ranks")
        super().__init__(in_features // mp, out_features, bias,
                         device=device, dtype=dtype)
        self.group, self.mp, self.rank = group, mp, rank
        self.full_in_features = in_features
        self.lora = None
        _LAYERS.add(self)

    def local_index(self) -> torch.Tensor:
        return shard_index(self.full_in_features, self.rank, self.mp)

    def _layout(self, pname: str) -> Optional[Layout]:
        if pname != "weight":
            return None                   # the bias is whole on every rank
        full = self.full_in_features
        return ([self.out_features, full],
                _blocks(full, self.rank, self.mp, 1, 1, self.out_features),
                [None, "model"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fused = self.mp == 1
        out = F.linear(x, self.weight, self.bias if fused else None)
        if self.lora is not None:
            # the rank's share of the delta joins its partial product
            out = self.lora(self, (x,), out)
        out = _all_reduce(out, self.group)
        if self.bias is not None and not fused:
            out = out + self.bias
        return out


class VocabParallelEmbedding(nn.Embedding):
    """``nn.Embedding(V, H)`` with the vocabulary rows split over
    ``group``."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *, group,
                 device=None, dtype=None):
        mp, rank = _group_of(group)
        if num_embeddings % mp != 0:
            raise ValueError(f"VocabParallelEmbedding: vocabulary "
                             f"{num_embeddings} does not split over {mp} "
                             f"ranks")
        super().__init__(num_embeddings // mp, embedding_dim,
                         device=device, dtype=dtype)
        self.group, self.mp, self.rank = group, mp, rank
        self.full_num_embeddings = num_embeddings
        self.vocab_start = rank * (num_embeddings // mp)
        _LAYERS.add(self)

    def _layout(self, pname: str) -> Layout:
        full = self.full_num_embeddings
        return ([full, self.embedding_dim],
                _blocks(full, self.rank, self.mp, 1, 0, self.embedding_dim),
                ["model", None])

    def local_index(self) -> torch.Tensor:
        return shard_index(self.full_num_embeddings, self.rank, self.mp)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.vocab_start
        outside = (local < 0) | (local >= self.num_embeddings)
        out = F.embedding(local.masked_fill(outside, 0), self.weight)
        out = out.masked_fill(outside[..., None], 0.0)
        return _all_reduce(out, self.group)
