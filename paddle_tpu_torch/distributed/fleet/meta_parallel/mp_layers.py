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

They train too: with gradients on, each collective is an autograd
function with Megatron's pairing (``_c_identity``/``_mp_allreduce`` of
Paddle's ``collective.py``): a column layer's input is the identity
forward and an all-reduce of its gradient backward; a row layer's and the
embedding's all-reduce forward pass their gradient through; the
all-gather of ``gather_output`` (:func:`gather_last`) keeps the rank's
slice of its gradient.  Under ``no_grad`` (serving) they issue exactly
the collectives they issued before.  :class:`ParallelCrossEntropy` is the
vocab-parallel loss over a column layer's (or the vocabulary-parallel
head's) local logits.  ``group=None`` takes the model group of
``fleet.init``'s topology (none: a layer of one rank that communicates
nothing); a split parameter carries ``is_distributed = True`` (Paddle's
attribute), which the hybrid optimizer's global-norm clip reads.

:func:`shard_layout` gives the global shape and index ranges of a
layer's sharded parameter (or a tensor sharing its memory, as
``state_dict()`` gives it): what a checkpoint records for the rank's
blocks (:mod:`paddle_tpu_torch.distributed.checkpoint`).

Every collective adds one to :data:`COLLECTIVES` (host side, where it is
issued, backward ones included).  The step programs capture these calls
in CUDA graphs: a capture
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
           "VocabParallelEmbedding", "ParallelCrossEntropy", "gather_last",
           "gather_output", "c_identity", "default_group", "is_split",
           "shard_index", "shard_layout"]

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


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
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


def _last_slice(t: torch.Tensor, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    cols = t.shape[-1] // n
    return t[..., r * cols:(r + 1) * cols].contiguous()


class _CIdentity(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _MPAllReduce(torch.autograd.Function):
    """All-reduce forward (in place); the gradient passes through."""

    @staticmethod
    def forward(ctx, x, group):
        _all_reduce(x, group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """:func:`gather_last` forward; the rank's slice of the gradient
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _last_slice(g, ctx.group), None


class _SplitLast(torch.autograd.Function):
    """The rank's slice of the last dim forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _last_slice(x, group)

    @staticmethod
    def backward(ctx, g):
        return gather_last(g, ctx.group), None


def _tracked(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def c_identity(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` with its gradient all-reduced over ``group`` (the input of a
    computation split over the group); ``x`` itself without a group or a
    gradient."""
    if group is None or not _tracked(x):
        return x
    return _CIdentity.apply(x, group)


def _reduce(t: torch.Tensor, group) -> torch.Tensor:
    if _tracked(t):
        return _MPAllReduce.apply(t, group)
    return _all_reduce(t, group)


def gather_output(t: torch.Tensor, group) -> torch.Tensor:
    """:func:`gather_last`, and with a gradient the rank's slice of it
    backward."""
    if _tracked(t):
        return _GatherLast.apply(t, group)
    return gather_last(t, group)


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


def default_group():
    """The model group of ``fleet.init``'s topology when its degree is
    above 1, else None."""
    from ..topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_model_parallel_world_size() == 1:
        return None
    return hcg.get_model_parallel_group()


def _group_of(group):
    """``(process group or None, mp, rank)`` of a layer's ``group``: a
    process group, a collective ``Group``, or None (:func:`default_group`;
    no group at all is one rank that communicates nothing)."""
    if group is None:
        group = default_group()
    pg = getattr(group, "process_group", group)
    if pg is None:
        return None, 1, 0
    return pg, dist.get_world_size(pg), dist.get_rank(pg)


def is_split(t: torch.Tensor) -> bool:
    """Whether ``t`` is a parameter a tensor-parallel layer split over its
    group (``is_distributed``; ``torch.Tensor`` has a method of that name,
    which an unmarked tensor answers with)."""
    return t.__dict__.get("is_distributed") is True


def _mark_split(layer: nn.Module, *names: str) -> None:
    if layer.mp > 1:
        for n in names:
            p = getattr(layer, n, None)
            if p is not None:
                p.is_distributed = True


class ColumnParallelLinear(nn.Linear):
    """``nn.Linear(in, out)`` with the out-features split over ``group``
    (``out % (parts * mp) == 0``).  ``has_bias`` and ``mp_group`` are
    Paddle's names for ``bias`` and ``group``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, group=None, gather_output: bool = False,
                 parts: int = 1, device=None, dtype=None,
                 has_bias: Optional[bool] = None, mp_group=None):
        group, mp, rank = _group_of(group if group is not None else mp_group)
        if out_features % (parts * mp) != 0:
            raise ValueError(f"ColumnParallelLinear: {out_features} "
                             f"out-features in {parts} part(s) do not "
                             f"split over {mp} ranks")
        super().__init__(in_features, out_features // mp,
                         bias if has_bias is None else has_bias,
                         device=device, dtype=dtype)
        self.group, self.mp, self.rank = group, mp, rank
        self.full_out_features = out_features
        self.parts = int(parts)
        self.gather_output = gather_output
        self.lora = None
        _mark_split(self, "weight", "bias")
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
        x = c_identity(x, self.group) if self.mp > 1 else x
        out = F.linear(x, self.weight, self.bias)
        if self.lora is not None:
            out = self.lora(self, (x,), out)
        if self.gather_output and self.group is not None:
            out = gather_output(out, self.group)
        return out


class RowParallelLinear(nn.Linear):
    """``nn.Linear(in, out)`` with the in-features split over ``group``:
    its input is the rank's slice (a column layer's local output), or,
    with ``input_is_parallel=False``, the whole input, of which it takes
    its slice."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, group=None, device=None, dtype=None,
                 has_bias: Optional[bool] = None,
                 input_is_parallel: bool = True, mp_group=None):
        group, mp, rank = _group_of(group if group is not None else mp_group)
        if in_features % mp != 0:
            raise ValueError(f"RowParallelLinear: {in_features} "
                             f"in-features do not split over {mp} ranks")
        super().__init__(in_features // mp, out_features,
                         bias if has_bias is None else has_bias,
                         device=device, dtype=dtype)
        self.group, self.mp, self.rank = group, mp, rank
        self.full_in_features = in_features
        self.input_is_parallel = input_is_parallel
        self.lora = None
        _mark_split(self, "weight")
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
        if not self.input_is_parallel and self.mp > 1:
            x = _SplitLast.apply(x, self.group) if _tracked(x) else \
                _last_slice(x, self.group)
        fused = self.mp == 1
        out = F.linear(x, self.weight, self.bias if fused else None)
        if self.lora is not None:
            # the rank's share of the delta joins its partial product
            out = self.lora(self, (x,), out)
        if self.group is not None:
            out = _reduce(out, self.group)
        if self.bias is not None and not fused:
            out = out + self.bias
        return out


class VocabParallelEmbedding(nn.Embedding):
    """``nn.Embedding(V, H)`` with the vocabulary rows split over
    ``group``."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 group=None, device=None, dtype=None, mp_group=None):
        group, mp, rank = _group_of(group if group is not None else mp_group)
        if num_embeddings % mp != 0:
            raise ValueError(f"VocabParallelEmbedding: vocabulary "
                             f"{num_embeddings} does not split over {mp} "
                             f"ranks")
        super().__init__(num_embeddings // mp, embedding_dim,
                         device=device, dtype=dtype)
        self.group, self.mp, self.rank = group, mp, rank
        self.full_num_embeddings = num_embeddings
        self.vocab_start = rank * (num_embeddings // mp)
        _mark_split(self, "weight")
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
        return out if self.group is None else _reduce(out, self.group)


class _VocabParallelCE(torch.autograd.Function):
    """Cross entropy over logits whose last dim is split over ``group``
    (rank ``r`` holds vocabulary ``[start, start + V_local)``): the max,
    the sum of exponentials and the target's logit are each all-reduced
    over the group, all in f32.  The loss is ``[..., 1]``, 0 where the
    label is ``ignore_index``; the gradient is ``softmax - onehot`` on the
    rank's columns, 0 on ignored rows."""

    @staticmethod
    def forward(ctx, logits, label, group, start: int, ignore_index: int):
        lg = logits.float()
        n_local = lg.shape[-1]
        m = lg.max(dim=-1, keepdim=True).values
        if group is not None:
            _all_reduce(m, group, dist.ReduceOp.MAX)
        lg = lg - m
        ex = lg.exp()
        s = ex.sum(dim=-1, keepdim=True)
        lb = label.unsqueeze(-1) if label.dim() == lg.dim() - 1 else label
        lb = lb.long()
        ignored = lb == ignore_index
        local = lb - start
        inside = (local >= 0) & (local < n_local) & ~ignored
        local = local.clamp(0, n_local - 1)
        picked = torch.gather(lg, -1, local) * inside
        if group is not None:
            _all_reduce(s, group)
            _all_reduce(picked, group)
        loss = (torch.log(s) - picked).masked_fill(ignored, 0.0)
        ctx.save_for_backward(ex.div_(s), local, inside, ignored)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, local, inside, ignored = ctx.saved_tensors
        grad = softmax.scatter_add(-1, local, -inside.float())
        grad = (grad * g.float()).masked_fill(ignored, 0.0)
        return grad.to(ctx.dtype), None, None, None, None


class ParallelCrossEntropy(nn.Module):
    """Paddle's ``ParallelCrossEntropy(mp_group=None, name=None,
    ignore_index=-100)``: ``forward(input, label)`` takes the rank's
    vocabulary columns of the logits (a column layer's or the
    vocabulary-parallel head's local output) and the full labels
    (``[...]`` or ``[..., 1]``), and returns the per-token loss ``[...,
    1]`` (f32; 0 at ``ignore_index``).  On one rank it is plain cross
    entropy."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self.group, self.mp, self.rank = _group_of(mp_group)
        self.ignore_index = int(ignore_index)

    def forward(self, input: torch.Tensor, label: torch.Tensor
                ) -> torch.Tensor:
        start = self.rank * input.shape[-1]
        return _VocabParallelCE.apply(input, label, self.group, start,
                                      self.ignore_index)
