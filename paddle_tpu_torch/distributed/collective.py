"""Functional collectives and communication groups over ``torch.distributed``.

Port of ``paddle_tpu/distributed/collective.py``: ``ReduceOp`` (with
``PROD`` and ``AVG``), ``Group``, ``new_group``, ``get_group``,
``all_reduce``, ``all_reduce_chunked``, ``all_gather``, ``broadcast``,
``reduce``, ``scatter``, ``alltoall``, ``reduce_scatter``, ``barrier``,
``send``, ``recv`` and ``ppermute``, and two differentiable forms for
layers that communicate inside a model's forward:
:func:`all_reduce_autograd` (a sum whose backward all-reduces the
gradient) and :func:`alltoall_autograd` (whose backward is the transposed
exchange, another all-to-all).

The data model is Paddle's own, not the JAX package's: every rank runs
this code on its own tensor (one process per rank, NCCL on the card, gloo
on the CPU).  The JAX functions take one *rank-stacked* tensor whose
leading axis indexes the group's ranks; here rank ``i`` of a group holds
what row ``i`` of that stacked tensor holds, and each function leaves on
it what row ``i`` of the JAX result holds.  Ranks (``src``, ``dst``) are
global, as in Paddle; ``ppermute``'s pairs are positions in the group, as
in the JAX function.  In-place functions write into the tensor they are
given and return it.

A group is made collectively (every rank asks for the same groups in the
same order, :func:`..mesh.process_group`); a group of one rank made by
:func:`new_group` holds no process group, and every function on it is the
identity.  The world group keeps its process group even at one rank, so
a world of one runs each collective through its backend.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from . import mesh as mesh_mod

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_reduce_chunked", "all_gather", "broadcast", "reduce",
           "scatter", "alltoall", "reduce_scatter", "barrier", "send",
           "recv", "ppermute", "all_reduce_autograd", "alltoall_autograd"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             # AVG is a SUM divided after it (gloo has no AVG)
             ReduceOp.AVG: dist.ReduceOp.SUM}


class Group:
    """The global ``ranks`` of a group (in group order) and its
    ``process_group`` (None for a group of one made by :func:`new_group`)."""

    def __init__(self, ranks: Sequence[int], gid: int = 0, pg=None):
        self.ranks = [int(r) for r in ranks]
        self.id = gid
        self.process_group = pg

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self) -> int:
        """This process's position in the group, -1 outside it."""
        return self.get_group_rank(dist.get_rank()
                                   if dist.is_initialized() else 0)

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self) -> bool:
        return self.rank >= 0

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_groups: List[Group] = []


def _world_group() -> Group:
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed world: call "
                           "paddle_tpu_torch.distributed.init_parallel_env "
                           "(or fleet.init) first")
    world = id(dist.group.WORLD)
    if not _groups or getattr(_groups[0], "_world", None) != world:
        # a new default group (the last one destroyed): its groups are new
        g = Group(range(dist.get_world_size()), 0, dist.group.WORLD)
        g._world = world
        _groups[:] = [g]
    return _groups[0]


def new_group(ranks: Optional[Sequence[int]] = None, backend=None,
              timeout=None) -> Group:
    """A group over global ``ranks`` (all by default): collective over the
    world, as ``dist.new_group`` is."""
    world = _world_group()
    ranks = world.ranks if ranks is None else [int(r) for r in ranks]
    pg = mesh_mod.process_group(ranks) if len(ranks) > 1 else None
    g = Group(ranks, gid=len(_groups), pg=pg)
    _groups.append(g)
    return g


def get_group(gid: int = 0) -> Optional[Group]:
    if gid == 0:
        return _world_group()
    for g in _groups:
        if g.id == gid:
            return g
    return None


def _group(group) -> Group:
    return group if isinstance(group, Group) else _world_group()


def _live(g: Group) -> bool:
    """Whether a collective on ``g`` communicates from this rank."""
    return g.process_group is not None and g.is_member()


def _check_rank(g: Group, rank: int, api: str, role: str) -> None:
    if rank not in g.ranks:
        raise ValueError(f"{api}: {role} rank {rank} is not in group "
                         f"{g.ranks}")


def _avg(t: torch.Tensor, op, n: int) -> torch.Tensor:
    if op == ReduceOp.AVG:
        t.div_(n)
    return t


def all_reduce(tensor: torch.Tensor, op=ReduceOp.SUM, group=None,
               sync_op: bool = True) -> torch.Tensor:
    """Every rank's ``tensor`` becomes the reduction over the group."""
    g = _group(group)
    if _live(g):
        dist.all_reduce(tensor, op=_TORCH_OP[op], group=g.process_group)
        _avg(tensor, op, g.nranks)
    return tensor


def all_reduce_chunked(tensor: torch.Tensor, chunks: int = 1,
                       op=ReduceOp.SUM, group=None) -> torch.Tensor:
    """:func:`all_reduce` issued as ``chunks`` reductions of equal slices
    of the last dim (one when ``chunks`` does not divide it)."""
    last = tensor.shape[-1] if tensor.dim() > 1 else 1
    if chunks <= 1 or last % chunks != 0:
        return all_reduce(tensor, op=op, group=group)
    parts = [c.contiguous() for c in tensor.chunk(chunks, dim=-1)]
    for p in parts:
        all_reduce(p, op=op, group=group)
    tensor.copy_(torch.cat(parts, dim=-1))
    return tensor


def all_gather(tensor_or_list, tensor: Optional[torch.Tensor] = None,
               group=None, sync_op: bool = True):
    """``all_gather(tensor)``: ``[nranks, *tensor.shape]``, row ``i``
    rank ``i``'s tensor; ``all_gather(tensor_list, tensor)``: the list
    refilled with each rank's tensor (Paddle's form)."""
    g = _group(group)
    as_list = isinstance(tensor_or_list, list)
    src = tensor if as_list else tensor_or_list
    if _live(g):
        parts = [torch.empty_like(src) for _ in range(g.nranks)]
        dist.all_gather(parts, src.contiguous(), group=g.process_group)
    else:
        parts = [src.clone()]
    if as_list:
        tensor_or_list.clear()
        tensor_or_list.extend(parts)
        return tensor_or_list
    return torch.stack(parts)


def broadcast(tensor: torch.Tensor, src: int = 0, group=None,
              sync_op: bool = True) -> torch.Tensor:
    """Every rank's ``tensor`` becomes global rank ``src``'s."""
    g = _group(group)
    _check_rank(g, src, "broadcast", "src")
    if _live(g):
        dist.broadcast(tensor, src, group=g.process_group)
    return tensor


def reduce(tensor: torch.Tensor, dst: int = 0, op=ReduceOp.SUM, group=None,
           sync_op: bool = True) -> torch.Tensor:
    """Global rank ``dst``'s ``tensor`` becomes the reduction; the other
    ranks keep theirs."""
    g = _group(group)
    _check_rank(g, dst, "reduce", "dst")
    if _live(g):
        # a backend may use a non-root's buffer as scratch: reduce a copy
        work = tensor.clone()
        dist.reduce(work, dst, op=_TORCH_OP[op], group=g.process_group)
        if dist.get_rank() == dst:
            tensor.copy_(_avg(work, op, g.nranks))
    return tensor


def scatter(tensor: torch.Tensor, tensor_list=None, src: int = 0,
            group=None, sync_op: bool = True) -> torch.Tensor:
    """Rank ``i``'s ``tensor`` becomes entry ``i`` of ``src``'s
    ``tensor_list`` (a list, or a tensor whose rows are the entries)."""
    g = _group(group)
    _check_rank(g, src, "scatter", "src")
    me = dist.get_rank() if dist.is_initialized() else 0
    if not _live(g):
        if tensor_list is not None:
            tensor.copy_(tensor_list[0])
        return tensor
    chunks = None
    if me == src:
        chunks = [t.contiguous() for t in tensor_list]
    out = torch.empty_like(tensor)
    dist.scatter(out, chunks, src=src, group=g.process_group)
    tensor.copy_(out)
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op: bool = True):
    """Rank ``i`` sends entry ``j`` of its input to rank ``j``; entry
    ``j`` of its output is what rank ``j`` sent it.  The input is a list,
    or a tensor whose rows are the entries (then the output is one too);
    ``out_tensor_list`` is refilled when given."""
    g = _group(group)
    as_list = isinstance(in_tensor_list, list)
    src = torch.stack(in_tensor_list) if as_list else in_tensor_list
    if src.shape[0] != g.nranks:
        raise ValueError(f"alltoall: {src.shape[0]} entries for a group of "
                         f"{g.nranks}")
    out = torch.empty_like(src)
    if _live(g):
        dist.all_to_all_single(out, src.contiguous(), group=g.process_group)
    else:
        out.copy_(src)
    if out_tensor_list is not None:
        out_tensor_list.clear()
        out_tensor_list.extend(out.unbind(0))
        return out_tensor_list
    return out


def reduce_scatter(tensor: torch.Tensor, tensor_or_list=None,
                   op=ReduceOp.SUM, group=None, sync_op: bool = True):
    """Rank ``i`` gets row ``i`` of the reduction of every rank's input.
    ``reduce_scatter(x)`` takes ``x`` (rows one per rank) and returns the
    row; ``reduce_scatter(out, inputs)`` (Paddle's form: a list or a
    row tensor) writes it into ``out``."""
    g = _group(group)
    src = tensor if tensor_or_list is None else tensor_or_list
    if isinstance(src, list):
        src = torch.stack(src)
    if src.shape[0] != g.nranks:
        raise ValueError(f"reduce_scatter: {src.shape[0]} rows for a group "
                         f"of {g.nranks}")
    row = torch.empty_like(src[0])
    if _live(g):
        # flat buffers: a 0-d row crashes gloo's reduce-scatter
        flat = torch.empty(row.numel(), dtype=row.dtype, device=row.device)
        dist.reduce_scatter_tensor(flat, src.reshape(-1).contiguous(),
                                   op=_TORCH_OP[op], group=g.process_group)
        row.copy_(_avg(flat, op, g.nranks).view_as(row))
    else:
        row.copy_(src[0])
    if tensor_or_list is None:
        return row
    tensor.copy_(row)
    return tensor


def barrier(group=None) -> None:
    g = _group(group)
    if _live(g):
        dist.barrier(group=g.process_group)


def send(tensor: torch.Tensor, dst: int = 0, group=None,
         sync_op: bool = True) -> None:
    """Send ``tensor`` to global rank ``dst`` (blocking)."""
    dist.send(tensor.contiguous(), dst, group=_group(group).process_group)


def recv(tensor: torch.Tensor, src: int = 0, group=None,
         sync_op: bool = True) -> torch.Tensor:
    """Receive into ``tensor`` from global rank ``src`` (blocking)."""
    dist.recv(tensor, src, group=_group(group).process_group)
    return tensor


def _permute(t: torch.Tensor, perm, g: Group) -> torch.Tensor:
    """Rank at position ``d`` gets the tensor of position ``s`` for each
    pair ``(s, d)``; a position no pair names gets zeros."""
    me = g.rank
    out = torch.zeros_like(t)
    if not _live(g):
        for s, d in perm:
            if s == d == me:
                out.copy_(t)
        return out
    ops = []
    src = t.contiguous()
    for s, d in perm:
        if s == me and d != me:
            ops.append(dist.P2POp(dist.isend, src, g.ranks[d],
                                  g.process_group))
        if d == me and s != me:
            ops.append(dist.P2POp(dist.irecv, out, g.ranks[s],
                                  g.process_group))
        if s == d == me:
            out.copy_(t)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, perm, g):
        ctx.perm, ctx.g = perm, g
        return _permute(t, perm, g)

    @staticmethod
    def backward(ctx, grad):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(grad.contiguous(), inverse, ctx.g), None, None


def ppermute(tensor: torch.Tensor, perm: Sequence, group=None
             ) -> torch.Tensor:
    """Collective permute over the group's positions (the JAX package's
    p2p primitive): the result on position ``d`` is position ``s``'s
    ``tensor`` for each pair ``(s, d)`` of ``perm``, zeros where no pair
    ends.  Differentiable: the gradient takes the inverse permutation."""
    g = _group(group)
    perm = [(int(s), int(d)) for s, d in perm]
    return _PPermute.apply(tensor, perm, g)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, g):
        ctx.g = g
        return all_reduce(t.clone(), group=g)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), group=ctx.g), None


def all_reduce_autograd(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The group's sum of ``tensor``, a new tensor, differentiable: each
    rank's loss adds to one total, so a rank's gradient of its input is the
    group's sum of the gradients of the output."""
    return _AllReduceSum.apply(tensor, _group(group))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, g):
        ctx.g = g
        return alltoall(t, group=g)

    @staticmethod
    def backward(ctx, grad):
        return alltoall(grad.contiguous(), group=ctx.g), None


def alltoall_autograd(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`alltoall` of a row tensor (row ``j`` to rank ``j``),
    differentiable: the gradient goes back by the same exchange."""
    return _AllToAll.apply(tensor, _group(group))
