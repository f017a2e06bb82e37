"""Ring attention: context parallelism over the ``sep`` axis.

Port of ``paddle_tpu/ops/ring_attention.py`` (``ring_flash_attention``,
``_ring_inner`` :44-84) for one process per rank.  The sequence is cut
into ``p`` chunks, one a rank of the sep group; each rank keeps its query
chunk and the key/value chunks travel around the ring, one hop a tick.
Tick ``r`` on rank ``i`` sees key block ``j = (i - r) mod p``:

- tick 0 is the diagonal block, run on K1 with ``causal=True``;
- a block with ``j < i`` runs K1 non-causal (both sides are ``[B, s, H,
  D]``, so ``Sq == Sk``);
- under a causal mask a block with ``j > i`` is in the future and is
  skipped (the JAX package masks it to zero probability: the same
  values);
- the ticks' outputs are merged in f32 by their log-sum-exp: ``lse =
  logaddexp(lse, lse_t)``, ``o = o * exp(lse_old - lse) + o_t *
  exp(lse_t - lse)``.

The backward (:class:`_RingAttention`, a ``torch.autograd.Function``)
goes around the ring again: per tick K3 gives this rank's dQ share and K2
the dK, dV share of the block it holds, both from the merged ``lse`` and
``delta = rowsum(dO * O)``; the dK and dV sums (f32) travel with their
block, and one last hop brings each home.  The JAX package gets the same
math by differentiating its ``ppermute``s.

The transport is its own object: :class:`GroupRing` sends to the next
rank of a process group and receives from the previous one with
``batch_isend_irecv``; :class:`LocalRing` holds all ``p`` chunks in one
process and rotates them (the card's single-process phase and the CPU
tests).  On CUDA tensors each tick runs the kernels; on CPU tensors (or
``kernel="reference"``) their plain versions, through the same Function.
:func:`ring_attention_reference` is ``_ring_inner``'s online softmax in
plain torch ops over the same transport, differentiated by autograd.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from . import kernels
from .attention import (
    _flash_bwd_dkv_reference, _flash_bwd_dq_reference, _flash_fwd_reference,
    _use_kernel,
)

__all__ = ["ring_flash_attention", "ring_attention_reference", "GroupRing",
           "LocalRing", "sep_group", "sep_offset", "sep_token_mean"]


class LocalRing:
    """All ``p`` chunks in this process: chunk ``i`` is rank ``i``'s, and
    a hop moves chunk ``i`` to position ``i + 1``."""

    def __init__(self, p: int):
        if p < 1:
            raise ValueError(f"a ring needs p >= 1, got {p}")
        self.p = p
        self.ranks = list(range(p))

    def shift(self, parts: List[torch.Tensor], back: bool = False
              ) -> List[torch.Tensor]:
        """One hop of the per-rank ``parts`` (``back``: the other way)."""
        d = -1 if back else 1
        return [parts[(i - d) % self.p] for i in range(self.p)]


class GroupRing:
    """This rank's chunk of a ring over ``group`` (a collective ``Group``):
    a hop sends to the next rank of the group and receives from the
    previous one, in one ``batch_isend_irecv``."""

    def __init__(self, group):
        self.group = group
        self.p = group.nranks
        me = group.rank
        if me < 0:
            raise ValueError("GroupRing: this rank is not in the group")
        self.ranks = [me]
        self._next = group.ranks[(me + 1) % self.p]
        self._prev = group.ranks[(me - 1) % self.p]

    def shift(self, parts: List[torch.Tensor], back: bool = False
              ) -> List[torch.Tensor]:
        """One hop of this rank's one part (``back``: the other way)."""
        (t,) = parts
        t = t.contiguous()
        out = torch.empty_like(t)
        pg = self.group.process_group
        to, frm = (self._prev, self._next) if back else (self._next,
                                                           self._prev)
        ops = [dist.P2POp(dist.isend, t, to, pg),
               dist.P2POp(dist.irecv, out, frm, pg)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return [out]


def _hop(ring, *per_rank: List[torch.Tensor]) -> list:
    """One hop of several per-rank tensor lists, each packed by dtype so a
    hop is one message a dtype."""
    out = [list(x) for x in per_rank]
    by_dtype: dict = {}
    for a, lst in enumerate(per_rank):
        by_dtype.setdefault(lst[0].dtype, []).append(a)
    for dtype, idx in by_dtype.items():
        packed = [torch.cat([per_rank[a][r].reshape(-1) for a in idx])
                  for r in range(len(ring.ranks))]
        moved = ring.shift(packed)
        for r, flat in enumerate(moved):
            off = 0
            for a in idx:
                n = per_rank[a][r].numel()
                out[a][r] = flat[off:off + n].view_as(per_rank[a][r])
                off += n
    return out


def _visible(i: int, j: int, causal: bool) -> bool:
    return not causal or j <= i


def _tick_fwd(q, k, v, causal: bool, kernel: str):
    if _use_kernel(q, kernel):
        return kernels.flash_fwd(q, k, v, causal)
    return _flash_fwd_reference(q, k, v, causal)


def _merge(o_acc, lse_acc, o_t, lse_t):
    """Merge one tick's ``(o_t, lse_t)`` into the f32 accumulators."""
    B, s, H, _ = o_t.shape
    if o_acc is None:
        return o_t.float(), lse_t
    lse = torch.logaddexp(lse_acc, lse_t)
    w_old = torch.exp(lse_acc - lse).view(B, H, s).transpose(1, 2)
    w_new = torch.exp(lse_t - lse).view(B, H, s).transpose(1, 2)
    return (o_acc * w_old.unsqueeze(-1) + o_t.float() * w_new.unsqueeze(-1),
            lse)


class _RingAttention(torch.autograd.Function):
    """The ring's forward (K1 a tick) and backward (K2 + K3 a tick) over
    ``ring`` (see the module).  ``q``, ``k``, ``v``: the chunks this
    process holds, stacked on a leading dim of ``len(ring.ranks)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kernel: str, ring):
        n = len(ring.ranks)
        ks, vs = list(k.unbind(0)), list(v.unbind(0))
        o_acc: List[Optional[torch.Tensor]] = [None] * n
        lse_acc: List[Optional[torch.Tensor]] = [None] * n
        for r in range(ring.p):
            for a, i in enumerate(ring.ranks):
                j = (i - r) % ring.p
                if not _visible(i, j, causal):
                    continue
                o_t, lse_t = _tick_fwd(q[a], ks[a], vs[a], causal and r == 0,
                                       kernel)
                o_acc[a], lse_acc[a] = _merge(o_acc[a], lse_acc[a], o_t,
                                              lse_t)
            if r < ring.p - 1:
                ks, vs = _hop(ring, ks, vs)
        o = torch.stack([t.to(q.dtype) for t in o_acc])
        lse = torch.stack(lse_acc)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.kernel, ctx.ring = causal, kernel, ring
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, kernel, ring = ctx.causal, ctx.kernel, ctx.ring
        n = len(ring.ranks)
        _, B, s, H, D = q.shape
        do = do.contiguous()
        delta = [(do[a].float() * o[a].float()).sum(-1).transpose(1, 2)
                 .contiguous().view(B * H, s) for a in range(n)]
        ks, vs = list(k.unbind(0)), list(v.unbind(0))
        dks = [torch.zeros((B, s, H, D), dtype=torch.float32,
                           device=q.device) for _ in range(n)]
        dvs = [torch.zeros_like(t) for t in dks]
        dqs = [torch.zeros_like(t) for t in dks]
        for r in range(ring.p):
            for a, i in enumerate(ring.ranks):
                j = (i - r) % ring.p
                if not _visible(i, j, causal):
                    continue
                args = (q[a], ks[a], vs[a], do[a], lse[a], delta[a],
                        causal and r == 0)
                if _use_kernel(q, kernel):
                    dk_t, dv_t = kernels.flash_bwd_dkv(*args)
                    dq_t = kernels.flash_bwd_dq(*args)
                else:
                    dk_t, dv_t = _flash_bwd_dkv_reference(*args)
                    dq_t = _flash_bwd_dq_reference(*args)
                dqs[a] += dq_t.float()
                dks[a] += dk_t.float()
                dvs[a] += dv_t.float()
            if r < ring.p - 1:
                ks, vs, dks, dvs = _hop(ring, ks, vs, dks, dvs)
        if ring.p > 1:
            # the last hop brings each block's dK, dV sums home
            dks, dvs = _hop(ring, dks, dvs)
        cast = lambda ts, like: torch.stack(ts).to(like.dtype)  # noqa: E731
        return cast(dqs, q), cast(dks, k), cast(dvs, v), None, None, None


def _chunks(t: torch.Tensor, p: int) -> torch.Tensor:
    B, S = t.shape[:2]
    if S % p:
        raise ValueError(f"ring attention: sequence {S} does not split "
                         f"into {p} chunks")
    return t.view(B, p, S // p, *t.shape[2:]).transpose(0, 1)


def _unchunk(t: torch.Tensor) -> torch.Tensor:
    p, B, s = t.shape[:3]
    return t.transpose(0, 1).reshape(B, p * s, *t.shape[3:])


def _stack_for(ring, query, key, value):
    if isinstance(ring, LocalRing):
        return tuple(_chunks(t, ring.p) for t in (query, key, value))
    return tuple(t.unsqueeze(0) for t in (query, key, value))


def ring_flash_attention(query: torch.Tensor, key: torch.Tensor,
                         value: torch.Tensor, is_causal: bool = True,
                         group=None, chunks: Optional[int] = None,
                         kernel: str = "cuda") -> torch.Tensor:
    """Attention over a sequence cut into ``p`` chunks (see the module).

    With ``group`` (a collective ``Group``; default the sep group of
    ``fleet``'s topology) ``query``/``key``/``value`` are this rank's
    chunk ``[B, s, H, D]`` and so is the result.  With ``chunks=p`` the
    whole ``[B, S, H, D]`` is in this process and is cut into ``p``
    chunks ringed here (:class:`LocalRing`); the result is whole."""
    ring = _ring(group, chunks)
    q, k, v = _stack_for(ring, query, key, value)
    o = _RingAttention.apply(q, k, v, is_causal, kernel, ring)
    return _unchunk(o) if isinstance(ring, LocalRing) else o[0]


def _ring(group, chunks):
    if chunks is not None:
        return LocalRing(int(chunks))
    g = group if group is not None else sep_group()
    if g is None:
        raise ValueError("ring attention needs a sep group of more than "
                         "one rank, or chunks=p")
    return GroupRing(g)


class _Hop(torch.autograd.Function):
    """One differentiable hop of the per-rank ``parts``: the gradient goes
    back the other way."""

    @staticmethod
    def forward(ctx, ring, *parts):
        ctx.ring = ring
        return tuple(ring.shift(list(parts)))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.ring.shift(list(grads), back=True))


def ring_attention_reference(query: torch.Tensor, key: torch.Tensor,
                             value: torch.Tensor, is_causal: bool = True,
                             group=None, chunks: Optional[int] = None
                             ) -> torch.Tensor:
    """The plain ring: ``_ring_inner``'s online softmax ``(m, l, o)`` in
    f32 over the same ticks and transport (a masked block's ``-1e30``
    scores underflow to zero probability after the diagonal), its
    gradients by autograd; arguments as :func:`ring_flash_attention`."""
    ring = _ring(group, chunks)
    q, k, v = _stack_for(ring, query, key, value)
    n, B, s, H, D = q.shape
    scale = 1.0 / D ** 0.5
    ar = torch.arange(s, device=q.device)
    outs = []
    ks, vs = list(k.unbind(0)), list(v.unbind(0))
    state = [(torch.zeros((B, H, s, D), device=q.device),
              torch.full((B, H, s), float("-inf"), device=q.device),
              torch.zeros((B, H, s), device=q.device)) for _ in range(n)]
    for r in range(ring.p):
        for a, i in enumerate(ring.ranks):
            o, m, l = state[a]
            j = (i - r) % ring.p
            scores = torch.einsum("bqhd,bkhd->bhqk", q[a].float(),
                                  ks[a].float()) * scale
            if is_causal:
                mask = (i * s + ar)[:, None] >= (j * s + ar)[None, :]
                scores = torch.where(mask, scores,
                                     torch.full_like(scores, -1e30))
            m_new = torch.maximum(m, scores.amax(-1))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(scores - m_new[..., None])
            state[a] = (o * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", pexp, vs[a].float()),
                m_new, l * alpha + pexp.sum(-1))
        if r < ring.p - 1:
            ks = list(_Hop.apply(ring, *ks))
            vs = list(_Hop.apply(ring, *vs))
    for o, m, l in state:
        out = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(query.dtype))
    o = torch.stack(outs)
    return _unchunk(o) if isinstance(ring, LocalRing) else o[0]


def sep_group():
    """The sep group of ``fleet``'s topology when its degree is above 1,
    else None."""
    from ..distributed.fleet.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_sep_parallel_world_size() <= 1:
        return None
    return hcg.get_sep_parallel_group()


def sep_offset(s: int) -> int:
    """The global position of this rank's first token when its chunk has
    ``s`` tokens: ``sep rank * s`` (0 without a sep degree)."""
    g = sep_group()
    return 0 if g is None else g.rank * s


def sep_token_mean(mean: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """A loss that is this rank's mean over its ``count`` tokens made the
    token-weighted mean over the sep group (its value, on every rank),
    whose gradient, once averaged over the sep ranks as the optimizer
    averages it, is that of the whole sequence's mean.  ``mean`` itself
    without a sep degree."""
    g = sep_group()
    if g is None:
        return mean
    from ..distributed import collective

    p = g.nranks
    n = count.detach().float().reshape(())
    total = n.clone()
    collective.all_reduce(total, group=g)
    local = mean * (n.clamp(min=1.0) * p / total.clamp(min=1.0))
    value = local.detach().clone()
    collective.all_reduce(value, group=g)
    return local + (value / p - local.detach())
