"""Attention against the serving KV caches: plain versions and the paged
kernel dispatch.

Port of ``paddle_tpu/ops/cached_attention.py``.  The plain PyTorch
versions (:func:`cached_attention`, :func:`verify_attention`,
:func:`gather_block_kv`, :func:`block_prefill_attention`) are the
``kernel="reference"`` path and the oracle the CUDA kernels are held
against.  They upcast to f32 before
the products, as the kernels do (the jnp oracles of the JAX package round
the logits in the input dtype first; in f32 the two agree).  For bf16 and
f16 inputs :func:`block_prefill_attention` also rounds the unnormalised
probabilities to the input dtype before P V, as K5's tensor-core loop
does (the Pallas ``_prefill_kernel`` keeps them in f32); the decode
versions keep them in f32, as K4 does.  All three dtypes, f32, bf16 and
f16, take the kernels on the card.

:func:`paged_decode_attention` (K4) and :func:`paged_prefill_attention`
(K5) consume the block table inside a hand-written CUDA kernel
(``csrc/paged_attention.cu``) when their tensors lie on a CUDA device; for
CPU tensors they run the plain gather + attention.
:func:`paged_verify_attention` runs a speculative window as rows of K4.  There is no fallback
from the device: a CUDA tensor the kernel does not take raises.

GQA everywhere: kv head ``h // (H // Hkv)`` serves query head ``h`` (a
consecutive repeat, ``torch.repeat_interleave``).
"""
from __future__ import annotations

import torch

from . import kernels

__all__ = ["cached_attention", "verify_attention", "gather_block_kv",
           "block_prefill_attention", "paged_decode_attention",
           "paged_verify_attention", "paged_prefill_attention", "NEG_INF"]

NEG_INF = -1e30


def _expand_gqa(k: torch.Tensor, v: torch.Tensor, n_heads: int):
    hkv = k.shape[2]
    if hkv == n_heads:
        return k, v
    rep = n_heads // hkv
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def _masked_attention(q, k, v, valid, round_p: bool = False):
    """softmax(mask(q k^T / sqrt(D))) v in f32; ``valid`` broadcasts
    against the ``[B, H, Sq, T]`` logits.  Output in q's dtype.
    ``round_p``: the unnormalised ``p = exp(s - max)`` is rounded to v's
    dtype before P V (the product summed in f32) and divided by the f32
    sum of the unrounded p, as the 16-bit tensor-core loop computes."""
    D = q.shape[-1]
    k, v = _expand_gqa(k, v, q.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / D ** 0.5)
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    if not round_p or v.dtype == torch.float32:
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (pv / p.sum(dim=-1, keepdim=True).transpose(1, 2)).to(q.dtype)


def cached_attention(query: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """One decode step of attention for a batch of cache slots.

    ``query`` ``[B, 1, H, D]``; ``k_cache``/``v_cache`` ``[B, T, Hkv, D]``
    with positions ``0..lengths[b]`` valid (the current token written
    first); ``lengths`` ``[B]`` int.  Returns ``[B, 1, H, D]``."""
    T = k_cache.shape[1]
    pos = torch.arange(T, device=query.device)
    valid = pos[None, :] <= lengths.long()[:, None]
    return _masked_attention(query, k_cache, v_cache,
                             valid[:, None, None, :])


def verify_attention(query: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """A speculative verify window of attention for a batch of cache
    slots: :func:`cached_attention` with W queries per slot.

    ``query`` ``[B, W, H, D]``, the window's queries at absolute positions
    ``lengths[b] .. lengths[b] + W - 1``; ``k_cache``/``v_cache``
    ``[B, T, Hkv, D]`` with the window already written; ``lengths`` ``[B]``
    int, the window's first position.  Query ``i`` sees keys ``kpos <=
    lengths[b] + i``.  Returns ``[B, W, H, D]``; at W = 1 it is
    :func:`cached_attention`."""
    W, T = query.shape[1], k_cache.shape[1]
    qpos = lengths.long()[:, None] + torch.arange(
        W, device=query.device)[None, :]
    kpos = torch.arange(T, device=query.device)
    valid = kpos[None, None, :] <= qpos[:, :, None]          # [B, W, T]
    return _masked_attention(query, k_cache, v_cache, valid[:, None])


def gather_block_kv(pool_layer: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """One layer of the paged pool gathered back into contiguous per-slot
    sequences: ``[num_blocks, bs, Hkv, D]`` by ``[B, max_blocks]`` →
    ``[B, max_blocks * bs, Hkv, D]`` (garbage past each slot's length,
    which the attention mask never reads)."""
    B, MB = block_tables.shape
    g = pool_layer.index_select(0, block_tables.reshape(-1).long())
    return g.reshape(B, MB * pool_layer.shape[1], *pool_layer.shape[2:])


def block_prefill_attention(query: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor,
                            start: torch.Tensor) -> torch.Tensor:
    """Tail-bucket prefill attention against a gathered cache: the ``S``
    queries sit at absolute positions ``start..start+S-1`` and see keys
    ``kpos <= qpos`` (the cached prefix and the causal tail in one mask).
    ``query`` ``[1, S, H, D]``, caches ``[1, T, Hkv, D]``; ``start`` an
    integer tensor of one element, read on the device as K5 reads it (a
    negative start counts as 0, in both).  bf16 and f16 round p before
    P V, as K5 does (:func:`_masked_attention`)."""
    S, T = query.shape[1], k_cache.shape[1]
    start = start.reshape(()).long().clamp_min(0)
    qpos = start + torch.arange(S, device=query.device)
    kpos = torch.arange(T, device=query.device)
    valid = kpos[None, :] <= qpos[:, None]
    return _masked_attention(query, k_cache, v_cache, valid[None, None],
                             round_p=True)


def paged_decode_attention(query: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention straight off the block pool: kernel K4 for CUDA
    tensors, ``gather_block_kv`` + :func:`cached_attention` for CPU ones.
    Shapes as :func:`kernels.paged_decode`."""
    if query.is_cuda:
        return kernels.paged_decode(query, k_pool, v_pool, block_tables,
                                    lengths)
    return cached_attention(query, gather_block_kv(k_pool, block_tables),
                            gather_block_kv(v_pool, block_tables), lengths)


def paged_verify_attention(query: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """A speculative verify window straight off the block pool, as decode
    rows of K4: ``query`` ``[B, W, H, D]`` becomes ``B·W`` rows of one
    query, row ``(b, i)`` taking slot ``b``'s table row and the window
    ``0 .. lengths[b] + i`` (clamped to the table's last position: such a
    row's query sits past ``max_seq``, where the round emits nothing).
    Each window query is one decode query, so this is
    :func:`verify_attention` over the gathered pool; CPU tensors run K4's
    plain version.  Returns ``[B, W, H, D]``."""
    B, W, H, D = query.shape
    T = block_tables.shape[1] * k_pool.shape[1]
    rows = block_tables.repeat_interleave(W, dim=0)
    lens = (lengths.long()[:, None] + torch.arange(
        W, device=lengths.device)[None, :]).clamp_max(T - 1)
    out = paged_decode_attention(query.reshape(B * W, 1, H, D), k_pool,
                                 v_pool, rows,
                                 lens.reshape(-1).to(torch.int32))
    return out.reshape(B, W, H, D)


def paged_prefill_attention(query: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_row: torch.Tensor,
                            start: torch.Tensor) -> torch.Tensor:
    """Fused cached-prefix + causal-tail prefill off the block pool: kernel
    K5 for CUDA tensors, ``gather_block_kv`` +
    :func:`block_prefill_attention` for CPU ones.  Arguments as
    :func:`kernels.paged_prefill` (``start`` an int32 tensor of one
    element beside the query)."""
    if query.is_cuda:
        return kernels.paged_prefill(query, k_pool, v_pool, block_row, start)
    row = block_row[None, :]
    return block_prefill_attention(query, gather_block_kv(k_pool, row),
                                   gather_block_kv(v_pool, row), start)
