"""Paged KV cache: a block pool behind the CacheContext surface.

Port of ``paddle_tpu/serving/paging.py``.  K/V live in a pool of
``[num_blocks, layers, block_size, kv_heads, head_dim]`` blocks addressed
through per-slot int32 block tables ``[slots, max_blocks_per_slot]`` on
the device; the host keeps the allocator and each slot's block list.
The pool, the tables and the lengths are updated in place.

Write discipline: prefill writes whole tail-bucket blocks starting at the
block boundary ``start // block_size``; decode writes each slot's token at
``lengths[slot]`` through its table; attention reads positions
``<= lengths[slot]``.  Block 0 is a reserved scratch block: idle slots'
rows point at it with length 0, so the all-slots decode write never lands
on live storage and the decode kernel reads only scratch for them.  A
speculative verify writes a window of W tokens at ``lengths[slot]..``
through the table (a position at or past ``max_seq`` goes to scratch),
and after the round the host drops the blocks past the accepted length
(:meth:`PagedKVCache.truncate_blocks`).

Attention runs through the CUDA kernels K4 (decode, and a verify window
as ``slots·W`` decode rows) and K5 (tail prefill) with ``kernel="cuda"``
(they read the pool through the table; for CPU tensors the same call runs
the plain gather + attention), or through the plain gather + attention
with ``kernel="reference"``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch

from ..ops.cached_attention import (
    block_prefill_attention, cached_attention, gather_block_kv,
    paged_decode_attention, paged_prefill_attention, paged_verify_attention,
    verify_attention,
)
from .kv_cache import CacheContext, check_scalar

__all__ = ["BlockAllocator", "PagedKVCache", "PagedCacheContext",
           "AllocatorError", "SCRATCH_BLOCK"]

#: Block id every idle/retired slot's table points at.  Never allocated.
SCRATCH_BLOCK = 0


class AllocatorError(RuntimeError):
    """A block-accounting invariant was about to be violated (double free,
    unref of a free block, ...)."""


class BlockAllocator:
    """Host-side accounting for the fixed KV block pool.

    Blocks are **free** (refcount 0, on the free list), **used** (held by
    at least one live slot) or **cached** (idle but retained by the prefix
    cache, which holds their single ref); ``free + used + cached == total
    - reserved`` at every step (:meth:`check`).  When the free list runs
    dry, :meth:`alloc` asks ``evict_cb`` (the prefix cache) to release idle
    cached blocks, LRU first."""

    def __init__(self, num_blocks: int, reserved: int = 1):
        if num_blocks < reserved + 1:
            raise ValueError(f"num_blocks must be > reserved={reserved}, "
                             f"got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.reserved = int(reserved)
        self._free: deque = deque(range(self.reserved, self.num_blocks))
        self._ref = [0] * self.num_blocks
        self._cached = set()
        self.evict_cb: Optional[Callable[[int], int]] = None
        self.allocs = 0
        self.frees = 0
        self.alloc_failures = 0

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks (refcount 1 each), evicting idle cached blocks
        under pressure; None (all or nothing) if the pool cannot supply
        them."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if len(self._free) < n and self.evict_cb is not None:
            self.evict_cb(n - len(self._free))
        if len(self._free) < n:
            self.alloc_failures += 1
            return None
        out = []
        for _ in range(n):
            b = self._free.popleft()
            self._ref[b] = 1
            out.append(b)
        self.allocs += n
        return out

    def ref(self, block_id: int) -> int:
        b = self._check_id(block_id)
        if self._ref[b] < 1:
            raise AllocatorError(f"ref of free block {b}")
        self._ref[b] += 1
        return self._ref[b]

    def unref(self, block_id: int) -> int:
        b = self._check_id(block_id)
        if self._ref[b] < 1:
            raise AllocatorError(f"double free of block {b}")
        self._ref[b] -= 1
        if self._ref[b] == 0:
            if b in self._cached:
                raise AllocatorError(
                    f"cached block {b} dropped to refcount 0: the prefix "
                    "cache must hold one ref per cached block")
            self._free.append(b)
            self.frees += 1
        return self._ref[b]

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block_id: int) -> int:
        return self._ref[self._check_id(block_id)]

    def _check_id(self, block_id: int) -> int:
        b = int(block_id)
        if not (self.reserved <= b < self.num_blocks):
            raise AllocatorError(f"block id {b} out of pool range "
                                 f"[{self.reserved}, {self.num_blocks})")
        return b

    def mark_cached(self, block_id: int) -> None:
        self._cached.add(self._check_id(block_id))

    def unmark_cached(self, block_id: int) -> None:
        self._cached.discard(self._check_id(block_id))

    def stats(self) -> dict:
        cached_idle = sum(1 for b in self._cached if self._ref[b] == 1)
        used = sum(1 for b in range(self.reserved, self.num_blocks)
                   if self._ref[b] > 0) - cached_idle
        return {"total": self.num_blocks, "reserved": self.reserved,
                "free": len(self._free), "used": used, "cached": cached_idle,
                "allocs": self.allocs, "frees": self.frees,
                "alloc_failures": self.alloc_failures}

    def check(self) -> List[str]:
        """Invariant audit; a non-empty return means the pool is corrupt."""
        out = []
        neg = [b for b, r in enumerate(self._ref) if r < 0]
        if neg:
            out.append(f"negative refcounts on blocks {neg}")
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            out.append("duplicate entries on the free list")
        both = [b for b in free_set if self._ref[b] != 0]
        if both:
            out.append(f"blocks {both} free-listed with nonzero refcount")
        s = self.stats()
        if s["free"] + s["used"] + s["cached"] != s["total"] - s["reserved"]:
            out.append(
                f"accounting leak: free({s['free']}) + used({s['used']}) "
                f"+ cached({s['cached']}) != total({s['total']}) - "
                f"reserved({s['reserved']})")
        uncached_idle = [b for b in self._cached if self._ref[b] == 0]
        if uncached_idle:
            out.append(f"cached blocks {uncached_idle} with refcount 0")
        return out


class PagedKVCache:
    """Block-pool KV storage exposing the :class:`KVCache` duck surface.

    Device state, updated in place: the K/V pools, the block tables and
    the lengths.  Host state: the :class:`BlockAllocator` and each slot's
    owned-block list."""

    def __init__(self, num_slots: int, num_layers: int, max_seq: int,
                 num_kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, *, block_size: int = 16,
                 num_blocks: Optional[int] = None, kernel: str = "cuda",
                 device="cuda"):
        if num_slots < 1 or num_layers < 1 or max_seq < 1:
            raise ValueError("num_slots/num_layers/max_seq must be >= 1")
        if kernel not in ("cuda", "reference"):
            raise ValueError(f"kernel must be 'cuda' or 'reference', got "
                             f"{kernel!r}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if max_seq % block_size != 0:
            raise ValueError(f"max_seq={max_seq} must be a multiple of "
                             f"block_size={block_size}")
        self.num_slots = int(num_slots)
        self.num_layers = int(num_layers)
        self.max_seq = int(max_seq)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.max_blocks_per_slot = self.max_seq // self.block_size
        if num_blocks is None:
            num_blocks = self.num_slots * self.max_blocks_per_slot + 1
        self.num_blocks = int(num_blocks)
        self.kernel = kernel
        self.dtype = dtype
        self.device = torch.device(device)
        self.allocator = BlockAllocator(self.num_blocks, reserved=1)
        shape = (self.num_blocks, self.num_layers, self.block_size,
                 self.num_kv_heads, self.head_dim)
        # zeros, not empty: the plain path multiplies masked positions by
        # probability 0, and 0 * (NaN bit pattern) would poison the sum
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.block_tables = torch.full(
            (self.num_slots, self.max_blocks_per_slot), SCRATCH_BLOCK,
            dtype=torch.int32, device=self.device)
        self.lengths = torch.zeros((self.num_slots,), dtype=torch.int32,
                                   device=self.device)
        self._slot_blocks: List[List[int]] = [[] for _ in range(num_slots)]
        self.copy_on_extends = 0

    # -- host-side slot lifecycle -------------------------------------------

    def begin_sequence(self, slot: int, shared_blocks: Sequence[int],
                       prefix_len: int, tail_bucket: int) -> bool:
        """Assign storage for one admission: ref the shared prefix blocks
        and allocate fresh blocks for the whole tail bucket.  All or
        nothing: False (slot untouched) when the pool cannot supply the
        tail."""
        if self._slot_blocks[slot]:
            raise AllocatorError(f"slot {slot} already owns blocks "
                                 f"{self._slot_blocks[slot]}")
        bs = self.block_size
        if prefix_len != len(shared_blocks) * bs:
            raise ValueError(f"prefix_len {prefix_len} != "
                             f"{len(shared_blocks)} shared blocks * {bs}")
        if tail_bucket % bs != 0:
            raise ValueError(f"tail bucket {tail_bucket} not a multiple of "
                             f"block_size {bs}")
        n_tail = tail_bucket // bs
        if len(shared_blocks) + n_tail > self.max_blocks_per_slot:
            raise ValueError(
                f"prefix {len(shared_blocks)} + tail {n_tail} blocks exceed "
                f"max_blocks_per_slot {self.max_blocks_per_slot}")
        # pin the hit blocks before allocating: alloc() may evict idle
        # cached blocks, and an un-ref'd hit block is exactly that
        owned = []
        for b in shared_blocks:
            self.allocator.ref(int(b))
            owned.append(int(b))
        fresh = self.allocator.alloc(n_tail)
        if fresh is None:
            for b in owned:
                self.allocator.unref(b)
            return False
        owned.extend(fresh)
        row = [SCRATCH_BLOCK] * self.max_blocks_per_slot
        row[:len(owned)] = owned
        self.block_tables[slot].copy_(torch.tensor(row, dtype=torch.int32))
        self._slot_blocks[slot] = owned
        return True

    def release_slot(self, slot: int) -> None:
        """Drop the slot's refs, point its row back at scratch and zero
        its length.  Idempotent."""
        owned, self._slot_blocks[slot] = self._slot_blocks[slot], []
        for b in owned:
            self.allocator.unref(b)
        if owned:
            self.block_tables[slot].fill_(SCRATCH_BLOCK)
        self.lengths[slot] = 0

    def ensure_capacity(self, slot: int, next_pos: int) -> bool:
        """Make position ``next_pos`` writable before a decode step: take a
        fresh block when the sequence grows into one it does not own, and
        copy on extend when the covering block is shared.  False when the
        pool is exhausted."""
        bidx = next_pos // self.block_size
        if bidx >= self.max_blocks_per_slot:
            return False
        owned = self._slot_blocks[slot]
        if bidx >= len(owned):
            if bidx != len(owned):
                raise AllocatorError(f"slot {slot} skipping block index "
                                     f"{len(owned)} to {bidx}")
            fresh = self.allocator.alloc(1)
            if fresh is None:
                return False
            owned.append(fresh[0])
            self.block_tables[slot, bidx] = fresh[0]
            return True
        block_id = owned[bidx]
        if self.allocator.refcount(block_id) > 1:
            fresh = self.allocator.alloc(1)
            if fresh is None:
                return False
            self.k[fresh[0]] = self.k[block_id]
            self.v[fresh[0]] = self.v[block_id]
            owned[bidx] = fresh[0]
            self.block_tables[slot, bidx] = fresh[0]
            self.allocator.unref(block_id)
            self.copy_on_extends += 1
        return True

    def truncate_blocks(self, slot: int, n_tokens: int) -> int:
        """Speculative rollback: drop the slot's blocks past those that
        cover positions ``0..n_tokens-1`` (a rejected window's tail), with
        no copy: refcounts and the table row's tail, written in place.
        The engine passes the accepted length, which covers the whole
        prompt, so a block the prefix cache registered is never among
        those dropped.  Returns how many blocks were released."""
        owned = self._slot_blocks[slot]
        keep = -(-int(n_tokens) // self.block_size)
        if len(owned) <= keep:
            return 0
        drop = owned[keep:]
        del owned[keep:]
        self.block_tables[slot, keep:].fill_(SCRATCH_BLOCK)
        for b in drop:
            self.allocator.unref(b)
        return len(drop)

    def reset(self) -> None:
        """Release every slot (cached prefix blocks stay with their
        owner)."""
        for slot in range(self.num_slots):
            self.release_slot(slot)

    # -- state ops of the CacheContext surface ------------------------------

    def table_row(self, slot: torch.Tensor) -> torch.Tensor:
        """The slot's block-table row ``[max_blocks]`` int32 (a copy),
        picked on the device."""
        return self.block_tables.index_select(0, slot.long())[0]

    def prefill_write(self, layer_idx: int, slot: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor,
                      start: torch.Tensor) -> None:
        """Write a tail bucket's K/V ``[1, S, Hkv, D]`` (S a multiple of
        block_size) through the slot's table row, starting at the block
        boundary ``start``.  The block ids stay on the device."""
        bs = self.block_size
        n = k.shape[1] // bs
        first = start.long() // bs
        ids = self.table_row(slot).gather(
            0, first + torch.arange(n, device=self.device)).long()
        shape = (n, bs, self.num_kv_heads, self.head_dim)
        self.k[:, layer_idx].index_copy_(0, ids,
                                         k[0].reshape(shape).to(self.dtype))
        self.v[:, layer_idx].index_copy_(0, ids,
                                         v[0].reshape(shape).to(self.dtype))

    def set_length(self, slot: torch.Tensor, length: torch.Tensor) -> None:
        self.lengths.index_copy_(0, check_scalar("slot", slot).long(),
                                 check_scalar("length", length))

    def _decode_token_write(self, layer_idx: int, k: torch.Tensor,
                            v: torch.Tensor):
        """Write one token per slot at ``lengths[slot]`` through the table,
        in place.  Returns the layer's pool views, the tables and the
        lengths."""
        bs = self.block_size
        lens = self.lengths.long()
        bidx = (lens // bs).clamp(0, self.max_blocks_per_slot - 1)
        block_ids = self.block_tables.gather(1, bidx[:, None])[:, 0].long()
        off = lens % bs
        k_layer, v_layer = self.k[:, layer_idx], self.v[:, layer_idx]
        k_layer[block_ids, off] = k[:, 0].to(self.dtype)
        v_layer[block_ids, off] = v[:, 0].to(self.dtype)
        return k_layer, v_layer, self.block_tables, self.lengths

    def decode_write(self, layer_idx: int, k: torch.Tensor,
                     v: torch.Tensor):
        """Reference decode read: token write, then each slot's sequence
        gathered contiguous ``[slots, max_blocks * bs, Hkv, D]``."""
        k_layer, v_layer, tbl, lens = self._decode_token_write(layer_idx, k,
                                                               v)
        return (gather_block_kv(k_layer, tbl), gather_block_kv(v_layer, tbl),
                lens)

    def decode_attention(self, layer_idx: int, q: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """One decode step of attention for this layer: write the token,
        then attend (kernel K4, or the gather + plain attention)."""
        if self.kernel == "cuda":
            k_layer, v_layer, tbl, lens = self._decode_token_write(
                layer_idx, k, v)
            return paged_decode_attention(q, k_layer, v_layer, tbl, lens)
        k_full, v_full, lens = self.decode_write(layer_idx, k, v)
        return cached_attention(q, k_full, v_full, lens)

    def _verify_token_write(self, layer_idx: int, k: torch.Tensor,
                            v: torch.Tensor):
        """Write a window of W tokens per slot (``[slots, W, Hkv, D]``) at
        ``lengths[slot] + i`` through the table, in place; a position at or
        past ``max_seq`` goes to the scratch block.  The engine made every
        running slot own the blocks of its window's positions below
        ``max_seq`` (``ensure_capacity``, copy on extend included).
        Returns the layer's pool views, the tables and the lengths."""
        bs = self.block_size
        W = k.shape[1]
        pos = self.lengths.long()[:, None] + torch.arange(
            W, device=self.device)[None, :]
        bidx = (pos // bs).clamp(0, self.max_blocks_per_slot - 1)
        block_ids = self.block_tables.gather(1, bidx).long()
        block_ids = torch.where(pos < self.max_seq, block_ids,
                                torch.full_like(block_ids, SCRATCH_BLOCK))
        off = pos % bs
        k_layer, v_layer = self.k[:, layer_idx], self.v[:, layer_idx]
        k_layer[block_ids, off] = k.to(self.dtype)
        v_layer[block_ids, off] = v.to(self.dtype)
        return k_layer, v_layer, self.block_tables, self.lengths

    def verify_attention(self, layer_idx: int, q: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """One verify window of attention for this layer: write the window,
        then attend (K4 over ``slots·W`` rows, or the gather + plain
        :func:`verify_attention`)."""
        k_layer, v_layer, tbl, lens = self._verify_token_write(layer_idx,
                                                               k, v)
        if self.kernel == "cuda":
            return paged_verify_attention(q, k_layer, v_layer, tbl, lens)
        return verify_attention(q, gather_block_kv(k_layer, tbl),
                                gather_block_kv(v_layer, tbl), lens)

    def advance(self, active: torch.Tensor) -> None:
        self.lengths += active

    # -- host-side management -----------------------------------------------

    def owned_blocks(self, slot: int) -> List[int]:
        return self._slot_blocks[slot]

    def nbytes(self) -> int:
        return self.k.numel() * self.k.element_size() * 2

    def check_invariants(self) -> List[str]:
        """Allocator audit plus the slot-level cross-checks."""
        out = self.allocator.check()
        seen = {}
        for slot, owned in enumerate(self._slot_blocks):
            for b in owned:
                seen.setdefault(b, []).append(slot)
                if self.allocator.refcount(b) < 1:
                    out.append(f"slot {slot} holds freed block {b}")
        for b, slots in seen.items():
            if len(slots) > self.allocator.refcount(b):
                out.append(f"block {b} held by slots {slots} with only "
                           f"{self.allocator.refcount(b)} refs")
        return out


@dataclass
class PagedCacheContext(CacheContext):
    """CacheContext over a :class:`PagedKVCache`, plus the tail prefill:
    ``start`` is the absolute position of the bucket's first token (the
    cached prefix length, a block boundary).  In prefill, ``slot`` and
    ``start`` are int32 tensors of one element on the cache's device, so
    that the engine's captured prefill reads them as data."""

    start: Optional[torch.Tensor] = None

    def __post_init__(self):
        super().__post_init__()
        if self.mode == "prefill":
            self.start = check_scalar("start", self.start)

    def write_prefill(self, k: torch.Tensor, v: torch.Tensor) -> None:
        self.cache.prefill_write(self.layer_idx, self.slot, k, v, self.start)

    def prefill_positions(self, seq_len: int) -> torch.Tensor:
        """Absolute positions of the tail's tokens ``[1, S]``."""
        return (self.start.long() + torch.arange(
            seq_len, device=self.cache.device))[None]

    def prefill_attention(self, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
        """Tail queries over the slot's whole block row (cached prefix +
        fresh tail) under one absolute-position causal mask: kernel K5, or
        the gather + plain attention."""
        cache, layer = self.cache, self.layer_idx
        row = cache.table_row(self.slot)
        if cache.kernel == "cuda":
            return paged_prefill_attention(q, cache.k[:, layer],
                                           cache.v[:, layer], row,
                                           self.start)
        return block_prefill_attention(
            q, gather_block_kv(cache.k[:, layer], row[None]),
            gather_block_kv(cache.v[:, layer], row[None]), self.start)
