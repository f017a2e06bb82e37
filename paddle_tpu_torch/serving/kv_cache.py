"""Contiguous per-slot KV cache and the routing handle models duck-type.

Port of ``paddle_tpu/serving/kv_cache.py``.  One preallocated tensor per K
and V of shape ``[slots, layers, max_seq, kv_heads, head_dim]`` plus a
``[slots]`` int32 length vector, all on the engine's device.  Where the
JAX cache rebound immutable arrays, this one is updated in place.

Write discipline (why stale bytes are never read): prefill writes
positions ``0..bucket-1`` of a slot and sets ``lengths[slot]``; decode
writes each slot's token at ``lengths[slot]`` and then advances the
lengths by the active mask; a speculative verify writes a window of W
tokens at ``lengths[slot]..`` and advances by the accepted count;
attention reads positions ``<= lengths[slot]`` (in a window, ``<=`` each
query's own position) only.  Every readable position was written by the
current request, so a reused slot needs no zeroing.

Positions past the end.  A speculating slot's window (and its draft's
decode steps) reach up to ``k`` positions past ``max_seq - 1``; JAX drops
such a write and clamps such a read, where CUDA asserts.  A cache made
with ``headroom=k`` holds ``k`` more positions that take those writes;
attention reads the first ``max_seq`` positions only, and the position
ids of a window (and of any step on a cache with headroom) are clamped to
``max_seq - 1``, inside every rope and position table.  Whatever a query
at or past ``max_seq`` computes is junk the round's cap never emits.

The prefill surface takes its slot, length and start as int32 tensors of
one element on the cache's device (:func:`check_scalar`), and writes
through ``index_copy_``: a prefill captured once per bucket into a CUDA
graph then serves every slot and prompt length.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.attention import flash_attention
from ..ops.cached_attention import cached_attention, verify_attention

__all__ = ["KVCache", "CacheContext", "check_scalar"]


def check_scalar(name: str, x) -> torch.Tensor:
    """``x`` as ``[1]``; it must be an int32 tensor of one element (a
    slot, length or start of the prefill surface).  The message names the
    type, never the value: formatting a device value reads it back, which
    a graph capture forbids."""
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.int32
            and x.numel() == 1):
        got = (f"{x.dtype} {tuple(x.shape)}" if isinstance(x, torch.Tensor)
               else type(x).__name__)
        raise TypeError(f"{name} must be an int32 tensor of one element on "
                        f"the cache's device, got {got}")
    return x.reshape(1)


class KVCache:
    """Preallocated per-slot KV storage shared by all layers of one model.

    ``dtype`` is the cache dtype and ``device`` where it lives (given
    explicitly; the engine passes its model's).  ``headroom`` positions
    past ``max_seq`` take a speculative window's writes past the end."""

    def __init__(self, num_slots: int, num_layers: int, max_seq: int,
                 num_kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, *, device="cuda",
                 headroom: int = 0):
        if num_slots < 1 or num_layers < 1 or max_seq < 1:
            raise ValueError("num_slots/num_layers/max_seq must be >= 1")
        if headroom < 0:
            raise ValueError(f"headroom must be >= 0, got {headroom}")
        self.num_slots = int(num_slots)
        self.num_layers = int(num_layers)
        self.max_seq = int(max_seq)
        self.headroom = int(headroom)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.device = torch.device(device)
        shape = (self.num_slots, self.num_layers,
                 self.max_seq + self.headroom, self.num_kv_heads,
                 self.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.lengths = torch.zeros((self.num_slots,), dtype=torch.int32,
                                   device=self.device)

    def prefill_write(self, layer_idx: int, slot: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor) -> None:
        """Write a prompt bucket's K/V ``[1, S, Hkv, D]`` into ``slot`` at
        positions ``0..S-1``, in place."""
        S, idx = k.shape[1], slot.long()
        self.k[:, layer_idx, :S].index_copy_(0, idx, k.to(self.dtype))
        self.v[:, layer_idx, :S].index_copy_(0, idx, v.to(self.dtype))

    def set_length(self, slot: torch.Tensor, length: torch.Tensor) -> None:
        """Record a freshly prefilled slot's length (in place)."""
        self.lengths.index_copy_(0, check_scalar("slot", slot).long(),
                                 check_scalar("length", length))

    def decode_write(self, layer_idx: int, k: torch.Tensor,
                     v: torch.Tensor):
        """Write one token per slot (``[slots, 1, Hkv, D]``) at that slot's
        length, in place.  Returns the layer's caches
        ``[slots, max_seq, Hkv, D]`` (views) and the pre-advance lengths —
        what :func:`ops.cached_attention` takes."""
        rows = torch.arange(self.num_slots, device=self.device)
        pos = self.lengths.long()
        k_layer, v_layer = self.k[:, layer_idx], self.v[:, layer_idx]
        k_layer[rows, pos] = k[:, 0].to(self.dtype)
        v_layer[rows, pos] = v[:, 0].to(self.dtype)
        T = self.max_seq
        return k_layer[:, :T], v_layer[:, :T], self.lengths

    def verify_write(self, layer_idx: int, k: torch.Tensor,
                     v: torch.Tensor):
        """Write a speculative window, W tokens per slot (``[slots, W,
        Hkv, D]``), at positions ``lengths[slot] .. lengths[slot] + W - 1``,
        in place; a position past the headroom (never one a round can
        emit) is clamped onto the last one.  Returns the layer's caches
        ``[slots, max_seq, Hkv, D]`` (views) and the window-start lengths
        — what :func:`ops.cached_attention.verify_attention` takes."""
        W = k.shape[1]
        rows = torch.arange(self.num_slots, device=self.device)[:, None]
        pos = (self.lengths.long()[:, None]
               + torch.arange(W, device=self.device)[None, :]).clamp_max(
                   self.max_seq + self.headroom - 1)
        k_layer, v_layer = self.k[:, layer_idx], self.v[:, layer_idx]
        k_layer[rows, pos] = k.to(self.dtype)
        v_layer[rows, pos] = v.to(self.dtype)
        T = self.max_seq
        return k_layer[:, :T], v_layer[:, :T], self.lengths

    def verify_attention(self, layer_idx: int, q: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """One verify window of attention for this layer: write the
        window, then the plain per-slot offset causal attention."""
        k_full, v_full, lens = self.verify_write(layer_idx, k, v)
        return verify_attention(q, k_full, v_full, lens)

    def advance(self, active: torch.Tensor) -> None:
        """Grow the lengths by the ``[slots]`` int32 active mask (in place,
        once per decode step, after every layer has written)."""
        self.lengths += active

    def release_slot(self, slot: int) -> None:
        """Zero a retired slot's length.  Every decode writes a token for
        every slot at its length, the idle ones too: a slot left at
        ``max_seq`` (retired at capacity) would index past its stripe."""
        self.lengths[slot] = 0

    def reset(self) -> None:
        """Forget all sequences (lengths to 0; payloads left as they are —
        the write discipline makes stale bytes unreadable)."""
        self.lengths.zero_()

    def nbytes(self) -> int:
        return self.k.numel() * self.k.element_size() * 2


@dataclass
class CacheContext:
    """Per-forward routing handle threaded through the model's layers.

    ``mode`` is ``"prefill"`` (causal forward writing K/V into ``slot``),
    ``"decode"`` (one token for every slot at once) or ``"verify"`` (a
    speculative window of ``width`` tokens per slot, each slot's at its
    own offset).  ``layer_idx`` is set by the model's layer loop.  Models
    only duck-type this object: they route every mode but prefill through
    :meth:`decode_attention` and :meth:`positions`."""

    cache: object
    mode: str                          # "prefill" | "decode" | "verify"
    slot: Optional[torch.Tensor] = None  # prefill: int32, one element
    layer_idx: int = 0
    width: int = 1                     # verify: tokens per slot (k + 1)

    def __post_init__(self):
        if self.mode not in ("prefill", "decode", "verify"):
            raise ValueError(f"CacheContext mode {self.mode!r} "
                             "(want 'prefill', 'decode' or 'verify')")
        if self.mode == "prefill":
            self.slot = check_scalar("slot", self.slot)

    def write_prefill(self, k: torch.Tensor, v: torch.Tensor) -> None:
        self.cache.prefill_write(self.layer_idx, self.slot, k, v)

    def decode_attention(self, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
        """Write this layer's token K/V, then attend over each slot's
        window.  A cache with its own ``decode_attention`` (the paged
        pool's kernel-or-reference routing) takes the whole step; in
        ``verify`` mode the cache's ``verify_attention`` takes the
        window."""
        if self.mode == "verify":
            return self.cache.verify_attention(self.layer_idx, q, k, v)
        cache_fn = getattr(self.cache, "decode_attention", None)
        if cache_fn is not None:
            return cache_fn(self.layer_idx, q, k, v)
        k_full, v_full, lens = self.cache.decode_write(self.layer_idx, k, v)
        return cached_attention(q, k_full, v_full, lens)

    def positions(self) -> torch.Tensor:
        """Position ids: in decode ``[slots, 1]``, the pre-advance lengths;
        in verify ``[slots, width]``, ``lengths[slot] + i``.  A window's
        (and a cache with headroom's) are clamped to ``max_seq - 1``."""
        pos = self.cache.lengths[:, None]
        if self.mode == "verify":
            pos = pos + torch.arange(self.width, dtype=pos.dtype,
                                     device=pos.device)[None, :]
        if self.mode == "verify" or getattr(self.cache, "headroom", 0):
            pos = pos.clamp_max(self.cache.max_seq - 1)
        return pos

    def prefill_positions(self, seq_len: int) -> Optional[torch.Tensor]:
        """Prefill position ids, or None for ``0..S-1`` (the paged context
        offsets them past its cached prefix)."""
        return None

    def prefill_attention(self, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
        """Causal attention over the prompt bucket, kv heads expanded
        first (the flash kernel K1 on CUDA)."""
        H, Hkv = q.shape[2], k.shape[2]
        if Hkv != H:
            k = k.repeat_interleave(H // Hkv, dim=2)
            v = v.repeat_interleave(H // Hkv, dim=2)
        return flash_attention(q, k, v, is_causal=True)
