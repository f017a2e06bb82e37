"""Cross-request prefix reuse: a host-side hash-chained block cache.

The port's own copy of ``paddle_tpu/serving/prefix_cache.py`` (numpy and
hashlib only).

- **Whole blocks only**: a block of ``block_size`` tokens is the unit of
  storage and of matching.
- **Hash-chained keys**: block ``i``'s key is
  ``H(key[i-1] || tokens[i*bs:(i+1)*bs])``, so a hit is always a
  contiguous prefix.
- **Capped below the full prompt**: at most ``(len(prompt) - 1) // bs``
  blocks hit, so the tail prefill always has a token to produce logits.
- **One reference per cached block**, taken on registration; evicting an
  entry drops only that reference.
- **LRU, leaf-first eviction** of idle entries (refcount 1).
- **Weight-version epoch**: the epoch is folded into every chain's root,
  so after :meth:`PrefixCache.bump_epoch` (a weight hot swap) no entry
  registered under older weights can be hit: its KV was computed by
  other weights.  Entries a live slot still pins keep their reference
  until the slot releases, unreachable either way.
- **Tenant salt**: a LoRA adapter changes the K/V a prompt computes, so
  :meth:`PrefixCache.lookup`, :meth:`~PrefixCache.register` and
  :meth:`~PrefixCache.probe` take a ``salt`` (``b""`` for the base
  model, ``b"name@vN"`` from ``AdapterPool.salt``) folded into the chain
  root after the epoch: one prompt lives in one disjoint hash domain per
  tenant and adapter version.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["PrefixCache"]

_ROOT = b"paddle-tpu-prefix-root"


def _chain_hash(parent: bytes, tokens: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(parent)
    h.update(np.ascontiguousarray(tokens, dtype=np.int64).tobytes())
    return h.digest()


@dataclass
class _Entry:
    block_id: int
    parent: Optional[bytes]
    children: int = 0


class PrefixCache:
    """Host-side chained-hash map from prompt blocks to pool block ids."""

    def __init__(self, allocator, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.allocator = allocator
        self.block_size = int(block_size)
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        #: weight-version epoch, folded into every chain-hash root
        self.epoch = 0
        self.lookups = 0
        self.hit_blocks_total = 0
        self.hit_tokens_total = 0
        self.lookup_tokens_total = 0
        self.evictions = 0
        allocator.evict_cb = self._evict_for_alloc

    def _keys_for(self, prompt: np.ndarray, n_blocks: int,
                  salt: bytes = b"") -> List[bytes]:
        bs, keys = self.block_size, []
        parent = _ROOT + self.epoch.to_bytes(8, "little") + salt
        for i in range(n_blocks):
            parent = _chain_hash(parent, prompt[i * bs:(i + 1) * bs])
            keys.append(parent)
        return keys

    def record_lookup(self, prompt_tokens: int, hit_tokens: int) -> None:
        """Count one logical lookup toward the hit-rate gauges (the engine
        calls it once per request, with the hit it actually reused)."""
        self.lookups += 1
        self.lookup_tokens_total += int(prompt_tokens)
        self.hit_blocks_total += int(hit_tokens) // self.block_size
        self.hit_tokens_total += int(hit_tokens)

    def lookup(self, prompt: Sequence[int], count: bool = True,
               salt: bytes = b"") -> Tuple[int, List[int]]:
        """Longest cached prefix of ``prompt`` in ``salt``'s domain:
        ``(n_tokens, block_ids)``.  Refreshes the hit entries' recency but
        takes no references."""
        prompt = np.asarray(list(prompt), dtype=np.int64).reshape(-1)
        if count:
            self.lookups += 1
            self.lookup_tokens_total += int(prompt.size)
        max_hit = max(0, (int(prompt.size) - 1) // self.block_size)
        block_ids: List[int] = []
        for key in self._keys_for(prompt, max_hit, salt):
            e = self._entries.get(key)
            if e is None:
                break
            self._entries.move_to_end(key)
            block_ids.append(e.block_id)
        if count:
            self.hit_blocks_total += len(block_ids)
            self.hit_tokens_total += len(block_ids) * self.block_size
        return len(block_ids) * self.block_size, block_ids

    def probe(self, prompt: Sequence[int], salt: bytes = b"") -> int:
        """Longest cached prefix of ``prompt`` in ``salt``'s domain, in
        tokens, with no side effect: no recency refresh, no counter, no
        reference."""
        prompt = np.asarray(list(prompt), dtype=np.int64).reshape(-1)
        max_hit = max(0, (int(prompt.size) - 1) // self.block_size)
        n = 0
        for key in self._keys_for(prompt, max_hit, salt):
            if key not in self._entries:
                break
            n += 1
        return n * self.block_size

    def register(self, prompt: Sequence[int], block_ids: Sequence[int],
                 salt: bytes = b"") -> int:
        """Make ``prompt``'s whole blocks hittable in ``salt``'s domain;
        ``block_ids`` cover them in order.  Keys already present are left
        alone (first writer wins: the bytes are the same).  Returns the
        entries created."""
        prompt = np.asarray(list(prompt), dtype=np.int64).reshape(-1)
        n_full = min(int(prompt.size) // self.block_size, len(block_ids))
        created, parent = 0, None
        for depth, key in enumerate(self._keys_for(prompt, n_full, salt)):
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                parent = key
                continue
            self._entries[key] = _Entry(block_id=int(block_ids[depth]),
                                        parent=parent)
            self.allocator.ref(int(block_ids[depth]))
            self.allocator.mark_cached(int(block_ids[depth]))
            if parent is not None:
                self._entries[parent].children += 1
            parent = key
            created += 1
        return created

    def _evictable(self) -> Optional[bytes]:
        """Oldest idle leaf entry, or None."""
        for key, e in self._entries.items():
            if e.children == 0 and self.allocator.refcount(e.block_id) == 1:
                return key
        return None

    def _evict_one(self, key: bytes) -> None:
        e = self._entries.pop(key)
        if e.parent is not None and e.parent in self._entries:
            self._entries[e.parent].children -= 1
        self.allocator.unmark_cached(e.block_id)
        self.allocator.unref(e.block_id)
        self.evictions += 1

    def _evict_for_alloc(self, n_blocks: int) -> int:
        freed = 0
        while freed < n_blocks:
            key = self._evictable()
            if key is None:
                break
            self._evict_one(key)
            freed += 1
        return freed

    def bump_epoch(self) -> int:
        """Invalidate every cached block for a weight hot swap: advance
        the epoch (new lookups and registrations hash in a disjoint
        domain, so an old-epoch entry can never be hit again) and drop
        every entry, so idle stale-KV blocks return to the pool.  Returns
        the new epoch."""
        self.epoch += 1
        self.clear()
        return self.epoch

    def clear(self) -> int:
        """Drop every entry, releasing the cache's references (a block a
        live slot still holds stays allocated to it).  Returns the number
        of entries dropped."""
        n = 0
        while self._entries:
            key = self._evictable()
            if key is None:
                # the rest is pinned by live slots: drop the cache's view
                # of them anyway (its refs released, the chains gone)
                key = next(iter(self._entries))
            self._evict_one(key)
            n += 1
        return n

    def __len__(self) -> int:
        return len(self._entries)

    def hit_rate(self) -> float:
        """Fraction of looked-up prompt tokens served from the cache."""
        return self.hit_tokens_total / self.lookup_tokens_total \
            if self.lookup_tokens_total else 0.0

    def stats(self) -> dict:
        return {"entries": len(self._entries), "epoch": self.epoch,
                "lookups": self.lookups,
                "hit_blocks": self.hit_blocks_total,
                "hit_tokens": self.hit_tokens_total,
                "lookup_tokens": self.lookup_tokens_total,
                "hit_rate": round(self.hit_rate(), 4),
                "evictions": self.evictions}
