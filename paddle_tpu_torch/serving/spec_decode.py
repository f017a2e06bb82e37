"""Speculative decoding: draft propose, one ``[slots, k+1]`` verify step,
acceptance on the device.

Port of ``paddle_tpu/serving/spec_decode.py``.  A small draft model
proposes ``k`` tokens one decode step at a time; the target model then
scores the pending token and the ``k`` proposals in one forward over a
``[slots, k+1]`` window (the ``"verify"`` cache mode), and rejection
sampling inside that same program keeps the longest valid prefix of the
proposals plus one bonus or resampled token.  A round emits 1 to ``k+1``
tokens per slot for one target forward.

As the engine's other steps, each part of a round is a program built once
at warmup (``serving.programs``; a CUDA graph on the card): one draft
prefill per bucket, ONE draft decode (the proposal's column ``j`` is a
device input, so the ``k`` calls of a round replay one graph) and ONE
verify (the active mask and the per-slot emission cap are device
inputs).  No program reads a device value on the host: the proposals
chain through the draft sampler's token lane into the ``[slots, k]``
proposals lane, the verify reads them from there, and the host pulls one
``[slots, k+2]`` int32 array per round (the emitted count, then the
emitted tokens).

- **Greedy is exact.**  Every token a greedy slot emits is the target's
  argmax at its position, whatever the draft proposed, so its stream is
  the non-speculative engine's.
- **Sampling keeps the target law** (:meth:`DeviceSampler.accept_speculative`
  argues the randomness: counters ``c + i`` under salted seeds, advanced
  by the emitted count, so no draw that decided an emitted token is used
  again), and a seeded stream replays the same.
- **Rollback is bookkeeping.**  The verify advances each slot's length by
  the emitted count only, so the rejected window positions stay
  unreadable; the paged engine then drops the table's blocks past the
  accepted length.
- **The draft's window is recomputed in the verify.**  The verify rewinds
  the draft's lengths to the round's start and runs the draft over the
  same window: that gives the exact proposal law for the acceptance ratio
  without keeping ``[slots, k, V]`` probabilities, and writes the draft's
  K/V for all ``k+1`` positions, so both caches end every round at the
  same length with one pending token.

Tenancy: the draft sampler shares the engine's grammar table, so the
proposals are drawn from the masked law the verify prices; the draft's
automaton state is the target's after the draft prefill, and both are
set to the state folded through the round's emitted tokens at its end.
The verify's target forward runs under each slot's adapter rows; the
draft runs under none (the acceptance prices the draft's own law, so an
un-adapted draft costs acceptance, never correctness).

Sharding: on a mesh the draft is cut into the rank's shard where the mesh
divides its heads and vocabulary (its cache then holds the rank's kv
heads), and otherwise runs whole on every rank; the proposals lane is
whole on every rank.

Durability: the draft's K/V is never journaled.  A preempted or recovered
request replays from its prompt, and its re-admission prefills the draft
again (a full-prompt prefill, no prefix cache, through the contiguous
layout's flash kernel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from .kv_cache import CacheContext, KVCache
from .sampling import DeviceSampler

__all__ = ["SpecConfig", "SpecState", "DRAFT_SEED_SALT"]

#: XORed into a request's effective seed for the draft's lanes: the draft
#: draws a stream of its own (the acceptance ratio prices it, the target
#: never replays it), yet a deterministic one, so preempt-resume and
#: journal recovery re-seed both lanes from the one journaled seed.
DRAFT_SEED_SALT = 0x5DC0DE


@dataclass
class SpecConfig:
    """Speculative decoding for :class:`~.engine.Engine` (opt-in).

    Args:
        draft_model: the proposal model: anything ``Engine.resolve_model``
            takes (a module, a ``GPTConfig``/``LlamaConfig`` or a registry
            name), built on the engine's device.  It must share the
            target's vocabulary and cover the engine's ``max_seq``
            positions.  It may be the target module itself
            (self-speculation, which accepts nearly every proposal).
        k: draft tokens proposed per round (the verify window is ``k + 1``
            wide).
        draft_cache_dtype: the draft's KV dtype (default: its parameters').
    """

    draft_model: Any
    k: int = 4
    draft_cache_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if int(self.k) < 1:
            raise ValueError(f"SpecConfig.k must be >= 1, got {self.k}")


class SpecState:
    """One engine's speculative state: the draft model, its contiguous KV
    cache (slot ``i`` mirrors the target's slot ``i``; ``k`` positions of
    headroom past ``max_seq`` take a near-capacity round's writes), its
    :class:`DeviceSampler` (the proposal law's lanes) and the ``[slots,
    k]`` proposals lane.  The three step bodies are methods that the
    engine runs as programs, or calls eagerly."""

    def __init__(self, engine, config: SpecConfig):
        from .engine import Engine

        self.config = config
        self.k = int(config.k)
        param = next(engine.model.parameters())
        model = Engine.resolve_model(config.draft_model,
                                     device=engine.device, dtype=param.dtype)
        dcfg = getattr(model, "config", None)
        if dcfg is None:
            raise TypeError("SpecConfig.draft_model needs a model "
                            "carrying a .config")
        if dcfg.vocab_size != engine.config.vocab_size:
            raise ValueError(
                f"draft vocab_size {dcfg.vocab_size} != target "
                f"{engine.config.vocab_size}: speculative acceptance "
                "compares distributions over one shared vocabulary")
        max_pos = getattr(dcfg, "max_position_embeddings", None)
        if max_pos is not None and max_pos < engine.max_seq:
            raise ValueError(
                f"draft max_position_embeddings {max_pos} < engine "
                f"max_seq {engine.max_seq}: the draft must cover every "
                "position it verifies")
        shard = engine.shard
        if shard is not None:
            if config.draft_model is engine.source_model:
                # self-speculation: the target's own shard
                model = engine.model
            elif shard.divides(dcfg.num_attention_heads,
                               getattr(dcfg, "n_kv_heads", None)
                               or dcfg.num_attention_heads,
                               dcfg.vocab_size):
                # the draft shards like the target where its heads divide
                # the mesh; otherwise it runs whole on every rank
                model = shard.place_model(model)
        dparam = next(model.parameters())
        if dparam.device != engine.device:
            raise ValueError(f"draft model on {dparam.device}, the engine "
                             f"on {engine.device}")
        # the target's model, cache and sampler, not the engine: the engine
        # holds this state, and a cycle would leave a dropped engine (and
        # its CUDA graphs) to the cyclic collector
        self.target_model = engine.model
        self.target_cache = engine.cache
        self.target_sampler = engine.sampler
        self.model = model.eval()
        dtype = config.draft_cache_dtype or dparam.dtype
        kv_heads = getattr(dcfg, "n_kv_heads", None) or \
            dcfg.num_attention_heads
        if getattr(self.model, "mesh", None) is not None:
            kv_heads = shard.local_heads(kv_heads)
        self.cache = KVCache(engine.num_slots, dcfg.num_hidden_layers,
                             engine.max_seq, kv_heads, dcfg.head_dim, dtype,
                             device=engine.device, headroom=self.k)
        # the engine's grammar table: one stacked trans/mask pair serves
        # both samplers
        self.sampler = DeviceSampler(engine.num_slots, device=engine.device,
                                     grammar=engine.sampler.grammar)
        self.target_pool = engine.adapter_pool
        self.proposals = torch.zeros((engine.num_slots, self.k),
                                     dtype=torch.int32, device=engine.device)

    # -- host-side slot lifecycle ------------------------------------------

    @staticmethod
    def draft_seed(seed: int) -> int:
        return int(seed) ^ DRAFT_SEED_SALT

    def stage_slot(self, slot: int, params, seed: int) -> None:
        """Stage the draft's lanes at an admission (first, resumed or
        recovered alike): the target's sampling parameters, the law the
        acceptance ratio prices, and the salted seed."""
        self.sampler.stage_slot(slot, params, self.draft_seed(seed))

    def release_slot(self, slot: int) -> None:
        """Forget a retired or preempted slot's draft sequence."""
        self.cache.release_slot(slot)

    def restore_lanes(self) -> None:
        """After the target's lanes were rewritten for a retry
        (``Engine._restore_lanes``), set the draft's length, token,
        counter and automaton-state lanes to the target's: at a round's
        start the two are in lockstep."""
        self.cache.lengths.copy_(self.target_cache.lengths)
        self.sampler.tokens.copy_(self.target_sampler.tokens)
        self.sampler.counters.copy_(self.target_sampler.counters)
        if self.sampler.grammar is not None:
            self.sampler.grammar_states.copy_(
                self.target_sampler.grammar_states)

    def reset(self) -> None:
        """Forget everything (warmup scribbles over slot 0's lanes)."""
        self.cache.reset()
        self.sampler.reset()
        self.proposals.zero_()

    # -- the step bodies ----------------------------------------------------

    @torch.no_grad()
    def draft_prefill(self, ids: torch.Tensor,
                      meta: torch.Tensor) -> torch.Tensor:
        """Prefill a whole prompt bucket ``ids`` ``[1, S]`` into the draft
        slot, set its length, and chain the draft's token and counter
        lanes off the target's (its prefill sampled the first token and
        counted one draw), so the round's first draft step feeds on the
        device; with grammars, its automaton state too (the target's
        prefill advanced past the first token).  ``meta`` is the ``[2]``
        int32 device tensor ``(slot, length)``.  Returns the slot's
        pending token ``[1]`` int32."""
        slot, length = meta[0:1], meta[1:2]
        self.model(ids, cache_ctx=CacheContext(self.cache, "prefill",
                                               slot=slot))
        self.cache.set_length(slot, length)
        idx = slot.long()
        target = self.target_sampler
        tok = target.tokens.index_select(0, idx)
        self.sampler.tokens.index_copy_(0, idx, tok)
        self.sampler.counters.index_copy_(
            0, idx, target.counters.index_select(0, idx))
        if self.sampler.grammar is not None:
            self.sampler.grammar_states.index_copy_(
                0, idx, target.grammar_states.index_select(0, idx))
        return tok

    @torch.no_grad()
    def draft_decode(self, active: torch.Tensor,
                     j: torch.Tensor) -> torch.Tensor:
        """One draft step for every slot: feed the draft's token lane,
        draw proposal ``j`` (a ``[1]`` int32 device index) into
        ``proposals[:, j]`` and the token lane.  Returns the ``[slots]``
        int32 proposals."""
        tokens = self.sampler.tokens[:, None].long()
        logits = self.model(tokens, cache_ctx=CacheContext(self.cache,
                                                           "decode"))
        self.cache.advance(active)
        prop = self.sampler.sample_all(logits[:, -1, :].float(), active)
        self.proposals.index_copy_(1, j.long(), prop[:, None])
        return prop

    @torch.no_grad()
    def verify(self, active: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
        """The verify step: one target forward over the ``[slots, k+1]``
        window (the pending token, then the proposals), the draft's window
        recomputed from the round's start, acceptance, and the length
        advance by the emitted count that is the rollback.  ``active`` and
        ``cap`` are ``[slots]`` int32.  Returns ``[slots, k+2]`` int32: the
        advance (``m`` for a running slot, 0 for an idle one), then the
        emitted tokens."""
        cache, sampler = self.target_cache, self.target_sampler
        W = self.k + 1
        window = torch.cat([sampler.tokens[:, None], self.proposals],
                           dim=1).long()
        pool = self.target_pool
        if pool is not None:
            pool.set_rows(pool.adapter_ids)   # the target's rows only
        try:
            tlogits = self.target_model(window, cache_ctx=CacheContext(
                cache, "verify", width=W))
        finally:
            if pool is not None:
                pool.clear_rows()
        # the draft's k steps advanced it: rewind to the round's start
        self.cache.lengths.copy_(cache.lengths)
        dlogits = self.model(window, cache_ctx=CacheContext(
            self.cache, "verify", width=W))
        emitted, m = sampler.accept_speculative(
            tlogits, dlogits, self.proposals, cap, active, self.sampler)
        adv = m * active
        cache.advance(adv)
        self.cache.advance(adv)
        return torch.cat([adv[:, None], emitted], dim=1).to(torch.int32)

    def nbytes(self) -> int:
        return self.cache.nbytes()

    def snapshot(self) -> dict:
        """The configuration half of ``stats()["speculation"]`` (the
        counters are :class:`~.metrics.ServingMetrics`')."""
        return {"k": self.k, "draft_layers": self.cache.num_layers,
                "draft_cache_mb": round(self.cache.nbytes() / 2 ** 20, 3)}
