"""Continuous-batching serving engine: a slot scheduler over a KV cache.

Port of the core loop of ``paddle_tpu/serving/engine.py``:

- **prefill**: an admitted request's prompt (or, in the paged layout, its
  uncached tail after a prefix-cache hit) is padded to a power-of-two
  bucket and run through the model once, writing K/V into its slot; the
  first token is sampled on the device from the slot's staged lanes.
- **decode**: every step runs one forward over all slots (``[slots, 1]``
  tokens read from the sampler's device token lane), each active slot
  extending its sequence by one token.

Requests enter free slots as they arrive and retire the step they finish
(eos, token budget or cache capacity).  With ``kv_layout="paged"`` the
attention runs through the CUDA kernels K4/K5 (``kernel="auto"`` or
``"cuda"``) or the plain gather path (``"reference"``); the contiguous
layout prefills through the flash kernel K1 and decodes with the plain
one-row attention, as the JAX engine does.

As in the JAX engine, each step runs as a program built once and then
reused (``serving.programs``): one per prefill bucket and one for the
decode step, whose inputs (the bucket's ids; the slot, length and start;
the active mask) are data.  On the card a program is a CUDA graph,
captured at its first call and replayed after; :meth:`warmup` builds them
all, and ``stats()["compile_cache"]`` counts the builds (misses) and
reuses (hits): a miss after warmup is an anomaly.  The bodies stay
methods (:meth:`Engine._prefill_step`, :meth:`Engine._decode_step`) that
can be called eagerly.

The opt-in subsystems of the JAX engine are not part of this port yet:
speculation, adapters, grammars, the journal, the tracer, the mesh, fault
plans, the sanitizer and the watchdog, priorities, preemption, shedding,
deadlines, bounded queues and step retries, and ``Fleet``.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .kv_cache import CacheContext, KVCache
from .metrics import ServingMetrics
from .programs import StepPrograms
from .sampling import DeviceSampler, SamplingParams

__all__ = ["Engine", "Request", "SamplingParams"]

_engine_counter = itertools.count()

#: States a request never leaves.
TERMINAL_STATES = frozenset({"finished", "failed", "rejected"})


@dataclass(eq=False)
class Request:
    """One generation request: ``queued → running → finished | failed``;
    a malformed request goes straight to ``rejected``."""

    prompt_ids: np.ndarray
    max_new_tokens: int = 16
    sampling: SamplingParams = field(default_factory=SamplingParams)
    eos_token_id: Optional[int] = None
    stream_cb: Optional[Callable[[int, "Request"], None]] = None
    request_id: int = -1
    state: str = "queued"
    error: Optional[str] = None
    slot: Optional[int] = None
    output_ids: List[int] = field(default_factory=list)
    prefill_bucket: int = 0
    t_enqueue: float = 0.0
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    _seq_len: int = 0                # prompt + emitted tokens in the cache
    _defers: int = 0                 # paged admissions deferred so far

    @property
    def finished(self) -> bool:
        return self.state == "finished"

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_enqueue


class Engine:
    """Slot-based continuous-batching engine over a causal-LM model.

    Args:
        model: an ``nn.Module`` with a ``.config`` whose forward takes
            ``cache_ctx`` (``GPTForCausalLM``, ``LlamaForCausalLM``).  The
            engine runs on the model's device and switches it to eval
            mode.
        num_slots: fixed decode batch width.
        max_seq: per-slot cache capacity (prompt + generated); defaults to
            the model's ``max_position_embeddings``.
        min_bucket: smallest prefill bucket; buckets double up to
            ``max_seq``.
        cache_dtype: KV cache dtype (default: the model's).
        name: the engine's label in its metrics.
        kv_layout: ``"contiguous"`` (one ``max_seq`` stripe per slot) or
            ``"paged"`` (block pool, block tables, prefix reuse).
        kernel: paged attention path: ``"auto"``/``"cuda"`` (kernels K4
            and K5 for CUDA tensors) or ``"reference"`` (plain gather +
            attention).  The contiguous layout has one path.
        block_size: tokens per KV block (paged); must divide ``min_bucket``
            and ``max_seq``.
        num_kv_blocks: paged pool size; default
            ``num_slots * max_seq / block_size + 1`` (the scratch block).
        enable_prefix_cache: paged only: serve repeated prompt prefixes
            from shared blocks and prefill only the uncached tail.
    """

    def __init__(self, model: nn.Module, *, num_slots: int = 4,
                 max_seq: Optional[int] = None, min_bucket: int = 8,
                 cache_dtype: Optional[torch.dtype] = None,
                 name: Optional[str] = None, kv_layout: str = "contiguous",
                 kernel: str = "auto", block_size: int = 16,
                 num_kv_blocks: Optional[int] = None,
                 enable_prefix_cache: bool = True):
        cfg = getattr(model, "config", None)
        if cfg is None:
            raise TypeError("Engine needs a model carrying a .config "
                            "(GPTForCausalLM, LlamaForCausalLM)")
        self.model = model.eval()
        self.config = cfg
        param = next(model.parameters())
        self.device = param.device
        max_pos = getattr(cfg, "max_position_embeddings", None)
        if max_seq is None and max_pos is None:
            raise ValueError("max_seq is required: the model config has no "
                             "max_position_embeddings to default to")
        self.max_seq = int(max_seq or max_pos)
        if max_pos is not None and self.max_seq > max_pos:
            raise ValueError(f"max_seq {self.max_seq} exceeds the model's "
                             f"max_position_embeddings {max_pos}")
        self.num_slots = int(num_slots)
        self.min_bucket = int(min_bucket)
        if self.min_bucket < 1:
            raise ValueError(f"min_bucket must be >= 1, got {min_bucket}")
        self.buckets = self._make_buckets()
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"kv_layout must be 'contiguous' or 'paged', "
                             f"got {kv_layout!r}")
        if kernel not in ("auto", "cuda", "reference"):
            raise ValueError(f"kernel must be 'auto', 'cuda' or "
                             f"'reference', got {kernel!r}")
        self.kv_layout = kv_layout
        self.kernel = ("reference" if kv_layout == "contiguous"
                       else ("cuda" if kernel == "auto" else kernel))
        self.block_size = int(block_size)
        cache_dtype = cache_dtype or param.dtype
        kv_heads = getattr(cfg, "n_kv_heads", None) or \
            cfg.num_attention_heads
        self.prefix_cache = None
        if kv_layout == "paged":
            from .paging import PagedKVCache
            from .prefix_cache import PrefixCache

            if self.min_bucket % self.block_size != 0:
                raise ValueError(
                    f"block_size {self.block_size} must divide min_bucket "
                    f"{self.min_bucket} (so every prefill bucket is whole "
                    f"blocks)")
            if self.max_seq % self.block_size != 0:
                raise ValueError(f"block_size {self.block_size} must divide "
                                 f"max_seq {self.max_seq}")
            self.cache = PagedKVCache(
                self.num_slots, cfg.num_hidden_layers, self.max_seq,
                kv_heads, cfg.head_dim, cache_dtype,
                block_size=self.block_size, num_blocks=num_kv_blocks,
                kernel=self.kernel, device=self.device)
            if enable_prefix_cache:
                self.prefix_cache = PrefixCache(self.cache.allocator,
                                                self.block_size)
        else:
            self.cache = KVCache(self.num_slots, cfg.num_hidden_layers,
                                 self.max_seq, kv_heads, cfg.head_dim,
                                 cache_dtype, device=self.device)
        self.name = name or f"engine-{next(_engine_counter)}"
        self.metrics = ServingMetrics(self.name, num_slots=self.num_slots)
        self.sampler = DeviceSampler(self.num_slots, device=self.device)
        self.programs = StepPrograms(self.device, self.metrics.on_compile)
        self._warm_misses: Optional[int] = None
        self.queue: deque = deque()
        self.running: Dict[int, Request] = {}
        self.free_slots: List[int] = list(range(self.num_slots))
        self._req_counter = itertools.count()
        self._step_counter = 0

    # -- buckets -----------------------------------------------------------

    def _make_buckets(self) -> List[int]:
        b, out = self.min_bucket, []
        while b < self.max_seq:
            out.append(b)
            b *= 2
        out.append(self.max_seq)
        return out

    def bucket_for(self, prompt_len: int) -> int:
        if prompt_len > self.max_seq:
            raise ValueError(f"prompt length {prompt_len} exceeds cache "
                             f"capacity max_seq={self.max_seq}")
        for b in self.buckets:
            if prompt_len <= b:
                return b
        return self.max_seq

    # -- the two step bodies and their programs ---------------------------

    @torch.no_grad()
    def _prefill_step(self, ids: torch.Tensor,
                      meta: torch.Tensor) -> torch.Tensor:
        """Run one prompt bucket ``ids`` ``[1, S]`` int64 (the tokens at
        absolute positions ``start..``) into a slot, set the slot's
        length, and sample its first token on the device from the last
        real position (tail index ``length - start - 1``).  ``meta`` is
        the ``[3]`` int32 device tensor ``(slot, length, start)``, start 0
        in the contiguous layout.  Returns a ``[1]`` int32 device
        tensor."""
        slot, length, start = meta[0:1], meta[1:2], meta[2:3]
        if self.kv_layout == "paged":
            from .paging import PagedCacheContext

            ctx = PagedCacheContext(self.cache, "prefill", slot=slot,
                                    start=start)
        else:
            ctx = CacheContext(self.cache, "prefill", slot=slot)
        logits = self.model(ids, cache_ctx=ctx)
        self.cache.set_length(slot, length)
        last = logits[0].index_select(0, (length - start - 1).long())
        return self.sampler.sample_slot(slot.long(), last.float())

    @torch.no_grad()
    def _decode_step(self, active: torch.Tensor) -> torch.Tensor:
        """One decode step over all slots; ``active`` is the ``[slots]``
        int32 mask of slots whose length advances and whose sampler
        counter moves.  Returns the sampled ``[slots]`` int32 tokens (also
        written into the token lane)."""
        tokens = self.sampler.tokens[:, None].long()
        logits = self.model(tokens, cache_ctx=CacheContext(self.cache,
                                                           "decode"))
        self.cache.advance(active)
        return self.sampler.sample_all(logits[:, -1, :].float(), active)

    def _run_prefill(self, ids: np.ndarray, slot: int, length: int,
                     start: int = 0) -> torch.Tensor:
        """The prefill program of ``ids``'s bucket on this admission."""
        meta = np.array([slot, length, start], dtype=np.int32)
        return self.programs.run(("prefill", ids.shape[1]),
                                 self._prefill_step, ids, meta)

    def _run_decode(self, active: np.ndarray) -> torch.Tensor:
        return self.programs.run(("decode",), self._decode_step, active)

    # -- public API --------------------------------------------------------

    @staticmethod
    def resolve_model(config, *, device="cuda", dtype=torch.float32,
                      seed: int = 0) -> nn.Module:
        """Turn what :meth:`from_config` accepts into a model: a module
        passes through; a ``GPTConfig``/``LlamaConfig`` or a registry name
        (``"gpt:gpt2-345m"``, ``"llama:llama2-7b"``) builds one on
        ``device`` in ``dtype`` with weights drawn from a generator seeded
        with ``seed``.  A GPT is built with its dropout probabilities at
        0: serving runs in eval mode, where dropout does nothing."""
        from ..models import (
            GPT_CONFIGS, GPTConfig, GPTForCausalLM, LLAMA_CONFIGS,
            LlamaConfig, LlamaForCausalLM,
        )

        if isinstance(config, nn.Module):
            return config
        if isinstance(config, str):
            family, _, which = config.partition(":")
            reg = {"gpt": GPT_CONFIGS, "llama": LLAMA_CONFIGS}.get(family)
            if reg is None or (which or "tiny") not in reg:
                raise KeyError(
                    f"unknown model spec {config!r}; want "
                    f"'gpt:<{'|'.join(GPT_CONFIGS)}>' or "
                    f"'llama:<{'|'.join(LLAMA_CONFIGS)}>'")
            config = reg[which or "tiny"]()
        if isinstance(config, GPTConfig):
            config = dataclasses.replace(config, hidden_dropout_prob=0.0,
                                         attention_probs_dropout_prob=0.0)
            cls_ = GPTForCausalLM
        elif isinstance(config, LlamaConfig):
            cls_ = LlamaForCausalLM
        else:
            raise TypeError(f"Engine.from_config: unsupported config "
                            f"{type(config).__name__} — pass a GPTConfig/"
                            f"LlamaConfig, a 'family:size' name, or a model")
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but no CUDA "
                               f"device is available")
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return cls_(config, device=dev, dtype=dtype, generator=gen)

    @classmethod
    def from_config(cls, config, *, device="cuda", dtype=torch.float32,
                    seed: int = 0, **engine_kwargs) -> "Engine":
        """Build an engine from a ``GPTConfig``/``LlamaConfig``, a
        registry name or a model; ``device``/``dtype``/``seed`` place and
        draw a new model."""
        return cls(cls.resolve_model(config, device=device, dtype=dtype,
                                     seed=seed), **engine_kwargs)

    def _validate(self, req: Request) -> Optional[str]:
        if req.prompt_ids.size == 0:
            return "empty prompt"
        if req.prompt_ids.size > self.max_seq:
            return (f"prompt length {req.prompt_ids.size} exceeds "
                    f"max_seq={self.max_seq}")
        if req.max_new_tokens < 1:
            return f"max_new_tokens must be >= 1, got {req.max_new_tokens}"
        if self.kv_layout == "paged":
            need = self.bucket_for(req.prompt_ids.size) // self.block_size
            usable = self.cache.num_blocks - self.cache.allocator.reserved
            if need > usable:
                return (f"prompt needs {need} KV blocks but the pool holds "
                        f"{usable}")
        return None

    @staticmethod
    def _seed_for(req: Request) -> int:
        """The request's sampling seed (the JAX engine's formula): staged
        into the slot's generator at every admission."""
        return (req.sampling.seed if req.sampling.seed is not None
                else (req.request_id + 1) * 7919)

    def add_request(self, prompt_ids: Sequence[int], *,
                    max_new_tokens: int = 16,
                    sampling: Optional[SamplingParams] = None,
                    temperature: Optional[float] = None,
                    eos_token_id: Optional[int] = None,
                    stream_cb: Optional[Callable] = None) -> Request:
        """Enqueue a prompt; a later :meth:`step` admits it into a slot.
        A malformed request is marked ``rejected`` and raises
        ``ValueError`` (the handle rides on the exception's ``.request``)."""
        prompt = np.asarray(list(prompt_ids), dtype=np.int64).reshape(-1)
        if sampling is None:
            sampling = SamplingParams(temperature=temperature or 0.0)
        req = Request(prompt_ids=prompt, max_new_tokens=int(max_new_tokens),
                      sampling=sampling, eos_token_id=eos_token_id,
                      stream_cb=stream_cb,
                      request_id=next(self._req_counter))
        req.t_enqueue = time.perf_counter()
        problem = self._validate(req)
        if problem is not None:
            req.state, req.error = "rejected", problem
            req.t_finish = time.perf_counter()
            self.metrics.on_reject()
            err = ValueError(problem)
            err.request = req
            raise err
        self.queue.append(req)
        self.metrics.on_enqueue()
        return req

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> dict:
        """Build every step program: each bucket's prefill (a dummy
        admission into slot 0, one real token, released after) and the
        decode step, then reset the cache and the sampler.  On the card
        this captures the CUDA graphs, so that live serving starts with
        every program built: ``stats()["compile_cache"]["misses"]`` must
        not move after it."""
        if self.running or self.queue:
            raise RuntimeError("warmup() must run before serving traffic "
                               "(it scribbles over slot 0 and resets all "
                               "slot lengths)")
        use = [int(b) for b in (buckets or self.buckets)]
        for b in use:
            ids = np.zeros((1, b), dtype=np.int64)
            if self.kv_layout == "paged":
                if not self.cache.begin_sequence(0, [], 0, b):
                    raise RuntimeError(
                        f"warmup: pool of {self.cache.num_blocks} blocks "
                        f"cannot hold one bucket-{b} prefill")
                try:
                    int(self._run_prefill(ids, 0, 1, 0))
                finally:
                    self.cache.release_slot(0)
            else:
                int(self._run_prefill(ids, 0, 1))
        self._run_decode(np.zeros(self.num_slots, dtype=np.int32)).cpu()
        self.cache.reset()
        self.sampler.reset()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm_misses = self.metrics.compile_misses
        return {"buckets": use, "programs": ["prefill", "decode"],
                "compile_misses": self.metrics.compile_misses}

    # -- admission ---------------------------------------------------------

    def _prefix_lookup(self, req: Request):
        if self.prefix_cache is None:
            return 0, []
        return self.prefix_cache.lookup(req.prompt_ids, count=False)

    def _paged_prefill(self, req: Request, L: int):
        """Paged admission: prefix lookup, block assignment, tail-bucket
        prefill.  Returns ``(status, first_token, bucket)``, status
        ``"ok"`` or ``"deferred"`` (no blocks now; slot untouched)."""
        P, shared = self._prefix_lookup(req)
        bucket = self.bucket_for(L - P)
        # a partial hit can push prefix + padded tail past the block table:
        # drop hit blocks from the end until the tail fits
        while shared and (len(shared) + bucket // self.block_size
                          > self.cache.max_blocks_per_slot):
            shared = shared[:-1]
            P -= self.block_size
            bucket = self.bucket_for(L - P)
        if self.prefix_cache is not None and req._defers == 0:
            self.prefix_cache.record_lookup(L, P)
        if not self.cache.begin_sequence(req.slot, shared, P, bucket):
            return "deferred", None, bucket
        ids = np.zeros((1, bucket), dtype=np.int64)
        ids[0, :L - P] = req.prompt_ids[P:]
        tok = self._run_prefill(ids, req.slot, L, P)
        if self.prefix_cache is not None:
            self.prefix_cache.register(req.prompt_ids,
                                       self.cache.owned_blocks(req.slot))
        return "ok", tok, bucket

    def _admit(self, req: Request) -> Optional[bool]:
        """Prefill ``req`` into its slot and deliver its first token.
        Returns False when a paged admission must wait for blocks."""
        L = int(req.prompt_ids.size)
        t0 = time.perf_counter()
        self.sampler.stage_slot(req.slot, req.sampling, self._seed_for(req))
        if self.kv_layout == "paged":
            status, tok_t, bucket = self._paged_prefill(req, L)
            if status == "deferred":
                return False
        else:
            bucket = self.bucket_for(L)
            ids = np.zeros((1, bucket), dtype=np.int64)
            ids[0, :L] = req.prompt_ids
            tok_t = self._run_prefill(ids, req.slot, L)
        # waits for the prefill; read before any other program runs
        tok = int(tok_t)
        now = time.perf_counter()
        self.metrics.prefill_time_s += now - t0
        req.state, req.prefill_bucket = "running", bucket
        req._seq_len = L
        self.running[req.slot] = req
        self.metrics.on_admit(bucket, L)
        if not self._emit_token(req, tok, now):
            return None
        self.metrics.on_first_token(req.ttft_s)
        if self._done_after_emit(req):
            self._retire(req)
        return None

    def _emit_token(self, req: Request, tok: int, now: float) -> bool:
        """Record one token and run the stream callback; a raising
        callback fails this request only."""
        if req.t_first_token is None:
            req.t_first_token = now
        req.output_ids.append(int(tok))
        if req.stream_cb is not None:
            try:
                req.stream_cb(int(tok), req)
            except Exception as e:       # noqa: BLE001 — per-request boundary
                self._retire(req, "failed", error=f"stream_cb raised: "
                             f"{type(e).__name__}: {e}")
                return False
        return True

    def _done_after_emit(self, req: Request) -> bool:
        if len(req.output_ids) >= req.max_new_tokens:
            return True
        if req.eos_token_id is not None and \
                req.output_ids[-1] == req.eos_token_id:
            return True
        # the next decode writes at position _seq_len
        return req._seq_len + 1 > self.max_seq

    def _retire(self, req: Request, state: str = "finished",
                error: Optional[str] = None) -> None:
        """The single exit path: the slot (and its blocks) are reclaimed
        exactly once.  Idempotent."""
        if req.done:
            return
        req.state = state
        if error is not None:
            req.error = error
        req.t_finish = time.perf_counter()
        slot = req.slot
        if slot is not None:
            self.running.pop(slot, None)
            if slot not in self.free_slots:
                self.free_slots.append(slot)
            if self.kv_layout == "paged":
                self.cache.release_slot(slot)
        if state == "finished":
            self.metrics.on_complete()
        elif state == "failed":
            self.metrics.on_fail()

    # -- decode ------------------------------------------------------------

    def _prepare_decode_paged(self) -> None:
        """Before a paged decode step each running slot's next write
        position must sit in a block it owns alone (fresh block or copy on
        extend); a slot the pool cannot serve fails."""
        for slot, req in list(self.running.items()):
            if not self.cache.ensure_capacity(slot, req._seq_len):
                self._retire(req, "failed",
                             error="KV block pool exhausted: no block free "
                                   f"for position {req._seq_len}")

    def _decode_body(self):
        """Dispatch one decode step.  Returns ``(tokens, t0)`` or None."""
        if self.kv_layout == "paged":
            self._prepare_decode_paged()
            if not self.running:
                return None
        active = np.zeros((self.num_slots,), dtype=np.int32)
        for slot in self.running:
            active[slot] = 1
        t0 = time.perf_counter()
        return self._run_decode(active), t0

    def _deliver_tokens(self, out: torch.Tensor, t0: float) -> None:
        """Pull the ``[slots]`` sampled tokens (the step's one device to
        host copy, before any other program runs), then run callbacks and
        stop checks."""
        toks = out.cpu().numpy()
        now = time.perf_counter()
        self.metrics.on_decode_step(len(self.running), now - t0)
        for slot, req in list(self.running.items()):
            req._seq_len += 1
            if not self._emit_token(req, int(toks[slot]), now):
                continue
            if self._done_after_emit(req):
                self._retire(req)

    # -- scheduling --------------------------------------------------------

    def step(self) -> bool:
        """One scheduler tick: admit queued requests into free slots (FIFO),
        then one decode step for the running slots.  True while work
        remains."""
        while self.queue and self.free_slots:
            req = self.queue.popleft()
            req.slot = self.free_slots.pop()
            try:
                deferred = self._admit(req) is False
            except BaseException:
                if not req.done:
                    self._retire(req, "failed",
                                 error="admission aborted by engine error")
                raise
            if deferred:
                # no blocks for this prompt now: hand the slot back and
                # wait for running work to retire; with nothing running no
                # block can ever free, so fail instead of spinning
                self.free_slots.append(req.slot)
                req.slot = None
                req._defers += 1
                if self.running:
                    self.queue.appendleft(req)
                else:
                    self._retire(req, "failed",
                                 error="KV block pool exhausted: prompt "
                                       "needs more free blocks than the "
                                       "pool can supply")
                break
        self.metrics.on_slots(len(self.running))
        if self.running:
            res = self._decode_body()
            if res is not None:
                self._deliver_tokens(*res)
        self._step_counter += 1
        return bool(self.running or self.queue)

    def run(self, max_steps: Optional[int] = None) -> None:
        """Drive :meth:`step` until idle (or ``max_steps``)."""
        n = 0
        while self.step():
            n += 1
            if max_steps is not None and n >= max_steps:
                break

    def generate(self, prompts: Sequence[Sequence[int]], *,
                 max_new_tokens: int = 16,
                 **request_kwargs) -> List[List[int]]:
        """Serve a batch of prompts to completion; generated ids per
        prompt."""
        reqs = [self.add_request(p, max_new_tokens=max_new_tokens,
                                 **request_kwargs) for p in prompts]
        self.run()
        return [r.output_ids for r in reqs]

    # -- introspection -----------------------------------------------------

    def _paging_snapshot(self) -> dict:
        al = self.cache.allocator.stats()
        return {"kv_layout": "paged", "kernel": self.kernel,
                "block_size": self.block_size,
                "max_blocks_per_slot": self.cache.max_blocks_per_slot,
                "blocks": al, "blocks_in_use": al["used"] + al["cached"],
                "copy_on_extends": self.cache.copy_on_extends,
                "prefix": (self.prefix_cache.stats()
                           if self.prefix_cache is not None else None)}

    def health(self) -> dict:
        """Liveness snapshot; in the paged layout also the block
        allocator's invariant audit (``"ok"`` or the violations)."""
        out = {"steps": self._step_counter, "queue_depth": len(self.queue),
               "slots_free": len(self.free_slots),
               "slots_total": self.num_slots}
        if self.kv_layout == "paged":
            violations = self.cache.check_invariants()
            al = self.cache.allocator.stats()
            out["kv_blocks"] = {k: al[k] for k in ("total", "reserved",
                                                   "free", "used", "cached")}
            out["kv_block_invariants"] = violations or "ok"
        return out

    def stats(self) -> dict:
        """``/stats``-style snapshot: the serving metrics, the health
        audit and, paged, the pool and prefix-cache gauges."""
        self.metrics._slots_busy = len(self.running)
        snap = self.metrics.snapshot()
        # programs built after warmup: a steady-state anomaly (None before
        # warmup)
        snap["compile_cache"]["after_warmup"] = (
            None if self._warm_misses is None
            else self.metrics.compile_misses - self._warm_misses)
        snap["queue_depth"] = len(self.queue)
        snap["health"] = self.health()
        snap["paging"] = (self._paging_snapshot()
                          if self.kv_layout == "paged" else None)
        return snap
