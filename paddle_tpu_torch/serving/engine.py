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

Request lifecycle and overload, as in the JAX engine: requests end
``finished | failed | cancelled | rejected``, every exit through
:meth:`Engine._retire`; ``Request.cancel()``, wall-clock deadlines, a
bounded queue (:class:`QueueFull`, ``reject`` or ``block``), bounded step
retries, priority classes with deferral aging, preemption of a
lower-priority stream for a slot or for KV blocks (its prompt blocks kept
in the prefix cache, so the resume prefills only the tail bucket), and
SLO shedding (:class:`ShedReject`).  All of it is host-side bookkeeping
between programs: none of it adds a step program.  A request tracer
(``tracer=``, :mod:`.tracing`) records each request's span chain, and a
flight recorder keeps the last steps' summaries.

A step program writes state in place while it runs (the KV cache, the
lengths, the sampler's token and draw-counter lanes), where the JAX
engine's ``jit`` wrote state back only when a call returned.  So a retry
first rewrites, from the host's own bookkeeping, what a failed call may
have written, whether it failed before its replay was enqueued or after
(:meth:`Engine._step_call`).

Durability, as in the JAX engine: the engine's ``state`` (``active``,
``draining``, ``stopped`` or a sticky ``unhealthy``), :meth:`Engine.drain`
and :meth:`Engine.shutdown`; a request journal (``journal=``,
:class:`~.journal.RequestJournal`) written between programs (an
admission record before the request is queued, one token record per
engine step, a restart at preemption, an end at retirement), from which
:meth:`Engine.recover` replays a crashed process's unfinished requests
from their prompts; and :meth:`Engine.update_weights`, a hot swap on an
idle engine.  A captured CUDA graph reads the parameters at the
addresses it saw at capture, so a swap writes every parameter in place
(``copy_``) on the stream the programs replay on, synchronises it, and
raises if a parameter moved; the JAX engine could rebind its buffers.
A self-speculating draft is the target module, so it follows the swap.

Speculative decoding, as in the JAX engine (``speculation=SpecConfig(
draft_model, k)``, :mod:`.spec_decode`): every request is served in
rounds of ``k`` draft-decode programs and one verify program, whose
``[slots, k+1]`` target forward and rejection-sampling acceptance emit 1
to ``k+1`` tokens per slot; the host pulls one ``[slots, k+2]`` int32
array a round.  A round replaces the decode program; the draft's prefill
runs after the target's at each admission.  A round's retry rewinds all
``k+1`` programs (the target's lanes as for a decode, the draft's length,
token and counter lanes to the target's), a preemption falls between
rounds, and the journal gets one token record per round.

Multi-tenant serving, as in the JAX engine (``adapters=``, an
:class:`~.adapters.AdapterConfig` or its keywords; ``grammars=``, a dict
of grammar specs): per-request LoRA
adapters (``SamplingParams.adapter``) through per-target factor lanes and
a per-slot id lane that the decoder layers' linears read through forward
hooks, constrained decoding (``SamplingParams.grammar``) through token
masks and a per-slot automaton state lane in the sampler, per-tenant SLO
accounting (``stats()["tenants"]``), the prefix cache salted per adapter
version, and :meth:`Engine.load_adapter`/:meth:`Engine.unload_adapter`
writing lane rows in place under the CUDA graphs (a hot swap or an unload
fails the adapter's in-flight requests with ``error_ctx``).  Every lane
is data the programs read: one set of programs serves every tenant mix,
and with no tenant selected the streams are the plain engine's, bitwise.

Resilience, as in the JAX engine: a serving fault plan
(``fault_plan=``, default :meth:`~..distributed.fault_tolerance.injection.
ServingFaultPlan.from_env`, ``PADDLE_TPU_FT_SERVING_FAULTS``) checked at
the same fault points, an injected failure taking the retry and lane
rewrite of any failed call; a step watchdog (``step_timeout_s=``) that
turns the engine sticky ``unhealthy`` when a step does not finish in
time; the sync sanitizer (``PADDLE_TPU_SANITIZE``, :mod:`.sanitize`),
which counts host coercions in each decode dispatch and runs the card
under CUDA's sync debug mode around the step call; and the prefix
cache's degraded mode (a lookup that raises or takes longer than
``prefix_lookup_timeout_s`` serves as a miss, a registration that raises
is counted and the request goes on).

A replay returns once its work is enqueued, so on the card a step's
device time is paid at the host's read of its output.  The watchdog's
window therefore runs from the step call until that read has returned
(:meth:`Engine._step_call` arms it, :meth:`Engine._disarm_watchdog`
after the read ends it), while the sanitizer's counting window keeps
the JAX engine's boundary and closes before the read: the two windows
end at different places.  A program's build (its kernels' compile, its
graph's capture) is not a step: the heartbeat pauses over it.

A fleet (:class:`~.router.Fleet`) puts replicas of this engine behind one
submit surface.  Its hooks here are the JAX engine's:
:meth:`Engine.export_requests` (the ejection hook),
``update_weights(version=)`` and ``Engine(model_version=)``; and
:meth:`Engine._release_device`, which frees what an ejected engine holds
on the card before its successor is built.

Tensor-parallel sharded serving, as in the JAX engine (``mesh=``, a
serving mesh from :func:`~.sharding.serving_mesh`; :mod:`.sharding`):
every rank of the mesh runs this engine on its shard of the model (its
heads, its KV pool at ``kv_heads/mp``), fed the same calls.  Every host
decision is the same on every rank: a decision that reads a clock or a
thread reads the values rank 0 had at the decision exchange that starts
each step and each ``add_request`` (:meth:`Engine._exchange`), which also
compares the ranks' scheduling digests and raises on a divergence.  The
logits are all-gathered over the vocabulary inside the model, so each
rank samples the same tokens from the same whole lanes.  A mesh of one
makes no exchange and serves the plain engine's streams bitwise.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
import weakref
import zlib
from collections import OrderedDict, deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..distributed.fault_tolerance.injection import ServingFaultPlan
from .adapters import AdapterConfig, AdapterPool
from .grammar import GrammarTable
from .kv_cache import CacheContext, KVCache
from .metrics import ServingMetrics
from .programs import StepPrograms
from .sampling import DeviceSampler, SamplingParams
from .sanitize import SyncSanitizer
from .spec_decode import SpecConfig, SpecState
from .tracing import NULL_TRACER, FlightRecorder, RequestTracer

__all__ = ["Engine", "Request", "SamplingParams", "SpecConfig", "QueueFull",
           "ShedReject", "EngineStopped", "PRIORITY_LOW", "PRIORITY_NORMAL",
           "PRIORITY_HIGH"]

_engine_counter = itertools.count()

#: States a request never leaves.
TERMINAL_STATES = frozenset({"finished", "failed", "cancelled", "rejected"})

#: Priority classes (any int works; higher serves first).
PRIORITY_LOW, PRIORITY_NORMAL, PRIORITY_HIGH = 0, 1, 2

_PRIORITY_NAMES = {"low": PRIORITY_LOW, "normal": PRIORITY_NORMAL,
                   "high": PRIORITY_HIGH}


def _as_priority(priority) -> int:
    """Normalize a priority class: ``"low"|"normal"|"high"`` or any int
    (higher = served first)."""
    if isinstance(priority, str):
        try:
            return _PRIORITY_NAMES[priority.lower()]
        except KeyError:
            raise ValueError(
                f"unknown priority {priority!r}; want one of "
                f"{sorted(_PRIORITY_NAMES)} or an int") from None
    return int(priority)


def _resolve_weights(state_or_path):
    """Normalize ``update_weights`` input to a flat state dict: a dict
    passes through and an ``.npz`` path loads its arrays.  A directory
    (a ``distributed.checkpoint`` of the JAX package) raises: that
    format's reader is not ported."""
    if isinstance(state_or_path, dict):
        return state_or_path
    if isinstance(state_or_path, (str, os.PathLike)):
        p = os.fspath(state_or_path)
        if os.path.isdir(p):
            raise NotImplementedError(
                f"update_weights: {p!r} is a directory; the "
                "distributed.checkpoint format is not ported (ROADMAP.md "
                "A.5): pass a state dict or an .npz path")
        if p.endswith(".npz"):
            with np.load(p) as z:
                return {k: z[k] for k in z.files}
        raise ValueError(f"update_weights: {p!r} is not an .npz file")
    raise TypeError("update_weights wants a state dict or an .npz path, "
                    f"got {type(state_or_path).__name__}")


@torch.no_grad()
def _write_state_dict(model: nn.Module, sd) -> None:
    """Write ``sd`` (the names and layouts of ``model.state_dict()``;
    torch tensors on any device or numpy arrays) into ``model``'s
    existing tensors, in place.  Every check runs before the first write:
    the names must cover the model exactly and every shape must match (a
    partial write would serve a mix of two models).  On the card the
    copies run on the current stream, the one the step programs replay
    on, which is synchronised before this returns, so no replay reads a
    half-written weight.  A captured graph reads a parameter at the
    address it had at capture: if any tensor moved, this raises."""
    targets = model.state_dict(keep_vars=True)
    missing = sorted(set(targets) - set(sd))
    unexpected = sorted(set(sd) - set(targets))
    if missing or unexpected:
        raise ValueError(f"update_weights: state dict does not cover the "
                         f"model "
                         f"(missing={missing[:5]}, "
                         f"unexpected={unexpected[:5]})")
    for name, t in targets.items():
        shape = tuple(np.shape(sd[name]))
        if shape != tuple(t.shape):
            raise ValueError(f"update_weights: {name} has shape {shape}, "
                             f"the model {tuple(t.shape)}")
    before = {name: t.data_ptr() for name, t in targets.items()}
    device = next(iter(targets.values())).device
    for name, t in targets.items():
        src = sd[name]
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.array(src))     # a writable copy
        t.copy_(src)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    moved = [name for name, t in model.state_dict(keep_vars=True).items()
             if t.data_ptr() != before.get(name)]
    if moved:
        raise RuntimeError(f"update_weights: {moved[:5]} moved in memory; "
                           f"the step programs' graphs still read the old "
                           f"address")


class QueueFull(RuntimeError):
    """Admission rejected by backpressure: the request queue is at
    ``max_queue`` (and, under the ``block`` policy, stayed full past the
    block timeout).  Carries the observed ``depth`` and the engine's
    estimated ``retry_after_s`` (also on the rejected handle's
    ``Request.error_ctx``)."""

    def __init__(self, msg: str, depth: int,
                 retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.depth = depth
        self.retry_after_s = retry_after_s


class ShedReject(QueueFull):
    """SLO-aware admission shed: the request carries a wall-clock
    deadline its estimated queue wait already exceeds, so prefilling it
    would spend a prefill on work doomed to miss its SLO.  A subclass of
    :class:`QueueFull`, so backpressure-aware callers handle both alike;
    ``retry_after_s`` says when the backlog is expected to have
    cleared."""


class EngineStopped(RuntimeError):
    """``add_request`` after ``drain()``/``shutdown()`` (or on an
    unhealthy engine): the engine no longer admits work."""


@dataclass(eq=False)
class Request:
    """One generation request: ``queued → running → finished | failed |
    cancelled``; a malformed, backpressured or shed request goes straight
    to ``rejected``.  A preempted request goes back to ``queued`` and its
    stream restarts from token 0."""

    prompt_ids: np.ndarray
    max_new_tokens: int = 16
    sampling: SamplingParams = field(default_factory=SamplingParams)
    eos_token_id: Optional[int] = None
    stream_cb: Optional[Callable[[int, "Request"], None]] = None
    request_id: int = -1
    deadline_s: Optional[float] = None   # wall-clock budget from enqueue
    #: priority class; queue order uses the *effective* priority (this
    #: plus the deferral-aging boost), preemption rights the class only
    priority: int = PRIORITY_NORMAL
    state: str = "queued"
    #: set when the scheduler evicted this request for a higher-priority
    #: admission (``preemptions`` counts the evictions)
    preempted: bool = False
    preemptions: int = 0
    #: durable identity in the request journal (``Engine(journal=...)``),
    #: stable across preemption and process crashes
    journal_id: Optional[str] = None
    #: set when this admission is a crash-recovery replay from the
    #: journal (its stream restarted from token 0)
    recovered: bool = False
    #: weight version the engine held when this request was admitted
    model_version: int = 0
    #: tenant label for SLO accounting: the adapter's name, else
    #: ``"grammar:<name>"``, else ``"base"``
    tenant: str = "base"
    #: the adapter version pinned at enqueue (None without an adapter): a
    #: hot swap or unload of that adapter fails the request, and recovery
    #: replays it onto that version only
    adapter_version: Optional[int] = None
    error: Optional[str] = None
    #: machine-readable context of a backpressure or shed rejection
    #: (``{"depth": int, "retry_after_s": float}``)
    error_ctx: Optional[dict] = None
    #: who a failure implicates: ``"request"`` (its own prompt, callback
    #: or deadline) or ``"replica"`` (the engine's step or lifecycle)
    error_kind: str = "request"
    slot: Optional[int] = None
    output_ids: List[int] = field(default_factory=list)
    prefill_bucket: int = 0
    t_enqueue: float = 0.0
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    _seq_len: int = 0                # prompt + emitted tokens in the cache
    _defers: int = 0                 # paged admissions deferred so far
    _cancel: bool = False
    _engine: Optional[object] = field(default=None, repr=False)

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

    def cancel(self) -> bool:
        """Ask the engine to stop this request: honoured at once while
        queued; a running request is retired ``cancelled`` at the next
        step boundary (before its next decode).  False if the request is
        already terminal."""
        if self.done:
            return False
        self._cancel = True
        eng = self._engine() if self._engine is not None else None
        if eng is not None:
            eng._on_cancel(self)
        elif self.state == "queued":
            self.state = "cancelled"
        return True


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
        name: the engine's label in its metrics and traces.
        max_queue: bound on queued (not yet admitted) requests; ``None``
            (default) is unbounded.
        queue_policy: what a full queue does to :meth:`add_request`:
            ``"reject"`` raises :class:`QueueFull` at once; ``"block"``
            drives :meth:`step` until space frees or ``block_timeout_s``
            passes (then raises :class:`QueueFull`).
        block_timeout_s: default wait budget of the ``block`` policy.
        default_deadline_s: wall-clock deadline of requests that set none
            (``None``: no deadline).
        max_step_retries: how many times a failed prefill or decode
            program call is retried (with exponential backoff) before the
            requests it serves fail.
        retry_backoff_s: backoff before the first retry.
        step_timeout_s: the step watchdog's deadline: a step call whose
            output has not reached the host within it (``startup_factor``
            times it for the first two steps) turns the engine sticky
            ``unhealthy`` (``step`` then raises :class:`EngineStopped`).
            ``None`` starts no watchdog.
        fault_plan: a :class:`~..distributed.fault_tolerance.injection.
            ServingFaultPlan` checked at the engine's fault points;
            default the env-armed plan (``PADDLE_TPU_FT_SERVING_FAULTS``;
            unset arms nothing).
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
        prefix_lookup_timeout_s: a prefix lookup that raises or takes
            longer than this serves as a miss
            (``paging.prefix_lookup_errors``).
        max_preemptions: how many times one request may be evicted for a
            higher-priority admission; past it the request is immune.  0
            turns preemption off.
        priority_aging_s: a queued request's effective priority rises by
            one class per this many seconds of wait, so no class starves
            (``None`` turns aging off).  Aging orders the queue only;
            preemption compares base classes.
        tracer: a :class:`~.tracing.RequestTracer` recording each
            request's span chain; default the env-armed tracer
            (``PADDLE_TPU_TRACE=1``) or the no-op
            :data:`~.tracing.NULL_TRACER`.
        flight_recorder_steps: ring capacity of the always-on
            :class:`~.tracing.FlightRecorder` (one summary per step),
            dumped when the engine turns ``unhealthy``.
        journal: a :class:`~.journal.RequestJournal`: every accepted
            request is journaled (its replay recipe, one token record
            per engine step, its end) so that a fresh process can
            :meth:`recover` it.  ``None`` journals nothing.
        speculation: a :class:`~.spec_decode.SpecConfig`: serve in
            speculative rounds (draft propose, one verify step, acceptance
            on the device).  ``None`` decodes one token a step.
        adapters: an :class:`~.adapters.AdapterConfig` (or its keywords
            as a dict): LoRA adapter lanes hooked into the decoder layers'
            linears; requests pick a loaded adapter by
            ``SamplingParams.adapter``.  ``None`` adds no hook.
        grammars: a dict of grammar name to spec
            (:class:`~.grammar.JsonArrayGrammar`), stacked into a
            :class:`~.grammar.GrammarTable` at the model's vocabulary on
            its device: constrained decoding;
            requests pick one by ``SamplingParams.grammar``.  ``None``
            adds no grammar lane.
        model_version: the weight version this engine starts at (a
            fleet's replica rebuilt after a rolling update joins at the
            fleet's version).
        mesh: a serving mesh (:func:`~.sharding.serving_mesh`): serve
            tensor-parallel on its ranks, each rank running this engine on
            its shard (a whole model is cut into the rank's shard,
            :meth:`~.sharding.ServingShard.place_model`; on a mesh of one
            it shares the model's tensors).  ``None`` serves on one
            device with no collective.

    ``PADDLE_TPU_SANITIZE=1|strict`` arms the sync sanitizer
    (``self.sanitizer``, :class:`~.sanitize.SyncSanitizer`) at
    construction, speculating or not.

    Engines on one card share their graphs' merge tickets (see
    :mod:`.programs`): two of them may serve from two threads only on one
    stream; a step program called on another stream while another
    engine's is still running raises ``RuntimeError``.  A fleet steps its
    replicas in turn and never meets it.
    """

    def __init__(self, model: nn.Module, *, num_slots: int = 4,
                 max_seq: Optional[int] = None, min_bucket: int = 8,
                 cache_dtype: Optional[torch.dtype] = None,
                 name: Optional[str] = None,
                 max_queue: Optional[int] = None,
                 queue_policy: str = "reject",
                 block_timeout_s: float = 30.0,
                 default_deadline_s: Optional[float] = None,
                 max_step_retries: int = 1,
                 retry_backoff_s: float = 0.05,
                 step_timeout_s: Optional[float] = None,
                 fault_plan=None,
                 kv_layout: str = "contiguous",
                 kernel: str = "auto", block_size: int = 16,
                 num_kv_blocks: Optional[int] = None,
                 enable_prefix_cache: bool = True,
                 prefix_lookup_timeout_s: float = 0.25,
                 max_preemptions: int = 2,
                 priority_aging_s: Optional[float] = 5.0,
                 tracer=None,
                 flight_recorder_steps: int = 256,
                 journal=None,
                 speculation: Optional[SpecConfig] = None,
                 adapters=None, grammars=None, model_version: int = 0,
                 mesh=None):
        cfg = getattr(model, "config", None)
        if cfg is None:
            raise TypeError("Engine needs a model carrying a .config "
                            "(GPTForCausalLM, LlamaForCausalLM)")
        kv_heads = getattr(cfg, "n_kv_heads", None) or \
            cfg.num_attention_heads
        #: the model as the caller gave it (a self-speculating draft names
        #: it), held weakly
        self._source_ref = weakref.ref(model)
        #: the engine's sharding (None: one device)
        self.shard = None
        if mesh is not None:
            from .sharding import ServingShard

            self.shard = ServingShard(mesh, kv_heads=kv_heads,
                                      num_heads=cfg.num_attention_heads)
            model = self.shard.place_model(model)
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
        if queue_policy not in ("reject", "block"):
            raise ValueError(f"queue_policy must be 'reject' or 'block', "
                             f"got {queue_policy!r}")
        if max_queue is not None and int(max_queue) < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_step_retries < 0:
            raise ValueError("max_step_retries must be >= 0")
        if step_timeout_s is not None and step_timeout_s <= 0:
            raise ValueError("step_timeout_s must be > 0")
        if max_preemptions < 0:
            raise ValueError("max_preemptions must be >= 0")
        if priority_aging_s is not None and priority_aging_s <= 0:
            raise ValueError("priority_aging_s must be > 0 (or None to "
                             "disable aging)")
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
        if self.shard is not None:
            if self.shard.device_type != self.device.type:
                raise ValueError(
                    f"the mesh is on {self.shard.device_type!r}, the model "
                    f"on {self.device.type!r}")
            # the rank's whole kv heads
            kv_heads = self.shard.local_heads(kv_heads)
        self.prefix_cache = None
        self.prefix_lookup_timeout_s = float(prefix_lookup_timeout_s)
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
            # a speculative window runs up to k positions past max_seq:
            # the headroom takes those writes (the paged pool sends them
            # to its scratch block)
            self.cache = KVCache(self.num_slots, cfg.num_hidden_layers,
                                 self.max_seq, kv_heads, cfg.head_dim,
                                 cache_dtype, device=self.device,
                                 headroom=(0 if speculation is None
                                           else int(speculation.k)))
        self.name = name or f"engine-{next(_engine_counter)}"
        self.metrics = ServingMetrics(self.name, num_slots=self.num_slots)
        # constrained decoding: the grammars' stacked tables, which the
        # sampler masks with inside the steps; None adds no lane
        self.grammar_table: Optional[GrammarTable] = None
        if grammars is not None:
            self.grammar_table = GrammarTable(cfg.vocab_size, grammars,
                                              device=self.device)
        self.sampler = DeviceSampler(self.num_slots, device=self.device,
                                     grammar=self.grammar_table)
        # multi-LoRA: the adapter lanes and the per-slot id lane, hooked
        # into the decoder layers' linears; None adds no hook
        self.adapter_pool: Optional[AdapterPool] = None
        if adapters is not None:
            acfg = (adapters if isinstance(adapters, AdapterConfig)
                    else AdapterConfig(**dict(adapters)))
            self.adapter_pool = AdapterPool(
                self.model, self.num_slots, max_adapters=acfg.max_adapters,
                rank=acfg.rank)
        self.programs = StepPrograms(self.device, self.metrics.on_compile)
        self._warm_misses: Optional[int] = None
        self.queue: deque = deque()
        self.running: Dict[int, Request] = {}
        self.free_slots: List[int] = list(range(self.num_slots))
        self._req_counter = itertools.count()
        self._step_counter = 0
        self._consecutive_failures = 0
        self.max_queue = None if max_queue is None else int(max_queue)
        self.queue_policy = queue_policy
        self.block_timeout_s = float(block_timeout_s)
        self.default_deadline_s = default_deadline_s
        self.max_step_retries = int(max_step_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.step_timeout_s = step_timeout_s
        # the watchdog thread starts at the first armed step; _armed says
        # whether its heartbeat runs now (a step call until its read)
        self._watchdog = None
        self._arm_counter = 0
        self._armed = False
        if fault_plan is None:
            fault_plan = ServingFaultPlan.from_env()
        self.fault_plan = fault_plan
        # the sync sanitizer (PADDLE_TPU_SANITIZE=1|strict); None costs
        # nothing
        self.sanitizer = SyncSanitizer.from_env()
        self.max_preemptions = int(max_preemptions)
        self.priority_aging_s = None if priority_aging_s is None \
            else float(priority_aging_s)
        if tracer is None:
            tracer = RequestTracer.from_env() or NULL_TRACER
        self.tracer = tracer
        self.flight = FlightRecorder(flight_recorder_steps, name=self.name)
        # the request journal: None journals nothing and costs nothing;
        # its writes are host file I/O between programs
        self.journal = journal
        #: weight version this engine serves (``update_weights`` bumps
        #: it; each request records the version that served it)
        self.model_version = int(model_version)
        #: the mesh-shape key ("model=2") journaled per admission and
        #: checked by recover(); None for an unsharded engine
        self.mesh_shape: Optional[str] = \
            None if self.shard is None else self.shard.key
        #: ranks this engine lost (the ``serving.shard_fail`` point): the
        #: fleet's degraded rebuild leaves them out
        self.lost_devices: List[int] = []
        # the decision exchange's values (a mesh of more than one rank):
        # rank 0's clock reading and mean inter-token latency
        self._agreed_now: Optional[float] = None
        self._agreed_itl: Optional[float] = None
        self.state = "active"    # active | draining | stopped | unhealthy
        self._unhealthy_reason: Optional[str] = None
        # speculative decoding: the draft, its cache, sampler and
        # proposals lane; None keeps the one-token decode step
        self.spec: Optional[SpecState] = None
        if speculation is not None:
            self.spec = SpecState(self, speculation)
            self.metrics.spec_cb = self.spec.snapshot

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
        pool = self.adapter_pool
        if pool is not None:
            # the slot's adapter lane: a [1] row id read on the device
            pool.set_rows(pool.adapter_ids.index_select(0, slot.long()))
        try:
            logits = self.model(ids, cache_ctx=ctx)
        finally:
            if pool is not None:
                pool.clear_rows()
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
        pool = self.adapter_pool
        if pool is not None:
            pool.set_rows(pool.adapter_ids)      # every slot's lane at once
        try:
            logits = self.model(tokens, cache_ctx=CacheContext(self.cache,
                                                               "decode"))
        finally:
            if pool is not None:
                pool.clear_rows()
        self.cache.advance(active)
        return self.sampler.sample_all(logits[:, -1, :].float(), active)

    def _restore_lanes(self) -> None:
        """Rewrite the ``[slots]`` lanes a decode writes in place as the
        last successful step left them, from the host's bookkeeping: a
        running slot's length is its request's ``_seq_len``, its token
        the request's last emitted token (the next decode's input), its
        draw counter the number of tokens it emitted (one draw each) and,
        with grammars, its automaton state the host's walk of its grammar
        over those tokens; an idle slot's are 0.  Whether the failed call
        ran or not, the retry then writes the same K/V rows at the same
        positions and draws at the same counters from the same states.
        Host-to-device copies only, on the retry path alone."""
        n = self.num_slots
        lengths = np.zeros(n, dtype=np.int32)
        tokens = np.zeros(n, dtype=np.int32)
        counters = np.zeros(n, dtype=np.int64)
        states = np.zeros(n, dtype=np.int32)
        gt = self.grammar_table
        for slot, req in self.running.items():
            lengths[slot] = req._seq_len
            tokens[slot] = req.output_ids[-1]
            counters[slot] = len(req.output_ids)
            if gt is not None:
                states[slot] = gt.walk(gt.gid_of(req.sampling.grammar),
                                       req.output_ids)
        lanes = [(self.cache.lengths, lengths),
                 (self.sampler.tokens, tokens),
                 (self.sampler.counters, counters)]
        if gt is not None:
            lanes.append((self.sampler.grammar_states, states))
        for lane, values in lanes:
            src = torch.from_numpy(values)
            if lane.is_cuda:
                src = src.pin_memory()
            lane.copy_(src, non_blocking=True)
        if self.spec is not None:
            # a round's retry: the draft's lanes are the target's at the
            # round's start
            self.spec.restore_lanes()

    def _program(self, key, body, *inputs) -> torch.Tensor:
        """Run step program ``key`` (:meth:`StepPrograms.run`); its first
        call, which builds it, runs under :meth:`_building`."""
        if key in self.programs:
            return self.programs.run(key, body, *inputs)
        with self._building():
            return self.programs.run(key, body, *inputs)

    def _run_prefill(self, ids: np.ndarray, slot: int, length: int,
                     start: int = 0) -> torch.Tensor:
        """The prefill program of ``ids``'s bucket on this admission."""
        meta = np.array([slot, length, start], dtype=np.int32)
        return self._program(("prefill", ids.shape[1]), self._prefill_step,
                             ids, meta)

    def _run_decode(self, active: np.ndarray) -> torch.Tensor:
        return self._program(("decode",), self._decode_step, active)

    def _run_draft_prefill(self, ids: np.ndarray, slot: int,
                           length: int) -> torch.Tensor:
        """The draft prefill program of ``ids``'s bucket."""
        meta = np.array([slot, length], dtype=np.int32)
        return self._program(("draft_prefill", ids.shape[1]),
                             self.spec.draft_prefill, ids, meta)

    def _run_draft_decode(self, active: np.ndarray, j: int) -> torch.Tensor:
        return self._program(("draft_decode",), self.spec.draft_decode,
                             active, np.array([j], dtype=np.int32))

    def _run_verify(self, active: np.ndarray,
                    cap: np.ndarray) -> torch.Tensor:
        return self._program(("verify",), self.spec.verify, active, cap)

    # -- resilience plumbing -------------------------------------------------

    def _fault(self, point: str) -> None:
        if self.fault_plan is not None and self.fault_plan.armed:
            self.fault_plan.check(point)

    # -- one decision stream across a mesh's ranks --------------------------

    @property
    def source_model(self) -> Optional[nn.Module]:
        return self._source_ref()

    def model_parallel(self) -> int:
        """The engine's model-parallel degree (1 without a mesh)."""
        return 1 if self.shard is None else self.shard.mp

    def _exchanging(self) -> bool:
        return self.shard is not None and self.shard.mp > 1

    def _clock(self) -> float:
        """The time a scheduling decision reads: the clock, or on a mesh of
        more than one rank rank 0's reading at the last exchange."""
        if self._agreed_now is None:
            return time.perf_counter()
        return self._agreed_now

    def _local_itl(self) -> Optional[float]:
        itl = self.metrics.itl_s
        return sum(itl) / len(itl) if itl else None

    def _itl_mean(self) -> Optional[float]:
        """The mean inter-token latency shedding prices a wait at (rank
        0's on a mesh of more than one rank); None before any decode."""
        return self._agreed_itl if self._exchanging() else self._local_itl()

    def _digest(self) -> int:
        """The scheduling state every rank must share: the step count, the
        running slots with their requests and token counts, the queue and
        the free slots."""
        state = (self._step_counter,
                 sorted((s, r.request_id, len(r.output_ids))
                        for s, r in self.running.items()),
                 [q.request_id for q in self.queue],
                 sorted(self.free_slots))
        return zlib.crc32(repr(state).encode())

    def _exchange(self) -> None:
        """The decision exchange of a mesh of more than one rank (no-op
        otherwise): every rank's clock, mean inter-token latency, state and
        scheduling digest are gathered; decisions then read rank 0's clock
        and latency, a rank turned unhealthy (its watchdog fired) turns
        every rank unhealthy, and differing digests raise: the ranks would
        issue different collectives."""
        if not self._exchanging():
            return
        frames = self.shard.agree({
            "now": time.perf_counter(), "itl": self._local_itl(),
            "state": self.state, "reason": self._unhealthy_reason,
            "digest": self._digest()})
        digests = [f["digest"] for f in frames]
        if len(set(digests)) > 1:
            raise RuntimeError(
                f"engine {self.name!r}: the ranks {self.shard.ranks} of mesh "
                f"{self.mesh_shape} diverged (scheduling digests {digests})")
        self._agreed_now = frames[0]["now"]
        self._agreed_itl = frames[0]["itl"]
        for f in frames:
            if f["state"] == "unhealthy" and self.state != "unhealthy":
                self.state = "unhealthy"
                self._unhealthy_reason = f["reason"]
                self.flight.dump(self._unhealthy_reason)

    def _any_rank(self, flag: bool) -> bool:
        """``flag`` on any rank of the mesh (the flag itself without an
        exchange)."""
        if not self._exchanging():
            return bool(flag)
        return any(self.shard.agree(bool(flag)))

    def _mark_shard_lost(self, reason) -> None:
        """Device loss on a sharded engine (the ``serving.shard_fail``
        point): the mesh's highest rank is lost, recorded in
        ``lost_devices`` for the fleet's degraded rebuild, and the engine
        turns sticky ``unhealthy`` as a wedged one does."""
        lost = self.shard.ranks[-1]
        self.lost_devices = [lost]
        self._unhealthy_reason = (
            f"shard failure: lost rank {lost} of mesh "
            f"{self.mesh_shape!r} ({reason})")
        self.state = "unhealthy"
        self.flight.dump(self._unhealthy_reason)
        self.tracer.on_unhealthy(self.name, self._unhealthy_reason)

    def _mark_wedged(self) -> None:
        """The watchdog fired (on its own thread, while this engine's
        thread is stalled in a step or blocked in the read of its output):
        the engine turns sticky ``unhealthy``, freezes its flight ring and
        tells the tracer.  Host work only: nothing here touches the
        device, which may be the thing that is stalled."""
        if self.state != "unhealthy":
            self._unhealthy_reason = (
                f"step watchdog fired: no step completion within "
                f"{self.step_timeout_s}s (stacks dumped to stderr)")
            self.state = "unhealthy"
            self.flight.dump(self._unhealthy_reason)
            self.tracer.on_unhealthy(self.name, self._unhealthy_reason)

    def _arm_watchdog(self) -> None:
        """Start the heartbeat of one step call (a new boundary); the
        watchdog thread starts at the first."""
        if self.step_timeout_s is None:
            return
        if self._watchdog is None:
            from ..distributed.fault_tolerance.watchdog import StepWatchdog

            # the thread must not pin the engine (model, KV cache,
            # graphs): its callbacks reach it through a weakref, and a
            # collected engine's thread is told to exit (Event.set is
            # safe in a finalizer; joining is not)
            wref = weakref.ref(self)

            def _on_timeout():
                eng = wref()
                if eng is not None:
                    eng._mark_wedged()

            def _last_program():
                eng = wref()
                return None if eng is None else eng.programs.last_key

            self._watchdog = StepWatchdog(
                self.step_timeout_s, hard_exit=False,
                on_timeout=_on_timeout, last_op=_last_program)
            self._watchdog.start()
            weakref.finalize(self, self._watchdog.request_stop)
        self._arm_counter += 1
        self._watchdog.notify(self._arm_counter)
        self._armed = True

    def _disarm_watchdog(self) -> None:
        """End the heartbeat: the step's output has reached the host (or
        the call failed)."""
        if self._watchdog is not None:
            self._watchdog.pause()
        self._armed = False

    def _stop_watchdog(self) -> None:
        """Join and drop the watchdog thread, so that a stopped engine
        holds no thread (nor, through it, its graphs)."""
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        self._armed = False

    @contextmanager
    def _building(self):
        """A program's build (its kernels' compile at their first use, its
        graph's capture) is not a step: an armed heartbeat pauses over it
        and restarts after."""
        armed = self._armed
        if armed:
            self._watchdog.pause()
        try:
            yield
        finally:
            if armed:
                self._watchdog.notify(self._arm_counter)

    def _step_call(self, point: str, call: Callable[[], torch.Tensor],
                   undo: Callable[[], None], *,
                   check: bool = True) -> torch.Tensor:
        """One step program call (``call``) with the watchdog armed, the
        fault plan's ``point`` checked before it (unless ``check`` is
        False: a round's ``call`` checks its own points), and a bounded
        retry.
        A program writes its state in place while it runs, so a failed
        call may have moved it (if it failed after its replay was
        enqueued) or not (if it failed before, an injected fault
        included): ``undo`` rewrites that state as the failed call found
        it, which is right either way, before the next attempt.  Adds no
        device-to-host sync.  Returns with the watchdog still armed: a
        replay returns before the device has run it, so the caller
        disarms once it has read the output (:meth:`_disarm_watchdog`).
        Raises the last error, disarmed, once ``max_step_retries``
        retries failed."""
        last_err = None
        for attempt in range(self.max_step_retries + 1):
            if attempt:
                self.metrics.on_retry(point)
                time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))
                undo()
            try:
                self._arm_watchdog()
                if check:
                    self._fault(point)
                out = call()
            except Exception as e:       # noqa: BLE001 — isolated upstream
                self._disarm_watchdog()
                last_err = e
                self._consecutive_failures += 1
                self.metrics.on_step_failure(point)
                continue
            self._consecutive_failures = 0
            return out
        raise last_err

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
        if req.deadline_s is not None and req.deadline_s <= 0:
            return f"deadline_s must be > 0, got {req.deadline_s}"
        if self.kv_layout == "paged":
            # worst case (no prefix hit) the prompt prefills a whole bucket
            # of fresh blocks: a prompt the pool can never hold is
            # rejected here instead of deferring forever
            bucket = self.bucket_for(req.prompt_ids.size)
            need = bucket // self.block_size
            usable = self.cache.num_blocks - self.cache.allocator.reserved
            if need > usable:
                return (f"prompt needs {need} KV blocks (bucket {bucket}, "
                        f"block_size {self.block_size}) but the pool "
                        f"holds {usable}")
        s = req.sampling
        if s.adapter is not None:
            if self.adapter_pool is None:
                return (f"sampling.adapter={s.adapter!r} but this engine "
                        "has no adapter pool (Engine(adapters=...))")
            try:
                self.adapter_pool.resolve(s.adapter)
            except KeyError as e:
                return e.args[0]
        if s.grammar is not None:
            if self.grammar_table is None:
                return (f"sampling.grammar={s.grammar!r} but this engine "
                        "has no grammar table (Engine(grammars=...))")
            try:
                spec = self.grammar_table.spec_of(s.grammar)
            except KeyError as e:
                return e.args[0]
            g_eos = getattr(spec, "eos_token_id", None)
            if (g_eos is not None and req.eos_token_id is not None
                    and req.eos_token_id != g_eos):
                return (f"grammar {s.grammar!r} terminates on eos token "
                        f"{g_eos} but the request sets "
                        f"eos_token_id={req.eos_token_id}")
        return None

    def _reject(self, req: Request, reason: str) -> None:
        req.state, req.error = "rejected", reason
        req.t_finish = time.perf_counter()
        self.metrics.on_reject()
        self.tracer.on_retired(req, self.name, "rejected", reason)

    @staticmethod
    def _seed_for(req: Request) -> int:
        """The request's sampling seed (the JAX engine's formula): staged
        into the slot's lanes at every admission, first and resumed
        alike, so a seeded stream replays the same."""
        return (req.sampling.seed if req.sampling.seed is not None
                else (req.request_id + 1) * 7919)

    def add_request(self, prompt_ids: Sequence[int], *,
                    max_new_tokens: int = 16,
                    sampling: Optional[SamplingParams] = None,
                    temperature: Optional[float] = None,
                    eos_token_id: Optional[int] = None,
                    stream_cb: Optional[Callable] = None,
                    deadline_s: Optional[float] = None,
                    block_timeout_s: Optional[float] = None,
                    priority=PRIORITY_NORMAL) -> Request:
        """Enqueue a prompt; a later :meth:`step` admits it into a slot.

        A malformed request is marked ``rejected`` and raises
        ``ValueError``; a full queue raises :class:`QueueFull` under the
        ``reject`` policy or first drives :meth:`step` for up to
        ``block_timeout_s`` under ``block``; a request whose estimated
        queue wait already exceeds its ``deadline_s`` (default: the
        engine's ``default_deadline_s``) is shed (:class:`ShedReject`).
        The rejected handle rides on the exception's ``.request``.
        ``priority`` is ``"low"|"normal"|"high"`` or any int; higher
        serves first and may preempt strictly lower.  A stopped, draining
        or unhealthy engine raises :class:`EngineStopped`.  With a
        journal, the admission record is written before the request is
        queued; if that write fails the request is rejected and the
        storage error raised."""
        prio = _as_priority(priority)
        self._exchange()
        if self.state != "active":
            raise EngineStopped(
                f"engine {self.name!r} is {self.state}: not admitting "
                "new requests")
        prompt = np.asarray(list(prompt_ids), dtype=np.int64).reshape(-1)
        if sampling is None:
            sampling = SamplingParams(temperature=temperature or 0.0)
        req = Request(prompt_ids=prompt, max_new_tokens=int(max_new_tokens),
                      sampling=sampling, eos_token_id=eos_token_id,
                      stream_cb=stream_cb,
                      deadline_s=(deadline_s if deadline_s is not None
                                  else self.default_deadline_s),
                      priority=prio, request_id=next(self._req_counter))
        # the tenant label (adapter, else grammar, else base)
        req.tenant = (sampling.adapter if sampling.adapter is not None
                      else (f"grammar:{sampling.grammar}"
                            if sampling.grammar is not None else "base"))
        if (sampling.grammar is not None and req.eos_token_id is None
                and self.grammar_table is not None):
            # a grammar ends on its own eos token: the request's stop
            # condition defaults to it (a mismatch is rejected in
            # _validate)
            try:
                spec = self.grammar_table.spec_of(sampling.grammar)
                req.eos_token_id = getattr(spec, "eos_token_id", None)
            except KeyError:
                pass                     # an unknown grammar: _validate
        req.t_enqueue = self._clock()
        origin_wall = None
        jr = self.journal
        if jr is not None:
            # the durable identity, taken before the admission checks: a
            # recovery replay arrives with an adopted id and the
            # recovered flag, which exempts it from shedding (it was
            # accepted once already, before the crash); otherwise the id
            # is this engine's, made unique across restarts by the
            # journal's boot marker
            pend = jr.take_pending()
            if pend is not None:
                req.journal_id, req.recovered, origin_wall = pend
            else:
                req.journal_id = \
                    f"{self.name}:b{jr.boot}:r{req.request_id}"
        problem = self._validate(req)
        if problem is not None:
            self._reject(req, problem)
            err = ValueError(problem)
            err.request = req
            raise err
        if sampling.adapter is not None:
            # the adapter version is pinned at enqueue: a hot swap or an
            # unload of this name fails the request, and a recovery
            # replays it onto this version only
            req.adapter_version = self.adapter_pool.resolve(
                sampling.adapter)[1]
        wait = None if req.recovered else self._shed_wait_s(req)
        if wait is not None:
            depth = len(self.queue)
            msg = (f"shed: estimated queue wait {wait:.3f}s exceeds "
                   f"deadline {req.deadline_s}s (depth={depth}, "
                   f"retry_after_s={wait:.3f})")
            req.error_ctx = {"depth": depth,
                             "retry_after_s": round(wait, 3)}
            self.metrics.on_shed()
            self.tracer.on_shed(req, self.name, wait)
            self._reject(req, msg)
            err = ShedReject(msg, depth, retry_after_s=round(wait, 3))
            err.request = req
            raise err
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            if self.queue_policy == "block":
                budget = self.block_timeout_s if block_timeout_s is None \
                    else float(block_timeout_s)
                t_end = self._clock() + budget
                while len(self.queue) >= self.max_queue:
                    if self._clock() >= t_end:
                        break
                    self.step()
            if len(self.queue) >= self.max_queue:
                depth = len(self.queue)
                retry = round(self.estimate_queue_wait_s(req.priority), 3)
                msg = (f"queue full: {depth} >= max_queue={self.max_queue} "
                       f"(policy={self.queue_policy}, "
                       f"retry_after_s={retry})")
                req.error_ctx = {"depth": depth, "retry_after_s": retry}
                self._reject(req, msg)
                err = QueueFull(msg, depth, retry_after_s=retry)
                err.request = req
                raise err
        req._engine = weakref.ref(self)
        if jr is not None:
            # write-ahead: the admission record commits before the
            # request is queued.  A failing write must not leave the
            # engine serving a request its caller was told failed
            s = req.sampling
            samp = {"temperature": s.temperature, "top_k": s.top_k,
                    "top_p": s.top_p, "seed": s.seed}
            # the tenancy keys go in only when set: a base request's
            # record is as it was before tenancy, and as the JAX engine's
            if s.adapter is not None:
                samp["adapter"] = s.adapter
            if s.grammar is not None:
                samp["grammar"] = s.grammar
            try:
                jr.record_admission(
                    req.journal_id, prompt_ids=req.prompt_ids,
                    sampling=samp, seed_effective=self._seed_for(req),
                    priority=req.priority, deadline_s=req.deadline_s,
                    max_new_tokens=req.max_new_tokens,
                    eos_token_id=req.eos_token_id, engine=self.name,
                    model_version=self.model_version,
                    recovered=req.recovered, mesh_shape=self.mesh_shape,
                    adapter_version=req.adapter_version)
            except Exception as e:       # noqa: BLE001 — storage failure
                req.journal_id = None    # nothing durable to audit
                self._reject(req, f"journal admission write failed: "
                                  f"{type(e).__name__}: {e}")
                try:
                    e.request = req      # the rejection-path convention
                except Exception:        # noqa: BLE001 — exotic exc type
                    pass
                raise
        self.queue.append(req)
        self.metrics.on_enqueue(len(self.queue))
        self.tracer.on_queued(req, self.name)
        if jr is not None and req.recovered:
            self.metrics.on_recovered()
            self.tracer.on_recovered(req, self.name, origin_wall,
                                     journal_id=req.journal_id)
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
        if self.state != "active":
            raise EngineStopped(f"engine {self.name!r} is {self.state}")
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
        idle = np.zeros(self.num_slots, dtype=np.int32)
        if self.spec is None:
            self._run_decode(idle).cpu()
            programs = ["prefill", "decode"]
        else:
            # a round replaces the decode program: the draft's prefill
            # per bucket, its one decode and the verify
            for b in use:
                self._run_draft_prefill(np.zeros((1, b), dtype=np.int64),
                                        0, 1).cpu()
            self._run_draft_decode(idle, 0).cpu()
            self._run_verify(idle, np.ones_like(idle)).cpu()
            self.spec.reset()
            programs = ["prefill", "draft_prefill", "draft_decode",
                        "verify"]
        self.cache.reset()
        self.sampler.reset()
        if self.adapter_pool is not None:
            self.adapter_pool.reset_slots()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm_misses = self.metrics.compile_misses
        return {"buckets": use, "programs": programs,
                "compile_misses": self.metrics.compile_misses}

    # -- deadlines, cancellation ---------------------------------------------

    def _deadline_expired(self, req: Request, now: float) -> bool:
        return req.deadline_s is not None and \
            (now - req.t_enqueue) > req.deadline_s

    def _fail_deadline(self, req: Request) -> None:
        self.metrics.on_deadline()
        self._retire(req, "failed",
                     error=f"deadline of {req.deadline_s}s exceeded")

    def _on_cancel(self, req: Request) -> None:
        """A queued request leaves at once; a running one is retired at
        the next step boundary, between programs."""
        if req.state != "queued":
            return
        try:
            self.queue.remove(req)
        except ValueError:
            # already claimed by the scheduler (popped for admission):
            # leave the flag, which _admit honours
            return
        self._retire(req, "cancelled")
        self.metrics.queue_depth = len(self.queue)

    def _reap(self, now: float) -> None:
        """Honour cancellations and deadlines before this step's
        admissions, for queued and running requests alike."""
        for req in list(self.queue):
            if not (req.done or req._cancel
                    or self._deadline_expired(req, now)):
                continue
            self.queue.remove(req)
            if req.done:
                continue
            if req._cancel:
                self._retire(req, "cancelled")
            else:
                self._fail_deadline(req)
        for req in list(self.running.values()):
            if req._cancel:
                self._retire(req, "cancelled")
            elif self._deadline_expired(req, now):
                self._fail_deadline(req)
        self.metrics.queue_depth = len(self.queue)

    # -- overload: priorities, preemption, shedding ------------------------

    def _effective_priority(self, req: Request, now: float) -> int:
        """Base class plus the deferral-aging boost (+1 class per
        ``priority_aging_s`` of queue wait): sustained higher-priority
        arrivals cannot hold a waiting request back forever."""
        if self.priority_aging_s is None:
            return req.priority
        return req.priority + int(
            max(0.0, now - req.t_enqueue) / self.priority_aging_s)

    def _best_queued_index(self, now: float) -> Optional[int]:
        """Index of the next request to admit: highest effective
        priority, FIFO within a class (the first maximum wins)."""
        best_i, best_eff = None, None
        for i, q in enumerate(self.queue):
            eff = self._effective_priority(q, now)
            if best_eff is None or eff > best_eff:
                best_i, best_eff = i, eff
        return best_i

    def _best_preempting_candidate(self, now: float):
        """With every slot busy, the queued request that should preempt:
        the highest effective priority among those a victim exists for.
        The effective head may hold no preemption rights (aging grants
        queue position, never eviction); it keeps its place for the next
        retirement while the entitled request evicts past it.  Returns
        ``(index, request, victim)`` or ``(None, None, None)``."""
        best, best_eff = (None, None, None), None
        for i, q in enumerate(self.queue):
            if q.done:
                continue
            eff = self._effective_priority(q, now)
            if best_eff is not None and eff <= best_eff:
                continue
            victim = self._pick_victim(q)
            if victim is not None:
                best, best_eff = (i, q, victim), eff
        return best

    def estimate_queue_wait_s(self,
                              priority: int = PRIORITY_NORMAL) -> float:
        """Estimated wall-clock wait before a fresh request of
        ``priority`` reaches a slot: the running requests' remaining
        token budgets plus the budgets of queued requests at >= its
        effective priority, priced at the measured mean inter-token
        latency and spread over the decode batch width.  A cold engine
        (no decode measured yet) estimates 0.0, so admission never sheds
        on a guess, and so does a request the free slots can take now."""
        itl = self._itl_mean()
        if itl is None:
            return 0.0
        now = self._clock()
        queued_ahead = [q for q in self.queue
                        if self._effective_priority(q, now) >= int(priority)]
        if len(queued_ahead) < len(self.free_slots):
            return 0.0
        tokens = sum(max(0, r.max_new_tokens - len(r.output_ids))
                     for r in self.running.values())
        tokens += sum(q.max_new_tokens for q in queued_ahead)
        return tokens * itl / max(self.num_slots, 1)

    def _shed_wait_s(self, req: Request) -> Optional[float]:
        """The estimated queue wait when it already exceeds the request's
        deadline, else None.  Deadline-less requests are never shed.  A
        request that would evict its way into a slot on its first
        scheduling pass does not wait behind the running backlog, so it
        is not shed on it; a queued request contends for that only if it
        could win the preemption pass (effective priority at >= this
        class and a victim of its own)."""
        if req.deadline_s is None:
            return None
        now = self._clock()
        if self._pick_victim(req) is not None and not any(
                not q.done and self._effective_priority(q, now)
                >= req.priority and self._pick_victim(q) is not None
                for q in self.queue):
            return None
        wait = self.estimate_queue_wait_s(req.priority)
        return wait if wait > req.deadline_s else None

    def _pick_victim(self, candidate: Request) -> Optional[Request]:
        """The preemption policy: among running requests of a strictly
        lower base class than the candidate's with eviction budget left,
        the lowest class first, the least progress (fewest emitted
        tokens) next, the youngest last: the least decode work lost."""
        if self.max_preemptions <= 0:
            return None
        cands = [r for r in self.running.values()
                 if r.priority < candidate.priority
                 and r.preemptions < self.max_preemptions]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.priority, len(r.output_ids),
                                         -r.request_id))

    def _preempt(self, victim: Request) -> None:
        """Evict a running request so a higher-priority admission can
        take its slot (or, paged, its blocks).  Not a terminal
        transition: the victim requeues, ``preempted``/``preemptions``
        set and ``output_ids`` reset, and its stream restarts from token
        0 on resume.  The resume is cheap: the victim's whole prompt
        blocks are registered in the prefix cache before its slot
        releases, so its prefill hits them and runs the tail bucket only.
        Its slot's lanes are staged anew at re-admission (``_seed_for``).

        This runs only between programs: the scheduler reads every
        program's output on the host (``int(tok)``, ``out.cpu()``) before
        it decides again, so no replay that reads the victim's table row
        or length is in flight when ``release_slot`` points the row at
        scratch.  The next decode finds the slot inactive."""
        slot = victim.slot
        if self.prefix_cache is not None:
            try:
                self.prefix_cache.register(victim.prompt_ids,
                                           self.cache.owned_blocks(slot),
                                           salt=self._tenant_salt(victim))
            except Exception:            # noqa: BLE001 — isolation boundary
                self.metrics.on_prefix_register_error()
        try:
            self.cache.release_slot(slot)
        except Exception as e:           # noqa: BLE001 — accounting bug
            self._mark_block_corruption(
                f"release_slot({slot}) failed on preemption: "
                f"{type(e).__name__}: {e}")
        if self.spec is not None:
            # the draft's K/V is never resumed: the replay from the prompt
            # prefills it again
            self.spec.release_slot(slot)
        self.running.pop(slot, None)
        if slot not in self.free_slots:
            self.free_slots.append(slot)
        victim.slot = None
        victim.state = "queued"
        victim.preempted = True
        victim.preemptions += 1
        victim.output_ids = []
        victim.t_first_token = None
        victim._seq_len = 0
        victim._defers = 0
        self.queue.append(victim)        # aging runs from its t_enqueue
        self.metrics.on_preempt(len(self.queue))
        self.tracer.on_preempt(victim, self.name)
        if self.journal is not None and victim.journal_id is not None:
            # the journaled stream restarts too: tokens before this
            # record are superseded by the resume's replay from token 0
            self.journal.record_restart(victim.journal_id, "preempt")

    # -- admission ---------------------------------------------------------

    def _tenant_salt(self, req: Request) -> bytes:
        """The prefix-cache salt of ``req``'s adapter (``b""`` for the base
        model): tenant K/V never hits across adapters or versions.  A name
        unloaded since still salts a domain of its own."""
        a = req.sampling.adapter
        if a is None or self.adapter_pool is None:
            return b""
        try:
            return self.adapter_pool.salt(a)
        except KeyError:
            v = self.adapter_pool.last_version(a)
            return f"{a}@v{v}#unloaded".encode()

    def _prefix_lookup(self, req: Request):
        """The longest cached prefix of the prompt, ``(n_tokens,
        block_ids)``.  A lookup that raises, or that returns after
        ``prefix_lookup_timeout_s``, serves as a plain miss: the request
        prefills its whole prompt, no block was referenced (a lookup takes
        no reference), and ``prefix_lookup_errors`` counts it.  The
        hit-rate is recorded by the caller after the partial-hit cap, so a
        discarded result counts as a miss there."""
        if self.prefix_cache is None:
            return 0, []
        t0 = time.perf_counter()
        hit = (0, [])
        try:
            self._fault("serving.prefix_lookup")
            hit = self.prefix_cache.lookup(req.prompt_ids, count=False,
                                           salt=self._tenant_salt(req))
        except Exception:                # noqa: BLE001 — isolation boundary
            failed = True
        else:
            # over budget: a degraded subsystem; its late result is
            # discarded (the lookup is synchronous, its stall is spent)
            failed = time.perf_counter() - t0 > self.prefix_lookup_timeout_s
        # on a mesh, a miss on any rank is a miss on every rank
        if self._any_rank(failed):
            self.metrics.on_prefix_lookup_error()
            return 0, []
        return hit

    def _stage(self, req: Request) -> None:
        """Stage the request's sampling lanes into its slot: its
        parameters, its seed, a zero draw counter and, with grammars, its
        grammar id at state 0."""
        self.sampler.stage_slot(req.slot, req.sampling, self._seed_for(req))

    def _stage_adapter(self, req: Request) -> bool:
        """Write the slot's adapter lane id.  A request whose adapter was
        unloaded, or hot-swapped past its pinned version, since its
        enqueue fails here with ``error_ctx`` (False) instead of decoding
        under other weights."""
        a = req.sampling.adapter
        try:
            if a is not None and req.adapter_version is not None:
                _, v = self.adapter_pool.resolve(a)
                if v != req.adapter_version:
                    raise KeyError(
                        f"adapter {a!r} was hot-swapped to v{v} (request "
                        f"pinned v{req.adapter_version})")
            self.adapter_pool.stage_slot(req.slot, a)
        except KeyError as e:
            req.error_ctx = {
                "adapter": a,
                "version": (req.adapter_version
                            if req.adapter_version is not None
                            else self.adapter_pool.last_version(a))}
            self._retire(req, "failed", error=str(e.args[0]))
            return False
        return True

    def _prefill_call(self, req: Request, ids: np.ndarray, L: int,
                      start: int = 0) -> Optional[torch.Tensor]:
        """One prefill program with the bounded retry.  A retry re-stages
        the slot's lanes (the failed call may have drawn the first token
        and moved the counter); its K/V rows and absolute length are
        written again the same.  Exhausted retries retire ``req`` failed
        and return None."""
        try:
            return self._step_call(
                "serving.prefill",
                lambda: self._run_prefill(ids, req.slot, L, start),
                lambda: self._stage(req))
        except Exception as e:           # noqa: BLE001 — isolation boundary
            n = self.max_step_retries
            self._retire(req, "failed",
                         error=f"prefill failed after {n} "
                               f"retr{'y' if n == 1 else 'ies'}: "
                               f"{type(e).__name__}: {e}",
                         kind="replica")
            return None

    def _paged_prefill(self, req: Request, L: int):
        """Paged admission: prefix lookup, block assignment, tail-bucket
        prefill.  Returns ``(status, first_token, bucket, prefix_hit)``,
        status ``"ok"``, ``"deferred"`` (no blocks now; slot untouched) or
        ``"failed"`` (the request was retired)."""
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
            return "deferred", None, bucket, P
        ids = np.zeros((1, bucket), dtype=np.int64)
        ids[0, :L - P] = req.prompt_ids[P:]
        tok = self._prefill_call(req, ids, L, P)
        if tok is None:
            return "failed", None, bucket, P
        if self.prefix_cache is not None:
            # this prompt's whole blocks become hittable; a registration
            # that raises costs later requests their hit, not this one
            try:
                self.prefix_cache.register(req.prompt_ids,
                                           self.cache.owned_blocks(req.slot),
                                           salt=self._tenant_salt(req))
            except Exception:            # noqa: BLE001 — isolation boundary
                self.metrics.on_prefix_register_error()
        return "ok", tok, bucket, P

    def _admit(self, req: Request) -> Optional[bool]:
        """Prefill ``req`` into its slot and deliver its first token.  A
        request cancelled or expired while queued leaves without a
        prefill.  Returns False when a paged admission must wait for
        blocks."""
        if req._cancel:                  # cancelled between pop and prefill
            self._retire(req, "cancelled")
            return None
        if self._deadline_expired(req, self._clock()):
            self._fail_deadline(req)
            return None
        L = int(req.prompt_ids.size)
        t0 = time.perf_counter()
        prefix_hit = 0
        self._stage(req)
        if self.adapter_pool is not None and not self._stage_adapter(req):
            return None
        if self.kv_layout == "paged":
            status, tok_t, bucket, prefix_hit = self._paged_prefill(req, L)
            if status == "deferred":
                return False
            if status == "failed":
                return None
        else:
            bucket = self.bucket_for(L)
            ids = np.zeros((1, bucket), dtype=np.int64)
            ids[0, :L] = req.prompt_ids
            tok_t = self._prefill_call(req, ids, L)
            if tok_t is None:
                return None
        # waits for the prefill; read before any other program runs.  The
        # prefill's watchdog window ends here, where its device time is paid
        try:
            tok = int(tok_t)
        finally:
            self._disarm_watchdog()
        if self.spec is not None and not self._spec_admit(req, L):
            return None
        now = time.perf_counter()
        self.metrics.prefill_time_s += now - t0
        req.state, req.prefill_bucket = "running", bucket
        req.model_version = self.model_version
        req._seq_len = L
        self.running[req.slot] = req
        self.metrics.on_admit(bucket, L, len(self.queue))
        self.tracer.on_admitted(req, self.name, bucket, req.slot,
                                prefix_hit)
        if self.journal is not None and req.journal_id is not None:
            # journaled before the emit: delivery is at-least-once
            # across a crash
            self.journal.record_tokens(self.name, self._step_counter,
                                       {req.journal_id: tok})
        if not self._emit_token(req, tok, now):
            return None
        self.metrics.on_first_token(req.ttft_s, tenant=req.tenant)
        if self._done_after_emit(req):
            self._retire(req)
        return None

    def _spec_admit(self, req: Request, L: int) -> bool:
        """The draft's half of a speculating admission: stage its lanes
        (the same on a first admission, a resume and a recovery replay)
        and prefill the whole prompt into its cache (no prefix cache: the
        draft's K/V is cheap and never kept).  A failure past the retries
        retires the request and returns False."""
        self.spec.stage_slot(req.slot, req.sampling, self._seed_for(req))
        ids = np.zeros((1, self.bucket_for(L)), dtype=np.int64)
        ids[0, :L] = req.prompt_ids
        try:
            self._step_call(
                "serving.spec_draft_prefill",
                lambda: self._run_draft_prefill(ids, req.slot, L),
                lambda: self.spec.stage_slot(req.slot, req.sampling,
                                             self._seed_for(req)))
            # its output is never read: its device time is paid at the
            # next read, under that step's heartbeat
            self._disarm_watchdog()
        except Exception as e:           # noqa: BLE001 — isolation boundary
            n = self.max_step_retries
            self._retire(req, "failed",
                         error=f"draft prefill failed after {n} "
                               f"retr{'y' if n == 1 else 'ies'}: "
                               f"{type(e).__name__}: {e}",
                         kind="replica")
            return False
        return True

    def _emit_token(self, req: Request, tok: int, now: float) -> bool:
        """Record one token and run the stream callback; a raising
        callback fails this request only."""
        if req.t_first_token is None:
            req.t_first_token = now
        req.output_ids.append(int(tok))
        if req.stream_cb is not None:
            try:
                self._fault("serving.stream_cb")
                req.stream_cb(int(tok), req)
            except Exception as e:       # noqa: BLE001 — per-request boundary
                self.metrics.on_callback_error()
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
                error: Optional[str] = None,
                kind: Optional[str] = None) -> None:
        """The single exit path: the slot (and its blocks) are reclaimed
        exactly once.  Idempotent.  ``kind`` tags who a failure
        implicates (``Request.error_kind``)."""
        if req.done:
            return
        req.state = state
        if error is not None:
            req.error = error
        if kind is not None:
            req.error_kind = kind
        req.t_finish = time.perf_counter()
        slot = req.slot
        if slot is not None:
            self.running.pop(slot, None)
            if slot not in self.free_slots:
                self.free_slots.append(slot)
            try:
                self.cache.release_slot(slot)
            except Exception as e:       # noqa: BLE001 — accounting bug
                self._mark_block_corruption(
                    f"release_slot({slot}) failed: "
                    f"{type(e).__name__}: {e}")
            if self.spec is not None:
                self.spec.release_slot(slot)
        if state == "finished":
            self.metrics.on_complete(tenant=req.tenant,
                                     n_tokens=len(req.output_ids))
        elif state == "cancelled":
            self.metrics.on_cancel()
        elif state == "failed":
            self.metrics.on_fail(tenant=req.tenant)
        self.tracer.on_retired(req, self.name, state, req.error)
        if self.journal is not None and req.journal_id is not None:
            # a request a fleet router owns ends only its attempt here
            # (the router writes the one final end)
            self.journal.record_end(
                req.journal_id, state,
                final=not self.journal.is_fleet_owned(req.journal_id),
                error=req.error, n_tokens=len(req.output_ids),
                engine=self.name)

    def _mark_block_corruption(self, reason: str) -> None:
        """A block-accounting violation is fatal to trust in the engine,
        not to its liveness: it turns the engine ``unhealthy`` (sticky;
        ``step`` then raises :class:`EngineStopped`), freezes the flight
        ring into a dump and tells the tracer."""
        if self.state != "unhealthy":
            self.state = "unhealthy"
            self._unhealthy_reason = f"KV block accounting: {reason}"
            self.flight.dump(self._unhealthy_reason)
            self.tracer.on_unhealthy(self.name, self._unhealthy_reason)

    # -- decode ------------------------------------------------------------

    def _prepare_decode_paged(self) -> None:
        """Before a paged decode step each running slot's next write
        position must sit in a block it owns alone (fresh block or copy on
        extend); a slot the pool cannot serve fails."""
        for slot, req in list(self.running.items()):
            try:
                ok = self.cache.ensure_capacity(slot, req._seq_len)
            except Exception as e:       # noqa: BLE001 — accounting bug
                self._mark_block_corruption(
                    f"ensure_capacity({slot}) failed: "
                    f"{type(e).__name__}: {e}")
                ok = False
            if not ok:
                self.tracer.on_block_pressure(req, self.name,
                                              kind="pool_exhausted",
                                              position=req._seq_len)
                self._retire(req, "failed",
                             error="KV block pool exhausted: no block "
                                   f"free for position {req._seq_len} "
                                   "(even after prefix-cache eviction)")

    def _decode_body(self):
        """Dispatch one decode step with the bounded retry.  Returns
        ``(tokens, t0)``, or None when nothing ran or the retries were
        exhausted (then every request of the batch failed)."""
        if self.kv_layout == "paged":
            self._prepare_decode_paged()
            if not self.running:
                return None
        active = np.zeros((self.num_slots,), dtype=np.int32)
        for slot in self.running:
            active[slot] = 1
        t0 = time.perf_counter()
        san = self.sanitizer
        try:
            # the step call must not read the card: the sanitizer runs it
            # under CUDA's sync debug mode (an error when strict)
            with (nullcontext() if san is None
                  else san.compiled_guard(self.device)):
                out = self._step_call("serving.decode",
                                      lambda: self._run_decode(active),
                                      self._restore_lanes)
        except Exception as e:           # noqa: BLE001 — isolation boundary
            if san is not None:
                san.count_violation(e)
            n = self.max_step_retries
            msg = (f"decode step failed after {n} "
                   f"retr{'y' if n == 1 else 'ies'}: "
                   f"{type(e).__name__}: {e}")
            for req in list(self.running.values()):
                self._retire(req, "failed", error=msg, kind="replica")
            return None
        if san is not None:
            san.note_step()
        return out, t0

    def _deliver_tokens(self, out: torch.Tensor, t0: float) -> None:
        """Pull the ``[slots]`` sampled tokens (the step's one device to
        host copy, before any other program runs, outside the sanitizer's
        window and the end of the watchdog's), then run callbacks and stop
        checks."""
        try:
            toks = out.cpu().numpy()
        finally:
            self._disarm_watchdog()
        now = time.perf_counter()
        if self.journal is not None:
            # one batched record per engine step for every running slot,
            # before the emits, from the tokens already on the host
            tokmap = {r.journal_id: int(toks[s])
                      for s, r in self.running.items()
                      if r.journal_id is not None}
            if tokmap:
                self.journal.record_tokens(self.name, self._step_counter,
                                           tokmap)
        self.metrics.on_decode_step(len(self.running), now - t0)
        if self.tracer.enabled:
            # one event per engine step, never one per token
            self.tracer.on_decode_step(self.name, self._step_counter,
                                       list(self.running), now - t0)
        for slot, req in list(self.running.items()):
            req._seq_len += 1
            if not self._emit_token(req, int(toks[slot]), now):
                continue
            if req.done:                 # cancelled from inside its cb
                continue
            if self._done_after_emit(req):
                self._retire(req)

    # -- speculative rounds --------------------------------------------------

    def _prepare_spec_paged(self) -> None:
        """Before a paged round, each running slot must own alone the
        blocks of its whole window ``[len, len+k]`` (the verify writes all
        ``k+1`` positions whatever it accepts): fresh blocks appended,
        shared ones copied on extend, as a decode's one position.
        Positions at or past ``max_seq`` go to scratch and need none.  A
        slot the pool cannot serve fails its request."""
        k = self.spec.k
        for slot, req in list(self.running.items()):
            ok = True
            try:
                last = min(req._seq_len + k, self.max_seq - 1)
                for pos in range(req._seq_len, last + 1):
                    if not self.cache.ensure_capacity(slot, pos):
                        ok = False
                        break
            except Exception as e:       # noqa: BLE001 — accounting bug
                self._mark_block_corruption(
                    f"ensure_capacity({slot}) failed: "
                    f"{type(e).__name__}: {e}")
                ok = False
            if not ok:
                self.tracer.on_block_pressure(req, self.name,
                                              kind="pool_exhausted",
                                              position=req._seq_len)
                self._retire(req, "failed",
                             error="KV block pool exhausted: no block "
                                   "free for the verify window at "
                                   f"position {req._seq_len} (even "
                                   "after prefix-cache eviction)")

    def _spec_round_body(self):
        """Dispatch one speculative round, ``k`` draft-decode programs and
        the verify, as one call with the bounded retry: a retry rewinds
        the whole round (:meth:`_restore_lanes` sets the target's lanes
        and the draft's to the round's start).  Returns ``(out, t0)``, or
        None when nothing ran or the retries were exhausted (then every
        request of the batch failed)."""
        spec = self.spec
        if self.kv_layout == "paged":
            self._prepare_spec_paged()
        if not self.running:
            return None
        active = np.zeros((self.num_slots,), dtype=np.int32)
        cap = np.ones((self.num_slots,), dtype=np.int32)
        for slot, req in self.running.items():
            active[slot] = 1
            # the emission cap, host ints only: the token budget and the
            # cache's room (each >= 1 for a running request, which
            # _done_after_emit retires at either boundary)
            cap[slot] = max(1, min(spec.k + 1,
                                   req.max_new_tokens - len(req.output_ids),
                                   self.max_seq - req._seq_len))

        def round_() -> torch.Tensor:
            # the JAX engine's fault points: each draft step, the verify
            for j in range(spec.k):
                self._fault("serving.spec_draft")
                self._run_draft_decode(active, j)
            self._fault("serving.spec_verify")
            return self._run_verify(active, cap)

        t0 = time.perf_counter()
        san = self.sanitizer
        try:
            with (nullcontext() if san is None
                  else san.compiled_guard(self.device)):
                out = self._step_call("serving.spec_round", round_,
                                      self._restore_lanes, check=False)
        except Exception as e:           # noqa: BLE001 — isolation boundary
            if san is not None:
                san.count_violation(e)
            n = self.max_step_retries
            msg = (f"speculative round failed after {n} "
                   f"retr{'y' if n == 1 else 'ies'}: "
                   f"{type(e).__name__}: {e}")
            for req in list(self.running.values()):
                self._retire(req, "failed", error=msg, kind="replica")
            return None
        if san is not None:
            san.note_step()              # one round is one counted step
        return out, t0

    def _deliver_spec(self, out: torch.Tensor, t0: float) -> None:
        """Pull the round's ``[slots, k+2]`` result (its one device to host
        copy), then the host's half of the round: a stream cut after its
        stop token, one journal record and one tracer event for the round,
        the lengths mirrored, the paged table truncated past the accepted
        length, the emits and the retirements."""
        try:
            arr = out.cpu().numpy()
        finally:
            self._disarm_watchdog()
        now = time.perf_counter()
        spec = self.spec
        running = list(self.running.items())
        step_s = now - t0
        delivered: Dict[int, List[int]] = {}
        accepted = 0
        for slot, req in running:
            m = int(arr[slot, 0])
            accepted += max(0, m - 1)
            toks = [int(t) for t in arr[slot, 1:1 + m]]
            if req.eos_token_id is not None and req.eos_token_id in toks:
                # the round ran past the stop token: what follows it is
                # never delivered, as the one-token loop would stop there
                toks = toks[:toks.index(req.eos_token_id) + 1]
            delivered[slot] = toks
        if self.journal is not None:
            # one record per round, each request's burst in it, before
            # the emits
            tokmap = {r.journal_id: delivered[s] for s, r in running
                      if r.journal_id is not None and delivered[s]}
            if tokmap:
                self.journal.record_tokens(self.name, self._step_counter,
                                           tokmap)
        proposed = spec.k * len(running)
        self.metrics.on_spec_round(
            step_s, draft_steps=spec.k, proposed=proposed,
            accepted=accepted,
            delivered=[len(delivered[s]) for s, _ in running])
        if self.tracer.enabled:
            # one event per round, never one per token
            self.tracer.on_verify_step(self.name, self._step_counter,
                                       [s for s, _ in running], step_s,
                                       proposed=proposed, accepted=accepted)
        for slot, req in running:
            req._seq_len += int(arr[slot, 0])    # the program's advance
            if self.kv_layout == "paged":
                try:
                    self.cache.truncate_blocks(slot, req._seq_len)
                except Exception as e:   # noqa: BLE001 — accounting bug
                    self._mark_block_corruption(
                        f"truncate_blocks({slot}) failed: "
                        f"{type(e).__name__}: {e}")
            # the cap fitted the burst to the budget and the cache, and it
            # ends at a stop token if it holds one: the whole burst is
            # delivered, then the one-token loop's stop checks
            for tok in delivered[slot]:
                if not self._emit_token(req, tok, now) or req.done:
                    break                # its callback failed or cancelled
            if not req.done and self._done_after_emit(req):
                self._retire(req)

    # -- scheduling --------------------------------------------------------

    def step(self) -> bool:
        """One scheduler tick: reap cancellations and deadlines, admit
        queued requests (highest effective priority first, preempting a
        lower-priority victim when no slot or no block is free), then one
        decode step for the running slots.  True while work remains.
        Raises :class:`EngineStopped` once the engine is unhealthy."""
        self._exchange()
        if self.state == "unhealthy":
            raise EngineStopped(
                f"engine {self.name!r} is unhealthy: "
                f"{self._unhealthy_reason}")
        if self.shard is not None and self.fault_plan is not None \
                and self.fault_plan.armed:
            # a simulated device loss (serving.shard_fail@N): the engine
            # loses its mesh's highest rank and turns unhealthy; a fleet
            # ejects it and rebuilds the group at a smaller viable mp
            from ..distributed.fault_tolerance.injection import \
                InjectedFault

            try:
                self.fault_plan.check("serving.shard_fail")
            except InjectedFault as e:
                self._mark_shard_lost(e)
                raise EngineStopped(
                    f"engine {self.name!r} is unhealthy: "
                    f"{self._unhealthy_reason}") from e
        self._reap(self._clock())
        while self.queue:
            now = self._clock()
            i = self._best_queued_index(now)
            req = self.queue[i]
            if req.done:                 # cancelled or expired while queued
                del self.queue[i]
                continue
            if not self.free_slots:
                # the entitled queued request (not necessarily the
                # effective head) may evict the lowest-priority victim;
                # otherwise the queue waits for a retirement
                i, req, victim = self._best_preempting_candidate(now)
                if victim is None:
                    break
                del self.queue[i]
                self._preempt(victim)
            else:
                del self.queue[i]
            req.slot = self.free_slots.pop()
            try:
                deferred = self._admit(req) is False
            except BaseException:
                if not req.done:
                    self._retire(req, "failed",
                                 error="admission aborted by engine error")
                raise
            if deferred:
                # no blocks for this prompt now: hand the slot back.  A
                # higher-priority admission evicts a lower-priority victim
                # for its blocks and tries again; otherwise it waits for
                # running work to retire, and with nothing running no
                # block can ever free, so it fails instead of spinning
                self.free_slots.append(req.slot)
                req.slot = None
                req._defers += 1
                self.tracer.on_block_pressure(req, self.name,
                                              defers=req._defers)
                victim = self._pick_victim(req)
                if victim is not None:
                    self._preempt(victim)
                    self.queue.appendleft(req)
                    continue
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
            # the dispatch runs in the sanitizer's counting window; the
            # delivery's token pull comes after it
            san = self.sanitizer
            with (nullcontext() if san is None else san.decode_window()):
                res = (self._decode_body() if self.spec is None
                       else self._spec_round_body())
            if res is not None and self.spec is None:
                self._deliver_tokens(*res)
            elif res is not None:
                self._deliver_spec(*res)
        self._step_counter += 1
        summary = dict(step=self._step_counter, running=len(self.running),
                       queued=len(self.queue))
        if self.kv_layout == "paged":
            summary["free_blocks"] = self.cache.allocator.free_blocks
        self.flight.record(**summary)
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

    # -- lifecycle ---------------------------------------------------------

    def drain(self) -> dict:
        """Stop admitting new requests, finish all queued and running
        work, and return the final stats snapshot.  The engine ends
        ``stopped`` (``add_request`` raises :class:`EngineStopped`)."""
        if self.state == "active":
            self.state = "draining"
        while (self.running or self.queue) and self.state == "draining":
            try:
                self.step()
            except EngineStopped:
                break                    # unhealthy mid-drain: sticky
        if self.state == "draining" and not (self.running or self.queue):
            self.state = "stopped"
            self._stop_watchdog()
        return self.stats()

    def shutdown(self, timeout_s: Optional[float] = None) -> dict:
        """Drain with a wall-clock budget, then cancel whatever is still
        unfinished (``error="engine shutdown"``, ``error_kind="replica"``)
        and stop the engine.  ``timeout_s=None`` waits for all work."""
        if self.state == "active":
            self.state = "draining"
        deadline = None if timeout_s is None \
            else self._clock() + float(timeout_s)
        while (self.running or self.queue) and self.state == "draining":
            if deadline is not None and self._clock() >= deadline:
                break
            try:
                self.step()
            except EngineStopped:
                break                    # unhealthy mid-drain: cancel the rest
        for req in list(self.queue) + list(self.running.values()):
            # a lifecycle cancellation implicates the engine, not the
            # request: a fleet may replay it elsewhere
            self._retire(req, "cancelled", error="engine shutdown",
                         kind="replica")
        self.queue.clear()
        self.metrics.queue_depth = 0
        if self.state != "unhealthy":
            self.state = "stopped"
        self._stop_watchdog()
        return self.stats()

    # -- fleet hooks ---------------------------------------------------------

    def export_requests(self) -> List[Request]:
        """Strip every non-terminal request off this engine for replay
        elsewhere: the ejection hook of :class:`~.router.Fleet`.  Queued
        and running requests come back in scheduling order (the queue
        first, then the running slots), each retired here ``cancelled``
        with ``error_kind="replica"``, so the one retire path reclaims
        their slots and blocks and the handles carry no engine state."""
        out = [r for r in self.queue if not r.done]
        out.extend(r for r in self.running.values() if not r.done)
        self.queue.clear()
        for req in out:
            self._retire(req, "cancelled",
                         error=f"exported from engine {self.name!r} "
                               "on replica ejection",
                         kind="replica")
        self.metrics.queue_depth = 0
        return out

    def _release_device(self) -> None:
        """Free what this engine holds on the device, so that a successor
        can be built in its place: its step programs (CUDA graphs, their
        static buffers and pool), the KV cache's tensors, its model (a
        fleet replica's own clone, unless something else holds it), its
        adapter lanes and its speculation state.  Host bookkeeping stays
        readable (``name``, ``metrics``, ``flight``, ``health()``,
        ``stats()``); the engine serves nothing after this.  Used on a
        stopped engine, or on one abandoned as a crash would leave it."""
        self._stop_watchdog()
        if self.state != "unhealthy":
            self.state = "stopped"
        self.programs.clear()
        for name, value in list(vars(self.cache).items()):
            if isinstance(value, torch.Tensor):
                setattr(self.cache, name, None)
        if self.spec is not None:
            snap = self.spec.snapshot()
            self.metrics.spec_cb = lambda: snap
            self.spec = None
        self.adapter_pool = None
        self.model = None

    # -- durability: crash recovery and weight hot swap --------------------

    def recover(self, journal=None, *, cross_mesh: bool = True) -> dict:
        """Crash recovery: re-enqueue every journaled request that has no
        final end, as a replay from its prompt (``recovered`` set, its
        stream restarting at token 0, its slot's lanes staged from the
        journaled effective seed, so greedy and seeded streams equal an
        uninterrupted run's).  The journal's terminal outcomes are banked
        into the metrics, so the counters continue across the restart.

        A request journaled at another mesh shape replays here when
        ``cross_mesh`` (one ``mesh_reshard`` record per old shape keeps
        the audit exactly-once) and fails finally when not.  A replay
        this engine cannot validate fails that request only, finally,
        and the rest replay.  ``max_queue`` is lifted while the replays
        are queued.

        Call on an engine after :meth:`warmup` and before any traffic;
        ``journal`` defaults to the engine's own (passing one attaches
        it).  Returns ``{"replayed", "requests", "invalid", "cross_mesh",
        "outcomes"}``."""
        journal = journal if journal is not None else self.journal
        if journal is None:
            raise ValueError("recover() needs a RequestJournal (pass "
                             "journal= here or to the Engine)")
        if self.running or self.queue:
            raise RuntimeError("recover() must run before serving "
                               "traffic (the journal's replay order is "
                               "the recovered queue order)")
        if self.journal is not None and journal is not self.journal:
            raise ValueError(
                "recover(journal=...) does not match the journal this "
                "engine records into: replaying one journal while "
                "recording into another leaves the replayed journal's "
                "pending set non-converging")
        self.journal = journal
        outcomes = journal.outcomes()
        self.metrics.bank_outcomes(outcomes)
        replayed, invalid = [], []
        # cross-shape dispositions, grouped by the journaled old shape
        cross: "OrderedDict[Optional[str], OrderedDict[str, str]]" = \
            OrderedDict()
        saved_max_queue, self.max_queue = self.max_queue, None
        try:
            for jid, rec in journal.pending().items():
                want = rec.get("mesh_shape")
                shape_changed = want != self.mesh_shape
                if shape_changed and not cross_mesh:
                    journal.record_end(
                        jid, "failed", final=True,
                        error=f"recovery replay rejected: journaled "
                              f"mesh shape {want!r} != this engine's "
                              f"{self.mesh_shape!r}",
                        engine=self.name)
                    invalid.append(jid)
                    continue
                s = journal.replay_sampling(rec)
                journal.begin_attempt(jid, recovered=True,
                                      origin_wall=rec.get("wall"))
                try:
                    self._validate_replay_tenancy(rec, s)
                    r = self.add_request(
                        rec["prompt_ids"],
                        max_new_tokens=rec["max_new_tokens"],
                        sampling=SamplingParams(**s),
                        eos_token_id=rec["eos_token_id"],
                        deadline_s=rec["deadline_s"],
                        priority=rec["priority"])
                except ValueError as e:
                    # fail THAT request with a final end so the journal
                    # converges, and keep replaying the rest
                    journal.record_end(jid, "failed", final=True,
                                       error=f"recovery replay "
                                             f"rejected: {e}",
                                       engine=self.name)
                    invalid.append(getattr(e, "request", None) or jid)
                    if shape_changed:
                        cross.setdefault(want, OrderedDict())[jid] = \
                            "failed"
                    continue
                finally:
                    journal.end_attempt()
                replayed.append(r)
                if shape_changed:
                    cross.setdefault(want, OrderedDict())[jid] = \
                        "replayed"
        finally:
            self.max_queue = saved_max_queue
        for old_shape, requests in cross.items():
            journal.record_mesh_reshard(
                self.name, old_shape, self.mesh_shape, requests)
        return {"replayed": len(replayed), "requests": replayed,
                "invalid": invalid,
                "cross_mesh": sum(len(v) for v in cross.values()),
                "outcomes": outcomes}

    def _validate_replay_tenancy(self, rec: dict, s: dict) -> None:
        """The replay gate of a journaled tenant request: its adapter must
        be loaded here at the journaled version (other weights would serve
        other tokens than the crashed run promised) and its grammar must
        be registered.  Raises ValueError (with ``error_ctx`` for an
        adapter), which fails that request finally in :meth:`recover`."""
        a = s.get("adapter")
        if a is not None:
            want = rec.get("adapter_version")
            msg = None
            if self.adapter_pool is None:
                msg = (f"journaled adapter {a!r} but this engine has no "
                       "adapter pool")
            else:
                try:
                    _, v = self.adapter_pool.resolve(a)
                except KeyError:
                    v = None
                if v is None:
                    msg = (f"journaled adapter {a!r} (v{want}) is not "
                           "loaded on the recovering engine")
                elif want is not None and v != want:
                    msg = (f"journaled adapter {a!r} v{want} != loaded "
                           f"v{v}: bitwise replay impossible")
            if msg is not None:
                e = ValueError(msg)
                e.error_ctx = {"adapter": a, "version": want}
                raise e
        g = s.get("grammar")
        if g is not None:
            if self.grammar_table is None:
                raise ValueError(f"journaled grammar {g!r} but this engine "
                                 "has no grammar table")
            try:
                self.grammar_table.spec_of(g)
            except KeyError as e:
                raise ValueError(e.args[0]) from None

    def update_weights(self, state_or_path, *,
                       version: Optional[int] = None) -> int:
        """Swap the model's weights in place on an idle engine.

        ``state_or_path`` is a state dict with the names and layouts of
        the port's ``model.state_dict()`` (torch tensors on any device,
        or numpy arrays) or an ``.npz`` path of one.  Every parameter is
        written in place on the stream the step programs replay on, which
        is synchronised before this returns; a parameter that moved in
        memory raises (a captured graph would go on reading the old
        one).  So every program built at warmup stays valid: no program
        is built.  The prefix-cache epoch is bumped, so no later request
        hits KV computed under the old weights, and ``model_version``
        advances by one (or is set to ``version``: a fleet's rolling
        update tags every replica with the fleet's version).  Queued or
        running work raises: its KV was computed under the old weights.
        A sharded engine takes the whole state dict and writes its rank's
        shard of it.  Returns the new version."""
        if self.running or self.queue:
            raise RuntimeError(
                f"engine {self.name!r} has in-flight work "
                f"({len(self.running)} running, {len(self.queue)} "
                "queued): drain before update_weights; decoding KV "
                "prefilled under old weights with new weights would "
                "serve a torn response")
        sd = _resolve_weights(state_or_path)
        if self.shard is not None:
            # a whole state dict: this rank's shard of it
            sd = self.shard.shard_weights(sd)
        _write_state_dict(self.model, sd)
        return self._mark_weights_swapped(version)

    def _mark_weights_swapped(self, version: Optional[int] = None) -> int:
        """The bookkeeping half of a swap: prefix epoch, version tag,
        metrics, tracer and journal.  Apart so that a fleet whose
        replicas share one parameter set writes the weights once and
        still gives every engine its own epoch and version."""
        if self.prefix_cache is not None:
            self.prefix_cache.bump_epoch()
        self.model_version = (int(version) if version is not None
                              else self.model_version + 1)
        self.metrics.on_weight_swap(self.model_version)
        self.tracer.on_weight_swap(self.name, self.model_version)
        if self.journal is not None:
            self.journal.record_weight_swap(self.name, self.model_version)
        return self.model_version

    # -- multi-LoRA adapter lifecycle ----------------------------------------

    def _fail_adapter_inflight(self, name: str, why: str) -> int:
        """Fail every queued and running request of adapter ``name`` with
        ``error_ctx = {"adapter", "version"}``: a lane about to be zeroed
        or overwritten must not go on serving a request pinned to the old
        version (a torn mix of two adapters).  Runs between programs.
        Returns how many requests failed."""
        v = self.adapter_pool.last_version(name)
        failed = 0
        for q in [q for q in self.queue if q.sampling.adapter == name]:
            self.queue.remove(q)
            q.error_ctx = {"adapter": name, "version": v}
            self._retire(q, "failed", error=f"adapter {name!r} {why} "
                                            f"while queued (was v{v})")
            failed += 1
        for r in [r for r in self.running.values()
                  if r.sampling.adapter == name]:
            r.error_ctx = {"adapter": name, "version": v}
            self._retire(r, "failed", error=f"adapter {name!r} {why} "
                                            f"mid-flight (was v{v})")
            failed += 1
        self.metrics.queue_depth = len(self.queue)
        return failed

    def _require_pool(self) -> AdapterPool:
        if self.adapter_pool is None:
            raise RuntimeError(f"engine {self.name!r} has no adapter pool "
                               "(construct with Engine(adapters=...))")
        return self.adapter_pool

    def load_adapter(self, name: str, weights, *,
                     scale: float = 1.0) -> int:
        """Load (or hot-swap) LoRA adapter ``name`` into a lane: ``weights``
        maps every target's module path to its ``(A [in, rank], B [rank,
        out])`` pair (:func:`~.adapters.make_lora_weights`), ``scale`` is
        folded into B.  The lane rows are written in place on the stream
        the programs replay on, which is synchronised, so every program
        built at warmup stays valid and none is built.  A hot swap first
        fails the adapter's in-flight requests.  Bumps the name's version
        (retiring its prefix-cache salt) and returns it."""
        pool = self._require_pool()
        if name in pool.loaded:
            self._fail_adapter_inflight(name, "hot-swapped")
        _lane, version = pool.load(name, weights, scale=scale)
        self.metrics.on_adapter_load()
        self.tracer.on_adapter_load(self.name, name, version)
        return version

    def unload_adapter(self, name: str) -> int:
        """Unload adapter ``name``: fail its in-flight requests (with
        ``error_ctx``), zero its lane in place and free it.  The name's
        version survives for a later load, so the unloaded version's salt
        is never minted again.  Returns the unloaded version."""
        pool = self._require_pool()
        pool.resolve(name)               # KeyError if not loaded
        self._fail_adapter_inflight(name, "unloaded")
        version = pool.unload(name)
        self.metrics.on_adapter_unload()
        self.tracer.on_adapter_unload(self.name, name, version)
        return version

    def prefix_probe(self, prompt_ids: Sequence[int],
                     adapter: Optional[str] = None) -> int:
        """The longest prompt prefix, in tokens, this engine's prefix
        cache holds in ``adapter``'s domain (the base model's for None),
        with no side effect.  0 for the contiguous layout, without a
        prefix cache, or for an adapter not loaded."""
        if self.prefix_cache is None:
            return 0
        salt = b""
        if adapter is not None and self.adapter_pool is not None:
            try:
                salt = self.adapter_pool.salt(adapter)
            except KeyError:
                return 0
        return self.prefix_cache.probe(prompt_ids, salt=salt)

    # -- introspection -----------------------------------------------------

    def _paging_snapshot(self) -> dict:
        al = self.cache.allocator.stats()
        return {"kv_layout": "paged", "kernel": self.kernel,
                "block_size": self.block_size,
                "max_blocks_per_slot": self.cache.max_blocks_per_slot,
                "blocks": al, "blocks_in_use": al["used"] + al["cached"],
                "copy_on_extends": self.cache.copy_on_extends,
                "prefix": (self.prefix_cache.stats()
                           if self.prefix_cache is not None else None),
                "prefix_lookup_errors": self.metrics.prefix_lookup_errors,
                "prefix_register_errors":
                    self.metrics.prefix_register_errors}

    def health(self) -> dict:
        """Liveness snapshot: the engine's ``state`` (and why it is
        unhealthy), steps, failures and capacity, and whether the step
        watchdog protects the next steps (``watchdog_armed``: configured,
        the engine still stepping, the monitor not fired or stopped); in
        the paged layout also the block allocator's invariant audit
        (``"ok"`` or the violations), a violation turning the engine
        ``unhealthy``."""
        out = {"state": self.state, "reason": self._unhealthy_reason,
               "steps": self._step_counter,
               "consecutive_step_failures": self._consecutive_failures,
               "queue_depth": len(self.queue),
               "slots_free": len(self.free_slots),
               "slots_total": self.num_slots,
               "watchdog_armed": bool(
                   self.step_timeout_s is not None
                   and self.state in ("active", "draining")
                   and (self._watchdog is None or self._watchdog.alive))}
        if self.kv_layout == "paged":
            violations = self.cache.check_invariants()
            if violations:
                self._mark_block_corruption("; ".join(violations))
                out["state"] = self.state
                out["reason"] = self._unhealthy_reason
            al = self.cache.allocator.stats()
            out["kv_blocks"] = {k: al[k] for k in ("total", "reserved",
                                                   "free", "used", "cached")}
            out["kv_block_invariants"] = violations or "ok"
        return out

    def stats(self) -> dict:
        """``/stats``-style snapshot: the serving metrics, the health
        audit, paged, the pool and prefix-cache gauges, sharded, the mesh
        shape and model-parallel degree (``"sharding"``), with a sanitizer
        its report, and, with a live tracer, its summary."""
        self.metrics._slots_busy = len(self.running)
        self.metrics.queue_depth = len(self.queue)
        snap = self.metrics.snapshot()
        # programs built after warmup: a steady-state anomaly (None before
        # warmup)
        snap["compile_cache"]["after_warmup"] = (
            None if self._warm_misses is None
            else self.metrics.compile_misses - self._warm_misses)
        snap["health"] = self.health()
        snap["paging"] = (self._paging_snapshot()
                          if self.kv_layout == "paged" else None)
        if self.adapter_pool is not None or self.grammar_table is not None:
            pool, gt = self.adapter_pool, self.grammar_table
            snap["tenancy"] = {
                "adapters": pool.loaded if pool is not None else {},
                "adapter_lanes": (pool.max_adapters if pool is not None
                                  else 0),
                "grammars": list(gt.names) if gt is not None else []}
        if self.journal is not None:
            snap["durability"]["journal"] = self.journal.stats()
        if self.shard is not None:
            snap["sharding"] = {"mesh_shape": self.mesh_shape,
                                "model_parallel": self.shard.mp}
        if self.sanitizer is not None:
            snap["sanitizer"] = self.sanitizer.report()
        if self.tracer.enabled:
            snap["tracing"] = self.tracer.snapshot()
        return snap
