"""The serving fleet: N supervised engine replicas behind one
submit/stream/cancel surface.

Port of ``paddle_tpu/serving/router.py``.  A :class:`Fleet` owns N
:class:`~.engine.Engine` replicas, each with its own KV pool, prefix
cache and step programs (CUDA graphs on the card), and treats a replica
as a unit that can fail, be ejected and be rebuilt:

- **Dispatch** is prefix affinity first: a request goes to the replica
  whose prefix cache already holds the longest prefix of its prompt
  (``Engine.prefix_probe``, no side effect), ties to the least loaded;
  without a hit, least loaded with a round-robin tie-break.  ``replica=``
  pins a request; ``max_queue`` bounds the queued depth summed over the
  active replicas.
- **Supervision**: every ``supervise_every`` fleet steps each replica's
  ``health()`` is read.  A replica that is ``unhealthy`` (the step
  watchdog, a block-accounting violation) or whose step calls failed
  ``eject_after_failures`` times in a row is **ejected**: its queued and
  running requests are exported (``Engine.export_requests``) and replayed
  on the others, the engine is shut down and what it holds on the card
  is freed (``Engine._release_device``), and a new engine is built in its
  place and warmed (at most :attr:`Fleet.MAX_REBUILD_ATTEMPTS` tries in
  a row before the replica is ``dead``).  The eject-to-rejoin time is the
  failover recovery (``stats()["supervision"]["last_recovery_ms"]``).
- **The stream contract on redispatch**: a replayed request restarts
  from its prompt; ``FleetRequest.redispatched``/``redispatches`` are set
  and ``output_ids`` reset before the replay's token 0, and the request
  reaches its terminal state exactly once (``duplicate_terminals``
  audits it).  After ``max_redispatch`` replays it fails with the
  replica's error.  Greedy and seeded streams replay the same.
- **Weights**: under weight isolation (the default with more than one
  replica) each replica serves its own copy of the template's
  parameters, so :meth:`Fleet.update_weights` rolls new weights through
  the replicas one at a time while the others serve; with shared weights
  the roll is a stop-the-world swap.  A copy is built on the ``meta``
  device (for GPT with the template's attention route), and each of its
  tensors is then a device copy of the template's, in its dtype: no
  random draw, no host round trip.
- **Durability**: a journal shared by the router and the replicas
  (``journal=``) and :meth:`Fleet.recover`, which replays a crashed
  process's unfinished requests across the fleet.

The replicas run on one host thread: a fleet step steps each replica in
turn, and each engine step reads its tokens on the host before the next
replica steps, so on one card the replicas share the device and never
run at once.

**Shard groups** (``shards_per_group=mp > 1``): every replica is a
tensor-parallel engine (``Engine(mesh=...)``) on its own ranks of a
``torch.distributed`` world, group g on ranks ``[g*mp, (g+1)*mp)``.
Every rank of the world builds the same fleet and is fed the same calls
(SPMD); a rank runs the engine of its own group and holds a stand-in
(:class:`_RemoteEngine`) for the others.  The fleet's host view is the
same on every rank: once per fleet step each group's first rank sends
its replica's state, load and attempts (tokens, terminal states) to the
whole world, and every rank's router applies them in one order, so every
dispatch, reap, ejection and rebuild is decided the same everywhere.  A
dispatch's prefix probes and a submit's outcome are exchanged the same
way.  ``dist.new_group`` is collective over the world, so every group a
degrade can reach (for each group and each viable mp, its first mp
ranks) is made at construction.

**Degraded rebuild**: a group that loses a rank (the
``serving.shard_fail`` point loses its highest) is ejected and rebuilt at
the largest viable mp (:func:`~.sharding.degrade_step`) on its surviving
ranks; the lost rank leaves its group's engine but goes on taking part
in the world's exchanges.  A group with no survivor is ``dead`` with an
error naming the viability ladder.  The degrade is journaled
(``mesh_reshard``), counted (``stats()["degraded"]``) and weighs the
group's load by ``configured / current`` mp in dispatch.  Each rank
journals into the journal it was given; give each rank its own
directory: :meth:`Fleet.recover` gathers the pending requests of every
rank's journal and replays their union in one order on every rank.
"""
from __future__ import annotations

import itertools
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import profiler
from .engine import (
    PRIORITY_NORMAL, TERMINAL_STATES, Engine, EngineStopped, QueueFull,
    Request, ShedReject, _as_priority, _resolve_weights, _write_state_dict,
)
from .metrics import FleetMetrics
from .sampling import SamplingParams
from .tracing import NULL_TRACER, RequestTracer

__all__ = ["Fleet", "FleetRequest"]

_fleet_counter = itertools.count()


@dataclass(eq=False)           # a live handle: identity, not field equality
class FleetRequest:
    """One generation request moving through the fleet.

    The handle outlives any one replica attempt: the engine
    :class:`~.engine.Request` under it may be replayed on another replica
    after an ejection, while this handle carries the stream the caller
    sees and reaches a terminal state exactly once.  ``output_ids``
    mirror the current attempt's stream; on redispatch they reset and
    ``redispatches``/``redispatched`` are set before the first replayed
    token arrives."""

    prompt_ids: np.ndarray
    request_id: int = -1
    stream_cb: Optional[Callable[[int, "FleetRequest"], None]] = None
    done_cb: Optional[Callable[["FleetRequest"], None]] = None
    kwargs: dict = field(default_factory=dict)    # engine add_request kwargs
    state: str = "pending"
    error: Optional[str] = None
    #: machine-readable rejection context, as ``Request.error_ctx``
    error_ctx: Optional[dict] = None
    output_ids: List[int] = field(default_factory=list)
    redispatches: int = 0
    redispatched: bool = False
    #: the current attempt's preemption markers (a preempted stream
    #: restarts from token 0, marked, one level down)
    preempted: bool = False
    preemptions: int = 0
    #: the request's id in the fleet's journal, the same across
    #: redispatches and process crashes
    journal_id: Optional[str] = None
    #: a crash-recovery replay made by :meth:`Fleet.recover`
    recovered: bool = False
    #: weight version of the replica that admitted the current attempt
    model_version: int = 0
    #: the pre-crash admission's wall stamp (the tracer's resume link)
    _origin_wall: Optional[float] = field(default=None, repr=False)
    #: the engines this request was dispatched to, in order
    replica_history: List[str] = field(default_factory=list)
    t_submit: float = 0.0
    t_finish: Optional[float] = None
    _attempt: Optional[Request] = field(default=None, repr=False)
    _cancel: bool = False
    #: a replica shed this request while the dispatch looked for one
    #: that would take it (the fleet's shed count must see it)
    _shed_seen: bool = field(default=False, repr=False)
    _fleet: Optional[object] = field(default=None, repr=False)

    @property
    def finished(self) -> bool:
        return self.state == "finished"

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    def cancel(self) -> bool:
        """Stop this request wherever its current attempt is.  False if
        it is already terminal."""
        if self.done:
            return False
        self._cancel = True
        fleet = self._fleet() if self._fleet is not None else None
        if fleet is not None:
            fleet._on_cancel(self)
        return True


class _Attempt:
    """A shard-group fleet's view of one engine attempt, the same on every
    rank: its fields come from the world exchange after each fleet step.
    A rank of the serving group also holds the engine's request
    (``local``), which a cancel reaches."""

    __slots__ = ("local", "state", "error", "error_kind", "error_ctx",
                 "output_ids", "preempted", "preemptions", "_cancel")

    def __init__(self, local: Optional[Request] = None):
        self.local = local
        self.state = "queued"
        self.error: Optional[str] = None
        self.error_kind: Optional[str] = None
        self.error_ctx: Optional[dict] = None
        self.output_ids: List[int] = []
        self.preempted = False
        self.preemptions = 0
        self._cancel = False

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    def cancel(self) -> bool:
        if self.done or self._cancel:
            return False
        self._cancel = True
        if self.local is not None:
            self.local.cancel()
        return True


class _RemoteEngine:
    """A replica's engine as a rank outside its group sees it: a name, a
    weight version and a mesh shape.  What else the router reads of it
    comes from the world exchange."""

    def __init__(self, name: str, model_version: int,
                 mesh_shape: Optional[str]):
        self.name = name
        self.model_version = model_version
        self.mesh_shape = mesh_shape


class _Replica:
    """One supervised engine slot of the fleet's rotation."""

    __slots__ = ("index", "engine", "state", "ejections", "rebuilds",
                 "rebuild_attempts", "last_error", "_eject_t",
                 "flight_dumps", "degraded", "mp", "live")

    def __init__(self, index: int, engine, mp: int = 1):
        self.index = index
        self.engine = engine
        self.state = "active"            # active | updating | ejected | dead
        self.ejections = 0
        self.rebuilds = 0
        self.rebuild_attempts = 0        # consecutive failed rebuilds
        self.last_error: Optional[str] = None
        self._eject_t: Optional[float] = None
        #: flight-recorder dumps frozen at each ejection (newest last):
        #: the post-mortem outlives the ejected engine
        self.flight_dumps: List[dict] = []
        #: a degraded rebuild left the group below ``shards_per_group``
        self.degraded = False
        #: the group's model-parallel degree
        self.mp = int(mp)
        #: a shard group's live engine requests on this rank, by fleet
        #: request id
        self.live: Dict[int, Request] = {}

    @property
    def local(self) -> bool:
        """Whether this rank runs the replica's engine."""
        return isinstance(self.engine, Engine)

    def load(self) -> int:
        return len(self.engine.queue) + len(self.engine.running)

    def model_parallel(self) -> int:
        return self.mp


def _meta_model(model: nn.Module) -> nn.Module:
    """``type(model)(model.config)`` on the ``meta`` device (no
    allocation, no random draw; GPT keeps the template's attention
    route): the shell of a copy, and the probe of whether the model can
    be copied at all."""
    kwargs = {"device": "meta"}
    routes = {m.kernel for m in model.modules()
              if isinstance(getattr(m, "kernel", None), str)}
    if len(routes) > 1:
        raise TypeError(f"the template mixes attention routes {routes}")
    if routes:
        kwargs["kernel"] = routes.pop()
    return type(model)(model.config, **kwargs)


def _clone_model(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with its own parameters and buffers: its
    :func:`_meta_model` shell with each parameter and buffer,
    non-persistent ones (Llama's RoPE tables) included, set to a copy of
    the template's, in its dtype on its device.  Raises if the copy's
    tensors do not match the template's names and shapes."""
    clone = _meta_model(model)
    src = dict(model.named_parameters())
    src.update(model.named_buffers())
    names = [n for n, _ in clone.named_parameters()]
    names += [n for n, _ in clone.named_buffers()]
    if sorted(names) != sorted(src):
        odd = sorted(set(names) ^ set(src))[:5]
        raise TypeError(f"the copy's tensors {odd} differ from the "
                        f"template's")
    with torch.no_grad():
        for prefix, mod in clone.named_modules():
            prefix = f"{prefix}." if prefix else ""
            for table in (mod._parameters, mod._buffers):
                for name, t in table.items():
                    if t is None:
                        continue
                    s = src[prefix + name]
                    if s.shape != t.shape:
                        raise TypeError(f"{prefix}{name}: the copy has "
                                        f"{tuple(t.shape)}, the template "
                                        f"{tuple(s.shape)}")
                    copy = s.detach().clone()
                    table[name] = (nn.Parameter(copy, t.requires_grad)
                                   if isinstance(t, nn.Parameter) else copy)
    return clone.eval()


class Fleet:
    """N supervised :class:`~.engine.Engine` replicas behind one
    submit/stream/cancel surface.

    Args:
        model_or_config: what :meth:`Engine.resolve_model` accepts (a
            model, a ``GPTConfig``/``LlamaConfig`` or a registry name such
            as ``"llama:llama2-7b"``): the template, built once, on
            ``device`` in ``dtype`` from ``seed`` when it is not a model.
        num_replicas: fleet width.
        max_redispatch: replays per request; past them the request fails
            with the replica's recorded error.
        max_queue: bound on the queued (not yet admitted) depth summed
            over the active replicas; ``None`` is unbounded.  A full fleet
            raises :class:`~.engine.QueueFull`.
        eject_after_failures: eject a replica once its
            ``consecutive_step_failures`` reaches this (besides a replica
            whose ``health()`` reports ``unhealthy``).
        supervise_every: run the supervision pass every Nth fleet step.
        fault_plan: a shared ``ServingFaultPlan``; each replica checks it
            through a replica-scoped view, so ``serving.r<k>.<point>``
            specs hit replica k only (default: the environment's plan).
        tracer: a :class:`~.tracing.RequestTracer` shared by the router
            and every replica (default: the environment's or the no-op
            tracer).
        journal: a :class:`~.journal.RequestJournal` shared by the router
            and every replica: submissions carry fleet-scoped ids, the
            router writes each request's one final end, and a new process
            can :meth:`recover`.
        isolate_weights: give each replica its own copy of the template's
            parameters, so that :meth:`update_weights` rolls one drained
            replica at a time.  ``None`` (auto) isolates with more than
            one replica when the model can be copied, else shares.  It is
            decided once, here: a copy that fails later (out of memory at
            a rebuild) fails that rebuild and never turns the fleet to
            shared weights.
        shards_per_group: tensor-parallel width of a replica.  Above 1
            every replica is a shard group: ``Engine(mesh=...)`` over its
            own ``shards_per_group`` ranks of the ``torch.distributed``
            world (which must hold ``num_replicas * shards_per_group``
            ranks; every rank builds the same fleet).  The width must be
            on the model's viability ladder (it divides both head
            counts).  A shard group's replicas always own their weights.
        device, dtype, seed: where and how a template built from a config
            or name is made (a model passes through as it is); ``device``
            is also the shard groups' mesh device.
        **engine_kwargs: passed to every replica's ``Engine(...)``
            (``num_slots``, ``max_seq``, ``kv_layout``, ...).  ``name``,
            ``fault_plan``, ``tracer``, ``journal``, ``model_version`` and
            ``mesh`` are the fleet's and raise here.
    """

    #: consecutive failed rebuilds before a replica is marked ``dead``:
    #: a deterministic failure must not spin warmups forever, a transient
    #: one must not shrink the fleet (each retry rides a later pass)
    MAX_REBUILD_ATTEMPTS = 3

    def __init__(self, model_or_config, *, num_replicas: int = 2,
                 max_redispatch: int = 2, max_queue: Optional[int] = None,
                 eject_after_failures: int = 2, supervise_every: int = 1,
                 name: Optional[str] = None, fault_plan=None,
                 tracer=None, journal=None,
                 isolate_weights: Optional[bool] = None,
                 shards_per_group: int = 1, device="cuda",
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 **engine_kwargs):
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, "
                             f"got {num_replicas}")
        if shards_per_group < 1:
            raise ValueError(f"shards_per_group must be >= 1, "
                             f"got {shards_per_group}")
        if max_redispatch < 0:
            raise ValueError("max_redispatch must be >= 0")
        if eject_after_failures < 1:
            raise ValueError("eject_after_failures must be >= 1")
        if supervise_every < 1:
            raise ValueError("supervise_every must be >= 1")
        for k in ("name", "fault_plan", "tracer", "journal",
                  "model_version", "mesh"):
            if k in engine_kwargs:
                raise ValueError(f"{k!r} is fleet-managed; pass it to "
                                 "Fleet, not through engine kwargs")
        self.model = Engine.resolve_model(model_or_config, device=device,
                                          dtype=dtype, seed=seed)
        self.device = device
        self.shards_per_group = int(shards_per_group)
        #: ranks recorded lost at ejection (``engine.lost_devices``): never
        #: handed to a rebuilt mesh again
        self._failed_devices: set = set()
        self._shard_groups(int(num_replicas))
        #: the fleet's weight version (bumped by update_weights; replicas,
        #: rebuilt ones too, join at it)
        self.model_version = 0
        self.weights_isolated = True if self._spmd else self._isolation(
            isolate_weights, num_replicas)
        self.name = name or f"fleet-{next(_fleet_counter)}"
        self.num_replicas = int(num_replicas)
        self.max_redispatch = int(max_redispatch)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.eject_after_failures = int(eject_after_failures)
        self.supervise_every = int(supervise_every)
        self._engine_kwargs = dict(engine_kwargs)
        if fault_plan is None:
            from ..distributed.fault_tolerance.injection import (
                ServingFaultPlan,
            )

            fault_plan = ServingFaultPlan.from_env()
        self.fault_plan = fault_plan
        # one tracer and one journal for the router and every replica: the
        # cross-replica span chain and the exactly-once journal audit link
        # up only when every party records into the same one
        if tracer is None:
            tracer = RequestTracer.from_env() or NULL_TRACER
        self.tracer = tracer
        self.journal = journal
        self.replicas: List[_Replica] = [
            _Replica(k, self._make_engine(k), self._group_mp(k))
            for k in range(self.num_replicas)]
        self.metrics = FleetMetrics(self.name,
                                    num_replicas=self.num_replicas)
        self.metrics.replicas_cb = self._replica_rows
        profiler._register_fleet_metrics(self)
        self.state = "active"            # active | draining | stopped
        #: live attempt -> (fleet request, replica): the reap table
        self._attempts: Dict[Request, Tuple[FleetRequest, _Replica]] = {}
        #: replica-implicated failures reaped with no survivor to take
        #: them, replayed after the supervision pass (which may rebuild
        #: the implicated replica this very tick)
        self._repatriate: List[Tuple[FleetRequest, str]] = []
        self._req_counter = itertools.count()
        self._rr = 0                     # least-loaded tie-break rotation
        self._tick = 0
        #: preemptions of engines that left rotation (live engines are
        #: summed on top in stats())
        self._banked_preemptions = 0
        #: shed submits, once per request
        self._sheds = 0

    # -- shard groups: the world, its groups and the exchange ---------------

    def _shard_groups(self, num_replicas: int) -> None:
        """Check and lay out the shard groups (``shards_per_group > 1``):
        the width on the viability ladder, enough ranks, group g's ranks,
        every group a degrade can reach made now, and each group's mesh
        (None on a rank outside it)."""
        spg = self.shards_per_group
        self._spmd = spg > 1
        #: each group's ranks as built, its current mesh's ranks, its mesh
        self._group_devices: List[Optional[list]] = [None] * num_replicas
        self._group_ranks: List[Optional[list]] = [None] * num_replicas
        self._group_meshes: list = [None] * num_replicas
        #: the live attempts of shard groups, by (replica, fleet request id)
        self._mirrors: Dict[Tuple[int, int], Tuple[_Attempt,
                                                   FleetRequest]] = {}
        #: each group's last exchanged view
        self._views: Dict[int, dict] = {}
        if not self._spmd:
            return
        from ..distributed.mesh import process_group
        from .sharding import serving_mesh, viable_ladder

        kv, nh = self._head_counts()
        ladder = viable_ladder(kv, nh)
        if spg not in ladder:
            raise ValueError(
                f"shards_per_group={spg} is not a viable model-parallel "
                f"degree for this model (kv_heads={kv}, "
                f"num_attention_heads={nh}): the viable ladder is {ladder} "
                f"— every mp must divide both head counts so the KV pool "
                f"shards whole GQA groups")
        world = dist.get_world_size() if dist.is_initialized() else 1
        need = num_replicas * spg
        if world < need:
            raise ValueError(
                f"shards_per_group={spg} with num_replicas={num_replicas} "
                f"needs {need} devices (one rank each, disjoint per-group "
                f"meshes), the torch.distributed world has {world}")
        self._rank = dist.get_rank()
        self._group_devices = [list(range(g * spg, (g + 1) * spg))
                               for g in range(num_replicas)]
        # dist.new_group is collective over the world: a rank lost later
        # could not take part, so every mesh a degrade can reach (the
        # group's first mp ranks, the lost rank being the highest) exists
        # from the start
        for devs in self._group_devices:
            for mp in ladder:
                if mp <= spg:
                    process_group(devs[:mp])
        self._group_ranks = [list(d) for d in self._group_devices]
        self._group_meshes = [serving_mesh(spg, ranks=d, device=self.device)
                              for d in self._group_devices]

    def _head_counts(self) -> Tuple[int, int]:
        """``(kv_heads, num_attention_heads)`` of the served model."""
        cfg = self.model.config
        kv = getattr(cfg, "n_kv_heads", None) or cfg.num_attention_heads
        return int(kv), int(cfg.num_attention_heads)

    def _group_mp(self, index: int) -> int:
        ranks = self._group_ranks[index]
        return 1 if ranks is None else len(ranks)

    def _leads(self, rep: _Replica) -> bool:
        """Whether this rank speaks for ``rep`` in the exchange: the first
        rank of its current mesh (always, without shard groups)."""
        if not self._spmd:
            return True
        return rep.local and self._group_ranks[rep.index][0] == self._rank

    def _world_gather(self, obj) -> list:
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj)
        return out

    def _gather_groups(self, fn: Callable[[_Replica], object],
                       reps: Optional[Sequence[_Replica]] = None
                       ) -> Dict[int, object]:
        """``{replica index: fn(replica)}`` for ``reps`` (default all),
        each computed where the replica's engine runs.  With shard groups
        this is a world exchange: every rank must call it at the same
        point with the same ``reps``."""
        reps = self.replicas if reps is None else reps
        if not self._spmd:
            return {rep.index: fn(rep) for rep in reps}
        # every rank of a group runs fn (it may issue the group's
        # collectives); the first one's value goes out
        mine = {}
        for rep in reps:
            if rep.local:
                value = fn(rep)
                if self._leads(rep):
                    mine[rep.index] = value
        out: Dict[int, object] = {}
        for part in self._world_gather(mine):
            out.update(part)
        return out

    def _view(self, rep: _Replica) -> dict:
        """What a shard group's first rank tells the world after a fleet
        step: its engine's health, load, lost ranks and each live
        attempt's state with the tokens the world has not seen, ``(start,
        tokens)`` (the whole stream from 0 after a preemption restarted
        it)."""
        eng = rep.engine
        attempts = {}
        for fid, ereq in rep.live.items():
            att = self._attempt_of(rep, fid)
            start = 0 if att is None or ereq.preemptions != \
                att.preemptions else len(att.output_ids)
            attempts[fid] = (ereq.state, ereq.error, ereq.error_kind,
                             getattr(ereq, "error_ctx", None),
                             ereq.preempted, ereq.preemptions, start,
                             list(ereq.output_ids[start:]))
        return {"health": eng.health(), "load": rep.load(),
                "lost": list(eng.lost_devices),
                "preemptions": eng.metrics.requests_preempted,
                "attempts": attempts}

    def _attempt_of(self, rep: _Replica, fid: int) -> Optional[_Attempt]:
        entry = self._mirrors.get((rep.index, fid))
        return None if entry is None else entry[0]

    def _sync_attempts(self, reps: Sequence[_Replica]) -> None:
        """The fleet step's world exchange (shard groups): every active
        group's view, applied on every rank in one order: each attempt's
        fields, the new tokens mirrored onto its fleet handle (the user's
        stream callback called for each), and the health the supervision
        reads."""
        views = self._gather_groups(self._view, reps)
        self._views = views
        for rep in reps:
            for fid, st in views[rep.index]["attempts"].items():
                entry = self._mirrors.get((rep.index, fid))
                if entry is None:
                    continue
                att, freq = entry
                (att.state, att.error, att.error_kind, att.error_ctx,
                 att.preempted, preemptions, start, tail) = st
                toks = att.output_ids[:start] + tail
                att.preemptions = preemptions
                if not freq.done and freq._attempt is att:
                    self._mirror_tokens(freq, att, toks)
                att.output_ids = toks
                if att.done:
                    del self._mirrors[(rep.index, fid)]
            # the engine's finished requests leave its live table
            for fid in [f for f, r in rep.live.items() if r.done]:
                del rep.live[fid]

    def _mirror_tokens(self, freq: FleetRequest, att: _Attempt,
                       toks: List[int]) -> None:
        """Put an attempt's new tokens on its fleet handle, calling the
        user's stream callback for each; a restarted stream (a
        preemption) resyncs.  A raising callback fails the request (it is
        never replayed) and cancels the attempt."""
        if toks[:len(freq.output_ids)] != freq.output_ids:
            freq.output_ids = []
        freq.preempted = freq.preempted or att.preempted
        freq.preemptions = att.preemptions
        for tok in toks[len(freq.output_ids):]:
            freq.output_ids.append(int(tok))
            if freq.stream_cb is None:
                continue
            try:
                freq.stream_cb(int(tok), freq)
            except Exception as e:       # noqa: BLE001 — per-request
                att.cancel()
                self._attempts.pop(att, None)
                self._finish(freq, "failed", error=f"stream_cb raised: "
                             f"{type(e).__name__}: {e}")
                return

    # -- replica construction ----------------------------------------------

    def _isolation(self, isolate_weights: Optional[bool],
                   num_replicas: int) -> bool:
        """Whether replicas get their own weights, decided before any is
        built, so that the fleet never mixes copies with the template:
        only the construction of a copy's shell is probed (``None`` falls
        back to shared weights when it fails, ``True`` raises)."""
        if not (num_replicas > 1 if isolate_weights is None
                else isolate_weights):
            return False
        try:
            _meta_model(self.model)
        except Exception as e:           # noqa: BLE001 — capability probe
            if isolate_weights is None:
                return False
            raise TypeError(
                "isolate_weights=True needs a model that can be rebuilt as "
                f"type(model)(model.config) ({type(e).__name__}: {e}); pass "
                "isolate_weights=False to share weights (rolling "
                "update_weights then becomes a stop-the-world swap)") from e
        return True

    def _replica_model(self) -> nn.Module:
        """The model a new replica serves: under weight isolation its own
        copy of the template at the template's current weights (a replica
        rebuilt mid-roll joins at the new ones), else the template.  A
        failed copy raises: at a rebuild it counts toward
        :attr:`MAX_REBUILD_ATTEMPTS`."""
        if not self.weights_isolated:
            return self.model
        return _clone_model(self.model)

    def _make_engine(self, index: int):
        name = f"{self.name}.r{index}"
        mesh = self._group_meshes[index]
        if self._spmd and mesh is None:
            # another group's engine
            return _RemoteEngine(name, self.model_version,
                                 f"model={self._group_mp(index)}")
        return Engine(self._replica_model(), name=name,
                      fault_plan=self.fault_plan.scoped(index),
                      tracer=self.tracer, journal=self.journal,
                      model_version=self.model_version, mesh=mesh,
                      **self._engine_kwargs)

    def warmup(self) -> dict:
        """Warm every active replica (build every step program), so that
        steady serving, and serving on the survivors after a failover,
        builds none."""
        active = [rep for rep in self.replicas if rep.state == "active"]
        got = self._gather_groups(lambda rep: rep.engine.warmup(), active)
        return {rep.engine.name: got[rep.index] for rep in active}

    # -- dispatch ----------------------------------------------------------

    def _active(self, exclude: Sequence[_Replica] = ()) -> List[_Replica]:
        return [r for r in self.replicas
                if r.state == "active" and r not in exclude]

    @staticmethod
    def _adapter_of(freq: FleetRequest) -> Optional[str]:
        """The adapter a request selects (None for the base model): the
        probe runs in that tenant's prefix domain."""
        s = freq.kwargs.get("sampling")
        return getattr(s, "adapter", None) if s is not None else None

    def _choose_replica(self, prompt_ids, exclude: Sequence[_Replica] = (),
                        adapter: Optional[str] = None
                        ) -> Tuple[Optional[_Replica], int]:
        """The dispatch policy: the replica whose prefix cache holds the
        longest prefix of the prompt (ties to the least loaded), else the
        least loaded (ties by rotation).  Returns ``(replica,
        affinity_tokens)``."""
        cands = self._active(exclude)
        if not cands:
            return None, 0
        got = self._gather_groups(
            lambda rep: (rep.engine.prefix_probe(prompt_ids,
                                                 adapter=adapter),
                         rep.load()), cands)
        probed = [(rep, got[rep.index][0]) for rep in cands]

        def load(rep):
            return self._effective_load(rep, got[rep.index][1])

        best_hit = max(hit for _, hit in probed)
        if best_hit > 0:
            tied = [rep for rep, hit in probed if hit == best_hit]
            return min(tied, key=load), best_hit
        self._rr += 1
        k = self._rr % len(cands)
        return min(cands[k:] + cands[:k], key=load), 0

    def _effective_load(self, rep: _Replica,
                        load: Optional[int] = None) -> float:
        """The load dispatch compares: a degraded group's queued and
        running count weighed by ``configured / current`` mp, so the
        full-width groups take more of the traffic."""
        if load is None:
            load = self._gather_groups(_Replica.load, [rep])[rep.index]
        mp = rep.model_parallel()
        if mp >= self.shards_per_group:
            return float(load)
        return load * (self.shards_per_group / max(mp, 1))

    def _wrap_stream(self, freq: FleetRequest):
        """The attempt's stream callback: mirrors its tokens onto the
        fleet handle and calls the user's callback with the fleet handle.
        A raising user callback fails the request in the engine
        (``error_kind="request"``: it is never replayed)."""
        def cb(tok: int, ereq: Request) -> None:
            entry = self._attempts.get(ereq)
            if entry is None or entry[0] is not freq:
                return               # a stale attempt of an ejected replica
            # one append per token; an engine-level preemption restarted
            # the attempt's stream, and a length mismatch resyncs in place
            if len(ereq.output_ids) == len(freq.output_ids) + 1:
                freq.output_ids.append(int(tok))
            else:
                freq.output_ids[:] = ereq.output_ids
            freq.preempted = freq.preempted or ereq.preempted
            freq.preemptions = ereq.preemptions
            if freq.stream_cb is not None:
                freq.stream_cb(int(tok), freq)
        return cb

    def _dispatch(self, freq: FleetRequest,
                  exclude: Sequence[_Replica] = (),
                  pin: Optional[int] = None,
                  redispatch: bool = False) -> None:
        """Place ``freq`` on a replica.  Raises QueueFull/EngineStopped
        when no replica can take it, ValueError (the handle rejected) on
        a request the engine refuses at enqueue."""
        excluded = list(exclude)
        while True:
            if pin is not None:
                if not (0 <= pin < self.num_replicas):
                    msg = (f"replica {pin} out of range "
                           f"[0, {self.num_replicas})")
                    self._finish(freq, "rejected", error=msg)
                    err = ValueError(msg)
                    err.request = freq
                    raise err
                rep = self.replicas[pin]
                if rep.state != "active":
                    raise EngineStopped(
                        f"replica {pin} is {rep.state}: cannot pin")
                affinity = 0
            else:
                rep, affinity = self._choose_replica(
                    freq.prompt_ids, excluded,
                    adapter=self._adapter_of(freq))
                if rep is None:
                    raise EngineStopped(
                        f"fleet {self.name!r} has no active replica "
                        "to dispatch to")
            # the adoption window: the attempt span and the admission
            # record the engine makes inside add_request join this
            # request's trace and its one fleet-scoped journal id
            self.tracer.begin_attempt(freq, rep.engine.name)
            if self.journal is not None:
                if freq.journal_id is None:
                    freq.journal_id = (f"{self.name}:b{self.journal.boot}"
                                       f":f{freq.request_id}")
                self.journal.begin_attempt(
                    freq.journal_id, fleet_owned=True,
                    recovered=freq.recovered,
                    origin_wall=freq._origin_wall)
            try:
                if self._spmd:
                    ereq = self._spmd_add(rep, freq)
                else:
                    ereq = rep.engine.add_request(
                        freq.prompt_ids, stream_cb=self._wrap_stream(freq),
                        **freq.kwargs)
            except ValueError as e:
                # enqueue validation: final, with the engine handle's
                # machine-readable context carried over
                ereq = getattr(e, "request", None)
                if ereq is not None and \
                        getattr(ereq, "error_ctx", None) is not None:
                    freq.error_ctx = dict(ereq.error_ctx)
                self._finish(freq, "rejected",
                             error=getattr(e.request, "error", str(e))
                             if hasattr(e, "request") else str(e))
                e.request = freq
                raise
            except (QueueFull, EngineStopped) as e:
                # this replica cannot take it now: try another
                if isinstance(e, ShedReject):
                    freq._shed_seen = True
                excluded.append(rep)
                if pin is not None or not self._active(excluded):
                    raise
                continue
            finally:
                self.tracer.end_attempt()
                if self.journal is not None:
                    self.journal.end_attempt()
            freq._attempt = ereq
            freq.model_version = rep.engine.model_version
            freq.replica_history.append(rep.engine.name)
            self._attempts[ereq] = (freq, rep)
            self.metrics.on_dispatch(affinity_tokens=affinity,
                                     pinned=pin is not None)
            self.tracer.on_dispatch(freq, rep.engine.name,
                                    redispatch=redispatch,
                                    affinity=affinity)
            return

    def _spmd_add(self, rep: _Replica, freq: FleetRequest) -> _Attempt:
        """A shard group's enqueue: its ranks call ``add_request`` (the
        tokens reach the fleet handle through the exchange, not a
        callback), and the outcome the group's first rank saw, a request
        or the exception, is the outcome on every rank."""
        def add(r: _Replica):
            try:
                r.live[freq.request_id] = r.engine.add_request(
                    freq.prompt_ids, **freq.kwargs)
            except ShedReject as e:
                return ("shed", str(e), e.depth, e.retry_after_s)
            except QueueFull as e:
                return ("full", str(e), e.depth, e.retry_after_s)
            except EngineStopped as e:
                return ("stopped", str(e))
            except ValueError as e:
                er = getattr(e, "request", None)
                return ("invalid", str(e), getattr(er, "error", None),
                        getattr(er, "error_ctx", None))
            return ("ok",)

        out = self._gather_groups(add, [rep])[rep.index]
        if out[0] == "ok":
            att = _Attempt(rep.live.get(freq.request_id))
            self._mirrors[(rep.index, freq.request_id)] = (att, freq)
            return att
        rep.live.pop(freq.request_id, None)
        if out[0] in ("shed", "full"):
            cls = ShedReject if out[0] == "shed" else QueueFull
            raise cls(out[1], out[2], retry_after_s=out[3])
        if out[0] == "stopped":
            raise EngineStopped(out[1])
        err = ValueError(out[1])
        err.request = _Attempt()
        err.request.state = "rejected"
        err.request.error = out[2] if out[2] is not None else out[1]
        err.request.error_ctx = out[3]
        raise err

    # -- public API --------------------------------------------------------

    def submit(self, prompt_ids: Sequence[int], *,
               max_new_tokens: int = 16,
               sampling: Optional[SamplingParams] = None,
               temperature: Optional[float] = None,
               eos_token_id: Optional[int] = None,
               stream_cb: Optional[Callable] = None,
               done_cb: Optional[Callable] = None,
               deadline_s: Optional[float] = None,
               priority=None,
               replica: Optional[int] = None) -> FleetRequest:
        """Enqueue a prompt on the fleet; returns the live
        :class:`FleetRequest`.

        Routing is prefix affinity first, least loaded otherwise;
        ``replica=<k>`` pins it.  A fleet whose queued depth is at
        ``max_queue`` raises :class:`~.engine.QueueFull`; a malformed
        request raises ``ValueError``; the rejected handle rides on the
        exception's ``.request``.  ``deadline_s`` is per attempt (a
        replay is a new prefill); ``priority`` goes into the dispatch
        kwargs verbatim, so a replay keeps its class."""
        if self.state != "active":
            raise EngineStopped(
                f"fleet {self.name!r} is {self.state}: not admitting "
                "new requests")
        self.metrics.on_submit()
        prompt = np.asarray(list(prompt_ids), dtype=np.int64).reshape(-1)
        if sampling is None and temperature is not None:
            sampling = SamplingParams(temperature=temperature)
        kwargs = {"max_new_tokens": int(max_new_tokens),
                  "eos_token_id": eos_token_id,
                  "deadline_s": deadline_s}
        if priority is not None:
            kwargs["priority"] = priority
        if sampling is not None:
            kwargs["sampling"] = sampling
        freq = FleetRequest(prompt_ids=prompt,
                            request_id=next(self._req_counter),
                            stream_cb=stream_cb, done_cb=done_cb,
                            kwargs=kwargs)
        freq.t_submit = time.perf_counter()
        freq._fleet = weakref.ref(self)
        self.tracer.on_submitted(freq, self.name)
        try:
            # normalised for the backpressure estimate only
            prio = _as_priority(kwargs.get("priority", PRIORITY_NORMAL))
        except ValueError as e:
            self._finish(freq, "rejected", error=str(e))
            e.request = freq
            raise
        if self.max_queue is not None:
            got = self._gather_groups(
                lambda rep: (len(rep.engine.queue),
                             rep.engine.estimate_queue_wait_s(prio)),
                self._active())
            depth = sum(q for q, _ in got.values())
            if depth >= self.max_queue:
                # the soonest any active replica expects the backlog ahead
                # of this request's class to clear
                waits = [w for _, w in got.values()]
                retry = round(min(waits), 3) if waits else 0.0
                msg = (f"fleet queue full: {depth} >= "
                       f"max_queue={self.max_queue} across "
                       f"{len(self._active())} active replicas "
                       f"(retry_after_s={retry})")
                freq.error_ctx = {"depth": depth, "retry_after_s": retry}
                self._finish(freq, "rejected", error=msg)
                err = QueueFull(msg, depth, retry_after_s=retry)
                err.request = freq
                raise err
        try:
            self._dispatch(freq, pin=replica)
        except (QueueFull, EngineStopped) as e:
            # no replica could take it: the handle still ends, rejected,
            # exactly once
            if isinstance(e, QueueFull):
                freq.error_ctx = {"depth": e.depth,
                                  "retry_after_s": e.retry_after_s}
            if isinstance(e, ShedReject) or freq._shed_seen:
                self._sheds += 1
            if not freq.done:
                self._finish(freq, "rejected", error=str(e))
            e.request = freq
            raise
        return freq

    def step(self) -> bool:
        """One fleet tick: step every active replica that has work, reap
        its terminal attempts into fleet outcomes, then run the
        supervision pass (eject, replay, rebuild).  True while any
        request is in flight."""
        if self.state == "stopped":
            raise EngineStopped(f"fleet {self.name!r} is stopped")
        serving = [rep for rep in self.replicas
                   if rep.state in ("active", "updating")]
        for rep in serving:
            # an "updating" replica (draining for a weight roll) steps its
            # in-flight work and takes no new dispatch
            if not rep.local:
                continue                 # another rank's group
            eng = rep.engine
            if (eng.queue or eng.running) and eng.state in (
                    "active", "draining"):
                try:
                    eng.step()
                except EngineStopped:
                    pass                 # unhealthy: supervision ejects it
            if not self._spmd:
                self._reap(rep)
        if self._spmd:
            # every group's attempts onto every rank, then one reap order
            self._sync_attempts(serving)
            for rep in serving:
                self._reap(rep)
        self._tick += 1
        if self._tick % self.supervise_every == 0:
            self._supervise()
            # replays parked for want of a survivor go out after the pass,
            # which has given the implicated replica its rebuild
            if self._repatriate:
                batch, self._repatriate = self._repatriate, []
                for freq, err in batch:
                    self._redispatch_or_fail(freq, err)
        return bool(self._attempts or self._repatriate)

    def run(self, max_steps: Optional[int] = None) -> None:
        """Drive :meth:`step` until every request is terminal (or
        ``max_steps``)."""
        n = 0
        while self.step():
            n += 1
            if max_steps is not None and n >= max_steps:
                break

    def generate(self, prompts: Sequence[Sequence[int]], *,
                 max_new_tokens: int = 16, **submit_kwargs
                 ) -> List[List[int]]:
        """Serve a batch of prompts through the fleet; generated ids per
        prompt."""
        reqs = [self.submit(p, max_new_tokens=max_new_tokens,
                            **submit_kwargs) for p in prompts]
        self.run()
        return [r.output_ids for r in reqs]

    # -- outcomes ------------------------------------------------------------

    def _finish(self, freq: FleetRequest, state: str,
                error: Optional[str] = None) -> None:
        """The one fleet-level terminal transition: a second arrival is
        counted on ``duplicate_terminals`` and not applied."""
        if freq.done:
            self.metrics.on_duplicate_terminal()
            return
        freq.state = state
        if error is not None:
            freq.error = error
        freq.t_finish = time.perf_counter()
        freq._attempt = None
        self.metrics.on_terminal(state)
        self.tracer.on_fleet_terminal(freq, state, error)
        if self.journal is not None and freq.journal_id is not None \
                and self.journal.has_admission(freq.journal_id):
            # the one final end of this journal id (an engine's retire of
            # a fleet-owned request ended its attempt only); a submit
            # rejected before any admission is not journaled
            self.journal.record_end(
                freq.journal_id, state, final=True, error=freq.error,
                n_tokens=len(freq.output_ids))
        if freq.done_cb is not None:
            try:
                freq.done_cb(freq)
            except Exception:            # noqa: BLE001 — isolation boundary
                pass

    def _reap(self, rep: _Replica) -> None:
        """Map this replica's terminal attempts onto fleet outcomes:
        finished, user-cancelled and request-fatal failures are final; a
        failure that implicates the replica is replayed within budget."""
        for ereq, (freq, _rep) in list(self._attempts.items()):
            if _rep is not rep or not ereq.done:
                continue
            del self._attempts[ereq]
            if freq.done:                # a late echo of a settled request
                continue
            freq._attempt = None
            if getattr(ereq, "error_ctx", None) is not None and \
                    freq.error_ctx is None:
                freq.error_ctx = dict(ereq.error_ctx)
            if ereq.state == "finished":
                self._finish(freq, "finished")
            elif ereq.state == "cancelled":
                if freq._cancel:
                    self._finish(freq, "cancelled")
                elif ereq.error_kind == "replica":
                    # the engine's lifecycle cancelled it under the fleet
                    self._replay(freq, ereq.error, rep)
                else:
                    self._finish(freq, "cancelled", error=ereq.error)
            elif ereq.state == "failed":
                if ereq.error_kind == "replica":
                    self._replay(freq, ereq.error, rep)
                else:
                    self._finish(freq, "failed", error=ereq.error)
            else:                        # "rejected" cannot happen here
                self._finish(freq, ereq.state, error=ereq.error)

    def _replay(self, freq: FleetRequest, error: Optional[str],
                rep: _Replica) -> None:
        """A reaped replica-implicated failure goes to a survivor when
        there is one (never straight back onto the implicated replica),
        else waits for the supervision pass, so a one-replica fleet
        replays on its rebuilt engine."""
        if self._active((rep,)):
            self._redispatch_or_fail(freq, error, exclude=(rep,))
        else:
            self._repatriate.append((freq, error))

    def _redispatch_or_fail(self, freq: FleetRequest,
                            error: Optional[str],
                            exclude: Sequence[_Replica] = ()) -> None:
        """Replay ``freq`` from its prompt on another replica within the
        ``max_redispatch`` budget; past it, fail with the replica's
        error.  The markers flip and ``output_ids`` reset before the
        replay's token 0 can arrive."""
        if freq.done:
            return                       # settled while parked
        if freq._cancel:
            self._finish(freq, "cancelled")
            return
        if freq.redispatches >= self.max_redispatch:
            self._finish(
                freq, "failed",
                error=f"redispatch budget exhausted "
                      f"({self.max_redispatch}); last replica error: "
                      f"{error}")
            return
        freq.redispatches += 1
        freq.redispatched = True
        freq.output_ids = []
        self.metrics.on_redispatch()
        try:
            self._dispatch(freq, exclude=exclude, redispatch=True)
        except (QueueFull, EngineStopped) as e:
            self._finish(freq, "failed",
                         error=f"redispatch found no replica: {e}; "
                               f"original replica error: {error}")
        except ValueError:
            pass                         # _dispatch rejected it already

    def _on_cancel(self, freq: FleetRequest) -> None:
        att = freq._attempt
        if att is not None:
            att.cancel()                 # reaped as cancelled next step
        elif not freq.done:
            self._finish(freq, "cancelled")

    # -- supervision -------------------------------------------------------

    def _supervise(self) -> None:
        """Eject the unhealthy and the failing replicas (their requests
        collected for replay), rebuild every ejected replica, then replay
        the orphans on the healed fleet."""
        orphans: List[Tuple[FleetRequest, str]] = []
        orphan_jids: Dict[int, List[str]] = {}
        serving = [rep for rep in self.replicas
                   if rep.state in ("active", "updating")]
        # also audits each block pool
        healths = self._gather_groups(lambda rep: rep.engine.health(),
                                      serving)
        for rep in serving:
            h = healths[rep.index]
            if h["state"] == "unhealthy":
                reason = h.get("reason") or "unhealthy"
            elif h["consecutive_step_failures"] >= \
                    self.eject_after_failures:
                reason = (f"{h['consecutive_step_failures']} consecutive "
                          "compiled-step failures")
            else:
                continue
            mine = self._eject(rep, reason)
            orphans.extend(mine)
            orphan_jids[rep.index] = [freq.journal_id for freq, _ in mine
                                      if freq.journal_id is not None]
        for rep in self.replicas:
            if rep.state == "ejected":
                self._rebuild(rep, orphan_jids.get(rep.index, ()))
        for freq, err in orphans:
            self._redispatch_or_fail(freq, err)

    def _eject(self, rep: _Replica, reason: str
               ) -> List[Tuple[FleetRequest, str]]:
        """Take a replica out of rotation: export its queued and running
        requests for replay, shut its engine down (joining its watchdog),
        free what it holds on the device, and record why."""
        rep.state = "ejected"
        rep.ejections += 1
        rep._eject_t = time.perf_counter()
        rep.last_error = reason
        eng = rep.engine
        if self._spmd:
            return self._eject_group(rep, reason)
        # its preemptions are banked (the rebuilt engine counts from 0)
        # and its flight ring frozen: the post-mortem outlives it
        self._banked_preemptions += eng.metrics.requests_preempted
        rep.flight_dumps.append(eng.flight.dump(f"ejected: {reason}"))
        del rep.flight_dumps[:-8]        # the newest 8
        self.metrics.on_eject()
        self.tracer.on_eject(eng.name, reason)
        err = f"replica {eng.name!r} ejected: {reason}"
        orphans = []
        for ereq in eng.export_requests():
            entry = self._attempts.pop(ereq, None)
            if entry is None:
                continue
            freq = entry[0]
            freq._attempt = None
            if not freq.done:
                orphans.append((freq, err))
        try:
            eng.shutdown(timeout_s=0.0)
        except Exception:                # noqa: BLE001 — already ejected
            pass
        # its graphs, KV pool and (isolated) weights go before the
        # successor allocates: on one card both would not fit
        eng._release_device()
        return orphans

    def _eject_group(self, rep: _Replica, reason: str
                     ) -> List[Tuple[FleetRequest, str]]:
        """A shard group's ejection, the same on every rank: its lost
        ranks (from the last exchange) leave the pool, its attempts are
        the orphans; its ranks export, stop and release the engine."""
        view = self._views.get(rep.index, {})
        self._failed_devices.update(view.get("lost", ()))
        self._banked_preemptions += view.get("preemptions", 0)
        eng = rep.engine
        if rep.local:
            rep.flight_dumps.append(eng.flight.dump(f"ejected: {reason}"))
            del rep.flight_dumps[:-8]
        self.metrics.on_eject()
        self.tracer.on_eject(eng.name, reason)
        err = f"replica {eng.name!r} ejected: {reason}"
        orphans = []
        for att, (freq, r) in list(self._attempts.items()):
            if r is not rep:
                continue
            del self._attempts[att]
            self._mirrors.pop((rep.index, freq.request_id), None)
            freq._attempt = None
            if not freq.done:
                orphans.append((freq, err))
        if rep.local:
            eng.export_requests()
            try:
                eng.shutdown(timeout_s=0.0)
            except Exception:            # noqa: BLE001 — already ejected
                pass
            eng._release_device()
        rep.live.clear()
        return orphans

    def _degrade_plan(self, rep: _Replica):
        """A shard group's rebuild mesh: ``(ranks, old_mp, new_mp,
        old_key)`` with ``new_mp < old_mp`` when its survivors no longer
        hold its mesh (the largest viable mp on them), ``(ranks, None,
        None, None)`` when they do, or None when not even mp 1 fits."""
        from .sharding import degrade_step

        ranks = self._group_ranks[rep.index]
        survivors = [d for d in self._group_devices[rep.index]
                     if d not in self._failed_devices]
        old_mp = len(ranks)
        if all(r in survivors for r in ranks):
            return ranks, None, None, None
        kv, nh = self._head_counts()
        new_mp = degrade_step(kv, nh, len(survivors))
        if new_mp is None:
            return None
        return survivors[:new_mp], old_mp, new_mp, f"model={old_mp}"

    def _rebuild(self, rep: _Replica,
                 orphan_jids: Sequence[str] = ()) -> None:
        """Heal an ejected replica: a new engine (new pool, prefix cache
        and programs) at the fleet's current weights, warmed, back in
        rotation.  The eject-to-rejoin wall time is the failover
        recovery.

        A shard group whose ranks were lost is rebuilt degraded: at the
        largest viable mp its surviving ranks hold (the mesh of its first
        survivors, made at construction), the shape change journaled as
        a ``mesh_reshard`` record, counted and traced.  With no survivor
        the group is ``dead``, its error naming the viability ladder."""
        degrade = None
        if self._spmd:
            from .sharding import serving_mesh, viable_ladder

            plan = self._degrade_plan(rep)
            if plan is None:
                kv, nh = self._head_counts()
                rep.state = "dead"
                survivors = [d for d in self._group_devices[rep.index]
                             if d not in self._failed_devices]
                rep.last_error = (
                    f"no viable degraded mesh: {len(survivors)} surviving "
                    f"device(s) in the group, viable ladder "
                    f"{viable_ladder(kv, nh)}")
                self.metrics.on_rebuild(0.0, ok=False)
                self.tracer.on_rebuild(rep.engine.name, 0.0, ok=False)
                return
            ranks, old_mp, new_mp, old_key = plan
            if new_mp is not None:
                degrade = (old_mp, new_mp, old_key)
            self._group_ranks[rep.index] = ranks
            self._group_meshes[rep.index] = serving_mesh(
                len(ranks), ranks=ranks, device=self.device)
        try:
            if self._spmd:
                eng = self._build_group(rep)
            else:
                eng = self._make_engine(rep.index)
                eng.warmup()
        except Exception as e:           # noqa: BLE001 — isolation boundary
            rep.rebuild_attempts += 1
            rep.state = ("dead" if rep.rebuild_attempts >=
                         self.MAX_REBUILD_ATTEMPTS else "ejected")
            rep.last_error = (f"rebuild failed "
                              f"({rep.rebuild_attempts}/"
                              f"{self.MAX_REBUILD_ATTEMPTS}): "
                              f"{type(e).__name__}: {e}")
            self.metrics.on_rebuild(0.0, ok=False)
            self.tracer.on_rebuild(rep.engine.name, 0.0, ok=False)
            return
        rep.engine = eng
        rep.mp = self._group_mp(rep.index)
        rep.state = "active"
        rep.rebuilds += 1
        rep.rebuild_attempts = 0
        recovery = time.perf_counter() - (rep._eject_t or
                                          time.perf_counter())
        rep._eject_t = None
        self.metrics.on_rebuild(recovery)
        self.tracer.on_rebuild(eng.name, recovery)
        if degrade is not None:
            old_mp, new_mp, old_key = degrade
            rep.degraded = new_mp < self.shards_per_group
            self.metrics.on_degrade(old_mp, new_mp, recovery)
            self.tracer.on_degrade(eng.name, old_mp, new_mp, recovery)
            if self.journal is not None:
                self.journal.record_mesh_reshard(
                    eng.name, old_key, eng.mesh_shape,
                    {jid: "redispatched" for jid in orphan_jids})

    def _build_group(self, rep: _Replica):
        """A shard group's new engine, built and warmed by the ranks of
        its new mesh (a stand-in elsewhere); a failure on its first rank
        is the failure on every rank."""
        eng = self._make_engine(rep.index)

        def warm(r: _Replica):
            try:
                eng.warmup()
            except Exception as e:       # noqa: BLE001 — agreed below
                return f"{type(e).__name__}: {e}"
            return None

        probe = _Replica(rep.index, eng)
        err = self._gather_groups(warm, [probe])[rep.index]
        if err is not None:
            if probe.local:
                eng._release_device()
            raise RuntimeError(err)
        return eng

    # -- durability: crash recovery and the rolling weight swap ------------

    def recover(self, journal=None) -> dict:
        """Replay every unfinished request of a crashed process's journal
        across the fleet, from its prompt (``recovered`` set, its stream
        restarting at token 0, seeded from the journaled effective seed:
        greedy and seeded streams equal an uninterrupted run's), under
        its original journal id, so that the journal's exactly-once audit
        spans the crash.  The journal's final outcomes are banked into
        the metrics.  Call after :meth:`warmup`, before new traffic.
        Returns ``{"replayed", "requests", "outcomes", "recovery_ms"}``.

        With shard groups each rank journals its own group's requests, so
        every rank calls this with its own reopened journal: the pending
        sets and final outcomes of all the world's journals are gathered
        first (a request final on any rank is final), and every rank
        replays the union in one order, by admission wall time, as the
        world's routers take every decision in one order.  Each replay is
        journaled by the ranks of the group it lands on; a rank whose
        journal held the request's old admission records its final end
        too, so every journal's pending set drains."""
        journal = journal if journal is not None else self.journal
        if journal is None:
            raise ValueError("recover() needs a RequestJournal (pass "
                             "journal= here or to the Fleet)")
        if self.state != "active":
            raise EngineStopped(
                f"fleet {self.name!r} is {self.state}: cannot recover")
        busy = self._gather_groups(
            lambda rep: bool(rep.engine.queue or rep.engine.running),
            [rep for rep in self.replicas
             if rep.state in ("active", "updating")])
        if self._attempts or self._repatriate or any(busy.values()):
            # a replay under a live request's journal id would be a second
            # terminal of that id
            raise RuntimeError(
                "recover() must run before serving traffic: the fleet "
                f"has {self.pending} request(s) in flight whose journal "
                "ids the replay would duplicate")
        if self.journal is None:
            self.journal = journal
            for rep in self.replicas:
                rep.engine.journal = journal
        elif journal is not self.journal:
            raise ValueError(
                "recover(journal=...) does not match the journal this "
                "fleet records into; recover into the SAME journal the "
                "fleet was constructed with (or construct the fleet "
                "with the journal being recovered)")
        t0 = time.perf_counter()
        if self._spmd:
            pending, outcomes = self._world_journal(journal)
        else:
            pending, outcomes = journal.pending(), journal.outcomes()
        self.metrics.bank_outcomes(outcomes)
        replayed = [self._submit_recovered(jid, rec)
                    for jid, rec in pending.items()]
        dt = time.perf_counter() - t0
        self.metrics.on_crash_recovery(len(replayed), dt)
        return {"replayed": len(replayed), "requests": replayed,
                "outcomes": outcomes,
                "recovery_ms": round(dt * 1e3, 3)}

    def _world_journal(self, journal) -> Tuple["OrderedDict", dict]:
        """The world's pending requests (in admission wall-time order) and
        final outcome counts, gathered from every rank's journal: each
        request counted once, a request final on any rank not pending.
        Every rank gets the same lists and merges them the same way.  The
        counts of compacted segments come from each group's first
        rank."""
        leads = self._rank in {ranks[0] for ranks in self._group_ranks
                               if ranks}
        parts = self._world_gather(
            (list(journal.pending().items()), journal.final_states(),
             journal.compacted_outcomes() if leads else {}))
        finals: Dict[str, str] = {}
        outcomes: Dict[str, int] = {}
        for _, fin, compacted in parts:
            finals.update(fin)
            for st, n in compacted.items():
                outcomes[st] = outcomes.get(st, 0) + n
        for st in finals.values():
            outcomes[st] = outcomes.get(st, 0) + 1
        pending: Dict[str, dict] = {}
        for pend, _, _ in parts:
            for jid, rec in pend:
                if jid not in finals and jid not in pending:
                    pending[jid] = rec
        order = sorted(pending.items(),
                       key=lambda kv: (kv[1].get("wall") or 0.0, kv[0]))
        return OrderedDict(order), outcomes

    def _submit_recovered(self, jid: str, rec: dict) -> FleetRequest:
        """One journal replay: a new handle with the original journal id
        and the journaled recipe, dispatched outside ``max_queue`` (the
        work was accepted once already)."""
        s = self.journal.replay_sampling(rec)
        kwargs = {"max_new_tokens": rec["max_new_tokens"],
                  "eos_token_id": rec["eos_token_id"],
                  "deadline_s": rec["deadline_s"],
                  "priority": rec["priority"],
                  "sampling": SamplingParams(**s)}
        freq = FleetRequest(
            prompt_ids=np.asarray(rec["prompt_ids"],
                                  dtype=np.int64).reshape(-1),
            request_id=next(self._req_counter), kwargs=kwargs)
        freq.journal_id = jid
        freq.recovered = True
        freq._origin_wall = rec.get("wall")
        freq.t_submit = time.perf_counter()
        freq._fleet = weakref.ref(self)
        self.metrics.on_submit()
        self.tracer.on_submitted(freq, self.name)
        problem = self._replay_tenancy_problem(rec, s)
        if problem is not None:
            # a replay that cannot run on the journaled adapter version or
            # grammar fails alone; the rest replay
            msg, ctx = problem
            freq.error_ctx = ctx
            self._finish(freq, "failed", error=msg)
            return freq
        try:
            self._dispatch(freq)
        except (QueueFull, EngineStopped) as e:
            if not freq.done:
                self._finish(freq, "failed",
                             error=f"recovery dispatch found no "
                                   f"replica: {e}")
        except ValueError:
            pass                         # _dispatch rejected it already
        return freq

    def _replay_tenancy_problem(self, rec: dict, s: dict):
        """``None`` when the journaled replay can run as it did (its
        adapter loaded at the journaled version on some active replica,
        its grammar registered on one), else ``(message, error_ctx)``."""
        a = s.get("adapter")
        if a is not None:
            want = rec.get("adapter_version")

            def version(rep: _Replica):
                pool = rep.engine.adapter_pool
                if pool is None:
                    return None
                try:
                    return pool.resolve(a)[1]
                except KeyError:
                    return None

            got = self._gather_groups(version, self._active())
            if not any(v is not None and (want is None or v == want)
                       for v in got.values()):
                return (f"recovery replay rejected: journaled adapter "
                        f"{a!r} (v{want}) is not loaded at that version "
                        f"on any active replica",
                        {"adapter": a, "version": want})
        g = s.get("grammar")
        if g is not None:
            got = self._gather_groups(
                lambda rep: rep.engine.grammar_table is not None
                and g in rep.engine.grammar_table.names, self._active())
            if not any(got.values()):
                return (f"recovery replay rejected: journaled grammar "
                        f"{g!r} is not registered on any active "
                        f"replica", {"grammar": g})
        return None

    def load_adapter(self, name: str, weights, *, scale: float = 1.0
                     ) -> int:
        """Load (or hot-swap) a LoRA adapter onto every active replica, so
        any replica can serve any tenant.  Returns its version.  A replica
        rebuilt after a failure comes back without adapters: load them
        again through this method."""
        if self.state != "active":
            raise EngineStopped(
                f"fleet {self.name!r} is {self.state}: cannot load "
                "adapters")
        got = self._gather_groups(
            lambda rep: rep.engine.load_adapter(name, weights, scale=scale),
            [r for r in self.replicas if r.state in ("active", "updating")])
        version = max(got.values()) if got else None
        if version is None:
            raise EngineStopped(
                f"fleet {self.name!r} has no active replica to load "
                f"adapter {name!r} onto")
        return version

    def unload_adapter(self, name: str) -> int:
        """Unload an adapter from every active replica; its in-flight
        requests fail with ``error_ctx`` (carried onto their fleet
        handles by the reap)."""
        if self.state != "active":
            raise EngineStopped(
                f"fleet {self.name!r} is {self.state}: cannot unload "
                "adapters")
        got = self._gather_groups(
            lambda rep: rep.engine.unload_adapter(name),
            [r for r in self.replicas if r.state in ("active", "updating")])
        version = max(got.values()) if got else None
        if version is None:
            raise EngineStopped(
                f"fleet {self.name!r} has no active replica to unload "
                f"adapter {name!r} from")
        return version

    def update_weights(self, state_or_path, *,
                       max_drain_steps: Optional[int] = None) -> dict:
        """Roll new weights through the fleet.

        Under weight isolation the replicas leave dispatch one at a time
        (state ``updating``), drain their in-flight work while the others
        go on serving the old weights, and take the new ones written in
        place through their own parameters (``Engine.update_weights``),
        so every captured graph stays valid and no program is built.  Each
        swap bumps the replica's prefix-cache epoch and tags it with the
        fleet's new version.  The template is written first, so a replica
        rebuilt mid-roll comes back at the new version.  With shared
        weights the roll is a stop-the-world swap: every replica drains,
        then the one write lands.

        ``max_drain_steps`` bounds each drain (RuntimeError past it; the
        fleet is left serving, partly rolled).  Accepts what
        ``Engine.update_weights`` accepts.  Returns ``{"model_version",
        "replicas_updated", "roll_ms"}``."""
        if self.state != "active":
            raise EngineStopped(
                f"fleet {self.name!r} is {self.state}: cannot roll "
                "weights")
        sd = _resolve_weights(state_or_path, self.model)
        new_version = self.model_version + 1
        t0 = time.perf_counter()
        updated = 0
        if self.weights_isolated:
            _write_state_dict(self.model, sd)
            self.model_version = new_version
            for rep in list(self.replicas):
                if rep.state != "active":
                    continue             # ejected or dead: rebuilds join
                rep.state = "updating"   # at the template's new weights
                try:
                    self._drain_replica(rep, max_drain_steps)
                    if rep.state == "updating":
                        self._gather_groups(
                            lambda r: r.engine.update_weights(
                                sd, version=new_version), [rep])
                        rep.engine.model_version = new_version
                        updated += 1
                finally:
                    if rep.state == "updating":
                        rep.state = "active"
        else:
            marked = [r for r in self.replicas if r.state == "active"]
            for rep in marked:
                rep.state = "updating"
            try:
                for rep in marked:
                    self._drain_replica(rep, max_drain_steps)
            finally:
                for rep in marked:
                    if rep.state == "updating":
                        rep.state = "active"
            _write_state_dict(self.model, sd)
            self.model_version = new_version
            for rep in marked:
                # one write through the shared tensors; each engine still
                # gets its own epoch and version
                if rep.state == "active" and not (
                        rep.engine.queue or rep.engine.running):
                    rep.engine._mark_weights_swapped(new_version)
                    updated += 1
        dt = time.perf_counter() - t0
        self.metrics.on_weight_roll(new_version, dt)
        self.tracer.on_weight_roll(self.name, new_version, dt, updated)
        return {"model_version": new_version,
                "replicas_updated": updated,
                "roll_ms": round(dt * 1e3, 3)}

    def _drain_replica(self, rep: _Replica,
                       max_drain_steps: Optional[int]) -> None:
        """Drive fleet steps until ``rep`` holds no queued or running
        work (the whole fleet steps; only new dispatches avoid ``rep``).
        An ejection mid-drain ends it: the rebuilt engine is empty."""
        def busy() -> int:
            if rep.state != "updating":
                return 0
            return self._gather_groups(_Replica.load, [rep])[rep.index]

        n = 0
        while busy():
            self.step()
            n += 1
            if max_drain_steps is not None and n >= max_drain_steps:
                raise RuntimeError(
                    f"replica {rep.engine.name!r} did not drain within "
                    f"{max_drain_steps} fleet steps (still {busy()} "
                    f"running or queued)")

    # -- lifecycle ---------------------------------------------------------

    def drain(self, max_steps: Optional[int] = None) -> dict:
        """Stop admitting, finish every in-flight request (supervision,
        ejection and rebuild included, goes on), stop the replicas, and
        return the final stats snapshot."""
        if self.state == "active":
            self.state = "draining"
        n = 0
        while (self._attempts or self._repatriate) and \
                self.state == "draining":
            self.step()
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        active = [rep for rep in self.replicas if rep.state == "active"]
        for rep in active:
            if rep.local:
                rep.engine.drain()
        # the engines' drains may have finished work the loop never saw
        # (max_steps cut it short): reap it, so every done_cb fires
        if self._spmd:
            self._sync_attempts(active)
        for rep in active:
            self._reap(rep)
        if not (self._attempts or self._repatriate):
            self.state = "stopped"
        return self.stats()

    def shutdown(self, timeout_s: Optional[float] = None) -> dict:
        """Drain within a wall-clock budget, then cancel what is still
        unfinished and stop every replica."""
        if self.state == "active":
            self.state = "draining"
        deadline = None if timeout_s is None \
            else time.perf_counter() + float(timeout_s)
        while (self._attempts or self._repatriate) and \
                self.state == "draining":
            if deadline is not None and time.perf_counter() >= deadline:
                break
            self.step()
        for ereq, (freq, _rep) in list(self._attempts.items()):
            del self._attempts[ereq]
            self._finish(freq, "cancelled", error="fleet shutdown")
        for freq, _err in self._repatriate:
            if not freq.done:
                self._finish(freq, "cancelled", error="fleet shutdown")
        self._repatriate.clear()
        for rep in self.replicas:
            if rep.state == "active" and rep.local:
                try:
                    rep.engine.shutdown(timeout_s=0.0)
                except Exception:        # noqa: BLE001 — best effort
                    pass
        self.state = "stopped"
        return self.stats()

    # -- observability -----------------------------------------------------

    @property
    def pending(self) -> int:
        """Accepted requests not yet terminal."""
        return len(self._attempts) + len(self._repatriate)

    @staticmethod
    def _engine_row(rep: _Replica) -> dict:
        """The part of a replica's row its engine knows."""
        eng = rep.engine
        m = eng.metrics
        last = rep.flight_dumps[-1] if rep.flight_dumps else None
        return {
            "engine_state": eng.state,
            "queue_depth": len(eng.queue),
            "slots_busy": len(eng.running),
            "slots_total": eng.num_slots,
            "occupancy": round(m.occupancy(), 4),
            "compile_misses": m.compile_misses,
            "mesh_shape": eng.mesh_shape,
            "preemptions": m.requests_preempted,
            "shed": m.requests_shed,
            # a summary of the dump frozen at the last ejection
            "last_flight_record": (
                None if last is None else
                {"reason": last["reason"],
                 "steps_seen": last["steps_seen"],
                 "events": len(last["events"])}),
        }

    def _replica_rows(self) -> List[dict]:
        # a shard group's engine row comes from its first rank (a world
        # exchange); an ejected or dead group's from the engine it left
        live = [rep for rep in self.replicas if rep.local or self._spmd]
        got = self._gather_groups(self._engine_row, live)
        rows = []
        for rep in self.replicas:
            row = {"index": rep.index, "name": rep.engine.name,
                   "state": rep.state, "ejections": rep.ejections,
                   "rebuilds": rep.rebuilds, "last_error": rep.last_error,
                   "model_parallel": rep.model_parallel(),
                   "degraded": rep.degraded}
            row.update(got.get(rep.index, {}))
            rows.append(row)
        return rows

    def _overload_section(self) -> dict:
        """Preemptions of every engine the fleet ran (banked from the
        ejected ones) and the fleet's shed submits (once per request)."""
        got = self._gather_groups(
            lambda rep: rep.engine.metrics.requests_preempted,
            [rep for rep in self.replicas if rep.state == "active"])
        pre = self._banked_preemptions + sum(got.values())
        return {"preemptions": pre, "shed": self._sheds}

    def health(self) -> dict:
        """Fleet liveness: its state, pending depth and each replica's
        ``health()``."""
        got = self._gather_groups(lambda rep: rep.engine.health())
        return {
            "state": self.state,
            "pending": self.pending,
            "active_replicas": len(self._active()),
            "replicas": {rep.engine.name: {
                "replica_state": rep.state,
                **got.get(rep.index, {}),
            } for rep in self.replicas},
        }

    def stats(self) -> dict:
        """``/stats``-style snapshot: the fleet metrics and each
        replica's engine snapshot."""
        out = self.metrics.snapshot()
        out["state"] = self.state
        out["pending"] = self.pending
        out["durability"]["weights_isolated"] = self.weights_isolated
        if self.journal is not None:
            out["durability"]["journal"] = self.journal.stats()
        out["overload"] = self._overload_section()
        # the degraded view: each group's current and configured mp and
        # the ranks the fleet has written off
        out["degraded"]["failed_devices"] = len(self._failed_devices)
        out["degraded"]["groups"] = {
            rep.engine.name: {"model_parallel": rep.model_parallel(),
                              "configured": self.shards_per_group,
                              "degraded": rep.degraded, "state": rep.state}
            for rep in self.replicas}
        if self.tracer.enabled:
            out["tracing"] = self.tracer.snapshot()
        got = self._gather_groups(lambda rep: rep.engine.stats())
        out["engines"] = {rep.engine.name: got[rep.index]
                          for rep in self.replicas if rep.index in got}
        return out
