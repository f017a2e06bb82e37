"""Request-lifecycle tracing: the per-request story the aggregate
metrics cannot tell.

The port's copy of ``paddle_tpu/serving/tracing.py``.  ``ServingMetrics``
says *how many* requests were preempted and what the p99 TTFT was; it
cannot say that request 17 was admitted into slot 2, preempted by a
high-priority arrival, resumed as a prefix hit and retired 400 ms late.
:class:`RequestTracer` records exactly that story as a span/event chain
for every request moving through an :class:`~.engine.Engine`:

``queued -> admitted(bucket, slot, prefix_hit) -> decode steps (batched,
one event per engine step, not per token) -> retired(state)``

with *linked* spans for ``preempt``/resume and ``shed``: a preempted
request's next attempt is a child span of the interrupted one, so the
whole story reconstructs from parent pointers alone.  The fleet-facing
hooks (submit, dispatch, eject, rebuild) are kept for the fleet the port
does not have yet.

House invariants, enforced by construction:

- **Pure host-side bookkeeping.**  Nothing here touches a device tensor
  or enters a step program: events record ints and floats the scheduler
  already holds, so tracing adds no program and no device-to-host sync.
- **Monotonic clock.**  Every event is stamped from
  ``time.perf_counter()`` relative to the tracer's start; a wall-clock
  anchor pair is captured once so *exporters* can emit wall-clock
  timestamps without any event doing latency math on ``time.time()``.
- **Near-zero overhead when off.**  The engine's default tracer is the
  module-level :data:`NULL_TRACER` (every method a no-op, ``enabled``
  False so hot-path call sites skip even argument construction); opt in
  per engine (``tracer=RequestTracer()``) or process-wide via
  ``PADDLE_TPU_TRACE=1``.
- **Bounded memory.**  At most ``max_events`` events are retained; past
  the cap events are counted as ``dropped`` (and the chain validator
  refuses to certify a trace with drops).

:class:`FlightRecorder` (re-exported from :mod:`..obs.flight`) is the
always-on companion: a bounded ring of the last N engine-step summaries.
Exporters live in :mod:`paddle_tpu_torch.obs` (Chrome/Perfetto trace
JSON, JSONL event log, metrics text); :func:`validate_trace` is the
chain validator.
"""
from __future__ import annotations

import itertools
import os
import time
import weakref
from typing import Dict, List, Optional

from ..obs.flight import FlightRecorder  # noqa: F401  (re-export)

__all__ = ["RequestTracer", "NullTracer", "NULL_TRACER", "FlightRecorder",
           "validate_trace", "TERMINAL_SPAN_STATES", "live_tracers"]

#: weak registry of every live enabled tracer: a crash-dump path finds
#: armed traces through it without holding them alive
_LIVE_TRACERS = weakref.WeakSet()


def live_tracers():
    """Every live :class:`RequestTracer` in the process (weakly held,
    registration order not guaranteed) — the crash-dump surface."""
    return list(_LIVE_TRACERS)

#: States an attempt span may legally end in.  ``preempted`` and
#: ``exported`` are *non-final* ends — the request continues on a child
#: span; everything else ends the attempt for good.
TERMINAL_SPAN_STATES = frozenset({
    "finished", "failed", "cancelled", "rejected", "preempted",
    "exported"})


def _noop(*_args, **_kwargs) -> None:
    return None


class NullTracer:
    """The disabled tracer: every hook a no-op, ``enabled`` False so
    hot-path call sites (the per-step decode event) skip argument
    construction entirely.  One shared instance (:data:`NULL_TRACER`)
    serves every untraced engine — tracing off costs one attribute read
    per lifecycle edge and nothing per decode step."""

    enabled = False
    events: tuple = ()
    dropped = 0

    def __getattr__(self, _name):
        return _noop


#: The shared disabled tracer every Engine/Fleet defaults to.
NULL_TRACER = NullTracer()


class RequestTracer:
    """Host-side span/event recorder for serving request lifecycles.

    One tracer may be shared by a whole fleet (every replica engine
    plus the router): events carry the replica (engine name), spans
    carry parent pointers, and request identity is a ``trace`` id —
    fleet-rooted (``"<fleet>:f<id>"``) when the router submitted the
    request, engine-local (``"<engine>:r<id>"``) otherwise.

    The scheduler is single-threaded, so no locking is needed; the only
    cross-thread writer is the watchdog's ``unhealthy`` event, and
    ``list.append`` is atomic under the GIL.

    Args:
        max_events: retention bound; events past it are dropped (and
            counted — :func:`validate_trace` fails on any drop).
    """

    enabled = True

    def __init__(self, max_events: int = 200_000):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = int(max_events)
        #: monotonic origin; every event ``ts`` is seconds since this
        self.t0 = time.perf_counter()
        #: wall-clock anchor captured ONCE for exporters — events
        #: themselves never carry (or compute with) wall-clock time
        self.wall0 = time.time()
        self.events: List[dict] = []
        self.dropped = 0
        self.spans: Dict[int, dict] = {}
        self._span_ids = itertools.count(1)
        # live-request bookkeeping (weak: a tracer must never keep a
        # retired request — or its engine — alive)
        self._req_span = weakref.WeakKeyDictionary()    # Request -> span
        self._req_trace = weakref.WeakKeyDictionary()   # Request -> trace
        self._root_span = weakref.WeakKeyDictionary()   # FleetRequest -> span
        self._last_attempt = weakref.WeakKeyDictionary()  # FleetRequest -> sp
        #: trace ids rooted by a fleet submit: engine-level retires on
        #: them are span ends, not trace terminals (the fleet's
        #: ``_finish`` emits the one final event)
        self._fleet_traces: set = set()
        #: pending adoption set by the router around one add_request
        #: call: ``(fleet_request, trace_id, parent_span)``
        self._pending = None
        _LIVE_TRACERS.add(self)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_env(cls) -> Optional["RequestTracer"]:
        """The env-armed tracer (``PADDLE_TPU_TRACE=1``), or None when
        tracing is off (the default: the engine falls back to
        :data:`NULL_TRACER`)."""
        v = os.environ.get("PADDLE_TPU_TRACE", "").strip().lower()
        if v in ("", "0", "false", "off", "no"):
            return None
        if v in ("1", "true", "on", "yes"):
            return cls()
        raise ValueError(f"PADDLE_TPU_TRACE={v!r}: expected 1/on to "
                         "enable or 0/off to disable")

    # -- core recording -----------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self.t0

    def _event(self, kind: str, trace: Optional[str] = None,
               span: Optional[int] = None, replica: Optional[str] = None,
               **attrs) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        ev = {"ts": self._now(), "kind": kind}
        if trace is not None:
            ev["trace"] = trace
        if span is not None:
            ev["span"] = span
        if replica is not None:
            ev["replica"] = replica
        if attrs:
            ev.update(attrs)
        self.events.append(ev)

    def _begin_span(self, trace: str, name: str,
                    parent: Optional[int] = None,
                    replica: Optional[str] = None) -> int:
        sid = next(self._span_ids)
        if len(self.spans) >= self.max_events:
            # span table shares the event budget: past the capture
            # window nothing is recorded (and the validator refuses to
            # certify a capped tracer via the drop counter)
            self.dropped += 1
            return sid
        self.spans[sid] = {"id": sid, "trace": trace, "name": name,
                           "parent": parent, "replica": replica,
                           "slot": None, "t_start": self._now(),
                           "t_end": None, "state": None}
        return sid

    def _end_span(self, sid: Optional[int], state: str) -> None:
        sp = self.spans.get(sid)
        if sp is not None and sp["t_end"] is None:
            sp["t_end"] = self._now()
            sp["state"] = state

    def _attempt_span_for(self, req, replica: str) -> int:
        """The request's current attempt span, created lazily (a
        rejection can be the first thing the tracer hears about a
        request).  Consumes the router's pending adoption, so an
        attempt created inside a fleet dispatch joins the fleet trace
        with the right parent."""
        sid = self._req_span.get(req)
        if sid is not None:
            return sid
        parent = None
        if self._pending is not None:
            _freq, trace, parent = self._pending
        else:
            trace = f"{replica}:r{req.request_id}"
        sid = self._begin_span(trace, "attempt", parent=parent,
                               replica=replica)
        self._req_span[req] = sid
        self._req_trace[req] = trace
        if self._pending is not None:
            self._last_attempt[self._pending[0]] = sid
        return sid

    # -- engine-facing hooks ------------------------------------------------

    def on_queued(self, req, replica: str) -> None:
        sid = self._attempt_span_for(req, replica)
        self._event("queued", trace=self._req_trace.get(req), span=sid,
                    replica=replica, request_id=req.request_id,
                    prompt_len=int(req.prompt_ids.size),
                    priority=req.priority,
                    preemptions=req.preemptions,
                    tenant=getattr(req, "tenant", "base"))

    def on_shed(self, req, replica: str, wait_s: float) -> None:
        sid = self._attempt_span_for(req, replica)
        self._event("shed", trace=self._req_trace.get(req), span=sid,
                    replica=replica, request_id=req.request_id,
                    estimated_wait_s=round(wait_s, 6),
                    deadline_s=req.deadline_s)

    def on_admitted(self, req, replica: str, bucket: int, slot: int,
                    prefix_hit: int = 0) -> None:
        sid = self._attempt_span_for(req, replica)
        sp = self.spans.get(sid)
        if sp is not None:
            sp["slot"] = slot
        self._event("admitted", trace=self._req_trace.get(req), span=sid,
                    replica=replica, request_id=req.request_id,
                    bucket=bucket, slot=slot, prefix_hit=prefix_hit,
                    tenant=getattr(req, "tenant", "base"))

    def on_decode_step(self, replica: str, step: int, slots,
                       dt_s: float) -> None:
        """ONE event per engine step (not per token): the slots that
        decoded this step and the step latency."""
        self._event("decode_step", replica=replica, step=step,
                    slots=list(slots), n_active=len(slots),
                    dt_ms=round(dt_s * 1e3, 3))

    def on_verify_step(self, replica: str, step: int, slots,
                       dt_s: float, *, proposed: int,
                       accepted: int) -> None:
        """The speculative variant of :meth:`on_decode_step`: ONE event
        per engine ROUND (k draft steps + one verify step, never one
        per token or per draft step), carrying the round's (proposed,
        accepted) draft-token pair — the acceptance story per round,
        rendered by the Perfetto exporter as an ``accepted_tokens``
        counter track next to ``active_slots``."""
        self._event("verify_step", replica=replica, step=step,
                    slots=list(slots), n_active=len(slots),
                    dt_ms=round(dt_s * 1e3, 3),
                    proposed=int(proposed), accepted=int(accepted))

    def on_retired(self, req, replica: str, state: str,
                   error: Optional[str] = None) -> None:
        """Terminal (engine-level) transition.  Final for the trace
        unless the trace is fleet-rooted — there, the router's
        ``_finish`` emits the single final event, and an engine retire
        (export on ejection included) only ends the attempt span."""
        sid = self._attempt_span_for(req, replica)
        trace = self._req_trace.get(req)
        final = trace not in self._fleet_traces
        end_state = state
        if not final and state == "cancelled" \
                and getattr(req, "error_kind", "request") == "replica":
            end_state = "exported"       # the fleet will replay it
        self._end_span(sid, end_state)
        self._event("retired", trace=trace, span=sid, replica=replica,
                    request_id=req.request_id, state=state, final=final,
                    n_tokens=len(req.output_ids),
                    **({"error": error} if error else {}))

    def on_preempt(self, victim, replica: str) -> None:
        """End the victim's attempt span (``preempted``) and open the
        linked resume span — the child the re-admission and final
        retirement will ride."""
        sid = self._attempt_span_for(victim, replica)
        trace = self._req_trace.get(victim)
        self._end_span(sid, "preempted")
        resume = self._begin_span(trace, "resume", parent=sid,
                                  replica=replica)
        self._req_span[victim] = resume
        self._event("preempt", trace=trace, span=sid, replica=replica,
                    request_id=victim.request_id, resume_span=resume,
                    preemptions=victim.preemptions)

    def on_block_pressure(self, req, replica: str, kind: str = "defer",
                          **attrs) -> None:
        """Paged-pool pressure on this request's admission or decode
        (``defer`` / ``pool_exhausted``)."""
        sid = self._req_span.get(req)
        self._event("block_pressure", trace=self._req_trace.get(req),
                    span=sid, replica=replica, request_id=req.request_id,
                    pressure=kind, **attrs)

    def on_unhealthy(self, replica: str, reason: str) -> None:
        self._event("unhealthy", replica=replica, reason=reason)

    def on_recovered(self, req, replica: str,
                     origin_wall: Optional[float] = None,
                     journal_id: Optional[str] = None) -> None:
        """A crash-recovery replay re-admitted this request from the
        journal.  The attempt span is its cross-process *resume span*;
        the link back to the pre-crash attempt is WALL-anchored
        (``origin_wall`` = the journaled original admission's wall
        stamp) because monotonic clocks do not survive a restart — the
        Perfetto exporter renders it as a flow arrow from a synthetic
        pre-crash instant into this span."""
        sid = self._attempt_span_for(req, replica)
        sp = self.spans.get(sid)
        if sp is not None:
            sp["recovered"] = True
        self._event("recovered", trace=self._req_trace.get(req), span=sid,
                    replica=replica, request_id=req.request_id,
                    journal_id=journal_id,
                    **({"origin_wall": round(origin_wall, 6)}
                       if origin_wall is not None else {}))

    def on_weight_swap(self, replica: str, version: int) -> None:
        """One replica finished its drain-and-swap: every admission on
        it from here serves model ``version``."""
        self._event("weight_swap", replica=replica, version=version)

    def on_adapter_load(self, replica: str, adapter: str,
                        version: int) -> None:
        """A LoRA adapter was loaded (or hot-swapped) into this
        replica's pool; admissions naming it serve ``version`` now."""
        self._event("adapter_load", replica=replica, adapter=adapter,
                    version=version)

    def on_adapter_unload(self, replica: str, adapter: str,
                          version: int) -> None:
        self._event("adapter_unload", replica=replica, adapter=adapter,
                    version=version)

    def on_weight_roll(self, fleet: str, version: int,
                       roll_s: float, replicas: int) -> None:
        """The fleet-level rolling update completed end to end."""
        self._event("weight_roll", replica=fleet, version=version,
                    roll_ms=round(roll_s * 1e3, 3), replicas=replicas)

    # -- fleet-facing hooks -------------------------------------------------

    def on_submitted(self, freq, fleet: str) -> None:
        trace = f"{fleet}:f{freq.request_id}"
        sid = self._begin_span(trace, "request")
        self._req_trace[freq] = trace
        self._root_span[freq] = sid
        if len(self._fleet_traces) < self.max_events:
            # shares the event budget (bounded memory): past the cap
            # nothing about the submit was recorded anyway — the drop
            # counter has already voided the capture
            self._fleet_traces.add(trace)
        self._event("submitted", trace=trace, span=sid,
                    request_id=freq.request_id,
                    prompt_len=int(freq.prompt_ids.size))

    def begin_attempt(self, freq, replica: str) -> None:
        """Arm the adoption window around ONE ``engine.add_request``
        call: the attempt span the engine creates inside it joins this
        fleet trace, parented on the previous attempt (the redispatch
        chain) or the root."""
        trace = self._req_trace.get(freq)
        if trace is None:                # tracer attached mid-flight
            return
        parent = self._last_attempt.get(freq) or self._root_span.get(freq)
        self._pending = (freq, trace, parent)

    def end_attempt(self) -> None:
        self._pending = None

    def on_dispatch(self, freq, replica: str, redispatch: bool = False,
                    affinity: int = 0) -> None:
        self._event("redispatch" if redispatch else "dispatch",
                    trace=self._req_trace.get(freq),
                    span=self._root_span.get(freq), replica=replica,
                    request_id=freq.request_id, affinity=affinity,
                    attempt_span=self._last_attempt.get(freq),
                    redispatches=freq.redispatches)

    def on_fleet_terminal(self, freq, state: str,
                          error: Optional[str] = None) -> None:
        """The ONE final event of a fleet-rooted trace (the router's
        exactly-once ``_finish`` is the caller, so finality inherits
        its guard)."""
        sid = self._root_span.get(freq)
        self._end_span(sid, state)
        self._event("retired", trace=self._req_trace.get(freq), span=sid,
                    request_id=freq.request_id, state=state, final=True,
                    n_tokens=len(freq.output_ids),
                    **({"error": error} if error else {}))

    def on_eject(self, replica: str, reason: str) -> None:
        self._event("eject", replica=replica, reason=reason)

    def on_rebuild(self, replica: str, recovery_s: float,
                   ok: bool = True) -> None:
        self._event("rebuild", replica=replica, ok=ok,
                    recovery_ms=round(recovery_s * 1e3, 3))

    def on_degrade(self, replica: str, old_mp: int, new_mp: int,
                   recovery_s: float) -> None:
        """A shard group was rebuilt DEGRADED at a smaller viable mp
        on its surviving devices (always paired with an on_rebuild
        event carrying the same recovery time)."""
        self._event("degrade", replica=replica, old_mp=int(old_mp),
                    new_mp=int(new_mp),
                    recovery_ms=round(recovery_s * 1e3, 3))

    # -- introspection ------------------------------------------------------

    def traces(self) -> List[str]:
        """Every distinct trace id seen, in first-event order."""
        seen, out = set(), []
        for ev in self.events:
            t = ev.get("trace")
            if t is not None and t not in seen:
                seen.add(t)
                out.append(t)
        return out

    def snapshot(self) -> dict:
        """JSON-ready summary (NOT the event payload — use the
        :mod:`paddle_tpu_torch.obs` exporters for that)."""
        return {"events": len(self.events), "dropped": self.dropped,
                "spans": len(self.spans), "traces": len(self.traces()),
                "max_events": self.max_events}


# -- chain validation --------------------------------------------------------

def validate_trace(tracer: RequestTracer) -> List[str]:
    """The trace-chain validator: every request's story must be closed
    and well-linked.  Returns a list of problems (empty = valid):

    - no dropped events (a capped tracer cannot certify completeness);
    - every event's span exists and belongs to the event's trace;
    - every trace has EXACTLY ONE final ``retired`` event;
    - every span ends, in a legal state, with ``t_end >= t_start``;
    - every child span's parent exists, shares its trace, and started
      first (preempt/resume and redispatch chains link parent→child);
    - every ``preempt`` event's ``resume_span`` exists and is parented
      on the preempted span.
    """
    problems: List[str] = []
    if tracer.dropped:
        problems.append(f"{tracer.dropped} events dropped at the "
                        f"max_events={tracer.max_events} cap: the chain "
                        "is incomplete")
    finals: Dict[str, int] = {}
    for i, ev in enumerate(tracer.events):
        sid = ev.get("span")
        if sid is not None:
            sp = tracer.spans.get(sid)
            if sp is None:
                problems.append(f"event #{i} ({ev['kind']}) references "
                                f"unknown span {sid}")
            elif ev.get("trace") is not None \
                    and sp["trace"] != ev["trace"]:
                problems.append(f"event #{i} ({ev['kind']}) trace "
                                f"{ev['trace']!r} != its span's "
                                f"{sp['trace']!r}")
        if ev["kind"] == "retired" and ev.get("final") \
                and ev.get("trace") is not None:
            finals[ev["trace"]] = finals.get(ev["trace"], 0) + 1
        if ev["kind"] == "preempt":
            rs = tracer.spans.get(ev.get("resume_span"))
            if rs is None:
                problems.append(f"preempt event #{i} has no resume span")
            elif rs["parent"] != ev.get("span"):
                problems.append(
                    f"preempt event #{i}: resume span {rs['id']} is "
                    f"parented on {rs['parent']}, not the preempted "
                    f"span {ev.get('span')}")
    for trace in {ev.get("trace") for ev in tracer.events} - {None}:
        n = finals.get(trace, 0)
        if n != 1:
            problems.append(f"trace {trace!r} has {n} terminal events "
                            "(want exactly 1)")
    for sid, sp in tracer.spans.items():
        if sp["t_end"] is None:
            problems.append(f"span {sid} ({sp['name']}, trace "
                            f"{sp['trace']!r}) never ended")
            continue
        if sp["t_end"] < sp["t_start"]:
            problems.append(f"span {sid} ends before it starts")
        if sp["state"] not in TERMINAL_SPAN_STATES:
            problems.append(f"span {sid} ended in unknown state "
                            f"{sp['state']!r}")
        parent = tracer.spans.get(sp["parent"]) \
            if sp["parent"] is not None else None
        if sp["parent"] is not None:
            if parent is None:
                problems.append(f"span {sid} has unknown parent "
                                f"{sp['parent']}")
            else:
                if parent["trace"] != sp["trace"]:
                    problems.append(
                        f"span {sid} (trace {sp['trace']!r}) parented "
                        f"across traces on {parent['id']} "
                        f"({parent['trace']!r})")
                if sp["t_start"] < parent["t_start"]:
                    problems.append(f"span {sid} starts before its "
                                    f"parent {parent['id']}")
    return problems
