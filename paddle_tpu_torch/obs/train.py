"""Training step observatory: where does a train step's wall time go?

The port's copy of ``paddle_tpu/obs/train.py``.  :class:`StepTimeline`
records the host-side story of every step as the span/event chain the
serving tracer uses, one trace per step attempt with phases as child
spans, so the :mod:`paddle_tpu_torch.obs` exporters render a training run
the way they render a serving engine:

``step`` (root span, one per attempt)
    ``data_fetch`` → ``step_dispatch`` → ``device_wait`` →
    ``snapshot_capture`` / ``checkpoint_commit`` / ``rollback_restore``

A divergence-sentry rollback ends the attempt span ``rolled_back`` and
links forward to the resumed attempt (a Perfetto flow arrow); a
blocklisted window is a ``skipped`` attempt.

- **Pure host-side bookkeeping.**  Spans are stamped around calls the
  loop already makes: attaching a timeline adds no program to a
  ``jit.to_static`` step and reads no device value.
- **Monotonic clock.**  Every span and event is stamped from
  ``time.perf_counter()`` relative to the timeline's start; the
  wall-clock anchor is taken once, for the exporters.
- **Near-zero overhead when off.**  The default is
  :data:`NULL_TIMELINE` (every hook a no-op); opt in per loop
  (``timeline=StepTimeline()``) or process-wide with
  ``PADDLE_TPU_TRAIN_TRACE=1``.
- **Bounded memory.**  At most ``max_events`` events are kept; past the
  cap they are counted as ``dropped`` (and :func:`validate_timeline`
  refuses to certify a capped timeline).

:func:`validate_timeline` is the chain validator: every step attempt
closed in a legal terminal state exactly once, phases nested inside
their attempt, every rollback linked to the attempt that resumed from
it.
"""
from __future__ import annotations

import itertools
import os
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = ["StepTimeline", "NullTimeline", "NULL_TIMELINE",
           "resolve_timeline", "validate_timeline",
           "STEP_TERMINAL_STATES"]

#: States a step-attempt (root) span may legally end in.  Background
#: phases recorded outside any step (e.g. the seed snapshot, the final
#: checkpoint commit) are their own one-span traces ending ``finished``.
#: ``reconfigured`` is a completion: the first attempt after an elastic
#: topology-change resume ends in it (the step ran to the boundary; the
#: marker says it ran on a DIFFERENT world than the checkpoint's).
STEP_TERMINAL_STATES = frozenset({
    "completed", "rolled_back", "skipped", "escalated", "finished",
    "reconfigured"})

#: The canonical phase names the training loops emit.  ``phase()``
#: accepts any string — these are documentation, not an allowlist.
PHASES = ("data_fetch", "step_dispatch", "device_wait",
          "snapshot_capture", "checkpoint_commit", "rollback_restore")


class _NullPhase:
    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        return False


_NULL_PHASE = _NullPhase()


def _noop(*_args, **_kwargs) -> None:
    return None


class NullTimeline:
    """The disabled timeline: every hook an EXPLICIT no-op (not a
    catch-all — a misspelled hook call must fail in unarmed CI runs
    too, not only for the first user who arms tracing), ``phase()`` a
    shared no-op context manager, ``enabled`` False so call sites can
    skip argument construction.  One shared instance
    (:data:`NULL_TIMELINE`) serves every untimed loop.  The
    exporter-facing surface (events, spans, clock anchors) is
    real-but-empty, so exporting an unarmed loop's timeline yields a
    valid empty trace instead of a crash."""

    enabled = False
    events: tuple = ()
    spans: dict = {}
    dropped = 0
    t0 = 0.0
    wall0 = 0.0
    max_events = 0

    # the hook set, mirrored from StepTimeline — keep in lockstep
    begin_step = _noop
    end_step = _noop
    abandon_step = _noop
    on_skip = _noop
    on_rollback = _noop
    on_escalate = _noop
    on_reconfigured = _noop

    def phase(self, _name: str):
        return _NULL_PHASE

    def counters(self) -> dict:
        return {}

    def snapshot(self) -> dict:
        return {}


#: The shared disabled timeline every training loop defaults to.
NULL_TIMELINE = NullTimeline()


def resolve_timeline(timeline=None):
    """THE arming contract, shared by every training entry point
    (``ResilientLoop``): an explicitly passed timeline
    wins, else the env-armed one (``PADDLE_TPU_TRAIN_TRACE=1``), else
    the no-op :data:`NULL_TIMELINE`."""
    if timeline is not None:
        return timeline
    return StepTimeline.from_env() or NULL_TIMELINE


class StepTimeline:
    """Host-side span/event recorder for training step lifecycles.

    One trace per step *attempt* (a rolled-back step's replay is a new
    attempt: ``trainer:s5`` then ``trainer:s5#2``), the ``step`` root
    span covering the whole boundary-to-boundary iteration and phases
    as child spans.  Rendered by :func:`paddle_tpu_torch.obs.chrome_trace`
    as one process (``process`` name, default ``trainer``) with one
    thread per phase; exported as JSONL by
    :func:`paddle_tpu_torch.obs.jsonl_lines`.

    The training loop is single-threaded; no locking.

    Args:
        max_events: retention bound shared by the event list and span
            table; past it everything is dropped and counted (and
            :func:`validate_timeline` fails on any drop).
        process: the Perfetto process-track name.
    """

    enabled = True

    def __init__(self, max_events: int = 200_000, process: str = "trainer"):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = int(max_events)
        self.process = process
        #: monotonic origin; every event/span ts is seconds since this
        self.t0 = time.perf_counter()
        #: wall-clock anchor captured ONCE for exporters
        self.wall0 = time.time()
        self.events: List[dict] = []
        self.spans: Dict[int, dict] = {}
        self.dropped = 0
        self._span_ids = itertools.count(1)
        self._bg_ids = itertools.count(1)
        #: step -> attempts seen, for REPLAYED steps only (a step past
        #: the high-water mark is always a first attempt and stores
        #: nothing, so a rollback-free multi-million-step run keeps
        #: this empty — the bounded-memory invariant holds)
        self._attempts: Dict[int, int] = {}
        self._max_step_seen: int = -(2 ** 62)
        self._step_span: Optional[int] = None
        self._step_trace: Optional[str] = None
        self._step: Optional[int] = None
        self._t_step_start: Optional[float] = None
        #: span ids of the CURRENT attempt (root + its phases), so
        #: abandon_step removes exactly them instead of scanning the
        #: whole span table
        self._attempt_sids: List[int] = []
        #: how to undo the open attempt's bookkeeping on abandon
        self._undo_attempt: Optional[tuple] = None
        #: the rollback event (if any) whose resume link points at the
        #: OPEN attempt — abandon_step re-arms it in O(1)
        self._attempt_rollback_ev: Optional[dict] = None
        #: rollback event awaiting its resume link (the next attempt)
        self._pending_rollback: Optional[dict] = None
        # host counters (the profiler/metrics snapshot surface)
        self.steps_completed = 0
        self.steps_rolled_back = 0
        self.steps_skipped = 0
        self.escalations = 0
        self.reconfigurations = 0
        self.phase_seconds: Dict[str, float] = {}

    # -- construction -------------------------------------------------------

    @classmethod
    def from_env(cls) -> Optional["StepTimeline"]:
        """The env-armed timeline (``PADDLE_TPU_TRAIN_TRACE=1``), or
        None when off (the default: loops fall back to
        :data:`NULL_TIMELINE`)."""
        v = os.environ.get("PADDLE_TPU_TRAIN_TRACE", "").strip().lower()
        if v in ("", "0", "false", "off", "no"):
            return None
        if v in ("1", "true", "on", "yes"):
            return cls()
        raise ValueError(f"PADDLE_TPU_TRAIN_TRACE={v!r}: expected 1/on "
                         "to enable or 0/off to disable")

    # -- core recording -----------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self.t0

    def _event(self, kind: str, trace: Optional[str] = None,
               span: Optional[int] = None, thread: Optional[str] = None,
               **attrs) -> Optional[dict]:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return None
        ev = {"ts": self._now(), "kind": kind}
        if trace is not None:
            ev["trace"] = trace
        if span is not None:
            ev["span"] = span
        if thread is not None:
            ev["thread"] = thread
        ev["replica"] = self.process
        if attrs:
            ev.update(attrs)
        self.events.append(ev)
        return ev

    def _begin_span(self, trace: str, name: str,
                    parent: Optional[int] = None,
                    thread: Optional[str] = None) -> int:
        sid = next(self._span_ids)
        if len(self.spans) >= self.max_events:
            self.dropped += 1
            return sid
        self.spans[sid] = {"id": sid, "trace": trace, "name": name,
                           "parent": parent, "replica": self.process,
                           "thread": thread or name,
                           "t_start": self._now(), "t_end": None,
                           "state": None}
        return sid

    def _end_span(self, sid: Optional[int], state: str) -> None:
        sp = self.spans.get(sid)
        if sp is not None and sp["t_end"] is None:
            sp["t_end"] = self._now()
            sp["state"] = state

    # -- step lifecycle -----------------------------------------------------

    def begin_step(self, step: int) -> None:
        """Open the attempt span for ``step``.  A replayed step (after
        a rollback) gets a fresh attempt trace; a pending rollback
        event links to this attempt as its resume target."""
        step = int(step)
        if step > self._max_step_seen:
            # remember how to UNDO this bookkeeping: an abandoned
            # attempt (data_fetch StopIteration) never happened, and
            # re-beginning the same step next epoch must be a first
            # attempt again, not a phantom "#2" replay
            self._undo_attempt = ("max", self._max_step_seen)
            self._max_step_seen = step
            n = 1
        else:
            # at/below the high-water mark = a rollback replay (the
            # only way the loops revisit a step); only these earn a
            # dict entry, bounded by the cap like everything else
            if len(self._attempts) > self.max_events:
                self._attempts.clear()      # uncertifiable past the
                self.dropped += 1           # cap anyway; stay bounded
            self._undo_attempt = ("attempts", step,
                                  self._attempts.get(step))
            n = self._attempts.get(step, 1) + 1
            self._attempts[step] = n
        trace = f"{self.process}:s{step}" + (f"#{n}" if n > 1 else "")
        sid = self._begin_span(trace, "step", thread="step")
        self._attempt_sids = [sid]
        self._attempt_rollback_ev = None
        if self._pending_rollback is not None:
            self._pending_rollback["resume_span"] = sid
            self._attempt_rollback_ev = self._pending_rollback
            self._pending_rollback = None
        self._step_span = sid
        self._step_trace = trace
        self._step = int(step)
        self._t_step_start = self._now()

    def end_step(self, state: str = "completed") -> None:
        """Close the open attempt span; emits the per-step summary
        event carrying the attempt's wall duration."""
        if self._step_span is None:
            return
        self._end_span(self._step_span, state)
        dt = self._now() - (self._t_step_start or self._now())
        self._event("step", trace=self._step_trace, span=self._step_span,
                    thread="step", step=self._step, state=state,
                    dt_ms=round(dt * 1e3, 3))
        if state in ("completed", "reconfigured"):
            self.steps_completed += 1
        elif state == "skipped":
            self.steps_skipped += 1
        self._step_span = None
        self._step_trace = None
        self._step = None
        self._t_step_start = None

    def abandon_step(self) -> None:
        """Discard an open attempt that never ran (e.g. the data
        iterator was exhausted after ``begin_step``): the attempt span
        AND any phases it already opened (the data_fetch that hit
        StopIteration) are removed as if the attempt never started.
        A rollback event already linked to the abandoned attempt is
        RE-ARMED: its resume link moves to the next attempt if one
        begins, or legally stays absent if the run is over (a dangling
        link into a deleted span would fail the validator)."""
        if self._step_span is not None:
            for k in self._attempt_sids:
                self.spans.pop(k, None)
            # the attempt never happened: undo begin_step's attempt
            # bookkeeping too, or re-beginning the SAME step (fit's
            # next epoch) would be mislabeled a "#2" rollback replay
            undo = self._undo_attempt
            if undo is not None:
                if undo[0] == "max":
                    self._max_step_seen = undo[1]
                elif undo[2] is None:
                    self._attempts.pop(undo[1], None)
                else:
                    self._attempts[undo[1]] = undo[2]
            ev = self._attempt_rollback_ev
            if ev is not None:
                ev.pop("resume_span", None)
                self._pending_rollback = ev
        self._step_span = None
        self._step_trace = None
        self._step = None
        self._t_step_start = None

    @contextmanager
    def phase(self, name: str):
        """Span one phase of the current step attempt (or a background
        trace of its own when no attempt is open — the seed snapshot,
        the final checkpoint commit)."""
        if self._step_span is not None:
            sid = self._begin_span(self._step_trace, name,
                                   parent=self._step_span, thread=name)
            self._attempt_sids.append(sid)
        else:
            sid = self._begin_span(
                f"{self.process}:bg{next(self._bg_ids)}", name,
                thread=name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # an abandoned attempt already removed this span — its
            # duration must not leak into the counters either, or
            # phase_ms would disagree with the exported spans
            if sid in self.spans:
                self._end_span(sid, "finished")
                self.phase_seconds[name] = \
                    self.phase_seconds.get(name, 0.0) \
                    + (time.perf_counter() - t0)

    # -- sentry transitions -------------------------------------------------

    def on_skip(self, step: int) -> None:
        """Mark the open attempt as a blocklisted-window skip (the
        caller still calls :meth:`end_step` with ``"skipped"``)."""
        self._event("skip", trace=self._step_trace, span=self._step_span,
                    thread="step", step=int(step))

    def on_rollback(self, step: int, target: Optional[int] = None,
                    code: int = 0) -> None:
        """End the open attempt ``rolled_back`` and arm the resume
        link: the next :meth:`begin_step` becomes this rollback's
        ``resume_span`` (rendered as a Perfetto flow arrow)."""
        ev = self._event("rollback", trace=self._step_trace,
                         span=self._step_span, thread="step",
                         step=int(step),
                         **({"target": int(target)}
                            if target is not None else {}),
                         **({"code": int(code)} if code else {}))
        self._end_span(self._step_span, "rolled_back")
        self.steps_rolled_back += 1
        # close out attempt bookkeeping WITHOUT the summary event —
        # the rollback event is this attempt's terminal record
        self._step_span = None
        self._step_trace = None
        self._step = None
        self._t_step_start = None
        if ev is not None:
            self._pending_rollback = ev

    def on_escalate(self, step: int) -> None:
        """Sentry escalation fail-stop: terminal for the open attempt."""
        self._event("escalate", trace=self._step_trace,
                    span=self._step_span, thread="step", step=int(step))
        self.escalations += 1
        self.end_step("escalated")

    # -- elastic transitions ------------------------------------------------

    def on_reconfigured(self, step: int,
                        origin_wall: Optional[float] = None,
                        **attrs) -> None:
        """Mark the OPEN attempt as the first one after an elastic
        topology-change resume (call between :meth:`begin_step` and
        :meth:`end_step`; the loop then ends the attempt
        ``"reconfigured"``).  ``origin_wall`` is the wall time of the
        checkpoint generation the resume restored — the exporter
        renders a wall-anchored synthetic instant at that moment plus a
        flow arrow into this attempt, the cross-restart link (same
        pattern as the crash-recovery ``pre_crash_admission``; the
        restarted process's monotonic clock shares no origin with its
        predecessor's, so only wall time can anchor the arrow)."""
        self._event("reconfigured", trace=self._step_trace,
                    span=self._step_span, thread="step", step=int(step),
                    **({"origin_wall": float(origin_wall)}
                       if origin_wall is not None else {}),
                    **attrs)
        self.reconfigurations += 1

    # -- introspection ------------------------------------------------------

    def counters(self) -> dict:
        """JSON-ready counters (the ``profiler.train_stats()`` /
        metrics-exposition surface — no event payloads)."""
        return {
            "steps_completed": self.steps_completed,
            "rolled_back": self.steps_rolled_back,
            "skipped": self.steps_skipped,
            "escalations": self.escalations,
            "reconfigured": self.reconfigurations,
            "events": len(self.events),
            "spans": len(self.spans),
            "dropped": self.dropped,
            "phase_ms": {k: round(v * 1e3, 3)
                         for k, v in sorted(self.phase_seconds.items())},
        }

    def snapshot(self) -> dict:
        return dict(self.counters(), process=self.process,
                    max_events=self.max_events)


# -- chain validation --------------------------------------------------------

def validate_timeline(tl: StepTimeline) -> List[str]:
    """The step-chain validator (the training analog of
    ``serving.tracing.validate_trace``).  Returns a list of problems
    (empty = valid):

    - no dropped events (a capped timeline cannot certify completeness);
    - every event's span exists and belongs to the event's trace;
    - every span ends, in a legal state, with ``t_end >= t_start``;
    - every trace has EXACTLY ONE root span (step attempts and
      background phases are one-terminal-per-trace by construction) and
      the root ends in a :data:`STEP_TERMINAL_STATES` state;
    - phases parent in-trace on their attempt span and start after it;
    - every ``rollback`` event links to an existing resume attempt that
      starts at/after the rollback (a rollback as the run's last act —
      nothing resumed — is legal and carries no link).
    """
    problems: List[str] = []
    if tl.dropped:
        problems.append(f"{tl.dropped} events dropped at the "
                        f"max_events={tl.max_events} cap: the chain is "
                        "incomplete")
    roots: Dict[str, List[int]] = {}
    for sid, sp in tl.spans.items():
        if sp["parent"] is None:
            roots.setdefault(sp["trace"], []).append(sid)
    for i, ev in enumerate(tl.events):
        sid = ev.get("span")
        if sid is not None:
            sp = tl.spans.get(sid)
            if sp is None:
                problems.append(f"event #{i} ({ev['kind']}) references "
                                f"unknown span {sid}")
            elif ev.get("trace") is not None and sp["trace"] != ev["trace"]:
                problems.append(f"event #{i} ({ev['kind']}) trace "
                                f"{ev['trace']!r} != its span's "
                                f"{sp['trace']!r}")
        if ev["kind"] == "rollback":
            rs = ev.get("resume_span")
            if rs is None:
                # legal ONLY when nothing resumed after it (the run
                # ended on the rollback); any later attempt means the
                # link was lost
                later = any(sp["name"] == "step"
                            and sp["t_start"] >= ev["ts"]
                            for sp in tl.spans.values())
                if later:
                    problems.append(f"rollback event #{i} has no resume "
                                    "link but a later attempt exists")
            else:
                sp = tl.spans.get(rs)
                if sp is None:
                    problems.append(f"rollback event #{i} resume span "
                                    f"{rs} does not exist")
                elif sp["name"] != "step":
                    problems.append(f"rollback event #{i} resume span "
                                    f"{rs} is not a step attempt")
                elif sp["t_start"] < ev["ts"]:
                    problems.append(f"rollback event #{i} resume span "
                                    f"{rs} starts before the rollback")
    for trace, sids in roots.items():
        if len(sids) != 1:
            problems.append(f"trace {trace!r} has {len(sids)} root spans "
                            "(want exactly 1)")
    for sid, sp in tl.spans.items():
        if sp["t_end"] is None:
            problems.append(f"span {sid} ({sp['name']}, trace "
                            f"{sp['trace']!r}) never ended")
            continue
        if sp["t_end"] < sp["t_start"]:
            problems.append(f"span {sid} ends before it starts")
        if sp["parent"] is None:
            if sp["state"] not in STEP_TERMINAL_STATES:
                problems.append(f"span {sid} ended in unknown terminal "
                                f"state {sp['state']!r}")
            continue
        if sp["state"] != "finished":
            problems.append(f"phase span {sid} ({sp['name']}) ended "
                            f"{sp['state']!r}, not 'finished'")
        parent = tl.spans.get(sp["parent"])
        if parent is None:
            problems.append(f"span {sid} has unknown parent "
                            f"{sp['parent']}")
        else:
            if parent["trace"] != sp["trace"]:
                problems.append(f"span {sid} (trace {sp['trace']!r}) "
                                f"parented across traces on "
                                f"{parent['id']} ({parent['trace']!r})")
            if sp["t_start"] < parent["t_start"]:
                problems.append(f"span {sid} starts before its parent "
                                f"{parent['id']}")
    return problems
