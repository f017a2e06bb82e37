"""Chrome/Perfetto trace-event export of a serving :class:`RequestTracer`.

The port's copy of ``paddle_tpu/obs/perfetto.py`` (its serving half).  It
produces the ``{"traceEvents": [...]}`` JSON that the Perfetto UI and
``chrome://tracing`` load directly:

- one **process** per replica (engine), named via ``process_name``
  metadata;
- one **thread** per slot (``slot 0..N-1``) plus thread 0 as the
  replica's *scheduler* track: attempt/resume spans render on the slot
  that served them (never-admitted spans on the scheduler track), point
  events (queued/preempt/shed/...) as instants;
- **flow arrows** (``ph: s``/``f``) from every ``preempt`` event to its
  resume span and every ``redispatch`` to the replayed attempt;
- a per-replica **counter track** (``active_slots``) fed by the batched
  per-step decode events.

Timestamps are the tracer's monotonic event clock in microseconds; the
tracer's wall-clock anchor is recorded once in
``metadata.wall_clock_origin``.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

__all__ = ["chrome_trace", "write_chrome_trace"]

#: tid reserved for per-replica scheduler-level events/spans
SCHEDULER_TID = 0

#: pid for fleet-level (router) tracks: submits, dispatch, root spans
ROUTER_PID = 0


def _us(ts_s: float) -> float:
    return round(ts_s * 1e6, 3)


class _Tracks:
    """pid/tid assignment plus the lazily emitted naming metadata."""

    def __init__(self, out: List[dict]):
        self.out = out
        self.pids: Dict[str, int] = {}
        self._named_threads = set()

    def pid(self, replica: Optional[str]) -> int:
        if replica is None:
            if ROUTER_PID not in self._named_threads:
                self._named_threads.add(ROUTER_PID)
                self.out.append({"ph": "M", "name": "process_name",
                                 "pid": ROUTER_PID, "tid": 0,
                                 "args": {"name": "router"}})
            return ROUTER_PID
        p = self.pids.get(replica)
        if p is None:
            p = len(self.pids) + 1
            self.pids[replica] = p
            self.out.append({"ph": "M", "name": "process_name",
                             "pid": p, "tid": 0,
                             "args": {"name": replica}})
        return p

    def tid(self, replica: Optional[str], slot: Optional[int]) -> int:
        p = self.pid(replica)
        t = SCHEDULER_TID if slot is None else int(slot) + 1
        if (p, t) not in self._named_threads:
            self._named_threads.add((p, t))
            self.out.append({
                "ph": "M", "name": "thread_name", "pid": p, "tid": t,
                "args": {"name": "scheduler" if t == SCHEDULER_TID
                         else f"slot {t - 1}"}})
        return t


def _flow(out: List[dict], tracks: _Tracks, flow_id: int, kind: str,
          pid: int, tid: int, ts: float, target: dict) -> None:
    """A flow arrow from ``(pid, tid, ts)`` into ``target``'s start."""
    out.append({"ph": "s", "id": flow_id, "pid": pid, "tid": tid,
                "ts": ts, "name": kind, "cat": "link"})
    out.append({"ph": "f", "bp": "e", "id": flow_id,
                "pid": tracks.pid(target["replica"]),
                "tid": tracks.tid(target["replica"], target.get("slot")),
                "ts": _us(target["t_start"]), "name": kind,
                "cat": "link"})


def chrome_trace(tracer) -> dict:
    """Render a :class:`~paddle_tpu_torch.serving.tracing.RequestTracer`
    into a Perfetto-loadable trace dict (the module docstring gives the
    track layout).  A pure host-side read of its events and spans."""
    out: List[dict] = []
    tracks = _Tracks(out)
    for sid, sp in sorted(tracer.spans.items()):
        t_end = sp["t_end"] if sp["t_end"] is not None else sp["t_start"]
        out.append({
            "ph": "X", "pid": tracks.pid(sp["replica"]),
            "tid": tracks.tid(sp["replica"], sp.get("slot")),
            "ts": _us(sp["t_start"]),
            "dur": max(_us(t_end) - _us(sp["t_start"]), 0.001),
            "name": f"{sp['name']} {sp['trace']}",
            "cat": sp["name"],
            "args": {"span": sid, "parent": sp["parent"],
                     "trace": sp["trace"], "state": sp["state"]},
        })
    flow_id = 0
    for ev in tracer.events:
        kind = ev["kind"]
        replica = ev.get("replica")
        if kind in ("decode_step", "verify_step"):
            pid = tracks.pid(replica)
            out.append({"ph": "C", "pid": pid, "tid": SCHEDULER_TID,
                        "ts": _us(ev["ts"]), "name": "active_slots",
                        "args": {"active": ev["n_active"]}})
            if kind == "verify_step":
                out.append({"ph": "C", "pid": pid, "tid": SCHEDULER_TID,
                            "ts": _us(ev["ts"]), "name": "accepted_tokens",
                            "args": {"accepted": ev["accepted"]}})
            continue
        sp = tracer.spans.get(ev.get("span"))
        slot = sp.get("slot") if sp is not None else None
        pid = tracks.pid(replica)
        tid = tracks.tid(replica, slot)
        args = {k: v for k, v in ev.items()
                if k not in ("ts", "kind", "span")}
        out.append({"ph": "i", "s": "t", "pid": pid, "tid": tid,
                    "ts": _us(ev["ts"]), "name": kind, "cat": kind,
                    "args": args})
        # linked spans as flow arrows: preempt -> its resume span,
        # redispatch -> the replayed attempt
        target = None
        if kind == "preempt":
            target = tracer.spans.get(ev.get("resume_span"))
        elif kind == "redispatch":
            target = tracer.spans.get(ev.get("attempt_span"))
        elif kind == "recovered" and ev.get("origin_wall") is not None:
            # a cross-process resume: the pre-crash attempt's events died
            # with its process, so the arrow starts at a synthetic instant
            # at the journaled admission's wall time, mapped through this
            # tracer's anchor
            rec = tracer.spans.get(ev.get("span"))
            if rec is not None:
                origin_ts = _us(ev["origin_wall"] - tracer.wall0)
                flow_id += 1
                out.append({"ph": "i", "s": "t", "pid": pid, "tid": tid,
                            "ts": origin_ts, "name": "pre_crash_admission",
                            "cat": "recovered",
                            "args": {"journal_id": ev.get("journal_id"),
                                     "origin_wall": ev["origin_wall"]}})
                _flow(out, tracks, flow_id, kind, pid, tid, origin_ts, rec)
        if target is not None:
            flow_id += 1
            _flow(out, tracks, flow_id, kind, pid, tid, _us(ev["ts"]),
                  target)
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "metadata": {
            "tool": "paddle_tpu_torch.obs",
            "wall_clock_origin": tracer.wall0,
            "events": len(tracer.events),
            "dropped": tracer.dropped,
            "spans": len(tracer.spans),
        },
    }


def write_chrome_trace(tracer, path: str) -> str:
    """Serialize :func:`chrome_trace` to ``path`` (plain JSON: load it in
    the Perfetto UI or ``chrome://tracing``).  Returns ``path``."""
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f)
    return path
