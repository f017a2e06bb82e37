"""Crash artifact persistence: the post-mortem must outlive the process.

The port's copy of ``paddle_tpu/obs/crashdump.py``.  The
:class:`~.flight.FlightRecorder` exists to explain the moments before a
failure, and the serving :class:`~..serving.tracing.RequestTracer` holds
the per-request story, but both live in process RAM, so a path that
*kills* the process (a watchdog's hard exit) would destroy exactly the
artifact it exists for.  :func:`persist_crash_artifacts` freezes every
live flight ring and every armed tracer into one JSON file *before* the
process dies:

- destination: ``$PADDLE_TPU_TRACE_DIR`` when set, else a ``crash/``
  sibling inside the most recently opened request journal's directory
  (the journal is the durable surface a recovering process reads first,
  so its crash dumps belong next to it), else nowhere (the function is
  a no-op: crash persistence is best-effort and must never block the
  exit path);
- content: the firing reason, wall time, pid, every live flight
  recorder's ring (a ``peek``, so no dump is banked on the live
  recorder) and retained dumps, and every live tracer's full event/span
  payload (wall-anchored through the tracer's one-shot anchor, so a
  post-mortem Perfetto export still lines up with logs).

Every failure in here is swallowed: a crash handler that crashes is
worse than no handler.
"""
from __future__ import annotations

import json
import os
import time
from typing import List, Optional

__all__ = ["persist_crash_artifacts", "register_journal_dir",
           "unregister_journal_dir", "crash_dir"]

#: journal directories registered at RequestJournal construction,
#: newest last: the fallback crash destination
_JOURNAL_DIRS: List[str] = []


def register_journal_dir(path: str) -> None:
    """Remember a journal directory as a crash-dump destination (its
    ``crash/`` sibling).  Called by ``RequestJournal.__init__``."""
    p = os.path.abspath(str(path))
    if p in _JOURNAL_DIRS:
        _JOURNAL_DIRS.remove(p)
    _JOURNAL_DIRS.append(p)
    del _JOURNAL_DIRS[:-8]               # bounded


def unregister_journal_dir(path: str) -> None:
    """Forget a journal directory (``RequestJournal.close``): a cleanly
    closed journal's directory may be deleted by its owner, and a later
    crash must not resurrect it as a dump destination.  A *crashed*
    process never closes, which is exactly when the registration should
    still be live."""
    p = os.path.abspath(str(path))
    if p in _JOURNAL_DIRS:
        _JOURNAL_DIRS.remove(p)


def crash_dir() -> Optional[str]:
    """Where crash artifacts go: ``$PADDLE_TPU_TRACE_DIR``, else
    ``<newest journal>/crash``, else None (nowhere configured)."""
    d = os.environ.get("PADDLE_TPU_TRACE_DIR")
    if d:
        return d
    if _JOURNAL_DIRS:
        return os.path.join(_JOURNAL_DIRS[-1], "crash")
    return None


def persist_crash_artifacts(reason: str,
                            extra: Optional[dict] = None
                            ) -> Optional[str]:
    """Freeze flight rings + armed tracers to disk; returns the written
    path, or None when no destination is configured or anything failed
    (best-effort by contract: the caller may be about to exit)."""
    try:
        d = crash_dir()
        if d is None:
            return None
        os.makedirs(d, exist_ok=True)
        payload = {"reason": str(reason),
                   "wall_time": round(time.time(), 6),
                   "pid": os.getpid()}
        try:
            from .flight import live_recorders

            # capture every live ring WITHOUT banking a dump (peek):
            # mutating recorder state from the crash path would
            # manufacture dumps the live process's consumers read
            rings, flight = {}, {}
            for rec in live_recorders():
                try:
                    rings.setdefault(rec.name, []).append(
                        rec.peek(f"crash: {reason}"))
                    flight.setdefault(rec.name, []).append(rec.snapshot())
                except Exception:        # noqa: BLE001 — best effort
                    pass
            payload["flight_rings"] = rings
            # plus each recorder's snapshot (retained dumps included)
            payload["flight"] = flight
        except Exception:                # noqa: BLE001 — best effort
            pass
        try:
            from ..serving import tracing

            traces = []
            for tr in tracing.live_tracers():
                traces.append({
                    "wall0": tr.wall0,
                    "dropped": tr.dropped,
                    "events": list(tr.events),
                    "spans": {str(k): dict(v)
                              for k, v in tr.spans.items()},
                })
            if traces:
                payload["traces"] = traces
        except Exception:                # noqa: BLE001 — best effort
            pass
        if extra:
            payload.update(extra)
        path = os.path.join(
            d, f"crash-{os.getpid()}-{int(time.time() * 1e3)}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        return path
    except Exception:                    # noqa: BLE001 — never block exit
        return None
