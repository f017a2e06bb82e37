"""Flight recorder: an always-on bounded ring of per-step summaries.

The port's copy of ``paddle_tpu/obs/flight.py``.  The serving engine
keeps one per :class:`~..serving.engine.Engine` and feeds it slot, queue
and block occupancy each scheduler step.  When something goes wrong the
ring is frozen into a **dump**: the last N steps leading up to the
failure, the post-mortem the aggregate counters cannot reconstruct.  The
port has no process-wide profiler registry yet, so a recorder is reached
through its owner (``engine.flight``).
"""
from __future__ import annotations

import time
import weakref
from collections import deque
from typing import List

__all__ = ["FlightRecorder", "live_recorders"]

#: weak registry of every live recorder: the crash-dump path finds the
#: rings through it without holding them alive
_LIVE = weakref.WeakSet()


def live_recorders() -> List["FlightRecorder"]:
    """Every live :class:`FlightRecorder` in the process (weakly held,
    registration order not guaranteed)."""
    return list(_LIVE)


class FlightRecorder:
    """Always-on bounded ring of the last N step summaries.

    One per engine, fed a handful of host ints/floats per step (cost: one
    small dict append).  ``dump(reason)`` freezes the ring into a
    post-mortem record; dumps are kept (newest last, at most
    ``max_dumps``).
    """

    def __init__(self, capacity: int = 256, name: str = "engine", *,
                 max_dumps: int = 4):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = name
        self.capacity = int(capacity)
        self.max_dumps = int(max_dumps)
        self._ring: deque = deque(maxlen=self.capacity)
        self.steps_seen = 0
        self.dumps: List[dict] = []
        _LIVE.add(self)

    def record(self, **fields) -> None:
        """Append one step summary (host ints/floats only: the caller is
        the scheduler, so this must stay allocation-light)."""
        self.steps_seen += 1
        fields["t"] = round(time.perf_counter(), 6)
        self._ring.append(fields)

    def dump(self, reason: str) -> dict:
        """Freeze the ring into a post-mortem record (newest events last)
        and bank it on ``dumps``."""
        d = self.peek(reason)
        self.dumps.append(d)
        del self.dumps[:-self.max_dumps]
        return d

    def peek(self, reason: str) -> dict:
        """A dump-shaped view of the current ring without banking it."""
        return {"name": self.name, "reason": reason,
                "wall_time": time.time(), "steps_seen": self.steps_seen,
                "events": [dict(e) for e in self._ring]}

    def snapshot(self) -> dict:
        """JSON-ready view: ring occupancy plus every retained dump."""
        return {"name": self.name, "capacity": self.capacity,
                "steps_seen": self.steps_seen,
                "ring_depth": len(self._ring),
                "dumps": [dict(d, events=[dict(e) for e in d["events"]])
                          for d in self.dumps]}
