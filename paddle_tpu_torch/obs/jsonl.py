"""JSONL event-log export of a serving :class:`RequestTracer`.

The port's copy of ``paddle_tpu/obs/jsonl.py``.  One JSON object per
line, in event order: the grep/jq-friendly form of the same chain the
Perfetto exporter renders.  Wall-clock timestamps are attached here, at
export, from the tracer's one-shot anchor pair (``t0``/``wall0``): events
themselves are stamped monotonically (``time.perf_counter``), so no
latency is ever computed across a wall-clock step.
"""
from __future__ import annotations

import json
from typing import Iterator

__all__ = ["jsonl_lines", "write_jsonl"]


def jsonl_lines(tracer) -> Iterator[str]:
    """Yield one JSON line per event: the monotonic ``ts`` (seconds since
    tracer start) plus the derived ``wall`` timestamp."""
    wall0 = tracer.wall0
    for ev in tracer.events:
        yield json.dumps({"wall": round(wall0 + ev["ts"], 6), **ev})


def write_jsonl(tracer, path: str) -> int:
    """Write the event log to ``path``; returns the line count."""
    n = 0
    with open(path, "w") as f:
        for line in jsonl_lines(tracer):
            f.write(line + "\n")
            n += 1
    return n
