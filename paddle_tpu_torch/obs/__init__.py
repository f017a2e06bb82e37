"""paddle_tpu_torch.obs: observability of the port's serving engine.

The port's copy of the serving half of ``paddle_tpu/obs``: a thin,
dependency-free export layer over
:class:`paddle_tpu_torch.serving.tracing.RequestTracer` and the
``Engine.stats()`` snapshot.

- :func:`chrome_trace` / :func:`write_chrome_trace`: Chrome/Perfetto
  trace-event JSON, one track group per engine, one thread per slot plus
  a scheduler track, spans as complete events, preempt links as flow
  arrows, per-step batch occupancy as a counter track;
- :func:`jsonl_lines` / :func:`write_jsonl`: one JSON object per event,
  wall-clock timestamps added at export from the tracer's anchor pair;
- :func:`render_metrics`: text exposition of a ``stats()`` snapshot;
- :class:`FlightRecorder`: the always-on bounded step-summary ring each
  engine feeds;
- :func:`persist_crash_artifacts`: freeze every live flight ring and
  tracer into one JSON file before a process dies
  (:mod:`.crashdump`).

Everything here is host-side and read-only: exporting never touches an
engine, a device tensor or a step program.
"""
from .crashdump import persist_crash_artifacts
from .flight import FlightRecorder
from .jsonl import jsonl_lines, write_jsonl
from .metrics import render_metrics
from .perfetto import chrome_trace, write_chrome_trace

__all__ = ["FlightRecorder", "chrome_trace", "write_chrome_trace",
           "jsonl_lines", "write_jsonl", "render_metrics",
           "persist_crash_artifacts"]
