"""paddle_tpu_torch.obs: observability of the serving and training stacks.

The port's copy of ``paddle_tpu/obs``: a thin, dependency-free export
layer over :class:`paddle_tpu_torch.serving.tracing.RequestTracer`, the
training :class:`StepTimeline` and the ``stats()`` snapshots.

- :func:`chrome_trace` / :func:`write_chrome_trace`: Chrome/Perfetto
  trace-event JSON, one track group per engine, one thread per slot plus
  a scheduler track, spans as complete events, preempt links as flow
  arrows, per-step batch occupancy as a counter track;
- :func:`jsonl_lines` / :func:`write_jsonl`: one JSON object per event,
  wall-clock timestamps added at export from the tracer's anchor pair;
- :func:`render_metrics` / :func:`render_all_metrics`: text exposition
  of a ``stats()`` snapshot, or of every live engine, fleet and training
  loop (:mod:`paddle_tpu_torch.profiler`);
- :class:`FlightRecorder`: the always-on bounded step-summary ring each
  engine feeds;
- :func:`persist_crash_artifacts`: freeze every live flight ring and
  tracer into one JSON file before a process dies
  (:mod:`.crashdump`).

The training step observatory:

- :class:`StepTimeline` / :func:`validate_timeline`: host-side per-step
  spans (dispatch, device wait, snapshot, checkpoint, rollback, skip),
  rendered by the same Perfetto and JSONL exporters;
- :class:`CompileLedger`: every program build of a ``jit.to_static``
  step, named and timed, a steady-state build a named anomaly;
- :class:`CostLedger`: one eager run of a step counted (flops, bytes, op
  mix, fingerprint, the analytic roofline on the H100).

Everything here is host-side and read-only, apart from the one guarded
eager run of :class:`CostLedger`: exporting never touches an engine, a
device tensor or a step program.
"""
from .compile_ledger import CompileLedger
from .cost import CostLedger
from .crashdump import persist_crash_artifacts
from .flight import FlightRecorder
from .jsonl import jsonl_lines, write_jsonl
from .metrics import render_all_metrics, render_metrics
from .perfetto import chrome_trace, write_chrome_trace
from .train import NULL_TIMELINE, StepTimeline, validate_timeline

__all__ = ["FlightRecorder", "chrome_trace", "write_chrome_trace",
           "jsonl_lines", "write_jsonl", "render_metrics",
           "render_all_metrics", "persist_crash_artifacts", "StepTimeline",
           "NULL_TIMELINE", "validate_timeline", "CompileLedger",
           "CostLedger"]
