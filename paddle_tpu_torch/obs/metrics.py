"""Prometheus-style text exposition of the engine's ``stats()`` snapshot.

The port's copy of ``render_metrics`` from ``paddle_tpu/obs/metrics.py``.
``Engine.stats()`` already exports everything a dashboard needs as
nested JSON; this flattens that same dict into the ``name{labels}
value`` text format scrapers ingest: no new counters, no second
bookkeeping path that could drift from the real one.  Numeric leaves
become samples, booleans 0/1, the ``state``-like strings ``*_info``
gauges with the string as a label, and everything else is skipped.
The metric names keep the reference's ``paddle_tpu_serving`` prefix, so
a dashboard binds to either package the same way.

::

    from paddle_tpu_torch import obs
    print(obs.render_metrics(engine.stats()))
    # paddle_tpu_serving_queue_depth{engine="engine-0"} 0

:func:`render_all_metrics` walks every live engine, fleet and training
loop through :mod:`paddle_tpu_torch.profiler`: the process-wide
``/metrics`` body, serving snapshots under ``paddle_tpu_serving*`` and the
training observatory (timeline, compile ledger, cost ledger, sentry)
under ``paddle_tpu_train``.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Optional, Tuple

__all__ = ["render_metrics", "render_all_metrics"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: string leaves exported as ``<name>_info{value="..."} 1``
_INFO_KEYS = ("state", "kv_block_invariants", "kv_layout", "kernel",
              "engine_state", "replica_state", "fingerprint", "chip",
              "bound")


def _metric_name(*parts: str) -> str:
    return "_".join(_NAME_RE.sub("_", str(p)).strip("_")
                    for p in parts if str(p) != "")


def _label_value(v) -> str:
    """Escape per the exposition format: backslash, double quote and
    newline are the three characters escaped inside a label value."""
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{_label_value(v)}"'
                    for k, v in sorted(labels.items()))
    return "{" + body + "}"


def _walk(node, path: Tuple[str, ...]) -> Iterator[Tuple[Tuple[str, ...],
                                                         object]]:
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, path + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, node


def render_metrics(snapshot: dict, *, prefix: str = "paddle_tpu_serving",
                   labels: Optional[Dict[str, str]] = None) -> str:
    """Flatten one ``stats()`` snapshot into exposition text.  The
    snapshot's ``name`` becomes an ``engine`` label by default, so the
    same metric name aggregates across engines."""
    labels = dict(labels or {})
    if not labels and isinstance(snapshot.get("name"), str):
        labels["engine"] = snapshot["name"]
    lab = _labels(labels)
    lines = []
    for path, v in _walk(snapshot, ()):
        if path and path[-1] == "name":
            continue
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, (int, float)):
            lines.append(f"{_metric_name(prefix, *path)}{lab} {v}")
        elif isinstance(v, str) and path and path[-1] in _INFO_KEYS:
            name = _metric_name(prefix, *path) + "_info"
            lines.append(f"{name}{_labels({**labels, 'value': v})} 1")
    return "\n".join(lines) + ("\n" if lines else "")


def render_all_metrics(prefix: str = "paddle_tpu_serving") -> str:
    """The process-wide ``/metrics`` body: every live engine's, fleet's and
    training loop's snapshot, flattened.  Training metrics render under
    ``paddle_tpu_train`` whatever ``prefix`` is, so one scrape covers both
    stacks without name collisions."""
    from .. import profiler

    chunks = []
    for name, snap in profiler.serving_stats().items():
        chunks.append(render_metrics(snap, prefix=prefix,
                                     labels={"engine": name}))
    for name, snap in profiler.serving_fleet().items():
        chunks.append(render_metrics(snap, prefix=prefix + "_fleet",
                                     labels={"fleet": name}))
    for name, snap in profiler.train_stats().items():
        chunks.append(render_metrics(snap, prefix="paddle_tpu_train",
                                     labels={"loop": name}))
    return "".join(chunks)
