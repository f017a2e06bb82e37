"""Statistics tables over a captured trace.

Port of ``paddle_tpu/profiler/statistic.py`` (reference:
``python/paddle/profiler/profiler_statistic.py``: event aggregation, the
summary tables, ``SortedKeys``).  The input is a chrome trace's complete
events (``ph == "X"``).  ``torch.profiler`` (Kineto) marks each with a
``cat``: the device events are ``kernel``, ``gpu_memcpy`` and
``gpu_memset``; the host events ``cpu_op``, ``user_annotation`` and
``python_function``; other categories (the runtime's launch calls, a user
annotation's device-side copy ``gpu_user_annotation``) are left out.  An
event without a ``cat`` is placed by its process's name, as the JAX
package places its own traces' events.  Device busy time is the union of
the device spans.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

DEVICE_CATS = frozenset(["kernel", "gpu_memcpy", "gpu_memset"])
HOST_CATS = frozenset(["cpu_op", "user_annotation", "python_function"])


class SortedKeys(enum.Enum):
    """Reference: ``profiler_statistic.py SortedKeys`` (GPU* spelled
    Device*)."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    DeviceTotal = 4
    DeviceAvg = 5
    DeviceMax = 6
    DeviceMin = 7


@dataclass
class EventSummary:
    name: str
    call: int = 0
    total_us: float = 0.0
    max_us: float = 0.0
    min_us: float = float("inf")

    def add(self, dur_us: float) -> None:
        self.call += 1
        self.total_us += dur_us
        self.max_us = max(self.max_us, dur_us)
        self.min_us = min(self.min_us, dur_us)

    @property
    def avg_us(self) -> float:
        return self.total_us / self.call if self.call else 0.0


def _busy(spans: List[tuple]) -> float:
    """The length of the union of ``(start, end)`` spans."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


@dataclass
class StatisticData:
    """One capture's host spans and device ops, aggregated by name."""
    host: Dict[str, EventSummary] = field(default_factory=dict)
    device: Dict[str, EventSummary] = field(default_factory=dict)
    device_busy_us: float = 0.0
    wall_us: float = 0.0

    @classmethod
    def from_chrome_trace(cls, trace: dict) -> "StatisticData":
        events = trace.get("traceEvents", []) if isinstance(trace, dict) \
            else trace
        pid_names: Dict[object, str] = {}
        for ev in events:
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                pid_names[ev.get("pid")] = ev.get("args", {}).get("name", "")

        def place(ev) -> Optional[str]:
            cat = ev.get("cat")
            if cat is not None:
                return "device" if cat in DEVICE_CATS else \
                    "host" if cat in HOST_CATS else None
            n = pid_names.get(ev.get("pid"), "").lower()
            device = ("device" in n or "tpu" in n or "gpu" in n
                      or "/device:" in n)
            return "device" if device else "host"

        data = cls()
        t0, t1 = float("inf"), 0.0
        dev_spans: List[tuple] = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            where = place(ev)
            if where is None:
                continue
            dur = float(ev.get("dur", 0.0))
            ts = float(ev.get("ts", 0.0))
            t0, t1 = min(t0, ts), max(t1, ts + dur)
            table = data.device if where == "device" else data.host
            name = ev.get("name", "?")
            table.setdefault(name, EventSummary(name)).add(dur)
            if where == "device":
                dev_spans.append((ts, ts + dur))
        data.wall_us = max(t1 - t0, 0.0)
        data.device_busy_us = _busy(dev_spans)
        return data

    # -- tables -------------------------------------------------------------

    def top(self, kind: str = "device",
            sorted_by: SortedKeys = SortedKeys.DeviceTotal,
            limit: int = 20) -> List[EventSummary]:
        table = self.device if kind == "device" else self.host
        keyfn = {
            SortedKeys.CPUTotal: lambda e: e.total_us,
            SortedKeys.CPUAvg: lambda e: e.avg_us,
            SortedKeys.CPUMax: lambda e: e.max_us,
            SortedKeys.CPUMin: lambda e: e.min_us,
            SortedKeys.DeviceTotal: lambda e: e.total_us,
            SortedKeys.DeviceAvg: lambda e: e.avg_us,
            SortedKeys.DeviceMax: lambda e: e.max_us,
            SortedKeys.DeviceMin: lambda e: e.min_us,
        }[sorted_by]
        return sorted(table.values(), key=keyfn, reverse=True)[:limit]

    def format_tables(self, sorted_by: SortedKeys = SortedKeys.DeviceTotal,
                      row_limit: int = 20, time_unit: str = "ms") -> str:
        scale = {"s": 1e-6, "ms": 1e-3, "us": 1.0}[time_unit]

        def fmt(v_us: float) -> str:
            return f"{v_us * scale:.3f}"

        def table(title: str, rows: List[EventSummary]) -> List[str]:
            if not rows:
                return []
            w = min(max([len(r.name) for r in rows] + [len("name")]), 60)
            out = [f"\n---- {title} (times in {time_unit}) ----",
                   f"{'name':<{w}}  {'calls':>6}  {'total':>12}  "
                   f"{'avg':>10}  {'max':>10}  {'min':>10}"]
            for r in rows:
                nm = r.name if len(r.name) <= w else r.name[:w - 1] + "…"
                out.append(f"{nm:<{w}}  {r.call:>6}  {fmt(r.total_us):>12}  "
                           f"{fmt(r.avg_us):>10}  {fmt(r.max_us):>10}  "
                           f"{fmt(r.min_us):>10}")
            tot = sum(r.total_us for r in rows)
            out.append(f"{'(sum)':<{w}}  {'':>6}  {fmt(tot):>12}")
            return out

        lines: List[str] = []
        if self.wall_us:
            util = 100.0 * self.device_busy_us / self.wall_us
            lines.append(f"capture wall: {fmt(self.wall_us)} {time_unit}   "
                         f"device busy: {fmt(self.device_busy_us)} "
                         f"{time_unit} ({util:.1f}%)")
        lines += table("device ops", self.top("device", sorted_by, row_limit))
        host_key = SortedKeys.CPUTotal if sorted_by == \
            SortedKeys.DeviceTotal else sorted_by
        lines += table("host spans", self.top("host", host_key, row_limit))
        return "\n".join(lines)
