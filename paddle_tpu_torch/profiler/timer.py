"""Step timing and throughput: ``benchmark()``.

Port of ``paddle_tpu/profiler/timer.py`` (reference:
``python/paddle/profiler/timer.py``, the timer hapi's ``fit`` reports ips
with): host wall times between ``step`` calls, with the sample counts
given.
"""
from __future__ import annotations

import time
from typing import Optional


class _Benchmark:
    """Per-step wall times and sample counts: ``begin()``,
    ``step(num_samples)``, ``end()``, then ``step_info()``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t_last: Optional[float] = None
        self._times: list = []
        self._samples: list = []
        self.events: int = 0

    def begin(self) -> None:
        self._t_last = time.perf_counter()

    def step(self, num_samples: Optional[int] = None) -> None:
        now = time.perf_counter()
        if self._t_last is not None:
            self._times.append(now - self._t_last)
            self._samples.append(num_samples or 0)
        self._t_last = now
        self.events += 1

    def end(self) -> None:
        self._t_last = None

    def _steady(self):
        # the first step (a build) is left out when there are enough
        if len(self._times) > 2:
            return self._times[1:], self._samples[1:]
        return self._times, self._samples

    def step_info(self, unit: str = "samples") -> str:
        if not self._times:
            return ""
        ts, ss = self._steady()
        msg = f"avg_step: {sum(ts) / len(ts) * 1e3:.2f} ms"
        if any(ss):
            msg += f", ips: {sum(ss) / sum(ts):.2f} {unit}/s"
        return msg

    @property
    def avg_step_seconds(self) -> float:
        ts, _ = self._steady()
        return sum(ts) / len(ts) if ts else 0.0


_bench = _Benchmark()


def benchmark() -> _Benchmark:
    """The process's timer (the one hapi's ``fit`` loop reports)."""
    return _bench
