"""The profiler: schedule-driven tracing with statistics tables, and the
process-wide registry of live serving engines, fleets and training loops.

Port of ``paddle_tpu/profiler/__init__.py`` (reference:
``python/paddle/profiler/profiler.py:271`` ``Profiler`` with its
CLOSED/READY/RECORD(_AND_RETURN) state machine, ``make_scheduler:71``,
``export_chrome_tracing:158``; ``profiler_statistic.py``'s tables,
:mod:`.statistic`; ``timer.py``'s ``benchmark``, :mod:`.timer`).

:class:`Profiler` keeps the JAX package's state machine (``start``,
``step``, ``stop``) over ``torch.profiler`` (Kineto, CUPTI on the card):
a cycle's READY steps run the tracer as a warm-up
(``torch.profiler.profile.prepare_trace``), its RECORD steps record
(``start_trace``; on the card a recording opens with the card idle
``WINDOW_LEAD_S``), and leaving the cycle stops it (``stop_trace``) and
hands the trace to ``on_trace_ready``.  Torch's own ``schedule=`` is not
used: it clears events at the end of each of its cycles.
``ProfilerTarget`` has Paddle's ``CPU`` and ``GPU`` (``TPU`` an alias of
``GPU``); :class:`RecordEvent` is ``torch.profiler.record_function`` with
``begin``/``end``.  ``export_chrome_tracing`` writes
``torch.profiler``'s chrome JSON; ``export_protobuf`` records the file of
``torch.profiler.tensorboard_trace_handler``, the nearest counterpart of
the JAX package's XPlane protobuf.  ``timer_only=True`` traces nothing.

The registry (:47-200 of the JAX file): each
:class:`~..serving.engine.Engine`, :class:`~..serving.router.Fleet` and
armed :class:`~..distributed.fault_tolerance.ResilientLoop` registers
itself at construction, held weakly: an object that goes away leaves the
registry at the next read, and the registry never keeps one alive.
:func:`paddle_tpu_torch.obs.render_all_metrics` flattens everything here
into one text exposition.
"""
from __future__ import annotations

import enum
import gzip
import json
import os
import time
import weakref
from typing import Callable, Iterable, List, Optional, Union

from .statistic import EventSummary, SortedKeys, StatisticData
from .timer import benchmark

__all__ = ["serving_stats", "serving_health", "serving_paging",
           "serving_fleet", "train_stats", "flight_record",
           "serving_flight_record", "ProfilerState", "ProfilerTarget",
           "make_scheduler", "export_chrome_tracing", "export_protobuf",
           "RecordEvent", "Profiler", "load_profiler_result",
           "StatisticData", "SortedKeys", "EventSummary", "benchmark"]

_engines: List[weakref.ref] = []
_fleets: List[weakref.ref] = []
_train_loops: List[weakref.ref] = []


def _live(refs: List[weakref.ref]) -> list:
    """Dereference ``refs``, pruning the dead ones."""
    out, live = [], []
    for ref in refs:
        obj = ref()
        if obj is None:
            continue
        live.append(ref)
        out.append(obj)
    refs[:] = live
    return out


def _register_serving_metrics(engine) -> None:
    """An engine joins the serving surface (its ``stats()``/``health()``)."""
    _engines.append(weakref.ref(engine))


def _register_fleet_metrics(fleet) -> None:
    _fleets.append(weakref.ref(fleet))


def _register_train_stats(loop) -> None:
    """A training loop joins :func:`train_stats` (its ``train_stats()``)."""
    _train_loops.append(weakref.ref(loop))


def _keyed(objs, snap: Callable, default: str) -> dict:
    """``{name: snap(obj)}``, a repeated name suffixed ``#2``, ``#3``..."""
    out = {}
    for o in objs:
        s = snap(o)
        name = getattr(o, "name", None) or default
        key, i = name, 1
        while key in out:
            i += 1
            key = f"{name}#{i}"
        out[key] = s
    return out


def serving_stats() -> dict:
    """Every live engine's ``stats()``, keyed by engine name."""
    return _keyed(_live(_engines), lambda e: e.stats(), "engine")


def serving_health() -> dict:
    """Every live engine's ``health()`` (the cheap liveness probe), keyed
    by engine name."""
    return _keyed(_live(_engines), lambda e: e.health(), "engine")


def serving_paging() -> dict:
    """The paged-KV section of every live paged engine's stats, keyed by
    engine name (contiguous engines are left out)."""
    out = {}
    for name, snap in serving_stats().items():
        if snap.get("paging") is not None:
            out[name] = snap["paging"]
    return out


def serving_fleet() -> dict:
    """Every live fleet's ``stats()``, keyed by fleet name."""
    return _keyed(_live(_fleets), lambda f: f.stats(), "fleet")


def train_stats() -> dict:
    """Every live training loop's observatory (timeline counters, compile
    ledger under ``"compiles"``, cost ledger, sentry counters), keyed by
    loop name (``#2``... when loops share one)."""
    return _keyed(_live(_train_loops), lambda o: o.train_stats(),
                  "training")


def flight_record() -> dict:
    """Every live flight recorder (engines and training loops): its ring's
    snapshot with the dumps frozen so far, plus the dumps a fleet banked
    at its ejections (which outlive the ejected engine).  ``{name:
    [snapshot_or_dump, ...]}``, newest last."""
    from ..obs.flight import live_recorders

    out: dict = {}
    seen = set()
    for rec in sorted(live_recorders(), key=lambda r: r.name):
        out.setdefault(rec.name, []).append(rec.snapshot())
        seen.update(id(d) for d in rec.dumps)
    for fleet in _live(_fleets):
        for rep in fleet.replicas:
            for d in rep.flight_dumps:
                if id(d) not in seen:
                    out.setdefault(d["name"], []).append(
                        {"name": d["name"], "banked": True, "dumps": [d]})
    return out


#: the serving-era name of :func:`flight_record`
serving_flight_record = flight_record


# -- the Profiler -------------------------------------------------------------

class ProfilerState(enum.Enum):
    """Reference: ``profiler.py ProfilerState`` (:34)."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3  # the last RECORD step of a cycle


class ProfilerTarget(enum.Enum):
    """What to trace: host ops (``CPU``) and the card's kernels and copies
    (``GPU``; ``TPU`` is its alias, as ``device.tpu`` is of
    ``device.cuda``)."""
    CPU = 0
    GPU = 1
    TPU = 1


def make_scheduler(*, closed: int, ready: int, record: int,
                   repeat: int = 0, skip_first: int = 0
                   ) -> Callable[[int], ProfilerState]:
    """A step -> state schedule: ``skip_first`` steps CLOSED, then cycles of
    ``closed`` CLOSED, ``ready`` READY and ``record`` RECORD steps (the last
    RECORD_AND_RETURN), ``repeat`` times (0: forever).  Reference:
    ``profiler.py:71``."""
    if closed < 0 or ready < 0 or record <= 0:
        raise ValueError("closed/ready must be >=0 and record >=1")
    cycle = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        if repeat and step >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = step % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


#: seconds the card idles at the start of every recording window: CUPTI
#: can drop the first device records after tracing starts (a prefix of a
#: GPT-2 345M step's attention launches); not seen with the card idle first
WINDOW_LEAD_S = 0.05


def _default_state_fn(_step: int) -> ProfilerState:
    return ProfilerState.RECORD


def _trace_name(dir_name: str, worker_name: Optional[str]) -> str:
    worker = worker_name or f"host_{os.getpid()}"
    return os.path.join(dir_name, f"{worker}_{time.time_ns()}"
                                  ".paddle_trace.json")


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None
                          ) -> Callable:
    """``on_trace_ready``: write the cycle's chrome trace into ``dir_name``
    (``<worker>_<ns>.paddle_trace.json``) and remember its path on the
    profiler.  Reference: ``profiler.py:158``."""

    def handle(prof: "Profiler") -> None:
        os.makedirs(dir_name, exist_ok=True)
        path = _trace_name(dir_name, worker_name)
        prof._torch_prof.export_chrome_trace(path)
        prof._exported_chrome_trace = path

    handle._dir_name = dir_name  # type: ignore[attr-defined]
    return handle


def export_protobuf(dir_name: str, worker_name: Optional[str] = None
                    ) -> Callable:
    """``on_trace_ready``: the file ``torch.profiler.
    tensorboard_trace_handler`` writes into ``dir_name`` (the TensorBoard
    plugin's input, a chrome JSON), remembered on the profiler as
    ``exported_protobuf``; the JAX package records its XPlane protobuf
    there."""

    def handle(prof: "Profiler") -> None:
        import torch.profiler as tp

        os.makedirs(dir_name, exist_ok=True)
        before = set(os.listdir(dir_name))
        tp.tensorboard_trace_handler(dir_name, worker_name)(prof._torch_prof)
        new = sorted(set(os.listdir(dir_name)) - before)
        if new:
            prof._exported_protobuf = os.path.join(dir_name, new[-1])
            prof._exported_chrome_trace = prof._exported_protobuf

    handle._dir_name = dir_name  # type: ignore[attr-defined]
    return handle


def _record_function():
    import torch.profiler as tp

    return tp.record_function


class RecordEvent:
    """A user-annotated span, in the trace and the host table
    (reference ``paddle.profiler.RecordEvent``): a
    ``torch.profiler.record_function``, as a context manager or with
    ``begin()`` / ``end()``."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._fn = None

    def begin(self) -> None:
        self._fn = _record_function()(self.name)
        self._fn.__enter__()

    def end(self) -> None:
        if self._fn is not None:
            self._fn.__exit__(None, None, None)
            self._fn = None

    def __enter__(self) -> "RecordEvent":
        self.begin()
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


class Profiler:
    """Schedule-driven profiler over ``torch.profiler`` (module docstring).

    Each ``step()`` advances the step count and enters the scheduler's
    state: from CLOSED into READY or RECORD the tracer starts (READY: its
    warm-up), and leaving RECORD_AND_RETURN (or ``stop()`` while
    recording) stops it and calls ``on_trace_ready``.  ``targets``: a list
    of :class:`ProfilerTarget` (default: the CPU, and the GPU when there is
    a card).  ``scheduler``: a schedule, a ``(start, end)`` pair of steps,
    or None (record every step).  ``timer_only=True`` only times the
    steps."""

    def __init__(self, *, targets: Optional[Iterable[ProfilerTarget]] = None,
                 scheduler: Union[Callable, tuple, None] = None,
                 on_trace_ready: Optional[Callable] = None,
                 timer_only: bool = False, log_dir: Optional[str] = None):
        if isinstance(scheduler, (tuple, list)):   # (start, end) sugar
            start, end = scheduler
            scheduler = make_scheduler(closed=max(start, 0), ready=0,
                                       record=end - start, repeat=1)
        self._state_fn = scheduler or _default_state_fn
        self._targets = None if targets is None else list(targets)
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._log_dir = log_dir or getattr(on_trace_ready, "_dir_name",
                                           None) or "./profiler_log"
        self.current_state = ProfilerState.CLOSED
        self._step = 0
        self._torch_prof = None
        self._on_card = False
        self._tracing = False
        self._warmup = False
        self._exported_chrome_trace: Optional[str] = None
        self._exported_protobuf: Optional[str] = None
        self._step_times: list = []
        self._t_last: Optional[float] = None

    # -- the tracer -----------------------------------------------------------

    def _activities(self) -> list:
        import torch
        import torch.profiler as tp

        targets = self._targets
        if targets is None:
            targets = [ProfilerTarget.CPU] + (
                [ProfilerTarget.GPU] if torch.cuda.is_available() else [])
        acts = []
        if ProfilerTarget.CPU in targets:
            acts.append(tp.ProfilerActivity.CPU)
        if ProfilerTarget.GPU in targets:
            if not torch.cuda.is_available():
                raise RuntimeError("Profiler: ProfilerTarget.GPU asked for, "
                                   "but no CUDA device is available")
            acts.append(tp.ProfilerActivity.CUDA)
        return acts

    def _start_trace(self, warmup: bool) -> None:
        """READY (``warmup``): a new tracer in its warm-up; RECORD: the
        warm-up's tracer, or a new one, recording."""
        if self._timer_only:
            return
        import torch
        import torch.profiler as tp

        if self._torch_prof is None:
            acts = self._activities()
            self._on_card = tp.ProfilerActivity.CUDA in acts
            # one profile a cycle (acc_events: keep what this cycle
            # records; torch's own schedule is not used)
            self._torch_prof = tp.profile(activities=acts, acc_events=True)
            self._torch_prof.prepare_trace()
        if not warmup:
            self._torch_prof.start_trace()
            self._tracing = True
            if self._on_card:
                torch.cuda.synchronize()
                time.sleep(WINDOW_LEAD_S)

    def _stop_trace(self, ready: bool) -> None:
        """End the cycle's tracer; ``ready`` hands a recording's trace to
        ``on_trace_ready`` (a warm-up's is dropped)."""
        prof = self._torch_prof
        if prof is None:
            return
        if not self._tracing:           # a warm-up: start, then drop it
            prof.start_trace()
        prof.stop_trace()
        recorded, self._tracing = self._tracing, False
        if ready and recorded:
            if self._on_trace_ready is not None:
                self._on_trace_ready(self)
            else:
                os.makedirs(self._log_dir, exist_ok=True)
                path = _trace_name(self._log_dir, None)
                prof.export_chrome_trace(path)
                self._exported_chrome_trace = path
        self._torch_prof = None

    # -- the state machine ----------------------------------------------------

    def _transit(self, new: ProfilerState) -> None:
        old = self.current_state
        if old == new:
            return
        rec = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        if old == ProfilerState.CLOSED and new != ProfilerState.CLOSED:
            self._start_trace(warmup=new == ProfilerState.READY)
        elif old == ProfilerState.READY and new in rec:
            self._start_trace(warmup=False)
        elif old == ProfilerState.READY and new == ProfilerState.CLOSED:
            self._stop_trace(ready=False)
        elif old in rec and new == ProfilerState.CLOSED:
            self._stop_trace(ready=True)
        elif old in rec and new == ProfilerState.READY:
            self._stop_trace(ready=True)
            self._start_trace(warmup=True)
        self.current_state = new

    def start(self) -> "Profiler":
        self._t_last = time.perf_counter()
        self._transit(self._state_fn(self._step))
        return self

    def step(self, num_samples: Optional[int] = None) -> None:
        now = time.perf_counter()
        if self._t_last is not None:
            self._step_times.append((now - self._t_last, num_samples))
        self._t_last = now
        # leaving RECORD_AND_RETURN ends the cycle even when the next state
        # records again
        if self.current_state == ProfilerState.RECORD_AND_RETURN:
            self._stop_trace(ready=True)
            self.current_state = ProfilerState.CLOSED
        self._step += 1
        self._transit(self._state_fn(self._step))

    def stop(self) -> None:
        self._stop_trace(ready=self.current_state in (
            ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN))
        self.current_state = ProfilerState.CLOSED

    def __enter__(self) -> "Profiler":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- results ----------------------------------------------------------------

    @property
    def chrome_trace_path(self) -> Optional[str]:
        return self._exported_chrome_trace

    @property
    def exported_protobuf(self) -> Optional[str]:
        return self._exported_protobuf

    def statistic_data(self) -> Optional[StatisticData]:
        path = self._exported_chrome_trace
        return None if path is None else load_profiler_result(path)

    def summary(self, sorted_by: SortedKeys = SortedKeys.DeviceTotal,
                op_detail: bool = True, thread_sep: bool = False,
                time_unit: str = "ms", row_limit: int = 20) -> str:
        """Print and return the step times and the last trace's tables
        (reference ``profiler_statistic.py`` summary)."""
        lines = []
        if self._step_times:
            ts = [t for t, _ in self._step_times[1:]] or \
                [t for t, _ in self._step_times]
            lines.append(f"steps: {len(self._step_times)}  avg step: "
                         f"{sum(ts) / len(ts) * 1e3:.2f} ms")
            timed = [(t, n) for t, n in self._step_times if n]
            if timed:
                ips = sum(n for _, n in timed) / sum(t for t, _ in timed)
                lines.append(f"ips: {ips:.2f} samples/s")
        data = self.statistic_data()
        if data is not None:
            lines.append(data.format_tables(sorted_by=sorted_by,
                                            row_limit=row_limit,
                                            time_unit=time_unit))
        out = "\n".join(lines)
        print(out)
        return out


def load_profiler_result(path: str) -> StatisticData:
    """A chrome trace file (``.json`` or ``.json.gz``) as a
    :class:`StatisticData`.  Reference: ``profiler.py
    load_profiler_result``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return StatisticData.from_chrome_trace(trace)
