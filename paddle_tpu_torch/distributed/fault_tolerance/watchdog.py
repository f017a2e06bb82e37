"""Step watchdog: turn a wedged step into a diagnosable failure.

The port's copy of ``paddle_tpu/distributed/fault_tolerance/watchdog.py``.
A wedged step (a device that never finishes, a deadlocked host callback)
blocks its thread forever while the process looks alive.  The watchdog
is a daemon thread fed a heartbeat at every step boundary; when no
boundary is crossed within ``timeout`` seconds it:

1. dumps every thread's stack to stderr (the stalled thread's stack names
   the blocked call),
2. prints the last dispatched step program (``last_op``, the key of the
   last program a :class:`~paddle_tpu_torch.serving.programs.StepPrograms`
   ran: the port has no op dispatcher),
3. calls ``on_timeout`` and, with ``hard_exit``, persists the flight
   rings and armed tracers (:func:`~paddle_tpu_torch.obs.crashdump.
   persist_crash_artifacts`) and exits the process with
   :data:`ELASTIC_EXIT_CODE` through ``os._exit`` (``sys.exit`` from a
   thread other than the main one would end the watchdog only), so a
   launcher's restart path relaunches it.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from ..fleet.elastic.manager import ELASTIC_EXIT_CODE

__all__ = ["StepWatchdog", "dump_all_stacks", "ELASTIC_EXIT_CODE"]


def dump_all_stacks(file=None):
    """Write every live thread's current stack to ``file`` (stderr)."""
    file = file or sys.stderr
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sys._current_frames().items():
        print(f"--- thread {names.get(ident, '?')} ({ident}) ---",
              file=file)
        for line in traceback.format_stack(frame):
            file.write(line)


class StepWatchdog:
    """Monitor thread that fires when no step boundary is crossed in time.

    ``notify(step)`` is the heartbeat; ``pause()`` suspends the deadline
    over phases that may legitimately take long and are not steps (a
    program's build, the host work between steps).  Until two boundaries
    have been crossed the deadline is ``timeout * startup_factor``: the
    first steps may carry cold builds.
    """

    def __init__(self, timeout: float,
                 exit_code: int = ELASTIC_EXIT_CODE,
                 poll_interval: Optional[float] = None,
                 on_timeout: Optional[Callable[[], None]] = None,
                 hard_exit: bool = True,
                 startup_factor: float = 10.0,
                 last_op: Optional[Callable[[], object]] = None):
        if timeout <= 0:
            raise ValueError("watchdog timeout must be > 0")
        self.timeout = float(timeout)
        self.exit_code = exit_code
        self.poll_interval = poll_interval or min(self.timeout / 4.0, 1.0)
        self.on_timeout = on_timeout
        self.hard_exit = hard_exit
        self.startup_factor = float(startup_factor)
        self.last_op = last_op
        self.last_step: Optional[int] = None
        self._boundaries = 0
        self.fired = False
        self._deadline_base = None          # None = paused
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._watch, name="paddle-tpu-step-watchdog", daemon=True)

    # -- lifecycle -------------------------------------------------------

    def start(self):
        with self._lock:
            self._deadline_base = time.monotonic()
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=self.poll_interval * 4)

    def request_stop(self):
        """Signal the monitor thread to exit without joining: safe to
        call from a garbage-collection finalizer (joining is not)."""
        self._stop.set()

    @property
    def alive(self) -> bool:
        """True while the monitor thread is still watching (it exits
        after firing once when ``hard_exit`` is off, and on stop)."""
        return self._thread.is_alive() and not self.fired

    # -- heartbeat -------------------------------------------------------

    def notify(self, step: int):
        with self._lock:
            if step != self.last_step:
                self._boundaries += 1
            self.last_step = step
            self._deadline_base = time.monotonic()

    def pause(self):
        with self._lock:
            self._deadline_base = None

    # -- monitor ---------------------------------------------------------

    def _watch(self):
        while not self._stop.wait(self.poll_interval):
            with self._lock:
                base = self._deadline_base
                warmed = self._boundaries >= 2   # one full step completed
            if base is None:
                continue
            deadline = self.timeout if warmed \
                else self.timeout * self.startup_factor
            stalled = time.monotonic() - base
            if stalled < deadline:
                continue
            self.fired = True
            self._report(stalled, deadline)
            if self.on_timeout is not None:
                self.on_timeout()
            if self.hard_exit:
                # the post-mortem must outlive the process os._exit is
                # about to end: best effort, it never blocks the exit
                try:
                    from ...obs.crashdump import persist_crash_artifacts

                    p = persist_crash_artifacts(
                        f"watchdog: no step boundary for "
                        f"{stalled:.1f}s (deadline {deadline:.1f}s)")
                    if p:
                        print(f"[watchdog] crash artifacts persisted "
                              f"to {p}", file=sys.stderr)
                except Exception:        # noqa: BLE001 — exiting anyway
                    pass
                sys.stderr.flush()
                sys.stdout.flush()
                os._exit(self.exit_code)
            return

    def _report(self, stalled: float, deadline: float):
        # notify() fires at the start of each step, so last_step is the
        # step that is stalled, not one that completed
        step = "during startup" if self.last_step is None \
            else f"in step {self.last_step}"
        op = self.last_op() if self.last_op is not None else None
        print(f"[watchdog] no step boundary for {stalled:.1f}s "
              f"(deadline {deadline:.1f}s) — stalled {step}; "
              f"last dispatched program: {op!r}", file=sys.stderr)
        dump_all_stacks(sys.stderr)
        print(f"[watchdog] exiting with code {self.exit_code} for relaunch"
              if self.hard_exit else
              "[watchdog] hard_exit disabled; invoking on_timeout only",
              file=sys.stderr)
