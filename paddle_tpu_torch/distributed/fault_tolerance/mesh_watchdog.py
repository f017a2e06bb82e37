"""Mesh health watchdog: per-host heartbeat, wedged-collective deadline,
and step-time straggler flagging over the elastic coordinator duck.

The port's copy of
``paddle_tpu/distributed/fault_tolerance/mesh_watchdog.py`` (plain Python;
the deadline is the port's :class:`~.watchdog.StepWatchdog`).

The elastic manager (``fleet.elastic.manager``) tracks *membership* —
node leases under ``.../nodes/<host>`` — which answers "is the process
alive?".  This watchdog answers the two questions a live process can
still fail: "is it making step progress?" and "is it dragging the whole
mesh?".  One :class:`MeshWatchdog` per host:

- **heartbeat** — a daemon thread publishes
  ``{"step", "ema_ms", "ts"}`` (JSON) under a lease at
  ``health_prefix(job_id) + host`` through the SAME coordinator duck
  the manager uses (``InMemoryCoordinator`` in tests,
  ``FileCoordinator`` across processes).  A host that stops beating
  goes stale after ``lease_ttl`` — readers just see it vanish, exactly
  like a node lease.  The chaos hook: ``elastic.heartbeat@N`` specs
  (``injection.FaultPlan.should_drop_heartbeat``) skip publishes
  deterministically.
- **wedged-collective deadline** — a composed :class:`StepWatchdog`
  with the same pause-over-save discipline ``ResilientLoop`` already
  uses: ``notify(step)`` at every boundary, ``pause()`` across
  checkpoint commits and rollbacks, hard-exit through
  ``persist_crash_artifacts`` + ``os._exit(ELASTIC_EXIT_CODE)`` so the
  manager sees exit-101 and relaunches.
- **straggler flagging** — ``notify`` maintains a per-host step-time
  EMA; the heartbeat thread compares its own EMA against the median of
  every host's published EMA and flags itself when
  ``ema > straggler_factor × median`` (needs ≥2 live hosts — a lone
  host has no median to drag).  ``straggler_patience`` consecutive
  flags escalate: crash artifacts are persisted, then the process
  exits ``ELASTIC_EXIT_CODE`` — the manager shrinks membership (the
  dead host's lease lapses) and relaunches the survivors at np−1.

Everything is host-side and best-effort: a watchdog failure must never
take down a healthy step loop.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

from ..fleet.elastic.manager import ELASTIC_EXIT_CODE, health_prefix
from .watchdog import StepWatchdog

__all__ = ["MeshWatchdog"]


class MeshWatchdog:
    """Per-host mesh health: heartbeat + wedged deadline + straggler EMA.

    ``collective_timeout=None`` disables the hard deadline (heartbeat
    and straggler flagging still run); ``hard_exit=False`` records the
    escalation instead of exiting — the test surface.
    """

    def __init__(self, coordinator, job_id: str, host: str, *,
                 heartbeat_interval: float = 1.0,
                 lease_ttl: Optional[float] = None,
                 collective_timeout: Optional[float] = None,
                 straggler_factor: float = 3.0,
                 straggler_patience: int = 3,
                 ema_alpha: float = 0.4,
                 exit_code: int = ELASTIC_EXIT_CODE,
                 hard_exit: bool = True,
                 fault_plan=None,
                 on_escalate=None):
        self.coord = coordinator
        self.host = str(host)
        self.key = health_prefix(job_id) + self.host
        self.prefix = health_prefix(job_id)
        self.heartbeat_interval = float(heartbeat_interval)
        self.lease_ttl = float(lease_ttl if lease_ttl is not None
                               else heartbeat_interval * 3)
        self.straggler_factor = float(straggler_factor)
        self.straggler_patience = int(straggler_patience)
        self.ema_alpha = float(ema_alpha)
        self.exit_code = int(exit_code)
        self.hard_exit = bool(hard_exit)
        self.fault_plan = fault_plan
        self.on_escalate = on_escalate
        self.step_watchdog = None
        if collective_timeout is not None:
            # the wedged-collective deadline: StepWatchdog already owns
            # the persist-artifacts-then-exit-101 path and the startup
            # grace for the cold compile
            self.step_watchdog = StepWatchdog(
                collective_timeout, exit_code=exit_code,
                hard_exit=hard_exit)
        self._lease = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._beat_loop, name="paddle-tpu-mesh-watchdog",
            daemon=True)
        # health state (all under _lock)
        self._last_step: Optional[int] = None
        self._last_notify: Optional[float] = None
        self.ema_ms: Optional[float] = None
        self._consecutive_slow = 0
        # counters (exported via stats())
        self.heartbeats = 0
        self.dropped_heartbeats = 0
        self.stragglers_flagged = 0
        self.escalated = False
        self.escalation_reason: Optional[str] = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "MeshWatchdog":
        """Register on the health prefix and start beating.  Idempotent —
        ResilientLoop starts an attached watchdog defensively."""
        if self._thread.is_alive():
            return self
        self._lease = self.coord.lease(self.lease_ttl)
        self._publish()           # register before the first interval
        self._thread.start()
        if self.step_watchdog is not None:
            self.step_watchdog.start()
        return self

    def stop(self):
        self._stop.set()
        if self.step_watchdog is not None:
            self.step_watchdog.stop()
        if self._thread.is_alive():
            self._thread.join(timeout=self.heartbeat_interval * 4)
        try:
            self.coord.delete(self.key)
        except Exception:
            pass

    # -- step-loop surface (mirrors StepWatchdog's discipline) -----------

    def notify(self, step: int):
        """Step-boundary heartbeat: feeds the wedged deadline AND the
        step-time EMA the straggler check publishes."""
        now = time.monotonic()
        with self._lock:
            if self._last_notify is not None and step != self._last_step:
                dt_ms = (now - self._last_notify) * 1000.0
                self.ema_ms = dt_ms if self.ema_ms is None else (
                    self.ema_alpha * dt_ms
                    + (1.0 - self.ema_alpha) * self.ema_ms)
            self._last_step = int(step)
            self._last_notify = now
        if self.step_watchdog is not None:
            self.step_watchdog.notify(step)

    def pause(self):
        """Suspend the wedged deadline over legitimately-slow non-step
        phases (checkpoint commit, rollback restore) — the same
        pause-over-save discipline ResilientLoop applies."""
        with self._lock:
            self._last_notify = None
        if self.step_watchdog is not None:
            self.step_watchdog.pause()

    # -- heartbeat + straggler thread -------------------------------------

    def _publish(self):
        if self.fault_plan is not None \
                and getattr(self.fault_plan, "should_drop_heartbeat", None) \
                and self.fault_plan.should_drop_heartbeat():
            self.dropped_heartbeats += 1
            return
        with self._lock:
            payload = json.dumps({
                "step": self._last_step,
                "ema_ms": self.ema_ms,
                "ts": time.time(),
            })
        try:
            self.coord.put(self.key, payload, lease=self._lease)
            self._lease.refresh()
            self.heartbeats += 1
        except Exception:
            pass                   # best-effort; the lease just ages

    def peers(self) -> dict:
        """Live health records by host (self included while beating)."""
        out = {}
        try:
            for v, k in self.coord.get_prefix(self.prefix):
                try:
                    out[k[len(self.prefix):]] = json.loads(v.decode())
                except (ValueError, AttributeError):
                    pass
        except Exception:
            pass
        return out

    def _check_straggler(self):
        with self._lock:
            own = self.ema_ms
        if own is None:
            return
        emas = [p.get("ema_ms") for p in self.peers().values()]
        emas = sorted(e for e in emas if e is not None)
        if len(emas) < 2:
            return                 # no fleet to lag behind
        median = emas[len(emas) // 2] if len(emas) % 2 else \
            0.5 * (emas[len(emas) // 2 - 1] + emas[len(emas) // 2])
        if median > 0 and own > self.straggler_factor * median:
            self.stragglers_flagged += 1
            self._consecutive_slow += 1
            if self._consecutive_slow >= self.straggler_patience:
                self.escalate(
                    f"straggler: step-time EMA {own:.1f}ms > "
                    f"{self.straggler_factor:g}x fleet median "
                    f"{median:.1f}ms for {self._consecutive_slow} "
                    f"consecutive checks")
        else:
            self._consecutive_slow = 0

    def _beat_loop(self):
        while not self._stop.wait(self.heartbeat_interval):
            if self.escalated:
                return
            self._publish()
            self._check_straggler()

    # -- escalation --------------------------------------------------------

    def escalate(self, reason: str):
        """Persist crash artifacts, then exit ``ELASTIC_EXIT_CODE`` so
        the elastic manager shrinks membership (this host's leases
        lapse) and relaunches the survivors."""
        self.escalated = True
        self.escalation_reason = reason
        print(f"[mesh-watchdog] escalating ({self.host}): {reason}",
              file=sys.stderr)
        try:
            from ...obs.crashdump import persist_crash_artifacts

            p = persist_crash_artifacts(
                f"mesh-watchdog: {reason}", extra=self.stats())
            if p:
                print(f"[mesh-watchdog] crash artifacts persisted to {p}",
                      file=sys.stderr)
        except Exception:          # noqa: BLE001 — escalating anyway
            pass
        if self.on_escalate is not None:
            try:
                self.on_escalate(reason)
            except Exception:
                pass
        if self.hard_exit:
            sys.stderr.flush()
            sys.stdout.flush()
            os._exit(self.exit_code)

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            ema = self.ema_ms
        return {
            "host": self.host,
            "membership": len(self.peers()),
            "heartbeats": int(self.heartbeats),
            "dropped_heartbeats": int(self.dropped_heartbeats),
            "step_time_ema_ms": float(ema) if ema is not None else 0.0,
            "stragglers_flagged": int(self.stragglers_flagged),
            "escalated": bool(self.escalated),
        }
