"""ResilientLoop: a train-step loop that survives preemption, hangs and
divergence.

Port of ``paddle_tpu/distributed/fault_tolerance/resilient_loop.py``
(:72-592).  The contract:

- **Cadence saves.**  Every ``save_every`` completed steps the loop
  commits a checkpoint generation (``step_000000123/`` under
  ``ckpt_dir``, :mod:`..checkpoint`'s format 2) of what ``state_fn()``
  returns, with the generators' states and the step; ``keep_last``
  generations are kept.  The commit is the atomic index write, so a kill
  during a save costs nothing.
- **Preemption.**  SIGTERM/SIGINT (handlers installed on the main thread
  only, for the duration of :meth:`ResilientLoop.run`) sets a flag; at
  the next step boundary the loop commits a generation and raises
  ``SystemExit(ELASTIC_EXIT_CODE)`` (101), for a launcher to relaunch.
- **Auto-resume.**  :meth:`ResilientLoop.resume` loads the newest
  generation that passes ``verify_checkpoint`` and restores it: user state
  through ``restore_fn``, then the generators, the loss ``scaler``, each
  written in place.
- **Hang detection.**  With ``watchdog_timeout``, the port's
  :class:`~.watchdog.StepWatchdog` fires when a step crosses no boundary
  in time (paused over commits and restores, which may legally be slow).
- **Divergence rollback.**  With a :class:`~.sentry.DivergenceSentry`
  the step is checked by its latch (one small host read a step, after
  the step); an anomaly restores the newest host-RAM snapshot
  (:class:`~.memory_checkpoint.MemorySnapshotRing`: weights, optimizer,
  generators, scaler, sentry state), blocklists the step and replays;
  past ``max_rollbacks`` consecutive rollbacks it commits the newest good
  snapshot to disk, freezes the flight ring and raises
  :class:`~.sentry.SentryEscalation`.  A rolled-back run ends bitwise
  equal to an uninterrupted run of the same effective schedule.

Every restore writes into the live tensors (``load_state_dict`` copies
in place): a ``jit.to_static`` step replays its CUDA graph on fixed
addresses, and a rebound tensor would leave the graph reading the old
memory.  ``restore_fn`` must therefore load, not rebind::

    loop = ResilientLoop(
        "ckpts/run0",
        state_fn=lambda: {"model": model.state_dict(),
                          "opt": opt.state_dict()},
        restore_fn=lambda s: (model.load_state_dict(s["model"]),
                              opt.set_state_dict(s["opt"])),
        save_every=100, keep_last=3, watchdog_timeout=300,
        sentry=DivergenceSentry(snapshot_every=25, ring_capacity=2))
    loop.run(train_one_step, num_steps=10_000)

With ``mesh_watchdog=`` (a :class:`~.mesh_watchdog.MeshWatchdog`, the
elastic mesh tier) the loop starts it, feeds it every step boundary
beside the step watchdog, pauses it over commits and restores, stops it at
the end, and reports its counters under ``elastic_stats()["watchdog"]``.
"""
from __future__ import annotations

import json
import signal
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from .. import checkpoint as ckpt
from ..reshard import world_descriptor
from ...obs.flight import FlightRecorder
from ...obs.train import StepTimeline, resolve_timeline
from .injection import FaultPlan
from .memory_checkpoint import restore_packed_state
from .sentry import DivergenceSentry, SentryEscalation
from .watchdog import ELASTIC_EXIT_CODE, StepWatchdog

__all__ = ["ResilientLoop", "pack_state", "world_descriptor"]


def pack_state(user_state: Dict[str, Any], step: int,
               include_rng: bool = True, scaler=None) -> Dict[str, Any]:
    """The generation payload every producer of resumable state builds
    (the loop's disk commits and its snapshot ring alike):
    ``{"user", "@step", "@rng", "@scaler", "@world", "@wall"}``.
    ``@rng`` is every device generator's ``[seed, offset]``
    (:func:`paddle_tpu_torch.rng.get_rng_state`), ``@scaler`` a loss
    scaler's state (its live scale), ``@world`` the packing topology and
    ``@wall`` the commit wall time (literals the restore ignores)."""
    from ... import rng

    state: Dict[str, Any] = {"user": user_state, "@step": int(step)}
    if include_rng:
        state["@rng"] = rng.get_rng_state()
    if scaler is not None:
        state["@scaler"] = scaler.state_dict()
    state["@world"] = world_descriptor()
    state["@wall"] = time.time()
    return state


class ResilientLoop:
    """A step function run with checkpoints, preemption handling,
    auto-resume, hang detection and sentry rollback (module docstring).

    ``timeline`` (an :class:`~...obs.train.StepTimeline`, or the
    ``PADDLE_TPU_TRAIN_TRACE`` one) records each step attempt;
    ``compile_ledger`` (an :class:`~...obs.compile_ledger.CompileLedger`)
    is attached for :meth:`run` and marked steady after the first
    completed step; ``cost_ledger`` (an :class:`~...obs.cost.CostLedger`
    the caller fills) rides :meth:`train_stats`.  An armed loop joins
    :func:`paddle_tpu_torch.profiler.train_stats`."""

    def __init__(self, ckpt_dir: str,
                 state_fn: Callable[[], Dict[str, Any]],
                 restore_fn: Callable[[Dict[str, Any]], Any],
                 save_every: Optional[int] = 100,
                 keep_last: Optional[int] = 3,
                 watchdog_timeout: Optional[float] = None,
                 include_rng: bool = True,
                 save_final: bool = True,
                 exit_code: int = ELASTIC_EXIT_CODE,
                 verbose: bool = True,
                 sentry: Optional[DivergenceSentry] = None,
                 scaler=None,
                 flight_capacity: int = 256,
                 timeline: Optional[StepTimeline] = None,
                 compile_ledger=None,
                 cost_ledger=None,
                 mesh_watchdog=None):
        if save_every is not None and save_every < 1:
            raise ValueError("save_every must be >= 1 (or None to disable)")
        if keep_last is not None and keep_last < 1:
            raise ValueError(
                "keep_last must be >= 1 (or None to disable retention): "
                "0 would delete every checkpoint as it is committed")
        self.ckpt_dir = ckpt_dir
        self.state_fn = state_fn
        self.restore_fn = restore_fn
        self.save_every = save_every
        self.keep_last = keep_last
        self.watchdog_timeout = watchdog_timeout
        self.include_rng = include_rng
        self.save_final = save_final
        self.exit_code = exit_code
        self.verbose = verbose
        self.sentry = sentry
        self.scaler = scaler
        #: the training flight ring: per-step summaries, frozen at a
        #: sentry escalation and a watchdog firing
        self.flight = FlightRecorder(capacity=flight_capacity,
                                     name="training")
        #: wall seconds of the latest rollback restore
        self.last_rollback_recovery_s: Optional[float] = None
        #: wall seconds of the latest disk commit, and of the latest
        #: resume (its integrity pass, load and restore)
        self.last_commit_s: Optional[float] = None
        self.last_resume_s: Optional[float] = None
        self.timeline = resolve_timeline(timeline)
        self.compile_ledger = compile_ledger
        self.cost_ledger = cost_ledger
        #: a MeshWatchdog: heartbeat, wedged-collective deadline and
        #: straggler EMA, fed the step boundaries beside the StepWatchdog
        self.mesh_watchdog = mesh_watchdog
        #: resumes from a generation packed on another world
        self.reconfigs = 0
        self.last_reconfig_s: Optional[float] = None
        self.reshard_report: Dict[str, Any] = {}
        self._reconfigured: Optional[Dict[str, Any]] = None
        self._preempt_sig: Optional[int] = None
        self._fault_plan = FaultPlan.from_env()
        # join profiler.train_stats() only when something is armed
        if self.timeline.enabled or sentry is not None \
                or compile_ledger is not None or cost_ledger is not None \
                or mesh_watchdog is not None:
            from ... import profiler

            profiler._register_train_stats(self)

    # -- checkpoints ------------------------------------------------------

    def _log(self, msg: str):
        if self.verbose:
            print(f"[resilient] {msg}", file=sys.stderr)

    def _save(self, completed: int):
        with self.timeline.phase("checkpoint_commit"):
            t0 = time.monotonic()
            state = pack_state(self.state_fn(), completed,
                               include_rng=self.include_rng,
                               scaler=self.scaler)
            ckpt.save_generation(state, self.ckpt_dir, completed,
                                 keep_last=self.keep_last)
        self.last_commit_s = time.monotonic() - t0
        self._log(f"committed generation {completed} "
                  f"({self.last_commit_s:.2f}s)")

    def resume(self) -> int:
        """Restore the newest valid generation in place; returns the step
        to continue from (0 on a fresh start).  A generation packed on
        another world (``@world``) is counted as a reconfiguration.  A
        generation of the JAX package carries a JAX PRNG key under
        ``@rng``, which cannot seed this package's generators: it raises
        unless the loop was built with ``include_rng=False``."""
        t0 = time.monotonic()
        found = ckpt.latest_valid(self.ckpt_dir)
        if found is None:
            self._log(f"no valid generation under {self.ckpt_dir}; "
                      "starting fresh")
            return 0
        step, path = found
        template: Dict[str, Any] = {"user": self.state_fn(), "@step": None}
        report: Dict[str, Any] = {}
        # tensors of the template land on its devices; the rest (the
        # generators', scaler's and sentry's states) are read on the host
        # and copied in place by the restore
        state = ckpt.load_state_dict(path, template, reshard_report=report,
                                     device="cpu")
        resumed = restore_packed_state(
            state, self.restore_fn, scaler=self.scaler,
            include_rng=self.include_rng)
        self.reshard_report = report
        self.last_resume_s = time.monotonic() - t0
        saved_world = state.get("@world")
        live_world = world_descriptor()
        if isinstance(saved_world, dict) and \
                dict(saved_world) != live_world:
            self.reconfigs += 1
            self.last_reconfig_s = self.last_resume_s
            self._reconfigured = {
                "origin_wall": state.get("@wall"),
                "from_world": dict(saved_world),
                "to_world": live_world,
                "reconfig_ms": round(self.last_reconfig_s * 1e3, 3),
            }
            self._log(f"topology change on resume: {dict(saved_world)} -> "
                      f"{live_world}")
        self._log(f"resumed from generation {step} (step {resumed})")
        return resumed

    # -- the memory tier and the sentry --------------------------------------

    def _mem_snapshot(self, completed: int):
        with self.timeline.phase("snapshot_capture"):
            state = pack_state(self.state_fn(), completed,
                               include_rng=self.include_rng,
                               scaler=self.scaler)
            state["@sentry"] = self.sentry.state_dict()
            self.sentry.ring.take(state)

    def _restore_newest_snapshot(self) -> Optional[int]:
        """Roll the state back to the newest ring snapshot, in place;
        returns its step (None when the ring is empty)."""
        # the ring's own host copies: the restore only reads them
        snap = self.sentry.ring.newest(copy=False)
        if snap is None:
            return None
        t0 = time.monotonic()
        with self.timeline.phase("rollback_restore"):
            step = restore_packed_state(
                snap, self.restore_fn, scaler=self.scaler,
                sentry=self.sentry, include_rng=self.include_rng)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self.last_rollback_recovery_s = time.monotonic() - t0
        return step

    def _escalate(self, step: int, report):
        """Give up on the memory tier: restore the newest good snapshot,
        commit it to disk, freeze the flight ring, raise."""
        good = self._restore_newest_snapshot()
        if good is not None:
            self._save(good)
        dump = self.flight.dump("sentry_escalation")
        self._log(f"sentry escalation at step {step}: "
                  f"{report.flags() or [report.code]} after "
                  f"{self.sentry.rollbacks} rollback(s); flight dump "
                  f"frozen ({len(dump['events'])} steps)")
        self.timeline.on_escalate(step)
        try:
            from ...obs.crashdump import persist_crash_artifacts

            p = persist_crash_artifacts(
                f"sentry escalation at step {step}",
                extra={"sentry": self.sentry_stats()})
            if p is not None:
                self._log(f"crash artifacts persisted to {p}")
        except Exception:                # noqa: BLE001 — best effort
            pass
        raise SentryEscalation(
            f"divergence sentry escalated at step {step} "
            f"(anomaly {report.flags() or report.code}; "
            f"{self.sentry.max_rollbacks} consecutive rollbacks "
            f"exhausted; last good disk generation: {good})",
            step=step, report=report, flight_dump=dump)

    def sentry_stats(self) -> dict:
        """JSON-ready sentry and rollback counters (empty without a
        sentry)."""
        if self.sentry is None:
            return {}
        out = dict(self.sentry.counters())
        out["ring"] = self.sentry.ring.snapshot()
        if self.last_rollback_recovery_s is not None:
            out["last_rollback_recovery_ms"] = round(
                self.last_rollback_recovery_s * 1e3, 3)
        return out

    def elastic_stats(self) -> dict:
        """JSON-ready reconfiguration counters from :meth:`resume`, and the
        mesh watchdog's counters under ``"watchdog"`` (empty when there
        is neither)."""
        out: Dict[str, Any] = {}
        if self.reconfigs:
            out["reconfigs"] = self.reconfigs
            out["last_reconfig_ms"] = round(self.last_reconfig_s * 1e3, 3)
            out["resharded_tensors"] = len(self.reshard_report)
            out["dropped_axis_tensors"] = sum(
                1 for r in self.reshard_report.values()
                if r.get("dropped_axes"))
        if self.mesh_watchdog is not None:
            out["watchdog"] = self.mesh_watchdog.stats()
        return out

    def train_stats(self) -> dict:
        """The training observatory: timeline counters, compile ledger,
        cost ledger, sentry and elastic counters (the
        ``profiler.train_stats()`` row)."""
        out: Dict[str, Any] = {"name": "training"}
        if self.timeline.enabled:
            out["timeline"] = self.timeline.counters()
        if self.compile_ledger is not None:
            out["compiles"] = self.compile_ledger.stats()
        if self.cost_ledger is not None:
            out["cost"] = self.cost_ledger.stats()
        sen = self.sentry_stats()
        if sen:
            out["sentry"] = sen
        ela = self.elastic_stats()
        if ela:
            out["elastic"] = ela
        return out

    # -- preemption --------------------------------------------------------

    def _install_handlers(self):
        if threading.current_thread() is not threading.main_thread():
            self._log("not on the main thread; preemption signals not "
                      "intercepted")
            return None

        def _handler(sig, _frame):
            self._preempt_sig = sig
            self._log(f"received signal {sig}; will commit at the next "
                      "step boundary and exit "
                      f"{self.exit_code} for relaunch")

        return (signal.signal(signal.SIGTERM, _handler),
                signal.signal(signal.SIGINT, _handler))

    def _restore_handlers(self, saved):
        if saved is not None:
            signal.signal(signal.SIGTERM, saved[0])
            signal.signal(signal.SIGINT, saved[1])

    @property
    def preempted(self) -> bool:
        return self._preempt_sig is not None

    def _on_watchdog_timeout(self):
        """Freeze the flight ring and print its newest events (parseable
        JSON) to stderr before the watchdog's hard exit."""
        d = self.flight.dump("watchdog")
        tail = dict(d, events=d["events"][-32:],
                    events_elided=max(0, len(d["events"]) - 32))
        try:
            print(f"[flight] {json.dumps(tail)}", file=sys.stderr)
        except (TypeError, ValueError):
            print(f"[flight] dump of {len(d['events'])} steps "
                  "(unserializable fields elided)", file=sys.stderr)

    # -- the loop ----------------------------------------------------------

    def run(self, step_fn: Callable[[int], Any], num_steps: int) -> int:
        """Run ``step_fn(step)`` for steps [resume point, ``num_steps``).

        Returns the number of completed steps.  Raises ``SystemExit`` with
        ``exit_code`` after committing when a preemption signal arrived.
        With a sentry, an anomalous step rolls back to the newest snapshot
        and is skipped on replay (``step_fn`` is never called for a
        blocklisted step).  The timeline gets one span per step attempt
        (phases ``step_dispatch``, ``device_wait`` around the sentry poll,
        ``snapshot_capture``, ``checkpoint_commit``, ``rollback_restore``;
        ``data_fetch`` is the step function's to mark)."""
        start = self.resume()
        sentry = self.sentry
        tl = self.timeline
        if self.compile_ledger is not None:
            self.compile_ledger.attach()
        watchdog = (StepWatchdog(self.watchdog_timeout,
                                 exit_code=self.exit_code,
                                 on_timeout=self._on_watchdog_timeout)
                    if self.watchdog_timeout else None)
        mesh_wd = self.mesh_watchdog
        saved_handlers = self._install_handlers()
        completed = start
        reconfig = self._reconfigured
        self._reconfigured = None

        def _commit(n, resume_step=None):
            # a commit may legally be slow: never under the step deadline
            if watchdog is not None:
                watchdog.pause()
            if mesh_wd is not None:
                mesh_wd.pause()
            self._save(n)
            if resume_step is not None:
                if watchdog is not None:
                    watchdog.notify(resume_step)
                if mesh_wd is not None:
                    mesh_wd.notify(resume_step)

        try:
            if watchdog is not None:
                watchdog.start()
            if mesh_wd is not None:
                mesh_wd.start()
            if sentry is not None:
                # seed the ring: a rollback target exists from step one
                self._mem_snapshot(start)
            step = start
            report = None
            while step < num_steps:
                tl.begin_step(step)
                reconfigured_attempt = reconfig is not None
                if reconfigured_attempt:
                    tl.on_reconfigured(step, **reconfig)
                    reconfig = None
                skipped = sentry is not None and sentry.should_skip(step)
                if skipped:
                    # a blocklisted window: step_fn is not called, but the
                    # boundary still runs the preemption, snapshot and
                    # commit checks below
                    sentry.note_skip(step)
                    tl.on_skip(step)
                    self._log(f"skipping blocklisted step {step}")
                else:
                    if watchdog is not None:
                        watchdog.notify(step)
                    if mesh_wd is not None:
                        mesh_wd.notify(step)
                    self._fault_plan.fire(step)
                    with tl.phase("step_dispatch"):
                        step_fn(step)
                    if sentry is not None:
                        with tl.phase("device_wait"):
                            report = sentry.poll()
                        if report.anomalous:
                            action = sentry.note_anomaly(step, report)
                            self.flight.record(step=step,
                                               anomaly=report.code,
                                               loss=report.loss,
                                               grad_norm=report.grad_norm,
                                               scale=report.scale)
                            # a restore or an escalation commit may
                            # legally be slow
                            if watchdog is not None:
                                watchdog.pause()
                            if mesh_wd is not None:
                                mesh_wd.pause()
                            if action == "escalate":
                                self._escalate(step, report)
                            target = self._restore_newest_snapshot()
                            if target is None:
                                self._escalate(step, report)
                            sentry.rollbacks += 1
                            self._log(
                                f"anomaly {report.flags() or report.code}"
                                f" at step {step}: rolled back to "
                                f"snapshot {target} ("
                                f"{self.last_rollback_recovery_s * 1e3:.1f}"
                                f"ms); step {step} blocklisted")
                            tl.on_rollback(step, target, code=report.code)
                            step = target
                            continue
                        sentry.note_clean(step)
                completed = step + 1
                if not skipped and self.compile_ledger is not None \
                        and not self.compile_ledger.steady:
                    # one step has run: a fixed-shape step's programs
                    # exist (on the card its capture, at the next call,
                    # completes the same program's record)
                    self.compile_ledger.mark_steady()
                if skipped:
                    self.flight.record(step=step, skipped=1)
                elif sentry is not None:
                    self.flight.record(
                        step=step, loss=report.loss,
                        grad_norm=report.grad_norm, scale=report.scale,
                        snapshot_age=(completed
                                      - (sentry.ring.steps() or [start])[-1]))
                else:
                    self.flight.record(step=step)
                state = "skipped" if skipped else \
                    ("reconfigured" if reconfigured_attempt else "completed")
                if self.preempted:
                    _commit(completed)
                    self._log(f"preempted at step boundary {completed}; "
                              f"exiting {self.exit_code}")
                    tl.end_step(state)
                    raise SystemExit(self.exit_code)
                if sentry is not None \
                        and completed % sentry.snapshot_every == 0:
                    self._mem_snapshot(completed)
                if self.save_every is not None \
                        and completed % self.save_every == 0 \
                        and completed < num_steps:
                    _commit(completed, resume_step=step)
                tl.end_step(state)
                step += 1
            if self.save_final and num_steps > start:
                _commit(num_steps)
            else:
                if watchdog is not None:
                    watchdog.pause()
                if mesh_wd is not None:
                    mesh_wd.pause()
        finally:
            if watchdog is not None:
                watchdog.stop()
            if mesh_wd is not None:
                mesh_wd.stop()
            if self.compile_ledger is not None:
                self.compile_ledger.detach()
            self._restore_handlers(saved_handlers)
        return completed
