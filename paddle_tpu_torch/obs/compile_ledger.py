"""Compile ledger: every program build of a ``jit.to_static`` step, named,
timed and attributed.

The port's copy of ``paddle_tpu/obs/compile_ledger.py``.  After warmup a
new program is a bug that costs a build (on the card an eager call and a
CUDA graph capture) at a step that should have replayed.
:class:`CompileLedger` subscribes to the builds
(:func:`paddle_tpu_torch.jit.subscribe_compiles`) and keeps one record per
program:

====================  ======================================================
``fn``                qualname of the compiled function
``key``               short digest of the program's key (specs and mode bits)
``arg_specs``         ``dtype[shape]`` list of the tensor arguments
``seconds``           the key's first call plus, on the card, its capture
                      call (the capture and its first replay)
``site``              the call site (innermost frame outside the package
                      and torch)
``captured``          whether the program's CUDA graph was captured
``steady_state``      True when the program's first call came after
                      :meth:`CompileLedger.mark_steady`: a named anomaly
====================  ======================================================

A program's build on the card spans two calls: the eager first call and
the capture at the second.  The training loop marks steady state after the
first completed step, which on the card comes between them, so the capture
of a program first called before :meth:`mark_steady` completes that
program's record and is no anomaly; a program first called after it is
one anomaly, its capture included.  A capture of a program this ledger did
not see start (attached in between) is a record of its own, and an anomaly
in steady state.

Pure host-side bookkeeping: attaching a ledger changes no program key and
reads no device value; with no ledger attached the build path pays one
falsy check.
"""
from __future__ import annotations

from typing import Dict, List

__all__ = ["CompileLedger"]


class CompileLedger:
    """Subscriber-side ledger of program builds.

    Use as a context manager or with explicit :meth:`attach` /
    :meth:`detach`::

        ledger = CompileLedger()
        with ledger:
            warmup()              # recorded, before steady state
            ledger.mark_steady()  # a new program from here is an anomaly
            train(...)
        assert ledger.steady_state_misses == 0

    Args:
        name: ledger label.
        max_records: retention bound; past it records are dropped and
            counted (the counters keep counting).
    """

    def __init__(self, name: str = "train", max_records: int = 4096):
        if max_records < 1:
            raise ValueError(f"max_records must be >= 1, got {max_records}")
        self.name = name
        self.max_records = int(max_records)
        self.records: List[dict] = []
        self.dropped = 0
        self.compiles = 0
        self.captures = 0
        self.total_seconds = 0.0
        self.steady_state_misses = 0
        self._steady = False
        self._attached = False
        #: program serial -> its record (also when the record was dropped)
        self._by_program: Dict[int, dict] = {}

    # -- subscription -------------------------------------------------------

    def attach(self) -> "CompileLedger":
        if not self._attached:
            from ..jit import subscribe_compiles

            subscribe_compiles(self._on_compile)
            self._attached = True
        return self

    def detach(self) -> None:
        if self._attached:
            from ..jit import unsubscribe_compiles

            unsubscribe_compiles(self._on_compile)
            self._attached = False

    def __enter__(self) -> "CompileLedger":
        return self.attach()

    def __exit__(self, *_exc) -> bool:
        self.detach()
        return False

    # -- recording ----------------------------------------------------------

    def _on_compile(self, record: dict) -> None:
        self.total_seconds += record["seconds"]
        own = self._by_program.get(record["program"])
        if record["event"] == "capture":
            self.captures += 1
            if own is not None:
                # the second half of a build this ledger saw start
                own["seconds"] = round(own["seconds"] + record["seconds"], 6)
                own["captured"] = True
                return
        rec = {k: v for k, v in record.items() if k != "event"}
        rec["captured"] = record["event"] == "capture"
        rec["steady_state"] = self._steady
        self.compiles += 1
        if self._steady:
            self.steady_state_misses += 1
        self._by_program[record["program"]] = rec
        if len(self.records) >= self.max_records:
            self.dropped += 1
            return
        self.records.append(rec)

    def mark_steady(self) -> None:
        """Every program first called from here on is a steady-state miss,
        a named anomaly.  The training loop calls this after the first
        completed step; call it after ``warmup()`` when driving
        manually."""
        self._steady = True

    def reset_steady(self) -> None:
        """Back out of steady state (a retry at a new batch size rebuilds
        legitimately).  Anomalies already counted stay counted."""
        self._steady = False

    @property
    def steady(self) -> bool:
        return self._steady

    # -- introspection ------------------------------------------------------

    def anomalies(self) -> List[dict]:
        """The steady-state records: each names the function, arg specs and
        call site that built a program when nothing should have."""
        return [r for r in self.records if r.get("steady_state")]

    def stats(self) -> dict:
        """JSON-ready counters (the ``profiler.train_stats()`` surface).
        ``by_function`` aggregates count and seconds per function;
        steady-state anomalies ride along fully named."""
        by_fn: Dict[str, dict] = {}
        for r in self.records:
            agg = by_fn.setdefault(r["fn"], {"count": 0, "seconds": 0.0})
            agg["count"] += 1
            agg["seconds"] = round(agg["seconds"] + r["seconds"], 6)
        return {
            "compiles": self.compiles,
            "captures": self.captures,
            "total_seconds": round(self.total_seconds, 6),
            "steady_state_misses": self.steady_state_misses,
            "records_dropped": self.dropped,
            "by_function": by_fn,
            "anomalies": [
                {k: r[k] for k in ("fn", "key", "arg_specs", "seconds",
                                   "site")}
                for r in self.anomalies()],
        }
