"""The process-wide registry of live serving engines, fleets and training
loops: their stats, health and flight records in one place.

Port of the registry half of ``paddle_tpu/profiler/__init__.py``
(:47-200).  Each :class:`~.serving.engine.Engine`,
:class:`~.serving.router.Fleet` and armed
:class:`~.distributed.fault_tolerance.ResilientLoop` registers itself
here at construction, held weakly: an object that goes away leaves the
registry at the next read, and the registry never keeps one alive.
:func:`paddle_tpu_torch.obs.render_all_metrics` flattens everything here
into one text exposition.  The rest of the JAX ``profiler`` (the
``Profiler`` state machine, its schedulers and exports) is not ported;
``torch.profiler`` traces the card (``profile_training.py``).
"""
from __future__ import annotations

import weakref
from typing import Callable, List

__all__ = ["serving_stats", "serving_health", "serving_paging",
           "serving_fleet", "train_stats", "flight_record",
           "serving_flight_record"]

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
    from .obs.flight import live_recorders

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
