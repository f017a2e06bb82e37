"""Deterministic fault injection for the serving engine's chaos tests.

The port's copy of the serving half of
``paddle_tpu/distributed/fault_tolerance/injection.py`` (the training
``FaultPlan``, ``corrupt_shard`` and the elastic points are not ported).
A fault is keyed to the Nth call of a named engine fault point and either
raises :class:`InjectedFault` (exercising a step retry or a per-request
error boundary) or stalls (exercising the step watchdog):

- ``PADDLE_TPU_FT_SERVING_FAULTS="serving.decode@2"``: raise at the 2nd
  decode-step call;
- ``"serving.prefill@1x2"``: raise at prefill calls 1 and 2 (defeats a
  single retry);
- ``"serving.decode@3:stall=1.5"``: sleep 1.5 s inside the 3rd decode
  call;
- specs are comma-separated and each fires exactly over its declared
  call window, so an injected run is reproducible call for call.

The variable's name and grammar are the JAX package's, so a deployment's
environment drives either package the same way.  A scope prefix,
``serving.r<k>.<point>``, keys a rule to fleet replica ``k``'s own calls
(:meth:`ServingFaultPlan.scoped`).
"""
from __future__ import annotations

import os
import re
import time
from typing import Optional

__all__ = ["ServingFaultPlan", "ReplicaScopedFaultPlan", "InjectedFault",
           "SERVING_FAULT_POINTS", "ENV_SERVING_FAULTS"]

ENV_SERVING_FAULTS = "PADDLE_TPU_FT_SERVING_FAULTS"

#: The fault points a plan accepts (the JAX package's list).  The engine
#: checks ``serving.prefill`` and ``serving.decode`` before each step
#: call, ``serving.stream_cb`` before a stream callback and
#: ``serving.prefix_lookup`` inside the paged prefix lookup (a raising or
#: stalling lookup is a plain miss); a sharded engine checks
#: ``serving.shard_fail`` at the start of each step (a firing loses its
#: mesh's highest rank).  A speculating
#: engine also checks ``serving.spec_draft``, ``serving.spec_verify`` and
#: ``serving.spec_draft_prefill``, which :meth:`ServingFaultPlan.check`
#: counts though ``add`` does not take them, as in the JAX package.
SERVING_FAULT_POINTS = ("serving.prefill", "serving.decode",
                        "serving.stream_cb", "serving.prefix_lookup",
                        "serving.shard_fail")

#: ``serving.r<k>.<suffix>``: a fault point scoped to fleet replica k.
_SCOPED_POINT_RE = re.compile(r"^serving\.r(\d+)\.(?P<suffix>.+)$")


def _canonical_point(point: str) -> str:
    """Strip a replica scope: ``serving.r2.decode`` → ``serving.decode``
    (unscoped points pass through)."""
    m = _SCOPED_POINT_RE.match(point)
    return f"serving.{m.group('suffix')}" if m else point


class InjectedFault(RuntimeError):
    """Raised by a :class:`ServingFaultPlan` rule at its trigger call."""


class ServingFaultPlan:
    """Call-count-keyed faults for the serving engine's fault points.

    The engine calls :meth:`check` at every pass through a fault point;
    the plan counts calls per point, and a rule fires over the call
    window ``[at_call, at_call + times)``, raising :class:`InjectedFault`
    or sleeping ``stall_s`` seconds.  ``times > 1`` defeats the engine's
    bounded retry.  Plans normally come from the environment
    (:meth:`from_env`), so the production serving loop is the chaos
    workload; :meth:`add` builds one in process.
    """

    def __init__(self):
        self._rules: list = []
        self._calls: dict = {}

    def add(self, point: str, at_call: int, times: int = 1,
            stall_s: Optional[float] = None) -> "ServingFaultPlan":
        if _canonical_point(point) not in SERVING_FAULT_POINTS:
            raise ValueError(f"unknown serving fault point {point!r}; "
                             f"want one of {SERVING_FAULT_POINTS} "
                             f"(optionally scoped 'serving.r<k>.<suffix>')")
        if at_call < 1 or times < 1:
            raise ValueError("at_call and times must be >= 1")
        self._rules.append({"point": point, "at": int(at_call),
                            "times": int(times),
                            "stall_s": None if stall_s is None
                            else float(stall_s)})
        return self

    @classmethod
    def from_env(cls, env=os.environ) -> "ServingFaultPlan":
        """Parse ``point@N[xM][:stall=S]`` comma-separated specs from
        ``PADDLE_TPU_FT_SERVING_FAULTS``; an unset variable arms
        nothing."""
        plan = cls()
        raw = env.get(ENV_SERVING_FAULTS, "")
        for spec in (s.strip() for s in raw.split(",")):
            if not spec:
                continue
            point, sep, rest = spec.partition("@")
            if not sep:
                raise ValueError(f"bad serving fault spec {spec!r}: "
                                 "expected point@N[xM][:stall=S]")
            window, _, opt = rest.partition(":")
            at, _, times = window.partition("x")
            stall = None
            if opt:
                key, _, val = opt.partition("=")
                if key != "stall":
                    raise ValueError(f"bad serving fault option {opt!r} "
                                     f"in {spec!r}: only 'stall=<s>'")
                stall = float(val)
            plan.add(point, int(at), int(times) if times else 1, stall)
        return plan

    @property
    def armed(self) -> bool:
        return bool(self._rules)

    def calls(self, point: str) -> int:
        """How many times ``point`` has been checked so far (scoped
        points, ``serving.r<k>.<suffix>``, count per replica)."""
        return self._calls.get(point, 0)

    def check(self, point: str, scope: Optional[str] = None) -> None:
        """Count one pass through ``point``; fire any matching rule.

        ``scope`` (``"serving.r1"``, from a :meth:`scoped` view) also
        counts the pass under the scoped key ``serving.r1.<suffix>``.
        Both counters advance before any rule fires, so a firing scoped
        rule never skews the global numbering an unscoped rule keys on;
        a scoped rule wins when both match the same call."""
        points = [point]
        if scope is not None:
            suffix = _canonical_point(point)[len("serving."):]
            points.insert(0, f"{scope}.{suffix}")
        fire, fire_n = None, 0
        for p in points:
            n = self._calls.get(p, 0) + 1
            self._calls[p] = n
            if fire is None:
                for r in self._rules:
                    if r["point"] == p and \
                            r["at"] <= n < r["at"] + r["times"]:
                        fire, fire_n = r, n
                        break
        if fire is None:
            return
        if fire["stall_s"] is not None:
            time.sleep(fire["stall_s"])
            return
        raise InjectedFault(
            f"injected fault: {fire['point']} call #{fire_n}")

    def scoped(self, replica_index: int) -> "ReplicaScopedFaultPlan":
        """A view of this plan scoped to one fleet replica:
        ``view.check('serving.decode')`` counts both
        ``serving.r<k>.decode`` and ``serving.decode``.  Views share the
        parent's rules and counters."""
        return ReplicaScopedFaultPlan(self, replica_index)


class ReplicaScopedFaultPlan:
    """Per-replica view over a shared :class:`ServingFaultPlan` (the
    ``armed``/``check``/``calls`` surface the engine uses)."""

    def __init__(self, plan: ServingFaultPlan, replica_index: int):
        self.plan = plan
        self.scope = f"serving.r{int(replica_index)}"

    @property
    def armed(self) -> bool:
        return self.plan.armed

    def calls(self, point: str) -> int:
        """The scoped count for a canonical point; scoped or foreign keys
        pass through to the parent."""
        if _SCOPED_POINT_RE.match(point) or not point.startswith("serving."):
            return self.plan.calls(point)
        return self.plan.calls(f"{self.scope}.{point[len('serving.'):]}")

    def check(self, point: str) -> None:
        self.plan.check(point, scope=self.scope)
