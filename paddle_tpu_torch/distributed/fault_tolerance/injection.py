"""Deterministic fault injection for chaos testing the resilience layer.

The port's copy of ``paddle_tpu/distributed/fault_tolerance/injection.py``.
Faults are declared in environment variables, so the injected process
needs no test-specific code: the training script that runs in production
runs under chaos, and a chaos test sets the variables on a subprocess.

Training (:class:`FaultPlan`, step keyed, consulted by ``ResilientLoop``):

- ``PADDLE_TPU_FT_DIE_AT_STEP=N``: deliver a signal to this process at
  the start of step N, before the step function runs.  The default,
  SIGTERM, exercises the loop's preemption path: it finishes step N,
  commits a generation and exits with ``ELASTIC_EXIT_CODE``.
- ``PADDLE_TPU_FT_DIE_SIGNAL=KILL``: the signal, by name (TERM, INT,
  KILL) or number.  KILL cannot be caught: no final commit, the resume
  comes from the last cadence save.
- ``PADDLE_TPU_FT_STALL_AT_STEP=N`` / ``PADDLE_TPU_FT_STALL_SECONDS=S``:
  sleep S seconds (default 3600) inside step N, a hung step for the
  watchdog.
- ``PADDLE_TPU_FT_TRAIN_FAULTS="train.nan@5,train.spike@7x2:factor=100"``:
  data-side numerical faults the training script applies to its own
  batch through :meth:`FaultPlan.corrupt_batch` (``train.nan@N[xM]``: the
  batches of steps [N, N+M) become NaN; ``train.spike@N[xM][:factor=F]``:
  scaled by F, default 1e4).  The tensor keeps its shape, dtype and
  device, so a compiled step sees the fault with no new program.  Each
  rule fires at most once per step.  ``train.straggler@N[xM][:stall=S]``
  sleeps S seconds (default 0.25) at the start of each step of its
  window (``ResilientLoop`` calls :meth:`FaultPlan.fire`), the slow host
  the mesh watchdog's deadline and straggler EMA must catch;
  ``elastic.heartbeat@N[xM]`` drops a :class:`~.mesh_watchdog.MeshWatchdog`'s
  heartbeats N..N+M-1 (1-based) when the watchdog is given the plan
  (:meth:`FaultPlan.should_drop_heartbeat`).

Every die or stall fires at most once per process.

Serving (:class:`ServingFaultPlan`): a fault keyed to the Nth call of a
named engine fault point either raises :class:`InjectedFault`
(exercising a step retry or a per-request error boundary) or stalls
(exercising the step watchdog):

- ``PADDLE_TPU_FT_SERVING_FAULTS="serving.decode@2"``: raise at the 2nd
  decode-step call;
- ``"serving.prefill@1x2"``: raise at prefill calls 1 and 2 (defeats a
  single retry);
- ``"serving.decode@3:stall=1.5"``: sleep 1.5 s inside the 3rd decode
  call;
- specs are comma-separated and each fires exactly over its declared
  call window, so an injected run is reproducible call for call.

The variables' names and grammars are the JAX package's, so a
deployment's environment drives either package the same way.  A scope
prefix, ``serving.r<k>.<point>``, keys a rule to fleet replica ``k``'s own
calls (:meth:`ServingFaultPlan.scoped`).  :func:`corrupt_shard` flips a
byte of a committed checkpoint's shard file, the bit-rot half of the
chaos suite.
"""
from __future__ import annotations

import os
import re
import signal
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["FaultPlan", "ServingFaultPlan", "ReplicaScopedFaultPlan",
           "InjectedFault", "corrupt_shard", "SERVING_FAULT_POINTS",
           "TRAIN_FAULT_POINTS", "ELASTIC_FAULT_POINTS", "ENV_SERVING_FAULTS",
           "ENV_TRAIN_FAULTS"]

ENV_DIE_AT_STEP = "PADDLE_TPU_FT_DIE_AT_STEP"
ENV_DIE_SIGNAL = "PADDLE_TPU_FT_DIE_SIGNAL"
ENV_STALL_AT_STEP = "PADDLE_TPU_FT_STALL_AT_STEP"
ENV_STALL_SECONDS = "PADDLE_TPU_FT_STALL_SECONDS"
ENV_SERVING_FAULTS = "PADDLE_TPU_FT_SERVING_FAULTS"
ENV_TRAIN_FAULTS = "PADDLE_TPU_FT_TRAIN_FAULTS"

#: Step-keyed numerical fault points (applied by
#: :meth:`FaultPlan.corrupt_batch`), plus ``train.straggler``, a per-step
#: host stall.
TRAIN_FAULT_POINTS = ("train.nan", "train.spike", "train.straggler")

#: Elastic fault points (heartbeat-count keyed; for the mesh watchdog).
ELASTIC_FAULT_POINTS = ("elastic.heartbeat",)

#: the default multiplier of ``train.spike``
DEFAULT_SPIKE_FACTOR = 1e4

#: the default per-step stall of ``train.straggler``
DEFAULT_STRAGGLER_STALL = 0.25

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


def _parse_signal(spec: str) -> int:
    if spec.isdigit():
        return int(spec)
    name = spec.upper()
    if not name.startswith("SIG"):
        name = "SIG" + name
    return int(getattr(signal, name))


#: the option key each train point takes (None: no option)
_TRAIN_FAULT_OPTS = {"train.nan": None, "train.spike": "factor",
                     "train.straggler": "stall", "elastic.heartbeat": None}


def _parse_train_faults(raw: str) -> list:
    """``point@N[xM][:factor=F|:stall=S]`` comma-separated specs →
    ``[{"kind", "at", "times", "factor", "stall", "fired_steps"}]``."""
    rules = []
    valid = TRAIN_FAULT_POINTS + ELASTIC_FAULT_POINTS
    for spec in (s.strip() for s in raw.split(",")):
        if not spec:
            continue
        point, sep, rest = spec.partition("@")
        if not sep or point not in valid:
            raise ValueError(
                f"bad train fault spec {spec!r}: expected "
                f"point@N[xM][:factor=F|:stall=S] with point in {valid}")
        window, _, opt = rest.partition(":")
        at, _, times = window.partition("x")
        factor = DEFAULT_SPIKE_FACTOR
        stall = DEFAULT_STRAGGLER_STALL
        if opt:
            key, _, val = opt.partition("=")
            want = _TRAIN_FAULT_OPTS[point]
            if want is None:
                raise ValueError(
                    f"{point} takes no options (got {spec!r})")
            if key != want:
                raise ValueError(f"bad train fault option {opt!r} in "
                                 f"{spec!r}: only '{want}=<f>'")
            if key == "factor":
                factor = float(val)
            else:
                stall = float(val)
        rules.append({"kind": point.split(".")[1], "at": int(at),
                      "times": int(times) if times else 1,
                      "factor": factor, "stall": stall,
                      "fired_steps": set()})
        if rules[-1]["at"] < 0 or rules[-1]["times"] < 1:
            raise ValueError(f"bad train fault window in {spec!r}")
    return rules


class FaultPlan:
    """The training faults this process has been asked to inject, step
    keyed (the module docstring lists them)."""

    def __init__(self, die_at_step: Optional[int] = None,
                 die_signal: int = signal.SIGTERM,
                 stall_at_step: Optional[int] = None,
                 stall_seconds: float = 3600.0,
                 train_faults: Optional[list] = None):
        self.die_at_step = die_at_step
        self.die_signal = die_signal
        self.stall_at_step = stall_at_step
        self.stall_seconds = stall_seconds
        self.train_faults = list(train_faults or [])
        self._fired_die = False
        self._fired_stall = False
        self._heartbeats = 0

    @classmethod
    def from_env(cls, env=os.environ) -> "FaultPlan":
        die = env.get(ENV_DIE_AT_STEP)
        stall = env.get(ENV_STALL_AT_STEP)
        return cls(
            die_at_step=int(die) if die is not None else None,
            die_signal=_parse_signal(env.get(ENV_DIE_SIGNAL, "TERM")),
            stall_at_step=int(stall) if stall is not None else None,
            stall_seconds=float(env.get(ENV_STALL_SECONDS, "3600")),
            train_faults=_parse_train_faults(env.get(ENV_TRAIN_FAULTS, "")))

    def add_train_fault(self, point: str, at_step: int, times: int = 1,
                        factor: float = DEFAULT_SPIKE_FACTOR,
                        stall: float = DEFAULT_STRAGGLER_STALL
                        ) -> "FaultPlan":
        """Arm a ``train.*``/``elastic.*`` rule in process (the variable
        parses to the same shape).  ``at_step`` is a step, or a 1-based
        heartbeat number for ``elastic.heartbeat``."""
        valid = TRAIN_FAULT_POINTS + ELASTIC_FAULT_POINTS
        if point not in valid:
            raise ValueError(f"unknown train fault point {point!r}; want "
                             f"one of {valid}")
        if at_step < 0 or times < 1:
            raise ValueError("at_step must be >= 0 and times >= 1")
        self.train_faults.append(
            {"kind": point.split(".")[1], "at": int(at_step),
             "times": int(times), "factor": float(factor),
             "stall": float(stall), "fired_steps": set()})
        return self

    @property
    def armed(self) -> bool:
        return (self.die_at_step is not None
                or self.stall_at_step is not None
                or bool(self.train_faults))

    def fire(self, step: int):
        """Called by ``ResilientLoop`` at the start of every step."""
        if self.stall_at_step == step and not self._fired_stall:
            self._fired_stall = True
            time.sleep(self.stall_seconds)
        for r in self.train_faults:
            # a straggler stays slow: every step of its window, once each
            if r["kind"] == "straggler" \
                    and r["at"] <= step < r["at"] + r["times"] \
                    and step not in r["fired_steps"]:
                r["fired_steps"].add(step)
                time.sleep(r["stall"])
        if self.die_at_step == step and not self._fired_die:
            self._fired_die = True
            os.kill(os.getpid(), self.die_signal)

    def should_drop_heartbeat(self) -> bool:
        """Count one heartbeat; True if an ``elastic.heartbeat`` rule
        covers it (1-based)."""
        self._heartbeats += 1
        for r in self.train_faults:
            if r["kind"] == "heartbeat" \
                    and r["at"] <= self._heartbeats < r["at"] + r["times"]:
                return True
        return False

    def corrupt_batch(self, step: int, batch):
        """Apply any armed ``train.nan``/``train.spike`` rule for ``step``
        to a batch: a numpy array or a torch tensor in, the same kind out,
        shape, dtype and device kept.  Each rule fires at most once per
        step, so a replay of an earlier step sees clean data."""
        rule = None
        for r in self.train_faults:
            if r["kind"] in ("nan", "spike") \
                    and r["at"] <= step < r["at"] + r["times"] \
                    and step not in r["fired_steps"]:
                rule = r
                break
        if rule is None:
            return batch
        is_tensor = isinstance(batch, torch.Tensor)
        if is_tensor:
            floating = batch.dtype.is_floating_point or batch.is_complex()
            dtype = batch.dtype
        else:
            dtype = np.asarray(batch).dtype
            floating = dtype.kind in "fc"
        if not floating:
            # NaN or a factor cast to an integer batch (token ids) gives
            # finite garbage the sentry never latches on
            raise ValueError(
                f"train.{rule['kind']} fault needs a float batch, got "
                f"dtype {dtype}; poison a float input of the step, not "
                "integer token ids")
        rule["fired_steps"].add(step)
        factor = float("nan") if rule["kind"] == "nan" else rule["factor"]
        if is_tensor:
            return batch * factor
        arr = np.asarray(batch)
        return (arr * np.asarray(factor).astype(arr.dtype)).astype(
            arr.dtype)


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


def corrupt_shard(ckpt_path: str, nth: int = 0, flip_at: float = 0.5) -> str:
    """Flip one byte of the ``nth`` shard file (sorted order) of a
    committed checkpoint directory.  Returns the corrupted file's name."""
    shards = sorted(f for f in os.listdir(ckpt_path) if f.endswith(".npy"))
    if not shards:
        raise FileNotFoundError(f"no shard files under {ckpt_path}")
    target = os.path.join(ckpt_path, shards[nth % len(shards)])
    size = os.path.getsize(target)
    pos = max(0, min(size - 1, int(size * flip_at)))
    with open(target, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))
    return shards[nth % len(shards)]
