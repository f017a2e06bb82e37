"""Divergence sentry: anomaly detection inside the train step.

Port of ``paddle_tpu/distributed/fault_tolerance/sentry.py`` (:62-381).
A NaN at step N need not cost ``save_every`` steps of work and a relaunch,
and a finite loss spike should not go unseen: the sentry detects, the
loop rolls back a few steps from host-RAM snapshots
(:class:`~.memory_checkpoint.MemorySnapshotRing`), skips the offending
data window and goes on (:class:`~.resilient_loop.ResilientLoop`).

How the latch lives on the device:

- **State in device tensors, updated in place.**  The loss window, the
  observation counts, the grad-norm EMA and the 5-lane report
  ``[code, loss, grad_norm, scale, window_mean]`` are f32/int32 tensors
  made at construction on the sentry's device, so a ``jit.to_static``
  capture finds them made.  :meth:`DivergenceSentry.observe` is
  ``torch.where`` selects over them and ``copy_`` back: no Python branch
  on a device value, so the same code runs eagerly and inside a CUDA
  graph, each replay updating the state.
- **One small host read a step.**  :meth:`DivergenceSentry.poll` reads
  the 5 lanes once, after the step, and clears the latch in place.
- **An AMP overflow skip is routine.**  ``observe(..., found_inf=...)``
  (the loss scaler's device bool) forces the code to 0 and freezes the
  window for that step.

Detection (bit flags OR-ed into the report code):

==========================  =================================================
``ANOMALY_NONFINITE_LOSS``  loss is NaN/Inf
``ANOMALY_NONFINITE_GRAD``  global grad norm is NaN/Inf
``ANOMALY_LOSS_SPIKE``      loss > ``spike_factor`` x windowed mean (armed
                            after ``min_history`` clean observations, and
                            only on a positive mean)
``ANOMALY_GRAD_RATIO``      grad norm > ``grad_ratio`` x its EMA (same
                            warmup, counted on grad observations)
==========================  =================================================

The host policy (the blocklist, the consecutive-rollback counter, the
counters, the snapshot ring) changes only in :meth:`poll` and the
``note_*`` methods, outside the step.  The device state has a
``state_dict``/``load_state_dict`` pair that loads in place and rides
every snapshot, so a rolled-back run replays with the detector as it was
before the anomaly.
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional

import torch

__all__ = [
    "DivergenceSentry", "SentryReport", "SentryEscalation",
    "global_grad_norm",
    "ANOMALY_NONFINITE_LOSS", "ANOMALY_NONFINITE_GRAD",
    "ANOMALY_LOSS_SPIKE", "ANOMALY_GRAD_RATIO",
]

ANOMALY_NONFINITE_LOSS = 1
ANOMALY_NONFINITE_GRAD = 2
ANOMALY_LOSS_SPIKE = 4
ANOMALY_GRAD_RATIO = 8

_FLAG_NAMES = (
    (ANOMALY_NONFINITE_LOSS, "nonfinite_loss"),
    (ANOMALY_NONFINITE_GRAD, "nonfinite_grad"),
    (ANOMALY_LOSS_SPIKE, "loss_spike"),
    (ANOMALY_GRAD_RATIO, "grad_ratio"),
)

#: report lane layout: [code, loss, grad_norm, scale, window_mean]
_REPORT_LANES = 5


class SentryReport(NamedTuple):
    """One step's report, read on the host (plain floats)."""

    code: int
    loss: float
    grad_norm: float
    scale: float
    window_mean: float

    @property
    def anomalous(self) -> bool:
        return self.code != 0

    def flags(self) -> List[str]:
        return [name for bit, name in _FLAG_NAMES if self.code & bit]


class SentryEscalation(RuntimeError):
    """Raised when ``max_rollbacks`` consecutive rollbacks could not get
    past an anomaly: the run fail-stops with a disk generation committed
    and the frozen flight-recorder dump attached (``.flight_dump``)."""

    def __init__(self, msg: str, step: int, report: SentryReport,
                 flight_dump: Optional[dict] = None):
        super().__init__(msg)
        self.step = step
        self.report = report
        self.flight_dump = flight_dump


def _as_f32_scalar(value, device: torch.device) -> torch.Tensor:
    """A tensor, array or number as an f32 scalar on ``device`` (the mean
    of a tensor of more than one element)."""
    t = torch.as_tensor(value).to(device=device, dtype=torch.float32)
    if t.dim():
        t = t.mean()
    return t


def global_grad_norm(parameters: Iterable) -> torch.Tensor:
    """The global L2 norm over every present ``.grad``, in f32 on the
    device (the ``None`` checks are structural, never on a value): each
    gradient's norm by one multi-tensor ``torch._foreach_norm`` in f32,
    then the norm of those.  Returns an f32 scalar tensor for
    :meth:`DivergenceSentry.observe`."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


class DivergenceSentry:
    """The anomaly latch on the device and the rollback policy on the host
    (module docstring).

    Args:
        window: loss-history length for the spike check.
        spike_factor: loss > ``spike_factor * window_mean`` is a spike.
        grad_ratio: grad norm > ``grad_ratio * ema`` is a blow-up.
        min_history: clean observations before the spike and ratio checks
            arm (the non-finite checks always are).
        ema_decay: the grad-norm EMA's decay.
        snapshot_every: memory-snapshot cadence (completed steps) the loop
            follows.
        ring_capacity: snapshot ring depth.
        max_rollbacks: consecutive rollbacks before
            :class:`SentryEscalation` (0: escalate at the first anomaly).
        blocklist: steps to skip from the start (how an oracle replays a
            chaos run's effective schedule).
        device: where the detector state lives: the train step's device
            (``"cuda"`` unless the caller asks for the CPU; no card
            raises).
    """

    def __init__(self, window: int = 32, spike_factor: float = 4.0,
                 grad_ratio: float = 10.0, min_history: int = 8,
                 ema_decay: float = 0.9, snapshot_every: int = 10,
                 ring_capacity: int = 2, max_rollbacks: int = 3,
                 blocklist: Iterable[int] = (), device="cuda"):
        from .memory_checkpoint import MemorySnapshotRing

        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if min_history < 1:
            raise ValueError(f"min_history must be >= 1, got {min_history}")
        if spike_factor <= 1.0 or grad_ratio <= 1.0:
            raise ValueError("spike_factor and grad_ratio must be > 1 "
                             f"(got {spike_factor}, {grad_ratio})")
        if not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        if snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {snapshot_every}")
        if max_rollbacks < 0:
            raise ValueError(
                f"max_rollbacks must be >= 0, got {max_rollbacks}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DivergenceSentry: device 'cuda' asked for, "
                               "but no CUDA device is available (pass "
                               "device='cpu')")
        self.device = device
        self.window = int(window)
        self.spike_factor = float(spike_factor)
        self.grad_ratio = float(grad_ratio)
        self.min_history = int(min_history)
        self.ema_decay = float(ema_decay)
        self.snapshot_every = int(snapshot_every)
        self.max_rollbacks = int(max_rollbacks)
        self.blocklist = set(int(s) for s in blocklist)
        self.ring = MemorySnapshotRing(ring_capacity)
        # host policy counters
        self.anomalies = 0
        self.rollbacks = 0
        self.escalations = 0
        self.skipped_steps = 0
        self.polls = 0
        self._consecutive = 0
        self._last_anomaly_step = -1
        # the device state, made here so that a capture finds it made.
        # Loss and grad observations are counted apart: under gradient
        # accumulation a loss comes every micro-batch, a grad norm only
        # on update batches.
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self._hist = torch.zeros(self.window, **f32)
        self._n = torch.zeros((), **i32)
        self._gn = torch.zeros((), **i32)
        self._gema = torch.zeros((), **f32)
        self._report = torch.zeros(_REPORT_LANES, **f32)
        self._slots = torch.arange(self.window, **i32)

    # -- the latch, inside the step ------------------------------------------

    def observe(self, loss, grad_norm=None, found_inf=None,
                scale=None) -> None:
        """Record one train step, inside the step (eager or captured).

        ``found_inf`` (the loss scaler's device bool) marks a routine
        overflow skip: code 0, window frozen.  An anomalous step never
        enters the window either.  Several observes may land between two
        polls (micro-batches): the report keeps the first anomalous one
        until :meth:`poll` clears it."""
        dev = self.device
        la = _as_f32_scalar(loss, dev)
        has_g = grad_norm is not None
        g = _as_f32_scalar(grad_norm, dev) if has_g else torch.zeros_like(la)
        sc = _as_f32_scalar(scale, dev) if scale is not None \
            else torch.ones_like(la)
        hist, n, gn, gema = self._hist, self._n, self._gn, self._gema

        filled = torch.clamp(n, max=self.window)
        mean = hist.sum() / torch.clamp(filled, min=1).to(torch.float32)
        warm = n >= self.min_history

        loss_ok = torch.isfinite(la)
        code = torch.where(loss_ok, 0, ANOMALY_NONFINITE_LOSS)
        # the spike check arms only on a positive window mean: a negative
        # objective, or one converged to ~0, has no multiplicative baseline
        spike = warm & loss_ok & (mean > 0.0) \
            & (la > self.spike_factor * mean)
        code = code + torch.where(spike, ANOMALY_LOSS_SPIKE, 0)
        if has_g:
            grad_ok = torch.isfinite(g)
            code = code + torch.where(grad_ok, 0, ANOMALY_NONFINITE_GRAD)
            # armed on grad observations, not loss ones
            ratio = (gn >= self.min_history) & grad_ok & (gema > 0.0) \
                & (g > self.grad_ratio * gema)
            code = code + torch.where(ratio, ANOMALY_GRAD_RATIO, 0)
        if found_inf is not None:
            # an AMP overflow: the scaler already skipped the update
            routine = torch.as_tensor(found_inf).to(device=dev,
                                                    dtype=torch.bool)
            code = torch.where(routine, 0, code)
            ok = (code == 0) & ~routine
        else:
            ok = code == 0
        at = (self._slots == torch.remainder(n, self.window)) & ok
        new_hist = torch.where(at, la, hist)
        new_n = n + ok.to(n.dtype)
        if has_g:
            seeded = torch.where(gn > 0, self.ema_decay * gema
                                 + (1.0 - self.ema_decay) * g, g)
            gema.copy_(torch.where(ok, seeded, gema))
            gn.copy_(gn + ok.to(gn.dtype))
        hist.copy_(new_hist)
        n.copy_(new_n)
        # the report latches the first anomalous observe until a poll
        prev = self._report
        fresh = torch.stack([code.to(torch.float32), la, g, sc, mean])
        self._report.copy_(torch.where(prev[0] > 0, prev, fresh))

    # -- the host surface ----------------------------------------------------

    def poll(self) -> SentryReport:
        """Read the step's report (the sentry's one host read: 5 f32
        lanes) and clear the latch in place."""
        vec = self._report.tolist()
        self.polls += 1
        self._report.zero_()
        return SentryReport(code=int(vec[0]), loss=float(vec[1]),
                            grad_norm=float(vec[2]), scale=float(vec[3]),
                            window_mean=float(vec[4]))

    def should_skip(self, step: int) -> bool:
        return int(step) in self.blocklist

    def note_skip(self, step: int) -> None:
        self.skipped_steps += 1

    def note_anomaly(self, step: int, report: SentryReport) -> str:
        """One detected anomaly: blocklist the step, count a consecutive
        rollback, and answer ``"rollback"`` or ``"escalate"``."""
        self.anomalies += 1
        self.blocklist.add(int(step))
        self._consecutive += 1
        self._last_anomaly_step = max(self._last_anomaly_step, int(step))
        if self._consecutive > self.max_rollbacks:
            self.escalations += 1
            return "escalate"
        return "rollback"

    def note_clean(self, step: int) -> None:
        """A clean step past the last anomaly is progress: the consecutive
        count resets (a clean replay of an earlier step is not)."""
        if self._consecutive and int(step) > self._last_anomaly_step:
            self._consecutive = 0

    def counters(self) -> dict:
        """JSON-ready policy counters."""
        return {
            "anomalies": self.anomalies,
            "rollbacks": self.rollbacks,
            "escalations": self.escalations,
            "skipped_steps": self.skipped_steps,
            "consecutive": self._consecutive,
            "blocklist": sorted(self.blocklist),
            "snapshots": self.ring.taken,
            "snapshot_steps": self.ring.steps(),
        }

    # -- the device state, in every snapshot ----------------------------------

    def state_dict(self) -> dict:
        """The device detector state only (window, counts, EMA, report);
        the policy state stays on the host, so a rollback keeps the step
        it has just blocklisted."""
        return {"hist": self._hist, "n": self._n, "gn": self._gn,
                "gema": self._gema, "report": self._report}

    def load_state_dict(self, sd: dict) -> None:
        """Load :meth:`state_dict` (tensors, arrays or numbers) in place, so
        a captured step reads the loaded values."""
        def put(dst: torch.Tensor, v) -> None:
            dst.copy_(torch.as_tensor(v).to(dtype=dst.dtype).reshape(
                dst.shape))

        put(self._hist, sd["hist"])
        put(self._n, sd["n"])
        put(self._gn, sd.get("gn", 0))
        put(self._gema, sd["gema"])
        if "report" in sd:
            put(self._report, sd["report"])
