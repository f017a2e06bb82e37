"""Sync-point sanitizer: measure (and optionally forbid) device-to-host
transfers on the serving engine's decode path.

The port's ``paddle_tpu/serving/sanitize.py``.  A decode step is one
replay of a captured program, and the host's only read of the device is
the step's ``[slots]`` token pull after it; :class:`SyncSanitizer` makes
that measurable:

- **counting window** (:meth:`SyncSanitizer.decode_window`): while a
  decode step (or a speculative round) is dispatched, a
  ``torch.overrides.TorchFunctionMode`` counts every host coercion of a
  tensor (``item``, ``tolist``, ``numpy``, ``cpu``, ``to`` a CPU target,
  ``__bool__``, ``__int__``, ``__float__``, ``__index__``,
  ``__array__``), whatever the tensor's device, as the JAX sanitizer
  counts on a CPU backend, and attributes each to its source line (the
  first frame outside torch's own files and this one).  The figure the
  engine holds is **0.0 per decode step**, speculative rounds included;
  the token pull after the dispatch is outside the window by design.
- **compiled guard** (:meth:`SyncSanitizer.compiled_guard`): around the
  step call (its input copies from pinned memory and its replay) the
  card runs under ``torch.cuda.set_sync_debug_mode``: ``"warn"`` by
  default, ``"error"`` in strict mode, where a synchronising CUDA call
  raises and the engine's error boundary fails the implicated batch.
  The mode is process-wide; the guard restores the previous one on
  exit.  On the CPU the guard is a null context, as the JAX guard is
  vacuous on the JAX CPU backend.

Arming: ``PADDLE_TPU_SANITIZE=1`` (count and warn) or
``PADDLE_TPU_SANITIZE=strict`` (count and forbid) arms every engine at
construction (:meth:`SyncSanitizer.from_env`); tests attach one
(``engine.sanitizer = SyncSanitizer()``).
"""
from __future__ import annotations

import os
import sys
from contextlib import contextmanager
from typing import Dict, Optional

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["SyncSanitizer"]

#: the tensor methods that coerce to the host (``to`` only with a CPU
#: target, see :func:`_coerces`)
_COERCIONS = frozenset({"item", "tolist", "numpy", "cpu", "to", "__bool__",
                        "__int__", "__float__", "__index__", "__array__"})

#: frames in these files are plumbing, not an attributable sync site
_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep
_THIS_FILE = os.path.abspath(__file__)

#: path parts a site's file name is shortened at ("paddle_tpu" would not
#: match the port's own part)
_ANCHORS = ("paddle_tpu_torch", "tests", "tools")

#: what ``torch.cuda.set_sync_debug_mode("error")`` raises with
_GUARD_MESSAGE = "called a synchronizing CUDA operation"


def _coerces(func, args, kwargs) -> bool:
    name = getattr(func, "__name__", None)
    if name not in _COERCIONS:
        return False
    if name != "to":
        return True
    # Tensor.to(device | other tensor | dtype, ..., device=...): a copy to
    # the host only when a CPU target is named
    for a in list(args[1:]) + [kwargs.get("device")]:
        if isinstance(a, torch.Tensor):
            return a.device.type == "cpu"
        if isinstance(a, (str, torch.device)):
            return torch.device(a).type == "cpu"
    return False


def _attribute_site() -> str:
    """``file:line`` of the nearest caller outside torch and this file,
    the path shortened at the first anchor."""
    f = sys._getframe(1)
    while f is not None:
        fname = f.f_code.co_filename
        if not (fname.startswith(_TORCH_DIR)
                or os.path.abspath(fname) == _THIS_FILE):
            parts = fname.split(os.sep)
            for anchor in _ANCHORS:
                if anchor in parts:
                    fname = os.sep.join(parts[parts.index(anchor):])
                    break
            else:
                fname = os.sep.join(parts[-2:])
            return f"{fname}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


class _CountingMode(TorchFunctionMode):
    """Counts host coercions into its sanitizer and runs every call
    unchanged."""

    def __init__(self, san: "SyncSanitizer"):
        super().__init__()
        self.san = san

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _coerces(func, args, kwargs):
            self.san._on_sync()
        return func(*args, **kwargs)


class SyncSanitizer:
    """Per-engine host-transfer meter for steady-state decode.

    One instance belongs to one engine.  The counting mode is installed
    only inside :meth:`decode_window` and only on the thread that opened
    it (torch's function-mode stack is per thread), so neither another
    engine's steps nor the watchdog's thread are counted.
    """

    def __init__(self, strict: bool = False):
        self.strict = bool(strict)
        self.decode_steps = 0
        self.host_transfers = 0
        self.by_site: Dict[str, int] = {}
        self.guard_violations = 0
        self._in_window = False

    @classmethod
    def from_env(cls) -> Optional["SyncSanitizer"]:
        """The env-armed sanitizer (``PADDLE_TPU_SANITIZE=1|strict``), or
        None when the mode is off (the default: no cost)."""
        v = os.environ.get("PADDLE_TPU_SANITIZE", "").strip().lower()
        if v in ("", "0", "false", "off", "no"):
            return None
        if v in ("1", "true", "on", "yes"):
            return cls(strict=False)
        if v == "strict":
            return cls(strict=True)
        raise ValueError(
            f"PADDLE_TPU_SANITIZE={v!r}: expected 1 (count+log), "
            "strict (count+disallow), or 0/off to disable")

    # -- the two measurement surfaces --------------------------------------

    def _on_sync(self) -> None:
        self.host_transfers += 1
        site = _attribute_site()
        self.by_site[site] = self.by_site.get(site, 0) + 1

    def note_step(self) -> None:
        """One decode step (or round) actually ran: called by the engine
        after a successful step call, never by :meth:`decode_window`, so
        a window that ends before its call (every request retired, the
        retries exhausted) does not dilute ``per_decode_step``."""
        self.decode_steps += 1

    @contextmanager
    def decode_window(self):
        """Count and attribute every host coercion during one decode
        dispatch.  Reentrancy-safe: an inner window installs nothing and
        its exit leaves the outer one counting."""
        if self._in_window:
            yield
            return
        self._in_window = True
        try:
            with _CountingMode(self):
                yield
        finally:
            self._in_window = False

    @contextmanager
    def compiled_guard(self, device):
        """Around a step call on ``device``: on the card, CUDA's sync
        debug mode (``"error"`` when strict, else ``"warn"``), the
        previous mode restored on exit; on the CPU, nothing."""
        if torch.device(device).type != "cuda":
            yield
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error" if self.strict else "warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    def count_violation(self, exc: BaseException) -> None:
        """Count ``exc`` as a guard violation when it is the sync debug
        mode's own error (matched by its message: an ordinary step
        failure is not one)."""
        if _GUARD_MESSAGE in str(exc):
            self.guard_violations += 1

    # -- export ------------------------------------------------------------

    def per_decode_step(self) -> float:
        return (self.host_transfers / self.decode_steps
                if self.decode_steps else 0.0)

    def report(self, top: int = 10) -> dict:
        """JSON-ready snapshot (``stats()["sanitizer"]``)."""
        sites = sorted(self.by_site.items(), key=lambda kv: (-kv[1], kv[0]))
        return {
            "strict": self.strict,
            "decode_steps": self.decode_steps,
            "host_transfers": self.host_transfers,
            "per_decode_step": round(self.per_decode_step(), 3),
            "by_site": dict(sites[:top]),
            "guard_violations": self.guard_violations,
        }
