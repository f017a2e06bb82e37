"""Runtime flags: ``paddle.get_flags`` / ``set_flags``, and the NaN/Inf
check that ``FLAGS_check_nan_inf`` arms.

Port of ``paddle_tpu/core/flags.py`` (a typed registry seeded from
``FLAGS_*`` environment variables, :36-75, with the JAX package's eight
flags; ``allocator_strategy`` names torch's caching allocator,
``auto_growth``, where the JAX one names XLA's) and of the check of
``core/dispatch.py:165-190`` and ``core/error_guard.py``.  Names are taken
with or without the ``FLAGS_`` prefix.

``check_nan_inf`` scans the floating output of every torch function while
it is on (a ``torch.overrides.TorchFunctionMode``, the mechanism of
``serving/sanitize.py``, entered when the flag turns on and left when it
turns off: the flag off costs nothing):

- **eagerly**, a non-finite value raises ``FloatingPointError("Operator
  <name> output contains NaN/Inf")`` at once, ``<name>`` the torch
  function's (``log``, ``matmul``, ``embedding``; a dunder or in-place
  name without its underscores; ``mul``, ``div`` and the like under the
  JAX package's names, ``multiply``, ``divide``), as the JAX dispatch
  names its op;
- **inside a CUDA graph capture** (a ``jit.to_static`` step on the card)
  nothing may be read on the host, so each scanned op writes "not
  finite" into its own index of a small device flag buffer
  (:class:`CapturedCheck`); after each replay of the step's graph, one
  host read of that buffer raises the same error naming the *first* op
  that fired.  A program captured with the flag on is a program of its
  own (the flag is part of its key), so turning the flag off runs the
  unscanned graph.  The replay has already written what the step writes
  (parameters, moments) when the error is raised, where the JAX step
  raises before its write-back (``jit/trace.py:432-435``): a caller that
  goes on after the error restores that state itself (ROADMAP C).

``isnan``, ``isinf``, ``isfinite`` and ``nan_to_num`` are not scanned,
as in the JAX package, nor are attribute reads and writes, data made
from values as they are (``torch.tensor``, ``as_tensor``), ``empty`` and
its kin (uninitialized memory), tensors off the CPU and the card
(``meta``), or the per-sample tensors inside a ``torch.vmap`` (an MoE
layer's experts: their batched output is scanned).  The scan sees the
torch functions Python calls: a forward, an optimizer step, a custom
``autograd.Function``'s backward; the built-in backward formulas run in
C++ beneath it, and a NaN they make is named by the first op that reads
it (the optimizer's cast of the gradient).
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["define_flag", "get_flags", "get_flag", "set_flags",
           "CapturedCheck"]


@dataclass
class _Flag:
    name: str
    default: Any
    type: type
    help: str
    value: Any = None
    on_change: Optional[Callable[[Any], None]] = None


_registry: Dict[str, _Flag] = {}
_lock = threading.Lock()


def _parse(tp: type, raw: str):
    if tp is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return tp(raw)


def _norm(name: str) -> str:
    return name[6:] if name.startswith("FLAGS_") else name


def define_flag(name: str, default, help: str = "", on_change=None):
    """Register a flag; the environment's ``FLAGS_<name>`` overrides the
    default.  ``on_change(value)`` runs at every change (and now, if the
    environment set it)."""
    tp = type(default)
    env = os.environ.get(f"FLAGS_{name}")
    value = _parse(tp, env) if env is not None else default
    with _lock:
        _registry[name] = _Flag(name, default, tp, help, value, on_change)
    if on_change is not None and value != default:
        on_change(value)
    return value


def get_flags(names=None) -> Dict[str, Any]:
    """``{name: value}`` of ``names`` (a name or a list; every flag for
    None), keyed as asked."""
    with _lock:
        if names is None:
            return {k: f.value for k, f in _registry.items()}
        if isinstance(names, str):
            names = [names]
        return {n: _registry[_norm(n)].value for n in names}


def get_flag(name: str):
    return _registry[_norm(name)].value


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flags by name (a string value is parsed to the flag's type)."""
    changed = []
    with _lock:
        for name, val in flags.items():
            name = _norm(name)
            if name not in _registry:
                raise KeyError(f"unknown flag {name!r}")
            f = _registry[name]
            f.value = _parse(f.type, val) if isinstance(val, str) \
                else f.type(val)
            if f.on_change:
                changed.append((f.on_change, f.value))
    for cb, value in changed:
        cb(value)


# -- the NaN/Inf check --------------------------------------------------------

#: not scanned: the checks themselves (as in the JAX package), attribute
#: reads and writes, data entering as it is (``to_tensor``, no op in the
#: JAX package), autograd bookkeeping and what makes uninitialized memory
_SKIP = frozenset({"isnan", "isinf", "isfinite", "nan_to_num", "get", "set",
                   "tensor", "as_tensor", "asarray", "requires_grad",
                   "detach", "empty", "empty_like",
                   "empty_strided", "new_empty", "new_empty_strided"})


#: torch's names where the JAX package names the op otherwise
_JAX_NAMES = {"mul": "multiply", "div": "divide", "true_divide": "divide",
              "sub": "subtract", "rsub": "subtract", "truediv": "divide",
              "rtruediv": "divide", "rmul": "multiply", "radd": "add",
              "neg": "negative", "abs": "abs", "mm": "matmul",
              "bmm": "matmul"}


def _op_name(func) -> str:
    name = getattr(func, "__name__", str(func)).strip("_").rstrip("_")
    return _JAX_NAMES.get(name, name)


def _floating(outs) -> List[torch.Tensor]:
    if isinstance(outs, torch.Tensor):
        outs = (outs,)
    elif not isinstance(outs, (tuple, list)):
        return []
    from torch._C import _functorch

    return [o for o in outs if isinstance(o, torch.Tensor)
            and (o.is_floating_point() or o.is_complex())
            and o.device.type in ("cpu", "cuda")
            and not _functorch.is_batchedtensor(o)]


def _error(name: str) -> FloatingPointError:
    return FloatingPointError(f"Operator {name} output contains NaN/Inf")


class CapturedCheck:
    """The device side of the check inside one captured graph: each
    scanned op's "not finite" at its own index of a bool buffer (chunks of
    :attr:`CHUNK`, made during the capture in the graph's pool, so every
    replay rewrites them), and the ops' names on the host."""

    CHUNK = 4096

    def __init__(self):
        self.names: List[str] = []
        self._chunks: List[torch.Tensor] = []

    def record(self, name: str, t: torch.Tensor) -> None:
        i = len(self.names)
        if i % self.CHUNK == 0:
            self._chunks.append(torch.zeros(self.CHUNK, dtype=torch.bool,
                                            device=t.device))
        self._chunks[-1][i % self.CHUNK].copy_(~torch.isfinite(t).all())
        self.names.append(name)

    def raise_if_fired(self) -> None:
        """One host read of the buffer (after a replay); raises naming the
        first op that fired."""
        if not self._chunks:
            return
        fired = torch.cat(self._chunks).cpu()[:len(self.names)]
        if bool(fired.any()):
            raise _error(self.names[int(fired.int().argmax())])


def scan(name: str, out) -> None:
    """Check ``out``'s floating tensors as the output of op ``name``: raise
    now, or, inside a capture, record into the graph's check."""
    for t in _floating(out):
        if t.is_cuda and torch.cuda.is_current_stream_capturing():
            if _Scan.sink is not None:
                _Scan.sink.record(name, t)
        elif not bool(torch.isfinite(t).all()):
            raise _error(name)


class _Scan(TorchFunctionMode):
    #: the check of the graph being captured (set by ``jit``), or None
    sink: Optional[CapturedCheck] = None
    #: > 0 inside a port op that is scanned as one (:func:`as_one_op`)
    paused = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = _op_name(func)
        if _Scan.paused or name in _SKIP:
            return out
        scan(name, out)
        return out


def as_one_op(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` scanned as the one op ``name``: its inner
    torch calls are not (a port op may hold an infinity on purpose, as a
    running maximum's start or a mask), its output is, as the JAX package
    checks its dispatched op's output.  ``amp.auto_cast.amp_op`` ops run
    so while the check is on."""
    _Scan.paused += 1
    try:
        out = fn(*args, **kwargs)
    finally:
        _Scan.paused -= 1
    if not _Scan.paused:
        scan(name, out)
    return out


_mode: Optional[_Scan] = None


def _arm_nan_check(on: bool) -> None:
    global _mode
    if on and _mode is None:
        _mode = _Scan()
        _mode.__enter__()
    elif not on and _mode is not None:
        mode, _mode = _mode, None
        mode.__exit__(None, None, None)


define_flag("check_nan_inf", False,
            "scan every op's floating output for NaN/Inf",
            on_change=_arm_nan_check)
define_flag("benchmark", False, "synchronize after each op for timing")
define_flag("low_precision_op_list", False, "log ops run under AMP autocast")
define_flag("use_flash_attention", True,
            "use the hand-written flash-attention kernels")
define_flag("allocator_strategy", "auto_growth",
            "memory allocator strategy (torch's caching allocator)")
define_flag("tracer_mkldnn_ops_on", "", "unused; API parity only")
define_flag("cache_jit_programs", True, "cache compiled to_static programs")
define_flag("eager_op_jit", True, "unused; API parity only")
