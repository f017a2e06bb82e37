"""``jit.to_static``: a step compiled once per input spec, on the card a
CUDA graph.

Port of ``paddle_tpu/jit/__init__.py`` ``to_static``, ``StaticFunction``,
``InputSpec``, ``not_to_static`` and ``enable_to_static`` (:127-290,
:453-475).  The JAX package traces a function (a model forward, or a whole
train step with backward and ``optimizer.step()``) into one XLA program
per input spec.  Here a program is one per key: the tensor arguments'
shapes, dtypes and devices, the other arguments' values, and the mode bits
of ``_extra_key`` (grad mode, the ``training`` flags of the function's
module and of module arguments), as the JAX cache keys it (:179-194).
``program_cache`` holds the programs; ``misses`` counts keys first seen
(the JAX package's trace and compile), ``hits`` the other calls,
``captures`` the graphs made.

On the CPU a program runs its body at every call.  On a CUDA device (a
tensor argument there) it follows the capture discipline of
``serving/programs.py``:

- the key's first call runs the body eagerly on the device's shared
  capture stream: it is the real first step, and it makes what a capture
  must find made (optimizer state and masters, the learning-rate tensors,
  the dropout generator, kernel libraries, the stream's cuBLAS
  workspace);
- the second call copies its tensor arguments into static buffers and
  captures the body on that stream into a CUDA graph of the program's own
  memory pool, then replays it: backward and optimizer step included, each
  call one step;
- later calls copy their tensor arguments into the buffers and replay.

What a replay computes lives in the pool and is overwritten by the next
replay: the call returns copies of the body's tensor outputs (detached),
so a loss returned once keeps its value.  Gradients and activations made
inside the graph stay in the pool between replays (they count in the
peak).  State the body updates in place (parameters, moments, the
scheduler's rate, the generator's offset) is updated at every replay; a
Python side effect of the body happens at the eager call and at the
capture only, and a float the body reads (a float learning rate) is a
constant of the graph.  A body must not read a device value on the host
(``.item()``, ``float()``, ``int()``, ``bool()``, printing a tensor) or
synchronize: its capture then fails and the call raises
:class:`CaptureError` naming that cause (the JAX package's tracer-leak
errors, :25-34); the program keeps raising, and no eager step stands in.
``save``, ``load``, ``TracedLayer`` and dy2static control flow are not
ported (ROADMAP.md A.5).
"""
from __future__ import annotations

import functools
import gc
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from .ops import kernels
from .serving.programs import _capture_stream

__all__ = ["CaptureError", "InputSpec", "StaticFunction", "enable_to_static",
           "not_to_static", "to_static"]

_enabled = {"to_static": True}


class CaptureError(RuntimeError):
    """A compiled step's body could not be captured as a CUDA graph."""


class InputSpec:
    """Declarative input signature (``paddle.static.InputSpec``): kept
    with the function, as the JAX package keeps it for its concrete
    programs."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = list(shape)
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) \
            else dtype
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def _flatten(obj, leaves: List[torch.Tensor]):
    """``obj`` with each tensor replaced by its index in ``leaves``, and a
    hashable key of the same structure (tensor specs and other values)."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("tensor", tuple(obj.shape), obj.dtype, obj.device,
                obj.requires_grad)
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,
                tuple(_flatten(o, leaves) for o in obj))
    if isinstance(obj, dict):
        return ("dict", tuple((k, _flatten(v, leaves))
                              for k, v in sorted(obj.items())))
    if isinstance(obj, nn.Module):
        return ("module", id(obj))
    try:
        hash(obj)
        return ("value", type(obj).__name__, obj)
    except TypeError:
        return ("value", type(obj).__name__, repr(obj))


def _replace(obj, it):
    """``obj`` with its tensors replaced, in order, by those of ``it``."""
    if isinstance(obj, torch.Tensor):
        return next(it)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_replace(o, it) for o in obj)
    if isinstance(obj, dict):
        return {k: _replace(v, it) for k, v in obj.items()}
    return obj


def _copy_out(obj):
    """The body's output with each tensor replaced by a detached copy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_copy_out(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _copy_out(v) for k, v in obj.items()}
    return obj


def _tensors(obj) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _flatten(obj, out)
    return out


class _Program:
    """One key's program.  On the card: ``calls`` so far, the static
    input buffers, the graph and its output, the kernel launches one
    replay makes, and the capture's error if it failed."""

    def __init__(self, device: Optional[torch.device]):
        self.device = device
        self.calls = 0
        self.statics: List[torch.Tensor] = []
        self.graph = None
        self.output = None
        self.launches: Dict[str, int] = {}
        self.error: Optional[CaptureError] = None


class StaticFunction:
    """A function compiled by :func:`to_static`: call it as the function.
    ``program_cache``: key -> program; ``misses``, ``hits``,
    ``captures``: counts over this function's calls."""

    def __init__(self, fn: Callable, input_spec=None):
        self._fn = fn
        self._input_spec = input_spec
        self._programs: Dict[Tuple, _Program] = {}
        self._enabled = True
        self.misses = self.hits = self.captures = 0
        self._pool = None
        functools.update_wrapper(self, fn)

    @property
    def program_cache(self) -> Dict[Tuple, _Program]:
        return self._programs

    def rollback(self) -> Callable:
        """Stop compiling: later calls run the function itself."""
        self._enabled = False
        return self._fn

    def _extra_key(self, args) -> Tuple:
        """Mode bits that change what the body runs: grad mode, and the
        ``training`` flags of the function's module and module arguments."""
        bits: List[Any] = [torch.is_grad_enabled()]
        owner = getattr(self._fn, "__self__", None)
        for m in [owner, *args]:
            if isinstance(m, nn.Module):
                bits.append(tuple(s.training for s in m.modules()))
        return tuple(bits)

    def __call__(self, *args, **kwargs):
        if not (self._enabled and _enabled["to_static"]):
            return self._fn(*args, **kwargs)
        leaves: List[torch.Tensor] = []
        key = (_flatten(args, leaves), _flatten(kwargs, leaves),
               self._extra_key(args))
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _Program(self._device(leaves))
            self.misses += 1
        else:
            self.hits += 1
        if prog.device is None:
            return self._fn(*args, **kwargs)
        return self._run(prog, args, kwargs, leaves)

    @staticmethod
    def _device(leaves: List[torch.Tensor]) -> Optional[torch.device]:
        """The card the program runs on, or None (a body run as it is)."""
        devices = {t.device for t in leaves}
        cuda = {d for d in devices if d.type == "cuda"}
        if not cuda:
            return None
        if len(devices) > 1:
            raise ValueError(
                f"to_static: tensor arguments on {sorted(map(str, devices))}"
                "; a program on the card takes its tensors on one device")
        return cuda.pop()

    def _run(self, prog: _Program, args, kwargs, leaves):
        if prog.error is not None:
            raise CaptureError(str(prog.error)) from prog.error
        prog.calls += 1
        side = _capture_stream(prog.device)
        cur = torch.cuda.current_stream(prog.device)
        if prog.calls == 1:
            # the real first step, on the capture stream
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = self._fn(*args, **kwargs)
            cur.wait_stream(side)
            for t in _tensors(out):
                t.record_stream(cur)
            return out
        if prog.graph is None:
            self._capture(prog, args, kwargs, leaves, side, cur)
        else:
            for dst, src in zip(prog.statics, leaves):
                dst.copy_(src)
        prog.graph.replay()
        kernels.add_launches(prog.launches)
        return _copy_out(prog.output)

    def _capture(self, prog: _Program, args, kwargs, leaves, side, cur):
        """Copy the arguments into static buffers and capture the body on
        ``side`` into a graph of this function's pool."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            prog.statics = [t.detach().clone() for t in leaves]
        it = iter(prog.statics)
        s_args, s_kwargs = _replace(args, it), _replace(kwargs, it)
        graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        # the cyclic collector must not run inside a capture
        # (serving/programs.py)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                output = self._fn(*s_args, **s_kwargs)
        except Exception as e:      # any failure leaves no usable program
            prog.error = _capture_error(self._fn, e)
            _end_failed_capture(prog.device, side)
            raise prog.error from e
        finally:
            if collecting:
                gc.enable()
            after = kernels.launch_counts()
            # the capture launched nothing: its counts move to the replays
            prog.launches = {n: after[n] - before[n] for n in after
                             if after[n] != before[n]}
            kernels.add_launches({n: -c for n, c in prog.launches.items()})
        cur.wait_stream(side)
        prog.graph, prog.output = graph, output
        self.captures += 1


def _end_failed_capture(device: torch.device, stream) -> None:
    """After a capture that failed: a failed ``cudaStreamEndCapture``
    leaves torch's CUDA generator marked as capturing, and every later
    draw from it then raises; a trivial capture that succeeds clears the
    mark."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        torch.zeros(1, device=device).add_(1)
    del graph


def _capture_error(fn, e: BaseException) -> CaptureError:
    name = getattr(fn, "__qualname__", getattr(fn, "__name__", repr(fn)))
    text = " | ".join(str(x) for x in (e, e.__context__) if x is not None)
    if "captur" in text:
        cause = ("its body reads a device value on the host or "
                 "synchronizes (.item(), float(), int(), bool(), .tolist(), "
                 ".cpu(), printing a tensor, torch.cuda.synchronize()), "
                 "which a CUDA graph capture forbids")
    else:
        cause = "its body raised during the capture"
    return CaptureError(f"to_static: {name} could not be captured as a CUDA "
                        f"graph: {cause} ({type(e).__name__}: {text})")


def to_static(function=None, input_spec=None, **kwargs):
    """Compile ``function`` (decorator, with or without arguments).  An
    ``nn.Module`` gets its ``forward`` compiled and is returned; a
    program's tensor outputs are values (detached), so compile a whole
    train step rather than a forward whose backward runs outside it."""

    def _decorate(fn):
        if isinstance(fn, nn.Module):
            fn.forward = StaticFunction(fn.forward, input_spec)
            return fn
        return StaticFunction(fn, input_spec)

    return _decorate(function) if function is not None else _decorate



def not_to_static(fn):
    """Mark ``fn`` as not to be converted (the JAX package's dy2static
    marker; the port converts no control flow)."""
    fn._not_to_static = True
    return fn


def enable_to_static(enable: bool = True) -> None:
    """Turn compilation on or off for every :class:`StaticFunction`: off,
    each runs its function."""
    _enabled["to_static"] = bool(enable)
