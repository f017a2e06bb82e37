"""``jit.to_static``: a step compiled once per input spec, on the card a
CUDA graph.

Port of ``paddle_tpu/jit/__init__.py`` (``to_static``,
``StaticFunction``, ``InputSpec``, ``not_to_static``, ``save``, ``load``,
``TranslatedLayer``, ``ProgramTranslator``, ``enable_to_static``,
``set_code_level``, ``set_verbosity``, ``TracedLayer``).  A
:class:`StaticFunction` converts its function's Python control flow over
tensors at construction (:mod:`.dy2static`, the JAX package's AST
rewrite), into calls of ``static.nn.cond`` / ``while_loop``: on the CPU
and at a program's eager first call they run Python's own control flow;
captured on the card they become CUDA graph IF and WHILE nodes, so one
graph follows the data at every replay; under ``torch.export`` (``save``)
they become ``torch.cond`` / ``torch.while_loop``.  The JAX package traces a function (a model forward, or a whole
train step with backward and ``optimizer.step()``) into one XLA program
per input spec.  Here a program is one per key: the tensor arguments'
shapes, dtypes and devices, the other arguments' values, and the mode bits
of ``_extra_key`` (grad mode, ``FLAGS_check_nan_inf``, the ``training``
flags of the function's module and of module arguments), as the JAX cache
keys it (:179-194).  A program captured with ``FLAGS_check_nan_inf`` on
scans every op into a device flag buffer and raises after each replay
that found a NaN or Inf (:mod:`..flags`).
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

A program's build is its key's first call plus, on the card, its capture
at the second call.  :func:`subscribe_compiles` listeners (the port's
``obs.CompileLedger``, as in ``paddle_tpu/jit/__init__.py:40-75``) get one
record at the first call (``event: "build"``, the eager call's seconds)
and, on the card, one at the capture (``event: "capture"``, its seconds),
both naming the same ``program``; with no listener the miss path pays one
falsy check.

``save``, ``load`` and ``TranslatedLayer`` (:302-450) are the deployment
format.  ``save(layer, path, input_spec)`` exports, with ``torch.export``,
a function of ``(state, inputs)`` that calls the layer through
``torch.func.functional_call`` (the JAX ``pure(state_arrays,
in_arrays)``), so that:

- ``<path>.pdmodel`` is a weight-free ``torch.export`` archive (the
  layer's parameters and buffers are its inputs, never its constants);
- ``<path>.pdiparams`` is the state in :mod:`.framework.io`'s format;
- ``<path>.pdmeta.json`` is the JAX sidecar's ``format: 1`` (input names,
  shapes with ``None`` where a dim is symbolic, dtypes).

An ``InputSpec`` dim given as ``None`` or ``-1`` becomes a
``torch.export.Dim`` of range 1.. (traced at size 2: ``torch.export``
specializes a dim whose example is 1).  Attention in the program is the
registered op ``paddle_tpu_torch::flash_fwd``, whose implementation the
dispatcher picks by device when the program runs (K1 on the card).
``load(path, device)`` moves the program and the state to ``device``
(``"cuda"`` unless the caller asks for the CPU), so a program exported on
the CPU runs K1 on the card.  A ``.pdmodel`` the JAX package wrote
(serialized StableHLO) is refused, naming what it is; its ``.pdiparams``
and ``.pdmeta.json`` still load (:func:`.framework.load`).  A forward
whose Python control flow depends on a tensor's value is exported after
the same conversion as ``to_static``'s: its branches and loops are the
archive's ``torch.cond`` / ``torch.while_loop``, which a loaded program
runs through torch's own higher-order-op path on either device.  A
construct the conversion leaves as Python (``dy2static``'s bail rules)
that a traced tensor reaches raises :class:`.dy2static.Dy2StaticError`
naming the construct and the user's line.
"""
from __future__ import annotations

import functools
import gc
import io
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import flags
from ..ops import kernels
from ..serving.programs import _capture_stream
from .trace import _Program

__all__ = ["CaptureError", "InputSpec", "ProgramTranslator",
           "StaticFunction", "TracedLayer", "TranslatedLayer",
           "declarative", "enable_to_static", "load", "not_to_static",
           "save", "set_code_level", "set_verbosity", "to_static",
           "subscribe_compiles", "unsubscribe_compiles", "in_to_static"]

# -- program builds, for the compile ledger -----------------------------------

_compile_listeners: List[Callable[[dict], None]] = []


def subscribe_compiles(listener: Callable[[dict], None]) -> None:
    """Register ``listener(record)`` for every program build: a key's
    first call (``record["event"] == "build"``) and, on the card, its
    capture (``"capture"``), the two naming the same ``record["program"]``
    (see :class:`paddle_tpu_torch.obs.compile_ledger.CompileLedger`).
    Idempotent per listener object."""
    if listener not in _compile_listeners:
        _compile_listeners.append(listener)


def unsubscribe_compiles(listener: Callable[[dict], None]) -> None:
    try:
        _compile_listeners.remove(listener)
    except ValueError:
        pass


def _compile_call_site() -> str:
    """The innermost stack frame outside this package and torch: who asked
    for the build."""
    skip = (os.sep + "paddle_tpu_torch" + os.sep, os.sep + "torch" + os.sep)
    for fr in reversed(traceback.extract_stack()):
        if not any(s in fr.filename for s in skip):
            return f"{fr.filename}:{fr.lineno}"
    return "<framework>"


def _arg_specs_str(leaves: List[torch.Tensor]) -> str:
    return ",".join(f"{str(t.dtype).replace('torch.', '')}"
                    f"[{','.join(str(d) for d in t.shape)}]" for t in leaves)


def _notify_compile(static_fn, prog, leaves, seconds: float,
                    event: str) -> None:
    fn = static_fn._fn
    rec = {"fn": getattr(fn, "__qualname__", getattr(fn, "__name__", "<fn>")),
           "key": prog.digest, "program": prog.serial, "event": event,
           "arg_specs": _arg_specs_str(leaves),
           "seconds": round(seconds, 6), "site": _compile_call_site(),
           "cache_size": len(static_fn._programs)}
    for cb in list(_compile_listeners):
        try:
            cb(rec)
        except Exception as e:  # noqa: BLE001 — an observer never breaks
            # a step (nor masks its real exception)
            print(f"paddle_tpu_torch.jit: compile listener {cb!r} raised "
                  f"{type(e).__name__}: {e} (ignored)", file=sys.stderr)


class CaptureError(RuntimeError):
    """A compiled step's body could not be captured as a CUDA graph."""


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a name (``"int64"``), a numpy dtype or type
    (``np.float32``) or a torch dtype.  A 64-bit type stays 64-bit (the
    JAX package narrows it to 32)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return getattr(torch, name)


class InputSpec:
    """Declarative input signature (``paddle.static.InputSpec``): kept
    with the function, as the JAX package keeps it for its concrete
    programs."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = list(shape)
        self.dtype = _torch_dtype(dtype)
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


#: how many compiled functions' bodies are running now (:func:`in_to_static`)
_static_depth = [0]


def in_to_static() -> bool:
    """Whether the caller runs inside a :func:`to_static` function's body
    (on the card: its eager build, its capture; on the CPU: every call)."""
    return _static_depth[0] > 0


class StaticFunction:
    """A function compiled by :func:`to_static`: call it as the function.
    ``program_cache``: key -> program; ``misses``, ``hits``,
    ``captures``: counts over this function's calls."""

    def __init__(self, fn: Callable, input_spec=None):
        from .dy2static import convert_function

        # the JAX package's rewrite of tensor control flow (a no-op on a
        # function without it)
        self._raw = fn
        self._fn = convert_function(fn)
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
        """Stop compiling: later calls run the function (converted, which
        in eager code computes what the function does); returns the
        function itself."""
        self._enabled = False
        return self._raw

    def last_program(self) -> _Program:
        """The program built last (for :meth:`_Program.compiled_stats`)."""
        if not self._programs:
            raise RuntimeError("no program compiled yet — call the "
                               "function once first")
        return next(reversed(self._programs.values()))

    def _key(self, args, kwargs, leaves):
        return (_flatten(args, leaves), _flatten(kwargs, leaves),
                self._extra_key(args))

    def get_concrete_program(self, *args, **kwargs) -> _Program:
        """The program for these arguments' key, made (not run) if it is
        new: its build is its first call, as every program's is."""
        leaves: List[torch.Tensor] = []
        key = self._key(args, kwargs, leaves)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _Program(self._device(leaves), key,
                                                  self._fn)
        return prog

    def concrete_program_specify_input_spec(self, input_spec=None
                                            ) -> _Program:
        """:meth:`get_concrete_program` at zeros of ``input_spec`` (the
        function's own by default), a symbolic dim at 1."""
        spec = input_spec or self._input_spec
        if spec is None:
            raise ValueError("input_spec required")
        tensors = [torch.zeros([1 if _is_symbolic(d) else int(d)
                                for d in s.shape], dtype=s.dtype)
                   if isinstance(s, InputSpec) else s for s in spec]
        return self.get_concrete_program(*tensors)

    def _extra_key(self, args) -> Tuple:
        """Mode bits that change what the body runs: grad mode,
        ``FLAGS_check_nan_inf`` (a scanned capture is a program of its
        own), and the ``training`` flags of the function's module and
        module arguments."""
        bits: List[Any] = [torch.is_grad_enabled(),
                           flags.get_flag("check_nan_inf")]
        owner = getattr(self._fn, "__self__", None)
        for m in [owner, *args]:
            if isinstance(m, nn.Module):
                bits.append(tuple(s.training for s in m.modules()))
        return tuple(bits)

    def __call__(self, *args, **kwargs):
        _static_depth[0] += 1
        try:
            return self._call(args, kwargs)
        finally:
            _static_depth[0] -= 1

    def _call(self, args, kwargs):
        if not (self._enabled and ProgramTranslator.enable_to_static):
            return self._fn(*args, **kwargs)
        leaves: List[torch.Tensor] = []
        key = self._key(args, kwargs, leaves)
        prog = self._programs.get(key)
        if prog is None or prog.calls == 0:
            if prog is None:
                prog = self._programs[key] = _Program(self._device(leaves),
                                                      key, self._fn)
            self.misses += 1
        else:
            self.hits += 1
        if prog.calls == 0:
            prog.args = (args, kwargs)
        if prog.device is None:
            build = prog.calls == 0
            prog.calls += 1
            if not (build and _compile_listeners):
                return self._fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return self._fn(*args, **kwargs)
            finally:
                _notify_compile(self, prog, leaves,
                                time.perf_counter() - t0, "build")
        if not (prog.calls < 2 and _compile_listeners):
            return self._run(prog, args, kwargs, leaves)
        # a build on the card: the eager first call, or the capture (and
        # the first replay) at the second
        event = "capture" if prog.calls else "build"
        t0 = time.perf_counter()
        try:
            return self._run(prog, args, kwargs, leaves)
        finally:
            torch.cuda.current_stream(prog.device).synchronize()
            _notify_compile(self, prog, leaves, time.perf_counter() - t0,
                            event)

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
            # the real first step, on the capture stream; a branch over a
            # device value also warms its untaken side there
            from ..static import nn as snn

            side.wait_stream(cur)
            with torch.cuda.stream(side), snn.warming():
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
        if prog.nan_check is not None:
            prog.nan_check.raise_if_fired()
        return _copy_out(prog.output)

    def _capture(self, prog: _Program, args, kwargs, leaves, side, cur):
        """Copy the arguments into static buffers and capture the body on
        ``side`` into a graph of this function's pool."""
        from ..static import nn as snn

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        prog.pool = self._pool
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            prog.statics = [t.detach().clone() for t in leaves]
            # the conditional nodes' run counters and body pools live as
            # long as the program's graph
            prog.nodes = snn.Nodes(prog.device)
        it = iter(prog.statics)
        s_args, s_kwargs = _replace(args, it), _replace(kwargs, it)
        # what compiled_stats runs at: the buffers each replay refills
        prog.args = (s_args, s_kwargs)
        graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        # the cyclic collector must not run inside a capture
        # (serving/programs.py)
        collecting = gc.isenabled()
        gc.disable()
        if flags.get_flag("check_nan_inf"):
            prog.nan_check = flags.CapturedCheck()
        flags._Scan.sink = prog.nan_check
        try:
            with prog.nodes, torch.cuda.graph(graph, pool=self._pool,
                                              stream=side):
                output = self._fn(*s_args, **s_kwargs)
        except Exception as e:      # any failure leaves no usable program
            prog.error = _capture_error(self._fn, e)
            _end_failed_capture(prog.device, side)
            del graph
            prog.nodes.release()
            raise prog.error from e
        finally:
            flags._Scan.sink = None
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
    """The failed capture named; a host read of a device value in control
    flow the conversion left as Python also names that statement
    (``dy2static.map_trace_error``)."""
    from .dy2static import Dy2StaticError, map_trace_error

    name = getattr(fn, "__qualname__", getattr(fn, "__name__", repr(fn)))
    text = " | ".join(str(x) for x in (e, e.__context__) if x is not None)
    if isinstance(e, Dy2StaticError):
        cause = "its control flow could not be converted"
    elif isinstance(e, CaptureError):
        cause = "an op of its body refused the capture"
    elif "captur" in text:
        cause = ("its body reads a device value on the host or "
                 "synchronizes (.item(), float(), int(), bool(), .tolist(), "
                 ".cpu(), printing a tensor, torch.cuda.synchronize()), "
                 "which a CUDA graph capture forbids")
        mapped = map_trace_error(e)
        if mapped is not None:
            text = f"{text}\n{mapped}"
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


declarative = to_static


def not_to_static(fn):
    """Mark ``fn`` as not to be converted: a call of it from converted code
    runs it as it is (``dy2static.convert_call``)."""
    fn._not_to_static = True
    return fn


class ProgramTranslator:
    """The reference's dygraph-to-static singleton: ``enable(False)`` makes
    every :class:`StaticFunction` run its function eagerly."""

    _instance = None
    enable_to_static = True

    @classmethod
    def get_instance(cls) -> "ProgramTranslator":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static: bool) -> None:
        type(self).enable_to_static = bool(enable_to_static)


def enable_to_static(enable: bool = True) -> None:
    """Turn compilation on or off for every :class:`StaticFunction`: off,
    each runs its function."""
    ProgramTranslator.get_instance().enable(enable)


def set_code_level(level=100, also_to_stdout=False) -> None:
    """The reference's debug knob for printing transformed code; accepted
    and ignored, as in the JAX package."""


def set_verbosity(level=0, also_to_stdout=False) -> None:
    """The reference's dy2static logging verbosity; accepted and ignored,
    as in the JAX package."""


class TracedLayer:
    """The reference's ``TracedLayer`` (trace, then save for inference):
    :meth:`trace` runs the layer once eagerly and compiles a function
    that calls it (the layer itself is left as it is: its direct calls
    stay eager); ``save_inference_model`` is :func:`save` of that
    function at the traced inputs."""

    def __init__(self, layer, inputs):
        self._layer = layer
        self._static = to_static(lambda *a, **k: layer(*a, **k))
        self._inputs = list(inputs)

    @staticmethod
    def trace(layer, inputs):
        outs = layer(*inputs)
        return outs, TracedLayer(layer, inputs)

    def __call__(self, *args, **kwargs):
        return self._static(*args, **kwargs)

    def save_inference_model(self, path, feed=None, fetch=None, **kwargs):
        save(self._layer, path, input_spec=self._inputs)


# -- save / load: the deployment format --------------------------------------

def _is_symbolic(d) -> bool:
    return d is None or (isinstance(d, int) and d < 0)


def _example(spec) -> torch.Tensor:
    """An input to trace with: zeros of the spec's shape, a symbolic dim
    at size 2 (``torch.export`` specializes a dim whose example is 0 or
    1); a tensor given in place of a spec is taken as it is."""
    if isinstance(spec, torch.Tensor):
        return spec
    return torch.zeros([2 if _is_symbolic(d) else int(d)
                        for d in spec.shape], dtype=spec.dtype)


class _Call(nn.Module):
    """The layer as a submodule (so that ``functional_call`` swaps its
    tensors) and the forward to call."""

    def __init__(self, net: Optional[nn.Module], fn: Callable):
        super().__init__()
        self.net = net
        self.fn = fn

    def forward(self, *inputs):
        return self.fn(*inputs)


class _Pure(nn.Module):
    """``(state, *inputs) -> fn(*inputs)`` with the layer's tensors taken
    from ``state`` (in ``names`` order).  The layer is held outside the
    module tree, so the exported program owns none of its tensors."""

    def __init__(self, call: _Call, names: List[str]):
        super().__init__()
        object.__setattr__(self, "_call", call)
        self._names = names

    def forward(self, state, *inputs):
        return torch.func.functional_call(
            self._call, {f"net.{n}": t for n, t in zip(self._names, state)},
            inputs)


def export_program(module: nn.Module, args: tuple, dynamic_shapes=None):
    """``torch.export.export`` (non-strict, no grad) of ``module`` at
    ``args``.  A traced tensor that reaches control flow the conversion
    left as Python raises :class:`.dy2static.Dy2StaticError` naming the
    construct and the user's line."""
    from .dy2static import Dy2StaticError, host_read_error, map_trace_error

    try:
        with torch.no_grad():
            return torch.export.export(module, args,
                                       dynamic_shapes=dynamic_shapes,
                                       strict=False)
    except Dy2StaticError:
        raise
    except Exception as e:
        mapped = map_trace_error(e) if host_read_error(e) else None
        if mapped is not None:
            raise mapped from e
        raise


def save(layer, path: str, input_spec=None, **configs) -> None:
    """``paddle.jit.save``: export ``layer`` (an ``nn.Module``, its bound
    forward, or a :func:`to_static` function) for ``input_spec`` (a list of
    :class:`InputSpec` or example tensors) to ``<path>.pdmodel``,
    ``<path>.pdiparams`` and ``<path>.pdmeta.json`` (module docstring).
    The layer is traced in eval mode with no gradient, on the device its
    tensors are on."""
    from ..framework.io import save as _fsave

    from .dy2static import convert_function

    if isinstance(layer, nn.Module):
        fwd, net = layer.forward, layer
    else:
        fwd, net = layer, getattr(layer, "__self__", None)
    if input_spec is None and isinstance(fwd, StaticFunction):
        input_spec = fwd._input_spec
    if input_spec is None:
        raise ValueError("jit.save requires input_spec")
    # the same conversion as to_static's: tensor control flow exports as
    # torch.cond / torch.while_loop
    raw_fn = fwd._fn if isinstance(fwd, StaticFunction) else \
        convert_function(fwd)
    state = {} if net is None else {**dict(net.named_parameters()),
                                    **dict(net.named_buffers())}
    names = sorted(state)
    devices = {t.device for t in state.values()}
    if len(devices) > 1:
        raise ValueError(f"jit.save: the layer's tensors lie on "
                         f"{sorted(map(str, devices))}")
    device = devices.pop() if devices else torch.device("cpu")
    examples = [_example(s).to(device) for s in input_spec]
    dims = iter(torch.export.Dim(f"_d{i}", min=1) for i in range(64))
    dynamic = [{a: next(dims) for a, d in enumerate(s.shape)
                if _is_symbolic(d)} or None
               if isinstance(s, InputSpec) else None for s in input_spec]
    was_training = net.training if net is not None else False
    if net is not None:
        net.eval()
    try:
        program = export_program(
            _Pure(_Call(net, raw_fn), names),
            ([state[n].detach() for n in names], *examples),
            ([None] * len(names), tuple(dynamic)))
    finally:
        if net is not None and was_training:
            net.train()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    # the archive keeps no tensor: not the traced examples (the state
    # among them), which torch.export would otherwise store with it
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    with open(path + ".pdmodel", "wb") as f:
        f.write(buf.getvalue())
    _fsave({n: state[n] for n in names}, path + ".pdiparams")
    in_names = [getattr(s, "name", None) or f"x{i}"
                for i, s in enumerate(input_spec)]
    meta = {"format": 1, "input_names": in_names,
            "inputs": [{"name": name,
                        "shape": [None if _is_symbolic(d) else int(d)
                                  for d in (s.shape
                                            if isinstance(s, InputSpec)
                                            else ex.shape)],
                        "dtype": str(ex.dtype).split(".")[-1]}
                       for name, s, ex in zip(in_names, input_spec,
                                              examples)]}
    with open(path + ".pdmeta.json", "w") as f:
        json.dump(meta, f, indent=1)


class TranslatedLayer:
    """An inference-only callable loaded by :func:`load` (reference:
    ``fluid/dygraph/io.py:1137``): the exported program, its state on one
    device, and the input dtypes of the sidecar."""

    def __init__(self, program, state: Dict[str, torch.Tensor],
                 device: torch.device, input_dtypes=None):
        self._program = program
        self._module = program.module()
        self._names = sorted(state)
        self._state = state
        self._device = device
        self._input_dtypes = input_dtypes

    @property
    def device(self) -> torch.device:
        return self._device

    def _input(self, i: int, x) -> torch.Tensor:
        t = torch.as_tensor(x)
        dtype = (self._input_dtypes[i] if self._input_dtypes
                 and i < len(self._input_dtypes) else t.dtype)
        return t.to(self._device, dtype=dtype)

    def __call__(self, *inputs):
        args = [self._input(i, x) for i, x in enumerate(inputs)]
        with torch.no_grad():
            out = self._module([self._state[n] for n in self._names], *args)
        if isinstance(out, (list, tuple)):
            return out[0] if len(out) == 1 else list(out)
        return out

    forward = __call__

    def eval(self) -> "TranslatedLayer":
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is inference-only")

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self._state)


def load(path: str, device="cuda", **configs) -> TranslatedLayer:
    """``paddle.jit.load``: what :func:`save` wrote, as a
    :class:`TranslatedLayer` on ``device`` (``"cuda"`` unless the caller
    asks for the CPU; no card raises).  The program's recorded devices are
    rewritten to ``device``, so a program exported on the CPU runs on the
    card.  A ``.pdmodel`` of the JAX package (serialized StableHLO) raises
    ``ValueError``."""
    from torch.export.passes import move_to_device_pass

    from ..framework.io import load as _fload

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"jit.load: device {device!r} asked for, but no "
                           f"CUDA device is available (pass device='cpu' "
                           f"to run on the CPU)")
    with open(path + ".pdmodel", "rb") as f:
        blob = f.read()
    if not blob.startswith(b"PK"):
        raise ValueError(
            f"jit.load: {path}.pdmodel is not a torch.export archive; the "
            f"JAX package writes its programs as serialized StableHLO, "
            f"which this package does not run (its .pdiparams loads with "
            f"paddle_tpu_torch.framework.load, its .pdmeta.json as JSON)")
    program = torch.export.load(io.BytesIO(blob))
    program = move_to_device_pass(program, dev)
    state = {n: t.detach().to(dev)
             for n, t in _fload(path + ".pdiparams").items()}
    dtypes = None
    try:
        with open(path + ".pdmeta.json") as f:
            dtypes = [getattr(torch, i["dtype"])
                      for i in json.load(f)["inputs"]]
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        pass
    return TranslatedLayer(program, state, dev, dtypes)
