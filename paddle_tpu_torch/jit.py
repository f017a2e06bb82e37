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
whose Python control flow depends on a tensor's value cannot be exported:
the JAX package rewrites it (``jit/dy2static.py``), which is not ported
(ROADMAP.md A.5), and ``save`` raises naming that.  ``TracedLayer``
(``jit/trace.py``) is not ported either.
"""
from __future__ import annotations

import functools
import gc
import io
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .ops import kernels
from .serving.programs import _capture_stream

__all__ = ["CaptureError", "InputSpec", "StaticFunction", "TranslatedLayer",
           "enable_to_static", "load", "not_to_static", "save", "to_static"]

_enabled = {"to_static": True}


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


def _data_dependent(e: BaseException) -> bool:
    text = " ".join(str(x) for x in (e, e.__cause__, e.__context__)
                    if x is not None).lower()
    return "data-dependent" in text or "data dependent" in text


def save(layer, path: str, input_spec=None, **configs) -> None:
    """``paddle.jit.save``: export ``layer`` (an ``nn.Module``, its bound
    forward, or a :func:`to_static` function) for ``input_spec`` (a list of
    :class:`InputSpec` or example tensors) to ``<path>.pdmodel``,
    ``<path>.pdiparams`` and ``<path>.pdmeta.json`` (module docstring).
    The layer is traced in eval mode with no gradient, on the device its
    tensors are on."""
    from .framework.io import save as _fsave

    if isinstance(layer, nn.Module):
        fwd, net = layer.forward, layer
    else:
        fwd, net = layer, getattr(layer, "__self__", None)
    if input_spec is None and isinstance(fwd, StaticFunction):
        input_spec = fwd._input_spec
    if input_spec is None:
        raise ValueError("jit.save requires input_spec")
    raw_fn = fwd._fn if isinstance(fwd, StaticFunction) else fwd
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
        with torch.no_grad():
            program = torch.export.export(
                _Pure(_Call(net, raw_fn), names),
                ([state[n].detach() for n in names], *examples),
                dynamic_shapes=([None] * len(names), tuple(dynamic)),
                strict=False)
    except Exception as e:
        if _data_dependent(e):
            raise NotImplementedError(
                f"jit.save: the forward's Python control flow depends on a "
                f"tensor's value, which torch.export cannot trace; the JAX "
                f"package rewrites such control flow (jit/dy2static.py), "
                f"which is not ported (ROADMAP.md A.5): "
                f"{str(e).splitlines()[0]}") from e
        raise
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

    from .framework.io import load as _fload

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
