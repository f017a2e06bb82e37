"""``paddle.static`` program mode: ``Program``, ``Executor`` and the rest.

Port of ``paddle_tpu/static/program.py`` (reference:
``python/paddle/fluid/framework.py`` Program/Variable,
``fluid/executor.py:625`` Executor).  There is no ProgramDesc: while
static mode is on (:func:`enable_static`), every op run is recorded into
the current program (:func:`default_main_program`, or the one of
:func:`program_guard`) and also run, under ``torch.no_grad``, on the
placeholders' zeros, so that shapes are known as the program is built.

What one op is.  The JAX package records at its dispatch chokepoint,
where a kernel is one op.  The port records at the outermost of:

- a public op of the ``paddle.*`` or ``nn.functional`` surface
  (``ops._helpers.public_op``; its kernel override is looked up again at
  every replay), a ``torch.autograd.Function``'s ``apply`` (the port's K1-K3
  Function, ``PyLayer``, the captured ``cond`` and the rest: static mode
  routes ``Function.apply`` through the recorder), a kernel wrapper of
  ``ops.kernels``, a registered op (``torch.ops.*``), or
- any other torch function or tensor method, seen by a
  ``TorchFunctionMode`` (:class:`_Recorder`).

What runs inside a recorded op is not recorded; the op replays by being
called again.  ``static.nn.cond`` and ``while_loop`` over a program value
record their branches and body as sub-programs and are one op whose replay
calls ``cond`` / ``while_loop`` again: Python control flow on the CPU,
CUDA graph IF and WHILE nodes in a capture (:mod:`.nn`).

What an op reads.  A tensor input is a placeholder (:func:`data`), the
output of a recorded op, or a leaf: a parameter, a buffer or any tensor
made before recording, read live at every replay (a parameter updated
between runs is seen).  An op none of whose inputs is any of these (a
creation op, a draw, arithmetic on such results) is run once and its
outputs are constants of the program.  An op that writes one of its inputs
in place and reads no placeholder (a parameter's initialization) is run
once and not recorded; one that reads a placeholder and writes a leaf
writes a copy of it at replay, as the JAX package's functional update
leaves the leaf as it was.  A tensor made while recording that is none of
these (made inside a recorded op and handed out another way) raises when
an op consumes it, naming that op, and so does reading a placeholder's
value on the host (``.item()``, ``.numpy()``, ``bool()``...): it holds
no data until :meth:`Executor.run`.

Replay.  :meth:`Executor.run` runs the recorded ops in order with the feeds
in place of the placeholders, through a :func:`..jit.to_static` function
per (feed names, fetch list), whose own cache keys the feeds' shapes:
every call on the CPU, and on the card the key's first call eagerly, the
second captured as a CUDA graph, the rest replayed.  After
``Optimizer.minimize`` the program trains: one call runs forward,
``backward()``, ``step()`` and ``clear_grad()`` (one graph on the card).
Nothing is recorded while a program runs.

Shape guards.  A ``None`` dim of :func:`data` records at a distinctive
dummy size (61 for every feed's first ``None`` axis, then 67, 71...); a
shape read from a placeholder or a tensor derived from one carries its
feed (:class:`SymbolicDim`), an op whose arguments hold such a dim baked
it, and ``Executor.run`` raises when a feed contradicts a baked size.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import tempfile
import threading
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.overrides import TorchFunctionMode

from ..device import CPUPlace, CUDAPlace, current_device
from ..ops import _helpers

__all__ = [
    "Program", "program_guard", "default_main_program",
    "default_startup_program", "data", "Executor", "Scope", "global_scope",
    "scope_guard", "cpu_places", "cuda_places", "create_global_var",
    "gradients", "append_backward", "name_scope", "device_guard",
    "BuildStrategy", "ExecutionStrategy", "CompiledProgram",
    "ParallelExecutor", "Print", "ExponentialMovingAverage", "accuracy",
    "auc", "save_inference_model", "load_inference_model",
    "serialize_program", "deserialize_program", "save_to_file",
    "load_from_file", "serialize_persistables", "deserialize_persistables",
    "save_program_state", "load_program_state", "set_program_state",
    "normalize_program", "py_func", "Variable", "xpu_places", "npu_places",
    "mlu_places", "IpuStrategy", "IpuCompiledProgram", "ipu_shard_guard",
    "set_ipu_shard", "enable_static", "disable_static", "in_static_mode",
]


class SymbolicDim(int):
    """An int read from the shape of a placeholder, or of a tensor derived
    from one, while a program records: it carries the ``None``-declared
    feeds it may derive from.  Arithmetic with ints keeps the mark, so
    ``x.shape[0] * n`` in an op's arguments is caught; other operands give
    plain numbers."""

    def __new__(cls, v, feeds=frozenset()):
        self = super().__new__(cls, v)
        self.feeds = frozenset(feeds)
        return self

    @staticmethod
    def _intlike(o):
        return isinstance(o, (int, np.integer)) and not isinstance(o, bool)

    def _mix(self, v, o):
        of = o.feeds if isinstance(o, SymbolicDim) else frozenset()
        return SymbolicDim(v, self.feeds | of)

    def _binary(op):
        def f(self, o):
            if not self._intlike(o):
                return NotImplemented
            return self._mix(op(int(self), int(o)), o)

        def r(self, o):
            if not self._intlike(o):
                return NotImplemented
            return self._mix(op(int(o), int(self)), o)
        return f, r

    __add__, __radd__ = _binary(lambda a, b: a + b)
    __sub__, __rsub__ = _binary(lambda a, b: a - b)
    __mul__, __rmul__ = _binary(lambda a, b: a * b)
    __floordiv__, __rfloordiv__ = _binary(lambda a, b: a // b)
    __mod__, __rmod__ = _binary(lambda a, b: a % b)
    del _binary

    def __neg__(self):
        return SymbolicDim(-int(self), self.feeds)

    def __repr__(self):
        return f"SymbolicDim({int(self)}, feeds={sorted(self.feeds)})"


def _symbolic_feeds(values) -> frozenset:
    out = frozenset()
    for v in values:
        if isinstance(v, SymbolicDim):
            out |= v.feeds or frozenset(["<unknown>"])
    return out


# -- the recorder's state -------------------------------------------------------

#: this thread's recorder depths and current sub-program
_st = threading.local()
#: static mode (:func:`enable_static`) and the thread it records on
_static = {"on": False, "thread": None, "mode": None}
#: a recorded op's body is running (its own calls are not recorded)
_BODY = "body"
#: a program runs, or the recorder is told to look away
_OFF = "off"


def _depth(kind: str) -> int:
    return getattr(_st, kind, 0)


@contextlib.contextmanager
def _entered(kind: str):
    setattr(_st, kind, _depth(kind) + 1)
    try:
        yield
    finally:
        setattr(_st, kind, _depth(kind) - 1)


def no_record():
    """Inside, nothing is recorded (the JAX ``no_static_record``)."""
    return _entered(_OFF)


def _recording() -> Optional["Program"]:
    """The program taking ops now, or None."""
    if not _static["on"] or _depth(_OFF) or _depth(_BODY) or \
            threading.get_ident() != _static["thread"]:
        return None
    sub = getattr(_st, "sub", None)
    return sub if sub is not None else _current["main"]


def in_static_mode() -> bool:
    return _static["on"]


# tensors made inside a recorded op's body: consuming one raises
_born: Dict[int, weakref.ref] = {}


def _note_born(out, args, kwargs) -> None:
    """Mark the tensors a call inside a recorded op's body made (not those
    it was given, which an in-place op hands back)."""
    given = {id(v) for v in pytree.tree_leaves((args, kwargs))
             if isinstance(v, torch.Tensor)}
    for t in pytree.tree_leaves(out):
        if isinstance(t, torch.Tensor) and id(t) not in given and \
                not isinstance(t, torch.nn.Parameter):
            _born[id(t)] = weakref.ref(t, lambda r, i=id(t): _born.pop(i, 0)
                                       if _born.get(i) is r else None)


def _is_born(t) -> bool:
    r = _born.get(id(t))
    return r is not None and r() is t


_HOST_READS = frozenset(["item", "tolist", "numpy", "__bool__", "__int__",
                         "__float__", "__index__", "__array__",
                         "__complex__"])
_NEVER = frozenset(["requires_grad_", "retain_grad", "register_hook",
                    "share_memory_", "record_stream", "backward",
                    "__set__", "__delete__"])
_INPLACE_DUNDER = frozenset([
    "__iadd__", "__isub__", "__imul__", "__itruediv__", "__ifloordiv__",
    "__imod__", "__ipow__", "__iand__", "__ior__", "__ixor__",
    "__ilshift__", "__irshift__", "__imatmul__", "__setitem__"])


def _func_name(func) -> str:
    name = getattr(func, "__name__", None) or type(func).__name__
    if name in ("__get__", "__set__"):
        owner = getattr(func, "__self__", None)
        name = f"{getattr(owner, '__name__', 'attr')}.{name}"
    return name


def _mutated(name: str, args, kwargs):
    """The input an op writes in place (by its name's convention, or
    ``out=``), or None."""
    if isinstance(kwargs.get("out"), torch.Tensor):
        return kwargs["out"]
    short = name.rsplit(".", 1)[-1]
    if short in _INPLACE_DUNDER or (short.endswith("_") and
                                   not short.startswith("__")):
        # the first argument (``torch.nn.init``'s pass it as ``tensor=``)
        first = args[0] if args else next(iter(kwargs.values()), None)
        if isinstance(first, torch.Tensor):
            return first
    return None


class _Recorder(TorchFunctionMode):
    """Static mode's ``TorchFunctionMode``: a torch function called outside
    any recorded op is recorded (:meth:`Program._call`); inside one's body
    it runs as it is, its tensors marked as made there."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        prog = _recording()
        if prog is None:
            out = func(*args, **kwargs)
            if _static["on"] and _depth(_BODY) and not _depth(_OFF):
                _note_born(out, args, kwargs)
            return out
        name = _func_name(func)
        owner = getattr(func, "__self__", None)
        if owner is torch.Tensor.shape or func is torch.Tensor.size:
            return prog._taint(args, func(*args, **kwargs))
        if name in _HOST_READS:
            prog._check_host_read(name, args)
        if name.rsplit(".", 1)[-1] in _NEVER or name in _HOST_READS:
            return func(*args, **kwargs)
        return prog._call(name, func, func, args, kwargs)


_FUNCTION_APPLY = torch.autograd.function.Function.__dict__["apply"]


def _function_apply(cls, *args, **kwargs):
    return _helpers.one_op(cls.__name__, cls.apply,
                           _FUNCTION_APPLY.__get__(None, cls), args, kwargs)


def _op_hook(name, op, impl, args, kwargs):
    """``ops._helpers.record_hook`` while static mode is on."""
    prog = _recording()
    if prog is None:
        if _static["on"] and _depth(_BODY) and not _depth(_OFF):
            out = impl(*args, **kwargs)
            _note_born(out, args, kwargs)
            return out
        return impl(*args, **kwargs)
    return prog._call(name, op, impl, args, kwargs)


def enable_static() -> None:
    """Static mode: ops are recorded into the current program."""
    if _static["on"]:
        return
    mode = _Recorder()
    mode.__enter__()
    _static.update(on=True, thread=threading.get_ident(), mode=mode)
    _helpers.record_hook = _op_hook
    torch.autograd.function.Function.apply = classmethod(_function_apply)


def disable_static() -> None:
    """Back to eager mode (the default)."""
    if not _static["on"]:
        return
    torch.autograd.function.Function.apply = _FUNCTION_APPLY
    _helpers.record_hook = None
    mode = _static["mode"]
    _static.update(on=False, thread=None, mode=None)
    mode.__exit__(None, None, None)


# -- programs -------------------------------------------------------------------

class _Ref:
    """An input of a recorded op: ``kind`` is ``"slot"`` (an op's output),
    ``"leaf"`` (read live), ``"outer"`` (a sub-program's value from the
    enclosing program) or ``"arg"`` (a sub-program's argument)."""

    __slots__ = ("kind", "index")

    def __init__(self, kind: str, index: int):
        self.kind, self.index = kind, index

    def __repr__(self):
        return f"{self.kind}{self.index}"


class _Op:
    __slots__ = ("name", "fn", "flat", "spec", "out_slots", "cow",
                 "mut_slot")

    def __init__(self, name, fn, flat, spec, out_slots, cow, mut_slot):
        self.name = name
        self.fn = fn
        self.flat = flat            # inputs: _Ref or a constant each
        self.spec = spec            # pytree spec of (args, kwargs)
        self.out_slots = out_slots  # per output leaf: slot or None
        self.cow = cow              # input positions copied before the op
        self.mut_slot = mut_slot    # slot of the written input, or None

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.flat))})"


class Program:
    """A recorded op list, its placeholders and leaves (reference
    ``framework.py Program``).  ``ops`` lists the recorded ops."""

    def __init__(self, _parent: Optional["Program"] = None):
        self._ops: List[_Op] = []
        self._leaves: List[torch.Tensor] = []
        # id -> (weakref, kind, index, feeds): what this program knows of
        # a record-time tensor ("slot", "leaf", or "const" for an output
        # of an op that was run once)
        self._tensors: Dict[int, tuple] = {}
        self._n_slots = 0
        self._feed_vars: Dict[str, torch.Tensor] = {}
        self._feed_leaf: Dict[str, int] = {}
        self._declared_shapes: Dict[str, list] = {}
        self._names: Dict[str, _Ref] = {}
        self._sym_feeds: Dict[str, list] = {}
        self._sym_dummy: Dict[int, list] = {}
        self._baked_shape_ops: List[tuple] = []
        self._linear_weights: set = set()    # leaf indices in [out, in]
        self._finalized = False
        self._n_post_run = 0
        self._needs_grad = False
        # set by Optimizer.minimize while this program records
        self._train_spec = None
        self._train_cache: Dict[tuple, object] = {}
        self._cache: Dict[tuple, object] = {}
        # a sub-program (a cond branch, a loop body): its enclosing
        # program, the values it reads from there, its arguments
        self._parent = _parent
        self._outer: List[torch.Tensor] = []
        self._outer_ix: Dict[int, int] = {}
        self._n_args = 0

    @property
    def ops(self) -> List[_Op]:
        return self._ops

    def global_block(self) -> "Program":
        return self

    def list_vars(self) -> List[torch.Tensor]:
        return list(self._feed_vars.values())

    def __repr__(self):
        return f"Program(num_ops={len(self._ops)})"

    # -- what a tensor is to this program ------------------------------------

    def _known(self, t):
        ent = self._tensors.get(id(t))
        if ent is not None and ent[0]() is t:
            return ent
        return None

    def _bind(self, t, kind: str, index: int, feeds=frozenset()) -> None:
        self._tensors[id(t)] = (weakref.ref(t), kind, index, feeds)
        if _is_born(t):
            del _born[id(t)]

    def _kind(self, t, consumer: str) -> tuple:
        """``(kind, feeds)``: "slot", "leaf", "feed" (a placeholder not
        read yet), "arg" or "outer" (dynamic), "const" (a constant of the
        program) or "live" (a tensor from before the recording: a
        parameter, a buffer, a constant of the caller's)."""
        ent = self._known(t)
        if ent is not None:
            return ent[1], ent[3]
        if self._parent is not None:
            feeds = self._parent._dynamic(t)
            if feeds is not None:
                return "outer", feeds
        if _is_born(t):
            raise RuntimeError(
                f"static program: op {consumer!r} consumes a tensor made "
                f"while the program recorded that is neither a placeholder "
                f"(static.data), a parameter or buffer, nor the output of "
                f"a recorded op (it was made inside another op and handed "
                f"out past it); its replay could not recompute it")
        return "live", frozenset()

    def _dynamic(self, t) -> Optional[frozenset]:
        """For a sub-program's lookup: the feeds of ``t`` when it is a
        program value here (an enclosing program's is taken in as an outer
        value), else None."""
        ent = self._known(t)
        if ent is not None:
            return ent[3] if ent[1] != "const" else None
        if self._parent is not None:
            feeds = self._parent._dynamic(t)
            if feeds is not None:
                self._outer_ref(t, feeds)
                return feeds
        return None

    def _outer_ref(self, t, feeds) -> _Ref:
        j = self._outer_ix.get(id(t))
        if j is None:
            j = self._outer_ix[id(t)] = len(self._outer)
            self._outer.append(t)
            self._bind(t, "outer", j, feeds)
        return _Ref("outer", j)

    def _leaf(self, t, feeds=frozenset()) -> int:
        i = len(self._leaves)
        self._leaves.append(t)
        self._bind(t, "leaf", i, feeds)
        return i

    def _ref(self, t, kind: str, feeds) -> _Ref:
        if kind == "feed":
            name = next(iter(feeds))
            self._feed_leaf[name] = self._leaf(t, feeds)
            return _Ref("leaf", self._feed_leaf[name])
        if kind in ("slot", "leaf", "arg", "outer"):
            if kind == "outer" and id(t) not in self._outer_ix:
                return self._outer_ref(t, feeds)
            return _Ref(kind, self._known(t)[2])
        return _Ref("leaf", self._leaf(t))

    def _taint(self, args, dims):
        """A shape read (``x.shape``, ``x.size()``, ``x.size(d)``) while
        recording: the ``None`` axes of a placeholder, and the dims of a
        feed-derived tensor that equal a feed's dummy size, carry the
        feed."""
        t = args[0]
        prog = self._root()
        if not prog._sym_feeds:
            return dims
        ent = self._known(t)
        feeds = ent[3] if ent is not None else frozenset()
        if not feeds:
            return dims
        placeholder = next((n for n in feeds if prog._feed_vars.get(n) is t),
                           None)

        def mark(i, d):
            if placeholder is not None:
                return SymbolicDim(d, {placeholder}) \
                    if i in prog._sym_feeds.get(placeholder, ()) else d
            return SymbolicDim(d, prog._sym_dummy[d]) \
                if d in prog._sym_dummy else d

        if isinstance(dims, int):
            axis = args[1] if len(args) > 1 else -1
            return mark(axis % t.dim(), dims)
        return torch.Size([mark(i, d) for i, d in enumerate(dims)])

    def _root(self) -> "Program":
        return self if self._parent is None else self._parent._root()

    def _check_host_read(self, name: str, args) -> None:
        for a in args:
            if isinstance(a, torch.Tensor):
                try:
                    _, feeds = self._kind(a, name)
                except RuntimeError:
                    continue
                if feeds:
                    raise RuntimeError(
                        f"static program: {name}() reads on the host the "
                        f"value of a tensor derived from feed(s) "
                        f"{sorted(feeds)} while the program records; a "
                        f"placeholder holds no data until Executor.run. "
                        f"Branch with static.nn.cond/while_loop, or run host "
                        f"code in static.py_func")

    # -- recording -------------------------------------------------------------

    def _call(self, name, fn, impl, args, kwargs):
        """Run ``impl(*args, **kwargs)`` (no grad, nothing inside recorded)
        and record the call as one op replaying through ``fn``."""
        if self._finalized:
            # between runs (a schedule, a metric): run, do not record
            self._n_post_run += 1
            with no_record():
                return impl(*args, **kwargs)
        flat, spec = pytree.tree_flatten((args, kwargs))
        kinds = [self._kind(v, name) if isinstance(v, torch.Tensor)
                 else None for v in flat]
        dynamic = any(k is not None and k[0] != "const" for k in kinds)
        feeds = frozenset().union(*(k[1] for k in kinds if k is not None))
        target = _mutated(name, args, kwargs)
        root = self._root()
        if root._sym_feeds:
            baked = _symbolic_feeds(flat)
            if baked:
                root._baked_shape_ops.append((name, baked))
        # no autograd graph at record time; a call with no tensor input (a
        # factory, or a mode switch such as torch.no_grad's) runs as it is
        grad = torch.no_grad() if any(k is not None for k in kinds) else \
            contextlib.nullcontext()
        with _entered(_BODY), grad:
            out = impl(*args, **kwargs)
        outs = pytree.tree_leaves(out)
        inputs = {id(v) for v in flat if isinstance(v, torch.Tensor)}
        if not dynamic or (target is not None and not feeds) or not any(
                isinstance(o, torch.Tensor) for o in outs + [target]):
            # a constant, an initialization, or no tensor out: run once
            for o in outs:
                if isinstance(o, torch.Tensor) and id(o) not in inputs:
                    self._bind(o, "const", -1)
            return out
        refs, cow = [], []
        for i, (v, k) in enumerate(zip(flat, kinds)):
            if k is None:
                refs.append(v)
                continue
            r = self._ref(v, *k)
            refs.append(r)
            if v is target and r.kind != "slot":
                cow.append(i)
        if fn is torch.nn.functional.linear and len(flat) > 1 and \
                isinstance(refs[1], _Ref) and refs[1].kind == "leaf":
            self._linear_weights.add(refs[1].index)
        out_slots = []
        for o in pytree.tree_leaves(out):
            if isinstance(o, torch.Tensor):
                out_slots.append(self._new_slot(o, feeds))
            else:
                out_slots.append(None)
        mut_slot = None
        if target is not None:
            mut_slot = self._new_slot(target, feeds)
        out_name = kwargs.get("name")
        if isinstance(out_name, str) and out_slots and out_slots[0] is not \
                None:
            self._names[out_name] = _Ref("slot", out_slots[0])
        self._ops.append(_Op(name, fn, refs, spec, out_slots, cow,
                             mut_slot))
        self._cache.clear()
        return out

    def _new_slot(self, t, feeds) -> int:
        s = self._n_slots
        self._n_slots += 1
        self._bind(t, "slot", s, feeds)
        return s

    def _register_data(self, name: str, t, declared_shape) -> None:
        self._feed_vars[name] = t
        self._declared_shapes[name] = list(declared_shape)
        # a leaf at its first use, as the JAX package numbers its leaves in
        # op order (a program state's keys)
        self._bind(t, "feed", -1, frozenset([name]))

    # -- running -----------------------------------------------------------------

    def _finalize(self) -> None:
        """Stop recording (ops run between runs are not recorded); a
        placeholder no op read becomes a leaf."""
        for name, t in self._feed_vars.items():
            if name not in self._feed_leaf:
                self._ref(t, "feed", frozenset([name]))
        self._finalized = True

    def _locate(self, target) -> _Ref:
        """A fetch target (a tensor of this program, or a name) as a
        :class:`_Ref`."""
        if isinstance(target, str):
            if target in self._feed_vars:
                return self._locate(self._feed_vars[target])
            ref = self._names.get(target)
            if ref is None:
                raise KeyError(f"no variable named {target!r} in this "
                               "program")
            return ref
        if isinstance(target, _Ref):
            return target
        ent = self._known(target) if isinstance(target, torch.Tensor) \
            else None
        if ent is None:
            raise KeyError("fetch target was not produced by this program")
        if ent[1] in ("const", "feed"):
            return self._ref(target, ent[1], ent[3])
        return _Ref(ent[1], ent[2])

    def _run_ops(self, leaves, outer=(), args=()):
        """Run the ops over ``leaves`` (and a sub-program's ``outer``
        values and ``args``); returns the slot values."""
        env: List[object] = [None] * self._n_slots

        def value(r):
            if r.kind == "slot":
                return env[r.index]
            if r.kind == "leaf":
                return leaves[r.index]
            if r.kind == "outer":
                return outer[r.index]
            return args[r.index]

        for op in self._ops:
            vals = [value(v) if isinstance(v, _Ref) else v for v in op.flat]
            for i in op.cow:
                vals[i] = vals[i].clone()
            a, k = pytree.tree_unflatten(vals, op.spec)
            out = op.fn(*a, **k)
            for s, o in zip(op.out_slots, pytree.tree_leaves(out)):
                if s is not None:
                    env[s] = o
            if op.mut_slot is not None:
                # the written input, after the op
                env[op.mut_slot] = _mutated(op.name, a, k)
        return env, value

    def _feed_tensors(self, feed: dict) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in (feed or {}).items():
            if k not in self._feed_vars:
                raise KeyError(f"feed target {k!r} was not declared with "
                               "static.data in this program")
            want = self._feed_vars[k]
            t = v if isinstance(v, torch.Tensor) else \
                torch.as_tensor(np.asarray(v))
            t = t.to(device=want.device, dtype=want.dtype)
            self._check_baked(k, t, want)
            out[k] = t
        return out

    def _check_baked(self, k: str, t, want) -> None:
        if not self._baked_shape_ops:
            return
        baked_here = sorted({n for n, fs in self._baked_shape_ops
                             if k in fs or "<unknown>" in fs})
        axes = self._sym_feeds.get(k, ()) if baked_here else ()
        for ax in axes:
            if ax < t.dim() and t.shape[ax] != want.shape[ax]:
                raise RuntimeError(
                    f"feed {k!r} has size {t.shape[ax]} at its None-declared "
                    f"axis {ax}, but ops {baked_here} baked an attribute "
                    f"computed from the build-time dummy size "
                    f"{want.shape[ax]} — the replay would be silently "
                    "wrong.  Declare the real size in static.data, or avoid "
                    "computing shape attributes from a None dim (reference "
                    "programs re-infer these at run time)")

    def _program_fn(self, feed_names, fetch, train: bool):
        """The function one (feed names, fetch list) runs: the ops over the
        leaves with the feeds in place (and, training, the step)."""
        from ..jit import to_static

        leaves = list(self._leaves)
        feed_ix = [self._feed_leaf[n] for n in feed_names]
        loss_ref = self._locate(self._train_spec[0]) if train else None
        opt = self._train_spec[1] if train else None

        def run(*feeds):
            lv = list(leaves)
            for i, f in zip(feed_ix, feeds):
                lv[i] = f
            with no_record():
                _, value = self._run_ops(lv)
                if train:
                    value(loss_ref).backward()
                    opt.step()
                    opt.clear_grad()
                return tuple(value(r) for r in fetch)

        run.__name__ = run.__qualname__ = "static_train_step" if train \
            else "static_program"
        return to_static(run)

    def _run(self, feed: dict, fetch_list) -> tuple:
        feeds = self._feed_tensors(feed)
        self._finalize()
        fetch = tuple(self._locate(t) for t in fetch_list)
        names = tuple(sorted(feeds))
        train = self._train_spec is not None
        cache = self._train_cache if train else self._cache
        key = (names, tuple((r.kind, r.index) for r in fetch))
        fn = cache.get(key)
        if fn is None:
            fn = cache[key] = self._program_fn(names, fetch, train)
        grad = train or self._needs_grad
        with no_record(), torch.set_grad_enabled(grad):
            return fn(*[feeds[n] for n in names])

    # -- sub-programs (cond branches, loop bodies) -------------------------------

    @contextlib.contextmanager
    def _sub(self):
        sub = Program(_parent=self)
        prev = getattr(_st, "sub", None)
        _st.sub = sub
        try:
            yield sub
        finally:
            _st.sub = prev

    def _arg(self, t) -> torch.Tensor:
        """A fresh tensor standing for a sub-program's next argument."""
        with no_record():
            a = t.detach().clone()
        self._bind(a, "arg", self._n_args, frozenset(["<arg>"]))
        self._n_args += 1
        return a

    def _outputs(self, out) -> tuple:
        """A branch's or body's result as refs (tensors) and values."""
        leaves, spec = pytree.tree_flatten(out)
        refs = []
        for v in leaves:
            if not isinstance(v, torch.Tensor):
                refs.append(v)
                continue
            kind, feeds = self._kind(v, "return")
            refs.append(self._ref(v, kind, feeds))
        return refs, spec

    def _run_sub(self, outs, outer, args=()) -> list:
        """The sub-program's results (``outs``, from :meth:`_outputs`) on
        ``outer`` values and ``args``; a result that is not an op's output
        is a copy."""
        _, value = self._run_ops(list(self._leaves), outer, args)
        return [(value(r) if r.kind == "slot" else value(r).clone())
                if isinstance(r, _Ref) else r for r in outs]


def records(*values) -> bool:
    """Whether a program records now and ``values`` hold a tensor: then
    ``static.nn.cond`` / ``while_loop`` are recorded as one op."""
    return _recording() is not None and any(
        isinstance(v, torch.Tensor) for v in values)


def record_cond(pred, true_fn, false_fn, operands):
    """``static.nn.cond`` while a program records: each branch recorded as
    a sub-program, the branch one op whose replay calls ``cond`` with
    both (``cond`` chooses, or captures IF nodes)."""
    from . import nn as snn

    prog = _recording()
    subs = []
    for fn in (true_fn, false_fn):
        with prog._sub() as sub:
            refs, spec = sub._outputs(fn(*operands))
        subs.append((sub, refs, spec))
    (t, t_refs, spec), (f, f_refs, f_spec) = subs
    consts = [(a, b) for a, b in zip(t_refs, f_refs)
              if not isinstance(a, _Ref) or not isinstance(b, _Ref)]
    if spec != f_spec or any(not (isinstance(a, _Ref) and
                                  isinstance(b, _Ref)) and a != b
                             for a, b in consts):
        raise ValueError("static.nn.cond: the two branches return "
                         "different structures")
    n_t = len(t._outer)
    tensor_ix = [i for i, r in enumerate(t_refs) if isinstance(r, _Ref)]

    def branch(sub, refs, lo, hi):
        def run(*outer):
            res = sub._run_sub(refs, outer[lo:hi])
            return [res[i] for i in tensor_ix]
        return run

    n = n_t + len(f._outer)

    def replay(pred, *outer):
        return tuple(snn.cond(pred, branch(t, t_refs, 0, n_t),
                              branch(f, f_refs, n_t, n), operands=outer))

    outs = iter(prog._call("cond", replay, replay,
                           (pred, *t._outer, *f._outer), {}))
    leaves = [next(outs) if isinstance(r, _Ref) else r for r in t_refs]
    return pytree.tree_unflatten(leaves, spec)


def record_while(cond_fn, body_fn, loop_vars) -> list:
    """``static.nn.while_loop`` while a program records: the test and the
    body recorded as sub-programs of the tensor loop variables, the loop
    one op whose replay calls ``while_loop`` with them (Python on the CPU,
    a WHILE node in a capture).  Other loop variables are constants."""
    from . import nn as snn

    prog = _recording()
    vars_ = list(loop_vars)
    idx = [i for i, v in enumerate(vars_) if isinstance(v, torch.Tensor)]
    subs = []
    for fn in (cond_fn, body_fn):
        with prog._sub() as sub:
            cur = list(vars_)
            for i in idx:
                cur[i] = sub._arg(vars_[i])
            res = fn(*cur)
            if fn is body_fn:
                res = list(res) if isinstance(res, (tuple, list)) else [res]
                if len(res) != len(vars_):
                    raise ValueError(
                        f"while_loop: the body returns {len(res)} values "
                        f"for {len(vars_)} loop variables")
            refs, _ = sub._outputs(res)
        subs.append((sub, refs))
    (c, c_refs), (b, b_refs) = subs
    n_v, n_c = len(idx), len(c._outer)

    def replay(*vals):
        outer_c = vals[n_v:n_v + n_c]
        outer_b = vals[n_v + n_c:]

        def test(*v):
            return c._run_sub(c_refs, outer_c, [v[i] for i in idx])[0]

        def body(*v):
            return b._run_sub(b_refs, outer_b, [v[i] for i in idx])

        start = list(vars_)
        for j, i in enumerate(idx):
            start[i] = vals[j]
        out = snn.while_loop(test, body, start)
        return tuple(out[i] for i in idx)

    outs = prog._call("while_loop", replay, replay,
                      (*[vars_[i] for i in idx], *c._outer, *b._outer), {})
    result = list(vars_)
    for j, i in enumerate(idx):
        result[i] = outs[j]
    return result


_default_main = Program()
_default_startup = Program()
_current = {"main": _default_main, "startup": _default_startup}


def default_main_program() -> Program:
    return _current["main"]


def default_startup_program() -> Program:
    return _current["startup"]


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program=None):
    """Record into ``main_program`` inside (reference framework.py
    ``program_guard``); recording needs static mode on."""
    old = dict(_current)
    _current["main"] = main_program
    if startup_program is not None:
        _current["startup"] = startup_program
    try:
        yield
    finally:
        _current.update(old)


_SYM_SIZE_POOL = (61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113)


def _next_sym_size(prog: Program) -> int:
    # pool[0] is the shared batch dummy (data() below)
    for v in _SYM_SIZE_POOL[1:]:
        if v not in prog._sym_dummy:
            return v
    return _SYM_SIZE_POOL[
        1 + len(prog._sym_dummy) % (len(_SYM_SIZE_POOL) - 1)]


def data(name: str, shape, dtype=None, lod_level: int = 0) -> torch.Tensor:
    """A feed placeholder of the current program (reference
    ``static.data``): zeros on the current device, replaced by the feed of
    that name at :meth:`Executor.run`.  A ``None`` (or negative) dim records
    at a distinctive dummy size (every feed's first ``None`` axis at 61, so
    that two feeds' batch axes broadcast; later ones at 67, 71, ...) and may
    be fed at any size, unless an op baked it (module docstring)."""
    dt = _helpers.convert_dtype(dtype) or _helpers.get_default_dtype()
    prog = _current["main"]
    sym_axes = [i for i, s in enumerate(shape) if s is None or int(s) < 0]
    concrete, sym_val = [], {}
    for i, s in enumerate(shape):
        if i in sym_axes:
            v = _SYM_SIZE_POOL[0] if i == sym_axes[0] else \
                _next_sym_size(prog)
            sym_val[i] = v
            concrete.append(v)
        else:
            concrete.append(int(s))
    with no_record():
        t = torch.zeros(concrete, dtype=dt, device=current_device())
    prog._register_data(name, t, shape)
    if sym_axes:
        prog._sym_feeds[name] = sym_axes
        for v in sym_val.values():
            prog._sym_dummy.setdefault(v, []).append(name)
    return t


# -- scopes, places, executor ----------------------------------------------------

class Scope:
    """A name -> tensor table (reference ``framework Scope``)."""

    def __init__(self):
        self._vars: Dict[str, torch.Tensor] = {}

    def var(self, name: str) -> torch.Tensor:
        if name not in self._vars:
            self._vars[name] = torch.zeros((), device=current_device())
        return self._vars[name]

    def find_var(self, name: str) -> Optional[torch.Tensor]:
        return self._vars.get(name)


_scope = {"global": Scope()}


def global_scope() -> Scope:
    return _scope["global"]


@contextlib.contextmanager
def scope_guard(scope: Scope):
    old = _scope["global"]
    _scope["global"] = scope
    try:
        yield
    finally:
        _scope["global"] = old


def cpu_places(device_count: Optional[int] = None) -> List[CPUPlace]:
    return [CPUPlace() for _ in range(device_count or 1)]


def cuda_places(device_ids=None) -> List[CUDAPlace]:
    """The CUDA places (all cards by default); raises with no card."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("cuda_places: no CUDA device is available")
    ids = range(n) if device_ids is None else device_ids
    return [CUDAPlace(int(i)) for i in ids]


def _place_device(place) -> torch.device:
    if place is None:
        return current_device()
    if isinstance(place, (str, torch.device)):
        return torch.device(place)
    return place.device


class Executor:
    """Runs programs (reference ``fluid/executor.py:625``): ``run``
    substitutes the feeds into the recorded program and returns the
    fetched values (numpy arrays unless ``return_numpy=False``).  Fetch
    targets are tensors of the program or names.  ``place`` is the device a
    loaded inference program runs on (:func:`load_inference_model`); a
    recorded program runs where it was recorded."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy: bool = True, **kwargs):
        prog = program if program is not None else _current["main"]
        if isinstance(prog, CompiledProgram):
            prog = prog._program
        if isinstance(prog, _LoadedProgram):
            outs = prog.run(feed or {})
            picked = [outs[i] for i in (fetch_list
                                        if fetch_list is not None
                                        else range(len(outs)))]
        else:
            picked = prog._run(feed or {}, list(fetch_list or []))
        if return_numpy:
            return [o.detach().cpu().numpy() for o in picked]
        return list(picked)

    def close(self) -> None:
        pass


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None) -> torch.Tensor:
    dev = torch.device("cpu") if force_cpu else current_device()
    with no_record():
        return torch.full([int(s) for s in shape], value,
                          dtype=_helpers.convert_dtype(dtype), device=dev)


def _grads_op(n_targets: int):
    def grads(*ts):
        return tuple(torch.autograd.grad(
            list(ts[:n_targets]), list(ts[n_targets:]), allow_unused=True,
            retain_graph=True))
    return grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """The gradients of ``targets`` with respect to ``inputs`` (reference
    ``static.gradients``): while a program records, an op of it (the
    program then runs with autograd on, and the values returned are those
    of the placeholders' zeros); eagerly, ``torch.autograd.grad``."""
    targets = list(targets) if isinstance(targets, (list, tuple)) \
        else [targets]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is not None:
        raise NotImplementedError("gradients: target_gradients")
    prog = _recording()
    if prog is None:
        return list(torch.autograd.grad(targets, inputs, allow_unused=True,
                                        retain_graph=True))
    prog._needs_grad = True
    # the record-time values: the program so far, run with autograd on
    refs = [prog._locate(t) for t in targets + inputs]
    with no_record(), torch.enable_grad():
        lv = list(prog._leaves)
        for r in refs[len(targets):]:
            if r.kind == "leaf" and not lv[r.index].requires_grad:
                lv[r.index] = lv[r.index].detach().requires_grad_()
        _, value = prog._run_ops(lv)
        vals = [value(r) for r in refs]
        grads = _grads_op(len(targets))(*vals)
    fn = _grads_op(len(targets))
    out = list(prog._call("gradients", fn, lambda *a: grads,
                          tuple(targets + inputs), {}))
    return out


append_backward = gradients


def name_scope(prefix=None):
    return contextlib.nullcontext()


@contextlib.contextmanager
def device_guard(device=None):
    """Paddle's op placement for pipelines; ops here run where their
    tensors are (the JAX package's no-op)."""
    yield


class BuildStrategy:
    """Build knobs (reference ``BuildStrategy``): kept, not read."""

    def __init__(self):
        self.memory_optimize = None
        self.enable_inplace = None
        self.fuse_all_optimizer_ops = False
        self.fuse_elewise_add_act_ops = False


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10


class CompiledProgram:
    """The program as it is (reference ``compiler.py CompiledProgram``):
    its replay is already a CUDA graph on the card; ``with_data_parallel``
    returns it."""

    def __init__(self, program, build_strategy=None):
        self._program = program

    def with_data_parallel(self, *a, **k) -> "CompiledProgram":
        return self

    def __getattr__(self, name):
        return getattr(self._program, name)


ParallelExecutor = CompiledProgram


def _host_op(name: str, fn, xs):
    """``fn(*xs)`` as one op that runs on the host: refused inside a CUDA
    graph capture (``jit.CaptureError`` naming ``name``)."""
    def run(*ts):
        if any(isinstance(t, torch.Tensor) and t.is_cuda for t in ts) and \
                torch.cuda.is_current_stream_capturing():
            from ..jit import CaptureError

            raise CaptureError(
                f"{name}: runs Python on the host, which a CUDA graph "
                f"capture cannot hold; call it outside the to_static "
                f"program (or run the program on the CPU)")
        return fn(*ts)
    return _helpers.one_op(name, run, run, tuple(xs), {})


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """Print ``input`` at every run of the program (reference
    ``fluid.layers.Print``; eagerly, now); returns it.  A host read:
    refused inside a capture."""
    def show(t):
        if _depth(_BODY) and not _depth(_OFF):     # recording: no value yet
            return t.clone()
        parts = [message or ""]
        if print_tensor_shape:
            parts.append(f"shape={list(t.shape)}")
        if print_tensor_type:
            parts.append(f"dtype={t.dtype}")
        flat = t.detach().reshape(-1)
        parts.append(f"data={flat[:summarize].tolist()}")
        print(" ".join(p for p in parts if p))
        return t.clone()
    return _host_op("Print", show, [input])


class ExponentialMovingAverage:
    """EMA of parameters (reference ``fluid/optimizer.py``):
    ``update(parameters)`` after each step, ``apply()`` swaps the shadow
    weights in (and back on exit), ``restore()`` puts the live ones back."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = float(decay)
        self._shadow: Dict[int, torch.Tensor] = {}
        self._backup: Dict[int, torch.Tensor] = {}
        self._tracked: List[torch.Tensor] = []
        self._step = 0

    @torch.no_grad()
    def update(self, parameters=None) -> None:
        if parameters is None:
            raise ValueError("pass parameters=model.parameters()")
        self._step += 1
        # the bias-limited decay of the reference
        d = min(self._decay, (1 + self._step) / (10 + self._step))
        self._tracked = list(parameters)
        for p in self._tracked:
            prev = self._shadow.get(id(p))
            v = p.detach().float().clone()
            self._shadow[id(p)] = v if prev is None else d * prev + \
                (1 - d) * v

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore: bool = True):
        with torch.no_grad():
            for p in self._tracked:
                self._backup[id(p)] = p.detach().clone()
                p.copy_(self._shadow[id(p)].to(p.dtype))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None) -> None:
        for p in self._tracked:
            b = self._backup.pop(id(p), None)
            if b is not None:
                p.copy_(b)


def accuracy(input, label, k=1, correct=None, total=None):
    from ..metric import accuracy as _acc

    return _acc(input, label, k=k)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """``(auc, batch_auc, state)`` of :class:`..metric.Auc` over one batch
    (the three the same value, as in the JAX package)."""
    from ..metric import Auc

    m = Auc(curve=curve, num_thresholds=min(num_thresholds, 4095))
    preds = np.asarray(input.detach().cpu().numpy()
                       if isinstance(input, torch.Tensor) else input)
    if preds.ndim == 1 or preds.shape[-1] == 1:
        preds = np.stack([1 - preds.reshape(-1), preds.reshape(-1)], axis=1)
    m.update(preds, np.asarray(label.detach().cpu().numpy()
                               if isinstance(label, torch.Tensor)
                               else label))
    val = torch.tensor(float(m.accumulate()), dtype=torch.float32)
    return (val,) * 3


# -- inference models ------------------------------------------------------------

class _ProgramModule(torch.nn.Module):
    """A program's replay from ``feeds`` to ``fetch`` as a module: its
    leaves (parameters and constants) are the module's buffers, so
    ``jit.save`` exports a weight-free program of them."""

    def __init__(self, prog: Program, feed_names, fetch):
        super().__init__()
        object.__setattr__(self, "_prog", prog)
        self._feed_ix = [prog._feed_leaf[n] for n in feed_names]
        self._fetch = list(fetch)
        self._kept = [i for i in range(len(prog._leaves))
                      if i not in self._feed_ix]
        for i in self._kept:
            self.register_buffer(f"leaf_{i}", prog._leaves[i].detach())

    def forward(self, *feeds):
        lv = [None] * len(self._prog._leaves)
        for i in self._kept:
            lv[i] = getattr(self, f"leaf_{i}")
        for i, f in zip(self._feed_ix, feeds):
            lv[i] = f
        with no_record():
            _, value = self._prog._run_ops(lv)
            return tuple(value(r) for r in self._fetch)


class _LoadedProgram:
    """A loaded inference program: ``Executor.run(program, feed={name:
    array}, fetch_list=<the fetch targets load returned>)``."""

    def __init__(self, layer, feed_names, n_fetch):
        self._layer = layer
        self._feed_names = list(feed_names)
        self._n_fetch = n_fetch

    def run(self, feed: dict) -> list:
        missing = [n for n in self._feed_names if n not in feed]
        if missing:
            raise KeyError(f"feeds {missing} missing")
        out = self._layer(*[feed[n] for n in self._feed_names])
        return list(out) if isinstance(out, (list, tuple)) else [out]


def save_inference_model(path_prefix: str, feed_vars, fetch_vars,
                         executor=None, program=None, **kwargs) -> None:
    """Save the program from ``feed_vars`` to ``fetch_vars`` for
    deployment in the format of :func:`..jit.save`: a weight-free
    ``torch.export`` program (``.pdmodel``), its parameters and constants
    (``.pdiparams``, :mod:`..framework.io`'s format) and the sidecar
    (``.pdmeta.json``, with the feed names and the fetch count).  ``None``
    dims of the feeds' declared shapes export as symbolic dims."""
    from .. import jit

    prog = program or default_main_program()
    prog._finalize()
    feed_names = []
    for t in feed_vars:
        name = next((n for n, v in prog._feed_vars.items() if v is t), None)
        if name is None:
            raise KeyError("save_inference_model: a feed var was not "
                           "declared with static.data in this program")
        feed_names.append(name)
    fetch = [prog._locate(t) for t in fetch_vars]
    module = _ProgramModule(prog, feed_names, fetch)
    specs = [jit.InputSpec([None if s is None or int(s) < 0 else int(s)
                            for s in prog._declared_shapes[n]],
                           prog._feed_vars[n].dtype, name=n)
             for n in feed_names]
    with no_record():
        jit.save(module, path_prefix, input_spec=specs)
    with open(path_prefix + ".pdmeta.json") as f:
        meta = json.load(f)
    meta.update(feed_names=feed_names, n_fetch=len(fetch))
    with open(path_prefix + ".pdmeta.json", "w") as f:
        json.dump(meta, f, indent=1)


def load_inference_model(path_prefix: str, executor=None, device=None,
                         **kwargs):
    """``(program, feed_target_names, fetch_targets)``: run it with
    ``Executor.run(program, feed={...}, fetch_list=fetch_targets)``.  It
    runs on ``device``, else the executor's place, else the current device
    (the card unless the caller asks for the CPU).  A program the JAX
    package saved (serialized StableHLO) is refused, naming what it is."""
    from .. import jit

    dev = torch.device(device) if device is not None else \
        _place_device(getattr(executor, "place", None))
    with open(path_prefix + ".pdmodel", "rb") as f:
        head = f.read(2)
    if head != b"PK":
        raise ValueError(
            f"load_inference_model: {path_prefix}.pdmodel is not a "
            f"torch.export archive; the JAX package saves an inference "
            f"program as serialized StableHLO with a pickled feed/fetch "
            f"sidecar, which this package does not run")
    with open(path_prefix + ".pdmeta.json") as f:
        meta = json.load(f)
    layer = jit.load(path_prefix, device=dev)
    prog = _LoadedProgram(layer, meta["feed_names"], meta["n_fetch"])
    return prog, list(meta["feed_names"]), list(range(meta["n_fetch"]))


_FILES = (".pdmodel", ".pdiparams", ".pdmeta.json")


def serialize_program(feed_vars, fetch_vars, program=None, **kwargs
                      ) -> bytes:
    """The saved inference program (:func:`save_inference_model`) as
    bytes."""
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "m")
        save_inference_model(p, feed_vars, fetch_vars, program=program)
        blob = {}
        for ext in _FILES:
            with open(p + ext, "rb") as f:
                blob[ext] = f.read()
    return pickle.dumps(blob)


def deserialize_program(data: bytes) -> "_LoadedProgram":
    """A :func:`serialize_program` blob as a runnable program on the
    current device."""
    blob = pickle.loads(data)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "m")
        for ext in _FILES:
            with open(p + ext, "wb") as f:
                f.write(blob[ext])
        prog, _, _ = load_inference_model(p)
    return prog


# -- program state ----------------------------------------------------------------

def save_to_file(path: str, content: bytes) -> None:
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def save_program_state(dirname=None, program=None) -> Dict[int, np.ndarray]:
    """The program's leaves (placeholders, parameters, constants) as numpy
    arrays keyed by leaf index, in Paddle's layout (a Linear weight
    ``[in, out]``), the JAX package's format."""
    prog = program or default_main_program()
    prog._finalize()
    out = {}
    for i, t in enumerate(prog._leaves):
        a = t.detach().cpu().numpy()
        out[i] = a.T.copy() if i in prog._linear_weights else a
    return out


def set_program_state(program: Program, state: dict) -> None:
    """Load a :func:`save_program_state` dict, the port's or the JAX
    package's (its leaf order is the program's op order in both), into
    the program's leaves in place: a Linear weight comes in Paddle's
    ``[in, out]`` layout and is transposed to the port's."""
    program._finalize()
    with torch.no_grad(), no_record():
        for i, arr in state.items():
            if not isinstance(i, int) or i >= len(program._leaves):
                continue
            t = program._leaves[i]
            a = np.asarray(arr)
            if i in program._linear_weights:
                a = a.T
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(
                    f"set_program_state: leaf {i} has shape "
                    f"{tuple(t.shape)}, the state {tuple(a.shape)}")
            t.copy_(torch.tensor(a).to(t.dtype))


def load_program_state(state_or_dirname=None, var_list=None):
    """A state dict passes through (``save_program_state`` ->
    ``set_program_state``); a directory raises, as in the JAX package."""
    if isinstance(state_or_dirname, dict) or state_or_dirname is None:
        return state_or_dirname if state_or_dirname is not None \
            else save_program_state()
    raise NotImplementedError(
        "load_program_state from a directory is not supported: persist "
        "state with serialize_persistables/save_to_file and restore via "
        "deserialize_persistables, or pass the dict from "
        "save_program_state")


def serialize_persistables(feed_vars, fetch_vars, program=None) -> bytes:
    """The program's state (:func:`save_program_state`) as bytes."""
    return pickle.dumps(save_program_state(program=program or
                                           default_main_program()))


def deserialize_persistables(program: Program, data: bytes,
                             executor=None) -> None:
    set_program_state(program, pickle.loads(data))


def normalize_program(program, feed_vars, fetch_vars):
    """Reference: prune to the feed->fetch subgraph; a replay runs the
    recorded ops only, so the program is returned as it is."""
    return program


def py_func(func, x, out=None, backward_func=None,
            skip_vars_in_backward_input=None):
    """A host Python op (reference ``py_func``): ``func(*x)`` at every run,
    with ``backward_func(*x, *grads)`` as its gradient when given.  Refused
    inside a CUDA graph capture (``jit.CaptureError``)."""
    from ..autograd import PyLayer

    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    if backward_func is None:
        res = _host_op("py_func", func, xs)
        return res if res is not None else out

    class _PyFunc(PyLayer):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args)
            return func(*args)

        @staticmethod
        def backward(ctx, *grads):
            return backward_func(*ctx.saved_tensor(), *grads)

    return _host_op("py_func", lambda *a: _PyFunc.apply(*a), xs)


#: the reference's graph-mode tensor handle: the port's tensors play both
#: roles, so ``isinstance(x, static.Variable)`` holds for all of them
Variable = torch.Tensor


def xpu_places(device_ids=None):
    raise RuntimeError("xpu_places: no XPU devices in this build")


def npu_places(device_ids=None):
    raise RuntimeError("npu_places: no NPU devices in this build")


def mlu_places(device_ids=None):
    raise RuntimeError("mlu_places: no MLU devices in this build")


class IpuStrategy:
    def __init__(self, *a, **k):
        raise NotImplementedError("IPU support is not part of this build")


class IpuCompiledProgram:
    def __init__(self, *a, **k):
        raise NotImplementedError("IPU support is not part of this build")


def ipu_shard_guard(*a, **k):
    raise NotImplementedError("IPU support is not part of this build")


def set_ipu_shard(*a, **k):
    raise NotImplementedError("IPU support is not part of this build")
