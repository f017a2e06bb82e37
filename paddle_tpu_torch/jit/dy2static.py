"""Dygraph-to-static: Python control flow over tensors, rewritten into
calls of :mod:`..static.nn`'s ``cond`` and ``while_loop``.

The port's own copy of ``paddle_tpu/jit/dy2static.py`` (reference:
dygraph_to_static/program_translator.py:239, ifelse_transformer.py,
loop_transformer.py).  The AST transformers (the second half of this
module) are the JAX package's, rule for rule: each branch or loop body
becomes a local function whose parameters are the names it reads and
whose results are the names it assigns; a possibly unbound name is read
through ``ld`` and flows as an ``UndefinedVar``; ``return`` inside control
flow becomes a flag and a value with guarded tails, ``break``/``continue``
loop flags folded into the loop's test, ``and``/``or``/``not``, chained
comparisons and ternaries short-circuiting converter calls; a statement
that cannot be converted (``yield``, ``global``, a store into an attribute
inside a branch, a container mutated across a loop, ...) is left as
Python and recorded, so that the error a traced tensor raises there names
the construct and the user's line (``map_trace_error``).

The runtime converters (the first half) decide per call, by the value
they meet, as :mod:`..static.nn` does: a Python value, or a tensor the
host can read (the CPU, a program's eager first call on the card), runs
Python's own control flow; a tensor on a capturing CUDA stream lowers to
CUDA graph IF and WHILE nodes; a tensor under ``torch.export`` lowers to
``torch.cond`` / ``torch.while_loop``.  Where the JAX package unifies the
two branches' outputs from an abstract probe (``jax.eval_shape``), the
port reads them from the two bodies it captured (on the card) or from a
probe of each branch with the export's graph recording turned off.
"""
from __future__ import annotations

import ast
import contextlib
import functools
import inspect
import textwrap
import types
from typing import List, Optional, Set

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..static import nn as _snn

__all__ = ["convert_function", "convert_ifelse", "convert_while",
           "convert_range_loop", "convert_logical_and",
           "convert_logical_or", "convert_logical_not", "ld",
           "UndefinedVar", "Dy2StaticError", "map_trace_error"]


class Dy2StaticError(RuntimeError):
    """A Python construct could not be (or was not) converted to static
    control flow, and the failure is mapped back to the user's source
    (reference: dygraph_to_static/error.py, origin_info.py)."""


# conversion-time records of constructs the transformer left as plain
# Python: {file, line, end, construct, reason}.  Consulted when a traced
# tensor reaches one, to tell the user which statement was the wall.
_BAIL_RECORDS: List[dict] = []
_BAIL_KEYS: set = set()
_MAX_BAIL_RECORDS = 512


def _record_bail(filename: str, node: ast.stmt, construct: str, reason: str):
    key = (filename, getattr(node, "lineno", 0), construct)
    if key in _BAIL_KEYS:
        return
    if len(_BAIL_RECORDS) >= _MAX_BAIL_RECORDS:
        dropped = _BAIL_RECORDS[:_MAX_BAIL_RECORDS // 2]
        del _BAIL_RECORDS[:_MAX_BAIL_RECORDS // 2]
        for r in dropped:
            _BAIL_KEYS.discard((r["file"], r["line"], r["construct"]))
    _BAIL_KEYS.add(key)
    _BAIL_RECORDS.append({
        "file": filename,
        "line": getattr(node, "lineno", 0),
        "end": getattr(node, "end_lineno", getattr(node, "lineno", 0)),
        "construct": construct,
        "reason": reason,
    })


def _library_frame(f: str) -> bool:
    return ("/paddle_tpu_torch/" in f or "/torch/" in f
            or "/site-packages/" in f or "/dist-packages/" in f
            or f.startswith("<"))


def map_trace_error(exc):
    """A :class:`Dy2StaticError` naming the user's statement where a traced
    tensor (one under ``torch.export``, or on a capturing CUDA stream)
    reached unconverted Python control flow; None when no user frame is
    found (the caller re-raises the original)."""
    import traceback

    user = None
    for fr in traceback.extract_tb(exc.__traceback__):
        if not _library_frame(fr.filename):
            user = fr           # the deepest user frame
    if user is None:
        return None
    lines = [
        "tensor-dependent python control flow could not be compiled.",
        f"  at {user.filename}:{user.lineno}",
    ]
    if user.line:
        lines.append(f"    {user.line.strip()}")
    hits = [r for r in _BAIL_RECORDS
            if r["file"] == user.filename
            and r["line"] <= user.lineno <= r["end"]]
    for r in hits[-3:]:
        lines.append(
            f"  the `{r['construct']}` at {r['file']}:{r['line']} was left "
            f"as plain python because {r['reason']}; a traced Tensor "
            "reached it, which requires static conversion")
    if not hits:
        lines.append(
            "  a Tensor whose value is only known at run time was used "
            "where python needs a concrete bool/int (if/while/assert/"
            "index). Rewrite with paddle.static.nn.cond / while_loop, or "
            "move the data-dependent branch out of the @to_static "
            "function.")
    lines.append(f"  (original error: {type(exc).__name__}: "
                 f"{str(exc).splitlines()[0] if str(exc) else ''})")
    return Dy2StaticError("\n".join(lines))


def host_read_error(exc: BaseException) -> bool:
    """Whether ``exc`` is a traced tensor forced to a host value: a
    data-dependent guard under ``torch.export``, or a read on a capturing
    stream."""
    text = " ".join(str(x) for x in (exc, exc.__cause__, exc.__context__)
                    if x is not None).lower()
    return ("data-dependent" in text or "data dependent" in text
            or "captur" in text)


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

class UndefinedVar:
    """A name that was unbound when captured.  Any real use raises with
    the variable name (reference: dygraph_to_static UndefinedVar)."""

    __slots__ = ("name",)

    def __init__(self, name=""):
        self.name = name

    def _raise(self):
        raise NameError(
            f"variable '{self.name}' is not defined on every path through "
            "converted control flow (assigned in only one branch, or read "
            "before the loop ever ran)")

    def __bool__(self):
        self._raise()

    def __array__(self, *a, **k):
        self._raise()

    def __getattr__(self, item):
        if item == "name":
            raise AttributeError(item)
        self._raise()

    def __call__(self, *a, **k):
        self._raise()

    # implicit dunder lookup bypasses __getattr__ — name the common ones
    def _binop(self, *a, **k):
        self._raise()

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _binop
    __truediv__ = __rtruediv__ = __matmul__ = __rmatmul__ = _binop
    __lt__ = __le__ = __gt__ = __ge__ = __iter__ = __len__ = _binop
    __getitem__ = __neg__ = __abs__ = __float__ = __int__ = _binop

    def __repr__(self):
        return f"UndefinedVar({self.name!r})"


def ld(thunk, name=""):
    """Read a possibly-unbound outer variable."""
    try:
        return thunk()
    except (NameError, UnboundLocalError):
        return UndefinedVar(name)


_is_traced = _snn.traced

_SKIP_CALL_MODULES = ("paddle_tpu_torch", "torch", "numpy", "builtins",
                      "functools", "itertools", "operator", "np")


def _traced_scalar(v):
    return _is_traced(v) and tuple(v.shape) == ()


def _convert_minmax(builtin, fold):
    """``max(a, b, ...)``/``min`` with traced scalar tensor arguments:
    Python would ``bool()`` a comparison of them, so fold elementwise
    instead (exact for scalars).  Every other form keeps the builtin."""
    def wrapped(*args, **kwargs):
        if (not kwargs and len(args) >= 2
                and any(_traced_scalar(a) for a in args)
                and all(_arrayable(a) for a in args)
                and all(tuple(getattr(a, "shape", ())) == ()
                        for a in args)):
            acc = args[0]
            for a in args[1:]:
                acc = _logical_binop(fold, acc, a)
            return acc
        return builtin(*args, **kwargs)
    return wrapped


def convert_call(fn):
    """Convert plain user functions reached from converted code
    (reference: convert_call wrapping every call site).  Library code
    (this package, torch, numpy, builtins) is never touched; ``max`` and
    ``min`` map to exact scalar folds over traced tensors."""
    if fn is max:
        return _convert_minmax(max, torch.maximum)
    if fn is min:
        return _convert_minmax(min, torch.minimum)
    if _snn.in_dynamo():
        # inside a torch.cond / torch.while_loop body that dynamo traces:
        # it traces the helper as it is
        return fn
    try:
        if inspect.isfunction(fn) or inspect.ismethod(fn):
            target = fn.__func__ if inspect.ismethod(fn) else fn
            mod = getattr(target, "__module__", "") or ""
            if getattr(target, _CONVERTED_MARK, False):
                return fn
            if getattr(target, "_not_to_static", False):
                return fn
            if mod.split(".")[0] in _SKIP_CALL_MODULES:
                return fn
            return convert_function(fn)
    except Exception:
        pass
    return fn


# short alias used by generated code at every call site
cvt = convert_call


def _truthy(v):
    if isinstance(v, torch.Tensor):
        return bool(v.item())
    return bool(v)


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else _snn.scalar(v, like.device)


def _logical_binop(op, x, y):
    like = x if isinstance(x, torch.Tensor) else y
    return op(_as_tensor(x, like), _as_tensor(y, like))


def convert_logical_and(x_fn, y_fn):
    """``x and y``: a concrete x keeps Python's short-circuit and value
    semantics; a traced x evaluates both sides into ``logical_and``."""
    x = x_fn()
    if _is_traced(x):
        return _logical_binop(torch.logical_and, x, y_fn())
    if not _truthy(x):
        return x
    return y_fn()


def convert_logical_or(x_fn, y_fn):
    x = x_fn()
    if _is_traced(x):
        return _logical_binop(torch.logical_or, x, y_fn())
    if _truthy(x):
        return x
    return y_fn()


def convert_logical_not(x):
    if _is_traced(x):
        return torch.logical_not(x)
    return not x


_CHAIN_CMP_OPS = {
    "Lt": lambda a, b: a < b, "LtE": lambda a, b: a <= b,
    "Gt": lambda a, b: a > b, "GtE": lambda a, b: a >= b,
    "Eq": lambda a, b: a == b, "NotEq": lambda a, b: a != b,
    "Is": lambda a, b: a is b, "IsNot": lambda a, b: a is not b,
    "In": lambda a, b: a in b, "NotIn": lambda a, b: a not in b,
}


def convert_chain_compare(left_fn, *pairs):
    """``a OP1 b OP2 c ...`` with Python's evaluation contract: each
    operand evaluates at most once, later ones are skipped after a
    concrete false comparison (whose value is returned); traced
    comparisons fold with ``logical_and``."""
    val = left_fn()
    acc = None
    for op, rhs_fn in pairs:
        rhs = rhs_fn()
        cmp = _CHAIN_CMP_OPS[op](val, rhs)
        if acc is None:
            acc = cmp
        elif _is_traced(acc) or _is_traced(cmp):
            acc = _logical_binop(torch.logical_and, acc, cmp)
        else:
            acc = cmp
        if not _is_traced(acc) and not _truthy(acc):
            return acc
        val = rhs
    return acc


def convert_ifexp(pred, t_fn, f_fn):
    """``a if pred else b``: through the same branch unification as a
    statement ``if``."""
    out = convert_ifelse(pred, lambda: (t_fn(),), lambda: (f_fn(),),
                         operands=(), names=("<ternary>",))
    return out[0]


class _RetNone:
    """Marks an explicit bare ``return`` / ``return None`` in a converted
    function, told apart from "value never assigned" (plain None)."""

    __slots__ = ()

    def __repr__(self):
        return "<bare return>"


RET_NONE = _RetNone()


def ret_unwrap(val):
    return None if isinstance(val, _RetNone) else val


def ret_value(flag, val):
    """Final return of a converted function with a fall-through path:
    ``val if returned else None``.  A traced flag cannot choose between a
    tensor and None in one program: raise instead."""
    if _is_traced(flag):
        raise Dy2StaticError(
            "this function returns a value on some paths but falls off "
            "the end (implicit `return None`) on others, and the choice "
            "depends on a traced Tensor; a compiled program needs one "
            "return structure — add an explicit `return` to the "
            "fall-through path")
    return ret_unwrap(val) if _truthy(flag) else None


# generated flag/value variables (return flags, break/continue flags, loop
# indices): the one name family for which a branch that does not bind the
# variable may be filled with a typed placeholder, its reads being guarded
# by the paired flag
_GEN_PREFIX = "__jstf_"


def _flat(v):
    return pytree.tree_flatten(v)


def convert_ifelse(pred, true_fn, false_fn, operands=(), names=None,
                   guard=False):
    """``if pred: ... else: ...`` with assigned-name outputs.

    A concrete pred runs the taken branch as Python (through
    ``static.nn.cond``, which on the card warms the other).  A traced pred
    unifies the two branches' outputs per assigned name (placeholder zeros
    for generated flag/value names missing on one side, dtype promotion
    and broadcasting, equal non-tensor constants passed through, a named
    error for a user name bound in one branch only) and lowers to IF nodes
    (captured) or ``torch.cond`` (exported)."""
    if not _is_traced(pred):
        out = _snn.cond(pred, true_fn, false_fn, operands)
        return out if isinstance(out, tuple) else (out,)
    if _snn.in_dynamo():
        return _inline_ifelse(pred, true_fn, false_fn, operands, names,
                              guard)
    if _snn.exporting(pred):
        return _export_ifelse(pred, true_fn, false_fn, operands, names,
                              guard)
    holder = {}

    def unify(t, f):
        t = tuple(t) if isinstance(t, (tuple, list)) else (t,)
        f = tuple(f) if isinstance(f, (tuple, list)) else (f,)
        nm = _names(names, len(t))
        plans = [_unify_slot(t[i], f[i], nm[i], guard) for i in range(len(t))]
        holder["plans"] = plans
        return (_tree_leaves(t, plans, 0, pred.device),
                _tree_leaves(f, plans, 1, pred.device))

    leaves = _snn._captured_cond(pred, true_fn, false_fn, operands,
                                 unify=unify)
    return _reassemble(holder["plans"], leaves)


def _names(names, n):
    return list(names) if names is not None else [f"<out {i}>"
                                                  for i in range(n)]


def _tree_leaves(outs, plans, side: int, device, zeros=None
                 ) -> List[torch.Tensor]:
    """The tensor leaves of the "tree" slots of one branch (``side`` 0 the
    true one, 1 the false), each cast and broadcast to its slot's unified
    (shape, dtype); a missing side reads as zeros (``zeros``: one tensor
    per leaf made outside the branch, whose clone stands in; else made
    here).  Whether a leaf needs a broadcast was decided with the plan, so
    a branch traced by ``torch.cond`` reads no size of the probe.  A leaf
    that is a Python value on both sides goes to ``device`` (the
    predicate's)."""
    res = []
    k = 0
    for v, plan in zip(outs, plans):
        if plan[0] != "tree":
            continue
        _, treedef, specs, missing = plan
        if missing[side]:
            for sh, dt, dev, _ in specs:
                res.append(zeros[k].clone() if zeros is not None
                           else torch.zeros(sh, dtype=dt,
                                            device=dev or device))
                k += 1
            continue
        for lv, (sh, dt, dev, bcast) in zip(_flat(v)[0], specs):
            a = lv if isinstance(lv, torch.Tensor) else _snn.scalar(
                lv, dev or device)
            if a.dtype != dt:
                a = a.to(dt)
            if bcast[side]:
                a = torch.broadcast_to(a, sh)
            res.append(a)
            k += 1
    return res


def _reassemble(plans, leaves) -> tuple:
    full, k = [], 0
    for plan in plans:
        if plan[0] == "tree":
            _, treedef, specs, _ = plan
            full.append(pytree.tree_unflatten(list(leaves[k:k + len(specs)]),
                                              treedef))
            k += len(specs)
        else:
            full.append(plan[1])
    return tuple(full)


@contextlib.contextmanager
def _unrecorded():
    """Run Python under an export without recording into its graph: the
    fake tensors still carry shapes and dtypes."""
    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

    with disable_proxy_modes_tracing(), torch.no_grad():
        yield


def _probe_branch(fn, operands):
    """A branch's raw outputs under an export, unrecorded."""
    with _unrecorded():
        out = fn(*operands)
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _export_ifelse(pred, true_fn, false_fn, operands, names, guard):
    t_raw = _probe_branch(true_fn, operands)
    f_raw = _probe_branch(false_fn, operands)
    nm = _names(names, len(t_raw))
    plans = [_unify_slot(t_raw[i], f_raw[i], nm[i], guard)
             for i in range(len(t_raw))]
    if not any(p[0] == "tree" for p in plans):
        return _reassemble(plans, [])
    # a missing side's zeros are made outside torch.cond and passed in: a
    # size made inside a branch from the probe's symbols would be lifted
    # into the branch twice
    dev = pred.device
    zeros = [torch.zeros(sh, dtype=dt, device=d or dev)
             for p in plans if p[0] == "tree" for sh, dt, d, _ in p[2]]
    n_ops = len(operands)

    def wrap(fn, side):
        def g(*args):
            out = fn(*args[:n_ops])
            out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
            return tuple(_tree_leaves(out, plans, side, dev, args[n_ops:]))
        return g

    leaves = _snn._export_cond(pred, wrap(true_fn, 0), wrap(false_fn, 1),
                               tuple(operands) + tuple(zeros))
    return _reassemble(plans, list(leaves))


def _inline_ifelse(pred, true_fn, false_fn, operands, names, guard):
    """A branch nested in a ``torch.cond`` branch or ``torch.while_loop``
    body, which torch's dynamo traces: both sides are computed and
    selected with ``torch.where`` (a converted branch binds names and
    stores into no object, so computing the untaken side changes
    nothing but the work)."""
    t = true_fn(*operands)
    f = false_fn(*operands)
    t = tuple(t) if isinstance(t, (tuple, list)) else (t,)
    f = tuple(f) if isinstance(f, (tuple, list)) else (f,)
    nm = _names(names, len(t))
    plans = [_unify_slot(t[i], f[i], nm[i], guard) for i in range(len(t))]
    p = _snn._as_pred(pred)
    leaves = [torch.where(p, a, b) for a, b in
              zip(_tree_leaves(t, plans, 0, p.device),
                  _tree_leaves(f, plans, 1, p.device))]
    return _reassemble(plans, leaves)


def _is_missing(v):
    return v is None or isinstance(v, UndefinedVar)


def _unify_slot(t, f, name, guard=False):
    """Decide how one assigned name flows through a traced ``if``: returns
    ``("tree", treedef, [(shape, dtype, device), ...])`` for values
    selected by the predicate, or ``("const", value)`` for values kept
    outside it.  ``guard`` marks a return-flag tail guard, on whose
    flag-set path every variable first assigned there is dead."""
    # "missing" = unbound (an UndefinedVar from an ld miss).  An explicit
    # None binding is a value for user variables; only the generated
    # return-value slots (and names inside a return guard) treat None as
    # the machinery's placeholder
    def missing(v):
        if isinstance(v, UndefinedVar):
            return True
        return v is None and (guard or name.startswith(_GEN_PREFIX))

    t_missing, f_missing = missing(t), missing(f)
    if (t is None) != (f is None) and not (t_missing or f_missing):
        other = f if t is None else t
        if not _is_traced(other) and not isinstance(other, torch.Tensor):
            raise Dy2StaticError(
                f"variable '{name}' is None on one path and a "
                f"non-tensor value ({type(other).__name__}) on the "
                "other of a converted `if` over a traced Tensor; a "
                "compiled branch cannot select between python objects "
                "— use tensor values on both paths")
        raise Dy2StaticError(
            f"variable '{name}' is None on one path of a converted "
            "`if` over a traced Tensor and a tensor on the other; "
            "assign a correctly-typed tensor default before the `if` "
            "instead of None")
    if isinstance(t, _RetNone) or isinstance(f, _RetNone):
        other = f if isinstance(t, _RetNone) else t
        if isinstance(other, _RetNone) or _is_missing(other):
            return ("const", RET_NONE)
        raise Dy2StaticError(
            "this function returns a value on one path and bare "
            "`return`/None on another inside a traced `if`; a compiled "
            "program needs one return structure — return a tensor on "
            "every path")
    if t_missing and f_missing:
        return ("const", t if t is not None else f)
    if t_missing or f_missing:
        present = f if t_missing else t
        leaves, treedef = _flat(present)
        # a concrete value bound in one branch only passes through as a
        # constant (branch-local temporaries)
        if not any(_is_traced(lv) for lv in leaves):
            return ("const", present)
        if guard or (name.startswith(_GEN_PREFIX)
                     and all(_arrayable(lv) for lv in leaves)):
            if any(not _arrayable(lv) for lv in leaves):
                return ("const", present)
            return ("tree", treedef, [(*_aval_of(lv), (False, False))
                                      for lv in leaves],
                    (t_missing, f_missing))
        raise Dy2StaticError(
            f"variable '{name}' is assigned a traced value in only one "
            "branch of an `if` whose condition is a traced Tensor; under "
            "static conversion both branches must bind it — assign a "
            "default before the `if`")
    t_leaves, t_def = _flat(t)
    f_leaves, f_def = _flat(f)
    if t_def != f_def:
        raise Dy2StaticError(
            f"variable '{name}' has mismatched structures across the two "
            f"branches of a converted `if` ({t_def} vs {f_def}); both "
            "branches must produce the same nesting of values")
    if all(not _arrayable(lv) for lv in t_leaves + f_leaves):
        if _const_equal(t, f):
            return ("const", t)
        raise Dy2StaticError(
            f"variable '{name}' is bound to different non-tensor python "
            f"values in the two branches of a converted `if` "
            f"({t!r} vs {f!r}); a traced condition can only select "
            "tensor values")
    specs = []
    for tl, fl in zip(t_leaves, f_leaves):
        if not (_arrayable(tl) and _arrayable(fl)):
            raise Dy2StaticError(
                f"variable '{name}' mixes tensor and non-tensor values "
                "across the branches of a converted `if`; both branches "
                "must produce tensors (or equal python constants)")
        tsh, tdt, tdev = _aval_of(tl)
        fsh, fdt, fdev = _aval_of(fl)
        sh = _broadcast_shapes(tsh, fsh, name)
        specs.append((sh, torch.promote_types(tdt, fdt),
                      tdev if isinstance(tl, torch.Tensor) else fdev,
                      (tuple(tsh) != sh, tuple(fsh) != sh)))
    return ("tree", t_def, specs, (False, False))


def _arrayable(v):
    return isinstance(v, (torch.Tensor, bool, int, float, np.ndarray,
                          np.generic))


def _aval_of(v):
    """(shape, dtype, device) of a tensor, or of a Python/numpy scalar as
    ``torch.as_tensor`` would make it."""
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), v.dtype, v.device
    a = torch.as_tensor(v)
    return tuple(a.shape), a.dtype, None


def _broadcast_shapes(a, b, name):
    try:
        return tuple(torch.broadcast_shapes(tuple(a), tuple(b)))
    except Exception:
        raise Dy2StaticError(
            f"variable '{name}' has incompatible shapes across the two "
            f"branches of a converted `if` ({a} vs {b})")


def _const_equal(a, b):
    if a is b:
        return True
    try:
        return bool(a == b)
    except Exception:
        return False


def _check_loop_carry(names, vars_, probe):
    """A tensor-dependent loop carries a fixed structure: a variable that
    enters unbound (or None) and leaves the body a tensor cannot be
    carried; the generated return-value slot (``__jstf_val_*``) and the
    for-range shadow target (``__jstf_tgt_*``) are dead until their flag
    is set, so they get placeholders of the probed shape and dtype, and
    any other such name raises, named.  ``probe()`` gives the body's
    outputs (unrecorded, under an export); a probe that fails is ignored
    (the real trace names its error)."""
    if names is None:
        return vars_
    missing = [i for i, v in enumerate(vars_) if _is_missing(v)]
    if not missing:
        return vars_
    try:
        outs = probe()
    except Exception:
        return vars_
    vars_ = list(vars_)
    for i in missing:
        if i < len(outs) and isinstance(outs[i], torch.Tensor):
            nm = names[i]
            if nm.startswith((_GEN_PREFIX + "val", _GEN_PREFIX + "tgt")):
                o = outs[i]         # the probe's: made again, recorded
                vars_[i] = torch.zeros(o.shape, dtype=o.dtype,
                                       device=o.device)
                continue
            raise Dy2StaticError(_loop_carry_message(nm))
    return vars_


def _loop_carry_message(nm: str) -> str:
    return (f"loop variable '{nm}' enters a tensor-dependent loop "
            "unbound (or None) but is assigned a Tensor inside the "
            "body; initialize it with a correctly-shaped tensor "
            "before the loop so the compiled loop can carry it")


def _lower_while(cond_fn, body_fn, vars_, names, device_like):
    """The loop over traced state: a WHILE node on a capturing stream,
    ``torch.while_loop`` under an export."""
    vars_ = list(vars_)
    if _snn.exporting(device_like):
        vars_ = _snn._promote(vars_, device_like.device)
        if not _snn.in_dynamo():
            vars_ = _check_loop_carry(
                names, vars_, lambda: _probe_branch(body_fn, vars_))
        return tuple(_snn._export_while(cond_fn, body_fn, vars_))

    def fill(i, r):
        nm = names[i] if names is not None else f"<var {i}>"
        if nm.startswith((_GEN_PREFIX + "val", _GEN_PREFIX + "tgt")):
            return torch.empty_like(r)
        raise Dy2StaticError(_loop_carry_message(nm))

    return tuple(_snn.captured_while(cond_fn, body_fn, vars_, fill=fill))


def _first_traced(*vs):
    for v in vs:
        if _is_traced(v):
            return v
    return None


def convert_while(cond_fn, body_fn, init_vars, names=None):
    """``while cond: body`` over the body's assigned names.  The Python
    loop runs, evaluating the test once a trip (Python's count), for as
    long as the test is concrete; the moment it comes back traced, the
    current state goes to the lowered loop and the completed trips stay
    applied.  (The JAX package also lowers a loop whose test is concrete
    once any loop variable is traced; here such a loop unrolls, as a
    Python loop over a traced body does under ``jax.jit``: the trip count
    does not depend on a traced value, so the result is the same.)"""
    vars_ = list(init_vars)
    while True:
        test = cond_fn(*vars_)
        if _is_traced(test):
            return _lower_while(cond_fn, body_fn, vars_, names, test)
        if not _truthy(test):
            return tuple(vars_)
        res = body_fn(*vars_)
        vars_ = list(res) if isinstance(res, (tuple, list)) else [res]


def convert_range_loop(start, stop, step, body_fn, init_vars, names=None,
                       target_init=None):
    """``for i in range(start, stop, step): body`` — ``body_fn(i, *vars)
    -> vars``.  Returns ``(final_target, *vars)``: Python leaves the target
    bound to the last iterated value.  Concrete bounds run the Python loop;
    traced bounds lower to a loop carrying the index as a tensor."""
    traced_b = _first_traced(start, stop, step)
    if traced_b is None:
        vars_ = tuple(init_vars)
        tgt = target_init
        s0, s1, st = (int(b.item() if isinstance(b, torch.Tensor) else b)
                      for b in (start, stop, step))
        for i in range(s0, s1, st):
            tgt = i
            vars_ = body_fn(i, *vars_)
        return (tgt,) + tuple(vars_)

    dev = traced_b.device
    idt = traced_b.dtype if not traced_b.is_floating_point() else torch.int64
    start_t, stop_t, step_t = (b if isinstance(b, torch.Tensor)
                               else _snn.scalar(b, dev, idt)
                               for b in (start, stop, step))
    if _snn.exporting(traced_b):
        # probe with a traced index: anything assigned from it comes out
        # traced, which a concrete probe index would under-report
        init_vars = _check_loop_carry(
            names, list(init_vars),
            lambda: _probe_branch(body_fn, [start_t] + list(init_vars)))

    def _cond(i, *vars_):
        return torch.where(step_t > 0, i < stop_t, i > stop_t)

    def _body(i, *vars_):
        new = body_fn(i, *vars_)
        new = new if isinstance(new, tuple) else (new,)
        return (i + step_t,) + tuple(new)

    body_names = None if names is None else ("<index>",) + tuple(names)
    out = _lower_while(_cond, _body, [start_t] + list(init_vars),
                       body_names, traced_b)
    # the carried index overshoots by one step; Python's final target is
    # the last in-range value, or the pre-loop binding when the loop ran
    # zero times (when that binding is not a number, the corrected value
    # stands in: Python would have left the name unbound)
    ran = torch.where(step_t > 0, start_t < stop_t, start_t > stop_t)
    last = out[0] - step_t
    if target_init is not None and not isinstance(target_init, UndefinedVar):
        try:
            ti = (target_init if isinstance(target_init, torch.Tensor)
                  else _snn.scalar(target_init, dev)).to(last.dtype)
            last = torch.where(ran, last, ti)
        except Exception:
            pass
    return (last,) + tuple(out[1:])


# ---------------------------------------------------------------------------
# AST analysis
# ---------------------------------------------------------------------------

_SCOPE_BARRIERS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
_BAIL_NODES = (ast.Return, ast.Break, ast.Continue, ast.Global,
               ast.Nonlocal, ast.Delete, ast.Yield, ast.YieldFrom,
               ast.Await)


def _walk_scope(node):
    """ast.walk that does not descend into nested function/class defs
    (their bodies are separate scopes), but does cover lambdas and
    comprehensions (their reads matter for capture)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, _SCOPE_BARRIERS):
            stack.extend(ast.iter_child_nodes(n))


def _walk_stmt(s):
    """The statement itself plus its same-scope subtree (if the statement
    IS a def, its body is a separate scope and is not entered)."""
    yield s
    if not isinstance(s, _SCOPE_BARRIERS):
        yield from _walk_scope(s)


def _nonname_store(n) -> bool:
    """Assignments into attributes/subscripts are object mutations whose
    effects would silently vanish inside a traced branch — bail."""
    tgts = []
    if isinstance(n, ast.Assign):
        tgts = n.targets
    elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
        tgts = [n.target]

    def bad(t):
        if isinstance(t, (ast.Attribute, ast.Subscript, ast.Starred)):
            return not isinstance(t, ast.Starred) or bad(t.value)
        if isinstance(t, (ast.Tuple, ast.List)):
            return any(bad(e) for e in t.elts)
        return False

    return any(bad(t) for t in tgts)


_BAIL_KEYWORD = {
    ast.Return: "return", ast.Break: "break", ast.Continue: "continue",
    ast.Global: "global", ast.Nonlocal: "nonlocal", ast.Delete: "del",
    ast.Yield: "yield", ast.YieldFrom: "yield from", ast.Await: "await",
}


# container-mutation methods that cannot cross a compiled region.
# `add`/`sort`/`reverse` are deliberately absent: they collide with
# (out-of-place) Tensor methods and would false-positive on `t.add(y)`
_MUTATING_METHODS = frozenset({
    "append", "extend", "insert", "pop", "remove", "clear", "update",
    "setdefault", "discard", "popitem"})


def _mutation_receiver(n):
    """(root_name, dotted_receiver) when `n` is a mutating method call on
    a name or attribute chain (buf.append / self.log.append), else
    None."""
    if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr in _MUTATING_METHODS):
        return None
    parts = []
    root = n.func.value
    while isinstance(root, ast.Attribute):
        parts.append(root.attr)
        root = root.value
    if not isinstance(root, ast.Name):
        return None
    parts.append(root.id)
    return root.id, ".".join(reversed(parts))


def _bail_reason(stmts) -> Optional[str]:
    """Why this statement region cannot become a branch/loop-body
    function — None when it can."""
    assigned = _assigned_names(stmts)
    for s in stmts:
        for n in _walk_stmt(s):
            if _nonname_store(n):
                return ("it assigns into an attribute/subscript (object "
                        "mutation cannot cross a compiled branch)")
            # list.append(...) etc. on a container from OUTSIDE the
            # region (bare name or attribute chain like self.log): under
            # tracing the call would run trace-count times (once per
            # branch / once per loop), not run-count times — silently
            # wrong sizes.  A container CREATED in the region is
            # trace-local and fine.
            recv = _mutation_receiver(n)
            if recv is not None and recv[0] not in assigned:
                return (f"it mutates `{recv[1]}` in place via "
                        f".{n.func.attr}() — a python container cannot "
                        "carry through a compiled branch/loop; collect "
                        "into a Tensor instead")
            if isinstance(n, _BAIL_NODES):
                # break/continue inside a NESTED loop are that loop's
                # business, not ours
                if isinstance(n, (ast.Break, ast.Continue)):
                    if _inside_nested_loop(s, n):
                        continue
                kw = _BAIL_KEYWORD.get(type(n), type(n).__name__)
                return f"it contains `{kw}`"
    return None


def _inside_nested_loop(root_stmt, node) -> bool:
    """True if `node` sits under a For/While that is itself inside
    root_stmt (so the break/continue does not escape the converted
    region)."""
    # collect all loop subtrees strictly inside root_stmt
    for n in _walk_scope(root_stmt):
        if isinstance(n, (ast.For, ast.While)):
            for m in [n] + list(_walk_scope(n)):
                if m is node:
                    return True
    return False


def _assigned_names(stmts) -> Set[str]:
    names: Set[str] = set()

    def targets_of(t):
        if isinstance(t, ast.Name):
            names.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                targets_of(e)
        elif isinstance(t, ast.Starred):
            targets_of(t.value)

    for s in stmts:
        for n in _walk_stmt(s):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    targets_of(t)
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets_of(n.target)
            elif isinstance(n, ast.For):
                targets_of(n.target)
            elif isinstance(n, ast.withitem) and n.optional_vars:
                targets_of(n.optional_vars)
            elif isinstance(n, ast.NamedExpr):
                targets_of(n.target)
            elif isinstance(n, _SCOPE_BARRIERS):
                names.add(n.name)
    # generated helpers are locals of their own region, and function/class
    # defs cannot cross a compiled branch as outputs
    return {n for n in names if not n.startswith("__jst_")}


def _is_converted_unpack(n) -> bool:
    """An Assign generated by an earlier (innermost-first) conversion:
    ``b, = _jst.convert_ifelse(...)`` / ``convert_while`` / range-loop."""
    return (isinstance(n, ast.Assign)
            and isinstance(n.value, ast.Call)
            and isinstance(n.value.func, ast.Attribute)
            and n.value.func.attr.startswith("convert_")
            and isinstance(n.value.func.value, ast.Name)
            and n.value.func.value.id == "_jst")


def _loaded_names(stmts) -> Set[str]:
    loads: Set[str] = set()
    for s in stmts:
        for n in _walk_stmt(s):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                loads.add(n.id)
            elif isinstance(n, ast.AugAssign) and \
                    isinstance(n.target, ast.Name):
                # `y += 2` reads y even though the AST marks the target
                # Store-only; missing it made the generated branch
                # function treat y as an uninitialized local
                # (UnboundLocalError at call time)
                loads.add(n.target.id)
            elif _is_converted_unpack(n):
                # outputs of an inner converted construct READ their
                # pre-value on the untaken/zero-trip side — but the read
                # sits inside the generated branch funcdefs, which are
                # scope barriers this walk rightly skips.  Count the
                # targets as reads so an enclosing conversion passes the
                # pre-value in as a parameter (else python shadows it
                # and the inner thunk sees an unbound local).
                loads.update(_assigned_names([n]))
    return {n for n in loads if not n.startswith("__jst_")}


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------

def _name(id_, ctx=None):
    return ast.Name(id=id_, ctx=ctx or ast.Load())


def _jst_attr(fn_name):
    return ast.Attribute(value=_name("_jst"), attr=fn_name, ctx=ast.Load())


def _ld_expr(var: str):
    """_jst.ld(lambda: var, 'var')"""
    lam = ast.Lambda(
        args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                           kw_defaults=[], defaults=[]),
        body=_name(var))
    return ast.Call(func=_jst_attr("ld"),
                    args=[lam, ast.Constant(var)], keywords=[])


def _branch_funcdef(fname: str, params: List[str], body: List[ast.stmt],
                    out_names: List[str]) -> ast.FunctionDef:
    ret = ast.Return(value=ast.Tuple(
        elts=[_ld_expr(n) for n in out_names], ctx=ast.Load()))
    return ast.FunctionDef(
        name=fname,
        args=ast.arguments(
            posonlyargs=[],
            args=[ast.arg(arg=p) for p in params],
            kwonlyargs=[], kw_defaults=[], defaults=[]),
        body=(body or [ast.Pass()]) + [ret],
        decorator_list=[])


def _unpack_assign(out_names: List[str], value: ast.expr) -> ast.stmt:
    tgt = ast.Tuple(elts=[_name(n, ast.Store()) for n in out_names],
                    ctx=ast.Store())
    return ast.Assign(targets=[tgt], value=value)


def _assign(name: str, value: ast.expr) -> ast.stmt:
    return ast.Assign(targets=[_name(name, ast.Store())], value=value)


def _lambda0(body: ast.expr) -> ast.expr:
    return ast.Lambda(
        args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                           kw_defaults=[], defaults=[]),
        body=body)


def _not(e: ast.expr) -> ast.expr:
    return ast.UnaryOp(op=ast.Not(), operand=e)


def _contains_return(s) -> bool:
    return any(isinstance(n, ast.Return) for n in _walk_stmt(s))


def _always_returns(stmts) -> bool:
    """Conservative terminal-path analysis: True when every way out of
    this statement list is a `return` or `raise` (loops are assumed
    skippable, so they never count — EXCEPT ``while True`` without a
    break, which python can only leave by returning/raising)."""
    for s in stmts:
        if isinstance(s, (ast.Return, ast.Raise)):
            return True
        if isinstance(s, ast.If) and s.orelse:
            if _always_returns(s.body) and _always_returns(s.orelse):
                return True
        if (isinstance(s, ast.While) and isinstance(s.test, ast.Constant)
                and s.test.value and not s.orelse
                and not _owned_bc(s.body)[0]):
            return True
    return False


class _ReturnTransformer:
    """Rewrite `return` inside control flow into a flag + value pair with
    guarded tails (reference return_transformer.py:136,
    early_return_transformer.py).  Inside a loop the flag set is followed
    by `break` (consumed by _BreakContinueTransformer); after a nested
    construct that may have returned, `if flag: break` (in a loop) or an
    `if not flag:` tail guard (outside) keeps later statements from
    running."""

    def __init__(self, uid: int):
        self.flag = f"{_GEN_PREFIX}ret_{uid}"
        self.val = f"{_GEN_PREFIX}val_{uid}"
        self.applied = False

    def run(self, fdef):
        if not any(isinstance(s, (ast.If, ast.While, ast.For))
                   and _contains_return(s) for s in fdef.body):
            return
        always = _always_returns(fdef.body)
        self.applied = True
        body, _may = self._block(list(fdef.body), in_loop=False)
        if always:
            # every path returns → the flag is True at the end and the
            # value is always well-defined (unwrap a bare-return marker)
            tail = ast.Return(value=ast.Call(
                func=_jst_attr("ret_unwrap"), args=[_name(self.val)],
                keywords=[]))
        else:
            # fall-through possible → `val if flag else None`, with a
            # clear error when the flag itself is traced (mixed
            # tensor/None return structure cannot compile)
            tail = ast.Return(value=ast.Call(
                func=_jst_attr("ret_value"),
                args=[_name(self.flag), _name(self.val)], keywords=[]))
        fdef.body = [
            _assign(self.flag, ast.Constant(False)),
            _assign(self.val, ast.Constant(None)),
        ] + body + [tail]

    def _block(self, stmts, in_loop):
        out: List[ast.stmt] = []
        for i, s in enumerate(stmts):
            if isinstance(s, ast.Return):
                out.append(_assign(self.flag, ast.Constant(True)))
                # bare `return` / `return None` stores the RET_NONE
                # sentinel, NOT None — plain None means "never assigned"
                # to the branch unifier
                bare = s.value is None or (
                    isinstance(s.value, ast.Constant)
                    and s.value.value is None)
                out.append(_assign(
                    self.val,
                    _jst_attr("RET_NONE") if bare else s.value))
                if in_loop:
                    out.append(ast.Break())
                return out, True           # rest is unreachable
            if isinstance(s, (ast.If, ast.While, ast.For)) and \
                    _contains_return(s):
                s, smay = self._compound(s, in_loop)
                out.append(s)
                if smay:
                    rest, _ = self._block(list(stmts[i + 1:]), in_loop)
                    if in_loop:
                        # a set flag must also exit this (enclosing) loop
                        out.append(ast.If(test=_name(self.flag),
                                          body=[ast.Break()], orelse=[]))
                        out.extend(rest)
                    elif rest:
                        out.append(ast.If(test=_not(_name(self.flag)),
                                          body=rest, orelse=[]))
                    return out, True
                continue
            out.append(s)
        return out, False

    def _compound(self, s, in_loop):
        if isinstance(s, ast.If):
            b, m1 = self._block(list(s.body), in_loop)
            o, m2 = self._block(list(s.orelse), in_loop)
            s.body = b or [ast.Pass()]
            s.orelse = o
            return s, m1 or m2
        # While / For: returns in the body exit via the injected break
        b, m = self._block(list(s.body), in_loop=True)
        s.body = b or [ast.Pass()]
        if s.orelse:
            o, m2 = self._block(list(s.orelse), in_loop)
            s.orelse = o
            m = m or m2
        return s, m


def _owned_bc(body_stmts):
    """(has_break, has_continue) whose innermost enclosing loop is the
    loop owning `body_stmts`.  With/Try are not entered: a break inside
    them stays python (the region then bails, keeping the loop python —
    consistent either way)."""
    brk = cont = False

    def scan(stmts):
        nonlocal brk, cont
        for s in stmts:
            if isinstance(s, ast.Break):
                brk = True
            elif isinstance(s, ast.Continue):
                cont = True
            elif isinstance(s, ast.If):
                scan(s.body)
                scan(s.orelse)
            # For/While own their inner break/continue; With/Try/defs
            # are left alone on purpose
    scan(body_stmts)
    return brk, cont


class _BreakContinueTransformer(ast.NodeTransformer):
    """break → loop flag folded into the loop condition; continue → flag
    guarding the rest of the iteration (reference
    break_continue_transformer.py:89).  For-range loops containing either
    are rewritten into the equivalent while so the flag can live in the
    condition."""

    def __init__(self):
        self._uid = 0
        self.changed = False

    def _next(self):
        self._uid += 1
        return self._uid

    def visit_FunctionDef(self, node):
        return node

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        return node

    def visit_Lambda(self, node):
        return node

    def visit_While(self, node: ast.While):
        self.generic_visit(node)       # innermost loops first
        has_brk, has_cont = _owned_bc(node.body)
        if node.orelse or not (has_brk or has_cont):
            return node
        self.changed = True
        uid = self._next()
        brk = f"{_GEN_PREFIX}brk_{uid}"
        cont = f"{_GEN_PREFIX}cont_{uid}"
        body = self._block(list(node.body), brk, cont,
                           has_brk, has_cont) or [ast.Pass()]
        if has_cont:
            body = [_assign(cont, ast.Constant(False))] + body
        test = node.test
        if has_brk:
            test = ast.BoolOp(op=ast.And(),
                              values=[_not(_name(brk)), test])
        pre = []
        if has_brk:
            pre.append(_assign(brk, ast.Constant(False)))
        if has_cont:
            pre.append(_assign(cont, ast.Constant(False)))
        return pre + [ast.While(test=test, body=body, orelse=[])]

    def visit_For(self, node: ast.For):
        self.generic_visit(node)
        has_brk, has_cont = _owned_bc(node.body)
        if node.orelse or not (has_brk or has_cont):
            return node
        if (not isinstance(node.target, ast.Name)
                or not isinstance(node.iter, ast.Call)
                or not isinstance(node.iter.func, ast.Name)
                or node.iter.func.id != "range"):
            return node     # non-range for keeps python break/continue
        # Keep the `for range` form (so concrete bounds still unroll with
        # a python index) and guard the whole body with the break flag:
        # after a `break` the remaining iterations become no-ops, which
        # both the unrolled and the lowered paths handle.
        self.changed = True
        uid = self._next()
        brk = f"{_GEN_PREFIX}brk_{uid}"
        cont = f"{_GEN_PREFIX}cont_{uid}"
        body = self._block(list(node.body), brk, cont,
                           has_brk, has_cont) or [ast.Pass()]
        if has_cont:
            body = [_assign(cont, ast.Constant(False))] + body
        pre = []
        post = []
        if has_brk:
            # after a break python's loop target stays at the breaking
            # iteration, but the flag-guarded loop keeps iterating as a
            # no-op — freeze the target in a shadow that only advances
            # while the loop is live, and restore it afterwards
            shadow = f"{_GEN_PREFIX}tgt_{uid}"
            tgt_name = (node.target.id
                        if isinstance(node.target, ast.Name) else None)
            if tgt_name is not None:
                body = [_assign(shadow, _name(tgt_name))] + body
                pre.append(_assign(shadow, _ld_expr(tgt_name)))
                post.append(_assign(tgt_name, _name(shadow)))
            body = [ast.If(test=_not(_name(brk)), body=body, orelse=[])]
            pre.append(_assign(brk, ast.Constant(False)))
        if has_cont:
            pre.append(_assign(cont, ast.Constant(False)))
        node.body = body
        return pre + [node] + post

    def _block(self, stmts, brk, cont, has_brk, has_cont):
        out: List[ast.stmt] = []
        for i, s in enumerate(stmts):
            if isinstance(s, ast.Break):
                out.append(_assign(brk, ast.Constant(True)))
                return out
            if isinstance(s, ast.Continue):
                out.append(_assign(cont, ast.Constant(True)))
                return out
            if isinstance(s, ast.If) and any(_owned_bc([s])):
                s.body = self._block(list(s.body), brk, cont,
                                     has_brk, has_cont) or [ast.Pass()]
                s.orelse = self._block(list(s.orelse), brk, cont,
                                       has_brk, has_cont)
                out.append(s)
                rest = self._block(list(stmts[i + 1:]), brk, cont,
                                   has_brk, has_cont)
                if rest:
                    flags = []
                    if has_brk:
                        flags.append(_name(brk))
                    if has_cont:
                        flags.append(_name(cont))
                    guard = flags[0] if len(flags) == 1 else \
                        ast.BoolOp(op=ast.Or(), values=flags)
                    out.append(ast.If(test=_not(guard), body=rest,
                                      orelse=[]))
                return out
            out.append(s)
        return out


class _LogicalTransformer(ast.NodeTransformer):
    """and/or/not → short-circuit-preserving converter calls that lower
    to logical ops on traced tensors (reference logical_transformer.py).
    Operand evaluation is wrapped in lambdas so the python short-circuit
    contract holds exactly for concrete values."""

    def __init__(self):
        self.changed = False

    def visit_FunctionDef(self, node):
        return node

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        return node

    def visit_Lambda(self, node):
        return node

    @staticmethod
    def _lambda_unsafe(*exprs) -> bool:
        # walrus bindings would become lambda-local (PEP 572),
        # yield/await cannot live in a lambda at all, and a container
        # mutation (buf.pop()) would execute trace-count times under a
        # traced predicate — keep python semantics (loud error when
        # traced) for such operands
        for e in exprs:
            for n in ast.walk(e):
                if isinstance(n, (ast.NamedExpr, ast.Yield,
                                  ast.YieldFrom, ast.Await)):
                    return True
                if _mutation_receiver(n) is not None:
                    return True
        return False

    def visit_BoolOp(self, node: ast.BoolOp):
        self.generic_visit(node)
        if self._lambda_unsafe(*node.values):
            return node
        fname = ("convert_logical_and" if isinstance(node.op, ast.And)
                 else "convert_logical_or")
        expr = node.values[-1]
        for v in reversed(node.values[:-1]):
            expr = ast.Call(func=_jst_attr(fname),
                            args=[_lambda0(v), _lambda0(expr)],
                            keywords=[])
        self.changed = True
        return expr

    def visit_UnaryOp(self, node: ast.UnaryOp):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            self.changed = True
            return ast.Call(func=_jst_attr("convert_logical_not"),
                            args=[node.operand], keywords=[])
        return node

    def visit_Compare(self, node: ast.Compare):
        """``a < b < c`` → ``_jst.convert_chain_compare(lambda: a,
        ("Lt", lambda: b), ("Lt", lambda: c))`` so a chained comparison
        over traced tensors converts like the explicit BoolOp would.
        The runtime helper evaluates each operand AT MOST once and
        short-circuits concrete-false comparisons, so python's chain
        contract holds exactly even for impure operands; only
        lambda-hostile operands (walrus/yield/mutation) stay python."""
        self.generic_visit(node)
        if len(node.ops) < 2:
            return node
        operands = [node.left] + node.comparators
        if self._lambda_unsafe(*operands):
            return node
        pair_args = [
            ast.Tuple(elts=[ast.Constant(type(op).__name__),
                            _lambda0(operands[i + 1])],
                      ctx=ast.Load())
            for i, op in enumerate(node.ops)]
        self.changed = True
        return ast.Call(func=_jst_attr("convert_chain_compare"),
                        args=[_lambda0(node.left)] + pair_args,
                        keywords=[])

    def visit_IfExp(self, node: ast.IfExp):
        self.generic_visit(node)
        if self._lambda_unsafe(node.body, node.orelse):
            return node
        self.changed = True
        return ast.Call(func=_jst_attr("convert_ifexp"),
                        args=[node.test, _lambda0(node.body),
                              _lambda0(node.orelse)], keywords=[])


class _CallSiteWrapper(ast.NodeTransformer):
    """foo(args) -> _jst.cvt(foo)(args) for plain-name/attribute callees,
    so user helper functions get converted recursively (reference
    convert_call).  Generated _jst.* calls are left alone."""

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        f = node.func
        if isinstance(f, ast.Name) and not f.id.startswith("__jst_"):
            pass
        elif isinstance(f, ast.Attribute):
            root = f
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name) and root.id == "_jst":
                return node
        else:
            return node
        node.func = ast.Call(func=_jst_attr("cvt"), args=[f], keywords=[])
        return node


class _ControlFlowTransformer(ast.NodeTransformer):
    def __init__(self, filename: str = "<unknown>"):
        self.changed = False
        self._uid = 0
        self._filename = filename

    def _next(self, kind):
        self._uid += 1
        return f"__jst_{kind}_{self._uid}"

    def _bail(self, node, construct, reason):
        _record_bail(self._filename, node, construct, reason)
        return node

    # do not descend into nested defs — they are separate conversions
    def visit_FunctionDef(self, node):
        return node

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        return node

    def visit_Lambda(self, node):
        return node

    def visit_If(self, node: ast.If):
        self.generic_visit(node)   # innermost first
        r = _bail_reason(node.body) or _bail_reason(node.orelse)
        if r:
            return self._bail(node, "if", r)
        assigned = sorted(_assigned_names(node.body)
                          | _assigned_names(node.orelse))
        if not assigned:
            # nothing flows out: conversion could only lose side-effect
            # semantics under tracing — keep the python if
            return self._bail(
                node, "if",
                "no variable assignment flows out of it (side-effect-"
                "only branches stay python)")
        reads = sorted((_loaded_names(node.body)
                        | _loaded_names(node.orelse)
                        | _loaded_names([ast.Expr(node.test)])) - {"_jst"})
        tname = self._next("true")
        fname = self._next("false")
        true_def = _branch_funcdef(tname, reads, node.body, assigned)
        false_def = _branch_funcdef(fname, reads, node.orelse, assigned)
        # a return-flag tail guard (`if not __jstf_ret_N:`) may fill
        # one-sided assignments with placeholders: they are dead on the
        # flag-set path (the function returns right after)
        is_guard = any(
            isinstance(m, ast.Name)
            and m.id.startswith(_GEN_PREFIX + "ret")
            for m in ast.walk(node.test))
        kw = [ast.keyword(
            arg="names",
            value=ast.Tuple(elts=[ast.Constant(n) for n in assigned],
                            ctx=ast.Load()))]
        if is_guard:
            kw.append(ast.keyword(arg="guard", value=ast.Constant(True)))
        call = ast.Call(
            func=_jst_attr("convert_ifelse"),
            args=[node.test, _name(tname), _name(fname),
                  ast.Tuple(elts=[_ld_expr(r) for r in reads],
                            ctx=ast.Load())],
            keywords=kw)
        self.changed = True
        return [true_def, false_def, _unpack_assign(assigned, call)]

    def visit_While(self, node: ast.While):
        self.generic_visit(node)
        if node.orelse:
            return self._bail(node, "while", "it has an `else` clause")
        r = _bail_reason(node.body)
        if r:
            return self._bail(node, "while", r)
        assigned = sorted(_assigned_names(node.body))
        if not assigned:
            return self._bail(node, "while",
                              "no variable assignment flows out of it")
        reads = sorted((_loaded_names(node.body)
                        | _loaded_names([ast.Expr(node.test)]))
                       - set(assigned) - {"_jst"})
        cname = self._next("cond")
        bname = self._next("body")
        params = assigned  # loop-carried; reads stay free (closures)
        cond_def = ast.FunctionDef(
            name=cname,
            args=ast.arguments(posonlyargs=[],
                               args=[ast.arg(arg=p) for p in params],
                               kwonlyargs=[], kw_defaults=[], defaults=[]),
            body=[ast.Return(value=node.test)],
            decorator_list=[])
        body_def = _branch_funcdef(bname, params, node.body, assigned)
        call = ast.Call(
            func=_jst_attr("convert_while"),
            args=[_name(cname), _name(bname),
                  ast.Tuple(elts=[_ld_expr(n) for n in assigned],
                            ctx=ast.Load())],
            keywords=[ast.keyword(
                arg="names",
                value=ast.Tuple(elts=[ast.Constant(n) for n in assigned],
                                ctx=ast.Load()))])
        self.changed = True
        return [cond_def, body_def, _unpack_assign(assigned, call)]

    def visit_For(self, node: ast.For):
        self.generic_visit(node)
        # only `for <name> in range(...)` without else
        if not (isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == "range"):
            return self._bail(
                node, "for",
                "it iterates a non-range iterable (tensor-dependent "
                "iteration needs `for i in range(...)`)")
        if (node.orelse
                or not isinstance(node.target, ast.Name)
                or node.iter.keywords
                or not 1 <= len(node.iter.args) <= 3
                or any(isinstance(a, ast.Starred)
                       for a in node.iter.args)):
            return self._bail(node, "for",
                              "its range/target form is not convertible")
        r = _bail_reason(node.body)
        if r:
            return self._bail(node, "for", r)
        assigned = sorted(_assigned_names(node.body) - {node.target.id})
        if not assigned:
            return self._bail(node, "for",
                              "no variable assignment flows out of it")
        ra = node.iter.args
        if len(ra) == 1:
            start, stop, step = ast.Constant(0), ra[0], ast.Constant(1)
        elif len(ra) == 2:
            start, stop, step = ra[0], ra[1], ast.Constant(1)
        else:
            start, stop, step = ra
        bname = self._next("forbody")
        body_def = _branch_funcdef(
            bname, [node.target.id] + assigned, node.body, assigned)
        # the loop target is itself an output: python leaves it bound to
        # the last iterated value after the loop, and user code reads it
        call = ast.Call(
            func=_jst_attr("convert_range_loop"),
            args=[start, stop, step, _name(bname),
                  ast.Tuple(elts=[_ld_expr(n) for n in assigned],
                            ctx=ast.Load())],
            keywords=[
                ast.keyword(
                    arg="names",
                    value=ast.Tuple(
                        elts=[ast.Constant(n) for n in assigned],
                        ctx=ast.Load())),
                ast.keyword(arg="target_init",
                            value=_ld_expr(node.target.id)),
            ])
        self.changed = True
        return [body_def,
                _unpack_assign([node.target.id] + assigned, call)]


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

_CONVERTED_MARK = "__jst_converted__"
#: the converted function, kept on the original (a call site reached at
#: every eager call converts once)
_CACHE = "__jst_converted_fn__"


def convert_function(fn):
    """AST-convert python control flow in ``fn``; returns ``fn`` itself
    when nothing needs converting or the source is unavailable."""
    bound_self = None
    if inspect.ismethod(fn):
        bound_self = fn.__self__
        fn = fn.__func__
    if getattr(fn, _CONVERTED_MARK, False):
        return fn if bound_self is None else fn.__get__(bound_self)
    cached = getattr(fn, _CACHE, None)
    if cached is not None:
        return cached if bound_self is None else cached.__get__(bound_self)
    if (getattr(fn, "__module__", "") or "").split(".")[0] in (
            "paddle_tpu_torch", "torch"):
        # library code: no tensor-dependent Python control flow by
        # construction (as convert_call skips it)
        return fn if bound_self is None else fn.__get__(bound_self)
    if "__class__" in fn.__code__.co_freevars:
        # zero-argument super() needs the class cell, which only a def
        # compiled inside the class body gets: leave the function as it is
        setattr(fn, _CONVERTED_MARK, True)
        return fn if bound_self is None else fn.__get__(bound_self)
    try:
        src_lines, first_line = inspect.getsourcelines(fn)
        src = textwrap.dedent("".join(src_lines))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return fn if bound_self is None else fn.__get__(bound_self)
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn if bound_self is None else fn.__get__(bound_self)
    # only the to_static decorator itself may be stripped; any other
    # decorator would be silently dropped by recompilation — bail
    for dec in fdef.decorator_list:
        if "to_static" not in ast.unparse(dec):
            setattr(fn, _CONVERTED_MARK, True)
            return fn if bound_self is None else fn.__get__(bound_self)
    fdef.decorator_list = []
    filename = fn.__code__.co_filename
    # map node linenos to FILE linenos before any transform, so bail
    # records, tracebacks, and linecache all point at the user's source
    # (reference origin_info.py)
    ast.increment_lineno(tree, first_line - 1)
    # generators/coroutines: `return` means StopIteration(value) and
    # yield/await cannot cross generated function boundaries — leave the
    # return machinery off (break/continue flags and call wrapping are
    # still semantics-preserving for them)
    is_gen = isinstance(fdef, ast.AsyncFunctionDef) or any(
        isinstance(n, (ast.Yield, ast.YieldFrom, ast.Await))
        for n in _walk_scope(fdef))
    ret_tr = _ReturnTransformer(uid=abs(hash(fn.__qualname__)) % 9973)
    if not is_gen:
        ret_tr.run(fdef)
    bc_tr = _BreakContinueTransformer()
    fdef.body = [x for stmt in fdef.body
                 for x in _as_list(bc_tr.visit(stmt))]
    log_tr = _LogicalTransformer()
    fdef.body = [x for stmt in fdef.body
                 for x in _as_list(log_tr.visit(stmt))]
    tr = _ControlFlowTransformer(filename=filename)
    fdef.body = [x for stmt in fdef.body
                 for x in _as_list(tr.visit(stmt))]
    # call-site wrapping lets helpers reached from here convert too
    # (reference convert_call); only worth the indirection when this
    # function itself converts, or when it might CALL converting code
    _CallSiteWrapper().visit(fdef)
    changed = (tr.changed or ret_tr.applied or bc_tr.changed
               or log_tr.changed)
    if not changed and not _has_user_calls(fdef):
        setattr(fn, _CONVERTED_MARK, True)
        return fn if bound_self is None else fn.__get__(bound_self)
    # the converted def is compiled nested in a factory whose locals are
    # the function's free names and ``_jst`` (this module), so that its
    # code takes them as closure cells: the function's own cells (a
    # rebinding of an enclosing local, ``nonlocal``, a helper defined after
    # the decorated function, all stay live) and a cell for ``_jst``; its
    # globals are the original module's dict itself (later rebindings of
    # module globals are seen, and so is every name by a tracer that reads
    # the dict directly, as torch's dynamo does for a torch.cond branch)
    free = list(fn.__code__.co_freevars)
    factory = ast.FunctionDef(
        name="__jst_factory",
        args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                           kw_defaults=[], defaults=[]),
        body=[_assign(n, ast.Constant(None)) for n in ["_jst"] + free]
        + [fdef, ast.Return(value=_name(fdef.name))],
        decorator_list=[])
    tree.body = [factory]
    ast.fix_missing_locations(tree)
    from . import dy2static as _jst_mod

    ns: dict = {}
    try:
        exec(compile(tree, filename=filename, mode="exec"), fn.__globals__,
             ns)
    except SyntaxError:
        setattr(fn, _CONVERTED_MARK, True)
        return fn if bound_self is None else fn.__get__(bound_self)
    code = next(c for c in ns["__jst_factory"].__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == fdef.name)
    cells = dict(zip(free, fn.__closure__ or ()))
    cells["_jst"] = types.CellType(_jst_mod)
    new_fn = types.FunctionType(code, fn.__globals__, fdef.name,
                                fn.__defaults__,
                                tuple(cells[n] for n in code.co_freevars))
    new_fn.__kwdefaults__ = fn.__kwdefaults__
    functools.update_wrapper(new_fn, fn)
    setattr(new_fn, _CONVERTED_MARK, True)
    setattr(fn, _CACHE, new_fn)
    return new_fn if bound_self is None else new_fn.__get__(bound_self)


def _has_user_calls(fdef) -> bool:
    """Does the (wrapped) function contain any _jst.cvt call sites?"""
    for n in ast.walk(fdef):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Call) and \
                isinstance(n.func.func, ast.Attribute) and \
                n.func.func.attr == "cvt":
            return True
    return False


def _as_list(v):
    return v if isinstance(v, list) else [v]
