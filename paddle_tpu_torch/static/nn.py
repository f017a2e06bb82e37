"""``paddle.static.nn`` control flow: ``cond``, ``while_loop``, ``case`` and
``switch_case``; the layer builders of :mod:`.nn_compat` (``fc``,
``embedding``, the convolutions, the norms...) are re-exported here, as in
the JAX package.

Port of ``paddle_tpu/static/nn.py:99-230`` and
``paddle_tpu/static/nn_compat.py:264-300``.  The JAX package runs a branch
or a loop eagerly when its predicate is concrete and lowers it to
``lax.cond`` / ``lax.while_loop`` when the predicate is traced.  The port
has no tracer: where the predicate lives decides.

- **Eager** (a Python value, or a tensor while no capture or export is
  running: the CPU, a program's eager first call on the card): the taken
  branch, or the loop, runs in Python with ``bool(pred)``, differentiable
  as any eager code.  On the card, inside a :mod:`..jit` program's eager
  first call, the untaken branch is also run once under a relaxed CUDA
  graph capture that is thrown away, so that a kernel library's lazy
  state (a cuBLAS workspace on the body stream) is made before the
  program's capture, as torch's ``ControlFlowOpWarmupDispatchMode`` warms
  both sides of a ``torch.cond``.  The warm-up runs no kernels, so tensor
  state that the branch makes on a module it reaches (a parameter, a
  buffer or a tensor attribute, new or rebound) would hold no values: it
  is put back and the call raises.  The branch's Python side effects
  happen at the warm-up too.
- **Captured** (the current CUDA stream is capturing): a branch becomes
  a pair of CUDA graph IF nodes, the true body under ``pred`` and the false
  body under ``not pred``, and the pair's outputs are selected after it
  with ``torch.where(pred, t, f)`` (torch's ``if_else_node`` copies the
  else outputs into the if outputs, which overwrites an if output that
  aliases an input).  A loop becomes one WHILE node
  (``csrc/graph_control.cu``): its carried tensors are copied into buffers
  of their own before the node, each trip copies the body's results back
  into them (a result that shares storage with another buffer cloned
  first, so ``a, b = b, a`` reads no overwritten buffer), and the trip's
  last kernel sets the test for the next.  :func:`host_replay` runs the
  same path on the CPU.  The
  bodies are captured on a stream of their own per nesting depth, and
  their allocations go to a memory pool per node (torch's
  ``_cuda_beginAllocateCurrentThreadToPool``).  The nodes' run counters
  (read by ``kernels.launch_counts()``) and their pools belong to the
  graph being captured: a :class:`Nodes` made before its capture and
  released after it.  A captured ``cond`` is a
  ``torch.autograd.Function`` whose backward records a second IF pair over
  the two branches' VJPs; a captured ``while_loop`` is forward-only, as
  ``lax.while_loop`` is, and a backward through it raises.
- **Exported** (``torch.compiler.is_exporting()``, or a fake tensor): the
  branch lowers to ``torch.cond`` and the loop to ``torch.while_loop``,
  which a saved program (:func:`..jit.save`) keeps.
- **Recorded** (a tensor while a static program records,
  :mod:`.program`): the branches, or the test and the body, are recorded
  as sub-programs, and the call is one op of the program whose replay
  calls ``cond`` / ``while_loop`` again on the replayed values, so it
  takes one of the paths above at every run.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..ops import kernels
from . import program as _program

from .nn_compat import *  # noqa: F401,F403 — fluid-style builders
from . import nn_compat as _nn_compat

__all__ = ["cond", "while_loop", "case", "switch_case", "Nodes",
           "host_replay"] + list(_nn_compat.__all__)

_local = threading.local()
#: untaken branches warmed so far (:func:`_warm`)
warmups = 0
#: the :class:`Nodes` of the capture under way (module-wide: a captured
#: backward's nodes are made on autograd's thread)
_scope: Optional["Nodes"] = None
#: the run counters a :class:`Nodes` makes for its graph
COUNTERS = 4096


# -- where the predicate lives ------------------------------------------------

def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def in_dynamo() -> bool:
    """True while torch's dynamo traces the code (a ``torch.cond`` branch
    or a ``torch.while_loop`` body under an export)."""
    return torch.compiler.is_dynamo_compiling()


def exporting(v=None) -> bool:
    """True while ``torch.export`` traces (or ``v`` is a fake tensor)."""
    if in_dynamo():
        return True
    return bool(torch.compiler.is_exporting()) or (
        isinstance(v, torch.Tensor) and _is_fake(v))


def capturing(v) -> bool:
    """True when ``v`` is a CUDA tensor and the current stream captures,
    or ``v`` is any tensor inside :func:`host_replay`."""
    if not isinstance(v, torch.Tensor) or exporting(v):
        return False
    if replaying():
        return True
    return v.is_cuda and torch.cuda.is_current_stream_capturing()


def replaying() -> bool:
    """True inside :func:`host_replay`."""
    return getattr(_local, "replay", False)


@contextlib.contextmanager
def host_replay():
    """Inside, a tensor predicate takes the captured path on any device,
    each node's body run by Python where the card would replay it: an IF
    pair runs both bodies and selects, a WHILE node runs its trips over
    the same carry buffers and the same staged write-back.  The CPU's
    twin of a capture, for tests of what a node computes."""
    prev = replaying()
    _local.replay = True
    try:
        yield
    finally:
        _local.replay = prev


def traced(v) -> bool:
    """The port's "traced" value: a tensor whose value the host cannot read
    now (under an export, or on a capturing stream)."""
    if in_dynamo():
        return isinstance(v, torch.Tensor)
    return isinstance(v, torch.Tensor) and (exporting(v) or capturing(v))


def scalar(v, device=None, dtype=None) -> torch.Tensor:
    """A 0-d tensor of a Python or numpy scalar on ``device``, made there
    by a fill (a capture refuses the host-to-device copy of
    ``torch.tensor(v, device=...)``)."""
    if dtype is None:
        dtype = torch.as_tensor(v).dtype
    if isinstance(v, (np.ndarray, np.generic)):
        v = v.item()
    return torch.full((), v, dtype=dtype, device=device)


def _as_pred(v, device=None) -> torch.Tensor:
    """A one-element bool tensor, contiguous (a node reads it by address)."""
    t = v if isinstance(v, torch.Tensor) else scalar(bool(v), device)
    if t.numel() != 1:
        raise ValueError(f"a condition must hold one element, got shape "
                         f"{tuple(t.shape)}")
    return t.reshape(()).to(torch.bool).contiguous()


def _truthy(v) -> bool:
    return bool(v.item()) if isinstance(v, torch.Tensor) else bool(v)


# -- conditional node bodies --------------------------------------------------

def _depth() -> int:
    return getattr(_local, "depth", 0)


@contextlib.contextmanager
def _body_capture(scope: "Nodes", depth: int):
    """Capture what runs inside on the depth's body stream, its allocations
    going to a new pool (``scope``'s)."""
    index = scope.index
    child = kernels.graph_stream(scope.device, depth)
    pool = torch.cuda.graph_pool_handle()
    scope.pools.append((index, pool))
    _local.depth = depth + 1
    try:
        with torch.cuda.stream(child):
            torch._C._cuda_beginAllocateCurrentThreadToPool(index, pool)
            try:
                yield child
            finally:
                torch._C._cuda_endAllocateToPool(index, pool)
    finally:
        _local.depth = depth


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


class Nodes:
    """What the conditional nodes of one CUDA graph hold, made before its
    capture and kept as long as the graph: a bank of ``capacity`` int64
    counters of their bodies' runs (made inside the capture, a counter
    would be zeroed at every replay), the memory pools of their bodies, and
    ``per_run``, the launches one run of each body makes, which
    ``kernels.launch_counts()`` multiplies by the counters while this
    object lives.  A :mod:`..jit` program makes one for its capture;
    around a capture of one's own::

        nodes = static.nn.Nodes(device)
        with nodes, torch.cuda.graph(graph, stream=side):
            ...
        ...                      # replays
        del graph
        nodes.release()

    ``capacity`` defaults to :data:`COUNTERS`; with 0 the nodes count no
    runs (a graph that is thrown away)."""

    def __init__(self, device, capacity: Optional[int] = None):
        if capacity is None:
            capacity = COUNTERS
        self.device = torch.device(device)
        self.index = _index(self.device)
        self.runs = torch.zeros(capacity, dtype=torch.int64,
                                device=self.device) if capacity else None
        self.used = 0
        self.pools: List[tuple] = []
        self.per_run: List[list] = []
        self._outer = None

    def __enter__(self) -> "Nodes":
        global _scope
        self._outer, _scope = _scope, self
        kernels.count_per_run(self)
        return self

    def __exit__(self, *exc) -> None:
        global _scope
        _scope = self._outer

    def counter(self) -> Optional[torch.Tensor]:
        """The next counter of the bank (None without one)."""
        if self.runs is None:
            return None
        if self.used >= self.runs.numel():
            raise RuntimeError(
                f"the capture makes more than {self.runs.numel()} conditional "
                "nodes, the run counters made for its graph")
        self.used += 1
        return self.runs[self.used - 1:self.used]

    def release(self) -> None:
        """Once the graph is gone: stop counting its bodies' runs and
        release their pools."""
        self.per_run = []
        pools, self.pools = self.pools, []
        for index, pool in pools:
            torch._C._cuda_releasePool(index, pool)


class _Node:
    """One conditional node while its body is captured: the body's own
    kernel launches are moved from the capture's counts to a count per run
    of the body (nested bodies count their own)."""

    def __init__(self, pred: torch.Tensor, is_while: bool, negate: bool):
        self.device = pred.device
        self.is_while = is_while
        self.scope = _scope
        if self.scope is None or self.scope.index != _index(self.device):
            raise RuntimeError(
                f"a conditional node was captured on cuda:"
                f"{_index(self.device)} outside a to_static program; capture "
                "it inside static.nn.Nodes(device), kept as long as the "
                "graph")
        self.runs = self.scope.counter()
        self.parent = torch.cuda.current_stream(self.device)
        self.depth = _depth()
        self.handle = None
        self.pred = pred
        self.negate = negate
        self.end_pred: Optional[torch.Tensor] = None

    @contextlib.contextmanager
    def body(self):
        outer = getattr(_local, "nodes", None)
        if outer is None:
            outer = _local.nodes = []
        child = kernels.graph_stream(self.device, self.depth)
        self.handle = kernels.graph_node_begin(
            self.parent, child, self.is_while, self.pred, self.negate,
            self.runs)
        before = kernels.launch_counts()
        outer.append({})                     # launches of nested bodies
        ok = False
        try:
            with _body_capture(self.scope, self.depth):
                yield self
            ok = True
        finally:
            nested = outer.pop()
            if not ok:
                # close the body's capture so the outer capture can end
                try:
                    kernels.graph_node_end(child, False, self.handle)
                except RuntimeError:
                    pass
        if self.is_while:
            if self.end_pred is None:
                raise RuntimeError("a WHILE body was closed without its test")
        kernels.graph_node_end(child, self.is_while, self.handle,
                               self.end_pred, self.runs)
        after = kernels.launch_counts()
        total = {n: after[n] - before[n] for n in after
                 if after[n] != before[n]}
        own = {n: c - nested.get(n, 0) for n, c in total.items()
               if c != nested.get(n, 0)}
        if outer:
            for n, c in total.items():
                outer[-1][n] = outer[-1].get(n, 0) + c
        # captured once, run as often as the counter says
        kernels.add_launches({n: -c for n, c in own.items()})
        if own and self.runs is not None:
            self.scope.per_run.append([own, self.runs, 0])


def _if_body(pred: torch.Tensor, fn: Callable, negate: bool):
    if replaying():
        return fn()
    node = _Node(pred, False, negate)
    with node.body():
        out = fn()
    return out


# -- warming the untaken branch -------------------------------------------------

@contextlib.contextmanager
def warming(on: bool = True):
    """Inside, an eager branch over a CUDA predicate also warms its untaken
    side (a program's eager first call on the card), once per branch
    function (a branch in a loop is warmed at its first trip)."""
    prev = getattr(_local, "warm", False), getattr(_local, "warmed", None)
    _local.warm, _local.warmed = on, set()
    try:
        yield
    finally:
        _local.warm, _local.warmed = prev


def _module_state(mods) -> dict:
    """(module, name) -> (the dict that holds it, tensor), for each tensor
    that ``mods`` and their submodules hold: parameters, buffers and
    tensor attributes."""
    state = {}
    for top in mods:
        for m in top.modules():
            for d in (m._parameters, m._buffers, vars(m)):
                for name, v in d.items():
                    if isinstance(v, torch.Tensor):
                        state[(m, name)] = (d, v)
    return state


def _put_back(before: dict, after: dict) -> List[str]:
    """Undo the changes from ``before`` to ``after`` (module state);
    returns what changed, named."""
    changed = []
    for (m, name), (_, v) in after.items():
        d, old = before.get((m, name), (None, None))
        if old is v:
            continue
        changed.append(f"{type(m).__name__}.{name}")
        for held in (m._parameters, m._buffers, vars(m)):
            held.pop(name, None)
        m._non_persistent_buffers_set.discard(name)
        if old is not None:
            d[name] = old
    return changed


def _warm(pred: torch.Tensor, fn: Callable, mods=()) -> None:
    """Run ``fn`` once under a relaxed capture that is thrown away: its
    kernels do not run, a kernel library's lazy state is made.  Tensor
    state made or rebound on ``mods`` is put back and raises (module
    docstring).  A warm-up that fails otherwise is dropped: the program's
    capture then meets the same failure and names it."""
    from ..jit import CaptureError, _end_failed_capture

    global warmups
    warmups += 1
    counts = kernels.launch_counts()
    stream = kernels.graph_stream(pred.device, _depth())
    graph = torch.cuda.CUDAGraph()
    nodes = Nodes(pred.device, capacity=0)
    state = _module_state(mods)
    prev = getattr(_local, "warm", False)
    _local.warm = False
    try:
        with nodes, torch.no_grad(), torch.cuda.graph(
                graph, stream=stream, capture_error_mode="relaxed"):
            fn()
    except Exception:                # noqa: BLE001 — see the docstring
        _end_failed_capture(pred.device, stream)
    finally:
        _local.warm = prev
        del graph
        nodes.release()
        after = kernels.launch_counts()
        kernels.add_launches({n: counts[n] - after[n] for n in after
                              if after[n] != counts[n]})
    changed = _put_back(state, _module_state(mods))
    if changed:
        raise CaptureError(
            f"to_static: the untaken branch of a tensor condition made or "
            f"rebound tensor state ({', '.join(changed)}) while it was "
            "warmed before the capture; a warm-up runs no kernels, so that "
            "state would hold no values.  Make it before the function runs "
            "(in the module's __init__)")


# -- branch output unification (shared with dy2static) -----------------------

def select(pred: torch.Tensor, t, f):
    """``where(pred, t, f)`` leaf by leaf over two matching structures (a
    missing side, ``None``, reads as zeros of the other's leaves)."""
    if t is None:
        t = pytree.tree_map(torch.zeros_like, f)
    if f is None:
        f = pytree.tree_map(torch.zeros_like, t)
    t_leaves, spec = pytree.tree_flatten(t)
    f_leaves, f_spec = pytree.tree_flatten(f)
    if spec != f_spec:
        raise ValueError(f"the branches return different structures "
                         f"({spec} vs {f_spec})")
    out = [torch.where(pred, a, b) for a, b in zip(t_leaves, f_leaves)]
    return pytree.tree_unflatten(out, spec)


# -- cond ----------------------------------------------------------------------

def _reachable(*fns, operands=()) -> tuple:
    """What a branch can read without taking it as an operand (the JAX
    ``_leaves_of``): modules (among the operands, a bound method's owner,
    in the functions' closures and in the globals they name) and raw
    tensors (in the closures and globals)."""
    mods, raw, seen = [], [], set()
    cands = list(operands)
    for fn in fns:
        owner = getattr(fn, "__self__", None)
        if owner is not None:
            cands.append(owner)
        for cell in getattr(fn, "__closure__", None) or ():
            try:
                cands.append(cell.cell_contents)
            except ValueError:
                continue
        code, glb = getattr(fn, "__code__", None), getattr(
            fn, "__globals__", None)
        if code is not None and glb is not None:
            cands.extend(glb[n] for n in code.co_names if n in glb)
    for v in cands:
        if id(v) in seen:
            continue
        seen.add(id(v))
        if isinstance(v, torch.nn.Module):
            mods.append(v)
        elif isinstance(v, torch.Tensor) and not any(v is o for o in
                                                     operands):
            raw.append(v)
    return mods, raw


def _grad_params(mods) -> List[tuple]:
    """(owning module, attribute, parameter) of every grad-requiring
    parameter of ``mods``, each parameter once."""
    out, seen = [], set()
    for m in mods:
        for name, p in m.named_parameters():
            if p.requires_grad and id(p) not in seen:
                seen.add(id(p))
                owner_name, _, attr = name.rpartition(".")
                out.append((m.get_submodule(owner_name), attr, p))
    return out


@contextlib.contextmanager
def _swapped(entries, leaves):
    """The parameters of ``entries`` replaced by ``leaves`` inside: a
    branch's autograd graph then ends at leaves made in its body (on the
    body's stream), not at the parameters' accumulators, which live on the
    capture stream and would join the body to the outer graph."""
    saved = [(owner, attr, owner._parameters[attr])
             for owner, attr, _ in entries]
    try:
        for (owner, attr, _), leaf in zip(entries, leaves):
            owner._parameters[attr] = leaf
        yield
    finally:
        for owner, attr, p in saved:
            owner._parameters[attr] = p


class _CapturedCond(torch.autograd.Function):
    """A captured ``cond`` that keeps gradients: the forward captures the
    IF pair with each branch's autograd graph recorded inside its body; the
    backward captures a second IF pair, each body taking the VJP of its
    branch, and selects the two by ``pred``."""

    @staticmethod
    def forward(ctx, pred, run, *inputs):
        outs, ctx.saved = run(inputs)
        ctx.pred, ctx.depth = pred, _depth()
        ctx.n_in = len(inputs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        pred, (t_outs, f_outs, wrt) = ctx.pred, ctx.saved
        need = [i for i, x in enumerate(wrt) if x.requires_grad]

        def vjp(outs):
            pairs = [(o, g.sum_to_size(o.shape).to(o.dtype))
                     for o, g in zip(outs, grads)
                     if g is not None and o is not None and o.requires_grad]
            got = [None] * len(need)
            if pairs:
                got = list(torch.autograd.grad(
                    [o for o, _ in pairs], [wrt[i] for i in need],
                    [g for _, g in pairs], allow_unused=True))
            return [torch.zeros_like(wrt[i]) if g is None else g
                    for i, g in zip(need, got)]

        prev = _depth()
        _local.depth = ctx.depth
        try:
            gt = _if_body(pred, lambda: vjp(t_outs), False)
            gf = _if_body(pred, lambda: vjp(f_outs), True)
        finally:
            _local.depth = prev
        res = [None] * ctx.n_in
        for i, a, b in zip(need, gt, gf):
            res[i] = torch.where(pred, a, b)
        return (None, None, *res)


def _captured_cond(pred, true_fn, false_fn, operands, unify=None):
    """Path (b): the IF pair, its outputs selected after it.  ``unify``
    (dy2static's) maps the two raw outputs to matching structures."""
    pred = _as_pred(pred)
    mods, raw = _reachable(true_fn, false_fn, operands=operands)
    params = _grad_params(mods)
    op_ix = [i for i, o in enumerate(operands) if isinstance(o, torch.Tensor)]
    grad = torch.is_grad_enabled() and (
        params or any(operands[i].requires_grad for i in op_ix))
    if grad and any(t.requires_grad for t in raw):
        raise RuntimeError(
            "static.cond: a captured branch reads a grad-requiring tensor "
            "that is neither an operand nor a module's parameter; pass it "
            "as an operand so its gradient can flow through the IF nodes")

    def run(inputs):
        """The IF pair on ``inputs`` (operand tensors, then the modules'
        grad-requiring parameters): returns the selected leaves and what
        the backward needs."""
        ops = list(operands)
        wrt = [x.detach().requires_grad_(x.requires_grad) if grad else x
               for x in inputs]
        for j, i in enumerate(op_ix):
            ops[i] = wrt[j]
        leaves = wrt[len(op_ix):]
        with torch.enable_grad() if grad else contextlib.nullcontext(), \
                _swapped(params, leaves):
            t = _if_body(pred, lambda: true_fn(*ops), False)
            f = _if_body(pred, lambda: false_fn(*ops), True)
            if unify is not None:
                t, f = unify(t, f)
        sel = select(pred, t, f)
        t_l = pytree.tree_leaves(t) if t is not None else None
        f_l = pytree.tree_leaves(f) if f is not None else None
        return sel, (t_l, f_l, wrt)

    if not grad:
        sel, _ = run([operands[i] for i in op_ix])
        return sel
    holder = {}

    def run_flat(inputs):
        sel, saved = run(inputs)
        leaves, holder["spec"] = pytree.tree_flatten(sel)
        t_l, f_l, wrt = saved
        return [x.detach() for x in leaves], (
            t_l or [None] * len(leaves), f_l or [None] * len(leaves), wrt)

    outs = _CapturedCond.apply(pred, run_flat,
                               *[operands[i] for i in op_ix],
                               *[p for _, _, p in params])
    return pytree.tree_unflatten(list(outs), holder["spec"])


def _fresh(outs):
    """``outs`` with every tensor cloned: ``torch.cond`` and
    ``torch.while_loop`` refuse a body output that aliases an input,
    another output or a tensor the body closes over (a converted branch
    hands an unassigned name's outer value straight back)."""
    return pytree.tree_map(
        lambda o: o.clone() if isinstance(o, torch.Tensor) else o, outs)


def _export_cond(pred, true_fn, false_fn, operands):
    """Path (c): ``torch.cond`` over the tensor operands."""
    tensors = [o for o in operands if isinstance(o, torch.Tensor)]
    ix = [i for i, o in enumerate(operands) if isinstance(o, torch.Tensor)]

    def branch(fn):
        def g(*args):
            ops = list(operands)
            for i, a in zip(ix, args):
                ops[i] = a
            return _fresh(fn(*ops))
        return g

    return torch.cond(_as_pred(pred), branch(true_fn), branch(false_fn),
                      tuple(tensors))


def cond(pred, true_fn: Callable, false_fn: Callable, operands: Sequence = (),
         params: Optional[Sequence] = None, name=None):
    """Two-way branch on a boolean scalar: ``true_fn(*operands)`` if
    ``pred`` else ``false_fn(*operands)`` (module docstring for how each
    device runs it).  Both branches return the same structure of tensors
    when the predicate is captured or exported.  ``params`` is accepted
    for the JAX signature; the port finds the tensors a branch closes over
    itself."""
    operands = tuple(operands)
    if _program.records(pred):
        return _program.record_cond(pred, true_fn, false_fn, operands)
    if isinstance(pred, torch.Tensor) and exporting(pred):
        return _export_cond(pred, true_fn, false_fn, operands)
    if capturing(pred):
        return _captured_cond(pred, true_fn, false_fn, operands)
    taken, other = (true_fn, false_fn) if _truthy(pred) else (false_fn,
                                                              true_fn)
    out = taken(*operands)
    if getattr(_local, "warm", False) and isinstance(pred, torch.Tensor) \
            and pred.is_cuda:
        code = getattr(other, "__code__", other)
        if code not in _local.warmed:
            _local.warmed.add(code)
            mods, _ = _reachable(other, operands=operands)
            _warm(pred, lambda: other(*operands), mods)
    return out


# -- while_loop ------------------------------------------------------------------

def _promote(vars_: List, device) -> List:
    """Python scalars become tensors (their updates must be carried)."""
    return [scalar(v, device) if isinstance(v, (bool, int, float)) else v
            for v in vars_]


class _ForwardOnly(torch.autograd.Function):
    """Marks the outputs of a captured WHILE node: a backward through them
    raises (the loop is forward-only, as ``lax.while_loop`` is)."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.detach() for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "static.while_loop: a loop run as a CUDA graph WHILE node is "
            "forward-only (as lax.while_loop is in the JAX package); run "
            "the backward outside it, or loop in Python over concrete "
            "values")


def _stage(pairs):
    """``pairs`` of (buffer, body result) with every result that shares
    storage with a buffer cloned, unless it is that buffer itself: the
    copies that follow then read no buffer an earlier copy wrote
    (``a, b = b, a``, or ``prev = cur; cur = cur * 2`` with the loop
    variables in name order)."""
    held = {b.untyped_storage().data_ptr() for b, _ in pairs}
    return [(b, r if r is b or r.untyped_storage().data_ptr() not in held
             else r.clone()) for b, r in pairs]


def captured_while(cond_fn: Callable, body_fn: Callable, vars_: List,
                   fill=None) -> List:
    """Path (b): one WHILE node.  ``fill(i, value)`` (dy2static's) gives a
    buffer for a carry that enters unbound and leaves the body a tensor, or
    raises.  A trip runs the body, then copies each result into its
    buffer, staged by :func:`_stage` inside the body (so the graph replays
    the clones)."""
    tensors = [v for v in vars_ if isinstance(v, torch.Tensor)]
    device = next((v.device for v in tensors if v.is_cuda),
                  tensors[0].device)
    vars_ = _promote(list(vars_), device)
    idx = [i for i, v in enumerate(vars_) if isinstance(v, torch.Tensor)]
    carries = [vars_[i].detach().clone() for i in idx]
    cur = list(vars_)
    for j, i in enumerate(idx):
        cur[i] = carries[j]
    pred0 = _as_pred(cond_fn(*cur), device)
    late = {}

    def trip() -> torch.Tensor:
        res = body_fn(*cur)
        res = list(res) if isinstance(res, (tuple, list)) else [res]
        if len(res) != len(vars_):
            raise ValueError(f"while_loop: the body returns {len(res)} "
                             f"values for {len(vars_)} loop variables")
        pairs = []
        for i, r in enumerate(res):
            if i in idx:
                c = cur[i]
                if not isinstance(r, torch.Tensor):
                    r = scalar(r, device, c.dtype)
                if r.shape != c.shape or r.dtype != c.dtype:
                    raise ValueError(
                        f"while_loop: loop variable {i} enters as "
                        f"{c.dtype} {tuple(c.shape)} and leaves the "
                        f"body as {r.dtype} {tuple(r.shape)}; a loop "
                        f"captured as a WHILE node carries fixed shapes "
                        f"and dtypes")
                pairs.append((c, r))
            elif isinstance(r, torch.Tensor):
                if i not in late:
                    if fill is None:
                        raise ValueError(
                            f"while_loop: loop variable {i} enters as "
                            f"{type(vars_[i]).__name__} and leaves the "
                            f"body as a tensor")
                    late[i] = fill(i, r)
                pairs.append((late[i], r))
        for buf, r in _stage(pairs):
            if r is not buf:
                buf.copy_(r)
        nxt = [late.get(i, cur[i] if i in idx else r)
               for i, r in enumerate(res)]
        return _as_pred(cond_fn(*nxt), device)

    if replaying():
        with torch.no_grad():
            pred = pred0
            while bool(pred):
                pred = trip()
    else:
        node = _Node(pred0, True, False)
        with node.body():
            with torch.no_grad():
                node.end_pred = trip()
    out = list(cur)
    for i, b in late.items():
        out[i] = b
    if torch.is_grad_enabled():
        # what the body could differentiate: grad-requiring carries, and
        # the parameters and tensors its functions reach
        mods, raw = _reachable(cond_fn, body_fn, operands=vars_)
        sources = ([vars_[i] for i in idx if vars_[i].requires_grad]
                   + [p for _, _, p in _grad_params(mods)]
                   + [t for t in raw if t.requires_grad])
        if sources:
            marked = _ForwardOnly.apply(*[out[i] for i in idx], *sources)
            for j, i in enumerate(idx):
                out[i] = marked[j]
    return out


def _export_while(cond_fn, body_fn, vars_: List) -> List:
    """Path (c): ``torch.while_loop`` over the tensor loop variables."""
    device = next(v.device for v in vars_ if isinstance(v, torch.Tensor))
    vars_ = _promote(list(vars_), device)
    idx = [i for i, v in enumerate(vars_) if isinstance(v, torch.Tensor)]

    def full(ts):
        cur = list(vars_)
        for i, t in zip(idx, ts):
            cur[i] = t
        return cur

    def c(*ts):
        return _as_pred(cond_fn(*full(ts)))

    def b(*ts):
        res = body_fn(*full(ts))
        res = list(res) if isinstance(res, (tuple, list)) else [res]
        out = []
        for i, t in zip(idx, ts):
            r = res[i]
            if not isinstance(r, torch.Tensor):
                r = scalar(r, t.device, t.dtype)
            out.append(r.to(t.dtype))
        return _fresh(tuple(out))

    outs = torch.while_loop(c, b, tuple(vars_[i] for i in idx))
    return full(outs)


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars: Sequence,
               is_test: bool = False, name=None) -> List:
    """``while cond_fn(*vars): vars = body_fn(*vars)``; returns the loop
    variables (module docstring for how each device runs it)."""
    vars_ = list(loop_vars)
    if _program.records(*vars_):
        return _program.record_while(cond_fn, body_fn, vars_)
    tensors = [v for v in vars_ if isinstance(v, torch.Tensor)]
    if any(exporting(v) for v in tensors):
        return _export_while(cond_fn, body_fn, vars_)
    if any(capturing(v) for v in tensors):
        return captured_while(cond_fn, body_fn, vars_)
    out = vars_
    while _truthy(cond_fn(*out)):
        res = body_fn(*out)
        out = list(res) if isinstance(res, (tuple, list)) else [res]
    return out


# -- case / switch_case ------------------------------------------------------------

def case(pred_fn_pairs, default=None, name=None):
    """The first branch whose predicate holds (a chain of :func:`cond`);
    with no ``default`` the last pair's function is the fallback."""
    if not pred_fn_pairs:
        raise TypeError("pred_fn_pairs may not be empty")

    def build(pairs):
        pred, fn = pairs[0]
        if len(pairs) == 1:
            if default is None:
                return fn()
            return cond(pred, fn, default)
        return cond(pred, fn, lambda: build(pairs[1:]))

    return build(list(pred_fn_pairs))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """The branch keyed by an integer index (a chain of :func:`cond`)."""
    items = (sorted(branch_fns.items()) if isinstance(branch_fns, dict)
             else list(enumerate(branch_fns)))

    def build(pairs):
        idx, fn = pairs[0]
        same = branch_index == idx
        if len(pairs) == 1:
            if default is None:
                return fn()
            return cond(same, fn, default)
        return cond(same, fn, lambda: build(pairs[1:]))

    return build(items)
