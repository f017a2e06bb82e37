"""The op-suite schema rows as data for the port.

``tests/test_op_suite.py`` and ``tests/test_op_suite_extra.py`` declare
one ``OpSpec`` row per op (its sample inputs, keyword arguments,
tolerances and, for some, a function of ``paddle`` and ``F``).  Their
module imports the JAX package, so this module reads their source and
evaluates the row tables alone, with ``paddle`` bound to the port
(``paddle_tpu_torch``) and ``F`` to its ``nn.functional``: a row's
function then calls the port's ops.  It imports numpy, torch and the
port only (``chip_smoke.py`` runs the rows on the card with it).

:func:`run_row` runs a row on one device: the seeded numpy inputs of the
JAX harness (``RandomState(seed)``, inputs sampled in order), the forward,
and for a differentiable row the gradient of the sum of its floating
outputs with respect to each floating input.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SUITES = (("test_op_suite.py", "SPECS"), ("test_op_suite_extra.py",
                                          "SPECS2"))

#: rows whose draws are random: held to their law, not to values
RANDOM = {"rand_like", "randn_like", "randint_like", "bernoulli",
          "poisson_op", "multinomial", "standard_normal_like",
          "uniform_like", "gumbel_softmax"}

#: rows whose values are free up to signs (compared in magnitude)
SIGN_FREE = {"qr"}


@dataclass
class Inp:
    """``op_harness.Inp``: one sample input (the same draws)."""
    shape: Tuple[int, ...]
    dtype: str = "float32"
    low: float = -1.0
    high: float = 1.0
    positive: bool = False
    int_high: int = 8
    no_grad: bool = False

    def sample(self, rs: np.random.RandomState):
        if self.dtype.startswith(("int", "uint", "bool")):
            if self.dtype == "bool":
                return rs.rand(*self.shape) > 0.5
            return rs.randint(0, self.int_high,
                              self.shape).astype(self.dtype)
        a = rs.uniform(self.low, self.high, self.shape)
        if self.positive:
            a = np.abs(a) + 0.5
        return a.astype(self.dtype)


@dataclass
class OpSpec:
    """``op_harness.OpSpec``'s fields."""
    name: str
    inputs: Sequence[Inp]
    fn: Optional[Callable] = None
    kwargs: dict = field(default_factory=dict)
    ref: Optional[Callable] = None
    grad: bool = True
    dtypes: Sequence[str] = ("float32",)
    method: Optional[str] = None
    rtol: float = 1e-5
    atol: float = 1e-6
    grad_rtol: float = 2e-2
    grad_atol: float = 1e-3
    eps: float = 1e-3
    grad_probes: int = 32


def _overrides(paddle) -> Dict[str, Callable]:
    """Rows whose function calls a Tensor method that means something
    else on ``torch.Tensor`` (the port has no Tensor wrapper): the same
    computation through the op function."""
    F = paddle.nn.functional

    def signs(t):
        # Paddle's t.numpy() copies a card's tensor to the host; torch's
        # refuses one
        return paddle.to_tensor(np.sign(t.detach().cpu().numpy()).astype(
            np.float32))

    return {
        # Paddle's x.sort() is the values; torch's is (values, indices)
        "unique_consecutive": lambda a: paddle.unique_consecutive(
            paddle.sort(a)),
        "soft_margin_loss": lambda a, b: F.soft_margin_loss(a, signs(b)),
        "margin_ranking_loss": lambda a, b, c: F.margin_ranking_loss(
            a, b, signs(c)),
    }


def _keep(node) -> bool:
    if isinstance(node, (ast.Import, ast.ImportFrom, ast.ClassDef,
                         ast.Assert)):
        return False
    if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
        return False
    return not any(isinstance(n, ast.Name) and n.id == "pytest"
                   for n in ast.walk(node))


def load_rows(paddle=None) -> Dict[str, OpSpec]:
    """Every row of both suites by name, its function resolved on the
    port (``paddle``: ``paddle_tpu_torch`` unless given)."""
    if paddle is None:
        import paddle_tpu_torch as paddle
    F = paddle.nn.functional
    over = _overrides(paddle)
    rows: Dict[str, OpSpec] = {}
    for fname, table in SUITES:
        path = os.path.join(HERE, fname)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        body = [n for n in tree.body if _keep(n)]
        ns = {"np": np, "paddle": paddle, "F": F, "Inp": Inp,
              "OpSpec": OpSpec, "__name__": "torch_op_rows"}
        exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"),
             ns)
        for spec in ns[table]:
            if spec.name in rows:
                raise ValueError(f"row {spec.name} is in both suites")
            if spec.name in over:
                spec.fn = over[spec.name]
            elif spec.fn is None:
                spec.fn = getattr(paddle, spec.name, None) or getattr(
                    F, spec.name)
            rows[spec.name] = spec
    return rows


def sample(spec: OpSpec, seed: int = 0):
    rs = np.random.RandomState(seed)
    return [i.sample(rs) for i in spec.inputs]


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _floating(t) -> bool:
    return isinstance(t, torch.Tensor) and (t.is_floating_point())


def run_row(spec: OpSpec, device, seed: int = 0) -> dict:
    """``{"out": [numpy leaves], "grads": [numpy or None per input]}`` of
    ``spec`` on ``device`` (under the port's ``device_guard``, so tensors
    a row makes itself land there too)."""
    import paddle_tpu_torch as paddle

    arrays = sample(spec, seed)
    with paddle.device_guard(device):
        ts = []
        for a, i in zip(arrays, spec.inputs):
            t = torch.tensor(a, device=device)
            if spec.grad and not i.no_grad and a.dtype.kind == "f":
                t.requires_grad_(True)
            ts.append(t)
        out = spec.fn(*ts, **spec.kwargs)
        leaves = _leaves(out)
        grads = [None] * len(ts)
        if spec.grad:
            floats = [o for o in leaves if _floating(o) and o.requires_grad]
            wrt = [t for t in ts if t.requires_grad]
            if floats and wrt:
                loss = sum(o.float().sum() for o in floats)
                got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
                for j, t in enumerate(ts):
                    if t.requires_grad:
                        g = next(got)
                        grads[j] = (np.zeros(t.shape, np.float32) if g is None
                                    else g.detach().cpu().numpy())
    return {"out": [o.detach().cpu().numpy() if isinstance(o, torch.Tensor)
                    else np.asarray(o) for o in leaves],
            "grads": grads}


def law_ok(name: str, out: np.ndarray, inputs) -> bool:
    """A random row's draw holds its law's support and shape."""
    if name in ("rand_like", "uniform_like"):
        lo = 0.0 if name == "rand_like" else -1.0
        return bool(((out >= lo) & (out < 1.0)).all())
    if name in ("randn_like", "standard_normal_like"):
        return bool(np.isfinite(out).all() and (np.abs(out) < 10).all())
    if name == "randint_like":
        return bool(((out >= 0) & (out < 5) & (out == np.round(out))).all())
    if name == "bernoulli":
        return bool(np.isin(out, (0.0, 1.0)).all())
    if name == "poisson_op":
        return bool(((out >= 0) & (out == np.round(out))).all())
    if name == "multinomial":
        return bool(((out >= 0) & (out < inputs[0].shape[-1])).all()
                    and all(len(set(r)) == len(r) for r in out.tolist()))
    if name == "gumbel_softmax":
        return bool(np.allclose(out.sum(-1), 1.0, atol=1e-5)
                    and (out >= 0).all())
    raise KeyError(name)


def compare(spec: OpSpec, got: dict, want: dict, rtol: float, atol: float,
            grad_rtol: float, grad_atol: float) -> float:
    """Hold ``got`` to ``want`` (two :func:`run_row` results, or the same
    layout): equal shapes, values within ``rtol``/``atol`` (integers and
    bools exactly), gradients within ``grad_rtol``/``grad_atol``; a random
    row's draws each hold its law.  Returns the largest absolute
    difference seen; raises ``AssertionError`` on a mismatch."""
    worst = 0.0
    if len(got["out"]) != len(want["out"]):
        raise AssertionError(f"{spec.name}: {len(got['out'])} outputs, "
                             f"want {len(want['out'])}")
    for k, (g, w) in enumerate(zip(got["out"], want["out"])):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape:
            raise AssertionError(f"{spec.name} output {k}: shape {g.shape}, "
                                 f"want {w.shape}")
        if spec.name in RANDOM:
            if not law_ok(spec.name, g, sample(spec)):
                raise AssertionError(f"{spec.name}: a draw outside its law")
            continue
        if spec.name in SIGN_FREE:
            g, w = np.abs(g), np.abs(w)
        dt = np.complex128 if np.iscomplexobj(g) or np.iscomplexobj(w) \
            else np.float64
        g64, w64 = g.astype(dt), w.astype(dt)
        exact = w.dtype.kind in "biu" and g.dtype.kind in "biu"
        if g64.size:
            worst = max(worst, float(np.nanmax(np.abs(g64 - w64))))
        np.testing.assert_allclose(
            g64, w64, rtol=0 if exact else rtol, atol=0 if exact else atol,
            err_msg=f"{spec.name} output {k}")
    for k, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        if w is None and g is None:
            continue
        if (w is None) != (g is None):
            raise AssertionError(f"{spec.name}: gradient of input {k} is "
                                 f"missing on one side")
        g64, w64 = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if g64.size:
            worst = max(worst, float(np.abs(g64 - w64).max()))
        np.testing.assert_allclose(g64, w64, rtol=grad_rtol, atol=grad_atol,
                                   err_msg=f"{spec.name} grad of input {k}")
    return worst
