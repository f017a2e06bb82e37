"""The port's tensor-op surface against the JAX package's, on the CPU.

Every ``OpSpec`` row of ``tests/test_op_suite.py`` (here) and
``tests/test_op_suite_extra.py`` (``tests/test_torch_ops_extra.py``) is
one case: the same seeded numpy
inputs (the harness's draws) through the JAX op and the port's
(``tests/torch_op_rows.py`` evaluates the row tables with ``paddle``
bound to the port), the forward outputs held to each other at the row's
stated ``rtol``/``atol`` (integers and bools exactly; the port keeps
int64 where the JAX package narrows to int32, so values are compared,
not dtypes), and for a differentiable row the port's autograd gradients
held to the JAX tape's at ``GRAD_RTOL``/``GRAD_ATOL`` (two analytic
gradients of the same f32 arithmetic).  The method cross-check of the
harness is skipped: the port has no Tensor wrapper.  Random rows are held
to their laws (``torch_op_rows.law_ok``), ``qr``'s R in magnitude (its
signs are free).

Then the names the port exports and ``to_tensor``.  The places where
Paddle's meaning differs from torch's are in ``tests/test_torch_op_traps.py``
(the three files keep each xdist worker's share short).
"""
import ast
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
import torch_op_rows as R
from op_harness import _to_scalar_loss
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed import mesh as mesh_mod
from test_op_suite import SPECS
from test_op_suite_extra import SPECS2

torch.set_num_threads(2)

#: port autograd against the JAX tape, both analytic, in f32
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5

PORT_ROWS = R.load_rows(paddle)
JAX_ROWS = {s.name: s for s in list(SPECS) + list(SPECS2)}
#: this file's rows: ``test_op_suite.py``'s (``test_torch_ops_extra.py``
#: runs ``test_op_suite_extra.py``'s)
ROWS = sorted(s.name for s in SPECS)


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    with paddle.device_guard("cpu"):
        yield
    mesh_mod.set_global_mesh(saved)


def _jax_leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _jax_leaves(o)]
    return [out]


def run_jax(spec, seed: int = 0) -> dict:
    """The JAX op on the harness's inputs: outputs and tape gradients in
    :func:`torch_op_rows.run_row`'s layout."""
    arrays = R.sample(spec, seed)
    ts = []
    for a, i in zip(arrays, spec.inputs):
        t = jpaddle.to_tensor(a)
        if spec.grad and not i.no_grad and a.dtype.kind == "f":
            t.stop_gradient = False
        ts.append(t)
    out = spec.resolve()(*ts, **spec.kwargs)
    grads = [None] * len(ts)
    if spec.grad:
        loss = _to_scalar_loss(out)
        if loss is not None:
            loss.backward()
            for j, (t, i) in enumerate(zip(ts, spec.inputs)):
                if not t.stop_gradient:
                    g = t.grad
                    grads[j] = (np.zeros(a.shape, np.float32) if g is None
                                else np.asarray(g.numpy()))
    return {"out": [np.asarray(o.numpy()) if isinstance(o, JTensor)
                    else np.asarray(o) for o in _jax_leaves(out)],
            "grads": grads}


def check_row(name):
    """The port's row ``name`` against the JAX row."""
    jspec, spec = JAX_ROWS[name], PORT_ROWS[name]
    R.compare(spec, R.run_row(spec, "cpu"), run_jax(jspec),
              spec.rtol, spec.atol, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("name", ROWS)
def test_row_matches_jax(name):
    check_row(name)


def test_every_row_is_enrolled():
    assert sorted(PORT_ROWS) == sorted(JAX_ROWS) and len(PORT_ROWS) == 362


# -- the exported surface -----------------------------------------------------

#: public names of the JAX op modules that the port leaves out, and why
NOT_EXPORTED = {}


def _public_functions(path):
    tree = ast.parse(open(path).read())
    names = set()
    for n in tree.body:
        if isinstance(n, ast.FunctionDef) and not n.name.startswith("_"):
            names.add(n.name)
        if isinstance(n, ast.Assign):
            names |= {t.id for t in n.targets if isinstance(t, ast.Name)
                      and not t.id.startswith("_") and t.id != "__all__"}
    return names


def test_every_jax_op_is_exported():
    root = os.path.join(os.path.dirname(os.path.abspath(jpaddle.__file__)),
                        "ops")
    missing = []
    for mod in ("math", "manipulation", "creation", "search", "logic",
                "linalg", "random", "misc"):
        for name in sorted(_public_functions(os.path.join(root,
                                                          mod + ".py"))):
            if not callable(getattr(paddle, name, None)) and \
                    name not in NOT_EXPORTED:
                missing.append(f"{mod}.{name}")
    assert not missing, missing
    for name in ("to_tensor", "float32", "int64", "bool", "bfloat16",
                 "get_default_dtype", "set_default_dtype", "no_grad",
                 "grad", "reverse", "create_parameter", "finfo", "iinfo",
                 "is_compiled_with_cuda", "get_cudnn_version",
                 "get_cuda_rng_state", "set_cuda_rng_state", "batch"):
        assert hasattr(paddle, name), name
    from paddle_tpu_torch.ops import flash_attention, rotary_embedding  # noqa
    assert paddle.float32 is torch.float32 and paddle.bool is torch.bool


def _np(t):
    return t.detach().cpu().numpy()


def test_to_tensor_and_helpers():
    t = paddle.to_tensor([[1.0, 2.0]], stop_gradient=False)
    assert t.dtype == torch.float32 and t.requires_grad
    assert paddle.to_tensor(np.arange(3)).dtype == torch.int64
    assert paddle.to_tensor(np.ones(2)).dtype == torch.float32
    assert paddle.to_tensor([1, 2], dtype="float64").dtype == torch.float64
    src = np.zeros(3, np.float32)
    paddle.to_tensor(src).add_(1)
    assert src.sum() == 0
    assert paddle.finfo("float16").max == 65504.0
    assert paddle.iinfo(paddle.int32).max == 2 ** 31 - 1
    np.testing.assert_array_equal(
        _np(paddle.reverse(torch.arange(4), axis=[0])), [3, 2, 1, 0])
    p = paddle.create_parameter([3, 2], "float32")
    assert p.shape == (3, 2) and p.requires_grad
    assert paddle.is_compiled_with_xpu() is False
    assert paddle.version.cuda() == (torch.version.cuda or "False")
    batches = list(paddle.batch(lambda: iter(range(5)), 2)())
    assert batches == [[0, 1], [2, 3], [4]]
    with paddle.no_grad():
        assert not paddle.is_grad_enabled()
