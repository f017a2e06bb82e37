"""The port's ``PyLayer`` against the JAX package's, on the CPU.

Spec: ``tests/test_py_layer.py`` (its ten cases) and
``tests/test_autograd.py::test_create_graph_pylayer_upstream_of_cut``.
Each case runs the same user layer on both packages from the same numpy
inputs; outputs and gradients agree within 1e-6 (the same f32
arithmetic), the refusals raise the same exception types.  Beyond the
spec: a ``PyLayer`` under ``torch.vmap`` (as an MoE layer's batched
experts run it) gives each sample the gradient it gives alone.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.autograd import PyLayer as JPyLayer
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu_torch.autograd import PyLayer

torch.set_num_threads(2)
ATOL = 1e-6


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _j(a, grad=True):
    return paddle.to_tensor(np.asarray(a, np.float32), stop_gradient=not grad)


def _t(a, grad=True):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _close(port, jax):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(jax.numpy()),
                               atol=ATOL, rtol=1e-6)


def _layers(base, forward, backward):
    """The same user layer as a subclass of ``base`` (either package)."""
    return type("L", (base,), {"forward": staticmethod(forward),
                               "backward": staticmethod(backward)})


def _both(forward, backward):
    return _layers(JPyLayer, forward, backward), _layers(PyLayer, forward,
                                                         backward)


def test_custom_backward_used():
    J, T = _both(lambda ctx, x: x * 2, lambda ctx, dy: dy * 10)
    jx, tx = _j([3.0]), _t([3.0])
    jy, ty = J.apply(jx), T.apply(tx)
    _close(ty, jy)
    jy.backward()
    ty.backward()
    _close(tx.grad, jx.grad)
    np.testing.assert_allclose(tx.grad.numpy(), [10.0])


def _square_fwd(ctx, x):
    ctx.save_for_backward(x)
    return x * x


def _square_bwd(ctx, dy):
    x, = ctx.saved_tensor()
    return dy * 2 * x


def test_saved_tensor_and_correct_grad():
    J, T = _both(_square_fwd, _square_bwd)
    jx, tx = _j([2.0, -3.0]), _t([2.0, -3.0])
    J.apply(jx).sum().backward()
    T.apply(tx).sum().backward()
    _close(tx.grad, jx.grad)


def test_composes_with_ops():
    def fwd(ctx, x):
        y = x.exp()
        ctx.save_for_backward(y)
        return y

    def bwd(ctx, dy):
        y, = ctx.saved_tensor()
        return dy * y

    J, T = _both(fwd, bwd)
    jx, tx = _j([0.5]), _t([0.5])
    (J.apply(jx * 2) + 1).sum().backward()
    (T.apply(tx * 2) + 1).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), [2 * math.e], rtol=1e-5)
    _close(tx.grad, jx.grad)


def test_multi_input_output():
    J, T = _both(lambda ctx, a, b: (a + b, a * b),
                 lambda ctx, da, db: (da + db * 3.0, da + db * 2.0))
    ja, jb, ta, tb = _j([2.0]), _j([3.0]), _t([2.0]), _t([3.0])
    js, jp = J.apply(ja, jb)
    ts, tp = T.apply(ta, tb)
    (js + jp).backward()
    (ts + tp).backward()
    _close(ta.grad, ja.grad)
    _close(tb.grad, jb.grad)


def test_wrong_grad_count_raises():
    J, T = _both(lambda ctx, a, b: a + b, lambda ctx, dy: dy)
    with pytest.raises(ValueError):
        J.apply(_j([1.0]), _j([1.0])).backward()
    with pytest.raises(ValueError):
        T.apply(_t([1.0]), _t([1.0])).backward()


@pytest.mark.parametrize("base", [JPyLayer, PyLayer],
                         ids=["jax", "port"])
def test_apply_override_rejected(base):
    with pytest.raises(RuntimeError):
        type("Nope", (base,), {
            "forward": staticmethod(lambda ctx, x: x),
            "backward": staticmethod(lambda ctx, dy: dy),
            "apply": classmethod(lambda cls, *a: None)})


def test_stop_gradient_input():
    J, T = _both(lambda ctx, x: x * 1, lambda ctx, dy: dy)
    jy, ty = J.apply(_j([1.0], grad=False)), T.apply(_t([1.0], grad=False))
    assert jy.stop_gradient and not ty.requires_grad


def test_passthrough_output_keeps_upstream_graph():
    J, T = _both(lambda ctx, x: x, lambda ctx, dy: dy)
    jx, tx = _j([3.0]), _t([3.0])
    (J.apply(jx * 2) * 1).sum().backward()
    (T.apply(tx * 2) * 1).sum().backward()
    _close(tx.grad, jx.grad)
    np.testing.assert_allclose(tx.grad.numpy(), [2.0])


def test_no_grad_passthrough_does_not_mutate_input():
    J, T = _both(lambda ctx, x: x, lambda ctx, dy: dy)
    jp, tp = _j([1.0]), _t([1.0])
    with paddle.no_grad():
        jout = J.apply(jp)
    with torch.no_grad():
        tout = T.apply(tp)
    assert jout.stop_gradient and not tout.requires_grad
    assert jp.stop_gradient is False and tp.requires_grad


def test_set_materialize_grads_false():
    seen = {}

    def fwd(ctx, x):
        ctx.set_materialize_grads(False)
        return x * 1, x * 2

    def bwd(ctx, d1, d2):
        seen.setdefault("d2", []).append(d2)
        return d1 if d2 is None else d2

    J, T = _both(fwd, bwd)
    jx, tx = _j([1.0]), _t([1.0])
    J.apply(jx)[0].sum().backward()
    T.apply(tx)[0].sum().backward()
    assert seen["d2"] == [None, None]
    _close(tx.grad, jx.grad)


def test_create_graph_pylayer_upstream_of_cut():
    """``test_autograd.py``'s case: a layer upstream of the input asked
    for is left out of a double-backward graph."""
    J, T = _both(lambda ctx, a: a * 2, lambda ctx, g: g * 2)
    jx, tx = _j([2.0]), _t([2.0])
    jh, th = J.apply(jx), T.apply(tx)
    (jgh,) = paddle.grad((jh * jh).sum(), jh, create_graph=True)
    (tgh,) = torch.autograd.grad((th * th).sum(), th, create_graph=True)
    _close(tgh, jgh)
    np.testing.assert_allclose(tgh.detach().numpy(), [8.0], rtol=1e-5)


def test_kwargs_receive_no_gradient():
    """Paddle's contract (``py_layer.py:112-116``): only positional tensors
    that need a gradient are given one."""
    J, T = _both(lambda ctx, x, scale=None: x * scale,
                 lambda ctx, dy: dy * 3.0)
    jx, tx = _j([1.0, 2.0]), _t([1.0, 2.0])
    js, ts = _j([2.0, 2.0]), _t([2.0, 2.0])
    J.apply(jx, scale=js).sum().backward()
    T.apply(tx, scale=ts).sum().backward()
    _close(tx.grad, jx.grad)
    assert ts.grad is None


def test_under_vmap_each_sample_as_alone():
    T = _layers(PyLayer, _square_fwd, _square_bwd)
    x = torch.tensor(np.random.RandomState(0).randn(3, 4).astype(np.float32),
                     requires_grad=True)
    torch.vmap(T.apply)(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * x.detach().numpy(),
                               atol=ATOL)
