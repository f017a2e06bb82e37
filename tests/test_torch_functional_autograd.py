"""The port's ``incubate.autograd`` (``vjp``, ``jvp``, ``Jacobian``,
``Hessian``) against the JAX package's, on the CPU.

Spec: the eleven cases of ``tests/test_functional_autograd.py``, each run
on both packages from the same numpy inputs: values agree within 1e-5
relative (both exact in f32 for these polynomials), shapes equal, and the
refusals raise the same exception types.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.incubate import autograd as JF
from paddle_tpu_torch.incubate import autograd as F

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t if isinstance(t, np.ndarray) else t.numpy())


def _close(port, jax):
    np.testing.assert_allclose(_np(port), _np(jax), rtol=1e-5, atol=1e-6)


def _pair(a):
    a = np.asarray(a, np.float32)
    return paddle.to_tensor(a), torch.tensor(a)


def test_vjp_default_cotangent():
    jx, tx = _pair([1.0, 2.0, 3.0])
    jo, jg = JF.vjp(lambda a: a * a, jx)
    to, tg = F.vjp(lambda a: a * a, tx)
    _close(to, jo)
    _close(tg, jg)
    np.testing.assert_allclose(_np(tg), [2, 4, 6])


def test_vjp_custom_cotangent():
    jx, tx = _pair([1.0, 2.0])
    jv, tv = _pair([10.0, 100.0])
    _close(F.vjp(lambda a: a * 3, tx, tv)[1],
           JF.vjp(lambda a: a * 3, jx, jv)[1])


def test_jvp():
    jx, tx = _pair([2.0, 3.0])
    jv, tv = _pair([1.0, 0.0])
    jo, jt = JF.jvp(lambda a: a * a, jx, jv)
    to, tt = F.jvp(lambda a: a * a, tx, tv)
    _close(to, jo)
    _close(tt, jt)
    np.testing.assert_allclose(_np(tt), [4, 0])


def test_jacobian():
    jx, tx = _pair([1.0, 2.0])
    J = JF.Jacobian(lambda a: paddle.concat([a * a, a.sum().reshape([1])]),
                    jx)
    T = F.Jacobian(lambda a: torch.cat([a * a, a.sum().reshape([1])]), tx)
    assert T.shape == J.shape == [3, 2]
    _close(T.numpy(), J.numpy())
    _close(T[1], J[1])


def test_jacobian_multi_input():
    ja, ta = _pair([1.0, 2.0])
    jb, tb = _pair([3.0])
    J = JF.Jacobian(lambda x, y: x * y, [ja, jb])
    T = F.Jacobian(lambda x, y: x * y, [ta, tb])
    assert T.shape == J.shape == [2, 3]
    _close(T.numpy(), J.numpy())


def test_hessian():
    jx, tx = _pair([1.0, 2.0])
    H = JF.Hessian(lambda a: (a * a * a).sum(), jx)
    T = F.Hessian(lambda a: (a * a * a).sum(), tx)
    assert T.shape == H.shape == [2, 2]
    _close(T.numpy(), H.numpy())


def test_hessian_scalar_check():
    jx, tx = _pair([1.0, 2.0])
    with pytest.raises(ValueError):
        JF.Hessian(lambda a: a * 2, jx).numpy()
    with pytest.raises(ValueError):
        F.Hessian(lambda a: a * 2, tx).numpy()


def test_multi_output_jacobian():
    jx, tx = _pair([1.0, 2.0])
    J = JF.Jacobian(lambda a: (a * a, a.sum().reshape([1])), jx)
    T = F.Jacobian(lambda a: (a * a, a.sum().reshape([1])), tx)
    assert T.shape == J.shape == [3, 2]
    _close(T.numpy(), J.numpy())


def test_batched_jacobian():
    jx, tx = _pair(np.arange(6, dtype=np.float32).reshape(3, 2))
    J = JF.Jacobian(lambda a: a * a, jx, is_batched=True)
    T = F.Jacobian(lambda a: a * a, tx, is_batched=True)
    assert T.shape == J.shape == [3, 2, 2]
    _close(T.numpy(), J.numpy())


def test_batched_hessian():
    jx, tx = _pair(np.ones((2, 3), np.float32))
    H = JF.Hessian(lambda a: (a ** 3).sum(axis=1), jx, is_batched=True)
    T = F.Hessian(lambda a: (a ** 3).sum(dim=1), tx, is_batched=True)
    assert T.shape == H.shape == [2, 3, 3]
    _close(T.numpy(), H.numpy())


def test_batched_multi_input_raises():
    jx, tx = _pair(np.ones((2, 2), np.float32))
    with pytest.raises(NotImplementedError):
        JF.Jacobian(lambda a, b: a + b, [jx, jx], is_batched=True).numpy()
    with pytest.raises(NotImplementedError):
        F.Jacobian(lambda a, b: a + b, [tx, tx], is_batched=True).numpy()


def test_prim_switch_is_state():
    for mod in (JF, F):
        assert not mod.prim_enabled()
        mod.enable_prim()
        assert mod.prim_enabled()
        mod.disable_prim()
        assert not mod.prim_enabled() and mod.prim2orig() is None
