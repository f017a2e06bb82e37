"""The port's extension points against the JAX package's, on the CPU.

Spec: ``tests/test_custom_kernel.py`` (every case has a counterpart
here): ``register_op`` (autograd from ``fn`` itself and from a ``vjp``),
``register_kernel`` over a built-in op and scoped to a backend, and
``cpp_extension.load`` of the spec's C++ source (eager, against
``softsign``, inside ``to_static``), each on the same seeded numpy inputs
in both packages, within 1e-6.  Beyond the spec: a registered op and a
C++ op are one op of a recording static program and of ``torch.export``;
an override reaches a recorded program's replay; ``hub`` and ``onnx``
behave as the JAX package's.
"""
import os
import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import hub as jhub
from paddle_tpu.utils import (register_kernel as jregister_kernel,
                              register_op as jregister_op,
                              unregister_kernel as junregister_kernel)
import paddle_tpu_torch as pt
from paddle_tpu_torch import hub, static
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.utils import (cpp_extension, register_kernel,
                                    register_op, unregister_kernel)

ATOL = 1e-6
HERE = os.path.dirname(os.path.abspath(__file__))


def _spec_cpp_src() -> str:
    """``CPP_SRC`` of the spec file (read, so that both packages build
    the same source)."""
    with open(os.path.join(HERE, "test_custom_kernel.py")) as f:
        return re.search(r'CPP_SRC = r"""(.*?)"""', f.read(), re.S).group(1)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=1e-6)


class TestRegisterOp:
    def test_new_op_with_autograd(self):
        x0 = np.array([1.0, 2.0, -0.5], np.float32)
        jop = jregister_op("port_cube", lambda x: x ** 3)
        jx = paddle.to_tensor(x0, stop_gradient=False)
        jy = jop(jx)
        jy.sum().backward()
        op = register_op("port_cube", lambda x: x ** 3)
        try:
            x = torch.tensor(x0, requires_grad=True)
            y = op(x)
            y.sum().backward()
            _close(y.detach(), np.asarray(jy.numpy()))
            _close(x.grad, np.asarray(jx.grad))
            _close(x.grad, 3 * x0 ** 2)
        finally:
            unregister_kernel("port_cube")
            junregister_kernel("port_cube")

    def test_custom_vjp(self):
        import jax.numpy as jnp

        jop = jregister_op("port_customgrad", lambda x: x * 2.0,
                           vjp=lambda res, g: (jnp.full_like(res[0], 10.0),))
        op = register_op("port_customgrad", lambda x: x * 2.0,
                         vjp=lambda res, g: (torch.full_like(res[0], 10.0),))
        try:
            jx = paddle.to_tensor(np.array([3.0], np.float32),
                                  stop_gradient=False)
            jop(jx).sum().backward()
            x = torch.tensor([3.0], requires_grad=True)
            op(x).sum().backward()
            _close(x.grad, np.asarray(jx.grad))
            _close(x.grad, [10.0])
        finally:
            unregister_kernel("port_customgrad")
            junregister_kernel("port_customgrad")

    def test_kernel_override_of_builtin(self):
        x0 = np.array([-1.0, 5.0], np.float32)
        try:
            register_kernel("relu", lambda x, name=None: x * 0.0 + 42.0)
            jregister_kernel("relu", lambda x: x * 0.0 + 42.0)
            got = F.relu(torch.tensor(x0))
            want = paddle.nn.functional.relu(paddle.to_tensor(x0))
            _close(got, np.asarray(want.numpy()))
            _close(got, 42.0)
        finally:
            unregister_kernel("relu")
            junregister_kernel("relu")
        _close(F.relu(torch.tensor(x0)), [0.0, 5.0])

    def test_backend_scoped_override_ignored_on_other_backend(self):
        """A kernel for the gpu backend: CPU tensors keep the op's own (the
        JAX package scopes by ``jax.default_backend()``, the port by the
        tensor's device); one for the cpu backend takes them."""
        x = torch.tensor([0.0])
        try:
            register_kernel("sigmoid", lambda x, name=None: x * 0.0,
                            backend="gpu")
            _close(pt.sigmoid(x), [0.5])
            register_kernel("sigmoid", lambda x, name=None: x * 0.0 + 7.0,
                            backend="cpu")
            _close(pt.sigmoid(x), [7.0])
        finally:
            unregister_kernel("sigmoid", backend="gpu")
            unregister_kernel("sigmoid", backend="cpu")
        _close(pt.sigmoid(x), [0.5])
        with pytest.raises(ValueError):
            register_kernel("sigmoid", lambda x: x, backend="tpu")

    def test_registered_op_is_one_op_of_a_program_and_an_export(self):
        op = register_op("port_square_plus", lambda x: x * x + 1.0)
        try:
            with pt.device_guard("cpu"):
                pt.enable_static()
                try:
                    main = static.Program()
                    with static.program_guard(main):
                        x = static.data("x", [3], "float32")
                        y = op(x * 2)
                finally:
                    pt.disable_static()
            assert [o.name for o in main.ops] == ["mul", "port_square_plus"]
            a = np.array([1.0, -2.0, 0.5], np.float32)
            r, = static.Executor().run(main, feed={"x": a}, fetch_list=[y])
            _close(r, (2 * a) ** 2 + 1)

            class M(torch.nn.Module):
                def forward(self, t):
                    return op(t) - 1.0
            ep = torch.export.export(M(), (torch.ones(3),))
            targets = [str(n.target) for n in ep.graph.nodes
                       if n.op == "call_function"]
            assert any("paddle_tpu_ext.port_square_plus" in t
                       for t in targets)
        finally:
            unregister_kernel("port_square_plus")

    def test_override_reaches_a_recorded_program(self):
        with pt.device_guard("cpu"):
            pt.enable_static()
            try:
                main = static.Program()
                with static.program_guard(main):
                    x = static.data("x", [2], "float32")
                    y = F.relu(x)
            finally:
                pt.disable_static()
        a = np.array([-1.0, 3.0], np.float32)
        exe = static.Executor()
        _close(exe.run(main, feed={"x": a}, fetch_list=[y])[0], [0.0, 3.0])
        try:
            register_kernel("relu", lambda x, name=None: x * 2.0,
                            backend="cpu")
            _close(exe.run(main, feed={"x": a}, fetch_list=[y])[0],
                   [-2.0, 6.0])
            compiled = pt.jit.to_static(lambda t: F.relu(t) + 1.0)
            _close(compiled(torch.tensor(a)), [-1.0, 7.0])
        finally:
            unregister_kernel("relu", backend="cpu")


class TestCppExtension:
    @pytest.fixture(scope="class")
    def exts(self, tmp_path_factory):
        from paddle_tpu.utils import cpp_extension as jcpp

        d = tmp_path_factory.mktemp("ext")
        src = d / "my_ops.cc"
        src.write_text(_spec_cpp_src())
        fns = {"twice_plus_one": {}, "softsign_ref": {}}
        jmod = jcpp.load("my_ops_jax", [str(src)], functions=fns,
                         build_directory=str(d / "jax"))
        mod = cpp_extension.load("my_ops", [str(src)], functions=fns,
                                 build_directory=str(d / "port"))
        yield mod, jmod
        junregister_kernel("my_ops_jax.twice_plus_one")
        junregister_kernel("my_ops_jax.softsign_ref")

    def test_eager_call(self, exts):
        mod, jmod = exts
        x0 = np.array([1.0, -2.0], np.float32)
        got = mod.twice_plus_one(torch.tensor(x0))
        _close(got, np.asarray(jmod.twice_plus_one(
            paddle.to_tensor(x0)).numpy()))
        _close(got, [3.0, -3.0])

    def test_matches_python_op(self, exts):
        mod, jmod = exts
        x0 = np.random.RandomState(0).randn(8).astype(np.float32)
        got = mod.softsign_ref(torch.tensor(x0))
        _close(got, F.softsign(torch.tensor(x0)))
        _close(got, np.asarray(jmod.softsign_ref(
            paddle.to_tensor(x0)).numpy()))

    def test_under_jit(self, exts):
        mod, jmod = exts
        f = pt.jit.to_static(lambda x: mod.twice_plus_one(x) * 2.0)
        jf = paddle.jit.to_static(lambda x: jmod.twice_plus_one(x) * 2.0)
        for v in ([1.0], [2.5]):
            got = f(torch.tensor(v))
            _close(got, np.asarray(jf(paddle.to_tensor(
                np.array(v, np.float32))).numpy()))
        _close(got, [12.0])

    def test_one_op_of_a_program(self, exts):
        mod, _ = exts
        with pt.device_guard("cpu"):
            pt.enable_static()
            try:
                main = static.Program()
                with static.program_guard(main):
                    x = static.data("x", [2], "float32")
                    y = mod.softsign_ref(x) + 1.0
            finally:
                pt.disable_static()
        assert [o.name for o in main.ops][0] == "my_ops.softsign_ref"
        a = np.array([3.0, -1.0], np.float32)
        r, = static.Executor().run(main, feed={"x": a}, fetch_list=[y])
        _close(r, a / (1 + np.abs(a)) + 1.0)

    def test_build_is_kept_by_hash(self, exts, tmp_path):
        mod, _ = exts
        again = cpp_extension.load(
            "my_ops", [os.path.join(os.path.dirname(os.path.dirname(
                mod.lib_path)), "my_ops.cc")],
            functions={"twice_plus_one": {}},
            build_directory=os.path.dirname(mod.lib_path))
        assert again.lib_path == mod.lib_path


HUBCONF = '''
def answer(x=1):
    """Twice x."""
    return x * 2


def _hidden():
    return 0
'''


class TestHubAndOnnx:
    def test_local_hub_equals_jax(self, tmp_path):
        (tmp_path / "hubconf.py").write_text(HUBCONF)
        d = str(tmp_path)
        assert hub.list(d) == jhub.list(d) == ["answer"]
        assert hub.help(d, "answer") == jhub.help(d, "answer") == "Twice x."
        assert hub.load(d, "answer", x=21) == jhub.load(d, "answer",
                                                          x=21) == 42
        for mod in (hub, jhub):
            with pytest.raises(RuntimeError):
                mod.load(d, "missing")
            with pytest.raises(RuntimeError):
                mod.list("someone/repo", source="github")
            with pytest.raises(ValueError):
                mod.list(d, source="ftp")
            with pytest.raises(FileNotFoundError):
                mod.list(str(tmp_path / "nowhere"))

    def test_onnx_export_raises_as_jax(self):
        from paddle_tpu import onnx as jonnx

        for mod in (pt.onnx, jonnx):
            with pytest.raises(RuntimeError, match="paddle2onnx"):
                mod.export(None, "model")
