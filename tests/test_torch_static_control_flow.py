"""``static.cond``, ``static.while_loop``, ``case`` and ``switch_case`` of
the port against the JAX package's, on the CPU.

Spec: the cond / while / case cases of ``tests/test_static_control_flow.py``.
The JAX package runs them eagerly (a concrete predicate) and compiled
(``to_static``: ``lax.cond`` / ``lax.while_loop``).  The port runs the
eager path on the CPU (a ``to_static`` program runs its body there) and
its traced path under ``torch.export`` (``torch.cond`` /
``torch.while_loop``); each is held to the JAX result on the same seeded
numpy inputs (tolerance in each test).  The captured path (CUDA graph IF
and WHILE nodes) is held on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import static as jstatic
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu_torch import jit, static

torch.set_num_threads(2)

#: the same f32 arithmetic on both sides
RTOL = 1e-6


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def exported(fn, *args):
    """``fn`` through the port's traced path: ``torch.export`` of a module
    calling it (its branches and loops become ``torch.cond`` /
    ``torch.while_loop``), returned as a callable program."""

    class M(torch.nn.Module):
        def forward(self, *a):
            return fn(*a)

    return jit.export_program(M(), tuple(args)).module()


def np_of(v):
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


class TestCondEager:
    def test_takes_branch_and_grads(self):
        a = np.array([2.0, 3.0], np.float32)
        jx = paddle.to_tensor(a)
        jx.stop_gradient = False
        jout = jstatic.cond(paddle.to_tensor(True), lambda v: (v * 2).sum(),
                            lambda v: (v * 3).sum(), operands=(jx,))
        jout.backward()
        x = torch.tensor(a, requires_grad=True)
        out = static.cond(torch.tensor(True), lambda v: (v * 2).sum(),
                          lambda v: (v * 3).sum(), operands=(x,))
        out.backward()
        np.testing.assert_allclose(x.grad.numpy(), np_of(jx.grad), rtol=RTOL)
        np.testing.assert_allclose(out.item(), float(jout), rtol=RTOL)

    def test_false_branch(self):
        a = np.array([1.0], np.float32)
        jout = jstatic.cond(paddle.to_tensor(False), lambda v: v * 2,
                            lambda v: v * 3, operands=(paddle.to_tensor(a),))
        out = static.cond(torch.tensor(False), lambda v: v * 2,
                          lambda v: v * 3, operands=(torch.tensor(a),))
        assert float(out) == float(jout) == 3.0


class TestCondCompiled:
    def test_data_dependent_branch_under_jit(self):
        """One program over both signs: the JAX ``lax.cond``, the port's
        ``torch.cond`` (exported once at the positive input); the port's
        ``to_static`` on the CPU runs the branch eagerly."""

        def f_jax(x):
            return jstatic.cond(x.sum() > 0, lambda a: a * 2.0,
                                lambda a: a - 1.0, operands=(x,))

        def f(x):
            return static.cond(x.sum() > 0, lambda a: a * 2.0,
                               lambda a: a - 1.0, operands=(x,))

        jf = paddle.jit.to_static(f_jax)
        pf = jit.to_static(f)
        pos = np.array([1.0, 2.0], np.float32)
        neg = np.array([-1.0, -2.0], np.float32)
        prog = exported(f, torch.from_numpy(pos))
        for a in (pos, neg):
            want = np_of(jf(paddle.to_tensor(a)))
            np.testing.assert_allclose(pf(torch.from_numpy(a)).numpy(),
                                       want, rtol=RTOL)
            np.testing.assert_allclose(prog(torch.from_numpy(a)).numpy(),
                                       want, rtol=RTOL)
        assert any("cond" in str(n.target) for n in prog.graph.nodes)

    def test_grads_through_compiled_cond(self):
        """A linear layer in one branch, zeros in the other, SGD: five steps
        of the JAX compiled step and of the port's, same weights and data
        (losses within 1e-5 relative, and falling)."""
        import paddle_tpu.nn as jnn

        paddle.seed(0)
        jlin = jnn.Linear(3, 3)
        jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                    parameters=jlin.parameters())

        @paddle.jit.to_static
        def jstep(x, y):
            h = jstatic.cond(x.sum() > 0, jlin.forward, lambda a: a * 0.0,
                             operands=(x,))
            loss = ((h - y) ** 2).mean()
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            return loss

        from paddle_tpu_torch.optimizer import SGD

        lin = torch.nn.Linear(3, 3)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(np_of(jlin.weight).T.copy()))
            lin.bias.copy_(torch.from_numpy(np_of(jlin.bias)))
        opt = SGD(lin.parameters(), lr=0.1)

        @jit.to_static
        def step(x, y):
            h = static.cond(x.sum() > 0, lin.forward, lambda a: a * 0.0,
                            operands=(x,))
            loss = ((h - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        rs = np.random.RandomState(0)
        x = np.abs(rs.randn(4, 3)).astype(np.float32)
        y = rs.randn(4, 3).astype(np.float32)
        jl = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))
              for _ in range(5)]
        pl = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for _ in range(5)]
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
        assert pl[-1] < pl[0]


class TestWhileLoop:
    def test_eager(self):
        ji, js = jstatic.while_loop(
            lambda i, s: i < 5, lambda i, s: (i + 1, s + 2.0),
            [paddle.to_tensor(np.int32(0)), paddle.to_tensor(np.float32(0))])
        i, s = static.while_loop(lambda i, s: i < 5,
                                 lambda i, s: (i + 1, s + 2.0),
                                 [torch.tensor(0), torch.tensor(0.0)])
        assert int(i) == int(ji) == 5 and float(s) == float(js) == 10.0

    def test_compiled(self):
        """A data-dependent trip count in one program: the JAX
        ``lax.while_loop`` and the port's ``torch.while_loop`` (exported
        at n 4, run at 4 and 6), exact."""

        def f_jax(n, x):
            def body(i, acc):
                return i + 1, acc * 2.0

            i, acc = jstatic.while_loop(
                lambda i, acc: i < n, body,
                [paddle.to_tensor(np.int32(0)) * 0 + 0, x])
            return acc

        def f(n, x):
            def body(i, acc):
                return i + 1, acc * 2.0

            i, acc = static.while_loop(lambda i, acc: i < n, body,
                                       [n * 0, x])
            return acc

        jf = paddle.jit.to_static(f_jax)
        x = np.array([1.0], np.float32)
        prog = exported(f, torch.tensor(4), torch.from_numpy(x))
        for n in (4, 6):
            want = np_of(jf(paddle.to_tensor(np.int32(n)),
                            paddle.to_tensor(x)))
            got = prog(torch.tensor(n), torch.from_numpy(x))
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                jit.to_static(f)(torch.tensor(n),
                                 torch.from_numpy(x)).numpy(), want)
        assert any("while_loop" in str(n.target) for n in prog.graph.nodes)

    def test_loop_carry_keeps_shape_and_dtype(self):
        """A carry whose dtype the body changes cannot be exported:
        ``torch.while_loop`` refuses it, as ``lax.while_loop`` does."""

        def f(n, x):
            return static.while_loop(lambda i, a: i < n,
                                     lambda i, a: (i + 1, a.sum()), [n * 0, x])

        with pytest.raises(Exception):
            exported(f, torch.tensor(3), torch.ones(2))


def _shift_and_double(x, n):
    """``prev = cur; cur = cur * 2`` for ``n`` trips: dy2static carries
    ``cur, i, prev`` in name order, so ``cur``'s buffer is written before
    ``prev`` reads it."""
    cur = x
    prev = x * 0
    i = n * 0
    while i < n:
        prev = cur
        cur = cur * 2
        i = i + 1
    return cur, prev


def _swap(a, b, n):
    i = n * 0
    while i < n:
        a, b = b, a
        i = i + 1
    return a, b


class TestCapturedWriteBack:
    """The WHILE node's carry write-back (each trip copies the body's
    results into the carry buffers), run by ``static.nn.host_replay`` on
    the CPU as the captured node runs it: a result that is another
    carry's buffer (a permutation of the carries) must be read before that
    buffer is written.  Held to the eager body and the JAX ``to_static``
    (``lax.while_loop``) of the same function, exactly."""

    def test_shift_and_double_through_to_static(self):
        x = np.array([3.0, -1.5], np.float32)
        for n in (1, 3):
            jcur, jprev = paddle.jit.to_static(_shift_and_double)(
                paddle.to_tensor(x), paddle.to_tensor(np.int32(n)))
            args = (torch.from_numpy(x), torch.tensor(n))
            eager = _shift_and_double(*args)
            with static.nn.host_replay():
                replay = jit.to_static(_shift_and_double)(*args)
            for got in (eager, replay):
                np.testing.assert_array_equal(got[0].numpy(), np_of(jcur))
                np.testing.assert_array_equal(got[1].numpy(), np_of(jprev))
        np.testing.assert_array_equal(replay[1].numpy(), x * 4)

    @pytest.mark.parametrize("n", [1, 2, 3])
    def test_swap_through_to_static(self, n):
        a, b = np.float32([1.0, 2.0]), np.float32([7.0, 9.0])
        ja, jb = paddle.jit.to_static(_swap)(
            paddle.to_tensor(a), paddle.to_tensor(b),
            paddle.to_tensor(np.int32(n)))
        args = (torch.from_numpy(a), torch.from_numpy(b), torch.tensor(n))
        with static.nn.host_replay():
            ra, rb = jit.to_static(_swap)(*args)
        ea, eb = _swap(*args)
        for got_a, got_b in ((ea, eb), (ra, rb)):
            np.testing.assert_array_equal(got_a.numpy(), np_of(ja))
            np.testing.assert_array_equal(got_b.numpy(), np_of(jb))
        np.testing.assert_array_equal(ra.numpy(), b if n % 2 else a)

    def test_swap_through_while_loop(self):
        """``static.nn.while_loop`` with the body returning the carries
        permuted, and one carry passed through unchanged."""

        def body(i, a, b, c):
            return i + 1, b, a, c

        init = [torch.tensor(0), torch.tensor([1.0]), torch.tensor([5.0]),
                torch.tensor([8.0])]
        ji, ja, jb, jc = jstatic.while_loop(
            lambda i, a, b, c: i < 3, body,
            [paddle.to_tensor(np.int32(0)),
             *(paddle.to_tensor(t.numpy()) for t in init[1:])])
        eager = static.while_loop(lambda i, a, b, c: i < 3, body, init)
        with static.nn.host_replay():
            replay = static.while_loop(lambda i, a, b, c: i < 3, body, init)
        for got in (eager, replay):
            assert int(got[0]) == int(ji) == 3
            for g, w in zip(got[1:], (ja, jb, jc)):
                np.testing.assert_array_equal(g.numpy(), np_of(w))
        assert float(replay[1]) == 5.0 and float(init[1]) == 1.0

    def test_if_pair_outputs_swapped(self):
        """The IF pair's outputs are selected after it by ``torch.where``
        into new tensors (no write-back): a branch that returns its
        operands swapped gives the same under the replay."""
        a, b = torch.tensor([1.0]), torch.tensor([2.0])
        for pred in (True, False):
            with static.nn.host_replay():
                x, y = static.cond(torch.tensor(pred), lambda u, v: (v, u),
                                   lambda u, v: (u, v), (a, b))
            assert (float(x), float(y)) == ((2.0, 1.0) if pred
                                             else (1.0, 2.0))


class TestCaseAndSwitchCase:
    def test_case_and_switch_case(self):
        """``tests/test_static_control_flow.py``'s case and switch_case,
        eager, and the same through the export (a chain of
        ``torch.cond``), exact."""
        a = np.ones(3, np.float32)
        jx = paddle.to_tensor(a)
        jr = jstatic.nn.case([
            (paddle.to_tensor(False), lambda: jx * 0),
            (paddle.to_tensor(True), lambda: jx + 1),
        ], default=lambda: jx * 9)
        jr2 = jstatic.nn.switch_case(
            paddle.to_tensor(np.int64(2)),
            {1: lambda: jx * 0, 2: lambda: jx * 5}, default=lambda: jx)

        def f(x, p1, p2, idx):
            r = static.case([(p1, lambda: x * 0), (p2, lambda: x + 1)],
                            default=lambda: x * 9)
            r2 = static.switch_case(idx, {1: lambda: x * 0,
                                          2: lambda: x * 5},
                                    default=lambda: x)
            return r, r2

        args = (torch.from_numpy(a), torch.tensor(False), torch.tensor(True),
                torch.tensor(2))
        for got in (f(*args), exported(f, *args)(*args)):
            np.testing.assert_array_equal(got[0].numpy(), np_of(jr))
            np.testing.assert_array_equal(got[1].numpy(), np_of(jr2))

    def test_case_default_and_last_pair_fallback(self):
        """No predicate holds: ``default`` runs; without one, the last
        pair's function is the fallback (both packages)."""
        jx = paddle.to_tensor(np.ones(2, np.float32))
        x = torch.ones(2)
        jr = jstatic.nn.case([(paddle.to_tensor(False), lambda: jx * 2)],
                             default=lambda: jx * 7)
        r = static.case([(torch.tensor(False), lambda: x * 2)],
                        default=lambda: x * 7)
        np.testing.assert_array_equal(r.numpy(), np_of(jr))
        jr = jstatic.nn.case([(paddle.to_tensor(False), lambda: jx * 2),
                              (paddle.to_tensor(False), lambda: jx * 3)])
        r = static.case([(torch.tensor(False), lambda: x * 2),
                         (torch.tensor(False), lambda: x * 3)])
        np.testing.assert_array_equal(r.numpy(), np_of(jr))
        with pytest.raises(TypeError):
            static.case([])
