"""The port's dygraph-to-static conversion against the JAX package's, on
the CPU.

Spec: ``tests/test_dy2static.py`` (15 cases), ``tests/test_dy2static_control.py``
(49), ``tests/test_jit.py:249``'s forward and
``tests/test_decode.py::TestParityShims``' toggle and ``TracedLayer``.
Each user function below is Python that both packages' tensors run (the
few that need a package's own call have a twin), converted by each
package's ``convert_function`` or compiled by each ``to_static``, on the
same seeded numpy inputs:

- the JAX package compiles it (``to_static``: its control flow over traced
  tensors becomes ``lax.cond`` / ``lax.while_loop``);
- the port runs it three ways: ``to_static`` on the CPU (the body runs
  eagerly, Python's own control flow), the converted function itself, and
  its traced path, ``torch.export`` of the converted function, whose
  branches and loops become ``torch.cond`` / ``torch.while_loop`` in ONE
  program that is then run on every input (:func:`exported`).

Values are held to the JAX package's to ``RTOL`` (the same f32 ops); where
the JAX test expects a raise, the port's traced path raises the same class
(the port's ``Dy2StaticError``, ``NameError``, ``TypeError``) naming the
same construct.  The card's captured path (CUDA graph IF and WHILE nodes)
is held in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.jit import dy2static as jdy
from paddle_tpu_torch import device_guard, jit
from paddle_tpu_torch.jit import dy2static as pdy

torch.set_num_threads(2)

#: the same f32 arithmetic on both sides
RTOL = 1e-6


@pytest.fixture(autouse=True)
def _single_device():
    """No JAX mesh, and the port's current device the CPU (the greedy
    loop's ``paddle.arange`` makes its positions there)."""
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    with device_guard("cpu"):
        yield
    mesh_mod.set_global_mesh(saved)


def J(a):
    return paddle.to_tensor(np.asarray(a))


def T(a):
    return torch.from_numpy(np.array(a))


def npv(v):
    if isinstance(v, (tuple, list)):
        return [npv(x) for x in v]
    if v is None:
        return None
    return np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                      else v.numpy())


def exported(fn, *args):
    """``fn`` converted and exported once at ``args``: the port's traced
    path, as ``jit.save`` makes it.  Returns the program (a callable)."""
    conv = pdy.convert_function(fn)

    class M(torch.nn.Module):
        def forward(self, *a):
            return conv(*a)

    return jit.export_program(M(), tuple(args)).module()


def check(f, *cases, jf=None, rtol=RTOL):
    """``f`` on each case (a tuple of numpy arguments): JAX ``to_static``
    (of ``jf``, default ``f``) against the port's ``to_static``, its
    converted function and one exported program run on every case."""
    jstep = paddle.jit.to_static(jf or f)
    pstep = jit.to_static(f)
    conv = pdy.convert_function(f)
    prog = exported(f, *[T(a) for a in cases[0]])
    for args in cases:
        want = npv(jstep(*[J(a) for a in args]))
        for got in (pstep(*[T(a) for a in args]),
                    conv(*[T(a) for a in args]),
                    prog(*[T(a) for a in args])):
            np.testing.assert_allclose(np.asarray(npv(got), np.float64),
                                       np.asarray(want, np.float64),
                                       rtol=rtol)
    return jstep, prog


def raises_like(f, jf=None, *args, exc, match):
    """The JAX ``to_static`` and the port's traced path raise ``exc`` (the
    JAX class, and the port's of the same name) matching ``match``."""
    pexc = getattr(pdy, exc.__name__, exc)
    with pytest.raises(exc, match=match):
        paddle.jit.to_static(jf or f)(*[J(a) for a in args])
    with pytest.raises(pexc, match=match):
        exported(f, *[T(a) for a in args])(*[T(a) for a in args])


POS = np.ones(3, np.float32)
NEG = -np.ones(3, np.float32)


# ---------------------------------------------------------------------------
# tests/test_dy2static.py
# ---------------------------------------------------------------------------

def ifelse_net(x):
    if x.sum() > 0:
        y = x * 2
        z = y + 1
    else:
        y = x - 1
        z = y * 3
    return z


def _was_converted(fn):
    g = pdy.convert_function(fn)
    return g, (getattr(g, "__jst_converted__", False)
               and g.__code__ is not fn.__code__)


def test_ifelse_converted_and_correct_eager():
    g, conv = _was_converted(ifelse_net)
    jg = jdy.convert_function(ifelse_net)
    assert conv
    for a in (np.array([1.0, 2.0], np.float32),
              np.array([-3.0, 1.0], np.float32)):
        np.testing.assert_allclose(g(T(a)).numpy(), npv(jg(J(a))),
                                   rtol=RTOL)


def test_ifelse_traced_single_program_both_branches():
    _, prog = check(ifelse_net, (np.array([1.0, 2.0], np.float32),),
                    (np.array([-3.0, 1.0], np.float32),))
    assert any("cond" in str(n.target) for n in prog.graph.nodes)


def grad_net(x, w):
    if x.sum() > 0:
        y = (x * w).sum()
    else:
        y = (x * w * 3.0).sum()
    return y


def test_ifelse_traced_grads_flow():
    """``w`` is state closed over by the step: its gradient flows through
    the converted branch, each sign (exact)."""
    jg = jdy.convert_function(grad_net)
    jw = paddle.to_tensor(np.array([2.0, 4.0], np.float32),
                          stop_gradient=False)

    @paddle.jit.to_static
    def jstep(x):
        loss = jg(x, jw)
        loss.backward()
        return loss

    g = pdy.convert_function(grad_net)
    w = torch.tensor([2.0, 4.0], requires_grad=True)

    @jit.to_static
    def step(x):
        loss = g(x, w)
        loss.backward()
        return loss

    for a in (np.array([1.0, 2.0], np.float32),
              np.array([-1.0, -2.0], np.float32)):
        jstep(J(a))
        step(T(a))
        np.testing.assert_array_equal(w.grad.numpy(), npv(jw.grad))
        jw.clear_gradient()
        w.grad = None


def while_net(x, n):
    i = 0
    s = x * 0
    while i < n:
        s = s + x + i
        i = i + 1
    return s


def test_while_eager_and_traced():
    g, conv = _was_converted(while_net)
    assert conv
    x = np.array([1.0, 2.0], np.float32)
    np.testing.assert_allclose(g(T(x), 3).numpy(),
                               npv(jdy.convert_function(while_net)(J(x), 3)))
    # a data-dependent trip count: one program for n 3 and 5
    _, prog = check(while_net, (x, np.int32(3)), (x, np.int32(5)))
    assert any("while_loop" in str(n.target) for n in prog.graph.nodes)


def range_net(x, n):
    acc = x * 0
    for i in range(n):
        acc = acc + x * i
    return acc


def test_for_range_traced_tensor_bound():
    g, conv = _was_converted(range_net)
    assert conv
    x = np.array([1.0, 2.0], np.float32)
    np.testing.assert_allclose(g(T(x), 3).numpy(), [3.0, 6.0])
    check(range_net, (x, np.int32(4)), (x, np.int32(2)))


def nested_net(x):
    if x.sum() > 0:
        if x.max() > 10:
            y = x * 100
        else:
            y = x * 2
    else:
        y = -x
    return y


def test_nested_if():
    check(nested_net, (np.array([1.0, 2.0], np.float32),),
          (np.array([1.0, 20.0], np.float32),),
          (np.array([-1.0, -2.0], np.float32),))


def one_branch_only(x):
    y = x * 1
    if x.sum() > 0:
        y = y + 10
    return y


def test_if_without_else():
    check(one_branch_only, (np.array([1.0], np.float32),),
          (np.array([-1.0], np.float32),))


def uses_return(x):
    if x.sum() > 0:
        return x * 2
    return x - 1


def test_return_in_branch_not_converted_python_fallback():
    g, _ = _was_converted(uses_return)
    x = np.array([1.0], np.float32)
    np.testing.assert_allclose(g(T(x)).numpy(), [2.0])
    check(uses_return, (x,), (-x,))


def undefined_one_branch(x):
    if x.sum() > 0:
        v = x * 2
    else:
        w = x * 3   # noqa: F841 — a different name
    return v * 2


def test_undefined_var_message():
    xn = np.array([-1.0], np.float32)
    with pytest.raises(NameError, match="every path"):
        jdy.convert_function(undefined_one_branch)(J(xn))
    with pytest.raises(NameError, match="every path"):
        pdy.convert_function(undefined_one_branch)(T(xn))


class BranchyNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(4, 4)
        self.b = torch.nn.Linear(4, 4)

    def forward(self, x):
        if x.mean() > 0:
            h = self.a(x)
        else:
            h = self.b(x)
        return h.sum()


class JBranchyNet(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.a = paddle.nn.Linear(4, 4)
        self.b = paddle.nn.Linear(4, 4)

    def forward(self, x):
        if x.mean() > 0:
            h = self.a(x)
        else:
            h = self.b(x)
        return h.sum()


def branchy_pair():
    """The JAX net and the port's on the same weights."""
    paddle.seed(0)
    jnet = JBranchyNet()
    net = BranchyNet()
    with torch.no_grad():
        for jl, pl in ((jnet.a, net.a), (jnet.b, net.b)):
            pl.weight.copy_(torch.from_numpy(npv(jl.weight).T.copy()))
            pl.bias.copy_(torch.from_numpy(npv(jl.bias)))
    return jnet, net


def test_layer_forward_traced_with_param_grads():
    """The branch taken gets the gradient, each way, in both packages
    (1e-6); the JAX compiled branch gives the untaken layer zeros, the
    port's eager one leaves it unset (None)."""
    jnet, net = branchy_pair()
    jfwd = jdy.convert_function(jnet.forward)
    fwd = pdy.convert_function(net.forward)

    @paddle.jit.to_static
    def jstep(x):
        loss = jfwd(x)
        loss.backward()
        return loss

    @jit.to_static
    def step(x):
        loss = fwd(x)
        loss.backward()
        return loss

    for a, taken in ((np.ones((2, 4), np.float32), "a"),
                     (-np.ones((2, 4), np.float32), "b")):
        jl, pl = jstep(J(a)), step(T(a))
        np.testing.assert_allclose(float(pl), float(jl), rtol=RTOL)
        jg = npv(getattr(jnet, taken).weight.grad)
        pg = getattr(net, taken).weight.grad.numpy()
        assert np.abs(pg).sum() > 0
        np.testing.assert_allclose(pg, jg.T, rtol=RTOL)
        for layer in (jnet.a, jnet.b):
            layer.weight.clear_gradient()
            layer.bias.clear_gradient()
        net.zero_grad(set_to_none=True)


def test_ld_and_undefined():
    assert pdy.ld(lambda: 42) == 42
    u = pdy.ld(lambda: _does_not_exist, "nope")  # noqa: F821
    assert isinstance(u, pdy.UndefinedVar)
    with pytest.raises(NameError, match="nope|every path"):
        bool(u)
    with pytest.raises(NameError, match="nope"):
        u + 1


def test_to_static_autoconverts_without_manual_call():
    """``to_static(net.forward)`` alone converts; both branches in one
    program (the export), the losses differ by branch and equal the JAX
    net's (1e-6)."""
    jnet, net = branchy_pair()
    jstep = paddle.jit.to_static(jnet.forward)
    step = jit.to_static(net.forward)
    pos, neg = np.ones((2, 4), np.float32), -np.ones((2, 4), np.float32)
    prog = exported(net.forward, T(pos))
    for a in (pos, neg):
        want = float(jstep(J(a)))
        assert abs(float(step(T(a))) - want) <= RTOL * abs(want)
        assert abs(float(prog(T(a))) - want) <= RTOL * abs(want)
    assert len(step.program_cache) == 1
    assert float(step(T(pos))) != float(step(T(neg)))


_FLAG = 1.0


def flag_net(x):
    if x.sum() > 0:
        y = x * _FLAG
    else:
        y = x
    return y


def test_converted_function_sees_rebound_globals():
    global _FLAG
    g = pdy.convert_function(flag_net)
    x = T(np.array([1.0], np.float32))
    _FLAG = 1.0
    np.testing.assert_allclose(g(x).numpy(), [1.0])
    _FLAG = 2.0
    try:
        np.testing.assert_allclose(g(x).numpy(), [2.0])
    finally:
        _FLAG = 1.0


def _helper_branch(x):
    if x.sum() > 0:
        return x * 2
    return x - 1


def caller_net(x):
    h = _helper_branch(x)
    return h + 10


def test_convert_call_recurses_into_helpers():
    check(caller_net, (np.array([1.0], np.float32),),
          (np.array([-1.0], np.float32),))


def _helper_assign(x):
    if x.sum() > 0:
        y = x * 2
    else:
        y = x - 1
    return y


def deep_net(x):
    return _helper_assign(x) + 100


def test_convert_call_traced_helper_branches():
    _, prog = check(deep_net, (np.array([1.0], np.float32),),
                    (np.array([-2.0], np.float32),))
    assert any("cond" in str(n.target) for n in prog.graph.nodes)


# ---------------------------------------------------------------------------
# tests/test_dy2static_control.py: early return
# ---------------------------------------------------------------------------

def ret_if(x):
    if x.sum() > 0:
        return x * 2.0
    return x + 1.0


def ret_if_else(x):
    if x.sum() > 0:
        return x - 5.0
    else:
        return x + 5.0


def ret_nested(x):
    if x.sum() > -100.0:
        if x.sum() > 0:
            return x * 10.0
        return x * -10.0
    return x


def ret_tuple(x):
    if x.sum() > 0:
        return x * 2.0, x * 3.0
    return x + 1.0, x + 2.0


def ret_bare(x):
    y = x * 2.0
    if x.sum() > 1e9:
        return
    return y


def outer_ret(x):
    return ret_if(x)


def tail_defines(x):
    if x.sum() > 100.0:
        return x * 0.0
    s = x * 2.0
    t = s + 1.0
    i = 0
    while i < 3:
        i = i + 1
    return t * float(i)


def ret_in_concrete_loop(x):
    i = 0
    while i < 5:
        i = i + 1
        if i == 3:
            return x * float(i)
    return x


def ret_in_traced_loop(x):
    s = x * 0.0
    while s.sum() < 10.0:
        s = s + x
        if s.sum() > 2.0:
            return s * 100.0
    return s


def while_true_return(x):
    s = x * 0.0
    while True:
        s = s + 1.0
        if s.sum() > 5.0:
            return s * 2.0


class TestEarlyReturn:
    @pytest.mark.parametrize("fn", [ret_if, ret_if_else, ret_nested,
                                    ret_tuple, outer_ret, tail_defines])
    def test_traced_returns_both_paths_one_program(self, fn):
        """``test_traced_if_both_paths_one_program``,
        ``test_traced_if_else_returns``, ``test_nested_ifs``,
        ``test_tuple_return``, ``test_helper_reached_through_convert_call``
        and ``test_tail_defines_new_vars_after_traced_return``."""
        check(fn, (POS,), (NEG,))

    def test_return_in_concrete_loop(self):
        check(ret_in_concrete_loop, (POS,))

    def test_bare_return_untaken(self):
        np.testing.assert_allclose(
            pdy.convert_function(ret_bare)(T(POS)).numpy(), 2.0)

    def test_return_in_traced_loop(self):
        """The generated return-value slot joins the loop's carry as a
        placeholder: one exported ``torch.while_loop`` over three inputs."""
        check(ret_in_traced_loop, (POS,), (np.full(3, 4.0, np.float32),),
              (np.full(3, 0.5, np.float32),))

    def test_return_in_traced_range_loop(self):
        def jf(x):
            n = (x.sum() * 0 + 5).astype("int32")
            s = x * 0.0
            for i in range(n):
                s = s + 1.0
                if s.sum() > 3.0:
                    return s * 2.0
            return s

        def f(x):
            n = (x.sum() * 0 + 5).to(torch.int32)
            s = x * 0.0
            for i in range(n):
                s = s + 1.0
                if s.sum() > 3.0:
                    return s * 2.0
            return s

        check(f, (np.array([1.0, 1.0], np.float32),), jf=jf)

    def test_return_in_zero_trip_traced_range(self):
        def jf(x):
            n = (x.sum() * 0).astype("int32")
            s = x * 0.0
            for i in range(n):
                s = s + 1.0
                if s.sum() > 0:
                    return s * 100.0
            return s + 7.0

        def f(x):
            n = (x.sum() * 0).to(torch.int32)
            s = x * 0.0
            for i in range(n):
                s = s + 1.0
                if s.sum() > 0:
                    return s * 100.0
            return s + 7.0

        check(f, (np.array([1.0, 1.0], np.float32),), jf=jf)

    def test_while_true_only_exit_is_return(self):
        check(while_true_return, (np.array([1.0, 1.0], np.float32),))


# ---------------------------------------------------------------------------
# break / continue
# ---------------------------------------------------------------------------

def brk_traced_while(x):
    i = x.sum() * 0.0
    s = x * 0.0
    while i < 10.0:
        s = s + x
        i = i + 1.0
        if s.sum() > 8.0:
            break
    return s


def cont_range_for(x):
    s = x * 0.0
    for i in range(6):
        if i % 2 == 0:
            continue
        s = s + x * float(i)
    return s


def brk_tensor_cond_for(x):
    s = x * 0.0
    for i in range(10):
        s = s + x
        if s.sum() > 8.0:
            break
    return s


def nested_loop_ownership(x):
    s = x * 0.0
    for i in range(3):
        for j in range(4):
            if j >= 2:
                break
            s = s + x
    return s


def brk_and_cont(x):
    s = x * 0.0
    i = 0
    while i < 10:
        i = i + 1
        if i % 2 == 0:
            continue
        if i > 6:
            break
        s = s + x * float(i)
    return s


def target_after_break(n):
    r = 0
    for i in range(n):
        r = r + i
        if i == 3:
            break
    return i


def target_after_loop(n):
    s = 0
    for i in range(n):
        s = s + i
    return i + s


def concrete_bc(n):
    total = 0
    for i in range(n):
        if i == 2:
            continue
        if i == 5:
            break
        total = total + i
    return total


class TestBreakContinue:
    @pytest.mark.parametrize("fn", [brk_traced_while, cont_range_for,
                                    brk_tensor_cond_for,
                                    nested_loop_ownership])
    def test_traced(self, fn):
        """``test_break_in_traced_while``, ``test_continue_in_range_for``,
        ``test_break_after_tensor_condition_in_for`` and
        ``test_nested_loop_ownership``."""
        check(fn, (POS,))

    def test_break_and_continue_same_loop(self):
        """Python's semantics (1, 3, 5 added, break at 7): the port's
        converted function, ``to_static`` and exported program equal the
        JAX conversion run eagerly.  (The JAX ``to_static`` refuses this
        function: it lowers the loop because ``s`` is traced, and
        ``float(i)`` then reads a traced ``i``; the port unrolls a loop
        whose test is concrete.)"""
        want = npv(jdy.convert_function(brk_and_cont)(J(POS)))
        np.testing.assert_allclose(want, 9.0)
        for got in (pdy.convert_function(brk_and_cont)(T(POS)),
                    jit.to_static(brk_and_cont)(T(POS)),
                    exported(brk_and_cont, T(POS))(T(POS))):
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)

    @pytest.mark.parametrize("fn,ns", [(target_after_break, (10, 2)),
                                       (target_after_loop, (4,)),
                                       (concrete_bc, (0, 1, 3, 5, 8))])
    def test_concrete_python_semantics(self, fn, ns):
        """``test_for_target_read_after_break``,
        ``test_for_target_read_after_plain_loop`` and
        ``test_concrete_matches_python``: the converted function on Python
        ints equals the function itself and the JAX conversion."""
        g, jg = pdy.convert_function(fn), jdy.convert_function(fn)
        for n in ns:
            assert g(n) == jg(n) == fn(n)


# ---------------------------------------------------------------------------
# tensor iteration
# ---------------------------------------------------------------------------

def iterate_rows(x):
    s = x[0] * 0.0
    for row in x:
        s = s + row * 2.0
    return s


class TestTensorIteration:
    def test_eager_iteration(self):
        t = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        rows = list(t)
        assert len(rows) == 3
        np.testing.assert_allclose(rows[1].numpy(), [2.0, 3.0])

    def test_traced_unrolls(self):
        check(iterate_rows, (np.arange(6, dtype=np.float32).reshape(3, 2),))

    def test_zero_d_raises_eagerly(self):
        with pytest.raises(TypeError, match="0-d"):
            iter(torch.tensor(3.0))

    def test_enumerate_and_unpack(self):
        t = torch.arange(4, dtype=torch.float32).reshape(2, 2)
        acc = 0.0
        for i, row in enumerate(t):
            a, b = row
            acc += i * float(a) + float(b)
        assert acc == 0 * 0 + 1 + 1 * 2 + 3


# ---------------------------------------------------------------------------
# logical ops
# ---------------------------------------------------------------------------

def and_or_not(x):
    a = x.sum() > 0
    b = x.sum() < 10
    if a and not b:
        y = x * 10.0
    elif a or b:
        y = x * 0.5
    else:
        y = x
    return y


def short_circuit():
    a = [] or "fallback"
    b = 5 and "taken"
    seen = []

    def side():
        seen.append(1)
        return True

    c = True or side()
    d = False and side()
    return a, b, c, d, len(seen)


def ternary(x):
    return x * 2.0 if x.sum() > 0 else x * 3.0


def ternary_concrete(n):
    return "big" if n > 5 else "small"


def chained_boolop(x):
    if x.sum() > 0 and x.sum() < 10 and x.sum() != 5:
        return x * 7.0
    return x


class TestLogical:
    def test_and_or_not_traced(self):
        check(and_or_not, (POS,), (NEG,))

    def test_short_circuit_value_semantics_concrete(self):
        assert pdy.convert_function(short_circuit)() == \
            jdy.convert_function(short_circuit)() == \
            ("fallback", "taken", True, False, 0)

    def test_ternary_over_traced_pred(self):
        check(ternary, (POS,), (NEG,))

    def test_ternary_concrete_value_semantics(self):
        g = pdy.convert_function(ternary_concrete)
        assert g(10) == "big" and g(1) == "small"

    def test_chained_boolop(self):
        check(chained_boolop, (POS,), (NEG,))


# ---------------------------------------------------------------------------
# bail-path errors
# ---------------------------------------------------------------------------

class _Holder:
    pass


_HOLD = _Holder()


def attr_store_in_branch(x):
    y = x * 1.0
    if x.sum() > 0:
        _HOLD.val = 1
        y = x * 2.0
    return y


def one_branch_var(x):
    if x.sum() > 0:
        z = x * 2.0
    return z


def bare_and_tensor_return(x):
    if x.sum() > 0:
        return
    return x * 2.0


def all_bare_returns(x):
    if x.sum() > 0:
        return
    z = (x * 2).sum()  # noqa: F841 — side computation only
    return


def bare_return_concrete(n):
    if n > 0:
        return
    return n * 2


def none_fallthrough(x):
    if x.sum() > 0:
        return x * 2.0


def none_fallthrough_concrete(n):
    if n > 0:
        return n * 2


def walrus(x):
    if (y := len(x)) and y > 0:
        z = y + 1
    else:
        z = 0
    return y + z


def list_append_in_loop(x):
    acc = []
    s = x.sum() * 0.0
    while s.sum() < 3.0:
        acc.append(1)
        s = s + 1.0
    return float(len(acc))


def list_created_in_region(x):
    if x.sum() > 0:
        parts = []
        parts.append(2.0)
        y = x * parts[0]
    else:
        y = x
    return y


def explicit_none_default(x):
    scale = None
    if x.sum() > 0:
        scale = 3.0
    if scale is None:
        scale = 1.0
    return x * scale


_BUF = [1.0, 2.0, 3.0]


def ternary_arm_mutation(x):
    y = _BUF.pop() if x.sum() > 0 else 0.0
    return x + y


class _Log:
    def __init__(self):
        self.log = []


_H = _Log()


def attr_chain_append(x):
    y = x
    if x.sum() > 0:
        _H.log.append(1)
        y = x * 2
    return y


def augassign_branch(x):
    y = x * 1.0
    if x.sum() > 0:
        y += 2.0
    return y


def augassign_break_guard(x):
    i = 0
    while i < 10:
        x = x + 1.0
        if x.sum() > 6.0:
            break
        i += 1
    return x.sum()


def chained_compare(x):
    s = x.sum()
    if 0.0 < s < 10.0:
        return s * 2.0
    return s


_CALLS = []


def _probe():
    _CALLS.append(1)
    return 3.0


def chained_call_middle(x):
    if 0.0 < _probe() < 10.0:
        return x * 2.0
    return x


def explicit_and_call(x):
    s = _probe()
    if 0.0 < s and s < 10.0:
        return x * 2.0
    return x


def nested_prebound(x):
    a = x * 0.0
    b = x * 0.0
    if x.sum() > 0:
        a = x + 1.0
        if x.sum() > 2:
            b = x + 2.0
    return (a + b).sum()


def minmax(x):
    return max(x.sum(), x.sum() * 2.0) + min(x.sum(), -1.0)


def yields(x):
    if x.sum() > 0:
        y = x * 2.0
        yield y
    yield x


class TestBailErrors:
    def test_attribute_store_names_construct_and_line(self):
        for f, args in ((lambda a: paddle.jit.to_static(
                attr_store_in_branch)(J(a)), (POS,)),
                (lambda a: exported(attr_store_in_branch, T(a))(T(a)),
                 (POS,))):
            with pytest.raises((jdy.Dy2StaticError,
                                pdy.Dy2StaticError)) as ei:
                f(*args)
            msg = str(ei.value)
            assert "test_torch_dy2static.py" in msg
            assert "`if`" in msg and "attribute" in msg

    def test_one_branch_variable_named(self):
        raises_like(one_branch_var, None, POS, exc=Exception, match="'z'")

    def test_bare_return_in_traced_if_raises_named(self):
        raises_like(bare_and_tensor_return, None, POS,
                    exc=jdy.Dy2StaticError, match="return structure")

    def test_all_bare_returns_traced_compiles_to_none(self):
        assert paddle.jit.to_static(all_bare_returns)(J(POS)) is None
        assert jit.to_static(all_bare_returns)(T(NEG)) is None
        prog = exported(all_bare_returns, T(POS))
        assert prog(T(POS)) is None and prog(T(NEG)) is None

    def test_bare_return_concrete_exact(self):
        g = pdy.convert_function(bare_return_concrete)
        assert g(1) is None and g(-2) == -4

    def test_none_fallthrough_under_traced_pred_raises(self):
        raises_like(none_fallthrough, None, POS, exc=jdy.Dy2StaticError,
                    match="implicit")

    def test_none_fallthrough_concrete_matches_python(self):
        g = pdy.convert_function(none_fallthrough_concrete)
        assert g(3) == 6 and g(-1) is None

    def test_walrus_in_boolop_keeps_python_scope(self):
        assert pdy.convert_function(walrus)([1, 2]) == \
            jdy.convert_function(walrus)([1, 2]) == 5

    def test_list_append_in_traced_loop_names_container(self):
        raises_like(list_append_in_loop, None, np.zeros(1, np.float32),
                    exc=jdy.Dy2StaticError, match="acc.*append")

    def test_list_created_inside_region_still_converts(self):
        check(list_created_in_region, (POS,), (NEG,))

    def test_explicit_none_default_not_folded(self):
        raises_like(explicit_none_default, None, NEG,
                    exc=jdy.Dy2StaticError, match="'scale'.*None")

    def test_ternary_arm_mutation_stays_python(self):
        with pytest.raises(Exception):
            paddle.jit.to_static(ternary_arm_mutation)(J(NEG))
        with pytest.raises(Exception):
            exported(ternary_arm_mutation, T(NEG))(T(NEG))
        assert len(_BUF) == 3, "ternary arms ran at trace time"

    def test_attribute_chain_append_bails_named(self):
        raises_like(attr_chain_append, None, POS, exc=jdy.Dy2StaticError,
                    match="_H.log.*append")
        assert _H.log == [], "append ran at trace time"

    def test_augassign_in_traced_branch(self):
        check(augassign_branch, (POS,), (NEG,))

    def test_augassign_under_break_flag_guard(self):
        check(augassign_break_guard, (np.array([1.0, 2.0], np.float32),))

    def test_chained_comparison_traced(self):
        check(chained_compare, (POS,), (np.full(3, 5.0, np.float32),),
              (NEG,))

    def test_chained_comparison_call_middle_evaluates_once(self):
        """A middle operand of a chain evaluates once a pass: the chained
        form calls its probe as often as the explicit ``and`` form, in
        the port's eager and traced paths."""
        counts = []
        for fn in (chained_call_middle, explicit_and_call):
            del _CALLS[:]
            out = jit.to_static(fn)(T(POS))
            exported(fn, T(POS))
            np.testing.assert_allclose(out.numpy(), np.full(3, 2.0))
            counts.append(len(_CALLS))
        assert counts[0] == counts[1]

    def test_nested_if_prebound_var_unifies_with_outer(self):
        check(nested_prebound, (np.array([1.0, 2.0], np.float32),),
              (np.array([0.5, 0.5], np.float32),),
              (-np.ones(2, np.float32),))

    def test_minmax_builtin_on_traced_scalars(self):
        check(minmax, (POS,), (NEG,))

    def test_yield_region_reported(self):
        g = pdy.convert_function(yields)
        assert len(list(g(T(POS)))) == 2


# ---------------------------------------------------------------------------
# tests/test_jit.py:249 through to_static, the shims, programs
# ---------------------------------------------------------------------------

class TestShims:
    def test_program_translator_toggle(self):
        """``tests/test_decode.py::TestParityShims``: the translator off,
        a compiled function runs its Python body at every call."""
        calls = {"n": 0}

        @jit.to_static
        def f(x):
            calls["n"] += 1
            return x * 2

        x = torch.ones(1)
        f(x)
        n = calls["n"]
        jit.ProgramTranslator().enable(False)
        try:
            assert not jit.ProgramTranslator.get_instance().enable_to_static
            f(x)
            assert calls["n"] == n + 1
        finally:
            jit.ProgramTranslator().enable(True)
        jit.set_code_level(100)
        jit.set_verbosity(1)

    def test_traced_layer(self, tmp_path):
        """``TracedLayer.trace`` and ``save_inference_model``: the traced
        callable, and the saved program loaded, equal the layer's outputs
        (1e-6), and the JAX ``TracedLayer``'s on the same weights."""
        import paddle_tpu.nn as jnn

        paddle.seed(0)
        jlin = jnn.Linear(3, 2)
        lin = torch.nn.Linear(3, 2)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(npv(jlin.weight).T.copy()))
            lin.bias.copy_(torch.from_numpy(npv(jlin.bias)))
        x = np.ones((1, 3), np.float32)
        jouts, jtraced = paddle.jit.TracedLayer.trace(jlin, [J(x)])
        outs, traced = jit.TracedLayer.trace(lin, [T(x)])
        np.testing.assert_allclose(npv(traced(T(x))), npv(outs), rtol=RTOL)
        np.testing.assert_allclose(npv(outs), npv(jouts), rtol=RTOL)
        path = str(tmp_path / "traced")
        traced.save_inference_model(path)
        loaded = jit.load(path, device="cpu")
        np.testing.assert_allclose(npv(loaded(T(x))), npv(outs), rtol=RTOL)
        assert sorted(loaded.state_dict()) == ["bias", "weight"]

    def test_concrete_programs_and_stats(self):
        """``get_concrete_program``, ``concrete_program_specify_input_spec``,
        ``last_program`` and ``compiled_stats`` (no ``hlo``: the port has
        none; flops counted from one eager run of the body)."""
        lin = torch.nn.Linear(4, 4)
        f = jit.to_static(lin.forward,
                          input_spec=[jit.InputSpec([None, 4], "float32")])
        with pytest.raises(RuntimeError, match="call the function"):
            f.last_program()
        prog = f.concrete_program_specify_input_spec()
        assert prog is f.get_concrete_program(torch.zeros(1, 4))
        with pytest.raises(RuntimeError, match="not run"):
            prog.compiled_stats()
        f(torch.ones(2, 4))
        stats = f.last_program().compiled_stats()
        assert "hlo" not in stats
        assert stats["argument_bytes"] == 2 * 4 * 4
        assert stats["cost"]["flops"] == 2 * 2 * 4 * 4
        assert stats["temp_bytes"] == 0

    def test_save_of_a_to_static_forward_with_a_loop(self, tmp_path):
        """A forward whose loop runs on a tensor's value: saved once (a
        ``torch.while_loop`` in the archive) and run at three trip counts,
        each equal to the eager forward and the JAX package's loaded
        program (1e-6)."""
        jnet, net = branchy_pair()

        def fwd(x, n):
            s = x * 0.0
            while n > 0:
                s = s + net.a(x)
                n = n - 1
            return s

        def jfwd(x, n):
            s = x * 0.0
            while n > 0:
                s = s + jnet.a(x)
                n = n - 1
            return s

        class Loop(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.net = net

            def forward(self, x, n):
                s = x * 0.0
                while n > 0:
                    s = s + self.net.a(x)
                    n = n - 1
                return s

        path = str(tmp_path / "loop")
        jit.save(jit.to_static(Loop()), path, input_spec=[
            jit.InputSpec([None, 4], "float32"), jit.InputSpec([], "int64")])
        loaded = jit.load(path, device="cpu")
        x = np.ones((3, 4), np.float32)
        jstep = paddle.jit.to_static(jfwd)
        for n in (0, 1, 3):
            got = loaded(T(x), torch.tensor(n))
            np.testing.assert_allclose(got.numpy(),
                                       fwd(T(x), torch.tensor(n)).detach()
                                       .numpy(), rtol=RTOL, atol=1e-6)
            np.testing.assert_allclose(
                got.numpy(), npv(jstep(J(x), J(np.int64(n)))), rtol=RTOL,
                atol=1e-6)


# ---------------------------------------------------------------------------
# the generation loop of chip_smoke.py's dy2static_generate, at 2 layers
# ---------------------------------------------------------------------------

def jax_greedy_step(model, input_ids, unfinished_flag, cur_len,
                    eos_token_id):
    logits = model(input_ids)
    next_token_logits = paddle.index_select(
        logits, (cur_len - 1).reshape([1]), axis=1)[:, 0]
    next_tokens = paddle.argmax(next_token_logits, axis=-1)
    next_tokens = paddle.where(unfinished_flag, next_tokens,
                               paddle.full_like(next_tokens, 0)
                               + eos_token_id)
    positions = paddle.arange(input_ids.shape[1])
    input_ids = paddle.where(positions.unsqueeze(0) == cur_len,
                             next_tokens.unsqueeze(1), input_ids)
    unfinished_flag = paddle.logical_and(unfinished_flag,
                                         next_tokens != eos_token_id)
    return input_ids, unfinished_flag, cur_len + 1


def jax_greedy_search(model, input_ids, cur_len, max_length,
                      eos_token_id):
    unfinished_flag = input_ids[:, 0] == input_ids[:, 0]
    while cur_len < max_length:
        input_ids, unfinished_flag, cur_len = jax_greedy_step(
            model, input_ids, unfinished_flag, cur_len, eos_token_id)
        if not unfinished_flag.any():
            break
    return input_ids, cur_len


@pytest.fixture(scope="module")
def tiny_generators():
    """A 2-layer GPT in both packages on the same weights, and the
    port's ``GreedyGenerator`` over it."""
    import chip_smoke as cs
    from paddle_tpu.models import gpt as jax_gpt
    from paddle_tpu_torch.models import (GPTForCausalLM, from_jax_state_dict,
                                         gpt_tiny)

    paddle.seed(0)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny())   # 2 layers
    jm.eval()
    pm = GPTForCausalLM(gpt_tiny(), device="cpu").eval()
    from_jax_state_dict(pm, {k: np.asarray(v.numpy())
                             for k, v in jm.state_dict().items()})
    return jm, cs.GreedyGenerator(pm, 24), cs


GEN_PROMPT = 6


@pytest.mark.parametrize("eos_step", [None, 3])
def test_generation_loop_matches_jax(tiny_generators, eos_step):
    """The greedy loop at 2 layers on a ``[2, 24]`` buffer, 6-token
    prompt: the JAX ``to_static`` (``lax.while_loop``) against the port's
    eager loop and ``to_static`` (ids equal, final ``cur_len`` equal);
    with ``eos_step`` the eos is the token the port emits at that step
    (batch 1), and both stop at the same ``cur_len``, before the end."""
    jm, gen, cs = tiny_generators
    ids = np.random.RandomState(7).randint(0, 128, (2, 24))
    eos = -1
    if eos_step is not None:
        ids = ids[:1]
        full, _ = gen(*cs.gen_inputs(ids, GEN_PROMPT, -1, "cpu"))
        eos = int(full[0, GEN_PROMPT + eos_step])
    args = cs.gen_inputs(ids, GEN_PROMPT, eos, "cpu")
    with torch.no_grad():
        p_ids, p_len = gen(*args)
        s_ids, s_len = jit.to_static(gen.forward)(*args)
    def jgen(i, c, e):
        return jax_greedy_search(jm, i, c, 24, e)

    jstep = paddle.jit.to_static(jgen)
    j_ids, j_len = jstep(J(args[0].numpy()), J(args[1].numpy()),
                         J(args[2].numpy()))
    np.testing.assert_array_equal(p_ids.numpy(), npv(j_ids))
    np.testing.assert_array_equal(s_ids.numpy(), p_ids.numpy())
    assert int(p_len) == int(s_len) == int(npv(j_len))
    if eos_step is not None:
        assert int(p_len) < 24


def test_generation_loop_saved_program(tiny_generators, tmp_path):
    """The same loop through ``jit.save`` (a ``torch.while_loop`` whose
    body holds the break's ``torch.where`` select) and ``jit.load`` on
    the CPU: ids and ``cur_len`` equal the eager loop's, for eos never and
    eos at step 3 (one program)."""
    _, gen, cs = tiny_generators
    ids = np.random.RandomState(7).randint(0, 128, (2, 24))
    path = str(tmp_path / "gen")
    jit.save(gen, path, input_spec=[
        jit.InputSpec([2, 24], "int64"), jit.InputSpec([], "int64"),
        jit.InputSpec([], "int64")])
    loaded = jit.load(path, device="cpu")
    ops = {str(n.target) for n in loaded._program.graph.nodes
           if n.op == "call_function"}
    assert any("while_loop" in o for o in ops)
    full, _ = gen(*cs.gen_inputs(ids, GEN_PROMPT, -1, "cpu"))
    for eos in (-1, int(full[0, GEN_PROMPT + 3])):
        args = cs.gen_inputs(ids, GEN_PROMPT, eos, "cpu")
        with torch.no_grad():
            want_ids, want_len = gen(*args)
        got_ids, got_len = loaded(*args)
        np.testing.assert_array_equal(got_ids.numpy(), want_ids.numpy())
        assert int(got_len) == int(want_len)
