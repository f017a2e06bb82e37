"""The port's AMP (``paddle_tpu_torch.amp``) against the JAX package's, on
the CPU: ``auto_cast``'s per-op policy, ``GradScaler`` and the O2 masters.

Every case of ``tests/test_amp.py`` runs in both packages on the same
seeded numpy inputs.  Tolerances: dtypes and the scaler's scale, counts
and skips exactly; values computed in the low dtype to one bf16 step of
their largest value (2**-7: both sides round the same f32 sums once, an
ulp apart at most); f32 values to 1e-6.  A skipped step is held bitwise.

The dtype trace records, for ``gpt_tiny``'s O1 forward, each op the
policy sees: its name, its input dtypes after the policy's casts, and its
output dtypes, the policy's own ``cast`` ops included.  On the JAX side
the test monkeypatches ``paddle_tpu.amp.auto_cast._hook`` (inputs) and
``paddle_tpu.core.dispatch._wrap_outs`` (outputs); on the port's, the
same ``_hook`` and ``_dispatch`` of ``paddle_tpu_torch.amp.auto_cast``.
Integer dtypes are compared as "int" (token ids are int32 in JAX and
int64 in torch).
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu_torch import amp, build_train_step, optimizer as popt
from paddle_tpu_torch.models import from_jax_state_dict

torch.set_num_threads(2)

jax_ac = importlib.import_module("paddle_tpu.amp.auto_cast")
port_ac = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _single_device():
    """The JAX side runs unsharded, whatever hybrid mesh an earlier test
    file in the same worker left set."""
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _jdt(t) -> str:
    return str(t._value().dtype)


def _pdt(t) -> str:
    return str(t.dtype).split(".")[-1]


def _close_low(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert np.abs(got - want).max() <= BF16_STEP * np.abs(want).max()


# -- auto_cast ----------------------------------------------------------------

def _xy(seed=0, shape=(4, 8), shape2=(8, 4)):
    rs = np.random.RandomState(seed)
    return rs.randn(*shape).astype(np.float32), \
        rs.randn(*shape2).astype(np.float32)


class TestAutoCast:
    @pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
    def test_white_list_casts_down(self, dtype):
        x, y = _xy()
        with paddle.amp.auto_cast(dtype=dtype):
            ref = paddle.matmul(paddle.to_tensor(x), paddle.to_tensor(y))
        with amp.auto_cast(dtype=dtype):
            out = torch.matmul(torch.from_numpy(x), torch.from_numpy(y))
            out2 = torch.from_numpy(x) @ torch.from_numpy(y)
        assert _pdt(out) == _pdt(out2) == _jdt(ref) == dtype
        _close_low(out.float().numpy(), ref.astype("float32").numpy())
        assert torch.matmul(torch.from_numpy(x), torch.from_numpy(y)) \
            .dtype == torch.float32

    def test_black_list_stays_f32(self):
        x, _ = _xy()
        with paddle.amp.auto_cast(dtype="bfloat16"):
            ref = JF.softmax(paddle.to_tensor(x))
        with amp.auto_cast(dtype="bfloat16"):
            out = torch.softmax(torch.from_numpy(x).bfloat16(), -1)
            mean = torch.from_numpy(x).bfloat16().mean()
        assert _jdt(ref) == _pdt(out) == _pdt(mean) == "float32"
        np.testing.assert_allclose(
            torch.softmax(torch.from_numpy(x), -1).numpy(), ref.numpy(),
            rtol=0, atol=1e-6)

    def test_o1_gray_passthrough(self):
        x, _ = _xy()
        with paddle.amp.auto_cast(dtype="bfloat16", level="O1"):
            ref = paddle.add(paddle.to_tensor(x), paddle.to_tensor(x))
        with amp.auto_cast(dtype="bfloat16", level="O1"):
            out = torch.from_numpy(x) + torch.from_numpy(x)
        assert _jdt(ref) == _pdt(out) == "float32"

    def test_custom_lists(self):
        x, _ = _xy()
        with paddle.amp.auto_cast(dtype="bfloat16",
                                  custom_white_list=["add"]):
            ref = paddle.add(paddle.to_tensor(x), paddle.to_tensor(x))
        with amp.auto_cast(dtype="bfloat16", custom_white_list=["add"]):
            out = torch.add(torch.from_numpy(x), torch.from_numpy(x))
        assert _jdt(ref) == _pdt(out) == "bfloat16"
        for mod in (paddle.amp, amp):
            with pytest.raises(ValueError, match="both custom lists"):
                with mod.auto_cast(custom_white_list=["add"],
                                   custom_black_list=["add"]):
                    pass

    @pytest.mark.parametrize("how", ["enable", "O0"])
    def test_disable(self, how):
        x, _ = _xy()
        kw = dict(enable=False) if how == "enable" else dict(level="O0")
        with paddle.amp.auto_cast(**kw):
            ref = paddle.matmul(paddle.to_tensor(x), paddle.to_tensor(x).t())
        with amp.auto_cast(**kw):
            out = torch.matmul(torch.from_numpy(x), torch.from_numpy(x).t())
        assert _jdt(ref) == _pdt(out) == "float32"

    def test_grad_flows_through_cast(self):
        x = np.random.RandomState(1).randn(4, 4).astype(np.float32)
        jx = paddle.to_tensor(x, stop_gradient=False)
        with paddle.amp.auto_cast(dtype="bfloat16"):
            loss = paddle.matmul(jx, jx).sum()
        loss.backward()
        px = torch.from_numpy(x).requires_grad_()
        with amp.auto_cast(dtype="bfloat16"):
            ploss = torch.matmul(px, px).sum()
        ploss.backward()
        assert _jdt(jx.grad) == _pdt(px.grad) == "float32"
        assert _jdt(loss) == _pdt(ploss) == "float32"
        _close_low(px.grad.numpy(), jx.grad.numpy())

    def test_o2_gray_casts_down_no_recursion(self):
        x, _ = _xy()
        with paddle.amp.auto_cast(dtype="bfloat16", level="O2"):
            ref = paddle.add(paddle.to_tensor(x), paddle.to_tensor(x))
        with amp.auto_cast(dtype="bfloat16", level="O2"):
            out = torch.from_numpy(x) + torch.from_numpy(x)
        assert _jdt(ref) == _pdt(out) == "bfloat16"

    def test_custom_black_overrides_default_white(self):
        x = np.random.RandomState(2).randn(4, 4).astype(np.float32)
        with paddle.amp.auto_cast(dtype="bfloat16",
                                  custom_black_list=["matmul"]):
            ref = paddle.matmul(paddle.to_tensor(x), paddle.to_tensor(x))
        with amp.auto_cast(dtype="bfloat16", custom_black_list=["matmul"]):
            out = torch.matmul(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(x))
        assert _jdt(ref) == _pdt(out) == "float32"

    def test_decorate_o2(self):
        m = jnn.Linear(4, 4)
        paddle.amp.decorate(m, level="O2", dtype="bfloat16")
        lin = torch.nn.Linear(4, 4)
        amp.decorate(lin, level="O2", dtype="bfloat16")
        assert _jdt(m.weight) == _pdt(lin.weight) == "bfloat16"

    def test_previous_policy_comes_back_and_lists_are_verbatim(self):
        assert amp.WHITE_LIST == paddle.amp.WHITE_LIST
        assert amp.BLACK_LIST == paddle.amp.BLACK_LIST
        x, _ = _xy()
        t = torch.from_numpy(x)
        with amp.auto_cast(dtype="float16"):
            with amp.auto_cast(enable=False):
                assert (t @ t.t()).dtype == torch.float32
            assert (t @ t.t()).dtype == torch.float16
            assert amp.amp_state().dtype == torch.float16
        assert amp.amp_state() is None
        assert (t @ t.t()).dtype == torch.float32
        for bad in (dict(level="O3"), dict(dtype="float64")):
            with pytest.raises(ValueError):
                with amp.auto_cast(**bad):
                    pass


# -- the dtype trace of gpt_tiny's O1 forward ------------------------------------

def _norm_dtype(d: str) -> str:
    d = d.split(".")[-1]
    return "int" if d.startswith(("int", "uint")) else d


def _jax_trace(monkeypatch, model, x, y, dtype):
    from paddle_tpu.core import dispatch
    from paddle_tpu.core.tensor import Tensor

    trace = []
    orig_hook, orig_wrap = jax_ac._hook, dispatch._wrap_outs

    def hook(name, args):
        out = orig_hook(name, args)
        trace.append([name, [_norm_dtype(str(a._value().dtype))
                             for a in out if isinstance(a, Tensor)], None])
        return out

    def wrap(name, out, *a, **kw):
        res = orig_wrap(name, out, *a, **kw)
        rec = next(r for r in reversed(trace) if r[2] is None)
        outs = res if isinstance(res, tuple) else (res,)
        rec[2] = [_norm_dtype(_jdt(o)) for o in outs]
        return res

    monkeypatch.setattr(jax_ac, "_hook", hook)
    monkeypatch.setattr(dispatch, "_wrap_outs", wrap)
    with paddle.amp.auto_cast(dtype=dtype, level="O1"):
        loss = model.compute_loss(paddle.to_tensor(x), paddle.to_tensor(y))
    return trace, float(loss.numpy())


def _port_trace(monkeypatch, model, x, y, dtype):
    trace = []
    orig_hook, orig_dispatch = port_ac._hook, port_ac._dispatch

    def hook(name, args):
        out = orig_hook(name, args)
        trace.append([name, [_norm_dtype(str(a.dtype)) for a in out], None])
        return out

    def dispatch(name, fn, args, kwargs):
        res = orig_dispatch(name, fn, args, kwargs)
        rec = next(r for r in reversed(trace) if r[2] is None)
        outs = res if isinstance(res, (tuple, list)) else (res,)
        rec[2] = [_norm_dtype(str(o.dtype)) for o in outs]
        return res

    monkeypatch.setattr(port_ac, "_hook", hook)
    monkeypatch.setattr(port_ac, "_dispatch", dispatch)
    with amp.auto_cast(dtype=dtype, level="O1"):
        loss = model.compute_loss(torch.from_numpy(x), torch.from_numpy(y))
    return trace, loss.item()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_o1_forward_dtype_trace_matches_jax(monkeypatch, dtype):
    """Op for op, the same names with the same input and output dtypes:
    the white-listed embeddings, linears and flash attention in the low
    dtype (their f32 weights cast by the policy), the gray adds, reshapes,
    splits, gelus and layer norms in whatever arrives (bf16/f16 in, f32
    weights), and the gray fused cross-entropy taking the low hidden
    states and the f32 tied embedding and returning f32.  The losses
    agree to 1e-2 relative (the low dtype's rounding at other points)."""
    paddle.seed(0)
    jmodel = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny())
    state = {k: np.asarray(v.numpy()) for k, v in
             jmodel.state_dict().items()}
    ts = build_train_step("tiny", batch=2, seq=16, device="cpu",
                          amp_level="O1", to_static=False)
    from_jax_state_dict(ts.model, state)
    x, y = ts.x.numpy(), ts.y.numpy()
    jtrace, jloss = _jax_trace(monkeypatch, jmodel, x, y, dtype)
    ptrace, ploss = _port_trace(monkeypatch, ts.model, x, y, dtype)
    assert [t[0] for t in ptrace] == [t[0] for t in jtrace]
    assert ptrace == jtrace
    names = {t[0] for t in ptrace}
    assert {"embedding", "linear", "flash_attention", "layer_norm",
            "fused_linear_cross_entropy", "cast"} <= names
    assert ptrace[-1] == ["fused_linear_cross_entropy",
                          [dtype, "float32", "int"], ["float32"]]
    assert abs(ploss - jloss) <= 1e-2 * abs(jloss)


# -- GradScaler -------------------------------------------------------------------

def _linear_weights(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(4, 2).astype(np.float32) * 0.5, \
        rs.randn(2).astype(np.float32) * 0.1


def _jax_linear(w, b):
    m = jnn.Linear(4, 2)
    m.weight.set_value(w)
    m.bias.set_value(b)
    return m


def _port_linear(w, b):
    m = torch.nn.Linear(4, 2)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w.T.copy()))
        m.bias.copy_(torch.from_numpy(b))
    return m


def _data(seed=0, n=8):
    rs = np.random.RandomState(seed)
    return rs.randn(n, 4).astype(np.float32), rs.randn(n, 2).astype(np.float32)


def _jax_train(scaler, n=3, poison=(), opt_name="SGD", **okw):
    m = _jax_linear(*_linear_weights())
    opt = getattr(paddle.optimizer, opt_name)(
        parameters=m.parameters(), **({"learning_rate": 0.1} | okw))
    x, y = (paddle.to_tensor(a) for a in _data())
    losses, scales = [], []
    for i in range(n):
        loss = ((m(x) - y) ** 2).mean()
        scaler.scale(loss).backward()
        if i in poison:
            m.weight.grad = np.full((4, 2), np.inf, np.float32)
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
        scales.append(scaler.get_loss_scaling())
    return m, opt, losses, scales


def _port_train(scaler, n=3, poison=(), opt_name="SGD", **okw):
    m = _port_linear(*_linear_weights())
    opt = getattr(popt, opt_name)(m.parameters(), **({"lr": 0.1} | okw))
    x, y = (torch.from_numpy(a) for a in _data())
    losses, scales = [], []
    for i in range(n):
        loss = ((m(x) - y) ** 2).mean()
        scaler.scale(loss).backward()
        if i in poison:
            m.weight.grad = torch.full((2, 4), float("inf"))
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(loss.item())
        scales.append(scaler.get_loss_scaling())
    return m, opt, losses, scales


class TestGradScaler:
    def test_scaled_training_matches_unscaled(self):
        """1024 is a power of two: scaling and unscaling are exact, so the
        scaled run equals the unscaled one in each package, and the two
        packages agree to 1e-6."""
        runs = {}
        for name, mod, train in (("jax", paddle.amp, _jax_train),
                                 ("port", amp, _port_train)):
            on = train(mod.GradScaler(init_loss_scaling=1024.0))
            off = train(mod.GradScaler(enable=False))
            assert on[2] == off[2]
            runs[name] = on
        np.testing.assert_allclose(runs["port"][2], runs["jax"][2], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(runs["port"][0].weight.detach().numpy().T,
                                   runs["jax"][0].weight.numpy(), rtol=0,
                                   atol=1e-6)

    def test_inf_step_skipped_and_scale_halved(self):
        for mod, train in ((paddle.amp, _jax_train), (amp, _port_train)):
            scaler = mod.GradScaler(init_loss_scaling=1024.0,
                                    decr_every_n_nan_or_inf=1)
            train(scaler, n=1, poison=(0,))
            assert scaler.get_loss_scaling() == 512.0

    def test_param_unchanged_on_skip(self):
        """A NaN gradient at Adam's first step: the parameters keep their
        values and the moments and ``beta1_pow`` born in that step keep
        their initial ones, bitwise, in both packages."""
        w0 = _linear_weights()[0]
        js = paddle.amp.GradScaler(init_loss_scaling=8.0,
                                   decr_every_n_nan_or_inf=1)
        m = _jax_linear(*_linear_weights())
        opt = paddle.optimizer.Adam(parameters=m.parameters())
        x = paddle.to_tensor(_data()[0][:4])
        js.scale(m(x).mean()).backward()
        m.weight.grad = np.full((4, 2), np.nan, np.float32)
        js.step(opt)
        js.update()
        np.testing.assert_array_equal(m.weight.numpy(), w0)
        accs = opt._accumulators[opt._param_key(m.weight)]
        assert np.all(np.asarray(accs["moment1"].numpy()) == 0.0)
        assert float(accs["beta1_pow"].numpy()) == 1.0

        ps = amp.GradScaler(init_loss_scaling=8.0, decr_every_n_nan_or_inf=1)
        pm = _port_linear(*_linear_weights())
        popt_ = popt.Adam(pm.parameters())
        ps.scale(pm(torch.from_numpy(_data()[0][:4])).mean()).backward()
        pm.weight.grad = torch.full((2, 4), float("nan"))
        ps.step(popt_)
        ps.update()
        np.testing.assert_array_equal(pm.weight.detach().numpy().T, w0)
        st = popt_.state[pm.weight]
        assert torch.equal(st["moment1"], torch.zeros(2, 4))
        assert torch.equal(st["moment2"], torch.zeros(2, 4))
        assert st["beta1_pow"].item() == st["beta2_pow"].item() == 1.0
        assert js.get_loss_scaling() == ps.get_loss_scaling() == 4.0

    def test_scale_grows_after_n_good_steps(self):
        for mod, train in ((paddle.amp, _jax_train), (amp, _port_train)):
            scaler = mod.GradScaler(init_loss_scaling=8.0,
                                    incr_every_n_steps=2)
            train(scaler, n=4)
            assert scaler.get_loss_scaling() == 32.0

    def test_double_unscale_raises(self):
        m = _port_linear(*_linear_weights())
        opt = popt.SGD(m.parameters())
        scaler = amp.GradScaler(init_loss_scaling=8.0)
        scaler.scale(m(torch.from_numpy(_data()[0])).mean()).backward()
        scaler.unscale_(opt)
        with pytest.raises(RuntimeError, match="unscale_"):
            scaler.unscale_(opt)
        with pytest.raises(TypeError, match="paddle_tpu_torch.optimizer"):
            amp.GradScaler().step(torch.optim.SGD(m.parameters(), lr=0.1))

    def test_jitted_step_with_scaler(self):
        """The scaler inside a ``jit.to_static`` step (with bf16
        ``auto_cast``): the loss falls, in both packages."""
        from paddle_tpu_torch import jit

        m = _port_linear(*_linear_weights())
        opt = popt.SGD(m.parameters(), lr=0.1)
        scaler = amp.GradScaler(init_loss_scaling=256.0)

        @jit.to_static
        def step(x, y):
            with amp.auto_cast(dtype="bfloat16"):
                loss = ((m(x) - y) ** 2).mean()
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            return loss

        x, y = (torch.from_numpy(a) for a in _data(1))
        l0 = step(x, y).item()
        for _ in range(10):
            ln = step(x, y).item()
        assert ln < l0

    def test_scale_trajectory_matches_jax(self):
        """Overflows at steps 1, 2 and 5 among 9 with
        ``incr_every_n_steps=2``, ``decr_every_n_nan_or_inf=2``: the scale
        after every step, and the losses, as the JAX scaler's."""
        kw = dict(init_loss_scaling=64.0, incr_every_n_steps=2,
                  decr_every_n_nan_or_inf=2)
        poison = (1, 2, 5)
        _, _, jl, js = _jax_train(paddle.amp.GradScaler(**kw), 9, poison)
        ps = amp.GradScaler(**kw)
        _, _, pl, pscales = _port_train(ps, 9, poison)
        assert pscales == js
        np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-6)
        sd = ps.state_dict()
        assert sd["incr_count"].item() == 1 and sd["decr_count"].item() == 0

    def test_state_dict_exchanges_with_the_jax_scaler(self):
        """A JAX scaler's state dict, as numpy, loads into the port's and
        back: the same keys and values both ways."""
        jsc = paddle.amp.GradScaler(init_loss_scaling=64.0,
                                    incr_every_n_steps=2)
        _jax_train(jsc, 3)
        jsd = {k: (np.asarray(v) if not isinstance(v, (bool, int, float))
                   else v) for k, v in jsc.state_dict().items()}
        psc = amp.GradScaler()
        psc.load_state_dict(jsd)
        psd = psc.state_dict()
        assert sorted(psd) == sorted(jsd)
        for k, v in jsd.items():
            got = psd[k]
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            np.testing.assert_array_equal(got, v)
        assert psc.get_loss_scaling() == jsc.get_loss_scaling() == 128.0
        back = paddle.amp.GradScaler()
        back.load_state_dict({k: (v.numpy() if isinstance(v, torch.Tensor)
                                  else v) for k, v in psd.items()})
        assert back.get_loss_scaling() == 128.0
        for k in ("incr_count", "decr_count"):
            assert int(np.asarray(back.state_dict()[k])) == \
                int(jsd[k])
        assert psc.is_enable() and psc.is_use_dynamic_loss_scaling()
        psc.set_init_loss_scaling(4.0)
        assert psc.get_loss_scaling() == 4.0


# -- O2 masters --------------------------------------------------------------------

class TestO2MasterWeights:
    def test_small_updates_accumulate(self):
        """SGD at 1e-4 on a bf16 Linear: each step is below bf16's
        resolution at the weights' size, and the master adds them up."""
        torch.manual_seed(0)
        lin = amp.decorate(torch.nn.Linear(4, 4, bias=False), level="O2")
        assert lin.weight.dtype == torch.bfloat16
        opt = popt.SGD(lin.parameters(), lr=1e-4)
        w0 = lin.weight.detach().float().clone()
        x = torch.ones(2, 4)
        for _ in range(64):
            with amp.auto_cast(dtype="bfloat16", level="O2"):
                loss = lin(x).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
        drift = (lin.weight.detach().float() - w0).abs().mean().item()
        assert drift > 5e-3, drift

    def test_adamw_o2_matches_f32_closely(self):
        def run(o2):
            torch.manual_seed(1)
            net = torch.nn.Linear(8, 8)
            if o2:
                net = amp.decorate(net, level="O2")
            opt = popt.AdamW(net.parameters(), lr=1e-2)
            rs = np.random.RandomState(0)
            x = torch.from_numpy(rs.randn(4, 8).astype(np.float32))
            y = torch.from_numpy(rs.randn(4, 8).astype(np.float32))
            for _ in range(20):
                with amp.auto_cast(dtype="bfloat16",
                                   level="O2" if o2 else "O1"):
                    loss = ((net(x) - y) ** 2).mean()
                loss.backward()
                opt.step()
                opt.clear_grad()
            return loss.item()

        lf32, lo2 = run(False), run(True)
        assert abs(lf32 - lo2) / abs(lf32) < 0.1, (lf32, lo2)

    def test_scaler_skip_rolls_back_master(self):
        """An inf input at the first O2 step: the bf16 weight and the f32
        master born in that step keep the weight's value, in both
        packages."""
        w = np.array([[0.5, -0.25], [0.75, 1.0]], np.float32)
        jl = jnn.Linear(2, 2, bias_attr=False)
        jl.weight.set_value(w)
        jl = paddle.amp.decorate(jl, level="O2")
        jopt = paddle.optimizer.AdamW(0.1, parameters=jl.parameters())
        js = paddle.amp.GradScaler(init_loss_scaling=2.0)
        with paddle.amp.auto_cast(dtype="bfloat16", level="O2"):
            loss = jl(paddle.to_tensor(np.full((1, 2), np.inf,
                                               np.float32))).sum()
        js.scale(loss).backward()
        js.step(jopt)
        js.update()
        np.testing.assert_array_equal(
            np.asarray(jl.weight.numpy(), np.float32), w)

        pl = torch.nn.Linear(2, 2, bias=False)
        with torch.no_grad():
            pl.weight.copy_(torch.from_numpy(w.T.copy()))
        pl = amp.decorate(pl, level="O2")
        popt_ = popt.AdamW(pl.parameters(), lr=0.1)
        ps = amp.GradScaler(init_loss_scaling=2.0)
        with amp.auto_cast(dtype="bfloat16", level="O2"):
            loss = pl(torch.full((1, 2), float("inf"))).sum()
        ps.scale(loss).backward()
        ps.step(popt_)
        ps.update()
        np.testing.assert_array_equal(pl.weight.detach().float().numpy().T,
                                      w)
        st = popt_.state[pl.weight]
        np.testing.assert_array_equal(st["master_weight"].numpy().T, w)
        assert js.get_loss_scaling() == ps.get_loss_scaling() == 2.0


def test_skip_is_bitwise_on_params_masters_and_accumulators():
    """Two good O2 AdamW steps, then an overflow: the overflowing step
    leaves the bf16 parameters, their f32 masters and every moment and
    ``beta*_pow`` bitwise as they were, in both packages; a good step
    after it moves them again, and the two packages' masters agree to
    1e-6 throughout."""
    rs = np.random.RandomState(3)
    w0 = rs.randn(3, 4).astype(np.float32)
    grads = [rs.randn(3, 4).astype(np.float32) for _ in range(4)]
    bad = 2

    def jax_state(opt, p):
        accs = opt._accumulators[opt._param_key(p)]
        return {k: np.array(v.astype("float32").numpy())
                for k, v in accs.items()} | {
            "param": np.array(p.astype("float32").numpy())}

    p = paddle.create_parameter([3, 4], "float32")
    p.set_value(w0)

    class M(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.p = p

    jopt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=[p])
    paddle.amp.decorate(M(), optimizers=jopt, level="O2")
    js = paddle.amp.GradScaler(init_loss_scaling=4.0)
    tp = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    m = torch.nn.Module()
    m.p = tp
    popt_ = popt.AdamW([tp], lr=1e-2)
    amp.decorate(m, level="O2")
    ps = amp.GradScaler(init_loss_scaling=4.0)
    history = []
    for i, g in enumerate(grads):
        gv = np.full_like(g, np.inf) if i == bad else g
        jloss = (p.astype("float32") * paddle.to_tensor(gv)).sum()
        js.scale(jloss).backward()
        js.step(jopt)
        js.update()
        jopt.clear_grad()
        ploss = (tp.float() * torch.from_numpy(gv)).sum()
        ps.scale(ploss).backward()
        ps.step(popt_)
        ps.update()
        popt_.clear_grad()
        pst = {k: v.float().numpy().copy()
               for k, v in popt_.state[tp].items()}
        pst["param"] = tp.detach().float().numpy().copy()
        history.append((jax_state(jopt, p), pst))
    for side in (0, 1):
        before, skipped = history[bad - 1][side], history[bad][side]
        assert sorted(before) == sorted(skipped)
        for k in before:
            np.testing.assert_array_equal(skipped[k], before[k])
        assert not np.array_equal(history[bad + 1][side]["param"],
                                  skipped["param"])
    for j, pt in history:
        np.testing.assert_allclose(pt["master_weight"], j["master_weight"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(pt["param"], j["param"])
        for k in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
            np.testing.assert_allclose(pt[k], j[k], rtol=1e-6, atol=0)
    assert js.get_loss_scaling() == ps.get_loss_scaling()


def test_o1_recompute_keeps_the_policy():
    """A recompute region runs under the policy it was entered with, also
    when the backward recomputes it outside ``auto_cast``: O1 steps with
    recompute on and off give bitwise equal losses and parameters."""
    runs = []
    for recompute in (False, True):
        ts = build_train_step("tiny", batch=2, seq=16, device="cpu",
                              amp_level="O1", recompute=recompute,
                              to_static=False)
        losses = [ts.train_step(ts.x, ts.y).item() for _ in range(3)]
        runs.append((losses, [p.detach().clone()
                              for p in ts.model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
