"""The port's static program mode against the JAX package's, on the CPU.

Spec: ``tests/test_static_program.py`` (every case has a counterpart
here, named after it).  Each program is built the same way in both
packages; the JAX program's state (``save_program_state``: its leaves in
op order) is carried into the port's with ``set_program_state`` (a
Linear/``fc`` weight transposed), both run the same seeded numpy feeds,
and the fetched values agree within 1e-5 (losses of a training run within
1e-4); the shape guard raises where the JAX package raises.  Beyond the
spec: a ``PyLayer`` whose forward goes through numpy replays the right
answer for a new feed, a tensor made inside a recorded op and handed out
past it raises when an op consumes it, a host read of a placeholder
raises, the fluid-style builders of ``static.nn`` agree with the JAX
package's, and GPT (tiny, f32) trains through ``Executor.run`` with the
eager model's losses.
"""
import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import static as jstatic
import paddle_tpu_torch as pt
from paddle_tpu_torch import static
from paddle_tpu_torch.ops import _helpers

torch.set_num_threads(2)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with pt.device_guard("cpu"):
        yield


@contextlib.contextmanager
def jax_static():
    paddle.enable_static()
    try:
        yield
    finally:
        paddle.disable_static()


@contextlib.contextmanager
def port_static():
    pt.enable_static()
    try:
        yield
    finally:
        pt.disable_static()


@pytest.fixture
def static_mode():
    with port_static():
        yield


def _carry(jmain, main):
    """The JAX program's state into the port's program."""
    static.set_program_state(main, jstatic.save_program_state(program=jmain))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


class TestProgramExecutor:
    def test_record_replay_with_feeds(self):
        a = np.random.RandomState(0).randn(3, 4).astype(np.float32)
        with jax_static():
            jmain = jstatic.Program()
            with jstatic.program_guard(jmain):
                x = jstatic.data("x", [None, 4], "float32")
                w = paddle.create_parameter([4, 2], "float32")
                y = paddle.nn.functional.relu(paddle.matmul(x, w)) + 1.0
            want, = jstatic.Executor().run(jmain, feed={"x": a},
                                           fetch_list=[y])
        with port_static():
            main = static.Program()
            with static.program_guard(main):
                x = static.data("x", [None, 4], "float32")
                w = pt.create_parameter([4, 2], "float32")
                y = pt.nn.functional.relu(pt.matmul(x, w)) + 1.0
            _carry(jmain, main)
            got, = static.Executor().run(main, feed={"x": a},
                                         fetch_list=[y])
        _close(got, want)
        _close(got, np.maximum(a @ w.detach().numpy(), 0) + 1.0)
        assert len(main.ops) >= 3

    def test_replay_different_batch_size(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2, 3], "float32")
            y = (x * 2).sum(dim=1)
        r, = static.Executor().run(main, feed={"x": np.ones((7, 3),
                                                            np.float32)},
                                   fetch_list=[y])
        _close(r, np.full(7, 6.0))

    def test_unknown_feed_raises(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            y = x + 1
        with pytest.raises(KeyError):
            static.Executor().run(main, feed={"bogus": np.ones(2)},
                                  fetch_list=[y])

    def test_fetch_placeholder_and_unproduced(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            _ = x * 3
        r, = static.Executor().run(main, feed={"x": np.array([1, 2],
                                                             np.float32)},
                                   fetch_list=[x])
        _close(r, [1, 2])
        with pytest.raises(KeyError):
            static.Executor().run(main, feed={"x": np.ones(2, np.float32)},
                                  fetch_list=[torch.ones(2)])

    def test_program_guard_scopes_recording(self):
        counts = {}
        for name, (on, mod, tensor_api) in {
                "jax": (jax_static, jstatic, paddle),
                "port": (port_static, static, pt)}.items():
            with on():
                p1, p2 = mod.Program(), mod.Program()
                with mod.program_guard(p1):
                    a = mod.data("a", [2], "float32")
                    _ = a + 1
                with mod.program_guard(p2):
                    b = mod.data("b", [2], "float32")
                    _ = b * 2
                    _ = b - 1
            counts[name] = (len(p1.ops), len(p2.ops))
        assert counts["port"] == counts["jax"] == (1, 2)

    def test_eager_mode_not_recorded(self):
        before = len(static.default_main_program().ops)
        t = pt.to_tensor(np.ones(2, np.float32))
        _ = t + 1
        assert _helpers.record_hook is None
        assert pt.in_dynamic_mode()
        assert len(static.default_main_program().ops) == before

    def test_program_guard_without_static_mode_records_nothing(self):
        p = static.Program()
        with static.program_guard(p):
            t = pt.to_tensor(np.ones(2, np.float32))
            _ = t + 1
        assert len(p.ops) == 0

    def test_gradients(self):
        with jax_static():
            jmain = jstatic.Program()
            with jstatic.program_guard(jmain):
                x = jstatic.data("x", [3], "float32")
                w = paddle.create_parameter([3], "float32")
                w.stop_gradient = False
                loss = (w * 2).sum()
            jg, = jstatic.gradients(loss, w)
        with port_static():
            assert not pt.in_dynamic_mode()
            main = static.Program()
            with static.program_guard(main):
                x = static.data("x", [3], "float32")
                w = pt.create_parameter([3], "float32")
                loss = (w * 2).sum()
                g, = static.gradients(loss, w)
            # the gradient is an op of the program too
            r, = static.Executor().run(main, feed={"x": np.ones(3,
                                                                np.float32)},
                                       fetch_list=[g])
        _close(g.numpy(), np.asarray(jg.numpy()))
        _close(r, [2, 2, 2])


class TestStaticExtras:
    def test_ema(self):
        import paddle_tpu.nn as jnn

        paddle.seed(0)
        jlin = jnn.Linear(2, 2, bias_attr=False)
        w0 = np.asarray(jlin.weight.numpy())
        lin = pt.nn.Linear(2, 2, bias_attr=False)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w0.T.copy()))
        jema, ema = jstatic.ExponentialMovingAverage(0.9), \
            static.ExponentialMovingAverage(0.9)
        jema.update(parameters=jlin.parameters())
        ema.update(parameters=lin.parameters())
        jlin.weight._set_data(jlin.weight._value() * 0.0)
        with torch.no_grad():
            lin.weight.zero_()
        jema.update(parameters=jlin.parameters())
        ema.update(parameters=lin.parameters())
        with jema.apply(), ema.apply():
            want = np.asarray(jlin.weight.numpy())
            got = lin.weight.detach().numpy()
            assert np.abs(got).sum() > 0
            _close(got.T, want)
        # restored to the zeroed live weights
        _close(lin.weight.detach().numpy(), 0.0)

    def test_scope_and_places(self):
        s = static.Scope()
        v = s.var("a")
        assert s.find_var("a") is v
        with static.scope_guard(s):
            assert static.global_scope() is s
        assert len(static.cpu_places(2)) == 2
        with pytest.raises(RuntimeError):       # no card here
            static.cuda_places()
        for stub in (static.xpu_places, static.npu_places,
                     static.mlu_places):
            with pytest.raises(RuntimeError):
                stub()
        with pytest.raises(NotImplementedError):
            static.IpuStrategy()

    def test_compiled_program_passthrough(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            y = x + 5
        cp = static.CompiledProgram(main).with_data_parallel()
        r, = static.Executor().run(cp, feed={"x": np.zeros(2, np.float32)},
                                   fetch_list=[y])
        _close(r, [5, 5])

    def test_accuracy(self):
        pred = np.array([[0.1, 0.9], [0.8, 0.2], [0.3, 0.7]], np.float32)
        label = np.array([[1], [0], [0]], np.int64)
        want = float(jstatic.accuracy(paddle.to_tensor(pred),
                                      paddle.to_tensor(label)))
        got = float(static.accuracy(pt.to_tensor(pred), pt.to_tensor(label)))
        assert abs(got - want) < 1e-6 and abs(got - 2 / 3) < 1e-6


    def test_auc_matches_jax(self):
        rs = np.random.RandomState(5)
        pred = rs.rand(64, 1).astype(np.float32)
        label = (rs.rand(64, 1) < pred).astype(np.int64)
        got = static.auc(pt.to_tensor(pred), pt.to_tensor(label))
        want = jstatic.auc(paddle.to_tensor(pred), paddle.to_tensor(label))
        _close([float(v) for v in got], [float(v) for v in want])

    def test_every_static_name_of_the_jax_package(self):
        assert set(jstatic.__all__) <= set(static.__all__)
        assert set(jstatic.nn.__all__) <= set(static.nn.__all__)
        for name in ("sequence_pad", "crf_decoding", "nce"):
            for mod in (static.nn, jstatic.nn):
                with pytest.raises(NotImplementedError, match="LoD"):
                    getattr(mod, name)(None)


class TestReviewRegressions:
    def test_param_updates_visible_across_runs(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            w = pt.create_parameter([2], "float32")
            y = (x * w).sum()
        exe = static.Executor()
        feed = np.ones(2, np.float32)
        r1, = exe.run(main, feed={"x": feed}, fetch_list=[y])
        with torch.no_grad():
            w.add_(1.0)
        r2, = exe.run(main, feed={"x": feed}, fetch_list=[y])
        _close(r2 - r1, 2.0, 1e-6)

    def test_fetch_by_name(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            _ = pt.add(x, pt.full([2], 7.0), name="out_y")
        r, = static.Executor().run(main, feed={"x": np.zeros(2,
                                                             np.float32)},
                                   fetch_list=["out_y"])
        _close(r, [7, 7])
        r, = static.Executor().run(main, feed={"x": np.ones(2, np.float32)},
                                   fetch_list=["x"])
        _close(r, [1, 1])
        with pytest.raises(KeyError):
            static.Executor().run(main, feed={"x": np.zeros(2, np.float32)},
                                  fetch_list=["nope"])

    def test_append_after_run_routes_to_scratch(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            y = x * 2
        static.Executor().run(main, feed={"x": np.ones(2, np.float32)},
                              fetch_list=[y])
        with static.program_guard(main):
            z = x + 1    # must not raise
        assert main._n_post_run == 1
        with pytest.raises(KeyError):
            static.Executor().run(main, feed={"x": np.ones(2, np.float32)},
                                  fetch_list=[z])
        out, = static.Executor().run(
            main, feed={"x": np.full(2, 3.0, np.float32)}, fetch_list=[y])
        _close(out, [6.0, 6.0])

    def test_intermediates_released_after_finalize(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            mid = x * 2
            y = mid + 1
        ref = weakref.ref(mid)
        static.Executor().run(main, feed={"x": np.ones(2, np.float32)},
                              fetch_list=[y])
        del mid
        gc.collect()
        assert ref() is None   # the program does not pin intermediates

    def test_weight_norm_param_attr(self):
        attr = static.WeightNormParamAttr(dim=0, name="w")
        assert attr.dim == 0 and attr.name == "w"
        assert jstatic.WeightNormParamAttr(dim=0).dim == attr.dim

    def test_save_load_inference_model(self, tmp_path):
        a = np.random.RandomState(1).randn(2, 3).astype(np.float32)
        with jax_static():
            jmain = jstatic.Program()
            with jstatic.program_guard(jmain):
                jx = jstatic.data("x", [2, 3], "float32")
                jw = paddle.create_parameter([3, 2], "float32")
                jy = paddle.matmul(jx, jw)
            jexe = jstatic.Executor()
            jstatic.save_inference_model(str(tmp_path / "jax"), [jx], [jy],
                                         jexe, program=jmain)
            jprog, _, jfetch = jstatic.load_inference_model(
                str(tmp_path / "jax"), jexe)
            jwant, = jexe.run(jprog, feed={"x": a}, fetch_list=jfetch)
        with port_static():
            main = static.Program()
            with static.program_guard(main):
                x = static.data("x", [2, 3], "float32")
                w = pt.create_parameter([3, 2], "float32")
                y = pt.matmul(x, w)
            _carry(jmain, main)
            exe = static.Executor(pt.device.CPUPlace())
            want, = exe.run(main, feed={"x": a}, fetch_list=[y])
            prefix = str(tmp_path / "infer")
            static.save_inference_model(prefix, [x], [y], exe, program=main)
            # the parameters are in the saved files: changing w does not
            # reach the loaded program
            with torch.no_grad():
                w.zero_()
            prog2, feed_names, fetch_targets = static.load_inference_model(
                prefix, exe)
            assert feed_names == ["x"]
            got, = exe.run(prog2, feed={"x": a}, fetch_list=fetch_targets)
        _close(got, want)
        _close(got, jwant)
        # a program the JAX package saved is refused, naming what it is
        with pytest.raises(ValueError, match="StableHLO"):
            static.load_inference_model(str(tmp_path / "jax"), exe)

    def test_inplace_op_recorded_correctly(self):
        feed = np.array([-1, 0, 2], np.float32)
        with jax_static():
            jmain = jstatic.Program()
            with jstatic.program_guard(jmain):
                x = jstatic.data("x", [3], "float32")
                h = x * 2
                paddle.nn.functional.relu_(h)
                y = h + 1
            want, = jstatic.Executor().run(jmain, feed={"x": feed},
                                           fetch_list=[y])
        with port_static():
            main = static.Program()
            with static.program_guard(main):
                x = static.data("x", [3], "float32")
                h = x * 2
                pt.nn.functional.relu_(h)
                y = h + 1
            got, = static.Executor().run(main, feed={"x": feed},
                                         fetch_list=[y])
        _close(got, want)
        _close(got, [1, 1, 5])

    def test_serialize_deserialize_roundtrip(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            y = x * 4
        blob = static.serialize_program([x], [y], program=main)
        prog2 = static.deserialize_program(blob)
        r, = static.Executor().run(prog2, feed={"x": np.ones(2,
                                                             np.float32)},
                                   fetch_list=[0])
        _close(r, [4, 4])
        state = static.serialize_persistables([x], [y], program=main)
        static.deserialize_persistables(main, state)

    def test_saved_model_dynamic_batch(self, static_mode, tmp_path):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [None, 3], "float32")
            w = pt.create_parameter([3, 2], "float32")
            y = pt.matmul(x, w)
        exe = static.Executor(pt.device.CPUPlace())
        prefix = str(tmp_path / "dyn")
        static.save_inference_model(prefix, [x], [y], exe, program=main)
        prog2, names, fetches = static.load_inference_model(prefix, exe)
        big = np.random.RandomState(2).randn(5, 3).astype(np.float32)
        got, = exe.run(prog2, feed={"x": big}, fetch_list=fetches)
        _close(got, big @ w.detach().numpy(), 1e-4)


class TestShapeAttrBakeDetection:
    def _raises_like_jax(self, build, feed, fetch_ix):
        """Build the same program in both packages; each raises at the
        same feed, or each returns the same value."""
        outcomes = []
        for on, mod, api in ((jax_static, jstatic, paddle),
                             (port_static, static, pt)):
            with on():
                main = mod.Program()
                with mod.program_guard(main):
                    outs = build(mod, api)
                try:
                    r, = mod.Executor().run(main, feed=feed(main),
                                            fetch_list=[outs[fetch_ix]])
                    outcomes.append(("value", float(np.asarray(r).sum())))
                except RuntimeError as e:
                    assert "baked" in str(e)
                    outcomes.append(("raised", None))
        assert outcomes[0] == outcomes[1], outcomes
        return outcomes[1]

    def test_baked_none_dim_attr_raises_on_other_batch(self):
        def build(mod, api):
            x = mod.data("x", [None, 4], "float32")
            return [x.reshape([x.shape[0], 2, 2]).sum()]
        got = self._raises_like_jax(
            build, lambda m: {"x": np.ones((8, 4), np.float32)}, 0)
        assert got[0] == "raised"

    def test_keepdim_one_not_false_flagged(self):
        def build(mod, api):
            x = mod.data("x", [None, 4], "float32")
            m = api.sum(x, axis=1, keepdim=True)          # [B, 1]
            return [api.sum(m.reshape([m.shape[1], -1]))]
        got = self._raises_like_jax(
            build, lambda m: {"x": np.ones((8, 4), np.float32)}, 0)
        assert got == ("value", 32.0)

    def test_baked_guard_is_per_feed(self):
        def build(mod, api):
            a = mod.data("a", [None, 4], "float32")
            b = mod.data("b", [None, 4], "float32")
            return [a.reshape([a.shape[0], 2, 2]).sum(), (b * 2.0).sum()]

        def consistent(main):
            dummy = main._feed_vars["a"].shape[0]
            return {"a": np.ones((dummy, 4), np.float32),
                    "b": np.ones((8, 4), np.float32)}
        assert self._raises_like_jax(build, consistent, 1) == ("value", 64.0)
        got = self._raises_like_jax(
            build, lambda m: {"a": np.ones((8, 4), np.float32),
                              "b": np.ones((8, 4), np.float32)}, 0)
        assert got[0] == "raised"

    def test_dynamic_batch_without_shape_attrs_still_works(self,
                                                           static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [None, 3], "float32")
            y = (x * 2.0).sum(dim=1)
        for b in (1, 4, 9):
            out, = static.Executor().run(
                main, feed={"x": np.ones((b, 3), np.float32)},
                fetch_list=[y])
            assert out.shape == (b,)

    def test_weight_shape_attrs_not_flagged(self):
        def build(mod, api):
            x = mod.data("x", [None, 6], "float32")
            w = api.to_tensor(np.ones((6, 2), np.float32))
            h = api.matmul(x, w)                              # feed-derived
            wr = w.reshape([w.shape[0] * w.shape[1]])   # a constant's shape
            return [h.sum() + wr.sum()]
        got = self._raises_like_jax(
            build, lambda m: {"x": np.ones((5, 6), np.float32)}, 0)
        assert got == ("value", 5 * 6 * 2 + 12)


def _fit_a_line(mod, api, make_opt, in_dim=4):
    x = mod.data("x", [None, in_dim], "float32")
    y = mod.data("y", [None, 1], "float32")
    pred = mod.nn.fc(x, 1)
    loss = api.mean((pred - y) ** 2)
    opt = make_opt(loss)
    return loss, opt


def _train_both(make_jopt, make_opt, xs, ys, steps, between=None):
    """The same fit-a-line program trained in both packages from the JAX
    program's initial state; both loss lists."""
    losses = {}
    with jax_static():
        jmain, jstart = jstatic.Program(), jstatic.Program()
        with jstatic.program_guard(jmain, jstart):
            jloss, jopt = _fit_a_line(jstatic, paddle, make_jopt,
                                      xs.shape[1])
        jexe = jstatic.Executor()
        jexe.run(jstart)
        state = jstatic.save_program_state(program=jmain)
        out = []
        for i in range(steps):
            lv, = jexe.run(jmain, feed={"x": xs, "y": ys},
                           fetch_list=[jloss])
            out.append(float(lv))
            if between:
                between(jopt, i)
        losses["jax"] = out
    with port_static():
        main, start = static.Program(), static.Program()
        with static.program_guard(main, start):
            loss, opt = _fit_a_line(static, pt, make_opt, xs.shape[1])
        exe = static.Executor()
        exe.run(start)
        static.set_program_state(main, state)
        out = []
        for i in range(steps):
            lv, = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
            out.append(float(lv))
            if between:
                between(opt, i)
        losses["port"] = out
    return losses, main, opt


class TestStaticTraining:
    def test_sgd_minimize_trains_via_executor(self):
        rs = np.random.RandomState(0)
        xs = rs.randn(32, 4).astype(np.float32)
        ys = xs @ rs.randn(4, 1).astype(np.float32)

        def jopt(loss):
            o = paddle.optimizer.SGD(0.1)
            o.minimize(loss)
            return o

        def opt(loss):
            o = pt.optimizer.SGD(None, lr=0.1)
            o.minimize(loss)
            return o
        losses, _, o = _train_both(jopt, opt, xs, ys, 100)
        # minimize with no parameters takes the program's two (fc weight
        # and bias)
        assert len(o.param_groups[0]["params"]) == 2
        _close(losses["port"], losses["jax"], 1e-4)
        assert losses["port"][-1] < 1e-3 < losses["port"][0]

    def test_minimize_with_explicit_parameters_trains(self):
        xs = np.random.RandomState(0).randn(16, 2).astype(np.float32)
        ys = xs @ np.array([[1.0], [-2.0]], np.float32)

        def jopt(loss):
            o = paddle.optimizer.SGD(0.1)
            o.minimize(loss, parameters=None)
            o2 = paddle.optimizer.SGD(0.1, parameters=o._parameter_list)
            o2.minimize(loss)
            return o2

        def opt(loss):
            o = pt.optimizer.SGD(None, lr=0.1)
            o.minimize(loss)
            o2 = pt.optimizer.SGD(o.param_groups[0]["params"], lr=0.1)
            o2.minimize(loss)
            return o2
        losses, _, _ = _train_both(jopt, opt, xs, ys, 80)
        _close(losses["port"], losses["jax"], 1e-4)
        assert losses["port"][-1] < 1e-2 < losses["port"][0]

    def test_adam_scheduler_lr_reaches_compiled_step(self):
        rs = np.random.RandomState(0)
        xs = rs.randn(32, 4).astype(np.float32)
        ys = xs @ rs.randn(4, 1).astype(np.float32)
        sched = {}

        def jopt(loss):
            sched["jax"] = paddle.optimizer.lr.StepDecay(0.05, step_size=5,
                                                         gamma=1e-9)
            o = paddle.optimizer.Adam(sched["jax"])
            o.minimize(loss)
            return o

        def opt(loss):
            sched["port"] = pt.optimizer.lr.StepDecay(0.05, step_size=5,
                                                      gamma=1e-9)
            o = pt.optimizer.Adam(None, lr=sched["port"])
            o.minimize(loss)
            return o

        def between(o, i):
            o._learning_rate.step()
        losses, main, _ = _train_both(jopt, opt, xs, ys, 30, between)
        _close(losses["port"], losses["jax"], 1e-4)
        port = losses["port"]
        assert port[4] < port[0]                 # the live rate: learning
        assert abs(port[29] - port[6]) < 1e-7 * max(1.0, abs(port[6]))
        assert len(main._train_cache) == 1       # one compiled step

    def test_two_none_batch_feeds_combine(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [None, 4], "float32")
            y = static.data("y", [None, 1], "float32")
            d = pt.mean((x - y) ** 2)
        r, = static.Executor().run(main, feed={
            "x": np.ones((5, 4), np.float32),
            "y": np.zeros((5, 1), np.float32)}, fetch_list=[d])
        _close(r, 1.0)


class TestStaticControlFlowOverFeeds:
    def test_cond_follows_the_feed(self):
        results = {}
        for name, (on, mod) in {"jax": (jax_static, jstatic),
                                "port": (port_static, static)}.items():
            with on():
                main = mod.Program()
                with mod.program_guard(main):
                    x = mod.data("x", [1], "float32")
                    out = mod.nn.cond(x[0] > 0, lambda: x * 2,
                                      lambda: x - 1)
                exe = mod.Executor()
                results[name] = [
                    exe.run(main, feed={"x": np.array([v], np.float32)},
                            fetch_list=[out])[0] for v in (3.0, -3.0)]
        _close(results["port"], results["jax"])
        _close(results["port"], [[6.0], [-4.0]])
        assert [o.name for o in main.ops][-1] == "cond"

    def test_while_loop_over_feed(self):
        results = {}
        for name, (on, mod, api) in {"jax": (jax_static, jstatic, paddle),
                                     "port": (port_static, static,
                                              pt)}.items():
            with on():
                main = mod.Program()
                with mod.program_guard(main):
                    x = mod.data("x", [1], "float32")
                    i = api.zeros([1], "float32")
                    _, out = mod.nn.while_loop(lambda i, s: i[0] < 5,
                                               lambda i, s: (i + 1, s * 2),
                                               [i, x])
                exe = mod.Executor()
                results[name] = [
                    exe.run(main, feed={"x": np.array([v], np.float32)},
                            fetch_list=[out])[0] for v in (1.0, -0.5)]
        _close(results["port"], results["jax"])
        _close(results["port"], [[32.0], [-16.0]])


class TestPortRecorder:
    """What the port's recorder adds to the spec."""

    def test_numpy_pylayer_replays_the_new_feed(self, static_mode):
        class NumpyTanh(pt.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = torch.from_numpy(np.tanh(x.detach().numpy()))
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                y, = ctx.saved_tensor()
                return dy * (1 - y * y)

        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [3], "float32")
            y = NumpyTanh.apply(x * 2) + 1
        assert [o.name for o in main.ops] == ["mul", "NumpyTanh", "add"]
        for v in ([0.1, -0.2, 0.3], [1.0, 2.0, -3.0]):
            a = np.array(v, np.float32)
            r, = static.Executor().run(main, feed={"x": a}, fetch_list=[y])
            _close(r, np.tanh(2 * a) + 1)

    def test_unrecorded_tensor_raises(self, static_mode):
        stash = []

        class Leak(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                stash.append(x * 3)      # made inside the op, handed out
                return x + 1

            @staticmethod
            def backward(ctx, g):
                return g

        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            Leak.apply(x)
            with pytest.raises(RuntimeError, match="'add'.*neither a "
                                                   "placeholder"):
                _ = stash[0] + 1

    def test_host_read_of_a_placeholder_raises(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            with pytest.raises(RuntimeError, match="no data until"):
                x.numpy()
            with pytest.raises(RuntimeError, match="no data until"):
                bool((x > 0).all())

    def test_py_func_runs_at_every_replay(self, static_mode):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            y = static.py_func(
                lambda t: torch.from_numpy(np.sqrt(t.numpy())), x * 4,
                None) + 0
        r, = static.Executor().run(main, feed={"x": np.array(
            [1.0, 4.0], np.float32)}, fetch_list=[y])
        _close(r, [2.0, 4.0])

    def test_print_prints_at_each_run_not_at_record(self, static_mode,
                                                     capsys):
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            y = static.Print(x * 2, message="seen") + 1
        assert "seen" not in capsys.readouterr().out
        for v in (1.0, 3.0):
            r, = static.Executor().run(main, feed={"x": np.full(
                2, v, np.float32)}, fetch_list=[y])
            _close(r, [2 * v + 1] * 2)
            assert f"seen shape=[2] dtype=torch.float32 data=[{2 * v}, " \
                f"{2 * v}]" in capsys.readouterr().out

    @pytest.mark.parametrize("builder", ["fc_relu", "embedding", "conv2d",
                                         "layer_norm", "prelu",
                                         "group_norm"])
    def test_builders_match_jax(self, builder):
        rs = np.random.RandomState(3)
        cases = {
            "fc_relu": ([None, 3, 4], "float32",
                        lambda m, x: m.nn.fc(x, 5, num_flatten_dims=2,
                                             activation="relu")),
            "embedding": ([None, 5], "int64",
                          lambda m, x: m.nn.embedding(x, [11, 6])),
            "conv2d": ([None, 3, 8, 8], "float32",
                       lambda m, x: m.nn.conv2d(x, 4, 3, padding=1,
                                                act="relu")),
            "layer_norm": ([2, 4, 6], "float32",
                           lambda m, x: m.nn.layer_norm(x)),
            "prelu": ([None, 3, 4], "float32",
                      lambda m, x: m.nn.prelu(x, mode="channel")),
            "group_norm": ([None, 4, 3, 3], "float32",
                           lambda m, x: m.nn.group_norm(x, 2)),
        }
        shape, dtype, build = cases[builder]
        feed_shape = [2] + shape[1:]
        feed = rs.randint(0, 11, feed_shape) if dtype == "int64" else \
            rs.randn(*feed_shape).astype(np.float32)
        with jax_static():
            jmain = jstatic.Program()
            with jstatic.program_guard(jmain):
                jy = build(jstatic, jstatic.data("x", shape, dtype))
            state = jstatic.save_program_state(program=jmain)
            # the JAX builders initialize some parameters to constants:
            # random values everywhere test the carry
            state = {k: rs.randn(*v.shape).astype(v.dtype)
                     if v.dtype == np.float32 else v
                     for k, v in state.items()}
            jstatic.set_program_state(jmain, state)
            want, = jstatic.Executor().run(jmain, feed={"x": feed},
                                           fetch_list=[jy])
        with port_static():
            main = static.Program()
            with static.program_guard(main):
                y = build(static, static.data("x", shape, dtype))
            static.set_program_state(main, state)
            got, = static.Executor().run(main, feed={"x": feed},
                                         fetch_list=[y])
        _close(got, want, 1e-4)


def test_gpt_trains_through_the_executor():
    """The static_train phase of ``chip_smoke.py`` at a tiny width on the
    CPU: GPT built under static mode, AdamW.minimize, the Executor's
    losses equal the eager model's from the same state and batches."""
    import chip_smoke

    res = chip_smoke.drive_static_train(
        dict(chip_smoke.STATIC_TINY), batch=2, seq=16, device="cpu",
        steps=4, eager_steps=3)
    assert res["loss_rel_err"] <= 1e-5, res
    assert all(np.isfinite(res["losses"]))
    assert res["infer_err"] <= 1e-5, res
