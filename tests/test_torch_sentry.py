"""The divergence sentry, the snapshot ring and sentry rollback of the
port, against the JAX package's, on the CPU.

``tests/test_sentry.py`` is the spec: every class but the hapi ones has
a counterpart here (``hapi.Model.fit(sentry=)`` is not ported, ROADMAP.md
A.5 step 5).  The port's side runs its own rigs (``torch.nn.Linear``, the
port's optimizers and ``jit.to_static``); where both packages can take
the same inputs they do:

- the sentry's 5 report lanes for one seeded loss and grad-norm sequence
  (spikes, NaN, Inf and an AMP overflow in it) are compared exactly;
- the bench's rollback drill (``Linear(8, 8)``, AdamW, ``train.nan`` at
  step 5, 8 steps) runs in both packages from one state dict: the
  counters are equal and the final weights within 1e-5.

The port's rollback, rolled back and replayed in place, is held bitwise
to the port's uninterrupted run of the same effective schedule.
"""
import hashlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch import jit, rng
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.fault_tolerance import (
    ANOMALY_GRAD_RATIO, ANOMALY_LOSS_SPIKE, ANOMALY_NONFINITE_GRAD,
    ANOMALY_NONFINITE_LOSS, DivergenceSentry, FaultPlan,
    MemorySnapshotRing, ResilientLoop, SentryEscalation, global_grad_norm,
    pack_state, restore_packed_state,
)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD, AdamW

CPU = "cpu"
#: final weights of the port's drill against the JAX drill's (f32)
WEIGHT_ATOL = 1e-5


def _t(x):
    return torch.tensor(np.float32(x))


def _digest(net, opt):
    """sha256 over the parameters, the optimizer's tensors and the
    generators' states: the bitwise oracle."""
    h = hashlib.sha256()
    for v in net.state_dict().values():
        h.update(v.detach().contiguous().numpy().tobytes())
    for st in opt.state_dict()["state"].values():
        for v in st.values():
            if isinstance(v, torch.Tensor):
                h.update(v.contiguous().numpy().tobytes())
    for v in rng.get_rng_state().values():
        h.update(v.numpy().tobytes())
    return h.hexdigest()


def _loop(net, opt, root, **kw):
    kw.setdefault("verbose", False)
    return ResilientLoop(
        root, state_fn=lambda: {"model": net.state_dict(),
                                "opt": opt.state_dict()},
        restore_fn=lambda s: (net.load_state_dict(s["model"]),
                              opt.set_state_dict(s["opt"])), **kw)


@pytest.fixture(scope="module", autouse=True)
def _single_device():
    """The JAX side runs unsharded (an earlier file in the worker may have
    left a mesh set)."""
    from paddle_tpu.distributed import mesh as mesh_mod

    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


class TestDetectorUnit:
    def _sentry(self, **kw):
        kw.setdefault("window", 8)
        kw.setdefault("min_history", 3)
        kw.setdefault("spike_factor", 4.0)
        kw.setdefault("grad_ratio", 10.0)
        kw.setdefault("device", CPU)
        return DivergenceSentry(**kw)

    def test_nonfinite_loss_latches(self):
        s = self._sentry()
        s.observe(_t("nan"))
        r = s.poll()
        assert r.code & ANOMALY_NONFINITE_LOSS
        assert r.anomalous and "nonfinite_loss" in r.flags()
        assert np.isnan(r.loss)

    def test_loss_spike_needs_warmup(self):
        s = self._sentry()
        s.observe(_t(1.0))
        s.observe(_t(100.0))
        assert not s.poll().anomalous
        s2 = self._sentry()
        for _ in range(4):
            s2.observe(_t(1.0))
            assert not s2.poll().anomalous
        s2.observe(_t(50.0))
        r = s2.poll()
        assert r.code == ANOMALY_LOSS_SPIKE
        assert r.window_mean == pytest.approx(1.0)
        # the anomalous loss never entered the window
        assert int(s2.state_dict()["n"]) == 4

    def test_spike_disarmed_on_nonpositive_mean(self):
        s = self._sentry()
        for _ in range(5):
            s.observe(_t(-3.0))
        s.observe(_t(0.5))
        assert not s.poll().anomalous
        s2 = self._sentry()
        for _ in range(5):
            s2.observe(_t(0.0))
        s2.observe(_t(1e-6))
        assert not s2.poll().anomalous
        s2.observe(_t("inf"))
        assert s2.poll().code & ANOMALY_NONFINITE_LOSS

    def test_grad_norm_checks(self):
        s = self._sentry()
        for _ in range(4):
            s.observe(_t(1.0), grad_norm=_t(2.0))
        s.observe(_t(1.0), grad_norm=_t(2000.0))
        assert s.poll().code == ANOMALY_GRAD_RATIO
        s.observe(_t(1.0), grad_norm=_t("inf"))
        assert s.poll().code == ANOMALY_NONFINITE_GRAD

    def test_found_inf_is_routine(self):
        s = self._sentry()
        for _ in range(4):
            s.observe(_t(1.0), grad_norm=_t(1.0))
        n_before = int(s.state_dict()["n"])
        s.observe(_t(500.0), grad_norm=_t("inf"),
                  found_inf=torch.tensor(True))
        r = s.poll()
        assert not r.anomalous and r.code == 0
        assert int(s.state_dict()["n"]) == n_before
        s.observe(_t(1.0), grad_norm=_t(1.0))
        assert not s.poll().anomalous

    def test_anomaly_latches_across_observes_until_poll(self):
        s = self._sentry()
        for _ in range(4):
            s.observe(_t(1.0))
            s.poll()
        s.observe(_t("nan"))
        s.observe(_t(1.0))
        r = s.poll()
        assert r.code & ANOMALY_NONFINITE_LOSS
        assert np.isnan(r.loss)
        assert s.poll().code == 0

    def test_report_scale_lane(self):
        s = self._sentry()
        s.observe(_t(1.0), scale=_t(4096.0))
        assert s.poll().scale == 4096.0

    def test_policy_counters(self):
        s = self._sentry(max_rollbacks=1)
        r = s.poll()
        assert s.note_anomaly(5, r) == "rollback"
        assert s.should_skip(5) and not s.should_skip(4)
        s.note_clean(4)
        assert s.note_anomaly(6, r) == "escalate"
        s2 = self._sentry(max_rollbacks=1)
        s2.note_anomaly(5, r)
        s2.note_clean(6)
        assert s2.note_anomaly(7, r) == "rollback"

    def test_validation(self):
        for kw in ({"window": 0}, {"spike_factor": 1.0},
                   {"snapshot_every": 0}, {"max_rollbacks": -1}):
            with pytest.raises(ValueError):
                DivergenceSentry(device=CPU, **kw)
        with pytest.raises(ValueError):
            MemorySnapshotRing(0)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                DivergenceSentry()

    def test_state_lives_on_the_device_and_loads_in_place(self):
        """The latch state is made at construction and every write is in
        place (what a captured step needs); a load keeps the tensors."""
        s = self._sentry()
        ids = {k: v.data_ptr() for k, v in s.state_dict().items()}
        for x in (1.0, 2.0, "nan"):
            s.observe(_t(x), grad_norm=_t(1.0))
        saved = {k: v.clone() for k, v in s.state_dict().items()}
        s.poll()
        s.observe(_t(3.0))
        s.load_state_dict(saved)
        assert {k: v.data_ptr() for k, v in s.state_dict().items()} == ids
        for k, v in s.state_dict().items():
            torch.testing.assert_close(v, saved[k], rtol=0, atol=0,
                                       equal_nan=True, msg=k)


class TestDetectorParity:
    def test_report_lanes_equal_the_jax_sentry(self):
        """One seeded sequence of losses and grad norms (a spike, a NaN,
        an Inf grad and an AMP overflow among them) through both
        sentries: every poll's 5 lanes and the window state, exactly."""
        import paddle_tpu as paddle
        from paddle_tpu.distributed.fault_tolerance import (
            DivergenceSentry as JaxSentry,
        )
        import jax.numpy as jnp

        rs = np.random.RandomState(11)
        losses = (rs.rand(24) * 2 + 1).astype(np.float32)
        grads = (rs.rand(24) * 3 + 0.5).astype(np.float32)
        losses[9], losses[14] = 40.0, np.nan
        grads[17], grads[20] = np.inf, 90.0
        inf_at = {12}
        kw = dict(window=8, min_history=3, spike_factor=4.0,
                  grad_ratio=10.0, ema_decay=0.9)
        port, jax_s = DivergenceSentry(device=CPU, **kw), JaxSentry(**kw)
        for i, (lo, g) in enumerate(zip(losses, grads)):
            fi = i in inf_at
            port.observe(_t(lo), grad_norm=_t(g),
                         found_inf=torch.tensor(fi),
                         scale=_t(2.0 ** (i % 5)))
            jax_s.observe(paddle.to_tensor(lo), grad_norm=paddle.to_tensor(g),
                          found_inf=jnp.bool_(fi),
                          scale=paddle.to_tensor(np.float32(2.0 ** (i % 5))))
            a, b = port.poll(), jax_s.poll()
            np.testing.assert_array_equal(
                np.array(a, np.float32), np.array(b, np.float32),
                err_msg=f"observation {i}")
        for k, v in port.state_dict().items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(jax_s.state_dict()[k].numpy()),
                err_msg=k)
        assert port.polls == jax_s.polls == 24


class TestSnapshotRing:
    def test_retention_and_eviction(self):
        ring = MemorySnapshotRing(capacity=3)
        for step in range(1, 6):
            ring.take({"user": {"w": torch.full((2, 2), float(step))},
                       "@step": step})
        assert ring.steps() == [3, 4, 5]
        assert len(ring) == 3 and ring.taken == 5 and ring.evictions == 2
        snap = ring.snapshot()
        assert snap["depth"] == 3 and snap["bytes"] > 0

    def test_retake_same_step_replaces(self):
        ring = MemorySnapshotRing(capacity=2)
        for step in (2, 4, 4):
            ring.take({"user": {}, "@step": step})
        assert ring.steps() == [2, 4]
        assert ring.evictions == 0

    def test_newest_is_fresh_copy(self):
        ring = MemorySnapshotRing(capacity=2)
        w = torch.ones(2, 2)
        ring.take({"user": {"w": w}, "@step": 1})
        w.zero_()                          # the ring never aliases w
        a = ring.newest()
        a["user"]["w"].zero_()
        b = ring.newest()
        assert torch.equal(b["user"]["w"], torch.ones(2, 2))
        assert b["user"]["w"] is not w

    def test_evicted_buffers_are_reused(self):
        """At steady state a snapshot allocates nothing: the evicted
        entry's host buffers take the next one."""
        ring = MemorySnapshotRing(capacity=1)
        ring.take({"user": {"w": torch.ones(4)}, "@step": 1})
        ptr = ring.newest(copy=False)["user"]["w"].data_ptr()
        ring.take({"user": {"w": torch.full((4,), 2.0)}, "@step": 2})
        got = ring.newest(copy=False)["user"]["w"]
        assert got.data_ptr() == ptr and torch.equal(got,
                                                     torch.full((4,), 2.0))

    def test_memory_and_disk_tiers_cross_restore(self, tmp_path):
        rng.seed(11)
        scaler = GradScaler(init_loss_scaling=1536.0)
        w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        state = pack_state({"w": w}, 7, scaler=scaler)
        ring = MemorySnapshotRing(capacity=1)
        ring.take(state)
        root = str(tmp_path / "ck")
        ckpt.save_generation(ring.newest(), root, 7)
        assert ckpt.verify_checkpoint(ckpt.generation_dir(root, 7)) == []
        got = {}
        scaler2 = GradScaler(init_loss_scaling=2.0)
        step, loaded = ckpt.load_generation(root, device=CPU)
        restored_step = restore_packed_state(
            loaded, lambda u: got.update(u), scaler=scaler2)
        assert step == restored_step == 7
        assert torch.equal(got["w"], w)
        assert scaler2.get_loss_scaling() == 1536.0


class TestTrainFaultInjection:
    def test_env_parsing(self):
        plan = FaultPlan.from_env({
            "PADDLE_TPU_FT_TRAIN_FAULTS":
                "train.nan@5, train.spike@7x2:factor=100"})
        assert plan.armed
        assert [r["kind"] for r in plan.train_faults] == ["nan", "spike"]
        assert plan.train_faults[1]["times"] == 2
        assert plan.train_faults[1]["factor"] == 100.0
        assert not FaultPlan.from_env({}).armed

    def test_bad_specs_raise(self):
        for bad in ("train.nope@3", "train.nan", "train.nan@3:factor=2",
                    "train.spike@3:stall=1"):
            with pytest.raises(ValueError):
                FaultPlan.from_env({"PADDLE_TPU_FT_TRAIN_FAULTS": bad})

    def test_parsing_equals_the_jax_plan(self):
        from paddle_tpu.distributed.fault_tolerance import (
            FaultPlan as JaxPlan,
        )

        env = {"PADDLE_TPU_FT_TRAIN_FAULTS":
               "train.nan@5,train.spike@7x2:factor=100,"
               "train.straggler@3x4:stall=0.5,elastic.heartbeat@2",
               "PADDLE_TPU_FT_DIE_AT_STEP": "9",
               "PADDLE_TPU_FT_DIE_SIGNAL": "INT"}
        a, b = FaultPlan.from_env(env), JaxPlan.from_env(env)
        assert a.train_faults == b.train_faults
        assert (a.die_at_step, a.die_signal) == (b.die_at_step,
                                                 b.die_signal)

    def test_corrupt_batch_window_and_once_per_step(self):
        plan = FaultPlan().add_train_fault("train.nan", 5) \
                          .add_train_fault("train.spike", 8, times=2,
                                           factor=50.0)
        x = np.ones(4, np.float32)
        assert np.isfinite(plan.corrupt_batch(4, x)).all()
        out = plan.corrupt_batch(5, x)
        assert np.isnan(out).all()
        assert out.shape == x.shape and out.dtype == x.dtype
        assert np.isfinite(plan.corrupt_batch(5, x)).all()
        np.testing.assert_array_equal(plan.corrupt_batch(8, x), x * 50)
        np.testing.assert_array_equal(plan.corrupt_batch(9, x), x * 50)
        assert np.isfinite(plan.corrupt_batch(10, x)).all()
        # a tensor in, a tensor out
        t = plan.corrupt_batch(5, torch.ones(4))
        assert torch.equal(t, torch.ones(4))
        plan2 = FaultPlan().add_train_fault("train.nan", 1)
        t = plan2.corrupt_batch(1, torch.ones(1))
        assert isinstance(t, torch.Tensor) and torch.isnan(t).all()

    def test_corrupt_batch_rejects_integer_batches(self):
        plan = FaultPlan().add_train_fault("train.nan", 2)
        ids = np.arange(6, dtype=np.int32)
        np.testing.assert_array_equal(plan.corrupt_batch(1, ids), ids)
        with pytest.raises(ValueError, match="float batch"):
            plan.corrupt_batch(2, ids)
        with pytest.raises(ValueError, match="float batch"):
            plan.corrupt_batch(2, torch.from_numpy(ids))


def _to_static_rig(blocklist=()):
    """A compiled train step (forward, backward, AdamW, dropout) with the
    sentry's latch inside it."""
    torch.manual_seed(42)
    rng.seed(42)
    net = torch.nn.Linear(6, 6)
    opt = AdamW(net.parameters(), lr=0.05)
    sentry = DivergenceSentry(window=8, min_history=2, spike_factor=4.0,
                              grad_ratio=100.0, snapshot_every=2,
                              ring_capacity=2, max_rollbacks=2,
                              blocklist=blocklist, device=CPU)

    @jit.to_static
    def train_step(x):
        y = F.dropout(net(x), p=0.25, training=True)
        loss = (y * y).mean()
        loss.backward()
        sentry.observe(loss, grad_norm=global_grad_norm(net.parameters()))
        opt.step()
        opt.clear_grad()
        return loss

    return net, opt, sentry, train_step


def _batch_for(step):
    rs = np.random.RandomState(1000 + step)
    return torch.from_numpy(rs.randn(4, 6).astype(np.float32))


class TestRollbackParity:
    def test_injected_nan_rollback_is_bitwise_identical(self, tmp_path):
        plan = FaultPlan().add_train_fault("train.nan", 5)
        net1, opt1, s1, step1 = _to_static_rig()

        def chaos_fn(step):
            step1(plan.corrupt_batch(step, _batch_for(step)))

        loop1 = _loop(net1, opt1, str(tmp_path / "chaos"), save_every=4,
                      keep_last=2, sentry=s1)
        chaos_fn(0)
        keys_warm = set(step1.program_cache.keys())
        assert len(keys_warm) == 1
        params = [p.data_ptr() for p in net1.parameters()]
        completed = loop1.run(chaos_fn, 10)
        assert completed == 10
        assert set(step1.program_cache.keys()) == keys_warm
        assert s1.anomalies == 1 and s1.rollbacks == 1
        assert sorted(s1.blocklist) == [5]
        assert s1.skipped_steps == 1
        assert loop1.last_rollback_recovery_s > 0
        stats = loop1.sentry_stats()
        assert stats["last_rollback_recovery_ms"] > 0
        assert stats["ring"]["depth"] == 2
        assert any(e.get("anomaly") for e in loop1.flight._ring)
        # restored in place: no parameter moved
        assert [p.data_ptr() for p in net1.parameters()] == params
        digest1 = _digest(net1, opt1)

        net2, opt2, s2, step2 = _to_static_rig(blocklist={5})

        def oracle_fn(step):
            step2(_batch_for(step))

        loop2 = _loop(net2, opt2, str(tmp_path / "oracle"), save_every=4,
                      keep_last=2, sentry=s2)
        oracle_fn(0)
        loop2.run(oracle_fn, 10)
        assert s2.anomalies == 0
        assert digest1 == _digest(net2, opt2)
        assert len(step2.program_cache) == 1

    def test_rollback_to_the_seed_snapshot_resets_born_state(self,
                                                             tmp_path):
        """A NaN at step 1 rolls back to the snapshot taken before any
        step, when the optimizer had no state yet: the moments born since
        go back, in place, to what the first step makes, and the run ends
        bitwise equal to the oracle that skips step 1."""
        plan = FaultPlan().add_train_fault("train.nan", 1)
        net1, opt1, s1, step1 = _to_static_rig()
        loop1 = _loop(net1, opt1, str(tmp_path / "a"), save_every=None,
                      save_final=False, sentry=s1)
        loop1.run(lambda step: step1(plan.corrupt_batch(
            step, _batch_for(step))), 4)
        assert (s1.anomalies, s1.rollbacks, s1.skipped_steps) == (1, 1, 1)
        digest1 = _digest(net1, opt1)
        net2, opt2, s2, step2 = _to_static_rig(blocklist={1})
        _loop(net2, opt2, str(tmp_path / "b"), save_every=None,
              save_final=False, sentry=s2).run(
            lambda step: step2(_batch_for(step)), 4)
        assert digest1 == _digest(net2, opt2)

    def test_skipped_step_still_hits_commit_boundary(self, tmp_path):
        net, opt, sentry, train_step = _to_static_rig(blocklist={3})
        root = str(tmp_path / "ck")
        loop = _loop(net, opt, root, save_every=4, keep_last=3,
                     save_final=False, sentry=sentry)
        loop.run(lambda step: train_step(_batch_for(step)), 6)
        assert 4 in ckpt.list_generations(root)

    def test_finite_spike_rolls_back_too(self, tmp_path):
        plan = FaultPlan().add_train_fault("train.spike", 6, factor=1e4)
        net, opt, sentry, train_step = _to_static_rig()
        loop = _loop(net, opt, str(tmp_path / "spike"), save_every=None,
                     save_final=False, sentry=sentry)
        loop.run(lambda step: train_step(
            plan.corrupt_batch(step, _batch_for(step))), 9)
        assert sentry.anomalies == 1 and sentry.rollbacks == 1
        assert sorted(sentry.blocklist) == [6]
        assert torch.isfinite(net.weight).all()

    def test_bench_drill_counters_and_weights_match_jax(self, tmp_path):
        """The bench's rollback drill in both packages from one state
        dict: equal counters, final weights within WEIGHT_ATOL."""
        import paddle_tpu as paddle
        import paddle_tpu.nn as jnn
        from paddle_tpu.distributed.fault_tolerance import (
            DivergenceSentry as JaxSentry, FaultPlan as JaxPlan,
            ResilientLoop as JaxLoop, global_grad_norm as jax_norm,
        )

        skw = dict(window=8, min_history=2, spike_factor=8.0,
                   grad_ratio=100.0, snapshot_every=2, ring_capacity=2,
                   max_rollbacks=2)
        paddle.seed(7)
        jnet = jnn.Linear(8, 8)
        w0 = np.asarray(jnet.weight.numpy())
        b0 = np.asarray(jnet.bias.numpy())
        jopt = paddle.optimizer.AdamW(learning_rate=0.05,
                                      parameters=jnet.parameters())
        jsen = JaxSentry(**skw)
        jplan = JaxPlan().add_train_fault("train.nan", 5)

        @paddle.jit.to_static
        def jstep(x):
            loss = (jnet(x) ** 2).mean()
            loss.backward()
            jsen.observe(loss, grad_norm=jax_norm(jnet.parameters()))
            jopt.step()
            jopt.clear_grad()
            return loss

        def jfn(step):
            rs = np.random.RandomState(100 + step)
            jstep(paddle.to_tensor(jplan.corrupt_batch(
                step, rs.randn(4, 8).astype(np.float32))))

        jloop = JaxLoop(str(tmp_path / "jax"),
                        state_fn=lambda: {"m": jnet.state_dict(),
                                          "o": jopt.state_dict()},
                        restore_fn=lambda s: (jnet.set_state_dict(s["m"]),
                                              jopt.set_state_dict(s["o"])),
                        save_every=None, save_final=False, sentry=jsen,
                        verbose=False)
        jloop.run(jfn, 8)

        net = torch.nn.Linear(8, 8)
        with torch.no_grad():
            net.weight.copy_(torch.from_numpy(w0.T.copy()))
            net.bias.copy_(torch.from_numpy(b0))
        opt = AdamW(net.parameters(), lr=0.05)
        sen = DivergenceSentry(device=CPU, **skw)
        plan = FaultPlan().add_train_fault("train.nan", 5)

        @jit.to_static
        def step_(x):
            loss = (net(x) ** 2).mean()
            loss.backward()
            sen.observe(loss, grad_norm=global_grad_norm(net.parameters()))
            opt.step()
            opt.clear_grad()
            return loss

        def fn(step):
            rs = np.random.RandomState(100 + step)
            step_(plan.corrupt_batch(step, torch.from_numpy(
                rs.randn(4, 8).astype(np.float32))))

        loop = _loop(net, opt, str(tmp_path / "port"), save_every=None,
                     save_final=False, sentry=sen)
        loop.run(fn, 8)
        drop = ("consecutive",)
        assert {k: v for k, v in sen.counters().items() if k not in drop} \
            == {k: v for k, v in jsen.counters().items() if k not in drop}
        assert (sen.anomalies, sen.rollbacks, sen.skipped_steps) == (1, 1, 1)
        np.testing.assert_allclose(
            net.weight.detach().numpy(),
            np.asarray(jnet.weight.numpy()).T, atol=WEIGHT_ATOL, rtol=0)
        np.testing.assert_allclose(net.bias.detach().numpy(),
                                   np.asarray(jnet.bias.numpy()),
                                   atol=WEIGHT_ATOL, rtol=0)


class TestEscalation:
    def test_max_rollbacks_escalates_fail_safe(self, tmp_path):
        from paddle_tpu_torch import profiler

        torch.manual_seed(9)
        net = torch.nn.Linear(4, 4)
        opt = SGD(net.parameters(), lr=0.1)
        sentry = DivergenceSentry(window=4, min_history=2, snapshot_every=2,
                                  ring_capacity=2, max_rollbacks=2,
                                  device=CPU)

        def step_fn(step):
            x = _batch_for(step)[:, :4]
            if step >= 3:
                x = x * float("nan")
            loss = (net(x) ** 2).mean()
            loss.backward()
            sentry.observe(loss,
                           grad_norm=global_grad_norm(net.parameters()))
            opt.step()
            opt.clear_grad()

        root = str(tmp_path / "ck")
        loop = _loop(net, opt, root, save_every=2, keep_last=2,
                     sentry=sentry)
        with pytest.raises(SentryEscalation) as ei:
            loop.run(step_fn, 10)
        exc = ei.value
        assert sentry.rollbacks == 2 and sentry.escalations == 1
        assert exc.report.anomalous
        assert exc.flight_dump["reason"] == "sentry_escalation"
        assert exc.flight_dump["events"]
        assert loop.flight.dumps[-1] is exc.flight_dump
        recs = profiler.flight_record().get("training", [])
        assert any(d["reason"] == "sentry_escalation"
                   for r in recs for d in r.get("dumps", []))
        step, path = ckpt.latest_valid(root)
        assert ckpt.verify_checkpoint(path) == []
        assert step == 4
        assert torch.isfinite(net.weight).all()


class TestScalerContinuity:
    def _scaled_rig(self, seed=5):
        torch.manual_seed(seed)
        net = torch.nn.Linear(4, 4)
        opt = SGD(net.parameters(), lr=0.05)
        scaler = GradScaler(init_loss_scaling=512.0, incr_ratio=2.0,
                            incr_every_n_steps=2)
        return net, opt, scaler

    def _scaled_step(self, net, opt, scaler):
        def step_fn(step):
            loss = (net(_batch_for(step)[:, :4]) ** 2).mean()
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
        return step_fn

    def test_disk_resume_restores_scale_bitwise(self, tmp_path):
        net1, opt1, scaler1 = self._scaled_rig()
        root = str(tmp_path / "ck")
        loop1 = ResilientLoop(
            root, state_fn=lambda: {"model": net1.state_dict(),
                                    "opt": opt1.state_dict()},
            restore_fn=lambda s: net1.load_state_dict(s["model"]),
            save_every=2, scaler=scaler1, verbose=False)
        loop1.run(self._scaled_step(net1, opt1, scaler1), 5)
        grown = scaler1.get_loss_scaling()
        assert grown == 2048.0

        net2, opt2, scaler2 = self._scaled_rig(seed=6)
        scaler2.scale(torch.ones(()))        # its state on the device
        scale_t = scaler2.scale_tensor
        assert scaler2.get_loss_scaling() == 512.0
        loop2 = ResilientLoop(
            root, state_fn=lambda: {"model": net2.state_dict(),
                                    "opt": opt2.state_dict()},
            restore_fn=lambda s: net2.load_state_dict(s["model"]),
            scaler=scaler2, verbose=False)
        assert loop2.resume() == 5
        assert scaler2.get_loss_scaling() == grown
        assert scaler2.scale_tensor is scale_t      # loaded in place
        sd1, sd2 = scaler1.state_dict(), scaler2.state_dict()
        assert torch.equal(sd1["scale"], sd2["scale"])
        assert torch.equal(sd1["incr_count"], sd2["incr_count"])

    def test_ring_rollback_restores_scale(self):
        scaler = GradScaler(init_loss_scaling=1024.0)
        ring = MemorySnapshotRing(capacity=1)
        ring.take(pack_state({}, 4, scaler=scaler))
        scaler.set_init_loss_scaling(64.0)            # drift
        restore_packed_state(ring.newest(), lambda u: None, scaler=scaler)
        assert scaler.get_loss_scaling() == 1024.0

    def test_amp_overflow_backoff_does_not_roll_back(self, tmp_path):
        torch.manual_seed(13)
        net = torch.nn.Linear(4, 4)
        opt = SGD(net.parameters(), lr=0.05)
        scaler = GradScaler(init_loss_scaling=1024.0,
                            decr_every_n_nan_or_inf=1, decr_ratio=0.5,
                            incr_every_n_steps=1000)
        sentry = DivergenceSentry(window=8, min_history=1, spike_factor=4.0,
                                  grad_ratio=10.0, snapshot_every=2,
                                  ring_capacity=2, max_rollbacks=1,
                                  device=CPU)

        def step_fn(step):
            loss = (net(_batch_for(step)[:, :4]) ** 2).mean()
            scaler.scale(loss).backward()
            if step == 3:
                for p in net.parameters():
                    p.grad = p.grad * float("inf")
            scaler.unscale_(opt)
            sentry.observe(loss,
                           grad_norm=global_grad_norm(net.parameters()),
                           found_inf=scaler.found_inf,
                           scale=scaler.scale_tensor)
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()

        loop = ResilientLoop(
            str(tmp_path / "ck"),
            state_fn=lambda: {"model": net.state_dict(),
                              "opt": opt.state_dict()},
            restore_fn=lambda s: net.load_state_dict(s["model"]),
            save_every=None, save_final=False, sentry=sentry,
            scaler=scaler, verbose=False)
        loop.run(step_fn, 6)
        assert sentry.anomalies == 0 and sentry.rollbacks == 0
        assert sentry.blocklist == set()
        assert scaler.get_loss_scaling() == 512.0
        assert torch.isfinite(net.weight).all()
