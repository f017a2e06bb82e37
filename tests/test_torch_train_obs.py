"""The training step observatory of the port, against the JAX package's,
on the CPU.

``tests/test_train_obs.py`` is the spec: each of its classes but the hapi
ones and ``TestStepAblationOffline`` (a JAX tool) has a counterpart here.
Where the packages compare directly they do: the bench's NaN rollback
drill run by both gives the same timeline (attempts, terminals, events,
spans, the rollback link) and the same compile-ledger counts.  The cost
ledger counts one eager run of the port's step (flops by
``FlopCounterMode``, attention by formula), held to the 6ND cross-check
and to its guard: the analysis leaves the program cache, the parameters
and the optimizer state as they were.
"""
import json

import numpy as np
import pytest
import torch

from paddle_tpu_torch import jit, obs, profiler
from paddle_tpu_torch.distributed.fault_tolerance import (
    DivergenceSentry, FaultPlan, ResilientLoop, global_grad_norm,
)
from paddle_tpu_torch.obs import (
    NULL_TIMELINE, CompileLedger, CostLedger, StepTimeline,
    validate_timeline,
)
from paddle_tpu_torch.obs.cost import attention_cost, chip_spec
from paddle_tpu_torch.optimizer import AdamW

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _single_device():
    from paddle_tpu.distributed import mesh as mesh_mod

    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _sentry(**kw):
    for k, v in dict(window=8, min_history=2, spike_factor=8.0,
                     grad_ratio=100.0, snapshot_every=2, ring_capacity=2,
                     max_rollbacks=2).items():
        kw.setdefault(k, v)
    return DivergenceSentry(device=CPU, **kw)


def _rig(seed=7):
    torch.manual_seed(seed)
    net = torch.nn.Linear(8, 8)
    opt = AdamW(net.parameters(), lr=0.05)
    sentry = _sentry()

    @jit.to_static
    def train_step(x):
        loss = (net(x) ** 2).mean()
        loss.backward()
        sentry.observe(loss, grad_norm=global_grad_norm(net.parameters()))
        opt.step()
        opt.clear_grad()
        return loss

    return net, opt, sentry, train_step


def _run_nan_drill(tmp_path, timeline, compile_ledger=None, steps=8,
                   nan_at=5, cost_ledger=None):
    net, opt, sentry, train_step = _rig()
    plan = FaultPlan().add_train_fault("train.nan", nan_at)

    def step_fn(step):
        rs = np.random.RandomState(100 + step)
        train_step(plan.corrupt_batch(step, torch.from_numpy(
            rs.randn(4, 8).astype(np.float32))))

    loop = ResilientLoop(
        str(tmp_path / "ck"),
        state_fn=lambda: {"m": net.state_dict(), "o": opt.state_dict()},
        restore_fn=lambda s: (net.load_state_dict(s["m"]),
                              opt.set_state_dict(s["o"])),
        save_every=None, save_final=False, sentry=sentry, verbose=False,
        timeline=timeline, compile_ledger=compile_ledger,
        cost_ledger=cost_ledger)
    loop.run(step_fn, steps)
    return loop, sentry, train_step


def _jax_drill(tmp_path, timeline, compile_ledger):
    """The same drill through the JAX package."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.distributed.fault_tolerance import (
        DivergenceSentry as JaxSentry, FaultPlan as JaxPlan,
        ResilientLoop as JaxLoop, global_grad_norm as jax_norm,
    )

    paddle.seed(7)
    net = jnn.Linear(8, 8)
    opt = paddle.optimizer.AdamW(learning_rate=0.05,
                                 parameters=net.parameters())
    sentry = JaxSentry(window=8, min_history=2, spike_factor=8.0,
                       grad_ratio=100.0, snapshot_every=2, ring_capacity=2,
                       max_rollbacks=2)
    plan = JaxPlan().add_train_fault("train.nan", 5)

    @paddle.jit.to_static
    def train_step(x):
        loss = (net(x) ** 2).mean()
        loss.backward()
        sentry.observe(loss, grad_norm=jax_norm(net.parameters()))
        opt.step()
        opt.clear_grad()
        return loss

    def step_fn(step):
        rs = np.random.RandomState(100 + step)
        train_step(paddle.to_tensor(plan.corrupt_batch(
            step, rs.randn(4, 8).astype(np.float32))))

    loop = JaxLoop(str(tmp_path / "jck"),
                   state_fn=lambda: {"m": net.state_dict(),
                                     "o": opt.state_dict()},
                   restore_fn=lambda s: (net.set_state_dict(s["m"]),
                                         opt.set_state_dict(s["o"])),
                   save_every=None, save_final=False, sentry=sentry,
                   verbose=False, timeline=timeline,
                   compile_ledger=compile_ledger)
    loop.run(step_fn, 8)
    return sentry


class TestStepTimeline:
    def test_loop_nan_rollback_chain_valid(self, tmp_path):
        tl = StepTimeline()
        loop, sentry, _ = _run_nan_drill(tmp_path, tl)
        assert sentry.rollbacks == 1 and sentry.skipped_steps == 1
        assert validate_timeline(tl) == []
        rolled = [s for s in tl.spans.values()
                  if s["state"] == "rolled_back"]
        assert len(rolled) == 1 and rolled[0]["name"] == "step"
        assert len([s for s in tl.spans.values()
                    if s["state"] == "skipped"]) == 1
        roots = {}
        for s in tl.spans.values():
            if s["parent"] is None:
                roots.setdefault(s["trace"], []).append(s)
        assert all(len(v) == 1 for v in roots.values())
        rb = [e for e in tl.events if e["kind"] == "rollback"]
        assert len(rb) == 1
        resume = tl.spans[rb[0]["resume_span"]]
        assert resume["name"] == "step"
        assert resume["t_start"] >= rb[0]["ts"]
        c = tl.counters()
        assert c["steps_completed"] == 8 and c["skipped"] == 1
        assert c["rolled_back"] == 1
        for ph in ("step_dispatch", "device_wait", "snapshot_capture",
                   "rollback_restore"):
            assert c["phase_ms"].get(ph, 0) > 0, ph

    def test_timeline_and_ledger_equal_the_jax_drill(self, tmp_path):
        """The same drill through both packages: the same attempts (trace
        names and terminal states, in order), events, counters and
        compile-ledger counts."""
        from paddle_tpu.obs import CompileLedger as JaxLedger
        from paddle_tpu.obs import StepTimeline as JaxTimeline

        tl, jtl = StepTimeline(), JaxTimeline()
        led, jled = CompileLedger(), JaxLedger()
        _, sentry, _ = _run_nan_drill(tmp_path, tl, compile_ledger=led)
        jsentry = _jax_drill(tmp_path, jtl, jled)

        def attempts(t):
            return [(s["trace"], s["name"], s["state"])
                    for _, s in sorted(t.spans.items())]

        assert attempts(tl) == attempts(jtl)
        assert [e["kind"] for e in tl.events] \
            == [e["kind"] for e in jtl.events]
        drop = ("phase_ms",)
        assert {k: v for k, v in tl.counters().items() if k not in drop} \
            == {k: v for k, v in jtl.counters().items() if k not in drop}
        assert (led.compiles, led.steady_state_misses) \
            == (jled.compiles, jled.steady_state_misses) == (1, 0)
        assert sentry.counters()["blocklist"] \
            == jsentry.counters()["blocklist"]

    def test_perfetto_and_jsonl_exports_well_formed(self, tmp_path):
        tl = StepTimeline()
        _run_nan_drill(tmp_path, tl)
        chrome = obs.chrome_trace(tl)
        json.dumps(chrome)
        rolled = [e for e in chrome["traceEvents"] if e.get("ph") == "X"
                  and e["args"]["state"] == "rolled_back"]
        assert len(rolled) == 1
        threads = {e["args"]["name"] for e in chrome["traceEvents"]
                   if e.get("name") == "thread_name"}
        assert {"step", "step_dispatch", "device_wait"} <= threads
        flows = [e for e in chrome["traceEvents"] if e.get("ph") in "sf"
                 and e.get("name") == "rollback"]
        assert len(flows) == 2
        lines = list(obs.jsonl_lines(tl))
        assert len(lines) == len(tl.events)
        assert all("wall" in json.loads(ln) for ln in lines)
        path = str(tmp_path / "t.json")
        obs.write_chrome_trace(tl, path)
        assert json.load(open(path))["traceEvents"]
        with NULL_TIMELINE.phase("anything"):
            pass
        NULL_TIMELINE.begin_step(0)
        NULL_TIMELINE.end_step()
        NULL_TIMELINE.on_rollback(0)
        assert NULL_TIMELINE.counters() == {}
        assert NULL_TIMELINE.snapshot() == {}
        with pytest.raises(AttributeError):
            NULL_TIMELINE.on_skipped(0)
        chrome = obs.chrome_trace(NULL_TIMELINE)
        json.dumps(chrome)
        assert chrome["traceEvents"] == []
        assert list(obs.jsonl_lines(NULL_TIMELINE)) == []

    def test_validator_rejects_broken_chains(self):
        tl = StepTimeline()
        tl.begin_step(0)
        assert any("never ended" in p for p in validate_timeline(tl))
        tl.end_step("completed")
        assert validate_timeline(tl) == []
        tl2 = StepTimeline()
        tl2.begin_step(0)
        tl2.on_rollback(0)
        tl2._pending_rollback = None
        tl2.begin_step(1)
        tl2.end_step("completed")
        assert any("no resume link" in p for p in validate_timeline(tl2))
        tl3 = StepTimeline()
        tl3.begin_step(0)
        tl3.on_rollback(0)
        assert validate_timeline(tl3) == []

    def test_timeline_cap_counts_drops(self):
        tl = StepTimeline(max_events=3)
        for i in range(6):
            tl.begin_step(i)
            tl.end_step()
        assert tl.dropped > 0
        assert any("dropped" in p for p in validate_timeline(tl))

    def test_env_arming(self, monkeypatch):
        monkeypatch.delenv("PADDLE_TPU_TRAIN_TRACE", raising=False)
        assert StepTimeline.from_env() is None
        monkeypatch.setenv("PADDLE_TPU_TRAIN_TRACE", "1")
        assert isinstance(StepTimeline.from_env(), StepTimeline)
        monkeypatch.setenv("PADDLE_TPU_TRAIN_TRACE", "bogus")
        with pytest.raises(ValueError):
            StepTimeline.from_env()

    def test_abandon_undoes_attempt_bookkeeping(self):
        tl = StepTimeline()
        for s in (0, 1):
            tl.begin_step(s)
            tl.end_step()
        tl.begin_step(2)
        with tl.phase("data_fetch"):
            pass
        tl.abandon_step()
        tl.begin_step(2)
        tl.end_step()
        assert validate_timeline(tl) == []
        traces = {sp["trace"] for sp in tl.spans.values()}
        assert "trainer:s2" in traces
        assert not any("#" in t for t in traces), traces
        assert tl._attempts == {}

    def test_abandon_rearms_pending_rollback_link(self):
        tl = StepTimeline()
        tl.begin_step(0)
        tl.on_rollback(0)
        tl.begin_step(1)
        with tl.phase("data_fetch"):
            pass
        tl.abandon_step()
        assert validate_timeline(tl) == []
        tl.begin_step(2)
        tl.end_step("completed")
        assert validate_timeline(tl) == []
        rb = [e for e in tl.events if e["kind"] == "rollback"][0]
        assert tl.spans[rb["resume_span"]]["trace"].endswith("s2")


class TestCompileLedger:
    def test_records_and_catches_shape_churn(self):
        torch.manual_seed(3)
        net = torch.nn.Linear(4, 4)

        @jit.to_static
        def fwd(x):
            return net(x)

        ledger = CompileLedger()
        with ledger:
            fwd(torch.zeros(2, 4))
            assert ledger.compiles == 1
            rec = ledger.records[0]
            assert rec["arg_specs"] == "float32[2,4]"
            assert rec["seconds"] > 0
            assert "test_torch_train_obs.py" in rec["site"]
            assert not rec["steady_state"]
            fwd(torch.zeros(2, 4))
            assert ledger.compiles == 1
            ledger.mark_steady()
            fwd(torch.ones(2, 4))
            assert ledger.steady_state_misses == 0
            fwd(torch.zeros(3, 4))
            assert ledger.steady_state_misses == 1
            anomalies = ledger.anomalies()
            assert len(anomalies) == 1
            assert anomalies[0]["arg_specs"] == "float32[3,4]"
        fwd(torch.zeros(5, 4))
        assert ledger.compiles == 2
        st = ledger.stats()
        assert st["compiles"] == 2 and st["steady_state_misses"] == 1
        fn_keys = [k for k in st["by_function"] if "fwd" in k]
        assert len(fn_keys) == 1
        assert st["by_function"][fn_keys[0]]["count"] == 2
        assert st["total_seconds"] > 0

    def test_capture_completes_the_program_record(self):
        """On the card a program's build spans the eager first call and
        the capture at the second: a capture of a program first called
        before steady state completes its record (no anomaly); one first
        called after it is exactly one anomaly; a capture of a program the
        ledger did not see start is a record of its own."""
        ledger = CompileLedger()
        rec = {"fn": "step", "key": "k", "program": 1, "arg_specs": "",
               "seconds": 0.5, "site": "s", "cache_size": 1}
        ledger._on_compile(dict(rec, event="build"))
        ledger.mark_steady()
        ledger._on_compile(dict(rec, event="capture", seconds=0.25))
        assert (ledger.compiles, ledger.steady_state_misses) == (1, 0)
        assert ledger.records[0]["seconds"] == 0.75
        assert ledger.records[0]["captured"]
        ledger._on_compile(dict(rec, program=2, event="build"))
        ledger._on_compile(dict(rec, program=2, event="capture"))
        assert (ledger.compiles, ledger.steady_state_misses) == (2, 1)
        ledger._on_compile(dict(rec, program=3, event="capture"))
        assert (ledger.compiles, ledger.steady_state_misses) == (3, 2)
        assert ledger.captures == 3

    def test_loop_marks_steady_and_stays_flat(self, tmp_path):
        ledger = CompileLedger()
        loop, sentry, train_step = _run_nan_drill(
            tmp_path, NULL_TIMELINE, compile_ledger=ledger)
        assert sentry.rollbacks == 1
        assert ledger.compiles == 1
        assert ledger.steady_state_misses == 0
        assert ledger.stats()["compiles"] == 1


@pytest.fixture(scope="module")
def tiny_gpt_step():
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

    torch.manual_seed(0)
    cfg = gpt_tiny()
    model = GPTForCausalLM(cfg, device=CPU)
    opt = AdamW(model.parameters(), lr=1e-4)

    @jit.to_static
    def train_step(x, y):
        loss = model.compute_loss(x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    B, S = 2, 32
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, S)))
    y = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, S)))
    train_step(x, y)                     # optimizer state made
    n_params = sum(p.numel() for p in model.parameters())
    return train_step, model, opt, x, y, B * S, n_params, cfg


class TestCostLedger:
    def test_flops_within_tolerance_of_6nd(self, tiny_gpt_step):
        train_step, model, opt, x, y, tokens, n_params, cfg = tiny_gpt_step
        ledger = CostLedger()
        rec = ledger.add("train_step", train_step, x, y,
                         tokens_per_step=tokens, n_params=n_params)
        assert rec["flops"] > 0
        assert 1.0 <= rec["flops_vs_6nd"] <= 4.0
        assert rec["bytes_accessed"] > 0
        assert rec["op_counts"]["dot"] > 0
        assert "all_gather" not in rec["op_counts"]
        assert rec["attention"] == "formula"

    def test_attention_counted_by_formula(self, tiny_gpt_step):
        """K1 forward and K2 + K3 backward of every layer, by the
        ``bound()`` formula: 18·H·D flops per causal (query, key) pair
        a layer; the plain versions' own ops are not counted on top."""
        train_step, model, opt, x, y, tokens, n_params, cfg = tiny_gpt_step
        rec = CostLedger().add("train_step", train_step, x, y)
        H = cfg.num_attention_heads
        D = cfg.hidden_size // H
        q = torch.empty(x.shape[0], x.shape[1], H, D)
        per_layer = sum(attention_cost(k, q, True)[0]
                        for k in ("fwd", "bwd_dkv", "bwd_dq"))
        B, S = x.shape
        assert per_layer == 18 * H * D * B * S * (S + 1) // 2
        L = cfg.num_hidden_layers
        assert rec["attention_flops"] == L * per_layer
        assert rec["attention_calls"] == 3 * L
        assert rec["op_counts"]["flash_attention"] == 3 * L

    def test_analysis_leaves_program_and_state_untouched(self,
                                                         tiny_gpt_step):
        from paddle_tpu_torch.ops import kernels

        train_step, model, opt, x, y, *_ = tiny_gpt_step
        keys = set(train_step.program_cache)
        params = {k: v.clone() for k, v in model.state_dict().items()}
        state = {i: {k: v.clone() for k, v in st.items()}
                 for i, st in opt.state_dict()["state"].items()}
        launches = kernels.launch_counts()
        rec = CostLedger().add("train_step", train_step, x, y)
        assert rec["restored_tensors"] > 0
        assert set(train_step.program_cache) == keys
        assert kernels.launch_counts() == launches
        for k, v in model.state_dict().items():
            assert torch.equal(v, params[k]), k
        for i, st in opt.state_dict()["state"].items():
            for k, v in st.items():
                assert torch.equal(v, state[i][k]), (i, k)
        assert all(p.grad is None for p in model.parameters())

    def test_analytic_roofline_and_fingerprint_stable(self, tiny_gpt_step):
        train_step, model, opt, x, y, *_ = tiny_gpt_step
        ledger = CostLedger(chip="h100")
        r1 = ledger.add("train_step", train_step, x, y)
        r2 = ledger.add("train_step", train_step, x, y)
        assert r1["fingerprint"] == r2["fingerprint"]
        assert r1["flops"] == r2["flops"]
        assert 0.0 < r1["analytic_mfu"] <= 1.0
        assert r1["arithmetic_intensity"] > 0
        assert r1["bound"] in ("compute", "memory")
        name, peak, bw = chip_spec("h100")
        assert (peak, bw) == (989e12, 3.35e12)
        t_c = r1["flops"] / peak
        t_m = r1["bytes_accessed"] / bw
        assert r1["roofline_step_ms"] == pytest.approx(
            max(t_c, t_m) * 1e3, rel=1e-3)
        st = ledger.stats()
        assert st["analytic_mfu"] == r1["analytic_mfu"]
        json.dumps(st)

    def test_fingerprint_discriminates(self, tiny_gpt_step):
        train_step, model, opt, x, y, *_ = tiny_gpt_step
        ledger = CostLedger()
        r1 = ledger.add("a", train_step, x, y)
        r2 = ledger.add("b", train_step, x[:1], y[:1])
        assert r1["fingerprint"] != r2["fingerprint"]

    def test_default_chip_is_h100(self, monkeypatch):
        """The port knows one chip; the JAX package's ``PADDLE_TPU_CHIP``
        (a TPU name) does not reach it."""
        monkeypatch.setenv("PADDLE_TPU_CHIP", "v5e")
        assert chip_spec() == chip_spec("h100")
        assert CostLedger().chip == "h100"

    def test_unknown_chip_rejected(self):
        with pytest.raises(ValueError):
            chip_spec("v99")
        with pytest.raises(ValueError):
            CostLedger(chip="v5e")


class TestZeroCompileKeys:
    def test_observatory_adds_zero_cache_keys(self, tmp_path):
        net, opt, sentry, train_step = _rig(seed=11)
        x = torch.ones(4, 8)
        train_step(x)
        keys = set(train_step.program_cache.keys())
        assert len(keys) == 1
        tl = StepTimeline()
        ledger = CompileLedger().attach()
        try:
            tl.begin_step(0)
            with tl.phase("step_dispatch"):
                train_step(x)
            tl.end_step()
            cost = CostLedger()
            cost.add("step", train_step, x)
            cost.add("step", train_step, x)
        finally:
            ledger.detach()
        assert set(train_step.program_cache.keys()) == keys
        assert ledger.compiles == 0
        assert validate_timeline(tl) == []


class TestStatsAndMetrics:
    def test_train_stats_and_exposition(self, tmp_path):
        tl = StepTimeline()
        ledger = CompileLedger()
        cost = CostLedger()
        loop, sentry, train_step = _run_nan_drill(
            tmp_path, tl, compile_ledger=ledger, cost_ledger=cost)
        cost.add("train_step", train_step, torch.ones(4, 8))
        snap = loop.train_stats()
        assert snap["timeline"]["steps_completed"] == 8
        assert snap["compiles"]["compiles"] == 1
        assert snap["sentry"]["rollbacks"] == 1
        assert snap["cost"]["analytic_mfu"] > 0
        stats = profiler.train_stats()
        assert any(s.get("sentry", {}).get("rollbacks") == 1
                   for s in stats.values())
        text = obs.render_all_metrics()
        assert "paddle_tpu_train_timeline_steps_completed" in text
        assert "paddle_tpu_train_compiles_compiles" in text
        assert "paddle_tpu_train_sentry_rollbacks" in text
        assert "paddle_tpu_train_cost_analytic_mfu" in text
        assert "paddle_tpu_train_cost_fingerprint_info" in text
        assert 'chip_info{' in text

    def test_serving_registry(self):
        """Engines and fleets join the registry at construction, weakly:
        their stats, health and paging by name, gone with the object."""
        import gc

        from paddle_tpu_torch import create_engine
        from paddle_tpu_torch.serving import Fleet

        eng = create_engine("gpt:tiny", device=CPU, kv_layout="paged",
                            block_size=8, min_bucket=8, max_seq=32,
                            num_slots=2, name="reg-engine")
        fl = Fleet("gpt:tiny", num_replicas=1, device=CPU, max_seq=32,
                   min_bucket=16, num_slots=2, name="reg-fleet")
        assert profiler.serving_stats()["reg-engine"]["name"] \
            == "reg-engine"
        assert profiler.serving_health()["reg-engine"]["state"] == "active"
        assert "reg-engine" in profiler.serving_paging()
        assert "reg-fleet" in profiler.serving_fleet()
        assert "reg-engine" in profiler.flight_record()
        text = obs.render_all_metrics()
        assert 'paddle_tpu_serving_queue_depth{engine="reg-engine"}' in text
        assert 'fleet="reg-fleet"' in text
        del eng, fl
        gc.collect()
        assert "reg-engine" not in profiler.serving_stats()
        assert "reg-fleet" not in profiler.serving_fleet()
