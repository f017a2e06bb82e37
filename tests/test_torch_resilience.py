"""The port's fault injection, step watchdog, sync sanitizer and the prefix
cache's degraded mode, against the JAX package's, on the CPU.

One ``gpt_tiny`` is built in the JAX package from a seed and its weights
converted into the port.  Each scenario of the parity spec runs on both
engines with the same arguments and the same fault plan (the JAX
package's ``ServingFaultPlan`` on its engine, the port's copy on the
port's), and what a caller sees must be identical: terminal states,
errors, greedy streams (also held to the port model's no-cache greedy
chain), failure counters, free slots, and the plan's call counts.  The
plans themselves, the watchdogs and the sanitizers' arming are compared
directly.  Greedy streams are compared exactly (argmaxes of f32 logits
that agree to ~1e-6).

The engines: the contiguous one of ``TestResilience`` (2 slots,
``max_seq`` 16, one bucket of 16) and the paged one of
``TestPagedEngine`` (2 slots, buckets 8 and 16, block 8).
"""
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as jax_serving
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.fault_tolerance import injection as jax_injection
from paddle_tpu.distributed.fault_tolerance import watchdog as jax_watchdog
from paddle_tpu.distributed.fleet.elastic.manager import (
    ELASTIC_EXIT_CODE as JAX_ELASTIC_EXIT_CODE,
)
from paddle_tpu.models import gpt as jax_gpt
import paddle_tpu_torch.serving as port_serving
from paddle_tpu_torch.distributed.fault_tolerance import (
    injection as port_injection, watchdog as port_watchdog,
)
from paddle_tpu_torch.models import (
    GPTForCausalLM, from_jax_state_dict, gpt_tiny,
)
from paddle_tpu_torch.obs import render_metrics
from paddle_tpu_torch.serving.sanitize import SyncSanitizer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = SimpleNamespace(name="jax", Engine=jax_serving.Engine,
                      EngineStopped=jax_serving.EngineStopped,
                      SpecConfig=jax_serving.SpecConfig,
                      SyncSanitizer=jax_serving.SyncSanitizer,
                      Plan=jax_injection.ServingFaultPlan,
                      InjectedFault=jax_injection.InjectedFault,
                      Watchdog=jax_watchdog.StepWatchdog)
PORT = SimpleNamespace(name="port", Engine=port_serving.Engine,
                       EngineStopped=port_serving.EngineStopped,
                       SpecConfig=port_serving.SpecConfig,
                       SyncSanitizer=port_serving.SyncSanitizer,
                       Plan=port_injection.ServingFaultPlan,
                       InjectedFault=port_injection.InjectedFault,
                       Watchdog=port_watchdog.StepWatchdog)
APIS = (JAX, PORT)

CONTIG_KW = dict(num_slots=2, max_seq=16, min_bucket=16)
PAGED_KW = dict(num_slots=2, max_seq=16, min_bucket=8, kv_layout="paged",
                block_size=8)
LAYOUT_KW = {"contiguous": CONTIG_KW, "paged": PAGED_KW}

#: every fault point either engine checks
POINTS = ("serving.prefill", "serving.decode", "serving.stream_cb",
          "serving.prefix_lookup", "serving.spec_draft",
          "serving.spec_verify", "serving.spec_draft_prefill")


@pytest.fixture(scope="module", autouse=True)
def _single_device():
    """The JAX side runs unsharded.  An earlier test file in the same
    worker may leave fleet's hybrid mesh set (model axis > 1)."""
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


@pytest.fixture(scope="module")
def models():
    """The JAX ``gpt_tiny`` and the port's, on the same weights."""
    paddle.seed(0)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny())
    jm.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(GPTForCausalLM(gpt_tiny(), device="cpu"), sd)
    return {"jax": jm, "port": tm.eval()}


def _both(scenario, models, *args):
    """``scenario(api, model, *args)`` on both packages."""
    return {api.name: scenario(api, models[api.name], *args)
            for api in APIS}


def _outcome(reqs):
    return [(r.state, r.output_ids,
             r.error.split(":")[0] if r.error else None) for r in reqs]


def _failures(eng) -> dict:
    f = eng.stats()["failures"]
    return {**{k: f[k] for k in ("failed", "cancelled", "callback_errors",
                                 "step_failures", "step_retries")},
            **{f"retries.{k}": v for k, v in f["retries_by_point"].items()}}


def _delta(eng, before: dict) -> dict:
    after = _failures(eng)
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] - before.get(k, 0)}


def _assert_greedy_chain(tm, prompt, out_ids):
    """``out_ids`` must be the no-cache greedy generation of ``prompt`` by
    the port's model."""
    L = len(prompt)
    full = list(prompt) + [int(t) for t in out_ids]
    with torch.no_grad():
        logits = tm(torch.tensor(full[:-1])[None]).numpy()[0]
    for i, t in enumerate(out_ids):
        assert int(np.argmax(logits[L - 1 + i])) == int(t), (i, t)


# -- the fault plans -----------------------------------------------------------

def _plan_env_parsing(api):
    env = {"PADDLE_TPU_FT_SERVING_FAULTS":
           "serving.prefill@1x2, serving.decode@3:stall=0.01"}
    plan = api.Plan.from_env(env)
    seen = [plan.armed]
    for _ in range(3):
        try:
            plan.check("serving.prefill")
            seen.append("ok")
        except api.InjectedFault as e:
            seen.append(str(e))
    plan.check("serving.decode")
    plan.check("serving.decode")
    t0 = time.perf_counter()
    plan.check("serving.decode")                 # stalls, not raises
    seen.append(time.perf_counter() - t0 >= 0.01)
    seen += [plan.calls("serving.decode"), plan.calls("serving.prefill"),
             plan.calls("serving.stream_cb"), api.Plan.from_env({}).armed]
    for bad in ("serving.decode", "serving.nope@1", "serving.decode@1:die=1",
                "serving.decode@0"):
        with pytest.raises(ValueError) as ei:
            api.Plan.from_env({"PADDLE_TPU_FT_SERVING_FAULTS": bad})
        seen.append(str(ei.value))
    return seen


def test_fault_plan_env_parsing():
    """The same spec string: the same firing window, stall, call counts
    and errors (texts included) in both packages."""
    got = {api.name: _plan_env_parsing(api) for api in APIS}
    assert got["port"] == got["jax"]
    assert got["port"][:6] == [True, "injected fault: serving.prefill "
                               "call #1", "injected fault: serving.prefill "
                               "call #2", "ok", True, 3]


def _plan_scoped(api):
    plan = api.Plan().add("serving.r1.decode", at_call=2, times=2) \
        .add("serving.decode", at_call=5)
    views = [plan.scoped(0), plan.scoped(1)]
    fired = []
    for i in range(6):
        for k, v in enumerate(views):
            try:
                v.check("serving.decode")
            except api.InjectedFault as e:
                fired.append((i, k, str(e)))
    return (fired, plan.calls("serving.decode"),
            [v.calls("serving.decode") for v in views],
            views[1].calls("serving.r0.decode"), views[0].armed)


def test_fault_plan_scoped_views():
    """A replica-scoped rule fires on that replica's own calls; both
    counters advance per check; an unscoped rule keys on the global
    count."""
    got = {api.name: _plan_scoped(api) for api in APIS}
    assert got["port"] == got["jax"]
    fired = got["port"][0]
    assert [(i, k) for i, k, _ in fired] == [(1, 1), (2, 0), (2, 1)]


def test_fault_points_and_exit_code_match_jax():
    assert port_injection.SERVING_FAULT_POINTS == \
        jax_injection.SERVING_FAULT_POINTS
    assert port_injection.ENV_SERVING_FAULTS == \
        jax_injection.ENV_SERVING_FAULTS
    assert port_watchdog.ELASTIC_EXIT_CODE == JAX_ELASTIC_EXIT_CODE == 101


# -- the TestResilience scenarios ----------------------------------------------

def _prefill_fault(api, model, layout):
    eng = api.Engine(model, **LAYOUT_KW[layout])
    eng.warmup()
    before = _failures(eng)
    eng.fault_plan = api.Plan().add("serving.prefill", at_call=1, times=2)
    p = np.random.RandomState(12).randint(0, 128, (4,)).tolist()
    r = eng.add_request(p, max_new_tokens=3)
    eng.run()
    free = sorted(eng.free_slots)
    r2 = eng.add_request(p, max_new_tokens=3)
    eng.run()
    return (_outcome([r, r2]), "injected fault" in r.error, free,
            _delta(eng, before), eng.fault_plan.calls("serving.prefill"), p)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefill_fault_slot_leak_regression(models, layout):
    """Two injected prefill failures defeat the one retry: the request
    fails, its slot comes back, and the same prompt is served next."""
    res = _both(_prefill_fault, models, layout)
    assert res["port"][:5] == res["jax"][:5]
    outcome, injected, free, delta, calls, p = res["port"]
    assert outcome[0][0] == "failed" and injected
    assert outcome[0][2] == "prefill failed after 1 retry"
    assert free == [0, 1] and calls == 3
    assert outcome[1][0] == "finished"
    _assert_greedy_chain(models["port"], p, outcome[1][1])
    assert delta == {"failed": 1, "step_failures": 2, "step_retries": 1,
                     "retries.serving.prefill": 1}


def _chaos(api, model, layout, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FT_SERVING_FAULTS",
                       "serving.decode@2,serving.stream_cb@3")
    eng = api.Engine(model, **LAYOUT_KW[layout])
    monkeypatch.delenv("PADDLE_TPU_FT_SERVING_FAULTS")
    armed = eng.fault_plan.armed                 # read from the env
    eng.warmup()
    warm = eng.metrics.compile_misses
    rs = np.random.RandomState(13)
    prompts = [rs.randint(0, 128, (L,)).tolist() for L in (3, 6, 4)]
    streamed = []
    reqs = [eng.add_request(p, max_new_tokens=4,
                            stream_cb=lambda t, r: streamed.append(
                                (r.request_id, t)))
            for p in prompts]
    eng.run()
    st = eng.stats()
    json.dumps(st)
    got = [[t for rid, t in streamed if rid == r.request_id] for r in reqs]
    return (armed, _outcome(reqs), got, sorted(eng.free_slots),
            st["failures"]["retries_by_point"], _failures(eng),
            eng.metrics.compile_misses - warm, st["health"]["state"],
            prompts)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_chaos_decode_retry_and_cb_fault(models, layout, monkeypatch):
    """Armed from ``PADDLE_TPU_FT_SERVING_FAULTS`` at construction: decode
    call #2 fails once (the retry absorbs it) and callback call #3
    raises (its request alone fails); the healthy streams are the
    unfaulted greedy ones, no slot leaks, no program is built after
    warmup."""
    res = _both(_chaos, models, layout, monkeypatch)
    assert res["port"][:8] == res["jax"][:8]
    (armed, outcome, got, free, by_point, fl, misses, state,
     prompts) = res["port"]
    assert armed and free == [0, 1] and misses == 0 and state == "active"
    assert outcome[0][0] == "failed" and outcome[0][2] == "stream_cb raised"
    for i in (1, 2):
        assert outcome[i][0] == "finished" and len(outcome[i][1]) == 4
        _assert_greedy_chain(models["port"], prompts[i], outcome[i][1])
        assert got[i] == outcome[i][1]
    assert by_point == {"serving.decode": 1}
    assert fl == {"failed": 1, "cancelled": 0, "callback_errors": 1,
                  "step_failures": 1, "step_retries": 1,
                  "retries.serving.decode": 1}


def _decode_exhausted(api, model, layout):
    eng = api.Engine(model, **LAYOUT_KW[layout])
    eng.warmup()
    eng.fault_plan = api.Plan().add("serving.decode", at_call=1, times=2)
    rs = np.random.RandomState(14)
    ps = [rs.randint(0, 128, (L,)).tolist() for L in (3, 5, 4)]
    reqs = [eng.add_request(p, max_new_tokens=3) for p in ps]
    eng.run()
    return (_outcome(reqs), _failures(eng), sorted(eng.free_slots),
            eng.health()["state"], ps)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_retry_exhausted_fails_batch_not_engine(models, layout):
    res = _both(_decode_exhausted, models, layout)
    assert res["port"][:4] == res["jax"][:4]
    outcome, fl, free, state, ps = res["port"]
    for s, _, err in outcome[:2]:
        assert s == "failed" and err == "decode step failed after 1 retry"
    assert outcome[2][0] == "finished" and state == "active"
    _assert_greedy_chain(models["port"], ps[2], outcome[2][1])
    assert fl["failed"] == 2 and fl["step_failures"] == 2
    assert free == [0, 1]


def _watchdog(api, model, layout):
    eng = api.Engine(model, **{**LAYOUT_KW[layout], "num_slots": 1},
                     step_timeout_s=0.1,
                     fault_plan=api.Plan().add("serving.decode", at_call=1,
                                               stall_s=0.6))
    armed = eng.health()["watchdog_armed"]       # configured, not started
    r = eng.add_request([1, 2], max_new_tokens=4)
    with pytest.raises(api.EngineStopped, match="unhealthy"):
        eng.run()
    health = eng.health()
    fired = eng._watchdog.fired
    with pytest.raises(api.EngineStopped):
        eng.add_request([3, 4])
    eng.shutdown(timeout_s=0.0)
    return (armed, eng.state, health["reason"], health["watchdog_armed"],
            fired, (r.state, r.error), sorted(eng.free_slots), eng.state,
            eng._watchdog is None, eng.flight.dumps[-1]["reason"])


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_watchdog_marks_engine_unhealthy(models, layout):
    """No warmup, a 0.1 s deadline and decode call #1 stalled 0.6 s: the
    watchdog fires (the first build is not counted against it), the
    engine turns sticky unhealthy with a flight dump, health stops
    claiming protection, and shutdown reclaims the request and joins the
    thread."""
    res = _both(_watchdog, models, layout)
    assert res["port"] == res["jax"]
    (armed, state, reason, still_armed, fired, req, free, after, joined,
     dump) = res["port"]
    assert armed and state == "unhealthy" and fired
    assert "watchdog" in reason and dump == reason
    assert still_armed is False
    assert req == ("cancelled", "engine shutdown")
    assert free == [0] and after == "unhealthy" and joined


def _watchdog_phases(api):
    """A watchdog's deadline: ``startup_factor`` times the timeout until
    two boundaries, the timeout after, nothing while paused."""
    out = []
    wd = api.Watchdog(0.05, hard_exit=False, startup_factor=20.0)
    wd.start()
    wd.notify(1)                              # one boundary: 1.0 s
    time.sleep(0.3)
    out.append(wd.fired)
    wd.notify(2)                              # warmed: 0.05 s
    wd.pause()
    time.sleep(0.3)
    out.append(wd.fired)
    wd.notify(3)
    time.sleep(0.3)
    out += [wd.fired, wd.alive]
    wd.stop()
    return out


def test_watchdog_startup_factor_and_pause():
    got = {api.name: _watchdog_phases(api) for api in APIS}
    assert got["port"] == got["jax"] == [False, False, True, False]


_CHILD_WATCHDOG = r"""
import sys, time
from paddle_tpu_torch.distributed.fault_tolerance.watchdog import StepWatchdog
from paddle_tpu_torch.obs.flight import FlightRecorder

bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
rec = FlightRecorder(8, name="wd-crash")
rec.record(step=1, running=1)
wd = StepWatchdog(0.2, hard_exit=True, startup_factor=1.0)
wd.start()
wd.notify(0)
wd.notify(1)                      # two boundaries: warmed deadline
time.sleep(30)                    # wedged: the watchdog must os._exit
raise SystemExit("unreachable")
"""


def test_hard_exit_persists_artifacts(tmp_path):
    """A child that imports the port alone: the hard exit leaves rc 101
    and one crash file holding the flight ring."""
    env = dict(os.environ, PADDLE_TPU_TRACE_DIR=str(tmp_path),
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _CHILD_WATCHDOG], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 101, (r.returncode, r.stderr[-2000:])
    crash = [f for f in os.listdir(tmp_path) if f.startswith("crash-")]
    assert len(crash) == 1, (os.listdir(tmp_path), r.stderr[-2000:])
    payload = json.load(open(tmp_path / crash[0]))
    assert payload["reason"].startswith("watchdog:")
    assert payload["flight_rings"]["wd-crash"][-1]["events"]
    assert "crash artifacts persisted" in r.stderr
    assert "last dispatched program: None" in r.stderr


# -- the prefix cache's degraded mode ------------------------------------------

def _lookup_chaos(api, model):
    eng = api.Engine(model, **PAGED_KW)
    eng.warmup()
    blocks_before = eng.cache.allocator.stats()
    prompt = np.random.RandomState(3).randint(0, 128, (11,)).tolist()
    eng.fault_plan = api.Plan().add("serving.prefix_lookup", at_call=1)
    r1 = eng.add_request(prompt, max_new_tokens=2)
    eng.run()
    errors = [eng.metrics.prefix_lookup_errors]
    eng.fault_plan = api.Plan().add("serving.prefix_lookup", at_call=1,
                                    stall_s=0.05)
    eng.prefix_lookup_timeout_s = 0.01
    t0 = time.perf_counter()
    r2 = eng.add_request(prompt, max_new_tokens=2)
    eng.run()
    stalled = time.perf_counter() - t0 >= 0.05
    eng.prefix_lookup_timeout_s = 0.25
    errors.append(eng.metrics.prefix_lookup_errors)
    st = eng.stats()
    after = eng.cache.allocator.stats()
    return (_outcome([r1, r2]), errors, stalled, st["health"]["state"],
            st["health"]["kv_block_invariants"], after["used"],
            after["free"] + after["cached"] - blocks_before["free"]
            - blocks_before["cached"], sorted(eng.free_slots),
            st["paging"]["prefix_lookup_errors"],
            st["paging"]["prefix"]["hit_tokens"], prompt)


def test_prefix_lookup_chaos_degrades_to_miss(models):
    """A raising lookup and one stalled past its budget both serve as
    plain misses: the requests complete with the same greedy stream, the
    engine stays healthy, no block leaks."""
    res = _both(_lookup_chaos, models)
    assert res["port"][:-2] == res["jax"][:-2]
    (outcome, errors, stalled, state, inv, used, leaked, free, shown, hits,
     prompt) = res["port"]
    assert [o[0] for o in outcome] == ["finished", "finished"]
    assert outcome[0][1] == outcome[1][1]
    _assert_greedy_chain(models["port"], prompt, outcome[0][1])
    assert errors == [1, 2] and shown == 2 and stalled
    assert state == "active" and inv == "ok" and used == 0 and leaked == 0
    assert free == [0, 1] and hits == 0          # both were misses


class _Boom(Exception):
    pass


def _register_raises(api, model, where):
    kw = dict(PAGED_KW, num_slots=1) if where == "preempt" else PAGED_KW
    eng = api.Engine(model, **kw)
    eng.warmup()
    real = eng.prefix_cache.register

    def boom(*a, **k):
        raise _Boom("register raised")

    rs = np.random.RandomState(4)
    if where == "admission":
        eng.prefix_cache.register = boom
        reqs = [eng.add_request(rs.randint(0, 128, (11,)).tolist(),
                                max_new_tokens=3)]
        eng.run()
    else:
        lo = eng.add_request(rs.randint(0, 128, (11,)).tolist(),
                             max_new_tokens=6, priority="low")
        eng.step()
        eng.step()
        hi = eng.add_request(rs.randint(0, 128, (5,)).tolist(),
                             max_new_tokens=2, priority="high")
        # the step that preempts lo and admits hi: two registrations
        eng.prefix_cache.register = boom
        eng.step()
        eng.prefix_cache.register = real
        eng.run()
        reqs = [lo, hi]
    st = eng.stats()
    return ([(r.state, r.output_ids, r.preemptions) for r in reqs],
            st["paging"]["prefix_register_errors"],
            st["health"]["kv_block_invariants"], sorted(eng.free_slots))


@pytest.mark.parametrize("where", ["admission", "preempt"])
def test_raising_register_is_counted_and_request_goes_on(models, where):
    """A prefix-cache registration that raises, after an admission's
    prefill or at a preemption, is counted and the requests finish."""
    res = _both(_register_raises, models, where)
    assert res["port"] == res["jax"]
    reqs, errors, inv, _ = res["port"]
    assert all(s == "finished" for s, _, _ in reqs)
    assert inv == "ok"
    assert errors == (1 if where == "admission" else 2)
    if where == "preempt":
        assert reqs[0][2] == 1                   # lo was preempted once


# -- the plans' call counts under the same workload ------------------------------

def _point_calls(api, model, layout, spec):
    kw = dict(LAYOUT_KW[layout], max_seq=32)
    if spec:
        kw["speculation"] = api.SpecConfig(draft_model=model, k=3)
    eng = api.Engine(model, **kw,
                     fault_plan=api.Plan().add("serving.decode",
                                               at_call=10 ** 6))
    eng.warmup()
    rs = np.random.RandomState(15)
    prompts = [rs.randint(0, 128, (L,)).tolist() for L in (5, 12, 9)]
    reqs = [eng.add_request(p, max_new_tokens=6,
                            stream_cb=lambda t, r: None) for p in prompts]
    eng.run()
    return ([r.output_ids for r in reqs],
            {p: eng.fault_plan.calls(p) for p in POINTS})


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_plan_calls_agree_per_point(models, layout, spec):
    """The same greedy workload checks every fault point the same number
    of times in both engines (a speculating round checks
    ``serving.spec_draft`` k times and ``serving.spec_verify`` once)."""
    res = _both(_point_calls, models, layout, spec)
    assert res["port"] == res["jax"]
    outs, calls = res["port"]
    assert calls["serving.stream_cb"] == 18
    assert calls["serving.prefill"] == 3
    if spec:
        assert calls["serving.decode"] == 0
        assert calls["serving.spec_draft"] == 3 * calls["serving.spec_verify"]
        assert calls["serving.spec_draft_prefill"] == 3
    else:
        assert calls["serving.spec_verify"] == 0
    assert calls["serving.prefix_lookup"] == (3 if layout == "paged" else 0)


# -- the sync sanitizer ----------------------------------------------------------

def _sanitized(api, model, layout, spec):
    kw = dict(LAYOUT_KW[layout], max_seq=32)
    if spec:
        kw["speculation"] = api.SpecConfig(draft_model=model, k=3)
    eng = api.Engine(model, **kw)
    eng.sanitizer = api.SyncSanitizer()
    outs = eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=4)
    rep = eng.stats()["sanitizer"]
    return outs, rep


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_counts_zero_transfers_per_decode_step(models, layout, spec):
    """The decode dispatch (a speculative round too) performs no host
    coercion: 0.0 per decode step in both packages, over the same
    counted steps."""
    res = _both(_sanitized, models, layout, spec)
    assert res["port"] == res["jax"]
    rep = res["port"][1]
    assert rep["decode_steps"] >= (1 if spec else 3)
    assert rep["per_decode_step"] == 0.0, rep
    assert rep["host_transfers"] == 0 and rep["by_site"] == {}, rep


def test_unarmed_engine_reports_no_sanitizer(models, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_SANITIZE", raising=False)
    for api in APIS:
        eng = api.Engine(models[api.name], **CONTIG_KW)
        assert eng.sanitizer is None
        assert "sanitizer" not in eng.stats()


@pytest.mark.parametrize("value", ["1", "strict"])
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_env_arms_every_engine(models, monkeypatch, value, spec):
    """``PADDLE_TPU_SANITIZE`` arms a plain and a speculating engine at
    construction in both packages; the report is the same."""
    monkeypatch.setenv("PADDLE_TPU_SANITIZE", value)
    reps = {}
    for api in APIS:
        kw = dict(CONTIG_KW, max_seq=32)
        if spec:
            kw["speculation"] = api.SpecConfig(
                draft_model=models[api.name], k=3)
        eng = api.Engine(models[api.name], **kw)
        assert eng.sanitizer is not None
        eng.generate([[1, 2, 3]], max_new_tokens=4)
        reps[api.name] = eng.stats()["sanitizer"]
    assert reps["port"] == reps["jax"]
    assert reps["port"]["strict"] == (value == "strict")
    assert reps["port"]["decode_steps"] > 0


def test_window_is_reentrancy_safe():
    san = SyncSanitizer()
    t = torch.tensor(2)
    with san.decode_window():
        with san.decode_window():
            t.item()
        t.item()                     # the inner exit left the outer window
    t.item()                         # uninstalled on exit
    assert san.host_transfers == 2
    assert san.decode_steps == 0     # note_step counts steps, not windows


def test_dunder_coercions_reach_the_mode():
    """Each coercion counts once (``to`` only with a CPU target), and the
    python operators that call the dunders reach the counting mode."""
    import operator

    san = SyncSanitizer()
    t, s = torch.ones(2, 2), torch.tensor(3)
    calls = {
        "item": lambda: s.item(), "tolist": lambda: t.tolist(),
        "numpy": lambda: t.numpy(), "cpu": lambda: t.cpu(),
        "to_cpu": lambda: t.to("cpu"), "to_device": lambda: t.to(
            device=torch.device("cpu")),
        "to_like": lambda: t.to(torch.zeros(1)),
        "bool": lambda: bool(t.sum() > 0), "int": lambda: int(s),
        "float": lambda: float(s), "index": lambda: operator.index(s),
        "list_index": lambda: [0, 1, 2, 3][s],
        "array": lambda: np.asarray(t)}
    counted = {}
    for name, fn in calls.items():
        n = san.host_transfers
        with san.decode_window():
            fn()
        counted[name] = san.host_transfers - n
    with san.decode_window():
        t.to(torch.float64)          # a dtype cast is not a coercion
        t + 1
    assert counted == {name: 1 for name in calls}
    assert san.host_transfers == len(calls)


def test_attribution_skips_torch_plumbing():
    san = SyncSanitizer()
    t = torch.ones(2, 2)
    with san.decode_window():
        t.numpy()
        t.tolist()
        bool(t.sum() > 0)
        np.asarray(t)
    assert san.host_transfers == 4
    for site in san.by_site:
        assert site.startswith(os.path.join("tests",
                                            "test_torch_resilience.py:")), \
            san.by_site
    torch_dir = os.path.dirname(torch.__file__)
    assert not any(torch_dir in s or "sanitize.py" in s
                   for s in san.by_site)


def test_from_env(monkeypatch):
    """Every value reads the same in both packages."""
    for v in (None, "0", "1", "strict", "off", "yes", "bogus"):
        got = []
        for cls in (JAX.SyncSanitizer, PORT.SyncSanitizer):
            if v is None:
                monkeypatch.delenv("PADDLE_TPU_SANITIZE", raising=False)
            else:
                monkeypatch.setenv("PADDLE_TPU_SANITIZE", v)
            try:
                san = cls.from_env()
                got.append(None if san is None else san.strict)
            except ValueError as e:
                got.append(str(e))
        assert got[0] == got[1], (v, got)
    assert "PADDLE_TPU_SANITIZE" in got[1]


def test_guard_is_null_on_the_cpu_and_matches_the_debug_message():
    san = SyncSanitizer(strict=True)
    with san.compiled_guard(torch.device("cpu")):
        torch.ones(2).sum().item()   # no sync debug mode off the card
    san.count_violation(RuntimeError("injected fault: serving.decode #1"))
    assert san.guard_violations == 0
    san.count_violation(RuntimeError(
        "called a synchronizing CUDA operation"))
    assert san.guard_violations == 1


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_sync_inside_the_window_is_seen(models, spec):
    """The negative control: a program call that reads its output on the
    host inside the dispatch is counted, once per call, at this file's
    line."""
    kw = dict(PAGED_KW, max_seq=32)
    if spec:
        kw["speculation"] = PORT.SpecConfig(draft_model=models["port"], k=3)
    eng = PORT.Engine(models["port"], **kw)
    eng.warmup()
    eng.sanitizer = SyncSanitizer()
    run = eng.programs.run
    kind = "verify" if spec else "decode"

    def reads(key, body, *inputs):
        out = run(key, body, *inputs)
        if key[0] == kind:
            out.sum().item()
        return out

    eng.programs.run = reads
    eng.generate([[1, 2, 3]], max_new_tokens=4)
    del eng.programs.run
    rep = eng.stats()["sanitizer"]
    assert rep["host_transfers"] == rep["decode_steps"] > 0
    (site,) = rep["by_site"]
    assert site.startswith(os.path.join("tests", "test_torch_resilience.py"))


def test_degraded_counters_are_rendered(models):
    eng = PORT.Engine(models["port"], **PAGED_KW)
    eng.metrics.on_prefix_lookup_error()
    eng.metrics.on_prefix_register_error()
    text = render_metrics(eng.stats())
    assert f'paddle_tpu_serving_paging_prefix_lookup_errors{{engine="' \
           f'{eng.name}"}} 1' in text
    assert "paddle_tpu_serving_paging_prefix_register_errors" in text
    assert "paddle_tpu_serving_health_watchdog_armed" in text
