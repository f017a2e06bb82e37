"""The port's request tracer, flight recorder and exporters, against the
JAX package's.

One traced paged engine per package (1 slot, so a high arrival must
preempt; aging off) serves the same preempt-and-resume scenario on the
same weights: the two tracers' event chains must agree in kinds, buckets
and ``prefix_hit``, and the resume must show as a prefix hit on the
tail bucket.  The exporters (Perfetto trace JSON, JSONL, metrics text)
run over the port's traced engine, in place of the JAX tests' fleet run.
"""
import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu.serving as jax_serving
from paddle_tpu_torch import obs
from paddle_tpu_torch.models import (
    GPTForCausalLM, from_jax_state_dict, gpt_tiny,
)
from paddle_tpu_torch.serving import (
    NULL_TRACER, Engine, FlightRecorder, QueueFull, RequestTracer,
    ServingMetrics, validate_trace,
)

torch.set_num_threads(2)

TRACED_KW = dict(num_slots=1, max_seq=32, min_bucket=8, kv_layout="paged",
                 block_size=8, priority_aging_s=None)


@pytest.fixture(scope="module")
def models(serving_model):
    """The JAX tests' ``gpt_tiny`` and the port's on its weights."""
    sd = {k: np.asarray(v.numpy())
          for k, v in serving_model.state_dict().items()}
    tm = from_jax_state_dict(GPTForCausalLM(gpt_tiny(), device="cpu"), sd)
    return {"jax": serving_model, "port": tm.eval()}


def _preempt_resume(engine_cls, model):
    """A low request admitted alone, then preempted by a high one; both
    run to the end.  Returns the engine, its tracer and the requests."""
    tr = RequestTracer() if engine_cls is Engine else \
        jax_serving.RequestTracer()
    eng = engine_cls(model, tracer=tr, **TRACED_KW)
    eng.warmup()
    warm = eng.metrics.compile_misses
    lo = eng.add_request(list(range(1, 10)), max_new_tokens=6,
                         priority="low")
    eng.step()                                   # lo admitted (bucket 16)
    hi = eng.add_request([4, 5, 6], max_new_tokens=4, priority="high")
    eng.run()
    return {"eng": eng, "tr": tr, "lo": lo, "hi": hi,
            "new_programs": eng.metrics.compile_misses - warm}


@pytest.fixture(scope="module")
def chains(models):
    return {"jax": _preempt_resume(jax_serving.Engine, models["jax"]),
            "port": _preempt_resume(Engine, models["port"])}


def _chain(run, req):
    """The trace of ``req``: each event's kind with its bucket and
    prefix hit where it has them, and its span's name."""
    tr, eng = run["tr"], run["eng"]
    trace = f"{eng.name}:r{req.request_id}"
    return [(ev["kind"], ev.get("bucket"), ev.get("prefix_hit"),
             tr.spans[ev["span"]]["name"])
            for ev in tr.events if ev.get("trace") == trace]


class TestPreemptResumeSpans:
    def test_chain_matches_the_jax_tracer(self, chains):
        j, t = chains["jax"], chains["port"]
        for who in ("lo", "hi"):
            assert _chain(t, t[who]) == _chain(j, j[who])
            assert t[who].output_ids == j[who].output_ids
        assert [ev["kind"] for ev in t["tr"].events] == \
            [ev["kind"] for ev in j["tr"].events]

    def test_preempt_links_resume_span_and_cheap_resume(self, chains):
        run = chains["port"]
        eng, tr, lo, hi = run["eng"], run["tr"], run["lo"], run["hi"]
        assert lo.finished and hi.finished and lo.preempted
        assert run["new_programs"] == 0
        trace = f"{eng.name}:r{lo.request_id}"
        pre = [ev for ev in tr.events if ev["kind"] == "preempt"
               and ev["trace"] == trace]
        assert len(pre) == 1
        resume = tr.spans[pre[0]["resume_span"]]
        assert resume["parent"] == pre[0]["span"]
        assert resume["name"] == "resume"
        assert tr.spans[pre[0]["span"]]["state"] == "preempted"
        assert resume["state"] == "finished"
        # the victim's prompt blocks were registered before its slot was
        # released: the resume hits them and prefills the tail bucket
        admits = [ev for ev in tr.events if ev["kind"] == "admitted"
                  and ev["trace"] == trace]
        assert admits[0]["prefix_hit"] == 0 and admits[0]["bucket"] == 16
        assert admits[-1]["span"] == resume["id"]
        assert admits[-1]["prefix_hit"] == 8 and admits[-1]["bucket"] == 8
        assert validate_trace(tr) == []

    def test_decode_steps_are_batched_per_engine_step(self, chains):
        tr = chains["port"]["tr"]
        steps = [ev for ev in tr.events if ev["kind"] == "decode_step"]
        assert steps
        assert all(ev["n_active"] == len(ev["slots"]) >= 1 for ev in steps)
        ts = [ev["ts"] for ev in tr.events]
        assert ts == sorted(ts)
        assert all("wall" not in ev for ev in tr.events)

    def test_shed_trace_terminates_exactly_once(self, models):
        tr = RequestTracer()
        eng = Engine(models["port"], tracer=tr, **TRACED_KW)
        eng.warmup()
        runner = eng.add_request(list(range(10, 19)), max_new_tokens=24)
        eng.step()                               # occupy the only slot
        queued = [eng.add_request(list(range(20, 29)), max_new_tokens=24)
                  for _ in range(2)]
        eng.metrics.itl_s.extend([0.05] * 50)
        with pytest.raises(QueueFull) as ei:
            eng.add_request([1, 2, 3], max_new_tokens=4, deadline_s=0.01)
        shed_req = ei.value.request
        eng.run()
        assert runner.finished and all(q.finished for q in queued)
        trace = f"{eng.name}:r{shed_req.request_id}"
        evs = [ev for ev in tr.events if ev.get("trace") == trace]
        assert [ev["kind"] for ev in evs] == ["shed", "retired"]
        assert evs[0]["estimated_wait_s"] > 0.01
        assert evs[1]["final"] and evs[1]["state"] == "rejected"
        assert validate_trace(tr) == []

    def test_block_pressure_events_on_defer(self, models):
        """A pool too small for two prompts at once: the second admission
        defers, and both tracers record the same pressure."""
        kinds = {}
        for name, cls in (("jax", jax_serving.Engine), ("port", Engine)):
            tr = RequestTracer() if cls is Engine else \
                jax_serving.RequestTracer()
            eng = cls(models[name], num_slots=2, max_seq=16, min_bucket=16,
                      kv_layout="paged", block_size=8, num_kv_blocks=3,
                      max_preemptions=0, tracer=tr)
            r1 = eng.add_request([1, 2, 3], max_new_tokens=2)
            r2 = eng.add_request([4, 5, 6], max_new_tokens=2)
            eng.step()
            pressure = [ev for ev in tr.events
                        if ev["kind"] == "block_pressure"]
            assert pressure and pressure[0]["pressure"] == "defer"
            assert r1.state in ("running", "finished")
            assert r2.state == "queued"
            eng.run()
            assert r1.finished and r2.finished
            kinds[name] = [(ev["kind"], ev.get("pressure"))
                           for ev in tr.events]
        assert kinds["port"] == kinds["jax"]


class TestDisabledTracerAndEnv:
    def test_default_engine_tracer_is_noop(self, models):
        eng = Engine(models["port"], num_slots=1, max_seq=16, min_bucket=16)
        assert eng.tracer is NULL_TRACER
        assert NULL_TRACER.enabled is False
        r = eng.add_request([1, 2, 3], max_new_tokens=2)
        assert NULL_TRACER.events == () and NULL_TRACER.dropped == 0
        assert NULL_TRACER.on_queued(r, "x") is None
        assert "tracing" not in eng.stats()
        assert r.cancel() and r.state == "cancelled"

    def test_from_env(self, monkeypatch):
        monkeypatch.delenv("PADDLE_TPU_TRACE", raising=False)
        assert RequestTracer.from_env() is None
        monkeypatch.setenv("PADDLE_TPU_TRACE", "0")
        assert RequestTracer.from_env() is None
        monkeypatch.setenv("PADDLE_TPU_TRACE", "1")
        assert isinstance(RequestTracer.from_env(), RequestTracer)
        monkeypatch.setenv("PADDLE_TPU_TRACE", "sometimes")
        with pytest.raises(ValueError, match="PADDLE_TPU_TRACE"):
            RequestTracer.from_env()

    def test_bounded_events_fail_validation(self):
        tr = RequestTracer(max_events=2)
        for _ in range(5):
            tr._event("decode_step", replica="x", n_active=1, slots=[0])
        assert len(tr.events) == 2 and tr.dropped == 3
        assert any("dropped" in p for p in validate_trace(tr))

    def test_validator_rejects_broken_chains(self):
        tr = RequestTracer()
        sid = tr._begin_span("t1", "attempt")
        tr._event("retired", trace="t1", span=sid, final=True,
                  state="finished")
        tr._event("retired", trace="t1", span=sid, final=True,
                  state="finished")
        problems = validate_trace(tr)
        assert any("2 terminal events" in p for p in problems)
        assert any("never ended" in p for p in problems)


class TestExporters:
    def test_chrome_trace_is_perfetto_loadable(self, chains, tmp_path):
        run = chains["port"]
        tr = run["tr"]
        ct = obs.chrome_trace(tr)
        assert json.loads(json.dumps(ct))["displayTimeUnit"] == "ms"
        te = ct["traceEvents"]
        procs = {e["args"]["name"] for e in te
                 if e["ph"] == "M" and e["name"] == "process_name"}
        assert procs == {run["eng"].name}
        threads = {e["args"]["name"] for e in te
                   if e["ph"] == "M" and e["name"] == "thread_name"}
        assert threads == {"slot 0"}         # every span was admitted
        spans = [e for e in te if e["ph"] == "X"]
        assert len(spans) == len(tr.spans) == 3   # hi, lo and lo's resume
        assert all(e["dur"] > 0 for e in spans)
        # the preempt renders as a flow arrow into the resume span
        starts = [e for e in te if e["ph"] == "s"]
        ends = [e for e in te if e["ph"] == "f"]
        assert len(starts) == len(ends) == 1
        assert starts[0]["id"] == ends[0]["id"]
        assert any(e["ph"] == "C" and e["name"] == "active_slots"
                   for e in te)
        path = obs.write_chrome_trace(tr, str(tmp_path / "trace.json"))
        with open(path) as f:
            assert json.load(f)["traceEvents"]

    def test_jsonl_export_adds_wall_clock(self, chains, tmp_path):
        tr = chains["port"]["tr"]
        path = str(tmp_path / "events.jsonl")
        n = obs.write_jsonl(tr, path)
        with open(path) as f:
            lines = [json.loads(ln) for ln in f]
        assert n == len(lines) == len(tr.events)
        now = time.time()
        for ln in lines:
            assert abs(ln["wall"] - (tr.wall0 + ln["ts"])) < 1e-6
            assert ln["wall"] <= now + 1
        assert [ln["ts"] for ln in lines] == sorted(ln["ts"] for ln in lines)

    def test_metrics_text_exposition(self, chains):
        eng = chains["port"]["eng"]
        text = obs.render_metrics(eng.stats())
        assert f'engine="{eng.name}"' in text
        for needle in ("paddle_tpu_serving_queue_depth",
                       "paddle_tpu_serving_requests_completed",
                       "paddle_tpu_serving_compile_cache_misses",
                       "paddle_tpu_serving_overload_preemptions",
                       "paddle_tpu_serving_tracing_events",
                       "paddle_tpu_serving_health_kv_block_invariants_info"):
            assert needle in text, (needle, text[:400])
        for line in text.strip().splitlines():
            name_part, value = line.rsplit(" ", 1)
            float(value)
            assert name_part.startswith("paddle_tpu_serving")


class TestSnapshotIsolation:
    def test_serving_metrics_snapshot_is_isolated(self):
        m = ServingMetrics("iso-test", num_slots=2)
        m.on_retry("serving.decode")
        m.on_admit(16, 9, 0)
        snap = m.snapshot()
        snap["failures"]["retries_by_point"]["serving.decode"] = 999
        snap["failures"]["retries_by_point"]["injected"] = 1
        snap["prefills_by_bucket"][16] = 999
        snap["requests"]["admitted"] = 999
        snap["ttft_ms"]["count"] = 999
        fresh = m.snapshot()
        assert fresh["failures"]["retries_by_point"] == \
            {"serving.decode": 1}
        assert fresh["prefills_by_bucket"] == {16: 1}
        assert fresh["requests"]["admitted"] == 1
        assert m.retries_by_point == {"serving.decode": 1}

    def test_engine_stats_paging_section_is_isolated(self, chains):
        eng = chains["port"]["eng"]
        snap = eng.stats()
        before = eng.cache.allocator.stats()["free"]
        snap["paging"]["blocks"]["free"] = -12345
        snap["health"]["kv_blocks"]["free"] = -12345
        assert eng.cache.allocator.stats()["free"] == before
        assert eng.stats()["paging"]["blocks"]["free"] == before


class TestFlightRecorder:
    def test_ring_bound_and_dumps(self):
        rec = FlightRecorder(capacity=4, name="fr-test", max_dumps=2)
        for i in range(10):
            rec.record(step=i)
        snap = rec.snapshot()
        assert snap["ring_depth"] == 4 and snap["steps_seen"] == 10
        for i in range(3):
            rec.dump(f"reason {i}")
        assert [d["reason"] for d in rec.dumps] == ["reason 1", "reason 2"]
        d = rec.dumps[-1]
        assert [e["step"] for e in d["events"]] == [6, 7, 8, 9]
        assert d["wall_time"] == pytest.approx(time.time(), abs=60)
        snap2 = rec.snapshot()
        snap2["dumps"][0]["events"].clear()
        assert rec.dumps[0]["events"]

    def test_engine_records_one_summary_per_step(self, chains):
        run = chains["port"]
        eng = run["eng"]
        ring = eng.flight.snapshot()
        assert ring["steps_seen"] == eng.health()["steps"] > 0
        last = eng.flight.peek("probe")["events"][-1]
        assert last["step"] == ring["steps_seen"]
        assert last["running"] == 0 and last["queued"] == 0
        assert last["free_blocks"] == eng.cache.allocator.free_blocks
