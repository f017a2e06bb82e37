"""The port's serving fleet (``paddle_tpu_torch.serving.router``) against
the JAX package's, on the CPU.

One ``gpt_tiny`` and one ``llama_tiny`` are built in the JAX package from
a seed and their weights carried into the port
(``models.from_jax_state_dict``).  Every scenario of
``tests/test_fleet.py`` (``TestFleetChaos``, ``TestFleetDispatch``,
``TestFleetResilience``), ``tests/test_durability.py::TestFleetDurability``
and the fleet half of ``tests/test_tracing.py`` (the chaos run's span
chain, the exporters, the flight dump frozen at ejection) runs on both
packages with the same arguments, the same seeded prompts and the same
``ServingFaultPlan`` specs, and what a caller sees must be identical:
terminal states and their order, greedy ``output_ids`` (also held to the
port model's no-cache greedy chain), ``redispatches`` and
``replica_history``, the ``requests``/``dispatch``/``supervision``/
``durability`` sections of ``stats()`` (times left out), the plan's call
counts per scoped point, each trace's event kinds, ``validate_trace`` and
the journal's ``audit()``.  Each package recovers the other's fleet
journal.  Greedy streams are compared exactly (argmaxes of f32 logits
that agree to ~1e-6).

A case that writes weights (a rolling update) gives each package its own
copy of the model: the JAX roll writes the template first.
"""
import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as jax_serving
from paddle_tpu import obs as jax_obs
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.fault_tolerance import injection as jax_injection
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.models import llama as jax_llama
import paddle_tpu_torch.serving as port_serving
from paddle_tpu_torch import obs as port_obs
from paddle_tpu_torch.distributed.fault_tolerance import (
    injection as port_injection,
)
from paddle_tpu_torch.models import (
    GPTForCausalLM, LlamaForCausalLM, from_jax_state_dict, gpt_tiny,
    llama_tiny, port_state_dict_from_jax,
)

torch.set_num_threads(2)


def _api(name, mod, injection, obs):
    return SimpleNamespace(
        name=name, Fleet=mod.Fleet, FleetRequest=mod.FleetRequest,
        FleetMetrics=mod.FleetMetrics, Engine=mod.Engine,
        EngineStopped=mod.EngineStopped, QueueFull=mod.QueueFull,
        ShedReject=mod.ShedReject, RequestTracer=mod.RequestTracer,
        RequestJournal=mod.RequestJournal, validate_trace=mod.validate_trace,
        PRIORITY_LOW=mod.PRIORITY_LOW, PRIORITY_HIGH=mod.PRIORITY_HIGH,
        Plan=injection.ServingFaultPlan, obs=obs)


JAX = _api("jax", jax_serving, jax_injection, jax_obs)
PORT = _api("port", port_serving, port_injection, port_obs)
APIS = (JAX, PORT)
FAMILIES = ("gpt", "llama")
_families = pytest.mark.parametrize("family", FAMILIES)

#: the scoped and unscoped points whose call counts are compared
POINTS = ("serving.decode", "serving.prefill", "serving.stream_cb",
          "serving.r0.decode", "serving.r1.decode", "serving.r2.decode",
          "serving.r0.prefill", "serving.r1.prefill", "serving.r2.prefill")

#: the small fleets of ``TestFleetResilience``
SMALL = dict(num_slots=1, max_seq=16, min_bucket=16)


@pytest.fixture(autouse=True)
def _single_device():
    """The JAX side runs unsharded: an earlier test in the same worker may
    leave a hybrid mesh set (model axis > 1)."""
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _jax_model(family):
    paddle.seed(0)
    if family == "gpt":
        m = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny())
    else:
        m = jax_llama.LlamaForCausalLM(jax_llama.llama_tiny())
    m.eval()
    return m


def _port_model(family, sd):
    m = (GPTForCausalLM(gpt_tiny(), device="cpu") if family == "gpt"
         else LlamaForCausalLM(llama_tiny(), device="cpu"))
    return from_jax_state_dict(m, sd).eval()


@pytest.fixture(scope="module")
def models():
    """Per family: the JAX model from seed 0, the port's on its weights,
    and the weights as numpy."""
    out = {}
    for family in FAMILIES:
        jm = _jax_model(family)
        sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
        out[family] = {"jax": jm, "port": _port_model(family, sd),
                       "state": sd}
    return out


def _own_copy(api, models, family):
    """A private copy of the shared model, for a case that writes its
    weights."""
    if api is JAX:
        m = _jax_model(family)
        m.set_state_dict(models[family]["jax"].state_dict())
        return m
    return _port_model(family, models[family]["state"])


def _new_weights(api, models, family):
    """A second weight set (seed 7), as each package's payload."""
    paddle.seed(7)
    jm = (jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny()) if family == "gpt"
          else jax_llama.LlamaForCausalLM(jax_llama.llama_tiny()))
    if api is JAX:
        return jm.state_dict()
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return port_state_dict_from_jax(models[family]["port"], sd)


def _both(scenario, models, family="gpt", *args):
    return {api.name: scenario(api, models[family][api.name], *args)
            for api in APIS}


def _assert_greedy_chain(tm, prompt, out_ids):
    """``out_ids`` must be the no-cache greedy generation of ``prompt`` by
    the port's model."""
    L = len(prompt)
    full = list(prompt) + [int(t) for t in out_ids]
    with torch.no_grad():
        logits = tm(torch.tensor(full[:-1])[None]).numpy()[0]
    for i, t in enumerate(out_ids):
        assert int(np.argmax(logits[L - 1 + i])) == int(t), (i, t)


def _timeless(d):
    """A stats section without its times (and the journal's path)."""
    return {k: v for k, v in d.items()
            if not k.endswith("_ms") and k != "journal"}


def _fleet_view(fleet) -> dict:
    st = fleet.stats()
    json.dumps(st)
    return {k: _timeless(st[k]) for k in ("requests", "dispatch",
                                          "supervision", "durability")}


def _handles(reqs):
    return [(r.state, r.output_ids, r.redispatches, r.redispatched,
             r.replica_history, r.error.split(":")[0] if r.error else None)
            for r in reqs]


# -- the chaos run: a scoped plan kills 1 of 3 replicas mid-decode ------------

MAX_NEW = 4


def _trace_view(api, fleet, tracer, reqs) -> dict:
    """What the chaos run's trace shows: each trace's event kinds, the
    validator's verdict, each request's final events and the attempt
    chain of each redispatched request."""
    kinds = {}
    for ev in tracer.events:
        if ev.get("trace") is not None:
            kinds.setdefault(ev["trace"], []).append(ev["kind"])
    finals, chains = [], []
    for req in reqs:
        trace = f"{fleet.name}:f{req.request_id}"
        finals.append([ev["state"] for ev in tracer.events
                       if ev["kind"] == "retired" and ev.get("final")
                       and ev.get("trace") == trace])
        attempts = sorted((s for s in tracer.spans.values()
                           if s["trace"] == trace and s["name"] == "attempt"),
                          key=lambda s: s["id"])
        root = tracer.spans[attempts[0]["parent"]]
        chains.append({
            "attempts": [(s["replica"], s["state"]) for s in attempts],
            "linked": all(b["parent"] == a["id"]
                          for a, b in zip(attempts, attempts[1:])),
            "root": (root["name"], root["state"])})
    steps = [ev for ev in tracer.events if ev["kind"] == "decode_step"]
    rb = next(ev for ev in tracer.events if ev["kind"] == "rebuild")
    ej = next(ev for ev in tracer.events if ev["kind"] == "eject")
    return {"kinds": kinds, "problems": api.validate_trace(tracer),
            "finals": finals, "chains": chains,
            "eject": (ej["replica"], ej["reason"]),
            "rebuild": (rb["replica"], rb["ok"], rb["recovery_ms"] > 0),
            "batched": (all(ev["n_active"] == len(ev["slots"]) >= 1
                            for ev in steps),
                        len(steps) < sum(ev["n_active"] for ev in steps)),
            "monotonic": [ev["ts"] for ev in tracer.events] == sorted(
                ev["ts"] for ev in tracer.events),
            "wall_free": all("wall" not in ev for ev in tracer.events),
            "dropped": tracer.dropped}


def _chaos(api, model) -> dict:
    """``tests/conftest.py``'s ``fleet_chaos`` run, then the checks of
    ``TestFleetChaos`` and ``TestFleetDispatch`` on the healed fleet."""
    plan = api.Plan().add("serving.r1.decode", at_call=2, times=2)
    tracer = api.RequestTracer()
    fleet = api.Fleet(model, num_replicas=3, num_slots=2, max_seq=32,
                      min_bucket=16, kv_layout="paged", block_size=16,
                      eject_after_failures=2, max_redispatch=2,
                      fault_plan=plan, tracer=tracer, name="chaos")
    fleet.warmup()
    warm = {rep.engine.name: rep.engine.metrics.compile_misses
            for rep in fleet.replicas}
    original_r1 = fleet.replicas[1].engine
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 128, (L,)).tolist()
               for L in (5, 9, 4, 7, 11, 3)]
    terminals, streamed = [], []
    reqs = [fleet.submit(
        p, max_new_tokens=MAX_NEW, replica=1 if i < 2 else None,
        stream_cb=lambda t, r: streamed.append(
            (r.request_id, r.redispatches, t)),
        done_cb=lambda r: terminals.append(r.request_id))
        for i, p in enumerate(prompts)]
    fleet.run()
    out = {"prompts": prompts, "terminals": terminals, "streamed": streamed,
           "handles": _handles(reqs), "stats": _fleet_view(fleet),
           "calls": {p: plan.calls(p) for p in POINTS}}
    out["survivors_flat"] = [
        rep.engine.metrics.compile_misses == warm[rep.engine.name]
        and rep.state == "active" and rep.ejections == 0
        for rep in (fleet.replicas[0], fleet.replicas[2])]
    out["invariants"] = [rep.engine.health()["kv_block_invariants"]
                         for rep in fleet.replicas]
    rep1 = fleet.replicas[1]
    out["replicas"] = [(rep.state, rep.ejections, rep.rebuilds)
                       for rep in fleet.replicas]
    out["r1_replaced"] = rep1.engine is not original_r1
    out["original_r1"] = original_r1.state
    dump = rep1.flight_dumps[-1]
    out["flight"] = (dump["reason"], dump["name"],
                     fleet.stats()["replicas"][1]["last_flight_record"]
                     ["reason"] == dump["reason"])
    out["trace"] = _trace_view(api, fleet, tracer, reqs)
    # the rebuilt replica serves a pinned request with no build past its
    # own warmup
    warm_rebuilt = rep1.engine.metrics.compile_misses
    r = fleet.submit([1, 2, 3, 4], max_new_tokens=3, replica=1)
    fleet.run()
    out["rebuilt_serves"] = (r.state, r.output_ids, r.replica_history,
                             rep1.engine.metrics.compile_misses
                             - warm_rebuilt)
    # TestFleetDispatch: prefix affinity, fleet admission, validation
    rs = np.random.RandomState(7)
    shared = rs.randint(0, 128, (16,)).tolist()     # one whole block
    seed = fleet.submit(shared + [1, 2, 3], max_new_tokens=2, replica=2)
    fleet.run()
    probe = fleet.replicas[2].engine.prefix_probe(shared + [9])
    before = fleet.metrics.affinity_hits
    a = fleet.submit(shared + [4, 5], max_new_tokens=2)
    routed = a.replica_history[:]
    fleet.run()
    b = fleet.submit(rs.randint(0, 128, (5,)).tolist(), max_new_tokens=2)
    fleet.run()
    out["affinity"] = {
        "seed": seed.state, "probe": probe, "routed": routed,
        "hits": fleet.metrics.affinity_hits - before,
        "rate_positive": fleet.metrics.affinity_hit_rate() > 0,
        "handles": _handles([a, b])}
    base_rej = fleet.metrics.rejected
    fleet.max_queue = 2
    try:
        held = [fleet.submit([1, 2], max_new_tokens=2) for _ in range(2)]
        with pytest.raises(api.QueueFull) as qi:
            fleet.submit([3, 4])
    finally:
        fleet.max_queue = None
    fleet.run()
    out["admission"] = {"depth": qi.value.depth,
                        "state": qi.value.request.state,
                        "across": "across" in qi.value.request.error,
                        "held": [r.state for r in held],
                        "rejected": fleet.metrics.rejected - base_rej}
    with pytest.raises(ValueError) as ei:
        fleet.submit([])
    empty = (isinstance(ei.value.request, api.FleetRequest),
             ei.value.request.state, ei.value.request.error)
    with pytest.raises(ValueError) as ei:
        fleet.submit([1, 2], replica=99)
    pinned_bad = str(ei.value)
    r = fleet.submit([5, 6, 7], max_new_tokens=64)
    fleet.step()
    first = r.cancel()
    fleet.run()
    out["validation"] = {"empty": empty, "pinned": pinned_bad,
                         "cancel": (first, r.state, r.cancel()),
                         "duplicates": fleet.metrics.duplicate_terminals}
    out["final_stats"] = _fleet_view(fleet)
    out["fleet"], out["tracer"] = fleet, tracer
    return out


@pytest.fixture(scope="module")
def chaos(models):
    return {family: _both(_chaos, models, family) for family in FAMILIES}


@_families
def test_chaos_terminal_exactly_once(chaos, models, family):
    """Every request ends once, finished, with its full greedy stream;
    the same terminals, streams, redispatches and replica histories in
    both packages."""
    jx, pt = chaos[family]["jax"], chaos[family]["port"]
    for key in ("terminals", "handles", "stats"):
        assert pt[key] == jx[key], key
    assert sorted(pt["terminals"]) == list(range(6))
    assert pt["stats"]["requests"]["duplicate_terminals"] == 0
    assert pt["stats"]["requests"]["completed"] == 6
    for p, h in zip(pt["prompts"], pt["handles"]):
        assert h[0] == "finished" and len(h[1]) == MAX_NEW
        _assert_greedy_chain(models[family]["port"], p, h[1])


@_families
def test_chaos_redispatch_stream_restarts_from_token_zero(chaos, family):
    """A redispatched stream restarts at token 0, marked: the replay-era
    stream is the whole final output, on another replica."""
    jx, pt = chaos[family]["jax"], chaos[family]["port"]
    assert pt["streamed"] == jx["streamed"]
    moved = [(i, h) for i, h in enumerate(pt["handles"]) if h[2] > 0]
    assert moved
    for i, (state, ids, n, marked, history, _) in moved:
        assert marked and n <= 2
        assert [t for rid, k, t in pt["streamed"] if rid == i and k == 0]
        assert [t for rid, k, t in pt["streamed"]
                if rid == i and k == n] == ids
        assert len(history) == 2 and history[0] != history[1]


@_families
def test_chaos_survivors_and_rebuild(chaos, family):
    """The survivors build no program; replica 1 is ejected once, rebuilt
    on a new engine and serves again with no build past its warmup."""
    jx, pt = chaos[family]["jax"], chaos[family]["port"]
    for key in ("survivors_flat", "invariants", "replicas", "r1_replaced",
                "original_r1", "rebuilt_serves"):
        assert pt[key] == jx[key], key
    assert pt["survivors_flat"] == [True, True]
    assert pt["replicas"][1] == ("active", 1, 1) and pt["r1_replaced"]
    sup = pt["stats"]["supervision"]
    assert sup["ejections"] == 1 and sup["rebuilds"] == 1
    assert pt["stats"]["dispatch"]["redispatches"] >= 1
    assert pt["rebuilt_serves"][0] == "finished"
    assert pt["rebuilt_serves"][2] == ["chaos.r1"]
    assert pt["rebuilt_serves"][3] == 0
    assert pt["fleet"].stats()["supervision"]["last_recovery_ms"] > 0


@_families
def test_chaos_plan_calls_per_scoped_point(chaos, family):
    jx, pt = chaos[family]["jax"], chaos[family]["port"]
    assert pt["calls"] == jx["calls"]
    assert pt["calls"]["serving.r1.decode"] >= 3


@_families
def test_chaos_trace_chain(chaos, family):
    """The span chain: valid, one final event per request, redispatch
    attempts linked across replicas, each trace's event kinds those of
    the JAX run, decode steps batched, times monotonic and wall-free."""
    jx, pt = chaos[family]["jax"]["trace"], chaos[family]["port"]["trace"]
    assert pt == jx
    assert pt["problems"] == []
    assert all(f == ["finished"] for f in pt["finals"])
    moved = [c for c in pt["chains"] if len(c["attempts"]) > 1]
    assert moved
    for c in moved:
        assert c["linked"] and c["root"] == ("request", "finished")
        assert c["attempts"][0][0] != c["attempts"][-1][0]
        assert c["attempts"][-1][1] == "finished"
        assert c["attempts"][0][1] in ("failed", "exported")
    assert pt["eject"][0] == "chaos.r1" and pt["rebuild"][1:] == (True,
                                                                  True)
    assert pt["batched"] == (True, True) and pt["monotonic"]
    assert pt["wall_free"] and pt["dropped"] == 0


@_families
def test_chaos_flight_dump_banked_on_ejection(chaos, family):
    jx, pt = chaos[family]["jax"], chaos[family]["port"]
    assert pt["flight"] == jx["flight"]
    reason, name, in_row = pt["flight"]
    assert reason.startswith("ejected") and name == "chaos.r1" and in_row


@_families
def test_dispatch_on_the_healed_fleet(chaos, family):
    """Prefix affinity follows the cached replica, an unrelated prompt
    routes least loaded, fleet admission sums the queues, a malformed or
    mis-pinned submit is rejected and a cancel ends once."""
    jx, pt = chaos[family]["jax"], chaos[family]["port"]
    for key in ("affinity", "admission", "validation", "final_stats"):
        assert pt[key] == jx[key], key
    aff = pt["affinity"]
    assert aff["probe"] == 16 and aff["routed"] == ["chaos.r2"]
    assert aff["hits"] == 1 and aff["rate_positive"]
    assert pt["admission"] == {"depth": 2, "state": "rejected",
                               "across": True,
                               "held": ["finished", "finished"],
                               "rejected": 1}
    v = pt["validation"]
    assert v["empty"][:2] == (True, "rejected")
    assert v["cancel"] == (True, "cancelled", False)
    assert v["duplicates"] == 0


def test_trace_exporters(chaos):
    """The chaos trace exported as a Chrome trace (one process per
    replica plus the router, one slice per span, redispatch flows, the
    active-slots counter) and as JSON lines with wall stamps, shaped as
    the JAX exporters shape it."""
    def shape(api, tracer, names):
        ct = api.obs.chrome_trace(tracer)
        te = json.loads(json.dumps(ct))["traceEvents"]
        procs = {e["args"]["name"] for e in te
                 if e["ph"] == "M" and e["name"] == "process_name"}
        lines = list(api.obs.jsonl_lines(tracer))
        walls = [json.loads(ln) for ln in lines[:20]]
        return {"router": "router" in procs,
                "replicas": {p for p in procs if ".r" in p} == names,
                "slices": len([e for e in te if e["ph"] == "X"]) ==
                len(tracer.spans),
                "flows": (any(e["ph"] == "s" for e in te),
                          any(e["ph"] == "f" for e in te)),
                "counter": any(e["ph"] == "C" and e["name"] ==
                               "active_slots" for e in te),
                "jsonl": (len(lines) == len(tracer.events),
                          all(abs(w["wall"] - (tracer.wall0 + w["ts"]))
                              < 1e-6 for w in walls))}

    got = {}
    for api in APIS:
        run = chaos["gpt"][api.name]
        names = {rep.engine.name for rep in run["fleet"].replicas}
        got[api.name] = shape(api, run["tracer"], names)
    assert got["port"] == got["jax"]
    assert all(v is True or v == (True, True)
               for v in got["port"].values())


def test_fleet_metrics_snapshot_is_isolated():
    for api in APIS:
        fm = api.FleetMetrics("iso-fleet", num_replicas=2)
        rows = [{"index": 0, "nested": {"k": 1}}]
        fm.replicas_cb = lambda: rows
        snap = fm.snapshot()
        snap["replicas"][0]["nested"]["k"] = 999
        snap["requests"]["completed"] = 999
        assert rows[0]["nested"]["k"] == 1
        assert fm.snapshot()["requests"]["completed"] == 0
    keys = {api.name: {k: sorted(v) if isinstance(v, dict) else None
                       for k, v in api.FleetMetrics("k").snapshot().items()}
            for api in APIS}
    assert keys["port"] == keys["jax"]


# -- TestFleetResilience ------------------------------------------------------

def _budget_exhausted(api, model):
    """A fault killing decode on every replica: replayed max_redispatch
    times, then failed with the replica's error; the fleet heals."""
    plan = api.Plan().add("serving.decode", at_call=1, times=4)
    fleet = api.Fleet(model, num_replicas=2, **SMALL,
                      eject_after_failures=2, max_redispatch=1,
                      fault_plan=plan, name="budget")
    terminals = []
    r = fleet.submit([1, 2, 3], max_new_tokens=4,
                     done_cb=lambda fr: terminals.append(fr.state))
    fleet.run()
    assert "redispatch budget exhausted (1)" in r.error
    assert "decode step failed" in r.error
    r2 = fleet.submit([4, 5], max_new_tokens=2)
    fleet.run()
    return {"handles": _handles([r, r2]), "terminals": terminals,
            "stats": _fleet_view(fleet),
            "calls": {p: plan.calls(p) for p in POINTS}}


def _single_replica_replays(api, model):
    """A 1-replica fleet holds a replica-implicated failure across the
    pass that rebuilds its replica, then replays it there."""
    plan = api.Plan().add("serving.decode", at_call=2, times=2)
    fleet = api.Fleet(model, num_replicas=1, **SMALL,
                      eject_after_failures=2, max_redispatch=1,
                      fault_plan=plan, name="solo")
    terminals = []
    r = fleet.submit([1, 2, 3], max_new_tokens=4,
                     done_cb=lambda fr: terminals.append(fr.state))
    fleet.run()
    return {"handles": _handles([r]), "terminals": terminals,
            "stats": _fleet_view(fleet),
            "calls": {p: plan.calls(p) for p in POINTS}}


def _cancel_while_parked(api, model):
    plan = api.Plan().add("serving.decode", at_call=2, times=2)
    fleet = api.Fleet(model, num_replicas=1, **SMALL,
                      eject_after_failures=2, supervise_every=10 ** 9,
                      fault_plan=plan, name="parked")
    terminals = []
    r = fleet.submit([1, 2, 3], max_new_tokens=4,
                     done_cb=lambda fr: terminals.append(fr.state))
    for n in range(9):
        fleet.step()
        if fleet._repatriate:
            break
    parked = (bool(fleet._repatriate), r.done, n)
    fleet.supervise_every = 1
    cancelled = (r.cancel(), r.state)
    fleet.run()
    fleet.shutdown(timeout_s=0.0)
    return {"parked": parked, "cancelled": cancelled,
            "terminals": terminals, "stats": _fleet_view(fleet)}


def _failed_rebuild(api, model):
    """A failed rebuild leaves the replica ejected for the next pass;
    MAX_REBUILD_ATTEMPTS failures in a row mark it dead."""
    fleet = api.Fleet(model, num_replicas=2, **SMALL, name="flaky")
    rep = fleet.replicas[0]
    orig = fleet._make_engine
    fail = {"n": 1}

    def flaky(index):
        if index == 0 and fail["n"] > 0:
            fail["n"] -= 1
            raise RuntimeError("transient rebuild failure")
        return orig(index)

    fleet._make_engine = flaky
    seen = [fleet._eject(rep, "test ejection")]
    fleet._supervise()
    seen.append((rep.state, rep.rebuild_attempts, rep.last_error))
    fleet._supervise()
    seen.append((rep.state, rep.rebuild_attempts))
    r = fleet.submit([1, 2], max_new_tokens=2, replica=0)
    fleet.run()
    fail["n"] = 10
    seen.append(fleet._eject(rep, "test ejection"))
    for _ in range(api.Fleet.MAX_REBUILD_ATTEMPTS):
        fleet._supervise()
    seen.append((rep.state, fleet.metrics.rebuild_failures))
    r2 = fleet.submit([3, 4], max_new_tokens=2)
    fleet.run()
    assert seen[-1] == ("dead", 4)
    return {"seen": seen, "handles": _handles([r, r2]),
            "stats": _fleet_view(fleet)}


def _kill_preemption_race(api, model):
    """A preempted low request and the high request that preempted it
    are both orphaned by a scoped kill of replica 0: each ends once,
    finished, with its priority class kept across the redispatch."""
    plan = api.Plan().add("serving.r0.decode", at_call=4, times=2)
    fleet = api.Fleet(model, num_replicas=2, num_slots=1, max_seq=32,
                      min_bucket=16, kv_layout="paged", block_size=16,
                      eject_after_failures=2, max_redispatch=2,
                      fault_plan=plan, name="race")
    fleet.warmup()
    terminals = []
    rs = np.random.RandomState(21)
    p_lo = rs.randint(0, 128, (5,)).tolist()
    p_hi = rs.randint(0, 128, (6,)).tolist()
    low = fleet.submit(p_lo, max_new_tokens=6, priority="low", replica=0,
                       done_cb=lambda r: terminals.append(r.request_id))
    fleet.step()
    high = fleet.submit(p_hi, max_new_tokens=6, priority="high", replica=0,
                        done_cb=lambda r: terminals.append(r.request_id))
    fleet.step()
    preempted = (low._attempt.preempted, low._attempt.state)
    replay_prio = {}
    for _ in range(60):
        fleet.step()
        for freq in (low, high):
            att = freq._attempt
            if freq.redispatches > 0 and att is not None:
                replay_prio[freq.request_id] = att.priority
        if low.done and high.done:
            break
    fleet.run()
    st = fleet.stats()
    out = {"preempted": preempted, "terminals": terminals,
           "handles": _handles([low, high]), "replay_prio": replay_prio,
           "kwarg": low.kwargs["priority"], "overload": st["overload"],
           "stats": _fleet_view(fleet), "prompts": [p_lo, p_hi]}
    fleet.shutdown(timeout_s=0.0)
    return out


def _shed_mixed_rejection(api, model):
    fleet = api.Fleet(model, num_replicas=2, **SMALL, name="shed")
    fleet.submit([1, 2], max_new_tokens=16, replica=0)
    fleet.replicas[0].engine.metrics.itl_s.extend([0.05] * 20)
    for _ in range(2):
        fleet.submit([3, 4], max_new_tokens=4, replica=1)
    fleet.replicas[1].engine.max_queue = 2
    with pytest.raises(api.QueueFull) as qi:
        fleet.submit([5, 6], max_new_tokens=4, deadline_s=0.001)
    out = {"shed_type": isinstance(qi.value, api.ShedReject),
           "state": qi.value.request.state,
           "overload": fleet.stats()["overload"]}
    fleet.shutdown(timeout_s=0.0)
    out["stats"] = _fleet_view(fleet)
    return out


def _retry_after_priority(api, model):
    fleet = api.Fleet(model, num_replicas=1, **SMALL, max_queue=1,
                      name="retry")
    fleet.submit([1, 2], max_new_tokens=16)
    fleet.replicas[0].engine.metrics.itl_s.extend([0.05] * 10)
    with pytest.raises(api.QueueFull) as hi:
        fleet.submit([3, 4], priority="high")
    with pytest.raises(api.QueueFull) as lo:
        fleet.submit([3, 4], priority="low")
    done = []
    with pytest.raises(ValueError) as vi:
        fleet.submit([3, 4], priority="urgent", done_cb=done.append)
    out = {"high": hi.value.retry_after_s, "low": lo.value.retry_after_s,
           "ctx": lo.value.request.error_ctx,
           "bad": (vi.value.request.state,
                   [r.request_id for r in done]
                   == [vi.value.request.request_id])}
    fleet.shutdown(timeout_s=0.0)
    out["stats"] = _fleet_view(fleet)
    assert out["high"] == 0.0 and out["low"] > 0.0
    return out


def _export_hook(api, model):
    """The ejection hook: queue first, then running, each retired
    replica-kind, slots reclaimed; idempotent."""
    eng = api.Engine(model, **SMALL)
    r1 = eng.add_request([1, 2], max_new_tokens=8)
    r2 = eng.add_request([3, 4], max_new_tokens=8)
    eng.step()
    out = eng.export_requests()
    return {"order": [r.request_id for r in out] == [r2.request_id,
                                                      r1.request_id],
            "retired": [(r.state, r.error_kind, "ejection" in r.error)
                        for r in (r1, r2)],
            "free": sorted(eng.free_slots),
            "empty": (not eng.queue, not eng.running,
                      eng.export_requests() == [])}


def _no_dispatchable_replica(api, model):
    fleet = api.Fleet(model, num_replicas=1, **SMALL, name="empty")
    fleet.replicas[0].state = "ejected"
    with pytest.raises(api.EngineStopped) as ei:
        fleet.submit([1, 2], max_new_tokens=2)
    r = ei.value.request
    with pytest.raises(api.EngineStopped) as ei2:
        fleet.submit([1, 2], max_new_tokens=2, replica=0)
    return {"first": (isinstance(r, api.FleetRequest), r.state, r.error),
            "pinned": ei2.value.request.state, "pending": fleet.pending,
            "stats": _fleet_view(fleet)}


def _drain_max_steps(api, model):
    fleet = api.Fleet(model, num_replicas=1, **SMALL, name="drain1")
    done = []
    reqs = [fleet.submit([i + 1, i + 2], max_new_tokens=2,
                         done_cb=lambda fr: done.append(fr.request_id))
            for i in range(2)]
    st = fleet.drain(max_steps=1)
    return {"handles": _handles(reqs), "done": done, "state": fleet.state,
            "pending": st["pending"], "stats": _fleet_view(fleet)}


def _drain_and_shutdown(api, model):
    fleet = api.Fleet(model, num_replicas=2, **SMALL, name="drain2")
    reqs = [fleet.submit([i, i + 1], max_new_tokens=2) for i in range(3)]
    st = fleet.drain()
    out = {"handles": _handles(reqs), "state": fleet.state,
           "pending": st["pending"],
           "engines": [rep.engine.state for rep in fleet.replicas]}
    with pytest.raises(api.EngineStopped):
        fleet.submit([1, 2])
    fleet2 = api.Fleet(model, num_replicas=1, **SMALL, name="stop")
    r = fleet2.submit([7, 8], max_new_tokens=64)
    fleet2.step()
    fleet2.shutdown(timeout_s=0.0)
    out["shutdown"] = (r.state, r.error, fleet2.state)
    out["stats"] = [_fleet_view(fleet), _fleet_view(fleet2)]
    return out


RESILIENCE = {
    "budget_exhausted": _budget_exhausted,
    "single_replica_replays": _single_replica_replays,
    "cancel_while_parked": _cancel_while_parked,
    "failed_rebuild_retries_before_dead": _failed_rebuild,
    "kill_preemption_race": _kill_preemption_race,
    "shed_counted_on_mixed_rejection": _shed_mixed_rejection,
    "queue_full_retry_after_priority": _retry_after_priority,
    "engine_export_requests_hook": _export_hook,
    "no_dispatchable_replica": _no_dispatchable_replica,
    "drain_max_steps_reaps": _drain_max_steps,
    "drain_and_shutdown": _drain_and_shutdown,
}


@pytest.mark.parametrize("case", list(RESILIENCE))
def test_resilience_matches_jax(models, case):
    """Each case of ``TestFleetResilience`` gives the same handles,
    terminals, counters and plan calls in both packages."""
    got = _both(RESILIENCE[case], models)
    assert got["port"] == got["jax"]
    port = got["port"]
    if "stats" in port and isinstance(port["stats"], dict):
        assert port["stats"]["requests"]["duplicate_terminals"] == 0
    tm = models["gpt"]["port"]
    if case == "budget_exhausted":
        (state, _, n, _, _, _), fin = port["handles"]
        assert (state, n) == ("failed", 1) and fin[0] == "finished"
        assert port["terminals"] == ["failed"]
        _assert_greedy_chain(tm, [4, 5], fin[1])
    elif case == "single_replica_replays":
        state, ids, n, marked, history, _ = port["handles"][0]
        assert (state, n, marked, len(history)) == ("finished", 1, True, 2)
        assert port["terminals"] == ["finished"]
        _assert_greedy_chain(tm, [1, 2, 3], ids)
    elif case == "cancel_while_parked":
        assert port["parked"][:2] == (True, False)
        assert port["terminals"] == ["cancelled"]
    elif case == "kill_preemption_race":
        assert port["preempted"] == (True, "queued")
        for p, h in zip(port["prompts"], port["handles"]):
            assert h[0] == "finished" and h[2] == 1 and len(h[4]) == 2
            _assert_greedy_chain(tm, p, h[1])
        assert port["handles"][1][4] == ["race.r0", "race.r1"]
        assert port["replay_prio"] == {0: 0, 1: 2}
        assert port["overload"]["preemptions"] >= 1
    elif case == "shed_counted_on_mixed_rejection":
        assert not port["shed_type"] and port["overload"]["shed"] == 1
    elif case == "engine_export_requests_hook":
        assert port["order"] and port["free"] == [0]
    elif case == "drain_max_steps_reaps":
        assert port["state"] == "stopped" and port["pending"] == 0
        assert sorted(port["done"]) == [0, 1]


# -- TestFleetDurability ------------------------------------------------------

def _rolling_update(api, model, weights, root):
    j = api.RequestJournal(str(root))
    fleet = api.Fleet(model, num_replicas=2, num_slots=2, max_seq=32,
                      min_bucket=8, kv_layout="paged", block_size=8,
                      journal=j, name="roll")
    fleet.warmup()
    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, 128, (L,)).tolist() for L in (5, 9, 12, 7)]
    live = [fleet.submit(p, max_new_tokens=8) for p in prompts]
    for _ in range(2):
        fleet.step()
    misses = {rep.engine.name: rep.engine.metrics.compile_misses
              for rep in fleet.replicas}
    res = fleet.update_weights(weights, max_drain_steps=500)
    post = [fleet.submit(p, max_new_tokens=6) for p in prompts[:2]]
    fleet.run()
    out = {"res": (res["model_version"], res["replicas_updated"]),
           "live": [(r.state, r.model_version, r.output_ids) for r in live],
           "post": [(r.state, r.model_version, r.output_ids) for r in post],
           "flat": [rep.engine.metrics.compile_misses ==
                    misses[rep.engine.name] for rep in fleet.replicas],
           "epochs": [(rep.engine.prefix_cache.epoch,
                       rep.engine.model_version) for rep in fleet.replicas],
           "isolated": fleet.weights_isolated,
           "stats": _fleet_view(fleet), "audit": j.audit()}
    fleet.shutdown(timeout_s=0.0)
    return out


@_families
def test_rolling_update_under_live_traffic(models, tmp_path, family):
    """In-flight requests finish at version 0, later ones run at 1 on the
    new weights, no program is built, every replica's prefix epoch is 1;
    the same streams in both packages."""
    got = {api.name: _rolling_update(
        api, _own_copy(api, models, family),
        _new_weights(api, models, family), tmp_path / api.name)
        for api in APIS}
    assert got["port"] == got["jax"]
    p = got["port"]
    assert p["res"] == (1, 2) and p["isolated"]
    assert all(s == "finished" and v == 0 for s, v, _ in p["live"])
    assert all(s == "finished" and v == 1 for s, v, _ in p["post"])
    assert p["flat"] == [True, True] and p["epochs"] == [(1, 1), (1, 1)]
    assert p["stats"]["durability"]["weight_rolls"] == 1
    assert p["stats"]["requests"]["failed"] == 0
    assert p["audit"]["duplicate_terminals"] == 0


def _shared_roll(api, model, weights):
    """``isolate_weights=False``: the stop-the-world swap drains every
    replica, writes once and tags each engine."""
    fleet = api.Fleet(model, num_replicas=2, num_slots=2, max_seq=32,
                      min_bucket=8, isolate_weights=False, name="shared")
    rs = np.random.RandomState(12)
    live = [fleet.submit(rs.randint(0, 128, (L,)).tolist(),
                         max_new_tokens=6) for L in (4, 7, 9)]
    fleet.step()
    res = fleet.update_weights(weights, max_drain_steps=100)
    post = fleet.submit([1, 2, 3], max_new_tokens=4)
    fleet.run()
    return {"res": (res["model_version"], res["replicas_updated"]),
            "live": [(r.state, r.model_version) for r in live],
            "post": (post.state, post.model_version, post.output_ids),
            "shared": fleet.replicas[0].engine.model is model,
            "versions": [rep.engine.model_version for rep in fleet.replicas],
            "stats": _fleet_view(fleet)}


def test_stop_the_world_swap_with_shared_weights(models):
    got = {api.name: _shared_roll(api, _own_copy(api, models, "gpt"),
                                  _new_weights(api, models, "gpt"))
           for api in APIS}
    assert got["port"] == got["jax"]
    assert got["port"]["res"] == (1, 2) and got["port"]["shared"]
    assert got["port"]["versions"] == [1, 1]


@_families
def test_weight_isolation_replicas_own_buffers(models, family):
    """Each replica serves its own copy of the template: other tensors,
    the same values, on the template's device and dtype."""
    for api in APIS:
        model = models[family][api.name]
        fleet = api.Fleet(model, num_replicas=2, num_slots=2, max_seq=32,
                          min_bucket=8)
        assert fleet.weights_isolated
        m0, m1 = (rep.engine.model for rep in fleet.replicas)
        assert m0 is not model and m1 is not model
        if api is JAX:
            p0, p1 = m0.parameters()[0], m1.parameters()[0]
            assert p0 is not p1
            np.testing.assert_array_equal(p0.numpy(), p1.numpy())
            continue
        for (n, t), (_, t0), (_, t1) in zip(model.state_dict().items(),
                                            m0.state_dict().items(),
                                            m1.state_dict().items()):
            assert t0.data_ptr() != t.data_ptr() != t1.data_ptr(), n
            assert t0.dtype == t.dtype and t0.device == t.device
            assert torch.equal(t0, t) and torch.equal(t1, t), n
        one = api.Fleet(model, num_replicas=1, num_slots=2, max_seq=32,
                        min_bucket=8)
        assert not one.weights_isolated
        assert one.replicas[0].engine.model is model


def _recover_refuses_live(api, model, root):
    j = api.RequestJournal(str(root))
    fleet = api.Fleet(model, num_replicas=1, num_slots=2, max_seq=32,
                      min_bucket=8, journal=j, name="live")
    fleet.warmup()
    fleet.submit([1, 2, 3], max_new_tokens=6)
    fleet.step()
    with pytest.raises(RuntimeError, match="before serving") as ei:
        fleet.recover()
    fleet.shutdown(timeout_s=0.0)
    return str(ei.value)


def test_fleet_recover_refuses_live_fleet(models, tmp_path):
    got = {api.name: _recover_refuses_live(api, models["gpt"][api.name],
                                           tmp_path / api.name)
           for api in APIS}
    assert got["port"] == got["jax"]


def _crash(api, model, root):
    """Serve one request to its end and leave two mid-decode: the
    abandoned fleet's journal."""
    j = api.RequestJournal(str(root))
    fleet = api.Fleet(model, num_replicas=1, num_slots=2, max_seq=32,
                      min_bucket=8, journal=j, name="crash")
    fleet.warmup()
    done = fleet.submit([1, 2, 3], max_new_tokens=2)
    fleet.run()
    pend = [fleet.submit([4, 5, 6, 7], max_new_tokens=6),
            fleet.submit([8, 9], max_new_tokens=6)]
    fleet.step()
    return {"done": done.state, "pending": [r.done for r in pend],
            "jids": [r.journal_id for r in [done] + pend]}


def _recover(api, model, root):
    j2 = api.RequestJournal(str(root))
    fleet2 = api.Fleet(model, num_replicas=1, num_slots=2, max_seq=32,
                       min_bucket=8, journal=j2, name="crash")
    fleet2.warmup()
    info = fleet2.recover()
    fleet2.run()
    out = {"replayed": info["replayed"], "outcomes": info["outcomes"],
           "jids": [r.journal_id for r in info["requests"]],
           "requests": [(r.recovered, r.state, r.output_ids)
                        for r in info["requests"]],
           "audit": j2.audit(), "stats": _fleet_view(fleet2)}
    fleet2.shutdown(timeout_s=0.0)
    return out


def test_fleet_recover_exactly_once(models, tmp_path):
    """A fleet's journal left with two requests mid-decode: a new fleet
    replays both once, banks the finished one, and the journal's audit
    converges."""
    got = {}
    for api in APIS:
        root = tmp_path / api.name
        crash = _crash(api, models["gpt"][api.name], root)
        assert crash["done"] == "finished" and crash["pending"] != [True,
                                                                    True]
        got[api.name] = _recover(api, models["gpt"][api.name], root)
    assert got["port"] == got["jax"]
    p = got["port"]
    assert p["replayed"] == 2 and p["outcomes"] == {"finished": 1}
    assert all(rec and s == "finished" for rec, s, _ in p["requests"])
    assert p["audit"]["pending"] == 0
    assert p["audit"]["duplicate_terminals"] == 0
    assert p["stats"]["requests"]["completed"] == 3
    assert p["stats"]["durability"]["crash_recoveries"] == 1
    assert p["stats"]["durability"]["recovered"] == 2


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_fleet_journal_recovered_across_packages(models, tmp_path, writer,
                                                 reader):
    """A fleet journal one package left mid-decode is recovered by the
    other's fleet with the writer's own recovered streams."""
    root = tmp_path / "journal"
    crash = _crash(writer, models["gpt"][writer.name], root)
    shutil.copytree(root, tmp_path / "copy")
    own = _recover(writer, models["gpt"][writer.name], root)
    other = _recover(reader, models["gpt"][reader.name], tmp_path / "copy")
    assert own["jids"] == crash["jids"][1:]
    assert other["audit"]["pending"] == 0
    assert other["audit"]["duplicate_terminals"] == 0
    assert other == own


# -- the engine's fleet hooks -------------------------------------------------

def _engine_hooks(api, model, weights):
    """``Engine(model_version=)`` and ``update_weights(version=)``."""
    eng = api.Engine(model, **SMALL, model_version=3)
    r = eng.add_request([1, 2, 3], max_new_tokens=2)
    eng.run()
    v = eng.update_weights(weights, version=7)
    later = eng.add_request([4, 5], max_new_tokens=6)
    eng.drain()
    return {"first": (r.model_version, r.state),
            "later": (later.model_version, later.state), "swap": v,
            "version": eng.model_version, "state": eng.state,
            "durability": eng.stats()["durability"]["model_version"]}


def test_engine_fleet_hooks(models):
    got = {api.name: _engine_hooks(api, _own_copy(api, models, "gpt"),
                                   _new_weights(api, models, "gpt"))
           for api in APIS}
    assert got["port"] == got["jax"]
    assert got["port"]["first"] == (3, "finished")
    assert got["port"]["swap"] == 7 == got["port"]["version"]
    assert got["port"]["later"] == (7, "finished")
    assert got["port"]["state"] == "stopped"


# -- port only ----------------------------------------------------------------

def test_shards_per_group_raises(models):
    """Shard groups need a rank per device: in a world of one the port
    raises the JAX package's ``needs N devices`` (the JAX package, on its
    8 virtual devices, raises it past 8); a width off the viability
    ladder raises naming the ladder in both packages."""
    with pytest.raises(ValueError, match="needs 4 devices"):
        PORT.Fleet(models["gpt"]["port"], shards_per_group=2, **SMALL)
    for api in APIS:
        with pytest.raises(ValueError, match="needs 16 devices"):
            api.Fleet(models["gpt"][api.name], num_replicas=8,
                      shards_per_group=2, **SMALL)
        with pytest.raises(ValueError, match=r"ladder is \[1, 2, 4\]"):
            api.Fleet(models["gpt"][api.name], shards_per_group=3, **SMALL)
    with pytest.raises(ValueError, match="fleet-managed"):
        PORT.Fleet(models["gpt"]["port"], mesh=object(), **SMALL)
    with pytest.raises(ValueError, match="shards_per_group"):
        PORT.Fleet(models["gpt"]["port"], shards_per_group=0, **SMALL)


@pytest.mark.parametrize("made", ["built", "cast"])
@_families
def test_clone_keeps_dtype_device_and_route(family, made):
    """A replica's copy keeps the template's dtypes (a template built in
    bf16 keeps f32 RoPE tables, one cast with ``.to`` does not), device
    and (GPT) attention route, and equals it, buffers included."""
    if made == "built":
        tmpl = PORT.Fleet(f"{family}:tiny", device="cpu",
                          dtype=torch.bfloat16, num_replicas=1,
                          **SMALL).model
    else:
        tmpl = port_serving.Engine.resolve_model(
            f"{family}:tiny", device="cpu").to(torch.bfloat16)
    fleet = PORT.Fleet(tmpl, num_replicas=2, **SMALL)
    assert fleet.weights_isolated
    if family == "gpt":
        for m in tmpl.modules():
            if hasattr(m, "kernel"):
                m.kernel = "reference"
    clone = fleet._replica_model()
    routes = {m.kernel for m in clone.modules()
              if isinstance(getattr(m, "kernel", None), str)}
    assert routes == (set() if family == "llama" else {"reference"})
    src = dict(tmpl.named_parameters())
    src.update(tmpl.named_buffers())
    for name, t in list(clone.named_parameters()) + list(
            clone.named_buffers()):
        assert t.dtype == src[name].dtype and t.device == src[name].device
        assert torch.equal(t, src[name]), name
        assert t.data_ptr() != src[name].data_ptr()
    assert next(clone.parameters()).dtype == torch.bfloat16
    ids = torch.tensor([[1, 2, 3, 4]])
    with torch.no_grad():
        assert torch.equal(clone(ids), tmpl(ids))


def test_ejected_engine_releases_its_device_state(models):
    """An ejection frees the engine's programs, KV tensors and model copy
    before the rebuild, and the released engine still answers
    ``health()`` and ``stats()``."""
    fleet = PORT.Fleet(models["gpt"]["port"], num_replicas=2,
                       num_slots=2, max_seq=32, min_bucket=16,
                       kv_layout="paged", block_size=16)
    fleet.warmup()
    old = fleet.replicas[1].engine
    fleet._eject(fleet.replicas[1], "test ejection")
    assert old.model is None and old.programs.keys() == []
    assert old.cache.k is None and old.cache.block_tables is None
    assert old.health()["kv_block_invariants"] == "ok"
    assert old.stats()["compile_cache"]["misses"] == len(old.buckets) + 1
    assert old.state == "stopped" and old._watchdog is None
    fleet._supervise()
    assert fleet.replicas[1].engine is not old
    r = fleet.submit([1, 2, 3], max_new_tokens=3, replica=1)
    fleet.run()
    assert r.finished
    _assert_greedy_chain(models["gpt"]["port"], [1, 2, 3], r.output_ids)


@pytest.mark.parametrize("when", ["construction", "rebuild"])
def test_failed_copy_never_mixes_weights(models, monkeypatch, when):
    """Isolation is decided once: a copy that fails (out of memory) for
    replica 1 fails the fleet's construction, or that rebuild, and never
    turns the fleet to shared weights.  The roll that follows a failed
    rebuild writes the survivor's own copy, and the replica rebuilt after
    it joins at the new weights and version."""
    import paddle_tpu_torch.serving.router as router

    clone, calls = router._clone_model, []

    def out_of_memory(model):
        calls.append(1)
        if when == "rebuild" or len(calls) == 2:
            raise RuntimeError("out of memory (injected)")
        return clone(model)

    model = _own_copy(PORT, models, "gpt")
    kw = dict(num_replicas=2, num_slots=2, max_seq=32, min_bucket=8)
    if when == "construction":
        monkeypatch.setattr(router, "_clone_model", out_of_memory)
        with pytest.raises(RuntimeError, match="out of memory"):
            PORT.Fleet(model, **kw)
        assert len(calls) == 2
        return
    fleet = PORT.Fleet(model, **kw)
    fleet.warmup()
    rep = fleet.replicas[1]
    monkeypatch.setattr(router, "_clone_model", out_of_memory)
    fleet._eject(rep, "test ejection")
    fleet._supervise()
    assert (rep.state, rep.rebuild_attempts) == ("ejected", 1)
    assert "out of memory" in rep.last_error and fleet.weights_isolated
    new = _new_weights(PORT, models, "gpt")
    res = fleet.update_weights(new, max_drain_steps=100)
    assert (res["model_version"], res["replicas_updated"]) == (1, 1)
    monkeypatch.setattr(router, "_clone_model", clone)
    fleet._supervise()
    assert rep.state == "active" and fleet.weights_isolated
    engines = [r.engine for r in fleet.replicas]
    assert [e.model_version for e in engines] == [1, 1]
    ptrs = {next(m.parameters()).data_ptr()
            for m in (model, *(e.model for e in engines))}
    assert len(ptrs) == 3
    ref = _own_copy(PORT, models, "gpt")
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(new[n])
    prompt = [5, 6, 7]
    pinned = [fleet.submit(prompt, max_new_tokens=4, replica=k)
              for k in (0, 1)]
    fleet.run()
    for r in pinned:
        assert r.finished and r.model_version == 1
        _assert_greedy_chain(ref, prompt, r.output_ids)


@pytest.mark.parametrize("kind", ["plain", "speculating", "tenancy"])
def test_release_device_keeps_host_bookkeeping(models, kind):
    """``Engine._release_device`` drops the programs, the KV tensors, the
    model and the adapter or speculation state, and ``health()`` and
    ``stats()`` still answer from the host's bookkeeping."""
    model = models["gpt"]["port"]
    kw = dict(num_slots=2, max_seq=32, min_bucket=8, kv_layout="paged",
              block_size=8)
    if kind == "speculating":
        kw["speculation"] = port_serving.SpecConfig(draft_model=model, k=2)
    elif kind == "tenancy":
        kw["adapters"] = dict(max_adapters=2, rank=4)
    eng = PORT.Engine(model, **kw)
    eng.warmup()
    eng.generate([[1, 2, 3]], max_new_tokens=3)
    before = eng.stats()
    eng._release_device()
    after = eng.stats()
    assert eng.model is None and eng.spec is None
    assert eng.adapter_pool is None and eng.programs.keys() == []
    assert eng.cache.k is None and eng.cache.lengths is None
    assert eng.state == "stopped" and after["health"]["state"] == "stopped"
    assert after["health"]["kv_block_invariants"] == "ok"
    for key in ("requests", "compile_cache", "speculation", "durability"):
        assert after[key] == before[key], key
    with pytest.raises(PORT.EngineStopped):
        eng.add_request([1, 2], max_new_tokens=2)
