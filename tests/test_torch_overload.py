"""The port's request lifecycle and overload regime, against the JAX engine.

One ``gpt_tiny`` is built in the JAX package from a seed and its weights
converted into the port.  Every scenario of ``tests/test_overload.py``
and the lifecycle cases of ``tests/test_serving.py::TestResilience`` run
on both engines with the same arguments, and what a caller sees must be
identical: output ids, ``preempted``/``preemptions``, terminal states and
errors, and the failure and overload counters.  Two exceptions, both
stated where they arise: a sampled stream is compared within the port
(its noise is a counter hash, not ``jax.random``), and where a deadline
falls between two decode steps by the host clock, each side's tokens
must be a prefix of the other's.

Failures are injected into both engines through their fault plans, which
raise before a step program runs.  The port's are also injected by
wrapping ``engine.programs.run`` and raising after the program ran (its
replay enqueued, its in-place state moved): the streams must be the same
either way.

Two module-scope pairs of engines serve the compiled scenarios: a paged
one (2 slots, buckets 16 and 32) and a contiguous one (2 slots, one
bucket of 16); counters are compared as deltas.  Host-only policy
scenarios build engines that never run a program.
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as jax_serving
from paddle_tpu.distributed.fault_tolerance.injection import (
    ServingFaultPlan,
)
from paddle_tpu.models import gpt as jax_gpt
import paddle_tpu_torch.serving as port_serving
from paddle_tpu_torch.distributed.fault_tolerance.injection import (
    ServingFaultPlan as PortServingFaultPlan,
)
from paddle_tpu_torch.models import (
    GPTForCausalLM, from_jax_state_dict, gpt_tiny,
)

torch.set_num_threads(2)

JAX = SimpleNamespace(
    name="jax", Engine=jax_serving.Engine, QueueFull=jax_serving.QueueFull,
    ShedReject=jax_serving.ShedReject, SamplingParams=jax_serving.SamplingParams,
    HIGH=jax_serving.PRIORITY_HIGH, NORMAL=jax_serving.PRIORITY_NORMAL,
    LOW=jax_serving.PRIORITY_LOW)
PORT = SimpleNamespace(
    name="port", Engine=port_serving.Engine,
    QueueFull=port_serving.QueueFull, ShedReject=port_serving.ShedReject,
    SamplingParams=port_serving.SamplingParams,
    HIGH=port_serving.PRIORITY_HIGH, NORMAL=port_serving.PRIORITY_NORMAL,
    LOW=port_serving.PRIORITY_LOW)

PAGED_KW = dict(num_slots=2, max_seq=32, min_bucket=16, kv_layout="paged",
                block_size=16, max_preemptions=2, priority_aging_s=30.0)
CONTIG_KW = dict(num_slots=2, max_seq=16, min_bucket=16)


@pytest.fixture(scope="module")
def models():
    """The JAX ``gpt_tiny`` and the port's, on the same weights."""
    paddle.seed(0)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny())
    jm.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(GPTForCausalLM(gpt_tiny(), device="cpu"), sd)
    return {"jax": jm, "port": tm.eval()}


def _pair(models, **kw):
    """A warmed JAX engine and a warmed port engine with ``kw``."""
    out = {}
    for api in (JAX, PORT):
        eng = api.Engine(models[api.name], **kw)
        eng.warmup()
        out[api.name] = eng
    return out


@pytest.fixture(scope="module")
def peng(models):
    """The paged pair (aging effectively off, so ordering tests set it)."""
    return _pair(models, **PAGED_KW)


@pytest.fixture(scope="module")
def reng(models):
    """The contiguous pair of the lifecycle scenarios."""
    return _pair(models, **CONTIG_KW)


def _both(scenario, engines_or_models, *args):
    """Run ``scenario(api, engine_or_model, *args)`` on both sides."""
    return {api.name: scenario(api, engines_or_models[api.name], *args)
            for api in (JAX, PORT)}


def _outcome(reqs):
    """What a caller sees of each request."""
    return [(r.state, r.output_ids, r.preempted, r.preemptions,
             r.error.split(":")[0] if r.error else None) for r in reqs]


def _counters(eng) -> dict:
    st = eng.stats()
    f = st["failures"]
    return {**{k: f[k] for k in ("failed", "cancelled", "rejected",
                                 "deadline_expired", "callback_errors",
                                 "step_failures", "step_retries")},
            **{f"retries.{k}": v for k, v in f["retries_by_point"].items()},
            "preemptions": st["overload"]["preemptions"],
            "shed": st["overload"]["shed"],
            "admitted": eng.metrics.requests_admitted}


def _delta(eng, before: dict) -> dict:
    after = _counters(eng)
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] - before.get(k, 0)}


def _assert_greedy_chain(tm, prompt, out_ids):
    """``out_ids`` must be the no-cache greedy generation of ``prompt``
    by the port's model (one causal forward gives every step's logits)."""
    L = len(prompt)
    full = list(prompt) + [int(t) for t in out_ids]
    with torch.no_grad():
        logits = tm(torch.tensor(full[:-1])[None]).numpy()[0]
    for i, t in enumerate(out_ids):
        assert int(np.argmax(logits[L - 1 + i])) == int(t), (i, t)


class Flaky:
    """Wraps ``engine.programs.run``: the calls of the programs named
    ``kind`` (``"prefill"`` or ``"decode"``) whose numbers, counted from
    1 after the wrapper is installed, are in ``fail_at`` raise, either
    ``before`` the program runs or ``after`` it ran."""

    def __init__(self, eng, kind: str, fail_at, when: str):
        self.eng, self.kind, self.fail_at, self.when = eng, kind, \
            set(fail_at), when
        self.real, self.calls = eng.programs.run, 0
        eng.programs.run = self

    def __call__(self, key, body, *inputs):
        if key[0] != self.kind:
            return self.real(key, body, *inputs)
        self.calls += 1
        fail = self.calls in self.fail_at
        if fail and self.when == "before":
            raise RuntimeError(f"injected fault: {self.kind} call "
                               f"#{self.calls}, before the program")
        out = self.real(key, body, *inputs)
        if fail:
            raise RuntimeError(f"injected fault: {self.kind} call "
                               f"#{self.calls}, after the program")
        return out

    def remove(self):
        del self.eng.programs.run        # the class's method again


def _inject(api, eng, kind, at_call, times, when):
    """Fail ``times`` calls of ``kind`` from the ``at_call``-th on; returns
    what undoes it.  A failure ``before`` the program is the fault plan's,
    in either package; one ``after`` it ran (its replay enqueued, its
    in-place state moved) has no JAX counterpart and wraps the port's
    ``programs.run``."""
    if api is JAX or when == "before":
        plan = ServingFaultPlan if api is JAX else PortServingFaultPlan
        eng.fault_plan = plan().add(f"serving.{kind}", at_call=at_call,
                                    times=times)
        return lambda: setattr(eng, "fault_plan", plan())
    return Flaky(eng, kind, range(at_call, at_call + times), when).remove


# -- host-only policy scenarios (no program ever runs) ----------------------

def _priority_normalization(api, model):
    eng = api.Engine(model, num_slots=1, max_seq=16, min_bucket=16)
    got = [eng.add_request([1, 2], priority="high").priority,
           eng.add_request([1, 2], priority="LOW").priority,
           eng.add_request([1, 2]).priority,
           eng.add_request([1, 2], priority=7).priority]
    with pytest.raises(ValueError, match="unknown priority"):
        eng.add_request([1, 2], priority="urgent")
    with pytest.raises(ValueError):
        api.Engine(model, max_seq=16, max_preemptions=-1)
    with pytest.raises(ValueError):
        api.Engine(model, max_seq=16, priority_aging_s=0.0)
    return got


def test_priority_normalization(models):
    res = _both(_priority_normalization, models)
    assert res["port"] == res["jax"] == [PORT.HIGH, PORT.LOW, PORT.NORMAL, 7]


def _victim_policy(api, model):
    eng = api.Engine(model, num_slots=4, max_seq=16, min_bucket=16,
                     max_preemptions=2)

    def running(slot, prio, tokens, rid):
        r = eng.add_request([1, 2], priority=prio)
        eng.queue.remove(r)
        r.slot, r.state, r.request_id = slot, "running", rid
        r.output_ids = list(range(tokens))
        eng.running[slot] = r
        return r

    lo_old = running(0, api.LOW, 3, 10)
    lo_new = running(1, api.LOW, 3, 11)
    lo_far = running(2, api.LOW, 5, 12)
    nm = running(3, api.NORMAL, 0, 13)
    names = {id(lo_old): "lo_old", id(lo_new): "lo_new",
             id(lo_far): "lo_far", id(nm): "nm", id(None): None}
    cand_hi = eng.add_request([3, 4], priority="high")
    picks = [eng._pick_victim(cand_hi)]
    lo_new.preemptions = 2
    picks.append(eng._pick_victim(cand_hi))
    for r in (lo_old, lo_far):
        r.preemptions = 2
    picks.append(eng._pick_victim(cand_hi))
    nm.preemptions = 2
    picks.append(eng._pick_victim(cand_hi))
    cand_nm = eng.add_request([3, 4], priority="normal")
    cand_nm.t_enqueue -= 1e6                    # an enormous aging boost
    nm.preemptions = 0
    boosted = eng._effective_priority(cand_nm, time.perf_counter()) > \
        api.HIGH
    picks.append(eng._pick_victim(cand_nm))
    eng.max_preemptions = 0
    picks.append(eng._pick_victim(cand_hi))
    return [names[id(p)] for p in picks], boosted


def test_victim_policy(models):
    """Lowest class first, least progress next, youngest last; a spent
    budget makes a request immune; aging never grants preemption."""
    res = _both(_victim_policy, models)
    assert res["port"] == res["jax"] == (
        ["lo_new", "lo_old", "nm", None, None, None], True)


def _estimator_and_shed(api, model):
    eng = api.Engine(model, num_slots=1, max_seq=32, min_bucket=16)
    out = {"cold": eng.estimate_queue_wait_s()}
    eng.add_request([1, 2, 3], max_new_tokens=16)
    eng.add_request([4, 5, 6], max_new_tokens=16)
    rq = eng.add_request([7, 8], max_new_tokens=4, deadline_s=0.001)
    out["cold_state"] = rq.state
    eng.queue.remove(rq)
    eng.metrics.itl_s.extend([0.005] * 20)
    out["wait"] = eng.estimate_queue_wait_s()
    with pytest.raises(api.ShedReject) as ei:
        eng.add_request([7, 8], max_new_tokens=4, deadline_s=0.001)
    e = ei.value
    out.update(is_queue_full=isinstance(e, api.QueueFull), depth=e.depth,
               retry_after_s=e.retry_after_s, state=e.request.state,
               error=e.request.error, error_ctx=e.request.error_ctx,
               shed=eng.metrics.requests_shed,
               rejected=eng.metrics.requests_rejected,
               overload=eng.stats()["overload"])
    out["generous"] = eng.add_request([7, 8], max_new_tokens=4,
                                      deadline_s=60.0).state
    out["no_deadline"] = eng.add_request([9], max_new_tokens=4).state
    out["high_waits_less"] = eng.estimate_queue_wait_s(api.HIGH) < \
        eng.estimate_queue_wait_s(api.LOW)
    return out


def test_estimator_and_shed(models):
    """A cold engine never sheds; a loaded one sheds a deadline-carrying
    admission with its depth and ``retry_after_s``; a deadline-less
    request is never shed."""
    res = _both(_estimator_and_shed, models)
    assert res["port"] == res["jax"]
    t = res["port"]
    assert t["cold"] == 0.0 and t["cold_state"] == "queued"
    assert t["wait"] > 0.001 and t["is_queue_full"] and t["depth"] == 2
    assert t["retry_after_s"] == pytest.approx(t["wait"], abs=0.05)
    assert t["state"] == "rejected" and "shed" in t["error"]
    assert t["error_ctx"] == {"depth": 2,
                              "retry_after_s": t["retry_after_s"]}
    assert t["overload"] == {"preemptions": 0, "shed": 1}
    assert t["generous"] == t["no_deadline"] == "queued"
    assert t["high_waits_less"]


def _entitled_preemptor(api, model):
    eng = api.Engine(model, num_slots=1, max_seq=16, min_bucket=16,
                     max_preemptions=2)
    lo = eng.add_request([1, 2], priority="low")
    eng.queue.remove(lo)
    lo.slot, lo.state = eng.free_slots.pop(), "running"
    eng.running[lo.slot] = lo
    eng.metrics.itl_s.extend([0.05] * 20)
    out = [eng.estimate_queue_wait_s(api.HIGH) > 0.001]
    hi = eng.add_request([3, 4], max_new_tokens=4, deadline_s=0.001,
                         priority="high")
    out.append(hi.state)                        # entitled: not shed
    with pytest.raises(api.ShedReject):         # contended: shed
        eng.add_request([5, 6], max_new_tokens=4, deadline_s=0.001,
                        priority="high")
    eng.queue.remove(hi)
    aged = eng.add_request([7, 8], priority="low")
    aged.t_enqueue -= 1e6
    out.append(eng._pick_victim(aged) is None)
    still = eng.add_request([3, 4], max_new_tokens=4, deadline_s=0.001,
                            priority="high")
    out.append(still.state)                     # victimless head: not shed
    eng.queue.remove(aged)
    eng.queue.remove(still)
    lo.preemptions = eng.max_preemptions
    with pytest.raises(api.ShedReject):         # no victim: shed
        eng.add_request([5, 6], max_new_tokens=4, deadline_s=0.001,
                        priority="high")
    return out


def test_entitled_preemptor_never_shed(models):
    res = _both(_entitled_preemptor, models)
    assert res["port"] == res["jax"] == [True, "queued", True, "queued"]


def _queue_full_retry_after(api, model):
    eng = api.Engine(model, num_slots=1, max_seq=16, min_bucket=16,
                     max_queue=1)
    eng.metrics.itl_s.extend([0.01] * 5)
    eng.add_request([1, 2], max_new_tokens=8)
    with pytest.raises(api.QueueFull) as qi:
        eng.add_request([3, 4], max_new_tokens=8)
    e = qi.value
    return e.depth, e.retry_after_s, e.request.error_ctx, e.request.error


def test_queue_full_carries_retry_after(models):
    res = _both(_queue_full_retry_after, models)
    assert res["port"] == res["jax"]
    depth, retry, ctx, error = res["port"]
    assert depth == 1 and retry is not None
    assert ctx == {"depth": 1, "retry_after_s": retry}
    assert "retry_after_s" in error


def _aging_ordering(api, model):
    eng = api.Engine(model, num_slots=1, max_seq=16, min_bucket=16,
                     priority_aging_s=0.05)
    old_low = eng.add_request([1, 2], priority="low")
    old_low.t_enqueue -= 0.11                   # two aging intervals
    fresh_nm = eng.add_request([3, 4], priority="normal")
    now = time.perf_counter()
    name = {id(old_low): "old_low", id(fresh_nm): "fresh_nm"}
    out = [eng._effective_priority(old_low, now),
           eng._effective_priority(fresh_nm, now),
           name[id(eng.queue[eng._best_queued_index(now)])]]
    old_low.t_enqueue = fresh_nm.t_enqueue
    out.append(name[id(eng.queue[eng._best_queued_index(now)])])
    eng.priority_aging_s = None
    old_low.t_enqueue -= 100.0
    out.append(name[id(eng.queue[eng._best_queued_index(
        time.perf_counter())])])
    return out


def test_effective_priority_aging_ordering(models):
    res = _both(_aging_ordering, models)
    assert res["port"] == res["jax"] == [
        PORT.LOW + 2, PORT.NORMAL, "old_low", "fresh_nm", "fresh_nm"]


# -- preemption on the paged pair --------------------------------------------

def _preemption_stream_restart(api, eng):
    rs = np.random.RandomState(5)
    streamed = []

    def cb(t, r):
        streamed.append((r.request_id, r.preemptions, t))

    before = _counters(eng)
    p1, p2 = (rs.randint(0, 128, (L,)).tolist() for L in (5, 6))
    a1 = eng.add_request(p1, max_new_tokens=8, priority="low", stream_cb=cb)
    a2 = eng.add_request(p2, max_new_tokens=8, priority="low", stream_cb=cb)
    eng.step()
    eng.step()
    mid = (a1.state, a2.state)
    b = eng.add_request(rs.randint(0, 128, (4,)).tolist(), max_new_tokens=4,
                        priority="high")
    eng.run()
    pre = [t for rid, n, t in streamed if rid == a2.request_id and n == 0]
    replay = [t for rid, n, t in streamed if rid == a2.request_id and n == 1]
    return {"mid": mid, "outcome": _outcome([a1, a2, b]),
            "prompts": [p1, p2], "pre": pre, "replay": replay,
            "delta": _delta(eng, before),
            "invariants": eng.health()["kv_block_invariants"],
            "free": sorted(eng.free_slots)}


def test_preemption_parity_and_stream_restart(models, peng):
    """A low request preempted mid-decode by a high one resumes and ends
    with the uninterrupted greedy stream; its stream restarts from token
    0, marked; no program is built."""
    warm = {k: e.metrics.compile_misses for k, e in peng.items()}
    res = _both(_preemption_stream_restart, peng)
    assert res["port"]["outcome"] == res["jax"]["outcome"]
    assert res["port"]["delta"] == res["jax"]["delta"]
    t = res["port"]
    assert t["mid"] == ("running", "running")
    (_, _, a1_pre, _, _), (_, a2_out, a2_pre, a2_n, _), _ = t["outcome"]
    assert a2_pre and a2_n == 1 and not a1_pre
    assert t["delta"]["preemptions"] == 1
    for (state, out, *_), p in zip(t["outcome"], t["prompts"]):
        assert state == "finished" and len(out) == 8
        _assert_greedy_chain(models["port"], p, out)
    assert t["pre"] and t["replay"] == a2_out
    assert t["invariants"] == "ok" and t["free"] == [0, 1]
    for k, e in peng.items():
        assert e.metrics.compile_misses == warm[k]


def _seeded_resume(api, eng, sp):
    rs = np.random.RandomState(16)
    p = rs.randint(0, 128, (6,)).tolist()
    ref = eng.add_request(p, max_new_tokens=6,
                          sampling=api.SamplingParams(**sp))
    eng.run()
    vic = eng.add_request(p, max_new_tokens=6,
                          sampling=api.SamplingParams(**sp), priority="low")
    filler = eng.add_request(rs.randint(0, 128, (5,)).tolist(),
                             max_new_tokens=6, priority="low")
    eng.step()
    eng.step()
    hi = eng.add_request(rs.randint(0, 128, (3,)).tolist(),
                         max_new_tokens=3, priority="high")
    eng.run()
    return {"ref": ref.output_ids, "vic": vic.output_ids,
            "shape": [(r.state, len(r.output_ids), r.preempted,
                       r.preemptions) for r in (ref, vic, filler, hi)]}


@pytest.mark.parametrize("sp", [
    dict(temperature=1.0, seed=77),
    dict(temperature=0.8, top_k=10, top_p=0.9, seed=314)],
    ids=["temperature", "top_k_top_p"])
def test_seeded_sampling_resumes_deterministically(peng, sp):
    """A seeded victim replays its stream: the re-admission re-stages
    its seed and a zero counter.  Held within the port (the two
    frameworks draw different noise from one seed); the lifecycle is
    held to the JAX engine."""
    res = _both(_seeded_resume, peng, sp)
    assert res["port"]["shape"] == res["jax"]["shape"]
    t = res["port"]
    assert any(pre for *_, pre, _n in t["shape"][1:3])
    assert all(s == "finished" for s, *_ in t["shape"])
    assert t["vic"] == t["ref"]
    assert all(0 <= tok < 128 for tok in t["vic"])


def _preemption_budget(api, eng):
    before = _counters(eng)
    rs = np.random.RandomState(8)
    a1 = eng.add_request(rs.randint(0, 128, (4,)).tolist(),
                         max_new_tokens=6, priority="low")
    a2 = eng.add_request(rs.randint(0, 128, (5,)).tolist(),
                         max_new_tokens=6, priority="low")
    eng.step()
    for r in (a1, a2):
        r.preemptions = eng.max_preemptions      # budget spent
    hi = eng.add_request(rs.randint(0, 128, (3,)).tolist(),
                         max_new_tokens=2, priority="high")
    eng.run()
    return _outcome([a1, a2, hi]), _delta(eng, before)


def test_preemption_budget_makes_request_immune(peng):
    res = _both(_preemption_budget, peng)
    assert res["port"] == res["jax"]
    outcome, delta = res["port"]
    assert "preemptions" not in delta
    assert all(s == "finished" for s, *_ in outcome)
    assert [len(o[1]) for o in outcome] == [6, 6, 2]


def _ordering_under_contention(api, eng):
    eng.max_preemptions, saved = 0, eng.max_preemptions
    try:
        rs = np.random.RandomState(9)
        a1 = eng.add_request(rs.randint(0, 128, (4,)).tolist(),
                             max_new_tokens=2)
        a2 = eng.add_request(rs.randint(0, 128, (5,)).tolist(),
                             max_new_tokens=8)
        eng.step()
        lo = eng.add_request(rs.randint(0, 128, (3,)).tolist(),
                             max_new_tokens=2, priority="low")
        hi = eng.add_request(rs.randint(0, 128, (6,)).tolist(),
                             max_new_tokens=2, priority="high")
        while hi.state == "queued":
            eng.step()
        lo_state = lo.state
        eng.run()
        return lo_state, _outcome([a1, a2, lo, hi])
    finally:
        eng.max_preemptions = saved


def test_priority_ordering_under_contention(peng):
    """With preemption off, classes only reorder the queue."""
    res = _both(_ordering_under_contention, peng)
    assert res["port"] == res["jax"]
    lo_state, outcome = res["port"]
    assert lo_state == "queued"
    assert all(s == "finished" for s, *_ in outcome)


def _aged_head(api, eng):
    eng.priority_aging_s, saved = 0.01, eng.priority_aging_s
    try:
        rs = np.random.RandomState(10)
        n1 = eng.add_request(rs.randint(0, 128, (4,)).tolist(),
                             max_new_tokens=8, priority="normal")
        n2 = eng.add_request(rs.randint(0, 128, (5,)).tolist(),
                             max_new_tokens=8, priority="normal")
        eng.step()
        aged_low = eng.add_request(rs.randint(0, 128, (3,)).tolist(),
                                   max_new_tokens=2, priority="low")
        aged_low.t_enqueue -= 1.0
        hi = eng.add_request(rs.randint(0, 128, (6,)).tolist(),
                             max_new_tokens=4, priority="high")
        now = time.perf_counter()
        ahead = eng._effective_priority(aged_low, now) > \
            eng._effective_priority(hi, now)
        eng.step()
        mid = (hi.state, aged_low.state)
        eng.run()
        return ahead, mid, _outcome([n1, n2, aged_low, hi])
    finally:
        eng.priority_aging_s = saved


def test_aged_head_does_not_block_entitled_preemptor(peng):
    res = _both(_aged_head, peng)
    assert res["port"] == res["jax"]
    ahead, mid, outcome = res["port"]
    assert ahead and mid == ("running", "queued")
    assert outcome[0][2] or outcome[1][2]       # a normal was preempted
    assert all(s == "finished" for s, *_ in outcome)


def _queued_deadline(api, eng):
    before = _counters(eng)
    buckets = dict(eng.metrics.prefills_by_bucket)
    r1 = eng.add_request([1, 2, 3], max_new_tokens=2,
                         stream_cb=lambda t, r: time.sleep(0.03))
    r2 = eng.add_request([4, 5, 6], max_new_tokens=2, deadline_s=0.01)
    eng.run()
    got = dict(eng.metrics.prefills_by_bucket)
    got[r1.prefill_bucket] -= 1                 # exactly r1's prefill
    return (_outcome([r1, r2]), _delta(eng, before),
            {k: v for k, v in got.items() if v} ==
            {k: v for k, v in buckets.items() if v},
            sorted(eng.free_slots))


def test_queued_deadline_expiry_pays_no_prefill(peng):
    """A deadline that expires while the request is queued retires it
    without a prefill, an admission or a bucket count."""
    res = _both(_queued_deadline, peng)
    assert res["port"] == res["jax"]
    outcome, delta, same_buckets, free = res["port"]
    assert outcome[0][0] == "finished"
    assert outcome[1][:2] == ("failed", []) and outcome[1][4] == \
        "deadline of 0.01s exceeded"
    assert delta == {"admitted": 1, "failed": 1, "deadline_expired": 1}
    assert same_buckets and free == [0, 1]


def _preempt_for_blocks(api, model):
    eng = api.Engine(model, num_slots=2, max_seq=32, min_bucket=16,
                     kv_layout="paged", block_size=16, num_kv_blocks=4,
                     max_preemptions=2, priority_aging_s=30.0)
    eng.warmup()
    warm = eng.metrics.compile_misses
    rs = np.random.RandomState(7)
    pa = rs.randint(0, 128, (17,)).tolist()     # bucket 32: 2 blocks
    pb = rs.randint(0, 128, (17,)).tolist()
    A = eng.add_request(pa, max_new_tokens=6, priority="low")
    eng.step()
    eng.step()
    mid = (A.state, A.prefill_bucket)
    hits = eng.prefix_cache.stats()["hit_blocks"]
    B = eng.add_request(pb, max_new_tokens=4, priority="high")
    eng.run()
    return {"mid": mid, "outcome": _outcome([A, B]),
            "buckets": (A.prefill_bucket, B.prefill_bucket),
            "hit_blocks": eng.prefix_cache.stats()["hit_blocks"] - hits,
            "new_programs": eng.metrics.compile_misses - warm,
            "invariants": eng.health()["kv_block_invariants"],
            "prompts": (pa, pb)}


def test_preempt_for_blocks_cheap_resume(models):
    """A high admission the pool cannot serve evicts the low victim's
    blocks; the victim's prompt blocks enter the prefix cache before its
    release, so its resume prefills the tail bucket only (16, not 32)."""
    res = _both(_preempt_for_blocks, models)
    assert res["port"] == res["jax"]
    t = res["port"]
    assert t["mid"] == ("running", 32)
    (a_state, a_out, a_pre, a_n, _), (b_state, b_out, *_) = t["outcome"]
    assert a_pre and a_n == 1 and a_state == b_state == "finished"
    assert t["buckets"] == (16, 32) and t["hit_blocks"] > 0
    for p, out in zip(t["prompts"], (a_out, b_out)):
        _assert_greedy_chain(models["port"], p, out)
    assert t["new_programs"] == 0 and t["invariants"] == "ok"


# -- lifecycle cases of TestResilience on the contiguous pair ---------------

def _backpressure(api, eng):
    before = _counters(eng)
    eng.max_queue, eng.queue_policy = 1, "reject"
    out = []
    try:
        with pytest.raises(ValueError) as ei:
            eng.add_request([])
        out.append((ei.value.request.state, ei.value.request.error))
        with pytest.raises(ValueError) as ei:
            eng.add_request([1, 2], deadline_s=-1.0)
        out.append(ei.value.request.error)
        r0 = eng.add_request([5, 6], max_new_tokens=2)
        with pytest.raises(api.QueueFull) as qi:
            eng.add_request([7, 8])
        out.append((qi.value.depth, qi.value.request.state))
        eng.queue_policy = "block"
        with pytest.raises(api.QueueFull):
            eng.add_request([7, 8], block_timeout_s=0.0)
        rz = eng.add_request([9, 10], max_new_tokens=2,
                             block_timeout_s=30.0)
        out.append(r0.state in ("running", "finished"))
        eng.run()
        out.append(_outcome([r0, rz]))
    finally:
        eng.max_queue, eng.queue_policy = None, "reject"
    return out, _delta(eng, before)


def test_enqueue_rejection_and_backpressure(reng):
    res = _both(_backpressure, reng)
    assert res["port"] == res["jax"]
    out, delta = res["port"]
    assert out[0] == ("rejected", "empty prompt")
    assert out[1] == "deadline_s must be > 0, got -1.0"
    assert out[2] == (1, "rejected") and out[3]
    assert [(s, len(o)) for s, o, *_ in out[4]] == [("finished", 2)] * 2
    assert delta == {"rejected": 4, "admitted": 2}


def _cancel(api, eng):
    before = _counters(eng)
    r1 = eng.add_request([1, 2, 3], max_new_tokens=4)
    out = [r1.cancel(), r1.state, len(eng.queue), r1.cancel()]
    r2 = eng.add_request([4, 5], max_new_tokens=8)
    eng.step()
    out.append(r2.state)
    emitted = list(r2.output_ids)
    out.append(r2.cancel())
    eng.run()
    out.append(r2.output_ids == emitted)
    r3 = eng.add_request(
        [6, 7], max_new_tokens=10,
        stream_cb=lambda t, r: r.cancel() if len(r.output_ids) >= 2
        else None)
    eng.run()
    out += [_outcome([r1, r2, r3]), sorted(eng.free_slots)]
    return out, _delta(eng, before)


def test_cancel_queued_running_and_from_cb(reng):
    """Cancel while queued (at once), while running (at the next step
    boundary, between programs) and from the request's own callback."""
    res = _both(_cancel, reng)
    assert res["port"] == res["jax"]
    out, delta = res["port"]
    assert out[:7] == [True, "cancelled", 0, False, "running", True, True]
    assert [(s, len(o)) for s, o, *_ in out[7]][2] == ("cancelled", 2)
    assert all(s == "cancelled" and e is None for s, _, _, _, e in out[7])
    assert out[8] == [0, 1]
    assert delta == {"cancelled": 3, "admitted": 2}


def _deadline(api, eng):
    before = _counters(eng)
    rq = eng.add_request([1, 2], max_new_tokens=4, deadline_s=1e-4)
    time.sleep(0.002)
    eng.run()
    rd = eng.add_request([3, 4], max_new_tokens=13, deadline_s=0.12,
                         stream_cb=lambda t, r: time.sleep(0.01))
    eng.run()
    return {"queued": (rq.state, rq.error, rq.slot, rq.output_ids),
            "decode": (rd.state, rd.error, rd.output_ids),
            "delta": _delta(eng, before), "free": sorted(eng.free_slots)}


def test_deadline_expiry(reng):
    """Expired while queued: failed without a slot.  Expired mid-decode
    (each token's callback sleeps 10 ms against a 120 ms budget): failed
    at a step boundary after a few tokens.  That step is found by the
    host clock, so each side's tokens are a prefix of the other's."""
    res = _both(_deadline, reng)
    j, t = res["jax"], res["port"]
    assert t["queued"] == j["queued"] == (
        "failed", "deadline of 0.0001s exceeded", None, [])
    assert t["decode"][:2] == j["decode"][:2] == (
        "failed", "deadline of 0.12s exceeded")
    jt, tt = j["decode"][2], t["decode"][2]
    assert 1 <= len(tt) < 13
    n = min(len(jt), len(tt))
    assert tt[:n] == jt[:n]
    assert t["delta"] == j["delta"] == {"failed": 2, "deadline_expired": 2,
                                        "admitted": 1}
    assert t["free"] == [0, 1]


def _prefill_fault(api, eng, when):
    before = _counters(eng)
    undo = _inject(api, eng, "prefill", 1, 2, when)
    rs = np.random.RandomState(12)
    p = rs.randint(0, 128, (4,)).tolist()
    try:
        r = eng.add_request(p, max_new_tokens=3)
        eng.run()
        free = sorted(eng.free_slots)
        r2 = eng.add_request(p, max_new_tokens=3)
        eng.run()
    finally:
        undo()
    return _outcome([r, r2]), free, _delta(eng, before), p


@pytest.mark.parametrize("when", ["before", "after"])
def test_prefill_fault_slot_leak_regression(models, reng, when):
    """Two failed prefill calls defeat the one retry: the request fails,
    its slot comes back, and the engine serves the same prompt next."""
    res = _both(_prefill_fault, reng, when)
    assert res["port"][:3] == res["jax"][:3]
    outcome, free, delta, p = res["port"]
    assert outcome[0][0] == "failed" and \
        outcome[0][4] == "prefill failed after 1 retry"
    assert free == [0, 1]
    assert outcome[1][0] == "finished"
    _assert_greedy_chain(models["port"], p, outcome[1][1])
    assert delta == {"failed": 1, "step_failures": 2, "step_retries": 1,
                     "retries.serving.prefill": 1, "admitted": 1}


def _decode_retry_and_cb_fault(api, eng, when):
    before = _counters(eng)
    undo = _inject(api, eng, "decode", 2, 1, when)
    calls = [0]
    streamed = []

    def cb(t, r):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("user cb boom")
        streamed.append((r.request_id, t))

    rs = np.random.RandomState(13)
    prompts = [rs.randint(0, 128, (L,)).tolist() for L in (3, 6, 4)]
    try:
        reqs = [eng.add_request(p, max_new_tokens=4, stream_cb=cb)
                for p in prompts]
        eng.run()
    finally:
        undo()
    got = [[t for rid, t in streamed if rid == r.request_id]
           for r in reqs]
    return (_outcome(reqs), got, _delta(eng, before),
            sorted(eng.free_slots), prompts)


@pytest.mark.parametrize("when", ["before", "after"])
def test_decode_retry_and_cb_fault(models, reng, when):
    """A decode call that fails once is absorbed by the retry, whether it
    failed before its program ran or after (then the lengths, tokens and
    counters it moved are put back first); a raising callback fails its
    request only.  The healthy streams are the unfaulted greedy ones."""
    res = _both(_decode_retry_and_cb_fault, reng, when)
    assert res["port"][:4] == res["jax"][:4]
    outcome, got, delta, free, prompts = res["port"]
    assert outcome[0][0] == "failed" and outcome[0][4] == "stream_cb raised"
    for i in (1, 2):
        assert outcome[i][0] == "finished" and len(outcome[i][1]) == 4
        _assert_greedy_chain(models["port"], prompts[i], outcome[i][1])
        assert got[i] == outcome[i][1]
    assert free == [0, 1]
    assert delta == {"failed": 1, "callback_errors": 1, "step_failures": 1,
                     "step_retries": 1, "retries.serving.decode": 1,
                     "admitted": 3}


def _decode_retry_exhausted(api, eng, when):
    before = _counters(eng)
    undo = _inject(api, eng, "decode", 1, 2, when)
    rs = np.random.RandomState(14)
    ps = [rs.randint(0, 128, (L,)).tolist() for L in (3, 5, 4)]
    try:
        reqs = [eng.add_request(p, max_new_tokens=3) for p in ps]
        eng.run()
    finally:
        undo()
    return _outcome(reqs), _delta(eng, before), sorted(eng.free_slots), ps


@pytest.mark.parametrize("when", ["before", "after"])
def test_decode_retry_exhausted_fails_batch_not_engine(models, reng, when):
    res = _both(_decode_retry_exhausted, reng, when)
    assert res["port"][:3] == res["jax"][:3]
    outcome, delta, free, ps = res["port"]
    for state, _, _, _, err in outcome[:2]:
        assert state == "failed" and err == "decode step failed after 1 retry"
    assert outcome[2][0] == "finished"
    _assert_greedy_chain(models["port"], ps[2], outcome[2][1])
    assert delta == {"failed": 2, "step_failures": 2, "step_retries": 1,
                     "retries.serving.decode": 1, "admitted": 3}
    assert free == [0, 1]


def _capacity_then_decode(api, eng):
    a = eng.add_request(list(range(10)), max_new_tokens=20)
    b = eng.add_request(list(range(3)), max_new_tokens=12)
    eng.run()
    return _outcome([a, b])


def test_slot_retired_at_capacity_leaves_decode_in_bounds(reng):
    """A contiguous slot that retires at ``max_seq`` must not make the
    next decode write past its stripe (every decode writes a token for
    every slot at its length, idle slots too)."""
    res = _both(_capacity_then_decode, reng)
    assert res["port"] == res["jax"]
    assert [(s, len(o)) for s, o, *_ in res["port"]] == [("finished", 7),
                                                          ("finished", 12)]


# -- retries on the paged pair, within the port ------------------------------

@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("when", ["before", "after"])
def test_retry_keeps_seeded_streams(peng, kind, when):
    """A failed call of either program, retried, leaves every seeded
    stream (greedy, temperature, top-k, top-p) as an unfaulted run gives
    it: a decode retry restores the lengths, tokens and draw counters
    the failed replay moved; a prefill retry re-stages the slot."""
    eng = peng["port"]
    rs = np.random.RandomState(21)
    SP = PORT.SamplingParams
    laws = [SP(), SP(temperature=0.9, seed=3), SP(temperature=1.0, top_k=7,
                                                  seed=4),
            SP(temperature=0.7, top_p=0.8, seed=5)]
    prompts = [rs.randint(0, 128, (L,)).tolist() for L in (5, 17, 9, 3)]

    def serve():
        reqs = [eng.add_request(p, max_new_tokens=6, sampling=s)
                for p, s in zip(prompts, laws)]
        eng.run()
        return [(r.state, r.output_ids) for r in reqs]

    ref = serve()
    before = _counters(eng)
    flaky = Flaky(eng, kind, [2], when)
    try:
        got = serve()
    finally:
        flaky.remove()
    assert got == ref and all(s == "finished" for s, _ in got)
    assert _delta(eng, before) == {"step_failures": 1, "step_retries": 1,
                                   f"retries.serving.{kind}": 1,
                                   "admitted": 4}
    assert eng.health()["kv_block_invariants"] == "ok"
    assert eng.stats()["compile_cache"]["after_warmup"] == 0
