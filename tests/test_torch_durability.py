"""The port's durability (request journal, crash recovery, weight hot swap,
drain and shutdown) against the JAX package.

The cases of ``tests/test_durability.py`` and the lifecycle cases of
``tests/test_serving.py`` run on both packages with the same arguments:

- the journal mechanics (round trip, torn records, segments and
  compaction) on each package's ``RequestJournal``; the two write the
  same records (apart from wall stamps), and each reads the other's;
- the prefix cache's version epoch on each package's ``PrefixCache``;
- recovery, hot swap, drain and shutdown on one ``gpt_tiny`` (built in
  the JAX package from a seed, its weights carried into the port), in
  both KV layouts on the port's side: greedy streams, journal ids,
  ``recovered`` flags, outcomes, banked counters, the ``"durability"``
  block, states and errors must be identical.  A sampled stream is
  compared within the port (its noise is a counter hash, not
  ``jax.random``): a recovered stream must equal the same request served
  uninterrupted.  Each JAX scenario runs once (the JAX engines compile)
  and both port layouts are held to it;
- a journal written by one package's engine and abandoned mid-decode is
  recovered by the other's, with the writer's own greedy streams;
- the SIGKILL drill in child processes that import the port only.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as jax_serving
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import gpt as jax_gpt
import paddle_tpu_torch.serving as port_serving
from paddle_tpu_torch import obs as port_obs
from paddle_tpu_torch.models import (
    GPTForCausalLM, from_jax_state_dict, gpt_tiny, port_state_dict_from_jax,
)
from paddle_tpu_torch.obs import crashdump as port_crashdump
from paddle_tpu_torch.obs.flight import FlightRecorder as PortFlightRecorder

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _api(name, mod):
    return SimpleNamespace(
        name=name, Engine=mod.Engine, SamplingParams=mod.SamplingParams,
        RequestJournal=mod.RequestJournal, JournalCorrupt=mod.JournalCorrupt,
        EngineStopped=mod.EngineStopped, ShedReject=mod.ShedReject,
        RequestTracer=mod.RequestTracer, BlockAllocator=mod.BlockAllocator,
        PrefixCache=mod.PrefixCache)


JAX = _api("jax", jax_serving)
PORT = _api("port", port_serving)
APIS = [JAX, PORT]
_ids = pytest.mark.parametrize("api", APIS, ids=lambda a: a.name)

#: the JAX case's geometry (``_mk_engine``), and the layouts
BASE = dict(num_slots=2, max_seq=32, min_bucket=8, name="e0")
LAYOUTS = {"contiguous": {}, "paged": dict(kv_layout="paged", block_size=8)}
_layouts = pytest.mark.parametrize("layout", list(LAYOUTS))


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
    """The JAX ``gpt_tiny`` from seed 0 and the port's on its weights."""
    paddle.seed(0)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny())
    jm.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(GPTForCausalLM(gpt_tiny(), device="cpu"), sd)
    return {"jax": jm, "port": tm.eval(), "state": sd}


@pytest.fixture(scope="module")
def new_weights(models):
    """A second weight set (seed 7): the JAX state dict, and the same
    weights as the port's ``update_weights`` payload."""
    paddle.seed(7)
    jsd = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny()).state_dict()
    np_sd = {k: np.asarray(v.numpy()) for k, v in jsd.items()}
    return {"jax": jsd,
            "port": port_state_dict_from_jax(models["port"], np_sd)}


def _mk_engine(api, model, journal=None, layout="contiguous", **kw):
    return api.Engine(model, journal=journal,
                      **{**BASE, **LAYOUTS[layout], **kw})


_JAX_RUNS = {}


def _jax_once(key, run):
    """A JAX scenario's result, run once per test process (its engines
    compile) and shared by every port case held to it."""
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = run()
    return _JAX_RUNS[key]


def _admit_args(jid, **over):
    base = dict(prompt_ids=[1, 2, 3],
                sampling={"temperature": 0.0, "top_k": 0, "top_p": 1.0,
                          "seed": None},
                seed_effective=7919, priority=1, deadline_s=None,
                max_new_tokens=4, eos_token_id=None, engine="e0",
                model_version=0)
    base.update(over)
    return jid, base


def _records(path):
    """Every record of a journal directory, in segment order, without
    wall stamps."""
    out = []
    for f in sorted(os.listdir(path)):
        if not f.endswith(".jrnl"):
            continue
        with open(os.path.join(path, f), "rb") as fh:
            for line in fh.read().splitlines():
                rec = json.loads(line[9:])
                rec.pop("wall", None)
                out.append(rec)
    return out


def _no_path(d):
    return {k: ({kk: vv for kk, vv in v.items() if kk != "path"}
                if k == "journal" else v) for k, v in d.items()}


# ---------------------------------------------------------------------------
# journal mechanics (host only), on each package's journal
# ---------------------------------------------------------------------------

@_ids
class TestJournalRoundTrip:
    def test_records_survive_reopen(self, api, tmp_path):
        j = api.RequestJournal(str(tmp_path))
        jid, kwargs = _admit_args("e0:b1:r0")
        j.record_admission(jid, **kwargs)
        j.record_tokens("e0", 1, {jid: 5})
        j.record_tokens("e0", 2, {jid: 9})
        jid2, kwargs2 = _admit_args("e0:b1:r1", prompt_ids=[4, 5])
        j.record_admission(jid2, **kwargs2)
        j.record_end(jid, "finished", n_tokens=2, engine="e0")
        j.close()

        j2 = api.RequestJournal(str(tmp_path))
        assert list(j2.pending().keys()) == [jid2]
        assert j2.pending()[jid2]["prompt_ids"] == [4, 5]
        assert j2.outputs(jid) == [5, 9]
        assert j2.outcomes() == {"finished": 1}
        a = j2.audit()
        assert a["admitted"] == 2 and a["finals"] == 1
        assert a["duplicate_terminals"] == 0 and a["torn_records"] == 0
        assert j2.boot > j.boot

    def test_restart_supersedes_tokens(self, api, tmp_path):
        j = api.RequestJournal(str(tmp_path))
        jid, kwargs = _admit_args("e0:b1:r0")
        j.record_admission(jid, **kwargs)
        j.record_tokens("e0", 1, {jid: 5})
        j.record_restart(jid, "preempt")
        j.record_tokens("e0", 9, {jid: 8})
        assert j.outputs(jid) == [8]

    def test_duplicate_final_is_audited(self, api, tmp_path):
        j = api.RequestJournal(str(tmp_path))
        jid, kwargs = _admit_args("e0:b1:r0")
        j.record_admission(jid, **kwargs)
        j.record_end(jid, "finished")
        j.record_end(jid, "finished")
        assert j.audit()["duplicate_terminals"] == 1

    def test_bad_config_rejected(self, api, tmp_path):
        with pytest.raises(ValueError):
            api.RequestJournal(str(tmp_path), fsync="sometimes")
        with pytest.raises(ValueError):
            api.RequestJournal(str(tmp_path), segment_records=0)


@_ids
class TestTornRecordRecovery:
    def _seg_paths(self, tmp_path):
        return sorted(p for p in os.listdir(tmp_path)
                      if p.endswith(".jrnl"))

    def test_torn_final_record_truncated(self, api, tmp_path):
        j = api.RequestJournal(str(tmp_path))
        jid, kwargs = _admit_args("e0:b1:r0")
        j.record_admission(jid, **kwargs)
        j.record_end(jid, "finished")
        jid2, kwargs2 = _admit_args("e0:b1:r1")
        j.record_admission(jid2, **kwargs2)
        j.close()
        seg = os.path.join(tmp_path, self._seg_paths(tmp_path)[-1])
        with open(seg, "ab") as f:        # a crash mid-append: no newline
            f.write(b'0badc0de {"kind":"end","jid":"e0:b1:r1","fin')
        j2 = api.RequestJournal(str(tmp_path))
        assert j2.torn_records == 1
        assert list(j2.pending().keys()) == [jid2]
        assert j2.audit()["duplicate_terminals"] == 0

    def test_torn_crc_with_newline_truncated(self, api, tmp_path):
        j = api.RequestJournal(str(tmp_path))
        jid, kwargs = _admit_args("e0:b1:r0")
        j.record_admission(jid, **kwargs)
        j.close()
        seg = os.path.join(tmp_path, self._seg_paths(tmp_path)[-1])
        with open(seg, "ab") as f:
            f.write(b'deadbeef {"kind":"end","jid":"e0:b1:r0"}\n')
        j2 = api.RequestJournal(str(tmp_path))
        assert j2.torn_records == 1
        assert list(j2.pending().keys()) == [jid]

    def test_torn_tail_truncated_on_disk_double_reopen(self, api, tmp_path):
        """The tear is cut from the file at the first reopen: once a
        fresh segment is open the torn one is no longer last, and a tear
        left in it would read as interior corruption at the next reopen."""
        j = api.RequestJournal(str(tmp_path))
        jid, kwargs = _admit_args("e0:b1:r0")
        j.record_admission(jid, **kwargs)
        j.close()
        seg = os.path.join(tmp_path, self._seg_paths(tmp_path)[-1])
        with open(seg, "ab") as f:
            f.write(b'0badc0de {"kind":"end","jid":"e0:b1:r0"')
        j2 = api.RequestJournal(str(tmp_path))
        assert j2.torn_records == 1
        j2.record_tokens("e0", 1, {jid: 5})
        j2.close()
        j3 = api.RequestJournal(str(tmp_path))
        assert j3.torn_records == 0
        assert list(j3.pending().keys()) == [jid]
        assert j3.outputs(jid) == [5]

    def test_interior_corruption_refused(self, api, tmp_path):
        j = api.RequestJournal(str(tmp_path))
        for i in range(3):
            jid, kwargs = _admit_args(f"e0:b1:r{i}")
            j.record_admission(jid, **kwargs)
        j.close()
        seg = os.path.join(tmp_path, self._seg_paths(tmp_path)[-1])
        with open(seg, "rb") as f:
            lines = f.read().splitlines(keepends=True)
        lines[1] = b'00000000 {"kind":"zap"}\n'
        with open(seg, "wb") as f:
            f.writelines(lines)
        with pytest.raises(api.JournalCorrupt):
            api.RequestJournal(str(tmp_path))


@_ids
class TestSegmentsAndCompaction:
    def test_rotation_compacts_fully_terminal_prefix(self, api, tmp_path):
        j = api.RequestJournal(str(tmp_path), segment_records=4)
        for i in range(2):
            jid, kwargs = _admit_args(f"e0:b1:r{i}")
            j.record_admission(jid, **kwargs)
            j.record_end(jid, "finished")
        jid2, kwargs2 = _admit_args("e0:b1:r2")
        j.record_admission(jid2, **kwargs2)
        for step in range(12):
            j.record_tokens("e0", step, {jid2: step})
        assert j.compacted_segments >= 1
        j.close()
        j2 = api.RequestJournal(str(tmp_path))
        assert list(j2.pending().keys()) == [jid2]
        assert j2.outputs(jid2) == list(range(12))
        assert j2.outcomes() == {"finished": 2}
        a = j2.audit()
        assert a["admitted"] == 3 and a["finals"] == 2

    def test_straddling_request_compacts_with_its_whole_prefix(
            self, api, tmp_path):
        j = api.RequestJournal(str(tmp_path), segment_records=2)
        jid, kwargs = _admit_args("e0:b1:r0")
        j.record_admission(jid, **kwargs)
        j.record_tokens("e0", 0, {jid: 1})
        j.record_tokens("e0", 1, {jid: 2})
        j.record_end(jid, "finished")
        assert j.compacted_segments == 2
        jid2, kwargs2 = _admit_args("e0:b1:r1")
        j.record_admission(jid2, **kwargs2)
        assert jid2 in j._admissions and jid not in j._admissions
        a = j.audit()
        assert a["admitted"] == 2 and a["finals"] == 1
        assert a["duplicate_terminals"] == 0
        j.close()
        j2 = api.RequestJournal(str(tmp_path))
        assert list(j2.pending().keys()) == [jid2]

    def test_pending_request_blocks_compaction(self, api, tmp_path):
        j = api.RequestJournal(str(tmp_path), segment_records=2)
        jid, kwargs = _admit_args("e0:b1:r0")
        j.record_admission(jid, **kwargs)
        for step in range(8):
            j.record_tokens("e0", step, {jid: step})
        assert j.compacted_segments == 0
        assert api.RequestJournal(str(tmp_path)).outputs(jid) == \
            list(range(8))


def _write_mixed(j):
    """One journal's worth of every record kind, rotating and compacting
    (segments of 3 records), with a request left pending."""
    for i in range(3):
        jid, kwargs = _admit_args(f"e0:b{j.boot}:r{i}",
                                  prompt_ids=[i + 1, 7, 9],
                                  priority=i, deadline_s=1.5 * i or None)
        j.record_admission(jid, **kwargs)
    j.record_tokens("e0", 0, {f"e0:b{j.boot}:r0": 4,
                              f"e0:b{j.boot}:r1": 5})
    j.record_restart(f"e0:b{j.boot}:r1", "preempt")
    j.record_end(f"e0:b{j.boot}:r0", "finished", n_tokens=1, engine="e0")
    j.record_weight_swap("e0", 1)
    j.record_tokens("e0", 1, {f"e0:b{j.boot}:r1": 6})
    j.record_end(f"e0:b{j.boot}:r1", "failed", error="boom", engine="e0")
    j.record_mesh_reshard("e0", "model=2", None,
                          {f"e0:b{j.boot}:r2": "replayed"})
    j.record_tokens("e0", 2, {f"e0:b{j.boot}:r2": [3, 8]})


def test_both_journals_write_the_same_records(tmp_path):
    """The same calls give the same records in the same segments, apart
    from wall stamps: the on-disk format is shared."""
    out = {}
    for api in APIS:
        path = str(tmp_path / api.name)
        j = api.RequestJournal(path, segment_records=3)
        _write_mixed(j)
        j.close()
        out[api.name] = (sorted(os.listdir(path)), _records(path))
    assert out["jax"] == out["port"]
    assert out["port"][1]                # the run wrote something


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_read_by_port", "port_read_by_jax"])
def test_each_reads_the_others_journal(writer, reader, tmp_path):
    """A journal one package wrote (rotated, compacted, torn at its tail)
    reads the same through the other's reader: pending requests, their
    token trails, outcomes and the audit."""
    src = str(tmp_path / "src")
    j = writer.RequestJournal(src, segment_records=3)
    _write_mixed(j)
    j.close()
    last = sorted(p for p in os.listdir(src) if p.endswith(".jrnl"))[-1]
    with open(os.path.join(src, last), "ab") as f:
        f.write(b'0badc0de {"kind":"end"')
    views = {}
    for api in (writer, reader):
        path = str(tmp_path / api.name)
        shutil.copytree(src, path)
        r = api.RequestJournal(path)
        views[api.name] = {
            "pending": dict(r.pending()),
            "outputs": {jid: r.outputs(jid) for jid in r.pending()},
            "outcomes": r.outcomes(), "audit": r.audit(), "boot": r.boot}
        r.close()
    assert views[writer.name] == views[reader.name]
    assert views[reader.name]["audit"]["torn_records"] == 1
    assert list(views[reader.name]["pending"]) == ["e0:b1:r2"]


# ---------------------------------------------------------------------------
# the prefix cache's version epoch
# ---------------------------------------------------------------------------

@_ids
class TestPrefixEpoch:
    def test_cross_epoch_blocks_never_hit(self, api):
        alloc = api.BlockAllocator(num_blocks=16)
        pc = api.PrefixCache(alloc, block_size=4)
        prompt = list(range(12))
        blocks = alloc.alloc(2)
        pc.register(prompt, blocks)
        hit, ids = pc.lookup(prompt)
        assert hit == 8 and ids == blocks
        epoch = pc.bump_epoch()
        assert epoch == 1
        assert pc.lookup(prompt) == (0, [])
        assert len(pc) == 0
        blocks2 = alloc.alloc(2)
        pc.register(prompt, blocks2)
        assert pc.lookup(prompt)[0] == 8
        assert pc.stats()["epoch"] == 1

    def test_pinned_entries_survive_bump_unhittable(self, api):
        alloc = api.BlockAllocator(num_blocks=16)
        pc = api.PrefixCache(alloc, block_size=4)
        prompt = list(range(8))
        blocks = alloc.alloc(1)
        pc.register(prompt, blocks)
        alloc.ref(blocks[0])              # a live slot still holds it
        pc.bump_epoch()
        assert pc.lookup(prompt) == (0, [])
        assert alloc.refcount(blocks[0]) >= 1


# ---------------------------------------------------------------------------
# in-process crash recovery, on both engines
# ---------------------------------------------------------------------------

def _recover_bitwise(api, model, root, layout):
    """test_abandon_and_recover_bitwise: three requests (greedy, seeded,
    unseeded sampled) abandoned mid-decode, recovered by a fresh engine
    and held to the same requests served uninterrupted on it."""
    j = api.RequestJournal(str(root))
    eng = _mk_engine(api, model, journal=j, layout=layout)
    eng.warmup()
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 128, (L,)).tolist() for L in (5, 9, 12)]
    first = [
        eng.add_request(prompts[0], max_new_tokens=6),
        eng.add_request(prompts[1], max_new_tokens=6,
                        sampling=api.SamplingParams(temperature=0.8, top_k=8,
                                                    seed=123)),
        eng.add_request(prompts[2], max_new_tokens=6,
                        sampling=api.SamplingParams(temperature=0.8))]
    for _ in range(3):                    # mid-decode "crash": abandon
        eng.step()
    assert any(r.output_ids for r in first)

    j2 = api.RequestJournal(str(root))
    pending = list(j2.pending())
    tracer = api.RequestTracer()
    eng2 = _mk_engine(api, model, journal=j2, layout=layout, tracer=tracer)
    eng2.warmup()
    misses0 = eng2.metrics.compile_misses
    info = eng2.recover()
    eng2.run()
    rec = info["requests"]
    res = {"pending": pending, "replayed": info["replayed"],
           "jids": [r.journal_id for r in rec],
           "recovered": [r.recovered for r in rec],
           "states": [r.state for r in rec],
           "steady_misses": eng2.metrics.compile_misses - misses0,
           "audit": j2.audit(),
           "durability": _no_path(eng2.stats()["durability"]),
           "greedy": rec[0].output_ids,
           "unseeded_seed": rec[2].sampling.seed,
           "trail": [j2.outputs(r.journal_id) == r.output_ids
                     for r in rec]}
    ref = [
        eng2.add_request(prompts[0], max_new_tokens=6),
        eng2.add_request(prompts[1], max_new_tokens=6,
                         sampling=api.SamplingParams(temperature=0.8,
                                                     top_k=8, seed=123)),
        eng2.add_request(prompts[2], max_new_tokens=6,
                         sampling=api.SamplingParams(
                             temperature=0.8, seed=rec[2].sampling.seed))]
    eng2.run()
    res["bitwise"] = [r.output_ids for r in ref] == \
        [r.output_ids for r in rec]
    res["sampled"] = [r.output_ids for r in rec[1:]]
    return res, tracer


@_layouts
def test_abandon_and_recover_bitwise(models, tmp_path, layout):
    want, _ = _jax_once("recover_bitwise", lambda: _recover_bitwise(
        JAX, models["jax"], tmp_path / "jax", "contiguous"))
    got, tracer = _recover_bitwise(PORT, models["port"], tmp_path / "port",
                                   layout)
    assert got["replayed"] == 3 and all(got["recovered"])
    assert got["jids"] == got["pending"]
    assert got["states"] == ["finished"] * 3
    assert got["steady_misses"] == 0
    assert got["audit"]["pending"] == 0
    assert got["audit"]["duplicate_terminals"] == 0
    assert got["bitwise"] and want["bitwise"]
    assert all(got["trail"])
    # what a caller sees is the JAX engine's, the sampled streams aside
    same = ("pending", "replayed", "jids", "recovered", "states",
            "steady_misses", "audit", "durability", "greedy",
            "unseeded_seed", "trail")
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    # the tracer: a valid chain, the recovered events with their
    # pre-crash wall stamp, and the Perfetto flow from before the crash
    assert port_serving.validate_trace(tracer) == []
    recov = [e for e in tracer.events if e["kind"] == "recovered"]
    assert len(recov) == 3 and all(e.get("origin_wall") for e in recov)
    ct = port_obs.chrome_trace(tracer)
    assert "pre_crash_admission" in [e.get("name")
                                     for e in ct["traceEvents"]]
    flows = [e for e in ct["traceEvents"]
             if e.get("cat") == "link" and e.get("name") == "recovered"]
    assert {e["ph"] for e in flows} >= {"s", "f"}


def _banked_monotone(api, model, root, layout):
    j = api.RequestJournal(str(root))
    eng = _mk_engine(api, model, journal=j, layout=layout)
    eng.warmup()
    eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=3)
    completed0 = eng.metrics.requests_completed
    eng.add_request([7, 8, 9], max_new_tokens=4)
    eng.step()                            # in flight at the "crash"
    j2 = api.RequestJournal(str(root))
    eng2 = _mk_engine(api, model, journal=j2, layout=layout)
    eng2.warmup()
    info = eng2.recover()
    st = eng2.stats()
    eng2.run()
    return {"completed_before": completed0, "outcomes": info["outcomes"],
            "completed": st["requests"]["completed"],
            "durability": _no_path(st["durability"]),
            "completed_after": eng2.stats()["requests"]["completed"],
            "output": info["requests"][0].output_ids}


@_layouts
def test_metrics_banked_monotone(models, tmp_path, layout):
    want = _jax_once("banked", lambda: _banked_monotone(
        JAX, models["jax"], tmp_path / "jax", "contiguous"))
    got = _banked_monotone(PORT, models["port"], tmp_path / "port", layout)
    assert got["outcomes"] == {"finished": 2}
    assert got["completed"] == 2 and got["completed_after"] == 3
    assert got["durability"]["banked"] == {"finished": 2}
    assert got["durability"]["recovered"] == 1
    assert got == want


def _never_shed(api, model, root, layout):
    j = api.RequestJournal(str(root))
    eng = _mk_engine(api, model, journal=j, layout=layout)
    eng.warmup()
    for i in range(4):
        eng.add_request([1 + i, 2, 3], max_new_tokens=6, deadline_s=30.0)
    eng.step()                            # in flight at the "crash"
    j2 = api.RequestJournal(str(root))
    eng2 = _mk_engine(api, model, journal=j2, layout=layout)
    eng2.warmup()
    # the estimator says every deadline is doomed: fresh traffic sheds,
    # recovered replays must not
    eng2.estimate_queue_wait_s = lambda priority=1: 1e6
    try:
        with pytest.raises(api.ShedReject):
            eng2.add_request([7, 7, 7], max_new_tokens=4, deadline_s=30.0)
        info = eng2.recover()
    finally:
        del eng2.estimate_queue_wait_s
    eng2.run()
    return {"replayed": info["replayed"],
            "states": [r.state for r in info["requests"]],
            "outputs": [r.output_ids for r in info["requests"]],
            "audit": j2.audit()}


@_layouts
def test_recovered_replays_are_never_shed(models, tmp_path, layout):
    want = _jax_once("never_shed", lambda: _never_shed(
        JAX, models["jax"], tmp_path / "jax", "contiguous"))
    got = _never_shed(PORT, models["port"], tmp_path / "port", layout)
    assert got["replayed"] == 4
    assert got["states"] == ["finished"] * 4
    assert got["audit"]["duplicate_terminals"] == 0
    assert got == want


def _invalid_replay(api, model, root, layout):
    j = api.RequestJournal(str(root))
    eng = _mk_engine(api, model, journal=j, layout=layout, max_seq=64)
    eng.warmup()
    eng.add_request(list(range(40)), max_new_tokens=4)
    eng.add_request([1, 2, 3], max_new_tokens=4)
    eng.step()                            # both in flight at the "crash"
    j2 = api.RequestJournal(str(root))
    eng2 = _mk_engine(api, model, journal=j2, layout=layout, max_seq=32)
    eng2.warmup()
    info = eng2.recover()
    eng2.run()
    return {"replayed": info["replayed"], "invalid": len(info["invalid"]),
            "audit": j2.audit(), "state": info["requests"][0].state,
            "output": info["requests"][0].output_ids,
            "again": eng2.recover()["replayed"]}


@_layouts
def test_invalid_replay_isolated_not_wedging(models, tmp_path, layout):
    want = _jax_once("invalid", lambda: _invalid_replay(
        JAX, models["jax"], tmp_path / "jax", "contiguous"))
    got = _invalid_replay(PORT, models["port"], tmp_path / "port", layout)
    assert got["replayed"] == 1 and got["invalid"] == 1
    assert got["audit"]["pending"] == 0
    assert got["audit"]["duplicate_terminals"] == 0
    assert got["state"] == "finished" and got["again"] == 0
    assert got == want


def _requires_idle(api, model, root, layout):
    j = api.RequestJournal(str(root))
    eng = _mk_engine(api, model, journal=j, layout=layout)
    eng.warmup()
    eng.add_request([1, 2], max_new_tokens=2)
    out = []
    with pytest.raises(RuntimeError, match="before serving") as e1:
        eng.recover()
    with pytest.raises(ValueError, match="RequestJournal") as e2:
        _mk_engine(api, model, layout=layout).recover()
    for e in (e1, e2):
        out.append((e.type.__name__, str(e.value)))
    return out


@_layouts
def test_recover_requires_idle_engine(models, tmp_path, layout):
    want = _jax_once("requires_idle", lambda: _requires_idle(
        JAX, models["jax"], tmp_path / "jax", "contiguous"))
    assert _requires_idle(PORT, models["port"], tmp_path / "port",
                          layout) == want


def _mismatch(api, model, root, layout):
    ja = api.RequestJournal(str(root / "a"))
    jb = api.RequestJournal(str(root / "b"))
    eng = _mk_engine(api, model, journal=ja, layout=layout)
    with pytest.raises(ValueError, match="does not match") as e:
        eng.recover(jb)
    return e.type.__name__


@_layouts
def test_recover_journal_mismatch_refused(models, tmp_path, layout):
    want = _jax_once("mismatch", lambda: _mismatch(
        JAX, models["jax"], tmp_path / "jax", "contiguous"))
    assert _mismatch(PORT, models["port"], tmp_path / "port",
                     layout) == want


def _write_failure(api, model, root, layout):
    j = api.RequestJournal(str(root))
    eng = _mk_engine(api, model, journal=j, layout=layout)
    j._seg.close()                        # the storage fails
    with pytest.raises(ValueError) as ei:
        eng.add_request([1, 2, 3], max_new_tokens=2)
    req = ei.value.request
    return {"queued": len(eng.queue), "state": req.state,
            "error": req.error, "journal_id": req.journal_id,
            "rejected": eng.metrics.requests_rejected}


@_layouts
def test_journal_write_failure_rejects_cleanly(models, tmp_path, layout):
    want = _jax_once("write_failure", lambda: _write_failure(
        JAX, models["jax"], tmp_path / "jax", "contiguous"))
    got = _write_failure(PORT, models["port"], tmp_path / "port", layout)
    assert got["queued"] == 0 and got["state"] == "rejected"
    assert got["error"].startswith("journal admission write failed")
    assert got["journal_id"] is None
    assert got == want


def _foreign_replays(api, model, root, cross_mesh):
    """A journal holding a request admitted at another mesh shape, one
    with an adapter, and a plain one, recovered by an unsharded engine
    without adapters."""
    j = api.RequestJournal(str(root))
    jid, kw = _admit_args("e9:b1:r0", prompt_ids=[5, 6, 7])
    j.record_admission(jid, **kw, mesh_shape="model=2")
    jid, kw = _admit_args("e9:b1:r1", prompt_ids=[8, 9])
    kw["sampling"] = dict(kw["sampling"], adapter="tenant-a")
    j.record_admission(jid, **kw, adapter_version=1)
    jid, kw = _admit_args("e9:b1:r2", prompt_ids=[1, 2, 3, 4])
    j.record_admission(jid, **kw)
    j.close()
    j2 = api.RequestJournal(str(root))
    eng = _mk_engine(api, model, journal=j2)
    eng.warmup()
    info = eng.recover(cross_mesh=cross_mesh)
    eng.run()
    a = j2.audit()
    return {"replayed": [r.journal_id for r in info["requests"]],
            "invalid": sorted(str(getattr(x, "journal_id", x))
                              for x in info["invalid"]),
            "cross_mesh": info["cross_mesh"],
            "outputs": [r.output_ids for r in info["requests"]],
            "mesh_reshards": a["mesh_reshards"], "pending": a["pending"],
            "outcomes": j2.outcomes()}


@pytest.mark.parametrize("cross_mesh", [True, False])
def test_cross_mesh_and_tenant_replays(models, tmp_path, cross_mesh):
    """A request journaled at another mesh shape replays under
    ``cross_mesh`` (a ``mesh_reshard`` record keeps the audit whole) and
    fails finally without it; a journaled adapter cannot replay on an
    engine without an adapter pool, nor a journaled grammar on one
    without a grammar table.  Both packages dispose of every request
    alike."""
    want = _jax_once(f"foreign-{cross_mesh}", lambda: _foreign_replays(
        JAX, models["jax"], tmp_path / "jax", cross_mesh))
    got = _foreign_replays(PORT, models["port"], tmp_path / "port",
                           cross_mesh)
    assert got["pending"] == 0 and "e9:b1:r1" in got["invalid"]
    if cross_mesh:
        assert got["replayed"] == ["e9:b1:r0", "e9:b1:r2"]
        assert got["cross_mesh"] == 1 and got["mesh_reshards"] == 1
    else:
        assert got["replayed"] == ["e9:b1:r2"]
        assert got["invalid"] == ["e9:b1:r0", "e9:b1:r1"]
    assert got == want
    with pytest.raises(ValueError, match="no grammar table"):
        _mk_engine(PORT, models["port"])._validate_replay_tenancy(
            {}, {"grammar": "json"})


def _greedy_recovery(api, model, jdir, layout="contiguous"):
    """Recover the journal at ``jdir`` on a fresh engine and serve it:
    the journal ids and output streams."""
    j = api.RequestJournal(str(jdir))
    eng = _mk_engine(api, model, journal=j, layout=layout)
    eng.warmup()
    info = eng.recover()
    eng.run()
    a = j.audit()
    return {"jids": [r.journal_id for r in info["requests"]],
            "recovered": [r.recovered for r in info["requests"]],
            "outputs": [r.output_ids for r in info["requests"]],
            "pending": a["pending"], "duplicates": a["duplicate_terminals"]}


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_journal_recovered_across_packages(models, tmp_path, writer,
                                           reader):
    """A journal the writer's engine left mid-decode (greedy requests)
    recovers on the other package's engine with the streams of the
    writer's own recovery."""
    jdir = tmp_path / "journal"
    eng = _mk_engine(writer, models[writer.name],
                     journal=writer.RequestJournal(str(jdir)))
    eng.warmup()
    rs = np.random.RandomState(8)
    for L in (4, 10, 13):
        eng.add_request(rs.randint(0, 128, (L,)).tolist(), max_new_tokens=7)
    for _ in range(3):
        eng.step()                        # abandoned mid-decode
    shutil.copytree(jdir, tmp_path / "copy")
    own = _greedy_recovery(writer, models[writer.name], jdir)
    other = _greedy_recovery(reader, models[reader.name], tmp_path / "copy")
    assert own["jids"] == ["e0:b1:r0", "e0:b1:r1", "e0:b1:r2"]
    assert all(other["recovered"]) and other["pending"] == 0
    assert other["duplicates"] == 0
    assert other == own


# ---------------------------------------------------------------------------
# hot swap, on both engines
# ---------------------------------------------------------------------------

def _idle_refusal(api, model, weights):
    eng = _mk_engine(api, model)
    eng.warmup()
    eng.add_request([1, 2, 3], max_new_tokens=4)
    with pytest.raises(RuntimeError, match="drain") as e:
        eng.update_weights(weights)
    return e.type.__name__


def test_update_requires_idle(models, new_weights):
    want = _jax_once("update_idle", lambda: _idle_refusal(
        JAX, models["jax"], new_weights["jax"]))
    assert _idle_refusal(PORT, models["port"], new_weights["port"]) == want


def _own_copy(api, models):
    """A private copy of the shared model, for a case that writes its
    weights."""
    if api is JAX:
        paddle.seed(0)
        own = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny())
        own.set_state_dict(models["jax"].state_dict())
        own.eval()
        return own
    return from_jax_state_dict(GPTForCausalLM(gpt_tiny(), device="cpu"),
                               models["state"]).eval()


def _partial_refusal(api, model, weights):
    eng = _mk_engine(api, model)
    partial = dict(list(weights.items())[:3])
    with pytest.raises(ValueError, match="does not cover") as e:
        eng.update_weights(partial)
    return e.type.__name__


def test_partial_state_dict_refused(models, new_weights):
    """Refused by both.  The JAX engine writes the covered names before it
    raises (its private copy here); the port checks every name and shape
    before its first write, so the model is untouched."""
    want = _jax_once("update_partial", lambda: _partial_refusal(
        JAX, _own_copy(JAX, models), new_weights["jax"]))
    own = _own_copy(PORT, models)
    before = {k: v.clone() for k, v in own.state_dict().items()}
    assert _partial_refusal(PORT, own, new_weights["port"]) == want
    assert all(torch.equal(before[k], v)
               for k, v in own.state_dict().items())


def test_shape_mismatch_and_checkpoint_directory_refused(models,
                                                         new_weights,
                                                         tmp_path):
    """The port's own refusals: a wrong shape (before anything is
    written) and a ``distributed.checkpoint`` directory (not ported)."""
    own = _own_copy(PORT, models)
    eng = _mk_engine(PORT, own)
    bad = dict(new_weights["port"])
    name = next(iter(bad))
    bad[name] = bad[name][:-1]
    before = {k: v.clone() for k, v in own.state_dict().items()}
    with pytest.raises(ValueError, match="shape"):
        eng.update_weights(bad)
    assert all(torch.equal(before[k], v)
               for k, v in own.state_dict().items())
    with pytest.raises(NotImplementedError, match="A.5"):
        eng.update_weights(str(tmp_path))
    path = str(tmp_path / "w.npz")
    np.savez(path, **{k: v.numpy() for k, v in new_weights["port"].items()})
    assert eng.update_weights(path) == 1
    assert eng.model_version == 1


def test_swap_raises_if_a_parameter_moved(models, new_weights):
    """A swap whose target tensors are not the ones the programs captured
    (here ``state_dict`` hands out copies after the check) raises:
    graphs would go on reading the old addresses."""
    own = _own_copy(PORT, models)
    eng = _mk_engine(PORT, own)
    sd, calls = own.state_dict, [0]

    def moving(*args, **kwargs):
        calls[0] += 1
        out = sd(*args, **kwargs)
        return out if calls[0] == 1 else {k: v.clone()
                                          for k, v in out.items()}

    own.state_dict = moving
    with pytest.raises(RuntimeError, match="moved in memory"):
        eng.update_weights(new_weights["port"])


def _swap_in_place(api, own, weights, root, layout):
    """test_swap_in_place_zero_new_keys on a private copy of the model."""
    j = api.RequestJournal(str(root))
    eng = _mk_engine(api, own, journal=j, layout=layout)
    eng.warmup()
    prompt = list(range(20))
    t0 = eng.generate([prompt], max_new_tokens=5)[0]
    r2 = eng.add_request(prompt, max_new_tokens=5)
    eng.run()
    pc = eng.prefix_cache
    hit_before = pc.hit_tokens_total if pc is not None else None
    misses = eng.metrics.compile_misses
    v = eng.update_weights(weights)
    r3 = eng.add_request(prompt, max_new_tokens=5)
    eng.run()
    return {"t0": t0, "v0_version": r2.model_version,
            "hit_before": hit_before,
            "hit_after": pc.hit_tokens_total if pc is not None else None,
            "version": v, "engine_version": eng.model_version,
            "epoch": pc.epoch if pc is not None else None,
            "t1": r3.output_ids, "v1_version": r3.model_version,
            "new_misses": eng.metrics.compile_misses - misses,
            "durability": _no_path(eng.stats()["durability"])}


@_layouts
def test_swap_in_place_zero_new_keys(models, new_weights, tmp_path,
                                     layout):
    want = _jax_once("swap", lambda: _swap_in_place(
        JAX, _own_copy(JAX, models), new_weights["jax"], tmp_path / "jax",
        "paged"))
    own = _own_copy(PORT, models)
    ptrs = {k: p.data_ptr() for k, p in own.named_parameters()}
    got = _swap_in_place(PORT, own, new_weights["port"], tmp_path / "port",
                         layout)
    # written in place: the same tensors, now holding the new weights
    assert {k: p.data_ptr() for k, p in own.named_parameters()} == ptrs
    for k, p in own.named_parameters():
        assert torch.equal(p, new_weights["port"][k]), k
    assert got["version"] == got["engine_version"] == 1
    assert got["v0_version"] == 0 and got["v1_version"] == 1
    assert got["new_misses"] == 0
    assert got["t1"] != got["t0"]
    assert got["durability"]["weight_swaps"] == 1
    assert got["durability"]["journal"]["records_written"] > 0
    same = ("t0", "t1", "v0_version", "v1_version", "version",
            "engine_version", "new_misses", "durability")
    if layout == "paged":
        # the v1 admission cannot hit the v0 blocks
        assert got["epoch"] == 1 and got["hit_before"] > 0
        assert got["hit_after"] == got["hit_before"]
        same += ("epoch", "hit_before", "hit_after")
    assert {k: got[k] for k in same} == {k: want[k] for k in same}


# ---------------------------------------------------------------------------
# drain and shutdown (tests/test_serving.py lifecycle cases)
# ---------------------------------------------------------------------------

LIFECYCLE = dict(num_slots=2, max_seq=16, min_bucket=16)
LIFECYCLE_LAYOUTS = {"contiguous": {},
                     "paged": dict(kv_layout="paged", block_size=16)}


def _drain(api, model, layout):
    eng = api.Engine(model, **LIFECYCLE, **LIFECYCLE_LAYOUTS[layout])
    rs = np.random.RandomState(15)
    ps = [rs.randint(0, 128, (L,)).tolist() for L in (3, 7, 5)]
    reqs = [eng.add_request(p, max_new_tokens=3) for p in ps]
    st = eng.drain()
    out = {"finished": [r.finished for r in reqs],
           "outputs": [r.output_ids for r in reqs], "state": eng.state,
           "health_state": st["health"]["state"],
           "queue_depth": st["queue_depth"],
           "running": st["requests"]["running"]}
    with pytest.raises(api.EngineStopped):
        eng.add_request([1, 2])
    with pytest.raises(api.EngineStopped):
        eng.warmup()
    return out, ps


@pytest.mark.parametrize("layout", list(LIFECYCLE_LAYOUTS))
def test_drain_finishes_in_flight_then_stops(models, layout):
    want, _ = _jax_once("drain", lambda: _drain(JAX, models["jax"],
                                                "contiguous"))
    got, ps = _drain(PORT, models["port"], layout)
    assert all(got["finished"]) and got["state"] == "stopped"
    assert got["health_state"] == "stopped"
    # each stream is the model's own greedy chain (one causal forward)
    tm = models["port"]
    for p, out in zip(ps, got["outputs"]):
        with torch.no_grad():
            logits = tm(torch.tensor([p + out[:-1]])).numpy()[0]
        assert [int(np.argmax(logits[len(p) - 1 + i]))
                for i in range(len(out))] == out
    assert got == want


def _shutdown(api, model, layout):
    eng = api.Engine(model, **LIFECYCLE, **LIFECYCLE_LAYOUTS[layout])
    r1 = eng.add_request([1, 2], max_new_tokens=14)
    r2 = eng.add_request([3, 4], max_new_tokens=14)
    eng.step()                            # both admitted
    st = eng.shutdown(timeout_s=0.0)
    out = {"state": eng.state,
           "requests": [(r.state, r.error, r.error_kind) for r in (r1, r2)],
           "free_slots": sorted(eng.free_slots),
           "cancelled": st["failures"]["cancelled"],
           "health_state": st["health"]["state"]}
    with pytest.raises(api.EngineStopped):
        eng.add_request([5])
    return out, st


@pytest.mark.parametrize("layout", list(LIFECYCLE_LAYOUTS))
def test_shutdown_timeout_cancels_remaining(models, layout):
    want, _ = _jax_once("shutdown", lambda: _shutdown(JAX, models["jax"],
                                                      "contiguous"))
    got, st = _shutdown(PORT, models["port"], layout)
    assert got["state"] == "stopped"
    assert got["requests"] == [("cancelled", "engine shutdown",
                                "replica")] * 2
    assert got["free_slots"] == [0, 1] and got["cancelled"] >= 2
    if layout == "paged":
        assert st["health"]["kv_block_invariants"] == "ok"
        assert st["paging"]["blocks"]["used"] == 0
    assert got == want


def test_block_corruption_turns_engine_unhealthy(models):
    """A failing block release (an accounting fault) turns the engine
    unhealthy for good: the flight ring is dumped, the tracer told, and
    ``step`` and ``add_request`` raise ``EngineStopped``."""
    tracer = PORT.RequestTracer()
    eng = _mk_engine(PORT, models["port"], layout="paged", tracer=tracer)
    eng.warmup()
    r = eng.add_request([1, 2, 3], max_new_tokens=6)
    eng.step()

    def broken(slot):
        raise RuntimeError("refcount underflow")

    eng.cache.release_slot = broken
    r.cancel()
    eng._reap(0.0)
    del eng.cache.release_slot
    assert r.state == "cancelled"
    h = eng.health()
    assert h["state"] == "unhealthy" and "refcount underflow" in h["reason"]
    assert eng.flight.dumps[-1]["reason"] == h["reason"]
    assert [e["kind"] for e in tracer.events].count("unhealthy") == 1
    with pytest.raises(PORT.EngineStopped, match="unhealthy"):
        eng.step()
    with pytest.raises(PORT.EngineStopped):
        eng.add_request([1])


# ---------------------------------------------------------------------------
# crash artifacts, on the port's crashdump
# ---------------------------------------------------------------------------

class TestCrashDump:
    def test_persists_flight_and_trace(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_TRACE_DIR", str(tmp_path))
        rec = PortFlightRecorder(8, name="crash-unit")
        rec.record(step=1, running=2)
        tracer = PORT.RequestTracer()
        tracer.on_eject("r0", "unit")
        dumps_before = list(rec.dumps)
        p = port_obs.persist_crash_artifacts("unit-test crash")
        assert p is not None and os.path.exists(p)
        payload = json.load(open(p))
        assert payload["reason"] == "unit-test crash"
        ring = payload["flight_rings"]["crash-unit"][-1]
        assert ring["reason"] == "crash: unit-test crash"
        assert any(e.get("step") == 1 for e in ring["events"])
        # persisting is a read: no dump was banked on the live recorder
        assert rec.dumps == dumps_before
        assert any(ev["kind"] == "eject"
                   for tr in payload["traces"] for ev in tr["events"])

    def test_no_destination_is_noop(self, monkeypatch):
        monkeypatch.delenv("PADDLE_TPU_TRACE_DIR", raising=False)
        monkeypatch.setattr(port_crashdump, "_JOURNAL_DIRS", [])
        assert port_crashdump.persist_crash_artifacts("nowhere") is None

    def test_journal_dir_fallback(self, tmp_path, monkeypatch):
        monkeypatch.delenv("PADDLE_TPU_TRACE_DIR", raising=False)
        j = PORT.RequestJournal(str(tmp_path / "j"))
        p = port_crashdump.persist_crash_artifacts("fallback")
        assert p is not None
        assert os.path.dirname(p) == str(tmp_path / "j" / "crash")
        j.close()                        # a closed journal is forgotten
        assert port_crashdump.crash_dir() != str(tmp_path / "j" / "crash")


# ---------------------------------------------------------------------------
# SIGKILL drill: child processes that import the port only
# ---------------------------------------------------------------------------

_CHILD_MODEL = r"""
import json, os, signal, sys
import numpy as np
import torch
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.serving import Engine, RequestJournal, SamplingParams

torch.set_num_threads(2)
model = GPTForCausalLM(gpt_tiny(), device="cpu",
                       generator=torch.Generator().manual_seed(0)).eval()
"""

_CHILD_SERVE = _CHILD_MODEL + r"""
eng = Engine(model, num_slots=2, max_seq=32, min_bucket=8,
             journal=RequestJournal(sys.argv[1]))
eng.warmup()
rs = np.random.RandomState(5)
prompts = [rs.randint(0, 128, (L,)).tolist() for L in (6, 11, 14)]
reqs = [eng.add_request(prompts[0], max_new_tokens=8),
        eng.add_request(prompts[1], max_new_tokens=8,
                        sampling=SamplingParams(temperature=0.7, top_k=8,
                                                seed=99)),
        eng.add_request(prompts[2], max_new_tokens=8)]
steps = 0
while eng.step():
    steps += 1
    if steps == 3:                  # mid-decode, tokens already streamed
        print("KILLING", json.dumps({r.journal_id: r.output_ids
                                     for r in reqs}), flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
raise SystemExit("unreachable: the SIGKILL must land mid-drill")
"""

_CHILD_RECOVER = _CHILD_MODEL + r"""
j = RequestJournal(sys.argv[1])
pend = j.pending()
journaled = {jid: j.outputs(jid) for jid in pend}
eng = Engine(model, num_slots=2, max_seq=32, min_bucket=8, journal=j)
eng.warmup()
misses0 = eng.metrics.compile_misses
info = eng.recover()
eng.run()
rec = info["requests"]
refs = [eng.add_request(r["prompt_ids"], max_new_tokens=r["max_new_tokens"],
                        sampling=SamplingParams(**{
                            k: v for k, v in j.replay_sampling(r).items()
                            if k in ("temperature", "top_k", "top_p",
                                     "seed")}))
        for r in pend.values()]
eng.run()
a = j.audit()
print(json.dumps({
    "replayed": info["replayed"],
    "recovered_flags": [bool(r.recovered) for r in rec],
    "all_finished": all(r.state == "finished" for r in rec),
    "bitwise": [r.output_ids for r in rec] == [r.output_ids for r in refs],
    "journaled": journaled,
    "recovered_streams": {r.journal_id: r.output_ids for r in rec},
    "steady_misses": eng.metrics.compile_misses - misses0,
    "pending_after": a["pending"],
    "duplicate_terminals": a["duplicate_terminals"],
    "jax_imported": any(m == "jax" or m.startswith(("jax.", "paddle_tpu."))
                        or m == "paddle_tpu" for m in sys.modules),
}))
"""


class TestSigkillChaosDrill:
    def test_sigkill_mid_decode_recovery(self, tmp_path):
        jdir = str(tmp_path / "journal")
        r1 = subprocess.run([sys.executable, "-c", _CHILD_SERVE, jdir],
                            cwd=REPO, capture_output=True, text=True,
                            timeout=300)
        assert r1.returncode == -signal.SIGKILL, \
            (r1.returncode, r1.stdout[-2000:], r1.stderr[-2000:])
        assert "KILLING" in r1.stdout
        r2 = subprocess.run([sys.executable, "-c", _CHILD_RECOVER, jdir],
                            cwd=REPO, capture_output=True, text=True,
                            timeout=300)
        assert r2.returncode == 0, (r2.stdout[-2000:], r2.stderr[-2000:])
        out = json.loads(r2.stdout.strip().splitlines()[-1])
        # the journal held exactly what each client received before the
        # kill, and each replay begins with it
        sent = json.loads(r1.stdout.split("KILLING", 1)[1].splitlines()[0])
        assert sum(map(len, sent.values())) > 0
        assert out.pop("journaled") == sent
        streams = out.pop("recovered_streams")
        assert sorted(streams) == sorted(sent)
        assert all(streams[jid][:len(t)] == t for jid, t in sent.items())
        assert out == {"replayed": 3, "recovered_flags": [True] * 3,
                       "all_finished": True, "bitwise": True,
                       "steady_misses": 0, "pending_after": 0,
                       "duplicate_terminals": 0, "jax_imported": False}
