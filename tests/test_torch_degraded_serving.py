"""Degraded sharded serving of the port against the JAX package's, on
the CPU.

``tests/test_degraded_serving.py`` is the spec: every case has a
counterpart here.  As in ``tests/test_torch_sharded_serving.py`` (whose
world launcher this module uses), the JAX side runs in this process and
the port's side in one spawned gloo world of four processes, made once
for the module: ranks 0-1 and 2-3 each run the cross-mesh recovery
scenarios on their own ``model=2`` mesh (the two pairs must agree), then
the four ranks run a fleet of two shard groups that loses a rank
(``serving.r0.shard_fail``), and a one-group fleet that loses both.

The bar is the JAX tests': greedy and seeded streams equal across the
shape change, every request ending exactly once, the degraded counters
and the durable ``mesh_reshard`` record.
"""
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import GPTConfig, gpt_tiny
from paddle_tpu_torch.serving import degrade_step, viable_ladder

from test_torch_sharded_serving import (
    WORLD, _get, greedy_chain_ok, port_model, run_world, scenario,
)

ENGINE_KW = dict(num_slots=2, max_seq=16, min_bucket=16)
MAX_NEW = 6
_rs = np.random.RandomState(3)
PROMPTS = [_rs.randint(0, 128, (L,)).tolist() for L in (5, 9, 10)]
#: the seeded request's sampling (temperature 0.8, top-k 8, seed 123)
SEEDED = dict(temperature=0.8, top_k=8, seed=123)
#: the independent 1-layer 2-head draft of the JAX test
DRAFT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=1,
             num_attention_heads=2, max_position_embeddings=64,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


# -- the port's worker ---------------------------------------------------------

def _degraded_worker(rank: int, world: int, workdir: str) -> dict:
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.fault_tolerance import (
        ServingFaultPlan,
    )
    from paddle_tpu_torch.serving import (
        Engine, Fleet, RequestJournal, SamplingParams, SpecConfig,
        mesh_shape_key, serving_mesh,
    )

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    pair = rank // 2
    meshes = [serving_mesh(2, ranks=[0, 1], device="cpu"),
              serving_mesh(2, ranks=[2, 3], device="cpu")]
    mesh = meshes[pair]
    full = port_model(inputs, "gpt")
    res: dict = {}

    def jdir(name):
        # every rank journals the same records into its own directory
        return os.path.join(workdir, f"{name}-r{rank}")

    def cross(src_mp, dst_mp):
        def m(mp):
            return mesh if mp else None

        path = jdir(f"cross{src_mp}{dst_mp}")
        j = RequestJournal(path)
        e1 = Engine(port_model(inputs, "gpt"), journal=j, mesh=m(src_mp),
                    **ENGINE_KW)
        e1.warmup()
        rg = e1.add_request(PROMPTS[0], max_new_tokens=MAX_NEW)
        rs = e1.add_request(PROMPTS[1], max_new_tokens=MAX_NEW,
                            sampling=SamplingParams(**SEEDED))
        for _ in range(3):
            e1.step()
        midway = any(r.output_ids for r in (rg, rs))
        e1.journal = None
        j.close()
        j2 = RequestJournal(path)
        n_pending = len(j2.pending())
        e2 = Engine(port_model(inputs, "gpt"), journal=j2, mesh=m(dst_mp),
                    **ENGINE_KW)
        e2.warmup()
        misses0 = e2.metrics.compile_misses
        info = e2.recover()
        e2.run()
        rec = info["requests"]
        ref = [e2.add_request(PROMPTS[0], max_new_tokens=MAX_NEW),
               e2.add_request(PROMPTS[1], max_new_tokens=MAX_NEW,
                              sampling=SamplingParams(
                                  temperature=0.8, top_k=8,
                                  seed=rec[1].sampling.seed))]
        e2.run()
        a = j2.audit()
        j3 = RequestJournal(path)
        return {"midway": midway, "pending": n_pending,
                "replayed": info["replayed"],
                "cross_mesh": info["cross_mesh"],
                "invalid": len(info["invalid"]),
                "recovered": all(r.finished and r.recovered for r in rec),
                "outs": [r.output_ids for r in rec],
                "ref": [r.output_ids for r in ref],
                "misses_after": e2.metrics.compile_misses - misses0,
                "audit": (a["pending"], a["duplicate_terminals"],
                          a["mesh_reshards"]),
                "reopen": (j3.mesh_reshards, len(j3.pending())),
                "key": mesh_shape_key(e2.shard.mesh if e2.shard else None)
                == e2.mesh_shape}

    scenario(res, "cross/mp2_to_mp1", cross, 2, None)
    scenario(res, "cross/mp1_to_mp2", cross, None, 2)

    def mid_spec():
        path = jdir("midspec")
        j = RequestJournal(path)
        e1 = Engine(port_model(inputs, "gpt"), journal=j, mesh=mesh,
                    speculation=SpecConfig(
                        draft_model=port_model(inputs, "draft"), k=3),
                    **ENGINE_KW)
        e1.warmup()
        r1 = e1.add_request(PROMPTS[1], max_new_tokens=MAX_NEW)
        for _ in range(2):
            e1.step()
        midway = 0 < len(r1.output_ids) < MAX_NEW
        e1.journal = None
        j.close()
        j2 = RequestJournal(path)
        e2 = Engine(port_model(inputs, "gpt"), journal=j2, **ENGINE_KW)
        e2.warmup()
        info = e2.recover()
        e2.run()
        rr = info["requests"][0]
        return {"midway": midway, "replayed": info["replayed"],
                "cross_mesh": info["cross_mesh"],
                "done": rr.finished and rr.recovered, "out": rr.output_ids,
                "chain": greedy_chain_ok(full, PROMPTS[1], rr.output_ids),
                "dups": j2.audit()["duplicate_terminals"],
                "draft_sharded": e1.spec.model.mesh is not None}

    scenario(res, "mid_spec", mid_spec)

    def preempted():
        kw = dict(ENGINE_KW, num_slots=1)
        path = jdir("preempted")
        j = RequestJournal(path)
        e1 = Engine(port_model(inputs, "gpt"), journal=j, **kw)
        e1.warmup()
        low = e1.add_request(PROMPTS[1], max_new_tokens=MAX_NEW,
                             priority="low")
        e1.step()
        e1.add_request(PROMPTS[0], max_new_tokens=MAX_NEW, priority="high")
        e1.step()
        preemptions = low.preemptions
        e1.journal = None
        j.close()
        j2 = RequestJournal(path)
        n_pending = len(j2.pending())
        e2 = Engine(port_model(inputs, "gpt"), journal=j2, mesh=mesh, **kw)
        e2.warmup()
        info = e2.recover()
        e2.run()
        a = j2.audit()
        return {"preemptions": preemptions, "pending": n_pending,
                "replayed": info["replayed"],
                "cross_mesh": info["cross_mesh"],
                "done": all(r.finished and r.recovered
                            for r in info["requests"]),
                "outs": [r.output_ids for r in info["requests"]],
                "chains": [greedy_chain_ok(full, p, r.output_ids)
                           for r, p in zip(info["requests"],
                                           (PROMPTS[1], PROMPTS[0]))],
                "audit": (a["pending"], a["duplicate_terminals"])}

    scenario(res, "preempted", preempted)

    def strict():
        path = jdir("strict")
        j = RequestJournal(path)
        e1 = Engine(port_model(inputs, "gpt"), journal=j, mesh=mesh,
                    **ENGINE_KW)
        e1.warmup()
        e1.add_request(PROMPTS[0], max_new_tokens=MAX_NEW)
        e1.step()
        e1.journal = None
        j.close()
        j2 = RequestJournal(path)
        e2 = Engine(port_model(inputs, "gpt"), journal=j2, **ENGINE_KW)
        info = e2.recover(cross_mesh=False)
        return {"replayed": info["replayed"],
                "invalid": len(info["invalid"]),
                "cross_mesh": info["cross_mesh"],
                "reshards": RequestJournal(path).mesh_reshards}

    scenario(res, "strict", strict)

    def viable():
        fl = Fleet(port_model(inputs, "gpt"), num_replicas=1,
                   shards_per_group=2, device="cpu", **ENGINE_KW)
        out = {"mp": fl.replicas[0].model_parallel(), "recover": None}
        try:
            fl.recover()
        except ValueError as e:
            out["recover"] = str(e)
        fl.shutdown()
        return out

    dist.barrier()
    scenario(res, "viable", viable)

    def shard_fail():
        plan = ServingFaultPlan().add("serving.r0.shard_fail", at_call=2)
        fl = Fleet(port_model(inputs, "gpt"), num_replicas=2,
                   shards_per_group=2, fault_plan=plan, device="cpu",
                   journal=RequestJournal(jdir("fleet")), **ENGINE_KW)
        fl.warmup()
        group0 = list(fl._group_devices[0])
        reqs = [fl.submit(PROMPTS[i % 3], max_new_tokens=MAX_NEW)
                for i in range(4)]
        fl.run(max_steps=200)
        rep0 = fl.replicas[0]
        rebuilt = list(fl._group_ranks[0])
        st = fl.stats()
        deg = st["degraded"]
        out = {"finished": [r.finished for r in reqs],
               "outs": [r.output_ids for r in reqs],
               "chains": [greedy_chain_ok(full, PROMPTS[i % 3],
                                          r.output_ids)
                          for i, r in enumerate(reqs)],
               "rep0": (rep0.state, rep0.degraded, rep0.model_parallel()),
               "rebuilt_in_group0": len(rebuilt) == 1
               and rebuilt[0] in group0,
               "rebuilt_not_failed": not (set(rebuilt)
                                          & fl._failed_devices),
               "failed_devices": deg["failed_devices"],
               "group0": deg["groups"][rep0.engine.name],
               "degrades": (deg["degrades"], deg["last_old_mp"],
                            deg["last_mp"]),
               "degrade_ms_positive": deg["last_degrade_ms"] > 0,
               "supervision": (st["supervision"]["ejections"],
                               st["supervision"]["rebuilds"]),
               "reshards": fl.journal.mesh_reshards,
               "dups": fl.journal.audit()["duplicate_terminals"],
               "runs_engine": rep0.local}
        fl.submit(PROMPTS[0], max_new_tokens=1, replica=0)
        out["load"] = fl._gather_groups(lambda r: r.load(),
                                        [rep0])[rep0.index]
        out["effective_load"] = fl._effective_load(rep0)
        fl.run(max_steps=50)
        fl.journal.close()
        reopened = RequestJournal(jdir("fleet"))
        out["reopen_reshards"] = reopened.mesh_reshards
        return out

    dist.barrier()
    scenario(res, "shard_fail", shard_fail)

    def zero_survivors():
        fl = Fleet(port_model(inputs, "gpt"), num_replicas=1,
                   shards_per_group=2, device="cpu",
                   journal=RequestJournal(jdir("zero")), **ENGINE_KW)
        rep = fl.replicas[0]
        fl._failed_devices.update(fl._group_devices[0])
        fl._eject(rep, "test: all shard devices lost")
        fl._rebuild(rep)
        return {"state": rep.state, "error": rep.last_error,
                "rebuild_failures": fl.metrics.rebuild_failures}

    dist.barrier()
    scenario(res, "zero", zero_survivors)

    def fleet_recover():
        # two groups, each rank journaling its own group's requests: the
        # recovery gathers the pending sets of all four journals
        def fleet(journal):
            return Fleet(port_model(inputs, "gpt"), name="fleet",
                         num_replicas=2, shards_per_group=2, device="cpu",
                         journal=journal, **ENGINE_KW)

        path = jdir("recover")
        f1 = fleet(RequestJournal(path))
        f1.warmup()
        for i in range(4):
            f1.submit(PROMPTS[i % 3], max_new_tokens=MAX_NEW)
        for _ in range(2):
            f1.step()
        f1.journal.close()
        j2 = RequestJournal(path)
        own = len(j2.pending())
        f2 = fleet(j2)
        f2.warmup()
        info = f2.recover()
        f2.run(max_steps=200)
        a = j2.audit()
        return {"own_pending": own, "replayed": info["replayed"],
                "jids": [r.journal_id for r in info["requests"]],
                "outs": [r.output_ids for r in info["requests"]],
                "done": all(r.finished and r.recovered
                            for r in info["requests"]),
                "audit": (a["pending"], a["duplicate_terminals"])}

    dist.barrier()
    scenario(res, "fleet_recover", fleet_recover)
    return res


# -- the JAX side and the world ------------------------------------------------

@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    import paddle_tpu as paddle
    from paddle_tpu.models import gpt as jax_gpt
    from paddle_tpu.serving import (
        Engine as JaxEngine, SamplingParams as JaxSampling,
    )
    from paddle_tpu_torch.models import (
        GPTForCausalLM, port_state_dict_from_jax,
    )

    workdir = str(tmp_path_factory.mktemp("degraded_world"))
    inputs = {"configs": {}}
    jax_models = {}
    for tag, seed, cfg in (("gpt", 0, gpt_tiny()),
                           ("draft", 7, GPTConfig(**DRAFT))):
        paddle.seed(seed)
        jcfg = (jax_gpt.gpt_tiny() if tag == "gpt"
                else jax_gpt.GPTConfig(**DRAFT))
        m = jax_gpt.GPTForCausalLM(jcfg)
        m.eval()
        jax_models[tag] = m
        sd = port_state_dict_from_jax(
            GPTForCausalLM(cfg, device="meta"),
            {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()})
        inputs[tag] = {k: v.numpy() for k, v in sd.items()}
        inputs["configs"][tag] = cfg
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    world = run_world("test_torch_degraded_serving", "_degraded_worker",
                      workdir)
    # the JAX single-chip streams of the two requests every cross-mesh
    # replay must give (greedy, and seeded at the journaled seed)
    eng = JaxEngine(jax_models["gpt"], **ENGINE_KW)
    eng.warmup()
    greedy = eng.add_request(PROMPTS[0], max_new_tokens=MAX_NEW)
    seeded = eng.add_request(PROMPTS[1], max_new_tokens=MAX_NEW,
                             sampling=JaxSampling(**SEEDED))
    eng.run()
    jax = {"greedy": greedy.output_ids, "seeded": seeded.output_ids,
           "plain": eng.generate(PROMPTS, max_new_tokens=MAX_NEW)}
    results = world.results()
    yield {"jax": jax, "world": results}
    shutil.rmtree(workdir, ignore_errors=True)


def _agree(ctx, name, ranks=range(WORLD)):
    vals = [_get(ctx["world"], name, r) for r in ranks]
    for r, v in zip(list(ranks)[1:], vals[1:]):
        assert v == vals[0], (name, r)
    return vals[0]


# ---------------------------------------------------------------------------
# viability ladder
# ---------------------------------------------------------------------------

class TestViabilityLadder:
    def test_ladder_values(self):
        from paddle_tpu.serving.sharding import viable_ladder as jax_ladder

        cases = [((4, 4), {}), ((2, 4), {}), ((3, 6), {}),
                 ((4, 4), {"max_mp": 3}), ((4, 4), {"max_mp": 0})]
        for args, kw in cases:
            assert viable_ladder(*args, **kw) == jax_ladder(*args, **kw)
        assert viable_ladder(4, 4) == [1, 2, 4]
        assert viable_ladder(2, 4) == [1, 2]
        assert viable_ladder(3, 6) == [1, 3]
        assert viable_ladder(4, 4, max_mp=3) == [1, 2]
        assert viable_ladder(4, 4, max_mp=0) == []
        with pytest.raises(ValueError):
            viable_ladder(0, 4)

    def test_degrade_step_picks_largest_viable(self):
        from paddle_tpu.serving.sharding import degrade_step as jax_step

        for args in ((4, 4, 4), (4, 4, 3), (4, 4, 1), (4, 4, 0),
                     (2, 4, 3)):
            assert degrade_step(*args) == jax_step(*args)
        assert degrade_step(4, 4, 4) == 4
        assert degrade_step(4, 4, 3) == 2
        assert degrade_step(4, 4, 1) == 1
        assert degrade_step(4, 4, 0) is None
        assert degrade_step(2, 4, 3) == 2

    def test_fleet_rejects_nonviable_shard_group(self, ctx):
        """gpt_tiny's ladder is [1, 2, 4]: a width of 3 is refused naming
        it (before any rank count); a viable width constructs on a world
        of ranks."""
        from paddle_tpu_torch.serving import Fleet

        with pytest.raises(ValueError) as ei:
            Fleet(gpt_tiny(), num_replicas=1, shards_per_group=3,
                  device="cpu", **ENGINE_KW)
        msg = str(ei.value)
        assert "[1, 2, 4]" in msg and "shards_per_group" in msg
        got = _agree(ctx, "viable")
        assert got["mp"] == 2
        # a shard-group fleet recovers (tests/test_torch_fleet_recover.py),
        # and without a journal refuses as the JAX fleet does
        assert "needs a RequestJournal" in got["recover"]


# ---------------------------------------------------------------------------
# cross-mesh journal recovery
# ---------------------------------------------------------------------------

class TestCrossMeshRecovery:
    @pytest.mark.parametrize("direction", ["mp2_to_mp1", "mp1_to_mp2"])
    def test_replay_bitwise_both_directions(self, ctx, direction):
        """Greedy and seeded requests journaled at one shape, abandoned
        mid-decode, replay at the other: equal to an uninterrupted run on
        the target (and the greedy one to the JAX engine's), no program
        built after warmup, each request ended once, one durable
        ``mesh_reshard`` record."""
        got = _agree(ctx, f"cross/{direction}")
        assert got["midway"] and got["pending"] == 2
        assert got["replayed"] == 2 and got["cross_mesh"] == 2
        assert got["invalid"] == 0 and got["recovered"]
        assert got["outs"] == got["ref"]
        assert got["outs"][0] == ctx["jax"]["greedy"]
        assert got["misses_after"] == 0
        assert got["audit"] == (0, 0, 1)
        assert got["reopen"] == (1, 0)
        assert got["key"]

    def test_mid_speculation_crash_replays_cross_mesh(self, ctx):
        """A request abandoned mid-speculation on a model=2 speculating
        engine (its 2-head draft sharded too) replays greedily on an
        unsharded engine without speculation."""
        got = _agree(ctx, "mid_spec")
        assert got["midway"]
        assert got["replayed"] == 1 and got["cross_mesh"] == 1
        assert got["done"] and got["chain"]
        assert got["out"] == ctx["jax"]["plain"][1]
        assert got["dups"] == 0
        assert got["draft_sharded"]

    def test_preempted_victim_replays_cross_mesh(self, ctx):
        """A victim preempted by a high-priority admission, then crashed,
        replays on a model=2 engine: both it and its preemptor end once
        with whole greedy streams."""
        got = _agree(ctx, "preempted")
        assert got["preemptions"] == 1 and got["pending"] == 2
        assert got["replayed"] == 2 and got["cross_mesh"] == 2
        assert got["done"] and all(got["chains"])
        assert got["outs"] == [ctx["jax"]["plain"][1],
                               ctx["jax"]["plain"][0]]
        assert got["audit"] == (0, 0)

    def test_strict_mode_still_refuses(self, ctx):
        got = _agree(ctx, "strict")
        assert got == {"replayed": 0, "invalid": 1, "cross_mesh": 0,
                       "reshards": 0}


# ---------------------------------------------------------------------------
# shard-group failover
# ---------------------------------------------------------------------------

class TestDegradedFleet:
    def test_shard_fail_degrades_group_and_keeps_serving(self, ctx):
        """``serving.r0.shard_fail`` loses group 0's highest rank: the
        fleet ejects the group, rebuilds it at mp 1 on its surviving rank,
        replays the orphans, and every request ends once with its greedy
        stream; the degrade is counted, journaled (surviving a reopen)
        and weighs the group's load by 2.  Every rank's fleet saw the
        same; the lost rank runs no engine any more."""
        vals = [_get(ctx["world"], "shard_fail", r) for r in range(WORLD)]
        runs = [v.pop("runs_engine") for v in vals]
        assert runs == [True, False, False, False]
        for v in vals[1:]:
            assert v == vals[0]
        got = vals[0]
        assert all(got["finished"]) and all(got["chains"])
        assert got["outs"] == [ctx["jax"]["plain"][i % 3]
                               for i in range(4)]
        assert got["rep0"] == ("active", True, 1)
        assert got["rebuilt_in_group0"] and got["rebuilt_not_failed"]
        assert got["failed_devices"] == 1
        assert got["group0"] == {"model_parallel": 1, "configured": 2,
                                 "degraded": True, "state": "active"}
        assert got["degrades"] == (1, 2, 1)
        assert got["degrade_ms_positive"]
        assert got["supervision"] == (1, 1)
        assert got["reshards"] >= 1 and got["dups"] == 0
        assert got["load"] == 1
        assert got["effective_load"] == pytest.approx(2.0)
        assert got["reopen_reshards"] >= 1

    def test_recover_gathers_every_groups_journal(self, ctx):
        """Two groups of two ranks journal their own requests (two each);
        after the crash every rank recovers all four, once each, in one
        order, with the JAX engine's greedy streams, and every rank's
        journal drains with no duplicate terminal."""
        vals = [_get(ctx["world"], "fleet_recover", r)
                for r in range(WORLD)]
        own = [v.pop("own_pending") for v in vals]
        assert own == [2, 2, 2, 2]
        for v in vals[1:]:
            assert v == vals[0]
        got = vals[0]
        assert got["replayed"] == 4 and got["done"]
        assert len(set(got["jids"])) == 4
        assert sorted(got["outs"]) == sorted(
            ctx["jax"]["plain"][i % 3] for i in range(4))
        assert got["audit"] == (0, 0)

    def test_zero_survivors_is_dead_with_ladder_error(self, ctx):
        got = _agree(ctx, "zero")
        assert got["state"] == "dead"
        assert "viable" in got["error"]
        assert got["rebuild_failures"] == 1

    def test_mesh_reshard_record_survives_reopen(self, tmp_path):
        from paddle_tpu_torch.serving import RequestJournal

        j = RequestJournal(str(tmp_path))
        j.record_mesh_reshard("e0", "model=2", "model=1",
                              {"e0:b0:r0": "replayed",
                               "e0:b1:r1": "redispatched"})
        j.close()
        j2 = RequestJournal(str(tmp_path))
        assert j2.mesh_reshards == 1
        assert j2.audit()["mesh_reshards"] == 1
