"""``Fleet.recover`` of a shard-group fleet: the port against the JAX
package's, on the CPU.

No JAX test covers a shard-group recovery, so the spec is the JAX
``Fleet.recover`` (``paddle_tpu/serving/router.py:1025-1085``) driven the
same way here: a fleet of one group of two (``shards_per_group=2``) with
a journal serves three greedy requests, is abandoned mid-decode (the
in-process crash stand-in), and a new fleet over the reopened journal
recovers and runs to the end.  The JAX side runs in this process on its
virtual CPU devices; the port's side in a spawned gloo world of two
processes (the world launcher of ``tests/test_torch_sharded_serving.py``),
each rank journaling into its own directory, so the recovery first
gathers the pending sets across the world.

The bar: every pending request replays exactly once, under its original
journal id, with the greedy stream the JAX fleet's recovery gives; each
rank's journal audits ``pending == 0`` and ``duplicate_terminals == 0``;
the JAX checks' messages (not active, requests in flight, another
journal) hold on a shard-group fleet too.
"""
import os
import pickle
import shutil

import numpy as np
import pytest

from paddle_tpu_torch.models import gpt_tiny

from test_torch_sharded_serving import _get, port_model, run_world, \
    scenario

WORLD2 = 2
ENGINE_KW = dict(num_slots=2, max_seq=16, min_bucket=16)
MAX_NEW = 6
_rs = np.random.RandomState(5)
PROMPTS = [_rs.randint(0, 128, (L,)).tolist() for L in (5, 9, 7)]
#: fleet steps served before the crash: every request still pending
CRASH_AFTER = 2


# -- the port's worker ---------------------------------------------------------

def _recover_worker(rank: int, world: int, workdir: str) -> dict:
    from paddle_tpu_torch.serving import Fleet, RequestJournal

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res: dict = {}
    path = os.path.join(workdir, f"journal-r{rank}")

    def fleet(journal):
        return Fleet(port_model(inputs, "gpt"), name="fleet",
                     num_replicas=1, shards_per_group=2, device="cpu",
                     journal=journal, **ENGINE_KW)

    def crash_and_recover():
        j1 = RequestJournal(path)
        f1 = fleet(j1)
        f1.warmup()
        reqs = [f1.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
        for _ in range(CRASH_AFTER):
            f1.step()
        midway = [len(r.output_ids) for r in reqs]
        # the crash: the journal's records are on disk, the fleet is
        # abandoned with its requests in flight
        try:
            f1.recover()
            busy = None
        except RuntimeError as e:
            busy = str(e)
        j1.close()
        j2 = RequestJournal(path)
        pending = sorted(j2.pending())
        f2 = fleet(j2)
        f2.warmup()
        info = f2.recover()
        f2.run(max_steps=200)
        a = j2.audit()
        try:
            f2.recover(journal=RequestJournal(path + "-other"))
            other = None
        except ValueError as e:
            other = str(e)
        f2.shutdown()
        try:
            f2.recover()
            stopped = None
        except RuntimeError as e:
            stopped = f"{type(e).__name__}: {e}"
        j2.close()
        reopened = RequestJournal(path)
        out = {"midway": midway, "busy": busy, "other": other,
               "stopped": stopped,
               "pending": pending, "replayed": info["replayed"],
               "jids": [r.journal_id for r in info["requests"]],
               "recovered": [r.recovered and r.finished
                             for r in info["requests"]],
               "outs": [r.output_ids for r in info["requests"]],
               "audit": (a["pending"], a["duplicate_terminals"]),
               "reopen_pending": len(reopened.pending()),
               "crash_recoveries":
                   f2.stats()["durability"]["crash_recoveries"]}
        reopened.close()
        return out

    scenario(res, "recover", crash_and_recover)
    return res


# -- the JAX side and the world ------------------------------------------------

@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    import paddle_tpu as paddle
    from paddle_tpu.distributed import mesh as mesh_mod
    from paddle_tpu.models import gpt as jax_gpt
    from paddle_tpu.serving import Fleet as JaxFleet
    from paddle_tpu.serving import RequestJournal as JaxJournal
    from paddle_tpu_torch.models import (
        GPTForCausalLM, port_state_dict_from_jax,
    )

    saved_mesh = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    workdir = str(tmp_path_factory.mktemp("recover_world"))
    paddle.seed(0)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny())
    jm.eval()
    sd = port_state_dict_from_jax(
        GPTForCausalLM(gpt_tiny(), device="meta"),
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    inputs = {"gpt": {k: v.numpy() for k, v in sd.items()},
              "configs": {"gpt": gpt_tiny()}}
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    world = run_world("test_torch_fleet_recover", "_recover_worker",
                      workdir, nprocs=WORLD2)
    try:
        path = os.path.join(workdir, "jax-journal")

        def fleet(journal):
            return JaxFleet(jm, name="fleet", num_replicas=1,
                            shards_per_group=2, journal=journal,
                            **ENGINE_KW)

        f1 = fleet(JaxJournal(path))
        f1.warmup()
        for p in PROMPTS:
            f1.submit(p, max_new_tokens=MAX_NEW)
        for _ in range(CRASH_AFTER):
            f1.step()
        f1.journal.close()
        j2 = JaxJournal(path)
        pending = sorted(j2.pending())
        f2 = fleet(j2)
        f2.warmup()
        info = f2.recover()
        f2.run(max_steps=200)
        a = j2.audit()
        jax = {"pending": pending, "replayed": info["replayed"],
               "jids": [r.journal_id for r in info["requests"]],
               "outs": [r.output_ids for r in info["requests"]],
               "audit": (a["pending"], a["duplicate_terminals"])}
        results = world.results()
    finally:
        mesh_mod.set_global_mesh(saved_mesh)
    yield {"jax": jax, "world": results}
    shutil.rmtree(workdir, ignore_errors=True)


class TestShardGroupRecover:
    def test_recover_replays_each_pending_request_once(self, ctx):
        """Both ranks recover the same three requests from their own
        journals, under the JAX fleet's journal ids, with its greedy
        streams; every journal drains and audits exactly once."""
        vals = [_get(ctx["world"], "recover", r) for r in range(WORLD2)]
        assert vals[1] == vals[0]
        got, jax = vals[0], ctx["jax"]
        # two slots: two requests mid-decode, the third still queued
        assert sorted(got["midway"])[1:] == [CRASH_AFTER + 1] * 2
        assert got["midway"].count(0) == 1
        assert got["pending"] == jax["pending"] and len(jax["pending"]) == 3
        assert got["replayed"] == jax["replayed"] == 3
        assert got["jids"] == jax["jids"]
        assert all(got["recovered"])
        assert got["outs"] == jax["outs"]
        assert all(len(o) == MAX_NEW for o in got["outs"])
        assert got["audit"] == jax["audit"] == (0, 0)
        assert got["reopen_pending"] == 0
        assert got["crash_recoveries"] == 1

    def test_recover_keeps_the_jax_checks(self, ctx):
        """A fleet with requests in flight, a journal other than the
        fleet's, and a stopped fleet are refused with the JAX messages."""
        got = _get(ctx["world"], "recover", 0)
        assert "must run before serving traffic" in got["busy"]
        assert "does not match the journal" in got["other"]
        assert got["stopped"].startswith("EngineStopped") \
            and "cannot recover" in got["stopped"]
