"""Tensor-parallel sharded serving of the port against the JAX package's,
on the CPU.

``tests/test_sharded_serving.py`` (and ``tests/test_tenancy.py::
TestShardedTenancy``) is the spec: every case has a counterpart here.
The JAX side runs in this process on ``serving_mesh(2)`` over its virtual
CPU devices, as its own tests do.  The port's side runs in one spawned
gloo world of :data:`WORLD` processes (``torch.distributed`` on a
``FileStore`` in the test's temporary directory), made once for the
module: ranks 0-1 and 2-3 each serve every engine scenario on their own
``model=2`` mesh (the two pairs must agree), then all four ranks run the
fleet of two shard groups.  A worker imports ``torch``, ``numpy`` and
``paddle_tpu_torch`` only (this module imports no JAX at its top level;
the JAX side lives in the fixtures).  Both sides load the same numpy
state dict (the JAX model's, through ``models/convert.py``) and take the
same seeded prompts.

Tolerance: greedy token streams are equal (the JAX tests' bar); the
sharded port's logits are within :data:`ATOL` (1e-5, f32) of the
unsharded port's, with and without adapter rows.  Each worker runs
under a join timeout; a worker still running at it is killed and the
tests fail.
"""
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import (
    GPTForCausalLM, LlamaForCausalLM, gpt_tiny, llama_tiny,
    shard_state_dict, unshard_state_dict,
)
from paddle_tpu_torch.models.convert import shard_rule

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path.insert(0, TESTS)
import torch_world  # noqa: E402
from torch_world import get as _get, scenario  # noqa: E402

#: ranks of the module's world
WORLD = 4
#: seconds a world may run before its workers are killed
WORLD_TIMEOUT_S = 240
ATOL = 1e-5

_FAMILIES = {"gpt": (GPTForCausalLM, gpt_tiny),
             "llama": (LlamaForCausalLM, llama_tiny)}
ENGINE_KW = dict(num_slots=2, max_seq=16, min_bucket=16)
PAGED_KW = dict(kv_layout="paged", block_size=8, num_kv_blocks=24)
MAX_NEW = 6
_rs = np.random.RandomState(3)
PROMPTS = [_rs.randint(0, 128, (L,)).tolist() for L in (5, 9, 10)]
_rs5 = np.random.RandomState(5)
PREEMPT = [_rs5.randint(0, 128, (L,)).tolist() for L in (5, 6, 4)]
_rs11 = np.random.RandomState(11)
FLEET_PROMPTS = [_rs11.randint(0, 128, (L,)).tolist()
                 for L in (5, 9, 12, 4, 7)]

# tests/test_tenancy.py's engine, adapters and grammar
TEN_ENG = dict(num_slots=2, max_seq=32, min_bucket=16)
TEN_PAGED = dict(kv_layout="paged", block_size=8)
TEN_ADAPTERS = dict(max_adapters=2, rank=4)
SCALE = 0.5
_rs0 = np.random.RandomState(0)
TEN_PROMPTS = [_rs0.randint(0, 128, (L,)).tolist() for L in (5, 13, 9)]


def _kw(layout):
    kw = dict(ENGINE_KW)
    if layout == "paged":
        kw.update(PAGED_KW)
    return kw


# -- the world (tests/torch_world.py), and what a worker loads ----------------

def run_world(module: str, func: str, workdir: str, nprocs: int = WORLD):
    """The module's world of :data:`WORLD` gloo ranks
    (:func:`torch_world.run_world`)."""
    return torch_world.run_world(module, func, workdir, nprocs,
                                 timeout_s=WORLD_TIMEOUT_S)


def port_model(inputs: dict, tag: str):
    """The port model of family ``tag`` (or a ``"draft"``) on the CPU with
    the JAX model's weights (``inputs[tag]``: a port-layout state
    dict)."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in inputs[tag].items()}
    cfg = inputs["configs"][tag]
    cls = LlamaForCausalLM if tag == "llama" else GPTForCausalLM
    m = cls(cfg, device="cpu")
    m.load_state_dict(sd)
    return m.eval()


def greedy_chain_ok(model, prompt, out_ids) -> bool:
    """Whether ``out_ids`` is the no-cache greedy continuation of
    ``prompt`` under ``model`` (one whole causal forward)."""
    full = list(prompt) + [int(t) for t in out_ids]
    with torch.no_grad():
        logits = model(torch.tensor([full[:-1]]))[0]
    L = len(prompt)
    return all(int(torch.argmax(logits[L - 1 + i])) == int(t)
               for i, t in enumerate(out_ids))


# -- the port's worker: every scenario -----------------------------------------

def _sharded_worker(rank: int, world: int, workdir: str) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.serving import (
        Engine, Fleet, JsonArrayGrammar, RequestJournal, SamplingParams,
        SpecConfig, make_lora_weights,
    )
    from paddle_tpu_torch.serving.sharding import (
        ServingShard, mesh_shape_key, serving_mesh,
    )

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    pair = rank // 2
    meshes = [serving_mesh(2, ranks=[0, 1], device="cpu"),
              serving_mesh(2, ranks=[2, 3], device="cpu")]
    mesh = meshes[pair]
    mesh4 = serving_mesh(4, ranks=[0, 1, 2, 3], device="cpu")
    res: dict = {}
    full = {tag: port_model(inputs, tag) for tag in ("gpt", "llama")}

    def streams(eng, prompts=PROMPTS, n=MAX_NEW, **kw):
        reqs = [eng.add_request(p, max_new_tokens=n, **kw)
                for p in prompts]
        eng.run()
        assert all(r.finished for r in reqs), \
            [(r.state, r.error) for r in reqs]
        return [r.output_ids for r in reqs]

    def parity(tag, layout):
        plain = Engine(port_model(inputs, tag), **_kw(layout))
        plain.warmup()
        want = streams(plain)
        eng = Engine(port_model(inputs, tag), mesh=mesh, **_kw(layout))
        eng.warmup()
        warm = eng.metrics.compile_misses
        got = streams(eng)
        ids = torch.tensor([PROMPTS[2]])
        with torch.no_grad():
            err = float((eng.model(ids) - full[tag](ids)).abs().max())
        cfg = inputs["configs"][tag]
        kv = getattr(cfg, "n_kv_heads", None) or cfg.num_attention_heads
        return {"plain": want, "got": got,
                "misses_after": eng.metrics.compile_misses - warm,
                "pool_heads": (int(eng.cache.k.shape[3]), kv),
                "sharding": eng.stats()["sharding"], "logits_err": err}

    for tag in ("gpt", "llama"):
        for layout in ("contiguous", "paged"):
            scenario(res, f"parity/{tag}/{layout}", parity, tag, layout)

    def spec():
        eng = Engine(port_model(inputs, "gpt"), mesh=mesh,
                     speculation=SpecConfig(
                         draft_model=port_model(inputs, "draft"), k=3),
                     **ENGINE_KW)
        eng.warmup()
        warm = eng.metrics.compile_misses
        return {"got": streams(eng),
                "misses_after": eng.metrics.compile_misses - warm,
                "draft_sharded": eng.spec.model.mesh is not None}

    scenario(res, "spec", spec)

    def preempt():
        eng = Engine(port_model(inputs, "gpt"), mesh=mesh,
                     max_preemptions=2, priority_aging_s=30.0,
                     **_kw("paged"))
        eng.warmup()
        warm = eng.metrics.compile_misses
        p1, p2, p3 = PREEMPT
        a1 = eng.add_request(p1, max_new_tokens=8, priority="low")
        a2 = eng.add_request(p2, max_new_tokens=8, priority="low")
        eng.step()
        eng.step()
        running = (a1.state, a2.state)
        hi = eng.add_request(p3, max_new_tokens=4, priority="high")
        eng.run()
        return {"running": running, "preempted": a2.preempted,
                "preemptions": a2.preemptions,
                "finished": [a1.finished, a2.finished, hi.finished],
                "outs": [a1.output_ids, a2.output_ids, hi.output_ids],
                "chains": [greedy_chain_ok(full["gpt"], p, r.output_ids)
                           for p, r in ((p1, a1), (p2, a2))],
                "misses_after": eng.metrics.compile_misses - warm,
                "invariants": eng.health()["kv_block_invariants"]}

    scenario(res, "preempt", preempt)

    def recovery():
        # every rank journals the same records into its own directory
        jdir = os.path.join(workdir, f"recovery{rank}")
        j = RequestJournal(jdir)
        e1 = Engine(port_model(inputs, "gpt"), journal=j, mesh=mesh,
                    **ENGINE_KW)
        e1.warmup()
        reqs = [e1.add_request(p, max_new_tokens=MAX_NEW)
                for p in PROMPTS]
        for _ in range(3):
            e1.step()
        midway = any(r.output_ids for r in reqs)
        j2 = RequestJournal(jdir)
        pending = j2.pending()
        shapes = [rec.get("mesh_shape") for rec in pending.values()]
        e2 = Engine(port_model(inputs, "gpt"), journal=j2, mesh=mesh,
                    **ENGINE_KW)
        e2.warmup()
        warm = e2.metrics.compile_misses
        info = e2.recover()
        e2.run()
        got = {tuple(r.prompt_ids.tolist()): r.output_ids
               for r in info["requests"]}
        return {"midway": midway, "pending": len(pending),
                "shapes": shapes, "replayed": info["replayed"],
                "invalid": len(info["invalid"]),
                "outs": [got[tuple(p)] for p in PROMPTS],
                "misses_after": e2.metrics.compile_misses - warm}

    scenario(res, "recovery", recovery)

    def strict():
        jdir = os.path.join(workdir, f"strict{rank}")
        j = RequestJournal(jdir)
        e1 = Engine(port_model(inputs, "gpt"), journal=j, mesh=mesh,
                    **ENGINE_KW)
        e1.warmup()
        e1.add_request(PROMPTS[0], max_new_tokens=MAX_NEW)
        e1.step()
        j2 = RequestJournal(jdir)
        n_pending = len(j2.pending())
        e2 = Engine(port_model(inputs, "gpt"), journal=j2, **ENGINE_KW)
        info = e2.recover(cross_mesh=False)
        j3 = RequestJournal(jdir)
        return {"pending": n_pending, "replayed": info["replayed"],
                "invalid": len(info["invalid"]),
                "cross_mesh": info["cross_mesh"],
                "pending_after": len(j3.pending()),
                "reshards": j3.mesh_reshards}

    scenario(res, "strict", strict)

    def tenancy():
        grammar = JsonArrayGrammar(eos_token_id=1, max_elems=3,
                                   max_digits=2)
        ten = dict(adapters=TEN_ADAPTERS, grammars={"json": grammar})

        def load(eng):
            for i, name in enumerate(("t1", "t2"), start=1):
                eng.load_adapter(name, make_lora_weights(
                    eng.adapter_pool, seed=i, init_scale=SCALE))

        out = {}
        for key, kw in (("mp1", {}), ("mp2", {"mesh": mesh})):
            eng = Engine(port_model(inputs, "gpt"), **TEN_ENG, **TEN_PAGED,
                         **ten, **kw)
            eng.warmup()
            load(eng)
            m0 = eng.metrics.compile_misses
            g = SamplingParams(grammar="json")
            out[key] = {
                "base": streams(eng, TEN_PROMPTS, 8),
                "t1": streams(eng, TEN_PROMPTS, 8,
                              sampling=SamplingParams(adapter="t1")),
                "json": streams(eng, TEN_PROMPTS, grammar.max_tokens,
                                sampling=g),
                "misses_after": eng.metrics.compile_misses - m0,
                "sharding": eng.stats().get("sharding"),
                "adapters": eng.stats()["tenancy"]["adapters"]}
            # logits under adapter rows (row targets add their delta
            # before the reduce)
            pool = eng.adapter_pool
            pool.set_rows(torch.tensor([1, 2], dtype=torch.int32))
            try:
                with torch.no_grad():
                    out[key]["logits"] = eng.model(torch.tensor(
                        [TEN_PROMPTS[0][:5], TEN_PROMPTS[2][:5]])).numpy()
            finally:
                pool.clear_rows()
        out["logits_err"] = float(np.abs(out["mp1"].pop("logits")
                                         - out["mp2"].pop("logits")).max())
        return out

    scenario(res, "tenancy", tenancy)

    def plumbing():
        out = {"key": mesh_shape_key(mesh), "none": mesh_shape_key(None)}
        try:
            ServingShard(mesh4, kv_heads=2, num_heads=4)
            out["guard"] = None
        except ValueError as e:
            out["guard"] = str(e)
        ServingShard(mesh, kv_heads=2, num_heads=4)
        data = DeviceMesh.from_group(mesh.get_group("model"), "cpu",
                                     mesh=mesh_mod.mesh_ranks(mesh),
                                     mesh_dim_names=("data",))
        try:
            ServingShard(data, kv_heads=4, num_heads=4)
            out["axis"] = None
        except ValueError as e:
            out["axis"] = str(e)
        return out

    scenario(res, "plumbing", plumbing)

    def fleet():
        new = port_model(inputs, "new")
        fl = Fleet(port_model(inputs, "gpt"), num_replicas=2,
                   shards_per_group=2, device="cpu", **_kw("paged"))
        fl.warmup()
        streamed = {}

        def cb(tok, freq):
            streamed.setdefault(freq.request_id, []).append(tok)

        reqs = [fl.submit(p, max_new_tokens=4, stream_cb=cb)
                for p in FLEET_PROMPTS[:4]]
        fl.run()
        rows = fl.metrics.replicas_cb()
        misses0 = {r["name"]: r["compile_misses"] for r in rows}
        roll = fl.update_weights(new.state_dict(), max_drain_steps=2000)
        rows2 = fl.metrics.replicas_cb()
        p = FLEET_PROMPTS[4]
        fr = fl.submit(p, max_new_tokens=4)
        fl.run()
        out = {"states": [r.state for r in reqs],
               "outs": [r.output_ids for r in reqs],
               "streamed": [streamed.get(r.request_id) for r in reqs],
               "shapes": [r["mesh_shape"] for r in rows],
               "groups": [list(g) for g in fl._group_devices],
               "mp": [rep.model_parallel() for rep in fl.replicas],
               "version": roll["model_version"],
               "misses_flat": {r["name"]: r["compile_misses"]
                               for r in rows2} == misses0,
               "post": fr.state, "post_chain": greedy_chain_ok(
                   new, p, fr.output_ids)}
        fl.shutdown()
        return out

    def layers():
        """Each tensor-parallel layer against its whole nn layer on the
        same weights and inputs (f32)."""
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
        )
        from paddle_tpu_torch.models.convert import _shard

        group = mesh.get_group("model")
        r = mesh_mod.mesh_ranks(mesh).index(dist.get_rank())
        g = torch.Generator().manual_seed(0)
        x = torch.randn(3, 5, 16, generator=g)
        out = {}
        for name, parts, gather in (("column", 1, True),
                                    ("fused", 2, False)):
            whole = torch.nn.Linear(16, 24)
            with torch.no_grad():
                whole.weight.normal_(generator=g)
                whole.bias.normal_(generator=g)
            tp = ColumnParallelLinear(16, 24, group=group, parts=parts,
                                      gather_output=gather)
            rule = (0, parts)
            with torch.no_grad():
                tp.weight.copy_(_shard(whole.weight, rule, r, 2))
                tp.bias.copy_(_shard(whole.bias, rule, r, 2))
            with torch.no_grad():
                want = whole(x)
                if not gather:
                    want = want.index_select(-1, tp.local_index())
                out[name] = float((tp(x) - want).abs().max())
        whole = torch.nn.Linear(16, 24)
        tp = RowParallelLinear(16, 24, group=group)
        with torch.no_grad():
            whole.weight.normal_(generator=g)
            whole.bias.normal_(generator=g)
            tp.weight.copy_(_shard(whole.weight, (1, 1), r, 2))
            tp.bias.copy_(whole.bias)
            got = tp(x.index_select(-1, tp.local_index()))
            out["row"] = float((got - whole(x)).abs().max())
        whole = torch.nn.Embedding(10, 6)
        tp = VocabParallelEmbedding(10, 6, group=group)
        with torch.no_grad():
            whole.weight.normal_(generator=g)
            tp.weight.copy_(_shard(whole.weight, (0, 1), r, 2))
        ids = torch.tensor([[0, 4, 5, 9], [9, 5, 4, 0]])    # both edges
        with torch.no_grad():
            out["vocab"] = float((tp(ids) - whole(ids)).abs().max())
        return out

    scenario(res, "layers", layers)

    def skewed_clock():
        """Rank 1's clock runs 1000 s ahead; a deadline of 30 s expires on
        no rank, since every decision reads rank 0's clock."""
        import time as time_mod

        real = time_mod.perf_counter
        if mesh_mod.mesh_ranks(mesh).index(dist.get_rank()) == 1:
            time_mod.perf_counter = lambda: real() + 1000.0
        try:
            eng = Engine(port_model(inputs, "gpt"), mesh=mesh,
                         default_deadline_s=30.0, **_kw("paged"))
            eng.warmup()
            reqs = [eng.add_request(p, max_new_tokens=MAX_NEW)
                    for p in PROMPTS]
            eng.run()
        finally:
            time_mod.perf_counter = real
        return {"states": [r.state for r in reqs],
                "outs": [r.output_ids for r in reqs]}

    scenario(res, "skewed_clock", skewed_clock)

    def divergence():
        """A rank whose scheduling state differs raises at the next
        exchange on every rank instead of hanging; a rank turned unhealthy
        (its watchdog fired) turns every rank unhealthy."""
        from paddle_tpu_torch.serving import EngineStopped

        local = mesh_mod.mesh_ranks(mesh).index(dist.get_rank())
        out = {}
        eng = Engine(port_model(inputs, "gpt"), mesh=mesh, **ENGINE_KW)
        eng.warmup()
        if local == 1:
            eng.free_slots.pop()         # a scheduler state of its own
        try:
            eng.step()
            out["diverged"] = None
        except RuntimeError as e:
            out["diverged"] = "diverged" in str(e)
        eng = Engine(port_model(inputs, "gpt"), mesh=mesh, **ENGINE_KW)
        eng.warmup()
        eng.add_request(PROMPTS[0], max_new_tokens=MAX_NEW)
        if local == 1:
            eng.step_timeout_s = 0.5
            eng._mark_wedged()
        try:
            eng.step()
            out["stopped"] = None
        except EngineStopped:
            out["stopped"] = eng.state
        return out

    scenario(res, "divergence", divergence)

    dist.barrier()
    scenario(res, "fleet", fleet)
    return res


# -- the JAX side and the world, once for the module ---------------------------

@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    """The JAX models and their weights for both sides; the port's world
    started on them; the JAX reference streams; the world's results."""
    import paddle_tpu as paddle
    from paddle_tpu.models import gpt as jax_gpt, llama as jax_llama
    from paddle_tpu.serving import (
        Engine as JaxEngine, JsonArrayGrammar as JaxJson,
        make_lora_weights as jax_lora, serving_mesh as jax_mesh,
    )
    from paddle_tpu_torch.models import port_state_dict_from_jax

    workdir = str(tmp_path_factory.mktemp("sharded_world"))
    jax_models, inputs = {}, {"configs": {}}
    specs = {"gpt": (jax_gpt.GPTForCausalLM, jax_gpt.gpt_tiny, 0,
                     GPTForCausalLM, gpt_tiny),
             "llama": (jax_llama.LlamaForCausalLM, jax_llama.llama_tiny, 0,
                       LlamaForCausalLM, llama_tiny),
             "draft": (jax_gpt.GPTForCausalLM, jax_gpt.gpt_tiny, 7,
                       GPTForCausalLM, gpt_tiny),
             "new": (jax_gpt.GPTForCausalLM, jax_gpt.gpt_tiny, 42,
                     GPTForCausalLM, gpt_tiny)}
    for tag, (jcls, jcfg, seed, pcls, pcfg) in specs.items():
        paddle.seed(seed)
        m = jcls(jcfg())
        m.eval()
        jax_models[tag] = m
        cfg = pcfg()
        shell = pcls(cfg, device="meta")
        sd = port_state_dict_from_jax(
            shell, {k: np.asarray(v.numpy())
                    for k, v in m.state_dict().items()})
        inputs[tag] = {k: v.numpy() for k, v in sd.items()}
        inputs["configs"][tag] = cfg
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    world = run_world("test_torch_sharded_serving", "_sharded_worker",
                      workdir)

    def clone(tag):
        src = jax_models[tag]
        m = type(src)(src.config)
        m.eval()
        m.set_state_dict(src.state_dict())
        return m

    def gen(eng, prompts=PROMPTS, n=MAX_NEW, **kw):
        return eng.generate(prompts, max_new_tokens=n, **kw)

    jax = {"baseline": {}, "mp2": {}}
    for tag in ("gpt", "llama"):
        for layout in ("contiguous", "paged"):
            eng = JaxEngine(clone(tag), **_kw(layout))
            eng.warmup()
            jax["baseline"][(tag, layout)] = gen(eng)
            eng = JaxEngine(clone(tag), mesh=jax_mesh(2), **_kw(layout))
            eng.warmup()
            jax["mp2"][(tag, layout)] = gen(eng)
    # the preemption episode on the JAX mp-2 engine
    eng = JaxEngine(clone("gpt"), mesh=jax_mesh(2), max_preemptions=2,
                    priority_aging_s=30.0, **_kw("paged"))
    eng.warmup()
    p1, p2, p3 = PREEMPT
    a1 = eng.add_request(p1, max_new_tokens=8, priority="low")
    a2 = eng.add_request(p2, max_new_tokens=8, priority="low")
    eng.step()
    eng.step()
    hi = eng.add_request(p3, max_new_tokens=4, priority="high")
    eng.run()
    jax["preempt"] = [a1.output_ids, a2.output_ids, hi.output_ids]
    # the single-chip tenancy engine of tests/test_tenancy.py
    grammar = JaxJson(eos_token_id=1, max_elems=3, max_digits=2)
    eng = JaxEngine(clone("gpt"), **TEN_ENG, **TEN_PAGED,
                    adapters=TEN_ADAPTERS, grammars={"json": grammar})
    eng.warmup()
    for i, name in enumerate(("t1", "t2"), start=1):
        eng.load_adapter(name, jax_lora(eng.adapter_pool, seed=i,
                                        init_scale=SCALE))
    from paddle_tpu.serving import SamplingParams as JaxSampling

    jax["tenancy"] = {
        "base": gen(eng, TEN_PROMPTS, 8),
        "t1": gen(eng, TEN_PROMPTS, 8,
                  sampling=JaxSampling(adapter="t1")),
        "json": gen(eng, TEN_PROMPTS, grammar.max_tokens,
                    sampling=JaxSampling(grammar="json"))}
    results = world.results()
    yield {"jax": jax, "world": results, "inputs": inputs,
           "jax_models": jax_models}
    shutil.rmtree(workdir, ignore_errors=True)


def _pairs_agree(ctx, name):
    """The scenario's result on rank 0, after checking that every rank
    (both meshes) got the same."""
    vals = [_get(ctx["world"], name, r) for r in range(WORLD)]
    for r, v in enumerate(vals[1:], start=1):
        assert v == vals[0], (name, r)
    return vals[0]


# ---------------------------------------------------------------------------
# bitwise parity
# ---------------------------------------------------------------------------

class TestShardedParity:
    @pytest.mark.parametrize("tag", ["gpt", "llama"])
    @pytest.mark.parametrize("layout", ["contiguous", "paged"])
    def test_sharded_bitwise_parity(self, ctx, tag, layout):
        """model=2 greedy streams equal the JAX model=2 engine's, the JAX
        single-chip engine's and the unsharded port engine's, for MHA and
        GQA (llama_tiny: 2 kv heads, one a rank) in both layouts, with no
        program built after warmup; the pool holds the rank's kv heads;
        the logits are the unsharded port's within ATOL."""
        vals = [_get(ctx["world"], f"parity/{tag}/{layout}", r)
                for r in range(WORLD)]
        got = vals[0]
        assert all(v["got"] == got["got"] for v in vals)
        assert got["got"] == ctx["jax"]["mp2"][(tag, layout)]
        assert got["got"] == ctx["jax"]["baseline"][(tag, layout)]
        assert got["got"] == got["plain"]
        assert got["misses_after"] == 0
        local, whole = got["pool_heads"]
        assert local * 2 == whole
        assert got["sharding"] == {"mesh_shape": "model=2",
                                   "model_parallel": 2}
        assert max(v["logits_err"] for v in vals) <= ATOL

    def test_mesh_size_one_degenerates_exactly(self, ctx):
        """serving_mesh(1) with no process group makes a gloo world of one
        on a HashStore; its engine serves the unsharded port engine's and
        the JAX single-chip engine's streams bitwise, its pool holds every
        kv head, and it shares the whole model's tensors."""
        import torch.distributed as dist

        from paddle_tpu_torch.serving import Engine, serving_mesh

        assert not dist.is_initialized()
        try:
            mesh = serving_mesh(1, device="cpu")
            assert dist.get_world_size() == 1
            assert dist.get_backend() == "gloo"
            plain = Engine(port_model(ctx["inputs"], "gpt"), **ENGINE_KW)
            plain.warmup()
            want = plain.generate(PROMPTS, max_new_tokens=MAX_NEW)
            model = port_model(ctx["inputs"], "gpt")
            eng = Engine(model, mesh=mesh, **ENGINE_KW)
            eng.warmup()
            warm = eng.metrics.compile_misses
            got = eng.generate(PROMPTS, max_new_tokens=MAX_NEW)
            assert got == want == ctx["jax"]["baseline"][("gpt",
                                                          "contiguous")]
            assert eng.metrics.compile_misses == warm
            assert eng.mesh_shape == "model=1"
            assert eng.model_parallel() == 1
            assert eng.cache.k.shape[3] == gpt_tiny().num_attention_heads
            assert [p.data_ptr() for p in eng.model.parameters()] == \
                [p.data_ptr() for p in model.parameters()]
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()

    def test_sharded_speculative_decoding_parity(self, ctx):
        """A model=2 speculating engine (the draft sharded too: its 4
        heads divide the mesh) serves the single-chip greedy streams with
        no program built after warmup."""
        got = _pairs_agree(ctx, "spec")
        assert got["got"] == ctx["jax"]["baseline"][("gpt", "contiguous")]
        assert got["misses_after"] == 0
        assert got["draft_sharded"]


# ---------------------------------------------------------------------------
# overload machinery sharded
# ---------------------------------------------------------------------------

class TestShardedPreemption:
    def test_preempt_resume_sharded(self, ctx):
        """A low-priority victim preempted mid-decode on a model=2 paged
        engine resumes to its whole greedy stream, the same as the JAX
        model=2 engine's episode, with no program built after warmup."""
        got = _pairs_agree(ctx, "preempt")
        assert got["running"] == ("running", "running")
        assert got["preempted"] and got["preemptions"] == 1
        assert all(got["finished"])
        assert all(got["chains"])
        assert got["outs"] == ctx["jax"]["preempt"]
        assert got["misses_after"] == 0
        assert got["invariants"] == "ok"


# ---------------------------------------------------------------------------
# durability sharded
# ---------------------------------------------------------------------------

class TestShardedRecovery:
    def test_recovery_bitwise_same_mesh_shape(self, ctx):
        """A model=2 engine abandoned mid-decode; a new one on a mesh of
        the same shape replays every pending request (journaled at
        "model=2") to the single-chip greedy streams.  Every rank journals
        the same records into its own directory."""
        got = _pairs_agree(ctx, "recovery")
        assert got["midway"]
        assert got["pending"] == 3
        assert got["shapes"] == ["model=2"] * 3
        assert got["replayed"] == 3 and got["invalid"] == 0
        assert got["outs"] == ctx["jax"]["baseline"][("gpt", "contiguous")]
        assert got["misses_after"] == 0

    def test_strict_recovery_rejects_mesh_shape_mismatch(self, ctx):
        """``recover(cross_mesh=False)`` fails pending work journaled at
        "model=2" on an unsharded engine, durably, with no mesh_reshard
        record."""
        got = _pairs_agree(ctx, "strict")
        assert got == {"pending": 1, "replayed": 0, "invalid": 1,
                       "cross_mesh": 0, "pending_after": 0,
                       "reshards": 0}


# ---------------------------------------------------------------------------
# fleet shard groups
# ---------------------------------------------------------------------------

class TestShardGroups:
    def test_hot_swap_rolls_groups_with_flat_misses(self, ctx):
        """Two shard groups of two ranks each (disjoint) serve, the
        streams reaching every rank's callbacks; a rolling
        update_weights drains and swaps one group at a time with every
        group's compile misses flat; traffic after the roll serves the new
        weights' greedy stream.  Every rank's fleet saw the same."""
        got = _pairs_agree(ctx, "fleet")
        assert got["states"] == ["finished"] * 4
        # every rank's callback saw each stream, token by token
        assert got["streamed"] == got["outs"]
        assert got["shapes"] == ["model=2", "model=2"]
        g0, g1 = got["groups"]
        assert set(g0).isdisjoint(g1)
        assert got["mp"] == [2, 2]
        assert got["version"] == 1
        assert got["misses_flat"]
        assert got["post"] == "finished" and got["post_chain"]

    def test_shard_group_validation(self):
        """The JAX package's refusals, in a world of one: a width below 1,
        more ranks than the world holds, a mesh through engine kwargs."""
        from paddle_tpu_torch.serving import Fleet, serving_mesh

        with pytest.raises(ValueError, match="shards_per_group"):
            Fleet(gpt_tiny(), num_replicas=2, shards_per_group=0,
                  device="cpu")
        with pytest.raises(ValueError, match="devices"):
            Fleet(gpt_tiny(), num_replicas=8, shards_per_group=2,
                  device="cpu")
        with pytest.raises(ValueError, match="fleet-managed"):
            Fleet(gpt_tiny(), num_replicas=1, mesh=object(), device="cpu")
        with pytest.raises(ValueError, match="devices"):
            serving_mesh(2, device="cpu")


# ---------------------------------------------------------------------------
# one decision stream across the ranks
# ---------------------------------------------------------------------------

class TestOneDecisionStream:
    def test_tensor_parallel_layers_match_whole_layers(self, ctx):
        """Column (gathered, and fused in two parts), row (bias once,
        after the reduce) and vocabulary (ids at both shards' edges)
        layers at mp 2 against the whole nn layers, f32 (N(0, 1) weights
        and inputs: the row layer's two half sums round apart, within
        ATOL; the others are exact)."""
        got = _pairs_agree(ctx, "layers")
        assert got["column"] == got["fused"] == got["vocab"] == 0.0, got
        assert got["row"] <= ATOL, got

    def test_decisions_read_rank_zeros_clock(self, ctx):
        """With rank 1's clock 1000 s ahead and a 30 s deadline, no rank
        fails a request: deadlines, reaping and shedding read rank 0's
        clock, and the streams are the single-chip ones."""
        got = _pairs_agree(ctx, "skewed_clock")
        assert got["states"] == ["finished"] * 3
        assert got["outs"] == ctx["jax"]["baseline"][("gpt", "paged")]

    def test_divergence_raises_and_unhealthy_spreads(self, ctx):
        got = _pairs_agree(ctx, "divergence")
        assert got == {"diverged": True, "stopped": "unhealthy"}


# ---------------------------------------------------------------------------
# plumbing validation
# ---------------------------------------------------------------------------

class TestShardingPlumbing:
    def test_serving_mesh_validation(self, ctx):
        from paddle_tpu_torch.serving import serving_mesh

        with pytest.raises(ValueError, match=">= 1"):
            serving_mesh(0, device="cpu")
        with pytest.raises(ValueError, match="devices"):
            serving_mesh(1024, device="cpu")
        got = _pairs_agree(ctx, "plumbing")
        assert got["key"] == "model=2" and got["none"] is None

    def test_kv_head_divisibility_guard(self, ctx):
        """A mesh wider than the kv-head count is refused up front: a GQA
        group split over ranks would put a head's K/V apart from its
        queries."""
        got = _pairs_agree(ctx, "plumbing")
        assert got["guard"] is not None and "kv_heads" in got["guard"]

    def test_mesh_needs_model_axis(self, ctx):
        got = _pairs_agree(ctx, "plumbing")
        assert got["axis"] is not None and "'model' axis" in got["axis"]


# ---------------------------------------------------------------------------
# sharded tenancy (tests/test_tenancy.py::TestShardedTenancy)
# ---------------------------------------------------------------------------

class TestShardedTenancy:
    def test_mp2_bitwise_parity(self, ctx):
        """A model=2 tenancy engine (banks sharded with the layers they
        modify, a row target's delta added before the reduce; lanes and
        grammar tables whole) serves the single-chip tenancy engine's
        streams, port and JAX, for the base model, an adapter and the
        grammar, with no program built after warmup; its logits under
        adapter rows are the unsharded port's within ATOL."""
        got = _pairs_agree(ctx, "tenancy")
        mp1, mp2 = got["mp1"], got["mp2"]
        for key in ("base", "t1", "json"):
            assert mp2[key] == mp1[key] == ctx["jax"]["tenancy"][key], key
        assert mp2["t1"] != mp2["base"]
        assert mp2["misses_after"] == 0
        assert mp2["sharding"] == {"mesh_shape": "model=2",
                                   "model_parallel": 2}
        assert mp2["adapters"] == {"t1": 1, "t2": 1}
        assert got["logits_err"] <= ATOL


# ---------------------------------------------------------------------------
# weights: shards against the JAX device shards
# ---------------------------------------------------------------------------

def _jax_shards(model, mp):
    """Each parameter's ``mp`` device shards, in mesh order, after the JAX
    package places the model on ``serving_mesh(mp)``."""
    from paddle_tpu.serving import serving_mesh as jax_mesh
    from paddle_tpu.serving.sharding import ServingShard as JaxShard

    mesh = jax_mesh(mp)
    cfg = model.config
    kv = getattr(cfg, "n_kv_heads", None) or cfg.num_attention_heads
    JaxShard(mesh, kv_heads=kv,
             num_heads=cfg.num_attention_heads).place_model(model)
    devices = list(mesh.devices.flat)
    out = {}
    for name, p in model.state_dict().items():
        arr = p._value()
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        out[name] = [by_dev[d] for d in devices]
    return out


@pytest.mark.parametrize("tag", ["gpt", "llama"])
def test_shard_state_dict_matches_jax_device_shards(ctx, tag):
    """Rank r's ``shard_state_dict`` tensor is the JAX device shard r
    (transposed as ``convert.py`` transposes a linear weight) for every
    parameter whose layout agrees; ``gate_up_proj`` holds gate's r-th
    slice then up's r-th slice (the port's layout, ROADMAP.md C)."""
    src = ctx["jax_models"][tag]
    model = type(src)(src.config)
    model.eval()
    model.set_state_dict(src.state_dict())
    shards = _jax_shards(model, 2)
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in ctx["inputs"][tag].items()}
    shell = _FAMILIES[tag][0](_FAMILIES[tag][1](), device="meta")
    linear = {f"{n}.weight" for n, m in shell.named_modules()
              if isinstance(m, torch.nn.Linear)}
    checked = 0
    for r in range(2):
        mine = shard_state_dict(sd, r, 2)
        for name, t in mine.items():
            if name.endswith("gate_up_proj.weight"):
                whole = sd[name]
                f = whole.shape[0] // 2
                n = f // 2
                want = torch.cat([whole[r * n:(r + 1) * n],
                                  whole[f + r * n:f + (r + 1) * n]])
                assert torch.equal(t, want), name
                continue
            jax_shard = shards[name][r]
            if name in linear:
                jax_shard = jax_shard.T
            np.testing.assert_array_equal(t.numpy(), jax_shard,
                                          err_msg=name)
            checked += shard_rule(name) is not None
    assert checked > 0


@pytest.mark.parametrize("tag", ["gpt", "llama"])
@pytest.mark.parametrize("mp", [2, 4])
def test_shards_round_trip_bitwise(ctx, tag, mp):
    """``unshard_state_dict`` of every rank's shard is the whole state
    dict, bitwise; a split tensor's shards are disjoint copies."""
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in ctx["inputs"][tag].items()}
    shards = [shard_state_dict(sd, r, mp) for r in range(mp)]
    back = unshard_state_dict(shards)
    assert set(back) == set(sd)
    for name in sd:
        assert torch.equal(back[name], sd[name]), name
        if shard_rule(name) is not None:
            assert shards[0][name].numel() * mp == sd[name].numel()
