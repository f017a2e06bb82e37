"""Multi-tenant serving of the port against the JAX package's, on the CPU.

Every case of ``tests/test_tenancy.py`` but ``TestShardedTenancy`` (the
mesh is not ported) has a counterpart here held to the JAX engine, at its
scale (``gpt_tiny``, 2 slots, ``max_seq`` 32, bucket 16, block 8, two
adapters of rank 4 at ``init_scale`` 0.5, the bounded JSON grammar with
eos 1).  The JAX model is built from a seed and its numpy state dict is
loaded into the port (``models/convert.py``); the adapters come from
``make_lora_weights`` at the same seeds, which draws the same numpy
factors in both packages.  Greedy streams are compared exactly (argmaxes
of f32 logits that agree to ~1e-6); logits under adapter rows agree
within ``ATOL`` (1e-5, f32); sampled streams are held to the grammar's
host oracle only (the two packages' noise differs by design).  The JAX
engines are module-scoped and their reference streams recorded once.

Module parity: the grammar tables (element for element, at the tiny
vocabulary and at Llama's), the adapter banks' keys (GPT and Llama) and
``make_lora_weights``' factors, the prefix cache's salted chain keys, the
grammar-masked speculative acceptance.  Cross-package: a tenant journal
written by either engine is recovered by the other.
"""
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu import to_tensor
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import gpt as jax_gpt, llama as jax_llama
from paddle_tpu.obs import render_metrics as jax_render
from paddle_tpu.serving import (
    Engine as JaxEngine, JsonArrayGrammar as JaxJson,
    RequestJournal as JaxJournal, make_lora_weights as jax_lora,
)
from paddle_tpu.serving.adapters import AdapterPool as JaxPool
from paddle_tpu.serving.grammar import GrammarTable as JaxTable
from paddle_tpu.serving.prefix_cache import PrefixCache as JaxPrefix
from paddle_tpu.serving.sampling import DeviceSampler as JaxSampler
from paddle_tpu_torch import create_engine
from paddle_tpu_torch.models import (
    GPTConfig, GPTForCausalLM, LlamaForCausalLM, from_jax_state_dict,
    gpt_tiny, llama_tiny,
)
from paddle_tpu_torch.obs import render_metrics
from paddle_tpu_torch.serving import (
    AdapterPool, DeviceSampler, Engine, GrammarTable, JsonArrayGrammar,
    PrefixCache, RequestJournal, SamplingParams, SpecConfig,
    make_lora_weights,
)

torch.set_num_threads(2)

ENG = dict(num_slots=2, max_seq=32, min_bucket=16)
PAGED = dict(kv_layout="paged", block_size=8)
SPEC = JsonArrayGrammar(eos_token_id=1, max_elems=3, max_digits=2)
JSPEC = JaxJson(eos_token_id=1, max_elems=3, max_digits=2)
ADAPTERS = dict(max_adapters=2, rank=4)
TEN = dict(adapters=ADAPTERS, grammars={"json": SPEC})
JTEN = dict(adapters=ADAPTERS, grammars={"json": JSPEC})
SCALE = 0.5
#: f32 logits of the two packages under adapter rows
ATOL = 1e-5
A1 = SamplingParams(adapter="t1")
A2 = SamplingParams(adapter="t2")
G = SamplingParams(grammar="json")

rs = np.random.RandomState(0)
PROMPTS = [rs.randint(0, 128, (L,)).tolist() for L in (5, 13, 9)]
#: a prompt of bucket 32 (past the 16 of a partial warmup)
LONG = rs.randint(0, 128, (20,)).tolist()


def _load(eng, names=("t1", "t2"), lora=make_lora_weights):
    for i, name in enumerate(names, start=1):
        eng.load_adapter(name, lora(eng.adapter_pool, seed=i,
                                    init_scale=SCALE))


def _jload(eng, names=("t1", "t2")):
    _load(eng, names, lora=jax_lora)


def _jax_params(p: SamplingParams):
    """The same request parameters as the JAX package's dataclass."""
    from paddle_tpu.serving import SamplingParams as JaxParams

    return JaxParams(temperature=p.temperature, top_k=p.top_k,
                     top_p=p.top_p, seed=p.seed, adapter=p.adapter,
                     grammar=p.grammar)


def _generate(eng, prompts=PROMPTS, n=8, sampling=None, **kw):
    if sampling is not None and isinstance(eng, JaxEngine):
        sampling = _jax_params(sampling)
    reqs = [eng.add_request(p, max_new_tokens=n, sampling=sampling, **kw)
            for p in prompts]
    eng.run()
    assert all(r.finished for r in reqs), \
        [(r.state, r.error, r.error_ctx) for r in reqs]
    return [r.output_ids for r in reqs]


def _warm(eng):
    eng.warmup()
    return eng


@pytest.fixture(scope="module", autouse=True)
def _single_device():
    """The JAX side runs unsharded.  An earlier test file in the same
    worker may leave fleet's hybrid mesh set (model axis > 1)."""
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _pair(jax_cls, jax_cfg, seed, port_cls, port_cfg):
    """A JAX model from ``seed`` and the port's on its weights."""
    paddle.seed(seed)
    jm = jax_cls(jax_cfg)
    jm.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return jm, from_jax_state_dict(port_cls(port_cfg, device="cpu"), sd)


def _gpt_pair(seed=0):
    return _pair(jax_gpt.GPTForCausalLM, jax_gpt.gpt_tiny(), seed,
                 GPTForCausalLM, gpt_tiny(hidden_dropout_prob=0.0,
                                          attention_probs_dropout_prob=0.0))


def _llama_pair(seed=0):
    return _pair(jax_llama.LlamaForCausalLM, jax_llama.llama_tiny(), seed,
                 LlamaForCausalLM, llama_tiny())


@pytest.fixture(scope="module")
def gpt():
    return _gpt_pair()


@pytest.fixture(scope="module")
def ref(gpt):
    """The JAX engines' streams, recorded once: a plain engine (no lane
    compiled) and the paged tenancy engine with both adapters, on the
    scenarios the port's cases replay."""
    plain = _warm(JaxEngine(gpt[0], **ENG))
    ten = _warm(JaxEngine(gpt[0], **ENG, **PAGED, **JTEN,
                          max_preemptions=2, priority_aging_s=30.0))
    _jload(ten)
    out = {"base": _generate(plain), "ten_base": _generate(ten),
           "t1": _generate(ten, sampling=A1),
           "t2": _generate(ten, sampling=A2),
           "json": _generate(ten, n=SPEC.max_tokens, sampling=G),
           "t1_long": _generate(ten, prompts=[LONG], n=6, sampling=A1)}
    rb = ten.add_request(PROMPTS[0], max_new_tokens=8)
    rt = ten.add_request(PROMPTS[1], max_new_tokens=8,
                         sampling=_jax_params(A1))
    ten.run()
    out["mixed"] = [rb.output_ids, rt.output_ids]
    out["snapshot"] = ten.stats()
    return out


@pytest.fixture(scope="module")
def plain(gpt):
    """The port's plain engine: no lane."""
    return _warm(Engine(gpt[1], **ENG))


@pytest.fixture(scope="module")
def ten(gpt):
    """The port's workhorse: paged tenancy engine, both adapters loaded,
    preemption armed."""
    eng = _warm(Engine(gpt[1], **ENG, **PAGED, **TEN, max_preemptions=2,
                       priority_aging_s=30.0))
    _load(eng)
    return eng


# ---------------------------------------------------------------------------
# lanes off: bitwise the plain engine
# ---------------------------------------------------------------------------

class TestAdapterOffBitwise:
    @pytest.mark.parametrize("layout", ["paged", "contiguous"])
    def test_lanes_off_equals_plain_engine(self, gpt, plain, ref, layout):
        """Adapters loaded, none selected: the streams of the engine with
        no lane, in both layouts, and the JAX engines' (plain and
        tenancy)."""
        base = _generate(plain)
        assert base == ref["base"] == ref["ten_base"]
        extra = PAGED if layout == "paged" else {}
        eng = _warm(create_engine(gpt[1], device="cpu", **ENG, **extra,
                                  **TEN))
        _load(eng)
        m0 = eng.metrics.compile_misses
        assert _generate(eng) == base
        assert eng.metrics.compile_misses == m0
        assert eng.stats()["tenancy"] == {
            "adapters": {"t1": 1, "t2": 1}, "adapter_lanes": 2,
            "grammars": ["json"]}

    @pytest.mark.parametrize("family", ["gpt", "llama"])
    def test_adapter_rows_logits_match_jax(self, family):
        """One forward with rows ``[1, 0, 2]`` (t1, base, t2) on fresh
        models of each family: the logits agree with the JAX model's
        within ATOL, and the base row is bitwise the forward without
        rows."""
        jm, pm = (_gpt_pair if family == "gpt" else _llama_pair)(seed=5)
        names = list(pm.state_dict())
        jpool, ppool = JaxPool(jm, 3, rank=4), AdapterPool(pm, 3, rank=4)
        for i, name in enumerate(("t1", "t2"), start=1):
            jpool.load(name, jax_lora(jpool, seed=i, init_scale=SCALE))
            ppool.load(name, make_lora_weights(ppool, seed=i,
                                               init_scale=SCALE))
        ids = np.random.RandomState(4).randint(0, 128, (3, 7))
        rows = [1, 0, 2]
        jpool.set_rows(jnp.asarray(rows, dtype=jnp.int32))
        want = np.asarray(jm(to_tensor(ids)).numpy())
        jpool.clear_rows()
        with torch.no_grad():
            base = pm(torch.from_numpy(ids))
            ppool.set_rows(torch.tensor(rows, dtype=torch.int32))
            got = pm(torch.from_numpy(ids))
            ppool.clear_rows()
            again = pm(torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        assert torch.equal(got[1], base[1])
        assert not torch.allclose(got[0], base[0], atol=1e-3)
        assert torch.equal(again, base)          # no rows: the identity
        # the pool's tensors are its own: the model's names are as before
        assert list(pm.state_dict()) == names


# ---------------------------------------------------------------------------
# tenant isolation
# ---------------------------------------------------------------------------

class TestTenantIsolation:
    def test_adapters_differ_and_mixed_batch_is_clean(self, ten, ref):
        m0 = ten.metrics.compile_misses
        a1 = _generate(ten, sampling=A1)
        a2 = _generate(ten, sampling=A2)
        assert a1 == ref["t1"] and a2 == ref["t2"]
        assert a1 != ref["base"] and a2 != ref["base"] and a1 != a2
        # a base and an adapter request in one decode batch: the base row
        # stays bitwise (the where-select guards it)
        rb = ten.add_request(PROMPTS[0], max_new_tokens=8)
        rt = ten.add_request(PROMPTS[1], max_new_tokens=8, sampling=A1)
        ten.run()
        assert rb.output_ids == ref["base"][0]
        assert rt.output_ids == a1[1]
        assert [rb.output_ids, rt.output_ids] == ref["mixed"]
        assert ten.metrics.compile_misses == m0
        snap = ten.stats()
        by = snap["tenants"]["by_tenant"]
        assert by["t1"]["completed"] >= 1 and by["t2"]["completed"] >= 1
        assert by["base"]["completed"] >= 1
        assert by["t1"]["ttft_ms"]["p50"] > 0
        assert by["t1"]["tokens"] >= 8 * len(PROMPTS)
        # the section's shape is the JAX engine's
        jsec = ref["snapshot"]["tenants"]
        assert set(snap["tenants"]) == set(jsec)
        assert set(by["t1"]) == set(jsec["by_tenant"]["t1"])
        assert set(by["t1"]["ttft_ms"]) == \
            set(jsec["by_tenant"]["t1"]["ttft_ms"])
        assert snap["tenants"]["adapter_loads"] == 2

    def test_tenants_render_as_the_jax_package_does(self, ten, ref):
        """The Prometheus text of the tenants section: the JAX package's
        metric names for the tenants both engines served."""
        def names(text, tenants):
            return {line.split("{")[0] for line in text.splitlines()
                    if line.startswith("paddle_tpu_serving_tenants_")
                    and ("by_tenant" not in line
                         or any(f"by_tenant_{t}_" in line for t in tenants))}

        _generate(ten, prompts=PROMPTS[:1], sampling=A1)
        common = ("t1", "base")
        got = names(render_metrics(ten.stats()), common)
        want = names(jax_render(ref["snapshot"]), common)
        assert got == want
        assert "paddle_tpu_serving_tenants_adapter_loads" in got
        assert "paddle_tpu_serving_tenants_by_tenant_t1_ttft_ms_p99" in got

    def test_two_pools_on_one_model_stay_apart(self, gpt, ref):
        """Two tenancy engines over one model: each pool's hooks serve
        only its own engine's rows, so a program the first engine builds
        after the second engine's pool exists still reads the first
        pool's lanes (the JAX package's pool replaces the layers' one
        hook; ROADMAP.md C.5)."""
        e1 = Engine(gpt[1], **ENG, **PAGED, **TEN)
        e1.warmup(buckets=[16])
        _load(e1, names=("t1",))
        e2 = _warm(Engine(gpt[1], **ENG, **PAGED, **TEN))   # t1 not loaded
        m0 = e1.metrics.compile_misses
        assert _generate(e1, prompts=[LONG], n=6, sampling=A1) == \
            ref["t1_long"]
        assert e1.metrics.compile_misses == m0 + 1    # bucket 32, built now
        assert _generate(e2, prompts=[LONG], n=6) != ref["t1_long"]

    def test_prefix_domains_disjoint_per_adapter(self, ten):
        """One prompt, three salt domains: K/V registered under one
        tenant is invisible to every other."""
        prompt = np.random.RandomState(11).randint(0, 128, (16,)).tolist()
        _generate(ten, prompts=[prompt], n=4, sampling=A1)
        assert ten.prefix_probe(prompt, adapter="t1") > 0
        assert ten.prefix_probe(prompt) == 0
        assert ten.prefix_probe(prompt, adapter="t2") == 0
        assert ten.prefix_probe(prompt, adapter="nope") == 0
        _generate(ten, prompts=[prompt], n=4)
        assert ten.prefix_probe(prompt) > 0


# ---------------------------------------------------------------------------
# constrained decoding
# ---------------------------------------------------------------------------

class TestGrammar:
    def test_greedy_emits_valid_json(self, ten, ref):
        m0 = ten.metrics.compile_misses
        outs = _generate(ten, n=SPEC.max_tokens, sampling=G)
        assert outs == ref["json"]
        for o in outs:
            assert SPEC.accepts(o, 128), o
        assert ten.metrics.compile_misses == m0

    def test_masks_compose_with_sampling_laws(self, ten):
        """Masks under temperature and top-k (the mask applies before the
        law) and under top-p: still valid JSON."""
        for law in (SamplingParams(grammar="json", temperature=0.8,
                                   top_k=8, seed=3),
                    SamplingParams(grammar="json", temperature=1.0,
                                   top_p=0.9, seed=4)):
            for o in _generate(ten, n=SPEC.max_tokens, sampling=law):
                assert SPEC.accepts(o, 128), o

    def test_validation_rejects_unknown_tenants(self, gpt, ten):
        with pytest.raises(ValueError, match="not loaded"):
            ten.add_request(PROMPTS[0], max_new_tokens=4,
                            sampling=SamplingParams(adapter="nope"))
        with pytest.raises(ValueError, match="grammar"):
            ten.add_request(PROMPTS[0], max_new_tokens=4,
                            sampling=SamplingParams(grammar="yaml"))
        with pytest.raises(ValueError, match="eos token 1"):
            ten.add_request(PROMPTS[0], max_new_tokens=4, eos_token_id=7,
                            sampling=G)
        with pytest.raises(ValueError, match="adapter"):
            Engine(gpt[1], **ENG).add_request(PROMPTS[0], max_new_tokens=4,
                                              sampling=A1)
        with pytest.raises(ValueError, match="grammar table"):
            Engine(gpt[1], **ENG).add_request(PROMPTS[0], max_new_tokens=4,
                                              sampling=G)
        with pytest.raises(ValueError, match="name"):
            SamplingParams(adapter=3)
        # a grammar request stops at the grammar's eos by default
        r = ten.add_request(PROMPTS[0], max_new_tokens=4, sampling=G)
        assert r.eos_token_id == 1 and r.tenant == "grammar:json"
        ten.run()


# ---------------------------------------------------------------------------
# speculative decoding with masks and adapters
# ---------------------------------------------------------------------------

def _draft():
    cfg = dict(vocab_size=128, hidden_size=32, num_hidden_layers=1,
               num_attention_heads=2, max_position_embeddings=64,
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    gen = torch.Generator().manual_seed(7)
    return GPTForCausalLM(GPTConfig(**cfg), device="cpu",
                          generator=gen).eval()


class TestSpeculativeTenancy:
    def test_spec_greedy_bitwise_all_classes(self, gpt, ten, ref):
        """A speculating tenancy engine (independent 1-layer draft, so
        proposals are rejected) gives the non-speculative greedy streams
        for base, adapter and grammar requests: the masks apply to both
        laws, the adapters to the target only."""
        eng = _warm(Engine(gpt[1], **ENG, **PAGED, **TEN,
                           speculation=SpecConfig(draft_model=_draft(),
                                                  k=3)))
        _load(eng)
        m0 = eng.metrics.compile_misses
        assert _generate(eng) == _generate(ten) == ref["base"]
        assert _generate(eng, sampling=A1) == ref["t1"]
        assert _generate(eng, n=SPEC.max_tokens, sampling=G) == ref["json"]
        assert eng.metrics.compile_misses == m0
        st = eng.stats()["speculation"]
        assert st["rounds"] > 0 and st["accept_rate"] < 1.0

    @pytest.mark.parametrize("kw", ["adapters", "grammars"])
    def test_draft_shares_tenancy_lanes(self, gpt, kw):
        """Either tenancy lane alone builds a speculating engine: the draft
        sampler masks with the engine's grammar table, and the verify runs
        under the engine's adapter pool (the draft under none)."""
        eng = Engine(gpt[1], **ENG, **{kw: TEN[kw]},
                     speculation=SpecConfig(draft_model=_draft(), k=3))
        assert eng.spec.sampler.grammar is eng.sampler.grammar
        assert (eng.sampler.grammar is not None) == (kw == "grammars")
        assert eng.spec.target_pool is eng.adapter_pool
        assert (eng.adapter_pool is not None) == (kw == "adapters")

    def test_spec_sampled_json_is_valid(self, gpt):
        """Seeded sampled grammar requests through speculative rounds:
        every stream is accepted by the oracle, and replays the same."""
        eng = _warm(Engine(gpt[1], **ENG, **TEN,
                           speculation=SpecConfig(draft_model=_draft(),
                                                  k=3)))
        law = SamplingParams(grammar="json", temperature=0.9, seed=11)
        a = _generate(eng, n=SPEC.max_tokens, sampling=law)
        assert all(SPEC.accepts(o, 128) for o in a), a
        assert _generate(eng, n=SPEC.max_tokens, sampling=law) == a

    def test_masked_acceptance_matches_jax(self):
        """Greedy acceptance over a masked window: the emitted tokens,
        the counts and the folded automaton states of both packages."""
        S, k, V = 3, 3, 128
        rs = np.random.RandomState(2)
        tl = rs.randn(S, k + 1, V).astype(np.float32)
        dl = rs.randn(S, k + 1, V).astype(np.float32)
        # proposals: a legal walk for the json slots, noise elsewhere
        props = np.array([[91, 49, 44], [91, 93, 1], [5, 6, 7]],
                         dtype=np.int32)
        cap = np.array([4, 4, 2], dtype=np.int32)
        gids = np.array([1, 1, 0], dtype=np.int32)
        jt = JaxTable(V, {"json": JSPEC})
        pt = GrammarTable(V, {"json": SPEC}, device="cpu")
        js, jd = JaxSampler(S, grammar=jt), JaxSampler(S, grammar=jt)
        ps = DeviceSampler(S, device="cpu", grammar=pt)
        pd = DeviceSampler(S, device="cpu", grammar=pt)
        for smp in (js, jd):
            smp.grammar_ids._set_data(jnp.asarray(gids))
        for smp in (ps, pd):
            smp.grammar_ids.copy_(torch.from_numpy(gids))
        j_em, j_m = js.accept_speculative(
            jnp.asarray(tl), jnp.asarray(dl), jnp.asarray(props),
            jnp.asarray(cap), jd)
        p_em, p_m = ps.accept_speculative(
            torch.from_numpy(tl), torch.from_numpy(dl),
            torch.from_numpy(props), torch.from_numpy(cap),
            torch.ones(S, dtype=torch.int32), pd)
        m = np.asarray(j_m)
        assert p_m.numpy().tolist() == m.tolist()
        for s in range(S):
            assert p_em[s, :m[s]].tolist() == \
                np.asarray(j_em)[s, :m[s]].tolist()
        want = np.asarray(js.grammar_states._value())
        assert ps.grammar_states.numpy().tolist() == want.tolist()
        assert torch.equal(pd.grammar_states, ps.grammar_states)


# ---------------------------------------------------------------------------
# preemption, step retries, crash recovery, unload and hot swap
# ---------------------------------------------------------------------------

class TestTenantDurability:
    def test_preempted_tenant_resumes_bitwise(self, ten, ref):
        want = ref["t1"][:2]
        m0 = ten.metrics.compile_misses
        lo = [ten.add_request(p, max_new_tokens=8, priority="low",
                              sampling=A1) for p in PROMPTS[:2]]
        ten.step()
        ten.step()
        assert all(r.state == "running" for r in lo)
        hi = ten.add_request(PROMPTS[2], max_new_tokens=4, priority="high")
        ten.run()
        assert any(r.preempted for r in lo) and hi.finished
        assert [r.output_ids for r in lo] == want
        assert ten.metrics.compile_misses == m0

    @pytest.mark.parametrize("spec", [False, True], ids=["decode", "round"])
    def test_retry_with_grammar_in_flight(self, gpt, ref, spec):
        """Programs failing before and after they ran, with a grammar and
        an adapter request in flight: the retries rebuild the automaton
        state from the emitted tokens (the draft's too, in a round), and
        every stream is the one served alone."""
        kw = {} if not spec else dict(speculation=SpecConfig(
            draft_model=_draft(), k=3))
        eng = _warm(Engine(gpt[1], **ENG, **PAGED, **TEN, **kw))
        _load(eng, names=("t1",))
        run, calls = eng.programs.run, {}
        step_kind = "verify" if spec else "decode"
        faults = {("prefill", 2): "after", (step_kind, 2): "before",
                  (step_kind, 4): "after"}

        def flaky(key, body, *inputs):
            calls[key[0]] = calls.get(key[0], 0) + 1
            when = faults.get((key[0], calls[key[0]]))
            if when == "before":
                raise RuntimeError(f"injected fault before {key}")
            out = run(key, body, *inputs)
            if when == "after":
                raise RuntimeError(f"injected fault after {key}")
            return out

        eng.programs.run = flaky
        try:
            rg = eng.add_request(PROMPTS[1], max_new_tokens=SPEC.max_tokens,
                                 sampling=G)
            ra = eng.add_request(PROMPTS[0], max_new_tokens=8, sampling=A1)
            eng.run()
        finally:
            del eng.programs.run
        retries = eng.stats()["failures"]["retries_by_point"]
        assert sum(retries.values()) == 3, retries
        assert rg.finished and ra.finished
        assert rg.output_ids == ref["json"][1]
        assert ra.output_ids == ref["t1"][0]

    def test_crash_recovery_replays_tenant_bitwise(self, gpt, tmp_path):
        path = str(tmp_path / "journal")
        e1 = _warm(Engine(gpt[1], **ENG, **TEN,
                          journal=RequestJournal(path)))
        _load(e1, names=("t1",))
        want = _generate(e1, prompts=[PROMPTS[0]], sampling=A1)[0]
        gwant = _generate(e1, prompts=[PROMPTS[1]], n=SPEC.max_tokens,
                          sampling=G)[0]
        r1 = e1.add_request(PROMPTS[0], max_new_tokens=8, sampling=A1)
        e1.add_request(PROMPTS[1], max_new_tokens=SPEC.max_tokens,
                       sampling=G)
        e1.step()                      # in flight, then "crash"
        assert r1.adapter_version == 1
        e1.journal.close()

        e2 = _warm(Engine(gpt[1], **ENG, **TEN,
                          journal=RequestJournal(path)))
        _load(e2, names=("t1",))
        res = e2.recover()
        assert res["replayed"] == 2 and not res["invalid"]
        m0 = e2.metrics.compile_misses
        e2.run()
        outs = {tuple(r.prompt_ids): r.output_ids for r in res["requests"]}
        assert outs[tuple(PROMPTS[0])] == want
        assert outs[tuple(PROMPTS[1])] == gwant
        assert e2.metrics.compile_misses == m0

        # the adapter gone from the recovering engine: the replay fails
        # finally (the journal converges) instead of serving other weights
        e2.journal.close()
        e3 = _warm(Engine(gpt[1], **ENG, **TEN,
                          journal=RequestJournal(path)))
        _load(e3, names=("t1",))
        e3.add_request(PROMPTS[0], max_new_tokens=8, sampling=A1)
        e3.step()
        e3.journal.close()
        e4 = _warm(Engine(gpt[1], **ENG, **TEN,
                          journal=RequestJournal(path)))
        res = e4.recover()             # t1 deliberately not loaded
        assert len(res["invalid"]) == 1 and res["replayed"] == 0
        assert not e4.journal.pending()

    def test_unload_fails_inflight_with_error_ctx(self, gpt):
        eng = _warm(Engine(gpt[1], **ENG, **TEN))
        _load(eng, names=("t1",))
        lanes = [(b.A.data_ptr(), b.B.data_ptr())
                 for b in eng.adapter_pool.banks.values()]
        m0 = eng.metrics.compile_misses
        r = eng.add_request(PROMPTS[0], max_new_tokens=20, sampling=A1)
        eng.step()
        eng.step()
        assert r.state == "running"
        eng.unload_adapter("t1")
        assert r.state == "failed"
        assert r.error_ctx == {"adapter": "t1", "version": 1}
        # a hot swap (a load over a live name) fails its requests too
        _load(eng, names=("t1",))
        r2 = eng.add_request(PROMPTS[0], max_new_tokens=20, sampling=A1)
        eng.step()
        eng.load_adapter("t1", make_lora_weights(
            eng.adapter_pool, seed=9, init_scale=SCALE))
        assert r2.state == "failed"
        assert r2.error_ctx == {"adapter": "t1", "version": 2}
        # the engine is unharmed: base traffic still serves ...
        assert _generate(eng, prompts=[PROMPTS[2]], n=4)[0]
        # ... and the new version under a new pin
        r3 = eng.add_request(PROMPTS[0], max_new_tokens=4, sampling=A1)
        eng.run()
        assert r3.finished and r3.adapter_version == 3
        # in place: no lane moved and no program was built
        assert [(b.A.data_ptr(), b.B.data_ptr())
                for b in eng.adapter_pool.banks.values()] == lanes
        assert eng.metrics.compile_misses == m0
        snap = eng.stats()
        assert snap["tenants"]["adapter_loads"] == 3
        assert snap["tenants"]["adapter_unloads"] == 1
        assert snap["tenants"]["by_tenant"]["t1"]["failed"] == 2
        with pytest.raises(KeyError, match="not loaded"):
            eng.unload_adapter("nope")
        with pytest.raises(RuntimeError, match="no adapter pool"):
            Engine(gpt[1], **ENG).load_adapter("t1", {})

    def test_queued_request_fails_at_admission_after_swap(self, gpt):
        """A request queued at v1 and admitted after a swap to v2 fails
        at its admission with the pinned version in ``error_ctx``; one
        queued behind a full engine while its adapter is unloaded fails
        at once."""
        eng = _warm(Engine(gpt[1], **ENG, **TEN))
        _load(eng, names=("t1",))
        q = eng.add_request(PROMPTS[0], max_new_tokens=4, sampling=A1)
        eng.adapter_pool.load("t1", make_lora_weights(
            eng.adapter_pool, seed=5, init_scale=SCALE))
        eng.run()
        assert q.state == "failed" and "hot-swapped" in q.error
        assert q.error_ctx == {"adapter": "t1", "version": 1}
        busy = [eng.add_request(p, max_new_tokens=6) for p in PROMPTS[:2]]
        eng.step()
        w = eng.add_request(PROMPTS[2], max_new_tokens=4, sampling=A1)
        eng.unload_adapter("t1")
        assert w.state == "failed" and "while queued" in w.error
        eng.run()
        assert all(b.finished for b in busy)


# ---------------------------------------------------------------------------
# the journal across packages
# ---------------------------------------------------------------------------

def _crash_tenants(eng):
    """On a warm contiguous tenancy engine with ``t1`` loaded: the
    uninterrupted t1 and json streams, then the same two requests
    admitted and abandoned after one step.  Returns the streams."""
    a1, g = A1, G
    if isinstance(eng, JaxEngine):
        a1, g = _jax_params(A1), _jax_params(G)
    want = _generate(eng, prompts=[PROMPTS[0]], sampling=A1)[0]
    gwant = _generate(eng, prompts=[PROMPTS[1]], n=SPEC.max_tokens,
                      sampling=G)[0]
    eng.add_request(PROMPTS[0], max_new_tokens=8, sampling=a1)
    eng.add_request(PROMPTS[1], max_new_tokens=SPEC.max_tokens, sampling=g)
    eng.step()
    eng.journal.close()
    return [want, gwant]


def _recovered(eng, path):
    res = eng.recover(journal=(JaxJournal if isinstance(eng, JaxEngine)
                               else RequestJournal)(path))
    eng.run()
    assert not res["invalid"] and res["replayed"] == 2
    assert all(r.recovered for r in res["requests"])
    assert not eng.journal.pending()
    return [r.output_ids for r in res["requests"]]


def test_tenant_journal_recovered_across_packages(gpt, tmp_path):
    """A tenant journal (a t1 request and a json request, abandoned
    mid-decode) written by the JAX engine recovers on the port's engine
    with the JAX engine's uninterrupted streams, and one written by the
    port's recovers on the JAX engine with the port's."""
    jeng = _warm(JaxEngine(gpt[0], **ENG, **JTEN))
    _jload(jeng, names=("t1",))
    # the JAX engine recovers the port's journal first (a recovering
    # engine is idle), then journals its own crash
    peng = _warm(Engine(gpt[1], **ENG, **TEN,
                        journal=RequestJournal(str(tmp_path / "port"))))
    _load(peng, names=("t1",))
    port_streams = _crash_tenants(peng)
    assert _recovered(jeng, str(tmp_path / "port")) == port_streams
    jeng.journal.close()
    jeng.journal = JaxJournal(str(tmp_path / "jax"))
    jax_streams = _crash_tenants(jeng)
    assert jax_streams == port_streams
    reader = _warm(Engine(gpt[1], **ENG, **TEN))
    _load(reader, names=("t1",))
    shutil.copytree(tmp_path / "jax", tmp_path / "jax_copy")
    assert _recovered(reader, str(tmp_path / "jax_copy")) == jax_streams
    assert os.path.isdir(tmp_path / "jax")


# ---------------------------------------------------------------------------
# module parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,eos", [(128, 1), (32000, 2)])
def test_grammar_tables_equal_jax(vocab, eos):
    specs = {"json": JsonArrayGrammar(eos_token_id=eos),
             "short": JsonArrayGrammar(eos_token_id=eos, max_elems=1,
                                       max_digits=1)}
    jspecs = {"json": JaxJson(eos_token_id=eos),
              "short": JaxJson(eos_token_id=eos, max_elems=1, max_digits=1)}
    pt = GrammarTable(vocab, specs, device="cpu")
    jt = JaxTable(vocab, jspecs)
    assert pt.names == jt.names and pt.max_states == jt.max_states
    np.testing.assert_array_equal(pt.trans.numpy(),
                                  np.asarray(jt.trans._value()))
    np.testing.assert_array_equal(pt.mask.numpy(),
                                  np.asarray(jt.mask._value()))
    np.testing.assert_array_equal(pt.trans_host, pt.trans.numpy())
    stream = [91, 55, 44, 48, 93, eos]
    assert specs["json"].accepts(stream, vocab) \
        == jspecs["json"].accepts(stream, vocab) is True
    assert pt.walk(pt.gid_of("json"), stream[:-1]) == 1
    # mask_rows and advance against the JAX table's
    rs = np.random.RandomState(vocab)
    logits = rs.randn(4, vocab).astype(np.float32)
    gids = np.array([0, 1, 2, 1], dtype=np.int32)
    sts = np.array([0, 2, 0, 5], dtype=np.int32)
    toks = np.array([3, 49, 91, 44], dtype=np.int32)
    got = pt.mask_rows(torch.from_numpy(logits), torch.from_numpy(gids),
                       torch.from_numpy(sts)).numpy()
    want = np.asarray(jt.mask_rows(jnp.asarray(logits), jnp.asarray(gids),
                                   jnp.asarray(sts)))
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(got[0], logits[0])     # grammar 0: bitwise
    np.testing.assert_array_equal(
        pt.advance(*(torch.from_numpy(a) for a in (gids, sts, toks)))
        .numpy(), np.asarray(jt.advance(jnp.asarray(gids), jnp.asarray(sts),
                                        jnp.asarray(toks))))


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_bank_keys_and_lora_weights_equal_jax(family):
    jm, pm = (_gpt_pair if family == "gpt" else _llama_pair)(seed=3)
    names = list(pm.state_dict())
    jpool, ppool = JaxPool(jm, 2, rank=4), AdapterPool(pm, 2, rank=4)
    assert list(ppool.banks) == list(jpool.banks)
    assert not any("lm_head" in k or "embed" in k for k in ppool.banks)
    for key, bank in ppool.banks.items():
        jb = jpool.banks[key]
        assert (bank.in_features, bank.out_features) == \
            (jb.in_features, jb.out_features)
        assert tuple(bank.A.shape) == tuple(jb.A.shape)
        assert tuple(bank.B.shape) == tuple(jb.B.shape)
    got, want = make_lora_weights(ppool, seed=4), jax_lora(jpool, seed=4)
    assert list(got) == list(want)
    for key in got:
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)
    # the pool leaves the model as it was: no parameter, no buffer
    assert list(pm.state_dict()) == names
    lane, version = ppool.load("a", got, scale=2.0)
    assert (lane, version) == (1, 1) and ppool.salt("a") == b"a@v1"
    key = next(iter(got))
    np.testing.assert_allclose(ppool.banks[key].B[1].numpy(),
                               got[key][1] * 2.0)
    assert ppool.load("a", got)[1] == 2 and ppool.unload("a") == 2
    assert not ppool.banks[key].A[1].any()
    assert ppool.load("a", got) == (1, 3)
    with pytest.raises(ValueError, match="cover"):
        ppool.load("b", {key: got[key]})


@pytest.mark.parametrize("salt", [b"", b"t1@v1", b"t1@v2"])
def test_prefix_chain_keys_equal_jax(salt):
    prompt = np.random.RandomState(9).randint(0, 128, (37,))
    port = PrefixCache(SimpleNamespace(), 8)
    jax_ = JaxPrefix(SimpleNamespace(), 8)
    for epoch in (0, 3):
        port.epoch = jax_.epoch = epoch
        assert port._keys_for(prompt, 4, salt) == \
            jax_._keys_for(prompt, 4, salt)
    assert port._keys_for(prompt, 4, salt) != \
        port._keys_for(prompt, 4, salt + b"x")
