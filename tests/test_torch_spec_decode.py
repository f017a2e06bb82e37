"""Speculative decoding of the port against the JAX package's, on the CPU.

Every case of ``tests/test_spec_decode.py`` has a counterpart here held to
the JAX engine, at its scale (k = 3, 2 slots, ``max_seq`` 32, bucket 16,
block 8).  The target and draft models are built in the JAX package from
seeds, and their numpy state dicts are loaded into the port through
``models/convert.py``.  Greedy streams are compared exactly (argmaxes of
f32 logits that agree to ~1e-6); the port's sampling noise is a counter
hash, not ``jax.random``, so sampled streams are held to the target law
and to same-seed replay within the port.  Module parity: the plain
``verify_attention`` and the flattened K4 route (K4's plain version on
CPU tensors) against the JAX ``verify_attention`` (f32, atol 1e-5), the
caches' verify writes, greedy acceptance (exact) and ``truncate_blocks``
(exact).
"""
import gc
import os
import tempfile
import weakref

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu import to_tensor
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import gpt as jax_gpt, llama as jax_llama
from paddle_tpu.serving import (
    Engine as JaxEngine, RequestJournal as JaxJournal,
    SpecConfig as JaxSpecConfig,
)
from paddle_tpu.serving.sampling import (
    DeviceSampler as JaxSampler, _device_masked_logits,
)
from paddle_tpu_torch.models import (
    GPTConfig, GPTForCausalLM, LlamaConfig, LlamaForCausalLM,
    from_jax_state_dict, gpt_tiny, llama_tiny,
)
from paddle_tpu_torch.obs import chrome_trace, render_metrics
from paddle_tpu_torch.ops import cached_attention as ca
from paddle_tpu_torch.serving import (
    DeviceSampler, Engine, KVCache, PagedKVCache, RequestJournal,
    RequestTracer, SamplingParams, SpecConfig, validate_trace,
)
from paddle_tpu_torch.serving.paging import SCRATCH_BLOCK
from paddle_tpu_torch.serving.sampling import masked_logits

torch.set_num_threads(2)

K = 3                      # draft tokens per round in every engine here
ENG = dict(num_slots=2, max_seq=32, min_bucket=16)
PAGED = dict(kv_layout="paged", block_size=8)
#: f32 attention outputs of the two packages
ATOL = 1e-5

rs = np.random.RandomState(0)
PROMPTS = [rs.randint(0, 128, (L,)).tolist() for L in (5, 13, 9, 3)]

GPT_DRAFT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=1,
                 num_attention_heads=2, max_position_embeddings=64,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
LLAMA_DRAFT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=1,
                   num_attention_heads=2, num_key_value_heads=1,
                   intermediate_size=64, max_position_embeddings=64)


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


@pytest.fixture(scope="module")
def gpt():
    return _pair(jax_gpt.GPTForCausalLM, jax_gpt.gpt_tiny(), 0,
                 GPTForCausalLM, gpt_tiny(hidden_dropout_prob=0.0,
                                          attention_probs_dropout_prob=0.0))


@pytest.fixture(scope="module")
def gpt_draft():
    # an independent 1-layer draft: proposals mostly rejected
    return _pair(jax_gpt.GPTForCausalLM, jax_gpt.GPTConfig(**GPT_DRAFT), 7,
                 GPTForCausalLM, GPTConfig(**GPT_DRAFT))


@pytest.fixture(scope="module")
def llama():
    return _pair(jax_llama.LlamaForCausalLM, jax_llama.llama_tiny(), 0,
                 LlamaForCausalLM, llama_tiny())


@pytest.fixture(scope="module")
def llama_draft():
    return _pair(jax_llama.LlamaForCausalLM,
                 jax_llama.LlamaConfig(**LLAMA_DRAFT), 9,
                 LlamaForCausalLM, LlamaConfig(**LLAMA_DRAFT))


def _warm(eng):
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def gpt_ref(gpt):
    """The port's non-speculative greedy oracle (contiguous)."""
    return _warm(Engine(gpt[1], **ENG))


@pytest.fixture(scope="module")
def gpt_spec_paged(gpt, gpt_draft):
    """The port's paged speculative GPT engine, traced."""
    return _warm(Engine(gpt[1], **ENG, **PAGED, tracer=RequestTracer(),
                        speculation=SpecConfig(draft_model=gpt_draft[1],
                                               k=K)))


@pytest.fixture(scope="module")
def jax_spec_paged(gpt, gpt_draft):
    return _warm(JaxEngine(gpt[0], **ENG, **PAGED,
                           speculation=JaxSpecConfig(
                               draft_model=gpt_draft[0], k=K)))


def _generate(eng, prompts=PROMPTS, n=10, **kw):
    reqs = [eng.add_request(p, max_new_tokens=n, **kw) for p in prompts]
    eng.run()
    assert all(r.finished for r in reqs), \
        [(r.state, r.error) for r in reqs]
    return [r.output_ids for r in reqs]


# -- greedy: the speculative streams are the plain ones ---------------------

class TestGreedy:
    def test_gpt_paged_low_accept(self, gpt_ref, gpt_spec_paged,
                                  jax_spec_paged):
        base = _generate(gpt_ref)
        m0 = gpt_spec_paged.metrics.compile_misses
        out = _generate(gpt_spec_paged)
        assert out == base
        assert out == _generate(jax_spec_paged)
        assert gpt_spec_paged.metrics.compile_misses == m0
        st = gpt_spec_paged.stats()["speculation"]
        assert st["rounds"] > 0 and st["proposed"] > 0
        assert st["verify_steps"] == st["rounds"]
        assert st["draft_steps"] == K * st["rounds"]
        assert st["accept_rate"] < 1.0       # the independent draft misses

    @pytest.mark.parametrize("layout", ["contiguous", "paged"])
    def test_gpt_self_spec_full_accept(self, gpt, gpt_ref, layout):
        base = _generate(gpt_ref)
        extra = PAGED if layout == "paged" else {}
        eng = _warm(Engine(gpt[1], **ENG, **extra,
                           speculation=SpecConfig(draft_model=gpt[1], k=K)))
        jeng = _warm(JaxEngine(gpt[0], **ENG, **extra,
                               speculation=JaxSpecConfig(draft_model=gpt[0],
                                                         k=K)))
        m0 = eng.metrics.compile_misses
        assert _generate(eng) == base
        assert _generate(jeng) == base
        assert eng.metrics.compile_misses == m0
        st = eng.stats()["speculation"]
        assert st["accept_rate"] > 0.5      # budget caps trim the tail
        assert st["mean_accepted_per_round"] > 0
        # the same rounds as the JAX engine: a greedy draft of the target
        # proposes the target's argmaxes, whatever the package
        jst = jeng.stats()["speculation"]
        assert (st["rounds"], st["accepted"]) == (jst["rounds"],
                                                  jst["accepted"])

    @pytest.mark.parametrize("layout", ["paged", "contiguous"])
    def test_llama_gqa(self, llama, llama_draft, layout):
        assert llama[1].config.n_kv_heads < \
            llama[1].config.num_attention_heads
        base = _generate(_warm(Engine(llama[1], **ENG)), n=8)
        extra = PAGED if layout == "paged" else {}
        eng = _warm(Engine(llama[1], **ENG, **extra,
                           speculation=SpecConfig(
                               draft_model=llama_draft[1], k=K)))
        jeng = _warm(JaxEngine(llama[0], **ENG, **extra,
                               speculation=JaxSpecConfig(
                                   draft_model=llama_draft[0], k=K)))
        m0 = eng.metrics.compile_misses
        assert _generate(eng, n=8) == base
        assert _generate(jeng, n=8) == base
        assert eng.metrics.compile_misses == m0

    def test_eos_mid_round_stops_like_nospec(self, gpt_ref, gpt_spec_paged,
                                             jax_spec_paged):
        base = _generate(gpt_ref, prompts=[PROMPTS[0]], n=10)[0]
        eos = base[2]
        want = base[:base.index(eos) + 1]
        for eng in (gpt_ref, gpt_spec_paged, jax_spec_paged):
            out = _generate(eng, prompts=[PROMPTS[0]], n=10,
                            eos_token_id=eos)[0]
            assert out == want, eng.name

    def test_capacity_retire_near_max_seq(self, gpt_ref, gpt_spec_paged,
                                          jax_spec_paged, gpt, gpt_draft):
        # a prompt 3 short of max_seq: the window overhangs the cache end
        # (scratch block, paged; headroom, contiguous) and the slot is
        # driven to max_seq, retiring on capacity as without speculation
        prompt = np.random.RandomState(5).randint(0, 128, (29,)).tolist()
        base = _generate(gpt_ref, prompts=[prompt], n=16)
        assert len(base[0]) == 4               # 29 + 4 = max_seq
        contiguous = _warm(Engine(gpt[1], **ENG, speculation=SpecConfig(
            draft_model=gpt_draft[1], k=K)))
        # both contiguous caches take a window's writes past max_seq in
        # headroom, never on position max_seq - 1
        assert contiguous.cache.headroom == contiguous.spec.cache.headroom \
            == K
        for eng in (gpt_spec_paged, contiguous, jax_spec_paged):
            assert _generate(eng, prompts=[prompt], n=16) == base, eng.name
        assert gpt_spec_paged.health()["kv_block_invariants"] == "ok"
        assert gpt_spec_paged.cache.allocator.stats()["used"] == 0

    def test_max_seq_prompt_retires_at_first_token(self, gpt_ref,
                                                   gpt_spec_paged,
                                                   jax_spec_paged):
        prompt = np.random.RandomState(6).randint(0, 128, (32,)).tolist()
        rounds0 = gpt_spec_paged.metrics.spec_rounds
        base = _generate(gpt_ref, prompts=[prompt], n=4)
        assert len(base[0]) == 1
        assert _generate(gpt_spec_paged, prompts=[prompt], n=4) == base
        assert _generate(jax_spec_paged, prompts=[prompt], n=4) == base
        assert gpt_spec_paged.metrics.spec_rounds == rounds0


# -- seeded sampling ----------------------------------------------------------

def _lanes(n, seed_base, temp=0.8, top_k=8, top_p=0.9):
    s = DeviceSampler(n, device="cpu")
    s.seeds.copy_(torch.arange(seed_base, seed_base + n))
    s.temps.fill_(temp)
    s.top_ks.fill_(top_k)
    s.top_ps.fill_(top_p)
    return s


def _jax_law(logits_row, temp=0.8, top_k=8, top_p=0.9):
    """The masked target softmax of one ``[V]`` row, by the JAX package."""
    z = _device_masked_logits(jnp.asarray(logits_row[None]),
                              jnp.full((1,), temp),
                              jnp.full((1,), top_k, jnp.int32),
                              jnp.full((1,), top_p))
    return np.asarray(jax.nn.softmax(z[0]))


def _draft_round(drf, dlog, k):
    """k proposals per lane from the fixed draft logits, as the draft's k
    decode programs draw them (each at the draft's next counter)."""
    N = drf.num_slots
    ones = torch.ones(N, dtype=torch.int32)
    return torch.stack([drf.sample_all(dlog[:, j], ones) for j in range(k)],
                       dim=1)


class TestSampling:
    def test_masked_logits_match_jax(self):
        """The law both samplers price: the port's ``masked_logits`` and
        JAX's ``_device_masked_logits`` on the same logits (atol 1e-6)."""
        lrs = np.random.RandomState(1)
        logits = (lrs.randn(5, 24) * 2).astype(np.float32)
        temps = np.array([0.8, 1.0, 0.5, 2.0, 1.3], np.float32)
        top_ks = np.array([8, 0, 3, 24, 1], np.int32)
        top_ps = np.array([0.9, 1.0, 0.5, 0.95, 1.0], np.float32)
        ref = np.asarray(_device_masked_logits(
            jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
            jnp.asarray(top_ps)))
        got = masked_logits(torch.from_numpy(logits),
                            torch.from_numpy(temps),
                            torch.from_numpy(top_ks),
                            torch.from_numpy(top_ps)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)

    def test_accept_marginal_matches_target_law(self):
        """4000 lanes, one round each (seeded), the draft proposing from a
        very different law: the first emitted token's empirical law is
        within L1 0.05 of the masked target softmax (by JAX)."""
        lrs = np.random.RandomState(1)
        V, k, N = 24, 3, 4000
        tlog = (lrs.randn(1, k + 1, V) * 2).astype(np.float32)
        dlog = (lrs.randn(1, k + 1, V) * 2).astype(np.float32)
        tgt, drf = _lanes(N, 1000), _lanes(N, 500_000)
        tl = torch.from_numpy(tlog).expand(N, k + 1, V)
        dl = torch.from_numpy(dlog).expand(N, k + 1, V)
        props = _draft_round(drf, dl, k)
        emitted, m = tgt.accept_speculative(
            tl, dl, props, torch.full((N,), k + 1, dtype=torch.int32),
            torch.ones(N, dtype=torch.int32), drf)
        m = m.numpy()
        assert np.all((m >= 1) & (m <= k + 1))
        counts = np.bincount(emitted[:, 0].numpy(), minlength=V)
        assert float(np.abs(counts / N - _jax_law(tlog[0, 0])).sum()) < 0.05
        # the counters advanced by the emitted count, in both samplers
        assert torch.equal(tgt.counters, torch.from_numpy(m).long())
        assert torch.equal(drf.counters, tgt.counters)

    def test_rounds_emit_independent_target_draws(self):
        """The counter scheme's no-reuse claim: 4000 lanes, rounds from
        fixed logits (so the target law is one law at every position)
        until each lane has emitted 8 tokens.  Each position's law is
        within L1 0.1 of the target's (V = 8), and consecutive positions
        agree as often as independent draws do (within 0.03 of
        ``sum p^2``): a round that reused a draw that decided an emitted
        token would repeat tokens."""
        lrs = np.random.RandomState(3)
        V, k, N, P = 8, 3, 4000, 8
        tlog = (lrs.randn(V) * 1.5).astype(np.float32)
        dlog = (lrs.randn(V) * 1.5).astype(np.float32)
        tl = torch.from_numpy(tlog).expand(N, k + 1, V)
        dl = torch.from_numpy(dlog).expand(N, k + 1, V)
        tgt = _lanes(N, 7, temp=1.0, top_k=0, top_p=1.0)
        drf = _lanes(N, 900_000, temp=1.0, top_k=0, top_p=1.0)
        ones = torch.ones(N, dtype=torch.int32)
        streams = [[] for _ in range(N)]
        rounds = 0
        while min(len(s) for s in streams) < P:
            props = _draft_round(drf, dl, k)
            emitted, m = tgt.accept_speculative(
                tl, dl, props, torch.full((N,), k + 1, dtype=torch.int32),
                ones, drf)
            for n, (row, mm) in enumerate(zip(emitted.tolist(), m.tolist())):
                streams[n].extend(row[:mm])
            rounds += 1
        assert rounds >= 2
        toks = np.array([s[:P] for s in streams])            # [N, P]
        law = _jax_law(tlog, temp=1.0, top_k=0, top_p=1.0)
        for p in range(P):
            counts = np.bincount(toks[:, p], minlength=V) / N
            assert float(np.abs(counts - law).sum()) < 0.1, p
        same = (toks[:, 1:] == toks[:, :-1]).mean(axis=0)
        assert np.all(np.abs(same - float((law ** 2).sum())) < 0.03), same

    def test_identical_laws_degenerate_residual(self):
        # draft law == target law: every rejection's residual has no mass
        # and falls back to the target law, never NaN
        lrs = np.random.RandomState(2)
        V, k = 16, 2
        log = torch.from_numpy((lrs.randn(2, k + 1, V) * 2)
                               .astype(np.float32))
        tgt = DeviceSampler(2, device="cpu")
        drf = DeviceSampler(2, device="cpu")
        for slot in range(2):
            tgt.stage_slot(slot, SamplingParams(temperature=1.0), 3)
            drf.stage_slot(slot, SamplingParams(temperature=1.0), 4)
        emitted, m = tgt.accept_speculative(
            log, log, torch.zeros((2, k), dtype=torch.int32),
            torch.full((2,), k + 1, dtype=torch.int32),
            torch.ones(2, dtype=torch.int32), drf)
        assert torch.all((m >= 1) & (m <= k + 1))
        assert torch.all((emitted >= 0) & (emitted < V))

    def test_greedy_accept_matches_jax(self):
        """Greedy acceptance on the same logits, proposals and caps:
        ``m`` and the whole emitted window equal JAX's exactly."""
        lrs = np.random.RandomState(4)
        S, k, V = 6, 3, 32
        W = k + 1
        tlog = (lrs.randn(S, W, V) * 2).astype(np.float32)
        dlog = (lrs.randn(S, W, V) * 2).astype(np.float32)
        argm = tlog.argmax(-1)
        props = lrs.randint(0, V, (S, k)).astype(np.int32)
        for s, n_good in enumerate([0, 1, 2, 3, 3, 2]):
            props[s, :n_good] = argm[s, :n_good]
        cap = np.array([4, 4, 4, 4, 2, 1], np.int32)
        jt, jd = JaxSampler(S), JaxSampler(S)
        j_emit, j_m = jt.accept_speculative(
            jnp.asarray(tlog), jnp.asarray(dlog), jnp.asarray(props),
            jnp.asarray(cap), jd)
        tt = DeviceSampler(S, device="cpu")
        td = DeviceSampler(S, device="cpu")
        t_emit, t_m = tt.accept_speculative(
            torch.from_numpy(tlog), torch.from_numpy(dlog),
            torch.from_numpy(props), torch.from_numpy(cap),
            torch.ones(S, dtype=torch.int32), td)
        np.testing.assert_array_equal(t_m.numpy(), np.asarray(j_m))
        np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
        np.testing.assert_array_equal(t_m.numpy(), [1, 2, 3, 4, 2, 1])
        np.testing.assert_array_equal(tt.tokens.numpy(),
                                      np.asarray(jt.tokens.numpy()))
        assert torch.equal(td.tokens, tt.tokens)

    def test_seeded_replay_bitwise(self, gpt_spec_paged):
        outs = [_generate(gpt_spec_paged, n=8,
                          sampling=SamplingParams(temperature=0.9,
                                                  top_k=20, top_p=0.9,
                                                  seed=42))
                for _ in range(2)]
        assert outs[0] == outs[1]


# -- rollback and the allocator ------------------------------------------------

class TestRollback:
    def test_allocator_clean_zero_leaked_blocks(self, gpt_spec_paged):
        eng = gpt_spec_paged
        reqs = [eng.add_request(p, max_new_tokens=10) for p in PROMPTS]
        seen_rounds = eng.metrics.spec_rounds
        while eng.step():
            assert eng.cache.check_invariants() == []
        assert all(r.finished for r in reqs)
        assert eng.metrics.spec_rounds > seen_rounds
        st = eng.cache.allocator.stats()
        assert eng.cache.allocator.check() == []
        assert st["used"] == 0, st
        assert eng.stats()["health"]["kv_block_invariants"] == "ok"

    def test_truncate_blocks_matches_jax(self):
        """The same admissions, capacity calls and truncations on both
        packages' paged caches: equal returns, owned blocks, table rows
        and allocator counts."""
        from paddle_tpu.serving.paging import PagedKVCache as JaxPaged

        kw = dict(num_slots=2, num_layers=1, max_seq=32, num_kv_heads=1,
                  head_dim=4, block_size=8)
        jc, tc = JaxPaged(**kw), PagedKVCache(**kw, device="cpu")
        for c in (jc, tc):
            assert c.begin_sequence(0, [], 0, 32)             # 4 blocks
            assert c.begin_sequence(1, [], 0, 8)
            assert c.ensure_capacity(1, 8) and c.ensure_capacity(1, 16)
        for slot, n in ((0, 17), (0, 17), (1, 9), (0, 1), (1, 24)):
            assert tc.truncate_blocks(slot, n) == jc.truncate_blocks(slot, n)
            assert tc.owned_blocks(slot) == jc.owned_blocks(slot)
            np.testing.assert_array_equal(tc.block_tables.numpy(),
                                          np.asarray(jc.block_tables.numpy()))
            assert tc.allocator.stats() == jc.allocator.stats()
        assert int(tc.block_tables[0, 1]) == SCRATCH_BLOCK
        assert tc.allocator.check() == []
        for slot in (0, 1):
            tc.release_slot(slot)
        assert tc.allocator.stats()["used"] == 0


# -- preemption and durability ---------------------------------------------

SEEDED = dict(sampling=SamplingParams(temperature=0.8, top_k=12, seed=9))


class TestPreemptAndRecovery:
    """Two one-slot paged speculative engines: the first serves the
    uninterrupted baseline and later the attempt a crash abandons; the
    second the preempt-resume run and later the journal recovery."""

    @pytest.fixture(scope="class")
    def engines(self, gpt, gpt_draft):
        def build():
            return _warm(Engine(gpt[1], num_slots=1, max_seq=32,
                                min_bucket=16, **PAGED,
                                speculation=SpecConfig(
                                    draft_model=gpt_draft[1], k=K)))

        return build(), build()

    @pytest.fixture(scope="class")
    def long_prompt(self):
        return np.random.RandomState(3).randint(0, 128, (16,)).tolist()

    @pytest.fixture(scope="class")
    def baseline(self, engines, long_prompt):
        r = engines[0].add_request(long_prompt, max_new_tokens=12,
                                   **SEEDED)
        engines[0].run()
        assert r.finished
        return list(r.output_ids)

    def test_preempt_resume_bitwise(self, engines, long_prompt, baseline):
        eng = engines[1]
        victim = eng.add_request(long_prompt, max_new_tokens=12,
                                 priority="low", **SEEDED)
        for _ in range(2):
            eng.step()                   # mid-speculation
        assert 0 < len(victim.output_ids) < 12
        m0 = eng.metrics.compile_misses
        hi = eng.add_request(PROMPTS[3], max_new_tokens=4, priority="high")
        eng.run()
        assert hi.finished and victim.finished
        assert victim.preemptions == 1
        assert victim.output_ids == baseline
        assert eng.metrics.compile_misses == m0
        assert eng.cache.allocator.check() == []
        assert eng.cache.allocator.stats()["used"] == 0

    def test_journal_recover_bitwise_exactly_once(self, engines,
                                                  long_prompt, baseline):
        e1, e2 = engines
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "jrnl")
            j1 = RequestJournal(path)
            e1.journal = j1
            r1 = e1.add_request(long_prompt, max_new_tokens=12, **SEEDED)
            for _ in range(2):
                e1.step()                # abandoned mid-speculation
            sent = list(r1.output_ids)
            assert 0 < len(sent) < 12
            e1.journal = None            # the crash: nothing more recorded
            j1.close()
            j2 = RequestJournal(path)
            jid = next(iter(j2.pending()))
            assert j2.tokens_for(jid) == sent    # one burst per round
            info = e2.recover(j2)
            assert info["replayed"] == 1
            m0 = e2.metrics.compile_misses
            e2.run()
            rr = info["requests"][0]
            assert rr.finished and rr.recovered
            assert rr.output_ids == baseline
            assert rr.output_ids[:len(sent)] == sent
            assert e2.metrics.compile_misses == m0
            audit = j2.audit()
            assert audit["duplicate_terminals"] == 0
            assert audit["pending"] == 0
            e2.journal = None
            j2.close()

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_each_package_recovers_the_others_spec_journal(
            self, gpt, gpt_draft, gpt_ref, writer):
        """A speculating engine of one package journals a greedy request
        and is abandoned after two rounds; a speculating engine of the
        other package recovers it from the same directory.  The journal's
        burst records hold what the client received, and the replay is
        the uninterrupted greedy stream (the same in both packages)."""
        prompt = PROMPTS[3]
        base = _generate(gpt_ref, prompts=[prompt], n=20)[0]
        engines = {
            "jax": lambda j: JaxEngine(
                gpt[0], **ENG, **PAGED, journal=j,
                speculation=JaxSpecConfig(draft_model=gpt_draft[0], k=K)),
            "port": lambda j: Engine(
                gpt[1], **ENG, **PAGED, journal=j,
                speculation=SpecConfig(draft_model=gpt_draft[1], k=K))}
        journals = {"jax": JaxJournal, "port": RequestJournal}
        reader = "port" if writer == "jax" else "jax"
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "jrnl")
            j1 = journals[writer](path)
            e1 = _warm(engines[writer](j1))
            r1 = e1.add_request(prompt, max_new_tokens=20)
            for _ in range(2):
                e1.step()                # an admission and two rounds
            sent = list(r1.output_ids)
            assert 2 < len(sent) < 20
            e1.journal = None
            j1.close()
            j2 = journals[reader](path)
            assert j2.tokens_for(next(iter(j2.pending()))) == sent
            e2 = _warm(engines[reader](j2))
            info = e2.recover()
            e2.run()
            rr = info["requests"][0]
            assert rr.finished and rr.recovered
            assert rr.output_ids == base
            audit = j2.audit()
            assert audit["pending"] == 0
            assert audit["duplicate_terminals"] == 0
            e2.journal = None
            j2.close()


# -- retries: a round is k+1 programs, a retry rewinds them all ---------------

def _flaky(eng, plan):
    """Wrap ``eng.programs.run``: ``plan`` maps a program kind and its
    call's number (from 1, counted from here) to ``"before"`` (raise
    before it runs) or ``"after"`` (raise after it ran and moved the
    lanes)."""
    run, seen = eng.programs.run, {}

    def flaky(key, body, *inputs):
        n = seen[key[0]] = seen.get(key[0], 0) + 1
        when = plan.get((key[0], n))
        if when == "before":
            raise RuntimeError(f"injected before {key[0]} #{n}")
        out = run(key, body, *inputs)
        if when == "after":
            raise RuntimeError(f"injected after {key[0]} #{n}")
        return out

    eng.programs.run = flaky


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_round_retry_rewinds_all_programs(gpt, gpt_draft, layout):
    """Draft steps and verifies that fail before and after they ran (the
    second draft step of a round, a verify after it wrote the caches and
    lanes) are retried as whole rounds: greedy and seeded streams equal
    an engine's that never failed."""
    extra = PAGED if layout == "paged" else {}
    reqs = [(PROMPTS[0], SamplingParams()),
            (PROMPTS[1], SamplingParams(temperature=0.8, top_k=12,
                                        seed=5))]

    def serve(plan):
        eng = _warm(Engine(gpt[1], **ENG, **extra,
                           speculation=SpecConfig(draft_model=gpt_draft[1],
                                                  k=K)))
        _flaky(eng, plan)
        out = [eng.add_request(p, sampling=s, max_new_tokens=10)
               for p, s in reqs]
        eng.run()
        assert all(r.finished for r in out), [r.error for r in out]
        return [r.output_ids for r in out], eng.stats()

    want, _ = serve({})
    # calls counted from the first round; with k = 3 and one retry each,
    # rounds 1-4 fail once: at their first draft step, their verify,
    # their second draft step and their verify
    got, st = serve({("draft_decode", 1): "before", ("verify", 2): "after",
                     ("draft_decode", 12): "after", ("verify", 5): "before"})
    assert got == want
    assert st["failures"]["retries_by_point"] == {"serving.spec_round": 4}
    assert st["compile_cache"]["after_warmup"] == 0


def test_exhausted_round_retries_fail_the_batch(gpt, gpt_draft):
    """With no retry left a failed round fails every request it served
    (``error_kind="replica"``); the pool is clean and the next request is
    served as alone."""
    eng = _warm(Engine(gpt[1], **ENG, **PAGED, max_step_retries=0,
                       speculation=SpecConfig(draft_model=gpt_draft[1],
                                              k=K)))
    _flaky(eng, {("verify", 1): "after"})
    reqs = [eng.add_request(p, max_new_tokens=10) for p in PROMPTS[:2]]
    eng.run()
    assert [(r.state, r.error_kind) for r in reqs] == [("failed",
                                                        "replica")] * 2
    assert all("speculative round failed" in r.error for r in reqs)
    assert eng.cache.check_invariants() == []
    assert eng.cache.allocator.stats()["used"] == 0
    alone = _warm(Engine(gpt[1], **ENG))
    assert _generate(eng, prompts=[PROMPTS[2]]) == \
        _generate(alone, prompts=[PROMPTS[2]])


def test_dropped_engine_is_freed_without_the_cyclic_collector(gpt,
                                                              gpt_draft):
    """A dropped speculating engine is freed by its reference count: left
    to the cyclic collector, its CUDA graphs could be freed inside another
    engine's capture, which invalidates that capture."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        for extra in ({}, PAGED):
            eng = _warm(Engine(gpt[1], **ENG, **extra,
                               speculation=SpecConfig(
                                   draft_model=gpt_draft[1], k=K)))
            _generate(eng, prompts=PROMPTS[:1], n=4)
            ref = weakref.ref(eng)
            del eng
            assert ref() is None, extra
    finally:
        if collecting:
            gc.enable()


# -- observability ----------------------------------------------------------

class TestObservability:
    def test_trace_chain_valid_with_verify_events(self, gpt_spec_paged):
        tr = gpt_spec_paged.tracer
        assert validate_trace(tr) == []
        vs = [e for e in tr.events if e["kind"] == "verify_step"]
        assert vs, "no verify_step events recorded"
        assert all("proposed" in e and "accepted" in e
                   and e["n_active"] >= 1 for e in vs)
        assert not any(e["kind"] == "decode_step" for e in tr.events)

    def test_perfetto_accepted_tokens_counter_track(self, gpt_spec_paged):
        trace = chrome_trace(gpt_spec_paged.tracer)
        names = {e["name"] for e in trace["traceEvents"]
                 if e.get("ph") == "C"}
        assert "accepted_tokens" in names and "active_slots" in names

    def test_speculation_stats_and_exposition(self, gpt_spec_paged,
                                              jax_spec_paged, gpt_ref):
        st = gpt_spec_paged.stats()
        sp = st["speculation"]
        assert sp["k"] == K and sp["rounds"] > 0
        assert 0.0 <= sp["accept_rate"] <= 1.0
        assert sp["proposed"] >= sp["accepted"] >= 0
        assert set(sp) == set(jax_spec_paged.stats()["speculation"])
        assert gpt_ref.stats()["speculation"] is None
        text = render_metrics(st)
        assert "speculation_rounds" in text
        assert "speculation_accept_rate" in text

    def test_warmup_registry_covers_draft_and_verify(self, gpt_ref,
                                                     gpt_spec_paged,
                                                     jax_spec_paged):
        m0 = gpt_spec_paged.metrics.compile_misses
        info = gpt_spec_paged.warmup()
        assert info["programs"] == jax_spec_paged.warmup()["programs"] == [
            "prefill", "draft_prefill", "draft_decode", "verify"]
        assert gpt_spec_paged.metrics.compile_misses == m0
        assert sorted(k[0] for k in gpt_spec_paged.programs.keys()) == \
            sorted(["prefill"] * 2 + ["draft_prefill"] * 2
                   + ["draft_decode", "verify"])
        assert gpt_ref.warmup()["programs"] == ["prefill", "decode"]


# -- configuration --------------------------------------------------------------

class TestConfig:
    def test_vocab_mismatch_rejected(self, gpt):
        bad = dict(GPT_DRAFT, vocab_size=64)
        for eng_cls, spec_cls, draft in (
                (JaxEngine, JaxSpecConfig,
                 jax_gpt.GPTForCausalLM(jax_gpt.GPTConfig(**bad))),
                (Engine, SpecConfig,
                 GPTForCausalLM(GPTConfig(**bad), device="cpu"))):
            model = gpt[0] if eng_cls is JaxEngine else gpt[1]
            with pytest.raises(ValueError, match="vocab"):
                eng_cls(model, **ENG,
                        speculation=spec_cls(draft_model=draft, k=K))

    def test_k_validated(self, gpt):
        for spec_cls, model in ((JaxSpecConfig, gpt[0]),
                                (SpecConfig, gpt[1])):
            with pytest.raises(ValueError, match="k must be >= 1"):
                spec_cls(draft_model=model, k=0)

    def test_short_draft_positions_rejected(self, gpt):
        bad = dict(GPT_DRAFT, max_position_embeddings=16)
        for eng_cls, spec_cls, draft in (
                (JaxEngine, JaxSpecConfig,
                 jax_gpt.GPTForCausalLM(jax_gpt.GPTConfig(**bad))),
                (Engine, SpecConfig,
                 GPTForCausalLM(GPTConfig(**bad), device="cpu"))):
            model = gpt[0] if eng_cls is JaxEngine else gpt[1]
            with pytest.raises(ValueError, match="max_position_embeddings"):
                eng_cls(model, **ENG,
                        speculation=spec_cls(draft_model=draft, k=K))

    @pytest.mark.parametrize("kw", ["mesh"])
    def test_unported_subsystems_raise(self, gpt, gpt_draft, kw):
        """A mesh without a ``model`` axis is refused as the JAX
        ``ServingShard`` refuses it (sharded speculation itself runs in
        tests/test_torch_sharded_serving.py)."""
        with pytest.raises(ValueError, match="needs a 'model' axis"):
            Engine(gpt[1], **ENG, **{kw: object()},
                   speculation=SpecConfig(draft_model=gpt_draft[1], k=K))

    @pytest.mark.parametrize("layout", ["contiguous", "paged"])
    def test_sanitized_rounds_raise(self, gpt, gpt_draft, monkeypatch,
                                    layout):
        """A speculating engine under ``PADDLE_TPU_SANITIZE`` constructs in
        both packages, and its rounds raise no host transfer: 0.0 per
        decode step (a round is one counted step), the same report as
        the JAX engine's."""
        monkeypatch.setenv("PADDLE_TPU_SANITIZE", "1")
        kw = dict(ENG, **(PAGED if layout == "paged" else {}))
        reps = []
        for eng_cls, spec_cls, i in ((JaxEngine, JaxSpecConfig, 0),
                                     (Engine, SpecConfig, 1)):
            eng = eng_cls(gpt[i], **kw, speculation=spec_cls(
                draft_model=gpt_draft[i], k=K))
            eng.generate(PROMPTS[:2], max_new_tokens=8)
            reps.append(eng.stats()["sanitizer"])
        assert reps[1] == reps[0]
        assert reps[1]["decode_steps"] > 0
        assert reps[1]["per_decode_step"] == 0.0, reps[1]


# -- module parity --------------------------------------------------------------

def _attn_inputs(seed, B=3, W=4, H=4, Hkv=2, D=8, T=32):
    r = np.random.RandomState(seed)
    q = r.randn(B, W, H, D).astype(np.float32)
    k = r.randn(B, T, Hkv, D).astype(np.float32)
    v = r.randn(B, T, Hkv, D).astype(np.float32)
    # the last slot's window runs past the end (positions 30..33 of 32)
    lens = np.array([0, 17, T - 2], np.int32)
    return q, k, v, lens


def _jax_verify(q, k, v, lens):
    from paddle_tpu.ops.cached_attention import verify_attention

    return verify_attention(to_tensor(q), to_tensor(k), to_tensor(v),
                            to_tensor(lens)).numpy()


@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_verify_attention_matches_jax(hkv):
    q, k, v, lens = _attn_inputs(0, Hkv=hkv)
    got = ca.verify_attention(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    np.testing.assert_allclose(got.numpy(), _jax_verify(q, k, v, lens),
                               atol=ATOL)


def test_verify_attention_at_width_one_is_cached_attention():
    q, k, v, lens = _attn_inputs(1, W=1)
    t = [torch.from_numpy(a) for a in (q, k, v, lens)]
    assert torch.equal(ca.verify_attention(*t), ca.cached_attention(*t))


@pytest.mark.parametrize("hkv", [4, 1])
def test_flattened_k4_route_matches_jax(hkv):
    """The paged verify as ``B·W`` decode rows of K4 (its plain version on
    CPU tensors): the pool is the gathered cache's blocks, so it must be
    ``verify_attention`` over that cache, windows past the end included."""
    q, k, v, lens = _attn_inputs(2, Hkv=hkv)
    B, T, bs = k.shape[0], k.shape[1], 8
    mb = T // bs
    order = np.random.RandomState(3).permutation(B * mb) + 1
    tables = order.reshape(B, mb).astype(np.int32)
    pool_k = np.zeros((B * mb + 1, bs) + k.shape[2:], np.float32)
    pool_v = np.zeros_like(pool_k)
    pool_k[tables.reshape(-1)] = k.reshape(B * mb, bs, *k.shape[2:])
    pool_v[tables.reshape(-1)] = v.reshape(B * mb, bs, *v.shape[2:])
    got = ca.paged_verify_attention(
        *(torch.from_numpy(a) for a in (q, pool_k, pool_v, tables, lens)))
    ref = _jax_verify(q, k, v, lens)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    plain = ca.verify_attention(*(torch.from_numpy(a)
                                  for a in (q, k, v, lens)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)


def _window(seed, S=2, W=4, Hkv=2, D=4):
    r = np.random.RandomState(seed)
    return (r.randn(S, W, 2 * Hkv, D).astype(np.float32),
            r.randn(S, W, Hkv, D).astype(np.float32),
            r.randn(S, W, Hkv, D).astype(np.float32))


@pytest.mark.parametrize("kernel", ["cuda", "reference"])
def test_paged_verify_write_and_attention_match_jax(kernel):
    """One verify window through both packages' paged caches, slot 1's
    window past ``max_seq`` (its positions there go to scratch): equal
    outputs where a query sits below ``max_seq``, and equal pools outside
    the scratch block."""
    from paddle_tpu.serving.paging import PagedKVCache as JaxPaged

    kw = dict(num_slots=2, num_layers=1, max_seq=32, num_kv_heads=2,
              head_dim=4, block_size=8)
    jc = JaxPaged(**kw)
    tc = PagedKVCache(**kw, kernel=kernel, device="cpu")
    lens = [5, 30]
    for c in (jc, tc):
        assert c.begin_sequence(0, [], 0, 16)
        assert c.begin_sequence(1, [], 0, 32)
    tc.lengths.copy_(torch.tensor(lens, dtype=torch.int32))
    jc.lengths._set_data(jnp.asarray(lens, jnp.int32))
    q, k, v = _window(4)
    got = tc.verify_attention(0, *(torch.from_numpy(a) for a in (q, k, v)))
    ref = jc.verify_attention(0, *(to_tensor(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got[0].numpy(), ref[0], atol=ATOL)
    np.testing.assert_allclose(got[1, :2].numpy(), ref[1, :2], atol=ATOL)
    for t_pool, j_pool in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_array_equal(t_pool[1:].numpy(),
                                      np.asarray(j_pool.numpy())[1:])


def test_contiguous_verify_with_headroom_matches_jax():
    """The contiguous cache's window past ``max_seq``: JAX drops those
    writes; the port's headroom takes them.  Outputs of queries below
    ``max_seq`` and the first ``max_seq`` positions agree."""
    from paddle_tpu.serving.kv_cache import KVCache as JaxKV

    jc = JaxKV(num_slots=2, num_layers=1, max_seq=32, num_kv_heads=2,
               head_dim=4)
    tc = KVCache(2, 1, 32, 2, 4, device="cpu", headroom=3)
    r = np.random.RandomState(5)
    init = r.randn(2, 1, 32, 2, 4).astype(np.float32)
    tc.k[:, :, :32] = torch.from_numpy(init)
    tc.v[:, :, :32] = torch.from_numpy(init[::-1].copy())
    jc.k._set_data(jnp.asarray(init))
    jc.v._set_data(jnp.asarray(init[::-1].copy()))
    lens = [5, 30]
    tc.lengths.copy_(torch.tensor(lens, dtype=torch.int32))
    jc.lengths._set_data(jnp.asarray(lens, jnp.int32))
    q, k, v = _window(6)
    got = tc.verify_attention(0, *(torch.from_numpy(a) for a in (q, k, v)))
    ref = jc.verify_attention(0, *(to_tensor(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got[0].numpy(), ref[0], atol=ATOL)
    np.testing.assert_allclose(got[1, :2].numpy(), ref[1, :2], atol=ATOL)
    np.testing.assert_array_equal(tc.k[:, :, :32].numpy(),
                                  np.asarray(jc.k.numpy()))
