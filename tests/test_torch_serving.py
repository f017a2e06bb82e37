"""The port's serving engine against the JAX package's, on the CPU.

One ``llama_tiny`` model is built in the JAX package from a seed; its
weights are converted into the port.  Six greedy prompts sharing a
19-token prefix (seeded numpy) are served by
``Engine(kv_layout="paged", block_size=8, min_bucket=8, max_seq=64,
num_slots=4)`` in both packages, and by the contiguous layout; the
generated ids must be identical (exact: greedy argmax of f32 logits that
agree to ~1e-6).  Sampling is held to the JAX masking law and to
same-seed replay within the port (the port's counter-based noise and
jax.random's streams differ).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving.sampling import _device_masked_logits
from paddle_tpu_torch.models import (
    LlamaForCausalLM, from_jax_state_dict, llama_tiny,
)
from paddle_tpu_torch.serving import (
    Engine, PagedKVCache, PrefixCache, SamplingParams,
)
from paddle_tpu_torch.serving.sampling import (
    device_sample, masked_logits, sample,
)

torch.set_num_threads(2)

ENGINE_KW = dict(block_size=8, min_bucket=8, max_seq=64, num_slots=4)
MAX_NEW = 6


@pytest.fixture(scope="module")
def setup():
    paddle.seed(0)
    jm = jax_llama.LlamaForCausalLM(jax_llama.llama_tiny())
    jm.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(LlamaForCausalLM(llama_tiny(), device="cpu"),
                             sd)
    rs = np.random.RandomState(0)
    prefix = rs.randint(0, 128, (19,)).tolist()
    prompts = [prefix + rs.randint(0, 128, (n,)).tolist()
               for n in (1, 4, 9, 13, 2, 7)]
    return jm, tm, prompts


@pytest.fixture(scope="module")
def runs(setup):
    jm, tm, prompts = setup
    out = {}
    for layout in ("paged", "contiguous"):
        je = JaxEngine(jm, kv_layout=layout, **ENGINE_KW)
        te = Engine(tm, kv_layout=layout, **ENGINE_KW)
        out[layout] = (je, je.generate(prompts, max_new_tokens=MAX_NEW),
                       te, te.generate(prompts, max_new_tokens=MAX_NEW))
    return out


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_greedy_outputs_identical(runs, layout):
    _, j_out, te, t_out = runs[layout]
    assert t_out == j_out
    assert all(len(o) == MAX_NEW for o in t_out)
    assert te.kernel == ("cuda" if layout == "paged" else "reference")


def test_prefix_hits_on_both_sides(runs):
    je, _, te, _ = runs["paged"]
    j_hit = je.stats()["paging"]["prefix"]["hit_rate"]
    t_hit = te.stats()["paging"]["prefix"]["hit_rate"]
    assert t_hit > 0 and j_hit > 0
    assert t_hit == j_hit            # one algorithm, the same prompts


def test_paged_pool_is_clean_after_serving(runs):
    _, _, te, _ = runs["paged"]
    h = te.health()
    assert h["kv_block_invariants"] == "ok"
    assert h["kv_blocks"]["used"] == 0 and h["slots_free"] == 4
    st = te.stats()
    assert st["requests"]["completed"] == 6
    assert st["tokens"]["decode"] == 6 * (MAX_NEW - 1)
    assert st["ttft_ms"]["count"] == 6


def test_reference_route_matches_kernel_route(setup, runs):
    _, tm, prompts = setup
    ref = Engine(tm, kv_layout="paged", kernel="reference", **ENGINE_KW)
    assert ref.generate(prompts, max_new_tokens=MAX_NEW) == \
        runs["paged"][3]


def test_small_pool_defers_and_finishes(setup, runs):
    """A pool of 11 usable blocks holds two requests (a 32-token bucket
    is 4 blocks, growing to 5): the other admissions wait for
    retirements and the greedy outputs do not change."""
    _, tm, prompts = setup
    eng = Engine(tm, kv_layout="paged", num_kv_blocks=12,
                 enable_prefix_cache=False, **ENGINE_KW)
    reqs = [eng.add_request(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.run()
    assert all(r.finished for r in reqs)
    assert [r.output_ids for r in reqs] == runs["paged"][3]
    assert any(r._defers > 0 for r in reqs)
    assert eng.health()["kv_block_invariants"] == "ok"


def test_masked_logits_match_jax():
    rs = np.random.RandomState(4)
    logits = rs.randn(6, 50).astype(np.float32) * 3
    temps = np.array([1.0, 0.7, 1.3, 0.5, 2.0, 1.0], np.float32)
    top_ks = np.array([0, 1, 5, 50, 7, 0], np.int32)
    top_ps = np.array([1.0, 0.9, 0.5, 0.3, 1.0, 0.95], np.float32)
    ref = np.asarray(_device_masked_logits(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps)))
    out = masked_logits(torch.from_numpy(logits), torch.from_numpy(temps),
                        torch.from_numpy(top_ks),
                        torch.from_numpy(top_ps)).numpy()
    kept = ref > -1e29
    np.testing.assert_array_equal(out > -1e29, kept)
    np.testing.assert_allclose(out[kept], ref[kept], rtol=1e-6, atol=0)


def test_greedy_sampling_is_argmax_of_raw_logits():
    rs = np.random.RandomState(5)
    logits = rs.randn(4, 40).astype(np.float32)
    toks = device_sample(torch.from_numpy(logits), torch.zeros(4),
                         torch.zeros(4, dtype=torch.int32), torch.ones(4),
                         torch.arange(4), torch.zeros(4, dtype=torch.int64))
    want = [sample(row, SamplingParams()) for row in logits]
    assert toks.tolist() == want


def test_top_k_one_is_greedy():
    rs = np.random.RandomState(6)
    logits = torch.from_numpy(rs.randn(3, 40).astype(np.float32))
    toks = device_sample(logits, torch.ones(3),
                         torch.ones(3, dtype=torch.int32), torch.ones(3),
                         torch.arange(3), torch.zeros(3, dtype=torch.int64))
    assert torch.equal(toks.long(), logits.argmax(-1))


def test_sampling_law_matches_host_oracle():
    """4k seeded draws from one top-k/top-p row against the host oracle's
    probabilities (L1 distance of the histograms < 0.05): 4000 rows of one
    seed lane, each at its own draw counter, as one slot's stream."""
    rs = np.random.RandomState(7)
    row = rs.randn(20).astype(np.float32) * 2
    params = SamplingParams(temperature=0.8, top_k=8, top_p=0.9)
    n = 4000
    logits = torch.from_numpy(np.tile(row, (n, 1)))
    toks = device_sample(logits, torch.full((n,), 0.8),
                         torch.full((n,), 8, dtype=torch.int32),
                         torch.full((n,), 0.9),
                         torch.full((n,), 7919, dtype=torch.int64),
                         torch.arange(n)).numpy()
    got = np.bincount(toks, minlength=20) / n
    z = masked_logits(torch.from_numpy(row[None]), torch.tensor([0.8]),
                      torch.tensor([8], dtype=torch.int32),
                      torch.tensor([0.9]))[0]
    want = torch.softmax(z, -1).numpy()
    host = np.bincount([sample(row, params, np.random.RandomState(i))
                        for i in range(2000)], minlength=20) / 2000
    assert np.abs(got - want).sum() < 0.05
    assert np.abs(host - want).sum() < 0.08


def _sampled_run(tm, prompts):
    eng = Engine(tm, kv_layout="paged", **ENGINE_KW)
    laws = [SamplingParams(temperature=0.9, seed=11),
            SamplingParams(temperature=1.0, top_k=20, seed=12),
            SamplingParams(temperature=0.8, top_p=0.9, seed=13),
            SamplingParams(temperature=1.2)]      # seed from request id
    reqs = [eng.add_request(p, sampling=laws[i % 4], max_new_tokens=8)
            for i, p in enumerate(prompts)]
    eng.run()
    return [r.output_ids for r in reqs]


def test_same_seed_gives_same_tokens(setup):
    _, tm, prompts = setup
    a = _sampled_run(tm, prompts)
    b = _sampled_run(tm, prompts)
    assert a == b
    assert all(len(o) == 8 for o in a)


def test_malformed_requests_are_rejected(setup):
    _, tm, _ = setup
    eng = Engine(tm, kv_layout="paged", **ENGINE_KW)
    for kw in ({"prompt_ids": []}, {"prompt_ids": list(range(65))},
               {"prompt_ids": [1, 2], "max_new_tokens": 0}):
        with pytest.raises(ValueError) as ei:
            eng.add_request(**kw)
        assert ei.value.request.state == "rejected"
    assert eng.stats()["requests"]["rejected"] == 3


def test_raising_stream_callback_fails_only_its_request(setup, runs):
    _, tm, prompts = setup
    eng = Engine(tm, kv_layout="paged", **ENGINE_KW)
    seen = []

    def boom(tok, req):
        raise RuntimeError("callback")

    bad = eng.add_request(prompts[0], max_new_tokens=MAX_NEW, stream_cb=boom)
    good = eng.add_request(prompts[1], max_new_tokens=MAX_NEW,
                           stream_cb=lambda t, r: seen.append(t))
    eng.run()
    assert bad.state == "failed" and "callback" in bad.error
    assert good.finished and seen == good.output_ids == runs["paged"][3][1]
    assert eng.health()["kv_block_invariants"] == "ok"


def test_copy_on_extend_gives_a_private_block():
    cache = PagedKVCache(2, 1, 32, 1, 4, block_size=8, device="cpu")
    prefix = PrefixCache(cache.allocator, 8)
    assert cache.begin_sequence(0, [], 0, 16)
    cache.k[cache.owned_blocks(0)[0]] = 1.5
    prefix.register(list(range(16)), cache.owned_blocks(0))
    shared = cache.owned_blocks(0)[0]
    assert cache.begin_sequence(1, [shared], 8, 8)
    assert cache.ensure_capacity(1, 3)          # lands in the shared block
    assert cache.copy_on_extends == 1
    fresh = cache.owned_blocks(1)[0]
    assert fresh != shared
    assert int(cache.block_tables[1, 0]) == fresh
    assert torch.equal(cache.k[fresh], cache.k[shared])
    assert cache.check_invariants() == []
