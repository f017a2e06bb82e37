"""The engine's step programs and the graph-safe sampler, on the CPU.

The port's counterpart of ``tests/test_serving.py``'s
``test_gpt_zero_recompile_churn_and_greedy_parity``: under admit/retire
churn of mixed prompt lengths, the program registry builds nothing after
warmup (on the card a build is a CUDA graph capture; here, where PyTorch
has no graphs, a first call), and the greedy outputs equal the JAX
engine's.  The sampler's streams are held to their seeds: each slot's
stream depends on its own seed and draws only.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu_torch.models import (
    GPTForCausalLM, from_jax_state_dict, gpt_tiny,
)
from paddle_tpu_torch.serving import (
    CacheContext, DeviceSampler, Engine, KVCache, PagedCacheContext,
    PagedKVCache, SamplingParams,
)
from paddle_tpu_torch.serving.programs import StepPrograms
from paddle_tpu_torch.serving.sampling import gumbel_noise

torch.set_num_threads(2)

LENGTHS = [3, 10, 17, 5, 12, 20, 7, 25]          # hits every bucket


@pytest.fixture(scope="module")
def gpt():
    paddle.seed(0)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny())
    jm.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return jm, from_jax_state_dict(GPTForCausalLM(gpt_tiny(), device="cpu"),
                                   sd)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_gpt_zero_recompile_churn_and_greedy_parity(gpt, layout):
    jm, tm = gpt
    kw = dict(num_slots=3, max_seq=32, min_bucket=8, kv_layout=layout,
              block_size=8)
    eng = Engine(tm, **kw)
    assert eng.buckets == [8, 16, 32]
    warm = eng.warmup()
    assert warm["compile_misses"] == len(eng.buckets) + 1  # prefills+decode
    assert warm["programs"] == ["prefill", "decode"]
    assert sorted(eng.programs.keys()) == [
        ("decode",), ("prefill", 8), ("prefill", 16), ("prefill", 32)]

    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 128, (L,)).tolist() for L in LENGTHS]
    streamed = []
    reqs = [eng.add_request(p, max_new_tokens=5,
                            stream_cb=lambda t, r: streamed.append(
                                (r.request_id, t)))
            for p in prompts]
    eng.run()

    st = eng.stats()
    assert st["compile_cache"]["misses"] == warm["compile_misses"]
    assert st["compile_cache"]["after_warmup"] == 0
    assert st["compile_cache"]["hits"] > 0
    want = JaxEngine(jm, **kw).generate(prompts, max_new_tokens=5)
    assert [r.output_ids for r in reqs] == want
    for r in reqs:
        assert r.finished and len(r.output_ids) == 5
        assert [t for rid, t in streamed if rid == r.request_id] == \
            r.output_ids
    assert st["requests"]["completed"] == len(prompts)
    assert st["tokens"]["decode"] == len(prompts) * 4     # 1st via prefill
    assert st["prefills_by_bucket"] == {8: 3, 16: 2, 32: 3}
    assert sorted(eng.free_slots) == [0, 1, 2]


def test_stats_name_no_anomaly_before_warmup(gpt):
    _, tm = gpt
    eng = Engine(tm, num_slots=2, max_seq=16, min_bucket=8)
    assert eng.stats()["compile_cache"] == {"hits": 0, "misses": 0,
                                            "after_warmup": None}
    eng.generate([[1, 2, 3]], max_new_tokens=2)
    assert eng.stats()["compile_cache"]["misses"] == 2


def test_registry_counts_a_first_call_as_a_miss_and_copies_inputs():
    calls = []
    reg = StepPrograms("cpu", calls.append)

    def body(x):
        return x * 2

    a = np.arange(4, dtype=np.int32)
    assert reg.run(("k",), body, a).tolist() == [0, 2, 4, 6]
    assert reg.run(("k",), body, a + 1).tolist() == [2, 4, 6, 8]
    assert calls == [True, False]
    with pytest.raises(ValueError, match="does not match"):
        reg.run(("k",), body, np.arange(5, dtype=np.int32))


def test_prefill_surface_takes_device_scalars_only():
    """Slot, length and start reach the prefill surface as int32 tensors
    of one element, as a captured program reads them; a host int is
    refused, naming its type."""
    kv = KVCache(2, 1, 16, 2, 8, device="cpu")
    paged = PagedKVCache(2, 1, 16, 2, 8, block_size=8, device="cpu")
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="slot must be an int32 tensor"):
        CacheContext(kv, "prefill", slot=1)
    with pytest.raises(TypeError, match="start must be an int32 tensor"):
        PagedCacheContext(paged, "prefill", slot=one, start=0)
    with pytest.raises(TypeError, match="length must be .* got torch.int64"):
        kv.set_length(one, torch.ones(1, dtype=torch.int64))
    for cache in (kv, paged):
        cache.set_length(one, torch.tensor([5], dtype=torch.int32))
        assert cache.lengths.tolist() == [0, 5]
    assert CacheContext(kv, "decode").slot is None


def _draw(sampler, logits, steps, drew=None):
    """``steps`` decode draws over every slot; the tokens per step."""
    drew = torch.ones(sampler.num_slots, dtype=torch.int32) \
        if drew is None else drew
    return [sampler.sample_all(logits, drew).tolist() for _ in range(steps)]


def _logits(n, v=64, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(n, v)
                            .astype(np.float32))


def test_same_seed_gives_the_same_stream():
    law = SamplingParams(temperature=0.9, top_k=20)
    runs = []
    for _ in range(2):
        s = DeviceSampler(2, device="cpu")
        s.stage_slot(0, law, 1234)
        s.stage_slot(1, law, 99)
        runs.append(_draw(s, _logits(2), 12))
    assert runs[0] == runs[1]
    slot0 = [t[0] for t in runs[0]]
    slot1 = [t[1] for t in runs[0]]
    assert slot0 != slot1 and len(set(slot0)) > 1
    # re-staging a slot replays its stream from the start
    s = DeviceSampler(2, device="cpu")
    s.stage_slot(0, law, 1234)
    _draw(s, _logits(2), 5)
    s.stage_slot(0, law, 1234)
    assert [t[0] for t in _draw(s, _logits(2), 12)] == slot0


def test_slot_stream_ignores_other_slots_traffic():
    """Slot 0 samples with one seed while the other slots switch between
    greedy and sampling, are idle or draw: its tokens do not change."""
    law = SamplingParams(temperature=1.0, top_p=0.9)
    logits = _logits(4, seed=1)

    def slot0(others, drew_others):
        s = DeviceSampler(4, device="cpu")
        s.stage_slot(0, law, 7)
        drew = torch.tensor([1] + [drew_others] * 3, dtype=torch.int32)
        out = []
        for step in range(10):
            for slot in (1, 2, 3):
                s.stage_slot(slot, others[(step + slot) % len(others)],
                             step * 31 + slot)
            out.append(s.sample_all(logits, drew)[0].item())
        return out

    quiet = slot0([SamplingParams()], 0)
    busy = slot0([SamplingParams(), SamplingParams(temperature=0.5),
                  SamplingParams(temperature=2.0, top_k=3)], 1)
    assert quiet == busy and len(set(quiet)) > 1


def test_counters_advance_only_for_slots_that_drew():
    s = DeviceSampler(3, device="cpu")
    for slot in range(3):
        s.stage_slot(slot, SamplingParams(temperature=1.0), slot)
    s.sample_all(_logits(3), torch.tensor([1, 0, 1], dtype=torch.int32))
    s.sample_slot(torch.tensor([1]), _logits(1))
    assert s.counters.tolist() == [1, 1, 1]
    tok = s.sample_slot(torch.tensor([2]), _logits(3)[1:2])
    assert tok.shape == (1,) and int(s.tokens[2]) == tok.item()
    assert s.counters.tolist() == [1, 1, 2]
    s.stage_slot(0, SamplingParams(), 5)
    assert int(s.counters[0]) == 0 and int(s.seeds[0]) == 5


def test_gumbel_noise_is_finite_and_standard():
    """The hash maps into the open interval (0, 1): finite noise, with the
    standard Gumbel mean (0.5772) and spread (pi / sqrt 6 = 1.2825) over
    many seeds, counters and vocabulary indices; seeds past 2**63 fold into
    the int64 lane."""
    g = gumbel_noise(torch.arange(64) * 7919 - 2 ** 40,
                     torch.arange(64) % 5, 4096)
    assert torch.isfinite(g).all()
    assert abs(g.mean().item() - 0.5772) < 0.01
    assert abs(g.std().item() - 1.2825) < 0.01
    s = DeviceSampler(1, device="cpu")
    s.stage_slot(0, SamplingParams(temperature=1.0), 2 ** 64 - 1)
    assert int(s.seeds[0]) == -1
