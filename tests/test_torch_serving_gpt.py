"""GPT through the port's serving engine, against the JAX package's.

One ``gpt_tiny`` model (head dim 16, tied head, learned positions) is
built in the JAX package from a seed and its weights converted into the
port.  Six greedy prompts sharing a 19-token prefix (seeded numpy) are
served by ``Engine(kv_layout="paged", block_size=8, min_bucket=8,
max_seq=64, num_slots=4)`` and by the contiguous layout in both packages;
the generated ids must be identical (greedy argmax of f32 logits that
agree to ~1e-6).  The cached decode logits are held to the JAX cached path
within 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.serving import CacheContext as JaxCacheContext
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import KVCache as JaxKVCache
from paddle_tpu_torch import create_engine
from paddle_tpu_torch.models import (
    GPTForCausalLM, from_jax_state_dict, gpt_tiny,
)
from paddle_tpu_torch.serving import (
    CacheContext, Engine, KVCache, PagedCacheContext, PagedKVCache,
)

torch.set_num_threads(2)

ENGINE_KW = dict(block_size=8, min_bucket=8, max_seq=64, num_slots=4)
MAX_NEW = 6
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    paddle.seed(0)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny())
    jm.eval()
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(GPTForCausalLM(gpt_tiny(), device="cpu"), sd)
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
    assert te.cache.num_kv_heads == te.config.num_attention_heads


def test_prefix_hits_on_both_sides(runs):
    je, _, te, _ = runs["paged"]
    j_hit = je.stats()["paging"]["prefix"]["hit_rate"]
    t_hit = te.stats()["paging"]["prefix"]["hit_rate"]
    assert t_hit > 0 and j_hit > 0
    assert t_hit == j_hit            # one algorithm, the same prompts
    assert te.health()["kv_block_invariants"] == "ok"


def _jax_cached_logits(jm, cfg, prompt, steps, slot=1, bucket=16):
    """The JAX cached path, eagerly: prefill into ``slot`` then ``steps``
    greedy decode steps; the logits row of every forward."""
    cache = JaxKVCache(num_slots=3, num_layers=cfg.num_hidden_layers,
                       max_seq=32, num_kv_heads=cfg.num_attention_heads,
                       head_dim=cfg.head_dim)
    L = len(prompt)
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :L] = prompt
    rows = []
    with paddle.no_grad():
        ctx = JaxCacheContext(cache, "prefill",
                              slot=paddle.to_tensor(np.int32(slot)),
                              length=paddle.to_tensor(np.int32(L)))
        rows.append(jm(paddle.to_tensor(ids), cache_ctx=ctx).numpy()[0,
                                                                     L - 1])
        cache.set_length(slot, L)
        active = np.zeros((3,), np.int32)
        active[slot] = 1
        for _ in range(steps):
            toks = np.zeros((3, 1), np.int64)
            toks[slot, 0] = int(np.argmax(rows[-1]))
            dctx = JaxCacheContext(cache, "decode",
                                   active=paddle.to_tensor(active))
            rows.append(jm(paddle.to_tensor(toks),
                           cache_ctx=dctx).numpy()[slot, 0])
            cache.advance(paddle.to_tensor(active))
    return rows


@torch.no_grad()
def _port_cached_logits(tm, cfg, prompt, steps, layout, slot=1, bucket=16):
    """The port's cached path with the same inputs; slot, length and start
    are passed as device tensors, as the engine's programs pass them."""
    kw = dict(device="cpu")
    if layout == "paged":
        cache = PagedKVCache(3, cfg.num_hidden_layers, 32,
                             cfg.num_attention_heads, cfg.head_dim,
                             block_size=8, **kw)
        cache.begin_sequence(slot, [], 0, bucket)
    else:
        cache = KVCache(3, cfg.num_hidden_layers, 32,
                        cfg.num_attention_heads, cfg.head_dim, **kw)
    L = len(prompt)
    ids = torch.zeros((1, bucket), dtype=torch.int64)
    ids[0, :L] = torch.tensor(prompt)
    slot_t = torch.tensor([slot], dtype=torch.int32)
    if layout == "paged":
        ctx = PagedCacheContext(cache, "prefill", slot=slot_t,
                                start=torch.zeros(1, dtype=torch.int32))
    else:
        ctx = CacheContext(cache, "prefill", slot=slot_t)
    rows = [tm(ids, cache_ctx=ctx)[0, L - 1]]
    cache.set_length(slot_t, torch.tensor([L], dtype=torch.int32))
    active = torch.zeros(3, dtype=torch.int32)
    active[slot] = 1
    for i in range(steps):
        if layout == "paged":
            assert cache.ensure_capacity(slot, L + i)
        toks = torch.zeros((3, 1), dtype=torch.int64)
        toks[slot, 0] = int(rows[-1].argmax())
        rows.append(tm(toks, cache_ctx=CacheContext(cache, "decode"))[slot,
                                                                      0])
        cache.advance(active)
    return [r.numpy() for r in rows]


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cached_decode_logits_match_jax(setup, layout):
    """Prefill + 5 greedy decode steps through each package's cache path:
    every forward's logits agree within 1e-5."""
    jm, tm, _ = setup
    cfg = tm.config
    prompt = np.random.RandomState(3).randint(0, 128, (11,)).tolist()
    want = _jax_cached_logits(jm, cfg, prompt, 5)
    got = _port_cached_logits(tm, cfg, prompt, 5, layout)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_TOL)


@torch.no_grad()
def test_slot_reuse_after_retire(setup):
    """A retired slot's stale cache bytes never leak into the next request
    served from the same slot (``tests/test_serving.py``'s
    ``test_slot_reuse_after_retire``): the greedy chain of each prompt,
    longer first, equals the one a full no-cache forward gives."""
    _, tm, _ = setup
    cfg = tm.config
    rs = np.random.RandomState(1)
    long_p = rs.randint(0, cfg.vocab_size, (12,)).tolist()
    short_p = rs.randint(0, cfg.vocab_size, (4,)).tolist()
    cache = KVCache(2, cfg.num_hidden_layers, 32, cfg.num_attention_heads,
                    cfg.head_dim, device="cpu")
    slot = torch.tensor([1], dtype=torch.int32)
    active = torch.tensor([0, 1], dtype=torch.int32)
    for prompt in (long_p, short_p):
        L = len(prompt)
        ids = torch.zeros((1, 16), dtype=torch.int64)
        ids[0, :L] = torch.tensor(prompt)
        out = tm(ids, cache_ctx=CacheContext(cache, "prefill", slot=slot))
        cache.set_length(slot, torch.tensor([L], dtype=torch.int32))
        seq = list(prompt) + [int(out[0, L - 1].argmax())]
        for _ in range(3):
            toks = torch.zeros((2, 1), dtype=torch.int64)
            toks[1, 0] = seq[-1]
            lg = tm(toks, cache_ctx=CacheContext(cache, "decode"))
            cache.advance(active)
            seq.append(int(lg[1, 0].argmax()))
        full = tm(torch.tensor([seq[:-1]]))[0]
        assert [int(t) for t in full[L - 1:].argmax(-1)] == seq[L:]


def test_from_config_builds_gpt_and_rejects_unknown_specs():
    eng = create_engine("gpt:tiny", device="cpu", kv_layout="paged",
                        block_size=8, max_seq=32, num_slots=2)
    assert isinstance(eng.model, GPTForCausalLM)
    assert eng.model.config.hidden_dropout_prob == 0.0
    assert len(eng.generate([[1, 2, 3]], max_new_tokens=3)[0]) == 3
    with pytest.raises(KeyError, match="gpt:"):
        Engine.from_config("gpt:nope", device="cpu")
    with pytest.raises(KeyError):
        Engine.from_config("mamba:tiny", device="cpu")
    with pytest.raises(TypeError):
        Engine.from_config(12345, device="cpu")
