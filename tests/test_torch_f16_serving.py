"""float16 serving in the port against the JAX package's, on the CPU.

The K4 and K5 plain versions (what CPU tensors run; the card holds the
f16 kernels against them) take float16 and are held to the Pallas kernels
at float16 in interpret mode on seeded numpy inputs: K4 (decode, and the
speculative verify window as rows of K4) within ``F16_TOL`` = 4e-3, a
quarter of the bf16 figure beside it (1.6e-2, two bf16 ulps at |x| < 4:
f16 keeps three more mantissa bits); K5 within the same, its plain
version rounding p to f16 before P V as the tensor-core K5 does, where
the Pallas kernel keeps p in f32 (one f16 rounding of p apart).

A JAX model made f16 is ``amp.decorate(model, level="O2",
dtype="float16")``; the port's is built in float16 on the same weights.
GPT's f16 forward matches the JAX one op for op (names and dtypes, traced
through both packages' AMP hooks with an empty policy).  Llama departs at
one point, on purpose: the JAX rotary multiplies f16 q/k by its f32
cos/sin tables and returns f32, so its attention and everything after run
in f32 activations against f16 weights; the port's rotary rounds q and k
back to f16, so the whole forward stays in f16 and K1/K4/K5 take one
dtype (ROADMAP C).  The logits of the cached paths (prefill and 4 decode
steps, paged and contiguous) agree with the JAX cached path within
``LOGIT_TOL``; the engines' greedy streams are equal where the margins
allow: where a stream parts from the JAX engine's, the JAX model's own
f16 logits must hold the two tokens within ``2 * LOGIT_TOL`` (a near
tie).  A speculative f16 engine (its verify on K4's rows) gives the plain
f16 engine's greedy streams, and a tenancy engine (LoRA lanes, the JSON
grammar) serves in f16 with its lanes-off rows bitwise the plain
engine's.
"""
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.core import dispatch as jax_dispatch
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import gpt as jax_gpt, llama as jax_llama
from paddle_tpu.ops.pallas.paged_attention_kernel import (
    paged_decode_attention_kernel, paged_prefill_attention_kernel,
)
from paddle_tpu.serving import CacheContext as JaxCacheContext
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import KVCache as JaxKVCache
from paddle_tpu_torch import create_engine
from paddle_tpu_torch.amp import auto_cast as _port_amp  # noqa: F401
from paddle_tpu_torch.models import (
    GPTConfig, GPTForCausalLM, LlamaForCausalLM, from_jax_state_dict,
    gpt_tiny, llama_tiny,
)
from paddle_tpu_torch.ops import cached_attention as ca
from paddle_tpu_torch.serving import (
    CacheContext, Engine, JsonArrayGrammar, KVCache, PagedCacheContext,
    PagedKVCache, SamplingParams, SpecConfig, make_lora_weights,
)

jax_ac = sys.modules["paddle_tpu.amp.auto_cast"]
port_ac = sys.modules["paddle_tpu_torch.amp.auto_cast"]

torch.set_num_threads(2)

#: K4/K5 plain versions against Pallas at f16, and the bf16 figure
F16_TOL, BF16_TOL = 4e-3, 1.6e-2
#: logits of the two packages' f16 cached paths (|logits| < ~4 here; an
#: f16 ulp there is 2^-9, and the JAX Llama's activations are f32)
LOGIT_TOL = 1e-2
ENGINE_KW = dict(block_size=8, min_bucket=8, max_seq=64, num_slots=4)
MAX_NEW = 6


@pytest.fixture(scope="module", autouse=True)
def _single_device():
    """The JAX side runs unsharded; an earlier file in the same worker may
    leave a hybrid mesh set."""
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _j(x, dtype):
    return jnp.asarray(np.asarray(x, np.float32)).astype(dtype)


DTYPES = [(torch.float16, "float16", F16_TOL),
          (torch.bfloat16, "bfloat16", BF16_TOL)]


# -- K4 and K5 at f16 against Pallas ------------------------------------------

@pytest.mark.parametrize("tdt,jdt,tol", DTYPES)
@pytest.mark.parametrize("hkv,h", [(4, 4), (2, 4), (1, 8)])
def test_paged_decode_f16_matches_pallas(tdt, jdt, tol, hkv, h):
    """K4's plain version at f16 (and bf16 beside it): empty, partial and
    multi-block windows, MHA and query groups of 2 and 8."""
    rs = np.random.RandomState(0)
    NB, BS, D, B, MB = 13, 8, 16, 4, 4
    kp, vp = (rs.randn(NB, BS, hkv, D) for _ in range(2))
    tbl = rs.randint(1, NB, (B, MB)).astype(np.int32)
    lens = np.array([0, 7, 18, 31], np.int32)
    q = rs.randn(B, 1, h, D)
    ref = paged_decode_attention_kernel(
        _j(q, jdt), _j(kp, jdt), _j(vp, jdt), jnp.asarray(tbl),
        jnp.asarray(lens), interpret=True)
    out = ca.paged_decode_attention(_t(q, tdt), _t(kp, tdt), _t(vp, tdt),
                                    torch.from_numpy(tbl),
                                    torch.from_numpy(lens))
    assert out.dtype == tdt
    err = np.abs(out.float().numpy()
                 - np.asarray(ref.astype(jnp.float32))).max()
    assert err <= tol


@pytest.mark.parametrize("hkv,h", [(4, 4), (2, 4)])
def test_paged_verify_f16_is_k4_rows_of_pallas(hkv, h):
    """A speculative verify window (W = 4) at f16 as rows of K4: row
    ``(b, i)`` is a decode query over slot ``b``'s table to position
    ``lengths[b] + i``, the last ones clamped to the table's end."""
    rs = np.random.RandomState(1)
    NB, BS, D, B, MB, W = 15, 8, 16, 3, 4, 4
    kp, vp = (rs.randn(NB, BS, hkv, D) for _ in range(2))
    tbl = rs.randint(1, NB, (B, MB)).astype(np.int32)
    lens = np.array([0, 9, 29], np.int32)
    q = rs.randn(B, W, h, D)
    out = ca.paged_verify_attention(
        _t(q, torch.float16), _t(kp, torch.float16), _t(vp, torch.float16),
        torch.from_numpy(tbl), torch.from_numpy(lens))
    rows = np.repeat(tbl, W, axis=0)
    row_lens = np.minimum(lens[:, None] + np.arange(W)[None, :],
                          MB * BS - 1).reshape(-1).astype(np.int32)
    ref = paged_decode_attention_kernel(
        _j(q.reshape(B * W, 1, h, D), "float16"), _j(kp, "float16"),
        _j(vp, "float16"), jnp.asarray(rows), jnp.asarray(row_lens),
        interpret=True)
    err = np.abs(out.float().numpy().reshape(B * W, 1, h, D)
                 - np.asarray(ref.astype(jnp.float32))).max()
    assert out.dtype == torch.float16 and err <= F16_TOL


@pytest.mark.parametrize("tdt,jdt,tol", DTYPES)
@pytest.mark.parametrize("hkv,h", [(4, 4), (2, 4)])
@pytest.mark.parametrize("start", [0, 16, 80])
def test_paged_prefill_f16_matches_pallas(tdt, jdt, tol, hkv, h, start):
    """K5's plain version at f16 (and bf16): with and without a cached
    prefix, 16-query tails, MHA and GQA."""
    rs = np.random.RandomState(3)
    NB, BS, D, MB, S = 17, 8, 16, 12, 16
    kp, vp = (rs.randn(NB, BS, hkv, D) for _ in range(2))
    row = rs.randint(1, NB, (MB,)).astype(np.int32)
    q = rs.randn(1, S, h, D)
    ref = paged_prefill_attention_kernel(
        _j(q, jdt), _j(kp, jdt), _j(vp, jdt), jnp.asarray(row), start,
        interpret=True)
    out = ca.paged_prefill_attention(
        _t(q, tdt), _t(kp, tdt), _t(vp, tdt), torch.from_numpy(row),
        torch.tensor([start], dtype=torch.int32))
    assert out.dtype == tdt
    err = np.abs(out.float().numpy()
                 - np.asarray(ref.astype(jnp.float32))).max()
    assert err <= tol


def test_plain_prefill_rounds_p_like_the_kernel():
    """At f16 the plain K5 rounds p = exp(s - max) to f16 before P V and
    divides by the f32 sum of the unrounded p; in f32 it is the softmax."""
    rs = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rs.randn(1, 8, 2, 16).astype(np.float32))
               for _ in range(3))
    start = torch.tensor([0], dtype=torch.int32)
    h = ca.block_prefill_attention(q.half(), k.half(), v.half(), start)
    s = torch.einsum("bqhd,bkhd->bhqk", q.half().float(),
                     k.half().float()) / 4.0
    s = s.masked_fill(~torch.ones(8, 8, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = torch.einsum("bhqk,bkhd->bqhd", p.half().float(),
                        v.half().float()) / p.sum(-1, keepdim=True) \
        .transpose(1, 2)
    assert torch.equal(h, want.half())
    f = ca.block_prefill_attention(q, k, v, start)
    assert torch.equal(f, ca._masked_attention(
        q, k, v, torch.ones(8, 8, dtype=torch.bool).tril()[None, None]))


# -- the f16 models -------------------------------------------------------------

def _f16_pair(family: str, seed: int = 0):
    """A JAX model from ``seed`` made f16 by ``amp.decorate`` (O2) and the
    port's f16 model on its weights."""
    paddle.seed(seed)
    if family == "gpt":
        jm = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny())
        pm = GPTForCausalLM(gpt_tiny(), device="cpu", dtype=torch.float16)
    else:
        jm = jax_llama.LlamaForCausalLM(jax_llama.llama_tiny())
        pm = LlamaForCausalLM(llama_tiny(), device="cpu",
                              dtype=torch.float16)
    jm.eval()
    jm = paddle.amp.decorate(jm, level="O2", dtype="float16")
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert {str(a.dtype) for a in sd.values()} == {"float16"}
    return jm, from_jax_state_dict(pm.eval(), sd)


@pytest.fixture(scope="module")
def gpt():
    return _f16_pair("gpt")


@pytest.fixture(scope="module")
def llama():
    return _f16_pair("llama")


def _pair(request, gpt, llama):
    return gpt if request == "gpt" else llama


def _norm(d: str) -> str:
    d = d.split(".")[-1]
    return "int" if d.startswith(("int", "uint")) else d


def _jax_trace(model, ids):
    """Every JAX op of ``model``'s forward with its input and output
    dtypes, through the AMP hook with an empty policy (nothing cast)."""
    trace = []
    orig_wrap = jax_dispatch._wrap_outs

    def hook(name, args):
        trace.append([name, [_norm(str(a._value().dtype)) for a in args
                             if isinstance(a, JaxTensor)], None])
        return args

    def wrap(name, out, *a, **kw):
        res = orig_wrap(name, out, *a, **kw)
        rec = next(r for r in reversed(trace) if r[2] is None)
        rec[2] = [_norm(str(o._value().dtype))
                  for o in (res if isinstance(res, tuple) else (res,))]
        return res

    prev = jax_ac._state, jax_dispatch._amp_cast_hook
    jax_ac._state = jax_ac.AmpState(True, "float16", "O1", set(), set())
    jax_dispatch._amp_cast_hook, jax_dispatch._wrap_outs = hook, wrap
    try:
        model(paddle.to_tensor(ids))
    finally:
        jax_ac._state, jax_dispatch._amp_cast_hook = prev
        jax_dispatch._wrap_outs = orig_wrap
    # a transpose of the tied head's weight is a view in the port
    return [t for t in trace if t[0] != "t"]


def _port_trace(model, ids):
    """The port's ops of ``model``'s forward (the torch functions of
    ``auto_cast.TORCH_OPS`` and the port's own ops) with their dtypes,
    through its AMP dispatch with an empty policy (nothing cast)."""
    trace = []
    orig = port_ac._dispatch

    def dispatch(name, fn, args, kwargs):
        rec = [name, [_norm(str(a.dtype)) for a in
                      [*args, *kwargs.values()]
                      if isinstance(a, torch.Tensor)], None]
        trace.append(rec)
        res = orig(name, fn, args, kwargs)
        rec[2] = [_norm(str(o.dtype)) for o in
                  (res if isinstance(res, (tuple, list)) else (res,))]
        return res

    port_ac._dispatch = dispatch
    try:
        with torch.no_grad(), port_ac._policy(
                port_ac.AmpState(True, "float16", "O1", set(), set())):
            model(torch.from_numpy(ids))
    finally:
        port_ac._dispatch = orig
    return trace


def test_gpt_f16_forward_dtype_trace_matches_jax(gpt):
    """Op for op, the same names with the same input and output dtypes:
    embeddings, layer norms, linears, gelus, flash attention and the tied
    head all in f16, as ``amp.decorate(O2, float16)`` makes the JAX
    model; the logits agree within LOGIT_TOL."""
    jm, pm = gpt
    ids = np.random.RandomState(0).randint(0, 128, (2, 16))
    jt, pt = _jax_trace(jm, ids), _port_trace(pm, ids)
    assert [t[0] for t in pt] == [t[0] for t in jt]
    assert pt == jt
    assert {"embedding", "layer_norm", "linear", "flash_attention",
            "gelu", "matmul"} <= {t[0] for t in pt}
    assert all(d == "float16" for t in pt for d in t[2])
    want = np.asarray(jm(paddle.to_tensor(ids)).astype("float32").numpy())
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).float().numpy()
    assert np.abs(got - want).max() <= LOGIT_TOL


def test_llama_f16_forward_departs_only_at_rotary(llama):
    """The two traces agree up to the rotary embedding; there the JAX one
    promotes q and k to f32 (its f32 tables), and its attention, o_proj
    and residual stream run in f32 from then on, while every op of the
    port's forward stays in f16 (its rotary rounds q and k back).  The
    logits still agree within LOGIT_TOL."""
    jm, pm = llama
    ids = np.random.RandomState(0).randint(0, 128, (2, 16))
    jt, pt = _jax_trace(jm, ids), _port_trace(pm, ids)
    first = next(i for i, t in enumerate(jt) if t[0] == "rotary_embedding")
    assert pt[:first] == jt[:first]
    assert jt[first][2] == ["float32", "float32"]
    assert any(t[0] == "flash_attention" and t[2] == ["float32"]
               for t in jt)
    attn = [t for t in pt if t[0] == "flash_attention"]
    assert len(attn) == 2
    assert all(t[1] == ["float16"] * 3 and t[2] == ["float16"]
               for t in attn)
    assert all(d in ("float16", "int") for t in pt if t[0] in
               ("linear", "rms_norm", "flash_attention", "embedding",
                "silu")
               for d in t[1] + t[2])
    want = np.asarray(jm(paddle.to_tensor(ids)).astype("float32").numpy())
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).float().numpy()
    assert np.abs(got - want).max() <= LOGIT_TOL


# -- the cached paths and the engines -------------------------------------------

def _kv_heads(cfg):
    return getattr(cfg, "n_kv_heads", None) or cfg.num_attention_heads


def _jax_cached_logits(jm, cfg, prompt, feed, slot=1, bucket=16):
    """The JAX cached path at f16 (contiguous), eagerly: prefill into
    ``slot``, then one decode step per token of ``feed``; the f32 logits
    row of every forward."""
    cache = JaxKVCache(num_slots=3, num_layers=cfg.num_hidden_layers,
                       max_seq=32, num_kv_heads=_kv_heads(cfg),
                       head_dim=cfg.head_dim, dtype="float16")
    L = len(prompt)
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :L] = prompt
    rows = []
    with paddle.no_grad():
        ctx = JaxCacheContext(cache, "prefill",
                              slot=paddle.to_tensor(np.int32(slot)),
                              length=paddle.to_tensor(np.int32(L)))
        rows.append(jm(paddle.to_tensor(ids), cache_ctx=ctx)
                    .astype("float32").numpy()[0, L - 1])
        cache.set_length(slot, L)
        active = np.zeros((3,), np.int32)
        active[slot] = 1
        for tok in feed:
            toks = np.zeros((3, 1), np.int64)
            toks[slot, 0] = tok
            dctx = JaxCacheContext(cache, "decode",
                                   active=paddle.to_tensor(active))
            rows.append(jm(paddle.to_tensor(toks), cache_ctx=dctx)
                        .astype("float32").numpy()[slot, 0])
            cache.advance(paddle.to_tensor(active))
    return rows


@torch.no_grad()
def _port_cached_logits(pm, cfg, prompt, feed, layout, slot=1, bucket=16):
    """The port's cached path at f16 with the same inputs (slot, start and
    length as int32 tensors, as the engine's programs pass them)."""
    args = (3, cfg.num_hidden_layers, 32, _kv_heads(cfg), cfg.head_dim,
            torch.float16)
    if layout == "paged":
        cache = PagedKVCache(*args, block_size=8, device="cpu")
        cache.begin_sequence(slot, [], 0, bucket)
    else:
        cache = KVCache(*args, device="cpu")
    L = len(prompt)
    ids = torch.zeros((1, bucket), dtype=torch.int64)
    ids[0, :L] = torch.tensor(prompt)
    slot_t = torch.tensor([slot], dtype=torch.int32)
    ctx = (PagedCacheContext(cache, "prefill", slot=slot_t,
                             start=torch.zeros(1, dtype=torch.int32))
           if layout == "paged" else
           CacheContext(cache, "prefill", slot=slot_t))
    rows = [pm(ids, cache_ctx=ctx)[0, L - 1]]
    cache.set_length(slot_t, torch.tensor([L], dtype=torch.int32))
    active = torch.zeros(3, dtype=torch.int32)
    active[slot] = 1
    for i, tok in enumerate(feed):
        if layout == "paged":
            assert cache.ensure_capacity(slot, L + i)
        toks = torch.zeros((3, 1), dtype=torch.int64)
        toks[slot, 0] = tok
        rows.append(pm(toks, cache_ctx=CacheContext(cache, "decode"))[slot,
                                                                      0])
        cache.advance(active)
    assert all(r.dtype == torch.float16 for r in rows)
    return [r.float().numpy() for r in rows]


@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cached_f16_logits_match_jax(gpt, llama, family, layout):
    """Prefill and 4 decode steps fed the same tokens (the JAX greedy
    ones): every forward's logits agree within LOGIT_TOL, and the port's
    greedy token is the JAX one wherever the JAX margin exceeds twice
    that."""
    jm, pm = _pair(family, gpt, llama)
    cfg = pm.config
    prompt = np.random.RandomState(3).randint(0, 128, (11,)).tolist()
    feed = []
    for _ in range(4):          # the JAX greedy stream
        feed.append(int(np.argmax(_jax_cached_logits(jm, cfg, prompt,
                                                     feed)[-1])))
    want = _jax_cached_logits(jm, cfg, prompt, feed)
    got = _port_cached_logits(pm, cfg, prompt, feed, layout)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= LOGIT_TOL
        top2 = np.sort(w)[-2:]
        if top2[1] - top2[0] > 2 * LOGIT_TOL:
            assert int(np.argmax(g)) == int(np.argmax(w))


def _prompts():
    rs = np.random.RandomState(0)
    prefix = rs.randint(0, 128, (19,)).tolist()
    return [prefix + rs.randint(0, 128, (n,)).tolist()
            for n in (1, 4, 9, 13, 2, 7)]


def _near_tie(jm, prompt, stream, i, a: int, b: int) -> bool:
    """The JAX model's own f16 logits after ``prompt + stream[:i]`` hold
    tokens ``a`` and ``b`` within ``2 * LOGIT_TOL``."""
    ids = np.asarray([prompt + stream[:i]], np.int64)
    row = np.asarray(jm(paddle.to_tensor(ids)).astype("float32")
                     .numpy())[0, -1]
    return abs(float(row[a]) - float(row[b])) <= 2 * LOGIT_TOL


@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_f16_engine_streams_match_jax_where_margins_allow(gpt, llama,
                                                          family, layout):
    """Six greedy prompts sharing a 19-token prefix through the JAX f16
    engine and the port's (prefix cache on in the paged layout): every
    port stream equals the JAX one up to its end, or up to a near tie of
    the JAX model's own logits; the paged engine keeps its pool clean and
    hits the prefix cache; the KV cache is f16."""
    jm, pm = _pair(family, gpt, llama)
    prompts = _prompts()
    je = JaxEngine(jm, kv_layout=layout, **ENGINE_KW)
    want = je.generate(prompts, max_new_tokens=MAX_NEW)
    te = Engine(pm, kv_layout=layout, **ENGINE_KW)
    got = te.generate(prompts, max_new_tokens=MAX_NEW)
    assert te.cache.dtype == torch.float16
    assert all(len(s) == MAX_NEW for s in got)
    equal = 0
    for prompt, g, w in zip(prompts, got, want):
        if g == w:
            equal += 1
            continue
        i = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        assert _near_tie(jm, prompt, w, i, g[i], w[i]), (prompt, g, w)
    assert equal >= len(prompts) // 2
    if layout == "paged":
        st = te.stats()
        assert st["paging"]["prefix"]["hit_rate"] > 0
        assert st["health"]["kv_block_invariants"] == "ok"


def test_speculative_f16_round_gives_the_plain_streams(llama):
    """A paged f16 engine speculating with the target as its own draft
    (k 3; the verify runs as K4 rows at f16) gives the plain f16 engine's
    greedy streams, and its rounds accept drafts."""
    _, pm = llama
    prompts = _prompts()[:4]
    plain = Engine(pm, kv_layout="paged", **ENGINE_KW).generate(
        prompts, max_new_tokens=MAX_NEW)
    spec = Engine(pm, kv_layout="paged",
                  speculation=SpecConfig(draft_model=pm, k=3), **ENGINE_KW)
    spec.warmup()
    got = spec.generate(prompts, max_new_tokens=MAX_NEW)
    assert got == plain
    st = spec.stats()["speculation"]
    assert st["rounds"] > 0 and st["accepted"] > 0
    assert spec.spec.cache.dtype == torch.float16


def test_tenancy_f16_engine_lanes_off_bitwise_and_grammar_holds():
    """A GPT f16 engine with LoRA lanes and the JSON grammar: a request
    with no tenant gives the plain f16 engine's stream bitwise, an
    adapter's stream parts from it, and a json stream is accepted by the
    grammar's oracle."""
    pm = GPTForCausalLM(GPTConfig(vocab_size=128, hidden_size=32,
                                  num_hidden_layers=2,
                                  num_attention_heads=2,
                                  max_position_embeddings=128,
                                  hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0),
                        device="cpu", dtype=torch.float16,
                        generator=torch.Generator().manual_seed(3)).eval()
    prompts = _prompts()[:3]
    plain = Engine(pm, kv_layout="paged", **ENGINE_KW).generate(
        prompts, max_new_tokens=MAX_NEW)
    grammar = JsonArrayGrammar(eos_token_id=2)
    eng = Engine(pm, kv_layout="paged", adapters=dict(max_adapters=2, rank=4),
                 grammars={"json": grammar}, **ENGINE_KW)
    eng.warmup()
    eng.load_adapter("t1", make_lora_weights(eng.adapter_pool, seed=1,
                                             init_scale=0.5))
    assert eng.adapter_pool.dtype == torch.float16
    base = eng.generate(prompts, max_new_tokens=MAX_NEW)
    tuned = eng.generate(prompts, max_new_tokens=MAX_NEW,
                         sampling=SamplingParams(adapter="t1"))
    js = eng.add_request(prompts[0], max_new_tokens=12,
                         sampling=SamplingParams(grammar="json"))
    eng.run()
    assert base == plain
    assert tuned != plain
    assert js.state == "finished"
    assert grammar.accepts(js.output_ids, 128)


def test_create_engine_builds_f16_models():
    """``create_engine(..., dtype=torch.float16)`` builds the model and
    its pool in f16 and serves."""
    eng = create_engine("llama:tiny", device="cpu", dtype=torch.float16,
                        kv_layout="paged", **ENGINE_KW)
    assert next(eng.model.parameters()).dtype == torch.float16
    assert eng.cache.dtype == torch.float16
    out = eng.generate(_prompts()[:2], max_new_tokens=3)
    assert all(len(o) == 3 for o in out)
