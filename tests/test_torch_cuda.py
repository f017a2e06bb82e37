"""The port's CUDA kernels and engine on a card (skipped where there is none).

This file imports torch, the port and the helpers of ``chip_smoke`` and
``profile_serving`` only, so it also runs on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: 1e-4 absolute in f32 (sums in another order than the plain
version's; the f32 K1 and K2 also split each operand into two tf32
halves on the tensor cores, 3xTF32, off by ~2^-22 of a product; K4
merges its splits in log2 units), 3e-2 in
bf16 (two bf16 ulps at |x| < 4; both sides accumulate in f32 and round
once, and the bf16 K1/K5 also round p to bf16 before P V on the tensor
cores), 1e-3 on the f32 lse.  The backward
kernels' gradients sum over up to S rows, so they are held relative to
the plain version's largest value: 1e-4 in f32, 2e-2 in bf16 (the bf16
K2/K3 run on tensor cores and round p and ds where the plain versions
do).  Under attention dropout the kept probabilities, and so O, are
scaled by 1/(1-p), and O's tolerance with them.  The f16 instances of
K1-K3 are held to 1e-2 (O) and 1e-2 of the largest gradient: f16 keeps
three more mantissa bits than bf16, and both sides round p and ds to f16
at the same points; so are the f16 K4 and K5 (K5 and its plain version
round p to f16 before P V alike), and under an f16 overflow their
outputs must be non-finite exactly where the plain versions' are.
"""
import dataclasses
import gc
import time

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.models import (
    GPTConfig, GPTForCausalLM, LlamaConfig, LlamaForCausalLM,
)
from paddle_tpu_torch.ops import cached_attention as ca
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.attention import (
    _flash_bwd_dkv_reference, _flash_bwd_dq_reference, _sdpa_reference,
    flash_attention,
)
from paddle_tpu_torch.serving import (
    Engine, JsonArrayGrammar, RequestJournal, SamplingParams, SpecConfig,
    make_lora_weights,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2),
                                       (torch.float16, 1e-2)])
@pytest.mark.parametrize("hkv,h", [(8, 8), (1, 8)])
def test_kernels_match_plain(cuda_device, dtype, tol, hkv, h):
    """K4, K5 and K1 against their plain versions at head_dim 64, on a
    strided one-layer view of a two-layer pool."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    kp, vp = rand(40, 2, 16, hkv, 64)[:, 1], rand(40, 2, 16, hkv, 64)[:, 1]
    tbl = (torch.randperm(39, generator=g, device=cuda_device)[:24] + 1
           ).reshape(3, 8).to(torch.int32)
    lens = torch.tensor([0, 17, 127], dtype=torch.int32, device=cuda_device)
    q = rand(3, 1, h, 64)
    got = kernels.paged_decode(q, kp, vp, tbl, lens)
    want = ca.cached_attention(q, ca.gather_block_kv(kp, tbl),
                               ca.gather_block_kv(vp, tbl), lens)
    assert (got.float() - want.float()).abs().max().item() <= tol
    qs = rand(1, 40, h, 64)
    start = torch.tensor([32], dtype=torch.int32, device=cuda_device)
    got = kernels.paged_prefill(qs, kp, vp, tbl[2], start)
    want = ca.block_prefill_attention(qs, ca.gather_block_kv(kp, tbl[2:]),
                                      ca.gather_block_kv(vp, tbl[2:]), start)
    assert (got.float() - want.float()).abs().max().item() <= tol
    x = rand(2, 40, h, 64)
    o, lse = kernels.flash_fwd(x, x, x, causal=True)
    o_ref, lse_ref = _sdpa_reference(x, x, x, True, return_lse=True)
    assert (o.float() - o_ref.float()).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 1, 2, 32, device=cuda_device)        # head_dim 32
    pool = torch.zeros(3, 4, 2, 32, device=cuda_device)
    tbl = torch.ones(1, 2, dtype=torch.int32, device=cuda_device)
    lens = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        kernels.paged_decode(q, pool, pool, tbl, lens)
    q = torch.zeros(1, 1, 2, 64, device=cuda_device)
    pool = torch.zeros(3, 4, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        kernels.paged_decode(q, pool, pool, tbl.long(), lens)
    with pytest.raises(ValueError, match="dtype"):
        kernels.paged_decode(q, pool.half(), pool.half(), tbl, lens)
    # the bf16 tensor-core loop copies 16-byte rows: a row stride of 65
    # elements (130 bytes), or a base 2 bytes off, is refused
    odd = torch.zeros(1, 8, 2, 65, dtype=torch.bfloat16,
                      device=cuda_device)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        kernels.flash_fwd(odd, odd, odd)
    flat = torch.zeros(1 + 8 * 2 * 64, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:].view(1, 8, 2, 64)
    start = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.paged_prefill(shifted, pool.bfloat16(), pool.bfloat16(),
                              tbl[0], start)
    # K5 reads start from device memory: a host int is refused
    with pytest.raises(ValueError, match="start"):
        kernels.paged_prefill(q, pool, pool, tbl[0], 0)


def _decode_inputs(device, dtype, lengths, h=32, hkv=32, d=128, bs=16,
                   max_seq=2048, shared_blocks=0):
    """Seeded K4 inputs on a strided one-layer view of a two-layer pool,
    the slots' blocks shuffled; ``shared_blocks``: every table row starts
    with row 0's first blocks (a prefix-cache hit)."""
    g = torch.Generator(device=device).manual_seed(6)
    B, MB = len(lengths), max_seq // bs

    def pool():
        return torch.randn((B * MB + 1, 2, bs, hkv, d), generator=g,
                           device=device).to(dtype)[:, 1]

    kp, vp = pool(), pool()
    tbl = (torch.randperm(B * MB, generator=g, device=device) + 1
           ).reshape(B, MB).to(torch.int32)
    if shared_blocks:
        tbl[:, :shared_blocks] = tbl[0, :shared_blocks].clone()
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    q = torch.randn((B, 1, h, d), generator=g, device=device).to(dtype)
    return q, kp, vp, tbl, lens


#: K4's edge cases: an empty window, windows about one split long, a
#: length past the table, one long slot, a 32768-position table (its grid
#: is capped, so a block walks several splits), query groups of 1, 2, 4
#: and 8 at D 64 and 128 and of 3 (a bucket of 4 with a row unused),
#: block size 32, and rows sharing their first 32 blocks
_P = kernels.DECODE_SPLIT_KEYS
DECODE_EDGES = {
    "len0": dict(lengths=[0]),
    "split_edges": dict(lengths=[_P - 1, _P, _P + 1]),
    "past_table": dict(lengths=[1024 + 37, 500], max_seq=1024),
    "B1_len4095": dict(lengths=[4095], max_seq=4096),
    "long_table": dict(lengths=[30000, 700], max_seq=32768),
    **{f"G{G}_D{d}": dict(lengths=[0, 300, 777, 1500], h=4 * G, hkv=4, d=d)
       for G in (1, 2, 4, 8) for d in (64, 128)},
    "G3_D128": dict(lengths=[0, 300, 777, 1500], h=12, hkv=4),
    "bs32": dict(lengths=[100, 1000, 2047], bs=32),
    "shared_prefix": dict(lengths=[600, 900, 511, 1500], shared_blocks=32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2),
                                       (torch.float16, 1e-2)])
@pytest.mark.parametrize("case", sorted(DECODE_EDGES))
def test_paged_decode_edges_match_plain(cuda_device, dtype, tol, case):
    """The split-K K4 against ``gather_block_kv`` + ``cached_attention``,
    and two calls on the same inputs agree bitwise (the splits are merged
    in split order, with no float atomics)."""
    args = _decode_inputs(cuda_device, dtype, **DECODE_EDGES[case])
    q, kp, vp, tbl, lens = args
    got = kernels.paged_decode(*args)
    want = ca.cached_attention(q, ca.gather_block_kv(kp, tbl),
                               ca.gather_block_kv(vp, tbl), lens)
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, kernels.paged_decode(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_never_reads_dead_positions(cuda_device, dtype):
    """Rows past each slot's length, in its last block and in the blocks
    after it, are overwritten with NaN: the result does not change, at
    one split and at several (lengths past 2 * split_keys)."""
    args = _decode_inputs(cuda_device, dtype, [4, 600, 2 * _P + 30], h=8,
                          hkv=2)
    q, kp, vp, tbl, lens = args
    want = kernels.paged_decode(*args)
    live = torch.zeros(kp.shape[:2], dtype=torch.bool, device=cuda_device)
    bs = kp.shape[1]
    for b, n in enumerate(lens.tolist()):
        pos = torch.arange(n + 1, device=cuda_device)
        live[tbl[b].long()[pos // bs], pos % bs] = True
    kp[~live] = float("nan")
    vp[~live] = float("nan")
    got = kernels.paged_decode(*args)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_paged_decode_issues_no_host_sync(cuda_device):
    """K4's grid and scratch come from the shapes alone: the wrapper never
    reads the lengths back, so it runs under ``set_sync_debug_mode
    ("error")``, including a call that grows the merge tickets."""
    small = _decode_inputs(cuda_device, torch.bfloat16, [5, 700])
    large = _decode_inputs(cuda_device, torch.bfloat16, [5, 700, 1500, 30])
    kernels.paged_decode(*small)            # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [kernels.paged_decode(*args) for args in (small, large,
                                                         small)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(torch.isfinite(o.float()).all() for o in outs)
    assert torch.equal(outs[0], outs[2])


@pytest.mark.cuda
def test_paged_decode_refuses_misaligned_rows(cuda_device):
    """K4 copies 16-byte rows in both dtypes: an f32 row stride of 66
    elements (264 bytes) is refused before any launch."""
    q = torch.zeros(1, 1, 2, 64, device=cuda_device)
    pool = torch.zeros(3, 4, 2, 66, device=cuda_device)[..., :64]
    tbl = torch.ones(1, 2, dtype=torch.int32, device=cuda_device)
    lens = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        kernels.paged_decode(q, pool, pool, tbl, lens)
    assert kernels.KERNELS["paged_decode"].launches == 0


@pytest.mark.cuda
def test_engine_kernel_path_matches_reference_path(cuda_device):
    """A GQA model at head_dim 64 in f32: the paged engine on K4/K5 gives
    the greedy (and seeded sampled) tokens of the plain reference path,
    and the contiguous engine on K1 the same greedy tokens."""
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      intermediate_size=512, max_position_embeddings=256)
    model = LlamaForCausalLM(
        cfg, device=cuda_device,
        generator=torch.Generator(device=cuda_device).manual_seed(0))
    rs = np.random.RandomState(0)
    prefix = rs.randint(0, 512, (40,)).tolist()
    prompts = [prefix + rs.randint(0, 512, (n,)).tolist()
               for n in (3, 20, 57, 9)]
    kw = dict(num_slots=2, max_seq=256, min_bucket=16, block_size=16)

    def run(layout, kernel, sampling=None):
        eng = Engine(model, kv_layout=layout, kernel=kernel, **kw)
        kernels.reset_launches()
        out = eng.generate(prompts, max_new_tokens=8,
                           **({} if sampling is None
                              else {"sampling": sampling}))
        return out, {n: k.launches for n, k in kernels.KERNELS.items()}

    ref, ref_launches = run("paged", "reference")
    got, got_launches = run("paged", "cuda")
    assert got == ref
    assert sum(ref_launches.values()) == 0
    assert got_launches["paged_decode"] > 0 and \
        got_launches["paged_prefill"] > 0
    contiguous, c_launches = run("contiguous", "auto")
    assert contiguous == ref and c_launches["flash_fwd"] > 0
    law = SamplingParams(temperature=0.9, top_k=50, seed=3)
    assert run("paged", "cuda", law)[0] == run("paged", "reference", law)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 70, 1000])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_fwd_bf16_tensor_cores_match_plain(cuda_device, S, causal, d):
    """The bf16 K1 (wgmma tile loop) against ``_sdpa_reference``: one part
    tile (16), a full tile and a part one (70), 16 tiles ragged (1000)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn((2, S, 3, d), generator=g, device=cuda_device)
               .bfloat16() for _ in range(3))
    o, lse = kernels.flash_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = _sdpa_reference(q, k, v, causal, return_lse=True)
    assert o.dtype == torch.bfloat16 and torch.isfinite(o.float()).all()
    assert (o.float() - o_ref.float()).abs().max().item() <= 3e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_fwd_bf16_reads_fused_qkv_views(cuda_device, d):
    """K1 on q/k/v split off one ``[B, S, H, 3*D]`` projection (row stride
    3*H*D, as GPT hands them over) equals K1 on contiguous copies."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = torch.randn((2, 200, 4, 3 * d), generator=g,
                          device=cuda_device).bfloat16().split(d, dim=-1)
    o, lse = kernels.flash_fwd(q, k, v, causal=True)
    o2, lse2 = kernels.flash_fwd(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_ref = _sdpa_reference(q, k, v, True)
    assert (o.float() - o_ref.float()).abs().max().item() <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("S,start", [(16, 0), (32, 1008), (128, 512)])
@pytest.mark.parametrize("hkv,h", [(8, 8), (2, 8)])
def test_paged_prefill_bf16_tensor_cores_match_plain(cuda_device, S, start,
                                                     hkv, h):
    """The bf16 K5 (wgmma tile loop through the block table) against
    ``block_prefill_attention`` on the gathered cache, on a strided
    one-layer view of a two-layer pool: a 16-query tail from 0, a
    32-query tail after a start that is a multiple of 16 but not of 64,
    and two full tiles after 512."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    n_blocks = (start + S) // 16 + 8

    def pool():
        return torch.randn((n_blocks + 1, 2, 16, hkv, 128), generator=g,
                           device=cuda_device).bfloat16()[:, 1]

    kp, vp = pool(), pool()
    row = (torch.randperm(n_blocks, generator=g, device=cuda_device) + 1
           ).to(torch.int32)
    q = torch.randn((1, S, h, 128), generator=g,
                    device=cuda_device).bfloat16()
    start = torch.tensor([start], dtype=torch.int32, device=cuda_device)
    got = kernels.paged_prefill(q, kp, vp, row, start)
    want = ca.block_prefill_attention(q, ca.gather_block_kv(kp, row[None]),
                                      ca.gather_block_kv(vp, row[None]),
                                      start)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("S,start", [(16, 0), (32, 1008), (128, 512)])
@pytest.mark.parametrize("hkv,h", [(8, 8), (2, 8)])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_prefill_f16_tensor_cores_match_plain(cuda_device, S, start,
                                                    hkv, h, d):
    """The f16 K5 (the wgmma tile loop at f16) against
    ``block_prefill_attention``, which rounds p to f16 before P V as the
    kernel does, at the bf16 test's tails and both head dims; a launch
    counts as ``paged_prefill_f16``."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    n_blocks = (start + S) // 16 + 8

    def pool():
        return torch.randn((n_blocks + 1, 2, 16, hkv, d), generator=g,
                           device=cuda_device).half()[:, 1]

    kp, vp = pool(), pool()
    row = (torch.randperm(n_blocks, generator=g, device=cuda_device) + 1
           ).to(torch.int32)
    q = torch.randn((1, S, h, d), generator=g, device=cuda_device).half()
    start = torch.tensor([start], dtype=torch.int32, device=cuda_device)
    kernels.reset_launches()
    got = kernels.paged_prefill(q, kp, vp, row, start)
    assert kernels.KERNELS["paged_prefill_f16"].launches == 1
    assert kernels.KERNELS["paged_prefill"].launches == 0
    want = ca.block_prefill_attention(q, ca.gather_block_kv(kp, row[None]),
                                      ca.gather_block_kv(vp, row[None]),
                                      start)
    assert got.dtype == torch.float16 and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 1e-2


@pytest.mark.cuda
def test_paged_f16_overflow_is_never_clamped(cuda_device):
    """A +inf V row (a projection past 65504 rounds to inf): K4's and
    K5's f16 outputs are non-finite exactly where the plain versions'
    are, and finite elsewhere."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    dec = chip_smoke.check_decode(g, 32, 32, torch.float16,
                                  [700, 1500, 33], inf_at=2)
    pre = chip_smoke.check_prefill(g, 8, 8, torch.float16, 512, 128,
                                   max_seq=1024, inf_at=2)
    for res in (dec, pre):
        assert res["err"] == 0.0 and res["nonfinite_kernel"] > 0
        assert res["nonfinite_kernel"] == res["nonfinite_plain"]


@pytest.mark.cuda
def test_registered_op_launches_k1_on_the_card(cuda_device):
    """``paddle_tpu_torch::flash_fwd`` on CUDA tensors runs K1 and nothing
    else: one launch counted per call (``flash_fwd_f16`` at f16), the
    kernel's own output; no-grad attention goes through it; a shape K1
    does not take raises instead of running the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v = (torch.randn((2, 100, 4, 64), generator=g, device=cuda_device)
               .half() for _ in range(3))
    kernels.reset_launches()
    o, lse = torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, True)
    assert kernels.launch_counts()["flash_fwd_f16"] == 1
    ko, klse = kernels.flash_fwd(q, k, v, True)
    assert torch.equal(o, ko) and torch.equal(lse, klse)
    kernels.reset_launches()
    with torch.no_grad():
        out = flash_attention(q, k, v, is_causal=True)
    assert torch.equal(out, ko)
    assert kernels.launch_counts() == {
        n: int(n == "flash_fwd_f16") for n in kernels.KERNELS}
    odd = torch.zeros((1, 8, 2, 32), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        torch.ops.paddle_tpu_torch.flash_fwd(odd, odd, odd, True)


@pytest.mark.cuda
def test_cpu_saved_artifact_runs_on_the_card(cuda_device, tmp_path):
    """A small f16 GPT saved on the CPU, loaded by a predictor on the
    card: its program's CPU devices are moved, it runs K1 once a layer,
    and its logits agree with the CPU predictor's within 1e-2."""
    res = chip_smoke.cpu_artifact_on_card(str(tmp_path), "cuda")
    assert res["device"].startswith("cuda")
    assert res["launches"]["flash_fwd_f16"] == res["layers"]
    assert res["err"] <= res["tolerance"]


@pytest.mark.cuda
def test_f16_engines_run_the_f16_kernels(cuda_device):
    """A GQA Llama at head dim 64 in f16: the paged engine launches only
    the f16 K4/K5 and gives the greedy tokens of its reference path where
    they do not part on a near tie (at least 3 of 4 streams), and the
    contiguous engine's prefill runs the f16 K1."""
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      intermediate_size=512, max_position_embeddings=256)
    model = LlamaForCausalLM(
        cfg, device=cuda_device, dtype=torch.float16,
        generator=torch.Generator(device=cuda_device).manual_seed(0))
    rs = np.random.RandomState(0)
    prefix = rs.randint(0, 512, (40,)).tolist()
    prompts = [prefix + rs.randint(0, 512, (n,)).tolist()
               for n in (3, 20, 57, 9)]
    kw = dict(num_slots=2, max_seq=256, min_bucket=16, block_size=16)

    def run(layout, kernel):
        eng = Engine(model, kv_layout=layout, kernel=kernel, **kw)
        kernels.reset_launches()
        out = eng.generate(prompts, max_new_tokens=8)
        return out, kernels.launch_counts()

    ref, ref_launches = run("paged", "reference")
    got, launches = run("paged", "cuda")
    assert sum(ref_launches.values()) == 0
    assert launches["paged_decode_f16"] > 0
    assert launches["paged_prefill_f16"] > 0
    assert launches["paged_decode"] == launches["paged_prefill"] == 0
    assert sum(a == b for a, b in zip(got, ref)) >= 3
    _, c_launches = run("contiguous", "auto")
    assert c_launches["flash_fwd_f16"] > 0 and c_launches["flash_fwd"] == 0


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H", [(2, 16, 3), (2, 70, 3), (2, 1000, 3),
                                   (4, 1000, 32)])
def test_backward_kernels_match_plain(cuda_device, dtype, rel, d, causal,
                                      B, S, H):
    """K2 and K3 on strided views of a fused ``[B, S, H, 3*D]`` qkv, lse
    and delta from the plain forward: one part-filled tile (S 16), a full
    tile and a part one (70), 16 tiles ragged (1000), and at B 4, H 32
    2048 blocks, several waves of the card."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = torch.randn((B, S, H, 3 * d), generator=g,
                          device=cuda_device).to(dtype).split(d, dim=-1)
    do = torch.randn((B, S, H, d), generator=g, device=cuda_device).to(dtype)
    o, lse = _sdpa_reference(q, k, v, causal, return_lse=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
        .contiguous().view(B * H, S)
    args = (q, k, v, do, lse, delta, causal)
    dk, dv = kernels.flash_bwd_dkv(*args)
    dq = kernels.flash_bwd_dq(*args)
    rk, rv = _flash_bwd_dkv_reference(*args)
    rq = _flash_bwd_dq_reference(*args)
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == dtype and got.shape == (B, S, H, d)
        assert _rel_err(got, want) <= rel


@pytest.mark.cuda
def test_flash_attention_gradients_kernel_vs_reference(cuda_device):
    """The autograd Function (K1 + K2 + K3) against its plain path, f32,
    through a fused qkv as the GPT model feeds it."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn((2, 130, 4, 192), generator=g, device=cuda_device)
    do = torch.randn((2, 130, 4, 64), generator=g, device=cuda_device)
    grads, outs = [], []
    for kernel in ("cuda", "reference"):
        t = qkv.clone().requires_grad_()
        kernels.reset_launches()
        out = flash_attention(*t.split(64, dim=-1), is_causal=True,
                              kernel=kernel)
        out.backward(do)
        outs.append(out.detach())
        grads.append(t.grad)
        launched = kernels.KERNELS["flash_bwd_dq"].launches
        assert launched == (1 if kernel == "cuda" else 0)
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-4
    assert _rel_err(grads[0], grads[1]) <= 1e-4


@pytest.mark.cuda
def test_backward_wrappers_raise_on_bad_rows(cuda_device):
    x = torch.zeros(1, 8, 2, 64, device=cuda_device)
    good = torch.zeros(2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="lse/delta"):
        kernels.flash_bwd_dq(x, x, x, x, good.t().contiguous(), good)
    with pytest.raises(ValueError, match="lse/delta"):
        kernels.flash_bwd_dkv(x, x, x, x, good, good.double())


@pytest.mark.cuda
def test_backward_wrappers_refuse_misaligned_bf16_rows(cuda_device):
    """The bf16 K2/K3 copy 16-byte rows: a row stride of 65 elements, or a
    base 2 bytes off, is refused before any launch."""
    rows = torch.zeros(2, 8, device=cuda_device)
    odd = torch.zeros(1, 8, 2, 65, dtype=torch.bfloat16,
                      device=cuda_device)[..., :64]
    flat = torch.zeros(1 + 8 * 2 * 64, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:].view(1, 8, 2, 64)
    good = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, device=cuda_device)
    kernels.reset_launches()
    for bad in (odd, shifted):
        with pytest.raises(ValueError, match="16-byte"):
            kernels.flash_bwd_dkv(good, bad, good, good, rows, rows)
        with pytest.raises(ValueError, match="16-byte"):
            kernels.flash_bwd_dq(good, good, good, bad, rows, rows)
    assert kernels.KERNELS["flash_bwd_dkv"].launches == 0
    assert kernels.KERNELS["flash_bwd_dq"].launches == 0


@pytest.mark.cuda
def test_gpt_loss_and_gradients_kernel_vs_reference(cuda_device):
    """A small GPT (head dim 64) in f32: ``compute_loss`` and every
    gradient on the kernel path against ``kernel="reference"``."""
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=128,
                    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    x, y = (torch.from_numpy(np.random.RandomState(i).randint(
        0, 512, (2, 96))).to(cuda_device) for i in range(2))
    res = []
    for kernel in ("cuda", "reference"):
        m = GPTForCausalLM(
            cfg, device=cuda_device, kernel=kernel,
            generator=torch.Generator(device=cuda_device).manual_seed(0))
        loss = m.compute_loss(x, y)
        loss.backward()
        res.append((loss.item(), {n: p.grad for n, p in
                                  m.named_parameters()}))
    (loss, grads), (ref_loss, ref_grads) = res
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    for n, want in ref_grads.items():
        assert _rel_err(grads[n], want) <= 1e-4, n


@pytest.mark.cuda
def test_gpt_bf16_loss_and_gradients_kernel_vs_reference(cuda_device):
    """A small GPT (head dim 64) in bf16: ``compute_loss`` and every
    gradient through K1 (tensor cores) -> K2/K3 against the reference
    path.  The two paths round at other points (K1 rounds p to bf16, the
    reference rounds only its output), so the loss is held to 1e-2
    relative and each gradient to 5e-2 of its reference norm."""
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=256,
                    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    x, y = (torch.from_numpy(np.random.RandomState(i).randint(
        0, 512, (2, 200))).to(cuda_device) for i in range(2))
    res = []
    for kernel in ("cuda", "reference"):
        m = GPTForCausalLM(
            cfg, device=cuda_device, dtype=torch.bfloat16, kernel=kernel,
            generator=torch.Generator(device=cuda_device).manual_seed(0))
        kernels.reset_launches()
        loss = m.compute_loss(x, y)
        loss.backward()
        launched = {n: k.launches for n, k in kernels.KERNELS.items()}
        res.append((loss.float().item(), launched,
                    {n: p.grad.float() for n, p in m.named_parameters()}))
    (loss, launched, grads), (ref_loss, ref_launched, ref_grads) = res
    assert launched["flash_fwd"] == launched["flash_bwd_dq"] == 2
    assert sum(ref_launched.values()) == 0
    assert np.isfinite(loss) and loss == pytest.approx(ref_loss, rel=1e-2)
    for n, want in ref_grads.items():
        err = ((grads[n] - want).norm() / want.norm().clamp(min=1e-30))
        assert err.item() <= 5e-2, n


# -- the engine's step programs as CUDA graphs -------------------------------

def _small_model(family, device, seed=0):
    """A 2-layer f32 model at head dim 64 (GPT) or 64 with GQA (Llama),
    its weights from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if family == "gpt":
        cfg = GPTConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                        num_attention_heads=4, max_position_embeddings=256,
                        hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
        return GPTForCausalLM(cfg, device=device, generator=gen).eval()
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      intermediate_size=512, max_position_embeddings=256)
    return LlamaForCausalLM(cfg, device=device, generator=gen).eval()


_ENGINE_KW = dict(num_slots=4, max_seq=256, min_bucket=16, block_size=16)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_replayed_steps_equal_eager_bodies(cuda_device, family, layout):
    """Seeded requests (greedy, temperature, top-k, top-p) served through
    the engine's CUDA graphs and through its step bodies called eagerly
    give the same tokens, token for token."""
    model = _small_model(family, cuda_device)
    reqs = chip_smoke.make_requests(512, 4, 40, [3, 30, 17, 70], seed=5)
    res = chip_smoke.drive_graph_parity(model, layout, reqs, 10,
                                        **_ENGINE_KW)
    assert res["programs"] == res["eager"]
    cc = res["compile_cache"]
    assert cc["after_warmup"] == 0 and cc["hits"] >= 4 + 9


@pytest.mark.cuda
def test_capture_after_warmup_counts_a_miss(cuda_device):
    """A bucket that warmup did not build is captured at its first
    admission: one miss after warmup, then hits."""
    eng = Engine(_small_model("gpt", cuda_device), kv_layout="paged",
                 **_ENGINE_KW)
    assert eng.warmup(buckets=[16])["compile_misses"] == 2
    eng.generate([list(range(5))], max_new_tokens=3)
    assert eng.stats()["compile_cache"]["after_warmup"] == 0
    eng.generate([list(range(20))], max_new_tokens=3)      # bucket 32
    cc = eng.stats()["compile_cache"]
    assert cc["after_warmup"] == 1 and cc["misses"] == 3
    eng.generate([list(range(30))], max_new_tokens=3)
    assert eng.stats()["compile_cache"]["misses"] == 3
    assert ("prefill", 32) in eng.programs.keys()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_paged_prefill_device_start_replayed(cuda_device, dtype, tol):
    """K5 captured once into a CUDA graph with its start in device memory,
    then replayed at other starts written into that memory, matches its
    plain version at each (a negative start counts as 0 in both)."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    S, h, hkv, d, n_blocks = 32, 8, 2, 64, 40
    kp, vp = (torch.randn((n_blocks + 1, 2, 16, hkv, d), generator=g,
                          device=cuda_device).to(dtype)[:, 1]
              for _ in range(2))
    row = (torch.randperm(n_blocks, generator=g, device=cuda_device) + 1
           ).to(torch.int32)
    q = torch.randn((1, S, h, d), generator=g, device=cuda_device).to(dtype)
    start = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.paged_prefill(q, kp, vp, row, start)        # load, opt in
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernels.paged_prefill(q, kp, vp, row, start)
    for s in (0, 16, 80, 512, -16):
        start.fill_(s)
        graph.replay()
        want = ca.block_prefill_attention(
            q, ca.gather_block_kv(kp, row[None]),
            ca.gather_block_kv(vp, row[None]), start)
        assert (out.float() - want.float()).abs().max().item() <= tol, s


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_replayed_decode_step_issues_no_host_sync(cuda_device, layout):
    """A replayed decode step (the active mask copied in from pinned
    memory, then the graph) runs under ``set_sync_debug_mode("error")``."""
    eng = Engine(_small_model("llama", cuda_device), kv_layout=layout,
                 **_ENGINE_KW)
    eng.warmup()
    eng.add_request(list(range(9)), max_new_tokens=8)
    eng.step()                                  # admission + one decode
    active = np.zeros(eng.num_slots, dtype=np.int32)
    active[list(eng.running)] = 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng._run_decode(active)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.shape == (eng.num_slots,) and out.dtype == torch.int32
    assert eng.stats()["compile_cache"]["after_warmup"] == 0


@pytest.mark.cuda
def test_launch_counts_are_per_replay(cuda_device):
    """A replayed graph adds the launches its capture made: K4 once per
    layer per decode step, K5 once per layer per admission."""
    eng = Engine(_small_model("gpt", cuda_device), kv_layout="paged",
                 **_ENGINE_KW)
    eng.warmup()
    kernels.reset_launches()
    eng.generate([list(range(12))], max_new_tokens=6)
    layers = eng.config.num_hidden_layers
    assert kernels.KERNELS["paged_prefill"].launches == layers
    assert kernels.KERNELS["paged_decode"].launches == 5 * layers


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_launch_counts_equal_the_profiled_kernels(cuda_device, layout):
    """Under replay the counts are bookkept (a replay adds its capture's);
    the profiler sees the device's own launches: K4/K5 (paged) or K1
    (contiguous prefill) counted as many times as the trace shows them."""
    import profile_serving
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = Engine(_small_model("gpt", cuda_device), kv_layout=layout,
                 **_ENGINE_KW)
    eng.warmup()
    torch.cuda.synchronize()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the window's first device records can be lost (profile_serving)
        time.sleep(profile_serving.WINDOW_LEAD_S)
        eng.generate([list(range(12)), list(range(40))], max_new_tokens=6)
        torch.cuda.synchronize()
    counted = kernels.launch_counts()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    profiled = profile_serving.port_kernel_counts(events)
    profile_serving.check_counts(counted, profiled)
    k = "paged_prefill" if layout == "paged" else "flash_fwd"
    assert counted[k] == 2 * eng.config.num_hidden_layers


# -- the request lifecycle over replayed graphs ------------------------------

def _alone_twice(eng, prompt, law, **kw):
    """``prompt`` served alone twice on ``eng``; the second stream (in the
    paged layout its admission hits the first's prompt blocks, as a
    resume's does)."""
    for _ in range(2):
        r = eng.add_request(prompt, sampling=law, max_new_tokens=10, **kw)
        eng.run()
    return r.output_ids


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_decode_retry_restores_replayed_lanes(cuda_device, layout):
    """A decode replay that ran and then failed has moved the lengths,
    the token lane and the draw counters; ``_restore_lanes`` rewrites
    them from the host's bookkeeping, and the replay run again samples
    the same tokens.  Through the engine's retry, a decode failing after
    its replay leaves every seeded stream unchanged."""
    eng = Engine(_small_model("llama", cuda_device), kv_layout=layout,
                 **_ENGINE_KW)
    eng.warmup()
    laws = chip_smoke.sampling_laws(3)
    prompts = [list(range(5 + 7 * i, 30 + 7 * i)) for i in range(4)]
    for p, s in zip(prompts[:2], laws[2:]):
        eng.add_request(p, sampling=s, max_new_tokens=10)
    eng.step()
    running = sorted(eng.running)
    active = np.zeros(eng.num_slots, dtype=np.int32)
    active[running] = 1
    lanes = (eng.cache.lengths, eng.sampler.tokens, eng.sampler.counters)
    before = [t.cpu()[running].clone() for t in lanes]
    lengths = eng.cache.lengths.cpu().clone()
    first = eng._run_decode(active).cpu()
    moved = [t.cpu()[running].clone() for t in lanes]
    assert not torch.equal(moved[0], before[0])          # lengths advanced
    assert not torch.equal(moved[2], before[2])          # counters drew
    eng._restore_lanes()
    assert all(torch.equal(t.cpu()[running], b)
               for t, b in zip(lanes, before))
    assert torch.equal(eng.cache.lengths.cpu(), lengths)
    again = eng._run_decode(active).cpu()
    assert torch.equal(again[running], first[running])
    assert all(torch.equal(t.cpu()[running], m) for t, m in zip(lanes, moved))
    for r in list(eng.running.values()):
        r.cancel()
    eng.run()

    def serve():
        reqs = [eng.add_request(p, sampling=s, max_new_tokens=10)
                for p, s in zip(prompts, laws)]
        eng.run()
        return [r.output_ids for r in reqs]

    ref = serve()
    run, calls = eng.programs.run, [0]

    def after(key, body, *inputs):
        out = run(key, body, *inputs)
        if key[0] == "decode":
            calls[0] += 1
            if calls[0] in (2, 5):
                raise RuntimeError("injected fault after the replay")
        return out

    eng.programs.run = after
    try:
        got = serve()
    finally:
        del eng.programs.run
    assert got == ref
    st = eng.stats()
    assert st["failures"]["retries_by_point"] == {"serving.decode": 2}
    assert st["compile_cache"]["after_warmup"] == 0


@pytest.mark.cuda
def test_preempted_slot_decodes_safely_and_resumes(cuda_device):
    """A preempted slot's row points at scratch with length 0 when the
    next replayed decode runs: the pool stays sound, and the victim's
    resume (a prefix hit and a tail-bucket K5 prefill) gives the stream
    it gives served alone."""
    eng = Engine(_small_model("gpt", cuda_device), kv_layout="paged",
                 max_preemptions=2, priority_aging_s=30, **_ENGINE_KW)
    eng.warmup()
    laws = chip_smoke.sampling_laws(5)
    lows = [(list(range(3 + i, 43 + i)), laws[i]) for i in range(4)]
    refs = [_alone_twice(eng, p, s) for p, s in lows]
    reqs = [eng.add_request(p, sampling=s, max_new_tokens=10,
                            priority="low") for p, s in lows]
    eng.step()
    eng.step()
    hi = eng.add_request(list(range(90, 110)), max_new_tokens=4,
                         priority="high")
    eng.step()                                   # preempts one low
    victims = [r for r in reqs if r.preempted]
    assert len(victims) == 1 and hi.state == "running"
    slot_free = [s for s in range(eng.num_slots) if s not in eng.running]
    assert eng.cache.lengths.cpu()[slot_free].tolist() == [0] * len(
        slot_free)
    eng.step()                                   # a replay over the row
    torch.cuda.synchronize()
    assert eng.health()["kv_block_invariants"] == "ok"
    eng.run()
    assert [r.output_ids for r in reqs] == refs
    assert all(r.finished for r in reqs + [hi])
    resumed = victims[0]
    assert resumed.prefill_bucket == 16          # the tail, after the hit
    assert eng.health()["kv_block_invariants"] == "ok"
    assert eng.stats()["compile_cache"]["after_warmup"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cancel_running_between_replays(cuda_device, layout):
    """A running request cancelled between two replays retires at the
    next step boundary with the tokens it had; the others' streams are
    the ones they give alone."""
    eng = Engine(_small_model("llama", cuda_device), kv_layout=layout,
                 **_ENGINE_KW)
    eng.warmup()
    laws = chip_smoke.sampling_laws(7)
    reqs_in = [(list(range(11 + 3 * i, 37 + 3 * i)), laws[i])
               for i in range(3)]
    refs = [_alone_twice(eng, p, s) for p, s in reqs_in]
    reqs = [eng.add_request(p, sampling=s, max_new_tokens=10)
            for p, s in reqs_in]
    for _ in range(3):
        eng.step()
    emitted = list(reqs[1].output_ids)
    assert reqs[1].cancel() and reqs[1].state == "running"
    eng.run()
    assert reqs[1].state == "cancelled" and reqs[1].output_ids == emitted
    assert emitted == refs[1][:len(emitted)]
    assert [reqs[0].output_ids, reqs[2].output_ids] == [refs[0], refs[2]]
    assert sorted(eng.free_slots) == list(range(eng.num_slots))
    if layout == "paged":
        assert eng.health()["kv_block_invariants"] == "ok"
        assert eng.stats()["paging"]["blocks"]["used"] == 0


# -- durability over replayed graphs ------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_hot_swap_graphs_read_the_new_weights(cuda_device, family, layout):
    """After ``update_weights`` the graphs captured over the old weights
    serve what graphs captured over the new weights serve (GPT's tied head
    included), no parameter moved and no program was built; swapping back
    gives the first streams again."""
    model = _small_model(family, cuda_device)
    other = _small_model(family, cuda_device, seed=1)
    reqs = chip_smoke.make_requests(512, 4, 40, [3, 30, 17, 70], seed=8)
    kw = dict(kv_layout=layout, **_ENGINE_KW)

    def serve(eng):
        out = [eng.add_request(p, sampling=s, max_new_tokens=10)
               for p, s in reqs]
        eng.run()
        return [r.output_ids for r in out]

    fresh = Engine(other, **kw)
    fresh.warmup()
    want = serve(fresh)
    del fresh
    eng = Engine(model, **kw)
    eng.warmup()
    first = serve(eng)
    ptrs = {k: p.data_ptr() for k, p in model.named_parameters()}
    old = {k: p.detach().clone() for k, p in model.named_parameters()}
    assert eng.update_weights(other.state_dict()) == 1
    got = serve(eng)
    assert got == want and got != first
    assert eng.update_weights(old) == 2
    assert serve(eng) == first
    assert {k: p.data_ptr() for k, p in model.named_parameters()} == ptrs
    cc = eng.stats()["compile_cache"]
    assert cc["after_warmup"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_recovered_streams_equal_eager_bodies(cuda_device, layout,
                                              tmp_path):
    """Seeded and greedy requests abandoned mid-decode and recovered by a
    new engine through its CUDA graphs give the streams its step bodies
    give called eagerly on the journaled recipes."""
    model = _small_model("llama", cuda_device)
    kw = dict(kv_layout=layout, enable_prefix_cache=False, **_ENGINE_KW)
    reqs = chip_smoke.make_requests(512, 4, 40, [3, 30, 17, 70], seed=9)
    eng = Engine(model, journal=RequestJournal(str(tmp_path)), **kw)
    eng.warmup()
    for p, s in reqs:
        eng.add_request(p, sampling=s, max_new_tokens=12)
    for _ in range(4):
        eng.step()
    del eng
    journal = RequestJournal(str(tmp_path))
    pending = journal.pending()
    eng = Engine(model, journal=journal, **kw)
    eng.warmup()
    info = eng.recover()
    eng.run()
    assert info["replayed"] == 4
    recipes = []
    for r in pending.values():
        s = journal.replay_sampling(r)
        recipes.append((r["prompt_ids"], SamplingParams(
            temperature=s["temperature"], top_k=s["top_k"],
            top_p=s["top_p"], seed=s["seed"])))
    eager = chip_smoke.serve_bodies(Engine(model, **kw), recipes, 12)
    assert [r.output_ids for r in info["requests"]] == eager
    assert journal.audit()["pending"] == 0
    assert eng.stats()["compile_cache"]["after_warmup"] == 0


# -- speculative decoding ----------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("hkv", [8, 2])
def test_verify_route_matches_plain(cuda_device, dtype, tol, hkv):
    """The paged verify window as ``slots·W`` K4 rows against the plain
    ``verify_attention`` over the gathered pool, one window past the
    table's end, at head dim 64."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    res = chip_smoke.check_verify_route(g, dtype, lengths=[250, 61, 17, 0],
                                        H=8, Hkv=hkv, D=64, max_seq=256)
    assert res["err"] <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_spec_greedy_equals_plain(cuda_device, family, layout):
    """Greedy requests through the speculating engine's graphs (a 1-layer
    draft, and the target as its own) equal the plain engine's streams in
    f32; no program is built after warmup and the pool ends clean."""
    model = _small_model(family, cuda_device)
    cfg = model.config
    draft = type(model)(dataclasses.replace(cfg, num_hidden_layers=1),
                        device=cuda_device,
                        generator=torch.Generator(
                            device=cuda_device).manual_seed(2)).eval()
    reqs = chip_smoke.spec_parity_requests(cfg.vocab_size, 256, seed=4)
    for d in (draft, model):
        res = chip_smoke.drive_spec_parity(model, d, layout, reqs, 10,
                                           **_ENGINE_KW)
        chip_smoke.check_spec_parity(res, f"{family}, {layout}")
        assert res["compile_cache"]["after_warmup"] == 0
        assert len(res["spec"][-1]) == 4           # retired at max_seq
        if layout == "paged":
            assert res["launches"]["paged_decode"] > 0


@pytest.mark.cuda
def test_decode_verify_ticket_reuse_across_replays(cuda_device):
    """K4's tickets: a decode graph, then a verify graph whose first call
    outgrows the decode's buffer, replayed decode → verify → decode, each
    bitwise equal to an eager call; every ticket is 0 after."""
    res = chip_smoke.ticket_replay(cuda_device, torch.bfloat16,
                                   lengths=[250, 61, 17, 0], H=8, Hkv=2,
                                   D=64, max_seq=256)
    assert res["all_equal"], res["calls"]
    assert res["tickets_nonzero"] == 0


@pytest.mark.cuda
def test_spec_round_retry_restores_replayed_lanes(cuda_device):
    """A verify replay that fails after it ran (its lanes moved) is retried
    as a whole round: the seeded and greedy streams equal an engine's that
    never failed."""
    model = _small_model("llama", cuda_device)
    draft = _small_model("llama", cuda_device, seed=3)
    reqs = chip_smoke.make_requests(512, 3, 20, [3, 30, 17], seed=6)

    def serve(fail):
        eng = Engine(model, kv_layout="paged", **_ENGINE_KW,
                     speculation=SpecConfig(draft_model=draft, k=3))
        eng.warmup()
        run, verifies = eng.programs.run, []

        def flaky(key, body, *inputs):
            out = run(key, body, *inputs)
            if key == ("verify",):
                verifies.append(key)
                # the first round's verify, and the second round's (the
                # first round's retry is the second call)
                if fail and len(verifies) in (1, 3):
                    raise RuntimeError("injected after the replay")
            return out

        eng.programs.run = flaky
        rs_ = [eng.add_request(p, sampling=s, max_new_tokens=9)
               for p, s in reqs]
        eng.run()
        assert all(r.finished for r in rs_)
        return [r.output_ids for r in rs_], eng.stats()

    want, _ = serve(False)
    got, st = serve(True)
    assert got == want
    assert st["failures"]["retries_by_point"] == {"serving.spec_round": 2}
    assert st["compile_cache"]["after_warmup"] == 0


@pytest.mark.cuda
def test_capture_runs_with_the_cyclic_collector_paused(cuda_device):
    """A program's first call runs its body eagerly with the collector on,
    then captures it with the collector off (a graph freed inside a
    capture invalidates it), and turns the collector back on."""
    from paddle_tpu_torch.serving.programs import StepPrograms

    seen = []

    def body(x):
        seen.append(gc.isenabled())
        return x * 2

    progs = StepPrograms(cuda_device, lambda miss: None)
    out = progs.run(("double",), body, np.ones(4, dtype=np.float32))
    assert seen == [True, False] and gc.isenabled()
    assert out.cpu().tolist() == [2.0] * 4


# -- multi-tenant serving over replayed graphs -------------------------------

_TENANCY = dict(adapters=dict(max_adapters=2, rank=8),
                grammars={"json": JsonArrayGrammar(eos_token_id=2)})


def _tenant_streams(eng, reqs, n=10):
    out = [eng.add_request(p, sampling=s, max_new_tokens=n) for p, s in reqs]
    eng.run()
    assert all(r.finished for r in out), [(r.state, r.error) for r in out]
    return [r.output_ids for r in out]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_lane_writes_after_capture_reach_the_replays(cuda_device, family,
                                                     layout):
    """Adapters loaded after the graphs were captured serve what an
    engine captured over the loaded lanes serves; a hot swap and a reload
    in place change and restore the stream; no lane moves and no program
    is built; with no tenant selected the streams are the plain engine's,
    bitwise."""
    model = _small_model(family, cuda_device)
    kw = dict(kv_layout=layout, **_ENGINE_KW, **_TENANCY)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 512, (n,)).tolist() for n in (7, 40, 21)]
    t1 = [(p, SamplingParams(adapter="t1")) for p in prompts]
    base = [(p, SamplingParams()) for p in prompts]

    def lora(pool, seed):
        return make_lora_weights(pool, seed=seed, init_scale=0.2)

    loaded_first = Engine(model, **kw)
    loaded_first.load_adapter("t1", lora(loaded_first.adapter_pool, 1))
    loaded_first.warmup()
    want = _tenant_streams(loaded_first, t1)
    del loaded_first
    plain = Engine(model, kv_layout=layout, **_ENGINE_KW)
    plain.warmup()
    want_base = _tenant_streams(plain, base)
    del plain
    eng = Engine(model, **kw)
    eng.warmup()
    pool = eng.adapter_pool
    ptrs = [(b.A.data_ptr(), b.B.data_ptr()) for b in pool.banks.values()]
    eng.load_adapter("t1", lora(pool, 1))
    assert _tenant_streams(eng, t1) == want
    assert _tenant_streams(eng, base) == want_base
    eng.load_adapter("t1", lora(pool, 2))
    assert _tenant_streams(eng, t1) != want
    eng.unload_adapter("t1")
    eng.load_adapter("t1", lora(pool, 1))
    assert _tenant_streams(eng, t1) == want
    assert [(b.A.data_ptr(), b.B.data_ptr())
            for b in pool.banks.values()] == ptrs
    assert eng.stats()["compile_cache"]["after_warmup"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_tenant_graph_streams_equal_eager_bodies(cuda_device, layout):
    """Base, adapter and grammar requests (greedy and seeded) served
    through the tenancy engine's CUDA graphs and through its step bodies
    called eagerly give the same tokens (a grammar stream up to its
    eos)."""
    model = _small_model("llama", cuda_device)
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, 512, (n,)).tolist() for n in (9, 33, 17, 50)]
    laws = [SamplingParams(adapter="t1"),
            SamplingParams(grammar="json", temperature=0.9, seed=4),
            SamplingParams(temperature=0.8, seed=5, adapter="t2"),
            SamplingParams(grammar="json")]
    reqs = list(zip(prompts, laws))
    kw = dict(kv_layout=layout, enable_prefix_cache=False, **_ENGINE_KW,
              **_TENANCY)
    engines = []
    for _ in range(2):
        eng = Engine(model, **kw)
        eng.warmup()
        for i, name in enumerate(("t1", "t2"), start=1):
            eng.load_adapter(name, make_lora_weights(
                eng.adapter_pool, seed=i, init_scale=0.2))
        engines.append(eng)
    graphs = _tenant_streams(engines[0], reqs, n=12)
    eager = chip_smoke.serve_bodies(engines[1], reqs, 12)
    spec = engines[0].grammar_table.spec_of("json")
    for (_, law), g, e in zip(reqs, graphs, eager):
        if law.grammar is not None:
            assert spec.accepts(g, 512), g
            e = e[:e.index(2) + 1] if 2 in e else e
        assert g == e


# -- resilience: the watchdog and the sync sanitizer over replayed graphs ----

@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_watchdog_fires_on_a_device_stall(cuda_device, layout):
    """A ~3 s ``torch.cuda._sleep`` enqueued after decode replay #3: the
    replay returns at once and the step's time is paid at the token read,
    inside the heartbeat, so the 0.5 s watchdog fires; the engine stays
    unhealthy and shutdown joins the thread.  (A heartbeat that ends at
    the call would not fire here.)"""
    eng = Engine(_small_model("llama", cuda_device), kv_layout=layout,
                 **_ENGINE_KW, step_timeout_s=chip_smoke.WATCHDOG_TIMEOUT_S)
    res = chip_smoke.watchdog_stall(eng, list(range(20)), "device")
    assert res["state"] == "unhealthy" and res["request"] == "cancelled"
    assert res["wall_s"] >= chip_smoke.STALL_S * 0.8


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_step_timeout_without_warmup_does_not_fire(cuda_device, layout):
    """``step_timeout_s=0.5`` and no ``warmup()``: every program is built
    (its kernels loaded, its graph captured) at its first call, inside a
    step, which the heartbeat does not count; serving finishes healthy."""
    eng = Engine(_small_model("gpt", cuda_device), kv_layout=layout,
                 **_ENGINE_KW, step_timeout_s=0.5)
    rs = np.random.RandomState(3)           # no shared prefix: 4 buckets
    reqs = [eng.add_request(rs.randint(0, 512, (n,)).tolist(),
                            max_new_tokens=6) for n in (5, 40, 100, 200)]
    eng.run()
    assert all(r.finished for r in reqs)
    assert eng.state == "active" and not eng._watchdog.fired
    assert eng.health()["watchdog_armed"]
    assert len(eng.programs.keys()) == 5         # 16, 64, 128, 256, decode
    eng.shutdown()
    assert eng._watchdog is None


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_strict_sanitizer_sees_no_sync(cuda_device, monkeypatch, layout,
                                       spec):
    """Strict engines built under ``PADDLE_TPU_SANITIZE=strict``, warmed
    or not: every replayed decode step or round runs under
    ``set_sync_debug_mode("error")`` without a sync, 0.0 host transfers a
    step, and the previous debug mode is back after."""
    model = _small_model("llama", cuda_device)
    kw = {"speculation": SpecConfig(draft_model=_small_model(
        "llama", cuda_device, seed=3), k=3)} if spec else {}
    monkeypatch.setenv("PADDLE_TPU_SANITIZE", "strict")
    eng = Engine(model, kv_layout=layout, **_ENGINE_KW, **kw)
    monkeypatch.delenv("PADDLE_TPU_SANITIZE")
    reqs = chip_smoke.make_requests(512, 3, 20, [3, 30, 17], seed=6)
    cold = [eng.add_request(p, sampling=s, max_new_tokens=8)
            for p, s in reqs]
    eng.run()                                   # builds inside the steps
    assert all(r.finished for r in cold)
    rep = chip_smoke.sanitized_run(eng, reqs, 8)
    assert rep["per_decode_step"] == 0.0 and rep["guard_violations"] == 0
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_strict_guard_fails_a_syncing_batch(cuda_device, monkeypatch):
    """The negative control: a read of the replay's output on the host
    inside the dispatch is counted at its line and, under the strict
    guard, raises; the batch fails after its retry (one violation) and
    the engine serves the next request."""
    monkeypatch.setenv("PADDLE_TPU_SANITIZE", "strict")
    eng = Engine(_small_model("gpt", cuda_device), kv_layout="paged",
                 **_ENGINE_KW)
    monkeypatch.delenv("PADDLE_TPU_SANITIZE")
    eng.warmup()
    reqs = chip_smoke.make_requests(512, 2, 20, [5, 9], seed=7)
    res = chip_smoke.sanitizer_control(eng, reqs[0], 8)
    assert res["request"] == "failed" and res["guard_violations"] == 1
    r = eng.add_request(reqs[1][0], sampling=reqs[1][1], max_new_tokens=8)
    eng.run()
    assert r.finished and eng.state == "active"
    assert torch.cuda.get_sync_debug_mode() == 0


# -- the fleet: supervised replicas over replayed graphs ----------------------

_FLEET_KW = dict(num_replicas=2, eject_after_failures=2, max_redispatch=2,
                 kv_layout="paged", **_ENGINE_KW)


def _fleet_prompts(n, seed=4):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 512, (L,)).tolist()
            for L in [7, 33, 12, 50, 21, 9, 40, 18][:n]]


@pytest.mark.cuda
def test_fleet_device_stall_ejects_and_rebuilds(cuda_device):
    """A ~3 s ``torch.cuda._sleep`` after replica 1's decode replay #3,
    under ``step_timeout_s``: the fleet's one host thread waits at that
    step's token read, the watchdog marks replica 1 unhealthy meanwhile,
    and the next supervision pass ejects it, replays its requests and
    rebuilds it; every request finishes once, and the streams that never
    left replica 0 equal an unfaulted fleet's."""
    from paddle_tpu_torch.serving import Fleet

    model = _small_model("llama", cuda_device)
    prompts = _fleet_prompts(6)

    def serve(fleet):
        fleet.warmup()
        reqs = [fleet.submit(p, max_new_tokens=12) for p in prompts]
        fleet.run()
        return reqs

    calm = serve(Fleet(model, **_FLEET_KW,
                       step_timeout_s=chip_smoke.WATCHDOG_TIMEOUT_S))
    fleet = Fleet(model, **_FLEET_KW,
                  step_timeout_s=chip_smoke.WATCHDOG_TIMEOUT_S)
    wedged = fleet.replicas[1].engine
    cycles, run, calls = chip_smoke.sleep_cycles(chip_smoke.STALL_S), \
        wedged.programs.run, [0]

    def stalls(key, body, *inputs):
        out = run(key, body, *inputs)
        if key[0] == "decode":
            calls[0] += 1
            if calls[0] == 3:
                torch.cuda._sleep(cycles)
        return out

    wedged.programs.run = stalls
    t0 = time.perf_counter()
    reqs = serve(fleet)
    assert time.perf_counter() - t0 >= chip_smoke.STALL_S * 0.8
    st = fleet.stats()
    assert st["supervision"]["ejections"] == 1
    assert st["supervision"]["rebuilds"] == 1
    assert st["requests"]["completed"] == 6
    assert st["requests"]["duplicate_terminals"] == 0
    assert wedged.state == "unhealthy"
    assert "watchdog" in wedged._unhealthy_reason
    assert wedged._watchdog is None              # joined at the ejection
    assert fleet.replicas[1].engine is not wedged
    assert fleet.replicas[1].engine.health()["watchdog_armed"]
    moved = [r for r in reqs if r.redispatches]
    assert moved and all(r.replica_history[0].endswith(".r1")
                         for r in moved)
    stayed = [(r, c) for r, c in zip(reqs, calm)
              if len(r.replica_history) == len(c.replica_history) == 1
              and r.replica_history[0].endswith(".r0")
              and c.replica_history[0].endswith(".r0")]
    assert stayed
    for r, c in stayed:
        assert r.output_ids == c.output_ids
    assert all(r.finished and len(r.output_ids) == 12 for r in reqs)


@pytest.mark.cuda
def test_fleet_memory_back_after_rebuilds(cuda_device):
    """Eject/rebuild cycles of replica 1: ``memory_allocated()`` comes back
    to its level each time (the ejected engine's graphs, KV pool and model
    copy are freed before the successor allocates, and the successor
    captures on the same side stream, so no new stream's cuBLAS workspace
    stays behind); K4's merge tickets of that stream are 0 after every
    launch, and the rebuilt replica streams what the first one did."""
    from paddle_tpu_torch.serving import Fleet

    fleet = Fleet(_small_model("gpt", cuda_device), **_FLEET_KW)
    fleet.warmup()
    prompt = _fleet_prompts(1)[0]
    stream = fleet.replicas[1].engine.programs._stream
    outs, base = [], None
    for _ in range(4):
        rep = fleet.replicas[1]
        r = fleet.submit(prompt, max_new_tokens=8, replica=1)
        fleet.run()
        outs.append(r.output_ids)
        torch.cuda.synchronize()
        gc.collect()
        if base is None:
            base = torch.cuda.memory_allocated()
        assert abs(torch.cuda.memory_allocated() - base) <= 2 ** 20
        fleet._eject(rep, "test ejection")
        fleet._supervise()
        assert rep.state == "active"
        assert rep.engine.programs._stream == stream
    assert all(o == outs[0] for o in outs)
    assert all(int(t.abs().sum()) == 0
               for t in kernels._decode_tickets.values())
    assert fleet.stats()["supervision"]["rebuilds"] == 4


@pytest.mark.cuda
def test_fleet_rolling_swap_over_graphs(cuda_device):
    """A rolling ``update_weights`` over captured graphs: no capture on
    any replica, no parameter of any replica moves, in-flight requests
    end at version 0, and the requests after the roll stream what an
    engine warmed over the new weights streams."""
    from paddle_tpu_torch.serving import Fleet

    model = _small_model("llama", cuda_device)
    other = _small_model("llama", cuda_device, seed=1)
    fleet = Fleet(model, **_FLEET_KW)
    fleet.warmup()
    assert fleet.weights_isolated
    ptrs = [{k: p.data_ptr() for k, p in rep.engine.model.named_parameters()}
            for rep in fleet.replicas]
    misses = [rep.engine.metrics.compile_misses for rep in fleet.replicas]
    prompts = _fleet_prompts(4)
    live = [fleet.submit(p, max_new_tokens=16) for p in prompts]
    fleet.step()
    res = fleet.update_weights(other.state_dict(), max_drain_steps=500)
    post = [fleet.submit(p, max_new_tokens=10) for p in prompts]
    fleet.run()
    assert res["replicas_updated"] == 2
    assert all(r.finished and r.model_version == 0 for r in live)
    assert all(r.finished and r.model_version == 1 for r in post)
    assert [rep.engine.metrics.compile_misses
            for rep in fleet.replicas] == misses
    assert [{k: p.data_ptr() for k, p in rep.engine.model.named_parameters()}
            for rep in fleet.replicas] == ptrs
    fresh = Engine(other, kv_layout="paged", **_ENGINE_KW)
    fresh.warmup()
    want = fresh.generate(prompts, max_new_tokens=10)
    assert [r.output_ids for r in post] == want


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_fleet_clone_keeps_dtype_and_device(cuda_device, family):
    """A replica's copy of a bf16 template on the card: bf16, on the card,
    the template's attention route, equal tensors in other memory, and
    the same logits."""
    from paddle_tpu_torch.serving import Fleet

    model = _small_model(family, cuda_device).to(torch.bfloat16)
    if family == "gpt":
        for m in model.modules():
            if hasattr(m, "kernel"):
                m.kernel = "reference"
    fleet = Fleet(model, num_replicas=2, num_slots=2, max_seq=64,
                  min_bucket=16)
    clone = fleet.replicas[1].engine.model
    assert clone is not model
    for (n, t), (_, s) in zip(clone.state_dict().items(),
                              model.state_dict().items()):
        assert t.dtype == s.dtype and t.device == s.device, n
        assert torch.equal(t, s) and t.data_ptr() != s.data_ptr(), n
    if family == "gpt":
        assert {m.kernel for m in clone.modules()
                if hasattr(m, "kernel")} == {"reference"}
    ids = torch.arange(1, 33, device=cuda_device)[None]
    with torch.no_grad():
        assert torch.equal(clone(ids), model(ids))


@pytest.mark.cuda
def test_step_programs_of_two_engines_never_overlap(cuda_device):
    """Registries on one card share K4's merge tickets: a program called
    on another stream while another registry's still runs raises; on the
    same stream, or once the other's has ended, it runs."""
    from paddle_tpu_torch.serving.programs import StepPrograms

    a, b = (StepPrograms(cuda_device, lambda miss: None) for _ in range(2))
    x = np.arange(8, dtype=np.float32)

    def body(t):
        return t * 2

    a.run(("k",), body, x)
    b.run(("k",), body, x)
    side = torch.cuda.Stream(cuda_device)
    torch.cuda.synchronize()
    torch.cuda._sleep(chip_smoke.sleep_cycles(0.5))
    a.run(("k",), body, x)
    with torch.cuda.stream(side):
        with pytest.raises(RuntimeError, match="another stream"):
            b.run(("k",), body, x)
    b.run(("k",), body, x)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        out = a.run(("k",), body, x)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), torch.from_numpy(x * 2))


# -- slice 13: attention dropout, the compiled train step ---------------------

def _snap(device, seed=77, offset=3):
    return torch.tensor([seed, offset], dtype=torch.int64, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,causal", [(200, True), (130, False)])
def test_dropout_kernels_match_plain(cuda_device, dtype, D, S, causal):
    """K1-K3's dropout instances against the plain versions on the same
    draw (p 0.2): O to the bf16/f32 tolerance on O's scale (1/(1-p)),
    lse unchanged, the gradients relative to the largest."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v, do = (torch.randn((2, S, 3, D), generator=g,
                               device=cuda_device).to(dtype)
                   for _ in range(4))
    p, snap = 0.2, _snap(cuda_device)
    tol = (1e-4 if dtype == torch.float32 else 3e-2) / (1 - p)
    o, lse = kernels.flash_fwd(q, k, v, causal, p, snap)
    o_ref, lse_ref = _sdpa_reference(q, k, v, causal, True, p, snap)
    assert (o.float() - o_ref.float()).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2) \
        .contiguous().view(-1, S)
    args = (q, k, v, do, lse_ref, delta, causal, p, snap)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip((*kernels.flash_bwd_dkv(*args),
                          kernels.flash_bwd_dq(*args)),
                         (*_flash_bwd_dkv_reference(*args),
                          _flash_bwd_dq_reference(*args))):
        top = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= rel * top


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_mask_is_exact(cuda_device, dtype):
    res = chip_smoke.check_dropout_mask(dtype)
    assert res["err"] == 0.0
    assert 0.65 < res["kept_share"] < 0.85


@pytest.mark.cuda
def test_dropout_counts_its_own_launches(cuda_device):
    x = torch.randn((1, 64, 2, 64), device=cuda_device,
                    dtype=torch.bfloat16, requires_grad=True)
    kernels.reset_launches()
    flash_attention(x, x, x, is_causal=True, dropout_p=0.1).sum().backward()
    counts = kernels.launch_counts()
    assert {n: c for n, c in counts.items() if c} == {
        "flash_fwd_dropout": 1, "flash_bwd_dkv_dropout": 1,
        "flash_bwd_dq_dropout": 1}


def _recipe_step(device, to_static, recompute=True, p=0.1, seed=0):
    from paddle_tpu_torch import build_train_step
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import lr

    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=8), 2, 0.0,
                            1e-3)
    ts = build_train_step("tiny", batch=2, seq=64, device=device,
                          to_static=to_static, dropout=p,
                          recompute=recompute, lr=sched, seed=seed,
                          grad_clip=ClipGradByGlobalNorm(1.0))
    return ts, sched


@pytest.mark.cuda
def test_to_static_steps_equal_the_eager_steps(cuda_device):
    """A tiny GPT at head dim 64 (hidden 256) in bf16 O2 at the whole
    recipe: the graph's losses equal the eager loop's bitwise, with one
    program, one capture, the scheduler's rate read at each replay and
    fresh dropout masks at each replay."""
    from paddle_tpu_torch.models import gpt as gpt_mod

    tiny = gpt_mod.GPT_CONFIGS["tiny"]
    gpt_mod.GPT_CONFIGS["tiny"] = lambda **kw: tiny(
        **{"hidden_size": 256, **kw})
    try:
        runs = {}
        for to_static in (False, True):
            ts, sched = _recipe_step(cuda_device, to_static)
            losses = []
            for _ in range(5):
                losses.append(ts.train_step(ts.x, ts.y))
                sched.step()
            runs[to_static] = ([float(v) for v in losses], ts)
    finally:
        gpt_mod.GPT_CONFIGS["tiny"] = tiny
    (eager, _), (graph, ts) = runs[False], runs[True]
    assert graph == eager and len(set(graph)) == 5
    f = ts.train_step
    assert (len(f.program_cache), f.misses, f.hits, f.captures) == \
        (1, 1, 4, 1)


@pytest.mark.cuda
def test_replays_read_the_new_rate_and_draw_new_masks(cuda_device):
    from paddle_tpu_torch import jit, rng
    from paddle_tpu_torch.nn.functional import dropout
    from paddle_tpu_torch.optimizer import SGD, lr

    sched = lr.StepDecay(0.5, step_size=1, gamma=0.5)
    w = torch.nn.Parameter(torch.zeros(4, device=cuda_device))
    opt = SGD([w], lr=sched)

    @jit.to_static
    def step(g):
        w.grad = g
        opt.step()
        opt.clear_grad()
        return dropout(torch.ones(4096, device=g.device), 0.5)

    g = torch.ones(4, device=cuda_device)
    masks = []
    for want in (-0.5, -0.75, -0.875, -0.9375):
        masks.append(step(g))
        sched.step()
        torch.cuda.synchronize()
        assert torch.allclose(w.detach(), torch.full_like(w, want))
    assert step.captures == 1
    assert len({tuple(m.nonzero().flatten().tolist()) for m in masks}) == 4
    assert rng.default_generator(cuda_device).get_state()[1].item() >= 4


@pytest.mark.cuda
def test_failed_capture_raises_and_the_card_recovers(cuda_device):
    from paddle_tpu_torch import jit

    w = torch.zeros(4, device=cuda_device)

    @jit.to_static
    def reads_the_host(x):
        y = (w + x).sum()
        if y.item() > 1e9:        # a host read: no graph can hold it
            return y * 2
        return y

    x = torch.ones(4, device=cuda_device)
    assert reads_the_host(x).item() == 4.0       # the eager first call
    with pytest.raises(jit.CaptureError, match="host"):
        reads_the_host(x)
    with pytest.raises(jit.CaptureError):          # no eager stand-in
        reads_the_host(x)
    a = torch.randn(32, 32, device=cuda_device)    # torch's generator
    q = torch.randn((1, 64, 2, 64), device=cuda_device, dtype=torch.bfloat16)
    kernels.flash_fwd(q, q, q)
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()


@pytest.mark.cuda
def test_state_made_inside_a_capture_raises(cuda_device):
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.optimizer import AdamW

    a, b = (torch.nn.Parameter(torch.zeros(4, device=cuda_device))
            for _ in range(2))
    opt = AdamW([a, b], lr=0.1)
    both = [False]

    @jit.to_static
    def step(g):
        a.grad = g
        if both[0]:
            b.grad = g * 2
        opt.step()
        opt.clear_grad()
        return a * 1

    g = torch.ones(4, device=cuda_device)
    step(g)
    both[0] = True
    with pytest.raises(jit.CaptureError, match="optimizer state"):
        step(g)


@pytest.mark.cuda
def test_set_lr_refuses_once_a_float_rate_is_captured(cuda_device):
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.optimizer import SGD

    w = torch.nn.Parameter(torch.zeros(2, device=cuda_device))
    opt = SGD([w], lr=0.5)
    opt.set_lr(0.25)

    @jit.to_static
    def step(g):
        w.grad = g
        opt.step()
        opt.clear_grad()
        return w * 1

    g = torch.ones(2, device=cuda_device)
    step(g)
    step(g)
    with pytest.raises(RuntimeError, match="captured"):
        opt.set_lr(0.1)
    torch.cuda.synchronize()
    assert torch.allclose(w.detach(), torch.full_like(w, -0.5))


# -- float16 K1-K3, AMP O1, the loss scaler, masks --------------------------

def _tiny_d64(hidden=256):
    """``GPT_CONFIGS["tiny"]`` at head dim 64 (4 heads of 64) while the
    context is open, so that the flash kernels take it."""
    import contextlib

    from paddle_tpu_torch.models import gpt as gpt_mod

    @contextlib.contextmanager
    def patched():
        tiny = gpt_mod.GPT_CONFIGS["tiny"]
        gpt_mod.GPT_CONFIGS["tiny"] = lambda **kw: tiny(
            **{"hidden_size": hidden, **kw})
        try:
            yield
        finally:
            gpt_mod.GPT_CONFIGS["tiny"] = tiny
    return patched()


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.2])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,causal", [(200, True), (130, False)])
def test_f16_kernels_match_plain(cuda_device, p, D, S, causal):
    """K1-K3's f16 instances (p 0 and dropout) against the plain versions
    on the same f16 inputs and draw; each launch counts as ``..._f16``."""
    from paddle_tpu_torch.ops.attention import _flash_fwd_reference

    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v, do = (torch.randn((2, S, 3, D), generator=g,
                               device=cuda_device).half() for _ in range(4))
    snap = _snap(cuda_device) if p else None
    kernels.reset_launches()
    o, lse = kernels.flash_fwd(q, k, v, causal, p, snap)
    o_ref, lse_ref = _flash_fwd_reference(q, k, v, causal, p, snap)
    assert o.dtype == torch.float16
    assert (o.float() - o_ref.float()).abs().max().item() <= 1e-2 / (1 - p)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2) \
        .contiguous().view(-1, S)
    args = (q, k, v, do, lse_ref, delta, causal, p, snap)
    for got, want in zip((*kernels.flash_bwd_dkv(*args),
                          kernels.flash_bwd_dq(*args)),
                         (*_flash_bwd_dkv_reference(*args),
                          _flash_bwd_dq_reference(*args))):
        assert got.dtype == torch.float16
        top = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= 1e-2 * top
    sfx = "_dropout_f16" if p else "_f16"
    assert {n: c for n, c in kernels.launch_counts().items() if c} == {
        f"flash_fwd{sfx}": 1, f"flash_bwd_dkv{sfx}": 1,
        f"flash_bwd_dq{sfx}": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["flash_bwd_dkv", "flash_bwd_dq"])
def test_f16_overflow_reaches_the_gradients(cuda_device, which):
    """Under a dO a large loss scale makes, K2/K3's f16 outputs hold inf
    or NaN where the plain versions' do: never clamped."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    res = chip_smoke.check_f16_overflow(g, which)
    assert res["nonfinite_kernel"] > 0
    assert res["err"] <= res["tol"]


@pytest.mark.cuda
def test_o1_graph_steps_equal_the_eager_steps(cuda_device):
    """``build_train_step(amp_level="O1")`` on a tiny GPT at head dim 64:
    f32 parameters, the graph's losses equal the eager step's bitwise,
    one program and one capture, K1-K3's bf16 instances per layer and
    step."""
    from paddle_tpu_torch import build_train_step

    runs = {}
    with _tiny_d64():
        for to_static in (False, True):
            ts = build_train_step("tiny", batch=2, seq=64, device=cuda_device,
                                  amp_level="O1", to_static=to_static)
            kernels.reset_launches()
            runs[to_static] = ([float(ts.train_step(ts.x, ts.y))
                                for _ in range(4)], ts,
                               kernels.launch_counts())
    (eager, _, _), (graph, ts, counts) = runs[False], runs[True]
    assert {p.dtype for p in ts.model.parameters()} == {torch.float32}
    assert graph == eager and graph[-1] < graph[0]
    f = ts.train_step
    assert (len(f.program_cache), f.captures) == (1, 1)
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        assert counts[name] == 2 * 4


@pytest.mark.cuda
def test_scaler_skip_inside_a_graph(cuda_device):
    """``train_fp16_scaler``'s run on a tiny GPT at head dim 64: from a
    scale past f16's range the first steps overflow inside the captured
    step, leave the state bitwise as it was and halve the scale (no host
    read of ``found_inf``), then steps apply; the f16 K1-K3 ran."""
    with _tiny_d64():
        run = chip_smoke.run_fp16_scaler(10, 2.0 ** 26, config="tiny",
                                         batch=2, seq=64, device="cuda")
    chip_smoke.check_fp16_scaler(run, "card")
    assert run["program_cache"]["captures"] == 1
    for name in chip_smoke.F16_KERNELS:
        assert run["launches"][name] == 2 * 10


@pytest.mark.cuda
def test_scaler_state_made_inside_a_capture_raises(cuda_device):
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.optimizer import SGD

    w = torch.nn.Parameter(torch.ones(4, device=cuda_device))
    opt = SGD([w], lr=0.1)
    scaler = amp.GradScaler()
    first = [True]

    @jit.to_static
    def step(x):
        loss = (w * x).sum()
        if first[0]:
            first[0] = False
            loss.backward()
        else:
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
        opt.clear_grad()
        return loss.detach()

    x = torch.ones(4, device=cuda_device)
    step(x)
    with pytest.raises(jit.CaptureError, match="GradScaler"):
        step(x)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_masked_attention_on_the_card(cuda_device, kind):
    """``flash_attention(attn_mask=)`` on CUDA tensors takes the plain
    route (no kernel launches) and gives the CPU's output and gradients
    (f32, 1e-4)."""
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn(2, 40, 2, 64, generator=g) for _ in range(4))
    mask = (torch.rand(2, 1, 40, 40, generator=g) > 0.3) if kind == "bool" \
        else torch.randn(2, 2, 40, 40, generator=g)
    outs = []
    for dev in ("cpu", cuda_device):
        ts = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        kernels.reset_launches()
        out = flash_attention(*ts, is_causal=True, attn_mask=mask.to(dev))
        out.backward(do.to(dev))
        outs.append([t.detach().cpu() for t in (out, *[x.grad for x in ts])])
        assert not any(kernels.launch_counts().values())
    for a, b in zip(*outs):
        assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_mesh_of_one_is_the_plain_engine_under_graphs(cuda_device, layout):
    """``Engine(mesh=serving_mesh(1))`` on an NCCL world of one (made on a
    ``HashStore``) over a small bf16 GPT: its CUDA graphs hold the
    tensor-parallel layers' all-reduces and the head's all-gather, it
    launches the kernels of the plain engine, and its streams (greedy and
    the three seeded laws) equal the plain engine's bitwise."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers
    from paddle_tpu_torch.serving import serving_mesh

    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=256,
                    hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    model = GPTForCausalLM(
        cfg, device=cuda_device, dtype=torch.bfloat16,
        generator=torch.Generator(device=cuda_device).manual_seed(0))
    reqs = chip_smoke.make_requests(512, 4, 40, [3, 20, 57, 9], seed=0)
    kw = dict(kv_layout=layout, num_slots=2, max_seq=256, min_bucket=16,
              block_size=16)
    try:
        mesh = serving_mesh(1)
        assert dist.get_backend() == "nccl"
        plain, meshed = Engine(model, **kw), Engine(model, mesh=mesh, **kw)
        ref = chip_smoke.serve(plain, reqs, max_new_tokens=8)
        res = chip_smoke.run_serve_mesh(Engine(model, **kw), meshed, reqs, 8,
                                        ref["outputs"])
        decode = meshed.programs._programs[("decode",)]
        assert decode.graph is not None
        assert res["collectives_per_decode_step"] == {
            "all_reduce": 2 * cfg.num_hidden_layers + 1, "all_gather": 1}
        want = "paged_decode" if layout == "paged" else "flash_fwd"
        assert res["launches"].get(want, 0) > 0
        assert set(res["launches"]) == set(
            n for n, c in ref["launches"].items() if c)
    finally:
        mp_layers.reset_collectives()
        if dist.is_initialized():
            dist.destroy_process_group()


def _small_gpt_rig(device, dropout=0.0):
    """A 2-layer GPT-2-shaped (D 64) rig of ``chip_smoke.resilience_rig``
    on the card, bf16 O2."""
    cfg = dict(config="gpt2-345m", batch=2, seq=128, device=device,
               dropout=dropout)
    from paddle_tpu_torch.models import gpt

    orig = gpt.GPT_CONFIGS["gpt2-345m"]
    gpt.GPT_CONFIGS["gpt2-345m"] = \
        lambda **kw: orig(**{**kw, "num_hidden_layers": 2})
    try:
        return chip_smoke.resilience_rig(**cfg)
    finally:
        gpt.GPT_CONFIGS["gpt2-345m"] = orig


@pytest.mark.cuda
def test_captured_step_rolled_back_then_replayed_is_bitwise(cuda_device):
    """A captured step (its graph replaying on fixed addresses) rolled back
    from a host snapshot, in place, and replayed ends bitwise equal to the
    uninterrupted run: the parameters, masters, moments, ``beta*_pow``,
    the sentry's state and the dropout generator all restored where the
    graph reads them."""
    from paddle_tpu_torch.distributed.fault_tolerance import (
        DivergenceSentry, MemorySnapshotRing, pack_state,
        restore_packed_state,
    )

    runs = []
    for rollback in (True, False):
        sentry = DivergenceSentry(device=cuda_device)
        ts, make, state_fn, restore_fn = _small_gpt_rig(cuda_device, 0.1)
        step = make(sentry)
        w = torch.ones(1, device=cuda_device)
        ring = MemorySnapshotRing(1)
        for i in range(6):
            if rollback and i == 3:
                snap = pack_state(state_fn(), i)
                snap["@sentry"] = sentry.state_dict()
                ring.take(snap)
                ptrs = [p.data_ptr() for p in ts.model.parameters()]
                for _ in range(2):           # two steps, thrown away
                    step(ts.x, ts.y, w)
                    sentry.poll()
                restore_packed_state(ring.newest(copy=False), restore_fn,
                                     sentry=sentry)
                assert [p.data_ptr() for p in ts.model.parameters()] == ptrs
            step(ts.x, ts.y, w)
            sentry.poll()
        assert step.captures == 1 and len(step.program_cache) == 1
        runs.append(chip_smoke.resilience_checksums(ts, sentry).cpu())
        del ts, make, step
        gc.collect()
        torch.cuda.empty_cache()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_bf16_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """bf16 and f32 card tensors through a format-2 checkpoint: loaded on
    the card (the template's device) bitwise, and the bf16 file holds the
    uint16 bits the JAX package reads."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt

    g = torch.Generator(device=cuda_device).manual_seed(0)
    state = {"w": torch.randn(64, 96, generator=g, device=cuda_device)
             .to(torch.bfloat16),
             "m": torch.randn(96, generator=g, device=cuda_device),
             "step": 3}
    path = str(tmp_path / "ck")
    ckpt.save_state_dict(state, path)
    assert ckpt.verify_checkpoint(path) == []
    tmpl = {"w": torch.empty_like(state["w"]),
            "m": torch.empty_like(state["m"]), "step": None}
    got = ckpt.load_state_dict(path, tmpl)
    assert got["w"].device.type == "cuda" and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], state["w"])
    assert torch.equal(got["m"], state["m"]) and got["step"] == 3
    bits = np.load(str(tmp_path / "ck" / "w.s0.full.npy"))
    assert bits.dtype == np.uint16
    assert np.array_equal(bits, state["w"].cpu().view(torch.int16).numpy()
                          .view(np.uint16))


@pytest.mark.cuda
def test_cost_ledger_counts_the_kernels_by_formula(cuda_device):
    """On the card K1-K3 are invisible to FlopCounterMode: the cost
    ledger counts each by ``attention_cost`` (2 layers: 2 forward and
    2 + 2 backward calls), its eager run launches each of K1-K3 once a
    layer and counts those launches, and its guarded run leaves the
    step's program and state as they were."""
    from paddle_tpu_torch.distributed.fault_tolerance import DivergenceSentry
    from paddle_tpu_torch.obs import CostLedger
    from paddle_tpu_torch.obs.cost import attention_cost

    sentry = DivergenceSentry(device=cuda_device)
    ts, make, state_fn, _ = _small_gpt_rig(cuda_device)
    step = make(sentry)
    w = torch.ones(1, device=cuda_device)
    for _ in range(3):
        step(ts.x, ts.y, w)
    before = chip_smoke.resilience_checksums(ts, sentry)
    launches = kernels.launch_counts()
    rec = CostLedger().add("train_step", step, ts.x, ts.y, w,
                           tokens_per_step=ts.x.numel(),
                           n_params=sum(p.numel()
                                        for p in ts.model.parameters()))
    cfg = ts.model.config
    H = cfg.num_attention_heads
    q = torch.empty(2, 128, H, cfg.hidden_size // H, dtype=torch.bfloat16)
    want = sum(attention_cost(k, q, True)[0]
               for k in ("fwd", "bwd_dkv", "bwd_dq")) * 2
    assert rec["attention_flops"] == want and rec["attention_calls"] == 6
    assert rec["flops"] > rec["attention_flops"] > 0
    assert len(step.program_cache) == 1 and step.captures == 1
    after = kernels.launch_counts()
    assert {n: c - launches[n] for n, c in after.items()
            if c != launches[n]} == {n: 2 for n in chip_smoke.TRAIN_KERNELS}
    assert torch.equal(chip_smoke.resilience_checksums(ts, sentry), before)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multi_head_attention_runs_k1_k3(cuda_device, dtype):
    """``nn.MultiHeadAttention`` self-attention at head dim 64: K1 in the
    forward, K2 and K3 in the backward (their dropout instances at
    dropout 0.1), the kernel route counted; against the same layer on
    the CPU (the plain versions)."""
    from paddle_tpu_torch import device_guard, nn, rng
    from paddle_tpu_torch.nn import functional as F

    rng.seed(0)
    with device_guard("cpu"):
        cpu = nn.MultiHeadAttention(128, 2).eval()
    dev = nn.MultiHeadAttention(128, 2).to(cuda_device, dtype=dtype).eval()
    dev.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 128, 128, generator=torch.Generator().manual_seed(1))
    xd = x.to(cuda_device, dtype).requires_grad_()
    routes = dict(F.ATTENTION_ROUTES)
    kernels.reset_launches()
    out = dev(xd)
    out.float().square().sum().backward()
    counts = kernels.launch_counts()
    assert {n: counts[n] for n in chip_smoke.TRAIN_KERNELS} == \
        dict.fromkeys(chip_smoke.TRAIN_KERNELS, 1)
    assert F.ATTENTION_ROUTES["kernel"] == routes["kernel"] + 1
    assert F.ATTENTION_ROUTES["plain"] == routes["plain"]
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float().cpu(), cpu(x), atol=tol,
                               rtol=tol)
    dev.train()
    dev.dropout = 0.1
    kernels.reset_launches()
    dev(xd).float().sum().backward()
    counts = kernels.launch_counts()
    assert all(counts[n] == 1 for n in chip_smoke.NN_TRAIN_KERNELS)


@pytest.mark.cuda
def test_nn_layers_default_to_the_card(cuda_device):
    """With no ``device=`` and no ``set_device``, a layer's parameters
    and buffers are made on the card."""
    from paddle_tpu_torch import device_guard, get_device, nn

    assert get_device() == f"gpu:{torch.cuda.current_device()}"
    net = nn.Sequential(nn.Linear(4, 4), nn.BatchNorm1D(4),
                        nn.TransformerEncoderLayer(64, 1, 128))
    assert all(t.is_cuda for t in net.state_dict().values())
    assert nn.Transformer.generate_square_subsequent_mask(4).is_cuda
    with device_guard("cpu"):
        assert not nn.Linear(4, 4).weight.is_cuda
    assert nn.Linear(4, 4).weight.is_cuda


@pytest.mark.cuda
def test_other_head_dims_take_the_plain_route(cuda_device):
    """Maskless self-attention at a head dim the kernels are not built
    for (32) takes the plain route on CUDA tensors (counted, no launch),
    as the JAX package falls back to its reference."""
    from paddle_tpu_torch.nn import functional as F

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, 64, 4, 32, generator=gen, device=cuda_device,
                           requires_grad=True) for _ in range(3))
    routes = dict(F.ATTENTION_ROUTES)
    kernels.reset_launches()
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    out.sum().backward()
    assert F.ATTENTION_ROUTES["plain"] == routes["plain"] + 1
    assert F.ATTENTION_ROUTES["kernel"] == routes["kernel"]
    assert not any(kernels.launch_counts().values())
    want = F.scaled_dot_product_attention(q.cpu(), k.cpu(), v.cpu(),
                                          is_causal=True)
    torch.testing.assert_close(out.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cross_and_masked_attention_take_the_plain_route(cuda_device):
    from paddle_tpu_torch import device_guard, nn
    from paddle_tpu_torch.nn import functional as F

    mha = nn.MultiHeadAttention(128, 2).to(cuda_device).eval()
    q = torch.randn(2, 16, 128, device=cuda_device)
    kv = torch.randn(2, 40, 128, device=cuda_device)
    mask = nn.Transformer.generate_square_subsequent_mask(16, cuda_device)
    routes = dict(F.ATTENTION_ROUTES)
    kernels.reset_launches()
    with torch.no_grad():
        cross = mha(q, kv, kv)
        masked = mha(q, attn_mask=mask)
    assert F.ATTENTION_ROUTES["plain"] == routes["plain"] + 2
    assert F.ATTENTION_ROUTES["kernel"] == routes["kernel"]
    assert not any(kernels.launch_counts().values())
    with device_guard("cpu"):
        cpu = nn.MultiHeadAttention(128, 2).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in mha.state_dict().items()})
    torch.testing.assert_close(cross.cpu(), cpu(q.cpu(), kv.cpu(), kv.cpu()),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(masked.cpu(), cpu(q.cpu(),
                                                 attn_mask=mask.cpu()),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_batch_norm_step_under_to_static_updates_running_stats(cuda_device):
    """A Conv2D + BatchNorm2D + Linear step through ``jit.to_static``
    (eager first call, capture, replays) updates ``_mean``/``_variance``
    in place at every replay, equal to the same step run eagerly."""
    from paddle_tpu_torch import device_guard, jit, nn, rng
    from paddle_tpu_torch.optimizer import Momentum

    def build():
        rng.seed(0)
        with device_guard(cuda_device):
            net = nn.Sequential(nn.Conv2D(3, 8, 3, padding=1),
                                nn.BatchNorm2D(8), nn.ReLU(), nn.Flatten(),
                                nn.Linear(8 * 36, 4))
        opt = Momentum(net.parameters(), lr=0.05)

        def step(x, y):
            loss = nn.functional.cross_entropy(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()
        return net, step

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    xs = [torch.randn(16, 3, 6, 6, generator=gen, device=cuda_device) * 2
          + 1 for _ in range(5)]
    y = torch.randint(0, 4, (16,), generator=gen, device=cuda_device)
    eager_net, eager_step = build()
    eager = [eager_step(x, y) for x in xs]
    net, body = build()
    step = jit.to_static(body)
    bn = net[1]
    mean_ptr = bn._mean.data_ptr()
    means = []
    losses = []
    for x in xs:
        losses.append(step(x, y))
        means.append(bn._mean.clone())
    assert step.captures == 1 and bn._mean.data_ptr() == mean_ptr
    assert not torch.equal(means[-1], means[-2])      # replays update it
    torch.testing.assert_close(torch.stack(losses), torch.stack(eager),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(bn._mean, eager_net[1]._mean, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(bn._variance, eager_net[1]._variance,
                               atol=1e-5, rtol=1e-5)


# ---- the high-level path: RNN, beam search, io workers, Model.fit ---------

def _rnn_pair(cls, cuda_device, **kw):
    """``cls(**kw)`` on the card and its CPU twin (the same draw)."""
    import copy

    from paddle_tpu_torch import device_guard, rng

    rng.seed(0)
    with device_guard(cuda_device):
        net = cls(**kw)
    return net, copy.deepcopy(net).to("cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
def test_rnn_forward_backward_on_the_card_match_the_cpu(cuda_device, kind,
                                                        direction):
    from paddle_tpu_torch import nn

    card, cpu = _rnn_pair(getattr(nn, kind), cuda_device, input_size=48,
                          hidden_size=64, num_layers=2, direction=direction)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 30, 48, generator=gen)
    c = torch.randn(4, 30, 64 * (2 if direction == "bidirect" else 1),
                    generator=gen)
    outs = {}
    for name, net, dev in (("card", card, cuda_device), ("cpu", cpu, "cpu")):
        xi = x.to(dev).requires_grad_()
        out, _ = net(xi)
        (out * c.to(dev)).sum().backward()
        outs[name] = (out.detach().cpu(), xi.grad.cpu(),
                      {n: p.grad.cpu() for n, p in net.named_parameters()})
    assert card.fw_cells[0].weight_ih.device.type == "cuda"
    torch.testing.assert_close(outs["card"][0], outs["cpu"][0], atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(outs["card"][1], outs["cpu"][1], atol=1e-4,
                               rtol=1e-4)
    for n, g in outs["cpu"][2].items():
        scale = max(float(g.abs().max()), 1e-3)
        err = float((outs["card"][2][n] - g).abs().max()) / scale
        assert err <= 1e-4, (n, err)


@pytest.mark.cuda
def test_beam_search_ties_on_the_card_equal_the_cpu(cuda_device):
    """The deterministic cell's table (every step ties exactly): the
    card's stable sort keeps ``lax.top_k``'s order, as the CPU's does."""
    from paddle_tpu_torch import nn

    V, B, K = 9, 3, 5
    tbl = torch.full((V, V), -5.0)
    for t in range(V):
        tbl[t, (t + 1) % V] = 5.0

    def decode(dev):
        table = tbl.to(dev)

        class Recording(nn.BeamSearchDecoder):
            def finalize(self, outputs, final_states, lengths):
                self.raw = outputs
                return super().finalize(outputs, final_states, lengths)

        dec = Recording(lambda ids, st: (table.index_select(0, ids), st),
                        0, V - 1, K)
        seqs, _, lens = nn.dynamic_decode(
            dec, inits=torch.zeros(B, 1, device=dev), max_step_num=12,
            return_length=True)
        return [t.cpu() for t in (seqs, dec.raw.predicted_ids,
                                  dec.raw.parent_ids, dec.raw.scores, lens)]

    card, cpu = decode(cuda_device), decode("cpu")
    for a, b in zip(card[:3] + card[4:], cpu[:3] + cpu[4:]):
        assert torch.equal(a, b)
    torch.testing.assert_close(card[3], cpu[3], atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_two_workers_feed_a_card_model(cuda_device):
    """Two spawned workers load through the shared-memory ring, without
    CUDA in either, and their batches train a model on the card."""
    import os

    import torch_io_data
    from paddle_tpu_torch import Model, device_guard, io, nn, rng
    from paddle_tpu_torch.optimizer import SGD

    probe = io.DataLoader(torch_io_data.WorkerProbe(8), batch_size=2,
                          num_workers=2, timeout=60)
    batches = list(probe)
    assert probe.transport == {"ring": 4, "queue": 0}
    assert all(int(b[2].sum()) == 0 and int(b[3].min()) == 1
               for b in batches)
    assert os.getpid() not in {int(v) for b in batches for v in b[1]}
    rng.seed(0)
    with device_guard(cuda_device):
        net = nn.Linear(1, 3)
    model = Model(net).prepare(SGD(net.parameters(), lr=0.1),
                               nn.CrossEntropyLoss())
    loader = io.DataLoader(torch_io_data.RangeDataset(24), batch_size=6,
                           num_workers=2, timeout=60)
    model.fit(loader, epochs=1, verbose=0)
    assert loader.transport == {"ring": 4, "queue": 0}
    assert net.weight.device.type == "cuda" and torch.isfinite(
        net.weight).all()


@pytest.mark.cuda
def test_model_fit_on_the_card_matches_the_cpu(cuda_device):
    """A classifier on the card trains, evaluates and predicts through
    ``Model`` as its CPU twin does (f32, 1e-5)."""
    import copy

    from paddle_tpu_torch import Model, device_guard, metric, nn, rng
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.optimizer import Adam

    class Losses(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    rs = np.random.RandomState(0)
    x = rs.randn(64, 16).astype(np.float32)
    y = (x @ rs.randn(16) > 0).astype(np.int64)
    data = list(zip(x, y))
    rng.seed(0)
    with device_guard(cuda_device):
        net = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 2))
    runs = {}
    for name, n in (("card", net), ("cpu", copy.deepcopy(net).to("cpu"))):
        m = Model(n).prepare(Adam(n.parameters(), lr=0.01),
                             nn.CrossEntropyLoss(), metrics=metric.Accuracy())
        rec = Losses()
        m.fit(data, batch_size=16, epochs=2, verbose=0, shuffle=False,
              callbacks=[rec])
        runs[name] = (rec.losses, m.evaluate(data, batch_size=32, verbose=0),
                      m.predict(data, batch_size=32, stack_outputs=True)[0])
    np.testing.assert_allclose(runs["card"][0], runs["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    assert runs["card"][1]["acc"] == runs["cpu"][1]["acc"]
    np.testing.assert_allclose(runs["card"][1]["loss"], runs["cpu"][1]["loss"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(runs["card"][2], runs["cpu"][2], rtol=1e-5,
                               atol=1e-5)
    assert net.parameters()[0].device.type == "cuda"


# -- dygraph-to-static: tensor control flow as CUDA graph IF / WHILE nodes ---

class _CfNet(torch.nn.Module):
    """``tests/test_jit.py:249``'s forward: an early return on a tensor's
    sign, else a loop."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 4)

    def forward(self, x):
        h = self.lin(x)
        if h.sum() > 0:
            return h * 2
        i = 0
        while i < 2:
            h = h + 1
            i += 1
        return h


@pytest.mark.cuda
def test_tensor_branch_captured_and_saved(cuda_device, tmp_path):
    """One CUDA graph takes either branch at replay (IF nodes), equal to
    the eager forward (1e-6); the saved program (``torch.cond``) loaded on
    the card too, both signs and a batch of 7."""
    from paddle_tpu_torch import jit, static

    torch.manual_seed(0)
    net = _CfNet().to(cuda_device)
    f = jit.to_static(net.forward)
    pos = torch.ones(2, 4, device=cuda_device)
    neg = -10 * torch.ones(2, 4, device=cuda_device)
    with torch.no_grad():
        want = {s: net(x) for s, x in (("pos", pos), ("neg", neg))}
        kernels.reset_launches()
        for s in ("pos", "pos", "pos", "neg", "pos", "neg"):
            got = f(pos if s == "pos" else neg)
            assert torch.allclose(got, want[s], rtol=0, atol=1e-6), s
    assert f.captures == 1 and len(f.program_cache) == 1
    assert kernels.launch_counts()["graph_conditional"] > 0
    stats = f.last_program().compiled_stats()
    assert "hlo" not in stats and stats["temp_bytes"] > 0
    path = str(tmp_path / "cf")
    jit.save(net, path, input_spec=[static.InputSpec([None, 4], "float32")])
    loaded = jit.load(path, device="cuda")
    for s, x in (("pos", pos), ("neg", neg)):
        assert torch.allclose(loaded(x), want[s], rtol=0, atol=1e-6)
    assert loaded(torch.ones(7, 4)).shape == (7, 4)


class _BranchyNet(torch.nn.Module):
    """``tests/test_dy2static.py``'s ``BranchyNet``."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(4, 4)
        self.b = torch.nn.Linear(4, 4)

    def forward(self, x):
        if x.mean() > 0:
            h = self.a(x)
        else:
            h = self.b(x)
        return h.sum()


@pytest.mark.cuda
@pytest.mark.parametrize("first", [1.0, -1.0])
def test_branchy_train_step_captured_both_ways(cuda_device, first):
    """The train step (forward, backward) captured with the branch taken
    one way at its eager call and capture, then replayed both ways: loss
    and every gradient equal the eager step's on a copy of the net
    (1e-6; the untaken layer's gradient is zero in the graph, unset in the
    eager step).  The captured ``cond``'s backward is its second IF
    pair."""
    import copy

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.jit import dy2static

    torch.manual_seed(0)
    net = _BranchyNet().to(cuda_device)
    ref = copy.deepcopy(net)
    fwd = dy2static.convert_function(net.forward)

    @jit.to_static
    def step(x):
        loss = fwd(x)
        loss.backward()
        return loss

    x0 = torch.randn(2, 4, device=cuda_device).abs()
    for sign in (first, first, first, -first, first, -first):
        x = x0 * sign
        for p in net.parameters():
            if p.grad is not None:
                p.grad.zero_()
        ref.zero_grad(set_to_none=True)
        loss = step(x)
        want = ref(x)
        want.backward()
        torch.cuda.synchronize()
        assert abs(float(loss) - float(want)) <= 1e-6
        for p, q in zip(net.parameters(), ref.parameters()):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            h = q.grad if q.grad is not None else torch.zeros_like(q)
            assert torch.allclose(g, h, rtol=0, atol=1e-6)
    assert step.captures == 1


@pytest.mark.cuda
def test_untaken_branch_is_warmed_before_the_capture(cuda_device):
    """At a program's eager first call the untaken branch runs once under
    a relaxed capture that is thrown away (its kernels never run): here a
    matmul of a shape the card has not run, on the body stream.  The
    capture then finds its library state made, and the graph's two
    branches equal the eager function's (1e-5: cuBLAS may pick other
    kernels on another stream)."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.static import nn as snn

    wa = torch.randn(48, 80, device=cuda_device)
    wb = torch.randn(48, 112, device=cuda_device)

    def body(x):
        if x.sum() > 0:
            y = (x @ wa).sum(dim=1)
        else:
            y = (x @ wb).sum(dim=1)
        return y

    f = jit.to_static(body)
    before = snn.warmups
    pos = torch.ones(24, 48, device=cuda_device)
    with torch.no_grad():
        want = {1: body(pos), -1: body(-pos)}
        f(pos)
        assert snn.warmups == before + 1       # the untaken side, warmed
        for s in (1, 1, -1, 1, -1):
            got = f(pos * s)
            assert torch.allclose(got, want[s], rtol=1e-5, atol=1e-5)
    assert f.captures == 1


@pytest.mark.cuda
def test_while_node_trips_follow_the_data(cuda_device):
    """A loop over a tensor's value with K1 in its body, captured once
    (one WHILE node): replays at 3, 5 and 0 trips equal the eager loop
    (exactly: the same kernels in the same order), and K1's launches count
    once a trip."""
    from paddle_tpu_torch import jit

    q = torch.randn(1, 64, 2, 64, device=cuda_device, dtype=torch.bfloat16)

    def loop(x, n):
        # no temporary: a name first bound in a loop's body needs a value
        # before the loop (the JAX package's rule)
        while n > 0:
            x = x + kernels.flash_fwd(q, q, q + x)[0]
            n = n - 1
        return x

    f = jit.to_static(loop)
    x = torch.zeros_like(q)
    for n in (3, 3, 3, 5, 0):
        nt = torch.tensor(n, device=cuda_device)
        want = loop(x, nt)
        kernels.reset_launches()
        got = f(x, nt)
        counts = kernels.launch_counts()
        assert torch.equal(got, want)
        if f.captures:
            assert counts["flash_fwd"] == n, (n, counts)
    assert f.captures == 1


@pytest.mark.cuda
def test_backward_through_a_captured_while_raises(cuda_device):
    """A captured WHILE node is forward-only: the capture of a step whose
    backward runs through one fails, naming the limit (the eager first
    call, a Python loop, differentiates)."""
    from paddle_tpu_torch import jit

    w = torch.nn.Parameter(torch.ones(4, device=cuda_device))

    @jit.to_static
    def step(x, n):
        s = x * 0
        while n > 0:
            s = s + w * x
            n = n - 1
        loss = s.sum()
        loss.backward()
        return loss

    x, n = torch.ones(4, device=cuda_device), torch.tensor(2, device=cuda_device)
    assert float(step(x, n)) == 8.0 and torch.equal(
        w.grad, torch.full_like(w, 2.0))
    with pytest.raises(jit.CaptureError, match="forward-only"):
        step(x, n)


@pytest.mark.cuda
def test_conditional_node_counters_belong_to_their_program(cuda_device,
                                                           monkeypatch):
    """Each program takes its conditional nodes' run counters from a bank
    of its own, made before its capture.  With banks of 2: three programs
    of one tensor ``if`` (an IF pair each) capture, equal the eager
    function (exactly: the same kernels) and count K1 once a taken branch;
    a program of two ``if``s (4 nodes) fails its capture naming the bank,
    and a program made after it still captures.  The programs' counts go
    with them."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.static import nn as snn

    monkeypatch.setattr(snn, "COUNTERS", 2)
    q = torch.randn(1, 64, 2, 64, device=cuda_device, dtype=torch.bfloat16)

    def one(x):
        if x.sum() > 0:
            y = kernels.flash_fwd(q, q, q + x)[0]
        else:
            y = x * 2
        return y

    def two(x):
        if x.sum() > 0:
            y = x + 1
        else:
            y = x - 1
        if y.sum() > 0:
            y = y * 2
        else:
            y = y * 3
        return y

    gc.collect()
    sources = len(kernels._per_run_sources)
    x = torch.full_like(q, 0.5)
    want = {1: one(x), -1: one(-x)}

    def check(f):
        f(x)
        f(x)
        for s in (1, -1, 1):
            kernels.reset_launches()
            assert torch.equal(f(x * s), want[s])
            assert kernels.launch_counts()["flash_fwd"] == (s > 0)
        assert f.captures == 1

    fs = [jit.to_static(one) for _ in range(3)]
    for f in fs:
        check(f)
    g = jit.to_static(two)
    g(x)
    with pytest.raises(jit.CaptureError, match="more than 2 conditional"):
        g(x)
    h = jit.to_static(one)
    check(h)
    del fs, g, h, f
    gc.collect()
    assert len(kernels._per_run_sources) == sources


@pytest.mark.cuda
def test_untaken_branch_making_module_state_raises(cuda_device):
    """A warm-up runs no kernels, so tensor state that the untaken branch
    makes while it is warmed would hold no values: a buffer registered
    lazily there is taken out again and the first call raises, naming
    it.  The module is as it was, and its eager calls are unchanged."""
    from paddle_tpu_torch import jit

    class Lazy(torch.nn.Module):
        def forward(self, x):
            if x.sum() > 0:
                y = x * 2
            else:
                if not hasattr(self, "scale"):
                    self.register_buffer("scale", torch.full_like(x, 3.0))
                y = x * self.scale
            return y

    net = Lazy()
    f = jit.to_static(net.forward)
    pos = torch.ones(8, device=cuda_device)
    with torch.no_grad():
        with pytest.raises(jit.CaptureError, match="Lazy.scale"):
            f(pos)
        assert "scale" not in dict(net.named_buffers())
        assert not hasattr(net, "scale")
        assert torch.equal(net(-pos), -3 * pos)
        assert torch.equal(net(pos), 2 * pos)


# -- the WHILE node's carry write-back, the op surface, ResNet ------------

def _shift_and_double(x, n):
    cur = x
    prev = x * 0
    i = n * 0
    while i < n:
        prev = cur
        cur = cur * 2
        i = i + 1
    return cur, prev


@pytest.mark.cuda
def test_carry_permutation_captured_through_to_static(cuda_device):
    """``prev = cur; cur = cur * 2`` (dy2static carries ``cur, i, prev`` in
    name order) and ``a, b = b, a`` captured as WHILE nodes: every replay
    equals the eager call, exactly (before the staged write-back ``prev``
    came out as the new ``cur``)."""
    from paddle_tpu_torch import jit

    def swap(a, b, n):
        i = n * 0
        while i < n:
            a, b = b, a
            i = i + 1
        return a, b

    x = torch.tensor([3.0, -1.5], device=cuda_device)
    y = torch.tensor([7.0, 9.0], device=cuda_device)
    f, g = jit.to_static(_shift_and_double), jit.to_static(swap)
    for n in (1, 1, 3, 2, 0):
        nt = torch.tensor(n, device=cuda_device)
        for got, want in ((f(x, nt), _shift_and_double(x, nt)),
                          (g(x, y, nt), swap(x, y, nt))):
            for a, b in zip(got, want):
                assert torch.equal(a, b), (n, got, want)
    assert f.captures == 1 and g.captures == 1


@pytest.mark.cuda
def test_carry_permutation_captured_through_while_loop(cuda_device):
    """``static.nn.while_loop`` whose body permutes its carries (and passes
    one through) captured in a graph of one's own: the replay equals the
    eager loop."""
    from paddle_tpu_torch import static

    def body(i, a, b, c):
        return i + 1, b, a * 2, c

    def init():
        return [torch.zeros((), dtype=torch.int64, device=cuda_device),
                torch.tensor([1.0], device=cuda_device),
                torch.tensor([5.0], device=cuda_device),
                torch.tensor([8.0], device=cuda_device)]

    n = torch.tensor(3, device=cuda_device)
    want = static.while_loop(lambda i, a, b, c: i < n, body, init())
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    graph, start = torch.cuda.CUDAGraph(), init()
    nodes = static.nn.Nodes(torch.device(cuda_device))
    with nodes, torch.cuda.graph(graph, stream=side):
        out = static.while_loop(lambda i, a, b, c: i < n, body, start)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, want):
        assert torch.equal(a, b), (out, want)
    assert [float(v) for v in out[1:]] == [10.0, 4.0, 8.0]
    del graph
    nodes.release()


@pytest.mark.cuda
def test_topk_argsort_tie_order_on_cuda(cuda_device):
    """The tie orders of the JAX package on the card (as on the CPU):
    ``topk`` lower index first, descending ``argsort`` the flip of the
    stable ascending sort, over a row long enough for torch's multi-block
    sort."""
    import paddle_tpu_torch as paddle

    rs = np.random.RandomState(0)
    x = rs.randint(0, 4, (3, 5000)).astype(np.float32)
    dev, cpu = torch.tensor(x, device=cuda_device), torch.tensor(x)
    for k in (1, 7, 100):
        for largest in (True, False):
            v, i = paddle.topk(dev, k, largest=largest)
            cv, ci = paddle.topk(cpu, k, largest=largest)
            assert torch.equal(i.cpu(), ci) and torch.equal(v.cpu(), cv)
    for desc in (False, True):
        assert torch.equal(paddle.argsort(dev, descending=desc).cpu(),
                           paddle.argsort(cpu, descending=desc))
    stable = np.argsort(x, axis=-1, kind="stable")
    assert np.array_equal(paddle.argsort(dev, descending=True).cpu().numpy(),
                          stable[:, ::-1])


@pytest.mark.cuda
def test_resnet18_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One ``Model.train_batch`` of ResNet-18 (Momentum, ``L2Decay``) on the
    card and on a CPU copy from the same weights, batch 8 at 64 x 64:
    loss within 1e-4 relative, every parameter after the step within 1e-3
    of its scale (f32 convolutions through cuDNN, TF32 off, and the
    CPU's)."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False        # f32 on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _resnet18_step(cuda_device)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _resnet18_step(cuda_device):
    import copy

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer, regularizer

    paddle.seed(0)
    with paddle.device_guard("cpu"):
        cpu_net = paddle.vision.resnet18(num_classes=10)
    dev_net = copy.deepcopy(cpu_net).to(cuda_device)
    rs = np.random.RandomState(1)
    x = rs.rand(8, 3, 64, 64).astype(np.float32)
    y = rs.randint(0, 10, (8, 1)).astype(np.int64)
    losses = []
    for net in (dev_net, cpu_net):
        m = paddle.Model(net).prepare(
            optimizer.Momentum(net.parameters(), lr=0.01, momentum=0.9,
                               weight_decay=regularizer.L2Decay(1e-4)),
            paddle.nn.CrossEntropyLoss())
        losses.append(float(np.asarray(m.train_batch([x], [y])[0])
                            .reshape(-1)[0]))
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1]), losses
    want = dict(cpu_net.named_parameters())
    for name, p in dev_net.named_parameters():
        w = want[name].detach()
        err = float((p.detach().cpu() - w).abs().max())
        assert err <= 1e-3 * float(w.abs().max()), (name, err)


#: vision_ops' drive at a card test's size (the phase runs the detectors'
#: shapes): every op on the card against the CPU
VISION_OPS_SMALL = {
    "yolo": dict(chip_smoke.VISION_OPS["yolo"], batch=2, grids=(4, 8, 16),
                 image=128, gt_boxes=12),
    "nms": dict(chip_smoke.VISION_OPS["nms"], boxes=300),
    "roi": dict(chip_smoke.VISION_OPS["roi"], feat=(2, 32, 50, 68),
                rois=64),
    "psroi": dict(chip_smoke.VISION_OPS["psroi"], feat=(2, 98, 50, 68)),
    "deform": dict(chip_smoke.VISION_OPS["deform"], x=(2, 64, 12, 17),
                   cout=32),
    "viterbi": dict(chip_smoke.VISION_OPS["viterbi"], batch=16, seq=40),
}


@pytest.mark.cuda
def test_vision_ops_on_the_card_match_the_cpu(cuda_device):
    """Every detection op of ``vision_ops`` on the card against the CPU,
    forward and gradient within ``chip_smoke.VISION_OPS_TOLERANCE`` of
    their scale (TF32 off), nms's indices and the Viterbi paths equal."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = chip_smoke.drive_vision_ops(VISION_OPS_SMALL, "cuda", "cpu",
                                          reps=1)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    assert not res["failed"], res["failed"]
    assert len(res["ops"]) == 12


def _captured_equals_eager(fn, args, tol):
    """``fn`` through ``jit.to_static``: its eager first call, its capture
    at the second and a replay at the third give the same values."""
    from paddle_tpu_torch import jit

    prog = jit.to_static(fn)
    eager = [o.clone() for o in prog(*args)]
    prog(*args)
    replay = prog(*args)
    assert prog.captures == 1 and prog.hits >= 1
    for a, b in zip(replay, eager):
        err = float((a - b).abs().max())
        assert err <= tol * max(float(b.abs().max()), 1.0), err


@pytest.mark.cuda
def test_roi_ops_in_a_capture_use_the_map_bound(cuda_device):
    """Inside a CUDA graph the RoI ops read no boxes on the host: windows
    and roi_align's adaptive grid take the feature map's bound, and the
    replay gives the eager values (1e-5 of scale: more zero terms in the
    window sums)."""
    from paddle_tpu_torch.vision import ops as V

    rs = np.random.RandomState(0)
    feat = torch.tensor(rs.randn(2, 8, 24, 30).astype(np.float32),
                        device=cuda_device)
    xy = rs.uniform(-4, 80, (10, 2))
    boxes = torch.tensor(np.concatenate(
        [xy, xy + rs.uniform(6, 60, (10, 2))], 1).astype(np.float32),
        device=cuda_device)
    num = torch.tensor([6, 4], dtype=torch.int32, device=cuda_device)
    ps = torch.tensor(rs.randn(2, 8 * 4, 24, 30).astype(np.float32),
                      device=cuda_device)

    def f(feat, ps, boxes, num):
        return (V.roi_align(feat, boxes, num, 4, 0.25, -1, True),
                V.roi_pool(feat, boxes, num, 3, 0.25),
                V.psroi_pool(ps, boxes, num, 2, 0.25))

    _captured_equals_eager(f, (feat, ps, boxes, num), 1e-5)


@pytest.mark.cuda
def test_yolo_ops_in_a_capture(cuda_device):
    """``yolo_box`` and ``yolo_loss`` make their anchors on the device by
    fills, so they capture; the replay gives the eager values (1e-6 of
    scale)."""
    from paddle_tpu_torch.vision import ops as V

    rs = np.random.RandomState(3)
    x = torch.tensor(rs.randn(2, 3 * 9, 8, 8).astype(np.float32),
                     device=cuda_device)
    img = torch.tensor([[256, 256], [200, 240]], dtype=torch.int32,
                       device=cuda_device)
    gt = torch.tensor(np.concatenate([rs.uniform(0.1, 0.9, (2, 5, 2)),
                                      rs.uniform(0.05, 0.5, (2, 5, 2))],
                                     2).astype(np.float32),
                      device=cuda_device)
    label = torch.tensor(rs.randint(0, 4, (2, 5)), device=cuda_device)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]

    def f(x, img, gt, label):
        boxes, scores = V.yolo_box(x, img, anchors[:6], 4, 0.01, 32)
        return boxes, scores, V.yolo_loss(x, gt, label, anchors, [0, 1, 2],
                                          4, 0.7, 32)

    _captured_equals_eager(f, (x, img, gt, label), 1e-6)


@pytest.mark.cuda
def test_nms_refuses_a_capture(cuda_device):
    """``nms`` reads its suppression mask on the host, so inside a CUDA
    graph it raises ``CaptureError`` (its eager call runs)."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.vision import ops as V

    boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30]],
                         dtype=torch.float32, device=cuda_device)
    scores = torch.tensor([0.9, 0.8, 0.7], device=cuda_device)
    def keep(b, s):
        return V.nms(b, 0.5, s) + 0

    prog = jit.to_static(keep)
    assert prog(boxes, scores).tolist() == [0, 2]
    with pytest.raises(jit.CaptureError, match="nms"):
        prog(boxes, scores)


@pytest.mark.cuda
def test_viterbi_ties_and_capture_on_the_card(cuda_device):
    """Viterbi on the card: integer potentials (many ties) decode to the
    CPU's paths (both take the first tag); in a CUDA graph the paths keep
    all S steps (no host read of the lengths) and equal the eager ones
    there."""
    from paddle_tpu_torch import text

    rs = np.random.RandomState(1)
    pot = rs.randint(0, 3, (8, 12, 7)).astype(np.float32)
    trans = rs.randint(0, 2, (7, 7)).astype(np.float32)
    lens = rs.randint(1, 11, 8).astype(np.int64)
    for include in (False, True):
        cs, cp = text.viterbi_decode(torch.tensor(pot), torch.tensor(trans),
                                     torch.tensor(lens), include)
        ds, dp = text.viterbi_decode(
            torch.tensor(pot, device=cuda_device),
            torch.tensor(trans, device=cuda_device),
            torch.tensor(lens, device=cuda_device), include)
        assert torch.equal(dp.cpu(), cp) and torch.equal(ds.cpu(), cs)
    from paddle_tpu_torch import jit

    args = [torch.tensor(a, device=cuda_device) for a in (pot, trans, lens)]
    def decode(p, t, n):
        return text.viterbi_decode(p, t, n)

    prog = jit.to_static(decode)
    s0, p0 = prog(*args)
    prog(*args)
    s2, p2 = prog(*args)
    assert tuple(p2.shape) == (8, 12) and tuple(p0.shape) == (8, 10)
    assert torch.equal(p2[:, :10], p0) and (p2[:, 10:] == 0).all()
    assert torch.equal(s2, s0)


@pytest.mark.cuda
def test_mobilenet_v3_small_train_step_on_the_card_matches_the_cpu(
        cuda_device):
    """One ``Model.train_batch`` of MobileNetV3 small (depthwise
    convolutions, Hardswish, squeeze-excite; dropout at p = 0) on the card
    and on a CPU copy from the same weights, batch 8 at 64 x 64: loss
    within 1e-4 relative, every parameter after the step within 1e-3 of
    its scale, at least 1e-6 (f32, TF32 off; a batch norm's bias that
    feeds another batch norm through a linear map has a zero gradient in
    exact arithmetic and holds rounding noise, ~5e-10, after the
    step)."""
    import copy

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer, regularizer

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        paddle.seed(0)
        with paddle.device_guard("cpu"):
            cpu_net = paddle.vision.mobilenet_v3_small(num_classes=10)
        for m in cpu_net.sublayers():
            if isinstance(m, paddle.nn.Dropout):
                m.p = 0.0
        dev_net = copy.deepcopy(cpu_net).to(cuda_device)
        rs = np.random.RandomState(1)
        x = rs.rand(8, 3, 64, 64).astype(np.float32)
        y = rs.randint(0, 10, (8, 1)).astype(np.int64)
        losses = []
        for net in (dev_net, cpu_net):
            m = paddle.Model(net).prepare(
                optimizer.Momentum(net.parameters(), lr=0.01, momentum=0.9,
                                   weight_decay=regularizer.L2Decay(1e-4)),
                paddle.nn.CrossEntropyLoss())
            losses.append(float(np.asarray(m.train_batch([x], [y])[0])
                                .reshape(-1)[0]))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1]), losses
    want = dict(cpu_net.named_parameters())
    for name, p in dev_net.named_parameters():
        w = want[name].detach()
        err = float((p.detach().cpu() - w).abs().max())
        assert err <= 1e-3 * max(float(w.abs().max()), 1e-6), (name, err)


@pytest.mark.cuda
def test_image_tensors_land_on_the_card(cuda_device, tmp_path):
    """``image_load(backend="tensor")``, ``read_file`` and ``decode_jpeg``
    give CHW uint8 tensors on the current device, the card by default."""
    from PIL import Image

    from paddle_tpu_torch.vision import image, ops as V

    img = np.random.RandomState(2).randint(0, 256, (5, 7, 3)).astype(
        np.uint8)
    png, jpg = str(tmp_path / "x.png"), str(tmp_path / "x.jpg")
    Image.fromarray(img).save(png)
    Image.fromarray(img).save(jpg)
    t = image.image_load(png, backend="tensor")
    assert t.is_cuda and t.dtype == torch.uint8
    assert np.array_equal(t.cpu().numpy(), img.transpose(2, 0, 1))
    data = V.read_file(jpg)
    dec = V.decode_jpeg(data, mode="rgb")
    assert data.is_cuda and dec.is_cuda and tuple(dec.shape) == (3, 5, 7)


# -- distributed: the launcher's NCCL world of one ------------------------------

def _launch_hybrid(tmp_path, *args):
    """``hybrid_train.py`` through the launcher on the card (GPT-2 345M's
    widths at 2 layers, S 64)."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "res.json")
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "1", "--log_dir", str(tmp_path),
         os.path.join("paddle_tpu_torch", "distributed", "launch",
                      "hybrid_train.py"), "--out", out, "--config",
         "gpt2-345m", "--layers", "2", "--seq", "64", *args], cwd=repo, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, (tmp_path / "workerlog.0").read_text()[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.cuda
def test_launcher_nccl_world_of_one(cuda_device, tmp_path):
    """A launched worker joins an NCCL world of one: every collective of
    ``distributed.collective`` on the card gives its expected value, an
    all-reduce captured in a CUDA graph replays to the eager result,
    gradient merge equals one full-batch update (f32, 1e-5) and refuses a
    compiled step; the fleet step at degree 1 runs through the wrappers
    and is bitwise the step built in this process without them."""
    from paddle_tpu_torch import build_train_step

    res = _launch_hybrid(tmp_path, "--warmup", "2", "--steps", "3")
    assert res["world"] == {"backend": "nccl", "size": 1}
    assert all(res["collectives"].values()), res["collectives"]
    assert res["capture"]["equal"], res["capture"]
    assert res["merge"]["max_abs_diff"] <= 1e-5
    assert res["merge"]["refuses_to_static"]
    fl = res["fleet"]
    assert (fl["model"], fl["optimizer"]) == ("TensorParallel",
                                              "HybridParallelOptimizer")
    assert fl["program_cache"]["captures"] == 1
    ts = build_train_step("gpt2-345m", batch=8, seq=64, device="cuda",
                          num_layers=2)
    assert type(ts.model).__name__ == "GPTForCausalLM"    # no launcher
    losses = [float(ts.train_step(ts.x, ts.y)) for _ in range(5)]
    assert losses == fl["losses"]
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        assert fl["launches"][name] == fl["layers"] * 5


@pytest.mark.cuda
def test_all_reduce_captured_in_a_graph(cuda_device):
    """In this process's world of one (NCCL): the capture and its replay."""
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.launch.hybrid_train import (
        capture_all_reduce,
    )

    mesh.ensure_world("cuda")
    res = capture_all_reduce("cuda")
    assert res["equal"] and res["max_abs_diff"] == 0.0


@pytest.mark.cuda
def test_tensor_parallel_dropout_refuses_the_card(cuda_device):
    """K1-K3's dropout instances draw at the rank's own coordinates (no
    longer refused): under ``shard_coordinates`` a head shard's attention
    on the card equals the plain version at the same coordinates, and its
    gradients reach the inputs."""
    from paddle_tpu_torch import rng
    from paddle_tpu_torch.ops.attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(2, 64, 2, 64, device="cuda", generator=gen)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    rng.default_generator("cuda").manual_seed(11)
    before = kernels.KERNELS["flash_fwd_dropout"].launches
    with rng.shard_coordinates(batch_start=2, head_start=2, heads_total=4):
        out = flash_attention(q, q, q, is_causal=True, dropout_p=0.1)
    assert kernels.KERNELS["flash_fwd_dropout"].launches == before + 1
    rng.default_generator("cuda").manual_seed(11)
    with rng.shard_coordinates(batch_start=2, head_start=2, heads_total=4):
        ref = flash_attention(q, q, q, is_causal=True, dropout_p=0.1,
                              kernel="reference")
    assert (out.float() - ref.float()).abs().max().item() <= 3e-2 / 0.9
    out.float().sum().backward()
    assert torch.isfinite(q.grad.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["flash_fwd", "flash_bwd_dkv",
                                   "flash_bwd_dq"])
def test_dropout_at_coordinates_matches_the_whole_draw(cuda_device, which):
    """Each quarter (2 batch x 2 head halves) of a problem, drawn at its
    coordinates, equals the slice of the whole problem's kernel output,
    and its plain version within the kernels' tolerances."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    res = chip_smoke.check_dropout_coords(gen, which, torch.bfloat16, B=4,
                                          S=256, H=4, D=64, p=0.25)
    assert res["slice_bitwise"], res
    assert res["err"] <= res["tol"], res


@pytest.mark.cuda
def test_small_ring_on_the_card_matches_the_whole_call(cuda_device):
    """The in-process ring (4 chunks of 128, bf16, causal) on K1-K3: its
    output and gradients against one K1-K3 call over the whole 512 and
    against the plain ring, each kernel launched once per visible tick."""
    res = chip_smoke.drive_ring_attention("cuda", shape=(2, 512, 4, 64),
                                          chunks=4)
    assert res["launches"] == {"flash_fwd": 10, "flash_bwd_dkv": 10,
                               "flash_bwd_dq": 10}
    for key in ("out_err_whole", "out_err_plain"):
        assert res[key] <= chip_smoke.TOLERANCE[torch.bfloat16], res
    for key in ("grad_rel_err_whole", "grad_rel_err_plain"):
        assert res[key] <= chip_smoke.BWD_TOLERANCE[torch.bfloat16], res


def _moe_model(device):
    """A small MoE LM of :func:`chip_smoke.moe_gpt` (2 layers, one MoE of
    4 experts with the PyLayer GeLU), bf16 O2."""
    from paddle_tpu_torch import amp, device as pdev, rng

    rng.seed(0)
    cfg = {"vocab": 256, "positions": 64, "hidden": 128, "heads": 2,
           "ffn": 256, "layers": 2, "experts": 4}
    with pdev.device_guard(device):
        model = chip_smoke.moe_gpt(cfg)
    amp.decorate(model, level="O2")
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randint(0, 256, (2, 64))).to(device)
    y = torch.from_numpy(rs.randint(0, 256, (2, 64))).to(device)
    return model, x, y


def _moe_step(model, k=5):
    from paddle_tpu_torch import amp, incubate, optimizer

    opt = incubate.LookAhead(optimizer.AdamW(model.parameters(), lr=1e-3),
                             alpha=0.5, k=k)

    def step(ids, labels):
        with amp.auto_cast(dtype="bfloat16", level="O2"):
            loss = model(ids, labels)
        loss = loss + 0.01 * model.aux_loss()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return opt, step


@pytest.mark.cuda
def test_pylayer_and_moe_captured_step_equals_eager(cuda_device):
    """A step with a PyLayer GeLU and an MoELayer (GShard, random routing
    on: the draws are device ops, the same in both runs) captured by
    to_static gives the eager step's losses, and the dropped-token count
    lives on the device."""
    from paddle_tpu_torch import jit, rng

    losses = {}
    for compiled in (False, True):
        model, x, y = _moe_model(cuda_device)
        rng.seed(0)
        _, step = _moe_step(model)
        if compiled:
            step = jit.to_static(step)
        losses[compiled] = [float(step(x, y)) for _ in range(4)]
        moe = model.moe_layers()[0]
        assert moe.dropped_tokens.is_cuda
    if compiled:
        assert step.captures == 1
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[True],
                                                  losses[False]))
    assert rel <= chip_smoke.MOE_LOSS_TOLERANCE, losses


@pytest.mark.cuda
def test_lookahead_syncs_inside_a_graph_at_multiples_of_k(cuda_device):
    """11 replays of a captured LookAhead(AdamW) step (k = 3): the slow
    weights equal the fast f32 masters after steps 3, 6 and 9 only."""
    from paddle_tpu_torch import jit

    model, x, y = _moe_model(cuda_device)
    opt, step = _moe_step(model, k=3)
    step = jit.to_static(step)
    met = []
    for _ in range(11):
        step(x, y)
        gap = max(float((opt.state[p]["slow"] - opt.inner_optimizer.state[p][
            "master_weight"]).abs().max()) for p in model.parameters())
        met.append(gap == 0.0)
    assert step.captures == 1
    assert [i + 1 for i, m in enumerate(met) if m] == [3, 6, 9]


@pytest.mark.cuda
def test_nan_check_in_a_captured_step(cuda_device):
    """FLAGS_check_nan_inf captures a program of its own whose replay
    raises naming an op once an embedding row is inf, with no host read
    inside the capture; with the flag off the plain program replays."""
    from paddle_tpu_torch import flags, jit

    model, x, y = _moe_model(cuda_device)
    _, step = _moe_step(model)
    step = jit.to_static(step)
    for _ in range(3):
        step(x, y)
    flags.set_flags({"FLAGS_check_nan_inf": True})
    try:
        for _ in range(3):
            assert torch.isfinite(step(x, y))
        assert step.captures == 2 and len(step.program_cache) == 2
        prog = step.last_program()
        assert prog.nan_check is not None and prog.nan_check.names
        with torch.no_grad():
            model.emb.weight[int(x[0, 0])] = float("inf")
        with pytest.raises(FloatingPointError, match="Operator embedding"):
            step(x, y)
    finally:
        flags.set_flags({"FLAGS_check_nan_inf": False})
    assert flags._mode is None
    step(x, y)                          # the unscanned program: no raise


@pytest.mark.cuda
def test_sync_batch_norm_world_of_one_is_batch_norm(cuda_device):
    """On a world of one (and without one) SyncBatchNorm is BatchNorm,
    bitwise, in training and evaluation."""
    import torch.distributed as dist

    from paddle_tpu_torch import device as pdev, nn
    from paddle_tpu_torch.distributed import mesh

    x = torch.randn(8, 4, 5, 5, device=cuda_device,
                    generator=torch.Generator("cuda").manual_seed(0))
    had = dist.is_initialized()
    if not had:
        mesh.ensure_world(torch.device("cpu"))
    try:
        with pdev.device_guard(cuda_device):
            a, b = nn.SyncBatchNorm(4), nn.BatchNorm2D(4)
        for train in (True, False):
            a.train(train)
            b.train(train)
            assert torch.equal(a(x), b(x))
        assert torch.equal(a._mean, b._mean)
        assert torch.equal(a._variance, b._variance)
    finally:
        if not had and dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.cuda
def test_samplers_and_segment_ops_refuse_a_capture(cuda_device):
    """The host-side samplers raise CaptureError inside a CUDA graph
    capture, as the segment ops do."""
    from paddle_tpu_torch import incubate, jit

    row = torch.tensor([1, 2, 3, 0], device=cuda_device)
    colptr = torch.tensor([0, 2, 3, 4, 4], device=cuda_device)
    nodes = torch.tensor([0, 1], device=cuda_device)

    def sample(r, c, n):
        return incubate.graph_sample_neighbors(r, c, n)[0] + 0

    prog = jit.to_static(sample)
    assert prog(row, colptr, nodes).tolist() == [1, 2, 3]
    with pytest.raises(jit.CaptureError, match="graph_sample_neighbors"):
        prog(row, colptr, nodes)


def _scan_indices(batch, spatial, nnz, seed):
    rs = np.random.RandomState(seed)
    flat = rs.choice(batch * int(np.prod(spatial)), nnz, replace=False)
    return np.stack(np.unravel_index(flat, (batch,) + spatial)).astype(
        np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [(3, 1, 1, True), (3, 2, 1, False),
                                    ((3, 1, 1), (2, 1, 1), 0, False),
                                    (2, 2, 0, False)])
def test_sparse_rulebook_on_the_card_equals_the_cpu(cuda_device, window):
    """A random scan's rulebook built on the card: output sites, spatial
    shape, pairs and counts equal the CPU's, with one host sync (its
    sizes), counted by torch's sync debug mode."""
    import warnings

    from paddle_tpu_torch.sparse import nn as snn

    k, s, p, subm = window
    idx = torch.from_numpy(_scan_indices(2, (41, 160, 140), 20000, 3))
    want = snn.build_rulebook(idx, (41, 160, 140), k, s, p, subm)
    dev_idx = idx.to(cuda_device)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = snn.build_rulebook(dev_idx, (41, 160, 140), k, s, p, subm)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if str(w.message).startswith(
        "called a synchronizing CUDA operation")]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert got.out_spatial == want.out_spatial
    assert got.counts == want.counts
    for name in ("out_indices", "in_rows", "out_rows"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))


@pytest.mark.cuda
def test_sparse_conv_stack_on_the_card_matches_the_cpu(cuda_device):
    """SubmConv3D → BatchNorm → ReLU → strided Conv3D → MaxPool3D on the
    card and the CPU from the same weights: sites equal, values and
    gradients within 1e-4 of their largest magnitude.  The first
    convolution has no bias, as before a batch norm in SECOND: its
    gradient would be zero in exact arithmetic, rounding noise here."""
    from paddle_tpu_torch import nn, sparse
    from paddle_tpu_torch.device import device_guard

    def build():
        S = sparse.nn
        return nn.Sequential(S.SubmConv3D(4, 16, 3, padding=1,
                                          bias_attr=False),
                             S.BatchNorm(16), S.ReLU(),
                             S.Conv3D(16, 32, 3, stride=2, padding=1),
                             S.MaxPool3D(2, stride=2))

    torch.manual_seed(0)
    with device_guard("cpu"):
        ref = build()
    with device_guard(cuda_device):
        net = build()
    net.load_state_dict(ref.state_dict())
    idx = _scan_indices(2, (21, 64, 64), 6000, 4)
    vals = np.random.RandomState(4).randn(6000, 4).astype(np.float32)
    outs = []
    for model, dev in ((ref, "cpu"), (net, cuda_device)):
        x = sparse.SparseCooTensor(torch.from_numpy(idx).to(dev),
                                   torch.tensor(vals, device=dev,
                                                requires_grad=True),
                                   (2, 21, 64, 64, 4))
        out = model(x)
        out.values().square().sum().backward()
        outs.append((out.indices().cpu(), out.values().detach().cpu(),
                     x.values().grad.cpu(),
                     [q.grad.cpu() for q in model.parameters()]))
    (i0, v0, g0, p0), (i1, v1, g1, p1) = outs
    assert torch.equal(i0, i1)
    for a, b in [(v1, v0), (g1, g0)] + list(zip(p1, p0)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_sparse_matmul_and_masked_matmul_on_the_card(cuda_device):
    from paddle_tpu_torch import sparse

    rs = np.random.RandomState(5)
    flat = rs.choice(300 * 200, 3000, replace=False)
    idx = np.stack(np.unravel_index(flat, (300, 200)))
    vals = rs.randn(3000).astype(np.float32)
    dense = rs.randn(200, 64).astype(np.float32)
    a, b = rs.randn(300, 32).astype(np.float32), \
        rs.randn(32, 200).astype(np.float32)
    res = []
    for dev in ("cpu", cuda_device):
        x = sparse.sparse_coo_tensor(torch.from_numpy(idx),
                                     torch.tensor(vals, device=dev),
                                     (300, 200), stop_gradient=False)
        d = torch.tensor(dense, device=dev, requires_grad=True)
        out = sparse.matmul(x.to_sparse_csr(), d)
        out.square().sum().backward()
        m = sparse.masked_matmul(torch.tensor(a, device=dev),
                                 torch.tensor(b, device=dev),
                                 x.to_sparse_csr())
        res.append([out.detach().cpu(), d.grad.cpu(),
                    m.crows().cpu(), m.cols().cpu(), m.values().cpu()])
    (o0, d0, c0, k0, m0), (o1, d1, c1, k1, m1) = res
    assert torch.equal(c0, c1) and torch.equal(k0, k1)
    for got, want in ((o1, o0), (d1, d0), (m1, m0)):
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_stft_istft_on_the_card(cuda_device):
    from paddle_tpu_torch import signal

    x = torch.from_numpy(np.random.RandomState(6).randn(4, 32000)
                         .astype(np.float32))
    w = torch.hann_window(400)
    spec = signal.stft(x, 400, hop_length=160, window=w)
    got = signal.stft(x.to(cuda_device), 400, hop_length=160,
                      window=w.to(cuda_device))
    assert got.shape == spec.shape == (4, 201, 201)
    assert float((got.cpu() - spec).abs().max()) <= \
        1e-4 * float(spec.abs().max())
    back = signal.istft(got, 400, hop_length=160, window=w.to(cuda_device),
                        length=32000)
    assert float((back.cpu() - x).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_normal_rsample_in_a_captured_graph_draws_afresh(cuda_device):
    from paddle_tpu_torch import distribution as D, jit, rng

    loc = torch.zeros(2, device=cuda_device)
    scale = torch.ones(2, device=cuda_device)
    f = jit.to_static(lambda a, b: D.Normal(a, b).rsample((4096,)))
    gen = rng.default_generator(loc.device)
    start = int(gen.get_state()[1])
    draws = [f(loc, scale) for _ in range(4)]
    assert f.captures == 1
    assert int(gen.get_state()[1]) == start + 4
    assert not torch.equal(draws[2], draws[3])
    rng.seed(11)
    eager = D.Normal(loc, scale).rsample((4096,))
    rng.seed(11)
    assert torch.equal(f(loc, scale), eager)


# -- the static program mode and the extension points -------------------------

def _attention_program(dev, B=2, S=128, H=4, D=64):
    """A program of one causal self-attention block (qkv projection,
    ``flash_attention``, output projection) recorded on ``dev``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.attention import flash_attention as fa

    torch.manual_seed(0)
    qkv = torch.nn.Linear(H * D, 3 * H * D, device=dev)
    out = torch.nn.Linear(H * D, H * D, device=dev)

    def block(x):
        q, k, v = qkv(x).view(B, S, H, 3 * D).split(D, dim=-1)
        return out(fa(q, k, v, is_causal=True).reshape(B, S, H * D))

    pt.enable_static()
    try:
        main = static.Program()
        with pt.device_guard(dev), static.program_guard(main):
            x = static.data("x", [B, S, H * D], "float32")
            y = block(x)
    finally:
        pt.disable_static()
    return main, y, block


@pytest.mark.cuda
def test_static_program_with_attention_replays_each_feed(cuda_device):
    """Two feeds through the recorded program (its eager call, its
    capture, replays) equal the eager block on each; K1 launches."""
    from paddle_tpu_torch import static

    main, y, block = _attention_program(cuda_device)
    assert "flash_attention" in [o.name for o in main.ops]
    exe = static.Executor()
    rs = np.random.RandomState(0)
    feeds = [rs.randn(2, 128, 256).astype(np.float32) for _ in range(2)]
    with torch.no_grad():
        wants = [block(torch.from_numpy(a).to(cuda_device)).cpu().numpy()
                 for a in feeds]
    kernels.reset_launches()
    for a, want in zip(feeds + feeds, wants + wants):
        got, = exe.run(main, feed={"x": a}, fetch_list=[y])
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert kernels.launch_counts()["flash_fwd"] == 4
    fn, = main._cache.values()
    assert fn.captures == 1


@pytest.mark.cuda
def test_profiler_device_table_names_the_flash_kernels(cuda_device,
                                                       tmp_path):
    from paddle_tpu_torch import profiler

    q, k, v = (torch.randn(2, 256, 4, 64, device=cuda_device,
                           requires_grad=True) for _ in range(3))
    p = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
        scheduler=profiler.make_scheduler(closed=0, ready=1, record=2,
                                          repeat=1),
        on_trace_ready=profiler.export_chrome_tracing(str(tmp_path)))
    p.start()
    for _ in range(3):
        with profiler.RecordEvent("attn_step"):
            flash_attention(q, k, v, is_causal=True).sum().backward()
            torch.cuda.synchronize()
        p.step()
    p.stop()
    stats = p.statistic_data()
    assert stats.host["attn_step"].call == 2
    assert chip_smoke.static_kernel_calls(stats) == {
        "flash_fwd": 2, "flash_bwd_dkv": 2, "flash_bwd_dq": 2}
    assert 0 < stats.device_busy_us <= stats.wall_us


@pytest.mark.cuda
def test_register_kernel_backend_scope_on_the_card(cuda_device):
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.utils import register_kernel, unregister_kernel

    x = torch.tensor([-1.0, 5.0])
    try:
        register_kernel("relu", lambda t, name=None: t * 0.0 + 42.0,
                        backend="gpu")
        assert F.relu(x.to(cuda_device)).tolist() == [42.0, 42.0]
        assert F.relu(x).tolist() == [0.0, 5.0]
        compiled = jit.to_static(lambda t: F.relu(t) + 1.0)
        for _ in range(3):                  # eager, capture, replay
            assert compiled(x.to(cuda_device)).tolist() == [43.0, 43.0]
    finally:
        unregister_kernel("relu", backend="gpu")
    assert F.relu(x.to(cuda_device)).tolist() == [0.0, 5.0]


@pytest.mark.cuda
def test_cpp_extension_on_the_card_and_refused_in_a_capture(cuda_device,
                                                            tmp_path):
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.utils import cpp_extension

    src = tmp_path / "my_ops.cc"
    src.write_text(chip_smoke.custom_kernel_cpp_src())
    ext = cpp_extension.load("card_ops", [str(src)],
                             functions={"softsign_ref": {},
                                        "twice_plus_one": {}},
                             build_directory=str(tmp_path))
    v = torch.randn(1000, device=cuda_device)
    got = ext.softsign_ref(v)
    assert got.device.type == "cuda"
    assert float((got - F.softsign(v)).abs().max()) <= 1e-6
    f = jit.to_static(lambda t: ext.twice_plus_one(t) + 0.0)
    assert float((f(v) - (2 * v + 1)).abs().max()) == 0.0   # eager call
    with pytest.raises(jit.CaptureError, match="card_ops.twice_plus_one"):
        f(v)                                                # its capture
    # a later draw still works (the failed capture was ended)
    torch.randn(4, device=cuda_device).sum().item()


# -- the f32 K1 and K2 on tensor cores (3xTF32 on wgmma) ----------------------

#: (S, causal, D, layout, p): ragged S (130, 1000) and one part tile (16)
#: at both masks and head dims; q/k/v as views of one fused [B, S, H, 3D]
#: projection, as rows of D + 1 floats (not 16-byte aligned: the kernels'
#: 4-byte copies), and at p 0.1 on one draw
F32_TC_CASES = [(S, causal, D, "separate", 0.0) for S in (16, 130, 1000)
                for causal in (True, False) for D in (64, 128)] + [
    (130, True, 64, "fused", 0.0), (1000, True, 128, "fused", 0.0),
    (130, False, 64, "odd", 0.0), (1000, True, 128, "odd", 0.0),
    (1000, True, 64, "fused", 0.1), (130, False, 128, "separate", 0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,causal,D,layout,p", F32_TC_CASES)
def test_f32_flash_fwd_and_dkv_on_tensor_cores_match_plain(
        cuda_device, S, causal, D, layout, p):
    """The f32 K1 and K2 against their plain versions: O within 1e-4 (on
    O's scale 1/(1-p) under dropout), lse 1e-3, dK and dV 1e-4 of the
    largest; two calls on the same inputs agree bitwise, and each launch
    counts under its instance."""
    from paddle_tpu_torch.ops.attention import _flash_fwd_reference

    g = torch.Generator(device=cuda_device).manual_seed(29)

    def rand(width):
        return torch.randn((2, S, 3, width), generator=g, device=cuda_device)

    if layout == "fused":
        q, k, v = rand(3 * D).split(D, dim=-1)
    elif layout == "odd":
        q, k, v = (rand(D + 1)[..., :D] for _ in range(3))
    else:
        q, k, v = (rand(D) for _ in range(3))
    do = rand(D)
    snap = _snap(cuda_device) if p else None
    kernels.reset_launches()
    o, lse = kernels.flash_fwd(q, k, v, causal, p, snap)
    o2, lse2 = kernels.flash_fwd(q, k, v, causal, p, snap)
    o_ref, lse_ref = _flash_fwd_reference(q, k, v, causal, p, snap)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert (o - o_ref).abs().max().item() <= 1e-4 / (1 - p)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    delta = (do * o_ref).sum(-1).transpose(1, 2).contiguous().view(-1, S)
    args = (q, k, v, do, lse_ref, delta, causal, p, snap)
    got, again = kernels.flash_bwd_dkv(*args), kernels.flash_bwd_dkv(*args)
    for a, b, want in zip(got, again, _flash_bwd_dkv_reference(*args)):
        assert torch.equal(a, b)
        assert (a - want).abs().max().item() <= \
            1e-4 * want.abs().max().item()
    sfx = "_dropout" if p else ""
    assert {n: c for n, c in kernels.launch_counts().items() if c} == {
        f"flash_fwd{sfx}": 2, f"flash_bwd_dkv{sfx}": 2}
