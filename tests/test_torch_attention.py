"""The port's attention ops against the JAX package's, on the CPU.

Inputs come from seeded numpy and go through both packages.  The JAX side
runs the Pallas kernels in interpret mode (as tests/test_paged_kernel.py
does) and its jnp oracles; the port side runs the same public functions,
which for CPU tensors take the kernels' plain PyTorch versions.
Tolerance: 1e-5 absolute in f32 (two f32 implementations of the same
sums in different orders differ by ~1e-6 here).

The CUDA kernels are held against their plain versions on a card in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas.flash_attention_kernel import (
    _fwd, flash_attention_fused,
)
from paddle_tpu.ops.pallas.paged_attention_kernel import (
    paged_decode_attention_kernel, paged_prefill_attention_kernel,
)
from paddle_tpu_torch.ops import cached_attention as ca
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.attention import _sdpa_reference, flash_attention

torch.set_num_threads(2)

F32_TOL = 1e-5


def _pool(rs, nb, bs, hkv, d):
    return (rs.randn(nb, bs, hkv, d).astype(np.float32),
            rs.randn(nb, bs, hkv, d).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- K4: paged decode --------------------------------------------------------

@pytest.mark.parametrize("hkv,h", [(4, 4), (2, 4)])      # MHA and GQA
def test_paged_decode_matches_pallas(hkv, h):
    """Lengths 0, a partly filled second block, and windows spanning
    several blocks of a block size 8 table."""
    rs = np.random.RandomState(0)
    NB, BS, D, B, MB = 13, 8, 16, 4, 4
    kp, vp = _pool(rs, NB, BS, hkv, D)
    tbl = rs.randint(1, NB, (B, MB)).astype(np.int32)
    lens = np.array([0, 7, 18, 31], np.int32)
    q = rs.randn(B, 1, h, D).astype(np.float32)
    ref = paged_decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(lens), interpret=True)
    out = ca.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tbl),
                                    _t(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=F32_TOL)


def test_paged_decode_reads_a_strided_layer_view():
    """The engine hands the ops one layer of the multi-layer pool, a
    strided view; the result equals the same data laid out contiguous."""
    rs = np.random.RandomState(5)
    pool = torch.from_numpy(rs.randn(9, 3, 8, 2, 16).astype(np.float32))
    vpool = torch.from_numpy(rs.randn(9, 3, 8, 2, 16).astype(np.float32))
    tbl = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    lens = torch.tensor([5, 20], dtype=torch.int32)
    q = torch.from_numpy(rs.randn(2, 1, 4, 16).astype(np.float32))
    a = ca.paged_decode_attention(q, pool[:, 1], vpool[:, 1], tbl, lens)
    b = ca.paged_decode_attention(q, pool[:, 1].contiguous(),
                                  vpool[:, 1].contiguous(), tbl, lens)
    assert torch.equal(a, b)


def test_paged_decode_positions_past_length_are_invisible():
    rs = np.random.RandomState(1)
    NB, BS, Hkv, D = 9, 8, 2, 8
    kp, vp = _pool(rs, NB, BS, Hkv, D)
    tbl = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    lens = np.array([4, 11], np.int32)
    q = _t(rs.randn(2, 1, 4, D).astype(np.float32))
    out = ca.paged_decode_attention(q, _t(kp), _t(vp), _t(tbl), _t(lens))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[1, 5:], vp2[1, 5:] = 999.0, -999.0
    kp2[[2, 3]], vp2[[2, 3]] = 999.0, -999.0
    out2 = ca.paged_decode_attention(q, _t(kp2), _t(vp2), _t(tbl), _t(lens))
    assert torch.equal(out[0], out2[0])


def test_cached_attention_matches_jax_oracle():
    from paddle_tpu import to_tensor
    from paddle_tpu.ops.cached_attention import cached_attention

    rs = np.random.RandomState(6)
    q = rs.randn(3, 1, 4, 8).astype(np.float32)
    k = rs.randn(3, 20, 2, 8).astype(np.float32)
    v = rs.randn(3, 20, 2, 8).astype(np.float32)
    lens = np.array([0, 9, 19], np.int32)
    ref = cached_attention(to_tensor(q), to_tensor(k), to_tensor(v),
                           to_tensor(lens)).numpy()
    out = ca.cached_attention(_t(q), _t(k), _t(v), _t(lens))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=F32_TOL)


# -- K5: paged prefill -------------------------------------------------------

@pytest.mark.parametrize("hkv,h", [(4, 4), (2, 4)])
@pytest.mark.parametrize("start", [0, 16, 80])
def test_paged_prefill_matches_pallas(hkv, h, start):
    """With and without a cached prefix (start > 0 puts shared blocks under
    the cross-attention half of the mask), 16-query tails.  start 80 is a
    multiple of 16 but not of 64, as the card's 64-query tiles meet it."""
    rs = np.random.RandomState(3)
    NB, BS, D, MB, S = 17, 8, 16, 12, 16
    kp, vp = _pool(rs, NB, BS, hkv, D)
    row = rs.randint(1, NB, (MB,)).astype(np.int32)
    q = rs.randn(1, S, h, D).astype(np.float32)
    ref = paged_prefill_attention_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(row),
        start, interpret=True)
    out = ca.paged_prefill_attention(_t(q), _t(kp), _t(vp), _t(row),
                                     _t(np.array([start], np.int32)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=F32_TOL)


def test_paged_prefill_future_positions_are_invisible():
    rs = np.random.RandomState(4)
    NB, BS, Hkv, D, S, start = 7, 8, 2, 8, 8, 8
    kp, vp = _pool(rs, NB, BS, Hkv, D)
    row = np.array([1, 2, 3], np.int32)
    q = _t(rs.randn(1, S, 2, D).astype(np.float32))
    start = _t(np.array([start], np.int32))
    out = ca.paged_prefill_attention(q, _t(kp), _t(vp), _t(row), start)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[2, 1:], vp2[2, 1:] = 777.0, -777.0
    kp2[3], vp2[3] = 777.0, -777.0
    out2 = ca.paged_prefill_attention(q, _t(kp2), _t(vp2), _t(row), start)
    assert torch.equal(out[0, 0], out2[0, 0])


# -- K1: flash forward -------------------------------------------------------

@pytest.mark.parametrize("S,block", [(16, 8), (80, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(causal, S, block):
    """S 80 is not a multiple of 64: the card's last 64-query tile is
    ragged there (the Pallas blocks, 16, divide it)."""
    rs = np.random.RandomState(7)
    B, H, D = 2, 2, 16
    q, k, v = (rs.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    ref = flash_attention_fused(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, block_q=block,
                                block_k=block, interpret=True)
    out = flash_attention(_t(q), _t(k), _t(v), is_causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("S,block", [(16, 8), (80, 16)])
def test_flash_lse_matches_pallas_fwd(S, block):
    """The compact [B*H, S] lse the kernel emits (and the backward kernels
    read) against the Pallas forward's."""
    rs = np.random.RandomState(8)
    B, H, D = 2, 2, 16
    q, k, v = (rs.randn(B, S, H, D).astype(np.float32) for _ in range(3))

    def to_bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, S, D)

    o_ref, lse_ref = _fwd(to_bh(q), to_bh(k), to_bh(v), scale=D ** -0.5,
                          causal=True, block_q=block, block_k=block,
                          interpret=True)
    out, lse = _sdpa_reference(_t(q), _t(k), _t(v), True, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=0,
                               atol=F32_TOL)
    np.testing.assert_allclose(
        out.numpy(),
        np.asarray(o_ref).reshape(B, H, S, D).transpose(0, 2, 1, 3),
        rtol=0, atol=F32_TOL)


# -- the kernel wrappers take CUDA tensors only -----------------------------

def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback hides a device: a wrapper given CPU tensors raises
    instead of quietly running the plain version."""
    q = torch.zeros(1, 1, 2, 64)
    pool = torch.zeros(3, 4, 2, 64)
    tbl = torch.ones(1, 2, dtype=torch.int32)
    lens = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.paged_decode(q, pool, pool, tbl, lens)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.paged_prefill(q, pool, pool, tbl[0], lens)
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flash_fwd(x, x, x)
    assert all(k.launches == 0 for k in kernels.KERNELS.values())


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels._nvcc()


# -- attn_mask: the JAX package's route for a mask ----------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_masked_attention_matches_the_jax_route(kind, causal):
    """``flash_attention(attn_mask=)`` against ``paddle_tpu.ops.pallas.
    flash_attention`` with the same mask, whose route for a mask is its
    XLA oracle: a bool ``[B, 1, S, S]`` mask (False drops the score; key
    0 kept, so that no causal row is empty) and an additive f32
    ``[B, H, S, S]`` one, with and without ``is_causal``, at p 0.  The
    output and the gradients of q, k and v (of ``sum(out * dO)``) to
    1e-5."""
    import paddle_tpu as paddle
    from paddle_tpu.ops.pallas import flash_attention as jax_flash

    rs = np.random.RandomState(7)
    B, S, H, D = 2, 12, 2, 16
    q, k, v, do = (rs.randn(B, S, H, D).astype(np.float32)
                   for _ in range(4))
    if kind == "bool":
        mask = rs.rand(B, 1, S, S) > 0.3
        mask[..., 0] = True
    else:
        mask = (2.0 * rs.randn(B, H, S, S)).astype(np.float32)
    jq, jk, jv = (paddle.to_tensor(a, stop_gradient=False)
                  for a in (q, k, v))
    ref = jax_flash(jq, jk, jv, attn_mask=paddle.to_tensor(mask),
                    is_causal=causal)
    (ref * paddle.to_tensor(do)).sum().backward()
    tq, tk, tv = (torch.from_numpy(a.copy()).requires_grad_()
                  for a in (q, k, v))
    out = flash_attention(tq, tk, tv, is_causal=causal,
                          attn_mask=torch.from_numpy(mask))
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=0,
                               atol=F32_TOL)
    for got, want in ((tq, jq), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   rtol=0, atol=F32_TOL)


def test_masked_attention_with_dropout_draws_the_port_generator():
    """Under a mask, attention dropout draws one ``[seed, offset]`` from
    the port's generator and multiplies the masked probabilities by the
    kernels' keep factors: re-seeding the generator repeats the output,
    and the dropped probabilities are those of ``rng.attention_dropout_
    factor`` of the draw."""
    from paddle_tpu_torch import rng

    rs = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rs.randn(1, 16, 2, 16).astype(np.float32))
               for _ in range(3))
    mask = torch.from_numpy(rs.rand(1, 1, 16, 16) > 0.2)
    outs = []
    for _ in range(2):
        rng.seed(3)
        snap = rng.default_generator("cpu").get_state().clone()
        outs.append(flash_attention(q, k, v, is_causal=True, dropout_p=0.3,
                                    attn_mask=mask))
    assert torch.equal(outs[0], outs[1])
    want = _sdpa_reference(q, k, v, True, False, 0.3, snap, mask)
    np.testing.assert_allclose(outs[0].numpy(), want.numpy(), rtol=0,
                               atol=F32_TOL)
