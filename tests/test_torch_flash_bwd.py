"""The port's flash-attention backward against the JAX package's, on the
CPU.

The JAX side runs the Pallas kernels in interpret mode with 8-row blocks:
``_bwd`` (K2 and K3) for the plain backward versions, and ``jax.vjp`` of
the ``_flash`` custom_vjp (K1 forward, K2/K3 backward) for the gradients
of the port's ``flash_attention``.  q, k and v are strided views of one
fused ``[B, S, H, 3*D]`` projection, as in the GPT model.  Tolerance:
1e-5 absolute in f32 (the same sums in other orders; measured ~7e-7); in
bf16, 2e-2 of each gradient's largest value (p and ds are rounded to bf16
at the same points on both sides, but an f32 sum in another order can put
a value on the other side of a bf16 rounding boundary); in f16, which
keeps three more mantissa bits, 5e-3 of the largest value, forward (K1's
plain version against ``_fwd``, p rounded to f16 before P V on both
sides) and backward.
K2/K3 themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas.flash_attention_kernel import _bwd, _flash, _fwd
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.attention import (
    _flash_bwd_dkv_reference, _flash_bwd_dq_reference, flash_attention,
)

torch.set_num_threads(2)

F32_TOL = 1e-5
B, S, H, D = 2, 16, 2, 16


def _inputs(seed):
    rs = np.random.RandomState(seed)
    qkv = rs.randn(B, S, H, 3 * D).astype(np.float32)
    do = rs.randn(B, S, H, D).astype(np.float32)
    return qkv, do


def _to_bh(x):
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, S, D)


def _from_bh(x):
    return np.asarray(x).reshape(B, H, S, D).transpose(0, 2, 1, 3)


def _split(qkv):
    return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]


BF16_REL_TOL = 2e-2
F16_REL_TOL = 5e-3
REL_TOL = {"bfloat16": BF16_REL_TOL, "float16": F16_REL_TOL}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_pallas_bwd(causal, dtype):
    """``_flash_bwd_dkv_reference`` / ``_flash_bwd_dq_reference`` against
    ``_bwd``, fed the Pallas forward's O and lse, with delta formed as the
    autograd Function forms it (``[B*H, S]``, row ``b*H + h``).  In bf16
    both sides get the same seeded inputs rounded to bf16: this pins the
    rounding points of p and ds that the card's K2/K3 share with Pallas;
    so in f16."""
    qkv, do = _inputs(0)
    if dtype != "float32":
        qkv = np.asarray(jnp.asarray(qkv, dtype))
        do = np.asarray(jnp.asarray(do, dtype))
    q, k, v = _split(qkv)
    o, lse = _fwd(_to_bh(q), _to_bh(k), _to_bh(v), scale=D ** -0.5,
                  causal=causal, block_q=8, block_k=8, interpret=True)
    dq, dk, dv = _bwd((_to_bh(q), _to_bh(k), _to_bh(v), o, lse), _to_bh(do),
                      scale=D ** -0.5, causal=causal, block_q=8, block_k=8,
                      interpret=True)
    tdt = getattr(torch, dtype)
    tqkv = torch.from_numpy(qkv.astype(np.float32)).to(tdt)
    tq, tk, tv = tqkv.split(D, dim=-1)             # strided views
    tdo = torch.from_numpy(do.astype(np.float32)).to(tdt)
    to = torch.from_numpy(_from_bh(o).astype(np.float32)).to(tdt)
    tlse = torch.from_numpy(np.array(lse))
    delta = (tdo.float() * to.float()).sum(-1).transpose(1, 2) \
        .contiguous().view(B * H, S)
    rk, rv = _flash_bwd_dkv_reference(tq, tk, tv, tdo, tlse, delta, causal)
    rq = _flash_bwd_dq_reference(tq, tk, tv, tdo, tlse, delta, causal)
    for got, want in ((rq, dq), (rk, dk), (rv, dv)):
        assert got.dtype == tdt
        want = _from_bh(want).astype(np.float32)
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
        else:
            assert np.abs(got - want).max() <= \
                REL_TOL[dtype] * np.abs(want).max()


@pytest.mark.parametrize("causal", [True, False])
def test_f16_plain_forward_matches_pallas_fwd(causal):
    """K1's plain version at f16 (``_flash_fwd_reference``: p rounded to
    f16 before P V, the sums f32) against ``_fwd`` in interpret mode on
    the same f16 inputs: O in f16 and the f32 lse."""
    from paddle_tpu_torch.ops.attention import _flash_fwd_reference

    qkv, _ = _inputs(3)
    qkv = np.asarray(jnp.asarray(qkv, jnp.float16))
    q, k, v = _split(qkv)
    o, lse = _fwd(_to_bh(q), _to_bh(k), _to_bh(v), scale=D ** -0.5,
                  causal=causal, block_q=8, block_k=8, interpret=True)
    assert o.dtype == jnp.float16
    tq, tk, tv = torch.from_numpy(qkv.copy()).split(D, dim=-1)
    to, tlse = _flash_fwd_reference(tq, tk, tv, causal)
    assert to.dtype == torch.float16
    want = _from_bh(o).astype(np.float32)
    assert np.abs(to.float().numpy() - want).max() <= \
        F16_REL_TOL * np.abs(want).max()
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse), rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_f16_flash_attention_grads_match_flash_vjp(causal):
    """At f16, the port's ``flash_attention`` (K1-K3's plain versions on
    CPU tensors) against ``jax.vjp`` of ``_flash`` in interpret mode: O
    and dQ/dK/dV, each in f16, to 5e-3 of its largest value."""
    qkv, do = _inputs(4)
    qkv = np.asarray(jnp.asarray(qkv, jnp.float16))
    do = np.asarray(jnp.asarray(do, jnp.float16))
    q, k, v = _split(qkv)
    o, vjp = jax.vjp(lambda a, b, c: _flash(a, b, c, causal, 8, 8, True),
                     _to_bh(q), _to_bh(k), _to_bh(v))
    grads = vjp(_to_bh(do))
    assert all(g.dtype == jnp.float16 for g in grads)
    t = torch.from_numpy(qkv).requires_grad_()
    out = flash_attention(*t.split(D, dim=-1), is_causal=causal)
    out.backward(torch.from_numpy(do))
    assert out.dtype == t.grad.dtype == torch.float16
    for got, want in ((out.detach(), o),
                      *zip(t.grad.split(D, dim=-1), grads)):
        want = _from_bh(want).astype(np.float32)
        assert np.abs(got.float().numpy() - want).max() <= \
            F16_REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grads_match_flash_vjp(causal):
    """Output and dQ/dK/dV of the port's autograd Function (plain versions
    on CPU tensors) against ``jax.vjp`` of ``_flash``."""
    qkv, do = _inputs(1)
    q, k, v = _split(qkv)
    o, vjp = jax.vjp(lambda a, b, c: _flash(a, b, c, causal, 8, 8, True),
                     _to_bh(q), _to_bh(k), _to_bh(v))
    dq, dk, dv = vjp(_to_bh(do))
    t = torch.from_numpy(qkv).requires_grad_()
    out = flash_attention(*t.split(D, dim=-1), is_causal=causal)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), _from_bh(o), rtol=0,
                               atol=F32_TOL)
    g = t.grad.numpy()
    for part, want in zip(_split(g), (dq, dk, dv)):
        np.testing.assert_allclose(part, _from_bh(want), rtol=0,
                                   atol=F32_TOL)


def test_reference_choice_runs_the_same_function():
    """``kernel="reference"`` is the plain path on any device; on CPU
    tensors ``kernel="cuda"`` takes it too, so the two agree exactly."""
    qkv, do = _inputs(2)
    grads = []
    for kernel in ("cuda", "reference"):
        t = torch.from_numpy(qkv).requires_grad_()
        flash_attention(*t.split(D, dim=-1), is_causal=True,
                        kernel=kernel).backward(torch.from_numpy(do))
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])


def test_no_grad_saves_nothing():
    x = torch.randn(1, 8, 2, 16, requires_grad=True)
    with torch.no_grad():
        out = flash_attention(x, x, x, is_causal=True)
    assert out.grad_fn is None
    assert flash_attention(x, x, x, is_causal=True).grad_fn is not None


def test_dropout_and_unknown_kernel_raise():
    """Attention dropout, refused before it was ported, runs (its law and
    gradients are held in test_torch_dropout.py); a rate outside [0, 1]
    and an unknown kernel raise."""
    x = torch.ones(1, 8, 2, 16)
    out = flash_attention(x, x, x, is_causal=True, dropout_p=0.1)
    assert out.shape == x.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="dropout"):
        flash_attention(x, x, x, is_causal=True, dropout_p=1.5)
    with pytest.raises(ValueError, match="kernel"):
        flash_attention(x, x, x, kernel="triton")


def test_attention_mask_is_refused():
    """A mask, refused before it was ported, runs on the JAX package's
    route for it (the plain attention, autograd through it): an all-True
    bool mask and a zero additive mask give the unmasked full attention,
    forward and gradients (its parity with the JAX route is held in
    test_torch_attention.py)."""
    qkv, do = _inputs(5)
    outs = []
    for mask in (None, torch.ones(S, S, dtype=torch.bool),
                 torch.zeros(B, 1, S, S)):
        t = torch.from_numpy(qkv).requires_grad_()
        out = flash_attention(*t.split(D, dim=-1), attn_mask=mask)
        out.backward(torch.from_numpy(do))
        outs.append((out.detach(), t.grad))
    for out, grad in outs[1:]:
        torch.testing.assert_close(out, outs[0][0], rtol=0, atol=F32_TOL)
        torch.testing.assert_close(grad, outs[0][1], rtol=0, atol=F32_TOL)


def test_backward_wrappers_refuse_cpu_tensors():
    """K2/K3's wrappers take CUDA tensors only: no quiet CPU fallback."""
    x = torch.zeros(1, 8, 2, 64)
    rows = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flash_bwd_dkv(x, x, x, x, rows, rows)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flash_bwd_dq(x, x, x, x, rows, rows)
    assert kernels.KERNELS["flash_bwd_dkv"].launches == 0
    assert kernels.KERNELS["flash_bwd_dq"].launches == 0
