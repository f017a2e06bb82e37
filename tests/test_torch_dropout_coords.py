"""Attention dropout at a rank's coordinates: the plain versions of K1-K3
on a slice of the batch and heads draw the slice of the whole tensors'
draw.

A rank holding samples ``b0..`` and heads ``h0..`` of ``H`` draws with
``rng.with_coordinates`` (``[seed, offset, batch_start, head_start,
heads_total]``); the dropout instances of K1-K3 take that draw on the
card (``kernels._dropout_args``), their plain versions here.  Each
quarter of a ``[4, 32, 4, 16]`` problem (2 batch halves x 2 head halves)
is held to the matching slice of the whole problem on one draw: the keep
factors exactly, the outputs and gradients within ``1e-6`` (the sums of
one head row run alone or beside the others).  The dropout bits are the
port's own Philox words (ROADMAP C, departures), so there is no JAX side
to hold them to.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import rng
from paddle_tpu_torch.ops import attention as att
from paddle_tpu_torch.ops import kernels

B, S, H, D, P = 4, 32, 4, 16, 0.25
SNAP = torch.tensor([1234, 5], dtype=torch.int64)
QUARTERS = [(bi, hi) for bi in range(2) for hi in range(2)]


def _problem():
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(B, S, H, D, generator=g) for _ in range(4))
    o, lse = att._flash_fwd_reference(q, k, v, True, P, SNAP)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous().view(B * H, S)
    return q, k, v, do, o, lse, delta


def _quarter(bi, hi):
    b_, h_ = B // 2, H // 2
    with rng.shard_coordinates(batch_start=bi * b_, head_start=hi * h_,
                               heads_total=H):
        draw = rng.with_coordinates(SNAP, h_)
    return slice(bi * b_, (bi + 1) * b_), slice(hi * h_, (hi + 1) * h_), draw


def _rows(t, bs, hs):
    return t.view(B, H, S)[bs, hs].reshape(-1, S).contiguous()


@pytest.mark.parametrize("bi,hi", QUARTERS)
def test_keep_factors_are_the_whole_draws_slice(bi, hi):
    whole = rng.attention_dropout_factor(SNAP, B * H, S, S, P, heads=H) \
        .view(B, H, S, S)
    bs, hs, draw = _quarter(bi, hi)
    assert draw.tolist() == [1234, 5, bi * 2, hi * 2, H]
    part = rng.attention_dropout_factor(draw, 4, S, S, P, heads=2)
    assert torch.equal(part.view(2, 2, S, S), whole[bs, hs])


@pytest.mark.parametrize("bi,hi", QUARTERS)
def test_plain_kernels_at_coordinates_match_the_whole(bi, hi):
    q, k, v, do, o, lse, delta = _problem()
    bs, hs, draw = _quarter(bi, hi)
    part = [t[bs, :, hs] for t in (q, k, v, do)]
    rows = [_rows(t, bs, hs) for t in (lse, delta)]
    o_p, lse_p = att._flash_fwd_reference(*part[:3], True, P, draw)
    np.testing.assert_allclose(o_p.numpy(), o[bs, :, hs].numpy(), atol=1e-6)
    np.testing.assert_allclose(lse_p.numpy(), rows[0].numpy(), atol=1e-6)
    args = (*part, *rows, True, P)
    dk, dv = att._flash_bwd_dkv_reference(*args, draw)
    dq = att._flash_bwd_dq_reference(*args, draw)
    wargs = (q, k, v, do, lse, delta, True, P, SNAP)
    wdk, wdv = att._flash_bwd_dkv_reference(*wargs)
    wdq = att._flash_bwd_dq_reference(*wargs)
    for got, want in ((dk, wdk), (dv, wdv), (dq, wdq)):
        np.testing.assert_allclose(got.numpy(), want[bs, :, hs].numpy(),
                                   atol=1e-6)


def test_flash_attention_draws_at_the_shards_coordinates():
    """Through ``flash_attention`` and its autograd: a head shard under
    ``shard_coordinates`` equals the whole call's heads, values and
    gradients, on the same generator draw."""
    q, k, v, do, *_ = _problem()
    gen = rng.Generator("cpu", seed=9)
    qw = q.clone().requires_grad_()
    whole = att.flash_attention(qw, k, v, is_causal=True, dropout_p=P,
                                generator=gen)
    (whole * do).sum().backward()
    gen.manual_seed(9)
    qs = q[:, :, 2:].clone().requires_grad_()
    with rng.shard_coordinates(head_start=2, heads_total=H):
        part = att.flash_attention(qs, k[:, :, 2:], v[:, :, 2:],
                                   is_causal=True, dropout_p=P,
                                   generator=gen)
    (part * do[:, :, 2:]).sum().backward()
    np.testing.assert_allclose(part.detach().numpy(),
                               whole[:, :, 2:].detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(qs.grad.numpy(), qw.grad[:, :, 2:].numpy(),
                               atol=1e-6)


def test_kernel_arguments_carry_the_coordinates():
    """The dropout instances get the draw's pointer and a flag saying it
    holds coordinates (``int64[5]``); ``int64[2]`` has none; another
    length is refused."""
    q = torch.zeros(1, 4, 2, 16)
    (ptr, coords, thr, scale), sfx = kernels._dropout_args("t", q, P, SNAP)
    assert (ptr, coords, sfx) == (SNAP.data_ptr(), 0, "_dropout")
    assert thr == rng.keep_threshold(P) and scale == pytest.approx(1 / 0.75)
    draw = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int64)
    assert kernels._dropout_args("t", q, P, draw)[0][:2] == \
        (draw.data_ptr(), 1)
    assert kernels._dropout_args("t", q, 0.0, None) == ((None, 0, 0, 0.0),
                                                        "")
    with pytest.raises(Exception, match="batch_start"):
        kernels._dropout_args("t", q, P, torch.zeros(3, dtype=torch.int64))
