"""The port's dropout on the CPU: the generator, ``nn.functional.dropout``,
``nn.Dropout``, attention dropout's plain versions and the GPT model's
dropout sites.

The bits cannot match ``jax.random``, so dropout is held to its law and
its identities, with the JAX package's branches as the reference where it
has them:

- the keep share within 4.5 standard deviations of Binomial(n, 1 - p),
  kept values scaled by exactly ``1 / (1 - p)`` (the same division);
- ``p == 0`` and ``training=False`` bitwise equal to no dropout,
  ``downscale_in_infer`` and ``p == 1`` as ``paddle_tpu``'s ``dropout``;
- the plain dropout attention and its gradients (the ``_FlashAttention``
  Function on CPU tensors) against attention written out with the same
  mask (1e-6);
- Philox against the Random123 known-answer vectors, and the attention
  mask's words against Philox evaluated element by element at their
  global coordinates (what makes the kernels' tiles agree).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu_torch import rng
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn.functional import dropout
from paddle_tpu_torch.ops import attention as att

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _within_binomial(kept: int, n: int, p: float) -> bool:
    mean, sd = n * (1 - p), math.sqrt(n * p * (1 - p))
    return abs(kept - mean) <= 4.5 * sd


# -- the generator -----------------------------------------------------------

@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    t = [torch.tensor([v], dtype=torch.int64) for v in counter + key]
    got = tuple(int(w) for w in rng.philox4x32_10(*t))
    assert got == want


def test_draws_advance_on_the_device_and_seed_resets():
    gen = rng.Generator("cpu", seed=7)
    a, b = gen.draw(), gen.draw()
    assert a.tolist() == [7, 0] and b.tolist() == [7, 1]
    assert gen.get_state().tolist() == [7, 2] and gen.draws == 2
    state = gen._state
    gen.manual_seed(9)
    assert gen._state is state and state.tolist() == [9, 0]   # in place
    gen.advance(3)
    assert gen.get_state().tolist() == [9, 3]


def test_package_seed_reseeds_every_generator():
    rng.seed(11)
    gen = rng.default_generator("cpu")
    gen.draw()
    rng.seed(11)
    assert gen.get_state().tolist() == [11, 0]
    m1 = dropout(torch.ones(1000), 0.5)
    rng.seed(11)
    assert torch.equal(dropout(torch.ones(1000), 0.5), m1)
    assert not torch.equal(dropout(torch.ones(1000), 0.5), m1)


def test_keep_threshold_is_the_full_word():
    assert rng.keep_threshold(0.0) == 0
    assert rng.keep_threshold(1.0) == 2 ** 32
    assert rng.keep_threshold(0.1) == round(0.1 * 2 ** 32)
    with pytest.raises(ValueError):
        rng.keep_threshold(1.5)


def test_attention_words_follow_global_coordinates():
    """Each factor is Philox at (col >> 1, (row >> 4) * 8 + (row & 7),
    bh, offset_lo), word ((row >> 3) & 1) * 2 + (col & 1), under key
    (seed_lo, seed_hi ^ offset_hi), whatever the shape asked for."""
    seed, off = (5 << 32) + 12345, (3 << 32) + 77
    snap = torch.tensor([seed, off], dtype=torch.int64)
    p = 0.3
    f = rng.attention_dropout_factor(snap, 3, 40, 37, p)
    small = rng.attention_dropout_factor(snap, 2, 17, 9, p)
    assert torch.equal(small, f[:2, :17, :9])        # no tiling in the bits
    rs = np.random.RandomState(0)
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    k0, k1 = seed & 0xFFFFFFFF, ((seed >> 32) ^ (off >> 32)) & 0xFFFFFFFF
    for _ in range(40):
        bh, r, c = rs.randint(3), rs.randint(40), rs.randint(37)
        words = rng.philox4x32_10(t(c >> 1), t((r >> 4) * 8 + (r & 7)),
                                  t(bh), t(off & 0xFFFFFFFF), t(k0), t(k1))
        w = int(words[((r >> 3) & 1) * 2 + (c & 1)])
        want = 1 / (1 - p) if w >= rng.keep_threshold(p) else 0.0
        assert f[bh, r, c].item() == pytest.approx(want, rel=1e-7)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_attention_mask_law(p):
    snap = torch.tensor([3, 1], dtype=torch.int64)
    f = rng.attention_dropout_factor(snap, 8, 128, 128, p)
    kept = int((f > 0).sum())
    assert _within_binomial(kept, f.numel(), p)
    assert set(f.unique().tolist()) == {0.0, np.float32(1 / (1 - p))}


# -- dropout and nn.Dropout --------------------------------------------------

@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_law(p, dtype):
    rng.seed(1)
    x = torch.from_numpy(
        np.random.RandomState(0).rand(256, 300).astype(np.float32) + 0.5
    ).to(dtype)
    out = dropout(x, p)
    kept = out != 0
    assert _within_binomial(int(kept.sum()), x.numel(), p)
    assert torch.equal(out[kept], x[kept] / (1 - p))
    assert out.dtype == dtype


def test_dropout_axis_shares_the_mask():
    rng.seed(2)
    out = dropout(torch.ones(64, 5, 3), 0.5, axis=0)
    kept = out != 0
    assert torch.equal(kept, kept[:, :1, :1].expand_as(kept))
    assert 0 < int(kept[:, 0, 0].sum()) < 64
    out = dropout(torch.ones(6, 40), 0.5, axis=[-1])
    assert torch.equal(out[0], out[5])


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("p,training", [(0.0, True), (0.3, False),
                                        (0.0, False), (1.0, True),
                                        (0.3, True)])
def test_dropout_branches_match_jax(p, training, mode):
    """The JAX package's branches: the value with no mask drawn, and the
    kept share's scale when one is."""
    x = np.random.RandomState(3).randn(50, 40).astype(np.float32)
    ref = jF.dropout(paddle.to_tensor(x), p=p, training=training,
                     mode=mode).numpy()
    got = dropout(torch.from_numpy(x), p=p, training=training, mode=mode)
    if p in (0.0, 1.0) or not training:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        kept = got.numpy() != 0
        scale = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
        np.testing.assert_allclose(got.numpy()[kept], x[kept] * scale,
                                   rtol=1e-6)
        ref_kept = ref != 0
        assert _within_binomial(int(kept.sum()), x.size, p)
        assert _within_binomial(int(ref_kept.sum()), x.size, p)


def test_no_dropout_is_bitwise_the_input():
    x = torch.randn(7, 9, requires_grad=True)
    assert dropout(x, 0.0) is x
    assert dropout(x, 0.4, training=False) is x
    layer = Dropout(0.4).eval()
    assert layer(x) is x
    y = dropout(x, 1.0)
    assert torch.equal(y, torch.zeros_like(x))
    y.sum().backward()
    assert torch.equal(x.grad, torch.zeros_like(x))


def test_dropout_gradient_is_the_mask_over_keep():
    rng.seed(4)
    x = torch.randn(30, 30, requires_grad=True)
    out = dropout(x, 0.25)
    out.sum().backward()
    kept = out.detach() != 0
    want = kept.float() / 0.75
    assert torch.equal(x.grad, want)


def test_dropout_refuses_bad_arguments():
    x = torch.ones(3)
    with pytest.raises(ValueError):
        dropout(x, 1.2)
    with pytest.raises(ValueError, match="mode"):
        dropout(x, 0.2, mode="nope")


# -- attention dropout ----------------------------------------------------------

def _written_out(q, k, v, snap, p, causal=True):
    """Attention with the mask written out: softmax, times the factors,
    then @ V (autograd through every op), in f64."""
    B, S, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          -1e30)
    f = rng.attention_dropout_factor(snap, B * H, S, S, p) \
        .view(B, H, S, S).double()
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1) * f, v)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_dropout_attention_and_gradients(causal):
    rs = np.random.RandomState(5)
    B, S, H, D, p = 2, 24, 3, 16, 0.2
    arrs = [rs.randn(B, S, H, D).astype(np.float32) for _ in range(4)]
    snap = torch.tensor([21, 4], dtype=torch.int64)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    do = torch.from_numpy(arrs[3])
    out = att._FlashAttention.apply(q, k, v, causal, "cuda", p, snap)
    out.backward(do)
    ref_in = [torch.from_numpy(a).double().requires_grad_()
              for a in arrs[:3]]
    ref = _written_out(*ref_in, snap, p, causal)
    ref.backward(do.double())
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=0, atol=1e-6)
    for got, want in zip((q, k, v), ref_in):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   rtol=0, atol=1e-6)


def test_flash_attention_draws_once_and_eval_draws_nothing():
    x = torch.randn(1, 16, 2, 16)
    rng.seed(6)
    gen = rng.default_generator("cpu")
    a = att.flash_attention(x, x, x, is_causal=True, dropout_p=0.3)
    assert gen.get_state()[1].item() == 1
    ref = att.flash_attention(x, x, x, is_causal=True)
    assert not torch.equal(a, ref)
    b = att.flash_attention(x, x, x, is_causal=True, dropout_p=0.3,
                            training=False)
    assert torch.equal(b, ref) and gen.get_state()[1].item() == 1


def test_dropout_lse_stays_undropped():
    x = torch.randn(1, 16, 2, 16)
    snap = torch.tensor([1, 1], dtype=torch.int64)
    _, lse = att._sdpa_reference(x, x, x, True, True, 0.5, snap)
    _, lse0 = att._sdpa_reference(x, x, x, True, True)
    assert torch.equal(lse, lse0)


# -- the model's dropout sites ------------------------------------------------

def test_gpt_dropout_sites_and_eval():
    cfg = gpt_tiny(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    m = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    plain = GPTForCausalLM(gpt_tiny(), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).randint(0, 128, (2, 16)))
    rng.seed(0)
    gen = rng.default_generator("cpu")
    train_loss = m.compute_loss(x, x)
    # the embeddings, and per layer the attention probabilities and the
    # two residual branches
    assert gen.get_state()[1].item() == 1 + 3 * cfg.num_hidden_layers
    m.eval()
    assert torch.equal(m.compute_loss(x, x), plain.compute_loss(x, x))
    assert not torch.equal(train_loss, plain.compute_loss(x, x))
    assert gen.get_state()[1].item() == 1 + 3 * cfg.num_hidden_layers
