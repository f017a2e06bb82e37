"""The port's GPT model and its layers against the JAX package's, on the
CPU.

The JAX ``gpt_tiny`` model is built from a seed; its ``state_dict()`` goes
through ``models.convert.from_jax_state_dict`` into the port's model
(linear weights transposed; the head-major qkv layout rides the output
axis; the tied embedding is one parameter on both sides), and the same
seeded numpy token ids go through both.  Tolerances in f32: 1e-5 absolute
on logits and on every parameter gradient, 1e-6 relative on the loss
(measured ~1e-6 and below); LayerNorm and tanh-gelu 1e-6 in f32.  In bf16
LayerNorm is held to one bf16 ulp of the output (2**-8 relative): both
sides compute in f32 and round once, so only the f32 sum order differs.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.nn import functional as jax_F
from paddle_tpu_torch.models import (
    GPT_CONFIGS, GPTForCausalLM, from_jax_state_dict, gpt_tiny,
)
from paddle_tpu_torch.nn import LayerNorm, layer_norm

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _single_device():
    """The JAX side runs unsharded.  An earlier test file in the same
    worker may leave fleet's hybrid mesh set (model axis > 1), which
    sends ``compute_loss`` down the vocab-parallel path."""
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _jax_tiny(seed=0, **kw):
    paddle.seed(seed)
    return jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny(**kw))


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def models():
    jm = _jax_tiny()
    sd = _state(jm)
    tm = from_jax_state_dict(GPTForCausalLM(gpt_tiny(), device="cpu"), sd)
    return jm, tm, sd


def _ids(seed, shape=(2, 12)):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 128, shape), rs.randint(0, 128, shape)


def test_tiny_logits_match(models):
    jm, tm, _ = models
    x, _ = _ids(0)
    ref = np.asarray(jm(paddle.to_tensor(x)).numpy())
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 12, 128)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("tied", [True, False])
def test_loss_and_every_gradient_match(tied):
    """``compute_loss`` and the gradient of every parameter, with
    ignore_index labels; untied puts an ``lm_head`` beside the
    embedding."""
    jm = _jax_tiny(1, tie_word_embeddings=tied)
    tm = from_jax_state_dict(
        GPTForCausalLM(gpt_tiny(tie_word_embeddings=tied), device="cpu"),
        _state(jm))
    x, y = _ids(1)
    y[0, 3] = -100
    loss = jm.compute_loss(paddle.to_tensor(x), paddle.to_tensor(y))
    loss.backward()
    jgrads = {n: np.asarray(p.grad.numpy())
              for n, p in jm.named_parameters()}
    tloss = tm.compute_loss(torch.from_numpy(x), torch.from_numpy(y))
    tloss.backward()
    assert tloss.item() == pytest.approx(float(loss.numpy()), rel=1e-6)
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    tgrads = dict(tm.named_parameters())
    assert set(tgrads) == set(jgrads)
    for name, want in jgrads.items():
        got = tgrads[name].grad.numpy()
        np.testing.assert_allclose(got.T if name in linear else got, want,
                                   rtol=0, atol=1e-5, err_msg=name)


def test_converted_layouts(models):
    """qkv_proj keeps the head-major ``[H, 3*D]`` output layout; the tied
    head is the word embedding itself."""
    _, tm, sd = models
    w = tm.gpt.layers[0].attn.qkv_proj.weight.detach().numpy()
    np.testing.assert_array_equal(w, sd["gpt.layers.0.attn.qkv_proj.weight"].T)
    assert tm.lm_head is None
    e = tm.gpt.embeddings.word_embeddings.weight
    np.testing.assert_array_equal(e.detach().numpy(),
                                  sd["gpt.embeddings.word_embeddings.weight"])
    assert tm._head_weight() is e


@pytest.mark.parametrize("name", sorted(GPT_CONFIGS))
def test_configs_match(name):
    a = GPT_CONFIGS[name]()
    b = jax_gpt.GPT_CONFIGS[name]()
    for f in ("vocab_size", "hidden_size", "num_hidden_layers",
              "num_attention_heads", "head_dim", "ffn_size",
              "max_position_embeddings", "hidden_dropout_prob",
              "attention_probs_dropout_prob", "initializer_range",
              "layer_norm_epsilon", "tie_word_embeddings", "recompute"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 2 ** -8)])
def test_layer_norm_matches(dtype, tol):
    """Statistics in f32, weight and bias applied in f32, one cast to the
    input dtype; bf16 tolerance relative to the output's largest value."""
    rs = np.random.RandomState(2)
    x = (rs.randn(3, 5, 32) * 3 + 1).astype(np.float32)
    w, b = rs.randn(32).astype(np.float32), rs.randn(32).astype(np.float32)
    ref = jax_F.layer_norm(paddle.to_tensor(x).astype(dtype), 32,
                           paddle.to_tensor(w).astype(dtype),
                           paddle.to_tensor(b).astype(dtype),
                           epsilon=1e-5).astype("float32").numpy()
    tdt = getattr(torch, dtype)
    out = layer_norm(torch.from_numpy(x).to(tdt), 32,
                     torch.from_numpy(w).to(tdt), torch.from_numpy(b).to(tdt),
                     1e-5)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())
    layer = LayerNorm(32, device="cpu")
    assert torch.equal(layer.weight, torch.ones(32))
    assert torch.equal(layer.bias, torch.zeros(32))


def test_tanh_gelu_matches():
    x = np.linspace(-6, 6, 97).astype(np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    out = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_unported_options_raise():
    """Dropout and recompute, refused before they were ported, now build
    and train; what is still refused raises."""
    x = torch.zeros(1, 16, dtype=torch.long)
    for cfg in (gpt_tiny(hidden_dropout_prob=0.1),
                gpt_tiny(attention_probs_dropout_prob=0.1),
                gpt_tiny(recompute=True)):
        m = GPTForCausalLM(cfg, device="cpu")
        loss = m.compute_loss(x, x)
        loss.backward()
        assert torch.isfinite(loss)
        assert all(p.grad is not None for p in m.parameters())
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        m(torch.zeros(1, 65, dtype=torch.long))


def test_seeded_weights_are_reproducible():
    a = GPTForCausalLM(gpt_tiny(), device="cpu",
                       generator=torch.Generator().manual_seed(3))
    b = GPTForCausalLM(gpt_tiny(), device="cpu",
                       generator=torch.Generator().manual_seed(3))
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    w = a.gpt.layers[0].mlp.fc1.weight
    assert abs(w.std().item() - 0.02) < 0.005
    assert not a.gpt.layers[0].mlp.fc1.bias.any()
    assert torch.equal(a.gpt.final_ln.weight, torch.ones(64))


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForCausalLM(gpt_tiny())
