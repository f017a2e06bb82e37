"""The port's transformer layers against the JAX package's, on the CPU.

Spec: ``tests/test_nn.py::TestTransformer``.  ``MultiHeadAttention``
(self and cross, bool and float masks, the incremental ``Cache`` and the
``StaticCache``), the encoder and decoder layers and stacks and
``Transformer`` are built in the JAX package from a seed, their
``state_dict()`` carried into the port by
``models.port_state_dict_from_jax``, and fed the same seeded inputs.
Outputs, and for the encoder and attention the input and parameter
gradients of ``sum(out * c)``, agree to ``TOL`` = 1e-4 (f32; attention
sums over the keys in another order).  On CPU tensors the kernel route of
``scaled_dot_product_attention`` runs the kernels' plain versions; the
routes are counted all the same and are checked here.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu_torch import device as tdevice
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as tF
from paddle_tpu_torch import rng as trng
from paddle_tpu_torch.models import port_state_dict_from_jax
from paddle_tpu_torch.regularizer import L2Decay

torch.set_num_threads(2)

TOL = 1e-4
E, H = 128, 2               # head dim 64: a kernel head dim


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's layers are built on the CPU (their default is the
    card)."""
    with tdevice.device_guard("cpu"):
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy())


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL,
                               err_msg=what)


def _r(seed, *shape):
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _pair(jl, tl):
    tl.load_state_dict(port_state_dict_from_jax(tl, _state(jl)))
    jl.eval()
    tl.eval()
    return jl, tl


def _mha(**kw):
    paddle.seed(0)
    return _pair(jnn.MultiHeadAttention(E, H, **kw),
                 tnn.MultiHeadAttention(E, H, **kw))


def _routes():
    return dict(tF.ATTENTION_ROUTES)


def _moved(before):
    return {k: tF.ATTENTION_ROUTES[k] - v for k, v in before.items()}


def test_self_attention_takes_the_kernel_route_with_gradients():
    jl, tl = _mha()
    x = _r(1, 2, 8, E)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    before = _routes()
    jout, tout = jl(jx), tl(tx)
    assert _moved(before) == {"kernel": 1, "plain": 0}
    _close(tout, _np(jout))
    c = _r(2, 2, 8, E)
    (jout * paddle.to_tensor(c)).sum().backward()
    (tout * torch.from_numpy(c)).sum().backward()
    _close(tx.grad, _np(jx.grad), "input grad")
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jl.named_parameters()}
    want = port_state_dict_from_jax(tl, jg)
    for n, p in tl.named_parameters():
        _close(p.grad, want[n].numpy(), n)


@pytest.mark.parametrize("mask", ["bool", "float", "causal"])
def test_masked_attention_takes_the_plain_route(mask):
    jl, tl = _mha()
    x = _r(3, 2, 6, E)
    if mask == "causal":
        jm = jnn.Transformer.generate_square_subsequent_mask(6)
        tm = tnn.Transformer.generate_square_subsequent_mask(6)
        _close(torch.where(torch.isinf(tm), -1.0, tm),
               np.where(np.isinf(_np(jm)), -1.0, _np(jm)))
    elif mask == "bool":
        m = np.random.RandomState(4).rand(2, 1, 6, 6) > 0.3
        m[..., 0] = True
        jm, tm = paddle.to_tensor(m), torch.from_numpy(m)
    else:
        m = _r(4, 1, H, 6, 6)
        jm, tm = paddle.to_tensor(m), torch.from_numpy(m)
    before = _routes()
    tout = tl(torch.from_numpy(x), attn_mask=tm)
    assert _moved(before) == {"kernel": 0, "plain": 1}
    _close(tout, _np(jl(paddle.to_tensor(x), attn_mask=jm)))


def test_cross_attention_with_kdim_vdim_takes_the_plain_route():
    jl, tl = _mha(kdim=24, vdim=40)
    q, k, v = _r(5, 2, 4, E), _r(6, 2, 7, 24), _r(7, 2, 7, 40)
    before = _routes()
    tout = tl(*(torch.from_numpy(a) for a in (q, k, v)))
    assert _moved(before) == {"kernel": 0, "plain": 1}
    _close(tout, _np(jl(*(paddle.to_tensor(a) for a in (q, k, v)))))


def test_incremental_and_static_caches_match_jax():
    jl, tl = _mha()
    mem = _r(8, 2, 5, E)
    jc = jl.gen_cache(paddle.to_tensor(_r(9, 2, 1, E)))
    tc = tl.gen_cache(torch.from_numpy(_r(9, 2, 1, E)))
    assert tuple(tc.k.shape) == (2, 0, H, E // H)
    for step in range(3):
        x = _r(10 + step, 2, 1, E)
        jout, jc = jl(paddle.to_tensor(x), cache=jc)
        tout, tc = tl(torch.from_numpy(x), cache=tc)
        _close(tout, _np(jout), f"step {step}")
        _close(tc.k, _np(jc.k))
    assert tuple(tc.k.shape) == (2, 3, H, E // H)
    js = jl.gen_cache(paddle.to_tensor(mem), type=jnn.MultiHeadAttention
                      .StaticCache)
    ts = tl.gen_cache(torch.from_numpy(mem),
                      type=tnn.MultiHeadAttention.StaticCache)
    x = _r(13, 2, 3, E)
    _close(tl(torch.from_numpy(x), cache=ts),
           _np(jl(paddle.to_tensor(x), cache=js)))


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_matches_jax_with_gradients(normalize_before):
    paddle.seed(1)
    jlayer = jnn.TransformerEncoderLayer(E, H, 64, dropout=0.0,
                                         activation="gelu",
                                         normalize_before=normalize_before)
    jl = jnn.TransformerEncoder(jlayer, 2, jnn.LayerNorm(E)
                                if normalize_before else None)
    tlayer = tnn.TransformerEncoderLayer(E, H, 64, dropout=0.0,
                                         activation="gelu",
                                         normalize_before=normalize_before)
    tl = tnn.TransformerEncoder(tlayer, 2, tnn.LayerNorm(E)
                                if normalize_before else None)
    _pair(jl, tl)
    x = _r(14, 2, 8, E)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    before = _routes()
    jout, tout = jl(jx), tl(tx)
    assert _moved(before) == {"kernel": 2, "plain": 0}
    _close(tout, _np(jout))
    c = _r(15, 2, 8, E)
    (jout * paddle.to_tensor(c)).sum().backward()
    (tout * torch.from_numpy(c)).sum().backward()
    _close(tx.grad, _np(jx.grad), "input grad")
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jl.named_parameters()}
    want = port_state_dict_from_jax(tl, jg)
    for n, p in tl.named_parameters():
        _close(p.grad, want[n].numpy(), n)


def test_encoder_cache_matches_jax():
    paddle.seed(2)
    jl = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(E, H, 32,
                                                            dropout=0.0), 2)
    tl = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(E, H, 32,
                                                            dropout=0.0), 2)
    _pair(jl, tl)
    x = _r(16, 1, 2, E)
    jout, jc = jl(paddle.to_tensor(x), cache=jl.gen_cache(
        paddle.to_tensor(x)))
    tout, tc = tl(torch.from_numpy(x), cache=tl.gen_cache(
        torch.from_numpy(x)))
    _close(tout, _np(jout))
    assert len(tc) == 2 and tuple(tc[0].k.shape) == (1, 2, H, E // H)


def test_decoder_layer_and_stack_match_jax_with_caches():
    paddle.seed(3)
    jl = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(
        E, H, 32, dropout=0.0, normalize_before=True), 2, jnn.LayerNorm(E))
    tl = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
        E, H, 32, dropout=0.0, normalize_before=True), 2, tnn.LayerNorm(E))
    _pair(jl, tl)
    tgt, mem = _r(17, 2, 4, E), _r(18, 2, 6, E)
    jm = jnn.Transformer.generate_square_subsequent_mask(4)
    tm = tnn.Transformer.generate_square_subsequent_mask(4)
    before = _routes()
    tout = tl(torch.from_numpy(tgt), torch.from_numpy(mem), tgt_mask=tm)
    assert _moved(before) == {"kernel": 0, "plain": 4}
    _close(tout, _np(jl(paddle.to_tensor(tgt), paddle.to_tensor(mem),
                        tgt_mask=jm)))
    jc = jl.gen_cache(paddle.to_tensor(mem))
    tc = tl.gen_cache(torch.from_numpy(mem))
    for step in range(2):
        x = _r(19 + step, 2, 1, E)
        jout, jc = jl(paddle.to_tensor(x), paddle.to_tensor(mem), cache=jc)
        tout, tc = tl(torch.from_numpy(x), torch.from_numpy(mem), cache=tc)
        _close(tout, _np(jout), f"step {step}")
    zipped = tl.gen_cache(torch.from_numpy(mem), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2


def test_transformer_matches_jax():
    """``tests/test_nn.py::TestTransformer::test_full_transformer``, with
    a causal target mask: the encoder's attention takes the kernel
    route, the decoder's self- and cross-attention the plain one."""
    paddle.seed(4)
    kw = dict(d_model=E, nhead=H, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=32, dropout=0.0)
    jl, tl = _pair(jnn.Transformer(**kw), tnn.Transformer(**kw))
    src, tgt = _r(21, 2, 8, E), _r(22, 2, 3, E)
    before = _routes()
    tout = tl(torch.from_numpy(src), torch.from_numpy(tgt),
              tgt_mask=tnn.Transformer.generate_square_subsequent_mask(3))
    assert _moved(before) == {"kernel": 2, "plain": 4}
    assert tuple(tout.shape) == (2, 3, E)
    _close(tout, _np(jl(paddle.to_tensor(src), paddle.to_tensor(tgt),
                        tgt_mask=jnn.Transformer
                        .generate_square_subsequent_mask(3))))


def test_stacks_deep_copy_the_first_layer_with_its_attributes():
    layer = tnn.TransformerEncoderLayer(
        16, 2, 32, weight_attr=tnn.ParamAttr(regularizer=L2Decay(0.1),
                                             need_clip=False))
    enc = tnn.TransformerEncoder(layer, 3)
    assert enc.layers[0] is layer and enc.layers[1] is not layer
    w0, w2 = enc.layers[0].linear1.weight, enc.layers[2].linear1.weight
    assert torch.equal(w0, w2) and w0.data_ptr() != w2.data_ptr()
    assert isinstance(w2.regularizer, L2Decay) and w2.need_clip is False


def test_attention_dropout_trains_and_evaluates():
    trng.seed(0)
    tl = tnn.MultiHeadAttention(E, H, dropout=0.5)
    x = torch.from_numpy(_r(23, 2, 8, E))
    tl.train()
    a, b = tl(x), tl(x)
    assert torch.isfinite(a).all() and not torch.equal(a, b)
    tl.eval()
    assert torch.equal(tl(x), tl(x))
    c = tF.scaled_dot_product_attention(
        *(x.reshape(2, 8, H, E // H),) * 3, dropout_p=0.5, training=False)
    d = tF.scaled_dot_product_attention(*(x.reshape(2, 8, H, E // H),) * 3)
    assert torch.equal(c, d)
