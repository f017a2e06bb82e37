"""The port's gradient clips against the JAX package's, on the CPU.

The three clips map the same seeded numpy gradients of four parameters
(one with ``need_clip=False``, one bf16) in both packages: 1e-6 absolute
on the f32 gradients (both sides do the same f32 arithmetic, in another
summation order), the bf16 one to its resolution.  ``clip_grad_norm_``
likewise, and ``TestGradClipIntegration``'s case
(``tests/test_optimizer.py:136``) through each package's SGD.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.optimizer import SGD

torch.set_num_threads(2)

SHAPES = [(4, 3), (5,), (2, 2, 2), (6,)]
NO_CLIP = 3          # this parameter's need_clip is False
BF16 = 1             # this gradient is bf16


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _grads(scale):
    rs = np.random.RandomState(0)
    return [(rs.randn(*s) * scale).astype(np.float32) for s in SHAPES]


def _jax_pairs(grads):
    pairs = []
    for i, g in enumerate(grads):
        p = jnn.Parameter(np.zeros(g.shape, np.float32))
        if i == NO_CLIP:
            p.need_clip = False
        t = paddle.to_tensor(g)
        pairs.append((p, t.astype("bfloat16") if i == BF16 else t))
    return pairs


def _port_pairs(grads):
    pairs = []
    for i, g in enumerate(grads):
        p = torch.nn.Parameter(torch.zeros(g.shape))
        if i == NO_CLIP:
            p.need_clip = False
        t = torch.from_numpy(g)
        pairs.append((p, t.to(torch.bfloat16) if i == BF16 else t))
    return pairs


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype("float32").numpy())


def _check(got, ref):
    for i, ((_, g), (_, r)) in enumerate(zip(got, ref)):
        tol = 2 ** -7 * np.abs(_np(r)).max() if i == BF16 else 1e-6
        np.testing.assert_allclose(_np(g), _np(r), rtol=0, atol=tol)


CLIPS = {"value": ("ClipGradByValue", (0.5,)),
         "value_min": ("ClipGradByValue", (0.4, -0.2)),
         "norm": ("ClipGradByNorm", (1.0,)),
         "global_norm": ("ClipGradByGlobalNorm", (1.0,))}


@pytest.mark.parametrize("scale", [0.05, 3.0])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_clip_matches_jax(clip, scale):
    name, args = CLIPS[clip]
    grads = _grads(scale)
    ref = getattr(jnn, name)(*args)(_jax_pairs(grads))
    got = getattr(pnn, name)(*args)(_port_pairs(grads))
    _check(got, ref)
    # need_clip=False keeps its gradient as it was
    np.testing.assert_array_equal(_np(got[NO_CLIP][1]), grads[NO_CLIP])
    if clip == "global_norm":
        clipped = [g for i, (_, g) in enumerate(got) if i != NO_CLIP]
        norm = pnn.ClipGradByGlobalNorm.global_norm(clipped).item()
        assert norm <= 1.0 + 1e-5
        if scale > 1:
            assert norm == pytest.approx(1.0, rel=1e-2)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    grads = _grads(2.0)
    jparams, pparams = [], []
    for g in grads:
        jp = jnn.Parameter(np.zeros(g.shape, np.float32))
        jp.grad = paddle.to_tensor(g)
        jparams.append(jp)
        pp = torch.nn.Parameter(torch.zeros(g.shape))
        pp.grad = torch.from_numpy(g.copy())
        pparams.append(pp)
    ref_total = float(np.asarray(
        jnn.clip_grad_norm_(jparams, 1.5, norm_type).numpy()))
    total = pnn.clip_grad_norm_(pparams, 1.5, norm_type)
    assert isinstance(total, torch.Tensor)
    assert total.item() == pytest.approx(ref_total, rel=1e-6)
    for jp, pp in zip(jparams, pparams):
        np.testing.assert_allclose(pp.grad.numpy(), _np(jp.grad), rtol=0,
                                   atol=1e-6)


def test_global_norm_clip_in_optimizer():
    """``TestGradClipIntegration.test_global_norm_clip_in_optimizer`` in
    both packages."""
    w = jnn.Parameter(np.zeros(4, dtype=np.float32))
    o = paddle.optimizer.SGD(1.0, parameters=[w],
                             grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    w.grad = paddle.to_tensor(np.full(4, 10.0, dtype=np.float32))
    o.step()
    pw = torch.nn.Parameter(torch.zeros(4))
    po = SGD([pw], lr=1.0, grad_clip=pnn.ClipGradByGlobalNorm(1.0))
    pw.grad = torch.full((4,), 10.0)
    po.step()
    np.testing.assert_allclose(np.linalg.norm(pw.detach().numpy()), 1.0,
                               rtol=1e-4)
    np.testing.assert_allclose(pw.detach().numpy(), w.numpy(), rtol=0,
                               atol=1e-7)
    # the optimizer hands the clipped gradient to its update and leaves the
    # parameter's own gradient as backward made it
    assert torch.equal(pw.grad, torch.full((4,), 10.0))


def test_clip_keeps_norm_and_scale_on_the_device():
    """Every value a clip forms is a tensor (nothing read on the host), so
    a clip runs inside a captured graph."""
    grads = [torch.randn(3, 3), torch.randn(4)]
    norm = pnn.ClipGradByGlobalNorm.global_norm(grads)
    assert isinstance(norm, torch.Tensor) and norm.dim() == 0
    pairs = [(torch.nn.Parameter(torch.zeros_like(g)), g) for g in grads]
    out = pnn.ClipGradByNorm(0.1)(pairs)
    assert all(isinstance(g, torch.Tensor) for _, g in out)
    assert pnn.ClipGradByGlobalNorm(1.0)([]) == []
