"""The port's fused LM-head cross-entropy against the JAX package's, on the
CPU.

The same seeded numpy hidden states, head weight and labels go through
``paddle_tpu.ops.fused.fused_linear_cross_entropy`` (eager, gradients by
its custom_vjp) and the port's.  The vocab (37) is not a multiple of the
block (8 or 16), labels include ``ignore_index``, and the weight comes
vocab-major (tied) or ``[H, V]`` with ``transpose_weight`` (untied).
Tolerance in f32: 1e-5 on the loss and 1e-5 absolute on the gradients
(measured ~1e-7).  In bf16 both sides take each block's logits in f32 off
bf16 operands; the per-token sums differ only in order, so the loss is
held to 1e-5 relative and the bf16 gradients to 2 bf16 ulps of the
largest element (2**-7 of the max).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.ops.fused import fused_linear_cross_entropy as jax_flce
from paddle_tpu_torch.ops import fused_linear_cross_entropy

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _single_device():
    """The JAX side runs unsharded, whatever hybrid mesh an earlier test
    file in the same worker left set."""
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


N_B, N_S, HID, V = 2, 6, 8, 37


def _inputs(seed, transpose):
    rs = np.random.RandomState(seed)
    h = rs.randn(N_B, N_S, HID).astype(np.float32)
    w = (rs.randn(HID, V) if transpose else rs.randn(V, HID)).astype(
        np.float32)
    lbl = rs.randint(0, V, (N_B, N_S)).astype(np.int64)
    lbl[0, 1] = lbl[1, 4] = -100
    mask = (rs.rand(N_B, N_S) > 0.3).astype(np.float32)
    return h, w, lbl, mask


def _jax(h, w, lbl, mask, block, transpose, dtype="float32"):
    th = paddle.to_tensor(h).astype(dtype)
    tw = paddle.to_tensor(w).astype(dtype)
    th.stop_gradient = False
    tw.stop_gradient = False
    loss = jax_flce(th, tw, paddle.to_tensor(lbl.astype(np.int32)),
                    loss_mask=None if mask is None else paddle.to_tensor(mask),
                    block_size=block, transpose_weight=transpose)
    loss.backward()
    return (float(loss.numpy()), np.asarray(th.grad.astype("float32").numpy()),
            np.asarray(tw.grad.astype("float32").numpy()))


def _port(h, w, lbl, mask, block, transpose, dtype=torch.float32):
    th = torch.from_numpy(h).to(dtype).requires_grad_()
    tw = torch.from_numpy(w).to(dtype).requires_grad_()
    loss = fused_linear_cross_entropy(
        th, tw, torch.from_numpy(lbl),
        loss_mask=None if mask is None else torch.from_numpy(mask),
        block_size=block, transpose_weight=transpose)
    loss.backward()
    return loss.item(), th.grad.float().numpy(), tw.grad.float().numpy()


@pytest.mark.parametrize("transpose", [False, True], ids=["tied", "untied"])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("block", [8, 16])
def test_loss_and_grads_match_jax(transpose, with_mask, block):
    h, w, lbl, mask = _inputs(0, transpose)
    mask = mask if with_mask else None
    ref = _jax(h, w, lbl, mask, block, transpose)
    got = _port(h, w, lbl, mask, block, transpose)
    assert got[0] == pytest.approx(ref[0], rel=1e-5)
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_bf16_matches_jax():
    """bf16 operands: f32 logits off the product on both sides."""
    h, w, lbl, _ = _inputs(1, False)
    ref = _jax(h, w, lbl, None, 16, False, dtype="bfloat16")
    got = _port(h, w, lbl, None, 16, False, dtype=torch.bfloat16)
    assert got[0] == pytest.approx(ref[0], rel=1e-5)
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2 ** -7 * np.abs(b).max())


def test_block_size_does_not_change_the_result():
    h, w, lbl, mask = _inputs(2, False)
    one = _port(h, w, lbl, mask, V, False)        # one block: plain CE
    for block in (1, 5, 36):
        got = _port(h, w, lbl, mask, block, False)
        assert got[0] == pytest.approx(one[0], rel=1e-6)
        for a, b in zip(got[1:], one[1:]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_matches_unfused_cross_entropy():
    """Against ``torch.nn.functional.cross_entropy`` on materialised
    logits (ignore_index, mean over the valid tokens)."""
    h, w, lbl, _ = _inputs(3, False)
    th = torch.from_numpy(h)
    logits = th.reshape(-1, HID) @ torch.from_numpy(w).t()
    want = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(lbl).reshape(-1), ignore_index=-100)
    got = fused_linear_cross_entropy(th, torch.from_numpy(w),
                                     torch.from_numpy(lbl), block_size=8)
    assert got.item() == pytest.approx(want.item(), rel=1e-6)


def test_ignored_tokens_get_no_gradient():
    h, w, lbl, _ = _inputs(4, False)
    _, dh, _ = _port(h, w, lbl, None, 8, False)
    assert not dh[0, 1].any() and not dh[1, 4].any()
    assert dh[0, 0].any()
