"""The LM head and its cross-entropy, fused so that no ``[N, V]`` logits
tensor is ever made.

Port of ``paddle_tpu/ops/fused.py`` ``fused_linear_cross_entropy``.  At
GPT-2 345M's batch 8 x 1024 tokens and vocab 50304 the logits would be
1.6 GB in bf16 (3.3 GB as an f32 softmax temporary).  The forward walks the
vocab in blocks (2048 rows of the head weight by default), keeping only an
f32 running max, sum of exponentials and picked logit per token; the
backward recomputes each block's logits, accumulates dh in f32 and writes
dW one block at a time.

Each block's product comes out in f32, as the JAX package takes it off
the accumulator (``preferred_element_type=f32``): on the card through
``torch.mm(..., out_dtype=torch.float32)``, on the CPU by multiplying the
bf16 values as f32 (the same exact products, summed in f32).  The block
products are plain matrix products outside any kernel, as in the JAX
package, where XLA runs them.

``fused_bias_dropout_residual_layer_norm`` is the counterpart of
``paddle_tpu/ops/pallas/__init__.py:112``: ``LayerNorm(residual +
dropout(x + bias))`` in plain torch, as the JAX function is plain ``jnp``
(no Pallas kernel, so no hand-written one here), its dropout one draw of
the device's Philox generator (:mod:`..rng`).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import rng as rng_mod
from ..amp.auto_cast import amp_op
from ._helpers import wrap_public

__all__ = ["fused_linear_cross_entropy",
           "fused_bias_dropout_residual_layer_norm"]

DEFAULT_BLOCK = 2048


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed and returned in f32."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _FusedLinearCrossEntropy(torch.autograd.Function):
    """Per-token loss ``lse(h W^T) - (h W^T)[label]`` in f32, 0 where
    ``valid`` is False.  ``h`` ``[N, H]`` and ``w`` ``[V, H]`` are in the
    compute dtype; ``labels`` ``[N]`` are already clamped into range."""

    @staticmethod
    def forward(ctx, h, w, labels, valid, block: int):
        N, V = h.shape[0], w.shape[0]
        f32 = dict(dtype=torch.float32, device=h.device)
        m = torch.full((N,), float("-inf"), **f32)
        s = torch.zeros((N,), **f32)
        picked = torch.full((N,), float("-inf"), **f32)
        for off in range(0, V, block):
            logits = _mm_f32(h, w[off:off + block].t())     # [N, nb] f32
            nb = logits.shape[1]
            new_m = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - new_m) \
                + torch.exp(logits - new_m[:, None]).sum(dim=1)
            m = new_m
            idx = (labels - off).clamp(0, nb - 1)
            in_blk = (labels >= off) & (labels < off + nb)
            picked = torch.where(in_blk, logits.gather(1, idx[:, None])[:, 0],
                                 picked)
        lse = m + torch.log(s)
        ctx.save_for_backward(h, w, labels, valid, lse)
        ctx.block = block
        return torch.where(valid, lse - picked, torch.zeros_like(lse))

    @staticmethod
    def backward(ctx, g):
        h, w, labels, valid, lse = ctx.saved_tensors
        block = ctx.block
        gv = (g * valid).float()                                # [N]
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dw = torch.empty_like(w)
        for off in range(0, w.shape[0], block):
            w_blk = w[off:off + block]
            p = torch.exp(_mm_f32(h, w_blk.t()) - lse[:, None])  # [N, nb]
            nb = p.shape[1]
            idx = (labels - off).clamp(0, nb - 1)
            in_blk = (labels >= off) & (labels < off + nb)
            p.scatter_add_(1, idx[:, None], -in_blk.float()[:, None])
            dlogits = (p * gv[:, None]).to(h.dtype)             # (p - onehot) g
            dh += _mm_f32(dlogits, w_blk)
            dw[off:off + nb] = _mm_f32(dlogits.t(), h).to(w.dtype)
        return dh.to(h.dtype), dw, None, None, None


@amp_op("fused_linear_cross_entropy")
def fused_linear_cross_entropy(hidden: torch.Tensor, weight: torch.Tensor,
                               label: torch.Tensor,
                               loss_mask: Optional[torch.Tensor] = None,
                               ignore_index: int = -100,
                               block_size: int = DEFAULT_BLOCK,
                               transpose_weight: bool = False
                               ) -> torch.Tensor:
    """Causal-LM loss ``cross_entropy(hidden @ weight.T, label)`` without
    materialising the ``[..., V]`` logits.

    ``hidden`` ``[..., H]``; ``weight`` ``[V, H]`` (vocab-major, the tied
    embedding's and ``nn.Linear``'s layout), or ``[H, V]`` with
    ``transpose_weight=True``; ``label`` ``[...]`` ints, where
    ``ignore_index`` positions add no loss and no gradient;
    ``loss_mask`` ``[...]`` multiplies the per-token losses.  The products
    run in hidden's dtype when it is bf16 or f16, else in f32: under
    :func:`..amp.auto_cast` O1 the op is gray, so bf16 or f16 hidden
    states and the f32 tied embedding arrive as they are and the weight is
    cast to the hidden states' dtype here, as the JAX ``_primal`` does
    (``paddle_tpu/ops/fused.py:155``).  Returns the f32 mean over the
    valid (or mask-weighted) positions."""
    w = weight.t() if transpose_weight else weight
    N = label.numel()
    cdt = hidden.dtype if hidden.dtype in (torch.bfloat16, torch.float16) \
        else torch.float32
    h2 = hidden.reshape(N, hidden.shape[-1]).to(cdt)
    lbl = label.reshape(N).long()
    valid = lbl != ignore_index
    safe = lbl.clamp(0, w.shape[0] - 1)
    loss = _FusedLinearCrossEntropy.apply(h2, w.to(cdt), safe, valid,
                                          int(block_size))
    if loss_mask is not None:
        mask = loss_mask.reshape(N).float()
        return (loss * mask).sum() / mask.sum().clamp(min=1.0)
    return loss.sum() / valid.float().sum().clamp(min=1.0)


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True, name=None):
    """``LayerNorm(residual + dropout(x + bias))`` over the last dim, in
    the inputs' dtype, the biased variance; dropout keeps an element with
    probability ``1 - dropout_rate`` and scales it by ``1 / (1 - rate)``
    (none outside training)."""
    p = float(dropout_rate) if training else 0.0
    a = x if bias is None else x + bias
    if p > 0.0:
        keep = rng_mod.dropout_keep(
            rng_mod.default_generator(x.device).draw(), a.shape, p)
        a = torch.where(keep, a / (1.0 - p), torch.zeros_like(a))
    y = residual + a
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    out = (y - mean) * torch.rsqrt(var + ln_epsilon)
    if ln_scale is not None:
        out = out * ln_scale
    if ln_bias is not None:
        out = out + ln_bias
    return out


wrap_public(globals())
