"""``nn.functional``: port of ``paddle_tpu/nn/functional``.

:func:`scaled_dot_product_attention` is the entry of Paddle's attention
layers into the flash kernels.  It routes by the JAX package's rule
(``paddle_tpu/ops/pallas/__init__.py:94-109`` with the kernel's
``supports``, ``flash_attention_kernel.py:362``): with no mask, equal
``[B, S, H, D]`` query and key shapes and a head dim the kernels are
instantiated for (``ops.kernels.HEAD_DIMS``), it takes the **kernel**
route, ``ops.attention.flash_attention``: on CUDA tensors K1 forward and
K2/K3 backward (their dropout instances at ``dropout_p > 0`` in
training; under ``torch.no_grad`` K1 through the registered op
``paddle_tpu_torch::flash_fwd``), on CPU tensors their plain versions.
A mask, ``Sq != Sk`` (cross-attention, an incremental ``Cache``) or
another head dim takes the **plain** route, ``flash_attention`` with
``kernel="reference"``: ``_sdpa_reference`` (the JAX package's XLA
oracle) with autograd, or at equal shapes without a mask the kernels'
plain versions, on every device.  So a CUDA call at another head dim
runs plain PyTorch, as the JAX package falls back to its reference,
where ``ops.attention.flash_attention`` itself raises (ROADMAP C).  The
route is
decided by shapes and mask alone, never by a kernel failing, and each
call adds one to :data:`ATTENTION_ROUTES` (a host count: a CUDA graph's
capture counts once, its replays none, as ``ops.kernels`` counts
launches).
"""
from __future__ import annotations

from typing import Dict

import torch

from ...amp.auto_cast import amp_op
from ...ops.attention import flash_attention, supports
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from . import activation, common, conv, extras, loss, norm, pooling

__all__ = (activation.__all__ + common.__all__ + conv.__all__
           + extras.__all__ + loss.__all__ + norm.__all__ + pooling.__all__
           + ["sequence_mask", "scaled_dot_product_attention",
              "ATTENTION_ROUTES"])

#: calls of :func:`scaled_dot_product_attention` by route
ATTENTION_ROUTES: Dict[str, int] = {"kernel": 0, "plain": 0}


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]`` for ``j < maxlen`` (default: the
    largest length, read on the host)."""
    from ..initializer import _dtype
    ml = int(x.max()) if maxlen is None else int(maxlen)
    return (torch.arange(ml, device=x.device) < x.unsqueeze(-1)) \
        .to(_dtype(dtype))


@amp_op("flash_attention")
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention over ``[batch, seq, heads, head_dim]`` tensors (Paddle's
    layout); ``attn_mask`` is a bool (False drops a score) or additive
    float mask broadcast to ``[B, H, Sq, Sk]``.  Routed as the module
    says."""
    kernel = attn_mask is None and supports(tuple(query.shape),
                                            tuple(key.shape))
    ATTENTION_ROUTES["kernel" if kernel else "plain"] += 1
    return flash_attention(query, key, value, is_causal=is_causal,
                           dropout_p=dropout_p, training=training,
                           kernel="cuda" if kernel else "reference",
                           attn_mask=attn_mask)
