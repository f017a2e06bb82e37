"""RMSNorm and LayerNorm in the order the JAX package uses.

Port of ``paddle_tpu/nn/functional/norm.py`` ``rms_norm`` and
``layer_norm`` and of ``paddle_tpu/nn/layer/norm.py`` ``RMSNorm`` and
``LayerNorm``.  Both keep the input dtype and compute their statistics in
f32 (bf16 in, bf16 out), so an AMP O2 model keeps a bf16 residual stream.

- RMSNorm normalises in f32, casts to the input dtype, and only then
  multiplies by the weight.  ``torch.nn.RMSNorm`` multiplies before the
  cast, so it is not used.
- LayerNorm applies its weight and bias in f32 (taken up from whatever
  dtype they are stored in) before the one cast to the input dtype.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from ..amp.auto_cast import amp_op

__all__ = ["rms_norm", "RMSNorm", "layer_norm", "LayerNorm"]


@amp_op("rms_norm")
def rms_norm(x: torch.Tensor, weight: torch.Tensor = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


class RMSNorm(nn.Module):
    """``y = cast(x / rms(x)) * weight``; the weight starts at ones."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.epsilon)


@amp_op("layer_norm")
def layer_norm(x: torch.Tensor, normalized_shape: Union[int, Sequence[int]],
               weight: torch.Tensor = None, bias: torch.Tensor = None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """``cast((x - mean) / sqrt(var + eps) * weight + bias)`` over the last
    ``len(normalized_shape)`` dims, all in f32, cast once to x's dtype."""
    shape = (normalized_shape,) if isinstance(normalized_shape, int) \
        else tuple(normalized_shape)
    out = nn.functional.layer_norm(
        x.float(), shape, None if weight is None else weight.float(),
        None if bias is None else bias.float(), epsilon)
    return out.to(x.dtype)


class LayerNorm(nn.Module):
    """Layer norm over the last dim; weight starts at ones, bias at zeros."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-5, *,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))
        self.bias = nn.Parameter(
            torch.zeros(hidden_size, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight.shape[0], self.weight, self.bias,
                          self.epsilon)
