"""Activation functionals.

Port of ``paddle_tpu/nn/functional/activation.py``: the same formulas in
torch ops (the JAX package has no activation kernels either; XLA fuses
them).  ``rrelu`` in training and ``gumbel_softmax`` draw from torch's
generator of the input's device: their bits differ from the JAX
package's, their laws do not.  The ``*_`` variants write in place.
"""
from __future__ import annotations

import torch
from torch.nn import functional as TF
from ...ops._helpers import wrap_public

__all__ = [
    "relu", "relu6", "relu_", "elu", "elu_", "selu", "celu", "gelu", "silu",
    "swish", "mish", "softplus", "softsign", "softshrink", "hardshrink",
    "tanhshrink", "hardtanh", "hardsigmoid", "hardswish", "leaky_relu",
    "log_sigmoid", "prelu", "rrelu", "maxout", "glu", "softmax", "softmax_",
    "log_softmax", "gumbel_softmax", "sigmoid", "tanh", "thresholded_relu",
]


def _cast(x, dtype):
    if dtype is None:
        return x
    from ..initializer import _dtype
    return x.to(_dtype(dtype))


def relu(x, name=None):
    return torch.relu(x)


def relu_(x, name=None):
    return x.relu_()


def relu6(x, name=None):
    return torch.clamp(x, 0.0, 6.0)


def elu(x, alpha=1.0, name=None):
    return TF.elu(x, alpha)


def elu_(x, alpha=1.0, name=None):
    return x.copy_(TF.elu(x, alpha))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return TF.celu(x, alpha)


def gelu(x, approximate=False, name=None):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    return TF.silu(x)


def swish(x, name=None):
    return TF.silu(x)


def mish(x, name=None):
    return x * torch.tanh(TF.softplus(x))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``x`` where ``beta * x > threshold``, else ``log1p(exp(beta x)) /
    beta``."""
    return TF.softplus(x, beta, threshold)


def softsign(x, name=None):
    return x / (1 + x.abs())


def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(x * slope + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def leaky_relu(x, negative_slope=0.01, name=None):
    return TF.leaky_relu(x, negative_slope)


def log_sigmoid(x, name=None):
    return TF.logsigmoid(x)


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where positive, else ``weight * x``; a weight of more than one
    element is per channel (axis 1, or the last under a channel-last
    ``data_format``)."""
    if weight.numel() > 1:
        shape = [1] * x.dim()
        shape[1 if data_format == "NCHW" else x.dim() - 1] = weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x > 0, x, weight * x)


def rrelu(x, lower=0.125, upper=0.3333333, training=False, name=None):
    """Leaky ReLU with slopes uniform in ``[lower, upper)`` per element in
    training, their mean otherwise."""
    if training:
        slope = (torch.rand(x.shape, device=x.device) * (upper - lower)
                 + lower).to(x.dtype)
        return torch.where(x >= 0, x, slope * x)
    return leaky_relu(x, (lower + upper) / 2.0)


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def maxout(x, groups, axis=1, name=None):
    """The JAX package's grouping: axis ``axis`` of ``C`` channels is read
    as ``[groups, C // groups]`` and maxed over ``groups``."""
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (groups, c // groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax)


def glu(x, axis=-1, name=None):
    return TF.glu(x, axis)


def softmax(x, axis=-1, dtype=None, name=None):
    return torch.softmax(_cast(x, dtype), dim=axis)


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(softmax(x, axis, dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
    return torch.log_softmax(_cast(x, dtype), dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g``; with
    ``hard`` the one-hot of its argmax in the forward and the soft
    gradient (straight through)."""
    u = torch.rand(x.shape, device=x.device)
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    soft = torch.softmax((x + g.to(x.dtype)) / temperature, dim=axis)
    if not hard:
        return soft
    idx = soft.argmax(dim=axis, keepdim=True)
    one_hot = torch.zeros_like(soft).scatter_(axis, idx, 1.0)
    return one_hot + soft - soft.detach()


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


wrap_public(globals())
