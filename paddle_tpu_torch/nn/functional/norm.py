"""Normalization functionals.

Port of ``paddle_tpu/nn/functional/norm.py``.  ``layer_norm``,
``rms_norm`` and ``batch_norm`` keep the input dtype and compute their
statistics in f32 (bf16 in, bf16 out), so an AMP O2 model keeps a bf16
residual stream:

- ``rms_norm`` normalises in f32, casts to the input dtype, and only then
  multiplies by the weight (``torch.nn.RMSNorm`` multiplies before the
  cast, so it is not used);
- ``layer_norm`` and ``batch_norm`` apply weight and bias in f32 before
  the one cast to the input dtype.

``batch_norm`` in training normalises by the batch's statistics and
updates the running ones as the JAX package does (:53-60):
``running = momentum * running + (1 - momentum) * batch`` with momentum
0.9 by default and the **biased** batch variance.  (``torch``'s
``batch_norm`` would update with the unbiased variance and the other
momentum, so it is not asked to.)  The update is an in-place ``copy_`` of
the buffers, so a step captured as a CUDA graph updates them at every
replay.  ``instance_norm``, ``group_norm``, ``normalize`` and
``local_response_norm`` compute in the input dtype, as the JAX package
does.  ``sync_batch_norm`` (for :class:`..layer.norm.SyncBatchNorm`) is
``batch_norm`` in training over a group's whole batch: the per-channel
count, sum and sum of squares are all-reduced (f32, differentiably, so
the backward all-reduces their gradients) before normalising.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch.nn import functional as TF

from ...amp.auto_cast import amp_op
from ...ops._helpers import wrap_public

__all__ = [
    "batch_norm", "layer_norm", "instance_norm", "group_norm", "normalize",
    "local_response_norm", "rms_norm",
]

_CHANNEL_LAST = ("NHWC", "NLC", "NDHWC")


def _channel_shape(x: torch.Tensor, channel_last: bool, c: int) -> list:
    shape = [1] * x.dim()
    shape[-1 if channel_last else 1] = c
    return shape


def _normalize(x, mean, var, weight, bias, epsilon, channel_last):
    shape = _channel_shape(x, channel_last, mean.shape[0])
    out = (x.float() - mean.float().reshape(shape)) \
        * torch.rsqrt(var.float().reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.float().reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    return out.to(x.dtype)


@amp_op("batch_norm")
def _bn_running(x, mean, var, weight, bias, epsilon, channel_last):
    return _normalize(x, mean, var, weight, bias, epsilon, channel_last)


@amp_op("batch_norm")
def _bn_batch(x, weight, bias, epsilon, channel_last):
    """The output and the batch's f32 mean and biased variance."""
    ch = x.dim() - 1 if channel_last else 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    xf = x.float()
    mean = xf.mean(dim=axes)
    var = xf.var(dim=axes, unbiased=False)
    return (_normalize(x, mean, var, weight, bias, epsilon, channel_last),
            mean, var)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm over every dim but the channel dim (1, or the last under
    a channel-last ``data_format``)."""
    channel_last = data_format in _CHANNEL_LAST
    if not (training and not use_global_stats):
        return _bn_running(x, running_mean, running_var, weight, bias,
                           epsilon, channel_last)
    out, mean, var = _bn_batch(x, weight, bias, epsilon, channel_last)
    with torch.no_grad():
        for run, batch in ((running_mean, mean), (running_var, var)):
            if run is not None:
                run.copy_(run * momentum
                          + batch.to(run.dtype) * (1 - momentum))
    return out


@amp_op("batch_norm")
def _bn_synced(x, weight, bias, epsilon, channel_last, group):
    """``_bn_batch`` with the statistics of ``group``'s whole batch."""
    from ...distributed import collective

    ch = x.dim() - 1 if channel_last else 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    xf = x.float()
    count = xf.new_full((1,), float(x.numel() // x.shape[ch]))
    stats = collective.all_reduce_autograd(
        torch.cat([xf.sum(dim=axes), xf.square().sum(dim=axes), count]),
        group)
    c = x.shape[ch]
    n = stats[-1]
    mean = stats[:c] / n
    var = (stats[c:2 * c] / n - mean.square()).clamp(min=0.0)
    return (_normalize(x, mean, var, weight, bias, epsilon, channel_last),
            mean, var)


def sync_batch_norm(x, running_mean, running_var, weight, bias, group,
                    momentum=0.9, epsilon=1e-5, data_format="NCHW"):
    """``batch_norm`` in training over ``group``'s whole batch (module
    docstring); the running statistics move by the whole batch's."""
    out, mean, var = _bn_synced(x, weight, bias, epsilon,
                                data_format in _CHANNEL_LAST, group)
    with torch.no_grad():
        for run, batch in ((running_mean, mean), (running_var, var)):
            if run is not None:
                run.copy_(run * momentum
                          + batch.to(run.dtype) * (1 - momentum))
    return out


@amp_op("layer_norm")
def layer_norm(x: torch.Tensor, normalized_shape: Union[int, Sequence[int]],
               weight: torch.Tensor = None, bias: torch.Tensor = None,
               epsilon: float = 1e-5, name=None) -> torch.Tensor:
    """``cast((x - mean) / sqrt(var + eps) * weight + bias)`` over the last
    ``len(normalized_shape)`` dims, all in f32, cast once to x's dtype."""
    shape = (normalized_shape,) if isinstance(normalized_shape, int) \
        else tuple(normalized_shape)
    out = TF.layer_norm(
        x.float(), shape, None if weight is None else weight.float(),
        None if bias is None else bias.float(), epsilon)
    return out.to(x.dtype)


@amp_op("rms_norm")
def rms_norm(x: torch.Tensor, weight: torch.Tensor = None,
             epsilon: float = 1e-6, name=None) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Per-sample, per-channel statistics over the spatial dims (the
    running statistics are not read or written, as in the JAX
    package)."""
    channel_last = data_format in _CHANNEL_LAST
    axes = tuple(range(1, x.dim() - 1)) if channel_last \
        else tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.reshape(_channel_shape(x, channel_last,
                                                  weight.shape[0]))
    if bias is not None:
        out = out + bias.reshape(_channel_shape(x, channel_last,
                                                bias.shape[0]))
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    channel_last = data_format in _CHANNEL_LAST
    a = torch.movedim(x, -1, 1) if channel_last else x
    n, c = a.shape[0], a.shape[1]
    grouped = a.reshape((n, num_groups, c // num_groups) + a.shape[2:])
    axes = tuple(range(2, grouped.dim()))
    mean = grouped.mean(dim=axes, keepdim=True)
    var = grouped.var(dim=axes, unbiased=False, keepdim=True)
    out = ((grouped - mean) * torch.rsqrt(var + epsilon)).reshape(a.shape)
    shape = [1] * out.dim()
    shape[1] = c
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return torch.movedim(out, 1, -1) if channel_last else out


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(|x|_p, epsilon)`` along ``axis``."""
    nrm = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp(nrm, min=epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * sum of squares over size channels) ** beta``
    (``alpha`` is not divided by ``size``, as in the JAX package)."""
    ch = x.dim() - 1 if data_format in _CHANNEL_LAST else 1
    half = size // 2
    pads = [0, 0] * (x.dim() - 1 - ch) + [half, size - 1 - half]
    summed = TF.pad(x.square(), pads).unfold(ch, size, 1).sum(dim=-1)
    return x / torch.pow(k + alpha * summed, beta)


wrap_public(globals())
