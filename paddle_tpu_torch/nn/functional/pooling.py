"""Pooling functionals.

Port of ``paddle_tpu/nn/functional/pooling.py`` (``lax.reduce_window``
there, torch's pooling here).  Paddle's conventions:

- ``padding`` takes the conv forms (:func:`.conv._resolve_padding`,
  ``"SAME"`` as XLA's); it is written into the input (``-inf`` for max,
  zeros for average), so asymmetric padding and padding past half a
  window pool as the JAX package's windows do;
- ``exclusive=True`` (the default; torch's ``count_include_pad=False``)
  averages over the window's elements inside the input; with
  ``exclusive=False``, or string padding, it divides by the window size;
  ``divisor_override`` divides by that instead;
- ``ceil_mode=True`` adds the windows that start inside the input but run
  past its end (padded further at the end).  The JAX package reads no
  ``ceil_mode`` (its outputs are always the floor's): ROADMAP C;
- ``return_mask=True`` also returns each maximum's index into the
  flattened spatial plane of the unpadded input, as ``max_unpool*d``
  takes it (int64; channel-first layouts only, as in the JAX package).

A channel-last ``data_format`` moves the channels to dim 1 and back.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as TF

from .common import _ntuple
from .conv import _flat, _resolve_padding, _same_pads
from ...ops._helpers import wrap_public

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "max_pool1d", "max_pool2d", "max_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
    "max_unpool1d", "max_unpool2d", "max_unpool3d",
]

_CHANNEL_LAST = ("NHWC", "NWC", "NDHWC", "NLC")
_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _window_pads(spatial, k, s, padding, ceil_mode):
    """Per-dim ``(lo, hi)`` padding (``ceil_mode``'s extra windows added
    to ``hi``) and whether the padding was given as a string."""
    pads = _resolve_padding(padding, len(k))
    string = isinstance(pads, str)
    if pads == "SAME":
        pads = _same_pads(spatial, k, s, (1,) * len(k))
    elif pads == "VALID":
        pads = [(0, 0)] * len(k)
    if ceil_mode:
        out = []
        for n, kk, ss, (lo, hi) in zip(spatial, k, s, pads):
            span = n + lo + hi - kk
            extra = (-(-span // ss)) * ss - span if span >= 0 else 0
            out.append((lo, hi + extra))
        pads = out
    return pads, string


def _lowest(x: torch.Tensor):
    return float("-inf") if x.is_floating_point() \
        else torch.iinfo(x.dtype).min


def _pool(x, nd, kernel, stride, padding, mode, ceil_mode, exclusive,
          data_format, divisor=None, return_mask=False):
    channel_last = data_format in _CHANNEL_LAST
    if channel_last:
        if return_mask:
            raise NotImplementedError(
                f"return_mask requires a channel-first layout, got "
                f"{data_format}")
        x = torch.movedim(x, -1, 1)
    k = _ntuple(kernel, nd)
    s = _ntuple(stride if stride is not None else kernel, nd)
    spatial = tuple(x.shape[2:])
    pads, string = _window_pads(spatial, k, s, padding, ceil_mode)
    padded = any(lo or hi for lo, hi in pads)
    if mode == "max":
        xp = TF.pad(x, _flat(pads), value=_lowest(x)) if padded else x
        if not return_mask:
            out = _MAX[nd](xp, k, s)
        else:
            out, idx = _MAX[nd](xp, k, s, return_indices=True)
            if padded:
                idx = _unpadded_index(idx, tuple(xp.shape[2:]), spatial,
                                      [lo for lo, _ in pads])
            return out, idx
    else:
        xp = TF.pad(x, _flat(pads)) if padded else x
        out = _AVG[nd](xp, k, s)                   # sum / window size
        if divisor is not None:
            out = out * (math.prod(k) / divisor)
        elif exclusive and not string and padded:
            ones = torch.ones((1, 1) + spatial, dtype=x.dtype,
                              device=x.device)
            out = out / _AVG[nd](TF.pad(ones, _flat(pads)), k, s)
    return torch.movedim(out, 1, -1) if channel_last else out


def _unpadded_index(idx, padded_sizes, sizes, lo):
    """Flat indices into a padded plane, re-read in the unpadded one."""
    out = torch.zeros_like(idx)
    rem = idx
    for d in reversed(range(len(sizes))):
        coord = rem % padded_sizes[d] - lo[d]
        rem = rem // padded_sizes[d]
        out = out + coord * math.prod(sizes[d + 1:])
    return out


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool(x, 1, kernel_size, stride, padding, "avg", ceil_mode,
                 exclusive, "NCW")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, 2, kernel_size, stride, padding, "avg", ceil_mode,
                 exclusive, data_format, divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, 3, kernel_size, stride, padding, "avg", ceil_mode,
                 exclusive, data_format, divisor_override)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _pool(x, 1, kernel_size, stride, padding, "max", ceil_mode, True,
                 "NCW", return_mask=return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _pool(x, 2, kernel_size, stride, padding, "max", ceil_mode, True,
                 data_format, return_mask=return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _pool(x, 3, kernel_size, stride, padding, "max", ceil_mode, True,
                 data_format, return_mask=return_mask)


def _max_unpool(x, indices, nd, kernel, stride, padding, output_size):
    """Each pooled value written back at its index (``return_mask``'s) of
    a zero plane of ``output_size`` (default ``(in - 1) * stride - 2 *
    padding + kernel`` per dim)."""
    k = _ntuple(kernel, nd)
    s = _ntuple(stride if stride is not None else kernel, nd)
    pads = _resolve_padding(padding, nd)
    if isinstance(pads, str):
        raise ValueError("max_unpool does not support string padding")
    n, c = x.shape[0], x.shape[1]
    if output_size is not None:
        out_sp = tuple(output_size)[-nd:]
    else:
        out_sp = tuple((i - 1) * st - 2 * lo + kk for i, st, (lo, _), kk
                       in zip(x.shape[2:], s, pads, k))
    out = torch.zeros((n, c, math.prod(out_sp)), dtype=x.dtype,
                      device=x.device)
    out = out.scatter(2, indices.reshape(n, c, -1).long(),
                      x.reshape(n, c, -1))
    return out.reshape((n, c) + out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, padding,
                       output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, padding,
                       output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, padding,
                       output_size)


def _adaptive(x, nd, output_size, mode, data_format, return_mask=False):
    """Segments ``[floor(i * n / m), ceil((i + 1) * n / m))`` per dim, as
    the JAX package cuts them."""
    channel_last = data_format in _CHANNEL_LAST
    if channel_last:
        x = torch.movedim(x, -1, 1)
    fn = _ADAPTIVE[(mode, nd)]
    size = _ntuple(output_size, nd)
    if return_mask:
        return fn(x, size, return_indices=True)
    out = fn(x, size)
    return torch.movedim(out, 1, -1) if channel_last else out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, 1, output_size, "avg", "NCW")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, 2, output_size, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, 3, output_size, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, 1, output_size, "max", "NCW", return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, 2, output_size, "max", "NCHW", return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, 3, output_size, "max", "NCDHW", return_mask)


wrap_public(globals())
