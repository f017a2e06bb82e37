"""Convolution functionals over torch's convolutions.

Port of ``paddle_tpu/nn/functional/conv.py``, which computes with
``lax.conv_general_dilated`` (not a Pallas kernel): here
``torch.nn.functional.conv*d`` and ``conv_transpose*d``.  Paddle's
padding forms are resolved first (an int, one per dim, ``[lo, hi]`` pairs
flattened or nested, ``"SAME"``, ``"VALID"``):

- ``"SAME"`` is XLA's: ``ceil(in / stride)`` outputs, the total padding
  split with the odd one after, at any stride (torch's ``padding="same"``
  takes stride 1 only);
- asymmetric padding is written into the input with ``F.pad`` and the
  convolution runs unpadded.

A channel-last ``data_format`` moves the channels to dim 1 and back.
Weights are Paddle's: ``[out, in / groups, *k]``, and for the transposes
``[in, out / groups, *k]`` (both torch's layout too).  A transpose's
``padding`` ``(lo, hi)`` crops its full output, ``output_padding`` extends
the end (with zeros past it), as the JAX package's lhs-dilated form
computes; ``output_size`` is not read (as in the JAX package).  A
transpose's ``"SAME"`` keeps ``in * stride`` outputs from the middle of
the full output and ``"VALID"`` all of it, as Paddle defines them (the
JAX package raises on string padding there: ROADMAP C).
"""
from __future__ import annotations

from typing import List, Tuple, Union

import torch
from torch.nn import functional as TF

from ...amp.auto_cast import amp_op
from .common import _ntuple
from ...ops._helpers import wrap_public

__all__ = ["conv1d", "conv2d", "conv3d",
           "conv1d_transpose", "conv2d_transpose", "conv3d_transpose"]

_CHANNEL_LAST = ("NHWC", "NWC", "NDHWC", "NLC")
_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}

Pads = Union[str, List[Tuple[int, int]]]


def _resolve_padding(padding, n: int) -> Pads:
    """``"SAME"``/``"VALID"``, or ``[(lo, hi)]`` for each of ``n`` dims."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (list, tuple)):
        flat = list(padding)
        if len(flat) == n and all(isinstance(p, int) for p in flat):
            return [(p, p) for p in flat]
        if len(flat) == 2 * n and all(isinstance(p, int) for p in flat):
            return [(flat[2 * i], flat[2 * i + 1]) for i in range(n)]
        if len(flat) == 1:
            return [(int(flat[0]), int(flat[0]))] * n
        if all(isinstance(p, (list, tuple)) for p in flat):
            pairs = [tuple(p) for p in flat]
            if len(pairs) == n + 2:        # with the batch and channel dims
                pairs = pairs[2:] if pairs[0] == (0, 0) else pairs[1:-1]
            return pairs
    return [(int(padding), int(padding))] * n


def _same_pads(sizes, k, strides, dils) -> List[Tuple[int, int]]:
    pads = []
    for n, kk, s, d in zip(sizes, k, strides, dils):
        out = -(-n // s)
        total = max((out - 1) * s + (kk - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _flat(pairs) -> list:
    """``F.pad``'s list (last dim first) for per-dim ``(lo, hi)`` pairs."""
    return [v for lo_hi in reversed(pairs) for v in lo_hi]


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format,
          nd):
    channel_last = data_format in _CHANNEL_LAST
    if channel_last:
        x = torch.movedim(x, -1, 1)
    strides, dils = _ntuple(stride, nd), _ntuple(dilation, nd)
    k = tuple(weight.shape[2:])
    pads = _resolve_padding(padding, nd)
    if pads == "SAME":
        pads = _same_pads(x.shape[2:], k, strides, dils)
    elif pads == "VALID":
        pads = [(0, 0)] * nd
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        x = TF.pad(x, _flat(pads))
        sym = 0
    out = _CONV[nd](x, weight, bias, strides, sym, dils, groups)
    return torch.movedim(out, 1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _CONV_OPS[1](x, weight, bias, stride, padding, dilation, groups,
                        data_format, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _CONV_OPS[2](x, weight, bias, stride, padding, dilation, groups,
                        data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _CONV_OPS[3](x, weight, bias, stride, padding, dilation, groups,
                        data_format, 3)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, nd):
    channel_last = data_format in _CHANNEL_LAST
    if channel_last:
        x = torch.movedim(x, -1, 1)
    strides, dils = _ntuple(stride, nd), _ntuple(dilation, nd)
    out_pads = _ntuple(output_padding, nd)
    k = tuple(weight.shape[2:])
    pads = _resolve_padding(padding, nd)
    if isinstance(pads, str):
        # Paddle's: "SAME" keeps in * stride outputs from the middle of
        # the full output, "VALID" all of it; no output padding
        pads = [(0, 0)] * nd
        if padding.upper() == "SAME":
            crop = [d * (kk - 1) + 1 - s for d, kk, s in zip(dils, k,
                                                              strides)]
            pads = [(max(c, 0) // 2, c - max(c, 0) // 2) for c in crop]
        out_pads = (0,) * nd
    if all(lo == hi for lo, hi in pads) and all(
            op < max(s, d) for op, s, d in zip(out_pads, strides, dils)):
        out = _CONV_T[nd](x, weight, bias, strides,
                          tuple(lo for lo, _ in pads), out_pads, groups,
                          dils)
    else:
        out = _CONV_T[nd](x, weight, None, strides, 0, 0, groups, dils)
        out = TF.pad(out, _flat([(-lo, op - hi) for (lo, hi), op
                                 in zip(pads, out_pads)]))
        if bias is not None:
            out = out + bias.reshape([1, -1] + [1] * nd)
    return torch.movedim(out, 1, -1) if channel_last else out


#: the ops as the AMP policy knows them (``conv2d``, ...: white-listed)
_CONV_OPS = {nd: amp_op(f"conv{nd}d")(_conv) for nd in (1, 2, 3)}
_CONV_T_OPS = {nd: amp_op(f"conv{nd}d_transpose")(_conv_transpose)
               for nd in (1, 2, 3)}


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _CONV_T_OPS[1](x, weight, bias, stride, padding, output_padding,
                          dilation, groups, data_format, 1)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _CONV_T_OPS[2](x, weight, bias, stride, padding, output_padding,
                          dilation, groups, data_format, 2)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _CONV_T_OPS[3](x, weight, bias, stride, padding, output_padding,
                          dilation, groups, data_format, 3)


wrap_public(globals())
