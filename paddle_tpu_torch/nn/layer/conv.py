"""Convolution layers.

Port of ``paddle_tpu/nn/layer/conv.py``: weights in Paddle's layout,
which is torch's (``[out, in / groups, *k]``; the transposes ``[in,
out / groups, *k]``), weight and bias drawn uniform in ``±1 /
sqrt(fan_in)`` with ``fan_in = in / groups * prod(k)``, as the JAX layers
draw them.  ``padding_mode`` is stored and not read, as there.
"""
from __future__ import annotations

import math

from .. import functional as F
from .. import initializer as I
from ..functional.common import _ntuple
from ..layer_base import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


class _ConvNd(Layer):
    _ND = 2
    _TRANSPOSE = False
    _FORMAT = "NCHW"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format=None):
        super().__init__()
        nd = self._ND
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _ntuple(kernel_size, nd)
        self._stride, self._padding = stride, padding
        self._output_padding, self._dilation = output_padding, dilation
        self._groups, self._padding_mode = groups, padding_mode
        self._data_format = data_format or self._FORMAT
        if self._TRANSPOSE:
            shape = [in_channels, out_channels // groups, *self._kernel_size]
        else:
            shape = [out_channels, in_channels // groups, *self._kernel_size]
        bound = 1.0 / math.sqrt((in_channels // groups)
                                * math.prod(self._kernel_size))
        self.weight = self.create_parameter(
            shape, attr=weight_attr,
            default_initializer=I.Uniform(-bound, bound))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}")


class _Conv(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        fn = (F.conv1d, F.conv2d, F.conv3d)[self._ND - 1]
        return fn(x, self.weight, self.bias, self._stride, self._padding,
                  self._dilation, self._groups, self._data_format)


class _ConvTranspose(_ConvNd):
    _TRANSPOSE = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups, "zeros",
                         weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        fn = (F.conv1d_transpose, F.conv2d_transpose,
              F.conv3d_transpose)[self._ND - 1]
        return fn(x, self.weight, self.bias, self._stride, self._padding,
                  self._output_padding, self._groups, self._dilation,
                  output_size, self._data_format)


class Conv1D(_Conv):
    _ND, _FORMAT = 1, "NCL"


class Conv2D(_Conv):
    _ND, _FORMAT = 2, "NCHW"


class Conv3D(_Conv):
    _ND, _FORMAT = 3, "NCDHW"


class Conv1DTranspose(_ConvTranspose):
    _ND, _FORMAT = 1, "NCL"


class Conv2DTranspose(_ConvTranspose):
    _ND, _FORMAT = 2, "NCHW"


class Conv3DTranspose(_ConvTranspose):
    _ND, _FORMAT = 3, "NCDHW"
