"""Pooling layers.

Port of ``paddle_tpu/nn/layer/pooling.py``: each holds its window and
options and calls its functional.
"""
from __future__ import annotations

from .. import functional as F
from ..layer_base import Layer

__all__ = [
    "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
    "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
    "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
    "AdaptiveMaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
]


class _Pool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        kwargs.pop("name", None)
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.kwargs = kwargs

    def forward(self, x):
        return type(self)._fn(x, self.kernel_size, self.stride, self.padding,
                              **self.kwargs)

    def extra_repr(self):
        return f"kernel_size={self.kernel_size}, stride={self.stride}"


class AvgPool1D(_Pool):
    _fn = staticmethod(F.avg_pool1d)


class AvgPool2D(_Pool):
    _fn = staticmethod(F.avg_pool2d)


class AvgPool3D(_Pool):
    _fn = staticmethod(F.avg_pool3d)


class MaxPool1D(_Pool):
    _fn = staticmethod(F.max_pool1d)


class MaxPool2D(_Pool):
    _fn = staticmethod(F.max_pool2d)


class MaxPool3D(_Pool):
    _fn = staticmethod(F.max_pool3d)


class _AdaptivePool(Layer):
    _fn = None

    def __init__(self, output_size, **kwargs):
        super().__init__()
        kwargs.pop("name", None)
        self.output_size, self.kwargs = output_size, kwargs

    def forward(self, x):
        return type(self)._fn(x, self.output_size, **self.kwargs)


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool1d)


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool2d)


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool3d)


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool1d)


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool2d)


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool3d)


class _MaxUnPool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.output_size = output_size

    def forward(self, x, indices):
        return type(self)._fn(x, indices, self.kernel_size, self.stride,
                              self.padding, output_size=self.output_size)

    def extra_repr(self):
        return f"kernel_size={self.kernel_size}, stride={self.stride}"


class MaxUnPool1D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool1d)


class MaxUnPool2D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool2d)


class MaxUnPool3D(_MaxUnPool):
    _fn = staticmethod(F.max_unpool3d)
