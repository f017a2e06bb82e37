"""Activation layers.

Port of ``paddle_tpu/nn/layer/activation.py``: each layer holds the
arguments it was built with and calls its functional on them.
"""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer

__all__ = [
    "CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid", "Hardswish",
    "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout", "Mish",
    "PReLU", "ReLU", "ReLU6", "RReLU", "SELU", "Sigmoid", "Silu", "Softmax",
    "Softmax2D", "Softplus", "Softshrink", "Softsign", "Swish", "Tanh",
    "Tanhshrink", "ThresholdedReLU",
]


def _simple(fname: str, cls_name: str):
    fn = getattr(F, fname)

    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            kwargs.pop("name", None)
            self._args, self._kwargs = args, kwargs

        def forward(self, x):
            return fn(x, *self._args, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = cls_name
    return _Act


CELU = _simple("celu", "CELU")
ELU = _simple("elu", "ELU")
GELU = _simple("gelu", "GELU")
Hardshrink = _simple("hardshrink", "Hardshrink")
Hardsigmoid = _simple("hardsigmoid", "Hardsigmoid")
Hardswish = _simple("hardswish", "Hardswish")
Hardtanh = _simple("hardtanh", "Hardtanh")
LeakyReLU = _simple("leaky_relu", "LeakyReLU")
LogSigmoid = _simple("log_sigmoid", "LogSigmoid")
LogSoftmax = _simple("log_softmax", "LogSoftmax")
Mish = _simple("mish", "Mish")
ReLU = _simple("relu", "ReLU")
ReLU6 = _simple("relu6", "ReLU6")
SELU = _simple("selu", "SELU")
Sigmoid = _simple("sigmoid", "Sigmoid")
Silu = _simple("silu", "Silu")
Softmax = _simple("softmax", "Softmax")
Softplus = _simple("softplus", "Softplus")
Softshrink = _simple("softshrink", "Softshrink")
Softsign = _simple("softsign", "Softsign")
Swish = _simple("swish", "Swish")
Tanh = _simple("tanh", "Tanh")
Tanhshrink = _simple("tanhshrink", "Tanhshrink")
ThresholdedReLU = _simple("thresholded_relu", "ThresholdedReLU")
Maxout = _simple("maxout", "Maxout")
GLU = _simple("glu", "GLU")


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self._data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class Softmax2D(Layer):
    """Softmax over the channel dim of ``[C, H, W]`` or ``[N, C, H, W]``."""

    def forward(self, x):
        if x.dim() not in (3, 4):
            raise ValueError(f"Softmax2D expects 3-D/4-D input, got "
                             f"{x.dim()}-D")
        return F.softmax(x, axis=-3)
