"""Common layers: ``Linear``, ``Embedding``, the dropouts, ``Flatten``,
padding, upsampling, ``Bilinear``, distances, pixel and channel shuffles,
``Unfold``/``Fold``.

Port of ``paddle_tpu/nn/layer/common.py``.  ``Linear`` is a
``torch.nn.Linear`` (so everything that looks for one finds it) whose
weight is torch's ``[out, in]``, drawn with the JAX package's law for
Paddle's ``[in, out]`` (``create_parameter(transpose=True)``: the fans,
and an ``Assign`` value written for Paddle, mean what they mean there);
``Embedding``, ``Bilinear`` (``[out, in1, in2]``, bias ``[1, out]``) keep
Paddle's shapes, which are torch's.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer

__all__ = [
    "Identity", "Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
    "AlphaDropout", "Flatten", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D",
    "Upsample", "UpsamplingBilinear2D", "UpsamplingNearest2D", "Bilinear",
    "CosineSimilarity", "PairwiseDistance", "PixelShuffle", "PixelUnshuffle",
    "ChannelShuffle", "Unfold", "Fold",
]


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Linear(nn.Linear, Layer):
    """``y = x W^T + b`` with ``W`` ``[out, in]``; the weight's default
    law is Xavier-uniform over Paddle's ``[in, out]``, the bias's zeros;
    ``bias_attr=False`` leaves the bias out."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=None):
        nn.Linear.__init__(self, in_features, out_features,
                           bias=bias_attr is not False, device="meta")
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr, dtype=dtype,
            default_initializer=I.XavierUniform(), device=device,
            transpose=True)
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [out_features], attr=bias_attr, dtype=dtype, is_bias=True,
                device=device)


class Embedding(Layer):
    """Rows of a ``[num_embeddings, embedding_dim]`` table (default law
    N(0, 1)); ``padding_idx``'s row starts at zeros and gets no
    gradient, and its positions give zeros."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse=False, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr, dtype=dtype,
            default_initializer=I.Normal(0.0, 1.0), device=device)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx].zero_()

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    """``Dropout(p=0.5, axis=None, mode="upscale_in_train")``:
    :func:`..functional.dropout` with ``training=self.training``, so
    ``eval()`` turns it off."""

    def __init__(self, p: float = 0.5,
                 axis: Union[None, int, Sequence[int]] = None,
                 mode: str = "upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, self.training, self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class _Pad(Layer):
    _FORMAT = "NCHW"

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format=None, name=None):
        super().__init__()
        self._pad, self._mode, self._value = padding, mode, value
        self._data_format = data_format or self._FORMAT

    def forward(self, x):
        return F.pad(x, self._pad, mode=self._mode, value=self._value,
                     data_format=self._data_format)


class Pad1D(_Pad):
    _FORMAT = "NCL"


class Pad2D(_Pad):
    _FORMAT = "NCHW"


class Pad3D(_Pad):
    _FORMAT = "NCDHW"


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True,
                         data_format=data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest",
                         data_format=data_format)


class Bilinear(Layer):
    """``out[b, o] = x1[b]^T W[o] x2[b] + bias``: ``W`` ``[out, in1,
    in2]``, bias ``[1, out]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = self.create_parameter([1, out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    """``(sum(|x - y| + epsilon) ** p) ** (1 / p)`` over the last dim."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return torch.pow(torch.pow(torch.abs(x - y) + self.epsilon, self.p)
                         .sum(-1, keepdim=self.keepdim), 1.0 / self.p)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes, self.strides = kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes, self.kernel_sizes = output_sizes, kernel_sizes
        self.strides, self.paddings = strides, paddings
        self.dilations = dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)
