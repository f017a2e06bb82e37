"""Normalization layers.

Port of ``paddle_tpu/nn/layer/norm.py``, with the JAX layers' parameter
and buffer names (their state dicts load as they are): batch norms keep
``weight``, ``bias`` and the persistable buffers ``_mean`` (zeros) and
``_variance`` (ones), updated in place in training
(:func:`..functional.batch_norm`); instance norms call their weight
``scale``.  ``SyncBatchNorm`` normalises by the whole data-parallel
batch's statistics: in training, when a group of more than one rank is
live (its ``group=``, else the ``torch.distributed`` world), each rank's
per-channel count, sum and sum of squares (f32) are all-reduced over it
before normalising (:func:`..functional.norm.sync_batch_stats`, as
``torch.nn.SyncBatchNorm`` does), so every rank normalises by, and moves
its running ``_mean`` and ``_variance`` by, the same statistics, those
the JAX layer computes on the whole batch; the backward all-reduces the
two per-channel gradient sums.  On a world of one, and in evaluation, it
is ``BatchNorm``.  ``LayerNorm`` and ``RMSNorm`` also take ``device=`` and
``dtype=`` keywords, as the port's models build them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ... import device as _device
from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer

__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
    "SyncBatchNorm", "LayerNorm", "RMSNorm", "GroupNorm", "InstanceNorm1D",
    "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm",
]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)
        device = _device.current_device()
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm(_BatchNormBase):
    """The fluid-style ``BatchNorm(num_channels, act=None, ...)``."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(F, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NLC" if data_format == "NLC" else "NCHW",
                         use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr,
                         "NDHWC" if data_format == "NDHWC" else "NCHW",
                         use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm over the whole data-parallel batch (module docstring);
    ``group``: the ranks to synchronise over (the world by default)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, group=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format)
        self._group = group

    def _sync_group(self):
        """The live group of more than one rank to reduce over, or None."""
        from ...distributed import collective

        g = self._group
        if g is None:
            if not (dist.is_available() and dist.is_initialized()) \
                    or dist.get_world_size() == 1:
                return None
            g = collective.get_group(0)
        return g if g.nranks > 1 and collective._live(g) else None

    def forward(self, x):
        group = self._sync_group() if self.training \
            and not self._use_global_stats else None
        if group is None:
            return super().forward(x)
        return F.norm.sync_batch_norm(
            x, self._mean, self._variance, self.weight, self.bias, group,
            momentum=self._momentum, epsilon=self._epsilon,
            data_format=self._data_format)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm in it (itself included) made a
        ``SyncBatchNorm`` holding the same values."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      data_format=layer._data_format)
            out.to(layer._mean.device)
            out.set_state_dict(layer.state_dict())
        for name, sub in list(layer.named_children()):
            out.add_module(name, cls.convert_sync_batchnorm(sub))
        return out


class LayerNorm(Layer):
    """Layer norm over the trailing ``normalized_shape`` dims; weight
    starts at ones, bias at zeros (``*_attr=False`` leaves either out)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = float(epsilon)
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr, dtype=dtype,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter(
            self._normalized_shape, attr=bias_attr, dtype=dtype,
            is_bias=True, device=device)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    """``y = cast(x / rms(x)) * weight``; the weight starts at ones."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self._epsilon = float(epsilon)
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr, dtype=dtype,
            default_initializer=I.Constant(1.0), device=device)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups, self._epsilon = num_groups, epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon, self._data_format = epsilon, data_format
        self.scale = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma from ``power_iters`` power iterations on
    ``weight`` read as ``[shape[axis], -1]`` from the (untrained,
    not updated) ``weight_u`` ``[shape[axis]]`` and ``weight_v``."""

    def __init__(self, weight_shape, axis=0, power_iters=1, epsilon=1e-12,
                 name=None, dtype="float32"):
        super().__init__()
        self._axis, self._power_iters = axis, power_iters
        self._epsilon = epsilon
        h = weight_shape[axis]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != axis:
                w *= s
        self.weight_u = self.create_parameter(
            [h], default_initializer=I.Normal(0.0, 1.0))
        self.weight_u.requires_grad_(False)
        self.weight_v = self.create_parameter(
            [w], default_initializer=I.Normal(0.0, 1.0))
        self.weight_v.requires_grad_(False)

    def forward(self, weight):
        axis, eps = self._axis, self._epsilon
        w_mat = torch.movedim(weight, axis, 0).reshape(weight.shape[axis], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v = w_mat.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = w_mat @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
        return weight / (u @ w_mat @ v)
