"""Bijective and injective tensor transforms (port of
``paddle_tpu/distribution/transform.py``): each has ``forward``,
``inverse``, the log-det-Jacobian both ways, and shape propagation;
:class:`~.transformed_distribution.TransformedDistribution` composes
them with a base distribution.  All are torch ops, so transformed
log-probabilities are differentiable (``StackTransform`` too, whose JAX
split and concatenation leave the tape)."""
from __future__ import annotations

import enum
import functools
import math
import operator

import torch
import torch.nn.functional as F

from .distribution import _param

__all__ = [
    "Transform", "AbsTransform", "AffineTransform", "ChainTransform",
    "ExpTransform", "IndependentTransform", "PowerTransform",
    "ReshapeTransform", "SigmoidTransform", "SoftmaxTransform",
    "StackTransform", "StickBreakingTransform", "TanhTransform",
]


class Type(enum.Enum):
    BIJECTION = "bijection"
    INJECTION = "injection"
    SURJECTION = "surjection"
    OTHER = "other"

    @classmethod
    def is_injective(cls, t):
        return t in (cls.BIJECTION, cls.INJECTION)


class Transform:
    _type = Type.OTHER

    # event dims consumed and produced (0: elementwise)
    _domain_event_rank = 0
    _codomain_event_rank = 0

    def _is_injective(self):
        # per instance: Chain and Stack take theirs from their members
        return Type.is_injective(self._type)

    def __call__(self, x):
        if isinstance(x, Transform):
            return ChainTransform([x, self])
        return self.forward(x)

    def forward(self, x):
        return self._forward(_param(x))

    def inverse(self, y):
        return self._inverse(_param(y))

    def forward_log_det_jacobian(self, x):
        if hasattr(self, "_forward_log_det_jacobian"):
            return self._forward_log_det_jacobian(_param(x))
        if hasattr(self, "_inverse_log_det_jacobian"):
            return -self._inverse_log_det_jacobian(self.forward(x))
        raise NotImplementedError

    def inverse_log_det_jacobian(self, y):
        if hasattr(self, "_inverse_log_det_jacobian"):
            return self._inverse_log_det_jacobian(_param(y))
        # the forward log-det at the preimage, negated (also for a
        # subclass that overrides the public forward_log_det_jacobian)
        return -self.forward_log_det_jacobian(self.inverse(y))

    def forward_shape(self, shape):
        return tuple(shape)

    def inverse_shape(self, shape):
        return tuple(shape)


def _softplus(v):
    return F.softplus(v)


class AbsTransform(Transform):
    """``y = |x|``, onto ``[0, inf)``; the inverse is the positive
    preimage, as the reference's."""
    _type = Type.SURJECTION

    def _forward(self, x):
        return torch.abs(x)

    def _inverse(self, y):
        return y


class AffineTransform(Transform):
    """``y = loc + scale · x``."""
    _type = Type.BIJECTION

    def __init__(self, loc, scale):
        self.loc = _param(loc)
        self.scale = _param(scale, self.loc.device)

    def forward(self, x):
        return self.loc + self.scale * _param(x)

    def inverse(self, y):
        return (_param(y) - self.loc) / self.scale

    def _log_abs_scale(self, v):
        ls = torch.log(torch.abs(self.scale))
        return ls.expand(torch.broadcast_shapes(v.shape, ls.shape))

    def forward_log_det_jacobian(self, x):
        return self._log_abs_scale(_param(x))

    def inverse_log_det_jacobian(self, y):
        return -self._log_abs_scale(_param(y))


class ExpTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def _forward_log_det_jacobian(self, x):
        return x


class PowerTransform(Transform):
    """``y = x ** power`` on ``x > 0``."""
    _type = Type.BIJECTION

    def __init__(self, power):
        self.power = _param(power)

    def forward(self, x):
        return torch.pow(_param(x), self.power)

    def inverse(self, y):
        return torch.pow(_param(y), 1.0 / self.power)

    def forward_log_det_jacobian(self, x):
        p = self.power
        return torch.log(torch.abs(p * torch.pow(_param(x), p - 1)))


class SigmoidTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.sigmoid(x)

    def _inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def _forward_log_det_jacobian(self, x):
        # log sigmoid'(x) = -softplus(-x) - softplus(x)
        return -_softplus(-x) - _softplus(x)


class TanhTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.tanh(x)

    def _inverse(self, y):
        return torch.atanh(y)

    def _forward_log_det_jacobian(self, x):
        # log(1 - tanh^2 x) = 2 (log 2 - x - softplus(-2x))
        return 2.0 * (math.log(2.0) - x - _softplus(-2.0 * x))


class SoftmaxTransform(Transform):
    """``y = softmax(x)`` over the last axis, onto the simplex."""
    _type = Type.OTHER
    _domain_event_rank = 1
    _codomain_event_rank = 1

    def _forward(self, x):
        return torch.softmax(x, dim=-1)

    def _inverse(self, y):
        return torch.log(y)


def _offsets(k: int, like: torch.Tensor) -> torch.Tensor:
    """``log(k), log(k - 1), ..., log(1)``."""
    return torch.log(torch.arange(k, 0, -1, dtype=like.dtype,
                                  device=like.device))


class StickBreakingTransform(Transform):
    """``R^{K-1}`` onto the open simplex in ``R^K`` by stick breaking."""
    _type = Type.BIJECTION
    _domain_event_rank = 1
    _codomain_event_rank = 1

    def _forward(self, x):
        z = torch.sigmoid(x - _offsets(x.shape[-1], x))
        zc = torch.cumprod(1 - z, dim=-1)
        ones = torch.ones_like(x[..., :1])
        return torch.cat([z, ones], dim=-1) * torch.cat([ones, zc], dim=-1)

    def _inverse(self, y):
        y_crop = y[..., :-1]
        sf = 1.0 - torch.cumsum(y_crop, dim=-1)
        sf = torch.cat([torch.ones_like(y[..., :1]), sf[..., :-1]], dim=-1)
        z = y_crop / sf
        return torch.log(z) - torch.log1p(-z) + _offsets(y_crop.shape[-1],
                                                         y)

    def _forward_log_det_jacobian(self, x):
        u = x - _offsets(x.shape[-1], x)
        log_z = -_softplus(-u)
        log_1mz_cum = torch.cumsum(-_softplus(u), dim=-1)
        shifted = torch.cat([torch.zeros_like(x[..., :1]),
                             log_1mz_cum[..., :-1]], dim=-1)
        return (log_z + shifted).sum(dim=-1)

    def forward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)

    def inverse_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)


class ReshapeTransform(Transform):
    _type = Type.BIJECTION

    def __init__(self, in_event_shape, out_event_shape):
        self._in = tuple(in_event_shape)
        self._out = tuple(out_event_shape)
        if functools.reduce(operator.mul, self._in, 1) != functools.reduce(
                operator.mul, self._out, 1):
            raise ValueError("event sizes must match")
        self._domain_event_rank = len(self._in)
        self._codomain_event_rank = len(self._out)

    @property
    def in_event_shape(self):
        return self._in

    @property
    def out_event_shape(self):
        return self._out

    def _forward(self, x):
        return x.reshape(tuple(x.shape[:x.dim() - len(self._in)])
                         + self._out)

    def _inverse(self, y):
        return y.reshape(tuple(y.shape[:y.dim() - len(self._out)])
                         + self._in)

    def _forward_log_det_jacobian(self, x):
        return x.new_zeros(tuple(x.shape[:x.dim() - len(self._in)]))

    def forward_shape(self, shape):
        n = len(self._in)
        if tuple(shape[len(shape) - n:]) != self._in:
            raise ValueError(f"shape {shape} does not end in {self._in}")
        return tuple(shape[:len(shape) - n]) + self._out

    def inverse_shape(self, shape):
        n = len(self._out)
        if tuple(shape[len(shape) - n:]) != self._out:
            raise ValueError(f"shape {shape} does not end in {self._out}")
        return tuple(shape[:len(shape) - n]) + self._in


class IndependentTransform(Transform):
    """A base transform with batch dims promoted to event dims (its
    log-det summed over them)."""

    def __init__(self, base, reinterpreted_batch_rank):
        if not isinstance(base, Transform):
            raise TypeError("base must be a Transform")
        self.base = base
        self.rank = int(reinterpreted_batch_rank)
        self._type = base._type
        self._domain_event_rank = base._domain_event_rank + self.rank
        self._codomain_event_rank = base._codomain_event_rank + self.rank

    def forward(self, x):
        return self.base.forward(x)

    def inverse(self, y):
        return self.base.inverse(y)

    def _sum(self, v):
        return v.sum(dim=tuple(range(v.dim() - self.rank, v.dim())))

    def forward_log_det_jacobian(self, x):
        return self._sum(self.base.forward_log_det_jacobian(x))

    def inverse_log_det_jacobian(self, y):
        return self._sum(self.base.inverse_log_det_jacobian(y))

    def forward_shape(self, shape):
        return self.base.forward_shape(shape)

    def inverse_shape(self, shape):
        return self.base.inverse_shape(shape)


class ChainTransform(Transform):
    """``t_n(...t_1(x))``; the log-dets add."""

    def __init__(self, transforms):
        if isinstance(transforms, Transform):
            transforms = [transforms]
        for t in transforms:
            if not isinstance(t, Transform):
                raise TypeError("all elements must be Transforms")
        self.transforms = list(transforms)
        self._type = (Type.BIJECTION if all(
            t._type == Type.BIJECTION for t in self.transforms)
            else Type.OTHER if any(not t._is_injective()
                                   for t in self.transforms)
            else Type.INJECTION)
        self._domain_event_rank = max(
            (t._domain_event_rank for t in self.transforms), default=0)
        self._codomain_event_rank = max(
            (t._codomain_event_rank for t in self.transforms), default=0)

    def forward(self, x):
        for t in self.transforms:
            x = t.forward(x)
        return x

    def inverse(self, y):
        for t in reversed(self.transforms):
            y = t.inverse(y)
        return y

    def forward_log_det_jacobian(self, x):
        total = None
        for t in self.transforms:
            ldj = t.forward_log_det_jacobian(x)
            total = ldj if total is None else total + ldj
            x = t.forward(x)
        return total

    def inverse_log_det_jacobian(self, y):
        total = None
        for t in reversed(self.transforms):
            ldj = t.inverse_log_det_jacobian(y)
            total = ldj if total is None else total + ldj
            y = t.inverse(y)
        return total

    def forward_shape(self, shape):
        for t in self.transforms:
            shape = t.forward_shape(shape)
        return tuple(shape)

    def inverse_shape(self, shape):
        for t in reversed(self.transforms):
            shape = t.inverse_shape(shape)
        return tuple(shape)


class StackTransform(Transform):
    """A list of transforms, each on its equal slice along ``axis``."""

    def __init__(self, transforms, axis=0):
        for t in transforms:
            if not isinstance(t, Transform):
                raise TypeError("all elements must be Transforms")
        self.transforms = list(transforms)
        self.axis = int(axis)
        self._type = (Type.BIJECTION if all(
            t._type == Type.BIJECTION for t in self.transforms)
            else Type.OTHER)

    def _map(self, fn, x):
        parts = torch.chunk(_param(x), len(self.transforms), dim=self.axis)
        return torch.cat([fn(t, p) for t, p in zip(self.transforms, parts)],
                         dim=self.axis)

    def forward(self, x):
        return self._map(lambda t, p: t.forward(p), x)

    def inverse(self, y):
        return self._map(lambda t, p: t.inverse(p), y)

    def forward_log_det_jacobian(self, x):
        return self._map(lambda t, p: t.forward_log_det_jacobian(p), x)
