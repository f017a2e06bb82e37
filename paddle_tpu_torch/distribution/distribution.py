"""The distribution base class (port of
``paddle_tpu/distribution/distribution.py``).

Parameters are tensors on one device: a tensor keeps its device and its
floating dtype (an integer one takes the default dtype); anything else
is made on the device of the first tensor parameter, or of ``device=``,
or the port's current device, in the default dtype (float64 data too, as
``to_tensor`` makes it).  All math is torch ops, so ``log_prob``,
``entropy`` and ``rsample`` are differentiable.  Draws come from the
device's Philox generator (:func:`paddle_tpu_torch.rng.default_generator`,
seeded by ``paddle.seed``), never torch's global one: each draw advances
the generator's offset on the device, so a draw inside a ``jit.to_static``
CUDA graph gives fresh values at every replay, as the JAX package's
functional key does inside ``to_static``.

Gamma variates (Beta, Dirichlet) are Marsaglia and Tsang's method with a
fixed number of candidate rounds (:data:`GAMMA_ROUNDS`), so a draw has
fixed shapes inside a CUDA graph, and their gradient with respect to the
concentration is the implicit one (``d x / d alpha = -(dF/dalpha) /
f(x)``), as ``jax.random.gamma``'s is.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops._helpers import device_of, get_default_dtype
from ..ops.random import _numel, _uniform01

__all__ = ["Distribution"]

#: Marsaglia-Tsang candidate rounds a gamma draw takes (each accepted with
#: probability above 0.95 for a shape of 1 or more, so all 12 miss with
#: probability below 0.05 ** 12)
GAMMA_ROUNDS = 12


def _param(x, device=None) -> torch.Tensor:
    """``x`` as a floating tensor (see the module's docstring)."""
    if isinstance(x, torch.Tensor):
        if not (x.is_floating_point() or x.is_complex()):
            x = x.to(get_default_dtype())
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device_of(
        device=device)).to(get_default_dtype())


def _params(*xs, device=None):
    """Each of ``xs`` as :func:`_param` makes it, all on one device."""
    dev = device_of(*xs, device=device)
    return [_param(x, dev) for x in xs]


def _shape(*ts) -> tuple:
    return tuple(torch.broadcast_shapes(*(t.shape for t in ts)))


def uniforms(shape, dtype, device) -> torch.Tensor:
    """Uniforms in ``[0, 1)`` of ``shape`` (one draw of the device's
    generator)."""
    work = torch.float64 if dtype == torch.float64 else torch.float32
    return _uniform01(_numel(shape), device, work).reshape(
        tuple(shape)).to(dtype)


def normals(shape, dtype, device) -> torch.Tensor:
    """Standard normals (Box-Muller over one draw of two uniforms an
    element)."""
    u = uniforms((2,) + tuple(shape), dtype, device)
    return torch.sqrt(-2.0 * torch.log1p(-u[0])) * torch.cos(
        2.0 * math.pi * u[1])


def _gamma_draw(alpha: torch.Tensor) -> torch.Tensor:
    """Standard gamma variates of shape ``alpha`` (each element its own
    shape parameter): ``GAMMA_ROUNDS`` candidates of Marsaglia and Tsang
    at ``alpha`` (``alpha + 1`` below 1, then scaled by ``U ** (1 /
    alpha)``); the first accepted candidate of each element is kept."""
    a = alpha.detach()
    boost = a < 1
    ab = torch.where(boost, a + 1, a)
    d = ab - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    out = torch.zeros_like(a)
    done = torch.zeros_like(a, dtype=torch.bool)
    for _ in range(GAMMA_ROUNDS):
        u = uniforms((3,) + tuple(a.shape), a.dtype, a.device)
        z = torch.sqrt(-2.0 * torch.log1p(-u[0])) * torch.cos(
            2.0 * math.pi * u[1])
        v = (1.0 + c * z) ** 3
        vs = torch.where(v > 0, v, torch.ones_like(v))
        ok = (v > 0) & (torch.log(u[2]) < 0.5 * z * z + d - d * vs
                        + d * torch.log(vs))
        out = torch.where(ok & ~done, d * vs, out)
        done = done | ok
    u = uniforms(a.shape, a.dtype, a.device)
    scale = torch.exp(torch.log(u) / a)
    return torch.where(boost, out * scale, out)


class _Gamma(torch.autograd.Function):
    """A standard gamma draw with the implicit gradient to its shape."""

    @staticmethod
    def forward(ctx, alpha):
        x = _gamma_draw(alpha)
        ctx.save_for_backward(alpha, x)
        return x

    @staticmethod
    def backward(ctx, grad):
        alpha, x = ctx.saved_tensors
        return grad * torch._standard_gamma_grad(alpha, x)


def standard_gamma(alpha: torch.Tensor) -> torch.Tensor:
    """Standard gamma variates of shape ``alpha`` on its device,
    differentiable with respect to ``alpha``."""
    return _Gamma.apply(alpha)


def betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class Distribution:
    """The abstract base (reference ``distribution.py:40``)."""

    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(
            batch_shape.shape if isinstance(batch_shape, torch.Tensor)
            else batch_shape)
        self._event_shape = tuple(
            event_shape.shape if isinstance(event_shape, torch.Tensor)
            else event_shape)

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    @property
    def mean(self):
        raise NotImplementedError

    @property
    def variance(self):
        raise NotImplementedError

    def sample(self, shape=()):
        raise NotImplementedError

    def rsample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        from .kl import kl_divergence

        return kl_divergence(self, other)

    def log_prob(self, value):
        raise NotImplementedError

    def _value(self, value) -> torch.Tensor:
        """A value argument on this distribution's device."""
        return _param(value, self._dev)

    def prob(self, value):
        """``exp(log_prob(value))`` unless a subclass has a closed form."""
        return torch.exp(self.log_prob(self._value(value)))

    def probs(self, value):
        return self.prob(value)

    def _extend_shape(self, sample_shape):
        return tuple(sample_shape) + self.batch_shape + self.event_shape

    @staticmethod
    def _probs_to_logits(probs, is_binary=False):
        return torch.log(probs / (1.0 - probs)) if is_binary \
            else torch.log(probs)

    @staticmethod
    def _logits_to_probs(logits, is_binary=False):
        if is_binary:
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=-1)
