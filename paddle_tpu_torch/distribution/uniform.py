"""Uniform distribution (port of ``paddle_tpu/distribution/uniform.py``):
``U(low, high)`` on ``[low, high)``."""
from __future__ import annotations

import torch

from .distribution import Distribution, _params, _shape, uniforms

__all__ = ["Uniform"]


class Uniform(Distribution):
    def __init__(self, low, high, name=None, *, device=None):
        self.low, self.high = _params(low, high, device=device)
        self._dev = self.low.device
        self.name = name or "Uniform"
        super().__init__(batch_shape=_shape(self.low, self.high))

    @property
    def mean(self):
        return (self.low + self.high) / 2

    @property
    def variance(self):
        return (self.high - self.low) ** 2 / 12

    def sample(self, shape=(), seed=0):
        with torch.no_grad():
            return self.rsample(shape)

    def rsample(self, shape=()):
        shp = self._extend_shape(tuple(shape))
        u = uniforms(shp, torch.promote_types(self.low.dtype,
                                              self.high.dtype), self._dev)
        return self.low + (self.high - self.low) * u

    def entropy(self):
        return torch.log(self.high - self.low)

    def _inside(self, v):
        return (v >= self.low) & (v < self.high)

    def log_prob(self, value):
        v = self._value(value)
        lp = -torch.log(self.high - self.low)
        return torch.where(self._inside(v), lp, torch.full_like(
            lp, float("-inf")))

    def probs(self, value):
        v = self._value(value)
        p = 1.0 / (self.high - self.low)
        return torch.where(self._inside(v), p, torch.zeros_like(p))

    def kl_divergence(self, other):
        if not isinstance(other, Uniform):
            raise TypeError("Uniform.kl_divergence expects a Uniform")
        return torch.log((other.high - other.low)
                         / (self.high - self.low))
