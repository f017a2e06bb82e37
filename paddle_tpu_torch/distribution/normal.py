"""Normal distribution (port of ``paddle_tpu/distribution/normal.py``)."""
from __future__ import annotations

import math

import torch

from .distribution import Distribution, _params, _shape, normals

__all__ = ["Normal"]


class Normal(Distribution):
    def __init__(self, loc, scale, name=None, *, device=None):
        self.loc, self.scale = _params(loc, scale, device=device)
        self._dev = self.loc.device
        self.name = name or "Normal"
        super().__init__(batch_shape=_shape(self.loc, self.scale))

    @property
    def mean(self):
        return self.loc.expand(_shape(self.loc, self.scale))

    @property
    def variance(self):
        return (self.scale * self.scale).expand(
            _shape(self.loc, self.scale))

    @property
    def stddev(self):
        return self.scale.expand(_shape(self.loc, self.scale))

    def sample(self, shape=(), seed=0):
        with torch.no_grad():
            return self.rsample(shape)

    def rsample(self, shape=()):
        """``loc + scale · ε`` with ``ε`` standard normals of the device's
        generator (one draw)."""
        shp = self._extend_shape(tuple(shape))
        eps = normals(shp, torch.promote_types(self.loc.dtype,
                                               self.scale.dtype), self._dev)
        return self.loc + self.scale * eps

    def entropy(self):
        return (0.5 + 0.5 * math.log(2 * math.pi)
                + torch.log(self.scale)).expand(_shape(self.loc,
                                                       self.scale))

    def log_prob(self, value):
        v = self._value(value)
        var = self.scale * self.scale
        return (-((v - self.loc) ** 2) / (2 * var) - torch.log(self.scale)
                - 0.5 * math.log(2 * math.pi))

    def probs(self, value):
        v = self._value(value)
        var = self.scale * self.scale
        return torch.exp(-((v - self.loc) ** 2) / (2 * var)) / torch.sqrt(
            2 * math.pi * var)

    def kl_divergence(self, other):
        if not isinstance(other, Normal):
            raise TypeError("Normal.kl_divergence expects a Normal")
        ratio = self.scale / other.scale
        diff = (self.loc - other.loc) / other.scale
        return 0.5 * (ratio * ratio + diff * diff) - 0.5 - torch.log(ratio)
