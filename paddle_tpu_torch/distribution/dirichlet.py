"""Dirichlet distribution (port of
``paddle_tpu/distribution/dirichlet.py``)."""
from __future__ import annotations

import torch

from .distribution import _params, standard_gamma
from .exponential_family import ExponentialFamily

__all__ = ["Dirichlet"]


class Dirichlet(ExponentialFamily):
    def __init__(self, concentration, *, device=None):
        (self.concentration,) = _params(concentration, device=device)
        if self.concentration.dim() < 1:
            raise ValueError(
                "concentration must be at least 1-dimensional")
        self._dev = self.concentration.device
        super().__init__(
            batch_shape=tuple(self.concentration.shape[:-1]),
            event_shape=tuple(self.concentration.shape[-1:]))

    @property
    def mean(self):
        c = self.concentration
        return c / c.sum(dim=-1, keepdim=True)

    @property
    def variance(self):
        c = self.concentration
        c0 = c.sum(dim=-1, keepdim=True)
        return c * (c0 - c) / (c0 * c0 * (c0 + 1))

    def sample(self, shape=()):
        """Normalised gamma draws, differentiable in the concentration
        (the implicit gradient), as ``jax.random.dirichlet`` is."""
        shp = tuple(shape) + self.batch_shape + self.event_shape
        g = standard_gamma(self.concentration.expand(shp))
        return g / g.sum(dim=-1, keepdim=True)

    def entropy(self):
        c = self.concentration
        k = c.shape[-1]
        c0 = c.sum(dim=-1)
        lnB = torch.lgamma(c).sum(dim=-1) - torch.lgamma(c0)
        return (lnB + (c0 - k) * torch.digamma(c0)
                - ((c - 1) * torch.digamma(c)).sum(dim=-1))

    def log_prob(self, value):
        v = self._value(value)
        c = self.concentration
        lnB = torch.lgamma(c).sum(dim=-1) - torch.lgamma(c.sum(dim=-1))
        return ((c - 1) * torch.log(v)).sum(dim=-1) - lnB

    @property
    def _natural_parameters(self):
        # p(x) = exp(<alpha - 1, log x> - ln B(alpha)): theta = alpha - 1
        return (self.concentration - 1.0,)

    def _log_normalizer(self, x):
        a = x + 1.0
        return torch.lgamma(a).sum(dim=-1) - torch.lgamma(a.sum(dim=-1))
