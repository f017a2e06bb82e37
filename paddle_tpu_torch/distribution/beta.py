"""Beta distribution (port of ``paddle_tpu/distribution/beta.py``)."""
from __future__ import annotations

import torch

from .distribution import _params, _shape, betaln, standard_gamma
from .exponential_family import ExponentialFamily

__all__ = ["Beta"]


class Beta(ExponentialFamily):
    def __init__(self, alpha, beta, *, device=None):
        self.alpha, self.beta = _params(alpha, beta, device=device)
        self._dev = self.alpha.device
        super().__init__(batch_shape=_shape(self.alpha, self.beta))

    @property
    def mean(self):
        return self.alpha / (self.alpha + self.beta)

    @property
    def variance(self):
        s = self.alpha + self.beta
        return self.alpha * self.beta / (s * s * (s + 1))

    def sample(self, shape=()):
        """``G_a / (G_a + G_b)`` over two gamma draws, differentiable in
        ``alpha`` and ``beta`` (their implicit gradients), as
        ``jax.random.beta`` is."""
        shp = self._extend_shape(tuple(shape))
        ga = standard_gamma(self.alpha.expand(shp))
        gb = standard_gamma(self.beta.expand(shp))
        return ga / (ga + gb)

    def entropy(self):
        a, b = self.alpha, self.beta
        s = a + b
        return (betaln(a, b) - (a - 1) * torch.digamma(a)
                - (b - 1) * torch.digamma(b) + (s - 2) * torch.digamma(s))

    def log_prob(self, value):
        v = self._value(value)
        return ((self.alpha - 1) * torch.log(v)
                + (self.beta - 1) * torch.log1p(-v)
                - betaln(self.alpha, self.beta))

    def prob(self, value):
        return torch.exp(self.log_prob(value))

    @property
    def _natural_parameters(self):
        # p(x) = exp((a-1) log x + (b-1) log(1-x) - ln B(a, b))
        return (self.alpha - 1.0, self.beta - 1.0)

    def _log_normalizer(self, x, y):
        return betaln(x + 1.0, y + 1.0)
