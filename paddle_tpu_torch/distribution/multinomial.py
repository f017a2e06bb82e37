"""Multinomial distribution (port of
``paddle_tpu/distribution/multinomial.py``)."""
from __future__ import annotations

import torch

from .categorical import categorical_draw
from .distribution import Distribution, _params

__all__ = ["Multinomial"]


class Multinomial(Distribution):
    def __init__(self, total_count, probs, *, device=None):
        if int(total_count) < 1:
            raise ValueError("total_count must be >= 1")
        self.total_count = int(total_count)
        (p,) = _params(probs, device=device)
        # normalised, as the reference does (probs need not sum to 1)
        self.probs = p / p.sum(dim=-1, keepdim=True)
        self._dev = self.probs.device
        super().__init__(batch_shape=tuple(self.probs.shape[:-1]),
                         event_shape=tuple(self.probs.shape[-1:]))

    @property
    def mean(self):
        return self.total_count * self.probs

    @property
    def variance(self):
        return self.total_count * self.probs * (1 - self.probs)

    def sample(self, shape=()):
        """Counts of ``total_count`` categorical draws (one draw of the
        device's generator), in the probabilities' dtype."""
        n, k = self.total_count, self.probs.shape[-1]
        shp = tuple(shape) + self.batch_shape
        draws = categorical_draw(torch.log(self.probs), (n,) + tuple(shape))
        counts = self.probs.new_zeros(shp + (k,))
        return counts.scatter_add_(-1, draws.movedim(0, -1),
                                   torch.ones_like(counts[..., :1]).expand(
                                       shp + (n,)))

    def entropy(self):
        """Exact: ``-log n! - n Σ p log p + Σ_i E[log x_i!]``, each ``x_i``
        binomial ``(n, p_i)``."""
        n, p = self.total_count, self.probs
        k = torch.arange(n + 1, dtype=p.dtype, device=p.device)
        lg_n1 = torch.lgamma(torch.tensor(float(n + 1), dtype=p.dtype,
                                          device=p.device))
        log_binom = lg_n1 - torch.lgamma(k + 1) - torch.lgamma(n - k + 1)
        pe = p[..., None]
        log_pmf = log_binom + k * torch.log(pe) + (n - k) * torch.log1p(-pe)
        e_log_fact = (torch.exp(log_pmf) * torch.lgamma(k + 1)).sum(dim=-1)
        return (-lg_n1 - n * (p * torch.log(p)).sum(dim=-1)
                + e_log_fact.sum(dim=-1))

    def log_prob(self, value):
        v = self._value(value)
        n, p = self.total_count, self.probs
        lg_n1 = torch.lgamma(torch.tensor(float(n + 1), dtype=p.dtype,
                                          device=p.device))
        return (lg_n1 - torch.lgamma(v + 1).sum(dim=-1)
                + (v * torch.log(p)).sum(dim=-1))
