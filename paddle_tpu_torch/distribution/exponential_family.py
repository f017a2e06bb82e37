"""The exponential-family base (port of
``paddle_tpu/distribution/exponential_family.py``): the entropy as a
Bregman divergence over the log normaliser ``F``,
``H = F(θ) - <θ, ∇F(θ)> - E[log h(x)]``, its gradient term taken by
``torch.autograd.grad`` with ``create_graph`` (so the entropy stays
differentiable in the parameters)."""
from __future__ import annotations

import torch

from .distribution import Distribution

__all__ = ["ExponentialFamily"]


def _grad_of_normalizer(dist, theta):
    """``theta`` made differentiable, and ``∇F(theta)`` (kept in the
    graph)."""
    theta = [t if t.requires_grad else t.detach().requires_grad_()
             for t in theta]
    with torch.enable_grad():
        total = dist._log_normalizer(*theta).sum()
        grads = torch.autograd.grad(total, theta, create_graph=True)
    return theta, grads


class ExponentialFamily(Distribution):
    @property
    def _natural_parameters(self):
        raise NotImplementedError

    def _log_normalizer(self, *natural_parameters):
        raise NotImplementedError

    @property
    def _mean_carrier_measure(self):
        return 0.0

    def entropy(self):
        """``F(θ) - <θ, ∇F(θ)> - E[log h(x)]``."""
        given = list(self._natural_parameters)
        theta, grads = _grad_of_normalizer(self, given)
        with torch.enable_grad():
            result = self._log_normalizer(*theta) - \
                self._mean_carrier_measure
            for t, g in zip(theta, grads):
                term = t * g
                if term.shape != result.shape:
                    term = term.sum(dim=-1)
                result = result - term
        if torch.is_grad_enabled() and any(t.requires_grad for t in given):
            return result
        return result.detach()
