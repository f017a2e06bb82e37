"""Categorical distribution (port of
``paddle_tpu/distribution/categorical.py``): ``logits`` are unnormalised
log-probabilities over the last axis; ``probs`` and ``log_prob`` pick by
index; ``sample`` draws int64 indices by inversion of the cumulative
probabilities (the JAX draws are int32)."""
from __future__ import annotations

import torch

from .distribution import Distribution, _numel, _params, uniforms

__all__ = ["Categorical"]


def _log_softmax(z):
    return torch.log_softmax(z, dim=-1)


def categorical_draw(logits: torch.Tensor, shape) -> torch.Tensor:
    """``shape + logits.shape[:-1]`` int64 category indices (one draw of
    the device's generator)."""
    p = torch.softmax(logits.detach().to(torch.float64), dim=-1)
    cdf = torch.cumsum(p, dim=-1)
    cdf = (cdf / cdf[..., -1:]).reshape(-1, p.shape[-1])   # [B, K]
    n = _numel(shape)
    u = uniforms((n, cdf.shape[0]), torch.float64, logits.device)
    idx = torch.searchsorted(cdf, u.t().contiguous(), right=True)  # [B, n]
    idx = idx.clamp(max=p.shape[-1] - 1)
    return idx.t().reshape(tuple(shape) + tuple(logits.shape[:-1]))


class Categorical(Distribution):
    def __init__(self, logits, name=None, *, device=None):
        (self.logits,) = _params(logits, device=device)
        self._dev = self.logits.device
        self.name = name or "Categorical"
        super().__init__(batch_shape=tuple(self.logits.shape[:-1]))

    def sample(self, shape=()):
        return categorical_draw(self.logits, tuple(shape))

    def entropy(self):
        lp = _log_softmax(self.logits)
        return -(torch.exp(lp) * lp).sum(dim=-1)

    def kl_divergence(self, other):
        if not isinstance(other, Categorical):
            raise TypeError("Categorical.kl_divergence expects a "
                            "Categorical")
        lp0, lp1 = _log_softmax(self.logits), _log_softmax(other.logits)
        return (torch.exp(lp0) * (lp0 - lp1)).sum(dim=-1, keepdim=True)

    def _pick(self, table, value):
        idx = torch.as_tensor(value, device=self._dev).to(torch.int64)
        if table.dim() == 1:
            return table[idx]
        return torch.take_along_dim(table, idx, dim=-1)

    def probs(self, value):
        return self._pick(torch.softmax(self.logits, dim=-1), value)

    def log_prob(self, value):
        return self._pick(_log_softmax(self.logits), value)
