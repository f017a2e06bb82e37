"""Independent (port of ``paddle_tpu/distribution/independent.py``): the
trailing batch dims of a base distribution read as event dims."""
from __future__ import annotations

from .distribution import Distribution

__all__ = ["Independent"]


class Independent(Distribution):
    def __init__(self, base, reinterpreted_batch_rank):
        if not isinstance(base, Distribution):
            raise TypeError("base must be a Distribution")
        rank = int(reinterpreted_batch_rank)
        if not 0 < rank <= len(base.batch_shape):
            raise ValueError(
                f"reinterpreted_batch_rank {rank} out of range for base "
                f"batch shape {base.batch_shape}")
        self._base = base
        self._dev = base._dev
        self._reinterpreted_batch_rank = rank
        shape = base.batch_shape + base.event_shape
        cut = len(base.batch_shape) - rank
        super().__init__(batch_shape=shape[:cut], event_shape=shape[cut:])

    @property
    def mean(self):
        return self._base.mean

    @property
    def variance(self):
        return self._base.variance

    def sample(self, shape=()):
        return self._base.sample(shape)

    def rsample(self, shape=()):
        return self._base.rsample(shape)

    def _sum_rightmost(self, e):
        r = self._reinterpreted_batch_rank
        return e.sum(dim=tuple(range(e.dim() - r, e.dim())))

    def entropy(self):
        return self._sum_rightmost(self._base.entropy())

    def log_prob(self, value):
        return self._sum_rightmost(self._base.log_prob(value))
