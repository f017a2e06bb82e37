"""TransformedDistribution (port of
``paddle_tpu/distribution/transformed_distribution.py``)."""
from __future__ import annotations

from .distribution import Distribution
from .transform import ChainTransform, Transform

__all__ = ["TransformedDistribution"]


def _sum_rightmost(e, n: int):
    return e if n <= 0 else e.sum(dim=tuple(range(e.dim() - n, e.dim())))


class TransformedDistribution(Distribution):
    def __init__(self, base, transforms):
        if not isinstance(base, Distribution):
            raise TypeError("base must be a Distribution")
        if isinstance(transforms, Transform):
            transforms = [transforms]
        for t in transforms:
            if not isinstance(t, Transform):
                raise TypeError("all transforms must be Transform instances")
        self._base = base
        self._dev = base._dev
        self._transforms = list(transforms)
        chain = ChainTransform(self._transforms)
        out_shape = chain.forward_shape(base.batch_shape + base.event_shape)
        event_rank = max(chain._codomain_event_rank, len(base.event_shape))
        cut = len(out_shape) - event_rank
        super().__init__(batch_shape=tuple(out_shape[:cut]),
                         event_shape=tuple(out_shape[cut:]))

    def sample(self, shape=()):
        x = self._base.sample(shape)
        for t in self._transforms:
            x = t.forward(x)
        return x

    def rsample(self, shape=()):
        x = self._base.rsample(shape)
        for t in self._transforms:
            x = t.forward(x)
        return x

    def log_prob(self, value):
        """``log p(y) = log p_base(x) - Σ log|det J_t(x)|`` with ``x =
        t⁻¹(y)``, each transform's event dims summed out."""
        log_det = None
        y = self._value(value)
        event_rank = len(self.event_shape)
        for t in reversed(self._transforms):
            x = t.inverse(y)
            term = _sum_rightmost(t.forward_log_det_jacobian(x),
                                  event_rank - t._codomain_event_rank)
            log_det = term if log_det is None else log_det + term
            y = x
            event_rank = t._domain_event_rank + max(
                event_rank - t._codomain_event_rank, 0)
        base_lp = _sum_rightmost(self._base.log_prob(y),
                                 event_rank - len(self._base.event_shape))
        return base_lp if log_det is None else base_lp - log_det
