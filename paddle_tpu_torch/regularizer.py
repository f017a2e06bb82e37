"""``paddle.regularizer``: ``L1Decay`` and ``L2Decay``.

Port of ``paddle_tpu/regularizer.py``.  The optimizer folds a
regularizer's gradient term into the gradient before its update rule
(coupled decay, as the JAX optimizers do for SGD, Momentum and the rest
of that family): pass one as ``weight_decay=``, or on a parameter as
``ParamAttr(regularizer=)``, which then takes the optimizer's place for
that parameter.
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self) -> float:
        return self._coeff

    def __str__(self):
        return f"{type(self).__name__}, coeff={self._coeff}"

    def _grad_term(self, p: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    """``loss += coeff * sum(|p|)``: the gradient gains ``coeff *
    sign(p)``."""

    def _grad_term(self, p):
        return self._coeff * torch.sign(p)


class L2Decay(WeightDecayRegularizer):
    """``loss += 0.5 * coeff * sum(p ** 2)``: the gradient gains ``coeff *
    p``."""

    def _grad_term(self, p):
        return self._coeff * p
