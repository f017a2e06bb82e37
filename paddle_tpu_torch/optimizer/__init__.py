"""Optimizers and learning-rate schedulers of the port
(``paddle_tpu/optimizer``): :class:`Optimizer` and its ten classes, and
:mod:`.lr`."""
from . import lr
from .optimizer import (
    SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Lars,
    LarsMomentumOptimizer, Momentum, Optimizer, RMSProp,
)

__all__ = ["Adadelta", "Adagrad", "Adam", "Adamax", "AdamW", "Lamb", "Lars",
           "LarsMomentumOptimizer", "Momentum", "Optimizer", "RMSProp", "SGD",
           "lr"]
