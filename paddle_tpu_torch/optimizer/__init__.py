"""Optimizers and learning-rate schedulers of the port
(``paddle_tpu/optimizer``): :class:`Optimizer`, :class:`SGD`,
:class:`Adam`, :class:`AdamW` and :mod:`.lr`."""
from . import lr
from .optimizer import SGD, Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer", "SGD", "lr"]
