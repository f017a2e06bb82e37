"""``paddle.autograd``: the gradient functions and custom autograd.

Port of ``paddle_tpu/autograd/__init__.py``.  ``backward``, ``grad`` and
the grad-mode switches are torch's own (the JAX package re-exports its
tape's); :class:`PyLayer` (:mod:`.py_layer`) is a user forward and
backward on a ``torch.autograd.Function``.
"""
import torch

from ..tensor import enable_grad, grad, is_grad_enabled, no_grad, \
    set_grad_enabled
from .py_layer import LegacyPyLayer, PyLayer, PyLayerContext

backward = torch.autograd.backward

__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "PyLayer", "PyLayerContext", "LegacyPyLayer"]
