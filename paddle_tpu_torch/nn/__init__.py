"""Layers of the port that PyTorch does not provide in the JAX package's
form: norms, dropout on the port's generator, gradient clipping."""
from . import functional
from .clip import (
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_,
)
from .common import Dropout
from .norm import LayerNorm, RMSNorm, layer_norm, rms_norm

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout", "LayerNorm", "RMSNorm", "clip_grad_norm_",
           "functional", "layer_norm", "rms_norm"]
