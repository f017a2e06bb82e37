"""The norms under their earlier import path (now
:mod:`.functional.norm` and :mod:`.layer.norm`)."""
from .functional.norm import layer_norm, rms_norm
from .layer.norm import LayerNorm, RMSNorm

__all__ = ["rms_norm", "RMSNorm", "layer_norm", "LayerNorm"]
