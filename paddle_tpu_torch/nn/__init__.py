"""Layers of the port that PyTorch does not provide in the JAX package's
form."""
from .norm import LayerNorm, RMSNorm, layer_norm, rms_norm

__all__ = ["LayerNorm", "RMSNorm", "layer_norm", "rms_norm"]
