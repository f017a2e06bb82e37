"""Operators of the port: attention (plain versions and the CUDA kernel
dispatch, forward and backward, ``ops.attention`` and
``ops.cached_attention``), the fused LM-head cross-entropy
(``ops.fused``), rotary embedding, and the kernel loader
(``ops.kernels``)."""
from .attention import flash_attention
from .fused import fused_linear_cross_entropy
from .rotary import rotary_embedding

__all__ = ["flash_attention", "fused_linear_cross_entropy",
           "rotary_embedding"]
