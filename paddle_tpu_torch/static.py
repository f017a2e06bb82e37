"""``paddle.static``: only ``InputSpec``, the class of :mod:`.jit`, as
the JAX package's tests spell it (``paddle.static.InputSpec``)."""
from .jit import InputSpec

__all__ = ["InputSpec"]
