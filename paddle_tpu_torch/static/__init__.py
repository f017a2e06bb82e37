"""``paddle.static``: ``InputSpec`` (the class of :mod:`..jit`, as the JAX
package's tests spell it, ``paddle.static.InputSpec``) and the control
flow of :mod:`.nn` (``cond``, ``while_loop``, ``case``, ``switch_case``;
``paddle_tpu/static/__init__.py``).  The JAX package's program mode
(``static/program.py``) is not ported (ROADMAP.md A.5 step 7)."""
from ..jit import InputSpec
from . import nn
from .nn import case, cond, switch_case, while_loop

__all__ = ["InputSpec", "nn", "cond", "while_loop", "case", "switch_case"]
