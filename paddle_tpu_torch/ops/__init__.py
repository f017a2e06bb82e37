"""Operators of the port.

Paddle's tensor-op surface as plain functions on ``torch.Tensor``
(:mod:`.creation`, :mod:`.math`, :mod:`.manipulation`, :mod:`.logic`,
:mod:`.search`, :mod:`.linalg`, :mod:`.random`, :mod:`.misc`; their
argument rules in :mod:`._helpers`), re-exported at the package's top
level as ``paddle.concat`` and the rest; attention (plain versions and
the CUDA kernel dispatch, forward and backward, ``ops.attention`` and
``ops.cached_attention``), the fused LM-head cross-entropy
(``ops.fused``), rotary embedding, and the kernel loader
(``ops.kernels``)."""
from . import creation, linalg, logic, manipulation, math, misc, search
from . import random as random_ops
from .attention import flash_attention
from .creation import *  # noqa: F401,F403
from .fused import fused_linear_cross_entropy
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .misc import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .rotary import rotary_embedding
from .search import *  # noqa: F401,F403

#: the ``paddle.*`` op surface (as the JAX package's star imports order
#: it: misc's complex ops over math's)
OPS = sorted(set(creation.__all__ + math.__all__ + manipulation.__all__
                 + linalg.__all__ + logic.__all__ + random_ops.__all__
                 + search.__all__ + misc.__all__))

__all__ = ["flash_attention", "fused_linear_cross_entropy",
           "rotary_embedding", "OPS"] + OPS
