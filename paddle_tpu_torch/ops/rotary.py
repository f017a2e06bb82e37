"""Rotary position embedding (rotate-half), port of ``rotary_embedding``
from ``paddle_tpu/ops/pallas/__init__.py``.

The rotation is computed in f32 and cast back to the input dtype.  In
bf16 this differs from the JAX package, where ``q * cos`` promotes to f32
and stays there; in f32 the two are the same arithmetic.
"""
from __future__ import annotations

from typing import Optional

import torch

from ._helpers import wrap_public

__all__ = ["rotary_embedding"]


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rotary_embedding(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor,
                     position_ids: Optional[torch.Tensor] = None):
    """Rotate ``q``/``k`` ``[B, S, H, D]`` by the ``[T, D]`` f32 tables.

    Without ``position_ids`` the rows ``0..S-1`` are used; with them
    (``[B, S]`` int, e.g. a decode slot's current offset) each token takes
    its own row.  Returns ``(q, k)`` in their input dtypes."""
    if position_ids is None:
        S = q.shape[1]
        c = cos[:S][None, :, None, :]
        s = sin[:S][None, :, None, :]
    else:
        pos = position_ids.long()
        c = cos[pos][:, :, None, :]
        s = sin[pos][:, :, None, :]

    def rot(x):
        xf = x.float()
        return (xf * c + _rotate_half(xf) * s).to(x.dtype)

    return rot(q), rot(k)


wrap_public(globals())
