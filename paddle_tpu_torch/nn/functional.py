"""Functional layers of the port: ``dropout``.

Port of ``paddle_tpu/nn/functional/common.py`` ``dropout`` (:39-60).  The
mask comes from the device's dropout generator (:mod:`..rng`, Philox) in
plain tensor ops, as the JAX package draws it with ``jax.random`` in XLA
ops: no kernel.  The bits differ from the JAX package's; the law, the
``1/(1-p)`` scale and the ``p == 0``, ``p == 1`` and ``training=False``
branches are the same.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from .. import rng as rng_mod
from ..amp.auto_cast import amp_op

__all__ = ["dropout"]

_MODES = ("upscale_in_train", "downscale_in_infer")


def dropout(x: torch.Tensor, p: float = 0.5,
            axis: Union[None, int, Sequence[int]] = None,
            training: bool = True, mode: str = "upscale_in_train",
            generator: Optional[rng_mod.Generator] = None) -> torch.Tensor:
    """Zero each element of ``x`` with probability ``p``.

    ``upscale_in_train`` divides what is kept by ``1 - p`` in training and
    returns ``x`` itself otherwise; ``downscale_in_infer`` keeps the kept
    values as they are in training and multiplies by ``1 - p`` otherwise.
    ``axis`` draws one keep bit for every index along those dims, shared
    over the others.  ``p == 0`` (or ``training=False`` under
    ``upscale_in_train``) returns ``x``; ``p == 1`` returns zeros.  One
    draw from ``generator`` (the default: ``x``'s device's) per call."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    rng_mod.keep_threshold(p)          # checks 0 <= p <= 1
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    return _dropout(x, p, axis, mode, generator)


@amp_op("dropout")
def _dropout(x, p, axis, mode, generator):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if p == 1.0:
        return torch.where(torch.zeros((), dtype=torch.bool,
                                       device=x.device), x, zero)
    gen = generator or rng_mod.default_generator(x.device)
    shape = list(x.shape)
    if axis is not None:
        axes = {a % x.dim() for a in ([axis] if isinstance(axis, int)
                                      else axis)}
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    out = torch.where(rng_mod.dropout_keep(gen.draw(), shape, p), x, zero)
    if mode == "upscale_in_train":
        out = out / (1.0 - p)
    return out
