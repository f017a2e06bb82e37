"""The rest of Paddle's tensor surface (port of ``paddle_tpu/ops/misc.py``):
``add_n``, ``slice``/``strided_slice``, ``quantile``, ``renorm``,
``multiplex``, the complex-number ops (which take precedence over
:mod:`.math`'s, as in the JAX package) and the in-place variants, each of
which writes ``x`` itself as torch's in-place ops do.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ._helpers import as_int_list
from .linalg import lu_unpack
from .math import _quantile

__all__ = [
    "add_n", "broadcast_shape", "check_shape", "diagonal", "is_complex",
    "is_floating_point", "is_integer", "logit", "multiplex", "nanquantile",
    "quantile", "rank", "renorm", "set_printoptions", "slice",
    "strided_slice", "tanh_", "tolist", "unstack", "real", "imag", "conj",
    "angle", "ceil_", "exp_", "floor_", "reciprocal_", "round_", "sqrt_",
    "erfinv_", "flatten_", "lerp_", "put_along_axis_", "lu_unpack",
]


def add_n(inputs, name=None):
    """The elementwise sum of a list of tensors."""
    if isinstance(inputs, torch.Tensor):
        return inputs
    out = inputs[0]
    for a in inputs[1:]:
        out = out + a
    return out


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def check_shape(shape):
    for s in as_int_list(shape):
        if s < -1 or s == 0:
            raise ValueError(f"invalid dim {s} in shape {shape}")
    return True


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2)


def is_complex(x) -> bool:
    return x.is_complex()


def is_floating_point(x) -> bool:
    return x.is_floating_point()


def is_integer(x) -> bool:
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def logit(x, eps=None, name=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def multiplex(inputs, index, name=None):
    """Row ``i`` of ``inputs[index[i]]``."""
    stacked = torch.stack(list(inputs), 0)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[index.reshape(-1).long(), rows]


def quantile(x, q, axis=None, keepdim=False, name=None):
    """Linear interpolation between the order statistics (``jnp.quantile``);
    a list ``q`` puts its axis first."""
    return _quantile(torch.quantile, x, q, axis, keepdim)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim)


def rank(input, name=None):
    """The number of dims as a 0-d int64 tensor."""
    return torch.full((), input.dim(), dtype=torch.int64,
                      device=input.device)


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` scaled down to p-norm ``max_norm`` where
    its norm is above it."""
    moved = torch.movedim(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.linalg.vector_norm(flat, ord=p, dim=1)
    scale = torch.where(norms > max_norm,
                        max_norm / torch.clamp(norms, min=1e-12),
                        torch.ones_like(norms))
    return torch.movedim((flat * scale[:, None]).reshape(moved.shape), 0,
                         axis)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """torch's print options (a tensor's repr)."""
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)


def _sliced(x, axes, starts, ends, strides):
    idx = [builtins.slice(None)] * x.dim()
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[ax] = builtins.slice(st, en, sd)
    if builtins.all((s.step or 1) > 0 for s in idx):
        return x[tuple(idx)]
    for d, s in enumerate(idx):                 # a negative stride
        if (s.step or 1) < 0:
            pick = torch.arange(*s.indices(x.shape[d]), device=x.device)
            x = x.index_select(d, pick)
            idx[d] = builtins.slice(None)
    return x[tuple(idx)]


def slice(input, axes, starts, ends, name=None):
    """``input[starts:ends]`` along each of ``axes``."""
    axes = as_int_list(axes)
    return _sliced(input, axes, as_int_list(starts), as_int_list(ends),
                   [1] * len(axes))


def strided_slice(x, axes, starts, ends, strides, name=None):
    return _sliced(x, as_int_list(axes), as_int_list(starts),
                   as_int_list(ends), as_int_list(strides))


def tanh_(x, name=None):
    return x.tanh_()


def tolist(x):
    return x.tolist()


def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(x, axis))


def real(x, name=None):
    """The real part (a real tensor itself)."""
    return torch.real(x) if x.is_complex() else x


def imag(x, name=None):
    """The imaginary part (zeros for a real tensor)."""
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def conj(x, name=None):
    return torch.conj_physical(x)


def angle(x, name=None):
    return torch.angle(x)


def ceil_(x, name=None):
    return x.ceil_()


def exp_(x, name=None):
    return x.exp_()


def floor_(x, name=None):
    return x.floor_()


def reciprocal_(x, name=None):
    return x.reciprocal_()


def round_(x, name=None):
    return x.round_()


def sqrt_(x, name=None):
    return x.sqrt_()


def erfinv_(x, name=None):
    return x.erfinv_()


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    from .manipulation import flatten, reshape_

    return reshape_(x, list(flatten(x, start_axis, stop_axis).shape))


def lerp_(x, y, weight, name=None):
    from .math import lerp

    return x.copy_(lerp(x, y, weight))


def put_along_axis_(arr, indices, values, axis, reduce="assign", name=None):
    from .manipulation import put_along_axis

    return arr.copy_(put_along_axis(arr, indices, values, axis,
                                    reduce=reduce))
