"""Creation ops (port of ``paddle_tpu/ops/creation.py``).

A creation op with no tensor input makes its tensor on ``device=`` or the
port's current device (:mod:`..device`); one with a tensor input follows
that tensor.  A floating op given no dtype uses the default dtype
(:func:`._helpers.get_default_dtype`); ``arange`` over ints gives int64.
"""
from __future__ import annotations

import numpy as np
import torch

from ._helpers import as_int_list, as_tensor, convert_dtype, device_of, \
    get_default_dtype
from ._helpers import wrap_public

__all__ = ["zeros", "ones", "full", "empty", "zeros_like", "ones_like",
           "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
           "diag", "diagflat", "tril", "triu", "meshgrid", "assign", "clone",
           "tril_indices", "triu_indices", "complex"]


def _dt(dtype) -> torch.dtype:
    return convert_dtype(dtype) if dtype is not None else get_default_dtype()


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None, name=None, device=None):
    return torch.zeros(as_int_list(shape), dtype=_dt(dtype),
                       device=device_of(device=device))


def ones(shape, dtype=None, name=None, device=None):
    return torch.ones(as_int_list(shape), dtype=_dt(dtype),
                      device=device_of(device=device))


def full(shape, fill_value, dtype=None, name=None, device=None):
    if dtype is None and isinstance(fill_value, bool):
        dtype = "bool"
    if isinstance(fill_value, torch.Tensor):
        return fill_value.to(_dt(dtype)).expand(as_int_list(shape)).clone()
    return torch.full(as_int_list(shape), fill_value, dtype=_dt(dtype),
                      device=device_of(device=device))


def empty(shape, dtype=None, name=None, device=None):
    """Zeros, as the JAX package's (an uninitialised buffer would make
    two runs differ)."""
    return zeros(shape, dtype, device=device)


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, _scalar(fill_value), dtype=convert_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None, device=None):
    if end is None:
        start, end = 0, start
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if dtype is None:
        ints = all(isinstance(v, (int, np.integer)) for v in (start, end,
                                                             step))
        dtype = torch.int64 if ints else get_default_dtype()
    return torch.arange(start, end, step, dtype=convert_dtype(dtype),
                        device=device_of(device=device))


def linspace(start, stop, num, dtype=None, name=None, device=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=_dt(dtype), device=device_of(device=device))


def logspace(start, stop, num, base=10.0, dtype=None, name=None,
             device=None):
    return torch.logspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          base=base, dtype=_dt(dtype),
                          device=device_of(device=device))


def eye(num_rows, num_columns=None, dtype=None, name=None, device=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=_dt(dtype),
                     device=device_of(device=device))


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D input becomes the ``offset`` diagonal of a square matrix
    (``padding_value`` off it); a 2-D input gives its diagonal."""
    if x.dim() == 1:
        out = torch.diag(x, offset)
        if padding_value != 0:
            on = torch.diag(torch.ones(x.shape[0], device=x.device),
                            offset).bool()
            out = torch.where(on, out, torch.full_like(out, padding_value))
        return out
    return torch.diagonal(x, offset)


def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal)


def meshgrid(*args, **kwargs):
    tensors = args[0] if len(args) == 1 and isinstance(args[0],
                                                       (list, tuple)) \
        else args
    return list(torch.meshgrid(*tensors, indexing="ij"))


def assign(x, output=None):
    """A copy of ``x`` (a tensor, array or list); with ``output``, written
    into it in place."""
    if output is not None:
        with torch.no_grad():
            output.copy_(as_tensor(x, output).to(output.dtype))
        return output
    if isinstance(x, torch.Tensor):
        return x.clone()
    return as_tensor(x)


def clone(x, name=None):
    return x.clone()


def tril_indices(row, col, offset=0, dtype="int64", device=None):
    return torch.tril_indices(row, col, offset, dtype=convert_dtype(dtype),
                              device=device_of(device=device))


def triu_indices(row, col=None, offset=0, dtype="int64", device=None):
    return torch.triu_indices(row, row if col is None else col, offset,
                              dtype=convert_dtype(dtype),
                              device=device_of(device=device))


def complex(real, imag, name=None):
    return torch.complex(real, imag)


wrap_public(globals())
