"""Search, sort and index ops (port of ``paddle_tpu/ops/search.py``).

Ties come out as the JAX package's do, on every device: ``argsort`` and
``sort`` are stable ascending sorts, and their descending order is the
flip of it (a tie's last index first); ``topk`` keeps ``lax.top_k``'s
order (a tie's lower index first), through a stable sort rather than
``torch.topk``, which promises no tie order on CUDA; ``kthvalue`` takes
the stable sort's index and ``mode`` the smallest most frequent value
and its first index.  ``nonzero`` and ``where(cond)`` have
data-dependent shapes and raise ``CaptureError`` inside a CUDA graph
capture.
"""
from __future__ import annotations

import torch

from ._helpers import check_host_read, convert_dtype

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "kthvalue",
           "mode", "nonzero", "where", "masked_scatter", "searchsorted",
           "bucketize", "index_fill"]


def _arg(fn, x, axis, keepdim, dtype):
    if axis is None:
        out = fn(x.reshape(-1))
        out = out.reshape([1] * x.dim()) if keepdim else out
    else:
        out = fn(x, axis, keepdim=keepdim)
    return out.to(convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    """The first index of the maximum (over the flattened tensor for
    None)."""
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, name=None):
    idx = torch.sort(x, dim=axis, stable=True).indices
    return torch.flip(idx, [axis]) if descending else idx


def sort(x, axis=-1, descending=False, name=None):
    vals = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(vals, [axis]) if descending else vals


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """``(values, indices)`` of the ``k`` largest (smallest) along
    ``axis`` (the last for None), ties in index order."""
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    axis = x.dim() - 1 if axis is None else axis % x.dim()
    idx = torch.sort(x, dim=axis, descending=largest,
                     stable=True).indices.narrow(axis, 0, k)
    return torch.take_along_dim(x, idx, axis), idx


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The ``k``-th smallest along ``axis`` and its index in the stable
    sort."""
    vals, idx = torch.sort(x, dim=axis, stable=True)
    vals, idx = vals.select(axis, k - 1), idx.select(axis, k - 1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of a tie, as
    ``scipy.stats.mode``) and the first index that holds it.  Compares
    every pair of entries along ``axis``."""
    a = torch.movedim(x, axis, -1)
    counts = (a.unsqueeze(-1) == a.unsqueeze(-2)).sum(-1)
    best = counts.amax(-1, keepdim=True)
    big = torch.full_like(a, float("inf") if a.is_floating_point()
                          else torch.iinfo(a.dtype).max)
    vals = torch.where(counts == best, a, big).amin(-1)
    idx = torch.argmax((a == vals.unsqueeze(-1)).to(torch.int32), -1)
    if keepdim:
        ax = axis % x.dim()
        vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
    return vals, idx


def nonzero(x, as_tuple=False, name=None):
    """The indices of the nonzero entries, ``[n, x.dim()]`` int64 (with
    ``as_tuple``, one ``[n, 1]`` tensor per dim)."""
    check_host_read("nonzero", x)
    nz = torch.nonzero(x)
    if as_tuple:
        return tuple(nz[:, d:d + 1] for d in range(x.dim()))
    return nz


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition`` holds, else ``y``; with neither,
    ``nonzero(condition, as_tuple=True)``."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return torch.where(condition.bool(), x, y)


def masked_scatter(x, mask, value, name=None):
    """``x`` with the entries where ``mask`` holds taken, in order, from
    ``value``."""
    return x.masked_scatter(torch.broadcast_to(mask.bool(), x.shape), value)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return torch.searchsorted(sorted_sequence, values, out_int32=out_int32,
                              right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def index_fill(x, index, axis, value, name=None):
    index = index.long() if isinstance(index, torch.Tensor) else \
        torch.as_tensor(index, dtype=torch.int64)
    index = torch.where(index < 0, index + x.shape[axis], index)
    return x.index_fill(axis, index.to(x.device).reshape(-1), value)
