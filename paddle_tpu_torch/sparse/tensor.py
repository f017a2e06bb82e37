"""Sparse COO and CSR tensors (port of ``paddle_tpu/sparse/tensor.py``).

A sparse tensor is a thin Python object over dense ``torch.Tensor``s on
one device: a COO tensor holds ``indices`` (``int64 [sparse_dim, nnz]``)
and ``values`` (``[nnz, *dense_dims]``), a CSR tensor ``crows``
(``[M + 1]``), ``cols`` (``[nnz]``) and ``values`` (``[nnz]``, 2-D
only).  The values are ordinary autograd tensors, so every op is
differentiable with respect to them.  Index work runs on the tensors'
device (sorts, ``searchsorted``, segment sums): no index goes through
numpy, and none is read to the host except where a size depends on the
data (``coalesce``'s count of distinct sites).

torch's own sparse layouts are not used: they reorder entries when they
coalesce, and the order of ``indices`` is part of a result here (a
coalesced tensor is row-major, a submanifold convolution keeps its
input's order).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import _parse, current_device
from ..ops._helpers import get_default_dtype

__all__ = ["SparseCooTensor", "SparseCsrTensor"]


def _as_tensor(x, device=None, index: bool = False) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is (moved to ``device`` if one
    is named); anything else made on ``device`` (the port's current device
    for None), float64 data in the default dtype and indices as int64."""
    dev = None if device is None else _parse(device)
    if isinstance(x, torch.Tensor):
        t = x if dev is None else x.to(dev)
    else:
        a = np.asarray(x)
        t = torch.tensor(a, device=current_device() if dev is None else dev)
        if a.dtype == np.float64:
            t = t.to(get_default_dtype())
    if index:
        t = t.to(torch.int64)
    return t


def flat_keys(indices: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """Row-major flat int64 keys of ``indices`` (``[len(dims), ...]``, one
    coordinate a row) in a grid of ``dims`` (the first size is not read:
    it only bounds the leading coordinate)."""
    key = torch.zeros_like(indices[0], dtype=torch.int64)
    for d, size in enumerate(dims):
        key = key * int(size) + indices[d]
    return key


def unflat_keys(keys: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """The inverse of :func:`flat_keys`: ``int64 [len(dims), n]`` (the
    leading coordinate whole, whatever ``dims[0]``)."""
    out = []
    for size in reversed(list(dims)[1:]):
        out.append(torch.remainder(keys, int(size)))
        keys = torch.div(keys, int(size), rounding_mode="floor")
    out.append(keys)
    return torch.stack(out[::-1])


def compact(mask: torch.Tensor, n: int, values: torch.Tensor) -> torch.Tensor:
    """``values[mask]`` for 1-D ``mask`` and ``values`` whose count of
    true entries ``n`` is already known on the host: a cumulative sum and
    a scatter, so nothing is read back from the device."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask, pos, torch.full_like(pos, n))
    out = values.new_empty(n + 1)
    out.scatter_(0, slot, values)
    return out[:n]


def sorted_unique(keys: torch.Tensor):
    """The distinct values of sorted ``keys`` and each key's rank among
    them (one host read: their count)."""
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    rank = torch.cumsum(first.to(torch.int64), 0) - 1
    n = int(first.sum()) if keys.numel() else 0
    return compact(first, n, keys), rank


class _Sparse:
    """What COO and CSR share: the values' autograd surface."""

    _values: torch.Tensor
    _shape: tuple

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def device(self):
        return self._values.device

    @property
    def stop_gradient(self) -> bool:
        return not self._values.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, v: bool) -> None:
        if v:
            self._values = self._values.detach()
        elif not self._values.requires_grad:
            self._values.requires_grad_(True)

    @property
    def grad(self):
        return self._values.grad

    def values(self) -> torch.Tensor:
        return self._values

    def backward(self, *a, **k):
        return self._values.backward(*a, **k)


class SparseCooTensor(_Sparse):
    """COO: ``indices`` ``[sparse_dim, nnz]`` int64, ``values`` ``[nnz,
    *dense_dims]``.  ``coalesced`` says the indices are already sorted
    row-major without duplicates."""

    def __init__(self, indices, values, shape, coalesced: bool = False):
        self._values = _as_tensor(values)
        self._indices = _as_tensor(indices, self._values.device, index=True)
        self._shape = tuple(int(s) for s in shape)
        self._coalesced = coalesced
        #: rulebooks of ``sparse.nn`` built on these indices, shared by
        #: every tensor over the same indices object
        self._plans: dict = {}
        if self._indices.dim() != 2:
            raise ValueError(f"indices must be [sparse_dim, nnz], got "
                             f"{list(self._indices.shape)}")
        sd, nnz = self._indices.shape
        if self._values.shape[0] != nnz:
            raise ValueError(
                f"values nnz {self._values.shape[0]} != indices nnz {nnz}")
        if sd + (self._values.dim() - 1) != len(self._shape):
            raise ValueError(
                f"sparse_dim {sd} + dense dims {self._values.dim() - 1} "
                f"!= rank {len(self._shape)}")

    def nnz(self) -> int:
        return int(self._indices.shape[1])

    def indices(self) -> torch.Tensor:
        return self._indices

    def is_sparse_coo(self) -> bool:
        return True

    def is_sparse_csr(self) -> bool:
        return False

    def _replace_values(self, new_values, shape=None) -> "SparseCooTensor":
        """The same sites (and their rulebooks) with other values, of
        ``shape`` (this tensor's for None)."""
        out = SparseCooTensor(self._indices, new_values,
                              self._shape if shape is None else shape,
                              self._coalesced)
        out._plans = self._plans
        return out

    def to_dense(self) -> torch.Tensor:
        """The dense tensor: values summed into their sites (duplicates
        add)."""
        out = self._values.new_zeros(self._shape)
        idx = tuple(self._indices[d] for d in range(self._indices.shape[0]))
        return out.index_put(idx, self._values, accumulate=True)

    def to_sparse_csr(self) -> "SparseCsrTensor":
        """2-D only: coalesced, then row pointers by ``searchsorted``."""
        if len(self._shape) != 2:
            raise ValueError("to_sparse_csr supports 2-D tensors")
        coo = self.coalesce()
        rows, cols = coo._indices[0], coo._indices[1]
        crows = torch.searchsorted(
            rows, torch.arange(self._shape[0] + 1, device=rows.device))
        return SparseCsrTensor(crows, cols, coo._values, self._shape)

    def coalesce(self) -> "SparseCooTensor":
        """Indices sorted row-major, duplicates summed (a stable sort of
        the flat keys and a segment sum on the device; one host read, the
        number of distinct sites).  A coalesced tensor is returned as it
        is."""
        if self._coalesced:
            return self
        dims = self._shape[:self._indices.shape[0]]
        keys, order = torch.sort(flat_keys(self._indices, dims), stable=True)
        uniq, seg = sorted_unique(keys)
        vals = self._values.new_zeros(
            (uniq.numel(),) + tuple(self._values.shape[1:]))
        vals = vals.index_add(0, seg, self._values[order])
        return SparseCooTensor(unflat_keys(uniq, dims), vals, self._shape,
                               coalesced=True)

    def __repr__(self):
        return (f"SparseCooTensor(shape={list(self._shape)}, "
                f"nnz={self.nnz()}, dtype={self.dtype})")


class SparseCsrTensor(_Sparse):
    """CSR: ``crows`` ``[M + 1]``, ``cols`` ``[nnz]``, ``values`` ``[nnz]``
    (2-D)."""

    def __init__(self, crows, cols, values, shape):
        self._values = _as_tensor(values)
        dev = self._values.device
        self._crows = _as_tensor(crows, dev, index=True)
        self._cols = _as_tensor(cols, dev, index=True)
        self._shape = tuple(int(s) for s in shape)
        if len(self._shape) != 2:
            raise ValueError("SparseCsrTensor supports 2-D shapes")

    def nnz(self) -> int:
        return int(self._cols.shape[0])

    def crows(self) -> torch.Tensor:
        return self._crows

    def cols(self) -> torch.Tensor:
        return self._cols

    def is_sparse_coo(self) -> bool:
        return False

    def is_sparse_csr(self) -> bool:
        return True

    def _row_ids(self) -> torch.Tensor:
        """Each entry's row: the last row whose pointer is at or below the
        entry's position (on the device, no host read)."""
        pos = torch.arange(self._cols.shape[0], device=self._cols.device)
        return torch.searchsorted(self._crows[1:].contiguous(), pos,
                                  right=True)

    def _replace_values(self, new_values) -> "SparseCsrTensor":
        return SparseCsrTensor(self._crows, self._cols, new_values,
                               self._shape)

    def to_dense(self) -> torch.Tensor:
        out = self._values.new_zeros(self._shape)
        return out.index_put((self._row_ids(), self._cols), self._values,
                             accumulate=True)

    def to_sparse_coo(self, sparse_dim: int = 2) -> SparseCooTensor:
        if sparse_dim != 2:
            raise ValueError("CSR→COO supports sparse_dim=2")
        idx = torch.stack([self._row_ids(), self._cols])
        return SparseCooTensor(idx, self._values, self._shape,
                               coalesced=True)

    def __repr__(self):
        return (f"SparseCsrTensor(shape={list(self._shape)}, "
                f"nnz={self.nnz()}, dtype={self.dtype})")
