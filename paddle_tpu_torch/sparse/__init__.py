"""``paddle.sparse`` (port of ``paddle_tpu/sparse/__init__.py``): COO and
CSR tensors over dense ``torch.Tensor``s (:mod:`.tensor`), their ops as
plain functions, and the sparse layers of :mod:`.nn` (the 3-D
convolutions' rulebooks built on the tensors' device).  Also
``paddle.incubate.sparse``.

Paddle's ``Tensor.to_sparse_coo`` method is the function
:func:`to_sparse_coo` here (the port does not patch ``torch.Tensor``).
Every op keeps its operands' device; the index work of ``matmul``,
``masked_matmul`` and the elementwise ops runs there (sorts,
``searchsorted``, gathers and ``index_add``), and gradients flow to the
values and to the dense operands.
"""
from __future__ import annotations

import torch

from .tensor import SparseCooTensor, SparseCsrTensor, _as_tensor, \
    flat_keys, sorted_unique, unflat_keys
from . import nn  # noqa: F401

__all__ = [
    "sparse_coo_tensor", "sparse_csr_tensor", "SparseCooTensor",
    "SparseCsrTensor", "sqrt", "sin", "tanh", "relu", "abs",
    "matmul", "masked_matmul", "add", "subtract", "multiply", "divide",
    "is_sparse", "to_sparse_coo", "nn",
]


def _values(values, dtype, place):
    from ..ops._helpers import convert_dtype

    vals = _as_tensor(values, place)
    if dtype is not None:
        vals = vals.to(convert_dtype(dtype))
    return vals


def sparse_coo_tensor(indices, values, shape=None, dtype=None, place=None,
                      stop_gradient=True) -> SparseCooTensor:
    """A COO tensor on ``place`` (the values' device for a tensor, else the
    port's current device); ``shape`` None takes each sparse dim's largest
    index plus one (a host read of the indices' maxima)."""
    vals = _values(values, dtype, place)
    idx = _as_tensor(indices, vals.device, index=True)
    if shape is None:
        spatial = tuple(int(m) + 1 for m in idx.amax(dim=1).tolist())
        shape = spatial + tuple(vals.shape[1:])
    t = SparseCooTensor(idx, vals, shape)
    t.stop_gradient = stop_gradient
    return t


def sparse_csr_tensor(crows, cols, values, shape, dtype=None, place=None,
                      stop_gradient=True) -> SparseCsrTensor:
    t = SparseCsrTensor(crows, cols, _values(values, dtype, place), shape)
    t.stop_gradient = stop_gradient
    return t


def is_sparse(x) -> bool:
    return isinstance(x, (SparseCooTensor, SparseCsrTensor))


# -- unary: elementwise on the values (zero-preserving functions) -------------

def _unary(name, fn):
    def apply(x):
        if not is_sparse(x):
            raise TypeError(f"sparse.{name} expects a sparse tensor")
        return x._replace_values(fn(x.values()))

    apply.__name__ = name
    return apply


sqrt = _unary("sqrt", torch.sqrt)
sin = _unary("sin", torch.sin)
tanh = _unary("tanh", torch.tanh)
relu = _unary("relu", torch.relu)
abs = _unary("abs", torch.abs)  # noqa: A001


# -- binary -------------------------------------------------------------------

def matmul(x, y, name=None) -> torch.Tensor:
    """Sparse ``[M, N]`` (COO or CSR) @ dense ``[N, K]`` → dense ``[M,
    K]``: each entry's dense row gathered, scaled by its value and added
    into its output row (``index_add``)."""
    if isinstance(x, SparseCsrTensor):
        x = x.to_sparse_coo()
    if not isinstance(x, SparseCooTensor):
        raise TypeError("matmul expects a sparse lhs")
    if len(x.shape) != 2:
        raise ValueError("sparse matmul supports 2-D lhs")
    y = _as_tensor(y, x.device)
    if y.dim() != 2 or y.shape[0] != x.shape[1]:
        raise ValueError(
            f"matmul shape mismatch: sparse {x.shape} @ dense "
            f"{list(y.shape)}")
    rows, cols = x.indices()[0], x.indices()[1]
    contrib = x.values()[:, None] * y.index_select(0, cols)
    out = contrib.new_zeros(x.shape[0], y.shape[1])
    return out.index_add(0, rows, contrib)


def masked_matmul(x, y, mask, name=None):
    """``x @ y`` sampled at ``mask``'s sites (SDDMM): sparse with the
    mask's pattern, COO for a COO mask (coalesced first: a duplicate site
    would count twice) and CSR for a CSR mask."""
    if isinstance(mask, SparseCsrTensor):
        coo, csr_out = mask.to_sparse_coo(), True
    elif isinstance(mask, SparseCooTensor):
        coo, csr_out = mask.coalesce(), False
    else:
        raise TypeError("mask must be sparse")
    x = _as_tensor(x, mask.device)
    y = _as_tensor(y, mask.device)
    if x.shape[1] != y.shape[0] or tuple(mask.shape) != (
            x.shape[0], y.shape[1]):
        raise ValueError(
            f"masked_matmul shape mismatch: x {list(x.shape)} @ y "
            f"{list(y.shape)} sampled at mask {mask.shape}")
    idx = coo.indices()
    vals = (x.index_select(0, idx[0])
            * y.t().index_select(0, idx[1])).sum(-1)
    out = SparseCooTensor(idx, vals, (x.shape[0], y.shape[1]),
                          coalesced=True)
    return out.to_sparse_csr() if csr_out else out


# -- math: sparse ∘ sparse elementwise ----------------------------------------

def _ewise(name, fn):
    def apply(x, y, name_=None):
        if not (is_sparse(x) and is_sparse(y)):
            raise TypeError(f"sparse.{name} expects two sparse tensors")
        was_csr = x.is_sparse_csr()
        a = x.to_sparse_coo() if x.is_sparse_csr() else x.coalesce()
        b = y.to_sparse_coo() if y.is_sparse_csr() else y.coalesce()
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError("shape mismatch")
        # the union of the two patterns, sorted (one host read: its size)
        sd = a.indices().shape[0]
        dims = tuple(a.shape[:sd])
        fa, fb = flat_keys(a.indices(), dims), flat_keys(b.indices(), dims)
        union, _ = sorted_unique(torch.sort(torch.cat([fa, fb]))[0])
        n = union.numel()
        pa = torch.searchsorted(union, fa)
        pb = torch.searchsorted(union, fb)
        va, vb = a.values(), b.values()
        dense_a = va.new_zeros((n,) + tuple(va.shape[1:])).index_copy(
            0, pa, va)
        dense_b = vb.new_zeros((n,) + tuple(vb.shape[1:])).index_copy(
            0, pb, vb)
        out = SparseCooTensor(unflat_keys(union, dims), fn(dense_a, dense_b),
                              a.shape, coalesced=True)
        return out.to_sparse_csr() if was_csr else out

    apply.__name__ = name
    return apply


add = _ewise("add", torch.add)
subtract = _ewise("subtract", torch.sub)
multiply = _ewise("multiply", torch.mul)
divide = _ewise("divide", torch.div)


# -- dense -> sparse ----------------------------------------------------------

def to_sparse_coo(x: torch.Tensor, sparse_dim: int = 2) -> SparseCooTensor:
    """Paddle's ``Tensor.to_sparse_coo(sparse_dim)``: a dense tensor as COO
    over its leading ``sparse_dim`` axes (trailing axes stay dense in the
    values), row-major and coalesced.  The values are gathered from ``x``,
    so gradients flow back to it.  The count of nonzero sites is read to
    the host (inside a CUDA graph capture this raises, as the JAX method
    refuses a traced value)."""
    nd = x.dim()
    sd = int(sparse_dim)
    if not 1 <= sd <= nd:
        raise ValueError(f"sparse_dim must be in [1, {nd}], got {sd}")
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "to_sparse_coo is eager-only: the number of nonzeros is "
            "data-dependent and cannot live in a captured program")
    mask = x != 0
    if sd < nd:
        mask = mask.any(dim=tuple(range(sd, nd)))
    idx = torch.nonzero(mask).t().contiguous()
    values = x[tuple(idx[d] for d in range(sd))]
    return SparseCooTensor(idx, values, list(x.shape), coalesced=True)
