"""Linear algebra ops (port of ``paddle_tpu/ops/linalg.py``).

As the JAX package's: ``slogdet`` stacks ``[sign, log|det|]``, ``lstsq``
returns the solution only (the pseudo-inverse's, minimum norm), ``lu``
returns Paddle's 1-based pivots, ``eig`` and ``eigvals`` are complex,
``cross``'s default axis is the first of size 3, ``triangular_solve``
reads the ``upper`` triangle of the (transposed, with ``transpose``)
matrix.  ``bincount`` has a data-dependent shape and raises
``CaptureError`` inside a CUDA graph capture.
"""
from __future__ import annotations

import numpy as np
import torch

from ._helpers import check_host_read
from ._helpers import wrap_public

__all__ = ["matmul", "bmm", "mm", "mv", "dot", "einsum", "norm", "dist",
           "cross", "cholesky", "cholesky_solve", "inv", "inverse", "det",
           "slogdet", "qr", "svd", "eig", "eigh", "eigvals", "eigvalsh",
           "matrix_power", "matrix_rank", "pinv", "solve",
           "triangular_solve", "lstsq", "multi_dot", "lu", "histogram",
           "bincount", "matrix_transpose", "corrcoef", "cov", "cond",
           "lu_unpack"]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-2, -1)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-2, -1)
    return torch.matmul(x, y)


def bmm(x, y, name=None):
    return torch.matmul(x, y)


def mm(x, y, name=None):
    return torch.matmul(x, y)


def mv(x, vec, name=None):
    return torch.matmul(x, vec)


def dot(x, y, name=None):
    return (x * y).sum(-1)


def einsum(equation, *operands):
    return torch.einsum(equation, *operands)


def _is_inf(p, sign) -> bool:
    return p == sign * np.inf or (sign > 0 and p == "inf")


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """The JAX package's rules: over all entries for None (``"fro"``/2 the
    2-norm, ``inf`` the largest magnitude, ...), else a vector norm along
    ``axis`` (``0`` counts the nonzeros)."""
    if axis is None:
        flat = x.reshape(-1)
        if p in ("fro", 2):
            out = torch.sqrt((flat * flat).sum())
            return out.reshape([1] * x.dim()) if keepdim else out
        if _is_inf(p, 1):
            return flat.abs().amax()
        if _is_inf(p, -1):
            return flat.abs().amin()
        if p == 1:
            return flat.abs().sum()
        return (flat.abs() ** p).sum() ** (1.0 / p)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if p == "fro":
        return torch.sqrt((x * x).sum(ax, keepdim=keepdim))
    if _is_inf(p, 1):
        return x.abs().amax(ax, keepdim=keepdim)
    if _is_inf(p, -1):
        return x.abs().amin(ax, keepdim=keepdim)
    if p == 0:
        return (x != 0).to(x.dtype).sum(ax, keepdim=keepdim)
    return (x.abs() ** p).sum(ax, keepdim=keepdim) ** (1.0 / p)


def dist(x, y, p=2, name=None):
    return norm(x - y, p=p)


def cross(x, y, axis=9, name=None):
    if axis == 9:                    # Paddle's default: the first axis of 3
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=axis)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(x, upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    """The solution of ``A z = x`` for ``A`` given by its Cholesky factor
    ``y``."""
    return torch.cholesky_solve(x, y, upper=upper)


def inv(x, name=None):
    return torch.linalg.inv(x)


inverse = inv


def det(x, name=None):
    return torch.linalg.det(x)


def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


def qr(x, mode="reduced", name=None):
    return tuple(torch.linalg.qr(x, mode=mode))


def svd(x, full_matrices=False, name=None):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


def eig(x, name=None):
    return tuple(torch.linalg.eig(x))


def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The count of singular values above ``tol`` (absolute), or above
    ``max(m, n) * eps`` times the largest for None."""
    if tol is None:
        return torch.linalg.matrix_rank(x, hermitian=hermitian)
    return torch.linalg.matrix_rank(x, atol=tol, rtol=0.0,
                                    hermitian=hermitian)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def solve(x, y, name=None):
    return torch.linalg.solve(x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a = x.transpose(-2, -1) if transpose else x
    return torch.linalg.solve_triangular(a, y, upper=upper,
                                         unitriangular=unitriangular)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """The least-squares solution of ``x z = y`` of least norm (through
    the pseudo-inverse, on every device; ``rcond`` relative)."""
    if rcond is None:
        return torch.linalg.pinv(x) @ y
    return torch.linalg.pinv(x, rtol=rcond) @ y


def multi_dot(x, name=None):
    return torch.linalg.multi_dot(list(x))


def lu(x, pivot=True, get_infos=False, name=None):
    """``(LU, pivots)`` (and a zero info with ``get_infos``), the pivots
    1-based as LAPACK and Paddle give them."""
    lu_, piv = torch.linalg.lu_factor(x, pivot=pivot)
    if get_infos:
        return lu_, piv, torch.zeros((), dtype=torch.int32, device=x.device)
    return lu_, piv


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts in ``bins`` equal bins over ``[min, max]`` (the data's range
    when both are 0), as int64."""
    return torch.histc(input.to(torch.float32), bins=bins, min=min,
                       max=max).to(torch.int64)


def bincount(x, weights=None, minlength=0, name=None):
    check_host_read("bincount", x)
    return torch.bincount(x, weights, minlength)


def matrix_transpose(x, name=None):
    return x.transpose(-2, -1)


def corrcoef(x, rowvar=True, name=None):
    return torch.corrcoef(x if rowvar else x.T)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


def cond(x, p=None, name=None):
    return torch.linalg.cond(x, p)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """``(P, L, U)`` of an :func:`lu` result (those asked for, in that
    order), ``A = P L U``."""
    P, L, U = torch.lu_unpack(x, y)
    outs = []
    if unpack_pivots:
        outs.append(P)
    if unpack_ludata:
        outs += [L, U]
    return tuple(outs)


wrap_public(globals())
