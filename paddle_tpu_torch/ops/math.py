"""Elementwise, reduction and scan ops (port of ``paddle_tpu/ops/math.py``).

Each op computes what the JAX package's does, not what the torch op of
the same name does where the two differ: ``median`` and ``nanmedian``
average the two middle values of an even count (as ``jnp.median``;
``torch.median`` returns the lower one), ``cummax`` returns the values
only, ``lerp`` is ``x + w * (y - x)``, ``outer`` flattens its inputs,
``imag`` of a real tensor is zeros.  A Python scalar operand is made on
the other operand's device.
"""
from __future__ import annotations

import torch

from ._helpers import as_tensor, convert_dtype, dims, norm_axis
from ._helpers import wrap_public

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "floor_mod", "pow", "maximum", "minimum", "fmax", "fmin", "atan2",
    "logaddexp", "heaviside", "hypot", "lerp", "nextafter", "gcd", "lcm",
    "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
    "square", "abs", "sign", "floor", "ceil", "round", "trunc", "frac", "sin",
    "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh",
    "acosh", "atanh", "erf", "erfinv", "reciprocal", "neg", "negative",
    "sigmoid", "digamma", "lgamma", "i0", "i1", "deg2rad", "rad2deg", "angle",
    "conj", "real", "imag", "scale", "increment", "clip", "nan_to_num",
    "stanh", "rsqrt_", "isnan", "isinf", "isfinite", "isclose", "allclose",
    "equal_all", "sum", "mean", "prod", "max", "min", "amax", "amin", "std",
    "var", "median", "nanmedian", "nansum", "nanmean", "logsumexp", "all",
    "any", "count_nonzero", "cumsum", "cumprod", "cummax", "logcumsumexp",
    "addmm", "inner", "outer", "kron", "trace", "diff",
]


def _pair(x, y):
    """Both operands as tensors, a non-tensor made on the other's device."""
    if not isinstance(x, torch.Tensor):
        x = as_tensor(x, y if isinstance(y, torch.Tensor) else None)
    if not isinstance(y, torch.Tensor):
        y = as_tensor(y, x)
    return x, y


def _binary(fn, name):
    def f(x, y, name=None):
        return fn(*_pair(x, y))

    f.__name__ = name
    f.__doc__ = f"``paddle.{name}`` elementwise, broadcasting."
    return f


# ---- binary elementwise -----------------------------------------------------

add = _binary(torch.add, "add")
subtract = _binary(torch.sub, "subtract")
multiply = _binary(torch.mul, "multiply")
divide = _binary(torch.true_divide, "divide")
floor_divide = _binary(lambda a, b: torch.div(a, b, rounding_mode="floor"),
                       "floor_divide")
remainder = _binary(torch.remainder, "remainder")
mod = remainder
floor_mod = remainder
pow = _binary(torch.pow, "pow")
maximum = _binary(torch.maximum, "maximum")
minimum = _binary(torch.minimum, "minimum")
fmax = _binary(torch.fmax, "fmax")
fmin = _binary(torch.fmin, "fmin")
atan2 = _binary(torch.atan2, "atan2")
logaddexp = _binary(torch.logaddexp, "logaddexp")
hypot = _binary(torch.hypot, "hypot")
nextafter = _binary(torch.nextafter, "nextafter")
gcd = _binary(torch.gcd, "gcd")
lcm = _binary(torch.lcm, "lcm")


def heaviside(x, y, name=None):
    x, y = _pair(x, y)
    return torch.heaviside(x, y.to(x.dtype))


def lerp(x, y, weight, name=None):
    """``x + weight * (y - x)`` (the JAX formula; ``torch.lerp`` switches
    formulas at ``weight`` 0.5)."""
    x, y = _pair(x, y)
    return x + weight * (y - x)


# ---- unary elementwise ------------------------------------------------------

def _unary(fn, name):
    def f(x, name=None):
        return fn(x)

    f.__name__ = name
    f.__doc__ = f"``paddle.{name}`` elementwise."
    return f


exp = _unary(torch.exp, "exp")
expm1 = _unary(torch.expm1, "expm1")
log = _unary(torch.log, "log")
log2 = _unary(torch.log2, "log2")
log10 = _unary(torch.log10, "log10")
log1p = _unary(torch.log1p, "log1p")
sqrt = _unary(torch.sqrt, "sqrt")
rsqrt = _unary(torch.rsqrt, "rsqrt")
square = _unary(torch.square, "square")
abs = _unary(torch.abs, "abs")
sign = _unary(torch.sign, "sign")
floor = _unary(torch.floor, "floor")
ceil = _unary(torch.ceil, "ceil")
round = _unary(torch.round, "round")          # half to even, as jnp.round
trunc = _unary(torch.trunc, "trunc")
frac = _unary(lambda a: a - torch.trunc(a), "frac")
sin = _unary(torch.sin, "sin")
cos = _unary(torch.cos, "cos")
tan = _unary(torch.tan, "tan")
asin = _unary(torch.asin, "asin")
acos = _unary(torch.acos, "acos")
atan = _unary(torch.atan, "atan")
sinh = _unary(torch.sinh, "sinh")
cosh = _unary(torch.cosh, "cosh")
tanh = _unary(torch.tanh, "tanh")
asinh = _unary(torch.asinh, "asinh")
acosh = _unary(torch.acosh, "acosh")
atanh = _unary(torch.atanh, "atanh")
erf = _unary(torch.erf, "erf")
erfinv = _unary(torch.erfinv, "erfinv")
reciprocal = _unary(lambda a: 1.0 / a, "reciprocal")
neg = _unary(torch.neg, "neg")
negative = neg
sigmoid = _unary(torch.sigmoid, "sigmoid")
digamma = _unary(torch.digamma, "digamma")
lgamma = _unary(torch.lgamma, "lgamma")
i0 = _unary(torch.special.i0, "i0")
i1 = _unary(torch.special.i1, "i1")
deg2rad = _unary(torch.deg2rad, "deg2rad")
rad2deg = _unary(torch.rad2deg, "rad2deg")
angle = _unary(torch.angle, "angle")
conj = _unary(torch.conj_physical, "conj")
real = _unary(lambda a: torch.real(a) if a.is_complex() else a, "real")
imag = _unary(lambda a: torch.imag(a) if a.is_complex()
              else torch.zeros_like(a), "imag")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x * scale + bias`` (``(x + bias) * scale`` if not
    ``bias_after_scale``), then the activation ``act`` of
    ``nn.functional`` if named."""
    out = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act is not None:
        from ..nn import functional as F

        out = getattr(F, act)(out)
    return out


def increment(x, value=1.0, name=None):
    """``x += value`` in place; returns ``x``."""
    with torch.no_grad():
        x.add_(value)
    return x


def clip(x, min=None, max=None, name=None):
    if min is None and max is None:
        return x.clone()
    return torch.clamp(x, min, max)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


def rsqrt_(x):
    return x.rsqrt_()


# ---- predicates ----------------------------------------------------------------

def isnan(x, name=None):
    return torch.isnan(x)


def isinf(x, name=None):
    return torch.isinf(x)


def isfinite(x, name=None):
    return torch.isfinite(x)


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    x, y = _pair(x, y)
    return torch.isclose(x, y.to(x.dtype), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    """A 0-d bool tensor (no host read, as the JAX op returns a tensor)."""
    return isclose(x, y, rtol, atol, equal_nan).all()


def equal_all(x, y, name=None):
    """A 0-d bool tensor: same shape and every element equal."""
    x, y = _pair(x, y)
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return (x == y).all()


# ---- reductions ----------------------------------------------------------------

def _keep_all(out, x, axis, keepdim):
    """A full reduction's ``keepdim`` shape: ``[1] * x.dim()``."""
    if keepdim and norm_axis(axis) is None:
        return out.reshape([1] * x.dim())
    return out


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    return torch.sum(x, dim=dims(axis, x.dim()), keepdim=keepdim,
                     dtype=convert_dtype(dtype))


def _float(x):
    return x if x.is_floating_point() or x.is_complex() else x.to(
        torch.float32)


def mean(x, axis=None, keepdim=False, name=None):
    return torch.mean(_float(x), dim=dims(axis, x.dim()), keepdim=keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    dt = convert_dtype(dtype)
    out = x if dt is None else x.to(dt)
    if norm_axis(axis) is None:
        return _keep_all(out.prod(), x, axis, keepdim)
    for d in sorted((a % x.dim() for a in dims(axis, x.dim())),
                    reverse=True):
        out = out.prod(d, keepdim=keepdim)
    return out


def max(x, axis=None, keepdim=False, name=None):
    """Values only (a tie's gradient is shared evenly, as the JAX op's)."""
    return torch.amax(x, dim=dims(axis, x.dim()), keepdim=keepdim)


def min(x, axis=None, keepdim=False, name=None):
    return torch.amin(x, dim=dims(axis, x.dim()), keepdim=keepdim)


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(_float(x), dim=dims(axis, x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(_float(x), dim=dims(axis, x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _to_last(x, axis):
    """``x`` with the reduced axes moved last and joined into one (all of
    them for None), and the kept shape of a ``keepdim`` result."""
    ax = [a % x.dim() for a in dims(axis, x.dim())] if x.dim() else []
    rest = [d for d in range(x.dim()) if d not in ax]
    keep = [1 if d in ax else x.shape[d] for d in range(x.dim())]
    y = x.permute(rest + ax) if x.dim() else x.reshape(1)
    return y.reshape([x.shape[d] for d in rest] + [-1]), keep


def _quantile(fn, x, q, axis, keepdim):
    y, keep = _to_last(_float(x), axis)
    qt = torch.as_tensor(q, dtype=y.dtype, device=y.device)
    out = fn(y, qt, dim=-1)
    if keepdim:
        out = out.reshape(list(qt.shape) + keep)
    return out


def median(x, axis=None, keepdim=False, name=None):
    """The middle value, the mean of the two middle values for an even
    count (``jnp.median``); NaN if the reduced values hold one."""
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


def nanmedian(x, axis=None, keepdim=False, name=None):
    """:func:`median` over the values that are not NaN."""
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return torch.nansum(x, dim=dims(axis, x.dim()), keepdim=keepdim,
                        dtype=convert_dtype(dtype))


def nanmean(x, axis=None, keepdim=False, name=None):
    return torch.nanmean(_float(x), dim=dims(axis, x.dim()), keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return torch.logsumexp(x, dim=dims(axis, x.dim()), keepdim=keepdim)


def all(x, axis=None, keepdim=False, name=None):
    return torch.amin(x.bool(), dim=dims(axis, x.dim()), keepdim=keepdim)


def any(x, axis=None, keepdim=False, name=None):
    return torch.amax(x.bool(), dim=dims(axis, x.dim()), keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return torch.sum(x != 0, dim=dims(axis, x.dim()), keepdim=keepdim)


# ---- scans ---------------------------------------------------------------------

def cumsum(x, axis=None, dtype=None, name=None):
    """Along ``axis``; over the flattened tensor for None."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, axis, dtype=convert_dtype(dtype))


def cumprod(x, dim=None, dtype=None, name=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim, dtype=convert_dtype(dtype))


def cummax(x, axis=None, dtype="int64", name=None):
    """The running maximum's values (the JAX op returns no indices)."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cummax(x, axis).values


def logcumsumexp(x, axis=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, axis)


# ---- products and differences --------------------------------------------------

def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * input + alpha * (x @ y)


def inner(x, y, name=None):
    return torch.inner(x, y)


def outer(x, y, name=None):
    return torch.outer(x.reshape(-1), y.reshape(-1))


def kron(x, y, name=None):
    return torch.kron(x, y)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    if prepend is not None:
        prepend = as_tensor(prepend, x)
    if append is not None:
        append = as_tensor(append, x)
    return torch.diff(x, n, axis, prepend, append)



wrap_public(globals())
