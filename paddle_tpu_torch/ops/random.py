"""Random sampling ops (port of ``paddle_tpu/ops/random.py``).

The JAX package splits a PRNG key per op; here every op takes one draw of
the device's generator (:func:`..rng.default_generator`, seeded by
``paddle.seed``) and turns Philox-4x32-10 words at counters ``(i, 0, 0,
offset)`` into its values, all as device ops: a draw inside a captured
CUDA graph gives fresh values at each replay, and the same seed gives
bitwise the same values.  The draws are the port's own, not the JAX
package's: they hold the same laws (uniform, normal by Box-Muller,
integers by scaling a 53-bit uniform, permutations and sampling without
replacement by sorting random keys, Poisson by inversion below a mean of
10 and by Hörmann's transformed rejection, PTRS, above).
"""
from __future__ import annotations

import math as _math

import torch

from .. import rng
from ._helpers import as_int_list, convert_dtype, device_of, \
    get_default_dtype

__all__ = ["rand", "randn", "standard_normal", "normal", "uniform",
           "randint", "randint_like", "randperm", "bernoulli", "poisson",
           "multinomial", "uniform_", "normal_", "exponential_", "rand_like",
           "randn_like"]

_MASK32 = 0xFFFFFFFF


def _words(n: int, device, per: int = 1, gen=None) -> torch.Tensor:
    """``[n, per]`` 32-bit Philox words (int64) of one draw of ``gen``
    (the device's generator for None)."""
    snap = (gen or rng.default_generator(device)).draw()
    k0, k1, off = rng._key_and_offset(snap)
    total = n * per
    calls = torch.arange((total + 3) // 4, dtype=torch.int64,
                         device=snap.device)
    w = rng.philox4x32_10(calls & _MASK32, calls >> 32,
                          torch.zeros_like(off), off, k0, k1)
    return torch.stack(w, dim=-1).reshape(-1)[:total].reshape(n, per)


def _uniform01(n: int, device, dtype: torch.dtype, gen=None) -> torch.Tensor:
    """``n`` uniforms in ``[0, 1)``: 24 bits for 32-bit and narrower
    dtypes, 53 bits (two words) for float64."""
    if dtype == torch.float64:
        w = _words(n, device, 2, gen)
        return ((w[:, 0] >> 5) * 67108864 + (w[:, 1] >> 6)).to(
            torch.float64) * 2.0 ** -53
    return ((_words(n, device, 1, gen)[:, 0] >> 8).to(torch.float32)
            * 2.0 ** -24).to(dtype)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _rand(shape, dtype, device, gen=None) -> torch.Tensor:
    shape = as_int_list(shape)
    work = torch.float64 if dtype == torch.float64 else torch.float32
    return _uniform01(_numel(shape), device, work, gen).reshape(shape).to(
        dtype)


def _randn(shape, dtype, device) -> torch.Tensor:
    """Box-Muller over two uniforms an element."""
    shape = as_int_list(shape)
    work = torch.float64 if dtype == torch.float64 else torch.float32
    n = _numel(shape)
    u = _uniform01(2 * n, device, work).reshape(n, 2)
    z = torch.sqrt(-2.0 * torch.log1p(-u[:, 0])) * torch.cos(
        2.0 * _math.pi * u[:, 1])
    return z.reshape(shape).to(dtype)


def _dt(dtype) -> torch.dtype:
    return convert_dtype(dtype) if dtype is not None else get_default_dtype()


def rand(shape, dtype=None, name=None, device=None):
    return _rand(shape, _dt(dtype), device_of(device=device))


def randn(shape, dtype=None, name=None, device=None):
    return _randn(shape, _dt(dtype), device_of(device=device))


def standard_normal(shape, dtype=None, name=None, device=None):
    return randn(shape, dtype, device=device)


def normal(mean=0.0, std=1.0, shape=None, name=None, device=None):
    """``mean + std * randn``; with a tensor ``mean`` or ``std`` the shape
    is their broadcast one."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        m = mean if isinstance(mean, torch.Tensor) else torch.as_tensor(mean)
        s = std if isinstance(std, torch.Tensor) else torch.as_tensor(std)
        shp = torch.broadcast_shapes(m.shape, s.shape)
        dev = device_of(mean, std, device=device)
        return m + s * _randn(list(shp), get_default_dtype(), dev)
    shp = as_int_list(shape) if shape is not None else []
    return mean + std * _randn(shp, get_default_dtype(),
                               device_of(device=device))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None,
            device=None):
    """Uniform on ``[min, max)``; a nonzero ``seed`` draws from a generator
    of that seed alone (the same values at every call)."""
    dev = device_of(device=device)
    u = _rand(shape, _dt(dtype), dev, rng.Generator(dev, seed) if seed
              else None)
    return u * (max - min) + min


def _randint(shape, low, high, dtype, device) -> torch.Tensor:
    shape = as_int_list(shape)
    u = _uniform01(_numel(shape), device, torch.float64)
    v = torch.floor(u * (high - low)).to(torch.int64) + low
    return v.clamp(max=high - 1).reshape(shape).to(dtype)


def randint(low=0, high=None, shape=[1], dtype="int64", name=None,
            device=None):
    """Integers uniform on ``[low, high)`` (``[0, low)`` with no
    ``high``)."""
    if high is None:
        low, high = 0, low
    return _randint(shape, low, high, convert_dtype(dtype),
                    device_of(device=device))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    """:func:`randint` of ``x``'s shape, in ``x``'s dtype unless given
    (a floating one holds the integers)."""
    if high is None:
        low, high = 0, low
    dt = convert_dtype(dtype) if dtype is not None else x.dtype
    return _randint(list(x.shape), low, high, dt, x.device)


def randperm(n, dtype="int64", name=None, device=None):
    """A permutation of ``range(n)``: the sort order of ``n`` random
    keys."""
    keys = _uniform01(n, device_of(device=device), torch.float64)
    return torch.argsort(keys, stable=True).to(convert_dtype(dtype))


def bernoulli(x, name=None):
    """1 where a uniform falls below the probability ``x``, else 0, in
    ``x``'s dtype."""
    u = _rand(list(x.shape), torch.float32, x.device)
    return (u < x).to(x.dtype)


def _poisson_small(lam, u) -> torch.Tensor:
    """Inversion for ``lam < 10``: the count of cumulative probabilities
    below ``u`` (48 terms: the tail past them is below 1e-20)."""
    p = torch.exp(-lam)
    cdf = p.clone()
    k = torch.zeros_like(lam)
    for i in range(1, 49):
        k = k + (u > cdf).to(lam.dtype)
        p = p * lam / i
        cdf = cdf + p
    return k


def _poisson_ptrs(lam, u, v) -> torch.Tensor:
    """Hörmann's PTRS for ``lam >= 10`` over candidate pairs ``(u, v)`` on
    the last dim: the first accepted candidate's count (16 candidates; the
    chance that none is accepted is below 1e-15)."""
    lam = lam.unsqueeze(-1)
    slam, loglam = torch.sqrt(lam), torch.log(lam)
    b = 0.931 + 2.53 * slam
    a = -0.059 + 0.02483 * b
    invalpha = 1.1239 + 1.1328 / (b - 3.4)
    vr = 0.9277 - 3.6224 / (b - 2)
    u = u - 0.5
    us = 0.5 - u.abs()
    k = torch.floor((2 * a / us + b) * u + lam + 0.43)
    quick = (us >= 0.07) & (v <= vr)
    reject = (k < 0) | ((us < 0.013) & (v > us))
    lhs = torch.log(v) + torch.log(invalpha) - torch.log(a / (us * us) + b)
    rhs = -lam + k * loglam - torch.lgamma(k + 1)
    ok = quick | (~reject & (lhs <= rhs))
    first = torch.argmax(ok.to(torch.int32), dim=-1, keepdim=True)
    return torch.take_along_dim(k, first, -1).squeeze(-1)


def poisson(x, name=None):
    """Poisson counts of mean ``x``, in ``x``'s dtype."""
    lam = x.to(torch.float64).reshape(-1)
    n = lam.numel()
    u = _uniform01(33 * n, x.device, torch.float64).reshape(n, 33)
    small = _poisson_small(lam.clamp(max=10.0), u[:, 0])
    big = _poisson_ptrs(lam.clamp(min=10.0), u[:, 1:17], u[:, 17:33])
    out = torch.where(lam < 10.0, small, big)
    return out.reshape(x.shape).to(x.dtype)


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Category indices drawn by the weights ``x`` (last dim): with
    replacement by inversion of the cumulative weights, without by the
    ``num_samples`` largest of ``log x`` plus Gumbel noise."""
    p = x.to(torch.float64)
    if replacement:
        cdf = torch.cumsum(p, -1)
        cdf = cdf / cdf[..., -1:]
        lead = list(p.shape[:-1])
        u = _uniform01(_numel(lead) * num_samples, x.device,
                       torch.float64).reshape(lead + [num_samples])
        out = torch.searchsorted(cdf.contiguous(), u.contiguous(),
                                 right=True)
        return out.clamp(max=p.shape[-1] - 1)
    g = -torch.log(-torch.log(_uniform01(p.numel(), x.device, torch.float64)
                              .reshape(p.shape).clamp(min=1e-300)))
    keys = torch.log(p.clamp(min=1e-30)) + g
    return torch.sort(keys, dim=-1, descending=True, stable=True).indices[
        ..., :num_samples]


def uniform_(x, min=-1.0, max=1.0, name=None):
    with torch.no_grad():
        return x.copy_(_rand(list(x.shape), x.dtype, x.device)
                       * (max - min) + min)


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        return x.copy_(mean + std * _randn(list(x.shape), x.dtype, x.device))


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        u = _rand(list(x.shape), torch.float64 if x.dtype == torch.float64
                  else torch.float32, x.device)
        return x.copy_(-torch.log1p(-u) / lam)


def rand_like(x, dtype=None, name=None):
    return _rand(list(x.shape), convert_dtype(dtype) or x.dtype, x.device)


def randn_like(x, dtype=None, name=None):
    return _randn(list(x.shape), convert_dtype(dtype) or x.dtype, x.device)
