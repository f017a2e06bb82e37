"""Weight initializers.

Port of ``paddle_tpu/nn/initializer.py``.  Each initializer is a callable
``(shape, dtype) -> tensor`` that draws on the CPU from a
``torch.Generator``: the one passed as ``generator=``, else
:data:`..rng.init_generator` (seeded by ``paddle_tpu_torch.seed``).  The
laws are the JAX package's, for a shape in **Paddle's layout**: a 2-D
weight is read as ``[in, out]`` (``_fan_in_out``).  A layer whose torch
weight is the transpose of Paddle's (``Linear``: ``[out, in]``) asks
:meth:`..layer_base.Layer.create_parameter` for the Paddle shape and
stores the transpose (``transpose=True``), so the fans, an ``Assign``
value written for Paddle and an ``Orthogonal`` draw all mean what they
mean in the JAX package.  The bits differ from the JAX package's (its
draws are ``jax.random``'s); the laws are the same.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import rng as rng_mod

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierUniform", "XavierNormal", "KaimingUniform", "KaimingNormal",
           "Assign", "Orthogonal", "Dirac", "Bilinear", "calculate_gain",
           "set_global_initializer"]

Shape = Sequence[int]
#: where every draw is made (whatever torch's default device), before the
#: layer moves it to its device
_CPU = torch.device("cpu")


def _dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("paddle.", "")
    return getattr(torch, name)


def _fan_in_out(shape: Shape):
    """``(fan_in, fan_out)`` of a Paddle-layout shape: 2-D is ``[in, out]``,
    a conv kernel ``[out_c, in_c, *spatial]``."""
    shape = list(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """``init(shape, dtype="float32", generator=None)``: a new CPU tensor."""

    def __call__(self, shape: Shape, dtype="float32",
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        out = self._draw(tuple(int(s) for s in shape),
                         generator or rng_mod.init_generator)
        return out.to(_dtype(dtype))

    def _draw(self, shape, gen) -> torch.Tensor:
        raise NotImplementedError


def _uniform(shape, low, high, gen):
    return (torch.rand(shape, generator=gen, device=_CPU) * (high - low)
            + low)


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def _draw(self, shape, gen):
        return torch.full(shape, float(self.value), device=_CPU)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def _draw(self, shape, gen):
        return _uniform(shape, self.low, self.high, gen)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def _draw(self, shape, gen):
        return torch.randn(shape, generator=gen, device=_CPU) * self.std \
            + self.mean


class TruncatedNormal(Initializer):
    """``mean + std * N(0, 1)`` truncated to two standard deviations."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def _draw(self, shape, gen):
        out = torch.empty(shape, device=_CPU)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return out * self.std + self.mean


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fans(self, shape):
        fi, fo = _fan_in_out(shape)
        return (self.fan_in if self.fan_in is not None else fi,
                self.fan_out if self.fan_out is not None else fo)

    def _draw(self, shape, gen):
        fi, fo = self._fans(shape)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit, gen)


class XavierNormal(XavierUniform):
    def _draw(self, shape, gen):
        fi, fo = self._fans(shape)
        return torch.randn(shape, generator=gen, device=_CPU) * (
            self.gain * math.sqrt(2.0 / (fi + fo)))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain(self) -> float:
        if self.nonlinearity == "relu":
            return math.sqrt(2.0)
        if self.nonlinearity == "leaky_relu":
            return math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return 1.0

    def _fan(self, shape) -> int:
        return self.fan_in if self.fan_in is not None \
            else _fan_in_out(shape)[0]

    def _draw(self, shape, gen):
        limit = self._gain() * math.sqrt(3.0 / self._fan(shape))
        return _uniform(shape, -limit, limit, gen)


class KaimingNormal(KaimingUniform):
    def _draw(self, shape, gen):
        return torch.randn(shape, generator=gen, device=_CPU) * (
            self._gain() / math.sqrt(self._fan(shape)))


class Assign(Initializer):
    """The given value (a numpy array, list or tensor), reshaped to the
    shape asked for."""

    def __init__(self, value):
        self.value = value

    def _draw(self, shape, gen):
        v = self.value
        arr = v.detach().cpu().float() if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.array(v, dtype=np.float32))
        return arr.reshape(shape) if tuple(arr.shape) != shape else arr


class Orthogonal(Initializer):
    """``gain`` times a matrix with orthonormal columns (or rows, when it
    has fewer rows than columns) over ``(prod(shape[:-1]), shape[-1])``,
    from the QR of a normal draw with R's diagonal made positive, as
    ``jax.nn.initializers.orthogonal``."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def _draw(self, shape, gen):
        n_rows, n_cols = int(np.prod(shape[:-1])), shape[-1]
        tall = n_rows >= n_cols
        a = torch.randn((n_rows, n_cols) if tall else (n_cols, n_rows),
                        generator=gen, device=_CPU)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if not tall:
            q = q.T
        return self.gain * q.reshape(shape)


class Dirac(Initializer):
    """Identity conv kernel: ``w[i, i % in_c, centre] = 1`` for ``i <
    min(out_c, in_c * groups)``."""

    def __init__(self, groups: int = 1):
        self.groups = groups

    def _draw(self, shape, gen):
        out = torch.zeros(shape, device=_CPU)
        out_c, in_c = shape[0], shape[1]
        centers = [s // 2 for s in shape[2:]]
        for i in range(min(out_c, in_c * self.groups)):
            out[(i, i % in_c, *centers)] = 1.0
        return out


class Bilinear(Initializer):
    """The bilinear-interpolation kernel of a transposed-conv upsampler on
    each ``w[i, i]`` of a 4-D ``[c_out, c_in, kh, kw]`` shape."""

    def _draw(self, shape, gen):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D shape")
        c_out, c_in, kh, kw = shape
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        ctr_h = f_h - 1 if kh % 2 == 1 else f_h - 0.5
        ctr_w = f_w - 1 if kw % 2 == 1 else f_w - 0.5
        og = np.ogrid[:kh, :kw]
        filt = ((1 - np.abs(og[0] - ctr_h) / f_h)
                * (1 - np.abs(og[1] - ctr_w) / f_w))
        out = torch.zeros(shape, device=_CPU)
        for i in range(min(c_out, c_in)):
            out[i, i] = torch.from_numpy(filt.astype(np.float32))
        return out


def calculate_gain(nonlinearity: str, param: Optional[float] = None
                   ) -> float:
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


_global_initializer = None


def set_global_initializer(weight_init: Union[None, Initializer],
                           bias_init: Union[None, Initializer] = None
                           ) -> None:
    """The default initializers of parameters made from now on (an
    explicit ``ParamAttr`` initializer still wins); ``(None, None)``
    resets."""
    global _global_initializer
    if weight_init is None and bias_init is None:
        _global_initializer = None
    else:
        _global_initializer = (weight_init, bias_init)


def _get_global_initializer():
    return _global_initializer
