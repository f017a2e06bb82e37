"""``paddle.fft`` (port of ``paddle_tpu/fft.py``): the 22 public functions
as plain functions on ``torch.Tensor`` over ``torch.fft`` (cuFFT on the
card), differentiable through autograd.

Real input is made complex (complex64 from float32, complex128 from
float64) where the transform wants complex.  The Hermitian n-d
transforms are built as the JAX package builds them: ``hfftn`` is the
real part of ``fftn`` of the Hermitian extension along the last
transform axis (``paddle_tpu/fft.py:145-203``), ``ihfftn`` the conjugate
of ``rfftn`` under the inverse direction's normalisation.
"""
from __future__ import annotations

import torch

from .ops._helpers import convert_dtype, device_of, get_default_dtype

__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft",
    "fft2", "ifft2", "rfft2", "irfft2", "hfft2", "ihfft2",
    "fftn", "ifftn", "rfftn", "irfftn", "hfftn", "ihfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]

_NORMS = ("forward", "backward", "ortho")


def _check_norm(norm) -> None:
    if norm not in _NORMS:
        raise ValueError(
            f"Unexpected norm: {norm}. Norm should be forward, backward "
            "or ortho")


def _check2(s, axes) -> None:
    if s is not None and len(s) != 2:
        raise ValueError(f"Invalid FFT argument s ({s}), it should be a "
                         "sequence of 2 integers.")
    if axes is not None and len(axes) != 2:
        raise ValueError(f"Invalid FFT argument axes ({axes}), it should "
                         "be a sequence of 2 integers.")


def _complex(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return x
    return x.to(torch.complex128 if x.dtype == torch.float64
                else torch.complex64)


def _real(x: torch.Tensor) -> torch.Tensor:
    """Real input for a real-to-complex transform (integers in the
    default dtype)."""
    return x if x.is_floating_point() else x.to(get_default_dtype())


def _axes(axes):
    """An axes or sizes argument as torch takes it (None, an int or a
    tuple)."""
    return axes if axes is None or isinstance(axes, int) else tuple(axes)


# -- 1-D ----------------------------------------------------------------------

def fft(x, n=None, axis=-1, norm="backward", name=None):
    _check_norm(norm)
    return torch.fft.fft(_complex(x), n=n, dim=axis, norm=norm)


def ifft(x, n=None, axis=-1, norm="backward", name=None):
    _check_norm(norm)
    return torch.fft.ifft(_complex(x), n=n, dim=axis, norm=norm)


def rfft(x, n=None, axis=-1, norm="backward", name=None):
    _check_norm(norm)
    return torch.fft.rfft(_real(x), n=n, dim=axis, norm=norm)


def irfft(x, n=None, axis=-1, norm="backward", name=None):
    _check_norm(norm)
    return torch.fft.irfft(_complex(x), n=n, dim=axis, norm=norm)


def hfft(x, n=None, axis=-1, norm="backward", name=None):
    _check_norm(norm)
    return torch.fft.hfft(_complex(x), n=n, dim=axis, norm=norm)


def ihfft(x, n=None, axis=-1, norm="backward", name=None):
    _check_norm(norm)
    return torch.fft.ihfft(_real(x), n=n, dim=axis,
                           norm=norm).resolve_conj()


# -- 2-D ----------------------------------------------------------------------

def fft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    _check2(s, axes)
    return fftn(x, s, axes, norm)


def ifft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    _check2(s, axes)
    return ifftn(x, s, axes, norm)


def rfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    _check2(s, axes)
    return rfftn(x, s, axes, norm)


def irfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    _check2(s, axes)
    return irfftn(x, s, axes, norm)


def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    _check2(s, axes)
    return hfftn(x, s, axes, norm)


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    _check2(s, axes)
    return ihfftn(x, s, axes, norm)


# -- N-D ----------------------------------------------------------------------

def fftn(x, s=None, axes=None, norm="backward", name=None):
    _check_norm(norm)
    return torch.fft.fftn(_complex(x), s=_axes(s), dim=_axes(axes),
                          norm=norm)


def ifftn(x, s=None, axes=None, norm="backward", name=None):
    _check_norm(norm)
    return torch.fft.ifftn(_complex(x), s=_axes(s), dim=_axes(axes),
                           norm=norm)


def rfftn(x, s=None, axes=None, norm="backward", name=None):
    _check_norm(norm)
    return torch.fft.rfftn(_real(x), s=_axes(s), dim=_axes(axes),
                           norm=norm)


def irfftn(x, s=None, axes=None, norm="backward", name=None):
    _check_norm(norm)
    return torch.fft.irfftn(_complex(x), s=_axes(s), dim=_axes(axes),
                            norm=norm)


def _hermitian_extend(a: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """The full length-``n`` spectrum along ``axis`` from its one-sided
    Hermitian half (the inverse of keeping ``[..., :n // 2 + 1]``)."""
    a = a.movedim(axis, -1)
    m = n // 2 + 1
    if a.shape[-1] < m:
        a = torch.nn.functional.pad(a, (0, m - a.shape[-1]))
    else:
        a = a[..., :m]
    # bins m..n-1 are the conjugates of bins n-m..1
    tail = torch.conj(a[..., 1:n - m + 1].flip(-1))
    return torch.cat([a, tail], dim=-1).movedim(-1, axis)


def hfftn(x, s=None, axes=None, norm="backward", name=None):
    """The real FFT of a signal Hermitian along the last transform axis
    (the n-d ``hfft``)."""
    _check_norm(norm)
    a = _complex(x)
    if axes is not None:
        ax = [d % a.dim() for d in axes]
    elif s is not None:
        # numpy's rule: s without axes means the last len(s) axes
        ax = list(range(a.dim() - len(s), a.dim()))
    else:
        ax = list(range(a.dim()))
    last = ax[-1]
    n_last = s[-1] if s is not None else 2 * (a.shape[last] - 1)
    if n_last < 1:
        raise ValueError("output length on the Hermitian axis must be >= 1")
    full = _hermitian_extend(a, n_last, last)
    sizes = None if s is None else list(s[:-1]) + [n_last]
    return torch.fft.fftn(full, s=sizes, dim=ax, norm=norm).real


def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    """The one-sided inverse of :func:`hfftn`: ``conj(rfftn(x))`` under the
    inverse direction's normalisation (``np.fft.ihfft`` on each line of
    the last axis)."""
    _check_norm(norm)
    inv = {"backward": "forward", "forward": "backward",
           "ortho": "ortho"}[norm]
    out = torch.fft.rfftn(_real(x), s=_axes(s), dim=_axes(axes), norm=inv)
    return torch.conj(out).resolve_conj()


# -- helpers ------------------------------------------------------------------

def fftfreq(n, d=1.0, dtype=None, name=None, device=None):
    """The sample frequencies of an ``n``-point FFT, on ``device`` (the
    port's current device for None)."""
    return torch.fft.fftfreq(int(n), d=float(d), dtype=torch.float64,
                             device=device_of(device=device)).to(
        convert_dtype(dtype) or get_default_dtype())


def rfftfreq(n, d=1.0, dtype=None, name=None, device=None):
    return torch.fft.rfftfreq(int(n), d=float(d), dtype=torch.float64,
                              device=device_of(device=device)).to(
        convert_dtype(dtype) or get_default_dtype())


def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(x, dim=_axes(axes))


def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(x, dim=_axes(axes))
