"""The port's ``fft`` and ``signal`` against the JAX package's, on the CPU.

Spec: ``tests/test_fft_signal.py``'s ``TestFFT1D``, ``TestFFTND``,
``TestSignal`` and the fft and signal cases of its review classes.  Both
packages take the same seeded numpy inputs; outputs within 1e-5 × the
largest magnitude of the JAX output, gradients within 1e-5 × the
largest JAX gradient.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu_torch import fft as pfft
from paddle_tpu_torch import signal as psignal
from paddle_tpu_torch.device import device_guard

torch.set_num_threads(2)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    with device_guard("cpu"):
        yield
    mesh_mod.set_global_mesh(saved)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().resolve_conj().numpy()
    return np.asarray(t.numpy())


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"max abs err {err} > {tol} x {scale}"


def _both(x, dtype=None):
    x = np.asarray(x) if dtype is None else np.asarray(x, dtype)
    return paddle.to_tensor(x), torch.from_numpy(x.copy())


X1 = np.random.RandomState(0).randn(3, 16).astype(np.float32)
XN = np.random.RandomState(1).randn(2, 8, 12).astype(np.float32)


# -- 1-D ----------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_fft_ifft(norm):
    j, p = _both(X1)
    jX, pX = paddle.fft.fft(j, norm=norm), pfft.fft(p, norm=norm)
    _close(pX, jX)
    _close(pfft.ifft(pX, norm=norm), paddle.fft.ifft(jX, norm=norm))


@pytest.mark.parametrize("name", ["rfft", "ihfft"])
def test_real_to_complex_1d(name):
    j, p = _both(X1)
    _close(getattr(pfft, name)(p), getattr(paddle.fft, name)(j))


@pytest.mark.parametrize("name,n", [("irfft", 16), ("hfft", None)])
def test_complex_to_real_1d(name, n):
    spec = np.fft.rfft(X1).astype(np.complex64)
    j, p = _both(spec)
    _close(getattr(pfft, name)(p, n=n), getattr(paddle.fft, name)(j, n=n))


def test_n_and_axis():
    j, p = _both(X1)
    _close(pfft.fft(p, n=8, axis=0), paddle.fft.fft(j, n=8, axis=0))


def test_bad_norm():
    with pytest.raises(ValueError):
        pfft.fft(torch.from_numpy(X1), norm="bogus")
    with pytest.raises(ValueError):
        pfft.fft2(torch.from_numpy(XN), s=[4])


# -- N-D ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fft2", "fftn", "rfft2", "rfftn",
                                  "ihfft2", "ihfftn"])
def test_forward_nd(name):
    j, p = _both(XN)
    _close(getattr(pfft, name)(p), getattr(paddle.fft, name)(j))


def test_inverse_nd():
    j, p = _both(XN)
    jX, pX = paddle.fft.fft2(j), pfft.fft2(p)
    _close(pfft.ifft2(pX), paddle.fft.ifft2(jX))
    _close(pfft.ifftn(pX), paddle.fft.ifftn(jX))
    jR, pR = paddle.fft.rfftn(j), pfft.rfftn(p)
    _close(pfft.irfftn(pR, s=XN.shape), paddle.fft.irfftn(jR, s=XN.shape))
    _close(pfft.irfft2(pR), paddle.fft.irfft2(jR))


@pytest.mark.parametrize("s,axes", [(None, None), ([16], None),
                                    (None, (0, 2)), ([8, 10], (-2, -1))])
def test_hfftn_matches_jax_hermitian_extension(s, axes):
    spec = np.fft.rfftn(XN).astype(np.complex64)          # [2, 8, 7]
    j, p = _both(spec)
    _close(pfft.hfftn(p, s=s, axes=axes),
           paddle.fft.hfftn(j, s=s, axes=axes))
    if axes is None or len(axes) == 2:
        s2 = None if s is None or len(s) != 2 else s
        _close(pfft.hfft2(p, s=s2), paddle.fft.hfft2(j, s=s2))


def test_ihfftn_norms():
    j, p = _both(XN)
    for norm in ("backward", "ortho", "forward"):
        _close(pfft.ihfftn(p, norm=norm), paddle.fft.ihfftn(j, norm=norm))


def test_freq_shift_helpers():
    for n, d in ((10, 0.5), (7, 2.0)):
        _close(pfft.fftfreq(n, d), paddle.fft.fftfreq(n, d))
        _close(pfft.rfftfreq(n, d), paddle.fft.rfftfreq(n, d))
    a = np.arange(10.0, dtype=np.float32).reshape(2, 5)
    j, p = _both(a)
    for axes in (None, 1, (0, 1)):
        _close(pfft.fftshift(p, axes=axes), paddle.fft.fftshift(j,
                                                                axes=axes))
        _close(pfft.ifftshift(p, axes=axes),
               paddle.fft.ifftshift(j, axes=axes))


@pytest.mark.parametrize("name", ["rfft", "fft2", "hfftn", "ihfftn"])
def test_fft_grad(name):
    """``|X|^2`` energy through the transform: the input's gradient (for a
    complex input torch gives the conjugate of the JAX gradient: ∂L/∂z̄
    against ∂L/∂z)."""
    x = np.fft.rfftn(XN).astype(np.complex64) if name == "hfftn" else XN
    jt = paddle.to_tensor(x, stop_gradient=False)
    pt = torch.tensor(x, requires_grad=True)
    jo, po = getattr(paddle.fft, name)(jt), getattr(pfft, name)(pt)
    if po.is_complex():
        (paddle.real(jo) ** 2 + paddle.imag(jo) ** 2).sum().backward()
        (po.real ** 2 + po.imag ** 2).sum().backward()
    else:
        (jo * jo).sum().backward()
        (po * po).sum().backward()
    _close(pt.grad.conj() if pt.is_complex() else pt.grad, jt.grad)


# -- signal -------------------------------------------------------------------

def test_frame_overlap_add_roundtrip():
    x = np.arange(32.0, dtype=np.float32)
    j, p = _both(x)
    jf = paddle.signal.frame(j, frame_length=8, hop_length=8)
    pf = psignal.frame(p, frame_length=8, hop_length=8)
    _close(pf, jf)
    _close(psignal.overlap_add(pf, hop_length=8),
           paddle.signal.overlap_add(jf, hop_length=8))


@pytest.mark.parametrize("axis", [-1, 0])
def test_frame_batched_overlapping(axis):
    x = np.random.RandomState(3).randn(2, 20).astype(np.float32)
    if axis == 0:
        x = np.ascontiguousarray(x.T)
    j, p = _both(x)
    jf = paddle.signal.frame(j, 8, 4, axis=axis)
    pf = psignal.frame(p, 8, 4, axis=axis)
    _close(pf, jf)
    _close(psignal.overlap_add(pf, 4, axis=axis),
           paddle.signal.overlap_add(jf, 4, axis=axis))


def test_frame_refusals():
    with pytest.raises(ValueError):
        psignal.frame(torch.zeros(3, 4, 5), 2, 1, axis=1)
    with pytest.raises(ValueError):
        psignal.frame(torch.zeros(4), 8, 1)
    with pytest.raises(ValueError):
        psignal.frame(torch.zeros(8), 4, 0)


def test_overlap_add_sums():
    j, p = _both(np.ones((4, 3), np.float32))
    _close(psignal.overlap_add(p, 2), paddle.signal.overlap_add(j, 2))


STFT_CASES = [
    # n_fft, hop, win_length, window, center, pad_mode, normalized
    (64, 16, None, "hann", True, "reflect", False),
    (64, 16, 48, "hann", True, "reflect", False),     # padded window
    (64, None, None, None, True, "constant", True),
    (32, 8, 32, "hann", False, "reflect", False),
    (64, 16, 40, "hann", True, "edge", True),
]


def _hann(n):
    return np.hanning(n).astype(np.float32)


@pytest.mark.parametrize("case", STFT_CASES, ids=str)
def test_stft_matches_jax(case):
    n_fft, hop, wl, win, center, mode, normalized = case
    x = np.random.RandomState(5).randn(2, 512).astype(np.float32)
    w = None if win is None else _hann(wl or n_fft)
    kw = dict(hop_length=hop, win_length=wl, center=center,
              pad_mode=mode, normalized=normalized)
    j, p = _both(x)
    jo = paddle.signal.stft(j, n_fft, window=None if w is None else
                            paddle.to_tensor(w), **kw)
    po = psignal.stft(p, n_fft, window=None if w is None else
                      torch.from_numpy(w), **kw)
    _close(po, jo)
    _close(psignal.stft(p[0], n_fft, window=None if w is None else
                        torch.from_numpy(w), **kw), jo[0])


@pytest.mark.parametrize("case", STFT_CASES[:3], ids=str)
def test_istft_matches_jax(case):
    n_fft, hop, wl, win, center, mode, normalized = case
    x = np.random.RandomState(7).randn(1024).astype(np.float32)
    w = None if win is None else _hann(wl or n_fft)
    jw = None if w is None else paddle.to_tensor(w)
    pw = None if w is None else torch.from_numpy(w)
    j, p = _both(x)
    kw = dict(hop_length=hop, win_length=wl, normalized=normalized)
    jspec = paddle.signal.stft(j, n_fft, window=jw, **kw)
    pspec = psignal.stft(p, n_fft, window=pw, **kw)
    jb = paddle.signal.istft(jspec, n_fft, window=jw, length=1024, **kw)
    pb = psignal.istft(pspec, n_fft, window=pw, length=1024, **kw)
    _close(pb, jb)
    np.testing.assert_allclose(_np(pb), x, atol=1e-3)


def test_istft_two_sided_and_lengths():
    x = np.random.RandomState(8).randn(2, 300).astype(np.float32)
    j, p = _both(x)
    w = _hann(64)
    jspec = paddle.signal.stft(j, 64, 16, window=paddle.to_tensor(w),
                               onesided=False)
    pspec = psignal.stft(p, 64, 16, window=torch.from_numpy(w),
                         onesided=False)
    _close(pspec, jspec)
    for length, rc in ((320, False), (200, True)):
        jb = paddle.signal.istft(jspec, 64, 16, window=paddle.to_tensor(w),
                                 onesided=False, length=length,
                                 return_complex=rc)
        pb = psignal.istft(pspec, 64, 16, window=torch.from_numpy(w),
                           onesided=False, length=length, return_complex=rc)
        _close(pb, jb)


def test_stft_complex_onesided_raises():
    rs0, rs1 = np.random.RandomState(0), np.random.RandomState(1)
    z = (rs0.randn(256) + 1j * rs1.randn(256)).astype(np.complex64)
    with pytest.raises(ValueError):
        psignal.stft(torch.from_numpy(z), 64)
    j, p = _both(z)
    _close(psignal.stft(p, 64, onesided=False),
           paddle.signal.stft(j, 64, onesided=False))


def test_stft_grad():
    x = np.random.RandomState(9).randn(400).astype(np.float32)
    w = _hann(64)
    jt = paddle.to_tensor(x, stop_gradient=False)
    pt = torch.tensor(x, requires_grad=True)
    jo = paddle.signal.stft(jt, 64, 16, window=paddle.to_tensor(w))
    po = psignal.stft(pt, 64, 16, window=torch.from_numpy(w))
    (paddle.real(jo) ** 2 + paddle.imag(jo) ** 2).sum().backward()
    (po.real ** 2 + po.imag ** 2).sum().backward()
    _close(pt.grad, jt.grad)
