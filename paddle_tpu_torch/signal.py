"""``paddle.signal`` (port of ``paddle_tpu/signal.py``): ``frame``,
``overlap_add``, ``stft`` and ``istft`` as plain functions on
``torch.Tensor``.

Framing is a strided view (``unfold``), overlap-add an ``index_add``, and
the transforms :mod:`.fft`'s (cuFFT on the card).  ``stft`` and
``istft`` follow the JAX functions, not ``torch.stft``: the window is
centre-padded to ``n_fft`` when shorter, the centre padding takes
``pad_mode`` (``reflect``, ``constant``, ``edge``/``replicate``,
``symmetric``, ``wrap``/``circular``), ``normalized`` divides by
``sqrt(n_fft)``, complex input needs ``onesided=False``, and ``istft``
divides by the window's squared overlap-added envelope where it exceeds
1e-11.
"""
from __future__ import annotations

import math

import torch

__all__ = ["frame", "overlap_add", "stft", "istft"]


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Overlapping frames of ``frame_length`` every ``hop_length`` samples
    along the last axis (``[..., frame_length, n_frames]``) or the first
    (``[frame_length, n_frames, ...]``)."""
    frame_length, hop_length = int(frame_length), int(hop_length)
    if hop_length <= 0:
        raise ValueError("hop_length must be positive")
    ax = axis % x.dim() if x.dim() else 0
    if ax not in (0, x.dim() - 1):
        raise ValueError("axis must be the first or last dimension")
    n = x.shape[ax]
    if frame_length > n:
        raise ValueError(
            f"frame_length ({frame_length}) > signal length ({n})")
    if ax == x.dim() - 1:
        return x.unfold(-1, frame_length, hop_length).transpose(-1, -2)
    out = x.movedim(0, -1).unfold(-1, frame_length, hop_length)
    return out.movedim((-1, -2), (0, 1))


def _ola_index(n_frames: int, frame_length: int, hop: int, device):
    """Each frame element's output position, frame-major ``[F·L]``."""
    starts = torch.arange(n_frames, device=device) * hop
    return (starts[:, None] + torch.arange(frame_length, device=device)
            ).reshape(-1)


def _ola_last(a: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add of ``[..., L, F]`` frames along the last axis."""
    L, F = a.shape[-2], a.shape[-1]
    n = (F - 1) * hop + L
    vals = a.transpose(-1, -2).reshape(a.shape[:-2] + (F * L,))
    out = a.new_zeros(a.shape[:-2] + (n,))
    return out.index_add(-1, _ola_index(F, L, hop, a.device), vals)


def overlap_add(x, hop_length, axis=-1, name=None):
    """The inverse of :func:`frame`: overlapping frames summed
    ``hop_length`` apart; ``[..., frame_length, n_frames]`` (``axis``
    -1) or ``[frame_length, n_frames, ...]`` (``axis`` 0)."""
    hop_length = int(hop_length)
    if axis % x.dim() == 0:
        out = _ola_last(x.movedim((0, 1), (-2, -1)), hop_length)
        return out.movedim(-1, 0)
    return _ola_last(x, hop_length)


def _window(window, win_length: int, n_fft: int, device, check: bool):
    """The window (ones for None) centre-padded to ``n_fft``."""
    if window is None:
        w = torch.ones(win_length, device=device)
    else:
        w = torch.as_tensor(window, device=device)
        if check and tuple(w.shape) != (win_length,):
            raise ValueError("window must be 1-D of length win_length")
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        w = torch.nn.functional.pad(w, (lp, n_fft - win_length - lp))
    return w


def _pad_index(n: int, pad: int, mode: str, device) -> torch.Tensor:
    """Source positions of a signal of ``n`` padded by ``pad`` on both
    sides (-1 where ``constant`` fills zeros), as ``np.pad`` places
    them."""
    i = torch.arange(-pad, n + pad, device=device)
    if mode == "constant":
        return torch.where((i >= 0) & (i < n), i, torch.full_like(i, -1))
    if mode in ("edge", "replicate"):
        return i.clamp(0, n - 1)
    if mode in ("wrap", "circular"):
        return torch.remainder(i, n)
    if mode == "reflect":
        period = 2 * (n - 1)
        r = torch.remainder(i, period) if period else torch.zeros_like(i)
        return torch.where(r < n, r, period - r)
    if mode == "symmetric":
        r = torch.remainder(i, 2 * n)
        return torch.where(r < n, r, 2 * n - 1 - r)
    raise ValueError(f"unsupported pad_mode {mode!r}")


def _pad_last(a: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    src = _pad_index(a.shape[-1], pad, mode, a.device)
    out = a.index_select(-1, src.clamp(min=0))
    if mode == "constant":
        out = out * (src >= 0).to(out.real.dtype)
    return out


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """Short-time Fourier transform: ``[..., n_fft // 2 + 1 (onesided) or
    n_fft, n_frames]``."""
    n_fft = int(n_fft)
    hop_length = int(hop_length) if hop_length is not None else n_fft // 4
    win_length = int(win_length) if win_length is not None else n_fft
    w = _window(window, win_length, n_fft, x.device, check=True)
    if onesided and x.is_complex():
        raise ValueError("stft with complex input requires onesided=False "
                         "(matches the reference's check)")
    squeeze = x.dim() == 1
    a = x[None] if squeeze else x
    if center:
        a = _pad_last(a, n_fft // 2, pad_mode)
    n = a.shape[-1]
    if n < n_fft:
        raise ValueError(
            f"Input frame size should be less or equal than signal frame "
            f"size ({n}), but got: {n_fft}. (with center={center} the "
            f"signal is padded by n_fft//2 on both sides first)")
    frames = a.unfold(-1, n_fft, hop_length) * w.to(a.dtype)
    if onesided:
        spec = torch.fft.rfft(frames, dim=-1)
    else:
        spec = torch.fft.fft(frames.to(torch.complex128 if frames.dtype in (
            torch.float64, torch.complex128) else torch.complex64), dim=-1)
    if normalized:
        spec = spec / math.sqrt(n_fft)
    out = spec.transpose(-1, -2)
    return out[0] if squeeze else out


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """Inverse STFT: the frames' inverse transforms, windowed,
    overlap-added and divided by the squared window's envelope."""
    n_fft = int(n_fft)
    hop_length = int(hop_length) if hop_length is not None else n_fft // 4
    win_length = int(win_length) if win_length is not None else n_fft
    w = _window(window, win_length, n_fft, x.device, check=False)
    squeeze = x.dim() == 2
    a = x[None] if squeeze else x
    spec = a.transpose(-1, -2)                  # [..., frames, freq]
    if normalized:
        spec = spec * math.sqrt(n_fft)
    if onesided:
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    else:
        frames = torch.fft.ifft(spec, n=n_fft, dim=-1)
        if not return_complex:
            frames = frames.real
    frames = frames * w.to(frames.dtype)
    F = frames.shape[-2]
    n = (F - 1) * hop_length + n_fft
    idx = _ola_index(F, n_fft, hop_length, frames.device)
    sig = frames.new_zeros(frames.shape[:-2] + (n,)).index_add(
        -1, idx, frames.reshape(frames.shape[:-2] + (-1,)))
    wsq = (w * w).to(frames.real.dtype)
    env = wsq.new_zeros(n).index_add(0, idx, wsq.repeat(F))
    sig = sig / torch.where(env.abs() > 1e-11, env, torch.ones_like(env))
    if center:
        pad = n_fft // 2
        sig = sig[..., pad:n - pad]
    if length is not None:
        sig = sig[..., :length]
        if sig.shape[-1] < length:
            sig = torch.nn.functional.pad(sig, (0, length - sig.shape[-1]))
    return sig[0] if squeeze else sig
