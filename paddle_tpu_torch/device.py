"""The port's current device: Paddle's ``set_device``/``get_device``.

Port of ``paddle_tpu/core/device.py``'s pair, on torch devices.  The
layers of :mod:`.nn` make their parameters and buffers on this device
unless a ``device=`` is passed to them.  It is the card (``"gpu"``, torch's
``cuda``) until :func:`set_device` names another, and reading it with no
card present raises: the CPU is asked for explicitly, with
``set_device("cpu")`` or, for a block, :func:`device_guard`.  torch's own
default device (``torch.set_default_device``, ``with torch.device(...)``)
does not move it.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__all__ = ["set_device", "get_device", "current_device", "device_guard"]

DeviceLike = Union[str, torch.device]

_current: Optional[torch.device] = None


def _parse(device: DeviceLike) -> torch.device:
    if isinstance(device, torch.device):
        return device
    kind, _, idx = str(device).lower().partition(":")
    if kind in ("gpu", "cuda"):
        kind = "cuda"
    elif kind != "cpu":
        raise ValueError(f"unsupported device {device!r} (want 'gpu', "
                         f"'gpu:N', 'cuda', 'cuda:N' or 'cpu')")
    return torch.device(kind, int(idx)) if idx else torch.device(kind)


def _check(device: torch.device) -> torch.device:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but no CUDA device is "
            f"available (paddle_tpu_torch.set_device('cpu') runs on the "
            f"CPU)")
    return device


def set_device(device: DeviceLike) -> torch.device:
    """Make ``device`` (``"gpu"``, ``"gpu:N"``, ``"cuda[:N]"``, ``"cpu"``
    or a ``torch.device``) the current device; a card that is not there
    raises."""
    global _current
    _current = _check(_parse(device))
    return _current


def current_device() -> torch.device:
    """The current device as a ``torch.device`` (``cuda`` if none was
    set; raises where there is no card)."""
    return _check(torch.device("cuda") if _current is None else _current)


def get_device() -> str:
    """Paddle's name of the current device: ``"gpu:N"`` or ``"cpu"``."""
    device = current_device()
    if device.type == "cuda":
        idx = torch.cuda.current_device() if device.index is None \
            else device.index
        return f"gpu:{idx}"
    return device.type


@contextlib.contextmanager
def device_guard(device: DeviceLike):
    """``set_device(device)`` for the block, then the device before it."""
    global _current
    before = _current
    set_device(device)
    try:
        yield _current
    finally:
        _current = before
