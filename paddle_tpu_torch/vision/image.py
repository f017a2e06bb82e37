"""The image backend (port of ``paddle_tpu/vision/image.py``): which loader
``image_load`` uses, ``"pil"`` (a ``PIL.Image``), ``"cv2"`` (an HWC BGR
array from ``cv2.imread``) or ``"tensor"`` (a CHW uint8 ``torch.Tensor``
on the port's current device)."""
from __future__ import annotations

import importlib

import numpy as np
import torch

from ..device import current_device

__all__ = ["set_image_backend", "get_image_backend", "image_load"]

_BACKENDS = ("pil", "cv2", "tensor")
_image_backend = "pil"


def _check(backend) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"Expected backend are one of {list(_BACKENDS)}, "
                         f"but got {backend}")


def set_image_backend(backend):
    global _image_backend
    _check(backend)
    _image_backend = backend


def get_image_backend():
    return _image_backend


def hwc_to_chw_tensor(arr) -> torch.Tensor:
    """An HW or HWC image array as a CHW tensor on the current device."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return torch.tensor(arr.transpose(2, 0, 1), device=current_device())


def image_load(path, backend=None):
    """The image at ``path`` through ``backend`` (the current one when
    None)."""
    backend = backend or _image_backend
    _check(backend)
    if backend == "cv2":
        try:
            cv2 = importlib.import_module("cv2")
        except ImportError as e:
            raise ImportError("image_load(backend='cv2') needs OpenCV "
                              "(the cv2 module)") from e
        return cv2.imread(path)
    from PIL import Image

    img = Image.open(path)
    if backend == "pil":
        return img
    return hwc_to_chw_tensor(img)
