"""The argument rules of the op surface: axes, integer lists and dtypes.

Port of ``paddle_tpu/ops/_helpers.py``'s rules, on ``torch.Tensor``.  The
JAX package wraps arrays in its own Tensor and records every op on its
tape; here the ops take and return ``torch.Tensor`` and torch's autograd
records, so there is no wrap, unwrap or op-recording hook.  Paddle's dtype
names map to ``torch.dtype`` (:func:`convert_dtype`); the port keeps
64-bit integers where the JAX package, running with x64 off, narrows them
to 32 bits.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import _parse, current_device

__all__ = ["convert_dtype", "get_default_dtype", "set_default_dtype",
           "as_int_list", "norm_axis", "dims", "device_of", "as_tensor",
           "check_host_read", "paddle_reshape_shape"]

_DTYPES = {
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
    "float32": torch.float32, "fp32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "fp64": torch.float64, "double": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int": torch.int32, "int64": torch.int64, "long": torch.int64,
    "uint8": torch.uint8, "uint16": torch.uint16, "uint32": torch.uint32,
    "uint64": torch.uint64, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
}

_default_dtype = torch.float32


def convert_dtype(dtype) -> Optional[torch.dtype]:
    """A ``torch.dtype`` for any dtype spec: a Paddle name (``"float32"``,
    ``"int64"``, ``"bool"``, ``"paddle.float32"``), a numpy dtype or type,
    or a ``torch.dtype``; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype.replace("paddle.", "")
    else:
        name = np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}") from None


def get_default_dtype() -> torch.dtype:
    """The floating dtype of a creation op given none (``float32``)."""
    return _default_dtype


def set_default_dtype(dtype) -> None:
    """``paddle.set_default_dtype``: a floating dtype only."""
    global _default_dtype
    d = convert_dtype(dtype)
    if not d.is_floating_point:
        raise TypeError(f"set_default_dtype: {dtype!r} is not a floating "
                        f"dtype")
    _default_dtype = d


def _as_int(x):
    """``int(x)``, except a symbolic size (under ``torch.export``) stays."""
    if isinstance(x, torch.SymInt):
        return x
    return int(x)


def as_int_list(v) -> List[int]:
    """A shape-like argument (an int, a list of ints or 0-d tensors, or a
    tensor) as a list of ints."""
    if isinstance(v, torch.Tensor):
        return [int(x) for x in v.reshape(-1).tolist()]
    if isinstance(v, (list, tuple, torch.Size)):
        return [int(x.item()) if isinstance(x, torch.Tensor) else _as_int(x)
                for x in v]
    return [_as_int(v)]


def norm_axis(axis) -> Union[None, int, Tuple[int, ...]]:
    """A reduction axis: None, an int, or a tuple of ints (a list or a
    tensor of axes becomes a tuple)."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.reshape(-1).tolist()
        return tuple(int(a) for a in axis) if len(axis) != 1 else int(axis[0])
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def dims(axis, ndim: int) -> Tuple[int, ...]:
    """The dims a reduction over ``axis`` covers (None: all of them)."""
    axis = norm_axis(axis)
    if axis is None:
        return tuple(range(ndim))
    return axis if isinstance(axis, tuple) else (axis,)


def device_of(*xs, device=None) -> torch.device:
    """``device`` if given, else the first tensor's among ``xs``, else the
    port's current device."""
    if device is not None:
        return _parse(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return current_device()


def as_tensor(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, anything else made on
    ``like``'s device (a Python float or float64 array in the default
    dtype, as a Paddle scalar operand is)."""
    if isinstance(x, torch.Tensor):
        return x
    dt = None
    if isinstance(x, float) or (isinstance(x, np.ndarray)
                                and x.dtype == np.float64):
        dt = _default_dtype
    dev = like.device if like is not None else current_device()
    return torch.as_tensor(x, dtype=dt, device=dev)


def check_host_read(op: str, *tensors) -> None:
    """Raise the port's ``CaptureError``, naming ``op``, when an op whose
    output shape depends on the data (it must read the device on the
    host) meets a CUDA tensor on a capturing stream."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda and \
                torch.cuda.is_current_stream_capturing():
            from ..jit import CaptureError

            raise CaptureError(
                f"paddle.{op}: its output shape depends on the data, so it "
                f"reads the device on the host, which a CUDA graph capture "
                f"cannot do; call it outside the to_static program")


def paddle_reshape_shape(orig_shape, shape) -> List[int]:
    """Paddle's reshape rule: 0 keeps the original dim, -1 is inferred."""
    return [orig_shape[i] if isinstance(s, int) and s == 0 else s
            for i, s in enumerate(as_int_list(shape))]
