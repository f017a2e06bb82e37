"""Paddle's top-level tensor names on torch: the dtype names,
``to_tensor``, the autograd switches and the odds and ends of
``paddle_tpu/__init__.py`` (``reverse``, ``create_parameter``, ``finfo``,
``iinfo``, the build predicates, the CUDA generator states).

There is no Tensor wrapper: ``to_tensor`` returns a ``torch.Tensor`` on
the port's current device, ``requires_grad`` set to ``not
stop_gradient``.  The build predicates answer for the torch this package
runs on, and ``get_cuda_rng_state`` / ``set_cuda_rng_state`` read and
write the port's own generators (:mod:`.rng`) of the CUDA devices.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng
from .device import _parse, current_device
from .ops._helpers import convert_dtype, get_default_dtype, \
    set_default_dtype

__all__ = [
    "bfloat16", "float16", "float32", "float64", "int8", "int16", "int32",
    "int64", "uint8", "uint16", "uint32", "uint64", "bool", "bool_",
    "complex64", "complex128", "float8_e4m3fn", "float8_e5m2", "dtype",
    "get_default_dtype", "set_default_dtype", "to_tensor", "no_grad",
    "enable_grad", "set_grad_enabled", "is_grad_enabled", "grad",
    "reverse", "create_parameter", "finfo", "iinfo", "is_compiled_with_cuda",
    "is_compiled_with_xpu", "is_compiled_with_npu", "is_compiled_with_rocm",
    "is_compiled_with_cinn", "get_cudnn_version", "get_cuda_rng_state",
    "set_cuda_rng_state", "disable_signal_handler", "in_dynamic_mode",
]

bfloat16, float16, float32, float64 = (torch.bfloat16, torch.float16,
                                       torch.float32, torch.float64)
int8, int16, int32, int64 = torch.int8, torch.int16, torch.int32, torch.int64
uint8, uint16, uint32, uint64 = (torch.uint8, torch.uint16, torch.uint32,
                                 torch.uint64)
bool = bool_ = torch.bool  # noqa: A001 — Paddle's name
complex64, complex128 = torch.complex64, torch.complex128
float8_e4m3fn, float8_e5m2 = torch.float8_e4m3fn, torch.float8_e5m2
#: the metatype: ``isinstance(x.dtype, paddle.dtype)``
dtype = torch.dtype

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled
grad = torch.autograd.grad


def to_tensor(data, dtype=None, place=None, stop_gradient=True
              ) -> torch.Tensor:
    """``data`` (a tensor, array, list or scalar) as a tensor on ``place``
    (a device name or ``torch.device``; the current device for None) in
    ``dtype``: float64 data with no dtype takes the default dtype, as in
    the JAX package, and integers stay int64."""
    dev = current_device() if place is None else _parse(place)
    dt = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(device=dev, dtype=dt, copy=True)
    else:
        a = np.asarray(data)
        if dt is None and a.dtype == np.float64:
            dt = get_default_dtype()
        t = torch.tensor(a, device=dev)              # a copy, never a view
        if dt is not None:
            t = t.to(dt)
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def reverse(x, axis, name=None):
    """``flip`` under its older name."""
    from .ops.manipulation import flip

    return flip(x, axis)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A parameter made as a layer's ``create_parameter`` makes it, on the
    current device."""
    from .nn import layer_base

    p = layer_base.Layer().create_parameter(
        shape, attr=attr, dtype=dtype, is_bias=is_bias,
        default_initializer=default_initializer)
    if name:
        p.name = name
    return p


def finfo(dtype):
    """``torch.finfo`` of a floating dtype (any spec)."""
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):
    """``torch.iinfo`` of an integer dtype (any spec)."""
    return torch.iinfo(convert_dtype(dtype))


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built() and torch.version.hip is None


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def get_cudnn_version():
    """cuDNN's version as torch reports it (None without cuDNN)."""
    return torch.backends.cudnn.version() if \
        torch.backends.cudnn.is_available() else None


def get_cuda_rng_state():
    """The state of each CUDA device's generator (:mod:`.rng`), in device
    order: ``int64[2]`` ``[seed, offset]`` tensors."""
    return [rng.default_generator(torch.device("cuda", i)).get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state_list) -> None:
    """Load a :func:`get_cuda_rng_state` list, device by device."""
    state_list = list(state_list)
    if len(state_list) > torch.cuda.device_count():
        raise RuntimeError(f"set_cuda_rng_state: {len(state_list)} states "
                           f"for {torch.cuda.device_count()} CUDA devices")
    for i, s in enumerate(state_list):
        rng.default_generator(torch.device("cuda", i)).set_state(s)


def disable_signal_handler() -> None:
    """Paddle's switch for its C++ signal handlers, which this package
    does not install: nothing to do."""


def in_dynamic_mode() -> bool:
    """Always True: the port runs eagerly, ``jit.to_static`` captures."""
    return True
