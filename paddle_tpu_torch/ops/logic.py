"""Comparison, logical and bitwise ops (port of ``paddle_tpu/ops/logic.py``).

Each returns a bool (or, bitwise, an integer) tensor; a Python scalar
operand is made on the other operand's device.
"""
from __future__ import annotations

import torch

from .math import _pair

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "logical_and", "logical_or",
           "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
           "bitwise_xor", "bitwise_not", "bitwise_left_shift",
           "bitwise_right_shift", "is_empty", "is_tensor"]


def _binary(fn, name):
    def f(x, y, out=None, name=None):
        return fn(*_pair(x, y))

    f.__name__ = name
    f.__doc__ = f"``paddle.{name}`` elementwise, broadcasting."
    return f


equal = _binary(torch.eq, "equal")
not_equal = _binary(torch.ne, "not_equal")
greater_than = _binary(torch.gt, "greater_than")
greater_equal = _binary(torch.ge, "greater_equal")
less_than = _binary(torch.lt, "less_than")
less_equal = _binary(torch.le, "less_equal")
logical_and = _binary(torch.logical_and, "logical_and")
logical_or = _binary(torch.logical_or, "logical_or")
logical_xor = _binary(torch.logical_xor, "logical_xor")
bitwise_and = _binary(torch.bitwise_and, "bitwise_and")
bitwise_or = _binary(torch.bitwise_or, "bitwise_or")
bitwise_xor = _binary(torch.bitwise_xor, "bitwise_xor")
bitwise_left_shift = _binary(torch.bitwise_left_shift, "bitwise_left_shift")
bitwise_right_shift = _binary(torch.bitwise_right_shift,
                              "bitwise_right_shift")


def logical_not(x, out=None, name=None):
    return torch.logical_not(x)


def bitwise_not(x, out=None, name=None):
    return torch.bitwise_not(x)


def is_empty(x, name=None):
    """A 0-d bool tensor: ``x`` holds no element."""
    return torch.full((), x.numel() == 0, dtype=torch.bool, device=x.device)


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)
