"""``paddle.hapi``: the high-level ``Model`` API, its callbacks,
``summary`` and ``flops``.

Port of ``paddle_tpu/hapi``.
"""
from . import callbacks
from .dynamic_flops import flops
from .model import Model
from .summary import summary

__all__ = ["Model", "callbacks", "flops", "summary"]
