"""``paddle.sysconfig``: where the package's headers and libraries are.
The port builds its CUDA sources at first use into ``_build/``, which is
its library directory; its headers are the CUDA sources' directory."""
from __future__ import annotations

import os

__all__ = ["get_include", "get_lib"]

_ROOT = os.path.dirname(os.path.abspath(__file__))


def get_include() -> str:
    return os.path.join(_ROOT, "csrc")


def get_lib() -> str:
    return os.path.join(_ROOT, "_build")
