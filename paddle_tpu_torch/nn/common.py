"""Layers of the port from ``paddle_tpu/nn/layer/common.py``: ``Dropout``."""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from .functional import dropout

__all__ = ["Dropout"]


class Dropout(nn.Module):
    """``Dropout(p=0.5, axis=None, mode="upscale_in_train")``:
    :func:`.functional.dropout` with ``training=self.training``, so
    ``eval()`` turns it off."""

    def __init__(self, p: float = 0.5,
                 axis: Union[None, int, Sequence[int]] = None,
                 mode: str = "upscale_in_train"):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, p=self.p, axis=self.axis, training=self.training,
                       mode=self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}"
