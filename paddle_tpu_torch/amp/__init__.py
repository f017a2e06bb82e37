"""Automatic mixed precision (port of ``paddle_tpu/amp``):
:func:`auto_cast` (the JAX package's per-op policy), :func:`decorate`
(O2) and :class:`GradScaler` (dynamic loss scaling on the device)."""
from .auto_cast import (
    BLACK_LIST, LOW_DTYPES, WHITE_LIST, amp_guard, amp_op, amp_state,
    auto_cast, decorate,
)
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "AmpScaler",
           "amp_op", "amp_state", "WHITE_LIST", "BLACK_LIST", "LOW_DTYPES"]
