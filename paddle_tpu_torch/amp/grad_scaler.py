"""Dynamic loss scaling, every decision on the device.

Port of ``paddle_tpu/amp/grad_scaler.py`` ``GradScaler`` (:41-210), with
its surface, its rule and its state-dict keys.  The scale and the good
and bad step counts are device tensors, made at the first eager call on
the loss's (or the gradients') device; made inside a CUDA graph capture
they would be reset at every replay, so that raises, as the optimizer's
state does.  ``unscale_`` latches ``found_inf`` as a device bool;
``step`` runs the optimizer with every write of a parameter, an f32
master and an accumulator gated by it (``torch.where``: an overflowing
step leaves them all, and an accumulator born in that step, exactly as
they were), and ``update`` applies the scale rule with device selects.
Nothing reads ``found_inf`` on the host, so scale, backward, ``step`` and
``update`` can be captured in one graph and replayed.  The JAX package
snapshots the state and selects after the step; gating each write gives
the same values without a second copy of the state (about 4.3 GB at GPT-2
345M under O1: f32 parameters and two f32 moments).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["GradScaler", "AmpScaler"]


def _host(v, dtype) -> torch.Tensor:
    """A state-dict leaf (a tensor, an array or a scalar) as a CPU tensor
    of ``dtype``."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", dtype)
    return torch.tensor(np.asarray(v), dtype=dtype)


class GradScaler:
    """``GradScaler(enable=True, init_loss_scaling=2**15, incr_ratio=2.0,
    decr_ratio=0.5, incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
    use_dynamic_loss_scaling=True)``; a step is ``scaler.scale(loss)
    .backward()``, ``scaler.step(opt)`` (or ``minimize``), then
    ``scaler.update()``.  ``opt`` is an optimizer of
    :mod:`paddle_tpu_torch.optimizer`."""

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._use_dynamic = use_dynamic_loss_scaling and enable
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        # the state before it is on a device: scale, good and bad counts
        self._host_state = (torch.tensor(float(init_loss_scaling) if enable
                                         else 1.0, dtype=torch.float32),
                            torch.tensor(0, dtype=torch.int32),
                            torch.tensor(0, dtype=torch.int32))
        self._scale_t = self._good_t = self._bad_t = None
        self._found_inf: Optional[torch.Tensor] = None
        self._unscaled = False

    # -- state on the device -------------------------------------------------

    def _on(self, device: torch.device) -> None:
        """Make the scale and the counts on ``device`` (once)."""
        if self._scale_t is not None:
            return
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "GradScaler: its state would be made inside a CUDA graph "
                "capture (and reset at every replay); run the step once "
                "eagerly before capturing it")
        self._scale_t, self._good_t, self._bad_t = (
            t.to(device, copy=True) for t in self._host_state)

    def _state(self):
        if self._scale_t is not None:
            return self._scale_t, self._good_t, self._bad_t
        return self._host_state

    # -- public API (reference surface) --------------------------------------

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._use_dynamic

    def get_loss_scaling(self) -> float:
        """The scale, read on the host: keep it out of a compiled step."""
        return float(self._state()[0])

    def set_init_loss_scaling(self, v: float) -> None:
        self._state()[0].fill_(float(v))

    @property
    def found_inf(self) -> Optional[torch.Tensor]:
        """The overflow latch of the last ``unscale_``: a device bool
        tensor (None before the first unscale and after ``update``)."""
        return self._found_inf

    @property
    def scale_tensor(self) -> Optional[torch.Tensor]:
        """The live scale, an f32 device tensor that a compiled step may
        read (None until the first call made it)."""
        return self._scale_t

    def scale(self, var: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return var
        self._on(var.device)
        return var * self._scale_t.to(var.dtype)

    @staticmethod
    def _grads(optimizer):
        return [p.grad for group in optimizer.param_groups
                for p in group["params"] if p.grad is not None]

    def unscale_(self, optimizer) -> None:
        """Divide the gradients by the scale, in place, and latch
        ``found_inf`` (reference: check_finite_and_unscale op)."""
        grads = self._grads(optimizer)
        if not self._enable:
            device = grads[0].device if grads else torch.device("cpu")
            self._found_inf = torch.zeros((), dtype=torch.bool,
                                          device=device)
            return
        if self._unscaled:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer since "
                "the last update()")
        if not grads:
            raise ValueError("unscale_: the optimizer's parameters have no "
                             "gradients")
        self._on(grads[0].device)
        inv = 1.0 / self._scale_t
        finite = []
        for g in grads:
            g.copy_(g.float() * inv)
            finite.append(torch.isfinite(g).all())
        self._found_inf = ~torch.stack(finite).all()
        self._unscaled = True

    def step(self, optimizer) -> None:
        """``unscale_`` (unless done), then the optimizer's step with every
        write gated by ``found_inf``."""
        from ..optimizer import Optimizer

        if not isinstance(optimizer, Optimizer):
            raise TypeError("GradScaler.step takes an optimizer of "
                            "paddle_tpu_torch.optimizer, got "
                            f"{type(optimizer).__name__}")
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        optimizer._found_inf = self._found_inf
        try:
            optimizer.step()
        finally:
            optimizer._found_inf = None
        self._unscaled = False

    def update(self) -> None:
        """The dynamic scale rule (reference: update_loss_scaling op), as
        device selects."""
        if not self._use_dynamic or self._found_inf is None:
            return
        found = self._found_inf
        scale, good, bad = self._scale_t, self._good_t, self._bad_t
        zero = torch.zeros_like(good)
        new_good = torch.where(found, zero, good + 1)
        new_bad = torch.where(found, bad + 1, zero)
        decr = new_bad >= self._decr_every_n_nan_or_inf
        new_scale = torch.where(
            decr, torch.clamp(scale * self._decr_ratio, min=1.0), scale)
        new_bad = torch.where(decr, zero, new_bad)
        incr = new_good >= self._incr_every_n_steps
        new_scale = torch.where(incr, new_scale * self._incr_ratio,
                                new_scale)
        new_good = torch.where(incr, zero, new_good)
        good.copy_(new_good)
        bad.copy_(new_bad)
        scale.copy_(new_scale)
        self._found_inf = None

    def minimize(self, optimizer, scaled_loss, *args, **kwargs) -> None:
        """reference: scaler.minimize = step + update (backward already run
        by the caller on the scaled loss)."""
        self.step(optimizer)
        self.update()

    def state_dict(self) -> dict:
        scale, good, bad = self._state()
        return {
            "scale": scale.clone(),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "incr_count": good.clone(),
            "decr_count": bad.clone(),
            "use_dynamic_loss_scaling": self._use_dynamic,
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore from :meth:`state_dict` (leaves may be tensors, numpy or
        JAX arrays, or Python scalars); a state already on the device is
        written in place, so a captured step reads the restored values."""
        scale, good, bad = self._state()
        scale.copy_(_host(sd["scale"], torch.float32))
        good.copy_(_host(sd.get("incr_count", 0), torch.int32))
        bad.copy_(_host(sd.get("decr_count", 0), torch.int32))
        self._incr_ratio = float(sd.get("incr_ratio", self._incr_ratio))
        self._decr_ratio = float(sd.get("decr_ratio", self._decr_ratio))
        self._incr_every_n_steps = int(
            sd.get("incr_every_n_steps", self._incr_every_n_steps))
        self._decr_every_n_nan_or_inf = int(
            sd.get("decr_every_n_nan_or_inf", self._decr_every_n_nan_or_inf))
        if "use_dynamic_loss_scaling" in sd:
            self._use_dynamic = bool(sd["use_dynamic_loss_scaling"]) \
                and self._enable


AmpScaler = GradScaler  # legacy alias (fluid/dygraph/amp/loss_scaler.py:40)
