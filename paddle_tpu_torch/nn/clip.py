"""Gradient clipping.

Port of ``paddle_tpu/nn/clip.py``: ``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm`` and ``clip_grad_norm_``.  A
clip object maps a list of ``(parameter, gradient)`` pairs to a new one,
as the optimizer hands it over before its update
(``Optimizer(grad_clip=)``); a parameter whose ``need_clip`` attribute is
False keeps its gradient.  Every norm and scale stays on the device (no
``.item()``, ``float()`` or ``bool()`` of a device value), so a clip runs
inside a train step captured as a CUDA graph.  The global norm is summed
in f32 over every gradient, and the scale is
``min(clip_norm / max(norm, 1e-12), 1)`` (``paddle_tpu/nn/clip.py:74-91``).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple, Union

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_"]

ParamsGrads = List[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _clipped(p: torch.Tensor, g: Optional[torch.Tensor]) -> bool:
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads: ParamsGrads) -> ParamsGrads:
        return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads: ParamsGrads) -> ParamsGrads:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient element into ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max: float, min: Optional[float] = None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _dygraph_clip(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm`` (the
    norm in the gradient's dtype, as the JAX package takes it)."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def _scaled(self, g: torch.Tensor) -> torch.Tensor:
        nrm = torch.sqrt(torch.sum(torch.square(g)))
        return g * torch.clamp(self.clip_norm / torch.clamp(nrm, min=1e-12),
                               max=1.0)

    def _dygraph_clip(self, params_grads):
        return [(p, self._scaled(g) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """Every clipped gradient scaled by one factor, so that their joint L2
    norm (summed in f32) is at most ``clip_norm``.  The scaled gradients
    are f32, the dtype the optimizer's update widens them to: the JAX
    package multiplies a bf16 gradient by the scale rounded to bf16, which
    can leave the clipped norm up to 2**-9 above ``clip_norm``."""

    def __init__(self, clip_norm: float, group_name: str = "default_group",
                 auto_skip_clip: bool = False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    @staticmethod
    def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
        """The f32 L2 norm over ``grads``, on their device."""
        total = None
        for g in grads:
            s = torch.sum(torch.square(g.float()))
            total = s if total is None else total + s
        return torch.sqrt(total)

    def _dygraph_clip(self, params_grads):
        grads = [g for p, g in params_grads if _clipped(p, g)]
        if not grads:
            return params_grads
        norm = self.global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return [(p, g.float() * scale if _clipped(p, g) else g)
                for p, g in params_grads]


def clip_grad_norm_(parameters: Union[torch.Tensor, Iterable[torch.Tensor]],
                    max_norm: float, norm_type: float = 2.0,
                    error_if_nonfinite: bool = False) -> torch.Tensor:
    """Scale the gradients of ``parameters`` in place so that their joint
    ``norm_type`` norm is at most ``max_norm`` (the coefficient
    ``min(max_norm / (norm + 1e-6), 1)``, as the JAX package's utility);
    returns the norm before clipping, a device scalar."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        device = parameters[0].device if parameters else "cpu"
        return torch.zeros((), device=device)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = None
        for g in grads:
            s = torch.sum(torch.pow(torch.abs(g.float()), norm_type))
            total = s if total is None else total + s
        total = torch.pow(total, 1.0 / norm_type)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))
    return total
