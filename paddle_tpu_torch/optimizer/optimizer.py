"""Optimizers with Paddle's semantics: SGD, Adam and AdamW, f32 masters.

Port of ``paddle_tpu/optimizer/optimizer.py`` ``Optimizer`` (:23-375),
``SGD`` (:379), ``Adam`` and ``AdamW`` (:415-485) and its master weights
(:263-288), as ``torch.optim.Optimizer`` subclasses.  What the base adds:

- ``lr`` is a float or an :class:`~.lr.LRScheduler`.  Under a scheduler
  every update reads the rate from the scheduler's f32 scalar on the
  parameter's device (``LRScheduler._lr_tensor``), never as a Python
  float, so a step captured as a CUDA graph follows the schedule.  A float
  rate is a constant of such a program, as it is of the JAX program;
  ``set_lr`` refuses under a scheduler, and once a step of this optimizer
  was captured (the program would keep the old constant).
- ``grad_clip`` (:mod:`..nn.clip`) maps the ``(parameter, gradient)``
  pairs before the update (``optimizer.py:200-201``).
- ``get_lr``, ``clear_grad`` and a ``state_dict`` that carries the
  scheduler's under ``"@lr_scheduler"`` (:312, :357).
- a bf16 or f16 parameter gets an f32 master copy, made from its value at
  its first step.  Gradients are widened to f32 and all update math is in
  f32; the parameter receives the master rounded to its dtype.  Without
  the master, an update smaller than the parameter's bf16 resolution
  would be lost.

Adam and AdamW differ from ``torch.optim``'s: epsilon is added to
``sqrt(v_hat)`` after bias correction, with per-parameter
``beta1_pow``/``beta2_pow`` accumulators in f32; ``moment_dtype``
(default f32) may store the moments narrower (widened for the update,
rounded when stored).  Adam's ``weight_decay`` is L2 added to the
gradient; AdamW's (default 0.01) is decoupled and applied to every
parameter unless ``apply_decay_param_fun(name)`` says otherwise.

Optimizer state (moments, masters) is made at a parameter's first step
and must exist before a step is captured: made inside a capture it would
be zeroed at every replay, so that raises.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]

_LOW = (torch.bfloat16, torch.float16)

LearningRate = Union[float, LRScheduler]


def _dtype(d: Union[None, str, torch.dtype]) -> torch.dtype:
    if d is None:
        return torch.float32
    if isinstance(d, str):
        return getattr(torch, d)
    return d


def _capturing(p: torch.Tensor) -> bool:
    return p.is_cuda and torch.cuda.is_current_stream_capturing()


class Optimizer(torch.optim.Optimizer):
    """The base: ``params`` are tensors, or ``(name, tensor)`` pairs such
    as ``model.named_parameters()`` (the names are what
    ``apply_decay_param_fun`` is given); ``defaults`` go to every group."""

    def __init__(self, params, lr: LearningRate, defaults: dict,
                 grad_clip=None):
        params = list(params)
        self._names = {}
        if params and isinstance(params[0], tuple):
            self._names = {id(p): n for n, p in params}
            params = [p for _, p in params]
        super().__init__(params, defaults)
        self._learning_rate = lr
        self._grad_clip = grad_clip
        self._captured = False

    # -- lr ------------------------------------------------------------------

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "set_lr is not allowed when learning rate is an "
                "LRScheduler; use scheduler.step() instead")
        if self._captured:
            raise RuntimeError(
                "set_lr: a step of this optimizer was captured as a CUDA "
                "graph, which holds the float learning rate as a constant; "
                "give the optimizer an LRScheduler to change the rate of a "
                "compiled step")
        self._learning_rate = float(value)

    def _lr(self, p: torch.Tensor):
        """The rate of ``p``'s update: the scheduler's device scalar, or
        the float."""
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate._lr_tensor(p.device)
        return float(self._learning_rate)

    # -- state ---------------------------------------------------------------

    #: accumulators every parameter gets at its first step (a bf16 or f16
    #: parameter also gets its f32 ``master_weight``)
    _ACCUMULATORS = ()

    def _state(self, p: torch.Tensor) -> dict:
        """``p``'s state, made at its first step (refused inside a graph
        capture)."""
        st = self.state[p]
        if not st and (self._ACCUMULATORS or p.dtype in _LOW):
            if _capturing(p):
                raise RuntimeError(
                    f"{type(self).__name__}: optimizer state would be made "
                    "inside a CUDA graph capture (and zeroed at every "
                    "replay); run the step once eagerly before capturing it")
            if p.dtype in _LOW:
                st["master_weight"] = p.detach().float()
            st.update(self._make_state(p))
        return st

    def _make_state(self, p: torch.Tensor) -> dict:
        return {}

    def _param32(self, p: torch.Tensor, st: dict) -> torch.Tensor:
        master = st.get("master_weight")
        return master if master is not None else p.float()

    @staticmethod
    def _apply(p: torch.Tensor, st: dict, new32: torch.Tensor) -> None:
        master = st.get("master_weight")
        if master is not None:
            master.copy_(new32)
        p.copy_(new32)

    # -- step ----------------------------------------------------------------

    def _params_grads(self):
        return [(p, p.grad) for group in self.param_groups
                for p in group["params"] if p.grad is not None]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params_grads = self._params_grads()
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        grads = {id(p): g for p, g in params_grads}
        for group in self.param_groups:
            for p in group["params"]:
                g = grads.get(id(p))
                if g is None:
                    continue
                if _capturing(p):
                    self._captured = True
                self._update(p, g.float(), group)
        return loss

    def _update(self, p: torch.Tensor, g32: torch.Tensor,
                group: dict) -> None:
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = False) -> None:
        """Drop every gradient (``set_to_zero``: zero it in place)."""
        self.zero_grad(set_to_none=not set_to_zero)

    # -- state dict ------------------------------------------------------------

    def state_dict(self) -> dict:
        sd = super().state_dict()
        if isinstance(self._learning_rate, LRScheduler):
            sd["@lr_scheduler"] = self._learning_rate.state_dict()
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        sched = state_dict.pop("@lr_scheduler", None)
        super().load_state_dict(state_dict)
        if sched is not None and isinstance(self._learning_rate,
                                            LRScheduler):
            self._learning_rate.set_state_dict(sched)

    set_state_dict = load_state_dict


class SGD(Optimizer):
    """``SGD(params, lr=1e-3, weight_decay=None, grad_clip=None)``:
    ``p -= lr * (g + weight_decay * p)``."""

    def __init__(self, params, lr: LearningRate = 1e-3,
                 weight_decay: Optional[float] = None, grad_clip=None):
        super().__init__(params, lr, dict(weight_decay=weight_decay or 0.0),
                         grad_clip)

    def _update(self, p, g32, group):
        st = self._state(p)
        if group["weight_decay"]:
            g32 = g32 + group["weight_decay"] * p.float()
        self._apply(p, st, self._param32(p, st) - self._lr(p) * g32)


class Adam(Optimizer):
    """``Adam(params, lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
    weight_decay=None, grad_clip=None, moment_dtype=None)``; weight decay
    is L2 added to the gradient."""

    def __init__(self, params, lr: LearningRate = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: Optional[float] = None, grad_clip=None,
                 moment_dtype: Union[None, str, torch.dtype] = None):
        super().__init__(params, lr, dict(beta1=beta1, beta2=beta2,
                                          epsilon=epsilon,
                                          weight_decay=weight_decay or 0.0),
                         grad_clip)
        self.moment_dtype = _dtype(moment_dtype)

    _ACCUMULATORS = ("moment1", "moment2", "beta1_pow", "beta2_pow")

    def _make_state(self, p):
        f32 = dict(dtype=torch.float32, device=p.device)
        m1 = torch.zeros(p.shape, dtype=self.moment_dtype, device=p.device)
        return {"moment1": m1, "moment2": torch.zeros_like(m1),
                "beta1_pow": torch.ones((), **f32),
                "beta2_pow": torch.ones((), **f32)}

    def _update(self, p, g32, group):
        if group["weight_decay"]:
            g32 = g32 + group["weight_decay"] * p.float()
        self._adam(p, g32, group, 0.0)

    def _adam(self, p, g32, group, decoupled_wd: float) -> None:
        st = self._state(p)
        lr, b1, b2 = self._lr(p), group["beta1"], group["beta2"]
        m = st["moment1"].float() * b1 + (1 - b1) * g32
        v = st["moment2"].float() * b2 + (1 - b2) * g32.square()
        st["beta1_pow"].mul_(b1)
        st["beta2_pow"].mul_(b2)
        st["moment1"].copy_(m)
        st["moment2"].copy_(v)
        m_hat = m / (1.0 - st["beta1_pow"])
        v_hat = v / (1.0 - st["beta2_pow"])
        p32 = self._param32(p, st)
        if decoupled_wd:
            p32 = p32 * (1.0 - lr * decoupled_wd)
        self._apply(p, st, p32 - lr * m_hat / (v_hat.sqrt()
                                               + group["epsilon"]))


class AdamW(Adam):
    """``AdamW(params, lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
    weight_decay=0.01, apply_decay_param_fun=None, grad_clip=None,
    moment_dtype=None)``; weight decay decoupled."""

    def __init__(self, params, lr: LearningRate = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
                 grad_clip=None,
                 moment_dtype: Union[None, str, torch.dtype] = None):
        super().__init__(params, lr, beta1, beta2, epsilon, weight_decay,
                         grad_clip, moment_dtype)
        if apply_decay_param_fun is not None and not self._names:
            raise ValueError("apply_decay_param_fun needs (name, parameter) "
                             "pairs, e.g. model.named_parameters()")
        self.apply_decay_param_fun = apply_decay_param_fun

    def _update(self, p, g32, group):
        wd = group["weight_decay"]
        if self.apply_decay_param_fun is not None and \
                not self.apply_decay_param_fun(self._names[id(p)]):
            wd = 0.0
        self._adam(p, g32, group, wd)
