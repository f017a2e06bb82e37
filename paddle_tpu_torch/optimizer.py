"""AdamW with Paddle's semantics and f32 master weights.

Port of ``paddle_tpu/optimizer/optimizer.py`` ``Adam``/``AdamW``
(:415-485) and its master weights (:263-288), as a
``torch.optim.Optimizer``.  What differs from ``torch.optim.AdamW``:

- epsilon is added to ``sqrt(v_hat)`` after bias correction, with
  per-parameter ``beta1_pow``/``beta2_pow`` accumulators in f32;
- weight decay (default 0.01) is decoupled and applied to every parameter
  unless ``apply_decay_param_fun(name)`` says otherwise;
- a bf16 or f16 parameter gets an f32 master copy, made from its value at
  the first step.  Gradients are widened to f32 and all update math is in
  f32; the parameter receives the master rounded to its dtype.  Without
  the master, an update smaller than the parameter's bf16 resolution
  would be lost, as it is with ``torch.optim.AdamW`` on bf16 parameters;
- ``moment_dtype`` (default f32) may store the moments narrower; they
  are widened for the update and rounded when stored.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

__all__ = ["AdamW"]

_LOW = (torch.bfloat16, torch.float16)


def _dtype(d: Union[None, str, torch.dtype]) -> torch.dtype:
    if d is None:
        return torch.float32
    if isinstance(d, str):
        return getattr(torch, d)
    return d


class AdamW(torch.optim.Optimizer):
    """``AdamW(params, lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
    weight_decay=0.01, apply_decay_param_fun=None, moment_dtype=None)``.

    ``params`` are tensors, or ``(name, tensor)`` pairs such as
    ``model.named_parameters()``; ``apply_decay_param_fun`` is called with
    the name and needs the pairs."""

    def __init__(self, params, lr: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
                 moment_dtype: Union[None, str, torch.dtype] = None):
        params = list(params)
        self._names = {}
        if params and isinstance(params[0], tuple):
            self._names = {id(p): n for n, p in params}
            params = [p for _, p in params]
        if apply_decay_param_fun is not None and not self._names:
            raise ValueError("apply_decay_param_fun needs (name, parameter) "
                             "pairs, e.g. model.named_parameters()")
        super().__init__(params, dict(lr=lr, beta1=beta1, beta2=beta2,
                                      epsilon=epsilon,
                                      weight_decay=weight_decay))
        self.apply_decay_param_fun = apply_decay_param_fun
        self.moment_dtype = _dtype(moment_dtype)

    def _state(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:
            f32 = dict(dtype=torch.float32, device=p.device)
            st["moment1"] = torch.zeros(p.shape, dtype=self.moment_dtype,
                                        device=p.device)
            st["moment2"] = torch.zeros_like(st["moment1"])
            st["beta1_pow"] = torch.ones((), **f32)
            st["beta2_pow"] = torch.ones((), **f32)
            if p.dtype in _LOW:
                st["master_weight"] = p.detach().float()
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, b1, b2 = group["lr"], group["beta1"], group["beta2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                wd = group["weight_decay"]
                if self.apply_decay_param_fun is not None and \
                        not self.apply_decay_param_fun(self._names[id(p)]):
                    wd = 0.0
                st = self._state(p)
                g32 = p.grad.float()
                m = st["moment1"].float() * b1 + (1 - b1) * g32
                v = st["moment2"].float() * b2 + (1 - b2) * g32.square()
                st["beta1_pow"].mul_(b1)
                st["beta2_pow"].mul_(b2)
                st["moment1"].copy_(m)
                st["moment2"].copy_(v)
                m_hat = m / (1.0 - st["beta1_pow"])
                v_hat = v / (1.0 - st["beta2_pow"])
                master = st.get("master_weight")
                p32 = master if master is not None else p.float()
                if wd:
                    p32 = p32 * (1.0 - lr * wd)
                new = p32 - lr * m_hat / (v_hat.sqrt() + group["epsilon"])
                if master is not None:
                    master.copy_(new)
                p.copy_(new)
        return loss
