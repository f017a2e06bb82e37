"""Learning-rate schedulers.

Port of ``paddle_tpu/optimizer/lr.py``: all 17 classes, from
:class:`LRScheduler` to :class:`CosineAnnealingWarmRestarts`, with the same
values, attribute names and ``state_dict``/``set_state_dict`` (so a state
dict saved by either package loads into the other).

A scheduler is a host-side state machine producing a float each step.  An
optimizer under a scheduler reads the rate from :meth:`LRScheduler._lr_tensor`,
one f32 scalar on each device it asks for, which :meth:`LRScheduler.step`
rewrites in place (``fill_`` on the current stream).  A train step
captured as a CUDA graph (``jit.to_static``) thus reads the new rate at
its next replay without a new capture, as the JAX program reads it without
a retrace.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

__all__ = ["LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
           "ExponentialDecay", "MultiStepDecay", "StepDecay", "LambdaDecay",
           "MultiplicativeDecay", "CosineAnnealingDecay", "ReduceOnPlateau",
           "CyclicLR", "OneCycleLR", "CosineAnnealingWarmRestarts"]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        self._sync_lr_tensor()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: set learning rate to "
                  f"{self.last_lr}.")

    def _lr_tensor(self, device) -> torch.Tensor:
        """The f32 scalar on ``device`` that mirrors ``last_lr`` (made at
        the first request, never inside a graph capture)."""
        tensors: Dict[torch.device, torch.Tensor] = \
            self.__dict__.setdefault("_lr_tensors", {})
        device = torch.device(device)
        t = tensors.get(device)
        if t is None:
            if device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "LRScheduler: the device learning rate cannot be made "
                    "inside a CUDA graph capture; run the step once "
                    "eagerly first")
            t = tensors[device] = torch.tensor(
                self.last_lr, dtype=torch.float32, device=device)
        return t

    def _sync_lr_tensor(self):
        for t in self.__dict__.get("_lr_tensors", {}).values():
            t.fill_(self.last_lr)

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list, tuple,
                                  type(None)))}

    def set_state_dict(self, state_dict):
        self.__dict__.update(state_dict)
        self._sync_lr_tensor()


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        a = step ** -0.5
        b = self.warmup_steps ** -1.5 * step
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * div
        else:
            step = min(step, decay_steps)
        return (self.base_lr - self.end_lr) * \
            (1 - step / decay_steps) ** self.power + self.end_lr


class LinearWarmup(LRScheduler):
    """``warmup_steps`` linear steps from ``start_lr`` to ``end_lr``, then
    ``learning_rate`` (a float, or a scheduler stepped from 0)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_after = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * \
                self.last_epoch / self.warmup_steps + self.start_lr
        if isinstance(self.lr_after, LRScheduler):
            self.lr_after.step(self.last_epoch - self.warmup_steps)
            return self.lr_after()
        return float(self.lr_after)

    def state_dict(self):
        sd = super().state_dict()
        sd.pop("lr_after", None)
        if isinstance(self.lr_after, LRScheduler):
            sd["@lr_after"] = self.lr_after.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        nested = state_dict.pop("@lr_after", None)
        super().set_state_dict(state_dict)
        if nested and isinstance(self.lr_after, LRScheduler):
            self.lr_after.set_state_dict(nested)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch
                                             // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def state_dict(self):
        sd = super().state_dict()
        sd.pop("lr_lambda", None)
        return sd


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        self._cur = float(learning_rate)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self._cur = self._cur * self.lr_lambda(self.last_epoch)
        return self._cur


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class ReduceOnPlateau(LRScheduler):
    """Steps on a metric: ``step(metrics)`` (a host number; reading a
    device value is the caller's sync, outside any compiled step)."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def _better(self, cur):
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            if self.mode == "min":
                return cur < self.best * (1 - self.threshold)
            return cur > self.best * (1 + self.threshold)
        if self.mode == "min":
            return cur < self.best - self.threshold
        return cur > self.best + self.threshold

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        cur = float(metrics)
        self.last_epoch += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self._better(cur):
            self.best = cur
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
                if self.verbose:
                    print(f"Epoch {self.last_epoch}: reducing lr to "
                          f"{new_lr}.")
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        self._sync_lr_tensor()


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.step_size_up = step_size_up
        self.step_size_down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self._scale_fn = scale_fn
        self.scale_mode = scale_mode
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.step_size_up + self.step_size_down
        cycle = math.floor(1 + self.last_epoch / total)
        x = self.last_epoch - (cycle - 1) * total
        if x < self.step_size_up:
            pct = x / self.step_size_up
        else:
            pct = 1 - (x - self.step_size_up) / self.step_size_down
        base_height = (self.max_lr - self.base_lr) * pct
        if self._scale_fn is not None:
            arg = cycle if self.scale_mode == "cycle" else self.last_epoch
            scale = self._scale_fn(arg)
        elif self.mode == "triangular":
            scale = 1.0
        elif self.mode == "triangular2":
            scale = 1 / (2 ** (cycle - 1))
        else:  # exp_range
            scale = self.exp_gamma ** self.last_epoch
        return self.base_lr + base_height * scale

    def state_dict(self):
        sd = super().state_dict()
        sd.pop("_scale_fn", None)
        return sd


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        self.three_phase = three_phase
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return (end - start) * pct + start

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        up_steps = float(self.phase_pct * self.total_steps) - 1
        if step <= up_steps or up_steps <= 0:
            pct = step / max(up_steps, 1)
            return self._interp(self.initial_lr, self.max_lr, min(pct, 1.0))
        down_pct = (step - up_steps) / max(self.total_steps - 1 - up_steps,
                                           1)
        return self._interp(self.max_lr, self.end_lr, min(down_pct, 1.0))


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0,
                 last_epoch=-1, verbose=False):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = self.last_epoch
        t_i = self.T_0
        while t >= t_i:
            t -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * t / t_i)) / 2
