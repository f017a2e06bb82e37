"""``paddle.incubate``'s optimizers: ``LookAhead`` and ``ModelAverage``.

Port of ``paddle_tpu/incubate/optimizer.py``.  Both keep their state in
tensors on the parameters' device and express their every-k-step and
window conditions as device values of a step counter, as the JAX ones
use ``jnp.where`` (:61-87): ``ModelAverage`` as ``torch.where``,
``LookAhead`` as ``lerp`` by a weight that is 0 off the sync steps (the
tensor kept bitwise) and ``alpha`` or 1 at them.  A ``step()`` inside a
``jit.to_static`` step is captured into the step's CUDA graph, and each
replay syncs or discards exactly when the counter says, with no host
read.  Their state
(the counters, the slow weights, the sums) is made at the first step,
which must run before a capture, as the port's optimizers' own state
(:mod:`..optimizer.optimizer`).

``LookAhead(inner, alpha, k)``: the inner optimizer updates the fast
weights at every step; at steps k, 2k, ... the f32 slow weights move
``alpha`` of the way to the fast ones and the fast ones are set to them.
The slow weights start from the parameters after the first inner update
(the reference's contract, ``lookahead.py:228``).  The fast weights are
read and written through the inner optimizer's f32 master where it keeps
one (AMP O2), so the master and the parameter stay one value.

``ModelAverage(rate, parameters, min_average_window,
max_average_window)``: the three-sum running average of the reference's
``average_accumulates`` kernel (window ``min(max_window, updates *
rate)``, at least ``min_window``; a precision fold every 16384 updates).
``apply()`` writes the average into the parameters in place and
``restore()`` writes the training values back; ``with ma.apply():``
restores on exit.
"""
from __future__ import annotations

import torch

from ..optimizer.optimizer import Optimizer, _capturing

__all__ = ["LookAhead", "ModelAverage"]


def _params(opt: Optimizer) -> list:
    return [p for g in opt.param_groups for p in g["params"]
            if p.requires_grad]


def _made_outside_capture(p: torch.Tensor, what: str) -> None:
    if _capturing(p):
        raise RuntimeError(
            f"{what}: its state would be made inside a CUDA graph capture "
            "(and zeroed at every replay); run the step once eagerly "
            "before capturing it")


class LookAhead(Optimizer):
    r"""Lookahead (Zhang et al. 2019, arXiv:1907.08610) around an inner
    optimizer (module docstring)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if not isinstance(inner_optimizer, Optimizer):
            raise TypeError("inner optimizer should be an Optimizer, but "
                            f"got {type(inner_optimizer)}")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha should be in [0, 1], but got {alpha}")
        if not (isinstance(k, int) and k > 0):
            raise ValueError(f"k should be a positive integer, but got {k}")
        super().__init__([p for g in inner_optimizer.param_groups
                          for p in g["params"]], alpha, {})
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = k
        self._k_step = None

    @torch.no_grad()
    def step(self, closure=None):
        loss = self.inner_optimizer.step(closure)
        params = _params(self)
        if not params:
            return loss
        inner = self.inner_optimizer
        if self._k_step is None:
            _made_outside_capture(params[0], "LookAhead")
            self._k_step = torch.zeros((), dtype=torch.int64,
                                       device=params[0].device)
        self._k_step.add_(1)
        # 1 at a sync step, else 0: lerp by 0 keeps a tensor bitwise, lerp
        # by 1 gives its end bitwise
        sync = (torch.remainder(self._k_step, self.k) == 0).float()
        toward_fast = sync * self.alpha
        for p in params:
            st = self.state[p]
            if "slow" not in st:
                _made_outside_capture(p, "LookAhead")
                st["slow"] = p.detach().float().clone()
            slow = st["slow"]
            ist = inner.state[p]
            fast = inner._param32(p, ist)
            slow.lerp_(fast, toward_fast)
            inner._apply(p, ist, fast.lerp(slow, sync))
        return loss

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero: bool = False) -> None:
        self.inner_optimizer.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def get_lr(self) -> float:
        return self.inner_optimizer.get_lr()

    def state_dict(self) -> dict:
        sd = super().state_dict()
        sd["@k_step"] = self._k_step
        sd["inner"] = self.inner_optimizer.state_dict()
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        inner = state_dict.pop("inner")
        k_step = state_dict.pop("@k_step", None)
        self.inner_optimizer.load_state_dict(inner)
        super().load_state_dict(state_dict)
        if k_step is not None:
            self._k_step = self._put(self._k_step, k_step,
                                     _params(self)[0])

    set_state_dict = load_state_dict


class ModelAverage(Optimizer):
    """The running average of the parameters over a trailing window
    (module docstring)."""

    _MAX_NUM_ACCUMULATES = 16384

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        super().__init__(list(parameters or []), 0.0, {})
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self._counters = None
        self._restore_vals = {}
        self._need_restore = True

    def _counter_state(self, device) -> dict:
        if self._counters is None:
            zero = dict(dtype=torch.int64, device=device)
            self._counters = {n: torch.zeros((), **zero) for n in (
                "num_updates", "num_accumulates", "old_num_accumulates")}
        return self._counters

    @torch.no_grad()
    def step(self, closure=None):
        params = _params(self)
        if not params:
            return None
        if self._counters is None:
            _made_outside_capture(params[0], "ModelAverage")
        c = self._counter_state(params[0].device)
        num_updates = c["num_updates"] + 1
        num_accumulates = c["num_accumulates"] + 1
        rollover = torch.remainder(num_updates,
                                   self._MAX_NUM_ACCUMULATES) == 0
        window = torch.clamp(num_updates.float() * self.average_window,
                             max=float(self.max_average_window))
        discard = (num_accumulates >= self.min_average_window) \
            & (num_accumulates.float() >= window)
        for p in params:
            st = self.state[p]
            if "sum_1" not in st:
                _made_outside_capture(p, "ModelAverage")
                for n in ("sum_1", "sum_2", "sum_3"):
                    st[n] = torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
            s1, s2, s3 = st["sum_1"], st["sum_2"], st["sum_3"]
            v1 = s1 + p.float()
            v2 = torch.where(rollover, s2 + v1, s2)
            v1 = torch.where(rollover, torch.zeros_like(v1), v1)
            s3.copy_(torch.where(discard, v1 + v2, s3))
            s1.copy_(torch.where(discard, torch.zeros_like(v1), v1))
            s2.copy_(torch.where(discard, torch.zeros_like(v2), v2))
        c["old_num_accumulates"].copy_(torch.where(
            discard, num_accumulates, c["old_num_accumulates"]))
        c["num_accumulates"].copy_(torch.where(
            discard, torch.zeros_like(num_accumulates), num_accumulates))
        c["num_updates"].copy_(num_updates)
        return None

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        self.step()
        return None, None

    def _average(self, p: torch.Tensor) -> torch.Tensor:
        st, c = self.state[p], self._counters
        total = c["num_accumulates"] + c["old_num_accumulates"]
        return (st["sum_1"] + st["sum_2"] + st["sum_3"]) \
            / torch.clamp(total, min=1).float()

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        """Write the averages into the parameters, in place."""
        for p in _params(self):
            if "sum_1" not in self.state[p]:
                continue
            self._restore_vals[p] = p.detach().clone()
            p.copy_(self._average(p))
        self._need_restore = need_restore
        return _ApplyContext(self)

    @torch.no_grad()
    def restore(self, executor=None):
        """Undo :meth:`apply`: the training values back, in place."""
        for p, v in self._restore_vals.items():
            p.copy_(v)
        self._restore_vals = {}

    def state_dict(self) -> dict:
        sd = super().state_dict()
        sd["@counters"] = self._counters
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        counters = state_dict.pop("@counters", None)
        super().load_state_dict(state_dict)
        if counters is not None:
            mine = self._counter_state(_params(self)[0].device)
            for n, v in counters.items():
                mine[n].copy_(torch.as_tensor(v))

    set_state_dict = load_state_dict


class _ApplyContext:
    """``with model_average.apply(): ...`` restores on exit when asked."""

    def __init__(self, ma: ModelAverage):
        self._ma = ma

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._ma._need_restore:
            self._ma.restore()
        return False
