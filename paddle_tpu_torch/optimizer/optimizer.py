"""Optimizers with Paddle's semantics, f32 masters.

Port of ``paddle_tpu/optimizer/optimizer.py``: the ``Optimizer`` base
(:23-375) with its master weights (:263-288) and parameter groups
(:27-60), and all ten classes: ``SGD`` (:379), ``Momentum`` (:391),
``Adam`` and ``AdamW`` (:415-485), ``Adamax`` (:488), ``Adagrad`` (:511),
``RMSProp`` (:532), ``Adadelta`` (:559), ``Lars`` (:580, alias
``LarsMomentumOptimizer``) and ``Lamb`` (:632), as
``torch.optim.Optimizer`` subclasses.  What the base adds:

- ``lr`` is a float or an :class:`~.lr.LRScheduler`.  Under a scheduler
  every update reads the rate from the scheduler's f32 scalar on the
  parameter's device (``LRScheduler._lr_tensor``), never as a Python
  float, so a step captured as a CUDA graph follows the schedule.  A float
  rate is a constant of such a program, as it is of the JAX program;
  ``set_lr`` refuses under a scheduler, and once a step of this optimizer
  was captured (the program would keep the old constant).
- ``grad_clip`` (:mod:`..nn.clip`) maps the ``(parameter, gradient)``
  pairs before the update (``optimizer.py:200-201``).
- ``get_lr``, ``clear_grad`` (``clear_gradients``), ``minimize`` and a
  ``state_dict`` that carries the scheduler's under ``"@lr_scheduler"``
  (:312, :357); loading one keeps each state tensor's own dtype (an f32
  master of a bf16 parameter stays f32) and writes in place where the
  tensor exists, so a captured step reads the restored values.  A state
  dict in the JAX package's key format (``"{param}/{accumulator}"``,
  :306-330) loads too, its parameters paired with these by position.
- parameter groups as Paddle defines them: ``params`` may be a list of
  dicts, each with a ``"params"`` list; a group's ``learning_rate``
  multiplies the global rate (in f32), and ``weight_decay``, ``beta1``,
  ``beta2``, ``epsilon`` and ``momentum`` override the optimizer's for
  that group.  A dict without ``"params"`` raises, and so does a
  parameter in two groups.
- ``weight_decay`` may be a :mod:`..regularizer` ``L1Decay`` or
  ``L2Decay`` (``paddle_tpu/optimizer/optimizer.py:68-77``): the coupled
  decay folds its ``_grad_term`` into the gradient, a decoupled one
  (AdamW, Lars, Lamb) takes its coefficient.  A parameter's own
  ``regularizer`` (``nn.ParamAttr(regularizer=)``) is not read, as the
  JAX optimizer reads none (``_decayed_grad``, ``:293-301``).
- a loss scaler's overflow gate: while :class:`..amp.GradScaler` runs a
  step, every write of a parameter, master or accumulator goes through
  ``torch.where(found_inf, old, new)`` (:meth:`Optimizer._write`), so an
  overflowing step leaves the state exactly as it was, an accumulator
  born in it at its initial value, with no host read.
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

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "RMSProp", "Adadelta", "Lars", "LarsMomentumOptimizer",
           "Lamb"]

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
    ``apply_decay_param_fun`` and Lars's ``exclude_from_weight_decay``
    are given), or a list of group dicts (see the module), or None in
    static mode (``minimize`` then takes the program's parameters);
    ``defaults`` go to every group."""

    def __init__(self, params, lr: LearningRate, defaults: dict,
                 grad_clip=None):
        self._names = {}
        if params is None:
            # a static program's optimizer: minimize() gives it the
            # program's parameters
            from ..static import program

            if not program.in_static_mode():
                raise ValueError(
                    f"{type(self).__name__}: parameters are required "
                    f"outside static mode (paddle.enable_static())")
            params = [{"params": []}]
        params = list(params)
        if params and isinstance(params[0], dict):
            groups = []
            for group in params:
                if "params" not in group:
                    raise ValueError(
                        "each optimizer parameter group dict needs a "
                        f"'params' key; got keys {sorted(group)}")
                g = dict(group)
                ps = g["params"]
                g["params"] = self._unname(
                    [ps] if isinstance(ps, torch.Tensor) else list(ps))
                groups.append(g)
            params = groups
        else:
            params = self._unname(params)
        super().__init__(params, {"learning_rate": 1.0, **defaults})
        for group in self.param_groups:
            self._init_group(group)
        self._learning_rate = lr
        self._grad_clip = grad_clip
        self._captured = False
        self._found_inf: Optional[torch.Tensor] = None

    @staticmethod
    def _init_group(group: dict) -> None:
        # an L1Decay/L2Decay: its coefficient for the decoupled decays, its
        # gradient term for the coupled one (_decayed)
        wd = group.get("weight_decay")
        group["regularizer"] = wd if hasattr(wd, "_grad_term") else None
        if group["regularizer"] is not None:
            group["weight_decay"] = wd.coeff

    def _unname(self, params: list) -> list:
        """Tensors of ``params``, recording the names of ``(name, tensor)``
        pairs."""
        if params and isinstance(params[0], tuple):
            self._names.update({id(p): n for n, p in params})
            return [p for _, p in params]
        return params

    def _name(self, p: torch.Tensor) -> str:
        return self._names.get(id(p), "")

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

    def _lr(self, p: torch.Tensor, group: dict):
        """The rate of ``p``'s update: the scheduler's device scalar, or
        the float, times the group's ``learning_rate`` factor in f32."""
        factor = group["learning_rate"]
        if isinstance(self._learning_rate, LRScheduler):
            lr = self._learning_rate._lr_tensor(p.device)
            return lr if factor == 1.0 else lr * np.float32(factor)
        lr = np.float32(self._learning_rate)
        return float(lr if factor == 1.0 else lr * np.float32(factor))

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

    def _write(self, t: torch.Tensor, new) -> None:
        """``t <- new`` in place; while a loss scaler found an overflow in
        this step (``_found_inf``, a device bool), ``t`` keeps its value."""
        if self._found_inf is not None:
            new = torch.where(self._found_inf, t, new)
        t.copy_(new)

    def _apply(self, p: torch.Tensor, st: dict, new32: torch.Tensor) -> None:
        """The parameter's new f32 value: into its master, if it has one,
        and rounded into the parameter."""
        master = st.get("master_weight")
        if master is not None:
            self._write(master, new32)
        self._write(p, new32)

    def _decayed(self, p: torch.Tensor, g32: torch.Tensor,
                 group: dict) -> torch.Tensor:
        """The gradient with the coupled decay folded in (``_decayed_grad``,
        the SGD/Momentum/Adam family's): the group's ``L1Decay`` or
        ``L2Decay`` (``_grad_term``), else its float ``weight_decay`` as
        L2."""
        reg = group.get("regularizer")
        if reg is not None:
            return g32 + reg._grad_term(p.float())
        if group["weight_decay"]:
            return g32 + group["weight_decay"] * p.float()
        return g32

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

    clear_gradients = clear_grad

    def minimize(self, loss: torch.Tensor, startup_program=None,
                 parameters=None, no_grad_set=None):
        """Dygraph: ``loss.backward()`` then :meth:`step`; the gradients
        stay until :meth:`clear_grad`, and ``parameters`` is ignored (this
        optimizer was built with its own, as the JAX one keeps a list it
        already has).  While a static program records
        (``paddle_tpu/optimizer/optimizer.py:211-240``): the program becomes
        a train program, each ``Executor.run`` of it one step of this
        optimizer over ``parameters``, else those it was built with, else
        the program's trainable parameters; no step runs now (the
        placeholders hold no data).  Returns ``(None, None)``."""
        from ..static import program as static_program

        prog = static_program._recording()
        if prog is not None:
            self._minimize_program(prog, loss, parameters)
            return None, None
        if no_grad_set is not None:
            raise NotImplementedError(
                "minimize: no_grad_set belongs to the static-graph API")
        loss.backward()
        self.step()
        return None, None

    def _minimize_program(self, prog, loss, parameters) -> None:
        if parameters is not None:
            params = list(parameters)
        elif any(g["params"] for g in self.param_groups):
            params = None
        else:
            params = [t for t in prog._leaves
                      if isinstance(t, torch.nn.Parameter)
                      and t.requires_grad]
            if not params:
                raise ValueError(
                    "minimize() found no trainable parameter in the "
                    "recording program (built without static.nn/"
                    "create_parameter layers?); pass parameters= "
                    "explicitly")
        if params is not None:
            self.param_groups = []
            self.state.clear()
            self.add_param_group({"params": params})
            self._init_group(self.param_groups[0])
        prog._train_spec = (loss, self)
        prog._train_cache.clear()   # a second minimize replaces the spec

    # -- state dict ------------------------------------------------------------

    def state_dict(self) -> dict:
        sd = super().state_dict()
        if isinstance(self._learning_rate, LRScheduler):
            sd["@lr_scheduler"] = self._learning_rate.state_dict()
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a state dict of this optimizer, or one in the JAX package's
        key format (``"{param}/{accumulator}"``, ``"@global_step"``,
        ``"@lr_scheduler"``).  Existing state tensors are written in
        place, so a captured step reads the loaded values."""
        state_dict = dict(state_dict)
        if "state" not in state_dict:
            self._load_jax_state(state_dict)
            return
        sched = state_dict.pop("@lr_scheduler", None)
        groups, saved_groups = self.param_groups, state_dict["param_groups"]
        if len(groups) != len(saved_groups) or any(
                len(g["params"]) != len(sg["params"])
                for g, sg in zip(groups, saved_groups)):
            raise ValueError("loaded state dict's parameter groups do not "
                             "match this optimizer's")
        for g, sg in zip(groups, saved_groups):
            g.update({k: v for k, v in sg.items() if k != "params"})
        # a state dict read back from a checkpoint has its integer keys
        # as strings.  torch's own load would cast every float state
        # tensor to its parameter's dtype on a new copy; the port's keep
        # their own dtype (f32 masters and moments of bf16 parameters) and
        # are written in place
        params = [p for g in groups for p in g["params"]]
        saved = {int(i): st for i, st in state_dict["state"].items()}
        for i, p in enumerate(params):
            live = self.state[p]
            if i not in saved:
                if live:
                    # saved before this parameter's first step: its state
                    # goes back to what that step makes, in place
                    self._reset_state(p, live)
                continue
            for key, v in saved[i].items():
                live[key] = self._put(live.get(key), v, p) \
                    if isinstance(v, torch.Tensor) else v
        if sched is not None and isinstance(self._learning_rate,
                                            LRScheduler):
            self._learning_rate.set_state_dict(sched)

    @torch.no_grad()
    def _reset_state(self, p: torch.Tensor, live: dict) -> None:
        """``p``'s state as its first step makes it (the master from the
        parameter's current value), written into the live tensors."""
        fresh = dict(self._make_state(p))
        if "master_weight" in live:
            fresh["master_weight"] = p.detach().float()
        for key, v in fresh.items():
            if key in live:
                live[key].copy_(v)

    @staticmethod
    def _put(old: Optional[torch.Tensor], v, p: torch.Tensor
             ) -> torch.Tensor:
        """``v`` into ``old`` in place when it fits, else a new tensor on
        ``p``'s device (in ``v``'s dtype)."""
        v = torch.as_tensor(v)
        if old is not None and old.shape == v.shape \
                and old.dtype == v.dtype:
            old.copy_(v)
            return old
        return v.to(p.device, copy=True)

    def _load_jax_state(self, sd: dict) -> None:
        """The JAX package's optimizer state: accumulators keyed
        ``"{param}/{name}"`` (its ``param_<n>``/layer names, paired with
        this optimizer's parameters by position, as the JAX package
        pairs renamed parameters), ``"@global_step"`` and
        ``"@lr_scheduler"``.  The pairing needs one saved parameter for
        each of this optimizer's: a JAX run makes a parameter's
        accumulators at its first step, so a state that leaves one out
        (frozen, or never given a gradient) cannot be paired and is
        refused.  A parameter's JAX accumulator shape must equal its own
        (a JAX linear weight is the transpose of the port's: load its
        moments through the model's conversion)."""
        params = [p for g in self.param_groups for p in g["params"]]
        keys: list = []
        for k in sd:
            if not k.startswith("@"):
                pk = k.rsplit("/", 1)[0]
                if pk not in keys:
                    keys.append(pk)
        if keys and len(keys) != len(params):
            raise ValueError(
                f"optimizer state names {len(keys)} parameters, this "
                f"optimizer has {len(params)}: the JAX state is paired by "
                f"position, which needs the same number")
        by_key = dict(zip(keys, params))
        for k, v in sd.items():
            if k == "@global_step":
                # the port counts no global step: its updates read the
                # per-parameter beta powers, which load below
                continue
            if k == "@lr_scheduler":
                if isinstance(self._learning_rate, LRScheduler):
                    self._learning_rate.set_state_dict(v)
                continue
            pk, name = k.rsplit("/", 1)
            p = by_key[pk]
            v = torch.as_tensor(np.asarray(v)) \
                if not isinstance(v, torch.Tensor) else v
            if v.dim() and tuple(v.shape) != tuple(p.shape):
                raise ValueError(
                    f"optimizer state {k!r} (shape {tuple(v.shape)}) does "
                    f"not fit parameter {params.index(p)} (shape "
                    f"{tuple(p.shape)}); the saved state appears to be for "
                    f"a different model")
            st = self.state[p]
            st[name] = self._put(st.get(name), v, p)

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
        g32 = self._decayed(p, g32, group)
        self._apply(p, st, self._param32(p, st) - self._lr(p, group) * g32)


class Momentum(Optimizer):
    """``Momentum(params, lr=1e-3, momentum=0.9, use_nesterov=False,
    weight_decay=None, grad_clip=None)``: ``v = momentum * v + g`` (g with
    the L2 decay), ``p -= lr * v`` (Nesterov: ``lr * (g + momentum *
    v)``); the velocity is f32."""

    def __init__(self, params, lr: LearningRate = 1e-3,
                 momentum: float = 0.9, use_nesterov: bool = False,
                 weight_decay: Optional[float] = None, grad_clip=None):
        super().__init__(params, lr, dict(momentum=momentum,
                                          weight_decay=weight_decay or 0.0),
                         grad_clip)
        self.use_nesterov = use_nesterov

    _ACCUMULATORS = ("velocity",)

    def _make_state(self, p):
        return {"velocity": torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)}

    def _update(self, p, g32, group):
        st = self._state(p)
        g32 = self._decayed(p, g32, group)
        mu = group["momentum"]
        v = mu * st["velocity"] + g32
        self._write(st["velocity"], v)
        upd = g32 + mu * v if self.use_nesterov else v
        self._apply(p, st, self._param32(p, st) - self._lr(p, group) * upd)


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
        self._adam(p, self._decayed(p, g32, group), group, 0.0)

    def _adam(self, p, g32, group, decoupled_wd: float) -> None:
        st = self._state(p)
        lr, b1, b2 = self._lr(p, group), group["beta1"], group["beta2"]
        m = st["moment1"].float() * b1 + (1 - b1) * g32
        v = st["moment2"].float() * b2 + (1 - b2) * g32.square()
        b1p, b2p = st["beta1_pow"] * b1, st["beta2_pow"] * b2
        self._write(st["beta1_pow"], b1p)
        self._write(st["beta2_pow"], b2p)
        self._write(st["moment1"], m)
        self._write(st["moment2"], v)
        m_hat = m / (1.0 - b1p)
        v_hat = v / (1.0 - b2p)
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


def _f32_zeros(p: torch.Tensor, init: float = 0.0) -> torch.Tensor:
    return torch.full(p.shape, init, dtype=torch.float32, device=p.device)


def _f32_one(p: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32, device=p.device)


class Adamax(Optimizer):
    """``Adamax(params, lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
    weight_decay=None, grad_clip=None)``: ``u = max(beta2 * u, |g|)``,
    ``p -= lr / (1 - beta1_pow) * m / (u + epsilon)``."""

    def __init__(self, params, lr: LearningRate = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: Optional[float] = None, grad_clip=None):
        super().__init__(params, lr, dict(beta1=beta1, beta2=beta2,
                                          epsilon=epsilon,
                                          weight_decay=weight_decay or 0.0),
                         grad_clip)

    _ACCUMULATORS = ("moment", "inf_norm", "beta1_pow")

    def _make_state(self, p):
        return {"moment": _f32_zeros(p), "inf_norm": _f32_zeros(p),
                "beta1_pow": _f32_one(p)}

    def _update(self, p, g32, group):
        st = self._state(p)
        g32 = self._decayed(p, g32, group)
        b1, b2 = group["beta1"], group["beta2"]
        m = b1 * st["moment"] + (1 - b1) * g32
        u = torch.maximum(b2 * st["inf_norm"], g32.abs())
        b1p = st["beta1_pow"] * b1
        self._write(st["moment"], m)
        self._write(st["inf_norm"], u)
        self._write(st["beta1_pow"], b1p)
        self._apply(p, st, self._param32(p, st) - self._lr(p, group)
                    / (1 - b1p) * m / (u + group["epsilon"]))


class Adagrad(Optimizer):
    """``Adagrad(params, lr, epsilon=1e-6, weight_decay=None,
    grad_clip=None, initial_accumulator_value=0.0)``: ``acc += g^2``,
    ``p -= lr * g / (sqrt(acc) + epsilon)``."""

    def __init__(self, params, lr: LearningRate, epsilon: float = 1e-6,
                 weight_decay: Optional[float] = None, grad_clip=None,
                 initial_accumulator_value: float = 0.0):
        super().__init__(params, lr, dict(epsilon=epsilon,
                                          weight_decay=weight_decay or 0.0),
                         grad_clip)
        self.initial_accumulator_value = float(initial_accumulator_value)

    _ACCUMULATORS = ("moment",)

    def _make_state(self, p):
        return {"moment": _f32_zeros(p, self.initial_accumulator_value)}

    def _update(self, p, g32, group):
        st = self._state(p)
        g32 = self._decayed(p, g32, group)
        acc = st["moment"] + g32.square()
        self._write(st["moment"], acc)
        self._apply(p, st, self._param32(p, st) - self._lr(p, group) * g32
                    / (acc.sqrt() + group["epsilon"]))


class RMSProp(Optimizer):
    """``RMSProp(params, lr, rho=0.95, epsilon=1e-6, momentum=0.0,
    centered=False, weight_decay=None, grad_clip=None)``: ``ms = rho * ms
    + (1 - rho) g^2`` (centered: minus the square of the running mean
    gradient), ``mom = momentum * mom + lr * g / sqrt(ms + epsilon)``,
    ``p -= mom``."""

    def __init__(self, params, lr: LearningRate, rho: float = 0.95,
                 epsilon: float = 1e-6, momentum: float = 0.0,
                 centered: bool = False,
                 weight_decay: Optional[float] = None, grad_clip=None):
        super().__init__(params, lr, dict(epsilon=epsilon, momentum=momentum,
                                          weight_decay=weight_decay or 0.0),
                         grad_clip)
        self.rho, self.centered = rho, centered

    _ACCUMULATORS = ("mean_square", "momentum")

    def _make_state(self, p):
        st = {"mean_square": _f32_zeros(p), "momentum": _f32_zeros(p)}
        if self.centered:
            st["mean_grad"] = _f32_zeros(p)
        return st

    def _update(self, p, g32, group):
        st = self._state(p)
        g32 = self._decayed(p, g32, group)
        rho = self.rho
        ms = rho * st["mean_square"] + (1 - rho) * g32.square()
        self._write(st["mean_square"], ms)
        denom = ms
        if self.centered:
            mg = rho * st["mean_grad"] + (1 - rho) * g32
            self._write(st["mean_grad"], mg)
            denom = ms - mg.square()
        upd = group["momentum"] * st["momentum"] + self._lr(p, group) * g32 \
            / (denom + group["epsilon"]).sqrt()
        self._write(st["momentum"], upd)
        self._apply(p, st, self._param32(p, st) - upd)


class Adadelta(Optimizer):
    """``Adadelta(params, lr=1e-3, epsilon=1e-6, rho=0.95,
    weight_decay=None, grad_clip=None)``: ``upd = -sqrt((E[dx^2] + eps) /
    (E[g^2] + eps)) * g``, ``p += lr * upd``."""

    def __init__(self, params, lr: LearningRate = 1e-3,
                 epsilon: float = 1e-6, rho: float = 0.95,
                 weight_decay: Optional[float] = None, grad_clip=None):
        super().__init__(params, lr, dict(epsilon=epsilon,
                                          weight_decay=weight_decay or 0.0),
                         grad_clip)
        self.rho = rho

    _ACCUMULATORS = ("avg_squared_grad", "avg_squared_update")

    def _make_state(self, p):
        return {"avg_squared_grad": _f32_zeros(p),
                "avg_squared_update": _f32_zeros(p)}

    def _update(self, p, g32, group):
        st = self._state(p)
        g32 = self._decayed(p, g32, group)
        rho, eps = self.rho, group["epsilon"]
        asg = rho * st["avg_squared_grad"] + (1 - rho) * g32.square()
        upd = -((st["avg_squared_update"] + eps) / (asg + eps)).sqrt() * g32
        asu = rho * st["avg_squared_update"] + (1 - rho) * upd.square()
        self._write(st["avg_squared_grad"], asg)
        self._write(st["avg_squared_update"], asu)
        self._apply(p, st, self._param32(p, st) + self._lr(p, group) * upd)


class Lars(Optimizer):
    """LARS momentum (reference: fluid/optimizer.py:1969
    LarsMomentumOptimizer; kernel lars_momentum_op.h):

        local_lr = lr * lars_coeff * ||p|| / (eps + ||g|| + wd * ||p||)
        velocity = mu * velocity + local_lr * (g + wd * p)
        p       -= velocity

    with the plain ``lr`` where either norm is 0.  ``Lars(params, lr,
    momentum, lars_coeff=0.001, lars_weight_decay=0.0005,
    grad_clip=None, exclude_from_weight_decay=None, epsilon=0,
    multi_precision=False, rescale_grad=1.0)``; a parameter whose name
    (from ``(name, tensor)`` pairs) contains a string of
    ``exclude_from_weight_decay`` has no decay.  A group's
    ``weight_decay`` overrides ``lars_weight_decay``, its ``epsilon`` and
    ``momentum`` the optimizer's."""

    def __init__(self, params, lr: LearningRate, momentum: float,
                 lars_coeff: float = 0.001,
                 lars_weight_decay: float = 0.0005, grad_clip=None,
                 exclude_from_weight_decay: Optional[Sequence[str]] = None,
                 epsilon: float = 0, multi_precision: bool = False,
                 rescale_grad: float = 1.0):
        super().__init__(params, lr,
                         dict(momentum=float(momentum),
                              weight_decay=float(lars_weight_decay),
                              epsilon=float(epsilon)),
                         grad_clip)
        self.lars_coeff = float(lars_coeff)
        self.exclude = list(exclude_from_weight_decay or [])
        self.rescale_grad = float(rescale_grad)

    _ACCUMULATORS = ("velocity",)

    def _make_state(self, p):
        return {"velocity": _f32_zeros(p)}

    def _update(self, p, g32, group):
        st = self._state(p)
        lr = self._lr(p, group)
        g32 = g32 * self.rescale_grad
        p32 = self._param32(p, st)
        wd = group["weight_decay"]
        if any(tok in self._name(p) for tok in self.exclude):
            wd = 0.0
        p_norm = p32.square().sum().sqrt()
        g_norm = g32.square().sum().sqrt()
        # reference kernel guard: the plain lr when either norm is zero
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            lr * self.lars_coeff * p_norm
            / (group["epsilon"] + g_norm + wd * p_norm),
            lr)
        v = group["momentum"] * st["velocity"] + local_lr * (g32 + wd * p32)
        self._write(st["velocity"], v)
        self._apply(p, st, p32 - v)


# reference class name (fluid/optimizer.py:1969)
LarsMomentumOptimizer = Lars


class Lamb(Optimizer):
    """Layer-wise adaptive moments (reference: optimizer/lamb.py):
    ``r = m_hat / (sqrt(v_hat) + epsilon) + wd * p``, ``p -= lr * trust *
    r`` with ``trust = ||p|| / ||r||`` (1 where either is 0).
    ``Lamb(params, lr=1e-3, lamb_weight_decay=0.01, beta1=0.9,
    beta2=0.999, epsilon=1e-6, grad_clip=None,
    exclude_from_weight_decay_fn=None)``; the function is given the
    parameter.  A group's ``weight_decay`` overrides
    ``lamb_weight_decay``."""

    def __init__(self, params, lr: LearningRate = 1e-3,
                 lamb_weight_decay: float = 0.01, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-6,
                 grad_clip=None,
                 exclude_from_weight_decay_fn: Optional[
                     Callable[[torch.Tensor], bool]] = None):
        super().__init__(params, lr, dict(beta1=beta1, beta2=beta2,
                                          epsilon=epsilon,
                                          weight_decay=lamb_weight_decay),
                         grad_clip)
        self.exclude_fn = exclude_from_weight_decay_fn

    _ACCUMULATORS = ("moment1", "moment2", "beta1_pow", "beta2_pow")

    def _make_state(self, p):
        return {"moment1": _f32_zeros(p), "moment2": _f32_zeros(p),
                "beta1_pow": _f32_one(p), "beta2_pow": _f32_one(p)}

    def _update(self, p, g32, group):
        st = self._state(p)
        lr, b1, b2 = self._lr(p, group), group["beta1"], group["beta2"]
        m = b1 * st["moment1"] + (1 - b1) * g32
        v = b2 * st["moment2"] + (1 - b2) * g32.square()
        b1p, b2p = st["beta1_pow"] * b1, st["beta2_pow"] * b2
        self._write(st["moment1"], m)
        self._write(st["moment2"], v)
        self._write(st["beta1_pow"], b1p)
        self._write(st["beta2_pow"], b2p)
        m_hat = m / (1 - b1p)
        v_hat = v / (1 - b2p)
        p32 = self._param32(p, st)
        wd = group["weight_decay"]
        if self.exclude_fn is not None and self.exclude_fn(p):
            wd = 0.0
        r = m_hat / (v_hat.sqrt() + group["epsilon"]) + wd * p32
        w_norm = p32.square().sum().sqrt()
        r_norm = r.square().sum().sqrt()
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        self._apply(p, st, p32 - lr * trust * r)
