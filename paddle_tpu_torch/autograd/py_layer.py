"""``paddle.autograd.PyLayer``: a user's forward and backward.

Port of ``paddle_tpu/autograd/py_layer.py``.  A subclass defines
``forward(ctx, *args, **kwargs)`` and ``backward(ctx, *grads)`` as static
methods and is called as ``MyLayer.apply(*args, **kwargs)``.  Underneath,
one ``torch.autograd.Function`` (``_PyLayerFunction``) runs the user's
forward under ``no_grad`` and the user's backward as its own, so the
forward's inner ops are invisible to autograd, as they are to the JAX
tape (:45-55).  What carries over from the JAX class:

- **The gradient count.** ``backward`` returns one gradient for each
  *differentiable positional tensor input* (a tensor that requires grad),
  in order; any other count raises ``ValueError`` (:112-116).  The
  Function's inputs are exactly those tensors, so torch asks for exactly
  that many; the other arguments, keyword arguments included, travel
  beside them and never receive a gradient.
- **Outputs.** An output that is an input comes back as a new tensor
  over the same storage (torch's Function makes it a view with this
  node's history), so the input's own graph stays whole (:76-87).  With
  grad mode off or no differentiable input, no node is made and every
  output is detached: an input under ``no_grad`` keeps its
  ``requires_grad``.
- **``apply``.** A subclass that defines ``apply`` is refused when it is
  defined (the metaclass, :37).
- ``ctx.save_for_backward`` / ``ctx.saved_tensor()`` (the tensors are
  saved through torch's ``save_for_backward``, so saving an output makes
  no reference cycle), ``ctx.set_materialize_grads(False)`` (an output
  that received no gradient passes ``None``), and free attributes on
  ``ctx``.

Nothing here reads a device value on the host, so a ``PyLayer`` inside a
``jit.to_static`` step is captured into the step's CUDA graph as it
stands, forward and backward.
"""
from __future__ import annotations

from typing import Any, List

import torch

from ..ops import _helpers

__all__ = ["PyLayer", "PyLayerContext", "LegacyPyLayer"]


class PyLayerContext:
    """The ``ctx`` given to ``forward`` and ``backward``."""

    def __init__(self):
        self._saved: tuple = ()
        self._materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tuple(tensors)

    def saved_tensor(self):
        return self._saved

    def set_materialize_grads(self, value: bool):
        """False: an output that received no gradient passes ``None`` to
        ``backward`` instead of zeros."""
        self._materialize_grads = bool(value)


def _as_list(outs) -> List[Any]:
    return list(outs) if isinstance(outs, (tuple, list)) else [outs]


def _requires_grad(t) -> bool:
    """Whether ``t`` needs a gradient; inside ``torch.vmap`` a batched
    tensor reports False itself, so its unbatched value is asked."""
    if not isinstance(t, torch.Tensor):
        return False
    from torch._C import _functorch

    while _functorch.is_batchedtensor(t):
        t = _functorch.get_unwrapped(t)
    return t.requires_grad


def _check_outputs(outs: list) -> None:
    for o in outs:
        if not isinstance(o, torch.Tensor):
            raise TypeError("PyLayer.forward must return Tensor(s); got "
                            f"{type(o).__name__}")


class _PyLayerFunction(torch.autograd.Function):
    """``apply(cls, pctx, args, kwargs, slots, *diff)``: ``args`` with the
    tensors ``diff`` at positions ``slots``.  Its forward takes no
    ``ctx`` (``setup_context`` saves), so ``torch.vmap`` runs it, the
    user's forward and backward batched (``generate_vmap_rule``): a
    ``PyLayer`` inside a batched computation, such as an MoE layer's
    experts, works."""

    generate_vmap_rule = True

    @staticmethod
    def forward(cls, pctx, args, kwargs, slots, *diff):
        args = list(args)
        for i, t in zip(slots, diff):
            args[i] = t
        outs = cls.forward(pctx, *args, **kwargs)
        pctx._single = not isinstance(outs, (tuple, list))
        outs = _as_list(outs)
        _check_outputs(outs)
        return tuple(outs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        cls, pctx, diff = inputs[0], inputs[1], inputs[5:]
        ctx.cls, ctx.pctx, ctx.n_diff = cls, pctx, len(diff)
        saved = pctx._saved
        ctx.layout = [isinstance(s, torch.Tensor) for s in saved]
        ctx.others = [s for s in saved if not isinstance(s, torch.Tensor)]
        ctx.save_for_backward(*[s for s in saved
                                if isinstance(s, torch.Tensor)])
        pctx._saved = ()
        ctx.set_materialize_grads(pctx._materialize_grads)

    @staticmethod
    def backward(ctx, *grads):
        pctx = ctx.pctx
        tensors, others = iter(ctx.saved_tensors), iter(ctx.others)
        pctx._saved = tuple(next(tensors) if is_t else next(others)
                            for is_t in ctx.layout)
        out = ctx.cls.backward(pctx, *grads)
        out = tuple(_as_list(out))
        if len(out) != ctx.n_diff:
            raise ValueError(
                f"{ctx.cls.__name__}.backward returned {len(out)} "
                f"gradients for {ctx.n_diff} differentiable inputs")
        return (None,) * 5 + out


class PyLayerMeta(type):
    def __init__(cls, name, bases, attrs):
        super().__init__(name, bases, attrs)
        if any(isinstance(b, PyLayerMeta) for b in bases) \
                and "apply" in attrs:
            raise RuntimeError(
                "do not override PyLayer.apply; define forward/backward")


class PyLayer(metaclass=PyLayerMeta):
    """Subclass with ``@staticmethod forward(ctx, *args)`` and
    ``backward(ctx, *grads)``; call ``MyLayer.apply(*args)``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError("PyLayer subclasses must implement "
                                  "forward")

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError("PyLayer subclasses must implement "
                                  "backward")

    @classmethod
    def apply(cls, *args, **kwargs):
        """Run the layer: its ``forward``, with its ``backward`` as the
        gradient; a recording static program takes the call as one op."""
        return _helpers.one_op(cls.__name__, cls.apply, cls._apply, args,
                               kwargs)

    @classmethod
    def _apply(cls, *args, **kwargs):
        pctx = PyLayerContext()
        slots = [i for i, a in enumerate(args) if _requires_grad(a)]
        if not (torch.is_grad_enabled() and slots):
            with torch.no_grad():
                outs = cls.forward(pctx, *args, **kwargs)
            single = not isinstance(outs, (tuple, list))
            outs = _as_list(outs)
            _check_outputs(outs)
            outs = [o.detach() for o in outs]
            return outs[0] if single else tuple(outs)
        diff = [args[i] for i in slots]
        template = [None if i in slots else a for i, a in enumerate(args)]
        outs = _PyLayerFunction.apply(cls, pctx, template, kwargs, slots,
                                      *diff)
        return outs[0] if pctx._single else outs


#: the reference's second name for the same class
LegacyPyLayer = PyLayer
