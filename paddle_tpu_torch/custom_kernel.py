"""Custom ops and custom kernels: the out-of-tree extension point.

Port of ``paddle_tpu/core/custom_kernel.py`` (reference:
``paddle/phi/core/custom_kernel.h:49`` and
``python/paddle/utils/cpp_extension``).  Two forms:

- :func:`register_op` makes a NEW op from a function of tensors: a
  ``torch.library.custom_op`` (namespace ``paddle_tpu_ext``), so that a
  static program records it as one op and ``torch.export`` keeps it.  Its
  gradient is ``vjp(inputs, grads)`` when one is given
  (``register_autograd``), else the VJP of ``fn`` itself, recomputed in
  the backward.
- :func:`register_kernel` replaces the kernel of an EXISTING op of the
  ``paddle.*`` or ``nn.functional`` surface, for one backend or for all:
  every public op function looks the table up once per call
  (``ops._helpers.public_op``), eagerly, while a static program records
  and inside a capture.  The backend is that of the call's first tensor
  (``"gpu"`` for a CUDA tensor, ``"cpu"``), where the JAX package asks
  ``jax.default_backend()``.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import torch

from .ops import _helpers

__all__ = ["register_op", "register_kernel", "unregister_kernel",
           "get_kernel_override"]

NAMESPACE = "paddle_tpu_ext"
#: the ``torch.library`` names taken so far (a name registered again, after
#: an ``unregister_kernel``, gets a fresh one: torch keeps a defined op)
_defined: Dict[str, int] = {}


def register_kernel(op_name: str, fn: Callable = None, *,
                    backend: Optional[str] = None):
    """Install ``fn`` as the kernel of ``op_name`` on ``backend``
    (``"gpu"``/``"cpu"``; None: every backend).  Usable as a decorator::

        @register_kernel("softmax", backend="gpu")
        def fast_softmax(x, axis=-1, dtype=None, name=None): ...
    """
    if backend not in (None, "gpu", "cpu"):
        raise ValueError(f"register_kernel: backend must be 'gpu', 'cpu' "
                         f"or None, not {backend!r}")

    def _do(f):
        _helpers.KERNEL_OVERRIDES[(op_name, backend)] = f
        return f

    return _do if fn is None else _do(fn)


def unregister_kernel(op_name: str, backend: Optional[str] = None) -> None:
    _helpers.KERNEL_OVERRIDES.pop((op_name, backend), None)


def get_kernel_override(op_name: str, backend: Optional[str] = None
                        ) -> Optional[Callable]:
    """The kernel registered for ``op_name`` on ``backend``, else for every
    backend, else None."""
    table = _helpers.KERNEL_OVERRIDES
    return table.get((op_name, backend)) or table.get((op_name, None))


def _library_name(name: str) -> str:
    """A fresh ``torch.library`` op name for the user's ``name``."""
    base = re.sub(r"\W", "_", name)
    n = _defined.get(base, 0)
    _defined[base] = n + 1
    return base if n == 0 else f"{base}_{n}"


def _recomputed_vjp(fn: Callable) -> Callable:
    """``vjp(inputs, grads)`` of ``fn`` by torch's autograd: ``fn`` runs
    again in the backward on detached copies of the inputs."""
    def vjp(inputs, grads):
        xs = [x.detach().requires_grad_(x.is_floating_point())
              for x in inputs]
        with torch.enable_grad():
            out = fn(*xs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        gs = grads if isinstance(grads, (tuple, list)) else (grads,)
        pairs = [(o, g) for o, g in zip(outs, gs)
                 if g is not None and o.requires_grad]
        wrt = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True) if pairs and wrt
                   else [None] * len(wrt))
        return tuple(next(got) if x.requires_grad else None for x in xs)
    return vjp


def define_op(name: str, cpu: Callable, cuda: Optional[Callable] = None,
              vjp: Optional[Callable] = None, n_outs: int = 1,
              fake: Optional[Callable] = None):
    """A ``torch.library.custom_op`` taking a list of tensors: ``cpu`` (and
    ``cuda``, else ``cpu``) as its implementations, ``fake`` (default
    ``cpu``) for tracing, ``vjp(inputs, grads) -> grads`` as its
    gradient (None: not differentiable).  Returns the ``OpOverload``'s
    packet, ``torch.ops.paddle_tpu_ext.<name>``, called with the tensors
    as one list."""
    lib_name = _library_name(name)
    out = "Tensor" if n_outs == 1 else "Tensor[]"

    def _impl(fn):
        def run(xs):
            res = fn(*xs)
            return res if n_outs == 1 else list(res)
        return run

    op = torch.library.custom_op(f"{NAMESPACE}::{lib_name}",
                                 _impl(cpu), mutates_args=(),
                                 device_types="cpu",
                                 schema=f"(Tensor[] xs) -> {out}")
    op.register_kernel("cuda")(_impl(cuda or cpu))
    op.register_fake(_impl(fake or cpu))
    if vjp is not None:
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*inputs[0])

        def backward(ctx, grad):
            got = vjp(tuple(ctx.saved_tensors), grad)
            got = got if isinstance(got, (tuple, list)) else (got,)
            return (list(got),)

        op.register_autograd(backward, setup_context=setup_context)
    return getattr(getattr(torch.ops, NAMESPACE), lib_name)


def register_op(name: str, fn: Callable, vjp: Optional[Callable] = None,
                tensor_method: bool = False, n_outs: int = 1) -> Callable:
    """A new op ``name`` computing ``fn(*tensors)``; returns its callable.

    ``vjp(inputs, grads) -> input grads`` (``inputs`` the tuple of the
    call's tensors) is its gradient; without one the gradient is that of
    ``fn``, recomputed in the backward.  The op is a
    ``torch.library.custom_op`` (visible to a recording program and to
    ``torch.export`` as one op), and takes the place of a public op of the
    same name (:func:`register_kernel` for every backend, as the JAX
    package registers it).  ``tensor_method=True`` also binds it as a
    method of ``torch.Tensor`` (refused where torch has one)."""
    packet = define_op(name, fn, vjp=vjp or _recomputed_vjp(fn),
                       n_outs=n_outs)

    @_helpers.recorded(name)
    def op_fn(*tensors, **kwargs):
        if kwargs:
            raise TypeError(f"register_op: op {name!r} takes tensors only "
                            f"(got keyword arguments {sorted(kwargs)})")
        res = packet(list(tensors))
        return res if n_outs == 1 else tuple(res)

    op_fn.__doc__ = fn.__doc__
    op_fn.op = packet
    register_kernel(name, op_fn)
    if tensor_method:
        if hasattr(torch.Tensor, name):
            raise ValueError(f"register_op: torch.Tensor already has a "
                             f"{name!r} attribute")
        setattr(torch.Tensor, name, op_fn)
    return op_fn
