"""``paddle.incubate.autograd``: the functional differentiation API.

Port of ``paddle_tpu/incubate/autograd.py`` on ``torch.func``: ``vjp``
(reverse mode, cotangent ones by default), ``jvp`` (forward mode, tangent
ones by default), and the lazy :class:`Jacobian` and :class:`Hessian`,
computed at their first read (``[i]``, ``numpy()``) and kept.  Their
``shape`` runs the function once on ``meta`` tensors (no arithmetic), as
the JAX classes read it off ``jax.eval_shape``.

- ``Jacobian(func, xs)``: ``[out_size, in_size]``, the outputs flattened
  and concatenated in order, the columns the inputs' in order;
  ``is_batched=True`` (one input ``[B, ...]``): ``[B, out_size, in_size]``
  per sample, by ``vmap`` of the per-sample Jacobian.
- ``Hessian(func, xs)`` of a scalar function: ``[in_size, in_size]``;
  batched (one input ``[B, n]``, one scalar a sample): ``[B, n, n]``.  A
  function with more than one output element raises ``ValueError``.

``enable_prim``, ``disable_prim``, ``prim_enabled`` and ``prim2orig`` keep
the JAX package's switch as state only: torch, like XLA there, always
differentiates its own primitives.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import func as tfunc

__all__ = ["vjp", "jvp", "Jacobian", "Hessian", "enable_prim",
           "disable_prim", "prim_enabled", "prim2orig"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _pack(ts):
    ts = list(ts)
    return ts[0] if len(ts) == 1 else tuple(ts)


def _flat(func):
    """``func`` with its outputs flattened into one vector."""

    def flat(*xs):
        outs = _as_list(func(*xs))
        return torch.cat([o.reshape(-1) for o in outs])

    return flat


def vjp(func, xs, v=None):
    """``(outputs, input gradients)`` for the cotangent ``v`` (ones by
    default)."""
    xs = _as_list(xs)
    outs, pullback = tfunc.vjp(func, *xs)
    if v is None:
        cot = tuple(torch.ones_like(o) for o in _as_list(outs))
    else:
        cot = tuple(_as_list(v))
    if not isinstance(outs, (tuple, list)):
        cot = cot[0]
    return _pack(_as_list(outs)), _pack(pullback(cot))


def jvp(func, xs, v=None):
    """``(outputs, output tangents)`` for the tangent ``v`` (ones by
    default)."""
    xs = _as_list(xs)
    tangents = tuple(torch.ones_like(x) for x in xs) if v is None \
        else tuple(_as_list(v))
    outs, tans = tfunc.jvp(func, tuple(xs), tangents)
    return _pack(_as_list(outs)), _pack(_as_list(tans))


def _out_size(flat, xs) -> int:
    """The flat output's length, from a run on ``meta`` tensors (a real
    run if the function cannot take them)."""
    try:
        return int(flat(*[x.detach().to("meta") for x in xs]).shape[0])
    except Exception:        # noqa: BLE001 — an op without a meta kernel
        with torch.no_grad():
            return int(flat(*[x.detach() for x in xs]).shape[0])


class _Lazy:
    def __init__(self, func, xs, is_batched=False):
        self._func = func
        self._xs = _as_list(xs)
        self._is_batched = is_batched
        self._mat = None

    def _single_input(self, what: str) -> torch.Tensor:
        if len(self._xs) > 1:
            raise NotImplementedError(
                f"batched {what} supports a single input tensor [B, ...]; "
                f"pass inputs concatenated")
        return self._xs[0]

    def _compute(self) -> torch.Tensor:
        raise NotImplementedError

    def __getitem__(self, idx):
        if self._mat is None:
            self._mat = self._compute()
        return self._mat[idx]

    def numpy(self) -> np.ndarray:
        return self[...].detach().cpu().numpy()


class Jacobian(_Lazy):
    """The lazy Jacobian (module docstring)."""

    def _compute(self):
        flat = _flat(self._func)
        if self._is_batched:
            x = self._single_input("Jacobian")
            jac = tfunc.vmap(tfunc.jacrev(lambda xb: flat(xb[None])))(x)
            return jac.reshape(x.shape[0], jac.shape[1], -1)
        jacs = tfunc.jacrev(flat, argnums=tuple(range(len(self._xs))))(
            *self._xs)
        rows = jacs[0].shape[0]
        return torch.cat([j.reshape(rows, -1) for j in jacs], dim=1)

    @property
    def shape(self):
        if self._mat is not None:
            return list(self._mat.shape)
        flat = _flat(self._func)
        if self._is_batched:
            x = self._xs[0]
            return [int(x.shape[0]), _out_size(flat, [x[:1]]),
                    int(x[0].numel())]
        return [_out_size(flat, self._xs),
                int(sum(x.numel() for x in self._xs))]


def _scalar(out: torch.Tensor, what: str) -> torch.Tensor:
    if out.numel() != 1:
        raise ValueError(what)
    return out.reshape(())


class Hessian(_Lazy):
    """The lazy Hessian of a scalar function (module docstring)."""

    def _compute(self):
        flat = _flat(self._func)
        if self._is_batched:
            x = self._single_input("Hessian")
            h = tfunc.vmap(tfunc.hessian(lambda xb: _scalar(
                flat(xb[None]),
                "batched Hessian requires one scalar per sample")))(x)
            n = int(x[0].numel())
            return h.reshape(x.shape[0], n, n)
        n_in = len(self._xs)
        h = tfunc.hessian(lambda *a: _scalar(
            flat(*a), "Hessian requires a scalar function"),
            argnums=tuple(range(n_in)))(*self._xs)
        sizes = [x.numel() for x in self._xs]
        return torch.cat([torch.cat([h[i][j].reshape(sizes[i], sizes[j])
                                     for j in range(n_in)], dim=1)
                          for i in range(n_in)], dim=0)

    @property
    def shape(self):
        if self._mat is not None:
            return list(self._mat.shape)
        if self._is_batched:
            x = self._xs[0]
            n = int(x[0].numel())
            return [int(x.shape[0]), n, n]
        n = int(sum(x.numel() for x in self._xs))
        return [n, n]


# -- the primitive-mode switch (state only; module docstring) -----------------

_prim_enabled = False


def enable_prim():
    global _prim_enabled
    _prim_enabled = True


def disable_prim():
    global _prim_enabled
    _prim_enabled = False


def prim_enabled() -> bool:
    return _prim_enabled


def prim2orig(block=None):
    """No primitive block to rewrite: returns None, as the JAX one does."""
    return None
