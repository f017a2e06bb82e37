"""``paddle.incubate.asp``: automatic 2:4 structured sparsity.

Port of ``paddle_tpu/incubate/asp.py``: ``prune_model``,
``decorate``, ``calculate_density``, ``set_excluded_layers`` and
``reset_excluded_layers``.  As in the JAX package, sparsity here is model
compression computed densely with masks: ``prune_model`` computes each
mask once on the host (the best 2 of every 4 by magnitude, ``_best_2in4_mask``
at ``asp.py:43``) and zeroes the pruned weights; the optimizer that
:func:`decorate` returns zeroes them again after every step (the
parameter and, under AMP O2, its f32 master), with in-place device ops
only, so a decorated step is captured into a CUDA graph as it stands.
No sparse tensor-core kernel is involved.

The groups of 4 run along the last axis of the weight in Paddle's layout,
so the masks are the JAX package's: a :class:`..nn.Linear` weight, stored
``[out, in]`` here, is masked along ``out`` (the last axis of Paddle's
``[in, out]``).  Embeddings, norms, biases and weights whose Paddle last
axis is below 4 are never pruned.  Parameters are named as
``model.named_parameters()`` names them (the port's parameters carry no
Paddle unique names): ``set_excluded_layers`` takes such names, or the
parameters themselves.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

__all__ = ["calculate_density", "decorate", "prune_model",
           "set_excluded_layers", "reset_excluded_layers"]

_excluded: set = set()
#: ``id(parameter)`` -> (a weak reference to it, its bool mask of what is
#: pruned: True where the weight is held at zero)
_masks: dict = {}


def _drop_mask(p: torch.Tensor):
    entry = _masks.get(id(p))
    if entry is None or entry[0]() is not p:
        return None
    return entry[1]


def set_excluded_layers(param_names, main_program=None):
    """Leave these parameters (names, or the parameters) unpruned."""
    for n in param_names:
        _excluded.add(n if isinstance(n, str) else id(n))


def reset_excluded_layers(main_program=None):
    _excluded.clear()


def calculate_density(x) -> float:
    """The fraction of nonzero entries."""
    arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    return float((arr != 0).sum()) / max(arr.size, 1)


def _best_2in4_mask(w: np.ndarray) -> np.ndarray:
    """The 2:4 keep mask along the last axis: the 2 largest ``|w|`` of
    every contiguous group of 4 (a short last group padded with zeros)."""
    orig_shape = w.shape
    n = w.shape[-1]
    pad = (-n) % 4
    if pad:
        w = np.concatenate(
            [w, np.zeros(w.shape[:-1] + (pad,), w.dtype)], axis=-1)
    g = np.abs(w).reshape(-1, 4)
    order = np.argsort(-g, axis=1)
    mask = np.zeros_like(g, dtype=bool)
    mask[np.arange(g.shape[0])[:, None], order[:, :2]] = True
    mask = mask.reshape(w.shape)
    if pad:
        mask = mask[..., :n]
    return mask.reshape(orig_shape)


def _transposed(layer) -> bool:
    """Whether ``layer``'s weight is stored transposed from Paddle's."""
    return isinstance(layer, torch.nn.Linear)


def _supported(layer) -> bool:
    from .. import nn

    return isinstance(layer, (torch.nn.Linear, nn.Conv1D, nn.Conv2D,
                              nn.Conv3D))


def _prunable(layer, name: str, p: torch.Tensor) -> bool:
    if name in _excluded or id(p) in _excluded or not _supported(layer):
        return False
    if p.dim() < 2:
        return False
    last = p.shape[0] if _transposed(layer) else p.shape[-1]
    return last >= 4


@torch.no_grad()
def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """Compute and apply the 2:4 masks of every prunable weight of
    ``model``; returns ``{name: keep mask}`` (bool, the parameter's
    shape)."""
    if (n, m) != (2, 4):
        raise NotImplementedError("only 2:4 sparsity is supported")
    out = {}
    for lname, layer in model.named_modules():
        for pname, p in layer.named_parameters(recurse=False):
            name = f"{lname}.{pname}" if lname else pname
            if not _prunable(layer, name, p):
                continue
            w = p.detach().float().cpu().numpy()
            if _transposed(layer):
                keep = _best_2in4_mask(w.T).T
            else:
                keep = _best_2in4_mask(w)
            keep = torch.from_numpy(np.ascontiguousarray(keep)).to(p.device)
            _masks[id(p)] = (weakref.ref(p), ~keep)
            p.masked_fill_(~keep, 0)
            out[name] = keep
    return out


class OptimizerWithSparsityGuarantee:
    """An optimizer whose ``step`` keeps the pruned weights at zero."""

    def __init__(self, optimizer):
        self._inner_opt = optimizer

    @torch.no_grad()
    def step(self, closure=None):
        loss = self._inner_opt.step(closure)
        for group in self._inner_opt.param_groups:
            for p in group["params"]:
                drop = _drop_mask(p)
                if drop is None:
                    continue
                p.masked_fill_(drop, 0)
                master = self._inner_opt.state[p].get("master_weight")
                if master is not None:
                    master.masked_fill_(drop, 0)
        return loss

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, *a, **k):
        return self._inner_opt.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)


def decorate(optimizer):
    return OptimizerWithSparsityGuarantee(optimizer)
