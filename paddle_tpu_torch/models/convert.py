"""Carry weights of the JAX package's models into the port.

The JAX ``state_dict()`` names match the port's module tree
(``llama.layers.0.self_attn.kv_proj.weight``, ``lm_head.weight``, ...).
Paddle keeps a linear weight as ``[in, out]`` and ``nn.Linear`` as
``[out, in]``, so linear weights are transposed; embeddings and norm
weights are taken as they are.  The fused layouts (head-major ``kv_proj``,
``[gate | up]`` ``gate_up_proj``) live on the output axis and survive the
transpose unchanged.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["port_state_dict_from_jax", "from_jax_state_dict"]


def port_state_dict_from_jax(model: nn.Module, state: Dict[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """A JAX-package state dict (name → numpy array) in the port's names
    and layouts: the state dict ``model.state_dict()`` would give, as CPU
    tensors (linear weights transposed).  Touches nothing of ``model``.
    Raises unless the names cover the model exactly and every shape
    matches."""
    linear = {f"{name}.weight" for name, m in model.named_modules()
              if isinstance(m, nn.Linear)}
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise ValueError(f"state dict does not cover the model "
                         f"(missing={missing[:5]}, "
                         f"unexpected={unexpected[:5]})")
    out = {}
    for name, p in params.items():
        arr = np.asarray(state[name])
        if name in linear:
            arr = arr.T
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} after layout "
                             f"change, model has {tuple(p.shape)}")
        out[name] = torch.from_numpy(np.array(arr))    # a writable copy
    return out


@torch.no_grad()
def from_jax_state_dict(model: nn.Module,
                        state: Dict[str, np.ndarray]) -> nn.Module:
    """Write a JAX-package state dict (name → numpy array) into ``model``
    in place, on the model's device and in its dtype
    (:func:`port_state_dict_from_jax`, then ``copy_``)."""
    params = dict(model.named_parameters())
    for name, t in port_state_dict_from_jax(model, state).items():
        params[name].copy_(t)
    return model
