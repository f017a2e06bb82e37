"""``nn.utils``: parameter vectors, weight norm and spectral norm.

Port of ``paddle_tpu/nn/utils/__init__.py``.  ``weight_norm(dim=)`` and
``spectral_norm(dim=)`` name a dim of the weight in Paddle's layout; a
``Linear``'s 2-D weight is stored as torch's ``[out, in]``, the transpose
of Paddle's ``[in, out]``, so its dim is mapped (Paddle's 0 is torch's
1).  The reparametrised weight is recomputed by a forward pre-hook and
set as a plain attribute of the layer; ``weight_g``/``weight_v``
(``weight_orig`` and the ``weight_sn`` sublayer) are its parameters, in
the JAX package's names and shapes (``weight_v`` of a ``Linear``
transposed, ``weight_g`` as it is).  ``remove_weight_norm`` folds the
weight back along the dim it was normalised over.
"""
from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

from ..clip import clip_grad_norm_  # noqa: F401

__all__ = ["parameters_to_vector", "vector_to_parameters", "weight_norm",
           "remove_weight_norm", "spectral_norm", "clip_grad_norm_"]


def parameters_to_vector(parameters: Iterable[torch.Tensor], name=None
                         ) -> torch.Tensor:
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec: torch.Tensor,
                         parameters: Iterable[torch.Tensor],
                         name=None) -> None:
    """Write consecutive slices of ``vec`` into ``parameters`` in place."""
    offset = 0
    for p in parameters:
        n = p.numel()
        p.copy_(vec[offset:offset + n].reshape(p.shape))
        offset += n


def _torch_dim(layer: nn.Module, dim: int, ndim: int) -> int:
    """Paddle's ``dim`` of a weight as a dim of the port's tensor."""
    dim %= ndim
    if isinstance(layer, nn.Linear) and ndim == 2:
        return 1 - dim
    return dim


def _other_dims(ndim: int, dim: int) -> list:
    return [i for i in range(ndim) if i != dim]


def weight_norm(layer: nn.Module, name: str = "weight", dim: int = 0):
    """Reparametrise ``layer.<name>`` as ``g * v / |v|``, the norm over
    every dim but ``dim``."""
    w = getattr(layer, name).detach()
    d = _torch_dim(layer, dim, w.dim())
    axes = _other_dims(w.dim(), d)
    del layer._parameters[name]
    layer.register_parameter(
        name + "_g", nn.Parameter(torch.linalg.vector_norm(w, dim=axes)))
    layer.register_parameter(name + "_v", nn.Parameter(w.clone()))

    def _pre_hook(module, inputs):
        g = module._parameters[name + "_g"]
        v = module._parameters[name + "_v"]
        shape = [1] * v.dim()
        shape[d] = -1
        nrm = torch.linalg.vector_norm(v, dim=axes, keepdim=True)
        setattr(module, name, v / nrm * g.reshape(shape))

    handles = layer.__dict__.setdefault("_weight_norm_hooks", {})
    handles[name] = (layer.register_forward_pre_hook(_pre_hook), d)
    _pre_hook(layer, ())
    return layer


def remove_weight_norm(layer: nn.Module, name: str = "weight"):
    """Fold ``g`` and ``v`` back into one parameter ``name``."""
    handle, d = layer._weight_norm_hooks.pop(name)
    handle.remove()
    g = layer._parameters.pop(name + "_g")
    v = layer._parameters.pop(name + "_v")
    shape = [1] * v.dim()
    shape[d] = -1
    with torch.no_grad():
        w = v / torch.linalg.vector_norm(v, dim=_other_dims(v.dim(), d),
                                         keepdim=True) * g.reshape(shape)
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, nn.Parameter(w))
    return layer


def spectral_norm(layer: nn.Module, name: str = "weight",
                  n_power_iterations: int = 1, eps: float = 1e-12,
                  dim=None):
    """Divide ``layer.<name>`` by its spectral norm at every forward
    (``<name>_orig`` the parameter, ``<name>_sn`` the power iteration's
    :class:`..layer.norm.SpectralNorm`)."""
    from ..layer.norm import SpectralNorm

    w = getattr(layer, name)
    d = _torch_dim(layer, 0 if dim is None else dim, w.dim())
    sn = SpectralNorm(list(w.shape), axis=d, power_iters=n_power_iterations,
                      epsilon=eps).to(w.device)
    layer.add_module(name + "_sn", sn)
    layer.register_parameter(name + "_orig", layer._parameters.pop(name))

    def _pre_hook(module, inputs):
        setattr(module, name, sn(module._parameters[name + "_orig"]))

    layer.register_forward_pre_hook(_pre_hook)
    _pre_hook(layer, ())
    return layer
