"""``nn.Layer``, ``ParamAttr`` and ``Parameter``.

Port of ``paddle_tpu/nn/layer_base.py``.  ``Layer`` is a
``torch.nn.Module``: registration, traversal, hooks, ``state_dict`` and
train/eval are torch's.  It adds only the Paddle names torch lacks:

- ``create_parameter(shape, attr, dtype, is_bias, default_initializer)``
  with the JAX package's precedence (a ``ParamAttr`` initializer, then
  :func:`.initializer.set_global_initializer`'s, then the layer's default;
  ``attr=False`` gives None);
- ``add_sublayer``, ``add_parameter``, ``sublayers``/``named_sublayers``,
  ``register_buffer(..., persistable=)`` (a non-persistable buffer stays
  out of ``state_dict``, as torch's ``persistent=False``);
- ``set_state_dict`` (shape-checked, returns ``(missing, unexpected)``;
  ``load_dict``), ``register_forward_post_hook``,
  ``to(device=, dtype=, blocking=)`` with Paddle's dtype names,
  ``astype``, ``full_name``, ``clear_gradients``, and ``parameters`` /
  ``named_parameters`` taking ``include_sublayers``.

``Parameter`` is ``torch.nn.Parameter``.  A parameter made through
``create_parameter`` carries its ``ParamAttr``'s ``trainable``
(as ``requires_grad``), ``need_clip`` (read by ``nn.clip``), ``regularizer``
(stored only: the optimizers, as the JAX package's, read their own
``weight_decay``) and ``optimize_attr = {"learning_rate": lr}`` as
attributes.  Parameters are made on ``device`` (default: the port's
current device, :func:`..device.current_device`: the card unless
``set_device`` named another, raising where there is none) in ``dtype``
(default: the layer's, float32).
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import device as _device
from . import initializer as I

__all__ = ["Layer", "Parameter", "ParamAttr"]

Parameter = nn.Parameter

_layer_name_counters: Dict[str, int] = collections.defaultdict(int)


class ParamAttr:
    """Paddle's ``ParamAttr``: how ``create_parameter`` makes a parameter."""

    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return I._dtype(dtype)


class Layer(nn.Module):
    """The base of every layer (reference: ``dygraph/layers.py:84``)."""

    def __init__(self, name_scope: Optional[str] = None,
                 dtype="float32"):
        super().__init__()
        scope = name_scope or type(self).__name__.lower()
        idx = _layer_name_counters[scope]
        _layer_name_counters[scope] += 1
        self._full_name = f"{scope}_{idx}"
        self._dtype = _torch_dtype(dtype)

    def full_name(self) -> str:
        return self._full_name

    # -- parameters --------------------------------------------------------

    def create_parameter(self, shape, attr=None, dtype=None,
                         is_bias: bool = False, default_initializer=None,
                         *, device=None, transpose: bool = False
                         ) -> Optional[nn.Parameter]:
        """A new parameter of Paddle shape ``shape`` (not registered: assign
        it to an attribute).  ``transpose=True`` stores the transpose of
        the 2-D draw (a torch ``[out, in]`` weight drawn as Paddle's
        ``[in, out]``)."""
        if attr is False:
            return None
        init, trainable = default_initializer, True
        need_clip, regularizer, lr = True, None, 1.0
        attr_init = None
        if isinstance(attr, I.Initializer):
            attr_init = attr
        elif attr is not None and not isinstance(attr, str):
            attr_init = getattr(attr, "initializer", None)
            trainable = getattr(attr, "trainable", True)
            need_clip = getattr(attr, "need_clip", True)
            regularizer = getattr(attr, "regularizer", None)
            lr = getattr(attr, "learning_rate", 1.0)
        if attr_init is not None:
            init = attr_init
        else:
            g = I._get_global_initializer()
            if g is not None and (g[1] if is_bias else g[0]) is not None:
                init = g[1] if is_bias else g[0]
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierUniform()
        dtype = _torch_dtype(dtype) or self._dtype or torch.float32
        value = init(shape, dtype)
        if transpose:
            value = value.T.contiguous()
        device = _device.current_device() if device is None else device
        p = nn.Parameter(value.to(device), requires_grad=trainable)
        p.trainable = trainable
        p.need_clip = need_clip
        p.regularizer = regularizer
        p.optimize_attr = {"learning_rate": lr}
        return p

    def add_parameter(self, name: str, parameter: Optional[nn.Parameter]):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer: Optional[nn.Module]):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor: Optional[torch.Tensor],
                        persistable: bool = True,
                        persistent: Optional[bool] = None):
        """Paddle's ``persistable`` (torch's ``persistent``): a
        non-persistable buffer is not in ``state_dict``."""
        if persistent is not None:
            persistable = persistent
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    def parameters(self, include_sublayers: bool = True,
                   recurse: Optional[bool] = None) -> List[nn.Parameter]:
        return list(super().parameters(
            include_sublayers if recurse is None else recurse))

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         remove_duplicate: bool = True,
                         recurse: Optional[bool] = None):
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    # -- traversal ---------------------------------------------------------

    def sublayers(self, include_self: bool = False) -> List[nn.Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False
                        ) -> Iterator[Tuple[str, nn.Module]]:
        it = self.named_modules(prefix=prefix)
        if not include_self:
            next(it)
        yield from it

    # -- hooks -------------------------------------------------------------

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after each forward; a value it
        returns replaces the outputs."""
        return self.register_forward_hook(hook)

    # -- state -------------------------------------------------------------

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy values (tensors or arrays) into the parameters and
        persistable buffers of the same names, in place and in their
        dtypes; a shape mismatch raises.  Returns ``(missing,
        unexpected)`` names."""
        own = self.state_dict(keep_vars=True)
        unexpected = [k for k in state_dict if k not in own]
        for k, v in state_dict.items():
            if k not in own:
                continue
            t = own[k]
            v = v if isinstance(v, torch.Tensor) \
                else torch.as_tensor(np.asarray(v))
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"state_dict shape mismatch for {k}: "
                                 f"{list(v.shape)} vs {list(t.shape)}")
            t.copy_(v)
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict

    # -- dtype / device ----------------------------------------------------

    def to(self, *args, device=None, dtype=None, blocking=None, **kwargs):
        """torch's ``to``, also taking Paddle's keywords and dtype names
        (``to(dtype="bfloat16")``)."""
        args = [_torch_dtype(a) if isinstance(a, str) and
                isinstance(getattr(torch, a, None), torch.dtype) else a
                for a in args]
        if device is not None:
            kwargs["device"] = device
        if dtype is not None:
            kwargs["dtype"] = _torch_dtype(dtype)
            self._dtype = kwargs["dtype"]
        if blocking is not None:
            kwargs["non_blocking"] = not blocking
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.grad = None
