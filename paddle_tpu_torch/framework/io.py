"""``save`` / ``load`` of tensors and nested containers of them.

Port of ``paddle_tpu/framework/io.py`` (:73-95), in its on-disk format: a
pickle (protocol 4) of the object with every tensor replaced by a tagged
payload, ``_TensorPayload``, holding a numpy array, the dtype's name, the
tensor's name and its ``stop_gradient`` flag; bfloat16 is stored as the
``uint16`` view of its bits under the tag ``"bfloat16"``.

The loader also reads files the JAX package wrote, without importing it:
an ``Unpickler.find_class`` maps that package's payload class
(``paddle_tpu.framework.io._TensorPayload``) to this module's copy, which
has the same slots, and refuses every other name of that package.  So a
JAX ``jit.save``'s ``.pdiparams`` loads here as name -> tensor, and
``models.port_state_dict_from_jax`` carries the weights into a port
model.  Unpickling runs the constructors a file names, so the loader
resolves only the names such a file holds (the payload classes, numpy's
array reconstruction, ``OrderedDict`` and plain builtin containers) and
refuses any other.

``load`` returns CPU tensors (``return_numpy=True``: numpy arrays; numpy
has no bfloat16 without ``ml_dtypes``, so a bfloat16 payload comes back as
float32 there, every value exact).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]

#: the JAX package's payload class, as its pickles name it
_JAX_PAYLOAD = ("paddle_tpu.framework.io", "_TensorPayload")
#: the other names a tensor file may hold: numpy's array and scalar
#: reconstruction (numpy 1 and 2 module paths) and containers
_ALLOWED = {
    **{(m, n): None for m in ("numpy.core.multiarray",
                              "numpy._core.multiarray")
       for n in ("_reconstruct", "scalar")},
    ("numpy", "ndarray"): None, ("numpy", "dtype"): None,
    ("collections", "OrderedDict"): None,
    **{("builtins", n): None for n in ("dict", "list", "tuple", "set",
                                       "frozenset", "complex", "slice")},
}


class _TensorPayload:
    """Pickle-stable tensor representation (the JAX package's slots)."""

    __slots__ = ("data", "dtype_name", "name", "stop_gradient")

    def __init__(self, tensor: torch.Tensor, name: str = ""):
        t = tensor.detach().cpu()
        self.dtype_name = str(t.dtype).split(".")[-1]
        if t.dtype == torch.bfloat16:
            self.data = t.view(torch.int16).numpy().view(np.uint16).copy()
        else:
            self.data = t.numpy().copy()
        self.name = name
        self.stop_gradient = not tensor.requires_grad

    def restore(self) -> torch.Tensor:
        arr = np.asarray(self.data)
        if self.dtype_name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()) \
                .view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        if t.is_floating_point() and not self.stop_gradient:
            t.requires_grad_(True)
        return t

    def restore_numpy(self) -> np.ndarray:
        if self.dtype_name == "bfloat16":
            return self.restore().detach().float().numpy()
        return np.asarray(self.data)


class _Unpickler(pickle.Unpickler):
    """Maps the JAX package's payload class to this module's, refuses any
    other name of that package (which this package never imports), and
    resolves only the names of :data:`_ALLOWED` besides."""

    def find_class(self, module, name):
        if (module, name) in (_JAX_PAYLOAD,
                              (__name__, "_TensorPayload")):
            return _TensorPayload
        if module == "paddle_tpu" or module.startswith("paddle_tpu."):
            raise pickle.UnpicklingError(
                f"{module}.{name}: a name of the JAX package, which "
                f"paddle_tpu_torch does not load (only its tensor payloads)")
        if (module, name) not in _ALLOWED:
            raise pickle.UnpicklingError(
                f"{module}.{name}: not a name a tensor file holds")
        return super().find_class(module, name)


def _convert_for_save(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _convert_for_save(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_convert_for_save(o) for o in obj)
    return obj


def _convert_for_load(obj, return_numpy: bool = False):
    if isinstance(obj, _TensorPayload):
        return obj.restore_numpy() if return_numpy else obj.restore()
    if isinstance(obj, dict):
        return {k: _convert_for_load(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_convert_for_load(o, return_numpy) for o in obj)
    return obj


def save(obj, path, protocol: int = 4, **configs) -> None:
    """``paddle.save``: a tensor, a state dict or nested containers, to a
    path (its directory made) or a binary file object."""
    if hasattr(path, "write"):
        pickle.dump(_convert_for_save(obj), path, protocol=protocol)
        return
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_convert_for_save(obj), f, protocol=protocol)


def load(path, return_numpy: bool = False, **configs):
    """``paddle.load``: what :func:`save` (of either package) wrote, its
    tensors as CPU tensors, or numpy arrays with ``return_numpy``."""
    if hasattr(path, "read"):
        obj = _Unpickler(path).load()
    else:
        with open(path, "rb") as f:
            obj = _Unpickler(f).load()
    return _convert_for_load(obj, return_numpy=return_numpy)
