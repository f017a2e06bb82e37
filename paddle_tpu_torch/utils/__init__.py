"""``paddle.utils``: ``try_import``, ``deprecated``, ``run_check``,
``unique_name`` and ``require_version``, and the extension points:
``register_op``, ``register_kernel`` and ``unregister_kernel``
(:mod:`..custom_kernel`) and :mod:`.cpp_extension`.

Port of ``paddle_tpu/utils/__init__.py``.  ``run_check`` trains a small
linear model for three steps on the card when there is one, else on the
CPU, and says which device it ran on.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import warnings

from ..custom_kernel import register_kernel, register_op, unregister_kernel
from . import cpp_extension

__all__ = ["try_import", "deprecated", "run_check", "unique_name",
           "require_version", "cpp_extension", "register_op",
           "register_kernel", "unregister_kernel"]


def try_import(module_name: str):
    """The module, or an ``ImportError`` naming it."""
    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(f"Failed to import {module_name}: {e}") from e


def deprecated(update_to="", since="", reason="", level=1):
    """Mark an API deprecated: level 1 warns (``DeprecationWarning``) at
    each call, level 2 raises (the API is removed), level 0 only notes it
    in the docstring, which every level extends."""

    def decorator(fn):
        msg = f"API '{fn.__module__}.{fn.__name__}' is deprecated"
        if since:
            msg += f" since {since}"
        if update_to:
            msg += f", use '{update_to}' instead"
        if reason:
            msg += f". Reason: {reason}"
        fn.__doc__ = (fn.__doc__ or "") + f"\n\n.. deprecated:: {msg}\n"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if level >= 2:
                raise RuntimeError(msg)
            if level == 1:
                warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return wrapper

    return decorator


def run_check() -> None:
    """Check the install: three SGD steps of a small linear model on the
    card (the CPU without one); raises if the loss is not finite."""
    import torch

    from .. import nn, optimizer, rng

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "CPU"
    print(f"Running verify on {device.type} device: {name} ...")
    rng.seed(0)
    lin = nn.Linear(4, 1, device=device)
    opt = optimizer.SGD(lin.parameters(), lr=0.1)
    x = torch.ones(8, 4, device=device)
    y = torch.zeros(8, 1, device=device)
    for _ in range(3):
        loss = ((lin(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("run_check: the train step gave a non-finite "
                           "loss")
    print(f"paddle_tpu_torch is installed successfully on {device.type}! "
          f"Let's start deep learning with paddle_tpu_torch now.")


class _UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self._ids = {}
        self._prefix = prefix

    def __call__(self, key):
        i = self._ids.get(key, 0)
        self._ids[key] = i + 1
        return f"{self._prefix}{key}_{i}"


_generator = _UniqueNameGenerator()


class unique_name:
    """``generate(key)`` gives ``key_0``, ``key_1``, ...; ``guard()``
    scopes a fresh name space (``guard("prefix")`` prefixes it, a callable
    replaces the generator)."""

    @staticmethod
    def generate(key):
        return _generator(key)

    @staticmethod
    @contextlib.contextmanager
    def guard(new_generator=None):
        global _generator
        old = _generator
        if callable(new_generator):
            _generator = new_generator
        else:
            _generator = _UniqueNameGenerator(new_generator or "")
        try:
            yield
        finally:
            _generator = old


def require_version(min_version, max_version=None):
    """Raise unless the package's version is within ``[min_version,
    max_version]``."""
    from .. import version as _v

    def key(s):
        return tuple(int(p) for p in str(s).split(".")[:3] if p.isdigit())

    cur = key(_v.full_version)
    if key(min_version) > cur:
        raise Exception(f"installed version {_v.full_version} < required "
                        f"{min_version}")
    if max_version is not None and key(max_version) < cur:
        raise Exception(f"installed version {_v.full_version} > allowed "
                        f"{max_version}")
