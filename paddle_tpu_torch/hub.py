"""``paddle.hub``: entry points of a local directory's ``hubconf.py``.

Port of ``paddle_tpu/hub.py`` (reference ``python/paddle/hapi/hub.py``):
``list``, ``help`` and ``load`` from ``source="local"``.  The github and
gitee sources fetch over the network, which this package does not do: they
raise, as in the JAX package.  An entry point builds what it builds (a
layer of this package on the current device, say) and takes keyword
arguments from ``load``.
"""
from __future__ import annotations

import importlib.util
import os

__all__ = ["list", "help", "load"]

_HUB_CONF = "hubconf.py"
_cache: dict = {}


def _load_hubconf(repo_dir: str, force_reload: bool = False):
    path = os.path.join(repo_dir, _HUB_CONF)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {_HUB_CONF} in {repo_dir}")
    key = os.path.abspath(path)
    if not force_reload and key in _cache:
        return _cache[key]
    spec = importlib.util.spec_from_file_location("paddle_tpu_torch_hubconf",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _cache[key] = mod
    return mod


def _check_source(source: str) -> None:
    if source not in ("local", "github", "gitee"):
        raise ValueError(
            f"unknown source {source!r}: expected local/github/gitee")
    if source != "local":
        raise RuntimeError(
            "github/gitee hub sources need network access, which this "
            "package does not use; clone the repo and use source='local'")


def _entry(repo_dir: str, model: str, source: str, force_reload: bool):
    _check_source(source)
    mod = _load_hubconf(repo_dir, force_reload)
    if not hasattr(mod, model):
        raise RuntimeError(f"entrypoint {model!r} not found in hubconf")
    return getattr(mod, model)


def list(repo_dir: str, source: str = "local",  # noqa: A001
         force_reload: bool = False):
    """The callable entry points of ``repo_dir/hubconf.py``."""
    _check_source(source)
    mod = _load_hubconf(repo_dir, force_reload)
    return [n for n in dir(mod)
            if callable(getattr(mod, n)) and not n.startswith("_")]


def help(repo_dir: str, model: str, source: str = "local",  # noqa: A001
         force_reload: bool = False):
    """An entry point's docstring."""
    return _entry(repo_dir, model, source, force_reload).__doc__


def load(repo_dir: str, model: str, source: str = "local",
         force_reload: bool = False, **kwargs):
    """Call an entry point with ``kwargs`` and return what it returns."""
    return _entry(repo_dir, model, source, force_reload)(**kwargs)
