"""``paddle.utils.cpp_extension``: user C++ host functions as ops.

Port of ``paddle_tpu/utils/cpp_extension.py`` (reference:
``python/paddle/utils/cpp_extension``, which compiles user ops into a
shared library and binds them).  ``load`` compiles the sources with
``g++`` into a shared library and binds each declared function with
``ctypes`` (no pybind11, no ``ninja``), under the JAX package's C ABI for
elementwise, shape-preserving functions::

    extern "C" void my_op(const float* x, float* y, int64_t n);

Each function becomes a registered op (``custom_kernel.define_op``,
``torch.ops.paddle_tpu_ext.<name>_<fn>``) with a CPU implementation (the
call on the tensor's memory) and a CUDA one (the tensor copied to the
host, the call, the result copied back).  A CUDA graph capture cannot hold
host work, so the CUDA implementation raises ``jit.CaptureError`` naming
the op inside one (eagerly, and on the CPU, it runs).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import _helpers

__all__ = ["load", "CppExtension", "get_build_directory"]

#: where a build goes unless the caller names a directory: the package's
#: own git-ignored build directory
_DEFAULT_BUILD = Path(__file__).resolve().parent.parent / "_build" / \
    "extensions"


def get_build_directory() -> str:
    _DEFAULT_BUILD.mkdir(parents=True, exist_ok=True)
    return str(_DEFAULT_BUILD)


def CppExtension(sources: Sequence[str], *args, **kwargs) -> dict:
    """The reference's setuptools ``Extension`` factory: here the sources,
    to pass on to :func:`load`."""
    return {"sources": list(sources)}


class CustomOpModule:
    """The loaded library and its functions' ops (as attributes)."""

    def __init__(self, name: str, lib_path: str):
        self.name = name
        self.lib_path = lib_path
        self._lib = ctypes.CDLL(lib_path)

    def __repr__(self):
        return f"<CustomOpModule {self.name} from {self.lib_path}>"


def _compile(name: str, sources: List[str], extra_cflags,
             build_directory: Optional[str], verbose: bool) -> str:
    build = build_directory or get_build_directory()
    os.makedirs(build, exist_ok=True)
    flags = list(extra_cflags or [])
    digest = hashlib.sha256()
    for src in sources:
        digest.update(Path(src).read_bytes())
    digest.update(" ".join(flags).encode())
    out = os.path.join(build, f"lib{name}-{digest.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
           *flags, *[os.path.abspath(s) for s in sources]]
    if verbose:
        print("[cpp_extension]", " ".join(cmd))
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for extension {name!r}:\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def _host_call(cfunc, dtype: np.dtype):
    """The CPU implementation: ``cfunc`` on a contiguous copy's memory."""
    tdtype = torch.from_numpy(np.empty(0, dtype)).dtype

    def run(x: torch.Tensor) -> torch.Tensor:
        x = x.detach().to(tdtype).contiguous()
        out = torch.empty_like(x)
        cfunc(x.data_ptr(), out.data_ptr(), x.numel())
        return out
    return run


def _device_call(host, op_name: str):
    """The CUDA implementation: to the host, the call, back; refused inside
    a CUDA graph capture."""
    def run(x: torch.Tensor) -> torch.Tensor:
        if torch.cuda.is_current_stream_capturing():
            from ..jit import CaptureError

            raise CaptureError(
                f"cpp_extension op {op_name!r} runs its C++ function on the "
                f"host, which a CUDA graph capture cannot hold; call it "
                f"outside the to_static program")
        return host(x.cpu()).to(x.device)
    return run


def load(name: str, sources: Sequence[str],
         functions: Optional[Dict[str, dict]] = None,
         extra_cflags: Optional[Sequence[str]] = None,
         build_directory: Optional[str] = None,
         verbose: bool = False) -> CustomOpModule:
    """Compile ``sources`` and make each function of ``functions``
    (``{fn_name: {"dtype": "float32"}}``, the C ABI of the module
    docstring) an op: an attribute of the returned module, callable on a
    tensor on either device.  A build is kept by the sources' hash."""
    from ..custom_kernel import define_op

    lib_path = _compile(name, list(sources), extra_cflags, build_directory,
                        verbose)
    mod = CustomOpModule(name, lib_path)
    for fn_name, spec in (functions or {}).items():
        dtype = np.dtype((spec or {}).get("dtype", "float32"))
        cfunc = getattr(mod._lib, fn_name)
        cfunc.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        cfunc.restype = None
        op_name = f"{name}.{fn_name}"
        host = _host_call(cfunc, dtype)
        packet = define_op(op_name, host, _device_call(host, op_name),
                           fake=lambda x: torch.empty_like(x))

        @_helpers.recorded(op_name)
        def op_fn(x, _packet=packet):
            return _packet([x])

        op_fn.op = packet
        setattr(mod, fn_name, op_fn)
    return mod
