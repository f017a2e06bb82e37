"""The port's current device: Paddle's ``set_device``/``get_device``.

Port of ``paddle_tpu/core/device.py``'s pair, on torch devices.  The
layers of :mod:`.nn` make their parameters and buffers on this device
unless a ``device=`` is passed to them.  It is the card (``"gpu"``, torch's
``cuda``) until :func:`set_device` names another, and reading it with no
card present raises: the CPU is asked for explicitly, with
``set_device("cpu")`` or, for a block, :func:`device_guard`.  torch's own
default device (``torch.set_default_device``, ``with torch.device(...)``)
does not move it.

The rest of ``paddle_tpu/core/device.py``, over ``torch.cuda`` and
``torch.device``: the ``Place`` classes (``CPUPlace`` and ``CUDAPlace``
name a ``torch.device``, :attr:`Place.device`; the other vendors' places
can be made and name none), :func:`device_count`, the memory statistics
(:func:`memory_stats`, :func:`memory_allocated`,
:func:`max_memory_allocated`, :func:`memory_reserved`,
:func:`max_memory_reserved`: the caching allocator's counters of a card,
``{}`` and 0 for the CPU, as the JAX functions give on the CPU),
:func:`synchronize`, the ``is_compiled_with_*`` predicates,
:func:`get_all_device_type` and :func:`get_cudnn_version`, and the
``paddle.device.cuda`` namespace Paddle users call (:data:`cuda`:
those functions with ``device_count``, ``empty_cache``,
``reset_max_memory_allocated`` and ``get_device_name``).  In the JAX
package ``tpu`` and ``cuda`` are one object (:191-210); here ``cuda`` is
the real one and ``tpu`` an alias of it (ROADMAP C).  A ``device`` argument is None (the
current device), an int (that card), a ``Place``, a ``torch.device`` or a
name such as ``"gpu:0"``.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__all__ = ["set_device", "get_device", "current_device", "device_guard",
           "Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "XPUPlace",
           "NPUPlace", "MLUPlace", "IPUPlace", "current_place",
           "device_count", "memory_stats", "memory_allocated",
           "max_memory_allocated", "memory_reserved", "max_memory_reserved",
           "synchronize", "cuda", "tpu", "is_compiled_with_cuda",
           "is_compiled_with_rocm", "is_compiled_with_xpu",
           "is_compiled_with_npu", "is_compiled_with_mlu",
           "is_compiled_with_ipu", "is_compiled_with_cinn",
           "get_cudnn_version", "get_all_device_type",
           "get_all_custom_device_type", "get_available_device",
           "get_available_custom_device"]

DeviceLike = Union[str, torch.device]

_current: Optional[torch.device] = None


def _parse(device: DeviceLike) -> torch.device:
    if isinstance(device, torch.device):
        return device
    kind, _, idx = str(device).lower().partition(":")
    if kind in ("gpu", "cuda"):
        kind = "cuda"
    elif kind != "cpu":
        raise ValueError(f"unsupported device {device!r} (want 'gpu', "
                         f"'gpu:N', 'cuda', 'cuda:N' or 'cpu')")
    return torch.device(kind, int(idx)) if idx else torch.device(kind)


def _check(device: torch.device) -> torch.device:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but no CUDA device is "
            f"available (paddle_tpu_torch.set_device('cpu') runs on the "
            f"CPU)")
    return device


def set_device(device: DeviceLike) -> torch.device:
    """Make ``device`` (``"gpu"``, ``"gpu:N"``, ``"cuda[:N]"``, ``"cpu"``
    or a ``torch.device``) the current device; a card that is not there
    raises."""
    global _current
    _current = _check(_parse(device))
    return _current


def current_device() -> torch.device:
    """The current device as a ``torch.device`` (``cuda`` if none was
    set; raises where there is no card)."""
    return _check(torch.device("cuda") if _current is None else _current)


def get_device() -> str:
    """Paddle's name of the current device: ``"gpu:N"`` or ``"cpu"``."""
    device = current_device()
    if device.type == "cuda":
        idx = torch.cuda.current_device() if device.index is None \
            else device.index
        return f"gpu:{idx}"
    return device.type


@contextlib.contextmanager
def device_guard(device: DeviceLike):
    """``set_device(device)`` for the block, then the device before it."""
    global _current
    before = _current
    set_device(device)
    try:
        yield _current
    finally:
        _current = before


# -- places -------------------------------------------------------------------


class Place:
    """A device kind and ordinal (``phi::Place``)."""

    __slots__ = ("kind", "index")

    def __init__(self, kind: str, index: int = 0):
        self.kind = kind
        self.index = index

    def __repr__(self):
        return f"Place({self.kind}:{self.index})"

    def __eq__(self, other):
        return isinstance(other, Place) and (self.kind, self.index) == (
            other.kind, other.index)

    def __hash__(self):
        return hash((self.kind, self.index))

    def is_gpu_place(self) -> bool:
        return self.kind == "gpu"

    def is_cpu_place(self) -> bool:
        return self.kind == "cpu"

    def get_device_id(self) -> int:
        return self.index

    @property
    def device(self) -> torch.device:
        """The ``torch.device`` of a CPU or CUDA place."""
        if self.kind == "cpu":
            return torch.device("cpu")
        if self.kind == "gpu":
            return torch.device("cuda", self.index)
        raise RuntimeError(f"no {self.kind} device in this build")


class CPUPlace(Place):
    def __init__(self, index: int = 0):
        super().__init__("cpu", index)


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("gpu", device_id)


class CUDAPinnedPlace(Place):
    def __init__(self):
        super().__init__("gpu_pinned", 0)


class XPUPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("xpu", device_id)


class NPUPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("npu", device_id)


class MLUPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("mlu", device_id)


class IPUPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("ipu", device_id)


def current_place() -> Place:
    d = current_device()
    if d.type == "cuda":
        return CUDAPlace(torch.cuda.current_device() if d.index is None
                         else d.index)
    return CPUPlace()


def device_count(kind: Optional[str] = None) -> int:
    """Cards (``kind`` None, ``"gpu"`` or ``"cuda"``), or 1 for ``"cpu"``."""
    if kind == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


# -- memory statistics --------------------------------------------------------


def _card(device=None) -> Optional[torch.device]:
    """The card ``device`` names, or None for the CPU (or no card)."""
    if isinstance(device, Place):
        device = device.device if device.kind in ("cpu", "gpu") \
            else torch.device("cpu")
    elif isinstance(device, int):
        device = torch.device("cuda", device)
    elif isinstance(device, str):
        device = _parse(device)
    elif device is None:
        device = _current if _current is not None else torch.device("cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return device


def memory_stats(device=None) -> dict:
    """The caching allocator's counters of a card (``{}`` for the CPU)."""
    d = _card(device)
    return dict(torch.cuda.memory_stats(d)) if d is not None else {}


def memory_allocated(device=None) -> int:
    """Bytes in tensors on the card now."""
    d = _card(device)
    return int(torch.cuda.memory_allocated(d)) if d is not None else 0


def max_memory_allocated(device=None) -> int:
    """The peak of :func:`memory_allocated` (since the last reset)."""
    d = _card(device)
    return int(torch.cuda.max_memory_allocated(d)) if d is not None else 0


def memory_reserved(device=None) -> int:
    """Bytes the caching allocator holds from the card."""
    d = _card(device)
    return int(torch.cuda.memory_reserved(d)) if d is not None else 0


def max_memory_reserved(device=None) -> int:
    d = _card(device)
    return int(torch.cuda.max_memory_reserved(d)) if d is not None else 0


def reset_max_memory_allocated(device=None) -> None:
    d = _card(device)
    if d is not None:
        torch.cuda.reset_peak_memory_stats(d)


def synchronize(device=None) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    d = _card(device)
    if d is not None:
        torch.cuda.synchronize(d)


class _CudaNamespace:
    """``paddle.device.cuda``."""

    memory_stats = staticmethod(memory_stats)
    memory_allocated = staticmethod(memory_allocated)
    max_memory_allocated = staticmethod(max_memory_allocated)
    memory_reserved = staticmethod(memory_reserved)
    max_memory_reserved = staticmethod(max_memory_reserved)
    reset_max_memory_allocated = staticmethod(reset_max_memory_allocated)
    synchronize = staticmethod(synchronize)

    @staticmethod
    def device_count() -> int:
        return device_count("gpu")

    @staticmethod
    def empty_cache() -> None:
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    @staticmethod
    def get_device_name(device=None) -> str:
        return torch.cuda.get_device_name(_card(device))


cuda = _CudaNamespace()
#: the JAX package's name for its accelerator namespace
tpu = cuda


# -- what this build has ------------------------------------------------------

def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built() and torch.version.hip is None


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def get_cudnn_version():
    """cuDNN's version as torch reports it (None without cuDNN)."""
    return torch.backends.cudnn.version() if \
        torch.backends.cudnn.is_available() else None


def is_compiled_with_mlu() -> bool:
    return False


def is_compiled_with_ipu() -> bool:
    return False


def get_all_device_type() -> list:
    """``["cpu"]``, and ``"gpu"`` with a card."""
    return ["cpu"] + (["gpu"] if torch.cuda.is_available() else [])


def get_all_custom_device_type() -> list:
    return []


def get_available_device() -> list:
    return ["cpu"] + [f"gpu:{i}" for i in range(device_count("gpu"))]


def get_available_custom_device() -> list:
    return []
