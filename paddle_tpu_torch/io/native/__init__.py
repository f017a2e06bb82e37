"""The shared-memory ring that carries ``DataLoader`` workers' batches.

Port of ``paddle_tpu/io/native/__init__.py`` over the port's own copy of
``shm_ring.cc`` (one single-producer, single-consumer ring in a POSIX
shared-memory segment per worker; see the source).  The library is built
with ``g++`` at first use into the git-ignored ``paddle_tpu_torch/_build/``
(named by a hash of the source, so an edited source builds anew), and
loaded through ctypes.  Without a toolchain :func:`available` is False and
the loader sends every batch through its queue.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

__all__ = ["ShmRing", "available", "load_library"]

_LIB = None
_LIB_LOCK = threading.Lock()
_SRC = Path(__file__).resolve().parent / "shm_ring.cc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD_DIR / f"libshm_ring-{h.hexdigest()[:12]}.so"


def load_library() -> Optional[ctypes.CDLL]:
    """Build (once) and load the ring library; None without ``g++`` or if
    the build fails."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        out = _library_path()
        if not out.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            try:
                res = subprocess.run(
                    ["g++", *_FLAGS, "-o", str(tmp), str(_SRC),
                     "-lpthread", "-lrt"], capture_output=True, text=True)
            except OSError:
                return None
            if res.returncode != 0:
                return None
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.shm_ring_create.restype = ctypes.c_void_p
        lib.shm_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.shm_ring_attach.restype = ctypes.c_void_p
        lib.shm_ring_attach.argtypes = [ctypes.c_char_p]
        lib.shm_ring_push.restype = ctypes.c_int
        lib.shm_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64, ctypes.c_int]
        lib.shm_ring_peek_size.restype = ctypes.c_int64
        lib.shm_ring_peek_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.shm_ring_pop.restype = ctypes.c_int64
        lib.shm_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_uint64, ctypes.c_int]
        lib.shm_ring_close_producer.argtypes = [ctypes.c_void_p]
        lib.shm_ring_detach.argtypes = [ctypes.c_void_p]
        lib.shm_ring_unlink.argtypes = [ctypes.c_char_p]
        _LIB = lib
        return _LIB


def available() -> bool:
    return load_library() is not None


class ShmRing:
    """A handle on one ring: ``create=True`` makes the segment (the
    consumer's side), otherwise it attaches to an existing one."""

    def __init__(self, name: str, capacity: int = 0, create: bool = False):
        lib = load_library()
        if lib is None:
            raise RuntimeError("the shared-memory ring is unavailable (no "
                               "g++ to build shm_ring.cc)")
        self._lib = lib
        self.name = name.encode()
        self._ptr = lib.shm_ring_create(self.name, capacity) if create \
            else lib.shm_ring_attach(self.name)
        if not self._ptr:
            raise OSError(f"shm_ring {'create' if create else 'attach'} "
                          f"failed for {name}")
        self._creator = create

    def push(self, data: bytes, timeout_ms: int = -1) -> None:
        rc = self._lib.shm_ring_push(self._ptr, data, len(data), timeout_ms)
        if rc == -2:
            raise ValueError(
                f"record of {len(data)} bytes exceeds ring capacity")
        if rc == -3:
            raise BrokenPipeError("ring closed")
        if rc != 0:
            raise TimeoutError("shm_ring push timed out")

    def pop(self, timeout_ms: int = -1) -> Optional[bytes]:
        """One record, or None once the producer closed and the ring is
        drained."""
        size = self._lib.shm_ring_peek_size(self._ptr, timeout_ms)
        if size == -3:
            return None
        if size < 0:
            raise TimeoutError("shm_ring pop timed out")
        buf = ctypes.create_string_buffer(int(size))
        got = self._lib.shm_ring_pop(self._ptr, buf, int(size), timeout_ms)
        if got == -3:
            return None
        if got < 0:
            raise TimeoutError("shm_ring pop timed out")
        return buf.raw[:got]

    def close_producer(self) -> None:
        self._lib.shm_ring_close_producer(self._ptr)

    def close(self) -> None:
        if self._ptr:
            self._lib.shm_ring_detach(self._ptr)
            self._ptr = None
        if self._creator:
            self._lib.shm_ring_unlink(self.name)
            self._creator = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
