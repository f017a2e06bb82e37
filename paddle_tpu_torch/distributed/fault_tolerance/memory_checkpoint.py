"""Memory-tier checkpoints: a bounded ring of host-RAM snapshots.

Port of ``paddle_tpu/distributed/fault_tolerance/memory_checkpoint.py``
(:101-177).  The disk generations of :mod:`..checkpoint` make a process
relaunch cheap; this ring makes an in-process rollback cheap: a divergence
at step N restores the newest snapshot from host RAM instead of replaying
from the last disk commit.

One schema, two tiers: a snapshot is the
:func:`~.resilient_loop.pack_state` payload the disk generations hold
(``{"user": ..., "@step": N, "@rng": ..., "@scaler": ...}``), so a
snapshot commits straight to disk (the loop does so at a sentry
escalation) and a loaded generation restores through
:func:`restore_packed_state` as a snapshot does.

Copies and the restore:

- :meth:`MemorySnapshotRing.take` copies every tensor leaf to host memory
  (pinned where the source is on the card, the copies queued on the
  current stream and waited for once), so the ring never aliases a live
  tensor.  A snapshot evicted from a full ring gives its host buffers to
  the next one of the same shapes and dtypes: at steady state a snapshot
  allocates nothing.
- The restore writes in place: ``restore_fn`` is expected to load with
  ``load_state_dict``/``set_state_dict`` (torch copies parameters in
  place, and so do the port's optimizers, loss scaler, generator and
  sentry).  This departs from the JAX package, whose restore makes new
  device buffers at each call: a CUDA graph replays on fixed addresses,
  so a rebound tensor would leave a captured step reading the old memory.
- :meth:`MemorySnapshotRing.newest` hands out a fresh host copy each
  call (restoring twice is safe); the loop reads the ring's own copy
  through ``newest(copy=False)``, which a ``load_state_dict`` only reads.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["MemorySnapshotRing", "restore_packed_state"]


class _Leaf:
    """A captured leaf: ``"T"`` a tensor (a host copy), ``"A"`` a numpy
    array (a copy), ``"L"`` a literal."""

    __slots__ = ("tag", "value")

    def __init__(self, tag: str, value):
        self.tag = tag
        self.value = value


def _host_buffer(t: torch.Tensor, pool: Dict[tuple, list]) -> torch.Tensor:
    key = (tuple(t.shape), t.dtype, t.is_cuda)
    free = pool.get(key)
    if free:
        return free.pop()
    return torch.empty(t.shape, dtype=t.dtype, device="cpu",
                       pin_memory=t.is_cuda)


def _capture(obj, pool: Dict[tuple, list]):
    """Nested state → a host-owned copy tree."""
    if isinstance(obj, dict):
        return {k: _capture(v, pool) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        items = [_capture(v, pool) for v in obj]
        return items if isinstance(obj, list) else tuple(items)
    if isinstance(obj, torch.Tensor):
        src = obj.detach()
        buf = _host_buffer(src, pool)
        buf.copy_(src, non_blocking=src.is_cuda)
        return _Leaf("T", buf)
    if isinstance(obj, np.ndarray):
        return _Leaf("A", np.array(obj, copy=True))
    return _Leaf("L", obj)


def _release(node, pool: Dict[tuple, list]) -> None:
    """Give an evicted snapshot's host buffers back to ``pool``."""
    if isinstance(node, dict):
        for v in node.values():
            _release(v, pool)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _release(v, pool)
    elif node.tag == "T":
        t = node.value
        pool.setdefault((tuple(t.shape), t.dtype, t.is_pinned()),
                        []).append(t)


def _restore(node, copy: bool):
    if isinstance(node, dict):
        return {k: _restore(v, copy) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        items = [_restore(v, copy) for v in node]
        return items if isinstance(node, list) else tuple(items)
    if node.tag == "T":
        return node.value.clone() if copy else node.value
    if node.tag == "A":
        return np.array(node.value, copy=True) if copy else node.value
    return node.value


def _tree_bytes(node) -> int:
    if isinstance(node, dict):
        return sum(_tree_bytes(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return sum(_tree_bytes(v) for v in node)
    if node.tag == "T":
        return node.value.numel() * node.value.element_size()
    if node.tag == "A":
        return int(node.value.nbytes)
    return 0


def _has_pinned(node) -> bool:
    if isinstance(node, dict):
        return any(_has_pinned(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return any(_has_pinned(v) for v in node)
    return node.tag == "T" and node.value.is_pinned()


class MemorySnapshotRing:
    """A bounded FIFO of host-RAM state snapshots (newest last).

    ``capacity`` bounds the host memory to ``capacity`` packed states; a
    snapshot past it evicts the oldest (``evictions``).  The newest is the
    rollback target; older ones are insurance against an anomaly that got
    past detection into the newest.
    """

    def __init__(self, capacity: int = 2):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: List[Dict[str, Any]] = []
        self.taken = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._ring)

    def take(self, state: Dict[str, Any]) -> int:
        """Copy ``state`` (a ``pack_state`` payload) to host RAM.  Returns
        the snapshot's step."""
        step = int(state["@step"])
        # a replay that recrosses its own snapshot cadence replaces the
        # entry; a full ring's oldest entry goes (its buffers recycled)
        pool: Dict[tuple, list] = {}
        keep = []
        for s in self._ring:
            if int(s["@step"].value) == step:
                _release(s, pool)
            else:
                keep.append(s)
        self._ring = keep
        while len(self._ring) >= self.capacity:
            _release(self._ring.pop(0), pool)
            self.evictions += 1
        snap = _capture(state, pool)
        if _has_pinned(snap):
            # the device-to-host copies were queued on the current stream
            torch.cuda.current_stream().synchronize()
        self._ring.append(snap)
        self.taken += 1
        return step

    def steps(self) -> List[int]:
        """Snapshot steps held, oldest first."""
        return [int(s["@step"].value) for s in self._ring]

    def newest(self, copy: bool = True) -> Optional[Dict[str, Any]]:
        """The newest snapshot as a restorable tree (None when empty): a
        fresh host copy, or with ``copy=False`` the ring's own tensors,
        for a restore that only reads them (``load_state_dict``)."""
        if not self._ring:
            return None
        return _restore(self._ring[-1], copy)

    def clear(self) -> None:
        self._ring = []

    def nbytes(self) -> int:
        return sum(_tree_bytes(s) for s in self._ring)

    def snapshot(self) -> dict:
        """JSON-ready occupancy stats."""
        return {"capacity": self.capacity, "depth": len(self._ring),
                "steps": self.steps(), "taken": self.taken,
                "evictions": self.evictions, "bytes": self.nbytes()}


def restore_packed_state(state: Dict[str, Any], restore_fn,
                         scaler=None, sentry=None,
                         include_rng: bool = True) -> int:
    """Restore one ``pack_state`` payload, a ring snapshot or a loaded
    disk generation alike.  Every piece is written in place: the user
    state by ``restore_fn``, the generators' states, the loss scaler's and
    the sentry's.  Returns the step the state was packed at."""
    if include_rng and state.get("@rng") is not None:
        from ... import rng

        # first: a state it refuses (a JAX key) raises before any write
        rng.set_rng_state(state["@rng"])
    restore_fn(state["user"])
    if scaler is not None and state.get("@scaler") is not None:
        scaler.load_state_dict(state["@scaler"])
    if sentry is not None and state.get("@sentry") is not None:
        sentry.load_state_dict(state["@sentry"])
    return int(state["@step"])
