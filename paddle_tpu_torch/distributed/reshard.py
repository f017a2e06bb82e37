"""Elastic resharding proofs and the exactly-once elastic data schedule.

Port of ``paddle_tpu/distributed/reshard.py``.  The control plane
(``fleet.elastic``: membership, leases, relaunch) decides when the world
changes; :func:`..checkpoint.load_state_dict` builds a saved state on the
new world.  This module holds the proof obligations of a topology-changing
resume and a data schedule that survives repartitioning:

- :func:`tensor_digest` / :func:`state_digests`: a per-tensor SHA-256 over
  the whole logical tensor (numpy's dtype name, the shape tuple, the
  row-major bytes; bf16 hashed as its ``uint16`` bits), equal to the JAX
  package's digest of the same array.  A ``DTensor`` digests its full
  tensor, so any placement of the same values digests alike, and
  :func:`verify_resharded` raises with a per-tensor report when two
  states differ.
- :class:`ElasticDataSchedule`: step ``s`` consumes the global sample ids
  ``[s*G, (s+1)*G)`` and each rank a contiguous slice of them, so every
  world size partitions the same window: a resume at another world
  replays from the restored step with no sample lost or repeated
  (:meth:`ElasticDataSchedule.assert_coverage` checks it at run time).
- :func:`world_descriptor`: the topology a state was packed under.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .checkpoint import _flatten

__all__ = ["tensor_digest", "state_digests", "diff_digests",
           "verify_resharded", "world_descriptor", "ElasticDataSchedule"]


def _global_numpy(value) -> Optional[np.ndarray]:
    """The whole logical array behind ``value`` (a tensor, a ``DTensor``,
    an ndarray or a Python scalar) on the host, or None for a literal that
    is not an array.  bf16 comes back as its ``uint16`` bits."""
    if isinstance(value, torch.Tensor):
        full = getattr(value, "full_tensor", None)
        t = (full() if callable(full) else value).detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return t.contiguous().numpy()
    if isinstance(value, np.ndarray) or np.isscalar(value):
        return np.asarray(value)
    return None


def tensor_digest(value) -> str:
    """SHA-256 hex digest of a tensor's global bytes, prefixed-hashed
    with dtype and shape so ``zeros((2,4))`` and ``zeros((4,2))``
    differ.  Sharding-independent: any placement of the same logical
    array digests identically.  Non-array literals (ints, strs in a
    packed state) digest their ``repr``."""
    arr = _global_numpy(value)
    h = hashlib.sha256()
    if arr is None:
        h.update(b"literal:" + repr(value).encode())
        return h.hexdigest()
    if arr.dtype.name == "bfloat16":           # an ndarray of ml_dtypes
        arr = arr.view(np.uint16)
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def state_digests(state) -> Dict[str, str]:
    """Per-leaf digests of a (possibly nested) state container, keyed by
    the same '/'-separated paths ``checkpoint.save_state_dict`` uses."""
    return {name: tensor_digest(v) for name, v in _flatten(state).items()}


def diff_digests(got: Dict[str, str], want: Dict[str, str]) -> List[str]:
    """Human-readable mismatch lines between two digest maps (missing,
    extra, and differing leaves); empty list == bitwise identical."""
    out = []
    for name in sorted(set(got) | set(want)):
        a, b = got.get(name), want.get(name)
        if a is None:
            out.append(f"missing from resharded state: {name}")
        elif b is None:
            out.append(f"unexpected leaf in resharded state: {name}")
        elif a != b:
            out.append(f"digest mismatch: {name}: {a[:12]}… != {b[:12]}…")
    return out


def verify_resharded(resharded, reference, ignore: Tuple[str, ...] = ()):
    """Assert ``resharded`` is bitwise identical (per-tensor digest) to
    ``reference`` — the resharded-resume proof obligation.  ``ignore``
    names leaf-path prefixes excluded from the comparison (e.g. the
    ``@wall`` save timestamp, which legitimately differs).  Returns the
    digest map on success; raises ``ValueError`` with the full
    per-tensor report on any mismatch."""
    got = {k: v for k, v in state_digests(resharded).items()
           if not k.startswith(ignore)}
    want = {k: v for k, v in state_digests(reference).items()
            if not k.startswith(ignore)}
    bad = diff_digests(got, want)
    if bad:
        raise ValueError(
            "resharded state is NOT bitwise identical to freshly sharding "
            "the same global arrays:\n  " + "\n  ".join(bad))
    return got


def world_descriptor(mesh=None) -> Dict[str, Any]:
    """The topology a state was packed under: the ``torch.distributed``
    world's processes, the devices one process sees, and the axes of
    ``mesh`` (default the global mesh, :func:`..mesh.get_global_mesh`):
    literal values only, it rides inside the checkpoint.  A resume whose
    descriptor differs is a reconfigured resume."""
    import torch.distributed as dist

    from .mesh import get_global_mesh

    desc: Dict[str, Any] = {
        "processes": dist.get_world_size()
        if dist.is_available() and dist.is_initialized() else 1,
        "devices": torch.cuda.device_count()
        if torch.cuda.is_available() else 1,
    }
    m = mesh if mesh is not None else get_global_mesh()
    if m is not None:
        for axis, size in zip(m.mesh_dim_names or (), m.mesh.shape):
            desc[f"mesh_{axis}"] = int(size)
    return desc


class ElasticDataSchedule:
    """World-size-invariant sample schedule: exactly-once across
    reconfigurations.

    The global batch ``G`` is fixed for the job; step ``s`` consumes
    global sample ids ``[s*G, (s+1)*G)`` (modulo ``dataset_size`` when
    given — an epoch wrap, still deterministic).  A rank's share is the
    contiguous slice of the window given by splitting ``G`` into
    ``world`` near-equal contiguous parts (sizes differ by at most 1),
    so ANY world size partitions the SAME window — resuming at a new np
    repartitions the remaining stream without losing or duplicating a
    sample.  All index math is host-side numpy; nothing here is traced.
    """

    def __init__(self, global_batch: int,
                 dataset_size: Optional[int] = None):
        if global_batch < 1:
            raise ValueError("global_batch must be >= 1")
        if dataset_size is not None and dataset_size < 1:
            raise ValueError("dataset_size must be >= 1 when given")
        self.global_batch = int(global_batch)
        self.dataset_size = None if dataset_size is None else int(dataset_size)

    def step_window(self, step: int) -> Tuple[int, int]:
        """Half-open global-id window consumed by ``step``."""
        g = self.global_batch
        return step * g, (step + 1) * g

    def _bounds(self, rank: int, world: int) -> Tuple[int, int]:
        base, extra = divmod(self.global_batch, world)
        lo = rank * base + min(rank, extra)
        return lo, lo + base + (1 if rank < extra else 0)

    def local_indices(self, step: int, rank: int, world: int) -> np.ndarray:
        """This rank's contiguous slice of step's global-id window (as
        dataset indices when ``dataset_size`` wraps the stream)."""
        if world < 1 or not (0 <= rank < world):
            raise ValueError(f"bad rank/world ({rank}/{world})")
        start, _ = self.step_window(step)
        lo, hi = self._bounds(rank, world)
        ids = np.arange(start + lo, start + hi, dtype=np.int64)
        if self.dataset_size is not None:
            ids %= self.dataset_size
        return ids

    def local_batch(self, step: int, rank: int, world: int,
                    data: np.ndarray) -> np.ndarray:
        """Gather this rank's samples for ``step`` from a host array
        whose leading dim is the dataset (requires ``dataset_size`` or
        ``len(data)`` as the wrap)."""
        sched = self if self.dataset_size is not None else \
            ElasticDataSchedule(self.global_batch, len(data))
        return data[sched.local_indices(step, rank, world)]

    def assert_coverage(self, step: int, world: int) -> None:
        """Host-side exactly-once assert: the union of every rank's
        slice at ``world`` is the step window, with zero duplicates.
        Cheap (pure index math on ``G`` ids) — run it at every world
        size the job passes through."""
        start, stop = self.step_window(step)
        seen = np.concatenate([
            self.local_indices(step, r, world) for r in range(world)])
        want = np.arange(start, stop, dtype=np.int64)
        if self.dataset_size is not None:
            want %= self.dataset_size
        if seen.shape != want.shape or not np.array_equal(seen, want):
            raise AssertionError(
                f"elastic schedule lost/duplicated samples at step {step} "
                f"world {world}: got {seen.size} ids, want {want.size} "
                f"covering [{start}, {stop})")

    def lost_samples(self, boundaries: List[Tuple[int, int, int]]) -> int:
        """Audit a whole run: ``boundaries`` is a list of
        ``(start_step, stop_step, world)`` segments (each segment is one
        "life" of the job, committed steps only).  Returns how many
        global ids in ``[min_start*G, max_stop*G)`` were consumed other
        than exactly once — 0 is the exactly-once contract."""
        if not boundaries:
            return 0
        counts: Dict[int, int] = {}
        for start_step, stop_step, world in boundaries:
            for s in range(start_step, stop_step):
                for r in range(world):
                    for i in self.local_indices(s, r, world).tolist():
                        counts[i] = counts.get(i, 0) + 1
        lo = min(b[0] for b in boundaries) * self.global_batch
        hi = max(b[1] for b in boundaries) * self.global_batch
        want = np.arange(lo, hi, dtype=np.int64)
        if self.dataset_size is not None:
            want %= self.dataset_size
        bad = 0
        expect: Dict[int, int] = {}
        for i in want.tolist():
            expect[i] = expect.get(i, 0) + 1
        for i, n in expect.items():
            if counts.get(i, 0) != n:
                bad += 1
        for i in counts:
            if i not in expect:
                bad += 1
        return bad
