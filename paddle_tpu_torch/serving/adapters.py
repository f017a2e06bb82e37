"""Multi-LoRA serving: per-request low-rank adapter lanes.

Port of ``paddle_tpu/serving/adapters.py``.  One deployment serves up to
``max_adapters`` fine-tunes of one base model:

- **Which adapter a slot decodes under is data.**  An
  :class:`AdapterPool` stacks the adapters' factor pairs per target
  linear, ``A [L, in, rank]`` and ``B [L, rank, out]`` with lane 0 the
  all-zero base lane, plus one ``adapter_ids [slots] int32`` lane.  One
  prefill, decode or verify program (a CUDA graph on the card) serves
  every tenant mix: the lanes are tensors the programs read, written in
  place between steps.
- **The low-rank math runs inside the step.**  Every ``nn.Linear`` of
  the decoder layers (the port's counterparts of the JAX package's
  ``ColumnParallelLinear``/``RowParallelLinear``, under the same module
  names; never ``lm_head`` or an embedding) gets a forward hook that
  gathers each row's factors and returns
  ``where(rows > 0, out + (x @ A[rows]) @ B[rows], out)``.  The select,
  not an add, keeps a base row bitwise (``-0.0 + 0.0`` is ``+0.0``).
  The hook reads no device value on the host and branches on none, so
  it is captured as it stands; outside a step (no rows set) it returns
  ``out`` untouched.
- **The host side is a small registry.**  ``load``/``unload`` write lane
  rows in place (``copy_``/``zero_``) on the current stream, the one the
  programs replay on, synchronise it, and raise if a lane tensor moved
  (a captured graph reads the address it saw at capture).  Each adapter
  name carries a version, bumped at every load of that name and kept
  across an unload; ``salt(name) == b"name@vN"`` goes into the prefix
  cache's chain root, so tenant K/V never hits another tenant's, nor a
  stale version of its own.

On a tensor-parallel model (``Engine(mesh=...)``) a bank shards like the
layer it modifies: a column layer's bank holds the rank's columns of
``B`` (its out-features), a row layer's the rank's rows of ``A`` (its
in-features), the other factor whole.  The hook of a tensor-parallel
layer is its ``lora`` attribute, which it applies to its own output
before the all-gather or the all-reduce: a row layer's delta joins the
rank's partial product and is summed with it.  :meth:`AdapterPool.load`
takes whole factors and writes the rank's share.

The banks and the id lane are the pool's own tensors, not parameters or
buffers of the model: ``model.named_parameters()``, ``state_dict()`` and
``update_weights``' cover check see the model as it was.  Not supported,
as in the JAX package: a rank per slot (rank is one pool constant),
adapters on the draft model, and adapters on embeddings or ``lm_head``.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["AdapterConfig", "AdapterPool", "make_lora_weights"]


@dataclass
class AdapterConfig:
    """The pool's size: ``max_adapters`` adapters loaded at once (lane 0,
    the base model, does not count) at one low-rank width ``rank``."""

    max_adapters: int = 4
    rank: int = 4

    def __post_init__(self):
        if self.max_adapters < 1:
            raise ValueError("max_adapters must be >= 1")
        if self.rank < 1:
            raise ValueError("rank must be >= 1")


@dataclass
class _Bank:
    """One target linear's stacked factors."""

    key: str                  # module path of the target layer
    in_features: int          # whole (the factors a load takes)
    out_features: int
    A: torch.Tensor           # [L, in, rank] (the rank's in-rows: row)
    B: torch.Tensor           # [L, rank, out] (the rank's out-cols: column)
    #: a tensor-parallel layer's kind ("column" or "row") and the whole
    #: dim's indices this rank holds; None for a plain linear
    kind: Optional[str] = None
    index: Optional[torch.Tensor] = None


def _f32(w) -> torch.Tensor:
    """A factor (numpy array or tensor) as an f32 tensor."""
    if isinstance(w, torch.Tensor):
        return w.detach().float()
    return torch.from_numpy(np.asarray(w, dtype=np.float32))


def _remove_hooks(handles) -> None:
    for h in handles:
        h.remove()


class _LoraHandle:
    """Removes a tensor-parallel layer's ``lora`` hook."""

    def __init__(self, layer):
        self.layer = weakref.ref(layer)

    def remove(self) -> None:
        layer = self.layer()
        if layer is not None:
            layer.lora = None


def _tp_kind(layer) -> Optional[str]:
    """``"column"``/``"row"`` for a tensor-parallel linear, else None."""
    if not hasattr(layer, "lora"):
        return None
    return "row" if hasattr(layer, "full_in_features") else "column"


def lora_targets(model: nn.Module) -> Dict[str, nn.Linear]:
    """The adapter targets of ``model``, by module path: every
    ``nn.Linear`` but ``lm_head`` (the decoder layers' projections)."""
    return {path: m for path, m in model.named_modules()
            if isinstance(m, nn.Linear)
            and path.rsplit(".", 1)[-1] != "lm_head"}


class AdapterPool:
    """Stacked per-target LoRA lanes and the per-slot adapter-id lane,
    hooked into ``model``'s targets (:func:`lora_targets`); ``num_slots``
    sizes the id lane.  The factors are kept in the model parameters'
    dtype on their device."""

    def __init__(self, model: nn.Module, num_slots: int, *,
                 max_adapters: int = 4, rank: int = 4):
        self.num_slots = int(num_slots)
        self.max_adapters = int(max_adapters)
        self.rank = int(rank)
        self.num_lanes = self.max_adapters + 1        # lane 0 = base
        param = next(model.parameters())
        self.device = param.device
        self.dtype = param.dtype
        self.banks: Dict[str, _Bank] = {}
        targets = lora_targets(model)
        if not targets:
            raise ValueError("AdapterPool found no nn.Linear targets in the "
                             "model")
        me, handles = weakref.ref(self), []
        for path, layer in targets.items():
            A = torch.zeros((self.num_lanes, layer.in_features, self.rank),
                            dtype=self.dtype, device=self.device)
            B = torch.zeros((self.num_lanes, self.rank, layer.out_features),
                            dtype=self.dtype, device=self.device)
            kind = _tp_kind(layer)
            self.banks[path] = _Bank(
                path, getattr(layer, "full_in_features", layer.in_features),
                getattr(layer, "full_out_features", layer.out_features), A,
                B, kind, None if kind is None else layer.local_index())
            if kind is None:
                handles.append(
                    layer.register_forward_hook(self._hook(me, path)))
            else:
                # applied by the layer before its gather or reduce
                layer.lora = self._hook(me, path)
                handles.append(_LoraHandle(layer))
        # the hooks leave the model with the pool
        self._unhook = weakref.finalize(self, _remove_hooks, handles)
        self.adapter_ids = torch.zeros(self.num_slots, dtype=torch.int32,
                                       device=self.device)
        # what every hook of a step reads, made once a step from its row
        # ids (``[1]`` prefill, ``[slots]`` decode and verify) by the step
        # bodies around the model call: the rows as gather indices and
        # the ``rows > 0`` select mask; None outside a step (the hooks
        # are then the identity)
        self._idx: Optional[torch.Tensor] = None
        self._keep: Optional[torch.Tensor] = None
        self._registry: Dict[str, int] = {}           # name -> lane
        self._versions: Dict[str, int] = {}           # name -> version
        self._free = list(range(1, self.num_lanes))

    @staticmethod
    def _hook(pool_ref, key: str):
        """The forward hook of target ``key``.  It holds its pool weakly:
        the model outlives an engine, and a pool that is gone (its hooks
        are removed then) leaves the layer as it was."""

        def hook(module, inputs, out):
            pool = pool_ref()
            if pool is None or pool._idx is None:
                return out
            bank, idx = pool.banks[key], pool._idx
            # [b, s, in] @ [b, in, rank] @ [b, rank, out]: the gather takes
            # each row's lane, no more
            delta = torch.bmm(torch.bmm(inputs[0],
                                        bank.A.index_select(0, idx)),
                              bank.B.index_select(0, idx))
            return torch.where(pool._keep, out + delta, out)

        return hook

    # -- registry ----------------------------------------------------------

    @property
    def loaded(self) -> Dict[str, int]:
        """name -> current version, for every loaded adapter."""
        return {n: self._versions[n] for n in self._registry}

    def resolve(self, name: str) -> Tuple[int, int]:
        """``(lane, version)`` of a loaded adapter; KeyError if not."""
        try:
            lane = self._registry[name]
        except KeyError:
            raise KeyError(
                f"adapter {name!r} is not loaded (loaded: "
                f"{sorted(self._registry)})") from None
        return lane, self._versions[name]

    def last_version(self, name: str) -> int:
        """The latest version this pool gave ``name`` (0 if never
        loaded); survives an unload."""
        return self._versions.get(name, 0)

    def salt(self, name: Optional[str]) -> bytes:
        """The prefix-cache tenant salt: ``b""`` for the base model, else
        ``b"name@vN"``."""
        if name is None:
            return b""
        _, version = self.resolve(name)
        return f"{name}@v{version}".encode()

    def _lane_ptrs(self):
        return [(b.A.data_ptr(), b.B.data_ptr()) for b in self.banks.values()]

    def _synced(self, before) -> None:
        """Synchronise the stream the lanes were written on; raise if a
        lane tensor moved."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        if self._lane_ptrs() != before:
            raise RuntimeError("adapter lanes moved in memory; the step "
                               "programs' graphs still read the old "
                               "address")

    @torch.no_grad()
    def load(self, name: str, weights: Dict[str, tuple], *,
             scale: float = 1.0) -> Tuple[int, int]:
        """Load (or hot-swap) adapter ``name`` from ``weights``, a dict
        mapping every target path to its ``(A [in, rank], B [rank, out])``
        pair (numpy arrays or tensors).  ``scale`` is folded into B at
        write time.  Every check runs before the first write.  Returns
        ``(lane, version)``; the version bumps at every load of a name,
        a hot swap included, which retires its old prefix-cache salt."""
        missing = sorted(set(self.banks) - set(weights))
        extra = sorted(set(weights) - set(self.banks))
        if missing or extra:
            raise ValueError(
                f"adapter {name!r} weights do not cover the target set "
                f"(missing={missing[:3]}, unexpected={extra[:3]})")
        factors = {key: tuple(_f32(w) for w in weights[key])
                   for key in self.banks}
        for key, bank in self.banks.items():
            A, B = factors[key]
            want_a = (bank.in_features, self.rank)
            want_b = (self.rank, bank.out_features)
            if tuple(A.shape) != want_a or tuple(B.shape) != want_b:
                raise ValueError(
                    f"adapter {name!r} target {key!r}: want A {want_a} / "
                    f"B {want_b}, got {tuple(A.shape)} / {tuple(B.shape)}")
        if name in self._registry:
            lane = self._registry[name]
        else:
            if not self._free:
                raise RuntimeError(
                    f"adapter pool is full ({self.max_adapters} lanes; "
                    f"loaded: {sorted(self._registry)}): unload one first")
            lane = self._free.pop(0)
        before = self._lane_ptrs()
        for key, bank in self.banks.items():
            A, B = factors[key]
            if bank.kind == "row":
                A = A.index_select(0, bank.index)
            elif bank.kind == "column":
                B = B.index_select(1, bank.index)
            bank.A[lane].copy_(A)
            # scaled in f32, then rounded once to the lane's dtype
            bank.B[lane].copy_(B * float(scale))
        self._synced(before)
        self._registry[name] = lane
        self._versions[name] = self._versions.get(name, 0) + 1
        return lane, self._versions[name]

    @torch.no_grad()
    def unload(self, name: str) -> int:
        """Zero ``name``'s lane (a stale id could only give the base
        model) and free it.  Returns the unloaded version; the name's
        version counter survives for a later load."""
        lane, version = self.resolve(name)
        before = self._lane_ptrs()
        for bank in self.banks.values():
            bank.A[lane].zero_()
            bank.B[lane].zero_()
        self._synced(before)
        del self._registry[name]
        self._free.append(lane)
        self._free.sort()
        return version

    # -- per-slot staging (host, between steps) ----------------------------

    def stage_slot(self, slot: int, name: Optional[str]) -> None:
        """Write one slot's lane id (an admission or a resume).  KeyError
        if ``name`` is not loaded."""
        self.adapter_ids[slot] = 0 if name is None else self.resolve(name)[0]

    def reset_slots(self) -> None:
        """Forget the per-slot ids (warmup scribbles slot 0); the loaded
        banks stay."""
        self.adapter_ids.zero_()

    # -- row binding (inside the step bodies) ------------------------------

    def set_rows(self, rows: torch.Tensor) -> None:
        """Bind the current step's ``[b]`` int32 row ids (lane per row)."""
        self._idx = rows.long()
        self._keep = (rows > 0)[:, None, None]

    def clear_rows(self) -> None:
        self._idx = self._keep = None

    def nbytes(self) -> int:
        return sum(b.A.numel() * b.A.element_size()
                   + b.B.numel() * b.B.element_size()
                   for b in self.banks.values())


def make_lora_weights(pool: AdapterPool, seed: int = 0,
                      init_scale: float = 0.02) -> Dict[str, tuple]:
    """Random adapter weights covering ``pool``'s targets: both factors
    drawn ``N(0, init_scale)`` from ``numpy.random.default_rng(seed)`` in
    the JAX package's order (its targets' order, A then B), so one seed
    gives the same factors in both packages.  Not the B = 0 training
    init: the adapter changes outputs."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, bank in pool.banks.items():
        out[key] = (
            rng.normal(0.0, init_scale,
                       (bank.in_features, pool.rank)).astype(np.float32),
            rng.normal(0.0, init_scale,
                       (pool.rank, bank.out_features)).astype(np.float32),
        )
    return out
