"""Cost ledger: what one train step costs, counted from one eager run.

The port's counterpart of ``paddle_tpu/obs/hlo_cost.py``'s
``CostLedger``, ``chip_spec`` and ``analyze_static_fn``.  The JAX package
asks XLA's cost analysis of a compiled program; the port has no HLO, so
:func:`analyze_static_fn` runs the ``jit.to_static`` function's body once,
eagerly, at the given arguments (the program's arg specs) and counts:

- **flops** with ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  convolutions: the ops it has formulas for);
- **bytes** as the inputs plus the outputs of each dispatched op (a
  ``TorchDispatchMode``; view ops move nothing and are skipped);
- **op counts**: ``dot`` for ``mm``/``addmm``/``bmm``/``baddbmm``,
  ``convolution``, the collectives, and ``flash_attention`` per K1/K2/K3
  call;
- a **fingerprint**: a digest over the op sequence with its shapes,
  stable run to run, moved by any change of the step's ops or shapes.

**Attention is counted by formula.**  The port's attention kernels reach
torch through ``ctypes`` (K1 also as the registered op
``paddle_tpu_torch::flash_fwd``) and K2/K3 run inside an
``autograd.Function``, so neither ``FlopCounterMode`` nor the dispatch
mode sees them on the card, while on the CPU they would see the plain
versions' ops.  Each call is therefore counted by
:func:`attention_cost`, the formula ``chip_smoke.py``'s kernel bounds read
too: K1 ``4·H·D`` flops per (query, key) pair of the causal triangle, K2
``8·H·D``, K3 ``6·H·D``, and the kernels' own input and output bytes;
whatever the plain versions dispatched on the CPU is taken out.  Records say so (``"attention": "formula"``).  Without this
a 345M step would read about 10 % under the 6ND count.

The run must leave the program and the training state as they were: it
calls the function's body directly (no program is looked up or built)
under a guard that saves every tensor that existed before the run the
first time an op writes to it, and writes the saved values back after
(parameters, masters, moments, the generator's offset, the sentry's
state, the scaler's).  On the card the run launches the step's kernels,
and those launches are counted as any other.  Analyze a
step after its first call, when its optimizer state exists (as the JAX
package analyzes a warm program), and one whose body clears the
gradients it makes, as a train step does.

:func:`chip_spec` knows the H100 (989e12 bf16 flop/s dense, 3.35e12 B/s
of HBM3), the default, and raises on any other name.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["CostLedger", "analyze_static_fn", "chip_spec", "CHIP_SPECS",
           "attention_cost"]

#: per-chip (peak dense bf16 flop/s, memory bytes/s) for the roofline
CHIP_SPECS: Dict[str, Tuple[float, float]] = {
    "h100": (989e12, 3.35e12),
}

_DOT_OPS = ("mm", "addmm", "bmm", "baddbmm")
_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
                "broadcast")


def chip_spec(chip: str = "h100") -> Tuple[str, float, float]:
    """``(name, peak_flops, bytes_per_s)`` of ``chip``."""
    name = chip.lower()
    if name not in CHIP_SPECS:
        raise ValueError(f"unknown chip {name!r}: expected one of "
                         f"{sorted(CHIP_SPECS)}")
    peak, bw = CHIP_SPECS[name]
    return name, peak, bw


def attention_cost(kind: str, q: torch.Tensor, causal: bool) -> Tuple[
        float, float]:
    """``(flops, bytes)`` of one K1 (``"fwd"``), K2 (``"bwd_dkv"``) or K3
    (``"bwd_dq"``) call on ``[B, S, H, D]`` queries: each (query, key)
    pair costs ``4·H·D``, ``8·H·D`` or ``6·H·D`` flops; the bytes are the
    kernel's inputs and outputs, each once."""
    B, S, H, D = q.shape
    isz = q.element_size()
    pairs = B * (S * (S + 1) // 2 if causal else S * S)
    if kind == "fwd":
        return 4.0 * H * D * pairs, float(4 * B * S * H * D * isz
                                          + B * H * S * 4)
    n_out, per_pair = (2, 8 * D) if kind == "bwd_dkv" else (1, 6 * D)
    return (float(per_pair * H * pairs),
            float((4 + n_out) * B * S * H * D * isz + 2 * B * H * S * 4))


def _written(func, args, kwargs) -> List[torch.Tensor]:
    """The tensors an op writes in place (its schema's mutable
    arguments)."""
    out = []
    schema = getattr(func, "_schema", None)
    if schema is None or not schema.is_mutable:
        return out
    for i, a in enumerate(schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = kwargs.get(a.name) if a.name in kwargs else \
            (args[i] if i < len(args) else None)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _is_view(func) -> bool:
    schema = getattr(func, "_schema", None)
    return schema is not None and any(
        r.alias_info is not None and not r.alias_info.is_write
        for r in schema.returns)


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """Bytes, op counts, the op sequence and the undo log of one run."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.counts: Dict[str, int] = {}
        self.sequence = hashlib.sha256()
        self.undo: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._saved = set()
        self._fresh = set()
        self.muted = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in _written(func, args, kwargs):
            ptr = t.untyped_storage().data_ptr()
            key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()))
            if ptr not in self._fresh and key not in self._saved:
                self._saved.add(key)
                self.undo.append((t, t.detach().clone()))
        out = func(*args, **kwargs)
        view = _is_view(func)
        if not view and not func._schema.is_mutable:
            # a new tensor: its later writes need no saving
            for t in _tensors(out):
                if t.device.type != "meta":
                    self._fresh.add(t.untyped_storage().data_ptr())
        if self.muted:
            return out
        name = func.overloadpacket.__name__
        if not view:
            self.bytes += sum(_nbytes(t) for t in _tensors(args)
                              + _tensors(kwargs) + _tensors(out))
        op = "dot" if name in _DOT_OPS else \
            "convolution" if name.startswith("convolution") else \
            next((c for c in _COLLECTIVES if c in name.replace(
                "allreduce", "all_reduce").replace(
                "allgather", "all_gather")), None)
        if op is not None:
            self.counts[op] = self.counts.get(op, 0) + 1
        shapes = ";".join(",".join(map(str, t.shape))
                          for t in _tensors(args))
        self.sequence.update(f"{name}({shapes})\n".encode())
        return out


class _AttentionProbe:
    """Hooked into ``ops.attention`` for one analysis: counts each K1, K2
    and K3 call by formula and mutes what its plain version dispatches."""

    def __init__(self, counter: _Counter, flops: FlopCounterMode):
        self.counter = counter
        self.flop_mode = flops
        self.flops = 0.0
        self.bytes = 0.0
        self.calls = 0
        self.excluded = 0
        self._start: List[int] = []

    def begin(self) -> None:
        self.counter.muted += 1
        self._start.append(self.flop_mode.get_total_flops())

    def end(self, kinds, q: torch.Tensor, causal: bool) -> None:
        self.counter.muted -= 1
        self.excluded += self.flop_mode.get_total_flops() - self._start.pop()
        for kind in kinds:
            f, b = attention_cost(kind, q, causal)
            self.flops += f
            self.bytes += b
            self.calls += 1
            self.counter.counts["flash_attention"] = \
                self.counter.counts.get("flash_attention", 0) + 1
            self.counter.sequence.update(
                f"flash_{kind}({','.join(map(str, q.shape))})\n".encode())


def _roofline(flops: float, nbytes: float, chip: str) -> dict:
    name, peak, bw = chip_spec(chip)
    t_compute = flops / peak
    t_memory = nbytes / bw if nbytes else 0.0
    t_step = max(t_compute, t_memory) or 1e-30
    return {
        "chip": name,
        "arithmetic_intensity": round(flops / max(nbytes, 1.0), 3),
        "ridge_intensity": round(peak / bw, 3),
        "bound": "compute" if t_compute >= t_memory else "memory",
        "roofline_step_ms": round(t_step * 1e3, 6),
        "analytic_mfu": round(t_compute / t_step, 6),
    }


def analyze_static_fn(static_fn, *args, chip: str = "h100",
                      **kwargs) -> dict:
    """Count one eager run of ``static_fn``'s body at ``args`` (module
    docstring).  ``static_fn`` is a ``jit.to_static`` function (its body
    runs, no program is touched) or a plain callable.  Returns the record
    :class:`CostLedger` keeps: flops, bytes, op counts, fingerprint and
    the roofline on ``chip``."""
    from ..ops import attention

    fn = getattr(static_fn, "_fn", static_fn)
    counter = _Counter()
    flops = FlopCounterMode(display=False)
    probe = _AttentionProbe(counter, flops)
    prev_probe = attention._cost_probe
    attention._cost_probe = probe
    try:
        with flops, counter:
            fn(*args, **kwargs)
    finally:
        attention._cost_probe = prev_probe
        with torch.no_grad():
            for dst, saved in reversed(counter.undo):
                dst.copy_(saved)
        if any(t.is_cuda for t, _ in counter.undo):
            torch.cuda.synchronize()
    counted = float(flops.get_total_flops() - probe.excluded)
    total_flops = counted + probe.flops
    nbytes = float(counter.bytes) + probe.bytes
    rec = {
        "flops": total_flops,
        "bytes_accessed": nbytes,
        "attention": "formula",
        "attention_flops": probe.flops,
        "attention_calls": probe.calls,
        "op_counts": dict(sorted(counter.counts.items())),
        "fingerprint": counter.sequence.hexdigest()[:16],
        "restored_tensors": len(counter.undo),
        **_roofline(total_flops, nbytes, chip),
    }
    return rec


class CostLedger:
    """Per-program cost ledger.

    ``add(name, static_fn, *args)`` analyzes one step and keeps the record
    under ``name``; ``tokens_per_step`` and ``n_params`` add the 6ND
    cross-check, ``flops_vs_6nd``: the counted flops over ``6 · n_params ·
    tokens`` (above 1 by attention's share, about 10 % at GPT-2 345M and
    S 1024).  :meth:`fingerprint` digests every program's fingerprint.
    """

    def __init__(self, chip: str = "h100"):
        self.chip = chip_spec(chip)[0]
        self.programs: Dict[str, dict] = {}

    def add(self, name: str, static_fn, *args,
            tokens_per_step: Optional[int] = None,
            n_params: Optional[int] = None) -> dict:
        rec = analyze_static_fn(static_fn, *args, chip=self.chip)
        if tokens_per_step and n_params:
            model_flops = 6.0 * float(n_params) * float(tokens_per_step)
            rec["model_flops_6nd"] = model_flops
            rec["flops_vs_6nd"] = round(rec["flops"] / model_flops, 4)
        self.programs[name] = rec
        return rec

    def fingerprint(self) -> str:
        """Digest over every program's fingerprint (sorted by name)."""
        h = hashlib.sha256()
        for name in sorted(self.programs):
            h.update(f"{name}={self.programs[name]['fingerprint']}\n"
                     .encode())
        return h.hexdigest()[:16]

    def analytic_mfu(self, name: Optional[str] = None) -> float:
        """The named program's analytic MFU (default ``train_step`` if
        present, else the only program, else 0.0)."""
        if name is None:
            name = "train_step" if "train_step" in self.programs else \
                (next(iter(self.programs)) if self.programs else None)
        if name is None:
            return 0.0
        return float(self.programs[name]["analytic_mfu"])

    def stats(self) -> dict:
        """JSON-ready snapshot (the ``profiler.train_stats()`` surface)."""
        progs = {}
        for name, r in self.programs.items():
            progs[name] = {k: r[k] for k in
                           ("flops", "bytes_accessed", "attention_flops",
                            "arithmetic_intensity", "analytic_mfu",
                            "roofline_step_ms")}
            progs[name]["op_counts"] = dict(r["op_counts"])
            if "flops_vs_6nd" in r:
                progs[name]["flops_vs_6nd"] = r["flops_vs_6nd"]
        return {"chip": self.chip, "programs": progs,
                "fingerprint": self.fingerprint(),
                "analytic_mfu": self.analytic_mfu()}
