"""A ``to_static`` program: one key's state, and what can be read of it.

The port's counterpart of ``paddle_tpu/jit/trace.py``'s
``CompiledProgram``.  Only ``compiled_stats`` (:373-406) carries over, as
:meth:`_Program.compiled_stats`.  The rest of that module, the
``TraceHook`` that lifts every tensor a traced function reads or writes
into a program input or output, its fixed-point discovery under
``jax.eval_shape`` and the write-back after each call, has no counterpart
here: a port program runs its body eagerly on the tensors themselves and,
on the card, captures that run as a CUDA graph that reads and writes the
same addresses at every replay, so there is no state to thread through a
program's signature.

``compiled_stats`` reports what the port can know without an HLO: the
bytes of the program's arguments and outputs, the bytes its graph's memory
pools hold on the card (the program's own pool and the pools of its
conditional nodes' bodies), and the counts of one eager run of its body
(``obs.cost.analyze_static_fn``: flops, bytes accessed, op counts).  It
has no ``hlo`` (ROADMAP.md C).
"""
from __future__ import annotations

import hashlib
import itertools
from typing import Dict, List, Optional, Tuple

import torch

_program_serials = itertools.count(1)


def _nbytes(ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def pool_bytes(pools) -> int:
    """Bytes the card's caching allocator holds in the graph pools
    ``pools`` (``(device index, pool id)`` pairs)."""
    want = {(int(i), tuple(p)) for i, p in pools}
    total = 0
    for seg in torch.cuda.memory_snapshot():
        key = (int(seg.get("device", 0)), tuple(seg.get("segment_pool_id",
                                                        ())))
        if key in want:
            total += int(seg["total_size"])
    return total


class _Program:
    """One key's program.  On the card: ``calls`` so far, the static input
    buffers, the graph and its output, the kernel launches one replay
    makes, the memory pools of its conditional nodes' bodies, and the
    capture's error if it failed.  ``args`` are the ``(args, kwargs)``
    that :meth:`compiled_stats` runs the body at: its first call's, and on
    the card once captured its static buffers (the last replay's)."""

    def __init__(self, device: Optional[torch.device], key, fn=None):
        self.device = device
        self.serial = next(_program_serials)
        self.digest = hashlib.sha1(repr(key).encode()).hexdigest()[:12]
        self.calls = 0
        self.statics: List[torch.Tensor] = []
        self.graph = None
        self.output = None
        self.launches: Dict[str, int] = {}
        self.error = None
        self.pool: Optional[Tuple[int, int]] = None
        #: the conditional nodes' ``static.nn.Nodes`` (on the card, once
        #: captured)
        self.nodes = None
        #: the NaN/Inf check captured with the graph
        #: (``flags.CapturedCheck``; ``FLAGS_check_nan_inf`` on at capture)
        self.nan_check = None
        self.fn = fn
        self.args: Optional[tuple] = None

    def __del__(self):
        # the conditional nodes' counters and pools go with the graph that
        # uses them
        nodes, self.nodes = getattr(self, "nodes", None), None
        if nodes is not None:
            self.graph = None
            try:
                nodes.release()
            except Exception:     # noqa: BLE001 — an interpreter shutting down
                pass

    def compiled_stats(self) -> dict:
        """What the program costs (module docstring): ``argument_bytes``,
        ``output_bytes``, ``temp_bytes`` (its graph pools on the card, 0
        before a capture and on the CPU), ``peak_bytes`` (their sum) and
        ``cost`` (``flops``, ``bytes_accessed``, ``op_counts`` of one eager
        run of the body at :attr:`args`)."""
        from ..obs.cost import analyze_static_fn
        from .dy2static import _flat

        if self.fn is None or self.calls == 0:
            raise RuntimeError("compiled_stats: the program has not run yet; "
                               "call the function once first")
        args, kwargs = self.args
        ins = [t for t in _flat(self.args)[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in _flat(self.output)[0]
                if isinstance(t, torch.Tensor)]
        temp = 0
        if self.device is not None and self.graph is not None:
            index = self.device.index if self.device.index is not None \
                else torch.cuda.current_device()
            pools = [(index, self.pool)] if self.pool is not None else []
            if self.nodes is not None:
                pools += self.nodes.pools
            temp = pool_bytes(pools)
        rec = analyze_static_fn(self.fn, *args, **kwargs)
        out = {"argument_bytes": _nbytes(ins), "output_bytes": _nbytes(outs),
               "temp_bytes": temp}
        out["peak_bytes"] = (out["argument_bytes"] + out["output_bytes"]
                             + temp)
        out["cost"] = {"flops": rec["flops"],
                       "bytes_accessed": rec["bytes_accessed"],
                       "op_counts": rec["op_counts"]}
        return out
