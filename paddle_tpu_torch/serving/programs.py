"""The engine's step programs: each built once, then reused.

Port of the JAX engine's compiled step programs (``jit.to_static`` and
``Engine._call_counted`` in ``paddle_tpu/serving/engine.py``).  There is
one program per key: ``("prefill", bucket)`` for each prefill bucket and
``("decode",)`` for the decode step.  A program owns static input buffers
on the device, and a call copies its host inputs into them (from pinned
memory, without a host sync).

On a CUDA device a program is a CUDA graph.  The first call of a key runs
the body once eagerly on a side stream (its result is the call's result,
and it readies what a capture must find made: the kernel libraries, the
cuBLAS workspace, K4's merge tickets for that stream), then captures the
body into a graph under ``no_grad`` and counts a **miss**.  A later call
copies its inputs in, replays the graph and counts a **hit**.  On the CPU
PyTorch has no graphs: a program runs its body, the first call of a key
counting a miss and later calls hits.  A failed capture raises; no path
on the card runs a step eagerly after its first call.

What a body writes in place (the KV cache, the block tables' reads, the
sampler's lanes) a replay writes again at the addresses it had at
capture, so that state is never reallocated.  A body's host side effects
happen at capture only.  The kernels' launch counts are such an effect:
the capture's launches are taken back (it launched nothing) and added
again at every replay, so the counts stay per device launch; so are the
collectives a tensor-parallel model issues (``mp_layers.COLLECTIVES``).
A sharded engine's graphs hold its NCCL collectives: the eager first
run of each body issues the same collectives before its capture, which
readies the communicator, and every rank captures the same programs in
the same order.

All the programs of one registry share one graph memory pool.  They never
run at once, but one program's replay may overwrite the memory that holds
another's output: the caller reads each program's output (``int(tok)``,
``out.cpu()``) before it runs the next program.

Every registry on a device captures on the same side stream, and what a
stream collects for good (its cuBLAS workspace, 32 MiB on Hopper; K4's
merge tickets) is then made once a device: a stream of its own per
registry left both behind each engine a fleet rebuilt.  The graphs of
every registry on a device therefore share K4's tickets, and two of their
replays must never run at once: programs of different registries run on
one stream (the device then runs them in turn), or each after the
other's has ended.  :meth:`StepPrograms.run` holds to that rule: it
raises when the last program run on the device belongs to another
registry, was run on another stream and has not ended yet.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..distributed.fleet.meta_parallel import mp_layers
from ..ops import kernels

__all__ = ["StepPrograms"]

#: the capture stream of each device, shared by every registry on it
_capture_streams: Dict[int, "torch.cuda.Stream"] = {}
#: per device, the last program run there: its registry's event, recorded
#: after it, and the stream it ran on
_last_run: Dict[int, Tuple["torch.cuda.Event", int]] = {}


def _device_index(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    index = _device_index(device)
    if index not in _capture_streams:
        _capture_streams[index] = torch.cuda.Stream(index)
    return _capture_streams[index]


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    """The collectives issued since ``before`` was read, by kind."""
    after = mp_layers.collective_counts()
    return {n: after[n] - before[n] for n in after if after[n] != before[n]}


class _Program:
    """One key's static inputs and, on the card, its graph, the graph's
    output and the kernel launches one replay makes; the collectives one
    call issues."""

    def __init__(self, inputs: List[torch.Tensor], graph=None, output=None,
                 launches: Dict[str, int] = None,
                 collectives: Dict[str, int] = None):
        self.inputs = inputs
        self.graph = graph
        self.output = output
        self.launches = launches or {}
        self.collectives = collectives or {}


class StepPrograms:
    """The registry of one engine's step programs.

    ``on_compile(miss)`` is told of every call: ``True`` for the first
    call of a key (a capture on the card), ``False`` for the others.  On
    the card, a call raises ``RuntimeError`` while another registry's
    program still runs on another stream of the device (the module's
    rule)."""

    def __init__(self, device, on_compile: Callable[[bool], None]):
        self.device = torch.device(device)
        self._on_compile = on_compile
        self._programs: Dict[Tuple, _Program] = {}
        #: the key of the last program called: what a stalled step was
        #: running, in the step watchdog's report
        self.last_key: Optional[Tuple] = None
        if self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = _capture_stream(self.device)
            self._index = _device_index(self.device)
            self._done = torch.cuda.Event()

    def keys(self) -> List[Tuple]:
        return list(self._programs)

    def clear(self) -> None:
        """Drop every program: its graph, its static buffers and its
        output.  Once no graph of the pool is left, the pool's memory
        goes back to the allocator."""
        self._programs.clear()
        self.last_key = None

    def __contains__(self, key: Tuple) -> bool:
        """Whether program ``key`` is built (its next call replays)."""
        return key in self._programs

    def run(self, key: Tuple, body: Callable[..., torch.Tensor],
            *inputs: np.ndarray) -> torch.Tensor:
        """Run the program ``key`` on ``inputs`` (host arrays, copied into
        its static buffers; their shapes and dtypes belong to the key).
        ``body`` maps the device buffers to one output tensor; it is run
        or captured only at the key's first call.  Returns the output,
        valid until the next program of this registry runs."""
        self.last_key = key
        on_card = self.device.type == "cuda"
        if on_card:
            stream = self._claim_device()
        prog = self._programs.get(key)
        if prog is None:
            statics = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                   device=self.device) for a in inputs]
            self._copy_in(statics, inputs)
            if on_card:
                prog, out = self._capture(body, statics)
                self._ran_on(stream)
            else:
                before = mp_layers.collective_counts()
                out = body(*statics)
                prog = _Program(statics, collectives=_delta(before))
            self._programs[key] = prog
            self._on_compile(True)
            return out
        self._copy_in(prog.inputs, inputs)
        if prog.graph is None:
            out = body(*prog.inputs)
        else:
            prog.graph.replay()
            self._ran_on(stream)
            kernels.add_launches(prog.launches)
            mp_layers.add_collectives(prog.collectives)
            out = prog.output
        self._on_compile(False)
        return out

    def _claim_device(self) -> "torch.cuda.Stream":
        """The current stream, once no other registry's program can still
        be running beside a program of this one (the module's rule)."""
        stream = torch.cuda.current_stream(self.device)
        last = _last_run.get(self._index)
        if (last is not None and last[0] is not self._done
                and last[1] != stream.cuda_stream and not last[0].query()):
            raise RuntimeError(
                f"a step program of another engine on cuda:{self._index} "
                "is still running on another stream; engines on one "
                "device share K4's merge tickets, so their programs run "
                "on one stream or one after the other")
        return stream

    def _ran_on(self, stream: "torch.cuda.Stream") -> None:
        self._done.record(stream)
        _last_run[self._index] = (self._done, stream.cuda_stream)

    @staticmethod
    def _copy_in(statics: List[torch.Tensor], inputs) -> None:
        for dst, a in zip(statics, inputs):
            src = torch.from_numpy(np.ascontiguousarray(a))
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(f"program input {src.dtype} "
                                 f"{tuple(src.shape)} does not match its "
                                 f"buffer {dst.dtype} {tuple(dst.shape)}")
            if dst.is_cuda:
                # a pinned block is reused only once its copy has run
                src = src.pin_memory()
            dst.copy_(src, non_blocking=True)

    def _capture(self, body, statics):
        """Run ``body`` eagerly on the side stream, then capture it there
        into a graph of the shared pool.  Returns the program and the
        eager run's output."""
        side, cur = self._stream, torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = body(*statics)
        cur.wait_stream(side)
        out.record_stream(cur)
        before = kernels.launch_counts()
        coll_before = mp_layers.collective_counts()
        graph = torch.cuda.CUDAGraph()
        # the cyclic collector must not run inside a capture: freeing an
        # unreachable engine's graphs there invalidates it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.no_grad(), torch.cuda.graph(graph, pool=self._pool,
                                                   stream=side):
                output = body(*statics)
        finally:
            if collecting:
                gc.enable()
        after = kernels.launch_counts()
        launches = {n: after[n] - before[n] for n in after
                    if after[n] != before[n]}
        # the capture launched nothing: its counts move to the replays
        kernels.add_launches({n: -c for n, c in launches.items()})
        collectives = _delta(coll_before)
        mp_layers.add_collectives({n: -c for n, c in collectives.items()})
        return _Program(statics, graph, output, launches, collectives), out
