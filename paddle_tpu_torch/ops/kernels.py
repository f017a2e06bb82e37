"""Build, load and launch the hand-written CUDA kernels (``csrc/``).

Each source under ``paddle_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, on first use,
into ``paddle_tpu_torch/_build/`` (named by a hash of the sources and
flags, so an edited source rebuilds).  The libraries are loaded with
``ctypes``; every launch goes onto PyTorch's current stream and the
wrapper raises if ``cudaGetLastError()`` reports anything.

The wrappers here take CUDA tensors only and raise on anything their
kernel does not take (device, dtype, shape, strides): the choice between a
kernel and its plain PyTorch version is made one level up, by the device
of the tensors (``ops.cached_attention``, ``ops.attention``).  Each
wrapper counts its launches in :data:`KERNELS`, so a run can show that it
went through the kernel; K1-K3 with attention dropout launch their
dropout instances and count them under ``<name>_dropout``, and every
kernel on float16 tensors counts its f16 instance under ``<name>_f16``
(K1-K3 with dropout: ``<name>_dropout_f16``).  All five take float32,
bfloat16 and float16.

The wrappers can be captured into a CUDA graph (``serving.programs``):
they read nothing back from the device, allocate their outputs and
scratch with ``torch.empty`` and make their one launch on the current
stream; K5 reads its ``start`` from device memory, K1-K3's dropout
instances their draw's seed and offset, and K4's merge tickets are made
outside any capture.  A count is taken on the host, so a
capture counts its launches once and a replay none: the program that
replays a graph adds the launches its capture made (``add_launches``).
The launches inside a conditional node's body (``graph_control.cu``, the
IF and WHILE nodes of ``static.nn``) count once a run of the body: its
node keeps a device counter of runs, and :func:`launch_counts` reads the
counters of the graphs still alive (a synchronization) when there are any.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["KERNELS", "build", "reset_launches", "launch_counts",
           "add_launches", "paged_decode", "paged_prefill", "flash_fwd",
           "flash_bwd_dkv", "flash_bwd_dq", "graph_stream",
           "graph_node_begin", "graph_node_end", "count_per_run",
           "decode_plan", "DecodePlan", "HEAD_DIMS", "MAX_GROUP",
           "DECODE_SPLIT_KEYS", "DECODE_GRID_BLOCKS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: head dims each kernel is instantiated for
HEAD_DIMS = (64, 128)
#: query heads per kv head one decode block holds (kMaxGroup in the source)
MAX_GROUP = 8
#: positions of a slot's window in one K4 split, for a query group of one
#: (half that for larger groups, whose blocks are bound by latency more
#: than bytes); the source takes at most kMaxSplitKeys, also 512
DECODE_SPLIT_KEYS = 512
#: K4's grid holds about this many blocks at most (slots x kv heads x
#: grid_splits); past it each block walks several splits
DECODE_GRID_BLOCKS = 2048
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the dtypes of K4/K5 (paged) and of K1-K3 (flash)
PAGED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
FLASH_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: the dtypes whose instances run on tensor cores and copy 16-byte rows
_TC_DTYPES = (torch.bfloat16, torch.float16)

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_LOG2E = 1.4426950408889634

# library -> (source, {C function: argtypes})
_LIBRARIES = {
    "paged_attention": ("paged_attention.cu", {
        "pt_paged_decode": [_I, _I] + [_P] * 9 + [_I] * 8 + [_L] * 8
                           + [_F, _P],
        "pt_paged_prefill": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _L, _L, _L, _L, _L, _L, _L, _F, _P],
        "pt_paged_error_string": [_I],
    }),
    "flash_attention_fwd": ("flash_attention_fwd.cu", {
        "pt_flash_fwd": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I]
                        + [_L] * 12 + [_F, _P, _I, _L, _F, _P],
        "pt_flash_error_string": [_I],
    }),
    "flash_attention_bwd": ("flash_attention_bwd.cu", {
        "pt_flash_bwd_dkv": [_I, _I] + [_P] * 8 + [_I] * 4 + [_L] * 18
                            + [_F, _P, _I, _L, _F, _P],
        "pt_flash_bwd_dq": [_I, _I] + [_P] * 7 + [_I] * 4 + [_L] * 15
                           + [_F, _P, _I, _L, _F, _P],
        "pt_flash_bwd_error_string": [_I],
    }),
    "graph_control": ("graph_control.cu", {
        "pt_graph_stream_create": [_P],
        "pt_graph_node_begin": [_P, _P, _I, _P, _I, _P, _P],
        "pt_graph_node_end": [_P, _I, ctypes.c_ulonglong, _P, _P],
        "pt_graph_error_string": [_I],
    }),
}


@dataclass
class KernelInfo:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times its wrapper launched it in this process."""

    name: str
    source: str
    replaces: str
    launches: int = 0


KERNELS: Dict[str, KernelInfo] = {
    "paged_decode": KernelInfo(
        "paged_decode", "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/ops/pallas/paged_attention_kernel.py:110"),
    "paged_prefill": KernelInfo(
        "paged_prefill", "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/ops/pallas/paged_attention_kernel.py:210"),
    "flash_fwd": KernelInfo(
        "flash_fwd", "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "paddle_tpu/ops/pallas/flash_attention_kernel.py:128"),
    "flash_bwd_dkv": KernelInfo(
        "flash_bwd_dkv", "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/flash_attention_kernel.py:170"),
    "flash_bwd_dq": KernelInfo(
        "flash_bwd_dq", "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/flash_attention_kernel.py:210"),
    # K1-K3 with attention dropout (the Pallas kernels take p == 0 only;
    # they replace the same functions)
    "flash_fwd_dropout": KernelInfo(
        "flash_fwd_dropout", "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "paddle_tpu/ops/pallas/flash_attention_kernel.py:128"),
    "flash_bwd_dkv_dropout": KernelInfo(
        "flash_bwd_dkv_dropout",
        "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/flash_attention_kernel.py:170"),
    "flash_bwd_dq_dropout": KernelInfo(
        "flash_bwd_dq_dropout",
        "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/flash_attention_kernel.py:210"),
}
# the float16 instances of K1-K5, K1-K3 at p == 0 and with dropout alike
# (the Pallas kernels are dtype-generic; they replace the same functions)
for _name in list(KERNELS):
    KERNELS[_name + "_f16"] = KernelInfo(
        _name + "_f16", KERNELS[_name].source, KERNELS[_name].replaces)
del _name
# the conditional nodes' one-thread kernel (IF and WHILE alike): it sets a
# node's condition from a device bool; it replaces no Pallas kernel, but the
# lax.cond / lax.while_loop the JAX package lowers a tensor branch or loop to
KERNELS["graph_conditional"] = KernelInfo(
    "graph_conditional", "paddle_tpu_torch/csrc/graph_control.cu",
    "paddle_tpu/static/nn.py:217")

_loaded: Dict[str, ctypes.CDLL] = {}


# what holds the launches of conditional node bodies (``static.nn.Nodes``,
# one per captured graph), held weakly: each has a ``per_run`` list of
# [counts one run of a body makes, its device int64 counter of runs, the
# runs already counted], and goes with its graph
_per_run_sources: "weakref.WeakSet" = weakref.WeakSet()


def count_per_run(source) -> None:
    """Count the launches ``source.per_run`` lists once for every run of
    their bodies, as their device counters tell: read when the counts are
    next asked for outside a capture, while ``source`` lives."""
    _per_run_sources.add(source)


def _fold_per_run() -> None:
    sources = [s for s in list(_per_run_sources) if s.per_run]
    if not sources or torch.cuda.is_current_stream_capturing():
        return
    torch.cuda.synchronize()
    for source in sources:
        seen = torch.stack([e[1].reshape(()) for e in source.per_run]
                           ).tolist()
        for entry, n in zip(source.per_run, seen):
            for name, c in entry[0].items():
                KERNELS[name].launches += c * (n - entry[2])
            entry[2] = n


def reset_launches() -> None:
    _fold_per_run()
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    _fold_per_run()
    return {n: k.launches for n, k in KERNELS.items()}


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (by kernel name) to the launch counts: a replayed
    graph's launches, which no wrapper call counts."""
    for n, c in counts.items():
        KERNELS[n].launches += c


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source on first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):       # sources and shared headers
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Compile the named libraries (default: all) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns per library
    ``{"path", "seconds", "cached", "ptxas"}`` (``ptxas``: the compiler's
    register/shared-memory report, kept beside the library so that a
    cached build reports it too).  Raises with the compiler's output if
    any build fails."""
    names = list(names or _LIBRARIES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            report = path.with_suffix(".ptxas.txt")
            out[name] = {"path": str(path), "seconds": 0.0, "cached": True,
                         "ptxas": report.read_text() if report.exists()
                         else ""}
            continue
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / _LIBRARIES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc rc {proc.returncode}) ---\n{log}")
            continue
        path.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, path)
        out[name] = {"path": str(path), "seconds": round(secs, 3),
                     "cached": False, "ptxas": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def _library(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]["path"]
        lib = ctypes.CDLL(path)
        for fn, argtypes in _LIBRARIES[name][1].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_char_p if fn.endswith("error_string") \
                else ctypes.c_int
        _loaded[name] = lib
    return lib


# -- argument checks -------------------------------------------------------

def _require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_common(what: str, q: torch.Tensor, *others: torch.Tensor,
                  dtypes=PAGED_DTYPES) -> int:
    _require(q.is_cuda, what, f"the kernel takes CUDA tensors, got "
             f"{q.device}")
    for t in others:
        _require(t.device == q.device, what,
                 f"tensors on {q.device} and {t.device}")
    _require(q.dtype in dtypes, what,
             f"dtype {q.dtype} (want one of {dtypes})")
    D = q.shape[-1]
    _require(D in HEAD_DIMS, what, f"head_dim {D} (want one of "
             f"{HEAD_DIMS})")
    _require(q.stride(-1) == 1, what, "the head dim of q must be contiguous")
    return D


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, lib: ctypes.CDLL, err_fn: str, what: str) -> None:
    if rc == -1:
        raise ValueError(f"{what}: no kernel instance for these arguments")
    if rc != 0:
        msg = getattr(lib, err_fn)(rc).decode()
        raise RuntimeError(f"{what}: launch failed with CUDA error {rc} "
                           f"({msg})")


def _check_pool(what: str, q, k_pool, v_pool, D: int):
    _require(k_pool.dim() == 4 and v_pool.shape == k_pool.shape, what,
             f"pools {tuple(k_pool.shape)} / {tuple(v_pool.shape)} (want "
             f"[num_blocks, block_size, Hkv, D] each)")
    _require(k_pool.shape[-1] == D, what, "pool head_dim != query head_dim")
    _require(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype, what,
             "pools and query differ in dtype")
    _require(k_pool.stride() == v_pool.stride(), what,
             "K and V pools must share their strides")
    _require(k_pool.stride(-1) == 1, what, "pool head dim must be "
             "contiguous")
    H, Hkv = q.shape[2], k_pool.shape[2]
    _require(H % Hkv == 0, what, f"{H} query heads over {Hkv} kv heads")
    return H, Hkv


def _check_rows16(what: str, *tensors: torch.Tensor,
                  dtypes=_TC_DTYPES) -> None:
    """The 16-bit tensor-core kernels (K1, K5, K2, K3), and K4 in both
    its dtypes, copy rows in 16-byte pieces: every row of each operand of
    a dtype in ``dtypes`` must start 16-byte aligned."""
    for t in tensors:
        if t.dtype not in dtypes:
            continue
        isz = t.element_size()
        strides = [s * isz for s, n in zip(t.stride()[:-1], t.shape[:-1])
                   if n > 1]
        _require(t.data_ptr() % 16 == 0 and all(s % 16 == 0
                                                for s in strides), what,
                 f"{t.dtype} rows must start 16-byte aligned for the "
                 f"kernel's 16-byte copies, got address {t.data_ptr()} and "
                 f"strides {tuple(t.stride())} (elements)")


def _check_index(what: str, t: torch.Tensor, dim: int, name: str) -> None:
    _require(t.dtype == torch.int32 and t.dim() == dim, what,
             f"{name} must be int32 with {dim} dim(s), got {t.dtype} "
             f"{tuple(t.shape)}")
    _require(t.stride(-1) == 1, what, f"{name} must be contiguous in its "
             f"last dim")


# -- wrappers --------------------------------------------------------------

@dataclass(frozen=True)
class DecodePlan:
    """K4's launch, from the shapes alone (never from the lengths' values,
    so the wrapper does not sync with the host): a slot's window of
    ``max_blocks * block_size`` positions is cut into ``splits`` runs of
    ``split_keys``; the grid is ``(grid_splits, kv heads, slots)``, block
    ``x`` walking splits ``x, x + grid_splits, ...`` of its (slot, kv
    head)'s live window.  When a window spans several splits each writes its partial
    softmax state to f32 scratch (``partial_shape``: the unnormalised acc,
    ``ml_shape``: m and l), and one int32 ticket per (slot, kv head) finds
    the block that merges them."""

    split_keys: int
    splits: int
    grid_splits: int
    partial_shape: Tuple[int, int, int, int]
    ml_shape: Tuple[int, int, int, int]
    tickets: int


def decode_plan(batch: int, heads: int, kv_heads: int, head_dim: int,
                max_blocks: int, block_size: int) -> DecodePlan:
    """K4's plan: splits of :data:`DECODE_SPLIT_KEYS` positions (half that
    for groups past one), and the grid capped near
    :data:`DECODE_GRID_BLOCKS` blocks."""
    split_keys = (DECODE_SPLIT_KEYS if heads == kv_heads
                  else DECODE_SPLIT_KEYS // 2)
    splits = max(1, -(-max_blocks * block_size // split_keys))
    grid_splits = min(splits, -(-DECODE_GRID_BLOCKS // (batch * kv_heads)))
    return DecodePlan(split_keys, splits, grid_splits,
                      (batch, heads, splits, head_dim),
                      (batch, heads, splits, 2), batch * kv_heads)


# (device, stream) -> K4's int32 tickets: 0 before and after every launch
# (the merging block resets its own), so they are zeroed once per stream
# and again only when a launch needs more.  A buffer is never freed: a
# CUDA graph that captured a launch keeps its address, so one outgrown by
# a later launch stays alive in _retired_tickets.
_decode_tickets: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_retired_tickets: List[torch.Tensor] = []


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    t = _decode_tickets.get((device, stream))
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            # made here, they would come from the graph's private pool and
            # be zeroed only at capture; the launch before a capture, on
            # the capture stream, makes them
            raise RuntimeError(
                "paged_decode: no merge tickets for this stream yet; launch "
                "the kernel once on the capture stream before capturing it")
        if t is not None:
            _retired_tickets.append(t)
        t = torch.zeros(n, dtype=torch.int32, device=device)
        _decode_tickets[(device, stream)] = t
    return t


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_tables: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """K4: one decode step per slot straight off the block pool.

    ``q`` ``[B, 1, H, D]``; pools ``[num_blocks, block_size, Hkv, D]``
    (a strided one-layer view of the multi-layer pool is taken as is);
    ``block_tables`` ``[B, max_blocks]`` int32; ``lengths`` ``[B]`` int32,
    the window being ``0..lengths[b]``.  Returns ``[B, 1, H, D]``.  The
    kernel copies rows in 16-byte pieces, so q's and the pools' rows must
    start 16-byte aligned (:func:`_check_rows16`).  The split-K launch
    comes from :func:`decode_plan`.  One device launch; a float16 launch
    counts as ``paged_decode_f16``."""
    what = "paged_decode"
    D = _check_common(what, q, k_pool, v_pool, block_tables, lengths)
    _require(q.dim() == 4 and q.shape[1] == 1, what,
             f"q {tuple(q.shape)} (want [B, 1, H, D])")
    H, Hkv = _check_pool(what, q, k_pool, v_pool, D)
    _require(H // Hkv <= MAX_GROUP, what, f"group of {H // Hkv} query "
             f"heads per kv head (max {MAX_GROUP})")
    B = q.shape[0]
    _check_index(what, block_tables, 2, "block_tables")
    _check_index(what, lengths, 1, "lengths")
    _require(block_tables.shape[0] == B and lengths.shape[0] == B, what,
             "block_tables/lengths batch != q batch")
    _check_rows16(what, q, k_pool, v_pool, dtypes=PAGED_DTYPES)
    bs, MB = k_pool.shape[1], block_tables.shape[1]
    plan = decode_plan(B, H, Hkv, D, MB, bs)
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    stream = _stream(q)
    part = ml = tickets = None
    if plan.splits > 1:
        part = torch.empty(plan.partial_shape, dtype=torch.float32,
                           device=q.device)
        ml = torch.empty(plan.ml_shape, dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, stream, plan.tickets)
    lib = _library("paged_attention")
    rc = lib.pt_paged_decode(
        _DTYPE_CODE[q.dtype], D, q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), *(None if t is None else t.data_ptr()
                          for t in (part, ml, tickets)),
        B, H, Hkv, bs, MB, plan.split_keys, plan.splits, plan.grid_splits,
        q.stride(0), q.stride(2), out.stride(0), out.stride(2),
        block_tables.stride(0), k_pool.stride(0), k_pool.stride(1),
        k_pool.stride(2), _LOG2E / D ** 0.5, stream)
    _raise_on(rc, lib, "pt_paged_error_string", what)
    KERNELS["paged_decode" + _instance(q, "")].launches += 1
    return out


def paged_prefill(q: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, block_row: torch.Tensor,
                  start: torch.Tensor) -> torch.Tensor:
    """K5: fused cached-prefix + causal-tail prefill off the block pool.

    ``q`` ``[1, S, H, D]`` tail queries at absolute positions
    ``start..start+S-1``; pools as :func:`paged_decode`; ``block_row``
    ``[max_blocks]`` int32, the slot's table row; ``start`` an int32
    tensor of one element on the device, which the kernel reads at entry
    (a negative value counts as 0), so that one CUDA graph of a bucket
    serves every prefix length.  Returns ``[1, S, H, D]``.  bf16 and f16
    run on tensor cores (p rounded to the input dtype before P V) and need
    16-byte aligned rows (:func:`_check_rows16`); f32 runs the CUDA-core
    loop.  A float16 launch counts as ``paged_prefill_f16``."""
    what = "paged_prefill"
    D = _check_common(what, q, k_pool, v_pool, block_row)
    _require(q.dim() == 4 and q.shape[0] == 1, what,
             f"q {tuple(q.shape)} (want [1, S, H, D])")
    H, Hkv = _check_pool(what, q, k_pool, v_pool, D)
    _check_index(what, block_row, 1, "block_row")
    # (the message names the start's type, never its value: formatting a
    # tensor's value reads it back, which a graph capture forbids)
    got = (f"{start.dtype} {tuple(start.shape)} on {start.device}"
           if isinstance(start, torch.Tensor) else type(start).__name__)
    _require(isinstance(start, torch.Tensor) and start.device == q.device
             and start.dtype == torch.int32 and start.numel() == 1, what,
             f"start must be an int32 tensor of one element on {q.device}, "
             f"got {got}")
    _check_rows16(what, q, k_pool, v_pool)
    S = q.shape[1]
    out = torch.empty((1, S, H, D), dtype=q.dtype, device=q.device)
    lib = _library("paged_attention")
    rc = lib.pt_paged_prefill(
        _DTYPE_CODE[q.dtype], D, q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_row.data_ptr(), start.data_ptr(),
        out.data_ptr(), S, H, Hkv, k_pool.shape[1], block_row.shape[0],
        q.stride(1), q.stride(2),
        out.stride(1), out.stride(2), k_pool.stride(0), k_pool.stride(1),
        k_pool.stride(2), 1.0 / D ** 0.5, _stream(q))
    _raise_on(rc, lib, "pt_paged_error_string", what)
    KERNELS["paged_prefill" + _instance(q, "")].launches += 1
    return out


def _check_dense(what: str, q: torch.Tensor, *others: torch.Tensor) -> int:
    """Equal ``[B, S, H, D]`` tensors of one dtype of
    :data:`FLASH_DTYPES`, head dims contiguous (any other strides are read
    as they are)."""
    D = _check_common(what, q, *others, dtypes=FLASH_DTYPES)
    _require(q.dim() == 4 and all(t.shape == q.shape for t in others), what,
             f"shapes {[tuple(t.shape) for t in (q, *others)]} (want equal "
             f"[B, S, H, D])")
    _require(all(t.dtype == q.dtype for t in others), what,
             "the tensors differ in dtype")
    _require(all(t.stride(-1) == 1 for t in others), what,
             "every head dim must be contiguous")
    return D


def _check_rows(what: str, q: torch.Tensor, *rows: torch.Tensor) -> None:
    """lse / delta: contiguous f32 ``[B*H, S]``, row ``b*H + h``."""
    B, S, H, _ = q.shape
    for t in rows:
        _require(t.dtype == torch.float32 and tuple(t.shape) == (B * H, S)
                 and t.is_contiguous() and t.device == q.device, what,
                 f"lse/delta must be contiguous float32 [B*H, S] = "
                 f"[{B * H}, {S}] on {q.device}, got {t.dtype} "
                 f"{tuple(t.shape)}")


def _instance(q: torch.Tensor, suffix: str) -> str:
    """The count a launch adds to, after the kernel's name: ``suffix``
    (K1-K3's dropout's), then ``_f16`` for a float16 instance."""
    return suffix + ("_f16" if q.dtype == torch.float16 else "")


def _dropout_args(what: str, q: torch.Tensor, dropout_p: float,
                  rng: Optional[torch.Tensor]):
    """The kernels' dropout arguments ``(rng pointer, coordinates?,
    threshold, 1/(1-p))`` and the launch's kernel name suffix: ``(None, 0,
    0, 0.0)`` and ``""`` for ``dropout_p == 0``.  ``rng`` is the draw on
    q's device, read by the kernel: ``int64[2]`` ``[seed, offset]``
    (``rng.Generator.draw``), or ``int64[5]`` with the rank's ``[batch_start,
    head_start, heads_total]`` after them (``rng.with_coordinates``), which
    place q's samples and heads in the whole tensors' draw."""
    if dropout_p == 0.0:
        return (None, 0, 0, 0.0), ""
    from ..rng import keep_threshold
    threshold = keep_threshold(dropout_p)
    _require(isinstance(rng, torch.Tensor) and rng.dtype == torch.int64
             and tuple(rng.shape) in ((2,), (5,)) and rng.device == q.device
             and rng.is_contiguous(), what,
             "dropout needs rng, a contiguous int64 [seed, offset] (or "
             f"[seed, offset, batch_start, head_start, heads_total]) tensor "
             f"on {q.device}")
    scale = 1.0 / (1.0 - dropout_p) if dropout_p < 1.0 else 0.0
    return (rng.data_ptr(), int(rng.numel() == 5), threshold, scale), \
        "_dropout"


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, dropout_p: float = 0.0,
              rng: Optional[torch.Tensor] = None):
    """K1: flash attention forward over ``[B, S, H, D]`` q/k/v, read
    through their strides (head dim contiguous).  Returns ``(o, lse)``:
    ``o`` ``[B, S, H, D]`` in the input dtype, ``lse`` ``[B*H, S]`` f32
    (of the undropped probabilities).  ``dropout_p > 0`` launches the
    dropout instance, which reads the draw ``rng`` (:func:`_dropout_args`)
    and counts as ``flash_fwd_dropout``.  bf16 and f16 run on tensor cores
    (p rounded to the input dtype before P V) and need 16-byte aligned
    rows (:func:`_check_rows16`); f32 runs the CUDA-core loop.  A float16
    launch counts as ``flash_fwd_f16`` (``flash_fwd_dropout_f16``)."""
    what = "flash_fwd"
    D = _check_dense(what, q, k, v)
    _check_rows16(what, q, k, v)
    drop, suffix = _dropout_args(what, q, dropout_p, rng)
    B, S, H, _ = q.shape
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    lib = _library("flash_attention_fwd")
    rc = lib.pt_flash_fwd(
        _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, S, H, int(bool(causal)),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        1.0 / D ** 0.5, *drop, _stream(q))
    _raise_on(rc, lib, "pt_flash_error_string", what)
    KERNELS["flash_fwd" + _instance(q, suffix)].launches += 1
    return o, lse


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool = True, dropout_p: float = 0.0,
                  rng: Optional[torch.Tensor] = None):
    """K2: dK and dV of flash attention.  ``q``/``k``/``v``/``do``
    ``[B, S, H, D]`` read through their strides (head dims contiguous);
    ``lse`` (K1's) and ``delta = rowsum(do * o)`` contiguous f32
    ``[B*H, S]``.  Returns ``(dk, dv)``, contiguous ``[B, S, H, D]`` in
    the input dtype.  ``dropout_p``/``rng``: the forward's (the dropout
    instance, counted as ``flash_bwd_dkv_dropout``).  bf16 and f16 run on
    tensor cores and need 16-byte aligned rows (:func:`_check_rows16`); f32
    runs the CUDA-core loop.  In f16 a ds past the dtype's range rounds to
    inf, as in the Pallas kernel, so an overflow under a loss scale reaches
    the gradients.  A float16 launch counts under ``..._f16``."""
    what = "flash_bwd_dkv"
    D = _check_dense(what, q, k, v, do)
    _check_rows16(what, q, k, v, do)
    _check_rows(what, q, lse, delta)
    drop, suffix = _dropout_args(what, q, dropout_p, rng)
    B, S, H, _ = q.shape
    dk = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _library("flash_attention_bwd")
    rc = lib.pt_flash_bwd_dkv(
        _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, S, H, int(bool(causal)),
        *[s for t in (q, k, v, do, dk, dv) for s in t.stride()[:3]],
        1.0 / D ** 0.5, *drop, _stream(q))
    _raise_on(rc, lib, "pt_flash_bwd_error_string", what)
    KERNELS["flash_bwd_dkv" + _instance(q, suffix)].launches += 1
    return dk, dv


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool = True, dropout_p: float = 0.0,
                 rng: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: dQ of flash attention; arguments as :func:`flash_bwd_dkv`
    (dropout counted as ``flash_bwd_dq_dropout``).  Returns ``dq``,
    contiguous ``[B, S, H, D]`` in the input dtype; bf16 and f16 need
    16-byte aligned rows, as there (a float16 launch counts under
    ``..._f16``)."""
    what = "flash_bwd_dq"
    D = _check_dense(what, q, k, v, do)
    _check_rows16(what, q, k, v, do)
    _check_rows(what, q, lse, delta)
    drop, suffix = _dropout_args(what, q, dropout_p, rng)
    B, S, H, _ = q.shape
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lib = _library("flash_attention_bwd")
    rc = lib.pt_flash_bwd_dq(
        _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B,
        S, H, int(bool(causal)),
        *[s for t in (q, k, v, do, dq) for s in t.stride()[:3]],
        1.0 / D ** 0.5, *drop, _stream(q))
    _raise_on(rc, lib, "pt_flash_bwd_error_string", what)
    KERNELS["flash_bwd_dq" + _instance(q, suffix)].launches += 1
    return dq


# -- conditional nodes of a CUDA graph (csrc/graph_control.cu) ---------------

_graph_streams: Dict[Tuple[int, int], torch.cuda.ExternalStream] = {}


def _graph_call(fn: str, *args) -> None:
    lib = _library("graph_control")
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA graph conditional node failed "
                           f"({rc}: {lib.pt_graph_error_string(rc).decode()})")


def graph_stream(device: torch.device, depth: int) -> torch.cuda.Stream:
    """The stream a conditional body at nesting ``depth`` is captured on:
    one of the port's own per (device, depth), made once."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    s = _graph_streams.get((index, depth))
    if s is None:
        ptr = ctypes.c_void_p()
        with torch.cuda.device(index):
            _graph_call("pt_graph_stream_create", ctypes.byref(ptr))
        s = torch.cuda.ExternalStream(ptr.value, device=torch.device(
            "cuda", index))
        _graph_streams[(index, depth)] = s
    return s


def _bool_ptr(what: str, pred: torch.Tensor) -> int:
    _require(pred.is_cuda and pred.dtype == torch.bool and pred.numel() == 1,
             what, f"the condition must be one CUDA bool, got {pred.dtype} "
             f"{tuple(pred.shape)} on {pred.device}")
    return pred.data_ptr()


def graph_node_begin(parent: torch.cuda.Stream, child: torch.cuda.Stream,
                     is_while: bool, pred: torch.Tensor, negate: bool = False,
                     runs: Optional[torch.Tensor] = None) -> int:
    """Add an IF (``is_while`` False) or WHILE node to the graph ``parent``
    is capturing into, its condition set from ``pred`` (negated if
    ``negate``) by the conditional kernel just before it; ``child`` then
    captures the node's body.  ``runs`` (int64, one element) counts the
    body's runs.  Returns the node's handle."""
    what = "graph_node_begin"
    handle = ctypes.c_ulonglong()
    _graph_call("pt_graph_node_begin", parent.cuda_stream, child.cuda_stream,
                int(is_while), _bool_ptr(what, pred), int(negate),
                None if runs is None else runs.data_ptr(),
                ctypes.byref(handle))
    KERNELS["graph_conditional"].launches += 1
    return handle.value


def graph_node_end(child: torch.cuda.Stream, is_while: bool, handle: int,
                   pred: Optional[torch.Tensor] = None,
                   runs: Optional[torch.Tensor] = None) -> None:
    """Close the body ``child`` captures; a WHILE body ends with the
    conditional kernel setting the next trip's condition from ``pred``."""
    what = "graph_node_end"
    ptr = _bool_ptr(what, pred) if is_while else None
    _graph_call("pt_graph_node_end", child.cuda_stream, int(is_while),
                handle, ptr, None if runs is None else runs.data_ptr())
    if is_while:
        KERNELS["graph_conditional"].launches += 1
