"""Sharded, CRC-checked, generation-keyed checkpoints: the JAX package's
format 2, read and written.

Port of ``paddle_tpu/distributed/checkpoint.py``.  A checkpoint is a
directory of ``.npy`` shard files plus one ``index.json`` mapping each
tensor to its global shape, dtype tag, spec and the global index range
each shard file covers, with the file's CRC32 (``format: 2``,
``save_id``).  The names, the index and the commit order are the JAX
package's, so either package reads what the other wrote:

- a nested state (dicts, lists, tuples) is flattened with ``/`` between
  levels, ``%``-escaped keys and ``<i>``/``<i!t>`` list and tuple
  markers (:func:`_flatten`); Python scalars and strings go into the
  index as literals;
- a shard file is ``<escaped name>.s<save_id>.full.npy`` (a whole
  tensor) or ``.s<save_id>.<rank>.<k>.npy`` (the k-th block a rank
  holds); bf16 is stored as its ``uint16`` bits tagged ``"bfloat16"``,
  read back through ``torch.from_numpy(bits).view(torch.bfloat16)`` (no
  ``ml_dtypes``);
- commit order: the data files first, then the index by an atomic
  ``os.replace``, then the files of older saves are deleted; a kill at
  any point leaves the previous checkpoint whole or the new one
  committed.

At one process every tensor is written whole (``.full.npy``).  Under a
``torch.distributed`` world every rank writes its own blocks of a tensor
of the tensor-parallel layers (:func:`~.fleet.meta_parallel.mp_layers.
shard_layout` gives their global ranges) and rank 0 the whole tensors;
each rank writes an index fragment and rank 0 merges them, with
``dist.barrier`` where the JAX package syncs its devices (its
``_commit``, :221-274).

Loading reads each tensor's regions from whichever shard files cover
them: a whole tensor at one process, the rank's blocks for a template
tensor of the tensor-parallel layers, on the template tensor's device or
on ``device`` (``"cuda"`` unless the caller asks for the CPU).  A
template's tensors are never written: the caller loads the result in
place (``load_state_dict``).

The generation layer (:func:`save_generation`, :func:`latest_valid`,
:func:`gc_generations`, ...) keeps one committed checkpoint per step
under a root, ``root/step_000000123``; :func:`verify_checkpoint` is the
integrity pass (index, files, CRC32, coverage) every resume runs.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import sys
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "save_state_dict", "load_state_dict", "AsyncSaveHandle",
    "verify_checkpoint", "save_generation", "list_generations",
    "latest_valid", "gc_generations", "generation_dir", "load_generation",
]

_INDEX = "index.json"
_GEN_PREFIX = "step_"
_GEN_DIGITS = 9


#: threads that write, read and checksum shard files at once (zlib, numpy
#: copies, file I/O and device copies release the GIL)
_IO_THREADS = min(8, os.cpu_count() or 1)


def _each(fn: Callable, items: list) -> list:
    """``[fn(x) for x in items]`` on ``_IO_THREADS`` threads, in order."""
    if len(items) < 2 or _IO_THREADS < 2:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=_IO_THREADS) as ex:
        return list(ex.map(fn, items))


def _world() -> Tuple[int, int]:
    """``(rank, world size)`` of the ``torch.distributed`` world, (0, 1)
    without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier(nproc: int) -> None:
    if nproc > 1:
        import torch.distributed as dist

        dist.barrier()


def _file_crc32(path: str) -> int:
    """CRC32 of a whole file (header and payload)."""
    crc = 0
    with open(path, "rb", buffering=0) as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


class _CRC32FileWriter:
    """A file object that accumulates the CRC32 of every byte ``np.save``
    writes (no read-back).  Not an ``io.FileIO``, so ``np.save`` takes its
    chunked ``write`` path."""

    def __init__(self, f):
        self._f = f
        self.crc = 0

    def write(self, b):
        self.crc = zlib.crc32(b, self.crc)
        return self._f.write(b)


def _to_host(t: torch.Tensor, copy: bool = False) -> np.ndarray:
    """A tensor as the numpy array its shard file holds (bf16 as its
    ``uint16`` bits); ``copy``: never sharing a CPU tensor's memory."""
    host = t.detach().cpu().contiguous()
    if copy and host.data_ptr() == t.data_ptr():
        host = host.clone()           # a CPU tensor: not its live memory
    t = host
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_tag(value) -> str:
    if isinstance(value, torch.Tensor):
        return str(value.dtype).replace("torch.", "")
    return str(np.dtype(value.dtype))


def _esc(key) -> str:
    """Escape a container key for a ``/``-separated path (optimizer keys
    contain ``/``; ``<`` guards the list-index markers)."""
    return (str(key).replace("%", "%25").replace("/", "%2F")
            .replace("<", "%3C"))


def _unesc(seg: str) -> str:
    return seg.replace("%3C", "<").replace("%2F", "/").replace("%25", "%")


def _flatten(obj, prefix=""):
    """A nested state as ``{path: leaf}``: ``/`` between levels, a literal
    ``/`` in a key ``%``-escaped, list and tuple indices as ``<i>`` and
    ``<i!t>`` so that containers come back with their type."""
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(_flatten(v, f"{prefix}{_esc(k)}/"))
    elif isinstance(obj, (list, tuple)):
        tag = "!t" if isinstance(obj, tuple) else ""
        for i, v in enumerate(obj):
            out.update(_flatten(v, f"{prefix}<{i}{tag}>/"))
    else:
        out[prefix[:-1]] = obj
    return out


_IDX_RE = re.compile(r"^<(\d+)(!t)?>$")


def _unflatten(flat: Dict[str, Any]):
    """The tree of :func:`_flatten`, built on the escaped keys (a user key
    that was literally ``<0>`` arrives as ``%3C0>``), then sequences
    rebuilt and keys unescaped."""
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        parts = name.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return _rebuild(out)


def _rebuild(node):
    if not isinstance(node, dict):
        return node
    if node and all(_IDX_RE.match(k) for k in node):
        items = sorted(((int(_IDX_RE.match(k).group(1)),
                         _IDX_RE.match(k).group(2), _rebuild(v))
                        for k, v in node.items()))
        seq = [v for _, _, v in items]
        return tuple(seq) if items[0][1] else seq
    return {_unesc(k): _rebuild(v) for k, v in node.items()}


def _is_literal(value) -> bool:
    return not isinstance(value, (torch.Tensor, np.ndarray, np.generic)) \
        and np.ndim(value) == 0


def _layout(t: torch.Tensor, nproc: int):
    """``(global shape, [box, ...], spec)`` of a tensor-parallel shard, or
    None for a whole tensor."""
    if nproc == 1:
        return None
    from .fleet.meta_parallel.mp_layers import shard_layout

    return shard_layout(t)


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    async_save: bool = False):
    """Write a (nested) state dict as a format-2 checkpoint in ``path``.

    The device-to-host copies happen in the call (the values at call
    time); with ``async_save=True`` the file writes and the commit run on
    a background thread: call ``.result()`` on the returned
    :class:`AsyncSaveHandle`."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(state_dict)
    pid, nproc = _world()
    # the save id tags the shard files, so rewriting a live checkpoint
    # never touches a file the current index names
    sid = 0
    idx_path = os.path.join(path, _INDEX)
    if os.path.exists(idx_path):
        try:
            with open(idx_path) as f:
                sid = int(json.load(f).get("save_id", -1)) + 1
        except Exception:                  # noqa: BLE001 — a torn index
            sid = 1
    _barrier(nproc)                        # every rank read sid first
    index: Dict[str, Any] = {"tensors": {}, "format": 2, "save_id": sid}
    pending: List[tuple] = []     # (file path, data, shard meta)

    for name, value in flat.items():
        safe = name.replace("%", "%25").replace("/", "%2F") + f".s{sid}"
        if _is_literal(value):
            index["tensors"][name] = {"literal": value}
            continue
        if not isinstance(value, torch.Tensor):
            value = np.asarray(value)
        lay = _layout(value, nproc) if isinstance(value, torch.Tensor) \
            else None
        if lay is None:
            meta = {"shape": list(value.shape), "dtype": _dtype_tag(value),
                    "spec": None, "shards": []}
            if pid == 0:
                fname = f"{safe}.full.npy"
                sh_meta = {"file": fname,
                           "index": [[0, int(d)] for d in value.shape]}
                meta["shards"].append(sh_meta)
                data = _to_host(value, async_save) \
                    if isinstance(value, torch.Tensor) else \
                    (np.array(value) if async_save else value)
                pending.append((os.path.join(path, fname), data, sh_meta))
            index["tensors"][name] = meta
            continue
        gshape, boxes, spec = lay
        meta = {"shape": list(gshape), "dtype": _dtype_tag(value),
                "spec": spec, "shards": []}
        host = value.detach().cpu()
        offset = 0
        for k, box in enumerate(boxes):
            dim = next(i for i, (lo, hi) in enumerate(box)
                       if hi - lo != gshape[i])
            n = box[dim][1] - box[dim][0]
            fname = f"{safe}.{pid}.{k}.npy"
            sh_meta = {"file": fname, "index": [list(b) for b in box]}
            meta["shards"].append(sh_meta)
            pending.append((os.path.join(path, fname),
                            _to_host(host.narrow(dim, offset, n), async_save),
                            sh_meta))
            offset += n
        index["tensors"][name] = meta

    def _commit():
        """Data files first, the index replaced atomically last, older
        saves' files deleted after."""
        frag = os.path.join(path, f"_index.{pid}.{sid}.json")
        with open(frag, "w") as f:
            json.dump(index, f)
        _barrier(nproc)
        if pid == 0:
            merged = index
            for p in range(1, nproc):
                fp = os.path.join(path, f"_index.{p}.{sid}.json")
                if not os.path.exists(fp):
                    raise RuntimeError(
                        f"index fragment for process {p} missing — "
                        f"checkpoint incomplete")
                with open(fp) as f:
                    other = json.load(f)
                for n, m in other["tensors"].items():
                    if "literal" in m:
                        continue      # every rank records the same literal
                    if n in merged["tensors"]:
                        merged["tensors"][n]["shards"].extend(m["shards"])
                    else:
                        merged["tensors"][n] = m
            tmp = os.path.join(path, _INDEX + ".tmp")
            with open(tmp, "w") as f:
                json.dump(merged, f, indent=1)
            os.replace(tmp, os.path.join(path, _INDEX))
        _barrier(nproc)
        # each rank deletes its own older files (rank 0 the whole ones)
        cur = f".s{sid}"
        for fn in os.listdir(path):
            full = os.path.join(path, fn)
            try:
                if fn.startswith("_index.") and not fn.endswith(
                        f".{sid}.json") and fn.split(".")[1] == str(pid):
                    os.remove(full)
                elif fn.endswith(".npy") and cur not in fn:
                    if f".{pid}." in fn or (pid == 0 and ".full" in fn):
                        os.remove(full)
            except OSError:
                pass

    def _write_one(item):
        fpath, data, sh_meta = item
        with open(fpath, "wb") as f:
            w = _CRC32FileWriter(f)
            np.save(w, data)
        sh_meta["crc32"] = w.crc

    def _write():
        _each(_write_one, pending)

    if async_save:
        if nproc > 1:
            raise NotImplementedError(
                "async_save in a multi-process world needs the commit "
                "barrier on the main thread; save synchronously")
        h = AsyncSaveHandle(_write, finalize=_commit)
        h.start()
        return h
    _write()
    _commit()
    return None


class AsyncSaveHandle:
    """A background writer: the device-to-host copies are already done;
    ``finalize`` (the index commit) runs on the thread after the data
    files, so the checkpoint becomes visible only complete."""

    def __init__(self, fn, finalize=None):
        if finalize is not None:
            orig = fn

            def fn():
                orig()
                finalize()
        self._fn = fn
        self._exc = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        try:
            self._fn()
        except BaseException as e:           # re-raised in result()
            self._exc = e

    def start(self):
        self._thread.start()

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout=None):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("checkpoint write still in progress")
        if self._exc is not None:
            raise self._exc
        return None


def _np_dtype(dtype_name: str):
    return np.dtype(np.uint16) if dtype_name == "bfloat16" \
        else np.dtype(dtype_name)


def _read_region(shards_meta, base: str, starts, stops,
                 dtype_name: str) -> np.ndarray:
    """The ``[starts, stops)`` box of the global tensor, assembled from
    whichever shard files overlap it (bf16 as its ``uint16`` bits)."""
    out = np.empty([b - a for a, b in zip(starts, stops)],
                   dtype=_np_dtype(dtype_name))
    filled = 0
    for sh in shards_meta:
        s_starts = [se[0] for se in sh["index"]]
        s_stops = [se[1] for se in sh["index"]]
        lo = [max(a, sa) for a, sa in zip(starts, s_starts)]
        hi = [min(b, sb) for b, sb in zip(stops, s_stops)]
        if any(l >= h for l, h in zip(lo, hi)):
            continue
        data = np.load(os.path.join(base, sh["file"]), mmap_mode="r")
        src = tuple(slice(l - sa, h - sa)
                    for l, h, sa in zip(lo, hi, s_starts))
        dst = tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, starts))
        out[dst] = data[src]
        filled += int(np.prod([h - l for l, h in zip(lo, hi)]))
    want = int(np.prod(out.shape))
    if filled < want:
        raise ValueError(
            f"checkpoint shards do not cover requested region "
            f"({filled}/{want} elements)")
    return out


def _as_tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(a, order="C"))     # 0-d stays 0-d
    if dtype_name == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    return t


def _spec_axes(entries) -> set:
    axes = set()
    for e in entries or ():
        if isinstance(e, (list, tuple)):
            axes.update(e)
        elif e is not None:
            axes.add(e)
    return axes


def _note_reshard(report, name, meta, source, kept_entries):
    """Record how one tensor landed: which saved-spec axes survived and
    which were dropped (replicated over)."""
    if report is None:
        return
    saved = meta.get("spec")
    kept = _spec_axes(kept_entries)
    report[name] = {"source": source, "saved_spec": saved,
                    "kept_axes": sorted(kept),
                    "dropped_axes": sorted(_spec_axes(saved) - kept)}


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_state_dict: device 'cuda' asked for, but "
                           "no CUDA device is available (pass "
                           "device='cpu')")
    return device


def load_state_dict(path: str, state_dict: Optional[Dict[str, Any]] = None,
                    mesh=None, return_numpy: bool = False,
                    reshard_report: Optional[dict] = None,
                    device="cuda"):
    """Load a checkpoint directory as a nested state.

    - With a template ``state_dict`` (e.g. ``model.state_dict()``), each
      tensor lands on its template tensor's device; a template tensor of
      the tensor-parallel layers (in a world of more than one process)
      gets this rank's blocks of the saved global tensor.
    - Other tensors land whole on ``device``; ``return_numpy=True`` gives
      numpy arrays (a bf16 tensor as a CPU ``torch.bfloat16`` tensor,
      numpy having no bfloat16).
    - ``reshard_report`` (a dict) is filled per tensor with ``{"source",
      "saved_spec", "kept_axes", "dropped_axes"}``.
    - ``mesh`` is accepted for the JAX signature; the placement comes
      from the template.

    The dtype is the saved one.  Nothing of the template is written."""
    del mesh
    with open(os.path.join(path, _INDEX)) as f:
        index = json.load(f)
    tmpl_flat = _flatten(state_dict) if state_dict is not None else {}
    _, nproc = _world()
    tensors = [(name, meta) for name, meta in index["tensors"].items()
               if "literal" not in meta]
    if not return_numpy and any(
            not isinstance(tmpl_flat.get(n), torch.Tensor)
            for n, _ in tensors):
        device = _check_device(device)

    def load_one(item):
        """``(value, report source, kept spec)`` of one tensor."""
        name, meta = item
        shape = [int(d) for d in meta["shape"]]
        dtype_name = meta["dtype"]
        tmpl = tmpl_flat.get(name)
        lay = _layout(tmpl, nproc) if isinstance(tmpl, torch.Tensor) \
            else None
        if lay is None:
            arr = _read_region(meta["shards"], path, [0] * len(shape),
                               shape, dtype_name)
            if return_numpy:
                return (_as_tensor(arr, dtype_name)
                        if dtype_name == "bfloat16" else arr), "host", ()
            if isinstance(tmpl, torch.Tensor):
                return _as_tensor(arr, dtype_name).to(tmpl.device), \
                    "template", ()
            return _as_tensor(arr, dtype_name).to(device), "device", ()
        gshape, boxes, spec = lay
        if list(gshape) != shape:
            raise ValueError(f"load_state_dict: {name} is {shape} in the "
                             f"checkpoint, the template's global shape "
                             f"{list(gshape)}")
        parts = []
        for box in boxes:
            dim = next(i for i, (lo, hi) in enumerate(box)
                       if hi - lo != gshape[i])
            parts.append((dim, _as_tensor(_read_region(
                meta["shards"], path, [lo for lo, _ in box],
                [hi for _, hi in box], dtype_name), dtype_name)))
        t = torch.cat([p for _, p in parts], dim=parts[0][0])
        return t.to(tmpl.device), "template", spec

    loaded = dict(zip((n for n, _ in tensors), _each(load_one, tensors)))
    out_flat: Dict[str, Any] = {}
    for name, meta in index["tensors"].items():
        if "literal" in meta:
            out_flat[name] = meta["literal"]
            continue
        value, source, kept = loaded[name]
        _note_reshard(reshard_report, name, meta, source, kept)
        out_flat[name] = value
    return _unflatten(out_flat)


# -- integrity and the step generations ----------------------------------------

#: above this many elements the coverage check compares volumes instead of
#: an exact boolean mask
_COVERAGE_MASK_CAP = 1 << 22


def verify_checkpoint(path: str, check_crc: bool = True) -> List[str]:
    """Integrity pass over one checkpoint directory: the problems found,
    empty when it is loadable (the index parses, every shard file exists,
    each file's CRC32 matches the one recorded at save time, each tensor's
    shards cover its global shape).  A save that died before its commit
    left no ``index.json``: one "no index" problem."""
    problems: List[str] = []
    idx_path = os.path.join(path, _INDEX)
    if not os.path.isfile(idx_path):
        return [f"{path}: no {_INDEX} (checkpoint never committed)"]
    try:
        with open(idx_path) as f:
            index = json.load(f)
        tensors = index["tensors"]
    except Exception as e:                  # noqa: BLE001 — reported
        return [f"{path}: unreadable {_INDEX}: {e}"]
    # the files' CRC32s first, in parallel; the checks below in order
    files = sorted({sh["file"] for meta in tensors.values()
                    for sh in meta.get("shards", ()) if "crc32" in sh
                    and os.path.isfile(os.path.join(path, sh["file"]))}) \
        if check_crc else []
    crcs = dict(zip(files, _each(
        lambda fn: _file_crc32(os.path.join(path, fn)), files)))
    for name, meta in tensors.items():
        if "literal" in meta:
            continue
        shape = tuple(meta.get("shape", ()))
        total = int(np.prod(shape)) if shape else 1
        mask = (np.zeros(shape, dtype=bool)
                if 0 < total <= _COVERAGE_MASK_CAP and shape else None)
        volume = 0
        for sh in meta.get("shards", ()):
            fpath = os.path.join(path, sh["file"])
            if not os.path.isfile(fpath):
                problems.append(f"{name}: missing shard file {sh['file']}")
                continue
            if check_crc and "crc32" in sh:
                crc = crcs[sh["file"]]
                if crc != sh["crc32"]:
                    problems.append(
                        f"{name}: crc mismatch in {sh['file']} "
                        f"(recorded {sh['crc32']:#010x}, "
                        f"actual {crc:#010x})")
                    continue
            region = [(int(a), int(b)) for a, b in sh["index"]]
            volume += int(np.prod([b - a for a, b in region])) \
                if region else 1
            if mask is not None:
                mask[tuple(slice(a, b) for a, b in region)] = True
        if mask is not None:
            if not mask.all():
                problems.append(
                    f"{name}: shards cover {int(mask.sum())}/{total} "
                    f"elements")
        elif volume < total:
            problems.append(
                f"{name}: shard volume {volume} < {total} elements")
    return problems


def generation_dir(root: str, step: int) -> str:
    """``root/step_000000123``: one committed checkpoint per step."""
    return os.path.join(root, f"{_GEN_PREFIX}{step:0{_GEN_DIGITS}d}")


def list_generations(root: str) -> List[int]:
    """Step numbers of every generation directory under ``root``
    (committed or not), ascending."""
    if not os.path.isdir(root):
        return []
    steps = []
    for fn in os.listdir(root):
        if fn.startswith(_GEN_PREFIX) and fn[len(_GEN_PREFIX):].isdigit() \
                and os.path.isdir(os.path.join(root, fn)):
            steps.append(int(fn[len(_GEN_PREFIX):]))
    return sorted(steps)


def latest_valid(root: str, check_crc: bool = True
                 ) -> Optional[Tuple[int, str]]:
    """The newest generation that passes :func:`verify_checkpoint`, as
    ``(step, path)``: a generation torn by a crash or corrupted on disk is
    skipped (and named on stderr), never loaded."""
    for step in reversed(list_generations(root)):
        path = generation_dir(root, step)
        problems = verify_checkpoint(path, check_crc=check_crc)
        if not problems:
            return step, path
        print(f"[ckpt] skipping generation {step}: {problems[0]}"
              + (f" (+{len(problems) - 1} more)" if len(problems) > 1
                 else ""), file=sys.stderr)
    return None


# a generation verified in full once per process is not CRC-read again by
# the retention pass that follows every cadence save, until its index
# changes; latest_valid at a resume always reads it in full
_VERIFY_OK_CACHE: Dict[str, float] = {}


def _index_mtime(path: str) -> Optional[float]:
    try:
        return os.path.getmtime(os.path.join(path, _INDEX))
    except OSError:
        return None


def _mark_verified(path: str):
    mt = _index_mtime(path)
    if mt is not None:
        _VERIFY_OK_CACHE[os.path.abspath(path)] = mt


def _verified_ok(path: str) -> bool:
    mt = _index_mtime(path)
    if mt is None:
        return False
    key = os.path.abspath(path)
    if _VERIFY_OK_CACHE.get(key) == mt:
        # the structural pass still runs: a generation that lost a file
        # after its one full verify is evicted
        return not verify_checkpoint(path, check_crc=False)
    if not verify_checkpoint(path):
        _VERIFY_OK_CACHE[key] = mt
        return True
    return False


def gc_generations(root: str, keep_last: int) -> List[int]:
    """Delete all but the newest ``keep_last`` valid generations (torn or
    corrupt ones always go: they can never be resumed from).  Returns the
    deleted steps.  In a multi-process world: rank 0 only, after the
    commit of the save that triggered it."""
    if keep_last < 1:
        raise ValueError(
            f"keep_last must be >= 1 (got {keep_last}): 0 would delete "
            "the generation that was just committed")
    kept = 0
    deleted = []
    for step in reversed(list_generations(root)):
        path = generation_dir(root, step)
        if kept < keep_last and _verified_ok(path):
            kept += 1
            continue
        shutil.rmtree(path, ignore_errors=True)
        _VERIFY_OK_CACHE.pop(os.path.abspath(path), None)
        deleted.append(step)
    return deleted


def save_generation(state_dict: Dict[str, Any], root: str, step: int,
                    keep_last: Optional[int] = None):
    """Commit ``state_dict`` as generation ``step`` under ``root``, then
    keep the newest ``keep_last``.  The generation is visible to
    :func:`latest_valid` only once its index commits."""
    path = generation_dir(root, step)
    save_state_dict(state_dict, path)
    # the CRCs were computed from the bytes as written: the retention
    # pass need not read the generation back
    _mark_verified(path)
    if keep_last is not None and _world()[0] == 0:
        gc_generations(root, keep_last)
    return path


def load_generation(root: str, state_dict: Optional[Dict[str, Any]] = None,
                    mesh=None, check_crc: bool = True, device="cuda"):
    """The newest valid generation as ``(step, state)``, or None."""
    found = latest_valid(root, check_crc=check_crc)
    if found is None:
        return None
    step, path = found
    return step, load_state_dict(path, state_dict, mesh=mesh, device=device)
