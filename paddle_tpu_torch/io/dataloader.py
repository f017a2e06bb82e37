"""``DataLoader``: batches of a dataset as CPU tensors, read in the loop's
process or by spawned worker processes.

Port of ``paddle_tpu/io/dataloader.py``.  Batches stay on the host: the
loader yields CPU tensors, and ``hapi.Model`` moves each batch to its
network's device.  ``num_workers > 0`` spawns that many workers, each fed
batch indices through its own queue; a worker reads and collates its
batch into numpy arrays and hands it back through its shared-memory ring
(:mod:`.native`), announcing it on a common result queue; the parent
reorders the batches to the sampler's order.  A batch larger than the
ring goes through the result queue itself, and so does every batch with
``use_shared_memory=False`` or without ``g++`` to build the ring.
``transport`` counts, on the loader, how each worker batch came
(``"ring"`` or ``"queue"``), so a fall-back shows.

A worker hides the cards from itself (``CUDA_VISIBLE_DEVICES=""``) before
it runs any of the dataset's code and never makes a CUDA tensor: the card
belongs to the training process.  A wait longer than ``timeout`` seconds
(600 when 0), or a worker that died, raises in the parent.
"""
from __future__ import annotations

import os
import pickle
import queue
import time
import traceback
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "WorkerInfo", "get_worker_info",
           "default_collate_fn", "numpy_collate_fn"]


@dataclass
class WorkerInfo:
    id: int
    num_workers: int
    dataset: Any
    seed: int = 0


_worker_info: Optional[WorkerInfo] = None


def get_worker_info() -> Optional[WorkerInfo]:
    """This worker's :class:`WorkerInfo` inside a worker, else None."""
    return _worker_info


def _collate(batch, leaf):
    """The batch traversal both collates share; ``leaf(ndarray)`` makes a
    stacked array a tensor (the loop's process) or keeps it (a worker)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return leaf(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return leaf(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return leaf(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (list, tuple)):
        return [_collate(list(items), leaf) for items in zip(*batch)]
    if isinstance(sample, dict):
        return {k: _collate([d[k] for d in batch], leaf) for k in sample}
    if isinstance(sample, torch.Tensor):
        return leaf(np.stack([s.detach().cpu().numpy() for s in batch]))
    return batch  # other sample types pass through unbatched


def default_collate_fn(batch):
    """Stack samples into batched CPU tensors (numbers: int64, float32)."""
    return _collate(batch, torch.from_numpy)


def numpy_collate_fn(batch):
    """:func:`default_collate_fn`'s traversal giving numpy arrays: the
    workers' collate (what crosses to the parent is numpy)."""
    return _collate(batch, lambda a: a)


def _fetch_batch(dataset, indices, collate_fn):
    return collate_fn([dataset[i] for i in indices])


def _np_ify(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_np_ify(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _np_ify(v) for k, v in obj.items()}
    return obj


def _tensor_ify(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tensor_ify(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _tensor_ify(v) for k, v in obj.items()}
    return obj


_SHM_MARKER = "__shm_ring__"


def _worker_loop(index_queue, result_queue, collate_fn, worker_init_fn,
                 worker_id, num_workers, ring_name=None):
    global _worker_info
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    # the dataset comes first on the index queue, not as an argument: a
    # large one pickled into the spawn pipe would hold Process.start()
    # until this worker had imported everything, starting the workers
    # one after another
    dataset = index_queue.get()
    ring = None
    if ring_name is not None:
        try:
            from .native import ShmRing

            ring = ShmRing(ring_name)
        except (OSError, RuntimeError):
            ring = None
    _worker_info = WorkerInfo(worker_id, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        item = index_queue.get()
        if item is None:
            break
        batch_id, indices = item
        try:
            data = _np_ify(_fetch_batch(dataset, indices, collate_fn))
            if ring is not None:
                # the batch rides the ring; the queue carries only the
                # announcement
                try:
                    ring.push(pickle.dumps(
                        (batch_id, data), protocol=pickle.HIGHEST_PROTOCOL))
                    result_queue.put(
                        (batch_id, (_SHM_MARKER, worker_id), None))
                    continue
                except ValueError:      # larger than the ring
                    pass
            result_queue.put((batch_id, data, None))
        except Exception:  # noqa: BLE001 - handed to the parent
            result_queue.put((batch_id, None, traceback.format_exc()))
    if ring is not None:
        ring.close_producer()


def _ring_capacity(n_workers: int) -> int:
    """Bytes of each worker's ring: 64 MiB, or half of the free
    ``/dev/shm`` shared by the workers where that is less (a segment is
    sparse when made, so a larger one would fault on first touch instead
    of failing cleanly)."""
    cap = 64 * 1024 * 1024
    try:
        st = os.statvfs("/dev/shm")
        cap = min(cap, int(st.f_bavail * st.f_frsize * 0.5)
                  // max(n_workers, 1))
    except OSError:
        pass
    return cap


class _MultiProcessIter:
    def __init__(self, loader):
        import multiprocessing as mp

        self.loader = loader
        ctx = mp.get_context("spawn")
        self.index_queues = []
        self.result_queue = ctx.Queue()
        self.workers = []
        self.batches = list(loader.batch_sampler)
        self.n_batches = len(self.batches)
        self.next_dispatch = 0
        self.next_yield = 0
        self.reorder = {}
        n = loader.num_workers
        # workers get the numpy collate unless the user gave one
        wcollate = numpy_collate_fn if loader.collate_fn \
            is default_collate_fn else loader.collate_fn
        self.rings = [None] * n
        ring_names = [None] * n
        if loader.use_shared_memory:
            from .native import ShmRing, available

            cap = _ring_capacity(n)
            if available() and cap >= 1024 * 1024:
                import uuid

                base = f"/ptt_{os.getpid()}_{uuid.uuid4().hex[:8]}"
                try:
                    for wid in range(n):
                        name = f"{base}_{wid}"
                        self.rings[wid] = ShmRing(name, capacity=cap,
                                                  create=True)
                        ring_names[wid] = name
                except OSError:
                    self._close_rings()
                    self.rings, ring_names = [None] * n, [None] * n
        for wid in range(n):
            iq = ctx.Queue()
            w = ctx.Process(
                target=_worker_loop,
                args=(iq, self.result_queue, wcollate,
                      loader.worker_init_fn, wid, n, ring_names[wid]),
                daemon=True)
            w.start()
            iq.put(loader.dataset)
            self.workers.append(w)
            self.index_queues.append(iq)
        for _ in range(min(2 * n, self.n_batches)):
            self._dispatch()

    def _dispatch(self):
        if self.next_dispatch >= self.n_batches:
            return
        wid = self.next_dispatch % len(self.workers)
        self.index_queues[wid].put(
            (self.next_dispatch, self.batches[self.next_dispatch]))
        self.next_dispatch += 1

    def __iter__(self):
        return self

    def _fail(self, msg: str):
        self._shutdown()
        raise RuntimeError(msg)

    def _get(self, timeout_s: float):
        """The next announcement, polling the workers' liveness."""
        deadline = time.monotonic() + timeout_s
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(f"DataLoader: no batch from the workers in "
                           f"{timeout_s} s (batch {self.next_yield})")
            try:
                return self.result_queue.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [w.pid for w in self.workers if not w.is_alive()]
                if dead:
                    self._fail(f"DataLoader: worker process(es) {dead} "
                               f"exited unexpectedly")

    def __next__(self):
        if self.next_yield >= self.n_batches:
            self._shutdown()
            raise StopIteration
        timeout_s = self.loader.timeout or 600
        while self.next_yield not in self.reorder:
            batch_id, data, err = self._get(timeout_s)
            if err is not None:
                self._fail(f"DataLoader worker failed:\n{err}")
            if isinstance(data, tuple) and len(data) == 2 and \
                    data[0] == _SHM_MARKER:
                payload = self.rings[data[1]].pop(
                    timeout_ms=int(timeout_s * 1000))
                if payload is None:
                    self._fail("DataLoader: a worker closed its ring "
                               "before delivering an announced batch")
                rid, data = pickle.loads(payload)
                if rid != batch_id:
                    self._fail(f"DataLoader: ring out of step: expected "
                               f"batch {batch_id}, got {rid}")
                self.loader.transport["ring"] += 1
            else:
                self.loader.transport["queue"] += 1
            self.reorder[batch_id] = data
        data = self.reorder.pop(self.next_yield)
        self.next_yield += 1
        self._dispatch()
        return _tensor_ify(data)

    def _close_rings(self):
        for r in getattr(self, "rings", []):
            if r is not None:
                r.close()
        self.rings = []

    def _shutdown(self):
        for iq in self.index_queues:
            try:
                iq.put(None)
            except (OSError, ValueError):
                pass
        for w in self.workers:
            w.join(timeout=1)
            if w.is_alive():
                w.terminate()
                w.join(timeout=1)
        for iq in self.index_queues:
            # a worker that died unread leaves the dataset in the pipe:
            # exiting must not wait to flush it
            iq.cancel_join_thread()
            iq.close()
        self.workers, self.index_queues = [], []
        self._close_rings()

    def __del__(self):
        try:
            self._shutdown()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


class DataLoader:
    """``paddle.io.DataLoader``: ``batch_size``/``shuffle``/``drop_last``
    make a :class:`BatchSampler` unless ``batch_sampler`` is given; an
    ``IterableDataset`` is batched in the loop's process.
    ``feed_list``, ``places``, ``return_list``, ``use_buffer_reader``,
    ``prefetch_factor`` and ``persistent_workers`` are accepted and not
    read (each pass over the loader spawns its workers anew)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.use_shared_memory = bool(use_shared_memory)
        #: how each worker batch reached this process
        self.transport = {"ring": 0, "queue": 0}
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle,
                batch_size=batch_size if batch_size is not None else 1,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def __iter__(self):
        if self._iterable_mode:
            return self._iter_iterable()
        if self.num_workers > 0:
            return _MultiProcessIter(self)
        return self._iter_single()

    def _iter_single(self):
        for indices in self.batch_sampler:
            yield _fetch_batch(self.dataset, indices, self.collate_fn)

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)
