"""The port's ``io`` (datasets, samplers, ``DataLoader`` and its workers)
against the JAX package's, on the CPU.

Spec: ``tests/test_io.py``'s dataset, sampler and loader cases, run on
both packages with the batches compared.  Seeded shuffles (a
``RandomSampler(generator=seed)``, ``DistributedBatchSampler``'s epoch
seed, ``WeightedRandomSampler`` under ``np.random.seed``) give the JAX
package's batch order, the draws being the same numpy calls.  Two spawned
workers load through the shared-memory ring and through the queue, and
the loader's ``transport`` counts say which; each worker test sets
``DataLoader(timeout=)`` to a few seconds, so that a hang fails fast.
The worker tests' datasets live in ``tests/torch_io_data.py``, which
imports numpy only, so the spawned workers never import JAX.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import io as jio
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.io import dataloader as tdl
from torch_io_data import (
    FailingDataset, RangeDataset, WideDataset, WorkerProbe,
)

torch.set_num_threads(2)

#: seconds a worker test waits for a batch before it fails
WORKER_TIMEOUT = 20


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.numpy())


def _batches(loader):
    """Every batch as a list of numpy arrays."""
    out = []
    for b in loader:
        parts = b if isinstance(b, (list, tuple)) else [b]
        out.append([_np(p) for p in parts])
    return out


def _same_batches(jloader, tloader):
    jb, tb = _batches(jloader), _batches(tloader)
    assert len(jb) == len(tb)
    for j, t in zip(jb, tb):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            assert a.shape == b.shape
            np.testing.assert_array_equal(b, a)
    return tb


class JaxRange(jio.Dataset):
    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return np.array([i], dtype=np.float32), np.int64(i % 3)

    def __len__(self):
        return self.n


# ---- datasets --------------------------------------------------------------

def test_tensor_dataset():
    xs = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    ys = torch.arange(6)
    ds = tio.TensorDataset([xs, ys])
    assert len(ds) == 6
    x0, y0 = ds[2]
    np.testing.assert_allclose(_np(x0), [4, 5])
    assert int(y0) == 2
    with pytest.raises(ValueError):
        tio.TensorDataset([xs, ys[:3]])


def test_concat_and_subset():
    a, b = RangeDataset(3), RangeDataset(4)
    cat = tio.ConcatDataset([a, b])
    assert len(cat) == 7
    np.testing.assert_allclose(cat[5][0], [2])
    np.testing.assert_allclose(cat[-1][0], [3])
    sub = tio.Subset(b, [1, 3])
    assert len(sub) == 2
    np.testing.assert_allclose(sub[1][0], [3])


def test_compose_and_chain():
    comp = tio.ComposeDataset([RangeDataset(3), RangeDataset(5)])
    assert len(comp) == 3 and len(comp[1]) == 4

    class Stream(tio.IterableDataset):
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi

        def __iter__(self):
            return iter(range(self.lo, self.hi))

    # (a comprehension: list() would ask the iterable for its len())
    assert [v for v in tio.ChainDataset([Stream(0, 2), Stream(5, 7)])] == \
        [0, 1, 5, 6]
    with pytest.raises(RuntimeError):
        Stream(0, 1)[0]


@pytest.mark.parametrize("seed", [0, 7])
def test_random_split_matches_jax(seed):
    tr, va = tio.random_split(RangeDataset(10), [7, 3], generator=seed)
    jtr, jva = jio.random_split(JaxRange(10), [7, 3], generator=seed)
    assert len(tr) == 7 and len(va) == 3
    assert tr.indices == jtr.indices and va.indices == jva.indices
    with pytest.raises(ValueError):
        tio.random_split(RangeDataset(10), [7, 4])


# ---- samplers --------------------------------------------------------------

def test_batch_sampler():
    bs = tio.BatchSampler(RangeDataset(10), batch_size=3)
    assert [len(b) for b in bs] == [3, 3, 3, 1] and len(bs) == 4
    bs2 = tio.BatchSampler(RangeDataset(10), batch_size=3, drop_last=True)
    assert len(list(bs2)) == 3 == len(bs2)


def test_random_sampler_is_permutation():
    assert sorted(tio.RandomSampler(RangeDataset(8))) == list(range(8))


@pytest.mark.parametrize("replacement", [False, True])
def test_seeded_random_sampler_matches_jax(replacement):
    t = tio.RandomSampler(RangeDataset(12), replacement=replacement,
                          num_samples=9, generator=3)
    j = jio.RandomSampler(JaxRange(12), replacement=replacement,
                          num_samples=9, generator=3)
    assert list(t) == list(j) and len(t) == 9


def test_weighted_sampler_matches_jax():
    w = [0.1, 0.5, 0.2, 0.2]
    np.random.seed(4)
    t = list(tio.WeightedRandomSampler(w, 20))
    np.random.seed(4)
    j = list(jio.WeightedRandomSampler(w, 20))
    assert t == j and len(t) == 20


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_distributed_batch_sampler_matches_jax(shuffle, drop_last):
    for rank in range(3):
        t = tio.DistributedBatchSampler(RangeDataset(11), batch_size=2,
                                        num_replicas=3, rank=rank,
                                        shuffle=shuffle, drop_last=drop_last)
        j = jio.DistributedBatchSampler(JaxRange(11), batch_size=2,
                                        num_replicas=3, rank=rank,
                                        shuffle=shuffle, drop_last=drop_last)
        for epoch in (0, 1):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j) and len(t) == len(j)


def test_distributed_batch_sampler_partitions_and_pads():
    seen = []
    for rank in range(2):
        seen += [i for b in tio.DistributedBatchSampler(
            RangeDataset(8), batch_size=2, num_replicas=2, rank=rank)
            for i in b]
    assert sorted(seen) == list(range(8))
    total = [i for rank in range(2) for b in tio.DistributedBatchSampler(
        RangeDataset(7), batch_size=2, num_replicas=2, rank=rank) for i in b]
    assert len(total) == 8


def test_distributed_batch_sampler_reads_the_process_group(tmp_path,
                                                           monkeypatch):
    import torch.distributed as dist

    s = tio.DistributedBatchSampler(RangeDataset(8), batch_size=2)
    assert (s.nranks, s.local_rank) == (1, 0)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        s = tio.DistributedBatchSampler(RangeDataset(8), batch_size=2)
        assert (s.nranks, s.local_rank) == (1, 0)
        # what the group says is what the sampler takes
        monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
        monkeypatch.setattr(dist, "get_rank", lambda *a: 2)
        s = tio.DistributedBatchSampler(RangeDataset(8), batch_size=2)
        assert (s.nranks, s.local_rank) == (4, 2)
        assert list(s) == [[2, 6]]
        s = tio.DistributedBatchSampler(RangeDataset(8), batch_size=2,
                                        num_replicas=4, rank=3)
        assert (s.nranks, s.local_rank) == (4, 3)
    finally:
        dist.destroy_process_group()


# ---- the loader in the loop's process -------------------------------------

def test_basic_iteration_matches_jax():
    tb = _same_batches(jio.DataLoader(JaxRange(10), batch_size=4),
                       tio.DataLoader(RangeDataset(10), batch_size=4))
    assert len(tb) == 3 and tb[0][0].shape == (4, 1) and tb[0][1].shape == (4,)
    np.testing.assert_allclose(tb[0][0].ravel(), [0, 1, 2, 3])
    x, y = next(iter(tio.DataLoader(RangeDataset(10), batch_size=4)))
    assert x.dtype == torch.float32 and y.dtype == torch.int64
    assert x.device.type == "cpu"


def test_seeded_shuffle_gives_the_jax_batch_order():
    def loader(io_mod, ds):
        return io_mod.DataLoader(ds, batch_sampler=io_mod.BatchSampler(
            sampler=io_mod.RandomSampler(ds, generator=11), batch_size=3))

    tb = _same_batches(loader(jio, JaxRange(14)), loader(tio, RangeDataset(14)))
    order = [int(v) for b in tb for v in b[0].ravel()]
    assert sorted(order) == list(range(14)) and order != list(range(14))


def test_shuffle_covers_all():
    dl = tio.DataLoader(RangeDataset(12), batch_size=4, shuffle=True)
    seen = [int(v) for x, _ in dl for v in _np(x).ravel()]
    assert sorted(seen) == list(range(12))


def test_iterable_dataset():
    class Stream(tio.IterableDataset):
        def __iter__(self):
            for i in range(7):
                yield np.array([i], dtype=np.float32)

    assert [list(b.shape) for b in tio.DataLoader(Stream(), batch_size=3)] \
        == [[3, 1], [3, 1], [1, 1]]
    assert [list(b.shape) for b in tio.DataLoader(
        Stream(), batch_size=3, drop_last=True)] == [[3, 1], [3, 1]]
    with pytest.raises(TypeError):
        len(tio.DataLoader(Stream(), batch_size=3))


def test_collate_dict_and_tensors_match_jax():
    class DictDS:
        def __getitem__(self, i):
            return {"a": np.float32(i), "b": np.array([i, i], np.int64),
                    "c": [float(i), i]}

        def __len__(self):
            return 4

    tb = next(iter(tio.DataLoader(DictDS(), batch_size=2)))
    jb = next(iter(jio.DataLoader(DictDS(), batch_size=2)))
    assert list(tb["a"].shape) == [2] and list(tb["b"].shape) == [2, 2]
    for k in ("a", "b"):
        np.testing.assert_array_equal(_np(tb[k]), _np(jb[k]))
    for t, j in zip(tb["c"], jb["c"]):
        np.testing.assert_array_equal(_np(t), _np(j))
    tensors = [torch.full((2,), float(i)) for i in range(3)]
    out = tio.default_collate_fn(tensors)
    assert out.shape == (3, 2) and float(out[2, 0]) == 2.0


# ---- spawned workers ---------------------------------------------------------

def test_two_workers_through_the_ring_keep_the_order():
    dl = tio.DataLoader(RangeDataset(20), batch_size=5, num_workers=2,
                        timeout=WORKER_TIMEOUT)
    jb = _batches(jio.DataLoader(JaxRange(20), batch_size=5))
    tb = _batches(dl)
    assert len(tb) == len(jb) == 4
    for j, t in zip(jb, tb):
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b, a)
    assert dl.transport == {"ring": 4, "queue": 0}
    # a second pass spawns its workers anew and counts on
    assert len(_batches(dl)) == 4 and dl.transport["ring"] == 8


def test_two_workers_through_the_queue():
    dl = tio.DataLoader(RangeDataset(20), batch_size=5, num_workers=2,
                        use_shared_memory=False, timeout=WORKER_TIMEOUT)
    seen = [int(v) for x, _ in dl for v in _np(x).ravel()]
    assert seen == list(range(20))
    assert dl.transport == {"ring": 0, "queue": 4}


def test_a_batch_larger_than_the_ring_goes_through_the_queue(monkeypatch):
    # 1 MiB rings; a batch of 4 samples of 80,000 float32 is 1.28 MB
    monkeypatch.setattr(tdl, "_ring_capacity", lambda n: 1024 * 1024)
    dl = tio.DataLoader(WideDataset(10, 80_000), batch_size=4,
                        num_workers=2, timeout=WORKER_TIMEOUT)
    batches = _batches(dl)
    assert [b[0].shape for b in batches] == [(4, 80_000)] * 2 + \
        [(2, 80_000)]
    assert [int(b[1][0]) for b in batches] == [0, 4, 8]
    # the last batch (2 samples, 640 KB) fits
    assert dl.transport == {"ring": 1, "queue": 2}


def test_worker_error_reaches_the_parent():
    dl = tio.DataLoader(FailingDataset(10, 7), batch_size=2, num_workers=2,
                        timeout=WORKER_TIMEOUT)
    with pytest.raises(RuntimeError, match="sample 7 is bad"):
        list(dl)


def test_workers_run_apart_without_cuda():
    """Each batch comes from one of two worker processes, neither of
    which initialised CUDA; the cards are hidden from them."""
    import os

    dl = tio.DataLoader(WorkerProbe(8), batch_size=2, num_workers=2,
                        timeout=WORKER_TIMEOUT)
    batches = _batches(dl)
    assert [int(v) for b in batches for v in b[0]] == list(range(8))
    pids = {int(v) for b in batches for v in b[1]}
    assert len(pids) == 2 and os.getpid() not in pids
    assert all((b[2] == 0).all() and (b[3] == 1).all() for b in batches)
