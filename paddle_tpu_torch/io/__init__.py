"""``paddle.io``: datasets, samplers and the ``DataLoader``.

Port of ``paddle_tpu/io``.  The loader yields CPU tensors; with
``num_workers > 0`` spawned workers hand their batches over through the
port's shared-memory ring (:mod:`.native`, ``shm_ring.cc``).
"""
from .dataloader import (
    DataLoader, WorkerInfo, default_collate_fn, get_worker_info,
)
from .dataset import (
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, random_split,
)
from .sampler import (
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler,
    SequenceSampler, WeightedRandomSampler,
)

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset",
           "ConcatDataset", "DataLoader", "Dataset",
           "DistributedBatchSampler", "IterableDataset", "RandomSampler",
           "Sampler", "SequenceSampler", "Subset", "TensorDataset",
           "WeightedRandomSampler", "WorkerInfo", "default_collate_fn",
           "get_worker_info", "random_split"]
