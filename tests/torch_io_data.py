"""Datasets for the port's ``DataLoader`` worker tests.

This module imports numpy only, so the workers that the loader spawns
(which unpickle these datasets and import their module) never import JAX.
"""
import os

import numpy as np


class RangeDataset:
    """Sample ``i``: ``([i] as float32, i % 3)``."""

    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return np.array([i], dtype=np.float32), np.int64(i % 3)

    def __len__(self):
        return self.n


class WideDataset:
    """Sample ``i``: ``width`` float32 values of ``i`` and ``i``; a batch
    of ``width * 4 * batch`` bytes tests the ring's size rule."""

    def __init__(self, n, width):
        self.n, self.width = n, width

    def __getitem__(self, i):
        return np.full(self.width, i, dtype=np.float32), np.int64(i)

    def __len__(self):
        return self.n


class FailingDataset(RangeDataset):
    """Raises on sample ``bad``."""

    def __init__(self, n, bad):
        super().__init__(n)
        self.bad = bad

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError(f"sample {i} is bad")
        return super().__getitem__(i)


class WorkerProbe(RangeDataset):
    """Sample ``i``: ``(i, the worker's pid, whether torch is imported and
    CUDA initialised in the worker, CUDA_VISIBLE_DEVICES)``."""

    def __getitem__(self, i):
        import sys

        torch = sys.modules.get("torch")
        cuda_on = bool(torch is not None and torch.cuda.is_initialized())
        return (np.int64(i), np.int64(os.getpid()), np.int64(cuda_on),
                np.int64(os.environ.get("CUDA_VISIBLE_DEVICES", "?") == ""))
