"""The launcher's environment contract, and this process's rank.

Port of ``paddle_tpu/distributed/env.py``: ``ParallelEnv`` (:13) reads
what ``python -m paddle_tpu_torch.distributed.launch`` sets for each
worker: ``PADDLE_TRAINER_ID`` (the global rank), ``PADDLE_TRAINERS_NUM``
(the world size), ``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_MASTER`` (the rendezvous ``host:port``) and
``PADDLE_LOCAL_RANK`` (the worker's index on its node, which picks its
card).  Once a ``torch.distributed`` world exists, :func:`get_rank` and
:func:`get_world_size` answer from it.
"""
from __future__ import annotations

import os

import torch.distributed as dist

__all__ = ["ParallelEnv", "get_rank", "get_world_size", "is_initialized"]


class ParallelEnv:
    """The contract as the environment holds it now."""

    def __init__(self):
        self.rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self.device_id = int(os.environ.get(
            "PADDLE_LOCAL_RANK", os.environ.get("FLAGS_selected_gpus", "0")))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self.trainer_endpoints = eps.split(",") if eps else []
        self.current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        self.master = os.environ.get(
            "PADDLE_MASTER",
            self.trainer_endpoints[0] if self.trainer_endpoints else "")

    @property
    def launched(self) -> bool:
        """Whether a launcher set the contract (a rendezvous is named)."""
        return "PADDLE_TRAINERS_NUM" in os.environ and bool(self.master)

    @property
    def local_rank(self) -> int:
        return self.device_id

    @property
    def nranks(self) -> int:
        return self.world_size

    @property
    def dev_id(self) -> int:
        return self.device_id


def is_initialized() -> bool:
    """Whether a ``torch.distributed`` world exists."""
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    """This process's global rank: the world's, else the contract's."""
    if is_initialized():
        return dist.get_rank()
    return ParallelEnv().rank


def get_world_size(group=None) -> int:
    """The world size: the world's, else the contract's."""
    if is_initialized():
        return dist.get_world_size()
    return ParallelEnv().world_size
