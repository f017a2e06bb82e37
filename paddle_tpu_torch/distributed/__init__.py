"""paddle_tpu_torch.distributed: Paddle's distributed surface over
``torch.distributed``, one process per rank (NCCL on the card, gloo on the
CPU).

Port of ``paddle_tpu/distributed/__init__.py``: the launcher's contract
and the world (:mod:`.env`, :func:`init_parallel_env`), the functional
collectives and groups (:mod:`.collective`), ``DataParallel``
(:mod:`.parallel`), ``fleet`` with the hybrid topology, the
tensor-parallel and pipeline layers, the hybrid and meta optimizers
(:mod:`.fleet`), ZeRO (:mod:`.sharding`), the launcher (:mod:`.launch`),
:func:`spawn`, :func:`wait`, :func:`split`, the ``gloo_*`` helpers, the
parameter-server names (which raise, as in the JAX package), fault
tolerance (:mod:`.fault_tolerance`, with the elastic mesh watchdog), the
format-2 checkpoints (:mod:`.checkpoint`), the elastic resharding proofs
and data schedule (:mod:`.reshard`), semi-automatic parallelism on
DTensor (:mod:`.auto_parallel`: ``ProcessMesh``, ``shard_tensor``,
``shard_op``, ``Engine``), and the meshes and sharding annotations
(:mod:`.mesh`, :mod:`.sharding_spec`).
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from . import (
    auto_parallel, checkpoint, fault_tolerance, fleet, launch, reshard,
    sharding,
)
from .auto_parallel import Engine, ProcessMesh, shard_op, shard_tensor
from .collective import (
    Group, ReduceOp, all_gather, all_reduce, all_reduce_chunked, alltoall,
    barrier, broadcast, get_group, new_group, ppermute, recv, reduce,
    reduce_scatter, scatter, send,
)
from .env import ParallelEnv, get_rank, get_world_size, is_initialized
from .fleet.topology import ParallelMode
from .mesh import (
    HYBRID_AXES, axis_size, get_global_mesh, hybrid_mesh, set_global_mesh,
)
from .parallel import DataParallel, init_parallel_env
from .reshard import (
    ElasticDataSchedule, diff_digests, state_digests, tensor_digest,
    verify_resharded, world_descriptor,
)
from .sharding_spec import (
    batch_spec, get_param_spec, mark_sharding, set_param_spec,
    shard_parameter,
)
from .strategy import DistributedStrategy

__all__ = ["DistributedStrategy", "ParallelEnv", "get_rank",
           "get_world_size", "is_initialized", "init_parallel_env",
           "DataParallel", "ReduceOp", "Group", "new_group", "get_group",
           "all_reduce", "all_reduce_chunked", "all_gather", "broadcast",
           "reduce", "scatter", "alltoall", "reduce_scatter", "barrier",
           "send", "recv", "ppermute", "spawn", "wait", "split",
           "gloo_init_parallel_env", "gloo_barrier", "gloo_release",
           "ParallelMode", "checkpoint", "fault_tolerance", "fleet",
           "launch", "sharding", "InMemoryDataset", "QueueDataset",
           "CountFilterEntry", "ProbabilityEntry", "ShowClickEntry",
           "auto_parallel", "ProcessMesh", "shard_tensor", "shard_op",
           "Engine", "reshard", "tensor_digest", "state_digests",
           "diff_digests", "verify_resharded", "world_descriptor",
           "ElasticDataSchedule", "mark_sharding", "shard_parameter",
           "set_param_spec", "get_param_spec", "batch_spec", "hybrid_mesh",
           "axis_size", "HYBRID_AXES", "get_global_mesh", "set_global_mesh"]


def _spawn_entry(rank: int, nprocs: int, master: str, func, args) -> None:
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_LOCAL_RANK": str(rank),
        "PADDLE_TRAINERS_NUM": str(nprocs), "PADDLE_MASTER": master,
        "PADDLE_TRAINER_ENDPOINTS": ",".join([master] * nprocs),
        "PADDLE_CURRENT_ENDPOINT": master, "FLAGS_selected_gpus": str(rank)})
    func(*args)


def spawn(func, args=(), nprocs: int = -1, join: bool = True,
          daemon: bool = False, **options):
    """Run ``func(*args)`` in ``nprocs`` new processes (default: one per
    card, else one), each with the launcher's contract for its rank, so
    ``init_parallel_env`` inside ``func`` joins them into one world.
    Returns ``torch.multiprocessing``'s context (joined when ``join``)."""
    import torch.multiprocessing as mp

    if nprocs < 1:
        nprocs = max(torch.cuda.device_count(), 1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        master = f"127.0.0.1:{s.getsockname()[1]}"
    return mp.start_processes(_spawn_entry,
                              args=(nprocs, master, func, tuple(args)),
                              nprocs=nprocs, join=join, daemon=daemon,
                              start_method="spawn")


def wait(tensor: torch.Tensor, group=None, use_calc_stream: bool = True
         ) -> None:
    """Block until the work that makes ``tensor`` is done (the
    collectives here are synchronous; a card's stream is synchronised)."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


def split(x, size, operation: str, axis: int = 0, num_partitions: int = 1,
          gather_out: bool = True, weight_attr=None, bias_attr=None,
          name=None):
    """The layer of Paddle's auto tensor parallelism, split over the model
    group (as the JAX package, this returns the layer):
    ``"embedding"`` a ``VocabParallelEmbedding(*size)``; ``"linear"`` a
    ``RowParallelLinear`` (``axis=0``) or a ``ColumnParallelLinear``."""
    from .fleet.meta_parallel import mp_layers

    if operation == "embedding":
        return mp_layers.VocabParallelEmbedding(size[0], size[1])
    if operation == "linear":
        if axis == 0:
            return mp_layers.RowParallelLinear(
                size[0], size[1], bias_attr is not False,
                input_is_parallel=not gather_out)
        return mp_layers.ColumnParallelLinear(
            size[0], size[1], bias_attr is not False,
            gather_output=gather_out)
    raise ValueError(f"split: unsupported operation {operation!r} "
                     "(embedding/linear)")


_gloo_world = [False]


def gloo_init_parallel_env(rank_id: int, rank_num: int,
                           server_endpoint: str) -> None:
    """A gloo world of ``rank_num`` ranks at ``server_endpoint``
    (``host:port``) when no world exists."""
    if not dist.is_initialized():
        from .mesh import GROUP_TIMEOUT

        dist.init_process_group("gloo", init_method=f"tcp://{server_endpoint}",
                                rank=rank_id, world_size=rank_num,
                                timeout=GROUP_TIMEOUT)
        _gloo_world[0] = True


def gloo_barrier() -> None:
    barrier()


def gloo_release() -> None:
    """End the world :func:`gloo_init_parallel_env` made."""
    if _gloo_world[0] and dist.is_initialized():
        dist.destroy_process_group()
        _gloo_world[0] = False


def _ps_descoped(name):
    raise NotImplementedError(
        f"paddle.distributed.{name} belongs to the parameter-server "
        "training stack, which is descoped: giant embeddings are "
        "vocabulary-parallel embeddings with ZeRO instead (see README)")


class InMemoryDataset:
    def __init__(self, *a, **k):
        _ps_descoped("InMemoryDataset")


class QueueDataset:
    def __init__(self, *a, **k):
        _ps_descoped("QueueDataset")


class CountFilterEntry:
    def __init__(self, *a, **k):
        _ps_descoped("CountFilterEntry")


class ProbabilityEntry:
    def __init__(self, *a, **k):
        _ps_descoped("ProbabilityEntry")


class ShowClickEntry:
    def __init__(self, *a, **k):
        _ps_descoped("ShowClickEntry")
