"""``paddle.distributed.fleet``: the hybrid-parallel user API.

Port of ``paddle_tpu/distributed/fleet/__init__.py`` (``init`` :36,
``distributed_model`` :83, ``distributed_optimizer`` :107, the worker
helpers, the role makers and ``UtilBase``) for one process per rank:

- :func:`init` makes the world from the launcher's contract when there is
  one (:func:`..parallel.init_parallel_env`; NCCL on the card, gloo with
  ``device="cpu"``) and the five-axis topology ``[data, pipe, sharding,
  sep, model]`` over it (``dp_degree=-1``: the world over the other
  degrees).  A strategy whose degrees ask for more ranks than the world
  has raises ``ValueError``.  Under ``sep_degree > 1`` each rank keeps a
  chunk of the sequence (:func:`shard_sequence`), attention runs the ring
  over the sep group (:mod:`...ops.ring_attention`), the loss is the
  token-weighted mean over the sep group, and gradients are averaged over
  data x sharding x sep.  Still refused (``NotImplementedError``,
  ROADMAP.md A.5 step 6): ``tensor_parallel_configs.overlap_chunks > 1``.
- :func:`distributed_model` wraps the model for the topology: a
  :class:`PipelineLayer` over a pipe degree above 1 in the pipeline
  engine, a ZeRO stage-3 model in ``ShardingParallel``, any other in
  ``TensorParallel``.
- :func:`distributed_optimizer` wraps in the JAX order: LARS (a
  ``Momentum`` becomes ``Lars``), the hybrid optimizer, then gradient
  merge, LocalSGD and the fp16 all-reduce.  ``strategy.dgc`` raises:
  construct ``DGCMomentumOptimizer`` directly, as in the JAX package.

In one process with no launcher (no world, or a world of one that no
launcher made), the wrappers are left out: the model and the optimizer
come back as they are (the meta-optimizers still wrap), as Paddle does
for one worker.  A launched world of one gets the wrappers, which then
run nothing but the wrapped step.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import collective
from ..env import ParallelEnv, get_rank, get_world_size
from ..parallel import init_parallel_env
from ..strategy import DistributedStrategy
from . import elastic, meta_parallel, utils
from .hybrid_optimizer import HybridParallelOptimizer
from .meta_parallel import (
    PipelineLayer, PipelineParallel, ShardingParallel, TensorParallel,
)
from .meta_parallel.tensor_parallel import (
    place_parameters, shard_batch, shard_sequence,
)
from .recompute import recompute
from .topology import (
    HYBRID_AXES, CommunicateTopology, HybridCommunicateGroup, ParallelMode,
    get_hybrid_communicate_group, set_hybrid_communicate_group,
)

__all__ = ["DistributedStrategy", "init", "is_initialized",
           "distributed_model", "distributed_optimizer", "recompute",
           "get_hybrid_communicate_group", "get_hybrid_parallel_strategy",
           "worker_num", "worker_index", "barrier_worker", "Role",
           "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "UtilBase",
           "util", "Fleet", "CommunicateTopology", "HybridCommunicateGroup",
           "ParallelMode", "HybridParallelOptimizer", "TensorParallel",
           "ShardingParallel", "PipelineLayer", "PipelineParallel",
           "meta_parallel", "utils", "place_parameters", "shard_batch",
           "shard_sequence", "elastic"]

_fleet_initialized = False
_user_strategy: Optional[DistributedStrategy] = None


def _refuse(strategy: DistributedStrategy) -> None:
    if strategy.tensor_parallel_configs.overlap_chunks > 1:
        raise NotImplementedError(
            "fleet: tensor_parallel_configs.overlap_chunks > 1 (the chunked "
            "TP overlap schedule) is not ported (ROADMAP.md A.5 step 6)")


def _distributed() -> bool:
    """Whether the wrappers apply: a world of several ranks, or one a
    launcher made."""
    return dist.is_initialized() and (dist.get_world_size() > 1
                                      or ParallelEnv().launched)


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None,
         device="cuda") -> None:
    """Make the world (when launched) and the hybrid topology from
    ``strategy.hybrid_configs`` (see the module)."""
    global _fleet_initialized, _user_strategy
    strategy = strategy or DistributedStrategy()
    _refuse(strategy)
    if dist.is_initialized() or ParallelEnv().launched:
        init_parallel_env(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    hc = strategy.hybrid_configs
    rest = hc.pp_degree * hc.sharding_degree * hc.sep_degree * hc.mp_degree
    dp = hc.dp_degree
    if dp <= 0:
        if world % rest:
            raise ValueError(f"pp x sharding x sep x mp = {rest} does not "
                             f"divide the world of {world}")
        dp = world // rest
    if dp * rest != world:
        raise ValueError(
            f"hybrid degrees dp={dp} pp={hc.pp_degree} "
            f"sharding={hc.sharding_degree} sep={hc.sep_degree} "
            f"mp={hc.mp_degree} multiply to {dp * rest}, but the world has "
            f"{world} rank(s)")
    topo = CommunicateTopology(HYBRID_AXES, [dp, hc.pp_degree,
                                             hc.sharding_degree,
                                             hc.sep_degree, hc.mp_degree])
    set_hybrid_communicate_group(HybridCommunicateGroup(topo))
    _user_strategy = strategy
    _fleet_initialized = True


def is_initialized() -> bool:
    return _fleet_initialized


def get_hybrid_parallel_strategy() -> Optional[DistributedStrategy]:
    return _user_strategy


def distributed_model(model):
    """The model wrapped for the topology (see the module)."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        init()
        hcg = get_hybrid_communicate_group()
    if not _distributed():
        return model
    s = _user_strategy
    if isinstance(model, PipelineLayer) and \
            hcg.get_pipe_parallel_world_size() > 1:
        return PipelineParallel(model, hcg, s)
    if s is not None and s.sharding_configs.stage >= 3 and \
            hcg.get_sharding_parallel_world_size() > 1:
        return ShardingParallel(model, hcg, s)
    return TensorParallel(model, hcg, s)


def distributed_optimizer(optimizer,
                          strategy: Optional[DistributedStrategy] = None):
    """The optimizer wrapped in the JAX order (see the module)."""
    s = strategy or _user_strategy
    if s is not None:
        _refuse(s)
    if s is not None and s.lars:
        from ...optimizer import Lars, Momentum

        if isinstance(optimizer, Momentum) and not isinstance(optimizer,
                                                              Lars):
            cfg = s.lars_configs
            names = optimizer._names
            params = [(names[id(p)], p) if id(p) in names else p
                      for g in optimizer.param_groups for p in g["params"]]
            optimizer = Lars(
                params, lr=optimizer._learning_rate,
                momentum=optimizer.param_groups[0]["momentum"],
                lars_coeff=cfg.lars_coeff,
                lars_weight_decay=cfg.lars_weight_decay,
                epsilon=cfg.epsilon,
                exclude_from_weight_decay=cfg.exclude_from_weight_decay,
                grad_clip=optimizer._grad_clip)
        elif not isinstance(optimizer, Lars):
            raise ValueError(
                "strategy.lars needs a Momentum inner optimizer; construct "
                "optimizer.Lars directly for other cases")
    opt = optimizer
    hcg = get_hybrid_communicate_group()
    if hcg is not None and _distributed():
        opt = HybridParallelOptimizer(opt, hcg, s)
    if s is not None and s.gradient_merge:
        from .meta_optimizers import GradientMergeOptimizer

        cfg = s.gradient_merge_configs
        opt = GradientMergeOptimizer(opt, k_steps=cfg.k_steps, avg=cfg.avg)
    if s is not None and s.localsgd:
        from .meta_optimizers import LocalSGDOptimizer

        opt = LocalSGDOptimizer(opt, k_steps=s.localsgd_configs.k_steps)
    if s is not None and s.fp16_allreduce:
        from .meta_optimizers import FP16AllReduceOptimizer

        opt = FP16AllReduceOptimizer(opt)
    if s is not None and s.dgc:
        raise ValueError(
            "strategy.dgc: construct DGCMomentumOptimizer directly (it "
            "replaces the inner momentum optimizer rather than wrapping "
            "an arbitrary one, as in the JAX package)")
    return opt


# -- worker info ---------------------------------------------------------------

def worker_num() -> int:
    return get_world_size()


def worker_index() -> int:
    return get_rank()


def barrier_worker() -> None:
    if dist.is_initialized():
        collective.barrier()


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class PaddleCloudRoleMaker:
    """Collective role maker: rank and size from the world; the
    parameter-server roles are descoped."""

    def __init__(self, is_collective: bool = True, **kwargs):
        if not is_collective:
            raise NotImplementedError(
                "parameter-server roles are descoped (see README); use "
                "is_collective=True")
        self._is_collective = True

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def role(self):
        return Role.WORKER


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, is_collective: bool = True, init_gloo: bool = False,
                 **kwargs):
        super().__init__(is_collective=is_collective)


class UtilBase:
    """Cross-worker helpers on host values."""

    def all_reduce(self, input, mode: str = "sum"):
        if mode not in ("sum", "max", "min"):
            raise ValueError(f"unknown mode {mode}")
        arr = np.asarray(input)
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return arr
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        t = torch.as_tensor(arr).to(dev)
        collective.all_reduce(t, {"sum": collective.ReduceOp.SUM,
                                  "max": collective.ReduceOp.MAX,
                                  "min": collective.ReduceOp.MIN}[mode])
        return t.cpu().numpy()

    def barrier(self, comm_world: str = "worker"):
        barrier_worker()

    def get_file_shard(self, files):
        return list(files)[worker_index()::worker_num()]

    def print_on_rank(self, message, rank_id: int = 0):
        if worker_index() == rank_id:
            print(message)


util = UtilBase()


class Fleet:
    """Paddle's ``fleet.Fleet``: this module is the default instance, and
    ``Fleet()`` answers with its functions."""

    def __getattr__(self, name):
        import sys

        return getattr(sys.modules[__name__], name)


def _ps_descoped_gen(name):
    def ctor(*a, **k):
        raise NotImplementedError(
            f"fleet.{name} is part of the parameter-server data pipeline, "
            "which is descoped (see README)")

    return ctor


MultiSlotDataGenerator = _ps_descoped_gen("MultiSlotDataGenerator")
MultiSlotStringDataGenerator = _ps_descoped_gen(
    "MultiSlotStringDataGenerator")
