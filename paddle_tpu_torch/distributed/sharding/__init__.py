"""``group_sharded_parallel``: the ZeRO user API.

Port of ``paddle_tpu/distributed/sharding/__init__.py``
(``group_sharded_parallel`` :27, ``save_group_sharded_model`` :49).
Each level is a stage of the hybrid optimizer's partition
(:mod:`..fleet.hybrid_optimizer`) over the sharding group of
``fleet.init``'s topology (its data group when the sharding degree is
1, as the JAX package falls back to the data axis), or over ``group``
(the world by default) without one:

- ``"os"``: each rank keeps the optimizer state of the parameters it
  owns and updates them; the parameters are then broadcast (stage 1);
- ``"os_g"``: the gradients are also reduced to their owner only, the
  other ranks drop theirs (stage 2);
- ``"p_g_os"``: the parameters too: between steps a rank keeps only the
  ones it owns, and the returned model (a ``ShardingParallel``) gathers
  the others back before each forward (stage 3).
"""
from __future__ import annotations

import os

from .. import collective
from ..fleet.hybrid_optimizer import HybridParallelOptimizer, gather_params
from ..fleet.meta_parallel.tensor_parallel import ShardingParallel
from ..fleet.topology import get_hybrid_communicate_group

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]

LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def group_sharded_parallel(model, optimizer, level: str = "os",
                           scaler=None, group=None, offload: bool = False,
                           sync_buffers: bool = False, buffer_max_size=None,
                           segment_size=None, sync_comm: bool = False):
    """``(model, optimizer, scaler)`` sharded at ``level`` (see the
    module)."""
    if level not in LEVELS:
        raise ValueError(f"level must be one of {tuple(LEVELS)}, got "
                         f"{level!r}")
    if offload:
        raise NotImplementedError(
            "group_sharded_parallel(offload=True): optimizer state on the "
            "host is not ported; it stays sharded in device memory")
    hcg = get_hybrid_communicate_group()
    dp = None
    if hcg is None:
        sharding = group or collective.new_group()
    elif hcg.get_sharding_parallel_world_size() > 1:
        sharding = hcg.get_sharding_parallel_group()
    else:
        # no sharding axis: the data axis shards, as in the JAX package
        sharding = hcg.get_data_parallel_group()
        dp = collective.Group([hcg.global_rank], gid=-1)
    if isinstance(optimizer, HybridParallelOptimizer):
        optimizer = optimizer._inner_opt     # a new policy replaces its
    optimizer = HybridParallelOptimizer(
        optimizer, hcg, sharding_stage=LEVELS[level],
        sharding_group=sharding, dp_group=dp)
    if level == "p_g_os":
        model = ShardingParallel(model, hcg)
    return model, optimizer, scaler


def save_group_sharded_model(model, output: str, optimizer=None) -> None:
    """Write the model's (and the optimizer's) state as format-2
    checkpoints under ``output/model`` (and ``output/opt``); a stage-3
    model's parameters are gathered first.  Load them with
    ``distributed.checkpoint.load_state_dict``."""
    from ..checkpoint import save_state_dict

    inner = getattr(model, "_layers", model)
    gather_params(inner.parameters())
    os.makedirs(output, exist_ok=True)
    save_state_dict(inner.state_dict(), os.path.join(output, "model"))
    if optimizer is not None:
        save_state_dict(optimizer.state_dict(), os.path.join(output, "opt"))
