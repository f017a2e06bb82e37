"""The fleet strategy object: one typed config for every parallelism knob.

Port of ``paddle_tpu/distributed/strategy.py`` (``DistributedStrategy``
:106 and its dataclasses): the hybrid degrees, the tensor-parallel,
sharding (ZeRO stage), pipeline, gradient-merge, LocalSGD, DGC, LARS, AMP,
recompute and MoE configs, and their boolean switches.  Assigning a dict
to a config updates the named fields and ignores unknown keys, as the JAX
package (and Paddle's proto wrapper) does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List

__all__ = ["DistributedStrategy", "HybridConfig", "AMPConfig",
           "TensorParallelConfig", "RecomputeConfig", "ShardingConfig",
           "PipelineConfig", "GradientMergeConfig", "LocalSGDConfig",
           "DGCConfig", "LarsConfig", "MoEConfig"]


@dataclass
class HybridConfig:
    dp_degree: int = -1       # -1: the world size over the other degrees
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1


@dataclass
class AMPConfig:
    enable: bool = False
    dtype: str = "bfloat16"
    level: str = "O1"
    init_loss_scaling: float = 32768.0
    incr_every_n_steps: int = 1000
    decr_every_n_nan_or_inf: int = 2
    incr_ratio: float = 2.0
    decr_ratio: float = 0.5
    use_dynamic_loss_scaling: bool = True
    custom_white_list: List[str] = field(default_factory=list)
    custom_black_list: List[str] = field(default_factory=list)


@dataclass
class TensorParallelConfig:
    tensor_init_seed: int = -1
    overlap_chunks: int = 1   # > 1: the chunked overlap schedule (refused)


@dataclass
class RecomputeConfig:
    enable: bool = False
    checkpoints: List[str] = field(default_factory=list)


@dataclass
class ShardingConfig:
    stage: int = 1            # 1: optimizer state, 2: + grads, 3: + params
    offload: bool = False


@dataclass
class PipelineConfig:
    accumulate_steps: int = 1
    micro_batch_size: int = 1
    schedule_mode: str = "1F1B"


@dataclass
class GradientMergeConfig:
    enable: bool = False
    k_steps: int = 1
    avg: bool = True


@dataclass
class LocalSGDConfig:
    k_steps: int = 1
    begin_step: int = 1


@dataclass
class DGCConfig:
    rampup_begin_step: int = 0
    rampup_step: int = 1
    sparsity: tuple = (0.999,)


@dataclass
class LarsConfig:
    lars_coeff: float = 0.001
    lars_weight_decay: float = 0.0005
    epsilon: float = 0.0
    exclude_from_weight_decay: List[str] = field(default_factory=list)


@dataclass
class MoEConfig:
    enable: bool = False
    num_experts: int = 1
    top_k: int = 2
    capacity_factor: float = 1.25


class DistributedStrategy:
    """``s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}``,
    ``s.gradient_merge = True``, ``s.gradient_merge_configs = {"k_steps":
    4}``, ..."""

    def __init__(self):
        self.hybrid_configs = HybridConfig()
        self.tensor_parallel_configs = TensorParallelConfig()
        self.amp_configs = AMPConfig()
        self.recompute_configs = RecomputeConfig()
        self.sharding_configs = ShardingConfig()
        self.pipeline_configs = PipelineConfig()
        self.gradient_merge_configs = GradientMergeConfig()
        self.localsgd_configs = LocalSGDConfig()
        self.dgc_configs = DGCConfig()
        self.lars_configs = LarsConfig()
        self.moe_configs = MoEConfig()
        self.amp = False
        self.recompute = False
        self.sharding = False
        self.gradient_merge = False
        self.localsgd = False
        self.dgc = False
        self.fp16_allreduce = False
        self.lars = False
        self.find_unused_parameters = False

    def __setattr__(self, name, value):
        cfg = self.__dict__.get(name)
        if isinstance(value, dict) and dataclasses.is_dataclass(cfg):
            for k, v in value.items():
                if hasattr(cfg, k):
                    setattr(cfg, k, v)
            return
        object.__setattr__(self, name, value)

    def __repr__(self):
        return f"DistributedStrategy({dict(self.__dict__)})"
