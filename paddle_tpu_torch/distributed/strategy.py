"""The fleet strategy object (``paddle_tpu/distributed/strategy.py``
``DistributedStrategy``), as far as one process on one card reads it: the
hybrid degrees."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = ["DistributedStrategy", "HybridConfig"]


@dataclass
class HybridConfig:
    dp_degree: int = -1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1


class DistributedStrategy:
    """``s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1}`` updates the
    named degrees and ignores unknown keys, as the JAX package does."""

    def __init__(self):
        self.hybrid_configs = HybridConfig()

    def __setattr__(self, name, value):
        cfg = self.__dict__.get(name)
        if isinstance(value, dict) and dataclasses.is_dataclass(cfg):
            for k, v in value.items():
                if hasattr(cfg, k):
                    setattr(cfg, k, v)
            return
        object.__setattr__(self, name, value)
