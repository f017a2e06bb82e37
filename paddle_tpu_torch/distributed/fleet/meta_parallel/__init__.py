"""Tensor-parallel layers (:mod:`.mp_layers`)."""
from .mp_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    gather_last,
)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "gather_last"]
