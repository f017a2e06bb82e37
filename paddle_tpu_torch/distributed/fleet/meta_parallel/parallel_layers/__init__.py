"""The parallel layers: tensor-parallel (:mod:`..mp_layers`), pipeline
(:mod:`.pp_layers`) and the RNG tracker (:mod:`.random`)."""
from ..mp_layers import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding,
)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc
from .random import (
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding", "LayerDesc",
           "PipelineLayer", "SharedLayerDesc", "RNGStatesTracker",
           "get_rng_state_tracker", "model_parallel_random_seed"]
