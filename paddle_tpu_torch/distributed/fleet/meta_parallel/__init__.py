"""``fleet.meta_parallel``: the tensor-parallel layers (:mod:`.mp_layers`),
the pipeline description and engine (:mod:`.parallel_layers.pp_layers`,
:mod:`.pipeline_parallel`, :mod:`.pp_schedule`), the RNG tracker and the
model wrappers (:mod:`.tensor_parallel`)."""
from .mp_layers import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, gather_last,
)
from .parallel_layers import (
    LayerDesc, PipelineLayer, RNGStatesTracker, SharedLayerDesc,
    get_rng_state_tracker, model_parallel_random_seed,
)
from .pipeline_parallel import PipelineParallel
from .tensor_parallel import ShardingParallel, TensorParallel

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding", "gather_last",
           "LayerDesc", "PipelineLayer", "SharedLayerDesc",
           "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "PipelineParallel",
           "ShardingParallel", "TensorParallel"]
