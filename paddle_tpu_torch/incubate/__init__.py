"""``paddle.incubate`` (port of ``paddle_tpu/incubate``): the segment ops
(:mod:`.tensor`), the graph and fused-softmax operators with the graph
samplers (:mod:`.operators`), ``LookAhead`` and ``ModelAverage``
(:mod:`.optimizer`), 2:4 sparsity (:mod:`.asp`), the functional autograd
(:mod:`.autograd`), MoE with expert parallelism
(:mod:`.distributed.models.moe`), the fused LM-head cross-entropy and
bias-dropout-residual layer norm of :mod:`..ops.fused`, and ``sparse``
(the port's :mod:`..sparse`, the 2.3-era import path
``paddle.incubate.sparse``)."""
from ..ops.fused import fused_bias_dropout_residual_layer_norm, \
    fused_linear_cross_entropy
from .. import sparse
from . import asp, autograd, distributed, operators, optimizer, tensor
from .operators import graph_khop_sampler, graph_reindex, \
    graph_sample_neighbors, graph_send_recv, softmax_mask_fuse, \
    softmax_mask_fuse_upper_triangle
from .optimizer import LookAhead, ModelAverage
from .tensor import segment_max, segment_mean, segment_min, segment_sum

__all__ = [
    "fused_linear_cross_entropy", "fused_bias_dropout_residual_layer_norm",
    "distributed", "sparse", "asp", "autograd", "operators", "optimizer",
    "tensor",
    "LookAhead", "ModelAverage",
    "softmax_mask_fuse_upper_triangle", "softmax_mask_fuse",
    "graph_send_recv", "graph_khop_sampler", "graph_sample_neighbors",
    "graph_reindex",
    "segment_sum", "segment_mean", "segment_max", "segment_min",
]
