"""The pipeline model description: ``LayerDesc``, ``SharedLayerDesc`` and
``PipelineLayer``.

Port of ``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/
pp_layers.py`` (``LayerDesc`` :21, ``SharedLayerDesc`` :38,
``PipelineLayer`` :67) for one process per stage, as in Paddle: the layer
list is cut into ``num_stages * num_virtual_pipeline_stages`` chunks, local
chunk ``c`` of stage ``s`` is global chunk ``c * num_stages + s``, and a
rank builds only the layers of its own chunks (a ``LayerDesc`` is built
where it is needed; a layer given built is kept where it belongs).

Cutting: a list of ``chunks + 1`` bounds is taken as it is; ``"layer:X"``
cuts before evenly spaced layers of class ``X``; ``"uniform"`` cuts the
longest run of layers of one class into equal chunks when it divides
(the layers before it join the first chunk, those after it the last, as
the JAX engine runs a prologue and an epilogue around its uniform body),
else the whole list by count.  Interleaving needs that run to divide
into ``num_stages * v`` chunks and the micro-batches
(``pipeline_configs.accumulate_steps``) into ``num_stages``; otherwise
``v`` falls back to 1, as in the JAX engine.

A built layer is registered under its global index (``"3"``), so state
dict names are the JAX ``PipelineLayer``'s.  A ``SharedLayerDesc`` is
built once per rank under ``shared_layers.<key>``; the stages that hold
it each keep a copy, broadcast from the first such stage when the model
is wrapped, whose ``shared_weight_attr`` gradients the engine
all-reduces between those stages after the backward (the copies on later
stages carry ``_pp_shared_copy`` so a global-norm clip counts the weight
once).  Without a pipe degree above 1 the layer holds every layer and
``forward`` runs them in order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ...recompute import recompute

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    """A layer built where its stage runs: ``layer_func(*inputs,
    **kwargs)``."""

    def __init__(self, layer_func, *inputs, **kwargs):
        if not (isinstance(layer_func, type)
                and issubclass(layer_func, nn.Module)):
            raise TypeError("LayerDesc expects an nn.Module subclass")
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self) -> nn.Module:
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer shared between stages under ``key`` (tied embeddings):
    each use runs ``forward_func(layer, *args)`` (the layer's own forward
    when None); ``shared_weight_attr`` names its shared parameter (a
    dotted path)."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr: str = "weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _SharedUse:
    """One use of a shared layer (not a module: the layer is registered
    once, under ``shared_layers``)."""

    def __init__(self, layer: nn.Module, forward_func):
        self.layer = layer
        self.forward_func = forward_func

    def __call__(self, *args):
        if self.forward_func is None:
            return self.layer(*args)
        return self.forward_func(self.layer, *args)


def _kind(d) -> Optional[str]:
    if isinstance(d, LayerDesc):
        return d.layer_func.__name__
    return type(d).__name__ if isinstance(d, nn.Module) else None


def _uniform_run(descs) -> tuple:
    """``(start, end)`` of the longest run of layers of one class."""
    kinds = [_kind(d) for d in descs]
    best, i = (0, 0), 0
    while i < len(kinds):
        if kinds[i] is None:
            i += 1
            continue
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        if j - i > best[1] - best[0]:
            best = (i, j)
        i = j
    return best


def _attr(module: nn.Module, path: str):
    for part in path.split("."):
        module = getattr(module, part)
    return module


class PipelineLayer(nn.Module):
    """Paddle's ``PipelineLayer(layers, num_stages=None, topology=None,
    loss_fn=None, seg_method="uniform", recompute_interval=0,
    num_virtual_pipeline_stages=None)``: see the module."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method="uniform",
                 recompute_interval: int = 0, recompute_ctx=None,
                 num_virtual_pipeline_stages: Optional[int] = None):
        super().__init__()
        from ...topology import get_hybrid_communicate_group

        self._loss_fn = loss_fn
        self._recompute_interval = int(recompute_interval)
        self._descs = list(layers)
        self._num_stages = topology.get_dim("pipe") if topology is not None \
            else int(num_stages or 1)
        hcg = get_hybrid_communicate_group()
        pipelined = hcg is not None and self._num_stages > 1 and \
            hcg.get_pipe_parallel_world_size() == self._num_stages
        self._stage = hcg.get_stage_id() if pipelined else None
        self._hcg = hcg if pipelined else None
        v = int(num_virtual_pipeline_stages or 1)
        if v > 1 and not self._interleavable(v):
            v = 1
        self._num_virtual = v
        self.segment_parts = self._segment_network(seg_method)
        self.shared_layers = nn.ModuleDict()
        self._shared_descs: Dict[str, SharedLayerDesc] = {}
        self._shared_stages: Dict[str, List[int]] = {}
        #: local chunk -> [(global index, callable)]
        self._chunks: List[List[tuple]] = []
        for c in range(self._local_chunks()):
            g = self._global_chunk(c)
            lo, hi = self.segment_parts[g], self.segment_parts[g + 1]
            self._chunks.append([(i, self._build(i)) for i in range(lo, hi)])
        # every shared key's stages, on every rank (its groups are made
        # collectively, whether this rank holds the key or not)
        for i, x in enumerate(self._descs):
            if isinstance(x, SharedLayerDesc):
                self._shared_stages.setdefault(x.layer_name, set()).add(
                    self._chunk_of(i) % self._num_stages)
        self._shared_stages = {k: sorted(v)
                               for k, v in self._shared_stages.items()}
        self._shared_groups = self._make_shared_groups()
        self.run_function = [f for chunk in self._chunks for _, f in chunk]

    # -- cutting ---------------------------------------------------------------

    def _interleavable(self, v: int) -> bool:
        from ... import get_hybrid_parallel_strategy

        start, end = _uniform_run(self._descs)
        strategy = get_hybrid_parallel_strategy()
        micro = strategy.pipeline_configs.accumulate_steps \
            if strategy is not None else 1
        return (end - start) % (self._num_stages * v) == 0 and \
            end - start >= self._num_stages * v and \
            micro % self._num_stages == 0

    def _segment_network(self, seg_method) -> List[int]:
        n = len(self._descs)
        k = self._num_stages * self._num_virtual
        if isinstance(seg_method, (list, tuple)):
            parts = [int(x) for x in seg_method]
            if len(parts) != k + 1:
                raise ValueError(f"seg_method: {len(parts)} bounds for "
                                 f"{k} chunks")
            return parts
        if isinstance(seg_method, str) and seg_method.startswith("layer:"):
            name = seg_method.split(":", 1)[1]
            marks = [i for i, d in enumerate(self._descs)
                     if _kind(d) == name]
            if len(marks) >= k:
                return [0] + [marks[int(round(len(marks) / k * s))]
                              for s in range(1, k)] + [n]
        start, end = _uniform_run(self._descs)
        run = end - start
        if run >= k and run % k == 0:
            return [0] + [start + run // k * s for s in range(1, k)] + [n]
        return [int(round(n / k * s)) for s in range(k)] + [n]

    def _local_chunks(self) -> int:
        return self._num_virtual if self._stage is not None else \
            self._num_stages * self._num_virtual

    def _global_chunk(self, c: int) -> int:
        return c if self._stage is None else \
            c * self._num_stages + self._stage

    def _chunk_of(self, index: int) -> int:
        for g in range(len(self.segment_parts) - 1):
            if self.segment_parts[g] <= index < self.segment_parts[g + 1]:
                return g
        return len(self.segment_parts) - 2

    def get_stage_from_index(self, layer_idx: int) -> int:
        return self._chunk_of(layer_idx) % self._num_stages

    # -- building --------------------------------------------------------------

    def _build(self, i: int):
        d = self._descs[i]
        if isinstance(d, SharedLayerDesc):
            if d.layer_name not in self.shared_layers:
                self.shared_layers[d.layer_name] = d.build_layer()
                self._shared_descs[d.layer_name] = d
            return _SharedUse(self.shared_layers[d.layer_name],
                              d.forward_func)
        layer = d.build_layer() if isinstance(d, LayerDesc) else d
        if isinstance(layer, nn.Module):
            self.add_module(str(i), layer)
        return layer

    def _make_shared_groups(self) -> Dict[str, object]:
        """For each shared key held by more than one stage: the group of
        this rank and its peers on those stages (made on every rank in one
        order); the copies past the first stage are marked."""
        from .... import collective

        groups = {}
        if self._hcg is None:
            return groups
        topo = self._hcg.topology()
        for key in sorted(self._shared_stages):
            stages = self._shared_stages[key]
            if len(stages) < 2:
                continue
            for ranks in topo.get_comm_list("pipe"):
                members = [ranks[s] for s in stages]
                g = collective.new_group(members)
                if self._hcg.global_rank in members:
                    groups[key] = g
            if key in self.shared_layers and self._stage != stages[0]:
                w = _attr(self.shared_layers[key],
                          self._shared_descs[key].shared_weight_attr)
                w._pp_shared_copy = True
        return groups

    @torch.no_grad()
    def sync_shared_weights(self) -> None:
        """Broadcast each shared weight from its first stage's copy."""
        from .... import collective

        for key, g in self._shared_groups.items():
            w = _attr(self.shared_layers[key],
                      self._shared_descs[key].shared_weight_attr)
            collective.broadcast(w.data, g.ranks[0], g)

    @torch.no_grad()
    def allreduce_shared_weight_gradients(self) -> None:
        """Sum each shared weight's gradient over the stages that use it
        (a stage whose copy got none adds zeros)."""
        from .... import collective

        for key, g in self._shared_groups.items():
            w = _attr(self.shared_layers[key],
                      self._shared_descs[key].shared_weight_attr)
            if w.grad is None:
                w.grad = torch.zeros_like(w)
            collective.all_reduce(w.grad, group=g)

    # -- running ---------------------------------------------------------------

    def _run(self, layers, x):
        for j, (i, layer) in enumerate(layers):
            args = x if isinstance(x, tuple) else (x,)
            if self._recompute_interval > 0 and isinstance(layer, nn.Module) \
                    and j % self._recompute_interval == 0 and \
                    any(isinstance(a, torch.Tensor) and a.is_floating_point()
                        for a in args):
                x = recompute(layer, *args)
            else:
                x = layer(*args)
        return x

    def forward_chunk(self, chunk: int, x):
        """Run local chunk ``chunk`` on ``x``."""
        return self._run(self._chunks[chunk], x)

    def forward(self, input):
        if self._stage is not None:
            raise RuntimeError(
                "PipelineLayer over a pipe degree above 1 holds one stage; "
                "run it through fleet.distributed_model (PipelineParallel)")
        x = input
        for c in range(len(self._chunks)):
            x = self.forward_chunk(c, x)
        return x
