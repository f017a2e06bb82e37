"""Carry weights of the JAX package's models into the port.

The JAX ``state_dict()`` names match the port's module tree
(``llama.layers.0.self_attn.kv_proj.weight``, ``lm_head.weight``, and
for the ``nn`` layers ``layers.0.self_attn.q_proj.weight``, ``_mean``,
...).  Paddle keeps a linear weight as ``[in, out]`` and ``nn.Linear`` as
``[out, in]``, so linear weights are transposed; embeddings, convs and
norm weights are taken as they are.  The fused layouts (head-major ``kv_proj``,
``[gate | up]`` ``gate_up_proj``) live on the output axis and survive the
transpose unchanged.

Tensor parallelism: :func:`shard_state_dict` cuts a port state dict into
rank r's shard of an ``mp``-way model (the layout of
``mp_layers``: a column layer's out-features, a row layer's in-features,
the vocabulary's rows; ``gate_up_proj`` as gate's r-th slice then up's
r-th slice), :func:`unshard_state_dict` puts the shards back together,
and :func:`shard_model` turns a whole model into the rank's shard on a
mesh.

Hybrid models: :func:`shard_state_dict_from_jax` takes a JAX model's full
numpy state straight to one rank's shard of a port model (built under
``fleet.init`` at some model degree, perhaps holding one pipeline
stage): each of the model's own tensors is looked up by name (mapped by
``rename``, e.g. :func:`gpt_pipe_jax_name` for ``GPTForCausalLMPipe``),
transposed if it is a linear weight, and cut as its layer splits it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["port_state_dict_from_jax", "from_jax_state_dict",
           "shard_rule", "shard_state_dict", "unshard_state_dict",
           "shard_model", "shard_state_dict_from_jax", "layer_rules",
           "gpt_pipe_jax_name"]

#: (module name, parameter) -> (dim split, equal parts of that dim), in
#: the port's ``[out, in]`` layout; every other tensor is whole on every
#: rank
_TP_RULES = {
    # GPT
    ("word_embeddings", "weight"): (0, 1),
    ("qkv_proj", "weight"): (0, 1), ("qkv_proj", "bias"): (0, 1),
    ("out_proj", "weight"): (1, 1),
    ("fc1", "weight"): (0, 1), ("fc1", "bias"): (0, 1),
    ("fc2", "weight"): (1, 1),
    # Llama
    ("embed_tokens", "weight"): (0, 1),
    ("q_proj", "weight"): (0, 1), ("kv_proj", "weight"): (0, 1),
    ("o_proj", "weight"): (1, 1),
    ("gate_up_proj", "weight"): (0, 2),
    ("down_proj", "weight"): (1, 1),
    # both (an untied head: its vocabulary columns)
    ("lm_head", "weight"): (0, 1),
}


def _named_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Parameters (a shared one under its first name, as the JAX
    ``state_dict`` names it) and persistable buffers."""
    state = dict(model.named_parameters())
    every = {n for n, _ in model.named_parameters(remove_duplicate=False)}
    state.update((k, v) for k, v in model.state_dict(keep_vars=True).items()
                 if k not in every)
    return state


def port_state_dict_from_jax(model: nn.Module, state: Dict[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """A JAX-package state dict (name → numpy array) of any layer tree in
    the port's names and layouts: the state dict ``model.state_dict()``
    would give (parameters and persistable buffers, such as a batch
    norm's ``_mean``/``_variance``; non-persistable buffers are in
    neither), as CPU tensors.  Every 2-D tensor of an ``nn.Linear`` is
    transposed (its ``weight``, or a weight-normed ``weight_v`` or
    spectral-normed ``weight_orig``; ``weight_g`` is 1-D); conv,
    transposed-conv, ``Bilinear`` and ``Embedding`` weights, norms and
    buffers are taken as they are, and so are ``sparse.nn``'s: a sparse
    convolution's ``[kd, kh, kw, Cin, Cout]`` weight (both packages read
    its offsets kz-major, so no permutation) and a sparse ``BatchNorm``'s
    ``weight``, ``bias``, ``_mean`` and ``_variance``.  Touches nothing of ``model``.  Raises
    unless the names cover the model exactly and every shape matches."""
    linear = {name for name, m in model.named_modules()
              if isinstance(m, nn.Linear)}
    own = _named_state(model)
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise ValueError(f"state dict does not cover the model "
                         f"(missing={missing[:5]}, "
                         f"unexpected={unexpected[:5]})")
    out = {}
    for name, t in own.items():
        arr = np.asarray(state[name])
        if name.rpartition(".")[0] in linear and arr.ndim == 2:
            arr = arr.T
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {arr.shape} after layout "
                             f"change, model has {tuple(t.shape)}")
        out[name] = torch.from_numpy(np.array(arr))    # a writable copy
    return out


@torch.no_grad()
def from_jax_state_dict(model: nn.Module,
                        state: Dict[str, np.ndarray]) -> nn.Module:
    """Write a JAX-package state dict (name → numpy array) into ``model``
    in place, on the model's device and in its dtypes
    (:func:`port_state_dict_from_jax`, then ``copy_``)."""
    own = _named_state(model)
    for name, t in port_state_dict_from_jax(model, state).items():
        own[name].copy_(t)
    return model


def shard_rule(name: str) -> Optional[Tuple[int, int]]:
    """``(dim, parts)`` along which parameter ``name`` splits over the
    model axis, or None when it is whole on every rank."""
    parts = name.rsplit(".", 2)
    if len(parts) < 2:
        return None
    return _TP_RULES.get((parts[-2], parts[-1]))


def _shard(t: torch.Tensor, rule, rank: int, mp: int) -> torch.Tensor:
    from ..distributed.fleet.meta_parallel.mp_layers import shard_index

    if rule is None or mp == 1:
        return t
    dim, parts = rule
    idx = shard_index(t.shape[dim], rank, mp, parts).to(t.device)
    return t.index_select(dim, idx)


def shard_state_dict(state: Dict[str, torch.Tensor], rank: int,
                     mp: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shard of a whole port state dict for an ``mp``-way
    model (each split tensor a copy of its rows or columns, the names
    saying where each splits, :func:`shard_rule`; whole ones are the same
    tensors; ``mp == 1`` gives the tensors back as they are)."""
    if not 0 <= rank < mp:
        raise ValueError(f"rank {rank} outside [0, {mp})")
    out = {}
    for name, t in state.items():
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t))
        out[name] = _shard(t, shard_rule(name), rank, mp)
    return out


def unshard_state_dict(shards: Sequence[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """The whole state dict from every rank's shard (``shards[r]`` rank
    r's), the inverse of :func:`shard_state_dict`."""
    from ..distributed.fleet.meta_parallel.mp_layers import shard_index

    mp = len(shards)
    out = {}
    for name, t0 in shards[0].items():
        rule = shard_rule(name)
        if rule is None or mp == 1:
            out[name] = t0
            continue
        dim, parts = rule
        shape = list(t0.shape)
        shape[dim] *= mp
        full = torch.empty(shape, dtype=t0.dtype, device=t0.device)
        for r, sd in enumerate(shards):
            full.index_copy_(dim, shard_index(shape[dim], r, mp,
                                              parts).to(t0.device),
                             sd[name])
        out[name] = full
    return out


@torch.no_grad()
def shard_model(model: nn.Module, mesh) -> nn.Module:
    """The rank's tensor-parallel shard of a whole ``model`` on ``mesh``:
    a model of the same class built with ``mesh=`` on the ``meta`` device
    (GPT with the same attention route), whose every tensor is the rank's
    share of ``model``'s, on its device and in its dtype.  On a mesh of
    one each tensor is ``model``'s own (nothing is copied); otherwise a
    split tensor is a copy of its rows or columns.  Buffers (Llama's RoPE
    tables) are taken as they are."""
    from ..distributed.mesh import mesh_ranks

    mp = mesh.size()
    rank = mesh_ranks(mesh).index(torch.distributed.get_rank())
    kwargs = {"device": "meta", "mesh": mesh}
    kernel = getattr(getattr(model, "gpt", None), "layers", None)
    if kernel is not None and len(kernel):
        kwargs["kernel"] = kernel[0].attn.kernel
    shell = type(model)(model.config, **kwargs)
    src = dict(model.named_parameters())
    src.update(model.named_buffers())
    for prefix, mod in shell.named_modules():
        prefix = f"{prefix}." if prefix else ""
        for table in (mod._parameters, mod._buffers):
            for name, t in list(table.items()):
                if t is None:
                    continue
                full = src[prefix + name]
                local = _shard(full.detach(), shard_rule(prefix + name)
                               if name in mod._parameters else None,
                               rank, mp)
                if tuple(local.shape) != tuple(t.shape):
                    raise ValueError(f"{prefix}{name}: the shard has "
                                     f"{tuple(local.shape)}, the model "
                                     f"{tuple(t.shape)}")
                table[name] = (nn.Parameter(local, t.requires_grad)
                               if isinstance(t, nn.Parameter) else local)
    return shell.eval()


def shard_state_dict_from_jax(model: nn.Module, state: Dict[str, np.ndarray],
                              rank: int = 0, mp: int = 1,
                              rename: Optional[Callable[[str], str]] = None
                              ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shard (of ``mp``) of a JAX-package state dict, for
    exactly the tensors ``model`` holds: each one's JAX name is
    ``rename(name)`` (the name itself by default), a linear weight is
    transposed, and a tensor of a tensor-parallel layer is cut as its
    class splits it (as :func:`shard_state_dict` cuts the model's by
    name).  CPU tensors; raises when a shape does not match the
    model's."""
    modules = dict(model.named_modules())
    rules = layer_rules(model)
    out = {}
    for name, t in _named_state(model).items():
        src = rename(name) if rename is not None else name
        if src not in state:
            raise ValueError(f"{name}: {src!r} is not in the state dict")
        arr = np.asarray(state[src])
        if isinstance(modules.get(name.rpartition(".")[0]), nn.Linear) \
                and arr.ndim == 2:
            arr = arr.T
        local = _shard(torch.from_numpy(np.array(arr)), rules.get(name),
                       rank, mp)
        if tuple(local.shape) != tuple(t.shape):
            raise ValueError(f"{name}: the shard has {tuple(local.shape)}, "
                             f"the model {tuple(t.shape)}")
        out[name] = local
    return out


def layer_rules(model: nn.Module) -> Dict[str, Tuple[int, int]]:
    """``{name: (dim, parts)}`` of every tensor of ``model`` that a
    tensor-parallel layer splits, by the layer's class (the names need
    not be those :data:`_TP_RULES` knows)."""
    from ..distributed.fleet.meta_parallel.mp_layers import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    )

    rules = {}
    for prefix, mod in model.named_modules():
        prefix = f"{prefix}." if prefix else ""
        if isinstance(mod, ColumnParallelLinear):
            rules[prefix + "weight"] = (0, mod.parts)
            if mod.bias is not None:
                rules[prefix + "bias"] = (0, mod.parts)
        elif isinstance(mod, RowParallelLinear):
            rules[prefix + "weight"] = (1, 1)
        elif isinstance(mod, VocabParallelEmbedding):
            rules[prefix + "weight"] = (0, 1)
    return rules


def gpt_pipe_jax_name(num_layers: int) -> Callable[[str], str]:
    """The JAX ``GPTForCausalLMPipe`` name of a port
    ``GPTForCausalLMPipe`` tensor: the tied embeddings
    (``shared_layers.embed.*``) are the JAX model's layer 0, an untied
    head (index ``num_layers + 2``) its layer ``num_layers + 1`` (the JAX
    head holds the final norm and the head in one layer); every other
    name is the same."""
    head = str(num_layers + 2)

    def rename(name: str) -> str:
        if name.startswith("shared_layers.embed."):
            return "0." + name[len("shared_layers.embed."):]
        idx, _, rest = name.partition(".")
        return f"{num_layers + 1}.{rest}" if idx == head else name

    return rename
