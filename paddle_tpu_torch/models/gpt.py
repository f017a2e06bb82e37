"""GPT decoder-only transformer (pre-LN, tanh-gelu MLP, tied LM head) as
``nn.Module``s, for training and serving.

Port of ``paddle_tpu/models/gpt.py``.  Without a mesh,
``ColumnParallelLinear``/``RowParallelLinear`` become ``nn.Linear``
(weight ``[out, in]``; the JAX layout is ``[in, out]``, see
``convert.py``) and ``VocabParallelEmbedding`` becomes ``nn.Embedding``.
With ``mesh=`` (a one-axis ``"model"`` mesh, :mod:`..serving.sharding`)
they are the tensor-parallel layers of
:mod:`..distributed.fleet.meta_parallel.mp_layers` at the rank's share:
``H/mp`` heads (the head-major ``qkv_proj`` splits into whole heads), the
MLP's ``ffn/mp`` columns, the vocabulary's ``V/mp`` rows; the tied head's
logits are all-gathered over the vocabulary before they leave the
model.  Without a mesh, a model built after ``fleet.init`` at a model
degree above 1 is that degree's shard, and :meth:`GPTForCausalLM.
compute_loss` takes the vocab-parallel path (the rank's vocabulary
columns of the logits through ``ParallelCrossEntropy``);
:func:`GPTForCausalLMPipe` is the pipeline-parallel model.
Module and parameter names are the JAX ``state_dict()``'s.  The fused
``qkv_proj`` keeps the JAX output layout, head-major ``[H, 3*D]``, so q, k
and v are strided ``[B, S, H, D]`` views of one projection, which the
flash kernels read through their strides.

Attention runs through :func:`ops.attention.flash_attention` (kernels K1,
K2 and K3 on CUDA, or the plain versions with ``kernel="reference"`` and
on the CPU); the loss through :func:`ops.fused.fused_linear_cross_entropy`
on the head weight, so no ``[B, S, V]`` logits are made.

Dropout sits where the JAX model has it (``paddle_tpu/models/gpt.py``):
on the embeddings' sum (``hidden_dropout_prob``), on the attention
probabilities inside the flash kernels (``attention_probs_dropout_prob``),
and on the attention and MLP outputs before each residual add; each draws
from the device's generator (:mod:`..rng`), and ``model.eval()`` turns all
of them off.  With ``config.recompute`` a training forward runs each
decoder layer as one activation-recompute region
(:func:`..distributed.fleet.recompute.recompute`), whose recomputed
forward draws the same dropout masks.

Serving passes a cache context (``serving.kv_cache.CacheContext`` or
``serving.paging.PagedCacheContext``) that routes the K/V writes and the
attention, as in the JAX package: a prefill writes the bucket's K/V and
attends through the context, a decode step writes each slot's token and
attends over its window, and the learned positions come from the context
(each slot's length in decode, the positions past a cached prefix in a
paged tail prefill).  q, k and v stay strided views of the head-major
qkv projection, which the kernels read through their strides.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import rng as rng_mod
from ..distributed.fleet.meta_parallel.mp_layers import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, c_identity, default_group, gather_output,
)
from ..distributed.fleet.recompute import recompute
from ..nn.common import Dropout
from ..nn.norm import LayerNorm
from ..ops.attention import flash_attention
from ..ops.fused import fused_linear_cross_entropy
from ..ops.ring_attention import sep_group, sep_offset, sep_token_mean

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTForCausalLMPipe", "GPTModel",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt2_345m", "gpt3_13b",
           "GPT_CONFIGS"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: Optional[int] = None   # None → 4 * hidden
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    recompute: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size


def gpt_tiny(**kw) -> GPTConfig:
    for k, v in dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, max_position_embeddings=64,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0).items():
        kw.setdefault(k, v)
    return GPTConfig(**kw)


def gpt2_345m(**kw) -> GPTConfig:
    for k, v in dict(vocab_size=50304, hidden_size=1024, num_hidden_layers=24,
                     num_attention_heads=16,
                     max_position_embeddings=1024).items():
        kw.setdefault(k, v)
    return GPTConfig(**kw)


def gpt3_13b(**kw) -> GPTConfig:
    for k, v in dict(vocab_size=50304, hidden_size=5120, num_hidden_layers=40,
                     num_attention_heads=40,
                     max_position_embeddings=2048).items():
        kw.setdefault(k, v)
    return GPTConfig(**kw)


GPT_CONFIGS = {"tiny": gpt_tiny, "gpt2-345m": gpt2_345m, "gpt3-13b": gpt3_13b}


class GPTAttention(nn.Module):
    """Causal self-attention off one fused, head-major qkv projection."""

    def __init__(self, config: GPTConfig, *, device=None, dtype=None,
                 kernel: str = "cuda", group=None):
        super().__init__()
        self.n_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        self.kernel = kernel
        h = config.hidden_size
        if group is None:
            self.qkv_proj = nn.Linear(h, 3 * h, device=device, dtype=dtype)
            self.out_proj = nn.Linear(h, h, device=device, dtype=dtype)
        else:
            self.qkv_proj = ColumnParallelLinear(h, 3 * h, group=group,
                                                 device=device, dtype=dtype)
            self.out_proj = RowParallelLinear(h, h, group=group,
                                              device=device, dtype=dtype)
            self.n_heads //= self.qkv_proj.mp
        #: a shard's first head among all (its dropout draws there)
        self.head_start = None if group is None else \
            self.qkv_proj.rank * self.n_heads
        self.heads_total = config.num_attention_heads
        self.dropout_p = config.attention_probs_dropout_prob

    def forward(self, x: torch.Tensor, cache_ctx=None) -> torch.Tensor:
        B, S, _ = x.shape
        qkv = self.qkv_proj(x).view(B, S, self.n_heads, 3 * self.head_dim)
        q, k, v = qkv.split(self.head_dim, dim=-1)          # [B, S, H, D]
        if cache_ctx is None:
            coords = contextlib.nullcontext() if self.head_start is None \
                else rng_mod.shard_coordinates(head_start=self.head_start,
                                               heads_total=self.heads_total)
            with coords:
                ctx = flash_attention(q, k, v, is_causal=True,
                                      dropout_p=self.dropout_p,
                                      kernel=self.kernel,
                                      training=self.training)
        elif cache_ctx.mode == "prefill":
            cache_ctx.write_prefill(k, v)
            ctx = cache_ctx.prefill_attention(q, k, v)
        else:               # decode: each slot's one token
            ctx = cache_ctx.decode_attention(q, k, v)
        return self.out_proj(ctx.reshape(B, S, self.n_heads * self.head_dim))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, *, device=None, dtype=None,
                 group=None):
        super().__init__()
        h, f = config.hidden_size, config.ffn_size
        if group is None:
            self.fc1 = nn.Linear(h, f, device=device, dtype=dtype)
            self.fc2 = nn.Linear(f, h, device=device, dtype=dtype)
        else:
            self.fc1 = ColumnParallelLinear(h, f, group=group,
                                            device=device, dtype=dtype)
            self.fc2 = RowParallelLinear(f, h, group=group, device=device,
                                         dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(nn.functional.gelu(self.fc1(x), approximate="tanh"))


class GPTDecoderLayer(nn.Module):
    """Pre-LN block: ``x + dropout(attn(ln1(x)))``;
    ``x + dropout(mlp(ln2(x)))``."""

    def __init__(self, config: GPTConfig, *, device=None, dtype=None,
                 kernel: str = "cuda", group=None):
        super().__init__()
        eps, h = config.layer_norm_epsilon, config.hidden_size
        self.ln1 = LayerNorm(h, eps, device=device, dtype=dtype)
        self.attn = GPTAttention(config, device=device, dtype=dtype,
                                 kernel=kernel, group=group)
        self.ln2 = LayerNorm(h, eps, device=device, dtype=dtype)
        self.mlp = GPTMLP(config, device=device, dtype=dtype, group=group)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x: torch.Tensor, cache_ctx=None) -> torch.Tensor:
        x = x + self.dropout(self.attn(self.ln1(x), cache_ctx))
        return x + self.dropout(self.mlp(self.ln2(x)))


class GPTEmbeddings(nn.Module):
    def __init__(self, config: GPTConfig, *, device=None, dtype=None,
                 group=None):
        super().__init__()
        if group is None:
            self.word_embeddings = nn.Embedding(
                config.vocab_size, config.hidden_size, device=device,
                dtype=dtype)
        else:
            self.word_embeddings = VocabParallelEmbedding(
                config.vocab_size, config.hidden_size, group=group,
                device=device, dtype=dtype)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size,
            device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if position_ids is None:
            # under a sep degree this is a chunk: its global positions
            S = input_ids.shape[-1]
            start = sep_offset(S)
            max_pos = self.position_embeddings.num_embeddings
            if start + S > max_pos:
                raise ValueError(f"sequence length {start + S} exceeds "
                                 f"max_position_embeddings {max_pos}")
            position_ids = torch.arange(start, start + S,
                                        device=input_ids.device)[None, :]
        return self.dropout(self.word_embeddings(input_ids)
                            + self.position_embeddings(position_ids))


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, *, device=None, dtype=None,
                 kernel: str = "cuda", group=None):
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config, device=device, dtype=dtype,
                                        group=group)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(config, device=device, dtype=dtype,
                             kernel=kernel, group=group)
             for _ in range(config.num_hidden_layers)])
        self.final_ln = LayerNorm(config.hidden_size,
                                  config.layer_norm_epsilon, device=device,
                                  dtype=dtype)

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                cache_ctx=None) -> torch.Tensor:
        if cache_ctx is not None and position_ids is None:
            if cache_ctx.mode != "prefill":
                # decode: each slot's token sits at that slot's length
                position_ids = cache_ctx.positions()
            else:
                # paged tail prefill: past the cached prefix (None for the
                # contiguous layout: 0..S-1)
                position_ids = cache_ctx.prefill_positions(
                    input_ids.shape[-1])
        h = self.embeddings(input_ids, position_ids)
        for i, layer in enumerate(self.layers):
            if cache_ctx is not None:
                cache_ctx.layer_idx = i
                h = layer(h, cache_ctx)
            elif self.config.recompute and self.training:
                h = recompute(layer, h)
            else:
                h = layer(h)
        return self.final_ln(h)


def _fleet_group():
    """The process group of ``fleet.init``'s model axis, or None."""
    g = default_group()
    return None if g is None else g.process_group


@torch.no_grad()
def init_weights(module: nn.Module, std: float,
                 generator: Optional[torch.Generator] = None) -> None:
    """Every weight matrix and embedding of ``module`` from N(0, std);
    biases zero; LayerNorm weight one, bias zero."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, std, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


class GPTPretrainingCriterion(nn.Module):
    """The causal-LM loss over the head's logits (the rank's vocabulary
    columns under tensor parallelism): :class:`ParallelCrossEntropy` per
    token, averaged over the tokens whose label is not ``ignore_index``
    (or weighted by ``loss_mask``), as the JAX package's criterion."""

    def __init__(self, ignore_index: int = -100, group=None):
        super().__init__()
        self.ce = ParallelCrossEntropy(mp_group=group,
                                       ignore_index=ignore_index)
        self.ignore_index = ignore_index

    def forward(self, logits, labels, loss_mask=None):
        loss = self.ce(logits, labels).squeeze(-1)
        if loss_mask is not None:
            m = loss_mask.float()
            total, n = (loss * m).sum(), m.sum()
            return sep_token_mean(total / n.clamp(min=1.0), n)
        denom = (labels != self.ignore_index).float().sum()
        return sep_token_mean(loss.sum() / denom.clamp(min=1.0), denom)


class GPTForCausalLM(nn.Module):
    """GPTModel + the LM head, tied to the word embedding by default.

    ``device`` defaults to ``"cuda"``; pass ``device="cpu"`` to run on the
    CPU.  Asking for CUDA on a machine without a card raises.  ``kernel``
    (``"cuda"`` or ``"reference"``) picks the attention path on the card;
    CPU tensors always take the plain versions.  ``mesh`` (a serving mesh)
    builds the rank's tensor-parallel shard; without one, a model built
    after ``fleet.init`` with a model degree above 1 is that degree's
    shard.  ``generator`` then draws the shard's own values."""

    def __init__(self, config: GPTConfig, *, device="cuda",
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 kernel: str = "cuda", mesh=None):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "GPTForCausalLM: device 'cuda' asked for, but no CUDA "
                "device is available (pass device='cpu' to run on the CPU)")
        self.config = config
        self.mesh = mesh
        self.group = group = _fleet_group() if mesh is None \
            else mesh.get_group("model")
        self.gpt = GPTModel(config, device=device, dtype=dtype, kernel=kernel,
                            group=group)
        if config.tie_word_embeddings:
            self.lm_head = None
        elif group is None:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias=False, device=device, dtype=dtype)
        else:
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, bias=False,
                group=group, device=device, dtype=dtype)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw every weight matrix and embedding from
        N(0, initializer_range); biases zero; LayerNorm weight one, bias
        zero."""
        init_weights(self, self.config.initializer_range, generator)

    def _head_weight(self) -> torch.Tensor:
        """The ``[V, H]`` head weight: the word embedding when tied."""
        if self.lm_head is None:
            return self.gpt.embeddings.word_embeddings.weight
        return self.lm_head.weight

    def forward(self, input_ids: torch.Tensor,
                cache_ctx=None) -> torch.Tensor:
        """Logits ``[B, S, V]`` (serving and tests; training calls
        :meth:`compute_loss`, which never makes them).  ``cache_ctx``
        routes a serving step through the KV cache.  With a mesh, the
        rank's vocabulary columns are all-gathered."""
        h = self.gpt(input_ids, cache_ctx=cache_ctx)
        if self.group is None:
            return h @ self._head_weight().t()
        logits = c_identity(h, self.group) @ self._head_weight().t()
        return gather_output(logits, self.group)

    def compute_loss(self, input_ids: torch.Tensor, labels: torch.Tensor,
                     loss_mask: Optional[torch.Tensor] = None,
                     ignore_index: int = -100) -> torch.Tensor:
        """Forward + causal-LM loss (f32 scalar): through the vocab-blocked
        fused cross-entropy, or, on a tensor-parallel model, through the
        rank's vocabulary columns of the logits and
        :class:`ParallelCrossEntropy` (the JAX package's vocab-parallel
        path).  Under a ``fleet`` sep degree the ids are this rank's chunk
        of the sequence and the loss is the token-weighted mean over the
        sep group (:func:`..ops.ring_attention.sep_token_mean`)."""
        h = self.gpt(input_ids)
        if self.group is None:
            loss = fused_linear_cross_entropy(
                h, self._head_weight(), labels, loss_mask=loss_mask,
                ignore_index=ignore_index)
            if sep_group() is None:
                return loss
            count = (loss_mask.float().sum() if loss_mask is not None
                     else (labels != ignore_index).float().sum())
            return sep_token_mean(loss, count)
        logits = c_identity(h, self.group) @ self._head_weight().t()
        crit = GPTPretrainingCriterion(ignore_index, self.group)
        return crit(logits, labels, loss_mask)


class _GPTFinalNorm(nn.Module):
    def __init__(self, config: GPTConfig, *, device=None, dtype=None):
        super().__init__()
        self.final_ln = LayerNorm(config.hidden_size,
                                  config.layer_norm_epsilon, device=device,
                                  dtype=dtype)

    def forward(self, x):
        return self.final_ln(x)


class _GPTLMHead(nn.Module):
    """The untied head: the rank's vocabulary columns."""

    def __init__(self, config: GPTConfig, *, device=None, dtype=None,
                 group=None):
        super().__init__()
        self.group = group
        if group is None:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias=False, device=device, dtype=dtype)
        else:
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, bias=False,
                group=group, device=device, dtype=dtype)

    def forward(self, h):
        return self.lm_head(h)


def _tied_head(embeddings: GPTEmbeddings, h: torch.Tensor) -> torch.Tensor:
    """The tied head on the last stage's copy of the embeddings: the
    rank's vocabulary columns of the logits."""
    w = embeddings.word_embeddings.weight
    group = getattr(embeddings.word_embeddings, "group", None)
    return c_identity(h, group) @ w.t()


def GPTForCausalLMPipe(config: GPTConfig, topology=None,
                       num_stages: Optional[int] = None,
                       recompute_interval: int = 0,
                       num_virtual_pipeline_stages: Optional[int] = None, *,
                       device="cuda", dtype=torch.float32,
                       generator: Optional[torch.Generator] = None,
                       kernel: str = "cuda"):
    """The pipeline-parallel GPT (the JAX package's
    ``GPTForCausalLMPipe``, ``models/gpt.py:342-365``): a
    :class:`PipelineLayer` of the embeddings, the decoder layers, the
    final norm and the head, cut before evenly spaced decoder layers.
    The tied head is a ``SharedLayerDesc`` of the embeddings (key
    ``"embed"``): the first and last stage each hold a copy, and the
    word embedding's gradient is summed between them.  Under a model
    degree above 1 the layers are that degree's shards and the loss is
    :class:`GPTPretrainingCriterion` over the local logits.  The state
    dict names are the JAX model's but the embeddings' (under
    ``shared_layers.embed.`` when tied) and an untied head's (one index
    on); :func:`..models.convert.gpt_pipe_jax_name` maps them."""
    from ..distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc,
    )

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("GPTForCausalLMPipe: device 'cuda' asked for, but "
                           "no CUDA device is available (pass device='cpu')")
    group = _fleet_group()
    kw = dict(device=device, dtype=dtype)
    if config.tie_word_embeddings:
        layers = [SharedLayerDesc("embed", GPTEmbeddings, None,
                                  "word_embeddings.weight", config,
                                  group=group, **kw)]
    else:
        layers = [LayerDesc(GPTEmbeddings, config, group=group, **kw)]
    layers += [LayerDesc(GPTDecoderLayer, config, kernel=kernel, group=group,
                         **kw) for _ in range(config.num_hidden_layers)]
    layers.append(LayerDesc(_GPTFinalNorm, config, **kw))
    if config.tie_word_embeddings:
        layers.append(SharedLayerDesc("embed", GPTEmbeddings, _tied_head,
                                      "word_embeddings.weight", config,
                                      group=group, **kw))
    else:
        layers.append(LayerDesc(_GPTLMHead, config, group=group, **kw))
    crit = GPTPretrainingCriterion(group=group)
    pipe = PipelineLayer(layers, num_stages=num_stages, topology=topology,
                         loss_fn=crit, seg_method="layer:GPTDecoderLayer",
                         recompute_interval=recompute_interval,
                         num_virtual_pipeline_stages=
                         num_virtual_pipeline_stages)
    init_weights(pipe, config.initializer_range, generator)
    pipe.config = config
    return pipe
