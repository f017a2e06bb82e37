"""Llama decoder-only transformer (RMSNorm + SwiGLU + rotary, GQA) as
``nn.Module``s.

Port of ``paddle_tpu/models/llama.py``.  Without a mesh the column/row
parallel linears are ``nn.Linear`` (weight ``[out, in]``; the JAX layout
is ``[in, out]``, see ``convert.py``) and the vocab-parallel embedding is
``nn.Embedding``.  The fused layouts are kept: ``kv_proj`` is head-major
(K then V for each kv head) and ``gate_up_proj`` splits its output into
``[gate | up]``.

With ``mesh=`` the rank holds its tensor-parallel shard (the layers of
:mod:`..distributed.fleet.meta_parallel.mp_layers`): ``H/mp`` query heads
and ``Hkv/mp`` whole kv heads (head-major, so a contiguous column shard
is whole heads), the vocabulary's ``V/mp`` rows of the embedding and of
the head (whose logits are all-gathered before they leave the model).
``gate_up_proj`` is not contiguous in ``[gate | up]``: rank r holds
gate's r-th slice and up's r-th slice (``parts=2``), so the SwiGLU needs
no communication.  The JAX package shards it contiguously and lets GSPMD
reshard after the split; the values are the same, the layout is not.

Every module is built on the ``device`` and in the ``dtype`` it is given.
Weights are drawn from ``generator`` (normal, std ``initializer_range``;
RMSNorm weights one), on the device, so a 7B model needs no host pass.
Serving passes a cache context (``serving.kv_cache.CacheContext`` or
``serving.paging.PagedCacheContext``) that routes the K/V writes and the
attention; without one the forward is plain causal self-attention.
"""
from __future__ import annotations

import functools

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..distributed.fleet.meta_parallel.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    gather_last,
)
from ..nn.norm import RMSNorm
from ..ops.attention import flash_attention
from ..ops.rotary import rotary_embedding

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "llama_tiny",
           "llama2_7b", "llama2_13b", "llama2_70b", "LLAMA_CONFIGS"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None   # None → MHA
    intermediate_size: Optional[int] = None     # None → llama 8/3 rule
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def n_kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def ffn_size(self) -> int:
        if self.intermediate_size is not None:
            return self.intermediate_size
        f = int(2 * 4 * self.hidden_size / 3)
        return 256 * ((f + 255) // 256)


def llama_tiny(**kw) -> LlamaConfig:
    kw.setdefault("vocab_size", 128)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_hidden_layers", 2)
    kw.setdefault("num_attention_heads", 4)
    kw.setdefault("num_key_value_heads", 2)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("max_position_embeddings", 64)
    return LlamaConfig(**kw)


def llama2_7b(**kw) -> LlamaConfig:
    kw.setdefault("hidden_size", 4096)
    kw.setdefault("num_hidden_layers", 32)
    kw.setdefault("num_attention_heads", 32)
    kw.setdefault("intermediate_size", 11008)
    return LlamaConfig(**kw)


def llama2_13b(**kw) -> LlamaConfig:
    kw.setdefault("hidden_size", 5120)
    kw.setdefault("num_hidden_layers", 40)
    kw.setdefault("num_attention_heads", 40)
    kw.setdefault("intermediate_size", 13824)
    return LlamaConfig(**kw)


def llama2_70b(**kw) -> LlamaConfig:
    kw.setdefault("hidden_size", 8192)
    kw.setdefault("num_hidden_layers", 80)
    kw.setdefault("num_attention_heads", 64)
    kw.setdefault("num_key_value_heads", 8)
    kw.setdefault("intermediate_size", 28672)
    return LlamaConfig(**kw)


LLAMA_CONFIGS = {"tiny": llama_tiny, "llama2-7b": llama2_7b,
                 "llama2-13b": llama2_13b, "llama2-70b": llama2_70b}


@functools.lru_cache(maxsize=8)
def _rope_cache(seq_len: int, dim: int, theta: float):
    """cos/sin tables ``[S, D]`` (rotate-half), built in float64 numpy and
    cast to f32, as the JAX package builds them.  Every layer asks for the
    same tables, so they are built once (a 7B model's 32 builds took 0.6 s
    of host time); callers copy them into their buffers."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    t = np.arange(seq_len, dtype=np.float64)
    freqs = np.outer(t, inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def _linear(n_in: int, n_out: int, device, dtype, group=None,
            kind: str = "column", parts: int = 1) -> nn.Linear:
    """A bias-free projection: ``nn.Linear`` without a group, else the
    ``kind`` (``"column"`` or ``"row"``) tensor-parallel layer."""
    if group is None:
        return nn.Linear(n_in, n_out, bias=False, device=device, dtype=dtype)
    if kind == "row":
        return RowParallelLinear(n_in, n_out, bias=False, group=group,
                                 device=device, dtype=dtype)
    return ColumnParallelLinear(n_in, n_out, bias=False, group=group,
                                parts=parts, device=device, dtype=dtype)


class LlamaAttention(nn.Module):
    """Rotary causal self-attention with grouped-query KV."""

    def __init__(self, config: LlamaConfig, *, device=None, dtype=None,
                 group=None):
        super().__init__()
        self.n_heads = config.num_attention_heads
        self.n_kv = config.n_kv_heads
        self.head_dim = config.head_dim
        h = config.hidden_size
        self.q_proj = _linear(h, self.n_heads * self.head_dim, device, dtype,
                              group)
        self.kv_proj = _linear(h, self.n_kv * 2 * self.head_dim, device,
                               dtype, group)
        self.o_proj = _linear(h, h, device, dtype, group, "row")
        if group is not None:
            self.n_heads //= self.q_proj.mp
            self.n_kv //= self.q_proj.mp
        self.rope_theta = config.rope_theta
        cos, sin = _rope_cache(config.max_position_embeddings, self.head_dim,
                               self.rope_theta)
        self.register_buffer("rope_cos", torch.tensor(cos, device=device),
                             persistent=False)
        self.register_buffer("rope_sin", torch.tensor(sin, device=device),
                             persistent=False)

    def _tables(self, n: int):
        if self.rope_cos.shape[0] < n:
            cos, sin = _rope_cache(n, self.head_dim, self.rope_theta)
            dev = self.rope_cos.device
            self.rope_cos = torch.tensor(cos, device=dev)
            self.rope_sin = torch.tensor(sin, device=dev)
        return self.rope_cos, self.rope_sin

    def forward(self, x: torch.Tensor, cache_ctx=None) -> torch.Tensor:
        B, S, _ = x.shape
        q = self.q_proj(x).view(B, S, self.n_heads, self.head_dim)
        kv = self.kv_proj(x).view(B, S, self.n_kv, 2 * self.head_dim)
        k, v = kv.split(self.head_dim, dim=-1)          # [B, S, Hkv, D]
        if cache_ctx is not None and cache_ctx.mode != "prefill":
            # decode: each slot's one token sits at that slot's offset
            cos, sin = self._tables(S)
            q, k = rotary_embedding(q, k, cos, sin,
                                    position_ids=cache_ctx.positions())
            ctx = cache_ctx.decode_attention(q, k, v)
        else:
            pos = None if cache_ctx is None else \
                cache_ctx.prefill_positions(S)
            cos, sin = self._tables(S)
            q, k = rotary_embedding(q, k, cos, sin, position_ids=pos)
            if cache_ctx is not None:
                cache_ctx.write_prefill(k, v)
                ctx = cache_ctx.prefill_attention(q, k, v)
            else:
                if self.n_kv != self.n_heads:
                    rep = self.n_heads // self.n_kv
                    k = k.repeat_interleave(rep, dim=2)
                    v = v.repeat_interleave(rep, dim=2)
                ctx = flash_attention(q, k, v, is_causal=True)
        return self.o_proj(ctx.reshape(B, S, self.n_heads * self.head_dim))


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))`` with gate/up fused."""

    def __init__(self, config: LlamaConfig, *, device=None, dtype=None,
                 group=None):
        super().__init__()
        self.ffn = config.ffn_size
        self.gate_up_proj = _linear(config.hidden_size, 2 * self.ffn, device,
                                    dtype, group, parts=2)
        self.down_proj = _linear(self.ffn, config.hidden_size, device, dtype,
                                 group, "row")
        if group is not None:
            self.ffn //= self.down_proj.mp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.gate_up_proj(x).split(self.ffn, dim=-1)
        return self.down_proj(nn.functional.silu(gate) * up)


class LlamaDecoderLayer(nn.Module):
    """Pre-RMSNorm block: ``x + attn(norm(x))``; ``x + mlp(norm(x))``."""

    def __init__(self, config: LlamaConfig, *, device=None, dtype=None,
                 group=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps,
                                       device=device, dtype=dtype)
        self.self_attn = LlamaAttention(config, device=device, dtype=dtype,
                                        group=group)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                device=device, dtype=dtype)
        self.mlp = LlamaMLP(config, device=device, dtype=dtype, group=group)

    def forward(self, x: torch.Tensor, cache_ctx=None) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), cache_ctx)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None,
                 group=None):
        super().__init__()
        self.config = config
        if group is None:
            self.embed_tokens = nn.Embedding(config.vocab_size,
                                             config.hidden_size,
                                             device=device, dtype=dtype)
        else:
            self.embed_tokens = VocabParallelEmbedding(
                config.vocab_size, config.hidden_size, group=group,
                device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device=device, dtype=dtype,
                               group=group)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=dtype)

    def forward(self, input_ids: torch.Tensor, cache_ctx=None):
        h = self.embed_tokens(input_ids)
        for i, layer in enumerate(self.layers):
            if cache_ctx is not None:
                cache_ctx.layer_idx = i
            h = layer(h, cache_ctx)
        return self.norm(h)


class LlamaForCausalLM(nn.Module):
    """LlamaModel + an untied LM head.

    ``device`` defaults to ``"cuda"``; pass ``device="cpu"`` to run on the
    CPU.  Asking for CUDA on a machine without a card raises.  ``mesh`` (a
    serving mesh) builds the rank's tensor-parallel shard; ``generator``
    then draws the shard's own values."""

    def __init__(self, config: LlamaConfig, *, device="cuda",
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "LlamaForCausalLM: device 'cuda' asked for, but no CUDA "
                "device is available (pass device='cpu' to run on the CPU)")
        self.config = config
        self.mesh = mesh
        self.group = group = None if mesh is None \
            else mesh.get_group("model")
        self.llama = LlamaModel(config, device=device, dtype=dtype,
                                group=group)
        self.lm_head = _linear(config.hidden_size, config.vocab_size, device,
                               dtype, group)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw every weight matrix from N(0, initializer_range) and set
        the RMSNorm weights to one."""
        std = self.config.initializer_range
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)

    def forward(self, input_ids: torch.Tensor,
                cache_ctx=None) -> torch.Tensor:
        logits = self.lm_head(self.llama(input_ids, cache_ctx=cache_ctx))
        return logits if self.group is None else \
            gather_last(logits, self.group)
