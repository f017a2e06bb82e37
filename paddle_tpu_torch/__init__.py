"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

This package stands beside ``paddle_tpu`` (the JAX reference) and imports
nothing of it.  It grows slice by slice.  Its attention runs in
hand-written CUDA kernels for Hopper (``csrc/``), one for each Pallas
kernel of the JAX package:

- K1 flash attention forward (``csrc/flash_attention_fwd.cu``),
- K2 (dK, dV) and K3 (dQ) flash attention backward
  (``csrc/flash_attention_bwd.cu``), K1-K3 each also with attention
  dropout on a Philox generator (:mod:`.rng`), each in f32, bf16 and
  f16,
- K4 paged decode and K5 fused paged prefill (``csrc/paged_attention.cu``),
  each in f32, bf16 and f16.

Entry points: :func:`inference.create_engine` serves GPT and Llama
models in f32, bf16 or f16, each engine step a CUDA graph on the card;
the deployment path :func:`jit.save` → ``inference.Config`` →
:func:`inference.create_predictor` → ``Predictor.run`` serves a saved
model in one call (its attention K1, through the registered op
``paddle_tpu_torch::flash_fwd``), and :func:`framework.save`/``load``
read and write the JAX package's tensor files;
:func:`training.build_train_step` trains GPT (the GPT-2 345M step of
``bench.py``, compiled by :func:`jit.to_static`: one CUDA graph a step on
the card; AMP O2 or O1), and so does a user's own loop of
``GPTForCausalLM``, an optimizer of :mod:`.optimizer` (ten classes,
parameter groups, ``lr=optimizer.lr.<scheduler>``,
``grad_clip=nn.Clip...``), ``amp.decorate`` or ``amp.auto_cast`` (the
JAX package's per-op lists), ``amp.GradScaler`` and ``jit.to_static``;
:func:`seed` seeds dropout.  Everything runs on ``cuda`` unless the caller passes
``device="cpu"``; on CPU tensors each kernel's plain PyTorch version runs
instead.
"""
from . import (
    amp, distributed, framework, inference, jit, models, nn, obs, ops,
    optimizer, rng, serving, static,
)
from .inference import create_engine
from .rng import seed
from .training import build_train_step

__all__ = ["amp", "build_train_step", "create_engine", "distributed",
           "framework", "inference", "jit", "models", "nn", "obs", "ops",
           "optimizer", "rng", "seed", "serving", "static"]
