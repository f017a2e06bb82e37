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
:func:`seed` seeds dropout.  A training loop survives faults under
``distributed.fault_tolerance.ResilientLoop`` (format-2 checkpoints of
:mod:`distributed.checkpoint`, preemption, the divergence sentry's
rollback), observed by :mod:`obs` (``StepTimeline``, ``CompileLedger``,
``CostLedger``) and :mod:`profiler`.  :mod:`nn` is Paddle's layers,
functionals and initializers as ``torch.nn.Module``s (the attention
layers on K1-K3 through ``nn.functional.scaled_dot_product_attention``),
with :mod:`regularizer`'s ``L1Decay``/``L2Decay`` for the optimizers,
the recurrent layers and beam search (``nn.LSTM``, ``nn.BeamSearchDecoder``,
``nn.dynamic_decode``).  The high-level path trains any such network:
:class:`Model` (``prepare``, ``fit``, ``evaluate``, ``predict``, callbacks
of :mod:`callbacks`) over :mod:`io`'s ``DataLoader`` (spawned workers
handing batches over a shared-memory ring), with :mod:`metric`,
:func:`summary` and :func:`flops`.  Paddle's tensor ops are plain
functions on ``torch.Tensor`` at the top level (``paddle.concat``,
``paddle.topk``, ..., :mod:`.ops`), with the dtype names, :func:`to_tensor`
and ``paddle.linalg``; :mod:`vision` has the model zoo, the transforms,
the datasets, the detection operators and the image backend, and
:mod:`text` Viterbi decoding and the text datasets; :mod:`sparse` is
COO/CSR tensors and the sparse 3-D convolutions (their rulebooks built
on the card), :mod:`fft` and :mod:`signal` the transforms and the STFT,
:mod:`distribution` the distributions, transforms and KL registry.
:func:`enable_static` turns on the program mode of :mod:`static`
(``Program``, ``Executor``, the ``static.nn`` builders, ``minimize`` on a
program, inference save and load); :mod:`profiler` has the ``Profiler``
over ``torch.profiler``; :mod:`custom_kernel` (``utils.register_op``,
``register_kernel``), ``utils.cpp_extension``, :mod:`hub` and
:mod:`onnx` are the extension points.
Everything runs on ``cuda`` unless the caller passes
``device="cpu"`` (for :mod:`nn`'s layers, :func:`set_device` or
:func:`device_guard` with ``"cpu"``; with no card, building on the
default device raises); on CPU tensors each kernel's plain PyTorch
version runs instead.
"""
from . import tensor as _tensor
from .ops import *  # noqa: F401,F403 — the paddle.* op surface
from .ops import linalg
from .tensor import *  # noqa: F401,F403 — dtypes, to_tensor, helpers
from . import (  # noqa: E402
    amp, autograd, custom_kernel, device, distributed, distribution, fft,
    flags, framework, hapi, hub, incubate, inference, io, jit, metric,
    models, nn, obs, onnx, ops, optimizer, profiler, regularizer, rng,
    serving, signal, sparse, static, sysconfig, text, utils, version,
    vision,
)
from .batch import batch  # noqa: E402
from .device import device_guard, get_device, set_device  # noqa: E402
from .flags import define_flag, get_flags, set_flags  # noqa: E402
from .hapi import Model, callbacks, flops, summary  # noqa: E402
from .inference import create_engine  # noqa: E402
from .rng import get_rng_state, seed, set_rng_state  # noqa: E402
from .training import build_train_step  # noqa: E402

__all__ = ["Model", "amp", "autograd", "batch", "build_train_step",
           "callbacks", "create_engine", "custom_kernel", "define_flag",
           "device", "device_guard", "distributed", "distribution", "fft",
           "flags", "flops", "framework", "get_device", "get_flags",
           "get_rng_state", "hapi", "hub", "incubate",
           "inference", "io", "jit", "linalg", "metric", "models", "nn",
           "obs", "onnx", "ops", "optimizer", "profiler", "regularizer", "rng",
           "seed", "serving", "set_device", "set_flags", "set_rng_state",
           "signal", "sparse", "static", "summary", "sysconfig", "text",
           "utils", "version", "vision"] \
    + ops.OPS + _tensor.__all__
