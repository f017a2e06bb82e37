"""The GPT train step: model, AdamW, AMP and the seeded batch.

Port of ``bench.py`` ``build_bench`` (:140-205), the step the JAX package
was built and benchmarked around: ``fleet.init``, ``GPTForCausalLM``
through ``fleet.distributed_model``, ``AdamW`` through
``fleet.distributed_optimizer`` (the identity in one process; under a
launcher, the wrappers, which add no work at degree 1), the AMP
level of ``PADDLE_TPU_BENCH_AMP`` (:183-194: O2 is ``amp.decorate``, bf16
parameters and f32 masters; O1 keeps f32 parameters and no masters), and
a step of ``compute_loss`` inside ``amp.auto_cast(dtype="bfloat16",
level=amp_level)`` (the fused vocab-blocked cross-entropy),
backward, ``step`` and ``clear_grad`` compiled with ``jit.to_static`` (on
the card one CUDA graph a step; ``to_static=False`` runs it eagerly).  The bench
step has dropout 0 and no recompute; the GPT-2 training recipe (dropout,
a learning-rate schedule, gradient clipping, activation recompute) is
asked for with ``dropout``, ``lr`` (a scheduler), ``grad_clip`` and
``recompute``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from . import amp, jit, rng
from .distributed import fleet
from .models.gpt import GPT_CONFIGS, GPTForCausalLM
from .optimizer import AdamW
from .optimizer.lr import LRScheduler

__all__ = ["TrainStep", "build_train_step"]


class TrainStep(NamedTuple):
    model: GPTForCausalLM
    optimizer: AdamW
    train_step: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    x: torch.Tensor
    y: torch.Tensor


def build_train_step(config: str = "gpt2-345m", *, batch: int = 8,
                     seq: int = 1024, device="cuda", amp_level: str = "O2",
                     lr: Union[float, LRScheduler] = 1e-4,
                     moment_dtype: Union[None, str, torch.dtype] = None,
                     seed: int = 0, kernel: str = "cuda",
                     to_static: bool = True, dropout: float = 0.0,
                     recompute: bool = False, grad_clip=None,
                     strategy: Optional[fleet.DistributedStrategy] = None,
                     num_layers: Optional[int] = None) -> TrainStep:
    """Build the train step of ``bench.py`` for a ``GPT_CONFIGS`` name.

    Weights are drawn from ``torch.Generator(device).manual_seed(seed)``;
    the batch ``x, y`` (``[batch, seq]`` token ids) from
    ``np.random.RandomState(seed)``, ``x`` then ``y``, as ``bench.py``
    draws them; the dropout generator is seeded with ``seed``
    (``rng.seed``).  ``amp_level`` is ``"O2"`` (bf16 parameters, f32
    masters), ``"O1"`` (f32 parameters, the per-op bf16 policy of
    ``amp.auto_cast`` around ``compute_loss``) or ``"O0"`` (f32).
    ``train_step(x, y)`` runs
    ``compute_loss``, backward, the optimizer step and clears the
    gradients; it returns the loss (f32, on the device, not
    synchronised).  It is a ``jit.to_static`` function unless
    ``to_static=False``.  ``dropout`` is the hidden and the attention
    dropout rate, ``recompute`` runs each layer as a recompute region,
    ``lr`` is a float or an ``LRScheduler`` (the caller steps it),
    ``grad_clip`` a clip of ``nn.clip``.  ``strategy`` is the one
    ``fleet.init`` gets (default: every degree 1); under a launcher (one
    process a rank) ``fleet.init`` makes the world, and the model and the
    optimizer come back wrapped.  ``num_layers`` cuts the configuration's
    depth (its widths stay).  ``device`` defaults to ``"cuda"`` and
    raises where there is no card."""
    if amp_level not in ("O0", "O1", "O2"):
        raise ValueError(f"amp_level must be O0, O1 or O2, got "
                         f"{amp_level!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_train_step: device 'cuda' asked for, but "
                           "no CUDA device is available (pass device='cpu')")
    fleet.init(is_collective=True,
               strategy=strategy or fleet.DistributedStrategy(),
               device=device)
    rng.seed(seed)
    cfg = GPT_CONFIGS[config](recompute=recompute,
                              hidden_dropout_prob=dropout,
                              attention_probs_dropout_prob=dropout)
    if num_layers is not None:
        cfg.num_hidden_layers = int(num_layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = fleet.distributed_model(
        GPTForCausalLM(cfg, device=device, generator=gen, kernel=kernel))
    opt = fleet.distributed_optimizer(
        AdamW(model.parameters(), lr=lr, moment_dtype=moment_dtype,
              grad_clip=grad_clip))
    if amp_level == "O2":
        model, opt = amp.decorate(model, opt, level="O2")
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randint(0, cfg.vocab_size, (batch, seq)))
    y = torch.from_numpy(rs.randint(0, cfg.vocab_size, (batch, seq)))

    def train_step(inputs: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
        with amp.auto_cast(dtype="bfloat16", level=amp_level):
            loss = model.compute_loss(inputs, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    if to_static:
        train_step = jit.to_static(train_step)
    return TrainStep(model, opt, train_step, x.to(device), y.to(device))
