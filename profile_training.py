#!/usr/bin/env python3
"""Where a GPT-2 345M train step's time goes on the card, for the port.

    python3 profile_training.py [--steps 5]     # one CUDA card

Builds the train step of ``chip_smoke.py``'s train phase
(``build_train_step("gpt2-345m")``: batch 8 x 1024, bf16 AMP O2, AdamW
with f32 masters, random weights from seed 0), runs two warm-up steps,
and prints one JSON line for each of:

- ``train_step``: ``--steps`` steps on the host clock (synchronised),
  then the same number traced with ``torch.profiler``: device busy time
  per step, the idle share, launches per step, device time by kernel
  group (K1/K2/K3, matrix products, elementwise/reduce, other) and the top
  kernels; beside them the forward, backward and optimizer spans of an
  untraced step on the device clock (CUDA events);
- ``cross_entropy``: the fused LM-head cross-entropy forward + backward
  alone at the step's shapes (hidden ``[8192, 1024]``, head
  ``[50304, 1024]``, bf16), traced the same way;
- ``optimizer``: ``AdamW.step()`` alone over the model's gradients.

No phase falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

import chip_smoke
from profile_serving import trace


def spans(ts, n_steps: int) -> dict:
    """Forward, backward and optimizer device-clock spans per step."""
    names = ("forward", "backward", "optimizer")
    total = dict.fromkeys(names, 0.0)
    for _ in range(n_steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = ts.model.compute_loss(ts.x, ts.y)
        ev[1].record()
        loss.backward()
        ev[2].record()
        ts.optimizer.step()
        ev[3].record()
        ts.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            total[name] += ev[i].elapsed_time(ev[i + 1])
    return {f"{k}_ms": v / n_steps for k, v in total.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_training: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch import build_train_step
    from paddle_tpu_torch.ops import fused_linear_cross_entropy

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    ts = build_train_step("gpt2-345m", batch=8, seq=1024, device="cuda")
    for _ in range(2):
        ts.train_step(ts.x, ts.y)
    by_phase = spans(ts, args.steps)
    step = trace(lambda: ts.train_step(ts.x, ts.y), args.steps)
    print(json.dumps({"phase": "train_step", "card": card,
                      "model": "gpt2-345m", "batch": 8, "seq": 1024,
                      **by_phase, **step}), flush=True)

    w = ts.model.gpt.embeddings.word_embeddings.weight.detach().clone() \
        .requires_grad_()
    h = torch.randn((8, 1024, 1024), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0)
                    ).to(torch.bfloat16).requires_grad_()

    def cross_entropy():
        fused_linear_cross_entropy(h, w, ts.y).backward()

    print(json.dumps({"phase": "cross_entropy", "card": card,
                      **trace(cross_entropy, args.steps)}), flush=True)
    ts.model.compute_loss(ts.x, ts.y).backward()
    print(json.dumps({"phase": "optimizer", "card": card,
                      **trace(ts.optimizer.step, args.steps)}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
