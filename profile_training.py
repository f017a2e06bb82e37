#!/usr/bin/env python3
"""Where a GPT-2 345M train step's time goes on the card, for the port.

    python3 profile_training.py [--steps 10] [--rounds 2]     # one CUDA card

Builds the train step of ``chip_smoke.py``'s train phase
(``build_train_step("gpt2-345m")``: batch 8 x 1024, bf16 AMP O2, AdamW
with f32 masters, random weights from seed 0) twice: compiled by
``jit.to_static`` (one CUDA graph a step) and eager (``to_static=False``).
It prints one JSON line for each of:

- ``train_turns``: the eager (E) and the graph (G) step in turns, E G G E
  ``--rounds`` times, ``--steps`` timed steps a turn after 3 warm-up steps
  each: per target the step ms of every turn, the median and quartiles,
  tokens/s, MFU, and the peak memory its build and warm-up added (the
  graph's pool included);
- ``train_step`` and ``train_step_graph``: each step traced with
  ``torch.profiler`` (``profile_serving.trace``): device busy time per
  step, the idle share, launches per step, device time by kernel group
  and the top kernels; the eager step also split into forward, backward
  and optimizer spans on the device clock (CUDA events);
- ``train_recipe_step`` and ``train_recipe_step_graph``: the step at the
  GPT-2 recipe (dropout 0.1, a warm-up then cosine schedule, a
  global-norm clip of 1.0, recompute off), traced the same way; beside
  the eager one, the device time a step of the hidden dropout's Philox
  passes (``rng.dropout_keep``) and of the whole hidden dropout, and of
  the clip's global norm, as groups of their own: their kernels are
  torch's generic elementwise and reduction kernels, with no name of
  their own, so each is timed alone at the step's shapes
  (``dropout_and_clip_ms``);
- ``cross_entropy``: the fused LM-head cross-entropy forward + backward
  alone at the step's shapes (hidden ``[8192, 1024]``, head
  ``[50304, 1024]``, bf16), traced the same way;
- ``optimizer``: ``AdamW.step()`` alone over the model's gradients;
- ``nn_encoder_step_graph``: ``chip_smoke.py``'s ``nn_encoder`` step
  (BERT-base's masked-LM model from the port's ``nn``, 8 x 512, bf16 O2,
  AdamW, dropout 0.1, one CUDA graph a step) traced the same way, with
  its AdamW step alone and its 25 hidden dropouts' device time alone at
  the step's shape (``nn_encoder_step``; alone: ``python3 -c "import
  profile_training as p; p.nn_encoder_step(10)"``);
- ``moe_step_graph``: ``chip_smoke.py``'s ``moe_train`` step (the 1.06 B
  MoE transformer, ``LookAhead(AdamW)``, one CUDA graph a step) traced
  the same way, with its optimizer step alone and one MoE layer's
  forward and backward alone (alone: ``python3 -c "import
  profile_training as p; p.moe_step(5)"``).

No phase falls back to the CPU.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np
import torch

import chip_smoke
from profile_serving import trace

TOKENS = 8 * 1024


def spans(ts, n_steps: int) -> dict:
    """Forward, backward and optimizer device-clock spans per step of an
    eager step."""
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
        ts.optimizer.clear_grad()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            total[name] += ev[i].elapsed_time(ev[i + 1])
    return {f"{k}_ms": v / n_steps for k, v in total.items()}


def build(to_static: bool, **kw):
    """A warmed step (3 steps) and the peak memory its build and warm-up
    added, in GiB."""
    from paddle_tpu_torch import build_train_step

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ts = build_train_step("gpt2-345m", batch=8, seq=1024, device="cuda",
                          to_static=to_static, **kw)
    for _ in range(3):
        ts.train_step(ts.x, ts.y)
    torch.cuda.synchronize()
    return ts, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def turns(targets: dict, n_steps: int, rounds: int) -> dict:
    """``targets`` (name -> warmed step) timed in turns: first, second,
    second, first, ``rounds`` times."""
    a, b = list(targets)
    ms = {a: [], b: []}
    for _ in range(rounds):
        for name in (a, b, b, a):
            ms[name].append(chip_smoke.timed_steps(targets[name], n_steps))
    n_params = sum(p.numel() for p in targets[a].model.parameters())
    out = {}
    for name, xs in ms.items():
        q = np.percentile(xs, [25, 50, 75])
        out[name] = {"step_ms": xs, "median_ms": q[1], "q1_ms": q[0],
                     "q3_ms": q[2], "tokens_per_s": TOKENS / q[1] * 1e3,
                     "mfu": TOKENS / q[1] * 1e3 * 6 * n_params
                     / chip_smoke.PEAK_FLOPS[torch.bfloat16]}
    return out


def dropout_and_clip_ms(ts, n_iters: int) -> dict:
    """Device ms of the recipe step's two groups of unnamed kernels, each
    timed alone (CUDA events, back to back) at the step's shapes and
    multiplied by its calls a step: a hidden dropout (the mask's Philox
    passes, ``rng.dropout_keep``, then the select and the scale) on a
    ``[8, 1024, 1024]`` bf16 activation, drawn ``1 + 2 * layers`` times a
    step without recompute; and the clip's global norm over the model's
    gradients, once a step."""
    from paddle_tpu_torch import rng
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.functional import dropout

    x = torch.randn((8, 1024, 1024), device="cuda").to(torch.bfloat16)
    gen = rng.default_generator("cuda")
    p = chip_smoke.RECIPE_DROPOUT
    hash_ms = chip_smoke.cuda_ms(
        lambda: rng.dropout_keep(gen.draw(), x.shape, p), iters=n_iters)
    drop_ms = chip_smoke.cuda_ms(lambda: dropout(x, p), iters=n_iters)
    ts.model.compute_loss(ts.x, ts.y).backward()
    grads = [g for _, g in ts.optimizer._params_grads()]
    norm_ms = chip_smoke.cuda_ms(
        lambda: ClipGradByGlobalNorm.global_norm(grads), iters=n_iters)
    ts.optimizer.clear_grad()
    draws = 1 + 2 * ts.model.config.num_hidden_layers
    return {"hidden_dropout_draws_per_step": draws,
            "dropout_hash_ms_per_draw": hash_ms,
            "dropout_ms_per_draw": drop_ms,
            "dropout_hash_ms_per_step": hash_ms * draws,
            "dropout_ms_per_step": drop_ms * draws,
            "clip_norm_ms_per_step": norm_ms}


def recipe(to_static: bool):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    return build(to_static, dropout=chip_smoke.RECIPE_DROPOUT,
                 lr=chip_smoke.recipe_schedule(),
                 grad_clip=ClipGradByGlobalNorm(1.0))


def nn_encoder_step(n_steps: int) -> dict:
    """Trace ``nn_encoder``'s compiled step after 3 warm-up steps; time
    its AdamW step alone (after one eager backward) and one hidden
    dropout at ``[8, 512, 768]`` bf16 (CUDA events), times the step's 25
    (the embeddings' and two a layer).  Prints and returns the line."""
    from paddle_tpu_torch import jit, rng
    from paddle_tpu_torch.nn import functional as F

    cfg = chip_smoke.BERT_BASE
    batch, seq = chip_smoke.NN_TRAIN
    data = chip_smoke.mlm_batch(cfg, batch, seq, "cuda")
    model, opt, body = chip_smoke.build_masked_lm(cfg, "cuda")
    step = jit.to_static(body)
    for _ in range(3):
        step(*data)
    res = trace(lambda: step(*data), n_steps)
    x = torch.randn((batch, seq, cfg["hidden_size"]), device="cuda") \
        .to(torch.bfloat16)
    draws = 1 + 2 * cfg["num_hidden_layers"]
    res["hidden_dropout_ms_per_step"] = draws * chip_smoke.cuda_ms(
        lambda: F.dropout(x, cfg["hidden_dropout_prob"]), iters=n_steps)
    res["philox_ms_per_step"] = draws * chip_smoke.cuda_ms(
        lambda: rng.dropout_keep(rng.default_generator("cuda").draw(),
                                 list(x.shape),
                                 cfg["hidden_dropout_prob"]),
        iters=n_steps)
    body(*data)                      # an eager step leaves the moments
    model(*data).backward()
    res["optimizer"] = trace(opt.step, n_steps)
    line = {"phase": "nn_encoder_step_graph", "card": chip_smoke.card_line(),
            "model": "bert-base-uncased masked LM (port nn)",
            "batch": batch, "seq": seq, **res}
    print(json.dumps(line), flush=True)
    return line


def moe_step(n_steps: int) -> dict:
    """Trace ``moe_train``'s compiled step (``chip_smoke.moe_gpt`` at
    ``MOE_GPT``, ``MOE_TRAIN``'s batch, bf16 O2, ``LookAhead(AdamW)``)
    after 3 warm-up steps, then its optimizer step alone (after one eager
    backward) and one MoE layer's forward and backward alone at the
    step's shapes.  Prints and returns the line."""
    from paddle_tpu_torch import amp, device as pdev, incubate, jit, \
        optimizer, rng

    cfg, shape = chip_smoke.MOE_GPT, chip_smoke.MOE_TRAIN
    rng.seed(0)
    with pdev.device_guard("cuda"):
        model = chip_smoke.moe_gpt(cfg)
    amp.decorate(model, level="O2")
    rs = np.random.RandomState(0)
    B, S = shape["batch"], shape["seq"]
    x = torch.from_numpy(rs.randint(0, cfg["vocab"], (B, S))).cuda()
    y = torch.from_numpy(rs.randint(0, cfg["vocab"], (B, S))).cuda()
    opt = incubate.LookAhead(optimizer.AdamW(model.parameters(),
                                             lr=shape["lr"]),
                             alpha=shape["alpha"], k=shape["k"])

    def body(ids, labels):
        with amp.auto_cast(dtype="bfloat16", level="O2"):
            loss = model(ids, labels)
        loss = loss + shape["aux"] * model.aux_loss()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    step = jit.to_static(body)
    for _ in range(3):
        step(x, y)
    res = trace(lambda: step(x, y), n_steps)
    with amp.auto_cast(dtype="bfloat16", level="O2"):
        loss = model(x, y)
    (loss + shape["aux"] * model.aux_loss()).backward()
    res["optimizer"] = trace(opt.step, n_steps)
    opt.clear_grad()
    moe = model.moe_layers()[0]
    h = torch.randn((B * S, cfg["hidden"]), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0)
                    ).to(torch.bfloat16).requires_grad_()

    def one_moe():
        moe(h).float().sum().backward()

    res["moe_layer"] = trace(one_moe, n_steps)
    line = {"phase": "moe_step_graph", "card": chip_smoke.card_line(),
            "model": "moe-gpt (chip_smoke.MOE_GPT)", "batch": B, "seq": S,
            **res}
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_training: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import fused_linear_cross_entropy

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    graph, graph_peak = build(True)
    eager, eager_peak = build(False)
    res = turns({"eager": eager, "graph": graph}, args.steps, args.rounds)
    res["eager"]["peak_added_gb"] = eager_peak
    res["graph"]["peak_added_gb"] = graph_peak
    print(json.dumps({"phase": "train_turns", "card": card,
                      "model": "gpt2-345m", "batch": 8, "seq": 1024,
                      "order": "E G G E", "rounds": args.rounds,
                      "steps_per_turn": args.steps, **res}), flush=True)
    by_phase = spans(eager, args.steps)
    print(json.dumps({"phase": "train_step", "card": card,
                      **by_phase, **trace(lambda: eager.train_step(
                          eager.x, eager.y), args.steps)}), flush=True)
    print(json.dumps({"phase": "train_step_graph", "card": card,
                      **trace(lambda: graph.train_step(graph.x, graph.y),
                              args.steps)}), flush=True)

    w = eager.model.gpt.embeddings.word_embeddings.weight.detach().clone() \
        .requires_grad_()
    h = torch.randn((8, 1024, 1024), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0)
                    ).to(torch.bfloat16).requires_grad_()

    def cross_entropy():
        fused_linear_cross_entropy(h, w, eager.y).backward()

    print(json.dumps({"phase": "cross_entropy", "card": card,
                      **trace(cross_entropy, args.steps)}), flush=True)
    eager.model.compute_loss(eager.x, eager.y).backward()
    print(json.dumps({"phase": "optimizer", "card": card,
                      **trace(eager.optimizer.step, args.steps)}),
          flush=True)
    del eager, graph, w, h, cross_entropy
    gc.collect()
    torch.cuda.empty_cache()

    for to_static in (False, True):
        ts, peak = recipe(to_static)
        step = trace(lambda: ts.train_step(ts.x, ts.y), args.steps)
        extra = {} if to_static else dropout_and_clip_ms(ts, args.steps)
        name = "train_recipe_step" + ("_graph" if to_static else "")
        print(json.dumps({"phase": name, "card": card,
                          "dropout": chip_smoke.RECIPE_DROPOUT,
                          "peak_added_gb": peak, **extra, **step}),
              flush=True)
        del ts
        gc.collect()
        torch.cuda.empty_cache()
    nn_encoder_step(args.steps)
    gc.collect()
    torch.cuda.empty_cache()
    moe_step(args.steps)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
