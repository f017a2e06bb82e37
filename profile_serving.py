#!/usr/bin/env python3
"""Where a serving step's time goes on the card, for the port.

    python3 profile_serving.py [--steps 10]     # one CUDA card

Builds the paged Llama-2 7B engine of ``chip_smoke.py``'s serve phase
(bf16, random weights from seed 0, 8 slots, block size 16), and traces
with ``torch.profiler``:

- ``--steps`` decode steps with all 8 slots running, timed first
  without the profiler and then traced;
- one admission step: a 1000-token tail prefilled after a 512-token
  prefix-cache hit (bucket 1024), plus that step's decode.  Its wall time
  is taken without the profiler, on a like request admitted before any
  tracing (the profiler slows the host).

For each it prints one JSON line: host wall time per step (synchronised),
device busy time per step (the union of kernel intervals), the idle
share, device time by kernel group (the port's kernels K4/K5/K1, matrix
products, the rest) and the top kernels.  No phase falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import numpy as np
import torch

import chip_smoke

GROUPS = (("K4 paged_decode", ("paged_decode_kernel",)),
          ("K5 paged_prefill", ("paged_prefill_kernel",)),
          ("K1 flash_fwd", ("flash_fwd_kernel",)),
          ("K2 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
          ("K3 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
          ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet",
                      "sm90_")),
          ("elementwise/reduce", ("elementwise", "vectorized", "reduce",
                                  "unrolled", "index", "scatter", "gather",
                                  "cat", "copy", "fill", "softmax", "sort",
                                  "argmax", "distribution")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def trace(fn, n_steps: int, plain=None) -> dict:
    """Run ``plain`` (default ``fn``) ``n_steps`` times on the host clock,
    then ``fn`` ``n_steps`` times under the profiler; per-step figures
    (``wall_ms_per_step`` and the idle share are the untraced run's).
    The idle share is taken against the unprofiled wall time (the
    profiler slows the host)."""
    plain = plain or fn
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        plain()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device events, less the user annotations the profiler also records
    # on the device timeline (e.g. "Optimizer.step#AdamW.step")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s                       # microseconds
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        rec = by_name[e.name]
        rec[0] += e.time_range.elapsed_us()
        rec[1] += 1
    groups = defaultdict(float)
    for name, (us, _) in by_name.items():
        groups[group_of(name)] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    per = 1e3 * n_steps                          # us -> ms per step
    return {
        "steps": n_steps,
        "wall_ms_per_step": plain_wall * 1e3 / n_steps,
        "profiled_wall_ms_per_step": wall * 1e3 / n_steps,
        "device_busy_ms_per_step": busy / per,
        "device_idle_share": max(0.0, 1.0 - busy / (plain_wall * 1e6)),
        "kernel_launches_per_step": len(kernels) / n_steps,
        "groups_ms_per_step": {g: us / per for g, us in
                               sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:120], "ms_per_step": us / per,
                         "calls_per_step": c / n_steps}
                        for n, (us, c) in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch import create_engine

    card = chip_smoke.card_line()
    eng = create_engine("llama:llama2-7b", device="cuda",
                        dtype=torch.bfloat16, kv_layout="paged",
                        block_size=16, min_bucket=16, num_slots=8, seed=0)
    eng.warmup()
    reqs = chip_smoke.make_requests(
        eng.config.vocab_size, 8, 512, [64, 1000, 300, 128, 777, 200, 512,
                                        96], seed=0)
    # request 0 fills the prefix cache; the admissions are of 1000-token
    # tails after its 512-token system prompt (a prefix-cache hit)
    rs = np.random.RandomState(1)
    system = reqs[0][0][:512]
    tails = [system + rs.randint(0, eng.config.vocab_size,
                                 (1000,)).tolist() for _ in range(2)]

    def admit(prompt):
        return lambda: (eng.add_request(prompt, max_new_tokens=200),
                        eng.step())

    eng.add_request(reqs[0][0], sampling=reqs[0][1], max_new_tokens=200)
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    admit(tails[0])()
    torch.cuda.synchronize()
    admission_wall = time.perf_counter() - t0
    # six more fill the 8 slots; the last one retires with the last traced
    # decode step (1 token at admission, one per step after), freeing the
    # slot for the traced admission.  Nothing is profiled before the
    # untraced decode steps are timed.
    settle = 3
    for i, (p, smp) in enumerate(reqs[2:]):
        last = i == len(reqs) - 3
        eng.add_request(p, sampling=smp, max_new_tokens=(
            1 + settle + 2 * args.steps if last else 200))
    for _ in range(settle):
        eng.step()
    if len(eng.running) != 8 or eng.queue:
        raise RuntimeError(f"expected 8 running slots, got "
                           f"{len(eng.running)}")
    lens = sorted(r._seq_len for r in eng.running.values())
    decode = trace(eng.step, args.steps)
    print(json.dumps({"phase": "decode_steps", "card": card,
                      "active_slots": 8, "lengths_at_start": lens,
                      **decode}),
          flush=True)
    if len(eng.running) != 7:
        raise RuntimeError("the short request did not retire on time")
    adm = trace(admit(tails[1]), 1, plain=lambda: None)
    adm["wall_ms_per_step"] = admission_wall * 1e3
    adm["device_idle_share"] = max(
        0.0, 1.0 - adm["device_busy_ms_per_step"] / (admission_wall * 1e3))
    print(json.dumps({"phase": "admission_step", "card": card,
                      "tail": 1000, "prefix_hit": 512, "active_slots": 8,
                      **adm}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
