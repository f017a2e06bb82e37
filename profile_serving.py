#!/usr/bin/env python3
"""Where a serving step's time goes on the card, for the port.

    python3 profile_serving.py [--steps 10]     # one CUDA card

Builds the paged Llama-2 7B engine of ``chip_smoke.py``'s serve phase
(bf16, random weights from seed 0, 8 slots, block size 16), and traces
with ``torch.profiler``:

- first, ``--steps`` decode steps of ``chip_smoke.py``'s serve_tenancy
  engine (the same geometry, 4 LoRA adapter lanes of rank 16 and the
  JSON grammar) with all 8 slots running over base and three adapters
  (the json slots of its traffic run as base: a json stream ends within
  11 tokens), traced as the plain decode steps below are; and the
  sampler's device ms for one decode step's ``[8, vocab]`` logits with
  and without the grammar table (``sample_all`` captured into a graph of
  its own and replayed), the grammar mask's share of it;
- ``--steps`` decode steps with all 8 slots running, timed first
  without the profiler and then traced;
- one admission step: a 1000-token tail prefilled after a 512-token
  prefix-cache hit (bucket 1024), plus that step's decode.  Its wall time
  is taken without the profiler, on a like request admitted before any
  tracing (the profiler slows the host).

- ``--rounds`` speculative rounds (``chip_smoke.py``'s serve_spec
  engine over the same model: paged, max_seq 2048, k 4, a draft of
  JackFram/llama-68m's shape) with all 8 slots running, traced as the
  decode steps are, and split by part: the device ms of the round's
  draft-decode programs and of its verify program (CUDA events around
  each program call), and of the acceptance alone (the verify's
  ``accept_speculative`` at its shapes, captured into a graph of its own
  and replayed).

For each it prints one JSON line: host wall time per step (synchronised),
device busy time per step (the union of kernel intervals), the idle
share, the device launches per step (kernels the profiler saw, those of
replayed CUDA graphs included), the port's kernels' launch counts per
step (a replay adds its capture's; each must equal the profiler's count
of that kernel, or the run fails), the host's enqueue time per step (the
time spent in the engine's step programs: copying the inputs in and
replaying, or capturing at a first call), device time by kernel group
(the port's kernels K4/K5/K1, matrix products, the rest) and the top
kernels.  No phase falls back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
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
          ("K1 flash_fwd_dropout", ("flash_fwd_dropout_kernel",)),
          ("K2 flash_bwd_dkv_dropout", ("flash_bwd_dkv_dropout_kernel",)),
          ("K3 flash_bwd_dq_dropout", ("flash_bwd_dq_dropout_kernel",)),
          ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet",
                      "sm90_")),
          ("elementwise/reduce", ("elementwise", "vectorized", "reduce",
                                  "unrolled", "index", "scatter", "gather",
                                  "cat", "copy", "fill", "softmax", "sort",
                                  "argmax", "distribution")))


#: seconds of idle card at the start of every profiler window
WINDOW_LEAD_S = 0.05


def port_kernel_counts(events) -> dict:
    """Per kernel of the port (``kernels.KERNELS``' names), the device
    launches among the profiler's ``events`` (by the kernel's function
    name, ``paged_decode`` -> ``paged_decode_kernel<...>``)."""
    from paddle_tpu_torch.ops.kernels import KERNELS

    return {n: sum(f"{n}_kernel" in e.name for e in events)
            for n in KERNELS}


def check_counts(counted: dict, profiled: dict) -> None:
    """The wrappers' counts (a replayed graph adds its capture's) must be
    the device launches the profiler saw, kernel by kernel."""
    if counted != profiled:
        raise AssertionError(f"launch counts {counted} differ from the "
                             f"kernels the profiler saw {profiled}")


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def trace(fn, n_steps: int, plain=None, enqueue=None) -> dict:
    """Run ``plain`` (default ``fn``) ``n_steps`` times on the host clock,
    then ``fn`` ``n_steps`` times under the profiler; per-step figures
    (``wall_ms_per_step``, the idle share and the enqueue time are the
    untraced run's).  The idle share is taken against the unprofiled wall
    time (the profiler slows the host).  ``enqueue``: the list that the
    engine's step programs append their host seconds to."""
    plain = plain or fn
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels as port_kernels

    torch.cuda.synchronize()
    if enqueue is not None:
        enqueue.clear()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        plain()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    enqueue_s = sum(enqueue) if enqueue is not None else None
    port_kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler can lose the first device records of its window (a
        # prefix of ~700 of a decode step's, in 2 of 80 one-step windows
        # on an H100), never with the card idle the window's first 50 ms
        time.sleep(WINDOW_LEAD_S)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = port_kernels.launch_counts()
    # device events, less the user annotations the profiler also records
    # on the device timeline (e.g. "Optimizer.step#AdamW.step")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    profiled = port_kernel_counts(kernels)
    check_counts(counted, profiled)
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
        # the wrappers' counts, each equal to the profiler's
        "port_launches_per_step": {n: c / n_steps
                                   for n, c in counted.items() if c},
        "enqueue_ms_per_step": (None if enqueue_s is None
                                else enqueue_s * 1e3 / n_steps),
        "groups_ms_per_step": {g: us / per for g, us in
                               sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:120], "ms_per_step": us / per,
                         "calls_per_step": c / n_steps}
                        for n, (us, c) in top],
    }


def acceptance_ms(eng) -> float:
    """Device ms of one round's acceptance at ``eng``'s verify shapes
    (``[slots, k+1, vocab]`` f32 logits of both models), on samplers
    staged like the serve_spec traffic's (greedy, temperature, top-k,
    top-p in turn), captured into a CUDA graph and replayed."""
    from paddle_tpu_torch.serving import DeviceSampler

    S, W, V = eng.num_slots, eng.spec.k + 1, eng.config.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(0)
    tl, dl = (torch.randn((S, W, V), generator=gen, device="cuda")
              for _ in range(2))
    props = torch.randint(0, V, (S, W - 1), generator=gen, device="cuda",
                          dtype=torch.int32)
    cap = torch.full((S,), W, dtype=torch.int32, device="cuda")
    active = torch.ones(S, dtype=torch.int32, device="cuda")
    tgt, drf = (DeviceSampler(S, device="cuda") for _ in range(2))
    laws = chip_smoke.sampling_laws(0)
    for slot in range(S):
        tgt.stage_slot(slot, laws[slot % len(laws)], slot)
        drf.stage_slot(slot, laws[slot % len(laws)], slot + 100)

    def accept():
        tgt.accept_speculative(tl, dl, props, cap, active, drf)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        accept()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        accept()
    return chip_smoke.cuda_ms(graph.replay)


def profile_rounds(model, card: str, n_rounds: int) -> None:
    """serve_spec's engine over ``model`` with its 8 slots running: the
    rounds traced, and each split into draft steps, verify and
    acceptance."""
    from paddle_tpu_torch.serving import Engine, SpecConfig

    eng = Engine(model, **chip_smoke.SPEC_ENGINE,
                 speculation=SpecConfig(
                     draft_model=chip_smoke.spec_draft_68m(
                         "cuda", torch.bfloat16), k=chip_smoke.SPEC_K))
    eng.warmup()
    reqs = chip_smoke.make_requests(eng.config.vocab_size, 8, 512,
                                    chip_smoke.PAGED_TAILS, seed=0)
    for p, smp in reqs:
        eng.add_request(p, sampling=smp, max_new_tokens=400)
    for _ in range(3):
        eng.step()
    if len(eng.running) != 8:
        raise RuntimeError(f"expected 8 running slots, got "
                           f"{len(eng.running)}")
    calls = chip_smoke.record_programs(eng)
    rounds0 = eng.metrics.spec_rounds
    accepted0 = eng.metrics.spec_accepted
    for _ in range(n_rounds):
        eng.step()
    by_kind = chip_smoke.program_ms(calls)
    del eng.programs.run
    n = eng.metrics.spec_rounds - rounds0
    traced = trace(eng.step, n_rounds)
    print(json.dumps({
        "phase": "spec_rounds", "card": card, "k": eng.spec.k,
        "draft": "llama-68m shape", "active_slots": 8,
        "accepted_per_round": (eng.metrics.spec_accepted - accepted0) / n,
        "split_ms_per_round": {
            "draft_steps": by_kind["draft_decode"]["ms"] / n,
            "verify": by_kind["verify"]["ms"] / n,
            "acceptance_in_verify": acceptance_ms(eng)},
        **traced}), flush=True)
    if eng.stats()["compile_cache"]["after_warmup"] != 0:
        raise RuntimeError("a program was built after warmup")


def sampler_ms(vocab: int, slots: int, grammar) -> float:
    """Device ms of one decode step's sampling (``sample_all`` over
    ``[slots, vocab]`` f32 logits, laws staged as serve_tenancy's mixed
    traffic), captured into a CUDA graph and replayed; ``grammar`` a
    ``GrammarTable`` or None."""
    from paddle_tpu_torch.serving import DeviceSampler

    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((slots, vocab), generator=gen, device="cuda")
    drew = torch.ones(slots, dtype=torch.int32, device="cuda")
    smp = DeviceSampler(slots, device="cuda", grammar=grammar)
    for slot, (_, tenant, law) in enumerate(chip_smoke.mixed_requests(
            [([0], None)] * slots, seed=0)):
        if grammar is None:
            law = dataclasses.replace(law, grammar=None)
        smp.stage_slot(slot, law, slot)

    def draw():
        smp.sample_all(logits, drew)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        draw()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        draw()
    return chip_smoke.cuda_ms(graph.replay)


def profile_tenancy(model, card: str, n_steps: int) -> None:
    """serve_tenancy's engine over ``model`` with its 8 slots running
    over the tenants: the decode steps traced; the sampler's ms with and
    without the grammar table."""
    eng = chip_smoke.tenancy_engine(model, eos=2, kv_layout="paged",
                                    block_size=16, min_bucket=16,
                                    num_slots=8)
    reqs = chip_smoke.make_requests(eng.config.vocab_size, 8, 512,
                                    chip_smoke.PAGED_TAILS, seed=0)
    for p, tenant, law in chip_smoke.mixed_requests(reqs, seed=7):
        if tenant == "json":
            # a json stream ends within 11 tokens: keep its slot busy with
            # the base model instead, so that 8 slots decode throughout
            law = dataclasses.replace(law, grammar=None)
        eng.add_request(p, sampling=law, max_new_tokens=400)
    for _ in range(3):
        eng.step()
    if len(eng.running) != 8:
        raise RuntimeError(f"expected 8 running slots, got "
                           f"{len(eng.running)}")
    tenants = sorted(r.tenant for r in eng.running.values())
    traced = trace(eng.step, n_steps)
    from paddle_tpu_torch.serving import GrammarTable, JsonArrayGrammar

    vocab = eng.config.vocab_size
    with_g = sampler_ms(vocab, 8, GrammarTable(
        vocab, {"json": JsonArrayGrammar(eos_token_id=2)}, device="cuda"))
    without = sampler_ms(vocab, 8, None)
    print(json.dumps({
        "phase": "tenancy_steps", "card": card, "active_slots": 8,
        "tenants": tenants,
        "adapter_targets": len(eng.adapter_pool.banks),
        "adapter_lanes_gb": eng.adapter_pool.nbytes() / 2 ** 30,
        "sampler_ms": {"grammar_table": with_g, "none": without,
                       "grammar_share": 1.0 - without / with_g},
        **traced}), flush=True)
    if eng.stats()["compile_cache"]["after_warmup"] != 0:
        raise RuntimeError("a program was built after warmup")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch import create_engine
    from paddle_tpu_torch.serving import Engine

    card = chip_smoke.card_line()
    model = Engine.resolve_model("llama:llama2-7b", device="cuda",
                                 dtype=torch.bfloat16, seed=0)
    profile_tenancy(model, card, args.steps)
    gc.collect()
    torch.cuda.empty_cache()
    eng = create_engine(model, kv_layout="paged", block_size=16,
                        min_bucket=16, num_slots=8)
    warm = eng.warmup()
    # the host's enqueue: the seconds of each step program's call
    enqueue, run = [], eng.programs.run

    def timed_run(*args):
        t0 = time.perf_counter()
        out = run(*args)
        enqueue.append(time.perf_counter() - t0)
        return out

    eng.programs.run = timed_run
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
    enqueue.clear()
    t0 = time.perf_counter()
    admit(tails[0])()
    torch.cuda.synchronize()
    admission_wall = time.perf_counter() - t0
    admission_enqueue = sum(enqueue)
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
    decode = trace(eng.step, args.steps, enqueue=enqueue)
    print(json.dumps({"phase": "decode_steps", "card": card,
                      "active_slots": 8, "lengths_at_start": lens,
                      **decode}),
          flush=True)
    if len(eng.running) != 7:
        raise RuntimeError("the short request did not retire on time")
    adm = trace(admit(tails[1]), 1, plain=lambda: None)
    adm["wall_ms_per_step"] = admission_wall * 1e3
    adm["enqueue_ms_per_step"] = admission_enqueue * 1e3
    adm["device_idle_share"] = max(
        0.0, 1.0 - adm["device_busy_ms_per_step"] / (admission_wall * 1e3))
    print(json.dumps({"phase": "admission_step", "card": card,
                      "tail": 1000, "prefix_hit": 512, "active_slots": 8,
                      **adm}), flush=True)
    cc = eng.stats()["compile_cache"]
    print(json.dumps({"phase": "programs", "card": card,
                      "warmup_misses": warm["compile_misses"],
                      "compile_cache": cc}), flush=True)
    if cc["after_warmup"] != 0:
        raise RuntimeError(f"step programs built after warmup: {cc}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    profile_rounds(model, card, args.rounds)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
