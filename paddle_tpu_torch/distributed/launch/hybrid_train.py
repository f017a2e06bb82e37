"""A worker of the launcher: GPT training through fleet, gradient merge,
and every collective, on one rank.

Run it through the launcher (the rank's card is ``PADDLE_LOCAL_RANK``)::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 1 \\
        paddle_tpu_torch/distributed/launch/hybrid_train.py --out res.json

with the repository on ``PYTHONPATH``.  It writes one JSON object to
``--out`` and prints it as its last line:

- ``fleet``: ``build_train_step`` (the ``bench.py`` recipe: ``fleet.init``
  with every degree 1 and ``sharding_configs`` stage 1,
  ``fleet.distributed_model``, ``fleet.distributed_optimizer(AdamW)``,
  AMP O2 bf16, the step under ``jit.to_static``) at ``--config`` (its
  depth cut to ``--layers``), ``--warmup`` then ``--steps`` steps on the
  seeded batch: the losses, the timed steps'
  ms, the kernels' launches of those steps (counted from 0 before the
  first), the program cache, and the wrappers' classes.
- ``merge``: the same model in f32 with dropout 0, SGD at ``GM_LR``
  through ``fleet.distributed_optimizer`` with ``gradient_merge_configs =
  {"k_steps": 4, "avg": True}``, eagerly over 4 micro-batches of
  ``--batch / 4``, against one full-batch SGD update of the same model:
  the max abs difference of the parameters; and whether the merge
  wrapper refuses a ``jit.to_static`` step.
- ``collectives``: every function of ``distributed.collective`` on the
  device in this world (each against its expected value), and one
  ``all_reduce`` captured in a CUDA graph on a side stream and replayed
  (card only), against the eager result.

``--probe-two-ranks`` instead makes a world of two ranks on this one
card (two processes, both on ``cuda:0``) and reports what the backend
answers to one all-reduce.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    # run as a script: the repository, not this directory, on the path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))

import numpy as np
import torch

GM_STEPS = 4
GM_LR = 1e-2
SEED = 0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_fleet(args) -> dict:
    from paddle_tpu_torch import build_train_step
    from paddle_tpu_torch.distributed import DistributedStrategy
    from paddle_tpu_torch.ops import kernels

    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": 1}
    s.sharding_configs = {"stage": 1}
    ts = build_train_step(args.config, batch=args.batch, seq=args.seq,
                          device=args.device, seed=SEED, strategy=s,
                          to_static=True, num_layers=args.layers)
    kernels.reset_launches()
    losses = [ts.train_step(ts.x, ts.y) for _ in range(args.warmup)]
    _sync(args.device)
    t0 = time.perf_counter()
    losses += [ts.train_step(ts.x, ts.y) for _ in range(args.steps)]
    _sync(args.device)
    wall = time.perf_counter() - t0
    f = ts.train_step
    return {"losses": [float(v) for v in losses],
            "step_ms": wall * 1e3 / max(args.steps, 1),
            "launches": kernels.launch_counts(),
            "layers": ts.model.config.num_hidden_layers,
            "program_cache": {"programs": len(f.program_cache),
                              "misses": f.misses, "hits": f.hits,
                              "captures": f.captures},
            "model": type(ts.model).__name__,
            "optimizer": type(ts.optimizer).__name__}


def run_merge(args) -> dict:
    from paddle_tpu_torch import jit, rng
    from paddle_tpu_torch.distributed import DistributedStrategy, fleet
    from paddle_tpu_torch.models import GPT_CONFIGS, GPTForCausalLM
    from paddle_tpu_torch.optimizer import SGD

    s = DistributedStrategy()
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": GM_STEPS, "avg": True}
    fleet.init(is_collective=True, strategy=s, device=args.device)
    rng.seed(SEED)
    cfg = GPT_CONFIGS[args.config](hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0)
    if args.layers is not None:
        cfg.num_hidden_layers = args.layers
    gen = torch.Generator(device=args.device).manual_seed(SEED)
    model = fleet.distributed_model(
        GPTForCausalLM(cfg, device=args.device, generator=gen))
    params = list(model.parameters())
    start = [p.detach().clone() for p in params]
    rs = np.random.RandomState(SEED)
    x = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                    (args.batch, args.seq))).to(args.device)
    y = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                    (args.batch, args.seq))).to(args.device)

    # one update on the whole batch
    full = SGD(params, lr=GM_LR)
    model.compute_loss(x, y).backward()
    full.step()
    full.clear_grad()
    want = [p.detach().clone() for p in params]
    moved = max(float((w - p0).abs().max()) for w, p0 in zip(want, start))
    with torch.no_grad():
        for p, p0 in zip(params, start):
            p.copy_(p0)
    del start

    # the same update merged over micro-batches
    opt = fleet.distributed_optimizer(SGD(params, lr=GM_LR), s)
    n = args.batch // GM_STEPS
    for i in range(GM_STEPS):
        model.compute_loss(x[i * n:(i + 1) * n],
                           y[i * n:(i + 1) * n]).backward()
        opt.step()
        opt.clear_grad()
    diff = max(float((p.detach() - w).abs().max())
               for p, w in zip(params, want))

    @jit.to_static
    def step(a, b):
        model.compute_loss(a, b).backward()
        opt.step()

    try:
        step(x[:n], y[:n])
        refused = False
    except RuntimeError as e:
        refused = "to_static" in str(e)
    opt.clear_grad()
    return {"max_abs_diff": diff, "micro_batches": GM_STEPS,
            "micro_batch": n, "update_max_abs": moved,
            "refuses_to_static": refused,
            "optimizer": type(opt).__name__}


def run_collectives(device) -> dict:
    """Each function of the collective module on ``device`` tensors in this
    world, against its expected value; ``{name: ok}``."""
    import torch.distributed as dist

    from paddle_tpu_torch import distributed as pdist

    n, r = dist.get_world_size(), dist.get_rank()
    dev = torch.device(device)
    base = torch.arange(6, dtype=torch.float32, device=dev).view(2, 3) + 1
    ok = {}

    def check(name, got, want):
        ok[name] = bool(torch.equal(got, want))

    for op, want in ((pdist.ReduceOp.SUM, base * n),
                     (pdist.ReduceOp.MAX, base), (pdist.ReduceOp.MIN, base),
                     (pdist.ReduceOp.PROD, base ** n),
                     (pdist.ReduceOp.AVG, base)):
        t = base.clone()
        pdist.all_reduce(t, op=op)
        check(f"all_reduce/{op}", t, want)
    t = base.clone()
    pdist.all_reduce_chunked(t, chunks=3)
    check("all_reduce_chunked", t, base * n)
    check("all_gather", pdist.all_gather(base), base.expand(n, 2, 3))
    lst = []
    pdist.all_gather(lst, base)
    check("all_gather/list", torch.stack(lst), base.expand(n, 2, 3))
    t = base.clone()
    pdist.broadcast(t, src=0)
    check("broadcast", t, base)
    t = base.clone()
    pdist.reduce(t, dst=0)
    check("reduce", t, base * n if r == 0 else base)
    t = torch.zeros(3, device=dev)
    pdist.scatter(t, list(base.new_ones(n, 3) * 7), src=0)
    check("scatter", t, torch.full((3,), 7.0, device=dev))
    rows = torch.arange(n * 3, dtype=torch.float32, device=dev).view(n, 3)
    check("alltoall", pdist.alltoall(rows), rows)
    out = []
    pdist.alltoall(list(rows), out)
    check("alltoall/list", torch.stack(out), rows)
    check("reduce_scatter", pdist.reduce_scatter(rows), rows[r] * n)
    t = torch.empty(3, device=dev)
    pdist.reduce_scatter(t, list(rows))
    check("reduce_scatter/list", t, rows[r] * n)
    pdist.barrier()
    ok["barrier"] = True
    check("ppermute", pdist.ppermute(base, [(i, i) for i in range(n)]), base)
    g = pdist.new_group([r])
    t = base.clone()
    pdist.all_reduce(t, group=g)
    check("new_group", t, base)
    ok["get_group"] = pdist.get_group(0).ranks == list(range(n))
    return ok


def capture_all_reduce(device) -> dict:
    """One ``all_reduce`` captured in a CUDA graph on a side stream, and
    replayed: the replay against the same call run eagerly."""
    from paddle_tpu_torch import distributed as pdist

    x = torch.arange(1024, dtype=torch.float32, device=device) / 7
    eager = x * 2
    pdist.all_reduce(eager)
    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm = static * 2
        pdist.all_reduce(warm)           # the communicator, outside capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = static * 2
        pdist.all_reduce(out)
    static.copy_(x)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return {"equal": bool(torch.equal(out, eager)),
            "max_abs_diff": float((out - eager).abs().max())}


def probe_two_ranks() -> dict:
    """Two processes, one world, both on ``cuda:0``: the backend's answer
    to one all-reduce."""
    import subprocess

    if os.environ.get("PADDLE_TRAINERS_NUM") == "2":
        import torch.distributed as dist

        os.environ["PADDLE_LOCAL_RANK"] = "0"        # both on one card
        from paddle_tpu_torch import distributed as pdist

        pdist.init_parallel_env("cuda")
        t = torch.ones(4, device="cuda")
        try:
            dist.all_reduce(t)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
        return {"all_reduce": t.tolist()}
    import signal

    me = os.path.abspath(__file__)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", me, "--probe-two-ranks"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=120)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)       # the launcher and workers
        text, _ = proc.communicate()
        rc = "timed out after 120 s"
    lines = [ln for ln in text.splitlines()
             if "NCCL" in ln or "rror" in ln or "all_reduce" in ln]
    return {"returncode": rc, "answer": lines[-8:]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hybrid_train")
    p.add_argument("--out", default=None)
    p.add_argument("--config", default="gpt2-345m")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the configuration's depth")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--probe-two-ranks", action="store_true")
    args = p.parse_args(argv)
    if args.probe_two_ranks:
        res = probe_two_ranks()
    else:
        if torch.device(args.device).type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
            torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        res = {"fleet": run_fleet(args)}
        import gc

        gc.collect()
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
        res["merge"] = run_merge(args)
        res["collectives"] = run_collectives(args.device)
        if torch.device(args.device).type == "cuda":
            res["capture"] = capture_all_reduce(args.device)
        import torch.distributed as dist

        res["world"] = {"backend": dist.get_backend(),
                        "size": dist.get_world_size()}
        res["seconds"] = time.perf_counter() - t0
        dist.destroy_process_group()
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
