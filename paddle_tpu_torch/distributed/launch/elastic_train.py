"""A worker of the launcher's elastic mode: the GPT train step under
``ResilientLoop`` with a ``MeshWatchdog``, resumed after a relaunch.

Run it through the elastic launcher (the rank's card is
``PADDLE_LOCAL_RANK``)::

    python -m paddle_tpu_torch.distributed.launch \\
        --elastic_coordinator COORD --np 1 --job_id smoke --max_restarts 2 \\
        paddle_tpu_torch/distributed/launch/elastic_train.py \\
        --root DIR --coord COORD --job_id smoke

with the repository on ``PYTHONPATH``.  Each life of the worker:

- builds ``build_train_step`` at ``--config`` (the ``bench.py`` recipe:
  ``fleet.init`` from the launcher's world, the wrappers, AMP O2 bf16,
  one CUDA graph a step) on its seeded batch;
- runs it under ``ResilientLoop(DIR/ckpt, save_every=--save_every,
  mesh_watchdog=MeshWatchdog(FileCoordinator(COORD), ...,
  collective_timeout=--deadline))``, which first resumes from the newest
  format-2 generation;
- in its first life only (no ``DIR/armed`` marker yet) arms
  ``train.straggler@--stall_at:stall=--stall`` in the environment, so
  that step stalls past the deadline: the watchdog persists its crash
  artifacts and exits 101, and the launcher relaunches the worker, which
  resumes from the last generation.

Every event goes as one JSON line into ``DIR/events.jsonl``: ``start``
(the life, its pid and wall time), ``step`` (step, loss, wall time at
its end, the life's kernel launches so far), ``fired`` (wall time the deadline fired), and ``done`` (the
kernels' launches of the life, its program cache, its elastic stats, the
seconds of its resume: integrity pass, load and restore).  ``--config
tiny --device cpu`` runs it on the CPU.
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

import torch

SEED = 0


def _event(path: str, **fields) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(fields) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="elastic_train")
    p.add_argument("--root", required=True)
    p.add_argument("--coord", required=True)
    p.add_argument("--job_id", default="default")
    p.add_argument("--config", default="gpt2-345m")
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--steps", type=int, default=13)
    p.add_argument("--save_every", type=int, default=4)
    p.add_argument("--stall_at", type=int, default=6)
    p.add_argument("--stall", type=float, default=8.0)
    p.add_argument("--deadline", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    os.makedirs(args.root, exist_ok=True)
    events = os.path.join(args.root, "events.jsonl")
    marker = os.path.join(args.root, "armed")
    first = not os.path.exists(marker)
    if first:
        with open(marker, "w") as f:
            f.write(str(os.getpid()))
        os.environ["PADDLE_TPU_FT_TRAIN_FAULTS"] = \
            f"train.straggler@{args.stall_at}:stall={args.stall}"
    else:
        os.environ.pop("PADDLE_TPU_FT_TRAIN_FAULTS", None)
    os.environ.setdefault("PADDLE_TPU_TRACE_DIR",
                          os.path.join(args.root, "crash"))
    life = 1 if first else 2
    _event(events, event="start", life=life, pid=os.getpid(),
           t=time.time())

    from paddle_tpu_torch import build_train_step
    from paddle_tpu_torch.distributed import DistributedStrategy
    from paddle_tpu_torch.distributed.fault_tolerance import (
        MeshWatchdog, ResilientLoop,
    )
    from paddle_tpu_torch.distributed.fleet.elastic import FileCoordinator
    from paddle_tpu_torch.ops import kernels

    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": 1}
    ts = build_train_step(args.config, batch=args.batch, seq=args.seq,
                          device=args.device, seed=SEED, strategy=s,
                          to_static=True, num_layers=args.layers)
    model, opt = ts.model, ts.optimizer
    host = os.environ.get("PADDLE_CURRENT_ENDPOINT", "worker0")
    coord = FileCoordinator(args.coord)
    wd = MeshWatchdog(coord, args.job_id, host, heartbeat_interval=0.5,
                      collective_timeout=args.deadline)
    wd.step_watchdog.on_timeout = lambda: _event(events, event="fired",
                                                 life=life, t=time.time())
    cuda = torch.device(args.device).type == "cuda"

    def step_fn(step: int) -> None:
        loss = float(ts.train_step(ts.x, ts.y))      # the host waits
        _event(events, event="step", life=life, step=step, loss=loss,
               t=time.time(), launches={
                   k: v for k, v in kernels.launch_counts().items() if v})

    loop = ResilientLoop(
        os.path.join(args.root, "ckpt"),
        state_fn=lambda: {"model": model.state_dict(),
                          "opt": opt.state_dict()},
        restore_fn=lambda st: (model.load_state_dict(st["model"]),
                               opt.set_state_dict(st["opt"])),
        save_every=args.save_every, keep_last=2, save_final=False,
        verbose=True, mesh_watchdog=wd)
    kernels.reset_launches()
    loop.run(step_fn, args.steps)
    if cuda:
        torch.cuda.synchronize()
    f = ts.train_step
    _event(events, event="done", life=life, t=time.time(),
           launches=kernels.launch_counts(),
           program_cache={"programs": len(f.program_cache),
                          "misses": f.misses, "hits": f.hits,
                          "captures": f.captures},
           elastic=loop.elastic_stats(), model=type(model).__name__,
           layers=ts.model.config.num_hidden_layers,
           resume_s=loop.last_resume_s)
    coord.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
