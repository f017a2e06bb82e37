"""World-change drill worker for the port (the counterpart of
``elastic_world_train.py``; imports the port only).

Runs under ``python -m paddle_tpu_torch.distributed.launch
--elastic_coordinator`` on N nodes, one process a node, on the CPU
(gloo).  Trains a tiny linear model data-parallel (``DataParallel``
averages the gradients over the world, so the update is the global
batch's mean gradient at every world size) on an
:class:`ElasticDataSchedule` (``assert_coverage`` checks exactly-once at
every world size the job passes through).  Rank 0 commits a pickle
checkpoint (tmp file and ``os.replace``) after every step with the
parameters, the optimizer, the losses and the ``(start_step, stop_step,
world)`` life segments; a relaunch resumes from it at whatever world the
elastic manager regenerated.  A collective that fails because a peer
died exits 101 for a relaunch; an armed :class:`MeshWatchdog` (wedged
deadline) does the same for a hang.

Env: PADDLE_TEST_CKPT_DIR (required), PADDLE_TEST_STEP_DIR (markers
``rank<r>_step<s>`` holding the launcher's pid, the test's kill target),
PADDLE_TEST_OUT (rank 0's final JSON), PADDLE_TEST_STEPS,
PADDLE_TEST_HEALTH_DIR (arm the MeshWatchdog through a FileCoordinator
there), PADDLE_TEST_COLLECTIVE_TIMEOUT, PADDLE_TEST_STEP_SLEEP.
"""
import json
import os
import pickle
import sys
import time

GLOBAL_BATCH = 16


def main():
    import numpy as np
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.fault_tolerance import MeshWatchdog
    from paddle_tpu_torch.distributed.fleet.elastic import FileCoordinator
    from paddle_tpu_torch.distributed.reshard import ElasticDataSchedule
    from paddle_tpu_torch.optimizer import SGD

    torch.set_num_threads(1)
    penv = dist.init_parallel_env(device="cpu")
    rank, world = penv.rank, max(penv.world_size, 1)
    ckpt_dir = os.environ["PADDLE_TEST_CKPT_DIR"]
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = os.path.join(ckpt_dir, "state.pkl")
    step_dir = os.environ.get("PADDLE_TEST_STEP_DIR")
    if step_dir:
        os.makedirs(step_dir, exist_ok=True)
    num_steps = int(os.environ.get("PADDLE_TEST_STEPS", "8"))

    rs = np.random.RandomState(0)
    X = rs.randn(GLOBAL_BATCH, 8).astype(np.float32)
    Y = X @ rs.randn(8, 2).astype(np.float32)
    sched = ElasticDataSchedule(GLOBAL_BATCH, dataset_size=GLOBAL_BATCH)

    torch.manual_seed(0)
    lin = torch.nn.Linear(8, 2)
    model = dist.DataParallel(lin)
    opt = SGD(model.parameters(), lr=0.05)
    start, losses, segments = 0, [], []
    if os.path.exists(ckpt):
        with open(ckpt, "rb") as f:
            st = pickle.load(f)
        lin.load_state_dict(st["model"])
        opt.set_state_dict(st["opt"])
        start, losses = st["step"], list(st["losses"])
        segments = [list(s) for s in st["segments"]]
        print(f"[drill {rank}] resumed step {start} at world {world} "
              f"(segments {segments})", file=sys.stderr, flush=True)
    segments.append([start, start, world])

    wd = None
    if os.environ.get("PADDLE_TEST_HEALTH_DIR"):
        wd = MeshWatchdog(
            FileCoordinator(os.environ["PADDLE_TEST_HEALTH_DIR"]),
            job_id="drill",
            host=os.environ.get("PADDLE_CURRENT_ENDPOINT", f"r{rank}"),
            heartbeat_interval=0.25,
            collective_timeout=float(
                os.environ.get("PADDLE_TEST_COLLECTIVE_TIMEOUT", "20")))
        wd.start()
    step_sleep = float(os.environ.get("PADDLE_TEST_STEP_SLEEP", "0"))

    for step in range(start, num_steps):
        if step_sleep:
            time.sleep(step_sleep)
        sched.assert_coverage(step, world)
        idx = sched.local_indices(step, rank, world)
        x, y = torch.from_numpy(X[idx]), torch.from_numpy(Y[idx])
        try:
            loss = ((model(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
        except Exception as exc:          # a peer died mid-collective
            print(f"[drill {rank}] step {step} collective failed "
                  f"({type(exc).__name__}); exiting 101 for relaunch",
                  file=sys.stderr, flush=True)
            os._exit(101)
        if wd is not None:
            wd.notify(step)
        # the loss of the whole global batch on the host: the same at
        # every world size
        with torch.no_grad():
            losses.append(float(((lin(torch.from_numpy(X))
                                  - torch.from_numpy(Y)) ** 2).mean()))
        segments[-1][1] = step + 1
        if rank == 0:
            tmp = ckpt + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump({"model": lin.state_dict(),
                             "opt": opt.state_dict(), "step": step + 1,
                             "losses": losses, "segments": segments}, f)
            os.replace(tmp, ckpt)
        if step_dir:
            with open(os.path.join(step_dir, f"rank{rank}_step{step}"),
                      "w") as f:
                f.write(str(os.getppid()))
    if wd is not None:
        wd.stop()
    if rank == 0 and os.environ.get("PADDLE_TEST_OUT"):
        lost = sched.lost_samples([tuple(s) for s in segments])
        with open(os.environ["PADDLE_TEST_OUT"], "w") as f:
            json.dump({"losses": losses, "segments": segments,
                       "lost_samples": lost, "final_world": world}, f)
    print(f"[drill {rank}] done at world {world}", flush=True)


if __name__ == "__main__":
    main()
