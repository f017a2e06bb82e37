"""Kill-and-resume worker for the port's elastic launcher tests (the
port's counterpart of ``elastic_resume_train.py``; imports the port
only).

Trains a tiny data-parallel linear model for 10 steps on the CPU (gloo),
rank 0 checkpointing after every step; on start it resumes from the
checkpoint.  With ``PADDLE_TEST_KILL_STEP`` set and the marker file
absent, the highest rank dies hard at that step (once): the launcher must
relaunch the set, and the loss history across the death must equal an
uninterrupted run's.  Rank 0 writes the losses to ``PADDLE_TEST_OUT``.
"""
import json
import os
import pickle
import sys


def main():
    import numpy as np
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.optimizer import SGD

    torch.set_num_threads(1)
    penv = dist.init_parallel_env(device="cpu")
    rank, world = penv.rank, max(penv.world_size, 1)
    ckpt_dir = os.environ["PADDLE_TEST_CKPT_DIR"]
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = os.path.join(ckpt_dir, "state.pkl")
    kill_step = int(os.environ.get("PADDLE_TEST_KILL_STEP", "-1"))
    marker = os.environ.get("PADDLE_TEST_KILL_MARKER")

    rs = np.random.RandomState(0)
    X = rs.randn(16, 8).astype(np.float32)
    Y = X @ rs.randn(8, 2).astype(np.float32)
    local = 16 // world
    x = torch.from_numpy(X[rank * local:(rank + 1) * local])
    y = torch.from_numpy(Y[rank * local:(rank + 1) * local])

    torch.manual_seed(0)
    lin = torch.nn.Linear(8, 2)
    model = dist.DataParallel(lin)
    opt = SGD(model.parameters(), lr=0.05)
    start, losses = 0, []
    if os.path.exists(ckpt):
        with open(ckpt, "rb") as f:
            state = pickle.load(f)
        lin.load_state_dict(state["model"])
        start, losses = state["step"], list(state["losses"])
        print(f"[worker {rank}] resumed from step {start}", file=sys.stderr,
              flush=True)

    @jit.to_static
    def step(x, y):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    for s in range(start, 10):
        loss = step(x, y).detach().clone()
        dist.all_reduce(loss, dist.ReduceOp.AVG)
        losses.append(float(loss))
        if rank == 0:
            tmp = ckpt + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump({"model": lin.state_dict(), "step": s + 1,
                             "losses": losses}, f)
            os.replace(tmp, ckpt)
        dist.barrier()
        if kill_step == s and rank == world - 1 and marker \
                and not os.path.exists(marker):
            open(marker, "w").write("died")
            print(f"[worker {rank}] simulated death at step {s}",
                  file=sys.stderr, flush=True)
            os._exit(7)
    if rank == 0 and os.environ.get("PADDLE_TEST_OUT"):
        with open(os.environ["PADDLE_TEST_OUT"], "w") as f:
            json.dump(losses, f)
    print(f"[worker {rank}] done", flush=True)


if __name__ == "__main__":
    main()
