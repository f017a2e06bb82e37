"""Worker script for the port's launcher tests: data-parallel training.

Each process loads its own slice of the global batch, trains the same
tiny model through ``DataParallel`` (gradients averaged over the world),
and rank 0 writes the loss history (the mean over the ranks' slices) and
the final parameters to ``PADDLE_TEST_OUT``.  Run alone (no launcher) it
trains on the whole batch: the one-process oracle.  Imports the port
only.
"""
import json
import os
import sys


def main():
    if os.environ.get("PADDLE_TEST_ALWAYS_FAIL"):
        print("simulated unrecoverable failure", file=sys.stderr)
        sys.exit(3)
    fail_marker = os.environ.get("PADDLE_TEST_FAIL_MARKER")
    if fail_marker and not os.path.exists(fail_marker):
        # the first generation dies once; the restarted one trains
        open(fail_marker, "w").write("died once")
        print("simulated worker failure", file=sys.stderr)
        sys.exit(3)

    import numpy as np
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.optimizer import SGD

    torch.set_num_threads(1)
    penv = dist.init_parallel_env(device="cpu")
    rank, world = penv.rank, penv.world_size
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

    @jit.to_static
    def step(x, y):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    losses = []
    for _ in range(10):
        loss = step(x, y).detach().clone()
        dist.all_reduce(loss, dist.ReduceOp.AVG)
        losses.append(float(loss))
    out = os.environ.get("PADDLE_TEST_OUT")
    if out and rank == 0:
        with open(out, "w") as f:
            json.dump({"losses": losses,
                       "weight": lin.weight.detach().tolist(),
                       "bias": lin.bias.detach().tolist()}, f)
    print("rank", rank, "losses", losses[0], losses[-1])


if __name__ == "__main__":
    main()
