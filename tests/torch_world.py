"""A gloo world of worker processes for the port's multi-rank tests.

:func:`run_world` starts ``nprocs`` processes; each joins one
``torch.distributed`` gloo world on a ``FileStore`` in the test's
temporary directory, runs ``<module>.<func>(rank, nprocs, workdir)``
(this directory on its path) and pickles what it returns to
``workdir/out<rank>.pkl``.  A worker imports ``torch``, ``numpy`` and
``paddle_tpu_torch`` only (a module that holds worker functions keeps
its JAX imports inside its fixtures).  ``results()`` waits for the world
under a join timeout; a worker still running at it is killed and its
result is an error with the tail of its log.  Each worker runs with one
thread (``OMP_NUM_THREADS=1``, ``torch.set_num_threads(1)``).
"""
import datetime
import os
import pickle
import subprocess
import sys
import time
import traceback

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

#: seconds a world may run before its workers are killed
WORLD_TIMEOUT_S = 240


def run_world(module: str, func: str, workdir: str, nprocs: int,
              timeout_s: float = WORLD_TIMEOUT_S):
    """Start the world; returns a handle whose ``results()`` waits (at most
    ``timeout_s`` from the start) and gives each rank's result, or
    ``{"_error": ...}`` for a rank that died or was killed."""
    code = (f"import sys; sys.path.insert(0, {TESTS!r}); "
            f"import torch_world as w, {module} as m; "
            f"w._worker_main(m.{func}, int(sys.argv[1]), int(sys.argv[2]), "
            f"sys.argv[3])")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    logs = [open(os.path.join(workdir, f"log{r}.txt"), "w")
            for r in range(nprocs)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(nprocs), workdir], cwd=REPO, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(nprocs)]
    start = time.monotonic()

    class _World:
        _done = None

        def results(self):
            if self._done is None:
                deadline = start + timeout_s
                killed = []
                for r, p in enumerate(procs):
                    try:
                        p.wait(max(0.0, deadline - time.monotonic()))
                    except subprocess.TimeoutExpired:
                        killed.append(r)
                for r in killed:
                    procs[r].kill()
                    procs[r].wait()
                for f in logs:
                    f.close()
                out = []
                for r in range(nprocs):
                    path = os.path.join(workdir, f"out{r}.pkl")
                    if r in killed or not os.path.exists(path):
                        with open(os.path.join(workdir,
                                               f"log{r}.txt")) as f:
                            tail = f.read()[-3000:]
                        out.append({"_error": f"rank {r} "
                                    f"{'killed' if r in killed else 'died'}"
                                    f" (rc {procs[r].returncode}):\n{tail}"})
                        continue
                    with open(path, "rb") as f:
                        out.append(pickle.load(f))
                self._done = out
            return self._done

    return _World()


def _worker_main(func, rank: int, world: int, workdir: str) -> None:
    """A worker: join the gloo world, run ``func``, pickle its result."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        out = func(rank, world, workdir)
    except BaseException:                # noqa: BLE001 — reported below
        out = {"_error": traceback.format_exc()}
    with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    try:
        dist.destroy_process_group()
    except Exception:                    # noqa: BLE001 — exiting anyway
        pass


def scenario(results: dict, name: str, fn, *args) -> None:
    """Run one scenario into ``results[name]``; an exception is kept as
    ``{"_error": traceback}`` and the others go on."""
    try:
        results[name] = fn(*args)
    except Exception:                    # noqa: BLE001 — reported per test
        results[name] = {"_error": traceback.format_exc()}


def get(world_results, name, rank=0):
    """A scenario's result on ``rank``, failing the test on an error."""
    import pytest

    res = world_results[rank]
    if "_error" in res:
        pytest.fail(res["_error"])
    val = res[name]
    if isinstance(val, dict) and "_error" in val:
        pytest.fail(f"rank {rank} {name}:\n{val['_error']}")
    return val


def shards(model, fleet) -> dict:
    """A rank's share of ``model``'s gradients with what :func:`unshard`
    needs to put the ranks' shares back together."""
    import torch

    from paddle_tpu_torch.models import layer_rules

    hcg = fleet.get_hybrid_communicate_group()
    vals = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
            if p.grad is not None}
    return {"vals": vals, "rules": layer_rules(model),
            "linear": [n for n, m in model.named_modules()
                       if isinstance(m, torch.nn.Linear)],
            "mp_rank": hcg.get_model_parallel_rank(),
            "batch_rank": hcg.get_batch_rank()}


def unshard(parts: list) -> dict:
    """Whole tensors, in the JAX layout (a linear weight ``[in, out]``),
    from each model rank's :func:`shards` (one per model rank)."""
    import numpy as np

    from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers import (
        shard_index,
    )

    by_mp = {p["mp_rank"]: p for p in parts}
    mp = len(by_mp)
    first = by_mp[0]
    out = {}
    for name, v0 in first["vals"].items():
        rule = first["rules"].get(name)
        full = v0
        if rule is not None and mp > 1:
            dim, n_parts = rule
            shape = list(v0.shape)
            shape[dim] *= mp
            full = np.zeros(shape, v0.dtype)
            for r, p in by_mp.items():
                sl = [slice(None)] * len(shape)
                sl[dim] = shard_index(shape[dim], r, mp, n_parts).numpy()
                full[tuple(sl)] = p["vals"][name]
        if name.rpartition(".")[0] in first["linear"] and full.ndim == 2:
            full = full.T
        out[name] = full
    return out
