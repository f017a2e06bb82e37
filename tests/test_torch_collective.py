"""The port's collectives, groups, topology and ``DataParallel`` against the
JAX package's, on the CPU.

Spec: ``tests/test_distributed.py``'s ``TestCollectives`` and
``TestTopology`` (and ``TestHybridTrainStep::test_dp_loss_equivalence``),
and ``tests/test_collective_multiproc.py::
test_functional_collectives_two_processes``: each case has a counterpart
here.  The JAX functions take one rank-stacked tensor (leading axis the
group's ranks) on the JAX package's virtual CPU devices, in this process;
the port's take each rank's own tensor, in one gloo world of :data:`W`
processes made once for the module (:mod:`torch_world`).  Each test
stacks the ranks' results and holds them to the JAX result on a group of
the same :data:`W` devices: equal for the exact cases, within ``1e-6``
for ``DataParallel``'s outputs and gradients (the JAX spec's tolerance).
"""
import os
import pickle
import sys

import numpy as np
import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
from torch_world import get, run_world, scenario  # noqa: E402

#: ranks of the module's world (and devices of the JAX group)
W = 4
PROD_VALUES = np.array([1.0, -2.0, 3.0, 1.0], np.float32)


# -- the port's worker ----------------------------------------------------------

def _worker(rank: int, world: int, workdir: str) -> dict:
    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.topology import (
        CommunicateTopology, HybridCommunicateGroup,
    )

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res = {}
    r = rank

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    def all_reduce_sum():
        x = t(np.arange(W * 2).reshape(W, 2)[r])
        pdist.all_reduce(x)
        return x.numpy()

    def all_reduce_max():
        x = t([r])
        pdist.all_reduce(x, op=pdist.ReduceOp.MAX)
        return x.numpy()

    def broadcast():
        x = t([r])
        pdist.broadcast(x, src=3)
        return x.numpy()

    def all_gather():
        return pdist.all_gather(t([r])).numpy()

    def alltoall():
        return pdist.alltoall(t(np.arange(W * W).reshape(W, W)[r])).numpy()

    def reduce_scatter():
        return pdist.reduce_scatter(t(np.arange(W))).numpy()

    def reduce():
        x = t(np.ones(3))
        pdist.reduce(x, dst=2)
        return x.numpy()

    def ppermute():
        return pdist.ppermute(t([r]), [(i, (i + 1) % W)
                                        for i in range(W)]).numpy()

    def scatter():
        x = t(np.zeros(2))
        chunks = list(t(np.arange(W * 2).reshape(W, 2)))
        pdist.scatter(x, chunks, src=0)
        return x.numpy()

    def barrier():
        pdist.barrier()
        return True

    def reduce_avg():
        x = t([r])
        pdist.reduce(x, dst=1, op=pdist.ReduceOp.AVG)
        return x.numpy()

    def prod_negative():
        x = t([PROD_VALUES[r]])
        pdist.all_reduce(x, op=pdist.ReduceOp.PROD)
        return x.numpy()

    def alltoall_list():
        data = np.arange(W * W, dtype=np.float32).reshape(W, W)
        out = []
        pdist.alltoall([t(data[r, j]) for j in range(W)], out)
        return [o.numpy() for o in out]

    def subgroup_allreduce():
        g = pdist.new_group([0, 1])
        x = t([r])
        pdist.all_reduce(x, group=g)
        return x.numpy()

    def rows_checked():
        try:
            pdist.alltoall(t(np.ones((3, 2))))
        except ValueError:
            return True
        return False

    def grad_flows():
        x = torch.ones(2, requires_grad=True)
        out = pdist.ppermute(x, [(i, (i + 1) % W) for i in range(W)])
        out.sum().backward()
        return x.grad.numpy()

    def src_outside_group():
        g = pdist.new_group([2, 3])
        try:
            pdist.broadcast(t([1.0]), src=0, group=g)
        except ValueError:
            return True
        return False

    def init_degree_mismatch():
        s = pdist.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 3, "mp_degree": 2}
        try:
            fleet.init(is_collective=True, strategy=s, device="cpu")
        except ValueError:
            return True
        return False

    def check_group():
        topo = CommunicateTopology(["data", "pipe", "sharding", "sep",
                                    "model"], [2, 1, 2, 1, 1])
        return HybridCommunicateGroup(topo).get_check_parallel_group().ranks

    def two_process():
        # tests/assets/collective_2proc.py's checks on a group of two
        g = pdist.new_group([0, 1])
        if r > 1:
            return None
        base = np.arange(4, dtype=np.float32)
        done = {}
        x = t(base + r * 10)
        pdist.all_reduce(x, group=g)
        done["all_reduce"] = x.numpy()
        x = t(base + r * 10)
        pdist.broadcast(x, src=1, group=g)
        done["broadcast"] = x.numpy()
        done["all_gather"] = pdist.all_gather(t(base + r * 10),
                                              group=g).numpy()
        payload = t(np.stack([base + r * 10 + j for j in range(2)]))
        done["alltoall"] = pdist.alltoall(payload, group=g).numpy()
        x = t(base + r * 10)
        pdist.reduce(x, dst=0, group=g)
        done["reduce"] = x.numpy()
        done["ppermute"] = pdist.ppermute(t(base + r * 10), [(0, 1), (1, 0)],
                                          group=g).numpy()
        return done

    def data_parallel():
        lin = torch.nn.Linear(16, 4)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(inputs["w"].T))
            lin.bias.copy_(torch.from_numpy(inputs["b"]))
            if r:                     # the wrap broadcasts rank 0's values
                lin.weight.add_(1.0)
        dp = pdist.DataParallel(lin)
        x = torch.from_numpy(inputs["x"][r * 4:(r + 1) * 4])
        y = dp(x)
        y.mean().backward()
        out = {"y": y.detach().numpy(),
               "gw": lin.weight.grad.numpy().T.copy(),
               "gb": lin.bias.grad.numpy().copy()}
        dp.sync_gradients()           # once per backward: no second average
        out["gw_again"] = lin.weight.grad.numpy().T.copy()
        lin.weight.grad = lin.bias.grad = None
        with dp.no_sync():
            dp(x).mean().backward()
        out["local"] = lin.weight.grad.numpy().T.copy()
        dp(x).mean().backward()       # the sum of both, averaged
        out["accumulated"] = lin.weight.grad.numpy().T
        return out

    for name, fn in list(locals().items()):
        if getattr(fn, "__qualname__", "").startswith("_worker.<locals>") \
                and name != "t":
            scenario(res, name, fn)
    return res


# -- the JAX side and the world, once for the module ---------------------------

@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn

    workdir = str(tmp_path_factory.mktemp("collective_world"))
    paddle.seed(0)
    lin = jnn.Linear(16, 4)
    x = np.random.RandomState(7).randn(16, 16).astype(np.float32)
    inputs = {"w": np.asarray(lin.weight.numpy()),
              "b": np.asarray(lin.bias.numpy()), "x": x}
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    world = run_world("test_torch_collective", "_worker", workdir, W)
    y = lin(paddle.to_tensor(x))
    y.mean().backward()
    jax_dp = {"y": np.asarray(y.numpy()),
              "gw": np.asarray(lin.weight.grad.numpy()),
              "gb": np.asarray(lin.bias.grad.numpy())}
    return {"world": world.results(), "dp": jax_dp}


def _stack(ctx, name, ranks=range(W)):
    return np.stack([np.asarray(get(ctx["world"], name, r)) for r in ranks])


def _jax(arr, fn, ranks=None):
    """Run ``fn(stacked_tensor, group)`` on the JAX package's group of
    ``ranks`` (the first :data:`W` devices by default)."""
    import paddle_tpu as paddle
    import paddle_tpu.distributed as jdist

    g = jdist.new_group(list(ranks if ranks is not None else range(W)))
    t = paddle.to_tensor(np.asarray(arr, np.float32))
    out = fn(t, g, jdist)
    return np.asarray((out if out is not None else t).numpy())


class TestCollectives:
    def test_all_reduce_sum(self, ctx):
        want = _jax(np.arange(W * 2).reshape(W, 2),
                    lambda t, g, d: d.all_reduce(t, group=g))
        np.testing.assert_array_equal(_stack(ctx, "all_reduce_sum"), want)

    def test_all_reduce_max(self, ctx):
        want = _jax(np.arange(W).reshape(W, 1), lambda t, g, d: d.all_reduce(
            t, op=d.ReduceOp.MAX, group=g))
        np.testing.assert_array_equal(_stack(ctx, "all_reduce_max"), want)

    def test_broadcast(self, ctx):
        want = _jax(np.arange(W).reshape(W, 1),
                    lambda t, g, d: d.broadcast(t, src=3, group=g))
        np.testing.assert_array_equal(_stack(ctx, "broadcast"), want)

    def test_all_gather(self, ctx):
        want = _jax(np.arange(W).reshape(W, 1),
                    lambda t, g, d: d.all_gather(t, group=g))
        np.testing.assert_array_equal(_stack(ctx, "all_gather"), want)

    def test_alltoall(self, ctx):
        want = _jax(np.arange(W * W).reshape(W, W),
                    lambda t, g, d: d.alltoall(t, group=g))
        np.testing.assert_array_equal(_stack(ctx, "alltoall"), want)

    def test_reduce_scatter(self, ctx):
        want = _jax(np.tile(np.arange(W), (W, 1)),
                    lambda t, g, d: d.reduce_scatter(t, group=g))
        np.testing.assert_array_equal(_stack(ctx, "reduce_scatter"),
                                      want.ravel())

    def test_reduce(self, ctx):
        want = _jax(np.ones((W, 3)),
                    lambda t, g, d: d.reduce(t, dst=2, group=g))
        np.testing.assert_array_equal(_stack(ctx, "reduce"), want)

    def test_ppermute(self, ctx):
        want = _jax(np.arange(W).reshape(W, 1), lambda t, g, d: d.ppermute(
            t, [(i, (i + 1) % W) for i in range(W)], group=g))
        np.testing.assert_array_equal(_stack(ctx, "ppermute"), want)

    def test_scatter(self, ctx):
        payload = np.broadcast_to(
            np.arange(W * 2, dtype=np.float32).reshape(1, W, 2), (W, W, 2))
        want = _jax(payload.copy(),
                    lambda t, g, d: d.scatter(t, src=0, group=g))
        np.testing.assert_array_equal(_stack(ctx, "scatter"), want)

    def test_barrier(self, ctx):
        assert all(get(ctx["world"], "barrier", r) for r in range(W))

    def test_reduce_avg(self, ctx):
        want = _jax(np.arange(W).reshape(W, 1), lambda t, g, d: d.reduce(
            t, dst=1, op=d.ReduceOp.AVG, group=g))
        np.testing.assert_allclose(_stack(ctx, "reduce_avg"), want,
                                   rtol=0, atol=0)

    def test_all_reduce_prod_negative(self, ctx):
        want = _jax(PROD_VALUES.reshape(W, 1), lambda t, g, d: d.all_reduce(
            t, op=d.ReduceOp.PROD, group=g))
        np.testing.assert_array_equal(_stack(ctx, "prod_negative"), want)

    def test_alltoall_list_form(self, ctx):
        import paddle_tpu as paddle
        import paddle_tpu.distributed as jdist

        data = np.arange(W * W, dtype=np.float32).reshape(W, W)
        g = jdist.new_group(list(range(W)))
        out = []
        jdist.alltoall([paddle.to_tensor(data[:, j].copy())
                        for j in range(W)], out, group=g)
        got = [get(ctx["world"], "alltoall_list", r) for r in range(W)]
        for j in range(W):
            np.testing.assert_array_equal(
                np.stack([got[r][j] for r in range(W)]), out[j].numpy())

    def test_subgroup_allreduce(self, ctx):
        want = _jax(np.arange(2).reshape(2, 1),
                    lambda t, g, d: d.all_reduce(t, group=g), ranks=[0, 1])
        got = _stack(ctx, "subgroup_allreduce")
        np.testing.assert_array_equal(got[:2], want)
        np.testing.assert_array_equal(got[2:].ravel(), [2, 3])

    def test_stacked_shape_check(self, ctx):
        # the JAX functions refuse a stack of the wrong height; the port's
        # take a rank's own tensor, and refuse entries that do not match
        # the group
        assert all(get(ctx["world"], "rows_checked", r) for r in range(W))

    def test_allreduce_grad_flows(self, ctx):
        import paddle_tpu as paddle
        import paddle_tpu.distributed as jdist

        g = jdist.new_group(list(range(W)))
        t = paddle.to_tensor(np.ones((W, 2), np.float32),
                             stop_gradient=False)
        jdist.ppermute(t, [(i, (i + 1) % W) for i in range(W)],
                       group=g).sum().backward()
        np.testing.assert_array_equal(_stack(ctx, "grad_flows"),
                                      t.grad.numpy())


class TestTopology:
    def test_coord_rank_roundtrip(self):
        from paddle_tpu.distributed.fleet.topology import (
            CommunicateTopology as JaxTopo,
        )
        from paddle_tpu_torch.distributed.fleet.topology import (
            CommunicateTopology,
        )

        names = ["data", "pipe", "sharding", "sep", "model"]
        topo, jt = CommunicateTopology(names, [2, 2, 1, 1, 2]), \
            JaxTopo(names, [2, 2, 1, 1, 2])
        assert topo.world_size() == 8
        for r in range(8):
            c = topo.get_coord(r)
            assert topo.get_rank(**c._asdict()) == r
            assert tuple(c) == tuple(jt.get_coord(r))

    def test_comm_list(self):
        from paddle_tpu.distributed.fleet.topology import (
            CommunicateTopology as JaxTopo,
        )
        from paddle_tpu_torch.distributed.fleet.topology import (
            CommunicateTopology,
        )

        names = ["data", "pipe", "sharding", "sep", "model"]
        topo = CommunicateTopology(names, [2, 1, 1, 1, 4])
        jt = JaxTopo(names, [2, 1, 1, 1, 4])
        assert topo.get_comm_list("model")[0] == [0, 1, 2, 3]
        assert topo.get_comm_list("data")[0] == [0, 4]
        for n in names:
            assert topo.get_comm_list(n) == jt.get_comm_list(n)

    def test_axis_list(self):
        from paddle_tpu_torch.distributed.fleet.topology import (
            CommunicateTopology,
        )

        topo = CommunicateTopology(["data", "pipe", "sharding", "sep",
                                    "model"], [2, 2, 1, 1, 2])
        assert topo.get_axis_list("data", 0) == [0, 1, 2, 3]

    def test_broadcast_src_outside_group_raises(self, ctx):
        assert all(get(ctx["world"], "src_outside_group", r)
                   for r in range(W))

    def test_init_degree_mismatch_raises(self, ctx):
        assert all(get(ctx["world"], "init_degree_mismatch", r)
                   for r in range(W))

    def test_check_group_cartesian(self, ctx):
        # data x sharding of the rank's other coordinates: all four ranks
        assert all(get(ctx["world"], "check_group", r) == [0, 1, 2, 3]
                   for r in range(W))


def test_functional_collectives_two_processes(ctx):
    """tests/assets/collective_2proc.py's expectations, on a group of two
    of the world's processes."""
    base = np.arange(4, dtype=np.float32)
    for r in range(2):
        got = get(ctx["world"], "two_process", r)
        assert set(got) == {"all_reduce", "broadcast", "all_gather",
                            "alltoall", "reduce", "ppermute"}
        np.testing.assert_array_equal(got["all_reduce"], 2 * base + 10)
        np.testing.assert_array_equal(got["broadcast"], base + 10)
        np.testing.assert_array_equal(got["all_gather"],
                                      np.stack([base, base + 10]))
        np.testing.assert_array_equal(
            got["alltoall"], np.stack([base + j * 10 + r for j in range(2)]))
        np.testing.assert_array_equal(
            got["reduce"], 2 * base + 10 if r == 0 else base + 10)
        np.testing.assert_array_equal(got["ppermute"],
                                      base + (1 - r) * 10)


def test_dp_loss_equivalence(ctx):
    """Each rank's quarter of the batch through ``DataParallel``: the
    outputs are the JAX model's rows, and after ``backward`` every rank
    holds the full-batch mean's gradients (within 1e-6)."""
    jax = ctx["dp"]
    got = [get(ctx["world"], "data_parallel", r) for r in range(W)]
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]),
                               jax["y"], atol=1e-6)
    for g in got:
        np.testing.assert_allclose(g["gw"], jax["gw"], atol=1e-6)
        np.testing.assert_allclose(g["gb"], jax["gb"], atol=1e-6)
        np.testing.assert_array_equal(g["gw_again"], g["gw"])
        np.testing.assert_allclose(g["accumulated"], 2 * jax["gw"],
                                   atol=1e-6)
    # inside no_sync each rank kept its own shard's gradient
    assert not np.allclose(got[0]["local"], got[1]["local"])
