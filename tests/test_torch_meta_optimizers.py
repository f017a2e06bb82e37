"""The port's meta-optimizers (gradient merge, LocalSGD, DGC momentum, the
fp16 all-reduce) and ``fleet.utils``' file systems against the JAX
package's, on the CPU.

Spec: ``tests/test_gradient_merge.py`` and ``tests/test_meta_optimizers.py``
but its ASP cases (``TestASP`` and ``test_asp_skips_embedding``, whose
counterparts are in ``tests/test_torch_incubate.py``): each case
has a counterpart here, run in this process on both packages from the
same weights and inputs (parameters within ``1e-6``).  A gloo world of
two processes (:mod:`torch_world`) adds what one process cannot show:
LocalSGD's average over the data group, the fp16 all-reduce's wire, and
gradient merge under a data degree of 2.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
from torch_world import get, run_world, scenario  # noqa: E402

ATOL = 1e-6


def _jax_linear(seed, i, o, bias=True):
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn

    paddle.seed(seed)
    return jnn.Linear(i, o) if bias else jnn.Linear(i, o, bias_attr=False)


def _port(jl):
    from paddle_tpu_torch.models import from_jax_state_dict

    sd = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    out, inp = sd["weight"].shape[1], sd["weight"].shape[0]
    return from_jax_state_dict(torch.nn.Linear(inp, out,
                                               bias="bias" in sd), sd)


def _w(t) -> np.ndarray:
    """A port weight in the JAX layout."""
    return t.detach().numpy().T


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(8, 4).astype(np.float32), rs.randn(8, 2).astype(np.float32)


def _jax_mse(model, x, y):
    import paddle_tpu as paddle

    return ((model(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()


def _mse(model, x, y):
    return ((model(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()


class TestGradientMerge:
    def _merged(self, pkg_opt, k=2, avg=True):
        """Two half-batches through the merge wrapper on both packages."""
        import paddle_tpu as paddle
        from paddle_tpu.distributed.fleet.meta_optimizers import (
            GradientMergeOptimizer as JGM,
        )

        from paddle_tpu_torch import optimizer as topt
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
            GradientMergeOptimizer,
        )

        X, Y = _data()
        jl = _jax_linear(0, 4, 2)
        tl = _port(jl)
        jgm = JGM(getattr(paddle.optimizer, pkg_opt)(
            learning_rate=0.1, parameters=jl.parameters()), k_steps=k,
            avg=avg)
        tgm = GradientMergeOptimizer(getattr(topt, pkg_opt)(
            tl.parameters(), lr=0.1), k_steps=k, avg=avg)
        for i in range(2):
            sl = slice(i * 4, (i + 1) * 4)
            _jax_mse(jl, X[sl], Y[sl]).backward()
            jgm.step()
            jgm.clear_grad()
            _mse(tl, X[sl], Y[sl]).backward()
            tgm.step()
            tgm.clear_grad()
        return jl, tl

    def test_k_step_equals_full_batch(self):
        from paddle_tpu_torch.optimizer import SGD

        jl, tl = self._merged("SGD")
        X, Y = _data()
        full = _port(_jax_linear(0, 4, 2))
        opt = SGD(full.parameters(), lr=0.1)
        _mse(full, X, Y).backward()
        opt.step()
        np.testing.assert_allclose(_w(tl.weight), _w(full.weight), atol=ATOL)
        np.testing.assert_allclose(_w(tl.weight), jl.weight.numpy(),
                                   atol=ATOL)

    def test_avg_apply_with_adamw(self):
        jl, tl = self._merged("AdamW")
        w0 = _jax_linear(0, 4, 2).weight.numpy()
        assert not np.allclose(_w(tl.weight), w0)
        np.testing.assert_allclose(_w(tl.weight), jl.weight.numpy(),
                                   atol=ATOL)

    def test_no_apply_before_k(self):
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
            GradientMergeOptimizer,
        )
        from paddle_tpu_torch.optimizer import SGD

        tl = _port(_jax_linear(0, 4, 2))
        w0 = _w(tl.weight).copy()
        gm = GradientMergeOptimizer(SGD(tl.parameters(), lr=0.1), k_steps=3)
        _mse(tl, *_data()).backward()
        gm.step()
        gm.clear_grad()
        np.testing.assert_array_equal(_w(tl.weight), w0)
        assert tl.weight.grad is not None        # kept for the next ones

    def test_state_dict_roundtrip(self):
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
            GradientMergeOptimizer,
        )
        from paddle_tpu_torch.optimizer import AdamW

        tl = _port(_jax_linear(0, 4, 2))
        gm = GradientMergeOptimizer(AdamW(tl.parameters(), lr=0.1),
                                    k_steps=2)
        _mse(tl, *_data()).backward()
        gm.step()
        sd = gm.state_dict()
        assert sd["@gradient_merge_count"] == 1
        gm2 = GradientMergeOptimizer(AdamW(tl.parameters(), lr=0.1),
                                     k_steps=2)
        with pytest.warns(UserWarning, match="mid-cycle"):
            gm2.set_state_dict(sd)
        assert gm2._count == 0

    def test_under_tracing_raises(self):
        from paddle_tpu_torch import jit
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
            GradientMergeOptimizer,
        )
        from paddle_tpu_torch.optimizer import SGD

        tl = _port(_jax_linear(0, 4, 2))
        gm = GradientMergeOptimizer(SGD(tl.parameters(), lr=0.1), k_steps=2)

        @jit.to_static
        def step(x, y):
            loss = ((tl(x) - y) ** 2).mean()
            loss.backward()
            gm.step()
            return loss

        X, Y = _data()
        with pytest.raises(RuntimeError, match="to_static"):
            step(torch.from_numpy(X), torch.from_numpy(Y))

    def test_fleet_strategy_wiring(self):
        from paddle_tpu_torch.distributed import DistributedStrategy, fleet
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
            GradientMergeOptimizer,
        )
        from paddle_tpu_torch.optimizer import SGD

        s = DistributedStrategy()
        s.gradient_merge = True
        s.gradient_merge_configs.k_steps = 4
        fleet.init(is_collective=True, strategy=s)
        tl = _port(_jax_linear(0, 4, 2))
        opt = fleet.distributed_optimizer(SGD(tl.parameters(), lr=0.1),
                                          strategy=s)
        assert isinstance(opt, GradientMergeOptimizer)
        assert opt._k == 4


class TestLocalSGD:
    def test_local_steps_then_sync(self):
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
            LocalSGDOptimizer,
        )
        from paddle_tpu_torch.optimizer import SGD

        lin = _port(_jax_linear(0, 3, 3))
        opt = LocalSGDOptimizer(SGD(lin.parameters(), lr=0.1), k_steps=2)
        x = torch.ones(2, 3)
        for _ in range(4):
            lin(x).sum().backward()
            opt.step()
            opt.clear_grad()
        # one process: the average is the identity; the window restarts
        assert opt._local_steps == 0
        assert opt._global_step == 4

    def test_callable_schedule(self):
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
            LocalSGDOptimizer,
        )
        from paddle_tpu_torch.optimizer import SGD

        lin = torch.nn.Linear(2, 2)
        opt = LocalSGDOptimizer(SGD(lin.parameters(), lr=0.1),
                                k_steps=lambda step: 3)
        assert opt._cur_k() == 3


def _dgc_pair(seed, i, o, **kw):
    from paddle_tpu.distributed.fleet.meta_optimizers import (
        DGCMomentumOptimizer as JDGC,
    )

    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        DGCMomentumOptimizer,
    )

    jl = _jax_linear(seed, i, o, bias=False)
    tl = _port(jl)
    return (jl, JDGC(parameters=jl.parameters(), **kw),
            tl, DGCMomentumOptimizer(parameters=tl.parameters(), **kw))


class TestDGC:
    def test_warmup_dense_then_sparse(self):
        import paddle_tpu as paddle

        jl, jopt, tl, opt = _dgc_pair(1, 8, 8, learning_rate=0.1,
                                      momentum=0.9, rampup_begin_step=2,
                                      sparsity=[0.75])
        x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
        losses = []
        for _ in range(6):
            (jl(paddle.to_tensor(x)) ** 2).mean().backward()
            jopt.step()
            jopt.clear_grad()
            loss = (tl(torch.from_numpy(x)) ** 2).mean()
            losses.append(float(loss))
            loss.backward()
            opt.step()
            opt.clear_grad()
        assert losses[-1] < losses[0]
        assert opt._v, "sparse phase never engaged"
        np.testing.assert_allclose(_w(tl.weight), jl.weight.numpy(),
                                   atol=ATOL)

    def test_sparse_update_only_touches_topk(self):
        import paddle_tpu as paddle

        jl, jopt, tl, opt = _dgc_pair(2, 4, 4, learning_rate=1.0,
                                      momentum=0.0, rampup_begin_step=0,
                                      sparsity=[0.75])
        w0 = _w(tl.weight).copy()
        x = (np.eye(4) * [10, 1, 1, 1]).astype(np.float32)
        (jl(paddle.to_tensor(x)) * paddle.to_tensor(
            np.eye(4, dtype=np.float32))).sum().backward()
        jopt.step()
        (tl(torch.from_numpy(x)) * torch.eye(4)).sum().backward()
        opt.step()
        changed = (np.abs(_w(tl.weight) - w0) > 1e-7).sum()
        assert changed <= 4, changed
        np.testing.assert_allclose(_w(tl.weight), jl.weight.numpy(),
                                   atol=ATOL)


def _dgc_steps(tl, opt, x, n):
    for _ in range(n):
        (tl(torch.from_numpy(x)) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()


class TestMetaOptimizerStateDict:
    def test_dgc_state_roundtrip(self):
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
            DGCMomentumOptimizer,
        )

        _, _, tl, opt = _dgc_pair(6, 4, 4, learning_rate=0.1, momentum=0.9,
                                  rampup_begin_step=0, sparsity=[0.75])
        x = np.random.RandomState(2).randn(2, 4).astype(np.float32)
        _dgc_steps(tl, opt, x, 3)
        sd = opt.state_dict()
        assert any(k.startswith("@dgc_v/") for k in sd)
        tl2 = torch.nn.Linear(4, 4, bias=False)
        tl2.load_state_dict(tl.state_dict())
        opt2 = DGCMomentumOptimizer(0.1, momentum=0.9, rampup_begin_step=0,
                                    sparsity=[0.75],
                                    parameters=tl2.parameters())
        opt2.set_state_dict(sd)
        assert opt2._step_count == opt._step_count
        np.testing.assert_allclose(opt2._v[0].numpy(), opt._v[0].numpy())

    def test_localsgd_restore_resets_window(self):
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
            LocalSGDOptimizer,
        )
        from paddle_tpu_torch.optimizer import SGD

        lin = torch.nn.Linear(2, 2)
        opt = LocalSGDOptimizer(SGD(lin.parameters(), lr=0.1), k_steps=5)
        for _ in range(3):
            lin(torch.ones(1, 2)).sum().backward()
            opt.step()
            opt.clear_grad()
        assert opt._local_steps == 3
        opt.set_state_dict(opt.state_dict())
        assert opt._local_steps == 0


class TestReviewRegressions:
    def test_dgc_positional_restore_across_renamed_params(self):
        """Residuals are kept by parameter position: a model whose names
        differ takes them back."""
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
            DGCMomentumOptimizer,
        )

        _, _, tl, opt = _dgc_pair(8, 4, 4, learning_rate=0.1, momentum=0.9,
                                  rampup_begin_step=0, sparsity=[0.75])
        x = np.random.RandomState(3).randn(2, 4).astype(np.float32)
        _dgc_steps(tl, opt, x, 1)
        sd = opt.state_dict()
        other = torch.nn.Sequential(torch.nn.Linear(4, 4, bias=False))
        other[0].load_state_dict(tl.state_dict())
        opt2 = DGCMomentumOptimizer(0.1, momentum=0.9, rampup_begin_step=0,
                                    sparsity=[0.75],
                                    parameters=other.named_parameters())
        opt2.set_state_dict(sd)
        assert 0 in opt2._v
        np.testing.assert_allclose(opt2._v[0].numpy(), opt._v[0].numpy())

    def test_dgc_seeds_velocity_at_transition(self):
        import paddle_tpu as paddle

        jl, jopt, tl, opt = _dgc_pair(9, 4, 4, learning_rate=0.1,
                                      momentum=0.9, rampup_begin_step=2,
                                      sparsity=[0.5])
        x = np.diag([4.0, 2.0, 1.0, 0.5]).astype(np.float32)
        for _ in range(3):
            jl(paddle.to_tensor(x)).sum().backward()
            jopt.step()
            jopt.clear_grad()
            tl(torch.from_numpy(x)).sum().backward()
            opt.step()
            opt.clear_grad()
        assert opt._u[0].abs().max() > 0 and opt._v[0].abs().max() > 0
        # the warm-up's velocity went into u at the transition
        assert "velocity" not in opt._inner_opt.state[tl.weight]
        np.testing.assert_allclose(_w(tl.weight), jl.weight.numpy(),
                                   atol=ATOL)

    def test_strategy_wires_localsgd(self):
        from paddle_tpu_torch.distributed import DistributedStrategy, fleet
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
            LocalSGDOptimizer,
        )
        from paddle_tpu_torch.optimizer import SGD

        s = DistributedStrategy()
        s.localsgd = True
        s.localsgd_configs = {"k_steps": 4}
        fleet.init(is_collective=True, strategy=s)
        lin = torch.nn.Linear(2, 2)
        opt = fleet.distributed_optimizer(SGD(lin.parameters(), lr=0.1),
                                          strategy=s)
        assert isinstance(opt, LocalSGDOptimizer)
        assert opt._cur_k() == 4


class TestFleetFS:
    def test_local_fs(self, tmp_path):
        from paddle_tpu_torch.distributed.fleet.utils import LocalFS
        from paddle_tpu_torch.distributed.fleet.utils.fs import (
            FSFileExistsError, FSFileNotExistsError,
        )

        fs = LocalFS()
        d = str(tmp_path / "a")
        fs.mkdirs(d)
        assert fs.is_dir(d) and fs.is_exist(d)
        f = str(tmp_path / "a" / "x.txt")
        fs.touch(f)
        assert fs.is_file(f)
        with pytest.raises(FSFileExistsError):
            fs.touch(f, exist_ok=False)
        assert fs.ls_dir(d) == ([], ["x.txt"])
        fs.mv(f, str(tmp_path / "a" / "y.txt"))
        assert not fs.is_exist(f)
        with pytest.raises(FSFileNotExistsError):
            fs.mv(f, str(tmp_path / "z"))
        fs.delete(d)
        assert not fs.is_exist(d)

    def test_hdfs_raises(self):
        from paddle_tpu_torch.distributed.fleet.utils import HDFSClient

        with pytest.raises(NotImplementedError):
            HDFSClient("hadoop_home")


class TestFP16AllReduce:
    def test_grad_quantized_to_fp16(self):
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
            FP16AllReduceOptimizer,
        )
        from paddle_tpu_torch.optimizer import SGD

        net = torch.nn.Linear(4, 4)
        o = FP16AllReduceOptimizer(SGD(net.parameters(), lr=1.0))
        w0 = net.weight.detach().clone()
        g = torch.full((4, 4), 0.1000123)       # not fp16-representable
        net.weight.grad = g.clone()
        net.bias.grad = torch.zeros(4)
        o.step()
        g16 = g.half().float()
        np.testing.assert_allclose(net.weight.detach().numpy(),
                                   (w0 - g16).numpy(), rtol=0, atol=1e-7)
        assert not np.allclose(net.weight.detach().numpy(), (w0 - g).numpy())

    def test_strategy_wiring(self):
        from paddle_tpu_torch.distributed import DistributedStrategy, fleet
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
            FP16AllReduceOptimizer,
        )
        from paddle_tpu_torch.optimizer import SGD

        s = DistributedStrategy()
        s.fp16_allreduce = True
        fleet.init(is_collective=True, strategy=s)
        net = fleet.distributed_model(torch.nn.Linear(2, 2))
        o = fleet.distributed_optimizer(SGD(net.parameters()), strategy=s)
        assert isinstance(o, FP16AllReduceOptimizer)


def test_dgc_strategy_raises():
    from paddle_tpu_torch.distributed import DistributedStrategy, fleet
    from paddle_tpu_torch.optimizer import Momentum

    s = DistributedStrategy()
    s.dgc = True
    with pytest.raises(ValueError, match="DGCMomentumOptimizer"):
        fleet.distributed_optimizer(
            Momentum(torch.nn.Linear(2, 2).parameters()), strategy=s)


# -- a world of two: what one process cannot show -------------------------------

def _worker(rank: int, world: int, workdir: str) -> dict:
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        LocalSGDOptimizer,
    )
    from paddle_tpu_torch.optimizer import SGD

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res = {}
    x = torch.from_numpy(inputs["x"][rank * 4:(rank + 1) * 4])
    y = torch.from_numpy(inputs["y"][rank * 4:(rank + 1) * 4])

    def model():
        lin = torch.nn.Linear(4, 2)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(inputs["w"].T))
            lin.bias.copy_(torch.from_numpy(inputs["b"]))
        return lin

    def init(**flags):
        s = pdist.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 2}
        for k, v in flags.items():
            setattr(s, k, v)
        fleet.init(is_collective=True, strategy=s, device="cpu")
        return s

    def localsgd():
        lin = model()
        opt = LocalSGDOptimizer(SGD(lin.parameters(), lr=0.1), k_steps=2)
        out = []
        for _ in range(2):
            ((lin(x) - y) ** 2).mean().backward()
            opt.step()
            opt.clear_grad()
            out.append(lin.weight.detach().numpy().T.copy())
        return out

    def fp16_wire():
        init(fp16_allreduce=True)
        lin = fleet.distributed_model(model())
        opt = fleet.distributed_optimizer(SGD(lin.parameters(), lr=1.0))
        lin.weight.grad = torch.full((2, 4), 0.1000123 * (rank + 1))
        lin.bias.grad = torch.zeros(2)
        opt.step()
        return lin.weight.detach().numpy().T.copy()

    def merge_dp():
        s = init(gradient_merge=True,
                 gradient_merge_configs={"k_steps": 2, "avg": True})
        lin = fleet.distributed_model(model())
        opt = fleet.distributed_optimizer(SGD(lin.parameters(), lr=0.1), s)
        for i in range(2):
            ((lin(x[i * 2:(i + 1) * 2]) - y[i * 2:(i + 1) * 2]) ** 2) \
                .mean().backward()
            opt.step()
            opt.clear_grad()
        return lin.weight.detach().numpy().T.copy()

    scenario(res, "localsgd", localsgd)
    scenario(res, "fp16_wire", fp16_wire)
    scenario(res, "merge_dp", merge_dp)
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("meta_opt_world"))
    jl = _jax_linear(0, 4, 2)
    X, Y = _data()
    inputs = {"w": np.asarray(jl.weight.numpy()),
              "b": np.asarray(jl.bias.numpy()), "x": X, "y": Y}
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return {"res": run_world("test_torch_meta_optimizers", "_worker",
                             workdir, 2).results(), "inputs": inputs}


def test_localsgd_averages_over_the_data_group(world):
    """Each rank steps on its own half, then the parameters are the two
    ranks' mean at the k-th step."""
    from paddle_tpu_torch.optimizer import SGD

    inp = world["inputs"]
    local = []
    for r in (0, 1):                        # each rank's two local steps
        lin = torch.nn.Linear(4, 2)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(inp["w"].T))
            lin.bias.copy_(torch.from_numpy(inp["b"]))
        opt = SGD(lin.parameters(), lr=0.1)
        steps = []
        for _ in range(2):
            _mse(lin, inp["x"][r * 4:(r + 1) * 4],
                 inp["y"][r * 4:(r + 1) * 4]).backward()
            opt.step()
            opt.clear_grad()
            steps.append(_w(lin.weight).copy())
        local.append(steps)
    for r in (0, 1):
        got = get(world["res"], "localsgd", r)
        np.testing.assert_allclose(got[0], local[r][0], atol=ATOL)
        np.testing.assert_allclose(got[1], (local[0][1] + local[1][1]) / 2,
                                   atol=ATOL)


def test_fp16_allreduce_travels_in_fp16(world):
    """Through the hybrid optimizer at dp 2 the gradients are cast to
    float16, summed there and averaged."""
    w = world["inputs"]["w"]
    g = (torch.full((2, 4), 0.1000123).half()
         + torch.full((2, 4), 0.1000123 * 2).half()).float() / 2
    want = w - g.numpy().T
    for r in (0, 1):
        np.testing.assert_allclose(get(world["res"], "fp16_wire", r), want,
                                   rtol=0, atol=1e-7)


def test_gradient_merge_under_data_parallel(world):
    """k = 2 merged micro-batches on each of two data ranks: one SGD
    update on the mean over the whole batch of 8."""
    from paddle_tpu_torch.optimizer import SGD

    inp = world["inputs"]
    full = torch.nn.Linear(4, 2)
    with torch.no_grad():
        full.weight.copy_(torch.from_numpy(inp["w"].T))
        full.bias.copy_(torch.from_numpy(inp["b"]))
    opt = SGD(full.parameters(), lr=0.1)
    _mse(full, inp["x"], inp["y"]).backward()
    opt.step()
    for r in (0, 1):
        np.testing.assert_allclose(get(world["res"], "merge_dp", r),
                                   _w(full.weight), atol=ATOL)
