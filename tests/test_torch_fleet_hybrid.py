"""Fleet's hybrid parallelism in the port against the JAX package, on the
CPU: the topology queries, the tensor-parallel layers and
``ParallelCrossEntropy``, the hybrid train step, ZeRO at its three
levels, the tensor-parallel GPT and its dropout coordinates.

Spec: ``tests/test_distributed.py`` (``TestTopology::test_hcg_queries``,
``TestTensorParallel``, ``TestRecompute``, ``TestHybridTrainStep::
test_jitted_step_converges_and_shards``, ``TestGroupSharded``): each case
has a counterpart here.  The JAX side runs in this process, on its
``dp2 x mp2 x sharding2`` mesh of eight virtual CPU devices where its
test does (the hybrid step, ZeRO), else unsharded; every fixture puts
the JAX package's global mesh, hybrid group and fleet strategy back as
it found them.  The port runs in one gloo world of :data:`W` processes
(:mod:`torch_world`): first at ``mp2 x sharding2``, then at ``dp2 x
mp2``.  A loss or a gradient does not depend on the degrees, so each is
held to the JAX eight-device run.  Both sides load the same numpy
weights (the JAX models', cut to each rank by
``models.shard_state_dict_from_jax``) and take the same seeded inputs.

Tolerances: forward values and gradients within ``1e-5`` (the JAX
spec's ``TestTensorParallel``), embeddings ``1e-6``; the hybrid step's
11 losses (AdamW at 1e-2) within ``2e-5``; ZeRO's parameters after
three Adam steps within ``1e-6``; the tensor-parallel GPT's loss and
gradients within ``1e-5``; the sharded GPT's dropout loss within
``1e-5`` of the one-process loss (the same Philox bits, drawn at each
rank's coordinates).
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
from torch_world import get, run_world, scenario, shards, unshard  # noqa: E402,E501

W = 4
STEPS = 11
ATOL = 1e-5
DROPOUT = 0.1
DROPOUT_SEED = 5


def _np_state(layer) -> dict:
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


# -- the port's worker ----------------------------------------------------------

def _worker(rank: int, world: int, workdir: str) -> dict:
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch import jit, rng
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mp
    from paddle_tpu_torch.distributed.fleet.hybrid_optimizer import (
        gather_params,
    )
    from paddle_tpu_torch.distributed.parallel import average_gradients
    from paddle_tpu_torch.models import (
        GPTForCausalLM, gpt_tiny, shard_state_dict_from_jax,
    )
    from paddle_tpu_torch.optimizer import Adam, AdamW

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res = {}

    def init(**degrees):
        s = pdist.DistributedStrategy()
        s.hybrid_configs = degrees
        fleet.init(is_collective=True, strategy=s, device="cpu")
        return fleet.get_hybrid_communicate_group()

    def load(model, state):
        hcg = fleet.get_hybrid_communicate_group()
        sd = shard_state_dict_from_jax(
            model, state, hcg.get_model_parallel_rank(),
            hcg.get_model_parallel_world_size())
        model.load_state_dict(sd)
        return model

    def batch_mean(t):
        hcg = fleet.get_hybrid_communicate_group()
        t = t.detach().clone()
        pdist.all_reduce(t, pdist.ReduceOp.AVG,
                         hcg.get_check_parallel_group())
        return float(t)

    class Par(torch.nn.Module):
        def __init__(s):
            super().__init__()
            s.fc1 = mp.ColumnParallelLinear(16, 32, gather_output=False)
            s.fc2 = mp.RowParallelLinear(32, 16, input_is_parallel=True)

        def forward(s, x):
            return s.fc2(F.relu(s.fc1(x)))

    class M(torch.nn.Module):
        """The JAX spec's model; its replicated head is a column layer
        here, so that ParallelCrossEntropy takes the rank's columns."""

        def __init__(s):
            super().__init__()
            s.emb = mp.VocabParallelEmbedding(64, 16)
            s.fc1 = mp.ColumnParallelLinear(16, 32, gather_output=False)
            s.fc2 = mp.RowParallelLinear(32, 16, input_is_parallel=True)
            s.head = mp.ColumnParallelLinear(16, 64, gather_output=False)

        def forward(s, x):
            h = s.emb(x)
            h = fleet.recompute(s.fc2, F.gelu(s.fc1(h)))
            return s.head(h)

    def hcg_queries():
        h = fleet.get_hybrid_communicate_group()
        return {"dp": h.get_data_parallel_world_size(),
                "mp": h.get_model_parallel_world_size(),
                "sharding": h.get_sharding_parallel_world_size(),
                "pp": h.get_pipe_parallel_world_size(), "nranks": h.nranks,
                "mode": h.get_parallel_mode(),
                "first_last": h.is_first_stage() and h.is_last_stage()}

    def tp_pair():
        par = load(Par(), inputs["par"])
        model = fleet.distributed_model(par)
        x = fleet.shard_batch(torch.from_numpy(inputs["x_par"]))
        y = model(x)
        y.sum().backward()
        hcg = fleet.get_hybrid_communicate_group()
        for p in par.parameters():      # the sum over the whole batch
            pdist.all_reduce(p.grad, group=hcg.get_check_parallel_group())
        return {"y": y.detach().numpy(), **shards(par, fleet),
                "weight_shape": tuple(par.fc1.weight.shape),
                "split": [mp.mp_layers.is_split(p)
                          for p in (par.fc1.weight, par.fc1.bias,
                                    par.fc2.weight, par.fc2.bias)]}

    def vocab():
        emb = load(mp.VocabParallelEmbedding(64, 16), inputs["emb"])
        return emb(torch.from_numpy(inputs["ids"])).detach().numpy()

    def _cols(a):
        h = fleet.get_hybrid_communicate_group()
        n = a.shape[-1] // h.get_model_parallel_world_size()
        r = h.get_model_parallel_rank()
        return torch.from_numpy(a[..., r * n:(r + 1) * n].copy())

    def pce_ignore():
        ce = mp.ParallelCrossEntropy()          # ignore_index -100
        return ce(_cols(inputs["logits_ignore"]),
                  torch.tensor([1, -100, 3, -100])).numpy()

    def pce():
        logits = _cols(inputs["logits"]).requires_grad_()
        loss = mp.ParallelCrossEntropy()(logits,
                                         torch.from_numpy(inputs["labels"]))
        loss.mean().backward()
        return {"loss": loss.detach().numpy(), "grad": logits.grad.numpy(),
                "mp_rank": fleet.get_hybrid_communicate_group()
                .get_model_parallel_rank()}

    def hybrid_step():
        m = load(M(), inputs["m"])
        model = fleet.distributed_model(m)
        opt = fleet.distributed_optimizer(AdamW(m.parameters(), lr=1e-2))
        lossfn = mp.ParallelCrossEntropy()

        @jit.to_static
        def step(x, y):
            loss = lossfn(model(x), y).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        x = fleet.shard_batch(torch.from_numpy(inputs["x_step"]))
        y = fleet.shard_batch(torch.from_numpy(inputs["y_step"]))
        losses = [batch_mean(step(x, y)) for _ in range(STEPS)]
        inner = opt._inner_opt
        return {"losses": losses, "state": len(inner.state),
                "params": len(list(m.parameters())),
                "stage": opt._stage}

    def zero(level):
        lin = torch.nn.Linear(32, 32)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(inputs["zero"]["weight"].T))
            lin.bias.copy_(torch.from_numpy(inputs["zero"]["bias"]))
        opt = Adam(lin.parameters())
        model, opt, _ = pdist.sharding.group_sharded_parallel(lin, opt,
                                                              level)
        x = fleet.shard_batch(torch.from_numpy(inputs["x_zero"]))
        released = []
        for _ in range(3):
            model(x).mean().backward()
            opt.step()
            opt.clear_grad()
            released.append(sorted(p.numel() for p in lin.parameters()))
        gather_params(lin.parameters())
        return {"weight": lin.weight.detach().numpy().T.copy(),
                "bias": lin.bias.detach().numpy().copy(),
                "released": released, "state": len(opt._inner_opt.state)}

    def gpt_tp():
        model = load(GPTForCausalLM(gpt_tiny(), device="cpu"), inputs["gpt"])
        wrapped = fleet.distributed_model(model)
        x = fleet.shard_batch(torch.from_numpy(inputs["x_gpt"]))
        y = fleet.shard_batch(torch.from_numpy(inputs["y_gpt"]))
        loss = wrapped.compute_loss(x, y)
        loss.backward()
        hcg = fleet.get_hybrid_communicate_group()
        average_gradients(model.parameters(),
                          hcg.get_check_parallel_group())
        return {"loss": batch_mean(loss), **shards(model, fleet)}

    def gpt_dropout():
        cfg = gpt_tiny(hidden_dropout_prob=DROPOUT,
                       attention_probs_dropout_prob=DROPOUT)
        model = load(GPTForCausalLM(cfg, device="cpu"), inputs["gpt"])
        wrapped = fleet.distributed_model(model.train())
        rng.seed(DROPOUT_SEED)
        x = fleet.shard_batch(torch.from_numpy(inputs["x_gpt"]))
        y = fleet.shard_batch(torch.from_numpy(inputs["y_gpt"]))
        with torch.no_grad():
            return batch_mean(wrapped.compute_loss(x, y))

    init(mp_degree=2, sharding_degree=2)
    for name, fn in [("hcg_queries", hcg_queries), ("tp_pair", tp_pair),
                     ("vocab", vocab), ("pce_ignore", pce_ignore),
                     ("pce", pce), ("step/mp2_sharding2", hybrid_step)]:
        scenario(res, name, fn)
    for level in ("os", "os_g", "p_g_os"):
        scenario(res, f"zero/{level}", zero, level)
    init(dp_degree=2, mp_degree=2)
    for name, fn in [("step/dp2_mp2", hybrid_step), ("gpt_tp", gpt_tp),
                     ("gpt_dropout", gpt_dropout)]:
        scenario(res, name, fn)
    return res


# -- the JAX side ---------------------------------------------------------------

class _JaxHybrid:
    """The JAX package's fleet on its ``dp2 x mp2 x sharding2`` mesh inside
    the block; its global mesh, hybrid group and strategy put back after."""

    def __enter__(self):
        import paddle_tpu.distributed as jdist
        from paddle_tpu.distributed import fleet as jfleet
        from paddle_tpu.distributed import mesh as jmesh
        from paddle_tpu.distributed.fleet import topology as jtopo

        self.saved = (jmesh.get_global_mesh(),
                      jtopo.get_hybrid_communicate_group(),
                      jfleet._user_strategy, jfleet._fleet_initialized)
        s = jdist.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2,
                            "sharding_degree": 2}
        jfleet.init(is_collective=True, strategy=s)
        return jfleet.get_hybrid_communicate_group()

    def __exit__(self, *exc):
        from paddle_tpu.distributed import fleet as jfleet
        from paddle_tpu.distributed import mesh as jmesh
        from paddle_tpu.distributed.fleet import topology as jtopo

        jmesh.set_global_mesh(self.saved[0])
        jtopo.set_hybrid_communicate_group(self.saved[1])
        jfleet._user_strategy, jfleet._fleet_initialized = self.saved[2:]


def _jax_reference(inputs: dict) -> dict:
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.models import gpt as jgpt

    out = {}
    with _JaxHybrid() as hcg:
        out["hcg"] = {"mp": hcg.get_model_parallel_world_size(),
                      "sharding": hcg.get_sharding_parallel_world_size(),
                      "pp": hcg.get_pipe_parallel_world_size(),
                      "nranks": hcg.nranks, "mode": hcg.get_parallel_mode(),
                      "first_last": hcg.is_first_stage()
                      and hcg.is_last_stage()}
        jmp = jfleet.meta_parallel

        class M(jnn.Layer):
            def __init__(s):
                super().__init__()
                s.emb = jmp.VocabParallelEmbedding(64, 16)
                s.fc1 = jmp.ColumnParallelLinear(16, 32,
                                                 gather_output=False)
                s.fc2 = jmp.RowParallelLinear(32, 16,
                                              input_is_parallel=True)
                s.head = jnn.Linear(16, 64)

            def forward(s, x):
                h = s.emb(x)
                h = jfleet.recompute(s.fc2, JF.gelu(s.fc1(h)))
                return s.head(h)

        paddle.seed(0)
        m = M()
        inputs["m"] = _np_state(m)
        m = jfleet.distributed_model(m)
        opt = jfleet.distributed_optimizer(paddle.optimizer.AdamW(
            learning_rate=1e-2, parameters=m.parameters()))
        lossfn = jmp.ParallelCrossEntropy()

        @paddle.jit.to_static
        def step(x, y):
            loss = lossfn(m(x), y).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        x = paddle.to_tensor(inputs["x_step"])
        y = paddle.to_tensor(inputs["y_step"])
        out["losses"] = [float(step(x, y)) for _ in range(STEPS)]

        paddle.seed(1)
        lin = jnn.Linear(32, 32)
        inputs["zero"] = _np_state(lin)
        jopt = paddle.optimizer.Adam(parameters=lin.parameters())
        lin, jopt, _ = paddle.distributed.sharding.group_sharded_parallel(
            lin, jopt, "p_g_os")
        xz = paddle.to_tensor(inputs["x_zero"])
        for _ in range(3):
            lin(xz).mean().backward()
            jopt.step()
            jopt.clear_grad()
        out["zero"] = {"weight": np.asarray(lin.weight.numpy()),
                       "bias": np.asarray(lin.bias.numpy())}

    # the unsharded references: TestTensorParallel's plain layers
    paddle.seed(2)
    fc1, fc2 = jnn.Linear(16, 32), jnn.Linear(32, 16)
    inputs["par"] = {"fc1." + k: v for k, v in _np_state(fc1).items()}
    inputs["par"].update({"fc2." + k: v for k, v in _np_state(fc2).items()})
    xp = paddle.to_tensor(inputs["x_par"])
    y = fc2(JF.relu(fc1(xp)))
    y.sum().backward()
    out["par"] = {"y": np.asarray(y.numpy()),
                  "grads": {f"{n}.{k}": np.asarray(getattr(l, k).grad.numpy())
                            for n, l in (("fc1", fc1), ("fc2", fc2))
                            for k in ("weight", "bias")}}
    emb = jnn.Embedding(64, 16)
    inputs["emb"] = _np_state(emb)
    out["emb"] = np.asarray(emb(paddle.to_tensor(inputs["ids"])).numpy())
    logits = paddle.to_tensor(inputs["logits"], stop_gradient=False)
    ref = JF.cross_entropy(logits, paddle.to_tensor(
        inputs["labels"].reshape(-1, 1)), reduction="none")
    ref.mean().backward()
    out["ce"] = {"loss": np.asarray(ref.numpy()).ravel(),
                 "grad": np.asarray(logits.grad.numpy())}
    paddle.seed(3)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    inputs["gpt"] = _np_state(jm)
    loss = jm.compute_loss(paddle.to_tensor(inputs["x_gpt"]),
                           paddle.to_tensor(inputs["y_gpt"]))
    loss.backward()
    out["gpt"] = {"loss": float(loss),
                  "grads": {n: np.asarray(p.grad.numpy())
                            for n, p in jm.named_parameters()}}
    return out


def _port_dropout_loss(state: dict, x, y) -> float:
    """The sharded model's dropout loss in one process of the port."""
    from paddle_tpu_torch import rng
    from paddle_tpu_torch.models import (
        GPTForCausalLM, from_jax_state_dict, gpt_tiny,
    )

    cfg = gpt_tiny(hidden_dropout_prob=DROPOUT,
                   attention_probs_dropout_prob=DROPOUT)
    m = from_jax_state_dict(GPTForCausalLM(cfg, device="cpu"), state)
    rng.seed(DROPOUT_SEED)
    with torch.no_grad():
        return float(m.train().compute_loss(torch.from_numpy(x),
                                            torch.from_numpy(y)))


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    from paddle_tpu.distributed import mesh as jmesh

    workdir = str(tmp_path_factory.mktemp("fleet_hybrid_world"))
    rs = np.random.RandomState(0)
    inputs = {"x_par": rs.randn(8, 16).astype(np.float32),
              "ids": np.random.RandomState(1).randint(0, 64, (8, 4)),
              "logits_ignore": np.random.RandomState(6).randn(4, 8)
              .astype(np.float32),
              "logits": np.random.RandomState(2).randn(8, 32)
              .astype(np.float32),
              "labels": np.random.RandomState(3).randint(0, 32, (8,)),
              "x_zero": np.random.RandomState(8).randn(8, 32)
              .astype(np.float32)}
    rs = np.random.RandomState(0)
    inputs["x_step"] = rs.randint(0, 64, (8, 4))
    inputs["y_step"] = rs.randint(0, 64, (8, 4))
    rs = np.random.RandomState(1)
    inputs["x_gpt"] = rs.randint(0, 128, (4, 16))
    inputs["y_gpt"] = rs.randint(0, 128, (4, 16))
    saved = jmesh.get_global_mesh()
    jmesh.set_global_mesh(None)
    try:
        jax = _jax_reference(inputs)
    finally:
        jmesh.set_global_mesh(saved)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    world = run_world("test_torch_fleet_hybrid", "_worker", workdir, W)
    dropout_loss = _port_dropout_loss(inputs["gpt"], inputs["x_gpt"],
                                      inputs["y_gpt"])
    return {"world": world.results(), "jax": jax, "inputs": inputs,
            "dropout_loss": dropout_loss}


def _all(ctx, name):
    return [get(ctx["world"], name, r) for r in range(W)]


class TestTopology:
    def test_hcg_queries(self, ctx):
        jax = ctx["jax"]["hcg"]
        for got in _all(ctx, "hcg_queries"):
            assert got["mp"] == jax["mp"] == 2
            assert got["sharding"] == jax["sharding"] == 2
            assert got["pp"] == jax["pp"] == 1
            assert got["mode"] == jax["mode"] == "TENSOR_PARALLEL"
            assert got["first_last"] and jax["first_last"]
            # the port's world is the JAX mesh without its data axis
            assert got["nranks"] * 2 == jax["nranks"] == 8
            assert got["dp"] == 1


class TestTensorParallel:
    def test_forward_backward_match(self, ctx):
        got = _all(ctx, "tp_pair")
        jax = ctx["jax"]["par"]
        rows = {g["batch_rank"]: g["y"] for g in got}
        y = np.concatenate([rows[b] for b in sorted(rows)])
        np.testing.assert_allclose(y, jax["y"], atol=ATOL)
        grads = unshard([g for g in got if g["batch_rank"] == 0])
        for name, want in jax["grads"].items():
            np.testing.assert_allclose(grads[name], want, atol=ATOL,
                                       err_msg=name)

    def test_param_placement(self, ctx):
        for g in _all(ctx, "tp_pair"):
            assert g["weight_shape"] == (16, 16)       # 32 out / mp 2
            # column weight and bias, row weight split; row bias whole
            assert g["split"] == [True, True, True, False]

    def test_vocab_parallel_embedding(self, ctx):
        for got in _all(ctx, "vocab"):
            np.testing.assert_allclose(got, ctx["jax"]["emb"], atol=1e-6)

    def test_parallel_cross_entropy_ignore_index(self, ctx):
        for got in _all(ctx, "pce_ignore"):
            arr = got.ravel()
            assert np.isfinite(arr).all()
            assert arr[1] == 0.0 and arr[3] == 0.0 and arr[0] > 0.0

    def test_parallel_cross_entropy(self, ctx):
        jax = ctx["jax"]["ce"]
        got = _all(ctx, "pce")
        by_mp = {}
        for g in got:
            np.testing.assert_allclose(g["loss"].ravel(), jax["loss"],
                                       atol=ATOL)
            by_mp[g["mp_rank"]] = g["grad"]
        np.testing.assert_allclose(
            np.concatenate([by_mp[0], by_mp[1]], axis=-1), jax["grad"],
            atol=ATOL)


class TestRecompute:
    """``fleet.recompute`` in one process against the JAX package's."""

    def _pair(self, seed):
        import paddle_tpu as paddle
        import paddle_tpu.nn as jnn

        from paddle_tpu_torch.models import from_jax_state_dict

        paddle.seed(seed)
        jl = jnn.Linear(8, 8)
        tl = from_jax_state_dict(torch.nn.Linear(8, 8), _np_state(jl))
        return jl, tl

    def test_grads_match_no_recompute(self):
        import paddle_tpu as paddle
        from paddle_tpu.distributed import fleet as jfleet

        from paddle_tpu_torch.distributed import fleet

        jl, tl = self._pair(4)
        x = np.random.RandomState(4).randn(4, 8).astype(np.float32)
        jy = jfleet.recompute(jl, paddle.to_tensor(x))
        jy.sum().backward()
        ty = fleet.recompute(tl, torch.from_numpy(x))
        ty.sum().backward()
        np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(tl.weight.grad.numpy().T,
                                   jl.weight.grad.numpy(), atol=1e-6)

    def test_input_grad(self):
        import paddle_tpu as paddle
        from paddle_tpu.distributed import fleet as jfleet

        from paddle_tpu_torch.distributed import fleet

        jl, tl = self._pair(5)
        x = np.random.RandomState(5).randn(4, 8).astype(np.float32)
        jx = paddle.to_tensor(x, stop_gradient=False)
        jfleet.recompute(jl, jx).sum().backward()
        tx = torch.from_numpy(x).requires_grad_()
        fleet.recompute(tl, tx).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(),
                                   atol=1e-6)


class TestHybridTrainStep:
    @pytest.mark.parametrize("layout", ["mp2_sharding2", "dp2_mp2"])
    def test_jitted_step_converges_and_shards(self, ctx, layout):
        want = ctx["jax"]["losses"]
        for got in _all(ctx, f"step/{layout}"):
            np.testing.assert_allclose(got["losses"], want, atol=2e-5)
            assert got["losses"][-1] < got["losses"][0]
            if layout == "mp2_sharding2":
                # ZeRO stage 1: each rank keeps the state of its own
                # parameters only
                assert got["stage"] == 1
                assert 0 < got["state"] < got["params"]


class TestGroupSharded:
    @pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
    def test_p_g_os_placement(self, ctx, level):
        jax = ctx["jax"]["zero"]
        for got in _all(ctx, f"zero/{level}"):
            np.testing.assert_allclose(got["weight"], jax["weight"],
                                       atol=1e-6)
            np.testing.assert_allclose(got["bias"], jax["bias"], atol=1e-6)
            assert got["state"] == 1          # weight on one, bias on other
            if level == "p_g_os":
                # between steps a rank holds only the parameter it owns
                assert all(r[0] == 0 for r in got["released"])
            else:
                assert all(r[0] > 0 for r in got["released"])


class TestGPTTensorParallel:
    def test_compute_loss_and_grads_match_jax(self, ctx):
        """The vocab-parallel loss path (ParallelCrossEntropy over the
        head's local columns) at dp2 x mp2 against the JAX model."""
        jax = ctx["jax"]["gpt"]
        got = _all(ctx, "gpt_tp")
        for g in got:
            assert abs(g["loss"] - jax["loss"]) < ATOL
        grads = unshard([g for g in got if g["batch_rank"] == 0])
        assert set(grads) == set(jax["grads"])
        for name, want in jax["grads"].items():
            np.testing.assert_allclose(grads[name], want, atol=ATOL,
                                       err_msg=name)

    def test_dropout_draws_at_global_coordinates(self, ctx):
        """At dp2 x mp2 with dropout 0.1 each rank draws its batch rows'
        and its heads' bits: the loss is the one-process loss."""
        for got in _all(ctx, "gpt_dropout"):
            assert abs(got - ctx["dropout_loss"]) < ATOL


def test_dropout_masks_union_is_one_process_mask():
    """The plain versions at p = 0.25: the ranks' hidden masks (batch
    slices) and attention factors (batch x head blocks) put together are
    the one-process ones, bit for bit."""
    from paddle_tpu_torch import rng

    snap = torch.tensor([1234, 7], dtype=torch.int64)
    B, S, H = 6, 5, 8
    full = rng.dropout_keep(snap, (B, S, H), 0.25)
    parts = []
    for b0 in (0, 2, 4):
        with rng.shard_coordinates(batch_start=b0):
            parts.append(rng.dropout_keep(snap, (2, S, H), 0.25))
    assert torch.equal(torch.cat(parts), full)
    heads, rows = 4, 16
    full = rng.attention_dropout_factor(snap, B * heads, rows, rows, 0.25,
                                        heads=heads)
    full = full.view(B, heads, rows, rows)
    for b0 in (0, 3):
        for h0 in (0, 2):
            with rng.shard_coordinates(batch_start=b0, head_start=h0,
                                       heads_total=heads):
                s = rng.with_coordinates(snap, 2)
            part = rng.attention_dropout_factor(s, 3 * 2, rows, rows, 0.25,
                                                heads=2).view(3, 2, rows,
                                                              rows)
            assert torch.equal(part, full[b0:b0 + 3, h0:h0 + 2])
