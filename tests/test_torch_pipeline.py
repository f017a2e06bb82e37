"""The port's pipeline (1F1B and interleaved, one process per stage)
against the JAX package's compiled pipeline, on the CPU.

Spec: ``tests/test_pipeline.py``: each case has a counterpart here.  The
JAX side runs in this process on its ``dp2 x mp2 x pp2`` mesh of eight
virtual CPU devices with ``accumulate_steps`` 4 (its ``hybrid_pp``
fixture), and puts its global mesh, hybrid group and fleet strategy back
after.  The port runs one gloo world of :data:`W` = 8 processes at the
same degrees (:mod:`torch_world`): each data rank its half of the batch,
each pipe stage its own layers, each model rank its shards.  Both load
the JAX models' weights and take the same seeded inputs.

Tolerances (the JAX spec's): the forward and the gradients within
``1e-5`` (the GPT pipe's logits ``2e-5``); the 11 ``train_batch`` losses
(AdamW at 1e-3) within ``1e-5``.  The schedule checks need no world: the
1F1B and interleaved action lists run to their end under
``pp_schedule.simulate`` (sends never block, a receive waits), and 1F1B
keeps at most ``stages - stage`` micro-batches in flight on a stage (the
bound the JAX package's per-tick remat stands in for, its
``TestPipelineMemoryBound``).
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch
from torch import nn

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
from torch_world import get, run_world, scenario, shards, unshard  # noqa: E402,E501

W = 8
MICRO = 4
STEPS = 11
ATOL = 1e-5


class Block(nn.Module):
    """The JAX spec's block: column, gelu, row, residual, LayerNorm."""

    def __init__(self):
        super().__init__()
        from paddle_tpu_torch.distributed.fleet import meta_parallel as mp
        from paddle_tpu_torch.nn.norm import LayerNorm

        self.fc1 = mp.ColumnParallelLinear(16, 32, gather_output=False)
        self.fc2 = mp.RowParallelLinear(32, 16, input_is_parallel=True)
        self.ln = LayerNorm(16, device="cpu")

    def forward(self, x):
        return self.ln(x + self.fc2(nn.functional.gelu(self.fc1(x))))


class Wide(nn.Module):
    """A layer of another structure (for stages that differ)."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(16, 16)

    def forward(self, x):
        return torch.tanh(self.fc(x))


def _loss(out, y):
    return ((out - y) ** 2).mean()


# -- the port's worker ----------------------------------------------------------

def _worker(rank: int, world: int, workdir: str) -> dict:
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer,
    )
    from paddle_tpu_torch.distributed.parallel import average_gradients
    from paddle_tpu_torch.models import (
        GPTForCausalLMPipe, gpt_pipe_jax_name, gpt_tiny,
        shard_state_dict_from_jax,
    )
    from paddle_tpu_torch.optimizer import AdamW

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res = {}
    s = pdist.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 2}
    s.pipeline_configs = {"accumulate_steps": MICRO}
    fleet.init(is_collective=True, strategy=s, device="cpu")
    hcg = fleet.get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank()

    def build(state, v=1, body=None):
        body = body or [LayerDesc(Block) for _ in range(4)]
        pipe = PipelineLayer([nn.Linear(8, 16)] + body + [nn.Linear(16, 4)],
                             topology=hcg.topology(), loss_fn=_loss,
                             num_virtual_pipeline_stages=v)
        pipe.load_state_dict(shard_state_dict_from_jax(pipe, state,
                                                       mp_rank, 2))
        return pipe, fleet.distributed_model(pipe)

    def local(name):
        return fleet.shard_batch(torch.from_numpy(inputs[name]))

    def info(pipe, model):
        return {"parts": pipe.segment_parts,
                "names": sorted({n.split(".")[0]
                                 for n, _ in pipe.named_parameters()}),
                "virtual": model.num_virtual, "stage": hcg.get_stage_id()}

    def forward(v=1):
        pipe, model = build(inputs["pipe"], v)
        return {**info(pipe, model),
                "out": model(local("x_grad")).numpy()}

    def grads(state, v=1, body=None):
        pipe, model = build(state, v, body)
        model.forward_backward_pipeline((local("x_grad"), local("y_grad")))
        average_gradients(pipe.parameters(), hcg.get_check_parallel_group())
        return {**shards(pipe, fleet), "stage": hcg.get_stage_id()}

    def train():
        pipe, model = build(inputs["pipe"])
        opt = fleet.distributed_optimizer(AdamW(pipe.parameters(), lr=1e-3))
        x, y = local("x_train"), local("y_train")
        losses = []
        for _ in range(STEPS):
            loss = model.train_batch((x, y), opt).clone()
            pdist.all_reduce(loss, pdist.ReduceOp.AVG,
                             hcg.get_data_parallel_group())
            losses.append(float(loss))
        return losses

    def indivisible():
        _, model = build(inputs["pipe"])
        try:
            model(local("x_six"))                 # 3 rows, 4 micro-batches
        except ValueError:
            return True
        return False

    def gpt():
        cfg = gpt_tiny()
        pipe = GPTForCausalLMPipe(cfg, topology=hcg.topology(), device="cpu")
        pipe.load_state_dict(shard_state_dict_from_jax(
            pipe, inputs["gpt"], mp_rank, 2,
            rename=gpt_pipe_jax_name(cfg.num_hidden_layers)))
        model = fleet.distributed_model(pipe)
        x, y = local("x_gpt"), local("y_gpt")
        out = {"logits": model(x).numpy(), "mp_rank": mp_rank,
               "batch_rank": hcg.get_batch_rank(),
               "loss": float(model.eval_batch((x, y)))}
        model.forward_backward_pipeline((x, y))
        average_gradients(pipe.parameters(), hcg.get_check_parallel_group())
        out["grads"] = shards(pipe, fleet)
        out["stage"] = hcg.get_stage_id()
        return out

    scenario(res, "forward", forward)
    scenario(res, "forward_v2", forward, 2)
    scenario(res, "degrade_v4", forward, 4)
    scenario(res, "grads", grads, inputs["pipe"])
    scenario(res, "grads_v2", grads, inputs["pipe"], 2)
    scenario(res, "grads_mixed", grads, inputs["mixed"], 1,
             [LayerDesc(Block), LayerDesc(Wide), LayerDesc(Block)])
    scenario(res, "train", train)
    scenario(res, "indivisible", indivisible)
    scenario(res, "gpt", gpt)
    return res


# -- the JAX side ---------------------------------------------------------------

class _JaxPipe:
    """The JAX package's ``hybrid_pp`` fleet inside the block; its mesh,
    hybrid group and strategy put back after."""

    def __enter__(self):
        import paddle_tpu as paddle
        from paddle_tpu.distributed import fleet as jfleet
        from paddle_tpu.distributed import mesh as jmesh
        from paddle_tpu.distributed.fleet import topology as jtopo

        self.saved = (jmesh.get_global_mesh(),
                      jtopo.get_hybrid_communicate_group(),
                      jfleet._user_strategy, jfleet._fleet_initialized)
        s = paddle.distributed.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 2}
        s.pipeline_configs = {"accumulate_steps": MICRO}
        jfleet.init(is_collective=True, strategy=s)
        return jfleet.get_hybrid_communicate_group()

    def __exit__(self, *exc):
        from paddle_tpu.distributed import fleet as jfleet
        from paddle_tpu.distributed import mesh as jmesh
        from paddle_tpu.distributed.fleet import topology as jtopo

        jmesh.set_global_mesh(self.saved[0])
        jtopo.set_hybrid_communicate_group(self.saved[1])
        jfleet._user_strategy, jfleet._fleet_initialized = self.saved[2:]


def _jax_reference(inputs: dict, start_world) -> dict:
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed.fleet.meta_parallel import (
        LayerDesc as JDesc, PipelineLayer as JPipe,
    )
    from paddle_tpu.models import GPTForCausalLMPipe as JGPTPipe, gpt_tiny

    class JBlock(jnn.Layer):
        def __init__(self):
            super().__init__()
            mp = jfleet.meta_parallel
            self.fc1 = mp.ColumnParallelLinear(16, 32, gather_output=False)
            self.fc2 = mp.RowParallelLinear(32, 16, input_is_parallel=True)
            self.ln = jnn.LayerNorm(16)

        def forward(self, x):
            return self.ln(x + self.fc2(JF.gelu(self.fc1(x))))

    class JWide(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = jnn.Linear(16, 16)

        def forward(self, x):
            return paddle.tanh(self.fc(x))

    def jloss(out, y):
        return ((out - y) ** 2).mean()

    out = {}
    with _JaxPipe() as hcg:
        def build(v=1, body=None, seed=0):
            paddle.seed(seed)
            body = body or [JDesc(JBlock) for _ in range(4)]
            pipe = JPipe([jnn.Linear(8, 16)] + body + [jnn.Linear(16, 4)],
                         topology=hcg.topology(), loss_fn=jloss,
                         num_virtual_pipeline_stages=v)
            return pipe, jfleet.distributed_model(pipe)

        def state(layer):
            return {k: np.asarray(v.numpy())
                    for k, v in layer.state_dict().items()}

        def grads(model, pipe):
            """The forward's output and every gradient of the loss."""
            x = paddle.to_tensor(inputs["x_grad"])
            y = paddle.to_tensor(inputs["y_grad"])
            fwd = model(x)
            jloss(fwd, y).backward()
            return np.asarray(fwd.numpy()), {
                n: np.asarray(p.grad.numpy())
                for n, p in pipe.named_parameters()}

        # every model first: the port's world starts on their weights
        models = {"plain": build(), "v2": build(2),
                  "mixed": build(body=[JDesc(JBlock), JDesc(JWide),
                                       JDesc(JBlock)], seed=1),
                  "train": build()}
        paddle.seed(0)
        cfg = gpt_tiny()
        gpipe = JGPTPipe(cfg, topology=hcg.topology())
        inputs["pipe"] = state(models["plain"][0])
        inputs["mixed"] = state(models["mixed"][0])
        inputs["gpt"] = state(gpipe)
        start_world()

        out["forward"], out["grads"] = grads(*models["plain"][::-1])
        assert models["v2"][1].num_virtual == 2
        out["forward_v2"], out["grads_v2"] = grads(*models["v2"][::-1])
        out["grads_mixed"] = grads(*models["mixed"][::-1])[1]
        pipe, model = models["train"]
        opt = jfleet.distributed_optimizer(paddle.optimizer.AdamW(
            learning_rate=1e-3, parameters=model.parameters()))

        @paddle.jit.to_static
        def step(x, y):
            return model.train_batch((x, y), opt)

        x = paddle.to_tensor(inputs["x_train"])
        y = paddle.to_tensor(inputs["y_train"])
        out["train"] = [float(step(x, y)) for _ in range(STEPS)]

        # the compiled pipeline's logits (its spec holds them to the
        # sequential stack's); the loss and gradients of the stack
        gmodel = jfleet.distributed_model(gpipe)
        xg = paddle.to_tensor(inputs["x_gpt"])
        yg = paddle.to_tensor(inputs["y_gpt"])
        with paddle.no_grad():
            out["gpt_logits"] = np.asarray(gmodel(xg).numpy())
        loss = gpipe._loss_fn(gpipe(xg), yg)
        out["gpt_loss"] = float(loss)
        loss.backward()
        out["gpt_grads"] = {n: np.asarray(p.grad.numpy())
                            for n, p in gpipe.named_parameters()}
    return out


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("pipeline_world"))
    rs = np.random.RandomState(1)
    inputs = {"x_grad": rs.randn(8, 8).astype(np.float32)}
    inputs["y_grad"] = rs.randn(8, 4).astype(np.float32)
    rs = np.random.RandomState(2)
    inputs["x_train"] = rs.randn(8, 8).astype(np.float32)
    inputs["y_train"] = rs.randn(8, 4).astype(np.float32)
    inputs["x_six"] = np.random.RandomState(3).randn(6, 8).astype(
        np.float32)
    rs = np.random.RandomState(4)
    inputs["x_gpt"] = rs.randint(0, 128, (8, 16))
    inputs["y_gpt"] = rs.randint(0, 128, (8, 16))
    world = []

    def start_world():
        with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        world.append(run_world("test_torch_pipeline", "_worker", workdir, W))

    jax = _jax_reference(inputs, start_world)
    return {"world": world[0].results(), "jax": jax}


def _all(ctx, name):
    return [get(ctx["world"], name, r) for r in range(W)]


def _rows(got, key="out"):
    """The data ranks' rows, in batch order (every pipe and model rank of
    a data rank holds the same)."""
    by_batch = {}
    for g in got:
        by_batch.setdefault(g.get("batch_rank", None), g[key])
    return by_batch


def _stage_grads(got) -> dict:
    """Every stage's parameters' gradients, put back together."""
    out = {}
    for stage in (0, 1):
        parts = [g for g in got if g["stage"] == stage
                 and g["batch_rank"] == 0]
        out.update(unshard(parts))
    return out


def _check_grads(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, atol=ATOL, err_msg=n)


class TestPipelineSchedule:
    def test_uniform_run_detected(self, ctx):
        # the run of four blocks splits in two; the first linear joins
        # stage 0 and the last stage 1
        for g in _all(ctx, "forward"):
            assert g["parts"] == [0, 3, 6]
            assert g["names"] == (["0", "1", "2"] if g["stage"] == 0
                                  else ["3", "4", "5"])

    def test_forward_matches_sequential(self, ctx):
        # each data rank's half of the batch; all its ranks return it
        got = _all(ctx, "forward")
        halves = [got[0]["out"], got[4]["out"]]     # data ranks 0 and 1
        for r, g in enumerate(got):
            np.testing.assert_array_equal(g["out"], halves[r // 4])
        np.testing.assert_allclose(np.concatenate(halves),
                                   ctx["jax"]["forward"], atol=ATOL)

    def test_grads_match_sequential(self, ctx):
        _check_grads(_stage_grads(_all(ctx, "grads")), ctx["jax"]["grads"])

    def test_train_batch_converges_jitted(self, ctx):
        want = ctx["jax"]["train"]
        for got in _all(ctx, "train"):
            np.testing.assert_allclose(got, want, atol=ATOL)
            assert np.isfinite(got[-1]) and got[-1] < got[0]

    def test_micro_batch_indivisible_raises(self, ctx):
        assert all(_all(ctx, "indivisible"))

    def test_gpt_pipe_model(self, ctx):
        """``GPTForCausalLMPipe`` at ``gpt_tiny``: the logits (each rank's
        rows and vocabulary columns), the loss (ParallelCrossEntropy on
        the last stage) and the gradients, the tied word embedding's
        summed over its two stages."""
        got = _all(ctx, "gpt")
        jax = ctx["jax"]
        blocks = {(g["batch_rank"], g["mp_rank"]): g["logits"] for g in got}
        logits = np.concatenate([np.concatenate([blocks[(b, 0)],
                                                 blocks[(b, 1)]], axis=-1)
                                 for b in (0, 1)])
        np.testing.assert_allclose(logits, jax["gpt_logits"], atol=2e-5)
        # each data rank's loss is its half's; their mean the batch's
        losses = {g["batch_rank"]: g["loss"] for g in got}
        assert abs(np.mean([losses[0], losses[1]]) - jax["gpt_loss"]) < 1e-5
        from paddle_tpu_torch.models import gpt_pipe_jax_name

        rename = gpt_pipe_jax_name(2)
        grads = {}
        for stage in (0, 1):
            parts = [g["grads"] for g in got if g["stage"] == stage
                     and g["batch_rank"] == 0]
            for n, v in unshard(parts).items():
                grads.setdefault(rename(n), v)
                if rename(n) in grads:
                    np.testing.assert_allclose(grads[rename(n)], v,
                                               atol=ATOL, err_msg=n)
        want = jax["gpt_grads"]
        assert set(grads) == set(want)
        for n, w in want.items():
            np.testing.assert_allclose(grads[n], w, atol=ATOL, err_msg=n)


class TestJaxSwitchVmaAD:
    def test_switch_grads_corrupt_select_grads_exact(self, ctx):
        """The JAX package pins a jax bug (``lax.switch`` under shard_map
        corrupts gradients) that keeps its structurally different stages
        off the compiled schedule.  The port's stages run their own
        layers: a pipeline whose stages differ in structure (a block and
        a wide layer on one, a block on the other) gives the JAX
        sequential run's gradients."""
        _check_grads(_stage_grads(_all(ctx, "grads_mixed")),
                     ctx["jax"]["grads_mixed"])


class TestPipelineMemoryBound:
    @pytest.mark.parametrize("stages,micro", [(2, 4), (4, 8), (4, 16)])
    def test_temp_memory_flat_in_microbatches(self, stages, micro):
        """1F1B keeps at most ``stages - stage`` micro-batches' activations
        alive on a stage, however many micro-batches there are."""
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            pp_schedule,
        )

        for stage in range(stages):
            live = peak = 0
            for kind, _, _ in pp_schedule.one_f_one_b(stages, stage, micro):
                live += 1 if kind == "F" else -1
                peak = max(peak, live)
            assert peak == min(stages - stage, micro)


class TestInterleavedSchedule:
    def test_virtual_stages_engaged(self, ctx):
        for g in _all(ctx, "forward_v2"):
            assert g["virtual"] == 2
            # four chunks of one block; the linears join the end chunks
            assert g["parts"] == [0, 2, 3, 4, 6]
            assert g["names"] == (["0", "1", "3"] if g["stage"] == 0
                                  else ["2", "4", "5"])

    def test_forward_matches_sequential(self, ctx):
        got = _all(ctx, "forward_v2")
        np.testing.assert_allclose(
            np.concatenate([got[0]["out"], got[4]["out"]]),
            ctx["jax"]["forward_v2"], atol=ATOL)

    def test_grads_match_sequential(self, ctx):
        _check_grads(_stage_grads(_all(ctx, "grads_v2")),
                     ctx["jax"]["grads_v2"])

    def test_indivisible_degrades_to_v1(self, ctx):
        # four blocks cannot split into 2 stages x 4 chunks
        for g in _all(ctx, "degrade_v4"):
            assert g["virtual"] == 1
            assert g["parts"] == [0, 3, 6]


@pytest.mark.parametrize("stages,micro,virtual",
                         [(2, 4, 1), (4, 8, 1), (4, 2, 1), (2, 4, 2),
                          (4, 8, 2), (2, 8, 3)])
def test_schedule_lists_run_without_deadlock(stages, micro, virtual):
    """Each stage's action list: every forward and backward once, 1F1B's
    shape (warm-up forwards, then one forward and one backward in turn),
    and the lists of all stages run to their end together."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import pp_schedule

    lists = [pp_schedule.schedule(stages, s, micro, virtual)
             for s in range(stages)]
    order = pp_schedule.simulate(lists, virtual)
    assert len(order) == 2 * micro * virtual * stages
    for s, acts in enumerate(lists):
        assert sorted(acts) == sorted(
            [(k, m, c) for k in "BF" for m in range(micro)
             for c in range(virtual)])
        if virtual == 1:
            warm = min(stages - s - 1, micro)
            assert [a[0] for a in acts[:warm]] == ["F"] * warm
            steady = acts[warm:warm + 2 * (micro - warm)]
            assert [a[0] for a in steady] == ["F", "B"] * (micro - warm)
    assert pp_schedule.one_f_one_b(2, 0, 4) == [
        ("F", 0, 0), ("F", 1, 0), ("B", 0, 0), ("F", 2, 0), ("B", 1, 0),
        ("F", 3, 0), ("B", 2, 0), ("B", 3, 0)]


def test_schedule_deadlock_is_detected():
    from paddle_tpu_torch.distributed.fleet.meta_parallel import pp_schedule

    # stage 1 asks for a backward before its forward came in
    lists = [[("F", 0, 0), ("B", 0, 0)], [("B", 0, 0), ("F", 0, 0)]]
    with pytest.raises(RuntimeError, match="deadlock"):
        pp_schedule.simulate(lists)
