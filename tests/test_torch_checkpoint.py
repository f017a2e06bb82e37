"""Format-2 checkpoints of the port, against the JAX package's, on the CPU.

``tests/test_checkpoint.py`` is the spec: each of its classes has a
counterpart here, and :class:`TestCrossPackage` holds the two packages to
one format:

- a checkpoint written by either package loads bitwise in the other (f32,
  bf16, int64, nested lists and tuples, literals, a scheduler's state);
- the port's shard files equal the JAX package's byte for byte where the
  layout is the same (a whole tensor);
- ``Engine.update_weights(<JAX checkpoint directory>)`` serves the JAX
  model's weights (greedy streams equal to the JAX engine's);
- a JAX ``ResilientLoop`` generation's user state resumes in the port,
  and its ``@rng`` (a JAX key) is refused unless ``include_rng=False``.

The sharded case runs in a spawned gloo world of two processes (the
launcher of ``tests/test_torch_sharded_serving.py``): each rank saves its
blocks of the tensor-parallel layers, rank 0 merges the index, and one
process (and the JAX package) reads the whole tensors back.
"""
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from paddle_tpu_torch import jit
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.lr import PiecewiseDecay

from test_torch_sharded_serving import _get, run_world, scenario

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _single_device():
    from paddle_tpu.distributed import mesh as mesh_mod

    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


# -- the sharded world ---------------------------------------------------------

#: the global tensors the world's layers hold blocks of
COL_OUT, IN, ROWS, VOCAB, HID = 12, 6, 8, 10, 4


def _globals():
    rs = np.random.RandomState(3)
    return {"col.weight": rs.randn(COL_OUT, IN).astype(np.float32),
            "col.bias": rs.randn(COL_OUT).astype(np.float32),
            "row.weight": rs.randn(ROWS, IN).astype(np.float32),
            "row.bias": rs.randn(ROWS).astype(np.float32),
            "emb.weight": rs.randn(VOCAB, HID).astype(np.float32)}


def _ckpt_worker(rank: int, world: int, workdir: str) -> dict:
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers
    from paddle_tpu_torch.distributed.mesh import process_group

    res: dict = {}
    group = process_group([0, 1])
    g = _globals()

    def layers():
        col = mp_layers.ColumnParallelLinear(IN, COL_OUT, group=group,
                                             parts=2)
        row = mp_layers.RowParallelLinear(IN, ROWS, group=group)
        emb = mp_layers.VocabParallelEmbedding(VOCAB, HID, group=group)
        return torch.nn.ModuleDict({"col": col, "row": row, "emb": emb})

    def save_and_load():
        m = layers()
        with torch.no_grad():
            m["col"].weight.copy_(torch.from_numpy(
                g["col.weight"])[m["col"].local_index()])
            m["col"].bias.copy_(torch.from_numpy(
                g["col.bias"])[m["col"].local_index()])
            m["row"].weight.copy_(torch.from_numpy(
                g["row.weight"])[:, m["row"].local_index()])
            m["row"].bias.copy_(torch.from_numpy(g["row.bias"]))
            m["emb"].weight.copy_(torch.from_numpy(
                g["emb.weight"])[m["emb"].local_index()])
        path = os.path.join(workdir, "sharded")
        ckpt.save_state_dict({"model": m.state_dict(), "step": 3}, path)
        dist.barrier()
        m2 = layers()
        loaded = ckpt.load_state_dict(path, {"model": m2.state_dict(),
                                             "step": None})
        m2.load_state_dict(loaded["model"])
        return {"files": sorted(f for f in os.listdir(path)
                                if f.endswith(".npy")),
                "same": all(torch.equal(a, b) for a, b in zip(
                    m.state_dict().values(), m2.state_dict().values())),
                "step": loaded["step"]}

    scenario(res, "sharded", save_and_load)
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("ckpt_world"))
    w = run_world("test_torch_checkpoint", "_ckpt_worker", workdir,
                  nprocs=2)
    yield {"dir": workdir, "results": w.results()}
    shutil.rmtree(workdir, ignore_errors=True)


class TestSaveLoadRoundtrip:
    def test_sharded_save_reshard_load(self, world):
        """Two ranks write their blocks (a fused two-part column layer:
        two blocks a rank), rank 0 the whole row bias and the merged
        index; each rank reads its blocks back, one process and the JAX
        package read whole tensors equal to the global ones."""
        from paddle_tpu.distributed import checkpoint as jck

        for r in range(2):
            got = _get(world["results"], "sharded", r)
            assert got["same"] and got["step"] == 3
        path = os.path.join(world["dir"], "sharded")
        files = _get(world["results"], "sharded", 0)["files"]
        # the column weight: 2 blocks on each of 2 ranks; the row bias
        # whole, from rank 0
        assert sum(f.startswith("model%2Fcol.weight.") for f in files) == 4
        assert [f for f in files if f.startswith("model%2Frow.bias.")] \
            == ["model%2Frow.bias.s0.full.npy"]
        assert ckpt.verify_checkpoint(path) == []
        whole = ckpt.load_state_dict(path, device=CPU)
        jax_whole = jck.load_state_dict(path, return_numpy=True)
        for name, want in _globals().items():
            np.testing.assert_array_equal(whole["model"][name].numpy(),
                                          want, err_msg=name)
            np.testing.assert_array_equal(jax_whole["model"][name], want,
                                          err_msg=name)
        with open(os.path.join(path, "index.json")) as f:
            meta = json.load(f)["tensors"]["model/row.weight"]
        assert meta["spec"] == [None, "model"]
        assert sorted(sh["index"][1] for sh in meta["shards"]) \
            == [[0, IN // 2], [IN // 2, IN]]

    def test_load_single_device_numpy(self, tmp_path):
        w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        path = str(tmp_path / "ck")
        ckpt.save_state_dict({"w": w}, path)
        out = ckpt.load_state_dict(path, return_numpy=True)
        np.testing.assert_array_equal(out["w"], w.numpy())

    def test_bf16_roundtrip(self, tmp_path):
        w = torch.linspace(-2, 2, 32).to(torch.bfloat16)
        path = str(tmp_path / "ck")
        ckpt.save_state_dict({"w": w}, path)
        with open(os.path.join(path, "index.json")) as f:
            assert json.load(f)["tensors"]["w"]["dtype"] == "bfloat16"
        out = ckpt.load_state_dict(path, device=CPU)
        assert out["w"].dtype == torch.bfloat16
        assert torch.equal(out["w"], w)

    def test_list_tuple_and_scheduler_state_roundtrip(self, tmp_path):
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 4)
        sched = PiecewiseDecay(boundaries=[100, 200],
                               values=[0.1, 0.05, 0.01])
        opt = AdamW(model.parameters(), lr=sched)
        loss = (model(torch.ones(2, 4)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        path = str(tmp_path / "ck")
        ckpt.save_state_dict({"opt": opt.state_dict(),
                              "misc": {"shape": (3, 4), "tags": ["a", "b"]}},
                             path)
        loaded = ckpt.load_state_dict(path, device=CPU)
        assert loaded["misc"]["shape"] == (3, 4)
        assert loaded["misc"]["tags"] == ["a", "b"]
        opt2 = AdamW(model.parameters(),
                     lr=PiecewiseDecay(boundaries=[1, 2],
                                       values=[1.0, 1.0, 1.0]))
        opt2.set_state_dict(loaded["opt"])
        assert opt2.get_lr() == opt.get_lr()
        for i, st in opt.state_dict()["state"].items():
            for k, v in st.items():
                assert torch.equal(opt2.state_dict()["state"][i][k], v)

    def test_overwrite_keeps_old_checkpoint_valid_until_commit(self,
                                                               tmp_path):
        path = str(tmp_path / "ck")
        ckpt.save_state_dict({"w": torch.full((4,), 1.0)}, path)
        files_gen0 = set(os.listdir(path))
        ckpt.save_state_dict({"w": torch.full((4,), 2.0)}, path)
        out = ckpt.load_state_dict(path, return_numpy=True)
        np.testing.assert_array_equal(out["w"], 2.0)
        leftover = [f for f in files_gen0
                    if f.endswith(".npy") and f in os.listdir(path)]
        assert leftover == []

    def test_async_save(self, tmp_path):
        w = torch.ones(16, 4)
        path = str(tmp_path / "ck")
        h = ckpt.save_state_dict({"w": w}, path, async_save=True)
        w.zero_()                     # the values at call time are saved
        h.result(timeout=30)
        out = ckpt.load_state_dict(path, return_numpy=True)
        np.testing.assert_array_equal(out["w"], 1.0)

    def test_default_device_is_the_card(self, tmp_path):
        path = str(tmp_path / "ck")
        ckpt.save_state_dict({"w": torch.ones(2)}, path)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                ckpt.load_state_dict(path)


def _mixed_state(pkg: str):
    """The same values as either package's tensors."""
    rs = np.random.RandomState(17)
    f32 = rs.randn(3, 5).astype(np.float32)
    bf = rs.randn(7).astype(np.float32)
    i64 = rs.randint(-1000, 1000, (6,)).astype(np.int64)
    nest = rs.randn(2, 2).astype(np.float32)
    if pkg == "port":
        t = torch.from_numpy
        return {"f32": t(f32), "bf16": t(bf).to(torch.bfloat16),
                "i64": t(i64),
                "nest": [t(nest), (4, "four", None), {"k/x": 2.5}],
                "lit": 7, "name": "run"}
    import paddle_tpu as paddle

    return {"f32": paddle.to_tensor(f32),
            "bf16": paddle.to_tensor(bf).astype("bfloat16"),
            "i64": i64,
            "nest": [paddle.to_tensor(nest), (4, "four", None),
                     {"k/x": 2.5}],
            "lit": 7, "name": "run"}


class TestCrossPackage:
    def test_jax_save_port_load_bitwise(self, tmp_path):
        from paddle_tpu.distributed import checkpoint as jck

        path = str(tmp_path / "j")
        jck.save_state_dict(_mixed_state("jax"), path)
        got = ckpt.load_state_dict(path, device=CPU)
        want = _mixed_state("port")
        for k in ("f32", "bf16", "i64"):
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(got["nest"][0], want["nest"][0])
        assert got["nest"][1] == want["nest"][1]
        assert got["nest"][2] == want["nest"][2]
        assert (got["lit"], got["name"]) == (7, "run")

    def test_port_save_jax_load_bitwise(self, tmp_path):
        from paddle_tpu.distributed import checkpoint as jck

        path = str(tmp_path / "p")
        ckpt.save_state_dict(_mixed_state("port"), path)
        assert jck.verify_checkpoint(path) == []
        got = jck.load_state_dict(path, return_numpy=True)
        want = _mixed_state("port")
        np.testing.assert_array_equal(got["f32"], want["f32"].numpy())
        assert str(got["bf16"].dtype) == "bfloat16"
        np.testing.assert_array_equal(
            np.asarray(got["bf16"]).view(np.uint16),
            want["bf16"].view(torch.int16).numpy().view(np.uint16))
        assert got["i64"].dtype == np.int64
        np.testing.assert_array_equal(got["i64"], want["i64"].numpy())
        np.testing.assert_array_equal(got["nest"][0],
                                      want["nest"][0].numpy())
        assert got["nest"][1] == (4, "four", None)
        assert got["nest"][2] == {"k/x": 2.5}
        assert (got["lit"], got["name"]) == (7, "run")

    def test_shard_files_equal_byte_for_byte(self, tmp_path):
        """Same values, same layout (whole tensors): the shard files of the
        two packages hold the same bytes, CRCs included."""
        from paddle_tpu.distributed import checkpoint as jck

        jck.save_state_dict(_mixed_state("jax"), str(tmp_path / "j"))
        ckpt.save_state_dict(_mixed_state("port"), str(tmp_path / "p"))
        for name in ("f32", "bf16", "i64", "nest%2F<0>"):
            a, = glob.glob(str(tmp_path / "p" / f"{name}.s0.*.npy"))
            b, = glob.glob(str(tmp_path / "j" / f"{name}.s0.*.npy"))
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
        idx = [json.load(open(tmp_path / d / "index.json"))["tensors"]
               for d in ("p", "j")]
        for name in ("f32", "bf16", "i64"):
            assert idx[0][name]["shards"][0]["crc32"] \
                == idx[1][name]["shards"][0]["crc32"]
            assert idx[0][name]["dtype"] == idx[1][name]["dtype"]
        assert idx[0]["lit"] == idx[1]["lit"] == {"literal": 7}

    def test_scheduler_state_crosses(self, tmp_path):
        """A JAX scheduler's state, saved by the JAX package, loads into
        the port's scheduler and gives the same rate."""
        import paddle_tpu as paddle
        from paddle_tpu.distributed import checkpoint as jck

        js = paddle.optimizer.lr.PiecewiseDecay(boundaries=[2, 4],
                                                values=[0.1, 0.05, 0.01])
        for _ in range(3):
            js.step()
        jck.save_state_dict({"s": js.state_dict()}, str(tmp_path / "s"))
        ps = PiecewiseDecay(boundaries=[1], values=[1.0, 1.0])
        ps.set_state_dict(ckpt.load_state_dict(str(tmp_path / "s"),
                                               device=CPU)["s"])
        assert ps() == js() and ps.last_epoch == js.last_epoch
        assert ps.boundaries == [2, 4]

    def test_update_weights_from_jax_checkpoint_dir(self, tmp_path):
        """A JAX model's state dict in a JAX checkpoint directory: the
        port's engine swaps to it (converting the JAX layouts) and serves
        the JAX engine's greedy streams."""
        import paddle_tpu as paddle
        from paddle_tpu.distributed import checkpoint as jck
        from paddle_tpu.models import gpt as jax_gpt
        from paddle_tpu.serving import Engine as JaxEngine
        from paddle_tpu_torch.models import (
            GPTForCausalLM, from_jax_state_dict, gpt_tiny,
        )
        from paddle_tpu_torch.serving import Engine

        kw = dict(num_slots=2, max_seq=16, min_bucket=16)
        prompts = [[3, 17, 9, 40], [5, 6, 7, 8, 9, 10]]
        jms = []
        for seed in (0, 1):
            paddle.seed(seed)
            jm = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny())
            jm.eval()
            jms.append(jm)
        path = str(tmp_path / "weights")
        jck.save_state_dict(jms[1].state_dict(), path)
        model = from_jax_state_dict(
            GPTForCausalLM(gpt_tiny(), device=CPU),
            {k: np.asarray(v.numpy()) for k, v in jms[0].state_dict().items()})
        eng = Engine(model, **kw)
        eng.warmup()
        before = eng.generate(prompts, max_new_tokens=5)
        assert eng.update_weights(path) == 1
        after = eng.generate(prompts, max_new_tokens=5)
        jeng = JaxEngine(jms[1], **kw)
        jeng.warmup()
        assert after == jeng.generate(prompts, max_new_tokens=5)
        assert after != before
        assert eng.stats()["compile_cache"]["after_warmup"] == 0

    def test_jax_generation_resumes_in_port(self, tmp_path):
        """A JAX ``ResilientLoop`` generation (its user state: a linear
        model and its AdamW state in the JAX key format) resumes in the
        port's loop with ``include_rng=False``; with the generators asked
        for, its JAX ``@rng`` key is refused, naming the way out."""
        import paddle_tpu as paddle
        import paddle_tpu.nn as jnn
        from paddle_tpu.distributed.fault_tolerance import (
            ResilientLoop as JaxLoop,
        )
        from paddle_tpu_torch.distributed.fault_tolerance import (
            ResilientLoop,
        )

        paddle.seed(3)
        jnet = jnn.Linear(4, 3)
        jopt = paddle.optimizer.AdamW(learning_rate=0.05,
                                      parameters=jnet.parameters())
        x = paddle.to_tensor(np.ones((2, 4), np.float32))

        def jstep(step):
            loss = (jnet(x) ** 2).mean()
            loss.backward()
            jopt.step()
            jopt.clear_grad()

        root = str(tmp_path / "ck")
        JaxLoop(root, state_fn=lambda: {"m": jnet.state_dict(),
                                        "o": jopt.state_dict()},
                restore_fn=lambda s: None, save_every=2, verbose=False
                ).run(jstep, 3)

        net = torch.nn.Linear(4, 3)
        opt = AdamW(net.parameters(), lr=0.05)

        def restore(s):
            with torch.no_grad():
                net.weight.copy_(torch.as_tensor(s["m"]["weight"]).T)
                net.bias.copy_(torch.as_tensor(s["m"]["bias"]))
            # the JAX linear weight's moments are [in, out]: transposed
            opt.set_state_dict({k: (torch.as_tensor(v).T
                                    if getattr(v, "ndim", 0) == 2 else v)
                                for k, v in s["o"].items()})

        def loop(include_rng):
            return ResilientLoop(
                root, state_fn=lambda: {"m": {}, "o": {}},
                restore_fn=restore, include_rng=include_rng, verbose=False)

        with pytest.raises(ValueError, match="include_rng=False"):
            loop(True).resume()
        assert loop(False).resume() == 3
        np.testing.assert_array_equal(net.weight.detach().numpy(),
                                      np.asarray(jnet.weight.numpy()).T)
        st = opt.state_dict()["state"][0]
        jst = {k.rsplit("/", 1)[1]: np.asarray(v.numpy())
               for k, v in jopt.state_dict().items()
               if k.startswith(jnet.weight.name + "/")}
        np.testing.assert_array_equal(st["moment1"].numpy(),
                                      jst["moment1"].T)
        np.testing.assert_array_equal(st["beta1_pow"].numpy(),
                                      jst["beta1_pow"])

    def test_jax_state_missing_a_parameter_refused(self):
        """A JAX optimizer makes a parameter's accumulators at its first
        step, so a parameter that never had a gradient has no keys. The
        port pairs JAX keys with its parameters by position, so such a
        state cannot be paired: it is refused, not loaded one parameter
        early into equal-shaped neighbours."""
        import paddle_tpu as paddle
        import paddle_tpu.nn as jnn

        paddle.seed(4)
        frozen, used = jnn.Linear(4, 4), jnn.Linear(4, 4)
        jopt = paddle.optimizer.AdamW(
            learning_rate=0.05,
            parameters=frozen.parameters() + used.parameters())
        x = paddle.to_tensor(np.ones((2, 4), np.float32))
        (used(x) ** 2).mean().backward()
        jopt.step()
        jsd = jopt.state_dict()
        saved = {k.rsplit("/", 1)[0] for k in jsd if not k.startswith("@")}
        assert len(saved) == 2          # the frozen layer left no keys

        nets = [torch.nn.Linear(4, 4), torch.nn.Linear(4, 4)]
        opt = AdamW([p for n in nets for p in n.parameters()], lr=0.05)
        with pytest.raises(ValueError, match="same number"):
            opt.set_state_dict({k: (torch.as_tensor(np.array(v)).T
                                    if getattr(v, "ndim", 0) == 2 else v)
                                for k, v in jsd.items()})
        assert all(not opt.state[p] for n in nets for p in n.parameters())


class TestTrainingContinuation:
    def _step_fn(self, model, opt):
        @jit.to_static
        def step(x, y):
            loss = ((model(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return step

    def test_loss_curve_continues_after_load(self, tmp_path):
        """4 steps, a checkpoint, 3 more; a fresh model (one divergent
        step first) loads the checkpoint in place and its 3 steps equal
        the first run's, bitwise."""
        rs = np.random.RandomState(0)
        x = torch.from_numpy(rs.randn(16, 8).astype(np.float32))
        y = torch.from_numpy(rs.randn(16, 2).astype(np.float32))

        def build():
            torch.manual_seed(0)
            model = torch.nn.Linear(8, 2)
            return model, AdamW(model.parameters(), lr=1e-2)

        model, opt = build()
        step = self._step_fn(model, opt)
        for _ in range(4):
            step(x, y)
        path = str(tmp_path / "ck")
        ckpt.save_state_dict({"model": model.state_dict(),
                              "opt": opt.state_dict()}, path)
        ref = [step(x, y) for _ in range(3)]

        model2, opt2 = build()
        step2 = self._step_fn(model2, opt2)
        step2(x, y)
        ptrs = [p.data_ptr() for p in model2.parameters()]
        loaded = ckpt.load_state_dict(
            path, {"model": model2.state_dict(), "opt": opt2.state_dict()})
        model2.load_state_dict(loaded["model"])
        opt2.set_state_dict(loaded["opt"])
        assert [p.data_ptr() for p in model2.parameters()] == ptrs
        got = [step2(x, y) for _ in range(3)]
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
