"""Semi-automatic parallelism in the port (``distributed.auto_parallel``)
against the JAX package, on the CPU.

Spec: every case of ``tests/test_auto_parallel.py``.

- ``ProcessMesh``: topology, names, default registration, bad dims; its
  ``device_mesh()`` is a ``DeviceMesh`` with the same dim names.
- ``shard_tensor`` / ``shard_op`` in a gloo world of 4 over the mesh
  ``[[0, 1], [2, 3]]`` (``x``, ``y``): a parameter placed by
  ``dims_mapping`` comes back a ``DTensor`` with ``Shard(1)`` on ``y``,
  an activation by ``shard_spec``, and an op's output redistributed; the
  values are whole where gathered.
- ``Engine.fit``: the tiny Llama from the JAX model's seeded weights,
  AdamW at 1e-3, 4 steps of batch 8: in a gloo world of 2 on
  ``ProcessMesh([0, 1], ["dp"])`` with ``inputs_spec=["dp"]``, and in a
  world of 4 on ``[[0, 1], [2, 3]]`` (``data``, ``model``: the batch over
  ``data``, the model's tensor-parallel shards over ``model``).  Each
  world's losses (the global batch's, on every rank) are held to the JAX
  package's single-device ``Engine`` at ``rtol=2e-5, atol=2e-6`` (the
  spec's tolerance).
- ``Engine.save`` / ``load``: a second engine evaluates as the first
  (``rtol=1e-6``).
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

from paddle_tpu_torch.distributed import auto_parallel as ap  # noqa: E402

STEPS = 4


@pytest.fixture(autouse=True)
def _reset_default_mesh():
    saved = ap._default_process_mesh
    ap._default_process_mesh = None
    yield
    ap._default_process_mesh = saved


class TestProcessMesh:
    def test_topology(self):
        pm = ap.ProcessMesh([[0, 1, 2, 3], [4, 5, 6, 7]],
                            dim_names=["x", "y"])
        assert pm.topology == [2, 4] and pm.shape == [2, 4]
        assert pm.dim_names == ["x", "y"]
        assert pm.processes == list(range(8))
        assert pm.ndim == 2
        assert (pm.dim_size("x"), pm.dim_size("y"), pm.dim_size("z")) == \
            (2, 4, 1)

    def test_default_registration(self):
        pm = ap.ProcessMesh([0, 1])
        assert ap.get_default_process_mesh() is pm
        ap.ProcessMesh([0])
        assert ap.get_default_process_mesh() is pm

    def test_bad_dims(self):
        with pytest.raises(ValueError):
            ap.ProcessMesh([[0, 1]], dim_names=["a", "b", "c"])


# -- the worlds ---------------------------------------------------------------

def _llama(inputs):
    from paddle_tpu_torch.models import (
        LlamaForCausalLM, from_jax_state_dict, llama_tiny,
    )

    return from_jax_state_dict(LlamaForCausalLM(llama_tiny(), device="cpu"),
                               inputs["llama"])


def _fit(inputs, mesh_ids, dim_names, inputs_spec):
    from paddle_tpu_torch.models import LlamaPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    ap._default_process_mesh = None
    ap.ProcessMesh(mesh_ids, dim_names=dim_names)
    model = _llama(inputs)
    eng = ap.Engine(model, inputs_spec=inputs_spec)
    eng.prepare(optimizer=AdamW(model.parameters(), lr=1e-3),
                loss=LlamaPretrainingCriterion())
    return {"losses": eng.fit((inputs["xs"], inputs["ys"]), batch_size=8,
                              epochs=1, steps_per_epoch=STEPS),
            "sharded": type(eng.model).__name__,
            "heads": eng.model.llama.layers[0].self_attn.n_heads}


def _worker2(rank: int, world: int, workdir: str) -> dict:
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res = {}
    scenario(res, "dp", _fit, inputs, [0, 1], ["dp"], ["dp"])
    return res


def _worker4(rank: int, world: int, workdir: str) -> dict:
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res = {}

    def shard_tensors():
        ap._default_process_mesh = None
        pm = ap.ProcessMesh([[0, 1], [2, 3]], dim_names=["x", "y"])
        assert pm.device_mesh().mesh_dim_names == ("x", "y")
        torch.manual_seed(0)            # the same weight on every rank
        lin = torch.nn.Linear(8, 16)
        w = ap.shard_tensor(lin.weight,
                            dist_attr={"process_mesh": pm,
                                       "dims_mapping": [-1, 1]})
        t = ap.shard_tensor(torch.zeros(4, 8), process_mesh=pm,
                            shard_spec=[None, "y"])
        f = ap.shard_op(lambda a, b: a + b, process_mesh=pm,
                        out_shard_specs=[["x"]])
        a = torch.ones(8, 2)
        out = f(a, a)
        return {"param": (isinstance(w, torch.nn.Parameter),
                          isinstance(w, DTensor), tuple(w.placements),
                          tuple(w.to_local().shape)),
                "param_full": torch.equal(w.full_tensor(), lin.weight),
                "act": (tuple(t.placements), tuple(t.to_local().shape)),
                "op": (tuple(out.placements), tuple(out.to_local().shape),
                       bool((out.full_tensor() == 2.0).all())),
                "want": ((Replicate(), Shard(1)), (Replicate(), Shard(1)),
                         (Shard(0), Replicate()))}

    scenario(res, "shard", shard_tensors)
    scenario(res, "mp", _fit, inputs, [[0, 1], [2, 3]], ["data", "model"],
             ["data"])
    return res


def _jax_engine(inputs: dict) -> list:
    """The JAX package's single-device Engine (the spec's ``_train(None,
    None)``), recording the model's first weights for the port."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed import auto_parallel as jap
    from paddle_tpu.distributed import mesh as jmesh
    from paddle_tpu.models import (
        LlamaForCausalLM, LlamaPretrainingCriterion, llama_tiny)

    saved = (jmesh.get_global_mesh(), jap._default_process_mesh)
    jmesh.set_global_mesh(None)
    jap._default_process_mesh = None
    try:
        paddle.seed(0)
        model = LlamaForCausalLM(llama_tiny())
        inputs["llama"] = {k: np.asarray(v.numpy())
                           for k, v in model.state_dict().items()}
        opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=model.parameters())
        eng = jap.Engine(model)
        eng.prepare(optimizer=opt, loss=LlamaPretrainingCriterion())
        return eng.fit((inputs["xs"], inputs["ys"]), batch_size=8,
                       epochs=1, steps_per_epoch=STEPS)
    finally:
        jmesh.set_global_mesh(saved[0])
        jap._default_process_mesh = saved[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("auto_parallel_worlds"))
    rs = np.random.RandomState(0)
    inputs = {"xs": rs.randint(0, 128, (32, 8)).astype(np.int64),
              "ys": rs.randint(0, 128, (32, 8)).astype(np.int64)}
    jax_losses = _jax_engine(inputs)
    out = {"jax": jax_losses, "inputs": inputs}
    for n in (2, 4):
        d = os.path.join(workdir, f"w{n}")
        os.makedirs(d)
        with open(os.path.join(d, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        out[n] = run_world("test_torch_auto_parallel", f"_worker{n}", d, n)
    out[2], out[4] = out[2].results(), out[4].results()
    return out


class TestShardTensor:
    def test_dims_mapping_places_parameter(self, worlds):
        for r in range(4):
            got = get(worlds[4], "shard", r)
            is_param, is_dt, placements, local = got["param"]
            assert is_param and is_dt and got["param_full"]
            assert placements == got["want"][0] and local == (16, 4)

    def test_shard_spec_names(self, worlds):
        for r in range(4):
            got = get(worlds[4], "shard", r)
            assert got["act"] == (got["want"][1], (4, 4))

    def test_shard_op_constrains_output(self, worlds):
        for r in range(4):
            got = get(worlds[4], "shard", r)
            placements, local, twos = got["op"]
            assert placements == got["want"][2] and local == (4, 2) and twos


class TestEngine:
    def test_fit_dp_matches_single_device(self, worlds):
        for r in range(2):
            got = get(worlds[2], "dp", r)
            assert got["heads"] == 4
            np.testing.assert_allclose(got["losses"], worlds["jax"],
                                       rtol=2e-5, atol=2e-6)

    def test_fit_mp_matches_single_device(self, worlds):
        for r in range(4):
            got = get(worlds[4], "mp", r)
            assert got["heads"] == 2          # a shard of the 4 heads
            np.testing.assert_allclose(got["losses"], worlds["jax"],
                                       rtol=2e-5, atol=2e-6)

    def test_engine_save_load(self, tmp_path, worlds):
        from paddle_tpu_torch.models import LlamaPretrainingCriterion
        from paddle_tpu_torch.optimizer import AdamW

        inputs = worlds["inputs"]
        xs, ys = inputs["xs"][:8], inputs["ys"][:8]
        model = _llama(inputs)
        eng = ap.Engine(model)
        eng.prepare(optimizer=AdamW(model.parameters(), lr=1e-3),
                    loss=LlamaPretrainingCriterion())
        eng.fit((xs, ys), batch_size=4, epochs=1)
        path = str(tmp_path / "ckpt")
        eng.save(path)
        torch.manual_seed(1)
        from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

        model2 = LlamaForCausalLM(llama_tiny(), device="cpu")
        eng2 = ap.Engine(model2)
        eng2.prepare(optimizer=AdamW(model2.parameters(), lr=1e-3),
                     loss=LlamaPretrainingCriterion())
        eng2.load(path)
        np.testing.assert_allclose(eng.evaluate((xs, ys), batch_size=4),
                                   eng2.evaluate((xs, ys), batch_size=4),
                                   rtol=1e-6)
        assert len(eng2.predict((xs, ys), batch_size=4)) == 2
