"""The port's ``inference`` Predictor, on the CPU (port of
``tests/test_inference.py``).

Every class of the JAX test file has its counterpart: ``TestPredictor``
(run in both forms, the config's knobs), ``TestPredictorPoolSharing``
(one load of the artifact for N slots), ``TestPredictorInputNames`` (the
sidecar's names, the ``KeyError`` that lists them, an artifact without a
sidecar) and ``TestModelScaleServingRoundtrip``, which here runs against
the JAX Predictor: a JAX ``gpt_tiny`` is ``jit.save``d by the JAX
package (f32, and made bf16 or f16 by ``amp.decorate(level="O2")``), the
port reads its ``.pdiparams`` (``framework.load``) and carries the
weights over (``models/convert.py``), saves its own artifact and serves
it through its own Predictor; the logits must match the JAX Predictor's
within 1e-5 in f32, 2e-3 in f16 and 1.6e-2 in bf16 (the two packages'
16-bit roundings at other points; the gpt_tiny logits are below 1), and
the port's eager forward bitwise.

A predictor here runs on the CPU because its config says so
(``disable_gpu()``); a config that asks for the card raises where there
is none, and never moves to the CPU by itself.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as paddle
from paddle_tpu import inference as jax_inference
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import GPTForCausalLM as JaxGPT, gpt_tiny as jax_tiny
from paddle_tpu_torch import framework, inference, jit, static
from paddle_tpu_torch.models import (
    GPTForCausalLM, from_jax_state_dict, gpt_tiny,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _cpu_config(path: str) -> inference.Config:
    cfg = inference.Config(path)
    cfg.disable_gpu()
    return cfg


@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("inf")
    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2)).eval()
    path = str(d / "net")
    jit.save(model, path, input_spec=[jit.InputSpec([2, 4], "float32")])
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    return path, x, want


class TestPredictor:
    def test_run_direct(self, saved_model):
        path, x, want = saved_model
        pred = inference.create_predictor(_cpu_config(path))
        out = pred.run([x])
        np.testing.assert_allclose(out[0], want, atol=1e-6)

    def test_run_with_handles(self, saved_model):
        path, x, want = saved_model
        pred = inference.create_predictor(_cpu_config(path))
        names = pred.get_input_names()
        assert len(names) == 1
        h = pred.get_input_handle(names[0])
        h.copy_from_cpu(x)
        assert h.shape() == [2, 4]
        assert pred.run() is True
        out_names = pred.get_output_names()
        assert out_names == ["out0"]
        out = pred.get_output_handle(out_names[0]).copy_to_cpu()
        np.testing.assert_allclose(out, want, atol=1e-6)
        with pytest.raises(KeyError):
            pred.get_output_handle("out9")

    def test_config_knobs(self, saved_model):
        """Every knob is accepted and recorded; the program runs on the
        card unless the config disables it, and with no card it raises."""
        path, x, want = saved_model
        cfg = inference.Config(path + ".pdmodel")
        cfg.enable_use_gpu(256, 0, inference.PrecisionType.Half)
        cfg.switch_ir_optim(True)
        cfg.enable_memory_optim()
        cfg.set_cpu_math_library_num_threads(4)
        cfg.enable_mkldnn()
        cfg.enable_tensorrt_engine()
        assert cfg.use_gpu() and cfg.ir_optim()
        assert cfg._precision == inference.PrecisionType.Half
        assert cfg._memory_pool_mb == 256
        assert cfg._extra == {"memory_optim": True, "cpu_threads": 4,
                              "mkldnn": True, "tensorrt": True}
        assert cfg.device() == torch.device("cuda:0")
        assert cfg.prog_file().endswith(".pdmodel")
        assert cfg.params_file().endswith(".pdiparams")
        assert "accelerator=True, device=cuda:0, precision=1" in \
            cfg.summary()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                inference.create_predictor(cfg)
        cfg.disable_gpu()
        assert not cfg.use_gpu() and cfg.device() == torch.device("cpu")
        pred = inference.create_predictor(cfg)
        assert pred.get_input_names()
        np.testing.assert_allclose(pred.run([x])[0], want, atol=1e-6)

    def test_needs_a_path(self):
        with pytest.raises(ValueError, match="model path"):
            inference.create_predictor(inference.Config())

    def test_module_surface(self):
        assert inference.get_num_bytes_of_data_type(
            inference.DataType.BFLOAT16) == 2
        assert inference.get_num_bytes_of_data_type(
            inference.DataType.INT64) == 8
        assert "paddle_tpu_torch" in inference.get_version()
        assert inference.get_trt_compile_version() == (0, 0, 0)
        assert inference.get_trt_runtime_version() == (0, 0, 0)
        assert inference.PlaceType.GPU == 1
        assert set(inference.__all__) == set(jax_inference.__all__)


class TestPredictorPoolSharing:
    def test_pool_loads_artifact_once(self, saved_model, monkeypatch):
        """One ``jit.load`` for N slots, each with its own handles."""
        path, x, want = saved_model
        calls = []
        orig = jit.load

        def counting(p, **k):
            calls.append(p)
            return orig(p, **k)

        monkeypatch.setattr(jit, "load", counting)
        pool = inference.PredictorPool(_cpu_config(path), 3)
        assert len(calls) == 1
        assert pool.retrieve(0)._layer is pool.retrieve(2)._layer
        assert pool.retrive(1) is pool.retrieve(1)
        for i in range(3):
            np.testing.assert_allclose(pool.retrieve(i).run([x])[0], want,
                                       atol=1e-6)
        assert pool.retrieve(0)._inputs is not pool.retrieve(1)._inputs


class TestPredictorInputNames:
    def test_named_inputs_from_signature(self, tmp_path):
        model = nn.Sequential(nn.Linear(4, 4))
        path = str(tmp_path / "named")
        jit.save(model, path, input_spec=[
            jit.InputSpec([2, 4], "float32", name="features")])
        pred = inference.create_predictor(_cpu_config(path))
        assert pred.get_input_names() == ["features"]
        h = pred.get_input_handle("features")
        h.copy_from_cpu(np.zeros((2, 4), np.float32))
        assert pred.run() is True

    def test_unknown_input_keyerror_lists_names(self, saved_model):
        path, _, _ = saved_model
        pred = inference.create_predictor(_cpu_config(path))
        with pytest.raises(KeyError) as ei:
            pred.get_input_handle("nope")
        msg = str(ei.value)
        assert "nope" in msg and "x0" in msg

    def test_legacy_artifact_without_sidecar(self, tmp_path):
        """An artifact with no sidecar serves with synthesized names."""
        model = nn.Sequential(nn.Linear(4, 4))
        path = str(tmp_path / "legacy")
        jit.save(model, path, input_spec=[
            jit.InputSpec([2, 4], "float32", name="features")])
        os.remove(path + ".pdmeta.json")
        pred = inference.create_predictor(_cpu_config(path))
        assert pred.get_input_names() == ["x0"]
        assert pred.run([np.ones((2, 4), np.float32)])[0].shape == (2, 4)

    def test_two_inputs_keep_their_order(self, tmp_path):
        class Two(nn.Module):
            def __init__(self):
                super().__init__()
                self.lin = nn.Linear(4, 3)

            def forward(self, a, b):
                return self.lin(a) - b

        net = Two().eval()
        path = str(tmp_path / "two")
        jit.save(net, path, input_spec=[
            jit.InputSpec([None, 4], "float32", name="a"),
            jit.InputSpec([3], "float32", name="b")])
        meta = json.load(open(path + ".pdmeta.json"))
        assert meta["inputs"][1] == {"name": "b", "shape": [3],
                                     "dtype": "float32"}
        pred = inference.create_predictor(_cpu_config(path))
        assert pred.get_input_names() == ["a", "b"]
        a = np.random.RandomState(1).randn(5, 4).astype(np.float32)
        b = np.random.RandomState(2).randn(3).astype(np.float32)
        pred.get_input_handle("a").copy_from_cpu(a)
        pred.get_input_handle("b").copy_from_cpu(b)
        assert pred.run() is True
        with torch.no_grad():
            want = net(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_array_equal(
            pred.get_output_handle("out0").copy_to_cpu(), want)


#: the port's Predictor against the JAX Predictor, by the model's dtype
ROUNDTRIP_TOL = {None: 1e-5, "float16": 2e-3, "bfloat16": 1.6e-2}
TORCH_DTYPE = {None: torch.float32, "float16": torch.float16,
               "bfloat16": torch.bfloat16}


class TestModelScaleServingRoundtrip:
    """save -> load -> serve a GPT causal LM through both packages'
    Predictors, on the weights the JAX package saved."""

    def _serve(self, tmp_path, dtype):
        paddle.seed(0)
        jm = JaxGPT(jax_tiny())
        jm.eval()
        if dtype:
            jm = paddle.amp.decorate(jm, level="O2", dtype=dtype)
        x = np.random.RandomState(0).randint(0, 128, (2, 16)).astype(np.int64)
        jpath = str(tmp_path / f"jax_{dtype}")
        paddle.jit.save(jm, jpath, input_spec=[
            paddle.static.InputSpec([None, 16], "int64")])
        jpred = jax_inference.create_predictor(jax_inference.Config(jpath))
        want = np.asarray(jpred.run([x])[0], np.float32)

        # the JAX package's weights, read and carried over without it
        sd = framework.load(jpath + ".pdiparams", return_numpy=True)
        pm = from_jax_state_dict(
            GPTForCausalLM(gpt_tiny(), device="cpu",
                           dtype=TORCH_DTYPE[dtype]), sd).eval()
        path = str(tmp_path / f"port_{dtype}")
        jit.save(pm, path,
                 input_spec=[static.InputSpec([None, 16], "int64")])
        pred = inference.create_predictor(_cpu_config(path))
        names = pred.get_input_names()
        assert names == ["x0"]
        pred.get_input_handle(names[0]).copy_from_cpu(x)
        assert pred.run() is True
        out = pred.get_output_handle(pred.get_output_names()[0]) \
            .copy_to_cpu()
        # logits over the whole vocab, batch preserved; bf16 comes back as
        # f32 (numpy has no bf16), f16 as f16
        assert out.shape == (2, 16, 128)
        assert out.dtype == (np.float16 if dtype == "float16"
                             else np.float32)
        np.testing.assert_allclose(out.astype(np.float32), want, rtol=0,
                                   atol=ROUNDTRIP_TOL[dtype])
        with torch.no_grad():
            eager = pm(torch.from_numpy(x)).float().numpy()
        np.testing.assert_array_equal(out.astype(np.float32), eager)
        # a batch of one through the symbolic batch
        one = pred.run([x[:1]])[0]
        np.testing.assert_array_equal(one, out[:1])

    def test_gpt_f32_roundtrip(self, tmp_path):
        self._serve(tmp_path, None)

    def test_gpt_bf16_roundtrip(self, tmp_path):
        self._serve(tmp_path, "bfloat16")

    def test_gpt_f16_roundtrip(self, tmp_path):
        self._serve(tmp_path, "float16")
