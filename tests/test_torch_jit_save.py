"""``jit.save``/``jit.load``, ``framework.save``/``load`` and the registered
K1 op of the port, on the CPU.

Ports ``tests/test_jit.py::TestJitSaveLoad`` and the behaviour around
it: a saved layer loads as a ``TranslatedLayer`` that gives the layer's
outputs (exactly: the same ops on the same device), at every batch size
of a symbolic batch, after the layer object is gone; the sidecar holds
the JAX package's names and shapes, and its dtypes after the JAX
package's 64-to-32-bit canonicalization; the program archive holds no
tensor (the state is an input, as in the JAX ``pure(state_arrays,
in_arrays)``) and calls attention as the registered op
``paddle_tpu_torch::flash_fwd``; a forward whose control flow reads a
tensor's value is converted as ``to_static`` converts it and saved with
``torch.cond``, following the data after a load; a JAX ``.pdmodel``
(serialized StableHLO) is refused and its ``.pdiparams`` read, without
importing the JAX package in the port.  ``framework.io`` round-trips
f32, bf16, f16 and integer tensors in nested containers, reads the JAX
package's files and refuses its other names.  The card-side halves (the
op's CUDA implementation launching K1, a CPU-saved artifact on the card)
are in ``tests/test_torch_cuda.py``.
"""
import gc
import io
import json
import pickle
import zipfile

import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu_torch import framework, jit, static
from paddle_tpu_torch.framework import io as fio
from paddle_tpu_torch.models import (
    GPTForCausalLM, LlamaForCausalLM, from_jax_state_dict, gpt_tiny,
    llama_tiny, port_state_dict_from_jax,
)
from paddle_tpu_torch.ops import attention as att
from paddle_tpu_torch.ops import kernels

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


def _mlp(seed=0):
    torch.manual_seed(seed)
    return nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2)).eval()


class TestJitSaveLoad:
    def test_save_load_inference(self, tmp_path):
        """The JAX test: a symbolic batch traced, a batch of one served."""
        net = _mlp()
        path = str(tmp_path / "infer_model")
        jit.save(net, path, input_spec=[jit.InputSpec([None, 4], "float32")])
        loaded = jit.load(path, device="cpu")
        x = torch.from_numpy(np.random.RandomState(0).randn(1, 4)
                             .astype(np.float32))
        with torch.no_grad():
            want = net(x)
        np.testing.assert_allclose(loaded(x).numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("np_dtype", [np.float32, np.int64])
    def test_numpy_dtype_spec(self, tmp_path, np_dtype):
        """A numpy dtype in the spec, as the JAX ``InputSpec`` takes it
        (``convert_dtype``): saved and loaded; the port keeps int64 where
        the JAX package narrows it to int32."""
        jspec = paddle.jit.InputSpec([None, 4], np_dtype)
        spec = jit.InputSpec([None, 4], np_dtype)
        want = {np.float32: torch.float32, np.int64: torch.int64}[np_dtype]
        assert spec.dtype == want
        assert jspec.dtype == np.dtype({np.float32: np.float32,
                                        np.int64: np.int32}[np_dtype])
        if np_dtype is np.float32:
            net = _mlp()
            x = torch.from_numpy(np.random.RandomState(1).randn(3, 4)
                                 .astype(np.float32))
        else:
            torch.manual_seed(0)
            net = nn.Sequential(nn.Embedding(16, 3), nn.Flatten()).eval()
            x = torch.from_numpy(np.random.RandomState(1)
                                 .randint(0, 16, (3, 4)))
        path = str(tmp_path / "np_spec")
        jit.save(net, path, input_spec=[spec])
        loaded = jit.load(path, device="cpu")
        with torch.no_grad():
            want_out = net(x)
        np.testing.assert_allclose(loaded(x).numpy(), want_out.numpy(),
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("family", ["gpt", "llama"])
    def test_symbolic_batch_round_trip(self, tmp_path, family):
        """``InputSpec([None, 16], "int64")``: batches 1, 2 and 5 give the
        eager forward's logits bitwise (the same ops on the CPU), numpy
        inputs taken as they come."""
        model = (GPTForCausalLM(gpt_tiny(), device="cpu") if family == "gpt"
                 else LlamaForCausalLM(llama_tiny(), device="cpu")).eval()
        path = str(tmp_path / family)
        jit.save(model, path,
                 input_spec=[static.InputSpec([None, 16], "int64")])
        loaded = jit.load(path, device="cpu")
        for B in (1, 2, 5):
            ids = np.random.RandomState(B).randint(0, 128, (B, 16))
            with torch.no_grad():
                want = model(torch.from_numpy(ids))
            got = loaded(ids)
            assert got.shape == (B, 16, 128)
            assert torch.equal(got, want)

    def test_loads_after_the_model_is_gone(self, tmp_path):
        net = _mlp(1)
        x = torch.randn(3, 4, generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            want = net(x)
        path = str(tmp_path / "gone")
        jit.save(net, path, input_spec=[jit.InputSpec([None, 4])])
        del net
        gc.collect()
        loaded = jit.load(path, device="cpu")
        assert torch.equal(loaded(x), want)
        assert loaded.eval() is loaded
        with pytest.raises(RuntimeError, match="inference-only"):
            loaded.train()
        assert set(loaded.state_dict()) == {"0.weight", "0.bias",
                                            "2.weight", "2.bias"}

    def test_to_static_forward_saves_its_spec(self, tmp_path):
        """A ``to_static`` function with an input spec saves without one
        given, through the function it compiles."""
        net = _mlp(3)
        fwd = jit.to_static(net.forward,
                            input_spec=[jit.InputSpec([None, 4], "float32",
                                                      name="feats")])
        path = str(tmp_path / "static")
        jit.save(fwd, path)
        meta = json.load(open(path + ".pdmeta.json"))
        assert meta["input_names"] == ["feats"]
        x = torch.randn(2, 4)
        with torch.no_grad():
            assert torch.equal(jit.load(path, device="cpu")(x), net(x))

    def test_missing_spec_raises(self, tmp_path):
        with pytest.raises(ValueError, match="input_spec"):
            jit.save(_mlp(), str(tmp_path / "x"))


def _archive_tensors(path: str) -> int:
    """Bytes of tensor data stored in a ``torch.export`` archive: its
    weights, constants and sample inputs (their config files aside)."""
    with zipfile.ZipFile(path) as z:
        return sum(i.file_size for i in z.infolist()
                   if "/data/" in i.filename
                   and not i.filename.endswith("_config.json"))


def test_program_is_weight_free_and_calls_the_registered_op(tmp_path):
    """The exported program takes the state as inputs: the archive holds
    no tensor, the ``.pdiparams`` holds them all, and every attention is
    ``paddle_tpu_torch::flash_fwd`` (the op the dispatcher sends to K1 on
    the card)."""
    model = GPTForCausalLM(gpt_tiny(), device="cpu").eval()
    path = str(tmp_path / "gpt")
    jit.save(model, path, input_spec=[jit.InputSpec([None, 16], "int64")])
    loaded = jit.load(path, device="cpu")
    prog = loaded._program
    assert len(prog.state_dict) == 0 and len(prog.constants) == 0
    assert _archive_tensors(path + ".pdmodel") == 0
    params = framework.load(path + ".pdiparams")
    assert set(params) == {n for n, _ in model.named_parameters()}
    ops = [n.target for n in prog.graph.nodes if n.op == "call_function"]
    flash = [t for t in ops
             if t == torch.ops.paddle_tpu_torch.flash_fwd.default]
    assert len(flash) == model.config.num_hidden_layers
    assert not any("scaled_dot_product" in str(t) for t in ops)


def test_registered_op_dispatches_by_device():
    """On CPU tensors the op runs K1's plain version; its fake gives ``o``
    like ``q`` and f32 ``lse`` ``[B*H, S]``; no-grad attention takes it
    (a CPU call launches nothing)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, 3, 16, generator=g) for _ in range(3))
    o, lse = torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, True)
    ro, rlse = att._flash_fwd_reference(q, k, v, True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    from torch._subclasses.fake_tensor import FakeTensorMode
    qh = q.half()
    with FakeTensorMode() as mode:
        fq = mode.from_tensor(qh)
        fo, flse = torch.ops.paddle_tpu_torch.flash_fwd(fq, fq, fq, False)
        assert fo.shape == q.shape and fo.dtype == torch.float16
        assert flse.shape == (6, 8) and flse.dtype == torch.float32
    kernels.reset_launches()
    with torch.no_grad():
        out = att.flash_attention(q, k, v, is_causal=True)
    assert torch.equal(out, ro)
    assert sum(kernels.launch_counts().values()) == 0


def test_control_flow_on_a_tensor_value_is_refused(tmp_path):
    """The forward of ``tests/test_jit.py:249-283``, whose ``if h.sum() >
    0`` returns early: ``jit.save`` converts it as ``to_static`` does (the
    early return a ``torch.cond`` over the flag), and the loaded program
    follows the data, as the JAX package's does, for both signs of input
    and under a symbolic batch of 7: within 1e-6 of the eager forward
    (and of the JAX package's saved program, same weights, 1e-5).  Kept
    under its old name: it held the refusal this replaces."""

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 4)

        def forward(self, x):
            h = self.lin(x)
            if h.sum() > 0:
                return h * 2
            i = 0
            while i < 2:
                h = h + 1
                i += 1
            return h

    class JNet(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = paddle.nn.Linear(4, 4)

        def forward(self, x):
            h = self.lin(x)
            if h.sum() > 0:
                return h * 2
            i = 0
            while i < 2:
                h = h + 1
                i += 1
            return h

    paddle.seed(0)
    jnet = JNet()
    net = Net()
    with torch.no_grad():
        net.lin.weight.copy_(torch.from_numpy(
            np.asarray(jnet.lin.weight.numpy()).T))
        net.lin.bias.copy_(torch.from_numpy(np.asarray(jnet.lin.bias.numpy())))
    x = np.ones((2, 4), np.float32)
    xneg = -np.ones((2, 4), np.float32) * 10
    path = str(tmp_path / "cf")
    jit.save(net, path, input_spec=[static.InputSpec([None, 4], "float32")])
    loaded = jit.load(path, device="cpu")
    jpath = str(tmp_path / "jcf")
    paddle.jit.save(jnet, jpath, input_spec=[
        paddle.static.InputSpec([None, 4], "float32")])
    jloaded = paddle.jit.load(jpath)
    for a in (x, xneg):
        want = net(torch.from_numpy(a)).detach()
        got = loaded(torch.from_numpy(a))
        assert torch.allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jloaded(paddle.to_tensor(a)).numpy()),
            rtol=1e-5, atol=1e-5)
    assert loaded(torch.ones(7, 4)).shape[0] == 7
    # the branch and the loop are the archive's, not a trace of one path
    ops = {str(n.target) for n in loaded._program.graph.nodes
           if n.op == "call_function"}
    assert any("cond" in o for o in ops)


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """A JAX ``gpt_tiny`` saved by the JAX package's ``jit.save``."""
    d = tmp_path_factory.mktemp("jaxsave")
    paddle.seed(0)
    jm = jax_gpt.GPTForCausalLM(jax_gpt.gpt_tiny())
    jm.eval()
    path = str(d / "gpt")
    paddle.jit.save(jm, path,
                    input_spec=[paddle.static.InputSpec([None, 16], "int64")])
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return path, sd


def test_jax_program_is_refused_and_its_params_read(jax_saved, tmp_path):
    path, sd = jax_saved
    with pytest.raises(ValueError, match="StableHLO"):
        jit.load(path, device="cpu")
    params = framework.load(path + ".pdiparams")
    assert set(params) == set(sd)
    for name, arr in sd.items():
        np.testing.assert_array_equal(params[name].detach().numpy(), arr)
    model = GPTForCausalLM(gpt_tiny(), device="cpu")
    ported = port_state_dict_from_jax(
        model, framework.load(path + ".pdiparams", return_numpy=True))
    assert set(ported) == set(dict(model.named_parameters()))


def test_sidecar_equals_the_jax_one(jax_saved, tmp_path):
    """The same model and spec saved by both packages: format, input
    names and shapes equal; dtypes equal once int64 reads as the JAX
    package's int32 (its 64-bit types canonicalize to 32)."""
    jpath, sd = jax_saved
    model = from_jax_state_dict(GPTForCausalLM(gpt_tiny(), device="cpu"),
                                sd).eval()
    ppath = str(tmp_path / "gpt")
    jit.save(model, ppath,
             input_spec=[static.InputSpec([None, 16], "int64")])
    jmeta = json.load(open(jpath + ".pdmeta.json"))
    pmeta = json.load(open(ppath + ".pdmeta.json"))
    assert pmeta["format"] == jmeta["format"] == 1
    assert pmeta["input_names"] == jmeta["input_names"] == ["x0"]
    canon = {"int64": "int32", "float64": "float32"}
    for p, j in zip(pmeta["inputs"], jmeta["inputs"]):
        assert p["name"] == j["name"] and p["shape"] == j["shape"]
        assert canon.get(p["dtype"], p["dtype"]) == j["dtype"]


def test_load_on_a_missing_card_raises(tmp_path):
    path = str(tmp_path / "m")
    jit.save(_mlp(), path, input_spec=[jit.InputSpec([None, 4])])
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jit.load(path)


def test_static_input_spec_is_the_jit_one():
    assert static.InputSpec is jit.InputSpec
    spec = static.InputSpec([None, 16], "int64", name="ids")
    assert spec.dtype == torch.int64 and spec.shape == [None, 16]


# -- framework.io ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int64])
def test_framework_io_round_trip(tmp_path, dtype):
    g = torch.Generator().manual_seed(1)
    t = (torch.randn(3, 5, generator=g) * 7).to(dtype)
    obj = {"a": t, "nest": [t[0], (t[1:], 3)], "s": "x"}
    path = str(tmp_path / "sub" / "obj.pdparams")
    framework.save(obj, path)
    back = framework.load(path)
    assert back["s"] == "x" and back["nest"][1][1] == 3
    for a, b in [(back["a"], t), (back["nest"][0], t[0]),
                 (back["nest"][1][0], t[1:])]:
        assert a.dtype == dtype and torch.equal(a, b)
    arr = framework.load(path, return_numpy=True)["a"]
    want = t.float().numpy() if dtype == torch.bfloat16 else t.numpy()
    np.testing.assert_array_equal(arr, want)
    buf = io.BytesIO()
    framework.save(t, buf)
    buf.seek(0)
    assert torch.equal(framework.load(buf), t)


def test_framework_io_stores_bf16_as_the_jax_package_does(tmp_path):
    """bfloat16 goes to disk as its uint16 bits under the tag
    ``"bfloat16"``, and a parameter keeps ``stop_gradient=False``."""
    t = torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)
    p = nn.Parameter(torch.ones(2))
    buf = io.BytesIO()
    framework.save({"t": t, "p": p}, buf)
    buf.seek(0)
    raw = pickle.load(buf)
    assert raw["t"].dtype_name == "bfloat16"
    assert raw["t"].data.dtype == np.uint16
    np.testing.assert_array_equal(raw["t"].data,
                                  t.view(torch.int16).numpy().view(np.uint16))
    assert raw["p"].stop_gradient is False and raw["t"].stop_gradient
    buf.seek(0)
    assert framework.load(buf)["p"].requires_grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_framework_io_reads_jax_files(tmp_path, dtype):
    from paddle_tpu.framework.io import save as jax_save

    x = (np.random.RandomState(2).randn(4, 3) * 5).astype(np.float32)
    path = str(tmp_path / "j.pdparams")
    jax_save({"w": paddle.to_tensor(x).astype(dtype), "n": 7}, path)
    back = fio.load(path)
    want = torch.from_numpy(x).to(getattr(torch, dtype))
    assert back["n"] == 7 and torch.equal(back["w"], want)


def _global(mod: bytes, name: bytes) -> bytes:
    """A pickle of the bare global ``mod.name``."""
    return (b"\x80\x04\x8c" + bytes([len(mod)]) + mod + b"\x8c"
            + bytes([len(name)]) + name + b"\x93.")


@pytest.mark.parametrize("mod,name,match", [
    (b"paddle_tpu.core.tensor", b"Tensor", "JAX package"),
    (b"os", b"system", "not a name a tensor file holds"),
    (b"builtins", b"eval", "not a name a tensor file holds"),
])
def test_framework_io_refuses_other_names(mod, name, match):
    """Only the tensor payload of the JAX package maps (nothing of it is
    imported); any other of its names is refused, and so is every name a
    tensor file does not hold (unpickling would call it)."""
    with pytest.raises(pickle.UnpicklingError, match=match):
        fio.load(io.BytesIO(_global(mod, name)))


def test_framework_io_takes_a_torch_state_dict(tmp_path):
    """A module's ``state_dict()`` (an ``OrderedDict``) round-trips."""
    net = _mlp(4)
    path = str(tmp_path / "sd.pdparams")
    framework.save(net.state_dict(), path)
    back = framework.load(path)
    assert list(back) == list(net.state_dict())
    assert all(torch.equal(back[k], v) for k, v in net.state_dict().items())
