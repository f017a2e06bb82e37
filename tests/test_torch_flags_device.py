"""The port's flags, NaN/Inf check, ``utils`` and device API against the
JAX package's, on the CPU.

Spec: ``tests/test_nan_check.py`` (eager: the error names the op, as the
JAX one does; no false positive; a step under ``to_static``, which on the
CPU runs its body eagerly, raises naming the op; the flag off lets a NaN
through), ``tests/test_fft_signal.py::TestUtilsParity``,
``tests/test_device_memory.py::TestMemoryStatsAPI`` and the flag
registry of ``paddle_tpu/core/flags.py``.  The captured check's device
buffer (``flags.CapturedCheck``, what a CUDA graph writes) is driven here
on CPU tensors; its capture and replay on the card are in
``tests/test_torch_cuda.py``.
"""
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch import flags

torch.set_num_threads(2)


@pytest.fixture
def nan_flag():
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    pt.set_flags({"FLAGS_check_nan_inf": True})
    yield
    paddle.set_flags({"FLAGS_check_nan_inf": False})
    pt.set_flags({"FLAGS_check_nan_inf": False})


def _op_in(msg: str) -> str:
    return re.search(r"Operator (\S+) output", msg).group(1)


class TestFlags:
    def test_same_flags_and_defaults_as_jax(self):
        jax_flags = paddle.get_flags()
        port = pt.get_flags()
        assert sorted(port) == sorted(jax_flags)
        for name in ("check_nan_inf", "benchmark", "use_flash_attention",
                     "cache_jit_programs"):
            assert port[name] == jax_flags[name]

    def test_prefixed_names_and_parsing(self):
        assert pt.get_flags("FLAGS_benchmark") == {"FLAGS_benchmark": False}
        pt.set_flags({"FLAGS_benchmark": "true"})
        try:
            assert flags.get_flag("benchmark") is True
        finally:
            pt.set_flags({"benchmark": False})
        with pytest.raises(KeyError):
            pt.set_flags({"FLAGS_no_such_flag": 1})

    def test_define_flag_reads_the_environment(self, monkeypatch):
        monkeypatch.setenv("FLAGS_torch_test_flag", "7")
        assert pt.define_flag("torch_test_flag", 3) == 7
        assert pt.get_flags(["torch_test_flag"]) == {"torch_test_flag": 7}

    def test_env_arms_the_check_at_import(self):
        code = ("import torch, paddle_tpu_torch as pt\n"
                "try:\n    torch.log(torch.tensor([-1.0]))\n"
                "except FloatingPointError as e:\n    print('raised', e)\n")
        out = subprocess.run([sys.executable, "-c", code], text=True,
                             capture_output=True, timeout=120,
                             env={**__import__("os").environ,
                                  "FLAGS_check_nan_inf": "1"})
        assert "raised Operator log output contains NaN/Inf" in out.stdout


class TestNanCheckEager:
    def test_eager_raises_with_the_jax_op_name(self, nan_flag):
        x = np.array([-1.0, 2.0], np.float32)
        with pytest.raises(FloatingPointError) as jerr:
            paddle.log(paddle.to_tensor(x))
        with pytest.raises(FloatingPointError) as terr:
            pt.log(torch.from_numpy(x))
        assert _op_in(str(terr.value)) == _op_in(str(jerr.value)) == "log"

    @pytest.mark.parametrize("case", ["sqrt", "divide", "multiply", "add",
                                      "matmul", "exp", "op*", "op/"])
    def test_other_ops_name_the_jax_op(self, nan_flag, case):
        x, z = np.array([-1.0, 0.0], np.float32), np.zeros(2, np.float32)
        big = np.full(2, 3e38, np.float32)
        run = {"sqrt": lambda P, T: P.sqrt(T(x)),
               "divide": lambda P, T: P.divide(T(x), T(z)),
               "multiply": lambda P, T: P.multiply(T(big), T(big)),
               "add": lambda P, T: P.add(T(big), T(big)),
               "matmul": lambda P, T: P.matmul(T(big.reshape(1, 2)),
                                               T(big.reshape(2, 1))),
               "exp": lambda P, T: P.exp(T(big)),
               "op*": lambda P, T: T(big) * T(big),
               "op/": lambda P, T: T(x) / T(z)}[case]
        names = []
        for pkg, wrap in ((paddle, paddle.to_tensor),
                          (pt, torch.from_numpy)):
            with pytest.raises(FloatingPointError) as err:
                run(pkg, wrap)
            names.append(_op_in(str(err.value)))
        assert names[0] == names[1]

    def test_no_false_positive(self, nan_flag):
        out = pt.log(torch.tensor([1.0, 2.0]))
        assert torch.isfinite(out).all()

    def test_to_static_step_raises_with_op_name(self, nan_flag):
        pt.seed(0)
        model = pt.nn.Linear(4, 2, device="cpu")
        opt = pt.optimizer.SGD(model.parameters(), lr=0.1)

        @pt.jit.to_static
        def step(x, y):
            h = model(x)
            h = torch.log(h - h.max() - 1.0)
            loss = ((h - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        with pytest.raises(FloatingPointError, match="log"):
            step(torch.ones(4, 4), torch.ones(4, 2))

    def test_flag_off_lets_nan_through(self):
        assert flags._mode is None
        out = pt.log(torch.tensor([-1.0]))
        assert torch.isnan(out).all()

    def test_checking_ops_are_not_scanned(self, nan_flag):
        x = torch.tensor([float("nan")])
        assert bool(torch.isnan(x).all())
        assert torch.nan_to_num(x).item() == 0.0


class TestCapturedCheckBuffer:
    def test_first_op_that_fired_is_named(self):
        chk = flags.CapturedCheck()
        chk.record("matmul", torch.ones(3))
        chk.record("log", torch.tensor([float("nan")]))
        chk.record("exp", torch.tensor([float("inf")]))
        with pytest.raises(FloatingPointError, match="Operator log output"):
            chk.raise_if_fired()

    def test_clean_buffer_passes_and_chunks_grow(self):
        chk = flags.CapturedCheck()
        for i in range(flags.CapturedCheck.CHUNK + 3):
            chk.record(f"op{i}", torch.zeros(1))
        chk.raise_if_fired()
        assert len(chk._chunks) == 2
        chk.record("last", torch.tensor([float("-inf")]))
        with pytest.raises(FloatingPointError, match="Operator last"):
            chk.raise_if_fired()


class TestUtils:
    def test_deprecated_warns(self):
        from paddle_tpu.utils import deprecated as jdep
        from paddle_tpu_torch.utils import deprecated

        for dec in (jdep, deprecated):
            @dec(update_to="paddle.new_api", since="0.3")
            def old_api():
                return 42

            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                assert old_api() == 42
            assert any(issubclass(x.category, DeprecationWarning) for x in w)
            assert "deprecated" in (old_api.__doc__ or "")

    def test_deprecated_level2_raises(self):
        from paddle_tpu_torch.utils import deprecated

        @deprecated(level=2)
        def removed_api():
            return 1

        with pytest.raises(RuntimeError):
            removed_api()

    def test_run_check(self, capsys):
        pt.utils.run_check()
        out = capsys.readouterr().out
        assert "successfully" in out and "cpu" in out

    def test_unique_name(self):
        from paddle_tpu.utils import unique_name as jun
        from paddle_tpu_torch.utils import unique_name

        for un in (jun, unique_name):
            assert un.generate("fc") != un.generate("fc")
            with un.guard():
                assert un.generate("fc") == "fc_0"
        with unique_name.guard("pre_"):
            assert unique_name.generate("fc") == "pre_fc_0"

    def test_require_version_and_try_import(self):
        from paddle_tpu_torch.utils import require_version, try_import

        require_version("0.1")
        with pytest.raises(Exception):
            require_version("99.0")
        with pytest.raises(Exception):
            require_version("0.0.1", "0.0.2")
        assert try_import("math").sqrt(4.0) == 2.0
        with pytest.raises(ImportError, match="no_such_module"):
            try_import("no_such_module")


class TestDevice:
    def test_surface_exists_and_returns_ints(self):
        d = pt.device
        assert isinstance(d.memory_stats(), dict)
        for fn in (d.memory_allocated, d.max_memory_allocated,
                   d.memory_reserved, d.max_memory_reserved):
            assert fn() >= 0
        d.synchronize()
        assert d.cuda.max_memory_allocated() >= 0
        assert d.cuda is d.tpu

    def test_cpu_values_match_the_jax_cpu_backend(self):
        for dev in (None, 0, pt.device.CPUPlace(), "cpu"):
            assert pt.device.memory_stats(dev) == {} or \
                torch.cuda.is_available()
        # a place of no torch device counts as the CPU
        assert pt.device.memory_stats(pt.device.XPUPlace(0)) == {}
        assert pt.device.memory_allocated("cpu") == \
            paddle.device.memory_allocated() == 0

    def test_places_name_torch_devices(self):
        d = pt.device
        assert d.CPUPlace().device == torch.device("cpu")
        assert d.CUDAPlace(1).device == torch.device("cuda", 1)
        assert d.CUDAPlace(1) == d.CUDAPlace(1) != d.CUDAPlace(0)
        assert d.CUDAPlace(0).is_gpu_place() and d.CPUPlace().is_cpu_place()
        with pytest.raises(RuntimeError):
            d.XPUPlace(0).device

    def test_counts_and_predicates(self):
        d = pt.device
        assert d.device_count("cpu") == 1
        assert d.device_count() == torch.cuda.device_count()
        assert d.get_all_device_type()[0] == "cpu"
        assert d.get_available_device()[0] == "cpu"
        assert d.is_compiled_with_cuda() == pt.is_compiled_with_cuda()
        assert not d.is_compiled_with_xpu() and not d.is_compiled_with_mlu()
        assert d.get_cudnn_version() == pt.get_cudnn_version()
