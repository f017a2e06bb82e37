"""``paddle.inference``: the deployment surface, and the serving engine.

Port of ``paddle_tpu/inference/__init__.py``.  The one-shot path serves a
:func:`.jit.save` artifact: ``Config(path)`` → :func:`create_predictor` →
the named input handles (``copy_from_cpu``) → ``Predictor.run()`` → the
output handles (``copy_to_cpu``), or ``run([arrays])`` in one call;
:class:`PredictorPool` gives N predictors over one load of the artifact.
The program runs on the card (``cuda:<device_id>``) unless
``config.disable_gpu()``; with no card it raises, and it never moves to
the CPU by itself.  Attention in a saved GPT or Llama runs K1 through the
registered op ``paddle_tpu_torch::flash_fwd``.

Every ``Config`` knob is accepted and recorded, as in the JAX package,
which acts on none of them: the precision a model runs in is the one it
was saved in (``amp.decorate(model, level="O2", dtype="float16")`` before
``jit.save`` serves it in f16), and ``enable_use_gpu(precision=...)`` is
recorded only.  numpy has no bfloat16 without ``ml_dtypes``, so a
bfloat16 output comes back from ``copy_to_cpu`` and ``run`` as float32
(every value exact); the JAX package returns ``ml_dtypes.bfloat16``.

:func:`create_engine` is the continuous-batching entry: it serves live
GPT and Llama models with KV-cache decode (:mod:`.serving`).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from . import jit as jit_mod
from .serving import Engine

__all__ = ["Config", "Predictor", "Tensor", "create_predictor",
           "DataType", "PredictorPool", "get_version",
           "get_num_bytes_of_data_type", "get_trt_compile_version",
           "get_trt_runtime_version",
           "PrecisionType", "PlaceType", "create_engine"]


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1
    XPU = 2
    TPU = 3


class Config:
    """Reference: ``paddle.inference.Config`` (analysis_config.cc).
    ``Config("model")`` names ``model.pdmodel``/``model.pdiparams``;
    ``Config("model.pdmodel")`` too."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if prog_file is not None and prog_file.endswith(".pdmodel"):
            self._path = prog_file[:-len(".pdmodel")]
        else:
            self._path = prog_file
        self._params_file = params_file
        self._use_accelerator = True
        self._device_id = 0
        self._memory_pool_mb = 0
        self._ir_optim = True
        self._precision = PrecisionType.Float32
        self._extra: Dict[str, object] = {}

    # -- device ---------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb: int = 100,
                       device_id: int = 0,
                       precision=PrecisionType.Float32):
        self._use_accelerator = True
        self._memory_pool_mb = memory_pool_init_size_mb
        self._device_id = int(device_id)
        self._precision = precision

    enable_use_tpu = enable_use_gpu

    def disable_gpu(self):
        self._use_accelerator = False

    def use_gpu(self) -> bool:
        return self._use_accelerator

    def device(self) -> torch.device:
        """Where a predictor of this config runs: ``cuda:<device_id>``
        unless :meth:`disable_gpu`, then the CPU."""
        return torch.device(f"cuda:{self._device_id}"
                            if self._use_accelerator else "cpu")

    # -- optimization knobs (recorded, as in the JAX package) -----------
    def switch_ir_optim(self, x: bool = True):
        self._ir_optim = x

    def ir_optim(self) -> bool:
        return self._ir_optim

    def enable_memory_optim(self, x: bool = True):
        self._extra["memory_optim"] = x

    def set_cpu_math_library_num_threads(self, n: int):
        self._extra["cpu_threads"] = n

    def enable_mkldnn(self):
        self._extra["mkldnn"] = True

    def enable_tensorrt_engine(self, *a, **k):
        self._extra["tensorrt"] = True

    def model_dir(self) -> Optional[str]:
        return self._path

    def prog_file(self) -> Optional[str]:
        return (self._path + ".pdmodel") if self._path else None

    def params_file(self) -> Optional[str]:
        return self._params_file or (
            (self._path + ".pdiparams") if self._path else None)

    def summary(self) -> str:
        return (f"Config(path={self._path}, accelerator="
                f"{self._use_accelerator}, device={self.device()}, "
                f"precision={self._precision}, ir_optim={self._ir_optim})")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Tensor:
    """Named input/output handle (reference: ``paddle_infer.Tensor``)."""

    def __init__(self, name: str):
        self.name = name
        self._data: Optional[np.ndarray] = None

    def reshape(self, shape):
        if self._data is not None:
            self._data = np.asarray(self._data).reshape(shape)

    def copy_from_cpu(self, arr: np.ndarray):
        self._data = np.asarray(arr)

    def copy_to_cpu(self) -> np.ndarray:
        return np.asarray(self._data)

    def shape(self):
        return list(np.asarray(self._data).shape) if self._data is not None \
            else []


class Predictor:
    """Reference: ``AnalysisPredictor`` via :func:`create_predictor`.

    ``_shared_layer`` lets :class:`PredictorPool` hand every slot the same
    loaded program instead of each slot loading the artifact again."""

    def __init__(self, config: Config, _shared_layer=None):
        self.config = config
        if not config.model_dir():
            raise ValueError("Config needs a model path (jit.save artifact)")
        self._layer = _shared_layer if _shared_layer is not None \
            else jit_mod.load(config.model_dir(), device=config.device())
        n_in = len(self._layer._program.graph_signature.user_inputs) \
            - len(self._layer._names)
        self._input_names = self._load_input_names(max(n_in, 1))
        self._inputs: Dict[str, Tensor] = {
            n: Tensor(n) for n in self._input_names}
        self._outputs: List[Tensor] = []

    def _load_input_names(self, n_in: int) -> List[str]:
        """The input names of the artifact's sidecar
        (``<path>.pdmeta.json``); without it, ``x0``, ``x1``, ..."""
        try:
            with open(self.config.model_dir() + ".pdmeta.json") as f:
                names = list(json.load(f)["input_names"])
            if names and len(names) == n_in and \
                    all(isinstance(n, str) and n for n in names) and \
                    len(set(names)) == len(names):
                return names
        except (OSError, ValueError, KeyError, TypeError):
            pass
        return [f"x{i}" for i in range(n_in)]

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> Tensor:
        try:
            return self._inputs[name]
        except KeyError:
            raise KeyError(
                f"unknown input {name!r}; this predictor's inputs are "
                f"{self._input_names}") from None

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Reference ``run()``: pass arrays and get the outputs as numpy
        arrays, or fill the input handles (``copy_from_cpu``), ``run()``
        (True) and read the output handles."""
        if inputs is not None:
            arrs = [np.asarray(a) for a in inputs]
        else:
            arrs = [self._inputs[n].copy_to_cpu()
                    for n in self._input_names]
        out = self._layer(*arrs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        self._outputs = []
        res = []
        for i, o in enumerate(outs):
            arr = _to_numpy(o) if isinstance(o, torch.Tensor) \
                else np.asarray(o)
            t = Tensor(f"out{i}")
            t.copy_from_cpu(arr)
            self._outputs.append(t)
            res.append(arr)
        return res if inputs is not None else True

    def get_output_names(self) -> List[str]:
        return [t.name for t in self._outputs]

    def get_output_handle(self, name: str) -> Tensor:
        for t in self._outputs:
            if t.name == name:
                return t
        raise KeyError(name)


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


class DataType:
    """Reference ``paddle_infer.DataType``."""

    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6


_DTYPE_BYTES = {
    DataType.FLOAT32: 4, DataType.INT64: 8, DataType.INT32: 4,
    DataType.UINT8: 1, DataType.INT8: 1, DataType.FLOAT16: 2,
    DataType.BFLOAT16: 2,
}


def get_num_bytes_of_data_type(dtype) -> int:
    return _DTYPE_BYTES[int(dtype)]


def get_version() -> str:
    return f"paddle_tpu_torch inference (torch {torch.__version__})"


def get_trt_compile_version():
    return (0, 0, 0)   # no TensorRT: the port's kernels are its own


def get_trt_runtime_version():
    return (0, 0, 0)


class PredictorPool:
    """N predictors over one artifact (reference
    ``paddle_infer.PredictorPool``): the first slot loads it and every
    further slot reuses that :class:`~.jit.TranslatedLayer`; each slot
    keeps its own input and output handles."""

    def __init__(self, config: Config, size: int = 1):
        first = Predictor(config)
        self._preds = [first] + [
            Predictor(config, _shared_layer=first._layer)
            for _ in range(max(int(size), 1) - 1)]

    def retrive(self, idx: int) -> Predictor:   # reference spells it so
        return self._preds[idx]

    retrieve = retrive


def create_engine(config, *, device="cuda", dtype=torch.float32,
                  seed: int = 0, journal=None, speculation=None,
                  **engine_kwargs) -> Engine:
    """Build a continuous-batching :class:`~.serving.Engine` from a
    ``GPTConfig``/``LlamaConfig``, a registry name (``"gpt:gpt2-345m"``,
    ``"llama:llama2-7b"``) or a model.

    A new model is built on ``device`` (``"cuda"`` unless the caller asks
    for ``"cpu"``) in ``dtype`` (float32, bfloat16 or float16), with
    weights drawn from a generator seeded with ``seed``; ``journal`` (a
    :class:`~.serving.RequestJournal`) journals every accepted request for
    ``Engine.recover``; ``speculation`` (a :class:`~.serving.SpecConfig`)
    serves in speculative rounds; ``engine_kwargs`` go to :class:`Engine`
    (``kv_layout``, ``block_size``, ``num_slots``, ``adapters``,
    ``grammars``, ...)."""
    return Engine.from_config(config, device=device, dtype=dtype, seed=seed,
                              journal=journal, speculation=speculation,
                              **engine_kwargs)
