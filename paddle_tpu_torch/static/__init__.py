"""``paddle.static``: the program mode (:mod:`.program`: ``Program``,
``Executor``, ``data``, ``program_guard``, inference save/load, program
state), the layer builders and control flow of :mod:`.nn`, ``InputSpec``
(the class of :mod:`..jit`), ``save``/``load`` (:mod:`..framework.io`),
``WeightNormParamAttr`` and ``create_parameter``: every name of
``paddle_tpu/static/__init__.py``'s ``__all__``, plus ``case`` and
``switch_case``.  ``paddle_tpu_torch.enable_static()`` turns recording on.
"""
from ..framework.io import load, save
from ..jit import InputSpec
from ..nn.layer_base import ParamAttr as _ParamAttr
from . import nn
from .nn import case, cond, switch_case, while_loop
from .program import (
    BuildStrategy, CompiledProgram, ExecutionStrategy, Executor,
    ExponentialMovingAverage, IpuCompiledProgram, IpuStrategy,
    ParallelExecutor, Print, Program, Scope, Variable, accuracy,
    append_backward, auc, cpu_places, create_global_var, cuda_places, data,
    default_main_program, default_startup_program, deserialize_persistables,
    deserialize_program, device_guard, global_scope, gradients,
    ipu_shard_guard, load_from_file, load_inference_model,
    load_program_state, mlu_places, name_scope, normalize_program,
    npu_places, program_guard, py_func, save_inference_model,
    save_program_state, save_to_file, scope_guard, serialize_persistables,
    serialize_program, set_ipu_shard, set_program_state, xpu_places,
)


class WeightNormParamAttr(_ParamAttr):
    """``ParamAttr`` plus the weight-norm ``dim`` (reference
    ``fluid/param_attr.py``): the attribute carries the intent through a
    layer's construction."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        super().__init__(name=name, initializer=initializer,
                         learning_rate=learning_rate,
                         regularizer=regularizer, trainable=trainable,
                         need_clip=need_clip)
        self.dim = dim


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """``static.create_parameter``: the top-level factory."""
    from ..tensor import create_parameter as _create

    return _create(shape, dtype, name=name, attr=attr, is_bias=is_bias,
                   default_initializer=default_initializer)


__all__ = [
    "InputSpec", "nn", "cond", "while_loop", "case", "switch_case",
    "Program", "program_guard", "default_main_program",
    "default_startup_program", "data", "Executor", "Scope", "global_scope",
    "scope_guard", "cpu_places", "cuda_places", "create_global_var",
    "gradients", "append_backward", "name_scope", "device_guard",
    "BuildStrategy", "ExecutionStrategy", "CompiledProgram",
    "ParallelExecutor", "Print", "ExponentialMovingAverage", "accuracy",
    "auc", "save", "load", "save_inference_model", "load_inference_model",
    "serialize_program", "deserialize_program", "save_to_file",
    "load_from_file", "serialize_persistables", "deserialize_persistables",
    "save_program_state", "load_program_state", "set_program_state",
    "normalize_program", "py_func", "Variable", "xpu_places", "npu_places",
    "mlu_places", "IpuStrategy", "IpuCompiledProgram", "ipu_shard_guard",
    "set_ipu_shard", "create_parameter", "WeightNormParamAttr",
]
