"""AMP autocast: the JAX package's per-op dtype policy, and ``decorate``.

Port of ``paddle_tpu/amp/auto_cast.py``.  ``WHITE_LIST`` and
``BLACK_LIST`` are the JAX package's, verbatim, and the policy applies
per op by the JAX op name:

- a white op's float inputs are cast to the low dtype (bf16 or f16);
- a black op's float inputs are cast to f32;
- a gray op (any other) runs in whatever dtype arrives at O1, and has its
  float inputs cast down at O2;
- ``cast`` itself passes through.

``torch.autocast`` is not used: its lists are not these.  It runs
``layer_norm`` in f32, where the JAX package leaves the norms gray
(dtype-preserving, f32 statistics inside), and it leaves ``embedding``
alone, where the JAX package white-lists it so that the whole block runs
in the low dtype; either would change the residual stream's dtype.

How the policy reaches the ops.  Inside :func:`auto_cast` a
``torch.overrides.TorchFunctionMode`` sees every torch function call and
maps the ones the port's models and users call (``F.linear``,
``F.embedding``, ``torch.matmul``, ``softmax``, ``mean``, ``sum``, the
residual ``+``, ``reshape``/``view``, ``split``, ``gelu``, ...) to their
JAX op names (:data:`TORCH_OPS`); a torch function that is not mapped
passes through untouched at every level.  The port's own ops (flash
attention, the norms, the fused cross-entropy) consult the policy by
their JAX name through :func:`amp_op`.  Either way an op's body runs with
the policy suspended, so the torch calls inside it are the op's own
business, as the inside of a JAX primal is.  Under a CUDA graph capture
the policy is host work: it decides which casts the graph holds, and the
replays run them.

The policy state is per thread (as ``torch.autocast``'s is); a recompute
region keeps the state it was entered with (``distributed.fleet``).

O2 is :func:`decorate`: every f32 parameter of the model cast to the low
dtype, the optimizer keeping an f32 master of each.  The port's O2 train
step needs no per-op policy on top: with bf16 parameters every op of the
step already runs in bf16, and the O2 train-parity test holds it to the
JAX step under ``auto_cast(level="O2")``.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Iterable, Optional, Set, Union

import torch
from torch import nn
from torch.nn import functional as F
from torch.overrides import TorchFunctionMode

from .. import flags

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_op", "amp_state",
           "WHITE_LIST", "BLACK_LIST", "LOW_DTYPES", "TORCH_OPS"]

# MXU-bound ops: cast to the low dtype (reference: white list
# fluid/dygraph/amp/auto_cast.py WHITE_LIST — matmul/conv/mul)
WHITE_LIST: Set[str] = {
    "matmul", "mm", "bmm", "mv", "linear", "einsum", "inner", "outer",
    "tensordot", "multi_dot",
    "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
    "flash_attention",
    # embedding output sets the residual stream's dtype: bf16 keeps the
    # whole transformer block (LN included, see below) in bf16
    "embedding",
    # chunked TP-overlap forwards must cast like their GSPMD twins
    # (linear / embedding) so chunks>1 stays AMP-transparent
    "tp_overlap_column_linear", "tp_overlap_row_linear",
    "tp_overlap_vocab_embedding",
}

# numerically sensitive ops: force f32 (reference: BLACK_LIST —
# softmax/CE/norms/exp/log/pow...).  The norm family is NOT listed: our
# layer_norm/rms_norm/batch_norm kernels are dtype-preserving with f32
# internal statistics (TPU-native AMP), so f32 promotion would only
# force a full-f32 residual stream and cast traffic around every matmul.
BLACK_LIST: Set[str] = {
    "softmax", "log_softmax", "cross_entropy", "parallel_cross_entropy",
    "tp_overlap_cross_entropy",
    "bce_with_logits", "binary_cross_entropy", "nll_loss", "kl_div",
    "ctc_loss",
    "mean", "sum", "var", "std",
    "cumsum", "logcumsumexp", "prod", "square_error_cost",
}

LOW_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}

T = torch.Tensor
#: torch function -> the JAX op name the policy knows it by
TORCH_OPS = {
    **dict.fromkeys((torch.matmul, T.matmul, T.__matmul__, T.__rmatmul__),
                    "matmul"),
    **dict.fromkeys((torch.mm, T.mm), "mm"),
    **dict.fromkeys((torch.bmm, T.bmm), "bmm"),
    **dict.fromkeys((torch.mv, T.mv), "mv"),
    F.linear: "linear",
    torch.einsum: "einsum",
    **dict.fromkeys((torch.inner, T.inner), "inner"),
    **dict.fromkeys((torch.outer, T.outer), "outer"),
    torch.tensordot: "tensordot",
    torch.linalg.multi_dot: "multi_dot",
    F.conv1d: "conv1d", F.conv2d: "conv2d", F.conv3d: "conv3d",
    F.conv_transpose1d: "conv1d_transpose",
    F.conv_transpose2d: "conv2d_transpose",
    F.conv_transpose3d: "conv3d_transpose",
    F.embedding: "embedding",
    **dict.fromkeys((torch.softmax, T.softmax, F.softmax), "softmax"),
    **dict.fromkeys((torch.log_softmax, T.log_softmax, F.log_softmax),
                    "log_softmax"),
    F.cross_entropy: "cross_entropy",
    F.binary_cross_entropy_with_logits: "bce_with_logits",
    F.binary_cross_entropy: "binary_cross_entropy",
    F.nll_loss: "nll_loss", F.kl_div: "kl_div", F.ctc_loss: "ctc_loss",
    **dict.fromkeys((torch.mean, T.mean), "mean"),
    **dict.fromkeys((torch.sum, T.sum), "sum"),
    **dict.fromkeys((torch.var, T.var), "var"),
    **dict.fromkeys((torch.std, T.std), "std"),
    **dict.fromkeys((torch.cumsum, T.cumsum), "cumsum"),
    **dict.fromkeys((torch.logcumsumexp, T.logcumsumexp), "logcumsumexp"),
    **dict.fromkeys((torch.prod, T.prod), "prod"),
    # gray ops of the port's models, named so that O2 casts them down
    **dict.fromkeys((torch.add, T.add, T.__add__, T.__radd__), "add"),
    **dict.fromkeys((torch.reshape, T.reshape, T.view), "reshape"),
    **dict.fromkeys((torch.split, T.split), "split"),
    F.gelu: "gelu",
}
del T


class AmpState:
    def __init__(self, enable: bool, dtype: str, level: str,
                 white: Set[str], black: Set[str]):
        self.enable = enable
        self.dtype = LOW_DTYPES[dtype]
        self.level = level
        self.white = white
        self.black = black


_local = threading.local()


def amp_state() -> Optional[AmpState]:
    """This thread's policy: the innermost ``auto_cast``'s, or None."""
    return getattr(_local, "state", None)


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def _cast_args(args, target):
    return [_dispatch("cast", torch.Tensor.to, (a, target), {})
            if _is_float(a) and a.dtype != target else a for a in args]


def _hook(name: str, tensor_args):
    """The policy for op ``name``: its tensor arguments, cast."""
    s = amp_state()
    if s is None or not s.enable or name == "cast":
        # "cast" passes through or the hook's own casts would recurse
        return tensor_args
    if name in s.white:
        return _cast_args(tensor_args, s.dtype)
    if name in s.black:
        return _cast_args(tensor_args, torch.float32)
    if s.level == "O2":
        # pure-low-precision: run gray ops in the low dtype too
        return _cast_args(tensor_args, s.dtype)
    return tensor_args


@contextlib.contextmanager
def _suspended():
    prev = amp_state()
    _local.state = None
    try:
        yield
    finally:
        _local.state = prev


def _dispatch(name: str, fn: Callable, args, kwargs):
    """Op ``name``: its tensor arguments (positional, then keyword) through
    :func:`_hook`, then ``fn`` with the policy suspended."""
    keys = [k for k, v in kwargs.items() if isinstance(v, torch.Tensor)]
    pos = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    cast = _hook(name, [args[i] for i in pos] + [kwargs[k] for k in keys])
    args = list(args)
    for i, t in zip(pos, cast):
        args[i] = t
    kwargs = {**kwargs, **dict(zip(keys, cast[len(pos):]))}
    with _suspended():
        return fn(*args, **kwargs)


class _AmpMode(TorchFunctionMode):
    """Routes the torch functions of :data:`TORCH_OPS` through the
    policy; every other call passes through."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = TORCH_OPS.get(func)
        s = amp_state()
        if name is None or s is None or not s.enable:
            return func(*args, **kwargs)
        return _dispatch(name, func, args, kwargs)


def amp_op(name: str):
    """Decorator of a port op that the JAX package dispatches as ``name``:
    under :func:`auto_cast` its tensor arguments take the policy of that
    name and its body runs with the policy suspended."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            s = amp_state()
            if s is None or not s.enable:
                return fn(*args, **kwargs)
            return _dispatch(name, fn, args, kwargs)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if flags._mode is not None:     # FLAGS_check_nan_inf: one op
                return flags.as_one_op(name, run, *args, **kwargs)
            return run(*args, **kwargs)
        return wrapper
    return deco


@contextlib.contextmanager
def _policy(state: Optional[AmpState]):
    """``state`` as this thread's policy inside the block (the mode that
    applies it pushed for the block), the previous one after."""
    prev = amp_state()
    _local.state = state
    try:
        with _AmpMode():
            yield
    finally:
        _local.state = prev


def auto_cast(enable: bool = True,
              custom_white_list: Optional[Iterable[str]] = None,
              custom_black_list: Optional[Iterable[str]] = None,
              level: str = "O1", dtype: str = "bfloat16"):
    """Context manager (reference: amp/auto_cast.py:21): inside it, the
    ops take the policy of ``level`` (``"O0"`` switches it off, as
    ``enable=False`` does) in the low ``dtype`` (``"bfloat16"`` or
    ``"float16"``).  A custom list takes precedence over the default
    lists; an op in both custom lists raises.  The previous policy comes
    back on exit."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"level must be O0/O1/O2, got {level}")
    if dtype not in LOW_DTYPES:
        raise ValueError(f"dtype must be bfloat16/float16, got {dtype}")
    cw, cb = set(custom_white_list or ()), set(custom_black_list or ())
    if cw & cb:
        raise ValueError(f"ops in both custom lists: {sorted(cw & cb)}")
    white = (set(WHITE_LIST) | cw) - cb
    black = (set(BLACK_LIST) | cb) - cw
    return _policy(AmpState(enable and level != "O0", dtype, level, white,
                            black))


amp_guard = auto_cast  # legacy alias (fluid/dygraph/amp/auto_cast.py)


def _low_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(dtype, str):
        if dtype not in LOW_DTYPES:
            raise ValueError(f"dtype must be one of {sorted(LOW_DTYPES)}, "
                             f"got {dtype!r}")
        return LOW_DTYPES[dtype]
    if dtype not in LOW_DTYPES.values():
        raise ValueError(f"dtype must be bfloat16 or float16, got {dtype}")
    return dtype


@torch.no_grad()
def decorate(models, optimizers=None, level: str = "O2",
             dtype: Union[str, torch.dtype] = torch.bfloat16):
    """Prepare ``models`` (one ``nn.Module`` or a list) for ``level``.

    O2 casts every f32 parameter to ``dtype`` in place (the optimizer
    keeps its references and builds f32 masters at its first step); O0
    and O1 return the models unchanged.  Returns ``(models, optimizers)``
    when optimizers are given, else ``models``."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"level must be O0/O1/O2, got {level!r}")
    if level == "O2":
        low = _low_dtype(dtype)
        for m in (models if isinstance(models, (list, tuple)) else [models]):
            if not isinstance(m, nn.Module):
                raise TypeError(f"decorate takes nn.Modules, got {type(m)}")
            for p in m.parameters():
                if p.dtype == torch.float32:
                    p.data = p.data.to(low)
    return (models, optimizers) if optimizers is not None else models
