"""Mixed precision for training: the O2 policy (bf16 parameters, f32
masters in the optimizer).

Port of ``paddle_tpu/amp/auto_cast.py`` ``decorate``.  O2 casts every f32
parameter of the model to the low dtype; :class:`optimizer.AdamW` keeps
an f32 master copy of each low-precision parameter and does all its
update math in f32.

No per-op cast hook is needed for the GPT train step.  Under the JAX
package's ``auto_cast(level="O2")`` every op of that step runs in the low
dtype: the white-list ops (linear, embedding, flash attention) and the
gray ops alike, which O2 casts down too.  The exceptions are the layer
norm statistics and the cross-entropy accumulators, which the ops keep in
f32 themselves, as the port's ``nn.norm.layer_norm`` and
``ops.fused.fused_linear_cross_entropy`` do.  With bf16 parameters every
PyTorch op of the port's step already runs in bf16, so the O2 model alone
is the policy; the O2 train-parity test holds it to the JAX step.  O1
``auto_cast`` (per-op casts over f32 parameters) is not ported
(ROADMAP.md A.6).
"""
from __future__ import annotations

from typing import Union

import torch
from torch import nn

__all__ = ["decorate", "LOW_DTYPES"]

LOW_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


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
