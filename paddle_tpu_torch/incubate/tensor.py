"""``paddle.incubate``'s segment pooling (port of
``paddle_tpu/incubate/tensor.py``): ``segment_sum``, ``segment_mean``,
``segment_max`` and ``segment_min``.  They size their output from the
largest segment id, a host read: inside a CUDA graph capture they raise
``CaptureError``."""
from __future__ import annotations

import torch

from ..ops._helpers import check_host_read

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min"]


def _pool(x, dst, n: int, pool_type: str):
    """Rows of ``x`` reduced into ``n`` rows by ``dst`` (``sum``, ``mean``,
    ``max`` or ``min``); a row that receives nothing is 0."""
    dst = dst.long().reshape(-1)
    shape = (n,) + tuple(x.shape[1:])
    if pool_type == "sum":
        return x.new_zeros(shape).index_add(0, dst, x)
    cnt = torch.zeros(n, dtype=x.dtype, device=x.device).index_add(
        0, dst, torch.ones_like(dst, dtype=x.dtype))
    cnt = cnt.reshape((n,) + (1,) * (x.dim() - 1))
    if pool_type == "mean":
        s = x.new_zeros(shape).index_add(0, dst, x)
        return s / cnt.clamp(min=1)
    if pool_type not in ("max", "min"):
        raise ValueError(f"pool_type should be `sum`, `mean`, `max` or "
                         f"`min`, but received {pool_type}")
    idx = dst.reshape((-1,) + (1,) * (x.dim() - 1)).expand(x.shape)
    m = x.new_zeros(shape).scatter_reduce(
        0, idx, x, "amax" if pool_type == "max" else "amin",
        include_self=False)
    return torch.where(cnt > 0, m, torch.zeros_like(m))


def _segment(data, segment_ids, pool_type):
    check_host_read(f"incubate.segment_{pool_type}", segment_ids)
    n = int(segment_ids.max()) + 1 if segment_ids.numel() else 0
    return _pool(data, segment_ids, n, pool_type)


def segment_sum(data, segment_ids, name=None):
    """``out[i]`` = the sum of the rows of ``data`` whose id is ``i``."""
    return _segment(data, segment_ids, "sum")


def segment_mean(data, segment_ids, name=None):
    return _segment(data, segment_ids, "mean")


def segment_max(data, segment_ids, name=None):
    return _segment(data, segment_ids, "max")


def segment_min(data, segment_ids, name=None):
    return _segment(data, segment_ids, "min")
