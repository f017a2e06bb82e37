"""``paddle.incubate``'s tensor ops (port of ``paddle_tpu/incubate/
tensor.py`` and of the fused softmax and message-passing ops of
``paddle_tpu/incubate/operators.py``): segment pooling,
``graph_send_recv``, ``softmax_mask_fuse`` and its causal form, and the
fused LM-head cross-entropy of :mod:`..ops.fused`.  The segment ops size
their output from the largest segment id, a host read: inside a CUDA
graph capture they raise ``CaptureError``."""
from __future__ import annotations

import torch

from ..ops._helpers import check_host_read
from ..ops.fused import fused_linear_cross_entropy

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min",
           "graph_send_recv", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle", "fused_linear_cross_entropy"]


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


def graph_send_recv(x, src_index, dst_index, pool_type="sum", out_size=None,
                    name=None):
    """``x[src_index]`` reduced into rows ``dst_index`` (``out_size`` rows,
    ``x``'s count for None)."""
    n = x.shape[0] if out_size is None else int(out_size)
    msgs = x.index_select(0, src_index.long().reshape(-1))
    return _pool(msgs, dst_index, n, pool_type)


def _softmax_f32(y, dtype):
    return torch.softmax(y, dim=-1).to(dtype)


def softmax_mask_fuse(x, mask, name=None):
    """``softmax(x + mask)`` over the last dim, in f32, returned in
    ``x``'s dtype."""
    return _softmax_f32(x.float() + mask.float(), x.dtype)


def softmax_mask_fuse_upper_triangle(x, name=None):
    """The causal softmax: a key after its query gets -10000 first."""
    s_q, s_k = x.shape[-2], x.shape[-1]
    causal = torch.ones(s_q, s_k, dtype=torch.bool, device=x.device).tril()
    y = torch.where(causal, x.float(), torch.full_like(x, -10000.0,
                                                       dtype=torch.float32))
    return _softmax_f32(y, x.dtype)
