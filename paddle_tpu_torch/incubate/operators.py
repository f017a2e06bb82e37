"""``paddle.incubate``'s graph and fused-softmax operators.

Port of ``paddle_tpu/incubate/operators.py``: the message passing
``graph_send_recv`` and the fused softmaxes (``softmax_mask_fuse`` and
its causal form) are device ops; the samplers ``graph_reindex``,
``graph_sample_neighbors`` and ``graph_khop_sampler`` run on the host in
numpy, as the JAX ones do (:115-222), since how many edges they return
depends on the data.  Their outputs are int64 tensors on the device of
their first input; inside a CUDA graph capture they raise
``CaptureError``.  The JAX samplers draw from an unseeded
``np.random.default_rng()`` (:185, :209); these take ``rng=`` (a
``np.random.Generator``, a seed, or None for an unseeded one), so a
caller can repeat a draw.  With ``sample_size`` at or above a node's
degree (or -1) every neighbour is taken, in the graph's order, as in the
JAX samplers; below it a uniform draw without replacement.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops._helpers import check_host_read
from .tensor import _pool

__all__ = ["graph_send_recv", "graph_khop_sampler", "graph_sample_neighbors",
           "graph_reindex", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle"]


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


# -- host-side samplers -------------------------------------------------------

def _host(op: str, *tensors):
    """The tensors as flat int64 numpy arrays (a host read: refused in a
    capture)."""
    check_host_read(op, *tensors)
    return [np.asarray(t.detach().cpu().numpy() if isinstance(
        t, torch.Tensor) else t).reshape(-1).astype(np.int64)
        for t in tensors]


def _rng(rng) -> np.random.Generator:
    return rng if isinstance(rng, np.random.Generator) \
        else np.random.default_rng(rng)


def _out(a: np.ndarray, like) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)


def _reindex_np(x, neighbors):
    """Order-preserving relabel: ``x`` first, then new neighbour ids by
    first appearance; ``(mapped_neighbors, out_nodes)``."""
    out_nodes = list(x)
    table = {int(v): i for i, v in enumerate(x)}
    mapped = np.empty(len(neighbors), np.int64)
    for i, v in enumerate(neighbors):
        v = int(v)
        j = table.get(v)
        if j is None:
            j = table[v] = len(out_nodes)
            out_nodes.append(v)
        mapped[i] = j
    return mapped, np.asarray(out_nodes, np.int64)


def graph_reindex(x, neighbors, count, value_buffer=None, index_buffer=None,
                  flag_buffer_hashtable=False, name=None):
    """Relabel a sampled subgraph's nodes from 0: ``(reindex_src,
    reindex_dst, out_nodes)``, edges ``dst[i] <- src[i]`` over the new
    ids, the input nodes first."""
    xs, nb, ct = _host("incubate.graph_reindex", x, neighbors, count)
    mapped, out_nodes = _reindex_np(xs, nb)
    dst = np.repeat(np.arange(len(xs), dtype=np.int64), ct)
    return _out(mapped, x), _out(dst, x), _out(out_nodes, x)


def _sample_one_hop(row, colptr, nodes, sample_size, eids, rng):
    """CSC one hop: the neighbours of ``n`` are
    ``row[colptr[n]:colptr[n + 1]]``."""
    out_nb, out_ct, out_eids = [], [], []
    for n in nodes:
        beg, end = int(colptr[n]), int(colptr[n + 1])
        deg = end - beg
        if sample_size < 0 or deg <= sample_size:
            idx = np.arange(beg, end)
        else:
            idx = beg + rng.choice(deg, size=sample_size, replace=False)
        out_nb.append(row[idx])
        out_ct.append(len(idx))
        if eids is not None:
            out_eids.append(eids[idx])
    nb = np.concatenate(out_nb) if out_nb else np.empty(0, np.int64)
    es = (np.concatenate(out_eids) if out_eids else np.empty(0, np.int64)) \
        if eids is not None else None
    return nb, np.asarray(out_ct, np.int64), es


def graph_sample_neighbors(row, colptr, input_nodes, eids=None,
                           perm_buffer=None, sample_size=-1,
                           return_eids=False, flag_perm_buffer=False,
                           name=None, rng=None):
    """Up to ``sample_size`` neighbours of each input node (-1: all):
    ``(out_neighbors, out_count[, out_eids])``."""
    if return_eids and eids is None:
        raise ValueError("`eids` should not be None if `return_eids` is "
                         "True.")
    r, cp, nodes = _host("incubate.graph_sample_neighbors", row, colptr,
                         input_nodes)
    ea = _host("incubate.graph_sample_neighbors", eids)[0] \
        if return_eids else None
    nb, ct, es = _sample_one_hop(r, cp, nodes, int(sample_size), ea,
                                 _rng(rng))
    outs = (_out(nb, row), _out(ct, row))
    return outs + (_out(es, row),) if return_eids else outs


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None,
                       rng=None):
    """Neighbour sampling over ``len(sample_sizes)`` hops, then the
    subgraph relabelled: ``(edge_src, edge_dst, sample_index,
    reindex_nodes[, edge_eids])``, the edge columns ``[E, 1]``."""
    if return_eids and sorted_eids is None:
        raise ValueError("`sorted_eids` should not be None if `return_eids` "
                         "is True.")
    r, cp, seeds = _host("incubate.graph_khop_sampler", row, colptr,
                         input_nodes)
    ea = _host("incubate.graph_khop_sampler", sorted_eids)[0] \
        if return_eids else None
    gen = _rng(rng)
    frontier = seeds
    all_src, all_dst, all_eids = [], [], []
    for size in list(sample_sizes):
        nb, ct, es = _sample_one_hop(r, cp, frontier, int(size), ea, gen)
        all_src.append(nb)
        all_dst.append(np.repeat(frontier, ct))
        if es is not None:
            all_eids.append(es)
        # the next hop samples the neighbours of the nodes found
        frontier = np.unique(nb)
    src = np.concatenate(all_src) if all_src else np.empty(0, np.int64)
    dst = np.concatenate(all_dst) if all_dst else np.empty(0, np.int64)
    mapped_src, out_nodes = _reindex_np(seeds, src)
    table = {int(v): i for i, v in enumerate(out_nodes)}
    mapped_dst = np.asarray([table[int(v)] for v in dst], np.int64)
    outs = (_out(mapped_src.reshape(-1, 1), row),
            _out(mapped_dst.reshape(-1, 1), row), _out(out_nodes, row),
            _out(np.arange(len(seeds), dtype=np.int64), row))
    if return_eids:
        es = np.concatenate(all_eids) if all_eids else np.empty(0, np.int64)
        return outs + (_out(es.reshape(-1, 1), row),)
    return outs
