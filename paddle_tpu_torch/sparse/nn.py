"""``paddle.sparse.nn`` (port of ``paddle_tpu/sparse/nn.py``): ``ReLU``,
``Softmax``, ``BatchNorm``, ``Conv3D``, ``SubmConv3D`` and ``MaxPool3D``
on ``NDHWC`` COO tensors (indices ``[4, nnz]``: batch, z, y, x).

A sparse convolution is a rulebook and a gather-GEMM-scatter, as in the
reference's CUDA kernels (``paddle/phi/kernels/sparse/gpu/convolution.cu``).
The rulebook lists, for each kernel offset (kz-major: ``kz, ky, kx``),
the pairs (input row, output row) it joins; the weight ``[kd, kh, kw,
Cin, Cout]`` is read as ``K = kd·kh·kw`` matrices in that order.  The JAX
package builds it in a Python loop over every site and offset on the
host; here :func:`build_rulebook` builds it on the indices' device, all
offsets at once, from flat int64 keys ``((b·D + z)·H + y)·W + x``:

- a submanifold output is its input's sites in their order; an input
  site's neighbour at an offset is found by ``searchsorted`` of its key
  in the sorted input keys and an equality check (a duplicate site
  resolves to its last copy, as the JAX dict does);
- a strided output is the sorted unique keys reachable from any input
  site (row-major, as the JAX ``sorted``), each candidate's row its rank
  among them.

Pairs keep the JAX order: offset by offset, input rows ascending.  One
host read a rulebook sizes it (the number of output sites and each
offset's pair count, one ``tolist`` of ``K + 1`` ints; :data:`HOST_READS`
counts them); nothing else leaves the device.  A rulebook is kept on the
input tensor's indices (``SparseCooTensor._plans``) and shared by every
tensor over the same indices, so a stack of submanifold layers on one
site set builds it once, as spconv's ``indice_key`` shares it.

The gather-GEMM-scatter is an ``autograd.Function`` (:func:`conv_forward`,
:func:`conv_backward`): every pair's input row gathered in one
``index_select``, each offset's slice multiplied by that offset's weight,
and the products added into the output rows in one ``index_add``
(atomics on CUDA, so the card's sums are within rounding of the CPU's,
not bitwise; the rulebooks are exact).

``BatchNorm`` keeps Paddle's momentum (``running = m·running + (1 −
m)·batch``, the biased variance), not ``torch.nn.BatchNorm1d``'s.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ..nn import initializer as init
from ..nn.layer_base import Layer
from .tensor import SparseCooTensor, SparseCsrTensor, compact, flat_keys, \
    unflat_keys

__all__ = ["ReLU", "Softmax", "BatchNorm", "Conv3D", "SubmConv3D",
           "MaxPool3D", "Rulebook", "build_rulebook", "HOST_READS"]

#: host reads made to size rulebooks (``"reads"``) and rulebooks built
#: (``"rulebooks"``); take differences
HOST_READS = {"reads": 0, "rulebooks": 0}


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


class Rulebook(NamedTuple):
    """A sparse convolution's plan: the output sites (``int64 [4, n_out]``)
    and spatial shape, and the pairs, offset by offset (``in_rows``,
    ``out_rows``: ``int64 [P]``; ``counts[k]`` pairs of offset ``k``, a
    host list)."""
    out_indices: torch.Tensor
    out_spatial: Tuple[int, int, int]
    in_rows: torch.Tensor
    out_rows: torch.Tensor
    counts: List[int]

    @property
    def n_out(self) -> int:
        return int(self.out_indices.shape[1])


def _offsets(kernel, device) -> torch.Tensor:
    """``int64 [K, 3]``: every kernel offset ``(kz, ky, kx)``, kz-major."""
    kd, kh, kw = kernel
    grid = torch.meshgrid(torch.arange(kd, device=device),
                          torch.arange(kh, device=device),
                          torch.arange(kw, device=device), indexing="ij")
    return torch.stack([g.reshape(-1) for g in grid], dim=1)


def _read_sizes(sizes: torch.Tensor) -> List[int]:
    """The one host read of a rulebook."""
    HOST_READS["reads"] += 1
    return sizes.tolist()


def build_rulebook(indices: torch.Tensor, spatial, kernel, stride, padding,
                   subm: bool) -> Rulebook:
    """The rulebook of a convolution (or pooling) window over ``indices``
    (``[4, nnz]``: batch, z, y, x) in a grid of ``spatial`` ``(D, H, W)``,
    on the indices' device; :class:`Rulebook`.  ``subm``: odd kernel,
    stride 1, the window centred whatever ``padding`` says."""
    kernel, stride, padding = _triple(kernel), _triple(stride), \
        _triple(padding)
    if subm:
        if any(k % 2 == 0 for k in kernel):
            raise ValueError("SubmConv3D requires odd kernel sizes")
        if stride != (1, 1, 1):
            raise ValueError("SubmConv3D requires stride 1 (the output "
                             "pattern equals the input pattern)")
        padding = tuple(k // 2 for k in kernel)
    dev = indices.device
    idx = indices.to(torch.int64)
    nnz = idx.shape[1]
    spatial = tuple(int(s) for s in spatial)
    if subm:
        out_spatial = spatial
    else:
        out_spatial = tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                            zip(spatial, padding, kernel, stride))
    offs = _offsets(kernel, dev)                                  # [K, 3]
    K = offs.shape[0]
    # each offset's output coordinates of each input site (Python ints for
    # the window: no host-to-device copy, which would wait for the stream)
    valid = torch.ones(K, nnz, dtype=torch.bool, device=dev)
    coords = [idx[:1].expand(K, nnz)]
    for a in range(3):
        t = idx[a + 1][None, :] + padding[a] - offs[:, a:a + 1]   # [K, nnz]
        o = torch.div(t, stride[a], rounding_mode="floor")
        valid &= (t >= 0) & (torch.remainder(t, stride[a]) == 0) & \
            (o < out_spatial[a])
        coords.append(o)
    grid = (0,) + out_spatial
    cand = flat_keys(torch.stack(coords), grid)                  # [K, nnz]
    if subm:
        keys, perm = torch.sort(flat_keys(idx, grid), stable=True)
        pos = torch.searchsorted(keys, cand.reshape(-1), right=True) - 1
        hit = keys[pos.clamp(min=0)] == cand.reshape(-1)
        found = valid.reshape(-1) & (pos >= 0) & hit
        row_of_cand = perm[pos.clamp(min=0)]
        sizes = _read_sizes(found.reshape(K, nnz).sum(dim=1))
        counts, out_indices = sizes, idx
    else:
        big = torch.iinfo(torch.int64).max
        flat = torch.where(valid, cand, torch.full_like(cand, big)
                           ).reshape(-1)
        found = valid.reshape(-1)
        skeys, perm = torch.sort(flat)
        first = skeys != big
        first[1:] &= skeys[1:] != skeys[:-1]
        rank = torch.cumsum(first.to(torch.int64), 0) - 1
        row_of_cand = torch.empty_like(rank).scatter_(0, perm, rank)
        sizes = _read_sizes(torch.cat([first.sum()[None],
                                       valid.sum(dim=1)]))
        n_out, counts = sizes[0], sizes[1:]
        out_keys = compact(first, n_out, skeys)
        out_indices = unflat_keys(out_keys, grid)
    total = sum(counts)
    rows = torch.arange(nnz, device=dev).expand(K, nnz).reshape(-1)
    HOST_READS["rulebooks"] += 1
    return Rulebook(out_indices, out_spatial, compact(found, total, rows),
                    compact(found, total, row_of_cand), list(counts))


def rulebook_of(x: SparseCooTensor, kernel, stride, padding,
                subm: bool) -> Rulebook:
    """``x``'s rulebook for this window, built once per indices object
    (kept in ``x._plans``, which tensors over the same indices share)."""
    if x.indices().shape[0] != 4:
        raise ValueError("sparse conv3d expects NDHWC layout with "
                         "indices [4, nnz] (batch, d, h, w)")
    kernel, stride, padding = _triple(kernel), _triple(stride), \
        _triple(padding)
    if subm:
        padding = None                 # the window is centred whatever
    spatial = tuple(x.shape[1:4])
    key = (spatial, kernel, stride, padding, subm)
    plan = x._plans.get(key)
    if plan is None:
        plan = x._plans[key] = build_rulebook(
            x.indices(), spatial, kernel, stride, padding or 0, subm)
    return plan


# -- gather-GEMM-scatter ------------------------------------------------------

def _spans(counts):
    start = 0
    for k, c in enumerate(counts):
        if c:
            yield k, start, start + c
        start += c


def conv_forward(values: torch.Tensor, weight: torch.Tensor,
                 rb: Rulebook) -> torch.Tensor:
    """``[n_out, Cout]``: every pair's input row gathered at once, each
    offset's slice of them multiplied by ``W[k]``, and all the products
    added into their output rows at once (offset by offset in order)."""
    wk = weight.reshape(-1, weight.shape[-2], weight.shape[-1])
    rows = values.index_select(0, rb.in_rows)
    prod = rows.new_empty(rows.shape[0], wk.shape[-1])
    for k, s, e in _spans(rb.counts):
        torch.mm(rows[s:e], wk[k], out=prod[s:e])
    out = values.new_zeros(rb.n_out, wk.shape[-1])
    return out.index_add_(0, rb.out_rows, prod)


def conv_backward(grad: torch.Tensor, values: torch.Tensor,
                  weight: torch.Tensor, rb: Rulebook, need_values=True):
    """The values' (None unless ``need_values``) and the weight's
    gradients of :func:`conv_forward`: the output rows' gradient gathered
    for every pair; per offset, ``values[in]ᵀ @ grad[out]`` into
    ``dW[k]`` and ``grad[out] @ W[k]ᵀ`` for the pairs' input rows, which
    are added into the values' gradient at once."""
    wk = weight.reshape(-1, weight.shape[-2], weight.shape[-1])
    go = grad.index_select(0, rb.out_rows)
    rows = values.index_select(0, rb.in_rows)
    g_rows = go.new_empty(go.shape[0], wk.shape[-2]) if need_values \
        else None
    g_w = torch.zeros_like(wk)
    for k, s, e in _spans(rb.counts):
        torch.mm(rows[s:e].t(), go[s:e], out=g_w[k])
        if need_values:
            torch.mm(go[s:e], wk[k].t(), out=g_rows[s:e])
    g_values = torch.zeros_like(values).index_add_(
        0, rb.in_rows, g_rows) if need_values else None
    return g_values, g_w.reshape(weight.shape)


class _GatherGemmScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, weight, rb):
        ctx.rb = rb
        ctx.save_for_backward(values, weight)
        return conv_forward(values, weight, rb)

    @staticmethod
    def backward(ctx, grad):
        values, weight = ctx.saved_tensors
        g_values, g_w = conv_backward(grad.contiguous(), values, weight,
                                      ctx.rb, ctx.needs_input_grad[0])
        return g_values, g_w, None


def _sparse_conv3d(x: SparseCooTensor, weight, bias, kernel, stride, padding,
                   subm: bool) -> SparseCooTensor:
    rb = rulebook_of(x, kernel, stride, padding, subm)
    vals = _GatherGemmScatter.apply(x.values(), weight, rb)
    if bias is not None:
        vals = vals + bias
    out_shape = (x.shape[0],) + rb.out_spatial + (int(weight.shape[-1]),)
    if subm:
        return x._replace_values(vals, out_shape)
    return SparseCooTensor(rb.out_indices, vals, out_shape, coalesced=True)


def _sparse_maxpool3d(x: SparseCooTensor, kernel, stride,
                      padding) -> SparseCooTensor:
    rb = rulebook_of(x, kernel, stride, padding, subm=False)
    v = x.values()
    src = v.index_select(0, rb.in_rows)
    out = v.new_full((rb.n_out, v.shape[-1]), float("-inf"))
    out = out.scatter_reduce(0, rb.out_rows[:, None].expand_as(src), src,
                             "amax", include_self=True)
    out_shape = (x.shape[0],) + rb.out_spatial + (x.shape[-1],)
    return SparseCooTensor(rb.out_indices, out, out_shape, coalesced=True)


# -- layers -------------------------------------------------------------------

class ReLU(Layer):
    def forward(self, x):
        from . import relu

        return relu(x)


class Softmax(Layer):
    """Row-wise softmax over a CSR tensor's stored entries (``axis=-1``
    only)."""

    def __init__(self, axis=-1, name=None):
        super().__init__()
        if axis != -1:
            raise ValueError("sparse Softmax supports axis=-1")

    def forward(self, x):
        if not isinstance(x, SparseCsrTensor):
            raise TypeError("sparse Softmax expects a SparseCsrTensor")
        rows = x._row_ids()
        v = x.values()
        M = x.shape[0]
        rmax = v.new_full((M,), float("-inf")).scatter_reduce(
            0, rows, v, "amax", include_self=True)
        e = torch.exp(v - rmax[rows])
        rsum = v.new_zeros(M).index_add(0, rows, e)
        return x._replace_values(e / rsum[rows])


class BatchNorm(Layer):
    """Per-channel batch norm over the active sites; Paddle's ``momentum``
    (the running statistics' share kept), the biased batch variance.
    Parameters and buffers on ``device`` (the port's current device for
    None)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NDHWC",
                 name=None, *, device=None):
        super().__init__()
        if data_format != "NDHWC":
            raise ValueError("sparse BatchNorm supports NDHWC")
        self._momentum = momentum
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=init.Constant(1.0), device=device)
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True,
            default_initializer=init.Constant(0.0), device=device)
        dev = self.weight.device
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        v = x.values()
        eps = self._epsilon
        if self.training:
            mean = v.mean(dim=0)
            var = v.var(dim=0, unbiased=False)
            with torch.no_grad():
                mom = self._momentum
                self._mean.mul_(mom).add_(mean.detach(), alpha=1 - mom)
                self._variance.mul_(mom).add_(var.detach(), alpha=1 - mom)
        else:
            mean, var = self._mean, self._variance
        out = (v - mean) * torch.rsqrt(var + eps) * self.weight + self.bias
        return x._replace_values(out)


class _Conv3D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, subm=False,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NDHWC", *, device=None):
        super().__init__()
        if data_format != "NDHWC":
            raise ValueError("sparse conv supports NDHWC")
        if groups != 1 or _triple(dilation) != (1, 1, 1):
            raise ValueError("sparse conv supports groups=1, dilation=1")
        self._kernel = _triple(kernel_size)
        self._stride = _triple(stride)
        self._padding = _triple(padding)
        self._subm = subm
        kd, kh, kw = self._kernel
        std = (2.0 / (in_channels * kd * kh * kw)) ** 0.5
        self.weight = self.create_parameter(
            [kd, kh, kw, in_channels, out_channels], attr=weight_attr,
            default_initializer=init.Normal(0.0, std), device=device)
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=init.Constant(0.0), device=device)

    def forward(self, x):
        return _sparse_conv3d(x, self.weight, self.bias, self._kernel,
                              self._stride, self._padding, self._subm)


class Conv3D(_Conv3D):
    """Sparse 3-D convolution: the output sites are every position the
    kernel reaches from an input site, sorted row-major."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NDHWC", *,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, False, padding_mode,
                         weight_attr, bias_attr, data_format, device=device)


class SubmConv3D(_Conv3D):
    """Submanifold sparse convolution: the output sites are the input's,
    in its order, so deep stacks do not dilate the active set."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NDHWC", *,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, True, padding_mode,
                         weight_attr, bias_attr, data_format, device=device)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 ceil_mode=False, return_mask=False, data_format="NDHWC",
                 name=None):
        super().__init__()
        if data_format != "NDHWC":
            raise ValueError("sparse MaxPool3D supports NDHWC")
        if return_mask:
            raise NotImplementedError(
                "sparse MaxPool3D return_mask is not supported")
        if ceil_mode:
            raise NotImplementedError(
                "sparse MaxPool3D ceil_mode is not supported")
        self._kernel = _triple(kernel_size)
        self._stride = _triple(stride if stride is not None
                               else kernel_size)
        self._padding = _triple(padding)

    def forward(self, x):
        return _sparse_maxpool3d(x, self._kernel, self._stride,
                                 self._padding)
