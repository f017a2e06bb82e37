"""Shape, layout, gather and scatter ops (port of
``paddle_tpu/ops/manipulation.py``).

Paddle's meanings hold where torch's differ: ``reshape`` keeps a dim
given as 0, ``expand`` keeps one given as -1, ``split`` takes a section
count or sizes with one -1, ``gather`` is an index-select along an axis
(not ``torch.gather``), ``scatter`` with ``overwrite=False`` zeroes the
target rows and then sums duplicates, ``pad`` reads Paddle's pad order
and ``data_format`` (``nn.functional.pad``, the port's one
implementation).  ``unique``, ``unique_consecutive`` and
``masked_select`` have data-dependent shapes: they read the device on
the host, and inside a CUDA graph capture they raise ``CaptureError``.
The in-place variants (``reshape_``, ``squeeze_``, ``scatter_``, ...)
write ``x`` itself, as torch's in-place ops do.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ._helpers import as_int_list, as_tensor, check_host_read, \
    convert_dtype, device_of, paddle_reshape_shape
from ._helpers import wrap_public

__all__ = [
    "cast", "astype", "reshape", "reshape_", "flatten", "transpose", "t",
    "clone_like", "moveaxis", "swapaxes", "squeeze", "unsqueeze", "squeeze_",
    "unsqueeze_", "concat", "stack", "vstack", "hstack", "dstack", "split",
    "chunk", "unbind", "tile", "expand", "expand_as", "broadcast_to",
    "broadcast_tensors", "flip", "rot90", "roll", "gather", "gather_nd",
    "take_along_axis", "put_along_axis", "scatter", "scatter_",
    "scatter_nd_add", "scatter_nd", "index_select", "index_sample",
    "index_add", "masked_select", "masked_fill", "pad", "unique",
    "unique_consecutive", "repeat_interleave", "as_real", "as_complex",
    "numel", "shape", "shard_index", "one_hot", "tensordot", "crop",
]


def _int(v) -> int:
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _index(index) -> torch.Tensor:
    """An index tensor torch's indexing takes (int64)."""
    return index.long() if isinstance(index, torch.Tensor) else \
        torch.as_tensor(np.asarray(index), dtype=torch.int64)


def cast(x, dtype):
    return x.to(convert_dtype(dtype))


def astype(x, dtype):
    return cast(x, dtype)


def reshape(x, shape, name=None):
    """Paddle's reshape: a 0 keeps the dim, a -1 is inferred."""
    return x.reshape(paddle_reshape_shape(list(x.shape), shape))


def _contiguous_strides(shape) -> List[int]:
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    return strides[::-1]


def reshape_(x, shape, name=None):
    """:func:`reshape` of ``x`` itself (a contiguous ``x``)."""
    out_shape = list(reshape(x, shape).shape)
    if not x.is_contiguous():
        raise ValueError("reshape_: x is not contiguous; use reshape")
    return x.as_strided_(out_shape, _contiguous_strides(out_shape))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def transpose(x, perm, name=None):
    return x.permute(as_int_list(perm))


def t(x, name=None):
    """The last two axes swapped; a copy of a 0-d or 1-d tensor."""
    if x.dim() <= 1:
        return x.clone()
    return x.transpose(-2, -1)


def clone_like(x):
    return x.clone()


def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(x, axis0, axis1)


def _squeezed_shape(x, axis) -> List[int]:
    if axis is None:
        return [s for s in x.shape if s != 1]
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = {a % x.dim() for a in as_int_list(axes)} if x.dim() else set()
    return [s for d, s in enumerate(x.shape) if not (d in axes and s == 1)]


def squeeze(x, axis=None, name=None):
    """Drop ``axis`` (an int or a list; every size-1 axis for None) where
    its size is 1; an axis of another size stays."""
    return x.reshape(_squeezed_shape(x, axis))


def unsqueeze(x, axis, name=None):
    axes = as_int_list(axis if isinstance(axis, (list, tuple)) else [axis])
    for ax in sorted(axes):
        x = x.unsqueeze(ax)
    return x


def squeeze_(x, axis=None, name=None):
    return reshape_(x, _squeezed_shape(x, axis))


def unsqueeze_(x, axis, name=None):
    return reshape_(x, list(unsqueeze(x, axis).shape))


def concat(x, axis=0, name=None):
    return torch.cat(list(x), dim=_int(axis))


def stack(x, axis=0, name=None):
    return torch.stack(list(x), dim=axis)


def vstack(x, name=None):
    return torch.vstack(list(x))


def hstack(x, name=None):
    return torch.hstack(list(x))


def dstack(x, name=None):
    return torch.dstack(list(x))


def split(x, num_or_sections, axis=0, name=None):
    """A list of pieces along ``axis``: ``num_or_sections`` equal ones (the
    size must divide), or pieces of the listed sizes (one may be -1)."""
    axis = _int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        n = num_or_sections
        if dim % n != 0:
            raise ValueError(f"split: axis dim {dim} is not divisible by "
                             f"num {n}")
        sizes = [dim // n] * n
    else:
        sizes = as_int_list(num_or_sections)
        if -1 in sizes:
            known = sum(s for s in sizes if s != -1)
            sizes = [dim - known if s == -1 else s for s in sizes]
    return list(torch.split(x, sizes, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return list(torch.unbind(x, axis))


def tile(x, repeat_times, name=None):
    return torch.tile(x, as_int_list(repeat_times))


def expand(x, shape, name=None):
    """Broadcast to ``shape``; a -1 keeps the input's dim there."""
    tgt = as_int_list(shape)
    off = len(tgt) - x.dim()
    full = [(x.shape[i - off] if i >= off else 1) if s == -1 else s
            for i, s in enumerate(tgt)]
    return x.expand(full)


def expand_as(x, y, name=None):
    return x.expand(y.shape)


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(x, as_int_list(shape))


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


def flip(x, axis, name=None):
    return torch.flip(x, as_int_list(axis if isinstance(axis, (list, tuple))
                                     else [axis]))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, k, list(axes))


def roll(x, shifts, axis=None, name=None):
    return torch.roll(x, shifts, axis)


# ---- gather / scatter -----------------------------------------------------------

def _wrap(index, n: int) -> torch.Tensor:
    """Negative indices count from the end (as ``jnp.take``)."""
    index = _index(index)
    return torch.where(index < 0, index + n, index)


def index_select(x, index, axis=0, name=None):
    """``x``'s entries at ``index`` along ``axis`` (an index of any rank
    puts its shape there)."""
    axis = _int(axis) % x.dim()
    index = _wrap(index, x.shape[axis]).to(x.device)
    out = torch.index_select(x, axis, index.reshape(-1))
    return out.reshape(list(x.shape[:axis]) + list(index.shape)
                       + list(x.shape[axis + 1:]))


def gather(x, index, axis=0, name=None):
    """Paddle's gather: :func:`index_select` along ``axis``, a
    multi-dimensional index taken flattened."""
    if isinstance(index, torch.Tensor) and index.dim() > 1:
        index = index.reshape(-1)
    return index_select(x, index, axis)


def gather_nd(x, index, name=None):
    """``x[index[..., 0], index[..., 1], ...]``."""
    index = _index(index).to(x.device)
    return x[tuple(index.unbind(-1))]


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return torch.take_along_dim(arr, _index(indices).to(arr.device), axis)


def _last_wins(arr, axis: int, index, v):
    """``arr`` with ``v`` assigned at ``index`` along ``axis`` where, of
    the writes that land on one element, the last along ``axis`` wins on
    every device (as a sequential scatter, the JAX package's on the CPU;
    torch's ``scatter`` leaves duplicates to the order of its threads)."""
    sub = tuple(slice(0, n) if d != axis else slice(None)
                for d, n in enumerate(index.shape))
    target = arr[sub]
    pos = torch.arange(index.shape[axis], device=arr.device).reshape(
        [-1 if d == axis else 1 for d in range(arr.dim())]).expand(
        index.shape)
    win = torch.full(target.shape, -1, dtype=torch.int64,
                     device=arr.device).scatter_reduce(
        axis, index, pos, "amax")
    taken = torch.take_along_dim(v, win.clamp(min=0), axis)
    out = arr.clone()
    out[sub] = torch.where(win >= 0, taken, target)
    return out


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    """``arr`` with ``values`` (broadcast to ``indices``' shape) put at
    ``indices`` along ``axis``: assigned (the last of duplicate writes
    wins), added (``"add"``) or multiplied (``"mul"``)."""
    index = _index(indices).to(arr.device)
    v = torch.broadcast_to(as_tensor(values, arr).to(arr.dtype), index.shape)
    axis = axis % arr.dim()
    if reduce == "assign":
        return _last_wins(arr, axis, index, v)
    if reduce in ("add", "sum"):
        return arr.scatter_add(axis, index, v)
    if reduce in ("mul", "multiply"):
        return arr.scatter_reduce(axis, index, v, "prod")
    raise ValueError(reduce)


def _rows(index, like) -> torch.Tensor:
    return _index(index).to(like.device).reshape(-1)


def scatter(x, index, updates, overwrite=True, name=None):
    """``x`` with rows ``index`` set to ``updates`` (the last of duplicate
    rows wins); with ``overwrite`` False the target rows are zeroed first
    and the updates summed."""
    idx = _rows(index, x)
    if overwrite:
        win = torch.full((x.shape[0],), -1, dtype=torch.int64,
                         device=x.device).scatter_reduce(
            0, idx, torch.arange(idx.numel(), device=x.device), "amax")
        rows = updates.index_select(0, win.clamp(min=0))
        keep = (win >= 0).reshape([-1] + [1] * (x.dim() - 1))
        return torch.where(keep, rows.to(x.dtype), x)
    zeroed = x.index_put((idx,), torch.zeros_like(updates))
    return zeroed.index_put((idx,), updates, accumulate=True)


def scatter_(x, index, updates, overwrite=True, name=None):
    """:func:`scatter` written into ``x``."""
    return x.copy_(scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    index = _index(index).to(x.device)
    return x.index_put(tuple(index.unbind(-1)), updates, accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    z = torch.zeros(as_int_list(shape), dtype=updates.dtype,
                    device=updates.device)
    return scatter_nd_add(z, index, updates)


def index_sample(x, index, name=None):
    return torch.take_along_dim(x, _index(index).to(x.device), 1)


def index_add(x, index, axis, value, name=None):
    return x.index_add(axis, _wrap(index, x.shape[axis]).to(x.device)
                       .reshape(-1), value)


def masked_select(x, mask, name=None):
    check_host_read("masked_select", x, mask)
    return torch.masked_select(x, mask.bool())


def masked_fill(x, mask, value, name=None):
    return torch.where(mask.bool(), as_tensor(value, x).to(x.dtype), x)


# ---- pads, uniques and the rest -----------------------------------------------

def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    from ..nn.functional import common

    return common.pad(x, pad, mode=mode, value=value,
                      data_format=data_format)


def _first_index(inverse, n_unique: int, length: int) -> torch.Tensor:
    pos = torch.arange(length, device=inverse.device)
    first = torch.full((n_unique,), length, dtype=torch.int64,
                       device=inverse.device)
    return first.scatter_reduce(0, inverse, pos, "amin")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted unique values (``np.unique``), and with the flags the
    first index of each, the inverse and the counts, in that order."""
    check_host_read("unique", x)
    flat = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    if not (return_index or return_inverse or return_counts):
        return vals
    outs = [vals]
    if return_index:
        length = flat.shape[0 if axis is None else axis]
        outs.append(_first_index(inv.reshape(-1), vals.shape[
            0 if axis is None else axis], length))
    if return_inverse:
        outs.append(inv)
    if return_counts:
        outs.append(counts)
    return tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, name=None):
    check_host_read("unique_consecutive", x)
    flat = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique_consecutive(
        flat, return_inverse=True, return_counts=True, dim=axis)
    outs = [vals]
    if return_inverse:
        outs.append(inv)
    if return_counts:
        outs.append(counts)
    return outs[0] if len(outs) == 1 else tuple(outs)


def repeat_interleave(x, repeats, axis=None, name=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def as_real(x, name=None):
    return torch.stack([x.real, x.imag], dim=-1)


def as_complex(x, name=None):
    if x.shape[-1] != 2:
        raise ValueError("as_complex needs a trailing axis of size 2")
    return torch.complex(x[..., 0], x[..., 1])


def numel(x, name=None):
    """The element count as a 0-d int64 tensor on ``x``'s device."""
    return torch.full((), x.numel(), dtype=torch.int64, device=x.device)


def shape(x):
    """``x``'s shape as a 1-D int64 tensor on its device."""
    return torch.tensor(list(x.shape), dtype=torch.int64,
                        device=device_of(x))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    in_range = (input >= lo) & (input < lo + shard_size)
    return torch.where(in_range, input - lo,
                       torch.full_like(input, ignore_value))


def one_hot(x, num_classes, name=None):
    from ..nn.functional import common

    return common.one_hot(x, num_classes)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, torch.Tensor):
        axes = int(axes.item())
    return torch.tensordot(x, y, dims=axes)


def crop(x, shape=None, offsets=None, name=None):
    """The block of ``shape`` at ``offsets`` (a -1 in ``shape`` runs to
    the end; an offset is clamped so the block fits, as
    ``lax.dynamic_slice``)."""
    tgt = as_int_list(shape)
    offs = as_int_list(offsets) if offsets is not None else [0] * len(tgt)
    tgt = [s if s != -1 else x.shape[i] - offs[i] for i, s in enumerate(tgt)]
    for d, (o, s) in enumerate(zip(offs, tgt)):
        o = max(0, min(o, x.shape[d] - s))
        x = x.narrow(d, o, s)
    return x


wrap_public(globals())
