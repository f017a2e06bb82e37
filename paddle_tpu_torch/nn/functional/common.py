"""Common functionals: linear, the dropout family, embedding, pad,
interpolate, unfold/fold, ...

Port of ``paddle_tpu/nn/functional/common.py``.  Paddle's conventions are
kept where they differ from torch's: :func:`linear` takes a weight in
Paddle's ``[in, out]`` layout (``x @ W + b``; the ``nn.Linear`` layer
keeps torch's ``[out, in]`` and calls torch's ``linear``), :func:`pad`
reads a full-rank list from the first dim, and :func:`interpolate` is
``jax.image.resize`` (half-pixel centres, antialiased when it shrinks;
``align_corners`` is not read, as in the JAX package).

The dropout family draws its masks from the device's dropout generator
(:mod:`...rng`, Philox) in plain tensor ops, as the JAX package draws
with ``jax.random`` in XLA ops: no kernel.  The bits differ from the JAX
package's; the law, the scale and the ``p == 0``, ``p == 1`` and
``training=False`` branches are the same.  Every draw is device ops, so a
step captured as a CUDA graph draws new masks at each replay.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch.nn import functional as TF

from ... import rng as rng_mod
from ...amp.auto_cast import amp_op
from ...ops._helpers import wrap_public

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "embedding", "one_hot", "pad", "zeropad2d", "cosine_similarity",
    "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "interpolate",
    "upsample", "unfold", "fold", "label_smooth", "class_center_sample",
    "temporal_shift", "npair_loss",
]

_MODES = ("upscale_in_train", "downscale_in_infer")
_CHANNEL_LAST = ("NHWC", "NWC", "NDHWC", "NLC")


def _ntuple(v, n: int) -> tuple:
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        raise ValueError(f"expected {n} values, got {v}")
    return tuple(int(v) for _ in range(n))


@amp_op("linear")
def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def dropout(x: torch.Tensor, p: float = 0.5,
            axis: Union[None, int, Sequence[int]] = None,
            training: bool = True, mode: str = "upscale_in_train",
            name=None, generator: Optional[rng_mod.Generator] = None
            ) -> torch.Tensor:
    """Zero each element of ``x`` with probability ``p``.

    ``upscale_in_train`` divides what is kept by ``1 - p`` in training and
    returns ``x`` itself otherwise; ``downscale_in_infer`` keeps the kept
    values as they are in training and multiplies by ``1 - p`` otherwise.
    ``axis`` draws one keep bit for every index along those dims, shared
    over the others.  ``p == 0`` (or ``training=False`` under
    ``upscale_in_train``) returns ``x``; ``p == 1`` returns zeros.  One
    draw from ``generator`` (the default: ``x``'s device's) per call."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    rng_mod.keep_threshold(p)          # checks 0 <= p <= 1
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = {a % x.dim() for a in ([axis] if isinstance(axis, int)
                                      else axis)}
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    return _dropout(x, p, shape, mode == "upscale_in_train", generator)


@amp_op("dropout")
def _dropout(x, p, shape, upscale: bool, generator):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if p == 1.0:
        return torch.where(torch.zeros((), dtype=torch.bool,
                                       device=x.device), x, zero)
    gen = generator or rng_mod.default_generator(x.device)
    out = torch.where(rng_mod.dropout_keep(gen.draw(), shape, p), x, zero)
    return out / (1.0 - p) if upscale else out


def _dropout_nd(x, p, training, data_format, nd):
    """One keep bit per (sample, channel), scaled by ``1 / (1 - p)``."""
    if not training or p == 0.0:
        return x
    shape = list(x.shape)
    if data_format in _CHANNEL_LAST:
        mask = shape[:1] + [1] * nd + shape[-1:]
    else:
        mask = shape[:2] + [1] * nd
    return _dropout(x, p, mask, True, None)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    return _dropout_nd(x, p, training, data_format, 2)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    return _dropout_nd(x, p, training, data_format, 3)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped elements take ``-alpha * scale``,
    then the affine map that keeps mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = rng_mod.dropout_keep(
        rng_mod.default_generator(x.device).draw(), list(x.shape), p)
    a = (1.0 - p + p * alpha_p ** 2 * (1.0 - p)) ** -0.5
    b = -a * p * alpha_p
    fill = torch.full((), alpha_p, dtype=x.dtype, device=x.device)
    return a * torch.where(keep, x, fill) + b


@amp_op("embedding")
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight``; positions whose id is ``padding_idx`` give zeros
    and send no gradient to that row (the JAX package masks the row)."""
    if padding_idx is None:
        return TF.embedding(x, weight)
    pidx = padding_idx if padding_idx >= 0 else weight.shape[0] + padding_idx
    out = TF.embedding(x, weight, padding_idx=pidx)
    return out.masked_fill((x == pidx).unsqueeze(-1), 0.0)


def one_hot(x, num_classes, name=None):
    return TF.one_hot(x.long(), num_classes).to(torch.float32)


def _pad_pairs(nd: int, pad_list, data_format: str):
    """``[(before, after)]`` per dim: a list of ``2 * nd`` numbers is
    read from the first dim; a shorter one holds the spatial dims'
    pairs, innermost first."""
    if len(pad_list) == 2 * nd:
        return [(pad_list[2 * i], pad_list[2 * i + 1]) for i in range(nd)]
    pairs = [(0, 0)] * nd
    spatial = list(range(1, nd - 1)) if data_format in _CHANNEL_LAST \
        else list(range(2, nd))
    for i in range(len(pad_list) // 2):
        pairs[spatial[len(spatial) - 1 - i]] = (pad_list[2 * i],
                                                pad_list[2 * i + 1])
    return pairs


def _pad_index(n: int, lo: int, hi: int, mode: str, device):
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    period = 2 * (n - 1)                          # reflect: no edge repeat
    i = i % period
    return torch.where(i >= n, period - i, i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Pad ``x`` (``mode``: constant, reflect, replicate or circular)."""
    if isinstance(pad, torch.Tensor):
        pad = pad.tolist()
    pad_list = [int(v) for v in (pad if isinstance(pad, (list, tuple))
                                 else [pad])]
    pairs = _pad_pairs(x.dim(), pad_list, data_format)
    if mode == "constant":
        flat = [v for lo_hi in reversed(pairs) for v in lo_hi]
        return TF.pad(x, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"pad mode {mode!r}")
    for d, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, mode,
                                             x.device))
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    """``sum(x1 x2) / max(|x1| |x2|, eps)`` along ``axis``."""
    dot = (x1 * x2).sum(dim=axis)
    na = torch.linalg.vector_norm(x1, dim=axis)
    nb = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp(na * nb, min=eps)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        return TF.pixel_shuffle(x, r)
    n, h, w, c = x.shape
    out = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        return TF.pixel_unshuffle(x, r)
    n, h, w, c = x.shape
    out = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
        .reshape(n, h, w, c)


def _linear_kernel(d):
    return torch.clamp(1.0 - d, min=0.0)


def _cubic_kernel(d):                      # Keys, a = -0.5
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = torch.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return torch.where(d >= 2.0, torch.zeros_like(d), out)


def _resize_weights(n_in: int, n_out: int, kernel, device) -> torch.Tensor:
    """``[n_out, n_in]`` f32 weights of ``jax.image.scale_and_translate``
    with scale ``n_out / n_in`` (the kernel widened by ``n_in / n_out``
    when it shrinks: antialiasing)."""
    inv = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv - 0.5
    width = max(inv, 1.0)
    dist = (sample[:, None] - torch.arange(n_in, dtype=torch.float64)
            [None, :]).abs() / width
    w = kernel(dist)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w)) \
        .to(torch.float32).to(device)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims as ``jax.image.resize`` does: ``nearest``
    takes ``floor((i + 0.5) * in / out)``; ``linear``/``bilinear``/
    ``trilinear``/``area`` (triangle) and ``bicubic`` (Keys) weight the
    inputs around half-pixel centres, the kernel widened when a dim
    shrinks."""
    channel_last = data_format in _CHANNEL_LAST
    nd = x.dim() - 2
    spatial_axes = list(range(1, 1 + nd)) if channel_last \
        else list(range(2, 2 + nd))
    spatial = [x.shape[a] for a in spatial_axes]
    if size is not None:
        out = [int(s) for s in (size if isinstance(size, (list, tuple))
                                else [size])]
        if len(out) == 1 and nd > 1:
            out = out * nd
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * nd
        out = [int(s * f) for s, f in zip(spatial, sf)]
    for ax, n_in, n_out in zip(spatial_axes, spatial, out):
        if n_in == n_out:
            continue
        if mode == "nearest":
            idx = torch.floor((torch.arange(n_out, dtype=torch.float32)
                               + 0.5) * n_in / n_out).long().to(x.device)
            x = x.index_select(ax, idx)
            continue
        kernel = _cubic_kernel if mode == "bicubic" else _linear_kernel
        w = _resize_weights(n_in, n_out, kernel, x.device)
        x = torch.movedim(torch.tensordot(x.float(), w, dims=([ax], [1])),
                          -1, ax).to(x.dtype)
    return x


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _unfold_pads(paddings):
    if isinstance(paddings, (list, tuple)) and len(paddings) == 4:
        top, left, bottom, right = (int(v) for v in paddings)
        return top, bottom, left, right
    ph, pw = _ntuple(paddings, 2)
    return ph, ph, pw, pw


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C*kh*kw, L]`` (``paddings`` as 1, 2 or 4 numbers,
    the 4 as top, left, bottom, right)."""
    top, bottom, left, right = _unfold_pads(paddings)
    if (top, left) != (bottom, right):
        x = TF.pad(x, [left, right, top, bottom])
        top = left = 0
    return TF.unfold(x, _ntuple(kernel_sizes, 2), _ntuple(dilations, 2),
                     (top, left), _ntuple(strides, 2))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of :func:`unfold`."""
    return TF.fold(x, _ntuple(output_sizes, 2), _ntuple(kernel_sizes, 2),
                   _ntuple(dilations, 2), _ntuple(paddings, 2),
                   _ntuple(strides, 2))


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC's sampled class centres: every positive class, then
    negatives from ``numpy.random.default_rng(0)`` up to ``num_samples``;
    returns the labels remapped into the sorted sample and the sample
    (int64, on the label's device)."""
    lab = label.detach().cpu().numpy().reshape(-1)
    pos = np.unique(lab)
    n_extra = max(0, num_samples - len(pos))
    neg_pool = np.setdiff1d(np.arange(num_classes), pos)
    rs = np.random.default_rng(0)
    extra = rs.choice(neg_pool, size=min(n_extra, len(neg_pool)),
                      replace=False)
    sampled = np.sort(np.concatenate([pos, extra]))
    remap = {c: i for i, c in enumerate(sampled)}
    remapped = np.array([remap[c] for c in lab], dtype=np.int64)
    return (torch.from_numpy(remapped).to(label.device),
            torch.from_numpy(sampled.astype(np.int64)).to(label.device))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    r = x.reshape(nt // seg_num, seg_num, c, h, w)
    fc = int(c * shift_ratio)
    left = torch.cat([r[:, 1:, :fc], torch.zeros_like(r[:, :1, :fc])], 1)
    right = torch.cat([torch.zeros_like(r[:, :1, fc:2 * fc]),
                       r[:, :-1, fc:2 * fc]], 1)
    out = torch.cat([left, right, r[:, :, 2 * fc:]], 2).reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.T
    lbl = labels.reshape(-1)
    target = (lbl[:, None] == lbl[None, :]).to(sim.dtype)
    target = target / target.sum(dim=1, keepdim=True)
    ce = -(target * torch.log_softmax(sim, dim=1)).sum(dim=1).mean()
    reg = l2_reg * (anchor.square().sum(dim=1).mean()
                    + positive.square().sum(dim=1).mean()) / 2
    return ce + reg


wrap_public(globals())
