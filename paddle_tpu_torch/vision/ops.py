"""``paddle.vision.ops`` (port of ``paddle_tpu/vision/ops.py``): the
detection operators ``roi_align``, ``roi_pool``, ``psroi_pool``, ``nms``,
``deform_conv2d``, ``yolo_box`` and ``yolo_loss``, their layers, and
``ConvNormActivation``, ``read_file`` and ``decode_jpeg``.

Plain functions on ``torch.Tensor`` with autograd, on the inputs' device.
The JAX package computes each in ``jnp`` (no Pallas kernel), and so does
the port in torch ops; each op keeps the JAX op's arithmetic and results.

The RoI ops read straight from the ``[N, C, H, W]`` map with each RoI's
image index, never a copy of the map per RoI: ``roi_align`` and
``psroi_pool`` a window of ``L_h x L_w`` rows and columns that holds every
pixel the RoI's bins touch, ``roi_pool`` each bin's rows and columns (the
sizes from one host read of the boxes; in a CUDA graph capture the whole
map's).  ``roi_align`` weighs the window with two separable
interpolation matrices (rows ``[R, ph, L_h]``, columns ``[R, pw, L_w]``)
whose entries are the JAX op's bilinear weights of the samples of each bin
over their count; ``sampling_ratio <= 0`` gives each RoI its own
``ceil(bin)`` samples a bin, the grid sized from the largest box read on
the host (the feature-map bound in a capture), as in the JAX package.

``nms`` builds the IoU matrix and the category mask on the device and
sweeps the greedy pass over one host copy of the ``[n, n]`` suppression
mask, as the JAX op's host pull of its kept indices allows; its indices are
int64, and inside a capture it raises ``jit.CaptureError`` (its output's
length depends on the data).  ``yolo_loss``'s targets are built from the
ground truth without a gradient (Paddle's op has none for it); its
gradient with respect to ``x`` is the JAX op's.
"""
from __future__ import annotations

import io
import math

import numpy as np
import torch

from .. import nn
from ..device import current_device
from ..nn import initializer as init
from ..ops._helpers import check_host_read
from .image import hwc_to_chw_tensor

__all__ = [
    'yolo_loss', 'yolo_box', 'deform_conv2d', 'DeformConv2D',
    'roi_align', 'RoIAlign', 'roi_pool', 'RoIPool', 'psroi_pool',
    'PSRoIPool', 'nms', 'ConvNormActivation', 'read_file',
    'decode_jpeg',
]


# ---------------------------------------------------------------- helpers
def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v), int(v))


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _batch_index(boxes_num, n_boxes: int, device) -> torch.Tensor:
    """Each RoI's image index, ``[R]`` int64 on ``device``, from the RoIs
    per image (a list, array or tensor; the RoIs of image 0 first).  The
    counts must sum to ``n_boxes`` (checked outside a capture)."""
    if isinstance(boxes_num, torch.Tensor):
        counts = boxes_num.reshape(-1).to(device=device, dtype=torch.long)
        if not _capturing(counts) and int(counts.sum()) != n_boxes:
            raise ValueError(f"boxes_num sums to {int(counts.sum())}, but "
                             f"there are {n_boxes} boxes")
        return torch.repeat_interleave(
            torch.arange(counts.numel(), device=device), counts,
            output_size=n_boxes)
    counts = np.asarray(boxes_num, np.int64).reshape(-1)
    if counts.sum() != n_boxes:
        raise ValueError(f"boxes_num sums to {counts.sum()}, but there are "
                         f"{n_boxes} boxes")
    return torch.cat([torch.full((int(c),), i, dtype=torch.long,
                                 device=device)
                      for i, c in enumerate(counts)] or
                     [torch.zeros(0, dtype=torch.long, device=device)])


def _const(values, device) -> torch.Tensor:
    """A small float32 vector of Python numbers made on ``device`` by
    fills (no host-to-device copy, so it may be made inside a CUDA graph
    capture)."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                   device=device) for v in values])


def _host_boxes(boxes: torch.Tensor):
    """The boxes as a float64 numpy array (one host read), or None inside
    a CUDA graph capture."""
    if _capturing(boxes):
        return None
    return boxes.detach().to("cpu", torch.float64).numpy()


def _div(a: torch.Tensor, n) -> torch.Tensor:
    """``a / n`` correctly rounded on every device: torch's CUDA kernel
    multiplies by the reciprocal of a Python number, which can move a
    bin's floor or ceil by one (found on the card at the phase's shapes:
    21 of roi_pool's 43,008 row ranges)."""
    return a / torch.full((), float(n), dtype=torch.float32,
                          device=a.device)


def _window_start(lo: torch.Tensor, size: int, length: int) -> torch.Tensor:
    """The first row (or column) of each RoI's window: ``lo`` (an integer
    valued tensor) kept inside ``[0, size - length]``."""
    return lo.clamp(0, size - length).long()


def _pixels(x: torch.Tensor, bidx, rows, cols) -> torch.Tensor:
    """``x`` ``[N, C, H, W]`` at image ``bidx``, row ``rows`` and column
    ``cols`` (broadcast together), channels last: ``[*shape, C]``.  One
    ``index_select`` of channels-last rows, whose gradient is one
    ``index_add`` (an indexing gather's accumulating ``index_put`` runs
    one element at a time on the CPU)."""
    N, C, H, W = x.shape
    flat = (bidx * H + rows) * W + cols
    pix = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    return pix.index_select(0, flat.reshape(-1)).reshape(*flat.shape, C)


def _windows(x: torch.Tensor, bidx, y0, x0, lh: int, lw: int):
    """``[R, lh, lw, C]``: rows ``y0 + k`` and columns ``x0 + k`` of each
    RoI's image, channels last."""
    dev = x.device
    rows = y0[:, None] + torch.arange(lh, device=dev)
    cols = x0[:, None] + torch.arange(lw, device=dev)
    return _pixels(x, bidx[:, None, None], rows[:, :, None],
                   cols[:, None, :])


def _interp(start, bin_size, n, n_bins: int, grid: int, size: int,
            w0, length: int) -> torch.Tensor:
    """``[R, n_bins, length]``: the weight of each window row in each bin,
    the bilinear weights of the bin's first ``n`` of ``grid`` samples
    (zero outside ``[0, size)``) over ``n``."""
    dev = start.device
    i = torch.arange(grid, device=dev, dtype=torch.float32)
    sub = (i + 0.5)[None, :] / n[:, None]                       # [R, grid]
    g = torch.arange(n_bins, device=dev)[None, :, None] + sub[:, None, :]
    s = start[:, None, None] + g * bin_size[:, None, None]  # [R, bins, grid]
    live = (i[None, None, :] < n[:, None, None]).to(s.dtype) \
        / n[:, None, None]
    f = torch.floor(s)
    frac = s - f
    idx, wts = [], []
    for d, w in ((0, 1 - frac), (1, frac)):
        k = f.long() + d
        valid = ((k >= 0) & (k < size)).to(s.dtype)
        idx.append((k - w0[:, None, None]).clamp(0, length - 1))
        wts.append(w * valid * live)
    idx = torch.cat(idx, dim=2)
    wts = torch.cat(wts, dim=2)
    out = torch.zeros(s.shape[0], n_bins, length, dtype=s.dtype,
                      device=dev)
    return out.scatter_add(2, idx, wts)


# ---------------------------------------------------------------- roi ops
def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign (Mask R-CNN): each bin the mean of bilinear samples of
    ``x`` ``[N, C, H, W]`` inside box ``[x1, y1, x2, y2]`` (``boxes [R,
    4]``, ``boxes_num`` RoIs an image); ``[R, C, ph, pw]``."""
    ph, pw = _pair(output_size)
    N, C, H, W = x.shape
    R = boxes.shape[0]
    bidx = _batch_index(boxes_num, R, x.device)
    if R == 0:
        return x.new_zeros(0, C, ph, pw)
    offset = 0.5 if aligned else 0.0
    r = boxes.to(torch.float32) * spatial_scale - offset
    x1, y1, x2, y2 = r.unbind(1)
    rw = x2 - x1
    rh = y2 - y1
    if not aligned:
        rw = rw.clamp_min(1.0)
        rh = rh.clamp_min(1.0)
    bin_h = _div(rh, ph)
    bin_w = _div(rw, pw)
    host = _host_boxes(boxes)
    if sampling_ratio > 0:
        sr_h = sr_w = int(sampling_ratio)
        n_h = torch.full_like(bin_h, sr_h)
        n_w = torch.full_like(bin_w, sr_w)
    else:
        if host is not None:
            # one grid for every RoI, sized from the largest box; each
            # RoI's samples past its own ceil(bin) count are masked out
            b = host * spatial_scale
            sr_h = int(np.ceil((b[:, 3] - b[:, 1]).max() / ph))
            sr_w = int(np.ceil((b[:, 2] - b[:, 0]).max() / pw))
        else:       # in a capture: the feature-map bound
            sr_h = int(np.ceil(H / ph))
            sr_w = int(np.ceil(W / pw))
        sr_h, sr_w = max(sr_h, 1), max(sr_w, 1)
        n_h = torch.ceil(bin_h).clamp(1, sr_h)
        n_w = torch.ceil(bin_w).clamp(1, sr_w)
    if host is not None:
        # the samples lie in [y1, y1 + rh]; their bilinear rows within
        # floor(rh) + 2 of floor(y1), and 3 more for f32 rounding
        hb = host * spatial_scale
        span_h = np.maximum(hb[:, 3] - hb[:, 1], 0 if aligned else 1.0)
        span_w = np.maximum(hb[:, 2] - hb[:, 0], 0 if aligned else 1.0)
        lh = min(H, int(np.floor(span_h.max())) + 5)
        lw = min(W, int(np.floor(span_w.max())) + 5)
    else:
        lh, lw = H, W
    y0 = _window_start(torch.floor(y1.detach()) - 1, H, lh)
    x0 = _window_start(torch.floor(x1.detach()) - 1, W, lw)
    ay = _interp(y1, bin_h, n_h, ph, sr_h, H, y0, lh)         # [R, ph, lh]
    ax = _interp(x1, bin_w, n_w, pw, sr_w, W, x0, lw)         # [R, pw, lw]
    win = _windows(x, bidx, y0, x0, lh, lw)                # [R, lh, lw, C]
    t = torch.matmul(ax[:, None].to(x.dtype), win)         # [R, lh, pw, C]
    out = torch.matmul(ay.to(x.dtype), t.reshape(R, lh, pw * C))
    return out.reshape(R, ph, pw, C).permute(0, 3, 1, 2)


def _bins(lo, size, n_bins: int, length: int, w0):
    """``[R, n_bins, length]`` bool: window row ``k`` (map row ``w0 + k``)
    lies in bin ``i``'s ``[floor(lo + i * size), ceil(lo + (i + 1) *
    size))``."""
    i = torch.arange(n_bins, device=lo.device)
    blo = torch.floor(lo[:, None] + i * size[:, None])
    bhi = torch.ceil(lo[:, None] + (i + 1) * size[:, None])
    rows = w0[:, None] + torch.arange(length, device=lo.device)
    return (rows[:, None, :] >= blo[:, :, None]) \
        & (rows[:, None, :] < bhi[:, :, None])


def _bin_rows(lo, size, n_bins: int, length: int, limit: int):
    """Bin ``i``'s rows (or columns) ``[floor(lo + i * size),
    max(ceil(lo + (i + 1) * size), that + 1))`` as ``length`` indices from
    its first (``[R, n_bins, length]``, clamped into ``[0, limit)``) and
    whether each is one of the bin's and inside the map."""
    i = torch.arange(n_bins, device=lo.device)
    blo = torch.floor(lo[:, None] + i * size[:, None])
    bhi = torch.maximum(torch.ceil(lo[:, None] + (i + 1) * size[:, None]),
                        blo + 1)
    k = blo[:, :, None] + torch.arange(length, device=lo.device)
    live = (k < bhi[:, :, None]) & (k >= 0) & (k < limit)
    return k.long().clamp(0, limit - 1), live


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """RoIPool: the max of each bin of the box rounded to the map's grid
    (Paddle's inclusive corners); an empty bin gives 0.  Each bin's rows
    and columns are gathered from the map (``[R, ph, L_h, pw, L_w, C]``,
    ``L`` the widest bin, from one host read of the boxes; in a capture
    the map's sides)."""
    ph, pw = _pair(output_size)
    N, C, H, W = x.shape
    R = boxes.shape[0]
    bidx = _batch_index(boxes_num, R, x.device)
    if R == 0:
        return x.new_zeros(0, C, ph, pw)
    r = torch.round(boxes.detach().to(torch.float32) * spatial_scale)
    r = r.to(torch.int32)
    x1, y1 = r[:, 0], r[:, 1]
    # inclusive corners: a box's width is x2 - x1 + 1
    x2 = torch.maximum(r[:, 2] + 1, x1 + 1)
    y2 = torch.maximum(r[:, 3] + 1, y1 + 1)
    rh = _div(y2 - y1, ph)
    rw = _div(x2 - x1, pw)
    if _capturing(r):
        lh, lw = H, W
    else:
        # a bin spans at most ceil(size) + 1 rows
        sizes = torch.stack([rh.max(), rw.max()]).tolist()
        lh = min(H, int(np.ceil(sizes[0])) + 1)
        lw = min(W, int(np.ceil(sizes[1])) + 1)
    rows, row_live = _bin_rows(y1.to(torch.float32), rh, ph, lh, H)
    cols, col_live = _bin_rows(x1.to(torch.float32), rw, pw, lw, W)
    vals = _pixels(x, bidx[:, None, None, None, None],
                   rows[:, :, :, None, None], cols[:, None, None, :, :])
    live = row_live[:, :, :, None, None] & col_live[:, None, None, :, :]
    out = vals.masked_fill_(~live[..., None], -math.inf).amax(dim=(2, 4))
    out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out.permute(0, 3, 1, 2)                      # [R, C, ph, pw]


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI average pooling (R-FCN): bin ``(i, j)`` of
    output channel ``k`` averages input channel ``(i * pw + j) * co + k``
    over the bin; ``[R, co, ph, pw]`` with ``co = C / (ph * pw)``."""
    ph, pw = _pair(output_size)
    N, C, H, W = x.shape
    if C % (ph * pw):
        raise ValueError(f"psroi_pool needs channels {C} divisible by "
                         f"output_size {ph}x{pw}")
    co = C // (ph * pw)
    R = boxes.shape[0]
    bidx = _batch_index(boxes_num, R, x.device)
    if R == 0:
        return x.new_zeros(0, co, ph, pw)
    r = boxes.detach().to(torch.float32) * spatial_scale
    x1, y1, x2, y2 = r.unbind(1)
    rh = _div(torch.clamp_min(y2 - y1, 0.1), ph)
    rw = _div(torch.clamp_min(x2 - x1, 0.1), pw)
    host = _host_boxes(boxes)
    if host is not None:
        # rows floor(y1) .. ceil(y1 + ph * rh) - 1: within ceil(span) + 1
        hb = host * spatial_scale
        lh = min(H, int(np.ceil(np.maximum(hb[:, 3] - hb[:, 1],
                                           0.1).max())) + 3)
        lw = min(W, int(np.ceil(np.maximum(hb[:, 2] - hb[:, 0],
                                           0.1).max())) + 3)
    else:
        lh, lw = H, W
    y0 = _window_start(torch.floor(y1), H, lh)
    x0 = _window_start(torch.floor(x1), W, lw)
    my = _bins(y1, rh, ph, lh, y0).to(x.dtype)              # [R, ph, lh]
    mx = _bins(x1, rw, pw, lw, x0).to(x.dtype)              # [R, pw, lw]
    win = _windows(x, bidx, y0, x0, lh, lw).reshape(R, lh, lw, ph, pw, co)
    s = torch.einsum("rjx,ryxijk->ryijk", mx, win)
    s = torch.einsum("riy,ryijk->rkij", my, s)
    cnt = (my.sum(2)[:, :, None] * mx.sum(2)[:, None, :]).clamp_min(1)
    return s / cnt[:, None]


# ---------------------------------------------------------------- nms
def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Greedy NMS: the kept indices (int64) in descending score order (in
    input order when ``scores`` is None), at most ``top_k``.  With
    ``category_idxs`` boxes of different categories never suppress each
    other (multiclass NMS)."""
    b = boxes
    check_host_read("vision.ops.nms", b)
    n = b.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.long, device=b.device)
    area = (b[:, 2] - b[:, 0]).clamp_min(0) * (b[:, 3] - b[:, 1]).clamp_min(0)
    lt = torch.maximum(b[:, None, :2], b[None, :, :2])
    rb = torch.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / torch.clamp_min(area[:, None] + area[None, :] - inter,
                                  1e-10)
    if category_idxs is not None:
        cats = torch.as_tensor(category_idxs, device=b.device)
        iou = torch.where(cats[:, None] == cats[None, :], iou,
                          torch.zeros_like(iou))
    if scores is not None:
        order = torch.argsort(-torch.as_tensor(scores, device=b.device),
                              stable=True)
    else:
        order = torch.arange(n, device=b.device)
    sup = (iou[order][:, order] > iou_threshold).cpu().numpy()
    removed = np.zeros(n, bool)
    keep = []
    for i in range(n):
        if not removed[i]:
            keep.append(i)
            removed |= sup[i]
    kept = order[torch.as_tensor(keep, device=b.device)]
    return kept[:top_k] if top_k is not None else kept


# ---------------------------------------------------------------- deform
def _bilinear(x, ys, xs):
    """``x`` ``[N, C, H, W]`` sampled bilinearly at ``ys``/``xs`` ``[N,
    P]`` (zero outside the map): ``[N, C, P]``."""
    N, C, H, W = x.shape
    flat = x.reshape(N, C, H * W)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    out = 0.0
    for dy, wy in ((0, 1 - wy1), (1, wy1)):
        for dx, wx in ((0, 1 - wx1), (1, wx1)):
            yy = y0.long() + dy
            xx = x0.long() + dx
            valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
            sample = flat.gather(2, idx[:, None].expand(N, C, idx.shape[1]))
            out = out + sample * (wy * wx * valid)[:, None]
    return out


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 (v2 with ``mask``): each kernel tap
    sampled bilinearly at its learned offset (``offset [N, 2 * kh * kw,
    outH, outW]``, ``(dy, dx)`` a tap), times the mask, then one matmul
    with ``weight [Cout, C, kh, kw]``."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    if groups != 1 or deformable_groups != 1:
        raise NotImplementedError(
            "deform_conv2d supports groups=1, deformable_groups=1")
    kh, kw = int(weight.shape[2]), int(weight.shape[3])
    N, C, H, W = x.shape
    out_h = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    out_w = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    K = kh * kw
    dev = x.device
    oy = torch.arange(out_h, device=dev) * sh - ph
    ox = torch.arange(out_w, device=dev) * sw - pw
    ky = torch.arange(kh, device=dev) * dh
    kx = torch.arange(kw, device=dev) * dw
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
        out_h, out_w, kh, kw).reshape(out_h, out_w, K)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
        out_h, out_w, kh, kw).reshape(out_h, out_w, K)
    off = offset.reshape(N, K, 2, out_h, out_w)
    ys = base_y[None] + off[:, :, 0].permute(0, 2, 3, 1)  # [N, oh, ow, K]
    xs = base_x[None] + off[:, :, 1].permute(0, 2, 3, 1)
    P = out_h * out_w * K
    samples = _bilinear(x, ys.reshape(N, P), xs.reshape(N, P))
    if mask is not None:
        m = mask.reshape(N, K, out_h, out_w).permute(0, 2, 3, 1)
        samples = samples * m.reshape(N, 1, P)
    # [N, C, oh * ow, K] -> [N, oh * ow, C * K] @ [C * K, Cout]
    smat = samples.reshape(N, C, out_h * out_w, K).permute(0, 2, 1, 3)
    out = smat.reshape(N, out_h * out_w, C * K) \
        @ weight.reshape(weight.shape[0], -1).t()
    out = out.permute(0, 2, 1).reshape(N, -1, out_h, out_w)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


class DeformConv2D(nn.Layer):
    """The layer of :func:`deform_conv2d` (weight He-normal, bias 0)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._deformable_groups = deformable_groups
        std = (2.0 / (in_channels * kh * kw)) ** 0.5
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, kh, kw],
            attr=weight_attr, default_initializer=init.Normal(0.0, std))
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [out_channels], attr=bias_attr, is_bias=True,
                default_initializer=init.Constant(0.0))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             self._stride, self._padding, self._dilation,
                             self._deformable_groups, self._groups, mask)


# ---------------------------------------------------------------- yolo
def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """A YOLOv3 head ``[N, na * (5 + class_num), H, W]`` decoded to boxes
    ``[N, na * H * W, 4]`` in the image's pixels (``img_size [N, 2]``,
    height then width) and scores ``[N, na * H * W, class_num]``; both
    zero where the objectness is below ``conf_thresh``."""
    an = np.asarray(anchors, np.float32).reshape(-1, 2)
    na = len(an)
    N, C, H, W = x.shape
    dev = x.device
    xa = x.reshape(N, na, -1, H, W)
    tx = torch.sigmoid(xa[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
    ty = torch.sigmoid(xa[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
    tw = xa[:, :, 2]
    th = xa[:, :, 3]
    obj = torch.sigmoid(xa[:, :, 4])
    cls = torch.sigmoid(xa[:, :, 5:])
    gx = torch.arange(W, dtype=torch.float32, device=dev)
    gy = torch.arange(H, dtype=torch.float32, device=dev)
    cx = (tx + gx[None, None, None, :]) / W
    cy = (ty + gy[None, None, :, None]) / H
    aw = _const(an[:, 0], dev)
    ah = _const(an[:, 1], dev)
    input_w = downsample_ratio * W
    input_h = downsample_ratio * H
    bw = torch.exp(tw) * aw[None, :, None, None] / input_w
    bh = torch.exp(th) * ah[None, :, None, None] / input_h
    im_h = img_size[:, 0].to(torch.float32)[:, None, None, None]
    im_w = img_size[:, 1].to(torch.float32)[:, None, None, None]
    x1 = (cx - bw / 2) * im_w
    y1 = (cy - bh / 2) * im_h
    x2 = (cx + bw / 2) * im_w
    y2 = (cy + bh / 2) * im_h
    if clip_bbox:
        x1 = x1.clamp_min(0)
        y1 = y1.clamp_min(0)
        x2 = torch.minimum(x2, im_w - 1)
        y2 = torch.minimum(y2, im_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(N, -1, 4)
    scores = obj[..., None] * cls.permute(0, 1, 3, 4, 2)
    scores = scores.reshape(N, -1, class_num)
    # the confidence filter zeroes (the shapes stay)
    keep = (obj.reshape(N, -1) >= conf_thresh)[..., None].to(boxes.dtype)
    return boxes * keep, scores * keep


def _bce(p, t):
    p = p.clamp(1e-7, 1 - 1e-7)
    return -(t * torch.log(p) + (1 - t) * torch.log(1 - p))


def _scatter_max(shape, flat_idx, values):
    """Zeros of ``shape`` with ``values`` max-reduced in at the flat
    indices (the JAX op's ``.at[...].max`` on zeros)."""
    out = torch.zeros(math.prod(shape), dtype=values.dtype,
                      device=values.device)
    out = out.scatter_reduce(0, flat_idx.reshape(-1), values.reshape(-1),
                             reduce="amax", include_self=True)
    return out.reshape(shape)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """The YOLOv3 loss of one head, ``[N]``: x/y sigmoid BCE and w/h L1
    on the cells whose anchor matches a ground-truth box (``gt_box [N, B,
    4]`` centre and size over the image; a zero size pads), objectness
    BCE with predictions of IoU above ``ignore_thresh`` ignored, and class
    BCE (label-smoothed by default)."""
    anchors_np = np.asarray(anchors, np.float32).reshape(-1, 2)
    mask = list(anchor_mask)
    an_sel = anchors_np[mask]
    na = len(mask)
    N, C, H, W = x.shape
    dev = x.device
    gb = gt_box.detach().to(torch.float32)
    gs = (gt_score.detach().to(torch.float32) if gt_score is not None
          else torch.ones(gb.shape[:2], dtype=torch.float32, device=dev))
    B = gb.shape[1]
    xa = x.reshape(N, na, 5 + class_num, H, W)
    px = torch.sigmoid(xa[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
    py = torch.sigmoid(xa[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
    pw = xa[:, :, 2]
    ph_ = xa[:, :, 3]
    pobj = torch.sigmoid(xa[:, :, 4])
    pcls = torch.sigmoid(xa[:, :, 5:])                  # [N, na, cls, H, W]

    input_size = downsample_ratio * H
    # ground truth: gb [N, B, 4] (cx, cy, w, h) normalized
    gx = gb[..., 0] * W                                 # grid coordinates
    gy = gb[..., 1] * H
    gw = gb[..., 2]
    gh = gb[..., 3]
    gi = gx.to(torch.int32).clamp(0, W - 1).long()
    gj = gy.to(torch.int32).clamp(0, H - 1).long()
    valid = (gb[..., 2] > 0) & (gb[..., 3] > 0)         # [N, B]

    # the best anchor of each box by wh-IoU against ALL anchors; this
    # head is responsible only if that anchor is in its mask
    aw = _const(anchors_np[:, 0] / input_size, dev)
    ah = _const(anchors_np[:, 1] / input_size, dev)
    inter = (torch.minimum(gw[..., None], aw)
             * torch.minimum(gh[..., None], ah))
    union = gw[..., None] * gh[..., None] + aw * ah - inter
    best = torch.argmax(inter / union.clamp_min(1e-10), dim=-1)
    resp = torch.full((N, B), -1, dtype=torch.long, device=dev)
    for k, a_id in enumerate(mask):
        resp = torch.where(best == a_id, k, resp)
    r = valid & (resp >= 0)

    # the dense targets, by scatter-max onto zeros
    bidx = torch.arange(N, device=dev)[:, None].expand(N, B)
    aidx = resp.clamp(0, na - 1)
    sel = torch.stack([_const(an_sel[:, 0], dev),
                       _const(an_sel[:, 1], dev)], 1)
    sel_aw = sel[:, 0][aidx] / input_size
    sel_ah = sel[:, 1][aidx] / input_size
    cell = ((bidx * na + aidx) * H + gj) * W + gi
    zero = torch.zeros((), device=dev)
    shp = (N, na, H, W)
    tx = _scatter_max(shp, cell, torch.where(r, gx - gi, zero))
    ty = _scatter_max(shp, cell, torch.where(r, gy - gj, zero))
    tw = _scatter_max(shp, cell, torch.where(
        r, torch.log((gw / sel_aw).clamp_min(1e-9)), zero))
    th = _scatter_max(shp, cell, torch.where(
        r, torch.log((gh / sel_ah).clamp_min(1e-9)), zero))
    tobj = _scatter_max(shp, cell, torch.where(r, gs, zero))
    tscale = _scatter_max(shp, cell, torch.where(r, 2.0 - gw * gh, zero))
    smooth = (1.0 / class_num if use_label_smooth and class_num > 1
              else 0.0)
    onehot = (gt_label.to(dev).long()[..., None]
              == torch.arange(class_num, device=dev)).to(torch.float32)
    if smooth:
        onehot = onehot.clamp(smooth, 1.0 - smooth)
    cls_cell = (((bidx * na + aidx)[..., None] * class_num
                 + torch.arange(class_num, device=dev)) * H
                + gj[..., None]) * W + gi[..., None]
    tcls = _scatter_max((N, na, class_num, H, W), cls_cell,
                        torch.where(r[..., None], onehot, zero))

    has_obj = tobj > 0
    # the ignore mask: predicted boxes of IoU above the threshold with any
    # ground-truth box
    gx_c = gb[..., 0][:, None, :, None, None]
    gy_c = gb[..., 1][:, None, :, None, None]
    gw_c = gb[..., 2][:, None, :, None, None]
    gh_c = gb[..., 3][:, None, :, None, None]
    cellx = (px + torch.arange(W, device=dev)[None, None, None, :]) / W
    celly = (py + torch.arange(H, device=dev)[None, None, :, None]) / H
    pw_n = torch.exp(pw) * sel[:, 0][None, :, None, None] / input_size
    ph_n = torch.exp(ph_) * sel[:, 1][None, :, None, None] / input_size
    px1 = cellx[:, :, None] - pw_n[:, :, None] / 2
    px2 = cellx[:, :, None] + pw_n[:, :, None] / 2
    py1 = celly[:, :, None] - ph_n[:, :, None] / 2
    py2 = celly[:, :, None] + ph_n[:, :, None] / 2
    tx1 = gx_c - gw_c / 2
    tx2 = gx_c + gw_c / 2
    ty1 = gy_c - gh_c / 2
    ty2 = gy_c + gh_c / 2
    iw = (torch.minimum(px2, tx2) - torch.maximum(px1, tx1)).clamp_min(0)
    ih = (torch.minimum(py2, ty2) - torch.maximum(py1, ty1)).clamp_min(0)
    inter_p = iw * ih
    union_p = (pw_n[:, :, None] * ph_n[:, :, None]
               + gw_c * gh_c - inter_p)
    iou_p = inter_p / union_p.clamp_min(1e-10)
    iou_p = torch.where(valid[:, None, :, None, None], iou_p, zero)
    ignore = (iou_p.amax(dim=2) > ignore_thresh) & ~has_obj

    hob = has_obj.to(x.dtype)
    loss_xy = tscale * (_bce(px, tx) + _bce(py, ty)) * hob
    loss_wh = tscale * ((pw - tw).abs() + (ph_ - th).abs()) * hob
    loss_obj = torch.where(has_obj, _bce(pobj, tobj),
                           torch.where(ignore, zero, _bce(pobj, zero)))
    loss_cls = (_bce(pcls, tcls) * hob[:, :, None]).sum(2)
    total = loss_xy + loss_wh + loss_obj + loss_cls
    return total.sum(dim=(1, 2, 3))


# ---------------------------------------------------------------- layers
class RoIAlign(nn.Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, self._output_size,
                         self._spatial_scale, aligned=aligned)


class RoIPool(nn.Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._output_size,
                        self._spatial_scale)


class PSRoIPool(nn.Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self._output_size,
                          self._spatial_scale)


class ConvNormActivation(nn.Sequential):
    """Conv2D, then a norm (``BatchNorm2D`` by default), then an
    activation (``ReLU`` by default); the convolution has no bias unless
    ``bias=True``."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=None, groups=1, norm_layer=None,
                 activation_layer=None, dilation=1, bias=None):
        if padding is None:
            padding = (kernel_size - 1) // 2 * dilation
        if norm_layer is None:
            norm_layer = nn.BatchNorm2D
        if activation_layer is None:
            activation_layer = nn.ReLU
        if bias is None:
            bias = norm_layer is None
        layers = [nn.Conv2D(in_channels, out_channels, kernel_size,
                            stride, padding, dilation=dilation,
                            groups=groups,
                            bias_attr=None if bias else False)]
        if norm_layer is not None:
            layers.append(norm_layer(out_channels))
        if activation_layer is not None:
            layers.append(activation_layer())
        super().__init__(*layers)


# ---------------------------------------------------------------- files
def read_file(filename, name=None):
    """The file's bytes as a uint8 tensor on the current device."""
    with open(filename, "rb") as f:
        data = f.read()
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(
        current_device())


def decode_jpeg(x, mode='unchanged', name=None):
    """A JPEG's bytes (a uint8 tensor) decoded by PIL on the host into a
    CHW uint8 tensor on the current device (``mode`` ``'gray'`` or
    ``'rgb'`` converts)."""
    from PIL import Image

    data = bytes(x.detach().cpu().numpy().astype(np.uint8))
    img = Image.open(io.BytesIO(data))
    if mode == 'gray':
        img = img.convert('L')
    elif mode == 'rgb':
        img = img.convert('RGB')
    return hwc_to_chw_tensor(img)
