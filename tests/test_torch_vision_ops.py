"""The port's ``vision.ops`` against the JAX package's, on the CPU.

Spec: ``tests/test_vision_ops.py``.  Every case builds its inputs from a
seeded ``numpy.random.RandomState`` and runs them through the JAX op and
its port; where the JAX op has a gradient, the gradients of ``sum(out *
c)`` (``c`` seeded) with respect to the float inputs are compared too.
The spec's own cases are repeated against the port (the adaptive-grid and
mixed-size RoI cases against their brute-force oracle), and ``nms``'s
kept indices must be equal.

Tolerances (absolute and relative, f32): ``TOL`` 1e-5 where both sides
do the same arithmetic in the same order (``yolo_box``, the IoU of
``nms``); ``SUM_TOL`` 1e-4 where the port sums the same terms in another
order (the RoI ops' weighted windows, ``deform_conv2d``'s matmul,
``yolo_loss``'s reductions over the cells).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.vision import ops as J
import paddle_tpu_torch as paddle
from paddle_tpu_torch.vision import ops as V

torch.set_num_threads(2)

TOL = 1e-5
SUM_TOL = 1e-4


@pytest.fixture(autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    with paddle.device_guard("cpu"):
        yield
    mesh_mod.set_global_mesh(saved)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.numpy())


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _both(fn_j, fn_t, floats, others=(), tol=SUM_TOL, grad=True, seed=9):
    """``fn_j(*jax_tensors)`` and ``fn_t(*torch_tensors)`` on the same
    ``floats`` (differentiated) and ``others``; the outputs and, with
    ``grad``, the gradients of ``sum(out * c)`` held at ``tol``.  Returns
    the port's outputs."""
    jf = [jpaddle.to_tensor(a, stop_gradient=not grad) for a in floats]
    tf = [torch.tensor(a, requires_grad=grad) for a in floats]
    jo = [jpaddle.to_tensor(a) for a in others]
    to = [torch.tensor(a) for a in others]
    jout, tout = fn_j(*jf, *jo), fn_t(*tf, *to)
    jouts = jout if isinstance(jout, tuple) else (jout,)
    touts = tout if isinstance(tout, tuple) else (tout,)
    for k, (a, b) in enumerate(zip(touts, jouts)):
        _close(_np(a), _np(b), tol, f"output {k}")
    if grad:
        rs = np.random.RandomState(seed)
        cs = [rs.rand(*tuple(o.shape)).astype(np.float32) for o in touts]
        jloss = sum((o * jpaddle.to_tensor(c)).sum()
                    for o, c in zip(jouts, cs))
        jloss.backward()
        tloss = sum((o * torch.tensor(c)).sum() for o, c in zip(touts, cs))
        tloss.backward()
        for k, (a, b) in enumerate(zip(tf, jf)):
            want = b.grad
            got = a.grad
            want = np.zeros(a.shape, np.float32) if want is None \
                else _np(want)
            got = np.zeros(a.shape, np.float32) if got is None \
                else _np(got)
            _close(got, want, tol, f"grad {k}")
    return touts


def _feat(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _boxes(seed, n, size, lo=1.0, hi=None):
    rs = np.random.RandomState(seed)
    hi = hi or size / 2
    x1 = rs.uniform(-2, size - 2, n)
    y1 = rs.uniform(-2, size - 2, n)
    w = rs.uniform(lo, hi, n)
    h = rs.uniform(lo, hi, n)
    return np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)


# ---- roi_align -------------------------------------------------------------

ROI_ALIGN_CASES = {
    # name: (feat shape, boxes_num, output, scale, sampling_ratio, aligned)
    "adaptive_aligned": ((2, 3, 12, 14), [4, 3], 3, 1.0, -1, True),
    "adaptive_unaligned": ((2, 3, 12, 14), [2, 5], (2, 3), 1.0, -1, False),
    "fixed_ratio": ((2, 2, 10, 10), [3, 3], 2, 1.0, 2, True),
    "scaled": ((1, 4, 16, 20), [6], 4, 0.25, -1, True),
}


@pytest.mark.parametrize("case", sorted(ROI_ALIGN_CASES))
def test_roi_align_matches_jax(case):
    shape, nums, out, scale, sr, aligned = ROI_ALIGN_CASES[case]
    feat = _feat(0, shape)
    size = shape[2] / scale
    boxes = _boxes(1, sum(nums), size, hi=size * 0.7)
    num = np.array(nums, np.int32)
    _both(lambda f, b, n: J.roi_align(f, b, n, out, scale, sr, aligned),
          lambda f, b, n: V.roi_align(f, b, n, out, scale, sr, aligned),
          [feat, boxes], [num])


def test_roi_align_boxes_num_as_a_list():
    feat = _feat(2, (2, 2, 8, 8))
    boxes = _boxes(3, 3, 8)
    got = V.roi_align(torch.tensor(feat), torch.tensor(boxes), [2, 1], 2)
    want = J.roi_align(jpaddle.to_tensor(feat), jpaddle.to_tensor(boxes),
                       [2, 1], 2)
    _close(_np(got), _np(want), SUM_TOL)
    with pytest.raises(ValueError, match="boxes_num"):
        V.roi_align(torch.tensor(feat), torch.tensor(boxes), [1, 1], 2)


def _roi_align_ref(feat, boxes, output_size, spatial_scale=1.0,
                   sampling_ratio=-1, aligned=True):
    """``tests/test_vision_ops.py``'s brute force: each RoI's own
    ``ceil(bin)`` samples a bin."""
    C, H, W = feat.shape[1:]
    ph = pw = output_size

    def interp(fb, y, x):
        y0, x0 = int(np.floor(y)), int(np.floor(x))
        out = np.zeros(C, np.float64)
        for dy in (0, 1):
            for dx in (0, 1):
                yy, xx = y0 + dy, x0 + dx
                if 0 <= yy < H and 0 <= xx < W:
                    out += fb[:, yy, xx] * (1 - abs(y - yy)) \
                        * (1 - abs(x - xx))
        return out

    outs = np.zeros((len(boxes), C, ph, pw), np.float64)
    off = 0.5 if aligned else 0.0
    for bi, (x1, y1, x2, y2) in enumerate(boxes):
        x1, y1 = x1 * spatial_scale - off, y1 * spatial_scale - off
        x2, y2 = x2 * spatial_scale - off, y2 * spatial_scale - off
        bh, bw = (y2 - y1) / ph, (x2 - x1) / pw
        nh = sampling_ratio if sampling_ratio > 0 else max(
            int(np.ceil(bh)), 1)
        nw = sampling_ratio if sampling_ratio > 0 else max(
            int(np.ceil(bw)), 1)
        for i in range(ph):
            for j in range(pw):
                acc = np.zeros(C, np.float64)
                for iy in range(nh):
                    for ix in range(nw):
                        acc += interp(feat[0], y1 + (i + (iy + 0.5) / nh)
                                      * bh, x1 + (j + (ix + 0.5) / nw) * bw)
                outs[bi, :, i, j] = acc / (nh * nw)
    return outs.astype(np.float32)


def _align(feat, boxes, out, sr=-1):
    return _np(V.roi_align(torch.tensor(feat), torch.tensor(boxes),
                           torch.tensor([len(boxes)], dtype=torch.int32),
                           out, sampling_ratio=sr))


def test_roi_align_one_pixel_box():
    feat = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    out = _align(feat, np.array([[1.0, 1.0, 2.0, 2.0]], np.float32), 1, 1)
    np.testing.assert_allclose(out.reshape(-1), [5.0], atol=1e-5)


def test_roi_align_small_roi_per_roi_grid():
    """A kink at row 3: oversampling a bin would move its mean."""
    feat = np.abs(np.arange(8, dtype=np.float32) - 3.0)
    feat = np.broadcast_to(feat[:, None], (8, 8)).copy()[None, None]
    boxes = np.array([[0.5, 0.5, 4.5, 4.5]], np.float32)
    np.testing.assert_allclose(_align(feat, boxes, 4),
                               _roi_align_ref(feat, boxes, 4),
                               rtol=1e-5, atol=1e-6)


def test_roi_align_mixed_roi_sizes():
    feat = _feat(2, (1, 2, 12, 12))
    boxes = np.array([[0, 0, 11, 11], [2, 2, 4.5, 7], [5, 5, 5.8, 5.9]],
                     np.float32)
    np.testing.assert_allclose(_align(feat, boxes, 4),
                               _roi_align_ref(feat, boxes, 4),
                               rtol=1e-4, atol=1e-5)


def test_roi_align_explicit_ratio():
    feat = _feat(3, (1, 1, 8, 8))
    boxes = np.array([[1, 1, 6, 6]], np.float32)
    np.testing.assert_allclose(_align(feat, boxes, 2, 2),
                               _roi_align_ref(feat, boxes, 2,
                                              sampling_ratio=2),
                               rtol=1e-5, atol=1e-6)


def test_roi_align_boxes_past_the_map():
    """Boxes that overhang the map, or lie wholly outside it, sample
    zeros there, as the JAX op's clipped gather does."""
    feat = _feat(4, (1, 2, 6, 6))
    boxes = np.array([[-3, -3, 2, 2], [4, 4, 9, 8], [7, 7, 9, 9],
                      [0, 0, 6, 6]], np.float32)
    _both(lambda f, b: J.roi_align(f, b, [4], 3),
          lambda f, b: V.roi_align(f, b, [4], 3), [feat, boxes])


def test_roi_align_no_boxes():
    out = V.roi_align(torch.zeros(1, 3, 4, 4), torch.zeros(0, 4), [0], 2)
    assert tuple(out.shape) == (0, 3, 2, 2)


# ---- roi_pool and psroi_pool -----------------------------------------------

@pytest.mark.parametrize("scale,out", [(1.0, 2), (0.5, (3, 2)),
                                       (1.0, 4)])
def test_roi_pool_matches_jax(scale, out):
    feat = _feat(5, (2, 3, 10, 12))
    boxes = _boxes(6, 7, 10 / scale, hi=8 / scale)
    num = np.array([3, 4], np.int32)
    _both(lambda f, b, n: J.roi_pool(f, b, n, out, scale),
          lambda f, b, n: V.roi_pool(f, b, n, out, scale),
          [feat, boxes], [num])


def test_roi_pool_max():
    feat = np.zeros((1, 1, 4, 4), np.float32)
    feat[0, 0, 1, 1] = 7.0
    feat[0, 0, 3, 3] = 9.0
    out = _np(V.roi_pool(torch.tensor(feat),
                         torch.tensor([[0, 0, 3, 3]], dtype=torch.float32),
                         torch.tensor([1]), output_size=2))
    assert out.max() == 9.0 and out[0, 0, 0, 0] == 7.0


def test_roi_pool_empty_bins_are_zero():
    """A box outside the map has empty bins: 0, as in the JAX op."""
    feat = _feat(7, (1, 2, 5, 5))
    boxes = np.array([[6, 6, 9, 9], [3, 3, 8, 8]], np.float32)
    got = _both(lambda f, b: J.roi_pool(f, b, [2], 2),
                lambda f, b: V.roi_pool(f, b, [2], 2), [feat, boxes])[0]
    assert (_np(got)[0] == 0).all()


@pytest.mark.parametrize("scale,out", [(1.0, 2), (0.5, (2, 3))])
def test_psroi_pool_matches_jax(scale, out):
    ph, pw = (out, out) if isinstance(out, int) else out
    feat = _feat(8, (2, ph * pw * 3, 9, 11))
    boxes = _boxes(9, 6, 9 / scale, lo=0.0, hi=7 / scale)
    num = np.array([2, 4], np.int32)
    _both(lambda f, b, n: J.psroi_pool(f, b, n, out, scale),
          lambda f, b, n: V.psroi_pool(f, b, n, out, scale),
          [feat, boxes], [num])


def test_psroi_pool_bin_mean():
    feat = _feat(1, (1, 8, 6, 6))
    out = _np(V.psroi_pool(torch.tensor(feat),
                           torch.tensor([[0, 0, 6, 6]], dtype=torch.float32),
                           torch.tensor([1]), output_size=2))
    assert out.shape == (1, 2, 2, 2)
    np.testing.assert_allclose(out[0, 0, 0, 0], feat[0, 0, 0:3, 0:3].mean(),
                               rtol=1e-4)


def test_psroi_pool_refuses_indivisible_channels():
    with pytest.raises(ValueError, match="divisible"):
        V.psroi_pool(torch.zeros(1, 6, 4, 4), torch.zeros(1, 4), [1], 2)


# ---- nms ---------------------------------------------------------------------

def _nms_both(boxes, thr, scores=None, cats=None, top_k=None):
    kw = dict(top_k=top_k)
    jkw, tkw = dict(kw), dict(kw)
    if scores is not None:
        jkw["scores"] = jpaddle.to_tensor(scores)
        tkw["scores"] = torch.tensor(scores)
    if cats is not None:
        jkw["category_idxs"] = jpaddle.to_tensor(cats)
        tkw["category_idxs"] = torch.tensor(cats)
        jkw["categories"] = tkw["categories"] = sorted(set(cats.tolist()))
    want = _np(J.nms(jpaddle.to_tensor(boxes), thr, **jkw))
    got = V.nms(torch.tensor(boxes), thr, **tkw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_np(got), want)
    return _np(got).tolist()


def test_nms_basic_suppression():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30]],
                     np.float32)
    assert _nms_both(boxes, 0.5, np.array([0.9, 0.8, 0.7],
                                          np.float32)) == [0, 2]


def test_nms_score_order_and_top_k():
    boxes = np.array([[0, 0, 10, 10], [100, 100, 110, 110],
                      [50, 50, 60, 60]], np.float32)
    scores = np.array([0.1, 0.9, 0.5], np.float32)
    assert _nms_both(boxes, 0.5, scores) == [1, 2, 0]
    assert _nms_both(boxes, 0.5, scores, top_k=2) == [1, 2]


def test_nms_categories():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11]], np.float32)
    kept = _nms_both(boxes, 0.3, np.array([0.9, 0.8], np.float32),
                     np.array([0, 1]))
    assert sorted(kept) == [0, 1]


@pytest.mark.parametrize("seed,thr,with_scores,n_cats,top_k", [
    (0, 0.5, True, 0, None), (1, 0.3, True, 4, None),
    (2, 0.45, True, 8, 10), (3, 0.5, False, 0, None),
    (4, 0.6, True, 3, 5)])
def test_nms_random_matches_jax(seed, thr, with_scores, n_cats, top_k):
    rs = np.random.RandomState(seed)
    boxes = _boxes(seed, 60, 50, lo=4, hi=20)
    scores = rs.rand(60).astype(np.float32) if with_scores else None
    if with_scores:
        scores[5] = scores[7]                   # a tie keeps input order
    cats = rs.randint(0, n_cats, 60) if n_cats else None
    _nms_both(boxes, thr, scores, cats, top_k)


def test_nms_no_boxes():
    out = V.nms(torch.zeros(0, 4), 0.5)
    assert out.dtype == torch.int64 and out.numel() == 0


# ---- deform_conv2d -------------------------------------------------------------

@pytest.mark.parametrize("stride,padding,dilation,with_mask,with_bias", [
    (1, 1, 1, False, True), (1, 1, 1, True, False), (2, 0, 1, True, True),
    (1, 2, 2, True, True)])
def test_deform_conv2d_matches_jax(stride, padding, dilation, with_mask,
                                   with_bias):
    rs = np.random.RandomState(10)
    N, C, H, W, Co, k = 2, 3, 7, 8, 4, 3
    oh = (H + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    ow = (W + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    x = rs.randn(N, C, H, W).astype(np.float32)
    off = (1.5 * rs.randn(N, 2 * k * k, oh, ow)).astype(np.float32)
    w = rs.randn(Co, C, k, k).astype(np.float32)
    floats = [x, off, w]
    if with_mask:
        floats.append(rs.rand(N, k * k, oh, ow).astype(np.float32))
    if with_bias:
        floats.append(rs.randn(Co).astype(np.float32))

    def call(ops):
        def f(x, off, w, *rest):
            rest = list(rest)
            m = rest.pop(0) if with_mask else None
            b = rest.pop(0) if with_bias else None
            return ops.deform_conv2d(x, off, w, b, stride, padding,
                                     dilation, mask=m)
        return f

    _both(call(J), call(V), floats)


def test_deform_conv2d_zero_offset_is_a_convolution():
    x = _feat(2, (1, 3, 6, 6))
    w = _feat(3, (4, 3, 3, 3))
    out = V.deform_conv2d(torch.tensor(x), torch.zeros(1, 18, 6, 6),
                          torch.tensor(w), padding=1)
    ref = torch.nn.functional.conv2d(torch.tensor(x), torch.tensor(w),
                                     padding=1)
    _close(_np(out), _np(ref), SUM_TOL)


def test_deform_conv2d_layer_with_mask_and_grad():
    paddle.seed(0)
    layer = V.DeformConv2D(3, 4, 3, padding=1)
    assert tuple(layer.weight.shape) == (4, 3, 3, 3)
    rs = np.random.RandomState(3)
    x = torch.tensor(rs.randn(2, 3, 5, 5).astype(np.float32))
    off = torch.tensor(0.1 * rs.randn(2, 18, 5, 5).astype(np.float32),
                       requires_grad=True)
    mask = torch.tensor(np.abs(rs.randn(2, 9, 5, 5)).astype(np.float32))
    out = layer(x, off, mask)
    assert tuple(out.shape) == (2, 4, 5, 5)
    out.sum().backward()
    assert layer.weight.grad is not None and off.grad is not None
    with pytest.raises(NotImplementedError):
        V.deform_conv2d(x, off, layer.weight, groups=2)


# ---- yolo ----------------------------------------------------------------------

ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]


@pytest.mark.parametrize("clip,scale_xy,thresh", [
    (True, 1.0, 0.01), (False, 1.05, 0.3), (True, 1.2, 0.0)])
def test_yolo_box_matches_jax(clip, scale_xy, thresh):
    rs = np.random.RandomState(11)
    N, na, cls, H, W = 2, 3, 4, 5, 6
    x = rs.randn(N, na * (5 + cls), H, W).astype(np.float32)
    img = np.array([[80, 96], [64, 48]], np.int32)
    kw = dict(anchors=ANCHORS[:6], class_num=cls, conf_thresh=thresh,
              downsample_ratio=16, clip_bbox=clip, scale_x_y=scale_xy)
    _both(lambda a, i: J.yolo_box(a, i, **kw),
          lambda a, i: V.yolo_box(a, i, **kw), [x], [img], tol=TOL)


def _gt(seed, N, B, real):
    rs = np.random.RandomState(seed)
    box = np.zeros((N, B, 4), np.float32)
    label = np.zeros((N, B), np.int64)
    for n in range(N):
        k = real[n]
        box[n, :k, :2] = rs.uniform(0.05, 0.95, (k, 2))
        box[n, :k, 2:] = rs.uniform(0.02, 0.6, (k, 2))
        label[n, :k] = rs.randint(0, 5, k)
    return box, label


@pytest.mark.parametrize("mask,smooth,with_score,scale_xy", [
    ([0, 1, 2], True, False, 1.0), ([3, 4, 5], False, True, 1.0),
    ([0, 2, 4], True, True, 1.1)])
def test_yolo_loss_matches_jax(mask, smooth, with_score, scale_xy):
    rs = np.random.RandomState(12)
    N, cls, H, W = 2, 5, 6, 6
    x = rs.randn(N, len(mask) * (5 + cls), H, W).astype(np.float32)
    box, label = _gt(13, N, 6, [4, 2])
    others = [box, label]
    if with_score:
        others.append(rs.uniform(0.5, 1.0, (N, 6)).astype(np.float32))
    kw = dict(anchors=ANCHORS, anchor_mask=mask, class_num=cls,
              ignore_thresh=0.5, downsample_ratio=32,
              use_label_smooth=smooth, scale_x_y=scale_xy)

    def call(ops):
        def f(x, b, l, *s):
            return ops.yolo_loss(x, b, l, gt_score=s[0] if s else None,
                                 **kw)
        return f

    out = _both(call(J), call(V), [x], others)[0]
    assert tuple(out.shape) == (N,) and np.isfinite(_np(out)).all()


def test_yolo_loss_two_boxes_in_one_cell():
    """Two boxes that land in the same cell and anchor: the targets take
    the max, as the JAX op's scatter does."""
    rs = np.random.RandomState(14)
    x = rs.randn(1, 3 * 7, 4, 4).astype(np.float32)
    box = np.array([[[0.3, 0.3, 0.2, 0.25], [0.31, 0.32, 0.22, 0.2],
                     [0.8, 0.7, 0.5, 0.4]]], np.float32)
    label = np.array([[0, 1, 1]], np.int64)
    kw = dict(anchors=[10, 13, 16, 30, 33, 23], anchor_mask=[0, 1, 2],
              class_num=2, ignore_thresh=0.7, downsample_ratio=16)
    _both(lambda a, b, l: J.yolo_loss(a, b, l, **kw),
          lambda a, b, l: V.yolo_loss(a, b, l, **kw), [x], [box, label])


# ---- layers and files ----------------------------------------------------------

def test_roi_layers_match_the_functions():
    feat = torch.tensor(_feat(15, (1, 8, 8, 8)))
    boxes = torch.tensor(_boxes(16, 3, 8))
    num = torch.tensor([3])
    torch.testing.assert_close(V.RoIAlign(2, 1.0)(feat, boxes, num),
                               V.roi_align(feat, boxes, num, 2))
    torch.testing.assert_close(V.RoIPool(2)(feat, boxes, num),
                               V.roi_pool(feat, boxes, num, 2))
    torch.testing.assert_close(V.PSRoIPool(2)(feat, boxes, num),
                               V.psroi_pool(feat, boxes, num, 2))


def test_conv_norm_activation_names_and_forward():
    """``ConvNormActivation``'s names are the JAX block's, and with its
    weights it gives the same output (eval mode)."""
    jpaddle.seed(0)
    jb = J.ConvNormActivation(3, 8, 3)
    tb = V.ConvNormActivation(3, 8, 3)
    sd = {k: np.asarray(v.numpy()) for k, v in jb.state_dict().items()}
    from paddle_tpu_torch.models import port_state_dict_from_jax

    tb.load_state_dict(port_state_dict_from_jax(tb, sd))
    jb.eval()
    tb.eval()
    x = _feat(17, (2, 3, 8, 8))
    out = _np(tb(torch.tensor(x)))
    _close(out, _np(jb(jpaddle.to_tensor(x))), SUM_TOL)
    assert out.min() >= 0 and tb[0].bias is None


def test_read_file_and_decode_jpeg(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(18)
    img = rs.randint(0, 256, (6, 5, 3)).astype(np.uint8)
    path = str(tmp_path / "x.jpg")
    Image.fromarray(img).save(path, quality=95)
    data = V.read_file(path)
    assert data.dtype == torch.uint8
    np.testing.assert_array_equal(_np(data), _np(J.read_file(path)))
    for mode in ("unchanged", "gray", "rgb"):
        got = _np(V.decode_jpeg(data, mode))
        want = _np(J.decode_jpeg(J.read_file(path), mode))
        np.testing.assert_array_equal(got, want)
