"""``paddle.static.nn``'s fluid-style layer builders.

Port of ``paddle_tpu/static/nn_compat.py`` (reference:
``python/paddle/static/nn/__init__.py``, re-exporting
``fluid/layers/nn.py``'s ``fc:195``, ``conv2d:1451``, ``embedding``,
``batch_norm``, ...).  Each builder makes its parameters with
``create_parameter`` (on the current device) and calls the port's
functional op, so a recording program takes the ops and reads the
parameters as leaves.  ``fc`` keeps its weight in the port's ``[out, in]``
layout (``torch.nn.functional.linear``, as ``nn.Linear``);
``static.set_program_state`` transposes a Paddle ``[in, out]`` weight into
it.  The LoD ``sequence_*`` family and the sampled-softmax/CRF ops are
legacy variable-length APIs with no 2.x tensor equivalent; they raise with
that reason, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "fc", "embedding", "conv2d", "conv2d_transpose", "conv3d",
    "conv3d_transpose", "batch_norm", "instance_norm", "layer_norm",
    "group_norm", "data_norm", "spectral_norm", "deform_conv2d", "prelu",
    "bilinear_tensor_product", "py_func",
    "crf_decoding", "nce", "multi_box_head", "row_conv",
    "sparse_embedding",
    "sequence_concat", "sequence_conv", "sequence_enumerate",
    "sequence_expand", "sequence_expand_as", "sequence_first_step",
    "sequence_last_step", "sequence_pad", "sequence_pool",
    "sequence_reshape", "sequence_reverse", "sequence_scatter",
    "sequence_slice", "sequence_softmax", "sequence_unpad",
]


def _param(shape, dtype=torch.float32, is_bias=False, transpose=False):
    from ..nn import initializer as I
    from ..nn.layer_base import Layer

    return Layer().create_parameter(
        list(shape), dtype=dtype, is_bias=is_bias, transpose=transpose,
        default_initializer=I.Constant(0.0) if is_bias else None)


def _act(out, act):
    if not act:
        return out
    from ..nn import functional as F

    return getattr(F, act)(out)


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """Fully connected over the dims from ``num_flatten_dims`` on
    (reference ``fluid/layers/nn.py fc``); a list of inputs is summed."""
    from ..ops.manipulation import reshape

    xs = [x] if isinstance(x, torch.Tensor) else list(x)
    out = None
    for xi in xs:
        in_dim = int(np.prod(xi.shape[num_flatten_dims:]))
        # 0 keeps a dim (Paddle's reshape): a None dim's dummy size is
        # never baked into the op
        flat = reshape(xi, [0] * num_flatten_dims + [in_dim])
        w = _param([in_dim, size], xi.dtype, transpose=True)
        y = torch.nn.functional.linear(flat, w)
        out = y if out is None else out + y
    if bias_attr is not False:
        out = out + _param([size], xs[0].dtype, is_bias=True)
    return _act(out, activation)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    from ..nn import functional as F
    from ..ops._helpers import convert_dtype

    w = _param(list(size), convert_dtype(dtype))
    return F.embedding(input, w, padding_idx=padding_idx)


def _conv(ndim, transpose):
    def builder(input, num_filters, filter_size, stride=1, padding=0,
                dilation=1, groups=1, param_attr=None, bias_attr=None,
                use_cudnn=True, act=None, name=None, output_size=None,
                data_format="NCHW" if ndim == 2 else "NCDHW"):
        from ..nn import functional as F

        fn = {(2, False): F.conv2d, (2, True): F.conv2d_transpose,
              (3, False): F.conv3d, (3, True): F.conv3d_transpose}[
                  (ndim, transpose)]
        c_in = input.shape[1]
        ks = [filter_size] * ndim if isinstance(filter_size, int) \
            else list(filter_size)
        g = max(int(groups or 1), 1)
        shape = [c_in, num_filters // g] if transpose else \
            [num_filters, c_in // g]
        w = _param(shape + ks, input.dtype)
        b = None if bias_attr is False else \
            _param([num_filters], input.dtype, is_bias=True)
        kw = dict(stride=stride, padding=padding, groups=g)
        if not transpose:
            kw["dilation"] = dilation
        return _act(fn(input, w, bias=b, **kw), act)

    return builder


conv2d = _conv(2, False)
conv2d_transpose = _conv(2, True)
conv3d = _conv(3, False)
conv3d_transpose = _conv(3, True)


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=True,
               use_global_stats=False, is_test=False):
    from ..nn import functional as F

    c = input.shape[1]
    w = _param([c], input.dtype)
    b = _param([c], input.dtype, is_bias=True)
    rm = torch.zeros(c, dtype=input.dtype, device=input.device)
    rv = torch.ones(c, dtype=input.dtype, device=input.device)
    out = F.batch_norm(input, rm, rv, weight=w, bias=b,
                       training=not (is_test or use_global_stats),
                       momentum=momentum, epsilon=epsilon,
                       data_format=data_layout)
    return _act(out, act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    from ..nn import functional as F

    c = input.shape[1]
    w = None if param_attr is False else _param([c], input.dtype)
    b = None if bias_attr is False else _param([c], input.dtype,
                                               is_bias=True)
    return F.instance_norm(input, weight=w, bias=b, eps=epsilon)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    from ..nn import functional as F
    from ..ops.manipulation import reshape

    n = int(np.prod(input.shape[begin_norm_axis:]))
    w = _param([n], input.dtype) if scale else None
    b = _param([n], input.dtype, is_bias=True) if shift else None
    flat = reshape(input, [0] * begin_norm_axis + [n])
    out = reshape(F.layer_norm(flat, n, weight=w, bias=b, epsilon=epsilon),
                  list(input.shape))
    return _act(out, act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None,
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    from ..nn import functional as F

    c = input.shape[1]
    w = None if param_attr is False else _param([c], input.dtype)
    b = None if bias_attr is False else _param([c], input.dtype,
                                               is_bias=True)
    return _act(F.group_norm(input, groups, epsilon=epsilon, weight=w,
                             bias=b), act)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              enable_scale_and_shift=False, **kwargs):
    """Normalization by the batch's own statistics (reference
    ``data_norm``)."""
    mean = input.mean(dim=0, keepdim=True)
    var = ((input - mean) ** 2).mean(dim=0, keepdim=True)
    return _act((input - mean) / (var + epsilon).sqrt(), act)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    from ..nn.layer.norm import SpectralNorm

    sn = SpectralNorm(list(weight.shape), axis=dim, power_iters=power_iters,
                      epsilon=eps)
    return sn(weight)


def deform_conv2d(input, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, param_attr=None, bias_attr=None, name=None):
    from ..vision.ops import deform_conv2d as _dc

    c_in = input.shape[1]
    ks = [filter_size] * 2 if isinstance(filter_size, int) \
        else list(filter_size)
    w = _param([num_filters, c_in // max(groups, 1)] + ks, input.dtype)
    b = None if bias_attr is False else \
        _param([num_filters], input.dtype, is_bias=True)
    return _dc(input, offset, w, bias=b, stride=stride, padding=padding,
               dilation=dilation, deformable_groups=deformable_groups,
               groups=groups, mask=mask)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    from ..nn import functional as F

    if mode == "all":
        n = 1
    elif mode == "channel":
        n = x.shape[1]
    else:
        n = int(np.prod(x.shape[1:]))
    return F.prelu(x, _param([n], x.dtype))


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    from ..nn import functional as F

    w = _param([size, x.shape[-1], y.shape[-1]], x.dtype)
    b = None if bias_attr is False else _param([size], x.dtype,
                                               is_bias=True)
    return _act(F.bilinear(x, y, w, bias=b), act)


def py_func(func, x, out=None, backward_func=None,
            skip_vars_in_backward_input=None):
    """Host Python op (reference ``py_func_op``): ``static.py_func``."""
    from .program import py_func as _py_func

    return _py_func(func, x, out, backward_func, skip_vars_in_backward_input)


def _lod_stub(name):
    def fn(*a, **k):
        raise NotImplementedError(
            f"static.nn.{name} operates on LoD (variable-length) tensors, "
            "a fluid-era representation with no 2.x tensor equivalent; "
            "use padded tensors + masks (paddle.nn, sequence_mask) "
            "instead")
    fn.__name__ = fn.__qualname__ = name
    return fn


for _n in ("sequence_concat", "sequence_conv", "sequence_enumerate",
           "sequence_expand", "sequence_expand_as", "sequence_first_step",
           "sequence_last_step", "sequence_pad", "sequence_pool",
           "sequence_reshape", "sequence_reverse", "sequence_scatter",
           "sequence_slice", "sequence_softmax", "sequence_unpad",
           "crf_decoding", "nce", "multi_box_head", "row_conv",
           "sparse_embedding"):
    globals()[_n] = _lod_stub(_n)
del _n
