"""The port's ``nn`` against the JAX package's, on the CPU.

Spec: ``tests/test_nn.py`` and ``tests/test_nn_extras.py`` (the RNN cases
excepted: ``nn/layer/rnn.py`` is not ported yet).  Every case builds its
inputs from a seeded ``numpy.random.RandomState`` and runs them through a
JAX functional or layer and its port; a layer's weights go from the JAX
layer's ``state_dict()`` through ``models.port_state_dict_from_jax`` into
the port's.  Outputs are compared, and where a function or layer trains,
the gradients of ``sum(out * c)`` (``c`` seeded) with respect to the
float inputs and the parameters.

Tolerances (absolute and relative, f32): ``ELEMENTWISE`` 1e-5 for the
activations, the common elementwise functions and the norms;
``REDUCING`` 1e-4 for convolution, pooling, the losses, attention and
the rest (sums of many terms in another order).  Dropout at p > 0 is
held to its laws (the share kept and the scale), not to the JAX package's
bits (ROADMAP C "Deliberate departures"); so are the initializers.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu_torch import device as tdevice
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as tF
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch import rng as trng
from paddle_tpu_torch.models import port_state_dict_from_jax
from paddle_tpu_torch.nn import initializer as tI
from paddle_tpu_torch.optimizer import SGD, Momentum

torch.set_num_threads(2)

ELEMENTWISE = 1e-5
REDUCING = 1e-4

#: the names of ``paddle_tpu.nn`` whose port is ROADMAP A.5 step 3b
STEP_3B = {"RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU", "Decoder",
           "BeamSearchDecoder", "dynamic_decode"}


@pytest.fixture(autouse=True)
def _single_device():
    """The JAX side runs unsharded (an earlier file in the worker may
    leave a mesh set)."""
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    yield
    mesh_mod.set_global_mesh(saved)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's layers are built on the CPU (their default is the
    card)."""
    with tdevice.device_guard("cpu"):
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.numpy())


def _close(got, want, tol, what=""):
    got = _np(got) if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


class Arg:
    """A float input that the case differentiates with respect to."""

    def __init__(self, value):
        self.value = np.asarray(value, np.float32)


def _inputs(args):
    jargs, targs, jgrad, tgrad = [], [], [], []
    for a in args:
        if isinstance(a, Arg):
            j = paddle.to_tensor(a.value, stop_gradient=False)
            t = torch.from_numpy(a.value.copy()).requires_grad_()
            jgrad.append(j)
            tgrad.append(t)
        elif isinstance(a, np.ndarray):
            j, t = paddle.to_tensor(a), torch.from_numpy(a.copy())
        else:
            j = t = a
        jargs.append(j)
        targs.append(t)
    return jargs, targs, jgrad, tgrad


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _backward_both(jout, tout, seed=7):
    """``sum(out * c)`` backward on both sides, ``c`` seeded."""
    c = np.asarray(np.random.RandomState(seed).randn(*_np(tout).shape),
                   np.float32)
    (jout * paddle.to_tensor(c)).sum().backward()
    (tout * torch.from_numpy(c)).sum().backward()


def check_fn(name, args, kwargs=None, tol=ELEMENTWISE, grad=False):
    kwargs = kwargs or {}
    keys = list(kwargs)
    jargs, targs, jgrad, tgrad = _inputs(list(args) + list(kwargs.values()))
    n = len(args)
    jout = _outs(getattr(jF, name)(*jargs[:n], **dict(zip(keys, jargs[n:]))))
    tout = _outs(getattr(tF, name)(*targs[:n], **dict(zip(keys, targs[n:]))))
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        _close(_np(t), _np(j), tol, name)
    if grad and tgrad:
        _backward_both(jout[0], tout[0])
        for j, t in zip(jgrad, tgrad):
            _close(_np(t.grad), _np(j.grad), tol, f"{name} grad")


def _r(seed, *shape, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


#: the parametrised cases whose gradients are compared too (each JAX
#: backward costs a compile, so the forward alone holds the rest)
GRADS = {"gelu5", "softplus10", "maxout26", "pad6", "pixel_shuffle13",
         "bilinear3", "batch_norm0", "cross_entropy0", "cross_entropy4",
         "cross_entropy6", "nll_loss11", "binary_cross_entropy_with_logits14",
         "triplet_margin_loss22", "conv2d4", "conv2d_transpose9",
         "avg_pool2d3", "max_pool2d6", "grid_sample5"}


def _grad(request) -> bool:
    return request.node.callspec.id.split("-")[0] in GRADS


X = Arg(_r(0, 3, 8))
X4 = Arg(_r(1, 2, 4, 5, 5))

ACTIVATIONS = [
    ("relu", []), ("relu6", []), ("elu", [0.7]), ("selu", []),
    ("celu", [1.3]), ("gelu", []), ("gelu", [True]), ("silu", []),
    ("swish", []), ("mish", []), ("softplus", [2.0, 1.5]), ("softsign", []),
    ("softshrink", [0.4]), ("hardshrink", [0.4]), ("tanhshrink", []),
    ("hardtanh", [-0.5, 0.7]), ("hardsigmoid", []), ("hardswish", []),
    ("leaky_relu", [0.2]), ("log_sigmoid", []), ("thresholded_relu", [0.3]),
    ("sigmoid", []), ("tanh", []), ("softmax", [0]), ("log_softmax", [-1]),
    ("glu", [-1]), ("maxout", [2, 1]), ("rrelu", [0.1, 0.3, False]),
]


@pytest.mark.parametrize("name,extra", ACTIVATIONS,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(ACTIVATIONS)])
def test_activation_matches_jax(name, extra, request):
    x = Arg(_r(2, 2, 4, 3) * 3) if name == "maxout" else X
    check_fn(name, [x] + extra, grad=_grad(request))


def test_prelu_per_channel_matches_jax():
    check_fn("prelu", [X4, Arg(np.array([0.1, 0.2, 0.3, 0.4], np.float32))])


def test_softmax_dtype_and_inplace_variants():
    x = _r(3, 3, 5)
    got = tF.softmax(torch.from_numpy(x).double(), dtype="float32")
    assert got.dtype == torch.float32
    t = torch.from_numpy(x.copy())
    tF.relu_(t)
    _close(t, np.maximum(x, 0), 0)
    t = torch.from_numpy(x.copy())
    tF.tanh_(t)
    _close(t, np.tanh(x), ELEMENTWISE)


def test_rrelu_training_slopes_lie_in_range():
    x = -torch.ones(20000)
    slope = -tF.rrelu(x, 0.1, 0.3, training=True)
    assert 0.1 <= float(slope.min()) and float(slope.max()) <= 0.3
    assert abs(float(slope.mean()) - 0.2) < 5e-3


def test_gumbel_softmax_laws():
    x = torch.from_numpy(_r(4, 6, 5)).requires_grad_()
    soft = tF.gumbel_softmax(x, temperature=0.5)
    _close(soft.sum(-1), np.ones(6), 1e-6)
    hard = tF.gumbel_softmax(x, hard=True)
    _close(hard, np.round(_np(hard)), 1e-6)
    _close(hard.sum(-1), np.ones(6), 1e-6)
    hard.sum().backward()
    assert x.grad is not None


COMMON = [
    ("linear", lambda: [Arg(_r(5, 4, 6)), Arg(_r(6, 6, 3)),
                        Arg(_r(7, 3))], {}),
    ("embedding", lambda: [np.array([[0, 2, 4], [1, 1, 3]]),
                           Arg(_r(8, 5, 4))], {}),
    ("embedding", lambda: [np.array([[0, 2, 4], [1, 1, 3]]),
                           Arg(_r(8, 5, 4))], {"padding_idx": 1}),
    ("one_hot", lambda: [np.array([0, 3, 2]), 4], {}),
    ("pad", lambda: [X4, [1, 0, 2, 1]], {}),
    ("pad", lambda: [X4, [0, 0, 0, 1, 2, 0, 1, 1]], {"value": 0.5}),
    ("pad", lambda: [X4, [1, 2, 2, 1]], {"mode": "reflect"}),
    ("pad", lambda: [X4, [1, 2, 2, 1]], {"mode": "replicate"}),
    ("pad", lambda: [X4, [1, 2, 2, 1]], {"mode": "circular"}),
    ("pad", lambda: [X4, [1, 2, 0, 1]], {"data_format": "NHWC"}),
    ("zeropad2d", lambda: [X4, [1, 0, 2, 1]], {}),
    ("cosine_similarity", lambda: [Arg(_r(9, 3, 5)), Arg(_r(10, 3, 5))],
     {}),
    ("cosine_similarity", lambda: [Arg(_r(9, 3, 5)), Arg(_r(10, 3, 5))],
     {"axis": 0}),
    ("pixel_shuffle", lambda: [Arg(_r(11, 1, 8, 2, 3)), 2], {}),
    ("pixel_shuffle", lambda: [Arg(_r(11, 1, 2, 3, 8)), 2],
     {"data_format": "NHWC"}),
    ("pixel_unshuffle", lambda: [Arg(_r(12, 1, 2, 4, 6)), 2], {}),
    ("pixel_unshuffle", lambda: [Arg(_r(12, 1, 4, 6, 2)), 2],
     {"data_format": "NHWC"}),
    ("channel_shuffle", lambda: [Arg(_r(13, 1, 6, 2, 2)), 3], {}),
    ("channel_shuffle", lambda: [Arg(_r(13, 1, 2, 2, 6)), 2],
     {"data_format": "NHWC"}),
    ("label_smooth", lambda: [Arg(np.eye(4, dtype=np.float32))],
     {"epsilon": 0.2}),
    ("temporal_shift", lambda: [Arg(_r(14, 4, 8, 2, 2)), 2], {}),
]


@pytest.mark.parametrize("name,build,kwargs", COMMON,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(COMMON)])
def test_common_matches_jax(name, build, kwargs, request):
    check_fn(name, build(), kwargs, grad=_grad(request))


RESIZES = [
    ("nearest", (2, 3, 4, 5), {"scale_factor": 2}),
    ("nearest", (2, 3, 6, 6), {"size": [4, 9]}),
    ("bilinear", (2, 3, 4, 5), {"size": [7, 9]}),
    ("bilinear", (2, 3, 8, 8), {"size": [3, 5]}),      # antialiased
    ("bicubic", (1, 2, 5, 5), {"scale_factor": 2}),
    ("linear", (2, 3, 6), {"size": 11, "data_format": "NCW"}),
    ("trilinear", (1, 2, 3, 4, 4), {"scale_factor": 2,
                                    "data_format": "NCDHW"}),
    ("area", (1, 2, 8, 8), {"size": [4, 4]}),
    ("bilinear", (2, 4, 5, 3), {"size": [8, 6], "data_format": "NHWC"}),
]


@pytest.mark.parametrize("mode,shape,kwargs", RESIZES,
                         ids=[f"{m}{i}" for i, (m, _, _) in
                              enumerate(RESIZES)])
def test_interpolate_matches_jax_image_resize(mode, shape, kwargs, request):
    check_fn("interpolate", [Arg(_r(15, *shape))], {"mode": mode, **kwargs},
             tol=REDUCING, grad=_grad(request))


@pytest.mark.parametrize("paddings", [[1, 2], [1, 0, 2, 1]])
def test_unfold_and_fold_match_jax(paddings):
    x = Arg(_r(16, 2, 3, 6, 7))
    check_fn("unfold", [x, [3, 2]], {"strides": [2, 1],
                                     "paddings": paddings, "dilations": 1},
             tol=REDUCING)
    if paddings == [1, 2]:
        cols = Arg(_r(17, 2, 12, 20))
        check_fn("fold", [cols, [5, 6], [2, 2]], {"paddings": 0},
                 tol=REDUCING)


def test_npair_and_class_center_sample_match_jax():
    check_fn("npair_loss", [Arg(_r(18, 4, 5)), Arg(_r(19, 4, 5)),
                            np.array([0, 1, 0, 2], np.float32)],
             tol=REDUCING)
    lab = np.array([3, 7, 3, 1, 9])
    j = jF.class_center_sample(paddle.to_tensor(lab), 12, 6)
    t = tF.class_center_sample(torch.from_numpy(lab), 12, 6)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(_np(b), _np(a))


NORMS = [
    ("batch_norm", lambda: [X4, np.zeros(4, np.float32),
                            np.ones(4, np.float32),
                            Arg(_r(20, 4)), Arg(_r(21, 4))],
     {"training": False}),
    ("layer_norm", lambda: [Arg(_r(22, 3, 4, 6)), [4, 6], Arg(_r(23, 4, 6)),
                            Arg(_r(24, 4, 6))], {}),
    ("rms_norm", lambda: [Arg(_r(25, 3, 8)), Arg(_r(26, 8))], {}),
    ("instance_norm", lambda: [X4], {"weight": Arg(_r(27, 4)),
                                     "bias": Arg(_r(28, 4))}),
    ("instance_norm", lambda: [Arg(_r(29, 2, 5, 5, 4))],
     {"data_format": "NHWC"}),
    ("group_norm", lambda: [X4, 2], {"weight": Arg(_r(30, 4)),
                                     "bias": Arg(_r(31, 4))}),
    ("group_norm", lambda: [Arg(_r(32, 2, 3, 3, 4)), 2],
     {"data_format": "NHWC"}),
    ("normalize", lambda: [X], {}),
    ("local_response_norm", lambda: [Arg(_r(33, 2, 6, 3, 3)), 3], {}),
    ("local_response_norm", lambda: [Arg(_r(33, 2, 3, 3, 6)), 4],
     {"data_format": "NHWC", "alpha": 0.1, "k": 2.0}),
]


@pytest.mark.parametrize("name,build,kwargs", NORMS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(NORMS)])
def test_norm_matches_jax(name, build, kwargs, request):
    check_fn(name, build(), kwargs, grad=_grad(request))


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_batch_norm_training_updates_running_stats_as_jax(data_format):
    x = _r(34, 6, 3, 4, 3) * 3 + 1
    mean = (np.arange(3, dtype=np.float32) * 0.1)
    var = np.full(3, 2.0, np.float32)
    jm, jv = paddle.to_tensor(mean), paddle.to_tensor(var)
    tm, tv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    jout = jF.batch_norm(paddle.to_tensor(x), jm, jv, training=True,
                         momentum=0.8, data_format=data_format)
    tout = tF.batch_norm(torch.from_numpy(x), tm, tv, training=True,
                         momentum=0.8, data_format=data_format)
    _close(tout, _np(jout), ELEMENTWISE)
    _close(tm, _np(jm), ELEMENTWISE, "running mean")
    _close(tv, _np(jv), ELEMENTWISE, "running variance (biased)")


def _labels(seed, n, c, ignore=None):
    lab = np.random.RandomState(seed).randint(0, c, n)
    if ignore is not None:
        lab[::3] = ignore
    return lab


LOGITS = Arg(_r(35, 6, 5))
PROB = Arg(1 / (1 + np.exp(-_r(36, 6, 5))))
TARGET = (np.random.RandomState(37).rand(6, 5) > 0.5).astype(np.float32)

LOSSES = [
    ("cross_entropy", lambda: [LOGITS, _labels(1, 6, 5)], {}),
    ("cross_entropy", lambda: [LOGITS, _labels(1, 6, 5)[:, None]],
     {"reduction": "sum"}),
    ("cross_entropy", lambda: [LOGITS, _labels(2, 6, 5, -100)],
     {"reduction": "none"}),
    ("cross_entropy", lambda: [LOGITS, _labels(2, 6, 5, 3)],
     {"ignore_index": 3}),
    ("cross_entropy", lambda: [LOGITS, _labels(3, 6, 5, -100)],
     {"weight": np.linspace(0.5, 2, 5).astype(np.float32)}),
    ("cross_entropy", lambda: [LOGITS, np.full((6, 5), 0.2, np.float32)],
     {"soft_label": True}),
    ("cross_entropy", lambda: [Arg(_r(38, 2, 5, 4)),
                               _labels(4, 8, 5).reshape(2, 1, 4)],
     {"axis": 1}),
    ("cross_entropy", lambda: [PROB, _labels(5, 6, 5)],
     {"use_softmax": False}),
    ("softmax_with_cross_entropy", lambda: [LOGITS,
                                            _labels(6, 6, 5)[:, None]], {}),
    ("mse_loss", lambda: [LOGITS, TARGET], {}),
    ("l1_loss", lambda: [LOGITS, TARGET], {"reduction": "sum"}),
    ("nll_loss", lambda: [LOGITS, _labels(7, 6, 5, -100)],
     {"weight": np.linspace(0.5, 2, 5).astype(np.float32)}),
    ("binary_cross_entropy", lambda: [PROB, TARGET], {}),
    ("binary_cross_entropy_with_logits", lambda: [LOGITS, TARGET], {}),
    ("binary_cross_entropy_with_logits", lambda: [LOGITS, TARGET],
     {"pos_weight": np.full(5, 2.0, np.float32),
      "weight": np.linspace(0.5, 2, 5).astype(np.float32)}),
    ("kl_div", lambda: [LOGITS, np.full((6, 5), 0.2, np.float32)], {}),
    ("kl_div", lambda: [LOGITS, np.full((6, 5), 0.2, np.float32)],
     {"reduction": "batchmean"}),
    ("smooth_l1_loss", lambda: [LOGITS, TARGET], {"delta": 0.5}),
    ("margin_ranking_loss", lambda: [Arg(_r(39, 6)), Arg(_r(40, 6)),
                                     np.sign(_r(41, 6))], {"margin": 0.1}),
    ("hinge_embedding_loss", lambda: [LOGITS, np.sign(_r(42, 6, 5))], {}),
    ("cosine_embedding_loss", lambda: [Arg(_r(43, 6, 5)), Arg(_r(44, 6, 5)),
                                       np.sign(_r(45, 6))], {"margin": 0.2}),
    ("triplet_margin_loss", lambda: [Arg(_r(46, 6, 5)), Arg(_r(47, 6, 5)),
                                     Arg(_r(48, 6, 5))], {}),
    ("triplet_margin_loss", lambda: [Arg(_r(46, 6, 5)), Arg(_r(47, 6, 5)),
                                     Arg(_r(48, 6, 5))],
     {"swap": True, "p": 1.0}),
    ("log_loss", lambda: [PROB, TARGET], {}),
    ("square_error_cost", lambda: [LOGITS, TARGET], {}),
    ("sigmoid_focal_loss", lambda: [LOGITS, TARGET], {}),
    ("dice_loss", lambda: [Arg(np.full((4, 3), 1 / 3, np.float32)),
                           _labels(8, 4, 3)[:, None]], {}),
    ("soft_margin_loss", lambda: [LOGITS, np.sign(_r(49, 6, 5))], {}),
    ("multi_label_soft_margin_loss", lambda: [LOGITS, TARGET], {}),
    ("poisson_nll_loss", lambda: [LOGITS, np.abs(_r(50, 6, 5)) * 3],
     {"full": True}),
    ("gaussian_nll_loss", lambda: [LOGITS, TARGET,
                                   np.abs(_r(51, 6, 5)) + 0.1],
     {"full": True}),
]


@pytest.mark.parametrize("name,build,kwargs", LOSSES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(LOSSES)])
def test_loss_matches_jax(name, build, kwargs, request):
    check_fn(name, build(), kwargs, tol=REDUCING, grad=_grad(request))


def test_cross_entropy_mean_divides_by_the_labels_kept():
    logits = torch.zeros(4, 3)
    lab = torch.tensor([0, -100, -100, 1])
    got = tF.cross_entropy(logits, lab)
    _close(got, np.log(3.0), 1e-6)


def test_ctc_loss_matches_jax():
    logits = Arg(_r(52, 12, 2, 5))
    labels = np.array([[1, 2, 2], [3, 1, 0]], np.int32)
    check_fn("ctc_loss", [logits, labels, np.array([12, 10], np.int32),
                          np.array([3, 2], np.int32)], tol=REDUCING)


CONVS = [
    ("conv1d", [(2, 3, 9), (4, 3, 3)], {"stride": 2, "padding": 1}),
    ("conv1d", [(2, 9, 3), (4, 3, 3)], {"padding": "SAME",
                                        "data_format": "NLC"}),
    ("conv2d", [(2, 4, 7, 6), (6, 2, 3, 3)], {"groups": 2, "padding": 1}),
    ("conv2d", [(2, 3, 7, 6), (4, 3, 3, 2)], {"stride": 2,
                                              "padding": "SAME"}),
    ("conv2d", [(2, 3, 7, 6), (4, 3, 3, 3)], {"padding": [1, 0, 2, 1],
                                              "dilation": 2}),
    ("conv2d", [(2, 7, 6, 3), (4, 3, 3, 3)], {"padding": "VALID",
                                              "data_format": "NHWC"}),
    ("conv3d", [(1, 2, 5, 4, 4), (3, 2, 3, 2, 2)], {"padding": 1,
                                                    "stride": [1, 2, 1]}),
    ("conv1d_transpose", [(2, 3, 5), (3, 4, 3)], {"stride": 2,
                                                  "padding": 1}),
    ("conv2d_transpose", [(2, 4, 5, 4), (4, 2, 3, 3)],
     {"stride": 2, "padding": 1, "output_padding": 1}),
    ("conv2d_transpose", [(2, 4, 5, 4), (4, 3, 3, 3)],
     {"stride": 2, "groups": 2, "padding": [1, 0, 0, 2]}),
    ("conv2d_transpose", [(2, 4, 5, 4), (4, 2, 3, 2)],
     {"stride": [2, 1], "padding": [0, 0], "dilation": 2}),
    ("conv3d_transpose", [(1, 2, 3, 3, 2), (2, 3, 2, 2, 2)],
     {"stride": 2}),
]


@pytest.mark.parametrize("name,shapes,kwargs", CONVS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CONVS)])
def test_conv_matches_jax(name, shapes, kwargs, request):
    x, w = shapes
    out_c = w[1] * kwargs.get("groups", 1) if "transpose" in name else w[0]
    check_fn(name, [Arg(_r(53, *x)), Arg(_r(54, *w) * 0.3),
                    Arg(_r(55, out_c))], kwargs, tol=REDUCING,
             grad=_grad(request))


@pytest.mark.parametrize("stride,k,dilation", [(2, 3, 1), (3, 2, 1),
                                               (2, 3, 2)])
def test_conv_transpose_string_padding(stride, k, dilation):
    """Paddle's ``"SAME"`` (``in * stride`` outputs, the full output's
    middle) and ``"VALID"`` (no padding).  The JAX package raises on
    string padding of a transposed conv (ROADMAP C)."""
    x, w = torch.randn(1, 2, 5, 4), torch.randn(2, 3, k, k)
    full = tF.conv2d_transpose(x, w, stride=stride, dilation=dilation)
    same = tF.conv2d_transpose(x, w, stride=stride, padding="SAME",
                               dilation=dilation)
    assert tuple(same.shape[2:]) == (5 * stride, 4 * stride)
    lo = max(dilation * (k - 1) + 1 - stride, 0) // 2
    full0 = torch.nn.functional.pad(full, [0, stride] * 2)   # zeros past
    _close(same, full0[..., lo:lo + 5 * stride, lo:lo + 4 * stride], 1e-6)
    _close(tF.conv2d_transpose(x, w, stride=stride, padding="VALID",
                               dilation=dilation), full, 0)


POOLS = [
    ("avg_pool1d", (2, 3, 9), [3], {"stride": 2, "padding": 1}),
    ("avg_pool2d", (2, 3, 7, 6), [3], {"stride": 2, "padding": 1}),
    ("avg_pool2d", (2, 3, 7, 6), [3], {"stride": 2, "padding": 1,
                                       "exclusive": False}),
    ("avg_pool2d", (2, 3, 7, 6), [[3, 2]], {"padding": [1, 0, 0, 1]}),
    ("avg_pool2d", (2, 7, 6, 3), [2], {"padding": "SAME",
                                       "data_format": "NHWC"}),
    ("max_pool2d", (2, 3, 7, 6), [3], {"stride": 2, "padding": 1}),
    ("max_pool2d", (2, 3, 7, 6), [3], {"stride": 2, "padding": [2, 1]}),
    ("max_pool2d", (2, 3, 7, 6), [2], {"stride": 2, "return_mask": True}),
    ("max_pool2d", (2, 3, 8, 8), [2], {"stride": 2, "padding": 1,
                                       "return_mask": True}),
    ("max_pool3d", (1, 2, 4, 4, 4), [2], {"return_mask": True}),
    ("adaptive_avg_pool1d", (2, 3, 9), [3], {}),
    ("adaptive_avg_pool2d", (2, 3, 7, 6), [[3, 4]], {}),
    ("adaptive_avg_pool2d", (2, 6, 4, 3), [2], {"data_format": "NHWC"}),
    ("adaptive_max_pool2d", (2, 3, 7, 6), [[3, 4]], {}),
    ("adaptive_max_pool3d", (1, 2, 4, 5, 4), [2], {}),
]


@pytest.mark.parametrize("name,shape,args,kwargs", POOLS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(POOLS)])
def test_pool_matches_jax(name, shape, args, kwargs, request):
    check_fn(name, [Arg(_r(56, *shape))] + args, kwargs, tol=REDUCING,
             grad=_grad(request))


def test_avg_pool_divisor_override():
    x = torch.ones(1, 1, 4, 4)
    _close(tF.avg_pool2d(x, 2, divisor_override=2), np.full((1, 1, 2, 2),
                                                             2.0), 0)


def test_pool_ceil_mode_keeps_the_windows_past_the_end():
    """The JAX package reads no ``ceil_mode`` (ROADMAP C): held to its
    definition, the windows that start inside the input kept."""
    x = torch.arange(25.0).reshape(1, 1, 5, 5)
    out = tF.max_pool2d(x, 2, stride=2, ceil_mode=True)
    _close(out[0, 0], [[6, 8, 9], [16, 18, 19], [21, 23, 24]], 0)
    avg = tF.avg_pool2d(x, 2, stride=2, ceil_mode=True)
    assert avg[0, 0, 2, 2] == 24.0          # exclusive: one element inside
    out, mask = tF.max_pool2d(x, 2, stride=2, ceil_mode=True,
                              return_mask=True)
    flat = x.reshape(1, 1, -1)
    _close(flat.gather(2, mask.reshape(1, 1, -1)).reshape(out.shape), out,
           0)


@pytest.mark.parametrize("nd,padding", [(1, 0), (2, 1)])
def test_max_unpool_matches_jax(nd, padding):
    shape = (2, 3) + (6,) * nd
    x = _r(57, *shape)
    pool = getattr(jF, f"max_pool{nd}d")
    jout, jmask = pool(paddle.to_tensor(x), 2, stride=2, padding=padding,
                       return_mask=True)
    tout, tmask = getattr(tF, f"max_pool{nd}d")(
        torch.from_numpy(x), 2, stride=2, padding=padding, return_mask=True)
    np.testing.assert_array_equal(_np(tmask), _np(jmask))
    name = f"max_unpool{nd}d"
    ju = getattr(jF, name)(jout, jmask, 2, stride=2, padding=padding)
    tu = getattr(tF, name)(tout, tmask, 2, stride=2, padding=padding)
    _close(tu, _np(ju), 0)
    layer = getattr(tnn, f"MaxUnPool{nd}D")(2, stride=2, padding=padding)
    _close(layer(tout, tmask), _np(ju), 0)


EXTRAS = [
    ("diag_embed", lambda: [Arg(_r(58, 2, 3))], {"offset": 1}),
    ("diag_embed", lambda: [Arg(_r(58, 2, 3))], {"offset": -1, "dim1": 0,
                                                 "dim2": 2}),
    ("bilinear", lambda: [Arg(_r(59, 4, 3)), Arg(_r(60, 4, 5)),
                          Arg(_r(61, 2, 3, 5)), Arg(_r(62, 2))], {}),
    ("affine_grid", lambda: [Arg(_r(63, 2, 2, 3)), [2, 1, 4, 5]], {}),
    ("affine_grid", lambda: [Arg(_r(63, 2, 2, 3)), [2, 1, 4, 5]],
     {"align_corners": False}),
    ("grid_sample", lambda: [Arg(_r(64, 2, 3, 5, 6)),
                             Arg(_r(65, 2, 4, 3, 2) * 0.8)], {}),
    ("grid_sample", lambda: [Arg(_r(64, 2, 3, 5, 6)),
                             Arg(_r(65, 2, 4, 3, 2) * 1.5)],
     {"padding_mode": "border", "align_corners": False}),
    ("grid_sample", lambda: [Arg(_r(64, 2, 3, 5, 6)),
                             np.round(_r(65, 2, 4, 3, 2) * 8) / 8],
     {"mode": "nearest"}),
    ("hsigmoid_loss", lambda: [Arg(_r(66, 4, 6)), np.array([0, 2, 4, 1]), 5,
                               Arg(_r(67, 4, 6)), Arg(_r(68, 4, 1))], {}),
    ("margin_cross_entropy", lambda: [Arg(np.tanh(_r(69, 4, 6))),
                                      _labels(9, 4, 6)], {"scale": 8.0}),
]


@pytest.mark.parametrize("name,build,kwargs", EXTRAS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(EXTRAS)])
def test_extras_match_jax(name, build, kwargs, request):
    check_fn(name, build(), kwargs, tol=REDUCING, grad=_grad(request))


def test_hsigmoid_custom_tree_matches_jax():
    table = np.array([[0, 1, -1], [0, 2, 3], [1, -1, -1]], np.int64)
    code = np.array([[1, 0, 0], [0, 1, 1], [1, 0, 0]], np.int64)
    check_fn("hsigmoid_loss", [Arg(_r(70, 3, 4)), np.array([0, 1, 2]), 5,
                               Arg(_r(71, 4, 4)), None],
             {"path_table": table, "path_code": code}, tol=REDUCING)


def test_gather_tree_and_sparse_attention_match_jax():
    ids = np.random.RandomState(72).randint(0, 9, (4, 2, 3))
    parents = np.random.RandomState(73).randint(0, 3, (4, 2, 3))
    check_fn("gather_tree", [ids, parents])
    b, h, s, d = 1, 2, 4, 8
    offs = np.tile(np.array([0, 2, 3, 5, 8], np.int32), (b, h, 1))
    cols = np.tile(np.array([0, 1, 1, 0, 2, 1, 2, 3], np.int32), (b, h, 1))
    check_fn("sparse_attention", [Arg(_r(74, b, h, s, d)),
                                  Arg(_r(75, b, h, s, d)),
                                  Arg(_r(76, b, h, s, d)), offs, cols],
             tol=REDUCING)


def test_sequence_mask_matches_jax():
    lens = np.array([[1, 3], [0, 2]])
    check_fn("sequence_mask", [lens], {"maxlen": 4})
    check_fn("sequence_mask", [lens], {"dtype": "float32"})


# -- dropout laws ------------------------------------------------------------


@pytest.mark.parametrize("name,shape,mask_axes", [
    ("dropout2d", (64, 32, 3, 3), (2, 3)),
    ("dropout3d", (32, 32, 2, 2, 2), (2, 3, 4)),
])
def test_channel_dropout_keeps_whole_channels(name, shape, mask_axes):
    trng.seed(0)
    out = getattr(tF, name)(torch.ones(shape), p=0.25)
    per_channel = out.amax(dim=mask_axes)
    assert torch.equal(out.amin(dim=mask_axes), per_channel)
    kept = float((per_channel > 0).float().mean())
    assert abs(kept - 0.75) < 0.05
    _close(per_channel[per_channel > 0].unique(), [1 / 0.75], 1e-6)
    x = torch.ones(shape)
    assert getattr(tF, name)(x, p=0.25, training=False) is x


def test_alpha_dropout_keeps_mean_and_variance():
    trng.seed(1)
    x = torch.randn(200000)
    y = tF.alpha_dropout(x, 0.2)
    assert abs(float(y.mean())) < 0.02 and abs(float(y.std()) - 1) < 0.02
    assert tF.alpha_dropout(x, 0.2, training=False) is x


# -- layers ------------------------------------------------------------------


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _pair(name, *args, seed=0, **kwargs):
    """The JAX layer ``name`` built from a seed, and the port's with the
    JAX layer's state carried over."""
    paddle.seed(seed)
    jl = getattr(jnn, name)(*args, **kwargs)
    tl = getattr(tnn, name)(*args, **kwargs)
    tl.load_state_dict(port_state_dict_from_jax(tl, _state(jl)))
    return jl, tl


def check_layer(jl, tl, inputs, tol=ELEMENTWISE, grad=True, train=False):
    """Outputs, and with ``grad`` the input and parameter gradients (the
    JAX ones carried into the port's layouts)."""
    if not train:
        jl.eval()
        tl.eval()
    jargs, targs, jgrad, tgrad = _inputs(inputs)
    jout, tout = jl(*jargs), tl(*targs)
    _close(tout, _np(jout), tol, type(tl).__name__)
    if not grad:
        return
    _backward_both(jout, tout)
    for j, t in zip(jgrad, tgrad):
        _close(t.grad, _np(j.grad), tol, "input grad")
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jl.named_parameters()
          if p.grad is not None}
    state = {**_state(jl), **jg}
    want = port_state_dict_from_jax(tl, state)
    for n, p in tl.named_parameters():
        if n in jg:
            _close(p.grad, want[n], tol, f"{n} grad")


LAYERS = [
    ("Linear", (5, 3), {}, lambda: [Arg(_r(80, 4, 5))], ELEMENTWISE),
    ("Linear", (5, 3), {"bias_attr": False}, lambda: [Arg(_r(80, 4, 5))],
     ELEMENTWISE),
    ("Embedding", (6, 4), {"padding_idx": 2},
     lambda: [np.array([[0, 2, 5], [1, 2, 3]])], ELEMENTWISE),
    ("Bilinear", (3, 4, 2), {}, lambda: [Arg(_r(81, 5, 3)),
                                         Arg(_r(82, 5, 4))], REDUCING),
    ("PReLU", (4,), {}, lambda: [X4], ELEMENTWISE),
    ("LayerNorm", ([4, 5],), {}, lambda: [Arg(_r(83, 2, 4, 5))],
     ELEMENTWISE),
    ("GroupNorm", (2, 4), {}, lambda: [X4], ELEMENTWISE),
    ("InstanceNorm2D", (4,), {}, lambda: [X4], ELEMENTWISE),
    ("RMSNorm", (8,), {}, lambda: [X], ELEMENTWISE),
    ("Conv2D", (4, 6, 3), {"stride": 2, "padding": "SAME", "groups": 2},
     lambda: [X4], REDUCING),
    ("Conv1DTranspose", (3, 2, 3), {"stride": 2, "padding": 1},
     lambda: [Arg(_r(84, 2, 3, 5))], REDUCING),
    ("Conv3D", (2, 3, 2), {}, lambda: [Arg(_r(85, 1, 2, 3, 4, 4))],
     REDUCING),
    ("HSigmoidLoss", (4, 6), {}, lambda: [Arg(_r(86, 3, 4)),
                                          np.array([0, 5, 3])], REDUCING),
]


#: the layers whose forward alone is compared (their functionals' math is
#: held above; each JAX backward costs a compile)
FORWARD_ONLY = {"PReLU", "GroupNorm", "InstanceNorm2D", "RMSNorm", "Conv3D"}


@pytest.mark.parametrize("name,args,kwargs,build,tol", LAYERS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(LAYERS)])
def test_layer_matches_jax(name, args, kwargs, build, tol):
    jl, tl = _pair(name, *args, **kwargs)
    check_layer(jl, tl, build(), tol, grad=name not in FORWARD_ONLY)


@pytest.mark.parametrize("name,shape", [("BatchNorm1D", (6, 3, 4)),
                                        ("BatchNorm2D", (6, 3, 4, 4)),
                                        ("BatchNorm3D", (4, 3, 2, 3, 3))])
def test_batch_norm_layers_train_and_eval_as_jax(name, shape):
    jl, tl = _pair(name, 3)
    x = Arg(_r(87, *shape) * 2 + 1)
    check_layer(jl, tl, [x], grad=True, train=True)
    _close(tl._mean, _np(jl._mean), ELEMENTWISE, "_mean")
    _close(tl._variance, _np(jl._variance), ELEMENTWISE, "_variance")
    check_layer(jl, tl, [Arg(_r(88, *shape))], grad=False)


FORWARD_LAYERS = [
    ("MaxPool2D", (3,), {"stride": 2, "padding": 1}, (2, 3, 7, 6)),
    ("AvgPool1D", (2,), {}, (2, 3, 8)),
    ("AdaptiveAvgPool2D", (3,), {}, (2, 3, 7, 6)),
    ("AdaptiveMaxPool2D", ([2, 3],), {}, (2, 3, 6, 6)),
    ("Upsample", (), {"scale_factor": 2, "mode": "bilinear"}, (1, 2, 3, 4)),
    ("UpsamplingNearest2D", (), {"size": [5, 6]}, (1, 2, 3, 4)),
    ("Pad2D", ([1, 0, 2, 1],), {"mode": "replicate"}, (1, 2, 3, 4)),
    ("Flatten", (), {}, (2, 3, 4)),
    ("Softmax2D", (), {}, (2, 3, 4, 4)),
    ("LocalResponseNorm", (3,), {}, (2, 5, 3, 3)),
    ("PixelShuffle", (2,), {}, (1, 8, 2, 2)),
    ("Unfold", ([2, 2],), {}, (1, 2, 4, 4)),
    ("GELU", (), {"approximate": True}, (3, 4)),
    ("LeakyReLU", (0.3,), {}, (3, 4)),
    ("Maxout", (2,), {}, (2, 4, 3)),
    ("Dropout", (0.3,), {}, (3, 4)),
    ("Identity", (), {}, (3, 4)),
]


@pytest.mark.parametrize("name,args,kwargs,shape", FORWARD_LAYERS,
                         ids=[c[0] for c in FORWARD_LAYERS])
def test_stateless_layer_matches_jax(name, args, kwargs, shape):
    jl, tl = _pair(name, *args, **kwargs)
    check_layer(jl, tl, [_r(89, *shape)], REDUCING, grad=False)


LOSS_LAYERS = [
    ("CrossEntropyLoss", {"ignore_index": 1}, lambda: [
        LOGITS, _labels(10, 6, 5)]),
    ("MSELoss", {}, lambda: [LOGITS, TARGET]),
    ("BCEWithLogitsLoss", {"reduction": "sum"}, lambda: [LOGITS, TARGET]),
    ("SmoothL1Loss", {"delta": 0.3}, lambda: [LOGITS, TARGET]),
    ("KLDivLoss", {"reduction": "batchmean"},
     lambda: [LOGITS, np.full((6, 5), 0.2, np.float32)]),
    ("TripletMarginLoss", {"margin": 0.5},
     lambda: [Arg(_r(90, 4, 5)), Arg(_r(91, 4, 5)), Arg(_r(92, 4, 5))]),
]


@pytest.mark.parametrize("name,kwargs,build", LOSS_LAYERS,
                         ids=[c[0] for c in LOSS_LAYERS])
def test_loss_layer_matches_jax(name, kwargs, build):
    jl, tl = _pair(name, **kwargs)
    check_layer(jl, tl, build(), REDUCING, grad=False)


# -- containers and the Layer API ------------------------------------------


def test_containers():
    seq = tnn.Sequential(tnn.Linear(4, 4), tnn.ReLU(), tnn.Linear(4, 2))
    assert len(seq) == 3 and isinstance(seq[1], tnn.ReLU)
    assert len(seq[1:]) == 2
    assert seq(torch.randn(3, 4)).shape == (3, 2)
    named = tnn.Sequential([("a", tnn.Linear(2, 2)), ("b", tnn.Tanh())])
    assert [n for n, _ in named.named_children()] == ["a", "b"]
    ll = tnn.LayerList([tnn.Linear(2, 2)])
    ll.append(tnn.Linear(2, 3)).extend([tnn.Linear(3, 1)])
    ll.insert(0, tnn.Identity())
    assert len(ll) == 4 and isinstance(ll[0], tnn.Identity)
    assert isinstance(ll[-1], tnn.Linear) and ll[-1].out_features == 1
    assert [n for n, _ in ll.named_parameters()][:2] == ["1.weight",
                                                         "1.bias"]
    ld = tnn.LayerDict({"x": tnn.ReLU()})
    ld["y"] = tnn.Tanh()
    assert list(ld.keys()) == ["x", "y"] and "y" in ld
    assert isinstance(ld.pop("x"), tnn.ReLU) and len(ld) == 1
    pl = tnn.ParameterList([tnn.Parameter(torch.zeros(2))])
    pl.append(tnn.Parameter(torch.ones(3)))
    assert len(pl) == 2 and pl[1].shape == (3,)
    assert len(list(pl.parameters())) == 2


class _Net(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(4, 8)
        self.fc2 = tnn.Linear(8, 2)

    def forward(self, x):
        return self.fc2(tF.relu(self.fc1(x)))


def test_layer_api_registration_state_and_hooks():
    """``tests/test_nn.py::TestLayerBase`` on the port."""
    net = _Net()
    names = [n for n, _ in net.named_parameters()]
    assert names == ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]
    assert set(net.state_dict()) == set(names)
    net2 = _Net()
    missing, unexpected = net2.set_state_dict(
        {k: v.numpy() for k, v in net.state_dict().items()})
    assert missing == [] and unexpected == []
    _close(net2.fc1.weight, _np(net.fc1.weight), 0)
    with pytest.raises(ValueError):
        net2.set_state_dict({"fc1.weight": np.zeros((3, 3), np.float32)})
    assert len(net.sublayers()) == 2 and net.sublayers(True)[0] is net
    assert isinstance(net.parameters(), list)
    assert len(net.parameters(include_sublayers=False)) == 0
    calls = []
    h1 = net.fc1.register_forward_pre_hook(lambda l, i: calls.append("pre"))
    h2 = net.fc1.register_forward_post_hook(
        lambda l, i, o: calls.append("post"))
    net(torch.ones(1, 4))
    h1.remove()
    h2.remove()
    net(torch.ones(1, 4))
    assert calls == ["pre", "post"]
    net.to(dtype="bfloat16")
    assert net.fc1.weight.dtype == torch.bfloat16
    net.astype("float32")
    assert net.fc1.weight.dtype == torch.float32
    seq = tnn.Sequential(tnn.Linear(4, 4), tnn.Dropout(0.5))
    seq.eval()
    x = torch.ones(2, 4)
    assert not seq[1].training and torch.equal(seq[1](x), x)
    bn = tnn.BatchNorm1D(4)
    assert {"_mean", "_variance"} <= set(dict(bn.named_buffers()))
    assert {"_mean", "_variance"} <= set(bn.state_dict())
    layer = tnn.Layer()
    layer.register_buffer("kept", torch.ones(2))
    layer.register_buffer("scratch", torch.ones(2), persistable=False)
    assert list(layer.state_dict()) == ["kept"]
    assert net.full_name().startswith("_net_")
    net(torch.ones(1, 4)).sum().backward()
    net.clear_gradients()
    assert all(p.grad is None for p in net.parameters())


def test_create_parameter_attrs_and_global_initializer():
    layer = tnn.Layer()
    reg = treg.L2Decay(0.1)
    p = layer.create_parameter(
        [3, 2], attr=tnn.ParamAttr(initializer=tI.Constant(2.0),
                                   trainable=False, need_clip=False,
                                   regularizer=reg, learning_rate=0.5))
    assert not p.requires_grad and not p.need_clip and p.regularizer is reg
    assert p.optimize_attr == {"learning_rate": 0.5}
    _close(p, np.full((3, 2), 2.0), 0)
    assert layer.create_parameter([2], attr=False) is None
    assert torch.equal(layer.create_parameter([2], is_bias=True),
                       torch.zeros(2))
    tI.set_global_initializer(tI.Constant(3.0), tI.Constant(4.0))
    try:
        lin = tnn.Linear(2, 2)
        assert torch.equal(lin.weight, torch.full((2, 2), 3.0))
        assert torch.equal(lin.bias, torch.full((2,), 4.0))
        lin = tnn.Linear(2, 2, weight_attr=tI.Constant(1.0))
        assert torch.equal(lin.weight, torch.ones(2, 2))
    finally:
        tI.set_global_initializer(None)
    value = np.arange(6, dtype=np.float32).reshape(2, 3)   # Paddle [in, out]
    lin = tnn.Linear(2, 3, weight_attr=tnn.ParamAttr(
        initializer=tI.Assign(value)))
    _close(lin.weight, value.T, 0)



def test_layers_default_to_the_card_and_raise_without_one(monkeypatch):
    """With no ``set_device``, a layer is built on the card: with none
    present, its parameters and buffers refuse to be made, and so does
    ``set_device("gpu")``; the CPU is taken only when asked for."""
    monkeypatch.setattr(tdevice, "_current", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tnn.Linear(2, 2), lambda: tnn.BatchNorm1D(2),
                  lambda: tnn.TransformerEncoderLayer(8, 2, 16),
                  lambda: tnn.Transformer.generate_square_subsequent_mask(2),
                  tdevice.get_device):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    for name in ("gpu", "gpu:1", "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdevice.set_device(name)
    with pytest.raises(ValueError, match="unsupported device"):
        tdevice.set_device("tpu")
    assert tnn.Linear(2, 2, device="cpu").weight.device.type == "cpu"
    with tdevice.device_guard("cpu") as d:
        assert d == torch.device("cpu") and tdevice.get_device() == "cpu"
        assert tnn.BatchNorm1D(2)._mean.device.type == "cpu"
    assert tdevice._current is None
    assert tdevice.set_device("cpu") == torch.device("cpu")
    assert tnn.Linear(2, 2).weight.device.type == "cpu"


# -- initializers -------------------------------------------------------------


def _draw(init, shape=(400, 300)):
    return _np(init(list(shape), generator=torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("init,mean,std", [
    (tI.Normal(0.5, 2.0), 0.5, 2.0),
    (tI.Uniform(-1.0, 3.0), 1.0, 4 / 12 ** 0.5),
    (tI.TruncatedNormal(0.0, 1.0), 0.0, 0.8796),
    # fans of Paddle's [in, out] = [400, 300]
    (tI.XavierUniform(), 0.0, (2 / 700) ** 0.5),
    (tI.XavierNormal(gain=2.0), 0.0, 2 * (2 / 700) ** 0.5),
    (tI.KaimingUniform(), 0.0, (2 / 400) ** 0.5),
    (tI.KaimingNormal(nonlinearity="leaky_relu", negative_slope=0.5), 0.0,
     (2 / 1.25 / 400) ** 0.5),
])
def test_initializer_laws(init, mean, std):
    w = _draw(init)
    assert abs(w.mean() - mean) < 0.02 * max(std, 1)
    assert abs(w.std() - std) < 0.02 * std


def test_initializer_bounds_and_fixed_values():
    assert np.abs(_draw(tI.TruncatedNormal(1.0, 0.5))) .max() <= 2.0
    limit = (6 / 700) ** 0.5
    assert np.abs(_draw(tI.XavierUniform())).max() <= limit
    q = _draw(tI.Orthogonal(2.0), (6, 4))
    _close(q.T @ q, 4 * np.eye(4), 1e-5)
    q = _draw(tI.Orthogonal(), (3, 5))
    _close(q @ q.T, np.eye(3), 1e-5)
    d = _draw(tI.Dirac(), (3, 2, 3, 3))
    assert d.sum() == 2 and d[0, 0, 1, 1] == 1 and d[1, 1, 1, 1] == 1
    _close(_draw(tI.Assign([[1, 2], [3, 4]]), (4,)), [1, 2, 3, 4], 0)
    for name in ("tanh", "relu", "leaky_relu", "selu", "sigmoid"):
        assert tI.calculate_gain(name) == pytest.approx(
            jnn.initializer.calculate_gain(name))
    want = np.asarray(jnn.initializer.Bilinear()([2, 2, 4, 3], "float32"))
    _close(_draw(tI.Bilinear(), (2, 2, 4, 3)), want, 1e-6)
    want = np.asarray(jnn.initializer.Dirac(2)([4, 2, 3], "float32"))
    _close(_draw(tI.Dirac(2), (4, 2, 3)), want, 0)


def test_linear_fans_are_paddles():
    """A Linear of 100 inputs and 4 outputs: Kaiming's fan is 100 (the
    port's weight is [out, in], drawn as Paddle's [in, out])."""
    lin = tnn.Linear(400, 20, weight_attr=tI.KaimingNormal())
    assert abs(float(lin.weight.std()) - (2 / 400) ** 0.5) < 0.02 * 0.07
    trng.seed(5)
    a = tnn.Linear(4, 3).weight.detach().clone()
    trng.seed(5)
    assert torch.equal(tnn.Linear(4, 3).weight, a)


# -- utils, regularizers, weights carried across ----------------------------


def test_parameters_to_vector_round_trip():
    net = _Net()
    vec = tnn.utils.parameters_to_vector(net.parameters())
    assert vec.shape == (4 * 8 + 8 + 8 * 2 + 2,)
    tnn.utils.vector_to_parameters(vec * 2, net.parameters())
    _close(tnn.utils.parameters_to_vector(net.parameters()), _np(vec) * 2,
           0)


@pytest.mark.parametrize("dim", [0, 1])
def test_weight_norm_linear_matches_jax(dim):
    """``dim`` names Paddle's ``[in, out]`` dim; the JAX state dict
    (``weight_g``, a transposed ``weight_v``) carries into the port."""
    jl, tl = _pair("Linear", 4, 3)
    jnn.utils.weight_norm(jl, "weight", dim=dim)
    tnn.utils.weight_norm(tl, "weight", dim=dim)
    assert tuple(tl.weight_g.shape) == tuple(jl.weight_g.shape)
    tl.load_state_dict(port_state_dict_from_jax(tl, _state(jl)))
    check_layer(jl, tl, [Arg(_r(93, 2, 4))])
    w = tl.weight.detach().clone()
    tnn.utils.remove_weight_norm(tl)
    assert "weight" in dict(tl.named_parameters())
    _close(tl.weight, _np(w), 1e-6)


def test_weight_and_spectral_norm_of_a_conv_match_jax():
    jl, tl = _pair("Conv2D", 2, 3, 3)
    jnn.utils.weight_norm(jl, "weight", dim=0)
    tnn.utils.weight_norm(tl, "weight", dim=0)
    tl.load_state_dict(port_state_dict_from_jax(tl, _state(jl)))
    check_layer(jl, tl, [_r(94, 1, 2, 5, 5)], REDUCING, grad=False)
    for name, dim in (("Linear", 0), ("Conv2D", 1)):
        args = (4, 3) if name == "Linear" else (2, 3, 3)
        jl, tl = _pair(name, *args, seed=3)
        jnn.utils.spectral_norm(jl, dim=dim)
        tnn.utils.spectral_norm(tl, dim=dim)
        tl.load_state_dict(port_state_dict_from_jax(tl, _state(jl)))
        x = _r(95, 2, 4) if name == "Linear" else _r(95, 1, 2, 5, 5)
        check_layer(jl, tl, [x], REDUCING, grad=False)


def test_regularizer_grad_terms():
    p = torch.tensor([-2.0, 0.0, 3.0])
    _close(treg.L1Decay(0.5)._grad_term(p), [-0.5, 0.0, 0.5], 0)
    _close(treg.L2Decay(0.5)._grad_term(p), [-1.0, 0.0, 1.5], 0)
    assert treg.L2Decay(0.25).coeff == 0.25


@pytest.mark.parametrize("opt", ["SGD", "Momentum"])
@pytest.mark.parametrize("decay", ["L1Decay", "L2Decay"])
def test_optimizer_regularizers_match_jax(opt, decay):
    """Three steps of SGD / Momentum with ``weight_decay=L1Decay`` or
    ``L2Decay`` against the JAX optimizer."""
    jl, tl = _pair("Linear", 4, 3, seed=4)
    jreg = getattr(paddle.regularizer, decay)(0.05)
    kw = {"momentum": 0.9} if opt == "Momentum" else {}
    jopt = getattr(paddle.optimizer, opt)(learning_rate=0.1,
                                          parameters=jl.parameters(),
                                          weight_decay=jreg, **kw)
    topt = {"SGD": SGD, "Momentum": Momentum}[opt](
        tl.parameters(), lr=0.1, weight_decay=getattr(treg, decay)(0.05),
        **kw)
    x, y = _r(96, 5, 4), _r(97, 5, 3)
    for _ in range(3):
        jloss = ((jl(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        tloss = ((tl(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
        tloss.backward()
        topt.step()
        topt.clear_grad()
    want = port_state_dict_from_jax(tl, _state(jl))
    for n, p in tl.named_parameters():
        _close(p, want[n], ELEMENTWISE, n)


def test_param_attr_regularizer_is_not_read_by_the_optimizer():
    """A ``ParamAttr(regularizer=)`` is stored on its parameter, and SGD
    with ``weight_decay=L2Decay`` decays it as the JAX optimizer does
    (which reads only its own ``weight_decay``)."""
    def build(m, reg):
        return m.Linear(2, 2, weight_attr=m.ParamAttr(
            initializer=m.initializer.Constant(1.0),
            regularizer=reg.L1Decay(1.0)))

    paddle.seed(0)
    jl, tl = build(jnn, paddle.regularizer), build(tnn, treg)
    tl.load_state_dict(port_state_dict_from_jax(tl, _state(jl)))
    assert isinstance(tl.weight.regularizer, treg.L1Decay)
    jopt = paddle.optimizer.SGD(learning_rate=1.0,
                                parameters=jl.parameters(),
                                weight_decay=paddle.regularizer.L2Decay(0.5))
    topt = SGD(tl.parameters(), lr=1.0, weight_decay=treg.L2Decay(0.5))
    x = _r(100, 3, 2)
    (jl(paddle.to_tensor(x)) * 0.0).sum().backward()
    jopt.step()
    (tl(torch.from_numpy(x)) * 0.0).sum().backward()
    topt.step()
    want = port_state_dict_from_jax(tl, _state(jl))
    for n, p in tl.named_parameters():
        _close(p, want[n], ELEMENTWISE, n)
    _close(tl.weight, np.full((2, 2), 0.5), 0)        # 1 - 0.5 * 1


def test_port_state_dict_carries_a_batch_norm_net_and_refuses_misfits():
    paddle.seed(0)
    jnet = jnn.Sequential(jnn.Conv2D(2, 4, 3, padding=1), jnn.BatchNorm2D(4),
                          jnn.ReLU(), jnn.Flatten(), jnn.Linear(4 * 16, 3))
    tnet = tnn.Sequential(tnn.Conv2D(2, 4, 3, padding=1), tnn.BatchNorm2D(4),
                          tnn.ReLU(), tnn.Flatten(), tnn.Linear(4 * 16, 3))
    x = paddle.to_tensor(_r(98, 3, 2, 4, 4))
    jnet(x)                                  # training: running stats move
    state = _state(jnet)
    assert "1._mean" in state and "1._variance" in state
    tnet.load_state_dict(port_state_dict_from_jax(tnet, state))
    _close(tnet[1]._variance, state["1._variance"], 0)
    check_layer(jnet, tnet, [_r(99, 3, 2, 4, 4)], REDUCING, grad=False)
    with pytest.raises(ValueError, match="missing"):
        port_state_dict_from_jax(tnet, {k: v for k, v in state.items()
                                        if k != "1._mean"})
    with pytest.raises(ValueError, match="unexpected"):
        port_state_dict_from_jax(tnet, {**state, "extra": np.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        port_state_dict_from_jax(tnet, {**state,
                                        "4.weight": np.zeros((3, 64))})


def test_port_nn_exports_every_jax_name_but_step_3b():
    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), type(np))}

    assert names(jnn) - names(tnn) == STEP_3B
    assert names(jF) - names(tF) == {"op", "nondiff"}   # JAX op helpers
    assert names(jnn.initializer) - names(tI) == set()
    assert names(jnn.utils) - names(tnn.utils) <= {"Layer", "Parameter",
                                                   "Tensor"}
    assert {"L1Decay", "L2Decay"} <= names(treg)
