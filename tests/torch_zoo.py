"""What the zoo test files share (``tests/test_torch_vision_zoo_*.py``): a
JAX zoo model and its port with the same weights, and the checks that hold
the port to it on the CPU.

A JAX model is built once a family (its build and first forward take most
of the time), its ``state_dict()`` carried into the port's model by
``models.port_state_dict_from_jax``.  The checks compare the parameter and
buffer names and shapes (the port's model built on the meta device), the
eval-mode outputs, and one train-mode step's loss and gradients.  Inputs
are seeded numpy; every tolerance is relative to the largest magnitude of
what it compares.  The JAX side of those two checks runs its model as one
program (``paddle_tpu.jit.to_static``): op by op it would compile each op
of the model apart, which took most of these files' time.
"""
import numpy as np
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as paddle
from paddle_tpu_torch.models import port_state_dict_from_jax

#: f32 convolutions and matmuls through two libraries (XLA's and torch's),
#: of the outputs' scale
FWD_TOL = 1e-4
#: one train step's gradients at batch 4 of 64 x 64 (the last maps 2 x 2):
#: the worst difference is 2.8e-5 of a tensor's scale for MobileNetV3
#: small and 1.2e-4 for ShuffleNetV2 (at batch 2 of 32 x 32 a train-mode
#: batch norm of 1 x 1 maps sees two values a channel, its gradients reach
#: 640 and f32 rounding alone moves them by 6.6%: too ill-conditioned to
#: compare, as for ResNet in ``test_torch_vision.py``)
GRAD_TOL = 1e-3
#: the bias of a batch norm that feeds another through a linear map has a
#: zero gradient in exact arithmetic (the second norm removes a shift), so
#: its f32 value is noise (6.5e-8 where MobileNetV3 small's largest
#: gradient is 0.62): each gradient's scale is at least this share of the
#: model's largest gradient
NOISE = 1e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.numpy())


def close(got, want, tol, what, floor=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs diff {err} (scale {scale})"


class Twins:
    """A JAX zoo model (``jmake()`` after ``paddle_tpu.seed(0)``) and the
    port's (``tmake()`` on the CPU) carrying its weights."""

    def __init__(self, jmake, tmake):
        jpaddle.seed(0)
        self.jnet = jmake()
        self.tmake = tmake
        with paddle.device_guard("cpu"):
            self.tnet = tmake()
        self.state = {k: np.asarray(v.numpy())
                      for k, v in self.jnet.state_dict().items()}
        self.tnet.load_state_dict(port_state_dict_from_jax(self.tnet,
                                                           self.state))
        self.linear = {n for n, m in self.tnet.named_modules()
                       if isinstance(m, torch.nn.Linear)}

    def jax_layout(self, name, arr):
        """A port tensor in the JAX model's layout (an ``nn.Linear``
        weight transposed)."""
        if name.rpartition(".")[0] in self.linear and arr.ndim == 2:
            return arr.T
        return arr


def check_names(tw: Twins):
    """The port's model, built on the meta device, has the JAX model's
    parameter and buffer names, each of the JAX shape in the port's
    layout."""
    with torch.device("meta"), paddle.device_guard("cpu"):
        meta = tw.tmake()
    got = {k: tuple(tw.jax_layout(k, v).shape)
           for k, v in meta.state_dict().items()}
    want = {k: v.shape for k, v in tw.state.items()}
    assert got == want


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


def check_eval(tw: Twins, shape, seed=0, tol=FWD_TOL):
    """Eval-mode outputs of one seeded batch of ``shape``."""
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    tw.jnet.eval()
    tw.tnet.eval()
    with torch.no_grad():
        touts = _outs(tw.tnet(torch.tensor(x)))
    jouts = _outs(jpaddle.jit.to_static(lambda a: tw.jnet(a))(
        jpaddle.to_tensor(x)))
    assert len(touts) == len(jouts)
    for k, (t, j) in enumerate(zip(touts, jouts)):
        close(_np(t), _np(j), tol, f"eval output {k}")


def no_dropout(net, dropout_cls):
    """Every ``dropout_cls`` layer of ``net`` at p = 0."""
    for m in net.sublayers():
        if isinstance(m, dropout_cls):
            m.p = 0.0


def check_train_step(tw: Twins, shape, classes, seed=1):
    """One train-mode step (every dropout at p = 0: its bits are the
    port's own): the cross-entropy loss at ``FWD_TOL`` and each
    parameter's gradient at ``GRAD_TOL`` of its scale (at least ``NOISE``
    of the largest gradient)."""
    rs = np.random.RandomState(seed)
    x = rs.rand(*shape).astype(np.float32)
    y = rs.randint(0, classes, shape[0]).astype(np.int64)
    no_dropout(tw.jnet, jnn.Dropout)
    no_dropout(tw.tnet, paddle.nn.Dropout)
    tw.jnet.train()
    tw.tnet.train()

    def jstep(a, b):
        loss = jnn.functional.cross_entropy(tw.jnet(a), b)
        loss.backward()
        return loss

    jloss = jpaddle.jit.to_static(jstep)(jpaddle.to_tensor(x),
                                         jpaddle.to_tensor(y))
    tloss = paddle.nn.functional.cross_entropy(tw.tnet(torch.tensor(x)),
                                               torch.tensor(y))
    tloss.backward()
    close(_np(tloss), _np(jloss), FWD_TOL, "loss")
    want = {k: np.asarray(p.grad.numpy())
            for k, p in tw.jnet.named_parameters()}
    floor = NOISE * max(float(np.abs(g).max()) for g in want.values())
    for name, p in tw.tnet.named_parameters():
        close(tw.jax_layout(name, _np(p.grad)), want[name], GRAD_TOL,
              f"grad {name}", floor)
