"""The port's ResNet and vision datasets against the JAX package's, on the
CPU.

A JAX ``resnet18(num_classes=10)`` is carried across by
``models.port_state_dict_from_jax`` (the one conversion of a JAX state
dict: convs as they are, ``fc`` transposed, the batch norms'
``_mean``/``_variance`` into the port's running stats) and held at
32×32, batch 2: the eval and train-mode forwards (and the running stats a
train-mode forward leaves), one step's loss and gradients in either mode,
and three batches of ``Model.fit`` (Momentum 0.9 with ``L2Decay``) on
``FakeData`` (at 64×64, for the reason its test gives).
``FakeData``'s images are bitwise the JAX one's; the file parsers
(MNIST idx, CIFAR pickle tarballs, ``DatasetFolder``) read tiny files
this test writes, against the JAX parsers on the same files.
Tolerances are stated where they are used.
"""
import gzip
import io as pyio
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import metric as jmetric
from paddle_tpu import regularizer as jreg
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.hapi.model import Model as JaxModel
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import models as jmodels
import paddle_tpu_torch as paddle
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.models import port_state_dict_from_jax
from paddle_tpu_torch.vision import datasets as tds

torch.set_num_threads(2)

#: f32 convolutions through different libraries (XLA's and torch's)
FWD_TOL = 1e-4
#: train mode at batch 2 normalises layer4's 1x1 maps over two values a
#: channel, which magnifies f32 rounding: against an f64 forward of the
#: same weights the port's f32 logits are off by 4.0e-3 and the JAX
#: package's by 1.5e-3 (scale 3.5), so the two are held at 3e-3 of scale
TRAIN_TOL = 3e-3
#: eval-mode gradients through 18 layers of them, of each tensor's scale
GRAD_TOL = 1e-3
#: train-mode gradients at batch 2: against f64 gradients of the same
#: weights and batch the port's f32 ones are off by 7.5e-3 of scale and
#: the JAX package's by 1.1e-2, so the two are held at 2e-2 of scale
TRAIN_GRAD_TOL = 2e-2


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


def _twins(seed=3):
    jpaddle.seed(seed)
    jnet = jmodels.resnet18(num_classes=10)
    tnet = paddle.vision.resnet18(num_classes=10)
    sd = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    tnet.load_state_dict(port_state_dict_from_jax(tnet, sd))
    return jnet, tnet


def _batch(seed=0, n=2):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 3, 32, 32).astype(np.float32),
            rs.randint(0, 10, n).astype(np.int64))


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs diff {err} (scale {scale})"


def test_conversion_names_and_layouts():
    jnet, tnet = _twins()
    sd = port_state_dict_from_jax(
        tnet, {k: np.asarray(v.numpy()) for k, v in
               jnet.state_dict().items()})
    assert set(sd) == set(tnet.state_dict())
    np.testing.assert_array_equal(_np(sd["fc.weight"]),
                                  np.asarray(jnet.fc.weight.numpy()).T)
    np.testing.assert_array_equal(_np(sd["layer1.0.bn1._variance"]),
                                  np.asarray(jnet.layer1[0].bn1._variance
                                             .numpy()))


def test_eval_forward():
    jnet, tnet = _twins()
    jnet.eval()
    tnet.eval()
    x, _ = _batch()
    _close(_np(tnet(torch.tensor(x))), _np(jnet(jpaddle.to_tensor(x))),
           FWD_TOL, "eval logits")


def test_train_forward_and_running_stats():
    jnet, tnet = _twins()
    jnet.train()
    tnet.train()
    x, _ = _batch(1)
    _close(_np(tnet(torch.tensor(x))), _np(jnet(jpaddle.to_tensor(x))),
           TRAIN_TOL, "train logits")
    for name in ("bn1._mean", "bn1._variance", "layer4.1.bn2._mean",
                 "layer4.1.bn2._variance"):
        _close(_np(tnet.state_dict()[name]),
               np.asarray(jnet.state_dict()[name].numpy()), TRAIN_TOL, name)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_one_step_loss_and_grads(mode):
    jnet, tnet = _twins()
    getattr(jnet, mode)()
    getattr(tnet, mode)()
    x, y = _batch(2)
    jloss = jnn.functional.cross_entropy(jnet(jpaddle.to_tensor(x)),
                                         jpaddle.to_tensor(y))
    jloss.backward()
    tloss = paddle.nn.functional.cross_entropy(tnet(torch.tensor(x)),
                                               torch.tensor(y))
    tloss.backward()
    fwd, grad = ((FWD_TOL, GRAD_TOL) if mode == "eval"
                 else (TRAIN_TOL, TRAIN_GRAD_TOL))
    _close(_np(tloss), _np(jloss), fwd, "loss")
    jp = dict(jnet.named_parameters())
    for name, p in tnet.named_parameters():
        g = _np(p.grad)
        want = np.asarray(jp[name].grad.numpy())
        if name == "fc.weight":
            want = want.T
        _close(g, want, grad, f"grad {name}")


class _Losses:
    def setup(self):
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(np.asarray(logs["loss"]).reshape(-1)[0]))


class JaxLosses(_Losses, jcb.Callback):
    def __init__(self):
        super().__init__()
        self.setup()


class TorchLosses(_Losses, tcb.Callback):
    def __init__(self):
        super().__init__()
        self.setup()


def test_three_batch_fit_on_fakedata():
    """Momentum 0.9 and ``L2Decay(1e-4)`` (PaddleClas's ResNet50 recipe)
    at lr 1e-4 through both ``Model.fit``s over the same three batches of
    ``FakeData``: the losses agree at 1e-3 relative.  The images are
    64×64: at 32×32 layer4's maps are 1×1 and a train-mode batch norm of
    batch 2 normalises two values a channel, where f32 rounding alone
    moves the loss of the same weights by 25% (3.70 against 4.68 on the
    second batch, at lr 1e-5); at 64×64 it normalises eight, and a larger
    rate turns the gradients' f32 noise (``TRAIN_GRAD_TOL``) into weights
    that differ more from step to step."""
    jnet, tnet = _twins()
    jm = JaxModel(jnet)
    jm.prepare(optimizer=jopt.Momentum(1e-4, 0.9, jnet.parameters(),
                                       weight_decay=jreg.L2Decay(1e-4)),
               loss=jnn.CrossEntropyLoss(),
               metrics=jmetric.Accuracy(topk=(1, 5)))
    tm = paddle.Model(tnet)
    tm.prepare(optimizer=topt.Momentum(tnet.parameters(), lr=1e-4,
                                       momentum=0.9,
                                       weight_decay=treg.L2Decay(1e-4)),
               loss=paddle.nn.CrossEntropyLoss(),
               metrics=tmetric.Accuracy(topk=(1, 5)))
    jrec, trec = JaxLosses(), TorchLosses()
    kw = dict(batch_size=2, epochs=1, verbose=0, shuffle=False)
    jm.fit(jds.FakeData(6, (3, 64, 64), 10), callbacks=[jrec], **kw)
    tm.fit(tds.FakeData(6, (3, 64, 64), 10), callbacks=[trec], **kw)
    assert len(trec.losses) == 3
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-3)


def test_fakedata_bitwise():
    j, t = jds.FakeData(5, (3, 8, 8), 4), tds.FakeData(5, (3, 8, 8), 4)
    assert len(j) == len(t) == 5
    for i in range(5):
        (ji, jl), (ti, tl) = j[i], t[i]
        assert ji.dtype == ti.dtype == np.float32
        np.testing.assert_array_equal(ti, ji)
        assert tl == jl and isinstance(tl, np.int64)


def _idx_files(root, n=5):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.uint8)
    ip, lp = (os.path.join(root, "train-images-idx3-ubyte.gz"),
              os.path.join(root, "train-labels-idx1-ubyte.gz"))
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return ip, lp


def _cifar_tar(path, members):
    with tarfile.open(path, "w:gz") as tar:
        for name, payload in members.items():
            data = pickle.dumps(payload)
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, pyio.BytesIO(data))


def _same(tds_obj, jds_obj):
    assert len(tds_obj) == len(jds_obj)
    for i in range(len(jds_obj)):
        (ti, tl), (ji, jl) = tds_obj[i], jds_obj[i]
        np.testing.assert_array_equal(ti, ji)
        assert int(tl) == int(jl)


def test_dataset_parsers(tmp_path):
    ip, lp = _idx_files(str(tmp_path))
    _same(tds.MNIST(image_path=ip, label_path=lp),
          jds.MNIST(image_path=ip, label_path=lp))
    _same(tds.FashionMNIST(image_path=ip, label_path=lp),
          jds.FashionMNIST(image_path=ip, label_path=lp))
    rs = np.random.RandomState(1)

    def batch(n, key):
        return {b"data": rs.randint(0, 256, (n, 3072)).astype(np.uint8),
                key: rs.randint(0, 10, n).tolist()}

    c10 = str(tmp_path / "cifar-10-python.tar.gz")
    _cifar_tar(c10, {"cifar-10-batches-py/data_batch_1": batch(3, b"labels"),
                     "cifar-10-batches-py/data_batch_2": batch(2, b"labels"),
                     "cifar-10-batches-py/test_batch": batch(2, b"labels")})
    for mode in ("train", "test"):
        _same(tds.Cifar10(c10, mode=mode), jds.Cifar10(c10, mode=mode))
    c100 = str(tmp_path / "cifar-100-python.tar.gz")
    _cifar_tar(c100, {"cifar-100-python/train": batch(4, b"fine_labels"),
                      "cifar-100-python/test": batch(2, b"fine_labels")})
    for mode in ("train", "test"):
        _same(tds.Cifar100(c100, mode=mode), jds.Cifar100(c100, mode=mode))
    for c, n in (("cat", 2), ("dog", 3)):
        os.makedirs(tmp_path / "folder" / c)
        for i in range(n):
            np.save(tmp_path / "folder" / c / f"{i}.npy",
                    rs.rand(2, 2).astype(np.float32))
    (tmp_path / "folder" / "dog" / "skip.txt").write_text("not an image")
    tf, jf = (tds.DatasetFolder(str(tmp_path / "folder")),
              jds.DatasetFolder(str(tmp_path / "folder")))
    assert tf.class_to_idx == jf.class_to_idx == {"cat": 0, "dog": 1}
    _same(tf, jf)
    with pytest.raises(FileNotFoundError):
        tds.MNIST(image_path=str(tmp_path / "absent.gz"), download=True)
    with pytest.raises(FileNotFoundError):
        tds.Cifar10(str(tmp_path / "absent.tar.gz"), download=True)


def test_every_depth_builds_with_jax_names():
    """A basic-block depth and a grouped bottleneck variant have the JAX
    model's parameter names and shapes (the port's built on the meta
    device; the JAX inits are most of the time), and ResNet-50 has its
    published 25,557,032 parameters."""
    for fn in ("resnet34", "resnext50_32x4d"):
        jnet = getattr(jmodels, fn)(num_classes=7)
        with torch.device("meta"), paddle.device_guard("cpu"):
            tnet = getattr(paddle.vision, fn)(num_classes=7)
        want = {k: tuple(v.shape) for k, v in jnet.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in tnet.state_dict().items()}
        got["fc.weight"] = got["fc.weight"][::-1]
        assert got == want, fn
    net = paddle.vision.resnet50()
    assert sum(p.numel() for p in net.parameters()) == 25557032
