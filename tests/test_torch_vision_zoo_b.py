"""The port's MobileNetV3 and SqueezeNet 1.1 against the JAX package's,
on the CPU (``tests/torch_zoo.py`` has the checks and their tolerances).

MobileNetV3 small and large at ``scale=0.35`` and SqueezeNet 1.1, 10
classes, batch 2 of 32 × 32; one train step each of MobileNetV3 small and
SqueezeNet 1.1 at batch 4 of 64 × 64.

The slice as a whole: MobileNetV3 small at ``scale=0.35`` trained through
both packages' ``Model.fit`` over ``DatasetFolder`` with augmenting
transforms, from the JAX model's weights, every dropout at p = 0.  Both
read the same eight seeded uint8 images (sides 72-96, four class
folders) through their own ``RandomResizedCrop(64)``,
``RandomHorizontalFlip``, ``ToTensor`` and ``Normalize`` after the same
``random.seed``, so both see the same crops and flips (the transforms are
bitwise equal: ``tests/test_torch_transforms.py``), in two batches of 4
with no loader workers; Momentum 0.9 at lr 0.01 with ``L2Decay(1e-4)``.
The two losses agree within ``LOSS_TOL``.  It shares this file with the
train step so that the JAX package's ops at batch 4 of 64 × 64 compile
once.
"""
import os
import random

import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.hapi.model import Model as JaxModel
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import models as J
from paddle_tpu.vision import transforms as JT
import paddle_tpu_torch as paddle
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import models as T
from paddle_tpu_torch.vision import transforms as TT

import torch_zoo as Z

torch.set_num_threads(2)

#: one forward of the same weights on the same batch, then one after a
#: step whose gradients differ by up to 1.2e-4 of their scale
#: (``torch_zoo.GRAD_TOL``'s measurement) at lr 0.01; measured: 1.0e-7 and
#: 0.0 relative
LOSS_TOL = 1e-4

FAMILIES = {
    "mobilenet_v3_small": (
        lambda: J.mobilenet_v3_small(scale=0.35, num_classes=10),
        lambda: T.mobilenet_v3_small(scale=0.35, num_classes=10),
        (2, 3, 32, 32)),
    "mobilenet_v3_large": (
        lambda: J.mobilenet_v3_large(scale=0.35, num_classes=10),
        lambda: T.mobilenet_v3_large(scale=0.35, num_classes=10),
        (2, 3, 32, 32)),
    "squeezenet1_1": (lambda: J.squeezenet1_1(num_classes=10),
                      lambda: T.squeezenet1_1(num_classes=10),
                      (2, 3, 32, 32)),
}
TRAIN = ("mobilenet_v3_small", "squeezenet1_1")


@pytest.fixture(scope="module", autouse=True)
def _single_device():
    saved = mesh_mod.get_global_mesh()
    mesh_mod.set_global_mesh(None)
    with paddle.device_guard("cpu"):
        yield
    mesh_mod.set_global_mesh(saved)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    jmake, tmake, shape = FAMILIES[request.param]
    return request.param, Z.Twins(jmake, tmake), shape


def test_names_and_shapes(family):
    Z.check_names(family[1])


def test_eval_logits(family):
    Z.check_eval(*family[1:])


def test_train_step(family):
    name, tw, _ = family
    if name in TRAIN:
        Z.check_train_step(tw, (4, 3, 64, 64), 10)


def test_mobilenet_v3_large_counts_its_parameters():
    """At full width and 1000 classes: 5,483,032 parameters, as the JAX
    model has (5,507,432 with the norms' buffers)."""
    with torch.device("meta"), paddle.device_guard("cpu"):
        net = T.mobilenet_v3_large(num_classes=1000)
    assert sum(p.numel() for p in net.parameters()) == 5_483_032
    assert sum(v.numel() for v in net.state_dict().values()) == 5_507_432


@pytest.mark.parametrize("make", ["mobilenet_v3_small",
                                  "mobilenet_v3_large", "squeezenet1_1"])
def test_pretrained_raises(make):
    with pytest.raises(NotImplementedError):
        getattr(T, make)(pretrained=True)


def _write_images(root, n=8, folders=4, sides=(72, 96)):
    rs = np.random.RandomState(0)
    for i in range(n):
        h, w = rs.randint(sides[0], sides[1] + 1, 2)
        d = os.path.join(root, f"class{i % folders}")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"{i}.npy"),
                rs.randint(0, 256, (h, w, 3), dtype=np.uint8))


def _train_set(tr, ds, root):
    return ds.DatasetFolder(root, transform=tr.Compose([
        tr.RandomResizedCrop(64), tr.RandomHorizontalFlip(), tr.ToTensor(),
        tr.Normalize(mean=[0.485, 0.456, 0.406],
                     std=[0.229, 0.224, 0.225])]))


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


def test_mobilenet_v3_small_fit_on_an_augmenting_folder(tmp_path):
    root = str(tmp_path / "images")
    _write_images(root)
    tw = Z.Twins(*FAMILIES["mobilenet_v3_small"][:2])
    Z.no_dropout(tw.jnet, jnn.Dropout)
    Z.no_dropout(tw.tnet, paddle.nn.Dropout)
    jm = JaxModel(tw.jnet)
    jm.prepare(optimizer=jopt.Momentum(
        0.01, 0.9, tw.jnet.parameters(), weight_decay=jreg.L2Decay(1e-4)),
        loss=jnn.CrossEntropyLoss())
    tm = paddle.Model(tw.tnet)
    tm.prepare(optimizer=topt.Momentum(
        tw.tnet.parameters(), lr=0.01, momentum=0.9,
        weight_decay=treg.L2Decay(1e-4)), loss=paddle.nn.CrossEntropyLoss())
    kw = dict(batch_size=4, epochs=1, verbose=0, shuffle=False,
              num_workers=0)
    jrec, trec = JaxLosses(), TorchLosses()
    random.seed(3)
    jm.fit(_train_set(JT, jds, root), callbacks=[jrec], **kw)
    after_jax = random.random()
    random.seed(3)
    tm.fit(_train_set(TT, tds, root), callbacks=[trec], **kw)
    assert random.random() == after_jax      # the same draws, in order
    assert len(trec.losses) == len(jrec.losses) == 2
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=LOSS_TOL)
