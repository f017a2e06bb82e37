"""The port's LeNet, AlexNet, VGG, MobileNet v1/v2 and SqueezeNet 1.0
against the JAX package's, on the CPU (``tests/torch_zoo.py`` has the
checks and their tolerances).

Each family is built once, at a narrow width where it has one
(``scale=0.25``), with 10 classes, at the smallest input its strides
allow: LeNet 1 × 28 × 28, AlexNet and SqueezeNet 1.0 64 × 64, VGG-11 with
batch norm and the MobileNets 32 × 32, batch 2.  ``pretrained=True``
raises, as in the JAX package.
"""
import pytest
import torch

from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.vision import models as J
import paddle_tpu_torch as paddle
from paddle_tpu_torch.vision import models as T

import torch_zoo as Z

torch.set_num_threads(2)

FAMILIES = {
    "lenet": (lambda: J.LeNet(num_classes=10),
              lambda: T.LeNet(num_classes=10), (2, 1, 28, 28)),
    "alexnet": (lambda: J.alexnet(num_classes=10),
                lambda: T.alexnet(num_classes=10), (2, 3, 64, 64)),
    "vgg11_bn": (lambda: J.vgg11(batch_norm=True, num_classes=10),
                 lambda: T.vgg11(batch_norm=True, num_classes=10),
                 (2, 3, 32, 32)),
    "mobilenet_v1": (lambda: J.mobilenet_v1(scale=0.25, num_classes=10),
                     lambda: T.mobilenet_v1(scale=0.25, num_classes=10),
                     (2, 3, 32, 32)),
    "mobilenet_v2": (lambda: J.mobilenet_v2(scale=0.25, num_classes=10),
                     lambda: T.mobilenet_v2(scale=0.25, num_classes=10),
                     (2, 3, 32, 32)),
    "squeezenet1_0": (lambda: J.squeezenet1_0(num_classes=10),
                      lambda: T.squeezenet1_0(num_classes=10),
                      (2, 3, 64, 64)),
}


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
    return Z.Twins(jmake, tmake), shape


def test_names_and_shapes(family):
    Z.check_names(family[0])


def test_eval_logits(family):
    Z.check_eval(*family)


@pytest.mark.parametrize("make", ["alexnet", "vgg13", "vgg16", "vgg19",
                                  "mobilenet_v1", "mobilenet_v2",
                                  "squeezenet1_0"])
def test_pretrained_raises(make):
    with pytest.raises(NotImplementedError):
        getattr(T, make)(pretrained=True)


def test_vgg_depths_count_their_parameters():
    """VGG-11/13/16/19 at 1000 classes have their published parameter
    counts (the port's built on the meta device)."""
    with torch.device("meta"), paddle.device_guard("cpu"):
        counts = [sum(p.numel() for p in getattr(T, f"vgg{d}")()
                      .parameters()) for d in (11, 13, 16, 19)]
    assert counts == [132_863_336, 133_047_848, 138_357_544, 143_667_240]
