"""The port's GoogLeNet and Inception v3 against the JAX package's, on the
CPU (``tests/torch_zoo.py`` has the checks and their tolerances).

GoogLeNet at 64 × 64 (its main and both auxiliary heads) and Inception v3
at 80 × 80 (the smallest its strides allow is 75), 10 classes, batch 2.
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
    "googlenet": (lambda: J.googlenet(num_classes=10),
                  lambda: T.googlenet(num_classes=10), (2, 3, 64, 64)),
    "inception_v3": (lambda: J.inception_v3(num_classes=10),
                     lambda: T.inception_v3(num_classes=10),
                     (2, 3, 80, 80)),
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


def test_googlenet_without_a_head_returns_no_aux():
    with paddle.device_guard("cpu"):
        net = T.googlenet(num_classes=0)
    net.eval()
    with torch.no_grad():
        out, aux1, aux2 = net(torch.zeros(1, 3, 64, 64))
    assert tuple(out.shape) == (1, 1024, 1, 1) and aux1 is aux2 is None


@pytest.mark.parametrize("make,count", [("googlenet", 13_385_816),
                                        ("inception_v3", 23_834_568)])
def test_counts_their_parameters(make, count):
    """At 1000 classes, built on the meta device (GoogLeNet with its two
    auxiliary heads; Inception v3's is torchvision's without its
    auxiliary head)."""
    with torch.device("meta"), paddle.device_guard("cpu"):
        net = getattr(T, make)()
    assert sum(p.numel() for p in net.parameters()) == count


@pytest.mark.parametrize("make", ["googlenet", "inception_v3"])
def test_pretrained_raises(make):
    with pytest.raises(NotImplementedError):
        getattr(T, make)(pretrained=True)
