"""The port's ShuffleNetV2 and DenseNet against the JAX package's, on the
CPU (``tests/torch_zoo.py`` has the checks and their tolerances).

ShuffleNetV2 x0.25, its swish variant (x1.0 with every ReLU a Swish) and
DenseNet-121, 10 classes, batch 2 of 32 × 32; one train step of
ShuffleNetV2 x0.25 at batch 4 of 64 × 64.
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
    "shufflenet_v2_x0_25": (lambda: J.shufflenet_v2_x0_25(num_classes=10),
                            lambda: T.shufflenet_v2_x0_25(num_classes=10),
                            (2, 3, 32, 32)),
    "shufflenet_v2_swish": (lambda: J.shufflenet_v2_swish(num_classes=10),
                            lambda: T.shufflenet_v2_swish(num_classes=10),
                            (2, 3, 32, 32)),
    "densenet121": (lambda: J.densenet121(num_classes=10),
                    lambda: T.densenet121(num_classes=10), (2, 3, 32, 32)),
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
    return request.param, Z.Twins(jmake, tmake), shape


def test_names_and_shapes(family):
    Z.check_names(family[1])


def test_eval_logits(family):
    Z.check_eval(*family[1:])


def test_train_step(family):
    name, tw, _ = family
    if name == "shufflenet_v2_x0_25":
        Z.check_train_step(tw, (4, 3, 64, 64), 10)


def test_swish_variant_has_no_relu():
    with paddle.device_guard("cpu"):
        net = T.shufflenet_v2_swish(num_classes=10)
    kinds = {type(m).__name__ for m in net.modules()}
    assert "Swish" in kinds and "ReLU" not in kinds


@pytest.mark.parametrize("make,published", [
    ("densenet121", 7_978_856), ("densenet161", 28_681_000),
    ("densenet169", 14_149_480), ("densenet201", 20_013_928),
    ("shufflenet_v2_x1_0", 2_278_604)])
def test_widths_count_their_parameters(make, published):
    """At 1000 classes the port's DenseNets and ShuffleNetV2 x1.0 have
    their published parameter counts (built on the meta device)."""
    with torch.device("meta"), paddle.device_guard("cpu"):
        net = getattr(T, make)()
    assert sum(p.numel() for p in net.parameters()) == published


@pytest.mark.parametrize("make", ["densenet264", "shufflenet_v2_x0_33",
                                  "shufflenet_v2_x2_0"])
def test_pretrained_raises(make):
    with pytest.raises(NotImplementedError):
        getattr(T, make)(pretrained=True)
