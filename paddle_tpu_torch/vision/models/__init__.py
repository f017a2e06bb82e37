"""The vision model zoo of the port (``paddle_tpu/vision/models``): ResNet,
LeNet, AlexNet, VGG, MobileNet v1/v2/v3, SqueezeNet, ShuffleNetV2,
DenseNet, GoogLeNet and Inception v3, with the JAX models' module names
(``models.port_state_dict_from_jax`` carries their weights across)."""
from .resnet import (
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, resnext50_64x4d,
    resnext101_32x4d, resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
    wide_resnet50_2, wide_resnet101_2,
)
from .lenet import LeNet
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2
from .alexnet import AlexNet, alexnet
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .densenet import (
    DenseNet, densenet121, densenet161, densenet169, densenet201,
    densenet264,
)
from .shufflenetv2 import (
    ShuffleNetV2, shufflenet_v2_x0_25, shufflenet_v2_x0_33,
    shufflenet_v2_x0_5, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0, shufflenet_v2_swish,
)
from .googlenet import GoogLeNet, googlenet
from .inceptionv3 import InceptionV3, inception_v3
from .mobilenetv3 import (
    MobileNetV3Small, MobileNetV3Large, mobilenet_v3_small,
    mobilenet_v3_large,
)
import sys as _sys

_FILES = ("resnet", "lenet", "vgg", "mobilenet", "alexnet", "squeezenet",
          "densenet", "shufflenetv2", "googlenet", "inceptionv3",
          "mobilenetv3")
__all__ = [name for f in _FILES
           for name in _sys.modules[f"{__name__}.{f}"].__all__]
