"""MobileNetV3 small and large (port of
``paddle_tpu/vision/models/mobilenetv3.py``): inverted residuals with
depthwise convolutions, Hardswish and squeeze-excite (a Hardsigmoid
gate); ``scale`` widens every layer to a multiple of 8."""
from ... import nn
from ...ops.manipulation import flatten
from ._pretrained import no_pretrained

__all__ = ["MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large"]


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _SqueezeExcite(nn.Layer):
    def __init__(self, c):
        super().__init__()
        sq = _make_divisible(c // 4)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(c, sq, 1)
        self.fc2 = nn.Conv2D(sq, c, 1)
        self.relu = nn.ReLU()
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class _InvertedResidual(nn.Layer):
    def __init__(self, in_c, exp_c, out_c, k, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        Act = nn.Hardswish if act == "hardswish" else nn.ReLU
        if exp_c != in_c:
            layers += [nn.Conv2D(in_c, exp_c, 1, bias_attr=False),
                       nn.BatchNorm2D(exp_c), Act()]
        layers += [
            nn.Conv2D(exp_c, exp_c, k, stride=stride, padding=k // 2,
                      groups=exp_c, bias_attr=False),
            nn.BatchNorm2D(exp_c), Act()]
        if use_se:
            layers.append(_SqueezeExcite(exp_c))
        layers += [nn.Conv2D(exp_c, out_c, 1, bias_attr=False),
                   nn.BatchNorm2D(out_c)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        y = self.block(x)
        return x + y if self.use_res else y


# (kernel, expand, out, use_se, act, stride)
_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class MobileNetV3(nn.Layer):
    def __init__(self, config, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_c = _make_divisible(16 * scale)
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, in_c, 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(in_c), nn.Hardswish())
        blocks = []
        for k, exp, out, se, act, s in config:
            exp_c = _make_divisible(exp * scale)
            out_c = _make_divisible(out * scale)
            blocks.append(_InvertedResidual(in_c, exp_c, out_c, k, s, se,
                                            act))
            in_c = out_c
        self.blocks = nn.Sequential(*blocks)
        # the last block's expansion width, as the reference takes it
        last_exp = _make_divisible(config[-1][1] * scale)
        self.conv2 = nn.Sequential(
            nn.Conv2D(in_c, last_exp, 1, bias_attr=False),
            nn.BatchNorm2D(last_exp), nn.Hardswish())
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_exp, last_channel), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_channel, num_classes))

    def forward(self, x):
        x = self.conv2(self.blocks(self.conv1(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_LARGE, 1280, scale, num_classes, with_pool)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_SMALL, 1024, scale, num_classes, with_pool)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)
