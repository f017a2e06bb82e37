"""MobileNet v1 and v2 (port of ``paddle_tpu/vision/models/mobilenet.py``):
depthwise-separable blocks with ReLU6, the v2 ones inverted residuals;
``scale`` widens or narrows every layer."""
from ... import nn
from ...ops.manipulation import flatten
from ._pretrained import no_pretrained

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


class ConvBNLayer(nn.Layer):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, groups=1,
                 act=True):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.act = nn.ReLU6() if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c1, out_c2, stride, scale=1.0):
        super().__init__()
        c1 = int(out_c1 * scale)
        c2 = int(out_c2 * scale)
        self.dw = ConvBNLayer(in_c, c1, 3, stride, 1, groups=in_c)
        self.pw = ConvBNLayer(c1, c2, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)

        self.conv1 = ConvBNLayer(3, s(32), 3, 2, 1)
        cfg = [
            (s(32), 32, 64, 1), (s(64), 64, 128, 2), (s(128), 128, 128, 1),
            (s(128), 128, 256, 2), (s(256), 256, 256, 1),
            (s(256), 256, 512, 2), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 1024, 2), (s(1024), 1024, 1024, 1),
        ]
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(in_c, c1, c2, st, scale)
            for in_c, c1, c2, st in cfg
        ])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden, 1))
        layers += [
            ConvBNLayer(hidden, hidden, 3, stride, 1, groups=hidden),
            ConvBNLayer(hidden, oup, 1, act=False),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        in_c = int(32 * scale)
        layers = [ConvBNLayer(3, in_c, 3, 2, 1)]
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                layers.append(InvertedResidual(in_c, out_c,
                                               s if i == 0 else 1, t))
                in_c = out_c
        last = int(1280 * max(1.0, scale))
        layers.append(ConvBNLayer(in_c, last, 1))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
