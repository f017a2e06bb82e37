"""Inception v3 (port of ``paddle_tpu/vision/models/inceptionv3.py``):
the A/B/C/D/E block stack; the input must be at least 75 × 75."""
from ... import nn
from ...ops.manipulation import concat, flatten
from ._pretrained import no_pretrained
from .googlenet import _ConvBN

__all__ = ["InceptionV3", "inception_v3"]


def _cat(xs):
    return concat(xs, axis=1)


class _InceptionA(nn.Layer):
    def __init__(self, in_c, pool_c):
        super().__init__()
        self.b1 = _ConvBN(in_c, 64, 1)
        self.b5 = nn.Sequential(_ConvBN(in_c, 48, 1),
                                _ConvBN(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_ConvBN(in_c, 64, 1),
                                _ConvBN(64, 96, 3, padding=1),
                                _ConvBN(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _ConvBN(in_c, pool_c, 1))

    def forward(self, x):
        return _cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)])


class _InceptionB(nn.Layer):  # reduction
    def __init__(self, in_c):
        super().__init__()
        self.b3 = _ConvBN(in_c, 384, 3, stride=2)
        self.b33 = nn.Sequential(_ConvBN(in_c, 64, 1),
                                 _ConvBN(64, 96, 3, padding=1),
                                 _ConvBN(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return _cat([self.b3(x), self.b33(x), self.pool(x)])


class _InceptionC(nn.Layer):
    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = _ConvBN(in_c, 192, 1)
        self.b7 = nn.Sequential(
            _ConvBN(in_c, c7, 1),
            _ConvBN(c7, c7, (1, 7), padding=(0, 3)),
            _ConvBN(c7, 192, (7, 1), padding=(3, 0)))
        self.b77 = nn.Sequential(
            _ConvBN(in_c, c7, 1),
            _ConvBN(c7, c7, (7, 1), padding=(3, 0)),
            _ConvBN(c7, c7, (1, 7), padding=(0, 3)),
            _ConvBN(c7, c7, (7, 1), padding=(3, 0)),
            _ConvBN(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _ConvBN(in_c, 192, 1))

    def forward(self, x):
        return _cat([self.b1(x), self.b7(x), self.b77(x), self.bp(x)])


class _InceptionD(nn.Layer):  # reduction
    def __init__(self, in_c):
        super().__init__()
        self.b3 = nn.Sequential(_ConvBN(in_c, 192, 1),
                                _ConvBN(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            _ConvBN(in_c, 192, 1),
            _ConvBN(192, 192, (1, 7), padding=(0, 3)),
            _ConvBN(192, 192, (7, 1), padding=(3, 0)),
            _ConvBN(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return _cat([self.b3(x), self.b7(x), self.pool(x)])


class _InceptionE(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b1 = _ConvBN(in_c, 320, 1)
        self.b3_stem = _ConvBN(in_c, 384, 1)
        self.b3_a = _ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.b33_stem = nn.Sequential(_ConvBN(in_c, 448, 1),
                                      _ConvBN(448, 384, 3, padding=1))
        self.b33_a = _ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b33_b = _ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _ConvBN(in_c, 192, 1))

    def forward(self, x):
        s3 = self.b3_stem(x)
        s33 = self.b33_stem(x)
        return _cat([
            self.b1(x),
            _cat([self.b3_a(s3), self.b3_b(s3)]),
            _cat([self.b33_a(s33), self.b33_b(s33)]),
            self.bp(x),
        ])


class InceptionV3(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _ConvBN(3, 32, 3, stride=2), _ConvBN(32, 32, 3),
            _ConvBN(32, 64, 3, padding=1), nn.MaxPool2D(3, stride=2),
            _ConvBN(64, 80, 1), _ConvBN(80, 192, 3),
            nn.MaxPool2D(3, stride=2))
        self.blocks = nn.Sequential(
            _InceptionA(192, 32), _InceptionA(256, 64),
            _InceptionA(288, 64),
            _InceptionB(288),
            _InceptionC(768, 128), _InceptionC(768, 160),
            _InceptionC(768, 160), _InceptionC(768, 192),
            _InceptionD(768),
            _InceptionE(1280), _InceptionE(2048))
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return InceptionV3(**kwargs)
