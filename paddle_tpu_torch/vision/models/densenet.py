"""DenseNet 121/161/169/201/264 (port of
``paddle_tpu/vision/models/densenet.py``): dense blocks whose layers
concatenate their growth onto their input, joined by average-pooling
transitions."""
from ... import nn
from ...ops.manipulation import concat, flatten
from ._pretrained import no_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFG = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class _DenseLayer(nn.Layer):
    def __init__(self, in_c, growth, bn_size, dropout):
        super().__init__()
        self.bn1 = nn.BatchNorm2D(in_c)
        self.conv1 = nn.Conv2D(in_c, bn_size * growth, 1, bias_attr=False)
        self.bn2 = nn.BatchNorm2D(bn_size * growth)
        self.conv2 = nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                               bias_attr=False)
        self.relu = nn.ReLU()
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        y = self.conv1(self.relu(self.bn1(x)))
        y = self.conv2(self.relu(self.bn2(y)))
        if self.dropout is not None:
            y = self.dropout(y)
        return concat([x, y], axis=1)


class _Transition(nn.Layer):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.bn = nn.BatchNorm2D(in_c)
        self.conv = nn.Conv2D(in_c, out_c, 1, bias_attr=False)
        self.relu = nn.ReLU()
        self.pool = nn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(nn.Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True):
        super().__init__()
        if layers not in _CFG:
            raise ValueError(f"layers must be one of {sorted(_CFG)}")
        init_c, growth, blocks = _CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = nn.Conv2D(3, init_c, 7, stride=2, padding=3,
                               bias_attr=False)
        self.bn1 = nn.BatchNorm2D(init_c)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        c = init_c
        stages = []
        for i, n in enumerate(blocks):
            for _ in range(n):
                stages.append(_DenseLayer(c, growth, bn_size, dropout))
                c += growth
            if i != len(blocks) - 1:
                stages.append(_Transition(c, c // 2))
                c //= 2
        self.features = nn.Sequential(*stages)
        self.bn2 = nn.BatchNorm2D(c)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(c, num_classes)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.relu(self.bn2(self.features(x)))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _make(layers, pretrained, **kwargs):
    no_pretrained(pretrained)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kw):
    return _make(121, pretrained, **kw)


def densenet161(pretrained=False, **kw):
    return _make(161, pretrained, **kw)


def densenet169(pretrained=False, **kw):
    return _make(169, pretrained, **kw)


def densenet201(pretrained=False, **kw):
    return _make(201, pretrained, **kw)


def densenet264(pretrained=False, **kw):
    return _make(264, pretrained, **kw)
