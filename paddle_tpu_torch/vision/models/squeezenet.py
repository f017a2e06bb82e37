"""SqueezeNet 1.0 and 1.1 (port of
``paddle_tpu/vision/models/squeezenet.py``): fire modules (a 1×1 squeeze,
then 1×1 and 3×3 expands concatenated) and a convolutional head."""
from ... import nn
from ...ops.manipulation import concat, flatten
from ._pretrained import no_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]

_FIRES = [(96, 16, 64, 64), (128, 16, 64, 64), (128, 32, 128, 128),
          (256, 32, 128, 128), (256, 48, 192, 192), (384, 48, 192, 192),
          (384, 64, 256, 256), (512, 64, 256, 256)]


class MakeFire(nn.Layer):
    def __init__(self, in_c, squeeze, expand1x1, expand3x3):
        super().__init__()
        self.squeeze = nn.Conv2D(in_c, squeeze, 1)
        self.relu = nn.ReLU()
        self.e1 = nn.Conv2D(squeeze, expand1x1, 1)
        self.e3 = nn.Conv2D(squeeze, expand3x3, 3, padding=1)

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return concat([self.relu(self.e1(x)), self.relu(self.e3(x))],
                      axis=1)


class SqueezeNet(nn.Layer):
    def __init__(self, version='1.0', num_classes=1000, with_pool=True):
        super().__init__()
        self.version = version
        self.num_classes = num_classes
        self.with_pool = with_pool
        fires = list(_FIRES)
        if version == '1.0':
            self.conv1 = nn.Conv2D(3, 96, 7, stride=2)
            self._pool_after = {2, 6}   # a max pool after these fires
        elif version == '1.1':
            self.conv1 = nn.Conv2D(3, 64, 3, stride=2, padding=1)
            fires[0] = (64,) + fires[0][1:]
            self._pool_after = {1, 3}
        else:
            raise ValueError(f"unsupported version {version}")
        self.relu = nn.ReLU()
        self.pool = nn.MaxPool2D(3, stride=2)
        self.fires = nn.LayerList([MakeFire(*f) for f in fires])
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.classifier = nn.Conv2D(512, num_classes, 1)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.pool(self.relu(self.conv1(x)))
        for i, fire in enumerate(self.fires):
            x = fire(x)
            if i in self._pool_after:
                x = self.pool(x)
        if self.num_classes > 0:
            x = self.relu(self.classifier(self.dropout(x)))
        if self.with_pool:
            x = flatten(self.avgpool(x), 1)
        return x


def squeezenet1_0(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet('1.0', **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet('1.1', **kwargs)
