"""GoogLeNet, Inception v1 (port of
``paddle_tpu/vision/models/googlenet.py``): the forward returns the main
logits and the two auxiliary heads' ``(out, aux1, aux2)``, the heads None
when ``num_classes`` is 0."""
from ... import nn
from ...ops.manipulation import concat, flatten
from ._pretrained import no_pretrained

__all__ = ["GoogLeNet", "googlenet"]


class _ConvBN(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride,
                              padding=padding, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class _Inception(nn.Layer):
    """The v1 block: 1x1 | 1x1-3x3 | 1x1-5x5 | pool-1x1."""

    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _ConvBN(in_c, c1, 1)
        self.b3 = nn.Sequential(_ConvBN(in_c, c3r, 1),
                                _ConvBN(c3r, c3, 3, padding=1))
        self.b5 = nn.Sequential(_ConvBN(in_c, c5r, 1),
                                _ConvBN(c5r, c5, 5, padding=2))
        self.bp = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                _ConvBN(in_c, proj, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b3(x), self.b5(x), self.bp(x)],
                      axis=1)


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _ConvBN(3, 64, 7, 2, 3), nn.MaxPool2D(3, 2, padding=1),
            _ConvBN(64, 64, 1), _ConvBN(64, 192, 3, padding=1),
            nn.MaxPool2D(3, 2, padding=1))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, 2, padding=1)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, 2, padding=1)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.4)
            self.fc = nn.Linear(1024, num_classes)
            # the auxiliary heads (deep supervision in training)
            self.aux_pool = nn.AdaptiveAvgPool2D(4)
            self.aux1_conv = _ConvBN(512, 128, 1)
            self.aux1_fc1 = nn.Linear(128 * 16, 1024)
            self.aux1_fc2 = nn.Linear(1024, num_classes)
            self.aux2_conv = _ConvBN(528, 128, 1)
            self.aux2_fc1 = nn.Linear(128 * 16, 1024)
            self.aux2_fc2 = nn.Linear(1024, num_classes)
            self.relu = nn.ReLU()

    def _aux(self, x, conv, fc1, fc2):
        a = flatten(conv(self.aux_pool(x)), 1)
        return fc2(self.relu(fc1(a)))

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        aux1 = aux2 = None
        if self.num_classes > 0:
            aux1 = self._aux(x, self.aux1_conv, self.aux1_fc1,
                             self.aux1_fc2)
        x = self.i4d(self.i4c(self.i4b(x)))
        if self.num_classes > 0:
            aux2 = self._aux(x, self.aux2_conv, self.aux2_fc1,
                             self.aux2_fc2)
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(flatten(x, 1)))
        return x, aux1, aux2


def googlenet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return GoogLeNet(**kwargs)
