"""ShuffleNetV2 at every published width (port of
``paddle_tpu/vision/models/shufflenetv2.py``): split-transform-concat
blocks and a channel shuffle of two groups."""
from ... import nn
from ...ops.manipulation import concat, flatten, reshape, transpose
from ._pretrained import no_pretrained

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]

_STAGE_OUT = {
    0.25: (24, 24, 48, 96, 512),
    0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}
_REPEATS = (4, 8, 4)


def _channel_shuffle(x, groups):
    n, c, h, w = x.shape
    x = reshape(x, [n, groups, c // groups, h, w])
    x = transpose(x, [0, 2, 1, 3, 4])
    return reshape(x, [n, c, h, w])


class _ConvBNReLU(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, padding=0, groups=1,
                 act=True):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.act = nn.ReLU() if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class _InvertedResidual(nn.Layer):
    def __init__(self, in_c, out_c, stride):
        super().__init__()
        self.stride = stride
        branch_c = out_c // 2
        if stride == 1:
            self.branch2 = nn.Sequential(
                _ConvBNReLU(in_c // 2, branch_c, 1),
                _ConvBNReLU(branch_c, branch_c, 3, stride, 1,
                            groups=branch_c, act=False),
                _ConvBNReLU(branch_c, branch_c, 1),
            )
        else:
            self.branch1 = nn.Sequential(
                _ConvBNReLU(in_c, in_c, 3, stride, 1, groups=in_c,
                            act=False),
                _ConvBNReLU(in_c, branch_c, 1),
            )
            self.branch2 = nn.Sequential(
                _ConvBNReLU(in_c, branch_c, 1),
                _ConvBNReLU(branch_c, branch_c, 3, stride, 1,
                            groups=branch_c, act=False),
                _ConvBNReLU(branch_c, branch_c, 1),
            )

    def forward(self, x):
        if self.stride == 1:
            half = x.shape[1] // 2
            out = concat([x[:, :half], self.branch2(x[:, half:])], axis=1)
        else:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        return _channel_shuffle(out, 2)


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, act='relu', num_classes=1000,
                 with_pool=True):
        super().__init__()
        if scale not in _STAGE_OUT:
            raise ValueError(f"scale must be one of {sorted(_STAGE_OUT)}")
        c0, c1, c2, c3, c_last = _STAGE_OUT[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = _ConvBNReLU(3, c0, 3, 2, 1)
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        blocks = []
        in_c = c0
        for out_c, rep in zip((c1, c2, c3), _REPEATS):
            blocks.append(_InvertedResidual(in_c, out_c, 2))
            for _ in range(rep - 1):
                blocks.append(_InvertedResidual(out_c, out_c, 1))
            in_c = out_c
        self.blocks = nn.Sequential(*blocks)
        self.conv_last = _ConvBNReLU(in_c, c_last, 1)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(c_last, num_classes)

    def forward(self, x):
        x = self.maxpool(self.conv1(x))
        x = self.conv_last(self.blocks(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def _make(scale, pretrained, **kw):
    no_pretrained(pretrained)
    return ShuffleNetV2(scale=scale, **kw)


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return _make(0.25, pretrained, **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return _make(0.33, pretrained, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return _make(0.5, pretrained, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return _make(1.0, pretrained, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return _make(1.5, pretrained, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return _make(2.0, pretrained, **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    """The x1.0 network with every ReLU swapped for Swish after it is
    built, so the block topology stays the same."""
    net = _make(1.0, pretrained, **kw)

    def _swap(layer):
        for name, child in list(layer._modules.items()):
            if isinstance(child, nn.ReLU):
                layer._modules[name] = nn.Swish()
            elif child is not None:
                _swap(child)

    _swap(net)
    return net
