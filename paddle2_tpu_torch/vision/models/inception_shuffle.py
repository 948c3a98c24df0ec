"""GoogLeNet, InceptionV3 and ShuffleNetV2: the counterpart of
``paddle2_tpu/vision/models/inception_shuffle.py``, the same layers
and attribute names over the port's ``nn`` (GoogLeNet's main classifier
only, as in the JAX package; the Inception branches pool with
``AvgPool2D(3, 1, padding=1)``, exclusive; the channel shuffle is a
reshape and a transpose)."""

from __future__ import annotations

from ... import nn
from ...amp.casting import amp_op
from ...ops.manipulation import concat
from ._utils import no_pretrained

__all__ = ["GoogLeNet", "googlenet", "InceptionV3", "inception_v3",
           "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5",
           "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]


class _BNConv(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, padding=0, groups=1,
                 act="relu"):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.act = {"relu": nn.ReLU, "swish": nn.Silu,
                    None: None}[act]
        self.act = self.act() if self.act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


# ------------------------------------------------------------- GoogLeNet

class _Inception(nn.Layer):
    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _BNConv(in_c, c1, 1)
        self.b2 = nn.Sequential(_BNConv(in_c, c3r, 1),
                                _BNConv(c3r, c3, 3, padding=1))
        self.b3 = nn.Sequential(_BNConv(in_c, c5r, 1),
                                _BNConv(c5r, c5, 5, padding=2))
        self.b4 = nn.Sequential(nn.MaxPool2D(3, 1, padding=1),
                                _BNConv(in_c, proj, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                      axis=1)


class GoogLeNet(nn.Layer):
    """GoogLeNet, the main classifier only (the upstream model's
    two auxiliary heads are a train-time regularizer that batch-norm
    largely obsoletes; forward returns ONE tensor)."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _BNConv(3, 64, 7, stride=2, padding=3),
            nn.MaxPool2D(3, 2, padding=1),
            _BNConv(64, 64, 1), _BNConv(64, 192, 3, padding=1),
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
            self.pool5 = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = nn.Dropout(0.4)
            self.fc = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4e(self.i4d(self.i4c(self.i4b(self.i4a(x)))))
        x = self.pool4(x)
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def googlenet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return GoogLeNet(**kwargs)


# ------------------------------------------------------------ InceptionV3

class _InceptionA(nn.Layer):
    def __init__(self, in_c, pool_c):
        super().__init__()
        self.b1 = _BNConv(in_c, 64, 1)
        self.b5 = nn.Sequential(_BNConv(in_c, 48, 1),
                                _BNConv(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_BNConv(in_c, 64, 1),
                                _BNConv(64, 96, 3, padding=1),
                                _BNConv(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _BNConv(in_c, pool_c, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)], 1)


class _InceptionB(nn.Layer):  # grid reduction
    def __init__(self, in_c):
        super().__init__()
        self.b3 = _BNConv(in_c, 384, 3, stride=2)
        self.b33 = nn.Sequential(_BNConv(in_c, 64, 1),
                                 _BNConv(64, 96, 3, padding=1),
                                 _BNConv(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return concat([self.b3(x), self.b33(x), self.pool(x)], 1)


class _InceptionC(nn.Layer):
    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = _BNConv(in_c, 192, 1)
        self.b7 = nn.Sequential(
            _BNConv(in_c, c7, 1),
            _BNConv(c7, c7, (1, 7), padding=(0, 3)),
            _BNConv(c7, 192, (7, 1), padding=(3, 0)))
        self.b77 = nn.Sequential(
            _BNConv(in_c, c7, 1),
            _BNConv(c7, c7, (7, 1), padding=(3, 0)),
            _BNConv(c7, c7, (1, 7), padding=(0, 3)),
            _BNConv(c7, c7, (7, 1), padding=(3, 0)),
            _BNConv(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _BNConv(in_c, 192, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b7(x), self.b77(x), self.bp(x)], 1)


class _InceptionD(nn.Layer):  # grid reduction
    def __init__(self, in_c):
        super().__init__()
        self.b3 = nn.Sequential(_BNConv(in_c, 192, 1),
                                _BNConv(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            _BNConv(in_c, 192, 1),
            _BNConv(192, 192, (1, 7), padding=(0, 3)),
            _BNConv(192, 192, (7, 1), padding=(3, 0)),
            _BNConv(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return concat([self.b3(x), self.b7(x), self.pool(x)], 1)


class _InceptionE(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b1 = _BNConv(in_c, 320, 1)
        self.b3_stem = _BNConv(in_c, 384, 1)
        self.b3_a = _BNConv(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _BNConv(384, 384, (3, 1), padding=(1, 0))
        self.b33_stem = nn.Sequential(_BNConv(in_c, 448, 1),
                                      _BNConv(448, 384, 3, padding=1))
        self.b33_a = _BNConv(384, 384, (1, 3), padding=(0, 1))
        self.b33_b = _BNConv(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _BNConv(in_c, 192, 1))

    def forward(self, x):
        s3 = self.b3_stem(x)
        s33 = self.b33_stem(x)
        return concat([self.b1(x),
                       concat([self.b3_a(s3), self.b3_b(s3)], 1),
                       concat([self.b33_a(s33), self.b33_b(s33)], 1),
                       self.bp(x)], 1)


class InceptionV3(nn.Layer):
    """InceptionV3 (299x299 inputs)."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _BNConv(3, 32, 3, stride=2), _BNConv(32, 32, 3),
            _BNConv(32, 64, 3, padding=1), nn.MaxPool2D(3, 2),
            _BNConv(64, 80, 1), _BNConv(80, 192, 3), nn.MaxPool2D(3, 2))
        self.blocks = nn.Sequential(
            _InceptionA(192, 32), _InceptionA(256, 64),
            _InceptionA(288, 64), _InceptionB(288),
            _InceptionC(768, 128), _InceptionC(768, 160),
            _InceptionC(768, 160), _InceptionC(768, 192),
            _InceptionD(768), _InceptionE(1280), _InceptionE(2048))
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return InceptionV3(**kwargs)


# ----------------------------------------------------------- ShuffleNetV2

@amp_op("channel_shuffle")
def _channel_shuffle(x, groups: int):
    b, c, h, w = x.shape
    return (x.reshape(b, groups, c // groups, h, w).transpose(1, 2)
            .reshape(b, c, h, w))


class _ShuffleUnit(nn.Layer):
    def __init__(self, in_c, out_c, stride, act):
        super().__init__()
        self.stride = stride
        mid = out_c // 2
        if stride == 1:
            self.branch2 = nn.Sequential(
                _BNConv(in_c // 2, mid, 1, act=act),
                _BNConv(mid, mid, 3, stride=1, padding=1, groups=mid,
                        act=None),
                _BNConv(mid, mid, 1, act=act))
            self.branch1 = None
        else:
            self.branch1 = nn.Sequential(
                _BNConv(in_c, in_c, 3, stride=stride, padding=1,
                        groups=in_c, act=None),
                _BNConv(in_c, mid, 1, act=act))
            self.branch2 = nn.Sequential(
                _BNConv(in_c, mid, 1, act=act),
                _BNConv(mid, mid, 3, stride=stride, padding=1, groups=mid,
                        act=None),
                _BNConv(mid, mid, 1, act=act))

    def forward(self, x):
        if self.stride == 1:
            half = x.shape[1] // 2
            x1, x2 = x[:, :half], x[:, half:]
            out = concat([x1, self.branch2(x2)], 1)
        else:
            out = concat([self.branch1(x), self.branch2(x)], 1)
        return _channel_shuffle(out, 2)


_SHUFFLE_CFG = {0.25: [24, 24, 48, 96, 512],
                0.33: [24, 32, 64, 128, 512],
                0.5: [24, 48, 96, 192, 1024],
                1.0: [24, 116, 232, 464, 1024],
                1.5: [24, 176, 352, 704, 1024],
                2.0: [24, 244, 488, 976, 2048]}


class ShuffleNetV2(nn.Layer):

    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        cfg = _SHUFFLE_CFG[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _BNConv(3, cfg[0], 3, stride=2, padding=1, act=act),
            nn.MaxPool2D(3, 2, padding=1))
        stages = []
        in_c = cfg[0]
        for i, reps in enumerate([4, 8, 4]):
            out_c = cfg[i + 1]
            units = [_ShuffleUnit(in_c, out_c, 2, act)]
            units += [_ShuffleUnit(out_c, out_c, 1, act)
                      for _ in range(reps - 1)]
            stages.append(nn.Sequential(*units))
            in_c = out_c
        self.stages = nn.Sequential(*stages)
        self.last = _BNConv(in_c, cfg[4], 1, act=act)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(cfg[4], num_classes)

    def forward(self, x):
        x = self.last(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _shuffle(scale, pretrained, act="relu", **kwargs):
    no_pretrained(pretrained)
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shuffle(0.25, pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shuffle(0.33, pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shuffle(0.5, pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shuffle(1.0, pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shuffle(1.5, pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shuffle(2.0, pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shuffle(1.0, pretrained, act="swish", **kwargs)
