"""MobileNet V1, V2 and V3: the counterpart of
``paddle2_tpu/vision/models/mobilenet.py``, the same layers and
attribute names over the port's ``nn`` (depthwise convolutions are
``Conv2D`` with ``groups`` equal to the channels)."""

from __future__ import annotations

from ... import nn
from ._utils import no_pretrained

__all__ = ["MobileNetV1", "MobileNetV2", "MobileNetV3Small",
           "MobileNetV3Large", "mobilenet_v1", "mobilenet_v2",
           "mobilenet_v3_small", "mobilenet_v3_large"]


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _ConvBNRelu(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, groups=1, act=nn.ReLU):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride,
                              padding=(k - 1) // 2, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.act = act() if act is not None else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class MobileNetV1(nn.Layer):
    """The depthwise-separable stack."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = lambda c: int(c * scale)
        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
              [(512, 1024, 2), (1024, 1024, 1)]
        layers = [_ConvBNRelu(3, s(32), 3, stride=2)]
        for in_c, out_c, stride in cfg:
            layers.append(_ConvBNRelu(s(in_c), s(in_c), 3, stride=stride,
                                      groups=s(in_c)))   # depthwise
            layers.append(_ConvBNRelu(s(in_c), s(out_c), 1))  # pointwise
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


class _InvertedResidual(nn.Layer):

    def __init__(self, in_c, out_c, stride, expand_ratio):
        super().__init__()
        hidden = int(round(in_c * expand_ratio))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNRelu(in_c, hidden, 1, act=nn.ReLU6))
        layers += [
            _ConvBNRelu(hidden, hidden, 3, stride=stride, groups=hidden,
                        act=nn.ReLU6),
            _ConvBNRelu(hidden, out_c, 1, act=None),
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
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = _make_divisible(32 * scale)
        last_c = _make_divisible(1280 * max(1.0, scale))
        layers = [_ConvBNRelu(3, in_c, 3, stride=2, act=nn.ReLU6)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                layers.append(_InvertedResidual(in_c, out_c,
                                                s if i == 0 else 1, t))
                in_c = out_c
        layers.append(_ConvBNRelu(in_c, last_c, 1, act=nn.ReLU6))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(nn.Dropout(0.2),
                                            nn.Linear(last_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class _SqueezeExcite(nn.Layer):
    def __init__(self, c, r=4):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.fc1 = nn.Conv2D(c, _make_divisible(c // r), 1)
        self.fc2 = nn.Conv2D(_make_divisible(c // r), c, 1)
        self.relu = nn.ReLU()
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        s = self.relu(self.fc1(self.pool(x)))
        return x * self.hsig(self.fc2(s))


class _V3Block(nn.Layer):
    def __init__(self, in_c, exp, out_c, k, stride, se, act):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if exp != in_c:
            layers.append(_ConvBNRelu(in_c, exp, 1, act=act))
        layers.append(_ConvBNRelu(exp, exp, k, stride=stride, groups=exp,
                                  act=act))
        if se:
            layers.append(_SqueezeExcite(exp))
        layers.append(_ConvBNRelu(exp, out_c, 1, act=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_V3_SMALL = [  # k, exp, out, se, act, stride  (mobilenetv3.py small cfg)
    (3, 16, 16, True, nn.ReLU, 2), (3, 72, 24, False, nn.ReLU, 2),
    (3, 88, 24, False, nn.ReLU, 1), (5, 96, 40, True, nn.Hardswish, 2),
    (5, 240, 40, True, nn.Hardswish, 1), (5, 240, 40, True, nn.Hardswish, 1),
    (5, 120, 48, True, nn.Hardswish, 1), (5, 144, 48, True, nn.Hardswish, 1),
    (5, 288, 96, True, nn.Hardswish, 2), (5, 576, 96, True, nn.Hardswish, 1),
    (5, 576, 96, True, nn.Hardswish, 1)]

_V3_LARGE = [
    (3, 16, 16, False, nn.ReLU, 1), (3, 64, 24, False, nn.ReLU, 2),
    (3, 72, 24, False, nn.ReLU, 1), (5, 72, 40, True, nn.ReLU, 2),
    (5, 120, 40, True, nn.ReLU, 1), (5, 120, 40, True, nn.ReLU, 1),
    (3, 240, 80, False, nn.Hardswish, 2), (3, 200, 80, False, nn.Hardswish, 1),
    (3, 184, 80, False, nn.Hardswish, 1), (3, 184, 80, False, nn.Hardswish, 1),
    (3, 480, 112, True, nn.Hardswish, 1), (3, 672, 112, True, nn.Hardswish, 1),
    (5, 672, 160, True, nn.Hardswish, 2), (5, 960, 160, True, nn.Hardswish, 1),
    (5, 960, 160, True, nn.Hardswish, 1)]


class _MobileNetV3(nn.Layer):

    def __init__(self, cfg, last_exp, last_c, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = lambda c: _make_divisible(c * scale)
        in_c = s(16)
        layers = [_ConvBNRelu(3, in_c, 3, stride=2, act=nn.Hardswish)]
        for k, exp, out_c, se, act, stride in cfg:
            layers.append(_V3Block(in_c, s(exp), s(out_c), k, stride, se,
                                   act))
            in_c = s(out_c)
        layers.append(_ConvBNRelu(in_c, s(last_exp), 1, act=nn.Hardswish))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(s(last_exp), last_c), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_V3_SMALL, 576, 1024, scale, num_classes, with_pool)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_V3_LARGE, 960, 1280, scale, num_classes, with_pool)




def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)
