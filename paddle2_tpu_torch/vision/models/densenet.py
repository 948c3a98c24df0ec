"""DenseNet: the counterpart of
``paddle2_tpu/vision/models/densenet.py``, the same layers and
attribute names over the port's ``nn``: each dense layer concatenates
its input and its growth, each transition ends in ``AvgPool2D(2, 2)``."""

from __future__ import annotations

from ... import nn
from ...ops.manipulation import concat
from ._utils import no_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFGS = {121: (64, 32, [6, 12, 24, 16]),
         161: (96, 48, [6, 12, 36, 24]),
         169: (64, 32, [6, 12, 32, 32]),
         201: (64, 32, [6, 12, 48, 32]),
         264: (64, 32, [6, 12, 64, 48])}


class _DenseLayer(nn.Layer):
    def __init__(self, in_c, growth_rate, bn_size, dropout):
        super().__init__()
        self.bn1 = nn.BatchNorm2D(in_c)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(in_c, bn_size * growth_rate, 1,
                               bias_attr=False)
        self.bn2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return concat([x, out], axis=1)


class _DenseBlock(nn.Layer):
    def __init__(self, n_layers, in_c, growth_rate, bn_size, dropout):
        super().__init__()
        self.layers = nn.LayerList([
            _DenseLayer(in_c + i * growth_rate, growth_rate, bn_size,
                        dropout) for i in range(n_layers)])

    def forward(self, x):
        for l in self.layers:
            x = l(x)
        return x


class _Transition(nn.Layer):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.bn = nn.BatchNorm2D(in_c)
        self.relu = nn.ReLU()
        self.conv = nn.Conv2D(in_c, out_c, 1, bias_attr=False)
        self.pool = nn.AvgPool2D(2, 2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(nn.Layer):
    """DenseNet-``layers``, ``layers`` in {121, 161, 169, 201, 264}."""

    def __init__(self, layers=121, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True):
        super().__init__()
        init_c, growth, cfg = _CFGS[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            nn.Conv2D(3, init_c, 7, stride=2, padding=3, bias_attr=False),
            nn.BatchNorm2D(init_c), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1))
        blocks = []
        c = init_c
        for i, n in enumerate(cfg):
            blocks.append(_DenseBlock(n, c, growth, bn_size, dropout))
            c += n * growth
            if i != len(cfg) - 1:
                blocks.append(_Transition(c, c // 2))
                c //= 2
        self.features = nn.Sequential(*blocks)
        self.bn_last = nn.BatchNorm2D(c)
        self.relu = nn.ReLU()
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Linear(c, num_classes)

    def forward(self, x):
        x = self.relu(self.bn_last(self.features(self.stem(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _make(layers, pretrained, **kwargs):
    no_pretrained(pretrained)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _make(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _make(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _make(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _make(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _make(264, pretrained, **kwargs)
