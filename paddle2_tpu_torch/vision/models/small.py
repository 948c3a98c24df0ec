"""LeNet, AlexNet and SqueezeNet: the counterpart of
``paddle2_tpu/vision/models/small.py``, the same layers and attribute
names over the port's ``nn`` (SqueezeNet's pools keep partial windows,
``ceil_mode=True``; AlexNet ends in ``AdaptiveAvgPool2D((6, 6))``)."""

from __future__ import annotations

from ... import nn
from ._utils import no_pretrained
from ...ops.manipulation import concat

__all__ = ["LeNet", "AlexNet", "SqueezeNet", "alexnet", "squeezenet1_0",
           "squeezenet1_1"]


class LeNet(nn.Layer):
    """LeNet (MNIST geometry, 1x28x28 input)."""

    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120), nn.Linear(120, 84),
                nn.Linear(84, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


class AlexNet(nn.Layer):

    def __init__(self, num_classes=1000):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2))
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
                nn.Dropout(), nn.Linear(4096, 4096), nn.ReLU(),
                nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def alexnet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return AlexNet(**kwargs)


class _Fire(nn.Layer):
    def __init__(self, in_c, squeeze, expand1, expand3):
        super().__init__()
        self.squeeze = nn.Conv2D(in_c, squeeze, 1)
        self.relu = nn.ReLU()
        self.expand1 = nn.Conv2D(squeeze, expand1, 1)
        self.expand3 = nn.Conv2D(squeeze, expand3, 3, padding=1)

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return concat([self.relu(self.expand1(x)),
                       self.relu(self.expand3(x))], axis=1)


class SqueezeNet(nn.Layer):
    """SqueezeNet; ``version`` in {'1.0', '1.1'}."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(512, 64, 256, 256))
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(),
                nn.Conv2D(512, num_classes, 1), nn.ReLU())
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.avgpool(x)
        return x.flatten(1)


def squeezenet1_0(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)
