"""ResNet / ResNeXt / WideResNet: the counterpart of
``paddle2_tpu/vision/models/resnet.py:27-239``.

The same blocks, the same attribute names (``conv1``, ``bn1``,
``layer1..4``, ``downsample.0/1``, ``fc``) and so the same
``state_dict`` names as the JAX model, over the port's ``Conv2D``,
``BatchNorm2D`` (Paddle's running statistics in ``_mean`` and
``_variance``), ``MaxPool2D`` and ``AdaptiveAvgPool2D``; ``fc`` is a
``torch.nn.Linear`` (weight ``[out, in]``;
:func:`paddle2_tpu_torch.models.resnet_state_from_reference` carries a
JAX model's weights across). Data is ``NCHW``.

``ResNet(..., device=None)`` runs on the GPU and raises without one;
pass ``device="cpu"`` for the CPU. Weights are drawn from a
``torch.Generator`` on ``device`` seeded with ``seed``, with the JAX
package's initializers: convolutions uniform in ±1/√fan_in, ``fc``'s
weight Xavier-normal and its bias zeros, BatchNorm ones and zeros. The
two frameworks draw different numbers from one seed. The model starts
in training mode, as the JAX package's layers do. ``pretrained=True``
raises: the port downloads nothing.
"""

import contextlib
import math

import torch
from torch import nn

from ...device import resolve_device
from ...framework import core
from ...nn import AdaptiveAvgPool2D, BatchNorm2D, Conv2D, MaxPool2D

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2"]


def _built_on(factory):
    """The port's layers (``Conv2D``, ``BatchNorm2D``) take no device:
    they are built on the current place, which this makes the device
    the torch layers of the model get."""
    dev = factory.get("device")
    return (core.place_scope(dev) if dev is not None
            else contextlib.nullcontext())


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, **factory):
        super().__init__()
        with _built_on(factory):
            norm_layer = norm_layer or BatchNorm2D
            if groups != 1 or base_width != 64:
                raise ValueError("BasicBlock only supports groups=1, "
                                 "base_width=64")
            self.conv1 = Conv2D(inplanes, planes, 3, stride=stride,
                                padding=1, bias_attr=False)
            self.bn1 = norm_layer(planes)
            self.relu = nn.ReLU()
            self.conv2 = Conv2D(planes, planes, 3, padding=1,
                                bias_attr=False)
            self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    """1x1 reduce, 3x3, 1x1 expand block."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, **factory):
        super().__init__()
        with _built_on(factory):
            norm_layer = norm_layer or BatchNorm2D
            width = int(planes * (base_width / 64.0)) * groups
            self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False)
            self.bn1 = norm_layer(width)
            self.conv2 = Conv2D(width, width, 3, stride=stride,
                                padding=dilation, groups=groups,
                                dilation=dilation,
                                bias_attr=False)
            self.bn2 = norm_layer(width)
            self.conv3 = Conv2D(width, planes * self.expansion, 1,
                                bias_attr=False)
            self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    """ResNet backbone: ``block`` (BasicBlock/BottleneckBlock), ``depth``
    in {18, 34, 50, 101, 152}, ``width`` (per-group base width),
    ``num_classes`` (<= 0 drops the head), ``with_pool``, ``groups``
    (ResNeXt cardinality), as in the JAX package; ``device`` and
    ``seed`` as the module docstring says."""

    _cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
            101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        factory = {"device": device}
        layers = self._cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self.inplanes = 64
        self.dilation = 1
        with _built_on(factory):
            self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                                bias_attr=False)
            self.bn1 = self._norm_layer(self.inplanes)
            self.relu = nn.ReLU()
            self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
            self.layer1 = self._make_layer(block, 64, layers[0], factory)
            self.layer2 = self._make_layer(block, 128, layers[1], factory, 2)
            self.layer3 = self._make_layer(block, 256, layers[2], factory, 2)
            self.layer4 = self._make_layer(block, 512, layers[3], factory, 2)
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = nn.Linear(512 * block.expansion, num_classes,
                                    **factory)
        self._init_weights(torch.Generator(device=device).manual_seed(seed))

    def _make_layer(self, block, planes, blocks, factory, stride=1):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False),
                norm_layer(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        norm_layer, **factory)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, **factory))
        return nn.Sequential(*layers)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Conv2D):
                m.reset_parameters(gen)
            elif isinstance(m, nn.Linear):
                std = math.sqrt(2.0 / (m.in_features + m.out_features))
                m.weight.normal_(0.0, std, generator=gen)
                m.bias.zero_()

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def _resnet(Block, depth, pretrained, **kwargs):
    if pretrained:
        raise ValueError(
            "pretrained=True is unavailable: the port downloads nothing; "
            "load weights with load_state_dict (a JAX model's through "
            "paddle2_tpu_torch.models.resnet_state_from_reference)")
    return ResNet(Block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    """The BASELINE.md ImageNet backbone (config 1)."""
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained,
                   **dict(kwargs, groups=32, width=4))


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained,
                   **dict(kwargs, groups=64, width=4))


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained,
                   **dict(kwargs, groups=32, width=4))


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained,
                   **dict(kwargs, groups=64, width=4))


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained,
                   **dict(kwargs, groups=32, width=4))


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained,
                   **dict(kwargs, groups=64, width=4))


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **dict(kwargs, width=128))


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained,
                   **dict(kwargs, width=128))
