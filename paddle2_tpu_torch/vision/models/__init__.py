"""The port's model zoo: the counterpart of
``paddle2_tpu/vision/models/__init__.py``, with its ``__all__``."""

from .resnet import (ResNet, BasicBlock, BottleneckBlock, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .small import (LeNet, AlexNet, SqueezeNet, alexnet, squeezenet1_0,
                    squeezenet1_1)
from .mobilenet import (MobileNetV1, MobileNetV2, MobileNetV3Small,
                        MobileNetV3Large, mobilenet_v1, mobilenet_v2,
                        mobilenet_v3_small, mobilenet_v3_large)
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet264)
from .inception_shuffle import (GoogLeNet, googlenet, InceptionV3,
                                inception_v3, ShuffleNetV2,
                                shufflenet_v2_x0_25, shufflenet_v2_x0_33,
                                shufflenet_v2_x0_5,
                                shufflenet_v2_x1_0, shufflenet_v2_x1_5,
                                shufflenet_v2_x2_0, shufflenet_v2_swish)

__all__ = [
    "ResNet", "BasicBlock", "BottleneckBlock", "resnet18", "resnet34",
    "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
    "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
    "resnext152_32x4d", "resnext152_64x4d", "wide_resnet50_2",
    "wide_resnet101_2", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "LeNet", "AlexNet", "SqueezeNet", "alexnet", "squeezenet1_0",
    "squeezenet1_1", "MobileNetV1", "MobileNetV2", "MobileNetV3Small",
    "MobileNetV3Large", "mobilenet_v1", "mobilenet_v2",
    "mobilenet_v3_small", "mobilenet_v3_large",
    "DenseNet", "densenet121", "densenet161", "densenet169",
    "densenet201", "densenet264", "GoogLeNet", "googlenet",
    "InceptionV3", "inception_v3", "ShuffleNetV2",
    "shufflenet_v2_x0_25", "shufflenet_v2_x0_33", "shufflenet_v2_x0_5",
    "shufflenet_v2_x1_0",
    "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "shufflenet_v2_swish",
]
