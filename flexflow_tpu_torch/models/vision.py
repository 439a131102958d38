"""Vision model zoo: AlexNet, ResNet-50, ResNeXt-50, Inception-v3.

The port of ``flexflow_tpu/models/vision.py``: the layer sequences of
the reference's ``examples/cpp/{AlexNet,ResNet,resnext50,InceptionV3}``
through the FFModel builders, the same as the JAX package's, so a model
built in both lines up layer for layer (``interop``).
"""
from __future__ import annotations

from ..ffconst import ActiMode, PoolType
from ..model import FFModel


def build_alexnet(ff: FFModel, batch_size: int, num_classes: int = 10,
                  image_hw: int = 229):
    """AlexNet (reference ``examples/cpp/AlexNet/alexnet.cc:70-84``)."""
    x = ff.create_tensor((batch_size, 3, image_hw, image_hw), name="input")
    t = ff.conv2d(x, 64, 11, 11, 4, 4, 2, 2, ActiMode.AC_MODE_RELU)
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, 192, 5, 5, 1, 1, 2, 2, ActiMode.AC_MODE_RELU)
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, 384, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU)
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU)
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU)
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.flat(t)
    t = ff.dense(t, 4096, ActiMode.AC_MODE_RELU)
    t = ff.dense(t, 4096, ActiMode.AC_MODE_RELU)
    t = ff.dense(t, num_classes)
    return ff.softmax(t)


def build_alexnet_cifar10(ff: FFModel, batch_size: int):
    """CIFAR-sized AlexNet (reference ``bootcamp_demo/ff_alexnet_cifar10.py``
    — BASELINE config 1). Smaller strides for 32x32 inputs."""
    x = ff.create_tensor((batch_size, 3, 32, 32), name="input")
    t = ff.conv2d(x, 64, 5, 5, 1, 1, 2, 2, ActiMode.AC_MODE_RELU)
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, 192, 5, 5, 1, 1, 2, 2, ActiMode.AC_MODE_RELU)
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, 384, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU)
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU)
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU)
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.flat(t)
    t = ff.dense(t, 2048, ActiMode.AC_MODE_RELU)
    t = ff.dense(t, 2048, ActiMode.AC_MODE_RELU)
    t = ff.dense(t, 10)
    return ff.softmax(t)


def _bottleneck(ff: FFModel, input, out_channels: int, stride: int,
                groups: int = 1, width_factor: int = 1):
    """ResNet bottleneck block (reference ``resnet.cc:33-58``); with
    groups>1 / width_factor=2 it is the ResNeXt block
    (``resnext50/resnext.cc``)."""
    width = out_channels * width_factor
    t = ff.conv2d(input, width, 1, 1, 1, 1, 0, 0, ActiMode.AC_MODE_NONE)
    t = ff.batch_norm(t)
    t = ff.conv2d(t, width, 3, 3, stride, stride, 1, 1,
                  ActiMode.AC_MODE_NONE, groups=groups)
    t = ff.batch_norm(t)
    t = ff.conv2d(t, 4 * out_channels, 1, 1, 1, 1, 0, 0)
    t = ff.batch_norm(t, relu=False)
    in_c = input.shape[1]
    if in_c != 4 * out_channels or stride > 1:
        input = ff.conv2d(input, 4 * out_channels, 1, 1, stride, stride, 0, 0)
        input = ff.batch_norm(input, relu=False)
    t = ff.add(input, t)
    return ff.relu(t)


def build_resnet50(ff: FFModel, batch_size: int, num_classes: int = 10,
                   image_hw: int = 224, groups: int = 1,
                   width_factor: int = 1):
    """ResNet-50 (reference ``examples/cpp/ResNet/resnet.cc:85-113``).
    groups=32, width_factor=2 gives ResNeXt-50 32x4d."""
    x = ff.create_tensor((batch_size, 3, image_hw, image_hw), name="input")
    t = ff.conv2d(x, 64, 7, 7, 2, 2, 3, 3)
    t = ff.batch_norm(t)
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1)
    for (n, c, s) in [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)]:
        for i in range(n):
            t = _bottleneck(ff, t, c, s if i == 0 else 1, groups,
                            width_factor)
    t = ff.pool2d(t, t.shape[2], t.shape[3], 1, 1, 0, 0, PoolType.POOL_AVG)
    t = ff.flat(t)
    t = ff.dense(t, num_classes)
    return ff.softmax(t)


def build_resnext50(ff: FFModel, batch_size: int, num_classes: int = 10,
                    image_hw: int = 224):
    """ResNeXt-50 32x4d (reference ``examples/cpp/resnext50``)."""
    return build_resnet50(ff, batch_size, num_classes, image_hw,
                          groups=32, width_factor=2)


def _inception_a(ff, x, pool_features):
    b1 = ff.batch_norm(ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0))
    b2 = ff.batch_norm(ff.conv2d(x, 48, 1, 1, 1, 1, 0, 0))
    b2 = ff.batch_norm(ff.conv2d(b2, 64, 5, 5, 1, 1, 2, 2))
    b3 = ff.batch_norm(ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0))
    b3 = ff.batch_norm(ff.conv2d(b3, 96, 3, 3, 1, 1, 1, 1))
    b3 = ff.batch_norm(ff.conv2d(b3, 96, 3, 3, 1, 1, 1, 1))
    b4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG)
    b4 = ff.batch_norm(ff.conv2d(b4, pool_features, 1, 1, 1, 1, 0, 0))
    return ff.concat([b1, b2, b3, b4], axis=1)


def _inception_b(ff, x):
    b1 = ff.batch_norm(ff.conv2d(x, 384, 3, 3, 2, 2, 0, 0))
    b2 = ff.batch_norm(ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0))
    b2 = ff.batch_norm(ff.conv2d(b2, 96, 3, 3, 1, 1, 1, 1))
    b2 = ff.batch_norm(ff.conv2d(b2, 96, 3, 3, 2, 2, 0, 0))
    b3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0)
    return ff.concat([b1, b2, b3], axis=1)


def _inception_c(ff, x, c7):
    b1 = ff.batch_norm(ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0))
    b2 = ff.batch_norm(ff.conv2d(x, c7, 1, 1, 1, 1, 0, 0))
    b2 = ff.batch_norm(ff.conv2d(b2, c7, 1, 7, 1, 1, 0, 3))
    b2 = ff.batch_norm(ff.conv2d(b2, 192, 7, 1, 1, 1, 3, 0))
    b3 = ff.batch_norm(ff.conv2d(x, c7, 1, 1, 1, 1, 0, 0))
    b3 = ff.batch_norm(ff.conv2d(b3, c7, 7, 1, 1, 1, 3, 0))
    b3 = ff.batch_norm(ff.conv2d(b3, c7, 1, 7, 1, 1, 0, 3))
    b3 = ff.batch_norm(ff.conv2d(b3, c7, 7, 1, 1, 1, 3, 0))
    b3 = ff.batch_norm(ff.conv2d(b3, 192, 1, 7, 1, 1, 0, 3))
    b4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG)
    b4 = ff.batch_norm(ff.conv2d(b4, 192, 1, 1, 1, 1, 0, 0))
    return ff.concat([b1, b2, b3, b4], axis=1)


def _inception_d(ff, x):
    b1 = ff.batch_norm(ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0))
    b1 = ff.batch_norm(ff.conv2d(b1, 320, 3, 3, 2, 2, 0, 0))
    b2 = ff.batch_norm(ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0))
    b2 = ff.batch_norm(ff.conv2d(b2, 192, 1, 7, 1, 1, 0, 3))
    b2 = ff.batch_norm(ff.conv2d(b2, 192, 7, 1, 1, 1, 3, 0))
    b2 = ff.batch_norm(ff.conv2d(b2, 192, 3, 3, 2, 2, 0, 0))
    b3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0)
    return ff.concat([b1, b2, b3], axis=1)


def _inception_e(ff, x):
    b1 = ff.batch_norm(ff.conv2d(x, 320, 1, 1, 1, 1, 0, 0))
    b2 = ff.batch_norm(ff.conv2d(x, 384, 1, 1, 1, 1, 0, 0))
    b2a = ff.batch_norm(ff.conv2d(b2, 384, 1, 3, 1, 1, 0, 1))
    b2b = ff.batch_norm(ff.conv2d(b2, 384, 3, 1, 1, 1, 1, 0))
    b2 = ff.concat([b2a, b2b], axis=1)
    b3 = ff.batch_norm(ff.conv2d(x, 448, 1, 1, 1, 1, 0, 0))
    b3 = ff.batch_norm(ff.conv2d(b3, 384, 3, 3, 1, 1, 1, 1))
    b3a = ff.batch_norm(ff.conv2d(b3, 384, 1, 3, 1, 1, 0, 1))
    b3b = ff.batch_norm(ff.conv2d(b3, 384, 3, 1, 1, 1, 1, 0))
    b3 = ff.concat([b3a, b3b], axis=1)
    b4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG)
    b4 = ff.batch_norm(ff.conv2d(b4, 192, 1, 1, 1, 1, 0, 0))
    return ff.concat([b1, b2, b3, b4], axis=1)


def build_inception_v3(ff: FFModel, batch_size: int, num_classes: int = 10,
                       image_hw: int = 299):
    """Inception-v3 (reference ``examples/cpp/InceptionV3/inception.cc``)."""
    x = ff.create_tensor((batch_size, 3, image_hw, image_hw), name="input")
    t = ff.batch_norm(ff.conv2d(x, 32, 3, 3, 2, 2, 0, 0))
    t = ff.batch_norm(ff.conv2d(t, 32, 3, 3, 1, 1, 0, 0))
    t = ff.batch_norm(ff.conv2d(t, 64, 3, 3, 1, 1, 1, 1))
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.batch_norm(ff.conv2d(t, 80, 1, 1, 1, 1, 0, 0))
    t = ff.batch_norm(ff.conv2d(t, 192, 3, 3, 1, 1, 1, 1))
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = _inception_a(ff, t, 32)
    t = _inception_a(ff, t, 64)
    t = _inception_a(ff, t, 64)
    t = _inception_b(ff, t)
    t = _inception_c(ff, t, 128)
    t = _inception_c(ff, t, 160)
    t = _inception_c(ff, t, 160)
    t = _inception_c(ff, t, 192)
    t = _inception_d(ff, t)
    t = _inception_e(ff, t)
    t = _inception_e(ff, t)
    t = ff.pool2d(t, t.shape[2], t.shape[3], 1, 1, 0, 0, PoolType.POOL_AVG)
    t = ff.flat(t)
    t = ff.dense(t, num_classes)
    return ff.softmax(t)
