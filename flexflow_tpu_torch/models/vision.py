"""Vision models: AlexNet, ResNet-50, InceptionV3, ResNeXt-50.

A copy of ``flexflow_tpu.models.vision`` (reference builders:
examples/cpp/AlexNet/alexnet.cc:40-126, examples/cpp/ResNet/resnet.cc,
examples/cpp/InceptionV3/inception.cc, examples/cpp/resnext50/resnext.cc,
bootcamp_demo/ff_alexnet_cifar10.py): the same FFModel builder calls in
the same order build the same layer names and weight layouts (NCHW
activations, HWIO conv kernels), so parameters carry between the two
packages 1:1.
"""
from __future__ import annotations

from ..ffconst import ActiMode, PoolType
from ..model import FFModel


def build_alexnet(ff: FFModel, batch_size: int = 64, image_size: int = 224,
                  num_classes: int = 1000):
    """reference: examples/cpp/AlexNet/alexnet.cc (conv 64/192/384/256/256)."""
    x = ff.create_tensor((batch_size, 3, image_size, image_size),
                         name="alexnet_input")
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
    return x, ff.softmax(t)


def build_alexnet_cifar10(ff: FFModel, batch_size: int = 64):
    """CIFAR-10 AlexNet (reference: bootcamp_demo/ff_alexnet_cifar10.py):
    smaller strides for 32x32 inputs."""
    x = ff.create_tensor((batch_size, 3, 32, 32), name="cifar_input")
    t = ff.conv2d(x, 64, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU)
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0)
    t = ff.conv2d(t, 192, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU)
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0)
    t = ff.conv2d(t, 384, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU)
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.AC_MODE_RELU)
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0)
    t = ff.flat(t)
    t = ff.dense(t, 512, ActiMode.AC_MODE_RELU)
    t = ff.dense(t, 10)
    return x, ff.softmax(t)


def _bottleneck(ff: FFModel, t, out_channels: int, stride: int,
                projection: bool, name: str):
    """ResNet bottleneck (reference: examples/cpp/ResNet BottleneckBlock)."""
    shortcut = t
    c = ff.conv2d(t, out_channels, 1, 1, 1, 1, 0, 0, name=f"{name}_c1")
    c = ff.batch_norm(c, relu=True, name=f"{name}_bn1")
    c = ff.conv2d(c, out_channels, 3, 3, stride, stride, 1, 1,
                  name=f"{name}_c2")
    c = ff.batch_norm(c, relu=True, name=f"{name}_bn2")
    c = ff.conv2d(c, 4 * out_channels, 1, 1, 1, 1, 0, 0, name=f"{name}_c3")
    c = ff.batch_norm(c, relu=False, name=f"{name}_bn3")
    if projection:
        shortcut = ff.conv2d(shortcut, 4 * out_channels, 1, 1, stride, stride,
                             0, 0, name=f"{name}_proj")
        shortcut = ff.batch_norm(shortcut, relu=False, name=f"{name}_bnp")
    out = ff.add(c, shortcut)
    return ff.relu(out)


def build_resnet50(ff: FFModel, batch_size: int = 64, image_size: int = 224,
                   num_classes: int = 1000, stages=(3, 4, 6, 3)):
    x = ff.create_tensor((batch_size, 3, image_size, image_size),
                         name="resnet_input")
    t = ff.conv2d(x, 64, 7, 7, 2, 2, 3, 3, name="stem")
    t = ff.batch_norm(t, relu=True, name="stem_bn")
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1)
    channels = 64
    for stage, blocks in enumerate(stages):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            t = _bottleneck(ff, t, channels, stride, projection=(b == 0),
                            name=f"s{stage}b{b}")
        channels *= 2
    # global average pool: kernel = remaining spatial extent (the reference
    # hardcodes 7x7 for 224px inputs)
    _, _, fh, fw = t.dims
    t = ff.pool2d(t, fh, fw, 1, 1, 0, 0, PoolType.POOL_AVG)
    t = ff.flat(t)
    t = ff.dense(t, num_classes)
    return x, ff.softmax(t)


# --------------------------------------------------------------- InceptionV3
# Reference: examples/cpp/InceptionV3/inception.cc — block builders
# InceptionA (:26), InceptionB (:50), InceptionC (:64), InceptionD, InceptionE.
def _inception_a(ff, t, pool_features, name):
    relu = ActiMode.AC_MODE_RELU
    t1 = ff.conv2d(t, 64, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_b1")
    t2 = ff.conv2d(t, 48, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_b2a")
    t2 = ff.conv2d(t2, 64, 5, 5, 1, 1, 2, 2, relu, name=f"{name}_b2b")
    t3 = ff.conv2d(t, 64, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_b3a")
    t3 = ff.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, relu, name=f"{name}_b3b")
    t3 = ff.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, relu, name=f"{name}_b3c")
    t4 = ff.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG)
    t4 = ff.conv2d(t4, pool_features, 1, 1, 1, 1, 0, 0, relu,
                   name=f"{name}_b4")
    return ff.concat([t1, t2, t3, t4], 1)


def _inception_b(ff, t, name):
    relu = ActiMode.AC_MODE_RELU
    t1 = ff.conv2d(t, 384, 3, 3, 2, 2, 0, 0, relu, name=f"{name}_b1")
    t2 = ff.conv2d(t, 64, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_b2a")
    t2 = ff.conv2d(t2, 96, 3, 3, 1, 1, 1, 1, relu, name=f"{name}_b2b")
    t2 = ff.conv2d(t2, 96, 3, 3, 2, 2, 0, 0, relu, name=f"{name}_b2c")
    t3 = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    return ff.concat([t1, t2, t3], 1)


def _inception_c(ff, t, channels, name):
    relu = ActiMode.AC_MODE_RELU
    t1 = ff.conv2d(t, 192, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_b1")
    t2 = ff.conv2d(t, channels, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_b2a")
    t2 = ff.conv2d(t2, channels, 1, 7, 1, 1, 0, 3, relu, name=f"{name}_b2b")
    t2 = ff.conv2d(t2, 192, 7, 1, 1, 1, 3, 0, relu, name=f"{name}_b2c")
    t3 = ff.conv2d(t, channels, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_b3a")
    t3 = ff.conv2d(t3, channels, 7, 1, 1, 1, 3, 0, relu, name=f"{name}_b3b")
    t3 = ff.conv2d(t3, channels, 1, 7, 1, 1, 0, 3, relu, name=f"{name}_b3c")
    t3 = ff.conv2d(t3, channels, 7, 1, 1, 1, 3, 0, relu, name=f"{name}_b3d")
    t3 = ff.conv2d(t3, 192, 1, 7, 1, 1, 0, 3, relu, name=f"{name}_b3e")
    t4 = ff.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG)
    t4 = ff.conv2d(t4, 192, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_b4")
    return ff.concat([t1, t2, t3, t4], 1)


def _inception_d(ff, t, name):
    relu = ActiMode.AC_MODE_RELU
    t1 = ff.conv2d(t, 192, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_b1a")
    t1 = ff.conv2d(t1, 320, 3, 3, 2, 2, 0, 0, relu, name=f"{name}_b1b")
    t2 = ff.conv2d(t, 192, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_b2a")
    t2 = ff.conv2d(t2, 192, 1, 7, 1, 1, 0, 3, relu, name=f"{name}_b2b")
    t2 = ff.conv2d(t2, 192, 7, 1, 1, 1, 3, 0, relu, name=f"{name}_b2c")
    t2 = ff.conv2d(t2, 192, 3, 3, 2, 2, 0, 0, relu, name=f"{name}_b2d")
    t3 = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    return ff.concat([t1, t2, t3], 1)


def _inception_e(ff, t, name):
    relu = ActiMode.AC_MODE_RELU
    t1 = ff.conv2d(t, 320, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_b1")
    t2i = ff.conv2d(t, 384, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_b2a")
    t2a = ff.conv2d(t2i, 384, 1, 3, 1, 1, 0, 1, relu, name=f"{name}_b2b")
    t2b = ff.conv2d(t2i, 384, 3, 1, 1, 1, 1, 0, relu, name=f"{name}_b2c")
    t3i = ff.conv2d(t, 448, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_b3a")
    t3i = ff.conv2d(t3i, 384, 3, 3, 1, 1, 1, 1, relu, name=f"{name}_b3b")
    t3a = ff.conv2d(t3i, 384, 1, 3, 1, 1, 0, 1, relu, name=f"{name}_b3c")
    t3b = ff.conv2d(t3i, 384, 3, 1, 1, 1, 1, 0, relu, name=f"{name}_b3d")
    t4 = ff.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG)
    t4 = ff.conv2d(t4, 192, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_b4")
    return ff.concat([t1, t2a, t2b, t3a, t3b, t4], 1)


def build_inception_v3(ff: FFModel, batch_size: int = 64,
                       image_size: int = 299, num_classes: int = 1000):
    """InceptionV3 (reference: examples/cpp/InceptionV3/inception.cc)."""
    relu = ActiMode.AC_MODE_RELU
    x = ff.create_tensor((batch_size, 3, image_size, image_size),
                         name="inception_input")
    t = ff.conv2d(x, 32, 3, 3, 2, 2, 0, 0, relu, name="stem1")
    t = ff.conv2d(t, 32, 3, 3, 1, 1, 0, 0, relu, name="stem2")
    t = ff.conv2d(t, 64, 3, 3, 1, 1, 1, 1, relu, name="stem3")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, 80, 1, 1, 1, 1, 0, 0, relu, name="stem4")
    t = ff.conv2d(t, 192, 3, 3, 1, 1, 1, 1, relu, name="stem5")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = _inception_a(ff, t, 32, "a1")
    t = _inception_a(ff, t, 64, "a2")
    t = _inception_a(ff, t, 64, "a3")
    t = _inception_b(ff, t, "b1")
    t = _inception_c(ff, t, 128, "c1")
    t = _inception_c(ff, t, 160, "c2")
    t = _inception_c(ff, t, 160, "c3")
    t = _inception_c(ff, t, 192, "c4")
    t = _inception_d(ff, t, "d1")
    t = _inception_e(ff, t, "e1")
    t = _inception_e(ff, t, "e2")
    _, _, fh, fw = t.dims
    t = ff.pool2d(t, fh, fw, 1, 1, 0, 0, PoolType.POOL_AVG)
    t = ff.flat(t)
    t = ff.dense(t, num_classes)
    return x, ff.softmax(t)


# --------------------------------------------------------------- ResNeXt-50
def _resnext_block(ff: FFModel, t, stride: int, out_channels: int,
                   groups: int, name: str):
    """Grouped-conv bottleneck (reference: examples/cpp/resnext50/
    resnext.cc:12-30)."""
    relu = ActiMode.AC_MODE_RELU
    shortcut = t
    in_channels = t.dims[1]
    c = ff.conv2d(t, out_channels, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_c1")
    c = ff.conv2d(c, out_channels, 3, 3, stride, stride, 1, 1, relu,
                  groups=groups, name=f"{name}_c2")
    c = ff.conv2d(c, 2 * out_channels, 1, 1, 1, 1, 0, 0, name=f"{name}_c3")
    if in_channels != 2 * out_channels or stride > 1:
        shortcut = ff.conv2d(shortcut, 2 * out_channels, 1, 1, stride, stride,
                             0, 0, name=f"{name}_proj")
    return ff.relu(ff.add(c, shortcut))


def build_resnext50(ff: FFModel, batch_size: int = 64, image_size: int = 224,
                    num_classes: int = 1000):
    """ResNeXt-50 32x4d (reference: examples/cpp/resnext50/resnext.cc:58-84)."""
    relu = ActiMode.AC_MODE_RELU
    x = ff.create_tensor((batch_size, 3, image_size, image_size),
                         name="resnext_input")
    t = ff.conv2d(x, 64, 7, 7, 2, 2, 3, 3, relu, name="stem")
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1)
    for b in range(3):
        t = _resnext_block(ff, t, 1, 128, 32, f"s1b{b}")
    for b in range(4):
        t = _resnext_block(ff, t, 2 if b == 0 else 1, 256, 32, f"s2b{b}")
    for b in range(6):
        t = _resnext_block(ff, t, 2 if b == 0 else 1, 512, 32, f"s3b{b}")
    for b in range(3):
        t = _resnext_block(ff, t, 2 if b == 0 else 1, 1024, 32, f"s4b{b}")
    _, _, fh, fw = t.dims
    t = ff.pool2d(t, fh, fw, 1, 1, 0, 0, PoolType.POOL_AVG)
    t = ff.flat(t)
    t = ff.dense(t, num_classes)
    return x, ff.softmax(t)
