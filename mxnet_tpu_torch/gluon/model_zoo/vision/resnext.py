"""ResNeXt and SE-ResNet (counterpart of ``mxnet_tpu/gluon/model_zoo/
vision/resnext.py``; GluonCV resnext.py and senet.py).

ResNeXt ("Aggregated Residual Transformations", Xie et al. 2017): the
bottleneck's 3x3 is a convolution of ``cardinality`` groups.  SE-ResNet
adds a squeeze-excitation gate (Hu et al. 2018): global pool, two 1x1
convolutions and a sigmoid scale.  The block structure and the
structural parameter names are the reference's.
"""
from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ... import nn

__all__ = ["ResNeXtBlock", "ResNeXt", "resnext50_32x4d", "resnext101_32x4d",
           "resnext101_64x4d", "se_resnet50", "se_resnet101",
           "SEBlock"]


class SEBlock(HybridBlock):
    """Squeeze-excitation gate: x * sigmoid(W2 relu(W1 gap(x)))."""

    def __init__(self, channels, reduction=16, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.fc1 = nn.Conv2D(max(channels // reduction, 4), 1)
            self.fc2 = nn.Conv2D(channels, 1)

    def hybrid_forward(self, F, x):
        w = F.mean(x, axis=(2, 3), keepdims=True)
        w = F.sigmoid(self.fc2(F.relu(self.fc1(w))))
        return x * w


class ResNeXtBlock(HybridBlock):
    """Grouped bottleneck, optionally with an SE gate (gluoncv resnext.py
    Block)."""

    def __init__(self, channels, cardinality, bottleneck_width, stride,
                 downsample=False, use_se=False, in_channels=0, **kwargs):
        super().__init__(**kwargs)
        D = int(channels * bottleneck_width / 64.0)
        group_width = cardinality * D
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(nn.Conv2D(group_width, 1, use_bias=False))
            self.body.add(nn.BatchNorm())
            self.body.add(nn.Activation("relu"))
            self.body.add(nn.Conv2D(group_width, 3, stride, 1,
                                    groups=cardinality, use_bias=False))
            self.body.add(nn.BatchNorm())
            self.body.add(nn.Activation("relu"))
            self.body.add(nn.Conv2D(channels * 4, 1, use_bias=False))
            self.body.add(nn.BatchNorm())
            self.se = SEBlock(channels * 4) if use_se else None
            if downsample:
                self.downsample = nn.HybridSequential(prefix="")
                self.downsample.add(nn.Conv2D(channels * 4, 1, stride,
                                              use_bias=False))
                self.downsample.add(nn.BatchNorm())
            else:
                self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        out = self.body(x)
        if self.se is not None:
            out = self.se(out)
        if self.downsample is not None:
            residual = self.downsample(x)
        return F.Activation(out + residual, act_type="relu")


class ResNeXt(HybridBlock):
    def __init__(self, layers, cardinality=32, bottleneck_width=4,
                 classes=1000, use_se=False, **kwargs):
        super().__init__(**kwargs)
        channels = 64
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(64, 7, 2, 3, use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                layer = nn.HybridSequential(prefix=f"stage{i + 1}_")
                with layer.name_scope():
                    layer.add(ResNeXtBlock(
                        channels, cardinality, bottleneck_width, stride,
                        downsample=True, use_se=use_se, prefix=""))
                    for _ in range(num_layer - 1):
                        layer.add(ResNeXtBlock(
                            channels, cardinality, bottleneck_width, 1,
                            use_se=use_se, prefix=""))
                self.features.add(layer)
                channels *= 2
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(F.flatten(x))


def _resnext(layers, cardinality, bottleneck_width, use_se=False,
             pretrained=False, **kwargs):
    if pretrained:
        raise MXNetError("pretrained weights unavailable offline; use "
                         "load_parameters with a local .params file")
    return ResNeXt(layers, cardinality, bottleneck_width, use_se=use_se,
                   **kwargs)


def resnext50_32x4d(**kwargs):
    return _resnext([3, 4, 6, 3], 32, 4, **kwargs)


def resnext101_32x4d(**kwargs):
    return _resnext([3, 4, 23, 3], 32, 4, **kwargs)


def resnext101_64x4d(**kwargs):
    return _resnext([3, 4, 23, 3], 64, 4, **kwargs)


def se_resnet50(**kwargs):
    # gluoncv se_resnet: cardinality 1, width 64 == plain bottleneck + SE
    return _resnext([3, 4, 6, 3], 1, 64, use_se=True, **kwargs)


def se_resnet101(**kwargs):
    return _resnext([3, 4, 23, 3], 1, 64, use_se=True, **kwargs)
