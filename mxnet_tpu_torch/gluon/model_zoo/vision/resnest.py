"""ResNeSt: Split-Attention Networks (counterpart of ``mxnet_tpu/gluon/
model_zoo/vision/resnest.py``; GluonCV resnest.py and splat.py).

The split-attention block is one grouped convolution, reshapes and a
softmax over the radix; the trunk has the deep 3x3 stem, avg-down
shortcuts and avd pooling of "ResNeSt: Split-Attention Networks" (Zhang
et al., 2020).  The block structure and the structural parameter names
are the reference's.
"""
from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ... import nn

__all__ = ["SplitAttentionConv", "ResNeStBlock", "ResNeSt",
           "resnest50", "resnest101", "resnest200", "resnest269"]


class SplitAttentionConv(HybridBlock):
    """Split-attention grouped conv (GluonCV splat.py SplitAttentionConv).

    radix feature groups are produced by one grouped conv; a squeezed
    gate (global pool -> fc1 -> fc2 -> softmax over radix) reweights and
    sums them. radix=1 degenerates to SE-style sigmoid gating.
    """

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, radix=2, reduction_factor=4,
                 norm_layer=nn.BatchNorm, **kwargs):
        super().__init__(**kwargs)
        self._radix = radix
        self._cardinality = groups
        self._channels = channels
        inter_channels = max(channels * radix // reduction_factor, 32)
        with self.name_scope():
            self.conv = nn.Conv2D(channels * radix, kernel_size, strides,
                                  padding, dilation, groups=groups * radix,
                                  use_bias=False)
            self.bn = norm_layer()
            self.relu = nn.Activation("relu")
            self.fc1 = nn.Conv2D(inter_channels, 1, groups=groups)
            self.bn1 = norm_layer()
            self.fc2 = nn.Conv2D(channels * radix, 1, groups=groups)

    def hybrid_forward(self, F, x):
        r, ch = self._radix, self._channels
        x = self.relu(self.bn(self.conv(x)))            # (B, r*ch, H, W)
        if r > 1:
            splits = F.reshape(x, (0, -4, r, ch, -2))   # (B, r, ch, H, W)
            gap = F.sum(splits, axis=1)                 # (B, ch, H, W)
        else:
            gap = x
        gap = F.mean(gap, axis=(2, 3), keepdims=True)   # (B, ch, 1, 1)
        gate = self.fc2(self.relu(self.bn1(self.fc1(gap))))  # (B, r*ch, 1, 1)
        if r > 1:
            # softmax over the radix axis, per cardinal group
            g = self._cardinality
            gate = F.reshape(gate, (0, g, r, ch // g))
            gate = F.softmax(gate, axis=2)
            gate = F.reshape(F.transpose(gate, axes=(0, 2, 1, 3)),
                             (0, r, ch, 1, 1))          # (B, r, ch, 1, 1)
            return F.sum(splits * gate, axis=1)
        gate = F.sigmoid(gate)
        return x * gate


class ResNeStBlock(HybridBlock):
    """ResNeSt bottleneck: 1x1 -> SplAt 3x3 (with avd pooling on stride-2
    blocks) -> 1x1, avg-down residual."""

    expansion = 4

    def __init__(self, planes, strides=1, dilation=1, downsample=None,
                 radix=2, cardinality=1, bottleneck_width=64, avd=True,
                 avd_first=False, norm_layer=nn.BatchNorm, **kwargs):
        super().__init__(**kwargs)
        group_width = int(planes * (bottleneck_width / 64.0)) * cardinality
        self._avd = avd and strides > 1
        self._avd_first = avd_first
        with self.name_scope():
            self.conv1 = nn.Conv2D(group_width, 1, use_bias=False)
            self.bn1 = norm_layer()
            self.relu = nn.Activation("relu")
            if self._avd:
                self.avd_layer = nn.AvgPool2D(3, strides, padding=1)
                strides = 1
            self.conv2 = SplitAttentionConv(
                group_width, 3, strides, padding=dilation, dilation=dilation,
                groups=cardinality, radix=radix, norm_layer=norm_layer)
            self.conv3 = nn.Conv2D(planes * 4, 1, use_bias=False)
            self.bn3 = norm_layer()
            self.downsample = downsample

    def hybrid_forward(self, F, x):
        residual = x
        out = self.relu(self.bn1(self.conv1(x)))
        if self._avd and self._avd_first:
            out = self.avd_layer(out)
        out = self.conv2(out)
        if self._avd and not self._avd_first:
            out = self.avd_layer(out)
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        return self.relu(out + residual)


class ResNeSt(HybridBlock):
    """ResNeSt-d trunk: deep 3x3x3 stem, avg-down shortcuts, split-attention
    bottlenecks (GluonCV resnest.py)."""

    def __init__(self, layers, classes=1000, radix=2, cardinality=1,
                 bottleneck_width=64, stem_width=32, norm_layer=nn.BatchNorm,
                 **kwargs):
        super().__init__(**kwargs)
        self._block_args = dict(radix=radix, cardinality=cardinality,
                                bottleneck_width=bottleneck_width,
                                norm_layer=norm_layer)
        with self.name_scope():
            self.stem = nn.HybridSequential(prefix="stem_")
            for channels, s in ((stem_width, 2), (stem_width, 1),
                                (stem_width * 2, 1)):
                self.stem.add(nn.Conv2D(channels, 3, s, 1, use_bias=False))
                self.stem.add(norm_layer())
                self.stem.add(nn.Activation("relu"))
            self.maxpool = nn.MaxPool2D(3, 2, 1)
            planes = (64, 128, 256, 512)
            self.layer1 = self._make_layer(planes[0], layers[0], 1,
                                           norm_layer)
            self.layer2 = self._make_layer(planes[1], layers[1], 2,
                                           norm_layer)
            self.layer3 = self._make_layer(planes[2], layers[2], 2,
                                           norm_layer)
            self.layer4 = self._make_layer(planes[3], layers[3], 2,
                                           norm_layer)
            self.avgpool = nn.GlobalAvgPool2D()
            self.fc = nn.Dense(classes)

    def _make_layer(self, planes, blocks, strides, norm_layer):
        layer = nn.HybridSequential()
        downsample = nn.HybridSequential()
        if strides != 1:
            # avg_down: pool does the striding, 1x1 conv keeps stride 1
            downsample.add(nn.AvgPool2D(strides, strides,
                                        count_include_pad=False))
        downsample.add(nn.Conv2D(planes * 4, 1, use_bias=False))
        downsample.add(norm_layer())
        layer.add(ResNeStBlock(planes, strides, downsample=downsample,
                               **self._block_args))
        for _ in range(1, blocks):
            layer.add(ResNeStBlock(planes, 1, **self._block_args))
        return layer

    def hybrid_forward(self, F, x):
        x = self.maxpool(self.stem(x))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        x = self.avgpool(x)
        return self.fc(F.flatten(x))


def _resnest(layers, stem_width, pretrained=False, **kwargs):
    if pretrained:
        raise MXNetError("pretrained weights unavailable offline; use "
                         "load_parameters with a local .params file")
    return ResNeSt(layers, stem_width=stem_width, **kwargs)


def resnest50(**kwargs):
    return _resnest([3, 4, 6, 3], 32, **kwargs)


def resnest101(**kwargs):
    return _resnest([3, 4, 23, 3], 64, **kwargs)


def resnest200(**kwargs):
    return _resnest([3, 24, 36, 3], 64, **kwargs)


def resnest269(**kwargs):
    return _resnest([3, 30, 48, 8], 64, **kwargs)
