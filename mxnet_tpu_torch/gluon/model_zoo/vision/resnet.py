"""ResNet V1/V2 for the Gluon model zoo.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``:
``resnet18``-``resnet152`` in v1 and v2, the basic and bottleneck
blocks, thumbnail mode for CIFAR, and ``SpaceToDepthStem``, the exact
space-to-depth rewrite of the 7x7/2 stem (``s2d_stem=True``).  Block
structure and structural parameter names are the reference's, so
weights and ``save_parameters`` files cross between the packages.
"""
from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "SpaceToDepthStem",
           "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


class SpaceToDepthStem(HybridBlock):
    """Numerically exact space-to-depth rewrite of the 7x7/stride-2 ImageNet
    stem (the MLPerf ResNet trick).

    The stride-2 7x7 conv over (B,3,224,224) becomes a stride-1 4x4 conv over
    the space-to-depth(2) input (B,12,112,112): identical FLOPs and output,
    with 4x more input channels and 4x fewer spatial positions.  The
    parameter keeps the stock stem's shape (C,3,7,7), so either stem loads
    the other's checkpoint, and the 4x4/12ch kernel is re-tiled from it at
    every call (a few kB).

    Derivation: out(i,j) = sum_{ky,kx,c} x[c, 2i+ky-3, 2j+kx-3] w[o,c,ky,kx].
    Writing ky = 2m+dy-1 (m in 0..3, dy in 0..1) turns the sum into a 4-tap
    stride-1 conv over the s2d grid with symmetric pad 2, valid outputs 0..111.
    """

    def __init__(self, channels, in_channels=3, **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels, 7, 7),
                allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        o, c_in = self._channels, self._in_channels
        if x.shape[1] != c_in:
            raise MXNetError(
                f"SpaceToDepthStem built for in_channels={c_in} but got "
                f"input with {x.shape[1]} channels; pass in_channels= to the "
                f"stem (the stock stem defers in_channels).")
        oh, ow = x.shape[2] % 2, x.shape[3] % 2
        if oh or ow:
            # odd spatial size: the 7x7/p3 conv reads zeros past the edge
            # anyway, so one explicit zero row/col keeps exact equivalence
            x = F.Pad(x, mode="constant",
                      pad_width=(0, 0, 0, 0, 0, oh, 0, ow))
        xs = F.space_to_depth(x, 2)
        # (O,C,7,7) -> pad front of each spatial dim -> (O,C,8,8); index
        # kyp = ky+1 = 2m+dy splits as (m, dy)
        w = F.Pad(weight, mode="constant",
                  pad_width=(0, 0, 0, 0, 1, 0, 1, 0))
        w = F.reshape(w, (o, c_in, 4, 2, 4, 2))        # (O, c, m, dy, n, dx)
        w = F.transpose(w, axes=(0, 3, 5, 1, 2, 4))    # (O, dy, dx, c, m, n)
        w = F.reshape(w, (o, 4 * c_in, 4, 4))          # ch = (dy*2+dx)*C + c
        y = F.Convolution(xs, w, None, kernel=(4, 4), stride=(1, 1),
                          pad=(2, 2), num_filter=o, no_bias=True)
        return F.slice(y, begin=(None, None, 0, 0),
                       end=(None, None, -1, -1))


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels, 1, channels)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        x = self.bn3(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv3(x)
        return x + residual


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 s2d_stem=False, stem_in_channels=3, **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                # prefix keeps the param named conv0_weight so checkpoints
                # interop between s2d_stem=True and the stock stem
                self.features.add(SpaceToDepthStem(channels[0],
                                                   stem_in_channels,
                                                   prefix="conv0_")
                                  if s2d_stem
                                  else nn.Conv2D(channels[0], 7, 2, 3,
                                                 use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0):
        layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 s2d_stem=False, stem_in_channels=3, **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(SpaceToDepthStem(channels[0],
                                                   stem_in_channels,
                                                   prefix="conv0_")
                                  if s2d_stem
                                  else nn.Conv2D(channels[0], 7, 2, 3,
                                                 use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=in_channels))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    _make_layer = ResNetV1._make_layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


resnet_spec = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
               34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
               50: ("bottle_neck", [3, 4, 6, 3],
                    [64, 256, 512, 1024, 2048]),
               101: ("bottle_neck", [3, 4, 23, 3],
                     [64, 256, 512, 1024, 2048]),
               152: ("bottle_neck", [3, 8, 36, 3],
                     [64, 256, 512, 1024, 2048])}

resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [{"basic_block": BasicBlockV1,
                          "bottle_neck": BottleneckV1},
                         {"basic_block": BasicBlockV2,
                          "bottle_neck": BottleneckV2}]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    assert num_layers in resnet_spec, \
        f"Invalid resnet depth {num_layers}; options: {sorted(resnet_spec)}"
    assert 1 <= version <= 2
    block_type, layers, channels = resnet_spec[num_layers]
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    net = resnet_class(block_class, layers, channels, **kwargs)
    if pretrained:
        raise MXNetError("pretrained weights unavailable offline; use "
                         "load_parameters with a local .params file")
    return net


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
