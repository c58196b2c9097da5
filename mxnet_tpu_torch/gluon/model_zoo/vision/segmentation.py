"""Semantic segmentation: the dilated ResNet v1b backbones, FCN, PSPNet
and DeepLabV3 (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/
segmentation.py``; GluonCV resnetv1b.py, fcn.py, pspnet.py,
deeplabv3.py and segbase.py).

``ResNetV1b`` with ``dilated=True`` keeps output stride 8: stages 3 and
4 run at stride 1 with dilations 2 and 4 (a stage's first block takes
dilation 1 where the stage's is 1 or 2, else 2; a basic block's second
conv the stage's own), and ``extract`` returns (c3, c4) for the heads.
``norm_layer`` takes any BatchNorm class, ``contrib.nn.SyncBatchNorm``
among them.  The heads resize with ``contrib.BilinearResize2D`` to the
input's size and pool with ``contrib.AdaptiveAvgPooling2D``; in
training mode with ``aux`` a model returns ``(out, aux_out)``, else
``out``.  The heads' Dropout masks come from the device's ``nd.random``
generator, where the reference folds its key (ROADMAP §3).
Block structure and structural parameter names are the reference's.
"""
from __future__ import annotations

from .... import _tape
from ....base import MXNetError
from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1b", "resnet18_v1b", "resnet34_v1b", "resnet50_v1b",
           "resnet101_v1b",
           "FCN", "PSPNet", "DeepLabV3",
           "get_fcn", "get_psp", "get_deeplab"]


class BasicBlockV1b(HybridBlock):
    """Two 3x3 convs, the stride on the first (GluonCV BasicBlockV1b)."""

    expansion = 1

    def __init__(self, planes, strides=1, dilation=1, downsample=None,
                 previous_dilation=1, norm_layer=nn.BatchNorm, **kwargs):
        super().__init__(**kwargs)
        self.conv1 = nn.Conv2D(planes, kernel_size=3, strides=strides,
                               padding=dilation, dilation=dilation,
                               use_bias=False)
        self.bn1 = norm_layer()
        self.conv2 = nn.Conv2D(planes, kernel_size=3, strides=1,
                               padding=previous_dilation,
                               dilation=previous_dilation, use_bias=False)
        self.bn2 = norm_layer()
        self.relu = nn.Activation("relu")
        self.downsample = downsample

    def hybrid_forward(self, F, x):
        residual = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        return self.relu(out + residual)


class BottleneckV1b(HybridBlock):
    """1x1, 3x3 (strided, dilated), 1x1 x4 (GluonCV BottleneckV1b)."""

    expansion = 4

    def __init__(self, planes, strides=1, dilation=1, downsample=None,
                 previous_dilation=1, norm_layer=nn.BatchNorm, **kwargs):
        super().__init__(**kwargs)
        self.conv1 = nn.Conv2D(planes, kernel_size=1, use_bias=False)
        self.bn1 = norm_layer()
        self.conv2 = nn.Conv2D(planes, kernel_size=3, strides=strides,
                               padding=dilation, dilation=dilation,
                               use_bias=False)
        self.bn2 = norm_layer()
        self.conv3 = nn.Conv2D(planes * 4, kernel_size=1, use_bias=False)
        self.bn3 = norm_layer()
        self.relu = nn.Activation("relu")
        self.downsample = downsample

    def hybrid_forward(self, F, x):
        residual = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            residual = self.downsample(x)
        return self.relu(out + residual)


class ResNetV1b(HybridBlock):
    """The (dilated) ResNet v1b backbone (GluonCV resnetv1b.py)."""

    def __init__(self, layers, classes=1000, dilated=True,
                 norm_layer=nn.BatchNorm, deep_stem=False,
                 block=BottleneckV1b, **kwargs):
        super().__init__(**kwargs)
        self._block = block
        self.conv1 = nn.Conv2D(64, kernel_size=7, strides=2, padding=3,
                               use_bias=False)
        self.bn1 = norm_layer()
        self.relu = nn.Activation("relu")
        self.maxpool = nn.MaxPool2D(pool_size=3, strides=2, padding=1)
        planes = (64, 128, 256, 512)
        strides = (1, 2, 1, 1) if dilated else (1, 2, 2, 2)
        dilations = (1, 1, 2, 4) if dilated else (1, 1, 1, 1)
        self.layer1 = self._make_layer(planes[0], layers[0], strides[0],
                                       dilations[0], norm_layer)
        self.layer2 = self._make_layer(planes[1], layers[1], strides[1],
                                       dilations[1], norm_layer)
        self.layer3 = self._make_layer(planes[2], layers[2], strides[2],
                                       dilations[2], norm_layer)
        self.layer4 = self._make_layer(planes[3], layers[3], strides[3],
                                       dilations[3], norm_layer)
        self.avgpool = nn.GlobalAvgPool2D()
        self.fc = nn.Dense(classes)

    def _make_layer(self, planes, blocks, strides, dilation, norm_layer):
        block = self._block
        layer = nn.HybridSequential()
        in_c = getattr(self, "_in_c", 64)
        if strides != 1 or in_c != planes * block.expansion:
            downsample = nn.HybridSequential()
            downsample.add(nn.Conv2D(planes * block.expansion, kernel_size=1,
                                     strides=strides, use_bias=False))
            downsample.add(norm_layer())
        else:   # the identity shortcut where the shapes match
            downsample = None
        self._in_c = planes * block.expansion
        first_dil = 1 if dilation in (1, 2) else 2
        layer.add(block(planes, strides, first_dil, downsample,
                        previous_dilation=dilation, norm_layer=norm_layer))
        for _ in range(1, blocks):
            layer.add(block(planes, 1, dilation, previous_dilation=dilation,
                            norm_layer=norm_layer))
        return layer

    def hybrid_forward(self, F, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        c1 = self.layer1(x)
        c2 = self.layer2(c1)
        c3 = self.layer3(c2)
        c4 = self.layer4(c3)
        x = self.avgpool(c4)
        return self.fc(F.flatten(x))

    def extract(self, x):
        """The (c3, c4) feature maps the segmentation heads read."""
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        c3 = self.layer3(x)
        c4 = self.layer4(c3)
        return c3, c4


def resnet18_v1b(**kwargs):
    return ResNetV1b([2, 2, 2, 2], block=BasicBlockV1b, **kwargs)


def resnet34_v1b(**kwargs):
    return ResNetV1b([3, 4, 6, 3], block=BasicBlockV1b, **kwargs)


def resnet50_v1b(**kwargs):
    return ResNetV1b([3, 4, 6, 3], **kwargs)


def resnet101_v1b(**kwargs):
    return ResNetV1b([3, 4, 23, 3], **kwargs)


class _FCNHead(HybridBlock):
    def __init__(self, nclass, channels=512, norm_layer=nn.BatchNorm,
                 **kwargs):
        super().__init__(**kwargs)
        self.block = nn.HybridSequential()
        self.block.add(nn.Conv2D(channels // 4, kernel_size=3, padding=1,
                                 use_bias=False))
        self.block.add(norm_layer())
        self.block.add(nn.Activation("relu"))
        self.block.add(nn.Dropout(0.1))
        self.block.add(nn.Conv2D(nclass, kernel_size=1))

    def hybrid_forward(self, F, x):
        return self.block(x)


class SegBaseModel(HybridBlock):
    """A dilated v1b backbone under a head: ``predict`` (and
    ``evaluate``) runs it in predict mode and returns the main output."""

    def __init__(self, nclass, backbone="resnet50", aux=True,
                 norm_layer=nn.BatchNorm, crop_size=480, **kwargs):
        super().__init__(**kwargs)
        self.nclass = nclass
        self.aux = aux
        self.crop_size = crop_size
        if backbone == "resnet50":
            self.base = resnet50_v1b(norm_layer=norm_layer)
        elif backbone == "resnet101":
            self.base = resnet101_v1b(norm_layer=norm_layer)
        else:
            raise MXNetError(f"unknown backbone {backbone}")

    def _resize(self, x, like):
        from ....ndarray import contrib
        return contrib.BilinearResize2D(x, height=like.shape[2],
                                        width=like.shape[3])

    def _heads(self, F, x, head):
        """``head(c4)`` resized to ``x``, and in training mode with
        ``aux`` the auxiliary head's ``c3`` beside it."""
        c3, c4 = self.base.extract(x)
        out = self._resize(head(c4), x)
        if self.aux and _tape.is_training():
            return out, self._resize(self.auxlayer(c3), x)
        return out

    def predict(self, x):
        prev = _tape.set_training(False)
        try:
            out = self(x)
        finally:
            _tape.set_training(prev)
        return out[0] if isinstance(out, (tuple, list)) else out

    def evaluate(self, x):
        return self.predict(x)


class FCN(SegBaseModel):
    """Fully convolutional network (GluonCV fcn.py)."""

    def __init__(self, nclass, backbone="resnet50", aux=True,
                 norm_layer=nn.BatchNorm, **kwargs):
        super().__init__(nclass, backbone, aux, norm_layer, **kwargs)
        self.head = _FCNHead(nclass, 2048, norm_layer)
        if aux:
            self.auxlayer = _FCNHead(nclass, 1024, norm_layer)

    def hybrid_forward(self, F, x):
        return self._heads(F, x, self.head)


class _PyramidPooling(HybridBlock):
    def __init__(self, norm_layer=nn.BatchNorm, **kwargs):
        super().__init__(**kwargs)
        self.convs = nn.HybridSequential()
        for _ in range(4):
            blk = nn.HybridSequential()
            blk.add(nn.Conv2D(512, kernel_size=1, use_bias=False))
            blk.add(norm_layer())
            blk.add(nn.Activation("relu"))
            self.convs.add(blk)

    def hybrid_forward(self, F, x):
        h, w = x.shape[2], x.shape[3]
        outs = [x]
        for size, conv in zip((1, 2, 3, 6), self.convs):
            p = conv(F.contrib.AdaptiveAvgPooling2D(x, output_size=size))
            outs.append(F.contrib.BilinearResize2D(p, height=h, width=w))
        return F.concat(*outs, dim=1)


class PSPNet(SegBaseModel):
    """Pyramid scene parsing (GluonCV pspnet.py)."""

    def __init__(self, nclass, backbone="resnet50", aux=True,
                 norm_layer=nn.BatchNorm, **kwargs):
        super().__init__(nclass, backbone, aux, norm_layer, **kwargs)
        self.psp = _PyramidPooling(norm_layer)
        self.head = nn.HybridSequential()
        self.head.add(nn.Conv2D(512, kernel_size=3, padding=1,
                                use_bias=False))
        self.head.add(norm_layer())
        self.head.add(nn.Activation("relu"))
        self.head.add(nn.Dropout(0.1))
        self.head.add(nn.Conv2D(nclass, kernel_size=1))
        if aux:
            self.auxlayer = _FCNHead(nclass, 1024, norm_layer)

    def hybrid_forward(self, F, x):
        return self._heads(F, x, lambda c4: self.head(self.psp(c4)))


class _ASPP(HybridBlock):
    """Atrous spatial pyramid pooling (GluonCV deeplabv3.py): a 1x1
    branch, three dilated 3x3 branches and the pooled branch."""

    def __init__(self, norm_layer=nn.BatchNorm, rates=(12, 24, 36), **kwargs):
        super().__init__(**kwargs)
        out_ch = 256
        self.b0 = nn.HybridSequential()
        self.b0.add(nn.Conv2D(out_ch, kernel_size=1, use_bias=False))
        self.b0.add(norm_layer())
        self.b0.add(nn.Activation("relu"))
        self.branches = nn.HybridSequential()
        for r in rates:
            blk = nn.HybridSequential()
            blk.add(nn.Conv2D(out_ch, kernel_size=3, padding=r, dilation=r,
                              use_bias=False))
            blk.add(norm_layer())
            blk.add(nn.Activation("relu"))
            self.branches.add(blk)
        self.gap_conv = nn.HybridSequential()
        self.gap_conv.add(nn.Conv2D(out_ch, kernel_size=1, use_bias=False))
        self.gap_conv.add(norm_layer())
        self.gap_conv.add(nn.Activation("relu"))
        self.project = nn.HybridSequential()
        self.project.add(nn.Conv2D(out_ch, kernel_size=1, use_bias=False))
        self.project.add(norm_layer())
        self.project.add(nn.Activation("relu"))
        self.project.add(nn.Dropout(0.5))

    def hybrid_forward(self, F, x):
        h, w = x.shape[2], x.shape[3]
        outs = [self.b0(x)]
        for blk in self.branches:
            outs.append(blk(x))
        gap = self.gap_conv(F.contrib.AdaptiveAvgPooling2D(x, output_size=1))
        outs.append(F.contrib.BilinearResize2D(gap, height=h, width=w))
        return self.project(F.concat(*outs, dim=1))


class DeepLabV3(SegBaseModel):
    """DeepLabV3 (GluonCV deeplabv3.py)."""

    def __init__(self, nclass, backbone="resnet50", aux=True,
                 norm_layer=nn.BatchNorm, **kwargs):
        super().__init__(nclass, backbone, aux, norm_layer, **kwargs)
        self.aspp = _ASPP(norm_layer)
        self.head = nn.HybridSequential()
        self.head.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                use_bias=False))
        self.head.add(norm_layer())
        self.head.add(nn.Activation("relu"))
        self.head.add(nn.Conv2D(nclass, kernel_size=1))
        if aux:
            self.auxlayer = _FCNHead(nclass, 1024, norm_layer)

    def hybrid_forward(self, F, x):
        return self._heads(F, x, lambda c4: self.head(self.aspp(c4)))


def get_fcn(nclass=21, backbone="resnet50", **kwargs):
    return FCN(nclass, backbone, **kwargs)


def get_psp(nclass=21, backbone="resnet50", **kwargs):
    return PSPNet(nclass, backbone, **kwargs)


def get_deeplab(nclass=21, backbone="resnet50", **kwargs):
    return DeepLabV3(nclass, backbone, **kwargs)
