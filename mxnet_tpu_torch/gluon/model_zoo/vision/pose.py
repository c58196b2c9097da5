"""Simple pose estimation (counterpart of ``mxnet_tpu/gluon/model_zoo/
vision/pose.py``; GluonCV simple_pose_resnet.py, "Simple Baselines for
Human Pose Estimation", Xiao et al., 2018).

``SimplePoseResNet``: a ResNet v1b trunk at output stride 32 (its stem
and four stages, under ``features_``), three 4x4 stride-2
``Conv2DTranspose`` + ``BatchNorm`` + ReLU stages under ``deconv_``,
and a 1x1 conv to one heatmap a joint.  ``heatmap_to_coord`` decodes
heatmaps on their own device.  Block structure and structural parameter
names are the reference's.
"""
from __future__ import annotations

import torch

from ....base import MXNetError
from ....ndarray.ndarray import NDArray, apply
from ...block import HybridBlock
from ... import nn
from . import segmentation as _v1b

__all__ = ["SimplePoseResNet", "simple_pose_resnet18_v1b",
           "simple_pose_resnet50_v1b", "heatmap_to_coord"]

_TRUNKS = {"resnet18_v1b": _v1b.resnet18_v1b,
           "resnet34_v1b": _v1b.resnet34_v1b,
           "resnet50_v1b": _v1b.resnet50_v1b,
           "resnet101_v1b": _v1b.resnet101_v1b}


class SimplePoseResNet(HybridBlock):
    def __init__(self, base_name="resnet50_v1b", num_joints=17,
                 num_deconv_layers=3, num_deconv_filters=256,
                 pretrained_base=False, **kwargs):
        super().__init__(**kwargs)
        if base_name not in _TRUNKS:
            raise MXNetError(f"unknown pose trunk {base_name!r}; "
                             f"options: {sorted(_TRUNKS)}")
        trunk = _TRUNKS[base_name](classes=1, dilated=False)
        with self.name_scope():
            # the trunk up to its global pool: the stem and four stages
            self.features = nn.HybridSequential(prefix="features_")
            for name in ("conv1", "bn1", "relu", "maxpool",
                         "layer1", "layer2", "layer3", "layer4"):
                self.features.add(getattr(trunk, name))
            self.deconv_layers = nn.HybridSequential(prefix="deconv_")
            for _ in range(num_deconv_layers):
                self.deconv_layers.add(nn.Conv2DTranspose(
                    num_deconv_filters, kernel_size=4, strides=2, padding=1,
                    use_bias=False))
                self.deconv_layers.add(nn.BatchNorm())
                self.deconv_layers.add(nn.Activation("relu"))
            self.final_layer = nn.Conv2D(num_joints, kernel_size=1)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.deconv_layers(x)
        return self.final_layer(x)


def heatmap_to_coord(heatmaps):
    """(B, K, H, W) heatmaps as ((B, K, 2) float32 coordinates (x, y) of
    each map's first maximum, (B, K) maxima), NDArrays on the heatmaps'
    device (GluonCV get_max_pred)."""
    hm = heatmaps if isinstance(heatmaps, NDArray) else NDArray(heatmaps)

    def heatmap_to_coord(t):
        b, k, h, w = t.shape
        flat = t.reshape(b, k, h * w)
        scores = flat.amax(-1)       # a tie shares the gradient, as jnp's
        idx = flat.argmax(-1)
        coords = torch.stack([idx % w, idx // w], -1).to(torch.float32)
        return coords, scores
    return apply(heatmap_to_coord, [hm], n_out=2)


def simple_pose_resnet18_v1b(**kwargs):
    return SimplePoseResNet("resnet18_v1b", **kwargs)


def simple_pose_resnet50_v1b(**kwargs):
    return SimplePoseResNet("resnet50_v1b", **kwargs)
