"""SSD, the single-shot detector (counterpart of ``mxnet_tpu/gluon/
model_zoo/vision/ssd.py``; GluonCV ssd.py): ``ConvPredictor``,
``SSDAnchorGenerator``, ``SSD``, ``_ResNetFeatures``, ``get_ssd``,
``ssd_300_resnet34_v1`` and ``ssd_512_resnet50_v1``.

In training mode ``SSD`` returns ``(cls_pred, box_pred, anchor)`` for
``contrib.MultiBoxTarget``; otherwise it decodes through
``contrib.MultiBoxDetection`` (``box_nms`` inside, a fixed sweep over the
top ``nms_topk`` candidates that reads nothing back to the host, so a
hybridized SSD captures whole on the card) and returns ``(ids, scores,
bboxes)``.  The anchors are ``contrib.MultiBoxPrior``'s of each feature
map.  Block structure and structural parameter names are the
reference's.
"""
from __future__ import annotations

from .... import _tape
from ....base import MXNetError
from ...block import HybridBlock
from ... import nn
from .resnet import get_resnet

__all__ = ["SSD", "ConvPredictor", "SSDAnchorGenerator", "get_ssd",
           "ssd_300_resnet34_v1", "ssd_512_resnet50_v1"]


class ConvPredictor(HybridBlock):
    """3x3 conv predictor head (gluoncv ConvPredictor)."""

    def __init__(self, num_channel, **kwargs):
        super().__init__(**kwargs)
        self.predictor = nn.Conv2D(num_channel, 3, 1, 1)

    def hybrid_forward(self, F, x):
        return self.predictor(x)


class SSDAnchorGenerator(HybridBlock):
    """Per-scale anchors via MultiBoxPrior (multibox_prior.cc semantics)."""

    def __init__(self, sizes, ratios, step, **kwargs):
        super().__init__(**kwargs)
        self._sizes = sizes
        self._ratios = ratios
        self._step = step

    @property
    def num_depth(self):
        return len(self._sizes) + len(self._ratios) - 1

    def hybrid_forward(self, F, x):
        return F.contrib.MultiBoxPrior(
            x, sizes=self._sizes, ratios=self._ratios, clip=False,
            steps=(self._step, self._step))


class SSD(HybridBlock):
    """Single Shot Detector.

    features: HybridBlock returning a list of multi-scale feature maps;
    sizes/ratios: per-scale anchor specs (len == num scales).
    """

    def __init__(self, features, sizes, ratios, steps, classes,
                 use_bn=True, nms_thresh=0.45, nms_topk=400, post_nms=100,
                 anchor_alloc_size=128, **kwargs):
        super().__init__(**kwargs)
        if len(sizes) != len(ratios) or len(sizes) != len(steps):
            raise MXNetError("sizes/ratios/steps length mismatch")
        self.classes = list(classes)
        self.num_classes = len(self.classes)
        self.nms_thresh = nms_thresh
        self.nms_topk = nms_topk
        self.post_nms = post_nms
        self.features = features
        self.class_predictors = nn.HybridSequential()
        self.box_predictors = nn.HybridSequential()
        self.anchor_generators = nn.HybridSequential()
        for s, r, st in zip(sizes, ratios, steps):
            gen = SSDAnchorGenerator(s, r, st)
            self.anchor_generators.add(gen)
            na = gen.num_depth
            self.class_predictors.add(
                ConvPredictor(na * (self.num_classes + 1)))
            self.box_predictors.add(ConvPredictor(na * 4))

    def set_nms(self, nms_thresh=0.45, nms_topk=400, post_nms=100):
        self.nms_thresh = nms_thresh
        self.nms_topk = nms_topk
        self.post_nms = post_nms

    def hybrid_forward(self, F, x):
        feats = self.features(x)
        cls_preds, box_preds, anchors = [], [], []
        for feat, cp, bp, ag in zip(feats, self.class_predictors,
                                    self.box_predictors,
                                    self.anchor_generators):
            c = cp(feat)    # (B, na*(C+1), H, W)
            b = bp(feat)
            # NCHW -> (B, HW*na, C+1)
            c = F.reshape(F.transpose(c, (0, 2, 3, 1)),
                          (c.shape[0], -1, self.num_classes + 1))
            b = F.reshape(F.transpose(b, (0, 2, 3, 1)), (b.shape[0], -1, 4))
            cls_preds.append(c)
            box_preds.append(b)
            anchors.append(ag(feat))
        cls_pred = F.concat(*cls_preds, dim=1)
        box_pred = F.concat(*box_preds, dim=1)
        anchor = F.concat(*anchors, dim=1)
        if _tape.is_training():
            return cls_pred, box_pred, anchor
        # inference: decode + nms -> (ids, scores, bboxes)
        cls_prob = F.softmax(cls_pred, axis=-1)
        cls_prob_t = F.transpose(cls_prob, (0, 2, 1))  # (B, C+1, N)
        dets = F.contrib.MultiBoxDetection(
            cls_prob_t, F.reshape(box_pred, (box_pred.shape[0], -1)),
            anchor, nms_threshold=self.nms_thresh, nms_topk=self.nms_topk)
        ids = F.slice_axis(dets, axis=2, begin=0, end=1)
        scores = F.slice_axis(dets, axis=2, begin=1, end=2)
        bboxes = F.slice_axis(dets, axis=2, begin=2, end=6)
        return ids, scores, bboxes


class _ResNetFeatures(HybridBlock):
    """ResNet truncated features + extra downsample stages (gluoncv
    FeatureExpander equivalent, conv-based)."""

    def __init__(self, base_net, num_extras=3, extra_channels=(512, 256, 256),
                 **kwargs):
        super().__init__(**kwargs)
        feats = base_net.features
        # stages: [0: conv..pool] [resnet stages] [-2 pool, -1 flatten] vary;
        # split: everything up to last stage = stage1 out; last stage = stage2
        self.stage1 = nn.HybridSequential()
        self.stage2 = nn.HybridSequential()
        blocks = list(feats._children.values())
        # drop trailing global pool / flatten if present
        core = [b for b in blocks if b.__class__.__name__ not in
                ("GlobalAvgPool2D", "Flatten")]
        for b in core[:-1]:
            self.stage1.add(b)
        self.stage2.add(core[-1])
        self.extras = nn.HybridSequential()
        for ch in extra_channels[:num_extras]:
            ext = nn.HybridSequential()
            ext.add(nn.Conv2D(ch // 2, 1, 1, 0, use_bias=False))
            ext.add(nn.BatchNorm())
            ext.add(nn.Activation("relu"))
            ext.add(nn.Conv2D(ch, 3, 2, 1, use_bias=False))
            ext.add(nn.BatchNorm())
            ext.add(nn.Activation("relu"))
            self.extras.add(ext)

    def hybrid_forward(self, F, x):
        outs = []
        x = self.stage1(x)
        outs.append(x)
        x = self.stage2(x)
        outs.append(x)
        for ext in self.extras:
            x = ext(x)
            outs.append(x)
        return outs


_VOC_CLASSES = tuple(f"class_{i}" for i in range(20))


def get_ssd(base_name, base_size, sizes, ratios, steps, classes=_VOC_CLASSES,
            **kwargs):
    if base_name.startswith("resnet"):
        ver = 1
        layers = {"resnet34": 34, "resnet50": 50}[base_name]
        base = get_resnet(ver, layers)
    else:
        raise MXNetError(f"unsupported SSD base {base_name}")
    features = _ResNetFeatures(base)
    return SSD(features, sizes, ratios, steps, classes, **kwargs)


def ssd_300_resnet34_v1(classes=_VOC_CLASSES, **kwargs):
    """SSD 300 with ResNet-34 (gluoncv ssd_300_resnet34_v1b parity)."""
    return get_ssd(
        "resnet34", 300,
        sizes=[[0.1, 0.141], [0.2, 0.272], [0.37, 0.447], [0.54, 0.619],
               [0.71, 0.79]],
        ratios=[[1, 2, 0.5]] * 3 + [[1, 2, 0.5]] * 2,
        steps=[-1.0] * 5, classes=classes, **kwargs)


def ssd_512_resnet50_v1(classes=_VOC_CLASSES, **kwargs):
    """SSD 512 with ResNet-50 (gluoncv ssd_512_resnet50_v1 parity)."""
    return get_ssd(
        "resnet50", 512,
        sizes=[[0.1, 0.141], [0.2, 0.272], [0.37, 0.447], [0.54, 0.619],
               [0.71, 0.79]],
        ratios=[[1, 2, 0.5]] * 5,
        steps=[-1.0] * 5, classes=classes, **kwargs)
