"""Faster R-CNN (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/
rcnn.py``; GluonCV faster_rcnn): ``RPNAnchorGenerator``, ``RPN``,
``FasterRCNN`` and ``faster_rcnn_resnet50_v1b``.

Every stage has a static shape, so a hybridized detector captures whole
on the card.  The RPN takes the top ``pre_nms`` anchors by score, runs
the reference's greedy suppression over them (its own IoU: each area
held above 1e-12, the denominator not; one (k x k) matrix, then the
fixed sweep of ``contrib._sweep``, a few launches a candidate), and
returns the top ``post_nms`` survivors, suppressed candidates scoring
-1.  Both orderings are stable sorts: ties keep the index order, as
``jax.lax.top_k``'s do (sigmoid scores of random weights saturate to
exactly 1.0, and where fewer than ``post_nms`` survive the -1 ties
decide which boxes are returned).  The box head reads the proposals
through ``contrib.ROIAlign`` without a gradient to their coordinates
(approximate joint training, Faster R-CNN §3.2); on the card its
backward adds into the features with atomics, in another order than on
the CPU (ROADMAP §3).  The backbone's
``layer4``, ``avgpool`` and ``fc`` are removed, so they are neither
allocated nor saved.  Block structure and structural parameter names
are the reference's.
"""
from __future__ import annotations

import math

import torch

from .... import _tape
from ....ndarray.contrib import ROIAlign, _sweep, box_nms
from ....ndarray.ndarray import apply
from ....ndarray.ops import _const
from ...block import HybridBlock
from ... import nn
from .segmentation import resnet50_v1b

__all__ = ["RPN", "FasterRCNN", "faster_rcnn_resnet50_v1b"]


class RPNAnchorGenerator(HybridBlock):
    """Anchors in image pixels at one stride (GluonCV rpn/anchor.py):
    (1, H * W * A, 4) corners, the anchors of a cell last."""

    def __init__(self, stride=16, scales=(8, 16, 32), ratios=(0.5, 1, 2),
                 base_size=16, **kwargs):
        super().__init__(**kwargs)
        self._stride = stride
        shapes = []
        for s in scales:
            for r in ratios:
                size = (base_size * s) ** 2 / r
                w = math.sqrt(size)
                h = w * r
                shapes.append((w, h))
        self._shapes = shapes

    @property
    def num_anchors(self):
        return len(self._shapes)

    def hybrid_forward(self, F, x):
        stride, shapes = self._stride, self._shapes

        def rpn_anchors(d):
            h, w = d.shape[-2], d.shape[-1]
            dev = d.device
            cy = (torch.arange(h, device=dev) + 0.5) * stride
            cx = (torch.arange(w, device=dev) + 0.5) * stride
            ws = _const([s[0] for s in shapes], torch.float32, dev)
            hs = _const([s[1] for s in shapes], torch.float32, dev)
            cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
            cyg, cxg = cyg[..., None], cxg[..., None]
            anch = torch.stack([cxg - ws / 2, cyg - hs / 2,
                                cxg + ws / 2, cyg + hs / 2], -1)
            return anch.reshape(1, -1, 4)

        return apply(rpn_anchors, [x])


def _rpn_iou(boxes):
    """The RPN's IoU of (B, k, 4) corner boxes with each other, (B, k,
    k): each area held above 1e-12, the denominator not (the
    reference's row formula, row i against every j)."""
    bi, bj = boxes[:, :, None, :], boxes[:, None, :, :]
    tl = torch.maximum(bj[..., :2], bi[..., :2])
    br = torch.minimum(bj[..., 2:], bi[..., 2:])
    wh = torch.clamp_min(br - tl, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = torch.clamp_min((boxes[..., 2] - boxes[..., 0]) *
                           (boxes[..., 3] - boxes[..., 1]), 1e-12)
    return inter / (area[:, None, :] + area[:, :, None] - inter)


def _rpn_proposals(sc, lc, anc, pre_nms, post_nms, nms_thresh, imh, imw):
    """The RPN's proposals from its raw scores (B, A, H, W), offsets (B,
    4A, H, W) and anchors (1, HWA, 4), in an image of ``imh`` x ``imw``:
    (rois (B, n, 4), scores (B, n)), n = min(post_nms, pre_nms, HWA);
    suppressed candidates score -1."""
    b = sc.shape[0]
    sc = torch.sigmoid(sc.permute(0, 2, 3, 1).reshape(b, -1))
    lc = lc.permute(0, 2, 3, 1).reshape(b, -1, 4)
    a = anc[0]
    aw = a[:, 2] - a[:, 0]
    ah = a[:, 3] - a[:, 1]
    ax = (a[:, 0] + a[:, 2]) / 2
    ay = (a[:, 1] + a[:, 3]) / 2
    ox = lc[..., 0] * aw + ax
    oy = lc[..., 1] * ah + ay
    ow = torch.exp(torch.clamp(lc[..., 2], -10, 10)) * aw / 2
    oh = torch.exp(torch.clamp(lc[..., 3], -10, 10)) * ah / 2
    boxes = torch.stack(
        [torch.clamp(ox - ow, 0, imw), torch.clamp(oy - oh, 0, imh),
         torch.clamp(ox + ow, 0, imw), torch.clamp(oy + oh, 0, imh)], -1)
    k = min(pre_nms, boxes.shape[1])
    top_s, idx = torch.sort(sc, dim=1, descending=True, stable=True)
    top_s, idx = top_s[:, :k], idx[:, :k]
    top_b = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    # the greedy sweep: a kept candidate drops every later one whose IoU
    # with it passes the threshold
    dev = sc.device
    later = torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
    with torch.no_grad():
        sup = (_rpn_iou(top_b) > nms_thresh) & later
        every = torch.ones(b, k, dtype=torch.bool, device=dev)
        keep = _sweep(every, sup, every)
    masked = torch.where(keep, top_s, -1.0)
    sel_s, sel_i = torch.sort(masked, dim=1, descending=True, stable=True)
    n = min(post_nms, k)
    sel_s, sel_i = sel_s[:, :n], sel_i[:, :n]
    rois = torch.gather(top_b, 1, sel_i[..., None].expand(-1, -1, 4))
    return rois, sel_s


class RPN(HybridBlock):
    """The region proposal head and its static proposal selection:
    returns ``(score, loc, anchors, rois, roi_scores)``, rois (B,
    post_nms, 4)."""

    def __init__(self, channels=256, stride=16, pre_nms=2000, post_nms=300,
                 nms_thresh=0.7, scales=(8, 16, 32), ratios=(0.5, 1, 2),
                 base_size=16, **kwargs):
        super().__init__(**kwargs)
        self._pre_nms = pre_nms
        self._post_nms = post_nms
        self._nms_thresh = nms_thresh
        with self.name_scope():
            self.anchor_gen = RPNAnchorGenerator(
                stride=stride, scales=scales, ratios=ratios,
                base_size=base_size)
            na = self.anchor_gen.num_anchors
            self.conv = nn.Conv2D(channels, 3, 1, 1, activation="relu")
            self.score = nn.Conv2D(na, 1, 1, 0)
            self.loc = nn.Conv2D(na * 4, 1, 1, 0)

    def hybrid_forward(self, F, feat, im_size):
        x = self.conv(feat)
        score = self.score(x)       # (B, na, H, W)
        loc = self.loc(x)           # (B, na * 4, H, W)
        anchors = self.anchor_gen(feat)
        pre_nms, post_nms = self._pre_nms, self._post_nms
        nms_thresh = self._nms_thresh
        imh, imw = im_size

        def rpn_proposals(sc, lc, anc):
            return _rpn_proposals(sc, lc, anc, pre_nms, post_nms,
                                  nms_thresh, imh, imw)

        rois, roi_scores = apply(rpn_proposals, [score, loc, anchors],
                                 n_out=2)
        return score, loc, anchors, rois, roi_scores


class FasterRCNN(HybridBlock):
    """Two stages: RPN proposals, ``ROIAlign``, the box head.  Training
    mode returns ``(cls_pred, box_pred, rois, rpn_score, rpn_loc,
    anchors)``; otherwise ``(ids, scores, bboxes)``, each roi's best
    class after ``box_nms``."""

    def __init__(self, classes, backbone=None, roi_size=(7, 7), stride=16,
                 post_nms=300, nms_thresh=0.3, score_thresh=0.05,
                 rpn_scales=(8, 16, 32), rpn_ratios=(0.5, 1, 2),
                 rpn_base_size=16, **kwargs):
        super().__init__(**kwargs)
        self.classes = list(classes)
        self.num_classes = len(self.classes)
        self._roi_size = roi_size
        self._stride = stride
        self._nms_thresh = nms_thresh
        self._score_thresh = score_thresh
        with self.name_scope():
            self.base = backbone or resnet50_v1b(dilated=False)
            # conv1..layer3 (C4) feed the detector: the classification
            # tail is removed, so it is neither allocated nor saved
            for tail in ("layer4", "avgpool", "fc"):
                if tail in self.base._children:
                    self.base._children.pop(tail)
                    object.__delattr__(self.base, tail)
            self.rpn = RPN(stride=stride, post_nms=post_nms,
                           scales=rpn_scales, ratios=rpn_ratios,
                           base_size=rpn_base_size)
            self.top_features = nn.HybridSequential()
            self.top_features.add(nn.Dense(1024, activation="relu",
                                           flatten=True))
            self.top_features.add(nn.Dense(1024, activation="relu"))
            self.class_predictor = nn.Dense(self.num_classes + 1)
            self.box_predictor = nn.Dense(self.num_classes * 4)

    def _features(self, x):
        b = self.base
        y = b.maxpool(b.relu(b.bn1(b.conv1(x))))
        y = b.layer1(y)
        y = b.layer2(y)
        return b.layer3(y)      # C4, stride 16

    def hybrid_forward(self, F, x):
        im_h, im_w = x.shape[2], x.shape[3]
        feat = self._features(x)
        rpn_score, rpn_loc, anchors, rois, roi_scores = \
            self.rpn(feat, (im_h, im_w))
        b, n_roi = rois.shape[0], rois.shape[1]

        def roi5(r):
            # no gradient to the proposal coordinates
            r = r.detach()
            batch_idx = torch.arange(b, device=r.device).to(r.dtype)[
                :, None].expand(b, n_roi).reshape(-1)
            return torch.cat([batch_idx[:, None], r.reshape(-1, 4)], -1)

        rois5 = apply(roi5, [rois])
        pooled = ROIAlign(feat, rois5, pooled_size=self._roi_size,
                          spatial_scale=1.0 / self._stride, sample_ratio=2)
        top = self.top_features(pooled)
        cls_pred = self.class_predictor(top)    # (B * R, C + 1)
        box_pred = self.box_predictor(top)      # (B * R, C * 4)
        if _tape.is_training():
            return cls_pred, box_pred, rois, rpn_score, rpn_loc, anchors
        ncls, score_thresh = self.num_classes, self._score_thresh

        def rcnn_decode(cp, bp, r):
            prob = torch.exp(torch.clamp(cp - cp.amax(-1, keepdim=True),
                                         -30, 0))
            prob = prob / prob.sum(-1, keepdim=True)
            best_p = prob[:, 1:].amax(-1)               # skip background
            best = prob[:, 1:].argmax(-1)
            deltas = bp.reshape(-1, ncls, 4)
            d = torch.gather(deltas, 1,
                             best[:, None, None].expand(-1, 1, 4))[:, 0]
            rf = r.reshape(-1, 4)
            rw = rf[:, 2] - rf[:, 0]
            rh = rf[:, 3] - rf[:, 1]
            rx = (rf[:, 0] + rf[:, 2]) / 2
            ry = (rf[:, 1] + rf[:, 3]) / 2
            ox = d[:, 0] * 0.1 * rw + rx
            oy = d[:, 1] * 0.1 * rh + ry
            ow = torch.exp(torch.clamp(d[:, 2] * 0.2, -10, 10)) * rw / 2
            oh = torch.exp(torch.clamp(d[:, 3] * 0.2, -10, 10)) * rh / 2
            boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], -1)
            ids = torch.where(best_p > score_thresh, best.to(boxes.dtype),
                              -1.0)
            det = torch.cat([ids[:, None], best_p[:, None], boxes], -1)
            return det.reshape(b, n_roi, 6)

        dets = apply(rcnn_decode, [cls_pred, box_pred, rois])
        dets = box_nms(dets, overlap_thresh=self._nms_thresh,
                       valid_thresh=score_thresh, topk=100,
                       coord_start=2, score_index=1, id_index=0)
        ids = F.slice_axis(dets, axis=-1, begin=0, end=1)
        scores = F.slice_axis(dets, axis=-1, begin=1, end=2)
        bboxes = F.slice_axis(dets, axis=-1, begin=2, end=6)
        return ids, scores, bboxes


_VOC_CLASSES = tuple(f"class_{i}" for i in range(20))


def faster_rcnn_resnet50_v1b(classes=_VOC_CLASSES, **kwargs):
    """Faster R-CNN over ResNet-50 v1b (GluonCV
    faster_rcnn_resnet50_v1b_voc)."""
    return FasterRCNN(classes, **kwargs)
