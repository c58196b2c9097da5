"""YOLOv3 with its Darknet-53 base (counterpart of ``mxnet_tpu/gluon/
model_zoo/vision/yolo.py``; GluonCV darknet.py and yolo3.py).

Each scale's ``YOLOOutputV3`` decodes its map: sigmoid offsets on the
integer grid times the stride, ``exp`` sizes times the anchors,
objectness times the class scores.  In training mode ``YOLOV3`` returns
three lists over the scales (the raw maps, the decoded boxes and
scores); otherwise the best class of each box and its score feed
``box_nms`` over the top ``nms_topk`` (a fixed sweep that reads nothing
back to the host, so a hybridized YOLOv3 captures whole on the card)
and it returns ``(ids, scores, bboxes)``.  The grid and the anchors are
made on the device.  Block structure and structural parameter names are
the reference's.
"""
from __future__ import annotations

import torch

from .... import _tape
from ....ndarray.ndarray import apply
from ....ndarray.ops import _const
from ...block import HybridBlock
from ... import nn

__all__ = ["DarknetV3", "darknet53", "YOLOV3", "yolo3_darknet53"]


def _conv2d(channel, kernel, padding, stride):
    cell = nn.HybridSequential()
    cell.add(nn.Conv2D(channel, kernel_size=kernel, strides=stride,
                       padding=padding, use_bias=False))
    cell.add(nn.BatchNorm(epsilon=1e-5, momentum=0.9))
    cell.add(nn.LeakyReLU(0.1))
    return cell


class DarknetBasicBlockV3(HybridBlock):
    def __init__(self, channel, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential()
        self.body.add(_conv2d(channel, 1, 0, 1))
        self.body.add(_conv2d(channel * 2, 3, 1, 1))

    def hybrid_forward(self, F, x):
        return x + self.body(x)


class DarknetV3(HybridBlock):
    """Darknet-53 (GluonCV darknet.py: stages of 1, 2, 8, 8, 4 blocks)."""

    def __init__(self, layers=(1, 2, 8, 8, 4),
                 channels=(64, 128, 256, 512, 1024), classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(_conv2d(32, 3, 1, 1))
        for nlayer, channel in zip(layers, channels):
            self.features.add(_conv2d(channel, 3, 1, 2))
            for _ in range(nlayer):
                self.features.add(DarknetBasicBlockV3(channel // 2))
        self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = F.Pooling(x, global_pool=True, pool_type="avg")
        return self.output(F.flatten(x))


def darknet53(classes=1000, **kwargs):
    return DarknetV3(classes=classes, **kwargs)


class YOLODetectionBlockV3(HybridBlock):
    def __init__(self, channel, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential()
        for _ in range(2):
            self.body.add(_conv2d(channel, 1, 0, 1))
            self.body.add(_conv2d(channel * 2, 3, 1, 1))
        self.body.add(_conv2d(channel, 1, 0, 1))
        self.tip = _conv2d(channel * 2, 3, 1, 1)

    def hybrid_forward(self, F, x):
        route = self.body(x)
        return route, self.tip(route)


class YOLOOutputV3(HybridBlock):
    """One scale's prediction and its decode (GluonCV YOLOOutputV3)."""

    def __init__(self, num_class, anchors, stride, **kwargs):
        super().__init__(**kwargs)
        self._classes = num_class
        self._num_pred = 1 + 4 + num_class
        self._anchors = [(float(w), float(h))
                         for w, h in zip(anchors[::2], anchors[1::2])]
        self._stride = stride
        self.prediction = nn.Conv2D(len(self._anchors) * self._num_pred,
                                    kernel_size=1, padding=0, strides=1)

    def hybrid_forward(self, F, x):
        pred = self.prediction(x)   # (B, na * npred, H, W)
        na, npred = len(self._anchors), self._num_pred
        stride, anchors, ncls = self._stride, self._anchors, self._classes

        def yolo_decode(p):
            b, _, h, w = p.shape
            dev = p.device
            p = p.reshape(b, na, npred, h, w).permute(0, 3, 4, 1, 2)
            gy, gx = torch.meshgrid(torch.arange(h, device=dev),
                                    torch.arange(w, device=dev),
                                    indexing="ij")
            aw = _const([a[0] for a in anchors], p.dtype, dev)
            ah = _const([a[1] for a in anchors], p.dtype, dev)
            cx = (torch.sigmoid(p[..., 0]) + gx[..., None]) * stride
            cy = (torch.sigmoid(p[..., 1]) + gy[..., None]) * stride
            bw = torch.exp(p[..., 2]) * aw
            bh = torch.exp(p[..., 3]) * ah
            scores = torch.sigmoid(p[..., 4:5]) * torch.sigmoid(p[..., 5:])
            boxes = torch.stack([cx - bw / 2, cy - bh / 2,
                                 cx + bw / 2, cy + bh / 2], -1)
            return boxes.reshape(b, -1, 4), scores.reshape(b, -1, ncls)

        boxes, scores = apply(yolo_decode, [pred], n_out=2)
        return pred, boxes, scores


class _Upsample(HybridBlock):
    """Nearest upsampling by an integer ``scale``."""

    def __init__(self, scale=2, **kwargs):
        super().__init__(**kwargs)
        self._scale = scale

    def hybrid_forward(self, F, x):
        s = self._scale

        def upsample(d):
            b, c, h, w = d.shape
            return d[:, :, :, None, :, None].expand(b, c, h, s, w, s) \
                .reshape(b, c, h * s, w * s)
        return apply(upsample, [x])


_COCO_ANCHORS = [[10, 13, 16, 30, 33, 23],
                 [30, 61, 62, 45, 59, 119],
                 [116, 90, 156, 198, 373, 326]]
_STRIDES = [8, 16, 32]


class YOLOV3(HybridBlock):
    """YOLOv3 (GluonCV yolo3.py).  Training mode: ``(preds, boxes,
    scores)``, a list each over the scales, the largest stride first;
    otherwise ``(ids, scores, bboxes)`` after the NMS."""

    def __init__(self, stages, channels=(512, 256, 128), classes=80,
                 anchors=_COCO_ANCHORS, strides=_STRIDES, nms_thresh=0.45,
                 nms_topk=400, post_nms=100, **kwargs):
        super().__init__(**kwargs)
        self.classes = classes
        self.nms_thresh = nms_thresh
        self.nms_topk = nms_topk
        self.post_nms = post_nms
        self.stages = nn.HybridSequential()
        for s in stages:
            self.stages.add(s)
        self.yolo_blocks = nn.HybridSequential()
        self.yolo_outputs = nn.HybridSequential()
        self.transitions = nn.HybridSequential()
        # top-down: the largest stride first
        for i, (ch, anc, st) in enumerate(
                zip(channels, reversed(anchors), reversed(strides))):
            self.yolo_blocks.add(YOLODetectionBlockV3(ch))
            self.yolo_outputs.add(YOLOOutputV3(classes, anc, st))
            if i < len(channels) - 1:
                self.transitions.add(_conv2d(ch // 2, 1, 0, 1))
        self.upsample = _Upsample(2)

    def hybrid_forward(self, F, x):
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        feats = feats[::-1]         # C5, C4, C3
        all_preds, all_boxes, all_scores = [], [], []
        route = None
        for i, (block, output) in enumerate(
                zip(self.yolo_blocks, self.yolo_outputs)):
            f = feats[i]
            if route is not None:
                up = self.upsample(self.transitions[i - 1](route))
                f = F.concat(up, f, dim=1)
            route, tip = block(f)
            pred, boxes, scores = output(tip)
            all_preds.append(pred)
            all_boxes.append(boxes)
            all_scores.append(scores)
        if _tape.is_training():
            return all_preds, all_boxes, all_scores
        boxes = F.concat(*all_boxes, dim=1)       # (B, N, 4)
        scores = F.concat(*all_scores, dim=1)     # (B, N, C)
        # each box's best class and its score
        cls_id = F.argmax(scores, axis=-1)
        best = F.max(scores, axis=-1)
        dets = F.concat(F.expand_dims(cls_id, -1), F.expand_dims(best, -1),
                        boxes, dim=-1)
        dets = F.contrib.box_nms(dets, overlap_thresh=self.nms_thresh,
                                 valid_thresh=0.01, topk=self.nms_topk,
                                 coord_start=2, score_index=1, id_index=0)
        ids = F.slice_axis(dets, axis=-1, begin=0, end=1)
        sc = F.slice_axis(dets, axis=-1, begin=1, end=2)
        bb = F.slice_axis(dets, axis=-1, begin=2, end=6)
        return ids, sc, bb


def yolo3_darknet53(classes=80, **kwargs):
    """YOLOv3 over Darknet-53 (GluonCV yolo3_darknet53_coco)."""
    base = darknet53()
    feats = list(base.features._children.values())
    # the stages end at C3 (the first 8-block stage), C4 and C5
    s1 = nn.HybridSequential()
    for b in feats[:15]:
        s1.add(b)
    s2 = nn.HybridSequential()
    for b in feats[15:24]:
        s2.add(b)
    s3 = nn.HybridSequential()
    for b in feats[24:]:
        s3.add(b)
    return YOLOV3([s1, s2, s3], classes=classes, **kwargs)
