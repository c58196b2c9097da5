"""``mx.nd.contrib``: the detection and miscellaneous contrib operators.

Counterpart of ``mxnet_tpu/ndarray/contrib.py``, with its 31 names: the
box ops (``box_iou``, ``box_nms``, ``box_encode``, ``box_decode``,
``bipartite_matching``), ``ROIAlign``/``ROIPooling``, the SSD ops
(``MultiBoxPrior``, ``MultiBoxTarget``, ``MultiBoxDetection``), the RPN
ops (``Proposal``, ``MultiProposal``), ``getnnz``, ``quantize``,
``arange_like``, ``fused_gelu``, ``BilinearResize2D``,
``AdaptiveAvgPooling2D``, ``DeformableConvolution``, ``boolean_mask``,
``index_copy``, ``index_array``, ``allclose``, ``gradientmultiplier``
(identity with a scaled gradient, a ``torch.autograd.Function``),
``fft``/``ifft`` (interleaved real and imaginary parts; ``ifft``
unnormalized, times n), ``count_sketch``, ``quadratic``,
``div_sqrt_dim``, ``edge_id`` and ``fused_linear_cross_entropy``; and
the helper ``math_sqrt``.

Every op is the reference's XLA code in plain PyTorch, batched where the
reference maps over a batch (``jax.vmap``), with its semantics and
corners: orderings are stable sorts (``box_nms``'s candidate order,
``Proposal``'s top-k), argmax sweeps take the first maximum
(``bipartite_matching``, ``MultiBoxTarget``), suppressed boxes keep
their rows with score -1.  The suppression sweeps of ``box_nms`` and the
RPN ops run a fixed trip over the top-k candidates, a few device ops a
candidate, and read nothing back to the host, so a CUDA graph captures
them (a launch each, many at SSD's and R-CNN's top-k: their time is
printed on the card, and making them fast is later work).  Constants are
made on the device (fills and arithmetic, no host copy), so every op
captures in a hybridized block except ``boolean_mask`` (its output size
comes from the data) and ``edge_id`` (host numpy, as in the reference),
which refuse a capture (``ops.host_sync``).

Where the reference leaves a duplicate scatter to XLA's order
(``MultiBoxTarget``'s forced matches of two ground truths on one
anchor), the port takes the later ground truth on every device, as XLA's
CPU scatter does.
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ops.blocked_cross_entropy import fused_linear_cross_entropy as _f
from .ndarray import NDArray, apply, array
from .ops import _const, _nd, host_sync

__all__ = ["box_iou", "box_nms", "box_encode", "box_decode",
           "bipartite_matching", "ROIAlign", "ROIPooling",
           "MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
           "getnnz", "quantize", "arange_like", "fused_gelu",
           "BilinearResize2D", "AdaptiveAvgPooling2D",
           "DeformableConvolution",
           "boolean_mask", "index_copy", "index_array", "allclose",
           "gradientmultiplier", "fft", "ifft", "count_sketch",
           "quadratic", "div_sqrt_dim", "edge_id",
           "Proposal", "MultiProposal", "fused_linear_cross_entropy"]

_INF = float("inf")


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------

def _corner(box, fmt):
    """[..., 4] boxes as corners (xmin, ymin, xmax, ymax)."""
    if fmt == "corner":
        return box
    if fmt == "center":
        x, y, w, h = box.unbind(-1)
        return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)
    raise MXNetError(f"unknown box format {fmt!r}")


def _pairwise_iou(lhs, rhs):
    """IoU of [..., N, 4] x [..., M, 4] corner boxes -> [..., N, M]."""
    l = lhs[..., :, None, :]
    r = rhs[..., None, :, :]
    tl = torch.maximum(l[..., :2], r[..., :2])
    br = torch.minimum(l[..., 2:], r[..., 2:])
    wh = torch.clamp_min(br - tl, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_l = torch.clamp_min(l[..., 2] - l[..., 0], 0.0) * \
        torch.clamp_min(l[..., 3] - l[..., 1], 0.0)
    area_r = torch.clamp_min(r[..., 2] - r[..., 0], 0.0) * \
        torch.clamp_min(r[..., 3] - r[..., 1], 0.0)
    return inter / torch.clamp_min(area_l + area_r - inter, 1e-12)


def box_iou(lhs, rhs, format="corner"):
    """Pairwise IoU (reference: src/operator/contrib/bounding_box.cc)."""
    def box_iou(a, b):
        return _pairwise_iou(_corner(a, format), _corner(b, format))
    return apply(box_iou, [lhs, rhs])


def _sweep(keep, sup, alive):
    """The fixed-trip suppression sweep over k sorted candidates, batched:
    candidate i, when still kept and ``alive[:, i]``, drops every later
    candidate ``sup[:, i]`` marks.  ``keep`` (B, k) bool, updated."""
    for i in range(keep.shape[1]):
        hit = keep[:, i:i + 1] & alive[:, i:i + 1]
        keep = keep & ~(sup[:, i] & hit)
    return keep


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False,
            in_format="corner", out_format="corner", background_id=-1):
    """Non-maximum suppression, MXNet semantics: ``data`` (..., N, K);
    rows sorted by score (descending, stable), suppressed rows keep their
    fields with score -1; the sweep runs over the top ``topk``
    candidates."""
    def box_nms(d):
        shape = d.shape
        d2 = d.reshape((-1,) + tuple(shape[-2:]))
        bt, n = d2.shape[0], d2.shape[1]
        k = n if topk < 0 else min(int(topk), n)
        scores = d2[:, :, score_index]
        ids = d2[:, :, id_index] if id_index >= 0 else \
            torch.zeros_like(scores)
        valid = scores > valid_thresh
        if background_id >= 0 and id_index >= 0:
            valid = valid & (ids != background_id)
        order = torch.argsort(-torch.where(valid, scores, -_INF), dim=1,
                              stable=True)
        cs = coord_start
        boxes = _corner(d2[:, :, cs:cs + 4], in_format)
        cand = order[:, :k]
        sboxes = torch.gather(boxes, 1, cand[..., None].expand(-1, -1, 4))
        svalid = torch.gather(valid, 1, cand)
        iou = _pairwise_iou(sboxes, sboxes)
        if not force_suppress and id_index >= 0:
            sids = torch.gather(ids, 1, cand)
            iou = torch.where(sids[:, :, None] == sids[:, None, :], iou, 0.0)
        later = torch.ones(k, k, dtype=torch.bool, device=d.device).triu(1)
        keep_k = _sweep(torch.ones(bt, k, dtype=torch.bool, device=d.device),
                        (iou > overlap_thresh) & later, svalid)
        keep = torch.zeros(bt, n, dtype=torch.bool, device=d.device)
        keep[:, :k] = keep_k & svalid
        out = torch.gather(d2, 1, order[..., None].expand(-1, -1,
                                                          d2.shape[2]))
        out = out.clone()
        out[:, :, score_index] = torch.where(keep, out[:, :, score_index],
                                             -1.0)
        if out_format != in_format:
            box_out = _corner(out[:, :, cs:cs + 4], in_format)
            if out_format == "center":
                xmin, ymin, xmax, ymax = box_out.unbind(-1)
                box_out = torch.stack([(xmin + xmax) / 2, (ymin + ymax) / 2,
                                       xmax - xmin, ymax - ymin], -1)
            out[:, :, cs:cs + 4] = box_out
        return out.reshape(shape)
    return apply(box_nms, [data])


def box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """Matched ground-truth boxes as normalized offsets from their
    anchors: ``(targets, masks)`` (B, N, 4) each; ``samples`` (B, N), 1
    for a positive; ``matches`` (B, N) ground-truth index."""
    def box_encode(s, m, a, r):
        mu = _const(means, torch.float32, a.device)
        sd = _const(stds, torch.float32, a.device)
        g = torch.gather(r, 1, m[..., None].long().clamp_min(0)
                         .expand(-1, -1, 4))
        aw = a[..., 2] - a[..., 0]
        ah = a[..., 3] - a[..., 1]
        ax = (a[..., 0] + a[..., 2]) / 2
        ay = (a[..., 1] + a[..., 3]) / 2
        gw = g[..., 2] - g[..., 0]
        gh = g[..., 3] - g[..., 1]
        gx = (g[..., 0] + g[..., 2]) / 2
        gy = (g[..., 1] + g[..., 3]) / 2
        t = torch.stack([(gx - ax) / torch.clamp_min(aw, 1e-12),
                         (gy - ay) / torch.clamp_min(ah, 1e-12),
                         torch.log(torch.clamp_min(gw, 1e-12) /
                                   torch.clamp_min(aw, 1e-12)),
                         torch.log(torch.clamp_min(gh, 1e-12) /
                                   torch.clamp_min(ah, 1e-12))], -1)
        t = (t - mu) / sd
        mask = (s > 0.5)[..., None].to(t.dtype)
        return t * mask, mask.expand(-1, -1, 4) * 0 + mask
    return apply(box_encode, [samples, matches, anchors, refs], n_out=2)


def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="center"):
    """Offsets back to corner boxes (the inverse of ``box_encode``);
    ``format`` is the anchors'."""
    def box_decode(d, a):
        if format == "corner":
            aw = a[..., 2] - a[..., 0]
            ah = a[..., 3] - a[..., 1]
            ax = (a[..., 0] + a[..., 2]) / 2
            ay = (a[..., 1] + a[..., 3]) / 2
        else:
            ax, ay, aw, ah = a.unbind(-1)
        t = d * _const((std0, std1, std2, std3), torch.float32, d.device)
        ox = t[..., 0] * aw + ax
        oy = t[..., 1] * ah + ay
        tw, th = t[..., 2], t[..., 3]
        if clip > 0:
            tw = torch.clamp_max(tw, clip)
            th = torch.clamp_max(th, clip)
        ow = torch.exp(tw) * aw / 2
        oh = torch.exp(th) * ah / 2
        return torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], -1)
    return apply(box_decode, [data, anchors])


def bipartite_matching(data, threshold=1e-12, is_ascend=False, topk=-1):
    """Greedy bipartite matching of a (B, N, M) score matrix: ``(rows,
    cols)``, each row's matched column and each column's matched row (-1
    for none), as float32.  A fixed-trip sweep of first-maximum picks."""
    def bipartite_matching(d):
        sign = 1.0 if not is_ascend else -1.0
        b, n, m = d.shape
        k = min(n, m) if topk < 0 else min(int(topk), n, m)
        s = d * sign
        bar = threshold * sign if not is_ascend else -_INF
        row = torch.full((b, n), -1.0, dtype=torch.float32, device=d.device)
        col = torch.full((b, m), -1.0, dtype=torch.float32, device=d.device)
        ar_n = torch.arange(n, device=d.device)
        ar_m = torch.arange(m, device=d.device)
        for _ in range(k):
            flat = torch.argmax(s.reshape(b, -1), dim=1)
            i, j = flat // m, flat % m
            ok = s.reshape(b, -1).gather(1, flat[:, None])[:, 0] > bar
            hit_i = (ar_n[None] == i[:, None]) & ok[:, None]
            hit_j = (ar_m[None] == j[:, None]) & ok[:, None]
            row = torch.where(hit_i, j[:, None].float(), row)
            col = torch.where(hit_j, i[:, None].float(), col)
            s = torch.where(hit_i[:, :, None] | hit_j[:, None, :], -_INF, s)
        return row, col
    return apply(bipartite_matching, [data], n_out=2)


# ---------------------------------------------------------------------------
# regions of interest
# ---------------------------------------------------------------------------

def _gather_hw(d, b, y, x):
    """``d[b, :, y, x]`` for int64 ``b`` (R,) and ``y``/``x`` (R, P):
    (R, P, C), one gather from the channels-last view."""
    B, C, H, W = d.shape
    flat = d.permute(0, 2, 3, 1).reshape(B * H * W, C)
    idx = (b[:, None] * H + y) * W + x
    return flat.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + (C,))


def ROIAlign(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
             sample_ratio=-1, position_sensitive=False, aligned=False):
    """ROI Align (reference: src/operator/contrib/roi_align.cc): ``data``
    (B, C, H, W), ``rois`` (R, 5) rows [batch, x0, y0, x1, y1] -> (R, C,
    ph, pw); a static grid of ``sample_ratio`` (<= 0: 2) samples a side,
    each bilinear, averaged a bin."""
    if position_sensitive:
        raise MXNetError("position_sensitive ROIAlign not supported")
    ph, pw = (pooled_size if isinstance(pooled_size, (tuple, list))
              else (pooled_size, pooled_size))
    sr = sample_ratio if sample_ratio > 0 else 2

    def ROIAlign(d, r):
        B, C, h, w = d.shape
        dev = d.device
        off = 0.5 if aligned else 0.0
        b = r[:, 0].long().clamp(0, B - 1)
        box = (r[:, 1:5] - off / spatial_scale) * spatial_scale
        x0, y0, x1, y1 = box.unbind(-1)
        rw = torch.clamp_min(x1 - x0, 1.0)
        rh = torch.clamp_min(y1 - y0, 1.0)
        bin_w = (rw / pw)[:, None, None]
        bin_h = (rh / ph)[:, None, None]
        i_s = torch.arange(sr, device=dev) + 0.5
        ys = y0[:, None, None] + torch.arange(ph, device=dev)[None, :, None] \
            * bin_h + i_s[None, None, :] / sr * bin_h         # (R, ph, sr)
        xs = x0[:, None, None] + torch.arange(pw, device=dev)[None, :, None] \
            * bin_w + i_s[None, None, :] / sr * bin_w         # (R, pw, sr)
        R = r.shape[0]
        yy = ys[:, :, None, :, None].expand(R, ph, pw, sr, sr) \
            .reshape(R, -1).clamp(0.0, h - 1.0)
        xx = xs[:, None, :, None, :].expand(R, ph, pw, sr, sr) \
            .reshape(R, -1).clamp(0.0, w - 1.0)
        y0i = torch.floor(yy).long()
        x0i = torch.floor(xx).long()
        y1i = torch.clamp_max(y0i + 1, h - 1)
        x1i = torch.clamp_max(x0i + 1, w - 1)
        wy = (yy - y0i)[..., None]
        wx = (xx - x0i)[..., None]
        vals = (_gather_hw(d, b, y0i, x0i) * (1 - wy) * (1 - wx) +
                _gather_hw(d, b, y0i, x1i) * (1 - wy) * wx +
                _gather_hw(d, b, y1i, x0i) * wy * (1 - wx) +
                _gather_hw(d, b, y1i, x1i) * wy * wx)         # (R, P, C)
        vals = vals.reshape(R, ph, pw, sr * sr, C).mean(3)
        return vals.permute(0, 3, 1, 2)
    return apply(ROIAlign, [data, rois])


def ROIPooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """Max ROI pooling (reference: src/operator/roi_pooling.cc): each
    bin's maximum over the feature cells it covers, 0 for an empty bin;
    the maximum taken over rows, then columns (the same set)."""
    ph, pw = (pooled_size if isinstance(pooled_size, (tuple, list))
              else (pooled_size, pooled_size))

    def ROIPooling(d, r):
        B, C, h, w = d.shape
        dev = d.device
        b = r[:, 0].long().clamp(0, B - 1)
        x0, y0, x1, y1 = torch.round(r[:, 1:5] * spatial_scale).unbind(-1)
        rw = torch.clamp_min(x1 - x0 + 1, 1.0)
        rh = torch.clamp_min(y1 - y0 + 1, 1.0)
        ys = torch.arange(h, device=dev)
        xs = torch.arange(w, device=dev)

        def bins(coord, lo, hi, extent, n):
            # a true division by n (the card multiplies by the
            # reciprocal of a host scalar): the bins are the CPU's
            p = torch.floor((coord[None] - lo[:, None]) /
                            (extent / extent.new_full((), n))[:, None])
            inside = (coord[None] >= lo[:, None]) & \
                (coord[None] <= hi[:, None])
            return torch.where(inside, p, -1.0).clamp(-1, n - 1)
        by = bins(ys, y0, y1, rh, ph)                       # (R, h)
        bx = bins(xs, x0, x1, rw, pw)                       # (R, w)
        feat = d.index_select(0, b)                         # (R, C, h, w)
        rows = torch.stack([
            torch.where((by == i)[:, None, :, None], feat, -_INF).amax(2)
            for i in range(ph)], 2)                         # (R, C, ph, w)
        out = torch.stack([
            torch.where((bx == j)[:, None, None, :], rows, -_INF).amax(3)
            for j in range(pw)], 3)                         # (R, C, ph, pw)
        return torch.where(torch.isfinite(out), out, 0.0)
    return apply(ROIPooling, [data, rois])


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def math_sqrt(x):
    return float(x) ** 0.5


def MultiBoxPrior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                  steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors of a feature map (reference: multibox_prior.cc): ``data``
    (B, C, H, W) -> (1, H*W*(S+R-1), 4) corner anchors in [0, 1]: the
    sizes at the first ratio, then the other ratios at the first size."""
    sizes = tuple(float(s) for s in sizes)
    ratios = tuple(float(r) for r in ratios)

    def MultiBoxPrior(d):
        h, w = d.shape[-2], d.shape[-1]
        dev = d.device
        step_y = steps[0] if steps[0] > 0 else 1.0 / h
        step_x = steps[1] if steps[1] > 0 else 1.0 / w
        cy = (torch.arange(h, device=dev) + offsets[0]) * step_y
        cx = (torch.arange(w, device=dev) + offsets[1]) * step_x
        ws = [s * math_sqrt(ratios[0]) for s in sizes] + \
            [sizes[0] * math_sqrt(r) for r in ratios[1:]]
        hs = [s / math_sqrt(ratios[0]) for s in sizes] + \
            [sizes[0] / math_sqrt(r) for r in ratios[1:]]
        ws = _const(ws, torch.float32, dev)
        hs = _const(hs, torch.float32, dev)
        cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
        cyg, cxg = cyg[..., None], cxg[..., None]
        out = torch.stack([cxg - ws / 2, cyg - hs / 2,
                           cxg + ws / 2, cyg + hs / 2], -1).reshape(1, -1, 4)
        return out.clamp(0.0, 1.0) if clip else out
    return apply(MultiBoxPrior, [data])


def _softmax(x, dim):
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


def MultiBoxTarget(anchor, label, cls_pred, overlap_threshold=0.5,
                   ignore_label=-1.0, negative_mining_ratio=3.0,
                   negative_mining_thresh=0.5, minimum_negative_samples=0,
                   variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets (reference: multibox_target.cc): ``anchor``
    (1, N, 4) corners, ``label`` (B, M, 5) rows [cls, x0, y0, x1, y1]
    (cls -1 pads), ``cls_pred`` (B, classes+1, N) -> ``(box_target (B,
    N*4), box_mask (B, N*4), cls_target (B, N))``, with hard negative
    mining by background confidence."""
    def MultiBoxTarget(anc, lab, pred):
        anc = anc[0]
        n = anc.shape[0]
        B, m = lab.shape[0], lab.shape[1]
        dev = anc.device
        var = _const(variances, torch.float32, dev)
        gt_valid = lab[:, :, 0] >= 0                           # (B, M)
        iou = _pairwise_iou(anc[None], lab[:, :, 1:5])         # (B, N, M)
        iou = torch.where(gt_valid[:, None, :], iou, 0.0)
        best_iou, best_gt = iou.amax(2), torch.argmax(iou, dim=2)
        pos = best_iou >= overlap_threshold
        # force-match: each valid ground truth claims its best anchor
        # (padded rows to a dropped slot n; of two on one anchor, the later)
        best_anchor = torch.argmax(iou, dim=1)                 # (B, M)
        safe = torch.where(gt_valid, best_anchor, n)
        forced = torch.zeros(B, n + 1, dtype=torch.bool, device=dev)
        forced.scatter_(1, safe, True)
        forced = forced[:, :n]
        gt_ids = torch.arange(m, device=dev).expand(B, m)
        forced_gt = torch.zeros(B, n + 1, dtype=best_gt.dtype, device=dev)
        forced_gt.scatter_reduce_(1, safe, gt_ids, "amax")
        pos = pos | forced
        best_gt = torch.where(forced, forced_gt[:, :n], best_gt)
        rows = torch.gather(lab, 1, best_gt.clamp_min(0)[..., None]
                            .expand(-1, -1, 5))                # (B, N, 5)
        g = rows[..., 1:5]
        aw = anc[:, 2] - anc[:, 0]
        ah = anc[:, 3] - anc[:, 1]
        ax = (anc[:, 0] + anc[:, 2]) / 2
        ay = (anc[:, 1] + anc[:, 3]) / 2
        gw = g[..., 2] - g[..., 0]
        gh = g[..., 3] - g[..., 1]
        gx = (g[..., 0] + g[..., 2]) / 2
        gy = (g[..., 1] + g[..., 3]) / 2
        t = torch.stack([
            (gx - ax) / torch.clamp_min(aw, 1e-12) / var[0],
            (gy - ay) / torch.clamp_min(ah, 1e-12) / var[1],
            torch.log(torch.clamp_min(gw, 1e-12) /
                      torch.clamp_min(aw, 1e-12)) / var[2],
            torch.log(torch.clamp_min(gh, 1e-12) /
                      torch.clamp_min(ah, 1e-12)) / var[3]], -1)
        box_target = torch.where(pos[..., None], t, 0.0).reshape(B, -1)
        box_mask = torch.where(pos[..., None], torch.ones_like(t), 0.0) \
            .reshape(B, -1)
        cls_target = torch.where(pos, rows[..., 0] + 1, 0.0)
        if negative_mining_ratio > 0:
            bg_conf = 1.0 - _softmax(pred, 1)[:, 0]
            neg_score = torch.where(pos, -_INF, bg_conf)
            num_pos = pos.sum(1)
            max_neg = torch.clamp_min(
                (negative_mining_ratio * num_pos).int(),
                minimum_negative_samples)
            rank = torch.argsort(torch.argsort(-neg_score, dim=1,
                                               stable=True),
                                 dim=1, stable=True)
            keep_neg = (rank < max_neg[:, None]) & ~pos
            cls_target = torch.where(pos | keep_neg, cls_target,
                                     float(ignore_label))
        return box_target, box_mask, cls_target
    return apply(MultiBoxTarget, [anchor, label, cls_pred], n_out=3)


def MultiBoxDetection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                      background_id=0, nms_threshold=0.5, force_suppress=False,
                      variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """SSD decode and NMS (reference: multibox_detection.cc):
    ``cls_prob`` (B, classes+1, N), ``loc_pred`` (B, N*4), ``anchor`` (1,
    N, 4) -> (B, N, 6) rows [cls_id, score, x0, y0, x1, y1], cls_id -1
    below ``threshold``, then :func:`box_nms`."""
    def MultiBoxDecode(cp, lp, anc):
        anc = anc[0]
        n = anc.shape[0]
        t = lp.reshape(lp.shape[0], n, 4) * \
            _const(variances, torch.float32, lp.device)
        aw = anc[:, 2] - anc[:, 0]
        ah = anc[:, 3] - anc[:, 1]
        ax = (anc[:, 0] + anc[:, 2]) / 2
        ay = (anc[:, 1] + anc[:, 3]) / 2
        ox = t[..., 0] * aw + ax
        oy = t[..., 1] * ah + ay
        ow = torch.exp(t[..., 2]) * aw / 2
        oh = torch.exp(t[..., 3]) * ah / 2
        boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], -1)
        if clip:
            boxes = boxes.clamp(0.0, 1.0)
        bg = (torch.arange(cp.shape[1], device=cp.device) ==
              background_id)[None, :, None]
        masked = torch.where(bg, -_INF, cp)
        score, cls_id = masked.amax(1), torch.argmax(masked, dim=1)
        cls_id = cls_id.to(boxes.dtype) - (1.0 if background_id == 0
                                           else 0.0)
        cls_id = torch.where(score > threshold, cls_id, -1.0)
        return torch.cat([cls_id[..., None], score[..., None], boxes], -1)
    out = apply(MultiBoxDecode, [cls_prob, loc_pred, anchor])
    return box_nms(out, overlap_thresh=nms_threshold, valid_thresh=threshold,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)


# ---------------------------------------------------------------------------
# elementwise, shapes and the rest
# ---------------------------------------------------------------------------

def getnnz(data, axis=None):
    """The count of nonzeros (over ``axis``), int32 (the reference's
    int64 without x64)."""
    def getnnz(d):
        nz = d != 0
        return (nz.sum() if axis is None else nz.sum(axis)).to(torch.int32)
    return apply(getnnz, [data])


def quantize(data, min_range, max_range, out_type="uint8"):
    """Affine quantization to uint8 ([0, 255]) or int8 ([-127, 127]) over
    [min_range, max_range] (reference: src/operator/quantization/)."""
    def quantize(d, lo, hi):
        qmin, qmax = (0.0, 255.0) if out_type == "uint8" else (-127.0, 127.0)
        scale = (qmax - qmin) / torch.clamp_min(hi - lo, 1e-12)
        q = torch.clamp(torch.round((d - lo) * scale + qmin), qmin, qmax)
        return q.to(torch.uint8 if out_type == "uint8" else torch.int8)
    return apply(quantize, [data, _nd(min_range, data),
                            _nd(max_range, data)])


def arange_like(data, start=0.0, step=1.0, axis=None, repeat=1):
    """``nd.arange_like`` (the same op, exported here as in the
    reference)."""
    from .ops import arange_like as _al
    return _al(data, start=start, step=step, repeat=repeat, axis=axis)


def fused_gelu(data):
    """Exact (erf) GELU."""
    return apply(lambda d: F.gelu(d), [data])


def BilinearResize2D(data, height=None, width=None, scale_height=None,
                     scale_width=None, like=None, mode="size",
                     align_corners=True):
    """Bilinear resize of NCHW: with ``align_corners`` (the reference's
    default) the (in-1)/(out-1) map, an output of 1 on an axis sampling
    the first pixel; without, the half-pixel map (the reference's
    ``jax.image.resize``, antialiased when shrinking)."""
    if like is not None:
        height, width = like.shape[2], like.shape[3]

    def BilinearResize2D(d):
        h = height if height is not None else int(d.shape[2] * scale_height)
        w = width if width is not None else int(d.shape[3] * scale_width)
        if not align_corners:
            return F.interpolate(d, size=(h, w), mode="bilinear",
                                 align_corners=False, antialias=True)
        hi, wi = d.shape[2], d.shape[3]
        dev = d.device
        rows = torch.linspace(0.0, hi - 1.0, h, device=dev) if h > 1 else \
            torch.zeros(1, device=dev)
        cols = torch.linspace(0.0, wi - 1.0, w, device=dev) if w > 1 else \
            torch.zeros(1, device=dev)
        r0 = torch.floor(rows).long().clamp(0, hi - 1)
        r1 = (r0 + 1).clamp(0, hi - 1)
        fr = (rows - r0).to(d.dtype)[None, None, :, None]
        c0 = torch.floor(cols).long().clamp(0, wi - 1)
        c1 = (c0 + 1).clamp(0, wi - 1)
        fc = (cols - c0).to(d.dtype)[None, None, None, :]
        top = d[:, :, r0, :] * (1 - fr) + d[:, :, r1, :] * fr
        return top[:, :, :, c0] * (1 - fc) + top[:, :, :, c1] * fc
    return apply(BilinearResize2D, [data])


def AdaptiveAvgPooling2D(data, output_size=1):
    """Adaptive average pooling to (oh, ow): bin i of n over an extent e
    spans [i*e//n, ceil((i+1)*e/n)) (at least one cell)."""
    oh, ow = (output_size if isinstance(output_size, (tuple, list))
              else (output_size, output_size))

    def AdaptiveAvgPooling2D(d):
        h, w = d.shape[2], d.shape[3]
        rows = [d[:, :, (i * h) // oh:((i + 1) * h + oh - 1) // oh or 1, :]
                .mean(2, keepdim=True) for i in range(oh)]
        col = torch.cat(rows, 2)
        cols = [col[:, :, :, (j * w) // ow:((j + 1) * w + ow - 1) // ow or 1]
                .mean(3, keepdim=True) for j in range(ow)]
        return torch.cat(cols, 3)
    return apply(AdaptiveAvgPooling2D, [data])


def DeformableConvolution(data, offset, weight, bias=None, kernel=(3, 3),
                          stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                          num_filter=1, num_deformable_group=1,
                          no_bias=False, **kwargs):
    """Deformable convolution v1 (reference: deformable_convolution.cc):
    ``data`` (B, C, H, W), ``offset`` (B, dg*2*kh*kw, Ho, Wo) (y, x) pairs
    a tap, ``weight`` (O, C, kh, kw).  The deformable im2col is a
    bilinear gather (a corner outside the image reads 0), then one
    (O, C*kh*kw) x (C*kh*kw, Ho*Wo) product a batch."""
    kh, kw = kernel
    sh, sw = stride
    ph, pw = pad
    dh, dw = dilate
    dg = num_deformable_group

    def DeformableConvolution(*arrs):
        d, off, w = arrs[0], arrs[1], arrs[2]
        b = arrs[3] if len(arrs) > 3 else None
        B, C, H, W = d.shape
        O = w.shape[0]
        K = kh * kw
        Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        dev = d.device
        base_y = torch.arange(Ho, device=dev) * sh - ph
        base_x = torch.arange(Wo, device=dev) * sw - pw
        taps = torch.arange(K, device=dev)
        ti, tj = (taps // kw) * dh, (taps % kw) * dw
        off = off.reshape(B, dg, K, 2, Ho, Wo)
        py = base_y[None, None, None, :, None] + ti[None, None, :, None,
                                                    None] + off[:, :, :, 0]
        px = base_x[None, None, None, None, :] + tj[None, None, :, None,
                                                    None] + off[:, :, :, 1]
        y0 = torch.floor(py)
        x0 = torch.floor(px)
        wy = py - y0
        wx = px - x0
        img = d.reshape(B, dg, C // dg, H * W)

        def at(yy, xx):
            yi = yy.long().clamp(0, H - 1)
            xi = xx.long().clamp(0, W - 1)
            valid = ((yy >= 0) & (yy <= H - 1) & (xx >= 0) &
                     (xx <= W - 1)).to(d.dtype)
            idx = (yi * W + xi).reshape(B, dg, 1, -1) \
                .expand(-1, -1, C // dg, -1)
            return torch.gather(img, 3, idx).reshape(
                B, dg, C // dg, K, Ho, Wo) * valid[:, :, None]
        wy, wx = wy[:, :, None], wx[:, :, None]
        cols = (at(y0, x0) * (1 - wy) * (1 - wx) +
                at(y0, x0 + 1) * (1 - wy) * wx +
                at(y0 + 1, x0) * wy * (1 - wx) +
                at(y0 + 1, x0 + 1) * wy * wx)
        cols = cols.reshape(B, C * K, Ho * Wo)
        out = torch.matmul(w.reshape(O, C * K), cols)
        out = out.reshape(B, O, Ho, Wo).to(d.dtype)
        if b is not None:
            out = out + b.reshape(1, O, 1, 1)
        return out
    inputs = [data, offset, weight]
    if bias is not None and not no_bias:
        inputs.append(bias)
    return apply(DeformableConvolution, inputs)


def boolean_mask(data, index, axis=0):
    """The entries of ``data`` along ``axis`` where ``index`` is nonzero:
    its size comes from the data, so it refuses a CUDA graph capture."""
    host_sync("boolean_mask")

    def boolean_mask(d, idx):
        keep = torch.nonzero(idx.bool()).reshape(-1)
        return d.index_select(axis, keep)
    return apply(boolean_mask, [data, _nd(index, data)])


def index_copy(old_tensor, index_vector, new_tensor):
    """``old_tensor`` with rows ``index_vector`` replaced by
    ``new_tensor``'s (out of place; differentiable in both tensors)."""
    def index_copy(old, idx, new):
        return torch.index_copy(old, 0, idx.long(), new)
    return apply(index_copy, [old_tensor, _nd(index_vector, old_tensor),
                              _nd(new_tensor, old_tensor)])


def index_array(data, axes=None):
    """int32 coordinates of ``data``'s shape: ``out[i_0, ...] = (i_0,
    ...)`` (only ``axes``, when given), stacked on a last axis."""
    def index_array(d):
        sel = range(d.dim()) if axes is None else axes
        grids = [torch.arange(d.shape[a], dtype=torch.int32,
                              device=d.device).reshape(
            tuple(d.shape[a] if i == a else 1 for i in range(d.dim())))
            .expand(d.shape) for a in sel]
        return torch.stack(grids, -1)
    return apply(index_array, [data])


def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=True):
    """1.0 when every element of ``a`` is close to ``b``'s, else 0.0 (a
    float32 scalar on the device)."""
    def allclose(x, y):
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = torch.broadcast_tensors(x.to(dt), y.to(dt))
        return torch.isclose(x, y, rtol=rtol, atol=atol,
                             equal_nan=equal_nan).all().float()
    return apply(allclose, [a, _nd(b, a)])


class _GradientMultiplier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, scalar):
        ctx.scalar = scalar
        return d.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


def gradientmultiplier(data, scalar=1.0):
    """Identity forward, gradient times ``scalar`` (negative: the
    gradient-reversal layer)."""
    return apply(lambda d: _GradientMultiplier.apply(d, scalar), [data])


def fft(data, compute_size=128):
    """FFT along the last axis, the complex output interleaved (..., 2n)
    as real/imaginary pairs, float32.  ``compute_size`` has no effect."""
    def fft(d):
        c = torch.fft.fft(d.float(), dim=-1)
        return torch.stack([c.real, c.imag], -1).reshape(
            d.shape[:-1] + (2 * d.shape[-1],)).float()
    return apply(fft, [data])


def ifft(data, compute_size=128):
    """The inverse of :func:`fft`: (..., 2n) interleaved pairs -> the real
    part, unnormalized (times n), float32."""
    def ifft(d):
        n = d.shape[-1] // 2
        pairs = d.float().reshape(d.shape[:-1] + (n, 2))
        c = torch.complex(pairs[..., 0], pairs[..., 1])
        return torch.fft.ifft(c, dim=-1).real.float() * n
    return apply(ifft, [data])


def count_sketch(data, h, s, out_dim=None, processing_batch_size=32):
    """Count sketch: ``out[..., h[j]] += s[j] * data[..., j]``, ``h`` in
    [0, out_dim), ``s`` +-1.  ``processing_batch_size`` has no effect."""
    if out_dim is None:
        raise MXNetError("count_sketch requires out_dim")

    def count_sketch(d, hh, ss):
        flat = d.reshape(-1, d.shape[-1])
        out = flat.new_zeros((flat.shape[0], out_dim))
        out = out.index_add(1, hh.reshape(-1).long(),
                            flat * ss.reshape(-1).to(d.dtype)[None, :])
        return out.reshape(d.shape[:-1] + (out_dim,))
    return apply(count_sketch, [data, _nd(h, data), _nd(s, data)])


def quadratic(data, a=0.0, b=0.0, c=0.0):
    """``a*x^2 + b*x + c`` elementwise."""
    return apply(lambda d: a * d * d + b * d + c, [data])


def div_sqrt_dim(data):
    """``data / sqrt(last dim)``, the root taken in ``data``'s dtype."""
    def div_sqrt_dim(d):
        return d / torch.sqrt(torch.full((), d.shape[-1], dtype=d.dtype,
                                         device=d.device))
    return apply(div_sqrt_dim, [data])


def edge_id(data, u, v):
    """The edge ids (positions in the CSR values) of the pairs (u[i],
    v[i]) of a CSR adjacency matrix, -1 where absent: host numpy, as in
    the reference (a CPU-only op there too); refuses a capture."""
    from .sparse import CSRNDArray
    if not isinstance(data, CSRNDArray):
        raise MXNetError("edge_id expects a CSRNDArray adjacency")
    host_sync("edge_id")
    indptr = data._indptr.cpu().numpy()
    cols = data._indices_csr.cpu().numpy()
    uu = _np.asarray(u.asnumpy() if hasattr(u, "asnumpy") else u) \
        .astype(_np.int64)
    vv = _np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v) \
        .astype(_np.int64)
    out = _np.full(uu.shape, -1.0, _np.float32)
    for i, (ru, cv) in enumerate(zip(uu.ravel(), vv.ravel())):
        lo, hi = indptr[ru], indptr[ru + 1]
        hits = _np.nonzero(cols[lo:hi] == cv)[0]
        if hits.size:
            out.ravel()[i] = float(lo + hits[0])
    return array(out, ctx=data.context)


# ---------------------------------------------------------------------------
# RPN proposals
# ---------------------------------------------------------------------------

def _generate_anchors(stride, scales, ratios, device):
    """The base anchors of one feature cell (reference proposal.cc
    GenerateAnchors), (A, 4) float32 on ``device``: the box [0, 0,
    stride-1, stride-1] over the ratios, then the scales, centred."""
    one = torch.ones((), dtype=torch.float32, device=device)
    w = h = (stride - 1.0) * one + 1.0
    cx = 0.5 * (w - 1.0)
    cy = 0.5 * (h - 1.0)
    anchors = []
    for r in ratios:
        ws = torch.round(torch.sqrt(w * h / r))
        hs = torch.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append(torch.stack([cx - 0.5 * (wss - 1.0),
                                        cy - 0.5 * (hss - 1.0),
                                        cx + 0.5 * (wss - 1.0),
                                        cy + 0.5 * (hss - 1.0)]))
    return torch.stack(anchors)


def _proposals(fg, deltas, info, anchors, stride, pre_nms, post_nms, thresh,
               min_size):
    """Batched RPN proposals: anchors shifted over the grid, the deltas
    applied, clipped to the image, boxes under the scaled minimum size
    dropped, the top ``pre_nms`` by score (stable), the fixed-trip NMS in
    the op's +1-pixel areas, the first ``post_nms`` kept boxes
    zero-padded.  ``fg`` (B, A, H, W); returns boxes (B, post, 4) and
    scores (B, post)."""
    B, A, H, W = fg.shape
    dev = fg.device
    shift_x = torch.arange(W, device=dev) * stride
    shift_y = torch.arange(H, device=dev) * stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
    boxes = (anchors[None] + shifts).reshape(-1, 4)          # (HWA, 4)
    d = deltas.reshape(B, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(B, -1, 4)
    s = fg.permute(0, 2, 3, 1).reshape(B, -1)
    widths = boxes[:, 2] - boxes[:, 0] + 1.0
    heights = boxes[:, 3] - boxes[:, 1] + 1.0
    ctr_x = boxes[:, 0] + 0.5 * (widths - 1.0)
    ctr_y = boxes[:, 1] + 0.5 * (heights - 1.0)
    px = d[..., 0] * widths + ctr_x
    py = d[..., 1] * heights + ctr_y
    pw = torch.exp(d[..., 2].clamp(-10.0, 10.0)) * widths
    ph = torch.exp(d[..., 3].clamp(-10.0, 10.0)) * heights
    hlim = (info[:, 0] - 1.0)[:, None]
    wlim = (info[:, 1] - 1.0)[:, None]
    zero = torch.zeros((), dtype=px.dtype, device=dev)
    prop = torch.stack([
        torch.minimum(torch.maximum(px - 0.5 * (pw - 1.0), zero), wlim),
        torch.minimum(torch.maximum(py - 0.5 * (ph - 1.0), zero), hlim),
        torch.minimum(torch.maximum(px + 0.5 * (pw - 1.0), zero), wlim),
        torch.minimum(torch.maximum(py + 0.5 * (ph - 1.0), zero), hlim)],
        -1)
    ms = (min_size * info[:, 2])[:, None]
    keepable = ((prop[..., 2] - prop[..., 0] + 1.0 >= ms) &
                (prop[..., 3] - prop[..., 1] + 1.0 >= ms))
    s = torch.where(keepable, s, -_INF)
    k = min(pre_nms, prop.shape[1])
    top_s, top_i = torch.sort(s, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    top_b = torch.gather(prop, 1, top_i[..., None].expand(-1, -1, 4))
    l, r = top_b[:, :, None, :], top_b[:, None, :, :]
    tl = torch.maximum(l[..., :2], r[..., :2])
    br = torch.minimum(l[..., 2:], r[..., 2:])
    wh = torch.clamp_min(br - tl + 1.0, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (top_b[..., 2] - top_b[..., 0] + 1.0) * \
        (top_b[..., 3] - top_b[..., 1] + 1.0)
    iou = inter / torch.clamp_min(area[:, :, None] + area[:, None, :] -
                                  inter, 1e-12)
    later = torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
    finite = torch.isfinite(top_s)
    keep = _sweep(torch.ones(B, k, dtype=torch.bool, device=dev),
                  (iou > thresh) & later, finite) & finite
    rank = torch.cumsum(keep.long(), 1) - 1
    sel = torch.where(keep & (rank < post_nms), rank, post_nms)
    out_b = top_b.new_zeros(B, post_nms + 1, 4)
    out_b.scatter_(1, sel[..., None].expand(-1, -1, 4), top_b)
    out_s = top_s.new_zeros(B, post_nms + 1)
    out_s.scatter_(1, sel, top_s)
    return out_b[:, :post_nms], out_s[:, :post_nms]


def MultiProposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                  rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                  scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                  feature_stride=16, output_score=False, iou_loss=False):
    """Batched RPN proposals (reference multi_proposal.cc): ``cls_prob``
    (B, 2A, H, W), ``bbox_pred`` (B, 4A, H, W), ``im_info`` (B, 3) ->
    rois (B*post, 5) with the batch index first (and the scores (B*post,
    1) with ``output_score``).  ``iou_loss`` raises, as in the
    reference."""
    if iou_loss:
        raise MXNetError("MultiProposal: iou_loss=True is not supported; "
                         "use the default bbox-delta parameterization")
    A = len(scales) * len(ratios)
    post = int(rpn_post_nms_top_n)

    def MultiProposal(cp, bp, info):
        anchors = _generate_anchors(float(feature_stride),
                                    [float(s) for s in scales],
                                    [float(r) for r in ratios], cp.device)
        boxes, scores = _proposals(cp[:, A:], bp, info, anchors,
                                   float(feature_stride),
                                   int(rpn_pre_nms_top_n), post,
                                   float(threshold), float(rpn_min_size))
        B = cp.shape[0]
        bidx = torch.arange(B, device=cp.device).to(boxes.dtype) \
            .repeat_interleave(post)
        rois = torch.cat([bidx[:, None], boxes.reshape(-1, 4)], -1)
        if output_score:
            return rois, scores.reshape(-1, 1)
        return rois
    return apply(MultiProposal, [cls_prob, bbox_pred, im_info],
                 n_out=2 if output_score else 1)


def Proposal(cls_prob, bbox_pred, im_info, **kwargs):
    """Single-image RPN proposals (reference proposal.cc): batch 1, else
    use :func:`MultiProposal`."""
    if cls_prob.shape[0] != 1:
        raise MXNetError("Proposal expects batch size 1; "
                         "use MultiProposal for batched inputs")
    return MultiProposal(cls_prob, bbox_pred, im_info, **kwargs)


def fused_linear_cross_entropy(data, weight, targets, block=2048,
                               ignore_index=None):
    """Per-token cross-entropy of ``softmax(data @ weight)`` against
    ``targets`` (``data`` (N, d), ``weight`` (d, V)), the vocabulary in
    blocks so the (N, V) logits never exist (``ops.blocked_cross_entropy``).
    Float targets are truncated to integers, as the reference casts them."""
    if not isinstance(targets, NDArray):
        targets = NDArray(torch.as_tensor(targets, device=data.data.device))

    def fused_linear_cross_entropy(x, w, t):
        return _f(x, w, t, block=block, ignore_index=ignore_index)

    return apply(fused_linear_cross_entropy, [data, weight, targets])
