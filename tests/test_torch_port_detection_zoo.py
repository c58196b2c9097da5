"""The port's YOLOv3 and Faster R-CNN against the JAX package's, on the
CPU.

- ``yolo3_darknet53(classes=20)`` at full width on 64 x 64 (the
  reference's own test case), batch 2: the training-mode outputs (three
  lists over the scales, through the port's CachedOp) and the inference
  detections after ``box_nms``; ``YOLOOutputV3``'s decode and
  ``_Upsample`` alone, with their gradients.
- ``RPN`` alone (16 channels, stride 16, 270 anchors a 5 x 6 map,
  ``pre_nms`` 50 below them and ``post_nms`` 100 above the survivors,
  so the second ordering meets the suppressed candidates' -1 ties): its
  proposals equal the reference's in order, with random score weights,
  with the score weights scaled until every sigmoid saturates to exactly
  0 or 1, and with every score exactly 0.5 (ties built in: both
  orderings keep the index order, as ``jax.lax.top_k``'s).
- ``FasterRCNN`` over a one-block-a-stage ``ResNetV1b`` of basic blocks
  (stride 32, its ``layer4`` removed; 256 channels at C4, so the box
  head's first layer reads 12,544 values a roi, not ResNet-50's
  50,176) at 64 x 64, batch 2: the training-mode outputs and
  their gradients through ``ROIAlign`` and the box head, and the
  inference detections; its weights carried by structural name, none
  left over on either side, and ``faster_rcnn_resnet50_v1b`` /
  ``yolo3_darknet53`` compared by names and declared shapes.
- ``chip_smoke._dets_agree``, phases 44 and 45's end-to-end check of
  the card's detections against the CPU's, on built rows: matched both
  ways, a dropped row refused, a swap of overlapping rows and a row at
  the score gate taken as ties.

The weights are ``Xavier(magnitude=2)``'s draws made with numpy
(``test_torch_port_vision_zoo._pair``), written into the reference's
parameters and carried from there by ``convert.load_block_weights``;
no draw touches the reference's global key.  Tolerances, with their
reasons:

- raw maps, decoded boxes and scores, RPN scores, offsets and anchors,
  R-CNN class and box predictions: 1e-4
  absolute and relative (sums in another order; XLA on the CPU
  contracts ``a * b + c`` into one rounding where PyTorch takes two, and
  its ``exp`` and sigmoid differ from ATen's by an ulp); YOLOv3's
  training-mode outputs and Faster R-CNN's training-mode proposals also
  within SPREAD_X (2) times the largest change that one ulp more in half
  of the input's elements makes in the port's own (YOLOv3's last stage
  normalizes 8 values a channel at 64 x 64, so its maps move by some
  1e-4 from that input; the proposals' pixel coordinates scale the
  offsets by anchors of 128-512 pixels);
- the RPN's proposals: scores within 1e-6, boxes within 1e-4 (pixel
  coordinates up to 96, the same roundings), the suppressed rows (-1)
  and the order exactly;
- detections: ids and the kept state exactly, scores and boxes within
  1e-4, as ``test_torch_port_vision_zoo.py``'s SSD;
- Faster R-CNN's gradients: each within GRAD_RTOL (5e-3) of its norm
  plus GRAD_ATOL (5e-5), ``test_torch_port_vision_zoo.py``'s limits.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch.gluon.model_zoo import vision
from test_torch_port_resnet import _chip_smoke
from test_torch_port_vision_zoo import (FWD_TOL, GRAD_ATOL, GRAD_RTOL,
                                        _declared, _pair)
from test_torch_port_segmentation_zoo import SPREAD_X, _ulp_up

RPN_SCORE_TOL, RPN_BOX_TOL = 1e-6, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(out):
    if isinstance(out, (list, tuple)):
        return type(out)(_np(o) for o in out)
    return out.asnumpy()


def _run(v, net, x, train):
    """``net`` on ``x`` in training or predict mode, not recording (the
    reference compiles no backward)."""
    pkg, rec = (jmx, jag) if v is jvision else (mx, ag)
    with (mx.cpu() if pkg is mx else jmx.cpu()):
        xa = pkg.nd.array(x)
        with (rec.train_mode() if train else rec.predict_mode()):
            return _np(net(xa))


def _grads(net):
    return {k: p.grad().asnumpy() for k, p in
            net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _close(got, want, tol=FWD_TOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _detections_agree(got, want):
    """(ids, scores, boxes) after ``box_nms``: the kept rows' ids, and
    which rows are kept, exactly; their scores and boxes within
    FWD_TOL."""
    (pids, psc, pbb), (jids, jsc, jbb) = got, want
    assert pids.shape == jids.shape and pbb.shape[-1] == 4
    kept = jsc[..., 0] > 0
    assert kept.any()
    np.testing.assert_array_equal(psc <= 0, jsc <= 0)
    np.testing.assert_array_equal(pids[kept], jids[kept])
    _close(psc[kept], jsc[kept])
    _close(pbb[kept], jbb[kept])


# ----------------------------------------------------------------------
# YOLOv3
# ----------------------------------------------------------------------

def test_factories_build_like_the_reference():
    for name in ("darknet53", "yolo3_darknet53", "faster_rcnn_resnet50_v1b"):
        assert _declared(vision.get_model(name)) == \
            _declared(jvision.get_model(name)), name
    net = vision.faster_rcnn_resnet50_v1b()
    assert not any(k.startswith(("base.layer4", "base.fc")) for k in
                   _declared(net))
    assert "layer4" not in net.base._children and \
        not hasattr(net.base, "fc")
    assert net.num_classes == 20 and len(net.rpn.anchor_gen._shapes) == 9


@pytest.fixture(scope="module")
def yolo_outputs():
    """Both packages' YOLOv3 in training and predict mode (the
    reference's two compiles run here)."""
    x = np.random.RandomState(1).rand(2, 3, 64, 64).astype(np.float32)
    jnet, pnet = _pair(lambda v: v.yolo3_darknet53(classes=20, prefix="y_"),
                       x)
    out = {"j_train": _run(jvision, jnet, x, True),
           "p_train": _run(vision, pnet, x, True),
           "j_det": _run(jvision, jnet, x, False),
           "p_det": _run(vision, pnet, x, False),
           "p_stats": dict(pnet._cached_op.stats)}
    out["p_ulp"] = _run(vision, pnet, _ulp_up(x), True)
    return out


def test_yolo3_training_outputs_match_jax(yolo_outputs):
    got, want = yolo_outputs["p_train"], yolo_outputs["j_train"]
    # three lists (raw maps, boxes, scores) over the three scales, the
    # nesting through the CachedOp
    assert isinstance(got, tuple) and len(got) == 3
    assert all(isinstance(g, list) and len(g) == 3 for g in got)
    assert [a.shape for a in got[0]] == [(2, 75, s, s) for s in (2, 4, 8)]
    for g_list, w_list, u_list in zip(got, want, yolo_outputs["p_ulp"]):
        for g, w, u in zip(g_list, w_list, u_list):
            lim = FWD_TOL + FWD_TOL * np.abs(w) + \
                SPREAD_X * np.abs(u - g).max()
            assert np.all(np.abs(g - w) <= lim)
    assert yolo_outputs["p_stats"]["eager_calls"] >= 2


def test_yolo3_detections_match_jax(yolo_outputs):
    got, want = yolo_outputs["p_det"], yolo_outputs["j_det"]
    assert got[0].shape == (2, 252, 1)
    _detections_agree(got, want)


def _yolo_head_loss(v, net, x, c_box, c_score):
    pkg, rec = (jmx, jag) if v is jvision else (mx, ag)
    with (mx.cpu() if pkg is mx else jmx.cpu()):
        xa = pkg.nd.array(x)
        with rec.record():
            pred, boxes, scores = net(xa)
            loss = (boxes * pkg.nd.array(c_box)).sum() + \
                (scores * pkg.nd.array(c_score)).sum()
        loss.backward()
    return _np((pred, boxes, scores)), _grads(net)


def test_yolo_output_decode_alone_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.rand(2, 16, 5, 7).astype(np.float32)
    c_box = rng.randn(2, 105, 4).astype(np.float32)
    c_score = rng.randn(2, 105, 3).astype(np.float32)
    jnet, pnet = _pair(lambda v: v.yolo.YOLOOutputV3(
        3, [10, 13, 16, 30, 33, 23], 8, prefix="o_"), x)
    (jp, jb, js), jg = _yolo_head_loss(jvision, jnet, x, c_box, c_score)
    (pp, pb, ps), pg = _yolo_head_loss(vision, pnet, x, c_box, c_score)
    assert pp.shape == (2, 24, 5, 7) and pb.shape == (2, 105, 4)
    for g, w in ((pp, jp), (pb, jb), (ps, js)):
        _close(g, w)
    assert sorted(pg) == sorted(jg)
    for k in jg:
        _close(pg[k], jg[k])


def test_upsample_alone_matches_jax():
    x = np.random.RandomState(3).rand(2, 3, 4, 5).astype(np.float32)
    cot = np.random.RandomState(4).rand(2, 3, 8, 10).astype(np.float32)
    outs = []
    for v, pkg, rec in ((jvision, jmx, jag), (vision, mx, ag)):
        with (mx.cpu() if pkg is mx else jmx.cpu()):
            xa = pkg.nd.array(x)
            xa.attach_grad()
            with rec.record():
                y = v.yolo._Upsample(2)(xa)
                (y * pkg.nd.array(cot)).sum().backward()
            outs.append((y.asnumpy(), xa.grad.asnumpy()))
    (jy, jg), (py, pg) = outs
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_array_equal(py, x.repeat(2, 2).repeat(2, 3))
    np.testing.assert_allclose(pg, jg, rtol=1e-6)


# ----------------------------------------------------------------------
# the RPN alone
# ----------------------------------------------------------------------

RPN_IM = (80, 96)


def _rpn_case(case):
    """Both packages' RPN on one feature map, the score weights as
    ``case`` sets them (the same in both)."""
    rng = np.random.RandomState(5)
    feat = rng.rand(2, 8, 5, 6).astype(np.float32)
    jnet, pnet = _pair(lambda v: v.rcnn.RPN(
        channels=16, stride=16, pre_nms=50, post_nms=100, prefix="r_"),
        feat, hybridize=False, call=lambda n, a: n(a, RPN_IM))
    jnet.hybridize(False)
    w = jnet.score.weight.data().asnumpy()
    b = jnet.score.bias.data().asnumpy()
    if case == "saturated":
        w, b = w * 1e4, b
    elif case == "flat":
        w, b = np.zeros_like(w), np.zeros_like(b)
    for net, pkg in ((jnet, jmx), (pnet, mx)):
        with (mx.cpu() if pkg is mx else jmx.cpu()):
            net.score.weight.set_data(pkg.nd.array(w))
            net.score.bias.set_data(pkg.nd.array(b))
    outs = []
    for net, pkg in ((jnet, jmx), (pnet, mx)):
        with (mx.cpu() if pkg is mx else jmx.cpu()):
            outs.append(_np(net(pkg.nd.array(feat), RPN_IM)))
    return outs


@pytest.fixture(scope="module", params=["random", "saturated", "flat"])
def rpn_case(request):
    """Both packages' RPN on one case (the reference's compiles run
    here, shared by the three cases)."""
    return request.param, _rpn_case(request.param)


def test_rpn_proposals_equal_the_reference_in_order(rpn_case):
    case, (want, got) = rpn_case
    for g, w in zip(got[:3], want[:3]):        # score, loc, anchors
        _close(g, w)
    rois, scores = got[3], got[4]
    assert rois.shape == (2, 50, 4) and scores.shape == (2, 50)
    # suppressed candidates score -1 and fill the tail: more than the
    # survivors are returned, so the second ordering meets their ties
    suppressed = scores == -1.0
    assert suppressed.any(axis=1).all()
    np.testing.assert_array_equal(suppressed, want[4] == -1.0)
    np.testing.assert_allclose(scores, want[4], rtol=0, atol=RPN_SCORE_TOL)
    np.testing.assert_allclose(rois, want[3], rtol=0, atol=RPN_BOX_TOL)
    assert (rois >= 0).all() and (rois[..., 0::2] <= RPN_IM[1]).all()
    live = scores[~suppressed]
    if case == "saturated":
        assert set(np.unique(live)) <= {0.0, 1.0} and (live == 1.0).sum() > 1
    if case == "flat":
        assert (live == 0.5).all()


# ----------------------------------------------------------------------
# Faster R-CNN over a one-block-a-stage backbone
# ----------------------------------------------------------------------

def _rcnn(v):
    base = v.segmentation.ResNetV1b([1, 1, 1, 1], dilated=False,
                                    block=v.segmentation.BasicBlockV1b)
    return v.rcnn.FasterRCNN(("a", "b", "c"), backbone=base, prefix="f_")


def _rcnn_train(v, net, x, cots):
    """Training mode: the six outputs, then the gradients of a fixed
    linear function of the class and box predictions and the RPN's
    score and offsets."""
    pkg, rec = (jmx, jag) if v is jvision else (mx, ag)
    with (mx.cpu() if pkg is mx else jmx.cpu()):
        xa = pkg.nd.array(x)
        with rec.record():
            out = net(xa)
            loss = sum((o * pkg.nd.array(c)).sum()
                       for o, c in zip((out[0], out[1], out[3], out[4]),
                                       cots))
        loss.backward()
    return _np(out), _grads(net)


@pytest.fixture(scope="module")
def rcnn_outputs():
    """Both packages' Faster R-CNN in training mode with a backward, and
    in predict mode (the reference's compiles run here)."""
    rng = np.random.RandomState(6)
    x = rng.rand(2, 3, 64, 64).astype(np.float32)
    jnet, pnet = _pair(_rcnn, x)
    shapes = [(288, 4), (288, 12), (2, 9, 4, 4), (2, 36, 4, 4)]
    cots = [rng.randn(*s).astype(np.float32) for s in shapes]
    out = {"j_train": _rcnn_train(jvision, jnet, x, cots),
           "p_train": _rcnn_train(vision, pnet, x, cots),
           "j_det": _run(jvision, jnet, x, False),
           "p_det": _run(vision, pnet, x, False),
           "names": (sorted(_declared(jnet)), sorted(_declared(pnet)))}
    out["p_ulp"] = _run(vision, pnet, _ulp_up(x), True)
    return out


def test_faster_rcnn_training_outputs_and_gradients_match_jax(rcnn_outputs):
    (got, pg), (want, jg) = rcnn_outputs["p_train"], \
        rcnn_outputs["j_train"]
    assert [o.shape for o in got] == [o.shape for o in want] == [
        (288, 4), (288, 12), (2, 144, 4), (2, 9, 4, 4), (2, 36, 4, 4),
        (1, 144, 4)]
    for i in (0, 1, 3, 4, 5):
        _close(got[i], want[i])
    # the proposals, in order: pixel coordinates from training-mode
    # features, held like YOLOv3's maps
    moved = np.abs(rcnn_outputs["p_ulp"][2] - got[2]).max()
    assert np.all(np.abs(got[2] - want[2]) <=
                  FWD_TOL + FWD_TOL * np.abs(want[2]) + SPREAD_X * moved)
    assert sorted(pg) == sorted(jg)
    for k in jg:
        err = np.linalg.norm(pg[k] - jg[k])
        norm = np.linalg.norm(jg[k])
        assert err <= GRAD_RTOL * norm + GRAD_ATOL, (k, err, norm)
    # no gradient reaches the proposals' coordinates: the RPN's offsets
    # take only their own head's
    assert np.linalg.norm(pg["rpn.loc.weight"]) > 0


def test_faster_rcnn_detections_match_jax(rcnn_outputs):
    got, want = rcnn_outputs["p_det"], rcnn_outputs["j_det"]
    assert got[0].shape == (2, 144, 1)
    _detections_agree(got, want)


def test_faster_rcnn_weights_carry_with_nothing_left_over(rcnn_outputs):
    jnames, pnames = rcnn_outputs["names"]
    assert jnames == pnames
    assert not any(n.startswith(("base.layer4", "base.fc", "base.avgpool"))
                   for n in pnames)
    assert "base.layer3.0.conv2.weight" in pnames


# ----------------------------------------------------------------------
# chip_smoke's end-to-end detection check (phases 44 and 45)
# ----------------------------------------------------------------------

def _boxes_far_apart(rng, n):
    """``n`` rows [id, score, x0, y0, x1, y1] of one image, scores
    descending from 0.9, boxes 20 pixels wide on a 40-pixel grid."""
    rows = np.zeros((n, 6), np.float32)
    rows[:, 0] = rng.randint(0, 3, n)
    rows[:, 1] = np.linspace(0.9, 0.3, n)
    rows[:, 2] = np.arange(n) * 40.0
    rows[:, 3] = rng.rand(n) * 100
    rows[:, 4:] = rows[:, 2:4] + 20
    return rows


def test_smoke_dets_agree_matches_both_ways_and_explains_only_ties():
    """``chip_smoke._dets_agree``: detections a small score and box
    difference apart all match; a kept row the card drops from the middle
    is unexplained; two overlapping rows of one class that swapped which
    one was kept, and a row at the score gate, are ties."""
    agree = _chip_smoke()._dets_agree
    rng = np.random.RandomState(9)
    want = np.stack([_boxes_far_apart(rng, 10) for _ in range(2)])
    got = want.copy()
    got[..., 1] += 1e-6
    got[..., 2:] += 1e-3
    matched, extra, ties, odd, box_err = agree(want, got, 0.4, 0.45, 0.01)
    assert (matched, extra, ties, odd) == ("20 / 20", 0, 0, [])
    assert 0 < box_err <= 2e-3
    dropped = got.copy()
    dropped[0, 4, 1] = -1.0
    matched, extra, ties, odd, _ = agree(want, dropped, 0.4, 0.45, 0.01)
    assert matched == "19 / 20" and extra == 0 and len(odd) == 1
    # rows 2 and 3 of image 1 overlap (IoU 0.8): the CPU kept 2, the
    # card 3
    w2, g2 = want.copy(), got.copy()
    for a in (w2, g2):
        a[1, 3, 0] = a[1, 2, 0]
        a[1, 3, 2:] = a[1, 2, 2:] + np.float32([0, 2.2, 0, 2.2])
    w2[1, 3, 1] = -1.0
    g2[1, 2, 1] = -1.0
    matched, extra, ties, odd, _ = agree(w2, g2, 0.4, 0.45, 0.01)
    assert (matched, extra, ties, odd) == ("18 / 19", 1, 2, [])
    # the CPU's last row sits at the score gate, and the card's gate
    # dropped it
    w3, g3 = want.copy(), got.copy()
    w3[0, 9, 1] = 0.01 + 1e-6
    g3[0, 9, 1] = -1.0
    matched, extra, ties, odd, _ = agree(w3, g3, 0.4, 0.45, 0.01)
    assert (matched, ties, odd) == ("19 / 20", 1, [])
