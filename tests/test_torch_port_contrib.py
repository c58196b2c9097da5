"""``mx.nd.contrib`` (``ndarray/contrib.py``): the port against
``mxnet_tpu.nd.contrib``, on the CPU.

Each case is one op with its arguments: the same numpy inputs (fixed
``RandomState`` seeds) go through both packages.  The test compares every
output and its dtype and, where the reference differentiates the op
(``ROIAlign``, ``DeformableConvolution``, ``BilinearResize2D``,
``AdaptiveAvgPooling2D``, ``index_copy``, ``gradientmultiplier``,
``count_sketch``, ``quadratic`` and the other smooth ops), the gradients
of the listed inputs under ``autograd.record()`` for a random head on
each floating output.  Tolerances:

- ``EXACT`` for integer, ordering, matching, masking, indexing and copy
  ops, and for the suppression and matching decisions (the score columns
  and indices of ``box_nms``, ``bipartite_matching`` with ties, the
  class targets of ``MultiBoxTarget``);
- ``F32``, 1e-5 relative (1e-6 absolute), for f32 arithmetic taken in
  another order (bilinear blends, box transforms, the products of the
  deformable convolution, the anchor and proposal math);
- ``TRANS``, 1e-6 relative and absolute, for transcendental ops (XLA's
  and torch's approximations an ulp or two apart; ``FFT``, 1e-5
  relative and absolute, for the transforms' sums).

The cases draw nothing.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError

EXACT, F32, TRANS, FFT = "exact", 1e-5, 1e-6, "fft"

RNG = np.random.RandomState(22)


def _boxes(rng, *lead):
    xy = rng.rand(*lead, 2) * 0.6
    wh = rng.rand(*lead, 2) * 0.4 + 0.05
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _nms_data(rng, b, n, ties=False):
    """(b, n, 6) rows [id, score, x0, y0, x1, y1]."""
    ids = rng.randint(0, 3, (b, n, 1)).astype(np.float32)
    scores = rng.rand(b, n, 1).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4
    out = np.concatenate([ids, scores, _boxes(rng, b, n)], -1)
    # overlapping pairs so suppression fires
    out[:, 1::2, 2:] = out[:, ::2, 2:][:, :out[:, 1::2].shape[1]] + 0.01
    return out.astype(np.float32)


BOX_A = _boxes(RNG, 5)
BOX_B = _boxes(RNG, 6)
CENTER_A = np.concatenate([BOX_A[:, :2] + 0.1, BOX_A[:, 2:] - BOX_A[:, :2]],
                          -1).astype(np.float32)
NMS = _nms_data(RNG, 2, 10)
NMS_TIES = _nms_data(RNG, 2, 10, ties=True)
NMS_3D = _nms_data(RNG, 6, 7).reshape(2, 3, 7, 6)
SAMPLES = np.array([[1, 0, -1, 1, 1], [0, 1, 1, -1, 0]], np.float32)
MATCHES = np.array([[0, 2, 1, 1, 0], [2, 0, 1, 2, 1]], np.float32)
ANCH = _boxes(RNG, 2, 5)
REFS = _boxes(RNG, 2, 3)
DELTAS = (RNG.randn(2, 5, 4) * 0.5).astype(np.float32)
CENTER_ANCH = np.concatenate([ANCH[..., :2] + 0.1, ANCH[..., 2:] -
                              ANCH[..., :2]], -1).astype(np.float32)
MATCH = RNG.rand(2, 4, 5).astype(np.float32)
MATCH_TIES = RNG.randint(0, 3, (2, 5, 4)).astype(np.float32) / 2
FEAT = RNG.randn(2, 3, 8, 9).astype(np.float32)
ROIS = np.array([[0, 0.5, 1.0, 6.5, 5.0], [1, 2.0, 0.0, 8.0, 7.5],
                 [0, 3.2, 2.1, 4.0, 3.0], [1, 0.0, 0.0, 12.0, 15.0]],
                np.float32)
MAP = RNG.randn(1, 3, 4, 5).astype(np.float32)
IMG = RNG.randn(2, 2, 5, 6).astype(np.float32)
POOL = RNG.randn(2, 3, 7, 5).astype(np.float32)
DCN_X = RNG.randn(2, 4, 6, 7).astype(np.float32)
DCN_W = (RNG.randn(5, 4, 3, 3) * 0.2).astype(np.float32)
DCN_B = RNG.randn(5).astype(np.float32)
DCN_OFF = (RNG.randn(2, 2 * 2 * 9, 6, 7) * 0.8).astype(np.float32)
DCN_OFF_S2 = (RNG.randn(2, 2 * 9, 2, 3) * 0.8).astype(np.float32)
A = RNG.randn(3, 4).astype(np.float32)
SPARSEISH = np.where(RNG.rand(3, 4) > 0.5, A, 0).astype(np.float32)
SIG = RNG.randn(3, 8).astype(np.float32)
SIG2 = RNG.randn(3, 16).astype(np.float32)
CS_H = np.array([0, 3, 1, 3, 2, 0], np.float32)
CS_S = np.array([1, -1, -1, 1, 1, -1], np.float32)
CS_X = RNG.randn(3, 6).astype(np.float32)


def _f(name, **kw):
    return lambda F, *a: getattr(F.contrib, name)(*a, **kw)


# id -> (call(F, *arrays), numpy inputs, indices of the inputs whose
# gradient is held, tolerance)
CASES = {}


def case(cid, call, inputs, grads=(), tol=EXACT):
    assert cid not in CASES, cid
    CASES[cid] = (call, inputs, grads, tol)


# ---- boxes ----
case("box_iou", _f("box_iou"), [BOX_A, BOX_B], (0, 1), F32)
case("box_iou-center", _f("box_iou", format="center"), [CENTER_A, BOX_B],
     (0, 1), F32)
case("box_nms", _f("box_nms", overlap_thresh=0.3), [NMS], (0,))
case("box_nms-ties", _f("box_nms", overlap_thresh=0.3), [NMS_TIES], (0,))
case("box_nms-ids-topk", _f("box_nms", overlap_thresh=0.2, topk=4,
                            id_index=0, valid_thresh=0.2), [NMS_TIES], (0,))
case("box_nms-force-background", _f("box_nms", overlap_thresh=0.2,
                                    id_index=0, force_suppress=True,
                                    background_id=1), [NMS], (0,))
case("box_nms-center-out", _f("box_nms", out_format="center"), [NMS],
     (0,), F32)
case("box_nms-center-in", _f("box_nms", in_format="center",
                             out_format="center"), [NMS], (0,))
case("box_nms-3d", _f("box_nms", overlap_thresh=0.3), [NMS_3D], (0,))
case("box_encode", _f("box_encode"), [SAMPLES, MATCHES, ANCH, REFS], (2, 3),
     F32)
case("box_encode-means", _f("box_encode", means=(0.1, -0.1, 0.0, 0.2),
                            stds=(0.2, 0.2, 0.3, 0.3)),
     [SAMPLES, MATCHES, ANCH, REFS], (2, 3), F32)
case("box_decode", _f("box_decode"), [DELTAS, CENTER_ANCH], (0, 1), F32)
case("box_decode-corner-clip", _f("box_decode", format="corner", clip=0.3),
     [DELTAS, ANCH], (0, 1), F32)
case("bipartite_matching", _f("bipartite_matching", threshold=0.2),
     [MATCH])
case("bipartite_matching-ties", _f("bipartite_matching", threshold=0.1),
     [MATCH_TIES])
case("bipartite_matching-ascend-topk", _f("bipartite_matching",
                                          is_ascend=True, topk=2),
     [MATCH_TIES])

# ---- regions of interest ----
case("ROIAlign", _f("ROIAlign", pooled_size=(3, 2), spatial_scale=0.5,
                    sample_ratio=2), [FEAT, ROIS], (0,), F32)
case("ROIAlign-default-ratio-aligned", _f("ROIAlign", pooled_size=2,
                                          aligned=True), [FEAT, ROIS], (0,),
     F32)
case("ROIPooling", _f("ROIPooling", pooled_size=(3, 2), spatial_scale=0.5),
     [FEAT, ROIS], (0,))
case("ROIPooling-full", _f("ROIPooling", pooled_size=(2, 2)), [FEAT, ROIS],
     (0,))

# ---- SSD ----
case("MultiBoxPrior", _f("MultiBoxPrior", sizes=(0.2, 0.35),
                         ratios=(1, 2, 0.5)), [MAP], (), F32)
case("MultiBoxPrior-clip-steps", _f("MultiBoxPrior", sizes=(0.5,),
                                    ratios=(1, 3), clip=True,
                                    steps=(0.3, 0.2), offsets=(0.4, 0.6)),
     [MAP], (), F32)


def _ssd_inputs(seed):
    rng = np.random.RandomState(seed)
    anchor = _boxes(rng, 1, 12)
    label = np.full((2, 3, 5), -1.0, np.float32)
    label[0, :2, 0] = [0, 2]
    label[0, :2, 1:] = anchor[0, [3, 7]] + 0.01
    label[1, :3, 0] = [1, 1, 0]
    label[1, :3, 1:] = _boxes(rng, 3)
    pred = rng.randn(2, 4, 12).astype(np.float32)
    return anchor, label, pred


ANCHOR, LABEL, PRED = _ssd_inputs(0)


def _target_call(F, a, l, p, **kw):
    bt, bm, ct = F.contrib.MultiBoxTarget(a, l, p, **kw)
    return [bt, bm, ct]


case("MultiBoxTarget", lambda F, *a: _target_call(F, *a, negative_mining_ratio=1.0,
                                                  minimum_negative_samples=1),
     [ANCHOR, LABEL, PRED], (), F32)
case("MultiBoxTarget-no-mining", lambda F, *a: _target_call(
    F, *a, negative_mining_ratio=-1, overlap_threshold=0.3,
    variances=(0.2, 0.2, 0.1, 0.1)), [ANCHOR, LABEL, PRED], (), F32)
CLS_PROB = np.exp(PRED) / np.exp(PRED).sum(1, keepdims=True)
LOC = (RNG.randn(2, 48) * 0.3).astype(np.float32)
case("MultiBoxDetection", _f("MultiBoxDetection", threshold=0.2,
                             nms_threshold=0.3),
     [CLS_PROB.astype(np.float32), LOC, ANCHOR], (), F32)
case("MultiBoxDetection-topk-noclip", _f("MultiBoxDetection", clip=False,
                                         nms_topk=5, background_id=1,
                                         force_suppress=True),
     [CLS_PROB.astype(np.float32), LOC, ANCHOR], (), F32)

# ---- RPN ----


def _rpn_inputs(seed, b, a=6, h=5, w=6):
    rng = np.random.RandomState(seed)
    cls = rng.rand(b, 2 * a, h, w).astype(np.float32)
    bbox = (rng.randn(b, 4 * a, h, w) * 0.2).astype(np.float32)
    info = np.tile(np.array([[h * 4.0, w * 4.0, 1.0]], np.float32), (b, 1))
    info[-1, :2] -= 3.0
    return cls, bbox, info


_RPN = dict(rpn_pre_nms_top_n=40, rpn_post_nms_top_n=12, threshold=0.5,
            rpn_min_size=3, scales=(2, 4), ratios=(0.5, 1, 2),
            feature_stride=4)
case("MultiProposal", _f("MultiProposal", output_score=True, **_RPN),
     list(_rpn_inputs(1, 2)), (), F32)
case("Proposal", _f("Proposal", **_RPN), list(_rpn_inputs(2, 1)), (), F32)

# ---- the rest ----
case("getnnz", _f("getnnz"), [SPARSEISH])
case("getnnz-axis", _f("getnnz", axis=0), [SPARSEISH])
case("quantize-uint8", lambda F, x, lo, hi: F.contrib.quantize(x, lo, hi),
     [A, np.array([-1.0], np.float32), np.array([1.5], np.float32)])
case("quantize-int8", lambda F, x, lo, hi: F.contrib.quantize(
    x, lo, hi, out_type="int8"),
     [A, np.array([-2.0], np.float32), np.array([2.0], np.float32)])
case("arange_like", _f("arange_like", start=1.5, step=0.5, axis=1), [A])
case("arange_like-repeat", _f("arange_like", repeat=2), [A])
case("fused_gelu", _f("fused_gelu"), [A], (0,), TRANS)
case("BilinearResize2D", _f("BilinearResize2D", height=8, width=3), [IMG],
     (0,), F32)
case("BilinearResize2D-scale-one", _f("BilinearResize2D", scale_height=0.2,
                                      scale_width=2.0), [IMG], (0,), F32)
case("BilinearResize2D-like", lambda F, x, y: F.contrib.BilinearResize2D(
    x, like=y), [IMG, POOL], (0,), F32)
case("BilinearResize2D-half-pixel-up", _f("BilinearResize2D", height=9,
                                          width=11, align_corners=False),
     [IMG], (0,), F32)
case("BilinearResize2D-half-pixel-down", _f("BilinearResize2D", height=3,
                                            width=4, align_corners=False),
     [IMG], (0,), F32)
case("AdaptiveAvgPooling2D", _f("AdaptiveAvgPooling2D", output_size=3),
     [POOL], (0,), F32)
case("AdaptiveAvgPooling2D-rect", _f("AdaptiveAvgPooling2D",
                                     output_size=(2, 4)), [POOL], (0,), F32)
case("DeformableConvolution", _f("DeformableConvolution", kernel=(3, 3),
                                 pad=(1, 1), num_filter=5,
                                 num_deformable_group=2),
     [DCN_X, DCN_OFF, DCN_W, DCN_B], (0, 1, 2, 3), F32)
case("DeformableConvolution-stride-dilate-nobias",
     lambda F, x, o, w: F.contrib.DeformableConvolution(
         x, o, w, kernel=(3, 3), stride=(2, 2), pad=(1, 1), dilate=(2, 2),
         num_filter=5, no_bias=True),
     [DCN_X, DCN_OFF_S2, DCN_W], (0, 1, 2), F32)
case("boolean_mask", lambda F, x, m: F.contrib.boolean_mask(x, m),
     [A, np.array([1, 0, 1], np.float32)], (0,))
case("boolean_mask-axis1", lambda F, x, m: F.contrib.boolean_mask(
    x, m, axis=1), [A, np.array([0, 1, 1, 0], np.float32)], (0,))
case("index_copy", _f("index_copy"),
     [A, np.array([2, 0], np.float32), SIG[:2, :4].copy()], (0, 2))
case("index_array", _f("index_array"), [SIG[:2]])
case("index_array-axes", _f("index_array", axes=(1,)), [NMS_3D[..., 0]])
case("allclose-true", _f("allclose"), [A, A + 1e-7])
case("allclose-false", _f("allclose", rtol=1e-3, atol=1e-4), [A, A * 1.01])
case("gradientmultiplier", _f("gradientmultiplier", scalar=-0.5), [A], (0,))
case("fft", _f("fft"), [SIG], (0,), FFT)
case("ifft", _f("ifft"), [SIG2], (0,), FFT)
case("count_sketch", lambda F, x, h, s: F.contrib.count_sketch(
    x, h, s, out_dim=4), [CS_X, CS_H, CS_S], (0,), F32)
case("quadratic", _f("quadratic", a=0.5, b=-1.0, c=2.0), [A], (0,), F32)
case("div_sqrt_dim", _f("div_sqrt_dim"), [SIG], (0,))


def _flat(out):
    if out is None:
        return []
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out] if hasattr(out, "asnumpy") else []


def _dt(a):
    return str(a.dtype)


def _run(pkg, call, inputs, grads):
    """``call``'s outputs and the gradients of ``grads`` for the loss
    ``sum(head * out)`` over the floating outputs."""
    arrs = [pkg.nd.array(x, dtype=x.dtype) for x in inputs]
    for i in grads:
        arrs[i].attach_grad()
    if grads:
        with pkg.autograd.record():
            outs = _flat(call(pkg.nd, *arrs))
            floats = [o for o in outs if _dt(o) == "float32"]
            rng = np.random.RandomState(7)
            loss = None
            for o in floats:
                h = rng.randn(*o.shape).astype(np.float32)
                term = (o * pkg.nd.array(h)).sum()
                loss = term if loss is None else loss + term
        loss.backward()
        return outs, [arrs[i].grad for i in grads]
    return _flat(call(pkg.nd, *arrs)), []


def _close(got, want, tol, what):
    got, want = got.asnumpy(), want.asnumpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tol == EXACT:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        rtol, atol = (1e-5, 1e-5) if tol == FFT else (tol, 1e-6)
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=rtol,
                                   atol=atol, err_msg=what)


@pytest.mark.parametrize("cid", sorted(CASES))
def test_contrib_op_matches_reference(cid):
    call, inputs, grads, tol = CASES[cid]
    jout, jgrads = _run(jmx, call, inputs, grads)
    with mx.cpu():
        pout, pgrads = _run(mx, call, inputs, grads)
    assert len(pout) == len(jout)
    for k, (p, j) in enumerate(zip(pout, jout)):
        assert _dt(p) == _dt(j), (k, _dt(p), _dt(j))
        _close(p, j, tol, f"output {k}")
    for i, p, j in zip(grads, pgrads, jgrads):
        _close(p, j, tol, f"gradient of input {i}")


def test_box_nms_suppresses_exactly_the_reference_rows():
    """The decisions of ``box_nms`` (score -1) and its stable order hold
    bitwise, ties included, beside the F32 box columns."""
    for data in (NMS, NMS_TIES):
        j = jmx.nd.contrib.box_nms(jmx.nd.array(data), overlap_thresh=0.3,
                                   id_index=0).asnumpy()
        with mx.cpu():
            p = mx.nd.contrib.box_nms(mx.nd.array(data), overlap_thresh=0.3,
                                      id_index=0).asnumpy()
        np.testing.assert_array_equal(p[..., :2], j[..., :2])
        assert (p[..., 1] == -1).any() and (p[..., 1] > -1).any()


def test_every_reference_contrib_name_exists():
    from mxnet_tpu.ndarray import contrib as jc
    assert mx.nd.contrib.__all__ == jc.__all__
    assert len(jc.__all__) == 31
    for name in jc.__all__:
        assert callable(getattr(mx.nd.contrib, name)), name
    assert mx.nd.contrib.math_sqrt(2.0) == jc.math_sqrt(2.0)


def test_edge_id_matches_reference():
    dense = np.array([[0, 1, 0, 2], [3, 0, 0, 0], [0, 4, 5, 0]], np.float32)
    u = np.array([0, 0, 1, 2, 2, 1], np.float32)
    v = np.array([1, 2, 0, 2, 3, 3], np.float32)
    want = jmx.nd.contrib.edge_id(jmx.nd.sparse.csr_matrix(dense),
                                  jmx.nd.array(u), jmx.nd.array(v)).asnumpy()
    with mx.cpu():
        got = mx.nd.contrib.edge_id(mx.nd.sparse.csr_matrix(dense),
                                    mx.nd.array(u), mx.nd.array(v)).asnumpy()
    np.testing.assert_array_equal(got, want)
    with mx.cpu(), pytest.raises(MXNetError, match="CSRNDArray"):
        mx.nd.contrib.edge_id(mx.nd.array(dense), mx.nd.array(u),
                              mx.nd.array(v))


def test_refusals_match_reference():
    with mx.cpu():
        x = mx.nd.array(FEAT)
        with pytest.raises(MXNetError, match="position_sensitive"):
            mx.nd.contrib.ROIAlign(x, mx.nd.array(ROIS),
                                   position_sensitive=True)
        with pytest.raises(MXNetError, match="out_dim"):
            mx.nd.contrib.count_sketch(mx.nd.array(CS_X), CS_H, CS_S)
        cls, bbox, info = _rpn_inputs(1, 2)
        with pytest.raises(MXNetError, match="batch size 1"):
            mx.nd.contrib.Proposal(mx.nd.array(cls), mx.nd.array(bbox),
                                   mx.nd.array(info))
        with pytest.raises(MXNetError, match="iou_loss"):
            mx.nd.contrib.MultiProposal(mx.nd.array(cls), mx.nd.array(bbox),
                                        mx.nd.array(info), iou_loss=True)
