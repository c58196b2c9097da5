"""The port's Gluon losses and loss ops against the JAX package's, on the
CPU.

Each case feeds both packages the same numpy inputs (``RandomState``),
records the loss (``autograd.record()``), runs ``backward`` with the same
head gradient and compares the value and the gradient of every float
input that takes one: within 1e-5 relative in the Frobenius norm
(float32, the same function; the CTC losses within 1e-4: a log-space
recursion over T steps whose sums round in another order).  Every Gluon
loss runs with ``weight`` and a ``sample_weight``.  The output ops
(``SoftmaxOutput``, the regression outputs, ``SVMOutput``) replace the
incoming gradient with their own, so their gradients are compared under
a head gradient that is not ones.

Where the port computes what MXNet defines and the reference does not
(``SigmoidBinaryCrossEntropyLoss``'s ``pos_weight``, ``CTCLoss``'s
``label_layout="TN"``), the port is held against MXNet's formula in
numpy, and against the reference where the two agree.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, gluon

RTOL = 1e-5
CTC_RTOL = 1e-4
B = 4


def _rng(case):
    return np.random.RandomState(sum(map(ord, case)))


def _close(got, want, what, rtol=RTOL):
    want = np.asarray(want, np.float64)
    scale = max(float(np.linalg.norm(want)), 1e-30)
    err = float(np.linalg.norm(np.asarray(got, np.float64) - want)) / scale
    assert err <= rtol, f"{what}: {err:.3g} relative to {scale:.3g}"


def _run(pkg, call, inputs, grad_of, kwargs=None, head=None):
    """``call(module)(*inputs, **kwargs)`` recorded in package ``pkg``
    (``jmx`` or ``mt``): ``(value, [gradient of inputs[i] for i in
    grad_of])``; ``head`` is the gradient ``backward`` starts from."""
    rec = jautograd if pkg is jmx else autograd
    ctx = jmx.cpu() if pkg is jmx else mt.cpu()
    with ctx:
        arrs = [pkg.nd.array(x, dtype=str(x.dtype)) for x in inputs]
        kw = {k: pkg.nd.array(v, dtype=str(v.dtype))
              for k, v in (kwargs or {}).items()}
        for i in grad_of:
            arrs[i].attach_grad()
        with rec.record():
            out = call(pkg)(*arrs, **kw)
        out.backward(None if head is None else
                     pkg.nd.array(head, dtype="float32"))
    return (np.array(out.asnumpy()),
            [np.array(arrs[i].grad.asnumpy()) for i in grad_of])


def _compare(case, call, inputs, grad_of, kwargs=None, head=None,
             rtol=RTOL):
    jv, jg = _run(jmx, call, inputs, grad_of, kwargs, head)
    pv, pg = _run(mt, call, inputs, grad_of, kwargs, head)
    assert pv.shape == jv.shape, case
    _close(pv, jv, f"{case} value", rtol)
    for i, a, b in zip(grad_of, pg, jg):
        _close(a, b, f"{case} gradient of input {i}", rtol)


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _sign(rng, *shape):
    return np.where(rng.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)


def _probs(rng, *shape):
    e = np.exp(rng.randn(*shape))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _ctc_case(rng, n=B, t=12, c=6, pad=-1):
    """Activations (N, T, C), labels (N, 4) padded with ``pad`` past each
    row's length (1-4), label classes 1..C-1 with repeats."""
    lab = np.full((n, 4), pad, np.float32)
    lengths = np.array([4, 1, 3, 2][:n], np.float32)
    for i, k in enumerate(lengths.astype(int)):
        lab[i, :k] = rng.randint(1, c, k)
    lab[0, 1] = lab[0, 0]                    # a repeated label
    return _f(rng, n, t, c), lab, lengths


# name -> (make the loss from the package, inputs from a RandomState,
#          indices of the inputs whose gradient is compared)
LOSSES = {
    "L2Loss": (lambda g: g.loss.L2Loss(weight=0.7),
               lambda r: [_f(r, B, 3), _f(r, B, 3)], (0,)),
    "L2Loss-batch_axis1": (lambda g: g.loss.L2Loss(batch_axis=1),
                           lambda r: [_f(r, 3, B), _f(r, 3, B)], (0,)),
    "L1Loss": (lambda g: g.loss.L1Loss(weight=0.5),
               lambda r: [_f(r, B, 3), _f(r, B, 3)], (0,)),
    "SigmoidBCE": (lambda g: g.loss.SigmoidBinaryCrossEntropyLoss(
        weight=0.6), lambda r: [_f(r, B, 3),
                                (r.rand(B, 3) > 0.5).astype(np.float32)],
        (0,)),
    "SigmoidBCE-from_sigmoid": (
        lambda g: g.loss.SigmoidBCELoss(from_sigmoid=True),
        lambda r: [(1 / (1 + np.exp(-_f(r, B, 3)))).astype(np.float32),
                   (r.rand(B, 3) > 0.5).astype(np.float32)], (0,)),
    "SoftmaxCE": (lambda g: g.loss.SoftmaxCrossEntropyLoss(weight=0.8),
                  lambda r: [_f(r, B, 5),
                             r.randint(0, 5, (B,)).astype(np.float32)],
                  (0,)),
    "SoftmaxCE-dense": (lambda g: g.loss.SoftmaxCELoss(sparse_label=False),
                        lambda r: [_f(r, B, 5), _probs(r, B, 5)], (0,)),
    "KLDivLoss": (lambda g: g.loss.KLDivLoss(weight=0.9),
                  lambda r: [np.log(_probs(r, B, 5)), _probs(r, B, 5)],
                  (0,)),
    "KLDivLoss-logits": (lambda g: g.loss.KLDivLoss(from_logits=False),
                         lambda r: [_f(r, B, 5), _probs(r, B, 5)], (0,)),
    "HuberLoss": (lambda g: g.loss.HuberLoss(rho=0.5, weight=1.5),
                  lambda r: [_f(r, B, 3), _f(r, B, 3)], (0,)),
    "HingeLoss": (lambda g: g.loss.HingeLoss(margin=1.0, weight=0.5),
                  lambda r: [_f(r, B, 3), _sign(r, B, 3)], (0,)),
    "SquaredHingeLoss": (lambda g: g.loss.SquaredHingeLoss(margin=0.5),
                         lambda r: [_f(r, B, 3), _sign(r, B, 3)], (0,)),
    "LogisticLoss": (lambda g: g.loss.LogisticLoss(weight=0.4),
                     lambda r: [_f(r, B, 3), _sign(r, B, 3)], (0,)),
    "LogisticLoss-binary": (
        lambda g: g.loss.LogisticLoss(label_format="binary"),
        lambda r: [_f(r, B, 3), (r.rand(B, 3) > 0.5).astype(np.float32)],
        (0,)),
    "TripletLoss": (lambda g: g.loss.TripletLoss(margin=0.5, weight=0.7),
                    lambda r: [_f(r, B, 3, 2), _f(r, B, 3, 2),
                               _f(r, B, 3, 2)], (0, 1, 2)),
    "CosineEmbeddingLoss": (
        lambda g: g.loss.CosineEmbeddingLoss(margin=0.2, weight=0.9),
        lambda r: [_f(r, B, 5), _f(r, B, 5), _sign(r, B)], (0, 1)),
    "PoissonNLLLoss": (lambda g: g.loss.PoissonNLLLoss(weight=0.5),
                       lambda r: [_f(r, B, 3),
                                  r.poisson(2.0, (B, 3)).astype(np.float32)],
                       (0,)),
    "PoissonNLLLoss-full": (
        lambda g: g.loss.PoissonNLLLoss(from_logits=False,
                                        compute_full=True),
        lambda r: [np.abs(_f(r, B, 3)) + 0.5,
                   r.poisson(2.0, (B, 3)).astype(np.float32)], (0,)),
}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_matches_jax(case):
    make, inputs, grad_of = LOSSES[case]
    rng = _rng(case)
    x = inputs(rng)
    batch = x[0].shape[1 if "batch_axis1" in case else 0]
    sw = rng.rand(batch, *([1] * (x[0].ndim - 1))).astype(np.float32)
    if "batch_axis1" in case:
        sw = sw.reshape(1, batch)
    if case.startswith(("TripletLoss", "CosineEmbedding")):
        sw = sw.reshape(batch)
    _compare(case, lambda pkg: make(
        jgluon if pkg is jmx else gluon), x, grad_of,
        {"sample_weight": sw})


@pytest.mark.parametrize("layout,pad,lengths", [
    ("NTC", -1, False), ("TNC", -1, False), ("NTC", 0, True),
    ("NTC", -1, "pred")], ids=["NTC", "TNC", "zero-padded-lengths",
                               "pred-lengths"])
def test_ctc_loss_matches_jax(layout, pad, lengths):
    rng = _rng(f"ctc{layout}{pad}{lengths}")
    pred, lab, label_lengths = _ctc_case(rng, pad=pad)
    pred_lengths = np.array([12, 10, 9, 11], np.float32)
    if layout == "TNC":
        pred = np.ascontiguousarray(pred.transpose(1, 0, 2))
    inputs = [pred, lab]
    if lengths == "pred":
        inputs.append(pred_lengths)
    elif lengths:
        inputs += [pred_lengths, label_lengths]
    sw = rng.rand(B).astype(np.float32)
    _compare(f"CTCLoss {layout}", lambda pkg: (jgluon if pkg is jmx else
                                               gluon).loss.CTCLoss(
        layout=layout, weight=0.5), inputs, (0,), {"sample_weight": sw},
        rtol=CTC_RTOL)


def test_ctc_loss_is_torch_ctc_loss_and_takes_time_major_labels():
    """The recursion equals ``F.ctc_loss`` (blank 0, no reduction) on the
    same log-probabilities, and ``label_layout="TN"`` reads (L, N)
    labels."""
    rng = _rng("ctc-torch")
    pred, lab, lengths = _ctc_case(rng)
    loss = gluon.loss.CTCLoss()
    got = loss(torch.from_numpy(pred), torch.from_numpy(lab))
    logp = torch.log_softmax(torch.from_numpy(pred), -1).transpose(0, 1)
    want = torch.nn.functional.ctc_loss(
        logp, torch.from_numpy(np.maximum(lab, 0)).long(),
        torch.full((B,), pred.shape[1], dtype=torch.long),
        torch.from_numpy(lengths).long(), blank=0, reduction="none")
    _close(got.numpy(), want.numpy(), "CTCLoss against F.ctc_loss",
           CTC_RTOL)
    tn = gluon.loss.CTCLoss(label_layout="TN")(
        torch.from_numpy(pred), torch.from_numpy(lab.T.copy()))
    np.testing.assert_array_equal(tn.numpy(), got.numpy())


def test_sigmoid_bce_pos_weight_is_mxnets():
    """``pos_weight`` weighs the positive term, as MXNet defines it (the
    reference takes the argument and drops it)."""
    rng = _rng("pos_weight")
    x, z = _f(rng, B, 3), (rng.rand(B, 3) > 0.5).astype(np.float32)
    pw = (rng.rand(1, 3) * 3).astype(np.float32)
    x64, z64, pw64 = (a.astype(np.float64) for a in (x, z, pw))
    sig = 1 / (1 + np.exp(-x64))
    want = -(pw64 * z64 * np.log(sig) + (1 - z64) * np.log(1 - sig))
    got = gluon.loss.SigmoidBCELoss()(torch.from_numpy(x),
                                      torch.from_numpy(z),
                                      pos_weight=torch.from_numpy(pw))
    _close(got.numpy(), want.mean(1), "pos_weight from logits")
    p = sig.astype(np.float32)
    want = -(pw64 * z64 * np.log(sig + 1e-12) +
             (1 - z64) * np.log(1 - sig + 1e-12))
    got = gluon.loss.SigmoidBCELoss(from_sigmoid=True)(
        torch.from_numpy(p), torch.from_numpy(z),
        pos_weight=torch.from_numpy(pw))
    _close(got.numpy(), want.mean(1), "pos_weight from sigmoid")
    with mt.cpu():
        nd = gluon.loss.SigmoidBCELoss()(mt.nd.array(x), mt.nd.array(z))
    jd = jgluon.loss.SigmoidBCELoss()(jmx.nd.array(x), jmx.nd.array(z))
    _close(nd.asnumpy(), np.array(jd.asnumpy()), "no pos_weight")


def test_every_reference_loss_is_ported():
    for name in jgluon.loss.__all__:
        assert hasattr(gluon.loss, name), name


# ----------------------------------------------------------------------
# the loss ops
# ----------------------------------------------------------------------

def _op(name, **kw):
    return lambda pkg: lambda *a: getattr(pkg.nd, name)(*a, **kw)


OPS = {
    "SoftmaxOutput": (
        _op("SoftmaxOutput", grad_scale=0.5),
        lambda r: [_f(r, B, 5), r.randint(0, 5, (B,)).astype(np.float32)]),
    "SoftmaxOutput-ignore-valid": (
        _op("SoftmaxOutput", use_ignore=True, ignore_label=-1,
            normalization="valid"),
        lambda r: [_f(r, B, 5), np.array([1, -1, 4, 0], np.float32)]),
    "SoftmaxOutput-batch": (
        _op("SoftmaxOutput", normalization="batch"),
        lambda r: [_f(r, B, 5), r.randint(0, 5, (B,)).astype(np.float32)]),
    "softmax_cross_entropy": (
        _op("softmax_cross_entropy"),
        lambda r: [_f(r, B, 5), r.randint(0, 5, (B,)).astype(np.float32)]),
    "smooth_l1": (_op("smooth_l1", scalar=1.5),
                  lambda r: [_f(r, B, 5)]),
    "MakeLoss": (_op("MakeLoss", grad_scale=0.3), lambda r: [_f(r, B, 5)]),
    "BlockGrad": (lambda pkg: lambda x: pkg.nd.BlockGrad(x) + x * 2,
                  lambda r: [_f(r, B, 5)]),
    "LinearRegressionOutput": (
        _op("LinearRegressionOutput", grad_scale=0.5),
        lambda r: [_f(r, B, 3), _f(r, B, 3)]),
    "MAERegressionOutput": (_op("MAERegressionOutput"),
                            lambda r: [_f(r, B, 3), _f(r, B, 3)]),
    "LogisticRegressionOutput": (
        _op("LogisticRegressionOutput", grad_scale=2.0),
        lambda r: [_f(r, B, 3), (r.rand(B, 3) > 0.5).astype(np.float32)]),
    "SVMOutput": (_op("SVMOutput", margin=0.5,
                      regularization_coefficient=0.7),
                  lambda r: [_f(r, B, 5),
                             r.randint(0, 5, (B,)).astype(np.float32)]),
    "SVMOutput-linear": (_op("SVMOutput", use_linear=True),
                         lambda r: [_f(r, B, 5),
                                    r.randint(0, 5, (B,)).astype(np.float32)]),
    "IdentityAttachKLSparseReg": (
        _op("IdentityAttachKLSparseReg", sparseness_target=0.2,
            penalty=0.01),
        lambda r: [r.rand(B, 5).astype(np.float32)]),
}


@pytest.mark.parametrize("case", sorted(OPS))
def test_loss_op_matches_jax(case):
    call, inputs = OPS[case]
    rng = _rng(case)
    x = inputs(rng)
    jv, _ = _run(jmx, call, x, ())
    head = rng.randn(*jv.shape).astype(np.float32) if jv.ndim else None
    _compare(case, call, x, (0,), head=head)


@pytest.mark.parametrize("blank,lengths", [
    ("first", False), ("last", False), ("first", True)],
    ids=["blank-first", "blank-last", "lengths"])
@pytest.mark.parametrize("name", ["ctc_loss", "CTCLoss"])
def test_ctc_loss_op_matches_jax(name, blank, lengths):
    rng = _rng(f"{name}{blank}{lengths}")
    pred, lab, label_lengths = _ctc_case(rng, c=6)
    if blank == "last":         # classes 0..C-2, the blank C-1
        lab = np.where(lab > 0, lab - 1, lab)
    data = np.ascontiguousarray(pred.transpose(1, 0, 2))   # (T, B, C)
    kw = dict(blank_label=blank)
    inputs = [data, lab]
    if lengths:
        inputs += [np.array([12, 10, 9, 11], np.float32), label_lengths]
        kw.update(use_data_lengths=True, use_label_lengths=True)
    _compare(f"{name} {blank}", _op(name, **kw), inputs, (0,),
             rtol=CTC_RTOL)


def test_every_loss_op_is_ported():
    names = {c.split("-")[0] for c in OPS} | {"ctc_loss", "CTCLoss"}
    assert len(names) == 12
    for n in names:
        assert n in mt.nd.ops._OPS, n
