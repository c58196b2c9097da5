"""The port's ResNet v1b backbones, segmentation heads and simple pose
against the JAX package's, on the CPU.

- ``ResNetV1b`` at every depth (18, 34, 50, 101; dilated or not; with
  ``contrib.nn.SyncBatchNorm`` as its norm layer) is built in both
  packages and compared by its parameters' structural names and
  declared shapes.  A one-block-a-stage ``ResNetV1b`` runs a predict
  forward and three SGD-momentum steps twice: with ``BottleneckV1b``
  dilated (output stride 8) at 32 x 32, where its last stages'
  2048-channel maps are 4 x 4, and with ``BasicBlockV1b`` at stride 32
  at 64 x 64 (each reference run compiles its forward, backward and
  two update programs, some 12 s of CPU).
- ``_FCNHead``, ``_PyramidPooling`` and ``_ASPP`` run alone on 16 input
  channels at 13 x 13 (neither 2, 3 nor 6 divides 13, so
  ``AdaptiveAvgPooling2D``'s bins overlap): predict and training-mode
  outputs, and the predict-mode gradients of a fixed linear head.  In
  training mode each pooled branch's BatchNorm normalizes 2-72 values
  a channel whose mean is some 50 deviations from 0, so the mean's
  rounding puts units within 1e-6 of the ReLU's kink (channel 298 of
  the 3-bin branch read -5.95e-7 in float64), and one unit on the other
  side moved that conv's gradient by 3.5e-2 of its norm; the
  training-mode backward of BatchNorm is held by the v1b, FCN and pose
  steps below.
- ``FCN``, ``PSPNet`` and ``DeepLabV3`` (ResNet-50 v1b, 5 classes) run
  whole at 32 x 32, the reference's own test size, in predict mode;
  ``FCN`` with ``aux`` over a one-block-a-stage dilated backbone (the
  reference's training compile of the whole ResNet-50 would take some
  10 s of this file's budget) in training mode returns both outputs and
  takes one SGD step of a per-pixel softmax cross-entropy over both;
  the backbone's classifier, which the forward does not read, takes a
  zero gradient and steps by its weight decay alone, as in the
  reference.
- ``SimplePoseResNet`` over ``resnet18_v1b`` at 64 x 64 runs a predict
  forward and one Adam step of an ``L2Loss`` on its heatmaps against
  seeded targets; ``heatmap_to_coord`` is held exactly, ties of the
  maximum included (both take the first maximum).
- ``chip_smoke.py``'s float64 witness at the card's kinks (phases
  44-47), with the CPU standing in for the card: ``_kink_mode`` records
  and replays ReLU and LeakyReLU gates exactly, and ``_kink_witness``
  holds a small conv net's f32 gradients within phase 42's limits of
  float64's at the same gates.

The weights are ``Xavier(magnitude=2)``'s draws made with numpy from
``RandomState(SEED)``, written into the reference's parameters and
carried from there by ``convert.load_block_weights``, which refuses a
name left over on either side (``test_torch_port_vision_zoo._pair``);
no draw touches the reference's global key.  The heads' Dropout layers
run at rate 0 in the training comparisons: their masks come from each
package's own generator (ROADMAP §3).  Tolerances, with their reasons:

- forwards, predict and training mode: 1e-4 absolute and relative (the
  convolutions' sums in another order, the training-mode BatchNorms over
  8-4096 values a channel); FCN's training-mode outputs also within
  SPREAD_X times the largest change the ulp-moved input makes in the
  port's own (BatchNorms over 32 values a channel at c4: over the whole
  ResNet-50 the port moved 2.3e-4 from that input and read 2.6e-4 from
  the reference);
- gradients: each within GRAD_RTOL (5e-3) of its norm plus GRAD_ATOL
  (5e-5), as ``test_torch_port_vision_zoo.py`` (ReLU units that
  rounding puts on the other side of 0 through BatchNorm stacks at
  batch 2-4); the one-block ResNetV1b's first gradients also within
  SPREAD_X (2) times what one ulp more in half of the input's elements
  moves the port's own (``chip_smoke.py`` phase 43's rule): at stride
  32 and 64 x 64 its last stage normalizes 16 values a channel, and one
  ulp of input moves the port's stem and stage-1 gradients by 4.8e-3
  of their norm, what the port and the reference read apart (5.2e-3);
- the three SGD steps' losses: the first within 1e-5 relative, the
  later ones within 5e-2; each parameter's whole update within 0.15 of
  the reference's update norm plus 1e-5 (``test_torch_port_vision_
  zoo.py``'s limits and reasons); for the one-block ResNetV1b each also
  within SPREAD_X times what the ulp-moved input moved the port's own
  (its loss falls to 0.02 by the third step, so the first gradients'
  differences are a large share of the later losses);
- one Adam step (pose): each parameter's update within ADAM_RTOL (2e-2)
  of the reference's update norm plus 1e-6; Adam's first step moves
  each element by about lr whatever its gradient's size, so an element
  whose gradient is rounding noise moves a whole lr either way (running
  statistics are held like the forwards).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag, gluon
from mxnet_tpu_torch.convert import load_block_weights
from mxnet_tpu_torch.gluon.model_zoo import vision
from test_torch_port_resnet import _chip_smoke
from test_torch_port_vision_zoo import (
    FWD_TOL, GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, LOSS_RTOL0, UPD_ATOL, UPD_TOL,
    _declared, _pair, _train)

CLASSES = 10
NCLASS = 5
ADAM_RTOL, ADAM_ATOL, ADAM_LR = 2e-2, 1e-6, 1e-3
SPREAD_X = 2.0


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pkg(v):
    return (jmx, jgluon, jag) if v is jvision else (mx, gluon, ag)


def _grads(net):
    return {k: p.grad().asnumpy() for k, p in
            net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _weights(net):
    return {k: p.data().asnumpy() for k, p in
            net._collect_params_with_prefix().items()}


def _close_grads(got, want, spread=None):
    """Each gradient within GRAD_RTOL of its norm plus GRAD_ATOL, plus
    SPREAD_X times ``spread[k]`` where given."""
    assert sorted(got) == sorted(want)
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        norm = np.linalg.norm(want[k])
        extra = SPREAD_X * spread[k] if spread else 0.0
        assert err <= GRAD_RTOL * norm + GRAD_ATOL + extra, \
            (k, err, norm, extra)


def _close_updates(got, want, w0, rtol, atol, spread=None):
    assert sorted(got) == sorted(want)
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        upd = np.linalg.norm(want[k] - w0[k])
        extra = SPREAD_X * spread[k] if spread else 0.0
        assert err <= rtol * upd + atol + extra, (k, err, upd, extra)


def _ulp_up(x):
    """``x`` one ulp up in half of its elements (a fixed half)."""
    out = x.copy()
    up = np.random.RandomState(0).rand(*x.shape) < 0.5
    out[up] = np.nextafter(out[up], np.float32(2))
    return out


def _predict(net, x, v):
    pkg, _, rec = _pkg(v)
    with (mx.cpu() if pkg is mx else jmx.cpu()), rec.predict_mode():
        out = net(pkg.nd.array(x))
    if isinstance(out, (list, tuple)):
        return [o.asnumpy() for o in out]
    return out.asnumpy()


# ----------------------------------------------------------------------
# the v1b backbones
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dilated", [True, False],
                         ids=["dilated", "stride32"])
def test_every_v1b_depth_builds_like_the_reference(dilated):
    for name in ("resnet18_v1b", "resnet34_v1b", "resnet50_v1b",
                 "resnet101_v1b"):
        got = _declared(vision.get_model(name, dilated=dilated))
        want = _declared(jvision.get_model(name, dilated=dilated))
        assert got == want, name
    # dilation: stage 3 and 4 keep the stride of stage 2; the first
    # block of stage 4 takes dilation 2, the others 4, its basic
    # block's second conv the stage's own
    net = vision.resnet18_v1b(dilated=dilated)
    l4 = net.layer4._children
    dil = [(b.conv1._kwargs["dilate"], b.conv2._kwargs["dilate"])
           for b in l4.values()]
    want = [((2, 2), (4, 4)), ((4, 4), (4, 4))] if dilated else \
        [((1, 1), (1, 1))] * 2
    assert dil == want


def test_v1b_takes_sync_batch_norm_as_its_norm_layer():
    from mxnet_tpu_torch.gluon.contrib.nn import SyncBatchNorm
    from mxnet_tpu.gluon.contrib.nn import SyncBatchNorm as JSync
    net = vision.resnet18_v1b(norm_layer=SyncBatchNorm)
    assert _declared(net) == _declared(
        jvision.resnet18_v1b(norm_layer=JSync))
    assert isinstance(net.bn1, SyncBatchNorm)
    assert isinstance(net.layer3._children["0"].bn2, SyncBatchNorm)
    net.initialize(ctx=mx.cpu())
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    with mx.cpu(), ag.record():
        out = net(mx.nd.array(x))
    assert out.shape == (2, 1000) and np.isfinite(out.asnumpy()).all()


# (block, dilated, input size)
V1B_CASES = [("BottleneckV1b", True, 32), ("BasicBlockV1b", False, 64)]


def _v1b_small(block, dilated):
    def make(v):
        return v.segmentation.ResNetV1b(
            [1, 1, 1, 1], classes=CLASSES, dilated=dilated,
            block=getattr(v.segmentation, block), prefix="n_")
    return make


@pytest.fixture(scope="module", params=V1B_CASES,
                ids=[f"{b}-{'dilated' if d else 'stride32'}"
                     for b, d, _ in V1B_CASES])
def v1b_run(request):
    """One-block-a-stage ResNetV1b in both packages: a predict forward
    and three SGD steps (the reference's compiles run here), and the
    port's first step again from an input one ulp up in half of its
    elements."""
    block, dilated, size = request.param
    rng = np.random.RandomState(1)
    x = rng.rand(4, 3, size, size).astype(np.float32)
    y = rng.randint(0, CLASSES, (4,)).astype(np.int32)
    make = _v1b_small(block, dilated)
    jnet, pnet = _pair(make, x)
    out = {"w0": _weights(jnet),
           "j_predict": _predict(jnet, x, jvision),
           "p_predict": _predict(pnet, x, vision)}
    out["j_steps"] = _train(jmx, jnet, x, y)
    out["p_steps"] = _train(mx, pnet, x, y)
    x_ulp = _ulp_up(x)
    again = make(vision)
    again.initialize(ctx=mx.cpu())
    with mx.cpu(), ag.predict_mode():
        again(mx.nd.array(x))
    load_block_weights(again, out["w0"])
    out["ulp_steps"] = _train(mx, again, x_ulp, y)
    return out


def test_v1b_forward_matches_jax(v1b_run):
    got = v1b_run
    np.testing.assert_allclose(got["p_predict"], got["j_predict"],
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got["p_steps"][3], got["j_steps"][3],
                               rtol=FWD_TOL, atol=FWD_TOL)
    assert got["p_predict"].shape == (4, CLASSES)


def test_v1b_sgd_steps_match_jax(v1b_run):
    (pl, pw, pg, _), (jl, jw, jg, _) = v1b_run["p_steps"], \
        v1b_run["j_steps"]
    ul, uw, ug, _ = v1b_run["ulp_steps"]
    _close_grads(pg, jg, {k: float(np.linalg.norm(ug[k] - pg[k]))
                          for k in pg})
    np.testing.assert_allclose(pl[0], jl[0], rtol=LOSS_RTOL0)
    for a, b, u in zip(pl[1:], jl[1:], ul[1:]):
        assert np.all(np.abs(a - b) <= LOSS_RTOL * np.abs(b) +
                      SPREAD_X * np.abs(u - a)), (a, b, u)
    _close_updates(pw, jw, v1b_run["w0"], UPD_TOL, UPD_ATOL,
                   {k: float(np.linalg.norm(uw[k] - pw[k])) for k in pw})


# ----------------------------------------------------------------------
# the heads alone
# ----------------------------------------------------------------------

def _no_dropout(net):
    def off(blk):
        if type(blk).__name__ == "Dropout":
            blk._rate = 0.0
    net.apply(off)
    return net


def _head(kind):
    def make(v):
        seg = v.segmentation
        if kind == "fcn":
            return seg._FCNHead(NCLASS, 32, prefix="h_")
        if kind == "psp":
            return seg._PyramidPooling(prefix="h_")
        return seg._ASPP(prefix="h_")
    return make


def _head_run(v, net, x, cot):
    """Predict output and the gradients of ``sum(out * cot)`` in predict
    mode, then the training-mode output."""
    pkg, _, rec = _pkg(v)
    with (mx.cpu() if pkg is mx else jmx.cpu()):
        xa, ca = pkg.nd.array(x), pkg.nd.array(cot)
        with rec.record(train_mode=False):
            pred = net(xa)
            loss = (pred * ca).sum()
        loss.backward()
        with rec.train_mode():
            out = net(xa)
    return pred.asnumpy(), out.asnumpy(), _grads(net)


@pytest.fixture(scope="module", params=["fcn", "psp", "aspp"])
def head_run(request):
    """One head alone in both packages (the reference's compiles run
    here): predict output and gradients, training-mode output."""
    kind = request.param
    rng = np.random.RandomState(2)
    x = rng.rand(2, 16, 13, 13).astype(np.float32)
    jnet, pnet = _pair(_head(kind), x)
    width = {"fcn": NCLASS, "psp": 16 + 4 * 512, "aspp": 256}[kind]
    cot = rng.randn(2, width, 13, 13).astype(np.float32)
    return width, _head_run(jvision, jnet, x, cot), \
        _head_run(vision, pnet, x, cot)


def test_head_alone_matches_jax(head_run):
    width, (jp, jt, jg), (pp, pt, pg) = head_run
    assert pp.shape == jp.shape == (2, width, 13, 13)
    np.testing.assert_allclose(pp, jp, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(pt, jt, rtol=FWD_TOL, atol=FWD_TOL)
    _close_grads(pg, jg)


# ----------------------------------------------------------------------
# the whole segmentation models at 32 x 32
# ----------------------------------------------------------------------

SEG_MODELS = {"fcn": "get_fcn", "psp": "get_psp", "deeplab": "get_deeplab"}


def _resolve_unread(net, xa):
    """A forward, then the parts it does not read: the backbone's
    classifier is a parameter of every segmentation model in both
    packages, and the auxiliary head runs only in training mode; one
    call of each gives them their shapes."""
    net(xa)
    net.base(xa)
    net.auxlayer(net.base.extract(xa)[0])


@pytest.fixture(scope="module", params=sorted(SEG_MODELS))
def seg_predict(request):
    """One whole model's ``predict`` in both packages (the reference's
    compile runs here)."""
    x = np.random.RandomState(3).rand(2, 3, 32, 32).astype(np.float32)
    jnet, pnet = _pair(lambda v: getattr(v, SEG_MODELS[request.param])(
        nclass=NCLASS, prefix="s_"), x, call=_resolve_unread)
    return _seg_predict(pnet, jnet, x)


def test_segmentation_model_predicts_like_jax(seg_predict):
    got, want = seg_predict
    assert got.shape == want.shape == (2, NCLASS, 32, 32)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def _seg_predict(pnet, jnet, x):
    """Both packages' ``predict`` (the port's ``evaluate`` too)."""
    with jmx.cpu():
        want = jnet.predict(jmx.nd.array(x)).asnumpy()
    with mx.cpu():
        got = pnet.predict(mx.nd.array(x)).asnumpy()
        np.testing.assert_array_equal(
            pnet.evaluate(mx.nd.array(x)).asnumpy(), got)
    return got, want


def _seg_step(v, net, x, y):
    """FCN with ``aux`` in training mode: both outputs, then one SGD
    step of the per-pixel softmax cross-entropy of both."""
    pkg, g, rec = _pkg(v)
    tr = g.Trainer(net.collect_params(), "sgd",
                   {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4})
    ce = g.loss.SoftmaxCrossEntropyLoss(axis=1)
    with (mx.cpu() if pkg is mx else jmx.cpu()):
        xa, ya = pkg.nd.array(x), pkg.nd.array(y, dtype="int32")
        with rec.record():
            out, aux = net(xa)
            loss = ce(out, ya) + 0.4 * ce(aux, ya)
        loss.backward()
        grads = _grads(net)
        tr.step(x.shape[0])
    return out.asnumpy(), aux.asnumpy(), loss.asnumpy(), grads, \
        _weights(net)


def _fcn_one_block(v):
    net = v.get_fcn(nclass=NCLASS, prefix="s_")
    net.base = v.segmentation.ResNetV1b([1, 1, 1, 1], dilated=True)
    return net


@pytest.fixture(scope="module")
def fcn_run():
    """FCN with ``aux`` over a one-block-a-stage dilated ``ResNetV1b`` of
    bottlenecks (c3 and c4 as wide as ResNet-50's): one training step in
    both packages (the reference's compiles run here), and the port's
    step again from the same weights and an input one ulp up in half of
    its elements."""
    rng = np.random.RandomState(4)
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, NCLASS, (2, 32, 32)).astype(np.int32)
    jnet, pnet = _pair(_fcn_one_block, x, call=_resolve_unread)
    w0 = _weights(jnet)
    out = {"w0": w0, "j": _seg_step(jvision, jnet, x, y),
           "p": _seg_step(vision, pnet, x, y)}
    load_block_weights(pnet, w0)
    out["ulp"] = _seg_step(vision, pnet, _ulp_up(x), y)
    return out


def test_fcn_with_aux_trains_like_jax(fcn_run):
    jo, ja, jl, jg, jw = fcn_run["j"]
    po, pa, pl, pg, pw = fcn_run["p"]
    uo, ua, ul, ug, uw = fcn_run["ulp"]
    assert po.shape == pa.shape == (2, NCLASS, 32, 32)
    for got, want, moved in ((po, jo, uo), (pa, ja, ua)):
        lim = FWD_TOL + FWD_TOL * np.abs(want) + \
            SPREAD_X * np.abs(moved - got).max()
        assert np.all(np.abs(got - want) <= lim)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL0)
    _close_grads(pg, jg, {k: float(np.linalg.norm(ug[k] - pg[k]))
                          for k in pg})
    _close_updates(pw, jw, fcn_run["w0"], UPD_TOL, UPD_ATOL,
                   {k: float(np.linalg.norm(uw[k] - pw[k])) for k in pw})
    assert np.array_equal(pw["base.fc.weight"], jw["base.fc.weight"]) or \
        np.abs(pw["base.fc.weight"] - jw["base.fc.weight"]).max() < 1e-7


def test_segmentation_heads_draw_their_dropout_in_training_mode():
    """With the heads' Dropouts at their own rates, two training-mode
    calls draw two masks from the device's generator, and predict mode
    draws none (the masks are each package's own: ROADMAP §3)."""
    net = vision.segmentation._FCNHead(NCLASS, 32)
    net.initialize(ctx=mx.cpu())
    x = np.random.RandomState(5).rand(2, 16, 8, 8).astype(np.float32)
    with mx.cpu():
        mx.random.seed(7)
        with ag.record():
            a = net(mx.nd.array(x)).asnumpy()
            b = net(mx.nd.array(x)).asnumpy()
        with ag.predict_mode():
            c = net(mx.nd.array(x)).asnumpy()
            d = net(mx.nd.array(x)).asnumpy()
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(c, d)


# ----------------------------------------------------------------------
# simple pose
# ----------------------------------------------------------------------

def _pose_step(v, net, x, target):
    pkg, g, rec = _pkg(v)
    tr = g.Trainer(net.collect_params(), "adam",
                   {"learning_rate": ADAM_LR})
    l2 = g.loss.L2Loss()
    with (mx.cpu() if pkg is mx else jmx.cpu()):
        xa, ta = pkg.nd.array(x), pkg.nd.array(target)
        with rec.record():
            hm = net(xa)
            loss = l2(hm, ta)
        loss.backward()
        grads = _grads(net)
        tr.step(x.shape[0])
    return hm.asnumpy(), loss.asnumpy(), grads, _weights(net)


@pytest.fixture(scope="module")
def pose_run():
    """Both packages' simple pose: a predict forward, then one Adam
    step (the reference's compiles run here)."""
    rng = np.random.RandomState(6)
    x = rng.rand(2, 3, 64, 64).astype(np.float32)
    target = rng.rand(2, 17, 16, 16).astype(np.float32)
    jnet, pnet = _pair(lambda v: v.simple_pose_resnet18_v1b(prefix="p_"), x)
    out = {"w0": _weights(jnet), "j_predict": _predict(jnet, x, jvision),
           "p_predict": _predict(pnet, x, vision)}
    out["j_step"] = _pose_step(jvision, jnet, x, target)
    out["p_step"] = _pose_step(vision, pnet, x, target)
    return out


def test_simple_pose_predicts_like_jax(pose_run):
    got, want = pose_run["p_predict"], pose_run["j_predict"]
    assert got.shape == want.shape == (2, 17, 16, 16)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_simple_pose_takes_an_adam_step_like_jax(pose_run):
    jh, jl, jg, jw = pose_run["j_step"]
    ph, pl, pg, pw = pose_run["p_step"]
    np.testing.assert_allclose(ph, jh, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL0)
    _close_grads(pg, jg)
    pw, jw = dict(pw), dict(jw)
    stats = [k for k in jw if k.endswith(("running_mean", "running_var"))]
    for k in stats:
        np.testing.assert_allclose(pw.pop(k), jw.pop(k), rtol=FWD_TOL,
                                   atol=FWD_TOL)
    _close_updates(pw, jw, pose_run["w0"], ADAM_RTOL, ADAM_ATOL)
    assert "features.7.1.conv3.weight" not in pw       # basic blocks
    assert "deconv_layers.0.weight" in pw


def test_heatmap_to_coord_matches_jax_with_ties():
    rng = np.random.RandomState(8)
    hm = rng.rand(2, 4, 6, 5).astype(np.float32)
    hm[0, 0] = 0.25                       # every cell ties
    hm[0, 1, 4, 3] = hm[0, 1, 1, 2] = 2.0  # two maxima: the first wins
    hm[1, 2, :, 4] = 3.0                  # a column of maxima
    from mxnet_tpu.gluon.model_zoo.vision.pose import heatmap_to_coord as jh
    jc, js = jh(jmx.nd.array(hm))
    with mx.cpu():
        pc, ps = vision.heatmap_to_coord(mx.nd.array(hm))
    assert pc.dtype == np.float32 and pc.shape == (2, 4, 2)
    np.testing.assert_array_equal(pc.asnumpy(), jc.asnumpy())
    np.testing.assert_array_equal(ps.asnumpy(), js.asnumpy())
    assert pc.asnumpy()[0, 1].tolist() == [2.0, 1.0]
    assert pc.asnumpy()[1, 2].tolist() == [4.0, 0.0]
    # a torch tensor is taken as well, and stays on its device
    c, s = vision.heatmap_to_coord(torch.from_numpy(hm))
    assert c.context.device_type == "cpu"
    np.testing.assert_array_equal(c.asnumpy(), jc.asnumpy())


# ----------------------------------------------------------------------
# chip_smoke's float64 witness at the card's kinks (phases 44-47)
# ----------------------------------------------------------------------

def test_smoke_kink_mode_passes_the_gradient_where_the_record_did():
    """``chip_smoke._kink_mode``: recording keeps each ReLU's and
    LeakyReLU's gate in call order; replayed, a unit passes its gradient
    where the recorded gate did, whatever its own input, and the units
    whose own gate differs are counted."""
    smoke = _chip_smoke()
    x = torch.tensor([-1.0, 2.0, 3.0, -4.0], requires_grad=True)
    with smoke._kink_mode() as rec:
        torch.relu(x)
        torch.nn.functional.leaky_relu(x, 0.1)
    assert [g.tolist() for g in rec.gates] == [[False, True, True, False]] * 2
    flipped = torch.tensor([True, True, False, False])
    with smoke._kink_mode([flipped, flipped]) as again:
        y = torch.relu(x).sum() + torch.nn.functional.leaky_relu(x, 0.1).sum()
    y.backward()
    assert again.flips == 4 and again.units == 8 and again.at == 2
    np.testing.assert_array_equal(x.grad.numpy(), np.float32([2, 2, 0.1, 0.1]))


def test_smoke_kink_witness_holds_f32_against_float64_at_its_gates():
    """``chip_smoke._kink_witness`` with the CPU in the card's place: a
    net of convolutions, BatchNorm over 4 x 14 x 14 values a channel,
    ReLU and LeakyReLU takes one step's forward and backward in f32 with
    its gates recorded, then in float64 with them replayed: each f32
    gradient within phase 42's limits (1e-3 of the float64 one's norm
    plus 5e-5)."""
    smoke = _chip_smoke()
    nn = gluon.nn

    def make():
        net = nn.HybridSequential()
        net.add(nn.Conv2D(8, 3), nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2D(8, 3), nn.BatchNorm(), nn.LeakyReLU(0.1),
                nn.GlobalAvgPool2D(), nn.Dense(CLASSES))
        return net
    rng = np.random.RandomState(10)
    x = rng.rand(4, 3, 16, 16).astype(np.float32)
    y = rng.randint(0, CLASSES, 4).astype(np.int32)
    host = make()
    with mx.cpu():
        mx.random.seed(10)
        host.initialize(mx.init.Xavier(magnitude=2))
        host(mx.nd.array(x))
    w0 = _weights(host)

    def step(model, trainer, ctx, xs):
        with ctx:
            xa = xs if isinstance(xs, mx.nd.NDArray) else mx.nd.array(xs)
            with ag.record():
                loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                    model(xa), mx.nd.array(y, dtype="int32"))
            loss.backward()
        trainer.step(4)
        return loss
    f32, f64, flips, units, _ = smoke._kink_witness(make, w0, mx.cpu(), x,
                                                     step)
    assert units == 4 * 8 * (14 * 14 + 12 * 12) and flips < units // 1000
    assert sorted(f32) == sorted(f64) and len(f64) == 10
    for k, g in f64.items():
        assert g.dtype == np.float64
        err = np.linalg.norm(f32[k] - g)
        assert err <= smoke.RESNET_UPDATE_RTOL * np.linalg.norm(g) + \
            smoke.MBV2_GRAD_ATOL, (k, err)
