"""The port's vision zoo beyond the ResNets against the JAX package's, on
the CPU: the eight classifier families and SSD.

Each family runs narrow where the reference's constructor allows it, or
at a thumbnail input: AlexNet at 64 x 64; VGG-11 with BatchNorm at
widths 8-16 and 32 x 32; SqueezeNet 1.1 at 64 x 64; DenseNet with 8
initial features, growth 4 and two layers a block, at 224 x 224 (its
last pooling is 7 x 7); ResNeXt with SE gates and ResNeSt at one block
a stage, 64 x 64.  Inception V3 and MobileNet v1/v2 fix their depth
(and Inception its 299 x 299 input), so their own blocks run instead,
at small inputs: Inception's A-E modules in a row, MobileNet's
depthwise pairs, MobileNet v2's linear bottlenecks with and without the
shortcut.  Every registered name is built at full width and compared by
its parameters' structural names and declared shapes.  The full-width
nets run on the card against the port's CPU (``chip_smoke.py`` phase
42).  SSD runs with a narrow feature block.

The weights are ``Xavier(magnitude=2)``'s draws (as
``test_torch_port_resnet.py``: a BatchNorm after a narrow conv would
otherwise divide by a tiny deviation), made with numpy from
``RandomState(SEED)``, written into the reference's parameters and
carried from there by structural name; the Dropout layers run at rate 0 in the
training comparisons (their masks come from other generators).
Tolerances, with their reasons:

- forward, predict and training mode (the first step's): 1e-4 absolute
  and relative (the convolutions' sums in another order, and in training
  mode BatchNorms over 16-200,000 values a channel; largest difference
  seen 1.1e-5);
- the first step's gradients, each within 5e-3 of its norm plus 5e-5
  (worst seen 7.9e-4 of the norm, SE-ResNeXt's betas; 1.1e-5 absolute
  at ResNeSt's attention biases, which feed a BatchNorm and take a zero
  gradient in exact arithmetic);
- three SGD-momentum steps (lr 0.01, momentum 0.9), held by each
  parameter's whole update ``p3 - p0``: the port's within 0.15 of the
  reference's update norm, plus 1e-5 absolute (conv biases and betas
  that feed a BatchNorm take a zero gradient in exact arithmetic, and
  their updates are rounding noise: 7e-7 seen); the first step's losses
  within 1e-5 relative and the later ones' within 5e-2.  Worst seen:
  0.122 of the update norm (DenseNet's ``features.4.0.body.0.gamma``),
  later losses 1.4e-2 apart (SE-ResNeXt, whose loss falls to 0.09 by
  the third step): the first gradients' differences, ReLU units that
  rounding puts on the other side of 0, grow with each step through
  these BatchNorm stacks at batch 4, and momentum carries them on;
- MobileNet v2 against float64 at the same ReLU6 gates (the reference of
  ``chip_smoke.py`` phase 42): the loss within 1e-5 relative, each
  gradient within 1e-4 of its norm plus 5e-5 (1.4e-6, 2.7e-5 and 9.8e-6
  seen);
- SSD: the training outputs (class and box predictions, anchors) 1e-4;
  inference detections: the ids and kept scores exactly where the
  scores are more than 1e-4 from the NMS threshold's ties, boxes 1e-4.
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

SEED = 26
CLASSES = 10
FWD_TOL, LR = 1e-4, 0.01
LOSS_RTOL0, LOSS_RTOL = 1e-5, 5e-2
GRAD_RTOL, GRAD_ATOL = 5e-3, 5e-5
MBV2_LOSS_RTOL, MBV2_RTOL, MBV2_ATOL = 1e-5, 1e-4, 5e-5
UPD_TOL, UPD_ATOL = 0.15, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inception_blocks(v):
    from importlib import import_module
    inc = import_module(v.__name__ + ".inception")
    net = _seq(v, "inc_")
    with net.name_scope():
        net.add(inc._make_A(16, "A_"), inc._make_B("B_"),
                inc._make_C(32, "C_"), inc._make_D("D_"), inc._make_E("E_"))
    return _head(v, net)


def _mobilenet_blocks(v):
    from importlib import import_module
    mob = import_module(v.__name__ + ".mobilenet")
    net = _seq(v, "mob_")
    with net.name_scope():
        mob._add_conv(net, 8, kernel=3, stride=2, pad=1)
        mob._add_conv_dw(net, 8, 16, 1)
        mob._add_conv_dw(net, 16, 16, 2)
    return _head(v, net)


def _mobilenet_v2_blocks(v):
    from importlib import import_module
    mob = import_module(v.__name__ + ".mobilenet")
    net = _seq(v, "mob2_")
    with net.name_scope():
        mob._add_conv(net, 8, kernel=3, stride=2, pad=1, relu6=True)
        net.add(mob.LinearBottleneck(8, 8, 6, 1),
                mob.LinearBottleneck(8, 16, 6, 2))
    return _head(v, net)


def _seq(v, prefix):
    nn = (jgluon if v is jvision else gluon).nn
    return nn.HybridSequential(prefix=prefix)


def _head(v, body):
    nn = (jgluon if v is jvision else gluon).nn
    net = nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(body, nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(CLASSES))
    return net


# name -> (constructor over a vision package, (B, C, H, W) input)
FAMILIES = {
    "alexnet": (lambda v: v.alexnet(classes=CLASSES, prefix="n_"),
                (2, 3, 64, 64)),
    "vgg11_bn-narrow": (lambda v: v.VGG([1, 1, 1, 1, 1], [8, 8, 16, 16, 16],
                                        classes=CLASSES, batch_norm=True,
                                        prefix="n_"), (4, 3, 32, 32)),
    "squeezenet1_1": (lambda v: v.squeezenet1_1(classes=CLASSES,
                                                prefix="n_"),
                      (4, 3, 64, 64)),
    "densenet-narrow": (lambda v: v.DenseNet(8, 4, [2, 2, 2, 2],
                                             classes=CLASSES, prefix="n_"),
                        (4, 3, 224, 224)),
    "inception-blocks": (_inception_blocks, (2, 8, 17, 17)),
    "mobilenet-blocks": (_mobilenet_blocks, (4, 3, 32, 32)),
    "mobilenet_v2-blocks": (_mobilenet_v2_blocks, (4, 3, 32, 32)),
    "se_resnext-narrow": (lambda v: v.ResNeXt([1, 1, 1, 1], 4, 8,
                                              classes=CLASSES, use_se=True,
                                              prefix="n_"), (4, 3, 64, 64)),
    "resnest-narrow": (lambda v: v.ResNeSt([1, 1, 1, 1], classes=CLASSES,
                                           stem_width=8, prefix="n_"),
                       (4, 3, 64, 64)),
}


def _no_dropout(net):
    def off(blk):
        if type(blk).__name__ == "Dropout":
            blk._rate = 0.0
    net.apply(off)
    return net


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape).astype(np.float32),
            rng.randint(0, CLASSES, (shape[0],)).astype(np.int32))


def _train(pkg, net, x, y, steps=3):
    """``steps`` SGD-momentum steps: (the losses, the parameters after,
    the first step's gradients, the first step's training-mode logits)."""
    g = jgluon if pkg is jmx else gluon
    rec = jag if pkg is jmx else ag
    tr = g.Trainer(net.collect_params(), "sgd",
                   {"learning_rate": LR, "momentum": 0.9})
    ce = g.loss.SoftmaxCrossEntropyLoss()
    params = net._collect_params_with_prefix()
    losses = []
    with (mx.cpu() if pkg is mx else jmx.cpu()):
        xa, ya = pkg.nd.array(x), pkg.nd.array(y, dtype="int32")
        for step in range(steps):
            with rec.record():
                out = net(xa)
                loss = ce(out, ya)
            loss.backward()
            if step == 0:
                logits = out.asnumpy()
                grads = {k: p.grad().asnumpy() for k, p in params.items()
                         if p.grad_req != "null"}
            tr.step(x.shape[0])
            losses.append(loss.asnumpy())
    return losses, {k: p.data().asnumpy() for k, p in params.items()}, \
        grads, logits


def _xavier(name, shape, rng):
    """``Xavier(magnitude=2)``'s draw for a parameter of ``shape`` (the
    reference's rule: uniform in +-sqrt(2 / mean(fan_in, fan_out)) for a
    weight; BatchNorm's gamma and running variance ones, the rest
    zeros), from the numpy generator ``rng``."""
    if name.endswith(("gamma", "running_var")):
        return np.ones(shape, np.float32)
    if len(shape) < 2:
        return np.zeros(shape, np.float32)
    field = int(np.prod(shape[2:]))
    scale = np.sqrt(2.0 / ((shape[1] * field + shape[0] * field) / 2.0))
    return rng.uniform(-scale, scale, shape).astype(np.float32)


def _no_init(desc, arr):
    """An initializer that leaves the reference's zeros: ``_pair`` writes
    every parameter (its own initializers compile one XLA program a
    shape)."""


def _pair(make, x, hybridize=True, call=None):
    """The reference's net and the port's from the same weights.  The
    port resolves the deferred shapes (one forward from zeros, the
    cheapest initializer: each layer's own draws cost some 10 ms a
    parameter); the weights are
    ``Xavier(magnitude=2)``'s draws made with numpy from
    ``RandomState(SEED)``, written into the reference's parameters (made
    by ``_no_init``, each layer's own initializer cleared: the
    reference's initializers compile one XLA program a parameter shape)
    and carried from there to the port's by ``load_block_weights``.  The reference runs hybridized,
    one program a mode, the port too unless ``hybridize`` is False.
    ``call(pnet, xa)`` replaces that forward where the net takes more
    arguments, or leaves parameters deferred (a segmentation backbone's
    unread classifier)."""
    pnet = _no_dropout(make(vision))
    pnet.initialize(mx.init.Zero(), ctx=mx.cpu())      # overwritten below
    with mx.cpu(), ag.predict_mode():
        (call or (lambda n, a: n(a)))(pnet, mx.nd.array(x))
    rng = np.random.RandomState(SEED)
    drawn = {k: _xavier(k, tuple(p.shape), rng) for k, p in
             sorted(pnet._collect_params_with_prefix().items())}
    jnet = _no_dropout(make(jvision))
    for p in jnet.collect_params().values():
        p.init = None
    jnet.initialize(_no_init)
    jparams = jnet._collect_params_with_prefix()
    assert sorted(jparams) == sorted(drawn)
    for k, p in jparams.items():
        p._finish_deferred_init(drawn[k].shape)
        p.set_data(jmx.nd.array(drawn[k]))
    weights = {k: p.data().asnumpy() for k, p in jparams.items()}
    load_block_weights(pnet, weights)
    jnet.hybridize()
    pnet.hybridize(hybridize)
    return jnet, pnet


def _family_run(name):
    """Both packages on family ``name``: a predict forward of one input,
    then three SGD steps, the first one's training-mode forward the
    training comparison."""
    make, shape = FAMILIES[name]
    x, y = _inputs(shape, 1)
    jnet, pnet = _pair(make, x)
    out = {"w0": {k: p.data().asnumpy() for k, p in
                  jnet._collect_params_with_prefix().items()}}
    with jag.predict_mode():
        out["j_predict"] = jnet(jmx.nd.array(x)).asnumpy()
    with mx.cpu(), ag.predict_mode():
        out["p_predict"] = pnet(mx.nd.array(x)).asnumpy()
    out["j_steps"] = _train(jmx, jnet, x, y)
    out["p_steps"] = _train(mx, pnet, x, y)
    out["j_train"], out["p_train"] = out["j_steps"][3], out["p_steps"][3]
    return out


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """One family's runs, made in the fixture's set-up: the reference's
    compiles (its predict forward and its training step) cost most of
    this file's time."""
    return request.param, _family_run(request.param)


def test_family_forward_matches_jax(family):
    name, got = family
    for mode in ("predict", "train"):
        p, j = got["p_" + mode], got["j_" + mode]
        assert p.shape == j.shape == (FAMILIES[name][1][0], CLASSES)
        np.testing.assert_allclose(p, j, rtol=FWD_TOL, atol=FWD_TOL,
                                   err_msg=mode)


def test_family_sgd_steps_match_jax(family):
    name, got = family
    (pl, pw, pg, _), (jl, jw, jg, _) = got["p_steps"], got["j_steps"]
    assert sorted(pg) == sorted(jg)
    for k in jg:
        err = np.linalg.norm(pg[k] - jg[k])
        norm = np.linalg.norm(jg[k])
        assert err <= GRAD_RTOL * norm + GRAD_ATOL, (k, err, norm)
    w0 = got["w0"]
    np.testing.assert_allclose(pl[0], jl[0], rtol=LOSS_RTOL0)
    for a, b in zip(pl[1:], jl[1:]):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)
    assert np.mean(pl[-1]) < np.mean(pl[0])
    assert sorted(pw) == sorted(jw)
    for k in jw:
        err = np.linalg.norm(pw[k] - jw[k])
        upd = np.linalg.norm(jw[k] - w0[k])
        assert err <= UPD_TOL * upd + UPD_ATOL, (k, err, upd)


@pytest.mark.parametrize("train", [False, True], ids=["predict", "train"])
def test_mobilenet_v2_gradients_match_float64_at_their_relu6_gates(train):
    """``chip_smoke.py`` phase 42's reference on the CPU: the port's f32
    gradients of ``mobilenet_v2_0_5`` (128 x 128, batch 4, He's
    initialization from ``mx.random.seed(43)``) against
    ``chip_smoke.mobilenet_v2_plain`` in float64, each ReLU6 passing its
    gradient where the port's run did: loss within MBV2_LOSS_RTOL, each
    gradient within MBV2_RTOL of its norm plus MBV2_ATOL.  Left to its
    own gates float64 differs by each unit that rounding put on the
    other side of a kink (``tools/port_mobilenet_kinks.py``)."""
    smoke = _chip_smoke()
    rng = np.random.RandomState(42)
    x = rng.rand(4, 3, 128, 128).astype(np.float32)
    y = rng.randint(0, CLASSES, 4).astype(np.int32)
    net = vision.mobilenet_v2_0_5(classes=CLASSES)
    with mx.cpu():
        mx.random.seed(43)
        net.initialize(mx.init.Xavier("gaussian", "in", 2))
        with ag.predict_mode():
            net(mx.nd.array(x[:1]))
        w0 = {k: p.data().asnumpy() for k, p in
              net._collect_params_with_prefix().items()}
        gates = smoke.relu6_gates(net)
        with ag.record(train_mode=train):
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                net(mx.nd.array(x)), mx.nd.array(y, dtype="int32")).mean()
        loss.backward()
    got = {k: p.grad().asnumpy() for k, p in
           net._collect_params_with_prefix().items() if p.grad_req != "null"}
    ref_l, ref, _ = smoke.mobilenet_v2_plain(w0, x, y, train, gates)
    assert abs(float(loss.asscalar()) - ref_l) <= MBV2_LOSS_RTOL * ref_l
    assert sorted(got) == sorted(ref)
    for k in ref:
        err, norm = np.linalg.norm(got[k] - ref[k]), np.linalg.norm(ref[k])
        assert err <= MBV2_RTOL * norm + MBV2_ATOL, (k, err, norm)


def _declared(net):
    return {k: tuple(p.shape) for k, p in
            net._collect_params_with_prefix().items()}


def test_every_registered_name_builds_at_full_width_like_the_reference():
    names = sorted(vision._MODELS)
    assert set(names) == set(jvision._MODELS)
    for name in names:
        got = _declared(vision.get_model(name))
        want = _declared(jvision.get_model(name))
        assert got == want, name
    assert len(_declared(vision.get_model("inception-v3"))) == \
        len(_declared(jvision.inception_v3()))


def test_get_model_names_item_11c_for_the_rest():
    """Item 11c is done: every name of the reference's registry is served
    and nothing raises naming it."""
    assert set(vision._MODELS) == set(jvision._MODELS)
    assert not hasattr(vision, "_LATER")
    assert "heatmap_to_coord" not in vision._MODELS
    for name in ("get_fcn", "get_psp", "get_deeplab", "FCN", "PSPNet",
                 "DeepLabV3", "heatmap_to_coord"):
        assert name in vision.__all__ and hasattr(vision, name), name
    for name in ("mobilenet0.25", "SqueezeNet1.1", "mobilenet-v2-1-0",
                 "simple-pose-resnet18-v1b", "Resnet101_v1b"):
        assert vision.get_model(name) is not None
    with pytest.raises(mx.MXNetError, match="not supported"):
        vision.get_model("fcn_resnet50")
    with pytest.raises(mx.NotSupportedError, match="pretrained"):
        vision.get_model("vgg16", pretrained=True)
    with pytest.raises(mx.MXNetError, match="offline"):
        vision.resnext50_32x4d(pretrained=True)


# ----------------------------------------------------------------------
# SSD over a narrow feature block
# ----------------------------------------------------------------------

def _ssd(v):
    base = vision.resnet if v is vision else jvision.resnet
    body = base.ResNetV1(base.BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
                         classes=CLASSES)
    ssd_mod = __import__(v.__name__ + ".ssd", fromlist=["_ResNetFeatures"])
    feats = ssd_mod._ResNetFeatures(body, num_extras=2,
                                    extra_channels=(16, 16))
    net = v.SSD(feats, sizes=[[0.2, 0.27], [0.37, 0.45], [0.54, 0.62],
                              [0.71, 0.79]],
                ratios=[[1, 2, 0.5]] * 4, steps=[-1.0] * 4,
                classes=("a", "b", "c"), nms_topk=50, post_nms=20)
    return net


@pytest.fixture(scope="module")
def ssd_outputs():
    """Both packages' SSD outputs in training mode and their detections
    in predict mode, made in the fixture's set-up (the reference's two
    compiles take most of it)."""
    x, _ = _inputs((2, 3, 64, 64), 5)
    jnet, pnet = _pair(_ssd, x)
    out = {}
    with jag.record():
        out["j_train"] = [a.asnumpy() for a in jnet(jmx.nd.array(x))]
    with mx.cpu(), ag.record():
        out["p_train"] = [a.asnumpy() for a in pnet(mx.nd.array(x))]
    with jag.predict_mode():
        out["j_det"] = [a.asnumpy() for a in jnet(jmx.nd.array(x))]
    with mx.cpu(), ag.predict_mode():
        out["p_det"] = [a.asnumpy() for a in pnet(mx.nd.array(x))]
    return out


def test_ssd_training_outputs_and_detections_match_jax(ssd_outputs):
    got, want = ssd_outputs["p_train"], ssd_outputs["j_train"]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[2].shape[-1] == 4 and got[0].shape[-1] == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=FWD_TOL, atol=FWD_TOL)
    jids, jscores, jboxes = ssd_outputs["j_det"]
    pids, pscores, pboxes = ssd_outputs["p_det"]
    assert pids.shape == jids.shape and pboxes.shape[-1] == 4
    # detections: rows away from ties at the threshold agree exactly in
    # id and in being kept, and within the tolerance in score and box
    kept = jscores[..., 0] > 0
    assert kept.any()
    np.testing.assert_array_equal(pids[kept], jids[kept])
    np.testing.assert_allclose(pscores[kept], jscores[kept], rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(pboxes[kept], jboxes[kept], rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_array_equal(pscores <= 0, jscores <= 0)


def test_ssd_factories_match_the_reference_by_names_and_shapes():
    for name in ("ssd_300_resnet34_v1", "ssd_512_resnet50_v1"):
        net, jnet = vision.get_model(name), jvision.get_model(name)
        assert _declared(net) == _declared(jnet)
        assert net.num_classes == jnet.num_classes == 20
        assert [g.num_depth for g in net.anchor_generators] == \
            [g.num_depth for g in jnet.anchor_generators]
