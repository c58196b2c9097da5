"""The port's ResNets against the JAX package's, on the CPU.

Nets are initialized by the reference (``Xavier(magnitude=2)``, MXNet's
image-classification setting: with the default ``Uniform(0.07)`` a
BatchNorm after a narrow conv divides by a tiny deviation, and three
steps at lr 0.1 turn rounding noise into different nets; deferred
shapes resolved by one forward) and carried into the port by structural
name
(``convert.load_block_weights``); the same numpy inputs (from
``RandomState``) go through both.  Full-width ResNet-50 training is the
card's (``chip_smoke.py`` phases 14-15): here the nets are
``resnet18_v1(thumbnail=True, classes=10)`` and narrow bottleneck nets
(``[1, 1, 1, 1]`` layers, channels ``[8, 32, 64, 128, 256]``) at 4 x 3 x
64 x 64 (at 2 x 3 x 32 x 32 the last stage's BatchNorms would average
two values each), and ``resnet50_v1()`` is compared by its parameters'
names and shapes.

Tolerances, with their reasons:

- forward, f32, predict and training mode: 1e-5 absolute and relative
  (the same sums in another order; values of order 1);
- three SGD-momentum steps (lr 0.1, momentum 0.9) in f32: losses within
  2e-4 relative (5.1e-5 seen at the third step, whose loss is 0.30),
  parameters and running statistics within 1e-4 absolute and relative
  (5e-6 seen): each step's BatchNorms divide by batch deviations that
  rounding moves by about 1e-6 relative, and lr 0.1 carries that into
  the weights;
- three steps at lr 0.01 under both packages' ``amp.init("bfloat16")``
  (at lr 0.1 the steps turn bf16 rounding into different nets): in bf16
  the gradients of a BatchNorm net this small are mostly rounding noise
  (the reference's bf16 updates differ from its own f32 updates by
  0.66-0.76 of their norm, the port's by 0.53-0.63), so parameters are
  not held one by one, nor the later steps' losses (their gap reached
  0.39 over four seeds).  Held, with what four seeds gave: the first
  step's mean loss within 0.06 of the reference's (0.027; bf16 logits);
  the norm of the port's whole update ``p3 - p0`` within 15% of the
  reference's (6.7%); its distance from the reference's update at most
  1.5 times the reference's own bf16-against-f32 distance (1.05); the
  running statistics within 0.15 absolute and relative (0.084; bf16
  activations, f32 statistics).  The body convs' biases, which feed a
  BatchNorm and take a zero gradient in exact arithmetic, are left out.
  A planted fault (the port at half the learning rate) must miss the
  norm limit (0.49-0.54 seen);
- the space-to-depth stem against the stock 7x7/2 stem from the same
  ``conv0_weight``: 1e-4 absolute and relative (another summation
  order over 147 products);
- ``remat=True`` against the plain forward: bitwise running statistics
  and parameters (the recomputed forward writes no statistics);
- weights and ``save_parameters`` files across the packages: bitwise.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jautograd, gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import amp, autograd, gluon
from mxnet_tpu_torch.convert import block_weights_to_numpy, load_block_weights
from mxnet_tpu_torch.gluon.model_zoo import vision

B, SIZE, CLASSES = 4, 64, 10
NARROW = dict(layers=[1, 1, 1, 1], channels=[8, 32, 64, 128, 256],
              classes=CLASSES)
FWD_TOL = 1e-5
LOSS_RTOL, PARAM_TOL = 2e-4, 1e-4
AMP_LR = 0.01
AMP_LOSS_ATOL, AMP_NORM_TOL, AMP_NOISE_FACTOR, AMP_STAT_TOL = \
    0.06, 0.15, 1.5, 0.15
S2D_TOL = 1e-4
LR = 0.1
RESNET50_PARAMS, RESNET50_TRAINABLE = 299, 25_575_912


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _narrow(pkg_vision, version, **kw):
    block = (pkg_vision.BottleneckV1, pkg_vision.BottleneckV2)[version - 1]
    net = (pkg_vision.ResNetV1, pkg_vision.ResNetV2)[version - 1]
    return net(block, NARROW["layers"], NARROW["channels"],
               classes=CLASSES, **kw)


MODELS = {
    "resnet18_v1-thumbnail": lambda v, **kw: v.resnet18_v1(
        thumbnail=True, classes=CLASSES, **kw),
    "bottleneck-v1": lambda v, **kw: _narrow(v, 1, **kw),
    "bottleneck-v2": lambda v, **kw: _narrow(v, 2, **kw),
}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, 3, SIZE, SIZE).astype(np.float32),
            rng.randint(0, CLASSES, (B,)).astype(np.int32))


def _pair(name, seed=0, **kw):
    """The reference's net, initialized from ``seed``, and the port's with
    its weights; and the weights."""
    jnet = MODELS[name](jvision, **kw)
    jmx.random.seed(seed)
    jnet.initialize(jmx.init.Xavier(magnitude=2))
    jnet(jmx.nd.array(_inputs()[0]))
    weights = {k: p.data().asnumpy() for k, p in
               jnet._collect_params_with_prefix().items()}
    pnet = MODELS[name](vision, **kw)
    pnet.initialize(ctx=mx.cpu())
    load_block_weights(pnet, weights)
    return jnet, pnet, weights


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in MODELS}


@pytest.mark.parametrize("train", [False, True], ids=["predict", "train"])
@pytest.mark.parametrize("name", list(MODELS))
def test_resnet_forward_matches_jax(pairs, name, train):
    jnet, pnet, _ = pairs[name]
    x, _ = _inputs(1)
    with jautograd.record(train_mode=train):
        want = jnet(jmx.nd.array(x)).asnumpy()
    with mx.cpu(), autograd.record(train_mode=train):
        got = pnet(mx.nd.array(x)).asnumpy()
    assert got.shape == want.shape == (B, CLASSES)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def _train(pkg, net, x, y, steps=3, lr=LR):
    """``steps`` SGD-momentum steps through the MXNet loop: per-sample
    losses of each step, the weights after, the Trainer."""
    g = jgluon if pkg is jmx else gluon
    rec = (jautograd if pkg is jmx else autograd).record
    tr = g.Trainer(net.collect_params(), "sgd",
                   {"learning_rate": lr, "momentum": 0.9})
    ce = g.loss.SoftmaxCrossEntropyLoss()
    ctx = mx.cpu() if pkg is mx else jmx.cpu()
    losses = []
    with ctx:
        xa, ya = pkg.nd.array(x), pkg.nd.array(y, dtype="int32")
        for _ in range(steps):
            with rec():
                out = net(xa)
                loss = ce(out, ya)
            loss.backward()
            tr.step(B)
            losses.append(loss.asnumpy().astype(np.float64))
    weights = {k: p.data().asnumpy() for k, p in
               net._collect_params_with_prefix().items()}
    return losses, weights, tr, str(out.dtype)


@pytest.fixture(scope="module")
def f32_trained():
    jnet, pnet, w0 = _pair("bottleneck-v1")
    x, y = _inputs(2)
    jl, jw, _, _ = _train(jmx, jnet, x, y)
    pl, pw, tr, _ = _train(mx, pnet, x, y)
    return w0, jl, jw, pl, pw, tr


def test_resnet_sgd_momentum_training_matches_jax(f32_trained):
    w0, jl, jw, pl, pw, tr = f32_trained
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)
    assert np.mean(pl[-1]) < np.mean(pl[0])
    stats = [k for k in w0 if k.endswith(("running_mean", "running_var"))]
    for k in jw:
        np.testing.assert_allclose(pw[k], jw[k], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=k)
    for k in stats:
        assert not np.array_equal(pw[k], w0[k]), k
    # every trainable parameter in one flat buffer (K1's bucket on the
    # card), the running statistics outside it
    trainable = [k for k in w0 if k not in stats]
    assert len(tr._in_buffer) == len(trainable)
    assert tr._flat_param.numel() == sum(w0[k].size for k in trainable)


def _port_from(name, weights):
    net = MODELS[name](vision)
    net.initialize(ctx=mx.cpu())
    load_block_weights(net, weights)
    return net


def _jax_from(name, weights):
    net = MODELS[name](jvision)
    net.initialize()
    net(jmx.nd.array(_inputs()[0]))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(weights[k]))
    return net


@pytest.fixture(scope="module")
def amp_trained():
    """From the same weights: the reference trains the narrow bottleneck
    net 3 SGD-momentum steps (lr ``AMP_LR``) in f32 and under
    ``amp.init("bfloat16")``, and the port under it, and again at half
    the learning rate (a planted fault); the policies are undone
    whatever happens."""
    _, _, w0 = _pair("bottleneck-v1")
    x, y = _inputs(3)
    _, jf32, _, _ = _train(jmx, _jax_from("bottleneck-v1", w0), x, y,
                           lr=AMP_LR)
    jamp.init("bfloat16")
    amp.init("bfloat16")
    try:
        jl, jw, _, jdt = _train(jmx, _jax_from("bottleneck-v1", w0), x, y,
                                lr=AMP_LR)
        pnet = _port_from("bottleneck-v1", w0)
        pl, pw, _, pdt = _train(mx, pnet, x, y, lr=AMP_LR)
        seen = {}
        pnet.features[1].register_forward_hook(
            lambda blk, args, out: seen.setdefault("bn", str(out.dtype)))
        with mx.cpu(), autograd.record():
            pnet(mx.nd.array(x))
        hl, hw, _, _ = _train(mx, _port_from("bottleneck-v1", w0), x, y,
                              lr=AMP_LR / 2)
    finally:
        jamp._deinit_for_tests()
        amp._deinit_for_tests()
    return w0, jf32, (jl, jw), (pl, pw), (hl, hw), (jdt, pdt, seen["bn"])


def _amp_measures(w0, keys, losses, w, ref_losses, ref, ref_f32):
    """(gap of the first step's mean loss, |update| / |reference's
    update|, the update's error against the reference's relative to
    the reference's own bf16-against-f32 error)."""
    gap = abs(float(np.mean(losses[0])) - float(np.mean(ref_losses[0])))

    def flat(ws):
        return np.concatenate([(ws[k] - w0[k]).ravel() for k in keys])
    du, dref, df32 = flat(w), flat(ref), flat(ref_f32)
    norm = float(np.linalg.norm(du) / np.linalg.norm(dref))
    err = float(np.linalg.norm(du - dref) / np.linalg.norm(dref))
    noise = float(np.linalg.norm(dref - df32) / np.linalg.norm(df32))
    return gap, norm, err / noise


def test_resnet_amp_training_matches_jax(amp_trained):
    w0, jf32, (jl, jw), (pl, pw), (hl, hw), dtypes = amp_trained
    # bf16 logits from the bf16 Dense, as the reference's; the stem's
    # BatchNorm keeps its bf16 input's dtype
    assert dtypes == ("bfloat16", "bfloat16", "bfloat16")
    stats = [k for k in w0 if k.endswith(("running_mean", "running_var"))]
    for k in stats:
        assert pw[k].dtype == np.float32
        np.testing.assert_allclose(pw[k], jw[k], rtol=AMP_STAT_TOL,
                                   atol=AMP_STAT_TOL, err_msg=k)
    # the body convs' biases feed a BatchNorm: their gradient is zero in
    # exact arithmetic, their updates rounding noise
    keys = [k for k in w0 if k not in stats and not (
        k.endswith("bias") and ".body." in k)]
    gap, norm, rel = _amp_measures(w0, keys, pl, pw, jl, jw, jf32)
    assert gap <= AMP_LOSS_ATOL and abs(norm - 1) <= AMP_NORM_TOL and \
        rel <= AMP_NOISE_FACTOR, (gap, norm, rel)
    gap, norm, rel = _amp_measures(w0, keys, hl, hw, jl, jw, jf32)
    assert abs(norm - 1) > AMP_NORM_TOL, (gap, norm, rel)


@pytest.mark.parametrize("size", [32, 33, (31, 34)], ids=["even", "odd",
                                                         "mixed"])
def test_space_to_depth_stem_equals_the_stock_stem(size):
    h, w = size if isinstance(size, tuple) else (size, size)
    rng = np.random.RandomState(4)
    x = rng.rand(B, 3, h, w).astype(np.float32)
    with mx.cpu():
        stock = _narrow(vision, 1)
        s2d = _narrow(vision, 1, s2d_stem=True)
        stock.initialize()
        s2d.initialize()
        xa = mx.nd.array(x)
        stock(xa)
        weights = block_weights_to_numpy(stock)
        load_block_weights(s2d, weights)      # the same conv0_weight
        for train in (False, True):
            with autograd.record(train_mode=train):
                a = stock(xa).asnumpy()
                b = s2d(xa).asnumpy()
            np.testing.assert_allclose(b, a, rtol=S2D_TOL, atol=S2D_TOL)
        stem_a = stock.features[0](xa).asnumpy()
        stem_b = s2d.features[0](xa).asnumpy()
    np.testing.assert_allclose(stem_b, stem_a, rtol=S2D_TOL, atol=S2D_TOL)
    assert s2d.features[0].weight.shape == (8, 3, 7, 7)


def test_space_to_depth_stem_loads_a_stock_checkpoint(tmp_path):
    x, _ = _inputs(5)
    f = os.fspath(tmp_path / "stock.params")
    with mx.cpu():
        stock = _narrow(vision, 1)
        stock.initialize()
        want = stock(mx.nd.array(x)).asnumpy()
        stock.save_parameters(f)
        s2d = _narrow(vision, 1, s2d_stem=True)
        s2d.load_parameters(f, ctx=mx.cpu())
        got = s2d(mx.nd.array(x)).asnumpy()
        np.testing.assert_allclose(got, want, rtol=S2D_TOL, atol=S2D_TOL)
        wrong = _narrow(vision, 1, s2d_stem=True, stem_in_channels=4)
        wrong.initialize()
        with pytest.raises(mx.MXNetError, match="in_channels=4"):
            wrong(mx.nd.array(x))


@pytest.fixture(scope="module")
def resnet50_names():
    """resnet50_v1()'s parameters by structural name in both packages
    (shapes from one forward at 1 x 3 x 32 x 32)."""
    x = np.zeros((1, 3, 32, 32), np.float32)
    jnet = jvision.resnet50_v1()
    jnet.initialize()
    jnet(jmx.nd.array(x))
    with mx.cpu():
        pnet = vision.resnet50_v1()
        pnet.initialize()
        pnet(mx.nd.array(x))

    def table(net):
        return {k: (tuple(p.shape), p.grad_req) for k, p in
                net._collect_params_with_prefix().items()}
    return table(jnet), table(pnet)


def test_resnet50_v1_has_the_reference_parameters(resnet50_names):
    want, got = resnet50_names
    assert list(got) == list(want)
    assert got == want
    assert len(got) == RESNET50_PARAMS
    trainable = sum(int(np.prod(s)) for s, req in got.values()
                    if req != "null")
    assert trainable == RESNET50_TRAINABLE
    # the bottleneck's two 1x1 body convs keep their biases
    assert got["features.5.0.body.0.bias"] == ((128,), "write")


def test_resnet_weights_and_files_cross_both_ways(tmp_path):
    jnet, pnet, weights = _pair("bottleneck-v2")
    back = block_weights_to_numpy(pnet)
    assert sorted(back) == sorted(weights)
    for k in weights:
        assert np.array_equal(back[k], weights[k]), k
    x, _ = _inputs(6)
    want = jnet(jmx.nd.array(x)).asnumpy()
    jfile = os.fspath(tmp_path / "jax.params")
    pfile = os.fspath(tmp_path / "port.params")
    jnet.save_parameters(jfile)
    with mx.cpu():
        net = MODELS["bottleneck-v2"](vision)
        net.load_parameters(jfile, ctx=mx.cpu())
        np.testing.assert_allclose(net(mx.nd.array(x)).asnumpy(), want,
                                   rtol=FWD_TOL, atol=FWD_TOL)
        net.save_parameters(pfile)
    jback = MODELS["bottleneck-v2"](jvision)
    jback.load_parameters(pfile)
    got = {k: p.data().asnumpy() for k, p in
           jback._collect_params_with_prefix().items()}
    for k in weights:
        assert np.array_equal(got[k], weights[k]), k


def test_remat_writes_the_running_statistics_once():
    x, y = _inputs(7)
    runs = []
    for remat in (False, True):
        with mx.cpu():
            net = _narrow(vision, 1)
            net.initialize()
            mx.random.seed(0)
            net(mx.nd.array(x))
            if not runs:
                w0 = block_weights_to_numpy(net)
            load_block_weights(net, w0)
        calls = []
        stage = net.features[4]            # stage 1: conv, BN, conv, ...
        stage[0].body[1].register_forward_hook(lambda *a: calls.append(1))
        if remat:
            stage.hybridize(remat=True)
        _, w, _, _ = _train(mx, net, x, y, steps=2)
        runs.append((w, len(calls)))
    (plain, n_plain), (remat, n_remat) = runs
    assert n_plain == 2 and n_remat == 4     # recomputed in each backward
    for k in plain:
        np.testing.assert_array_equal(remat[k], plain[k], err_msg=k)


def test_resnet50_initialize_needs_a_card_or_the_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(mx.MXNetError):
            vision.resnet50_v1().initialize()
    net = vision.resnet50_v1()
    net.initialize(ctx=mx.cpu())
    head0 = net.output.weight.data().asnumpy()    # in_units given: no wait
    x, y = _inputs(8)
    losses, w, tr, _ = _train(mx, net, x, y, steps=1)
    assert np.all(np.isfinite(losses[0]))
    assert not np.array_equal(w["output.weight"], head0)
    assert tr._flat_param.numel() == RESNET50_TRAINABLE
    assert tr._flat_param.device.type == "cpu"


def test_get_model_serves_the_resnets_and_names_the_rest():
    for name in ("resnet18_v1", "ResNet50_v2", "resnet152-v1"):
        net = vision.get_model(name, classes=7)
        assert type(net).__name__ == ("ResNetV2" if "v2" in name.lower()
                                      else "ResNetV1")
    for name in ("vgg16", "mobilenet1.0", "densenet121"):
        with pytest.raises(mx.NotSupportedError, match="item 11"):
            vision.get_model(name)
    with pytest.raises(mx.MXNetError, match="not supported"):
        vision.get_model("resnet19_v1")
    with pytest.raises(mx.NotSupportedError, match="pretrained"):
        vision.get_model("resnet50_v1", pretrained=True)
    with pytest.raises(mx.MXNetError, match="offline"):
        vision.resnet18_v1(pretrained=True)
    assert sorted(vision._MODELS) == sorted(
        n for n in jvision.resnet.__all__
        if n[0].islower() and not n.startswith("get_"))
    assert vision._LATER == set(jvision._MODELS) - set(vision._MODELS)



def _chip_smoke():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_update_errs_holds_the_update_net_of_storage_rounding():
    """``chip_smoke.update_errs`` (phases 12, 14 and 16): a gamma near 1
    whose two-step update is some tens of ulps, stored one ulp apart in
    one element by two runs that added the same update, agrees (the
    unreduced statistic puts it above phase 14's 1e-3); the same
    parameters after a 0.2% error in the learning rate do not."""
    smoke = _chip_smoke()
    rng = np.random.RandomState(14)
    w0 = {"gamma": (1 + rng.uniform(-0.01, 0.01, 64)).astype(np.float32),
          "weight": rng.normal(0, 0.02, 4096).astype(np.float32)}
    du = {"gamma": rng.normal(0, 5e-6, 64),
          "weight": rng.normal(0, 1e-3, 4096)}

    def stored(scale):
        return {k: (w0[k].astype(np.float64) + scale * du[k])
                .astype(np.float32) for k in w0}

    want = stored(1.0)
    got = {k: v.copy() for k, v in want.items()}
    got["gamma"][3] = np.nextafter(got["gamma"][3], np.float32(2))
    raw = float(np.linalg.norm(got["gamma"] - want["gamma"]) /
                np.linalg.norm(want["gamma"] - w0["gamma"]))
    assert raw > smoke.RESNET_UPDATE_RTOL
    errs = smoke.update_errs(w0, got, want, 2)
    assert errs == {"gamma": 0.0, "weight": 0.0}
    errs = smoke.update_errs(w0, stored(1.002), want, 2)
    assert 1.9e-3 < errs["weight"] < 2.1e-3
    assert max(errs.values()) > smoke.RESNET_UPDATE_RTOL
    assert smoke.update_errs(w0, got, want, 2, skip=("gamma",)).keys() \
        == {"weight"}
