"""The port's convolution, pooling and normalization ops and their Gluon
layers against the JAX package's, on the CPU.

The same numpy inputs (from ``RandomState``) and the same cotangent go
through the reference's op and the port's, inside each package's
``autograd.record()``; the outputs and the gradients of every input are
compared.  Layers carry their weights across by structural name
(``convert.load_block_weights``).

Tolerances, with their reasons:

- forward, f32: 1e-5 absolute and relative (the same sums in another
  order; values of order 1);
- gradients, f32: 1e-4 absolute and relative (sums over every window
  and channel that reads an element, in another order);
- integer pooling: exact;
- BatchNorm's running statistics after two training steps: 1e-5
  absolute and relative (a mean and a variance over the batch, mixed
  with momentum 0.9).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd, gluon as jgluon

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.convert import block_weights_to_numpy, load_block_weights

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
STAT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rand(rng, shape, kind):
    if kind == "relu":       # many exact zeros: ties in max pooling
        return np.maximum(rng.randn(*shape), 0).astype(np.float32)
    if kind == "int":
        return rng.randint(-20, 20, shape).astype(np.int32)
    if kind == "pos":
        return (rng.rand(*shape) + 0.5).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _run(pkg, op, arrays, kwargs, ct, train_mode=True):
    """(output, gradients of the floating inputs) of ``pkg``'s op."""
    nd = pkg.nd
    rec = (jautograd if pkg is jmx else autograd).record
    with (mx.cpu() if pkg is mx else _Nothing()):
        xs = [nd.array(a, dtype="int32" if a.dtype == np.int32 else None)
              for a in arrays]
        grads = [x for x in xs if x.dtype != np.int32]
        for x in grads:
            x.attach_grad()
        if not grads:
            return getattr(nd, op)(*xs, **kwargs).asnumpy(), []
        with rec(train_mode=train_mode):
            y = getattr(nd, op)(*xs, **kwargs)
        y.backward(nd.array(ct))
    return y.asnumpy(), [x.grad.asnumpy() for x in grads]


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _check_op(op, shapes, kwargs, kinds=None, train_mode=True, seed=0):
    rng = np.random.RandomState(seed)
    kinds = kinds or ["randn"] * len(shapes)
    arrays = [_rand(rng, s, k) for s, k in zip(shapes, kinds)]
    with mx.cpu():
        out_shape = getattr(mx.nd, op)(
            *[mx.nd.array(a, dtype="int32" if a.dtype == np.int32 else None)
              for a in arrays], **kwargs).shape
    ct = rng.randn(*out_shape).astype(np.float32)
    jy, jg = _run(jmx, op, arrays, kwargs, ct, train_mode)
    py, pg = _run(mx, op, arrays, kwargs, ct, train_mode)
    assert py.shape == jy.shape and py.dtype == jy.dtype, (py.dtype, jy.dtype)
    if py.dtype == np.int32:
        np.testing.assert_array_equal(py, jy)
    else:
        np.testing.assert_allclose(py, jy, rtol=FWD_TOL, atol=FWD_TOL)
    assert len(pg) == len(jg)
    for i, (a, b) in enumerate(zip(pg, jg)):
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"gradient of input {i}")
    return py


CONV_CASES = {
    "1d-stride-pad-bias": ([(2, 4, 9), (6, 4, 3), (6,)],
                           dict(kernel=(3,), stride=(2,), pad=(1,),
                                num_filter=6)),
    "2d-groups-dilate": ([(2, 4, 7, 8), (6, 2, 3, 3), (6,)],
                         dict(kernel=(3, 3), stride=(1, 2), dilate=(2, 1),
                              pad=(2, 1), num_filter=6, num_group=2)),
    "2d-7x7-stride2": ([(2, 3, 11, 11), (4, 3, 7, 7)],
                       dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                            num_filter=4, no_bias=True)),
    "3d": ([(1, 2, 5, 5, 4), (4, 2, 3, 2, 2)],
           dict(kernel=(3, 2, 2), pad=(1, 0, 1), num_filter=4,
                no_bias=True)),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_convolution_matches_jax(case):
    shapes, kwargs = CONV_CASES[case]
    _check_op("Convolution", shapes, kwargs)


DECONV_CASES = {
    "2d-stride-adj-bias": ([(2, 4, 5, 4), (4, 3, 3, 3), (3,)],
                           dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                adj=(1, 0), num_filter=3, no_bias=False)),
    "2d-groups-dilate": ([(2, 4, 5, 5), (4, 2, 3, 3)],
                         dict(kernel=(3, 3), stride=(2, 1), dilate=(2, 2),
                              pad=(1, 2), num_filter=4, num_group=2)),
    "2d-target-shape": ([(1, 2, 4, 5), (2, 3, 4, 4)],
                        dict(kernel=(4, 4), stride=(2, 3), pad=(1, 1),
                             target_shape=(9, 15), num_filter=3)),
    # adj at the stride: torch refuses it as an output padding, so the
    # port crops an unpadded result (and zero-fills past its reach)
    "1d-adj-at-stride-bias": ([(2, 3, 5), (3, 2, 3), (2,)],
                              dict(kernel=(3,), stride=(1,), pad=(1,),
                                   adj=(2,), num_filter=2, no_bias=False)),
    "3d": ([(1, 2, 3, 4, 3), (2, 2, 2, 3, 2)],
           dict(kernel=(2, 3, 2), stride=(2, 1, 2), num_filter=2)),
}


@pytest.mark.parametrize("case", list(DECONV_CASES))
def test_deconvolution_matches_jax(case):
    shapes, kwargs = DECONV_CASES[case]
    _check_op("Deconvolution", shapes, kwargs)


def test_deconvolution_unreachable_target_shape_raises_in_both():
    kw = dict(kernel=(3, 3), stride=(2, 2), target_shape=(20, 20),
              num_filter=2)
    x = np.zeros((1, 2, 4, 4), np.float32)
    w = np.zeros((2, 2, 3, 3), np.float32)
    with pytest.raises(jmx.MXNetError, match="unreachable"):
        jmx.nd.Deconvolution(jmx.nd.array(x), jmx.nd.array(w), **kw)
    with mx.cpu(), pytest.raises(mx.MXNetError, match="unreachable"):
        mx.nd.Deconvolution(mx.nd.array(x), mx.nd.array(w), **kw)


POOL_CASES = {
    # ResNet's stem pool over relu output: ties everywhere
    "max-3x3-s2-p1-ties": ((2, 3, 9, 9), "relu",
                           dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    "max-full-ties": ((2, 2, 8, 7), "relu",
                      dict(kernel=(3, 2), stride=(2, 2),
                           pooling_convention="full")),
    "max-1d": ((2, 3, 10), "randn", dict(kernel=(3,), stride=(2,))),
    "max-3d-pad": ((1, 2, 5, 4, 6), "randn",
                   dict(kernel=(2, 2, 3), stride=(2, 1, 2), pad=(1, 0, 1))),
    "avg-full-include-pad": ((2, 2, 7, 8), "randn",
                             dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                  pool_type="avg",
                                  pooling_convention="full")),
    "avg-full-exclude-pad": ((2, 2, 7, 8), "randn",
                             dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                  pool_type="avg", count_include_pad=False,
                                  pooling_convention="full")),
    "avg-1d-exclude-pad": ((2, 2, 9), "randn",
                           dict(kernel=(4,), stride=(3,), pad=(2,),
                                pool_type="avg", count_include_pad=False)),
    "avg-3d": ((1, 2, 4, 6, 5), "randn",
               dict(kernel=(2, 3, 2), stride=(2, 2, 1), pool_type="avg")),
    "sum": ((2, 3, 6, 7), "randn",
            dict(kernel=(2, 3), stride=(1, 2), pad=(1, 1),
                 pool_type="sum")),
    # lp is (sum x^p)^(1/p) with no abs: negatives change the result
    "lp1-negatives": ((2, 2, 6, 6), "randn",
                      dict(kernel=(2, 2), stride=(2, 2), pool_type="lp",
                           p_value=1)),
    "lp2-negatives-full": ((2, 2, 7, 5), "randn",
                           dict(kernel=(3, 2), stride=(2, 2), pad=(1, 0),
                                pool_type="lp", p_value=2,
                                pooling_convention="full")),
    "lp3-positive": ((2, 2, 6, 6), "pos",
                     dict(kernel=(3, 3), stride=(1, 1), pool_type="lp",
                          p_value=3)),
    "sum-int32": ((2, 3, 7, 6), "int",
                  dict(kernel=(3, 2), stride=(2, 2), pad=(1, 1),
                       pool_type="sum", pooling_convention="full")),
    "max-int32": ((2, 3, 7, 6), "int",
                  dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    "avg-int32": ((2, 2, 6, 6), "int",
                  dict(kernel=(2, 2), stride=(2, 2), pool_type="avg")),
    "global-max": ((2, 3, 5, 4), "relu", dict(global_pool=True)),
    "global-avg": ((2, 3, 5, 4), "randn",
                   dict(global_pool=True, pool_type="avg", kernel=(1, 1))),
    "global-sum-3d": ((2, 3, 3, 4, 2), "randn",
                      dict(global_pool=True, pool_type="sum")),
    "global-lp2": ((2, 3, 5, 4), "randn",
                   dict(global_pool=True, pool_type="lp", p_value=2)),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pooling_matches_jax(case):
    shape, kind, kwargs = POOL_CASES[case]
    _check_op("Pooling", [shape], kwargs, [kind])


def test_max_pool_gradient_goes_to_the_first_of_tied_elements():
    """A window of equal values sends its whole gradient to its first
    element in row-major order, in both packages (``jax.grad`` of
    ``reduce_window`` and torch's ``max_pool2d``)."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    ct = np.ones((1, 1, 2, 2), np.float32)
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))
    _, (jg,) = _run(jmx, "Pooling", [x], kw, ct)
    _, (pg,) = _run(mx, "Pooling", [x], kw, ct)
    want = np.zeros((4, 4), np.float32)
    want[:2, :2] = 1.0
    np.testing.assert_array_equal(jg[0, 0], want)
    np.testing.assert_array_equal(pg[0, 0], want)


NORM_CASES = {
    "batchnorm-train": ("BatchNorm", [(4, 3, 5, 5), (3,), (3,), (3,), (3,)],
                        dict(fix_gamma=False, eps=1e-3), True),
    "batchnorm-train-fix-gamma": ("BatchNorm",
                                  [(4, 3, 5), (3,), (3,), (3,), (3,)],
                                  dict(), True),
    "batchnorm-predict": ("BatchNorm", [(4, 3, 5, 5), (3,), (3,), (3,),
                                        (3,)], dict(fix_gamma=False), False),
    "batchnorm-global-stats": ("BatchNorm", [(4, 3, 5, 5), (3,), (3,), (3,),
                                             (3,)],
                               dict(fix_gamma=False, use_global_stats=True),
                               True),
    "batchnorm-axis-2": ("BatchNorm", [(4, 5, 3), (3,), (3,), (3,), (3,)],
                         dict(fix_gamma=False, axis=2), True),
    "instancenorm": ("InstanceNorm", [(2, 3, 5, 6), (3,), (3,)], dict(), True),
    "instancenorm-eps": ("InstanceNorm", [(2, 3, 7), (3,), (3,)],
                         dict(eps=1e-5), True),
    "groupnorm": ("GroupNorm", [(2, 6, 4, 5), (6,), (6,)],
                  dict(num_groups=3), True),
}


@pytest.mark.parametrize("case", list(NORM_CASES))
def test_norm_ops_match_jax(case):
    op, shapes, kwargs, train = NORM_CASES[case]
    kinds = ["randn"] * len(shapes)
    if op == "BatchNorm":
        kinds[-1] = "pos"            # a variance
    _check_op(op, shapes, kwargs, kinds, train_mode=train)


PAD_CASES = {
    "constant": ((2, 3, 4, 5), "randn",
                 dict(mode="constant", pad_width=(0, 0, 0, 0, 1, 2, 3, 0),
                      constant_value=1.5)),
    "edge": ((2, 3, 4, 5), "randn",
             dict(mode="edge", pad_width=(0, 0, 0, 0, 2, 1, 0, 3))),
    "reflect": ((2, 3, 4, 5), "randn",
                dict(mode="reflect", pad_width=(0, 0, 0, 0, 3, 1, 2, 2))),
    "reflect-3d-all-axes": ((2, 3, 4), "randn",
                            dict(mode="reflect",
                                 pad_width=(1, 0, 0, 2, 3, 3))),
    "constant-int32": ((2, 2, 3, 3), "int",
                       dict(mode="constant",
                            pad_width=(0, 0, 1, 0, 1, 1, 0, 2))),
}


@pytest.mark.parametrize("case", list(PAD_CASES))
def test_pad_matches_jax(case):
    shape, kind, kwargs = PAD_CASES[case]
    _check_op("Pad", [shape], kwargs, [kind])
    _check_op("pad", [shape], kwargs, [kind])


@pytest.mark.parametrize("op,shape", [("space_to_depth", (2, 3, 6, 4)),
                                      ("depth_to_space", (2, 12, 3, 2))])
def test_space_depth_shuffles_match_jax(op, shape):
    _check_op(op, [shape], dict(block_size=2))


# ---------------------------------------------------------------------------
# gluon layers
# ---------------------------------------------------------------------------

LAYER_CASES = {
    "conv1d-relu": (lambda nn: nn.Conv1D(5, 3, strides=2, padding=1,
                                         activation="relu"), (2, 4, 9)),
    "conv2d-groups": (lambda nn: nn.Conv2D(6, (3, 2), padding=(1, 0),
                                           dilation=(1, 2), groups=2),
                      (2, 4, 7, 8)),
    "conv3d-no-bias": (lambda nn: nn.Conv3D(3, 2, use_bias=False),
                       (1, 2, 4, 4, 3)),
    "conv1d-transpose": (lambda nn: nn.Conv1DTranspose(
        3, 3, strides=2, padding=1, output_padding=1), (2, 4, 5)),
    "conv2d-transpose-groups": (lambda nn: nn.Conv2DTranspose(
        4, 3, strides=(2, 1), padding=1, output_padding=(1, 0), groups=2),
        (2, 4, 5, 5)),
    "conv3d-transpose": (lambda nn: nn.Conv3DTranspose(2, 2, strides=2),
                         (1, 3, 2, 3, 2)),
    "maxpool2d-ceil": (lambda nn: nn.MaxPool2D(3, 2, ceil_mode=True),
                       (2, 3, 8, 8)),
    "maxpool1d": (lambda nn: nn.MaxPool1D(2), (2, 3, 9)),
    "maxpool3d": (lambda nn: nn.MaxPool3D(2, padding=1), (1, 2, 4, 5, 3)),
    "avgpool2d-exclude-pad": (lambda nn: nn.AvgPool2D(
        3, 2, padding=1, count_include_pad=False), (2, 3, 7, 7)),
    "avgpool1d-ceil": (lambda nn: nn.AvgPool1D(3, 2, ceil_mode=True),
                       (2, 3, 8)),
    "avgpool3d": (lambda nn: nn.AvgPool3D(2), (1, 2, 4, 4, 4)),
    "globalmax1d": (lambda nn: nn.GlobalMaxPool1D(), (2, 3, 7)),
    "globalmax2d": (lambda nn: nn.GlobalMaxPool2D(), (2, 3, 5, 4)),
    "globalmax3d": (lambda nn: nn.GlobalMaxPool3D(), (1, 2, 3, 4, 2)),
    "globalavg1d": (lambda nn: nn.GlobalAvgPool1D(), (2, 3, 7)),
    "globalavg2d": (lambda nn: nn.GlobalAvgPool2D(), (2, 3, 5, 4)),
    "globalavg3d": (lambda nn: nn.GlobalAvgPool3D(), (1, 2, 3, 4, 2)),
    "reflectionpad2d": (lambda nn: nn.ReflectionPad2D(2), (2, 3, 5, 4)),
    "instancenorm-no-scale": (lambda nn: nn.InstanceNorm(scale=False),
                              (2, 3, 5, 4)),
    "groupnorm": (lambda nn: nn.GroupNorm(num_groups=2), (2, 4, 3, 5)),
}


def _layer_grads(pkg, layer, x, ct):
    rec = (jautograd if pkg is jmx else autograd).record
    with (mx.cpu() if pkg is mx else _Nothing()):
        xa = pkg.nd.array(x)
        xa.attach_grad()
        with rec():
            y = layer(xa)
        y.backward(pkg.nd.array(ct))
    params = layer._collect_params_with_prefix()
    return y.asnumpy(), xa.grad.asnumpy(), {
        k: p.grad().asnumpy() for k, p in params.items()
        if p.grad_req != "null"}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layers_match_jax(case):
    make, shape = LAYER_CASES[case]
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    jl = make(jgluon.nn)
    jl.initialize()
    jl(jmx.nd.array(x))
    weights = {k: rng.randn(*p.shape).astype(np.float32) for k, p in
               jl._collect_params_with_prefix().items()}
    for k, p in jl._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(weights[k]))
    pl = make(gluon.nn)
    pl.initialize(ctx=mx.cpu())
    load_block_weights(pl, weights)   # finishes deferred shapes too
    ct = rng.randn(*jl(jmx.nd.array(x)).shape).astype(np.float32)
    jy, jgx, jgp = _layer_grads(jmx, jl, x, ct)
    py, pgx, pgp = _layer_grads(mx, pl, x, ct)
    np.testing.assert_allclose(py, jy, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(pgx, jgx, rtol=GRAD_TOL, atol=GRAD_TOL)
    assert sorted(pgp) == sorted(jgp)
    for k in jgp:
        np.testing.assert_allclose(pgp[k], jgp[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)
    assert repr(pl) == repr(jl)


def test_conv_layers_defer_in_channels_to_the_first_input():
    with mx.cpu():
        conv = gluon.nn.Conv2D(8, 3, groups=2)
        deconv = gluon.nn.Conv2DTranspose(6, 3, groups=3)
        bn = gluon.nn.BatchNorm()
        for layer in (conv, deconv, bn):
            layer.initialize()
        x = mx.nd.array(np.ones((1, 6, 5, 5), np.float32))
        assert conv(x).shape == (1, 8, 3, 3)
        assert deconv(x).shape == (1, 6, 7, 7)
        bn(x)
    assert conv.weight.shape == (8, 3, 3, 3)
    assert deconv.weight.shape == (6, 2, 3, 3)
    assert bn.gamma.shape == bn.running_var.shape == (6,)


def _bn_net(nn):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(momentum=0.8),
            nn.Activation("relu"), nn.BatchNorm(scale=False, center=False),
            nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(3))
    return net


def _bn_train(pkg, net, x, y, steps=2):
    """``steps`` SGD-momentum steps through ``record``/``Trainer``; the
    per-sample losses of each step."""
    g = jgluon if pkg is jmx else gluon
    rec = (jautograd if pkg is jmx else autograd).record
    tr = g.Trainer(net.collect_params(), "sgd",
                   {"learning_rate": 0.1, "momentum": 0.9})
    ce = g.loss.SoftmaxCrossEntropyLoss()
    losses = []
    with (mx.cpu() if pkg is mx else _Nothing()):
        xa, ya = pkg.nd.array(x), pkg.nd.array(y, dtype="int32")
        for _ in range(steps):
            with rec():
                loss = ce(net(xa), ya)
            loss.backward()
            tr.step(x.shape[0])
            losses.append(loss.asnumpy())
    return losses, tr


@pytest.fixture(scope="module")
def bn_trained():
    """A conv, two BatchNorms (one with ``scale=False, center=False``)
    and a dense head, trained two SGD-momentum steps by both packages
    from the same weights."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, 3, 6, 6).astype(np.float32)
    y = rng.randint(0, 3, (4,)).astype(np.int32)
    jnet = _bn_net(jgluon.nn)
    jmx.random.seed(2)
    jnet.initialize()
    jnet(jmx.nd.array(x))
    w0 = {k: p.data().asnumpy() for k, p in
          jnet._collect_params_with_prefix().items()}
    pnet = _bn_net(gluon.nn)
    pnet.initialize(ctx=mx.cpu())
    load_block_weights(pnet, w0)
    jl, _ = _bn_train(jmx, jnet, x, y)
    pl, tr = _bn_train(mx, pnet, x, y)
    jw = {k: p.data().asnumpy() for k, p in
          jnet._collect_params_with_prefix().items()}
    return x, w0, jl, jw, pl, block_weights_to_numpy(pnet), tr, jnet, pnet


def test_batchnorm_running_statistics_after_two_steps_match_jax(bn_trained):
    x, w0, jl, jw, pl, pw, tr, _, _ = bn_trained
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, rtol=FWD_TOL, atol=FWD_TOL)
    stats = [k for k in jw if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 4
    for k in jw:
        np.testing.assert_allclose(pw[k], jw[k], rtol=STAT_TOL,
                                   atol=STAT_TOL, err_msg=k)
    for k in stats:                 # they moved, in MXNet's convention
        assert not np.allclose(pw[k], w0[k]), k
    # the statistics and the frozen gamma/beta stay out of the Trainer's
    # bucket: conv weight and bias, gamma and beta of the first norm,
    # dense weight and bias
    assert tr._flat_param is not None and len(tr._in_buffer) == 6
    assert tr._flat_param.numel() == sum(
        w0[k].size for k in w0 if k not in stats and not k.startswith("3."))


def test_batchnorm_predict_mode_and_global_stats_match_jax(bn_trained):
    x, _, _, _, _, _, _, jnet, pnet = bn_trained
    with mx.cpu():
        px = mx.nd.array(x)
        out = pnet(px).asnumpy()                # outside record: running
        with autograd.record(train_mode=False):
            rec_out = pnet(px).asnumpy()
    want = jnet(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(out, want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(rec_out, want, rtol=FWD_TOL, atol=FWD_TOL)
    # use_global_stats: the running statistics inside record(), training
    rng = np.random.RandomState(3)
    xs = rng.randn(3, 2, 4, 4).astype(np.float32)
    w = {"gamma": rng.rand(2).astype(np.float32) + 0.5,
         "beta": rng.randn(2).astype(np.float32),
         "running_mean": rng.randn(2).astype(np.float32),
         "running_var": rng.rand(2).astype(np.float32) + 0.5}
    jbn = jgluon.nn.BatchNorm(use_global_stats=True, in_channels=2)
    jbn.initialize()
    for k, p in jbn._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(w[k]))
    pbn = gluon.nn.BatchNorm(use_global_stats=True, in_channels=2)
    pbn.initialize(ctx=mx.cpu())
    load_block_weights(pbn, w)
    ct = rng.randn(*xs.shape).astype(np.float32)
    jy, jgx, jgp = _layer_grads(jmx, jbn, xs, ct)
    py, pgx, pgp = _layer_grads(mx, pbn, xs, ct)
    np.testing.assert_allclose(py, jy, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(pgx, jgx, rtol=GRAD_TOL, atol=GRAD_TOL)
    for k in jgp:
        np.testing.assert_allclose(pgp[k], jgp[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)
    for k in ("running_mean", "running_var"):   # not updated
        np.testing.assert_array_equal(
            pbn._collect_params_with_prefix()[k].data().asnumpy(), w[k])


def test_batchnorm_cast_keeps_float32_statistics():
    for pkg, ctx in ((jgluon, None), (gluon, mx.cpu())):
        bn = pkg.nn.BatchNorm(in_channels=3)
        bn.initialize(ctx=ctx)
        for dtype in ("bfloat16", "float16", np.float16):
            bn.cast(dtype)
            for p in bn.collect_params().values():
                assert str(p.data().dtype) == "float32", (pkg, dtype, p.name)
        dense = pkg.nn.Dense(2, in_units=3)
        dense.initialize(ctx=ctx)
        dense.cast("bfloat16")
        assert str(dense.weight.data().dtype) == "bfloat16"
    assert repr(gluon.nn.BatchNorm(in_channels=3)) == \
        repr(jgluon.nn.BatchNorm(in_channels=3))
