"""The port's Gluon core against ``mxnet_tpu.gluon``, on the CPU:
``Parameter``/``ParameterDict``, ``Block``/``HybridBlock``, the layers of
``gluon.nn``, the initializers, the metrics, and the Trainer's
``grad_req`` and multipliers.

Blocks are built with explicit ``prefix=`` in both packages, so the
process-wide naming counters of either do not matter.  Weights are
carried from the reference by structural name
(``convert.load_block_weights``).  Tolerances: layer outputs and
gradients 1e-5 (f32 products in another order); trained parameters
1e-6 absolute (one or two SGD steps at lr 0.1); ``Constant``/``Zero``/
``One`` bitwise; ``Uniform``/``Normal``/``Xavier`` by their bounds and
moments (the draws come from another generator); metrics 1e-12 (the
same numpy arithmetic).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgluon
from mxnet_tpu import initializer as jinit, metric as jmetric

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag, gluon, initializer as init
from mxnet_tpu_torch import metric
from mxnet_tpu_torch.convert import load_block_weights
from mxnet_tpu_torch.gluon import nn

TOL = 1e-5
RNG = np.random.RandomState(0)
X = RNG.randn(2, 3, 4).astype(np.float32)


def _port(a, dtype=None):
    with mx.cpu():
        return mx.nd.array(a, dtype=dtype)


# ----------------------------------------------------------------------
# parameters and names
# ----------------------------------------------------------------------

def _mlp(pkg):
    net = pkg.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.nn.Dense(5, activation="relu"), pkg.nn.Dropout(0.1),
                pkg.nn.Dense(3, in_units=5, use_bias=False))
        net.add(pkg.nn.LayerNorm())
    return net


def test_names_prefixes_and_collect_params_match_jax():
    pnet, jnet = _mlp(gluon), _mlp(jgluon)
    assert list(pnet.collect_params()) == list(jnet.collect_params())
    assert list(pnet.collect_params()) == [
        "mlp_dense0_weight", "mlp_dense0_bias", "mlp_dense1_weight",
        "mlp_layernorm0_gamma", "mlp_layernorm0_beta"]
    for sel in (".*weight", "mlp_dense0_.*", ".*(gamma|beta)$"):
        assert list(pnet.collect_params(sel)) == \
            list(jnet.collect_params(sel))
    assert sorted(pnet._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix()) == [
            "0.bias", "0.weight", "2.weight", "3.beta", "3.gamma"]
    assert pnet.prefix == "mlp_" and pnet.name == "mlp"
    assert pnet[0].name == "mlp_dense0" and len(pnet) == 4
    assert isinstance(pnet[1:3], nn.HybridSequential)


def test_parameter_dict_get_update_and_shared():
    pd = gluon.ParameterDict("blk_")
    w = pd.get("w", shape=(2, 3), init="ones")
    assert w.name == "blk_w" and pd.get("w") is w and "blk_w" in pd
    with pytest.raises(mx.MXNetError):
        pd.get("w", shape=(4, 3))
    c = pd.get_constant("c", np.arange(3, dtype=np.float32))
    shared = gluon.ParameterDict("blk_", shared=pd)
    assert shared.get("w") is w
    other = gluon.ParameterDict("x_")
    other.get("w", shape=(1,))
    with pytest.raises(mx.MXNetError, match="duplicate"):
        pd.update({"blk_w": other["x_w"]})
    pd.initialize(ctx=mx.cpu())
    np.testing.assert_array_equal(w.data().asnumpy(), np.ones((2, 3)))
    np.testing.assert_array_equal(c.data().asnumpy(), np.arange(3))
    assert c.grad_req == "null"
    with pytest.raises(mx.MXNetError, match="grad_req='null'"):
        c.grad()
    pd.setattr("lr_mult", 0.5)
    assert w.lr_mult == 0.5


def test_deferred_initialization():
    for pkg, arr in ((gluon, _port), (jgluon, jmx.nd.array)):
        d = pkg.nn.Dense(4, prefix="d_")
        if pkg is gluon:
            d.initialize(ctx=mx.cpu())
        else:
            d.initialize()
        assert d.weight.shape == (4, 0)
        with pytest.raises(Exception, match="deferred"):
            d.weight.data()
        out = d(arr(X))                 # flatten: in_units = 3 * 4
        assert out.shape == (2, 4) and d.weight.shape == (4, 12)
    p = gluon.Parameter("p", shape=(0, 3))
    with pytest.raises(mx.MXNetError, match="deferred init is not"):
        p.initialize(ctx=mx.cpu())
    p = gluon.Parameter("p", shape=(0, 3), allow_deferred_init=True)
    p.initialize(ctx=mx.cpu())
    with pytest.raises(gluon.DeferredInitializationError):
        p.data()
    p.shape_updated((5, 3))
    p._finish_deferred_init()
    assert p.data().shape == (5, 3) and p.list_ctx() == [mx.cpu()]
    p.set_data(np.ones((5, 3), np.float32))
    np.testing.assert_array_equal(p.data().asnumpy(), np.ones((5, 3)))
    with pytest.raises(mx.MXNetError, match="set_data shape"):
        p.set_data(np.ones((2, 3), np.float32))


def test_parameter_cast_reset_ctx_and_sparse_refusal():
    p = gluon.Parameter("w", shape=(2, 2), init="ones")
    p.initialize(ctx=mx.cpu())
    p.cast("bfloat16")
    assert p.data().dtype == "bfloat16" and p.data().data.requires_grad
    p.reset_ctx(mx.cpu())
    assert p.list_ctx() == [mx.cpu()]
    with pytest.raises(mx.NotSupportedError, match="item 8"):
        gluon.Parameter("s", shape=(2,), stype="row_sparse")
    with pytest.raises(mx.NotSupportedError, match="item 8"):
        nn.Embedding(4, 2, sparse_grad=True)
    with pytest.raises(mx.NotSupportedError, match="item 11"):
        nn.HybridSequential(prefix="e_").export("x")
    with pytest.raises(mx.NotSupportedError, match="item 11"):
        gluon.SymbolBlock()


def test_parameter_data_follows_the_trainer_flat_buffer():
    """An NDArray taken from ``data()`` before the Trainer builds its flat
    buffer sees the buffer after it, and the updates in it."""
    net = _mlp(gluon)
    net.initialize(ctx=mx.cpu())
    x = _port(X[0])
    net(x)
    before = {k: p.data() for k, p in net.collect_params().items()}
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    with ag.record():
        (net(x) ** 2).sum().backward()
    tr.step(1)
    buf = tr._flat_param
    for k, p in net.collect_params().items():
        t = before[k].data
        assert buf.data_ptr() <= t.data_ptr() < buf.data_ptr() + \
            4 * buf.numel(), k
        assert p.data().data is t
    w = net[0].weight
    w.set_data(np.zeros(w.shape, np.float32))       # in place: still there
    assert not before["mlp_dense0_weight"].asnumpy().any()
    with ag.record():
        (net(x) ** 2).sum().backward()
    tr.step(1)                                       # the buffer holds


# ----------------------------------------------------------------------
# layers against the reference, on carried weights
# ----------------------------------------------------------------------

LAYERS = {
    "Dense": (lambda nn_: nn_.Dense(5, prefix="l_"), X),
    "Dense-act-noflat": (lambda nn_: nn_.Dense(5, activation="tanh",
                                               flatten=False, prefix="l_"),
                         X),
    "Dropout": (lambda nn_: nn_.Dropout(0.3, prefix="l_"), X),
    "LayerNorm": (lambda nn_: nn_.LayerNorm(epsilon=1e-12, prefix="l_"), X),
    "LayerNorm-axis1": (lambda nn_: nn_.LayerNorm(axis=1, prefix="l_"), X),
    "Embedding": (lambda nn_: nn_.Embedding(6, 4, prefix="l_"),
                  np.array([[0, 5, 2], [1, 1, 3]], np.int32)),
    "Flatten": (lambda nn_: nn_.Flatten(prefix="l_"), X),
    "Activation": (lambda nn_: nn_.Activation("sigmoid", prefix="l_"), X),
    "LeakyReLU": (lambda nn_: nn_.LeakyReLU(0.2, prefix="l_"), X),
    "PReLU": (lambda nn_: nn_.PReLU(in_channels=3, prefix="l_"), X),
    "ELU": (lambda nn_: nn_.ELU(0.5, prefix="l_"), X),
    "SELU": (lambda nn_: nn_.SELU(prefix="l_"), X),
    "GELU": (lambda nn_: nn_.GELU(prefix="l_"), X),
    "Swish": (lambda nn_: nn_.Swish(2.0, prefix="l_"), X),
    "Identity": (lambda nn_: nn_.Identity(prefix="l_"), X),
    "HybridLambda": (lambda nn_: nn_.HybridLambda(
        lambda F, x: F.relu(x) * 2, prefix="l_"), X),
    "HybridLambda-name": (lambda nn_: nn_.HybridLambda("tanh", prefix="l_"),
                          X),
    "Lambda": (lambda nn_: nn_.Lambda(lambda x: x * 3 + 1, prefix="l_"), X),
    "HybridConcatenate": (lambda nn_: _concat(nn_.HybridConcatenate), X),
    "Concatenate": (lambda nn_: _concat(nn_.Concatenate), X),
    "Sequential": (lambda nn_: _seq(nn_.Sequential), X),
    "HybridSequential": (lambda nn_: _seq(nn_.HybridSequential), X),
}


def _concat(cls):
    blk = cls(axis=-1, prefix="l_")
    with blk.name_scope():
        blk.add(blk_dense(cls, 2), blk_dense(cls, 3))
    return blk


def blk_dense(cls, units):
    nn_ = nn if cls.__module__.startswith("mxnet_tpu_torch") else jgluon.nn
    return nn_.Dense(units, flatten=False)


def _seq(cls):
    nn_ = nn if cls.__module__.startswith("mxnet_tpu_torch") else jgluon.nn
    blk = cls(prefix="l_")
    with blk.name_scope():
        blk.add(nn_.Dense(6, flatten=False), nn_.GELU(),
                nn_.LayerNorm(), nn_.Dense(2))
    return blk


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    make, x = LAYERS[name]
    dtype = "int32" if x.dtype == np.int32 else None
    jblk = make(jgluon.nn)
    jblk.initialize(init=jinit.Normal(0.5))
    jx = jmx.nd.array(x, dtype=dtype)
    jblk(jx)                                         # deferred shapes
    weights = {k: p.data().asnumpy() for k, p in
               jblk._collect_params_with_prefix().items()}
    pblk = make(nn)
    pblk.initialize(ctx=mx.cpu())
    load_block_weights(pblk, weights)
    px = _port(x, dtype)
    if dtype is None:
        jx.attach_grad()
        px.attach_grad()
    outs = []
    for pkg, blk, xx in ((ag, pblk, px), (jag, jblk, jx)):
        # Dropout in predict mode: the draws come from other generators
        with pkg.record(train_mode=name != "Dropout"):
            y = blk(xx)
            loss = (y * y).sum()
        loss.backward()
        grads = {k: p.grad().asnumpy() for k, p in
                 blk._collect_params_with_prefix().items()}
        outs.append((y.asnumpy(), None if dtype else xx.grad.asnumpy(),
                     grads))
    (py, pgx, pg), (jy, jgx, jg) = outs
    np.testing.assert_allclose(py, jy, rtol=TOL, atol=TOL)
    if pgx is not None:
        np.testing.assert_allclose(pgx, jgx, rtol=TOL, atol=TOL)
    assert sorted(pg) == sorted(jg)
    for k in pg:
        np.testing.assert_allclose(pg[k], jg[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_hybridize_gives_the_outputs_of_eager_and_hooks_run():
    net = _seq(nn.HybridSequential)
    net.initialize(ctx=mx.cpu())
    x = _port(X)
    eager = net(x).asnumpy()
    seen = []
    net.register_forward_pre_hook(lambda blk, args: seen.append("pre"))
    net.register_forward_hook(lambda blk, args, out: seen.append(out.shape))
    net.hybridize(static_alloc=True, static_shape=True)
    assert net._active and net._flags["static_alloc"]
    np.testing.assert_array_equal(net(x).asnumpy(), eager)
    assert seen == ["pre", (2, 2)]
    names = []
    net.apply(lambda b: names.append(type(b).__name__))
    assert names[-1] == "HybridSequential" and names.count("Dense") == 2
    assert "HybridSequential" in repr(net)


def test_summary_and_save_load_parameters(tmp_path, capsys):
    net = _seq(nn.HybridSequential)
    net.initialize(ctx=mx.cpu())
    x = _port(X)
    net.summary(x)
    assert "parameters" in capsys.readouterr().out
    path = str(tmp_path / "seq.params")
    net.save_parameters(path)
    twin = _seq(nn.HybridSequential)
    twin.initialize(ctx=mx.cpu())
    twin.load_parameters(path)
    np.testing.assert_array_equal(twin(x).asnumpy(), net(x).asnumpy())
    with pytest.raises(mx.MXNetError, match="not present"):
        _mlp(gluon).load_parameters(path, ctx=mx.cpu())
    jtwin = _seq(jgluon.nn.HybridSequential)
    jtwin.load_parameters(path)
    np.testing.assert_allclose(jtwin(jmx.nd.array(X)).asnumpy(),
                               net(x).asnumpy(), rtol=TOL, atol=TOL)
    pd_path = str(tmp_path / "pd.params")
    net.collect_params().save(pd_path, strip_prefix="l_")
    other = _seq(nn.HybridSequential)
    other.initialize(ctx=mx.cpu())
    other(x)
    other.collect_params().load(pd_path, restore_prefix="l_")
    np.testing.assert_array_equal(other(x).asnumpy(), net(x).asnumpy())


# ----------------------------------------------------------------------
# the Trainer: grad_req and multipliers against the reference's
# ----------------------------------------------------------------------

def _trainer_run(pkg, reqs, mults, steps=2):
    """Three Dense layers (weights from seed 3), each with its grad_req
    and (lr_mult, wd_mult), trained by SGD-momentum with wd; two backward
    passes before each step.  The layers' parameters after ``steps``."""
    nn_ = pkg.nn
    net = nn_.HybridSequential(prefix="t_")
    with net.name_scope():
        for units in (4, 3, 2):
            net.add(nn_.Dense(units, flatten=False))
    arr = _port if pkg is gluon else jmx.nd.array
    rng = np.random.RandomState(3)
    weights = {}
    for i, units in enumerate((4, 3, 2)):
        weights[f"{i}.weight"] = rng.randn(units, 4 if i == 0 else
                                           (4, 3)[i - 1]).astype(np.float32)
        weights[f"{i}.bias"] = rng.randn(units).astype(np.float32)
    if pkg is gluon:
        net.initialize(ctx=mx.cpu())
        load_block_weights(net, weights)
    else:
        net.initialize()
        net(arr(X))
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(jmx.nd.array(weights[k]))
    for i, (req, (lm, wm)) in enumerate(zip(reqs, mults)):
        for p in net[i].collect_params().values():
            p.grad_req = req
            p.lr_mult, p.wd_mult = lm, wm
    tr = pkg.Trainer(net.collect_params(), "sgd",
                     {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01})
    ag_ = ag if pkg is gluon else jag
    x = arr(X)
    for _ in range(steps):
        for scale in (1.0, 0.5):
            with ag_.record():
                loss = (net(x) * scale).sum()
            loss.backward()
        tr.step(2)
    return {k: p.data().asnumpy() for k, p in
            net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("reqs,mults", [
    (("write", "write", "write"), ((1, 1), (1, 1), (1, 1))),
    (("write", "add", "null"), ((1, 1), (1, 1), (1, 1))),
    (("add", "write", "write"), ((2.0, 1), (1, 0.0), (0.5, 3.0)))],
    ids=["write", "write-add-null", "add-multipliers"])
def test_grad_req_and_multipliers_match_jax_trainer(reqs, mults):
    got = _trainer_run(gluon, reqs, mults)
    want = _trainer_run(jgluon, reqs, mults)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    w0 = _trainer_run(gluon, reqs, mults, steps=0)
    for i, req in enumerate(reqs):
        moved = not np.array_equal(got[f"{i}.weight"], w0[f"{i}.weight"])
        assert moved == (req != "null")


def test_trainer_refuses_what_the_reference_refuses():
    net = _mlp(gluon)
    net.initialize(ctx=mx.cpu())
    net(_port(X[0]))
    tr = gluon.Trainer(net.collect_params(), "adam")
    assert tr.optimizer.param_dict[0] is \
        net.collect_params()[sorted(net.collect_params().keys())[0]]
    with pytest.raises(mx.MXNetError, match="has not been computed"):
        tr.step(1)
    with pytest.raises(mx.MXNetError):
        gluon.Trainer([net[0].weight, torch.nn.Parameter(torch.ones(1))],
                      "sgd")
    opt = mx.optimizer.SGD(learning_rate=0.5)
    opt.set_lr_mult({0: 0.1})
    opt.set_wd_mult({0: 2.0})
    opt.wd = 0.25
    assert opt._get_lr(0) == pytest.approx(0.05) and opt._get_lr(1) == 0.5
    assert opt._get_wd(0) == 0.5


# ----------------------------------------------------------------------
# initializers
# ----------------------------------------------------------------------

def _filled(initializer, shape, name="w_weight"):
    arr = mx.nd.zeros(shape, ctx=mx.cpu())
    initializer(init.InitDesc(name), arr)
    return arr.asnumpy()


def _jfilled(initializer, shape, name="w_weight"):
    arr = jmx.nd.zeros(shape)
    initializer(jinit.InitDesc(name), arr)
    return arr.asnumpy()


@pytest.mark.parametrize("name,kw", [("Constant", {"value": 0.37}),
                                     ("Zero", {}), ("One", {})])
def test_constant_initializers_bitwise(name, kw):
    got = _filled(getattr(init, name)(**kw), (3, 5))
    want = _jfilled(getattr(jinit, name)(**kw), (3, 5))
    np.testing.assert_array_equal(got, want)
    # by registry name, and the suffix rules of the base class
    for alias in ("zeros", "ones", "constant"):
        assert type(init.create(alias)).__name__ == \
            type(jinit.create(alias)).__name__
    for suffix, want_v in (("bias", 0.0), ("gamma", 1.0), ("beta", 0.0),
                           ("running_var", 1.0)):
        assert (_filled(init.Uniform(), (4,), "x_" + suffix) == want_v).all()


def test_random_initializers_by_bounds_and_moments():
    mx.random.seed(1)
    shape = (256, 128)
    u = _filled(init.Uniform(0.2), shape)
    assert u.min() >= -0.2 and u.max() <= 0.2
    assert abs(u.mean()) < 5e-3 and abs(u.std() - 0.2 / np.sqrt(3)) < 2e-3
    n = _filled(init.Normal(0.05), shape)
    assert abs(n.mean()) < 1e-3 and abs(n.std() - 0.05) < 1e-3
    scale = np.sqrt(3.0 / ((256 + 128) / 2))
    xv = _filled(init.Xavier(), shape)
    assert np.abs(xv).max() <= scale and abs(xv.std() - scale /
                                             np.sqrt(3)) < 2e-3
    jxv = _jfilled(jinit.Xavier(), shape)
    assert np.abs(jxv).max() <= scale
    g = _filled(init.Xavier(rnd_type="gaussian", factor_type="in",
                            magnitude=2), shape)
    assert abs(g.std() - np.sqrt(2.0 / 128)) < 2e-3
    k = _filled(init.MSRAPrelu(slope=0.0), shape)
    assert abs(k.std() - np.sqrt(2.0 / 192)) < 2e-3
    mixed = init.Mixed(["a_.*", ".*"], [init.One(), init.Constant(3)])
    assert (_filled(mixed, (2,), "a_weight") == 1).all()
    assert (_filled(mixed, (2,), "b_weight") == 3).all()
    assert (_filled(mixed, (2,), "b_bias") == 0).all()    # by its suffix
    mx.random.seed(1)
    assert np.array_equal(_filled(init.Uniform(0.2), shape), u)  # seeded


# ----------------------------------------------------------------------
# metrics: the same numpy arithmetic as the reference's
# ----------------------------------------------------------------------

PRED = RNG.rand(6, 4).astype(np.float32)
PRED /= PRED.sum(1, keepdims=True)
LABEL = np.array([0, 3, 1, 1, 2, 0], np.float32)
REG_P = RNG.randn(6).astype(np.float32)
REG_L = RNG.randn(6).astype(np.float32)

METRICS = {
    "acc": ((), (LABEL, PRED)), "top_k_acc": ((), None),
    "mae": ((), (REG_L, REG_P)), "mse": ((), (REG_L, REG_P)),
    "rmse": ((), (REG_L, REG_P)), "ce": ((), (LABEL, PRED)),
    "nll_loss": ((), (LABEL, PRED)), "perplexity": ((), (LABEL, PRED)),
    "loss": ((), (None, REG_P)), "f1": ((), None), "mcc": ((), None),
    "pearsoncorrelation": ((), (REG_L, REG_P))}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name):
    _, data = METRICS[name]
    if name == "top_k_acc":
        p, j = metric.create(name, top_k=2), jmetric.create(name, top_k=2)
        data = (LABEL, PRED)
    elif name in ("f1", "mcc"):
        p, j = metric.create(name), jmetric.create(name)
        data = ((LABEL > 1).astype(np.float32),
                np.stack([1 - PRED[:, 0], PRED[:, 0]], 1))
    elif name == "perplexity":
        p, j = metric.create(name, ignore_label=None), \
            jmetric.create(name, ignore_label=None)
    else:
        p, j = metric.create(name), jmetric.create(name)
    label, pred = data
    for m, arr in ((p, _port), (j, jmx.nd.array)):
        for _ in range(2):
            m.update(None if label is None else [arr(label)], [arr(pred)])
    (pn, pv), (jn, jv) = p.get(), j.get()
    assert pn == jn
    np.testing.assert_allclose(pv, jv, rtol=1e-12)
    p.reset()
    assert np.isnan(p.get()[1])


def test_composite_metric_matches_jax():
    p = metric.create(["acc", "ce"])
    j = jmetric.create(["acc", "ce"])
    p.update([_port(LABEL)], [_port(PRED)])
    j.update([jmx.nd.array(LABEL)], [jmx.nd.array(PRED)])
    assert p.get()[0] == j.get()[0]
    np.testing.assert_allclose(p.get()[1], j.get()[1], rtol=1e-12)
    assert isinstance(p, metric.CompositeEvalMetric)
    p.update([torch.from_numpy(LABEL)], [torch.from_numpy(PRED)])
    assert p.get_metric(0).num_inst == 12
