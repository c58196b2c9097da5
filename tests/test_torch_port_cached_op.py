"""The port's CachedOp (``hybridize()``) against the JAX package's, on
the CPU.

Both packages' blocks are hybridized; the reference's run as one
``jax.jit`` program per signature, the port's through ``CachedOp``,
whose pure function runs eagerly on the CPU (the card's capture and
replay are held against the eager block in ``test_torch_port_cuda.py``).
Weights are made by the reference and carried by structural name
(``convert.load_block_weights``); inputs come from ``RandomState``.

Tolerances: outputs and gradients in float32 1e-5 absolute and relative
(the same math in another op order); running statistics 1e-6; under
``amp.init("bfloat16")`` 1e-2 (two bf16 ulps of values of order 1).
Retrace counts, warnings, output trees, dtypes and hook sequences are
compared exactly.  The JAX BERT's compiles run in a module fixture.
"""
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp, autograd as jag, gluon as jgluon
from mxnet_tpu.gluon.model_zoo.nlp.bert import get_bert_model as jax_bert
from mxnet_tpu.lint.retrace import RetraceWarning as JRetraceWarning

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import amp, autograd as ag, gluon, parallel
from mxnet_tpu_torch.base import NotSupportedError
from mxnet_tpu_torch.convert import load_block_weights
from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model
from mxnet_tpu_torch.lint import RetraceMonitor, RetraceWarning

TOL = 1e-5
STAT_TOL = 1e-6
AMP_TOL = 1e-2
RNG = np.random.RandomState(0)


@pytest.fixture(autouse=True)
def _reference_threshold(monkeypatch):
    monkeypatch.delenv("MXTPU_RETRACE_WARN", raising=False)


def _port(a, dtype=None):
    with mx.cpu():
        return mx.nd.array(a, dtype=dtype)


def _jax(a, dtype=None):
    return jmx.nd.array(a, dtype=dtype)


def _weights(jnet):
    return {k: p.data().asnumpy() for k, p in
            jnet._collect_params_with_prefix().items()}


def _grads(net):
    return {k: p.grad().asnumpy() for k, p in
            net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _close_dicts(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=f"{what} {k}")


def _mlp(pkg):
    net = pkg.nn.HybridSequential(prefix="cmlp_")
    with net.name_scope():
        net.add(pkg.nn.Dense(6, activation="relu", in_units=4),
                pkg.nn.Dense(3, in_units=6))
    return net


def _twin(build, init_args=None):
    """The same block in both packages, the reference's weights carried
    into the port's."""
    jnet, pnet = build(jgluon), build(gluon)
    jmx.random.seed(0)
    jnet.initialize(jmx.init.Xavier())
    pnet.initialize(ctx=mx.cpu())
    if init_args is not None:
        jnet(*[_jax(a) for a in init_args])
        pnet(*[_port(a) for a in init_args])
    load_block_weights(pnet, _weights(jnet))
    return jnet, pnet


def _train_call(pkg, tensor, net, x, calls=1):
    """``calls`` recorded forwards summed into one loss, its backward;
    returns the outputs, the parameters' and the input's gradients."""
    ag_ = jag if pkg == "jax" else ag
    xx = tensor(x)
    xx.attach_grad()
    with ag_.record():
        outs = [net(xx) for _ in range(calls)]
        loss = sum((o * o).sum() for o in outs)
    loss.backward()
    return outs[0].asnumpy(), _grads(net), xx.grad.asnumpy()


def test_mlp_forward_and_gradients_match_jax():
    jnet, pnet = _twin(_mlp)
    jnet.hybridize()
    pnet.hybridize()
    x = RNG.randn(5, 4).astype(np.float32)
    for _ in range(2):                  # a new signature, then a cached one
        jy, jg, jgx = _train_call("jax", _jax, jnet, x)
        py, pg, pgx = _train_call("port", _port, pnet, x)
        np.testing.assert_allclose(py, jy, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(pgx, jgx, rtol=TOL, atol=TOL)
        _close_dicts(pg, jg, TOL, "grad")
    np.testing.assert_allclose(pnet(_port(x)).asnumpy(),
                               jnet(_jax(x)).asnumpy(), rtol=TOL, atol=TOL)
    # on the CPU every call runs the pure function eagerly
    assert pnet._cached_op.stats == {"captures": 0, "capture_seconds": 0.0,
                                     "replays": 0, "eager_calls": 3}
    assert pnet._cached_op.graph_pool_bytes() == 0
    assert pnet._cached_op.graphs_captured() == 0


def test_block_called_twice_in_one_record_matches_jax():
    jnet, pnet = _twin(_mlp)
    jnet.hybridize()
    pnet.hybridize()
    x = RNG.randn(2, 4).astype(np.float32)
    jy, jg, jgx = _train_call("jax", _jax, jnet, x, calls=2)
    py, pg, pgx = _train_call("port", _port, pnet, x, calls=2)
    np.testing.assert_allclose(py, jy, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pgx, jgx, rtol=TOL, atol=TOL)
    _close_dicts(pg, jg, TOL, "grad")


def _conv_bn(pkg):
    net = pkg.nn.HybridSequential(prefix="cbn_")
    with net.name_scope():
        net.add(pkg.nn.Conv2D(4, 3, padding=1, in_channels=2),
                pkg.nn.BatchNorm(in_channels=4),
                pkg.nn.Activation("relu"), pkg.nn.GlobalAvgPool2D(),
                pkg.nn.Dense(3, in_units=4))
    return net


@pytest.mark.parametrize("remat", [False, True])
def test_batchnorm_statistics_after_two_training_calls_match_jax(remat):
    jnet, pnet = _twin(_conv_bn)
    jnet.hybridize(remat=remat)
    pnet.hybridize(remat=remat)
    x = RNG.randn(3, 2, 5, 5).astype(np.float32)
    for step in range(2):
        jy, jg, jgx = _train_call("jax", _jax, jnet, x + step)
        py, pg, pgx = _train_call("port", _port, pnet, x + step)
        np.testing.assert_allclose(py, jy, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(pgx, jgx, rtol=TOL, atol=TOL)
        _close_dicts(pg, jg, TOL, f"step {step} grad")
    stats = {k: v for k, v in _weights(jnet).items() if "running" in k}
    got = {k: p.data().asnumpy() for k, p in
           pnet._collect_params_with_prefix().items() if "running" in k}
    _close_dicts(got, stats, STAT_TOL, "running statistic")
    # predict mode reads them
    np.testing.assert_allclose(pnet(_port(x)).asnumpy(),
                               jnet(_jax(x)).asnumpy(), rtol=TOL, atol=TOL)


def _optional(pkg):
    class Optional(pkg.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.dense = pkg.nn.Dense(3, prefix="dense_")   # deferred

        def hybrid_forward(self, F, x, mask=None, bias=None):
            y = self.dense(x)
            if mask is not None:
                y = y * mask
            if bias is not None:
                y = y + bias
            return y, [F.relu(y), y * 2]
    return Optional(prefix="opt_")


def test_none_arguments_deferred_shapes_and_output_trees_match_jax():
    jnet, pnet = _optional(jgluon), _optional(gluon)
    jnet.initialize(jmx.init.One())
    pnet.initialize(init=mx.init.One(), ctx=mx.cpu())
    jnet.hybridize()
    pnet.hybridize()
    x = RNG.randn(2, 5).astype(np.float32)
    m = (RNG.rand(2, 3) > 0.5).astype(np.float32)
    b = RNG.randn(3).astype(np.float32)
    for args in ((x, None, b), (x, m, None), (x, None, None), (x, m, b)):
        jout = jnet(*[None if a is None else _jax(a) for a in args])
        pout = pnet(*[None if a is None else _port(a) for a in args])
        assert type(pout) is type(jout) and type(pout[1]) is type(jout[1])
        for got, want in ((pout[0], jout[0]), (pout[1][0], jout[1][0]),
                          (pout[1][1], jout[1][1])):
            np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                       rtol=TOL, atol=TOL)
    assert pnet.dense.weight.shape == jnet.dense.weight.shape == (3, 5)
    assert pnet._cached_op._retrace.misses == \
        jnet._cached_op._retrace.misses == 4


def test_retrace_counts_and_the_single_warning_match_jax():
    jnet, pnet = _twin(_mlp)
    jnet.hybridize()
    pnet.hybridize()
    seen = {}
    for name, net, tensor, cls in (("jax", jnet, _jax, JRetraceWarning),
                                   ("port", pnet, _port, RetraceWarning)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for n in (2, 2, 3, 4, 3, 5, 6, 6, 2):
                net(tensor(np.ones((n, 4), np.float32)))
            with jag.train_mode() if name == "jax" else ag.train_mode():
                net(tensor(np.ones((2, 4), np.float32)))
        mon = net._cached_op._retrace
        seen[name] = (mon.misses, mon.calls, mon.warned,
                      sum(issubclass(w.category, cls) for w in caught))
    assert seen["port"] == seen["jax"] == (6, 10, True, 1)


def test_retrace_monitor_threshold_is_an_argument():
    mon = RetraceMonitor("blk", threshold=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert mon.record("a") and not mon.record("a") and mon.record("b")
        mon.record("c")
    assert mon.misses == 3 and mon.calls == 4 and len(caught) == 1
    assert issubclass(caught[0].category, RetraceWarning)
    off = RetraceMonitor("blk", threshold=0)
    for s in range(10):
        off.record(s)
    assert not off.warned and RetraceMonitor("x").threshold == 3


def test_hooks_of_a_hybridized_block_follow_the_reference():
    """Fault m: the hybridized block's own hooks never fire, and its
    child's fire once per signature (while it is traced)."""
    seqs = {}
    for name, pkg, tensor in (("jax", jgluon, _jax), ("port", gluon, _port)):
        net = _mlp(pkg)
        if name == "jax":
            net.initialize()
        else:
            net.initialize(ctx=mx.cpu())
        seen = []
        net.register_forward_pre_hook(lambda b, a: seen.append("pre"))
        net.register_forward_hook(lambda b, a, o: seen.append("post"))
        net[0].register_forward_hook(lambda b, a, o: seen.append("child"))
        net.hybridize()
        x = tensor(np.ones((2, 4), np.float32))
        for _ in range(3):
            net(x)
        first = list(seen)
        net(tensor(np.ones((3, 4), np.float32)))
        seqs[name] = (first, seen[len(first):])
    assert seqs["port"] == seqs["jax"] == (["child"], ["child"])


def _amp_block(pkg):
    class Mixed(pkg.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.weight = self.params.get("weight", shape=(6, 4))

        def hybrid_forward(self, F, x, weight):
            y = F.FullyConnected(x, weight, no_bias=True, num_hidden=6)
            return F.softmax(F.relu(y)), F.relu(y), F.exp(y)
    return Mixed(prefix="mixed_")


def test_amp_init_op_lists_match_jax():
    jnet, pnet = _twin(_amp_block)
    jnet.hybridize()
    pnet.hybridize()
    x = RNG.randn(3, 4).astype(np.float32)
    jamp.init("bfloat16", target_precision_ops=["softmax"],
              fp32_ops=["relu"])
    amp.init("bfloat16", target_precision_ops=["softmax"],
             fp32_ops=["relu"])
    try:
        jout = jnet(_jax(x))
        pout = pnet(_port(x))
        # and in the nd namespace: relu now widens, softmax narrows
        eager = mx.nd.relu(_port(x, "bfloat16"))
    finally:
        amp._deinit_for_tests()
        jamp._deinit_for_tests()
    assert [str(o.dtype) for o in pout] == [str(o.dtype) for o in jout] == \
        ["bfloat16", "float32", "float32"]
    assert str(eager.dtype) == "float32"
    for got, want in zip(pout, jout):
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                   rtol=AMP_TOL, atol=AMP_TOL)
    # the lists are the reference's own again
    assert str(mx.nd.relu(_port(x, "bfloat16")).dtype) == "bfloat16"
    assert [str(o.dtype) for o in pnet(_port(x))] == ["float32"] * 3


def test_amp_training_through_the_cached_op_matches_jax():
    """Under ``amp.init("bfloat16")`` the casts of a recorded hybridized
    forward join the graph: the gradients reach the float32 weights,
    as the reference's and the eager port's do."""
    jnet, pnet = _twin(_mlp)
    enet = _mlp(gluon)
    enet.initialize(ctx=mx.cpu())
    load_block_weights(enet, _weights(jnet))
    jnet.hybridize()
    pnet.hybridize()
    x = RNG.randn(3, 4).astype(np.float32)
    jamp.init("bfloat16")
    amp.init("bfloat16")
    try:
        jy, jg, jgx = _train_call("jax", _jax, jnet, x)
        py, pg, pgx = _train_call("port", _port, pnet, x)
        ey, eg, egx = _train_call("port", _port, enet, x)
    finally:
        amp._deinit_for_tests()
        jamp._deinit_for_tests()
    assert sorted(pg) == sorted(jg)
    for k in jg:
        assert str(pnet._collect_params_with_prefix()[k].grad().dtype) == \
            "float32"
        np.testing.assert_array_equal(pg[k], eg[k], err_msg=k)
    _close_dicts(pg, jg, AMP_TOL, "amp grad")
    np.testing.assert_allclose(py, jy, rtol=AMP_TOL, atol=AMP_TOL)
    np.testing.assert_allclose(pgx, jgx, rtol=AMP_TOL, atol=AMP_TOL)


@pytest.fixture(scope="module")
def bert():
    tiny = dict(num_layers=2, units=64, hidden_size=128, num_heads=4,
                vocab_size=100, max_length=16, dropout=0.0,
                use_decoder=False)
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, 100, (2, 16)).astype(np.int32)
    types = rng.randint(0, 2, (2, 16)).astype(np.int32)
    valid = np.array([16, 9], np.float32)
    jmx.random.seed(0)
    jnet = jax_bert(**tiny)
    jnet.initialize()
    jargs = [_jax(tokens, "int32"), _jax(types, "int32"), _jax(valid)]
    jnet(*jargs)
    weights = _weights(jnet)
    jnet.hybridize()
    with jag.record():
        out = jnet(*jargs)
        loss = (out[0] * out[0]).sum() + out[-1].sum()
    loss.backward()
    ref = {"outs": [o.asnumpy() for o in out], "grads": _grads(jnet)}
    return tiny, weights, (tokens, types, valid), ref


def test_bert_forward_and_gradients_match_jax(bert):
    tiny, weights, (tokens, types, valid), ref = bert
    pnet = get_bert_model(**tiny)
    pnet.initialize(ctx=mx.cpu())
    pargs = [_port(tokens, "int32"), _port(types, "int32"), _port(valid)]
    pnet(*pargs)
    load_block_weights(pnet, weights)
    pnet.hybridize()
    for _ in range(2):
        with ag.record():
            out = pnet(*pargs)
            loss = (out[0] * out[0]).sum() + out[-1].sum()
        loss.backward()
        assert len(out) == len(ref["outs"])
        for got, want in zip(out, ref["outs"]):
            np.testing.assert_allclose(got.asnumpy(), want, rtol=TOL,
                                       atol=TOL)
        _close_dicts(_grads(pnet), ref["grads"], 1e-4, "bert grad")
    # the encoder's hybridized children ran inline: no CachedOp of their own
    assert pnet.encoder._cached_op is None


def test_second_order_gradient_through_a_hybridized_block_raises():
    net = _mlp(gluon)
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    x = _port(RNG.randn(2, 4))
    x.attach_grad()
    with ag.record():
        y = (net(x) ** 2).sum()
    with pytest.raises(NotSupportedError, match="create_graph"):
        ag.grad(y, [x], create_graph=True)
    # the first-order gradient, and a retained second backward, still work
    with ag.record():
        y = (net(x) ** 2).sum()
    (gx,) = ag.grad(y, [x], retain_graph=True)
    y.backward(retain_graph=True)
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), gx.asnumpy(), rtol=TOL,
                               atol=TOL)


def test_data_parallel_trainer_runs_hybridized_blocks_inline():
    net = _mlp(gluon)
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    with mx.cpu():
        mesh = parallel.make_mesh({"dp": 1})
    trainer = parallel.DataParallelTrainer(
        net, gluon.loss.L2Loss(), "sgd", {"learning_rate": 0.1}, mesh=mesh)
    x = _port(RNG.randn(4, 4))
    y = _port(RNG.randn(4, 3))
    losses = [float(trainer.step(x, y).asscalar()) for _ in range(3)]
    assert losses[-1] < losses[0]
    assert net._cached_op is None
    assert all(c._cached_op is None for c in net._children.values())


def test_hybridize_and_cast_drop_the_cached_op():
    net = _mlp(gluon)
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    net(_port(np.ones((2, 4))))
    op = net._cached_op
    assert op is not None and op._retrace.misses == 1
    net.cast("float32")
    assert net._cached_op is None
    net(_port(np.ones((2, 4))))
    assert net._cached_op is not op
    net.hybridize()
    assert net._cached_op is None
    net.hybridize(active=False)
    net(_port(np.ones((2, 4))))
    assert net._cached_op is None
    with pytest.raises(mx.MXNetError, match="NDArrays"):
        net.hybridize()
        net(np.ones((2, 4), np.float32))
