"""The port's ``gluon.contrib`` against the JAX package's, on the CPU:
``nn`` (``SyncBatchNorm`` alone and over two gloo ranks, ``Identity``,
``Concurrent``, ``HybridConcurrent``), ``rnn`` (``VariationalDropoutCell``,
``Conv2DLSTMCell``) and ``data`` (``IntervalSampler``); ``estimator``
raises naming ROADMAP §1 item 11b.

The reference's weights are drawn under ``seeded(SEED)`` and carried by
structural name.  Tolerances, with their reasons:

- layer outputs and gradients: 1e-5 absolute and relative (f32 sums in
  another order; values of order 1);
- ``SyncBatchNorm`` over two ranks against the reference's BatchNorm
  over the whole batch (what the reference's ``SyncBatchNorm`` computes
  when its batch is sharded): 1e-5; each rank's statistics sum the two
  halves in f32 and the ranks' running statistics are bitwise equal;
- ``VariationalDropoutCell``: by its masks (one for every step of a
  sequence, kept share within 0.03 of ``1 - p`` over 4,000 draws, kept
  values scaled by ``1 / (1 - p)``), not their bits (another
  generator); in predict mode it is its base cell, within 1e-6;
- ``IntervalSampler``: the same indices.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgluon
from mxnet_tpu.gluon import contrib as jcontrib

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag, gluon
from mxnet_tpu_torch.base import MXNetError, NotSupportedError
from mxnet_tpu_torch.convert import load_block_weights
from mxnet_tpu_torch.gluon import contrib
import torch_dist_worker as worker
from test_torch_port_amp import seeded

SEED = 26
TOL = 1e-5


def _nd(pkg, a):
    if pkg is mx:
        with mx.cpu():
            return mx.nd.array(a)
    return jmx.nd.array(a)


def _pair(make, x):
    jblk = make(jcontrib, jgluon)
    with seeded(SEED):
        jblk.initialize(jmx.init.Uniform(0.5))
    jblk(jmx.nd.array(x))
    weights = {k: p.data().asnumpy() for k, p in
               jblk._collect_params_with_prefix().items()}
    pblk = make(contrib, gluon)
    pblk.initialize(ctx=mx.cpu())
    load_block_weights(pblk, weights)
    return jblk, pblk, weights


def _grads(pkg, blk, x, coef, train=True):
    rec = ag if pkg is mx else jag
    xa = _nd(pkg, x)
    xa.attach_grad()
    with rec.record(train_mode=train):
        y = blk(xa)
        loss = (y * y * _nd(pkg, coef)).sum()
    loss.backward()
    return (y.asnumpy(), xa.grad.asnumpy(),
            {k: p.grad().asnumpy() for k, p in
             blk._collect_params_with_prefix().items()
             if p.grad_req != "null"},
            {k: p.data().asnumpy() for k, p in
             blk._collect_params_with_prefix().items()})


def _close(a, b, what=""):
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=what)


def _bn_data(seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(8, 5, 3, 3) * 2 + 1).astype(np.float32)
    return x, rng.rand(*x.shape).astype(np.float32)


def test_sync_batch_norm_alone_is_batch_norm():
    x, coef = _bn_data()

    def make(c, g):
        return c.nn.SyncBatchNorm(in_channels=5, num_devices=2,
                                  prefix="sbn_")
    jblk, pblk, _ = _pair(make, x)
    for train in (True, False):
        got = _grads(mx, pblk, x, coef, train)
        want = _grads(jmx, jblk, x, coef, train)
        for g, w in zip(got[:2], want[:2]):
            _close(g, w)
        for d_got, d_want in zip(got[2:], want[2:]):
            assert sorted(d_got) == sorted(d_want)
            for k in d_got:
                _close(d_got[k], d_want[k], k)
    assert isinstance(pblk, gluon.nn.BatchNorm)


def test_sync_batch_norm_over_two_gloo_ranks(tmp_path):
    """Two gloo processes each normalize half the batch with the whole
    batch's statistics: outputs, the input's gradient and the summed
    gamma/beta gradients match the reference's BatchNorm over the
    whole batch."""
    x, coef = _bn_data(1)
    jbn = jgluon.nn.BatchNorm(in_channels=5, prefix="sbn_")
    with seeded(SEED):
        jbn.initialize(jmx.init.Uniform(0.5))
    w0 = {k: p.data().asnumpy() for k, p in
          jbn._collect_params_with_prefix().items()}
    w0["gamma"] = w0["gamma"] + 1.0
    w0["beta"] = np.linspace(-1, 1, 5).astype(np.float32)
    for k, p in jbn._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(w0[k]))
    y, dx, grads, params = _grads(jmx, jbn, x, coef)
    ranks = worker.run_ranks("contrib", 2, tmp_path, w0,
                             {"x": x, "c": coef})
    _close(np.concatenate([r["sync_bn/y"] for r in ranks]), y)
    _close(np.concatenate([r["sync_bn/dx"] for r in ranks]), dx)
    for k in ("gamma", "beta"):
        _close(sum(r[f"sync_bn/grad/{k}"] for r in ranks), grads[k], k)
    for k in ("running_mean", "running_var"):
        np.testing.assert_array_equal(ranks[0][f"sync_bn/{k}"],
                                      ranks[1][f"sync_bn/{k}"])
        _close(ranks[0][f"sync_bn/{k}"], params[k], k)


@pytest.mark.parametrize("kind", ["Concurrent", "HybridConcurrent"])
def test_concurrent_matches_jax(kind):
    x = np.random.RandomState(2).randn(3, 4).astype(np.float32)

    def make(c, g):
        blk = getattr(c.nn, kind)(axis=1, prefix="cc_")
        with blk.name_scope():
            blk.add(g.nn.Dense(3), c.nn.Identity(), g.nn.Dense(2))
        return blk
    jblk, pblk, _ = _pair(make, x)
    if kind == "HybridConcurrent":
        pblk.hybridize()
    coef = np.ones((3, 9), np.float32)
    got, want = _grads(mx, pblk, x, coef), _grads(jmx, jblk, x, coef)
    assert got[0].shape == (3, 9)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    for k in got[2]:
        _close(got[2][k], want[2][k], k)


def _conv_lstm(c, g):
    return c.rnn.Conv2DLSTMCell((3, 6, 6), 4, prefix="cl_")


def test_conv2d_lstm_cell_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 3, 6, 6).astype(np.float32)      # (B, T, C, H, W)
    jcell = _conv_lstm(jcontrib, jgluon)
    with seeded(SEED):
        jcell.initialize(jmx.init.Uniform(0.3))
    pcell = _conv_lstm(contrib, gluon)
    weights = {k: p.data().asnumpy() for k, p in
               jcell._collect_params_with_prefix().items()}
    pcell.initialize(ctx=mx.cpu())
    load_block_weights(pcell, weights)
    assert sorted(weights) == ["h2h.weight", "i2h.bias", "i2h.weight"]
    res = []
    for pkg, cell, rec in ((mx, pcell, ag), (jmx, jcell, jag)):
        xa = _nd(pkg, x)
        xa.attach_grad()
        with (mx.cpu() if pkg is mx else jmx.cpu()), rec.record():
            outs, states = cell.unroll(4, xa, layout="NTC",
                                       merge_outputs=True)
            loss = (outs * outs).sum() + (states[1] * states[1]).sum()
        loss.backward()
        res.append([outs.asnumpy(), states[0].asnumpy(),
                    states[1].asnumpy(), xa.grad.asnumpy()] +
                   [p.grad().asnumpy() for _, p in sorted(
                       cell._collect_params_with_prefix().items())])
    assert res[0][0].shape == (2, 4, 4, 6, 6)
    for g, w in zip(*res):
        _close(g, w)
    assert [s["shape"] for s in pcell.state_info(2)] == \
        [s["shape"] for s in jcell.state_info(2)]


class _Echo(gluon.rnn.HybridRecurrentCell):
    """A cell whose output is its input (and whose state is the step's
    input too), to see the masks."""

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, 40)}]

    def __call__(self, inputs, states):
        return inputs, [inputs]


def test_variational_dropout_cell_shares_one_mask_a_sequence():
    p = 0.5
    cell = contrib.rnn.VariationalDropoutCell(_Echo(), drop_inputs=p,
                                              drop_outputs=p)
    with mx.cpu():
        x = mx.nd.ones((100, 3, 40))                 # (B, T, C)
        mx.random.seed(5)
        with ag.train_mode():
            outs, _ = cell.unroll(3, x, merge_outputs=True)
        o = outs.asnumpy()
        with ag.train_mode():
            again, _ = cell.unroll(3, x, merge_outputs=True)
    # inputs and outputs each masked once: values 0 or 4, the same at
    # every step, and a new pair of masks for the next sequence
    assert set(np.unique(o)) <= {0.0, 1.0 / (1 - p) ** 2}
    for t in (1, 2):
        np.testing.assert_array_equal(o[:, t], o[:, 0])
    assert abs((o[:, 0] != 0).mean() - (1 - p) ** 2) < 0.03
    assert not np.array_equal(again.asnumpy(), o)


def test_variational_dropout_cell_in_predict_mode_is_its_base_cell():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 5).astype(np.float32)

    def make(c, g):
        return c.rnn.VariationalDropoutCell(
            g.rnn.LSTMCell(6, input_size=5, prefix="vd_"), drop_inputs=0.3,
            drop_states=0.3, drop_outputs=0.3)
    jcell = make(jcontrib, jgluon)
    with seeded(SEED):
        jcell.initialize(jmx.init.Uniform(0.5))
    pcell = make(contrib, gluon)
    w = {k: p.data().asnumpy() for k, p in
         jcell._collect_params_with_prefix().items()}
    pcell.initialize(ctx=mx.cpu())
    load_block_weights(pcell, w)
    assert sorted(w) == sorted(pcell._collect_params_with_prefix())
    with jag.predict_mode():
        jo, js = jcell.unroll(3, jmx.nd.array(x), merge_outputs=True)
    with mx.cpu(), ag.predict_mode():
        po, ps = pcell.unroll(3, mx.nd.array(x), merge_outputs=True)
    np.testing.assert_allclose(po.asnumpy(), jo.asnumpy(), rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(ps, js):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6,
                                   atol=1e-6)


def test_interval_sampler_matches_jax():
    for length, interval, rollover in ((10, 3, True), (10, 3, False),
                                       (7, 7, True), (9, 1, False)):
        got = contrib.data.IntervalSampler(length, interval, rollover)
        want = jcontrib.data.IntervalSampler(length, interval, rollover)
        assert list(got) == list(want)
        assert len(got) == len(want)
    with pytest.raises(MXNetError, match="interval"):
        contrib.data.IntervalSampler(3, 4)


def test_contrib_namespace_and_estimator_refusal():
    import mxnet_tpu_torch.gluon.contrib as c
    assert set(c.nn.__all__) == set(jcontrib.nn.__all__)
    assert set(c.rnn.__all__) == set(jcontrib.rnn.__all__)
    assert set(c.data.__all__) == set(jcontrib.data.__all__)
    with pytest.raises(NotSupportedError, match="item 11b"):
        c.estimator
    with pytest.raises(AttributeError):
        c.no_such_module
    x = np.ones((2, 3), np.float32)
    with mx.cpu():
        np.testing.assert_array_equal(
            c.nn.Identity()(mx.nd.array(x)).asnumpy(), x)
