"""The port's recurrent layers against the JAX package's, on the CPU:
``gluon.rnn``'s cells and wrappers, ``unroll`` in both layouts, the fused
``RNN``/``LSTM``/``GRU`` layers (plain and hybridized), ``nd.RNN`` over
one packed vector, the ``FusedRNN`` initializer, the legacy ``mx.rnn``
(``BucketSentenceIter``, the checkpoint helpers) and the weights'
carrying (``convert.load_block_weights``, ``rnn_packed_vector``).

The reference's weights are drawn under ``seeded(SEED)`` (its global key
and numpy's, restored after) and carried to the port by structural name;
inputs and states come from ``RandomState``.  Tolerances, with their
reasons:

- outputs, final states and every gradient (input, states, weights):
  2e-5 absolute and relative.  The port hoists each layer's input
  projection into one product over all steps and adds ``h W_h2h^T +
  b_h2h`` after it, where the reference adds the four terms left to
  right in its step: the same sums in another order, carried through up
  to 6 steps of a recurrence whose values are of order 1 (largest
  difference seen 4e-6);
- ``nd.RNN`` against the gluon layer over the same packed weights, in
  the port: bitwise (one code path);
- ``FusedRNN``'s biases and a ``Constant`` init's weights: bitwise; its
  random weights by their bounds (another generator);
- dropout (between layers, ``DropoutCell``, ``ZoneoutCell``): by its
  distribution, not its bits (the port draws from the device's
  ``nd.random`` generator, the reference from its key): the kept share
  within 0.03 of ``1 - p`` over 6,000 draws (4.5 standard deviations),
  kept values scaled by exactly ``1 / (1 - p)``;
- ``BucketSentenceIter``: the same batches, bitwise, under the same
  numpy seed.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgluon

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag, gluon
from mxnet_tpu_torch.base import MXNetError, NotSupportedError
from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                     load_block_weights, rnn_packed_vector)
from test_torch_port_amp import seeded

TOL = 2e-5
SEED = 26
H = 6


def _nd(pkg, a, **kw):
    if pkg is mx:
        with mx.cpu():
            return mx.nd.array(a, **kw)
    return jmx.nd.array(a, **kw)


def _carry(jblk, pblk):
    weights = {k: p.data().asnumpy() for k, p in
               jblk._collect_params_with_prefix().items()}
    pblk.initialize(ctx=mx.cpu())
    load_block_weights(pblk, weights)
    return weights


def _close(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


# ----------------------------------------------------------------------
# the fused layers
# ----------------------------------------------------------------------

LAYERS = {
    "lstm-1": ("LSTM", 1, False, "TNC"),
    "lstm-2-bi": ("LSTM", 2, True, "TNC"),
    "lstm-2-ntc": ("LSTM", 2, False, "NTC"),
    "gru-1-bi": ("GRU", 1, True, "NTC"),
    "gru-2": ("GRU", 2, False, "TNC"),
    "rnn-tanh-2-bi": ("RNN", 2, True, "TNC"),
    "rnn-relu-1": ("RNN", 1, False, "NTC"),
}


def _layer(pkg, name):
    cls, layers, bi, layout = LAYERS[name]
    kw = {"activation": "relu" if "relu" in name else "tanh"} \
        if cls == "RNN" else {}
    return getattr(pkg.rnn, cls)(H, layers, layout=layout, bidirectional=bi,
                                 input_size=4, prefix="r_", **kw)


def _run_layer(pkg, blk, x, states):
    rec = ag if pkg is mx else jag
    xa = _nd(pkg, x)
    sa = [_nd(pkg, s) for s in states]
    for a in [xa] + sa:
        a.attach_grad()
    with rec.record():
        out, new = blk(xa, sa)
        loss = (out * out).sum() + sum((s * s * 0.5).sum() for s in new)
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in
             blk._collect_params_with_prefix().items()}
    return ([out.asnumpy()] + [s.asnumpy() for s in new],
            [a.grad.asnumpy() for a in [xa] + sa], grads)


_LAYER_RUNS = {}


def _layer_case(name):
    """The reference's layer ``name`` (weights drawn under
    ``seeded(SEED)``), its inputs and its outputs and gradients, once a
    name (the plain and the hybridized port hold against the same)."""
    if name not in _LAYER_RUNS:
        cls, layers, bi, layout = LAYERS[name]
        rng = np.random.RandomState(1)
        T, B, I = 5, 3, 4
        x = rng.randn(*((T, B, I) if layout == "TNC" else (B, T, I))) \
            .astype(np.float32)
        n_states = 2 if cls == "LSTM" else 1
        states = [rng.randn(layers * (2 if bi else 1), B, H)
                  .astype(np.float32) for _ in range(n_states)]
        jblk = _layer(jgluon, name)
        with seeded(SEED):
            jblk.initialize(jmx.init.Uniform(0.5))
        weights = {k: p.data().asnumpy() for k, p in
                   jblk._collect_params_with_prefix().items()}
        _LAYER_RUNS[name] = (x, states, weights,
                             _run_layer(jmx, jblk, x, states))
    return _LAYER_RUNS[name]


@pytest.mark.parametrize("hybridize", [False, True], ids=["plain", "hybrid"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_fused_layer_matches_jax(name, hybridize):
    x, states, weights, want = _layer_case(name)
    pblk = _layer(gluon, name)
    pblk.initialize(ctx=mx.cpu())
    load_block_weights(pblk, weights)
    pblk.hybridize(hybridize)
    got = _run_layer(mx, pblk, x, states)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        _close(g, w)
    assert sorted(got[2]) == sorted(want[2])
    for k in got[2]:
        _close(got[2][k], want[2][k], k)
    if hybridize:
        assert pblk._cached_op.stats["eager_calls"] == 1


def test_layer_defers_input_size_and_begins_zero_states():
    jblk = jgluon.rnn.LSTM(H, 2, prefix="d_")
    pblk = gluon.rnn.LSTM(H, 2, prefix="d_")
    assert pblk.l0_i2h_weight.shape == (4 * H, 0)
    x = np.random.RandomState(2).randn(4, 2, 5).astype(np.float32)
    with seeded(SEED):
        jblk.initialize()
    jout = jblk(jmx.nd.array(x))                     # states begun zero
    pblk.initialize(ctx=mx.cpu())
    pout = pblk(_nd(mx, x))
    assert pblk.l0_i2h_weight.shape == (4 * H, 5)
    assert pout.shape == jout.shape == (4, 2, H)
    load_block_weights(pblk, {k: p.data().asnumpy() for k, p in
                              jblk._collect_params_with_prefix().items()})
    _close(pblk(_nd(mx, x)).asnumpy(), jout.asnumpy())
    assert [s["shape"] for s in pblk.state_info(3)] == \
        [s["shape"] for s in jblk.state_info(3)] == [(2, 3, H)] * 2
    with mx.cpu():
        st = pblk.begin_state(3)
    assert [s.shape for s in st] == [(2, 3, H)] * 2
    assert not any(s.asnumpy().any() for s in st)
    assert repr(pblk) == repr(jblk)


def _kept_share(out, x, p):
    out, x = np.asarray(out), np.asarray(x)
    kept = out != 0
    np.testing.assert_allclose(out[kept], x[kept] / (1 - p), rtol=1e-6)
    return kept.mean()


def test_dropout_between_layers_is_inverted_and_only_between():
    """With 1x1 identity weights and relu, layer 1's output is its input,
    so the second layer sees the mask of the first: the kept share is
    1 - p and the kept values scaled; the last layer is not dropped."""
    p = 0.3
    blk = gluon.rnn.RNN(1, 3, activation="relu", dropout=p, input_size=1,
                        i2h_weight_initializer=mx.init.One(),
                        h2h_weight_initializer=mx.init.Zero(), prefix="dr_")
    blk.initialize(ctx=mx.cpu())
    x = np.random.RandomState(3).rand(60, 100, 1).astype(np.float32) + 0.5
    mx.random.seed(7)
    with ag.record():
        out = blk(_nd(mx, x)).asnumpy()
    # two masks (after layers 0 and 1), each of share 1 - p
    kept = out != 0
    assert abs(kept.mean() - (1 - p) ** 2) < 0.03
    np.testing.assert_allclose(out[kept], x[kept] / (1 - p) ** 2, rtol=1e-5)
    with ag.predict_mode():
        np.testing.assert_array_equal(blk(_nd(mx, x)).asnumpy(), x)


# ----------------------------------------------------------------------
# nd.RNN over the packed vector, and FusedRNN
# ----------------------------------------------------------------------

def test_nd_rnn_is_the_gluon_layer_over_one_packed_vector():
    rng = np.random.RandomState(4)
    x = rng.randn(5, 3, 4).astype(np.float32)
    h0, c0 = (rng.randn(4, 3, H).astype(np.float32) for _ in range(2))
    jblk = jgluon.rnn.LSTM(H, 2, bidirectional=True, prefix="p_")
    with seeded(SEED):
        jblk.initialize(jmx.init.Uniform(0.5))
    jblk(jmx.nd.array(x))
    pblk = gluon.rnn.LSTM(H, 2, bidirectional=True, prefix="p_")
    _carry(jblk, pblk)
    vec = rnn_packed_vector(pblk)
    want_out, want_states = pblk(_nd(mx, x), [_nd(mx, h0), _nd(mx, c0)])
    with mx.cpu():
        got = mx.nd.RNN(_nd(mx, x), _nd(mx, vec), _nd(mx, h0),
                        state_cell=_nd(mx, c0), num_layers=2, mode="lstm",
                        bidirectional=True, state_outputs=True)
    np.testing.assert_array_equal(got[0].asnumpy(), want_out.asnumpy())
    for g, w in zip(got[1:], want_states):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    # the reference's op over the same vector, and its gradient
    pv, jv = _nd(mx, vec), jmx.nd.array(vec)
    pv.attach_grad()
    jv.attach_grad()
    outs = []
    for pkg, rec, v in ((mx, ag, pv), (jmx, jag, jv)):
        with rec.record():
            y = pkg.nd.RNN(_nd(pkg, x), v, _nd(pkg, h0),
                           state_cell=_nd(pkg, c0), state_size=H,
                           num_layers=2, mode="lstm", bidirectional=True)
            (y * y).sum().backward()
        outs.append((y.asnumpy(), v.grad.asnumpy()))
    _close(outs[0][0], outs[1][0])
    _close(outs[0][1], outs[1][1])


@pytest.mark.parametrize("mode", ["gru", "rnn_tanh"])
def test_nd_rnn_modes_match_jax(mode):
    rng = np.random.RandomState(5)
    x = rng.randn(4, 2, 3).astype(np.float32)
    h0 = rng.randn(1, 2, H).astype(np.float32)
    g = 3 if mode == "gru" else 1
    n = g * H * 3 + g * H * H + 2 * g * H
    vec = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    got = mx.nd.RNN(_nd(mx, x), _nd(mx, vec), _nd(mx, h0), mode=mode,
                    state_outputs=True)
    want = jmx.nd.RNN(jmx.nd.array(x), jmx.nd.array(vec), jmx.nd.array(h0),
                      mode=mode, state_outputs=True)
    for a, b in zip(got, want):
        _close(a.asnumpy(), b.asnumpy())


def test_nd_rnn_keeps_the_reference_refusals():
    x, h = _nd(mx, np.zeros((2, 1, 3))), _nd(mx, np.zeros((1, 1, H)))
    vec = _nd(mx, np.zeros(4 * H * 3 + 4 * H * H + 8 * H))
    with pytest.raises(MXNetError, match="projection_size"):
        mx.nd.RNN(x, vec, h, state_cell=h, projection_size=2)
    with pytest.raises(MXNetError, match="use_sequence_length"):
        mx.nd.RNN(x, vec, h, state_cell=h, use_sequence_length=True)
    with pytest.raises(MXNetError, match="unknown mode"):
        mx.nd.RNN(x, vec, h, mode="lstmp")
    with pytest.raises(MXNetError, match="state_cell"):
        mx.nd.RNN(x, vec, h)
    with pytest.raises(MXNetError, match="packed parameter vector"):
        mx.nd.RNN(x, _nd(mx, np.zeros(7)), h, state_cell=h)
    with pytest.raises(MXNetError, match="layer slots"):
        mx.nd.RNN(x, vec, h, state_cell=h, num_layers=2)


def test_fused_rnn_initializer_packs_like_the_reference():
    # lstm, 2 layers, one direction, input 3: layer 1 reads H inputs
    n = (4 * H * 3 + 4 * H * H) + (4 * H * H + 4 * H * H) + 4 * (4 * H)
    for init in ("one", mx.init.Uniform(0.3)):
        with mx.cpu():
            got = mx.nd.zeros((n,))
        ref = jmx.nd.zeros((n,))
        mx.init.FusedRNN(init, H, 2, "lstm", forget_bias=0.5)("rnn_w", got)
        jinit = jmx.init.FusedRNN("one" if init == "one"
                                  else jmx.init.Uniform(0.3), H, 2, "lstm",
                                  forget_bias=0.5)
        with seeded(SEED):
            jinit("rnn_w", ref)
        g, r = got.asnumpy(), ref.asnumpy()
        nw = n - 4 * (4 * H)
        np.testing.assert_array_equal(g[nw:], r[nw:])        # biases
        assert g[nw:].reshape(4, 4, H)[:, 1].min() == 0.5
        if init == "one":
            np.testing.assert_array_equal(g, r)
        else:
            assert np.abs(g[:nw]).max() <= 0.3 and g[:nw].std() > 0.1
    with pytest.raises(MXNetError, match="inconsistent"):
        with mx.cpu():
            mx.init.FusedRNN("one", H, 2, "lstm")("w", mx.nd.zeros((7,)))


# ----------------------------------------------------------------------
# the cells
# ----------------------------------------------------------------------

def _cell(pkg, kind):
    r = pkg.rnn
    if kind == "rnn":
        return r.RNNCell(H, activation="relu", prefix="c_")
    if kind == "lstm":
        return r.LSTMCell(H, prefix="c_")
    if kind == "gru":
        return r.GRUCell(H, prefix="c_")
    if kind == "sequential":
        seq = r.SequentialRNNCell(prefix="c_")
        with seq.name_scope():
            seq.add(r.LSTMCell(H))
            seq.add(r.ResidualCell(r.GRUCell(H, input_size=H)))
        return seq
    if kind == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(H, prefix="l_"),
                                   r.GRUCell(H, prefix="r_"))
    raise ValueError(kind)


def _unroll(pkg, cell, x, layout, merge, valid=None):
    rec = ag if pkg is mx else jag
    xa = _nd(pkg, x)
    xa.attach_grad()
    va = None if valid is None else _nd(pkg, valid)
    ctx = mx.cpu() if pkg is mx else jmx.cpu()
    with ctx, rec.record():
        outs, states = cell.unroll(x.shape[layout.find("T")], xa,
                                   layout=layout, merge_outputs=merge,
                                   valid_length=va)
        merged = outs if merge else pkg.nd.stack(*outs,
                                                 axis=layout.find("T"))
        loss = (merged * merged).sum() + sum((s * s).sum() for s in states)
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in
             cell._collect_params_with_prefix().items()}
    return ([merged.asnumpy()] + [s.asnumpy() for s in states],
            xa.grad.asnumpy(), grads)


CELL_CASES = [("rnn", "NTC", True, False), ("lstm", "TNC", False, False),
              ("gru", "NTC", False, True), ("sequential", "TNC", True, False),
              ("bidirectional", "NTC", True, True)]


@pytest.mark.parametrize("kind,layout,merge,valid", CELL_CASES,
                         ids=[c[0] + "-" + c[1] for c in CELL_CASES])
def test_cell_unroll_matches_jax(kind, layout, merge, valid):
    rng = np.random.RandomState(6)
    B, T = 3, 4
    x = rng.randn(*((B, T, 5) if layout == "NTC" else (T, B, 5))) \
        .astype(np.float32)
    vl = np.array([4, 2, 3], np.float32) if valid else None
    jcell, pcell = _cell(jgluon, kind), _cell(gluon, kind)
    with seeded(SEED):
        jcell.initialize(jmx.init.Uniform(0.5))
    jcell.unroll(T, jmx.nd.array(x), layout=layout)      # deferred shapes
    _carry(jcell, pcell)
    got = _unroll(mx, pcell, x, layout, merge, vl)
    want = _unroll(jmx, jcell, x, layout, merge, vl)
    for g, w in zip(got[0], want[0]):
        _close(g, w)
    _close(got[1], want[1])
    assert sorted(got[2]) == sorted(want[2])
    for k in got[2]:
        _close(got[2][k], want[2][k], k)
    assert [s["shape"] for s in pcell.state_info(B)] == \
        [s["shape"] for s in jcell.state_info(B)]


def test_cell_step_counts_and_bidirectional_refuses_a_step():
    cell = gluon.rnn.GRUCell(H, input_size=2, prefix="s_")
    cell.initialize(ctx=mx.cpu())
    with mx.cpu():
        st = cell.begin_state(1)
        for _ in range(3):
            out, st = cell(mx.nd.ones((1, 2)), st)
    assert cell._counter == 2 and cell._init_counter == 0
    assert out.shape == (1, H)
    cell.reset()
    assert cell._counter == -1
    bi = _cell(gluon, "bidirectional")
    with pytest.raises(NotImplementedError, match="unroll"):
        bi(None, [])


def test_dropout_and_zoneout_cells_by_their_distribution():
    p = 0.4
    with mx.cpu():
        x = mx.nd.ones((60, 100))
        mx.random.seed(8)
        drop = gluon.rnn.DropoutCell(p)
        with ag.train_mode():
            out, st = drop(x, [])
        assert st == []
        assert abs(_kept_share(out.asnumpy(), x.asnumpy(), p) - (1 - p)) \
            < 0.03
        with ag.predict_mode():
            np.testing.assert_array_equal(drop(x, [])[0].asnumpy(), 1.0)
        # zoneout of the states: each element keeps the old state with
        # probability p (old 0, new 100 through a constant cell)
        base = gluon.rnn.RNNCell(100, activation="relu", input_size=100,
                                 i2h_weight_initializer=mx.init.One(),
                                 h2h_weight_initializer=mx.init.Zero(),
                                 prefix="z_")
        zone = gluon.rnn.ZoneoutCell(base, zoneout_states=p)
        zone.initialize(ctx=mx.cpu())
        _, new = zone(mx.nd.ones((60, 100)), zone.begin_state(60))
        kept_old = (new[0].asnumpy() == 0).mean()
        assert abs(kept_old - p) < 0.03
        assert set(np.unique(new[0].asnumpy())) == {0.0, 100.0}
    assert [s["shape"] for s in zone.state_info(2)] == [(2, 100)]


# ----------------------------------------------------------------------
# mx.rnn and the weights' carrying
# ----------------------------------------------------------------------

def test_bucket_sentence_iter_matches_jax():
    rng = np.random.RandomState(9)
    sents = [list(rng.randint(1, 50, rng.randint(2, 12)))
             for _ in range(60)]
    for layout, buckets in (("NT", [4, 8, 12]), ("TN", None)):
        state = np.random.get_state()
        try:
            np.random.seed(3)
            it = mx.rnn.BucketSentenceIter(sents, 4, buckets=buckets,
                                           layout=layout, invalid_label=0)
            with mx.cpu():
                got = [(b.bucket_key, b.data[0].asnumpy(),
                        b.label[0].asnumpy()) for b in it]
            np.random.seed(3)
            jit = jmx.rnn.BucketSentenceIter(sents, 4, buckets=buckets,
                                             layout=layout, invalid_label=0)
            want = [(b.bucket_key, b.data[0].asnumpy(),
                     b.label[0].asnumpy()) for b in jit]
        finally:
            np.random.set_state(state)
        assert it.buckets == jit.buckets
        assert [d.shape for d in it.provide_data] == \
            [d.shape for d in jit.provide_data]
        assert len(got) == len(want) > 0
        for (gk, gd, gl), (wk, wd, wl) in zip(got, want):
            assert gk == wk
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
    with pytest.raises(MXNetError, match="layout"):
        mx.rnn.BucketSentenceIter(sents, 4, layout="NC")


def test_rnn_checkpoint_round_trip_and_symbol_refusal(tmp_path):
    cell = mx.rnn.LSTMCell(H, input_size=3, prefix="ck_")
    cell.initialize(mx.init.Uniform(0.3), ctx=mx.cpu())
    before = block_weights_to_numpy(cell)
    prefix = str(tmp_path / "lm")
    mx.rnn.save_rnn_checkpoint(cell, prefix, 3)
    cell.initialize(mx.init.Zero(), ctx=mx.cpu(), force_reinit=True)
    with mx.cpu():
        sym, args, aux = mx.rnn.load_rnn_checkpoint([cell], prefix, 3)
    assert sym is None and aux == {}
    assert sorted(args) == sorted(cell.collect_params())
    for k, v in block_weights_to_numpy(cell).items():
        np.testing.assert_array_equal(v, before[k])
    # the reference reads the file
    jsym, jargs, _ = jmx.model.load_checkpoint(prefix, 3)
    for k, v in args.items():
        np.testing.assert_array_equal(jargs[k].asnumpy(), v.asnumpy())
    with pytest.raises(NotSupportedError, match="item 11b"):
        mx.rnn.save_rnn_checkpoint(cell, prefix, 4, symbol=object())
    other = mx.rnn.GRUCell(H, input_size=3, prefix="other_")
    other.initialize(ctx=mx.cpu())
    with pytest.raises(MXNetError, match="not in checkpoint"):
        with mx.cpu():
            mx.rnn.load_rnn_checkpoint(other, prefix, 3)


def test_every_recurrent_parameter_is_carried_and_packed():
    """``load_block_weights`` carries every parameter of the fused
    layers (``l0_i2h_weight``... ``r1_h2h_bias``) and of a cell stack,
    none left on either side; ``rnn_packed_vector`` lays them out as
    ``nd.RNN`` and the reference's packing order."""
    for make in (lambda p: p.rnn.GRU(H, 2, bidirectional=True,
                                     input_size=3, prefix="w_"),
                 lambda p: _cell(p, "sequential")):
        jblk, pblk = make(jgluon), make(gluon)
        with seeded(SEED):
            jblk.initialize()
        if isinstance(jblk, jgluon.rnn.SequentialRNNCell):
            jblk.unroll(2, jmx.nd.ones((1, 2, 3)))
        w = _carry(jblk, pblk)
        got = block_weights_to_numpy(pblk)
        assert sorted(got) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(got[k], w[k])
        with pytest.raises(MXNetError, match="missing"):
            load_block_weights(pblk, dict(list(w.items())[1:]))
    blk = gluon.rnn.GRU(H, 2, bidirectional=True, input_size=3, prefix="v_")
    blk.initialize(mx.init.Uniform(0.2), ctx=mx.cpu())
    vec = rnn_packed_vector(blk)
    names = blk._param_list()
    weights = [n for n in names if n.endswith("weight")]
    biases = [n for n in names if n.endswith("bias")]
    want = np.concatenate([blk._reg_params[n].data().asnumpy().ravel()
                           for n in weights + biases])
    np.testing.assert_array_equal(vec, want)
    assert [n[:2] for n in weights[:4]] == ["l0", "l0", "r0", "r0"]


def test_gluon_rnn_names_are_the_reference_s():
    from mxnet_tpu.gluon.rnn import rnn_cell as jcells
    assert set(jcells.__all__) | {"RNN", "LSTM", "GRU"} == \
        set(gluon.rnn.__all__)
    from mxnet_tpu import rnn as jlegacy
    assert set(jlegacy.__all__) == set(mx.rnn.__all__)
    assert "fusedrnn" in mx.init._REGISTRY
    assert os.path.basename(mx.rnn.__file__) == "rnn.py"
    assert torch.is_tensor(mx.nd.zeros((1,), ctx=mx.cpu()).data)
