"""The port's language models (``gluon.model_zoo.nlp.StandardRNN`` and
``AWDRNN``) against the JAX package's, on the CPU, narrow: vocabulary
50, embedding and hidden 24, sequences of 7 tokens in batches of 3.

The reference's weights are drawn under ``seeded(SEED)`` and carried to
the port by structural name; the port's nets run hybridized (one
CachedOp over embedding, recurrence and projection).  Tolerances, with
their reasons:

- logits and final states in predict mode: 2e-5 absolute and relative
  (the recurrence's sums in another order, ``test_torch_port_rnn.py``;
  largest difference seen 2e-6);
- three SGD-momentum steps (lr 0.5, momentum 0.9) with the dropouts at
  0 (in training mode their masks come from other generators): losses
  within 1e-5 relative and parameters within 1e-4 absolute and relative
  (each step's rounding, carried through the next forward; 1.2e-6
  seen);
- with dropout on, the port's training forward is held by what dropout
  must do: finite logits, different from predict mode's, and a second
  draw different from the first.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgluon
from mxnet_tpu.gluon.model_zoo import nlp as jnlp

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as ag, gluon
from mxnet_tpu_torch.base import MXNetError, NotSupportedError
from mxnet_tpu_torch.convert import load_block_weights
from mxnet_tpu_torch.gluon.model_zoo import nlp
from test_torch_port_amp import seeded

SEED = 26
V, E, T, B = 50, 24, 7, 3
TOL = 2e-5
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-4
LR = 0.5


def _standard(pkg, tie=True, dropout=0.2, mode="lstm"):
    return pkg.StandardRNN(mode, V, E, E, 2, dropout=dropout,
                           tie_weights=tie, prefix="lm_")


def _awd(pkg, tie=True, drop=0.3, mode="lstm"):
    return pkg.AWDRNN(mode, V, E, 32, 3, tie_weights=tie, dropout=drop,
                      drop_h=drop, drop_i=drop, drop_e=drop, prefix="lm_")


MODELS = {
    "standard-tied": lambda p, **kw: _standard(p, True, **kw),
    "standard-gru-untied": lambda p, **kw: _standard(p, False, mode="gru",
                                                     **kw),
    "awd-tied": lambda p, **kw: _awd(p, True, **kw),
    "awd-untied": lambda p, **kw: _awd(p, False, **kw),
}
NO_DROP = {"standard-tied": {"dropout": 0}, "standard-gru-untied":
           {"dropout": 0}, "awd-tied": {"drop": 0}, "awd-untied":
           {"drop": 0}}


def _tokens(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, V, (T, B)).astype(np.float32),
            rng.randint(0, V, (T, B)).astype(np.float32))


def _pair(name, **kw):
    jnet = MODELS[name](jnlp, **kw)
    with seeded(SEED):
        jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(_tokens(0)[0]))                 # deferred shapes
    weights = {k: p.data().asnumpy() for k, p in
               jnet._collect_params_with_prefix().items()}
    pnet = MODELS[name](nlp, **kw)
    pnet.initialize(ctx=mx.cpu())
    load_block_weights(pnet, weights)
    pnet.hybridize()
    return jnet, pnet


def _flat(states):
    if isinstance(states, (list, tuple)):
        return [a for s in states for a in _flat(s)]
    return [states.asnumpy()]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_language_model_forward_and_begin_state_match_jax(name):
    jnet, pnet = _pair(name)
    x, _ = _tokens(1)
    jst = jnet.begin_state(batch_size=B)
    with mx.cpu():
        pst = pnet.begin_state(batch_size=B)
    assert [a.shape for a in _flat(pst)] == [a.shape for a in _flat(jst)]
    rng = np.random.RandomState(2)
    noise = [rng.randn(*a.shape).astype(np.float32) * 0.5
             for a in _flat(jst)]

    def fill(states, pkg):
        it = iter(noise)

        def go(s):
            if isinstance(s, (list, tuple)):
                return [go(a) for a in s]
            return pkg.nd.array(next(it), ctx=s.context)
        return go(states)
    for use_state in (False, True):
        with jag.predict_mode():
            jy, jnew = jnet(jmx.nd.array(x), fill(jst, jmx)) if use_state \
                else jnet(jmx.nd.array(x))
        with mx.cpu(), ag.predict_mode():
            py, pnew = pnet(mx.nd.array(x), fill(pst, mx)) if use_state \
                else pnet(mx.nd.array(x))
        assert py.shape == jy.shape == (T, B, V)
        np.testing.assert_allclose(py.asnumpy(), jy.asnumpy(), rtol=TOL,
                                   atol=TOL)
        for g, w in zip(_flat(pnew), _flat(jnew)):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    # one CachedOp signature per (state given or not)
    assert pnet._cached_op.stats["eager_calls"] == 2


def _train(pkg, net, steps=3):
    g = jgluon if pkg is jmx else gluon
    rec = jag if pkg is jmx else ag
    tr = g.Trainer(net.collect_params(), "sgd",
                   {"learning_rate": LR, "momentum": 0.9})
    ce = g.loss.SoftmaxCrossEntropyLoss()
    losses = []
    ctx = mx.cpu() if pkg is mx else jmx.cpu()
    with ctx:
        for _ in range(steps):
            x, y = _tokens(10)
            with rec.record():
                logits, _ = net(pkg.nd.array(x))
                loss = ce(logits, pkg.nd.array(y))
            loss.backward()
            tr.step(T * B)
            losses.append(loss.asnumpy())
    return losses, {k: p.data().asnumpy() for k, p in
                    net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("name", ["standard-tied", "awd-untied"])
def test_language_model_sgd_steps_match_jax(name):
    jnet, pnet = _pair(name, **NO_DROP[name])
    jl, jw = _train(jmx, jnet)
    pl, pw = _train(mx, pnet)
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)
    assert np.mean(pl[-1]) < np.mean(pl[0])
    for k in jw:
        np.testing.assert_allclose(pw[k], jw[k], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=k)


def test_language_model_dropout_trains_on_fresh_masks():
    _, pnet = _pair("awd-tied")
    x, _ = _tokens(3)
    with mx.cpu():
        with ag.predict_mode():
            base = pnet(mx.nd.array(x))[0].asnumpy()
        mx.random.seed(4)
        with ag.record():
            a = pnet(mx.nd.array(x))[0].asnumpy()
            b = pnet(mx.nd.array(x))[0].asnumpy()
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert not np.allclose(a, base) and not np.allclose(a, b)


def test_get_model_serves_the_language_models():
    for name, cls in (("standard_lstm_lm_200", nlp.StandardRNN),
                      ("standard_lstm_lm_1500", nlp.StandardRNN),
                      ("awd_lstm_lm_600", nlp.AWDRNN)):
        net = nlp.get_model(name, vocab_size=V)
        assert isinstance(net, cls)
        jnet = jnlp.get_model(name, vocab_size=V)
        assert sorted(net._collect_params_with_prefix()) == \
            sorted(jnet._collect_params_with_prefix())
        assert [p.shape for _, p in sorted(
            net._collect_params_with_prefix().items())] == \
            [p.shape for _, p in sorted(
                jnet._collect_params_with_prefix().items())]
    awd = nlp.awd_lstm_lm_1150()
    assert [enc._hidden_size for enc in awd.encoders] == [1150, 1150, 400]
    assert awd.embedding.weight.shape == (33278, 400)
    assert set(nlp._MODELS) == set(jnlp._MODELS)
    with pytest.raises(NotSupportedError, match="pretrained"):
        nlp.get_model("awd_lstm_lm_1150", pretrained=True)
    with pytest.raises(ValueError, match="tie_weights"):
        nlp.StandardRNN("lstm", V, 16, 24, tie_weights=True)
    with pytest.raises(MXNetError):
        nlp.get_model("no_such_lm")
