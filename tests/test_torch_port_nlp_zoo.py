"""The port's Transformer, sequence samplers and NLP ``get_model``
against the JAX package's, on the CPU.

Both packages build the same small ``TransformerModel`` (2 + 2 layers,
16 units, 2 heads, vocab 40) with one explicit prefix, so the
``collect_params()`` keys are comparable; the reference initializes it
and its parameters cross into the port by structural name
(``convert.load_block_weights``).  Inputs are numpy arrays from a seed.
The reference's Adam step and beam searches run in module fixtures, so
each test stays under the duration guard.

What is held, with its reason:

- the parameter keys equal the reference's;
- logits within 1e-5 (float32; XLA and PyTorch sum in other orders),
  with and without ``src_valid_length``, post-norm and pre-norm;
- one Adam step: parameters within 1e-5 (at lr 1e-3 and these sizes no
  gradient is near zero against its rounding, so Adam's normalized step
  does not amplify it; measured 1e-9-1e-8);
- ``BeamSearchSampler``: samples and lengths identical, scores within
  1e-6, for the reference's test decoder (ties everywhere: the port's
  ``_topk`` orders them as ``lax.top_k``) and for the small
  Transformer's decode step; ``SequenceSampler`` with ``top_k=1``
  identical (no draw decides), and with draws reproducible after the
  ``nd.random`` generator's state is restored (the reference restores
  its key; the bits differ, ROADMAP §3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd, gluon as jgluon
from mxnet_tpu.gluon.model_zoo import nlp as jnlp

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, NotSupportedError, autograd, gluon
from mxnet_tpu_torch.convert import load_block_weights
from mxnet_tpu_torch.gluon.model_zoo import nlp
from mxnet_tpu_torch.gluon.model_zoo.nlp import sampler as port_sampler
from mxnet_tpu_torch.ndarray import random as port_random

VOCAB = 40
KW = dict(src_vocab_size=VOCAB, tgt_vocab_size=VOCAB, num_layers=2,
          units=16, hidden_size=32, num_heads=2, max_length=32, dropout=0.0,
          prefix="transformer_")
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, VOCAB, (3, 7)).astype(np.int32),
            rng.randint(0, VOCAB, (3, 5)).astype(np.int32),
            np.array([7, 4, 2], np.float32))


def _weights(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _jnd(a, dtype=None):
    return jmx.nd.array(a, dtype=dtype)


def _pnd(a, dtype=None):
    return mx.nd.array(a, ctx=mx.cpu(), dtype=dtype)


@pytest.fixture(scope="module", params=[False, True],
                ids=["post_norm", "pre_norm"])
def model(request):
    """The reference's model, its keys, weights and logits (with and
    without valid lengths), and its parameters after one Adam step."""
    kw = dict(KW, pre_norm=request.param)
    jmx.random.seed(0)
    jnet = jnlp.TransformerModel(**kw)
    jnet.initialize()
    jnet.hybridize()
    src, tgt, vl = _inputs()
    out = {"kw": kw, "keys": list(jnet.collect_params().keys())}
    out["masked"] = jnet(_jnd(src, "int32"), _jnd(tgt, "int32"),
                         _jnd(vl)).asnumpy()
    out["plain"] = jnet(_jnd(src, "int32"), _jnd(tgt, "int32")).asnumpy()
    out["w0"] = _weights(jnet)
    tr = jgluon.Trainer(jnet.collect_params(), "adam",
                        {"learning_rate": 1e-3})
    with jautograd.record():
        loss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            jnet(_jnd(src, "int32"), _jnd(tgt, "int32"), _jnd(vl)),
            _jnd(tgt))
    loss.backward()
    tr.step(src.shape[0])
    out["w1"] = _weights(jnet)
    return out


def _port_model(model):
    net = nlp.TransformerModel(**model["kw"])
    net.initialize(ctx=mx.cpu())
    return load_block_weights(net, model["w0"])


def test_parameter_keys_equal_the_reference(model):
    net = nlp.TransformerModel(**model["kw"])
    assert list(net.collect_params().keys()) == model["keys"]
    assert "transformer_enc_pos" in model["keys"]


def test_logits_match_the_reference(model):
    net = _port_model(model)
    src, tgt, vl = _inputs()
    got = net(_pnd(src, "int32"), _pnd(tgt, "int32"), _pnd(vl))
    assert got.shape == (3, 5, VOCAB)
    np.testing.assert_allclose(got.asnumpy(), model["masked"], atol=TOL,
                               rtol=TOL)
    got = net(_pnd(src, "int32"), _pnd(tgt, "int32"))
    np.testing.assert_allclose(got.asnumpy(), model["plain"], atol=TOL,
                               rtol=TOL)


def test_one_adam_step_matches_the_reference(model):
    net = _port_model(model)
    src, tgt, vl = _inputs()
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-3})
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            net(_pnd(src, "int32"), _pnd(tgt, "int32"), _pnd(vl)), _pnd(tgt))
    loss.backward()
    tr.step(src.shape[0])
    got = _weights(net)
    for k, v in model["w1"].items():
        np.testing.assert_allclose(got[k], v, atol=TOL, rtol=0, err_msg=k)


def test_decoder_is_causal_and_padding_is_masked(model):
    net = _port_model(model)
    src, tgt, vl = _inputs()
    a = net(_pnd(src, "int32"), _pnd(tgt, "int32"), _pnd(vl)).asnumpy()
    tgt2, src2 = tgt.copy(), src.copy()
    tgt2[:, 4] = (tgt2[:, 4] + 1) % VOCAB
    src2[1, 4:] = (src2[1, 4:] + 3) % VOCAB           # row 1's padding
    b = net(_pnd(src2, "int32"), _pnd(tgt2, "int32"), _pnd(vl)).asnumpy()
    np.testing.assert_allclose(a[:, :4], b[:, :4], atol=TOL, rtol=TOL)
    assert not np.allclose(a[:, 4], b[:, 4])


def test_untied_unshared_model_and_the_512_config():
    net = nlp.TransformerModel(VOCAB, 30, num_layers=1, units=8,
                               hidden_size=16, num_heads=2, max_length=16,
                               share_embed=False, tie_weights=False,
                               prefix="t_")
    keys = list(net.collect_params().keys())
    jkeys = list(jnlp.TransformerModel(
        VOCAB, 30, num_layers=1, units=8, hidden_size=16, num_heads=2,
        max_length=16, share_embed=False, tie_weights=False,
        prefix="t_").collect_params().keys())
    assert keys == jkeys and "t_proj_weight" in keys
    net.initialize(ctx=mx.cpu())
    src, tgt, _ = _inputs(1)
    assert net(_pnd(src, "int32"), _pnd(tgt % 30, "int32")).shape == \
        (3, 5, 30)
    big = nlp.transformer_en_de_512(prefix="big_")
    params = big.collect_params()
    assert params["big_src_embed_weight"].shape == (36794, 512)
    assert params["big_enc_pos"].shape == (1024, 512)
    n_cells = len([k for k in params if k.endswith("ffn1_weight")])
    assert n_cells == 12


def test_positional_encoding_equals_the_reference():
    np.testing.assert_array_equal(nlp.positional_encoding(50, 12),
                                  jnlp.positional_encoding(50, 12))


# ----------------------------------------------------------------------
# samplers
# ----------------------------------------------------------------------

def _tie_decoder(nd_mod, as_numpy):
    """The reference's test decoder (tests/test_nlp_models.py): every
    token but one at -10.0, so most candidates tie."""
    def decoder(step_input, states):
        step = int(as_numpy(states["step"])[0])
        n = step_input.shape[0]
        lp = np.full((n, 6), -10.0, dtype=np.float32)
        if step == 0:
            lp[:, 3] = -0.1
        elif step == 1:
            lp[:, 0] = -0.1
            lp[:, 2] = -0.1
        else:
            lp[:, 0] = -0.1
        return nd_mod(lp), {"step": nd_mod(np.array([step + 1] * n))}
    return decoder


def _np_of(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _to_np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else x.cpu().numpy() \
        if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def tie_reference():
    out = {}
    for beam, max_len in ((2, 4), (3, 5), (4, 3)):
        sampler = jnlp.BeamSearchSampler(
            beam_size=beam, decoder=_tie_decoder(jmx.nd.array, _np_of),
            eos_id=0, max_length=max_len, sync_every=2)
        out[beam, max_len] = [r.asnumpy() for r in sampler(
            jmx.nd.array([1, 4]), {"step": jmx.nd.array([0, 0])})]
    return out


@pytest.mark.parametrize("beam,max_len", [(2, 4), (3, 5), (4, 3)])
def test_beam_search_over_ties_matches_the_reference(tie_reference, beam,
                                                     max_len):
    sampler = nlp.BeamSearchSampler(
        beam_size=beam, decoder=_tie_decoder(_pnd, _to_np), eos_id=0,
        max_length=max_len, sync_every=2)
    got = [r.asnumpy() for r in sampler(_pnd([1, 4]),
                                        {"step": _pnd([0, 0])})]
    want = tie_reference[beam, max_len]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].shape == (2, beam, want[0].shape[2])


def test_topk_orders_ties_as_lax_top_k():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 2.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    for k in (1, 3, 5):
        vals, idx = port_sampler._topk(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def _mt_decoder(F, net, mem_key):
    """A step function that re-decodes the whole prefix (the model keeps
    no incremental state): states hold the memory, its mask and the
    tokens so far; returns the last position's log-probs."""
    def decoder(step_input, states):
        tok = _to_np(step_input).astype(np.int32)[:, None]
        prefix = np.concatenate([_to_np(states["prefix"]), tok], 1) \
            .astype(np.int32)
        logits = net.decode(F(prefix, "int32"), F(_to_np(states[mem_key])),
                            None, F(_to_np(states["mask"])[:, :1]))
        lp = _to_np(logits)[:, -1]
        lp = lp - np.log(np.exp(lp - lp.max(-1, keepdims=True)).sum(
            -1, keepdims=True)) - lp.max(-1, keepdims=True)
        return F(lp.astype(np.float32)), dict(states, prefix=F(prefix))
    return decoder


def _mt_states(F, net, src, vl):
    lk = src.shape[1]
    keep = (np.arange(lk)[None, None, :] < vl[:, None, None]) \
        .astype(np.float32)
    mask = np.broadcast_to(keep, (src.shape[0], lk, lk))
    mem = _to_np(net.encode(F(src, "int32"), F(mask)))
    return {"mem": F(mem), "mask": F(np.ascontiguousarray(mask)),
            "prefix": F(np.zeros((src.shape[0], 0), np.int32))}


@pytest.fixture(scope="module")
def mt_reference(model):
    jmx.random.seed(0)
    jnet = jnlp.TransformerModel(**model["kw"])
    jnet.initialize()
    jnet.hybridize()
    src, _, vl = _inputs(2)
    jnet(_jnd(src, "int32"), _jnd(src[:, :2], "int32"))
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(model["w0"][k]))
    sampler = jnlp.BeamSearchSampler(
        beam_size=3, decoder=_mt_decoder(_jnd, jnet, "mem"), eos_id=1,
        max_length=6)
    return [r.asnumpy() for r in sampler(
        _jnd(np.array([2, 2, 2], np.float32)), _mt_states(_jnd, jnet, src,
                                                          vl))]


def test_beam_search_over_the_transformer_matches_the_reference(
        model, mt_reference):
    net = _port_model(model)
    src, _, vl = _inputs(2)
    sampler = nlp.BeamSearchSampler(
        beam_size=3, decoder=_mt_decoder(_pnd, net, "mem"), eos_id=1,
        max_length=6)
    got = [r.asnumpy() for r in sampler(
        _pnd(np.array([2, 2, 2], np.float32)),
        _mt_states(_pnd, net, src, vl))]
    np.testing.assert_array_equal(got[0], mt_reference[0])
    np.testing.assert_allclose(got[1], mt_reference[1], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got[2], mt_reference[2])


def _ramp_step(vocab):
    """A raw step function (flagged ``expects_ndarray = False``): an
    ascending ramp of log-probs, the same at every step."""
    logits = torch.log_softmax(torch.linspace(0.0, 1.0, vocab), dim=0)

    def step(tok, states):
        assert torch.is_tensor(tok)
        return logits.expand(tok.shape[0], vocab).clone(), states
    step.expects_ndarray = False
    return step


def test_sequence_sampler_top1_matches_the_reference():
    vocab = 12

    @jax.jit
    def jstep(tok, states):
        logits = jnp.tile(jnp.linspace(0.0, 1.0, vocab)[None, :],
                          (tok.shape[0], 1))
        return jax.nn.log_softmax(logits, axis=-1), states

    want = [r.asnumpy() for r in jnlp.SequenceSampler(
        beam_size=3, decoder=jstep, eos_id=0, max_length=6, top_k=1)(
        jmx.nd.array([1, 2]), {})]
    got = [r.asnumpy() for r in nlp.SequenceSampler(
        beam_size=3, decoder=_ramp_step(vocab), eos_id=0, max_length=6,
        top_k=1)(_pnd([1, 2]), {})]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])


def test_sequence_sampler_replays_after_the_generator_is_restored():
    vocab = 12
    sampler = nlp.SequenceSampler(beam_size=3, decoder=_ramp_step(vocab),
                                  eos_id=0, max_length=6, temperature=1.0,
                                  top_k=4, step_mode="jax")
    gen = port_random.generator(torch.device("cpu"))
    snap = gen.get_state()
    s1, _, l1 = sampler(_pnd([1, 2]), {})
    gen.set_state(snap)
    s2, _, l2 = sampler(_pnd([1, 2]), {})
    np.testing.assert_array_equal(s1.asnumpy(), s2.asnumpy())
    np.testing.assert_array_equal(l1.asnumpy(), l2.asnumpy())
    s3, _, _ = sampler(_pnd([1, 2]), {})
    assert not np.array_equal(s1.asnumpy(), s3.asnumpy())
    # the 4 best ids only
    assert set(np.unique(s1.asnumpy()[..., 1:])) <= set(range(vocab - 4,
                                                              vocab))


def test_step_modes():
    vocab = 6
    seen = []

    def nd_step(tok, states):
        seen.append(type(tok))
        return _pnd(np.log(np.full((tok.shape[0], vocab), 1 / vocab,
                                   np.float32))), states
    nlp.BeamSearchSampler(2, nd_step, eos_id=0, max_length=2)(
        _pnd([1]), {})
    nlp.BeamSearchSampler(2, nd_step, eos_id=0, max_length=2,
                          step_mode="jax")(_pnd([1]), {})
    assert seen[0] is mx.nd.NDArray and seen[-1] is torch.Tensor
    raw = _ramp_step(vocab)
    assert port_sampler._StepCaller(raw)._raw
    assert not port_sampler._StepCaller(raw, "ndarray")._raw
    with pytest.raises(MXNetError):
        nlp.BeamSearchSampler(2, nd_step, eos_id=0, step_mode="numpy")


def test_get_model_serves_bert_and_the_transformer():
    assert isinstance(nlp.get_model("transformer_en_de_512", prefix="g_"),
                      nlp.TransformerModel)
    bert = nlp.get_model("bert_12_768_12", vocab_size=50,
                         use_decoder=False, use_classifier=False)
    assert isinstance(bert, nlp.BERTModel)
    # the language models are served too (tests/test_torch_port_language_
    # model.py holds them against the reference)
    assert isinstance(nlp.get_model("standard_lstm_lm_200", vocab_size=20),
                      nlp.StandardRNN)
    with pytest.raises(NotSupportedError, match="pretrained"):
        nlp.get_model("transformer_en_de_512", pretrained=True)
    with pytest.raises(MXNetError):
        nlp.get_model("no_such_model")
    assert set(nlp._MODELS) == set(jnlp._MODELS)
    assert not hasattr(nlp, "_LATER")


def test_nlp_names_are_the_reference_s_but_the_language_models():
    # the language models are ported now: every callable name
    want = {n for n in dir(jnlp) if not n.startswith("_")
            and callable(getattr(jnlp, n))}
    missing = {n for n in want if not hasattr(nlp, n)}
    assert not missing, missing
