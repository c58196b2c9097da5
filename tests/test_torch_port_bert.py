"""The port's BERT against the JAX package's, on the CPU.

A tiny BERT (2 layers, 32 units, 4 heads, FFN 64, vocab 100, L 16) is
initialized by the reference and carried into the port by
``convert.load_block_weights`` (structural names); the same numpy inputs
(from ``RandomState``) go through both.  The reference's flash path runs
its ``_scan_forward``/``_scan_backward`` on the CPU, the port's its
plain versions.

Tolerances, with their reasons:

- forward outputs (sequence, pooled, MLM scores, NSP scores), f32:
  1e-5 absolute and relative: the same math in another op order (f32
  rounding, values of order 1).
- three Adam steps (lr 1e-3) through ``autograd.record`` and
  ``Trainer(net.collect_params(), "adam")``, f32: losses within 1e-4
  relative, parameters within 1e-5 absolute.
- the same steps under both packages' ``amp.init("bfloat16")``: each
  parameter is held by its UPDATE ``p3 - p0``, as
  ``|dp_port - dp_jax| / |dp_jax|`` (Frobenius norms): within 0.25 for
  each parameter (0.164 seen) and 0.1 over all of them together (0.035
  seen).  Adam's step ``m / sqrt(v)`` is about ``lr`` whatever the
  gradient's size, so an element whose tiny bf16 gradient differs in
  sign between the packages moves by ``2 lr`` the other way; with the
  loss on the CLS token alone, many gradients are tiny.  The key
  projections' bias, whose gradient is zero in exact arithmetic, is
  held to Adam's bound ``3 lr`` instead.  A planted fault (the port at
  half the learning rate) must miss both limits.
- ``save_parameters`` / ``load_parameters`` across the packages:
  bitwise.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jautograd, gluon as jgluon
from mxnet_tpu.gluon.model_zoo.nlp.bert import get_bert_model as jax_bert

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import amp, autograd, gluon
from mxnet_tpu_torch.convert import block_weights_to_numpy, load_block_weights
from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model

TINY = dict(num_layers=2, units=32, hidden_size=64, num_heads=4,
            vocab_size=100, max_length=16, dropout=0.0)
B, L, M = 2, 16, 3
FWD_TOL = 1e-5
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5
AMP_UPDATE_TOL, AMP_GLOBAL_TOL = 0.25, 0.1
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, 100, (B, L)).astype(np.int32),
            "types": rng.randint(0, 2, (B, L)).astype(np.int32),
            "valid": np.array([L, 11], np.float32),
            "positions": rng.randint(0, L, (B, M)).astype(np.int32),
            "labels": rng.randint(0, 2, (B,)).astype(np.int32)}


def _jax_args(x, valid, masked):
    args = [jmx.nd.array(x["tokens"], dtype="int32"),
            jmx.nd.array(x["types"], dtype="int32")]
    args.append(jmx.nd.array(x["valid"]) if valid else None)
    args.append(jmx.nd.array(x["positions"], dtype="int32") if masked
                else None)
    return args


def _port_args(x, valid, masked):
    with mx.cpu():
        args = [mx.nd.array(x["tokens"], dtype="int32"),
                mx.nd.array(x["types"], dtype="int32")]
        args.append(mx.nd.array(x["valid"]) if valid else None)
        args.append(mx.nd.array(x["positions"], dtype="int32") if masked
                    else None)
    return args


def _nets(use_flash=True, use_decoder=True):
    """The reference's tiny BERT, initialized (its deferred shapes by one
    forward), and the port's carrying its weights."""
    kw = dict(TINY, use_flash=use_flash, use_decoder=use_decoder)
    jnet = jax_bert(**kw)
    jnet.initialize()
    jnet(*_jax_args(_inputs(), False, use_decoder))
    weights = {k: p.data().asnumpy() for k, p in
               jnet._collect_params_with_prefix().items()}
    pnet = get_bert_model(**kw)
    pnet.initialize(ctx=mx.cpu())
    load_block_weights(pnet, weights)
    return jnet, pnet, weights


@pytest.mark.parametrize("use_flash,valid", [(True, False), (False, False),
                                             (True, True), (False, True)],
                         ids=["flash", "einsum", "flash-masked",
                              "einsum-masked"])
def test_bert_forward_matches_jax(use_flash, valid):
    jnet, pnet, _ = _nets(use_flash)
    x = _inputs(1)
    jout = jnet(*_jax_args(x, valid, True))
    pout = pnet(*_port_args(x, valid, True))
    assert len(jout) == len(pout) == 4
    for j, p in zip(jout, pout):
        assert j.shape == p.shape
        np.testing.assert_allclose(p.asnumpy(), j.asnumpy(), rtol=FWD_TOL,
                                   atol=FWD_TOL)


def test_bert_weights_carry_both_ways():
    _, pnet, weights = _nets()
    back = block_weights_to_numpy(pnet)
    assert sorted(back) == sorted(weights)
    for k in weights:
        assert np.array_equal(back[k], weights[k]), k
    with pytest.raises(mx.MXNetError, match="shape"):
        load_block_weights(pnet, dict(weights, **{
            "classifier.weight": np.zeros((3, 32), np.float32)}))
    with pytest.raises(mx.MXNetError, match="missing"):
        load_block_weights(pnet, {k: v for k, v in weights.items()
                                  if k != "pooler.bias"})


def _train_jax(jnet, x, steps=3, lr=LR):
    tr = jgluon.Trainer(jnet.collect_params(), "adam", {"learning_rate": lr})
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()
    args = _jax_args(x, False, False)
    label = jmx.nd.array(x["labels"], dtype="int32")
    losses = []
    for _ in range(steps):
        with jautograd.record():
            loss = ce(jnet(*args)[-1], label)
        loss.backward()
        tr.step(B)
        losses.append(loss.asnumpy().astype(np.float64))
    return losses, {k: p.data().asnumpy() for k, p in
                    jnet._collect_params_with_prefix().items()}


def _train_port(pnet, x, steps=3, lr=LR):
    tr = gluon.Trainer(pnet.collect_params(), "adam", {"learning_rate": lr})
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    args = _port_args(x, False, False)
    with mx.cpu():
        label = mx.nd.array(x["labels"], dtype="int32")
    losses = []
    for _ in range(steps):
        with autograd.record():
            loss = ce(pnet(*args)[-1], label)
        loss.backward()
        tr.step(B)
        losses.append(loss.asnumpy().astype(np.float64))
    return losses, block_weights_to_numpy(pnet), tr


@pytest.fixture(scope="module")
def f32_trained():
    """Both packages train tiny BERT 3 Adam steps in f32 (in a fixture:
    the JAX package's eager ops compile for seconds)."""
    jnet, pnet, _ = _nets(use_decoder=False)
    x = _inputs(2)
    return _train_jax(jnet, x) + _train_port(pnet, x)


def test_bert_adam_training_matches_jax(f32_trained):
    jl, jw, pl, pw, tr = f32_trained
    # the whole group lies in the Trainer's flat buffer (K2's path)
    assert tr._flat_param is not None and \
        len(tr._in_buffer) == len(jw)
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)
    for k in jw:
        np.testing.assert_allclose(pw[k], jw[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    assert pl[-1].mean() < pl[0].mean()


def _update_errors(w0, w, ref, keys):
    """Per parameter, and over all of ``keys`` together,
    ``|(w - w0) - (ref - w0)| / |ref - w0|``."""
    per = {k: float(np.linalg.norm((w[k] - w0[k]) - (ref[k] - w0[k])) /
                    np.linalg.norm(ref[k] - w0[k])) for k in keys}
    diff = np.concatenate([((w[k] - w0[k]) - (ref[k] - w0[k])).ravel()
                           for k in keys])
    size = np.concatenate([(ref[k] - w0[k]).ravel() for k in keys])
    return per, float(np.linalg.norm(diff) / np.linalg.norm(size))


@pytest.fixture(scope="module")
def amp_trained():
    """Both packages train tiny BERT 3 Adam steps under
    ``amp.init("bfloat16")``, and the port again at half the learning
    rate (a planted fault); the policies are undone whatever happens."""
    jamp.init("bfloat16")
    amp.init("bfloat16")
    try:
        jnet, pnet, w0 = _nets(use_decoder=False)
        x = _inputs(3)
        jl, jw = _train_jax(jnet, x)
        pl, pw, _ = _train_port(pnet, x)
        with autograd.record():
            out = pnet(*_port_args(x, False, False))
        dtypes = (str(out[0].dtype), str(out[-1].dtype))
        _, pnet2, _ = _nets(use_decoder=False)
        _, half, _ = _train_port(pnet2, x, lr=LR / 2)
    finally:
        jamp._deinit_for_tests()
        amp._deinit_for_tests()
    return w0, jl, jw, pl, pw, dtypes, half


def test_bert_amp_training_matches_jax(amp_trained):
    w0, jl, jw, pl, pw, dtypes, half = amp_trained
    # as the reference's: f32 sequence output (LayerNorm is an FP32 op),
    # bf16 classifier scores (FullyConnected runs in the target dtype)
    assert dtypes == ("float32", "bfloat16")
    np.testing.assert_allclose(np.mean(pl, 1), np.mean(jl, 1), atol=2e-2)
    # the key projections' bias has a zero gradient in exact arithmetic
    # (each score row shifts by a constant): its updates are bf16
    # rounding noise normalized by Adam, held to Adam's bound only
    noise = [k for k in jw if k.endswith("proj_key.bias")]
    keys = [k for k in jw if k not in noise]
    for k in noise:
        for w in (pw, jw):
            assert np.abs(w[k] - w0[k]).max() <= 3 * LR * 1.001, k
    per, whole = _update_errors(w0, pw, jw, keys)
    assert whole <= AMP_GLOBAL_TOL and max(per.values()) <= AMP_UPDATE_TOL, \
        (whole, per)
    per_half, whole_half = _update_errors(w0, half, jw, keys)
    assert whole_half > AMP_GLOBAL_TOL and \
        max(per_half.values()) > AMP_UPDATE_TOL


def test_convert_hybrid_block_casts_each_parameter():
    _, pnet, _ = _nets()
    assert amp.convert_hybrid_block(pnet, "bfloat16") is pnet
    params = pnet.collect_params()
    assert all(p.data().dtype == "bfloat16" and p.dtype == "bfloat16"
               for p in params.values())


def test_save_parameters_across_packages_bitwise(tmp_path):
    jnet, pnet, weights = _nets()
    # JAX writes, the port reads (into a net whose shapes wait)
    jfile = str(tmp_path / "jax.params")
    jnet.save_parameters(jfile)
    fresh = get_bert_model(**dict(TINY, use_flash=True))
    fresh.initialize(ctx=mx.cpu())
    fresh.load_parameters(jfile)
    got = block_weights_to_numpy(fresh)
    for k in weights:
        assert np.array_equal(got[k], weights[k]), k
    # the port writes (after a change), JAX reads
    with mx.cpu():
        pnet.encoder.position_weight.set_data(
            mx.nd.ones(pnet.encoder.position_weight.shape))
    pfile = str(tmp_path / "port.params")
    pnet.save_parameters(pfile)
    jnet.load_parameters(pfile)
    want = block_weights_to_numpy(pnet)
    for k, p in jnet._collect_params_with_prefix().items():
        assert np.array_equal(p.data().asnumpy(), want[k]), k


def test_remat_gives_the_same_gradients():
    _, pnet, _ = _nets(use_decoder=False)
    x = _inputs(4)
    args = _port_args(x, False, False)

    def grads():
        with autograd.record():
            out = pnet(*args)
            loss = (out[0] * out[0]).sum() + out[-1].sum()
        loss.backward()
        return {k: p.grad().asnumpy().copy() for k, p in
                pnet._collect_params_with_prefix().items()}

    plain = grads()
    pnet.encoder.remat()
    assert all(c._flags["remat"] for c in
               pnet.encoder.transformer_cells._children.values())
    again = grads()
    for k in plain:
        np.testing.assert_allclose(again[k], plain[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
