"""Quantized training (``ops/quant_matmul.py``'s training half, the
``compute_dtype`` seam of ``nd.FullyConnected`` and ``gluon.nn.Dense``)
against the JAX package, on the CPU.

The reference draws its int8 stochastic-rounding noise from a key folded
from the bits of each operand's sum (``_sr_key``); the port draws from
the device's generator.  A test feeds the port the reference's own draw
(``uniform=``, or ``_device_uniform`` patched for the layers), built here
from the reference's functions, so the codes, the products and both
gradients compare bitwise.  Where the bits of the draws differ (the
port's own generator), int8 is held by the mean over draws (the rounding
is unbiased) and by the bound of one quantization step per operand
element.  The JAX side reads ``MXTPU_COMPUTE_DTYPE`` and
``MXTPU_QUANT_BF16_ALLOW``, set through ``monkeypatch`` for it alone; the
port reads neither.

Tolerances:

- bitwise for int8 given the reference's draw (int32 accumulation is
  exact, the scales and the rescale are the same f32 operations), for
  ``compute_dtype=None`` against the plain product, and for the codes;
- 1e-6 of the Frobenius norm for fp8 products and gradients (f32
  accumulation of exact fp8 products, summed in another order) and the
  bf16 fallback;
- the narrow BERT trained two Adam steps with every Dense in fp8: losses
  within 1e-4 relative, each parameter's update within 1e-4 of the
  reference's in the Frobenius norm (1.9e-5 seen: the f32 ops around
  the products round in another order, and an operand an ulp apart may
  round to the neighbouring fp8 code); the key projections' bias, whose
  gradient is zero in exact arithmetic, within Adam's bound of 3 lr a
  step (``test_torch_port_bert.py``'s rule);
- the mean of n stochastic roundings within 6 standard errors
  (``0.5 step / sqrt(n)``) of each element, and 1 on average.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd, gluon as jgluon
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.nlp.bert import get_bert_model as jax_bert
import importlib

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon
from mxnet_tpu_torch.convert import block_weights_to_numpy, load_block_weights
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model
from test_torch_port_amp import seeded

R = importlib.import_module("mxnet_tpu.ops.quant_matmul")
P = importlib.import_module("mxnet_tpu_torch.ops.quant_matmul")

RNG = np.random.RandomState(24)
SHAPES = {"square": ((16, 32), (32, 24)), "odd": ((5, 19), (19, 7)),
          "classifier": ((6, 32), (32, 2)), "batched": ((2, 3, 20), (20, 9))}


@pytest.fixture(autouse=True)
def _keep_the_global_generators():
    """Both packages' global generators as they were after each test (the
    amp parity test on the same xdist worker depends on them)."""
    from mxnet_tpu_torch.ndarray import random as prand
    key = jmx.random.get_key_data()
    seed = prand._SEED[0]
    states = {dev: gen.get_state() for dev, gen in prand._GENERATORS.items()}
    yield
    jmx.random.set_key_data(key)
    prand._SEED[0] = seed
    for dev in list(prand._GENERATORS):
        if dev in states:
            prand._GENERATORS[dev].set_state(states[dev])
        else:
            del prand._GENERATORS[dev]


def ref_uniform(x, salt):
    """The reference's uniform draw for operand ``x`` (a port tensor) at
    ``salt``: ``jax.random.uniform(_sr_key(x, salt), ...)``."""
    xj = jnp.asarray(x.detach().float().numpy())
    u = jax.random.uniform(R._sr_key(xj, salt), x.shape, jnp.float32)
    return torch.from_numpy(np.array(u))


def _operands(shape_id, seed=0):
    (sa, sb) = SHAPES[shape_id]
    rng = np.random.RandomState(seed)
    a = rng.randn(*sa).astype(np.float32)
    b = (rng.randn(*sb) * 0.3).astype(np.float32)
    head = rng.randn(*(sa[:-1] + sb[-1:])).astype(np.float32)
    return a, b, head


def _ref(mode, a, b, head, tag="mm"):
    def f(x, y):
        return jnp.sum(R.quant_matmul(x, y, compute_dtype=mode, tag=tag) *
                       head)
    y = R.quant_matmul(jnp.asarray(a), jnp.asarray(b), compute_dtype=mode,
                       tag=tag)
    ga, gb = jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    return [np.asarray(v) for v in (y, ga, gb)]


def _port(mode, a, b, head, **kw):
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    y = P.quant_matmul(ta, tb, compute_dtype=mode, **kw)
    (y * torch.from_numpy(head)).sum().backward()
    return [v.detach().numpy() for v in (y, ta.grad, tb.grad)]


def _norm_close(got, want, rtol, what=""):
    err = np.linalg.norm(np.asarray(got, np.float64) - want)
    assert err <= rtol * np.linalg.norm(want), (what, err)


def test_module_surface_matches_reference():
    assert set(R.__all__) <= set(P.__all__)
    assert (P.INT8_MAX, P.FP8_MAX, P.FP8_GRAD_MAX) == \
        (R.INT8_MAX, R.FP8_MAX, R.FP8_GRAD_MAX)


@pytest.mark.parametrize("value", ["int8", "I8", " fp8 ", "float8",
                                   "float8_e4m3fn", "fp32", "float32", "off",
                                   "0", "none", ""])
def test_resolve_compute_dtype_spellings(value):
    assert P.resolve_compute_dtype(value) == R.resolve_compute_dtype(value)


def test_resolve_compute_dtype_typo_raises(monkeypatch):
    with pytest.raises(MXNetError, match="expected int8"):
        P.resolve_compute_dtype("int4")
    monkeypatch.setenv("MXTPU_COMPUTE_DTYPE", "fp8")
    assert R.resolve_compute_dtype() == "fp8"
    assert P.resolve_compute_dtype() is None


def test_bf16_fallback_tags(monkeypatch):
    monkeypatch.setenv("MXTPU_QUANT_BF16_ALLOW", " fc, attn ,")
    assert P.bf16_fallback_tags() == {"head", "logits"}
    assert P.bf16_fallback_tags(("fc", "attn")) == R.bf16_fallback_tags()
    assert P.bf16_fallback_tags(" fc, attn ,") == R.bf16_fallback_tags()


@pytest.fixture(scope="module")
def products():
    """Each shape's int8 (fed the reference's draw) and fp8 products and
    gradients in both packages (in a fixture: the reference's eager
    custom-VJP ops trace at every call)."""
    out = {}
    for shape_id in SHAPES:
        a, b, head = _operands(shape_id)
        out[shape_id, "int8"] = (_port("int8", a, b, head,
                                       uniform=ref_uniform),
                                 _ref("int8", a, b, head))
        a, b, head = _operands(shape_id, seed=1)
        out[shape_id, "fp8"] = (_port("fp8", a, b, head),
                                _ref("fp8", a, b, head))
    return out


@pytest.mark.parametrize("shape_id", sorted(SHAPES))
def test_int8_with_reference_draw_is_bitwise(products, shape_id):
    for got, want, what in zip(*products[shape_id, "int8"],
                               ("y", "da", "db")):
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("shape_id", sorted(SHAPES))
def test_fp8_matches_reference(products, shape_id):
    for got, want, what in zip(*products[shape_id, "fp8"],
                               ("y", "da", "db")):
        assert got.dtype == want.dtype == np.float32
        _norm_close(got, want, 1e-6, what)


@pytest.mark.parametrize("tag,extra", [("head", ()), ("fc", ("fc",))],
                         ids=["default-tag", "caller-tag"])
def test_bf16_fallback_matches_reference(monkeypatch, tag, extra):
    monkeypatch.setenv("MXTPU_QUANT_BF16_ALLOW", ",".join(extra))
    a, b, head = _operands("odd", seed=2)
    for got, want, what in zip(_port("int8", a, b, head, tag=tag,
                                     bf16_tags=extra),
                               _ref("int8", a, b, head, tag=tag),
                               ("y", "da", "db")):
        _norm_close(got, want, 1e-6, what)


def test_quantize_sr_int8_codes_and_unbiasedness():
    x = RNG.randn(64, 33).astype(np.float32)
    key = jax.random.key(3)
    jc, js = R.quantize_sr_int8(jnp.asarray(x), key)
    u = torch.from_numpy(np.array(jax.random.uniform(
        key, x.shape, jnp.float32)))
    pc, ps = P.quantize_sr_int8(torch.from_numpy(x) / 1.0, u)
    assert float(ps) == float(js)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    # the mean over the device generator's draws is x (within a few
    # standard errors of a step, 0.5 / sqrt(n) each)
    mx.random.seed(0)
    n = 400
    acc = torch.zeros(x.shape, dtype=torch.float64)
    for _ in range(n):
        c, s = P.quantize_sr_int8(torch.from_numpy(x))
        acc += P.dequantize_int8(c, s).double()
    se = 0.5 * float(s) / np.sqrt(n)
    err = np.abs(acc.numpy() / n - x)
    assert err.max() < 6 * se and err.mean() < se


def test_int8_own_draws_unbiased_and_within_a_step():
    """With the device generator's draws the bits are not the
    reference's: each product is within one step an operand element of
    the exact one, and the mean over draws approaches it."""
    a, b, _ = _operands("square", seed=3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    exact = (ta.double() @ tb.double()).numpy()
    sa = np.abs(a).max() / 127.0
    sb = np.abs(b).max() / 127.0
    bound = sa * np.abs(b).sum(0)[None, :] + sb * np.abs(a).sum(1)[:, None] \
        + a.shape[1] * sa * sb
    mx.random.seed(1)
    n = 200
    mean = np.zeros_like(exact)
    for _ in range(n):
        y = P.quant_matmul(ta, tb, compute_dtype="int8").numpy()
        assert (np.abs(y - exact) <= bound * 1.0001).all()
        mean += y / n
    assert np.abs(mean - exact).max() < 0.25 * bound.max()
    assert np.linalg.norm(mean - exact) < 0.2 * np.linalg.norm(
        P.quant_matmul(ta, tb, compute_dtype="int8").numpy() - exact)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_matmul_delayed_three_steps(mode):
    state_j = R.init_delayed_state(history=2)
    state_p = P.init_delayed_state(history=2)
    for step in range(3):
        a = (RNG.randn(8, 16) * (1 + step)).astype(np.float32)
        b = RNG.randn(16, 8).astype(np.float32)
        yj, state_j = R.quant_matmul_delayed(jnp.asarray(a), jnp.asarray(b),
                                             state_j, compute_dtype=mode)
        yp, state_p = P.quant_matmul_delayed(
            torch.from_numpy(a), torch.from_numpy(b), state_p,
            compute_dtype=mode, uniform=ref_uniform)
        if mode == "int8":
            np.testing.assert_array_equal(yp.numpy(), np.asarray(yj))
        else:
            _norm_close(yp.numpy(), np.asarray(yj), 1e-6)
        for k in ("a", "b"):
            np.testing.assert_array_equal(state_p[k].numpy(),
                                          np.asarray(state_j[k]))
    with pytest.raises(MXNetError, match="history"):
        P.init_delayed_state(0)
    y, same = P.quant_matmul_delayed(torch.ones(2, 2), torch.ones(2, 2),
                                     state_p)
    assert same is state_p and torch.equal(y, torch.full((2, 2), 2.0))


def _fc_inputs(seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(4, 3, 10).astype(np.float32),
            (rng.randn(6, 30) * 0.2).astype(np.float32),
            rng.randn(6).astype(np.float32))


def _fc_run(mode, x, w, bias, head):
    """The reference's FullyConnected under ``MXTPU_COMPUTE_DTYPE=mode``
    and the port's with ``compute_dtype=mode`` fed the reference's draws:
    each package's output and input gradients, as NDArrays."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("MXTPU_COMPUTE_DTYPE", mode)
        jx, jw, jb = (jmx.nd.array(v) for v in (x, w, bias))
        for v in (jx, jw, jb):
            v.attach_grad()
        with jautograd.record():
            jy = jmx.nd.FullyConnected(jx, jw, jb, num_hidden=6)
            (jy * jmx.nd.array(head)).sum().backward()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(P, "_device_uniform", ref_uniform)
        with mx.cpu():
            px, pw, pb = (mx.nd.array(v) for v in (x, w, bias))
            for v in (px, pw, pb):
                v.attach_grad()
            with autograd.record():
                py = mx.nd.FullyConnected(px, pw, pb, num_hidden=6,
                                          compute_dtype=mode)
                (py * mx.nd.array(head)).sum().backward()
    return [(py, jy)] + [(p.grad, j.grad) for p, j in
                         ((px, jx), (pw, jw), (pb, jb))]


def _dense_run(x):
    """Two Dense layers of the reference under ``MXTPU_COMPUTE_DTYPE=
    int8``, and the port's from the same weights switched to int8 by
    ``net.apply`` (built with fp8 on the first), fed the reference's
    draws: (port output, reference output)."""
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(7, activation="relu"), jnn.Dense(3))
    with seeded(26):
        jnet.initialize(jmx.init.Xavier())
        jnet(jmx.nd.array(x))
    weights = {k: p.data().asnumpy()
               for k, p in jnet._collect_params_with_prefix().items()}
    with pytest.MonkeyPatch.context() as m:
        m.setenv("MXTPU_COMPUTE_DTYPE", "int8")
        want = jnet(jmx.nd.array(x)).asnumpy()
    net = nn.HybridSequential()
    net.add(nn.Dense(7, activation="relu", compute_dtype="fp8"),
            nn.Dense(3))
    net.initialize(ctx=mx.cpu())
    with pytest.MonkeyPatch.context() as m, mx.cpu():
        m.setattr(P, "_device_uniform", ref_uniform)
        net(mx.nd.array(x))
        load_block_weights(net, weights)
        net.apply(lambda b: setattr(b, "compute_dtype", "int8")
                  if isinstance(b, nn.Dense) else None)
        got = net(mx.nd.array(x)).asnumpy()
    return got, want


@pytest.fixture(scope="module")
def layer_runs():
    """The seam's runs in both packages (in a fixture, as ``products``)."""
    x, w, bias = _fc_inputs()
    head = np.random.RandomState(25).randn(4, 6).astype(np.float32)
    out = {mode: _fc_run(mode, x, w, bias, head) for mode in ("int8", "fp8")}
    out["dense"] = _dense_run(np.random.RandomState(26).randn(5, 8)
                              .astype(np.float32))
    return out


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_fully_connected_seam_matches_reference(layer_runs, mode):
    for k, (p, j) in enumerate(layer_runs[mode]):
        if mode == "int8":
            np.testing.assert_array_equal(p.asnumpy(), j.asnumpy(),
                                          err_msg=str(k))
        else:
            _norm_close(p.asnumpy(), j.asnumpy(), 1e-6, k)


@pytest.mark.parametrize("off", [None, "fp32", "off"])
def test_fully_connected_and_dense_off_are_the_plain_path(off):
    x, w, bias = _fc_inputs(6)
    tx, tw, tb = (torch.from_numpy(v) for v in (x, w, bias))
    plain = torch.nn.functional.linear(tx.reshape(4, -1), tw, tb)
    with mx.cpu():
        got = mx.nd.FullyConnected(mx.nd.array(x), mx.nd.array(w),
                                   mx.nd.array(bias), num_hidden=6,
                                   compute_dtype=off)
        dense = nn.Dense(6, in_units=30, compute_dtype=off)
        dense.initialize()
        dense.weight.set_data(w)
        dense.bias.set_data(bias)
        out = dense(mx.nd.array(x))
    assert torch.equal(got.data, plain) and torch.equal(out.data, plain)


def test_dense_compute_dtype_is_settable_and_matches_reference(layer_runs):
    """``Dense(compute_dtype=)``, and the attribute set on a built net
    with ``net.apply``: the reference under ``MXTPU_COMPUTE_DTYPE``."""
    got, want = layer_runs["dense"]
    np.testing.assert_array_equal(got, want)


# ---- a narrow BERT trained in fp8 ----

TINY = dict(num_layers=2, units=32, hidden_size=64, num_heads=4,
            vocab_size=100, max_length=16, dropout=0.0, use_decoder=False)
B, L = 2, 16


def _bert_inputs():
    rng = np.random.RandomState(7)
    return (rng.randint(0, 100, (B, L)).astype(np.int32),
            rng.randint(0, 2, (B, L)).astype(np.int32),
            rng.randint(0, 2, (B,)).astype(np.int32))


@contextlib.contextmanager
def _env(name, value):
    with pytest.MonkeyPatch.context() as m:
        m.setenv(name, value)
        yield


@pytest.fixture(scope="module")
def fp8_trained():
    """Both packages train the narrow BERT two Adam steps with every
    Dense in fp8, from the reference's initialization (in a fixture: the
    reference's eager ops compile for seconds)."""
    tokens, types, labels = _bert_inputs()
    key = jmx.random.get_key_data()
    jmx.random.seed(11)
    jnet = jax_bert(**TINY)
    jnet.initialize()
    args = [jmx.nd.array(tokens, dtype="int32"),
            jmx.nd.array(types, dtype="int32"), None, None]
    jnet(*args)             # the deferred parameters draw here: seeded too
    jmx.random.set_key_data(key)
    w0 = {k: p.data().asnumpy() for k, p in
          jnet._collect_params_with_prefix().items()}
    jtr = jgluon.Trainer(jnet.collect_params(), "adam",
                         {"learning_rate": 1e-3})
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()
    jl = []
    with _env("MXTPU_COMPUTE_DTYPE", "fp8"):
        for _ in range(2):
            with jautograd.record():
                loss = ce(jnet(*args)[-1], jmx.nd.array(labels, dtype="int32"))
            loss.backward()
            jtr.step(B)
            jl.append(loss.asnumpy())
    jw = {k: p.data().asnumpy() for k, p in
          jnet._collect_params_with_prefix().items()}
    pnet = get_bert_model(**TINY)
    pnet.initialize(ctx=mx.cpu())
    load_block_weights(pnet, w0)
    dense = []
    pnet.apply(lambda b: dense.append(b) or setattr(b, "compute_dtype", "fp8")
               if isinstance(b, nn.Dense) else None)
    tr = gluon.Trainer(pnet.collect_params(), "adam", {"learning_rate": 1e-3})
    pce = gluon.loss.SoftmaxCrossEntropyLoss()
    pl = []
    with mx.cpu():
        pargs = [mx.nd.array(tokens, dtype="int32"),
                 mx.nd.array(types, dtype="int32"), None, None]
        for _ in range(2):
            with autograd.record():
                loss = pce(pnet(*pargs)[-1], mx.nd.array(labels,
                                                         dtype="int32"))
            loss.backward()
            tr.step(B)
            pl.append(loss.asnumpy())
    return w0, jl, jw, pl, block_weights_to_numpy(pnet), len(dense)


def test_narrow_bert_trains_in_fp8_like_reference(fp8_trained):
    w0, jl, jw, pl, pw, n_dense = fp8_trained
    assert n_dense == 2 * 6 + 2        # 4 attention + 2 FFN a layer, heads
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, rtol=1e-4)
    errs = {}
    for k in jw:
        upd = jw[k] - w0[k]
        if k.endswith("proj_key.bias"):
            # zero gradient in exact arithmetic: Adam's steps on noise
            assert np.abs(pw[k] - w0[k]).max() <= 3 * 1e-3 * 2, k
            continue
        errs[k] = np.linalg.norm((pw[k] - w0[k]) - upd) / np.linalg.norm(upd)
    assert max(errs.values()) <= 1e-4, errs


def test_narrow_bert_trains_in_int8():
    """int8 with the device generator's draws: finite, falling loss over
    a few Adam steps (the bits are not the reference's; the products are
    held above by unbiasedness and the step bound)."""
    tokens, types, labels = _bert_inputs()
    mx.random.seed(2)
    pnet = get_bert_model(**TINY)
    pnet.initialize(ctx=mx.cpu())
    pnet.apply(lambda b: setattr(b, "compute_dtype", "int8")
               if isinstance(b, nn.Dense) else None)
    tr = gluon.Trainer(pnet.collect_params(), "adam", {"learning_rate": 3e-3})
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    with mx.cpu():
        args = [mx.nd.array(tokens, dtype="int32"),
                mx.nd.array(types, dtype="int32"), None, None]
        for _ in range(6):
            with autograd.record():
                loss = ce(pnet(*args)[-1], mx.nd.array(labels, dtype="int32"))
            loss.backward()
            tr.step(B)
            losses.append(float(loss.asnumpy().mean()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
