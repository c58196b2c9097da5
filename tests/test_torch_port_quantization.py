"""The port's int8 post-training quantization (``contrib.quantization``,
``ops.quant_matmul``) against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed.  Float weights cross into the port
by structural name (``convert.load_block_weights``); quantized layers
cross with their codes and scales (``convert.quantized_state`` /
``load_quantized_state``), so a parity test compares one set of codes,
never two calibrations.

Tolerances, with their reasons:

- weight codes and scales, ``quantize_rtn_int8`` (ties and the clip
  included), ``optimal_threshold_kl`` and the int8 product: bitwise (the
  same f32 divisions, round half to even, int32 sums exact);
- naive thresholds within 1e-6 relative: the reference reads the
  activations of its own forward, the port of its own, which agree to
  float32 summation order;
- ``QuantizedDense`` and ``QuantizedConv2D`` on carried codes and scales:
  bitwise against the reference on the same input (the product is an
  exact int32 sum and the rescale the same f32 ops);
- the quantized Llama against the reference's with carried codes within
  2e-3 of the logits' largest magnitude: the activations reaching each
  quantizer agree to float32 summation order, so a code can flip by one
  at a rounding boundary, moving that layer's output by one activation
  step times the weight's scale;
- the drift of the quantized Llama from the float one within
  ``0.05 * max|logit|``, the reference's documented serving bound
  (``tests/test_quantization.py``).
"""
import importlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon.model_zoo.nlp.llama import (
    LlamaConfig as JaxConfig, LlamaForCausalLM as JaxLlama)
jqm = importlib.import_module("mxnet_tpu.ops.quant_matmul")

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.contrib import quantization as q
from mxnet_tpu_torch.convert import (load_block_weights,
                                     load_quantized_state, quantized_state)
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                       LlamaForCausalLM)
from mxnet_tpu_torch.ops.quant_matmul import (dequantize_int8, int8_matmul,
                                              quantize_rtn_int8)

jnd = jmx.nd
GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=64, max_seq_len=64)
DRIFT_FRAC = 0.05
CARRIED_FRAC = 2e-3
NAIVE_RTOL = 1e-6


def _nd(a):
    return mx.nd.array(a, ctx=mx.cpu())


def _weights(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _walk(block):
    yield block
    for child in block._children.values():
        yield from _walk(child)


# ----------------------------------------------------------------------
# the quantizers and the product
# ----------------------------------------------------------------------

def test_weight_codes_and_scales_are_the_reference_bitwise():
    rng = np.random.RandomState(0)
    w = (rng.randn(48, 40) * rng.rand(48, 1)).astype(np.float32)
    w[3] = 0.0                              # the 1e-8 floor
    for axis in (1, None):
        jc, js = jq._quant_params_symmetric(jnp_array(w), axis=axis)
        pc, ps = q._quant_params_symmetric(torch.from_numpy(w), axis=axis)
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    conv = rng.randn(8, 3, 3, 3).astype(np.float32)
    jc, js = jq._quant_params_symmetric(jnp_array(conv), axis=(1, 2, 3))
    pc, ps = q._quant_params_symmetric(torch.from_numpy(conv),
                                       axis=(1, 2, 3))
    assert ps.shape == (8, 1, 1, 1)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def jnp_array(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


@pytest.mark.parametrize("scale", [0.5, 0.0137, 1.0 / 127.0])
def test_quantize_rtn_int8_is_the_reference_bitwise(scale):
    """Round half to even at the ties, clipped to +-127, from f32 and
    from bf16 inputs."""
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5, 200.0,
                     -300.0, 0.0], np.float32) * np.float32(scale)
    x = np.concatenate([ties, np.random.RandomState(1)
                        .randn(500).astype(np.float32) * 60 * scale])
    want = np.asarray(jqm.quantize_rtn_int8(jnp_array(x), scale))
    got = quantize_rtn_int8(torch.from_numpy(x), scale)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:3].tolist() == [0, 2, 2] and got[8:10].tolist() == [127, -127]
    as_tensor = torch.tensor(scale, dtype=torch.float32)
    assert torch.equal(quantize_rtn_int8(torch.from_numpy(x), as_tensor), got)
    np.testing.assert_array_equal(
        dequantize_int8(got, scale).numpy(),
        np.asarray(jqm.dequantize_int8(jnp_array(want), scale)))


def test_int8_matmul_is_the_exact_int32_product():
    rng = np.random.RandomState(2)
    a = rng.randint(-127, 128, (5, 64)).astype(np.int8)
    b = rng.randint(-127, 128, (24, 64)).astype(np.int8)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (5, 24)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64).T)
    with pytest.raises(MXNetError, match="int8 operands"):
        int8_matmul(torch.from_numpy(a).float(), torch.from_numpy(b))
    with pytest.raises(MXNetError, match=r"\(M, K\) x \(N, K\)"):
        int8_matmul(torch.from_numpy(a), torch.from_numpy(b[:, :32]))


def test_optimal_threshold_kl_is_the_reference():
    rng = np.random.RandomState(0)
    v = np.concatenate([rng.normal(0, 1, 20000), [40.0, -35.0]])
    amax = np.abs(v).max()
    hist, edges = np.histogram(v, bins=2001, range=(-amax, amax))
    assert q.optimal_threshold_kl(hist, edges) == \
        jq.optimal_threshold_kl(hist, edges)
    assert q.optimal_threshold_kl(hist[:100], edges[:101]) == \
        jq.optimal_threshold_kl(hist[:100], edges[:101])


# ----------------------------------------------------------------------
# the layers, on carried codes
# ----------------------------------------------------------------------

def _mlp(pkg, flatten=True):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", flatten=flatten),
            nn.Dense(16, flatten=flatten))
    return net


def _jax_init(net, *probe):
    jmx.random.seed(3)
    net.initialize()
    net(*[jnd.array(x) for x in probe])
    return net


def _port_twin(jnet, w, make, x):
    """The port's net with the reference's float weights ``w``, then its
    int8 twins with the reference's codes and scales."""
    pnet = make(mx)
    pnet.initialize(ctx=mx.cpu())
    pnet(_nd(x))
    load_block_weights(pnet, w)
    return load_quantized_state(pnet, quantized_state(jnet))


@pytest.mark.parametrize("flatten", [True, False])
def test_quantized_dense_matches_the_reference(flatten):
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (3, 4, 16)).astype(np.float32)
    jnet = _jax_init(_mlp(jmx, flatten), x)
    w = _weights(jnet)
    jq.quantize_net(jnet, calib_data=[jnd.array(x)])
    pnet = _port_twin(jnet, w, lambda pkg: _mlp(pkg, flatten), x)
    assert [type(c).__name__ for c in pnet._children.values()] == \
        ["QuantizedDense"] * 2
    for k, (codes, scales, act) in quantized_state(pnet).items():
        jcodes, jscales, jact = quantized_state(jnet)[k]
        assert codes.shape == jcodes.shape and scales.shape == (codes.shape[0],
                                                               1)
        np.testing.assert_array_equal(codes, jcodes)
        assert act == jact
    x2 = rng.uniform(-1.5, 1.5, x.shape).astype(np.float32)
    want = jnet(jnd.array(x2)).asnumpy()
    got = pnet(_nd(x2))
    assert got.data.dtype == torch.float32
    np.testing.assert_array_equal(got.asnumpy(), want)


def _convnet(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, kernel_size=3, padding=1),
            nn.Conv2D(6, kernel_size=3, strides=2, padding=1, groups=2,
                      use_bias=False))
    return net


@pytest.fixture(scope="module")
def conv_reference():
    """The reference's quantized conv net, its float weights, the input
    and its output (its compiles here, outside the test's call)."""
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (2, 4, 8, 8)).astype(np.float32)
    jnet = _jax_init(_convnet(jmx), x)
    w = _weights(jnet)
    jq.quantize_net(jnet, calib_data=[jnd.array(x)])
    return jnet, w, x, jnet(jnd.array(x)).asnumpy()


def test_quantized_conv2d_matches_the_reference(conv_reference):
    jnet, w, x, want = conv_reference
    pnet = _port_twin(jnet, w, _convnet, x)
    assert [type(c).__name__ for c in pnet._children.values()] == \
        ["QuantizedConv2D"] * 2
    got = pnet(_nd(x)).asnumpy()
    assert got.shape == want.shape == (2, 6, 4, 4)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def mlp_thresholds():
    """Both packages' naive and entropy thresholds of one MLP on the same
    batches (in a fixture: the KL sweeps take seconds)."""
    rng = np.random.RandomState(6)
    batches = [rng.uniform(-2, 2, (4, 16)).astype(np.float32)
               for _ in range(3)]
    jnet = _jax_init(_mlp(jmx), batches[0])
    pnet = _mlp(mx)
    pnet.initialize(ctx=mx.cpu())
    pnet(_nd(batches[0]))
    load_block_weights(pnet, _weights(jnet))
    out = {}
    for mode in ("naive", "entropy"):
        jt = jq.calib_thresholds(jnet, [jnd.array(b) for b in batches], mode)
        pt = q.calib_thresholds(pnet, [_nd(b) for b in batches], mode)
        out[mode] = ([pt[b] for b in pnet._children.values()],
                     [jt[b] for b in jnet._children.values()])
    return out


def test_naive_and_entropy_thresholds_match_the_reference(mlp_thresholds):
    pv, jv = mlp_thresholds["naive"]
    np.testing.assert_allclose(pv, jv, rtol=NAIVE_RTOL)
    pv, jv = mlp_thresholds["entropy"]
    # the first layer's input is the batch itself: one histogram
    assert pv[0] == jv[0]
    assert all(t > 0 for t in pv)


def test_refusals_follow_the_reference():
    net = _mlp(mx)
    net.initialize(ctx=mx.cpu())
    x = _nd(np.ones((2, 16), np.float32))
    with pytest.raises(MXNetError, match="calib_data is required"):
        q.quantize_net(net)
    with pytest.raises(MXNetError, match="only int8"):
        q.quantize_net(net, calib_data=[x], quantized_dtype="uint8")
    with pytest.raises(MXNetError, match="use quantize_net"):
        q.quantize_model(None, {}, {})
    # exclude_layers keeps a child (by attribute name) in float
    q.quantize_net(net, calib_data=[x], exclude_layers=["1"])
    assert [type(c).__name__ for c in net._children.values()] == \
        ["QuantizedDense", "Dense"]


# ----------------------------------------------------------------------
# Llama
# ----------------------------------------------------------------------

def _jax_llama(tie):
    jmx.random.seed(0)
    net = JaxLlama(JaxConfig(tie_embeddings=tie, **GEOM))
    net.initialize()
    net(jnd.array(np.zeros((1, 4)), dtype="int32"))
    return net


def _calib(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, (2, 12)).astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module", params=[False, True], ids=["head", "tied"])
def llamas(request):
    """The reference's Llama quantized by its ``quantize_net``; the
    port's float twin and its int8 twin on the carried codes; the
    port's own ``quantize_net`` of the float twin."""
    tie = request.param
    jnet = _jax_llama(tie)
    w = _weights(jnet)
    x = np.random.RandomState(1).randint(0, 64, (2, 10)).astype(np.int32)
    jfloat = jnet(jnd.array(x, dtype="int32")).asnumpy()
    jth = jq.calib_thresholds(jnet, [jnd.array(b, dtype="int32")
                                     for b in _calib()])
    jq.quantize_net(jnet, calib_data=[jnd.array(b, dtype="int32")
                                      for b in _calib()])
    jint8 = jnet(jnd.array(x, dtype="int32")).asnumpy()

    def port():
        return load_block_weights(
            LlamaForCausalLM(LlamaConfig(tie_embeddings=tie, **GEOM),
                             device="cpu"), w)
    carried = load_quantized_state(port(), quantized_state(jnet))
    own = port()
    pfloat = own(_nd(x)).asnumpy()
    pth = q.calib_thresholds(own, [_nd(b) for b in _calib()])
    q.quantize_net(own, calib_data=[_nd(b) for b in _calib()])
    return dict(tie=tie, x=x, jfloat=jfloat, jint8=jint8, carried=carried,
                own=own, pfloat=pfloat, jth=sorted(jth.values()),
                pth=sorted(pth.values()), jnet=jnet)


def test_llama_quantize_net_swaps_every_projection(llamas):
    n = sum(isinstance(b, q.QuantizedDense) for b in _walk(llamas["own"]))
    assert n == 2 * 7 + (0 if llamas["tie"] else 1)
    assert len(llamas["pth"]) == n
    np.testing.assert_allclose(llamas["pth"], llamas["jth"],
                               rtol=NAIVE_RTOL)
    assert sorted(quantized_state(llamas["own"])) == \
        sorted(quantized_state(llamas["jnet"]))


def test_llama_int8_drift_within_the_serving_bound(llamas):
    """The port's own quantized Llama drifts from its float forward by at
    most ``0.05 * max|logit|``, as the reference's does."""
    out = llamas["own"](_nd(llamas["x"])).asnumpy()
    ref = llamas["pfloat"]
    assert out.shape == ref.shape and np.isfinite(out).all()
    drift = np.abs(out - ref).max()
    assert drift <= DRIFT_FRAC * np.abs(ref).max(), drift
    jdrift = np.abs(llamas["jint8"] - llamas["jfloat"]).max()
    assert jdrift <= DRIFT_FRAC * np.abs(llamas["jfloat"]).max()


def test_llama_on_carried_codes_matches_the_reference(llamas):
    out = llamas["carried"](_nd(llamas["x"])).asnumpy()
    want = llamas["jint8"]
    err = np.abs(out - want).max()
    assert err <= CARRIED_FRAC * np.abs(want).max(), err
