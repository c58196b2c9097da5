"""The port's NDArray and op subset against ``mxnet_tpu.nd``, on the CPU.

The same numpy inputs (``RandomState``) go through ``mxnet_tpu.nd`` and
``mxnet_tpu_torch.nd`` (created inside ``with mx.cpu():``).  Tolerances:

- bitwise where both compute the same IEEE operation elementwise (add,
  subtract, multiply, divide, sqrt, abs, comparisons, max/min, where,
  every shape op and gather);
- 1e-6 relative (and absolute) for the transcendental elementwise ops
  (exp, log, tanh, sigmoid, erf, GELU, ELU, SELU, softrelu, softmax's
  exp): XLA and torch use different polynomial approximations, an ulp or
  two apart; and for ``linspace``, whose float32 ``start * (1 - s) +
  stop * s`` XLA contracts into fused multiply-adds of its own choosing;
- 1e-5 for products and reductions (FullyConnected, dot, batch_dot,
  linalg_gemm2, sum, mean, norm, LayerNorm, log_softmax): f32 sums
  taken in another order.

``save``/``load`` across the packages are bitwise.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import utils as jutils

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import NotSupportedError

import test_ndarray_v2_fixture as v2

BIT, ULP, PROD = "bitwise", 1e-6, 1e-5
RNG = np.random.RandomState(0)
A = RNG.randn(3, 4).astype(np.float32)
B_ = RNG.randn(3, 4).astype(np.float32)
POS = np.abs(A) + 0.5
W = RNG.randn(5, 4).astype(np.float32)
BIAS = RNG.randn(5).astype(np.float32)
X3 = RNG.randn(2, 3, 4).astype(np.float32)
Y3 = RNG.randn(2, 4, 5).astype(np.float32)
IDX = np.array([[0, 2], [1, 5]], np.int32)          # 5 clips to 3 (take)
PICK = np.array([0, 3, 1], np.int32)
EMB = RNG.randn(7, 4).astype(np.float32)
TOK = np.array([[1, 6, 0], [3, 3, 2]], np.int32)
GAMMA = RNG.rand(4).astype(np.float32) + 0.5
BETA = RNG.randn(4).astype(np.float32)
MASK = (RNG.rand(3, 4) > 0.5).astype(np.float32)
POSITIONS = np.array([[0, 2], [1, 1]], np.int32)


# name -> (fn(F, *arrays), inputs, tolerance)
CASES = {
    "add": (lambda F, a, b: a + b, (A, B_), BIT),
    "subtract": (lambda F, a, b: F.subtract(a, b), (A, B_), BIT),
    "multiply": (lambda F, a, b: a * b, (A, B_), BIT),
    "divide": (lambda F, a, b: a / b, (A, POS), BIT),
    "scalar-ops": (lambda F, a: (2.0 - a) * 3 / 4 + 1, (A,), BIT),
    "rscalar-div": (lambda F, a: 1.0 / a, (POS,), BIT),
    "power": (lambda F, a: a ** 2, (A,), BIT),
    "mod": (lambda F, a: a % 0.7, (A,), BIT),
    "maximum": (lambda F, a, b: F.maximum(a, b), (A, B_), BIT),
    "minimum": (lambda F, a, b: F.minimum(a, b), (A, B_), BIT),
    "neg-abs": (lambda F, a: abs(-a), (A,), BIT),
    "sqrt": (lambda F, a: F.sqrt(a), (POS,), BIT),
    "square": (lambda F, a: F.square(a), (A,), BIT),
    "relu": (lambda F, a: F.relu(a), (A,), BIT),
    "compare": (lambda F, a, b: (a > b) + (a <= b) * 2 + (a == a) * 4,
                (A, B_), BIT),
    "broadcast_greater": (lambda F, a, b: F.broadcast_greater(a, b),
                          (A, B_), BIT),
    "where": (lambda F, m, a, b: F.where(m, a, b), (MASK, A, B_), BIT),
    "clip": (lambda F, a: F.clip(a, -0.5, 0.5), (A,), BIT),
    "exp": (lambda F, a: F.exp(a), (A,), ULP),
    "log": (lambda F, a: F.log(a), (POS,), ULP),
    "tanh": (lambda F, a: F.tanh(a), (A,), ULP),
    "sigmoid": (lambda F, a: F.sigmoid(a), (A,), ULP),
    "erf": (lambda F, a: F.erf(a), (A,), ULP),
    "Activation-tanh": (lambda F, a: F.Activation(a, act_type="tanh"),
                        (A,), ULP),
    "Activation-softrelu": (lambda F, a: F.Activation(
        a, act_type="softrelu"), (A,), ULP),
    "Activation-relu": (lambda F, a: F.Activation(a, act_type="relu"),
                        (A,), BIT),
    "LeakyReLU-leaky": (lambda F, a: F.LeakyReLU(a, act_type="leaky",
                                                 slope=0.1), (A,), BIT),
    "LeakyReLU-gelu": (lambda F, a: F.LeakyReLU(a, act_type="gelu"), (A,),
                       ULP),
    "LeakyReLU-elu": (lambda F, a: F.LeakyReLU(a, act_type="elu",
                                               slope=0.7), (A,), ULP),
    "LeakyReLU-selu": (lambda F, a: F.LeakyReLU(a, act_type="selu"), (A,),
                       ULP),
    "LeakyReLU-prelu": (lambda F, a, g: F.LeakyReLU(a, g, act_type="prelu"),
                        (A, np.array([0.1, 0.2, 0.3, 0.4], np.float32)), BIT),
    "softmax": (lambda F, a: F.softmax(a, axis=-1), (A,), ULP),
    "softmax-axis0": (lambda F, a: F.softmax(a, axis=0), (A,), ULP),
    "log_softmax": (lambda F, a: F.log_softmax(a, axis=-1), (A,), PROD),
    "FullyConnected": (lambda F, x, w, b: F.FullyConnected(
        x, w, b, num_hidden=5), (A, W, BIAS), PROD),
    "FullyConnected-flatten": (lambda F, x, w: F.FullyConnected(
        x, w, None, num_hidden=5, no_bias=True, flatten=True),
        (X3.reshape(2, 3, 4)[:, :1], W), PROD),
    "FullyConnected-3d": (lambda F, x, w, b: F.FullyConnected(
        x, w, b, num_hidden=5, flatten=False), (X3, W, BIAS), PROD),
    "dot": (lambda F, a, w: F.dot(a, w, transpose_b=True), (A, W), PROD),
    "dot-3d": (lambda F, x, y: F.dot(x, y[0]), (X3, Y3), PROD),
    "batch_dot": (lambda F, x, y: F.batch_dot(x, y), (X3, Y3), PROD),
    "batch_dot-t": (lambda F, x: F.batch_dot(x, x, transpose_b=True),
                    (X3,), PROD),
    "linalg_gemm2": (lambda F, x, y: F.linalg_gemm2(x, y, alpha=0.5),
                     (X3, Y3), PROD),
    "LayerNorm": (lambda F, x, g, b: F.LayerNorm(x, g, b, eps=1e-12),
                  (X3, GAMMA, BETA), PROD),
    "LayerNorm-axis1": (lambda F, x, g, b: F.LayerNorm(x, g, b, axis=0),
                        (A.T.copy(), GAMMA, BETA), PROD),
    "Embedding": (lambda F, i, w: F.Embedding(i, w, input_dim=7,
                                              output_dim=4), (TOK, EMB), BIT),
    "Dropout-predict": (lambda F, a: F.Dropout(a, p=0.5), (A,), BIT),
    "reshape-codes": (lambda F, x: F.reshape(x, (0, -1)), (X3,), BIT),
    "flatten": (lambda F, x: F.flatten(x), (X3,), BIT),
    "transpose": (lambda F, x: F.transpose(x, (2, 0, 1)), (X3,), BIT),
    "transpose-default": (lambda F, x: x.T, (X3,), BIT),
    "expand_dims": (lambda F, a: F.expand_dims(a, axis=1), (A,), BIT),
    "broadcast_to": (lambda F, a: F.broadcast_to(
        F.expand_dims(a, axis=0), (2, 3, 4)), (A,), BIT),
    "concat": (lambda F, a, b: F.concat(a, b, dim=0), (A, B_), BIT),
    "stack": (lambda F, a, b: F.stack(a, b, axis=1), (A, B_), BIT),
    "split": (lambda F, x: F.split(x, num_outputs=2, axis=2)[1], (X3,), BIT),
    "split-squeeze": (lambda F, x: F.split(x, 3, axis=1,
                                           squeeze_axis=True)[2], (X3,), BIT),
    "slice": (lambda F, x: F.slice(x, begin=(0, 1), end=(None, 3)), (X3,),
              BIT),
    "slice_axis": (lambda F, x: F.slice_axis(x, axis=2, begin=1, end=3),
                   (X3,), BIT),
    "take": (lambda F, a, i: F.take(a, i), (A, IDX), BIT),
    "take-axis1-wrap": (lambda F, a, i: F.take(a, i, axis=1, mode="wrap"),
                        (A, IDX), BIT),
    "pick": (lambda F, a, i: F.pick(a, i, axis=-1), (A, PICK), BIT),
    "pick-keepdims": (lambda F, a, i: F.pick(a, i, axis=1, keepdims=True),
                      (A, PICK), BIT),
    "one_hot": (lambda F, i: F.one_hot(i, 4, on_value=2.0, off_value=-1.0),
                (PICK,), BIT),
    "gather_positions": (lambda F, x, p: F.gather_positions(x, p),
                         (X3, POSITIONS), BIT),
    "sum": (lambda F, x: F.sum(x, axis=(0, 2)), (X3,), PROD),
    "sum-all-keepdims": (lambda F, x: F.sum(x, keepdims=True), (X3,), PROD),
    "sum-exclude": (lambda F, x: F.sum(x, axis=1, exclude=True), (X3,),
                    PROD),
    "mean": (lambda F, x: F.mean(x, axis=-1), (X3,), PROD),
    "max-min": (lambda F, x: F.max(x, axis=1) - F.min(x, axis=1), (X3,),
                BIT),
    "prod": (lambda F, x: F.prod(x, axis=2), (X3,), PROD),
    "norm": (lambda F, x: F.norm(x, axis=1), (X3,), PROD),
    "argmax": (lambda F, x: F.argmax(x, axis=-1), (X3,), BIT),
    "method-chain": (lambda F, x: x.reshape((-1, 4)).sum(axis=0).exp(),
                     (X3,), ULP),
    "add_n": (lambda F, a, b: F.add_n(a, b, a), (A, B_), BIT),
    "cast": (lambda F, a: F.cast(a, "float16"), (A,), BIT),
}
INT_INPUTS = {"Embedding": (0,), "take": (1,), "take-axis1-wrap": (1,),
              "pick": (1,), "pick-keepdims": (1,), "one_hot": (0,),
              "gather_positions": (1,)}


def _port(fn, arrays, dtypes):
    with mx.cpu():
        args = [mx.nd.array(a, dtype=d) for a, d in zip(arrays, dtypes)]
        return fn(mx.nd, *args)


def _jax(fn, arrays, dtypes):
    args = [jmx.nd.array(a, dtype=d) for a, d in zip(arrays, dtypes)]
    return fn(jmx.nd, *args)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    fn, arrays, tol = CASES[name]
    dtypes = ["int32" if i in INT_INPUTS.get(name, ()) else None
              for i in range(len(arrays))]
    got = _port(fn, arrays, dtypes)
    want = _jax(fn, arrays, dtypes)
    assert got.shape == want.shape
    assert str(got.dtype) == str(want.dtype), (got.dtype, want.dtype)
    g, w = got.asnumpy(), want.asnumpy()
    if tol == BIT:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("codes", [(0, -1), (-1, 4), (-2,), (-3, 4),
                                   (2, -3), (-4, 1, 2, 0, 4), (0, -4, -1, 1, 4),
                                   (6, -1), (-3, -2)])
def test_reshape_special_codes_match_jax(codes):
    got = _port(lambda F, x: x.reshape(codes), (X3,), (None,))
    want = _jax(lambda F, x: x.reshape(codes), (X3,), (None,))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_reshape_refuses_what_the_reference_refuses():
    with mx.cpu():
        x = mx.nd.zeros((2, 3, 4))
    for codes in [(-1, -1), (5, -1), (-4, -1, -1, 0), (7,)]:
        with pytest.raises(mx.MXNetError):
            x.reshape(codes)
        with pytest.raises(jmx.base.MXNetError):
            jmx.nd.zeros((2, 3, 4)).reshape(codes)


@pytest.mark.parametrize("src,dtype", [
    (np.arange(6, dtype=np.int64), None), (np.arange(6.0), None),
    ([1, 2, 3], None), (np.ones(3, np.float16), None),
    (np.arange(4), "float32"), ([0.5, 1.5], "int32"),
    (np.arange(3, dtype=np.uint8), None)])
def test_creation_dtypes_match_jax(src, dtype):
    with mx.cpu():
        got = mx.nd.array(src, dtype=dtype)
    want = jmx.nd.array(src, dtype=dtype)
    assert str(got.dtype) == str(want.dtype)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_constructors_match_jax():
    pairs = [(lambda nd, **c: nd.zeros((2, 3), **c)),
             (lambda nd, **c: nd.ones(4, dtype="int32", **c)),
             (lambda nd, **c: nd.full((2, 2), 7.5, **c)),
             (lambda nd, **c: nd.empty((3,), **c)),
             (lambda nd, **c: nd.arange(2, 11, 3, **c)),
             (lambda nd, **c: nd.arange(5, repeat=2, **c)),
             (lambda nd, **c: nd.eye(3, 4, 1, **c)),
             (lambda nd, **c: nd.linspace(0, 1, 7, **c)),
             (lambda nd, **c: nd.linspace(0, 1, 4, endpoint=False, **c)),
             (lambda nd, **c: nd.linspace(-3, 5, 11, **c)),
             (lambda nd, **c: nd.linspace(0.5, 7.3, 13, **c))]
    for i, make in enumerate(pairs):
        got = make(mx.nd, ctx=mx.cpu())
        want = make(jmx.nd)
        assert str(got.dtype) == str(want.dtype) and got.shape == want.shape
        if i < 7:
            np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        else:   # linspace: XLA contracts its f32 math into FMAs its own way
            np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                       rtol=ULP, atol=ULP)
    with mx.cpu():
        cat = mx.nd.concat(mx.nd.ones((1, 2)), mx.nd.zeros((1, 2)), dim=0)
    assert cat.shape == (2, 2) and cat.context == mx.cpu()


def test_indexing_and_inplace_match_jax():
    def run(nd, **c):
        x = nd.array(A, **c)
        y = x[1:, ::2] * 1
        x[0] = 5.0
        x[:, 1] = nd.array(np.array([9.0, 8.0, 7.0], np.float32), **c)
        x += 1
        x *= 2
        x -= y[0, 1]
        x /= 4
        z = x[nd.array(np.array([2, 0], np.int32), dtype="int32", **c)]
        return [x, y, z, x[1, 2]]
    for g, w in zip(run(mx.nd, ctx=mx.cpu()), run(jmx.nd)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


def test_ndarray_surface():
    with mx.cpu():
        x = mx.nd.array(A)
    assert x.context == mx.cpu() and x.ctx.device_type == "cpu"
    assert x.ndim == 2 and x.size == 12 and len(x) == 3 and x.stype == \
        "default"
    assert x[0, 0].asscalar() == pytest.approx(float(A[0, 0]))
    assert x.astype("bfloat16").dtype == "bfloat16"
    assert x.astype("float16").asnumpy().dtype == np.float16
    assert x.as_in_context(mx.cpu()) is x
    c = x.copy()
    c[:] = 0
    assert float(x.abs().sum().asscalar()) > 0
    other = mx.nd.zeros((3, 4), ctx=mx.cpu())
    x.copyto(other)
    np.testing.assert_array_equal(other.asnumpy(), A)
    assert x.tolist() == A.tolist() and np.asarray(x).shape == (3, 4)
    t = torch.arange(4.0)
    assert mx.nd.from_torch(t).data is t          # the bridge, no copy
    assert mx.nd.ones((2,), ctx=mx.cpu()).dtype == np.float32
    with pytest.raises(mx.MXNetError):
        bool(x)


def test_entry_points_raise_without_a_card_and_run_on_the_cpu_when_asked():
    if torch.cuda.is_available():
        pytest.skip("the rule is about hosts without a card")
    with pytest.raises(mx.MXNetError, match="mx.cpu"):
        mx.nd.array([1.0])
    with pytest.raises(mx.MXNetError, match="mx.cpu"):
        mx.current_context()
    net = mx.gluon.nn.Dense(3, in_units=2)
    with pytest.raises(mx.MXNetError, match="mx.cpu"):
        net.initialize()
    net.initialize(ctx=mx.cpu())
    with mx.cpu():
        assert mx.current_context() == mx.cpu()
        assert net(mx.nd.ones((1, 2))).shape == (1, 3)
    assert mx.resolve_device(mx.cpu()) == torch.device("cpu")
    assert mx.gpu(1).torch_device == torch.device("cuda", 1)
    assert mx.Context.from_device(torch.device("cuda", 2)) == mx.gpu(2)


def test_unported_ops_raise_naming_their_item():
    for name in ("RNN", "LRN", "topk", "sample_normal"):
        with pytest.raises(NotSupportedError, match="item 8"):
            getattr(mx.nd, name)
    with pytest.raises(AttributeError):
        mx.nd.no_such_op
    from mxnet_tpu.ndarray import ops as jops
    ported = set(mx.nd.ops._OPS)
    later = mx.nd.ops._REFERENCE_OPS
    # every reference op name is either ported or known to wait
    assert set(jops.__all__) <= later
    assert {"FullyConnected", "LayerNorm", "Embedding", "softmax",
            "gather_positions", "batch_dot", "where", "Convolution",
            "Deconvolution", "Pooling", "BatchNorm", "InstanceNorm",
            "GroupNorm", "Pad", "pad", "space_to_depth",
            "depth_to_space"} <= ported


def test_dropout_in_training():
    with mx.cpu():
        x = mx.nd.ones((200, 50))
        mx.random.seed(3)
        with mx.autograd.train_mode():
            y = mx.nd.Dropout(x, p=0.25).asnumpy()
            z = mx.nd.Dropout(x, p=0.25, axes=(1,)).asnumpy()
        mx.random.seed(3)
        with mx.autograd.train_mode():
            y2 = mx.nd.Dropout(x, p=0.25).asnumpy()
    assert set(np.unique(y)) <= {0.0, np.float32(1.0) / np.float32(0.75)}
    assert abs((y == 0).mean() - 0.25) < 0.02
    np.testing.assert_array_equal(y, y2)             # seeded
    assert (z == z[:, :1]).all()                     # one draw along axis 1


def test_random_samplers_by_their_moments():
    mx.random.seed(7)
    with mx.cpu():
        u = mx.nd.random.uniform(-1, 3, shape=(20000,)).asnumpy()
        n = mx.nd.random.normal(2, 0.5, shape=(20000,)).asnumpy()
        r = mx.nd.random.randn(3, 4).asnumpy()
        i = mx.nd.random.randint(0, 5, shape=(1000,))
        b = mx.nd.random.bernoulli(0.3, shape=(20000,)).asnumpy()
    assert -1 <= u.min() and u.max() < 3 and abs(u.mean() - 1) < 0.05
    assert abs(n.mean() - 2) < 0.02 and abs(n.std() - 0.5) < 0.02
    assert r.shape == (3, 4) and str(i.dtype) == "int32"
    assert set(np.unique(i.asnumpy())) == set(range(5))
    assert abs(b.mean() - 0.3) < 0.02


# ----------------------------------------------------------------------
# files: native and legacy containers, both ways
# ----------------------------------------------------------------------

def _arrays(nd, **c):
    return {"w": nd.array(A, **c),
            "i": nd.array(np.array([1, -2, 3], np.int32), dtype="int32", **c),
            "h": nd.array(np.array([1.5, -2.25], np.float16),
                          dtype="float16", **c)}


def test_save_load_across_packages_bitwise(tmp_path):
    pfile, jfile = str(tmp_path / "port.nd"), str(tmp_path / "jax.nd")
    mx.nd.save(pfile, _arrays(mx.nd, ctx=mx.cpu()))
    jmx.nd.save(jfile, _arrays(jmx.nd))
    for loaded in (jmx.nd.load(pfile), mx.nd.load(jfile, ctx=mx.cpu()),
                   mx.nd.load(pfile, ctx=mx.cpu())):
        want = _arrays(jmx.nd)
        assert sorted(loaded) == sorted(want)
        for k in want:
            assert str(loaded[k].dtype) == str(want[k].dtype)
            np.testing.assert_array_equal(loaded[k].asnumpy(),
                                          want[k].asnumpy())
    # an unnamed list, and bfloat16 stored as float32 under its own name
    with mx.cpu():
        mx.nd.save(pfile, [mx.nd.array(A).astype("bfloat16")])
    back = jmx.nd.load(pfile)
    assert isinstance(back, list) and str(back[0].dtype) == "bfloat16"
    got = mx.nd.load(pfile, ctx=mx.cpu())[0]
    assert got.dtype == "bfloat16"
    np.testing.assert_array_equal(got.asnumpy(), back[0].asnumpy())


def test_legacy_files_read_as_the_reference_reads_them(tmp_path):
    """The hand-encoded NDARRAY_V2/V3 bytes of test_ndarray_v2_fixture,
    the committed golden fixture, and a file the reference's legacy
    writer made: the same names, shapes, dtypes and values."""
    blob_path = tmp_path / "hand.params"
    blob_path.write_bytes(v2._fixture_blob())
    legacy = str(tmp_path / "legacy.params")
    jutils.save_legacy(legacy, {k: v for k, v in _arrays(jmx.nd).items()
                                if k != "h"})
    golden = str(v2.__file__).replace("test_ndarray_v2_fixture.py",
                                      "fixtures/golden_ndarray_v2.params")
    for path in (str(blob_path), golden, legacy):
        want = jmx.nd.load(path)
        got = mx.nd.load(path, ctx=mx.cpu())
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape
            assert str(got[k].dtype) == str(want[k].dtype)
            np.testing.assert_array_equal(got[k].asnumpy(),
                                          want[k].asnumpy())
    out = mx.nd.load(str(blob_path), ctx=mx.cpu())
    assert str(out["fc0_bias"].dtype) == "int32"
    np.testing.assert_array_equal(out["fc0_bias"].asnumpy(),
                                  [-1, 2 ** 30 + 5, 7])


def test_sparse_records_raise_naming_their_item(tmp_path):
    path = tmp_path / "sparse.params"
    blob = bytearray(v2._fixture_blob())
    blob[28:32] = (1).to_bytes(4, "little")          # stype row_sparse
    path.write_bytes(bytes(blob))
    with pytest.raises(NotSupportedError, match="item 8"):
        mx.nd.load(str(path), ctx=mx.cpu())
    rsp = str(tmp_path / "rsp.nd")
    jmx.nd.save(rsp, {"r": jmx.nd.sparse.row_sparse_array(
        jmx.nd.array(np.eye(3, dtype=np.float32)))})
    with pytest.raises(NotSupportedError, match="item 8"):
        mx.nd.load(rsp, ctx=mx.cpu())
