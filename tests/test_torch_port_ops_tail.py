"""The rest of the op registry (the tail of ``ndarray/ops.py``), the
``nd`` namespace's ``moveaxis``/``shuffle`` and the NDArray method
surface, against ``mxnet_tpu.nd``, on the CPU.

Each case is one op with its arguments: the same numpy inputs (fixed
``RandomState`` seeds) go through ``mxnet_tpu.nd`` and
``mxnet_tpu_torch.nd``.  The test compares every output and its dtype
and, where the reference differentiates the op, the gradients of the
listed inputs under ``autograd.record()`` for a random head on each
floating output.  Tolerances:

- ``EXACT`` for integer, comparison, ordering, indexing, shape and copy
  ops (ties included: a sort's order among equal values, and so its
  gradient, is the reference's);
- ``F32``, 1e-5 relative (1e-6 absolute), for f32 arithmetic: sums,
  products and the vision ops' blends, taken in another order;
- ``TRANS``, 1e-6 relative and absolute, for transcendental ops (the
  rule of ``test_torch_port_ndarray.py``: XLA and torch approximate them
  an ulp or two apart);
- ``BF16``, 2**-8 relative, for the ``amp.init("bfloat16")`` cases.

The cases draw nothing; the ``shuffle`` test seeds the port's generator
and restores both packages' global generators after each test.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, amp, autograd

EXACT, F32, TRANS, BF16 = "exact", 1e-5, 1e-6, 2.0 ** -8

RNG = np.random.RandomState(21)
A = RNG.randn(3, 4).astype(np.float32)
B = RNG.randn(3, 4).astype(np.float32)
POS = (np.abs(A) + 0.5).astype(np.float32)
UNIT = (RNG.rand(3, 4) * 1.8 - 0.9).astype(np.float32)
GE1 = (POS + 1.0).astype(np.float32)
X3 = RNG.randn(2, 3, 4).astype(np.float32)
Y3 = RNG.randn(2, 4, 5).astype(np.float32)
X4 = RNG.randn(2, 6, 3, 5).astype(np.float32)
IMG = RNG.randn(2, 3, 6, 7).astype(np.float32)
INT = RNG.randint(-20, 20, (3, 4)).astype(np.int32)
INTP = RNG.randint(1, 30, (3, 4)).astype(np.int32)
INTQ = RNG.randint(1, 12, (3, 4)).astype(np.int32)
TIES = RNG.randint(0, 4, (3, 8)).astype(np.float32)
SPECIAL = np.array([np.nan, np.inf, -np.inf, 1.5, -2.0, 0.0], np.float32)
HALVES = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.4, -0.6], np.float32)
VEC = RNG.randn(5).astype(np.float32)
SEQ = RNG.randn(5, 3, 2).astype(np.float32)              # (T, B, C)
SEQ_BT = SEQ.transpose(1, 0, 2).copy()                   # (B, T, C)
SQ = RNG.randn(3, 3, 2).astype(np.float32)               # T == B
LENS = np.array([2, 5, 1], np.float32)
LENS3 = np.array([2, 3, 1], np.float32)
MASK3 = (RNG.rand(2, 3, 4) > 0.4).astype(np.float32)
MASK3[0, 1] = 0.0                                        # a row all masked
IDX_ND = np.array([[0, 1, -1, 1], [2, 0, 1, -3]], np.float32)
SORTED = np.sort(RNG.randn(6)).astype(np.float32)
THETA = (np.array([[0.9, 0.1, 0.05, -0.2, 1.1, -0.1],
                   [1.2, -0.3, 0.2, 0.25, 0.8, 0.1]]) +
         RNG.randn(2, 6) * 0.01).astype(np.float32)
GRID = (np.tanh(RNG.randn(2, 2, 4, 5)) * 1.15).astype(np.float32)
FLOW = RNG.randn(2, 2, 4, 5).astype(np.float32)


def _f(name, **kw):
    return lambda F, *a: getattr(F, name)(*a, **kw)


def _mat(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# id -> (call(F, *arrays), numpy inputs, indices of the inputs whose
# gradient is held, tolerance)
CASES = {}


def case(cid, call, inputs, grads=(), tol=EXACT):
    assert cid not in CASES, cid
    CASES[cid] = (call, inputs, grads, tol)


# ---- elementwise math and activations ----
for name, x in (("arcsin", UNIT), ("arccos", UNIT), ("arctan", A),
                ("sinh", A), ("cosh", A), ("arcsinh", A), ("arccosh", GE1),
                ("arctanh", UNIT), ("cbrt", A), ("rcbrt", POS),
                ("erfinv", UNIT), ("digamma", POS), ("gammaln", POS),
                ("gamma", POS), ("gelu", A), ("mish", A), ("selu", A),
                ("softrelu", A), ("log_sigmoid", A), ("silu", A),
                ("swish", A)):
    case(name, _f(name), [x], (0,), TRANS)
case("gamma-negative", _f("gamma"), [np.array([-0.5, -1.5, -2.3, 0.7],
                                              np.float32)], (0,), TRANS)
case("sinh-int", _f("sinh"), [INTQ // 4], (), TRANS)
for name in ("degrees", "radians"):
    case(name, _f(name), [A], (0,), EXACT)
    case(name + "-int", _f(name), [INT], (), EXACT)
case("fix", lambda F, a: F.fix(a * 3), [A], (0,))
case("fix-int", _f("fix"), [INT])
case("rint-half-even", _f("rint"), [HALVES], (0,))
case("relu6", lambda F, a: F.relu6(a * 4), [A], (0,))
case("hard_sigmoid", _f("hard_sigmoid", alpha=0.3, beta=0.4), [A], (0,),
     F32)
case("elu", _f("elu", alpha=0.7), [A], (0,), TRANS)
case("softmin", _f("softmin", axis=0), [A], (0,), TRANS)
case("SoftmaxActivation-channel", _f("SoftmaxActivation", mode="channel"),
     [X4], (0,), TRANS)
case("SoftmaxActivation-instance", _f("SoftmaxActivation"), [A], (0,),
     TRANS)
for name in ("isnan", "isinf", "isfinite", "isposinf", "isneginf"):
    case(name, _f(name), [SPECIAL])
case("nan_to_num", _f("nan_to_num"), [SPECIAL])
case("nan_to_num-values", _f("nan_to_num", nan=1.0, posinf=9.0,
                             neginf=-9.0), [SPECIAL])
case("hypot", _f("hypot"), [A, B], (0, 1), TRANS)
case("hypot-scalar", lambda F, a: F.hypot(a, 3.0), [A], (0,), TRANS)
case("broadcast_hypot", _f("broadcast_hypot"), [A[:, :1], B[:1]], (0, 1),
     TRANS)
case("arctan2", _f("arctan2"), [A, B], (0, 1), TRANS)
case("logical_xor", lambda F, a, b: F.logical_xor(a > 0, b > 0), [A, B])
case("logical_xor-scalar", lambda F, a: F.logical_xor(a > 0, 1), [A])
case("broadcast_logical_xor", lambda F, a, b: F.broadcast_logical_xor(
    a > 0, b > 0), [A[:, :1], B[:1]])
case("fmod", _f("fmod"), [A * 3, POS], (0, 1))
case("mod", lambda F, a: F.mod(a * 3, 0.7), [A], (0,))
case("mod-int", lambda F, a: F.mod(a, 7), [INT])
case("floor_divide", lambda F, a, b: F.floor_divide(a * 5, b), [A, POS])
case("floor_divide-int", _f("floor_divide"), [INT, INTQ])
case("true_divide", _f("true_divide"), [A, POS], (0, 1), F32)
case("true_divide-int", _f("true_divide"), [INT, INTQ])
case("divmod", lambda F, a, b: F.divmod(a * 5, b), [A, POS])
case("divmod-int", _f("divmod"), [INT, INTQ])
case("outer", _f("outer"), [A[0], B[1]], (0, 1))
case("inner", _f("inner"), [A, B], (0, 1), F32)
case("vdot", _f("vdot"), [A, B], (0, 1), F32)
case("kron", _f("kron"), [A[:2, :2], B], (0, 1), F32)
case("matmul", _f("matmul"), [X3, Y3], (0, 1), F32)
case("tensordot", _f("tensordot", axes=1), [X3, Y3[0]], (0, 1), F32)
case("tensordot-axes", _f("tensordot", axes=([1, 2], [0, 1])),
     [X3, _mat(3, 3, 4, 2)], (0, 1), F32)
for name, a, b in (("gcd", INT, INTP), ("lcm", INTQ, INTP),
                   ("bitwise_and", INT, INTP), ("bitwise_or", INT, INTP),
                   ("bitwise_xor", INT, INTP), ("left_shift", INT, INTQ),
                   ("right_shift", INT, INTQ // 3)):
    case(name, _f(name), [a, b])
case("gcd-scalar", lambda F, a: F.gcd(a, 6), [INT])
case("left_shift-scalar", lambda F, a: F.left_shift(a, 3), [INT])
case("bitwise_not", _f("bitwise_not"), [INT])
case("invert", _f("invert"), [INT])

# ---- scans, reductions and numerics ----
case("cumsum", _f("cumsum"), [A], (0,), F32)
case("cumsum-axis", _f("cumsum", axis=1), [X3], (0,), F32)
case("cumsum-int", _f("cumsum", axis=0), [INT])
case("cumsum-dtype", _f("cumsum", axis=1, dtype="float16"), [A], (), 1e-3)
case("cumprod", _f("cumprod", axis=0), [POS], (0,), F32)
case("cumprod-flat", _f("cumprod"), [INTQ // 3])
case("nanprod", _f("nanprod", axis=1), [np.where(A > 1, np.nan, POS)
                                        .astype(np.float32)], (0,), F32)
case("nanprod-all", _f("nanprod"), [POS], (0,), F32)
case("mp_sum", _f("mp_sum", axis=0), [A], (0,), F32)
case("moments", _f("moments", axes=(0, 2)), [X3], (0,), F32)
case("moments-keepdims", _f("moments", axes=(1,), keepdims=True), [X3],
     (0,), F32)
case("moments-all", _f("moments"), [A], (0,), F32)
case("ediff1d", _f("ediff1d", to_begin=[1.0, 2.0], to_end=3.0), [A], (0,))
case("ediff1d-plain", _f("ediff1d"), [INT])
XP = np.array([-1.0, -0.2, 0.3, 0.3, 1.4], np.float32)
case("interp", _f("interp"), [np.linspace(-2, 2, 11).astype(np.float32),
                              XP, VEC], (0, 2), F32)
case("interp-left-right", _f("interp", left=-5.0, right=7.0),
     [A, XP, VEC], (0, 2), F32)
case("polyval", _f("polyval"), [VEC[:4], A], (0, 1), F32)
case("searchsorted", _f("searchsorted"), [SORTED, A])
case("searchsorted-right", _f("searchsorted", side="right"),
     [SORTED, np.concatenate([SORTED[:3], A[0]])])
case("digitize", _f("digitize"), [A, SORTED])
case("digitize-right", _f("digitize", right=True),
     [np.concatenate([SORTED, A[0]]), SORTED])
case("digitize-decreasing", _f("digitize"), [A, SORTED[::-1].copy()])
# the counts exact; the edges are a linspace, which XLA computes with
# fused multiply-adds of its own choosing (an ulp apart, as nd.linspace)
for cid, kw, x in (("histogram", dict(bins=5), A),
                   ("histogram-range", dict(bins=4, range=(-1.0, 1.0)), A),
                   ("histogram-flat", dict(bins=3),
                    np.full((4,), 2.0, np.float32))):
    case(cid, lambda F, a, kw=kw: F.histogram(a, **kw)[0], [x])
    case(cid + "-edges", lambda F, a, kw=kw: F.histogram(a, **kw)[1], [x],
         (), TRANS)
case("histogram-given-edges", _f("histogram", bins=np.array(
    [-2.0, -0.5, 0.0, 0.5, 3.0], np.float32)), [A])
case("bincount", _f("bincount"), [INTP.reshape(-1)])
case("bincount-weights", _f("bincount", minlength=40),
     [INTP.reshape(-1), A.reshape(-1)])
case("bincount-negative", _f("bincount", minlength=3),
     [np.array([-1, 0, 2, 2, -4], np.int32)])
case("unique", _f("unique"), [TIES])

# ---- ordering ----
for axis in (-1, 0):
    for asc in (True, False):
        tag = f"{'asc' if asc else 'desc'}-axis{axis}"
        case(f"sort-{tag}", _f("sort", axis=axis, is_ascend=asc), [TIES],
             (0,))
        case(f"argsort-{tag}", _f("argsort", axis=axis, is_ascend=asc),
             [TIES])
        case(f"topk-{tag}", _f("topk", axis=axis, k=2, ret_typ="both",
                               is_ascend=asc), [TIES], (0,))
case("sort-flat", _f("sort", axis=None), [TIES], (0,))
case("argsort-int32", _f("argsort", dtype="int32"), [A])
case("topk-indices", _f("topk", k=3), [TIES])
case("topk-value", _f("topk", k=3, ret_typ="value"), [TIES], (0,))
case("topk-int32", _f("topk", k=4, ret_typ="both", dtype="int32"), [A],
     (0,))
case("topk-3d-axis1", _f("topk", axis=1, k=2, ret_typ="both"), [X3], (0,))
case("argmax_channel", _f("argmax_channel"), [X4])

# ---- indexing and shaping ----
case("gather_nd", _f("gather_nd"), [X3, IDX_ND], (0,))
case("gather_nd-full", _f("gather_nd"),
     [A, np.array([[0, 2, 1], [3, 0, -1]], np.float32)], (0,))
case("scatter_nd", _f("scatter_nd", shape=(3, 4)),
     [VEC[:4], np.array([[0, 2, 2, 1], [1, 3, 3, 0]], np.float32)], (0,))
case("scatter_nd-rows", _f("scatter_nd", shape=(4, 4)),
     [A, np.array([[3, -1, 0]], np.float32)], (0,))
case("batch_take", _f("batch_take"), [A, np.array([0, 3, 1], np.float32)],
     (0,))
case("choose_element_0index", _f("choose_element_0index"),
     [A, np.array([2, 0, 3], np.float32)], (0,))
case("fill_element_0index", _f("fill_element_0index"),
     [A, VEC[:3], np.array([1, 3, 0], np.float32)], (0, 1))
for name in ("one_hot_encode", "onehot_encode"):
    case(name, lambda F, i, o, name=name: getattr(F, name)(i, o),
         [np.array([1, 4, 0], np.float32), np.zeros((3, 5), np.float32)])
case("ravel_multi_index", _f("ravel_multi_index", shape=(3, 4, 5)),
     [np.array([[0, 2, 1], [3, 0, 1], [4, 4, 0]], np.float32)])
case("unravel_index", _f("unravel_index", shape=(3, 4)),
     [np.array([0, 5, 11, 13, -1, -3, 7], np.float32)])
case("slice_like", _f("slice_like", axes=(1, 2)),
     [X3, np.zeros((1, 2, 3), np.float32)], (0,))
case("slice_like-all", _f("slice_like"), [A, np.zeros((2, 3), np.float32)],
     (0,))
for k in (0, 1, -1):
    case(f"diag-matrix-{k}", _f("diag", k=k), [A], (0,))
    case(f"diag-vector-{k}", _f("diag", k=k), [VEC], (0,))
case("diag-3d", _f("diag", k=1), [X3], (0,))
case("tril", _f("tril", k=1), [A], (0,))
case("triu", _f("triu", k=-1), [X3], (0,))
case("trace", _f("trace"), [A], (0,), F32)
case("trace-offset", _f("trace", offset=1, axis1=1, axis2=2), [X3], (0,),
     F32)
case("trace-int", _f("trace"), [INT])
case("reverse", _f("reverse", axis=1), [A], (0,))
case("SwapAxis", _f("SwapAxis", dim1=0, dim2=2), [X3], (0,))
case("rot90", _f("rot90"), [A], (0,))
case("rot90-axes", _f("rot90", k=3, axes=(1, 2)), [X3], (0,))
case("shape_array", _f("shape_array"), [X3])
case("size_array", _f("size_array"), [X3])
case("arange_like", _f("arange_like"), [X3])
case("arange_like-repeat", _f("arange_like", start=1.0, step=0.5,
                              repeat=2), [X3])
case("arange_like-axis", _f("arange_like", start=2.0, axis=1), [X3])
case("arange_like-int", _f("arange_like", step=3.0), [INT])
case("full_like", _f("full_like", fill_value=2.5), [A])
case("full_like-dtype", _f("full_like", fill_value=3, dtype="int32"), [A])
case("khatri_rao", _f("khatri_rao"), [_mat(4, 3, 2), _mat(5, 4, 2)],
     (0, 1), F32)
case("khatri_rao-three", _f("khatri_rao"),
     [_mat(4, 3, 2), _mat(5, 2, 2), _mat(6, 2, 2)], (0, 1, 2), F32)
for name in ("hstack", "vstack", "dstack"):
    case(name, _f(name), [A, B], (0, 1))
case("hstack-list", lambda F, a, b: F.hstack([a, b]), [VEC, VEC[:2]],
     (0, 1))
case("hsplit", _f("hsplit", indices_or_sections=2), [A], (0,))
case("hsplit-indices", _f("hsplit", indices_or_sections=[1, 3]), [A], (0,))
case("hsplit-one", _f("hsplit", indices_or_sections=1), [A], (0,))
case("vsplit", _f("vsplit", indices_or_sections=[2]), [A], (0,))
case("meshgrid-xy", _f("meshgrid"), [VEC[:3], VEC, VEC[:2]], (0, 1, 2),
     F32)
case("meshgrid-ij", _f("meshgrid", indexing="ij"), [VEC[:3], VEC], (0, 1),
     F32)
case("meshgrid-one", _f("meshgrid"), [VEC], (0,))
case("embedding", _f("embedding"), [np.array([[1, 0], [3, 2]], np.float32),
                                    A.T.copy()], (1,))

# ---- sequence ops ----
for name in ("SequenceMask", "sequence_mask"):
    case(f"{name}-axis0", _f(name, use_sequence_length=True, value=-1.0),
         [SEQ, LENS], (0,))
case("SequenceMask-axis1", _f("SequenceMask", use_sequence_length=True,
                              axis=1), [SEQ_BT, LENS], (0,))
case("SequenceMask-no-lengths", _f("SequenceMask"), [SEQ], (0,))
for name in ("SequenceLast", "sequence_last"):
    case(f"{name}-axis0", _f(name, use_sequence_length=True), [SEQ, LENS],
         (0,))
case("SequenceLast-axis1", _f("SequenceLast", use_sequence_length=True,
                              axis=1), [SEQ_BT, LENS], (0,))
case("SequenceLast-no-lengths", _f("SequenceLast", axis=1), [SEQ_BT], (0,))
for name in ("SequenceReverse", "sequence_reverse"):
    case(f"{name}-axis0", _f(name, use_sequence_length=True), [SEQ, LENS],
         (0,))
case("SequenceReverse-axis1", _f("SequenceReverse", use_sequence_length=True,
                                 axis=1), [SQ, LENS3], (0,))
case("SequenceReverse-no-lengths", _f("SequenceReverse", axis=1), [SEQ_BT],
     (0,))

# ---- vision and neural-network ops ----
case("masked_softmax", _f("masked_softmax"), [X3, MASK3], (0,), TRANS)
case("masked_softmax-axis", _f("masked_softmax", axis=1, temperature=0.5),
     [X3, MASK3], (0,), TRANS)
for mode in ("instance", "channel", "spatial"):
    case(f"L2Normalization-{mode}", _f("L2Normalization", mode=mode),
         [X4], (0,), F32)
case("LRN", _f("LRN", nsize=3, alpha=0.1, beta=0.6, knorm=1.5), [X4], (0,),
     F32)
case("LRN-default", _f("LRN"), [X4], (0,), F32)
case("UpSampling-nearest", _f("UpSampling", scale=2), [X4], (0,))
case("UpSampling-two", _f("UpSampling", scale=3, num_args=2),
     [X4, X4[:, :2].copy()], (0, 1))
case("UpSampling-bilinear", _f("UpSampling", scale=2,
                               sample_type="bilinear"), [X4], (0,), F32)
case("Crop-h_w", _f("Crop", h_w=(2, 3), offset=(1, 1)), [X4], (0,))
case("Crop-center", _f("Crop", h_w=(1, 3), center_crop=True), [X4], (0,))
case("Crop-like", _f("Crop", num_args=2), [X4, np.zeros((1, 1, 2, 2),
                                                        np.float32)], (0,))
case("Correlation", _f("Correlation", max_displacement=2, pad_size=2),
     [IMG, _mat(7, 2, 3, 6, 7)], (0, 1), F32)
case("Correlation-strides", _f("Correlation", max_displacement=2,
                               stride1=2, stride2=2, pad_size=1),
     [IMG, _mat(8, 2, 3, 6, 7)], (0, 1), F32)
case("Correlation-abs", _f("Correlation", max_displacement=1, pad_size=1,
                           is_multiply=False),
     [IMG, _mat(9, 2, 3, 6, 7)], (0, 1), F32)
case("GridGenerator-affine", _f("GridGenerator", target_shape=(4, 5)),
     [THETA], (0,), F32)
case("BilinearSampler", _f("BilinearSampler"), [IMG, GRID], (0, 1), F32)
case("SpatialTransformer", _f("SpatialTransformer", target_shape=(5, 4)),
     [IMG, THETA], (0, 1), F32)
IM2COL = dict(kernel=(3, 3), stride=(2, 1), pad=(1, 1), dilate=(1, 2))
# a patch is a copy, but its gradient sums the overlaps in another order
case("im2col", _f("im2col", **IM2COL), [IMG], (0,), F32)
case("im2col-plain", _f("im2col", kernel=(2, 2)), [IMG], (0,), F32)
case("im2col-1d", _f("im2col", kernel=(3,), stride=(2,), pad=(1,)),
     [X3], (0,), F32)
case("col2im", _f("col2im", output_size=(6, 7), **IM2COL),
     [_mat(10, 2, 27, 15)], (0,), F32)
case("col2im-1d", _f("col2im", output_size=4, kernel=(3,), stride=(2,),
                     pad=(1,)), [_mat(11, 2, 9, 2)], (0,), F32)

# ---- casts ----
case("amp_cast", _f("amp_cast", dtype="float16"), [A], (0,))
case("amp_multicast", _f("amp_multicast", num_outputs=2),
     [A.astype(np.float16), B], (0, 1))
case("amp_multicast-narrow", _f("amp_multicast", cast_narrow=True),
     [A.astype(np.float16), B], (0, 1))


# ---- control flow ----
def _foreach(F, x, s):
    return F.foreach(lambda xt, st: (xt * 2 + st[0], [st[0] + xt, st[1] * xt]),
                     x, [s, s + 1])


def _foreach_lists(F, x, y, s):
    return F.foreach(lambda xs, st: ([xs[0] + xs[1], xs[0] * st], st + xs[1]),
                     [x, y], s)


case("foreach", _foreach, [SEQ, SEQ[0]])
case("foreach-lists", _foreach_lists, [SEQ, SEQ * 2, SEQ[0]])
case("cond-then", lambda F, p, a: F.cond(p, lambda: a * 2, lambda: a - 1),
     [np.array([1.0], np.float32), A])
case("cond-else", lambda F, p, a: F.cond(p > 0, lambda: a * 2,
                                         lambda: a - 1),
     [np.array([-1.0], np.float32), A])
case("while_loop", lambda F, i, a: F.while_loop(
    lambda j, s: j < 4, lambda j, s: (s * j, [j + 1, s + j]), [i, a],
    max_iterations=10), [np.array([0.0], np.float32), A])
case("while_loop-capped", lambda F, i, a: F.while_loop(
    lambda j, s: j < 10, lambda j, s: ([s, s * 2], [j + 1, s + 1]), [i, a],
    max_iterations=3), [np.array([0.0], np.float32), A])


def _flat(out):
    if out is None:
        return []
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out] if hasattr(out, "asnumpy") else []


def _dt(a):
    return str(a.dtype)


def _floating(a):
    return _dt(a) in ("float16", "float32", "float64", "bfloat16")


def _run(pkg, call, inputs, grads):
    """``call``'s outputs and the gradients of ``grads`` for the loss
    ``sum(head * out)`` over the floating outputs."""
    arrs = [pkg.nd.array(x, dtype=x.dtype) for x in inputs]
    for i in grads:
        arrs[i].attach_grad()
    if grads:
        with pkg.autograd.record():
            outs = _flat(call(pkg.nd, *arrs))
            floats = [o for o in outs if _floating(o)]
            loss = None
            for o, h in zip(floats, _heads(floats)):
                term = (o.astype("float32") * pkg.nd.array(h)).sum()
                loss = term if loss is None else loss + term
        loss.backward()
        return outs, [arrs[i].grad for i in grads]
    return _flat(call(pkg.nd, *arrs)), []


def _heads(outs):
    rng = np.random.RandomState(7)
    return [np.asarray(rng.randn(*o.shape), np.float32) for o in outs]


def _close(got, want, tol, what):
    got, want = got.asnumpy(), want.asnumpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tol == EXACT:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(
            got.astype(np.float64), want.astype(np.float64), rtol=tol,
            atol=1e-6 if tol != BF16 else tol, err_msg=what)


def _check(call, inputs, grads, tol):
    jout, jgrads = _run(jmx, call, inputs, grads)
    with mx.cpu():
        pout, pgrads = _run(mx, call, inputs, grads)
    assert len(pout) == len(jout)
    for k, (p, j) in enumerate(zip(pout, jout)):
        assert _dt(p) == _dt(j), (k, _dt(p), _dt(j))
        _close(p, j, tol, f"output {k}")
    for i, p, j in zip(grads, pgrads, jgrads):
        _close(p, j, tol, f"gradient of input {i}")


@pytest.mark.parametrize("cid", sorted(CASES))
def test_op_matches_reference(cid):
    _check(*CASES[cid])


def test_every_reference_op_is_ported_but_rnn():
    from mxnet_tpu.ndarray import ops as jops
    ops = mx.nd.ops
    # RNN too, since gluon.rnn is ported (tests/test_torch_port_rnn.py)
    assert ops._REFERENCE_OPS - set(ops._OPS) == set()
    assert set(jops.__all__) <= ops._REFERENCE_OPS
    assert mx.nd.RNN is ops._OPS["RNN"]


def test_method_surface_and_namespace():
    """Every method the reference builds from its registry exists and
    forwards to its op; ``moveaxis`` and ``shuffle`` resolve."""
    from mxnet_tpu.ndarray import _METHOD_FORWARD_OPS
    from mxnet_tpu_torch.ndarray import NDArray
    missing = [n for n in _METHOD_FORWARD_OPS if not hasattr(NDArray, n)]
    assert not missing
    with mx.cpu():
        x = mx.nd.array(TIES)
        for name, kw in (("sort", {}), ("diag", {}), ("erfinv", {}),
                         ("argsort", {"is_ascend": False}),
                         ("nanprod", {"axis": 1}), ("cbrt", {})):
            got = getattr(x if name != "erfinv" else x / 4, name)(**kw)
            want = getattr(mx.nd, name)(x if name != "erfinv" else x / 4,
                                        **kw)
            np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        mean, var = x.moments(axes=(1,))
        jm, jv = jmx.nd.array(TIES).moments(axes=(1,))
        np.testing.assert_allclose(mean.asnumpy(), jm.asnumpy(), rtol=F32)
        np.testing.assert_allclose(var.asnumpy(), jv.asnumpy(), rtol=F32)
        moved = mx.nd.moveaxis(mx.nd.array(X3), 0, -1)
        np.testing.assert_array_equal(
            moved.asnumpy(), jmx.nd.moveaxis(jmx.nd.array(X3), 0,
                                             -1).asnumpy())
        assert mx.nd.shuffle is mx.nd.random.shuffle


@pytest.fixture
def _keep_the_global_generators():
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


def test_shuffle_permutes_rows(_keep_the_global_generators):
    with mx.cpu():
        mx.random.seed(5)
        x = mx.nd.array(np.arange(40, dtype=np.float32).reshape(10, 4))
        y = mx.nd.shuffle(x).asnumpy()
        mx.random.seed(5)
        again = mx.nd.shuffle(x).asnumpy()
    np.testing.assert_array_equal(y, again)
    np.testing.assert_array_equal(np.sort(y[:, 0]), x.asnumpy()[:, 0])
    np.testing.assert_array_equal(y % 4, np.tile(np.arange(4), (10, 1)))


def test_data_dependent_ops_detach_and_fail_like_the_reference():
    with mx.cpu():
        x = mx.nd.array(A)
        x.attach_grad()
        with autograd.record():
            counts, edges = mx.nd.histogram(x, bins=3)
            u = mx.nd.unique(x)
        assert counts.data.grad_fn is None and u.data.grad_fn is None
        with pytest.raises(MXNetError, match="sorter"):
            mx.nd.searchsorted(x, x, sorter=x)
        with pytest.raises(MXNetError, match="Crop"):
            mx.nd.Crop(mx.nd.array(X4))
        with pytest.raises(MXNetError, match="broadcast"):
            mx.nd.SequenceReverse(mx.nd.array(SEQ_BT), mx.nd.array(LENS),
                                  use_sequence_length=True, axis=1)
        with pytest.raises(MXNetError, match="kernel_size"):
            mx.nd.Correlation(mx.nd.array(IMG), mx.nd.array(IMG),
                              kernel_size=3)


def test_nan_to_num_in_place():
    for pkg in (jmx, mx):
        with (mx.cpu() if pkg is mx else _Null()):
            x = pkg.nd.array(SPECIAL)
            out = pkg.nd.nan_to_num(x, copy=False)
            assert out is x
            assert np.isfinite(x.asnumpy()).all()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def _amp_both():
    jamp.init("bfloat16")
    amp.init("bfloat16")
    yield
    jamp._deinit_for_tests()
    amp._deinit_for_tests()


AMP_CASES = {
    "cumsum": (_f("cumsum", axis=1), [A]),
    "softmin": (_f("softmin"), [A]),
    "L2Normalization": (_f("L2Normalization"), [X4]),
    "gammaln": (_f("gammaln"), [POS]),
    "nanprod": (_f("nanprod", axis=0), [POS]),
    "gelu": (_f("gelu"), [A]),
    "masked_softmax": (_f("masked_softmax"), [X3, MASK3]),
}


@pytest.mark.parametrize("cid", sorted(AMP_CASES))
def test_op_under_amp_matches_reference(cid, _amp_both):
    """Under both packages' ``amp.init("bfloat16")`` on bf16 inputs: the
    fp32-list ops cast up to float32, the others stay in bf16."""
    call, inputs = AMP_CASES[cid]
    jx = [jmx.nd.array(x, dtype="bfloat16") for x in inputs]
    with mx.cpu():
        px = [mx.nd.array(x, dtype="bfloat16") for x in inputs]
        pout = _flat(call(mx.nd, *px))
    jout = _flat(call(jmx.nd, *jx))
    for p, j in zip(pout, jout):
        assert _dt(p) == _dt(j)
        _close(p, j, BF16, cid)


def test_grid_generator_warp_and_one_input_multicast():
    """Two forms the reference cannot run (its ``GridGenerator`` warp
    calls the registry's ``max`` reduction on Python ints, and its
    ``amp_multicast`` wraps a one-input call's tuple): the port's warp
    grid is each position plus its flow, scaled to [-1, 1], and a
    one-input multicast is that input."""
    b, _, h, w = FLOW.shape
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    want = np.stack([(gx + FLOW[:, 0]) * (2.0 / (w - 1)) - 1.0,
                     (gy + FLOW[:, 1]) * (2.0 / (h - 1)) - 1.0], 1)
    with mx.cpu():
        got = mx.nd.GridGenerator(mx.nd.array(FLOW), transform_type="warp")
        one = mx.nd.amp_multicast(mx.nd.array(A))
    np.testing.assert_allclose(got.asnumpy(), want, rtol=F32, atol=1e-6)
    np.testing.assert_array_equal(one.asnumpy(), A)
