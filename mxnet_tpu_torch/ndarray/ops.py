"""The operator library: MXNet op names and semantics over PyTorch.

Counterpart of ``mxnet_tpu/ndarray/ops.py``, the subset the training
surface and BERT call: the neural-network ops (``FullyConnected``,
``Activation``, ``LeakyReLU`` with exact-erf GELU, ``softmax``,
``log_softmax``, ``Dropout``, ``LayerNorm``, ``Embedding``), the
products (``dot``, ``batch_dot``, ``linalg_gemm2``), the shape ops, the
gathers (``take``, ``pick``, ``one_hot``, ``gather_positions``),
``where``, the elementwise unary and binary ops and the reductions;
and the ops of convolutional nets: ``Convolution``, ``Deconvolution``,
``Pooling``, ``BatchNorm``, ``InstanceNorm``, ``GroupNorm``,
``Pad``/``pad``, ``space_to_depth`` and ``depth_to_space``.  Every op
runs through ``ndarray.apply`` (so only ``autograd.record()`` builds a
graph) and is listed in ``_OPS`` by ``_register``, as in the reference.
Where XLA fused these ops for free they are plain PyTorch, and the
convolutions and pooling windows torch's calls: none is a TPU kernel.

Under ``amp.init()`` the registry casts an op's floating inputs by the
reference's lists (``amp/lists.py``), as the reference's ``amp.init``
patches its registry: ``TARGET_DTYPE_OPS`` to the target dtype,
``FP32_OPS`` to float32, ``WIDEST_TYPE_CASTS`` to the widest input
dtype; the op itself runs with autocast off, so it computes the same on
the CPU and on the card.

Every other op name of the reference's registry (``_REFERENCE_OPS``)
raises ``NotSupportedError`` naming ROADMAP §1 item 8, through the
``nd`` namespace's ``__getattr__``.
"""
from __future__ import annotations

import builtins as _builtins
import functools
import math

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError, NotSupportedError
from .. import _tape, amp as _amp
from ..amp import lists as _lists
from .ndarray import NDArray, apply, _dtype_of, array, zeros, ones, full, \
    arange

__all__ = []          # filled by _register
_OPS = {}             # op name -> the registered function


def _amp_modes(low_extra=(), fp32_extra=()):
    """Op name -> ``"low"``/``"fp32"``/``"widest"``: the reference's
    lists extended as its ``amp.init`` extends them (``low`` wins over
    ``fp32``, both over ``widest``)."""
    low = set(_lists.TARGET_DTYPE_OPS) | set(low_extra)
    fp32 = (set(_lists.FP32_OPS) | set(fp32_extra)) - low
    widest = set(_lists.WIDEST_TYPE_CASTS) - low - fp32
    modes = dict.fromkeys(widest, "widest")
    modes.update(dict.fromkeys(fp32, "fp32"))
    modes.update(dict.fromkeys(low, "low"))
    return modes


_AMP_MODE = _amp_modes()
_PLAIN = {}           # op name -> the function without its amp wrapper

# every op name of the reference's registry; those the port lacks raise
# NotSupportedError when looked up (ROADMAP §1 item 8)
_REFERENCE_OPS = frozenset("""
Activation BatchNorm BilinearSampler BlockGrad CTCLoss Concat Convolution
Correlation Crop Deconvolution Dropout ElementWiseSum Embedding Flatten
FullyConnected GridGenerator GroupNorm IdentityAttachKLSparseReg
InstanceNorm L2Normalization LRN LayerNorm LeakyReLU LinearRegressionOutput
LogisticRegressionOutput MAERegressionOutput MakeLoss Pad Pooling RNN
Reshape SVMOutput SequenceLast SequenceMask SequenceReverse SliceChannel
SoftmaxActivation SoftmaxOutput SpatialTransformer SwapAxis UpSampling abs
adagrad_update adam_update adamax_update add add_n all_finite amp_cast
amp_multicast arange_like arccos arccosh arcsin arcsinh arctan arctan2
arctanh argmax argmax_channel argmin argsort batch_dot batch_take bincount
bitwise_and bitwise_not bitwise_or bitwise_xor broadcast_add broadcast_axes
broadcast_axis broadcast_div broadcast_equal broadcast_greater
broadcast_greater_equal broadcast_hypot broadcast_lesser
broadcast_lesser_equal broadcast_like broadcast_logical_and
broadcast_logical_or broadcast_logical_xor broadcast_maximum
broadcast_minimum broadcast_mod broadcast_mul broadcast_not_equal
broadcast_power broadcast_sub broadcast_to cast cbrt ceil
choose_element_0index clip col2im concat cond cos cosh ctc_loss cumprod
cumsum degrees depth_to_space diag digamma digitize divide divmod dot
dstack ediff1d elemwise_add elemwise_div elemwise_mul elemwise_sub elu
embedding equal erf erfinv exp expand_dims expm1 fill_element_0index fix
flatten flip floor floor_divide fmod foreach ftml_update ftrl_update
full_like fully_connected gamma gammaln gather_nd gather_positions gcd gelu
greater greater_equal hard_sigmoid histogram hsplit hstack hypot identity
im2col inner interp invert isfinite isinf isnan isneginf isposinf
khatri_rao kron lamb_update_phase1 lamb_update_phase2 lcm left_shift lesser
lesser_equal linalg_gemm2 log log10 log1p log2 log_sigmoid log_softmax
logical_and logical_not logical_or logical_xor masked_softmax matmul max
max_axis maximum mean meshgrid min min_axis minimum mish mod modulo moments
mp_lamb_update_phase1 mp_lamb_update_phase2 mp_nag_mom_update
mp_sgd_mom_update mp_sgd_update mp_sum multi_all_finite multi_lamb_update
multi_lars multi_mp_sgd_mom_update multi_mp_sgd_update multi_sgd_mom_update
multi_sgd_update multi_sum_sq multiply nadam_update nag_mom_update
nan_to_num nanprod nansum negative norm not_equal one_hot one_hot_encode
onehot_encode ones_like outer pad pick polyval power
preloaded_multi_mp_sgd_mom_update preloaded_multi_mp_sgd_update
preloaded_multi_sgd_mom_update preloaded_multi_sgd_update prod radians
random_normal random_pdf_dirichlet random_pdf_exponential random_pdf_gamma
random_pdf_generalized_negative_binomial random_pdf_negative_binomial
random_pdf_normal random_pdf_poisson random_pdf_uniform random_uniform
ravel_multi_index rcbrt reciprocal relu relu6 repeat reset_arrays reshape
reverse right_shift rint rmsprop_update rmspropalex_update rot90 round
rsqrt sample_exponential sample_gamma sample_generalized_negative_binomial
sample_multinomial sample_negative_binomial sample_normal sample_poisson
sample_uniform scatter_nd searchsorted selu sequence_last sequence_mask
sequence_reverse sgd_mom_update sgd_update shape_array sigmoid sign
signsgd_update signum_update silu sin sinh size_array slice slice_axis
slice_like smooth_l1 softmax softmax_cross_entropy softmin softrelu
softsign sort space_to_depth split sqrt square squeeze stack stop_gradient
subtract sum sum_axis swapaxes swish take tan tanh tensordot tile topk
trace transpose tril triu true_divide trunc unique unravel_index vdot
vsplit vstack where while_loop zeros_like
""".split())


def _amp_dtype(mode, args, kwargs):
    """The dtype the reference's ``amp`` wrapper casts an op's floating
    NDArray inputs to (None: no cast)."""
    if mode == "low":
        return _amp._DTYPES[_amp._target_dtype]
    if mode == "fp32":
        return torch.float32
    dts = [x._data.dtype for x in list(args) + list(kwargs.values())
           if isinstance(x, NDArray) and x._data.is_floating_point()]
    return functools.reduce(torch.promote_types, dts) if dts else None


def _amp_op(fn, name):
    """``fn`` with the amp cast of ``name``'s mode: while the policy is
    on, ``_tape.run`` casts the op's floating inputs inside the op's own
    recorded call, so the cast costs no op of its own."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        mode = None if _amp._target_dtype is None else _AMP_MODE.get(name)
        if mode is None:
            return fn(*args, **kwargs)
        state = _tape._STATE
        prev = state.cast
        state.cast = _amp_dtype(mode, args, kwargs)
        try:
            return fn(*args, **kwargs)
        finally:
            state.cast = prev
    return op


def _register(fn, name=None):
    """List ``fn`` in the registry under ``name`` (default: its own),
    with the amp cast when ``name`` is on the lists."""
    name = name or fn.__name__
    op = _amp_op(fn, name) if name in _AMP_MODE else fn
    _PLAIN[name] = fn
    _OPS[name] = op
    __all__.append(name)
    return op


def set_amp_lists(target_precision_ops=(), fp32_ops=()):
    """Extend the reference's lists (``amp.init``'s op-list arguments;
    no arguments: the reference's own lists again) and rebind each
    registered op whose wrapping changes, here and in the ``nd``
    namespace, as the reference's ``amp.init`` patches its registry."""
    import sys
    _AMP_MODE.clear()
    _AMP_MODE.update(_amp_modes(target_precision_ops, fp32_ops))
    modules = [sys.modules[__name__], sys.modules[__package__]]
    for name, fn in _PLAIN.items():
        op = _OPS[name]
        if (name in _AMP_MODE) == (op is not fn):
            continue
        new = _amp_op(fn, name) if name in _AMP_MODE else fn
        _OPS[name] = new
        for mod in modules:
            if getattr(mod, name, None) is op:
                setattr(mod, name, new)


def _alias(name, op):
    _OPS[name] = op
    __all__.append(name)
    return op


def _nd(x, like=None):
    if isinstance(x, NDArray):
        return x
    if torch.is_tensor(x):
        return NDArray(x)
    return array(x, ctx=like.context if like is not None else None)


def later(name):
    """The error for a reference op that is not ported yet."""
    return NotSupportedError(
        f"op {name!r} is not ported yet: the rest of ndarray/ops.py arrives "
        "with ROADMAP §1 item 8")


# ===========================================================================
# elementwise unary
# ===========================================================================

def _unary(name, tfn):
    def op(data, **kwargs):
        return apply(tfn, [data])
    op.__name__ = name
    op.__doc__ = f"Elementwise {name} (reference: elemwise_unary_op)."
    return _register(op)


relu = _unary("relu", torch.relu)
sigmoid = _unary("sigmoid", torch.sigmoid)
tanh = _unary("tanh", torch.tanh)
softsign = _unary("softsign", F.softsign)
exp = _unary("exp", torch.exp)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
expm1 = _unary("expm1", torch.expm1)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
square = _unary("square", torch.square)
abs = _unary("abs", torch.abs)
sign = _unary("sign", torch.sign)
round = _unary("round", torch.round)
ceil = _unary("ceil", torch.ceil)
floor = _unary("floor", torch.floor)
trunc = _unary("trunc", torch.trunc)
negative = _unary("negative", torch.neg)
reciprocal = _unary("reciprocal", torch.reciprocal)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
erf = _unary("erf", torch.erf)
zeros_like = _unary("zeros_like", torch.zeros_like)
ones_like = _unary("ones_like", torch.ones_like)
logical_not = _unary("logical_not", lambda t: (t == 0).float())


@_register
def identity(data):
    return apply(lambda t: t.clone(), [data])


@_register
def cast(data, dtype):
    dt = _dtype_of(dtype)
    return apply(lambda t: t.to(dt), [data])


@_register
def clip(data, a_min, a_max):
    return apply(lambda t: torch.clamp(t, a_min, a_max), [data])


@_register
def stop_gradient(data):
    return apply(lambda t: t.detach(), [data])


# ===========================================================================
# elementwise binary (broadcasting)
# ===========================================================================

def _binary(name, tfn):
    def op(lhs, rhs, **kwargs):
        lhs = _nd(lhs, rhs if isinstance(rhs, NDArray) else None)
        if isinstance(rhs, NDArray):
            return apply(tfn, [lhs, rhs])
        return apply(lambda a: tfn(a, rhs), [lhs])
    op.__name__ = name
    op.__doc__ = f"Broadcasting binary {name} (reference: " \
        "elemwise_binary_broadcast_op)."
    return _register(op)


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", torch.true_divide)
modulo = _binary("modulo", torch.fmod)
power = _binary("power", torch.pow)
maximum = _binary("maximum", lambda a, b: torch.maximum(
    a, torch.as_tensor(b, dtype=a.dtype, device=a.device)))
minimum = _binary("minimum", lambda a, b: torch.minimum(
    a, torch.as_tensor(b, dtype=a.dtype, device=a.device)))
equal = _binary("equal", lambda a, b: (a == b).float())
not_equal = _binary("not_equal", lambda a, b: (a != b).float())
greater = _binary("greater", lambda a, b: (a > b).float())
greater_equal = _binary("greater_equal", lambda a, b: (a >= b).float())
lesser = _binary("lesser", lambda a, b: (a < b).float())
lesser_equal = _binary("lesser_equal", lambda a, b: (a <= b).float())
logical_and = _binary("logical_and",
                      lambda a, b: ((a != 0) & (b != 0)).float())
logical_or = _binary("logical_or",
                     lambda a, b: ((a != 0) | (b != 0)).float())

# the broadcast_* names: torch broadcasts everywhere, as jax does
for _n, _op in (("add", add), ("sub", subtract), ("mul", multiply),
                ("div", divide), ("mod", modulo), ("power", power),
                ("maximum", maximum), ("minimum", minimum),
                ("equal", equal), ("not_equal", not_equal),
                ("greater", greater), ("greater_equal", greater_equal),
                ("lesser", lesser), ("lesser_equal", lesser_equal),
                ("logical_and", logical_and), ("logical_or", logical_or)):
    globals()["broadcast_" + _n] = _register(
        getattr(_op, "__wrapped__", _op), "broadcast_" + _n)
elemwise_add = _alias("elemwise_add", add)
elemwise_sub = _alias("elemwise_sub", subtract)
elemwise_mul = _alias("elemwise_mul", multiply)
elemwise_div = _alias("elemwise_div", divide)


def _add_n(*args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])

    def fn(*ts):
        out = ts[0]
        for t in ts[1:]:
            out = out + t
        return out
    return apply(fn, list(args))


add_n = _register(_add_n, "add_n")
ElementWiseSum = _alias("ElementWiseSum", add_n)


@_register
def where(condition, x, y):
    return apply(lambda c, a, b: torch.where(c != 0, a, b),
                 [_nd(condition), _nd(x), _nd(y)])


# ===========================================================================
# reductions
# ===========================================================================

def _axes(data, axis, exclude=False):
    if axis is None:
        return None
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    if exclude:
        axes = tuple(i for i in range(data.ndim)
                     if i not in tuple(a % data.ndim for a in axes))
    return axes


def _reduce(name, tfn):
    def op(data, axis=None, keepdims=False, exclude=False, **kwargs):
        ax = _axes(data, axis, exclude)

        def fn(t):
            if ax is None:
                out = tfn(t, tuple(range(t.dim())))
                return out.reshape((1,) * t.dim()) if keepdims else out
            return tfn(t, ax, keepdims)
        return apply(fn, [data])
    op.__name__ = name
    op.__doc__ = f"Reduction {name} (reference: broadcast_reduce_op)."
    return _register(op)


def _amax(t, dims, keepdim=False):
    return torch.amax(t, dims, keepdim) if dims else t.clone()


def _amin(t, dims, keepdim=False):
    return torch.amin(t, dims, keepdim) if dims else t.clone()


def _prod(t, dims, keepdim=False):
    out = t
    for d in sorted((d % t.dim() for d in dims), reverse=True):
        out = torch.prod(out, d, keepdim)
    return out


sum = _reduce("sum", lambda t, d, k=False: torch.sum(t, d, k))
mean = _reduce("mean", lambda t, d, k=False: torch.mean(t, d, k))
max = _reduce("max", _amax)
min = _reduce("min", _amin)
prod = _reduce("prod", _prod)
nansum = _reduce("nansum", lambda t, d, k=False: torch.nansum(t, d, k))
sum_axis = _alias("sum_axis", sum)
max_axis = _alias("max_axis", max)
min_axis = _alias("min_axis", min)


@_register
def norm(data, ord=2, axis=None, keepdims=False, **kwargs):
    """``ord`` 1 (sum of |x|) or 2 (L2) over ``axis`` (all by default)."""
    ax = _axes(data, axis)
    if ord not in (1, 2):
        raise MXNetError(f"norm only supports ord=1 or 2, got {ord}")

    def fn(t):
        dims = tuple(range(t.dim())) if ax is None else ax
        if ord == 1:
            return torch.sum(torch.abs(t), dims, keepdims)
        return torch.sqrt(torch.sum(torch.square(t), dims, keepdims))
    return apply(fn, [data])


@_register
def argmax(data, axis=None, keepdims=False):
    """Float32 indices, as the reference returns them."""
    return apply(lambda t: torch.argmax(t, axis, keepdims).float(), [data])


@_register
def argmin(data, axis=None, keepdims=False):
    return apply(lambda t: torch.argmin(t, axis, keepdims).float(), [data])


# ===========================================================================
# products
# ===========================================================================

@_register
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """mx.nd.dot: the last axis of ``lhs`` against the first of ``rhs``
    (``tensordot`` over one axis); a transpose reverses every axis."""
    def fn(a, b):
        if transpose_a:
            a = a.permute(*range(a.dim() - 1, -1, -1))
        if transpose_b:
            b = b.permute(*range(b.dim() - 1, -1, -1))
        if a.dim() == 1 and b.dim() == 1:
            return torch.dot(a, b)
        return torch.tensordot(a, b, dims=1)
    return apply(fn, [lhs, rhs])


@_register
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """(B, M, K) x (B, K, N) -> (B, M, N)."""
    def fn(a, b):
        if transpose_a:
            a = a.transpose(-1, -2)
        if transpose_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return apply(fn, [lhs, rhs])


@_register
def linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0):
    def fn(x, y):
        if transpose_a:
            x = x.transpose(-1, -2)
        if transpose_b:
            y = y.transpose(-1, -2)
        out = torch.matmul(x, y)
        return out if alpha == 1.0 else alpha * out
    return apply(fn, [a, b])


# ===========================================================================
# shape
# ===========================================================================

@_register
def reshape(data, shape, reverse=False):
    """MXNet reshape with the codes 0/-1/-2/-3/-4; ``reverse=True``
    matches the codes from the right."""
    if reverse:
        from .ndarray import _resolve_reshape
        spec = tuple(int(s) for s in shape)
        if -4 in spec:
            raise MXNetError("reshape(reverse=True) with -4 split is not "
                             "supported; write the split explicitly")
        new_shape = _resolve_reshape(tuple(data.shape)[::-1],
                                     spec[::-1])[::-1]
        return data.reshape(new_shape)
    return data.reshape(shape)


Reshape = _alias("Reshape", reshape)


@_register
def flatten(data):
    return data.flatten()


Flatten = _alias("Flatten", flatten)


@_register
def transpose(data, axes=None):
    return data.transpose(axes) if axes else data.transpose()


@_register
def expand_dims(data, axis):
    return data.expand_dims(axis)


@_register
def squeeze(data, axis=None):
    return data.squeeze(axis)


@_register
def swapaxes(data, dim1, dim2):
    return data.swapaxes(dim1, dim2)


@_register
def broadcast_to(data, shape):
    return data.broadcast_to(shape)


@_register
def broadcast_like(lhs, rhs):
    return lhs.broadcast_to(rhs.shape)


@_register
def broadcast_axis(data, axis, size):
    """Broadcast size-1 axes to the given sizes."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        if tgt[a] != 1:
            raise MXNetError(f"broadcast_axis: axis {a} has size "
                             f"{tgt[a]} != 1")
        tgt[a] = s
    return data.broadcast_to(tuple(tgt))


broadcast_axes = _alias("broadcast_axes", broadcast_axis)


def _concat(*data, dim=1):
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = tuple(data[0])
    return apply(lambda *ts: torch.cat(ts, dim), list(data))


def _stack(*data, axis=0):
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = tuple(data[0])
    return apply(lambda *ts: torch.stack(ts, axis), list(data))


concat = _register(_concat, "concat")
Concat = _alias("Concat", concat)
stack = _register(_stack, "stack")


@_register
def split(data, num_outputs, axis=1, squeeze_axis=False):
    """Split into ``num_outputs`` equal parts (reference SliceChannel)."""
    def fn(t):
        parts = torch.chunk(t, num_outputs, dim=axis)
        if squeeze_axis:
            parts = [p.squeeze(axis) for p in parts]
        return tuple(parts)
    if data.shape[axis] % num_outputs:
        raise MXNetError(f"split: axis {axis} of {data.shape} does not "
                         f"divide into {num_outputs}")
    outs = apply(fn, [data], n_out=num_outputs)
    return outs[0] if num_outputs == 1 else outs


SliceChannel = _alias("SliceChannel", split)


@_register
def slice(data, begin, end, step=None):
    """``data[begin:end:step]`` per axis (None: the whole axis)."""
    begin, end = tuple(begin), tuple(end)
    step = tuple(step) if step is not None else (1,) * len(begin)
    idx = tuple(_builtins.slice(b, e, s) for b, e, s in zip(begin, end, step))
    return apply(lambda t: t[idx + (Ellipsis,)], [data])


@_register
def slice_axis(data, axis, begin, end):
    def fn(t):
        sl = [_builtins.slice(None)] * t.dim()
        sl[axis] = _builtins.slice(begin, end)
        return t[tuple(sl)]
    return apply(fn, [data])


@_register
def tile(data, reps):
    return apply(lambda t: t.tile(tuple(reps)), [data])


@_register
def repeat(data, repeats, axis=None):
    if axis is None:
        return apply(lambda t: torch.repeat_interleave(t.reshape(-1),
                                                       repeats), [data])
    return apply(lambda t: torch.repeat_interleave(t, repeats, axis), [data])


@_register
def flip(data, axis):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return apply(lambda t: torch.flip(t, axes), [data])


# ===========================================================================
# gathers
# ===========================================================================

@_register
def take(a, indices, axis=0, mode="clip"):
    """``a``'s slices along ``axis`` at ``indices`` (any shape), clipped
    to the axis (``mode="wrap"``: modulo its size)."""
    idx = _nd(indices, a)

    def fn(t, i):
        n = t.shape[axis]
        ii = i.long()
        ii = torch.remainder(ii, n) if mode == "wrap" else \
            torch.clamp(ii, 0, n - 1)
        ax = axis % t.dim()
        out = torch.index_select(t, ax, ii.reshape(-1))
        return out.reshape(t.shape[:ax] + ii.shape + t.shape[ax + 1:])
    return apply(fn, [a, idx])


@_register
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """One element along ``axis`` per position, at ``index``."""
    idx = _nd(index, data)

    def fn(t, i):
        ax = axis % t.dim()
        ii = torch.clamp(i.long(), 0, t.shape[ax] - 1).unsqueeze(ax)
        out = torch.gather(t, ax, ii)
        return out if keepdims else out.squeeze(ax)
    return apply(fn, [data, idx])


@_register
def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    dt = _dtype_of(dtype)

    def fn(i):
        ii = i.long()
        valid = (ii >= 0) & (ii < depth)
        oh = F.one_hot(torch.where(valid, ii, 0), depth) * \
            valid.unsqueeze(-1)
        return (oh.to(dt) * (on_value - off_value) + off_value).to(dt)
    return apply(fn, [_nd(indices)])


@_register
def gather_positions(data, positions):
    """Rows at per-batch positions: data (B, L, C), positions (B, M) ->
    (B, M, C) (the MLM head's gather)."""
    def fn(t, p):
        idx = p.long().unsqueeze(-1).expand(-1, -1, t.shape[-1])
        return torch.gather(t, 1, idx)
    return apply(fn, [data, _nd(positions, data)])


@_register
def Embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False):
    """Rows of ``weight`` at the (int32) indices ``data``."""
    if sparse_grad:
        raise NotSupportedError(
            "Embedding(sparse_grad=True): row-sparse gradients arrive with "
            "the rest of the ops (ROADMAP §1 item 8)")
    return apply(lambda i, w: F.embedding(i.long() if i.is_floating_point()
                                          else i, w),
                 [_nd(data), _nd(weight)])


# ===========================================================================
# neural-network ops
# ===========================================================================

@_register
def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):
    """``data @ weight.T + bias``; ``weight`` is (out, in), MXNet's
    layout; ``flatten=True`` folds every axis after the first."""
    inputs = [data, weight] + ([] if no_bias or bias is None else [bias])

    def fn(d, w, *b):
        x = d.reshape(d.shape[0], -1) if flatten and d.dim() > 2 else d
        return F.linear(x, w, b[0] if b else None)
    return apply(fn, inputs)


fully_connected = _alias("fully_connected", FullyConnected)

_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign}


@_register
def Activation(data, act_type="relu"):
    if act_type not in _ACTIVATIONS:
        raise MXNetError(f"unknown act_type {act_type}")
    return apply(_ACTIVATIONS[act_type], [data])


def _gamma_shape(g, d):
    if g.dim() == 1 and d.dim() > 1:
        return g.reshape((1, -1) + (1,) * (d.dim() - 2))
    return g


@_register
def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334):
    """leaky, prelu, elu, selu and gelu (exact, through erf)."""
    if act_type == "leaky":
        return apply(lambda t: F.leaky_relu(t, slope), [data])
    if act_type == "elu":
        return apply(lambda t: F.elu(t, slope), [data])
    if act_type == "selu":
        return apply(F.selu, [data])
    if act_type == "gelu":
        return apply(lambda t: F.gelu(t, approximate="none"), [data])
    if act_type == "prelu":
        return apply(lambda t, g: torch.where(t >= 0, t,
                                              _gamma_shape(g, t) * t),
                     [data, gamma])
    raise MXNetError(f"unknown LeakyReLU act_type {act_type}")


@_register
def softmax(data, axis=-1, temperature=None, length=None):
    def fn(t):
        return torch.softmax(t / temperature if temperature else t, axis)
    return apply(fn, [data])


@_register
def log_softmax(data, axis=-1, temperature=None):
    def fn(t):
        return torch.log_softmax(t / temperature if temperature else t, axis)
    return apply(fn, [data])


@_register
def Dropout(data, p=0.5, mode="training", axes=None, cudnn_off=False):
    """In training (``autograd.is_training()``), zero each element (or,
    with ``axes``, each slice along them) with probability ``p`` and
    scale the rest by ``1 / (1 - p)``; the mask comes from the
    ``nd.random`` generator of the array's device.  Otherwise the
    input."""
    from . import random as _rnd
    if not _tape.is_training() or p <= 0:
        return data
    shape = data.shape
    if axes:
        shape = tuple(1 if i in axes else s for i, s in enumerate(shape))
    t = data._data
    gen = _rnd.generator(t.device)
    keep = torch.rand(shape, generator=gen, device=t.device) >= p

    def fn(d):
        return torch.where(keep, d / (1.0 - p), torch.zeros((), dtype=d.dtype,
                                                           device=d.device))
    return apply(fn, [data])


@_register
def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """``(x - mean) / sqrt(var + eps) * gamma + beta`` over ``axis``."""
    def fn(d, g, b):
        ax = axis % d.dim()
        if ax == d.dim() - 1:
            return F.layer_norm(d, (d.shape[-1],), g, b, eps)
        m = torch.mean(d, ax, keepdim=True)
        v = torch.mean(torch.square(d - m), ax, keepdim=True)
        shape = [1] * d.dim()
        shape[ax] = d.shape[ax]
        return (d - m) * torch.rsqrt(v + eps) * g.reshape(shape) + \
            b.reshape(shape)
    return apply(fn, [data, gamma, beta])


# ===========================================================================
# convolution, pooling, normalization, padding
# ===========================================================================
# The reference lowers these to plain XLA (``lax.conv_general_dilated``,
# ``lax.reduce_window``, ``jnp.mean``/``jnp.var``): here they are torch's
# convolution and pooling calls and plain tensor ops.  Data is NC[D]HW
# and a convolution weight OI[D]HW, MXNet's layout; ``layout`` is taken
# and ignored, as the reference's op ignores it.

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _spatial(value, nd, default):
    return tuple(value) if value else (default,) * nd


@_register
def Convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, workspace=None, layout=None, cudnn_off=False,
                cudnn_tune=None):
    """1-3 D convolution (reference: src/operator/nn/convolution.cc):
    stride, symmetric ``pad``, dilation, ``num_group`` groups and a bias;
    the output in the data's dtype."""
    nd = len(kernel) if kernel else weight.ndim - 2
    stride, dilate, pad = (_spatial(stride, nd, 1), _spatial(dilate, nd, 1),
                           _spatial(pad, nd, 0))
    inputs = [data, weight] + ([] if no_bias or bias is None else [bias])

    def fn(d, w, *b):
        return _CONV[nd](d, w, b[0].to(d.dtype) if b else None, stride, pad,
                         dilate, num_group)
    return apply(fn, inputs)


@_register
def Deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, target_shape=None,
                  num_filter=None, num_group=1, no_bias=True, workspace=None,
                  layout=None, cudnn_off=False, cudnn_tune=None):
    """Transposed convolution (reference: src/operator/nn/
    deconvolution.cc); the weight is ``(in, out / num_group, *kernel)``,
    torch's ``conv_transpose`` layout.  The output's size is ``(in - 1) *
    stride - 2 pad + dilate (kernel - 1) + 1 + adj``; ``target_shape``
    overrides ``adj`` and raises when no ``0 <= adj < stride`` reaches
    it."""
    nd = len(kernel) if kernel else weight.ndim - 2
    stride, dilate, pad = (_spatial(stride, nd, 1), _spatial(dilate, nd, 1),
                           _spatial(pad, nd, 0))
    keff = [dilate[i] * (weight.shape[2 + i] - 1) + 1 for i in range(nd)]
    if target_shape is not None:
        ts = tuple(target_shape)
        in_sp = data.shape[2:]
        adj = tuple(ts[i] - ((in_sp[i] - 1) * stride[i] - 2 * pad[i] +
                             keff[i]) for i in range(nd))
        if any(a < 0 or a >= stride[i] for i, a in enumerate(adj)):
            raise MXNetError(
                f"Deconvolution: target_shape {ts} unreachable from input "
                f"{tuple(in_sp)} with kernel/stride/pad/dilate given")
    adj = _spatial(adj, nd, 0)
    inputs = [data, weight] + ([] if no_bias or bias is None else [bias])
    # torch takes an output padding below the stride or the dilation; a
    # larger ``adj`` runs unpadded and is cropped (and zero-filled past
    # the last input's reach) to the size above
    direct = all(a < _builtins.max(s, dl)
                 for a, s, dl in zip(adj, stride, dilate))

    def fn(d, w, *b):
        bb = b[0].to(d.dtype) if b else None
        if direct:
            return _DECONV[nd](d, w, bb, stride, pad, adj, num_group, dilate)
        y = _DECONV[nd](d, w, None, stride, 0, 0, num_group, dilate)
        for i in range(nd):
            n = y.shape[2 + i]
            over = _builtins.max(adj[i] - pad[i], 0)
            if over:
                y = F.pad(y, (0, 0) * (nd - 1 - i) + (0, over))
            y = y.narrow(2 + i, pad[i], n - 2 * pad[i] + adj[i])
        return y if bb is None else y + bb.reshape((1, -1) + (1,) * nd)
    return apply(fn, inputs)


def _pool_pads(shape, k, s, p, full):
    """(before, after) padding of each spatial axis: ``full`` rounds the
    output size up (ceil division) and pads the right to fit it, with no
    rule that the last window start inside the input."""
    pads = []
    for i in range(len(k)):
        x = shape[2 + i] + 2 * p[i]
        extra = 0
        if full:
            out = -(-(x - k[i]) // s[i]) + 1
            extra = _builtins.max((out - 1) * s[i] + k[i] - x, 0)
        pads.append((p[i], p[i] + extra))
    return pads


def _torch_pads(pairs):
    """``F.pad``'s argument for (before, after) pairs of the trailing
    axes, first axis first."""
    return tuple(v for lo, hi in reversed(pairs) for v in (lo, hi))


def _window_sum(t, k, s, divisor=1):
    """Sum (over ``divisor``) of each ``k`` window at stride ``s`` of the
    already padded floating ``t``."""
    if len(k) == 1:
        return F.avg_pool2d(t.unsqueeze(2), (1,) + k, (1,) + s,
                            divisor_override=divisor).squeeze(2)
    pool = F.avg_pool2d if len(k) == 2 else F.avg_pool3d
    return pool(t, k, s, divisor_override=divisor)


def _windows(t, k, s):
    """Each ``k`` window at stride ``s`` of ``t`` as one trailing axis:
    (N, C, *out, prod(k))."""
    for i in range(len(k)):
        t = t.unfold(2 + i, k[i], s[i])
    return t.flatten(-len(k))


@_register
def Pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            cudnn_off=False, count_include_pad=True, layout=None,
            p_value=2):
    """Max, avg, sum and lp pooling (reference: src/operator/nn/
    pooling.cc), 1-3 D, or over the whole of each map (``global_pool``).
    Padding is explicit (-inf or the integer minimum for max, zeros
    otherwise) and the windows pool unpadded, so ``pooling_convention=
    "full"`` (ceil division) keeps the reference's extra right padding,
    which torch's ``ceil_mode`` drops; avg with ``count_include_pad``
    divides by ``prod(kernel)``, the extra padding included; lp is
    ``(sum x^p)^(1/p)`` with no ``abs``, as the reference's; a max
    window's gradient goes to its first largest element.  Integer inputs
    pool through ``unfold``."""
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError(f"unknown pool_type {pool_type!r}")

    def glob(d):
        axes = tuple(range(2, d.dim()))
        if pool_type == "max":
            return torch.amax(d, axes, keepdim=True)
        if pool_type == "sum":
            return torch.sum(d, axes, keepdim=True, dtype=d.dtype)
        if pool_type == "lp":
            return torch.sum(d ** p_value, axes, keepdim=True,
                             dtype=d.dtype) ** (1.0 / p_value)
        return torch.mean(d if d.is_floating_point() else d.float(), axes,
                          keepdim=True)

    def fn(d):
        if global_pool:
            return glob(d)
        nd = d.dim() - 2
        k = tuple(kernel)
        s, p = _spatial(stride, nd, 1), _spatial(pad, nd, 0)
        pairs = _pool_pads(d.shape, k, s, p, pooling_convention == "full")
        floating = d.is_floating_point()
        if pool_type == "max":
            low = float("-inf") if floating else torch.iinfo(d.dtype).min
            x = F.pad(d, _torch_pads(pairs), value=low)
            if floating:
                return _MAX_POOL[nd](x, k, s)
            return torch.amax(_windows(x, k, s), -1)
        x = F.pad(d, _torch_pads(pairs))
        if pool_type == "lp":
            x = x ** p_value
        if not floating:
            ssum = torch.sum(_windows(x, k, s), -1, dtype=d.dtype)
        elif pool_type == "avg" and count_include_pad:
            return _window_sum(x, k, s, math.prod(k))
        else:
            ssum = _window_sum(x, k, s)
        if pool_type == "sum":
            return ssum
        if pool_type == "lp":
            return (ssum ** (1.0 / p_value)).to(d.dtype)
        if count_include_pad:
            return (ssum / math.prod(k)).to(d.dtype)
        ones = F.pad(torch.ones((1, 1) + tuple(d.shape[2:]),
                                dtype=torch.float32, device=d.device),
                     _torch_pads(pairs))
        return (ssum / _window_sum(ones, k, s)).to(d.dtype)
    return apply(fn, [data])


def _var_mean(d, dims):
    """The biased variance and the mean over ``dims`` (``jnp.var``'s
    ``ddof=0``)."""
    return torch.var_mean(d, dims, correction=0, keepdim=True)


@_register
def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=False):
    """The stateless op (reference: src/operator/nn/batch_norm.cc): in
    training (``autograd.is_training()`` and not ``use_global_stats``)
    it normalizes with the batch's mean and biased variance, otherwise
    with ``moving_mean``/``moving_var``; ``fix_gamma`` scales by one.
    The running statistics' update is ``gluon.nn.BatchNorm``'s."""
    training = _tape.is_training() and not use_global_stats

    def fn(d, g, b, mm, mv):
        ax = axis % d.dim()
        shape = [1] * d.dim()
        shape[ax] = d.shape[ax]
        if training:
            v, m = _var_mean(d, tuple(i for i in range(d.dim()) if i != ax))
        else:
            m, v = mm.reshape(shape), mv.reshape(shape)
        out = (d - m) * torch.rsqrt(v + eps)
        if not fix_gamma:
            out = out * g.reshape(shape)
        return out + b.reshape(shape)
    return apply(fn, [data, gamma, beta, moving_mean, moving_var])


@_register
def InstanceNorm(data, gamma, beta, eps=1e-3):
    """Normalize each (sample, channel) map over its spatial axes, then
    scale by ``gamma`` and shift by ``beta`` per channel."""
    def fn(d, g, b):
        v, m = _var_mean(d, tuple(range(2, d.dim())))
        shape = (1, -1) + (1,) * (d.dim() - 2)
        return (d - m) * torch.rsqrt(v + eps) * g.reshape(shape) + \
            b.reshape(shape)
    return apply(fn, [data, gamma, beta])


@_register
def GroupNorm(data, gamma, beta, num_groups=1, eps=1e-5):
    """Group normalization over groups of ``C / num_groups`` channels
    (reference: src/operator/nn/group_norm.cc)."""
    def fn(d, g, b):
        n, c = d.shape[0], d.shape[1]
        x = d.reshape((n, num_groups, c // num_groups) + tuple(d.shape[2:]))
        v, m = _var_mean(x, tuple(range(2, x.dim())))
        x = ((x - m) / torch.sqrt(v + eps)).reshape(d.shape)
        shape = (1, c) + (1,) * (d.dim() - 2)
        return x * g.reshape(shape) + b.reshape(shape)
    return apply(fn, [data, _nd(gamma, data), _nd(beta, data)])


@_register
def Pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """N-d padding (reference: src/operator/pad.cc): ``pad_width`` is a
    flat (before, after) pair per axis; ``mode`` constant, edge or
    reflect (numpy's modes)."""
    pw = tuple(int(p) for p in pad_width)
    if len(pw) != 2 * len(data.shape):
        raise MXNetError(f"pad_width needs 2 entries per axis, got "
                         f"{len(pw)} for ndim {len(data.shape)}")
    if mode not in ("constant", "edge", "reflect"):
        raise MXNetError(f"unknown pad mode {mode!r}")
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]

    def fn(d):
        if mode == "constant":
            return F.pad(d, _torch_pads(pairs), value=constant_value)
        for ax, (lo, hi) in enumerate(pairs):
            if lo or hi:   # the source index of each output row
                idx = _np.pad(_np.arange(d.shape[ax]), (lo, hi), mode=mode)
                d = torch.index_select(d, ax, torch.as_tensor(
                    idx, device=d.device))
        return d
    return apply(fn, [data])


pad = _alias("pad", Pad)


@_register
def space_to_depth(data, block_size):
    """(N, C, H, W) -> (N, C b^2, H / b, W / b); channel ``(dy b + dx) C +
    c`` holds ``x[c, b i + dy, b j + dx]``."""
    b = block_size

    def fn(d):
        n, c, h, w = d.shape
        d = d.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
        return d.reshape(n, c * b * b, h // b, w // b)
    return apply(fn, [data])


@_register
def depth_to_space(data, block_size):
    """The inverse of :func:`space_to_depth`."""
    b = block_size

    def fn(d):
        n, c, h, w = d.shape
        d = d.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
        return d.reshape(n, c // (b * b), h * b, w * b)
    return apply(fn, [data])


# ===========================================================================
# creation (the ``F.arange`` of hybrid_forward)
# ===========================================================================

_alias("arange", arange)
_alias("zeros", zeros)
_alias("ones", ones)
_alias("full", full)
_alias("array", array)
