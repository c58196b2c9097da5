"""The operator library: MXNet op names and semantics over PyTorch.

Counterpart of ``mxnet_tpu/ndarray/ops.py``: the neural-network ops
(``FullyConnected``, ``Activation``, ``LeakyReLU`` with exact-erf GELU,
``softmax``, ``log_softmax``, ``Dropout``, ``LayerNorm``, ``Embedding``), the
products (``dot``, ``batch_dot``, ``linalg_gemm2``), the shape ops, the
gathers (``take``, ``pick``, ``one_hot``, ``gather_positions``),
``where``, the elementwise unary and binary ops and the reductions;
and the ops of convolutional nets: ``Convolution``, ``Deconvolution``,
``Pooling``, ``BatchNorm``, ``InstanceNorm``, ``GroupNorm``,
``Pad``/``pad``, ``space_to_depth`` and ``depth_to_space``; the loss
ops (``SoftmaxOutput``, ``softmax_cross_entropy``, ``smooth_l1``,
``MakeLoss``, ``BlockGrad``, ``ctc_loss``/``CTCLoss``, the regression
outputs, ``SVMOutput``, ``IdentityAttachKLSparseReg``; where the
reference defines its own gradient, a ``torch.autograd.Function``), the
optimizer update ops (``sgd_update`` ... ``preloaded_multi_*``,
``lamb_update_phase1/2``, ``multi_sum_sq``, ``multi_lars``,
``all_finite``, ``reset_arrays``: they write their state arguments and
the weight in place, calling ``optimizer.fused_rule`` where a rule
computes the same function) and the samplers (``sample_*``,
``random_uniform``/``random_normal``, the ``random_pdf_*`` densities).
Every op but the update ops (which run under ``no_grad``) runs through
``ndarray.apply`` (so only ``autograd.record()`` builds a graph), and
every op is listed in ``_OPS`` by ``_register``, as in the reference.
Where XLA
fused these ops for free they are plain PyTorch, and the convolutions
and pooling windows torch's calls: none is a TPU kernel.

Under ``amp.init()`` the registry casts an op's floating inputs by the
reference's lists (``amp/lists.py``), as the reference's ``amp.init``
patches its registry: ``TARGET_DTYPE_OPS`` to the target dtype,
``FP32_OPS`` to float32, ``WIDEST_TYPE_CASTS`` to the widest input
dtype; the op itself runs with autocast off, so it computes the same on
the CPU and on the card.

and the rest of the registry (its tail below): the elementwise math and
activations, the ordering, indexing and shaping ops, the sequence ops,
the vision ops, the casts and the control flow.  An op that needs a
host sync (``unique``, ``histogram``, ``bincount``, ``cond``,
``while_loop``) refuses to run inside a CUDA graph capture
(:func:`host_sync`).

The registry also holds ``RNN``, the fused recurrence over a packed
parameter vector, which runs ``gluon.rnn``'s loop: every op name of the
reference's registry (``_REFERENCE_OPS``) is registered.
"""
from __future__ import annotations

import builtins as _builtins
import functools
import math

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError
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

# every op name of the reference's registry (all of them registered here)
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


def _named_op(fn, name):
    """``fn`` naming itself to the tape while it runs, for
    ``debug.set_debug_nans``'s errors (the innermost op's name wins)."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        state = _tape._STATE
        prev = state.op
        state.op = name
        try:
            return fn(*args, **kwargs)
        finally:
            state.op = prev
    return op


_NAMING = [False]     # debug.set_debug_nans: each op names itself
_BINDINGS = {}        # (fn, name, amp-wrapped, named) -> the bound op


def _bind(name, fn):
    """``fn`` as the registry binds it: with the amp cast when ``name``
    is on the lists, naming itself while the finite checks are on (one
    object per combination, so switching back restores the same op)."""
    key = (fn, name, name in _AMP_MODE, _NAMING[0])
    op = _BINDINGS.get(key)
    if op is None:
        op = _amp_op(fn, name) if key[2] else fn
        op = _BINDINGS[key] = _named_op(op, name) if key[3] else op
    return op


def _register(fn, name=None):
    """List ``fn`` in the registry under ``name`` (default: its own),
    bound by :func:`_bind`."""
    name = name or fn.__name__
    op = _bind(name, fn)
    _PLAIN[name] = fn
    _OPS[name] = op
    __all__.append(name)
    return op


def _rebind():
    """Bind each registered op whose wrapping changed again, here and in
    the ``nd`` namespace."""
    import sys
    modules = [sys.modules[__name__], sys.modules[__package__]]
    for name, fn in _PLAIN.items():
        op, new = _OPS[name], _bind(name, fn)
        if new is op:
            continue
        _OPS[name] = new
        for mod in modules:
            if getattr(mod, name, None) is op:
                setattr(mod, name, new)


def set_amp_lists(target_precision_ops=(), fp32_ops=()):
    """Extend the reference's lists (``amp.init``'s op-list arguments;
    no arguments: the reference's own lists again) and rebind each
    registered op whose wrapping changes, as the reference's
    ``amp.init`` patches its registry."""
    _AMP_MODE.clear()
    _AMP_MODE.update(_amp_modes(target_precision_ops, fp32_ops))
    _rebind()


def set_op_names(enabled):
    """Make every registered op name itself to the tape while it runs
    (``debug.set_debug_nans``), or stop."""
    _NAMING[0] = bool(enabled)
    _rebind()


def _alias(name, op):
    _OPS[name] = op
    __all__.append(name)
    return op


def _nd(x, like=None):
    if isinstance(x, NDArray):
        return x
    if torch.is_tensor(x):
        return NDArray(x)
    ctx = like.context if like is not None else None
    if isinstance(x, (bool, int, float, _np.bool_, _np.number)):
        # a float32 scalar, as ``array`` makes it, but by a fill on the
        # device: a CUDA graph capture cannot hold a copy from the host
        return full((), float(x), ctx=ctx, dtype="float32")
    return array(x, ctx=ctx)


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


class _SparseEmbedding(torch.autograd.Function):
    """The gather with a row-sparse weight gradient: a sparse COO tensor
    of the raw ids (repeats included) and the output gradient's rows,
    O(nnz) and of a fixed shape (a captured backward carries it out);
    duplicates are summed when the gradient is read."""

    @staticmethod
    def forward(ctx, ids, weight):
        ids = ids.long()
        ctx.save_for_backward(ids)
        ctx.shape = tuple(weight.shape)
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, dy):
        ids, = ctx.saved_tensors
        rows = dy.reshape(-1, dy.shape[-1])
        return None, torch.sparse_coo_tensor(
            ids.reshape(1, -1), rows, ctx.shape, is_coalesced=False,
            check_invariants=False)


@_register
def Embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False):
    """Rows of ``weight`` at the (int32) indices ``data``.
    ``sparse_grad=True`` gives the weight a row-sparse gradient
    (``ndarray/sparse.py``): memory and work O(nnz), never O(vocab)."""
    if sparse_grad:
        return apply(_SparseEmbedding.apply, [_nd(data), _nd(weight)])
    return apply(lambda i, w: F.embedding(i.long() if i.is_floating_point()
                                          else i, w),
                 [_nd(data), _nd(weight)])


# ===========================================================================
# neural-network ops
# ===========================================================================

@_register
def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True, compute_dtype=None):
    """``data @ weight.T + bias``; ``weight`` is (out, in), MXNet's
    layout; ``flatten=True`` folds every axis after the first.

    ``compute_dtype="int8"|"fp8"`` runs the product through
    ``ops.quant_matmul`` (tag ``"fc"``; an f32 result, then the bias),
    the seam the reference's ``MXTPU_COMPUTE_DTYPE`` opens for every
    Dense; None (or an "off" spelling) is the plain ``F.linear``."""
    inputs = [data, weight] + ([] if no_bias or bias is None else [bias])
    from ..ops.quant_matmul import quant_matmul, resolve_compute_dtype
    cd = resolve_compute_dtype(compute_dtype)

    def fn(d, w, *b):
        x = d.reshape(d.shape[0], -1) if flatten and d.dim() > 2 else d
        if cd is None:
            return F.linear(x, w, b[0] if b else None)
        y = quant_matmul(x, w.t(), compute_dtype=cd, tag="fc")
        return y + b[0] if b else y
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


_SQRT_HALF = float(_np.float32(_np.sqrt(0.5)))


def _gelu(t):
    """Exact GELU, ``0.5 x erfc(-x sqrt(1/2))``, as ``jax.nn.gelu(
    approximate=False)`` writes it.  On the CPU the written form: ATen's
    CPU GELU kernel evaluates erf by a vectorized polynomial less exact
    than ``torch.erfc``, which moved a parity test's gradients past
    1e-5 at some draws (ROADMAP §3, fault q;
    ``tools/port_gelu_seed_sweep.py``).  On the card ``F.gelu``, one
    fused kernel a direction."""
    if t.device.type == "cpu":
        return 0.5 * t * torch.erfc(t * -_SQRT_HALF)
    return F.gelu(t, approximate="none")


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
        return apply(_gelu, [data])
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


# ===========================================================================
# losses at op level (reference: src/operator/loss_binary_op.cc,
# softmax_output.cc, regression_output.cc, svm_output.cc, make_loss.cc,
# identity_attach_KL_sparse_reg.cc, nn/ctc_loss.cc).  Where the reference
# defines its own gradient (a custom_vjp), it is a torch.autograd.Function
# here: the op's gradient replaces the incoming one, as there.
# ===========================================================================

def _onehot(label, depth, dtype):
    """One-hot rows of ``label`` (any float or int tensor); an index out
    of ``[0, depth)`` (an ignore label of -1) gives a zero row, as
    ``jax.nn.one_hot`` does."""
    idx = label.long().unsqueeze(-1)
    return (idx == torch.arange(depth, device=label.device)).to(dtype)


class _SoftmaxOutputFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, label, grad_scale, ignore_label, use_ignore,
                normalization):
        p = torch.softmax(d, dim=-1)
        ctx.save_for_backward(p, label)
        ctx.cfg = (grad_scale, ignore_label, use_ignore, normalization)
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization = ctx.cfg
        grad = (p - _onehot(label, p.shape[-1], p.dtype)) * grad_scale
        if use_ignore:
            grad = grad * (label != ignore_label).to(p.dtype)[..., None]
        if normalization == "batch":
            grad = grad / p.shape[0]
        elif normalization == "valid" and use_ignore:
            grad = grad / torch.clamp((label != ignore_label).sum(),
                                      min=1).to(p.dtype)
        return grad, None, None, None, None, None


@_register
def SoftmaxOutput(data, label, grad_scale=1.0, ignore_label=-1,
                  use_ignore=False, multi_output=False, normalization="null",
                  out_grad=False, smooth_alpha=0.0):
    """Forward softmax over the last axis; backward ``(p - onehot(label))
    * grad_scale`` (masked by ``use_ignore``, divided by the batch or the
    valid count), replacing the incoming gradient.  Reference:
    src/operator/softmax_output.cc."""
    return apply(lambda d, l: _SoftmaxOutputFn.apply(
        d, l, grad_scale, ignore_label, use_ignore, normalization),
        [data, _nd(label, data)])


@_register
def softmax_cross_entropy(data, label):
    """``-sum(onehot(label) * log_softmax(data))`` over everything: one
    scalar (reference loss_binary_op.cc)."""
    def fn(d, l):
        return -torch.sum(_onehot(l, d.shape[-1], d.dtype) *
                          F.log_softmax(d, dim=-1))
    return apply(fn, [data, _nd(label, data)])


@_register
def smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar

    def fn(d):
        a = torch.abs(d)
        return torch.where(a < 1.0 / s2, 0.5 * s2 * torch.square(d),
                           a - 0.5 / s2)
    return apply(fn, [data])


@_register
def MakeLoss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """``data * grad_scale`` (reference make_loss.cc, as the reference's
    port computes it)."""
    return apply(lambda d: d * grad_scale, [data])


BlockGrad = _alias("BlockGrad", stop_gradient)


class _OutputFn(torch.autograd.Function):
    """The Module-era output ops: ``forward(d)`` is the op's forward;
    the backward is ``grad_of(out or d, label)``, replacing the incoming
    gradient (the label takes none)."""

    @staticmethod
    def forward(ctx, d, label, forward, grad_of, from_output):
        out = forward(d)
        ctx.save_for_backward(out if from_output else d, label)
        ctx.grad_of = grad_of
        return out

    @staticmethod
    def backward(ctx, g):
        x, label = ctx.saved_tensors
        return ctx.grad_of(x, label).to(x.dtype), None, None, None, None


def _output_op(name, grad_of, forward=None, doc=""):
    def op(data, label, grad_scale=1.0):
        fwd = forward or (lambda d: d.clone())
        return apply(lambda d, l: _OutputFn.apply(
            d, l, fwd, lambda x, lab: grad_of(x, lab, grad_scale),
            forward is not None), [data, _nd(label, data)])
    op.__name__ = name
    op.__doc__ = doc
    return _register(op)


LinearRegressionOutput = _output_op(
    "LinearRegressionOutput",
    lambda d, l, s: (d - l.reshape(d.shape)) * s,
    doc="Identity forward; backward ``(data - label) * grad_scale`` "
        "(reference regression_output.cc).")
MAERegressionOutput = _output_op(
    "MAERegressionOutput",
    lambda d, l, s: torch.sign(d - l.reshape(d.shape)) * s,
    doc="Identity forward; backward ``sign(data - label) * grad_scale``.")
LogisticRegressionOutput = _output_op(
    "LogisticRegressionOutput",
    lambda out, l, s: (out - l.reshape(out.shape)) * s,
    forward=torch.sigmoid,
    doc="Forward ``sigmoid(data)``; backward ``(out - label) * "
        "grad_scale``.")


def _svm_grad(d, l, scale, margin, coef, use_linear):
    onehot = _onehot(l, d.shape[-1], d.dtype) > 0
    signed = torch.where(onehot, -d, d)
    viol = (margin + signed) > 0
    sign = torch.where(onehot, -1.0, 1.0).to(d.dtype)
    g = sign if use_linear else 2.0 * (margin + signed) * sign
    return torch.where(viol, g, torch.zeros_like(g)) * scale * coef


@_register
def SVMOutput(data, label, margin=1.0, regularization_coefficient=1.0,
              use_linear=False, grad_scale=1.0):
    """Identity forward; backward the hinge (``use_linear``) or squared
    hinge margin-violation gradient (reference svm_output.cc)."""
    return apply(lambda d, l: _OutputFn.apply(
        d, l, lambda x: x.clone(),
        lambda x, lab: _svm_grad(x, lab, grad_scale, margin,
                                 regularization_coefficient, use_linear),
        False), [data, _nd(label, data)])


class _KLSparseFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, target, penalty):
        ctx.save_for_backward(d)
        ctx.cfg = (target, penalty)
        return d.clone()

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        t, penalty = ctx.cfg
        rho = torch.clamp(d.mean(dim=0, keepdim=True), 1e-6, 1 - 1e-6)
        kl = penalty * (-t / rho + (1 - t) / (1 - rho))
        return g + kl.expand_as(g) / d.shape[0], None, None


@_register
def IdentityAttachKLSparseReg(data, sparseness_target=0.1, penalty=0.001,
                              momentum=0.9):
    """Identity forward; the backward adds the KL sparsity penalty's
    gradient toward ``sparseness_target`` (reference
    identity_attach_KL_sparse_reg.cc, as the reference's port computes
    it: ``rho`` is the batch's mean activation, so ``momentum`` has no
    effect)."""
    return apply(lambda d: _KLSparseFn.apply(d, sparseness_target, penalty),
                 [data])


_CTC_NEG = -1e30


def _ctc_nll(logp, ext, skip, t_len, l_len):
    """The CTC negative log-likelihood of each row: ``logp`` (N, T, C)
    log-probabilities, ``ext`` (N, S) the blank-interleaved labels,
    ``skip`` (N, S) where a position may be reached from two back,
    ``t_len``/``l_len`` (N,) the used lengths.  The forward (alpha)
    recursion in log space, one step a time position, differentiable
    by autograd (the reference's ``lax.scan``)."""
    n, T, _ = logp.shape
    neg = logp.new_full((n, 1), _CTC_NEG)
    emit = torch.gather(logp, 2, ext.unsqueeze(1).expand(n, T, -1))
    alpha = torch.cat([emit[:, 0, :1],
                       torch.where(l_len[:, None] > 0, emit[:, 0, 1:2], neg),
                       logp.new_full((n, ext.shape[1] - 2), _CTC_NEG)], 1)
    for t in range(1, T):
        a = torch.logaddexp(alpha, torch.cat([neg, alpha[:, :-1]], 1))
        a2 = torch.cat([neg, neg, alpha[:, :-2]], 1)
        a = torch.where(skip, torch.logaddexp(a, a2), a)
        alpha = torch.where((t < t_len)[:, None], a + emit[:, t], alpha)
    end = 2 * l_len
    last = torch.gather(alpha, 1, end[:, None])[:, 0]
    last2 = torch.gather(alpha, 1, torch.clamp(end - 1, min=0)[:, None])[:, 0]
    last2 = torch.where(l_len > 0, last2, neg[:, 0])
    return -torch.logaddexp(last, last2)


def _ctc_extended(lab, blank):
    """The blank-interleaved labels (N, 2L + 1) of ``lab`` (N, L, padding
    already clamped into range) and the positions reachable from two
    back (a label that differs from the one two back)."""
    n, L = lab.shape
    ext = torch.full((n, 2 * L + 1), blank, dtype=torch.long,
                     device=lab.device)
    ext[:, 1::2] = lab
    skip = torch.zeros(ext.shape, dtype=torch.bool, device=lab.device)
    skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    return ext, skip


@_register
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """Connectionist temporal classification loss of each example.

    ``data`` (T, B, C) pre-softmax activations; ``label`` (B, L), padded
    with -1 (or, with the blank first, with 0s).  Without
    ``use_label_lengths`` a label's length counts its entries above 0
    (blank first) or at least 0 (blank last, ``C - 1``).  Returns (B,)
    in float32.  Reference: src/operator/nn/ctc_loss.cc, as the
    reference's port computes it (``_ctc_nll``'s log-space recursion)."""
    if blank_label not in ("first", "last"):
        raise MXNetError("blank_label must be 'first' or 'last'")
    inputs = [data, _nd(label, data)]
    for flag, value, what in ((use_data_lengths, data_lengths,
                               "use_data_lengths"),
                              (use_label_lengths, label_lengths,
                               "use_label_lengths")):
        if flag:
            if value is None:
                raise MXNetError(f"{what}=True requires "
                                 f"{what[4:]}")
            inputs.append(_nd(value, data))

    def fn(d, lab, *lens):
        t, b, c = d.shape
        blank = 0 if blank_label == "first" else c - 1
        logp = F.log_softmax(d.permute(1, 0, 2).float(), dim=-1)
        lab = lab.long()
        if use_label_lengths:
            l_len = lens[1 if use_data_lengths else 0].long()
        else:
            l_len = ((lab > 0) if blank == 0 else (lab >= 0)).sum(1)
        t_len = lens[0].long() if use_data_lengths else \
            torch.full((b,), t, dtype=torch.long, device=d.device)
        ext, skip = _ctc_extended(torch.clamp(lab, min=0), blank)
        return _ctc_nll(logp, ext, skip, t_len, l_len)
    return apply(fn, inputs)


CTCLoss = _alias("CTCLoss", ctc_loss)


# ===========================================================================
# optimizer update ops (reference: src/operator/optimizer_op.cc and
# contrib/{multi_lamb,multi_sum_sq,multi_lars,all_finite,reset_arrays,
# preloaded_multi_sgd}.cc).  Each writes its state arguments and the
# weight (or ``out``) in place, as the reference's ``_set_data``, and
# returns the weight.  Where a rule of ``optimizer.fused_rule`` computes
# the same function, the op calls it: the update math has one source.
# ===========================================================================

def _t(x):
    return x._data if isinstance(x, NDArray) else x


def _write_outs(pairs):
    """Write each new tensor into its NDArray, in place; return the
    first NDArray."""
    for target, value in pairs:
        target._write(value.detach())
    return pairs[0][0]


def _clip_or_none(clip):
    return clip if clip is not None and clip >= 0 else None


def _rule(name, clip, **hyper):
    from ..optimizer.optimizer import fused_rule
    return fused_rule(name, clip_gradient=_clip_or_none(clip), **hyper)[1]


def _prep_grad(g, w, wd, rescale_grad, clip_gradient):
    g = g * rescale_grad
    clip = _clip_or_none(clip_gradient)
    if clip is not None:
        g = torch.clamp(g, -clip, clip)
    return g + wd * w


def _sgd_mom(w, g, m, lr, momentum, wd, rescale, clip, nesterov=False):
    """``(w', m')`` of sgd_mom_update (nag_mom_update): the sgd (nag)
    rule; with ``momentum`` 0 the reference still writes the momentum
    (``-lr·g``, or ``g`` for nag)."""
    if momentum:
        new_w, s = _rule("nag" if nesterov else "sgd", clip,
                         momentum=momentum)(w, g, {"mom": m}, lr, wd,
                                            rescale)
        return new_w, s["mom"]
    g = _prep_grad(g, w, wd, rescale, clip)
    return w - lr * g, (g if nesterov else -lr * g)


@_register
@torch.no_grad()
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
               lazy_update=True, out=None):
    new_w, _ = _rule("sgd", clip_gradient)(_t(weight), _t(grad), {}, lr, wd,
                                           rescale_grad)
    return _write_outs([(out if out is not None else weight, new_w)])


@_register
@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                   out=None):
    new_w, new_m = _sgd_mom(_t(weight), _t(grad), _t(mom), lr, momentum, wd,
                            rescale_grad, clip_gradient)
    return _write_outs([(out if out is not None else weight, new_w),
                        (mom, new_m)])


@_register
@torch.no_grad()
def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, out=None):
    new_w, new_m = _sgd_mom(_t(weight), _t(grad), _t(mom), lr, momentum, wd,
                            rescale_grad, clip_gradient, nesterov=True)
    return _write_outs([(out if out is not None else weight, new_w),
                        (mom, new_m)])


@_register
@torch.no_grad()
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True, out=None):
    """Adam's step at a learning rate the caller has bias-corrected (the
    op takes no step count)."""
    w = _t(weight)
    g = _prep_grad(_t(grad), w, wd, rescale_grad, clip_gradient)
    m = beta1 * _t(mean) + (1 - beta1) * g
    v = beta2 * _t(var) + (1 - beta2) * torch.square(g)
    return _write_outs([(out if out is not None else weight,
                         w - lr * m / (torch.sqrt(v) + epsilon)),
                        (mean, m), (var, v)])


@_register
@torch.no_grad()
def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, out=None):
    w = _t(weight)
    g = _prep_grad(_t(grad), w, 0.0, rescale_grad, clip_gradient)
    return _write_outs([(out if out is not None else weight,
                         (1 - lr * wd) * w - lr * torch.sign(g))])


@_register
@torch.no_grad()
def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0, out=None):
    w = _t(weight)
    g = _prep_grad(_t(grad), w, wd, rescale_grad, clip_gradient)
    m = momentum * _t(mom) - (1 - momentum) * g
    return _write_outs([(out if out is not None else weight,
                         (1 - lr * wd_lh) * w + lr * torch.sign(m)),
                        (mom, m)])


@_register
@torch.no_grad()
def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0,
                   out=None):
    """The op's RMSProp: ``w - lr·g / (sqrt(n) + eps)`` (the optimizer's
    rule takes ``sqrt(n + eps)``)."""
    w = _t(weight)
    g = _prep_grad(_t(grad), w, wd, rescale_grad, clip_gradient)
    n_new = gamma1 * _t(n) + (1 - gamma1) * torch.square(g)
    w_new = w - lr * g / (torch.sqrt(n_new) + epsilon)
    if clip_weights > 0:
        w_new = torch.clamp(w_new, -clip_weights, clip_weights)
    return _write_outs([(out if out is not None else weight, w_new),
                        (n, n_new)])


@_register
@torch.no_grad()
def rmspropalex_update(weight, grad, n, g, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0, out=None):
    """Centered RMSProp with momentum (Graves): the centered rmsprop
    rule."""
    apply_ = _rule("rmsprop", clip_gradient, gamma1=gamma1, gamma2=gamma2,
                   epsilon=epsilon, centered=True,
                   clip_weights=clip_weights if clip_weights > 0 else None)
    new_w, s = apply_(_t(weight), _t(grad),
                      {"n": _t(n), "g": _t(g), "d": _t(delta)}, lr, wd,
                      rescale_grad)
    return _write_outs([(out if out is not None else weight, new_w),
                        (n, s["n"]), (g, s["g"]), (delta, s["d"])])


@_register
@torch.no_grad()
def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, out=None):
    w = _t(weight)
    g = _prep_grad(_t(grad), w, 0.0, rescale_grad, clip_gradient)
    n_old = _t(n)
    n_new = n_old + torch.square(g)
    sigma = (torch.sqrt(n_new) - torch.sqrt(n_old)) / lr
    z_new = _t(z) + g - sigma * w
    w_new = -(z_new - torch.sign(z_new) * lamda1) / \
        ((beta + torch.sqrt(n_new)) / lr + wd)
    w_new = torch.where(torch.abs(z_new) <= lamda1, torch.zeros_like(w_new),
                        w_new)
    return _write_outs([(out if out is not None else weight, w_new),
                        (z, z_new), (n, n_new)])


@_register
@torch.no_grad()
def adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, out=None):
    w = _t(weight)
    g = _prep_grad(_t(grad), w, wd, rescale_grad, clip_gradient)
    h = _t(history) + torch.square(g)
    return _write_outs([(out if out is not None else weight,
                         w - lr * g / (torch.sqrt(h) + epsilon)),
                        (history, h)])


@_register
@torch.no_grad()
def ftml_update(weight, grad, d, v, z, lr, t, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0,
                out=None):
    w = _t(weight)
    g = _prep_grad(_t(grad), w, wd, rescale_grad, clip_grad)
    v_new = beta2 * _t(v) + (1 - beta2) * torch.square(g)
    d_new = (1 - beta1 ** t) / lr * (
        torch.sqrt(v_new / (1 - beta2 ** t)) + epsilon)
    sigma = d_new - beta1 * _t(d)
    z_new = beta1 * _t(z) + (1 - beta1) * g - sigma * w
    return _write_outs([(out if out is not None else weight, -z_new / d_new),
                        (d, d_new), (v, v_new), (z, z_new)])


@_register
@torch.no_grad()
def adamax_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                  epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                  out=None):
    """AdaMax at a learning rate the caller has bias-corrected."""
    w = _t(weight)
    g = _prep_grad(_t(grad), w, wd, rescale_grad, clip_gradient)
    m = beta1 * _t(mean) + (1 - beta1) * g
    u = torch.maximum(beta2 * _t(var), torch.abs(g))
    return _write_outs([(out if out is not None else weight,
                         w - lr * m / (u + epsilon)), (mean, m), (var, u)])


_NADAM_SCHED = {}   # (beta1, schedule_decay) -> (mus, cumulative products)


def _nadam_schedule(beta1, schedule_decay, t):
    mus, cum = _NADAM_SCHED.setdefault((beta1, schedule_decay),
                                       ([None], [1.0]))
    while len(mus) <= t + 1:
        mu = beta1 * (1 - 0.5 * 0.96 ** (len(mus) * schedule_decay))
        mus.append(mu)
        cum.append(cum[-1] * mu)
    return mus[t], mus[t + 1], cum[t], cum[t] * mus[t + 1]


@_register
@torch.no_grad()
def nadam_update(weight, grad, mean, var, lr, t, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0, out=None):
    """Nesterov Adam with the cumulative momentum schedule (the
    reference's; its products cached per ``(beta1, schedule_decay)``)."""
    mu_t, mu_next, m_sched, m_sched_next = _nadam_schedule(
        beta1, schedule_decay, t)
    w = _t(weight)
    g = _prep_grad(_t(grad), w, wd, rescale_grad, clip_gradient)
    m = beta1 * _t(mean) + (1 - beta1) * g
    v = beta2 * _t(var) + (1 - beta2) * torch.square(g)
    m_bar = (1 - mu_t) * (g / (1 - m_sched)) + \
        mu_next * (m / (1 - m_sched_next))
    v_hat = v / (1 - beta2 ** t)
    return _write_outs([(out if out is not None else weight,
                         w - lr * m_bar / (torch.sqrt(v_hat) + epsilon)),
                        (mean, m), (var, v)])


def _lamb_direction(w32, g, m, v, t, beta1, beta2, epsilon,
                    bias_correction, wd, rescale_grad, clip_gradient):
    g = _prep_grad(g, w32, 0.0, rescale_grad, clip_gradient)
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * torch.square(g)
    if bias_correction:
        m_hat, v_hat = m / (1 - beta1 ** t), v / (1 - beta2 ** t)
    else:
        m_hat, v_hat = m, v
    return m_hat / (torch.sqrt(v_hat) + epsilon) + wd * w32, m, v


def _lamb_ratio(r1, r2, lower_bound, upper_bound):
    r1, r2 = r1.reshape(()), r2.reshape(())
    if lower_bound > 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound > 0:
        r1 = torch.clamp(r1, max=upper_bound)
    return torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))


@_register
@torch.no_grad()
def lamb_update_phase1(weight, grad, mean, var, t, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's direction ``m̂ / (sqrt(v̂) + eps) + wd·w`` (returned);
    mean and var updated in place.  Phase 2 applies the trust ratio."""
    g_out, m, v = _lamb_direction(
        _t(weight), _t(grad), _t(mean), _t(var), t, beta1, beta2, epsilon,
        bias_correction, wd, rescale_grad, clip_gradient)
    _write_outs([(mean, m), (var, v)])
    return NDArray(g_out)


@_register
@torch.no_grad()
def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0, out=None):
    """``w - lr · (r1 / r2) · g``, ``r1`` bounded, ratio 1 where either
    norm is 0."""
    ratio = _lamb_ratio(_t(_nd(r1, weight)), _t(_nd(r2, weight)),
                        lower_bound, upper_bound)
    return _write_outs([(out if out is not None else weight,
                         _t(weight) - lr * ratio * _t(g))])


@_register
@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, out=None):
    """SGD on the float32 master copy; the weight is its cast."""
    new32, _ = _rule("sgd", clip_gradient)(_t(weight32), _t(grad).float(),
                                           {}, lr, wd, rescale_grad)
    return _write_outs([(out if out is not None else weight,
                         new32.to(_t(weight).dtype)), (weight32, new32)])


@_register
@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, out=None):
    new32, m = _sgd_mom(_t(weight32), _t(grad).float(), _t(mom), lr,
                        momentum, wd, rescale_grad, clip_gradient)
    return _write_outs([(out if out is not None else weight,
                         new32.to(_t(weight).dtype)), (mom, m),
                        (weight32, new32)])


@_register
@torch.no_grad()
def mp_nag_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, out=None):
    new32, m = _sgd_mom(_t(weight32), _t(grad).float(), _t(mom), lr,
                        momentum, wd, rescale_grad, clip_gradient,
                        nesterov=True)
    return _write_outs([(out if out is not None else weight,
                         new32.to(_t(weight).dtype)), (mom, m),
                        (weight32, new32)])


@_register
@torch.no_grad()
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, t, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, bias_correction=True,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Phase 1 of LAMB on the float32 master copy."""
    g_out, m, v = _lamb_direction(
        _t(weight32), _t(grad).float(), _t(mean), _t(var), t, beta1, beta2,
        epsilon, bias_correction, wd, rescale_grad, clip_gradient)
    _write_outs([(mean, m), (var, v)])
    return NDArray(g_out)


@_register
@torch.no_grad()
def mp_lamb_update_phase2(weight, g, r1, r2, weight32, lr, lower_bound=-1.0,
                          upper_bound=-1.0, out=None):
    ratio = _lamb_ratio(_t(_nd(r1, weight)), _t(_nd(r2, weight)),
                        lower_bound, upper_bound)
    new32 = _t(weight32) - lr * ratio * _t(g)
    return _write_outs([(out if out is not None else weight,
                         new32.to(_t(weight).dtype)), (weight32, new32)])


def _groups(name, arrays, per_weight, num_weights=None):
    if len(arrays) % per_weight:
        raise MXNetError(f"{name}: {len(arrays)} arrays are not groups of "
                         f"{per_weight}")
    groups = [arrays[i:i + per_weight]
              for i in range(0, len(arrays), per_weight)]
    if num_weights is not None and num_weights != len(groups):
        raise MXNetError(f"{name}: num_weights {num_weights} != "
                         f"{len(groups)} weight groups passed")
    return groups


@_register
@torch.no_grad()
def multi_sgd_update(*arrays, lrs, wds, rescale_grad=1.0,
                     clip_gradient=None, num_weights=None, out=None):
    """Group SGD over ``(w0, g0, w1, g1, ...)``; each weight in place;
    returns the weights."""
    groups = _groups("multi_sgd_update", arrays, 2, num_weights)
    apply_ = _rule("sgd", clip_gradient)
    for (w, g), lr, wd in zip(groups, lrs, wds):
        _write_outs([(w, apply_(_t(w), _t(g), {}, lr, wd, rescale_grad)[0])])
    return [grp[0] for grp in groups]


@_register
@torch.no_grad()
def multi_sgd_mom_update(*arrays, lrs, wds, momentum=0.9, rescale_grad=1.0,
                         clip_gradient=None, num_weights=None, out=None):
    """Group SGD with momentum over ``(w0, g0, m0, ...)``."""
    groups = _groups("multi_sgd_mom_update", arrays, 3, num_weights)
    for (w, g, m), lr, wd in zip(groups, lrs, wds):
        new_w, new_m = _sgd_mom(_t(w), _t(g), _t(m), lr, momentum, wd,
                                rescale_grad, clip_gradient)
        _write_outs([(w, new_w), (m, new_m)])
    return [grp[0] for grp in groups]


@_register
@torch.no_grad()
def multi_mp_sgd_update(*arrays, lrs, wds, rescale_grad=1.0,
                        clip_gradient=None, num_weights=None, out=None):
    """Group mixed-precision SGD over ``(w0, g0, w32_0, ...)``."""
    groups = _groups("multi_mp_sgd_update", arrays, 3, num_weights)
    for (w, g, w32), lr, wd in zip(groups, lrs, wds):
        mp_sgd_update(w, g, w32, lr, wd, rescale_grad,
                      -1.0 if clip_gradient is None else clip_gradient)
    return [grp[0] for grp in groups]


@_register
@torch.no_grad()
def multi_mp_sgd_mom_update(*arrays, lrs, wds, momentum=0.9,
                            rescale_grad=1.0, clip_gradient=None,
                            num_weights=None, out=None):
    """Group mixed-precision SGD with momentum over ``(w0, g0, m0, w32_0,
    ...)``."""
    groups = _groups("multi_mp_sgd_mom_update", arrays, 4, num_weights)
    for (w, g, m, w32), lr, wd in zip(groups, lrs, wds):
        mp_sgd_mom_update(w, g, m, w32, lr, momentum, wd, rescale_grad,
                          -1.0 if clip_gradient is None else clip_gradient)
    return [grp[0] for grp in groups]


@_register
@torch.no_grad()
def multi_lamb_update(*arrays, lrs, wds, beta1=0.9, beta2=0.999,
                      epsilon=1e-6, rescale_grad=1.0, clip_gradient=None,
                      step=1, lower_bound=None, upper_bound=None, out=None):
    """Group LAMB over ``(w0, g0, mean0, var0, ...)`` at step ``step``;
    the bounds apply to the trust ratio (the reference's multi_lamb)."""
    groups = _groups("multi_lamb_update", arrays, 4)
    for (w, g, mean, var), lr, wd in zip(groups, lrs, wds):
        upd, m, v = _lamb_direction(
            _t(w), _t(g), _t(mean), _t(var), step, beta1, beta2, epsilon,
            True, wd, rescale_grad, clip_gradient)
        wn = torch.linalg.vector_norm(_t(w))
        un = torch.linalg.vector_norm(upd)
        ratio = torch.where((wn > 0) & (un > 0),
                            wn / torch.clamp(un, min=1e-12),
                            torch.ones_like(wn))
        if lower_bound is not None:
            ratio = torch.clamp(ratio, min=lower_bound)
        if upper_bound is not None:
            ratio = torch.clamp(ratio, max=upper_bound)
        _write_outs([(w, _t(w) - lr * ratio * upd), (mean, m), (var, v)])
    return [grp[0] for grp in groups]


def _preloaded(name, per_weight, rule_step):
    def op(*data, rescale_grad=1.0, clip_gradient=-1.0, momentum=0.0,
           num_weights=None):
        n = num_weights if num_weights is not None else \
            (len(data) - 2) // per_weight
        if len(data) != n * per_weight + 2:
            raise MXNetError(f"{name}: expected {n}*{per_weight}+2 arrays "
                             f"(groups + lrs + wds), got {len(data)}")
        lrs, wds = _t(data[-2]), _t(data[-1])
        groups = [data[i * per_weight:(i + 1) * per_weight]
                  for i in range(n)]
        with torch.no_grad():
            for i, grp in enumerate(groups):
                rule_step(grp, lrs[i], wds[i], rescale_grad, clip_gradient,
                          momentum)
        return [grp[0] for grp in groups]
    op.__name__ = name
    op.__doc__ = (f"{name}: the learning rates and weight decays are device "
                  "tensors (the last two arrays), read per weight on the "
                  "device (reference contrib/preloaded_multi_sgd.cc).")
    return _register(op)


preloaded_multi_sgd_update = _preloaded(
    "preloaded_multi_sgd_update", 2,
    lambda grp, lr, wd, r, c, m: sgd_update(*grp, lr, wd, r, c))
preloaded_multi_sgd_mom_update = _preloaded(
    "preloaded_multi_sgd_mom_update", 3,
    lambda grp, lr, wd, r, c, m: sgd_mom_update(*grp, lr, m, wd, r, c))
preloaded_multi_mp_sgd_update = _preloaded(
    "preloaded_multi_mp_sgd_update", 3,
    lambda grp, lr, wd, r, c, m: mp_sgd_update(*grp, lr, wd, r, c))
preloaded_multi_mp_sgd_mom_update = _preloaded(
    "preloaded_multi_mp_sgd_mom_update", 4,
    lambda grp, lr, wd, r, c, m: mp_sgd_mom_update(*grp, lr, m, wd, r, c))


@_register
def all_finite(data, init_output=True):
    """``[1.0]`` if every element is finite, else ``[0.0]``."""
    return apply(lambda d: torch.isfinite(d).all().float().reshape(1),
                 [data])


@_register
def multi_all_finite(*arrays, num_arrays=None, init_output=True):
    if num_arrays is not None and num_arrays != len(arrays):
        raise MXNetError(f"multi_all_finite: num_arrays {num_arrays} != "
                         f"{len(arrays)} inputs")
    return apply(lambda *ds: torch.stack(
        [torch.isfinite(d).all() for d in ds]).all().float().reshape(1),
        list(arrays))


@_register
def multi_sum_sq(*arrays, num_arrays=None):
    """Each array's sum of squares in float32, as one ``(n,)`` array."""
    if num_arrays is not None and num_arrays != len(arrays):
        raise MXNetError(f"multi_sum_sq: num_arrays {num_arrays} != "
                         f"{len(arrays)} inputs")
    return apply(lambda *ds: torch.stack(
        [torch.sum(torch.square(d.float())) for d in ds]), list(arrays))


@_register
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-8,
               rescale_grad=1.0):
    """Each layer's learning rate times LARS's trust ratio
    ``eta |w| / (|g| rescale + wd |w| + eps)``, unchanged where a norm
    is 0."""
    def fn(lr, wss, gss, wd):
        wn = torch.sqrt(wss)
        gn = torch.sqrt(gss) * rescale_grad
        return torch.where((wn > 0) & (gn > 0),
                           lr * (eta * wn / (gn + wd * wn + eps)), lr)
    return apply(fn, [lrs, _nd(weights_sum_sq, lrs), _nd(grads_sum_sq, lrs),
                      _nd(wds, lrs)])


@_register
def reset_arrays(*arrays, num_arrays=None):
    """Zero every array in place (the gradients of ``grad_req='add'``)."""
    if num_arrays is not None and num_arrays != len(arrays):
        raise MXNetError(f"reset_arrays: num_arrays {num_arrays} != "
                         f"{len(arrays)} arrays passed")
    for a in arrays:
        a._write(torch.zeros_like(a._data))
    return None


# ===========================================================================
# samplers (reference: src/operator/random/sample_op.cc,
# multisample_op.cc, pdf_op.cc).  Every draw comes from the explicit
# generator of the parameters' device (``nd.random.generator``): the
# distributions are the reference's, the bits are not.
# ===========================================================================

def _sample_shape(pshape, shape):
    if shape is None:
        return tuple(pshape)
    return tuple(pshape) + ((shape,) if isinstance(shape, int)
                            else tuple(shape))


def _bcast(p, out_shape):
    """A parameter tensor broadcast over the sample axes after its own."""
    return p.reshape(p.shape + (1,) * (len(out_shape) - p.dim())) \
        .expand(out_shape)


def _sampler(name, n_params, draw):
    """``name(*params, shape=None, dtype=None, ctx=None)``: per-element
    parameters; the output is ``params[0].shape + shape``, each element
    drawn by ``draw(generator, *broadcast params)`` in float32."""
    def op(*params, shape=None, dtype=None, ctx=None):
        if len(params) != n_params:
            raise MXNetError(f"{name} takes {n_params} parameter arrays")
        first = _nd(params[0], None)
        ps = [first] + [_nd(p, first) for p in params[1:]]
        out_shape = _sample_shape(first.shape, shape)
        from . import random as _rnd
        gen = _rnd.generator(first._data.device)

        def fn(*ts):
            ts = [_bcast(t.float(), out_shape) for t in ts]
            return draw(gen, *ts).to(_dtype_of(dtype or "float32"))
        with torch.no_grad():
            return apply(fn, ps)
    op.__name__ = name
    return _register(op)


def _standard_gamma(gen, alpha):
    return torch._standard_gamma(alpha.contiguous(), generator=gen)


def _gamma_poisson(gen, shape_, scale):
    """Negative binomial draws as the Gamma-Poisson mixture (the
    reference's construction)."""
    return torch.poisson(_standard_gamma(gen, shape_) * scale, generator=gen)


sample_uniform = _sampler(
    "sample_uniform", 2, lambda gen, lo, hi: lo + torch.rand(
        lo.shape, generator=gen, device=lo.device) * (hi - lo))
sample_normal = _sampler(
    "sample_normal", 2, lambda gen, mu, sigma: mu + torch.randn(
        mu.shape, generator=gen, device=mu.device) * sigma)
sample_gamma = _sampler(
    "sample_gamma", 2,
    lambda gen, alpha, beta: _standard_gamma(gen, alpha) * beta)
sample_exponential = _sampler(
    "sample_exponential", 1, lambda gen, lam: torch.empty(
        lam.shape, device=lam.device).exponential_(generator=gen) / lam)
sample_poisson = _sampler(
    "sample_poisson", 1,
    lambda gen, lam: torch.poisson(lam.contiguous(), generator=gen))
sample_negative_binomial = _sampler(
    "sample_negative_binomial", 2,
    lambda gen, k, p: _gamma_poisson(gen, k, (1 - p) / torch.clamp(
        p, min=1e-12)))
sample_generalized_negative_binomial = _sampler(
    "sample_generalized_negative_binomial", 2,
    lambda gen, mu, alpha: _gamma_poisson(
        gen, 1 / torch.clamp(alpha, min=1e-12),
        mu * torch.clamp(alpha, min=1e-12)))


@_register
def sample_multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """Draws from the rows of ``data`` (probabilities on the last axis):
    ``data.shape[:-1] + shape``; with ``get_prob`` also each draw's
    ``log(max(p, 1e-30))``."""
    from . import random as _rnd
    data = _nd(data)
    extra = () if shape is None else (
        (shape,) if isinstance(shape, int) else tuple(shape))
    n = int(_np.prod(extra)) if extra else 1
    p = data._data
    gen = _rnd.generator(p.device)
    rows = p.reshape(-1, p.shape[-1]).float()
    with torch.no_grad():
        draws = torch.multinomial(rows, n, replacement=True, generator=gen)
    out_shape = tuple(p.shape[:-1]) + extra
    out = NDArray(draws.reshape(out_shape).to(_dtype_of(dtype)))
    if not get_prob:
        return out
    logp = apply(lambda t: torch.gather(
        torch.log(torch.clamp(t.reshape(-1, t.shape[-1]), min=1e-30)), 1,
        draws).reshape(out_shape), [data])
    return [out, logp]


@_register
def random_uniform(*args, **kwargs):
    """The reference's ``_random_uniform``: ``nd.random.uniform``."""
    from . import random as _rnd
    return _rnd.uniform(*args, **kwargs)


@_register
def random_normal(*args, **kwargs):
    """The reference's ``_random_normal``: ``nd.random.normal``."""
    from . import random as _rnd
    return _rnd.normal(*args, **kwargs)


def _pdf_op(name, logpdf, n_params, event_dims=0):
    def op(sample, *params, is_log=False):
        if len(params) != n_params:
            raise MXNetError(f"{name} expects {n_params} parameter "
                             f"array(s), got {len(params)}")

        def fn(s, *ps):
            # the parameters broadcast over the trailing sample axis
            # (dirichlet's event axis stays last)
            ps = [p.unsqueeze(-1 - event_dims) for p in ps]
            lp = logpdf(s, *ps)
            return lp if is_log else torch.exp(lp)
        return apply(fn, [sample] + [_nd(p, sample) for p in params])
    op.__name__ = name
    op.__doc__ = (f"{name}(sample, *params, is_log=False): the density (or "
                  "log-density) of each sample under its row's parameters "
                  "(reference src/operator/random/pdf_op.cc).")
    return _register(op)


def _lgamma(x):
    return torch.lgamma(x.float())


def _gnb_logpdf(s, mu, alpha):
    r = 1.0 / alpha
    p = r / (r + mu)
    return (_lgamma(s + r) - _lgamma(s + 1) - _lgamma(r)
            + r * torch.log(p) + s * torch.log1p(-p))


random_pdf_uniform = _pdf_op(
    "random_pdf_uniform", lambda s, low, high: torch.where(
        (s >= low) & (s <= high), -torch.log(high - low),
        torch.full_like(s, -math.inf)), 2)
random_pdf_normal = _pdf_op(
    "random_pdf_normal", lambda s, mu, sigma: -0.5 * torch.square(
        (s - mu) / sigma) - torch.log(sigma) - 0.5 * math.log(2 * math.pi), 2)
random_pdf_gamma = _pdf_op(
    "random_pdf_gamma", lambda s, alpha, beta: (alpha - 1) * torch.log(s)
    - s * beta + alpha * torch.log(beta) - _lgamma(alpha), 2)
random_pdf_exponential = _pdf_op(
    "random_pdf_exponential", lambda s, lam: torch.log(lam) - lam * s, 1)
random_pdf_poisson = _pdf_op(
    "random_pdf_poisson",
    lambda s, lam: s * torch.log(lam) - lam - _lgamma(s + 1), 1)
random_pdf_negative_binomial = _pdf_op(
    "random_pdf_negative_binomial", lambda s, k, p: _lgamma(s + k)
    - _lgamma(s + 1) - _lgamma(k) + k * torch.log(p)
    + s * torch.log1p(-p), 2)
random_pdf_generalized_negative_binomial = _pdf_op(
    "random_pdf_generalized_negative_binomial", _gnb_logpdf, 2)
random_pdf_dirichlet = _pdf_op(
    "random_pdf_dirichlet", lambda s, alpha: torch.sum(
        (alpha - 1) * torch.log(s), dim=-1)
    + _lgamma(torch.sum(alpha, dim=-1)) - torch.sum(_lgamma(alpha), dim=-1),
    1, event_dims=1)


# ===========================================================================
# the rest of the registry (reference: the tail of ops.py, from its
# elementwise math to its vision and control-flow ops).  The reference
# runs JAX with 64-bit types off, so an integer result is int32 and a
# float result float32 wherever jnp would widen; each op here casts to the
# reference's dtype.  None reaches a kernel of the port: XLA fused these
# ops in the reference, so they are plain PyTorch.
# ===========================================================================

def _inexact(t):
    """``t`` as jnp's inexact ops take it: integers and booleans become
    float32."""
    return t if t.is_floating_point() else t.float()


def _apply_n(fn, inputs, n):
    """``fn``'s ``n`` outputs as a list of NDArrays, one included."""
    if n == 1:
        return [apply(lambda *ts: fn(*ts)[0], inputs)]
    return apply(fn, inputs, n_out=n)


def _promote(*ts):
    dt = functools.reduce(torch.promote_types, [t.dtype for t in ts])
    return [t.to(dt) for t in ts]


def _const(v, dtype, device):
    """``v``, a number or a short sequence of numbers, as a tensor made
    by fills on ``device``: a CUDA graph capture cannot hold a copy from
    the host, and a hybridized block's ops run inside one."""
    if _np.ndim(v) == 0:
        return torch.full((), _np.asarray(v).item(), dtype=dtype,
                          device=device)
    vals = _np.asarray(v)
    out = torch.empty(vals.size, dtype=dtype, device=device)
    for i, x in enumerate(vals.reshape(-1).tolist()):
        out[i].fill_(x)
    return out.reshape(vals.shape)


def host_sync(name):
    """Refuse ``name`` inside a CUDA graph capture (a hybridized block's
    capture, a trainer's or an engine's): the op reads the device from
    the host or makes a shape from the data, which a captured graph
    cannot replay.  The reference fails the same way under ``jit``."""
    if _tape.capturing():
        raise MXNetError(
            f"{name} needs a host sync (a data-dependent shape or a host "
            "read) and cannot run inside a CUDA graph capture: call it "
            "outside the hybridized block")


def _funary(name, tfn):
    """A unary op over jnp's inexact promotion."""
    return _unary(name, lambda t: tfn(_inexact(t)))


def _cbrt(t):
    t = _inexact(t)
    return torch.sign(t) * torch.pow(torch.abs(t), 1.0 / 3.0)


arcsin = _funary("arcsin", torch.asin)
arccos = _funary("arccos", torch.acos)
arctan = _funary("arctan", torch.atan)
sinh = _funary("sinh", torch.sinh)
cosh = _funary("cosh", torch.cosh)
arcsinh = _funary("arcsinh", torch.asinh)
arccosh = _funary("arccosh", torch.acosh)
arctanh = _funary("arctanh", torch.atanh)
degrees = _funary("degrees", lambda t: t * (180.0 / math.pi))
radians = _funary("radians", lambda t: t * (math.pi / 180.0))
cbrt = _unary("cbrt", _cbrt)
rcbrt = _unary("rcbrt", lambda t: 1.0 / _cbrt(t))
erfinv = _funary("erfinv", torch.erfinv)
digamma = _funary("digamma", torch.digamma)
gammaln = _funary("gammaln", torch.lgamma)
# exp(gammaln): |Γ(x)| for negative x, as the reference computes it
gamma = _funary("gamma", lambda t: torch.exp(torch.lgamma(t)))
fix = _unary("fix", lambda t: torch.trunc(t) if t.is_floating_point()
             else t.clone())
# torch.round rounds half to even, as jnp.rint does
rint = _funary("rint", torch.round)
gelu = _funary("gelu", _gelu)
mish = _funary("mish", F.mish)
relu6 = _funary("relu6", lambda t: torch.clamp(t, 0.0, 6.0))
selu = _funary("selu", F.selu)
softrelu = _funary("softrelu", F.softplus)
log_sigmoid = _funary("log_sigmoid", F.logsigmoid)
silu = _funary("silu", F.silu)
swish = _funary("swish", F.silu)
isnan = _unary("isnan", torch.isnan)
isinf = _unary("isinf", torch.isinf)
isfinite = _unary("isfinite", torch.isfinite)
isposinf = _unary("isposinf", lambda t: torch.isposinf(t).float())
isneginf = _unary("isneginf", lambda t: torch.isneginf(t).float())


@_register
def hard_sigmoid(data, alpha=0.2, beta=0.5):
    """``clip(alpha x + beta, 0, 1)``."""
    return apply(lambda t: torch.clamp(alpha * t + beta, 0.0, 1.0), [data])


@_register
def elu(data, alpha=1.0):
    return apply(lambda t: torch.where(t > 0, t, alpha * torch.expm1(t)),
                 [data])


@_register
def softmin(data, axis=-1):
    return apply(lambda t: torch.softmax(-t, axis), [data])


@_register
def SoftmaxActivation(data, mode="instance"):
    """Softmax over the channels (``mode="channel"``, axis 1) or the last
    axis."""
    return softmax(data, axis=1 if mode == "channel" else -1)


@_register
def nan_to_num(data, copy=True, nan=0.0, posinf=None, neginf=None):
    """NaN to ``nan``, infinities to ``posinf``/``neginf`` (the dtype's
    largest and smallest by default); ``copy=False`` writes the result
    into ``data``."""
    out = apply(lambda t: torch.nan_to_num(t, nan, posinf, neginf)
                if t.is_floating_point() else t.clone(), [data])
    if not copy:
        data._write(out._data)
        return data
    return out


def _scalar_tensor(b, like):
    """A Python number ``b`` in ``like``'s dtype (jnp's weak typing)."""
    return b if torch.is_tensor(b) else _const(b, like.dtype, like.device)


def _inexact_pair(a, b):
    """``a`` and ``b`` under jnp's inexact promotion, a Python number
    ``b`` taking ``a``'s float dtype."""
    a = _inexact(a)
    return _promote(a, _inexact(_scalar_tensor(b, a)))


hypot = _binary("hypot", lambda a, b: torch.hypot(*_inexact_pair(a, b)))
arctan2 = _binary("arctan2", lambda a, b: torch.atan2(*_inexact_pair(a, b)))
logical_xor = _binary("logical_xor", lambda a, b: torch.logical_xor(
    a != 0, _scalar_tensor(b, a) != 0).float())
broadcast_hypot = _register(getattr(hypot, "__wrapped__", hypot),
                            "broadcast_hypot")
broadcast_logical_xor = _register(
    getattr(logical_xor, "__wrapped__", logical_xor), "broadcast_logical_xor")


def _binary_nd(name, tfn):
    """The reference's second binary form: a Python number becomes a
    float32 array first (``_nd``), so it promotes as an array (with an
    integer operand, to float32), where ``_binary`` passes it on as a
    number that takes the other operand's dtype."""
    def op(lhs, rhs, **kwargs):
        return apply(tfn, [lhs, _nd(rhs, lhs)])
    op.__name__ = name
    op.__doc__ = f"Elementwise {name} (reference: elemwise_binary_op_basic)."
    return _register(op)


def _outer(a, b):
    return a.reshape(-1, 1) * b.reshape(1, -1)


fmod = _binary_nd("fmod", torch.fmod)
# C fmod: the sign of the dividend (not torch.remainder)
mod = _binary_nd("mod", torch.fmod)
floor_divide = _binary_nd("floor_divide", torch.floor_divide)
true_divide = _binary_nd("true_divide", torch.true_divide)
outer = _binary_nd("outer", _outer)
inner = _binary_nd("inner", lambda a, b: torch.inner(*_promote(a, b)))
vdot = _binary_nd("vdot", lambda a, b: torch.dot(
    *_promote(a.reshape(-1), b.reshape(-1))))
kron = _binary_nd("kron", lambda a, b: torch.kron(*_promote(a, b)))
matmul = _binary_nd("matmul", lambda a, b: torch.matmul(*_promote(a, b)))


@_register
def divmod(lhs, rhs):
    """``(floor(a / b), a - floor(a / b) b)``."""
    def fn(a, b):
        q = torch.floor_divide(a, b)
        return q, a - q * b
    return apply(fn, [lhs, _nd(rhs, lhs)], n_out=2)


@_register
def tensordot(a, b, axes=2):
    if isinstance(axes, (list, tuple)) and all(
            isinstance(x, int) for x in axes):
        axes = ([axes[0]], [axes[1]])
    return apply(lambda x, y: torch.tensordot(*_promote(x, y), dims=axes),
                 [a, _nd(b, a)])


# the integer ops: a Python number takes the other operand's integer
# dtype (the reference passes it to jnp raw)
bitwise_and = _binary("bitwise_and", lambda a, b: torch.bitwise_and(
    a, _scalar_tensor(b, a)))
bitwise_or = _binary("bitwise_or", lambda a, b: torch.bitwise_or(
    a, _scalar_tensor(b, a)))
bitwise_xor = _binary("bitwise_xor", lambda a, b: torch.bitwise_xor(
    a, _scalar_tensor(b, a)))
left_shift = _binary("left_shift", lambda a, b: torch.bitwise_left_shift(
    a, _scalar_tensor(b, a)))
right_shift = _binary("right_shift", lambda a, b: torch.bitwise_right_shift(
    a, _scalar_tensor(b, a)))
lcm = _binary("lcm", lambda a, b: torch.lcm(a, _scalar_tensor(b, a)))
gcd = _binary("gcd", lambda a, b: torch.gcd(a, _scalar_tensor(b, a)))


@_register
def bitwise_not(data):
    return apply(torch.bitwise_not, [data])


invert = _alias("invert", bitwise_not)


# ---- scans, reductions and numpy-style numerics ----

def _flat_axis(t, axis):
    return (t.reshape(-1), 0) if axis is None else (t, axis)


def _scan_dtype(t, dtype=None):
    if dtype is not None:
        return _dtype_of(dtype)
    return t.dtype if t.is_floating_point() else torch.int32


@_register
def cumsum(a, axis=None, dtype=None):
    """Over the flattened array when ``axis`` is None; integers sum in
    int32."""
    def fn(t):
        t, ax = _flat_axis(t, axis)
        return torch.cumsum(t, ax).to(_scan_dtype(t, dtype))
    return apply(fn, [a])


@_register
def cumprod(a, axis=None):
    def fn(t):
        t, ax = _flat_axis(t, axis)
        return torch.cumprod(t, ax).to(_scan_dtype(t))
    return apply(fn, [a])


nanprod = _reduce("nanprod", lambda t, d, k=False: _prod(
    torch.where(torch.isnan(t), torch.ones_like(t), t), d, k))


@_register
def mp_sum(*args, **kwargs):
    """The reference's alias of ``sum``."""
    return sum(*args, **kwargs)


@_register
def moments(data, axes=None, keepdims=False):
    """``(mean, biased variance)`` over ``axes`` (all by default)."""
    ax = tuple(axes) if isinstance(axes, (list, tuple)) else axes

    def fn(t):
        dims = tuple(range(t.dim())) if ax is None else ax
        v, m = torch.var_mean(t, dims, correction=0, keepdim=keepdims)
        return m, v
    return apply(fn, [data], n_out=2)


@_register
def ediff1d(data, to_end=None, to_begin=None):
    """The differences of the flattened array, with ``to_begin`` before
    and ``to_end`` after (in its dtype)."""
    def fn(t):
        out = torch.diff(t.reshape(-1))
        parts = [_const(v, out.dtype, out.device).reshape(-1)
                 if v is not None else None for v in (to_begin, to_end)]
        return torch.cat([p for p in (parts[0], out, parts[1])
                          if p is not None])
    return apply(fn, [data])


@_register
def interp(x, xp, fp, left=None, right=None):
    """Piecewise-linear interpolation (``jnp.interp``'s formula: the
    interval by a right-side search, a zero-width interval takes its
    left value)."""
    def fn(a, b, c):
        a, b = _promote(_inexact(a), _inexact(b))
        c = _inexact(c)
        i = torch.clamp(torch.searchsorted(b, a, side="right"), 1,
                        b.shape[0] - 1)
        df = c[i] - c[i - 1]
        dx = b[i] - b[i - 1]
        delta = a - b[i - 1]
        eps = float(_np.spacing(_np.finfo(_np.float32).eps))
        dx0 = torch.abs(dx) <= eps
        f = torch.where(dx0, c[i - 1], c[i - 1] + (
            delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
        lo = c[0] if left is None else _const(left, f.dtype, f.device)
        hi = c[-1] if right is None else _const(right, f.dtype, f.device)
        f = torch.where(a < b[0], lo, f)
        return torch.where(a > b[-1], hi, f)
    return apply(fn, [x, _nd(xp, x), _nd(fp, x)])


@_register
def polyval(p, x):
    """Horner's rule from the highest coefficient, as ``jnp.polyval``."""
    def fn(pp, xx):
        pp, xx = _promote(_inexact(pp), _inexact(xx))
        y = torch.zeros(torch.broadcast_shapes(pp.shape[1:], xx.shape),
                        dtype=xx.dtype, device=xx.device)
        for k in range(pp.shape[0]):
            y = y * xx + pp[k]
        return y
    return apply(fn, [_nd(p, x), x])


def _search(sorted_seq, values, side):
    a, v = _promote(sorted_seq, values)
    return torch.searchsorted(a.contiguous(), v.contiguous(), side=side)


@_register
def searchsorted(a, v, side="left", sorter=None):
    """int32 insertion points of ``v`` in the sorted 1-D ``a``."""
    if sorter is not None:
        raise MXNetError("searchsorted: sorter is not supported; pre-sort "
                         "the input")
    return apply(lambda s, x: _search(s, x, side).to(torch.int32),
                 [a, _nd(v, a)])


@_register
def digitize(data, bins, right=False):
    """int32 bin indices (numpy's, increasing or decreasing bins)."""
    side = "left" if right else "right"

    def fn(d, b):
        up = _search(b, d, side)
        down = b.shape[0] - _search(torch.flip(b, (0,)), d, side)
        return torch.where(b[-1] >= b[0], up, down).to(torch.int32)
    return apply(fn, [data, _nd(bins, data)])


def _linspace_t(lo, hi, num):
    """``jnp.linspace(lo, hi, num)`` over float32 device scalars
    (``start (1 - s) + stop s``, ``s = i / (num - 1)``, the stop
    itself last), as the port's ``nd.linspace`` computes it."""
    div = num - 1
    s = torch.arange(div, dtype=torch.float32, device=lo.device) * \
        _const(1.0 / div, torch.float32, lo.device)
    return torch.cat([lo * (1 - s) + hi * s, hi.reshape(1)])


@_register
def histogram(data, bins=10, range=None):
    """``(counts, edges)`` as ``jnp.histogram``: float32 counts, the last
    bin closed, edges over ``range`` or the data's min and max (widened
    by 0.5 each way when they are equal); ``bins`` a count or the edges.
    Not differentiable (the input is detached)."""
    host_sync("histogram")
    d = _inexact(_nd(data)._data.detach()).reshape(-1)
    if isinstance(bins, (NDArray, list, tuple, _np.ndarray)):
        edges = _inexact(_nd(bins, _nd(data))._data.detach()).to(d.dtype)
    else:
        if range is None:
            lo, hi = torch.amin(d), torch.amax(d)
        else:
            lo, hi = (_const(float(v), d.dtype, d.device) for v in range)
        same = lo == hi
        lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5,
                                                               hi)
        edges = _linspace_t(lo, hi, int(bins) + 1)
    idx = torch.searchsorted(edges, d, side="right")
    idx = torch.where(d == edges[-1], edges.shape[0] - 1, idx)
    keep = idx < edges.shape[0]          # past the last edge: dropped
    counts = torch.zeros(edges.shape[0], dtype=d.dtype, device=d.device)
    counts.index_add_(0, idx[keep], torch.ones_like(d[keep]))
    return [NDArray(counts[1:]), NDArray(edges)]


@_register
def bincount(data, weights=None, minlength=0):
    """Counts (int32), or sums of ``weights``, of each non-negative
    integer value (negative values count as 0); the length is
    ``max(minlength, max + 1)``, read from the device.  Not
    differentiable (the inputs are detached)."""
    host_sync("bincount")
    x = torch.clamp(_nd(data)._data.detach().to(torch.int32), min=0)
    x = x.reshape(-1).long()
    n = _builtins.max(int(minlength), int(x.max()) + 1 if x.numel() else 0)
    if weights is None:
        w = torch.ones(x.shape, dtype=torch.int32, device=x.device)
    else:
        w = _nd(weights, _nd(data))._data.detach().reshape(-1)
    return NDArray(torch.zeros(n, dtype=w.dtype, device=x.device)
                   .index_add_(0, x, w))


@_register
def unique(data):
    """The sorted unique values of the flattened array.  Not
    differentiable (the input is detached)."""
    host_sync("unique")
    return NDArray(torch.unique(_nd(data)._data.detach().reshape(-1)))


# ---- ordering (reference: src/operator/tensor/ordering_op.cc) ----
# The reference sorts stably ascending and flips for descending order,
# so among equal values a descending sort puts the later index first;
# its topk (lax.top_k) puts the lower index first.  Every order here is
# a stable sort, which is the same on the CPU and on the card.

@_register
def sort(data, axis=-1, is_ascend=True):
    def fn(t):
        t, ax = _flat_axis(t, axis)
        out = torch.sort(t, dim=ax, stable=True).values
        return out if is_ascend else torch.flip(out, (ax,))
    return apply(fn, [data])


@_register
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    dt = _dtype_of(dtype)

    def fn(t):
        t, ax = _flat_axis(t, axis)
        out = torch.argsort(t, dim=ax, stable=True)
        return (out if is_ascend else torch.flip(out, (ax,))).to(dt)
    return apply(fn, [data])


@_register
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``, the
    lower index first among equal values: ``ret_typ`` "value", "both"
    (values, indices) or the indices, in ``dtype``."""
    dt = _dtype_of(dtype)

    def fn(t):
        ax = axis % t.dim()
        last = ax == t.dim() - 1
        x = t if last else t.transpose(ax, -1)
        vals, idx = torch.sort(x, dim=-1, descending=not is_ascend,
                               stable=True)
        vals, idx = vals[..., :k], idx[..., :k]
        if not last:
            vals, idx = vals.transpose(ax, -1), idx.transpose(ax, -1)
        if ret_typ == "value":
            return vals
        if ret_typ == "both":
            return vals, idx.to(dt)
        return idx.to(dt)
    return apply(fn, [data], n_out=2 if ret_typ == "both" else 1)


@_register
def argmax_channel(data):
    """float32 argmax over axis 1."""
    return apply(lambda t: torch.argmax(t, 1).float(), [data])


# ---- indexing (reference: src/operator/tensor/indexing_op.cc,
# ravel.cc) ----

def _wrap_index(i, n):
    """Negative indices count from the end (jnp normalizes them)."""
    i = i.long()
    return torch.where(i < 0, i + n, i)


@_register
def gather_nd(data, indices):
    """``data[indices[0], ..., indices[M - 1]]``: indices (M, ...)
    address the first M axes; an index past an axis is clamped to it."""
    def fn(d, i):
        idx = tuple(torch.clamp(_wrap_index(i[k], d.shape[k]), 0,
                                d.shape[k] - 1) for k in range(i.shape[0]))
        return d[idx]
    return apply(fn, [data, _nd(indices, data)])


@_register
def scatter_nd(data, indices, shape):
    """Zeros of ``shape`` with ``data`` added at ``indices`` (duplicates
    add; an index past an axis is dropped)."""
    shape = tuple(int(s) for s in shape)

    def fn(d, i):
        idx = [_wrap_index(i[k], shape[k]) for k in range(i.shape[0])]
        ok = functools.reduce(torch.logical_and, [
            (x >= 0) & (x < shape[k]) for k, x in enumerate(idx)])
        idx = tuple(torch.where(ok, x, 0) for x in idx)
        vals = torch.where(ok.reshape(ok.shape + (1,) * (
            d.dim() - ok.dim())), d, torch.zeros((), dtype=d.dtype,
                                                 device=d.device))
        out = torch.zeros(shape, dtype=d.dtype, device=d.device)
        return out.index_put(idx, vals, accumulate=True)
    return apply(fn, [data, _nd(indices, data)])


@_register
def batch_take(a, indices):
    """``a[i, indices[i]]`` for each row ``i``."""
    def fn(d, i):
        ii = torch.clamp(_wrap_index(i.reshape(-1), d.shape[1]), 0,
                         d.shape[1] - 1)
        return torch.gather(d, 1, ii.reshape(-1, 1)).squeeze(1)
    return apply(fn, [a, _nd(indices, a)])


@_register
def choose_element_0index(data, index, axis=1, keepdims=False):
    """``pick`` along the row axis (the reference's legacy op)."""
    return pick(data, index, axis=axis, keepdims=keepdims)


@_register
def fill_element_0index(lhs, mhs, rhs):
    """``lhs`` with ``lhs[i, rhs[i]] = mhs[i]`` for each row."""
    def fn(l, m, r):
        rows = torch.arange(l.shape[0], device=l.device)
        return l.index_put((rows, r.long()), m.to(l.dtype))
    return apply(fn, [lhs, _nd(mhs, lhs), _nd(rhs, lhs)])


@_register
def one_hot_encode(indices, out):
    """Write ``out[i] = one_hot(indices[i])`` in place (``out`` (N, C)
    gives the class count and the dtype); returns ``out``."""
    if out.ndim != 2 or indices.ndim != 1:
        raise MXNetError("one_hot_encode expects indices (N,), out (N, C)")
    n, c = out.shape
    if indices.shape[0] != n:
        raise MXNetError(f"one_hot_encode: indices length "
                         f"{indices.shape[0]} != out rows {n}")
    res = apply(lambda i: _onehot(i.to(torch.int32), c, out._data.dtype),
                [indices])
    out._write(res._data)
    return out


onehot_encode = _alias("onehot_encode", one_hot_encode)


@_register
def ravel_multi_index(data, shape):
    """(ndim, n) coordinates to int32 flat indices into ``shape``."""
    shape = tuple(int(s) for s in shape)
    strides = _np.cumprod((1,) + shape[:0:-1])[::-1].copy()

    def fn(d):
        st = _const(strides, torch.int32, d.device)
        return torch.sum(d.to(torch.int32) * st[:, None], 0,
                         dtype=torch.int32)
    return apply(fn, [data])


@_register
def unravel_index(data, shape):
    """int32 flat indices to (ndim, n) coordinates in ``shape``; an index
    past either end gives the nearest corner (``jnp.unravel_index``)."""
    shape = tuple(int(s) for s in shape)

    def fn(d):
        rest = d.to(torch.int32)
        coords = [None] * len(shape)
        for k in reversed(range(len(shape))):
            coords[k] = torch.remainder(rest, shape[k])
            rest = torch.div(rest, shape[k], rounding_mode="floor")
        over, under = rest > 0, rest < -1
        return torch.stack([torch.where(over, s - 1, torch.where(under, 0, c))
                            for s, c in zip(shape, coords)]).to(torch.int32)
    return apply(fn, [data])


@_register
def slice_like(data, shape_like, axes=None):
    """``data`` cut to ``shape_like``'s size on ``axes`` (all by
    default), from the start."""
    def fn(d, ref):
        sl = [_builtins.slice(None)] * d.dim()
        for a in (axes if axes is not None else range(d.dim())):
            sl[a] = _builtins.slice(0, ref.shape[a])
        return d[tuple(sl)]
    return apply(fn, [data, shape_like])


@_register
def diag(data, k=0):
    """A vector's diagonal matrix or a matrix's ``k``-th diagonal; past
    two axes, the diagonal of the first two (last in the output)."""
    def fn(t):
        if t.dim() <= 2:
            return torch.diag(t, k)
        return torch.diagonal(t, k, 0, 1)
    return apply(fn, [data])


@_register
def tril(data, k=0):
    return apply(lambda t: torch.tril(t, k), [data])


@_register
def triu(data, k=0):
    return apply(lambda t: torch.triu(t, k), [data])


@_register
def trace(data, offset=0, axis1=0, axis2=1):
    """The sum of each diagonal; integers sum in int32."""
    return apply(lambda t: torch.diagonal(t, offset, axis1, axis2).sum(
        -1, dtype=_scan_dtype(t)), [data])


reverse = _alias("reverse", flip)
SwapAxis = _alias("SwapAxis", swapaxes)
embedding = _alias("embedding", Embedding)


@_register
def rot90(data, k=1, axes=(0, 1)):
    return apply(lambda t: torch.rot90(t, k, list(axes)), [data])


@_register
def shape_array(data):
    """The shape as an int32 vector."""
    return NDArray(_const(data.shape, torch.int32, data._data.device))


@_register
def size_array(data):
    """The element count as a one-element int32 vector."""
    return NDArray(_const([data.size], torch.int32, data._data.device))


@_register
def arange_like(data, start=0.0, step=1.0, repeat=1, ctx=None, axis=None):
    """``start + step (i // repeat)`` over ``data``'s elements (shaped
    like it) or along ``axis``, in ``data``'s dtype."""
    def fn(t):
        n = t.shape[axis] if axis is not None else t.numel()
        q = torch.div(torch.arange(n, device=t.device), repeat,
                      rounding_mode="floor").float()
        dt = t.dtype if t.dtype != torch.bool else torch.float32
        vals = (start + step * q).to(dt)
        return vals if axis is not None else vals.reshape(t.shape)
    return apply(fn, [data])


@_register
def full_like(data, fill_value, dtype=None):
    return apply(lambda t: torch.full_like(
        t, fill_value, dtype=_dtype_of(dtype) if dtype else t.dtype),
        [data])


@_register
def khatri_rao(*args):
    """The column-wise Kronecker product: (m, k) x (n, k) -> (m n, k)."""
    if not args:
        raise MXNetError("khatri_rao needs at least one matrix")

    def fn(*ms):
        out = ms[0]
        for m in ms[1:]:
            out = (out.unsqueeze(1) * m.unsqueeze(0)).reshape(
                -1, out.shape[1])
        return out
    return apply(fn, [_nd(a) for a in args])


@_register
def meshgrid(*arrays, indexing="xy"):
    """numpy's meshgrid: a list of arrays, each in its own dtype."""
    arrs = [_nd(a) for a in arrays]

    def fn(*ts):
        sizes = [t.numel() for t in ts]
        pos = list(range(len(ts)))
        if indexing == "xy" and len(ts) > 1:
            pos[0], pos[1] = 1, 0
        full_shape = [0] * len(ts)
        for i, s in enumerate(sizes):
            full_shape[pos[i]] = s
        outs = []
        for i, t in enumerate(ts):
            shape = [1] * len(ts)
            shape[pos[i]] = -1
            outs.append(t.reshape(shape).expand(full_shape).contiguous())
        return tuple(outs)
    return _apply_n(fn, arrs, len(arrs))


def _stacker(name, tfn):
    def op(*arrays, **kwargs):
        if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
            arrays = tuple(arrays[0])
        return apply(lambda *ts: tfn(_promote(*ts)), [_nd(a) for a in arrays])
    op.__name__ = name
    op.__doc__ = f"numpy's {name}."
    return _register(op)


hstack = _stacker("hstack", torch.hstack)
vstack = _stacker("vstack", torch.vstack)
dstack = _stacker("dstack", torch.dstack)


def _splitter(name, tfn):
    def op(data, indices_or_sections):
        n = indices_or_sections if isinstance(indices_or_sections, int) \
            else len(indices_or_sections) + 1
        sec = indices_or_sections if isinstance(indices_or_sections, int) \
            else list(indices_or_sections)
        return _apply_n(lambda t: tuple(tfn(t, sec)), [data], n)
    op.__name__ = name
    op.__doc__ = f"numpy's {name}: always a list."
    return _register(op)


hsplit = _splitter("hsplit", torch.hsplit)
vsplit = _splitter("vsplit", torch.vsplit)


# ---- sequence ops (reference: src/operator/sequence_*.cc): time on
# ``axis`` (0 or 1), the batch on the other ----

def _batch_shape(d, axis):
    shape = [1] * d.dim()
    shape[1 - axis] = d.shape[1 - axis]
    return shape


@_register
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """Steps at or past each sequence's length set to ``value``."""
    if not use_sequence_length or sequence_length is None:
        return identity(data)

    def fn(d, sl):
        tshape = [1] * d.dim()
        tshape[axis] = d.shape[axis]
        steps = torch.arange(d.shape[axis], device=d.device).reshape(tshape)
        mask = steps < sl.reshape(_batch_shape(d, axis))
        return d.masked_fill(~mask, value)
    return apply(fn, [data, _nd(sequence_length, data)])


@_register
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """Each sequence's last valid step (the last step without lengths)."""
    if not use_sequence_length or sequence_length is None:
        return slice_axis(data, axis=axis, begin=-1, end=None).squeeze(axis)

    def fn(d, sl):
        idx = (sl.to(torch.int32) - 1).long().reshape(_batch_shape(d, axis))
        shape = list(d.shape)
        shape[axis] = 1
        return torch.gather(d, axis, idx.expand(shape)).squeeze(axis)
    return apply(fn, [data, _nd(sequence_length, data)])


@_register
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each sequence's first ``length`` steps reversed, the rest in
    place.  With lengths the reference gathers along axis 0 whatever
    ``axis`` says (its index is (T, B, 1, ...) broadcast to the data's
    shape), and so does this port: ``axis=1`` works where that
    broadcast does."""
    if not use_sequence_length or sequence_length is None:
        return flip(data, axis)

    def fn(d, sl):
        T = d.shape[axis]
        steps = torch.arange(T, device=d.device).reshape(
            (-1,) + (1,) * (d.dim() - 1))
        sl_b = sl.to(torch.int32).long().reshape((1, -1) + (1,) * (
            d.dim() - 2))
        rev = torch.where(steps < sl_b, sl_b - 1 - steps, steps)
        try:
            rev = rev.expand(d.shape)
        except RuntimeError as e:
            raise MXNetError(f"sequence_reverse: index of shape "
                             f"{tuple(rev.shape)} does not broadcast to the "
                             f"data's {tuple(d.shape)}") from e
        return torch.gather(d, 0, rev)
    return apply(fn, [data, _nd(sequence_length, data)])


SequenceMask = _alias("SequenceMask", sequence_mask)
SequenceLast = _alias("SequenceLast", sequence_last)
SequenceReverse = _alias("SequenceReverse", sequence_reverse)


# ---- vision and neural-network ops (reference: src/operator/{lrn,
# l2_normalization,upsampling,crop,correlation,grid_generator,
# bilinear_sampler,spatial_transformer}.cc, nn/softmax.cc, nn/im2col.h) ----

@_register
def masked_softmax(data, mask, axis=-1, temperature=1.0):
    """Softmax over the positions where ``mask`` is nonzero; the others
    take probability 0 (a row with none gives zeros)."""
    def fn(d, m):
        keep = m.to(torch.bool)
        neg = torch.finfo(d.dtype if d.is_floating_point()
                          else torch.float32).min
        z = (d / temperature).masked_fill(~keep, neg)
        p = torch.softmax(z, axis)
        return torch.where(keep, p, torch.zeros((), dtype=p.dtype,
                                                device=p.device))
    return apply(fn, [data, _nd(mask, data)])


@_register
def L2Normalization(data, eps=1e-10, mode="instance"):
    """``x / sqrt(sum x^2 + eps)`` over every axis after the first
    (``mode="channel"``: over axis 1; the reference reads any other mode
    as "instance")."""
    def fn(d):
        axes = (1,) if mode == "channel" else tuple(range(1, d.dim()))
        return d / torch.sqrt(torch.sum(torch.square(d), axes,
                                        keepdim=True) + eps)
    return apply(fn, [data])


@_register
def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across channels: ``x / (knorm +
    alpha / nsize * sum of x^2 over nsize neighbouring channels)^beta``,
    the window summed in the reference's order."""
    def fn(d):
        half = nsize // 2
        padded = F.pad(torch.square(d), (0, 0) * (d.dim() - 2) +
                       (half, half))
        acc = torch.zeros_like(d)
        for i in range(nsize):
            acc = acc + padded.narrow(1, i, d.shape[1])
        return d / torch.pow(knorm + alpha * acc / nsize, beta)
    return apply(fn, [data])


@_register
def UpSampling(*data, scale=2, sample_type="nearest", num_filter=0,
               num_args=1):
    """NCHW upsampling by ``scale`` (nearest, or bilinear with half-pixel
    centres); several inputs are each resized to the first's target and
    concatenated on the channels, as the reference does."""
    def one(d, th, tw):
        if sample_type == "nearest" and th == d.shape[2] * scale and \
                tw == d.shape[3] * scale:
            return torch.repeat_interleave(
                torch.repeat_interleave(d, scale, 2), scale, 3)
        if sample_type == "nearest":
            return F.interpolate(d, size=(th, tw), mode="nearest-exact")
        return F.interpolate(d, size=(th, tw), mode="bilinear",
                             align_corners=False)

    def fn(*ds):
        th, tw = ds[0].shape[2] * scale, ds[0].shape[3] * scale
        outs = [one(d, th, tw) for d in ds]
        return outs[0] if len(outs) == 1 else torch.cat(outs, 1)
    return apply(fn, [_nd(d) for d in data])


@_register
def Crop(*data, offset=(0, 0), h_w=(0, 0), num_args=1, center_crop=False):
    """The first NCHW input cut to the second's size (``num_args=2``) or
    to ``h_w``, at ``offset`` or centred."""
    x = data[0]
    if num_args == 2 and len(data) > 1:
        th, tw = data[1].shape[2], data[1].shape[3]
    else:
        th, tw = h_w
    if th <= 0 or tw <= 0:
        raise MXNetError("Crop needs a reference input (num_args=2) or a "
                         f"positive h_w, got {(th, tw)}")
    h, w = x.shape[2], x.shape[3]
    oy, ox = ((h - th) // 2, (w - tw) // 2) if center_crop else offset
    if oy < 0 or ox < 0 or oy + th > h or ox + tw > w:
        raise MXNetError(f"Crop window {(th, tw)} at offset {(oy, ox)} "
                         f"exceeds input {(h, w)}")
    return apply(lambda d: d[:, :, oy:oy + th, ox:ox + tw], [x])


def _window_start(start, size, pad):
    """Where the reference's ``lax.dynamic_slice`` starts a window of
    ``size`` in an axis padded by ``pad`` on each side: a negative start
    counts from the axis's end, then it is clamped into range."""
    if start < 0:
        start += size + 2 * pad
    return _builtins.min(_builtins.max(start, 0), 2 * pad)


@_register
def Correlation(data1, data2, kernel_size=1, max_displacement=4, stride1=1,
                stride2=1, pad_size=4, is_multiply=True):
    """FlowNet's correlation: for each displacement on the ``stride2``
    grid within ``max_displacement``, the channel mean of ``a`` times
    (or ``|a - b|`` with) ``b`` shifted by it, ``b`` zero-padded by
    ``pad_size``; (N, D^2, H, W), then every ``stride1``-th position."""
    if kernel_size != 1:
        raise MXNetError("Correlation: only kernel_size=1 is supported")

    def fn(a, b):
        n, c, h, w = a.shape
        bp = F.pad(b, (pad_size,) * 4)
        d = max_displacement
        outs = []
        for dy in range(-d, d + 1, stride2):
            for dx in range(-d, d + 1, stride2):
                oy, ox = _window_start(dy + pad_size, h, pad_size), \
                    _window_start(dx + pad_size, w, pad_size)
                shifted = bp[:, :, oy:oy + h, ox:ox + w]
                prod = a * shifted if is_multiply else torch.abs(a - shifted)
                outs.append(torch.mean(prod, 1))
        out = torch.stack(outs, 1)
        return out[:, :, ::stride1, ::stride1] if stride1 > 1 else out
    return apply(fn, [data1, _nd(data2, data1)])


@_register
def GridGenerator(data, transform_type="affine", target_shape=None):
    """``affine``: (B, 6) transforms to a (B, 2, H, W) grid of (x, y) in
    [-1, 1]; ``warp``: a (B, 2, H, W) flow field plus each position,
    scaled to [-1, 1]."""
    if transform_type == "affine":
        if target_shape is None:
            raise MXNetError("GridGenerator(affine) needs target_shape")
        h, w = int(target_shape[0]), int(target_shape[1])

        def fn(theta):
            dev = theta.device
            one = _const(1.0, torch.float32, dev)
            ys, xs = _linspace_t(-one, one, h), _linspace_t(-one, one, w)
            gy, gx = ys[:, None].expand(h, w), xs[None, :].expand(h, w)
            base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                                torch.ones(h * w, device=dev)])
            t = theta.reshape(theta.shape[0], 2, 3).float()
            return torch.matmul(t, base).reshape(theta.shape[0], 2, h, w)
        return apply(fn, [data])
    if transform_type == "warp":
        def fn(flow):
            b, _, h, w = flow.shape
            gy = torch.arange(h, dtype=torch.float32,
                              device=flow.device)[:, None].expand(h, w)
            gx = torch.arange(w, dtype=torch.float32,
                              device=flow.device)[None, :].expand(h, w)
            x = (gx[None] + flow[:, 0]) * (2.0 / _builtins.max(w - 1, 1)) - 1.0
            y = (gy[None] + flow[:, 1]) * (2.0 / _builtins.max(h - 1, 1)) - 1.0
            return torch.stack([x, y], 1)
        return apply(fn, [data])
    raise MXNetError(f"unknown transform_type {transform_type!r}")


def _bilinear_sample(d, g):
    """``d`` (B, C, H, W) at ``g`` (B, 2, Ho, Wo), (x, y) in [-1, 1]:
    each output the bilinear blend of its four neighbours, a neighbour
    outside the image taken as 0 (the reference's formula, so the
    gradients in ``d`` and ``g`` are its)."""
    b, c, h, w = d.shape
    x = (g[:, 0] + 1.0) * (w - 1) / 2.0
    y = (g[:, 1] + 1.0) * (h - 1) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    flat = d.reshape(b, c, h * w)

    def corner(yy, xx):
        yi = torch.clamp(yy.to(torch.int32), 0, h - 1).long()
        xi = torch.clamp(xx.to(torch.int32), 0, w - 1).long()
        valid = ((yy >= 0) & (yy <= h - 1) & (xx >= 0) &
                 (xx <= w - 1)).to(d.dtype)
        idx = (yi * w + xi).reshape(b, 1, -1).expand(b, c, -1)
        vals = torch.gather(flat, 2, idx).reshape((b, c) + tuple(yy.shape[1:]))
        return vals * valid[:, None]
    wx, wy = x - x0, y - y0
    wx, wy = wx[:, None], wy[:, None]
    return (corner(y0, x0) * (1 - wy) * (1 - wx) +
            corner(y0, x0 + 1) * (1 - wy) * wx +
            corner(y0 + 1, x0) * wy * (1 - wx) +
            corner(y0 + 1, x0 + 1) * wy * wx)


@_register
def BilinearSampler(data, grid, cudnn_off=None):
    """Sample ``data`` (B, C, H, W) at ``grid`` (B, 2, Ho, Wo), zero
    outside; differentiable in both."""
    return apply(_bilinear_sample, [data, _nd(grid, data)])


@_register
def SpatialTransformer(data, loc, target_shape=None, transform_type="affine",
                       sampler_type="bilinear", cudnn_off=None):
    """``GridGenerator`` (affine) then ``BilinearSampler``."""
    if transform_type != "affine" or sampler_type != "bilinear":
        raise MXNetError("SpatialTransformer supports affine/bilinear "
                         "(reference supports exactly these too)")
    return BilinearSampler(data, GridGenerator(
        loc, transform_type="affine", target_shape=target_shape))


def _patch_geometry(kernel, stride, dilate, pad):
    nd = len(kernel)
    return (tuple(kernel), _spatial(stride, nd, 1), _spatial(dilate, nd, 1),
            _spatial(pad, nd, 0))


def _patch_slices(spatial, k, s, dl, p):
    """For each kernel offset (row-major), the strided slice of each
    padded spatial axis it reads, and the output's spatial size."""
    out = [(spatial[i] + 2 * p[i] - dl[i] * (k[i] - 1) - 1) // s[i] + 1
           for i in range(len(k))]
    offsets = _np.ndindex(*k)
    return [tuple(_builtins.slice(o[i] * dl[i], o[i] * dl[i] +
                                  (out[i] - 1) * s[i] + 1, s[i])
                  for i in range(len(k))) for o in offsets], out


@_register
def im2col(data, kernel, stride=None, dilate=None, pad=None):
    """Convolution patches (N, C, *spatial) -> (N, C prod(kernel), L):
    channel-major, then the kernel offsets row-major, the output
    positions last (the reference's column order)."""
    k, s, dl, p = _patch_geometry(kernel, stride, dilate, pad)

    def fn(d):
        n, c = d.shape[:2]
        x = F.pad(d, _torch_pads([(q, q) for q in p]))
        sls, _ = _patch_slices(d.shape[2:], k, s, dl, p)
        cols = torch.stack([x[(Ellipsis,) + sl] for sl in sls], 2)
        return cols.reshape(n, c * len(sls), -1)
    return apply(fn, [data])


@_register
def col2im(data, output_size, kernel, stride=None, dilate=None, pad=None):
    """The adjoint of :func:`im2col`: each column added back at its
    patch's place (overlaps sum) into an image of ``output_size``."""
    k, s, dl, p = _patch_geometry(kernel, stride, dilate, pad)
    out_sp = (output_size,) * len(k) if isinstance(output_size, int) \
        else tuple(output_size)

    def fn(cols):
        n = cols.shape[0]
        sls, out = _patch_slices(out_sp, k, s, dl, p)
        c = cols.shape[1] // len(sls)
        parts = cols.reshape((n, c, len(sls)) + tuple(out))
        img = torch.zeros((n, c) + tuple(o + 2 * q for o, q in
                                         zip(out_sp, p)),
                          dtype=cols.dtype, device=cols.device)
        for j, sl in enumerate(sls):
            img[(Ellipsis,) + sl] += parts[:, :, j]
        return img[(Ellipsis,) + tuple(_builtins.slice(q, q + o)
                                       for o, q in zip(out_sp, p))]
    return apply(fn, [data])


# ---- casts (reference: src/operator/tensor/amp_cast.cc) ----

@_register
def amp_cast(data, dtype):
    """The cast ``amp`` inserts."""
    dt = _dtype_of(dtype)
    return apply(lambda t: t.to(dt), [data])


@_register
def amp_multicast(*data, num_outputs=None, cast_narrow=False):
    """Every input cast to the widest (``cast_narrow``: the narrowest)
    floating dtype among them."""
    if num_outputs is not None and num_outputs != len(data):
        raise MXNetError(f"amp_multicast: num_outputs {num_outputs} != "
                         f"{len(data)} inputs")
    bits = [torch.finfo(d._data.dtype).bits for d in data]
    pick_ = _builtins.min if cast_narrow else _builtins.max
    target = data[bits.index(pick_(bits))]._data.dtype
    outs = _apply_n(lambda *ts: tuple(t.to(target) for t in ts),
                    list(data), len(data))
    return outs[0] if len(outs) == 1 else outs


# ---- control flow (reference: src/operator/control_flow.cc) ----

@_register
def foreach(body, data, init_states):
    """``body(x_t, states) -> (out, new_states)`` over the first axis of
    ``data`` (an array or a list), the outputs stacked on a new first
    axis: ``(outs, final_states)``.  As in the reference it runs outside
    the tape: nothing inside records a graph."""
    single = not isinstance(data, (list, tuple))
    datas = [data] if single else list(data)
    states_single = not isinstance(init_states, (list, tuple))
    states = [init_states] if states_single else list(init_states)
    prev = _tape.set_recording(False)
    try:
        steps = []
        for t in range(datas[0].shape[0]):
            xs = [NDArray(d._data[t]) for d in datas]
            out, new = body(xs[0] if single else xs,
                            states[0] if states_single else states)
            steps.append(list(out) if isinstance(out, (list, tuple))
                         else [out])
            states = list(new) if isinstance(new, (list, tuple)) else [new]
        outs = [NDArray(torch.stack([s[i]._data for s in steps]))
                for i in range(len(steps[0]))]
    finally:
        _tape.set_recording(prev)
    return (outs[0] if len(outs) == 1 else outs,
            states[0] if states_single else states)


@_register
def cond(pred, then_func, else_func):
    """``then_func()`` if ``pred`` (read from the device) else
    ``else_func()``."""
    host_sync("cond")
    p = pred.asscalar() if isinstance(pred, NDArray) else pred
    return then_func() if p else else_func()


@_register
def while_loop(cond_fn, func, loop_vars, max_iterations=None):
    """Run ``func(*vars) -> (out, new_vars)`` while ``cond_fn(*vars)``
    (read from the device) holds, at most ``max_iterations`` times:
    ``(stacked outputs, final vars)``."""
    host_sync("while_loop")
    steps, outputs, lv = 0, [], list(loop_vars)
    while cond_fn(*lv) and (max_iterations is None or steps < max_iterations):
        out, lv = func(*lv)
        lv = list(lv) if isinstance(lv, (list, tuple)) else [lv]
        if out is not None:
            outputs.append(out)
        steps += 1
    if outputs and isinstance(outputs[0], (list, tuple)):
        outs = [stack(*[o[i] for o in outputs], axis=0)
                for i in range(len(outputs[0]))]
    elif outputs:
        outs = stack(*outputs, axis=0)
    else:
        outs = []
    return outs, lv


# ===========================================================================
# the fused RNN over a packed parameter vector
# ===========================================================================

@_register
def RNN(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, projection_size=None, sequence_length=None,
        use_sequence_length=False):
    """Multi-layer (bi)directional RNN over the reference's packed 1-D
    parameter vector (``src/operator/rnn.cc``): all weights first, for
    each layer and then direction ``W_i2h`` (G*H, in) and ``W_h2h`` (G*H,
    H), then all biases in the same order (``b_i2h``, ``b_h2h``).  ``data``
    (T, B, I); ``state`` (and ``state_cell`` for ``lstm``) (L*dirs, B, H).
    Returns the output (T, B, H*dirs), and with ``state_outputs`` the
    final states too.  The recurrence is ``gluon.rnn``'s
    (``run_fused_rnn``), so a gluon layer's weights packed into this
    layout give the layer's outputs; dropout ``p`` between layers draws
    from the ``nd.random`` generator of ``data``'s device."""
    from ..gluon.rnn.rnn_layer import _GATES, dropout_masks, run_fused_rnn
    if projection_size is not None or use_sequence_length:
        raise MXNetError("nd.RNN: projection_size/use_sequence_length "
                         "are not supported (reference cuDNN-only paths)")
    gates = _GATES.get(mode)
    if gates is None:
        raise MXNetError(f"nd.RNN: unknown mode {mode!r}")
    if mode == "lstm" and state_cell is None:
        raise MXNetError("nd.RNN: lstm mode requires state_cell")
    dirs = 2 if bidirectional else 1
    T, B, I = data.shape
    H = int(state_size) if state_size else state.shape[-1]
    if state.shape[0] != num_layers * dirs:
        raise MXNetError(
            f"nd.RNN: state has {state.shape[0]} layer slots, need "
            f"num_layers*dirs = {num_layers * dirs}")
    shapes = []
    for layer in range(num_layers):
        in_sz = I if layer == 0 else H * dirs
        shapes += [(gates * H, in_sz), (gates * H, H)] * dirs
    shapes += [(gates * H,)] * (2 * num_layers * dirs)
    expected = _builtins.sum(int(_np.prod(s)) for s in shapes)
    parameters = _nd(parameters, data)
    if parameters.size != expected:
        raise MXNetError(
            f"nd.RNN: packed parameter vector has {parameters.size} values, "
            f"layout needs {expected} (mode={mode}, num_layers="
            f"{num_layers}, bidirectional={bidirectional}, I={I}, H={H})")
    x = data.data
    masks = dropout_masks(p, num_layers, (T, B, H * dirs), x.device,
                          x.dtype, _tape.is_training())

    def fn(x, w, *state_arrs):
        parts, offs = [], 0
        w = w.reshape(-1)
        for s in shapes:
            n = int(_np.prod(s))
            parts.append(w[offs:offs + n].view(s))
            offs += n
        nw = 2 * num_layers * dirs
        weights = list(zip(parts[0:nw:2], parts[1:nw:2]))
        biases = list(zip(parts[nw::2], parts[nw + 1::2]))
        return run_fused_rnn(mode, x, state_arrs, weights, biases,
                             num_layers, dirs, masks)

    inputs = [data, parameters, state] + \
        ([state_cell] if mode == "lstm" else [])
    results = apply(fn, inputs, n_out=len(inputs) - 1)
    return results if state_outputs else results[0]
