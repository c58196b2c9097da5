"""NDArray: the imperative tensor, over ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  An ``NDArray`` holds one
``torch.Tensor`` (``.data``) on an explicit device; its context is the
tensor's device (``mx.gpu(i)`` or ``mx.cpu()``).  Every op runs through
:func:`apply`, the counterpart of the reference's ``apply_nary``: torch's
grad mode set to MXNet's recording flag (``_tape.run``), so a graph is
built only inside ``autograd.record()``.

MXNet's quirks kept on purpose, as the reference keeps them:

- the default dtype is float32; int64 and float64 narrow to int32 and
  float32 (the reference's 32-bit policy without its x64 switch);
- comparisons return 0/1 arrays in float32 (in the operand's dtype for
  ``==`` on floats); ``%`` is C ``fmod``;
- in-place ops (``+=``, ``x[:] = v``) write into the array's own storage
  (so a parameter's array keeps aliasing the Trainer's flat buffer); on
  an array produced inside an active ``record()`` they raise;
- ``reshape`` takes the codes 0, -1, -2, -3 and -4 (``_resolve_reshape``);
- ``flatten`` keeps the first axis.

``asnumpy`` of a bfloat16 array returns float32 values (numpy has no
bfloat16); ``dtype`` is a numpy dtype, or the string ``"bfloat16"``.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..context import Context, current_context
from .. import _tape

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concat", "concatenate", "stack", "from_torch", "waitall", "eye",
           "linspace", "apply"]

_NAMED = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16, "float64": torch.float32,
          "int32": torch.int32, "int64": torch.int32, "int8": torch.int8,
          "uint8": torch.uint8, "int16": torch.int16, "bool": torch.bool,
          "uint32": torch.int32, "uint64": torch.int32}
_NUMPY = {torch.float32: _np.float32, torch.float16: _np.float16,
          torch.int32: _np.int32, torch.int8: _np.int8,
          torch.uint8: _np.uint8, torch.int16: _np.int16,
          torch.bool: _np.bool_, torch.int64: _np.int64,
          torch.float64: _np.float64}
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32}


def _dtype_of(dtype):
    """The torch dtype of an MXNet dtype spec (None: float32), with
    64-bit types narrowed to 32 bits."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return _NARROW.get(dtype, dtype)
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    if name not in _NAMED:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return _NAMED[name]


def _ctx_device(ctx):
    """The torch device of ``ctx`` (None: the current context)."""
    if ctx is None:
        ctx = current_context()
    elif not isinstance(ctx, Context):
        ctx = Context.from_device(ctx)
    return ctx.torch_device


class NDArray:
    """An n-dimensional array on a device context, over ``torch.Tensor``.

    ``attach_grad(grad_req)`` makes it a variable: ``"write"`` keeps the
    last backward's gradient, ``"add"`` sums them, ``"null"`` takes none.
    ``grad`` reads it (zeros before the first backward)."""

    __slots__ = ("_data", "_grad_req", "_grad_hook", "_grad_stype",
                 "__weakref__")
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None):
        if not torch.is_tensor(data):
            raise MXNetError(f"NDArray wraps a torch.Tensor, got "
                             f"{type(data)}")
        if ctx is not None:
            dev = _ctx_device(ctx)
            if data.device != dev:
                data = data.to(dev)
        self._data = data
        self._grad_req = "null"
        self._grad_hook = None
        self._grad_stype = None

    # -- properties ---------------------------------------------------------
    @property
    def data(self):
        """The underlying ``torch.Tensor`` (no copy)."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        dt = self._data.dtype
        return "bfloat16" if dt == torch.bfloat16 else _np.dtype(_NUMPY[dt])

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def context(self):
        return Context.from_device(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    # -- autograd -----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Mark this array a variable (reference ``NDArray.attach_grad``):
        it leaves any graph it came from, and a backward writes
        (``"write"``) or adds (``"add"``) its gradient."""
        from ..autograd import _mark
        _mark(self, grad_req, stype)

    @property
    def grad(self):
        """The gradient: zeros before the first backward (None for a
        ``"row_sparse"`` variable); a :class:`~.sparse.RowSparseNDArray`
        (duplicate rows summed) when a row-sparse op wrote it, except
        that ``grad_req="add"`` on a default variable sums densely, as
        the reference's dense buffer does."""
        if self._grad_req == "null":
            return None
        g = self._data.grad
        if g is None:
            return None if self._grad_stype == "row_sparse" else \
                NDArray(torch.zeros_like(self._data))
        if g.is_sparse:
            from .sparse import _from_coo
            if self._grad_req == "add" and self._grad_stype != "row_sparse":
                return NDArray(g.to_dense())
            rsp = _from_coo(g)
            # keep the summed pair, so later reads reuse it
            self._data.grad = torch.sparse_coo_tensor(
                rsp._indices.long()[None], rsp._values, g.shape,
                is_coalesced=True, check_invariants=False)
            return rsp
        return NDArray(g)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from ..autograd import backward
        backward([self], None if out_grad is None else [out_grad],
                 retain_graph=retain_graph, train_mode=train_mode)

    def detach(self):
        return NDArray(self._data.detach())

    def _check_mutable(self):
        if _tape.is_recording() and self._data.grad_fn is not None:
            raise MXNetError(
                "in-place mutation of an NDArray produced inside an active "
                "autograd.record() scope is not supported; use out-of-place "
                "ops or detach() first")

    def _write(self, value):
        """Write ``value`` (a tensor) into this array in place: into its
        own storage when dtype and shape allow, else rebind."""
        self._check_mutable()
        with torch.no_grad():
            if value.dtype == self._data.dtype and \
                    value.shape == self._data.shape:
                self._data.copy_(value)
            else:
                self._data = value.detach()
        return self

    # -- conversion ---------------------------------------------------------
    def asnumpy(self):
        """A host copy: it never shares the array's storage, so a later
        in-place write (a running statistic, ``x[:] = v``) leaves it as
        it was, as the reference's copy does."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy()
        return t.to("cpu", copy=True).numpy()

    def asscalar(self):
        if _tape.capturing():
            raise MXNetError("asscalar reads the device from the host and "
                             "cannot run inside a CUDA graph capture")
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    item = asscalar

    def tolist(self):
        return self.asnumpy().tolist()

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    def astype(self, dtype, copy=True):
        dt = _dtype_of(dtype)
        if dt == self._data.dtype and not copy:
            return self
        return apply(lambda t: t.to(dt), [self])

    def as_in_context(self, ctx):
        ctx = Context.from_device(ctx) if not isinstance(ctx, Context) \
            else ctx
        if ctx == self.context:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._write(self._data.detach().to(other._data.device))
            return other
        dev = _ctx_device(other)
        return apply(lambda t: t.to(dev, copy=True), [self])

    def copy(self):
        return apply(lambda t: t.clone(), [self])

    # -- shape --------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        new_shape = _resolve_reshape(self.shape, shape)
        return apply(lambda t: t.reshape(new_shape), [self])

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def expand_dims(self, axis):
        return apply(lambda t: t.unsqueeze(axis), [self])

    def squeeze(self, axis=None):
        if axis is None:
            return apply(lambda t: t.squeeze(), [self])
        return apply(lambda t: t.squeeze(axis), [self])

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        if not axes:
            axes = tuple(range(self.ndim))[::-1]
        return apply(lambda t: t.permute(*axes), [self])

    @property
    def T(self):
        return self.transpose()

    def flatten(self):
        """MXNet Flatten: collapse all but the first axis."""
        lead = self.shape[0] if self.ndim else 1
        return apply(lambda t: t.reshape(lead, -1), [self])

    def swapaxes(self, a1, a2):
        return apply(lambda t: t.transpose(a1, a2), [self])

    def broadcast_to(self, shape):
        shape = tuple(shape)
        cur = self.shape
        if len(cur) < len(shape):
            cur = (1,) * (len(shape) - len(cur)) + cur
        for c, s in zip(cur, shape):
            if c != s and c != 1:
                raise MXNetError(f"cannot broadcast {self.shape} to {shape}")
        return apply(lambda t: t.reshape(cur).expand(shape), [self])

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        from . import ops
        return ops.split(self, num_outputs=num_outputs, axis=axis,
                         squeeze_axis=squeeze_axis)

    # -- reductions and elementwise (the full set is in ops.py) -------------
    def _op(self, name, *args, **kwargs):
        from . import ops
        return getattr(ops, name)(self, *args, **kwargs)

    def sum(self, axis=None, keepdims=False):
        return self._op("sum", axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._op("mean", axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return self._op("max", axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self._op("min", axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._op("prod", axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._op("argmax", axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._op("argmin", axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._op("norm", ord=ord, axis=axis, keepdims=keepdims)

    def abs(self):
        return self._op("abs")

    def sqrt(self):
        return self._op("sqrt")

    def exp(self):
        return self._op("exp")

    def log(self):
        return self._op("log")

    def relu(self):
        return self._op("relu")

    def sigmoid(self):
        return self._op("sigmoid")

    def tanh(self):
        return self._op("tanh")

    def square(self):
        return self._op("square")

    def clip(self, a_min=None, a_max=None):
        return self._op("clip", a_min, a_max)

    def softmax(self, axis=-1):
        return self._op("softmax", axis=axis)

    def log_softmax(self, axis=-1):
        return self._op("log_softmax", axis=axis)

    def dot(self, other):
        return self._op("dot", other)

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return self._op("one_hot", depth, on_value, off_value, dtype)

    def take(self, indices, axis=0, mode="clip"):
        return self._op("take", indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False):
        return self._op("pick", index, axis=axis, keepdims=keepdims)

    def slice_axis(self, axis, begin, end):
        return self._op("slice_axis", axis=axis, begin=begin, end=end)

    def zeros_like(self):
        return self._op("zeros_like")

    def ones_like(self):
        return self._op("ones_like")

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, key):
        key = _convert_index(key)
        return apply(lambda t: t[key], [self])

    def __setitem__(self, key, value):
        self._check_mutable()
        key = _convert_index(key)
        if isinstance(value, NDArray):
            value = value._data
        elif not torch.is_tensor(value):
            value = torch.as_tensor(_np.asarray(value),
                                    dtype=self._data.dtype)
        with torch.no_grad():
            self._data[key] = value.to(self._data.device, self._data.dtype)

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other):
        return _binary(self, other, torch.add)

    __radd__ = __add__

    def __sub__(self, other):
        return _binary(self, other, torch.sub)

    def __rsub__(self, other):
        return _binary(self, other, lambda a, b: b - a)

    def __mul__(self, other):
        return _binary(self, other, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _binary(self, other, torch.true_divide)

    def __rtruediv__(self, other):
        return _binary(self, other, lambda a, b: b / a)

    def __mod__(self, other):
        # the reference's mod is C fmod (the sign of the dividend)
        return _binary(self, other, torch.fmod)

    def __rmod__(self, other):
        return _binary(self, other, lambda a, b: torch.fmod(
            torch.as_tensor(b, dtype=a.dtype, device=a.device), a))

    def __pow__(self, other):
        return _binary(self, other, torch.pow)

    def __rpow__(self, other):
        return _binary(self, other, lambda a, b: torch.pow(b, a))

    def __neg__(self):
        return apply(torch.neg, [self])

    def __abs__(self):
        return apply(torch.abs, [self])

    def __matmul__(self, other):
        return _binary(self, other, torch.matmul)

    def _inplace(self, other, fn):
        with torch.no_grad():
            return self._write(fn(self._data, _raw(other, self)))

    def __iadd__(self, other):
        return self._inplace(other, torch.add)

    def __isub__(self, other):
        return self._inplace(other, torch.sub)

    def __imul__(self, other):
        return self._inplace(other, torch.mul)

    def __itruediv__(self, other):
        return self._inplace(other, torch.true_divide)

    # comparisons: 0/1 arrays (mx.nd semantics)
    def __eq__(self, other):
        return _binary(self, other, lambda a, b: (a == b).to(
            a.dtype if a.is_floating_point() else torch.float32))

    def __ne__(self, other):
        return _binary(self, other, lambda a, b: (a != b).float())

    def __gt__(self, other):
        return _binary(self, other, lambda a, b: (a > b).float())

    def __ge__(self, other):
        return _binary(self, other, lambda a, b: (a >= b).float())

    def __lt__(self, other):
        return _binary(self, other, lambda a, b: (a < b).float())

    def __le__(self, other):
        return _binary(self, other, lambda a, b: (a <= b).float())

    def __hash__(self):
        return id(self)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("The truth value of an NDArray with multiple "
                         "elements is ambiguous")

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def apply(fn, inputs, n_out=1):
    """``fn`` over the tensors of the NDArrays ``inputs``, under the
    tape's recording flag (the reference's ``apply_nary``).  Returns one
    NDArray, or a list of ``n_out``."""
    tensors = [x._data for x in inputs]
    outs = _tape.run(fn, tensors, tensors[0].device.type)
    if n_out == 1:
        return NDArray(outs)
    return [NDArray(o) for o in outs]


def _raw(other, like):
    """``other`` as something torch combines with ``like``'s tensor."""
    if isinstance(other, NDArray):
        return other._data
    if isinstance(other, (int, float, bool)):
        return other
    return torch.as_tensor(_np.asarray(other), dtype=like._data.dtype,
                           device=like._data.device)


def _binary(lhs, rhs, fn):
    if isinstance(rhs, NDArray):
        return apply(fn, [lhs, rhs])
    other = _raw(rhs, lhs)
    return apply(lambda a: fn(a, other), [lhs])


def _resolve_reshape(cur, shape):
    """MXNet reshape codes (``src/operator/tensor/matrix_op-inl.h``
    ``InferReshapeShape``): 0 copies the input dim, -1 infers one dim,
    -2 copies all remaining input dims, -3 merges two input dims, -4
    splits one input dim into the next two entries (one may be -1)."""
    shape = tuple(int(s) for s in shape)
    out = []
    src = 0
    i = 0
    while i < len(shape):
        s = shape[i]
        if s > 0:
            out.append(s)
            src += 1
        elif s == 0:
            if src >= len(cur):
                raise MXNetError(f"reshape code 0 at dim {i} out of range "
                                 f"for shape {cur}")
            out.append(cur[src])
            src += 1
        elif s == -1:
            if -1 in out:
                raise MXNetError("reshape allows at most one -1 "
                                 f"(outside -4 splits): {shape}")
            out.append(-1)
            src += 1
        elif s == -2:
            out.extend(cur[src:])
            src = len(cur)
        elif s == -3:
            if src + 1 >= len(cur):
                raise MXNetError(f"reshape code -3 at dim {i} needs two "
                                 f"input dims, shape {cur} has "
                                 f"{len(cur) - src} left")
            out.append(cur[src] * cur[src + 1])
            src += 2
        elif s == -4:
            if i + 2 >= len(shape):
                raise MXNetError("reshape code -4 must be followed by two "
                                 f"split dims: {shape}")
            if src >= len(cur):
                raise MXNetError(f"reshape code -4 at dim {i} out of range "
                                 f"for shape {cur}")
            d = cur[src]
            d1, d2 = shape[i + 1], shape[i + 2]
            d1 = d if d1 == 0 else d1
            d2 = d if d2 == 0 else d2
            if d1 == -1 and d2 == -1:
                raise MXNetError("reshape -4 split cannot infer both dims")
            if d1 == -1:
                d1 = d // d2
            if d2 == -1:
                d2 = d // d1
            if d1 * d2 != d:
                raise MXNetError(f"reshape -4 split {d1}x{d2} != input "
                                 f"dim {d}")
            out.extend([d1, d2])
            src += 1
            i += 2
        else:
            raise MXNetError(f"invalid reshape code {s}")
        i += 1
    total = 1
    for c in cur:
        total *= c
    if -1 in out:
        known = 1
        for o in out:
            if o != -1:
                known *= o
        if known == 0 or total % known:
            raise MXNetError(f"cannot infer -1 in reshape {shape} of {cur}")
        out[out.index(-1)] = total // known
    size = 1
    for o in out:
        size *= o
    if size != total:
        raise MXNetError(f"reshape {shape} of {cur}: target size {size} "
                         f"!= input size {total}")
    return tuple(out)


def _convert_index(key):
    if isinstance(key, NDArray):
        t = key._data
        return t if t.dtype == torch.bool else t.long()
    if isinstance(key, tuple):
        return tuple(_convert_index(k) for k in key)
    return key


# ---------------------------------------------------------------------------
# creation (reference: python/mxnet/ndarray/ndarray.py)
# ---------------------------------------------------------------------------

def _shape(shape):
    return (int(shape),) if isinstance(shape, (int, _np.integer)) \
        else tuple(int(s) for s in shape)


def array(source_array, ctx=None, dtype=None):
    """An NDArray copy of ``source_array`` (numpy, list, NDArray or
    tensor) on ``ctx`` (None: the current context).  Numpy sources keep
    their dtype but float64; lists default to float32."""
    dev = _ctx_device(ctx)
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if torch.is_tensor(source_array):
        dt = _dtype_of(source_array.dtype if dtype is None else dtype)
        return NDArray(source_array.detach().to(dev, dt, copy=True))
    np_arr = _np.asarray(source_array)
    if dtype is None:
        dtype = np_arr.dtype if isinstance(source_array, _np.ndarray) and \
            np_arr.dtype != _np.float64 else "float32"
    dt = _dtype_of(dtype)
    if dt == torch.bfloat16:
        t = torch.from_numpy(_np.ascontiguousarray(np_arr, _np.float32))
    else:
        host = {torch.int32: _np.int32, torch.float32: _np.float32}.get(dt)
        t = torch.from_numpy(_np.array(np_arr, dtype=host, copy=True)
                             if host is not None else
                             _np.array(np_arr, copy=True))
    return NDArray(t.to(dev, dt))


def from_torch(tensor, ctx=None):
    """An NDArray over ``tensor`` itself (no copy), or over its copy on
    ``ctx`` when that is another device: the bridge to and from plain
    torch code (the reference's ``from_jax``)."""
    return NDArray(tensor, ctx)


def zeros(shape, ctx=None, dtype=None):
    return NDArray(torch.zeros(_shape(shape), dtype=_dtype_of(dtype),
                               device=_ctx_device(ctx)))


def ones(shape, ctx=None, dtype=None):
    return NDArray(torch.ones(_shape(shape), dtype=_dtype_of(dtype),
                              device=_ctx_device(ctx)))


def full(shape, val, ctx=None, dtype=None):
    return NDArray(torch.full(_shape(shape), val, dtype=_dtype_of(dtype),
                              device=_ctx_device(ctx)))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, dtype=_dtype_of(dtype),
                     device=_ctx_device(ctx))
    if repeat > 1:
        t = torch.repeat_interleave(t, repeat)
    return NDArray(t)


def eye(N, M=0, k=0, ctx=None, dtype=None):
    t = torch.from_numpy(_np.eye(N, M if M else N, k, dtype=_np.float32))
    return NDArray(t.to(_ctx_device(ctx), _dtype_of(dtype)))


def linspace(start, stop, num, endpoint=True, ctx=None, dtype=None):
    """``num`` points from ``start`` to ``stop``, computed in float32 as
    ``start * (1 - s) + stop * s`` with ``s = i / div`` (the
    reference's ``jnp.linspace``), ``stop`` itself last when
    ``endpoint``."""
    div = num - 1 if endpoint else num
    dev = _ctx_device(ctx)
    if div > 0:
        s = torch.arange(div, dtype=torch.float32, device=dev) * \
            torch.tensor(1.0 / div, dtype=torch.float32, device=dev)
        t = torch.tensor(float(start), device=dev) * (1 - s) + \
            torch.tensor(float(stop), device=dev) * s
        if endpoint:
            t = torch.cat([t, torch.tensor([float(stop)], device=dev)])
    else:
        t = torch.full((num,), float(start), device=dev)
    return NDArray(t.to(_dtype_of(dtype)))


def concat(*arrays, dim=1):
    from . import ops
    return ops.concat(*arrays, dim=dim)


def concatenate(arrays, axis=0):
    from . import ops
    return ops.concat(*arrays, dim=axis)


def stack(*arrays, axis=0):
    from . import ops
    return ops.stack(*arrays, axis=axis)


def waitall():
    """Wait for all work on the cards (the reference's engine
    ``WaitForAll``)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
