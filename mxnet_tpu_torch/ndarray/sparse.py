"""Sparse NDArrays: the ``row_sparse`` and ``csr`` storage types.

Counterpart of ``mxnet_tpu/ndarray/sparse.py``.  Both keep their
compressed form and densify lazily, on the first read of the dense view
(``.data``, ``asnumpy``, any dense op); ``retain``, ``dot(csr, dense)``,
the optimizers' lazy updates and ``nd.save`` work on the compressed form
and never densify.

- :class:`RowSparseNDArray`: ``values`` (rows x trailing dims) at
  ``indices`` (int32 row numbers, the reference's index dtype).  A dense
  write (``r += 1``, ``r[:] = v``) goes to the dense view and marks the
  pair stale; the next ``indices``/``values`` recovers it from the rows
  that are not all zero (a host sync: the count sizes the result).
- :class:`CSRNDArray`: ``values``, ``indices`` (column numbers) and
  ``indptr`` (int32), read-only.
- :func:`sum_duplicate_rows` sums the values of repeated row indices:
  the one merge of row-sparse pairs (a gradient's raw ids are deduplicated
  by it when the gradient is read).
- :func:`dot` of a CSR left operand and a dense right one is a gather of
  the right operand's rows at the stored columns, scaled by the stored
  values, and a segment sum into the output rows (``index_add_``); every
  other form runs the dense ``nd.dot``.

Row-sparse gradients: ``Embedding(sparse_grad=True)`` (the op and the
Gluon layer) gives its weight a gradient of the batch's raw ids and
rows, O(nnz), never O(vocab): a torch sparse COO tensor whose indices
may repeat, which a captured backward carries out of its graph with a
fixed shape.  ``NDArray.grad``/``Parameter.grad()`` sum the duplicates
and return a :class:`RowSparseNDArray`; ``attach_grad(stype=
"row_sparse")`` and ``Parameter(grad_stype="row_sparse")`` give None
before the first backward.  The reference's ``jnp`` ops are plain
PyTorch here; deduplication (``torch.unique``) sizes its output from the
data, so it refuses a CUDA graph capture (``ops.host_sync``).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..context import Context, current_context
from .ndarray import NDArray, _ctx_device, _dtype_of, array
from .ops import host_sync

__all__ = ["RowSparseNDArray", "CSRNDArray", "row_sparse_array", "csr_matrix",
           "zeros", "retain", "dot", "sum_duplicate_rows"]

_INDEX = torch.int32      # the reference's index dtype (no x64)


def _tensor(x, device, dtype=None):
    """``x`` (an NDArray, tensor, or array-like) as a tensor on
    ``device``."""
    if isinstance(x, NDArray):
        x = x.data
    if not torch.is_tensor(x):
        x = torch.from_numpy(_np.ascontiguousarray(_np.asarray(x)))
    if dtype is None and x.dtype in (torch.float64, torch.int64):
        dtype = torch.float32 if x.is_floating_point() else _INDEX
    return x.to(device=device, dtype=dtype)


def sum_duplicate_rows(indices, values):
    """``(unique sorted indices, summed values)`` of a row-sparse pair
    whose indices may repeat (an Embedding gradient's raw batch ids).
    The indices keep their dtype."""
    idx = indices.data if isinstance(indices, NDArray) else indices
    vals = values.data if isinstance(values, NDArray) else values
    host_sync("sum_duplicate_rows")
    uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
    if uniq.numel() == idx.numel() and torch.equal(uniq, idx):
        return idx, vals
    summed = vals.new_zeros((uniq.numel(),) + tuple(vals.shape[1:]))
    summed.index_add_(0, inv.reshape(-1), vals)
    return uniq.to(idx.dtype), summed


def _rows_of(grad):
    """``(int32 rows, values)`` of a row-sparse gradient (a
    :class:`RowSparseNDArray` or a torch sparse COO tensor, duplicates
    summed), or None for a dense one."""
    if isinstance(grad, RowSparseNDArray):
        grad._refresh_sparse()
        return grad._indices, grad._values
    if torch.is_tensor(grad) and grad.is_sparse:
        return _coalesced(grad)
    return None


def _coalesced(grad):
    """``(int32 rows, values)`` of the torch sparse COO gradient
    ``grad`` with its duplicate rows summed."""
    if grad.is_coalesced():
        return grad._indices()[0].to(_INDEX), grad._values()
    return sum_duplicate_rows(grad._indices()[0].to(_INDEX),
                              grad._values())


def _from_coo(grad):
    """A :class:`RowSparseNDArray` of the torch sparse COO gradient
    ``grad`` (duplicates summed)."""
    rows, vals = _coalesced(grad)
    return RowSparseNDArray(vals, rows, tuple(grad.shape))


class BaseSparseNDArray(NDArray):
    __slots__ = ()

    @property
    def context(self):
        return Context.from_device(self._device)

    ctx = context

    @property
    def shape(self):
        return self._dense_shape

    @property
    def ndim(self):
        return len(self._dense_shape)

    @property
    def size(self):
        return int(_np.prod(self._dense_shape))

    def wait_to_read(self):
        if self._device.type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()
        return self


class RowSparseNDArray(BaseSparseNDArray):
    """``values`` (rows x trailing dims) at ``indices`` (int32 rows) of a
    dense shape; no dense array exists until a dense op asks for one."""

    __slots__ = ("_indices", "_values", "_dense_shape", "_dense_cache",
                 "_sparse_stale", "_device")

    def __init__(self, values, indices, shape, ctx=None):
        dev = values.device if ctx is None else _ctx_device(ctx)
        self._values = values.to(dev)
        self._indices = indices.to(dev, _INDEX)
        self._dense_shape = tuple(int(s) for s in shape)
        self._dense_cache = None
        self._sparse_stale = False
        self._device = dev
        self._grad_req = "null"
        self._grad_hook = None
        self._grad_stype = None

    def __reduce__(self):
        """Pickle the compressed pair (a base NDArray would come back
        dense)."""
        self._refresh_sparse()
        return (_row_sparse_from_host,
                (self._values.detach().cpu().numpy(),
                 self._indices.cpu().numpy(), self._dense_shape))

    # -- the lazy dense view ------------------------------------------------
    @property
    def _data(self):
        if self._dense_cache is None:
            dense = self._values.new_zeros(self._dense_shape)
            dense[self._indices.long()] = self._values
            self._dense_cache = dense
        return self._dense_cache

    @_data.setter
    def _data(self, value):
        # a dense write: the pair is recovered at its next read
        self._dense_cache = value
        self._sparse_stale = True

    def _write(self, value):
        dense = self._data
        with torch.no_grad():
            if value.shape == dense.shape and value.dtype == dense.dtype:
                dense.copy_(value)
            else:
                self._dense_cache = value.detach()
        self._sparse_stale = True
        return self

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self._sparse_stale = True

    def _refresh_sparse(self):
        if self._sparse_stale:
            host_sync("RowSparseNDArray.indices after a dense write")
            d = self._dense_cache
            mask = (d != 0).reshape(d.shape[0], -1).any(dim=1)
            rows = torch.nonzero(mask).reshape(-1)
            self._indices = rows.to(_INDEX)
            self._values = d.index_select(0, rows)
            self._sparse_stale = False

    @property
    def dtype(self):
        t = self._dense_cache if self._sparse_stale else self._values
        return NDArray(t[:0]).dtype

    @property
    def stype(self):
        return "row_sparse"

    @property
    def indices(self):
        self._refresh_sparse()
        return NDArray(self._indices)

    @property
    def values(self):
        self._refresh_sparse()
        return NDArray(self._values)

    data_nd = values

    def tostype(self, stype):
        if stype == "default":
            return NDArray(self._data)
        if stype == "row_sparse":
            return self
        raise MXNetError(f"cannot convert row_sparse to {stype}")

    def retain(self, indices):
        return retain(self, indices)

    def copyto(self, other):
        if isinstance(other, RowSparseNDArray):
            self._refresh_sparse()
            other._indices = self._indices.to(other._device)
            other._values = self._values.to(other._device)
            other._dense_shape = self._dense_shape
            other._dense_cache = None
            other._sparse_stale = False
            return other
        return super().copyto(other)

    def __repr__(self):
        self._refresh_sparse()
        return (f"\n<RowSparseNDArray {self._dense_shape} "
                f"({self._indices.numel()} rows stored) @{self.context}>")


class CSRNDArray(BaseSparseNDArray):
    """``values`` at (row, ``indices``) of a 2D shape, the rows delimited
    by ``indptr`` (int32); read-only."""

    __slots__ = ("_indptr", "_indices_csr", "_values_csr", "_dense_shape",
                 "_dense_cache", "_device")

    def __init__(self, data_vals, indptr, indices, shape, ctx=None):
        dev = _ctx_device(ctx) if ctx is not None else (
            data_vals.device if torch.is_tensor(data_vals)
            else _ctx_device(None))
        self._values_csr = _tensor(data_vals, dev)
        self._indptr = _tensor(indptr, dev, _INDEX)
        self._indices_csr = _tensor(indices, dev, _INDEX)
        self._dense_shape = tuple(int(s) for s in shape)
        self._dense_cache = None
        self._device = dev
        self._grad_req = "null"
        self._grad_hook = None
        self._grad_stype = None

    def __reduce__(self):
        """Pickle the compressed triple, not the dense view."""
        return (_csr_from_host,
                (self._values_csr.detach().cpu().numpy(),
                 self._indptr.cpu().numpy(),
                 self._indices_csr.cpu().numpy(), self._dense_shape))

    def _rows(self):
        """The row of each stored value (int64, on the device), with no
        host read: the count of values is known on the host."""
        counts = (self._indptr[1:] - self._indptr[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(self._dense_shape[0], device=self._device), counts,
            output_size=self._values_csr.numel())

    @property
    def _data(self):
        if self._dense_cache is None:
            dense = self._values_csr.new_zeros(self._dense_shape)
            dense[self._rows(), self._indices_csr.long()] = self._values_csr
            self._dense_cache = dense
        return self._dense_cache

    @_data.setter
    def _data(self, value):
        raise MXNetError("CSRNDArray is read-only; convert with "
                         "tostype('default') first")

    def _write(self, value):
        raise MXNetError("CSRNDArray is read-only; convert with "
                         "tostype('default') first")

    def __setitem__(self, key, value):
        self._write(value)

    @property
    def dtype(self):
        return NDArray(self._values_csr[:0]).dtype

    @property
    def stype(self):
        return "csr"

    @property
    def indptr(self):
        return NDArray(self._indptr)

    @property
    def indices(self):
        return NDArray(self._indices_csr)

    @property
    def values(self):
        return NDArray(self._values_csr)

    data_nd = values

    def tostype(self, stype):
        if stype == "default":
            return NDArray(self._data)
        if stype == "csr":
            return self
        raise MXNetError(f"cannot convert csr to {stype}")

    def __repr__(self):
        return (f"\n<CSRNDArray {self._dense_shape} "
                f"({self._values_csr.numel()} stored) @{self.context}>")


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A :class:`RowSparseNDArray` from ``(values, indices)`` and
    ``shape``, or from a dense array (its rows that are not all zero)."""
    dev = _ctx_device(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 2:
        values, indices = arg1
        dt = None if dtype is None else _dtype_of(dtype)
        return RowSparseNDArray(_tensor(values, dev, dt),
                                _tensor(indices, dev, _INDEX), shape)
    dense = array(arg1, ctx=ctx, dtype=dtype)
    np_d = dense.asnumpy()
    nz = _np.where(_np.any(np_d != 0, axis=tuple(range(1, np_d.ndim))))[0]
    return RowSparseNDArray(dense.data[torch.from_numpy(nz).to(dev)],
                            torch.from_numpy(nz.astype(_np.int32)),
                            np_d.shape, dense.context)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A :class:`CSRNDArray` from ``(values, indices, indptr)`` and
    ``shape``, or from a dense 2D array."""
    dev = _ctx_device(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data_vals, indices, indptr = arg1
        dt = None if dtype is None else _dtype_of(dtype)
        return CSRNDArray(_tensor(data_vals, dev, dt), indptr, indices,
                          shape, dev)
    dense = _np.asarray(array(arg1, ctx=ctx, dtype=dtype).asnumpy())
    nz_r, nz_c = _np.nonzero(dense)
    indptr = _np.zeros(dense.shape[0] + 1, _np.int64)
    _np.add.at(indptr, nz_r + 1, 1)
    return CSRNDArray(torch.from_numpy(dense[nz_r, nz_c].copy()),
                      _np.cumsum(indptr), nz_c, dense.shape, dev)


def cast_storage(data, stype):
    """``data`` in storage ``stype`` (``"default"``, ``"row_sparse"``,
    ``"csr"``): the reference's ``tostype`` over ``cast_storage``; a dense
    array to ``"default"`` is a new copy."""
    if isinstance(data, BaseSparseNDArray):
        return data.tostype(stype)
    if stype == "default":
        return data.copy()
    if stype == "row_sparse":
        return row_sparse_array(data, ctx=data.context)
    if stype == "csr":
        return csr_matrix(data, ctx=data.context)
    raise MXNetError(f"unknown storage type {stype!r}")


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage ``stype`` (nothing stored)."""
    dev = _ctx_device(ctx)
    dt = _dtype_of(dtype)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + tuple(shape[1:]), dtype=dt, device=dev),
            torch.zeros(0, dtype=_INDEX, device=dev), shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros(0, dtype=dt, device=dev),
                          torch.zeros(shape[0] + 1, dtype=_INDEX),
                          torch.zeros(0, dtype=_INDEX), shape, dev)
    from .ndarray import zeros as dense_zeros
    return dense_zeros(shape, ctx, dtype)


def retain(data, indices):
    """The rows of ``data`` (a :class:`RowSparseNDArray`) at ``indices``,
    from the compressed pair (never densified).  Reference
    ``sparse_retain``."""
    if not isinstance(data, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    data._refresh_sparse()
    req = _tensor(indices, data._device).to(data._indices.dtype)
    keep = torch.isin(data._indices, req)
    return RowSparseNDArray(data._values[keep], data._indices[keep],
                            data._dense_shape)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``lhs . rhs``.  A CSR ``lhs`` (not transposed) against a dense
    ``rhs`` runs as a gather of ``rhs``'s rows at the stored columns and a
    segment sum into the output rows, O(nnz); every other form the dense
    ``nd.dot``."""
    if isinstance(lhs, CSRNDArray) and not transpose_a and \
            isinstance(rhs, NDArray) and \
            not isinstance(rhs, BaseSparseNDArray):
        b = rhs.data.t() if transpose_b else rhs.data
        nrows = lhs._dense_shape[0]
        out = b.new_zeros((nrows, b.shape[1]))
        if lhs._values_csr.numel():
            contrib = lhs._values_csr[:, None] * \
                b.index_select(0, lhs._indices_csr)
            out.index_add_(0, lhs._rows(), contrib)
        return NDArray(out)
    from . import ops as _ops
    return _ops.dot(lhs, rhs, transpose_a=transpose_a,
                    transpose_b=transpose_b)


def _row_sparse_from_host(values, indices, shape):
    """Unpickle target: the pair on the current context's device."""
    dev = _ctx_device(current_context())
    return RowSparseNDArray(torch.from_numpy(_np.array(values)).to(dev),
                            torch.from_numpy(_np.array(indices)), shape)


def _csr_from_host(values, indptr, indices, shape):
    dev = _ctx_device(current_context())
    return CSRNDArray(torch.from_numpy(_np.array(values)).to(dev), indptr,
                      indices, shape, dev)
