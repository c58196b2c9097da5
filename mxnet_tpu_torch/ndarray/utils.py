"""NDArray files: ``nd.save`` / ``nd.load`` / ``nd.load_frombuffer``.

Counterpart of ``mxnet_tpu/ndarray/utils.py``, with the reference's two
formats:

- the native ``MXTPU001`` container (magic, uint64 header length, a JSON
  header of ``{name, shape, dtype, nbytes}`` records, then the raw
  little-endian payloads in order; bfloat16 is stored as float32 under
  its own dtype name), which ``save`` writes.  A sparse record adds its
  ``stype`` and ``segments`` (``{shape, dtype, nbytes}`` each): a
  row_sparse array's values and indices, a csr array's values, indptr
  and indices, its compressed form, as the reference writes it;
- the legacy dmlc container of MXNet's ``NDArray::Save`` (file magic
  0x112, NDARRAY_V2 records with a storage type, or V3 records without),
  which ``load`` reads (``_load_legacy``).

This is the bridge for weights across the packages: a file the JAX
package's ``save_parameters`` wrote loads into the port's
``load_parameters``, and the reverse.  ``load`` returns a sparse record
as a ``RowSparseNDArray`` or ``CSRNDArray`` (``load_numpy``, which
parameter files go through, as its dense numpy array).  A legacy sparse
record raises ``MXNetError``, as in the reference.
"""
from __future__ import annotations

import json
import struct

import numpy as _np
import torch

from ..base import MXNetError
from .ndarray import NDArray, array

__all__ = ["save", "load", "load_frombuffer", "load_numpy"]

_MAGIC = b"MXTPU001"
_LEGACY_FILE_MAGIC = 0x112
_LEGACY_ND_MAGIC = 0xF993FAC9       # NDARRAY_V2
_LEGACY_ND_MAGIC_V3 = 0xF993FAC8
_LEGACY_DTYPES = {0: "float32", 1: "float64", 2: "float16", 3: "uint8",
                  4: "int32", 5: "int8", 6: "int64"}


def _host(arr):
    """(numpy payload, dtype name) of an NDArray, tensor or array."""
    if isinstance(arr, NDArray):
        arr = arr.data
    if torch.is_tensor(arr):
        t = arr.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy(), "bfloat16"
        t = t.cpu().numpy()
        return t, str(t.dtype)
    a = _np.asarray(arr)
    return a, str(a.dtype)


def to_numpy(a):
    """A host numpy copy of ``a``: an NDArray of either package (anything
    with ``asnumpy``), a tensor, or array-like.  Checkpoint states arrive
    in any of these."""
    if hasattr(a, "asnumpy"):
        return _np.array(a.asnumpy())
    if torch.is_tensor(a):
        return a.detach().cpu().numpy().copy()
    return _np.array(a)


def save(fname, data):
    """Save an NDArray, a list of them or a ``str -> NDArray`` dict."""
    if isinstance(data, (NDArray, _np.ndarray)) or torch.is_tensor(data):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = [""] * len(data)
        arrays = list(data)
    metas, payloads = [], []
    for name, arr in zip(names, arrays):
        segs = _sparse_segments(arr)
        if segs is not None:
            stype, parts = segs
            seg_meta, raw = [], b""
            for part in parts:
                p = _np.ascontiguousarray(part)
                seg_meta.append({"shape": list(p.shape),
                                 "dtype": str(p.dtype), "nbytes": p.nbytes})
                raw += p.tobytes()
            metas.append({"name": name, "shape": list(arr.shape),
                          "dtype": str(arr.dtype), "stype": stype,
                          "segments": seg_meta, "nbytes": len(raw)})
            payloads.append(raw)
            continue
        np_arr, dtype = _host(arr)
        np_arr = _np.ascontiguousarray(np_arr)
        metas.append({"name": name, "shape": list(np_arr.shape),
                      "dtype": dtype, "nbytes": np_arr.nbytes})
        payloads.append(np_arr.tobytes())
    header = json.dumps(metas).encode()
    with open(fname, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for p in payloads:
            f.write(p)


def _sparse_segments(arr):
    """``(stype, [numpy parts])`` of a sparse array (through its
    ``values``/``indices`` properties, which recover the compressed form
    after a dense write), None for a dense one."""
    from .sparse import CSRNDArray, RowSparseNDArray
    if isinstance(arr, RowSparseNDArray):
        return "row_sparse", [_host(arr.values)[0], _host(arr.indices)[0]]
    if isinstance(arr, CSRNDArray):
        return "csr", [_host(arr.values)[0], _host(arr.indptr)[0],
                       _host(arr.indices)[0]]
    return None


class _SparseRecord:
    """A sparse record as read: its stype, dense shape and numpy parts."""

    def __init__(self, stype, shape, parts):
        self.stype, self.shape, self.parts = stype, tuple(shape), parts

    def array(self, ctx):
        from .sparse import csr_matrix, row_sparse_array
        if self.stype == "row_sparse":
            return row_sparse_array((self.parts[0], self.parts[1]),
                                    shape=self.shape, ctx=ctx)
        if self.stype == "csr":
            return csr_matrix((self.parts[0], self.parts[2], self.parts[1]),
                              shape=self.shape, ctx=ctx)
        raise MXNetError(f"unknown stype {self.stype!r} in container")

    def dense(self):
        out = _np.zeros(self.shape, self.parts[0].dtype)
        if self.stype == "row_sparse":
            out[self.parts[1].astype(_np.int64)] = self.parts[0]
        else:
            indptr = self.parts[1].astype(_np.int64)
            rows = _np.repeat(_np.arange(self.shape[0]), _np.diff(indptr))
            out[rows, self.parts[2].astype(_np.int64)] = self.parts[0]
        return out


def load(fname, ctx=None):
    """The arrays of a native or legacy file, on ``ctx`` (None: the
    current context): a dict when the file names them, else a list."""
    with open(fname, "rb") as f:
        return load_frombuffer(f.read(), ctx)


def load_frombuffer(blob, ctx=None):
    out = _records(blob)
    items = out.items() if isinstance(out, dict) else enumerate(out)
    arrays = {k: rec.array(ctx) if isinstance(rec, _SparseRecord)
              else array(rec[0], ctx=ctx, dtype=rec[1])
              for k, rec in items}
    return arrays if isinstance(out, dict) else \
        [arrays[i] for i in range(len(out))]


def _records(blob):
    if blob[:8] == _MAGIC:
        return _load_native(blob)
    return _load_legacy(blob)


def load_numpy(blob):
    """A file's records as ``(numpy array, dtype name)`` pairs (a sparse
    record densified), in a dict when the file names them, else a
    list."""
    out = _records(blob)

    def dense(rec):
        if isinstance(rec, _SparseRecord):
            return rec.dense(), str(rec.parts[0].dtype)
        return rec
    if isinstance(out, dict):
        return {k: dense(r) for k, r in out.items()}
    return [dense(r) for r in out]


def _load_native(blob):
    (hlen,) = struct.unpack("<Q", blob[8:16])
    metas = json.loads(blob[16:16 + hlen].decode())
    off = 16 + hlen
    out_list, out_dict, named = [], {}, False
    for m in metas:
        if m.get("stype"):
            parts, seg_off = [], off
            for seg in m["segments"]:
                cnt = int(_np.prod(seg["shape"])) if seg["shape"] else 1
                parts.append(_np.frombuffer(
                    blob, dtype=seg["dtype"], count=cnt,
                    offset=seg_off).reshape(seg["shape"]))
                seg_off += seg["nbytes"]
            rec = _SparseRecord(m["stype"], m["shape"], parts)
        else:
            dtype = "float32" if m["dtype"] == "bfloat16" else m["dtype"]
            count = int(_np.prod(m["shape"])) if m["shape"] else 1
            rec = (_np.frombuffer(blob, dtype=dtype, count=count,
                                  offset=off).reshape(m["shape"]),
                   m["dtype"])
        off += m["nbytes"]
        if m["name"]:
            named = True
            out_dict[m["name"]] = rec
        out_list.append(rec)
    return out_dict if named else out_list


def _load_legacy(blob):
    """The reference dmlc container (src/ndarray/ndarray.cc Save):
    uint64 file magic 0x112, uint64 reserved, uint64 count, then per
    record uint32 magic (+ int32 stype for V2), uint32 ndim, int64 dims,
    uint32 dev_type, uint32 dev_id, uint32 dtype flag, the payload; then
    uint64 name count and length-prefixed names."""
    off = 0

    def u64():
        nonlocal off
        (v,) = struct.unpack_from("<Q", blob, off)
        off += 8
        return v

    def u32():
        nonlocal off
        (v,) = struct.unpack_from("<I", blob, off)
        off += 4
        return v

    if u64() != _LEGACY_FILE_MAGIC:
        raise MXNetError("unrecognized NDArray file format")
    u64()                                      # reserved
    records = []
    for _ in range(u64()):
        magic = u32()
        if magic not in (_LEGACY_ND_MAGIC, _LEGACY_ND_MAGIC_V3):
            raise MXNetError(f"bad ndarray record magic {magic:#x}")
        if magic == _LEGACY_ND_MAGIC:
            stype = struct.unpack_from("<i", blob, off)[0]
            off += 4
            if stype not in (0, -1):           # dense, or undefined
                raise MXNetError("sparse legacy checkpoints not supported "
                                 "yet")
        ndim = u32()
        shape = [struct.unpack_from("<q", blob, off + 8 * i)[0]
                 for i in range(ndim)]
        off += 8 * ndim
        u32()                                  # ctx dev_type
        u32()                                  # ctx dev_id
        dtype = _LEGACY_DTYPES.get(u32())
        if dtype is None:
            raise MXNetError("unknown legacy dtype flag")
        count = int(_np.prod(shape)) if ndim else 1
        np_arr = _np.frombuffer(blob, dtype=dtype, count=count,
                                offset=off).reshape(shape)
        off += count * _np.dtype(dtype).itemsize
        records.append((np_arr, dtype))
    names = []
    for _ in range(u64()):
        ln = u64()
        names.append(blob[off:off + ln].decode())
        off += ln
    return dict(zip(names, records)) if names else records
