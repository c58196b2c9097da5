"""``mx.kv``: the KVStore, gradient communication between ranks.

Counterpart of ``mxnet_tpu/kvstore/kvstore.py``.  The reference reduces
per-device copies inside one process and crosses processes through
JAX's multi-host collectives; the port runs one process per device, so
its stores reduce across the ranks of a ``torch.distributed`` process
group (``parallel.distributed_init``), NCCL between cards and gloo
between CPU processes.  Types, as ``create`` maps them:

- ``local`` / ``device``: :class:`KVStoreLocal`, one process: a push of
  a list of copies sums them (``_local_reduce``), a pull writes the
  stored value into every output.
- ``nccl`` / ``tpu_sync``: :class:`KVStoreTPUSync`: a push sums over the
  ranks of the dp group as well (the current mesh's, else the world's),
  one ``all_reduce`` a key on the device with no host synchronization,
  so it may run inside a captured step; ``pushpull_scatter`` returns
  this rank's 1/N shard of the sum (``reduce_scatter_tensor``).  The
  reference's counterpart is an in-graph ``psum`` over the mesh axis.
- ``dist_sync`` / ``dist_device_sync`` / ``dist_tpu_sync``:
  :class:`KVStoreDistTPUSync`, with ``rank``, ``num_workers`` and
  ``barrier``: ``init`` keeps rank 0's value (a broadcast), and a push
  coalesces the dense keys into buckets of at most ``bigarray_bound``
  bytes, one ``all_reduce`` a bucket (``wire="allgather"``: one
  ``all_gather`` a bucket, summed here); row-sparse values cross as
  their rows (``_allgather_sparse``), never dense; with gradient
  compression the packed codes cross by ``all_gather`` and each rank
  sums the decompressed values.
- ``horovod`` / ``byteps``: the reference's facades over the dist store.
- ``dist_async``: refused (the parameter server, ROADMAP §1 item 10b).

The reference's ``MXTPU_KVSTORE_BIGARRAY_BOUND`` and
``MXTPU_KVSTORE_WIRE`` are the arguments ``bigarray_bound`` and ``wire``
of ``create`` and of the dist store (ROADMAP §3: no environment knobs).
Values are NDArrays (or lists of them, a device's copies); pushes and
pulls write the outputs in place.
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.distributed as dist

from .. import _dist_init
from .. import optimizer as opt
from ..base import MXNetError, NotSupportedError
from ..ndarray.ndarray import NDArray
from ..ndarray.sparse import RowSparseNDArray, sum_duplicate_rows
from ..ops.quant_matmul import quantize_rtn_int8

__all__ = ["KVStore", "KVStoreLocal", "KVStoreTPUSync", "KVStoreDistTPUSync",
           "GradientCompression", "Int8GradientCompression", "create",
           "DEFAULT_BIGARRAY_BOUND"]

#: the reference's default bucket bound for the dist wire (25 MiB)
DEFAULT_BIGARRAY_BOUND = 25 * 1024 * 1024


def _listify(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _write(dst, value):
    """Write ``value`` (an NDArray, row-sparse or dense) into ``dst``."""
    if isinstance(value, RowSparseNDArray) and \
            isinstance(dst, RowSparseNDArray):
        value.copyto(dst)               # stays O(nnz)
        return
    dst._write(value.data.to(dst.data.device))


class KVStore:
    """The store's interface (reference ``KVStore``)."""

    def __init__(self):
        self._updater = None
        self._optimizer = None
        self._compression = None

    @property
    def type(self):
        raise NotImplementedError

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        raise NotImplementedError

    def push(self, key, value, priority=0):
        raise NotImplementedError

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        self.pull(key, out=out if out is not None else value,
                  priority=priority)
        return out

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError(f"row_sparse_pull not supported by {self.type}")

    def send_command_to_servers(self, head, body):
        """No servers to talk to (the reference's serverless stores)."""

    @staticmethod
    def _local_reduce(vs):
        """The sum of one key's copies: row-sparse copies stay row-sparse
        (rows concatenated, duplicates summed), anything else sums
        densely."""
        if all(isinstance(v, RowSparseNDArray) for v in vs):
            idx = torch.cat([v.indices.data for v in vs])
            vals = torch.cat([v.values.data for v in vs], dim=0)
            uniq, summed = sum_duplicate_rows(idx, vals)
            return RowSparseNDArray(summed, uniq, vs[0].shape)
        merged = vs[0].data
        for extra in vs[1:]:
            merged = merged + extra.data.to(merged.device)
        return NDArray(merged)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out=out, priority=priority)

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` on the store: a push then updates the stored
        weight with the reduced gradient (``update_on_kvstore``)."""
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        """``{"type": "2bit", "threshold": t}`` (the reference's 2-bit
        quantization with error feedback) or ``{"type": "int8"}``
        (blockwise int8 with error feedback); applied on the wire between
        ranks, so only the dist stores honour it."""
        params = dict(compression_params or {})
        ctype = params.get("type", "2bit")
        if ctype == "2bit":
            extra = set(params) - {"type", "threshold"}
            if extra:
                raise MXNetError(f"unknown compression params {sorted(extra)}")
            self._compression = GradientCompression(
                threshold=float(params.get("threshold", 0.5)))
        elif ctype == "int8":
            extra = set(params) - {"type"}
            if extra:
                raise MXNetError(
                    f"int8 compression takes no params, got {sorted(extra)}")
            self._compression = Int8GradientCompression()
        else:
            raise MXNetError(f"unsupported compression type {ctype!r}")

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("Cannot save states for distributed training")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot load states for distributed training")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def barrier(self):
        pass

    def _barrier(self):
        self.barrier()


def _make_buckets(flats, bound):
    """Greedy coalescing of flat tensors into buckets of at most
    ``bound`` bytes (index lists), in order."""
    buckets, cur, cur_bytes = [], [], 0
    for i, f in enumerate(flats):
        nbytes = f.numel() * f.element_size()
        if cur and cur_bytes + nbytes > bound:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


class KVStoreLocal(KVStore):
    """One process's store (reference ``KVStoreLocal``): a push of a
    list of copies reduces them; a pull writes the stored value out."""

    def __init__(self, device_reduce=True):
        super().__init__()
        self._store = {}
        self._device_reduce = device_reduce

    @property
    def type(self):
        return "device" if self._device_reduce else "local"

    @staticmethod
    def _canon(keys, values):
        if isinstance(keys, (list, tuple)):
            return list(keys), list(values)
        return [keys], [values]

    def _stored(self, k):
        k = str(k)
        if k not in self._store:
            raise MXNetError(f"key {k} not initialized (call init first)")
        return self._store[k]

    def init(self, key, value):
        keys, values = self._canon(key, value)
        for k, v in zip(keys, values):
            v = _listify(v)[0]
            self._store[str(k)] = NDArray(v.data.detach().clone())

    def _apply(self, k, red):
        """Store the reduced push ``red`` under ``k``: through the updater
        when the store runs the optimizer, else replace the value."""
        k = str(k)
        if self._updater is not None:
            grad = red if isinstance(red, RowSparseNDArray) \
                else NDArray(red.data.to(self._store[k].data.device))
            self._updater(int(k) if k.isdigit() else k, grad,
                          self._store[k])
        elif isinstance(red, RowSparseNDArray):
            self._store[k] = red
        else:
            self._store[k]._write(red.data.to(self._store[k].data.device))

    def push(self, key, value, priority=0):
        keys, values = self._canon(key, value)
        for k, v in zip(keys, values):
            self._stored(k)
            self._apply(k, self._reduce(_listify(v)))

    def _reduce(self, vs):
        return self._local_reduce(vs)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = self._canon(key, out)
        for k, o in zip(keys, outs):
            stored = self._stored(k)
            for dst in _listify(o):
                _write(dst, stored)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Only the rows ``row_ids`` of each key, as a
        :class:`RowSparseNDArray` (sorted unique rows)."""
        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids")
        keys, outs = self._canon(key, out)
        ids = row_ids if isinstance(row_ids, (list, tuple)) \
            else [row_ids] * len(keys)
        results = []
        for k, o, rid in zip(keys, outs, ids):
            stored = self._stored(k)
            rows = _np.unique(_np.asarray(
                rid.asnumpy() if isinstance(rid, NDArray) else rid)
                .astype(_np.int64).ravel())
            dense = stored.data
            sel = torch.from_numpy(rows).to(dense.device)
            rsp = RowSparseNDArray(dense.index_select(0, sel), sel,
                                   stored.shape)
            if o is not None:
                _write(o, rsp)
                results.append(o)
            else:
                results.append(rsp)
        return results if isinstance(key, (list, tuple)) else results[0]


class KVStoreTPUSync(KVStoreLocal):
    """The synchronous store of one mesh (reference ``KVStoreTPUSync``,
    ``nccl``): a push sums over the ranks of the dp group too, one
    ``all_reduce`` a key on the device (no host synchronization, so it
    may run inside a captured step); one process alone reduces its
    copies only."""

    def __init__(self, device_reduce=True, group=None):
        super().__init__(device_reduce)
        from ..parallel.mesh import AXIS_DP
        self._data_axis = AXIS_DP
        self._group = group

    @property
    def type(self):
        return "tpu_sync"

    def set_data_axis(self, name):
        """The mesh axis the collective reduces over: only the dp axis
        exists in the port's meshes."""
        from ..parallel.mesh import AXIS_DP
        if str(name) != AXIS_DP:
            raise MXNetError(f"set_data_axis({name!r}): the port's meshes "
                             f"have one axis, {AXIS_DP!r}")
        self._data_axis = str(name)

    def _dp_group(self):
        """``(group, size)`` the push reduces over: the given group, the
        current mesh's, else the world's; ``(None, 1)`` alone."""
        if self._group is not None:
            return self._group, dist.get_world_size(self._group)
        from ..parallel.mesh import current_mesh
        mesh = current_mesh()
        if mesh is not None and mesh.distributed:
            return mesh.group, mesh.size
        w = _dist_init.world()
        if w is None or w["size"] == 1:
            return None, 1
        return dist.group.WORLD, w["size"]

    def _reduce(self, vs):
        red = self._local_reduce(vs)
        group, size = self._dp_group()
        if size > 1:
            if isinstance(red, RowSparseNDArray):
                raise MXNetError(
                    f"{self.type}: row_sparse values cross ranks on the "
                    "dist stores (kv.create('dist_sync'))")
            red = NDArray(red.data.clone())
            dist.all_reduce(red.data, group=group)
        return red

    def pushpull_scatter(self, key, value, priority=0):
        """Each rank's 1/N contiguous shard of the sum over the dp group
        (``reduce_scatter_tensor``; values flat, their length divisible
        by N); alone, the whole local sum.  Returns the shard NDArray, or
        the list of them for a key list."""
        if self._updater is not None:
            raise MXNetError("pushpull_scatter supports updater=None only "
                             "(the optimizer on the store is a host path)")
        keys, values = self._canon(key, value)
        group, size = self._dp_group()
        shards = []
        for k, v in zip(keys, values):
            self._stored(k)
            red = self._local_reduce(_listify(v))
            if isinstance(red, RowSparseNDArray):
                raise MXNetError("row_sparse values are not supported by "
                                 "pushpull_scatter")
            flat = red.data.reshape(-1)
            if size > 1:
                if flat.numel() % size:
                    raise MXNetError(
                        f"pushpull_scatter: key {k} has {flat.numel()} "
                        f"elements, not divisible by the dp group's {size} "
                        "ranks (pad the bucket, as parallel.zero.BucketPlan "
                        "does)")
                from ..parallel.zero import _quiet
                shard = flat.new_empty(flat.numel() // size)
                _quiet(dist.reduce_scatter_tensor, shard, flat.contiguous(),
                       group=group)
                flat = shard
            shards.append(NDArray(flat))
        return shards if isinstance(key, (list, tuple)) else shards[0]


class KVStoreDistTPUSync(KVStoreTPUSync):
    """The store over every rank of the process group (reference
    ``KVStoreDistTPUSync``): ``rank`` and ``num_workers`` are the
    group's, ``init`` keeps rank 0's value, a push crosses ranks in
    buckets of at most ``bigarray_bound`` bytes (``wire``:
    ``"allreduce"``, one ``all_reduce`` a bucket, or ``"allgather"``).
    Without a process group it is one worker."""

    def __init__(self, bigarray_bound=None, wire=None):
        super().__init__()
        w = _dist_init.world()
        self._rank = 0 if w is None else w["rank"]
        self._size = 1 if w is None else w["size"]
        self._bound = DEFAULT_BIGARRAY_BOUND if bigarray_bound is None \
            else int(bigarray_bound)
        self._wire = wire or "allreduce"
        if self._wire not in ("allreduce", "allgather"):
            raise MXNetError(f"wire={wire!r}: allreduce or allgather")
        #: the wire the last push used, as the reference reports it
        self._wire_mode = None

    @property
    def type(self):
        return "dist_tpu_sync"

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._size

    def init(self, key, value):
        """Rank 0's value wins (reference ``InitImpl``): one broadcast a
        bucket."""
        super().init(key, value)
        if self._size > 1:
            keys, _ = self._canon(key, value)
            vals = [self._store[str(k)].data for k in keys]
            for idxs in _make_buckets([v.reshape(-1) for v in vals],
                                      self._bound):
                flat = torch.cat([vals[i].reshape(-1) for i in idxs]) \
                    if len({vals[i].dtype for i in idxs}) == 1 else None
                if flat is None:
                    for i in idxs:
                        dist.broadcast(vals[i], src=0)
                    continue
                dist.broadcast(flat, src=0)
                off = 0
                for i in idxs:
                    n = vals[i].numel()
                    vals[i].copy_(flat[off:off + n].view(vals[i].shape))
                    off += n

    def push(self, key, value, priority=0):
        keys, values = self._canon(key, value)
        self._eager_push(keys, values)

    def pushpull(self, key, value, out=None, priority=0):
        """One pass: the reduce, the crossing and the writes into the
        store and into ``out`` (or ``value``)."""
        keys, values = self._canon(key, value)
        outs = out if out is not None else value
        _, outs_l = self._canon(key, outs)
        self._eager_push(keys, values, outs=outs_l)
        return out

    def _eager_push(self, keys, values, outs=None):
        done = {}
        dense_keys, dense = [], []
        for k, v in zip(keys, values):
            self._stored(k)
            red = self._local_reduce(_listify(v))
            if isinstance(red, RowSparseNDArray):
                done[str(k)] = self._allgather_sparse(red) \
                    if self._size > 1 else red
            else:
                dense_keys.append(str(k))
                dense.append(red.data)
        if self._compression is not None:
            packed = [self._compression.compress(k, m)
                      for k, m in zip(dense_keys, dense)]
            if self._size > 1:
                gathered = self._bucketed_allgather([p for p, _ in packed])
                dense = [torch.stack([self._compression.decompress(
                    p, shape, m.dtype) for p in per_worker]).sum(dim=0)
                    for (_, shape), m, per_worker in zip(packed, dense,
                                                         gathered)]
            else:
                dense = [self._compression.decompress(p, shape, m.dtype)
                         for (p, shape), m in zip(packed, dense)]
        elif self._size > 1:
            if self._wire == "allreduce":
                dense = self._bucketed_allreduce(dense)
            else:
                dense = [torch.stack(list(w)).sum(dim=0)
                         for w in self._bucketed_allgather(dense)]
            self._wire_mode = self._wire
        done.update((k, NDArray(m) if torch.is_tensor(m) else m)
                    for k, m in zip(dense_keys, dense))
        for k in [str(k) for k in keys]:
            self._apply(k, done[k])
        if outs is not None:
            for k, o in zip([str(k) for k in keys], outs):
                for dst in _listify(o):
                    _write(dst, self._store[k])

    def _allreduce_async(self, flat):
        """Launch the sum of ``flat`` over every rank, in place and
        asynchronous (the overlap scheduler's wire); None where this
        store's push is more than a sum (compression, an optimizer on
        the store, the all-gather wire) or there is one worker."""
        if self._compression is not None or self._updater is not None \
                or self._wire != "allreduce" or self._size == 1:
            return None
        return dist.all_reduce(flat, async_op=True)

    def _bucketed_allreduce(self, arrays):
        """The sum of each tensor over every rank: the tensors of one
        dtype coalesced into buckets of at most ``bigarray_bound`` bytes,
        one ``all_reduce`` a bucket."""
        out = [None] * len(arrays)
        flats = [a.reshape(-1) for a in arrays]
        for idxs in _make_buckets(flats, self._bound):
            groups = {}
            for i in idxs:
                groups.setdefault(flats[i].dtype, []).append(i)
            for members in groups.values():
                flat = torch.cat([flats[i] for i in members])
                dist.all_reduce(flat)
                off = 0
                for i in members:
                    n = flats[i].numel()
                    out[i] = flat[off:off + n].view(arrays[i].shape)
                    off += n
        return out

    def _bucketed_allgather(self, arrays):
        """Every rank's value of each tensor (a list, rank order): one
        ``all_gather`` a bucket of one dtype."""
        from ..parallel.zero import _quiet
        per_key = [None] * len(arrays)
        flats = [a.reshape(-1) for a in arrays]
        for idxs in _make_buckets(flats, self._bound):
            groups = {}
            for i in idxs:
                groups.setdefault(flats[i].dtype, []).append(i)
            for members in groups.values():
                flat = torch.cat([flats[i] for i in members])
                got = flat.new_empty(self._size * flat.numel())
                _quiet(dist.all_gather_into_tensor, got, flat)
                got = got.view(self._size, -1)
                off = 0
                for i in members:
                    n = flats[i].numel()
                    per_key[i] = [got[w, off:off + n].view(arrays[i].shape)
                                  for w in range(self._size)]
                    off += n
        return per_key

    def _allgather_sparse(self, rsp):
        """The sum over every rank of a row-sparse value at O(rows) wire
        cost: the row counts gathered, indices and values padded to the
        largest and gathered, then merged by row.  Never dense."""
        from ..parallel.zero import _quiet
        idx = rsp.indices.data.to(torch.int64)
        vals = rsp.values.data
        sizes = idx.new_empty(self._size)
        _quiet(dist.all_gather_into_tensor, sizes,
               idx.new_tensor([idx.numel()]))
        sizes = sizes.cpu().tolist()
        cap = max(sizes)
        if cap == 0:
            return rsp
        pad = cap - idx.numel()
        if pad:
            idx = torch.cat([idx, idx.new_zeros(pad)])
            vals = torch.cat([vals, vals.new_zeros((pad,) + vals.shape[1:])])
        all_idx = idx.new_empty(self._size * cap)
        all_vals = vals.new_empty((self._size * cap,) + vals.shape[1:])
        _quiet(dist.all_gather_into_tensor, all_idx, idx.contiguous())
        _quiet(dist.all_gather_into_tensor, all_vals, vals.contiguous())
        keep = torch.cat([torch.arange(w * cap, w * cap + sizes[w])
                          for w in range(self._size)]).to(all_idx.device)
        uniq, summed = sum_duplicate_rows(
            all_idx.index_select(0, keep).to(torch.int32),
            all_vals.index_select(0, keep))
        return RowSparseNDArray(summed, uniq, rsp.shape)

    def barrier(self):
        if self._size > 1:
            dist.barrier()


class GradientCompression:
    """2-bit gradient quantization with error feedback (reference
    ``Quantize2Bit``): values at or above ``threshold`` send
    +threshold (code 1), at or below -threshold send -threshold (code
    2), the rest 0; the error is kept in a residual a key, added before
    the next quantization; codes pack 4 to a byte."""

    def __init__(self, threshold=0.5):
        if threshold <= 0:
            raise MXNetError("threshold must be positive")
        self.threshold = float(threshold)
        self._residuals = {}

    def compress(self, key, grad):
        """``grad`` -> ``(packed uint8 codes, shape)``; updates the
        residual."""
        t = self.threshold
        res = self._residuals.get(key)
        g = grad if res is None else grad + res
        codes = torch.where(g >= t, 1, torch.where(g <= -t, 2, 0)) \
            .to(torch.uint8)
        q = torch.where(codes == 1, t, torch.where(codes == 2, -t, 0.0)) \
            .to(grad.dtype)
        self._residuals[key] = g - q
        flat = codes.reshape(-1)
        pad = (-flat.numel()) % 4
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        quads = flat.view(-1, 4)
        packed = quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) \
            | (quads[:, 3] << 6)
        return packed, tuple(grad.shape)

    def decompress(self, packed, shape, dtype=torch.float32):
        t = self.threshold
        quads = torch.stack([(packed >> s) & 3 for s in (0, 2, 4, 6)], dim=1)
        flat = quads.reshape(-1)[:int(_np.prod(shape))]
        vals = torch.where(flat == 1, t, torch.where(flat == 2, -t, 0.0))
        return vals.reshape(shape).to(dtype)


class Int8GradientCompression:
    """Blockwise int8 wire quantization with error feedback (reference
    ``Int8GradientCompression``): each 256-value block one f32 scale
    (``max|g| / 127``) and round-to-nearest codes, carried with their
    scales' bytes in one uint8 payload."""

    BLOCK = 256

    def __init__(self):
        self._residuals = {}

    def compress(self, key, grad):
        b = self.BLOCK
        res = self._residuals.get(key)
        g = grad if res is None else grad + res
        flat = g.reshape(-1).to(torch.float32)
        pad = (-flat.numel()) % b
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        blocks = flat.view(-1, b)
        scale = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True)
                                / 127.0, 1e-30)
        q = quantize_rtn_int8(blocks, scale)
        deq = (q.to(torch.float32) * scale).reshape(-1)[:g.numel()]
        self._residuals[key] = g - deq.view(g.shape).to(grad.dtype)
        return torch.cat([q.reshape(-1).view(torch.uint8),
                          scale.reshape(-1).contiguous().view(torch.uint8)]), \
            tuple(grad.shape)

    def decompress(self, packed, shape, dtype=torch.float32):
        b = self.BLOCK
        n = int(_np.prod(shape))
        npad = -(-n // b) * b
        codes = packed[:npad].contiguous().view(torch.int8).view(-1, b)
        scale = packed[npad:npad + 4 * (npad // b)].contiguous() \
            .view(torch.float32)
        vals = codes.to(torch.float32) * scale.view(-1, 1)
        return vals.reshape(-1)[:n].view(shape).to(dtype)


def create(name="local", bigarray_bound=None, wire=None):
    """The store of type ``name`` (reference ``mx.kv.create``);
    ``bigarray_bound`` (bytes) and ``wire`` are the dist stores'."""
    name = name.lower()
    if name == "local":
        return KVStoreLocal(device_reduce=False)
    if name == "device":
        return KVStoreLocal(device_reduce=True)
    if name in ("nccl", "tpu_sync"):
        return KVStoreTPUSync()
    if name in ("dist_sync", "dist_device_sync", "dist_tpu_sync"):
        return KVStoreDistTPUSync(bigarray_bound=bigarray_bound, wire=wire)
    if name == "dist_async":
        raise NotSupportedError(
            "kv.create('dist_async'): the asynchronous parameter server "
            "(kvstore/ps_server.py, rpc.py) arrives with ROADMAP §1 item 10b")
    if name in ("horovod", "byteps"):
        from .horovod import KVStoreHorovod, KVStoreBytePS
        cls = KVStoreHorovod if name == "horovod" else KVStoreBytePS
        return cls(bigarray_bound=bigarray_bound, wire=wire)
    raise MXNetError(f"unknown KVStore type {name!r}")
