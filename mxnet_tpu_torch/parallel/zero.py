"""Bucketed sharded gradient sync and ZeRO-1 optimizer-state sharding.

Counterpart of ``mxnet_tpu/parallel/zero.py``:

- :class:`BucketPlan`: the trainable parameters filled, in order, into
  flat f32 buckets of at most ``bound_bytes`` (one tensor larger than
  the bound gets a bucket of its own), each zero-padded to a multiple of
  ``dp`` so that every rank's shard is ``length // dp`` elements.
- :func:`reduce_scatter_bucket`: one bucket's gradient mean over the dp
  ranks, of which this rank keeps its 1/dp shard; the wire carries f32,
  bf16 (the sum taken in bf16) or int8 (stochastic-rounding codes at one
  scale a rank and bucket, exchanged by ``all_to_all`` and summed in
  f32).  :func:`all_gather_bucket` brings the updated shards back.
- :func:`comm_block`: the ``comm`` observability schema.

The reference reads its knobs from the environment; here each is an
argument (ROADMAP §3): ``DataParallelTrainer``'s ``bucket_mb``
(``MXTPU_COMM_BUCKET_MB``, default 32), ``comm_dtype``
(``MXTPU_COMM_DTYPE``) and ``shard_updates=False`` (the kill switch
``MXTPU_SHARDED_SYNC=0``), and the gluon ``Trainer``'s
``overlap_comm`` (``MXTPU_OVERLAP_COMM``).

The collectives run over a ``torch.distributed`` process group, one
process a rank: ``reduce_scatter_tensor``, ``all_gather_into_tensor``,
``all_to_all_single`` and ``all_reduce`` on every backend.  gloo takes
all four on CUDA tensors too, in torch 2.11 on the card machine and
2.13 on the CPU (``tools/port_dist_probe.py``), so no collective is
rebuilt from another under gloo; ``comm_stats()`` reports the group's
``backend``.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from ..base import MXNetError
from ..ops.quant_matmul import (quantize_sr_int8 as quantize_int8,
                                dequantize_int8)

__all__ = ["BucketPlan", "bucket_bound_bytes", "comm_dtype",
           "reduce_scatter_bucket", "all_gather_bucket", "all_reduce_mean",
           "quantize_int8", "dequantize_int8", "int8_roundtrip_error",
           "comm_block", "ZERO1_RULES", "DEFAULT_BUCKET_MB"]

#: rules elementwise in the parameter, so the update runs on any flat
#: shard of a bucket; lamb and lars need per-parameter norms and keep
#: the replicated psum path
ZERO1_RULES = frozenset({"sgd", "nag", "adam", "adamw", "rmsprop"})

#: the reference's default bucket bound (``MXTPU_COMM_BUCKET_MB`` unset)
DEFAULT_BUCKET_MB = 32


def bucket_bound_bytes(bucket_mb=None):
    """The bucket bound in bytes (``bucket_mb`` MiB, default 32)."""
    mb = DEFAULT_BUCKET_MB if bucket_mb is None else float(bucket_mb)
    if mb <= 0:
        raise MXNetError(f"bucket_mb must be positive, got {bucket_mb!r}")
    return int(mb * 1024 * 1024)


def comm_dtype(mode="fp32"):
    """The gradient wire's dtype name, ``"fp32"``, ``"bf16"`` or
    ``"int8"`` (``float32``/``bfloat16`` accepted)."""
    m = str(mode or "fp32").lower()
    if m not in ("fp32", "float32", "bf16", "bfloat16", "int8"):
        raise MXNetError(f"comm_dtype={mode!r}: expected fp32|bf16|int8")
    return {"float32": "fp32", "bfloat16": "bf16"}.get(m, m)


class BucketPlan:
    """Greedy coalescing of parameter tensors into flat f32 buckets
    (reference ``BucketPlan``): ``buckets`` (lists of parameter indices),
    ``lengths`` (padded), ``offsets`` (``(bucket, offset)`` of each
    parameter)."""

    def __init__(self, shapes, dp, bound_bytes=None):
        if dp < 1:
            raise MXNetError(f"BucketPlan: dp must be >= 1, got {dp}")
        bound = bound_bytes if bound_bytes is not None \
            else bucket_bound_bytes()
        bound_elems = max(1, bound // 4)          # f32 on-wire elements
        self.dp = int(dp)
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.sizes = [int(torch.Size(s).numel()) for s in self.shapes]
        self.buckets = []
        cur, cur_n = [], 0
        for i in range(len(self.sizes)):
            n = self.sizes[i]
            if cur and cur_n + n > bound_elems:
                self.buckets.append(cur)
                cur, cur_n = [], 0
            cur.append(i)
            cur_n += n
        if cur:
            self.buckets.append(cur)
        self.lengths = []
        self.offsets = [None] * len(self.sizes)
        for b, idxs in enumerate(self.buckets):
            off = 0
            for i in idxs:
                self.offsets[i] = (b, off)
                off += self.sizes[i]
            self.lengths.append(off + (-off) % self.dp)

    @property
    def n_buckets(self):
        return len(self.buckets)

    def shard_length(self, b):
        return self.lengths[b] // self.dp

    def bucket_starts(self):
        """Each bucket's first element in the concatenated buckets."""
        starts, off = [], 0
        for n in self.lengths:
            starts.append(off)
            off += n
        return starts

    def param_span(self, i):
        """``(bucket, offset, size)`` of parameter ``i`` in bucket space."""
        b, off = self.offsets[i]
        return b, off, self.sizes[i]

    def flatten(self, arrays):
        """Per-bucket flat f32 tensors (plan order, zero-padded)."""
        out = []
        for b, idxs in enumerate(self.buckets):
            parts = [arrays[i].reshape(-1).to(torch.float32) for i in idxs]
            pad = self.lengths[b] - sum(self.sizes[i] for i in idxs)
            if pad:
                parts.append(parts[0].new_zeros(pad))
            out.append(torch.cat(parts) if len(parts) > 1 else parts[0])
        return out

    def unflatten(self, flats, like):
        """Inverse of :meth:`flatten`: tensors of the plan's shapes and
        ``like``'s dtypes."""
        out = [None] * len(self.shapes)
        for i, (b, off) in enumerate(self.offsets):
            n = self.sizes[i]
            out[i] = flats[b][off:off + n].reshape(self.shapes[i]) \
                .to(like[i].dtype)
        return out

    def grad_bytes_fp32(self):
        return 4 * sum(self.lengths)

    def wire_bytes(self, mode):
        """A rank's gradient payload of one reduce-scatter round, after
        quantization (the reference's accounting)."""
        per_elem = {"fp32": 4, "bf16": 2, "int8": 1}[mode]
        scales = 4 * self.n_buckets if mode == "int8" else 0
        return per_elem * sum(self.lengths) + scales


def int8_roundtrip_error(flat, u=None):
    """``max|deq - x| / max|x|`` of one quantization of ``flat`` at the
    draw ``u`` (None: the device's generator)."""
    q, scale = quantize_int8(flat, u)
    err = (dequantize_int8(q, scale) - flat).abs().amax()
    return err / torch.clamp_min(flat.abs().amax(), 1e-30)


def _quiet(fn, *args, **kwargs):
    """Call a collective whose name torch has deprecated for another
    (``reduce_scatter_tensor``, ``all_gather_into_tensor``: their
    successors are not in every torch the port runs on)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


def reduce_scatter_bucket(flat, dp, mode="fp32", group=None, u=None):
    """The mean over the ``dp`` ranks of ``group`` of one bucket
    (``flat``: this rank's local f32 gradient, ``len % dp == 0``);
    returns this rank's 1/dp shard.  ``mode``: the wire dtype; ``u``: the
    int8 rounding draw (None: the device's generator)."""
    n = flat.numel()
    if n % dp:
        raise MXNetError(f"reduce_scatter_bucket: {n} elements not "
                         f"divisible by dp={dp} (pad the bucket)")
    ls = n // dp
    if mode in ("fp32", "bf16"):
        wire = flat if mode == "fp32" else flat.to(torch.bfloat16)
        shard = wire.new_empty(ls)
        _quiet(dist.reduce_scatter_tensor, shard, wire, group=group)
        return shard.to(torch.float32) / dp
    if mode == "int8":
        q, scale = quantize_int8(flat, u)
        got = torch.empty_like(q)
        # row j of (dp, ls) goes to rank j: each rank receives every
        # peer's codes for its own shard
        dist.all_to_all_single(got, q, group=group)
        scales = scale.reshape(1).new_empty(dp)
        _quiet(dist.all_gather_into_tensor, scales, scale.reshape(1),
               group=group)
        deq = (got.reshape(dp, ls).to(torch.float32)
               * scales.reshape(dp, 1)).sum(dim=0)
        return deq / dp
    raise MXNetError(f"unknown comm dtype {mode!r}")


def all_gather_bucket(out, shard, group=None):
    """Gather every rank's ``shard`` into the bucket ``out`` in rank
    order (the parameters come back exact: f32 on every transport)."""
    _quiet(dist.all_gather_into_tensor, out, shard, group=group)
    return out


def all_reduce_mean(flat, dp, group=None):
    """``flat`` summed over ``dp`` ranks and divided, in place."""
    dist.all_reduce(flat, group=group)
    return flat.div_(dp)


def comm_block(dp=1, wire_dtype="fp32", buckets=0, bucket_mb=None,
               bytes_reduced_per_step=0, bytes_gathered_per_step=0,
               grad_bytes_fp32=0, collective_ms=None, est_ici_gb_s=None,
               zero1=False, state_bytes_per_chip=0,
               state_bytes_replicated=0, exposed_comm_ms=None,
               backend=None):
    """The per-step ``comm`` block (the reference's keys, and
    ``backend``: the process group's).  Measured fields are None when
    nothing was measured, never 0.  ``DataParallelTrainer`` launches a
    step's collectives after its backward: ``overlap_comm`` is False and
    ``overlap_efficiency``/``overlap_frac`` None (nothing overlaps)."""
    def _r(x, n):
        return None if x is None else round(float(x), n)

    return {
        "zero1": bool(zero1),
        "dp": int(dp),
        "wire_dtype": str(wire_dtype),
        "buckets": int(buckets),
        "bucket_mb": float(bucket_mb if bucket_mb is not None
                           else DEFAULT_BUCKET_MB),
        "bytes_reduced_per_step": int(bytes_reduced_per_step),
        "bytes_gathered_per_step": int(bytes_gathered_per_step),
        "grad_bytes_fp32": int(grad_bytes_fp32),
        "collective_ms": _r(collective_ms, 3),
        "est_ici_gb_s": _r(est_ici_gb_s, 2),
        "overlap_efficiency": None,
        "overlap_comm": False,
        "exposed_comm_ms": _r(exposed_comm_ms, 3),
        "overlap_frac": None,
        "state_bytes_per_chip": int(state_bytes_per_chip),
        "state_bytes_replicated": int(state_bytes_replicated),
        "backend": backend,
    }
