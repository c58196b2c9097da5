"""Paged decode attention: a CUDA kernel for Hopper and its plain version.

Counterpart of ``mxnet_tpu/ops/paged_attention.py``.  One decode step
attends one query token per sequence against the block-table paged KV
cache (``serving.kv_cache.PagedKVCache``).  The TPU kernel
(``_pallas_paged``) becomes ``csrc/paged_attention.cu``; the plain
PyTorch version is a port of the reference's ``_fallback``: a dense
gather through the block table, then the shared single-block
online softmax ``llama._cache_attention``.  In the JAX engine the
default inline decode attention is that same fallback, so the port's
engine uses this op as its only decode path.

Pools are f32, bf16 or fp8 (``float8_e4m3fn`` codes with one f32 scale
per token row, ``k_scale``/``v_scale`` of shape ``(num_blocks,
block_size)``); the scale rows are gathered through the same block table
and multiplied in after the gather.  Routing is by device: a CPU tensor
runs the plain version, a CUDA tensor launches the kernel or raises.
The kernel counts f32/bf16 launches in ``paged_decode_attention.launches``
and fp8 launches in ``paged_decode_attention.launches_fp8``.

Kernel note: replaces ``_pallas_paged`` (``paged_attention.py:89``).
Memory-bound on the H100: per layer a step reads about
``2 * B * ctx * KVH * D * sizeof(pool)`` bytes of K/V (plus ``8 * ctx``
bytes of scales per sequence for fp8) against ``4 * H * D`` FLOPs per
position.  To fill the card at decode batch sizes the kernel splits the
context: its grid is (B, KVH, S), S splits of C positions
(:func:`split_plan`, from the table's width, never from ``pos``, so the
launch needs no host synchronisation).  Each split writes its
unnormalised softmax state (max, sum of p, p.V) to an f32 workspace
(``torch.empty`` per call) and draws a ticket from an int32 counter per
(sequence, kv head); the last split merges all of them in split order
and resets the counter.  The counters are one zeroed buffer per device,
kept by this module and grown on demand; K5 runs on one stream.  One
launch per call, no float atomics: two runs give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError, NotSupportedError
from . import _build
from .quant_kv import kv_dequantize

__all__ = ["paged_decode_attention", "paged_decode_plain", "split_plan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_DTYPES = {**_DTYPES, torch.float8_e4m3fn: 2}
_HEAD_DIMS = (64, 128)
_REPS = (1, 2, 4, 8)
_SPLIT = 128                # positions of the context a CTA takes

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"paged_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P,
                                          _P, _P, _I, _I, _I, _I, _I, _I,
                                          _I, _I, _I, _I, ctypes.c_float,
                                          _I, _P]}
_counters = {}              # device index -> zeroed int32 ticket counters


def split_plan(nbl, bs):
    """``(C, S)``: the kernel cuts a table of ``nbl`` blocks of ``bs``
    positions into ``S`` splits of ``C`` positions, ``C`` the largest
    multiple of ``bs`` within 128, at least ``bs``.  The C entry refuses
    a plan whose split does not fit a CTA's shared memory."""
    c = bs * max(1, _SPLIT // bs)
    return c, max(1, -(-nbl * bs // c))


def _ticket_counters(device, n):
    """At least ``n`` zeroed int32 counters on ``device``; every launch
    leaves them zeroed."""
    buf = _counters.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device.index] = buf
    return buf


def paged_decode_plain(q, k_pool, v_pool, block_tables, pos, scale,
                       k_scale=None, v_scale=None):
    """Plain PyTorch version (the reference's ``_fallback``): gather the
    sequences' blocks into a dense ``(B, L, KVH, D)`` view, dequantize a
    low-precision pool to f32 (fp8 codes times their row scales, gathered
    through the same table), mask positions past ``pos`` and attend."""
    from ..gluon.model_zoo.nlp.llama import _cache_attention
    B = q.shape[0]
    nbl = block_tables.shape[1]
    bs, kvh, d = k_pool.shape[1:]
    L = nbl * bs
    tables = block_tables.long()
    ck = k_pool[tables].reshape(B, L, kvh, d)
    cv = v_pool[tables].reshape(B, L, kvh, d)
    if k_scale is not None:
        ck = kv_dequantize(ck, k_scale[tables].reshape(B, L))
        cv = kv_dequantize(cv, v_scale[tables].reshape(B, L))
    elif k_pool.dtype != torch.float32:
        ck = kv_dequantize(ck)
        cv = kv_dequantize(cv)
    ck = ck.transpose(1, 2)
    cv = cv.transpose(1, 2)
    valid = torch.arange(L, device=q.device)[None, :] <= pos[:, None]
    return _cache_attention(q, ck, cv, valid, scale)


def _check_scales(k_pool, k_scale, v_scale):
    """An fp8 pool needs both scale planes, contiguous f32 of shape
    ``(num_blocks, block_size)``; another pool takes none."""
    fp8 = k_pool.dtype == torch.float8_e4m3fn
    if (k_scale is None) != (v_scale is None):
        raise NotSupportedError("paged attention: k_scale and v_scale come "
                                "together")
    if fp8 and k_scale is None:
        raise NotSupportedError("paged attention: an fp8 pool needs its "
                                "k_scale/v_scale planes")
    if not fp8 and k_scale is not None:
        raise NotSupportedError(f"paged attention: scales with a "
                                f"{k_pool.dtype} pool (fp8 only)")
    if fp8:
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or t.shape != k_pool.shape[:2] \
                    or not t.is_contiguous():
                raise NotSupportedError(
                    "paged attention: scales must be contiguous f32 of "
                    f"shape {tuple(k_pool.shape[:2])}, got {t.dtype} "
                    f"{tuple(t.shape)}")


def _kernel(q, k_pool, v_pool, block_tables, pos, scale, k_scale, v_scale):
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise MXNetError(f"paged kernel: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, H, D = q.shape
    _, bs, kvh, d = k_pool.shape
    nbl = block_tables.shape[-1]
    if d != D or D not in _HEAD_DIMS:
        raise NotSupportedError(f"paged kernel: head_dim {D} vs pool {d} "
                                "(64 or 128)")
    if H % kvh or H // kvh not in _REPS:
        raise NotSupportedError(f"paged kernel: {H} heads over {kvh} kv "
                                f"heads (rep in {_REPS})")
    if q.dtype not in _DTYPES or k_pool.dtype not in _POOL_DTYPES \
            or v_pool.dtype != k_pool.dtype:
        raise NotSupportedError(f"paged kernel: q {q.dtype}, pools "
                                f"{k_pool.dtype}/{v_pool.dtype} (f32, bf16, "
                                "fp8)")
    if q.dtype == torch.bfloat16 and k_pool.dtype == torch.float32:
        raise NotSupportedError("paged kernel: a bf16 query needs a bf16 or "
                                "fp8 pool")
    _check_scales(k_pool, k_scale, v_scale)
    scales = () if k_scale is None else (k_scale, v_scale)
    if block_tables.shape != (B, nbl) or pos.shape != (B,) \
            or block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise MXNetError("paged kernel: block_tables (B, nbl) and pos (B,) "
                         "must be int32")
    for t in (k_pool, v_pool, block_tables, pos, *scales):
        if t.device != q.device:
            raise MXNetError("paged kernel: all inputs on one device")
    for t in (q, k_pool, v_pool, block_tables, pos):
        if not t.is_contiguous():
            raise MXNetError("paged kernel: inputs must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise MXNetError("paged kernel: pools must be 16-byte aligned (the "
                         "kernel loads 16 bytes a lane)")
    out = torch.empty(B, H * D, dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    chunk, splits = split_plan(nbl, bs)
    ws = counters = None
    if splits > 1:
        ws = torch.empty(B * kvh * splits * (H // kvh) * (D + 2),
                         dtype=torch.float32, device=q.device)
        counters = _ticket_counters(q.device, B * kvh)
    lib = _build.load("paged_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ks_ptr, vs_ptr = [t.data_ptr() for t in scales] if scales else [None] * 2
    err = lib.paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks_ptr, vs_ptr,
        block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), B, H, kvh, D, bs,
        nbl, chunk, splits, _DTYPES[q.dtype], _POOL_DTYPES[k_pool.dtype],
        float(scale), q.device.index, stream)
    _build.check(lib, err, "paged_decode_attention")
    if scales:
        paged_decode_attention.launches_fp8 += 1
    else:
        paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, pos, scale,
                           k_scale=None, v_scale=None):
    """One decode step of attention against a paged KV cache.

    q : (B, H, D) current-position queries, already rotated (f32 or
        bf16).
    k_pool / v_pool : (num_blocks, block_size, KVH, D) -- one layer's
        slice of the engine's pool: f32, bf16 or float8_e4m3fn codes.
    block_tables : (B, n_blocks) int32 physical block ids per sequence
        (null-block padded); every id must be < num_blocks.
    pos : (B,) int32 position written this step; cache positions
        ``<= pos`` participate, later ones (write-ahead rows, padding)
        are masked.
    scale : softmax scale (1/sqrt(D)).
    k_scale / v_scale : (num_blocks, block_size) f32 per-token-row
        scales of an fp8 pool (one layer's plane), None otherwise.

    Returns (B, H*D) in q's dtype.  CUDA tensors launch the kernel and
    count one launch in ``paged_decode_attention.launches`` (f32/bf16
    pools) or ``paged_decode_attention.launches_fp8`` (fp8 pools).
    """
    if q.device.type == "cpu":
        _check_scales(k_pool, k_scale, v_scale)
        return paged_decode_plain(q, k_pool, v_pool, block_tables, pos, scale,
                                  k_scale, v_scale)
    if q.device.type == "cuda":
        return _kernel(q, k_pool, v_pool, block_tables, pos, scale, k_scale,
                       v_scale)
    raise MXNetError(f"paged_decode_attention: unsupported device {q.device}")


paged_decode_attention.launches = 0
paged_decode_attention.launches_fp8 = 0
