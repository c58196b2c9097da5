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

Routing is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises.  This slice takes f32 and bf16 pools; the
fp8 path with per-row scales comes with the fp8 KV slice.

Kernel note: replaces ``_pallas_paged`` (``paged_attention.py:89``).
Memory-bound on the H100: per layer a step reads about
``2 * B * ctx * KVH * D * sizeof(pool)`` bytes of K/V against
``4 * H * D`` FLOPs per position.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError, NotSupportedError
from . import _build
from .quant_kv import kv_dequantize

__all__ = ["paged_decode_attention", "paged_decode_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_REPS = (1, 2, 4, 8)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"paged_decode_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                          _I, _I, _I, _I, _I, ctypes.c_float,
                                          _I, _P]}


def paged_decode_plain(q, k_pool, v_pool, block_tables, pos, scale):
    """Plain PyTorch version (the reference's ``_fallback``): gather the
    sequences' blocks into a dense ``(B, L, KVH, D)`` view, widen a bf16
    pool to f32, mask positions past ``pos`` and attend."""
    from ..gluon.model_zoo.nlp.llama import _cache_attention
    B = q.shape[0]
    nbl = block_tables.shape[1]
    bs, kvh, d = k_pool.shape[1:]
    L = nbl * bs
    tables = block_tables.long()
    ck = k_pool[tables].reshape(B, L, kvh, d)
    cv = v_pool[tables].reshape(B, L, kvh, d)
    if k_pool.dtype != torch.float32:
        ck = kv_dequantize(ck)
        cv = kv_dequantize(cv)
    ck = ck.transpose(1, 2)
    cv = cv.transpose(1, 2)
    valid = torch.arange(L, device=q.device)[None, :] <= pos[:, None]
    return _cache_attention(q, ck, cv, valid, scale)


def _kernel(q, k_pool, v_pool, block_tables, pos, scale):
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
    if q.dtype not in _DTYPES or k_pool.dtype not in _DTYPES \
            or v_pool.dtype != k_pool.dtype:
        raise NotSupportedError(f"paged kernel: q {q.dtype}, pools "
                                f"{k_pool.dtype}/{v_pool.dtype} (f32, bf16)")
    if q.dtype == torch.bfloat16 and k_pool.dtype != torch.bfloat16:
        raise NotSupportedError("paged kernel: a bf16 query needs a bf16 pool")
    if block_tables.shape != (B, nbl) or pos.shape != (B,) \
            or block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise MXNetError("paged kernel: block_tables (B, nbl) and pos (B,) "
                         "must be int32")
    for t in (k_pool, v_pool, block_tables, pos):
        if t.device != q.device:
            raise MXNetError("paged kernel: all inputs on one device")
    for t in (q, k_pool, v_pool, block_tables, pos):
        if not t.is_contiguous():
            raise MXNetError("paged kernel: inputs must be contiguous")
    out = torch.empty(B, H * D, dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    lib = _build.load("paged_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H, kvh,
        D, bs, nbl, _DTYPES[q.dtype], _DTYPES[k_pool.dtype], float(scale),
        q.device.index, stream)
    _build.check(lib, err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, pos, scale):
    """One decode step of attention against a paged KV cache.

    q : (B, H, D) current-position queries, already rotated.
    k_pool / v_pool : (num_blocks, block_size, KVH, D) -- one layer's
        slice of the engine's pool, f32 or bf16.
    block_tables : (B, n_blocks) int32 physical block ids per sequence
        (null-block padded); every id must be < num_blocks.
    pos : (B,) int32 position written this step; cache positions
        ``<= pos`` participate, later ones (write-ahead rows, padding)
        are masked.
    scale : softmax scale (1/sqrt(D)).

    Returns (B, H*D) in q's dtype.  CUDA tensors launch the kernel and
    count one launch in ``paged_decode_attention.launches``.
    """
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, block_tables, pos, scale)
    if q.device.type == "cuda":
        return _kernel(q, k_pool, v_pool, block_tables, pos, scale)
    raise MXNetError(f"paged_decode_attention: unsupported device {q.device}")


paged_decode_attention.launches = 0
