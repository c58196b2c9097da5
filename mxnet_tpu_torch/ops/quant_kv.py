"""KV-cache storage precision: the counterpart of
``mxnet_tpu/ops/quant_kv.py``.

The serving pools are pure storage: each step writes fresh K/V rows into
pool blocks and the attention reads them back widened to f32.  Three
modes:

- ``None`` (also ``"fp32"``): the pool keeps the model's own dtype;
- ``"bf16"``: bfloat16 codes, no scales (bf16 keeps f32's exponent
  range, so amax scaling buys nothing);
- ``"fp8"``: ``float8_e4m3fn`` codes with ONE f32 amax scale per written
  token row (amax over that row's ``(kv_heads, head_dim)`` values), kept
  in ``(layers, num_blocks, block_size)`` scale planes beside the pools.
  Per-row scales make a one-row decode write exact without requantizing
  its neighbours.  Quantization is round-to-nearest of ``x / scale``;
  dequantization multiplies the row scale back in f32 before any
  attention math.  :func:`kv_block_bytes` charges the scale rows.

One deliberate difference from the reference: :func:`kv_quantize_fp8`
always quantizes from f32, so a bf16 model's rows are widened first
(the reference computes a bf16 row's amax / 448 in bf16).
For f32 rows the codes and scales are bitwise the reference's.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["resolve_kv_dtype", "kv_pool_dtype", "kv_has_scales", "kv_cast",
           "kv_quantize_fp8", "kv_dequantize", "kv_block_bytes",
           "kv_blocks_in_budget", "FP8_MAX"]

#: max normal magnitude of float8_e4m3fn: the fp8 amax scaling target
FP8_MAX = 448.0

_CANON = {"fp8": "fp8", "float8": "fp8", "float8_e4m3fn": "fp8",
          "bf16": "bf16", "bfloat16": "bf16",
          "fp32": None, "float32": None, "": None, "none": None}


def resolve_kv_dtype(value=None):
    """Canonical storage mode: ``"fp8"``, ``"bf16"`` or ``None`` (the
    pool keeps the model's dtype).  Unknown names raise."""
    v = "" if value is None else str(value).strip().lower()
    if v not in _CANON:
        raise MXNetError(f"kv_dtype={value!r}: expected fp8|bf16|fp32")
    return _CANON[v]


def kv_pool_dtype(kv_dtype, model_dtype=torch.float32):
    """The pool storage dtype for a resolved mode."""
    if kv_dtype == "fp8":
        return torch.float8_e4m3fn
    return torch.bfloat16 if kv_dtype == "bf16" else model_dtype


def kv_has_scales(kv_dtype):
    """Only fp8 carries per-row amax scale planes."""
    return kv_dtype == "fp8"


def kv_cast(x, dtype):
    """Storage cast for the scale-free modes: identity when ``x`` already
    has ``dtype``."""
    return x if x.dtype == dtype else x.to(dtype)


def kv_quantize_fp8(x):
    """K or V rows ``x`` (..., kv_heads, head_dim) to fp8 codes and
    per-row scales: ``scale = max(amax / 448, 1e-30)`` over each row's
    (kvh, hd) values (the floor makes an all-zero row quantize to exact
    zeros), ``codes = fp8(x / scale)`` rounded to nearest.  A bf16 or
    f16 ``x`` is widened to f32 first.  Returns ``(codes x.shape
    float8_e4m3fn, scales x.shape[:-2] f32)``."""
    x = x.float()
    amax = x.abs().amax(dim=(-2, -1))
    scale = torch.clamp_min(amax / FP8_MAX, 1e-30)
    codes = (x / scale[..., None, None]).to(torch.float8_e4m3fn)
    return codes, scale


def kv_dequantize(codes, scale=None):
    """Back to f32 for the attention math: ``codes * scale`` per row
    (fp8; ``scale`` has ``codes.shape[:-2]``), or a plain widening cast
    (bf16, ``scale=None``)."""
    x = codes.float()
    if scale is None:
        return x
    return x * scale[..., None, None]


def kv_block_bytes(num_layers, num_kv_heads, head_dim, block_size,
                   kv_dtype=None):
    """Bytes ONE pool block pins across both pools and all layers,
    including the fp8 scale rows (an f32 pool when ``kv_dtype`` is
    None, as in the reference)."""
    per = (2 * num_layers * block_size * num_kv_heads * head_dim
           * kv_pool_dtype(kv_dtype).itemsize)
    if kv_has_scales(kv_dtype):
        per += 2 * num_layers * block_size * 4   # f32 scale per token row
    return per


def kv_blocks_in_budget(budget_bytes, num_layers, num_kv_heads, head_dim,
                        block_size, kv_dtype=None):
    """Allocatable blocks one byte budget holds at a storage mode."""
    per = kv_block_bytes(num_layers, num_kv_heads, head_dim, block_size,
                         kv_dtype)
    return int(budget_bytes) // per
