"""KV-cache storage precision: the fp32/bf16 subset of
``mxnet_tpu/ops/quant_kv.py``.

The serving pools are pure storage: each step writes fresh K/V rows into
pool blocks and the attention reads them back widened to f32.  This slice
stores either the model's own dtype (``None``/``"fp32"``) or bfloat16
(``"bf16"``, no scales).  The fp8 mode with per-row amax scales is the
later slice that ports the fp8 path of the paged kernel; selecting it
raises :class:`NotSupportedError`.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, NotSupportedError

__all__ = ["resolve_kv_dtype", "kv_pool_dtype", "kv_cast", "kv_dequantize"]

_CANON = {"fp8": "fp8", "float8": "fp8", "float8_e4m3fn": "fp8",
          "bf16": "bf16", "bfloat16": "bf16",
          "fp32": None, "float32": None, "": None, "none": None}


def resolve_kv_dtype(value=None):
    """Canonical storage mode: ``"bf16"`` or ``None`` (the pool keeps
    the model's dtype).  Unknown names raise; ``"fp8"`` raises
    :class:`NotSupportedError` until the fp8 KV slice lands."""
    v = "" if value is None else str(value).strip().lower()
    if v not in _CANON:
        raise MXNetError(f"kv_dtype={value!r}: expected fp8|bf16|fp32")
    mode = _CANON[v]
    if mode == "fp8":
        raise NotSupportedError(
            "kv_dtype='fp8' (e4m3 codes with per-row scales) is not ported "
            "yet: it arrives with the fp8 path of the paged decode kernel")
    return mode


def kv_pool_dtype(kv_dtype, model_dtype=torch.float32):
    """The pool storage dtype for a resolved mode."""
    return torch.bfloat16 if kv_dtype == "bf16" else model_dtype


def kv_cast(x, dtype):
    """Storage cast: identity when ``x`` already has ``dtype``."""
    return x if x.dtype == dtype else x.to(dtype)


def kv_dequantize(codes):
    """Back to f32 for the attention math (a plain widening cast)."""
    return codes.float()
