"""int8 products for weight-quantized serving: the serving half of
``mxnet_tpu/ops/quant_matmul.py``.

- :func:`quantize_rtn_int8` is the reference's round-to-nearest
  activation (and weight) quantization at a fixed, calibrated scale:
  ``x / scale`` in float32, rounded half to even, clipped to +-127.
- :func:`dequantize_int8` widens codes back: ``codes * scale`` in f32.
- :func:`int8_matmul` is the int8 x int8 -> int32 product
  ``qx @ qw.T`` of a ``QuantizedDense`` and of the engine's int8
  projections.  The reference computes it in XLA
  (``lax.dot_general(..., preferred_element_type=int32)``), outside any
  Pallas kernel, so it is a plain matrix product here too, as
  ``torch.matmul`` is for the float projections: on the card cuBLASLt's
  ``torch._int_mm``, on the CPU an exact int32 product (its plain
  version).

``torch._int_mm`` takes more than 16 rows, and K and N multiples of 8,
with the weight as the transpose of a contiguous ``(N, K)`` tensor.  A
product of at most 16 rows (a decode step) is padded with zero rows,
which is exact: the accumulation is int32.  K or N not a multiple of 8
raises ``MXNetError`` on the card; no float product stands in for an
int8 one.  The call is legal under CUDA-graph capture (the engine's
steps are captured).

The training side of the reference module (stochastic-rounding int8 and
fp8 ``quant_matmul``) arrives with ROADMAP §1 item 8.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["INT8_MAX", "quantize_rtn_int8", "dequantize_int8",
           "int8_matmul"]

INT8_MAX = 127
_MIN_ROWS = 17            # torch._int_mm takes more than 16 rows


def quantize_rtn_int8(x, scale):
    """Round-to-nearest int8 codes of ``x`` at a fixed ``scale`` (a
    float or an f32 tensor that broadcasts against ``x``): the division
    in f32, round half to even, clip to +-127."""
    if not torch.is_tensor(scale):
        scale = torch.tensor(scale, dtype=torch.float32, device=x.device)
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8)


def dequantize_int8(codes, scale):
    """``codes * scale`` in f32."""
    return codes.to(torch.float32) * scale


def int8_matmul(qx, qw):
    """``qx @ qw.T`` with int32 accumulation: ``qx`` (M, K) int8, ``qw``
    (N, K) int8 (a Dense weight's layout); returns (M, N) int32.  CPU
    tensors take the exact int32 product; CUDA tensors cuBLASLt's int8
    GEMM (``torch._int_mm``), with M padded past 16 rows."""
    if qx.dim() != 2 or qw.dim() != 2 or qx.shape[1] != qw.shape[1]:
        raise MXNetError(f"int8_matmul: qx {tuple(qx.shape)} against qw "
                         f"{tuple(qw.shape)} (M, K) x (N, K)")
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise MXNetError(f"int8_matmul: int8 operands, got {qx.dtype} and "
                         f"{qw.dtype}")
    if qx.device != qw.device:
        raise MXNetError("int8_matmul: operands on one device")
    if qx.device.type == "cpu":
        return torch.matmul(qx.to(torch.int32), qw.to(torch.int32).T)
    if qx.device.type != "cuda":
        raise MXNetError(f"int8_matmul: unsupported device {qx.device}")
    M, K = qx.shape
    N = qw.shape[0]
    if K % 8 or N % 8:
        raise MXNetError(f"int8_matmul on the card: K={K} and N={N} must be "
                         "multiples of 8 (cuBLASLt's int8 GEMM)")
    if not qw.is_contiguous():
        raise MXNetError("int8_matmul on the card: the weight must be a "
                         "contiguous (N, K) tensor")
    rows = M if M >= _MIN_ROWS else _MIN_ROWS
    rows += -rows % 8
    a = qx.contiguous() if rows == M else F.pad(qx, (0, 0, 0, rows - M))
    out = torch._int_mm(a, qw.t())
    return out if rows == M else out[:M]
