"""Scaled low-precision products: serving's int8 and training's int8
and fp8.  Counterpart of ``mxnet_tpu/ops/quant_matmul.py``.

Serving (weight-quantized engines, ``QuantizedDense``):

- :func:`quantize_rtn_int8` is the reference's round-to-nearest
  activation (and weight) quantization at a fixed, calibrated scale:
  ``x / scale`` in float32, rounded half to even, clipped to +-127.
- :func:`dequantize_int8` widens codes back: ``codes * scale`` in f32.
- :func:`int8_matmul` is the int8 x int8 -> int32 product
  ``qx @ qw.T`` of a ``QuantizedDense`` and of the engine's int8
  projections: on the card cuBLASLt's ``torch._int_mm``, on the CPU an
  exact int32 product (its plain version).  ``torch._int_mm`` takes more
  than 16 rows, and K and N multiples of 8, with the weight as the
  transpose of a contiguous ``(N, K)`` tensor.  A product of at most 16
  rows (a decode step) is padded with zero rows, which is exact; K or N
  not a multiple of 8 raises ``MXNetError`` on the card.

Training (:func:`quant_matmul`, the seam of ``nd.FullyConnected`` and
``gluon.nn.Dense`` with ``compute_dtype``):

- **int8**: per-tensor amax scales (``amax / 127``), the unbiased
  stochastic rounding ``floor(x / scale + u)`` with ``u ~ U[0, 1)``,
  int32 accumulation (exact), the rescale in f32.  ``u`` comes from the
  operand's device generator (``nd.random.generator``), which every
  captured graph registers, so replays draw fresh noise.  The reference
  folds its noise key from the bits of the operand's sum; the port
  cannot reproduce those bits, so the distribution is the reference's
  and the bits are not.  ``uniform=`` takes a function ``(operand,
  salt) -> u`` instead (the salts are the reference's: 0 for the left
  operand, 1 for the right), which is how a test feeds it the
  reference's own draw.
- **fp8**: e4m3 operands (max 448) in the forward, e5m2 (max 57344) on
  the gradient side, per-tensor amax scales, round to nearest, f32
  accumulation.
- The backward (``torch.autograd.Function``) is the reference's
  straight-through estimator with quantized gradient-side products:
  ``da = q(dy) @ q(b.T)`` and ``db = q(a.T) @ q(dy)``.
- Tags in :func:`bf16_fallback_tags` (``"head"``, ``"logits"`` and the
  caller's ``bf16_tags``) compute bf16 operands with f32 accumulation
  and plain autodiff instead.
- :func:`init_delayed_state` / :func:`quant_matmul_delayed`: scales
  from an amax history (forward only, the state a dict of tensors).

The products are plain large matrix products, which the reference
computes in XLA (``lax.dot_general(..., preferred_element_type=...)``)
outside any Pallas kernel, so they are library GEMMs on the card, with
exact padding where cuBLASLt wants aligned shapes:

- int8: ``torch._int_mm`` (M past 16 rows, M, K and N to multiples of
  8), padded with zeros;
- fp8 e4m3 x e4m3: ``torch._scaled_mm`` with the two scales as its f32
  scale tensors (M, K and N to multiples of 16; the right operand
  column-major);
- fp8 e5m2 x e5m2 (both gradient-side products), which cuBLASLt's fp8
  GEMM does not take on sm_90: the codes widened to bfloat16, which
  holds every e5m2 value exactly, and ``torch.mm(..., out_dtype=
  torch.float32)``, so the accumulation and the output stay f32.

On the CPU each product is its plain version: the codes widened (int32
for int8, f32 for fp8) and multiplied exactly or in f32.  Every step
stays on the device with no host read, so a CUDA graph holds it; a
failed library call raises.  The compute dtype is an argument: nothing
here reads an environment variable.  The reference's telemetry gauges
(``quant.amax.*``, ``quant.overflow_pct.*``) wait for ``telemetry/``
(ROADMAP §1 item 11) and are not published.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["quant_matmul", "resolve_compute_dtype",
           "quantize_sr_int8", "dequantize_int8", "quantize_rtn_int8",
           "bf16_fallback_tags", "init_delayed_state",
           "quant_matmul_delayed", "INT8_MAX", "FP8_MAX",
           "FP8_GRAD_MAX", "int8_matmul"]

INT8_MAX = 127
FP8_MAX = 448.0           # float8_e4m3fn's largest normal (forward)
FP8_GRAD_MAX = 57344.0    # float8_e5m2's largest normal (gradient side)
_MIN_ROWS = 17            # torch._int_mm takes more than 16 rows

#: tags whose products compute in bf16 (numerically fragile heads)
_DEFAULT_BF16_TAGS = frozenset({"head", "logits"})


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


# ---------------------------------------------------------------------------
# training: settings
# ---------------------------------------------------------------------------

def resolve_compute_dtype(value=None):
    """The training compute mode of ``value``: ``"int8"``, ``"fp8"`` or
    None (the plain product).  The reference's spellings; None, ``""``,
    ``"0"``, ``"off"``, ``"none"``, ``"fp32"`` and ``"float32"`` are off.
    Anything else raises: a typo must not train at full width."""
    if value is None:
        return None
    v = str(value).strip().lower()
    if v in ("", "0", "off", "none", "fp32", "float32"):
        return None
    if v in ("int8", "i8"):
        return "int8"
    if v in ("fp8", "float8", "float8_e4m3fn"):
        return "fp8"
    raise MXNetError(f"compute_dtype={value!r}: expected int8|fp8|fp32")


def bf16_fallback_tags(extra=()):
    """Tags whose products compute in bf16 instead of 8 bits: the
    reference's defaults (``"head"``, ``"logits"``) and ``extra`` (an
    iterable of tags, or one comma-separated string)."""
    if isinstance(extra, str):
        extra = extra.split(",")
    return frozenset(_DEFAULT_BF16_TAGS |
                     {t.strip() for t in extra if t.strip()})


# ---------------------------------------------------------------------------
# training: stochastic rounding
# ---------------------------------------------------------------------------

def _device_uniform(x, salt):
    """``u ~ U[0, 1)`` of ``x``'s shape in f32, from the device's
    generator (the one captured graphs register)."""
    from ..ndarray import random as _rnd
    return torch.rand(x.shape, dtype=torch.float32, device=x.device,
                      generator=_rnd.generator(x.device))


def _sr_cast_int8(v, u):
    """``floor(v + u)`` clipped to +-127, as int8: the unbiased
    stochastic round of the pre-scaled ``v`` at the draw ``u``."""
    return torch.clamp(torch.floor(v + u), -INT8_MAX, INT8_MAX) \
        .to(torch.int8)


def _div(x, q):
    """``x / q`` for the host number ``q`` as a true division: on the card
    PyTorch multiplies by the reciprocal of a host scalar, an ulp off the
    quotient the CPU and the reference take."""
    return x / x.new_full((), q)


def quantize_sr_int8(flat, u=None):
    """``(codes int8, scale f32)``: the stochastic-rounding quantization
    of ``flat`` at its per-tensor amax scale, at the draw ``u`` (None:
    one from the device's generator).  Unbiased: the mean of
    ``dequantize_int8(*quantize_sr_int8(x))`` over draws is ``x``."""
    scale = torch.clamp_min(_div(flat.abs().amax(), float(INT8_MAX)), 1e-30)
    v = flat / scale
    return _sr_cast_int8(v, _device_uniform(v, 0) if u is None else u), \
        scale


# ---------------------------------------------------------------------------
# training: the products
# ---------------------------------------------------------------------------

def _amax_scale(x, qmax):
    """The per-tensor scale ``max(amax / qmax, 1e-30)``, taken in ``x``'s
    dtype and widened to f32 after (the reference's order)."""
    return torch.clamp_min(_div(x.abs().amax(), qmax), 1e-30).float()


def _pad_to(x, rows, cols):
    """``x`` padded with zeros to ``(rows, cols)`` (itself when it fits;
    a zero fill and a copy, which fp8 tensors take on the card)."""
    r, c = x.shape
    if (r, c) == (rows, cols):
        return x
    out = x.new_zeros((rows, cols))
    out[:r, :c] = x
    return out


def _round_up(n, m):
    return n + (-n % m)


def _col_major(x):
    """``x`` (K, N) laid out column-major (a transposed contiguous
    tensor), as cuBLASLt's int8 and fp8 GEMMs take the right operand."""
    return x if x.stride(0) == 1 and x.stride(1) == x.shape[0] \
        else x.t().contiguous().t()


def _int8_product(qa, qb):
    """``qa @ qb`` (int8, (M, K) @ (K, N)) with int32 accumulation: the
    exact int32 product on the CPU, ``torch._int_mm`` on the card with
    M, K and N padded with zeros (M past 16 rows)."""
    if qa.device.type == "cpu":
        return torch.matmul(qa.to(torch.int32), qb.to(torch.int32))
    M, K = qa.shape
    N = qb.shape[1]
    rows = _round_up(max(M, _MIN_ROWS), 8)
    k, n = _round_up(K, 8), _round_up(N, 8)
    out = torch._int_mm(_pad_to(qa, rows, k).contiguous(),
                        _col_major(_pad_to(qb, k, n)))
    return out if (rows, n) == (M, N) else out[:M, :N]


def _fp8_product(qa, qb, sa, sb):
    """``(qa @ qb) * (sa * sb)`` in f32 for fp8 codes.  On the CPU the
    codes widen to f32 (exact) for an f32 product.  On the card e4m3 x
    e4m3 runs ``torch._scaled_mm`` with the scales as its scale tensors;
    e5m2 x e5m2, which it does not take, widens the codes to bfloat16
    (exact) for ``torch.mm`` with an f32 output.  M, K and N are padded
    with zeros to multiples of 16."""
    if qa.device.type == "cpu":
        return torch.matmul(qa.float(), qb.float()) * (sa * sb)
    M, K = qa.shape
    N = qb.shape[1]
    m, k, n = _round_up(M, 16), _round_up(K, 16), _round_up(N, 16)
    a = _pad_to(qa, m, k)
    b = _pad_to(qb, k, n)
    if qa.dtype == torch.float8_e4m3fn and qb.dtype == torch.float8_e4m3fn:
        out = torch._scaled_mm(a.contiguous(), _col_major(b), scale_a=sa,
                               scale_b=sb, out_dtype=torch.float32)
    else:
        out = torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                       out_dtype=torch.float32) * (sa * sb)
    return out if (m, n) == (M, N) else out[:M, :N]


def _qmm_impl(a, b, mode, uniform, grad_side=False, scales=None):
    """One quantized (M, K) @ (K, N) product in f32: both operands at
    their per-tensor amax scales (or the given ``scales`` ``(sa, sb)``),
    the wide product, the rescale.  ``grad_side`` switches fp8 to e5m2
    (range over precision)."""
    if mode == "int8":
        sa, sb = scales or (_amax_scale(a, float(INT8_MAX)),
                            _amax_scale(b, float(INT8_MAX)))
        qa = _sr_cast_int8(a.float() / sa, uniform(a, 0))
        qb = _sr_cast_int8(b.float() / sb, uniform(b, 1))
        return _int8_product(qa, qb).float() * (sa * sb)
    qmax = FP8_GRAD_MAX if grad_side else FP8_MAX
    fp8 = torch.float8_e5m2 if grad_side else torch.float8_e4m3fn
    sa, sb = scales or (_amax_scale(a, qmax), _amax_scale(b, qmax))
    qa = torch.clamp(a.float() / sa, -qmax, qmax).to(fp8)
    qb = torch.clamp(b.float() / sb, -qmax, qmax).to(fp8)
    return _fp8_product(qa, qb, sa, sb)


class _QuantMatmul(torch.autograd.Function):
    """The quantized product with the reference's straight-through
    backward: both gradient-side products quantized too."""

    @staticmethod
    def forward(ctx, a, b, mode, uniform):
        ctx.save_for_backward(a, b)
        ctx.mode, ctx.uniform = mode, uniform
        return _qmm_impl(a, b, mode, uniform)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _qmm_impl(dy, b.t(), ctx.mode, ctx.uniform, grad_side=True)
        if ctx.needs_input_grad[1]:
            db = _qmm_impl(a.t(), dy, ctx.mode, ctx.uniform, grad_side=True)
        return da, db, None, None


def quant_matmul(a, b, compute_dtype=None, tag="mm", bf16_tags=(),
                 uniform=None):
    """``a @ b`` through the scaled low-precision path.

    ``a`` (..., K), its leading axes flattened for the product and
    restored after (per-tensor scales make that exact); ``b`` (K, N).
    ``compute_dtype`` ``"int8"``/``"fp8"`` (the reference's spellings,
    :func:`resolve_compute_dtype`) or None, the plain ``torch.matmul``.
    ``tag`` names the call site: a tag in :func:`bf16_fallback_tags`
    ``(bf16_tags)`` computes bf16 operands with f32 accumulation.
    ``uniform(operand, salt) -> u`` replaces the device generator's int8
    draws.  The quantized result is f32, as in the reference."""
    mode = resolve_compute_dtype(compute_dtype)
    if mode is None:
        return torch.matmul(a, b)
    if b.dim() != 2:
        raise MXNetError(f"quant_matmul: b must be 2D (K, N), got "
                         f"{tuple(b.shape)}")
    lead = a.shape[:-1]
    flat = a.reshape(-1, a.shape[-1])
    if tag in bf16_fallback_tags(bf16_tags):
        y = torch.matmul(flat.to(torch.bfloat16).float(),
                         b.to(torch.bfloat16).float())
    else:
        y = _QuantMatmul.apply(flat, b, mode, uniform or _device_uniform)
    return y.reshape(*lead, b.shape[1])


# ---------------------------------------------------------------------------
# delayed (amax-history) scaling: the threaded-state variant
# ---------------------------------------------------------------------------

def init_delayed_state(history=16, device="cpu"):
    """A fresh amax history for one :func:`quant_matmul_delayed` site on
    ``device``: a window per operand, zeros meaning no history yet (the
    first step scales from the current amax)."""
    if history < 1:
        raise MXNetError(f"history {history} must be >= 1")
    return {"a": torch.zeros(history, dtype=torch.float32, device=device),
            "b": torch.zeros(history, dtype=torch.float32, device=device)}


def _delayed_scale(hist, cur_amax, qmax):
    h = hist.amax()
    amax = torch.where(h > 0, h, cur_amax)
    return torch.clamp_min(_div(amax, qmax), 1e-30)


def quant_matmul_delayed(a, b, state, compute_dtype=None, tag="mm",
                         uniform=None):
    """``(y, new_state)``: the product at scales from the amax history
    (its max over the window) rather than this step's tensors, the
    FP8-LM recipe; a stale scale clips.  Forward only (no gradient
    through the rounding).  2D operands."""
    mode = resolve_compute_dtype(compute_dtype)
    if mode is None:
        return torch.matmul(a, b), state
    if a.dim() != 2 or b.dim() != 2:
        raise MXNetError("quant_matmul_delayed operates on 2D operands")
    uniform = uniform or _device_uniform
    qmax = float(INT8_MAX) if mode == "int8" else FP8_MAX
    cur_a = a.abs().amax().float()
    cur_b = b.abs().amax().float()
    sa = _delayed_scale(state["a"], cur_a, qmax)
    sb = _delayed_scale(state["b"], cur_b, qmax)
    with torch.no_grad():
        y = _qmm_impl(a, b, mode, uniform, scales=(sa, sb))
    new_state = {k: torch.cat([cur.reshape(1), state[k][:-1]])
                 for k, cur in (("a", cur_a), ("b", cur_b))}
    return y, new_state
