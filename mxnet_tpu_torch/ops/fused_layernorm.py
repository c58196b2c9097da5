"""Fused LayerNorm + residual (+ dropout): CUDA kernels for Hopper and
their plain versions.

Counterpart of ``mxnet_tpu/ops/fused_layernorm.py``.  The op computes
``LayerNorm(dropout(x) + residual) * gamma + beta`` over the last axis
with f32 row statistics (two-pass variance) and returns x's dtype.  The
TPU kernels ``_forward_kernel`` and ``_backward_kernel`` become
``csrc/fused_layernorm.cu``; the plain PyTorch versions are ports of the
reference's ``_fallback_forward`` and ``_fallback_backward``.

Forward and backward are one ``torch.autograd.Function`` (``_FusedLN``,
the counterpart of the reference's ``_fused_ln`` custom VJP): it saves
x, the residual and gamma, never the statistics, and the backward
recomputes them.  The residual's gradient is dx cast to its dtype.
Routing is by device: CPU tensors run the plain versions, CUDA tensors
launch the kernels (counted in ``fused_layer_norm_fwd.launches`` and
``fused_layer_norm_bwd.launches``) or raise on what the kernels do not
take (dtypes other than f32/bf16, D above 8192).

Two deliberate differences from the reference: ``dropout`` draws its
mask from a ``torch.Generator`` (other bits than JAX's keys), and, with
no MXNet autograd tape in the port, ``training=None`` means
``torch.is_grad_enabled()``.

Kernel notes: the forward replaces ``_forward_kernel``
(``fused_layernorm.py:79``), the backward ``_backward_kernel`` (``:97``).
Both are memory-bound on the H100: the forward moves x, res and y, the
backward x, res, dy and dx, at about 10 FLOPs per element.  Both give a
row to a group of ``ceil(D / 1024)`` warps (rounded up to a power of
two) that hold it in registers.  The forward runs a plain grid, a CTA
per ``8 / warps`` rows (:func:`fwd_plan`), each CTA reading gamma and
beta once; the backward a persistent grid of as many CTAs as are
resident on the card (:func:`bwd_plan`), each writing one row of partial
dgamma/dbeta sums, which a second grid adds in a fixed order (no float
atomics).  Both are bitwise repeatable.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError, NotSupportedError
from . import _build

__all__ = ["fused_layer_norm", "fused_layer_norm_fwd", "fused_layer_norm_bwd",
           "layer_norm_plain", "layer_norm_bwd_plain", "fwd_plan", "bwd_plan",
           "MAX_D"]

#: longest normalized axis the kernels take (8 warps a CTA, 32 columns a
#: lane)
MAX_D = 8192
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROW_WARPS = 8           # warps a CTA of either row kernel
_WARP_COLS = 1024        # columns a warp holds in registers

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_layer_norm_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             ctypes.c_float, _I, _P],
    "fused_layer_norm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, ctypes.c_float, _I, _P],
    "fused_layer_norm_resident": [_I, _I, _I, _I, _I, _I, _I]}
# (backward, vector, D, WPR, dtype, g_dtype, device) -> CTAs a SM of the
# backward's row kernel
_resident = {}


def fwd_plan(rows, d):
    """``(warps a row, CTAs)`` of the forward's row kernel: a row of
    ``d`` columns goes to the fewest warps, a power of two, whose lanes
    hold 32 columns each; the grid is plain, one CTA of 8 warps for
    every ``8 / warps`` rows.  The kernel takes both from here (its C
    entry refuses warps that cannot hold the row)."""
    wpr = _warps_per_row(d)
    return wpr, -(-rows // (_ROW_WARPS // wpr))


def bwd_plan(rows, d, sms, resident):
    """``(warps a row, CTAs)`` of the backward's row kernel: the
    forward's warps a row; the grid is persistent, ``sms * resident``
    CTAs of 8 warps, or fewer where the rows do not fill them.  The
    kernel takes both from here (its C entry refuses warps that cannot
    hold the row)."""
    wpr, ctas = fwd_plan(rows, d)
    return wpr, max(1, min(sms * resident, ctas))


def _warps_per_row(d):
    wpr = 1
    while wpr * _WARP_COLS < d:
        wpr *= 2
    return wpr


def _stats(x, res, eps):
    h = x.float()
    if res is not None:
        h = h + res.float()
    mean = h.mean(dim=-1, keepdim=True)
    var = (h - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (h - mean) * rstd, rstd


def layer_norm_plain(x, res, gamma, beta, eps):
    """Plain PyTorch version (the reference's ``_fallback_forward``)."""
    xhat, _ = _stats(x, res, eps)
    return (xhat * gamma.float() + beta.float()).to(x.dtype)


def layer_norm_bwd_plain(x, res, gamma, dy, eps):
    """Plain PyTorch version (the reference's ``_fallback_backward``):
    ``(dx in x's dtype, dgamma f32, dbeta f32)``."""
    xhat, rstd = _stats(x, res, eps)
    dyf = dy.float()
    a = dyf * gamma.float()
    c1 = (a * xhat).mean(dim=-1, keepdim=True)
    c2 = a.mean(dim=-1, keepdim=True)
    dx = ((a - c2 - xhat * c1) * rstd).to(x.dtype)
    d = x.shape[-1]
    return dx, (dyf * xhat).reshape(-1, d).sum(0), dyf.reshape(-1, d).sum(0)


def _check(what, x, res, gamma, other):
    """What the kernels take: contiguous (..., D) f32/bf16 rows with
    1 <= D <= MAX_D, a residual of x's shape and dtype, gamma and its
    partner (beta or dy's row) on one device."""
    d = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPES or gamma.dtype not in _DTYPES:
        raise NotSupportedError(f"{what}: x {x.dtype}, gamma {gamma.dtype} "
                                "(f32, bf16)")
    if not 1 <= d <= MAX_D:
        raise NotSupportedError(f"{what}: normalized axis {d} (1..{MAX_D})")
    if res is not None and (res.shape != x.shape or res.dtype != x.dtype):
        raise NotSupportedError(f"{what}: residual {res.dtype} "
                                f"{tuple(res.shape)} must match x {x.dtype} "
                                f"{tuple(x.shape)}")
    if gamma.shape != (d,):
        raise MXNetError(f"{what}: gamma {tuple(gamma.shape)}, want ({d},)")
    tensors = [t for t in (x, res, gamma, *other) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise MXNetError(f"{what}: inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError(f"{what}: inputs must be contiguous")
    return x.numel() // d, d


def _ptr(t):
    return None if t is None else t.data_ptr()


def _vector(d, tensors):
    """1 where the row kernels take 16-byte loads and stores: a row is a
    multiple of 16 bytes and every tensor starts on a 16-byte boundary
    (else 0: their scalar instantiations)."""
    return int(d * tensors[0].element_size() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors if t is not None))


def _fwd_kernel(x, res, gamma, beta, eps):
    rows, d = _check("fused_layer_norm_fwd", x, res, gamma, (beta,))
    if beta.shape != gamma.shape or beta.dtype != gamma.dtype:
        raise NotSupportedError("fused_layer_norm_fwd: beta must match "
                                "gamma's shape and dtype")
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _build.load("fused_layernorm", _SIGNATURES)
    wpr, ctas = fwd_plan(rows, d)
    vector = _vector(d, (x, res, y))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_layer_norm_fwd(
        x.data_ptr(), _ptr(res), gamma.data_ptr(), beta.data_ptr(),
        y.data_ptr(), rows, d, wpr, ctas, vector, _DTYPES[x.dtype],
        _DTYPES[gamma.dtype], float(eps), x.device.index, stream)
    _build.check(lib, err, "fused_layer_norm_fwd")
    fused_layer_norm_fwd.launches += 1
    return y


def _bwd_kernel(x, res, gamma, dy, eps):
    rows, d = _check("fused_layer_norm_bwd", x, res, gamma, (dy,))
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise NotSupportedError("fused_layer_norm_bwd: dy must match x's "
                                "shape and dtype")
    dx = torch.empty_like(x)
    if rows == 0:
        zeros = torch.zeros(d, dtype=torch.float32, device=x.device)
        return dx, zeros, zeros.clone()
    dgamma = torch.empty(d, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(d, dtype=torch.float32, device=x.device)
    lib = _build.load("fused_layernorm", _SIGNATURES)
    vector = _vector(d, (x, res, dy, dx))
    wpr = _warps_per_row(d)
    key = (1, vector, d, wpr, _DTYPES[x.dtype], _DTYPES[gamma.dtype],
           x.device.index)
    if key not in _resident:
        got = lib.fused_layer_norm_resident(*key)
        _build.check(lib, max(0, -got), "fused_layer_norm_resident")
        if got < 1:
            raise MXNetError(f"fused_layer_norm_bwd: no CTA of the row "
                             f"kernel fits a SM at D={d}")
        _resident[key] = got
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _, ctas = bwd_plan(rows, d, sms, _resident[key])
    ws = torch.empty(2, ctas, d, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_layer_norm_bwd(
        x.data_ptr(), _ptr(res), gamma.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), ws.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        rows, d, wpr, ctas, vector, _DTYPES[x.dtype], _DTYPES[gamma.dtype],
        float(eps), x.device.index, stream)
    _build.check(lib, err, "fused_layer_norm_bwd")
    fused_layer_norm_bwd.launches += 1
    return dx, dgamma, dbeta


def _route(x, plain, kernel, *args):
    if x.device.type == "cpu":
        return plain(*args)
    if x.device.type == "cuda":
        return kernel(*args)
    raise MXNetError(f"fused_layer_norm: unsupported device {x.device}")


def fused_layer_norm_fwd(x, res, gamma, beta, eps):
    """``LayerNorm(x [+ res]) * gamma + beta`` over the last axis, not
    differentiable.  CPU tensors run :func:`layer_norm_plain`; CUDA
    tensors launch the kernel and count one launch in
    ``fused_layer_norm_fwd.launches``."""
    return _route(x, layer_norm_plain, _fwd_kernel, x, res, gamma, beta,
                  eps)


fused_layer_norm_fwd.launches = 0


def fused_layer_norm_bwd(x, res, gamma, dy, eps):
    """``(dx, dgamma, dbeta)`` of the forward at ``(x, res, gamma)`` for
    the output gradient ``dy``; dgamma and dbeta in f32.  CPU tensors run
    :func:`layer_norm_bwd_plain`; CUDA tensors launch the kernel (a row
    grid and a column grid) and count one launch in
    ``fused_layer_norm_bwd.launches``."""
    return _route(x, layer_norm_bwd_plain, _bwd_kernel, x, res, gamma, dy,
                  eps)


fused_layer_norm_bwd.launches = 0


class _FusedLN(torch.autograd.Function):
    """Counterpart of the reference's ``_fused_ln`` custom VJP: saves x,
    res and gamma, recomputes the statistics in the backward."""

    @staticmethod
    def forward(ctx, x, res, gamma, beta, eps):
        ctx.save_for_backward(x, res, gamma)
        ctx.eps, ctx.beta_dtype = eps, beta.dtype
        return fused_layer_norm_fwd(x, res, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, res, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = fused_layer_norm_bwd(x, res, gamma,
                                                 dy.contiguous(), ctx.eps)
        dres = None if res is None else dx.to(res.dtype)
        return (dx, dres, dgamma.to(gamma.dtype), dbeta.to(ctx.beta_dtype),
                None)


def fused_layer_norm(x, gamma, beta, residual=None, eps=1e-5, dropout=0.0,
                     training=None, generator=None):
    """``LayerNorm(dropout(x) + residual) * gamma + beta`` in one fused
    pass over the activation (last-axis normalization, f32 statistics).

    ``x``: (..., D); ``gamma``/``beta``: (D,); ``residual``: optional
    (..., D) added before normalization (the transformer post-sublayer
    shape).  ``dropout`` > 0 applies inverted dropout to ``x`` before the
    residual add when ``training`` (default: ``torch.is_grad_enabled()``),
    with its mask drawn from ``generator``.  Differentiable through the
    fused backward.  On CUDA tensors the kernels run; on CPU tensors
    their plain versions.
    """
    if x.dim() < 1 or tuple(gamma.shape) != (x.shape[-1],) \
            or tuple(beta.shape) != (x.shape[-1],):
        raise ValueError(
            f"fused_layer_norm: x (..., D) with gamma/beta (D,); got x "
            f"{tuple(x.shape)}, gamma {tuple(gamma.shape)}, beta "
            f"{tuple(beta.shape)}")
    if training is None:
        training = torch.is_grad_enabled()
    rate = float(dropout)
    if rate > 0.0 and training:
        keep = 1.0 - rate
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        x = torch.where(mask, x / keep, 0.0).to(x.dtype)
    return _FusedLN.apply(
        x.contiguous(), None if residual is None else residual.contiguous(),
        gamma.contiguous(), beta.contiguous(), float(eps))
