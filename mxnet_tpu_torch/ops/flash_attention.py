"""Flash attention, forward and backward: CUDA kernels for Hopper and
their plain versions.

Counterpart of ``mxnet_tpu/ops/flash_attention.py``.  The TPU kernel
(``_pallas_forward``) becomes ``csrc/flash_attention.cu``; the
reference's backward, the XLA ``_scan_backward``, becomes
``csrc/flash_attention_bwd.cu``.  The plain PyTorch versions are ports
of the blockwise ``_scan_forward`` and ``_scan_backward``.  Layout of the
public op: ``(B, H, L, D)``.

Forward and backward are one ``torch.autograd.Function`` (the
counterpart of the reference's ``_flash`` custom VJP): the forward saves
``q, k, v, out, lse`` and the backward recomputes the scores from the
saved logsumexp.  Routing is by device and nothing else: CPU tensors run
the plain versions, CUDA tensors launch the kernels (or raise on what
the kernels do not take).  There is no fallback from one to the other.

Kernel notes: the forward replaces ``_pallas_forward``
(``flash_attention.py:51``); at the serving shapes (H=32, D=128, L up
to 1024, causal) a layer moves about 32 MB against about 8.6 GFLOP of
score and PV products.  The backward replaces ``_scan_backward``
(``:174``) and does five such products (two recomputed, three for the
gradients) against q, k, v, out, g, lse in and dq, dk, dv out.  Both
run their products on the tensor cores.  In bf16 through ``wgmma``, with
bf16 tiles in shared memory and the sums in registers; the backward
rounds ``p`` and ``ds`` to bf16 for its three gradient products, where
the plain version keeps them in f32.  In f32 through warp-level
``mma.sync`` as 3xTF32: each f32 operand is split into a big and a small
TF32 part and three products give about f32 accuracy (``p`` and ``ds``
included).  See the sources.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError, NotSupportedError
from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_plain", "flash_attention_bwd_plain"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _I, ctypes.c_float, _I, _P]}
_BWD_SIGNATURES = {"flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                           _P, _I, _I, _I, _I, _I, _I,
                                           ctypes.c_float, _I, _P]}


def _pick_block(n, preferred=512):
    """Largest multiple-of-128 divisor of n up to ``preferred``; None if
    n is not a multiple of 128 (the reference's block choice)."""
    if n % 128:
        return None
    b = min(preferred, n)
    b -= b % 128
    while b >= 128:
        if n % b == 0:
            return b
        b -= 128
    return None


def flash_attention_plain(q, k, v, causal, sm_scale, bk=None, q_start=None):
    """Plain PyTorch version: the reference's ``_scan_forward`` on
    ``(BH, L, D)`` -- a loop over ``bk``-column KV blocks with f32 scores,
    running max and denominator, and ``p`` rounded to the value dtype
    before the PV product.  With ``q_start`` ((BH,) int, the absolute
    position of each row's query 0) query i of row b sees key j when
    ``j <= q_start[b] + i``, whatever ``causal`` says: the reference
    engine's chunk attention (``attend`` in its ``_build_chunk_prefill``),
    with the same blocks.  Returns ``(out, lse)``."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    if bk is None:
        bk = _pick_block(lk, 256) or lk
    q32 = q.float()
    qpos = torch.arange(lq, device=q.device)[None, :, None]  # (1, Lq, 1)
    if q_start is not None:
        causal = True
        qpos = q_start.to(device=q.device, dtype=torch.long)[:, None, None] \
            + qpos                                           # (BH, Lq, 1)
    acc = torch.zeros(bh, lq, d, dtype=torch.float32, device=q.device)
    m_i = torch.full((bh, lq, 1), _NEG_INF, dtype=torch.float32,
                     device=q.device)
    l_i = torch.zeros(bh, lq, 1, dtype=torch.float32, device=q.device)
    for j in range(lk // bk):
        kj = k[:, j * bk:(j + 1) * bk].float()
        vj = v[:, j * bk:(j + 1) * bk]
        s = torch.einsum("bqd,bkd->bqk", q32, kj) * sm_scale
        if causal:
            kpos = j * bk + torch.arange(bk, device=q.device)
            s = torch.where(qpos >= kpos, s, _NEG_INF)
        m_new = torch.maximum(m_i, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m_i - m_new)
        l_i = l_i * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bqk,bkd->bqd", p.to(v.dtype).float(), vj.float())
        m_i = m_new
    denom = torch.clamp_min(l_i, 1e-30)
    out = (acc / denom).to(q.dtype)
    lse = (m_i + torch.log(denom))[..., 0]
    return out, lse


def flash_attention_bwd_plain(q, k, v, out, lse, g, causal, sm_scale,
                              bk=None):
    """Plain PyTorch version of the backward: the reference's
    ``_scan_backward`` on ``(BH, L, D)``.  All math in f32: ``delta =
    rowsum(out * g)``, then per ``bk``-column KV block ``p = exp(s -
    lse)`` (masked, and not rounded to the value dtype), ``dv = p^T g``,
    ``ds = p (dp - delta) scale``, ``dk = ds^T q``, ``dq += ds k``.
    Returns ``(dq, dk, dv)`` in the input dtypes."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    if bk is None:
        bk = _pick_block(lk, 256) or lk
    q32, g32 = q.float(), g.float()
    delta = torch.sum(out.float() * g32, dim=-1, keepdim=True)
    qpos = torch.arange(lq, device=q.device)[:, None]
    dq = torch.zeros(bh, lq, d, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for j in range(lk // bk):
        kj = k[:, j * bk:(j + 1) * bk].float()
        vj = v[:, j * bk:(j + 1) * bk].float()
        s = torch.einsum("bqd,bkd->bqk", q32, kj) * sm_scale
        if causal:
            kpos = j * bk + torch.arange(bk, device=q.device)[None, :]
            s = torch.where((qpos >= kpos)[None], s, _NEG_INF)
        p = torch.exp(s - lse[..., None])
        dvs.append(torch.einsum("bqk,bqd->bkd", p, g32))
        dp = torch.einsum("bqd,bkd->bqk", g32, vj)
        ds = p * (dp - delta) * sm_scale
        dks.append(torch.einsum("bqk,bqd->bkd", ds, q32))
        dq = dq + torch.einsum("bqk,bkd->bqd", ds, kj)
    dk = torch.cat(dks, dim=1) if dks else torch.zeros_like(k, dtype=dq.dtype)
    dv = torch.cat(dvs, dim=1) if dvs else torch.zeros_like(v, dtype=dq.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(what, tensors):
    """Refuse what the kernels do not take: tensors[:3] are q, k, v of
    shapes ``(BH, Lq, D)``, ``(BH, Lk, D)``; every tensor contiguous, on
    one device and 16-byte aligned."""
    q, k, v = tensors[:3]
    if q.dtype not in _DTYPES:
        raise NotSupportedError(
            f"{what}: dtype {q.dtype} (f32, bf16); float16 waits for an "
            "fp16 instantiation of the tensor-core kernels (ROADMAP §2b)")
    if not (k.dtype == v.dtype == q.dtype):
        raise MXNetError(f"{what}: q, k, v must share one dtype")
    if any(t.device != q.device for t in tensors):
        raise MXNetError(f"{what}: inputs must be on one device")
    bh, _, d = q.shape
    lk = k.shape[1]
    if k.shape != (bh, lk, d) or v.shape != k.shape:
        raise MXNetError(f"{what}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if d not in _HEAD_DIMS:
        raise NotSupportedError(f"{what}: head_dim {d} (64, 128)")
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError(f"{what}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):  # the kernels' 16-byte copies
        raise MXNetError(f"{what}: base pointers must be 16-byte aligned")


def _kernel(q, k, v, causal, sm_scale, q_start=None):
    _check("flash kernel", (q, k, v))
    bh, lq, d = q.shape
    lk = k.shape[1]
    if q_start is not None and (
            q_start.shape != (bh,) or q_start.dtype != torch.int32
            or q_start.device != q.device or not q_start.is_contiguous()):
        raise MXNetError("flash kernel: q_start must be a contiguous (BH,) "
                         "int32 tensor on q's device")
    out = torch.empty_like(q)
    lse = torch.empty(bh, lq, dtype=torch.float32, device=q.device)
    if bh == 0 or lq == 0:
        return out, lse
    if lk == 0:
        raise MXNetError("flash kernel: no keys")
    lib = _build.load("flash_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), None if q_start is None else q_start.data_ptr(),
        bh, lq, lk, d, _DTYPES[q.dtype], int(bool(causal)), float(sm_scale),
        q.device.index, stream)
    _build.check(lib, err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention_fwd.launches_bf16 += 1
    if q_start is not None:
        flash_attention_fwd.launches_offset += 1
    return out, lse


def _bwd_kernel(q, k, v, out, lse, g, causal, sm_scale):
    _check("flash backward kernel", (q, k, v, out, lse, g))
    bh, lq, d = q.shape
    lk = k.shape[1]
    if out.shape != q.shape or g.shape != q.shape or \
            lse.shape != (bh, lq) or lse.dtype != torch.float32:
        raise MXNetError("flash backward kernel: out and g must have q's "
                         "shape and lse must be (BH, Lq) f32")
    if out.dtype != q.dtype or g.dtype != q.dtype:
        raise MXNetError("flash backward kernel: out and g must have q's "
                         "dtype")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if bh == 0 or lq == 0 or lk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty(bh, lq, dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), bh, lq, lk, d, _DTYPES[q.dtype],
        int(bool(causal)), float(sm_scale), q.device.index, stream)
    _build.check(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention_bwd.launches_bf16 += 1
    return dq, dk, dv


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None \
        else float(sm_scale)


def _route(q, plain, kernel, *args, **kwargs):
    """The plain version for CPU tensors, the kernel for CUDA ones; with
    autocast off, so that inside an ``amp`` region the plain version's
    f32 products stay f32 (the kernels take the dtype they are given)."""
    if q.device.type not in ("cpu", "cuda"):
        raise MXNetError(f"flash_attention: unsupported device {q.device}")
    with torch.autocast(q.device.type, enabled=False):
        return (plain if q.device.type == "cpu" else kernel)(*args, **kwargs)


class _Flash(torch.autograd.Function):
    """Counterpart of the reference's ``_flash`` custom VJP on ``(BH, L,
    D)``: returns ``(out, lse)``, saves ``q, k, v, out, lse`` and runs
    the backward from the saved logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _route(q, flash_attention_plain, _kernel, q, k, v,
                          causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        # g arrives strided from the caller's transpose; the kernel reads
        # it row-major
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None, q_start=None):
    """Attention forward on ``(BH, L, D)``: ``(out, lse)``, differentiable
    in q, k, v.  CPU tensors run :func:`flash_attention_plain`; CUDA
    tensors launch the kernel and count one launch in
    ``flash_attention_fwd.launches`` (bf16 launches also in
    ``.launches_bf16``).

    ``q_start`` ((BH,) int32 on q's device) gives each row's query 0 an
    absolute position: query i of row b sees key j when ``j <= q_start[b]
    + i`` (the chunked prefill's mask; ``causal`` is then implied).  That
    form is forward only: with autograd recording (grad mode on and an
    input that requires grad) it raises ``NotSupportedError``.  Its
    launches also count in ``.launches_offset``."""
    scale = _scale(q, sm_scale)
    if q_start is None:
        return _Flash.apply(q, k, v, bool(causal), scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotSupportedError(
            "flash_attention_fwd(q_start=...) is forward only: the chunked "
            "prefill runs under no_grad, and no training path needs its "
            "backward")
    return _route(q, flash_attention_plain, _kernel, q, k, v, True, scale,
                  q_start=q_start)


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_bf16 = 0
flash_attention_fwd.launches_offset = 0


def flash_attention_bwd(q, k, v, out, lse, g, causal=False, sm_scale=None):
    """Attention backward on ``(BH, L, D)`` from the forward's ``out``
    and ``lse`` and the output gradient ``g``: ``(dq, dk, dv)``.  CPU
    tensors run :func:`flash_attention_bwd_plain`; CUDA tensors launch
    the kernel (a delta pre-pass, a dK/dV pass and a dQ pass) and count
    one launch in ``flash_attention_bwd.launches`` (bf16 launches also in
    ``.launches_bf16``)."""
    return _route(q, flash_attention_bwd_plain, _bwd_kernel, q, k, v, out,
                  lse, g, bool(causal), _scale(q, sm_scale))


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_bf16 = 0


def flash_attention(query, key, value, causal=False, sm_scale=None):
    """softmax(QK^T * sm_scale [+ causal mask]) V without materialising
    the score matrix.  query/key/value: ``(B, H, L, D)`` tensors;
    differentiable through the flash backward."""
    if query.dim() != 4:
        raise MXNetError("flash_attention expects (B, H, L, D) inputs, "
                         f"got shape {tuple(query.shape)}")
    b, h, lq, d = query.shape
    lk = key.shape[2]
    out, _ = flash_attention_fwd(
        query.reshape(b * h, lq, d).contiguous(),
        key.reshape(b * h, lk, d).contiguous(),
        value.reshape(b * h, lk, d).contiguous(), causal, sm_scale)
    return out.reshape(b, h, lq, d)
