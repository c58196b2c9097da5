"""Flash attention forward: a CUDA kernel for Hopper and its plain version.

Counterpart of ``mxnet_tpu/ops/flash_attention.py``.  The TPU kernel
(``_pallas_forward``) becomes ``csrc/flash_attention.cu``; the plain
PyTorch version is a port of the blockwise ``_scan_forward`` and returns
the same ``(out, lse)``.  Layout of the public op: ``(B, H, L, D)``.

Routing is by device and nothing else: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel (or raises on what the kernel
does not take).  There is no fallback from one to the other.

Kernel note: replaces ``_pallas_forward`` (``flash_attention.py:51``).
At the serving shapes (H=32, D=128, L up to 1024, causal) a layer moves
about 32 MB (q, k, v in, out and lse out) against about 8.6 GFLOP of
score and PV products; see the source for what the first version is
bound by.  Only the forward is ported: the backward (``_scan_backward``)
belongs to the training slice.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError, NotSupportedError
from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_plain"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _I, ctypes.c_float, _I, _P]}


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


def flash_attention_plain(q, k, v, causal, sm_scale, bk=None):
    """Plain PyTorch version: the reference's ``_scan_forward`` on
    ``(BH, L, D)`` -- a loop over ``bk``-column KV blocks with f32 scores,
    running max and denominator, and ``p`` rounded to the value dtype
    before the PV product.  Returns ``(out, lse)``."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    if bk is None:
        bk = _pick_block(lk, 256) or lk
    q32 = q.float()
    qpos = torch.arange(lq, device=q.device)[:, None]
    acc = torch.zeros(bh, lq, d, dtype=torch.float32, device=q.device)
    m_i = torch.full((bh, lq, 1), _NEG_INF, dtype=torch.float32,
                     device=q.device)
    l_i = torch.zeros(bh, lq, 1, dtype=torch.float32, device=q.device)
    for j in range(lk // bk):
        kj = k[:, j * bk:(j + 1) * bk].float()
        vj = v[:, j * bk:(j + 1) * bk]
        s = torch.einsum("bqd,bkd->bqk", q32, kj) * sm_scale
        if causal:
            kpos = j * bk + torch.arange(bk, device=q.device)[None, :]
            s = torch.where((qpos >= kpos)[None], s, _NEG_INF)
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


def _kernel(q, k, v, causal, sm_scale):
    if q.dtype not in _DTYPES:
        raise NotSupportedError(f"flash kernel: dtype {q.dtype} (f32, bf16)")
    if not (k.dtype == v.dtype == q.dtype):
        raise MXNetError("flash kernel: q, k, v must share one dtype")
    if not (k.device == v.device == q.device):
        raise MXNetError("flash kernel: q, k, v must be on one device")
    bh, lq, d = q.shape
    lk = k.shape[1]
    if k.shape != (bh, lk, d) or v.shape != k.shape:
        raise MXNetError(f"flash kernel: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if d not in _HEAD_DIMS:
        raise NotSupportedError(f"flash kernel: head_dim {d} (64, 128)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise MXNetError("flash kernel: inputs must be contiguous")
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
        lse.data_ptr(), bh, lq, lk, d, _DTYPES[q.dtype], int(bool(causal)),
        float(sm_scale), q.device.index, stream)
    _build.check(lib, err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None):
    """Attention forward on ``(BH, L, D)``: ``(out, lse)``.  CPU tensors
    run :func:`flash_attention_plain`; CUDA tensors launch the kernel
    and count one launch in ``flash_attention_fwd.launches``."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None \
        else float(sm_scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bool(causal), scale)
    if q.device.type == "cuda":
        return _kernel(q, k, v, causal, scale)
    raise MXNetError(f"flash_attention: unsupported device {q.device}")


flash_attention_fwd.launches = 0


def flash_attention(query, key, value, causal=False, sm_scale=None):
    """softmax(QK^T * sm_scale [+ causal mask]) V without materialising
    the score matrix.  query/key/value: ``(B, H, L, D)`` tensors."""
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
