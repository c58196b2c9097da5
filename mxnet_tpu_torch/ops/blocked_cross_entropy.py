"""Fused linear + softmax cross-entropy over vocabulary blocks.

Counterpart of ``mxnet_tpu/ops/blocked_cross_entropy.py``.  The loss of
a linear head,

    loss_i = logsumexp_v(x_i . W[:, v]) - x_i . W[:, target_i],

is computed one vocabulary block at a time (an online logsumexp plus the
target logit), so the (N, V) logit tensor never exists: peak activation
memory is O(N * block).  The backward recomputes each block's softmax
from the saved ``(x, logsumexp)``, accumulates dx, and writes each
block's dW into one (d, V) gradient allocated once, in the weight's
dtype and layout.

Semantics, the reference's: x is cast to float32; each weight block is
cast to float32 on its own (a bf16 head is never widened whole); a
target equal to ``ignore_index`` or outside [0, V) gives loss 0 and
gradient 0.  The reference pads the weight to a whole number of blocks
and masks the padding with -inf; here the last block is the narrower
slice itself, which adds the same zeros to the sum without a copy of
the weight.  Each block's products are plain ``torch.matmul``: the
reference computes them with XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["fused_linear_cross_entropy"]


def _blocks(v_real, block):
    return [(v0, min(v0 + block, v_real)) for v0 in range(0, v_real, block)]


def _valid_tokens(t, v_real, ignore_index):
    valid = (t >= 0) & (t < v_real)
    if ignore_index is not None:
        valid = valid & (t != ignore_index)
    return valid


def _in_block(t, v0, v1):
    """(rows whose target lies in [v0, v1), the target's column there
    clipped into the block)."""
    rel = t - v0
    return (rel >= 0) & (rel < v1 - v0), rel.clamp(0, v1 - v0 - 1)


def _lse_and_target(xf, w, t, block):
    """One pass over the vocabulary blocks: the online logsumexp and the
    target logit of each row.  xf: (N, d) float32; w: (d, V); t: (N,)
    int64.  Returns (lse, t_logit), both (N,) float32."""
    n = xf.shape[0]
    m = torch.full((n,), float("-inf"), dtype=torch.float32,
                   device=xf.device)
    s = torch.zeros(n, dtype=torch.float32, device=xf.device)
    tl = torch.zeros(n, dtype=torch.float32, device=xf.device)
    for v0, v1 in _blocks(w.shape[1], block):
        logits = xf @ w[:, v0:v1].float()                    # (N, bv)
        new_m = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - new_m) + \
            torch.exp(logits - new_m[:, None]).sum(dim=-1)
        m = new_m
        hit, rel = _in_block(t, v0, v1)
        tl = torch.where(hit, logits.gather(1, rel[:, None])[:, 0], tl)
    return m + torch.log(s), tl


class _FusedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, block, ignore_index):
        t = targets.long()
        lse, t_logit = _lse_and_target(x.float(), w, t, block)
        valid = _valid_tokens(t, w.shape[1], ignore_index)
        ctx.save_for_backward(x, w, t, lse)
        ctx.block, ctx.ignore_index = block, ignore_index
        return torch.where(valid, lse - t_logit, 0.0)

    @staticmethod
    def backward(ctx, g):
        x, w, t, lse = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        xf = x.float()
        g = g.float() * _valid_tokens(t, w.shape[1],
                                      ctx.ignore_index).float()
        dx = torch.zeros_like(xf) if need_dx else None
        # w's own layout: the transposed view of a (V, d) parameter gets
        # a gradient whose blocks are whole rows of that parameter
        dw = torch.empty_like(w) if need_dw else None
        for v0, v1 in _blocks(w.shape[1], ctx.block):
            wf = w[:, v0:v1].float()
            p = torch.exp(xf @ wf - lse[:, None])            # block softmax
            hit, rel = _in_block(t, v0, v1)
            p.scatter_add_(1, rel[:, None], -hit.float()[:, None])
            dlogits = p * g[:, None]
            if need_dx:
                dx += dlogits @ wf.T
            if need_dw:
                dw[:, v0:v1] = xf.T @ dlogits
        return (None if dx is None else dx.to(x.dtype), dw, None, None,
                None)


def fused_linear_cross_entropy(x, w, targets, block=2048,
                               ignore_index=None):
    """Per-token CE loss of a linear head, the vocabulary in blocks.

    x: (N, d) activations; w: (d, V) head weight (each block cast to
    float32 as it is used); targets: (N,) integers.  Returns the (N,)
    float32 losses; a target equal to ``ignore_index`` or outside
    [0, V) gives loss 0 and gradient 0.  Differentiable in x and w."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise MXNetError(f"fused_linear_cross_entropy: x {tuple(x.shape)} "
                         f"and w {tuple(w.shape)} do not chain")
    if int(block) < 1:
        raise MXNetError(f"fused_linear_cross_entropy: block {block} < 1")
    return _FusedLinearCE.apply(x, w, targets, int(block), ignore_index)
