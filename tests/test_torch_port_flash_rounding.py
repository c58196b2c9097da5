"""The bf16 flash backward's rounding, emulated on the CPU.

On the card the bf16 backward kernels run their products on the tensor
cores, which take ``p`` and ``ds`` as bf16: both are rounded before the
three gradient products (dV = P^T dO, dK = dS^T Q, dQ = dS K), where the
reference (``_scan_backward``) and the port's plain version keep them in
f32.  S, dP and every sum stay f32.  This file emulates that rounding in
PyTorch and holds the result against the port's plain backward and
against JAX's ``_scan_backward``, fed the same numpy inputs, within the
bf16 backward tolerance the card's tests use (1e-2 absolute + 1.6e-2
relative, ``chip_smoke.FLASH_BWD_TOL``): the deviation the kernels are
held to on the card, on record where the CPU suite sees it.
"""
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mxnet_tpu_torch.ops.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)

BF16_BWD_TOL = dict(atol=1e-2, rtol=1.6e-2)


def _rounded_products_bwd(q, k, v, out, lse, g, causal, scale):
    """The kernels' backward numerics: f32 scores and dP from the bf16
    inputs, p and ds rounded to bf16 before the gradient products."""
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
    lq, lk = q.shape[1], k.shape[1]
    delta = (out.float() * g32).sum(-1, keepdim=True)
    s = torch.einsum("bqd,bkd->bqk", q32, k32) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        seen = torch.arange(lq)[:, None] >= torch.arange(lk)[None, :]
        p = torch.where(seen[None], p, torch.zeros(()))
    dp = torch.einsum("bqd,bkd->bqk", g32, v32)
    ds = p * (dp - delta) * scale
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bqk,bqd->bkd", p16, g32)
    dk = torch.einsum("bqk,bqd->bkd", ds16, q32)
    dq = torch.einsum("bqk,bkd->bqd", ds16, k32)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _jax_scan_backward():
    import mxnet_tpu.ops  # noqa: F401  (re-exports the function's name)
    return sys.modules["mxnet_tpu.ops.flash_attention"]._scan_backward


@pytest.mark.parametrize("bh,lq,lk,d,causal", [
    (2, 256, 256, 64, True),      # two of the kernels' 128-row tiles
    (2, 200, 200, 64, True),      # ragged: no 64-row tile boundary
    (2, 96, 160, 128, False)])    # cross-attention lengths, D = 128
def test_bf16_p_ds_rounding_fits_the_backward_tolerance(bh, lq, lk, d,
                                                        causal):
    rng = np.random.RandomState(lq + lk + d)
    q, k, v, g = (rng.randn(bh, n, d).astype(np.float32)
                  for n in (lq, lk, lk, lq))
    tq, tk, tv, tg = (torch.from_numpy(a).bfloat16() for a in (q, k, v, g))
    scale = d ** -0.5
    out, lse = flash_attention_plain(tq, tk, tv, causal, scale)
    got = _rounded_products_bwd(tq, tk, tv, out, lse, tg, causal, scale)
    plain = flash_attention_bwd_plain(tq, tk, tv, out, lse, tg, causal,
                                      scale)
    # the same inputs through JAX: bf16 codes, the port's out and lse
    jq, jk, jv, jg, jout = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                            for t in (tq, tk, tv, tg, out))
    ref = _jax_scan_backward()(jq, jk, jv, jout, jnp.asarray(lse.numpy()),
                               jg, causal, scale, lk)
    moved = 0.0
    for a, b, r in zip(got, plain, ref):
        torch.testing.assert_close(a.float(), b.float(), **BF16_BWD_TOL)
        want = torch.from_numpy(np.asarray(r.astype(jnp.float32)))
        torch.testing.assert_close(a.float(), want, **BF16_BWD_TOL)
        moved = max(moved, float((a.float() - b.float()).abs().max()))
    assert moved > 0          # the rounding is real, not a no-op here
