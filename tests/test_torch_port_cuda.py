"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test needs an NVIDIA GPU with ``nvcc`` and skips
without one.  This file imports only torch and the port, so it also runs
where JAX is absent::

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

Tolerances: float32 5e-5 absolute + 1e-4 relative (summation order
only); bfloat16 outputs 1e-2 absolute + 1.6e-2 relative (two ulps of the
bf16 output; the flash kernel also rounds p against a running max taken
over other column blocks than the plain version's).  The flash backward
in float32 is held to 1e-4 absolute + 1e-4 relative (its ``dp - delta``
cancels, so summation-order noise is relative to the terms, not the
result).  The update kernels K1/K2 are held to 1e-6 relative + 1e-7
absolute, not bitwise: nvcc contracts ``a*b + c`` into one FMA where
the plain PyTorch rule rounds twice.  K5's fp8 path takes the
tolerance of its query's dtype, against the plain version on the same
codes and scales (the kernel folds each row's scale into the score and
into p, the plain version into the dequantized row: f32 rounding only).
K4's y and dx take the tolerance of their dtype; dgamma and dbeta, f32
sums over all rows in another order, 1e-3 absolute + 1e-4 relative.
"""
import os
import threading

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import MXNetError, NotSupportedError, amp, ops
from mxnet_tpu_torch import autograd as mt_autograd, nd as mt_nd
from mxnet_tpu_torch.convert import block_weights_to_numpy, load_block_weights
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama_tiny
from mxnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_fwd,
                                                 flash_attention_plain)
from mxnet_tpu_torch.ops.fused_update import (fused_adam_update,
                                              fused_bucket_rule,
                                              fused_sgd_update)
from mxnet_tpu_torch.optimizer import fused_rule
from mxnet_tpu_torch.ops.fused_layernorm import (fused_layer_norm,
                                                 fused_layer_norm_bwd,
                                                 fused_layer_norm_fwd,
                                                 layer_norm_bwd_plain,
                                                 layer_norm_plain)
from mxnet_tpu_torch.ops import paged_attention as paged_mod
from mxnet_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                 paged_decode_plain,
                                                 split_plan)
from mxnet_tpu_torch.ops.quant_kv import kv_quantize_fp8
from mxnet_tpu_torch.ops.quant_matmul import int8_matmul, quantize_rtn_int8
from mxnet_tpu_torch.serving import InferenceEngine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=5e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-2, rtol=1.6e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal,lq,lk", [
    (True, 1, 1), (True, 16, 16), (True, 65, 65), (True, 200, 200),
    (False, 48, 96), (False, 130, 70),
    # the edges of the bf16 kernel's 128-row tiles
    (True, 127, 127), (True, 129, 129), (True, 1000, 1000), (False, 1, 300),
    (False, 300, 64),
    # causal cross-attention lengths (top-left mask), one at the 64-row edge
    (True, 48, 96), (True, 130, 70), (True, 64, 129)])
def test_flash_kernel_matches_plain(card, dtype, D, causal, lq, lk):
    g = torch.Generator(device=card).manual_seed(lq * 7 + lk + D)
    q = torch.randn(6, lq, D, device=card, generator=g).to(dtype)
    k = torch.randn(6, lk, D, device=card, generator=g).to(dtype)
    v = torch.randn(6, lk, D, device=card, generator=g).to(dtype)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    ref, ref_lse = flash_attention_plain(q, k, v, causal, D ** -0.5)
    assert out.dtype == dtype and lse.dtype == torch.float32
    _close(out, ref, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("C,L", [(16, 16), (64, 256), (100, 300),
                                 (128, 128), (256, 1024), (1, 65)])
def test_flash_kernel_q_start_matches_plain(card, dtype, D, C, L):
    """The offset form (the chunked prefill's): each row's queries start
    at their own position in [0, L - C], the first row at 0 and the last
    at L - C."""
    g = torch.Generator(device=card).manual_seed(C * 7 + L + D)
    bh = 6
    q = torch.randn(bh, C, D, device=card, generator=g).to(dtype)
    k = torch.randn(bh, L, D, device=card, generator=g).to(dtype)
    v = torch.randn(bh, L, D, device=card, generator=g).to(dtype)
    starts = torch.randint(0, L - C + 1, (bh,), device=card, generator=g,
                           dtype=torch.int32)
    starts[0], starts[-1] = 0, L - C
    before = ops.launch_counts()
    with torch.no_grad():
        out, lse = flash_attention_fwd(q, k, v, True, q_start=starts)
    torch.cuda.synchronize()
    got = ops.launch_counts()
    assert got["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert got["flash_attention_fwd_offset"] == \
        before["flash_attention_fwd_offset"] + 1
    ref, ref_lse = flash_attention_plain(q, k, v, True, D ** -0.5,
                                         q_start=starts)
    _close(out, ref, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_q_start_zero_is_the_causal_kernel(card, dtype):
    """Offsets of 0 on square rows: the offset instantiation gives the
    causal kernel's bits."""
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn(8, 300, 128, device=card, generator=g).to(dtype)
               for _ in range(3))
    with torch.no_grad():
        want = flash_attention_fwd(q, k, v, True)
        got = flash_attention_fwd(
            q, k, v, True, q_start=torch.zeros(8, dtype=torch.int32,
                                               device=card))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_flash_kernel_q_start_refusals(card):
    q = torch.randn(2, 16, 64, device=card)
    with pytest.raises(MXNetError, match="q_start"):
        flash_attention_fwd(q, q, q, True,
                            q_start=torch.zeros(2, dtype=torch.int64,
                                                device=card))
    with pytest.raises(MXNetError, match="q_start"):
        flash_attention_fwd(q, q, q, True,
                            q_start=torch.zeros(3, dtype=torch.int32,
                                                device=card))
    with pytest.raises(NotSupportedError, match="forward only"):
        flash_attention_fwd(q.requires_grad_(), q, q, True,
                            q_start=torch.zeros(2, dtype=torch.int32,
                                                device=card))


def _paged_case(card, B, H, KVH, D, bs, nbl, q_dtype, kv_dtype, seed):
    """q, pools, tables and positions on the card; an fp8 pool is
    quantized there and followed by its (k_scale, v_scale)."""
    rng = np.random.RandomState(seed)
    nb = 1 + B * nbl
    q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32))
    kp = torch.from_numpy(rng.randn(nb, bs, KVH, D).astype(np.float32))
    vp = torch.from_numpy(rng.randn(nb, bs, KVH, D).astype(np.float32))
    pos = rng.randint(0, nbl * bs, B).astype(np.int32)
    pos[0] = 0                                   # an idle row
    pos[-1] = nbl * bs - 1                       # a full row
    tables = np.zeros((B, nbl), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    for i in range(1, B):                        # row 0: all null
        n = int(pos[i]) // bs + 1
        tables[i, :n], perm = perm[:n], perm[n:]
    if kv_dtype == torch.float8_e4m3fn:
        (kc, ks), (vc, vs) = (kv_quantize_fp8(t.to(card)) for t in (kp, vp))
        return [q.to(q_dtype).to(card), kc, vc,
                torch.from_numpy(tables).to(card),
                torch.from_numpy(pos).to(card), ks, vs]
    args = [q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype),
            torch.from_numpy(tables), torch.from_numpy(pos)]
    return [a.to(card) for a in args]


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("H,KVH,D", [(4, 4, 64), (8, 4, 128), (32, 8, 128),
                                      (16, 2, 64)])
def test_paged_kernel_matches_plain(card, q_dtype, kv_dtype, H, KVH, D):
    q, kp, vp, tables, pos = _paged_case(card, 5, H, KVH, D, 16, 6, q_dtype,
                                         kv_dtype, seed=H + D)
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, kp, vp, tables, pos, D ** -0.5)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_plain(q, kp, vp, tables, pos, D ** -0.5)
    assert out.dtype == q_dtype and torch.isfinite(out).all()
    _close(out, ref, q_dtype)


def test_paged_kernel_ignores_rows_past_pos(card):
    """Garbage (even NaN) past ``pos`` and in unused blocks is never read."""
    q, kp, vp, tables, pos = _paged_case(card, 4, 8, 4, 128, 16, 4,
                                         torch.float32, torch.float32, 3)
    out = paged_decode_attention(q, kp, vp, tables, pos, 0.1)
    kp2, vp2 = kp.clone(), vp.clone()
    for i in range(4):
        p = int(pos[i])
        blk = int(tables[i, p // 16])
        kp2[blk, p % 16 + 1:] = float("nan")
        vp2[blk, p % 16 + 1:] = float("nan")
    out2 = paged_decode_attention(q, kp2, vp2, tables, pos, 0.1)
    torch.testing.assert_close(out2[1:], out[1:], atol=0, rtol=0)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D", [(32, 8, 128), (8, 8, 128), (16, 2, 128),
                                      (32, 8, 64), (8, 8, 64), (16, 2, 64)])
def test_paged_fp8_kernel_matches_plain(card, q_dtype, H, KVH, D):
    q, kp, vp, tables, pos, ks, vs = _paged_case(
        card, 5, H, KVH, D, 16, 6, q_dtype, torch.float8_e4m3fn, seed=H + D)
    before = (paged_decode_attention.launches,
              paged_decode_attention.launches_fp8)
    out = paged_decode_attention(q, kp, vp, tables, pos, D ** -0.5,
                                 k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert (paged_decode_attention.launches,
            paged_decode_attention.launches_fp8) == (before[0], before[1] + 1)
    ref = paged_decode_plain(q, kp, vp, tables, pos, D ** -0.5, ks, vs)
    assert out.dtype == q_dtype and torch.isfinite(out).all()
    _close(out, ref, q_dtype)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_fp8_kernel_at_context_4096(card, q_dtype):
    """The fp8 serving phase's longest context: 256 blocks of 16."""
    q, kp, vp, tables, pos, ks, vs = _paged_case(
        card, 3, 32, 8, 128, 16, 256, q_dtype, torch.float8_e4m3fn, seed=11)
    out = paged_decode_attention(q, kp, vp, tables, pos, 128 ** -0.5,
                                 k_scale=ks, v_scale=vs)
    ref = paged_decode_plain(q, kp, vp, tables, pos, 128 ** -0.5, ks, vs)
    torch.cuda.synchronize()
    assert int(pos[-1]) == 4095
    _close(out, ref, q_dtype)


def test_paged_fp8_kernel_ignores_rows_past_pos(card):
    """NaN codes and scales past ``pos`` are never read."""
    q, kp, vp, tables, pos, ks, vs = _paged_case(
        card, 4, 8, 4, 128, 16, 4, torch.float32, torch.float8_e4m3fn, 3)
    out = paged_decode_attention(q, kp, vp, tables, pos, 0.1, k_scale=ks,
                                 v_scale=vs)
    kb, vb = kp.view(torch.uint8).clone(), vp.view(torch.uint8).clone()
    ks2, vs2 = ks.clone(), vs.clone()
    for i in range(4):
        p = int(pos[i])
        blk = int(tables[i, p // 16])
        kb[blk, p % 16 + 1:] = 0x7F                 # e4m3 NaN
        vb[blk, p % 16 + 1:] = 0x7F
        ks2[blk, p % 16 + 1:] = float("nan")
        vs2[blk, p % 16 + 1:] = float("nan")
    out2 = paged_decode_attention(q, kb.view(torch.float8_e4m3fn),
                                  vb.view(torch.float8_e4m3fn), tables, pos,
                                  0.1, k_scale=ks2, v_scale=vs2)
    torch.testing.assert_close(out2[1:], out[1:], atol=0, rtol=0)


def _split_case(card, positions, rep, kv_dtype, nbl, seed, KVH=2, D=128,
                bs=16):
    """K5 inputs with the given positions: a bf16 query for bf16 and fp8
    pools, f32 for f32; each sequence's blocks scattered over the pool
    (null padding past its position)."""
    B = len(positions)
    rng = np.random.RandomState(seed)
    nb = 1 + B * nbl
    pos = np.asarray(positions, np.int32)
    tables = np.zeros((B, nbl), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    for i, p in enumerate(pos):
        n = int(p) // bs + 1
        tables[i, :n], perm = perm[:n], perm[n:]
    q_dtype = torch.float32 if kv_dtype == torch.float32 else torch.bfloat16
    q = torch.from_numpy(rng.randn(B, KVH * rep, D).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(nb, bs, KVH, D).astype(np.float32))
            .to(card) for _ in range(2))
    tail = [torch.from_numpy(tables).to(card), torch.from_numpy(pos).to(card)]
    if kv_dtype == torch.float8_e4m3fn:
        (kc, ks), (vc, vs) = kv_quantize_fp8(k), kv_quantize_fp8(v)
        return [q.to(q_dtype).to(card), kc, vc, *tail], dict(k_scale=ks,
                                                            v_scale=vs)
    return [q.to(q_dtype).to(card), k.to(kv_dtype), v.to(kv_dtype),
            *tail], {}


def _paged_against_plain(args, scales):
    out = paged_decode_attention(*args, args[0].shape[-1] ** -0.5, **scales)
    ref = paged_decode_plain(*args, args[0].shape[-1] ** -0.5,
                             scales.get("k_scale"), scales.get("v_scale"))
    torch.cuda.synchronize()
    assert out.dtype == args[0].dtype and torch.isfinite(out).all()
    _close(out, ref, args[0].dtype)
    return out


_C = split_plan(32, 16)[0]       # positions a split at the default plan


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                      torch.float8_e4m3fn],
                         ids=["f32", "bf16", "fp8"])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("positions", [
    [0], [_C - 1], [_C], [_C + 1], [2 * _C], [32 * 16 - 1],
    [0, _C - 1, _C, _C + 1, 2 * _C, 511, 3, 200, 77, 511, 0, 300, 129, 255,
     256, 257]], ids=["0", "C-1", "C", "C+1", "2C", "bucket-1", "B16"])
def test_paged_kernel_split_edges(card, kv_dtype, rep, positions):
    """K5 at the edges of its context splits (a 512-position bucket, C
    positions a split), one sequence and sixteen, every pool type."""
    args, scales = _split_case(card, positions, rep, kv_dtype, 32,
                               seed=rep + len(positions))
    assert split_plan(32, 16)[1] == 4
    _paged_against_plain(args, scales)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn],
                         ids=["bf16", "fp8"])
def test_paged_kernel_is_bitwise_repeatable(card, kv_dtype):
    """The ordered combine: two runs at the fp8 serving phase's geometry
    (B = 16, 256 blocks of 16) give the same bits."""
    positions = np.random.RandomState(0).randint(0, 4096, 16)
    positions[0] = 4095
    args, scales = _split_case(card, positions, 4, kv_dtype, 256, seed=1,
                               KVH=8)
    first = _paged_against_plain(args, scales)
    for _ in range(2):
        again = paged_decode_attention(*args, 128 ** -0.5, **scales)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


def test_paged_kernel_calls_in_a_row_with_other_splits(card):
    """Three calls with other B and S in a row, each against the plain
    version: a ticket counter left unreset would merge too early."""
    for positions, nbl, kv_dtype in (
            ([1023, 5, 700, 1000, 64], 64, torch.bfloat16),
            (list(range(0, 4096, 256)), 256, torch.float8_e4m3fn),
            ([300, 1023, 17], 64, torch.float32),
            ([1023, 5, 700, 1000, 64], 64, torch.bfloat16)):
        args, scales = _split_case(card, positions, 4, kv_dtype, nbl,
                                   seed=nbl + len(positions), KVH=8)
        _paged_against_plain(args, scales)


def test_flash_kernel_matches_plain_at_4096(card):
    """K3 forward at the fp8 serving phase's longest prompt bucket."""
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=card).manual_seed(4096)
        q, k, v = (torch.randn(4, 4096, 128, device=card, generator=g)
                   .to(dtype) for _ in range(3))
        out, lse = flash_attention_fwd(q, k, v, True)
        ref, ref_lse = flash_attention_plain(q, k, v, True, 128 ** -0.5)
        torch.cuda.synchronize()
        _close(out, ref, dtype)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


def test_kernels_refuse_what_they_do_not_take(card):
    from mxnet_tpu_torch import NotSupportedError
    x = torch.zeros(2, 16, 32, device=card)
    with pytest.raises(NotSupportedError):
        flash_attention_fwd(x, x, x)             # head_dim 32
    q = torch.zeros(2, 4, 64, device=card, dtype=torch.bfloat16)
    kp = torch.zeros(3, 16, 2, 64, device=card)
    t = torch.zeros(2, 1, dtype=torch.int32, device=card)
    p = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(NotSupportedError):
        paged_decode_attention(q, kp, kp, t, p, 0.1)   # bf16 q, f32 pool
    k8 = kp.to(torch.float8_e4m3fn)
    s = torch.ones(3, 16, device=card)
    for pools, scales in (((k8, k8), {}),              # fp8 without scales
                          ((kp, kp), dict(k_scale=s, v_scale=s)),
                          ((k8, k8), dict(k_scale=s[:, :8], v_scale=s)),
                          ((k8, k8), dict(k_scale=s.double(), v_scale=s)),
                          ((k8, k8), dict(k_scale=s.t().contiguous().t(),
                                          v_scale=s))):
        with pytest.raises(NotSupportedError):
            paged_decode_attention(q.float(), *pools, t, p, 0.1, **scales)
    x = torch.zeros(4, 8193, device=card)
    w = torch.ones(8193, device=card)
    with pytest.raises(NotSupportedError):
        fused_layer_norm_fwd(x, None, w, w, 1e-5)      # D above 8192
    h = torch.zeros(4, 64, device=card, dtype=torch.float16)
    w = torch.ones(64, device=card)
    with pytest.raises(NotSupportedError):
        fused_layer_norm_fwd(h, None, w, w, 1e-5)      # float16
    with pytest.raises(NotSupportedError):             # residual dtype
        fused_layer_norm_fwd(h.float(), h, w, w, 1e-5)


# ----------------------------------------------------------------------
# training kernels: flash backward, K1, K2
# ----------------------------------------------------------------------

BWD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=1e-2, rtol=1.6e-2)}
UPDATE_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal,lq,lk", [
    (True, 1, 1), (True, 16, 16), (True, 65, 65), (True, 200, 200),
    (True, 256, 256), (False, 48, 96), (False, 130, 70),
    # the edges of the bf16 kernels' 128- and 64-row tiles
    (True, 127, 127), (True, 129, 129), (True, 1000, 1000), (False, 1, 300),
    (False, 300, 64),
    # causal cross-attention lengths (top-left mask), one at the 64-row edge
    (True, 48, 96), (True, 130, 70), (True, 64, 129)])
def test_flash_bwd_kernel_matches_plain(card, dtype, D, causal, lq, lk):
    q, k, v, do = _bwd_inputs(card, 4, lq, lk, D, dtype, lq * 5 + lk + D)
    out, lse = flash_attention_fwd(q, k, v, causal)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal, D ** -0.5)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[dtype])


def _bwd_inputs(card, bh, lq, lk, D, dtype, seed):
    """q, k, v, do on the card from a seeded generator."""
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(bh, lq, D, device=card, generator=g).to(dtype)
    k = torch.randn(bh, lk, D, device=card, generator=g).to(dtype)
    v = torch.randn(bh, lk, D, device=card, generator=g).to(dtype)
    do = torch.randn(bh, lq, D, device=card, generator=g).to(dtype)
    return q, k, v, do


def test_flash_bwd_kernel_matches_plain_at_4096(card):
    """The bf16 backward at a long causal sequence: 64 Q tiles reach the
    first KV tile, with p and ds rounded to bf16 in every product."""
    q, k, v, do = _bwd_inputs(card, 2, 4096, 4096, 128, torch.bfloat16, 4096)
    out, lse = flash_attention_fwd(q, k, v, True)
    got = flash_attention_bwd(q, k, v, out, lse, do, True)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, True, 128 ** -0.5)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(),
                                   **BWD_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_is_bitwise_repeatable(card, dtype):
    """No float atomics: two backward runs give the same bits."""
    q, k, v, do = _bwd_inputs(card, 4, 333, 333, 128, dtype, 7)
    out, lse = flash_attention_fwd(q, k, v, True)
    first = flash_attention_bwd(q, k, v, out, lse, do, True)
    again = flash_attention_bwd(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_kernels_refuse_unaligned_base_pointers(card):
    """The kernels copy 16 bytes at a time: a tensor whose storage starts
    one element into an allocation is refused, not read misaligned."""
    buf = torch.zeros(4 * 64 * 64 + 1, device=card, dtype=torch.bfloat16)
    bad = buf[1:].view(4, 64, 64)
    good = torch.zeros(4, 64, 64, device=card, dtype=torch.bfloat16)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    with pytest.raises(MXNetError, match="aligned"):
        flash_attention_fwd(bad, good, good, True)
    out, lse = flash_attention_fwd(good, good, good, True)
    with pytest.raises(MXNetError, match="aligned"):
        flash_attention_bwd(good, good, good, out, lse, bad, True)


def test_flash_on_card_is_differentiable(card):
    """On a CUDA tensor that requires grad the op's output has a
    ``grad_fn``, and its backward launches the backward kernel."""
    g = torch.Generator(device=card).manual_seed(9)
    q, k, v, do = (torch.randn(2, 4, 96, 64, device=card, generator=g)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True)
    assert out.grad_fn is not None
    before = flash_attention_bwd.launches
    out.backward(do.transpose(1, 2).contiguous().transpose(1, 2))
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    flat = [t.reshape(8, 96, 64) for t in (q, k, v)]
    o, lse = flash_attention_plain(*flat, True, 0.125)
    want = flash_attention_bwd_plain(*flat, o, lse, do.reshape(8, 96, 64),
                                     True, 0.125)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad.reshape(8, 96, 64), w,
                                   **BWD_TOL[torch.float32])


_UPDATE_RULES = [("sgd", {}), ("sgd", {"momentum": 0.9}),
                 ("nag", {"momentum": 0.9}), ("adam", {}), ("adamw", {})]


def _on_card(card, lr, s):
    """``lr`` and the state ``s`` as K1/K2 take them on the card: a
    float32 and (Adam's ``t``) an int32 device scalar."""
    s = dict(s)
    if "t" in s:
        s["t"] = torch.tensor([int(s["t"])], dtype=torch.int32, device=card)
    return torch.tensor([lr], dtype=torch.float32, device=card), s


@pytest.mark.parametrize("n", [5000, 1 << 20])
@pytest.mark.parametrize("name,hyper", _UPDATE_RULES,
                         ids=["sgd", "momentum", "nag", "adam", "adamw"])
def test_update_kernels_match_plain(card, name, hyper, n):
    """K1/K2 on an unaligned and an aligned bucket, 3 steps with clip
    and wd, against the plain rule on the same card."""
    rng = np.random.RandomState(n % 97)
    p0 = torch.from_numpy(rng.randn(n).astype(np.float32)).to(card)
    init, apply = fused_bucket_rule(name, clip_gradient=0.5, **hyper)
    _, plain = fused_rule(name, clip_gradient=0.5, **hyper)
    lr, ks = _on_card(card, 0.01, init(p0))
    kp = p0.clone()
    pp, ps = p0.clone(), init(p0)
    wrapper = fused_sgd_update if name in ("sgd", "nag") else \
        fused_adam_update
    for _ in range(3):
        grad = torch.from_numpy(rng.randn(n).astype(np.float32)).to(card)
        before = wrapper.launches
        kp, ks = apply(kp, grad, ks, lr, 1e-3, 0.5)
        assert wrapper.launches == before + 1
        pp, ps = plain(pp, grad, ps, 0.01, 1e-3, 0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(kp, pp, **UPDATE_TOL)
    for leaf, val in ps.items():
        if torch.is_tensor(val):
            torch.testing.assert_close(ks[leaf], val, **UPDATE_TOL)
        else:
            assert int(ks[leaf].item()) == val


def _copy_at(x, offset):
    """A copy of the flat ``x`` ``offset`` elements into its allocation."""
    return torch.empty(x.numel() + offset, device=x.device)[offset:].copy_(x)


@pytest.mark.parametrize("n", [1, 3, 4099, 5003, (1 << 20) + 3])
@pytest.mark.parametrize("offsets", [(1, 1, 1, 1), (2, 2, 2, 2), (3, 3, 3, 3),
                                     (1, 2, 0, 3)],
                         ids=["offset1", "offset2", "offset3", "mixed"])
@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("name,hyper", _UPDATE_RULES,
                         ids=["sgd", "momentum", "nag", "adam", "adamw"])
def test_update_kernels_heads_tails_and_offsets(card, name, hyper, clip,
                                                offsets, n):
    """K1/K2 on buckets with a scalar head (p, g and the state views 1-3
    elements into their allocations), a scalar tail, and streams at
    different offsets (the all-scalar plan): one launch a call, within
    UPDATE_TOL of the plain rule, and two runs bitwise equal."""
    rng = np.random.RandomState(n % 89 + sum(offsets))
    init, apply = fused_bucket_rule(name, clip_gradient=clip, **hyper)
    _, plain = fused_rule(name, clip_gradient=clip, **hyper)
    p = torch.from_numpy(rng.randn(n).astype(np.float32)).to(card)
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(card)
    s = init(p)
    for leaf in s:
        if torch.is_tensor(s[leaf]):
            s[leaf] = torch.from_numpy(np.abs(
                rng.randn(n)).astype(np.float32) * 0.1).to(card)
    if "t" in s:
        s["t"] = 2
    wrapper = fused_sgd_update if name in ("sgd", "nag") else \
        fused_adam_update
    want_p, want_s = plain(p, g, s, 0.01, 1e-3, 0.5)
    runs = []
    for _ in range(2):
        kp = _copy_at(p, offsets[0])
        lr, ks = _on_card(card, 0.01, {
            leaf: _copy_at(val, offsets[2 + i]) if torch.is_tensor(val)
            else val for i, (leaf, val) in enumerate(s.items())})
        before = wrapper.launches
        kp, ks = apply(kp, _copy_at(g, offsets[1]), ks, lr, 1e-3, 0.5)
        assert wrapper.launches == before + 1
        runs.append((kp, ks))
    torch.cuda.synchronize()
    for kp, ks in runs:
        torch.testing.assert_close(kp, want_p, **UPDATE_TOL)
        for leaf, val in want_s.items():
            if torch.is_tensor(val):
                torch.testing.assert_close(ks[leaf], val, **UPDATE_TOL)
            else:
                assert int(ks[leaf].item()) == val
    (p1, s1), (p2, s2) = runs
    assert torch.equal(p1, p2)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


def test_update_kernels_refuse_what_they_do_not_take(card):
    _, apply = fused_bucket_rule("adam")
    p = torch.zeros(4, 4, device=card)
    lr, s = _on_card(card, 0.1, {"m": torch.zeros_like(p),
                                 "v": torch.zeros_like(p), "t": 0})
    with pytest.raises(MXNetError):
        apply(p, p, s, lr)                         # not flat
    pb = torch.zeros(16, device=card, dtype=torch.bfloat16)
    _, sb = _on_card(card, 0.1, {"m": torch.zeros_like(pb),
                                 "v": torch.zeros_like(pb), "t": 0})
    with pytest.raises(MXNetError):
        apply(pb, pb, sb, lr)                      # not f32
    flat = torch.zeros(16, device=card)
    _, sf = _on_card(card, 0.1, {"m": torch.zeros_like(flat),
                                 "v": torch.zeros_like(flat), "t": 0})
    with pytest.raises(MXNetError, match="overlap"):
        apply(flat, flat, sf, lr)                  # p is g
    _, s8 = _on_card(card, 0.1, {"m": torch.zeros(8, device=card),
                                 "v": torch.zeros(8, device=card), "t": 0})
    with pytest.raises(MXNetError, match="overlap"):
        apply(flat[:8], flat[4:12], s8, lr)
    g = torch.zeros(16, device=card)
    with pytest.raises(MXNetError, match="one-element"):
        apply(flat, g, sf, 0.1)                    # a host lr on the card
    with pytest.raises(MXNetError, match="one-element"):
        apply(flat, g, {**sf, "t": 0}, lr)         # a host t on the card


def _weights(net):
    """A port Llama's parameter tensors by structural name."""
    return {name: p.data().data
            for name, p in net._collect_params_with_prefix().items()}


def _copy_weights(src, dst):
    load_block_weights(dst, block_weights_to_numpy(src))
    return dst


def _nd(a, dev):
    return mt_nd.array(a, ctx=dev)


def test_llama_training_step_card_equals_cpu(card):
    """Two SGD-momentum steps of a small Llama block (head_dim 64, the
    kernels' smallest) through ``Trainer(net.collect_params())`` on the
    card and on the host from the same weights: the card runs flash
    fwd/bwd and K1."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kw = dict(hidden_size=128, num_heads=2, num_kv_heads=1,
                  intermediate_size=256, num_layers=2)
        on_card = llama_tiny(device=card, seed=4, **kw)
        on_cpu = _copy_weights(on_card,
                               llama_tiny(device="cpu", seed=None, **kw))
        rng = np.random.RandomState(4)
        tokens = rng.randint(0, 256, (2, 48))
        labels = rng.randint(0, 256, (2, 48))
        losses = []
        for net in (on_card, on_cpu):
            dev = net.decode_weights()[0].device
            tr = Trainer(net.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9})
            run = []
            for _ in range(2):
                with mt_autograd.record():
                    loss = SoftmaxCrossEntropyLoss()(
                        net(_nd(tokens, dev)), _nd(labels, dev))
                    total = loss.sum()
                total.backward()
                tr.step(2)
                run.append(float(loss.data.mean()))
            losses.append(run)
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
        got, want = _weights(on_card), _weights(on_cpu)
        for name in got:
            torch.testing.assert_close(got[name].cpu(), want[name],
                                       atol=1e-5, rtol=0, msg=name)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_trainer_flat_bucket_after_a_stale_step_still_launches_k1(card):
    """A step that skips a stale parameter and the full step after it
    each update as one flat bucket: one K1 launch per step."""
    kw = dict(hidden_size=128, num_heads=2, num_kv_heads=1,
              intermediate_size=256, num_layers=1)
    net = llama_tiny(device=card, seed=6, **kw)
    tr = Trainer(net.collect_params(), "sgd",
                 {"learning_rate": 0.1, "momentum": 0.9})
    tokens = _nd(np.random.RandomState(6).randint(0, 256, (2, 16)), card)
    before = _weights(net)["model.norm.weight"].detach().clone()
    for step in range(2):
        with mt_autograd.record():
            total = SoftmaxCrossEntropyLoss()(net(tokens), tokens).sum()
        total.backward()
        launches = fused_sgd_update.launches
        if step == 0:
            _weights(net)["model.norm.weight"].grad = None
            tr.step(2, ignore_stale_grad=True)
            assert torch.equal(_weights(net)["model.norm.weight"], before)
        else:
            tr.step(2)
        assert fused_sgd_update.launches == launches + 1
    assert not torch.equal(_weights(net)["model.norm.weight"], before)


# ----------------------------------------------------------------------
# bf16 mixed precision (amp) on the training path
# ----------------------------------------------------------------------

AMP_NET = dict(hidden_size=128, num_heads=2, num_kv_heads=1,
               intermediate_size=256, num_layers=2)


def test_amp_bf16_training_steps_on_the_card(card):
    """Two AdamW steps of a small Llama under ``amp.init("bfloat16")``:
    logits and loss bf16, f32 gradients, the parameters updated where
    they lie (the flat buffer); the first loss within 2e-2 relative of
    the CPU's from the same weights (bf16 matmuls in other orders, the
    loss rounded to bf16), and the update ``p2 - p0`` of all parameters
    together within 0.1 of the CPU's, relative to its norm: AdamW's step
    is about ``lr`` whatever the gradient's size, so a near-zero
    gradient element whose bf16 sign differs moves ``2 lr`` the other
    way (``tests/test_torch_port_amp.py`` holds the same limit against
    the reference, and shows that a wrong update misses it).  It is
    held over all parameters, not leaf by leaf: in a 128-element norm
    weight one such element alone is 0.18 of the norm."""
    on_card = llama_tiny(device=card, seed=11, **AMP_NET)
    on_cpu = _copy_weights(on_card,
                           llama_tiny(device="cpu", seed=None, **AMP_NET))
    w0 = {k: p.detach().clone() for k, p in _weights(on_cpu).items()}
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, 256, (2, 64))
    labels = rng.randint(0, 256, (2, 64))
    amp.init("bfloat16")
    try:
        first, updates = [], []
        for net in (on_card, on_cpu):
            dev = net.decode_weights()[0].device
            tr = Trainer(net.collect_params(), "adamw",
                         {"learning_rate": 1e-3, "wd": 0.1})
            amp.init_trainer(tr)
            tr._refresh()     # gluon parameters join the flat buffer here
            ptrs = [p.data_ptr() for p in _weights(net).values()]
            for step in range(2):
                with mt_autograd.record():
                    logits = net(_nd(tokens, dev))
                    loss = SoftmaxCrossEntropyLoss()(logits,
                                                     _nd(labels, dev))
                    with amp.scale_loss(loss.sum(), tr) as scaled:
                        scaled.backward()
                assert logits.data.dtype == loss.data.dtype == \
                    torch.bfloat16
                assert all(p.grad.dtype == torch.float32
                           for p in _weights(net).values())
                tr.step(2)
                if step == 0:
                    first.append(float(loss.data.float().mean()))
                assert bool(torch.isfinite(loss.data.float()).all())
            assert [p.data_ptr() for p in _weights(net).values()] == ptrs
            updates.append({k: p.detach().cpu() - w0[k]
                            for k, p in _weights(net).items()})
    finally:
        amp._deinit_for_tests()
    np.testing.assert_allclose(first[0], first[1], rtol=2e-2)
    card, cpu = (torch.cat([u[k].reshape(-1) for k in sorted(u)])
                 for u in updates)
    err = float((card - cpu).norm() / cpu.norm())
    assert err <= 0.1, err


def test_amp_bf16_launch_counts_on_the_card(card):
    """One AMP step runs K3's bf16 kernels forward and backward once a
    layer and K2 once."""
    net = llama_tiny(device=card, seed=12, **AMP_NET)
    tr = Trainer(net.collect_params(), "adamw", {"learning_rate": 1e-3})
    tokens = _nd(np.random.RandomState(12).randint(0, 256, (2, 64)), card)
    amp.init("bfloat16")
    try:
        amp.init_trainer(tr)
        ops.reset_launches()
        with mt_autograd.record():
            total = SoftmaxCrossEntropyLoss()(net(tokens), tokens).sum()
        total.backward()
        tr.step(2)
    finally:
        amp._deinit_for_tests()
    layers = AMP_NET["num_layers"]
    got = ops.launch_counts()
    assert got["flash_attention_fwd"] == got["flash_attention_fwd_bf16"] \
        == layers
    assert got["flash_attention_bwd"] == got["flash_attention_bwd_bf16"] \
        == layers
    assert got["fused_adam_update"] == 1


def test_amp_float16_is_refused_at_the_flash_kernel(card):
    net = llama_tiny(device=card, seed=13, **AMP_NET)
    amp.init("float16")
    try:
        with pytest.raises(NotSupportedError, match="float16"):
            net(_nd(np.zeros((1, 16), np.int32), card))
    finally:
        amp._deinit_for_tests()


@pytest.mark.parametrize("bad", [float("inf"), float("nan"), None])
def test_loss_scaler_has_overflow_on_the_card(card, bad):
    ps = [torch.nn.Parameter(torch.zeros(n, device=card))
          for n in (5, 70000)]
    for p in ps:
        p.grad = torch.ones_like(p)
    if bad is not None:
        ps[1].grad[65537] = bad
    assert amp.LossScaler().has_overflow(ps) == (bad is not None)


# ----------------------------------------------------------------------
# fused LayerNorm (K4)
# ----------------------------------------------------------------------

LN_PARAM_TOL = dict(atol=1e-3, rtol=1e-4)


def _ln_case(card, rows, D, dtype, residual, seed, g_dtype=torch.float32):
    g = torch.Generator(device=card).manual_seed(seed)
    x = (torch.randn(rows, D, device=card, generator=g) * 2 + 0.5).to(dtype)
    res = torch.randn(rows, D, device=card, generator=g).to(dtype) \
        if residual else None
    gamma = torch.randn(D, device=card, generator=g).to(g_dtype)
    beta = torch.randn(D, device=card, generator=g).to(g_dtype)
    dy = torch.randn(rows, D, device=card, generator=g).to(dtype)
    return x, res, gamma, beta, dy


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 64, 100, 768, 1000, 1024, 2048, 4096,
                               8192])
@pytest.mark.parametrize("rows", [1, 7, 4096, 4097])
def test_layernorm_kernels_match_plain(card, rows, D, dtype, residual):
    x, res, gamma, beta, dy = _ln_case(card, rows, D, dtype, residual,
                                       rows + D)
    before = (fused_layer_norm_fwd.launches, fused_layer_norm_bwd.launches)
    y = fused_layer_norm_fwd(x, res, gamma, beta, 1e-5)
    dx, dg, db = fused_layer_norm_bwd(x, res, gamma, dy, 1e-5)
    torch.cuda.synchronize()
    assert (fused_layer_norm_fwd.launches,
            fused_layer_norm_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert y.dtype == dx.dtype == dtype and dg.dtype == torch.float32
    _close(y, layer_norm_plain(x, res, gamma, beta, 1e-5), dtype)
    rdx, rdg, rdb = layer_norm_bwd_plain(x, res, gamma, dy, 1e-5)
    _close(dx, rdx, dtype)
    torch.testing.assert_close(dg, rdg, **LN_PARAM_TOL)
    torch.testing.assert_close(db, rdb, **LN_PARAM_TOL)


def test_layernorm_bf16_params_and_widest_row(card):
    """bf16 gamma/beta, and D = 8192 (the backward's row held by all 8
    warps of a CTA, 96 KB of shared memory)."""
    for D, g_dtype in ((1024, torch.bfloat16), (8192, torch.float32)):
        x, res, gamma, beta, dy = _ln_case(card, 33, D, torch.bfloat16, True,
                                           D, g_dtype)
        y = fused_layer_norm_fwd(x, res, gamma, beta, 1e-12)
        dx, dg, db = fused_layer_norm_bwd(x, res, gamma, dy, 1e-12)
        _close(y, layer_norm_plain(x, res, gamma, beta, 1e-12),
               torch.bfloat16)
        rdx, rdg, rdb = layer_norm_bwd_plain(x, res, gamma, dy, 1e-12)
        _close(dx, rdx, torch.bfloat16)
        torch.testing.assert_close(dg, rdg, **LN_PARAM_TOL)
        torch.testing.assert_close(db, rdb, **LN_PARAM_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [768, 1024])
def test_layernorm_kernels_take_misaligned_views(card, D, dtype):
    """x, res and dy one element into their allocations: the kernels'
    scalar instantiations (16-byte loads need aligned rows)."""
    x, res, gamma, beta, dy = _ln_case(card, 33, D, dtype, True, D + 1)

    def shifted(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype,
                           device=t.device)[1:].view(t.shape).copy_(t)

    sx, sres, sdy = shifted(x), shifted(res), shifted(dy)
    assert sx.data_ptr() % 16 != 0 and sx.is_contiguous()
    y = fused_layer_norm_fwd(sx, sres, gamma, beta, 1e-5)
    dx, dg, db = fused_layer_norm_bwd(sx, sres, gamma, sdy, 1e-5)
    _close(y, layer_norm_plain(x, res, gamma, beta, 1e-5), dtype)
    rdx, rdg, rdb = layer_norm_bwd_plain(x, res, gamma, dy, 1e-5)
    _close(dx, rdx, dtype)
    torch.testing.assert_close(dg, rdg, **LN_PARAM_TOL)
    torch.testing.assert_close(db, rdb, **LN_PARAM_TOL)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_layernorm_kernels_are_bitwise_repeatable(card, direction):
    x, res, gamma, beta, dy = _ln_case(card, 4096, 1024, torch.float32,
                                       True, 5)
    if direction == "fwd":
        def run():
            return (fused_layer_norm_fwd(x, res, gamma, beta, 1e-12),)
    else:
        def run():
            return fused_layer_norm_bwd(x, res, gamma, dy, 1e-12)
    first = run()
    for _ in range(3):
        for a, b in zip(first, run()):
            assert torch.equal(a, b)


def test_layernorm_kernels_replay_in_a_cuda_graph(card):
    """One forward and one backward captured in a ``torch.cuda.graph``
    and replayed: outputs bitwise equal to the eager launches (the C
    entries' cudaSetDevice and cudaFuncSetAttribute calls are legal
    under stream capture)."""
    x, res, gamma, beta, dy = _ln_case(card, 4096, 1024, torch.bfloat16,
                                       True, 6)
    eager = (fused_layer_norm_fwd(x, res, gamma, beta, 1e-12),
             *fused_layer_norm_bwd(x, res, gamma, dy, 1e-12))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = (fused_layer_norm_fwd(x, res, gamma, beta, 1e-12),
                    *fused_layer_norm_bwd(x, res, gamma, dy, 1e-12))
    for t in captured:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


def test_layernorm_op_on_card_is_differentiable(card):
    """The public op through ``_FusedLN``: one forward and one backward
    launch, gradients equal to the plain backward's, dres == dx."""
    x, res, gamma, beta, dy = _ln_case(card, 96, 768, torch.float32, True, 8)
    leaves = [t.clone().requires_grad_() for t in (x, res, gamma, beta)]
    before = (fused_layer_norm_fwd.launches, fused_layer_norm_bwd.launches)
    out = fused_layer_norm(leaves[0], leaves[2], leaves[3],
                           residual=leaves[1], eps=1e-12)
    assert out.grad_fn is not None
    out.backward(dy)
    torch.cuda.synchronize()
    assert (fused_layer_norm_fwd.launches,
            fused_layer_norm_bwd.launches) == (before[0] + 1, before[1] + 1)
    rdx, rdg, rdb = layer_norm_bwd_plain(x, res, gamma, dy, 1e-12)
    _close(leaves[0].grad, rdx, torch.float32)
    assert torch.equal(leaves[1].grad, leaves[0].grad)
    torch.testing.assert_close(leaves[2].grad, rdg, **LN_PARAM_TOL)
    torch.testing.assert_close(leaves[3].grad, rdb, **LN_PARAM_TOL)


# ----------------------------------------------------------------------
# the serving engine's CUDA graphs
# ----------------------------------------------------------------------

# a 2-layer Llama narrow enough for a test and wide enough for the
# kernels (head_dim 64, GQA rep 2); buckets 16 and 32
GRAPH_NET = dict(hidden_size=256, intermediate_size=512, num_heads=4,
                 num_kv_heads=2, vocab_size=512, max_seq_len=64)
GRAPH_ENGINE = dict(max_batch=2, block_size=16, max_context=32)
GRAPH_POOLS = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, None),
               "fp8": (torch.bfloat16, "fp8")}


def _graph_engine(card, pool="f32", **kw):
    dtype, kv_dtype = GRAPH_POOLS[pool]
    net = llama_tiny(device=card, dtype=dtype, seed=3, **GRAPH_NET)
    return InferenceEngine(net, kv_dtype=kv_dtype, device=card,
                           **dict(GRAPH_ENGINE, **kw))


def _bucket(eng, pos):
    return next(b for b in eng.buckets if pos < b) // eng.block_size


@pytest.mark.parametrize("pool", sorted(GRAPH_POOLS))
def test_engine_graphs_replay_the_eager_bodies(card, pool):
    """Warmup captures one graph per (kind, bucket); a prefill and 8
    decode steps across the 16 -> 32 bucket replay them, and every
    replay's outputs are bitwise those of its body run eagerly on the
    same static inputs (which writes the same K/V rows again).  The
    returned logits are not views of the static outputs: later replays
    leave them as they were."""
    eng = _graph_engine(card, pool).warmup()
    assert eng.graphs_captured() == eng.stats["compiles"] == 4
    assert eng.graph_pool_bytes() > 0
    prompt = np.random.RandomState(7).randint(0, 512, 12).tolist()
    tok, last = eng.prefill(0, prompt)
    step = eng._steps["prefill", 16]
    want_last, want_tok = eng._prefill_body(*step.args)
    assert torch.equal(last, want_last) and tok == int(want_tok[0])
    fed, outs = prompt + [tok], [(last, want_last)]
    for _ in range(8):
        pos = len(fed) - 1
        assert eng.reserve(0, pos)
        nxt, logits = eng.decode([(0, fed[-1], pos)])
        step = eng._steps["decode", _bucket(eng, pos)]
        want = eng._decode_body(*step.args)[:1]
        assert torch.equal(logits, want)
        assert int(nxt[0]) == int(torch.argmax(want[0]))
        fed.append(int(nxt[0]))
        outs.append((logits, want))
    assert eng.stats["compiles_after_warmup"] == 0
    assert all(torch.equal(got, want) for got, want in outs)
    assert eng.stats["decode_calls"] == 8


@pytest.mark.parametrize("pool", sorted(GRAPH_POOLS))
def test_engine_chunk_and_verify_graphs_replay_the_eager_bodies(card, pool):
    """Warmup also captures one chunk graph per table width and one
    verify graph per (width, table width); two chunk replays (the
    second across the 16 -> 32 bucket, after a prefix of 16) and a
    verify replay give bitwise what their bodies give run eagerly on the
    same static inputs, each replay making one K3 offset launch a layer
    (chunk) or W K5 launches a layer (verify)."""
    eng = _graph_engine(card, pool, prefill_chunk=16, spec_decode=True,
                        spec_k=3).warmup()
    layers = eng.cfg.num_layers
    assert eng.graphs_captured() == eng.stats["compiles"] == 10
    prompt = np.random.RandomState(8).randint(0, 512, 20).tolist()
    assert eng.cache.alloc(0, 0)
    for start, end, nbl in ((0, 16, 1), (16, 20, 2)):
        ops.reset_launches()
        nxt, last = eng.chunk_prefill([(0, prompt[start:end], start)])
        got = ops.launch_counts()
        assert got["flash_attention_fwd_offset"] == \
            got["flash_attention_fwd"] == layers
        assert sum(v for k, v in got.items()
                   if not k.startswith("flash_attention_fwd")) == 0
        want_last, want_tok = eng._chunk_body(*eng._steps["chunk",
                                                          nbl].args)
        # chunk_prefill returns numpy logits (bf16 widened to f32)
        assert np.array_equal(last, want_last[:1].float().cpu().numpy())
        assert int(nxt[0]) == int(want_tok[0])
    toks = [int(nxt[0]), 7, 9]
    assert eng.reserve(0, 20, 3)
    ops.reset_launches()
    out = eng.verify([(0, toks, 20)])
    got = ops.launch_counts()
    kernel = "paged_decode_attention_fp8" if pool == "fp8" \
        else "paged_decode_attention"
    assert got[kernel] == 4 * layers           # width 4
    want = eng._verify_body(*eng._steps["verify", (4, 2)].args)
    assert np.array_equal(out, want[:1].cpu().numpy())
    assert eng.stats["compiles_after_warmup"] == 0
    eng.release(0)
    eng.cache.check_leaks()


def test_engine_capture_survives_a_collection_of_another_engine(card):
    """An engine with captured graphs, dropped in a reference cycle while
    another engine captures, is not collected inside the capture: a
    collection there frees its graphs, which invalidates the capture.
    The cycle is dropped from inside the capturing body, which then runs
    a full collection wherever the collector is enabled (where it would
    run one on its own, at an allocation)."""
    import gc
    holder = [_graph_engine(card).warmup()]
    assert holder[0].graphs_captured() == 4
    eng = _graph_engine(card, prefill_chunk=16)
    mlp = eng._mlp

    def mlp_dropping_the_other(lp, x):
        if torch.cuda.is_current_stream_capturing() and holder:
            holder.clear()                     # the old engine's cycle dies
            if gc.isenabled():
                gc.collect()
        return mlp(lp, x)

    eng._mlp = mlp_dropping_the_other
    try:
        eng.warmup()
    finally:
        del eng._mlp
    assert not holder
    gc.collect()
    assert eng.graphs_captured() == eng.stats["compiles"] == 6


def test_engine_launch_counters_count_replays_not_captures(card):
    """Warmup runs each body once eagerly (counted), captures it (not
    counted) and replays it once (counted); a second warmup does
    nothing; traffic counts one launch a layer a replay."""
    eng = _graph_engine(card)
    layers, buckets = eng.cfg.num_layers, len(eng.buckets)
    ops.reset_launches()
    eng.warmup()
    want = {"flash_attention_fwd": 2 * layers * buckets,
            "paged_decode_attention": 2 * layers * buckets}
    got = ops.launch_counts()
    assert {k: got[k] for k in want} == want
    assert sum(got.values()) == sum(want.values())
    eng.warmup()
    assert ops.launch_counts() == got
    ops.reset_launches()
    prompt = list(range(1, 20))
    tok, _ = eng.prefill(0, prompt)
    for j in range(3):
        assert eng.reserve(0, len(prompt) + j)
        tok = int(eng.decode([(0, tok, len(prompt) + j)])[0][0])
    got = ops.launch_counts()
    assert got["flash_attention_fwd"] == layers
    assert got["paged_decode_attention"] == 3 * layers
    assert sum(got.values()) == 4 * layers


def test_engine_sampling_under_graphs_is_seeded_and_within_top_k(card):
    """Top-k sampling runs inside the graphs from the engine's generator:
    the same seed gives the same tokens, each among the top k of the
    logits the step returned."""
    prompt = np.random.RandomState(9).randint(0, 512, 10).tolist()
    runs = []
    for _ in range(2):
        eng = _graph_engine(card, temperature=1.0, top_k=3,
                            seed=5).warmup()
        tok, last = eng.prefill(0, prompt)
        assert tok in torch.topk(last, 3).indices.tolist()
        toks = [tok]
        for j in range(6):
            pos = len(prompt) + j
            assert eng.reserve(0, pos)
            nxt, logits = eng.decode([(0, toks[-1], pos)])
            assert int(nxt[0]) in torch.topk(logits[0], 3).indices.tolist()
            toks.append(int(nxt[0]))
        runs.append(toks)
    assert runs[0] == runs[1]
    assert eng.stats["compiles_after_warmup"] == 0


def test_engine_copy_on_write_between_replays_is_seen(card):
    """``reserve`` forks a shared block between two replays; the next
    replay attends over the copy: the forked sequence's logits equal
    the source's for the same token at the same position."""
    eng = _graph_engine(card).warmup()
    prompt = np.random.RandomState(11).randint(0, 512, 12).tolist()
    tok, _ = eng.prefill("a", prompt)
    eng.cache.adopt("b", eng.cache.table("a"), len(prompt))
    assert eng.reserve("b", len(prompt))
    assert eng.cache.cow_copies == 1
    _, lb = eng.decode([("b", tok, len(prompt))])
    assert eng.reserve("a", len(prompt))
    _, la = eng.decode([("a", tok, len(prompt))])
    assert eng.cache.table("a")[0] != eng.cache.table("b")[0]
    assert torch.equal(la, lb)


def test_paged_ticket_counters_grow_after_a_capture(card):
    """A graph captured on the ticket counters keeps them: growing the
    counters for a larger launch keeps the old buffer, and the graph's
    replay still merges its splits right even when fresh allocations
    are filled with garbage afterwards."""
    positions = [255, 3, 130, 200]
    args, scales = _split_case(card, positions, 2, torch.bfloat16, 16,
                               seed=21, KVH=2)
    want = _paged_against_plain(args, scales)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_decode_attention(*args, 128 ** -0.5, **scales)
    # the size only: a reference held here would keep the buffer alive
    dev = args[0].device                 # with its index, as K5 keys it
    held = paged_mod._ticket_counters(dev, 0).numel()
    big, big_scales = _split_case(card, [255] * (held // 2 + 1), 2,
                                  torch.bfloat16, 16, seed=22, KVH=2)
    paged_decode_attention(*big, 128 ** -0.5, **big_scales)
    assert paged_mod._ticket_counters(dev, 0).numel() > held
    junk = [torch.full((held,), 7, dtype=torch.int32, device=dev)
            for _ in range(8)]
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    del junk


# ----------------------------------------------------------------------
# BERT's geometry: K3 non-causal at head_dim 64, and tiny BERT's steps
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_bert_base_shape(card, dtype):
    """BERT-base at batch 64 x 128 tokens: (B*H = 768, L = 128, D = 64),
    non-causal, forward and backward against the plain versions."""
    q, k, v, do = _bwd_inputs(card, 768, 128, 128, 64, dtype, 768)
    out, lse = flash_attention_fwd(q, k, v, False)
    ref, ref_lse = flash_attention_plain(q, k, v, False, 64 ** -0.5)
    _close(out, ref, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    got = flash_attention_bwd(q, k, v, out, lse, do, False)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, False,
                                     64 ** -0.5)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[dtype])


def test_tiny_bert_training_card_equals_cpu(card):
    """Two Adam steps of a tiny BERT at head_dim 64 (the kernels'
    smallest) through ``autograd.record`` and
    ``Trainer(net.collect_params(), "adam")``, on the card and on the
    host from the same weights: the card runs K3 (non-causal) forward
    and backward in f32 and K2."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                         load_block_weights)
    from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kw = dict(num_layers=2, units=128, hidden_size=256, num_heads=2,
                  vocab_size=100, max_length=32, dropout=0.0,
                  use_flash=True, use_decoder=False)
        rng = np.random.RandomState(6)
        data = {"tokens": rng.randint(0, 100, (2, 32)),
                "types": rng.randint(0, 2, (2, 32)),
                "labels": rng.randint(0, 2, (2,))}
        weights, runs = None, []
        for ctx in (mx.gpu(0), mx.cpu()):
            net = get_bert_model(**kw)
            mx.random.seed(6)
            net.initialize(ctx=ctx)
            with ctx:
                x = mx.nd.array(data["tokens"], dtype="int32")
                t = mx.nd.array(data["types"], dtype="int32")
                y = mx.nd.array(data["labels"], dtype="int32")
            if weights is None:
                net(x, t)
                weights = block_weights_to_numpy(net)
            load_block_weights(net, weights)
            tr = gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
            ce = gluon.loss.SoftmaxCrossEntropyLoss()
            ops.reset_launches()
            losses = []
            for _ in range(2):
                with autograd.record():
                    loss = ce(net(x, t)[-1], y)
                loss.backward()
                tr.step(2)
                losses.append(float(loss.mean().asscalar()))
            if ctx == mx.gpu(0):
                counts = ops.launch_counts()
                assert counts["flash_attention_fwd"] == 4
                assert counts["flash_attention_bwd"] == 4
                assert counts["fused_adam_update"] == 2
            runs.append((losses, block_weights_to_numpy(net)))
        np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-4)
        for k in runs[1][1]:
            np.testing.assert_allclose(runs[0][1][k], runs[1][1][k],
                                       rtol=0, atol=1e-5, err_msg=k)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ----------------------------------------------------------------------
# the convolutional ops (plain torch calls, no kernel of the port's own):
# the card against the port's CPU path, forward and backward
# ----------------------------------------------------------------------

# bf16 through a convolution or a window: the output rounded to bf16 on
# both sides after f32 sums in different orders; gradients sum bf16
# products over the batch and the map in another order again
CONV_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
CONV_GRAD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
                 torch.bfloat16: dict(atol=1e-1, rtol=5e-2)}

CARD_OPS = {
    "conv2d-groups-dilate": ("Convolution",
                             [(2, 4, 9, 8), (6, 2, 3, 3), (6,)],
                             dict(kernel=(3, 3), stride=(1, 2),
                                  dilate=(2, 1), pad=(2, 1), num_filter=6,
                                  num_group=2)),
    "conv2d-7x7-stride2": ("Convolution", [(2, 3, 33, 33), (8, 3, 7, 7)],
                           dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                                num_filter=8, no_bias=True)),
    "conv1d": ("Convolution", [(2, 4, 9), (6, 4, 3), (6,)],
               dict(kernel=(3,), stride=(2,), pad=(1,), num_filter=6)),
    "conv3d": ("Convolution", [(1, 2, 5, 5, 4), (4, 2, 3, 2, 2)],
               dict(kernel=(3, 2, 2), pad=(1, 0, 1), num_filter=4,
                    no_bias=True)),
    "deconv2d-adj": ("Deconvolution", [(2, 4, 5, 4), (4, 3, 3, 3), (3,)],
                     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          adj=(1, 0), num_filter=3, no_bias=False)),
    "deconv2d-groups-target": ("Deconvolution",
                               [(1, 4, 4, 5), (4, 3, 4, 4)],
                               dict(kernel=(4, 4), stride=(2, 3), pad=(1, 1),
                                    num_group=2, target_shape=(9, 15),
                                    num_filter=6)),
    "deconv1d-adj-at-stride": ("Deconvolution",
                               [(2, 3, 5), (3, 2, 3), (2,)],
                               dict(kernel=(3,), stride=(1,), pad=(1,),
                                    adj=(2,), num_filter=2, no_bias=False)),
    "maxpool-stem": ("Pooling", [(2, 4, 17, 17)],
                     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    "maxpool-full-3d": ("Pooling", [(1, 2, 5, 4, 6)],
                        dict(kernel=(2, 2, 3), stride=(2, 1, 2),
                             pooling_convention="full")),
    "avgpool-full-exclude-pad": ("Pooling", [(2, 2, 7, 8)],
                                 dict(kernel=(3, 3), stride=(2, 2),
                                      pad=(1, 1), pool_type="avg",
                                      count_include_pad=False,
                                      pooling_convention="full")),
    "avgpool-1d": ("Pooling", [(2, 3, 10)],
                   dict(kernel=(3,), stride=(2,), pad=(1,),
                        pool_type="avg")),
    "sumpool": ("Pooling", [(2, 3, 6, 7)],
                dict(kernel=(2, 3), stride=(1, 2), pool_type="sum")),
    "lppool": ("Pooling", [(2, 2, 6, 6)],
               dict(kernel=(2, 2), stride=(2, 2), pool_type="lp",
                    p_value=2)),
    "global-avg": ("Pooling", [(4, 8, 7, 7)],
                   dict(global_pool=True, pool_type="avg")),
    "batchnorm-op": ("BatchNorm", [(4, 3, 5, 5), (3,), (3,), (3,), (3,)],
                     dict(fix_gamma=False)),
    "instancenorm": ("InstanceNorm", [(2, 3, 5, 6), (3,), (3,)], dict()),
    "groupnorm": ("GroupNorm", [(2, 6, 4, 5), (6,), (6,)],
                  dict(num_groups=3)),
    "pad-reflect": ("Pad", [(2, 3, 4, 5)],
                    dict(mode="reflect",
                         pad_width=(0, 0, 0, 0, 3, 1, 2, 2))),
    "pad-edge": ("Pad", [(2, 3, 4, 5)],
                 dict(mode="edge", pad_width=(0, 0, 0, 0, 2, 1, 0, 3))),
    "space-to-depth": ("space_to_depth", [(2, 3, 6, 4)],
                       dict(block_size=2)),
}


def _op_run(op, arrays, kwargs, ct, ctx, dtype):
    """(output, input gradients) of ``op`` on ``ctx``: the data (the first
    input) and a convolution's weight in ``dtype``, the other inputs f32
    (a norm's gamma, beta and statistics)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    low = 2 if op in ("Convolution", "Deconvolution") else 1
    with ctx:
        xs = [mx.nd.array(a).astype(dtype_name(dtype) if i < low
                                    else "float32")
              for i, a in enumerate(arrays)]
        for x in xs:
            x.attach_grad()
        with autograd.record():
            y = getattr(mx.nd, op)(*xs, **kwargs)
        y.backward(mx.nd.array(ct).astype(str(y.dtype)))
    return y.data.float().cpu(), [x.grad.data.float().cpu() for x in xs]


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CARD_OPS))
def test_conv_ops_on_the_card_match_the_cpu(card, case, dtype):
    import mxnet_tpu_torch as mx
    op, shapes, kwargs = CARD_OPS[case]
    rng = np.random.RandomState(13)
    arrays = [rng.randn(*s).astype(np.float32) for s in shapes]
    if op == "BatchNorm":
        arrays[-1] = np.abs(arrays[-1]) + 0.5           # a variance
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with mx.cpu():
            shape = getattr(mx.nd, op)(*[mx.nd.array(a) for a in arrays],
                                       **kwargs).shape
        ct = rng.randn(*shape).astype(np.float32)
        y, gs = _op_run(op, arrays, kwargs, ct, mx.gpu(0), dtype)
        want_y, want_gs = _op_run(op, arrays, kwargs, ct, mx.cpu(), dtype)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    torch.testing.assert_close(y, want_y, **CONV_TOL[dtype])
    for i, (g, w) in enumerate(zip(gs, want_gs)):
        torch.testing.assert_close(g, w, **CONV_GRAD_TOL[dtype],
                                   msg=lambda m: f"input {i}: {m}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int32_pooling_on_the_card(card, dtype):
    """Integer max and sum pooling go through ``unfold`` on both
    devices: exact."""
    import mxnet_tpu_torch as mx
    x = np.random.RandomState(3).randint(-20, 20, (2, 3, 7, 6))
    for kw in (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
               dict(kernel=(3, 2), stride=(2, 2), pool_type="sum",
                    pooling_convention="full")):
        outs = []
        for ctx in (mx.gpu(0), mx.cpu()):
            with ctx:
                outs.append(mx.nd.Pooling(mx.nd.array(x, dtype="int32"),
                                          **kw).asnumpy())
        assert outs[0].dtype == np.int32
        np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_layer_on_the_card_matches_the_cpu(card, dtype):
    """Gluon BatchNorm in training mode (``native_batch_norm``, f32
    gamma, beta and statistics beside ``dtype`` activations): output,
    gradients and running statistics on the card against the CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    rng = np.random.RandomState(5)
    x = rng.randn(8, 16, 9, 9).astype(np.float32) * 3 + 1
    ct = rng.randn(*x.shape).astype(np.float32)
    runs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        bn = gluon.nn.BatchNorm(momentum=0.9, in_channels=16)
        bn.initialize(ctx=ctx)
        with ctx:
            xa = mx.nd.array(x).astype(dtype)
            xa.attach_grad()
            for _ in range(2):
                with autograd.record():
                    y = bn(xa)
                y.backward(mx.nd.array(ct).astype(dtype))
        assert str(y.dtype) == dtype
        runs.append([y.data.float().cpu(), xa.grad.data.float().cpu()] +
                    [p.data().data.float().cpu() if p.grad_req == "null"
                     else p.grad().data.float().cpu()
                     for p in bn.collect_params().values()])
    tol = CONV_TOL[getattr(torch, dtype)]
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, **tol)


def test_narrow_resnet_sgd_steps_card_equal_cpu(card):
    """Two SGD-momentum steps of a narrow bottleneck ResNet (channels 8
    to 256) through the MXNet loop on the card and on the host from the
    same weights: K1 once a step on the card, losses within 1e-4
    relative, parameters and running statistics within 1e-4."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                         load_block_weights)
    from mxnet_tpu_torch.gluon.model_zoo import vision
    prev = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.RandomState(9)
        x = rng.rand(4, 3, 64, 64).astype(np.float32)
        y = rng.randint(0, 10, (4,))
        weights, runs = None, []
        for ctx in (mx.gpu(0), mx.cpu()):
            net = vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                                  [8, 32, 64, 128, 256], classes=10)
            mx.random.seed(9)
            net.initialize(mx.init.Xavier(magnitude=2), ctx=ctx)
            with ctx:
                xa = mx.nd.array(x)
                ya = mx.nd.array(y, dtype="int32")
            if weights is None:
                net(xa)
                weights = block_weights_to_numpy(net)
            load_block_weights(net, weights)
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
            ce = gluon.loss.SoftmaxCrossEntropyLoss()
            ops.reset_launches()
            losses = []
            for _ in range(2):
                with autograd.record():
                    loss = ce(net(xa), ya)
                loss.backward()
                tr.step(4)
                losses.append(float(loss.mean().asscalar()))
            if ctx == mx.gpu(0):
                assert ops.launch_counts()["fused_sgd_update"] == 2
            runs.append((losses, block_weights_to_numpy(net)))
        np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-4)
        for k in runs[1][1]:
            np.testing.assert_allclose(runs[0][1][k], runs[1][1][k],
                                       rtol=1e-4, atol=1e-4, err_msg=k)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev


# ----------------------------------------------------------------------
# K1/K2's device scalars, and DataParallelTrainer's captured steps
# ----------------------------------------------------------------------

DEVICE_SCALAR_RULES = [("sgd", {}), ("sgd", {"momentum": 0.9}),
                       ("nag", {"momentum": 0.9}), ("adam", {}),
                       ("adamw", {})]


@pytest.mark.parametrize("clip", [None, 0.05])
@pytest.mark.parametrize("rule,hyper", DEVICE_SCALAR_RULES,
                         ids=[r if not h else f"{r}-momentum"
                              for r, h in DEVICE_SCALAR_RULES])
def test_update_device_scalars_change_without_recapture(card, rule, hyper,
                                                        clip):
    """One captured K1/K2 launch (n = 4099: head, vectors and tail),
    replayed with lr written in memory and Adam's t counted up by the
    graph itself: each replay is bitwise the eager launch at that lr and
    step, on copies of the same buffers."""
    init, apply = fused_bucket_rule(rule, clip_gradient=clip, **hyper)
    gen = torch.Generator(device=card).manual_seed(4)
    p = torch.randn(4099, device=card, generator=gen)
    g = torch.randn(4099, device=card, generator=gen)
    lr, s = _on_card(card, 1e-3, init(p))
    hp, hs = p.clone(), {k: v.clone() for k, v in s.items()}
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):          # warm-up: counters, library
        apply(p.clone(), g, {k: v.clone() for k, v in s.items()}, lr, 1e-3)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        apply(p, g, s, lr, 1e-3)
    for step, rate in enumerate((1e-3, 1e-3, 5e-4, 2e-3), start=1):
        lr.fill_(rate)
        graph.replay()
        hlr, _ = _on_card(card, rate, {})
        apply(hp, g, hs, hlr, 1e-3)
        torch.cuda.synchronize()
        assert torch.equal(p, hp), step
        for k, v in s.items():
            assert torch.equal(v, hs[k]), (k, step)
        if "t" in s:
            assert int(s["t"].item()) == step


def _dp_net(nn, dropout=0.0, batchnorm=True):
    net = nn.HybridSequential(prefix="dpc_")
    with net.name_scope():
        # no conv bias before a BatchNorm: its gradient is zero in exact
        # arithmetic, and Adam would step its rounding noise
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3,
                          use_bias=not batchnorm))
        if batchnorm:
            net.add(nn.BatchNorm(in_channels=8))
        net.add(nn.Activation("relu"), nn.GlobalAvgPool2D(), nn.Flatten())
        if dropout:
            net.add(nn.Dropout(dropout))
        net.add(nn.Dense(10, in_units=8))
    return net


def _dp_pair(rule, params, weights=None, ctx=None, **net_kw):
    """A DataParallelTrainer over a small conv net on ``ctx`` (the card
    by default), from ``weights`` when given."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.convert import load_block_weights
    ctx = ctx or mx.gpu(0)
    net = _dp_net(gluon.nn, **net_kw)
    mx.random.seed(5)
    net.initialize(mx.init.Xavier(magnitude=2), ctx=ctx)
    if weights is not None:
        load_block_weights(net, weights)
    tr = parallel.DataParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), rule, dict(params),
        mesh=parallel.make_mesh({"dp": 1}, devices=[ctx.torch_device]))
    return net, tr


def _dp_batches(n, b=8, seed=6):
    rng = np.random.RandomState(seed)
    return [(rng.rand(b, 3, 12, 12).astype(np.float32),
             rng.randint(0, 10, (b,)).astype(np.float32)) for _ in range(n)]


def _weights_np(net):
    from mxnet_tpu_torch.convert import block_weights_to_numpy
    return block_weights_to_numpy(net)


@pytest.mark.parametrize("rule,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-3})])
def test_dp_captured_steps_match_the_eager_body(card, rule, params):
    """The captured replays against the same body run eagerly on the
    card, and against the CPU: f32, 5 steps, one capture, K1/K2 once a
    step."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        net, tr = _dp_pair(rule, params)
        w0 = _weights_np(net)
        enet, etr = _dp_pair(rule, params, w0)
        etr._use_graphs = False
        import mxnet_tpu_torch as mx
        cnet, ctr = _dp_pair(rule, params, w0, ctx=mx.cpu())
        kernel = "fused_sgd_update" if rule == "sgd" else "fused_adam_update"
        ops.reset_launches()
        losses = []
        for x, y in _dp_batches(5):
            losses.append([float(t.step(x, y).asnumpy())
                           for t in (tr, etr, ctr)])
        assert ops.launch_counts()[kernel] == 10
        assert tr.stats["captures"] == 1 and tr.graphs_captured() == 1
        assert tr.stats["eager_calls"] == 1 and tr.graph_pool_bytes() > 0
        assert etr.stats["captures"] == 0
        losses = np.array(losses)
        np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=1e-5)
        np.testing.assert_allclose(losses[:, 0], losses[:, 2], rtol=1e-4)
        got, eager, cpu = (_weights_np(n) for n in (net, enet, cnet))
        for k in got:
            np.testing.assert_allclose(got[k], eager[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(got[k], cpu[k], rtol=1e-3,
                                       atol=1e-4, err_msg=k)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("rule,params", [
    ("lamb", {"learning_rate": 1e-3, "wd": 0.01}),
    ("lars", {"learning_rate": 0.1, "momentum": 0.9, "wd": 5e-5}),
    ("rmsprop", {"learning_rate": 1e-3, "centered": True})])
def test_dp_lamb_lars_rmsprop_steps_capture_without_host_sync(card, rule,
                                                              params):
    """The rules without a bucket kernel run in the captured step: LAMB's
    and LARS's per-parameter norms (``_foreach_norm`` over the flat
    buffer's views, the ratios gathered back by segment number) read no
    device value on the host, so the step captures (a synchronizing call
    makes the capture raise) and every later step replays; LAMB's step
    count advances on the device.  Held against the eager body on the
    card (1e-5) and the CPU (1e-3) over 5 steps, f32."""
    import mxnet_tpu_torch as mx
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        net, tr = _dp_pair(rule, params)
        w0 = _weights_np(net)
        enet, etr = _dp_pair(rule, params, w0)
        etr._use_graphs = False
        cnet, ctr = _dp_pair(rule, params, w0, ctx=mx.cpu())
        ops.reset_launches()
        losses = np.array([[float(t.step(x, y).asnumpy())
                            for t in (tr, etr, ctr)]
                           for x, y in _dp_batches(5)])
        assert tr.stats["captures"] == 1 and tr.graphs_captured() == 1
        assert tr.stats["eager_calls"] == 1
        assert ops.launch_counts()["fused_adam_update"] == 0
        assert ops.launch_counts()["fused_sgd_update"] == 0
        if rule == "lamb":
            assert int(tr._t.item()) == 5
        np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=1e-5)
        np.testing.assert_allclose(losses[:, 0], losses[:, 2], rtol=1e-4)
        got, eager, cpu = (_weights_np(n) for n in (net, enet, cnet))
        for k in got:
            np.testing.assert_allclose(got[k], eager[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(got[k], cpu[k], rtol=1e-3,
                                       atol=1e-4, err_msg=k)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_dp_learning_rate_and_adam_step_change_without_recapture(card):
    import mxnet_tpu_torch as mx
    net, tr = _dp_pair("adam", {"learning_rate": 1e-3})
    cnet, ctr = _dp_pair("adam", {"learning_rate": 1e-3}, _weights_np(net),
                         ctx=mx.cpu())
    for i, (x, y) in enumerate(_dp_batches(6)):
        if i == 3:
            for t in (tr, ctr):
                t.set_learning_rate(5e-3)
        for t in (tr, ctr):
            t.step(x, y)
    assert tr.stats["captures"] == 1 and int(tr._t.item()) == 6
    assert float(tr._lr_buf.item()) == np.float32(5e-3)
    got, want = _weights_np(net), _weights_np(cnet)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_dp_batchnorm_statistics_advance_per_replay(card):
    net, tr = _dp_pair("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    stat = [p for k, p in net.collect_params().items()
            if k.endswith("running_mean")][0]
    seen = []
    for x, y in _dp_batches(4):
        tr.step(x, y)
        seen.append(stat.data().asnumpy())
    assert tr.stats["captures"] == 1
    for a, b in zip(seen, seen[1:]):
        assert not np.array_equal(a, b)


def test_dp_host_sync_in_the_forward_raises_at_capture(card):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, parallel

    class Syncing(gluon.nn.HybridBlock):
        def __init__(self):
            super().__init__(prefix="sync_")
            with self.name_scope():
                self.dense = gluon.nn.Dense(3, in_units=4)

        def hybrid_forward(self, F, x):
            out = self.dense(x)
            out.asnumpy()                   # a device-to-host read
            return out

    net = Syncing()
    net.initialize(ctx=mx.gpu(0))
    tr = parallel.DataParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1},
        mesh=parallel.make_mesh({"dp": 1}, devices=[card]))
    x = np.ones((2, 4), np.float32)
    y = np.zeros((2,), np.float32)
    tr.step(x, y)                           # eager: fine
    with pytest.raises(MXNetError, match="capturing the step"):
        tr.step(x, y)


def test_dp_dropout_draws_differ_between_replays(card):
    """At lr 0 the parameters stay, so the losses of replays on one batch
    differ only by their dropout masks: they differ (the graph registers
    the generator), and with dropout 0 they are equal."""
    for dropout in (0.5, 0.0):
        net, tr = _dp_pair("sgd", {"learning_rate": 0.0}, dropout=dropout,
                           batchnorm=False)
        x, y = _dp_batches(1)[0]
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state") \
                and dropout:
            tr.step(x, y)
            with pytest.raises(NotSupportedError, match="dropout"):
                tr.step(x, y)
            continue
        losses = [float(tr.step(x, y).asnumpy()) for _ in range(5)]
        assert tr.stats["captures"] == 1
        if dropout:
            assert len(set(losses[1:])) == 4, losses
        else:
            assert len(set(losses)) == 1, losses


def test_dp_amp_replays_read_the_updated_weights(card):
    """Under bf16 AMP (autocast's cast cache off in the body) each replay
    reads the weights the last one wrote: the second replay's loss
    differs from the first's and both match the eager body's."""
    amp.init("bfloat16")
    try:
        net, tr = _dp_pair("sgd", {"learning_rate": 0.5}, batchnorm=False)
        enet, etr = _dp_pair("sgd", {"learning_rate": 0.5}, _weights_np(net),
                             batchnorm=False)
        etr._use_graphs = False
        x, y = _dp_batches(1)[0]
        losses = [[float(t.step(x, y).asnumpy()) for t in (tr, etr)]
                  for _ in range(4)]
    finally:
        amp._deinit_for_tests()
    losses = np.array(losses)
    assert losses[2, 0] != losses[1, 0]
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=2e-2)


def test_dp_step_accum_and_step_indexed_on_the_card(card):
    """``step_accum(n_micro=2)`` against ``step`` on the whole batch (no
    BatchNorm: the two compute one gradient), ``step_indexed`` against
    ``step`` on the same slice; each its own captured signature."""
    runs = []
    net0, _ = _dp_pair("sgd", {"learning_rate": 0.1}, batchnorm=False)
    w0 = _weights_np(net0)
    batches = _dp_batches(3)
    for how in ("step", "accum", "indexed"):
        net, tr = _dp_pair("sgd", {"learning_rate": 0.1}, w0,
                           batchnorm=False)
        handle = tr.put_epoch(np.stack([b[0] for b in batches]),
                              np.stack([b[1] for b in batches]))
        for i in (0, 1, 2, 1):
            x, y = batches[i]
            if how == "step":
                tr.step(x, y)
            elif how == "accum":
                tr.step_accum(x, y, n_micro=2)
            else:
                tr.step_indexed(handle, i)
        assert tr.stats["captures"] == 1
        runs.append(_weights_np(net))
    for k in runs[0]:
        np.testing.assert_allclose(runs[1][k], runs[0][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(runs[2][k], runs[0][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_dp_step_indexed_serves_every_epoch_with_one_graph(card):
    """Four epochs of one shape through ``put_epoch``/``step_indexed``,
    each handle dropped after its epoch: one capture in all, the device
    memory flat from the second epoch on (a dropped epoch is freed), and
    each step the parameters of ``step`` on the same batch."""
    net0, _ = _dp_pair("sgd", {"learning_rate": 0.1}, batchnorm=False)
    w0 = _weights_np(net0)
    inet, itr = _dp_pair("sgd", {"learning_rate": 0.1}, w0, batchnorm=False)
    snet, str_ = _dp_pair("sgd", {"learning_rate": 0.1}, w0,
                          batchnorm=False)
    allocated = []
    for e in range(4):
        batches = _dp_batches(3, seed=20 + e)
        handle = itr.put_epoch(np.stack([b[0] for b in batches]),
                               np.stack([b[1] for b in batches]))
        for i in (0, 2, 1):
            itr.step_indexed(handle, i)
            str_.step(*batches[i])
        del handle
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated(card))
    assert itr.stats["captures"] == 1 and itr.graphs_captured() == 1
    assert allocated[1] == allocated[2] == allocated[3], allocated
    got, want = _weights_np(inet), _weights_np(snet)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# ----------------------------------------------------------------------
# int8 weight serving: cuBLASLt's int8 product, QuantizedDense, engines
# ----------------------------------------------------------------------

@pytest.mark.parametrize("KN", [(4096, 1024), (4096, 14336), (14336, 4096)],
                         ids=lambda kn: f"K{kn[0]}-N{kn[1]}")
@pytest.mark.parametrize("M", [1, 8, 16, 17, 32])
def test_int8_matmul_is_exact_on_the_card(card, M, KN):
    """``int8_matmul`` on the card (cuBLASLt, rows padded past 16) equals
    the CPU's exact int32 product at Llama-3-8B's projection shapes."""
    K, N = KN
    g = torch.Generator().manual_seed(M + K + N)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, generator=g)
    b = torch.randint(-127, 128, (N, K), dtype=torch.int8, generator=g)
    got = int8_matmul(a.to(card), b.to(card))
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got.cpu(), int8_matmul(a, b))


@pytest.mark.parametrize("bad", ["K", "N"])
def test_int8_matmul_refuses_shapes_off_eight_on_the_card(card, bad):
    K, N = (36, 64) if bad == "K" else (64, 36)
    a = torch.ones(32, K, dtype=torch.int8, device=card)
    b = torch.ones(N, K, dtype=torch.int8, device=card)
    with pytest.raises(MXNetError, match="multiples of 8"):
        int8_matmul(a, b)


def test_int8_matmul_replays_in_a_captured_graph(card):
    """A captured ``quantize -> int8_matmul -> rescale`` (the engine's
    projection, M = 8 padded) replays on new inputs as it runs eagerly."""
    g = torch.Generator(device=card).manual_seed(9)
    x = torch.randn(8, 4096, device=card, generator=g)
    qw = torch.randint(-127, 128, (1024, 4096), dtype=torch.int8,
                       device=card, generator=g)
    scale = torch.tensor(0.03, device=card)

    def body():
        return int8_matmul(quantize_rtn_int8(x, scale), qw).float() * scale

    s = torch.cuda.Stream(card)
    s.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(s):
        body()
    torch.cuda.current_stream(card).wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()
    x.copy_(torch.randn(8, 4096, device=card, generator=g))
    graph.replay()
    torch.cuda.synchronize(card)
    assert torch.equal(out, body())


def test_quantized_dense_card_equals_cpu(card):
    """A ``QuantizedDense`` made on the CPU, carried to the card by
    ``convert``: the same codes, and outputs within f32 rounding (the
    int32 sums are exact; the rescale is the same f32 ops)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.convert import load_quantized_state, quantized_state
    from mxnet_tpu_torch.gluon import nn
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (24, 256)).astype(np.float32)
    nets = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        net = nn.HybridSequential()
        net.add(nn.Dense(128, activation="relu", in_units=256),
                nn.Dense(64, in_units=128))
        net.initialize(ctx=ctx)
        nets.append(net)
    cpu_net, card_net = nets
    _copy_weights(cpu_net, card_net)
    quantize_net(cpu_net, calib_data=[_nd(x, torch.device("cpu"))])
    load_quantized_state(card_net, quantized_state(cpu_net))
    want = cpu_net(_nd(x, torch.device("cpu"))).data
    got = card_net(_nd(x, card)).data
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pool", sorted(GRAPH_POOLS))
def test_int8_engine_graphs_replay_the_eager_bodies(card, pool):
    """int8 weights (calibrated on seeded token batches): the prefill and
    decode replays give bitwise what their bodies give run eagerly on
    the same static inputs; the logits are f32 whatever the net's
    dtype."""
    dtype, kv_dtype = GRAPH_POOLS[pool]
    net = llama_tiny(device=card, dtype=dtype, seed=3, **GRAPH_NET)
    calib = [np.random.RandomState(i).randint(0, 512, (2, 12))
             for i in range(2)]
    eng = InferenceEngine(net, quantize="int8", calib_data=calib,
                          kv_dtype=kv_dtype, device=card,
                          **GRAPH_ENGINE).warmup()
    assert eng.quantized and eng.graphs_captured() == 4
    prompt = np.random.RandomState(7).randint(0, 512, 12).tolist()
    tok, last = eng.prefill(0, prompt)
    want_last, want_tok = eng._prefill_body(*eng._steps["prefill", 16].args)
    assert last.dtype == torch.float32
    assert torch.equal(last, want_last) and tok == int(want_tok[0])
    fed = prompt + [tok]
    for _ in range(8):
        pos = len(fed) - 1
        assert eng.reserve(0, pos)
        nxt, logits = eng.decode([(0, fed[-1], pos)])
        want = eng._decode_body(*eng._steps["decode",
                                            _bucket(eng, pos)].args)[:1]
        assert torch.equal(logits, want)
        fed.append(int(nxt[0]))
    assert eng.stats["compiles_after_warmup"] == 0


# ----------------------------------------------------------------------
# the serving Router: a shared KV pool and threaded replicas
# ----------------------------------------------------------------------

def _chunked_then_decoded(pre, dec, slot_pre, slot_dec, prompt, n):
    """Chunk-prefill ``prompt`` on ``pre`` (chunks of its
    ``prefill_chunk``), hand the slot's blocks to ``dec`` when it is
    another engine over the same pool (adopt, then release), and run
    ``n`` greedy decode steps there.  (first token, decode logits)."""
    C = pre.prefill_chunk
    assert pre.cache.alloc(slot_pre, 0)
    for start in range(0, len(prompt), C):
        nxt, _ = pre.chunk_prefill([(slot_pre, prompt[start:start + C],
                                     start)])
    slot = slot_pre
    if dec is not pre:
        cache = pre.cache
        m = cache.seq_len(slot_pre)
        cache.trim(slot_pre, m)
        cache.adopt(slot_dec, cache.table(slot_pre), m)
        pre.release(slot_pre)
        slot = slot_dec
    fed, logits = list(prompt) + [int(nxt[0])], []
    for _ in range(n):
        pos = len(fed) - 1
        assert dec.reserve(slot, pos)
        tok, lg = dec.decode([(slot, fed[-1], pos)])
        logits.append(lg[0].clone())
        fed.append(int(tok[0]))
    dec.release(slot)
    return fed[len(prompt)], logits


@pytest.mark.parametrize("pool", sorted(GRAPH_POOLS))
def test_shared_pool_handoff_decodes_bitwise_the_combined_engine(card,
                                                                 pool):
    """A prefill engine's chunk graphs fill blocks of a pool that a
    decode engine adopted (``kv_cache=``); the decode engine takes the
    blocks over and its first 8 decode replays give bitwise the logits
    of one combined engine on the same prompt.  Both engines replay on
    the current stream, so the decode replay reads what the chunk replay
    wrote."""
    dtype, kv_dtype = GRAPH_POOLS[pool]
    net = llama_tiny(device=card, dtype=dtype, seed=3, **GRAPH_NET)
    kw = dict(GRAPH_ENGINE, kv_dtype=kv_dtype, device=card,
              prefill_chunk=16)
    pre = InferenceEngine(net, **kw)
    dec = InferenceEngine(net, kv_cache=pre.cache, **kw)
    solo = InferenceEngine(net, **kw)
    for eng in (pre, dec, solo):
        eng.warmup()
    assert dec.cache is pre.cache and dec.cache_shared
    assert not pre.cache_shared and not solo.cache_shared
    prompt = np.random.RandomState(9).randint(0, 512, 20).tolist()
    got = _chunked_then_decoded(pre, dec, (0, 0), (1, 0), prompt, 8)
    want = _chunked_then_decoded(solo, solo, 0, 0, prompt, 8)
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    pre.cache.check_leaks()
    for eng in (pre, dec, solo):
        assert eng.stats["compiles_after_warmup"] == 0


def test_router_add_replica_while_two_workers_replay(card):
    """In threaded mode ``add_replica`` warms a third engine (capturing
    its graphs) while two workers serve: the workers are held at their
    next boundary for the warmup, the newcomer joins, and every stream
    is the one ``drive()`` gives on a fresh router."""
    from mxnet_tpu_torch.serving import Request, Router
    net = llama_tiny(device=card, dtype=torch.bfloat16, seed=3, **GRAPH_NET)

    def factory(cc):
        return InferenceEngine(net, compile_cache=cc, device=card,
                               max_batch=4, block_size=16, max_context=64,
                               prefill_chunk=16, prefix_cache=True)

    rng = np.random.RandomState(10)
    prompts = [rng.randint(0, 512, int(n)).tolist()
               for n in rng.randint(4, 24, 16)]
    ref = Router(factory, replicas=2)
    want = [ref.submit(Request(p, 40, request_id=i))
            for i, p in enumerate(prompts)]
    ref.drive()
    router = Router(factory, replicas=2).start()
    try:
        reqs = [router.submit(Request(p, 40, request_id=i))
                for i, p in enumerate(prompts)]
        rep = router.add_replica()
        assert not router.all_done()        # the workers were held
        assert rep.thread is not None and rep.engine.graphs_captured() > 0
        more = [router.submit(Request(p, 40, request_id=100 + i))
                for i, p in enumerate(prompts[:4])]
        assert router.wait_all_done(timeout=300)
    finally:
        router.stop()
    assert [r.generated for r in reqs] == [r.generated for r in want]
    assert [r.generated for r in more] == [r.generated for r in want[:4]]
    assert router.epoch == 1 and len(router.finished()) == 20
    assert router.stats()["compiles_after_warmup"] == 0
    for rep in router.replicas:
        rep.engine.cache.check_leaks(
            holders=rep.engine.prefix_cache.held_blocks())


# ----------------------------------------------------------------------
# the LLM extras: generate's captured step, the blocked cross-entropy,
# the Transformer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generate_replays_equal_the_eager_body(card, dtype, temperature):
    """One graph a signature; its replays give the tokens of the same
    step body run eagerly on the card (sampled ones from the same seeded
    generator)."""
    net = llama_tiny(device=card, dtype=dtype, seed=7, hidden_size=128,
                     num_heads=2, num_kv_heads=1, intermediate_size=256)
    prefix = np.random.RandomState(7).randint(0, 256, (3, 9))
    got = [net.generate(prefix, 12, temperature=temperature,
                        seed=3).asnumpy() for _ in range(2)]
    assert net.generate_stats()["captures"] == 1
    net._generate_graphs = False
    want = net.generate(prefix, 12, temperature=temperature,
                        seed=3).asnumpy()
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want)
    assert net.generate_stats()["captures"] == 1


def test_generate_graph_follows_weight_changes(card):
    """In-place updates are read by the same graph; weights in new
    storage are captured again; both decode what the eager body does."""
    net = llama_tiny(device=card, seed=8)
    other = llama_tiny(device=card, seed=9)
    prefix = np.random.RandomState(8).randint(0, 256, (2, 6))

    def both():
        got = net.generate(prefix, 8).asnumpy()
        net._generate_graphs = False
        want = net.generate(prefix, 8).asnumpy()
        net._generate_graphs = True
        np.testing.assert_array_equal(got, want)
        return got

    first = both()
    with torch.no_grad():
        for p, q in zip(net.collect_params().values(),
                        other.collect_params().values()):
            p.data().data.copy_(q.data().data)
    second = both()
    assert net.generate_stats()["captures"] == 1
    assert not np.array_equal(first, second)
    for p in net.collect_params().values():
        p._bind(p.data().data.clone() * 0.5)
    both()
    assert net.generate_stats()["captures"] == 2
    assert net.generate_stats()["graphs"] == 1


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_blocked_cross_entropy_card_equals_cpu(card, wdtype):
    from mxnet_tpu_torch.ops import fused_linear_cross_entropy
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.RandomState(9)
        x = torch.from_numpy(rng.randn(300, 128).astype(np.float32))
        w = torch.from_numpy((rng.randn(128, 5000) * 0.05)
                             .astype(np.float32)).to(wdtype)
        t = torch.from_numpy(rng.randint(-5, 5005, 300))
        out = []
        for dev in (card, torch.device("cpu")):
            xd = x.to(dev).requires_grad_(True)
            wd = w.to(dev).requires_grad_(True)
            loss = fused_linear_cross_entropy(xd, wd, t.to(dev), 1024,
                                              ignore_index=3)
            loss.sum().backward()
            out.append([loss.detach().cpu(), xd.grad.cpu(),
                        wd.grad.float().cpu()])
        for a, b in zip(*out):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_transformer_adam_step_card_equals_cpu(card):
    """One Adam step of a narrow Transformer (2 + 2 layers, 64 units,
    masked by valid lengths) on the card and on the host from the same
    weights: logits and parameters agree, and the card runs K2."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo.nlp import TransformerModel
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kw = dict(src_vocab_size=100, num_layers=2, units=64,
                  hidden_size=128, num_heads=4, max_length=64,
                  dropout=0.0, prefix="t_")
        rng = np.random.RandomState(10)
        src, tgt = rng.randint(0, 100, (4, 20)), rng.randint(0, 100, (4, 12))
        vl = np.array([20, 15, 9, 3], np.float32)
        weights, runs = None, []
        for ctx in (mx.gpu(0), mx.cpu()):
            net = TransformerModel(**kw)
            net.initialize(ctx=ctx)
            with ctx:
                s_, t_, v_ = (mx.nd.array(src, dtype="int32"),
                              mx.nd.array(tgt, dtype="int32"),
                              mx.nd.array(vl))
            if weights is None:
                net(s_, t_, v_)
                weights = block_weights_to_numpy(net)
            load_block_weights(net, weights)
            tr = gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
            ops.reset_launches()
            with autograd.record():
                out = net(s_, t_, v_)
                loss = gluon.loss.SoftmaxCrossEntropyLoss()(out, t_)
            loss.backward()
            tr.step(4)
            if ctx == mx.gpu(0):
                assert ops.launch_counts()["fused_adam_update"] == 1
            runs.append((out.asnumpy(), block_weights_to_numpy(net)))
        np.testing.assert_allclose(runs[0][0], runs[1][0], atol=1e-4,
                                   rtol=1e-4)
        for k in runs[1][1]:
            np.testing.assert_allclose(runs[0][1][k], runs[1][1][k],
                                       rtol=0, atol=1e-5, err_msg=k)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ----------------------------------------------------------------------
# hybridize(): the CachedOp's captured forward and backward against the
# same net with hybridize(active=False), on the card
# ----------------------------------------------------------------------

# each replay against the eager block: the same kernels on the same
# inputs (bitwise expected; summation order only otherwise)
CACHED_TOL = dict(rtol=1e-5, atol=1e-6)


def _cached_pair(dropout=0.0, batchnorm=True):
    """A small conv net twice on the card, the same weights: the first
    hybridized, the second not."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    nets = []
    for active in (True, False):
        net = _dp_net(gluon.nn, dropout=dropout, batchnorm=batchnorm)
        mx.random.seed(5)
        net.initialize(mx.init.Xavier(magnitude=2), ctx=mx.gpu(0))
        net.hybridize(active=active)
        nets.append(net)
    load_block_weights(nets[1], _weights_np(nets[0]))
    return nets


def _recorded(net, x, calls=1):
    """``calls`` recorded forwards of ``x`` summed into one loss and its
    backward: (first output, parameter gradients, input gradient)."""
    import mxnet_tpu_torch as mx
    xx = mt_nd.array(x, ctx=mx.gpu(0))
    xx.attach_grad()
    with mt_autograd.record():
        outs = [net(xx) for _ in range(calls)]
        loss = outs[0] * outs[0]
        for o in outs[1:]:
            loss = loss + o * o
        loss = loss.sum()
    loss.backward()
    grads = {k: p.grad().data.clone() for k, p in
             net._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    return outs[0].data, grads, xx.grad.data


def _stats_of(net):
    return {k: p.data().data.clone() for k, p in
            net._collect_params_with_prefix().items() if "running" in k}


def _assert_same(got, want):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], **CACHED_TOL,
                                       msg=k)
    else:
        torch.testing.assert_close(got, want, **CACHED_TOL)


def test_cached_op_replays_match_the_inactive_block(card):
    """Forward, gradients and running statistics of 4 training calls
    (one eager warm-up, one capture, two replays), then predict calls."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cap, eager = _cached_pair()
        for x, _ in _dp_batches(4):
            for got, want in zip(_recorded(cap, x), _recorded(eager, x)):
                _assert_same(got, want)
            _assert_same(_stats_of(cap), _stats_of(eager))
        assert cap._cached_op.stats["captures"] == 1
        assert cap._cached_op.stats["eager_calls"] == 1
        assert cap._cached_op.stats["replays"] == 3
        assert cap._cached_op.graph_pool_bytes() > 0
        import mxnet_tpu_torch as mx
        x = mt_nd.array(_dp_batches(1, seed=9)[0][0], ctx=mx.gpu(0))
        for _ in range(3):      # predict mode: warm-up, capture, replay
            _assert_same(cap(x).data, eager(x).data)
        assert cap._cached_op.stats["captures"] == 2
        assert cap._cached_op.graphs_captured() == 3
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_cached_op_dropout_draws_fresh_masks(card):
    """Replays on one input differ only by their dropout masks: they
    differ (each graph registers the generator); with dropout 0 they are
    equal."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    x = mt_nd.array(_dp_batches(1)[0][0], ctx=mx.gpu(0))
    for dropout in (0.5, 0.0):
        net = _dp_net(gluon.nn, dropout=dropout, batchnorm=False)
        net.initialize(ctx=mx.gpu(0))
        net.hybridize()
        outs = []
        for _ in range(6):
            with mt_autograd.record():
                y = net(x).sum()
            y.backward()
            outs.append(float(y.asscalar()))
        assert net._cached_op.stats["replays"] == 5
        if dropout:
            assert len(set(outs)) == 6, outs
        else:
            assert len(set(outs)) == 1, outs


def test_cached_op_two_pending_forwards_of_one_key(card):
    """A block called twice in one record(): the second forward of the
    signature captures another instance, so the first backward reads its
    own activations; the gradients equal the eager block's."""
    cap, eager = _cached_pair()
    for i, (x, _) in enumerate(_dp_batches(4)):
        for got, want in zip(_recorded(cap, x, calls=2),
                             _recorded(eager, x, calls=2)):
            _assert_same(got, want)
    assert cap._cached_op.stats["captures"] == 2
    assert cap._cached_op.stats["replays"] == 6


def test_cached_op_recaptures_after_the_trainer_moves_parameters(card):
    """The Trainer's first step moves the parameters into its flat
    buffer: the next call captures over the new addresses (no second
    warm-up), and later steps replay; the weights follow the eager
    net's."""
    from mxnet_tpu_torch import gluon
    cap, eager = _cached_pair()
    trainers = [gluon.Trainer(n.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9})
                for n in (cap, eager)]
    ops.reset_launches()
    for x, y in _dp_batches(5):
        for net, tr in zip((cap, eager), trainers):
            _recorded(net, x)
            tr.step(8)
    st = cap._cached_op.stats
    assert (st["captures"], st["eager_calls"], st["replays"]) == (1, 1, 4)
    assert ops.launch_counts()["fused_sgd_update"] == 10
    got, want = _weights_np(cap), _weights_np(eager)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_cached_op_makes_no_graph_inside_dp_or_a_capture(card):
    """A hybridized net inside DataParallelTrainer's step, inside a raw
    stream capture and under a serving engine's warm-up runs as plain
    ops: none of its blocks makes a CachedOp."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, parallel
    net = _dp_net(gluon.nn)
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    tr = parallel.DataParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1},
        mesh=parallel.make_mesh({"dp": 1}, devices=[card]))
    for x, y in _dp_batches(3):
        tr.step(x, y)
    assert tr.stats["captures"] == 1
    blocks = []
    net.apply(blocks.append)
    assert all(getattr(b, "_cached_op", None) is None for b in blocks)
    # a raw capture of the hybridized net's forward
    x = mt_nd.array(_dp_batches(1)[0][0], ctx=mx.gpu(0))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), mt_autograd.predict_mode():
        from mxnet_tpu_torch import _tape
        with _tape.inline_scope():
            want = net(x).data.clone()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph), mt_autograd.predict_mode():
        out = net(x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.data, want)
    assert all(getattr(b, "_cached_op", None) is None for b in blocks)
    # a serving engine over a hybridized Llama
    lnet = llama_tiny(device=card, dtype=torch.float32, seed=3, **GRAPH_NET)
    lnet.hybridize()
    eng = InferenceEngine(lnet, device=card, **GRAPH_ENGINE).warmup()
    tok, _ = eng.prefill(0, [1, 2, 3])
    assert eng.graphs_captured() > 0 and lnet._cached_op is None
    lblocks = []
    lnet.apply(lblocks.append)
    assert all(getattr(b, "_cached_op", None) is None for b in lblocks)


def test_cached_op_failed_capture_raises(card):
    """A forward that reads a device value on the host runs in the
    warm-up and raises at its capture: nothing falls back to eager."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    class Syncing(gluon.nn.HybridBlock):
        def __init__(self):
            super().__init__(prefix="csync_")
            with self.name_scope():
                self.dense = gluon.nn.Dense(3, in_units=4)

        def hybrid_forward(self, F, x):
            out = self.dense(x)
            out.asnumpy()                   # a device-to-host read
            return out

    net = Syncing()
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    x = mt_nd.array(np.ones((2, 4), np.float32), ctx=mx.gpu(0))
    net(x)
    with pytest.raises(MXNetError, match="capturing the forward"):
        net(x)
    assert net._cached_op.stats["eager_calls"] == 1
    assert net._cached_op.stats["replays"] == 0


def test_cached_op_second_order_gradient_raises(card):
    """``create_graph=True`` through a captured block raises
    ``NotSupportedError`` (the captured backward is not differentiable
    again); the first-order gradient equals the eager block's."""
    cap, eager = _cached_pair(batchnorm=False)
    x = _dp_batches(1)[0][0]
    for _ in range(2):
        _recorded(cap, x)
    import mxnet_tpu_torch as mx
    xs = []
    for net in (cap, eager):
        xx = mt_nd.array(x, ctx=mx.gpu(0))
        xx.attach_grad()
        with mt_autograd.record():
            y = (net(xx) ** 2).sum()
        xs.append((xx, y))
    with pytest.raises(NotSupportedError, match="create_graph"):
        mt_autograd.grad(xs[0][1], [xs[0][0]], create_graph=True)
    with mt_autograd.record():
        y = (cap(xs[0][0]) ** 2).sum()
    (g_cap,) = mt_autograd.grad(y, [xs[0][0]])
    (g_eager,) = mt_autograd.grad(xs[1][1], [xs[1][0]])
    _assert_same(g_cap.data, g_eager.data)


def _remat_footprint(card, layers):
    """Two same-weight Llamas with ``net.model.remat()``: the first's
    layers run as CachedOps, the second's inline (eager remat).  Each
    takes two recorded steps (warm-up, capture), then two more after
    the allocator's cache is emptied; returns ({name: (peak reserved,
    peak allocated)} of those two, {name: gradients}, the CachedOps)."""
    import gc
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _tape
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    kw = dict(num_layers=layers, hidden_size=256, intermediate_size=512,
              num_heads=4, num_kv_heads=2, vocab_size=512)
    nets = [llama_tiny(device=card, seed=11, **kw) for _ in range(2)]
    for net in nets:
        net.model.remat()
    rng = np.random.RandomState(11)
    tokens, labels = (mt_nd.array(rng.randint(0, 512, (8, 512)),
                                  dtype="int32", ctx=mx.gpu(0))
                      for _ in range(2))
    ce = SoftmaxCrossEntropyLoss()

    def step(net, inline):
        with mt_autograd.record():
            if inline:
                with _tape.inline_scope():
                    out = net(tokens)
            else:
                out = net(tokens)
            loss = ce(out, labels).sum()
        loss.backward()

    grads, peaks = {}, {}
    for name, net, inline in (("eager", nets[1], True),
                              ("captured", nets[0], False)):
        for _ in range(2):                      # warm-up, capture
            step(net, inline)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            step(net, inline)
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_reserved(),
                       torch.cuda.max_memory_allocated())
        grads[name] = {k: p.grad().data.clone() for k, p in
                       net._collect_params_with_prefix().items()}
    return peaks, grads, [layer._cached_op for layer in nets[0].model.layers]


def test_cached_op_per_layer_remat_llama(card):
    """``net.model.remat()`` makes each decoder layer its own CachedOp
    (checkpointed inside its captured function, in the device's shared
    pool, its outputs and gradients in the device's shared buffers):
    recorded steps give the gradients of the same remat run eagerly (the
    layers inline), and what the captured layers reserve beyond eager
    remat in steady steps (the graph pool: one layer's temporaries) does
    not grow with depth, by more than one activation from 2 to 4 layers.
    The peaks are printed: at these sizes the captured path reserves its
    pool on top of eager remat's peak."""
    from mxnet_tpu_torch import _graphs
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        extra = {}
        for layers in (2, 4):
            peaks, grads, ops_ = _remat_footprint(card, layers)
            assert all(o is not None and o.stats["captures"] == 1
                       and o.stats["replays"] == 3 for o in ops_)
            for k in grads["eager"]:
                torch.testing.assert_close(grads["captured"][k],
                                           grads["eager"][k], rtol=1e-5,
                                           atol=1e-6, msg=k)
            extra[layers] = peaks["captured"][0] - peaks["eager"][0]
            print(f"per-layer remat, {layers} layers of width 256, 8 x 512 "
                  f"tokens: peak reserved / allocated bytes, eager "
                  f"{peaks['eager']}, captured {peaks['captured']} (graph "
                  f"pool {ops_[0].graph_pool_bytes()}, shared buffers "
                  f"{_graphs.scratch_bytes(torch.device('cuda', 0))})")
            del grads, ops_
        one_activation = 8 * 512 * 256 * 4
        assert extra[4] <= extra[2] + one_activation, extra
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _spd_np(r, n=4):
    b = r.randn(2, n, n)
    return (b @ b.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def _randn(r, *shape):
    return r.randn(*shape).astype(np.float32)


# op -> (the block's body over F and its inputs, the inputs drawn from a
# RandomState, the inputs that take a gradient): the ops of the
# registry's tail and ``nd.linalg`` that need no host sync, each with the
# constants it makes (fills, Python scalars, index tensors)
_SEQ = (lambda r: [_randn(r, 5, 3, 4), np.array([2, 5, 1], np.float32)])
_CAPTURED_OPS = {
    "masked_softmax": (lambda F, x, m: F.masked_softmax(x, m, temperature=2.0),
                       lambda r: [_randn(r, 2, 3, 5), (r.rand(2, 3, 5) > 0.3)
                                  .astype(np.float32)], (0,)),
    "SequenceMask": (lambda F, x, n: F.SequenceMask(
        x, n, use_sequence_length=True, value=-1.0), _SEQ, (0,)),
    "SequenceLast": (lambda F, x, n: F.SequenceLast(
        x, n, use_sequence_length=True), _SEQ, (0,)),
    "SequenceReverse": (lambda F, x, n: F.SequenceReverse(
        x, n, use_sequence_length=True), _SEQ, (0,)),
    "GridGenerator+BilinearSampler": (
        lambda F, d, t: F.BilinearSampler(d, F.GridGenerator(
            t, transform_type="affine", target_shape=(5, 5))),
        lambda r: [_randn(r, 2, 3, 6, 6), np.array(
            [[1, 0, 0, 0, 1, 0]] * 2, np.float32) + _randn(r, 2, 6) * 0.1],
        (0, 1)),
    "SpatialTransformer": (
        lambda F, d, t: F.SpatialTransformer(d, t, target_shape=(5, 5)),
        lambda r: [_randn(r, 2, 3, 6, 6), np.array(
            [[1, 0, 0, 0, 1, 0]] * 2, np.float32) + _randn(r, 2, 6) * 0.1],
        (0, 1)),
    "shape_array": (lambda F, x: F.shape_array(x),
                    lambda r: [_randn(r, 2, 3, 5)], ()),
    "size_array": (lambda F, x: F.size_array(x),
                   lambda r: [_randn(r, 2, 3, 5)], ()),
    "hypot-scalar": (lambda F, x: F.hypot(x, 3.0),
                     lambda r: [_randn(r, 3, 4)], (0,)),
    "arctan2-scalar": (lambda F, x: F.arctan2(x, 2.0),
                       lambda r: [_randn(r, 3, 4)], (0,)),
    "logical_xor-scalar": (lambda F, x: F.logical_xor(x, 1.0),
                           lambda r: [(r.rand(3, 4) > 0.5).astype(
                               np.float32)], ()),
    "gcd-scalar": (lambda F, x: F.gcd(x, 6),
                   lambda r: [r.randint(1, 50, (3, 4)).astype(np.int32)], ()),
    "left_shift-scalar": (lambda F, x: F.left_shift(x, 2),
                          lambda r: [r.randint(0, 50, (3, 4)).astype(
                              np.int32)], ()),
    "fmod-scalar": (lambda F, x: F.fmod(x, 1.5),
                    lambda r: [_randn(r, 3, 4) * 3], (0,)),
    "LRN": (lambda F, x: F.LRN(x, nsize=3),
            lambda r: [np.abs(_randn(r, 2, 6, 4, 4))], (0,)),
    "im2col": (lambda F, x: F.im2col(x, kernel=(3, 3), pad=(1, 1)),
               lambda r: [_randn(r, 2, 3, 6, 6)], (0,)),
    "col2im": (lambda F, x: F.col2im(x, output_size=(6, 6), kernel=(3, 3),
                                     pad=(1, 1)),
               lambda r: [_randn(r, 2, 27, 36)], (0,)),
    "topk-value": (lambda F, x: F.topk(x, k=3, ret_typ="value"),
                   lambda r: [_randn(r, 3, 7)], (0,)),
    "topk-indices": (lambda F, x: F.topk(x, k=3),
                     lambda r: [np.round(_randn(r, 3, 7))], ()),
    "sort": (lambda F, x: F.sort(x, is_ascend=False),
             lambda r: [_randn(r, 3, 7)], (0,)),
    "argsort": (lambda F, x: F.argsort(x),
                lambda r: [np.round(_randn(r, 3, 7))], ()),
    "cumsum": (lambda F, x: F.cumsum(x, axis=1),
               lambda r: [_randn(r, 3, 7)], (0,)),
    "gelu": (lambda F, x: F.gelu(x), lambda r: [_randn(r, 3, 7)], (0,)),
    "interp": (lambda F, x, xp, fp: F.interp(x, xp, fp, left=-1.0,
                                             right=2.0),
               lambda r: [_randn(r, 9) * 2, np.sort(_randn(r, 5)),
                          _randn(r, 5)], (0, 2)),
    "ravel_multi_index": (lambda F, c: F.ravel_multi_index(c, shape=(4, 6)),
                          lambda r: [np.stack([r.randint(0, 4, 5), r.randint(
                              0, 6, 5)]).astype(np.float32)], ()),
    "ediff1d": (lambda F, x: F.ediff1d(x, to_begin=0.5, to_end=[1.0, 2.0]),
                lambda r: [_randn(r, 3, 4)], (0,)),
    "gather_nd": (lambda F, x, i: F.gather_nd(x, i),
                  lambda r: [_randn(r, 3, 4), np.array(
                      [[0, 2, 1], [3, 0, 1]], np.float32)], (0,)),
    "UpSampling": (lambda F, x: F.UpSampling(x, scale=2,
                                             sample_type="nearest"),
                   lambda r: [_randn(r, 2, 3, 4, 4)], (0,)),
    "L2Normalization": (lambda F, x: F.L2Normalization(x),
                        lambda r: [_randn(r, 2, 3, 4)], (0,)),
    "Correlation": (lambda F, a, b: F.Correlation(a, b, max_displacement=1),
                    lambda r: [_randn(r, 2, 4, 6, 6), _randn(r, 2, 4, 6, 6)],
                    (0, 1)),
    "amp_cast": (lambda F, x: F.amp_cast(x, dtype="bfloat16"),
                 lambda r: [_randn(r, 3, 4)], (0,)),
    "linalg_extracttrian": (lambda F, a: F.linalg_extracttrian(a, offset=1),
                            lambda r: [_randn(r, 2, 4, 4)], (0,)),
    "linalg_maketrian": (lambda F, v: F.linalg_maketrian(v, lower=False),
                         lambda r: [_randn(r, 2, 6)], (0,)),
    "linalg_potrf": (lambda F, a: F.linalg_potrf(a),
                     lambda r: [_spd_np(r)], (0,)),
    "linalg_potri": (lambda F, a: F.linalg_potri(F.linalg_potrf(a)),
                     lambda r: [_spd_np(r)], (0,)),
    "linalg_trsm": (lambda F, a, b: F.linalg_trsm(F.linalg_potrf(a), b),
                    lambda r: [_spd_np(r), _randn(r, 2, 4, 3)], (0, 1)),
    "linalg_inverse": (lambda F, a: F.linalg_inverse(a),
                       lambda r: [_spd_np(r)], (0,)),
    "linalg_det": (lambda F, a: F.linalg_det(a),
                   lambda r: [_spd_np(r) * 0.5], (0,)),
    "linalg_slogdet": (lambda F, a: F.linalg_slogdet(a)[1],
                       lambda r: [_spd_np(r)], (0,)),
    "linalg_gelqf": (lambda F, a: F.linalg_gelqf(a)[0] ** 2,
                     lambda r: [_randn(r, 2, 3, 5)], (0,)),
}


@pytest.mark.parametrize("op", sorted(_CAPTURED_OPS))
def test_tail_ops_capture_in_a_hybridized_block(card, op):
    """A hybridized block calling the op captures it (its second call)
    and replays it: four calls on fresh inputs, in predict mode and,
    where the op is differentiable, recording with a backward, give the
    outputs and input gradients of the same block unhybridized."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    body, draw, diff = _CAPTURED_OPS[op]

    class Net(gluon.HybridBlock):
        def hybrid_forward(self, F, *xs):
            return body(F, *xs)

    nets = []
    for active in (True, False):
        net = Net()
        net.initialize(ctx=mx.gpu(0))
        net.hybridize(active=active)
        nets.append(net)
    for recording in ((False, True) if diff else (False,)):
        for step in range(4):     # warm-up, capture, two replays
            arrays = draw(np.random.RandomState(step))
            runs = []
            for net in nets:
                xs = [mt_nd.array(a, ctx=mx.gpu(0)) for a in arrays]
                if not recording:
                    runs.append((net(*xs).data, []))
                    continue
                for i in diff:
                    xs[i].attach_grad()
                with mt_autograd.record():
                    out = net(*xs)
                head = np.random.RandomState(100 + step).randn(*out.shape)
                out.backward(mt_nd.array(head, ctx=mx.gpu(0)).astype(
                    out.dtype))
                runs.append((out.data, [xs[i].grad.data for i in diff]))
            (got, got_g), (want, want_g) = runs
            _assert_same(got, want)
            for g, w in zip(got_g, want_g):
                _assert_same(g, w)
    # each mode: one eager warm-up, one capture that replays, two replays
    modes = 2 if diff else 1
    stats = nets[0]._cached_op.stats
    assert (stats["eager_calls"], stats["captures"], stats["replays"]) == (
        modes, modes, 3 * modes), stats


@pytest.mark.parametrize("op", ["unique", "histogram", "cond",
                                "linalg_syevd"])
def test_host_sync_ops_refuse_a_capture_naming_themselves(card, op):
    """An op that reads the device from the host or shapes its output by
    the data runs eagerly, and inside a hybridized block's capture (its
    second call) raises ``MXNetError`` naming itself, as the reference
    fails under ``jit`` (``linalg_syevd`` is cuSOLVER's host-buffered
    call here, where the reference runs it under ``jit``); a stream
    capture of the bare op refuses it too."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    def call(F, x):
        if op == "unique":
            return F.unique(x)
        if op == "histogram":
            return F.histogram(x, bins=4)[0]
        if op == "linalg_syevd":      # a diagonal matrix: exact
            return F.linalg_syevd(F.linalg_makediag(x))[1]
        return F.cond(x.sum() > 0, lambda: x * 2, lambda: x - 1)

    class Net(gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return call(F, x)

    x = mt_nd.array(np.array([3, 1, 3, 2, 0, 2], np.float32), ctx=mx.gpu(0))
    want = call(mt_nd, mt_nd.array(x.asnumpy(), ctx=mx.cpu())).asnumpy()
    net = Net()
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    np.testing.assert_array_equal(net(x).asnumpy(), want)   # the warm-up
    with pytest.raises(MXNetError, match=op):
        net(x)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with pytest.raises(MXNetError, match=op):
        with torch.cuda.graph(graph, stream=stream):
            call(mt_nd, x)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(call(mt_nd, x).asnumpy(), want)


# ----------------------------------------------------------------------
# quantized training, row-sparse gradients and the contrib ops (the
# slice of ops/quant_matmul.py's training half, ndarray/sparse.py and
# ndarray/contrib.py)
# ----------------------------------------------------------------------

def _fixed_uniform(x, salt):
    """A draw of ``x``'s shape made on the host from a seed of its shape
    and salt, the same on the CPU and the card."""
    g = torch.Generator().manual_seed(salt * 100003 + x.numel())
    return torch.rand(x.shape, generator=g).to(x.device)


@pytest.mark.parametrize("M,K,N", [(8192, 768, 3072), (5, 40, 2),
                                   (16, 24, 10), (17, 8, 8), (33, 70, 2),
                                   (64, 768, 768)])
def test_quant_int8_products_padded_are_exact_on_the_card(card, M, K, N):
    """The training int8 product (``torch._int_mm``, M, K and N padded
    with zeros) and the whole quantized forward and both gradients, given
    the same draws, equal the CPU's bitwise (int32 accumulation)."""
    from mxnet_tpu_torch.ops import quant_matmul as qm
    g = torch.Generator().manual_seed(M + K + N)
    qa = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    qb = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    assert torch.equal(qm._int8_product(qa.to(card), qb.to(card)).cpu(),
                       qm._int8_product(qa, qb))
    if M > 1024:
        return
    a = torch.randn(M, K, generator=g)
    b = torch.randn(K, N, generator=g) * 0.1
    head = torch.randn(M, N, generator=g)
    outs = []
    for dev in ("cpu", card):
        ta = a.to(dev, copy=True).requires_grad_()
        tb = b.to(dev, copy=True).requires_grad_()
        y = qm.quant_matmul(ta, tb, compute_dtype="int8",
                            uniform=_fixed_uniform)
        (y * head.to(dev)).sum().backward()
        outs.append([t.detach().cpu() for t in (y, ta.grad, tb.grad)])
    for got, want in zip(*outs[::-1]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("M,K,N", [(8192, 768, 3072), (64, 768, 2),
                                   (5, 40, 2), (16, 24, 10), (33, 70, 18)])
@pytest.mark.parametrize("grad_side", [False, True],
                         ids=["e4m3-scaled-mm", "e5m2-widened"])
def test_quant_fp8_products_match_their_plain_version(card, M, K, N,
                                                      grad_side):
    """fp8 products on the card (e4m3 through ``torch._scaled_mm``, e5m2
    widened to bf16 through ``torch.mm(out_dtype=float32)``; shapes off
    16 padded) against the plain version on the same codes: the codes
    widened to f32, one f32 product without TF32, times the scales.
    e5m2 within 1e-5 of the norm (exact products summed in f32 in
    another order); e4m3 within 1e-3: cuBLASLt's fp8 GEMM sums the
    tensor cores' partial products at reduced precision before it
    promotes them to f32 (1.3e-4 seen at every shape)."""
    from mxnet_tpu_torch.ops import quant_matmul as qm
    g = torch.Generator().manual_seed(M * 3 + K + N)
    a = torch.randn(M, K, generator=g).to(card)
    b = torch.randn(K, N, generator=g).to(card) * 0.1
    qmax = qm.FP8_GRAD_MAX if grad_side else qm.FP8_MAX
    fp8 = torch.float8_e5m2 if grad_side else torch.float8_e4m3fn
    sa, sb = qm._amax_scale(a, qmax), qm._amax_scale(b, qmax)
    qa = torch.clamp(a / sa, -qmax, qmax).to(fp8)
    qb = torch.clamp(b / sb, -qmax, qmax).to(fp8)
    got = qm._fp8_product(qa, qb, sa, sb)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = (qa.float() @ qb.float()) * (sa * sb)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert got.dtype == torch.float32 and got.shape == (M, N)
    err = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert err <= (1e-5 if grad_side else 1e-3), err


def _quant_mlp(ctx, mode):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(64, activation="relu", compute_dtype=mode),
            nn.Dense(10, compute_dtype=mode))
    mx.random.seed(5)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


@pytest.mark.parametrize("mode", ["fp8", "int8"])
def test_dp_quantized_steps_capture_and_replay(card, mode):
    """``DataParallelTrainer`` over Dense layers with ``compute_dtype``:
    one capture, every later step one replay with no host sync; fp8
    (deterministic) replays equal the eager body on the card; int8's
    replays draw fresh noise from the registered generator (two replays
    of one batch from the same weights differ), its loss finite."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, parallel
    x = np.random.RandomState(1).rand(32, 48).astype(np.float32)
    y = np.random.RandomState(2).randint(0, 10, (32,)).astype(np.float32)
    runs = []
    for graphs in (True, False):
        net = _quant_mlp(mx.gpu(0), mode)
        tr = parallel.DataParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
            {"learning_rate": 1e-3},
            mesh=parallel.make_mesh({"dp": 1}, devices=[card]))
        tr._use_graphs = graphs
        runs.append(([float(tr.step(x, y).asnumpy()) for _ in range(5)],
                     _weights_np(net), tr))
    (cl, cw, ctr), (el, ew, etr) = runs
    assert ctr.stats["captures"] == 1 and ctr.graphs_captured() == 1
    assert np.isfinite(cl).all()
    if mode == "fp8":
        np.testing.assert_allclose(cl, el, rtol=1e-5)
        for k in cw:
            np.testing.assert_allclose(cw[k], ew[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    else:
        net = _quant_mlp(mx.gpu(0), mode)
        tr = parallel.DataParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.0},
            mesh=parallel.make_mesh({"dp": 1}, devices=[card]))
        losses = [float(tr.step(x, y).asnumpy()) for _ in range(4)]
        assert tr.stats["captures"] == 1
        assert losses[2] != losses[3]       # two replays, fresh draws


def test_sparse_embedding_in_a_hybridized_block_on_the_card(card):
    """A hybridized Embedding(sparse_grad=True) + Dense: the captured
    backward carries the raw (ids, rows) pair out of its graph; after the
    replay the gradient is a RowSparseNDArray of the batch's rows, equal
    to the inactive block's, and the lazy Adam leaves untouched rows
    bitwise unchanged."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray
    nets, trainers = [], []
    for active in (True, False):
        net = nn.HybridSequential()
        net.add(nn.Embedding(1000, 16, sparse_grad=True),
                nn.Dense(3, flatten=False, in_units=16))
        mx.random.seed(3)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net.hybridize(active=active)
        nets.append(net)
        trainers.append(Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.1}))
    w0 = nets[0][0].weight.data().asnumpy()
    touched = set()
    for step in range(4):
        ids = np.random.RandomState(step).randint(0, 1000, (2, 6))
        touched |= set(ids.ravel().tolist())
        grads = []
        for net, tr in zip(nets, trainers):
            with mt_autograd.record():
                loss = net(mt_nd.array(ids, ctx=mx.gpu(0))).sum()
            loss.backward()
            g = net[0].weight.grad()
            assert isinstance(g, RowSparseNDArray)
            np.testing.assert_array_equal(g.indices.asnumpy(),
                                          np.unique(ids))
            grads.append(g.values.data.clone())
            tr.step(1)
        torch.testing.assert_close(grads[0], grads[1], **CACHED_TOL)
    assert nets[0]._cached_op.stats["captures"] >= 1
    w = nets[0][0].weight.data().asnumpy()
    rest = sorted(set(range(1000)) - touched)
    np.testing.assert_array_equal(w[rest], w0[rest])
    np.testing.assert_allclose(w, nets[1][0].weight.data().asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_dp_sparse_embedding_step_captures_densely_on_the_card(card):
    """``DataParallelTrainer`` over Embedding(sparse_grad=True) + Dense
    with Adam: the row-sparse gradient made dense in the captured body
    (its backward runs on autograd's device thread), one capture, K2
    once a step; held against the eager body and against the same net
    with a dense gradient (1e-5, f32, 5 steps)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.convert import load_block_weights

    def pair(sparse, weights=None):
        net = nn.HybridSequential()
        net.add(nn.Embedding(1000, 16, sparse_grad=sparse),
                nn.Dense(10, in_units=96))
        mx.random.seed(3)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        if weights is not None:
            load_block_weights(net, weights)
        return net, parallel.DataParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
            {"learning_rate": 1e-2},
            mesh=parallel.make_mesh({"dp": 1}, devices=[card]))

    net, tr = pair(True)
    w0 = _weights_np(net)
    enet, etr = pair(True, w0)
    etr._use_graphs = False
    dnet, dtr = pair(False, w0)
    rng = np.random.RandomState(8)
    ops.reset_launches()
    losses = []
    for _ in range(5):
        ids = rng.randint(0, 1000, (8, 6)).astype(np.float32)
        y = rng.randint(0, 10, (8,)).astype(np.float32)
        losses.append([float(t.step(ids, y).asnumpy())
                       for t in (tr, etr, dtr)])
    assert tr.stats["captures"] == 1 and tr.graphs_captured() == 1
    assert ops.launch_counts()["fused_adam_update"] == 15
    losses = np.array(losses)
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=1e-5)
    np.testing.assert_allclose(losses[:, 0], losses[:, 2], rtol=1e-5)
    got, eager, dense = (_weights_np(n) for n in (net, enet, dnet))
    for (k, g), e, d in zip(got.items(), eager.values(), dense.values()):
        np.testing.assert_allclose(g, e, rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(g, d, rtol=1e-5, atol=1e-6, err_msg=k)


_CONTRIB_CAPTURED = {
    "box_nms": (lambda F, d: F.contrib.box_nms(d, overlap_thresh=0.3,
                                               topk=6, id_index=0),
                lambda r: [np.concatenate([
                    r.randint(0, 3, (2, 8, 1)), r.rand(2, 8, 1),
                    r.rand(2, 8, 2) * 0.5, r.rand(2, 8, 2) * 0.5 + 0.5],
                    -1).astype(np.float32)], ()),
    "box_iou": (lambda F, a, b: F.contrib.box_iou(a, b),
                lambda r: [_randn(r, 5, 4), _randn(r, 3, 4)], (0,)),
    "box_encode": (lambda F, s, m, a, g: F.contrib.box_encode(s, m, a, g)[0],
                   lambda r: [r.randint(-1, 2, (2, 5)).astype(np.float32),
                              r.randint(0, 3, (2, 5)).astype(np.float32),
                              np.abs(_randn(r, 2, 5, 4)),
                              np.abs(_randn(r, 2, 3, 4))], ()),
    "box_decode": (lambda F, d, a: F.contrib.box_decode(d, a),
                   lambda r: [_randn(r, 2, 5, 4),
                              np.abs(_randn(r, 2, 5, 4)) + 0.1], (0,)),
    "bipartite_matching": (
        lambda F, d: F.contrib.bipartite_matching(d, threshold=0.1)[0],
        lambda r: [r.rand(2, 4, 5).astype(np.float32)], ()),
    "ROIAlign": (lambda F, d, roi: F.contrib.ROIAlign(d, roi, (3, 3), 0.5),
                 lambda r: [_randn(r, 2, 3, 8, 8), np.array(
                     [[0, 1, 1, 9, 9], [1, 0, 2, 6, 12]], np.float32)],
                 (0,)),
    "ROIPooling": (lambda F, d, roi: F.contrib.ROIPooling(d, roi, (2, 3),
                                                          0.5),
                   lambda r: [_randn(r, 2, 3, 8, 8), np.array(
                       [[0, 1, 1, 9, 9], [1, 0, 2, 6, 12]], np.float32)],
                   (0,)),
    "MultiBoxPrior": (lambda F, d: F.contrib.MultiBoxPrior(
        d, sizes=(0.3, 0.5), ratios=(1, 2)),
        lambda r: [_randn(r, 1, 2, 4, 5)], ()),
    "MultiBoxTarget": (lambda F, a, l, p: F.contrib.MultiBoxTarget(a, l, p)[2],
                       lambda r: [np.sort(r.rand(1, 10, 4), -1).astype(
                           np.float32)[..., [0, 1, 2, 3]],
                           np.concatenate([r.randint(0, 2, (2, 2, 1)),
                                           np.sort(r.rand(2, 2, 4), -1)],
                                          -1).astype(np.float32),
                           _randn(r, 2, 3, 10)], ()),
    "MultiBoxDetection": (lambda F, c, l, a: F.contrib.MultiBoxDetection(
        F.softmax(c, axis=1), l, a, nms_topk=5),
        lambda r: [_randn(r, 2, 3, 10), _randn(r, 2, 40) * 0.1,
                   np.sort(r.rand(1, 10, 4), -1).astype(np.float32)], ()),
    "MultiProposal": (lambda F, c, b, i: F.contrib.MultiProposal(
        c, b, i, rpn_pre_nms_top_n=30, rpn_post_nms_top_n=8,
        scales=(2, 4), feature_stride=4, rpn_min_size=2),
        lambda r: [r.rand(2, 12, 4, 5).astype(np.float32),
                   _randn(r, 2, 24, 4, 5) * 0.1,
                   np.array([[16, 20, 1], [15, 18, 1]], np.float32)], ()),
    "getnnz": (lambda F, x: F.contrib.getnnz(F.relu(x), axis=1),
               lambda r: [_randn(r, 3, 6)], ()),
    "quantize": (lambda F, x, lo, hi: F.contrib.quantize(x, lo, hi),
                 lambda r: [_randn(r, 3, 4), np.array([-1], np.float32),
                            np.array([1], np.float32)], ()),
    "arange_like": (lambda F, x: F.contrib.arange_like(x, axis=1) + x,
                    lambda r: [_randn(r, 3, 4)], (0,)),
    "fused_gelu": (lambda F, x: F.contrib.fused_gelu(x),
                   lambda r: [_randn(r, 3, 4)], (0,)),
    "BilinearResize2D": (lambda F, x: F.contrib.BilinearResize2D(
        x, height=7, width=3), lambda r: [_randn(r, 2, 3, 5, 6)], (0,)),
    "AdaptiveAvgPooling2D": (lambda F, x: F.contrib.AdaptiveAvgPooling2D(
        x, output_size=(2, 3)), lambda r: [_randn(r, 2, 3, 7, 5)], (0,)),
    "DeformableConvolution": (
        lambda F, x, o, w: F.contrib.DeformableConvolution(
            x, o, w, kernel=(3, 3), pad=(1, 1), num_filter=4, no_bias=True),
        lambda r: [_randn(r, 2, 3, 6, 6), _randn(r, 2, 18, 6, 6),
                   _randn(r, 4, 3, 3, 3)], (0, 1, 2)),
    "index_copy": (lambda F, x, i, n: F.contrib.index_copy(x, i, n),
                   lambda r: [_randn(r, 5, 3), np.array([3, 0], np.float32),
                              _randn(r, 2, 3)], (0, 2)),
    "index_array": (lambda F, x: F.contrib.index_array(x),
                    lambda r: [_randn(r, 2, 3)], ()),
    "allclose": (lambda F, a, b: F.contrib.allclose(a, b),
                 lambda r: [_randn(r, 3, 4), _randn(r, 3, 4)], ()),
    "gradientmultiplier": (lambda F, x: F.contrib.gradientmultiplier(
        x, scalar=-0.5), lambda r: [_randn(r, 3, 4)], (0,)),
    "fft+ifft": (lambda F, x: F.contrib.ifft(F.contrib.fft(x)),
                 lambda r: [_randn(r, 3, 8)], (0,)),
    "count_sketch": (lambda F, x, h, s: F.contrib.count_sketch(
        x, h, s, out_dim=4), lambda r: [_randn(r, 3, 6), np.array(
            [0, 3, 1, 3, 2, 0], np.float32), np.array(
            [1, -1, -1, 1, 1, -1], np.float32)], (0,)),
    "quadratic": (lambda F, x: F.contrib.quadratic(x, 0.5, -1.0, 2.0),
                  lambda r: [_randn(r, 3, 4)], (0,)),
    "div_sqrt_dim": (lambda F, x: F.contrib.div_sqrt_dim(x),
                     lambda r: [_randn(r, 3, 4)], (0,)),
}


@pytest.mark.parametrize("op", sorted(_CONTRIB_CAPTURED))
def test_contrib_ops_capture_in_a_hybridized_block(card, op):
    """Every contrib op but ``boolean_mask`` and ``edge_id`` captures in
    a hybridized block and replays: four calls (warm-up, capture, two
    replays) on fresh inputs give the outputs, and where differentiable
    the input gradients, of the block unhybridized."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    body, draw, diff = _CONTRIB_CAPTURED[op]

    class Net(gluon.HybridBlock):
        def hybrid_forward(self, F, *xs):
            return body(F, *xs)

    nets = []
    for active in (True, False):
        net = Net()
        net.initialize(ctx=mx.gpu(0))
        net.hybridize(active=active)
        nets.append(net)
    for recording in ((False, True) if diff else (False,)):
        for step in range(4):
            arrays = draw(np.random.RandomState(step))
            runs = []
            for net in nets:
                xs = [mt_nd.array(a, ctx=mx.gpu(0)) for a in arrays]
                if not recording:
                    runs.append((net(*xs).data, []))
                    continue
                for i in diff:
                    xs[i].attach_grad()
                with mt_autograd.record():
                    out = net(*xs)
                head = np.random.RandomState(100 + step).randn(*out.shape)
                out.backward(mt_nd.array(head, ctx=mx.gpu(0)).astype(
                    out.dtype))
                runs.append((out.data, [xs[i].grad.data for i in diff]))
            (got, got_g), (want, want_g) = runs
            _assert_same(got, want)
            for g, w in zip(got_g, want_g):
                _assert_same(g, w)
    assert nets[0]._cached_op.stats["captures"] >= 1


@pytest.mark.parametrize("op", ["boolean_mask", "edge_id"])
def test_contrib_host_ops_refuse_a_capture(card, op):
    """``boolean_mask`` (its output size from the data) and ``edge_id``
    (host numpy) run eagerly and refuse a CUDA graph capture, naming
    themselves."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import sparse as sp
    x = mt_nd.array(np.arange(12, dtype=np.float32).reshape(4, 3),
                    ctx=mx.gpu(0))
    m = mt_nd.array(np.array([1, 0, 1, 1], np.float32), ctx=mx.gpu(0))
    adj = sp.csr_matrix(np.eye(4, dtype=np.float32), ctx=mx.gpu(0))

    def call():
        if op == "boolean_mask":
            return mt_nd.contrib.boolean_mask(x, m)
        return mt_nd.contrib.edge_id(adj, np.array([0, 1]),
                                     np.array([0, 2]))
    eager = call().asnumpy()
    assert eager.shape[0] in (3, 2)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with pytest.raises(MXNetError, match=op):
        with torch.cuda.graph(graph, stream=stream):
            call()
    torch.cuda.synchronize()


# ----------------------------------------------------------------------
# the surface modules and gluon.data on the card
# ----------------------------------------------------------------------

def _cuda_flag(x):
    """A sample's transform in a process worker: the image and whether
    CUDA is initialized in that process."""
    return np.full((2,), float(torch.cuda.is_initialized()), np.float32)


def test_loader_pins_and_copies_batches_to_the_card(card, monkeypatch):
    """With ``pin_memory`` each batch crosses through pinned memory in a
    non-blocking copy, on the calling thread, and lands on the context
    iteration started under; the batches equal the host loader's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import data as gdata
    from mxnet_tpu_torch.gluon.data.vision import transforms as T
    rng = np.random.RandomState(0)
    ds = gdata.ArrayDataset(
        rng.randint(0, 256, (24, 16, 16, 3)).astype(np.uint8),
        rng.randint(0, 10, 24).astype(np.int32)).transform_first(
            T.Compose([T.ToTensor(), T.Normalize(0.5, 0.25)]))
    pinned, threads = [], []
    real = torch.Tensor.pin_memory

    def spy(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        pinned.append(out.is_pinned())
        threads.append(threading.current_thread())
        return out
    monkeypatch.setattr(torch.Tensor, "pin_memory", spy)
    runs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        np.random.seed(3)
        with ctx:
            loader = gdata.DataLoader(ds, batch_size=8, shuffle=True,
                                      num_workers=2, pin_memory=True)
            batches = list(loader)
        assert all(d.context == ctx and l.context == ctx
                   for d, l in batches)
        runs.append([(d.asnumpy(), l.asnumpy()) for d, l in batches])
    assert pinned and all(pinned) and len(pinned) == 6      # card run only
    assert set(threads) == {threading.main_thread()}
    for (a, b), (c, d) in zip(*runs):
        assert np.array_equal(a, c) and np.array_equal(b, d)


def test_process_workers_never_touch_the_card(card):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import data as gdata
    torch.zeros(1, device=card)             # the parent has CUDA up
    ds = gdata.ArrayDataset(np.zeros((4, 2), np.float32)).transform(
        _cuda_flag)
    with mx.gpu(0):
        loader = gdata.DataLoader(ds, batch_size=2, num_workers=2,
                                  thread_pool=False)
        batches = list(loader)
    loader._mp_pool.terminate()
    loader._mp_pool.join()
    assert [b.context for b in batches] == [mx.gpu(0)] * 2
    assert all(float(b.asnumpy().max()) == 0.0 for b in batches)


def test_clip_global_norm_scales_card_gradients_in_place(card):
    """The Trainer's K1 update applies the clipped gradients: the
    parameters after the step are the plain momentum rule's on them."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn
    net = nn.Dense(8, in_units=16)
    net.initialize(ctx=mx.gpu(0))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    rng = np.random.RandomState(1)
    x = mt_nd.array(rng.randn(4, 16).astype(np.float32) * 50, ctx=mx.gpu(0))
    params = list(net.collect_params().values())
    w0 = [p.data().data.clone() for p in params]
    with mt_autograd.record():
        loss = (net(x) ** 2).sum()
    loss.backward()
    stores = [p.grad().data for p in params]
    raw = torch.cat([g.reshape(-1) for g in stores]).double()
    norm = gluon.utils.clip_global_norm([p.grad() for p in params], 1.0)
    assert isinstance(norm, float)
    np.testing.assert_allclose(norm, float(torch.linalg.vector_norm(raw)),
                               rtol=1e-5)
    assert [p.grad().data.data_ptr() for p in params] == \
        [s.data_ptr() for s in stores]
    clipped = [s.clone() for s in stores]
    np.testing.assert_allclose(float(torch.linalg.vector_norm(torch.cat(
        [c.reshape(-1) for c in clipped]).double())), 1.0, rtol=1e-5)
    before = fused_sgd_update.launches
    trainer.step(4)
    assert fused_sgd_update.launches == before + 1
    for p, w, g in zip(params, w0, clipped):
        torch.testing.assert_close(p.data().data, w - 0.1 * g / 4,
                                   rtol=1e-6, atol=1e-7)


def _smoke_softmax_op(name):
    import mxnet_tpu_torch as mx

    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            label = in_data[1].asnumpy().ravel().astype(int)
            y = out_data[0].asnumpy()
            y[np.arange(label.shape[0]), label] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))

    @mx.operator.register(name)
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()
    return name


def test_custom_op_on_the_card(card):
    """MXNet's numpy-body softmax on card arrays: its outputs and
    gradients stay on the card and match ``nd.softmax``;
    ``check_consistency``'s default runs it on cpu(0) and gpu(0)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import test_utils
    op = _smoke_softmax_op("cuda_test_softmax")
    rng = np.random.RandomState(2)
    xs = rng.randn(8, 10).astype(np.float32)
    ys = rng.randint(0, 10, 8).astype(np.float32)
    x = mt_nd.array(xs, ctx=mx.gpu(0))
    x.attach_grad()
    with mt_autograd.record():
        out = mt_nd.Custom(x, mt_nd.array(ys, ctx=mx.gpu(0)), op_type=op)
    out.backward()
    assert out.context == mx.gpu(0) and x.grad.context == mx.gpu(0)
    want = torch.softmax(torch.from_numpy(xs), -1)
    np.testing.assert_allclose(out.asnumpy(), want.numpy(), atol=1e-6)
    onehot = np.eye(10, dtype=np.float32)[ys.astype(int)]
    np.testing.assert_allclose(x.grad.asnumpy(), want.numpy() - onehot,
                               atol=1e-6)
    res = test_utils.check_consistency(
        lambda a, b: mt_nd.Custom(a, b, op_type=op),
        [mt_nd.array(xs, ctx=mx.cpu()), mt_nd.array(ys, ctx=mx.cpu())])
    assert [r.context for r in res] == [mx.cpu(), mx.gpu(0)]


def test_custom_op_in_a_hybridized_block_on_the_card(card):
    """A numpy body raises at the block's first (eager) call, before any
    capture; an NDArray body is captured as the block's own ops and its
    replays match the inactive block."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import MXNetError, gluon
    from mxnet_tpu_torch.gluon import nn
    op = _smoke_softmax_op("cuda_test_softmax_hyb")

    class Sig(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        1.0 / (1.0 + mt_nd.exp(-in_data[0])))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1.0 - y))

    @mx.operator.register("cuda_test_sigmoid")
    class SigProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Sig()

    class Net(gluon.HybridBlock):
        def __init__(self, op_type):
            super().__init__()
            self.op_type = op_type
            with self.name_scope():
                self.dense = nn.Dense(4, in_units=5)

        def hybrid_forward(self, F, x, *label):
            return F.Custom(self.dense(x), *label, op_type=self.op_type)

    rng = np.random.RandomState(3)
    x = mt_nd.array(rng.randn(2, 5).astype(np.float32), ctx=mx.gpu(0))
    net = Net(op)
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    with pytest.raises(MXNetError, match="cuda_test_softmax_hyb"):
        with mt_autograd.record():
            net(x, mt_nd.array([1.0, 2.0], ctx=mx.gpu(0)))
    assert not torch.cuda.is_current_stream_capturing()
    nets = []
    for active in (True, False):
        n = Net("cuda_test_sigmoid")
        n.initialize(ctx=mx.gpu(0))
        n.dense.weight.set_data(mt_nd.array(rng.randn(4, 5).astype(
            np.float32), ctx=mx.gpu(0)) if not nets else
            nets[0].dense.weight.data())
        n.hybridize(active=active)
        nets.append(n)
    for _ in range(3):
        outs = []
        for n in nets:
            with mt_autograd.record():
                y = n(x)
            y.backward()
            outs.append((y.data.clone(), n.dense.weight.grad().data.clone()))
        torch.testing.assert_close(outs[0][0], outs[1][0])
        torch.testing.assert_close(outs[0][1], outs[1][1])
    assert nets[0]._cached_op.stats["captures"] == 1
    assert nets[0]._cached_op.stats["replays"] >= 1


def test_debug_nans_runs_a_hybridized_block_without_capture(card):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import MXNetError, debug
    from mxnet_tpu_torch.gluon import nn
    net = nn.Dense(3, in_units=4)
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    x = mt_nd.ones((2, 4), ctx=mx.gpu(0))
    debug.set_debug_nans(True)
    try:
        for _ in range(3):
            net(x)
        assert net._cached_op is None or \
            net._cached_op.stats["captures"] == 0
        with pytest.raises(MXNetError, match="op 'log'"):
            mt_nd.log(net(x) * 0 - 1)
    finally:
        debug.set_debug_nans(False)


# ----------------------------------------------------------------------
# the input pipeline on the card: DevicePrefetcher, ImageRecordIter,
# DataLoader(prefetch_to_device=True)
# ----------------------------------------------------------------------

_JPEG8 = str(__import__("pathlib").Path(__file__).parent / "fixtures" /
             "jpeg8.rec")


def test_prefetcher_copies_on_its_stream_and_the_consumer_waits(
        card, monkeypatch):
    """Each host batch crosses on the prefetcher's own stream; the
    consumer's stream waits on its event and each delivered tensor is
    marked used there; a consumer that frees its batch and allocates
    between batches while slow work still reads it sees every value."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io as mio
    marked, waited = [], []
    real_mark, real_wait = torch.Tensor.record_stream, \
        torch.cuda.Stream.wait_event

    def mark(self, stream):
        marked.append(stream)
        return real_mark(self, stream)

    def wait(self, event):
        waited.append(self)
        return real_wait(self, event)
    monkeypatch.setattr(torch.Tensor, "record_stream", mark)
    monkeypatch.setattr(torch.cuda.Stream, "wait_event", wait)
    n, rows = 12, 2048
    host = [np.full((rows, 1024), i, np.float32) for i in range(n)]
    with mx.gpu(0):
        pf = mio.DevicePrefetcher(iter([(h, np.int32(i)) for i, h in
                                        enumerate(host)]), depth=2)
        sums = []
        for i, (x, label) in enumerate(pf):
            assert x.context == mx.gpu(0) and int(label.asnumpy()) == i
            y = x.data
            for _ in range(20):                 # slow reads of the batch
                y = torch.tanh(y @ torch.eye(1024, device=card) * 0 + y)
            sums.append(y.sum())
            del x, y
            junk = torch.full((rows, 1024), -1.0, device=card)  # reuse bait
            del junk
        cur = torch.cuda.current_stream(card)
    assert pf._stream is not None and pf._stream != cur
    for i, s in enumerate(sums):
        want = torch.full((rows, 1024), float(i), device=card)
        for _ in range(20):
            want = torch.tanh(want @ torch.eye(1024, device=card) * 0 + want)
        assert float(s) == float(want.sum()), i
    assert len(waited) == n and all(w == cur for w in waited)
    assert len(marked) == 2 * n and all(m == cur for m in marked)  # x, label
    assert pf.stats.summary()["batches"] == n


def test_image_record_iter_on_the_card(card):
    """The native path's batches on the card, directly and through a
    DevicePrefetcher, equal the host's bitwise."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io as mio
    kw = dict(data_shape=(3, 224, 224), batch_size=4, shuffle=True,
              rand_mirror=True, mean_r=123.68, mean_g=116.78,
              mean_b=103.94, std_r=58.4, std_g=57.12, std_b=57.38,
              preprocess_threads=4)
    runs = {}
    for name, ctx, prefetch in (("host", mx.cpu(), False),
                                ("card", mx.gpu(0), False),
                                ("card, prefetched", mx.gpu(0), True)):
        np.random.seed(24)
        with ctx:
            it = mio.ImageRecordIter(_JPEG8, **kw)
            assert it._use_native
            src = mio.DevicePrefetcher(it, depth=2) if prefetch else it
            batches = []
            for _ in range(2):
                for b in src:
                    assert b.data[0].context == ctx == b.label[0].context
                    batches.append((b.data[0].asnumpy(),
                                    b.label[0].asnumpy()))
                src.reset()
        runs[name] = batches
    for name, got in runs.items():
        assert len(got) == 4
        for (a, b), (c, d) in zip(got, runs["host"]):
            assert np.array_equal(a, c) and np.array_equal(b, d), name


def test_dataloader_prefetch_to_device_on_the_card(card):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import data as gdata
    from mxnet_tpu_torch.gluon.data.vision import transforms as T
    rng = np.random.RandomState(5)
    ds = gdata.ArrayDataset(
        rng.randint(0, 256, (20, 32, 32, 3)).astype(np.uint8),
        rng.randint(0, 10, 20).astype(np.int32)).transform_first(
            T.Compose([T.ToTensor(), T.Normalize(0.5, 0.25)]))
    runs = []
    for prefetch in (False, True):
        np.random.seed(6)
        with mx.gpu(0):
            loader = gdata.DataLoader(ds, batch_size=8, shuffle=True,
                                      num_workers=2, pin_memory=True,
                                      prefetch_to_device=prefetch)
            batches = list(loader)
        assert all(d.context == mx.gpu(0) == lb.context
                   for d, lb in batches)
        runs.append([(d.asnumpy(), lb.asnumpy()) for d, lb in batches])
    assert len(runs[0]) == len(runs[1]) == 3
    for (a, b), (c, d) in zip(*runs):
        assert np.array_equal(a, c) and np.array_equal(b, d)


# ----------------------------------------------------------------------
# data parallelism over more than one rank (ROADMAP §1 item 10a)
# ----------------------------------------------------------------------

def test_dist_nccl_one_rank_captured_collectives_match_eager(card, tmp_path):
    """NCCL at one rank: all_reduce, reduce_scatter_tensor and
    all_gather_into_tensor (zero.reduce_scatter_bucket's and
    all_gather_bucket's) captured in one CUDA graph replay the eager
    results bitwise."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import zero
    assert parallel.distributed_init(f"file://{tmp_path}/store", 1, 0)
    try:
        assert mx.runtime.Features().is_enabled("DIST_KVSTORE")
        gen = torch.Generator(device=card).manual_seed(0)
        src = torch.randn(1 << 20, device=card, generator=gen)
        buf, full = torch.empty_like(src), torch.empty_like(src)
        group = torch.distributed.group.WORLD

        def body():
            buf.copy_(src)
            zero.all_reduce_mean(buf, 1, group)
            shard = zero.reduce_scatter_bucket(buf, 1, "fp32", group)
            zero.all_gather_bucket(full, shard * 0.5, group)

        body()
        torch.cuda.synchronize()
        eager = (buf.clone(), full.clone())
        buf.zero_()
        full.zero_()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            body()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(buf, eager[0]) and torch.equal(full, eager[1])
        assert torch.distributed.get_backend(group) == "nccl"
    finally:
        parallel.teardown_distributed()


def test_dist_nccl_one_rank_trainer_captures_its_collectives(card,
                                                            tmp_path):
    """``DataParallelTrainer`` on the one-rank NCCL mesh: its step (the
    gradient's all_reduce and BatchNorm's statistics all_reduces inside)
    is captured once and its replays match the same body run eagerly."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, parallel
    rng = np.random.RandomState(1)
    batches = [(rng.rand(4, 3, 16, 16).astype(np.float32),
                rng.randint(0, 10, (4,)).astype(np.float32))
               for _ in range(3)]

    def net_of():
        nn = gluon.nn
        net = nn.HybridSequential(prefix="ncclnet_")
        with net.name_scope():
            net.add(nn.Conv2D(8, 3, padding=1, use_bias=False),
                    nn.BatchNorm(), nn.Activation("relu"),
                    nn.GlobalAvgPool2D(), nn.Dense(10))
        return net

    with mx.cpu():
        host = net_of()
        host.initialize(mx.init.Xavier())
        host(mx.nd.array(batches[0][0]))
        w0 = block_weights_to_numpy(host)
    assert parallel.distributed_init(f"file://{tmp_path}/store", 1, 0)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got = {}
        for graphs in (True, False):
            net = net_of()
            net.initialize(ctx=mx.gpu(0))
            load_block_weights(net, w0)
            mesh = parallel.make_mesh({"dp": 1})
            assert mesh.group is not None
            tr = parallel.DataParallelTrainer(
                net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                {"learning_rate": 0.1, "momentum": 0.9}, mesh=mesh)
            tr._use_graphs = graphs
            losses = [float(tr.step(*b).asnumpy()) for b in batches]
            assert tr.stats["captures"] == (1 if graphs else 0)
            got[graphs] = (losses, block_weights_to_numpy(net))
        np.testing.assert_allclose(got[True][0], got[False][0], rtol=1e-5)
        for k, v in got[False][1].items():
            np.testing.assert_allclose(got[True][1][k], v, rtol=1e-5,
                                       atol=1e-6)
    finally:
        torch.backends.cudnn.deterministic = prev
        parallel.teardown_distributed()


def test_dist_two_ranks_on_one_card_bitwise_and_k1_on_the_shard(card,
                                                                tmp_path):
    """Two processes share the card over gloo (eager steps: gloo's
    collectives cannot be captured): on both paths the ranks'
    parameters are bitwise equal after every step and finite (and the
    psum path's BatchNorm statistics); K1 on a
    rank's ZeRO-1 shard matches its plain version within K1's limits."""
    import pathlib
    import sys
    import mxnet_tpu_torch as mx
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    import torch_dist_worker as worker
    ops._build.build(["fused_update"])
    rng = np.random.RandomState(0)
    with mx.cpu():
        net = worker.conv_net()
        net.initialize(mx.init.Xavier())
        net(mx.nd.array(rng.rand(2, 3, 8, 8).astype(np.float32)))
        w0 = worker.weights_of(net)
    data = {}
    for b in ("0", "1"):
        data["x" + b] = rng.rand(8, 3, 8, 8).astype(np.float32)
        data["y" + b] = rng.randint(0, 10, (8,)).astype(np.float32)
    ranks = worker.run_ranks("card", 2, tmp_path, w0, data)
    for path in ("psum", "zero1"):
        # under ZeRO-1 each rank's BatchNorm statistics are its own rows'
        keys = [k for k in ranks[0] if k.startswith(f"card/{path}/")
                and not k.endswith(("use_graphs", "k1_err", "k1_scale",
                                    "k1_shard"))
                and not (path == "zero1" and "running_" in k)]
        assert keys
        for k in keys:
            assert np.isfinite(ranks[0][k]).all(), k
            assert np.array_equal(ranks[0][k], ranks[1][k]), k
        assert not bool(ranks[0][f"card/{path}/use_graphs"])
    for r in ranks:
        assert int(r["card/zero1/k1_shard"]) * 2 >= sum(
            v.size for k, v in w0.items() if "running_" not in k)
        assert float(r["card/zero1/k1_err"]) <= \
            1e-7 + 1e-6 * float(r["card/zero1/k1_scale"])



# ----------------------------------------------------------------------
# the recurrent layers, the language models, the classifiers and SSD
# (chip_smoke.py phases 40-43 at small sizes): hybridized on the card
# against the port on the CPU, f32, TF32 off
# ----------------------------------------------------------------------

@pytest.fixture
def f32_card(card):
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield card
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = prev


def _item11_pair(make, x, seed, init=None):
    """A net made by ``make()`` on the CPU (deferred shapes resolved by a
    predict-mode forward on ``x``) and one on the card from its weights,
    hybridized."""
    import mxnet_tpu_torch as mx
    host = make()
    with mx.cpu():
        mx.random.seed(seed)
        host.initialize(init or mx.init.Xavier(magnitude=2))
        with mt_autograd.predict_mode():
            host(*[mx.nd.array(a) for a in x])
    weights = block_weights_to_numpy(host)
    net = make()
    net.initialize(ctx=mx.gpu(0))
    load_block_weights(net, weights)
    net.hybridize()
    return host, net, weights


def _rel_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("mode,bi", [("lstm", True), ("gru", False)])
def test_rnn_layer_replays_match_the_cpu(f32_card, mode, bi):
    """Phase 40's check: a 2-layer fused layer, hybridized, its third
    call a replay of the captured forward and backward: outputs and
    states within 1e-5, every gradient within 1e-4 of its norm."""
    import mxnet_tpu_torch as mx
    cls = mx.gluon.rnn.LSTM if mode == "lstm" else mx.gluon.rnn.GRU
    rng = np.random.RandomState(40)
    x = rng.randn(6, 3, 5).astype(np.float32)
    n_dir = 2 if bi else 1
    h0 = [rng.randn(2 * n_dir, 3, 8).astype(np.float32)
          for _ in range(2 if mode == "lstm" else 1)]
    host, net, _ = _item11_pair(
        lambda: cls(8, 2, bidirectional=bi, input_size=5, prefix="r_"),
        [x], 40, mx.init.Uniform(0.3))

    def run(blk, ctx):
        with ctx:
            xa = mx.nd.array(x)
            st = [mx.nd.array(h) for h in h0]
        for a in [xa] + st:
            a.attach_grad()
        with mt_autograd.record():
            out, new = blk(xa, st)
            loss = (out * out).sum() + sum((s * s).sum() for s in new)
        loss.backward()
        return ([out.asnumpy()] + [s.asnumpy() for s in new],
                [a.grad.asnumpy() for a in [xa] + st] +
                [p.grad().asnumpy() for _, p in sorted(
                    blk._collect_params_with_prefix().items())])
    want = run(host, mx.cpu())
    for _ in range(3):
        got = run(net, mx.gpu(0))
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1], want[1]):
        assert _rel_err(g, w) <= 1e-4
    stats = net._cached_op.stats
    assert stats["captures"] == 1 and stats["replays"] >= 2


def test_language_model_card_matches_the_cpu_and_trains_captured(f32_card):
    """Phase 41's check at vocabulary 50: a predict-mode forward and
    backward against the CPU (loss 1e-5 relative, gradients 1e-4 of
    their norms), then three captured training steps with dropout and
    ``clip_global_norm``: finite losses, K1 once a step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import nlp
    from mxnet_tpu_torch.gluon.utils import clip_global_norm
    ops._build.build(["fused_update"])
    rng = np.random.RandomState(41)
    x = rng.randint(0, 50, (7, 4)).astype(np.float32)
    y = rng.randint(0, 50, (7, 4)).astype(np.float32)
    host, net, _ = _item11_pair(
        lambda: nlp.AWDRNN("lstm", 50, 16, 24, 3, prefix="lm_"), [x], 41)
    ce = SoftmaxCrossEntropyLoss()

    def grads(blk, ctx):
        with ctx:
            xa, ya = mx.nd.array(x), mx.nd.array(y)
        with mt_autograd.record(train_mode=False):
            loss = ce(blk(xa)[0], ya).mean()
        loss.backward()
        return float(loss.asscalar()), [p.grad().asnumpy() for _, p in
                                        sorted(blk.collect_params().items())]
    want_l, want_g = grads(host, mx.cpu())
    got_l, got_g = grads(net, mx.gpu(0))
    assert abs(got_l - want_l) <= 1e-5 * abs(want_l)
    for g, w in zip(got_g, want_g):
        assert _rel_err(g, w) <= 1e-4
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 1.0})
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    with mx.gpu(0):
        xa, ya = mx.nd.array(x), mx.nd.array(y)
    ops.reset_launches()
    losses = []
    for _ in range(3):
        with mt_autograd.record():
            loss = ce(net(xa)[0], ya).mean()
        loss.backward()
        clip_global_norm([p.grad() for p in params], 0.25)
        tr.step(1)
        losses.append(float(loss.asscalar()))
    assert np.isfinite(losses).all()
    assert ops.launch_counts()["fused_sgd_update"] == 3
    assert net._cached_op.stats["captures"] >= 1


def _chip_smoke():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the classifier test's limits, its gradients on the card against
# float64 at the card's ReLU6 gates, from its readings on an H100: the
# loss 6.8e-7 relative at worst, gradients 2.4e-5 of their norms
# (predict mode), and 6.7e-6 absolute for the training mode's out.7
# betas, zero in exact arithmetic
CLF_LOSS_RTOL, CLF_GRAD_RTOL, CLF_GRAD_ATOL = 5e-6, 1e-4, 2e-5


def test_classifier_card_matches_the_cpu(f32_card):
    """Phase 42's check on ``mobilenet_v2_0_25`` at 64 x 64, batch 16
    (He's initialization, as the smoke's ``_he_init``): predict mode
    replayed against the CPU (1e-4 x max |logit|); the loss and every
    gradient in predict and in training mode, eager on the card, against
    ``chip_smoke.mobilenet_v2_plain`` in float64 on the CPU with each
    ReLU6 passing its gradient where the card's did (the loss within
    ``CLF_LOSS_RTOL``, each gradient within ``CLF_GRAD_RTOL`` of its norm
    plus ``CLF_GRAD_ATOL``); three training steps captured against the eager
    block's on the card (1e-5, phase 16's limit)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    smoke = _chip_smoke()
    ops._build.build(["fused_update"])
    rng = np.random.RandomState(42)
    x = rng.rand(16, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.int32)
    he = mx.init.Xavier("gaussian", "in", 2)
    host, net, w0 = _item11_pair(
        lambda: vision.mobilenet_v2_0_25(classes=10), [x], 42, he)
    with mx.cpu(), mt_autograd.predict_mode():
        want = host(mx.nd.array(x)).asnumpy()
    with mx.gpu(0), mt_autograd.predict_mode():
        for _ in range(3):
            got = net(mx.nd.array(x)).asnumpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert net._cached_op.stats["replays"] >= 1
    ce = SoftmaxCrossEntropyLoss()
    for train in (False, True):
        blk = vision.mobilenet_v2_0_25(classes=10)
        blk.initialize(ctx=mx.gpu(0))
        load_block_weights(blk, w0)
        gates = smoke.relu6_gates(blk)
        with mx.gpu(0):
            xa, ya = mx.nd.array(x), mx.nd.array(y, dtype="int32")
        with mt_autograd.record(train_mode=train):
            loss = ce(blk(xa), ya).mean()
        loss.backward()
        got = {k: p.grad().asnumpy() for k, p in
               blk._collect_params_with_prefix().items()
               if p.grad_req != "null"}
        ref_l, ref, _ = smoke.mobilenet_v2_plain(w0, x, y, train, gates)
        assert abs(float(loss.asscalar()) - ref_l) <= \
            CLF_LOSS_RTOL * abs(ref_l)
        for k in ref:
            err = np.linalg.norm(got[k] - ref[k])
            assert err <= CLF_GRAD_RTOL * np.linalg.norm(ref[k]) + \
                CLF_GRAD_ATOL, (train, k, err, np.linalg.norm(ref[k]))
    runs = []
    for active in (True, False):
        blk = vision.mobilenet_v2_0_25(classes=10)
        blk.initialize(ctx=mx.gpu(0))
        load_block_weights(blk, w0)
        blk.hybridize(active)
        tr = Trainer(blk.collect_params(), "sgd",
                     {"learning_rate": 0.1, "momentum": 0.9})
        with mx.gpu(0):
            xa, ya = mx.nd.array(x), mx.nd.array(y, dtype="int32")
        ls = []
        for _ in range(3):
            with mt_autograd.record():
                loss = ce(blk(xa), ya)
            loss.backward()
            tr.step(16)
            ls.append(float(loss.mean().asscalar()))
        runs.append((ls, block_weights_to_numpy(blk)))
    (cap_l, cap_w), (eag_l, eag_w) = runs
    np.testing.assert_allclose(cap_l, eag_l, rtol=1e-5)
    for k, v in w0.items():
        du = eag_w[k] - v
        assert np.linalg.norm((cap_w[k] - v) - du) <= \
            1e-5 * np.linalg.norm(du) + 3 * np.spacing(
                np.abs(v).max()) * np.sqrt(v.size), k


def test_ssd_card_matches_the_cpu(f32_card):
    """Phase 43's check on a narrow SSD at 64 x 64: training-mode
    predictions against the CPU (1e-4), ``MultiBoxDetection`` on the
    card against the CPU's over the same inputs (ids and kept rows
    equal, scores and boxes within 1e-5), and a hybridized inference
    call captured."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.model_zoo.vision.ssd import _ResNetFeatures
    rng = np.random.RandomState(43)
    x = rng.rand(2, 3, 64, 64).astype(np.float32)

    def make():
        body = vision.ResNetV1(vision.BasicBlockV1, [1, 1, 1, 1],
                               [8, 8, 16, 32, 64], classes=10)
        return vision.SSD(_ResNetFeatures(body, 2, (16, 16)),
                          [[0.2, 0.27], [0.37, 0.45], [0.54, 0.62],
                           [0.71, 0.79]], [[1, 2, 0.5]] * 4, [-1.0] * 4,
                          ("a", "b", "c"), nms_topk=50)
    host, net, _ = _item11_pair(make, [x], 43)
    with mx.cpu(), mt_autograd.record():
        want = [a.asnumpy() for a in host(mx.nd.array(x))]
    with mx.gpu(0), mt_autograd.record():
        got = [a.asnumpy() for a in net(mx.nd.array(x))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    prob = torch.softmax(torch.from_numpy(got[0]), -1).permute(0, 2, 1) \
        .contiguous().numpy()
    dets = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        with ctx:
            dets.append(mt_nd.contrib.MultiBoxDetection(
                mx.nd.array(prob), mx.nd.array(got[1].reshape(2, -1)),
                mx.nd.array(got[2]), nms_threshold=0.45,
                nms_topk=50).asnumpy())
    np.testing.assert_array_equal(dets[1][..., 0], dets[0][..., 0])
    np.testing.assert_array_equal(dets[1][..., 1] > 0, dets[0][..., 1] > 0)
    np.testing.assert_allclose(dets[1], dets[0], rtol=1e-5, atol=1e-5)
    with mx.gpu(0), mt_autograd.predict_mode():
        for _ in range(3):
            ids, scores, boxes = net(mx.nd.array(x))
    assert ids.shape[-1] == scores.shape[-1] == 1 and boxes.shape[-1] == 4
    assert net._cached_op.stats["captures"] >= 1


# ----------------------------------------------------------------------
# the rest of the zoo (chip_smoke.py phases 44-47), narrow or small
# ----------------------------------------------------------------------

def _sgd_step(mx, net, x, loss_fn, batch, rule="sgd"):
    """One step of the Gluon loop on ``net`` at ``x`` (numpy) in the
    current context: the loss and the parameters after."""
    from mxnet_tpu_torch import gluon
    args = {"learning_rate": 1e-3} if rule == "adam" else \
        {"learning_rate": 1e-3, "momentum": 0.9, "wd": 5e-4}
    tr = gluon.Trainer(net.collect_params(), rule, args)
    with mt_autograd.record():
        loss = loss_fn(net(mx.nd.array(x)))
    loss.backward()
    tr.step(batch)
    return float(loss.mean().asscalar()), block_weights_to_numpy(net)


def _step_matches(mx, host, net, w0, x, loss_fn, batch, rule, kernel):
    """One step from ``w0`` on the CPU, on the card (``kernel`` launched
    once) and on the CPU again from ``x`` one ulp up in half of its
    elements: the loss within 1e-4 relative, and each parameter's
    update within 1e-2 of the CPU's update norm plus 1e-5 plus twice what
    the ulp moved it on the CPU (phase 43's rule: at these batches the
    BatchNorms normalize a few values a channel and rounding puts units
    across the ReLUs' kinks)."""
    runs = []
    for ctx, model, xs in ((mx.cpu(), host, x), (mx.gpu(0), net, x),
                           (mx.cpu(), host, _chip_smoke()._ulp_half(x))):
        load_block_weights(model, w0)
        before = kernel.launches
        with ctx:
            runs.append(_sgd_step(mx, model, xs, loss_fn, batch, rule))
        assert kernel.launches == before + (model is net)
    (cpu_l, cpu_w), (card_l, card_w), (_, ulp_w) = runs
    assert abs(card_l - cpu_l) <= 1e-4 * abs(cpu_l)
    for k in w0:
        if k.endswith(("running_mean", "running_var")):
            continue
        err = np.linalg.norm(card_w[k] - cpu_w[k])
        upd = np.linalg.norm(cpu_w[k] - w0[k])
        moved = np.linalg.norm(ulp_w[k] - cpu_w[k])
        assert err <= 1e-2 * upd + 1e-5 + 2 * moved, (k, err, upd, moved)


def test_yolo3_card_matches_the_cpu(f32_card):
    """Phase 44's check on ``yolo3_darknet53(classes=20)`` at 64 x 64:
    training-mode maps against the CPU (1e-4 plus twice the one-ulp
    spread), detections after
    ``box_nms`` (kept rows and ids equal, scores and boxes within 1e-3
    of the image), the inference call captured, and one SGD step (K1)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    ops._build.build(["fused_update"])
    x = np.random.RandomState(44).rand(2, 3, 64, 64).astype(np.float32)
    host, net, w0 = _item11_pair(lambda: vision.yolo3_darknet53(classes=20),
                                 [x], 44)
    with mx.cpu(), mt_autograd.predict_mode():
        want = [a.asnumpy() for a in host(mx.nd.array(x))]
    with mx.gpu(0), mt_autograd.predict_mode():
        for _ in range(3):
            got = [a.asnumpy() for a in net(mx.nd.array(x))]
    assert net._cached_op.stats["captures"] >= 1
    kept = want[1][..., 0] > 0
    np.testing.assert_array_equal(got[1][..., 0] > 0, kept)
    np.testing.assert_array_equal(got[0][kept], want[0][kept])
    np.testing.assert_allclose(got[2][kept], want[2][kept], atol=6.4e-2)
    # training mode at batch 2: the last stage normalizes 8 values a
    # channel, so the maps are held within 1e-4 plus twice what one ulp
    # of input moves the CPU's own
    maps = []
    for ctx, model, xs in ((mx.cpu(), host, x), (mx.gpu(0), net, x),
                           (mx.cpu(), host, _chip_smoke()._ulp_half(x))):
        with ctx, mt_autograd.train_mode():
            maps.append([a.asnumpy() for a in model(mx.nd.array(xs))[0]])
    for w, g, u in zip(*maps):
        assert np.all(np.abs(g - w) <= 1e-4 + 1e-4 * np.abs(w) +
                      2 * np.abs(u - w).max())

    def loss_fn(out):
        return sum(((p - 0.5) ** 2).mean() for p in out[0])
    _step_matches(mx, host, net, w0, x, loss_fn, 2, "sgd", fused_sgd_update)


def test_faster_rcnn_card_matches_the_cpu(f32_card):
    """Phase 45's check on a Faster R-CNN over a one-block-a-stage
    ``ResNetV1b`` of basic blocks at 64 x 96: the RPN's proposals on the
    card equal the CPU's over the same raw outputs, in order; the
    inference call captured; one SGD step (K1) through ``ROIAlign``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.model_zoo.vision.rcnn import _rpn_proposals
    ops._build.build(["fused_update"])
    x = np.random.RandomState(45).rand(1, 3, 64, 96).astype(np.float32)

    def make():
        base = vision.segmentation.ResNetV1b(
            [1, 1, 1, 1], dilated=False,
            block=vision.segmentation.BasicBlockV1b)
        return vision.rcnn.FasterRCNN(("a", "b", "c"), backbone=base)
    host, net, w0 = _item11_pair(make, [x], 45)
    with mx.gpu(0), mt_autograd.record():
        raw = [a.asnumpy() for a in net(mx.nd.array(x))]
    props = []
    for dev in ("cuda", "cpu"):
        r, s = _rpn_proposals(*(torch.from_numpy(raw[i]).to(dev)
                                for i in (3, 4, 5)), 2000, 300, 0.7, 64, 96)
        props.append((r.cpu().numpy(), s.cpu().numpy()))
    np.testing.assert_array_equal(props[0][1] == -1, props[1][1] == -1)
    np.testing.assert_allclose(props[0][0], props[1][0], atol=1e-4)
    np.testing.assert_allclose(props[0][1], props[1][1], atol=1e-6)
    np.testing.assert_allclose(props[0][0], raw[2], atol=1e-4)
    with mx.gpu(0), mt_autograd.predict_mode():
        for _ in range(3):
            ids, scores, boxes = net(mx.nd.array(x))
    assert net._cached_op.stats["captures"] >= 1
    assert np.isfinite(boxes.asnumpy()).all()

    def loss_fn(out):
        return (out[0] ** 2).mean() + out[1].abs().mean() + \
            (out[3] ** 2).mean() + out[4].abs().mean()
    _step_matches(mx, host, net, w0, x, loss_fn, 1, "sgd", fused_sgd_update)


def test_segmentation_card_matches_the_cpu(f32_card):
    """Phase 46's check on ``get_fcn``/``get_psp``/``get_deeplab`` (5
    classes) at 32 x 32: ``predict`` captured on the card against the
    CPU (1e-4 x max |x|); FCN with ``aux`` and its Dropouts at rate 0:
    one SGD step (K1) against the CPU, the backbone's unread classifier
    stepping by its weight decay alone on both."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    ops._build.build(["fused_update"])
    x = np.random.RandomState(46).rand(2, 3, 32, 32).astype(np.float32)
    y = np.random.RandomState(47).randint(0, 5, (2, 32, 32))
    for make in (vision.get_psp, vision.get_deeplab, vision.get_fcn):
        host = make(nclass=5)
        with mx.cpu():
            mx.random.seed(46)
            host.initialize(mx.init.Xavier(magnitude=2))
            with mt_autograd.predict_mode():
                xa = mx.nd.array(x)
                host(xa)
                host.base(xa)
                host.auxlayer(host.base.extract(xa)[0])
            want = host.predict(xa).asnumpy()
        w0 = block_weights_to_numpy(host)
        net = make(nclass=5)
        net.initialize(ctx=mx.gpu(0))
        load_block_weights(net, w0)
        net.hybridize()
        with mx.gpu(0):
            for _ in range(3):
                got = net.predict(mx.nd.array(x)).asnumpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        assert net._cached_op.stats["replays"] >= 1
    for blk in (host, net):
        blk.apply(lambda b: setattr(b, "_rate", 0.0)
                  if type(b).__name__ == "Dropout" else None)
    host.hybridize()
    ce = SoftmaxCrossEntropyLoss(axis=1)

    def loss_fn(out):
        label = mx.nd.array(y, dtype="int32", ctx=out[0].context)
        return ce(out[0], label) + ce(out[1], label)
    _step_matches(mx, host, net, w0, x, loss_fn, 2, "sgd", fused_sgd_update)


def test_simple_pose_card_matches_the_cpu(f32_card):
    """Phase 47's check on ``simple_pose_resnet18_v1b`` at 64 x 64: the
    heatmaps captured on the card against the CPU (1e-4 x max |x|),
    ``heatmap_to_coord`` on the card equal to the CPU's over the same
    heatmaps, and one Adam step (K2) against the CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    ops._build.build(["fused_update"])
    x = np.random.RandomState(47).rand(2, 3, 64, 64).astype(np.float32)
    target = np.random.RandomState(48).rand(2, 17, 16, 16).astype(np.float32)
    host, net, w0 = _item11_pair(vision.simple_pose_resnet18_v1b, [x], 47)
    with mx.cpu(), mt_autograd.predict_mode():
        want = host(mx.nd.array(x)).asnumpy()
    with mx.gpu(0), mt_autograd.predict_mode():
        for _ in range(3):
            hm = net(mx.nd.array(x))
    assert np.abs(hm.asnumpy() - want).max() <= 1e-4 * np.abs(want).max()
    assert net._cached_op.stats["replays"] >= 1
    card = [a.asnumpy() for a in vision.heatmap_to_coord(hm)]
    with mx.cpu():
        cpu = [a.asnumpy() for a in vision.heatmap_to_coord(
            mx.nd.array(hm.asnumpy()))]
    for g, w in zip(card, cpu):
        np.testing.assert_array_equal(g, w)

    def loss_fn(out):
        from mxnet_tpu_torch.gluon.loss import L2Loss
        return L2Loss()(out, mx.nd.array(target, ctx=out.context))
    _step_matches(mx, host, net, w0, x, loss_fn, 2, "adam",
                  fused_adam_update)
