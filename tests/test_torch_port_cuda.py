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
