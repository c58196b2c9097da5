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


def test_llama_training_step_card_equals_cpu(card):
    """Two SGD-momentum steps of a small Llama (head_dim 64, the
    kernels' smallest) on the card and on the host from the same
    weights: the card runs flash fwd/bwd and K1."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kw = dict(hidden_size=128, num_heads=2, num_kv_heads=1,
                  intermediate_size=256, num_layers=2)
        on_card = llama_tiny(device=card, seed=4, **kw)
        on_cpu = llama_tiny(device="cpu", seed=None, **kw)
        on_cpu.load_state_dict(on_card.state_dict())
        rng = np.random.RandomState(4)
        tokens = torch.from_numpy(rng.randint(0, 256, (2, 48)))
        labels = torch.from_numpy(rng.randint(0, 256, (2, 48)))
        losses = []
        for net in (on_card, on_cpu):
            dev = next(net.parameters()).device
            tr = Trainer(dict(net.named_parameters()), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9})
            run = []
            for _ in range(2):
                loss = SoftmaxCrossEntropyLoss()(
                    net(tokens.to(dev)), labels.to(dev))
                loss.sum().backward()
                tr.step(2)
                run.append(float(loss.mean()))
            losses.append(run)
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
        for (name, a), (_, b) in zip(on_card.named_parameters(),
                                     on_cpu.named_parameters()):
            torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0,
                                       msg=name)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_trainer_flat_bucket_after_a_stale_step_still_launches_k1(card):
    """A step that skips a stale parameter and the full step after it
    each update as one flat bucket: one K1 launch per step."""
    kw = dict(hidden_size=128, num_heads=2, num_kv_heads=1,
              intermediate_size=256, num_layers=1)
    net = llama_tiny(device=card, seed=6, **kw)
    params = dict(net.named_parameters())
    tr = Trainer(params, "sgd", {"learning_rate": 0.1, "momentum": 0.9})
    tokens = torch.from_numpy(
        np.random.RandomState(6).randint(0, 256, (2, 16))).to(card)
    before = params["model.norm.weight"].detach().clone()
    for step in range(2):
        SoftmaxCrossEntropyLoss()(net(tokens), tokens).sum().backward()
        launches = fused_sgd_update.launches
        if step == 0:
            params["model.norm.weight"].grad = None
            tr.step(2, ignore_stale_grad=True)
            assert torch.equal(params["model.norm.weight"], before)
        else:
            tr.step(2)
        assert fused_sgd_update.launches == launches + 1
    assert not torch.equal(params["model.norm.weight"], before)


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
    on_cpu = llama_tiny(device="cpu", seed=None, **AMP_NET)
    on_cpu.load_state_dict(on_card.state_dict())
    w0 = {k: p.detach().clone() for k, p in on_cpu.named_parameters()}
    rng = np.random.RandomState(11)
    tokens = torch.from_numpy(rng.randint(0, 256, (2, 64)))
    labels = torch.from_numpy(rng.randint(0, 256, (2, 64)))
    amp.init("bfloat16")
    try:
        first, updates = [], []
        for net in (on_card, on_cpu):
            dev = next(net.parameters()).device
            tr = Trainer(dict(net.named_parameters()), "adamw",
                         {"learning_rate": 1e-3, "wd": 0.1})
            amp.init_trainer(tr)
            ptrs = [p.data_ptr() for p in net.parameters()]
            for step in range(2):
                logits = net(tokens.to(dev))
                loss = SoftmaxCrossEntropyLoss()(logits, labels.to(dev))
                with amp.scale_loss(loss.sum(), tr) as scaled:
                    scaled.backward()
                assert logits.dtype == loss.dtype == torch.bfloat16
                assert all(p.grad.dtype == torch.float32
                           for p in net.parameters())
                tr.step(2)
                if step == 0:
                    first.append(float(loss.float().mean()))
                assert bool(torch.isfinite(loss.float()).all())
            assert [p.data_ptr() for p in net.parameters()] == ptrs
            updates.append({k: p.detach().cpu() - w0[k]
                            for k, p in net.named_parameters()})
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
    tr = Trainer(dict(net.named_parameters()), "adamw",
                 {"learning_rate": 1e-3})
    tokens = torch.from_numpy(
        np.random.RandomState(12).randint(0, 256, (2, 64))).to(card)
    amp.init("bfloat16")
    try:
        amp.init_trainer(tr)
        ops.reset_launches()
        SoftmaxCrossEntropyLoss()(net(tokens), tokens).sum().backward()
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
            net(torch.zeros(1, 16, dtype=torch.int64, device=card))
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
