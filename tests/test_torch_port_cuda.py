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

from mxnet_tpu_torch import MXNetError
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
from mxnet_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                 paged_decode_plain,
                                                 split_plan)
from mxnet_tpu_torch.ops.quant_kv import kv_quantize_fp8

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
    kp, ks = p0.clone(), init(p0)
    pp, ps = p0.clone(), init(p0)
    wrapper = fused_sgd_update if name in ("sgd", "nag") else \
        fused_adam_update
    for _ in range(3):
        grad = torch.from_numpy(rng.randn(n).astype(np.float32)).to(card)
        before = wrapper.launches
        kp, ks = apply(kp, grad, ks, 0.01, 1e-3, 0.5)
        assert wrapper.launches == before + 1
        pp, ps = plain(pp, grad, ps, 0.01, 1e-3, 0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(kp, pp, **UPDATE_TOL)
    for leaf, val in ps.items():
        if torch.is_tensor(val):
            torch.testing.assert_close(ks[leaf], val, **UPDATE_TOL)
        else:
            assert ks[leaf] == val


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
        ks = {leaf: _copy_at(val, offsets[2 + i]) if torch.is_tensor(val)
              else val for i, (leaf, val) in enumerate(s.items())}
        before = wrapper.launches
        kp, ks = apply(kp, _copy_at(g, offsets[1]), ks, 0.01, 1e-3, 0.5)
        assert wrapper.launches == before + 1
        runs.append((kp, ks))
    torch.cuda.synchronize()
    for kp, ks in runs:
        torch.testing.assert_close(kp, want_p, **UPDATE_TOL)
        for leaf, val in want_s.items():
            if torch.is_tensor(val):
                torch.testing.assert_close(ks[leaf], val, **UPDATE_TOL)
            else:
                assert ks[leaf] == val
    (p1, s1), (p2, s2) = runs
    assert torch.equal(p1, p2)
    assert all(torch.equal(s1[k], s2[k]) for k in s1 if torch.is_tensor(s1[k]))


def test_update_kernels_refuse_what_they_do_not_take(card):
    _, apply = fused_bucket_rule("adam")
    p = torch.zeros(4, 4, device=card)
    s = {"m": torch.zeros_like(p), "v": torch.zeros_like(p), "t": 0}
    with pytest.raises(MXNetError):
        apply(p, p, s, 0.1)                        # not flat
    pb = torch.zeros(16, device=card, dtype=torch.bfloat16)
    sb = {"m": torch.zeros_like(pb), "v": torch.zeros_like(pb), "t": 0}
    with pytest.raises(MXNetError):
        apply(pb, pb, sb, 0.1)                     # not f32
    flat = torch.zeros(16, device=card)
    with pytest.raises(MXNetError, match="overlap"):
        apply(flat, flat, {"m": torch.zeros_like(flat),     # p is g
                           "v": torch.zeros_like(flat), "t": 0}, 0.1)
    with pytest.raises(MXNetError, match="overlap"):
        apply(flat[:8], flat[4:12], {"m": torch.zeros(8, device=card),
                                     "v": torch.zeros(8, device=card),
                                     "t": 0}, 0.1)


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
