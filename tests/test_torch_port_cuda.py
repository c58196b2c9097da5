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
the plain PyTorch rule rounds twice.
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
from mxnet_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                 paged_decode_plain)

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
    (False, 48, 96), (False, 130, 70)])
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
    (True, 256, 256), (False, 48, 96), (False, 130, 70)])
def test_flash_bwd_kernel_matches_plain(card, dtype, D, causal, lq, lk):
    g = torch.Generator(device=card).manual_seed(lq * 5 + lk + D)
    q = torch.randn(4, lq, D, device=card, generator=g).to(dtype)
    k = torch.randn(4, lk, D, device=card, generator=g).to(dtype)
    v = torch.randn(4, lk, D, device=card, generator=g).to(dtype)
    do = torch.randn(4, lq, D, device=card, generator=g).to(dtype)
    out, lse = flash_attention_fwd(q, k, v, causal)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal, D ** -0.5)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[dtype])


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
