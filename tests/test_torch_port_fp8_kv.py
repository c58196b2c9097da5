"""The port's fp8 KV cache against the JAX package, on the CPU.

Inputs come from numpy with a seed and go to both packages; Llama
weights are carried across by ``mxnet_tpu_torch.convert``.  Tolerances,
with their reasons:

- ``kv_quantize_fp8`` codes and scales are bitwise the reference's
  (the same f32 division and round-to-nearest cast), and so is
  ``kv_dequantize``;
- the plain fp8 paged attention against the reference's ``_fallback``
  on identical codes and scales: 1e-5 for an f32 query (only the
  summation order differs), 8e-3 for a bf16 query (one bf16 ulp of the
  output);
- the fp8 engine against the JAX fp8 engine, teacher-forced: the first
  token is identical (prefill attends over the fresh K/V), decode logits
  within 2e-2 (each package quantizes its own f32 K/V, and a value near
  an e4m3 rounding midpoint may round to the other code, a 6% step in
  that one element); the port's own fp8-vs-f32 drift lies in (0, 0.1],
  the reference's gate (``tests/test_quant_kv.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.nlp.llama import (
    LlamaConfig as JaxConfig, LlamaForCausalLM as JaxLlama)
from mxnet_tpu.ops import quant_kv as jqkv
from mxnet_tpu.ops.paged_attention import _fallback as jax_paged_fallback
from mxnet_tpu.serving import (InferenceEngine as JaxEngine,
                               PagedKVCache as JaxCache)

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_llama_decode_weights
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                       LlamaForCausalLM)
from mxnet_tpu_torch.ops import quant_kv as qkv
from mxnet_tpu_torch.ops.paged_attention import paged_decode_attention
from mxnet_tpu_torch.serving import InferenceEngine, PagedKVCache
from test_torch_port_amp import seeded

# the reference's weights are drawn under this seed of its global key
# (restored after), not under whatever key earlier tests left
SEED_REF = 26
GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=64, max_seq_len=64,
            tie_embeddings=True)
ENGINE = dict(max_batch=2, block_size=8, max_context=32)


def _codes(c):
    """fp8 codes of either package as their raw bytes."""
    if isinstance(c, torch.Tensor):
        return c.view(torch.uint8).numpy()
    return np.asarray(c).view(np.uint8)


# ----------------------------------------------------------------------
# quantization
# ----------------------------------------------------------------------

def _rows(kind, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 8, 2, 16).astype(np.float32)
    if kind == "zero_rows":
        x[0, 3] = 0.0
        x[2] = 0.0
    elif kind == "fp8_subnormal_codes":
        # one large value per row: the rest quantize below e4m3's
        # smallest normal (2^-6) into its subnormal codes
        x *= 1e-3
        x[..., 0, 0] = 5.0
    elif kind == "f32_subnormal_rows":
        x *= 1e-39
    else:
        x *= float(kind)
    return x


@pytest.mark.parametrize("kind", ["1e-3", "1", "1e2", "zero_rows",
                                  "fp8_subnormal_codes",
                                  "f32_subnormal_rows"])
def test_quantize_fp8_bitwise_equal_to_jax(kind):
    x = _rows(kind)
    jc, js = jqkv.kv_quantize_fp8(jnp.asarray(x))
    tc, ts = qkv.kv_quantize_fp8(torch.from_numpy(x))
    assert tc.dtype == torch.float8_e4m3fn and ts.dtype == torch.float32
    assert tc.shape == x.shape and ts.shape == x.shape[:-2]
    np.testing.assert_array_equal(_codes(tc), _codes(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if kind == "zero_rows":
        assert not _codes(tc)[2].any() and not _codes(tc)[0, 3].any()


@pytest.mark.parametrize("kind", ["1e-3", "1e2", "zero_rows"])
def test_dequantize_equal_to_jax(kind):
    x = _rows(kind, seed=1)
    jc, js = jqkv.kv_quantize_fp8(jnp.asarray(x))
    tc, ts = qkv.kv_quantize_fp8(torch.from_numpy(x))
    np.testing.assert_array_equal(qkv.kv_dequantize(tc, ts).numpy(),
                                  np.asarray(jqkv.kv_dequantize(jc, js)))
    # the scale-free widening cast of a bf16 row
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        qkv.kv_dequantize(xb).numpy(),
        np.asarray(jqkv.kv_dequantize(jnp.asarray(x, jnp.bfloat16))))


def test_bf16_rows_are_widened_before_quantizing():
    """The deliberate difference: a bf16 row is quantized as its f32
    widening (the reference rounds the bf16 amax / 448 to bf16)."""
    x = torch.from_numpy(_rows("1", seed=2)).to(torch.bfloat16)
    codes, scale = qkv.kv_quantize_fp8(x)
    want_c, want_s = qkv.kv_quantize_fp8(x.float())
    assert torch.equal(codes.view(torch.uint8), want_c.view(torch.uint8))
    assert torch.equal(scale, want_s)


GEOMS = [dict(num_layers=24, num_kv_heads=8, head_dim=128, block_size=16),
         dict(num_layers=32, num_kv_heads=8, head_dim=128, block_size=16),
         dict(num_layers=2, num_kv_heads=2, head_dim=8, block_size=4),
         dict(num_layers=1, num_kv_heads=1, head_dim=64, block_size=32)]


@pytest.mark.parametrize("mode", [None, "bf16", "fp8"])
@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: "x".join(
    str(v) for v in g.values()))
def test_block_bytes_and_budget_equal_to_jax(geom, mode):
    assert qkv.kv_block_bytes(kv_dtype=mode, **geom) == \
        jqkv.kv_block_bytes(kv_dtype=mode, **geom)
    for budget in (1 << 20, 1 << 30, 80 * 10 ** 9 + 7):
        assert qkv.kv_blocks_in_budget(budget, kv_dtype=mode, **geom) == \
            jqkv.kv_blocks_in_budget(budget, kv_dtype=mode, **geom)


def test_fp8_capacity_gate():
    """The reference's gate: at an equal budget fp8 holds at least twice
    the f32 blocks, scale rows charged; bf16 exactly twice."""
    geom = GEOMS[0]
    f32 = qkv.kv_blocks_in_budget(1 << 30, **geom)
    assert qkv.kv_blocks_in_budget(1 << 30, kv_dtype="fp8", **geom) >= 2 * f32
    assert qkv.kv_blocks_in_budget(1 << 30, kv_dtype="bf16", **geom) == \
        2 * f32
    assert qkv.kv_block_bytes(kv_dtype="fp8", **geom) > \
        qkv.kv_block_bytes(**geom) // 4


def test_kv_modes_and_pool_dtypes():
    assert qkv.resolve_kv_dtype("float8_e4m3fn") == "fp8"
    assert qkv.kv_pool_dtype("fp8") == torch.float8_e4m3fn
    assert qkv.kv_pool_dtype("bf16") == torch.bfloat16
    assert qkv.kv_pool_dtype(None, torch.bfloat16) == torch.bfloat16
    assert qkv.kv_has_scales("fp8") and not qkv.kv_has_scales("bf16")
    assert qkv.FP8_MAX == jqkv.FP8_MAX


# ----------------------------------------------------------------------
# cache
# ----------------------------------------------------------------------

def test_cache_fp8_planes_and_bytes_equal_to_jax():
    kw = dict(num_layers=2, num_kv_heads=2, head_dim=8, num_blocks=9,
              block_size=4, max_batch=2)
    ref = JaxCache(kv_dtype="fp8", **kw)
    port = PagedKVCache(kv_dtype="fp8", device="cpu", **kw)
    assert port.k_pool.dtype == torch.float8_e4m3fn
    assert tuple(port.k_pool.shape) == tuple(ref.k_pool.shape)
    for t, r in ((port.k_scale, ref.k_scale), (port.v_scale, ref.v_scale)):
        assert t.dtype == torch.float32 and tuple(t.shape) == tuple(r.shape)
        assert not t.any()
    assert port.block_nbytes == ref.block_nbytes
    assert port.stats()["kv_dtype"] == ref.stats()["kv_dtype"] == "fp8"
    plain = PagedKVCache(device="cpu", **kw)
    assert plain.k_scale is None and plain.v_scale is None
    assert plain.block_nbytes == JaxCache(**kw).block_nbytes


# ----------------------------------------------------------------------
# K5's fp8 path: the plain version against the reference's _fallback
# ----------------------------------------------------------------------

def _fp8_inputs(seed, B=4, h=4, kvh=2, d=16, num_blocks=16, bs=4, nbl=3):
    """Quantized pools (codes and scales from the reference's quantizer,
    so both packages read identical bytes), scattered block tables and
    mixed positions."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, h, d).astype(np.float32)
    k = rng.randn(num_blocks, bs, kvh, d).astype(np.float32)
    v = rng.randn(num_blocks, bs, kvh, d).astype(np.float32) * 3.0
    kc, ks = jqkv.kv_quantize_fp8(jnp.asarray(k))
    vc, vs = jqkv.kv_quantize_fp8(jnp.asarray(v))
    tables = np.zeros((B, nbl), np.int32)
    perm = rng.permutation(np.arange(1, num_blocks))
    tables[0] = perm[:nbl]                      # full context
    tables[1, :2] = perm[nbl:nbl + 2]           # 2 blocks + null pad
    tables[2, :1] = perm[nbl + 2:nbl + 3]       # mid-first-block
    pos = np.array([nbl * bs - 1, bs + 1, 1, 0], np.int32)  # row 3 idle
    return q, (kc, ks, vc, vs), tables, pos, 1.0 / np.sqrt(d)


def _torch_pools(pools):
    kc, ks, vc, vs = pools
    return (torch.from_numpy(_codes(kc).copy()).view(torch.float8_e4m3fn),
            torch.from_numpy(np.asarray(ks).copy()),
            torch.from_numpy(_codes(vc).copy()).view(torch.float8_e4m3fn),
            torch.from_numpy(np.asarray(vs).copy()))


@pytest.mark.parametrize("q_dtype,tol", [("float32", 1e-5),
                                         ("bfloat16", 8e-3)])
@pytest.mark.parametrize("h,kvh", [(4, 2), (4, 4), (8, 2)])
def test_paged_fp8_plain_matches_jax_fallback(q_dtype, tol, h, kvh):
    q, pools, tables, pos, scale = _fp8_inputs(h * 10 + kvh, h=h, kvh=kvh)
    kc, ks, vc, vs = pools
    jq = jnp.asarray(q, getattr(jnp, q_dtype))
    ref = jax_paged_fallback(jq, kc, vc, jnp.asarray(tables),
                             jnp.asarray(pos), scale, k_scale=ks, v_scale=vs)
    tk, tks, tv, tvs = _torch_pools(pools)
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    out = paged_decode_attention(tq, tk, tv, torch.from_numpy(tables),
                                 torch.from_numpy(pos), scale, k_scale=tks,
                                 v_scale=tvs)
    assert out.shape == (4, h * 16) and out.dtype == tq.dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_paged_fp8_ignores_poisoned_positions():
    """Codes and scales past ``pos`` (write-ahead rows, null padding)
    leave the output bitwise unchanged, even as NaN."""
    q, pools, tables, pos, scale = _fp8_inputs(5)
    tk, tks, tv, tvs = _torch_pools(pools)
    args = (torch.from_numpy(tables), torch.from_numpy(pos), scale)
    tq = torch.from_numpy(q)
    out = paged_decode_attention(tq, tk, tv, *args, k_scale=tks, v_scale=tvs)
    k2, v2 = tk.view(torch.uint8).clone(), tv.view(torch.uint8).clone()
    ks2, vs2 = tks.clone(), tvs.clone()
    for blk, rows in ((tables[1, 2], slice(None)),      # row 1's null pad
                      (tables[2, 0], slice(2, None))):  # row 2 sees 0..1
        k2[blk, rows] = 0x7F                             # e4m3 NaN
        v2[blk, rows] = 0x7E                             # 448
        ks2[blk, rows] = float("nan")
        vs2[blk, rows] = 1e30
    out2 = paged_decode_attention(
        tq, k2.view(torch.float8_e4m3fn), v2.view(torch.float8_e4m3fn),
        *args, k_scale=ks2, v_scale=vs2)
    assert torch.equal(out2[1], out[1]) and torch.equal(out2[2], out[2])


@pytest.mark.parametrize("case", ["fp8_without_scales", "scales_on_f32",
                                  "one_scale", "scale_shape", "scale_dtype",
                                  "scale_strided"])
def test_paged_fp8_refusals(case):
    q, pools, tables, pos, scale = _fp8_inputs(7)
    tk, tks, tv, tvs = _torch_pools(pools)
    kw = dict(k_scale=tks, v_scale=tvs)
    if case == "fp8_without_scales":
        kw = {}
    elif case == "scales_on_f32":
        tk, tv = tk.float(), tv.float()
    elif case == "one_scale":
        kw = dict(k_scale=tks)
    elif case == "scale_shape":
        kw = dict(k_scale=tks[:, :2], v_scale=tvs[:, :2])
    elif case == "scale_dtype":
        kw = dict(k_scale=tks.double(), v_scale=tvs.double())
    else:
        kw = dict(k_scale=tks.t().contiguous().t(), v_scale=tvs)
    with pytest.raises(mt.NotSupportedError):
        paged_decode_attention(torch.from_numpy(q), tk, tv,
                               torch.from_numpy(tables),
                               torch.from_numpy(pos), scale, **kw)


# ----------------------------------------------------------------------
# engine: port fp8 against JAX fp8
# ----------------------------------------------------------------------

def _to_numpy(tree):
    embed, norm, head, layers = tree
    return (np.asarray(embed), np.asarray(norm),
            None if head is None else np.asarray(head),
            [tuple(np.asarray(w) for w in layer) for layer in layers])


@pytest.fixture(scope="module")
def nets():
    jnet = JaxLlama(JaxConfig(**GEOM))
    with seeded(SEED_REF):
        jnet.initialize()
        jnet(mx.nd.array([[1, 2, 3]], dtype="int32"))
    jnet.hybridize()
    jnet.engine_compile_cache = {}
    pnet = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu")
    load_llama_decode_weights(pnet, _to_numpy(jnet.decode_weights()))
    return jnet, pnet


@pytest.fixture(scope="module")
def jax_fp8_run(nets):
    """The JAX fp8 engine's greedy run: prefill + 8 decode steps."""
    jnet, _ = nets
    eng = JaxEngine(jnet, compile_cache=jnet.engine_compile_cache,
                    kv_dtype="fp8", prefix_cache=False, **ENGINE).warmup()
    prompt = np.random.RandomState(3).randint(0, 64, (11,)).tolist()
    tok, last = eng.prefill(0, prompt)
    fed = list(prompt) + [int(tok)]
    logits = [np.asarray(last, np.float32)]
    for _ in range(8):
        pos = len(fed) - 1
        assert eng.reserve(0, pos)
        nxt, lg = eng.decode([(0, fed[-1], pos)])
        logits.append(np.asarray(lg[0], np.float32))
        fed.append(int(nxt[0]))
    return prompt, fed, logits


def _replay(eng, prompt, fed, n_steps=8):
    """Teacher-force ``fed`` through ``eng``: (first token, logits)."""
    tok, last = eng.prefill(0, prompt)
    logits = [last.float().numpy()]
    for j in range(n_steps):
        pos = len(prompt) + j
        assert eng.reserve(0, pos)
        _, lg = eng.decode([(0, fed[pos], pos)])
        logits.append(lg[0].float().numpy())
    return tok, logits


def test_engine_fp8_matches_jax_fp8(nets, jax_fp8_run):
    _, pnet = nets
    prompt, fed, ref = jax_fp8_run
    eng = InferenceEngine(pnet, device="cpu", kv_dtype="fp8",
                          **ENGINE).warmup()
    assert eng.cache.k_pool.dtype == torch.float8_e4m3fn
    tok, logits = _replay(eng, prompt, fed)
    assert tok == fed[len(prompt)]
    for a, b in zip(logits, ref):
        np.testing.assert_allclose(a, b, atol=2e-2, rtol=0)
    assert eng.stats["decode_calls"] == 8
    assert eng.stats["compiles_after_warmup"] == 0
    # the written rows carry scales: every live position's scale > 0
    table = eng.cache.table(0)
    n = len(prompt) + 8
    ks = eng.cache.k_scale[:, table].reshape(GEOM["num_layers"], -1)[:, :n]
    assert bool((ks > 0).all())


def test_engine_fp8_drift_against_f32_pool_is_bounded(nets, jax_fp8_run):
    _, pnet = nets
    prompt, fed, _ = jax_fp8_run
    _, lg8 = _replay(InferenceEngine(pnet, device="cpu", kv_dtype="fp8",
                                     **ENGINE), prompt, fed)
    _, lg32 = _replay(InferenceEngine(pnet, device="cpu", **ENGINE), prompt,
                      fed)
    np.testing.assert_array_equal(lg8[0], lg32[0])   # prefill: fresh K/V
    drift = max(float(np.abs(a - b).max()) for a, b in zip(lg8, lg32))
    assert 0.0 < drift <= 0.1


def _state(c):
    return (c.num_free_blocks, c.blocks_in_use, c.alloc_failures,
            c.cow_copies, sorted(c._refs.items()),
            {str(s): c.table(s) for s in c._tables})


def test_cow_fork_carries_fp8_scales_like_jax(nets):
    """A sequence adopting another's blocks, then writing into the shared
    partial block, forks it: the new block holds the same codes and
    scale rows, and the accounting matches the JAX engine op for op."""
    jnet, pnet = nets
    prompt = np.random.RandomState(8).randint(0, 64, (12,)).tolist()
    jeng = JaxEngine(jnet, compile_cache=jnet.engine_compile_cache,
                     kv_dtype="fp8", prefix_cache=False, **ENGINE)
    peng = InferenceEngine(pnet, device="cpu", kv_dtype="fp8", **ENGINE)
    forks = []
    for eng in (jeng, peng):
        eng.prefill("a", prompt)
        eng.cache.adopt("b", eng.cache.table("a"), len(prompt))
        src = eng.cache.table("b")[1]
        assert eng.cache.refcount(src) == 2
        assert eng.reserve("b", len(prompt))
        dst = eng.cache.table("b")[1]
        forks.append((src, dst))
    assert forks[0] == forks[1]
    assert _state(jeng.cache) == _state(peng.cache)
    src, dst = forks[1]
    assert src != dst and peng.cache.cow_copies == 1
    c = peng.cache
    for pool in (c.k_pool, c.v_pool):
        assert torch.equal(pool.view(torch.uint8)[:, dst],
                           pool.view(torch.uint8)[:, src])
    for plane, ref in ((c.k_scale, jeng.cache.k_scale),
                       (c.v_scale, jeng.cache.v_scale)):
        assert torch.equal(plane[:, dst], plane[:, src])
        assert bool((plane[:, dst, :len(prompt) - 8] > 0).all())
        np.testing.assert_allclose(plane[:, dst].numpy(),
                                   np.asarray(ref)[:, dst], rtol=1e-5)
    for eng in (jeng, peng):
        eng.release("a")
        eng.release("b")
    assert _state(jeng.cache) == _state(peng.cache)
    assert c.check_leaks() and c.blocks_in_use == 0
