"""Chunked prefill and the prefix cache of the port's serving engine
against the JAX package, on the CPU.

The JAX net is initialised by the reference; its ``decode_weights()``
cross into the port by ``mxnet_tpu_torch.convert``.  Both packages then
see the same prompts, made from a numpy seed.  Tolerances: the offset
form of K3's plain version within 1e-5 of the reference's chunk
attention (``attend`` in its ``_build_chunk_prefill``, written out here
in jax.numpy, since it is a closure of the engine); ``chunk_prefill``
logits within 1e-4 of the reference's (float32; XLA and PyTorch sum in
other orders), 2e-2 with fp8 pools; the port's prefix path within 1e-5
of its own cold path; greedy token streams identical throughout, and
``PrefixCache`` equal to the reference's op for op.  Every JAX engine
here shares one compile cache, so each graph compiles once (in a fixture
or the first test that needs it).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.nlp.llama import (
    LlamaConfig as JaxConfig, LlamaForCausalLM as JaxLlama)
from mxnet_tpu.ops.flash_attention import _NEG_INF, _pick_block
from mxnet_tpu.serving import (ContinuousBatcher as JaxContinuous,
                               InferenceEngine as JaxEngine,
                               PagedKVCache as JaxCache,
                               PrefixCache as JaxPrefixCache,
                               Request as JaxRequest)

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_llama_decode_weights
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                       LlamaForCausalLM)
from mxnet_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                 flash_attention_plain)
from mxnet_tpu_torch.serving import (ContinuousBatcher, InferenceEngine,
                                     PagedKVCache, PrefixCache, Request)
from test_torch_port_amp import seeded

ATOL = 1e-4
FP8_ATOL = 2e-2
PREFIX_ATOL = 1e-5
# the reference's weights are drawn under this seed of its global key
# (restored after), not under whatever key earlier tests left
SEED_REF = 26
GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=64, max_seq_len=64)
# buckets 8, 16 and 32; chunks of 8 tokens
ENGINE = dict(max_batch=3, block_size=8, max_context=32)
CHUNK = 8
_CC = {}          # one JAX compile cache for the module


@pytest.fixture(scope="module")
def nets():
    jnet = JaxLlama(JaxConfig(**GEOM))
    with seeded(SEED_REF):
        jnet.initialize()
        jnet(mx.nd.array([[1, 2, 3]], dtype="int32"))
    jnet.hybridize()
    embed, norm, head, layers = jnet.decode_weights()
    weights = (np.asarray(embed), np.asarray(norm),
               None if head is None else np.asarray(head),
               [tuple(np.asarray(w) for w in layer) for layer in layers])
    pnet = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu")
    return jnet, load_llama_decode_weights(pnet, weights)


def _jax(jnet, **kw):
    kw.setdefault("prefix_cache", False)
    return JaxEngine(jnet, compile_cache=_CC,
                     **dict(ENGINE, **kw)).warmup()


def _port(pnet, **kw):
    return InferenceEngine(pnet, device="cpu",
                           **dict(ENGINE, **kw)).warmup()


@pytest.fixture(scope="module")
def jax_chunked(nets):
    """A warmed JAX chunk engine of each pool (its compiles paid here)."""
    jnet, _ = nets
    return {pool: _jax(jnet, prefill_chunk=CHUNK, kv_dtype=pool)
            for pool in (None, "fp8")}


# ----------------------------------------------------------------------
# K3's offset form: the plain version against the reference's attend
# ----------------------------------------------------------------------

def _reference_attend(q, kr, vr, qpos, scale):
    """The reference engine's chunk attention (``attend`` in
    ``_build_chunk_prefill``), verbatim in jax.numpy: q (BH, C, d), kr/vr
    (BH, L, d), qpos (BH, C) absolute positions."""
    bh, C, d = q.shape
    L = kr.shape[1]
    bk = _pick_block(L, 256) or L
    nk = L // bk
    kb = kr.reshape(bh, nk, bk, d).transpose(1, 0, 2, 3)
    vb = vr.reshape(bh, nk, bk, d).transpose(1, 0, 2, 3)
    acc = jnp.zeros((bh, C, d), jnp.float32)
    m_i = jnp.full((bh, C, 1), _NEG_INF, jnp.float32)
    l_i = jnp.zeros((bh, C, 1), jnp.float32)
    for j in range(nk):
        s = jnp.einsum("bqd,bkd->bqk", q, kb[j],
                       preferred_element_type=jnp.float32) * scale
        kpos = j * bk + jnp.arange(bk)[None, :]
        s = jnp.where(qpos[:, :, None] >= kpos[None], s, _NEG_INF)
        m_new = jnp.maximum(m_i, jnp.max(s, axis=-1, keepdims=True))
        p = jnp.exp(s - m_new)
        alpha = jnp.exp(m_i - m_new)
        l_i = l_i * alpha + jnp.sum(p, axis=-1, keepdims=True)
        acc = acc * alpha + jnp.einsum("bqk,bkd->bqd", p.astype(vr.dtype),
                                       vb[j],
                                       preferred_element_type=jnp.float32)
        m_i = m_new
    return np.asarray((acc / jnp.maximum(l_i, 1e-30)).astype(q.dtype))


@pytest.mark.parametrize("C,L,D", [(8, 32, 16), (16, 64, 32),
                                   (8, 384, 64), (32, 512, 128)])
def test_flash_q_start_plain_matches_reference_attend(C, L, D):
    """Rows start anywhere in [0, L - C], the reference's chunk math:
    one KV block at L = 32 and 64, three of 128 at L = 384, two of 256 at
    L = 512."""
    rng = np.random.RandomState(C + L + D)
    bh = 6
    q = rng.randn(bh, C, D).astype(np.float32)
    k = rng.randn(bh, L, D).astype(np.float32)
    v = rng.randn(bh, L, D).astype(np.float32)
    starts = rng.randint(0, L - C + 1, bh).astype(np.int32)
    starts[0] = 0
    qpos = starts[:, None] + np.arange(C)[None, :]
    scale = 1.0 / np.sqrt(D)
    ref = _reference_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(qpos), scale)
    out, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), True, scale,
                                   q_start=torch.from_numpy(starts))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    assert lse.shape == (bh, C) and bool(torch.isfinite(lse).all())


def test_flash_q_start_zero_is_the_causal_form():
    """Offsets of 0 on square rows are the causal mask: bitwise."""
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(4, 40, 16).astype(np.float32))
               for _ in range(3))
    want = flash_attention_plain(q, k, v, True, 0.25)
    got = flash_attention_plain(q, k, v, False, 0.25,
                                q_start=torch.zeros(4, dtype=torch.int32))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_flash_q_start_refuses_autograd():
    q, k, v = (torch.randn(2, 8, 16, requires_grad=True) for _ in range(3))
    starts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(mt.NotSupportedError, match="forward only"):
        flash_attention_fwd(q, k, v, True, q_start=starts)
    with torch.no_grad():
        out, _ = flash_attention_fwd(q, k, v, True, q_start=starts)
    assert out.shape == (2, 8, 16)


# ----------------------------------------------------------------------
# chunk_prefill against the reference's
# ----------------------------------------------------------------------

def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _chunk_script(eng, prompts):
    """Two packed chunk calls: rows of prompts 0 (its first chunk) and 1
    (whole), then prompt 0's tail with prompt 2 (whole); 4 greedy decode
    steps of all three after.  Returns (tokens, [logits rows])."""
    p0, p1, p2 = prompts
    for slot in range(3):
        assert eng.cache.alloc(slot, 0)
    outs = []
    nxt, last = eng.chunk_prefill([(0, p0[:CHUNK], 0), (1, p1, 0)])
    outs.append((list(nxt), _np(last)))
    nxt2, last2 = eng.chunk_prefill([(0, p0[CHUNK:], CHUNK), (2, p2, 0)])
    outs.append((list(nxt2), _np(last2)))
    fed = {0: list(p0) + [int(nxt2[0])], 1: list(p1) + [int(nxt[1])],
           2: list(p2) + [int(nxt2[1])]}
    for _ in range(4):
        entries = []
        for slot in range(3):
            pos = len(fed[slot]) - 1
            assert eng.reserve(slot, pos)
            entries.append((slot, fed[slot][-1], pos))
        toks, lg = eng.decode(entries)
        outs.append((list(toks), _np(lg)))
        for slot, t in zip(range(3), toks):
            fed[slot].append(int(t))
    for slot in range(3):
        eng.release(slot)
    return outs


@pytest.mark.parametrize("pool", [None, "fp8"], ids=["f32", "fp8"])
def test_chunk_prefill_matches_jax(nets, jax_chunked, pool):
    _, pnet = nets
    rng = np.random.RandomState(21)
    prompts = [rng.randint(0, 64, (n,)).tolist() for n in (13, 6, 8)]
    ref = _chunk_script(jax_chunked[pool], prompts)
    eng = _port(pnet, prefill_chunk=CHUNK, kv_dtype=pool)
    got = _chunk_script(eng, prompts)
    tol = ATOL if pool is None else FP8_ATOL
    for (toks, lg), (rtoks, rlg) in zip(got, ref):
        assert [int(t) for t in toks] == [int(t) for t in rtoks]
        np.testing.assert_allclose(lg, rlg, atol=tol, rtol=0)
    assert eng.stats["chunk_prefill_calls"] == 2
    assert eng.stats["prompt_tokens_computed"] == 27
    assert eng.stats["compiles_after_warmup"] == 0
    eng.cache.check_leaks()


def test_chunk_prefill_refusals(nets):
    _, pnet = nets
    eng = _port(pnet, prefill_chunk=CHUNK)
    assert eng.cache.alloc(0, 0)
    with pytest.raises(mt.MXNetError, match="chunk of 9 tokens"):
        eng.chunk_prefill([(0, list(range(9)), 0)])
    with pytest.raises(mt.MXNetError, match="rows vs max_batch"):
        eng.chunk_prefill([])
    with pytest.raises(mt.MXNetError, match="prefill_chunk > 0"):
        _port(pnet).chunk_prefill([(0, [1], 0)])
    eng.release(0)


def test_chunk_prefill_without_blocks_returns_none(nets):
    """A chunk the pool cannot cover returns None and writes nothing."""
    _, pnet = nets
    eng = _port(pnet, prefill_chunk=CHUNK)
    assert eng.cache.alloc(0, 8 * (eng.cache.num_blocks - 1))   # all of it
    assert eng.cache.alloc(1, 0)
    assert eng.chunk_prefill([(1, [1, 2, 3], 0)]) is None
    assert eng.stats["chunk_prefill_calls"] == 0
    eng.release(0)
    eng.release(1)
    eng.cache.check_leaks()


@pytest.mark.parametrize("kwargs,err", [
    ({"prefill_chunk": 5}, mt.MXNetError),
    ({"prefill_chunk": -8}, mt.MXNetError),
    ({"spec_k": 0}, mt.MXNetError),
    ({"spec_decode": True, "temperature": 0.7}, mt.NotSupportedError)],
    ids=["chunk_not_block_multiple", "negative_chunk", "spec_k_0",
         "sampled_speculation"])
def test_engine_checks_the_new_arguments(nets, kwargs, err):
    """The reference's checks of ``prefill_chunk``, ``spec_k`` and
    greedy-only speculation."""
    _, pnet = nets
    with pytest.raises(err):
        InferenceEngine(pnet, device="cpu", **dict(ENGINE, **kwargs))


def test_engine_takes_the_new_arguments(nets):
    _, pnet = nets
    eng = InferenceEngine(pnet, device="cpu", prefill_chunk=64,
                          prefix_cache=True, spec_decode=True, spec_k=3,
                          **ENGINE)
    assert eng.prefill_chunk == 32                # capped at max_context
    assert isinstance(eng.prefix_cache, PrefixCache)
    assert eng.prefix_cache.cache is eng.cache
    assert eng.spec_decode and eng.spec_k == 3
    assert eng._verify_widths() == [2, 4]
    own = PrefixCache(eng.cache)
    assert InferenceEngine(pnet, device="cpu", prefix_cache=own,
                           **ENGINE).prefix_cache is own
    off = InferenceEngine(pnet, device="cpu", **ENGINE)
    assert (off.prefill_chunk, off.prefix_cache, off.spec_decode,
            off.spec_k) == (0, None, False, 4)
    with pytest.raises(mt.MXNetError, match="prefix_cache=True"):
        off.pin_prefix([1, 2, 3])
    assert off.attach_prefix(0, [1, 2, 3]) == 0


def test_warmup_builds_one_chunk_step_per_width(nets, jax_chunked):
    """prefill, decode and chunk per bucket: the compile counters of the
    reference (which adds one ``cow`` graph the port does not need)."""
    _, pnet = nets
    eng = _port(pnet, prefill_chunk=CHUNK)
    assert sorted(k for k in eng._steps if k[0] == "chunk") == \
        [("chunk", 1), ("chunk", 2), ("chunk", 4)]
    assert eng.stats["compiles"] == 9
    # the fixture's engine compiled the module's graphs: the same families
    # and one cow graph
    assert jax_chunked[None].stats["compiles"] == eng.stats["compiles"] + 1
    eng.warmup()
    assert eng.stats["compiles"] == 9


# ----------------------------------------------------------------------
# the prefix path against the port's cold path
# ----------------------------------------------------------------------

def _solo(eng, slot, prompt, n):
    """Cold path: prefill and ``n`` greedy decode steps; (tokens,
    decode logits rows)."""
    tok, _ = eng.prefill(slot, prompt)
    cur = list(prompt) + [int(tok)]
    rows = []
    for _ in range(n):
        pos = len(cur) - 1
        assert eng.reserve(slot, pos)
        nxt, lg = eng.decode([(slot, cur[-1], pos)])
        rows.append(_np(lg)[0])
        cur.append(int(nxt[0]))
    eng.release(slot)
    return cur[len(prompt):], rows


def test_prefix_path_matches_cold_path(nets):
    """A 12-token system prompt (one full block, a 4-token partial)
    pinned once; three requests that continue it compute only their
    suffix, fork the partial block on their first write, and decode
    within 1e-5 of the cold path with the same tokens."""
    _, pnet = nets
    rng = np.random.RandomState(3)
    sys_prompt = rng.randint(0, 64, (12,)).tolist()
    users = [rng.randint(0, 64, (n,)).tolist() for n in (5, 7, 3)]
    cold = _port(pnet)
    refs = [_solo(cold, "solo", sys_prompt + u, 4) for u in users]
    eng = _port(pnet, prefill_chunk=CHUNK, prefix_cache=True, num_blocks=25)
    assert eng.pin_prefix(sys_prompt)
    pinned = eng.stats["prompt_tokens_computed"]
    assert pinned == len(sys_prompt)
    for u, (ref_toks, ref_rows) in zip(users, refs):
        b = ContinuousBatcher(eng)
        rows = []
        decode = eng.decode

        def capture(entries, _rows=rows):
            nxt, lg = decode(entries)
            _rows.append(_np(lg)[0])
            return nxt, lg

        eng.decode = capture
        try:
            req = b.submit(Request(sys_prompt + u, max_new_tokens=5))
            b.run()
        finally:
            del eng.decode
        assert req.generated == ref_toks
        assert len(rows) == len(ref_rows) == 4
        for got, want in zip(rows, ref_rows):
            np.testing.assert_allclose(got, want, atol=PREFIX_ATOL, rtol=0)
    assert eng.stats["prompt_tokens_computed"] == \
        pinned + sum(len(u) for u in users)
    pc = eng.prefix_cache
    assert (pc.hits, pc.hit_rate()) == (3, 1.0)
    assert eng.cache.cow_copies >= 3
    assert eng.stats["compiles_after_warmup"] == 0
    eng.cache.check_leaks(holders=pc.held_blocks())


def test_eviction_under_pressure_matches_cold_streams(nets):
    """Pool pressure evicts LRU chains in flight; live requests keep
    their blocks (refcount > 1) and finish with the cold streams."""
    _, pnet = nets
    rng = np.random.RandomState(9)
    sys_prompt = rng.randint(0, 64, (12,)).tolist()
    cold = _port(pnet)
    eng = _port(pnet, prefill_chunk=CHUNK, prefix_cache=True, num_blocks=13)
    assert eng.pin_prefix(sys_prompt)
    for _ in range(2):
        eng.pin_prefix(rng.randint(0, 64, (8,)).tolist())
    b = ContinuousBatcher(eng)
    reqs, refs = [], []
    for n in (6, 9, 4, 7):
        prompt = sys_prompt + rng.randint(0, 64, (n,)).tolist()
        refs.append(_solo(cold, "solo", prompt, 3)[0])
        reqs.append(b.submit(Request(prompt, max_new_tokens=4)))
    b.run()
    assert [r.generated for r in reqs] == refs
    assert eng.prefix_cache.evictions > 0
    assert eng.stats["compiles_after_warmup"] == 0
    eng.cache.check_leaks(holders=eng.prefix_cache.held_blocks())


# ----------------------------------------------------------------------
# PrefixCache against the reference, op for op
# ----------------------------------------------------------------------

def _prefix_script(cache_cls, pc_cls, **kw):
    """One scripted sequence over a pool of 12 allocatable blocks; the
    trace of every observable the cache and the pool give."""
    c = cache_cls(num_layers=1, num_kv_heads=2, head_dim=8, num_blocks=13,
                  block_size=4, max_batch=3, **kw)
    pc = pc_cls(c)
    trace = []

    def snap(tag, value=None):
        trace.append((tag, value, c.num_free_blocks, sorted(c._refs.items()),
                      {s: c.table(s) for s in sorted(c._tables, key=str)},
                      pc.held_blocks(), pc.hit_rate(), pc.stats()))

    seqs = {"a": list(range(10)), "b": [0, 1, 2, 3, 9, 9, 9, 9, 5, 6],
            "c": [7] * 6}
    for slot, toks in seqs.items():
        assert c.alloc(slot, len(toks))
        pc.insert(slot, toks)
        snap(("insert", slot))
    for slot in seqs:
        c.free(slot)
    snap("freed")
    for toks in (list(range(10)) + [99], [0, 1, 2, 3, 9, 9, 9, 9, 1],
                 [7, 7, 7, 7, 7, 1], [5, 5, 5], [0, 1, 2]):
        n, blocks = pc.lookup(toks)
        snap("lookup", (n, list(blocks)))
    for toks, k in (([0, 1, 2, 3], 8), ([0, 1, 2, 3, 9], 3), ([7, 7], 4),
                    ([1, 2], 2)):
        snap("continuation", pc.continuation(toks, k))
    snap("attach", pc.attach("req", list(range(10)) + [42]))
    assert c.alloc("big", 16)
    snap("evict", pc.evict(blocks_needed=9))
    order = []
    while pc.held_blocks():
        before = {nd.block for nd in pc._nodes.values()}
        pc.evict(blocks_needed=0, nodes_needed=1)
        order.append(sorted(before - {nd.block for nd in
                                      pc._nodes.values()}))
    snap("eviction order", order)
    c.free("req")
    c.free("big")
    snap("end")
    assert c.check_leaks()
    return trace


def test_prefix_cache_matches_reference_op_for_op():
    ref = _prefix_script(JaxCache, JaxPrefixCache)
    got = _prefix_script(PagedKVCache, PrefixCache, device="cpu")
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g == r


def test_prefix_cache_max_nodes_evicts_lru_like_reference():
    traces = []
    for cache_cls, pc_cls, kw in ((JaxCache, JaxPrefixCache, {}),
                                  (PagedKVCache, PrefixCache,
                                   {"device": "cpu"})):
        c = cache_cls(num_layers=1, num_kv_heads=2, head_dim=8,
                      num_blocks=13, block_size=4, max_batch=3, **kw)
        pc = pc_cls(c, max_nodes=3)
        out = []
        for i, toks in enumerate(([1] * 8, [2] * 9, [3] * 4, [1] * 8)):
            assert c.alloc(i, len(toks))
            pc.insert(i, toks)
            c.free(i)
            out.append((sorted(nd.block for nd in pc._nodes.values()),
                        pc.evictions, c.num_free_blocks))
        pc.clear()
        assert c.check_leaks()
        traces.append(out)
    assert traces[0] == traces[1]


# ----------------------------------------------------------------------
# batchers: chunked, and chunked with the prefix cache
# ----------------------------------------------------------------------

def _serve(batcher, req_cls, prompts, n):
    for i, p in enumerate(prompts):
        batcher.submit(req_cls(p, n, request_id=i))
    stats = batcher.run()
    return {r.id: r.generated for r in batcher.finished}, stats


@pytest.mark.parametrize("prefix", [False, True], ids=["chunked",
                                                       "prefix_chunked"])
def test_batcher_streams_match_jax_and_plain(nets, jax_chunked, prefix):
    """Six requests sharing a 12-token system prompt (and one prompt
    longer than two chunks) through each package's ContinuousBatcher:
    identical streams, the same chunk calls and prompt tokens computed;
    the port's streams equal its plain (serial prefill) streams."""
    jnet, pnet = nets
    rng = np.random.RandomState(5)
    sys_prompt = rng.randint(0, 64, (12,)).tolist()
    prompts = [sys_prompt + rng.randint(0, 64, (3 + i % 5,)).tolist()
               for i in range(5)] + [rng.randint(0, 64, (20,)).tolist()]
    kw = dict(prefill_chunk=CHUNK, prefix_cache=prefix)
    jeng = _jax(jnet, **kw)
    peng = _port(pnet, **kw)
    if prefix:
        assert jeng.pin_prefix(sys_prompt) and peng.pin_prefix(sys_prompt)
    ref, js = _serve(JaxContinuous(jeng), JaxRequest, prompts, 5)
    got, ps = _serve(ContinuousBatcher(peng), Request, prompts, 5)
    plain, _ = _serve(ContinuousBatcher(_port(pnet)), Request, prompts, 5)
    assert got == ref == plain
    for key in ("chunk_prefill_calls", "prefill_calls", "decode_calls",
                "prompt_tokens_computed", "compiles_after_warmup"):
        assert peng.stats[key] == jeng.stats[key], key
    assert ps["decode_steps"] == js["decode_steps"]
    assert ps["cache"] == {k: js["cache"][k] for k in ps["cache"]}
    assert peng.stats["compiles_after_warmup"] == 0
    if prefix:
        assert peng.prefix_cache.stats() == jeng.prefix_cache.stats()
        assert peng.prefix_cache.hits == 5
    held = peng.prefix_cache.held_blocks() if prefix else 0
    peng.cache.check_leaks(holders=held)
