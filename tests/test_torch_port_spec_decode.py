"""Speculative decoding of the port's serving engine against the JAX
package, on the CPU.

As the reference's own tests do, the nets have one layer and the
engines one context bucket (``block_size == max_context == 16``) with
``spec_k=3`` (verify widths 2 and 4), and every JAX engine shares one
compile cache whose graphs compile in a module fixture.  The JAX net's
``decode_weights()`` cross into the port by ``mxnet_tpu_torch.convert``.
Tolerance: none.  Drafts, verify tokens and committed streams must be
identical to the reference's and to the plain (non-speculative) stream;
a verify row of count 1 must write the same K/V bits and pick the same
token as the port's plain decode.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.nlp.llama import (
    LlamaConfig as JaxConfig, LlamaForCausalLM as JaxLlama)
from mxnet_tpu.serving import (ContinuousBatcher as JaxContinuous,
                               DraftSource as JaxDraftSource,
                               InferenceEngine as JaxEngine,
                               PagedKVCache as JaxCache,
                               PrefixCache as JaxPrefixCache,
                               Request as JaxRequest)

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_llama_decode_weights
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                       LlamaForCausalLM)
from mxnet_tpu_torch.serving import (ContinuousBatcher, DraftSource,
                                     InferenceEngine, PagedKVCache,
                                     PrefixCache, Request)
from test_torch_port_amp import seeded

VOCAB = 48
# the reference's weights are drawn under this seed of its global key
# (restored after), not under whatever key earlier tests left
SEED_REF = 26
GEOM = dict(vocab_size=VOCAB, hidden_size=32, num_layers=1, num_heads=4,
            num_kv_heads=2, intermediate_size=64, max_seq_len=64,
            tie_embeddings=True)
ENGINE = dict(max_batch=3, block_size=16, max_context=16)
# self-repeating prompts: the n-gram draft source fires on the trailing
# gram, so speculative boundaries really draft
PROMPTS = ((1, 2, 3, 1, 2, 3, 1), (5, 6, 7, 5, 6), (9, 10, 9, 10, 9, 10))
MAX_NEW = 6
_CC = {}


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
    load_llama_decode_weights(pnet, weights)
    # every JAX graph of the file compiles here, outside the tests' calls
    JaxEngine(jnet, prefix_cache=False, compile_cache=_CC, spec_decode=True,
              spec_k=3, **ENGINE).warmup()
    return jnet, pnet


def _jax(jnet, **kw):
    kw.setdefault("prefix_cache", False)
    kw.setdefault("spec_decode", False)
    return JaxEngine(jnet, compile_cache=_CC, **dict(ENGINE, **kw)).warmup()


def _port(pnet, **kw):
    return InferenceEngine(pnet, device="cpu", **dict(ENGINE, **kw)).warmup()


def _serve(batcher, req_cls, prompts=PROMPTS, n=MAX_NEW):
    for i, p in enumerate(prompts):
        batcher.submit(req_cls(list(p), n, request_id=i))
    stats = batcher.run()
    return {r.id: r.generated for r in batcher.finished}, stats


@pytest.fixture(scope="module")
def plain(nets):
    """The port's plain greedy streams of PROMPTS."""
    _, pnet = nets
    eng = _port(pnet)
    streams, stats = _serve(ContinuousBatcher(eng), Request)
    assert stats["verify_steps"] == 0
    return streams


# ----------------------------------------------------------------------
# drafts
# ----------------------------------------------------------------------

def test_draft_source_ngram_matches_reference():
    rng = np.random.RandomState(7)
    contexts = [rng.randint(0, 5, n).tolist() for n in range(0, 40, 3)]
    contexts += [list(p) for p in PROMPTS] + [[4], [4, 4], [1, 2, 1, 2, 3]]
    for ngram in (1, 2, 3):
        ref, got = JaxDraftSource(ngram=ngram), DraftSource(ngram=ngram)
        for ctx in contexts:
            for k in (0, 1, 3, 5):
                assert got.propose(ctx, k) == ref.propose(ctx, k)
        assert (got.proposals, got.from_cache, got.from_ngram) == \
            (ref.proposals, ref.from_cache, ref.from_ngram)


def test_draft_source_prefix_cache_first_matches_reference():
    """With a prefix cache, its trie continuation comes first, then the
    n-gram lookup; the same chains give the same drafts."""
    sources = []
    for cache_cls, pc_cls, ds_cls, kw in (
            (JaxCache, JaxPrefixCache, JaxDraftSource, {}),
            (PagedKVCache, PrefixCache, DraftSource, {"device": "cpu"})):
        c = cache_cls(num_layers=1, num_kv_heads=2, head_dim=8,
                      num_blocks=16, block_size=4, max_batch=2, **kw)
        pc = pc_cls(c)
        for slot, toks in enumerate(([1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
                                     [1, 2, 3, 4, 6, 6], [8, 8, 8, 8, 8])):
            assert c.alloc(slot, len(toks))
            pc.insert(slot, toks)
            c.free(slot)
        sources.append(ds_cls(prefix_cache=pc))
    ref, got = sources
    rng = np.random.RandomState(3)
    contexts = [[1, 2], [1, 2, 3, 4], [1, 2, 3, 4, 5], [1, 2, 3, 4, 6],
                [8, 8, 8], [3, 1, 3], [7, 7]] + \
        [rng.randint(1, 10, n).tolist() for n in (2, 5, 9, 12)]
    for ctx in contexts:
        for k in (1, 2, 4, 8):
            assert got.propose(ctx, k) == ref.propose(ctx, k), (ctx, k)
    assert (got.proposals, got.from_cache, got.from_ngram) == \
        (ref.proposals, ref.from_cache, ref.from_ngram)
    assert got.from_cache > 0 and got.from_ngram > 0


# ----------------------------------------------------------------------
# verify
# ----------------------------------------------------------------------

def _prefilled(eng, prompts):
    """Prefill each prompt into slots 0..n-1; the first tokens."""
    return [int(eng.prefill(i, list(p))[0]) for i, p in enumerate(prompts)]


def test_verify_matches_reference(nets):
    """Rows of counts 3, 1 and 4 (width 4): the same greedy tokens as the
    reference's verify, and the same tokens again from a second call
    that overwrites the write-ahead."""
    jnet, pnet = nets
    outs = []
    for eng in (_jax(jnet, spec_decode=True, spec_k=3),
                _port(pnet, spec_decode=True, spec_k=3)):
        firsts = _prefilled(eng, PROMPTS)
        entries = []
        for i, (p, t) in enumerate(zip(PROMPTS, firsts)):
            toks = [t] + [[3, 1], [], [9, 10, 9]][i]
            assert eng.reserve(i, len(p), len(toks))
            entries.append((i, toks, len(p)))
        first = np.asarray(eng.verify(entries))
        again = np.asarray(eng.verify(entries))
        outs.append((first, again, dict(eng.stats)))
        for i in range(3):
            eng.release(i)
        eng.cache.check_leaks()
    (rf, ra, rstats), (pf, pa, pstats) = outs
    assert pf.shape == rf.shape == (3, 4)
    assert pf.dtype == np.int32
    np.testing.assert_array_equal(pf, rf)
    np.testing.assert_array_equal(pa, ra)
    np.testing.assert_array_equal(pa, pf)
    for key in ("verify_calls", "draft_tokens_scored",
                "compiles_after_warmup"):
        assert pstats[key] == rstats[key]
    assert pstats["draft_tokens_scored"] == 2 * 5


def test_verify_count_one_row_is_the_plain_decode(nets):
    """A row of count 1 runs the decode body op for op: the same token
    and the same K/V bits in the pool as the port's plain decode, beside
    a row of count 3 in the same replay."""
    _, pnet = nets
    results = []
    for use_verify in (False, True):
        eng = _port(pnet, spec_decode=True, spec_k=3)
        firsts = _prefilled(eng, PROMPTS[:2])
        assert eng.reserve(0, len(PROMPTS[0]))
        if use_verify:
            assert eng.reserve(1, len(PROMPTS[1]), 3)
            out = eng.verify([(0, [firsts[0]], len(PROMPTS[0])),
                              (1, [firsts[1], 5, 6], len(PROMPTS[1]))])
            tok = int(out[0, 0])
        else:
            tok = int(eng.decode([(0, firsts[0], len(PROMPTS[0]))])[0][0])
        pool = eng.cache.k_pool[:, eng.cache.table(0)].clone(), \
            eng.cache.v_pool[:, eng.cache.table(0)].clone()
        results.append((tok, pool))
    (t_dec, (k_dec, v_dec)), (t_ver, (k_ver, v_ver)) = results
    assert t_ver == t_dec
    assert torch.equal(k_ver, k_dec) and torch.equal(v_ver, v_dec)


@pytest.mark.parametrize("entries,match", [
    ([], "empty batch"),
    ([(0, [1, 2, 3, 4, 5], 7)], "spec_k"),
    ([(0, [1], 7)] * 4, "max_batch")], ids=["empty", "too_long", "too_many"])
def test_verify_refusals(nets, entries, match):
    _, pnet = nets
    eng = _port(pnet, spec_decode=True, spec_k=3)
    with pytest.raises(mt.MXNetError, match=match):
        eng.verify(entries)


def test_warmup_builds_each_verify_width(nets):
    _, pnet = nets
    eng = _port(pnet, spec_decode=True, spec_k=3)
    assert sorted(k for k in eng._steps if k[0] == "verify") == \
        [("verify", (2, 1)), ("verify", (4, 1))]
    ref = _jax(nets[0], spec_decode=True, spec_k=3)
    assert ref.stats["compiles"] == 0          # all in the shared cache
    assert eng.stats["compiles"] == 4
    assert eng.stats["compiles_after_warmup"] == 0


# ----------------------------------------------------------------------
# speculative batching
# ----------------------------------------------------------------------

@pytest.mark.parametrize("spec_k", [2, 3])
def test_spec_batcher_matches_reference_and_plain(nets, plain, spec_k):
    """The speculative ContinuousBatcher's streams equal the reference
    batcher's and the plain streams, with the reference's verify steps,
    accept rate and tokens per dispatch, in fewer replays than the plain
    run's decode steps."""
    jnet, pnet = nets
    jeng = _jax(jnet, spec_decode=True, spec_k=3)
    peng = _port(pnet, spec_decode=True, spec_k=3)
    ref, js = _serve(JaxContinuous(jeng, spec_k=spec_k), JaxRequest)
    got, ps = _serve(ContinuousBatcher(peng, spec_k=spec_k), Request)
    assert got == ref == plain
    for key in ("decode_steps", "verify_steps", "spec_accept_rate",
                "tokens_per_dispatch", "tokens_generated"):
        assert ps[key] == js[key], key
    assert ps["verify_steps"] > 0
    for key in ("verify_calls", "draft_tokens_scored", "decode_calls",
                "compiles_after_warmup"):
        assert peng.stats[key] == jeng.stats[key], key
    assert peng.stats["compiles_after_warmup"] == 0
    assert ps["cache"]["blocks_in_use"] == 0
    peng.cache.check_leaks()


def test_spec_batcher_with_missing_drafts_cools_down(nets, plain):
    """Drafts that never match: the stream stays the plain one and a
    sequence sits out ``_spec_cooldown`` boundaries after two misses,
    as in the reference."""
    jnet, pnet = nets
    runs = []
    for eng, cls, req in ((_jax(jnet, spec_decode=True, spec_k=3),
                           JaxContinuous, JaxRequest),
                          (_port(pnet, spec_decode=True, spec_k=3),
                           ContinuousBatcher, Request)):
        b = cls(eng)
        b.draft.propose = lambda ctx, k: [VOCAB - 1] * k if k > 0 else []
        runs.append(_serve(b, req, n=8))
    (ref, js), (got, ps) = runs
    assert got == ref
    assert ps["spec_accept_rate"] == js["spec_accept_rate"] == 0.0
    assert ps["verify_steps"] == js["verify_steps"]
    assert ps["decode_steps"] == js["decode_steps"]


def test_batcher_speculative_refusals(nets):
    _, pnet = nets
    plain_eng = InferenceEngine(pnet, device="cpu", **ENGINE)
    with pytest.raises(mt.MXNetError, match="spec_decode=True"):
        ContinuousBatcher(plain_eng, speculative=True)
    eng = InferenceEngine(pnet, device="cpu", spec_decode=True, spec_k=3,
                          **ENGINE)
    with pytest.raises(mt.MXNetError, match="outside"):
        ContinuousBatcher(eng, spec_k=4)
    assert ContinuousBatcher(eng).speculative
    assert not ContinuousBatcher(eng, speculative=False).speculative
    assert ContinuousBatcher(eng, spec_k=2).spec_k == 2


def test_write_ahead_forks_are_freed_by_trim(nets):
    """A pinned prefix whose partial tail block the request shares: the
    verify write-ahead forks it (and may open a block past the committed
    length), the trim after acceptance gives back what only rejected
    drafts covered, and the pool balances with the chain's holds."""
    _, pnet = nets
    eng = InferenceEngine(pnet, device="cpu", prefill_chunk=16,
                          prefix_cache=True, spec_decode=True, spec_k=3,
                          max_batch=3, block_size=4, max_context=16)
    eng.warmup()
    sys_prompt = [1, 2, 3, 1, 2, 3]              # one block and 2 tokens
    assert eng.pin_prefix(sys_prompt)
    b = ContinuousBatcher(eng)
    b.draft.propose = lambda ctx, k: [VOCAB - 1] * k if k > 0 else []
    reqs = [b.submit(Request(sys_prompt + [1], 5)),
            b.submit(Request(sys_prompt + [2, 3], 4))]
    b.run()
    assert all(r.done for r in reqs)
    assert b.verify_steps > 0
    assert eng.cache.cow_copies >= 2
    assert eng.cache.blocks_in_use == eng.prefix_cache.held_blocks()
    eng.cache.check_leaks(holders=eng.prefix_cache.held_blocks())
    cold = _port(pnet)
    for r in reqs:
        toks = list(r.tokens)
        tok, _ = cold.prefill(0, toks)
        want = [int(tok)]
        for _ in range(len(r.generated) - 1):
            pos = len(toks) + len(want) - 1
            assert cold.reserve(0, pos)
            want.append(int(cold.decode([(0, want[-1], pos)])[0][0]))
        cold.release(0)
        assert r.generated == want
