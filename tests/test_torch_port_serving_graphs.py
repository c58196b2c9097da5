"""The serving engine's step cache against the JAX engine's compile cache,
on the CPU.

On the card each (kind, bucket) step of ``mxnet_tpu_torch``'s
``InferenceEngine`` is a CUDA graph captured at warmup; with
``device="cpu"`` the same step objects run their bodies directly on
their static buffers, and that is what runs here.  The counters follow
the reference's: a miss is one compile, a miss after warmup is also
counted in ``compiles_after_warmup``.  Tolerance: greedy token streams
identical to the JAX engine's; a step's outputs bitwise equal to its
body called directly on the same inputs.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.nlp.llama import (
    LlamaConfig as JaxConfig, LlamaForCausalLM as JaxLlama)
from mxnet_tpu.serving import (ContinuousBatcher as JaxContinuous,
                               InferenceEngine as JaxEngine,
                               Request as JaxRequest)

from mxnet_tpu_torch import ops
from mxnet_tpu_torch.convert import load_llama_decode_weights
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                       LlamaForCausalLM)
from mxnet_tpu_torch.serving import (ContinuousBatcher, InferenceEngine,
                                     Request)

GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=64, max_seq_len=64)
# buckets 8, 16 and 32
ENGINE = dict(max_batch=2, block_size=8, max_context=32)
POOLS = {"f32": None, "fp8": "fp8"}
STATS = ("compiles", "compiles_after_warmup", "prefill_calls",
         "decode_calls", "prompt_tokens_computed")


@pytest.fixture(scope="module")
def nets():
    jnet = JaxLlama(JaxConfig(**GEOM))
    jnet.initialize()
    jnet(mx.nd.array([[1, 2, 3]], dtype="int32"))
    jnet.hybridize()
    embed, norm, head, layers = jnet.decode_weights()
    weights = (np.asarray(embed), np.asarray(norm),
               None if head is None else np.asarray(head),
               [tuple(np.asarray(w) for w in layer) for layer in layers])
    pnet = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu")
    return jnet, load_llama_decode_weights(pnet, weights)


def _port(pnet, pool="f32", **kw):
    return InferenceEngine(pnet, device="cpu", kv_dtype=POOLS[pool],
                           **dict(ENGINE, **kw))


def _stats(eng):
    return {k: eng.stats[k] for k in STATS}


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_warmup_and_traffic_count_like_jax(nets, pool):
    """A fresh engine of each package: the same counters after warmup
    (one compile per (kind, bucket)), and after mixed-length traffic
    across the three buckets through each package's ContinuousBatcher
    (no compile after warmup, the same calls); greedy streams equal."""
    jnet, pnet = nets
    jeng = JaxEngine(jnet, kv_dtype=POOLS[pool], prefix_cache=False,
                     **ENGINE).warmup()
    peng = _port(pnet, pool).warmup()
    assert _stats(peng) == _stats(jeng)
    assert peng.stats["compiles"] == 2 * len(peng.buckets) == 6
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 64, (n,)).tolist() for n in (3, 11, 19, 6)]
    jb, pb = JaxContinuous(jeng), ContinuousBatcher(peng)
    for i, p in enumerate(prompts):
        jb.submit(JaxRequest(p, 6, request_id=i))
        pb.submit(Request(p, 6, request_id=i))
    jb.run()
    pb.run()
    streams = {r.id: r.generated for r in pb.finished}
    assert streams == {r.id: r.generated for r in jb.finished}
    assert _stats(peng) == _stats(jeng)
    assert peng.stats["compiles_after_warmup"] == 0
    assert peng.stats["prefill_calls"] == len(prompts)


def test_second_warmup_builds_nothing(nets):
    _, pnet = nets
    eng = _port(pnet).warmup()
    steps = dict(eng._steps)
    before = dict(eng.stats)
    eng.warmup()
    assert eng.stats == before
    assert eng._steps == steps
    assert all(eng._steps[k] is steps[k] for k in steps)


def test_miss_after_warmup_is_counted(nets):
    """Without warmup a call builds its step on first use (a compile);
    after warmup a step missing from the cache counts in
    ``compiles_after_warmup``, as the reference counts."""
    _, pnet = nets
    eng = _port(pnet)
    eng.prefill(0, [1, 2, 3])
    assert _stats(eng)["compiles"] == 1
    eng.warmup()
    assert eng.stats["compiles"] == 6
    assert eng.stats["compiles_after_warmup"] == 0
    del eng._steps["decode", 1]
    assert eng.reserve(0, 3)
    eng.decode([(0, 4, 3)])
    assert eng.stats["compiles"] == 7
    assert eng.stats["compiles_after_warmup"] == 1


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_steps_equal_their_bodies_called_directly(nets, pool):
    """A step's outputs are bitwise its body's on the same static
    inputs (which hold the call's tokens, positions and tables), and
    the decode tables are a contiguous (max_batch, width) view."""
    _, pnet = nets
    eng = _port(pnet, pool).warmup()
    prompt = np.random.RandomState(6).randint(0, 64, (11,)).tolist()
    tok, last = eng.prefill(0, prompt)
    step = eng._steps["prefill", 16]
    assert int(step.args[1]) == len(prompt)
    want_last, want_tok = eng._prefill_body(*step.args)
    assert torch.equal(last, want_last) and tok == int(want_tok[0])
    fed = prompt + [tok]
    for _ in range(6):                       # crosses the 16 -> 32 bucket
        pos = len(fed) - 1
        assert eng.reserve(0, pos)
        nxt, logits = eng.decode([(0, fed[-1], pos)])
        nbl = (16 if pos < 16 else 32) // eng.block_size
        step = eng._steps["decode", nbl]
        toks, positions, tables, blk = step.args
        assert tables.shape == (eng.max_batch, nbl)
        assert tables.is_contiguous()
        assert tables[0].tolist() == eng.cache.table_array([0], nbl)[0] \
            .tolist()
        assert (int(toks[0]), int(positions[0])) == (fed[-1], pos)
        assert torch.equal(logits, eng._decode_body(*step.args)[:1])
        fed.append(int(nxt[0]))


def test_returned_logits_are_not_views_of_the_step(nets):
    """``prefill`` and ``decode`` hand out fresh tensors: the next call
    leaves them as they were."""
    _, pnet = nets
    eng = _port(pnet).warmup()
    t0, l0 = eng.prefill(0, [5, 6, 7])
    t1, l1 = eng.prefill(1, [9, 8, 7])
    outs, toks = [l0, l1], [t0, t1]
    kept = [l0.clone(), l1.clone()]
    for pos in range(3, 6):
        assert eng.reserve(0, pos) and eng.reserve(1, pos)
        nxt, lg = eng.decode([(0, toks[0], pos), (1, toks[1], pos)])
        toks = [int(t) for t in nxt]
        outs.append(lg)
        kept.append(lg.clone())
    eng.prefill("late", [1])
    for out, ref in zip(outs, kept):
        assert torch.equal(out, ref)


@pytest.mark.parametrize("top_k", [0, 3])
def test_sampling_draws_as_multinomial(nets, top_k):
    """The engine's categorical draw (written out so a graph can hold
    it) takes the same numbers from the generator as
    ``torch.multinomial(p, 1)`` and picks the same tokens."""
    _, pnet = nets
    eng = _port(pnet, temperature=0.7, top_k=top_k, seed=4)
    logits = torch.from_numpy(
        np.random.RandomState(8).randn(5, 64).astype(np.float32))
    ref_gen = torch.Generator().manual_seed(4)
    for _ in range(4):
        got = eng._sample(logits)
        scaled = logits / 0.7
        idx = None
        if top_k:
            scaled, idx = torch.topk(scaled, top_k, dim=-1)
        pick = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                 generator=ref_gen)
        if idx is not None:
            pick = torch.gather(idx, 1, pick)
        assert torch.equal(got, pick[:, 0].to(torch.int32))
    assert torch.equal(eng._gen.get_state(), ref_gen.get_state())


def test_add_launches_adds_by_name():
    """What a graph replay reports: counts added by their
    ``launch_counts`` names, K5's fp8 launches apart."""
    ops.reset_launches()
    ops.add_launches({"flash_attention_fwd": 3,
                      "paged_decode_attention_fp8": 2})
    ops.add_launches({"paged_decode_attention_fp8": -1})
    got = ops.launch_counts()
    assert got["flash_attention_fwd"] == 3
    assert got["paged_decode_attention_fp8"] == 1
    assert sum(got.values()) == 4
    ops.reset_launches()
    assert not any(ops.launch_counts().values())
