"""The port's serving slice against the JAX package, on the CPU.

The JAX net is initialised by the reference; its ``decode_weights()`` are
carried into the port by ``mxnet_tpu_torch.convert`` (never drawn twice
from two RNGs).  Both packages then see the same prompts, made from a
numpy seed.  Tolerance: atol 1e-4 on logits (float32; XLA and PyTorch
sum in other orders and lower RoPE's pow/cos/sin differently), and
greedy token streams must be identical.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.nlp.llama import (
    LlamaConfig as JaxConfig, LlamaForCausalLM as JaxLlama)
from mxnet_tpu.serving import (ContinuousBatcher as JaxContinuous,
                               InferenceEngine as JaxEngine,
                               PagedKVCache as JaxCache, Request as JaxRequest,
                               StaticBatcher as JaxStatic)

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_llama_decode_weights
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                       LlamaForCausalLM)
from mxnet_tpu_torch.serving import (ContinuousBatcher, DoubleFreeError,
                                     InferenceEngine, PagedKVCache, Request,
                                     StaticBatcher)

ATOL = 1e-4
GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=64, max_seq_len=64)
ENGINE = dict(max_batch=2, block_size=8, max_context=32)


def _jax_net(tie):
    net = JaxLlama(JaxConfig(tie_embeddings=tie, **GEOM))
    net.initialize()
    net(mx.nd.array([[1, 2, 3]], dtype="int32"))
    net.hybridize()
    return net


def _to_numpy(tree):
    embed, norm, head, layers = tree
    return (np.asarray(embed), np.asarray(norm),
            None if head is None else np.asarray(head),
            [tuple(np.asarray(w) for w in layer) for layer in layers])


def _port_net(jax_net, tie):
    net = LlamaForCausalLM(LlamaConfig(tie_embeddings=tie, **GEOM),
                           device="cpu")
    return load_llama_decode_weights(net, _to_numpy(jax_net.decode_weights()))


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "head"])
def nets(request):
    jnet = _jax_net(request.param)
    # one compile cache for every JAX engine over this net: each graph
    # compiles once, and each test still gets a fresh KV pool
    jnet.engine_compile_cache = {}
    return jnet, _port_net(jnet, request.param)


def _jax_engine(jnet):
    return JaxEngine(jnet, compile_cache=jnet.engine_compile_cache,
                     **ENGINE).warmup()


def _port_engine(pnet):
    return InferenceEngine(pnet, device="cpu", **ENGINE).warmup()


# ----------------------------------------------------------------------
# model forward
# ----------------------------------------------------------------------

def test_forward_matches_jax(nets):
    jnet, pnet = nets
    toks = np.random.RandomState(1).randint(0, 64, (2, 13)).astype(np.int32)
    ref = jnet(mx.nd.array(toks, dtype="int32")).asnumpy()
    with torch.no_grad():
        out = pnet(torch.from_numpy(toks)).numpy()
    assert out.shape == ref.shape == (2, 13, 64)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_convert_rejects_mismatched_geometry(nets):
    jnet, _ = nets
    other = LlamaForCausalLM(LlamaConfig(**dict(GEOM, hidden_size=64)),
                             device="cpu")
    with pytest.raises(mt.MXNetError):
        load_llama_decode_weights(other, _to_numpy(jnet.decode_weights()))


# ----------------------------------------------------------------------
# engine: prefill + greedy decode
# ----------------------------------------------------------------------

def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _drive(eng, slot, prompt, n_steps):
    """Prefill + n_steps greedy decode; returns (tokens, [logits...])."""
    tok, last = eng.prefill(slot, prompt)
    cur = list(prompt) + [int(tok)]
    logits = [_np(last)]
    for _ in range(n_steps):
        pos = len(cur) - 1
        assert eng.reserve(slot, pos)
        nxt, lg = eng.decode([(slot, cur[-1], pos)])
        logits.append(_np(lg)[0])
        cur.append(int(nxt[0]))
    return cur[len(prompt):], logits


@pytest.mark.parametrize("t0", [5, 12])
def test_engine_prefill_and_decode_match_jax(nets, t0):
    """Prefill logits and 8 greedy decode steps (crossing the 8 -> 16
    and 16 -> 32 buckets) agree with the JAX engine; streams equal."""
    jnet, pnet = nets
    prompt = np.random.RandomState(t0).randint(0, 64, (t0,)).tolist()
    ref_toks, ref_logits = _drive(_jax_engine(jnet), 0, prompt, 8)
    eng = _port_engine(pnet)
    toks, logits = _drive(eng, 0, prompt, 8)
    assert toks == ref_toks
    for a, b in zip(logits, ref_logits):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    assert eng.stats["compiles_after_warmup"] == 0
    assert eng.stats["prefill_calls"] == 1 and eng.stats["decode_calls"] == 8


def test_engine_bf16_pool_stays_close(nets):
    """bf16 KV storage on an f32 model: the first token comes from the
    fresh f32 K/V, later steps read bf16-rounded rows back as f32."""
    _, pnet = nets
    prompt = np.random.RandomState(3).randint(0, 64, (9,)).tolist()
    ref_toks, ref_logits = _drive(_port_engine(pnet), 0, prompt, 4)
    eng = InferenceEngine(pnet, device="cpu", kv_dtype="bf16", **ENGINE)
    assert eng.cache.k_pool.dtype == torch.bfloat16
    toks, logits = _drive(eng.warmup(), 0, prompt, 4)
    np.testing.assert_array_equal(logits[0], ref_logits[0])
    for a, b in zip(logits, ref_logits):
        np.testing.assert_allclose(a, b, atol=2e-2, rtol=0)


def test_engine_topk_sampling_is_seeded_and_within_top_k(nets):
    """Sampled decoding draws from the engine's generator: the same seed
    gives the same token, and the token is one of the top k logits."""
    _, pnet = nets
    prompt = np.random.RandomState(4).randint(0, 64, (7,)).tolist()
    picks = []
    for _ in range(2):
        eng = InferenceEngine(pnet, device="cpu", temperature=1.0, top_k=3,
                              seed=5, **ENGINE)
        tok, last = eng.prefill(0, prompt)
        assert tok in torch.topk(last, 3).indices.tolist()
        picks.append(tok)
    assert picks[0] == picks[1]


# ----------------------------------------------------------------------
# batching
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["continuous", "static"])
def test_batcher_streams_match_jax(nets, kind):
    """3 mixed-length requests through each package's batcher give the
    same streams and the same decode-step count."""
    jnet, pnet = nets
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, 64, (n,)).tolist() for n in (3, 11, 19)]
    jax_cls, port_cls = {"continuous": (JaxContinuous, ContinuousBatcher),
                         "static": (JaxStatic, StaticBatcher)}[kind]
    jb = jax_cls(_jax_engine(jnet))
    pb = port_cls(_port_engine(pnet))
    for i, p in enumerate(prompts):
        jb.submit(JaxRequest(p, 6, request_id=i))
        pb.submit(Request(p, 6, request_id=i))
    js, ps = jb.run(), pb.run()
    streams = {r.id: r.generated for r in pb.finished}
    assert streams == {r.id: r.generated for r in jb.finished}
    assert all(len(s) == 6 for s in streams.values())
    assert ps["decode_steps"] == js["decode_steps"]
    # the reference's stats keys, speculation's at their values without it
    assert set(ps) == set(js)
    assert (ps["verify_steps"], ps["spec_accept_rate"]) == \
        (js["verify_steps"], js["spec_accept_rate"]) == (0, None)
    assert ps["cache"]["blocks_in_use"] == 0
    pb.engine.cache.check_leaks()


# ----------------------------------------------------------------------
# paged KV cache: host accounting op for op
# ----------------------------------------------------------------------

def _state(c):
    return (c.num_free_blocks, c.blocks_in_use, c.alloc_failures,
            c.cow_copies, sorted(c._refs.items()),
            {str(s): c.table(s) for s in c._tables})


def _run(op, c, held):
    try:
        return op(c, held)
    except (mx.MXNetError, mt.MXNetError) as e:
        return type(e).__name__


_CACHE_OPS = [
    lambda c, h: c.alloc("a", 10),
    lambda c, h: c.alloc("b", 17),
    lambda c, h: c.alloc("c", 1),                  # pool exhausted
    lambda c, h: c.ensure("a", 12),                # no block for it yet
    lambda c, h: c.free("b"),
    lambda c, h: c.ensure("a", 12),
    lambda c, h: c.trim("a", 10),
    lambda c, h: c.table_array(["a", None], 4).tolist(),
    lambda c, h: c.alloc("d", 6),
    lambda c, h: c.alloc("d", 6),                  # already allocated
    # a prefix chain shares d's first block; writing it copies on write
    lambda c, h: (h.__setitem__("shared", c.table("d")[0]),
                  c.ref(h["shared"]))[1],
    lambda c, h: c.refcount(h["shared"]),
    lambda c, h: c.prepare_write("d", 0, 5),
    lambda c, h: c.unref(h["shared"]),
    lambda c, h: c.unref(h["shared"]),             # underflow
    lambda c, h: c.free("a"),
    lambda c, h: c.adopt("e", c.table("d"), 6),
    lambda c, h: c.free("d"),
    lambda c, h: c.alloc("f", 24),
    lambda c, h: c.free("e"),
    lambda c, h: c.free("e"),                      # double free
    lambda c, h: c.free("f"),
]


def test_cache_accounting_matches_jax_op_for_op():
    kw = dict(num_layers=1, num_kv_heads=2, head_dim=8, num_blocks=9,
              block_size=4, max_batch=2)
    ref, port = JaxCache(**kw), PagedKVCache(device="cpu", **kw)
    held_ref, held_port = {}, {}
    for i, op in enumerate(_CACHE_OPS):
        assert _run(op, ref, held_ref) == _run(op, port, held_port), i
        assert _state(ref) == _state(port), i
    assert port.check_leaks() and port.blocks_in_use == 0
    assert port.num_free_blocks == 8 and port.cow_copies == 1


def test_cache_rejects_bad_config_and_double_free():
    with pytest.raises(mt.MXNetError):
        PagedKVCache(1, 2, 8, num_blocks=4, block_size=3, device="cpu")
    with pytest.raises(mt.MXNetError):
        PagedKVCache(1, 2, 8, num_blocks=1, device="cpu")
    c = PagedKVCache(1, 2, 8, num_blocks=4, block_size=4, device="cpu")
    assert c.alloc("a", 4)
    with pytest.raises(mt.MXNetError):
        c.alloc("a", 4)
    c.free("a")
    with pytest.raises(DoubleFreeError):
        c.free("a")


# ----------------------------------------------------------------------
# devices and refusals
# ----------------------------------------------------------------------

def test_entry_points_refuse_without_a_card():
    """Without ``device="cpu"`` the entry points ask for CUDA; on a host
    without a card they raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    with pytest.raises(mt.MXNetError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig(**GEOM))
    with pytest.raises(mt.MXNetError, match="device='cpu'"):
        PagedKVCache(1, 2, 8)
    net = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu")
    with pytest.raises(mt.MXNetError, match="device='cpu'"):
        InferenceEngine(net)


@pytest.mark.parametrize("kwargs", [
    {"quantize": "int8"}, {"mesh": "tp=2"}, {"kv_cache": object()},
    {"calib_data": [np.zeros((1, 4), np.int32)]}, {"compile_cache": {}},
    {"paged_attn": False}],
    ids=lambda kw: next(iter(kw)))
def test_engine_refuses_later_slices(kwargs):
    net = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu")
    with pytest.raises(mt.NotSupportedError, match="ROADMAP §"):
        InferenceEngine(net, device="cpu", **kwargs)


@pytest.mark.parametrize("port_cls,jax_cls", [
    (InferenceEngine, JaxEngine), (ContinuousBatcher, JaxContinuous),
    (StaticBatcher, JaxStatic), (PagedKVCache, JaxCache)],
    ids=["engine", "continuous", "static", "cache"])
def test_constructors_take_the_reference_arguments(port_cls, jax_cls):
    """Each constructor takes the reference's parameters, in its order and
    with its defaults; the port's ``device=`` comes last."""
    import inspect
    port = list(inspect.signature(port_cls).parameters.values())
    ref = list(inspect.signature(jax_cls).parameters.values())
    if port_cls in (InferenceEngine, PagedKVCache):
        assert port[-1].name == "device"
        port = port[:-1]
    assert [(p.name, p.default) for p in port] == \
        [(p.name, p.default) for p in ref]


def test_reference_defaults_and_no_op_values_are_taken():
    """``max_batch=None`` / ``block_size=None`` mean 4 and 16 (the
    reference's without its environment); the no-op values of the other
    arguments change nothing."""
    net = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu")
    eng = InferenceEngine(net, None, None, None, 32, 0.0, 0, 0, None, None,
                          3, None, None, None, None, None, None, True, None,
                          None, device="cpu")
    assert (eng.max_batch, eng.block_size, eng.max_context) == (4, 16, 32)
    for cls in (ContinuousBatcher, StaticBatcher):
        kw = dict(slot_ns=None, role="combined")
        if cls is ContinuousBatcher:
            kw.update(prefills_per_step=2, speculative=None, spec_k=None)
        assert cls(eng, **kw).engine is eng
        for bad in ({"slot_ns": "a"}, {"role": "decode"}):
            with pytest.raises(mt.NotSupportedError, match="item 5"):
                cls(eng, **bad)
    # speculation is ported: the batcher follows the engine's
    # ``spec_decode`` and ``spec_k`` and refuses more than the engine built
    with pytest.raises(mt.MXNetError, match="spec_decode=True"):
        ContinuousBatcher(eng, speculative=True)
    assert ContinuousBatcher(eng, spec_k=2).spec_k == 2
    assert not ContinuousBatcher(eng).speculative
    cache = PagedKVCache(1, 2, 8, 4, 4, 2, None, None, "bf16", device="cpu")
    assert cache.dtype == torch.bfloat16
    with pytest.raises(mt.NotSupportedError, match="item 10"):
        PagedKVCache(1, 2, 8, sharding=object(), device="cpu")


def test_decode_returns_numpy_tokens_and_device_logits(nets):
    """A standing difference: ``decode`` returns the tokens as numpy, as
    the reference does, and the logits as a tensor on the engine's
    device (the reference returns numpy), sparing a host copy of n x
    vocab logits a step; ``prefill``'s logits are device values in
    both."""
    _, pnet = nets
    eng = _port_engine(pnet)
    tok, last = eng.prefill(0, [1, 2, 3])
    assert isinstance(last, torch.Tensor)
    assert eng.reserve(0, 3)
    nxt, logits = eng.decode([(0, int(tok), 3)])
    assert isinstance(nxt, np.ndarray) and nxt.dtype == np.int32
    assert isinstance(logits, torch.Tensor)
    assert logits.device == eng.device and logits.shape == (1, 64)


def test_config_refuses_parallel_modes():
    with pytest.raises(mt.NotSupportedError):
        LlamaConfig(tensor_parallel=True, **GEOM)
