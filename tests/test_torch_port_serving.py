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
from mxnet_tpu_torch.contrib.quantization import (QuantizedDense, _walk,
                                                  quantize_net)
from mxnet_tpu_torch.convert import (load_block_weights,
                                     load_llama_decode_weights,
                                     load_quantized_state, quantized_state)
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                       LlamaForCausalLM)
from mxnet_tpu_torch.serving import (ContinuousBatcher, DoubleFreeError,
                                     InferenceEngine, PagedKVCache, Request,
                                     StaticBatcher)
from mxnet_tpu_torch.serving.engine import next_bucket
from test_torch_port_amp import seeded

ATOL = 1e-4
# int8 engines against the JAX int8 engine on the same codes: an
# activation code may flip by one at a rounding boundary where the two
# packages' f32 activations differ in the last digits (none flipped in
# these runs: the logits agreed bitwise)
INT8_ATOL = 1e-3
# fp8 pools against f32 pools under one int8 net: the decode steps read
# e4m3 rows back (the fp8 tests' limit)
FP8_ATOL = 2e-2
GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=64, max_seq_len=64)
ENGINE = dict(max_batch=2, block_size=8, max_context=32)


def _jax_net(tie):
    net = JaxLlama(JaxConfig(tie_embeddings=tie, **GEOM))
    with seeded(26):
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
    out = pnet(mt.nd.array(toks, ctx=mt.cpu())).asnumpy()
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
        LlamaForCausalLM(LlamaConfig(**GEOM), seed=0)
    with pytest.raises(mt.MXNetError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig(**GEOM)).initialize()
    with pytest.raises(mt.MXNetError, match="device='cpu'"):
        PagedKVCache(1, 2, 8)
    net = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu")
    with pytest.raises(mt.MXNetError, match="device='cpu'"):
        InferenceEngine(net)


@pytest.mark.parametrize("kwargs", [
    {"mesh": "tp=2"}, {"kv_cache": None}, {"compile_cache": {}},
    {"paged_attn": False}],
    ids=lambda kw: next(iter(kw)))
def test_engine_refuses_later_slices(kwargs):
    """What is not ported raises ``NotSupportedError`` naming ROADMAP.
    ``kv_cache`` is ported: a pool of another geometry raises the
    reference's mismatch error instead."""
    net = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu")
    if "kv_cache" in kwargs:
        net = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu", seed=0)
        other = PagedKVCache(1, GEOM["num_kv_heads"], 8, device="cpu")
        with pytest.raises(mt.MXNetError, match="geometry mismatch"):
            InferenceEngine(net, device="cpu", kv_cache=other)
        return
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
    net = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu", seed=0)
    eng = InferenceEngine(net, None, None, None, 32, 0.0, 0, 0, None, None,
                          3, None, None, None, None, None, None, True, None,
                          None, device="cpu")
    assert (eng.max_batch, eng.block_size, eng.max_context) == (4, 16, 32)
    for cls in (ContinuousBatcher, StaticBatcher):
        kw = dict(slot_ns=None, role="combined")
        if cls is ContinuousBatcher:
            kw.update(prefills_per_step=2, speculative=None, spec_k=None)
        assert cls(eng, **kw).engine is eng
        # the disaggregated roles and slot namespaces are ported
        b = cls(eng, slot_ns="a", role="decode")
        assert (b.slot_ns, b.role) == ("a", "decode")
        with pytest.raises(mt.MXNetError, match="combined|prefill|decode"):
            cls(eng, role="router")
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


def test_engine_return_types_follow_the_reference(nets):
    """``prefill`` returns (int, device logits) in both packages;
    ``decode`` numpy tokens in both and the logits on the engine's device
    (standing difference g: the reference returns numpy);
    ``chunk_prefill`` numpy tokens and numpy logits in both."""
    jnet, pnet = nets
    kw = dict(ENGINE, prefill_chunk=8)
    jeng = JaxEngine(jnet, compile_cache=jnet.engine_compile_cache,
                     **kw).warmup()
    peng = InferenceEngine(pnet, device="cpu", **kw).warmup()
    out = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        tok, last = eng.prefill(0, [1, 2, 3])
        assert eng.reserve(0, 3)
        nxt, logits = eng.decode([(0, int(tok), 3)])
        assert eng.cache.alloc(1, 0)
        ctoks, clogits = eng.chunk_prefill([(1, [4, 5, 6, 7], 0)])
        out[name] = (tok, last, nxt, logits, ctoks, clogits)
    jtok, jlast, jnxt, _, jct, jcl = out["jax"]
    tok, last, nxt, logits, ct, cl = out["port"]
    assert type(tok) is type(jtok) is int
    assert isinstance(last, torch.Tensor) and not isinstance(jlast,
                                                             np.ndarray)
    for got, want in ((nxt, jnxt), (ct, jct), (cl, jcl)):
        assert isinstance(got, np.ndarray) and isinstance(want, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
    assert isinstance(logits, torch.Tensor) and logits.device == peng.device
    np.testing.assert_allclose(cl, jcl, atol=ATOL, rtol=0)


# ----------------------------------------------------------------------
# int8 weight serving
# ----------------------------------------------------------------------

def _calib(seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, (2, 12)).astype(np.int32) for _ in range(2)]


def _port_float(weights, tie=False, dtype=None):
    net = LlamaForCausalLM(LlamaConfig(tie_embeddings=tie, **GEOM),
                           device="cpu", dtype=dtype)
    return load_block_weights(net, weights)


def _block_weights(jnet):
    return {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def int8_nets():
    """The JAX net quantized by its int8 engine's calibration (the
    engine's compile in here), and the port's net on the carried float
    weights and int8 codes."""
    jnet = _jax_net(False)
    weights = _block_weights(jnet)
    jeng = JaxEngine(jnet, quantize="int8",
                     calib_data=[mx.nd.array(b, dtype="int32")
                                 for b in _calib()], **ENGINE)
    assert jeng.quantized
    jeng.warmup()
    pnet = load_quantized_state(_port_float(weights), quantized_state(jnet))
    return dict(jnet=jnet, jeng=jeng, pnet=pnet, weights=weights)


def _forward_rows(net, toks, bucket):
    """The net's own forward over ``toks`` padded to ``bucket``: the
    logits of each position (the reference engine's parity oracle)."""
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :len(toks)] = toks
    return net(mt.nd.array(padded, ctx=mt.cpu())).data[0]


def test_int8_engine_is_its_quantized_net_bitwise(int8_nets):
    """Prefill and 8 decode steps of the port's int8 engine equal the
    port's quantized net's own forward at each step's bucket width,
    bitwise: the engine's projections are ``QuantizedDense``'s ops and
    the int32 product is exact."""
    pnet = int8_nets["pnet"]
    eng = InferenceEngine(pnet, quantize="int8", device="cpu",
                          **ENGINE).warmup()
    assert eng.quantized
    prompt = np.random.RandomState(5).randint(0, 64, (6,)).tolist()
    tok, last = eng.prefill(0, prompt)
    bucket = next_bucket(len(prompt), eng.buckets)
    assert torch.equal(last, _forward_rows(pnet, prompt, bucket)[5])
    cur = list(prompt) + [tok]
    for _ in range(8):
        pos = len(cur) - 1
        assert eng.reserve(0, pos)
        nxt, lg = eng.decode([(0, cur[-1], pos)])
        want = _forward_rows(pnet, cur, next_bucket(pos + 1, eng.buckets))
        assert torch.equal(lg[0], want[pos]), pos
        cur.append(int(nxt[0]))
    assert eng.stats["compiles_after_warmup"] == 0


def test_int8_engine_matches_the_jax_int8_engine(int8_nets):
    prompt = np.random.RandomState(6).randint(0, 64, (9,)).tolist()
    ref_toks, ref_logits = _drive(int8_nets["jeng"], 0, prompt, 8)
    int8_nets["jeng"].release(0)
    eng = InferenceEngine(int8_nets["pnet"], quantize="int8", device="cpu",
                          **ENGINE).warmup()
    toks, logits = _drive(eng, 0, prompt, 8)
    assert toks == ref_toks
    for a, b in zip(logits, ref_logits):
        assert a.dtype == np.asarray(b).dtype == np.float32
        np.testing.assert_allclose(a, b, atol=INT8_ATOL, rtol=0)


def _int8_dtype_calls(eng):
    """Prefill, one decode step and one chunk: their logits."""
    tok, last = eng.prefill(0, [1, 2, 3])
    assert eng.reserve(0, 3)
    _, logits = eng.decode([(0, int(tok), 3)])
    assert eng.cache.alloc(1, 0)
    _, clogits = eng.chunk_prefill([(1, [4, 5, 6], 0)])
    return last, logits, clogits


@pytest.fixture(scope="module")
def jax_int8_bf16():
    """The reference's int8 engine on a bf16 net: the float weights it
    started from and its logits' dtypes (its compiles here, outside the
    test's call)."""
    jnet = _jax_net(False)
    weights = _block_weights(jnet)
    jnet.cast("bfloat16")
    calib = [mx.nd.array(b, dtype="int32") for b in _calib()]
    jeng = JaxEngine(jnet, quantize="int8", calib_data=calib,
                     **dict(ENGINE, prefill_chunk=8))
    return weights, [str(np.asarray(x).dtype)
                     for x in _int8_dtype_calls(jeng)]


def test_int8_logit_dtypes_follow_the_reference_in_bf16(jax_int8_bf16):
    """In a bf16 net the int8 projections leave f32, as the reference's:
    the prefill, decode and chunk logits are f32 in both packages, and
    the port's prefill attention takes f32 q, k and v."""
    from mxnet_tpu_torch.serving import engine as engine_mod
    weights, jax_dtypes = jax_int8_bf16
    kw = dict(ENGINE, prefill_chunk=8)
    pnet = _port_float(weights, dtype=torch.bfloat16)
    peng = InferenceEngine(pnet, quantize="int8", calib_data=_calib(),
                           device="cpu", **kw)
    seen = []
    flash = engine_mod.flash_attention

    def recording(q, k, v, **a):
        seen.append((q.dtype, k.dtype, v.dtype))
        return flash(q, k, v, **a)
    engine_mod.flash_attention = recording
    try:
        port_dtypes = [str(x.dtype).replace("torch.", "")
                       for x in _int8_dtype_calls(peng)]
    finally:
        engine_mod.flash_attention = flash
    assert port_dtypes == jax_dtypes == ["float32"] * 3
    assert seen and set(seen) == {(torch.float32,) * 3}
    assert peng.cache.k_pool.dtype == torch.bfloat16


def test_int8_chunk_verify_and_fp8_pools(int8_nets):
    """The chunk and verify families and fp8 pools under int8 weights:
    a prompt chunked in two gives the plain prefill's tokens; a verify
    whose drafts are the plain stream accepts them all; an fp8-pool
    engine's prefill logits equal the f32 pool's (its own attention
    reads the fresh K/V) and its decode logits stay within the fp8
    limit."""
    pnet = int8_nets["pnet"]
    prompt = np.random.RandomState(7).randint(0, 64, (12,)).tolist()
    plain = InferenceEngine(pnet, quantize="int8", device="cpu",
                            **ENGINE).warmup()
    ref_toks, ref_logits = _drive(plain, 0, prompt, 4)
    eng = InferenceEngine(pnet, quantize="int8", device="cpu",
                          prefill_chunk=8, spec_decode=True, spec_k=3,
                          **ENGINE).warmup()
    assert eng.cache.alloc(0, 0)
    out = eng.chunk_prefill([(0, prompt[:8], 0)])
    out = eng.chunk_prefill([(0, prompt[8:], 8)])
    assert int(out[0][0]) == ref_toks[0]
    np.testing.assert_allclose(out[1][0], ref_logits[0], atol=1e-5, rtol=0)
    pos = len(prompt)
    assert eng.reserve(0, pos, 4)
    got = eng.verify([(0, ref_toks[:4], pos)])
    assert got[0].tolist()[:3] == ref_toks[1:4]
    fp8 = InferenceEngine(pnet, quantize="int8", kv_dtype="fp8",
                          device="cpu", **ENGINE).warmup()
    tok, last = fp8.prefill(0, prompt)
    np.testing.assert_array_equal(_np(last), ref_logits[0])
    fed = list(prompt) + ref_toks        # teacher-forced: the plain stream
    for step in range(4):
        pos = len(prompt) + step
        assert fp8.reserve(0, pos)
        _, lg = fp8.decode([(0, fed[pos], pos)])
        np.testing.assert_allclose(_np(lg)[0], ref_logits[step + 1],
                                   atol=FP8_ATOL, rtol=0)


def test_int8_engine_takes_quantize_and_calib_data():
    """``quantize="int8"`` with ``calib_data`` quantizes a float net in
    place (7 projections a layer and the head); ``quantize`` and
    ``calib_data`` are ported, so neither is refused."""
    net = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu", seed=0)
    eng = InferenceEngine(net, quantize="int8", calib_data=_calib(),
                          num_calib_batches=1, device="cpu", **ENGINE)
    assert eng.quantized
    twins = [b for b in _walk(net) if isinstance(b, QuantizedDense)]
    assert len(twins) == 2 * 7 + 1
    assert eng.params["head"]["qw"] is net.lm_head.quantized_weight
    tok, last = eng.warmup().prefill(0, [1, 2, 3])
    assert last.dtype == torch.float32 and torch.isfinite(last).all()


def test_int8_engine_follows_a_reloaded_quantized_state():
    """``load_quantized_state`` writes the codes, the scales and the
    activation scale in place, so an engine built before it serves the
    new state (its steps read the twins' own tensors), as an engine
    built after it does."""
    net = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu", seed=0)
    quantize_net(net, calib_data=[mt.nd.array(b, ctx=mt.cpu())
                                  for b in _calib()])
    early = InferenceEngine(net, quantize="int8", device="cpu", **ENGINE)
    other = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu", seed=1)
    quantize_net(other, calib_data=[mt.nd.array(b, ctx=mt.cpu())
                                    for b in _calib(2)])
    old, new = quantized_state(net), quantized_state(other)
    assert all(old[k][2] != new[k][2] for k in old)
    load_quantized_state(net, new)
    _, got = early.prefill(0, [1, 2, 3])
    _, want = InferenceEngine(net, quantize="int8", device="cpu",
                              **ENGINE).prefill(0, [1, 2, 3])
    assert torch.equal(got, want)


def test_int8_refusals_follow_the_reference():
    """``quantize="int4"`` and ``quantize="int8"`` on a float net without
    ``calib_data`` raise ``MXNetError`` with the reference's messages; an
    engine built before ``quantize_net`` swapped the projections refuses
    to serve at ``warmup``, ``prefill`` and ``chunk_prefill``."""
    net = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu", seed=0)
    with pytest.raises(mt.MXNetError, match="only int8"):
        InferenceEngine(net, quantize="int4", device="cpu")
    with pytest.raises(mt.MXNetError, match="needs calib_data"):
        InferenceEngine(net, quantize="int8", device="cpu")
    early = InferenceEngine(net, device="cpu", prefill_chunk=8, **ENGINE)
    early.prefill(0, [1, 2, 3])
    quantize_net(net, calib_data=[mt.nd.array(b, ctx=mt.cpu())
                                  for b in _calib()])
    assert early.cache.alloc(2, 0)
    for call in (early.warmup, lambda: early.prefill(1, [1, 2, 3]),
                 lambda: early.chunk_prefill([(2, [1, 2], 0)])):
        with pytest.raises(mt.MXNetError, match="quantize_net"):
            call()
    late = InferenceEngine(net, quantize="int8", device="cpu", **ENGINE)
    assert late.warmup().prefill(0, [1, 2, 3]) is not None
