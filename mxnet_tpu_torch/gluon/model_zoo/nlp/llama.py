"""Llama-family decoder LM as Gluon ``HybridBlock``s.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/llama.py``: RMSNorm +
interleaved RoPE + grouped-query attention + SwiGLU, causal attention
through the flash kernel (``ops.flash_attention``).  The blocks, their
children and their structural parameter names are the reference's
(``model.embed.weight``, ``model.layers.0.attention.q_proj.weight``,
..., ``lm_head.weight``), so ``save_parameters`` files and
``convert.load_block_weights`` cross between the packages, and
``Trainer(net.collect_params())``, ``DataParallelTrainer`` and
``contrib.quantization.quantize_net`` take the net.  The math the
reference runs through ``apply_nary`` runs through ``nd.apply``:
``rms_norm``, ``llama_attention``, ``swiglu`` and ``tied_lm_head``.
``_rms``, ``_rope_cos_sin``, ``_rot_interleaved`` and
``_cache_attention`` are the shared math the serving engine reuses.

Construction.  ``LlamaForCausalLM(cfg)`` is the reference's: the
parameters wait for ``net.initialize(ctx=...)`` (the initializers draw
them).  The port adds three keywords: ``device`` places every
parameter there (``cuda`` by default, which raises without a card),
``dtype`` is the parameters' dtype, and ``seed`` allocates the weights
on that device at once and draws them there from one
``torch.Generator`` (normal, std 0.02; norms 1), in the order of the
structural names; no seeded weight passes through the host.  With a
device and no seed the parameters hold no data until
``load_parameters``, ``convert`` or ``set_data`` writes them there: a
forward or an ``InferenceEngine`` raises before.

Numerics follow the reference op for op where the dtype is float32:
RoPE frequencies and angles in float32, ``_rms`` casting the normalised
value back to the input dtype before the weight multiply, K/V heads
repeated with ``repeat_interleave`` (``jnp.repeat``).  In bfloat16 the
port keeps activations in bfloat16 (the rotation is computed in float32
and rounded back), where JAX's type promotion would widen them to
float32 after the rotation; parity with the reference is held in float32.
Under ``amp.init("bfloat16")`` the outermost block call opens the
``amp`` region and the ops cast by the registry's lists, as every Gluon
block does: the projections (``FullyConnected``) run in bfloat16, and
K3 takes bfloat16 q and k after RoPE (``amp`` module doc).

``fused_ce_loss`` runs the head and the loss through
``ops.fused_linear_cross_entropy`` (the vocabulary in blocks).
``generate`` decodes with dense per-layer caches, one step a position,
over ``decode_weights()``; on CUDA each step is one CUDA graph, captured
once a signature and replayed (see :class:`_GenerateStep`).  Tensor and
context parallelism are not ported (ROADMAP §1 item 10b).
"""
from __future__ import annotations

import math
import time

import torch
import torch.nn.functional as F_

from .... import _graphs
from ....base import MXNetError, NotSupportedError
from ....context import resolve_device
from ....ndarray.ndarray import NDArray, _dtype_of, apply
from ....ops.blocked_cross_entropy import fused_linear_cross_entropy
from ....ops.flash_attention import flash_attention
from ...block import HybridBlock
from ... import nn

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "RMSNorm",
           "llama3_8b", "llama_tiny"]

_NEG_INF = -1e30
_INIT_STD = 0.02


class LlamaConfig:
    def __init__(self, vocab_size=128256, hidden_size=4096,
                 intermediate_size=14336, num_layers=32, num_heads=32,
                 num_kv_heads=8, max_seq_len=8192, rope_theta=500000.0,
                 rms_eps=1e-5, tie_embeddings=False,
                 tensor_parallel=False, context_parallel=False):
        if tensor_parallel or context_parallel:
            raise NotSupportedError(
                "tensor and context parallelism are not ported yet: they "
                "arrive with the multi-device slice")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.max_seq_len = max_seq_len
        self.rope_theta = rope_theta
        self.rms_eps = rms_eps
        self.tie_embeddings = tie_embeddings
        if hidden_size % num_heads:
            raise MXNetError("num_heads must divide hidden_size")
        if num_heads % num_kv_heads:
            raise MXNetError("num_kv_heads must divide num_heads")
        self.head_dim = hidden_size // num_heads


def _rms(d, w, eps):
    """Shared RMSNorm math (layer forward and the engine): reduce in
    float32, cast back to the input dtype, then scale by the weight."""
    d32 = d.float()
    var = torch.mean(d32 * d32, dim=-1, keepdim=True)
    return (d32 / torch.sqrt(var + eps)).to(d.dtype) * w


def _rope_cos_sin(pos, d, theta):
    """cos/sin of ``pos * theta ** (-arange(0, d, 2) / d)`` in float32;
    ``pos`` is an integer tensor, the result has shape ``pos.shape +
    (d/2,)``."""
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.int32,
                                    device=pos.device) / d)
    ang = pos.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _rot_interleaved(u, cos, sin):
    """Shared interleaved-pair RoPE rotation: pairs are
    ``(u[..., 0::2], u[..., 1::2])``, not halves.  cos/sin broadcast
    against ``u[..., 0::2]``; the result has u's dtype."""
    u1, u2 = u[..., 0::2], u[..., 1::2]
    return torch.stack([u1 * cos - u2 * sin, u2 * cos + u1 * sin],
                       dim=-1).reshape(u.shape).to(u.dtype)


def _cache_attention(q, ck, cv, valid, scale):
    """Single-token attention against a KV cache, shared by the plain
    paged-decode op and the tests: the reference's single-block online
    softmax with the initial carry folded in (exact: the carry is 0).

    q: (B, H, D) current-position queries (already rotated);
    ck/cv: (B, KVH, L, D) cache (unrepeated GQA heads);
    valid: (B, L) bool, True where the cache position participates;
    scale: softmax scale.  Returns (B, H*D) in q's dtype.
    """
    b, h, d = q.shape
    kvh, L = ck.shape[1], ck.shape[2]
    rep = h // kvh
    kr = ck.repeat_interleave(rep, dim=1).reshape(b * h, L, d).float()
    vr = cv.repeat_interleave(rep, dim=1).reshape(b * h, L, d)
    s = torch.einsum("bqd,bkd->bqk", q.reshape(b * h, 1, d).float(),
                     kr) * scale
    vmask = valid[:, None, :].expand(b, h, L).reshape(b * h, 1, L)
    s = torch.where(vmask, s, _NEG_INF)
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), _NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bqk,bkd->bqd", p.to(vr.dtype).float(), vr.float())
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out[:, 0].reshape(b, h * d)


def _categorical(scores, gen):
    """One draw a row from ``softmax(scores)``, as ``torch.multinomial(p,
    1)`` draws it but with no host synchronisation, so a CUDA graph can
    capture it: the argmax of ``p / q`` with ``q`` exponential from
    ``gen`` (an exponential race)."""
    p = torch.softmax(scores, dim=-1)
    q = torch.empty_like(p).exponential_(1, generator=gen)
    return torch.argmax(p / q, dim=-1)


class RMSNorm(HybridBlock):
    """Root-mean-square norm (no mean subtraction, no bias)."""

    def __init__(self, hidden_size, eps=1e-5, dtype="float32", **kwargs):
        super().__init__(**kwargs)
        self._eps = eps
        with self.name_scope():
            self.weight = self.params.get("weight", shape=(hidden_size,),
                                          dtype=dtype, init="ones")

    def hybrid_forward(self, F, x, weight):
        eps = self._eps

        def rms_norm(d, w):
            return _rms(d, w, eps)
        return apply(rms_norm, [x, weight])


def _dense(units, in_units, dtype):
    return nn.Dense(units, use_bias=False, flatten=False, dtype=dtype,
                    in_units=in_units)


class LlamaAttention(HybridBlock):
    def __init__(self, cfg, dtype="float32", **kwargs):
        super().__init__(**kwargs)
        self.cfg = cfg
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        hid = cfg.hidden_size
        with self.name_scope():
            self.q_proj = _dense(h * d, hid, dtype)
            self.k_proj = _dense(kvh * d, hid, dtype)
            self.v_proj = _dense(kvh * d, hid, dtype)
            self.o_proj = _dense(hid, h * d, dtype)

    def hybrid_forward(self, F, x):
        cfg = self.cfg
        b, t = x.shape[0], x.shape[1]
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        theta = cfg.rope_theta

        def llama_attention(q, k, v):
            q = q.reshape(b, t, h, d).transpose(1, 2)
            k = k.reshape(b, t, kvh, d).transpose(1, 2)
            v = v.reshape(b, t, kvh, d).transpose(1, 2)
            cos, sin = _rope_cos_sin(torch.arange(t, device=q.device), d,
                                     theta)
            q = _rot_interleaved(q, cos, sin)
            k = _rot_interleaved(k, cos, sin)
            rep = h // kvh
            o = flash_attention(q, k.repeat_interleave(rep, dim=1),
                                v.repeat_interleave(rep, dim=1), causal=True)
            return o.transpose(1, 2).reshape(b, t, h * d)

        out = apply(llama_attention,
                    [self.q_proj(x), self.k_proj(x), self.v_proj(x)])
        return self.o_proj(out)


class LlamaMLP(HybridBlock):
    """SwiGLU feed-forward."""

    def __init__(self, cfg, dtype="float32", **kwargs):
        super().__init__(**kwargs)
        hid, inter = cfg.hidden_size, cfg.intermediate_size
        with self.name_scope():
            self.gate_proj = _dense(inter, hid, dtype)
            self.up_proj = _dense(inter, hid, dtype)
            self.down_proj = _dense(hid, inter, dtype)

    def hybrid_forward(self, F, x):
        def swiglu(g, u):
            return F_.silu(g) * u
        return self.down_proj(apply(swiglu, [self.gate_proj(x),
                                             self.up_proj(x)]))


class LlamaLayer(HybridBlock):
    def __init__(self, cfg, dtype="float32", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dtype)
            self.attention = LlamaAttention(cfg, dtype)
            self.post_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dtype)
            self.mlp = LlamaMLP(cfg, dtype)

    def hybrid_forward(self, F, x):
        x = x + self.attention(self.input_norm(x))
        return x + self.mlp(self.post_norm(x))


class LlamaModel(HybridBlock):
    def __init__(self, cfg, dtype="float32", **kwargs):
        super().__init__(**kwargs)
        self.cfg = cfg
        with self.name_scope():
            self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                      dtype=dtype)
            self.layers = nn.HybridSequential()
            for _ in range(cfg.num_layers):
                self.layers.add(LlamaLayer(cfg, dtype))
            self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, dtype)

    def hybrid_forward(self, F, tokens):
        x = self.embed(tokens)
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)

    def remat(self, active=True):
        """Per-decoder-layer rematerialization: while recording, each
        layer runs under ``torch.utils.checkpoint``, so the backward keeps
        only the layers' boundary activations and recomputes the rest."""
        for layer in self.layers:
            layer.hybridize(active, remat=active)


class LlamaForCausalLM(HybridBlock):
    """Causal LM: ``net(tokens)`` takes an int NDArray ``(B, T)`` and
    returns the logits ``(B, T, vocab)`` as an NDArray.

    ``device``/``dtype``/``seed`` (see the module doc): with a device or
    a seed, every parameter is placed on ``device`` (``cuda`` when None)
    in ``dtype`` (float32 when None); with a seed it is allocated and
    drawn there, without one it holds no data until it is loaded; with
    neither, the parameters wait for ``initialize``, as in the
    reference."""

    def __init__(self, cfg, device=None, dtype=None, seed=None, **kwargs):
        super().__init__(**kwargs)
        self.cfg = cfg
        dt = str(_dtype_of(dtype)).replace("torch.", "")
        with self.name_scope():
            self.model = LlamaModel(cfg, dt)
            self.lm_head = None if cfg.tie_embeddings else \
                _dense(cfg.vocab_size, cfg.hidden_size, dt)
        if device is None and seed is None:
            return
        dev = resolve_device(device)
        if seed is None:
            for p in self.collect_params().values():
                p.reset_ctx(dev)
            return
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        with torch.no_grad():
            # the structural names' order
            for name, p in self._collect_params_with_prefix().items():
                w = torch.empty(p.shape, dtype=_dtype_of(p.dtype), device=dev)
                if name.endswith("norm.weight"):
                    w.fill_(1.0)
                else:
                    w.normal_(0.0, _INIT_STD, generator=gen)
                p._bind(w)

    def hybrid_forward(self, F, tokens):
        x = self.model(tokens)
        if self.lm_head is not None:
            return self.lm_head(x)

        def tied_lm_head(d, emb):
            return d @ emb.T
        return apply(tied_lm_head, [x, self.model.embed.weight.data()])

    def fused_ce_loss(self, tokens, targets, block=2048,
                      ignore_index=None):
        """Per-token cross-entropy of the next-token logits against
        ``targets`` through the blocked fused head
        (``ops.fused_linear_cross_entropy``): the (B, L, V) logits never
        exist.  Returns the losses, shaped as ``tokens``, as an NDArray;
        differentiable under ``autograd.record()``.  A target equal to
        ``ignore_index`` or outside [0, V) gives loss 0 and gradient 0."""
        x = self.model(tokens)
        head = self.model.embed if self.lm_head is None else self.lm_head
        if not isinstance(targets, NDArray):
            targets = NDArray(torch.as_tensor(targets,
                                              device=x.data.device))

        def fused_ce_loss(h, wv, t):
            d = h.shape[-1]
            # the tied embedding and lm_head are both stored (V, d):
            # transposed unconditionally, as the reference does
            loss = fused_linear_cross_entropy(
                h.reshape(-1, d), wv.T, t.reshape(-1), block=block,
                ignore_index=ignore_index)
            return loss.reshape(h.shape[:-1])
        return apply(fused_ce_loss, [x, head.weight.data(), targets])

    #: False runs ``generate``'s step eagerly on CUDA too (the body its
    #: graphs are held against)
    _generate_graphs = True

    def generate(self, tokens, max_new_tokens, temperature=0.0, seed=0):
        """Autoregressive decode with dense per-layer caches ``(B, KVH,
        T_prefix + max_new_tokens, D)`` in the weights' dtype, one step a
        position: the prefix tokens are forced one at a time, then each
        step feeds the last prediction.  Greedy at temperature 0, else a
        categorical draw from ``logits.float() / temperature`` taken from
        a generator on the net's device seeded with ``seed`` at every
        call.  tokens: ``(B, T_prefix)`` integers (an NDArray or an
        array); returns the ``(B, T_prefix + max_new_tokens)`` int32
        NDArray on the net's device.

        The step reads ``decode_weights()``.  On CUDA it is captured as
        one CUDA graph per signature ``(B, T_prefix, total, temperature)``
        and a call is ``total`` replays; a graph is keyed on the weight
        tensors' addresses, so weights loaded into new storage are
        captured again, and weights updated in place are read as they
        are."""
        weights = self.decode_weights()
        emb = weights[0]
        toks = tokens.data if isinstance(tokens, NDArray) else \
            torch.as_tensor(tokens)
        if toks.dim() != 2:
            raise MXNetError(f"generate() takes (batch, prefix) tokens, "
                             f"not shape {tuple(toks.shape)}")
        b, t_prefix = toks.shape
        if t_prefix == 0:
            raise MXNetError("generate() needs at least one prefix token")
        sig = (b, t_prefix, t_prefix + int(max_new_tokens),
               float(temperature))
        leaves = [emb, weights[1]] + ([] if weights[2] is None else
                                      [weights[2]])
        leaves += [w for layer in weights[3] for w in layer]
        key = tuple((w.data_ptr(), w.dtype, tuple(w.shape))
                    for w in leaves)
        cache = self._generate_cache_of()
        steps = cache["steps"]
        step = steps.get(sig)
        if step is None or step.key != key:
            # steps over other weights hold those alive: drop them
            for s_ in [s_ for s_, st in steps.items() if st.key != key]:
                del steps[s_]
            step = steps[sig] = _GenerateStep(self.cfg, weights, sig, key)
        out = step.run(toks.to(emb.device, torch.int32), seed,
                       self._generate_graphs, cache)
        return NDArray(out)

    def _generate_cache_of(self):
        """``generate``'s steps by signature and its capture counts."""
        cache = self.__dict__.get("_generate_cache")
        if cache is None:
            cache = self._generate_cache = {"steps": {}, "captures": 0,
                                            "capture_seconds": 0.0}
        return cache

    def generate_stats(self):
        """``{"captures", "capture_seconds", "graphs"}``: the CUDA graphs
        ``generate`` has captured on this net, the seconds they took, and
        how many are cached now."""
        cache = self._generate_cache_of()
        return {"captures": cache["captures"],
                "capture_seconds": cache["capture_seconds"],
                "graphs": sum(st.graph is not None
                              for st in cache["steps"].values())}

    def _decode_params(self):
        """:meth:`decode_weights`' structure of the Parameters."""
        m = self.model
        layers = []
        for layer in m.layers:
            a, f = layer.attention, layer.mlp
            layers.append(tuple(blk.weight for blk in (
                layer.input_norm, a.q_proj, a.k_proj, a.v_proj, a.o_proj,
                layer.post_norm, f.gate_proj, f.up_proj, f.down_proj)))
        head = None if self.lm_head is None else self.lm_head.weight
        return (m.embed.weight, m.norm.weight, head, layers)

    def decode_weights(self):
        """Decode-weight structure, as the reference's
        ``decode_weights()``: ``(embed, final_norm, lm_head|None,
        [per-layer (in_norm, q, k, v, o, post_norm, gate, up, down)])``.
        The tensors are the parameters' own (no copies)."""
        embed, norm, head, layers = self._decode_params()
        return (embed.data().data, norm.data().data,
                None if head is None else head.data().data,
                [tuple(p.data().data for p in layer) for layer in layers])


class _GenerateStep:
    """One ``generate`` signature over one set of weight tensors.

    Static device buffers: the per-layer caches, the forced tokens (the
    prefix, then zeros), the previous prediction, the position and the
    predictions.  The body is one decode step: it reads the position and
    both tokens from those buffers, writes its K/V rows and its
    prediction, and advances the position, so the same body serves every
    position.  On CUDA it is captured once as a CUDA graph
    (``_graphs.capture``, the sampling generator registered with the
    graph) and a call is ``total`` replays; on the CPU, or with graphs
    off, the body runs eagerly ``total`` times."""

    def __init__(self, cfg, weights, sig, key):
        self.cfg, self.weights, self.key = cfg, weights, key
        b, self.t_prefix, self.total, self.temp = sig
        emb = weights[0]
        dev = emb.device
        shape = (b, cfg.num_kv_heads, self.total, cfg.head_dim)
        self.ck = [torch.zeros(shape, dtype=emb.dtype, device=dev)
                   for _ in weights[3]]
        self.cv = [torch.zeros(shape, dtype=emb.dtype, device=dev)
                   for _ in weights[3]]
        self.forced = torch.zeros((b, self.total), dtype=torch.int32,
                                  device=dev)
        self.out = torch.zeros_like(self.forced)
        self.prev = torch.zeros(b, dtype=torch.int32, device=dev)
        self.pos = torch.zeros(1, dtype=torch.int64, device=dev)
        self.positions = torch.arange(self.total, device=dev)
        self.gen = None if self.temp == 0.0 else torch.Generator(device=dev)
        self.graph = None

    @torch.no_grad()
    def body(self):
        cfg = self.cfg
        emb, norm_w, head_w, layers = self.weights
        h, kvh, d, eps = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                          cfg.rms_eps)
        b, pos = self.prev.shape[0], self.pos
        forced = self.forced.index_select(1, pos)[:, 0]
        tok = torch.where(pos < self.t_prefix, forced, self.prev)
        x = emb[tok.long()]                                  # (B, hidden)
        cos, sin = _rope_cos_sin(pos, d, cfg.rope_theta)
        valid = (self.positions <= pos).expand(b, self.total)
        for (in_w, qw, kw, vw, ow, po_w, gw, uw, dw), ck, cv in zip(
                layers, self.ck, self.cv):
            hh = _rms(x, in_w, eps)
            q = _rot_interleaved((hh @ qw.T).reshape(b, h, d), cos, sin)
            k = _rot_interleaved((hh @ kw.T).reshape(b, kvh, d), cos, sin)
            ck.index_copy_(2, pos, k[:, :, None, :])
            cv.index_copy_(2, pos, (hh @ vw.T).reshape(b, kvh, 1, d))
            o = _cache_attention(q, ck, cv, valid, 1.0 / math.sqrt(d))
            x = x + o @ ow.T
            y = _rms(x, po_w, eps)
            x = x + (F_.silu(y @ gw.T) * (y @ uw.T)) @ dw.T
        logits = _rms(x, norm_w, eps) @ (emb if head_w is None else head_w).T
        if self.temp == 0.0:
            nxt = torch.argmax(logits, dim=-1)
        else:
            nxt = _categorical(logits.float() / self.temp, self.gen)
        nxt = nxt.to(torch.int32)
        self.out.index_copy_(1, pos, nxt[:, None])
        self.prev.copy_(nxt)
        pos.add_(1)

    def _capture(self, cache):
        """Run the body once on a side stream (kernels loaded, cuBLAS
        set up), then capture it with the cyclic collector off."""
        t0 = time.perf_counter()
        dev = self.pos.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.body()
        graph = torch.cuda.CUDAGraph()
        if self.gen is not None:
            graph.register_generator_state(self.gen)
        with _graphs.capture(graph, None, stream):
            self.body()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph = graph
        cache["captures"] += 1
        cache["capture_seconds"] += time.perf_counter() - t0

    def run(self, toks, seed, graphs, cache):
        """Decode ``toks`` (the prefix, on the device, int32); returns the
        prefix followed by the generated tokens."""
        replay = graphs and self.pos.device.type == "cuda"
        if replay and self.graph is None:
            self._capture(cache)
        self.forced[:, :self.t_prefix].copy_(toks)
        self.pos.zero_()
        self.prev.zero_()
        if self.gen is not None:
            self.gen.manual_seed(int(seed))
        for _ in range(self.total):
            if replay:
                self.graph.replay()
            else:
                self.body()
        # out[:, i] is the prediction after position i
        return torch.cat([toks, self.out[:, self.t_prefix - 1:
                                          self.total - 1]], dim=1)


def llama3_8b(device=None, dtype=None, seed=None, **overrides):
    """Llama-3-8B geometry: hidden 4096, 32 layers, 32/8 heads, head_dim
    128, SwiGLU 14336, vocab 128256."""
    return LlamaForCausalLM(LlamaConfig(**overrides), device=device,
                            dtype=dtype, seed=seed)


def llama_tiny(device=None, dtype=None, seed=None, **overrides):
    """Tiny config for tests."""
    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128)
    kw.update(overrides)
    return LlamaForCausalLM(LlamaConfig(**kw), device=device, dtype=dtype,
                            seed=seed)
