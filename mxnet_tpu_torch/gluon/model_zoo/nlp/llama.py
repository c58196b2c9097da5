"""Llama-family decoder LM as PyTorch modules.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/llama.py``: RMSNorm +
interleaved RoPE + grouped-query attention + SwiGLU, causal attention
through the flash kernel (``ops.flash_attention``).  ``_rms``,
``_rot_interleaved`` and ``_cache_attention`` are the shared math the
serving engine reuses, as in the reference.

Numerics follow the reference op for op where the dtype is float32:
RoPE frequencies and angles in float32, ``_rms`` casting the normalised
value back to the input dtype before the weight multiply, K/V heads
repeated with ``repeat_interleave`` (``jnp.repeat``).  In bfloat16 the
port keeps activations in bfloat16 (the rotation is computed in float32
and rounded back), where JAX's type promotion would widen them to
float32 after the rotation; parity with the reference is held in float32.
Under ``amp.init("bfloat16")`` the same holds of q and k after RoPE
(``amp`` module doc), and the forward body runs in one autocast region.

Not in this slice: ``generate()``, tensor and context parallelism and
``fused_ce_loss``.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from .... import amp
from ....base import MXNetError, NotSupportedError
from ....context import resolve_device
from ....ops.flash_attention import flash_attention

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


class RMSNorm(nn.Module):
    """Root-mean-square norm (no mean subtraction, no bias)."""

    def __init__(self, hidden_size, eps=1e-5, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return _rms(x, self.weight, self.eps)


def _linear(n_in, n_out, device, dtype):
    return nn.Linear(n_in, n_out, bias=False, device=device, dtype=dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.q_proj = _linear(cfg.hidden_size, h * d, device, dtype)
        self.k_proj = _linear(cfg.hidden_size, kvh * d, device, dtype)
        self.v_proj = _linear(cfg.hidden_size, kvh * d, device, dtype)
        self.o_proj = _linear(h * d, cfg.hidden_size, device, dtype)

    def forward(self, x):
        cfg = self.cfg
        b, t = x.shape[0], x.shape[1]
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.q_proj(x).reshape(b, t, h, d).transpose(1, 2)
        k = self.k_proj(x).reshape(b, t, kvh, d).transpose(1, 2)
        v = self.v_proj(x).reshape(b, t, kvh, d).transpose(1, 2)
        cos, sin = _rope_cos_sin(torch.arange(t, device=x.device), d,
                                 cfg.rope_theta)
        q = _rot_interleaved(q, cos, sin)
        k = _rot_interleaved(k, cos, sin)
        rep = h // kvh
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        o = flash_attention(q, k, v, causal=True)
        return self.o_proj(o.transpose(1, 2).reshape(b, t, h * d))


class LlamaMLP(nn.Module):
    """SwiGLU feed-forward."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        hid, inter = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _linear(hid, inter, device, dtype)
        self.up_proj = _linear(hid, inter, device, dtype)
        self.down_proj = _linear(inter, hid, device, dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaLayer(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device, dtype)
        self.attention = LlamaAttention(cfg, device, dtype)
        self.post_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device, dtype)
        self.mlp = LlamaMLP(cfg, device, dtype)

    def forward(self, x):
        x = x + self.attention(self.input_norm(x))
        return x + self.mlp(self.post_norm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                  device=device, dtype=dtype)
        self.layers = nn.ModuleList(LlamaLayer(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device, dtype)

    def forward(self, tokens):
        x = self.embed(tokens.long())
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Causal LM.  Built directly on ``device`` (``cuda`` by default;
    raises without a card unless ``device="cpu"``): the modules are laid
    out on the meta device, storage is allocated on the target, and the
    weights are drawn there from a generator seeded with ``seed``
    (normal, std 0.02; norms 1).  No weight ever passes through the host.
    ``seed=None`` leaves the storage uninitialised, for weights that are
    loaded right after (``load_state_dict``, ``convert``).
    """

    def __init__(self, cfg, device=None, dtype=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        dtype = dtype or torch.float32
        with torch.device("meta"):
            self.model = LlamaModel(cfg, dtype=dtype)
            self.lm_head = None if cfg.tie_embeddings else \
                _linear(cfg.hidden_size, cfg.vocab_size, None, dtype)
        self.to_empty(device=dev)
        if seed is not None:
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        """Seeded random init on the model's own device."""
        dev = self.model.embed.weight.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, _INIT_STD, generator=gen)

    def forward(self, tokens):
        """Logits ``(B, T, vocab)``.  While ``amp.init()`` is in force the
        body runs in one ``torch.autocast`` region (``amp.region``): the
        projections and the LM head in the target dtype, so the logits
        leave it in bf16; otherwise nothing changes."""
        with amp.region(self.model.embed.weight.device.type):
            x = self.model(tokens)
            if self.lm_head is not None:
                return self.lm_head(x)
            return x @ self.model.embed.weight.T

    def decode_weights(self):
        """Decode-weight structure, as the reference's
        ``decode_weights()``: ``(embed, final_norm, lm_head|None,
        [per-layer (in_norm, q, k, v, o, post_norm, gate, up, down)])``.
        The tensors are the modules' own parameters (no copies)."""
        m = self.model
        layers = []
        for layer in m.layers:
            a, f = layer.attention, layer.mlp
            layers.append((layer.input_norm.weight, a.q_proj.weight,
                           a.k_proj.weight, a.v_proj.weight,
                           a.o_proj.weight, layer.post_norm.weight,
                           f.gate_proj.weight, f.up_proj.weight,
                           f.down_proj.weight))
        head = None if self.lm_head is None else self.lm_head.weight
        return (m.embed.weight, m.norm.weight, head, layers)


def llama3_8b(device=None, dtype=None, seed=0, **overrides):
    """Llama-3-8B geometry: hidden 4096, 32 layers, 32/8 heads, head_dim
    128, SwiGLU 14336, vocab 128256."""
    return LlamaForCausalLM(LlamaConfig(**overrides), device=device,
                            dtype=dtype, seed=seed)


def llama_tiny(device=None, dtype=None, seed=0, **overrides):
    """Tiny config for tests."""
    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128)
    kw.update(overrides)
    return LlamaForCausalLM(LlamaConfig(**kw), device=device, dtype=dtype,
                            seed=seed)
