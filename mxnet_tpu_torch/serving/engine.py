"""Bucketed inference engine for Llama-family decoders, on one card.

Counterpart of ``mxnet_tpu/serving/engine.py``.  The reference compiles
two graph families ahead of time; here PyTorch runs eagerly and the same
two bodies are plain methods:

- ``_prefill_body``: a causal forward over a prompt padded to a
  power-of-two bucket through the flash kernel, writing the unrepeated
  GQA K/V into the sequence's pool blocks and sampling the first token
  from the last VALID position's logits.
- ``_decode_body``: ONE token for the whole fixed-size batch (padded to
  ``max_batch``) against the paged KV cache: the current K/V is written
  into the pool first, then attention runs through the paged-decode
  kernel (``ops.paged_attention``), whose plain version is the
  reference's inline gather + ``_cache_attention``.  It is the only
  decode path: no routing knob.

With ``kv_dtype="fp8"`` both bodies quantize each written K/V row to
e4m3 codes and one f32 amax scale (``ops.quant_kv.kv_quantize_fp8``),
and the decode attention dequantizes inside the kernel.  Prefill's own
attention reads the fresh K/V, so the first generated token never
drifts; decode reads the pool.

The KV pools are updated IN PLACE by index assignment; that replaces the
reference's donated-argument round trip (``pool_args``/``update_pools``).
Weights are the model's own parameters, never copied.  The big
projections stay ``torch.matmul`` (the reference leaves them to XLA);
RMSNorm, RoPE and SwiGLU are plain torch.  Sampling uses one
``torch.Generator`` on the engine's device: greedy streams match the
reference exactly, sampled streams draw other numbers than JAX's keys.

``stats`` keeps the reference's keys.  ``compiles`` counts the first run
of each (kind, bucket) shape and ``compiles_after_warmup`` those first
seen after :meth:`warmup` -- the shapes a later slice captures as CUDA
graphs.

Not in this slice (each raises ``NotSupportedError``): int8 weights
(``quantize``), tensor parallelism (``mesh``), chunked prefill
(``prefill_chunk``), the prefix cache, speculative decoding and sharing
one ``kv_cache`` between engines.
"""
from __future__ import annotations

import math

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError, NotSupportedError
from ..context import resolve_device
from ..gluon.model_zoo.nlp.llama import (_rms, _rope_cos_sin,
                                         _rot_interleaved)
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_decode_attention
from ..ops.quant_kv import (kv_cast, kv_has_scales, kv_quantize_fp8,
                            resolve_kv_dtype)
from .kv_cache import PagedKVCache

__all__ = ["InferenceEngine", "next_bucket"]


def next_bucket(n, buckets):
    """Smallest bucket >= n, or None when n exceeds every bucket."""
    for b in buckets:
        if n <= b:
            return b
    return None


def _refuse(name, value, later):
    if value:
        raise NotSupportedError(f"InferenceEngine({name}={value!r}) is not "
                                f"ported yet: it arrives with {later}")


class InferenceEngine:
    """Serving engine over one port ``LlamaForCausalLM``.

    Parameters
    ----------
    net : the model; its parameters must live on ``device``.
    max_batch : decode slots (>= 2; the decode batch is padded to it).
    block_size : KV-cache block size in tokens (power of two).
    num_blocks : pool size including the null block (default
        ``1 + max_batch * max_context / block_size``).
    max_context : longest sequence (rounded down to a multiple of
        ``block_size``); the buckets are the powers of two in
        ``[block_size, max_context]``.
    temperature / top_k / seed : sampling (greedy at temperature 0,
        else top-k categorical when ``top_k > 0``, full categorical when
        0), from a ``torch.Generator`` seeded with ``seed``.
    kv_dtype : pool storage: ``None`` (the model's dtype), ``"bf16"``,
        or ``"fp8"`` (e4m3 codes with per-row f32 scales).
    device : ``cuda`` by default; raises without a card unless
        ``device="cpu"`` (the kernels' plain versions then run).
    """

    def __init__(self, net, max_batch=4, block_size=16, num_blocks=None,
                 max_context=None, temperature=0.0, top_k=0, seed=0,
                 quantize=None, mesh=None, prefill_chunk=None,
                 prefix_cache=None, spec_decode=None, kv_cache=None,
                 kv_dtype=None, device=None):
        _refuse("quantize", quantize, "the int8 serving slice")
        _refuse("mesh", mesh, "the tensor-parallel serving slice")
        _refuse("prefill_chunk", prefill_chunk, "the chunked-prefill slice")
        _refuse("prefix_cache", prefix_cache, "the prefix-cache slice")
        _refuse("spec_decode", spec_decode,
                "the speculative-decoding slice")
        _refuse("kv_cache", kv_cache is not None,
                "the disaggregated-serving slice")
        self.device = resolve_device(device)
        cfg = net.cfg
        net_dev = net.model.embed.weight.device
        if net_dev != self.device:
            raise MXNetError(f"net lives on {net_dev} but the engine runs "
                             f"on {self.device}; build the net there")
        self.net = net
        self.cfg = cfg
        self.max_batch = max(2, int(max_batch))
        bs = int(block_size)
        mc = max_context if max_context is not None else \
            min(cfg.max_seq_len, 1024)
        mc = (mc // bs) * bs
        if mc < bs:
            raise MXNetError(f"max_context {mc} < block_size {bs}")
        self.block_size = bs
        self.max_context = mc
        self.buckets = []
        b = bs
        while b <= mc:
            self.buckets.append(b)
            b *= 2
        if num_blocks is None:
            num_blocks = 1 + self.max_batch * (mc // bs)
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        self._kv_fp8 = kv_has_scales(self.kv_dtype)
        self.params = self._extract_weights(net)
        self.cache = PagedKVCache(
            cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
            num_blocks=num_blocks, block_size=bs, max_batch=self.max_batch,
            dtype=self.params["embed"].dtype, kv_dtype=self.kv_dtype,
            device=self.device)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._seen = set()
        self._warmed = False
        self.stats = {"compiles": 0, "compiles_after_warmup": 0,
                      "prefill_calls": 0, "decode_calls": 0,
                      "chunk_prefill_calls": 0,
                      "prompt_tokens_computed": 0,
                      "verify_calls": 0, "draft_tokens_scored": 0}

    # -- weights ---------------------------------------------------------

    @staticmethod
    def _extract_weights(net):
        embed, norm, head, layers = net.decode_weights()
        names = ("in_norm", "q", "k", "v", "o", "post_norm", "gate", "up",
                 "down")
        params = {"embed": embed.detach(), "norm": norm.detach(),
                  "layers": [{n: w.detach() for n, w in zip(names, lw)}
                             for lw in layers]}
        if head is not None:
            params["head"] = head.detach()
        return params

    def _head_logits(self, x):
        w = self.params.get("head")
        return torch.matmul(x, (self.params["embed"] if w is None else w).T)

    # -- the two bodies --------------------------------------------------

    def _write_kv(self, li, idx, k, v):
        """Store K/V rows ``k``/``v`` (..., kvh, d) of layer ``li`` at the
        pool index ``idx`` (a tuple of index tensors): fp8 codes and
        their row scales, or a plain storage cast."""
        c = self.cache
        if not self._kv_fp8:
            c.k_pool[(li, *idx)] = kv_cast(k, c.k_pool.dtype)
            c.v_pool[(li, *idx)] = kv_cast(v, c.v_pool.dtype)
            return
        for pool, plane, x in ((c.k_pool, c.k_scale, k),
                               (c.v_pool, c.v_scale, v)):
            pool[(li, *idx)], plane[(li, *idx)] = kv_quantize_fp8(x)

    def _mlp(self, lp, x):
        y = _rms(x, lp["post_norm"], self.cfg.rms_eps)
        return x + torch.matmul(F.silu(torch.matmul(y, lp["gate"].T)) *
                                torch.matmul(y, lp["up"].T), lp["down"].T)

    def _prefill_body(self, toks, valid, bt):
        """Prefill for one prompt padded to ``L = toks.shape[1]`` tokens:
        causal forward through the flash kernel, unrepeated K/V written
        into the blocks ``bt`` (covering the whole bucket), the first
        token sampled from row ``valid - 1``.  Returns (logits (V,),
        token (1,))."""
        cfg = self.cfg
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        rep, eps = h // kvh, cfg.rms_eps
        bs = self.block_size
        L = toks.shape[1]
        nb = L // bs
        x = self.params["embed"][toks]                       # (1, L, hid)
        cos, sin = _rope_cos_sin(torch.arange(L, device=self.device), d,
                                 cfg.rope_theta)
        for li, lp in enumerate(self.params["layers"]):
            hh = _rms(x, lp["in_norm"], eps)
            q = torch.matmul(hh, lp["q"].T).reshape(1, L, h, d).transpose(1, 2)
            k = torch.matmul(hh, lp["k"].T).reshape(1, L, kvh, d) \
                .transpose(1, 2)
            v = torch.matmul(hh, lp["v"].T).reshape(1, L, kvh, d) \
                .transpose(1, 2)
            q = _rot_interleaved(q, cos, sin)
            k = _rot_interleaved(k, cos, sin)
            # unrepeated K/V rows into the pool blocks, then attention
            # over the fresh repeated heads
            self._write_kv(li, (bt,),
                           k[0].transpose(0, 1).reshape(nb, bs, kvh, d),
                           v[0].transpose(0, 1).reshape(nb, bs, kvh, d))
            o = flash_attention(q, k.repeat_interleave(rep, dim=1),
                                v.repeat_interleave(rep, dim=1), causal=True)
            o = o.transpose(1, 2).reshape(1, L, h * d)
            x = x + torch.matmul(o, lp["o"].T)
            x = self._mlp(lp, x)
        x = _rms(x, self.params["norm"], eps)
        last = self._head_logits(x[0, valid - 1])            # (V,)
        return last, self._sample(last[None, :])

    def _decode_body(self, toks, pos, bts, blk):
        """One decode step's layer stack for the padded batch: embed
        ``toks`` (B,), rotate at ``pos``, write K/V at (``blk``,
        ``pos % block_size``) BEFORE attending, attend through the
        paged kernel over the block tables ``bts``; returns the logits
        (B, V)."""
        cfg = self.cfg
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        eps = cfg.rms_eps
        B = self.max_batch
        scale = 1.0 / math.sqrt(d)
        c = self.cache
        x = self.params["embed"][toks.long()]                # (B, hid)
        cos, sin = _rope_cos_sin(pos, d, cfg.rope_theta)     # (B, d/2)
        cos, sin = cos[:, None, :], sin[:, None, :]
        off = (pos % self.block_size).long()
        blk = blk.long()
        for li, lp in enumerate(self.params["layers"]):
            hh = _rms(x, lp["in_norm"], eps)
            q = torch.matmul(hh, lp["q"].T).reshape(B, h, d)
            k = torch.matmul(hh, lp["k"].T).reshape(B, kvh, d)
            v = torch.matmul(hh, lp["v"].T).reshape(B, kvh, d)
            q = _rot_interleaved(q, cos, sin)
            k = _rot_interleaved(k, cos, sin)
            self._write_kv(li, (blk, off), k, v)
            ks, vs = (None, None) if c.k_scale is None else \
                (c.k_scale[li], c.v_scale[li])
            o = paged_decode_attention(q, c.k_pool[li], c.v_pool[li], bts,
                                       pos, scale, k_scale=ks, v_scale=vs)
            x = x + torch.matmul(o, lp["o"].T)
            x = self._mlp(lp, x)
        return self._head_logits(_rms(x, self.params["norm"], eps))

    def _sample(self, logits):
        """Next-token sampling on the device: greedy at temperature 0,
        else (top-k) categorical from the engine's generator."""
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        scaled = logits.float() / self.temperature
        if self.top_k > 0:
            vals, idx = torch.topk(scaled, self.top_k, dim=-1)
            pick = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                                     generator=self._gen)
            return torch.gather(idx, 1, pick)[:, 0].to(torch.int32)
        return torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                 generator=self._gen)[:, 0].to(torch.int32)

    def _note(self, kind, size):
        """Count the first run of each (kind, bucket) shape."""
        if (kind, size) in self._seen:
            return
        self._seen.add((kind, size))
        self.stats["compiles"] += 1
        if self._warmed:
            self.stats["compiles_after_warmup"] += 1

    def _tensor(self, arr):
        return torch.from_numpy(_np.ascontiguousarray(arr)).to(self.device)

    # -- warmup ----------------------------------------------------------

    @torch.no_grad()
    def warmup(self):
        """Run every bucket's prefill and decode once (the decode with
        every row inactive, writing the null block), so the kernels are
        built and loaded before traffic."""
        for bucket in self.buckets:
            nb = bucket // self.block_size
            if not self.cache.alloc("__warmup__", bucket):
                raise MXNetError("warmup: KV pool too small for bucket "
                                 f"{bucket}; raise num_blocks")
            bt = self._tensor(_np.asarray(self.cache.table("__warmup__"),
                                          _np.int64))
            self._note("prefill", bucket)
            self._prefill_body(
                torch.zeros(1, bucket, dtype=torch.long, device=self.device),
                1, bt)
            bts = self._tensor(self.cache.table_array(
                ["__warmup__"] + [None] * (self.max_batch - 1), nb))
            zeros = torch.zeros(self.max_batch, dtype=torch.int32,
                                device=self.device)
            self._note("decode", nb)
            self._decode_body(zeros, zeros, bts, zeros)
            self.cache.free("__warmup__")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warmed = True
        return self

    # -- serving calls ---------------------------------------------------

    @torch.no_grad()
    def prefill(self, slot, tokens):
        """Prefill ``tokens`` (1D int sequence) into ``slot``: allocates
        blocks, runs the bucketed prefill, samples the first generated
        token.  Returns ``(first_token, last_logits)`` or None when the
        prompt exceeds max_context or the pool is exhausted (the request
        stays queued)."""
        toks = _np.asarray(tokens, _np.int64).reshape(-1)
        t = toks.shape[0]
        if t == 0:
            raise MXNetError("prefill needs at least one token")
        bucket = next_bucket(t, self.buckets)
        if bucket is None:
            return None
        if not self.cache.alloc(slot, bucket):
            return None
        padded = _np.zeros((1, bucket), _np.int64)
        padded[0, :t] = toks
        bt = self._tensor(_np.asarray(self.cache.table(slot), _np.int64))
        self._note("prefill", bucket)
        last, tok = self._prefill_body(self._tensor(padded), t, bt)
        self.cache.trim(slot, t)
        self.cache.set_len(slot, t)
        self.stats["prefill_calls"] += 1
        self.stats["prompt_tokens_computed"] += t
        return int(tok[0]), last

    def reserve(self, slot, pos, n=1):
        """Grow ``slot``'s block table to cover positions
        ``[pos, pos + n)`` before a decode step, copy-on-write-forking
        any written block another holder still shares (with its fp8 scale
        rows, so the fork dequantizes as its source).  False when the
        pool is exhausted."""
        c = self.cache
        if not c.ensure(slot, pos + n - 1):
            return False
        copies = c.prepare_write(slot, pos, pos + n)
        if copies is None:
            return False
        planes = [c.k_pool, c.v_pool]
        if self._kv_fp8:
            planes += [c.k_scale, c.v_scale]
        for src, dst in copies:
            for plane in planes:
                plane[:, dst] = plane[:, src]
        return True

    @torch.no_grad()
    def decode(self, entries):
        """One decode step for the joined batch.

        entries: list of (slot, token, position) for the ACTIVE rows
        (position = where this token goes, i.e. the current sequence
        length).  Pads to ``max_batch``, picks the context bucket from
        the largest position, builds the block tables and runs the step.
        Returns (next_tokens (n,) np.int32, logits (n, V) tensor).
        """
        if not entries:
            raise MXNetError("decode: empty batch")
        n = len(entries)
        if n > self.max_batch:
            raise MXNetError(f"decode batch {n} > max_batch")
        max_pos = max(p for _, _, p in entries)
        bucket = next_bucket(max_pos + 1, self.buckets)
        if bucket is None:
            raise MXNetError(f"position {max_pos} exceeds max_context "
                             f"{self.max_context}")
        nbl = bucket // self.block_size
        slots = [s for s, _, _ in entries] + [None] * (self.max_batch - n)
        # rows: token, position, block written (inactive rows: the
        # null block at position 0)
        host = _np.zeros((3, self.max_batch), _np.int32)
        for i, (slot, tok, p) in enumerate(entries):
            host[:2, i] = tok, p
            self.cache.set_len(slot, p + 1)
        table = self.cache.table_array(slots, nbl)
        host[2, :n] = table[_np.arange(n), host[1, :n] // self.block_size]
        dev = self._tensor(host)
        bts = self._tensor(table)
        self._note("decode", nbl)
        logits = self._decode_body(dev[0], dev[1], bts, dev[2])
        nxt = self._sample(logits)
        self.stats["decode_calls"] += 1
        return nxt[:n].cpu().numpy(), logits[:n]

    def release(self, slot):
        """Finished sequence: drop its hold on its blocks."""
        self.cache.free(slot)
