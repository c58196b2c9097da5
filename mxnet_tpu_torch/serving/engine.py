"""Bucketed inference engine for Llama-family decoders, on one card.

Counterpart of ``mxnet_tpu/serving/engine.py``, with its serving
contract: nothing compiles under traffic.  The reference AOT-compiles
one executable per (kind, bucket) in :meth:`warmup` and only looks them
up afterwards; here each (kind, bucket) is one step object
(:class:`_Step`) over static input and output buffers, and on the card
:meth:`warmup` captures each step's body as a CUDA graph.  ``prefill``
and ``decode`` then copy their inputs in, replay, and read the outputs
out.  The two bodies:

- ``_prefill_body``: a causal forward over a prompt padded to a
  power-of-two bucket through the flash kernel, writing the unrepeated
  GQA K/V into the sequence's pool blocks and sampling the first token
  from the last VALID position's logits (the valid length is a device
  tensor, so one graph serves every prompt length of its bucket).
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
Weights are the model's own parameters, never copied, so in-place
updates (an optimizer step) are served; an engine refuses to serve (at
``warmup`` and ``prefill``) once a weight has been moved to new storage,
as a ``gluon.Trainer`` built on the net after the engine moves it into
its flat buffer.  (The reference's engine keeps the arrays it was built
with, whatever the net does afterwards.)  The big
projections stay ``torch.matmul`` (the reference leaves them to XLA);
RMSNorm, RoPE and SwiGLU are plain torch.

The graph cache (the reference's ``_sig``/``_get``): steps are keyed by
``(kind, size)`` (``size`` is the prefill bucket or the decode's table
width in blocks).  A miss builds one step and counts in
``stats["compiles"]``, and after :meth:`warmup` also in
``compiles_after_warmup``; a second :meth:`warmup` finds every step and
builds nothing.  On CUDA a step's first run runs its body once on the
engine's capture stream (kernels built and loaded, cuBLAS set up), then
captures it into a ``torch.cuda.CUDAGraph``; every graph of an engine
allocates from one memory pool, so they share their intermediates.  A
failed capture or replay raises; there is no eager path on the card.
With ``device="cpu"`` the same step objects run their bodies directly on
the static buffers.  The reference's ``compile_cache=`` (one cache
shared by Router replicas) has no counterpart: a graph bakes in this
engine's pool, weight and buffer addresses, so it serves no other
engine.

Inputs reach a step through one staging buffer (pinned on the card) and
one non-blocking copy a call; a call waits on an event for the last
copy out of the buffer before refilling it (every serving call already
ends in a host read of the sampled token, so the wait is free).  A
replay overwrites the static outputs (and the shared pool may reuse an
output of one graph as scratch in another), so ``prefill`` and
``decode`` return clones.  Kernel launch counters (``ops.launch_counts``)
count what ran: a capture's wrapper calls are taken back out, and each
replay adds them again.

Sampling runs inside the graph from one ``torch.Generator`` on the
engine's device, registered with every graph: greedy at temperature 0,
else (top-k) categorical.  The categorical draw is ``torch.multinomial``'s
own one-sample algorithm written out (``argmax(p / q)``, ``q`` drawn
from ``Exp(1)``): it draws the same numbers from the generator and picks
the same token, without the host-side validity check that makes
``multinomial`` itself uncapturable.  Greedy streams match the reference
exactly; sampled streams draw other numbers than JAX's keys.

Not in this slice (each raises ``NotSupportedError``): int8 weights
(``quantize``), tensor parallelism (``mesh``), chunked prefill
(``prefill_chunk``), the prefix cache, speculative decoding and sharing
one ``kv_cache`` between engines.
"""
from __future__ import annotations

import math
import time

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError, NotSupportedError
from ..context import resolve_device
from ..gluon.model_zoo.nlp.llama import (_rms, _rope_cos_sin,
                                         _rot_interleaved)
from ..ops import add_launches, launch_counts
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


class _Step:
    """One (kind, bucket) step over static buffers: the port's
    counterpart of one executable in the reference's compile cache.

    The inputs are int32 views of one flat buffer on the engine's
    device: for ``"prefill"`` the padded tokens ``(1, L)``, the valid
    length ``(1,)`` and the block table ``(L / block_size,)``; for
    ``"decode"`` the tokens, positions and written block ids
    ``(max_batch,)`` and the block tables ``(max_batch, size)``.  The
    caller fills :meth:`stage`'s host views, then :meth:`run` copies
    them in and, on CUDA, replays the step's graph (capturing it at the
    first run) and returns the static outputs; on the CPU it runs the
    body on the static inputs."""

    def __init__(self, eng, kind, size):
        self.eng = eng
        B = eng.max_batch
        if kind == "prefill":
            parts = [size, 1, size // eng.block_size]
            self.body = eng._prefill_body
        else:
            parts = [B, B, B, B * size]
            self.body = eng._decode_and_sample
        self._splits = _np.cumsum(parts)[:-1]
        self.flat = torch.zeros(sum(parts), dtype=torch.int32,
                                device=eng.device)
        views = self.flat.split(parts)
        if kind == "prefill":
            toks, valid, table = views
            self.args = (toks.view(1, size), valid, table)
        else:
            toks, pos, blk, tables = views
            # the paged kernel takes contiguous (B, nbl) tables: a view
            # of a contiguous piece, never a column slice
            self.args = (toks, pos, tables.view(B, size), blk)
        self.graph = None
        self.outputs = None
        self.launches = {}      # kernel -> launches a replay makes

    def stage(self):
        """Zeroed host views of the inputs, flat, in the order above (the
        engine's staging buffer, pinned on CUDA; the last call's copy
        out of it has finished)."""
        eng = self.eng
        if eng._staged is not None:
            eng._staged.synchronize()
        host = eng._stage_np[:self.flat.numel()]
        host[:] = 0
        return _np.split(host, self._splits)

    def run(self):
        """Copy the staged inputs in and run the step: ``(logits,
        tokens)``, static tensors on CUDA."""
        eng = self.eng
        self.flat.copy_(eng._stage[:self.flat.numel()], non_blocking=True)
        if eng.device.type == "cpu":
            return self.body(*self.args)
        eng._staged.record()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        add_launches(self.launches)
        return self.outputs

    def _capture(self):
        """Run the body once on the engine's capture stream (as
        ``torch.cuda.graph`` asks: kernels loaded, cuBLAS workspaces set
        up), then capture it into the engine's graph pool.  The capture's
        wrapper calls launched nothing: their counts are taken back out
        and kept as what each replay launches."""
        eng = self.eng
        t0 = time.perf_counter()
        stream = eng._capture_stream
        stream.wait_stream(torch.cuda.current_stream(eng.device))
        with torch.cuda.stream(stream):
            self.body(*self.args)
        graph = torch.cuda.CUDAGraph()
        if eng.temperature != 0.0:
            graph.register_generator_state(eng._gen)
        before = launch_counts()
        with torch.cuda.graph(graph, pool=eng._graph_pool, stream=stream):
            outputs = self.body(*self.args)
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        add_launches({k: -v for k, v in self.launches.items()})
        self.graph, self.outputs = graph, outputs
        eng.capture_seconds += time.perf_counter() - t0


_ITEM5 = "the serving features' slice (ROADMAP §1 item 5)"


def _weight_leaves(tree):
    """The tensors of a ``decode_weights()`` tree."""
    embed, norm, head, layers = tree
    return [embed, norm] + ([] if head is None else [head]) + \
        [w for layer in layers for w in layer]


def _refuse(name, value, later):
    if value:
        raise NotSupportedError(f"InferenceEngine({name}={value!r}) is not "
                                f"ported yet: it arrives with {later}")


class InferenceEngine:
    """Serving engine over one port ``LlamaForCausalLM``.

    Parameters
    ----------
    net : the model; its parameters must live on ``device``.
    max_batch : decode slots (>= 2; the decode batch is padded to it);
        None means 4, the reference's default without its environment.
    block_size : KV-cache block size in tokens (power of two); None
        means 16.
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
    quantize, calib_data, num_calib_batches, mesh, prefill_chunk,
    prefix_cache, compile_cache, spec_decode, spec_k, paged_attn,
    kv_cache : the reference's arguments, in its order; each is taken at
        a value that changes nothing (``None``, ``False``;
        ``paged_attn=True``, the port's only decode path) and refused
        with ``NotSupportedError`` otherwise.
    device : ``cuda`` by default; raises without a card unless
        ``device="cpu"`` (the kernels' plain versions then run).
    """

    def __init__(self, net, max_batch=None, block_size=None, num_blocks=None,
                 max_context=None, temperature=0.0, top_k=0, seed=0,
                 quantize=None, calib_data=None, num_calib_batches=10,
                 mesh=None, prefill_chunk=None, prefix_cache=None,
                 compile_cache=None, spec_decode=None, spec_k=None,
                 paged_attn=None, kv_cache=None, kv_dtype=None, device=None):
        # the reference's arguments in its order; what is not ported is
        # taken only at a value that changes nothing
        # (``num_calib_batches`` is read only with ``quantize``)
        _refuse("quantize", quantize, _ITEM5)
        _refuse("calib_data", calib_data is not None, _ITEM5)
        _refuse("mesh", mesh, "the tensor-parallel serving slice "
                "(ROADMAP §1 item 10)")
        _refuse("prefill_chunk", prefill_chunk, _ITEM5)
        _refuse("prefix_cache", prefix_cache, _ITEM5)
        if compile_cache is not None:
            raise NotSupportedError(
                "InferenceEngine(compile_cache=...) has no counterpart in "
                "the port: a CUDA graph bakes in its own engine's pool, "
                "weight and buffer addresses, so no cache is shared "
                "between engines (ROADMAP §3, standing differences)")
        _refuse("spec_decode", spec_decode, _ITEM5)
        _refuse("spec_k", spec_k is not None, _ITEM5)
        if paged_attn not in (None, True):
            raise NotSupportedError(
                f"InferenceEngine(paged_attn={paged_attn!r}): the port has "
                "one decode path, the paged-decode kernel (ROADMAP §3, "
                "standing differences)")
        _refuse("kv_cache", kv_cache is not None, _ITEM5)
        self.device = resolve_device(device)
        cfg = net.cfg
        net_dev = net.model.embed.weight.device
        if net_dev != self.device:
            raise MXNetError(f"net lives on {net_dev} but the engine runs "
                             f"on {self.device}; build the net there")
        self.net = net
        self.cfg = cfg
        self.max_batch = max(2, 4 if max_batch is None else int(max_batch))
        bs = 16 if block_size is None else int(block_size)
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
        # where each of the net's weights lay when the engine took it
        self._weight_ptrs = [(w, w.data_ptr())
                             for w in _weight_leaves(net.decode_weights())]
        self.cache = PagedKVCache(
            cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
            num_blocks=num_blocks, block_size=bs, max_batch=self.max_batch,
            dtype=self.params["embed"].dtype, kv_dtype=self.kv_dtype,
            device=self.device)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._steps = {}             # (kind, size) -> _Step
        self._warmed = False
        top = self.buckets[-1]
        cuda = self.device.type == "cuda"
        self._stage = torch.empty(
            max(top + 1 + top // bs, self.max_batch * (3 + top // bs)),
            dtype=torch.int32, pin_memory=cuda)
        self._stage_np = self._stage.numpy()
        self._staged = torch.cuda.Event() if cuda else None
        self._graph_pool = torch.cuda.graph_pool_handle() if cuda else None
        self._capture_stream = torch.cuda.Stream(self.device) if cuda \
            else None
        #: seconds spent capturing graphs (each with its warm-up run)
        self.capture_seconds = 0.0
        self.stats = {"compiles": 0, "compiles_after_warmup": 0,
                      "prefill_calls": 0, "decode_calls": 0,
                      "chunk_prefill_calls": 0,
                      "prompt_tokens_computed": 0,
                      "verify_calls": 0, "draft_tokens_scored": 0}

    # -- weights ---------------------------------------------------------

    def _check_weights(self):
        """Raise if one of the net's weights no longer lies where the
        engine took it: its steps (and their graphs) read the old storage
        and would serve stale weights.  A ``gluon.Trainer`` built on the
        net after the engine moves every f32 parameter into its flat
        buffer; ``p.data = ...`` and ``net.to()`` move one too.  In-place
        writes (``load_state_dict``, an optimizer step) keep it."""
        for w, ptr in self._weight_ptrs:
            if w.data_ptr() != ptr:
                raise MXNetError(
                    "the net's weights were moved since this "
                    "InferenceEngine was built (a gluon.Trainer built on "
                    "the net afterwards, p.data = ..., net.to()): build "
                    "the engine after the Trainer, or a new one")

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
        token sampled from row ``valid - 1`` (``valid`` a (1,) int
        tensor on the engine's device).  Returns (logits (V,), token
        (1,))."""
        cfg = self.cfg
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        rep, eps = h // kvh, cfg.rms_eps
        bs = self.block_size
        L = toks.shape[1]
        nb = L // bs
        bt = bt.long()
        x = self.params["embed"][toks.long()]                # (1, L, hid)
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
        # the last valid row, picked on the device (a graph serves every
        # prompt length of its bucket)
        row = x[0].index_select(0, valid.long() - 1)[0]
        last = self._head_logits(row)                        # (V,)
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

    def _decode_and_sample(self, toks, pos, bts, blk):
        """The decode step's graph body: ``(logits (B, V), next tokens
        (B,))``."""
        logits = self._decode_body(toks, pos, bts, blk)
        return logits, self._sample(logits)

    def _sample(self, logits):
        """Next-token sampling on the device: greedy at temperature 0,
        else (top-k) categorical from the engine's generator, drawn as
        ``torch.multinomial(p, 1)`` draws it (see the module doc)."""
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        scaled = logits.float() / self.temperature
        idx = None
        if self.top_k > 0:
            scaled, idx = torch.topk(scaled, self.top_k, dim=-1)
        p = torch.softmax(scaled, dim=-1)
        q = torch.empty_like(p).exponential_(1, generator=self._gen)
        pick = torch.argmax(p / q, dim=-1, keepdim=True)
        if idx is not None:
            pick = torch.gather(idx, 1, pick)
        return pick[:, 0].to(torch.int32)

    def _get(self, kind, size):
        """The step for ``(kind, size)``; a miss builds one (captured at
        its first run on CUDA) and is counted, after :meth:`warmup` also
        in ``compiles_after_warmup``: traffic must never miss."""
        step = self._steps.get((kind, size))
        if step is None:
            step = self._steps[kind, size] = _Step(self, kind, size)
            self.stats["compiles"] += 1
            if self._warmed:
                self.stats["compiles_after_warmup"] += 1
        return step

    def graphs_captured(self):
        """How many CUDA graphs this engine holds (0 on the CPU)."""
        return sum(s.graph is not None for s in self._steps.values())

    def graph_pool_bytes(self):
        """Bytes the caching allocator reserves in this engine's graph
        pool (0 on the CPU)."""
        if self._graph_pool is None:
            return 0
        pool = tuple(self._graph_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

    # -- warmup ----------------------------------------------------------

    @torch.no_grad()
    def warmup(self):
        """Build every bucket's prefill and decode step and run each once
        (the decode with every row inactive, writing the null block): on
        CUDA each is captured as a graph here, before traffic.  Buckets
        whose steps exist already are skipped, as the reference skips
        signatures its cache holds.  Raises if the net's weights were
        moved since the engine was built (:meth:`_check_weights`)."""
        self._check_weights()
        B = self.max_batch
        for bucket in self.buckets:
            nb = bucket // self.block_size
            if ("prefill", bucket) in self._steps and \
                    ("decode", nb) in self._steps:
                continue
            if not self.cache.alloc("__warmup__", bucket):
                raise MXNetError("warmup: KV pool too small for bucket "
                                 f"{bucket}; raise num_blocks")
            step = self._get("prefill", bucket)
            _, valid, table = step.stage()
            valid[0] = 1
            table[:] = self.cache.table("__warmup__")
            step.run()
            step = self._get("decode", nb)
            tables = step.stage()[3]
            tables[:] = self.cache.table_array(
                ["__warmup__"] + [None] * (B - 1), nb).ravel()
            step.run()
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
        stays queued).  Raises if the net's weights were moved since the
        engine was built (:meth:`_check_weights`; ``decode`` does not
        check, to keep its step short)."""
        self._check_weights()
        toks = _np.asarray(tokens, _np.int64).reshape(-1)
        t = toks.shape[0]
        if t == 0:
            raise MXNetError("prefill needs at least one token")
        bucket = next_bucket(t, self.buckets)
        if bucket is None:
            return None
        if not self.cache.alloc(slot, bucket):
            return None
        step = self._get("prefill", bucket)
        padded, valid, table = step.stage()
        padded[:t], valid[0] = toks, t
        table[:] = self.cache.table(slot)
        last, tok = step.run()
        first, last = int(tok[0]), last.clone()
        self.cache.trim(slot, t)
        self.cache.set_len(slot, t)
        self.stats["prefill_calls"] += 1
        self.stats["prompt_tokens_computed"] += t
        return first, last

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
        Returns (next_tokens (n,) np.int32, logits (n, V) tensor on the
        engine's device).  The reference returns numpy logits; the port
        keeps them on the card, since a host copy would move n x vocab
        floats every step for callers (the batchers) that read only the
        tokens.
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
        step = self._get("decode", nbl)
        # inactive rows: token 0 at position 0 of the null block
        toks, pos, blk, tables = step.stage()
        for i, (slot, tok, p) in enumerate(entries):
            toks[i], pos[i] = tok, p
            self.cache.set_len(slot, p + 1)
        table = self.cache.table_array(slots, nbl)
        blk[:n] = table[_np.arange(n), pos[:n] // self.block_size]
        tables[:] = table.ravel()
        logits, nxt = step.run()
        logits = logits[:n].clone()
        self.stats["decode_calls"] += 1
        return nxt[:n].cpu().numpy(), logits

    def release(self, slot):
        """Finished sequence: drop its hold on its blocks."""
        self.cache.free(slot)
