"""Bucketed inference engine for Llama-family decoders, on one card.

Counterpart of ``mxnet_tpu/serving/engine.py``, with its serving
contract: nothing compiles under traffic.  The reference AOT-compiles
one executable per (kind, bucket) in :meth:`warmup` and only looks them
up afterwards; here each (kind, bucket) is one step object
(:class:`_Step`) over static input and output buffers, and on the card
:meth:`warmup` captures each step's body as a CUDA graph.  The serving
calls then copy their inputs in, replay, and read the outputs out.  The
step families:

- ``prefill`` (one per bucket), ``_prefill_body``: a causal forward over
  a prompt padded to a power-of-two bucket through the flash kernel,
  writing the unrepeated GQA K/V into the sequence's pool blocks and
  sampling the first token from the last VALID position's logits (the
  valid length is a device tensor, so one graph serves every prompt
  length of its bucket).
- ``decode`` (one per table width), ``_decode_body``: ONE token for the
  whole fixed-size batch (padded to ``max_batch``) against the paged KV
  cache: the current K/V is written into the pool first, then attention
  runs through the paged-decode kernel (``ops.paged_attention``), whose
  plain version is the reference's inline gather + ``_cache_attention``.
  It is the only decode path: no routing knob.
- ``chunk`` (one per table width, with ``prefill_chunk``),
  ``_chunk_body``: a packed continuation prefill.  Up to ``max_batch``
  rows, each a chunk of up to ``prefill_chunk`` prompt tokens starting
  at any position, write their K/V rows first, then attend to that
  row's whole cached context through its block table: the flash
  kernel's offset form (``q_start``, each row's start), which computes
  the reference's chunk attention.  One replay admits several prompts
  of a boundary, or only the uncached suffix of a prompt whose prefix
  the :class:`~.frontend.PrefixCache` holds.
- ``verify`` (one per (width, table width), with ``spec_decode``),
  ``_verify_body``: ``W`` decode bodies unrolled in one replay, each
  followed by an argmax.  Step ``w`` feeds row i's ``w``-th token
  (the last committed one, then the drafts) at ``pos + w``; its K/V
  write is visible to step ``w + 1``.  Steps past a row's count write
  the null block, so a row of count 1 runs the plain decode body op for
  op: speculative streams are the greedy stream, in fewer replays.

With ``kv_dtype="fp8"`` every body quantizes each written K/V row to
e4m3 codes and one f32 amax scale (``ops.quant_kv.kv_quantize_fp8``),
and the decode attention dequantizes inside the kernel.  Prefill's own
attention reads the fresh K/V, so the first generated token never
drifts; decode, verify and chunk read the pool (the chunk family
dequantizes its gathered rows before the flash kernel, as the
reference does).

The KV pools are updated IN PLACE by index assignment; that replaces the
reference's donated-argument round trip (``pool_args``/``update_pools``)
and its ``cow`` graph: a copy-on-write fork (:meth:`reserve`,
:meth:`chunk_prefill`) is an index copy on the stream the next replay
runs on, so it lands before the replay writes into the fork.
Weights are the model's own parameters, never copied, so in-place
updates (an optimizer step) are served; an engine refuses to serve (at
``warmup``, ``prefill`` and ``chunk_prefill``) once a weight has been
moved to new storage, as a ``gluon.Trainer`` built on the net after the
engine moves it into its flat buffer, or once ``quantize_net`` has
swapped the projections it read.  (The reference's engine keeps the
arrays it was built with, whatever the net does afterwards.)  The big
projections stay ``torch.matmul`` (the reference leaves them to XLA);
RMSNorm, RoPE and SwiGLU are plain torch.

int8 weights (``quantize="int8"``, the reference's): the net's ``Dense``
projections become ``contrib.quantization.QuantizedDense`` twins
(calibrated on ``calib_data`` by ``quantize_net``, or taken as they are
when the net is quantized already), and every projection of every step
family runs :meth:`_proj`'s int8 branch, op for op the twin's forward:
the input quantized at the activation scale, ``ops.quant_matmul.
int8_matmul`` (cuBLASLt's int8 GEMM on the card, an exact int32 product
on the CPU), then the f32 rescale.  As in the reference, that product
leaves f32 whatever the net's dtype, so in a bf16 net the residual
stream, q, k and v are f32 after the first projection: the prefill's
and the chunk's attention run in f32, the decode queries are f32
against the pool's own dtype, and K/V rows are cast to the pool's
dtype when written.

The graph cache (the reference's ``_sig``/``_get``): steps are keyed by
``(kind, size)`` (``size`` is the prefill bucket, the table width in
blocks, or ``(W, width)`` for ``verify``).  A miss builds one step and
counts in ``stats["compiles"]``, and after :meth:`warmup` also in
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
ends in a host read of the sampled tokens, so the wait is free).  A
replay overwrites the static outputs (and the shared pool may reuse an
output of one graph as scratch in another), so the serving calls return
clones.  Kernel launch counters (``ops.launch_counts``) count what ran:
a capture's wrapper calls are taken back out, and each replay adds them
again.

Sampling runs inside the graph from one ``torch.Generator`` on the
engine's device, registered with every graph: greedy at temperature 0,
else (top-k) categorical.  The categorical draw is ``torch.multinomial``'s
own one-sample algorithm written out (``argmax(p / q)``, ``q`` drawn
from ``Exp(1)``): it draws the same numbers from the generator and picks
the same token, without the host-side validity check that makes
``multinomial`` itself uncapturable.  Greedy streams match the reference
exactly; sampled streams draw other numbers than JAX's keys (the chunk
family draws from the same generator, where the reference folds the
chunk call count into its key).

``kv_cache=`` adopts another engine's :class:`~.kv_cache.PagedKVCache`
(the disaggregated fleet's one pool behind its prefill and decode
replicas, ``frontend.Router``): the geometry must match, and
``cache_shared`` is then True.  The pool is updated in place and never
reallocated, so every engine over it bakes the same addresses into its
graphs.  A replay runs on the caller's current stream, so an engine's
replay reads what another engine's earlier replay on that stream wrote
into a shared block.

Not in this slice (raises ``NotSupportedError``): tensor parallelism
(``mesh``).
"""
from __future__ import annotations

import math
import time

import numpy as _np
import torch
import torch.nn.functional as F

from .._graphs import capture
from ..base import MXNetError, NotSupportedError
from ..context import resolve_device
from ..gluon.model_zoo.nlp.llama import (_categorical, _rms,
                                         _rope_cos_sin, _rot_interleaved)
from ..ops import add_launches, launch_counts
from ..ops.flash_attention import flash_attention, flash_attention_fwd
from ..ops.paged_attention import paged_decode_attention
from ..ops.quant_matmul import int8_matmul, quantize_rtn_int8
from ..ops.quant_kv import (kv_cast, kv_dequantize, kv_has_scales,
                            kv_quantize_fp8, resolve_kv_dtype)
from ..parallel.mesh import MeshConfig
from .frontend.prefix_cache import PrefixCache
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
    device (``B`` is ``max_batch``): for ``"prefill"`` the padded tokens
    ``(1, L)``, the valid length ``(1,)`` and the block table
    ``(L / block_size,)``; for ``"decode"`` the tokens and positions
    ``(B,)``, the block tables ``(B, size)`` and the written block ids
    ``(B,)``; for
    ``"chunk"`` the tokens ``(B, prefill_chunk)``, the starts and valid
    lengths ``(B,)``, the block tables ``(B, size)`` and the active mask
    ``(B,)``; for ``"verify"`` (``size`` is ``(W, nbl)``) the tokens
    ``(B, W)``, the positions ``(B,)``, the block tables ``(B, nbl)``,
    the counts and the active mask ``(B,)``.  The caller fills
    :meth:`stage`'s host views, then :meth:`run` copies them in and, on
    CUDA, replays the step's graph (capturing it at the first run) and
    returns the static outputs; on the CPU it runs the body on the
    static inputs."""

    def __init__(self, eng, kind, size):
        self.eng = eng
        self.shapes = eng._input_shapes(kind, size)
        parts = [int(_np.prod(shape)) for shape in self.shapes]
        self.body = {"prefill": eng._prefill_body,
                     "decode": eng._decode_and_sample,
                     "chunk": eng._chunk_body,
                     "verify": eng._verify_body}[kind]
        self._splits = _np.cumsum(parts)[:-1]
        self.flat = torch.zeros(sum(parts), dtype=torch.int32,
                                device=eng.device)
        # the kernels take contiguous tables: each a view of a contiguous
        # piece, never a column slice
        self.args = tuple(v.view(shape) for v, shape in
                          zip(self.flat.split(parts), self.shapes))
        self.graph = None
        self.outputs = None
        self.launches = {}      # kernel -> launches a replay makes

    def stage(self):
        """Zeroed host views of the inputs, in the order and shapes above
        (the engine's staging buffer, pinned on CUDA; the last call's
        copy out of it has finished)."""
        eng = self.eng
        if eng._staged is not None:
            eng._staged.synchronize()
        host = eng._stage_np[:self.flat.numel()]
        host[:] = 0
        return [h.reshape(shape) for h, shape in
                zip(_np.split(host, self._splits), self.shapes)]

    def run(self):
        """Copy the staged inputs in and run the step: its body's outputs
        (``(logits, tokens)``; ``verify``: the tokens), static tensors on
        CUDA."""
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
        up), then capture it into the engine's graph pool, with the
        cyclic garbage collector off (``_graphs.capture``).  The capture's
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
        with capture(graph, eng._graph_pool, stream):
            outputs = self.body(*self.args)
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        add_launches({k: -v for k, v in self.launches.items()})
        self.graph, self.outputs = graph, outputs
        eng.capture_seconds += time.perf_counter() - t0


_LAYER_PROJ = (("q", "attention", "q_proj"), ("k", "attention", "k_proj"),
               ("v", "attention", "v_proj"), ("o", "attention", "o_proj"),
               ("gate", "mlp", "gate_proj"), ("up", "mlp", "up_proj"),
               ("down", "mlp", "down_proj"))


def _net_leaves(net):
    """The tensors whose storage the steps read, as the net holds them
    now, in a fixed order: each Parameter's own tensor, a twin's codes
    and scales."""
    m = net.model
    out = [m.embed.weight._var, m.norm.weight._var]
    projs = [] if net.lm_head is None else [net.lm_head]
    for layer in m.layers._children.values():
        out += [layer.input_norm.weight._var, layer.post_norm.weight._var]
        projs += [getattr(getattr(layer, part), proj)
                  for _, part, proj in _LAYER_PROJ]
    for b in projs:
        out += [b._qw, b._w_scale] if hasattr(b, "_qw") else [b.weight._var]
    return out


def _mm(x, w):
    """``x @ w.T`` in the wider of the two dtypes (an int8 projection
    hands a bf16 net's float weights f32 activations)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.T.to(dt))


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
    prefill_chunk : chunk bucket in tokens (a multiple of
        ``block_size``) for the packed ``chunk`` family; 0 or None is
        off (no chunk steps).
    prefix_cache : True builds a :class:`~.frontend.PrefixCache` over
        this engine's pool; an object is used as given; None or False is
        off.
    spec_decode : True builds the speculative ``verify`` family at
        warmup (greedy only: temperature 0); None or False is off.
    spec_k : most draft tokens a ``verify`` replay scores (>= 1; None
        means 4); the widths are the powers of two from 2 covering
        ``spec_k + 1`` fed tokens.
    quantize : ``"int8"`` serves int8 projection weights (the net's
        ``Dense`` children become ``QuantizedDense`` twins, in place);
        None serves the net's own weights.  Anything else raises.
    calib_data : calibration token batches (NDArrays, or arrays the
        engine puts on its device) for ``quantize="int8"`` on a net not
        yet quantized; ``num_calib_batches`` of them are run.
    kv_cache : an existing ``PagedKVCache`` to adopt instead of
        building one (engines over one pool: the disaggregated fleet);
        its layers, KV heads, head size, block size and storage dtype
        must be this engine's, and it must live on ``device``.
        ``num_blocks`` is then ignored.
    mesh, compile_cache, paged_attn : the reference's other arguments,
        in its order; each is taken at a value that changes nothing
        (``None``; ``paged_attn=True``, the port's only decode path) and
        refused with ``NotSupportedError`` otherwise.
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
        # (``calib_data``/``num_calib_batches`` are read only with
        # ``quantize``)
        if quantize not in (None, "int8"):
            raise MXNetError(f"quantize={quantize!r}: only int8 weight "
                             "quantization is supported")
        _refuse("mesh", mesh, "the tensor-parallel serving slice "
                "(ROADMAP §1 item 10b)")
        if compile_cache is not None:
            raise NotSupportedError(
                "InferenceEngine(compile_cache=...) has no counterpart in "
                "the port: a CUDA graph bakes in its own engine's pool, "
                "weight and buffer addresses, so no cache is shared "
                "between engines (ROADMAP §3, standing differences)")
        if paged_attn not in (None, True):
            raise NotSupportedError(
                f"InferenceEngine(paged_attn={paged_attn!r}): the port has "
                "one decode path, the paged-decode kernel (ROADMAP §3, "
                "standing differences)")
        self.device = resolve_device(device)
        # the reference records its MeshConfig; the port serves on one
        # device, so it is always the one-device config ("dp1")
        self.mesh_config = MeshConfig()
        cfg = net.cfg
        net_dev = net.model.embed.weight.data().data.device
        if net_dev != self.device:
            raise MXNetError(f"net lives on {net_dev} but the engine runs "
                             f"on {self.device}; build the net there")
        self.net = net
        self.cfg = cfg
        self.quantized = False
        if quantize == "int8":
            self._quantize_in_place(net, calib_data, num_calib_batches)
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
        # where each weight the steps read lay when the engine took it
        self._weight_ptrs = [w.data_ptr() for w in _net_leaves(net)]
        if kv_cache is not None:
            # disaggregated serving: prefill and decode replicas adopt one
            # pool, and a handoff moves block ownership through its
            # refcounts, never the data; a graph over another geometry
            # would gather garbage
            if (kv_cache.num_layers != cfg.num_layers
                    or kv_cache.num_kv_heads != cfg.num_kv_heads
                    or kv_cache.head_dim != cfg.head_dim
                    or kv_cache.block_size != bs
                    or kv_cache.kv_dtype != self.kv_dtype
                    or (self.kv_dtype is None and
                        kv_cache.dtype != self.params["embed"].dtype)):
                raise MXNetError(
                    "kv_cache geometry mismatch: shared pool is "
                    f"(layers={kv_cache.num_layers}, "
                    f"kvh={kv_cache.num_kv_heads}, "
                    f"hd={kv_cache.head_dim}, "
                    f"bs={kv_cache.block_size}, "
                    f"kv_dtype={kv_cache.kv_dtype or 'fp32'}) vs this "
                    f"engine's (layers={cfg.num_layers}, "
                    f"kvh={cfg.num_kv_heads}, hd={cfg.head_dim}, "
                    f"bs={bs}, kv_dtype={self.kv_dtype or 'fp32'})")
            if kv_cache.device != self.device:
                raise MXNetError(f"kv_cache lives on {kv_cache.device} but "
                                 f"the engine runs on {self.device}")
            self.cache = kv_cache
            self.cache_shared = True
        else:
            self.cache = PagedKVCache(
                cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                num_blocks=num_blocks, block_size=bs,
                max_batch=self.max_batch, dtype=self.params["embed"].dtype,
                kv_dtype=self.kv_dtype, device=self.device)
            self.cache_shared = False
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        # chunked prefill: the chunk bucket in tokens; 0 builds no chunk
        # steps
        pc = 0 if prefill_chunk is None else int(prefill_chunk)
        if pc < 0 or (pc and pc % bs):
            raise MXNetError(f"prefill_chunk {pc} must be a positive "
                             f"multiple of block_size {bs} (or 0=off)")
        self.prefill_chunk = min(pc, mc)
        # copy-on-write prefix cache: True builds one, an object is used
        # as given
        if prefix_cache is True:
            self.prefix_cache = PrefixCache(self.cache)
        else:
            self.prefix_cache = prefix_cache or None
        # speculative decoding: off by default (no verify steps)
        self.spec_decode = bool(spec_decode)
        self.spec_k = 4 if spec_k is None else int(spec_k)
        if self.spec_k < 1:
            raise MXNetError(f"spec_k {self.spec_k} must be >= 1")
        if self.spec_decode and self.temperature != 0.0:
            raise NotSupportedError(
                "speculative decoding is greedy-only (acceptance "
                "compares argmaxes); serve temperature > 0 with "
                "spec_decode off")
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._steps = {}             # (kind, size) -> _Step
        self._warmed = False
        top = self.buckets[-1] // bs
        cuda = self.device.type == "cuda"
        sizes = [("prefill", self.buckets[-1]), ("decode", top)]
        if self.prefill_chunk:
            sizes.append(("chunk", top))
        if self.spec_decode:
            sizes.append(("verify", (self._verify_widths()[-1], top)))
        self._stage = torch.empty(
            max(sum(int(_np.prod(shape)) for shape in
                    self._input_shapes(kind, size)) for kind, size in sizes),
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
        """Raise if one of the weights the net holds now no longer lies
        where the engine took it: its steps (and their graphs) read the
        old storage and would serve stale weights.  A ``gluon.Trainer``
        built on the net after the engine moves every f32 parameter into
        its flat buffer; ``p.data = ...`` and ``cast`` move one too, and
        ``quantize_net`` replaces the projections.  In-place writes
        (``load_parameters``, ``convert``, an optimizer step) keep
        them."""
        if [w.data_ptr() for w in _net_leaves(self.net)] != \
                self._weight_ptrs:
            raise MXNetError(
                "the net's weights were moved since this "
                "InferenceEngine was built (a gluon.Trainer built on "
                "the net afterwards, p.data = ..., cast, quantize_net): "
                "build the engine after them, or a new one")

    def _quantize_in_place(self, net, calib_data, num_calib_batches):
        """The reference's: a net with ``QuantizedDense`` twins is served
        as it is; otherwise ``quantize_net`` calibrates on ``calib_data``
        (required) and swaps the projections in place."""
        from ..contrib.quantization import (QuantizedDense, _walk,
                                            quantize_net)
        from ..ndarray.ndarray import NDArray, array
        if not any(isinstance(m, QuantizedDense) for m in _walk(net)):
            if calib_data is None:
                raise MXNetError("quantize='int8' needs calib_data "
                                 "(token batches for PTQ calibration)")
            batches = [b if isinstance(b, NDArray) else
                       array(b, ctx=self.device) for b in calib_data]
            with torch.no_grad():
                quantize_net(net, calib_data=batches,
                             num_calib_batches=num_calib_batches)
        self.quantized = True

    @staticmethod
    def _proj_params(layer):
        """One projection as a tagged dict: ``{"w"}`` (float) or
        ``{"qw", "ws", "as"}`` (int8 codes, per-channel f32 scales, the
        f32 activation scale) of a ``QuantizedDense`` twin."""
        if hasattr(layer, "quantized_weight"):
            return {"qw": layer.quantized_weight,
                    "ws": layer.weight_scale.float(), "as": layer._as}
        return {"w": layer.weight.data().data.detach()}

    @classmethod
    def _extract_weights(cls, net):
        """The weights the steps read, the net's own tensors (no
        copies): the embedding, the norms and each projection's
        :meth:`_proj_params`."""
        m = net.model
        layers = []
        for layer in m.layers:
            lp = {"in_norm": layer.input_norm.weight.data().data.detach(),
                  "post_norm": layer.post_norm.weight.data().data.detach()}
            for name, part, proj in _LAYER_PROJ:
                lp[name] = cls._proj_params(
                    getattr(getattr(layer, part), proj))
            layers.append(lp)
        params = {"embed": m.embed.weight.data().data.detach(),
                  "norm": m.norm.weight.data().data.detach(),
                  "layers": layers}
        if net.lm_head is not None:
            params["head"] = cls._proj_params(net.lm_head)
        return params

    @staticmethod
    def _proj(x, p):
        """A projection, op for op the block's forward: the float one
        ``x @ w.T`` (in the wider of the two dtypes, as the reference's
        promotion); the int8 one ``QuantizedDense``'s round/clip, the
        int8 x int8 -> int32 product and the f32 rescale."""
        if "qw" in p:
            lead = x.shape[:-1]
            qx = quantize_rtn_int8(x.reshape(-1, x.shape[-1]), p["as"])
            acc = int8_matmul(qx, p["qw"])
            out = acc.float() * (p["as"] * p["ws"].reshape(1, -1))
            return out.reshape(lead + (out.shape[-1],))
        return _mm(x, p["w"])

    def _head_logits(self, x):
        if "head" in self.params:
            return self._proj(x, self.params["head"])
        return _mm(x, self.params["embed"])

    # -- the step bodies -------------------------------------------------

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
        return x + self._proj(F.silu(self._proj(y, lp["gate"])) *
                              self._proj(y, lp["up"]), lp["down"])

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
            q = self._proj(hh, lp["q"]).reshape(1, L, h, d).transpose(1, 2)
            k = self._proj(hh, lp["k"]).reshape(1, L, kvh, d).transpose(1, 2)
            v = self._proj(hh, lp["v"]).reshape(1, L, kvh, d).transpose(1, 2)
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
            x = x + self._proj(o, lp["o"])
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
            q = self._proj(hh, lp["q"]).reshape(B, h, d)
            k = self._proj(hh, lp["k"]).reshape(B, kvh, d)
            v = self._proj(hh, lp["v"]).reshape(B, kvh, d)
            q = _rot_interleaved(q, cos, sin)
            k = _rot_interleaved(k, cos, sin)
            self._write_kv(li, (blk, off), k, v)
            ks, vs = (None, None) if c.k_scale is None else \
                (c.k_scale[li], c.v_scale[li])
            o = paged_decode_attention(q, c.k_pool[li], c.v_pool[li], bts,
                                       pos, scale, k_scale=ks, v_scale=vs)
            x = x + self._proj(o, lp["o"])
            x = self._mlp(lp, x)
        return self._head_logits(_rms(x, self.params["norm"], eps))

    def _decode_and_sample(self, toks, pos, bts, blk):
        """The decode step's graph body: ``(logits (B, V), next tokens
        (B,))``."""
        logits = self._decode_body(toks, pos, bts, blk)
        return logits, self._sample(logits)

    def _chunk_body(self, toks, starts, valids, bts, active):
        """The packed continuation prefill (the reference's
        ``_build_chunk_prefill``) for ``R = max_batch`` rows of ``C =
        prefill_chunk`` tokens: row r's tokens sit at positions
        ``starts[r] + [0, C)``, the first ``valids[r]`` of them real.
        Each layer writes the real rows' K/V first (padded and inactive
        rows into the null block), gathers each row's ``nbl`` blocks
        (dequantizing fp8), repeats the K/V heads and attends through
        the flash kernel's offset form (``q_start`` = the row's start,
        repeated per head).  The head runs on each row's last valid
        hidden state only.  Returns (logits (R, V), tokens (R,))."""
        cfg = self.cfg
        h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        rep, eps = h // kvh, cfg.rms_eps
        bs = self.block_size
        R, C = toks.shape
        nbl = bts.shape[1]
        L = nbl * bs
        scale = 1.0 / math.sqrt(d)
        c = self.cache
        cidx = torch.arange(C, device=self.device)
        abs_pos = starts.long()[:, None] + cidx[None, :]     # (R, C)
        cos, sin = _rope_cos_sin(abs_pos, d, cfg.rope_theta)  # (R, C, d/2)
        write = (active[:, None] != 0) & (cidx[None, :] < valids[:, None])
        bts = bts.long()
        blk = torch.gather(bts, 1, torch.clamp(abs_pos // bs, max=nbl - 1))
        blk = torch.where(write, blk, 0)                     # null block
        off = abs_pos % bs
        q_start = starts.repeat_interleave(h)                # (R*h,) int32
        x = self.params["embed"][toks.long()]                # (R, C, hid)
        for li, lp in enumerate(self.params["layers"]):
            hh = _rms(x, lp["in_norm"], eps)
            q = self._proj(hh, lp["q"]).reshape(R, C, h, d)
            k = self._proj(hh, lp["k"]).reshape(R, C, kvh, d)
            v = self._proj(hh, lp["v"]).reshape(R, C, kvh, d)
            q = _rot_interleaved(q, cos[:, :, None], sin[:, :, None])
            k = _rot_interleaved(k, cos[:, :, None], sin[:, :, None])
            self._write_kv(li, (blk, off), k, v)
            ck = c.k_pool[li][bts].reshape(R, L, kvh, d)
            cv = c.v_pool[li][bts].reshape(R, L, kvh, d)
            if self._kv_fp8:
                ck = kv_dequantize(ck, c.k_scale[li][bts].reshape(R, L))
                cv = kv_dequantize(cv, c.v_scale[li][bts].reshape(R, L))
            ck, cv = ck.to(q.dtype), cv.to(q.dtype)
            kr = ck.transpose(1, 2).repeat_interleave(rep, dim=1) \
                .reshape(R * h, L, d)
            vr = cv.transpose(1, 2).repeat_interleave(rep, dim=1) \
                .reshape(R * h, L, d)
            o, _ = flash_attention_fwd(
                q.transpose(1, 2).reshape(R * h, C, d), kr, vr, True, scale,
                q_start=q_start)
            o = o.reshape(R, h, C, d).transpose(1, 2).reshape(R, C, h * d)
            x = x + self._proj(o, lp["o"])
            x = self._mlp(lp, x)
        x = _rms(x, self.params["norm"], eps)
        # each row's last valid hidden state, picked before the head (the
        # reference takes the same row from all R x C rows' logits)
        rows = x[torch.arange(R, device=self.device),
                 torch.clamp(valids.long() - 1, 0, C - 1)]   # (R, hid)
        last = self._head_logits(rows)                       # (R, V)
        return last, self._sample(last)

    def _verify_body(self, toks, pos, bts, counts, active):
        """The speculative verify step (the reference's
        ``_build_verify``): ``W = toks.shape[1]`` decode bodies unrolled,
        step ``w`` feeding ``toks[:, w]`` at ``pos + w`` and taking the
        argmax of its logits.  Steps past a row's count, and inactive
        rows, write the null block.  Returns the greedy tokens (B, W):
        ``[i, j]`` is the token after absorbing ``toks[i, :j + 1]``."""
        bs = self.block_size
        nbl = bts.shape[1]
        live_rows = active != 0
        outs = []
        for w in range(toks.shape[1]):
            live = live_rows & (w < counts)
            pw = pos + w
            idx = torch.clamp(pw // bs, max=nbl - 1).long()
            blk = torch.where(live, torch.gather(bts, 1, idx[:, None])[:, 0],
                              0).long()
            logits = self._decode_body(toks[:, w], pw, bts, blk)
            outs.append(torch.argmax(logits, dim=-1).to(torch.int32))
        return torch.stack(outs, dim=1)

    def _verify_widths(self):
        """The verify widths: the powers of two from 2 covering up to
        ``spec_k + 1`` fed tokens (the last committed one and the
        drafts); a boundary with no draft uses the plain decode step."""
        top = 2
        while top < self.spec_k + 1:
            top *= 2
        out, w = [], 2
        while w <= top:
            out.append(w)
            w *= 2
        return out

    def _input_shapes(self, kind, size):
        """The shapes of a ``(kind, size)`` step's int32 inputs, in the
        order of its flat buffer (see :class:`_Step`)."""
        B, bs = self.max_batch, self.block_size
        if kind == "prefill":
            return [(1, size), (1,), (size // bs,)]
        if kind == "decode":
            return [(B,), (B,), (B, size), (B,)]
        if kind == "chunk":
            return [(B, self.prefill_chunk), (B,), (B,), (B, size), (B,)]
        W, nbl = size
        return [(B, W), (B,), (B, nbl), (B,), (B,)]

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
        pick = _categorical(scaled, self._gen)[:, None]
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
        (the decode with every row inactive, writing the null block), then,
        when enabled, every table width's chunk step and every (width,
        table width)'s verify step, each with every row inactive (their
        writes land in the null block, so no pool block is needed): on
        CUDA each is captured as a graph here, before traffic.  Steps that
        exist already are skipped, as the reference skips signatures its
        cache holds.  Raises if the net's weights were moved since the
        engine was built (:meth:`_check_weights`)."""
        self._check_weights()
        B = self.max_batch
        for bucket in self.buckets:
            nb = bucket // self.block_size
            if ("prefill", bucket) in self._steps and \
                    ("decode", nb) in self._steps:
                continue
            # one slot key for every engine: over a shared pool it is
            # taken and freed within this loop, and a Router warms its
            # replicas one after another
            if not self.cache.alloc("__warmup__", bucket):
                raise MXNetError("warmup: KV pool too small for bucket "
                                 f"{bucket}; raise num_blocks")
            step = self._get("prefill", bucket)
            _, valid, table = step.stage()
            valid[0] = 1
            table[:] = self.cache.table("__warmup__")
            step.run()
            step = self._get("decode", nb)
            tables = step.stage()[2]
            tables[:] = self.cache.table_array(
                ["__warmup__"] + [None] * (B - 1), nb)
            step.run()
            self.cache.free("__warmup__")
        widths = [b // self.block_size for b in self.buckets]
        keys = []
        if self.prefill_chunk:
            keys += [("chunk", nb) for nb in widths]
        if self.spec_decode:
            keys += [("verify", (W, nb)) for W in self._verify_widths()
                     for nb in widths]
        for kind, size in keys:
            if (kind, size) not in self._steps:
                step = self._get(kind, size)
                step.stage()
                step.run()
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
        padded[0, :t], valid[0] = toks, t
        table[:] = self.cache.table(slot)
        last, tok = step.run()
        first, last = int(tok[0]), last.clone()
        self.cache.trim(slot, t)
        self.cache.set_len(slot, t)
        self.stats["prefill_calls"] += 1
        self.stats["prompt_tokens_computed"] += t
        return first, last

    def attach_prefix(self, slot, tokens):
        """Prefix-cache admission: adopt the longest cached block chain
        that prefixes ``tokens`` into ``slot`` (refcounts bumped, no
        compute) and return the number of cached positions (0: a miss,
        or no prefix cache; the caller prefills from there)."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.attach(slot, tokens)

    def insert_prefix(self, slot, tokens):
        """Register ``slot``'s freshly prefilled prompt in the prefix
        cache, so later requests that share the prefix skip its
        compute."""
        if self.prefix_cache is not None:
            self.prefix_cache.insert(slot, tokens)

    def pin_prefix(self, tokens):
        """Prefill ``tokens`` once into a temporary slot and pin the chain,
        the partial tail block included, in the prefix cache: every later
        request that starts with ``tokens`` adopts the blocks (and forks
        the tail on its first write past them) instead of recomputing
        them.  False when the pool cannot hold the prefix now."""
        if self.prefix_cache is None:
            raise MXNetError("pin_prefix needs prefix_cache=True")
        # id(self) keeps the slot apart from other engines' pins over a
        # shared pool (the disaggregated fleet)
        slot = ("__prefix_pin__", id(self), self.stats["prefill_calls"])
        if self.prefill(slot, tokens) is None:
            return False
        self.prefix_cache.insert(slot, tokens)
        self.release(slot)
        return True

    @torch.no_grad()
    def chunk_prefill(self, entries):
        """One packed continuation-prefill replay: ``entries`` is a list
        of ``(slot, tokens, start)`` rows; ``tokens`` (at most
        ``prefill_chunk`` of them) are the prompt positions ``[start,
        start + n)`` of ``slot``, whose table already holds everything
        before ``start``.

        Allocates and copy-on-write-forks the written blocks, runs the
        chunk step once for all rows, and returns ``(next_tokens (n,)
        np.int32, logits (n, V) numpy)`` aligned with ``entries``, as the
        reference does (bf16 logits widen to float32, which numpy has; a
        row's token means something only where its chunk ends the
        prompt).  None when the pool cannot cover the
        chunk (the caller may evict prefix chains and retry).  Raises if
        the net's weights were moved since the engine was built."""
        self._check_weights()
        if not self.prefill_chunk:
            raise MXNetError("chunk_prefill needs prefill_chunk > 0")
        n = len(entries)
        if not 1 <= n <= self.max_batch:
            raise MXNetError(f"chunk_prefill: {n} rows vs max_batch "
                             f"{self.max_batch}")
        C = self.prefill_chunk
        end_max = 0
        for slot, toks, start in entries:
            t = len(toks)
            if not 1 <= t <= C:
                raise MXNetError(f"chunk of {t} tokens vs chunk bucket "
                                 f"{C}")
            if not self.cache.ensure(slot, start + t - 1):
                return None
            copies = self.cache.prepare_write(slot, start, start + t)
            if copies is None:
                return None
            self._apply_cow(copies)
            end_max = max(end_max, start + t)
        bucket = next_bucket(end_max, self.buckets)
        if bucket is None:
            raise MXNetError(f"chunk end {end_max} exceeds max_context "
                             f"{self.max_context}")
        nbl = bucket // self.block_size
        step = self._get("chunk", nbl)
        toks, starts, valids, tables, active = step.stage()
        slots = [None] * self.max_batch
        for i, (slot, chunk, start) in enumerate(entries):
            toks[i, :len(chunk)] = _np.asarray(chunk, _np.int64)
            starts[i], valids[i], active[i] = start, len(chunk), 1
            slots[i] = slot
        tables[:] = self.cache.table_array(slots, nbl)
        last, nxt = step.run()
        last = last[:n].float().cpu().numpy()
        for slot, chunk, start in entries:
            self.cache.set_len(slot, start + len(chunk))
        self.stats["chunk_prefill_calls"] += 1
        self.stats["prompt_tokens_computed"] += \
            int(sum(len(c) for _s, c, _p in entries))
        return nxt[:n].cpu().numpy(), last

    def _apply_cow(self, copies):
        """The device half of each ``(src, dst)`` copy-on-write fork the
        cache planned, with the fp8 scale rows, so the fork dequantizes
        as its source.  An index copy on the current stream, which the
        next replay runs on: it lands before the replay writes into the
        fork."""
        c = self.cache
        planes = [c.k_pool, c.v_pool]
        if self._kv_fp8:
            planes += [c.k_scale, c.v_scale]
        for src, dst in copies:
            for plane in planes:
                plane[:, dst] = plane[:, src]

    def reserve(self, slot, pos, n=1):
        """Grow ``slot``'s block table to cover positions
        ``[pos, pos + n)`` before a decode or verify step, and
        copy-on-write-fork any written block another holder (a prefix
        chain) still shares.  ``n > 1`` is the speculative write-ahead:
        the verify step writes the whole draft window before acceptance
        is known (rejected positions stay garbage until ``trim``).  Under
        pool pressure LRU prefix chains are evicted first (only chains,
        never a block a live sequence holds).  False when the pool is
        exhausted even then."""
        pc = self.prefix_cache
        c = self.cache
        last = pos + n - 1
        if not c.ensure(slot, last):
            need = c.blocks_for(last + 1) - len(c.table(slot))
            if pc is None or not pc.evict(blocks_needed=need):
                return False
            if not c.ensure(slot, last):
                return False
        copies = c.prepare_write(slot, pos, pos + n)
        if copies is None:
            if pc is None or not pc.evict(blocks_needed=1):
                return False
            copies = c.prepare_write(slot, pos, pos + n)
            if copies is None:
                return False
        self._apply_cow(copies)
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
        toks, pos, tables, blk = step.stage()
        for i, (slot, tok, p) in enumerate(entries):
            toks[i], pos[i] = tok, p
            self.cache.set_len(slot, p + 1)
        table = self.cache.table_array(slots, nbl)
        blk[:n] = table[_np.arange(n), pos[:n] // self.block_size]
        tables[:] = table
        logits, nxt = step.run()
        logits = logits[:n].clone()
        self.stats["decode_calls"] += 1
        return nxt[:n].cpu().numpy(), logits

    @torch.no_grad()
    def verify(self, entries):
        """One speculative verify replay.

        entries: list of ``(slot, tokens, position)``: ``tokens`` is the
        row's last committed token followed by its drafts (1 <= len <=
        spec_k + 1), fed at positions ``position .. position + len - 1``;
        the caller must have reserved that whole range.  Returns
        ``out`` (n, W) np.int32, ``out[i, j]`` the greedy token after
        absorbing ``tokens[i][:j + 1]``: the caller commits the drafts
        that match and trims the write-ahead past the committed length
        (``ContinuousBatcher._decode_spec``)."""
        if not entries:
            raise MXNetError("verify: empty batch")
        if self.temperature != 0.0:
            raise NotSupportedError(
                "verify is greedy-only; sampled decoding keeps the plain "
                "decode path")
        n = len(entries)
        if n > self.max_batch:
            raise MXNetError(f"verify batch {n} > max_batch")
        wmax = max(len(t) for _, t, _ in entries)
        if wmax < 1:
            raise MXNetError("verify: empty token row")
        if wmax > self.spec_k + 1:
            raise MXNetError(f"verify row of {wmax} tokens vs spec_k "
                             f"{self.spec_k} (+1 committed)")
        W = next_bucket(max(wmax, 2), self._verify_widths())
        end_max = max(p + len(t) for _, t, p in entries)
        bucket = next_bucket(end_max, self.buckets)
        if bucket is None:
            raise MXNetError(f"verify end {end_max} exceeds max_context "
                             f"{self.max_context}")
        nbl = bucket // self.block_size
        step = self._get("verify", (W, nbl))
        toks, pos, tables, counts, active = step.stage()
        slots = [s for s, _, _ in entries] + [None] * (self.max_batch - n)
        for i, (slot, tk, p) in enumerate(entries):
            tk = _np.asarray(tk, _np.int64).reshape(-1)
            toks[i, :tk.shape[0]] = tk
            pos[i], counts[i], active[i] = p, tk.shape[0], 1
            # write-ahead length; the batcher trims back to the committed
            # length after acceptance
            self.cache.set_len(slot, p + tk.shape[0])
        tables[:] = self.cache.table_array(slots, nbl)
        out = step.run()
        self.stats["verify_calls"] += 1
        self.stats["draft_tokens_scored"] += \
            int(sum(len(t) - 1 for _, t, _ in entries))
        return out[:n].cpu().numpy()

    def release(self, slot):
        """Finished sequence: drop its hold on its blocks (a block a
        prefix chain still holds stays in the pool)."""
        self.cache.free(slot)
