"""``mxnet_tpu_torch.serving`` -- single-card inference serving.

Counterpart of ``mxnet_tpu.serving``:

- :class:`InferenceEngine` -- bucketed prefill through the flash kernel
  and single-token decode through the paged-decode kernel, over a paged
  KV cache updated in place; with ``prefill_chunk`` a packed chunked
  prefill (the flash kernel's offset form), with ``prefix_cache`` a
  copy-on-write prefix cache, with ``spec_decode`` a speculative
  ``verify`` step;
- :class:`PagedKVCache` -- block-table indexed K/V pool with the
  reference's host accounting (null block 0, LIFO free list, refcounts,
  typed :class:`DoubleFreeError`, and :class:`HandoffError` for a block
  handoff between engines that share one pool);
- :class:`ContinuousBatcher` / :class:`StaticBatcher` -- token-boundary
  continuous batching (chunked admission, speculative boundaries) and
  the fixed-batch baseline over the same engine;
- :class:`PrefixCache` (``frontend``) and :class:`DraftSource` -- the
  prefix chains and the model-free drafts;
- :class:`Router` (``frontend``) -- engine replicas behind least-loaded
  admission, with death, drain and requeue, and disaggregated prefill
  and decode replicas over one shared pool (:class:`AdmissionShed`);
- :func:`serving_block` -- the benchmark record's ``serving`` block.

``tools/port_serve_loadgen.py`` drives a fleet through ``Router``.
"""
from __future__ import annotations

from .draft import DraftSource
from .engine import InferenceEngine, next_bucket
from .frontend import AdmissionShed, PrefixCache, Router
from .kv_cache import DoubleFreeError, HandoffError, PagedKVCache
from .scheduler import ContinuousBatcher, Request, StaticBatcher

__all__ = ["InferenceEngine", "PagedKVCache", "DoubleFreeError",
           "HandoffError", "ContinuousBatcher", "StaticBatcher",
           "Request", "next_bucket", "serving_block", "PrefixCache",
           "Router", "AdmissionShed", "DraftSource"]


def _r(x, nd=3):
    return None if x is None else round(float(x), nd)


def serving_block(max_batch=0, block_size=0, buckets=(), quantized=False,
                  continuous=True, requests=0, p50_ms=None, p99_ms=None,
                  ttft_p50_ms=None, tokens_s=None, tokens_s_chip=None,
                  occupancy=None, tokens_per_step=None,
                  compiles_after_warmup=None, cache_utilization=None,
                  chunked_prefill=False, router_replicas=0,
                  prefix_hit_rate=None, router_p99_ms=None,
                  speculative=False, paged_attn=False,
                  spec_accept_rate=None, tokens_per_dispatch=None,
                  tp_shards=0, disaggregated=False, handoff_ms=None,
                  prefill_pool_occupancy=None,
                  decode_pool_occupancy=None, kv_dtype="fp32",
                  kv_capacity_ratio=None, kv_decode_drift=None):
    """The benchmark record's ``serving`` block (the reference's, key for
    key): the static configuration is always real; the measured fields
    default to ``None``, so a field nobody measured never reads as zero
    latency or a perfect rate.  Config: ``max_batch`` ... ``continuous``,
    ``chunked_prefill``, ``router_replicas``, ``speculative``,
    ``paged_attn``, ``tp_shards``, ``disaggregated``, ``kv_dtype``;
    everything else is measured (``handoff_ms`` and the pool occupancies
    only by a disaggregated run, ``kv_capacity_ratio`` and
    ``kv_decode_drift`` only with a low-precision KV pool)."""
    return {
        "max_batch": int(max_batch),
        "block_size": int(block_size),
        "buckets": list(int(b) for b in buckets),
        "quantized": bool(quantized),
        "continuous": bool(continuous),
        "requests": int(requests),
        "p50_ms": _r(p50_ms), "p99_ms": _r(p99_ms),
        "ttft_p50_ms": _r(ttft_p50_ms),
        "tokens_s": _r(tokens_s, 1), "tokens_s_chip": _r(tokens_s_chip, 1),
        "occupancy": _r(occupancy, 4),
        "tokens_per_step": _r(tokens_per_step, 3),
        "compiles_after_warmup": (None if compiles_after_warmup is None
                                  else int(compiles_after_warmup)),
        "cache_utilization": _r(cache_utilization, 4),
        "chunked_prefill": bool(chunked_prefill),
        "router_replicas": int(router_replicas),
        "prefix_hit_rate": _r(prefix_hit_rate, 4),
        "router_p99_ms": _r(router_p99_ms),
        "speculative": bool(speculative),
        "paged_attn": bool(paged_attn),
        "spec_accept_rate": _r(spec_accept_rate, 4),
        "tokens_per_dispatch": _r(tokens_per_dispatch, 3),
        "tp_shards": int(tp_shards),
        "disaggregated": bool(disaggregated),
        "handoff_ms": _r(handoff_ms),
        "prefill_pool_occupancy": _r(prefill_pool_occupancy, 4),
        "decode_pool_occupancy": _r(decode_pool_occupancy, 4),
        "kv_dtype": str(kv_dtype or "fp32"),
        "kv_capacity_ratio": _r(kv_capacity_ratio),
        "kv_decode_drift": (None if kv_decode_drift is None
                            else float(kv_decode_drift)),
    }
