"""``mxnet_tpu_torch.serving`` -- single-card inference serving.

Counterpart of ``mxnet_tpu.serving``:

- :class:`InferenceEngine` -- bucketed prefill through the flash kernel
  and single-token decode through the paged-decode kernel, over a paged
  KV cache updated in place;
- :class:`PagedKVCache` -- block-table indexed K/V pool with the
  reference's host accounting (null block 0, LIFO free list, refcounts,
  typed :class:`DoubleFreeError`);
- :class:`ContinuousBatcher` / :class:`StaticBatcher` -- token-boundary
  continuous batching and the fixed-batch baseline over the same engine.
"""
from __future__ import annotations

from .engine import InferenceEngine, next_bucket
from .kv_cache import DoubleFreeError, PagedKVCache
from .scheduler import ContinuousBatcher, Request, StaticBatcher

__all__ = ["InferenceEngine", "PagedKVCache", "DoubleFreeError",
           "ContinuousBatcher", "StaticBatcher", "Request", "next_bucket"]
