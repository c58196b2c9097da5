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
  typed :class:`DoubleFreeError`);
- :class:`ContinuousBatcher` / :class:`StaticBatcher` -- token-boundary
  continuous batching (chunked admission, speculative boundaries) and
  the fixed-batch baseline over the same engine;
- :class:`PrefixCache` (``frontend``) and :class:`DraftSource` -- the
  prefix chains and the model-free drafts.
"""
from __future__ import annotations

from .draft import DraftSource
from .engine import InferenceEngine, next_bucket
from .frontend import PrefixCache
from .kv_cache import DoubleFreeError, PagedKVCache
from .scheduler import ContinuousBatcher, Request, StaticBatcher

__all__ = ["InferenceEngine", "PagedKVCache", "DoubleFreeError",
           "ContinuousBatcher", "StaticBatcher", "Request", "next_bucket",
           "PrefixCache", "DraftSource"]
