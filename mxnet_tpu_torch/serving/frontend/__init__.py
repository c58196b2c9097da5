"""``mxnet_tpu_torch.serving.frontend`` -- the serving front end.

Counterpart of ``mxnet_tpu.serving.frontend``:

- :class:`PrefixCache` -- hashes token prefixes to KV block chains, so a
  system prompt that every request shares is prefilled once; each
  request's blocks fork copy-on-write (``PagedKVCache`` refcounts), and
  LRU eviction only drops chains no live request still reads.
- :class:`Router` -- N engine replicas behind least-loaded admission, an
  epoch-numbered replica set, death -> drain -> requeue with no request
  lost or duplicated, and disaggregated prefill/decode replicas over one
  shared KV pool; :class:`AdmissionShed` is what a shedding router
  raises.  Each replica captures its own CUDA graphs (no compile cache
  is shared).
"""
from __future__ import annotations

from .prefix_cache import PrefixCache
from .router import AdmissionShed, Replica, Router

__all__ = ["PrefixCache", "Router", "Replica", "AdmissionShed"]
