"""``mxnet_tpu_torch.serving.frontend`` -- the serving front end.

Counterpart of ``mxnet_tpu.serving.frontend``.  In this port:

- :class:`PrefixCache` -- hashes token prefixes to KV block chains, so a
  system prompt that every request shares is prefilled once; each
  request's blocks fork copy-on-write (``PagedKVCache`` refcounts), and
  LRU eviction only drops chains no live request still reads.

The reference's ``Router`` (replicas behind least-loaded admission) is
not ported yet (ROADMAP §1 item 5).
"""
from __future__ import annotations

from .prefix_cache import PrefixCache

__all__ = ["PrefixCache"]
