"""Model-free draft sources for speculative decoding.

Counterpart of ``mxnet_tpu/serving/draft.py``.  Speculative decoding
needs candidate continuations cheaper than a model step; two sources
cost nothing:

- the :class:`~.frontend.prefix_cache.PrefixCache` trie: every prompt
  (and pinned system prompt) ever inserted is a token chain keyed by its
  exact prefix, so "what did earlier traffic say after these tokens?" is
  one refcount-neutral trie walk (``PrefixCache.continuation``);
- the request's own context: prompt-lookup (n-gram self-match), for
  generations that repeat spans of their prompt.

A draft is a guess: the engine's ``verify`` step scores it against the
model in one replay and the batcher commits exactly the greedy-matching
prefix, so a bad draft costs the wasted verify rows, never correctness.

Everything here is host-side integer work at token boundaries,
deterministic for a given context.
"""
from __future__ import annotations

__all__ = ["DraftSource"]


class DraftSource:
    """Propose up to ``k`` continuation tokens for a request context.

    Parameters
    ----------
    prefix_cache : optional PrefixCache whose trie is consulted first
        (its chains come from real traffic and beat self-matches when
        present); None = prompt-lookup only.
    ngram : longest trailing n-gram tried for the prompt-lookup
        self-match (falls through to shorter grams down to 1).
    """

    def __init__(self, prefix_cache=None, ngram=3):
        self.prefix_cache = prefix_cache
        self.ngram = max(1, int(ngram))
        # accounting (host ints; the scheduler publishes rates)
        self.proposals = 0
        self.from_cache = 0
        self.from_ngram = 0

    def propose(self, context, k):
        """Up to ``k`` draft tokens continuing ``context`` (the
        request's prompt + generated so far).  Empty list = nothing to
        speculate on (the scheduler then decodes plainly)."""
        k = int(k)
        if k <= 0 or len(context) < 2:
            return []
        out = []
        if self.prefix_cache is not None:
            out = self.prefix_cache.continuation(context, k)
            if out:
                self.from_cache += 1
        if not out:
            out = self._ngram_match(context, k)
            if out:
                self.from_ngram += 1
        if out:
            self.proposals += 1
        return [int(t) for t in out[:k]]

    def _ngram_match(self, context, k):
        """Prompt-lookup decoding: find the most recent EARLIER
        occurrence of the trailing n-gram in the context and propose
        the tokens that followed it (longest gram wins, then recency —
        deterministic)."""
        ctx = [int(t) for t in context]
        top = min(self.ngram, len(ctx) - 1)
        for n in range(top, 0, -1):
            tail = ctx[-n:]
            # the tail itself starts at len(ctx)-n; scan strictly
            # earlier starts, most recent first
            for i in range(len(ctx) - n - 1, -1, -1):
                if ctx[i:i + n] == tail:
                    cont = ctx[i + n:i + n + k]
                    if cont:
                        return cont
        return []
