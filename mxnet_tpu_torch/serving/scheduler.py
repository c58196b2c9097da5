"""Continuous-batching request scheduler over the engine.

Counterpart of ``mxnet_tpu/serving/scheduler.py``: requests arrive on a
queue, new sequences JOIN the running decode batch at token boundaries
and finished ones vacate their slot in the same boundary, so the decode
batch never drains to admit work.  A boundary admits, then decodes:

- admission: with the engine's ``prefill_chunk`` set, one packed
  ``chunk_prefill`` a boundary (the tail chunks of prompts in flight
  first, then new requests through the prefix cache); else up to
  ``prefills_per_step`` bucketed prefills;
- decoding: one joined ``decode`` step or, with ``speculative``, one
  ``verify`` step scoring each row's drafts (``DraftSource``), which
  commits the greedy-matching prefix and trims the write-ahead.

``StaticBatcher`` is the fixed-batch baseline over the same engine.

Everything here is host-side policy; per boundary the host reads back
only the sampled tokens.  Not in this slice: the disaggregated
prefill/decode roles; their constructor arguments (``slot_ns``,
``role``) are taken at the values that change nothing and refused
otherwise.  The reference's trace spans and telemetry are not ported
(ROADMAP §1 item 11).
"""
from __future__ import annotations

import itertools
import time
from collections import deque

from ..base import MXNetError, NotSupportedError
from .draft import DraftSource

__all__ = ["Request", "ContinuousBatcher", "StaticBatcher"]

_ids = itertools.count()


class Request:
    """One generation request: ``tokens`` (prompt ids), ``max_new_tokens``
    and an optional per-request ``eos_id``."""

    def __init__(self, tokens, max_new_tokens, eos_id=None, request_id=None):
        self.id = next(_ids) if request_id is None else request_id
        self.tokens = [int(t) for t in tokens]
        if not self.tokens:
            raise MXNetError("Request needs at least one prompt token")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        # lifecycle stamps (perf_counter seconds) + outputs
        self.submit_t = None
        self.first_token_t = None
        self.finish_t = None
        self.generated = []
        self.finish_reason = None     # "eos" | "length"

    @property
    def done(self):
        return self.finish_reason is not None

    def latency(self):
        if self.submit_t is None or self.finish_t is None:
            return None
        return self.finish_t - self.submit_t

    def ttft(self):
        """Time to first token."""
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    def tpot(self):
        """Time per output token after the first (None until a second
        token exists)."""
        if (self.first_token_t is None or self.finish_t is None
                or len(self.generated) < 2):
            return None
        return (self.finish_t - self.first_token_t) \
            / (len(self.generated) - 1)


def _refuse(what, value, item):
    if value:
        raise NotSupportedError(
            f"{what}={value!r} is not ported yet: it arrives with ROADMAP "
            f"§1 item {item}")


class _BatcherBase:
    def __init__(self, engine, slot_ns=None, role="combined"):
        # the reference's arguments: a slot namespace for engines that
        # share one KV cache, and the disaggregated roles; the port takes
        # each at the value that changes nothing
        _refuse("slot_ns", slot_ns is not None, 5)
        _refuse("role", role != "combined", 5)
        self.engine = engine
        self.queue = deque()
        self.finished = []
        # per-boundary occupancy samples: active slots / max_batch
        self.occupancy_samples = []
        self.decode_steps = 0
        self.tokens_generated = 0
        self.verify_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0

    def submit(self, request):
        request.submit_t = time.perf_counter()
        self.queue.append(request)
        return request

    def _admit_one(self, slot, req):
        """Prefill ``req`` into ``slot``; True on admission.  The first
        generated token comes from the prefill itself."""
        out = self.engine.prefill(slot, req.tokens)
        if out is None:
            return False
        tok, _logits = out
        req.first_token_t = time.perf_counter()
        self._append_token(req, slot, tok)
        return True

    def _append_token(self, req, slot, tok):
        req.generated.append(int(tok))
        self.tokens_generated += 1
        if req.eos_id is not None and int(tok) == int(req.eos_id):
            req.finish_reason = "eos"
        elif len(req.generated) >= req.max_new_tokens:
            req.finish_reason = "length"
        if req.done:
            req.finish_t = time.perf_counter()
            self.engine.release(slot)
            self.finished.append(req)

    def _decode_active(self, active):
        """One joined decode step over ``active`` {slot: request}."""
        entries = []
        for slot, req in active.items():
            pos = len(req.tokens) + len(req.generated) - 1
            # the token AT ``pos`` is the last generated one; its K/V is
            # written by this step, so the table must cover ``pos``
            if not self.engine.reserve(slot, pos):
                raise MXNetError("KV pool exhausted mid-decode; raise "
                                 "num_blocks or lower max_batch")
            entries.append((slot, req.generated[-1], pos))
        nxt, _logits = self.engine.decode(entries)
        self.decode_steps += 1
        self.occupancy_samples.append(len(entries) / self.engine.max_batch)
        for (slot, _t, _p), tok in zip(entries, nxt):
            self._append_token(active[slot], slot, tok)
        for slot in [s for s, r in active.items() if r.done]:
            del active[slot]

    def occupancy(self):
        s = self.occupancy_samples
        return sum(s) / len(s) if s else None

    def stats(self):
        lat = sorted(r.latency() for r in self.finished
                     if r.latency() is not None)

        def pct(p):
            if not lat:
                return None
            return lat[min(len(lat) - 1, int(round(p * (len(lat) - 1))))]

        occ = self.occupancy()
        return {"requests": len(self.finished),
                "tokens_generated": self.tokens_generated,
                "decode_steps": self.decode_steps,
                "verify_steps": self.verify_steps,
                "spec_accept_rate": (
                    round(self.spec_accepted / self.spec_drafted, 4)
                    if self.spec_drafted else None),
                "tokens_per_dispatch": (
                    round(self.tokens_generated / self.decode_steps, 4)
                    if self.decode_steps else None),
                "occupancy": round(occ, 4) if occ is not None else None,
                "p50_latency_s": pct(0.50), "p99_latency_s": pct(0.99),
                "cache": self.engine.cache.stats()}


class _PrefillState:
    """A prompt part-way through chunked prefill: ``done`` positions of
    ``req.tokens`` are cached in ``slot`` (prefix-cache hits count)."""

    __slots__ = ("req", "slot", "done")

    def __init__(self, req, slot, done):
        self.req = req
        self.slot = slot
        self.done = int(done)


class ContinuousBatcher(_BatcherBase):
    """Token-boundary continuous batching: admit into free slots before
    every decode step, evict finished sequences the moment EOS/length
    hits, never drain the batch to take new work.  With the engine's
    ``prefill_chunk`` set, admission packs chunks of several prompts
    into one replay a boundary; with ``speculative`` (default: the
    engine's ``spec_decode``) each boundary verifies drafts of up to
    ``spec_k`` tokens a row (default and ceiling: the engine's)."""

    # boundaries a sequence sits out after its drafts stop landing (a
    # host counter; it drafts again when it expires)
    _spec_cooldown = 8
    _spec_miss_limit = 2

    def __init__(self, engine, prefills_per_step=1, speculative=None,
                 spec_k=None, slot_ns=None, role="combined"):
        super().__init__(engine, slot_ns=slot_ns, role=role)
        self.prefills_per_step = int(prefills_per_step)
        self.active = {}          # slot -> Request
        self.prefilling = {}      # slot -> _PrefillState (chunked only)
        self._free_slots = list(range(engine.max_batch - 1, -1, -1))
        self.speculative = engine.spec_decode if speculative is None \
            else bool(speculative)
        if self.speculative and not engine.spec_decode:
            raise MXNetError(
                "speculative batching needs an engine built with "
                "spec_decode=True (the verify steps are built at warmup)")
        self.spec_k = engine.spec_k if spec_k is None else int(spec_k)
        if not 1 <= self.spec_k <= engine.spec_k:
            raise MXNetError(f"spec_k {self.spec_k} outside the "
                             f"engine's [1, {engine.spec_k}]")
        self.draft = DraftSource(prefix_cache=engine.prefix_cache)
        self._spec_state = {}     # req.id -> [misses, cooldown]

    def step(self):
        """One scheduling boundary: admit queued requests (one packed
        chunk replay when chunked, else up to ``prefills_per_step``
        prefills), then run one joined decode or verify step.  Returns
        the work done (admissions + chunk rows + sequences decoded; 0 is
        a no-op)."""
        if self.engine.prefill_chunk:
            admitted = self._admit_chunked()
        else:
            admitted = self._admit_serial()
        if not self.active:
            return admitted
        before = set(self.active)
        if self.speculative:
            self._decode_spec(self.active)
        else:
            self._decode_active(self.active)
        for slot in before - set(self.active):
            self._free_slots.append(slot)
        return admitted + len(before)

    def _decode_spec(self, active):
        """One speculative boundary: draft, verify in one replay, commit
        the greedy-matching prefix, trim the write-ahead.

        A committed token is either a verify argmax (the decode body op
        for op) or a draft that equalled one, so the stream is the plain
        greedy stream in fewer replays.  A boundary where no row drafts
        (cold caches, cooldowns, length caps) runs the plain decode
        step."""
        eng = self.engine
        drafts = {}
        any_draft = False
        for slot, req in active.items():
            pos = len(req.tokens) + len(req.generated) - 1
            st = self._spec_state.get(req.id)
            if st is not None and st[1] > 0:
                st[1] -= 1        # cooling down: rides as a plain row
                drafts[slot] = []
                continue
            # a draft commits up to cap + 1 tokens and writes K/V up to
            # pos + cap: the length budget and the context ceiling bound
            # the window
            cap = min(self.spec_k,
                      req.max_new_tokens - len(req.generated) - 1,
                      eng.max_context - 2 - pos)
            d = self.draft.propose(req.tokens + req.generated, cap) \
                if cap > 0 else []
            drafts[slot] = d
            if d:
                any_draft = True
        if not any_draft:
            return self._decode_active(active)
        entries = []
        for slot, req in active.items():
            pos = len(req.tokens) + len(req.generated) - 1
            toks = [req.generated[-1]] + drafts[slot]
            if len(toks) > 1 and not eng.reserve(slot, pos, len(toks)):
                toks = toks[:1]   # pool pressure: shed the write-ahead
            if len(toks) == 1 and not eng.reserve(slot, pos):
                raise MXNetError("KV pool exhausted mid-decode; raise "
                                 "num_blocks or lower max_batch")
            entries.append((slot, toks, pos))
        out = eng.verify(entries)
        self.decode_steps += 1
        self.verify_steps += 1
        self.occupancy_samples.append(len(entries) / eng.max_batch)
        for i, (slot, toks, pos) in enumerate(entries):
            req = active[slot]
            D = len(toks) - 1
            # out[i, j] is the greedy token after toks[:j + 1]: each draft
            # that matches its predecessor's argmax is accepted, and the
            # match's own argmax rides along as the next commit
            committed = [int(out[i, 0])]
            j = 1
            while j <= D and int(toks[j]) == int(out[i, j - 1]):
                committed.append(int(out[i, j]))
                j += 1
            accepted = j - 1
            self.spec_drafted += D
            self.spec_accepted += accepted
            if D:
                st = self._spec_state.setdefault(req.id, [0, 0])
                if accepted == 0:
                    st[0] += 1
                    if st[0] >= self._spec_miss_limit:
                        st[0], st[1] = 0, self._spec_cooldown
                else:
                    st[0] = 0
            for tok in committed:
                if req.done:
                    break         # EOS inside the window: the rest is moot
                self._append_token(req, slot, tok)
            if req.done:
                self._spec_state.pop(req.id, None)
            else:
                # roll back the write-ahead: K/V past the committed length
                # is rejected-draft garbage; drop the length and any block
                # (a fork included) only the garbage covered
                n = pos + 1 + accepted
                eng.cache.trim(slot, n)
                eng.cache.set_len(slot, n)
        for slot in [s for s, r in active.items() if r.done]:
            del active[slot]

    def _admit_serial(self):
        admitted = 0
        while (self.queue and self._free_slots
               and admitted < self.prefills_per_step):
            slot = self._free_slots[-1]
            req = self.queue[0]
            if not self._admit_one(slot, req):
                break                       # pool full / prompt too long
            self.queue.popleft()
            self._free_slots.pop()
            admitted += 1
            if req.done:                    # finished inside prefill
                self._free_slots.append(slot)
            else:
                self.active[slot] = req
        return admitted

    def _admit_chunked(self):
        """Pack one ``chunk_prefill`` replay: the tail chunks of prompts
        in flight first (they hold slots and blocks: finish them), then
        new admissions through the prefix cache.  Returns admissions +
        rows replayed."""
        eng = self.engine
        C = eng.prefill_chunk
        entries, rows = [], {}
        for slot, st in list(self.prefilling.items()):
            if len(entries) >= eng.max_batch:
                break
            chunk = st.req.tokens[st.done:st.done + C]
            entries.append((slot, chunk, st.done))
            rows[slot] = st
        admitted = 0
        while (self.queue and self._free_slots
               and len(entries) < eng.max_batch):
            req = self.queue[0]
            if len(req.tokens) - 1 >= eng.max_context:
                raise MXNetError(
                    "request cannot be admitted (prompt exceeds "
                    "max_context)")
            slot = self._free_slots[-1]
            start = eng.attach_prefix(slot, req.tokens)
            if start == 0 and not eng.cache.alloc(slot, 0):
                break                       # cannot even open a table
            self.queue.popleft()
            self._free_slots.pop()
            st = _PrefillState(req, slot, start)
            self.prefilling[slot] = st
            entries.append((slot, req.tokens[start:start + C], start))
            rows[slot] = st
            admitted += 1
        if not entries:
            return admitted
        out = eng.chunk_prefill(entries)
        if out is None and eng.prefix_cache is not None:
            # pool pressure: evict LRU chains no request still shares
            # (blocks of refcount > 1 survive), then retry once
            need = sum(
                max(0, eng.cache.blocks_for(start + len(chunk))
                    - len(eng.cache.table(slot)))
                for slot, chunk, start in entries)
            if eng.prefix_cache.evict(blocks_needed=need):
                out = eng.chunk_prefill(entries)
        if out is None:
            # still starved: prompts in flight keep their state and retry
            # at the next boundary (decode frees blocks as requests end)
            return admitted
        nxt, _logits = out
        for i, (slot, chunk, start) in enumerate(entries):
            st = rows[slot]
            st.done = start + len(chunk)
            if st.done < len(st.req.tokens):
                continue                    # more chunks to come
            del self.prefilling[slot]
            req = st.req
            req.first_token_t = time.perf_counter()
            # register the finished prompt before decode writes past it
            # (the partial tail block forks on the first write)
            eng.insert_prefix(slot, req.tokens)
            self._append_token(req, slot, int(nxt[i]))
            if req.done:
                self._free_slots.append(slot)
            else:
                self.active[slot] = req
        return admitted + len(entries)

    def run(self, max_steps=100000):
        """Drive until queue, prompts in flight and batch are empty."""
        steps = 0
        while self.queue or self.active or self.prefilling:
            moved = self.step()
            steps += 1
            if steps > max_steps:
                raise MXNetError("run() exceeded max_steps - scheduler "
                                 "wedged (pool too small for any "
                                 "queued request?)")
            if moved == 0 and not self.active and \
                    (self.queue or self.prefilling):
                # a no-op boundary with work still queued: the head
                # request can never be admitted
                raise MXNetError(
                    "request cannot be admitted (prompt exceeds "
                    "max_context or KV pool too small)")
        return self.stats()


class StaticBatcher(_BatcherBase):
    """The fixed-batch baseline: form a batch of up to ``max_batch``
    requests, prefill them all, decode until EVERY member finishes, then
    form the next batch.  Same engine; only the policy differs."""

    def run(self, max_steps=100000):
        steps = 0
        while self.queue:
            n_before = len(self.queue)
            active = {}
            for slot in range(self.engine.max_batch):
                if not self.queue:
                    break
                req = self.queue[0]
                if not self._admit_one(slot, req):
                    break
                self.queue.popleft()
                if not req.done:
                    active[slot] = req
            if len(self.queue) == n_before:
                raise MXNetError(
                    "request cannot be admitted (prompt exceeds "
                    "max_context or KV pool too small)")
            while active:
                self._decode_active(active)
                steps += 1
                if steps > max_steps:
                    raise MXNetError("static run exceeded max_steps")
        return self.stats()
