"""Continuous-batching request scheduler over the engine.

Counterpart of ``mxnet_tpu/serving/scheduler.py``: requests arrive on a
queue, new sequences JOIN the running decode batch at token boundaries
and finished ones vacate their slot in the same boundary, so the decode
batch never drains to admit work.  Prompts run through the engine's
bucketed prefill between decode steps, at most ``prefills_per_step`` per
boundary.  ``StaticBatcher`` is the fixed-batch baseline over the same
engine.

Everything here is host-side policy; per boundary the host reads back
only the sampled tokens.  Not in this slice: chunked admission,
speculative decoding and the disaggregated prefill/decode roles; their
constructor arguments (``speculative``, ``spec_k``, ``slot_ns``,
``role``) are taken at the values that change nothing and refused
otherwise, and ``stats()`` reports the reference's ``verify_steps`` (0)
and ``spec_accept_rate`` (None) of a run without speculation.
"""
from __future__ import annotations

import itertools
import time
from collections import deque

from ..base import MXNetError, NotSupportedError

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
                # no speculative decoding in the port: the reference's
                # values without it
                "verify_steps": 0, "spec_accept_rate": None,
                "tokens_per_dispatch": (
                    round(self.tokens_generated / self.decode_steps, 4)
                    if self.decode_steps else None),
                "occupancy": round(occ, 4) if occ is not None else None,
                "p50_latency_s": pct(0.50), "p99_latency_s": pct(0.99),
                "cache": self.engine.cache.stats()}


class ContinuousBatcher(_BatcherBase):
    """Token-boundary continuous batching: admit into free slots before
    every decode step, evict finished sequences the moment EOS/length
    hits, never drain the batch to take new work."""

    def __init__(self, engine, prefills_per_step=1, speculative=None,
                 spec_k=None, slot_ns=None, role="combined"):
        _refuse("speculative", speculative, 5)
        _refuse("spec_k", spec_k is not None, 5)
        super().__init__(engine, slot_ns=slot_ns, role=role)
        self.prefills_per_step = int(prefills_per_step)
        self.active = {}          # slot -> Request
        self._free_slots = list(range(engine.max_batch - 1, -1, -1))

    def step(self):
        """One scheduling boundary: admit up to ``prefills_per_step``
        queued requests, then run one joined decode step.  Returns the
        work done (admissions + sequences decoded; 0 is a no-op)."""
        admitted = self._admit_serial()
        if not self.active:
            return admitted
        before = set(self.active)
        self._decode_active(self.active)
        for slot in before - set(self.active):
            self._free_slots.append(slot)
        return admitted + len(before)

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

    def run(self, max_steps=100000):
        """Drive until queue and batch are empty."""
        steps = 0
        while self.queue or self.active:
            moved = self.step()
            steps += 1
            if steps > max_steps:
                raise MXNetError("run() exceeded max_steps - scheduler "
                                 "wedged (pool too small for any "
                                 "queued request?)")
            if moved == 0 and not self.active and self.queue:
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
