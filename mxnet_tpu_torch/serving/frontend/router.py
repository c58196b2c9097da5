"""Multi-replica serving router: least-loaded admission, epoch-fenced
replica membership, drain-and-requeue on replica death.

Counterpart of ``mxnet_tpu/serving/frontend/router.py``.  The Router
owns N :class:`~mxnet_tpu_torch.serving.InferenceEngine` replicas, each
with its own :class:`~mxnet_tpu_torch.serving.ContinuousBatcher`, KV
pool and prefix cache, and:

- **admits** each request to the live replica with the lowest load
  score: queue depth, KV block utilization and median recent TTFT, as
  each replica published them at its last scheduling boundary (read
  live only before a replica's first boundary), the reference's choice
  at its default, where those signals travel through its telemetry
  registry.  A signal some candidate has not measured (``None``) is
  left out for every candidate;
- **numbers the replica set with an epoch**: every death, drain or join
  bumps it;
- **drains and requeues** when a replica dies mid-traffic: its queued,
  prefilling and mid-decode requests are reset to their prompts and
  admitted again to the survivors.  Greedy decoding is deterministic,
  so a request run again produces the tokens it would have: none lost,
  none duplicated.

With ``disaggregated=True`` the fleet splits into prefill-role (even
rids) and decode-role (odd rids) replicas over ONE shared
:class:`~mxnet_tpu_torch.serving.PagedKVCache`: a prefill replica fills
a request's blocks, then a decode replica adopts them through the
refcounts (adopt, then release).

Two drive modes.  ``start()`` runs one worker thread per replica (each
replica's engine and batcher are touched only by its worker; the
router's bookkeeping is the only locked state).  ``drive()`` steps every
live replica once a round on the caller's thread: deterministic, no
sleeps.  Both run the same admission, death and requeue code.

On the card each replica's engine captures and replays its own CUDA
graphs: a graph bakes in its engine's pool and buffer addresses, so the
reference's one warmup compile cache for the fleet has no counterpart
(``engine_factory`` gets ``None`` for it; ``warmup_compiles_shared`` is
0).  In threaded mode :meth:`Router.add_replica` holds every worker at
its next boundary while the newcomer's warmup captures, since a capture
fails if another thread synchronizes with the device meanwhile.  All
replicas share one card: a device fault is sticky for the process and
ends every replica, where the reference's replicas are separate chips.
Not ported: tracing spans and telemetry events (ROADMAP §1 item 11) and
preemption notices (:meth:`Router.attach_notices`, item 11).
"""
from __future__ import annotations

import threading
import time

from ...base import MXNetError, NotSupportedError
from ...testing import faults
from ..kv_cache import HandoffError
from ..scheduler import ContinuousBatcher

__all__ = ["Router", "Replica", "AdmissionShed"]


class AdmissionShed(MXNetError):
    """The router is shedding new admissions (capacity below the healthy
    target).  In-flight and requeued requests are unaffected; the caller
    should back off or route elsewhere."""


class Replica:
    """One engine, its batcher and (in threaded mode) its worker thread.
    Everything here belongs to the thread that steps the replica; the
    Router reads or writes it only under its lock in ways that thread
    tolerates (the inbox, the death flag)."""

    __slots__ = ("rid", "engine", "batcher", "alive", "inbox",
                 "boundaries", "thread", "ttfts", "role")

    def __init__(self, rid, engine, batcher, role="combined"):
        self.rid = rid
        self.engine = engine
        self.batcher = batcher
        self.alive = True
        self.inbox = []          # guarded-by: Router._lock
        self.boundaries = 0      # scheduling boundaries stepped
        self.thread = None
        self.ttfts = []          # recent TTFTs (seconds) for scoring
        self.role = role         # combined | prefill | decode

    def load_signals(self, inbox_len=0):
        """The admission signals read off the replica now (what it
        publishes at each boundary).  ``inbox_len`` is read by the caller
        under the router lock."""
        b = self.batcher
        depth = len(b.queue) + int(inbox_len) + len(b.active) + \
            len(b.prefilling)
        recent = self.ttfts[-8:]
        # None, not 0.0, before the first measured TTFT: an unmeasured
        # replica reads as "no signal", never as "perfect"
        ttft_ms = (sorted(recent)[len(recent) // 2] * 1e3
                   if recent else None)
        return {"queue_depth": depth,
                "ttft_ms": ttft_ms,
                "kv_block_utilization": self.engine.cache.utilization()}


class Router:
    """Front end over ``replicas`` engine replicas.

    Parameters
    ----------
    engine_factory : callable(compile_cache) -> InferenceEngine
        (not warmed).  Called once per replica with ``None`` for the
        compile cache (the port shares none between engines); the router
        warms each engine.  A disaggregated router calls it as
        ``engine_factory(None, kv_cache=shared_or_None)``: the first
        replica creates the pool, every later one must pass the given
        ``kv_cache`` through to its ``InferenceEngine``.
    replicas : fleet size (>= 1); None means 2 (the reference reads
        ``MXTPU_SERVE_REPLICAS``; the port reads no environment knob).
    prefills_per_step : forwarded to each ContinuousBatcher.
    now : timestamp source for the membership events (a ``FakeClock``
        in tests; never used for waiting).
    disaggregated : split the fleet into prefill-role and decode-role
        replicas over one shared ``PagedKVCache``; None means False.
        ``drive()`` only.
    """

    def __init__(self, engine_factory, replicas=None,
                 prefills_per_step=1, now=None, disaggregated=None):
        if replicas is None:
            replicas = 2
        if replicas < 1:
            raise MXNetError(f"Router needs >= 1 replica, got {replicas}")
        self.disaggregated = bool(disaggregated)
        if self.disaggregated and replicas < 2:
            raise MXNetError(
                "disaggregated serving needs >= 2 replicas (at least "
                f"one prefill and one decode), got {replicas}")
        self._now = now if now is not None else time.time
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.epoch = 0             # guarded-by: _lock (replica-set epoch)
        self.requeues = 0          # guarded-by: _lock
        self._assigned = {}        # guarded-by: _lock; req.id -> rid
        self._submitted = {}       # guarded-by: _lock; req.id -> Request
        self._stopping = False     # guarded-by: _lock
        self._shedding = False     # guarded-by: _lock
        self._published = {}       # guarded-by: _lock; rid -> signals
        self._busy = 0             # guarded-by: _lock; workers mid-step
        self._paused = 0           # guarded-by: _lock; warmups holding
        self.events = []           # guarded-by: _lock; membership log
        self._factory = engine_factory
        self._prefills_per_step = prefills_per_step
        self.replicas = []
        self.handoffs = 0          # guarded-by: _lock
        self.handoff_ms = []       # guarded-by: _lock; one per handoff
        self._shared_cache = None  # disaggregated: the fleet's one pool
        warm0 = None
        for rid in range(replicas):
            role = self._role_for(rid)
            eng = self._make_engine()
            before = eng.stats["compiles"]
            eng.warmup()
            if rid == 0:
                warm0 = eng.stats["compiles"] - before
            self.replicas.append(Replica(rid, eng,
                                         self._make_batcher(eng, rid,
                                                            role),
                                         role=role))
        # replica 0's captures; every replica captures its own, so no
        # warmup is shared
        self.warmup_compiles = warm0 or 0
        self.warmup_compiles_shared = 0

    def _role_for(self, rid):
        """Disaggregated placement: even rids prefill, odd rids decode,
        so every fleet of >= 2 has one of each; ``add_replica(role=...)``
        grows either pool."""
        if not self.disaggregated:
            return "combined"
        return "prefill" if rid % 2 == 0 else "decode"

    def _make_engine(self):
        """One replica's engine from the factory.  Disaggregated, the
        factory gets the fleet's shared ``kv_cache`` (None for the first
        replica, whose pool every later one adopts)."""
        if not self.disaggregated:
            return self._factory(None)
        eng = self._factory(None, kv_cache=self._shared_cache)
        if self._shared_cache is None:
            self._shared_cache = eng.cache
        elif eng.cache is not self._shared_cache:
            raise HandoffError(
                "disaggregated replicas must share one PagedKVCache: "
                "the engine_factory ignored its kv_cache argument")
        # the creator's pool outlives it too (the fleet shares it), so
        # its death must free its slots like any other replica's
        eng.cache_shared = True
        return eng

    def _make_batcher(self, eng, rid, role):
        return ContinuousBatcher(
            eng, self._prefills_per_step,
            slot_ns=(rid if self.disaggregated else None), role=role)

    # -- membership ------------------------------------------------------

    def live_replicas(self):
        return [r for r in self.replicas if r.alive]

    def kill_replica(self, rid):
        """Administrative kill: the path a crashed worker takes (epoch
        bump, drain, requeue)."""
        self._on_death(self.replicas[rid],
                       MXNetError(f"replica {rid} killed"))

    def _evacuate(self, rep, event_kind, detail):
        """Take ``rep`` out of the replica set (epoch bump) and collect
        everything it still owed: inbox, queued, mid-prefill,
        mid-decode, awaiting handoff.  Returns the requests to requeue
        and the new epoch; shared by the death path and the drain."""
        with self._lock:
            rep.alive = False
            self.epoch += 1
            epoch = self.epoch
            lost = list(rep.inbox)
            rep.inbox.clear()
            self.events.append(dict(detail, kind=event_kind,
                                    rid=rep.rid, epoch=epoch,
                                    t=self._now()))
            self._cond.notify_all()   # its worker thread must exit
        b = rep.batcher
        lost += list(b.queue)
        b.queue.clear()
        # slots the replica still holds: a per-replica pool dies with its
        # engine, but a shared pool outlives the replica, so every hold
        # is dropped or the survivors' leak sweep finds its blocks
        held_slots = (list(b.prefilling) + list(b.active)
                      + [slot for slot, _req in b.handoff_ready])
        lost += [st.req for st in b.prefilling.values()]
        b.prefilling.clear()
        lost += list(b.active.values())
        b.active.clear()
        lost += [req for _slot, req in b.handoff_ready]
        b.handoff_ready.clear()
        if rep.engine.cache_shared:
            for slot in held_slots:
                rep.engine.cache.free(slot)
            if rep.engine.prefix_cache is not None:
                rep.engine.prefix_cache.clear()
        return lost, epoch

    def _requeue_all(self, lost):
        for req in lost:
            # back to the prompt: greedy decoding reproduces the exact
            # stream on the new replica, so nothing is lost or doubled
            req.generated = []
            req.finish_reason = None
            req.first_token_t = None
            req.finish_t = None
            with self._lock:
                self.requeues += 1
            self.submit(req, _requeue=True)

    def _on_death(self, rep, exc):
        if not rep.alive:
            return
        lost, _epoch = self._evacuate(
            rep, "replica_dead",
            {"error": f"{type(exc).__name__}: {exc}"})
        if not self.live_replicas():
            raise MXNetError(
                f"router: last replica died ({exc}); "
                f"{len(lost)} request(s) unservable")
        if self.disaggregated and not any(
                r.role == rep.role for r in self.live_replicas()):
            raise MXNetError(
                f"router: last {rep.role}-role replica died ({exc}); "
                f"the disaggregated fleet cannot serve without one")
        self._requeue_all(lost)

    def drain_replica(self, rid, reason="admin"):
        """Graceful exit of a replica (preemption noticed, scaled away):
        epoch bump, everything it owed requeued to the survivors.
        Returns the number of requests requeued."""
        rep = self.replicas[rid]
        if not rep.alive:
            return 0
        if len(self.live_replicas()) <= 1:
            raise MXNetError(
                f"router: refusing to drain replica {rid} — it is the "
                f"last live replica (scale up or stop shedding first)")
        if self.disaggregated and sum(
                1 for r in self.live_replicas()
                if r.role == rep.role) <= 1:
            raise MXNetError(
                f"router: refusing to drain replica {rid} — it is the "
                f"last live {rep.role}-role replica (grow that pool "
                "first)")
        lost, _epoch = self._evacuate(rep, "replica_drained",
                                      {"reason": str(reason)})
        self._requeue_all(lost)
        return len(lost)

    def add_replica(self, role=None):
        """Grow the fleet by one replica from the stored factory (epoch
        bump; a worker thread is started when the fleet runs threaded).
        ``role`` picks a disaggregated pool ("prefill" | "decode");
        the default grows the smaller one.  A fleet that is not
        disaggregated refuses explicit roles.

        In threaded mode every worker is held at its next boundary while
        the newcomer is built and warmed: its warmup captures CUDA
        graphs, and a capture fails when another thread synchronizes
        with the device meanwhile."""
        if not self.disaggregated:
            if role not in (None, "combined"):
                raise MXNetError(
                    f"add_replica(role={role!r}) needs a disaggregated "
                    "router (role'd replicas share one KV pool)")
            role = "combined"
        elif role is None:
            live = self.live_replicas()
            n_pre = sum(1 for r in live if r.role == "prefill")
            n_dec = sum(1 for r in live if r.role == "decode")
            role = "prefill" if n_pre <= n_dec else "decode"
        elif role not in ("prefill", "decode"):
            raise MXNetError(
                f"add_replica role {role!r} must be prefill|decode on "
                "a disaggregated router")
        threaded = any(r.thread is not None for r in self.replicas)
        if threaded:
            with self._lock:
                self._paused += 1
                while self._busy:
                    self._cond.wait()
        try:
            eng = self._make_engine()
            eng.warmup()
        finally:
            if threaded:
                with self._lock:
                    self._paused -= 1
                    self._cond.notify_all()
        # self.replicas has one writer (the control loop that calls
        # add_replica) and append is atomic; concurrent readers take
        # list(self.replicas), so only the epoch and events need the lock
        rid = len(self.replicas)
        rep = Replica(rid, eng, self._make_batcher(eng, rid, role),
                      role=role)
        self.replicas.append(rep)
        with self._lock:
            self.epoch += 1
            self.events.append({"kind": "replica_added", "rid": rid,
                                "epoch": self.epoch, "role": role,
                                "t": self._now()})
        if threaded:
            t = threading.Thread(target=self._worker, args=(rep,),
                                 name=f"router-replica{rid}",
                                 daemon=True)
            rep.thread = t
            t.start()
        return rep

    # -- degradation / notices -------------------------------------------

    def set_shedding(self, on, reason=None):
        """While shedding, NEW submissions raise :class:`AdmissionShed`;
        requeues (drain and death evacuation) pass, so nothing in flight
        is lost.  Idempotent; returns the new state.  (``reason`` feeds
        the reference's telemetry event, which the port has not.)"""
        on = bool(on)
        with self._lock:
            self._shedding = on
        return on

    @property
    def shedding(self):
        with self._lock:
            return self._shedding

    def attach_notices(self, board):
        """The reference drains a replica when an ``elastic.NoticeBoard``
        names it; the notice board is not ported."""
        raise NotSupportedError(
            "Router.attach_notices is not ported yet: preemption notices "
            "(elastic.NoticeBoard) arrive with ROADMAP §1 item 11")

    # -- admission -------------------------------------------------------

    def _signals(self, rep):
        """``rep``'s load signals as it published them at its last
        boundary; read live before its first.  Unmeasured signals are
        ``None``: scoring drops a signal not measured on every candidate
        rather than let an unmeasured replica win on numbers nobody
        observed."""
        with self._lock:
            published = self._published.get(rep.rid)
            inbox_len = len(rep.inbox)
        if published is not None:
            return dict(published)
        return rep.load_signals(inbox_len)

    def _score(self, sig, use_ttft=True, use_kv=True):
        # queue depth dominates (each queued request is a whole
        # generation of latency); KV pressure breaks ties between equal
        # queues; TTFT drift demotes a replica that has been serving
        # slowly even when its queue momentarily clears
        s = 2.0 * sig["queue_depth"]
        if use_kv:
            s += 1.0 * sig["kv_block_utilization"]
        if use_ttft:
            s += 0.001 * sig["ttft_ms"]
        return s

    def submit(self, request, _requeue=False):
        """Admit ``request`` to the least-loaded live replica.  While
        shedding, new requests raise :class:`AdmissionShed` (requeues of
        in-flight work pass)."""
        if not _requeue:
            with self._lock:
                shedding = self._shedding
            if shedding:
                raise AdmissionShed(
                    "router is shedding new admissions (capacity below "
                    "the healthy target — degradation-ladder rung 1); "
                    "retry after capacity recovers")
        # decode-role replicas take work through block handoff, never
        # direct admission: a fresh prompt always needs a prefill
        live = [r for r in self.live_replicas() if r.role != "decode"]
        if not live:
            raise MXNetError("router: no live replicas that can admit")
        sigs = [self._signals(r) for r in live]
        use_ttft = all(s["ttft_ms"] is not None for s in sigs)
        use_kv = all(s["kv_block_utilization"] is not None for s in sigs)
        scored = [(self._score(s, use_ttft, use_kv), r.rid, r)
                  for s, r in zip(sigs, live)]
        scored.sort(key=lambda t: (t[0], t[1]))
        rep = scored[0][2]
        with self._lock:
            if not _requeue:
                self._submitted[request.id] = request
            self._assigned[request.id] = rep.rid
            rep.inbox.append(request)
            self._cond.notify_all()
        return request

    def _drain_inbox(self, rep):
        with self._lock:
            pending, rep.inbox = rep.inbox, []
        for req in pending:
            rep.batcher.submit(req)

    # -- driving ---------------------------------------------------------

    def _step_replica(self, rep):
        """One scheduling boundary on one replica (on its owner thread:
        its worker or ``drive()``'s caller), then its signals published for
        admission, as the reference publishes its gauges."""
        rep.boundaries += 1
        faults.fault_point(f"serving.replica{rep.rid}.step",
                           payload=rep.boundaries)
        self._drain_inbox(rep)
        n_fin = len(rep.batcher.finished)
        moved = rep.batcher.step()
        if rep.role == "prefill":
            moved += self._drain_handoffs(rep)
        for req in rep.batcher.finished[n_fin:]:
            t = req.ttft()
            if t is not None:
                rep.ttfts.append(t)
        with self._lock:
            sig = rep.load_signals(len(rep.inbox))
            published = self._published.setdefault(rep.rid,
                                                   {"ttft_ms": None})
            published["queue_depth"] = sig["queue_depth"]
            if sig["ttft_ms"] is not None:
                # absent until measured: admission reads None as "no
                # signal", never as a perfect 0.0
                published["ttft_ms"] = round(sig["ttft_ms"], 3)
            published["kv_block_utilization"] = round(
                sig["kv_block_utilization"], 4)
        return moved

    def _pick_decode(self):
        """The least-loaded live decode-role replica with a free batch
        slot, or None (the decode pool is saturated: the entry waits in
        the prefill outbox)."""
        cands = [r for r in self.live_replicas()
                 if r.role == "decode" and r.batcher._free_slots]
        if not cands:
            return None
        cands.sort(key=lambda r: (len(r.batcher.active), r.rid))
        return cands[0]

    def _drain_handoffs(self, rep):
        """Move ``rep``'s finished prefills to decode-role replicas:
        adopt, then release, over the shared pool's refcounts.  The fault
        point fires before any change, so a replica killed mid-handoff
        leaves the head entry wholly owned by its outbox, and the
        evacuation requeues it exactly once.  Entries the decode pool
        cannot take yet stay parked for the next boundary.

        The handoff is host bookkeeping only.  The decode replica's
        first replay reads blocks the prefill replica's graph wrote;
        ``drive()`` replays every replica's graphs on one thread and one
        stream, in this order, so the write lands first.  (Threaded
        disaggregated serving is refused: it would need an event between
        the two engines' streams.)"""
        b = rep.batcher
        moved = 0
        while b.handoff_ready:
            slot, req = b.handoff_ready[0]
            tgt = self._pick_decode()
            if tgt is None:
                break
            faults.fault_point(f"serving.replica{rep.rid}.handoff",
                               payload=req.id)
            t0 = time.perf_counter()
            cache = rep.engine.cache
            n = cache.seq_len(slot)
            cache.trim(slot, n)   # drop blocks past the prompt
            dst = tgt.batcher.adopt_handoff(req, cache.table(slot), n)
            if dst is None:
                break
            b.complete_handoff(slot)
            b.handoff_ready.popleft()
            ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self._assigned[req.id] = tgt.rid
                self.handoffs += 1
                self.handoff_ms.append(ms)
            moved += 1
        return moved

    def _replica_idle(self, rep):
        b = rep.batcher
        return not (rep.inbox or b.queue or b.active or b.prefilling
                    or b.handoff_ready)

    def drive(self, max_boundaries=100000):
        """Deterministic mode: step every live replica in turn until all
        submitted requests finish.  No sleeps, no threads."""
        boundaries = 0
        while not self.all_done():
            progressed = False
            for rep in list(self.replicas):
                if not rep.alive or self._replica_idle(rep):
                    continue
                try:
                    self._step_replica(rep)
                except Exception as e:  # noqa: BLE001 — death path
                    self._on_death(rep, e)
                progressed = True
                boundaries += 1
                if boundaries > max_boundaries:
                    raise MXNetError("router drive exceeded "
                                     "max_boundaries — fleet wedged")
            if not progressed and not self.all_done():
                raise MXNetError(
                    "router: no replica can make progress but "
                    "requests remain (pool too small for the mix?)")
        return boundaries

    # -- threaded mode ---------------------------------------------------

    def start(self):
        """Start one worker thread per replica.  Each worker owns its
        replica; it sleeps on the router's condition while idle (no
        polling)."""
        if self.disaggregated:
            raise NotSupportedError(
                "threaded disaggregated serving is not supported yet: "
                "the block handoff crosses two replicas' batchers, "
                "which breaks the one-owner-thread-per-replica "
                "discipline — use drive()")
        for rep in self.replicas:
            if rep.thread is not None:
                continue
            t = threading.Thread(target=self._worker, args=(rep,),
                                 name=f"router-replica{rep.rid}",
                                 daemon=True)
            rep.thread = t
            t.start()
        return self

    def _worker(self, rep):
        # the reference activates the trace context captured at start()
        # here; the port has no tracing yet (ROADMAP §1 item 11)
        self._worker_loop(rep)

    def _worker_loop(self, rep):
        while True:
            with self._lock:
                while (rep.alive and not self._stopping
                       and (self._paused or self._replica_idle(rep))):
                    self._cond.wait()
                if self._stopping or not rep.alive:
                    return
                self._busy += 1
            try:
                self._step_replica(rep)
            except Exception as e:  # noqa: BLE001 — death path
                self._on_death(rep, e)
                return
            finally:
                with self._lock:
                    self._busy -= 1
                    self._cond.notify_all()

    def stop(self):
        """Stop the workers after their current boundary."""
        with self._lock:
            self._stopping = True
            self._cond.notify_all()
        for rep in self.replicas:
            if rep.thread is not None:
                rep.thread.join(timeout=60)
                rep.thread = None
        with self._lock:
            self._stopping = False
        return self

    def wait_all_done(self, timeout=60.0):
        """Threaded mode: block until every submitted request finished
        (woken by the workers after each boundary)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                reqs = list(self._submitted.values())
                if all(r.done for r in reqs):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise MXNetError(
                        "router: requests still unfinished at timeout")
                self._cond.wait(remaining)

    # -- introspection ---------------------------------------------------

    def all_done(self):
        with self._lock:
            reqs = list(self._submitted.values())
        return all(r.done for r in reqs)

    def finished(self):
        """Every finished request across live and dead replicas (one
        that completed before its replica died stays completed)."""
        out = []
        for rep in self.replicas:
            out.extend(rep.batcher.finished)
        return out

    def manifest(self):
        """The fleet's shape: epoch, and each replica's liveness, role,
        engine configuration and mesh (the engine's one-device
        ``MeshConfig``, ``"dp1"``).  ``shared_compile_cache`` is 0: the
        port shares no compile cache."""
        with self._lock:
            epoch = self.epoch
        return {
            "epoch": epoch,
            "disaggregated": self.disaggregated,
            "replicas": [{
                "rid": r.rid,
                "alive": r.alive,
                "role": r.role,
                "cache_shared": r.engine.cache_shared,
                "mesh": r.engine.mesh_config.describe(),
                "max_batch": r.engine.max_batch,
                "block_size": r.engine.block_size,
                "max_context": r.engine.max_context,
                "buckets": list(r.engine.buckets),
                "quantized": r.engine.quantized,
                "prefill_chunk": r.engine.prefill_chunk,
                "prefix_cache": r.engine.prefix_cache is not None,
            } for r in self.replicas],
            "shared_compile_cache": 0,
            "warmup_compiles": self.warmup_compiles,
            "warmup_compiles_shared": self.warmup_compiles_shared,
        }

    def stats(self):
        fin = self.finished()
        lat = sorted(r.latency() for r in fin
                     if r.latency() is not None)

        def pct(p):
            if not lat:
                return None
            return lat[min(len(lat) - 1, int(round(p * (len(lat) - 1))))]

        per_replica = []
        total_caw = 0
        pool_occ = {"prefill": [], "decode": []}
        for r in self.replicas:
            occ = r.batcher.occupancy()
            total_caw += r.engine.stats["compiles_after_warmup"]
            if r.role in pool_occ and occ is not None:
                pool_occ[r.role].append(occ)
            per_replica.append({
                "rid": r.rid, "alive": r.alive, "role": r.role,
                "requests": len(r.batcher.finished),
                "boundaries": r.boundaries,
                "occupancy": round(occ, 4) if occ is not None else None,
                "prefix": (r.engine.prefix_cache.stats()
                           if r.engine.prefix_cache else None),
            })
        with self._lock:
            epoch, requeues = self.epoch, self.requeues
            shedding = self._shedding
            handoffs = self.handoffs

        def _pool(vals):
            # None, not 0.0, until a pool member measured something
            return round(sum(vals) / len(vals), 4) if vals else None

        return {"replicas": len(self.replicas),
                "live": len(self.live_replicas()),
                "epoch": epoch,
                "disaggregated": self.disaggregated,
                "requests": len(fin),
                "requeues": requeues,
                "handoffs": handoffs,
                "prefill_pool_occupancy": _pool(pool_occ["prefill"]),
                "decode_pool_occupancy": _pool(pool_occ["decode"]),
                "shedding": shedding,
                "p50_latency_s": pct(0.50), "p99_latency_s": pct(0.99),
                "compiles_after_warmup": total_caw,
                "per_replica": per_replica}
