"""The port's serving ``Router`` against the JAX package's, on the CPU.

The JAX net is initialised by the reference at its router tests' tiny
geometry; its ``decode_weights()`` cross into the port by
``mxnet_tpu_torch.convert``.  Both packages then serve the same requests
(a shared 12-token system prompt pinned on every replica, tails of 3-8
tokens, made from numpy seeds) through 2-replica routers at the
reference's engine configuration (``max_batch=3, block_size=8,
max_context=32, prefill_chunk=8, prefix_cache=True``).  Held exactly:
every greedy stream (against the JAX router's and a solo port
batcher's), the admissions (``_assigned``) and per-replica request
counts, the requeue counts, epochs and membership events of a death and
a drain, shedding, the signal rules, ``serving_block`` and the key sets
of ``stats()`` and ``manifest()``, and the loadgen's configuration and
counts at its smoke size.  Standing differences, asserted as such: no
compile cache is shared (``warmup_compiles_shared`` 0, each replica
captures its own steps).  The JAX routers run at their defaults (their
telemetry on, reset before each) with one module compile cache, built
in module fixtures so each test stays short.
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import telemetry
from mxnet_tpu.gluon.model_zoo.nlp.llama import (
    LlamaConfig as JaxConfig, LlamaForCausalLM as JaxLlama)
from mxnet_tpu.serving import (InferenceEngine as JaxEngine,
                               Request as JaxRequest, Router as JaxRouter,
                               serving_block as jax_serving_block)
from mxnet_tpu.testing import faults as jax_faults

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_llama_decode_weights
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                       LlamaForCausalLM)
from mxnet_tpu_torch.serving import (AdmissionShed, ContinuousBatcher,
                                     InferenceEngine, Request, Router,
                                     serving_block)
from mxnet_tpu_torch.testing import faults
from test_torch_port_amp import seeded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's weights are drawn under this seed of its global key
# (restored after), not under whatever key earlier tests left
SEED_REF = 26
GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=64, max_seq_len=64,
            tie_embeddings=True)
ENGINE = dict(max_batch=3, block_size=8, max_context=32, prefill_chunk=8,
              prefix_cache=True)
NEW = 4
_CC = {}          # one JAX compile cache for the module


def _prompts(seed, n, system=12):
    rng = np.random.RandomState(seed)
    sys_prompt = rng.randint(0, 64, (system,)).tolist()
    return sys_prompt, [sys_prompt + rng.randint(0, 64, (3 + i % 6,)).tolist()
                        for i in range(n)]


@pytest.fixture(scope="module")
def nets():
    jnet = JaxLlama(JaxConfig(**GEOM))
    with seeded(SEED_REF):
        jnet.initialize()
        jnet(mx.nd.array([[1, 2, 3]], dtype="int32"))
    jnet.hybridize()
    embed, norm, head, layers = jnet.decode_weights()
    weights = (np.asarray(embed), np.asarray(norm),
               None if head is None else np.asarray(head),
               [tuple(np.asarray(w) for w in layer) for layer in layers])
    pnet = LlamaForCausalLM(LlamaConfig(**GEOM), device="cpu")
    return jnet, load_llama_decode_weights(pnet, weights)


def _jax_router(jnet, replicas=2):
    telemetry.reset()     # the registry is process-wide: no stale gauges
    return JaxRouter(lambda _cc: JaxEngine(jnet, compile_cache=_CC,
                                           **ENGINE), replicas=replicas)


def _port_router(pnet, replicas=2):
    return Router(lambda cc: InferenceEngine(pnet, compile_cache=cc,
                                             device="cpu", **ENGINE),
                  replicas=replicas)


def _serve(router, prompts, request_cls, pin=None, fault=None,
           inject=None):
    """Pin ``pin`` on every replica, submit every prompt (ids 0..n-1),
    drive (under ``fault`` = (site, at) when given); the requests."""
    if pin is not None:
        for rep in router.replicas:
            assert rep.engine.pin_prefix(pin)
    reqs = [router.submit(request_cls(p, NEW, request_id=i))
            for i, p in enumerate(prompts)]
    if fault is None:
        router.drive()
    else:
        with inject(fault[0], at=fault[1]):
            router.drive()
    return reqs


def _summary(router, reqs):
    st = router.stats()
    return {"streams": [list(r.generated) for r in reqs],
            "assigned": dict(router._assigned),
            "requests": [p["requests"] for p in st["per_replica"]],
            "requeues": router.requeues, "epoch": router.epoch,
            "events": [(e["kind"], e["rid"], e["epoch"])
                       for e in router.events],
            "finished": sorted(r.id for r in router.finished()),
            "stats": st, "manifest": router.manifest()}


@pytest.fixture(scope="module")
def jax_runs(nets):
    """The JAX routers' runs (their compiles paid here): plain, a death
    of replica 1 at its second boundary, a drain and a join."""
    jnet, _ = nets
    out = {}
    sys_prompt, prompts = _prompts(11, 7)
    r = _jax_router(jnet)
    out["plain"] = _summary(r, _serve(r, prompts, JaxRequest, sys_prompt))
    r = _jax_router(jnet)
    out["death"] = _summary(r, _serve(
        r, prompts, JaxRequest, sys_prompt,
        ("serving.replica1.step", 2), jax_faults.inject))
    r = _jax_router(jnet, replicas=3)
    out["death3"] = _summary(r, _serve(
        r, _prompts(11, 12)[1], JaxRequest, sys_prompt,
        ("serving.replica1.step", 2), jax_faults.inject))
    _, prompts = _prompts(17, 4, system=0)
    r = _jax_router(jnet)
    reqs = [r.submit(JaxRequest(p, 3, request_id=i))
            for i, p in enumerate(prompts)]
    out["drained"] = r.drain_replica(1, reason="notice:test")
    out["added_rid"] = r.add_replica().rid
    r.drive()
    out["drain"] = _summary(r, reqs)
    return out


@pytest.fixture(scope="module")
def solo_streams(nets):
    """Each prompt of the death runs (the plain run's are the first 7)
    through one solo port batcher over a combined engine without a
    prefix cache."""
    _, pnet = nets
    _, prompts = _prompts(11, 12)
    eng = InferenceEngine(pnet, device="cpu", max_batch=3, block_size=8,
                          max_context=32, prefill_chunk=8).warmup()
    b = ContinuousBatcher(eng)
    reqs = [b.submit(Request(p, NEW)) for p in prompts]
    b.run()
    return [list(r.generated) for r in reqs]


def test_router_streams_and_admissions_match_jax_router(nets, jax_runs,
                                                        solo_streams):
    _, pnet = nets
    sys_prompt, prompts = _prompts(11, 7)
    r = _port_router(pnet)
    got = _summary(r, _serve(r, prompts, Request, sys_prompt))
    ref = jax_runs["plain"]
    assert got["streams"] == ref["streams"] == solo_streams[:7]
    # every request submitted before drive(): admission reads the live
    # signals, queue depth alternating the replicas
    assert got["assigned"] == ref["assigned"]
    assert got["requests"] == ref["requests"] == [4, 3]
    assert got["stats"]["compiles_after_warmup"] == 0
    assert got["stats"]["requeues"] == 0 and got["epoch"] == 0
    for key in ("p50_latency_s", "p99_latency_s"):
        assert got["stats"][key] > 0
    for rep in r.replicas:
        rep.engine.cache.check_leaks(
            holders=rep.engine.prefix_cache.held_blocks())


def test_router_death_requeues_like_the_jax_router(nets, jax_runs,
                                                   solo_streams):
    """Replica 1 dies at its second boundary: zero lost or duplicated,
    the solo streams, and the reference's requeues, epoch, events and
    final admissions (requeues read the signals the replicas published
    at their last boundary, as the reference reads its gauges)."""
    _, pnet = nets
    sys_prompt, prompts = _prompts(11, 7)
    r = _port_router(pnet)
    got = _summary(r, _serve(r, prompts, Request, sys_prompt,
                             ("serving.replica1.step", 2), faults.inject))
    ref = jax_runs["death"]
    assert got["finished"] == list(range(len(prompts)))
    assert got["streams"] == ref["streams"] == solo_streams[:7]
    for key in ("requeues", "epoch", "events", "assigned", "requests"):
        assert got[key] == ref[key], key
    assert got["requeues"] >= 1 and got["epoch"] == 1
    assert got["stats"]["live"] == 1
    assert got["stats"]["compiles_after_warmup"] == 0
    survivor = r.live_replicas()[0]
    assert survivor.engine.cache.check_leaks(
        holders=survivor.engine.prefix_cache.held_blocks())
    assert faults.active() == []


def test_requeues_follow_the_signals_published_at_boundaries(
        nets, jax_runs, solo_streams):
    """Three replicas, replica 1 killed at its second boundary: its 4
    requests are requeued to two survivors whose signals were published
    at their last boundary, and each goes where the reference sends it,
    8 and 4 (live reads would count each requeue as it lands: 6 and
    6)."""
    _, pnet = nets
    sys_prompt, prompts = _prompts(11, 12)
    r = _port_router(pnet, replicas=3)
    got = _summary(r, _serve(r, prompts, Request, sys_prompt,
                             ("serving.replica1.step", 2), faults.inject))
    ref = jax_runs["death3"]
    assert got["streams"] == ref["streams"] == solo_streams
    for key in ("requeues", "epoch", "events", "assigned", "requests",
                "finished"):
        assert got[key] == ref[key], key
    assert got["requeues"] == 4 and got["requests"] == [8, 0, 4]
    for rep in r.live_replicas():
        rep.engine.cache.check_leaks(
            holders=rep.engine.prefix_cache.held_blocks())


def test_router_drain_and_add_replica_match_jax(nets, jax_runs):
    _, pnet = nets
    _, prompts = _prompts(17, 4, system=0)
    r = _port_router(pnet)
    reqs = [r.submit(Request(p, 3, request_id=i))
            for i, p in enumerate(prompts)]
    moved = r.drain_replica(1, reason="notice:test")
    assert moved == jax_runs["drained"] and moved >= 1
    assert r.epoch == 1 and not r.replicas[1].alive
    rep = r.add_replica()
    assert rep.rid == jax_runs["added_rid"] == 2 and rep.alive
    assert rep.role == "combined" and r.epoch == 2
    r.drive()
    got, ref = _summary(r, reqs), jax_runs["drain"]
    for key in ("streams", "assigned", "requests", "requeues", "epoch",
                "events", "finished"):
        assert got[key] == ref[key], key
    assert len(r.finished()) == len(reqs)
    assert r.stats()["compiles_after_warmup"] == 0
    r.drain_replica(2, reason="autoscale")
    with pytest.raises(mt.MXNetError, match="last live replica"):
        r.drain_replica(0)
    with pytest.raises(mt.MXNetError, match="disaggregated"):
        r.add_replica(role="prefill")


def test_router_shedding_rejects_new_admissions_only(nets):
    _, pnet = nets
    rng = np.random.RandomState(19)
    r = _port_router(pnet)
    reqs = [r.submit(Request(rng.randint(0, 64, (5,)).tolist(), 2))
            for _ in range(2)]
    assert r.set_shedding(True, reason="test") is True and r.shedding
    with pytest.raises(AdmissionShed):
        r.submit(Request([1, 2, 3], 1))
    r.drain_replica(1, reason="notice:test")    # requeues pass
    r.drive()
    assert all(q.done for q in reqs)
    assert r.set_shedding(False) is False
    r3 = r.submit(Request([1, 2, 3], 1))
    r.drive()
    assert r3.done


def test_admission_unmeasured_ttft_is_no_signal_not_perfect(nets):
    """The reference's regression: replica 1 has the deeper queue and no
    measured TTFT or KV signal.  Scoring on queue depth alone sends the
    request to replica 0, in both packages."""
    jnet, pnet = nets
    r = _port_router(pnet)
    r._published[0] = {"queue_depth": 2, "ttft_ms": 3000.0,
                       "kv_block_utilization": 0.5}
    r._published[1] = {"queue_depth": 3, "ttft_ms": None,
                       "kv_block_utilization": None}
    req = r.submit(Request([1, 2, 3], 1))
    assert r._assigned[req.id] == 0
    sig = r._signals(r.replicas[1])
    assert sig["ttft_ms"] is None and sig["kv_block_utilization"] is None
    jr = _jax_router(jnet)
    telemetry.set_gauge("serving.replica0.queue_depth", 2)
    telemetry.set_gauge("serving.replica0.ttft_ms", 3000.0)
    telemetry.set_gauge("serving.replica0.kv_block_utilization", 0.5)
    telemetry.set_gauge("serving.replica1.queue_depth", 3)
    jreq = jr.submit(JaxRequest([1, 2, 3], 1))
    assert jr._assigned[jreq.id] == 0
    telemetry.reset()


def test_replica_ttft_signal_absent_until_measured(nets):
    """Before any finished request a replica's TTFT reads None, and an
    idle boundary publishes none; it appears once one was measured."""
    _, pnet = nets
    r = _port_router(pnet)
    rep = r.replicas[0]
    assert rep.load_signals()["ttft_ms"] is None
    r._step_replica(rep)                      # idle boundary publishes...
    assert r._signals(rep)["queue_depth"] == 0
    assert r._signals(rep)["ttft_ms"] is None  # ...no TTFT
    req = r.submit(Request(np.random.RandomState(23).randint(
        0, 64, (4,)).tolist(), 2))
    r.drive()
    rid = r._assigned[req.id]
    assert r._signals(r.replicas[rid])["ttft_ms"] is not None


def test_threaded_mode_with_add_replica_gives_drive_streams(nets,
                                                            solo_streams):
    """start(), an add_replica() while the workers run (the workers are
    held while the newcomer warms up), wait_all_done(): every stream is
    drive()'s; the workers exit at stop()."""
    _, pnet = nets
    sys_prompt, prompts = _prompts(11, 7)
    r = _port_router(pnet)
    for rep in r.replicas:
        assert rep.engine.pin_prefix(sys_prompt)
    r.start()
    try:
        reqs = [r.submit(Request(p, NEW)) for p in prompts]
        rep = r.add_replica()
        assert rep.thread is not None
        more = [r.submit(Request(p, NEW)) for p in prompts[:3]]
        assert r.wait_all_done(timeout=60)
    finally:
        r.stop()
    assert all(rep.thread is None for rep in r.replicas)
    assert r._busy == 0 and r._paused == 0
    assert [q.generated for q in reqs] == solo_streams[:7]
    assert [q.generated for q in more] == solo_streams[:3]
    assert len(r.finished()) == len(prompts) + 3 and r.epoch == 1
    assert r.stats()["compiles_after_warmup"] == 0


def test_stats_and_manifest_key_sets_match_jax(nets, jax_runs):
    """Every key of the reference's ``stats()`` and ``manifest()``; the
    compile-cache fields hold the standing difference (no shared cache:
    each replica captured its own steps)."""
    _, pnet = nets
    r = _port_router(pnet)
    st, man = r.stats(), r.manifest()
    ref_st = jax_runs["plain"]["stats"]
    ref_man = jax_runs["plain"]["manifest"]
    assert set(st) == set(ref_st)
    assert set(st["per_replica"][0]) == set(ref_st["per_replica"][0])
    assert set(man) == set(ref_man)
    assert set(man["replicas"][0]) == set(ref_man["replicas"][0])
    for rep, ref in zip(man["replicas"], ref_man["replicas"]):
        assert rep == ref       # mesh "dp1", buckets, chunk, roles ...
    assert man["shared_compile_cache"] == 0
    assert man["warmup_compiles_shared"] == 0
    assert man["warmup_compiles"] == r.replicas[0].engine.stats["compiles"]
    assert all(rep.engine.stats["compiles"] == man["warmup_compiles"]
               for rep in r.replicas)
    with pytest.raises(mt.NotSupportedError, match="item 11"):
        r.attach_notices(object())


@pytest.mark.parametrize("kwargs", [
    {},
    dict(max_batch=8, block_size=16, buckets=(16, 32, 64),
         requests=12, p50_ms=12.34567, p99_ms=20.0, ttft_p50_ms=3.21,
         tokens_s=1234.56, tokens_s_chip=617.28, occupancy=0.123456,
         compiles_after_warmup=0, chunked_prefill=True,
         router_replicas=2, prefix_hit_rate=0.916666, router_p99_ms=20.0),
    dict(disaggregated=True, router_replicas=4, handoff_ms=0.0123456,
         prefill_pool_occupancy=0.25, decode_pool_occupancy=0.333333,
         kv_dtype=None, speculative=True, paged_attn=True,
         spec_accept_rate=0.5, tokens_per_dispatch=1.23456),
    dict(kv_dtype="fp8", kv_capacity_ratio=3.9411, kv_decode_drift=0.0123,
         quantized=True, continuous=False, tp_shards=2,
         cache_utilization=0.77777)],
    ids=["defaults", "router", "disagg", "fp8"])
def test_serving_block_matches_jax(kwargs):
    assert serving_block(**kwargs) == jax_serving_block(**kwargs)


@pytest.fixture(scope="module")
def loadgens():
    """The reference's fleet benchmark at its smoke size, combined and
    disaggregated (its compiles paid here), and the port's."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import port_serve_loadgen
        import serve_loadgen
    finally:
        sys.path.pop(0)
    out = {}
    for dis, reps in ((False, 2), (True, 4)):
        telemetry.reset()
        out[dis] = (serve_loadgen.run_router_loadgen(
                        smoke=True, replicas=reps, disaggregated=dis),
                    port_serve_loadgen.run_router_loadgen(
                        smoke=True, replicas=reps, disaggregated=dis,
                        device="cpu"))
    return out, port_serve_loadgen


# the walls' fields, and the compile-cache difference
_TIMED = {"p50_ms", "p99_ms", "tokens_s", "tokens_s_chip", "router_p99_ms",
          "handoff_ms"}


@pytest.mark.parametrize("disagg", [False, True], ids=["combined",
                                                       "disagg"])
def test_loadgen_config_and_counts_match_jax(loadgens, disagg):
    runs, _ = loadgens
    ref, got = runs[disagg]
    assert set(got) == set(ref) and set(got["serving"]) == set(
        ref["serving"])
    for key, value in ref["serving"].items():
        if key in _TIMED:
            assert (got["serving"][key] is None) == (value is None), key
        elif key == "paged_attn":
            # the port decodes only through the paged kernel
            assert value is False and got["serving"][key] is True
        else:
            assert got["serving"][key] == value, key
    for key, value in ref["router"].items():
        if key == "warmup_compiles_shared":
            assert value > 0 and got["router"][key] == 0
        else:
            assert got["router"][key] == value, key
    assert got["serving"]["compiles_after_warmup"] == 0
    assert got["router"]["handoffs"] == (12 if disagg else 0)


@pytest.mark.parametrize("disagg", [False, True], ids=["combined",
                                                       "disagg"])
def test_loadgen_rates_the_fleet_on_one_card(loadgens, disagg):
    """Every replica shares one card, so the per-chip rate is the
    fleet's rate (the reference divides by its replicas, one chip
    each); the reference's rate per chip is its fleet rate over 2 or 4."""
    runs, _ = loadgens
    ref, got = runs[disagg]
    assert got["serving"]["tokens_s_chip"] == got["serving"]["tokens_s"]
    reps = ref["serving"]["router_replicas"]
    assert reps == (4 if disagg else 2)
    assert ref["serving"]["tokens_s_chip"] == pytest.approx(
        ref["serving"]["tokens_s"] / reps, abs=0.1)


@pytest.mark.parametrize("at,times,payloads", [
    (1, None, [None] * 3), (3, None, [None] * 5), (2, 2, [None] * 5),
    (3, None, [1, 2, 3, 4, 2]), (5, 1, [4, 5, 6, 7]), (2, None, [9, 9])],
    ids=["every", "from_third", "twice", "payload", "payload_once",
         "payload_hits"])
def test_fault_points_fire_as_the_reference(at, times, payloads):
    """``inject``/``fault_point`` fire on the same hits as the
    reference's (hit counts, integer payloads against ``at``, ``times``),
    raise ``FaultInjected``, run actions and disarm on exit."""
    def trace(mod):
        out = []
        with mod.inject("serving.replica0.step", at=at, times=times) as f:
            for p in payloads:
                try:
                    out.append(mod.fault_point("serving.replica0.step",
                                               payload=p))
                except mod.FaultInjected:
                    out.append("raised")
            out.append((f.hits, f.fired, mod.active()))
        with mod.inject("x.drop", action=lambda p: "drop", at=at,
                        times=times), \
                mod.inject("x.act", action=lambda p: ("ran", p)):
            out += [mod.fault_point("x.drop", payload=p) for p in payloads]
            out.append(mod.fault_point("x.act", payload=7))
        return out + [mod.active(), mod.fault_point("x.drop")]
    assert trace(faults) == trace(jax_faults)


def test_fault_helpers_match_the_reference():
    """``FakeClock`` and ``reset`` against the reference's; the
    reference's drop and preemption actions and file helpers are item 11
    and raise or are absent."""
    clocks = [faults.FakeClock(5.0), jax_faults.FakeClock(5.0)]
    assert [(c(), c.advance(1.5), c()) for c in clocks] == [(5.0, 6.5,
                                                             6.5)] * 2
    with faults.inject("train.step", at=3):
        assert faults.active() == ["train.step"]
        faults.reset()
        assert faults.active() == []
        assert faults.fault_point("train.step", payload=5) is None
    for action in ("drop", "preempt"):
        with pytest.raises(mt.NotSupportedError, match="item 11"):
            with faults.inject("train.step", action=action):
                pass
    assert faults.active() == []
    for name in ("preempt_action", "truncate_file", "corrupt_file"):
        assert hasattr(jax_faults, name) and not hasattr(faults, name)
