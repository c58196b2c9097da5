"""Disaggregated prefill/decode serving in the port against the JAX
package, on the CPU.

One shared ``PagedKVCache`` behind prefill-role and decode-role
replicas: a prefill replica fills a request's blocks, then a decode
replica adopts them through the refcounts (adopt, then release), and
every protocol violation raises the typed ``HandoffError``.  The net and
engine geometry are the reference's disaggregation tests' (vocabulary
64, hidden 32, 2 layers; ``max_batch=2, block_size=8, num_blocks=32,
max_context=32``); the JAX net's ``decode_weights()`` cross into the
port by ``mxnet_tpu_torch.convert``, and both packages serve the same
prompts (numpy seeds).  Held exactly: the streams (against a solo
combined engine's and the JAX fleet's), the roles, the handoff and
requeue counts, the epochs and membership events, the pool occupancies
and the leak sweep of the shared pool, for a plain fleet and for the
reference's two chaos kills (a prefill replica killed mid-handoff, a
decode replica at a boundary).  The JAX fleets run at their defaults
with one module compile cache, in module fixtures.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import telemetry
from mxnet_tpu.gluon.model_zoo.nlp.llama import (
    LlamaConfig as JaxConfig, LlamaForCausalLM as JaxLlama)
from mxnet_tpu.serving import (InferenceEngine as JaxEngine,
                               Request as JaxRequest, Router as JaxRouter)
from mxnet_tpu.testing import faults as jax_faults

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_llama_decode_weights
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                       LlamaForCausalLM)
from mxnet_tpu_torch.serving import (ContinuousBatcher, HandoffError,
                                     InferenceEngine, Request, Router)
from mxnet_tpu_torch.testing import faults
from test_torch_port_amp import seeded

# the reference's weights are drawn under this seed of its global key
# (restored after), not under whatever key earlier tests left
SEED_REF = 26
GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=64, max_seq_len=64,
            tie_embeddings=True)
ENGINE = dict(max_batch=2, block_size=8, num_blocks=32, max_context=32)
NEW = 4
_CC = {}          # one JAX compile cache for the module
# (name, replicas, prompts' seed, requests, fault site or None, at)
RUNS = [("plain", 2, 0, 7, None, 0),
        ("prefill_killed_mid_handoff", 4, 18, 6, "serving.replica0.handoff",
         2),
        ("decode_killed_at_boundary", 4, 18, 6, "serving.replica1.step", 3)]


def _prompts(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, (3 + i % 5,)).tolist() for i in range(n)]


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


def _port_factory(pnet, **kw):
    def factory(compile_cache, kv_cache=None):
        return InferenceEngine(pnet, compile_cache=compile_cache,
                               kv_cache=kv_cache, device="cpu",
                               **dict(ENGINE, **kw))
    return factory


def _solo(pnet, prompts):
    """The combined-role streams: one solo port batcher."""
    b = ContinuousBatcher(_port_factory(pnet)(None).warmup())
    reqs = [b.submit(Request(p, NEW)) for p in prompts]
    b.run()
    return [list(r.generated) for r in reqs]


def _run(router, prompts, request_cls, inject, site, at):
    reqs = [router.submit(request_cls(p, NEW, request_id=i))
            for i, p in enumerate(prompts)]
    if site is None:
        router.drive()
    else:
        with inject(site, at=at):
            router.drive()
    st = router.stats()
    return {"streams": [list(r.generated) for r in reqs],
            "finished": sorted(r.id for r in router.finished()),
            "handoffs": router.handoffs, "requeues": router.requeues,
            "epoch": router.epoch, "assigned": dict(router._assigned),
            "events": [(e["kind"], e["rid"], e["epoch"])
                       for e in router.events],
            "roles": [r.role for r in router.replicas],
            "requests": [p["requests"] for p in st["per_replica"]],
            "pools": (st["prefill_pool_occupancy"],
                      st["decode_pool_occupancy"]),
            "compiles_after_warmup": st["compiles_after_warmup"]}


@pytest.fixture(scope="module")
def jax_fleets(nets):
    """Each run of RUNS through a JAX disaggregated fleet (its compiles
    paid here)."""
    jnet, _ = nets
    out = {}
    for name, replicas, seed, n, site, at in RUNS:
        telemetry.reset()
        router = JaxRouter(
            lambda _cc, kv_cache=None: JaxEngine(
                jnet, compile_cache=_CC, kv_cache=kv_cache, **ENGINE),
            replicas=replicas, disaggregated=True)
        out[name] = _run(router, _prompts(seed, n), JaxRequest,
                         jax_faults.inject, site, at)
        router._shared_cache.check_leaks(holders=0)
    return out


@pytest.fixture(scope="module")
def fleet(nets):
    """The port's plain 2-replica run, shared by the read-only tests."""
    _, pnet = nets
    router = Router(_port_factory(pnet), replicas=2, disaggregated=True)
    got = _run(router, _prompts(0, 7), Request, faults.inject, None, 0)
    return router, got


@pytest.mark.parametrize("run", RUNS, ids=[r[0] for r in RUNS])
def test_disagg_runs_match_solo_and_jax_fleet(nets, jax_fleets, run):
    """Streams bitwise the solo combined engine's, nothing lost or
    duplicated, the shared pool leak-clean, and the JAX fleet's
    handoffs, requeues, epochs, events, admissions and occupancies."""
    _, pnet = nets
    name, replicas, seed, n, site, at = run
    prompts = _prompts(seed, n)
    router = Router(_port_factory(pnet), replicas=replicas,
                    disaggregated=True)
    got = _run(router, prompts, Request, faults.inject, site, at)
    ref = jax_fleets[name]
    assert got["streams"] == ref["streams"] == _solo(pnet, prompts)
    assert got["finished"] == list(range(n))
    for key in ("handoffs", "requeues", "epoch", "events", "assigned",
                "roles", "requests", "pools"):
        assert got[key] == ref[key], key
    assert got["compiles_after_warmup"] == 0
    if site is None:
        assert got["handoffs"] == n and got["requeues"] == 0
    else:
        assert got["requeues"] >= 1 and got["handoffs"] >= 1
        assert got["epoch"] == 1
    router._shared_cache.check_leaks(holders=0)
    assert faults.active() == []


def test_disagg_roles_and_shared_pool_in_manifest(fleet):
    router, _ = fleet
    man = router.manifest()
    assert man["disaggregated"] is True
    assert {r["rid"]: r["role"] for r in man["replicas"]} == \
        {0: "prefill", 1: "decode"}
    assert all(r["cache_shared"] for r in man["replicas"])
    assert len({id(rep.engine.cache) for rep in router.replicas}) == 1
    st = router.stats()
    assert 0.0 < st["prefill_pool_occupancy"] <= 1.0
    assert 0.0 < st["decode_pool_occupancy"] <= 1.0


def test_disagg_decode_replicas_never_admit(fleet):
    router, got = fleet
    prefill_rep, decode_rep = router.replicas
    assert not decode_rep.batcher.queue
    assert len(decode_rep.batcher.finished) == 7
    assert not prefill_rep.batcher.finished
    assert not prefill_rep.batcher.handoff_ready
    assert set(got["assigned"].values()) == {1}
    with pytest.raises(mt.NotSupportedError):
        router.start()


def test_handoff_protocol_violations_are_typed(nets):
    """Every way to break adopt-then-release raises HandoffError."""
    _, pnet = nets
    eng = _port_factory(pnet)(None).warmup()
    b = ContinuousBatcher(eng, role="combined")
    with pytest.raises(HandoffError):
        b.adopt_handoff(Request([1, 2], 2), [0], 2)
    # release before adopt: the prefill side may not drop its hold until
    # the decode side holds every block (refcount >= 2)
    pre = ContinuousBatcher(eng, slot_ns=0, role="prefill")
    pre.submit(Request([1, 2, 3], max_new_tokens=4))
    pre.step()
    assert pre.handoff_ready
    slot, _req = pre.handoff_ready[0]
    assert slot == (0, 0)
    with pytest.raises(HandoffError):
        pre.complete_handoff(slot)
    eng.release(slot)
    pre.handoff_ready.clear()
    eng.cache.check_leaks(holders=0)
    with pytest.raises(mt.MXNetError, match="combined-role"):
        pre.run()
    with pytest.raises(mt.MXNetError, match="combined|prefill|decode"):
        ContinuousBatcher(eng, role="router")


def test_disagg_factory_must_share_pool(nets):
    _, pnet = nets
    factory = _port_factory(pnet)
    with pytest.raises(HandoffError):
        Router(lambda cc, kv_cache=None: factory(cc, kv_cache=None),
               replicas=2, disaggregated=True)
    with pytest.raises(mt.MXNetError, match=">= 2 replicas"):
        Router(factory, replicas=1, disaggregated=True)


def test_disagg_roundrobin_roles_and_pool_scaling(nets):
    """Even rids prefill, odd rids decode; add_replica(role=...) grows the
    named pool and a bare add_replica the smaller one; the last replica
    of a role never drains."""
    _, pnet = nets
    router = Router(_port_factory(pnet), replicas=2, disaggregated=True)
    with pytest.raises(mt.MXNetError, match="last live decode-role"):
        router.drain_replica(1)
    assert router.add_replica(role="decode").role == "decode"
    assert router.add_replica().role == "prefill"
    with pytest.raises(mt.MXNetError, match="prefill|decode"):
        router.add_replica(role="combined")
    assert [r.role for r in router.replicas] == \
        ["prefill", "decode", "decode", "prefill"]
    assert router.epoch == 2
    reqs = [router.submit(Request(p, NEW)) for p in _prompts(0, 7)]
    router.drive()
    assert all(r.done for r in reqs)
    router._shared_cache.check_leaks(holders=0)


def test_disagg_composes_with_spec_decode(nets):
    """Speculative decode replicas: the streams stay the plain solo
    engine's."""
    _, pnet = nets
    prompts = _prompts(4, 5)
    router = Router(_port_factory(pnet, spec_decode=True, spec_k=2),
                    replicas=2, disaggregated=True)
    reqs = [router.submit(Request(p, NEW)) for p in prompts]
    router.drive()
    assert [list(r.generated) for r in reqs] == _solo(pnet, prompts)
    assert router.stats()["compiles_after_warmup"] == 0
    router._shared_cache.check_leaks(holders=0)


def test_engine_adopts_a_pool_of_its_geometry_only(nets):
    _, pnet = nets
    owner = _port_factory(pnet)(None)
    assert owner.cache_shared is False
    guest = _port_factory(pnet)(None, kv_cache=owner.cache)
    assert guest.cache is owner.cache and guest.cache_shared is True
    with pytest.raises(mt.MXNetError, match="geometry mismatch"):
        _port_factory(pnet, block_size=16)(None, kv_cache=owner.cache)
    with pytest.raises(mt.MXNetError, match="geometry mismatch"):
        _port_factory(pnet, kv_dtype="fp8")(None, kv_cache=owner.cache)


def test_two_engines_over_one_pool_pin_the_same_prompt(nets):
    """Each engine's pin slot carries its own id: two engines over one
    pool pin the same prompt without colliding, and each adopts its own
    chain."""
    _, pnet = nets
    a = _port_factory(pnet, prefill_chunk=8, prefix_cache=True)(None)
    b = _port_factory(pnet, prefill_chunk=8, prefix_cache=True)(
        None, kv_cache=a.cache)
    a.warmup()
    b.warmup()
    prompt = list(range(1, 12))
    assert a.pin_prefix(prompt) and b.pin_prefix(prompt)
    held = a.prefix_cache.held_blocks() + b.prefix_cache.held_blocks()
    assert held == 4 and a.cache.blocks_in_use == 4
    assert a.attach_prefix("x", prompt + [5]) == len(prompt)
    assert b.attach_prefix("y", prompt + [5]) == len(prompt)
    assert a.cache.table("x") != b.cache.table("y")
    a.release("x")
    b.release("y")
    a.cache.check_leaks(holders=held)
