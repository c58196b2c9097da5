#!/usr/bin/env python3
"""Fleet load generator over the port: a shared-system-prompt request
mix through ``mxnet_tpu_torch.serving.Router``.

    python3 tools/port_serve_loadgen.py --smoke --device cpu
    python3 tools/port_serve_loadgen.py --smoke --disagg --replicas 4
    python3 tools/port_serve_loadgen.py --replicas 2      # on the card

Counterpart of ``run_router_loadgen`` in ``tools/serve_loadgen.py``:
the same net sizes (``--smoke``: vocabulary 128, hidden 64, 2 layers;
else vocabulary 32000, hidden 1024, 8 layers), the same traffic (a
pinned 12-token system prompt, user tails cycling through
``_USER_MIX``, generation budgets through ``_NEW_MIX``, every request
submitted before ``drive()``), the same engines (``prefill_chunk`` of 2
blocks, ``prefix_cache=True``, one pool of ``1 + replicas * (max_batch
+ 1) * max_context / block_size`` blocks shared by a disaggregated
fleet) and the same payload, its ``serving`` block through the port's
``serving_block``.  The weights are random, drawn from ``--seed`` on
the device; the mix does not depend on them (no EOS), so the counts
(requests, prefix hits, computed prompt tokens, per-replica requests
and occupancy, handoffs) equal the reference's at the same arguments.

Differences: ``warmup_compiles_shared`` is 0 (each replica captures its
own graphs); ``handoff_ms`` is the mean of this router's handoffs (the
reference reads the mean of its process-wide telemetry histogram);
``tokens_s_chip`` equals ``tokens_s``, because every replica shares one
card (the reference's replicas are separate chips, so it divides by
the replica count); ``paged_attn`` is true, because the port's only
decode path is the paged kernel; there is no ``--tp`` (tensor-parallel
serving is ROADMAP §1 item 10); the reference's single-engine
continuous-versus-static mode (``run_loadgen``) is not ported.  On the card the times (tokens/s,
latency percentiles) are host-clock walls around work that ends in a
device synchronization, and the card's name and power limit are printed
before the JSON payload; without a card only ``--device cpu`` runs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the reference's mixes (tools/serve_loadgen.py)
_NEW_MIX = (4, 12, 6, 16, 3, 9)
_SYS_PROMPT_LEN = 12
_USER_MIX = (5, 9, 3, 7, 4, 11)


def _build_net(smoke, device, seed):
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (
        LlamaConfig, LlamaForCausalLM)
    if smoke:
        cfg = LlamaConfig(vocab_size=128, hidden_size=64, num_layers=2,
                          num_heads=4, num_kv_heads=2,
                          intermediate_size=128, max_seq_len=128,
                          tie_embeddings=True)
    else:
        cfg = LlamaConfig(vocab_size=32000, hidden_size=1024,
                          num_layers=8, num_heads=16, num_kv_heads=8,
                          intermediate_size=2816, max_seq_len=1024)
    return LlamaForCausalLM(cfg, device=device, seed=seed), cfg


def _buckets(bs, mc):
    out = []
    b = bs
    while b <= mc:
        out.append(b)
        b *= 2
    return out


def _ms(s):
    return None if s is None else s * 1e3


def _kv_capacity_ratio(cfg, kv_dtype, block_size):
    """Blocks an equal byte budget holds under ``kv_dtype`` against f32
    (the budget: 256 f32 blocks of this geometry), pool arithmetic."""
    from mxnet_tpu_torch.ops.quant_kv import (kv_block_bytes,
                                              kv_blocks_in_budget)
    if kv_dtype is None:
        return None
    geom = dict(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, block_size=block_size)
    budget = 256 * kv_block_bytes(**geom)
    f32 = kv_blocks_in_budget(budget, **geom)
    lowp = kv_blocks_in_budget(budget, kv_dtype=kv_dtype, **geom)
    return round(lowp / f32, 3) if f32 else None


def _kv_decode_drift(net, cfg, kv_dtype, block_size, max_context, seed,
                     device):
    """Largest |logit| difference of a short greedy decode under the
    low-precision pool against an f32 pool, on the same weights and
    prompt (two one-slot engines)."""
    import numpy as np
    from mxnet_tpu_torch.serving import InferenceEngine
    rng = np.random.RandomState(seed + 7)
    prompt = rng.randint(0, cfg.vocab_size, (9,)).tolist()
    per_mode = []
    for kd in ("fp32", kv_dtype):
        eng = InferenceEngine(net, max_batch=1, block_size=block_size,
                              max_context=max_context, kv_dtype=kd,
                              device=device)
        tok, _ = eng.prefill(0, prompt)
        cur = list(prompt) + [int(tok)]
        rows = []
        for _ in range(4):
            pos = len(cur) - 1
            if not eng.reserve(0, pos):
                raise RuntimeError("KV pool exhausted")
            nxt, lg = eng.decode([(0, cur[-1], pos)])
            rows.append(lg[0].float().cpu().numpy())
            cur.append(int(nxt[0]))
        eng.release(0)
        per_mode.append(rows)
    return max(float(np.max(np.abs(a - b)))
               for a, b in zip(*per_mode))


def run_router_loadgen(n_requests=12, max_batch=4, block_size=8,
                       max_context=64, smoke=True, replicas=2, seed=0,
                       disaggregated=False, kv_dtype=None,
                       device=None):
    """The reference's fleet benchmark over the port: the shared-system-
    prompt mix through ``replicas`` engine replicas behind one Router
    (prefix cache and chunked prefill on, deterministic ``drive()``).
    Returns the payload: ``serving`` (``serving_block``) and ``router``
    (epoch, requeues, handoffs, prompt tokens computed, prefix-hit
    tokens, per-replica requests and occupancy)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.context import resolve_device
    from mxnet_tpu_torch.ops.quant_kv import resolve_kv_dtype
    from mxnet_tpu_torch.serving import (InferenceEngine, Request, Router,
                                         serving_block)
    device = resolve_device(device)
    kv_dtype = resolve_kv_dtype(kv_dtype)
    net, cfg = _build_net(smoke, device, seed)
    rng = np.random.RandomState(seed)
    sys_prompt = rng.randint(0, cfg.vocab_size,
                             (_SYS_PROMPT_LEN,)).tolist()
    # a disaggregated fleet shares ONE pool across every replica's slots
    # (and the prefix pins), so its creator sizes it for the fleet
    num_blocks = (1 + replicas * (max_batch + 1)
                  * (max_context // block_size)
                  if disaggregated else None)

    def factory(compile_cache, kv_cache=None):
        return InferenceEngine(net, max_batch=max_batch,
                               block_size=block_size,
                               max_context=max_context,
                               num_blocks=num_blocks,
                               prefill_chunk=2 * block_size,
                               prefix_cache=True,
                               compile_cache=compile_cache,
                               kv_cache=kv_cache,
                               kv_dtype=kv_dtype or "fp32", device=device)

    router = Router(factory, replicas=replicas,
                    disaggregated=disaggregated)
    for rep in router.replicas:
        if rep.role != "decode":   # decode-role replicas never prefill
            rep.engine.pin_prefix(sys_prompt)
    reqs = []
    for i in range(n_requests):
        user = rng.randint(0, cfg.vocab_size,
                           (_USER_MIX[i % len(_USER_MIX)],)).tolist()
        reqs.append(Request(sys_prompt + user,
                            _NEW_MIX[i % len(_NEW_MIX)]))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for req in reqs:
        router.submit(req)
    router.drive()
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    st = router.stats()
    tokens = sum(len(r.generated) for r in router.finished())
    prefix_hits = prefix_lookups = hit_tokens = computed = 0
    for rep in router.replicas:
        pc = rep.engine.prefix_cache
        prefix_hits += pc.hits
        prefix_lookups += pc.lookups
        hit_tokens += pc.hit_tokens
        computed += rep.engine.stats["prompt_tokens_computed"]
    hit_rate = prefix_hits / prefix_lookups if prefix_lookups else None
    drift = (None if kv_dtype is None else
             _kv_decode_drift(net, cfg, kv_dtype, block_size,
                              max_context, seed, device))
    occ = [r["occupancy"] for r in st["per_replica"]
           if r["occupancy"] is not None]
    blk = serving_block(
        max_batch=max_batch, block_size=block_size,
        buckets=_buckets(block_size, max_context),
        continuous=True, requests=st["requests"],
        p50_ms=_ms(st["p50_latency_s"]), p99_ms=_ms(st["p99_latency_s"]),
        tokens_s=(round(tokens / wall, 1) if wall > 0 else None),
        tokens_s_chip=(round(tokens / wall, 1)       # one card
                       if wall > 0 else None),
        occupancy=(sum(occ) / len(occ) if occ else None),
        compiles_after_warmup=st["compiles_after_warmup"],
        chunked_prefill=True, router_replicas=replicas, paged_attn=True,
        prefix_hit_rate=hit_rate, router_p99_ms=_ms(st["p99_latency_s"]),
        tp_shards=0, disaggregated=bool(st["disaggregated"]),
        handoff_ms=(sum(router.handoff_ms) / len(router.handoff_ms)
                    if router.handoff_ms else None),
        prefill_pool_occupancy=st["prefill_pool_occupancy"],
        decode_pool_occupancy=st["decode_pool_occupancy"],
        kv_dtype=kv_dtype or "fp32",
        kv_capacity_ratio=_kv_capacity_ratio(cfg, kv_dtype, block_size),
        kv_decode_drift=drift)
    return {"metric": "serve_loadgen", "mode": "router",
            "smoke": bool(smoke), "serving": blk,
            "router": {
                "epoch": st["epoch"], "requeues": st["requeues"],
                "handoffs": st["handoffs"],
                "prompt_tokens_computed": computed,
                "prefix_hit_tokens": hit_tokens,
                "warmup_compiles_shared": router.warmup_compiles_shared,
                "per_replica": [
                    {"rid": r["rid"], "role": r["role"],
                     "requests": r["requests"],
                     "occupancy": r["occupancy"]}
                    for r in st["per_replica"]],
            }}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's tiny net and short mix")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--max-context", type=int, default=None)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--disagg", action="store_true",
                    help="prefill and decode pools over one shared KV "
                         "pool (implies --replicas >= 2)")
    ap.add_argument("--kv-dtype", choices=("fp32", "bf16", "fp8"),
                    default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    smoke = args.smoke
    replicas = max(args.replicas, 2) if args.disagg else args.replicas
    n = args.requests if args.requests is not None else (12 if smoke
                                                         else 64)
    payload = run_router_loadgen(
        n_requests=n, max_batch=args.max_batch,
        block_size=args.block_size or (8 if smoke else 16),
        max_context=args.max_context or (64 if smoke else 512),
        smoke=smoke, replicas=replicas, seed=args.seed,
        disaggregated=args.disagg, kv_dtype=args.kv_dtype,
        device=args.device)
    import torch
    if torch.device(args.device or "cuda").type == "cuda":
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
    print(json.dumps(payload), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
