#!/usr/bin/env python3
"""Where the time goes in the port's serving path on one NVIDIA GPU.

Builds Llama-3-8B (random weights from ``--seed``, bfloat16, full width;
``--layers`` cuts depth) with ``mxnet_tpu_torch``'s ``InferenceEngine``
(block_size 16; ``--max-batch`` 8, ``--max-context`` 1024 and the KV
storage ``--kv-dtype`` by default the model's), whose ``warmup()``
captures every bucket's prefill and decode as CUDA graphs, fills the
batch with prompts of ``--prompt`` tokens, then profiles the graph
replays with ``torch.profiler``:

- one prefill of a ``--prompt``-token prompt;
- ``--steps`` decode steps of the full batch.

Each window runs twice: once on the host clock alone, then under the
profiler.

For each window it prints the traced run's wall time, its device time
summed over kernels and its idle share (1 - busy / wall), the kernels
that ran (inside the graphs, as the profiler records them) and the
kernels with the most device time, as one JSON line.  CUPTI's tracing
slows the graph replays, so it also prints the untraced run's wall and
an idle-share estimate that divides the traced run's busy time by it:
two runs mixed, which holds only as far as tracing leaves the kernels'
own durations unchanged.  With ``--trace-dir`` the
Chrome traces are written there too.

Run from the root of a checkout:  ``python3 tools/port_serving_profile.py``
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def window(name, fn, trace_dir):
    """Run ``fn`` once on the host clock alone, then once under the
    profiler: the traced run's idle share, and an estimate that takes
    its busy time against the untraced run's wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_dir:
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              f"trace_{name}.json"))
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"window": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "unprofiled_wall_ms": plain_ms,
            "idle_share_estimate": 1.0 - busy_ms / plain_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top": [{"kernel": e.key[:80], "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in top]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-context", type=int, default=1024)
    ap.add_argument("--kv-dtype", default=None, help="bf16 or fp8")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, REPO)
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama3_8b
    from mxnet_tpu_torch.serving import InferenceEngine
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    dev = torch.device("cuda", 0)
    net = llama3_8b(device=dev, dtype=torch.bfloat16, seed=args.seed,
                    num_layers=args.layers)
    eng = InferenceEngine(net, max_batch=args.max_batch, block_size=16,
                          max_context=args.max_context,
                          kv_dtype=args.kv_dtype, device=dev).warmup()
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, net.cfg.vocab_size, args.prompt).tolist()
               for _ in range(eng.max_batch)]
    toks = [eng.prefill(i, p)[0] for i, p in enumerate(prompts[1:], 1)]

    def prefill_slot0():
        eng.prefill(0, prompts[0])
        eng.release(0)

    results = [window("prefill", prefill_slot0, args.trace_dir)]
    state = {"toks": [eng.prefill(0, prompts[0])[0]] + toks,
             "pos": args.prompt}

    def decode_steps():
        for _ in range(args.steps):
            entries = []
            for slot in range(eng.max_batch):
                if not eng.reserve(slot, state["pos"]):
                    raise RuntimeError("KV pool exhausted")
                entries.append((slot, state["toks"][slot], state["pos"]))
            nxt, _ = eng.decode(entries)
            state["toks"] = [int(t) for t in nxt]
            state["pos"] += 1

    results.append(window(f"decode_x{args.steps}", decode_steps,
                          args.trace_dir))
    for r in results:
        print(f"{r['window']}: wall {r['wall_ms']:.3f} ms, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share "
              f"{r['idle_share']:.3f}, {r['kernel_launches']} kernel "
              f"launches; unprofiled wall {r['unprofiled_wall_ms']:.3f} ms, "
              f"idle share estimate (traced busy over it) "
              f"{r['idle_share_estimate']:.3f}",
              flush=True)
    print(card)
    print(json.dumps({"card": card, "layers": args.layers,
                      "prompt": args.prompt, "max_batch": eng.max_batch,
                      "kv_dtype": eng.kv_dtype, "windows": results}))


if __name__ == "__main__":
    main()
