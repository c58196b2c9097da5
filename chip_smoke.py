#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, in order; any failure exits non-zero and nothing is caught and
continued:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of the serving path from
   ``mxnet_tpu_torch/ops/csrc`` (one ``nvcc`` per source, in parallel);
3. kernels: hold each kernel against its plain PyTorch version on the
   card, in float32 and bfloat16, at the shapes the serving path gives
   it; time the kernel, the plain version and, where one PyTorch call
   computes the same function, that call (``library_ms``);
4. serving: Llama-3-8B at full width and depth in bfloat16, random
   weights from a seed, ``InferenceEngine(max_batch=8, block_size=16,
   max_context=1024)`` and a ``ContinuousBatcher`` serving 16 greedy
   requests of 32 new tokens; the kernels' launch counters are set to 0
   just before and read just after, and every kernel must have run;
5. card vs CPU: a 2-layer model at the full 4096/32/8/128/14336 geometry
   and full vocabulary in float32, the same weights on the card (kernels)
   and on the host (plain versions), one 40-token prompt with prefill and
   8 greedy decode steps: logits within 2e-3, identical tokens.

The second-to-last line is the card's name and power limit, the line
before it the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12            # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,       # CUDA cores (no tensor cores here)
              "bfloat16": 989e12}     # dense tensor-core peak
FLASH_TOL = {"float32": (5e-5, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
PAGED_TOL = {"float32": (5e-5, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
LOGIT_ATOL = 2e-3


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, flush):
    """Mean device time of ``fn`` in ms from CUDA events, each launch
    timed alone with the L2 cache flushed before it (the serving path
    finds K/V cold)."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        # keep the card busy while the host enqueues the launch, so the
        # events time the kernel and not the Python wrapper
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def max_err(got, want, tol):
    """Largest |got - want| and whether every element is within
    ``atol + rtol * |want|``."""
    import torch
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool(torch.all(diff <= tol[0] + tol[1] * want.abs()))
    return float(diff.max()), ok


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------

def check_flash(dev, flush):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    H, D = 32, 128
    main = None
    worst = 0.0
    for L in (16, 128, 200, 1024):
        for name in ("float32", "bfloat16"):
            dtype = getattr(torch, name)
            g = torch.Generator(device=dev).manual_seed(L)
            q, k, v = (torch.randn(H, L, D, device=dev, generator=g)
                       .to(dtype) for _ in range(3))
            out, lse = flash_attention_fwd(q, k, v, True)
            ref, ref_lse = flash_attention_plain(q, k, v, True, D ** -0.5)
            torch.cuda.synchronize()
            err, ok = max_err(out, ref, FLASH_TOL[name])
            lerr, lok = max_err(lse, ref_lse, (1e-4, 1e-4))
            if not (ok and lok):
                fail(f"flash kernel vs plain at L={L} {name}: max |out| "
                     f"err {err}, max |lse| err {lerr}")
            worst = max(worst, err) if name == "bfloat16" else worst
            ms = time_ms(lambda: flash_attention_fwd(q, k, v, True), 20,
                         flush)
            plain_ms = time_ms(
                lambda: flash_attention_plain(q, k, v, True, D ** -0.5), 5,
                flush)
            qs, ks, vs = (t[None] for t in (q, k, v))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True), 20, flush)
            elem = q.element_size()
            nbytes = 4 * H * L * D * elem + 4 * H * L     # q,k,v,o + lse
            flops = 4.0 * H * D * (L * (L + 1) / 2)      # causal pairs
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[name] * 1e3
            print(f"flash_attention_fwd L={L} {name}: max_abs_err {err:.3e} "
                  f"lse_err {lerr:.3e} kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms sdpa {lib_ms:.4f} ms bound "
                  f"{max(t_bytes, t_ops):.4f} ms", flush=True)
            if L == 1024 and name == "bfloat16":
                main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=max(t_bytes, t_ops),
                            bound_by="bytes" if t_bytes >= t_ops
                            else "operations")
    main["max_abs_err"] = worst
    return main


def check_paged(dev, flush):
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                     paged_decode_plain)
    B, H, KVH, D, bs, nbl = 8, 32, 8, 128, 16, 64
    nb = 1 + B * nbl
    rng = np.random.RandomState(0)
    pos = rng.randint(0, nbl * bs, B).astype(np.int32)
    pos[0], pos[1] = nbl * bs - 1, 0                   # full row, idle row
    tables = np.zeros((B, nbl), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    for i in range(B):
        n = int(pos[i]) // bs + 1 if i != 1 else 0    # idle: null table
        tables[i, :n], perm = perm[:n], perm[n:]
    tab = torch.from_numpy(tables).to(dev)
    ps = torch.from_numpy(pos).to(dev)
    main = None
    worst = 0.0
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        g = torch.Generator(device=dev).manual_seed(1)
        q = torch.randn(B, H, D, device=dev, generator=g).to(dtype)
        kp, vp = (torch.randn(nb, bs, KVH, D, device=dev, generator=g)
                  .to(dtype) for _ in range(2))
        out = paged_decode_attention(q, kp, vp, tab, ps, D ** -0.5)
        ref = paged_decode_plain(q, kp, vp, tab, ps, D ** -0.5)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, PAGED_TOL[name])
        if not ok or not bool(torch.isfinite(out).all()):
            fail(f"paged kernel vs plain {name}: max abs err {err}")
        worst = max(worst, err) if name == "bfloat16" else worst
        ms = time_ms(lambda: paged_decode_attention(q, kp, vp, tab, ps,
                                                    D ** -0.5), 50, flush)
        plain_ms = time_ms(lambda: paged_decode_plain(q, kp, vp, tab, ps,
                                                      D ** -0.5), 5, flush)
        elem = q.element_size()
        rows = int((pos.astype(np.int64) + 1).sum())
        nbytes = (2 * rows * KVH * D * elem + 2 * B * H * D * elem
                  + sum(int(p) // bs + 1 for p in pos) * 4 + B * 4)
        flops = 4.0 * rows * H * D
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[name] * 1e3
        print(f"paged_decode_attention B={B} pos<= {int(pos.max())} {name}: "
              f"max_abs_err {err:.3e} kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms bound {max(t_bytes, t_ops):.4f} ms",
              flush=True)
        if name == "bfloat16":
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations")
    main["max_abs_err"] = worst
    return main


# ----------------------------------------------------------------------
# phase 4: the serving path at full width
# ----------------------------------------------------------------------

def serve_llama3_8b(dev, card):
    import numpy as np
    import torch
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama3_8b
    from mxnet_tpu_torch.serving import (ContinuousBatcher, InferenceEngine,
                                         Request)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    net = llama3_8b(device=dev, dtype=torch.bfloat16, seed=0)
    eng = InferenceEngine(net, max_batch=8, block_size=16,
                          max_context=1024, device=dev)
    eng.warmup()
    setup_s = time.perf_counter() - t0
    finite = []
    step_s = []
    prefill, decode = eng.prefill, eng.decode

    def prefill_checked(slot, tokens):
        out = prefill(slot, tokens)
        if out is not None:
            finite.append(torch.isfinite(out[1]).all())
        return out

    def decode_checked(entries):
        t = time.perf_counter()
        nxt, logits = decode(entries)      # returns after a host sync
        step_s.append(time.perf_counter() - t)
        finite.append(torch.isfinite(logits).all())
        return nxt, logits

    eng.prefill, eng.decode = prefill_checked, decode_checked
    rng = np.random.RandomState(0)
    lengths = rng.randint(16, 901, 16)
    batcher = ContinuousBatcher(eng)
    ops.reset_launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for n in lengths:
        batcher.submit(Request(rng.randint(0, net.cfg.vocab_size, n), 32))
    stats = batcher.run()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    if len(batcher.finished) != 16 or any(
            len(r.generated) != 32 for r in batcher.finished):
        fail("not every request finished with 32 tokens")
    if not bool(torch.stack(finite).all()):
        fail("non-finite logits on the serving path")
    n_layers = net.cfg.num_layers
    want = {"flash_attention_fwd": n_layers * eng.stats["prefill_calls"],
            "paged_decode_attention": n_layers * eng.stats["decode_calls"]}
    if launches != want or min(launches.values()) < 1:
        fail(f"kernel launches {launches}, expected {want}")
    ttft = sorted(r.ttft() for r in batcher.finished)
    tokens = stats["tokens_generated"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"serving llama3_8b bf16 on {card}: {len(lengths)} requests, "
          f"prompts {int(lengths.min())}-{int(lengths.max())} tokens, "
          f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s; "
          f"TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms; decode step "
          f"median {sorted(step_s)[len(step_s) // 2] * 1e3:.2f} ms over "
          f"{len(step_s)} steps; peak memory {peak_gb:.2f} GB; set-up "
          f"{setup_s:.1f} s; launches {launches}", flush=True)
    del eng, net, batcher
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phase 5: card against CPU on the full-width geometry
# ----------------------------------------------------------------------

def card_vs_cpu(dev):
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                           LlamaForCausalLM)
    from mxnet_tpu_torch.serving import InferenceEngine
    cfg = LlamaConfig(num_layers=2)
    on_card = LlamaForCausalLM(cfg, device=dev, seed=1)
    on_cpu = LlamaForCausalLM(cfg, device="cpu", seed=None)
    on_cpu.load_state_dict(on_card.state_dict())
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, 40).tolist()
    runs = []
    for net, d in ((on_card, dev), (on_cpu, "cpu")):
        eng = InferenceEngine(net, max_batch=2, block_size=16,
                              max_context=64, device=d)
        tok, last = eng.prefill(0, prompt)
        toks, logits = [tok], [last.float().cpu()]
        for _ in range(8):
            pos = len(prompt) + len(toks) - 1
            if not eng.reserve(0, pos):
                fail("card-vs-cpu: KV pool exhausted")
            nxt, lg = eng.decode([(0, toks[-1], pos)])
            toks.append(int(nxt[0]))
            logits.append(lg[0].float().cpu())
        runs.append((toks, torch.stack(logits)))
    (t_card, l_card), (t_cpu, l_cpu) = runs
    err = float((l_card - l_cpu).abs().max())
    print(f"card vs cpu (2 layers, full width, fp32): max |logit| diff "
          f"{err:.3e} (limit {LOGIT_ATOL}), tokens card {t_card} cpu "
          f"{t_cpu}", flush=True)
    if t_card != t_cpu or not err <= LOGIT_ATOL:
        fail("card and CPU disagree")


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke runs on the card")
    if not os.path.isdir(os.path.join(REPO, "mxnet_tpu_torch")):
        fail("run from the root of a checkout (mxnet_tpu_torch/ missing)")
    sys.path.insert(0, REPO)
    from mxnet_tpu_torch.ops import _build

    # phase 1: device
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"device: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build every kernel of the path
    t0 = time.perf_counter()
    _build.build(["flash_attention", "paged_attention"])
    print(f"build: {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}",
          flush=True)

    # phase 3: kernels against plain versions
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    flash = check_flash(dev, flush)
    paged = check_paged(dev, flush)
    del flush

    # phase 4: the serving path
    launches = serve_llama3_8b(dev, card)

    # phase 5: card against CPU
    card_vs_cpu(dev)

    kernels = []
    for name, res, src, tpu in (
            ("flash_attention_fwd", flash,
             "mxnet_tpu_torch/ops/csrc/flash_attention.cu",
             "mxnet_tpu/ops/flash_attention.py:51"),
            ("paged_decode_attention", paged,
             "mxnet_tpu_torch/ops/csrc/paged_attention.cu",
             "mxnet_tpu/ops/paged_attention.py:89")):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu, "tpu_kernel": tpu,
                        "launches": launches[name],
                        "max_abs_err": res["max_abs_err"],
                        "max_err": res["max_abs_err"], "ms": res["ms"],
                        "plain_ms": res["plain_ms"],
                        "bound_ms": res["bound_ms"],
                        "bound_by": res["bound_by"],
                        "library_ms": res["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
