#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, in order; any failure exits non-zero and nothing is caught and
continued:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of the serving and training paths from
   ``mxnet_tpu_torch/ops/csrc`` (one ``nvcc`` per source, in parallel);
3. kernels: hold each kernel against its plain PyTorch version on the
   card at the shapes its path gives it; time the kernel, the plain
   version and, where one PyTorch call computes the same function (or,
   marked "near", nearly the same), that call (``library_ms``):
   flash forward (float32, bfloat16), flash backward (BH=64, L=1024,
   D=128 causal, float32 and bfloat16, and ragged L=200 with D=64), K1
   (momentum, NAG) and K2 (Adam, AdamW with clip) on the training
   phase's 1.92 G-element bucket and an unaligned one of 5000;
4. serving: Llama-3-8B at full width and depth in bfloat16, random
   weights from a seed, ``InferenceEngine(max_batch=8, block_size=16,
   max_context=1024)`` and a ``ContinuousBatcher`` serving 16 greedy
   requests of 32 new tokens;
5. card vs CPU, serving: a 2-layer model at the full 4096/32/8/128/14336
   geometry and full vocabulary in float32, the same weights on the card
   (kernels) and on the host (plain versions), one 40-token prompt with
   prefill and 8 greedy decode steps: logits within 2e-3, identical
   tokens;
6. training: Llama-3-8B width at 4 layers in float32 (1.92 G
   parameters), batch 2 x 1024 tokens, ``SoftmaxCrossEntropyLoss`` and
   ``gluon.Trainer(..., "adamw", lr 1e-3, wd 0.1)``, 5 steps on one
   batch: the loss must be finite and fall from step 1 to step 5, with
   one K2 launch per step and one flash forward and backward per layer
   per step;
7. card vs CPU, training: one layer at the full geometry (vocabulary cut
   to 32000 to keep host memory modest), two SGD-momentum steps (K1 on
   the card, the plain rule on the host) on 64 tokens from the same
   weights: losses within 1e-4 relative, parameters within 1e-5.

Before each of phases 4, 6 and 7 the kernels' launch counters are set
to 0; each phase reads them just after and fails unless its kernels
ran the expected number of times.  The second-to-last line is the
card's name and power limit, the line before it the kernels' JSON
record; the last line is ``{"ok": true, "device": {...}}``.
"""
import gc
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12            # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,       # CUDA cores (no tensor cores here)
              "bfloat16": 989e12}     # dense tensor-core peak
FLASH_TOL = {"float32": (5e-5, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
# the backward's dp - delta cancels: f32 noise is relative to the terms
FLASH_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
PAGED_TOL = {"float32": (5e-5, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
# nvcc contracts a*b + c into one FMA; the plain rule rounds twice
UPDATE_TOL = (1e-7, 1e-6)
LOGIT_ATOL = 2e-3
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
CHUNK = 1 << 26                       # plain update rule, per chunk
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2, 1024, 5


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
    """Median device time of ``fn`` in ms from CUDA events, each launch
    timed alone with the L2 cache flushed before it (the serving path
    finds K/V cold); the median keeps one slow call (an allocation, a
    clock change) out of the number."""
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
    return statistics.median(s.elapsed_time(e) for s, e in events)


def max_err(got, want, tol):
    """Largest |got - want| and whether every element is within
    ``atol + rtol * |want|``."""
    import torch
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool(torch.all(diff <= tol[0] + tol[1] * want.abs()))
    return float(diff.max()), ok


# ----------------------------------------------------------------------
# shared checks
# ----------------------------------------------------------------------

def read_launches(phase, want):
    """Every kernel's launch count since the last ``reset_launches``;
    fails unless the kernels in ``want`` ran exactly that often (at
    least once) and every other kernel not at all."""
    from mxnet_tpu_torch import ops
    got = {name: fn.launches for name, fn in ops.KERNELS.items()}
    full = {name: want.get(name, 0) for name in got}
    if got != full or min(want.values()) < 1:
        fail(f"{phase}: kernel launches {got}, expected {full}")
    return got


def bound(nbytes, flops, dtype_name):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def check_flash_bwd(dev, flush):
    """The backward kernel against the plain backward at the training
    phase's shape (B=2 x H=32 heads, L=1024, D=128, causal) and a ragged
    one (L=200, D=64); library: the backward of
    ``scaled_dot_product_attention`` (forward + backward minus
    forward)."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd)
    B, H = 2, 32
    main = None
    worst = 0.0
    for L, D in ((1024, 128), (200, 64)):
        for name in ("float32", "bfloat16"):
            dtype = getattr(torch, name)
            g = torch.Generator(device=dev).manual_seed(L + D)
            q, k, v, do = (torch.randn(B * H, L, D, device=dev, generator=g)
                           .to(dtype) for _ in range(4))
            out, lse = flash_attention_fwd(q, k, v, True)
            got = flash_attention_bwd(q, k, v, out, lse, do, True)
            want = flash_attention_bwd_plain(q, k, v, out, lse, do, True,
                                             D ** -0.5)
            torch.cuda.synchronize()
            err = 0.0
            for a, b, what in zip(got, want, ("dq", "dk", "dv")):
                e, ok = max_err(a, b, FLASH_BWD_TOL[name])
                if not ok or not bool(torch.isfinite(a).all()):
                    fail(f"flash backward kernel vs plain at L={L} D={D} "
                         f"{name}: max |{what}| err {e}")
                err = max(err, e)
            worst = max(worst, err)
            ms = time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do,
                                                     True), 10, flush)
            plain_ms = time_ms(lambda: flash_attention_bwd_plain(
                q, k, v, out, lse, do, True, D ** -0.5), 10, flush)
            qs, ks, vs = (t.view(B, H, L, D).detach().requires_grad_()
                          for t in (q, k, v))
            gs = do.view(B, H, L, D)

            def sdpa_fwd():
                return F.scaled_dot_product_attention(qs, ks, vs,
                                                      is_causal=True)

            fwd_ms = time_ms(sdpa_fwd, 10, flush)
            both_ms = time_ms(lambda: torch.autograd.grad(
                sdpa_fwd(), (qs, ks, vs), gs), 10, flush)
            lib_ms = both_ms - fwd_ms
            elem = q.element_size()
            nbytes = 8 * B * H * L * D * elem + 4 * B * H * L  # 5 in, 3 out
            flops = 10.0 * B * H * D * (L * (L + 1) / 2)      # 5 products
            bound_ms, by = bound(nbytes, flops, name)
            print(f"flash_attention_bwd BH={B * H} L={L} D={D} {name}: "
                  f"max_abs_err {err:.3e} kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms sdpa-bwd {lib_ms:.4f} ms bound "
                  f"{bound_ms:.4f} ms ({by})", flush=True)
            if L == 1024 and name == "float32":   # the training phase's
                main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=by)
            del q, k, v, do, out, lse, got, want, qs, ks, vs, gs
    main["max_abs_err"] = worst
    return main


def _chunks(n):
    return [slice(i, min(i + CHUNK, n)) for i in range(0, n, CHUNK)]


def _library_update(rule, hyper, p, g, s, lr, wd, step):
    """The nearest single PyTorch call on the one flat tensor ("near":
    torch puts eps after the bias-corrected sqrt(v), has no clip, and
    its momentum convention differs)."""
    import torch
    if rule in ("adam", "adamw"):
        fn = torch._fused_adamw_ if rule == "adamw" else torch._fused_adam_
        fn([p], [g], [s["m"]], [s["v"]], [], [step], lr=lr,
           beta1=hyper["beta1"], beta2=hyper["beta2"], weight_decay=wd,
           eps=hyper["epsilon"], amsgrad=False, maximize=False)
    else:
        torch._fused_sgd_([p], [g], [s["mom"]], weight_decay=wd,
                          momentum=hyper["momentum"], lr=lr, dampening=0.0,
                          nesterov=rule == "nag", maximize=False,
                          is_first_step=False)


def check_updates(dev, flush, n_big):
    """K1 (momentum, NAG) and K2 (Adam, AdamW, with clip) against the
    plain rule on the training phase's bucket of ``n_big`` elements and
    an unaligned one of 5000.  The kernel updates copies of p and the
    state in place; the plain rule, elementwise, runs on chunks of the
    same inputs."""
    import torch
    from mxnet_tpu_torch.ops.fused_update import fused_bucket_rule
    from mxnet_tpu_torch.optimizer import fused_rule
    lr, wd, rescale, clip = 1e-3, 0.1, 0.5, 1.0
    cases = [("adamw", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
             ("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
             ("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9})]
    results = {}
    for rule, hyper in cases:
        kernel_name = "fused_adam_update" if rule.startswith("adam") \
            else "fused_sgd_update"
        for n in (n_big, 5000):
            g_ = torch.Generator(device=dev).manual_seed(n % 1009)
            p = torch.randn(n, device=dev, generator=g_)
            grad = torch.randn(n, device=dev, generator=g_)
            if kernel_name == "fused_adam_update":
                s = {"m": torch.randn(n, device=dev, generator=g_) * 0.1,
                     "v": torch.rand(n, device=dev, generator=g_) * 0.01,
                     "t": 3}
            else:
                s = {"mom": torch.randn(n, device=dev, generator=g_) * 0.1}
            _, apply = fused_bucket_rule(rule, clip_gradient=clip, **hyper)
            _, plain = fused_rule(rule, clip_gradient=clip, **hyper)
            kp = p.clone()
            ks = {k: v.clone() if torch.is_tensor(v) else v
                  for k, v in s.items()}
            kp, ks = apply(kp, grad, ks, lr, wd, rescale)   # in place
            err = 0.0
            for c in _chunks(n):
                want_p, want_s = plain(
                    p[c], grad[c], {k: v[c] if torch.is_tensor(v) else v
                                    for k, v in s.items()}, lr, wd, rescale)
                pairs = [(kp[c], want_p)] + [
                    (ks[k][c], want_s[k]) for k in ks if torch.is_tensor(
                        ks[k])]
                for got, want in pairs:
                    e, ok = max_err(got, want, UPDATE_TOL)
                    if not ok:
                        fail(f"{kernel_name} ({rule}) vs plain at n={n}: "
                             f"max abs err {e}")
                    err = max(err, e)
            del want_p, want_s, pairs
            ms = time_ms(lambda: apply(kp, grad, ks, lr, wd, rescale), 10,
                         flush)
            def plain_pass():
                for c in _chunks(n):    # each chunk's result is dropped
                    plain(p[c], grad[c], {
                        k: v[c] if torch.is_tensor(v) else v
                        for k, v in s.items()}, lr, wd, rescale)

            plain_ms = time_ms(plain_pass, 3, flush)
            step = torch.tensor(3.0, device=dev)
            lib_ms = time_ms(lambda: _library_update(
                rule, hyper, kp, grad, ks, lr, wd, step), 10, flush)
            per_elem = 28 if kernel_name == "fused_adam_update" else 20
            flops = (20.0 if kernel_name == "fused_adam_update" else 8.0) * n
            bound_ms, by = bound(per_elem * n, flops, "float32")
            print(f"{kernel_name} ({rule}, clip) n={n}: max_abs_err "
                  f"{err:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                  f"library (near) {lib_ms:.4f} ms bound {bound_ms:.4f} ms "
                  f"({by})", flush=True)
            res = results.setdefault(kernel_name, {"max_abs_err": 0.0})
            res["max_abs_err"] = max(res["max_abs_err"], err)
            # the training phases' rules at the training bucket
            if n == n_big and rule in ("adamw", "sgd"):
                res.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=by)
            del p, grad, s, kp, ks
            torch.cuda.empty_cache()
    return results


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
    launches = read_launches("serving", {
        "flash_attention_fwd": net.cfg.num_layers * eng.stats["prefill_calls"],
        "paged_decode_attention":
            net.cfg.num_layers * eng.stats["decode_calls"]})
    if len(batcher.finished) != 16 or any(
            len(r.generated) != 32 for r in batcher.finished):
        fail("not every request finished with 32 tokens")
    if not bool(torch.stack(finite).all()):
        fail("non-finite logits on the serving path")
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
    # the checked prefill/decode wrappers and the engine reference each
    # other: collect the cycle, or 17 GB of weights and cache outlive
    # the phase
    del eng, net, batcher, prefill, decode
    gc.collect()
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


# ----------------------------------------------------------------------
# phase 6: training at full width
# ----------------------------------------------------------------------

def train_param_count():
    """Parameters of the training phase's model, counted on the meta
    device (the size of the Trainer's flat bucket)."""
    import torch
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                           LlamaModel)
    cfg = LlamaConfig(num_layers=TRAIN_LAYERS)
    with torch.device("meta"):
        trunk = LlamaModel(cfg)
    return sum(p.numel() for p in trunk.parameters()) + \
        cfg.vocab_size * cfg.hidden_size           # untied lm_head


def train_llama3_8b(dev, card):
    import statistics
    import numpy as np
    import torch
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama3_8b
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    net = llama3_8b(device=dev, dtype=torch.float32, seed=0,
                    num_layers=TRAIN_LAYERS)
    trainer = Trainer(dict(net.named_parameters()), "adamw",
                      {"learning_rate": 1e-3, "wd": 0.1})
    loss_fn = SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(0)
    vocab = net.cfg.vocab_size
    tokens, labels = (torch.from_numpy(rng.randint(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ))).to(dev) for _ in range(2))
    n_params = sum(p.numel() for p in net.parameters())
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    ops.reset_launches()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        loss = loss_fn(net(tokens), labels)          # (batch,)
        loss.sum().backward()
        trainer.step(TRAIN_BATCH)
        losses.append(loss.detach().mean())
        torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t)
    launches = read_launches("training", {
        "flash_attention_fwd": TRAIN_LAYERS * TRAIN_STEPS,
        "flash_attention_bwd": TRAIN_LAYERS * TRAIN_STEPS,
        "fused_adam_update": TRAIN_STEPS})
    losses = [float(x) for x in losses]
    step_ms = statistics.median(step_s[1:]) * 1e3
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"training llama3_8b width, {TRAIN_LAYERS} layers, fp32, "
          f"{n_params} params, adamw, batch {TRAIN_BATCH}x{TRAIN_SEQ} on "
          f"{card}: losses {losses}; step median {step_ms:.1f} ms over steps "
          f"2-{TRAIN_STEPS} (first {step_s[0] * 1e3:.1f} ms) = "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.1f} tokens/s; peak "
          f"memory {peak_gb:.2f} GB; set-up {setup_s:.1f} s; launches "
          f"{launches}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall from step 1 to step "
             f"{TRAIN_STEPS}: {losses}")
    del net, trainer, loss
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phase 7: training, card against CPU on the full-width geometry
# ----------------------------------------------------------------------

def train_card_vs_cpu(dev):
    import numpy as np
    import torch
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                           LlamaForCausalLM)
    cfg = LlamaConfig(num_layers=1, vocab_size=32000)
    on_card = LlamaForCausalLM(cfg, device=dev, seed=1)
    on_cpu = LlamaForCausalLM(cfg, device="cpu", seed=None)
    on_cpu.load_state_dict(on_card.state_dict())
    rng = np.random.RandomState(2)
    tokens, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                   (1, 64)))
                      for _ in range(2))
    runs, launches = [], None
    for net, d in ((on_card, dev), (on_cpu, torch.device("cpu"))):
        trainer = Trainer(dict(net.named_parameters()), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9})
        if d.type == "cuda":
            ops.reset_launches()
        losses = []
        for _ in range(2):
            loss = SoftmaxCrossEntropyLoss()(net(tokens.to(d)),
                                             labels.to(d))
            loss.sum().backward()
            trainer.step(1)
            losses.append(float(loss.detach().mean()))
        if d.type == "cuda":
            torch.cuda.synchronize(dev)
            launches = read_launches("training card vs cpu", {
                "flash_attention_fwd": 2, "flash_attention_bwd": 2,
                "fused_sgd_update": 2})
        runs.append(losses)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*runs))
    param_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                    for a, b in zip(on_card.parameters(),
                                    on_cpu.parameters()))
    print(f"training card vs cpu (1 layer, full width, vocab cut to "
          f"{cfg.vocab_size}, fp32, 2 sgd-momentum steps on 64 tokens): "
          f"losses card {runs[0]} cpu {runs[1]}, max relative loss diff "
          f"{loss_err:.3e} (limit {TRAIN_LOSS_RTOL}), max |param| diff "
          f"{param_err:.3e} (limit {TRAIN_PARAM_ATOL})", flush=True)
    if not (loss_err <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_ATOL):
        fail("training on the card and on the CPU disagree")
    del on_card, on_cpu
    torch.cuda.empty_cache()
    return launches


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

    # phase 2: build every kernel of the paths
    t0 = time.perf_counter()
    _build.build(["flash_attention", "flash_attention_bwd",
                  "paged_attention", "fused_update"])
    print(f"build: {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}",
          flush=True)

    # phase 3: kernels against plain versions
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    checks = {"flash_attention_fwd": check_flash(dev, flush),
              "paged_decode_attention": check_paged(dev, flush),
              "flash_attention_bwd": check_flash_bwd(dev, flush)}
    checks.update(check_updates(dev, flush, train_param_count()))
    del flush
    torch.cuda.empty_cache()

    # phases 4-7: each path from zeroed launch counters
    by_path = {"serving": serve_llama3_8b(dev, card)}
    card_vs_cpu(dev)
    by_path["training"] = train_llama3_8b(dev, card)
    by_path["training_card_vs_cpu"] = train_card_vs_cpu(dev)

    kernels = []
    for name, src, tpu in (
            ("flash_attention_fwd", "flash_attention.cu",
             "mxnet_tpu/ops/flash_attention.py:51"),
            ("flash_attention_bwd", "flash_attention_bwd.cu",
             "mxnet_tpu/ops/flash_attention.py:174"),
            ("paged_decode_attention", "paged_attention.cu",
             "mxnet_tpu/ops/paged_attention.py:89"),
            ("fused_sgd_update", "fused_update.cu",
             "mxnet_tpu/ops/fused_update.py:95"),
            ("fused_adam_update", "fused_update.cu",
             "mxnet_tpu/ops/fused_update.py:118")):
        res = checks[name]
        paths = {path: got[name] for path, got in by_path.items()
                 if got[name]}
        if not paths:
            fail(f"{name} ran on no path")
        kernels.append({"name": name, "route": "cuda",
                        "source": f"mxnet_tpu_torch/ops/csrc/{src}",
                        "replaces": tpu, "tpu_kernel": tpu,
                        "launches": sum(paths.values()),
                        "launches_by_path": paths,
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
