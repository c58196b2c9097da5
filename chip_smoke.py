#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, in order; any failure exits non-zero and nothing is caught and
continued:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of the serving, training and LayerNorm
   paths from ``mxnet_tpu_torch/ops/csrc`` (one ``nvcc`` per source, in
   parallel); print each flash kernel's registers, spill bytes (ptxas),
   dynamic shared memory and ``HGMMA`` (wgmma), ``HMMA`` (mma.sync) and
   instruction counts (``cuobjdump -sass``), and fail if a flash kernel
   spills, a bf16 one issues no wgmma or an f32 one no mma.sync; print
   the registers, spills and shared memory of every paged-attention,
   LayerNorm and update (K1/K2) kernel, and fail if one spills, and the
   resident CTAs of K4's two row kernels and K1/K2's;
3. kernels: hold each kernel against its plain PyTorch version on the
   card at the shapes its path gives it; time the kernel, the plain
   version and, where one PyTorch call computes the same function (or,
   marked "near", nearly the same), that call (``library_ms``), the
   flash lines with their factor against SDPA and share of the bound:
   flash forward (float32, bfloat16), paged decode (f32 and bf16 pools;
   an fp8 pool with a bf16 and an f32 query; an fp8 pool at phase 7's
   B = 16 and 4096-position bucket), flash backward (BH=64,
   L=1024, D=128 causal, float32 and bfloat16, and ragged L=200 with
   D=64), fused LayerNorm forward and backward (4096 x 1024 with
   residual, float32 and bfloat16; two runs of each bitwise equal; the
   forward timed against its library call and ``torch.add(x, res)`` in
   20 interleaved pairs; the paged decode and LayerNorm rows also print
   their device time by kernel from ``torch.profiler``), K1
   (momentum, NAG) and K2 (Adam, AdamW with clip) on the training
   phase's 1.92 G-element bucket, on buckets of 5000 and 5003 elements
   and on views one element into their allocations; at the training
   bucket each is timed against its library call in 20 interleaved
   pairs (medians, the ratio's median and range, TB/s, share of the
   bound);
4. serving: Llama-3-8B at full width and depth in bfloat16, random
   weights from a seed, ``InferenceEngine(max_batch=8, block_size=16,
   max_context=1024)`` and a ``ContinuousBatcher`` serving 16 greedy
   requests of 32 new tokens;
5. card vs CPU, serving: a 2-layer model at the full 4096/32/8/128/14336
   geometry and full vocabulary in float32, the same weights on the card
   (kernels) and on the host (plain versions), one 40-token prompt with
   prefill and 8 greedy decode steps: logits within 2e-3, identical
   tokens;
6. card vs CPU, fp8 KV: the same nets and prompt with ``kv_dtype="fp8"``
   on both, the CPU teacher-forced with the card's tokens: logits within
   2e-2, a drift against the f32 pool above 0, and on the rows computed
   from fresh inputs codes identical in 99.9% of elements and scales
   within 1e-5 relative;
7. fp8 KV serving: Llama-3-8B bf16 at full depth with
   ``kv_dtype="fp8", max_batch=16, max_context=4096`` (4097 blocks), 32
   greedy requests with prompts of 256-3800 tokens and 32 new tokens,
   then one request's drift against a bf16 pool (printed);
8. training: Llama-3-8B width at 4 layers in float32 (1.92 G
   parameters), batch 2 x 1024 tokens, ``SoftmaxCrossEntropyLoss`` and
   ``gluon.Trainer(..., "adamw", lr 1e-3, wd 0.1)``, 5 steps on one
   batch: the loss must be finite and fall from step 1 to step 5, with
   one K2 launch per step and one flash forward and backward per layer
   per step;
9. card vs CPU, training: one layer at the full geometry (vocabulary cut
   to 32000 to keep host memory modest), two SGD-momentum steps (K1 on
   the card, the plain rule on the host) on 64 tokens from the same
   weights: losses within 1e-4 relative, parameters within 1e-5;
10. LayerNorm op: BERT-large's 48 post-sublayer LayerNorms at 4096 x 1024
    in bfloat16 (f32 gamma/beta) through ``ops.fused_layer_norm``,
    forward and backward: gradients finite and within phase 3's
    tolerances of the plain backward; the device time of a pass by
    kernel (``torch.profiler``) beside the host clock.

Before each of phases 4, 7, 8, 9 and 10 the kernels' launch counters are
set to 0; each phase reads them just after and fails unless its kernels
ran the expected number of times.  The second-to-last line is the
card's name and power limit, the line before it the kernels' JSON
record, and the line before that every timed row of phase 3 as
``{"kernel_rows": [...]}``; the last line is ``{"ok": true, "device":
{...}}``.
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
# dense tensor-core peaks; f32-accurate products run as 3xTF32 (three
# TF32 products each), so f32 gets 495 TF/s TF32 / 3
PEAK_FLOPS = {"float32": 495e12 / 3,
              "bfloat16": 989e12}
FLASH_TOL = {"float32": (5e-5, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
# the backward's dp - delta cancels: f32 noise is relative to the terms
FLASH_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
PAGED_TOL = {"float32": (5e-5, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
# K4: y and dx in their dtype; dgamma/dbeta are f32 sums over 4096 rows
# taken in another order than the plain version's
LN_TOL = {"float32": (5e-5, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
LN_PARAM_TOL = (1e-3, 1e-4)
FP8_LOGIT_ATOL = 2e-2
FP8_CODES_SAME = 0.999
FP8_SCALE_RTOL = 1e-5
# nvcc contracts a*b + c into one FMA; the plain rule rounds twice
UPDATE_TOL = (1e-7, 1e-6)
LOGIT_ATOL = 2e-3
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
CHUNK = 1 << 26                       # plain update rule, per chunk
UPDATE_PAIRS = 20                     # K1/K2 against the library, in turns
LN_PAIRS = 20                         # K4 forward, its library call, x + res
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


def time_ms(fn, iters, flush, cover=200_000):
    """Median device time of ``fn`` in ms over ``iters`` calls, each timed
    alone as ``interleaved_ms`` times it (the L2 cache flushed before it:
    the serving path finds K/V cold); the median keeps one slow call (an
    allocation, a clock change) out of the number."""
    return statistics.median(
        interleaved_ms({"fn": fn}, iters, flush, cover)["fn"])


def interleaved_ms(fns, rounds, flush, cover=200_000):
    """{name: [device ms of each call]} of the callables in ``fns``, one
    call of each a round, in the given order on even rounds and reversed
    on odd ones (kernel, library, library, kernel, ...), each call timed
    alone by CUDA events with the L2 cache flushed before it.  ``cover``:
    cycles the card sleeps ahead of each timed call while the host
    enqueues it, so the events time the kernel and not the Python
    wrapper."""
    import torch
    names = list(fns)
    for name in names:
        fns[name]()
    torch.cuda.synchronize()
    events = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            flush.zero_()
            torch.cuda._sleep(cover)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            events[name].append((start, end))
    torch.cuda.synchronize()
    return {name: [s.elapsed_time(e) for s, e in ev]
            for name, ev in events.items()}


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
    got = ops.launch_counts()
    full = {name: want.get(name, 0) for name in got}
    if got != full or min(want.values()) < 1:
        fail(f"{phase}: kernel launches {got}, expected {full}")
    return got


ROWS = []        # every timed (kernel, dtype, shape) of phase 3


def record(kernel, dtype, shape, ms, plain_ms, library_ms, bound_ms, by,
           device_ms=None, add_ms=None):
    """Keep one timed row of phase 3 for the ``kernel_rows`` line."""
    row = {"kernel": kernel, "dtype": dtype, "shape": shape, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": by}
    if device_ms is not None:
        row["device_ms"] = device_ms
    if add_ms is not None:
        row["add_ms"] = add_ms
    ROWS.append(row)


def device_ms(fn, iters, flush=None):
    """{kernel: device ms a call} of ``fn`` from ``torch.profiler`` over
    ``iters`` calls, the L2 cache flushed before each where ``flush`` is
    given (the flush's own kernel left out): no launch latency and no
    host time in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and not any(
                w in e.key.lower() for w in ("fill", "memset")):
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].removeprefix("void ")
            out[name] = out.get(name, 0.0) + \
                e.self_device_time_total / 1e3 / iters
    return out


def by_kernel(times):
    """``device_ms``'s result as printed text."""
    return ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()) or \
        "not measured"


def bound(nbytes, flops, dtype_name):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ----------------------------------------------------------------------
# phase 2: what ptxas and the SASS say about the flash kernels
# ----------------------------------------------------------------------

def flash_kernel_report():
    """For every kernel of the two flash libraries: registers and spill
    bytes (ptxas, from the build log), the dynamic shared memory its
    launch asks for, and its ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync)
    instructions in the SASS.  Fails if a flash kernel spills, a bf16 one
    issues no HGMMA or an f32 one (3xTF32) no HMMA."""
    import ctypes
    import re
    from mxnet_tpu_torch.ops import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for lib_name, smem_fn in (("flash_attention", "flash_attention_fwd_smem"),
                              ("flash_attention_bwd",
                               "flash_attention_bwd_smem")):
        with open(_build.log_path(lib_name)) as f:
            log = f.read()
        path = _build.build([lib_name])[lib_name]
        sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                              text=True, timeout=300)
        if sass.returncode != 0:
            fail(f"cuobjdump -sass {path}: {sass.stderr.strip()}")
        funcs = {m[1]: m[2] for m in re.finditer(
            r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass.stdout,
            re.S)}
        lib = ctypes.CDLL(path)         # its own handle: the ops' argtypes
        smem = getattr(lib, smem_fn)                      # stay untouched
        smem.restype = ctypes.c_int
        for entry in log.split("Compiling entry function '")[1:]:
            mangled = entry.split("'")[0]
            m = re.search(r"((?:flash_fwd|flash_bwd|delta)\w*?kernel)I(\w*?)"
                          r"Li(\d+)E", mangled)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", entry)
            if not (m and regs and spill):
                fail(f"{lib_name}: unreadable ptxas entry {mangled}")
            name, d = m[1], int(m[3])
            bf16 = "bfloat16" in m[2] or "bf16" in name
            if name == "delta_kernel":
                nbytes = 0
            elif lib_name == "flash_attention":
                nbytes = smem(int(bf16), d)
            else:
                nbytes = smem(int(bf16), d, int("_dq_" in name))
            tag = f"{name}<{'bf16' if bf16 else 'f32'}, D={d}>"
            body = funcs.get(mangled, "")
            hgmma, hmma = body.count("HGMMA"), body.count("HMMA")
            n_sass = len(re.findall(r"/\*[0-9a-f]{4,}\*/ +[@A-Z]", body))
            print(f"ptxas {tag}: {regs[1]} registers, {spill[1]} bytes spill "
                  f"stores, {spill[2]} bytes spill loads, {nbytes} bytes "
                  f"shared memory; {hgmma} HGMMA, {hmma} HMMA of {n_sass} "
                  f"instructions in SASS", flush=True)
            if name == "delta_kernel":
                continue
            if int(spill[1]) > 0 or (hgmma if bf16 else hmma) == 0:
                fail(f"{tag}: no {'wgmma' if bf16 else 'mma.sync'} in its "
                     f"SASS, or it spills")


def ptxas_report(lib_names):
    """For every kernel of the named libraries: registers, spill bytes,
    stack and static shared memory as ptxas reports them (names demangled
    where the toolkit has ``cu++filt``).  Fails if one spills.  K4's row
    kernels also take dynamic shared memory: the forward 2 * 4 * D bytes
    (gamma and beta in f32; 8 KB at D = 1024), the backward (1 + 16 /
    WPR) * 4 * D bytes (68 KB); their resident CTAs a SM at phase 3's
    D = 1024 are printed, and those of K1/K2's
    ``update_kernel<rule, clip, U>`` (rule 0 SGD, 1 momentum,
    2 NAG, 3 Adam, 4 AdamW), which size their persistent grid."""
    import ctypes
    import re
    from mxnet_tpu_torch.ops import _build
    filt = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    spilled = []
    for lib_name in lib_names:
        with open(_build.log_path(lib_name)) as f:
            entries = f.read().split("Compiling entry function '")[1:]
        mangled = [e.split("'")[0] for e in entries]
        names = mangled
        if os.path.exists(filt):
            out = subprocess.run([filt], input="\n".join(mangled),
                                 capture_output=True, text=True, timeout=60)
            if out.returncode == 0:
                names = out.stdout.splitlines()
        for name, entry in zip(names, entries):
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", entry)
            smem = re.search(r"(\d+) bytes smem", entry)
            stack = re.search(r"(\d+) bytes stack frame", entry)
            if not (regs and spill):
                fail(f"{lib_name}: unreadable ptxas entry {name}")
            name = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "",
                          name)
            name = re.sub(r"^void |\(int\)|\([^()]*\)$", "", name)
            print(f"ptxas {name}: {regs[1]} registers, {spill[1]} bytes spill "
                  f"stores, {spill[2]} bytes spill loads, "
                  f"{stack[1] if stack else 0} bytes stack, "
                  f"{smem[1] if smem else 0} bytes static shared memory",
                  flush=True)
            if int(spill[1]) > 0 or int(spill[2]) > 0:
                spilled.append(name)
    if spilled:
        fail(f"these kernels spill: {spilled}")
    lib = ctypes.CDLL(_build.build(["fused_layernorm"])["fused_layernorm"])
    resident = lib.fused_layer_norm_resident
    resident.argtypes = [ctypes.c_int] * 7
    for backward, kernel in ((0, "ln_fwd_rows"), (1, "ln_bwd_rows")):
        for dtype, name in ((0, "f32"), (1, "bf16")):
            print(f"{kernel} {name} at D=1024: "
                  f"{resident(backward, 1, 1024, 1, dtype, 0, 0)} / "
                  f"{resident(backward, 0, 1024, 1, dtype, 0, 0)} resident "
                  f"CTAs a SM of 8 warps (16-byte / scalar loads)",
                  flush=True)
    lib = ctypes.CDLL(_build.build(["fused_update"])["fused_update"])
    resident = lib.fused_update_resident
    resident.argtypes = [ctypes.c_int] * 3
    print("update_kernel resident CTAs a SM of 256 threads, by rule 0-4 "
          "without / with the clip: " + ", ".join(
              f"{r}: {resident(r, 0, 0)}/{resident(r, 1, 0)}"
              for r in range(5)), flush=True)


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
            bound_ms, by = bound(nbytes, flops, name)
            print(f"flash_attention_fwd L={L} {name}: max_abs_err {err:.3e} "
                  f"lse_err {lerr:.3e} kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms sdpa {lib_ms:.4f} ms "
                  f"({ms / lib_ms:.2f}x sdpa) bound {bound_ms:.4f} ms "
                  f"({by}; {bound_ms / ms:.1%} of it)", flush=True)
            record("flash_attention_fwd", name, [H, L, D], ms, plain_ms,
                   lib_ms, bound_ms, by)
            if L == 1024 and name == "bfloat16":
                main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=by)
    main["max_abs_err"] = worst
    return main


PAGED_SHAPE = dict(B=8, H=32, KVH=8, D=128, bs=16, nbl=64)
# phase 7's decode geometry: 16 sequences, a 4096-position bucket
PAGED_LONG = dict(PAGED_SHAPE, B=16, nbl=256)


def paged_tables(dev, B=PAGED_SHAPE["B"], bs=PAGED_SHAPE["bs"],
                 nbl=PAGED_SHAPE["nbl"]):
    """K5's check inputs, from seed 0: tables of scattered blocks (row 0
    full, row 1 idle on the null block) and positions drawn below
    ``nbl * bs``.  Returns (pos as numpy, tables and pos as int32 on
    ``dev``)."""
    import numpy as np
    import torch
    nb = 1 + B * nbl
    rng = np.random.RandomState(0)
    pos = rng.randint(0, nbl * bs, B).astype(np.int32)
    pos[0], pos[1] = nbl * bs - 1, 0                   # full row, idle row
    tables = np.zeros((B, nbl), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    for i in range(B):
        n = int(pos[i]) // bs + 1 if i != 1 else 0    # idle: null table
        tables[i, :n], perm = perm[:n], perm[n:]
    return (pos, torch.from_numpy(tables).to(dev),
            torch.from_numpy(pos).to(dev))


def check_paged(dev, flush):
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                     paged_decode_plain)
    B, H, KVH, D, bs, nbl = PAGED_SHAPE.values()
    nb = 1 + B * nbl
    pos, tab, ps = paged_tables(dev)
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
        dev_ms = device_ms(lambda: paged_decode_attention(
            q, kp, vp, tab, ps, D ** -0.5), 20, flush)
        plain_ms = time_ms(lambda: paged_decode_plain(q, kp, vp, tab, ps,
                                                      D ** -0.5), 5, flush)
        elem = q.element_size()
        rows = int((pos.astype(np.int64) + 1).sum())
        nbytes = (2 * rows * KVH * D * elem + 2 * B * H * D * elem
                  + sum(int(p) // bs + 1 for p in pos) * 4 + B * 4)
        bound_ms, by = bound(nbytes, 4.0 * rows * H * D, name)
        print(f"paged_decode_attention B={B} pos<= {int(pos.max())} {name}: "
              f"max_abs_err {err:.3e} kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms bound {bound_ms:.4f} ms; device "
              f"{by_kernel(dev_ms)}", flush=True)
        record("paged_decode_attention", name, [B, H, KVH, D, int(pos.max())],
               ms, plain_ms, None, bound_ms, by, dev_ms)
        if name == "bfloat16":
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                        bound_ms=bound_ms, bound_by=by)
    main["max_abs_err"] = worst
    return main


def check_paged_fp8(dev, flush):
    """K5's fp8 path: pools quantized on the card by ``kv_quantize_fp8``,
    against the plain fp8 version on the same codes and scales; at
    ``check_paged``'s shapes with a bf16 and an f32 query, and at phase
    7's decode geometry (``PAGED_LONG``: B = 16, positions from seed 0 up
    to 4095) with a bf16 query."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                     paged_decode_plain)
    from mxnet_tpu_torch.ops.quant_kv import kv_quantize_fp8
    main = None
    worst = 0.0
    for shape, name in ((PAGED_SHAPE, "bfloat16"), (PAGED_SHAPE, "float32"),
                        (PAGED_LONG, "bfloat16")):
        B, H, KVH, D, bs, nbl = shape.values()
        nb = 1 + B * nbl
        pos, tab, ps = paged_tables(dev, B, bs, nbl)
        g = torch.Generator(device=dev).manual_seed(2)
        (kp, ks), (vp, vs) = (kv_quantize_fp8(
            torch.randn(nb, bs, KVH, D, device=dev, generator=g))
            for _ in range(2))
        q = torch.randn(B, H, D, device=dev, generator=g).to(
            getattr(torch, name))

        def kernel():
            return paged_decode_attention(q, kp, vp, tab, ps, D ** -0.5,
                                          k_scale=ks, v_scale=vs)

        def plain():
            return paged_decode_plain(q, kp, vp, tab, ps, D ** -0.5, ks, vs)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, PAGED_TOL[name])
        if not ok or not bool(torch.isfinite(out).all()):
            fail(f"paged fp8 kernel vs plain, {name} query: max abs err "
                 f"{err}")
        worst = max(worst, err)
        ms = time_ms(kernel, 50, flush)
        dev_ms = device_ms(kernel, 20, flush)
        plain_ms = time_ms(plain, 5, flush)
        rows = int((pos.astype(np.int64) + 1).sum())
        elem = q.element_size()
        nbytes = (2 * rows * KVH * D + 2 * rows * 4 + 2 * B * H * D * elem
                  + sum(int(p) // bs + 1 for p in pos) * 4 + B * 4)
        bound_ms, by = bound(nbytes, 4.0 * rows * H * D, name)
        print(f"paged_decode_attention fp8 pool, {name} query, B={B} pos<= "
              f"{int(pos.max())}: max_abs_err {err:.3e} kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({by}); "
              f"device {by_kernel(dev_ms)}", flush=True)
        record("paged_decode_attention_fp8", name,
               [B, H, KVH, D, int(pos.max())], ms, plain_ms, None, bound_ms,
               by, dev_ms)
        if name == "bfloat16" and shape is PAGED_SHAPE:
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                        bound_ms=bound_ms, bound_by=by)
        del kp, vp, ks, vs
    main["max_abs_err"] = worst
    return main


def check_layernorm(dev, flush):
    """K4 forward and backward against the plain versions at BERT-large's
    post-sublayer shape (8 x 512 tokens = 4096 rows, D = 1024, residual,
    eps 1e-12), f32 and bf16 activations with f32 gamma/beta; library
    (near: the residual add is a separate pass): ``F.layer_norm(x + res)``
    forward, and its backward alone through a retained graph; the
    forward also against ``torch.add(x, res)``, which moves its bytes,
    the three timed in ``LN_PAIRS`` interleaved pairs.  Two runs of each
    kernel must be bitwise equal."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.fused_layernorm import (fused_layer_norm_bwd,
                                                     fused_layer_norm_fwd,
                                                     layer_norm_bwd_plain,
                                                     layer_norm_plain)
    rows, D, eps = 4096, 1024, 1e-12
    res_fwd, res_bwd = {}, {}
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        g = torch.Generator(device=dev).manual_seed(3)
        x, res, dy = (torch.randn(rows, D, device=dev, generator=g)
                      .to(dtype) for _ in range(3))
        gamma, beta = (torch.randn(D, device=dev, generator=g)
                       for _ in range(2))
        y = fused_layer_norm_fwd(x, res, gamma, beta, eps)
        y_again = fused_layer_norm_fwd(x, res, gamma, beta, eps)
        got = fused_layer_norm_bwd(x, res, gamma, dy, eps)
        again = fused_layer_norm_bwd(x, res, gamma, dy, eps)
        want_y = layer_norm_plain(x, res, gamma, beta, eps)
        want = layer_norm_bwd_plain(x, res, gamma, dy, eps)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"fused_layer_norm_bwd {name}: two runs differ")
        if not torch.equal(y, y_again):
            fail(f"fused_layer_norm_fwd {name}: two runs differ")
        err_f, ok = max_err(y, want_y, LN_TOL[name])
        if not ok or not bool(torch.isfinite(y).all()):
            fail(f"fused_layer_norm_fwd vs plain {name}: max abs err {err_f}")
        err_b = 0.0
        for a, b, what, tol in zip(got, want, ("dx", "dgamma", "dbeta"),
                                   (LN_TOL[name], LN_PARAM_TOL,
                                    LN_PARAM_TOL)):
            e, ok = max_err(a, b, tol)
            if not ok or not bool(torch.isfinite(a).all()):
                fail(f"fused_layer_norm_bwd vs plain {name}: max |{what}| "
                     f"err {e}")
            err_b = max(err_b, e)
        elem = x.element_size()
        # the library yardstick, weights in the activations' type: the
        # forward without a graph, the backward alone through a retained
        # graph, with the card kept busy while autograd enqueues it
        lx, lres, lg, lb = (t.detach().to(dtype).requires_grad_()
                            for t in (x, res, gamma, beta))
        lib_out = F.layer_norm(lx + lres, (D,), lg, lb, eps)

        def lib_fwd():
            with torch.no_grad():
                return F.layer_norm(x + res, (D,), lg, lb, eps)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (lx, lres, lg, lb), dy,
                                       retain_graph=True)

        y_add = torch.empty_like(x)

        def add():
            return torch.add(x, res, out=y_add)

        for what, kernel, plain, library, nbytes in (
                ("fwd", lambda: fused_layer_norm_fwd(x, res, gamma, beta,
                                                     eps),
                 lambda: layer_norm_plain(x, res, gamma, beta, eps), lib_fwd,
                 3 * rows * D * elem + 2 * D * 4),
                ("bwd", lambda: fused_layer_norm_bwd(x, res, gamma, dy, eps),
                 lambda: layer_norm_bwd_plain(x, res, gamma, dy, eps),
                 lib_bwd, 4 * rows * D * elem + 3 * D * 4)):
            dev_ms = device_ms(kernel, 20, flush)
            plain_ms = time_ms(plain, 10, flush)
            bound_ms, by = bound(nbytes, 10.0 * rows * D, "float32")
            add_ms, pairs = None, ""
            if what == "fwd":
                # the kernel, its library call and x + res (the forward's
                # bytes: read two rows, write one) in turns
                times = interleaved_ms({"kernel": kernel, "library": library,
                                        "add": add}, LN_PAIRS, flush,
                                       cover=1_000_000)
                ms, lib_ms, add_ms = (statistics.median(times[k])
                                      for k in ("kernel", "library", "add"))
                pairs = "; " + "; ".join(
                    ratio_text(times["kernel"], times[k], k)
                    for k in ("library", "add"))
            else:
                ms = time_ms(kernel, 20, flush, cover=1_000_000)
                lib_ms = time_ms(library, 20, flush, cover=2_000_000)
            print(f"fused_layer_norm_{what} {rows}x{D} {name}, residual: "
                  f"max_abs_err {err_f if what == 'fwd' else err_b:.3e} "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
                  f"(near) {lib_ms:.4f} ms"
                  + ("" if add_ms is None else f" torch.add {add_ms:.4f} ms")
                  + f" bound {bound_ms:.4f} ms ({by}; {bound_ms / ms:.1%} of "
                  f"it); device {by_kernel(dev_ms)}{pairs}", flush=True)
            record(f"fused_layer_norm_{what}", name, [rows, D], ms, plain_ms,
                   lib_ms, bound_ms, by, device_ms=dev_ms, add_ms=add_ms)
            out = res_fwd if what == "fwd" else res_bwd
            out.setdefault("max_abs_err", 0.0)
            out["max_abs_err"] = max(out["max_abs_err"],
                                     err_f if what == "fwd" else err_b)
            if name == "bfloat16":            # the K4 path phase's type
                out.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=by)
        del x, res, dy, y, y_again, got, again, want_y, want, lx, lres, \
            lib_out, y_add
    torch.cuda.empty_cache()
    return {"fused_layer_norm_fwd": res_fwd, "fused_layer_norm_bwd": res_bwd}


def check_flash_bwd(dev, flush):
    """The backward kernel against the plain backward at the training
    phase's shape (B=2 x H=32 heads, L=1024, D=128, causal) and a ragged
    one (L=200, D=64); library: the backward of
    ``scaled_dot_product_attention`` alone, through a retained graph,
    with the card kept busy while autograd enqueues it."""
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

            sdpa_out = F.scaled_dot_product_attention(qs, ks, vs,
                                                      is_causal=True)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                sdpa_out, (qs, ks, vs), gs, retain_graph=True), 10, flush,
                cover=2_000_000)
            elem = q.element_size()
            nbytes = 8 * B * H * L * D * elem + 4 * B * H * L  # 5 in, 3 out
            flops = 10.0 * B * H * D * (L * (L + 1) / 2)      # 5 products
            bound_ms, by = bound(nbytes, flops, name)
            print(f"flash_attention_bwd BH={B * H} L={L} D={D} {name}: "
                  f"max_abs_err {err:.3e} kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms sdpa-bwd {lib_ms:.4f} ms "
                  f"({ms / lib_ms:.2f}x sdpa) bound {bound_ms:.4f} ms "
                  f"({by}; {bound_ms / ms:.1%} of it)", flush=True)
            record("flash_attention_bwd", name, [B * H, L, D], ms, plain_ms,
                   lib_ms, bound_ms, by)
            if L == 1024 and name == "float32":   # the training phase's
                main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=by)
            del q, k, v, do, out, lse, got, want, qs, ks, vs, gs, sdpa_out
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


def ratio_text(kernel_ms, other_ms, other):
    """The median and range of kernel / ``other`` by pair, and in how
    many pairs the kernel was ahead."""
    ratios = [k / o for k, o in zip(kernel_ms, other_ms)]
    return (f"kernel/{other} median {statistics.median(ratios):.4f} (range "
            f"{min(ratios):.4f}-{max(ratios):.4f}, kernel ahead in "
            f"{sum(r < 1 for r in ratios)} of {len(ratios)} pairs)")


def pair_summary(kernel_ms, library_ms, nbytes, bound_ms):
    """(text, kernel median, library median) of interleaved pairs: both
    medians, the median and range of kernel / library by pair, the
    kernel's achieved TB/s and its share of the bound."""
    ratios = [k / l for k, l in zip(kernel_ms, library_ms)]
    ms = statistics.median(kernel_ms)
    lib_ms = statistics.median(library_ms)
    text = (f"{len(ratios)} pairs: kernel median {ms:.4f} ms, library "
            f"{lib_ms:.4f} ms, kernel/library median "
            f"{statistics.median(ratios):.4f} "
            f"(range {min(ratios):.4f}-{max(ratios):.4f}, kernel ahead in "
            f"{sum(r < 1 for r in ratios)}), {nbytes / ms / 1e9:.3f} TB/s, "
            f"{bound_ms / ms:.1%} of the bound")
    return text, ms, lib_ms


def update_case(rule, n, dev):
    """p, the gradient and the rule's state of ``n`` elements from a
    seeded generator."""
    import torch
    g_ = torch.Generator(device=dev).manual_seed(n % 1009)
    p = torch.randn(n, device=dev, generator=g_)
    grad = torch.randn(n, device=dev, generator=g_)
    if rule.startswith("adam"):
        return p, grad, {"m": torch.randn(n, device=dev, generator=g_) * 0.1,
                         "v": torch.rand(n, device=dev, generator=g_) * 0.01,
                         "t": 3}
    return p, grad, {"mom": torch.randn(n, device=dev, generator=g_) * 0.1}


def copy_at(t, offset):
    """A copy of the flat ``t`` that starts ``offset`` elements into its
    own allocation."""
    import torch
    return torch.empty(t.numel() + offset, dtype=t.dtype,
                       device=t.device)[offset:].copy_(t)


def check_updates(dev, flush, n_big):
    """K1 (momentum, NAG) and K2 (Adam, AdamW, with clip) against the
    plain rule on the training phase's bucket of ``n_big`` elements, on
    buckets of 5000 and 5003 (a scalar tail) and on views one element
    into their allocations (a scalar head).  The kernel updates copies of
    p and the state in place; the plain rule, elementwise, runs on chunks
    of the same inputs.  At ``n_big`` the kernel and its library call
    are timed in ``UPDATE_PAIRS`` interleaved pairs."""
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
        for n, offset in ((n_big, 0), (5000, 0), (5003, 0), (5000, 1),
                          (5003, 1)):
            p, grad, s = update_case(rule, n, dev)
            _, apply = fused_bucket_rule(rule, clip_gradient=clip, **hyper)
            _, plain = fused_rule(rule, clip_gradient=clip, **hyper)
            # the kernel's copies of p and the state, every stream (the
            # gradient too) ``offset`` elements into its allocation
            kp = copy_at(p, offset)
            ks = {k: copy_at(v, offset) if torch.is_tensor(v) else v
                  for k, v in s.items()}
            kp, ks = apply(kp, copy_at(grad, offset) if offset else grad, ks,
                           lr, wd, rescale)                 # in place
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
                        fail(f"{kernel_name} ({rule}) vs plain at n={n}, "
                             f"offset {offset}: max abs err {e}")
                    err = max(err, e)
            del want_p, want_s, pairs
            res = results.setdefault(kernel_name, {"max_abs_err": 0.0})
            res["max_abs_err"] = max(res["max_abs_err"], err)
            if offset or n == 5003:
                print(f"{kernel_name} ({rule}, clip) n={n} offset {offset}: "
                      f"max_abs_err {err:.3e}", flush=True)
                continue

            def plain_pass():
                for c in _chunks(n):    # each chunk's result is dropped
                    plain(p[c], grad[c], {
                        k: v[c] if torch.is_tensor(v) else v
                        for k, v in s.items()}, lr, wd, rescale)

            def kernel():
                apply(kp, grad, ks, lr, wd, rescale)

            step = torch.tensor(3.0, device=dev)

            def library():
                _library_update(rule, hyper, kp, grad, ks, lr, wd, step)

            per_elem = 28 if kernel_name == "fused_adam_update" else 20
            flops = (20.0 if kernel_name == "fused_adam_update" else 8.0) * n
            bound_ms, by = bound(per_elem * n, flops, "float32")
            plain_ms = time_ms(plain_pass, 3, flush)
            pairs_text = ""
            if n == n_big:
                times = interleaved_ms({"kernel": kernel,
                                        "library": library}, UPDATE_PAIRS,
                                       flush)
                pairs_text, ms, lib_ms = pair_summary(
                    times["kernel"], times["library"], per_elem * n,
                    bound_ms)
                pairs_text = "; " + pairs_text
            else:
                ms = time_ms(kernel, 10, flush)
                lib_ms = time_ms(library, 10, flush)
            print(f"{kernel_name} ({rule}, clip) n={n}: max_abs_err "
                  f"{err:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                  f"library (near) {lib_ms:.4f} ms bound {bound_ms:.4f} ms "
                  f"({by}){pairs_text}", flush=True)
            record(kernel_name, f"float32 {rule}", [n], ms, plain_ms, lib_ms,
                   bound_ms, by)
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
# phase 7: fp8 KV serving at full width and a long context
# ----------------------------------------------------------------------

def _greedy(eng, slot, prompt, n):
    """Prefill and ``n`` greedy decode steps: (fed tokens, logits)."""
    tok, last = eng.prefill(slot, prompt)
    fed, logits = list(prompt) + [tok], [last.float()]
    for _ in range(n):
        pos = len(fed) - 1
        if not eng.reserve(slot, pos):
            fail("KV pool exhausted")
        nxt, lg = eng.decode([(slot, fed[-1], pos)])
        fed.append(int(nxt[0]))
        logits.append(lg[0].float())
    return fed, logits


def _replay(eng, slot, prompt, fed, n):
    """Teacher-force ``fed`` through ``eng``: its logits at the same
    positions."""
    _, last = eng.prefill(slot, prompt)
    logits = [last.float()]
    for j in range(n):
        pos = len(prompt) + j
        if not eng.reserve(slot, pos):
            fail("KV pool exhausted")
        _, lg = eng.decode([(slot, fed[pos], pos)])
        logits.append(lg[0].float())
    return logits


def serve_llama3_8b_fp8(dev, card):
    """Llama-3-8B bf16, 32 layers, ``kv_dtype="fp8"``, max_batch 16,
    max_context 4096 (4097 blocks); a ``ContinuousBatcher`` serves 32
    greedy requests with prompts of 256-3800 tokens and 32 new tokens
    each.  Afterwards, outside the counted window, one request's fp8
    decode logits against a bf16-pool engine on the same net
    (teacher-forced; printed, not a limit)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama3_8b
    from mxnet_tpu_torch.ops.quant_kv import kv_block_bytes
    from mxnet_tpu_torch.serving import (ContinuousBatcher, InferenceEngine,
                                         Request)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    net = llama3_8b(device=dev, dtype=torch.bfloat16, seed=0)
    cfg = net.cfg
    eng = InferenceEngine(net, kv_dtype="fp8", max_batch=16, block_size=16,
                          max_context=4096, device=dev)
    eng.warmup()
    setup_s = time.perf_counter() - t0
    c = eng.cache
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in (c.k_pool, c.v_pool, c.k_scale, c.v_scale))
    if pool_bytes != c.num_blocks * c.block_nbytes:
        fail(f"fp8 pool holds {pool_bytes} bytes, block_nbytes says "
             f"{c.num_blocks * c.block_nbytes}")
    bf16_bytes = c.num_blocks * kv_block_bytes(
        cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, c.block_size, "bf16")
    finite, step_s = [], []
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
    lengths = rng.randint(256, 3801, 32)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in lengths]
    batcher = ContinuousBatcher(eng)
    ops.reset_launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for p in prompts:
        batcher.submit(Request(p, 32))
    stats = batcher.run()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = read_launches("fp8 serving", {
        "flash_attention_fwd": cfg.num_layers * eng.stats["prefill_calls"],
        "paged_decode_attention_fp8":
            cfg.num_layers * eng.stats["decode_calls"]})
    if len(batcher.finished) != 32 or any(
            len(r.generated) != 32 for r in batcher.finished):
        fail("fp8 serving: not every request finished with 32 tokens")
    if not bool(torch.stack(finite).all()):
        fail("non-finite logits on the fp8 serving path")
    eng.prefill, eng.decode = prefill, decode
    ttft = sorted(r.ttft() for r in batcher.finished)
    tokens = stats["tokens_generated"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"serving llama3_8b bf16, fp8 KV cache, max_context 4096, on "
          f"{card}: {len(lengths)} requests, prompts {int(lengths.min())}-"
          f"{int(lengths.max())} tokens, {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.1f} tokens/s; TTFT p50 "
          f"{ttft[len(ttft) // 2] * 1e3:.1f} ms; decode step median "
          f"{sorted(step_s)[len(step_s) // 2] * 1e3:.2f} ms over "
          f"{len(step_s)} steps; peak memory {peak_gb:.2f} GB; pool "
          f"{c.num_blocks} blocks, {pool_bytes} bytes fp8 with scales "
          f"against {bf16_bytes} bf16; set-up {setup_s:.1f} s; launches "
          f"{launches}", flush=True)
    # drift of one request's fp8 decode logits against a bf16 pool
    ref = InferenceEngine(net, kv_dtype="bf16", max_batch=2, block_size=16,
                          max_context=1024, device=dev)
    prompt = prompts[0][:900].tolist()
    fed, lg8 = _greedy(eng, "drift", prompt, 16)
    lg16 = _replay(ref, "drift", prompt, fed, 16)
    drift = max(float((a - b).abs().max()) for a, b in zip(lg8[1:],
                                                            lg16[1:]))
    top = max(float(a.abs().max()) for a in lg16[1:])
    print(f"fp8 vs bf16 KV pool, {len(prompt)}-token prompt, 16 "
          f"teacher-forced decode steps: max |logit| drift {drift:.4e} "
          f"(largest |logit| {top:.4e}); prefill logits equal: "
          f"{bool(torch.equal(lg8[0], lg16[0]))}", flush=True)
    del eng, ref, net, batcher, prefill, decode, prefill_checked, \
        decode_checked
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phases 5 and 6: card against CPU on the full-width geometry, with
# f32 and with fp8 KV pools
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
    card_vs_cpu_fp8(dev, on_card, on_cpu, prompt)


def card_vs_cpu_fp8(dev, on_card, on_cpu, prompt):
    """fp8 KV pools on phase 5's nets: prefill the 40-token prompt and
    run 8 decode steps on the card, and teacher-force the card's tokens
    through the CPU engine.  Limits: decode logits within 2e-2, the card's
    fp8-vs-f32-pool drift above 0, and, on the rows whose inputs no pool
    read has touched (layer 0 at every position, later layers at the
    prompt's, which prefill computes from the fresh K/V), codes identical
    in 99.9% of elements and scales within 1e-5 relative.  Later layers'
    decode rows are computed from attention over fp8 rows, so one code
    that rounds the other way upstream moves them further (printed)."""
    import torch
    from mxnet_tpu_torch.serving import InferenceEngine
    kw = dict(max_batch=2, block_size=16, max_context=64)
    e_card = InferenceEngine(on_card, kv_dtype="fp8", device=dev, **kw)
    e_cpu = InferenceEngine(on_cpu, kv_dtype="fp8", device="cpu", **kw)
    fed, l_card = _greedy(e_card, 0, prompt, 8)
    l_cpu = _replay(e_cpu, 0, prompt, fed, 8)
    l_f32 = _replay(InferenceEngine(on_card, device=dev, **kw), 0, prompt,
                    fed, 8)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(l_card,
                                                               l_cpu))
    drift = max(float((a - b).abs().max()) for a, b in zip(l_card, l_f32))
    n = len(prompt) + 8                  # positions written by both
    table = e_card.cache.table(0)
    if table != e_cpu.cache.table(0):
        fail(f"fp8 card vs cpu: block tables {table} vs "
             f"{e_cpu.cache.table(0)}")
    layers = e_card.cache.num_layers
    fresh = torch.zeros(layers, n, dtype=torch.bool)
    fresh[0] = True
    fresh[:, :len(prompt)] = True

    def rows(a):                         # (layers, n, ...) of slot 0
        return a[:, table].flatten(1, 2)[:, :n].cpu()

    same, total, scale_err = [0, 0], [0, 0], [0.0, 0.0]
    for a, b in ((e_card.cache.k_pool, e_cpu.cache.k_pool),
                 (e_card.cache.v_pool, e_cpu.cache.v_pool)):
        eq = rows(a.view(torch.uint8)) == rows(b.view(torch.uint8))
        for i, sel in enumerate((fresh, torch.ones_like(fresh))):
            same[i] += int(eq[sel].sum())
            total[i] += eq[sel].numel()
    for a, b in ((e_card.cache.k_scale, e_cpu.cache.k_scale),
                 (e_card.cache.v_scale, e_cpu.cache.v_scale)):
        rel = (rows(a) - rows(b)).abs() / rows(b)
        for i, sel in enumerate((fresh, torch.ones_like(fresh))):
            scale_err[i] = max(scale_err[i], float(rel[sel].max()))
    frac = [a / b for a, b in zip(same, total)]
    print(f"card vs cpu, fp8 KV (2 layers, full width, fp32, 8 "
          f"teacher-forced decode steps): max |logit| diff {err:.3e} "
          f"(limit {FP8_LOGIT_ATOL}); card fp8-vs-f32 drift {drift:.3e} "
          f"(must be > 0); rows from fresh inputs: codes identical "
          f"{same[0]}/{total[0]} = {frac[0]:.6f} (limit {FP8_CODES_SAME}), "
          f"max scale rel diff {scale_err[0]:.3e} (limit {FP8_SCALE_RTOL}); "
          f"all written rows: codes identical {same[1]}/{total[1]} = "
          f"{frac[1]:.6f}, max scale rel diff {scale_err[1]:.3e}",
          flush=True)
    if not (err <= FP8_LOGIT_ATOL and frac[0] >= FP8_CODES_SAME
            and scale_err[0] <= FP8_SCALE_RTOL and drift > 0):
        fail("fp8 KV on the card and on the CPU disagree")


# ----------------------------------------------------------------------
# phase 8: training at full width
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
# phase 9: training, card against CPU on the full-width geometry
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


# ----------------------------------------------------------------------
# phase 10: the fused LayerNorm op path (K4)
# ----------------------------------------------------------------------

def layernorm_path(dev, card):
    """BERT-large's 24 layers x 2 post-sublayer LayerNorms
    (``bert_24_1024_16``: batch 8 x 512 tokens = 4096 rows, D = 1024),
    each ``fused_layer_norm(x_i, gamma_i, beta_i, residual=h_i, eps=1e-12)``
    on bf16 activations with f32 parameters, then one backward through
    autograd, twice; the second pass is counted and timed: 48 forward and
    48 backward launches, every gradient finite and within phase 3's
    tolerances of the plain backward.  A further pass under
    ``torch.profiler`` gives the device time by kernel, printed beside
    the host clock."""
    import torch
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.ops import fused_layer_norm
    from mxnet_tpu_torch.ops.fused_layernorm import layer_norm_bwd_plain
    n, rows, D, eps = 48, 4096, 1024, 1e-12
    g = torch.Generator(device=dev).manual_seed(10)
    sets = []
    for _ in range(n):
        x, h, dy = (torch.randn(rows, D, device=dev, generator=g)
                    .to(torch.bfloat16) for _ in range(3))
        gamma = 1.0 + 0.1 * torch.randn(D, device=dev, generator=g)
        beta = 0.1 * torch.randn(D, device=dev, generator=g)
        sets.append([t.requires_grad_() for t in (x, h, gamma, beta)] + [dy])

    def run():
        """Forward and backward of the 48 norms: (fwd s, fwd + bwd s)."""
        for t in (t for st in sets for t in st[:4]):
            t.grad = None
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        outs = [fused_layer_norm(x, gamma, beta, residual=h, eps=eps)
                for x, h, gamma, beta, _ in sets]
        torch.cuda.synchronize(dev)
        fwd_s = time.perf_counter() - t0
        torch.autograd.backward(outs, [st[4] for st in sets])
        torch.cuda.synchronize(dev)
        return fwd_s, time.perf_counter() - t0

    run()                       # warm: the allocator's blocks exist after
    ops.reset_launches()
    fwd_s, both_s = run()
    launches = read_launches("layernorm op", {"fused_layer_norm_fwd": n,
                                              "fused_layer_norm_bwd": n})
    worst = {"dx": 0.0, "dgamma": 0.0, "dbeta": 0.0}
    for x, h, gamma, beta, dy in sets:
        want = layer_norm_bwd_plain(x.detach(), h.detach(), gamma.detach(),
                                    dy, eps)
        if not torch.equal(h.grad, x.grad):
            fail("layernorm op: dres differs from dx")
        for got, w, what, tol in zip((x.grad, gamma.grad, beta.grad), want,
                                     worst, (LN_TOL["bfloat16"],
                                             LN_PARAM_TOL, LN_PARAM_TOL)):
            e, ok = max_err(got, w, tol)
            if not ok or not bool(torch.isfinite(got).all()):
                fail(f"layernorm op: {what} vs plain, max abs err {e}")
            worst[what] = max(worst[what], e)
    busy = device_ms(run, 1)
    print(f"layernorm op, bert_24_1024_16 post-sublayer shape, {n} x "
          f"fused_layer_norm({rows}x{D} bf16, f32 gamma/beta, residual) on "
          f"{card}: forward {fwd_s * 1e3:.2f} ms, forward + backward "
          f"{both_s * 1e3:.2f} ms (host clock, second pass); device time "
          f"of a pass by kernel (profiler) {by_kernel(busy)}, "
          f"{sum(busy.values()):.4f} ms in all; max err vs plain {worst}; "
          f"launches {launches}", flush=True)
    del sets
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
                  "paged_attention", "fused_update", "fused_layernorm"])
    print(f"build: {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}",
          flush=True)
    flash_kernel_report()
    ptxas_report(["paged_attention", "fused_layernorm", "fused_update"])

    # phase 3: kernels against plain versions
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    checks = {"flash_attention_fwd": check_flash(dev, flush),
              "paged_decode_attention": check_paged(dev, flush),
              "paged_decode_attention_fp8": check_paged_fp8(dev, flush),
              "flash_attention_bwd": check_flash_bwd(dev, flush)}
    checks.update(check_layernorm(dev, flush))
    checks.update(check_updates(dev, flush, train_param_count()))
    del flush
    torch.cuda.empty_cache()

    # phases 4-10: each path from zeroed launch counters
    by_path = {"serving": serve_llama3_8b(dev, card)}
    card_vs_cpu(dev)
    by_path["serving_fp8"] = serve_llama3_8b_fp8(dev, card)
    by_path["training"] = train_llama3_8b(dev, card)
    by_path["training_card_vs_cpu"] = train_card_vs_cpu(dev)
    by_path["layernorm_op"] = layernorm_path(dev, card)

    kernels = []
    for name, src, tpu in (
            ("flash_attention_fwd", "flash_attention.cu",
             "mxnet_tpu/ops/flash_attention.py:51"),
            ("flash_attention_bwd", "flash_attention_bwd.cu",
             "mxnet_tpu/ops/flash_attention.py:174"),
            ("paged_decode_attention", "paged_attention.cu",
             "mxnet_tpu/ops/paged_attention.py:89"),
            ("paged_decode_attention_fp8", "paged_attention.cu",
             "mxnet_tpu/ops/paged_attention.py:89"),
            ("fused_sgd_update", "fused_update.cu",
             "mxnet_tpu/ops/fused_update.py:95"),
            ("fused_adam_update", "fused_update.cu",
             "mxnet_tpu/ops/fused_update.py:118"),
            ("fused_layer_norm_fwd", "fused_layernorm.cu",
             "mxnet_tpu/ops/fused_layernorm.py:79"),
            ("fused_layer_norm_bwd", "fused_layernorm.cu",
             "mxnet_tpu/ops/fused_layernorm.py:97")):
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
    print(json.dumps({"kernel_rows": ROWS}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
