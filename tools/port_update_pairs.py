#!/usr/bin/env python3
"""Time the port's bucket update kernels K1 and K2 against PyTorch's fused
optimizer calls, in interleaved pairs, on one NVIDIA GPU.

    python3 tools/port_update_pairs.py [--checkout DIR] [--pairs 20]
                                       [--variants]

For AdamW and SGD with momentum 0.9, both with clip, on the training
phase's flat bucket (``chip_smoke.train_param_count()`` elements:
Llama-3-8B's width at 4 layers), the kernel (through the public
``fused_bucket_rule``) and ``torch._fused_adamw_`` / ``torch._fused_sgd_``
are timed in turns (kernel, library, library, kernel, ...), each call
alone between CUDA events; the medians, the median and range of kernel /
library by pair, the achieved TB/s and the share of the bound are
printed.  ``--checkout DIR`` runs the port of another checkout (an
unpacked older commit) the same way.  ``--variants`` builds
``tools/update_sweep.cu``, checks each of its layouts of the kernel
against the plain rule on small buckets (aligned, and one element into
their allocations), and times them in the same turns, beside PyTorch's
``copy_`` and ``add`` over the same buffers (the HBM rate a plain
stream reaches).  The card's name and power limit come first.
"""
import argparse
import ctypes
import importlib.util
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (kind, a, b) of tools/update_sweep.cu, and whether the grid is one CTA
# a chunk instead of the resident CTAs
VARIANTS = [(0, u, c, False) for u in (1, 2, 4, 8) for c in (0, 1)] + \
    [(0, u, 0, True) for u in (1, 2, 4, 8)] + \
    [(1, v, st, False) for v, st in ((1, 4), (1, 8), (2, 2), (2, 3), (2, 4),
                                     (4, 2), (4, 3))] + \
    [(2, 2, 3, False), (2, 4, 3, False), (3, 2, 0, False),
     (3, 4, 0, False)]
CASES = [("adamw", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
         ("sgd", {"momentum": 0.9})]
LR, WD, RESCALE, CLIP = 1e-3, 0.1, 0.5, 1.0


def label(kind, a, b, full_grid=False):
    if kind == 0:
        layout = "a chunk a CTA" if full_grid else \
            "contiguous ranges" if b else "grid-stride"
        return f"vector U={a}, fixed chunks, {layout}"
    if kind == 3:
        return f"vector U={a}, chunks drawn in order"
    order = "drawn in order" if kind == 2 else "fixed"
    return f"bulk ring V={a}, {b} stages, tiles {order}"


def build_sweep():
    """The sweep library, built with the port's nvcc flags; prints every
    instance's registers and spills."""
    from mxnet_tpu_torch.ops import _build
    out = os.path.join(_build.BUILD_DIR, "libupdate_sweep.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    run = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
         os.path.join(REPO, "tools", "update_sweep.cu")],
        capture_output=True, text=True, timeout=900)
    if run.returncode != 0:
        sys.exit(f"update_sweep.cu: nvcc exited {run.returncode}\n"
                 f"{run.stdout}{run.stderr}")
    entries = (run.stdout + run.stderr).split(
        "Compiling entry function '")[1:]
    names = [e.split("'")[0] for e in entries]
    filt = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    if os.path.exists(filt):
        dem = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if dem.returncode == 0:
            names = dem.stdout.splitlines()
    for name, entry in zip(names, entries):
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", entry)
        name = re.sub(r"\(anonymous namespace\)::|<unnamed>::|^void ", "",
                      name)
        name = re.sub(r"\((?:[^()]|\([^()]*\))*\)$", "", name)
        print(f"ptxas {name}: {regs[1]} registers, {spill[1]}/{spill[2]} "
              f"bytes spill stores/loads", flush=True)
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_int64
    lib = ctypes.CDLL(out)
    # kind, a, b, rule; the streams, the plan and the counters; lr, wd,
    # rescale, clip, momentum, t, the betas, eps; device, stream
    lib.sweep_update.argtypes = [I] * 4 + [P] * 4 + [L] * 4 + [I, P] + \
        [F] * 5 + [I] + [F] * 5 + [I, P]
    lib.sweep_resident.argtypes = [ctypes.c_int] * 5
    return lib


def variant_call(lib, variant, rule, hyper, p, g, s, counters):
    """A callable that runs layout ``variant`` of the kernel for ``rule``
    with clip on p, g and the state in place."""
    import torch
    from mxnet_tpu_torch.ops.fused_update import update_plan
    kind, a, b, full_grid = variant
    code = {"sgd": 1, "adamw": 4}[rule]
    dev = p.device.index
    resident = lib.sweep_resident(kind, a, b, code, dev)
    if resident < 1:
        sys.exit(f"sweep_resident{variant[:3]} for rule {code}: {resident}")
    streams = [p, g] + [s[k] for k in ("mom", "m", "v") if k in s]
    ptrs = [x.data_ptr() for x in streams]
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    # a grid of one CTA a chunk: no cap from the resident CTAs
    plan = update_plan(ptrs, p.numel(), sms, 1 << 40 if full_grid
                       else resident)
    b1, b2 = hyper.get("beta1", 0.0), hyper.get("beta2", 0.0)
    args = (kind, a, b, code, *ptrs, *[None] * (4 - len(ptrs)), p.numel(),
            *plan, counters.data_ptr(), LR, WD, RESCALE, CLIP,
            hyper.get("momentum", 0.0), int(s.get("t", 0)) + 1, b1, b2,
            float(1 - b1), float(1 - b2), hyper.get("epsilon", 0.0), dev,
            torch.cuda.current_stream(p.device).cuda_stream)

    def call():
        err = lib.sweep_update(*args)
        if err:
            raise RuntimeError(f"sweep_update {label(*variant)}: CUDA error "
                               f"{err}")
    return call


def check_variants(lib, dev, counters):
    """Every layout against the plain rule at n = 1 << 20 + 3, aligned and
    one element into every allocation (a scalar head and tail)."""
    import chip_smoke
    import torch
    from mxnet_tpu_torch.optimizer import fused_rule
    n = (1 << 20) + 3
    for rule, hyper in CASES:
        _, plain = fused_rule(rule, clip_gradient=CLIP, **hyper)
        for variant in VARIANTS:
            for offset in (0, 1):
                p, g, s = chip_smoke.update_case(rule, n, dev)
                want_p, want_s = plain(p, g, s, LR, WD, RESCALE)
                kp = chip_smoke.copy_at(p, offset)
                ks = {k: chip_smoke.copy_at(v, offset) if torch.is_tensor(v)
                      else v for k, v in s.items()}
                variant_call(lib, variant, rule, hyper, kp,
                             chip_smoke.copy_at(g, offset), ks, counters)()
                torch.cuda.synchronize()
                for got, want in [(kp, want_p)] + [
                        (ks[k], want_s[k]) for k in ks
                        if torch.is_tensor(ks[k])]:
                    err, ok = chip_smoke.max_err(got, want,
                                                 chip_smoke.UPDATE_TOL)
                    if not ok:
                        sys.exit(f"{label(*variant)} {rule} offset "
                                 f"{offset}: max abs err {err}")
    print(f"every layout within {chip_smoke.UPDATE_TOL} of the plain rule "
          f"at n={n}, offsets 0 and 1", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=REPO,
                    help="root of the checkout whose port is timed")
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--variants", action="store_true",
                    help="also time the layouts of tools/update_sweep.cu")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the kernels run on the card")
    # the port from the checkout; chip_smoke (its timing and cases) from
    # this repository, whatever the checkout holds
    sys.path.insert(0, os.path.abspath(args.checkout))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = sys.modules["chip_smoke"] = \
        importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from mxnet_tpu_torch.ops.fused_update import fused_bucket_rule
    print(f"{chip_smoke.card_line()}; port from {args.checkout}", flush=True)
    dev = torch.device("cuda", 0)
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    lib = None
    if args.variants:
        lib = build_sweep()
        check_variants(lib, dev, counters)
    n = chip_smoke.train_param_count()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    for rule, hyper in CASES:
        p, g, s = chip_smoke.update_case(rule, n, dev)
        _, apply = fused_bucket_rule(rule, clip_gradient=CLIP, **hyper)
        lr_dev, ks = chip_smoke.device_scalars(LR, s, dev)
        step = torch.tensor(4.0, device=dev)
        fns = {"kernel": lambda: apply(p, g, ks, lr_dev, WD, RESCALE),
               "library": lambda: chip_smoke._library_update(
                   rule, hyper, p, g, s, LR, WD, step)}
        per_elem = 28 if rule == "adamw" else 20
        nbytes = {name: per_elem * n for name in fns}
        if lib:
            for variant in VARIANTS:
                name = label(*variant)
                fns[name] = variant_call(lib, variant, rule, hyper, p, g, s,
                                         counters)
                nbytes[name] = per_elem * n
            # PyTorch's own streaming passes over the same buffers: the
            # HBM rate a plain copy (8 bytes an element) and add (12) reach
            # beside the update's mix of reads and writes
            state = s["m"] if "m" in s else s["mom"]
            fns["torch copy_"] = lambda: p.copy_(g)
            fns["torch add"] = lambda: torch.add(p, g, out=state)
            nbytes["torch copy_"] = 8 * n
            nbytes["torch add"] = 12 * n
        times = chip_smoke.interleaved_ms(fns, args.pairs, flush)
        for name, ms in times.items():
            if name != "library":
                bound_ms, _ = chip_smoke.bound(nbytes[name], 0, "float32")
                text, _, _ = chip_smoke.pair_summary(
                    ms, times["library"], nbytes[name], bound_ms)
                print(f"{rule} + clip, n={n}, {name} "
                      f"({nbytes[name] // n} B/elem): {text}", flush=True)
        del p, g, s, fns
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
