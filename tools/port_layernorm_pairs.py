#!/usr/bin/env python3
"""Time the port's LayerNorm forward kernel (K4) in interleaved pairs on
one NVIDIA GPU: against its library call, against ``torch.add``, against
another checkout's kernel, and against the layouts of its row kernel.

    python3 tools/port_layernorm_pairs.py [--checkout DIR] [--pairs 20]
                                          [--variants] [--flush read]

At ``chip_smoke.py`` phase 3's shape (4096 x 1024 with residual, eps
1e-12; bf16 activations with f32 gamma/beta, then f32), the port's
``fused_layer_norm_fwd``, ``F.layer_norm(x + res)`` (the library call,
near: the add is its own pass) and ``torch.add(x, res, out=y)`` (the
forward's bytes: two rows read, one written) are timed in turns (in
order on even rounds, reversed on odd ones), each call alone between
CUDA events with the L2 cache flushed before it.  ``--checkout DIR``
adds the forward of the port in another checkout (an unpacked older
commit, imported under another package name, its kernels built in its
own tree) to the same rounds.  ``--variants`` builds
``tools/layernorm_sweep.cu`` (the row kernel, from the port's pieces, in
each layout: fixed strides over a plain or a persistent grid, or rows
drawn from a counter; gamma and beta in shared memory or in registers;
the next row's loads first or not; a bound of 3 or 4 CTAs a SM on the
registers or none), prints each instance's registers, spills and
resident CTAs, checks each against the plain version and the port's
kernel, and adds them to the rounds.  For each timed call the median,
the achieved TB/s, the share of the bound, and the median and range of
kernel / that call by pair are printed.  Last, the device time by kernel
(``torch.profiler``) of one pass of ``chip_smoke.py`` phase 10 (48 x
``fused_layer_norm`` forward and backward at 4096 x 1024 bf16, f32
gamma/beta, residual) through this port and the other checkout's, in
the order this, other, other, this.  ``--flush read`` evicts the L2
cache by reading a 128 MB buffer instead of writing it (as
``chip_smoke.py`` does), so the timed call finds clean lines and no
write-back of the flush's own data.  The card's name and power limit
come first.
"""
import argparse
import ctypes
import importlib
import importlib.util
import os
import re
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, D, EPS = 4096, 1024, 1e-12
# (layout code of tools/layernorm_sweep.cu, grid, CTAs a SM that ptxas
# leaves room for): code = grid kind * 4 + gamma/beta in registers * 2 +
# prefetch; "plain" is a CTA per 8 rows, "resident" the resident CTAs on
# every SM (or fewer); with gamma/beta in registers only 1 (unbounded)
VARIANTS = [(code, grid, ctas) for code in range(8)
            for grid in (("plain", "resident") if code < 4 else
                         ("resident",))
            for ctas in ((1,) if code & 2 else (1, 3, 4))]


def label(code, grid, ctas):
    rows = "rows drawn in order" if code >= 4 else \
        f"fixed strides, {grid} grid"
    gb = "gamma/beta in registers" if code & 2 else "gamma/beta in smem"
    bound = f", launch bound {ctas} CTAs" if ctas > 1 else ""
    return f"{rows}, {gb}{', prefetch' if code & 1 else ''}{bound}"


def build_sweep():
    """The sweep library, built with the port's nvcc flags; prints every
    instance's registers and spills."""
    from mxnet_tpu_torch.ops import _build
    out = os.path.join(_build.BUILD_DIR, "libln_sweep.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    run = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
         os.path.join(REPO, "tools", "layernorm_sweep.cu")],
        capture_output=True, text=True, timeout=900)
    if run.returncode != 0:
        sys.exit(f"layernorm_sweep.cu: nvcc exited {run.returncode}\n"
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
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sweep_ln_fwd.argtypes = [I, I, P, P, P, P, P, P, I, I, I, I,
                                 ctypes.c_float, I, P]
    lib.sweep_ln_fwd_resident.argtypes = [I, I, I, I, I]
    return lib


def variant_call(lib, variant, x, res, gamma, beta, y, counters):
    """A callable that runs layout ``variant`` into ``y``, and its CTAs
    a SM."""
    import torch
    dev = x.device.index
    dtype = 0 if x.dtype == torch.float32 else 1
    code, grid, ctas_bound = variant
    resident = lib.sweep_ln_fwd_resident(code, ctas_bound, D, dtype, dev)
    if resident < 1:
        sys.exit(f"sweep_ln_fwd_resident{variant}: {resident}")
    rows = x.numel() // D
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ctas = -(-rows // 8)
    if grid == "resident":
        ctas = min(ctas, sms * resident)
    args = (code, ctas_bound, x.data_ptr(), res.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), y.data_ptr(), counters.data_ptr(), rows, D,
            ctas, dtype, EPS, dev,
            torch.cuda.current_stream(x.device).cuda_stream)

    def call():
        err = lib.sweep_ln_fwd(*args)
        if err:
            raise RuntimeError(f"sweep_ln_fwd {label(*variant)}: CUDA "
                               f"error {err}")
    call.tensors = (x, res, gamma, beta, y, counters)   # args hold pointers
    return call, resident


class ReadFlush:
    """Evicts the L2 cache by reading ``buf`` (``zero_`` is the name
    ``chip_smoke.interleaved_ms`` calls): the lines it leaves are
    clean."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        self.buf.amax()


def load_port(root, name):
    """The ``mxnet_tpu_torch`` package of the checkout at ``root``,
    imported as ``name``."""
    pkg = os.path.join(os.path.abspath(root), "mxnet_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    sys.modules[name] = mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.fused_layernorm")


def op_device_ms(ln, n=48):
    """{kernel: device ms} of one pass of phase 10's op path through the
    fused LayerNorm module ``ln``: ``n`` forwards of ``fused_layer_norm``
    with a residual, then one backward through autograd."""
    import torch
    import chip_smoke
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(10)
    sets = []
    for _ in range(n):
        x, h, dy = (torch.randn(ROWS, D, device=dev, generator=g)
                    .to(torch.bfloat16) for _ in range(3))
        gamma = 1.0 + 0.1 * torch.randn(D, device=dev, generator=g)
        beta = 0.1 * torch.randn(D, device=dev, generator=g)
        sets.append([t.requires_grad_() for t in (x, h, gamma, beta)] + [dy])

    def run():
        for t in (t for st in sets for t in st[:4]):
            t.grad = None
        outs = [ln.fused_layer_norm(x, gamma, beta, residual=h, eps=EPS)
                for x, h, gamma, beta, _ in sets]
        torch.autograd.backward(outs, [st[4] for st in sets])
    return chip_smoke.device_ms(run, 1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", help="root of another checkout whose "
                    "forward kernel is timed beside this one's")
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--variants", action="store_true",
                    help="also time the layouts of tools/layernorm_sweep.cu")
    ap.add_argument("--flush", choices=("write", "read"), default="write",
                    help="evict the L2 cache by writing (chip_smoke.py's "
                    "way) or by reading a 128 MB buffer")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the kernels run on the card")
    sys.path.insert(0, REPO)
    import chip_smoke
    from mxnet_tpu_torch.ops.fused_layernorm import (fused_layer_norm_fwd,
                                                     layer_norm_plain)
    print(f"{chip_smoke.card_line()}; port from {REPO}"
          + (f", other checkout {args.checkout}" if args.checkout else ""),
          flush=True)
    other = load_port(args.checkout, "other_port") if args.checkout \
        else None
    lib = build_sweep() if args.variants else None
    dev = torch.device("cuda", 0)
    flush = torch.zeros(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    if args.flush == "read":
        flush = ReadFlush(flush)
    print(f"L2 flushed by {args.flush}ing 128 MB before each call",
          flush=True)
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    for name in ("bfloat16", "float32"):
        dtype = getattr(torch, name)
        g = torch.Generator(device=dev).manual_seed(3)
        x, res = (torch.randn(ROWS, D, device=dev, generator=g).to(dtype)
                  for _ in range(2))
        gamma, beta = (torch.randn(D, device=dev, generator=g)
                       for _ in range(2))
        lg, lb = gamma.to(dtype), beta.to(dtype)
        y_add = torch.empty_like(x)
        want = layer_norm_plain(x, res, gamma, beta, EPS)
        mine = fused_layer_norm_fwd(x, res, gamma, beta, EPS)
        fns = {"kernel": lambda: fused_layer_norm_fwd(x, res, gamma, beta,
                                                      EPS),
               "library": lambda: F.layer_norm(x + res, (D,), lg, lb, EPS),
               "torch.add": lambda: torch.add(x, res, out=y_add)}
        if other is not None:
            theirs = other.fused_layer_norm_fwd(x, res, gamma, beta, EPS)
            err, ok = chip_smoke.max_err(theirs, want,
                                         chip_smoke.LN_TOL[name])
            print(f"{name}: other checkout's kernel max abs err {err:.3e} "
                  f"against the plain version", flush=True)
            fns["other checkout"] = lambda: other.fused_layer_norm_fwd(
                x, res, gamma, beta, EPS)
        if lib is not None:
            for variant in VARIANTS:
                y = torch.empty_like(x)
                call, resident = variant_call(lib, variant, x, res, gamma,
                                              beta, y, counters)
                call()
                torch.cuda.synchronize()
                err, ok = chip_smoke.max_err(y, want,
                                             chip_smoke.LN_TOL[name])
                if not ok or int(counters.abs().sum()):
                    sys.exit(f"{label(*variant)} {name}: max abs err "
                             f"{err}, counters {counters.tolist()}")
                print(f"{name} {label(*variant)}: {resident} resident CTAs "
                      f"a SM; max abs err {err:.3e}, bitwise the port's: "
                      f"{torch.equal(y, mine)}", flush=True)
                fns[label(*variant)] = call
        torch.cuda.synchronize()
        nbytes = {k: 3 * x.numel() * x.element_size() + 2 * D * 4
                  for k in fns}
        nbytes["torch.add"] = 3 * x.numel() * x.element_size()
        nbytes["library"] = 5 * x.numel() * x.element_size() + 2 * D * \
            x.element_size()                  # x + res, then the norm
        times = chip_smoke.interleaved_ms(fns, args.pairs, flush,
                                          cover=1_000_000)
        for fn_name, ms in times.items():
            med = statistics.median(ms)
            bound_ms, _ = chip_smoke.bound(nbytes[fn_name], 0, "float32")
            print(f"{name} {ROWS}x{D} + residual, {fn_name}: median "
                  f"{med:.4f} ms (range {min(ms):.4f}-{max(ms):.4f}), "
                  f"{nbytes[fn_name] / med / 1e9:.3f} TB/s, "
                  f"{bound_ms / med:.1%} of its bytes' bound"
                  + ("" if fn_name == "kernel" else "; " +
                     chip_smoke.ratio_text(times["kernel"], ms, fn_name)),
                  flush=True)
        del x, res, y_add, want, mine, fns
        torch.cuda.empty_cache()
    import mxnet_tpu_torch.ops.fused_layernorm as mine_ln
    ports = [("this port", mine_ln)]
    if other is not None:
        ports += [("other checkout", other), ("other checkout", other),
                  ("this port", mine_ln)]
    for name, ln in ports:
        busy = op_device_ms(ln)
        print(f"op path, 48 x fused_layer_norm({ROWS}x{D} bf16, residual) "
              f"forward and backward, {name}: device time by kernel "
              f"{chip_smoke.by_kernel(busy)}, {sum(busy.values()):.4f} ms "
              f"in all", flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
