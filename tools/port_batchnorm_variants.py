#!/usr/bin/env python3
"""Time the ways the port can run BatchNorm's training step on
ResNet-50 v1's 53 BatchNorm layers, on one NVIDIA GPU.

    python3 tools/port_batchnorm_variants.py [--batch 128] [--rounds 5]

Each variant computes what ``gluon.nn.BatchNorm`` needs in training: the
output normalized by the batch's mean and biased variance (bf16
activations, f32 gamma and beta), the batch mean and variance for the
running update, and the backward to the input, gamma and beta.  The
variants:

- ``native``: ``torch.native_batch_norm`` (returns the mean and
  ``1 / sqrt(var + eps)``);
- ``impl_index``: ``torch._batch_norm_impl_index``, which picks cuDNN
  where it can and returns the same two statistics;
- ``functional_var_mean``: ``F.batch_norm`` without running statistics,
  and ``torch.var_mean`` in f32 beside it for the statistics.

One pass runs every layer of ResNet-50 v1 at ``--batch`` x 224 x 224
(the stem's 64 x 112 x 112 down to 2048 x 7 x 7), forward and backward;
the variants take turns (in order, then reversed), each pass timed alone
between CUDA events.  Each variant's output, gradients and statistics
are first held against ``native``'s.  The card's name and power limit
come first; the median ms a pass of each variant last.
"""
import argparse
import statistics
import subprocess

import torch
import torch.nn.functional as F

EPS = 1e-5
# (channels, spatial side, how many) of resnet50_v1's BatchNorms at 224
LAYERS = [(64, 112, 1), (64, 56, 6), (256, 56, 4), (128, 28, 8),
          (512, 28, 5), (256, 14, 12), (1024, 14, 7), (512, 7, 6),
          (2048, 7, 4)]


def native(x, g, b):
    out, mean, invstd = torch.native_batch_norm(x, g, b, None, None, True,
                                                0.0, EPS)
    return out, mean.detach(), invstd.detach().pow(-2) - EPS


def impl_index(x, g, b):
    out, mean, invstd, _, _ = torch._batch_norm_impl_index(
        x, g, b, None, None, True, 0.0, EPS, True)
    return out, mean.detach(), invstd.detach().pow(-2) - EPS


def functional_var_mean(x, g, b):
    out = F.batch_norm(x, None, None, g, b, True, 0.0, EPS)
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), (0, 2, 3), correction=0)
    return out, mean, var


VARIANTS = {"native": native, "impl_index": impl_index,
            "functional_var_mean": functional_var_mean}


def make_layers(batch, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    layers = []
    for c, hw, n in LAYERS:
        for _ in range(n):
            x = (torch.randn(batch, c, hw, hw, device=dev, generator=gen)
                 * 2 + 0.5).to(torch.bfloat16).requires_grad_()
            g = (torch.rand(c, device=dev, generator=gen) + 0.5) \
                .requires_grad_()
            b = torch.randn(c, device=dev, generator=gen).requires_grad_()
            dy = torch.randn(batch, c, hw, hw, device=dev, generator=gen) \
                .to(torch.bfloat16)
            layers.append((x, g, b, dy))
    return layers


def one_pass(fn, layers):
    """Every layer forward then backward; the statistics of each."""
    stats = []
    for x, g, b, dy in layers:
        out, mean, var = fn(x, g, b)
        out.backward(dy)
        stats.append((mean, var))
    return stats


def check(layers):
    """Each variant's output, gradients and statistics against
    ``native``'s on the first two layers."""
    want = {}
    for name, fn in VARIANTS.items():
        got = []
        for x, g, b, dy in layers[:2]:
            for t in (x, g, b):
                t.grad = None
            out, mean, var = fn(x, g, b)
            out.backward(dy)
            got.append([out.float(), x.grad.float(), g.grad, b.grad,
                        mean, var])
        if not want:
            want = got
            continue
        for layer, (a, w) in enumerate(zip(got, want)):
            for what, u, v in zip(("out", "dx", "dgamma", "dbeta", "mean",
                                   "var"), a, w):
                err = float((u - v).abs().max())
                scale = float(v.abs().max())
                print(f"{name} layer {layer} {what}: max |diff| {err:.3e} "
                      f"(max |native| {scale:.3e})", flush=True)
                if not err <= 2e-2 * max(1.0, scale):
                    raise SystemExit(f"{name} disagrees with native on "
                                     f"{what}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool times the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    layers = make_layers(args.batch, dev)
    check(layers)
    names = list(VARIANTS)
    for name in names:                       # warm up (cuDNN's plans)
        one_pass(VARIANTS[name], layers)
    torch.cuda.synchronize()
    times = {name: [] for name in names}
    for r in range(args.rounds * 2):
        for name in (names if r % 2 == 0 else names[::-1]):
            for x, g, b, _ in layers:
                x.grad = g.grad = b.grad = None
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            one_pass(VARIANTS[name], layers)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    for name in names:
        print(f"{name}: median {statistics.median(times[name]):.3f} ms a pass "
              f"of 53 layers forward and backward at batch {args.batch} "
              f"(range {min(times[name]):.3f}-{max(times[name]):.3f}, "
              f"{len(times[name])} passes)", flush=True)


if __name__ == "__main__":
    main()
