#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` against CPU references at several
thread counts, on one NVIDIA GPU.

    python3 tools/port_resnet_cpu_threads.py [--threads 1,2,4,8,16,64]

Phase 14 trains ``resnet50_v1()`` (f32, TF32 off) for two SGD-momentum
steps on the card and on the CPU from the same host-made weights and
holds each parameter's update, card against CPU.  The CPU's sums run in
an order that follows its thread count, so the reference moves with the
machine.  This script makes phase 14's weights and batch, trains twice
on the card on cuDNN's deterministic algorithms (as phase 14 does) and
twice on any algorithm, once on the CPU at each ``--threads`` count, and
once more on the CPU with the learning rate 0.2% high and 0.1% low
(planted faults).  For each card run and each fault against each CPU run it
prints phase 14's statistics: the losses, each parameter's update both
as ``chip_smoke.update_errs`` reads it (less the f32 rounding of storing
each step) and unreduced, the body convs' biases, the running
statistics and the predict-mode logits.  The card's name and power
limit come first.  Run it from the root of a checkout.
"""
import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", default="1,2,4,8,16,64")
    args = ap.parse_args()
    counts = [int(n) for n in args.threads.split(",")]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"cpus {os.cpu_count()}, torch threads by default "
          f"{torch.get_num_threads()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                         load_block_weights)
    from mxnet_tpu_torch.gluon.model_zoo import vision

    rng = np.random.RandomState(0)
    b, s = smoke.RESNET_CHECK_BATCH, smoke.RESNET_CHECK_SIZE
    host_x = rng.rand(b, 3, s, s).astype(np.float32)
    host_y = rng.randint(0, 1000, (b,))
    w0 = smoke.resnet_check_weights(host_x)

    def run(ctx, lr=smoke.RESNET_LR, deterministic=False):
        torch.backends.cudnn.deterministic = deterministic
        net = vision.resnet50_v1()
        net.initialize(ctx=ctx)
        with ctx:
            data = mx.nd.array(host_x)
            label = mx.nd.array(host_y, dtype="int32")
        load_block_weights(net, w0)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": lr,
                                 "momentum": smoke.RESNET_MOMENTUM})
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        losses = [float(smoke._resnet_step(net, ce, trainer, data, label,
                                           b)[0].mean().asscalar())
                  for _ in range(2)]
        out = losses, block_weights_to_numpy(net), net(data).asnumpy()
        torch.backends.cudnn.deterministic = False
        return out

    stats = [k for k in w0 if k.endswith(("running_mean", "running_var"))]
    noise = [k for k in w0 if k.endswith("bias") and ".body." in k]
    held = {k: w0[k] for k in w0 if k not in stats and k not in noise}

    def compare(a, b):
        (al, aw, ao), (bl, bw, bo) = a, b
        loss = max(abs(x - y) / abs(y) for x, y in zip(al, bl))
        new = smoke.update_errs(held, aw, bw, 2)
        raw = smoke.update_errs(held, aw, bw, 0)
        nk, rk = max(new, key=new.get), max(raw, key=raw.get)
        nz = max(float(np.abs(aw[k] - bw[k]).max()) for k in noise)
        st = max(float(np.abs(aw[k] - bw[k]).max() /
                       max(1.0, np.abs(bw[k]).max())) for k in stats)
        return (f"loss {loss:.3e}, update {new[nk]:.3e} at {nk}, "
                f"unreduced {raw[rk]:.3e} at {rk}, biases {nz:.3e}, "
                f"statistics {st:.3e}, logits "
                f"{float(np.abs(ao - bo).max()):.3e}")

    runs = {}
    for i in range(2):
        runs[f"card_det{i}"] = run(mx.gpu(0), deterministic=True)
        runs[f"card{i}"] = run(mx.gpu(0))
    cards = list(runs)
    default = torch.get_num_threads()
    cpus = []
    for n in counts:
        torch.set_num_threads(n)
        runs[f"cpu{n}"] = run(mx.cpu())
        cpus.append(f"cpu{n}")
    torch.set_num_threads(default)
    runs["lr+0.2%"] = run(mx.cpu(), smoke.RESNET_LR * 1.002)
    runs["lr-0.1%"] = run(mx.cpu(), smoke.RESNET_LR * 0.999)
    for a in cards + ["lr+0.2%", "lr-0.1%"]:
        for c in cpus:
            print(f"{a} vs {c}: {compare(runs[a], runs[c])}", flush=True)
    for i, c in enumerate(cpus):
        for d in cpus[i + 1:]:
            print(f"{c} vs {d}: {compare(runs[c], runs[d])}", flush=True)
    print(f"limits: losses {smoke.TRAIN_LOSS_RTOL}, update "
          f"{smoke.RESNET_UPDATE_RTOL}, biases "
          f"{smoke.RESNET_NOISE_BIAS_ATOL}, statistics "
          f"{smoke.RESNET_STAT_TOL}, logits {smoke.RESNET_LOGIT_TOL} x "
          f"max(1, |logit|)", flush=True)


if __name__ == "__main__":
    main()
