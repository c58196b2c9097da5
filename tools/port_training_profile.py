#!/usr/bin/env python3
"""Where the time goes in the port's training step on one NVIDIA GPU.

Builds Llama-3-8B's geometry (random weights from ``--seed``, float32,
full width; ``--layers`` cuts depth) and a ``gluon.Trainer`` with AdamW
(lr 1e-3, wd 0.1), takes one warm-up step on a batch of ``--batch`` x
``--seq`` tokens, then profiles with ``torch.profiler``:

- the forward and loss, the backward and the update (``trainer.step``)
  of one step, each as a window of its own;
- one whole step.

For each window it prints the wall time, the device time summed over
kernels, the device's idle share (1 - busy / wall), the kernel launches
and the kernels with the most device time, as one JSON line.  With
``--trace-dir`` the Chrome traces are written there too.

Run from the root of a checkout:  ``python3 tools/port_training_profile.py``
"""
import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from port_serving_profile import window  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, REPO)
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama3_8b
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 means fp32
    dev = torch.device("cuda", 0)
    net = llama3_8b(device=dev, dtype=torch.float32, seed=args.seed,
                    num_layers=args.layers)
    trainer = Trainer(dict(net.named_parameters()), "adamw",
                      {"learning_rate": 1e-3, "wd": 0.1})
    loss_fn = SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(args.seed)
    tokens, labels = (torch.from_numpy(rng.randint(
        0, net.cfg.vocab_size, (args.batch, args.seq))).to(dev)
        for _ in range(2))
    state = {}

    def forward():
        state["loss"] = loss_fn(net(tokens), labels).sum()

    def backward():
        state.pop("loss").backward()

    def update():
        trainer.step(args.batch)

    def step():
        forward()
        backward()
        update()

    step()                                            # warm-up
    ops.reset_launches()
    results = [window("forward", forward, args.trace_dir),
               window("backward", backward, args.trace_dir),
               window("update", update, args.trace_dir),
               window("step", step, args.trace_dir)]
    for r in results:
        print(f"{r['window']}: wall {r['wall_ms']:.3f} ms, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share "
              f"{r['idle_share']:.3f}, {r['kernel_launches']} kernel "
              f"launches", flush=True)
    print(card)
    print(json.dumps({"card": card, "layers": args.layers,
                      "tokens": args.batch * args.seq,
                      "port_launches": ops.launch_counts(),
                      "windows": results}))


if __name__ == "__main__":
    main()
