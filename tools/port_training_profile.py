#!/usr/bin/env python3
"""Where the time goes in the port's training step on one NVIDIA GPU.

Builds Llama-3-8B's geometry (random weights from ``--seed``, float32,
full width; ``--layers`` cuts depth) and a ``gluon.Trainer`` with AdamW
(lr 1e-3, wd 0.1), takes one warm-up step on a batch of ``--batch`` x
``--seq`` tokens, then profiles with ``torch.profiler``.  With ``--amp``
the steps run under ``amp.init("bfloat16")``, ``amp.init_trainer`` and
``amp.scale_loss`` (chip_smoke.py's phase 11); without it in float32
(phase 8).  The windows:

- the forward and loss, the backward and the update (``trainer.step``)
  of one step, each as a window of its own;
- one whole step.

With ``--bert`` the model is BERT-base at chip_smoke.py's phase 13
configuration instead (``get_bert_model(vocab_size=30522,
max_length=128, dropout=0.0, use_flash=True, use_decoder=False)``,
``hybridize()``, Adam lr 1e-4, ``--batch`` 64 x ``--seq`` 128 from
``RandomState(seed)``), trained through the Gluon loop
(``autograd.record``, ``Trainer(net.collect_params())``); pass ``--amp``
for phase 13's bf16.

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
    ap.add_argument("--amp", action="store_true",
                    help="bf16 mixed precision (amp.init('bfloat16'))")
    ap.add_argument("--bert", action="store_true",
                    help="BERT-base through the Gluon loop (phase 13)")
    args = ap.parse_args()
    if args.bert and args.seq == 1024:
        args.batch, args.seq = 64, 128
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, REPO)
    from mxnet_tpu_torch import amp, ops
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
    loss_fn = SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(args.seed)
    state = {}
    if args.bert:
        forward, backward, update, trainer = _bert(args, rng, state)
    else:
        net = llama3_8b(device=dev, dtype=torch.float32, seed=args.seed,
                        num_layers=args.layers)
        trainer = Trainer(dict(net.named_parameters()), "adamw",
                          {"learning_rate": 1e-3, "wd": 0.1})
        if args.amp:
            amp.init("bfloat16")
            amp.init_trainer(trainer)
        tokens, labels = (torch.from_numpy(rng.randint(
            0, net.cfg.vocab_size, (args.batch, args.seq))).to(dev)
            for _ in range(2))
        params = list(net.parameters())

        # ``window`` runs each function twice (untraced, then traced), so
        # each one can run again: the backward keeps its graph, and the
        # update puts the backward's gradients back before each step
        def forward():
            state["loss"] = loss_fn(net(tokens), labels).sum()

        def backward():
            with amp.scale_loss(state["loss"], trainer) as scaled:
                scaled.backward(retain_graph=True)
            state["grads"] = [p.grad for p in params]

        def update():
            for p, g in zip(params, state["grads"]):
                p.grad = g
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
    print(json.dumps({"card": card, "model": "bert_12_768_12" if args.bert
                      else "llama3_8b", "layers": args.layers,
                      "amp": "bfloat16" if args.amp else None,
                      "tokens": args.batch * args.seq,
                      "port_launches": ops.launch_counts(),
                      "windows": results}))


def _bert(args, rng, state):
    """BERT-base's forward (with the loss), backward and update as
    phase 13 runs them: (forward, backward, update, trainer)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model
    if args.amp:
        amp.init("bfloat16")
    mx.random.seed(args.seed)
    net = get_bert_model(vocab_size=30522, max_length=args.seq, dropout=0.0,
                         use_flash=True, use_decoder=False)
    net.initialize()
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-4})
    if args.amp:
        amp.init_trainer(trainer)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    data = mx.nd.array(rng.randint(0, 30522, (args.batch, args.seq)),
                       dtype="int32")
    types = mx.nd.zeros((args.batch, args.seq), dtype="int32")
    label = mx.nd.array(rng.randint(0, 2, (args.batch,)), dtype="int32")
    params = list(net.collect_params().values())

    def forward():
        with autograd.record():
            state["loss"] = ce(net(data, types)[-1], label)

    def backward():
        with amp.scale_loss(state["loss"], trainer) as scaled:
            scaled.backward(retain_graph=True)
        state["grads"] = [p._var.grad for p in params]

    def update():
        for p, g in zip(params, state["grads"]):
            p._var.grad = g
        trainer.step(args.batch)

    return forward, backward, update, trainer


if __name__ == "__main__":
    main()
