#!/usr/bin/env python3
"""Where phase 30's f32 check (``chip_smoke.py``) finds its differences:
BERT-base's gradients from three storages, and LAMB's rule per parameter
against its segmented form on one gradient, on one NVIDIA GPU.

    python3 tools/port_lamb_grad_noise.py

Phase 30's check holds ``DataParallelTrainer``'s captured LAMB step
against ``gluon.Trainer``'s per-parameter LAMB on BERT-base at
``bench.py``'s configuration (f32, batch 64 x 128, the sentence head).
This script makes that check's weights and batch and takes the gradient
of the batch's mean loss on the card four ways: twice on one net (run to
run), on a second net holding the same weights in storage of its own,
and through ``DataParallelTrainer``'s step body (``_loss_and_grad``) on a
third, whose parameters are views of one flat buffer.  For each pair it
prints each parameter's relative gradient difference ``|g_a - g_b| /
|g_b|`` (the median and the five largest), and the same of LAMB's first
direction ``g / (|g| + eps)`` (bias-corrected moments at t = 1, eps
1e-6).  Then, on the first gradient, LAMB's first update per parameter
(``optimizer.fused_rule("lamb")``) against the segmented rule over the
flat bucket (``fused_rule(..., segments=Segments(...))``, the trainer's):
the largest relative difference of an update.  The card's name and power
limit come first.  Run it from the root of a checkout.
"""
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as smoke  # noqa: E402

EPS = 1e-6                    # LAMB's default epsilon


def gluon_grads(net, ce, data, types, label):
    """Each parameter's gradient (a copy) of the mean loss."""
    from mxnet_tpu_torch import autograd
    with autograd.record():
        loss = ce(net(data, types)[-1], label).mean()
    loss.backward()
    return {k: p.grad().data.detach().clone()
            for k, p in net._collect_params_with_prefix().items()}


def report(label, a, b):
    for name, f in (("gradient", lambda g: g),
                    ("LAMB's first direction",
                     lambda g: g / (g.abs() + EPS))):
        d = {k: float((f(a[k]) - f(b[k])).norm() /
                      max(float(f(b[k]).norm()), 1e-30)) for k in b}
        top = sorted(d.items(), key=lambda kv: -kv[1])[:5]
        print(f"{label}, {name}: median over {len(d)} parameters "
              f"{statistics.median(d.values()):.3e}; largest "
              + ", ".join(f"{k} {v:.3e}" for k, v in top), flush=True)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.optimizer import Segments, fused_rule
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["flash_attention", "flash_attention_bwd"])
    dev = torch.device("cuda", 0)
    ctx = mx.gpu(0)
    rng = np.random.RandomState(30)        # phase 30's check's batch
    data = mx.nd.array(rng.randint(0, smoke.BERT_VOCAB,
                                   (smoke.BERT_BATCH, smoke.BERT_SEQ)),
                       dtype="int32", ctx=ctx)
    types = mx.nd.zeros((smoke.BERT_BATCH, smoke.BERT_SEQ), dtype="int32",
                        ctx=ctx)
    label = mx.nd.array(rng.randint(0, 2, (smoke.BERT_BATCH,)),
                        dtype="int32", ctx=ctx)
    nets = []
    for _ in range(3):
        mx.random.seed(30)
        net = get_bert_model(vocab_size=smoke.BERT_VOCAB,
                             max_length=smoke.BERT_SEQ, dropout=0.0,
                             use_flash=True, use_decoder=False)
        net.initialize(ctx=ctx)
        net(data, types)
        nets.append(net)
    for net in nets[1:]:
        smoke.copy_weights(nets[0], net)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    first = gluon_grads(nets[0], ce, data, types, label)
    again = gluon_grads(nets[0], ce, data, types, label)
    other = gluon_grads(nets[1], ce, data, types, label)
    dp = parallel.DataParallelTrainer(
        nets[2], lambda out, y: ce(out[-1], y), "lamb",
        dict(smoke.DP_RULES[("bert", "lamb")]),
        mesh=parallel.make_mesh({"dp": 1}, devices=[dev]))
    dp._prepare(lambda: [data.data, types.data])
    _, flat_g = dp._loss_and_grad([data.data, types.data], label.data)
    params = dp._param_objs
    keys = {id(p): k for k, p in nets[2]._collect_params_with_prefix().items()}
    body, off = {}, 0
    for i in dp._train:
        var = params[i]._var
        body[keys[id(params[i])]] = flat_g[off:off + var.numel()].view(
            var.shape).clone()
        off += var.numel()
    torch.cuda.synchronize(dev)
    report("one net, run to run", again, first)
    report("a second net's storage", other, first)
    report("DataParallelTrainer's body, flat buffer", body, first)
    # the optimizer alone: LAMB per parameter against the segmented rule
    names = sorted(first)
    w = {k: p.data().data.detach() for k, p in
         nets[0]._collect_params_with_prefix().items()}
    hyper = smoke.DP_RULES[("bert", "lamb")]
    _, per_param = fused_rule("lamb")
    per = {k: per_param(w[k], first[k], {"m": torch.zeros_like(w[k]),
                                         "v": torch.zeros_like(w[k]),
                                         "t": 0},
                        hyper["learning_rate"], hyper["wd"])[0] - w[k]
           for k in names}
    seg = Segments([w[k].numel() for k in names], dev)
    _, flat_rule = fused_rule("lamb", segments=seg)
    flat_w = torch.cat([w[k].reshape(-1) for k in names])
    new, _ = flat_rule(flat_w, torch.cat([first[k].reshape(-1)
                                          for k in names]),
                       {"m": torch.zeros_like(flat_w),
                        "v": torch.zeros_like(flat_w),
                        "t": torch.zeros(1, dtype=torch.int32, device=dev)},
                       torch.full((1,), hyper["learning_rate"], device=dev),
                       hyper["wd"])
    du, off, worst = new - flat_w, 0, []
    for k in names:
        n = w[k].numel()
        d = du[off:off + n].view(w[k].shape)
        worst.append((float((d - per[k]).norm() /
                            max(float(per[k].norm()), 1e-30)), k))
        off += n
    worst.sort(reverse=True)
    print("LAMB's first update on one gradient, per parameter against the "
          "segmented rule: largest relative differences "
          + ", ".join(f"{k} {v:.3e}" for v, k in worst[:5]), flush=True)


if __name__ == "__main__":
    main()
