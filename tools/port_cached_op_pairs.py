#!/usr/bin/env python3
"""The Gluon training loop with ``hybridize()`` (the CachedOp's captured
forward and backward) against the same loop with
``hybridize(active=False)``, on one NVIDIA GPU.

Two models, at chip_smoke.py's configurations:

- ``bert``: phase 13's BERT-base (``get_bert_model(vocab_size=30522,
  max_length=128, dropout=0.0, use_flash=True, use_decoder=False)``),
  bf16 AMP (``amp.init("bfloat16")``, ``amp.init_trainer``), Adam lr
  1e-4, batch 64 x 128 from ``RandomState(seed)``;
- ``transformer``: phase 28's ``transformer_en_de_512`` (f32, dropout
  0.1), Adam lr 1e-4, 64 x 64 source and target tokens.

For each model two nets with the same weights (copied on the card) and
a Trainer each take 3 warm-up steps, then ``--rounds`` rounds of
windows in the order eager, captured, captured, eager, each window
``--steps`` steps timed one by one (host clock, ending in a
synchronize).  Then two profiled steps each (``torch.profiler``) give
the device time a step, and the host share is ``1 - busy / median
step``.  Printed, one JSON line a model: the card's name and power
limit, each variant's step medians by window, peak memory of a step
above its start, and the captured net's CachedOp counts and graph pool
bytes.  With ``--out`` the lines are also written to that file.

``--parity`` measures no time: for each model the two nets take
``--steps`` recorded forward and backward passes on one batch with no
update (the first eager on both, then the captured net's capture and
replays), and each pass's outputs, loss and parameter gradients are
compared, captured against eager (bitwise, and the largest difference
relative to the largest magnitude); then one bf16 and one f32 product
at BERT's FFN shape (8192 x 768 by 768 x 3072) is run eagerly and as a
captured graph's replay and compared the same way.

Run from the root of a checkout:  ``python3 tools/port_cached_op_pairs.py``
"""
import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402


def _bert(mx, rng):
    from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model

    def build():
        return get_bert_model(vocab_size=smoke.BERT_VOCAB,
                              max_length=smoke.BERT_SEQ, dropout=0.0,
                              use_flash=True, use_decoder=False)
    b, t = smoke.BERT_BATCH, smoke.BERT_SEQ
    batch = (mx.nd.array(rng.randint(0, smoke.BERT_VOCAB, (b, t)),
                         dtype="int32"),
             mx.nd.zeros((b, t), dtype="int32"),
             mx.nd.array(rng.randint(0, 2, (b,)), dtype="int32"))

    def loss_of(net, ce):
        return ce(net(batch[0], batch[1])[-1], batch[2])
    return build, batch[:2], loss_of, b, True


def _transformer(mx, rng):
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo.nlp import transformer_en_de_512

    def build():
        return transformer_en_de_512(prefix="mt512_")
    vocab = build()._tgt_vocab_size
    b, t = smoke.MT_BATCH, smoke.MT_LEN
    src, tgt, label = (mx.nd.array(rng.randint(0, vocab, (b, t)),
                                   dtype="int32") for _ in range(3))
    vl = mx.nd.array(rng.randint(t // 4, t + 1, b).astype(np.float32))

    def loss_of(net, ce):
        return ce(net(src, tgt, vl), label)
    return build, (src, tgt, vl), loss_of, b, False


def run(name, make, args, dev, card):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd, gluon
    rng = np.random.RandomState(args.seed)
    with mx.gpu(dev.index or 0):
        build, probe, loss_of, batch, use_amp = make(mx, rng)
    if use_amp:
        amp.init("bfloat16")
    try:
        nets, trainers = [], []
        for active in (True, False):
            mx.random.seed(args.seed)
            net = build()
            net.initialize(ctx=mx.gpu(dev.index or 0))
            net.hybridize(active=active)
            net(*probe)                    # the deferred shapes resolve
            nets.append(net)
        smoke.copy_weights(nets[0], nets[1])
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        for net in nets:
            tr = gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-4})
            if use_amp:
                amp.init_trainer(tr)
            trainers.append(tr)

        def step(j):
            with autograd.record():
                loss = loss_of(nets[j], ce)
            with amp.scale_loss(loss, trainers[j]) as scaled:
                scaled.backward()
            trainers[j].step(batch)

        for _ in range(3):
            for j in (0, 1):
                step(j)
        torch.cuda.synchronize(dev)
        windows, peak = {0: [], 1: []}, [0, 0]
        order = [1, 0, 0, 1] * args.rounds
        for j in order:
            times = []
            for _ in range(args.steps):
                torch.cuda.synchronize(dev)
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                t = time.perf_counter()
                step(j)
                torch.cuda.synchronize(dev)
                times.append(time.perf_counter() - t)
                peak[j] = max(peak[j], torch.cuda.max_memory_allocated(dev)
                              - base)
            windows[j].append(statistics.median(times) * 1e3)
        busy = []
        for j in (0, 1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    step(j)
                torch.cuda.synchronize(dev)
            busy.append(smoke.busy_by_class(prof, 2))
        op = nets[0]._cached_op
        stats = dict(op.stats, graph_pool_bytes=op.graph_pool_bytes())
    finally:
        if use_amp:
            amp._deinit_for_tests()
    out = {"model": name, "card": card, "steps_a_window": args.steps,
           "order": "eager, captured, captured, eager" + (
               f" x {args.rounds}" if args.rounds > 1 else "")}
    for j, variant in ((0, "captured"), (1, "eager")):
        med = statistics.median(windows[j])
        out[variant] = {
            "window_median_ms": [round(w, 3) for w in windows[j]],
            "step_ms": round(med, 3), "device_busy_ms": round(busy[j][0], 3),
            "host_share": round(1 - busy[j][0] / med, 4),
            "step_peak_gb_above_start": round(peak[j] / 1e9, 3),
            "device_ms_by_class": busy[j][1]}
    out["cached_op"] = stats
    del nets, trainers
    torch.cuda.empty_cache()
    return out


def _diff(a, b):
    """(bitwise, max |a - b| / max |b|) of two tensors."""
    import torch
    a, b = a.float(), b.float()
    scale = float(b.abs().max()) or 1.0
    return torch.equal(a, b), float((a - b).abs().max()) / scale


def parity(name, make, args, dev, card):
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd, gluon
    rng = np.random.RandomState(args.seed)
    with mx.gpu(dev.index or 0):
        build, probe, loss_of, batch, use_amp = make(mx, rng)
    if use_amp:
        amp.init("bfloat16")
    try:
        nets = []
        for active in (True, False):
            mx.random.seed(args.seed)
            net = build()
            net.initialize(ctx=mx.gpu(dev.index or 0))
            net.hybridize(active=active)
            net(*probe)
            nets.append(net)
        smoke.copy_weights(nets[0], nets[1])
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        rows = []
        for step in range(args.steps):
            got = []
            for net in nets:
                mx.random.seed(args.seed + step)      # the same masks
                with autograd.record():
                    loss = loss_of(net, ce)
                loss.backward()
                grads = {k: p.grad().data.clone() for k, p in
                         net._collect_params_with_prefix().items()
                         if p.grad_req != "null"}
                got.append((loss.data.clone(), grads))
            (lc, gc_), (le, ge) = got
            worst = max(((k,) + _diff(gc_[k], ge[k]) for k in ge),
                        key=lambda t: t[2])
            rows.append({"step": step + 1, "loss": _diff(lc, le),
                         "grads_bitwise": all(_diff(gc_[k], ge[k])[0]
                                              for k in ge),
                         "worst_grad": worst})
        stats = dict(nets[0]._cached_op.stats)
    finally:
        if use_amp:
            amp._deinit_for_tests()
    del nets
    torch.cuda.empty_cache()
    return {"model": name, "card": card, "parity": rows, "cached_op": stats}


def product_parity(dev, card):
    """One product eagerly and as a captured graph's replay."""
    import torch
    out = {"card": card, "shape": "8192x768 @ 768x3072"}
    g = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        a = torch.randn(8192, 768, device=dev, generator=g).to(dtype)
        w = torch.randn(3072, 768, device=dev, generator=g).to(dtype)
        b = torch.randn(3072, device=dev, generator=g).to(dtype)
        eager = torch.nn.functional.linear(a, w, b)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            torch.nn.functional.linear(a, w, b)
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = torch.nn.functional.linear(a, w, b)
        graph.replay()
        torch.cuda.synchronize(dev)
        out[str(dtype).replace("torch.", "")] = _diff(static, eager)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default="bert,transformer")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--parity", action="store_true",
                    help="compare captured and eager passes; no timing")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from mxnet_tpu_torch.ops import _build
    _build.build(["flash_attention", "flash_attention_bwd", "fused_update"])
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    makers = {"bert": _bert, "transformer": _transformer}
    lines = []
    if args.parity:
        lines.append(json.dumps(product_parity(dev, card)))
        print(lines[-1], flush=True)
    for name in args.models.split(","):
        fn = parity if args.parity else run
        line = json.dumps(fn(name, makers[name], args, dev, card))
        print(line, flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
