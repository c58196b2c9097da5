#!/usr/bin/env python3
"""Why MobileNet v2's f32 gradients differ between two devices by much
more than their ops do: the witness behind ``chip_smoke.py`` phase 42's
gradient check, on the CPU.

    python3 tools/port_mobilenet_kinks.py [--batch 4] [--size 224]

``mobilenet_v2_1_0`` with He's initialization from ``mx.random.seed(43)``
and phase 42's images and labels (``RandomState(42)``, the first
``--batch``) runs one recorded forward and backward in the port at f32
on the CPU, in predict and in training mode, with ``relu6_gates``
recording which inputs of each ReLU6 pass their gradient.  Then
``chip_smoke.mobilenet_v2_plain`` computes the same loss and gradients
in float64 twice: with its own gates, and with the f32 run's (at most
four CPU threads; about 10 s at the defaults).  For each
mode the script prints the loss's relative difference, all gradients'
difference together by norm (each against float64), the parameter
worst by its own norm with that norm, and how many units the two
forwards put on different sides of a kink.  The f32 run agrees with
float64 at its own gates within what its ops round; with float64's own
gates it differs by each flipped unit's share of its layer's backward
signal.
"""
import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _against(got, ref):
    """All gradients together by norm; the worst by its own norm of those
    whose norm is at least 1e-4 of the largest; and the largest
    difference of the rest (zero or small by invariance in training
    mode: the out.7 betas, the out.1 gammas)."""
    norm = {k: float(np.linalg.norm(ref[k])) for k in ref}
    diff = {k: float(np.linalg.norm(got[k] - ref[k])) for k in ref}
    whole = float(np.sqrt(sum(d * d for d in diff.values()) /
                          sum(n * n for n in norm.values())))
    big = [k for k in ref if norm[k] >= 1e-4 * max(norm.values())]
    worst = max(big, key=lambda k: diff[k] / norm[k])
    small = max((diff[k] for k in ref if k not in big), default=0.0)
    return (f"gradients together {whole:.3e}, worst {worst} "
            f"{diff[worst] / norm[worst]:.3e} of norm {norm[worst]:.3e}, "
            f"the {len(ref) - len(big)} small ones within {small:.3e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=224)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    smoke = _smoke()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    rng = np.random.RandomState(42)
    x = rng.rand(64, 3, args.size, args.size).astype(np.float32)
    y = rng.randint(0, 1000, 64).astype(np.int32)
    x, y = x[:args.batch], y[:args.batch]
    net = vision.mobilenet_v2_1_0()
    with mx.cpu():
        mx.random.seed(43)
        net.initialize(mx.init.Xavier("gaussian", "in", 2))
        with autograd.predict_mode():
            net(mx.nd.array(x[:1]))
    params = net._collect_params_with_prefix()
    w0 = {k: p.data().asnumpy() for k, p in params.items()}
    gates = smoke.relu6_gates(net)
    for train in (False, True):
        gates.clear()
        with mx.cpu(), autograd.record(train_mode=train):
            loss = SoftmaxCrossEntropyLoss()(
                net(mx.nd.array(x)), mx.nd.array(y, dtype="int32")).mean()
        loss.backward()
        got = {k: p.grad().asnumpy() for k, p in params.items()
               if p.grad_req != "null"}
        units = sum(g.numel() for g in gates)
        for how, given in (("its own gates", None),
                           ("the f32 run's gates", gates)):
            ref_l, ref, flips = smoke.mobilenet_v2_plain(w0, x, y, train,
                                                         given)
            rel = abs(float(loss.asscalar()) - ref_l) / ref_l
            print(f"{'training' if train else 'predict'} mode, batch "
                  f"{args.batch} at {args.size}, f32 against float64 at "
                  f"{how}: loss {rel:.3e}, {_against(got, ref)}"
                  + (f"; units on the other side of a kink {flips} of "
                     f"{units}" if given is not None else ""), flush=True)


if __name__ == "__main__":
    torch.set_num_threads(min(4, torch.get_num_threads()))
    main()
