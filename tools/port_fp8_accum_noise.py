#!/usr/bin/env python3
"""How far phase 34c's narrow fp8 BERT moves when its e4m3 products are
summed as the card sums them: on the CPU, no card needed.

    JAX_PLATFORMS=cpu python3 tools/port_fp8_accum_noise.py

Phase 34c of ``chip_smoke.py`` trains a narrow BERT (2 layers of 256
units, batch 8 x 64, every Dense in fp8) two steps on the card and on the
CPU from the same weights.  The card's e4m3 product (cuBLASLt's fp8 GEMM,
``torch._scaled_mm``) sits about 1.3e-4 of the norm from the CPU's exact
f32 sums (phase 34a), and every layer quantizes its input to e4m3 again.
This script runs phase 34c's model twice on the CPU: once as it is, once
with each e4m3 forward product multiplied by ``1 + 1.3e-4 * n``, ``n``
standard normal (a seeded generator) — the card's difference, put in on
the CPU.  For Adam (lr 1e-3) and SGD (lr 0.1) it prints both runs' mean
losses and the second run's updates against the first's: over all
parameters together and the worst parameter, ``|du_noisy - du| / |du|``
in the Frobenius norm (the key projections' bias, zero in exact
arithmetic, left out).  Run it from the root of a checkout; about a
minute.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, gluon  # noqa: E402
from mxnet_tpu_torch.convert import (block_weights_to_numpy,  # noqa: E402
                                     load_block_weights)
from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model  # noqa: E402
from mxnet_tpu_torch.ops import quant_matmul as qm  # noqa: E402

CARD_RTOL = 1.3e-4        # phase 34a's e4m3 products against exact sums


def train(rule, args, noise, w0=None):
    """Two steps of phase 34c's model on the CPU; ``noise`` perturbs the
    e4m3 products.  Returns (mean losses, weights, initial weights)."""
    plain = qm._fp8_product
    gen = torch.Generator().manual_seed(0)

    def product(qa, qb, sa, sb):
        out = plain(qa, qb, sa, sb)
        if noise and qa.dtype == torch.float8_e4m3fn:
            out = out * (1 + CARD_RTOL * torch.randn(out.shape,
                                                      generator=gen))
        return out
    rng = np.random.RandomState(340)
    cfg = chip_smoke.QUANT_NARROW
    tokens = rng.randint(0, cfg["vocab_size"], (8, 64))
    types = rng.randint(0, 2, (8, 64))
    labels = rng.randint(0, 2, (8,))
    qm._fp8_product = product
    try:
        with mx.cpu():
            mx.random.seed(34)
            net = get_bert_model(**cfg)
            net.initialize()
            args_nd = (mx.nd.array(tokens, dtype="int32"),
                       mx.nd.array(types, dtype="int32"))
            net(*args_nd)
            if w0 is None:
                w0 = block_weights_to_numpy(net)
            else:
                load_block_weights(net, w0)
            net.apply(lambda b: setattr(b, "compute_dtype", "fp8")
                      if isinstance(b, gluon.nn.Dense) else None)
            tr = gluon.Trainer(net.collect_params(), rule, dict(args))
            ce = gluon.loss.SoftmaxCrossEntropyLoss()
            y = mx.nd.array(labels, dtype="int32")
            losses = []
            for _ in range(2):
                with autograd.record():
                    loss = ce(net(*args_nd)[-1], y)
                loss.backward()
                tr.step(8)
                losses.append(float(loss.asnumpy().mean()))
    finally:
        qm._fp8_product = plain
    return losses, block_weights_to_numpy(net), w0


def main():
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    for rule, args in (("adam", {"learning_rate": 1e-3}),
                       ("sgd", {"learning_rate": 0.1})):
        l0, w_a, w0 = train(rule, args, False)
        l1, w_b, _ = train(rule, args, True, w0)
        diff = size = 0.0
        per = {}
        for k in w_a:
            if k.endswith("proj_key.bias"):
                continue
            du = (w_a[k] - w0[k]).astype(np.float64)
            dd = (w_b[k] - w0[k]).astype(np.float64) - du
            diff += float((dd ** 2).sum())
            size += float((du ** 2).sum())
            per[k] = float(np.linalg.norm(dd) / max(np.linalg.norm(du),
                                                    1e-30))
        worst = max(per, key=per.get)
        print(f"{rule} {args}: mean losses {l0} exact, {l1} with the card's "
              f"{CARD_RTOL} product noise; updates over all parameters "
              f"{(diff / size) ** 0.5:.4f} of their norm apart, the worst "
              f"parameter {worst} {per[worst]:.4f}", flush=True)


if __name__ == "__main__":
    main()
