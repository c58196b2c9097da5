#!/usr/bin/env python3
"""The Gluon layer parity test's errors over draws of the reference's
weights, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/port_gelu_seed_sweep.py [--seeds 0-31]
        [--layers Sequential,HybridSequential,GELU]

``tests/test_torch_port_gluon.py::test_layer_matches_jax`` draws each
layer's reference weights from ``Normal(0.5)`` under one seed of the
reference's global key (``LAYER_SEED``), carries them to the port and
holds outputs and gradients to ``TOL``.  This script runs the test's
own case (``layer_case``) under each seed given and prints, for each
layer and seed, the largest error over outputs and gradients as a
multiple of the test's limit (``|a - b| / (TOL + TOL |b|)``, as
``assert_allclose`` reads it) and where it is; then the worst case of
each layer.  A ratio above 1 fails the test at that seed.
``--aten-gelu`` runs the port's GELU through ATen's ``F.gelu`` on the
CPU as well, as before the repair of ROADMAP §3's fault q.
"""
import argparse
import os
import sys

import numpy as np

sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "tests")]
import test_torch_port_gluon as t  # noqa: E402

DEFAULT_LAYERS = "Sequential,HybridSequential,GELU,Dense-act-noflat"


def seeds_of(text):
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def ratio(a, b):
    return float(np.max(np.abs(a - b) / (t.TOL + t.TOL * np.abs(b))))


def case_ratios(name, seed):
    (py, pgx, pg), (jy, jgx, jg) = t.layer_case(name, seed)
    got = {"output": ratio(py, jy)}
    if pgx is not None:
        got["input grad"] = ratio(pgx, jgx)
    for k in pg:
        got[k] = ratio(pg[k], jg[k])
    return got


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0-31")
    ap.add_argument("--layers", default=DEFAULT_LAYERS)
    ap.add_argument("--aten-gelu", action="store_true")
    args = ap.parse_args()
    if args.aten_gelu:
        import torch.nn.functional as F
        from mxnet_tpu_torch.ndarray import ops
        # LeakyReLU(act_type="gelu") looks ``_gelu`` up at each call
        ops._gelu = lambda t: F.gelu(t, approximate="none")
    failed = 0
    for name in args.layers.split(","):
        worst = (0.0, None, None)
        for seed in seeds_of(args.seeds):
            got = case_ratios(name, seed)
            where = max(got, key=got.get)
            print(f"{name} seed {seed}: worst {got[where]:.3f} x TOL "
                  f"({where})", flush=True)
            failed += got[where] > 1.0
            if got[where] > worst[0]:
                worst = (got[where], seed, where)
        print(f"{name}: worst {worst[0]:.3f} x TOL at seed {worst[1]} "
              f"({worst[2]})", flush=True)
    print(f"cases over the limit: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
