#!/usr/bin/env python3
"""The bf16 AMP parity test's update errors over draws of the reference's
initialisation, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/port_amp_seed_sweep.py [--seeds 0-7]

``tests/test_torch_port_amp.py::test_amp_llama_training_matches_jax``
trains the reference's ``llama_tiny`` and the port's from the same
weights for 4 steps under both packages' ``amp.init("bfloat16")`` and
holds each update ``p4 - p0`` against the reference's.  The test draws
its weights under one seed of the reference's global key
(``AMP_SEED``).  This script runs the test's own training
(``train_amp_case``) under each seed given and prints, for each
optimizer case: the losses' largest difference, every leaf's update
error with the worst, the errors as the test holds them
(``held_update_errors``: each matrix leaf alone, the RMSNorm weights
together), the test's limit, and each planted fault's worst held error
over that limit.  A seed whose held error passes the limit, or whose
planted fault misses it by less than 1.5x, is marked.
"""
import argparse
import os
import sys

import numpy as np

sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "tests")]
import test_torch_port_amp as t  # noqa: E402


def seeds_of(text):
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0-7")
    ap.add_argument("--cases", default=",".join(sorted(t.AMP_CASES)))
    args = ap.parse_args()
    bad = 0
    for case in args.cases.split(","):
        for seed in seeds_of(args.seeds):
            got = t.train_amp_case(case, seed)
            w0, ref, tol = got["w0"], got["jax_w"], got["tol"]
            per_leaf = t._update_errors(w0, got["port_w"], ref)
            held = t.held_update_errors(w0, got["port_w"], ref)
            loss_d = float(np.max(np.abs(np.subtract(
                got["port_losses"], got["jax_losses"]))))
            planted = {n: max(t.held_update_errors(w0, w, ref))
                       for n, (_, w, _) in got["planted"].items()}
            ok = max(held) <= tol and all(v > 1.5 * tol
                                          for v in planted.values()) \
                and loss_d <= t.LOSS_ATOL
            bad += not ok
            print(f"{case} seed {seed}: loss diff {loss_d:.4g}; per leaf "
                  + " ".join(f"{e:.4f}" for e in per_leaf)
                  + f" (worst {max(per_leaf):.4f} at leaf "
                  f"{int(np.argmax(per_leaf))}); held "
                  + " ".join(f"{e:.4f}" for e in held)
                  + f" (worst {max(held):.4f}) against {tol}; planted "
                  + ", ".join(f"{n} {v:.4f} ({v / tol:.2f}x)"
                              for n, v in planted.items())
                  + ("" if ok else "  <-- FAILS"), flush=True)
    print(f"{bad} failing draw(s)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
