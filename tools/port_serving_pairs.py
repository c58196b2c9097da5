#!/usr/bin/env python3
"""Serve ``chip_smoke.py``'s phase 4 and phase 7 workloads through this
checkout's serving engine and another checkout's, in interleaved pairs,
on one NVIDIA GPU.

    python3 tools/port_serving_pairs.py --checkout DIR [--pairs 10]

Each tree builds its own Llama-3-8B (bfloat16, full width and depth,
random weights drawn on the card from seed 0; the same seed gives both
trees the same weights, so the streams can be held equal).  For each of
the two cells of
``chip_smoke.SERVING_CELLS`` (``bf16``: phase 4's 16 requests on a bf16
pool, ``max_batch=8, max_context=1024``; ``fp8``: phase 7's 32 requests
on an fp8 pool, ``max_batch=16, max_context=4096``), an
``InferenceEngine`` of each tree is built over that net (the other
tree's ``mxnet_tpu_torch`` is imported under another package name and
builds its kernels in its own tree) and warmed up; then each tree's
``ContinuousBatcher`` serves the cell's requests, drawn by
``chip_smoke.serving_prompts`` and served by
``chip_smoke.serve_requests`` as the smoke serves them, in the order
this, other, other, this, ... for ``--pairs`` pairs.

Every run prints its decode step median, tokens per second over the
run and TTFT p50 (all requests submitted at t = 0); each cell then
prints each tree's medians and, per metric, the median and range of
this / other by pair and the pairs this tree won.  It fails unless
every run of both trees gives the same greedy streams.  The card's name
and power limit come first, a JSON summary last.
"""
import argparse
import gc
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# metric -> True when larger is better
METRICS = {"step_ms": False, "tokens_per_s": True, "ttft_p50_ms": False}


def load_port(root, name):
    """The ``mxnet_tpu_torch`` package of the checkout at ``root``,
    imported as ``name``, with its serving and ops modules."""
    pkg = os.path.join(os.path.abspath(root), "mxnet_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    sys.modules[name] = mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for sub in ("serving", "ops._build", "gluon.model_zoo.nlp.llama"):
        importlib.import_module(f"{name}.{sub}")
    return mod


def serve(smoke, pkg, eng, prompts, label):
    """One run of the cell's requests through ``pkg``'s batcher on
    ``eng``: (greedy streams, metrics)."""
    run = smoke.serve_requests(pkg.serving, eng, prompts, label)
    return ({r.id: list(r.generated) for r in run["finished"]},
            {m: run[m] for m in METRICS})


def run_cell(smoke, name, nets, pkgs, pairs, dev):
    import torch
    cell = smoke.SERVING_CELLS[name]
    prompts, _ = smoke.serving_prompts(cell, nets["this"].cfg.vocab_size)
    engines = {}
    for tree, pkg in pkgs.items():
        t0 = time.perf_counter()
        eng = smoke.serving_engine(pkg.serving, nets[tree], cell, dev)
        graphs = eng.graphs_captured() if hasattr(eng, "graphs_captured") \
            else 0
        print(f"{name}: {tree} engine warmed up in "
              f"{time.perf_counter() - t0:.2f} s, {graphs} CUDA graphs",
              flush=True)
        engines[tree] = eng
    runs = {tree: [] for tree in pkgs}
    ref = None
    for i in range(pairs):
        for tree in ("this", "other") if i % 2 == 0 else ("other", "this"):
            streams, m = serve(smoke, pkgs[tree], engines[tree], prompts,
                               f"{name} pair {i} {tree}")
            if ref is None:
                ref = streams
            elif streams != ref:
                sys.exit(f"{name}: {tree}'s greedy streams differ from the "
                         "first run's")
            runs[tree].append(m)
            print(f"{name} pair {i} {tree}: decode step median "
                  f"{m['step_ms']:.3f} ms, {m['tokens_per_s']:.1f} tokens/s, "
                  f"TTFT p50 {m['ttft_p50_ms']:.1f} ms", flush=True)
    for tree, eng in engines.items():
        if eng.stats["compiles_after_warmup"]:
            sys.exit(f"{name}: {tree}'s engine compiled after warmup")
    summary = {"cell": name, "pairs": pairs, "streams_identical": True}
    for metric, higher in METRICS.items():
        this = [r[metric] for r in runs["this"]]
        other = [r[metric] for r in runs["other"]]
        ratios = [a / b for a, b in zip(this, other)]
        won = sum((a > b) if higher else (a < b) for a, b in zip(this,
                                                                 other))
        summary[metric] = {
            "this_median": statistics.median(this),
            "other_median": statistics.median(other),
            "this_range": [min(this), max(this)],
            "other_range": [min(other), max(other)],
            "ratio_median": statistics.median(ratios),
            "ratio_range": [min(ratios), max(ratios)], "this_won": won}
        print(f"{name} {metric}: this {statistics.median(this):.3f} "
              f"({min(this):.3f}-{max(this):.3f}), other "
              f"{statistics.median(other):.3f} ({min(other):.3f}-"
              f"{max(other):.3f}); this/other median "
              f"{statistics.median(ratios):.4f} (range {min(ratios):.4f}-"
              f"{max(ratios):.4f}), this better in {won} of {pairs} pairs",
              flush=True)
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", required=True,
                    help="root of another checkout whose engine serves "
                    "the same requests")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the engines run on the card")
    sys.path.insert(0, REPO)
    import chip_smoke
    import mxnet_tpu_torch
    import mxnet_tpu_torch.serving
    import mxnet_tpu_torch.gluon.model_zoo.nlp.llama
    from mxnet_tpu_torch.ops import _build
    card = chip_smoke.card_line()
    print(f"{card}; this port from {REPO}, other from {args.checkout}",
          flush=True)
    pkgs = {"this": mxnet_tpu_torch,
            "other": load_port(args.checkout, "other_port")}
    t0 = time.perf_counter()
    for build in (_build, pkgs["other"].ops._build):
        build.build(["flash_attention", "paged_attention"])
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    nets = {tree: pkg.gluon.model_zoo.nlp.llama.llama3_8b(
        device=dev, dtype=torch.bfloat16, seed=0)
        for tree, pkg in pkgs.items()}
    summaries = [run_cell(chip_smoke, name, nets, pkgs, args.pairs, dev)
                 for name in chip_smoke.SERVING_CELLS]
    print(card)
    print(json.dumps({"card": card, "layers": nets["this"].cfg.num_layers,
                      "cells": summaries}))


if __name__ == "__main__":
    main()
