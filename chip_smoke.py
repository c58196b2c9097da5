#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, in order; any failure exits non-zero and nothing is caught and
continued:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of the serving, training and LayerNorm
   paths from ``mxnet_tpu_torch/ops/csrc`` (one ``nvcc`` per source, in
   parallel); print each flash kernel's registers, spill bytes (ptxas),
   dynamic shared memory and ``HGMMA`` (wgmma), ``HMMA`` (mma.sync) and
   instruction counts (``cuobjdump -sass``), and fail if a flash kernel
   spills, a bf16 one issues no wgmma or an f32 one no mma.sync; print
   the registers, spills and shared memory of every paged-attention,
   LayerNorm and update (K1/K2) kernel, and fail if one spills, and the
   resident CTAs of K4's two row kernels and K1/K2's;
3. kernels: hold each kernel against its plain PyTorch version on the
   card at the shapes its path gives it; time the kernel, the plain
   version and, where one PyTorch call computes the same function (or,
   marked "near", nearly the same), that call (``library_ms``), the
   flash lines with their factor against SDPA and share of the bound:
   flash forward (float32, bfloat16), paged decode (f32 and bf16 pools,
   and an f32 query against a bf16 pool, the int8 path's; an fp8 pool with a bf16 and an f32 query; an fp8 pool at phase 7's
   B = 16 and 4096-position bucket), flash backward (BH=64,
   L=1024, D=128 causal, float32 and bfloat16, and ragged L=200 with
   D=64), fused LayerNorm forward and backward (4096 x 1024 with
   residual, float32 and bfloat16; two runs of each bitwise equal; the
   forward timed against its library call and ``torch.add(x, res)`` in
   20 interleaved pairs; the paged decode and LayerNorm rows also print
   their device time by kernel from ``torch.profiler``), K1
   (momentum, NAG) and K2 (Adam, AdamW with clip) on the training
   phase's 1.92 G-element bucket, on buckets of 5000 and 5003 elements
   and on views one element into their allocations; at the training
   bucket each is timed against its library call in 20 interleaved
   pairs (medians, the ratio's median and range, TB/s, share of the
   bound); K3 forward and backward at BERT-base's attention geometry
   (B*H = 768, L = 128, D = 64, non-causal), float32 and bfloat16, each
   timed beside its plain version and SDPA; K1 at ResNet-50 v1's bucket
   (n = 25,575,912, momentum 0.9, lr 0.1, wd 0, no clip: phase 15's
   update) against its plain rule, timed against it and
   ``torch._fused_sgd_`` in 20 interleaved pairs (the row the kernels
   line reports for K1); K3's offset form (``q_start``, the chunk
   step's) at BH = 8 x 32, C = 256, Lk = 1024, D = 128, starts in
   [0, 768], float32 and bfloat16, timed beside its plain version and
   SDPA with a boolean mask, its bound from the visible keys and pairs;
4. serving: Llama-3-8B at full width and depth in bfloat16, random
   weights from a seed, ``InferenceEngine(max_batch=8, block_size=16,
   max_context=1024)`` and a ``ContinuousBatcher`` serving 16 greedy
   requests of 32 new tokens; ``warmup()`` captures every bucket's
   prefill and decode as CUDA graphs and the phase fails unless the
   traffic only replayed them (``compiles_after_warmup`` 0); it prints
   the graphs, their capture time and the graph pool's bytes; then one
   request is teacher-forced for 16 decode steps, each replay held
   against ``_decode_body`` run eagerly on the same static inputs
   (logits within 2e-2, bitwise printed, tokens identical);
21. chunked prefill and the prefix cache (on phase 4's net, right
    after it): ``InferenceEngine(max_batch=8, block_size=16,
    max_context=1024, prefill_chunk=256, prefix_cache=True)``, a
    500-token system prompt pinned at set-up, 16 greedy requests (the
    system prompt and 16-400 tokens of their own, 32 new tokens) through
    the batcher's chunked admission, then the same requests through a
    phase-4 engine: TTFT p50 and p99, tokens/s, prompt tokens computed
    against submitted, chunk calls, prefix hit rate, forks, evictions,
    captures, capture seconds and pool bytes of both; fails unless
    ``compiles_after_warmup`` is 0 and fewer prompt tokens were computed
    than submitted; one request the run did not serve, teacher-forced
    16 steps along the prefix path and the cold path: logits within
    2e-2 (bitwise printed); one K3 offset launch a layer a chunk call;
22. speculative decoding (the same net): phase 4's engine with
    ``spec_decode=True, spec_k=4`` serves 8 greedy requests (a 64-token
    segment 4 times and 8 tokens, 64 new tokens); every stream must be
    identical to the phase-4 engine's, ``verify_steps`` above 0, and a
    verify whose drafts are the plain stream must accept every draft;
    random weights copy nothing from their prompts, so the n-gram
    drafts rarely fire: the same requests run again with each prompt
    and its plain stream (but the last token) pinned in the engine's
    prefix cache, whose continuations then draft the stream itself
    (held to the same limits); each run prints the accept rate, tokens
    per dispatch and the verify and dispatch walls beside the plain
    engine's; W x layers K5 launches a verify of width W;
24. the serving ``Router`` (on phase 4's net, after phase 22): phase
    21's engine configuration as ``Router(factory, replicas=2)``
    replicas, the system prompt pinned on each, phase 21's 16 requests
    submitted at once, three ways: ``drive()``; ``drive()`` with replica
    1 killed at its fifth boundary (``testing.faults.inject(
    "serving.replica1.step", at=5)``); threaded (``start()``,
    ``wait_all_done``) with ``add_replica()`` while the two workers run
    (they are held while the newcomer captures its graphs), the system
    prompt pinned on the newcomer and 4 requests submitted again.  Every
    stream must be phase 21's single engine's, none lost or duplicated,
    ``compiles_after_warmup`` 0 on every replica, each live pool clean
    but for its prefix chains, and the membership exact: no death and
    no requeue in the first run (epoch 0), only replica 1 dead with
    requeues above 0 after the kill (epoch 1), all three alive and no
    requeue in the threaded run (epoch 1, the add); it prints tokens/s, latency and TTFT (from submission),
    per-replica requests, occupancy, captures, capture seconds and graph
    pool bytes, requeues, epoch, peak memory, and the first run's
    ``serving_block`` as one JSON line;
25. disaggregated serving (the same net): ``Router(factory, replicas=4,
    disaggregated=True)``, rids 0 and 2 prefill (the system prompt
    pinned), 1 and 3 decode, over one pool of 2305 blocks, phase 21's
    requests: the same streams, ``handoffs`` 16 (every request outlives
    its prefill), epoch 0 with every replica alive and no requeue, the
    shared pool clean once the pins are dropped; then a fresh fleet with
    replica 0 killed mid-handoff (``inject("serving.replica0.handoff",
    at=3)``): none lost or duplicated, only replica 0 dead, epoch 1, the
    same streams, the pool clean; it prints the handoff
    time (median and max), the two pools' occupancy, tokens/s and TTFT
    beside phase 21's, the pool's bytes and peak memory.  Phases 24 and
    25 count one K3 offset launch a layer a chunk call and one K5 a
    layer a decode call, over every replica;
5. card vs CPU, serving: a 2-layer model at the full 4096/32/8/128/14336
   geometry and full vocabulary in float32, the same weights on the card
   (graphs captured at first use) and on the host (the same step
   objects run directly, plain versions), one 40-token prompt with
   prefill and 8 greedy decode steps: logits within 2e-3, identical
   tokens;
6. card vs CPU, fp8 KV: the same nets and prompt with ``kv_dtype="fp8"``
   on both, the CPU teacher-forced with the card's tokens: logits within
   2e-2, a drift against the f32 pool above 0, and on the rows computed
   from fresh inputs codes identical in 99.9% of elements and scales
   within 1e-5 relative;
20. card vs CPU, the chunk and verify steps and the prefix cache:
    phase 5's nets, f32, ``max_batch=4, block_size=16,
    max_context=256, prefill_chunk=64, prefix_cache=True,
    spec_decode=True, spec_k=3``; a 100-token prefix pinned (a partial
    tail block), two prompts continuing it (30 and 90 tokens more)
    through ``chunk_prefill``, 8 greedy decode steps, one ``verify``
    whose drafts are the card's own next 3 greedy tokens: logits within
    2e-3, tokens identical, every draft accepted; then the same with
    fp8 pools, within 2e-2; a chunk replay one K3 launch a layer, a
    verify replay W x layers K5 launches; then int8 weights on the same
    nets: ``quantize_net`` calibrates the CPU's net on 2 seeded batches
    of 2 x 12 tokens, ``convert`` carries its codes and scales to the
    card's; each of the 15 ``QuantizedDense`` twins on the same inputs
    (its own in the card's forward of the prompt, 40 rows and 1) within
    1e-6 of its output's largest magnitude, card against CPU; then an
    int8 engine (``prefill_chunk=64, spec_decode=True, spec_k=3``) on
    each runs prefill, 16 greedy decode steps, one chunk and one verify,
    the CPU teacher-forced with the card's tokens and fed the card's
    activation codes, taped from each step's body: logits within 2e-2,
    greedy picks, chunk and verify tokens identical, and the CPU's own
    activations within half a code (plus float noise) of the card's
    codes;
23. int8 weight serving (on phase 4's net, after phase 25): phase 4's
    engine is gone, ``quantize_net`` swaps all 225 projections (32 x 7
    and the head) for ``QuantizedDense`` twins after 2 seeded
    calibration batches of 2 x 12 tokens, and ``InferenceEngine(net,
    quantize="int8", max_batch=8, block_size=16, max_context=1024)``
    serves phase 4's 16 requests: ``compiles_after_warmup`` 0, 16
    teacher-forced decode replays against ``_decode_body`` run eagerly
    (logits within 2e-2, tokens identical), the prefill logits against
    the quantized net's own forward at the bucket width (within 2e-2),
    and the first prompt with 16 decode steps teacher-forced on phase
    4's tokens against a plain PyTorch forward at full width fed the
    engine's activation codes (``plain_int8_logits``: f64 products of
    the codes, plain attention; logits within 2e-3, the same greedy
    picks, its own activations within half a code plus float noise of
    the engine's codes); that prompt's drift against phase 4's bf16
    logits is printed beside the reference's bound (``|drift| <= 0.05 *
    max|logit|``), which no implementation of the reference's int8 path
    holds on these random weights (the activations' dtype alone moves
    them past it, ``tools/port_int8_drift.py``); it prints the decode
    step, the replays' device time and host share, tokens/s and TTFT p50
    beside phase 4's, the weight bytes (int8 codes and scales against
    bf16), peak memory and one decode replay's device time by class
    (int8 GEMMs, the activations' quantize and rescale, K5);
7. fp8 KV serving: Llama-3-8B bf16 at full depth with
   ``kv_dtype="fp8", max_batch=16, max_context=4096`` (4097 blocks), 32
   greedy requests with prompts of 256-3800 tokens and 32 new tokens,
   on graphs as phase 4 (the same limit, fields and graph-vs-eager
   check), then one request's drift against a bf16 pool (printed);
8. training: Llama-3-8B width at 4 layers in float32 (1.92 G
   parameters, views of the Trainer's one flat f32 buffer, which K2
   updates where it lies), batch 2 x 1024 tokens,
   ``SoftmaxCrossEntropyLoss`` and ``gluon.Trainer(..., "adamw", lr
   1e-3, wd 0.1)``, 5 steps on one batch: the loss must be finite and
   fall from step 1 to step 5, with one K2 launch per step and one flash
   forward and backward per layer per step; the step and peak memory
   are printed beside the numbers before the flat parameter buffer;
9. card vs CPU, training: one layer at the full geometry (vocabulary cut
   to 32000 to keep host memory modest), two SGD-momentum steps (K1 on
   the card, the plain rule on the host) on 64 tokens from the same
   weights: losses within 1e-4 relative, parameters within 1e-5;
10. LayerNorm op: BERT-large's 48 post-sublayer LayerNorms at 4096 x 1024
    in bfloat16 (f32 gamma/beta) through ``ops.fused_layer_norm``,
    forward and backward: gradients finite and within phase 3's
    tolerances of the plain backward; the device time of a pass by
    kernel (``torch.profiler``) beside the host clock;
12. card vs CPU, BERT through the imperative core (NDArray, autograd,
    Parameter, gluon.nn): ``get_bert_model(num_layers=2)`` at BERT-base
    width (vocab 30522, max_length 128), dropout 0, ``use_flash=True``,
    no decoder, f32, the same weights on both; two Adam steps (lr 1e-4)
    on batch 2 x 128 through ``autograd.record`` and
    ``Trainer(net.collect_params(), "adam")``: losses within 1e-4
    relative, each parameter's update within 1e-3 relative (Adam maps a
    noise-level gradient to a step of about lr, so parameters are not
    held absolutely); on the card 2 K3 forward and 2 backward launches a
    step (f32, non-causal, D = 64) and one K2;
14. card vs CPU, ResNet-50 v1 through the Gluon loop (convolutions,
    pooling, BatchNorm's running statistics): ``resnet50_v1()`` at full
    width in f32, the same weights (``Xavier(magnitude=2)``, seeded, each
    bottleneck's last BatchNorm gamma zeroed) on both, two SGD-momentum
    steps (lr 0.1, momentum 0.9) on 4 x 3 x 64 x 64, the card on
    cuDNN's deterministic algorithms: losses within 1e-4 relative, each
    parameter's two-step update within 1e-3 relative once each
    element's difference is reduced by
    the f32 rounding of storing it, an ulp a step (``update_errs``, as
    in phases 12 and 16; the body convs' biases, whose gradient is zero
    in exact arithmetic, within 1e-3 absolute), running statistics and a
    predict-mode forward after the steps within 1e-4; exactly 2 K1
    launches; then ``SpaceToDepthStem`` against the stock stem on the
    card from the same ``conv0_weight``, within 1e-4;
11. bf16 AMP training (``amp.init`` is process-wide, so phases 11, 13,
    15, 17 and 18 come last, in that order): phase 8's model, batch and AdamW under
    ``amp.init("bfloat16")``, ``amp.init_trainer`` and
    ``amp.scale_loss``, 5 steps: the loss finite and falling, its first
    value within 2e-2 relative of phase 8's, logits and loss bf16 and
    gradients f32, and exactly 20 flash forward and 20 backward
    launches, every one on bf16 inputs, and 5 K2 launches;
13. BERT-base training at ``bench.py``'s configuration
    (``get_bert_model(vocab_size=30522, max_length=128, dropout=0.0,
    use_flash=True, use_decoder=False)``, ``initialize()`` on the card,
    ``hybridize()``, batch 64 x 128 from ``RandomState(0)``, bf16 AMP,
    Adam lr 1e-4) through the MXNet loop: 3 warm-up and 10 timed steps;
    the loss finite and falling, exactly 12 K3 forward and 12 backward
    launches a step, all bf16, and one K2; it prints the step median,
    samples/s, peak memory, and, from two profiled steps, the device
    time by kernel and the step's host share;
16. card vs CPU, ``parallel.DataParallelTrainer`` (the reference's
    training entry point, on ``make_mesh({"dp": 1})``): a small conv net
    with BatchNorm (SGD momentum) and a 2-layer BERT at BERT-base width
    (Adam), f32, 3 steps, then ``set_learning_rate`` and a 4th: losses
    within 1e-4 relative and each parameter's update within 1e-3, card
    (one CUDA graph replay a step after the first) against CPU; the
    replays against the same body run eagerly on the card within 1e-5
    (bitwise printed); ``step_indexed`` over ``put_epoch`` against
    ``step`` on the same slices, ``step_accum(n_micro=2)`` against
    ``step`` on the whole batch; K1 12, K2 12, K3 32 and 32 launches;
19. checkpointing on the card: a Dense/BatchNorm net through
    ``DataParallelTrainer`` (Adam), ``CheckpointManager.save`` at step 3,
    2 more steps; a fresh trainer restores and takes the same 2 steps:
    parameters bitwise; a torn checkpoint is skipped by ``latest()``;
15. ResNet-50 v1 training at ``bench.py``'s configuration
    (``resnet50_v1()`` with the stock stem, ``initialize()`` on the
    card, ``hybridize()``, batch 128 x 3 x 224 x 224 from
    ``nd.random.uniform`` seeded 0, labels zeros, bf16 AMP, SGD lr 0.1
    momentum 0.9 on 25,575,912 trainable parameters) through the MXNet
    loop: 3 warm-up and 10 timed steps; the loss finite and falling,
    bf16 logits, the running statistics finite and moved, and exactly one
    K1 launch a step; it prints the step median, images/s, peak memory,
    and, from two profiled steps, the device time by kernel class
    (convolutions forward and backward, cuDNN's layout transposes,
    BatchNorm, casts, K1, the gradient gather) and the step's host
    share;
17. ResNet-50 v1 through ``DataParallelTrainer``, ``bench.py``'s
    ``_bench_resnet`` with nothing cut (``resnet50_v1(s2d_stem=True)``,
    bf16 AMP, batch 128 from ``nd.random.uniform``, zero labels, SGD lr
    0.1 momentum 0.9): 3 warm-up steps (the first eager, the second
    captured), 20 timed, each one graph replay with one K1 launch; step
    median, images/s, peak memory, captures, capture seconds, graph pool
    bytes, the replay's device time (CUDA events) and host share, and
    the device time by class from two profiled steps;
18. BERT-base through ``DataParallelTrainer`` at ``bench.py``'s
    ``_bench_bert`` (bf16 AMP, batch 64 x 128 from ``RandomState(0)``,
    Adam lr 1e-4): as phase 17, with one K2 and 12 bf16 K3 forward and
    backward launches a replay.

Phases 4 and 7 also print, from a pass after the timed run (so the
run's steps are measured as they run without it) that replays each
decode step on its own staged inputs, the replays' device time (CUDA
events around ``graph.replay()``) and each step's host share beside
it.  Before
each of phases 4, 7-19 and 20-25 the kernels' launch counters are set to 0; each phase reads them just after and fails unless its kernels
ran the expected number of times.  The second-to-last line is the
card's name and power limit, the line before it the kernels' JSON
record, and the line before that every timed row of phase 3 as
``{"kernel_rows": [...]}``; the last line is ``{"ok": true, "device":
{...}}``.
"""
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12            # HBM3, H100 SXM data sheet
# dense tensor-core peaks; f32-accurate products run as 3xTF32 (three
# TF32 products each), so f32 gets 495 TF/s TF32 / 3
PEAK_FLOPS = {"float32": 495e12 / 3,
              "bfloat16": 989e12}
FLASH_TOL = {"float32": (5e-5, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
# the backward's dp - delta cancels: f32 noise is relative to the terms
FLASH_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
PAGED_TOL = {"float32": (5e-5, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
# K4: y and dx in their dtype; dgamma/dbeta are f32 sums over 4096 rows
# taken in another order than the plain version's
LN_TOL = {"float32": (5e-5, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
LN_PARAM_TOL = (1e-3, 1e-4)
FP8_LOGIT_ATOL = 2e-2
FP8_CODES_SAME = 0.999
FP8_SCALE_RTOL = 1e-5
# nvcc contracts a*b + c into one FMA; the plain rule rounds twice
UPDATE_TOL = (1e-7, 1e-6)
LOGIT_ATOL = 2e-3
# graph replay against the eager decode body (bf16 logits): about one
# bf16 ulp at |logit| 2-4; greedy tokens must be identical
GRAPH_LOGIT_ATOL = 2e-2
GRAPH_CHECK_STEPS = 16
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
CHUNK = 1 << 26                       # plain update rule, per chunk
UPDATE_PAIRS = 20                     # K1/K2 against the library, in turns
LN_PAIRS = 20                         # K4 forward, its library call, x + res
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2, 1024, 5
# phase 8 before the flat parameter buffer, with the gathered bucket
# (PERF.md §6; NVIDIA H100 80GB HBM3 at 700 W)
TRAIN_PREV = {"peak_gb": 46.42, "step_ms": "386.2-387.8"}
# phase 11's first loss against phase 8's (same weights and batch): the
# loss is rounded to bf16 (spacing 2**-4 = 0.0625 between 8 and 16, 0.5%
# of a loss near 12.6) after bf16 matmuls and a bf16 log-softmax over
# 128256 logits
AMP_FIRST_LOSS_RTOL = 2e-2


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, flush, cover=200_000):
    """Median device time of ``fn`` in ms over ``iters`` calls, each timed
    alone as ``interleaved_ms`` times it (the L2 cache flushed before it:
    the serving path finds K/V cold); the median keeps one slow call (an
    allocation, a clock change) out of the number."""
    return statistics.median(
        interleaved_ms({"fn": fn}, iters, flush, cover)["fn"])


def interleaved_ms(fns, rounds, flush, cover=200_000):
    """{name: [device ms of each call]} of the callables in ``fns``, one
    call of each a round, in the given order on even rounds and reversed
    on odd ones (kernel, library, library, kernel, ...), each call timed
    alone by CUDA events with the L2 cache flushed before it.  ``cover``:
    cycles the card sleeps ahead of each timed call while the host
    enqueues it, so the events time the kernel and not the Python
    wrapper."""
    import torch
    names = list(fns)
    for name in names:
        fns[name]()
    torch.cuda.synchronize()
    events = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            flush.zero_()
            torch.cuda._sleep(cover)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            events[name].append((start, end))
    torch.cuda.synchronize()
    return {name: [s.elapsed_time(e) for s, e in ev]
            for name, ev in events.items()}


def max_err(got, want, tol):
    """Largest |got - want| and whether every element is within
    ``atol + rtol * |want|``."""
    import torch
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool(torch.all(diff <= tol[0] + tol[1] * want.abs()))
    return float(diff.max()), ok


# ----------------------------------------------------------------------
# shared checks
# ----------------------------------------------------------------------

def read_launches(phase, want, got=None):
    """Every kernel's launch count since the last ``reset_launches`` (or
    ``got``, a path's counts summed over its windows); fails unless the
    kernels in ``want`` ran exactly that often (at least once) and every
    other kernel not at all."""
    from mxnet_tpu_torch import ops
    got = ops.launch_counts() if got is None else got
    full = {name: want.get(name, 0) for name in got}
    if got != full or min(want.values()) < 1:
        fail(f"{phase}: kernel launches {got}, expected {full}")
    return got


def copy_weights(src, dst):
    """Copy a port block's parameters into another's of the same
    structure, by structural name, device to device (no numpy); returns
    ``dst``."""
    import torch
    want = dst._collect_params_with_prefix()
    with torch.no_grad():
        for name, p in src._collect_params_with_prefix().items():
            want[name].set_data(p.data().data)
    return dst


def update_errs(w0, got, want, steps, skip=()):
    """Each parameter's update from ``w0``, one run (``got``) against
    another (``want``), as ``|du_got - du_want| / |du_want|`` over float32
    arrays by name, after each element's difference has been reduced by
    ``steps`` ulps of the parameter's magnitude (and not below zero).

    That reduction is the rounding of storing the parameter: each step
    rounds the new value by up to half an ulp on each run, so ``steps``
    steps may move the two stored updates apart by ``steps`` ulps with no
    difference at all in what was added.  Where an update is only some
    tens of ulps of its parameter (a BatchNorm gamma near 1 behind a
    zeroed gamma: ResNet-50's ``features.4.0.body.4.gamma`` moves by
    about 5e-6 an element, 44 ulps) those roundings alone made the
    relative difference 2.9e-3 between two CPU runs that differ only in
    their thread count."""
    import numpy as np
    out = {}
    for k in w0:
        if k in skip:
            continue
        du = want[k] - w0[k]
        mag = np.maximum(np.maximum(np.abs(w0[k]), np.abs(got[k])),
                         np.abs(want[k])).astype(np.float32)
        diff = np.maximum(np.abs((got[k] - w0[k]) - du) -
                          steps * np.spacing(mag), 0.0)
        out[k] = float(np.linalg.norm(diff) /
                       max(float(np.linalg.norm(du)), 1e-30))
    return out


def graph_vs_eager(eng, prompt):
    """Teacher-force one request through ``eng``'s graphs: after each of
    ``GRAPH_CHECK_STEPS`` decode replays, run ``_decode_body`` eagerly on
    the same static inputs (it writes the same K/V rows again) and
    compare its logits with the replay's.  Fails unless the greedy
    tokens agree and the logits are within ``GRAPH_LOGIT_ATOL``; returns
    the text for the phase's line."""
    import torch
    from mxnet_tpu_torch.serving import next_bucket
    slot = "graph-check"
    tok, _ = eng.prefill(slot, prompt)
    fed = list(prompt) + [tok]
    worst, bitwise = 0.0, True
    for _ in range(GRAPH_CHECK_STEPS):
        pos = len(fed) - 1
        if not eng.reserve(slot, pos):
            fail("graph check: KV pool exhausted")
        nxt, logits = eng.decode([(slot, fed[-1], pos)])
        nbl = next_bucket(pos + 1, eng.buckets) // eng.block_size
        want = eng._decode_body(*eng._steps["decode", nbl].args)[:1]
        bitwise = bitwise and bool(torch.equal(logits, want))
        worst = max(worst, float((logits.float() - want.float()).abs()
                                 .max()))
        if int(nxt[0]) != int(torch.argmax(want[0])):
            fail(f"graph replay picked token {int(nxt[0])}, the eager "
                 f"body {int(torch.argmax(want[0]))} at position {pos}")
        fed.append(int(nxt[0]))
    eng.release(slot)
    if not worst <= GRAPH_LOGIT_ATOL:
        fail(f"graph replay vs eager decode body: max |logit| diff "
             f"{worst:.3e} > {GRAPH_LOGIT_ATOL}")
    return (f"graph vs eager, {len(prompt)}-token prompt, "
            f"{GRAPH_CHECK_STEPS} decode steps: bitwise {bitwise}, max "
            f"|logit| diff {worst:.3e} (limit {GRAPH_LOGIT_ATOL}), tokens "
            f"identical")


def graph_text(eng):
    """The phase line's graph fields; fails if traffic missed the cache."""
    if eng.stats["compiles_after_warmup"]:
        fail(f"{eng.stats['compiles_after_warmup']} graphs captured after "
             "warmup: traffic must only replay")
    return (f"{eng.graphs_captured()} CUDA graphs captured in "
            f"{eng.capture_seconds:.2f} s, graph pool "
            f"{eng.graph_pool_bytes()} bytes reserved, compiles after "
            f"warmup 0")


ROWS = []        # every timed (kernel, dtype, shape) of phase 3


def record(kernel, dtype, shape, ms, plain_ms, library_ms, bound_ms, by,
           device_ms=None, add_ms=None):
    """Keep one timed row of phase 3 for the ``kernel_rows`` line."""
    row = {"kernel": kernel, "dtype": dtype, "shape": shape, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": by}
    if device_ms is not None:
        row["device_ms"] = device_ms
    if add_ms is not None:
        row["add_ms"] = add_ms
    ROWS.append(row)


def device_ms(fn, iters, flush=None):
    """{kernel: device ms a call} of ``fn`` from ``torch.profiler`` over
    ``iters`` calls, the L2 cache flushed before each where ``flush`` is
    given (the flush's own kernel left out): no launch latency and no
    host time in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and not any(
                w in e.key.lower() for w in ("fill", "memset")):
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].removeprefix("void ")
            out[name] = out.get(name, 0.0) + \
                e.self_device_time_total / 1e3 / iters
    return out


def by_kernel(times):
    """``device_ms``'s result as printed text."""
    return ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()) or \
        "not measured"


def bound(nbytes, flops, dtype_name):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ----------------------------------------------------------------------
# phase 2: what ptxas and the SASS say about the flash kernels
# ----------------------------------------------------------------------

def flash_kernel_report():
    """For every kernel of the two flash libraries: registers and spill
    bytes (ptxas, from the build log), the dynamic shared memory its
    launch asks for, and its ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync)
    instructions in the SASS.  Fails if a flash kernel spills, a bf16 one
    issues no HGMMA or an f32 one (3xTF32) no HMMA."""
    import ctypes
    import re
    from mxnet_tpu_torch.ops import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for lib_name, smem_fn in (("flash_attention", "flash_attention_fwd_smem"),
                              ("flash_attention_bwd",
                               "flash_attention_bwd_smem")):
        with open(_build.log_path(lib_name)) as f:
            log = f.read()
        path = _build.build([lib_name])[lib_name]
        sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                              text=True, timeout=300)
        if sass.returncode != 0:
            fail(f"cuobjdump -sass {path}: {sass.stderr.strip()}")
        funcs = {m[1]: m[2] for m in re.finditer(
            r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass.stdout,
            re.S)}
        lib = ctypes.CDLL(path)         # its own handle: the ops' argtypes
        smem = getattr(lib, smem_fn)                      # stay untouched
        smem.restype = ctypes.c_int
        for entry in log.split("Compiling entry function '")[1:]:
            mangled = entry.split("'")[0]
            m = re.search(r"((?:flash_fwd|flash_bwd|delta)\w*?kernel)I(\w*?)"
                          r"Li(\d+)E", mangled)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", entry)
            if not (m and regs and spill):
                fail(f"{lib_name}: unreadable ptxas entry {mangled}")
            name, d = m[1], int(m[3])
            bf16 = "bfloat16" in m[2] or "bf16" in name
            if name == "delta_kernel":
                nbytes = 0
            elif lib_name == "flash_attention":
                nbytes = smem(int(bf16), d)
            else:
                nbytes = smem(int(bf16), d, int("_dq_" in name))
            # the forward's offset instantiations (``q_start``) end Lb1E
            tag = (f"{name}<{'bf16' if bf16 else 'f32'}, D={d}"
                   f"{', offset' if 'Lb1E' in mangled else ''}>")
            body = funcs.get(mangled, "")
            hgmma, hmma = body.count("HGMMA"), body.count("HMMA")
            n_sass = len(re.findall(r"/\*[0-9a-f]{4,}\*/ +[@A-Z]", body))
            print(f"ptxas {tag}: {regs[1]} registers, {spill[1]} bytes spill "
                  f"stores, {spill[2]} bytes spill loads, {nbytes} bytes "
                  f"shared memory; {hgmma} HGMMA, {hmma} HMMA of {n_sass} "
                  f"instructions in SASS", flush=True)
            if name == "delta_kernel":
                continue
            if int(spill[1]) > 0 or (hgmma if bf16 else hmma) == 0:
                fail(f"{tag}: no {'wgmma' if bf16 else 'mma.sync'} in its "
                     f"SASS, or it spills")


def ptxas_report(lib_names):
    """For every kernel of the named libraries: registers, spill bytes,
    stack and static shared memory as ptxas reports them (names demangled
    where the toolkit has ``cu++filt``).  Fails if one spills.  K4's row
    kernels also take dynamic shared memory: the forward 2 * 4 * D bytes
    (gamma and beta in f32; 8 KB at D = 1024), the backward (1 + 16 /
    WPR) * 4 * D bytes (68 KB); their resident CTAs a SM at phase 3's
    D = 1024 are printed, and those of K1/K2's
    ``update_kernel<rule, clip, U>`` (rule 0 SGD, 1 momentum,
    2 NAG, 3 Adam, 4 AdamW), which size their persistent grid."""
    import ctypes
    import re
    from mxnet_tpu_torch.ops import _build
    filt = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    spilled = []
    for lib_name in lib_names:
        with open(_build.log_path(lib_name)) as f:
            entries = f.read().split("Compiling entry function '")[1:]
        mangled = [e.split("'")[0] for e in entries]
        names = mangled
        if os.path.exists(filt):
            out = subprocess.run([filt], input="\n".join(mangled),
                                 capture_output=True, text=True, timeout=60)
            if out.returncode == 0:
                names = out.stdout.splitlines()
        for name, entry in zip(names, entries):
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", entry)
            smem = re.search(r"(\d+) bytes smem", entry)
            stack = re.search(r"(\d+) bytes stack frame", entry)
            if not (regs and spill):
                fail(f"{lib_name}: unreadable ptxas entry {name}")
            name = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "",
                          name)
            name = re.sub(r"^void |\(int\)|\([^()]*\)$", "", name)
            print(f"ptxas {name}: {regs[1]} registers, {spill[1]} bytes spill "
                  f"stores, {spill[2]} bytes spill loads, "
                  f"{stack[1] if stack else 0} bytes stack, "
                  f"{smem[1] if smem else 0} bytes static shared memory",
                  flush=True)
            if int(spill[1]) > 0 or int(spill[2]) > 0:
                spilled.append(name)
    if spilled:
        fail(f"these kernels spill: {spilled}")
    lib = ctypes.CDLL(_build.build(["fused_layernorm"])["fused_layernorm"])
    resident = lib.fused_layer_norm_resident
    resident.argtypes = [ctypes.c_int] * 7
    for backward, kernel in ((0, "ln_fwd_rows"), (1, "ln_bwd_rows")):
        for dtype, name in ((0, "f32"), (1, "bf16")):
            print(f"{kernel} {name} at D=1024: "
                  f"{resident(backward, 1, 1024, 1, dtype, 0, 0)} / "
                  f"{resident(backward, 0, 1024, 1, dtype, 0, 0)} resident "
                  f"CTAs a SM of 8 warps (16-byte / scalar loads)",
                  flush=True)
    lib = ctypes.CDLL(_build.build(["fused_update"])["fused_update"])
    resident = lib.fused_update_resident
    resident.argtypes = [ctypes.c_int] * 3
    print("update_kernel resident CTAs a SM of 256 threads, by rule 0-4 "
          "without / with the clip: " + ", ".join(
              f"{r}: {resident(r, 0, 0)}/{resident(r, 1, 0)}"
              for r in range(5)), flush=True)


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------

def check_flash(dev, flush):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    H, D = 32, 128
    main = None
    worst = 0.0
    for L in (16, 128, 200, 1024):
        for name in ("float32", "bfloat16"):
            dtype = getattr(torch, name)
            g = torch.Generator(device=dev).manual_seed(L)
            q, k, v = (torch.randn(H, L, D, device=dev, generator=g)
                       .to(dtype) for _ in range(3))
            out, lse = flash_attention_fwd(q, k, v, True)
            ref, ref_lse = flash_attention_plain(q, k, v, True, D ** -0.5)
            torch.cuda.synchronize()
            err, ok = max_err(out, ref, FLASH_TOL[name])
            lerr, lok = max_err(lse, ref_lse, (1e-4, 1e-4))
            if not (ok and lok):
                fail(f"flash kernel vs plain at L={L} {name}: max |out| "
                     f"err {err}, max |lse| err {lerr}")
            worst = max(worst, err) if name == "bfloat16" else worst
            ms = time_ms(lambda: flash_attention_fwd(q, k, v, True), 20,
                         flush)
            plain_ms = time_ms(
                lambda: flash_attention_plain(q, k, v, True, D ** -0.5), 5,
                flush)
            qs, ks, vs = (t[None] for t in (q, k, v))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True), 20, flush)
            elem = q.element_size()
            nbytes = 4 * H * L * D * elem + 4 * H * L     # q,k,v,o + lse
            flops = 4.0 * H * D * (L * (L + 1) / 2)      # causal pairs
            bound_ms, by = bound(nbytes, flops, name)
            print(f"flash_attention_fwd L={L} {name}: max_abs_err {err:.3e} "
                  f"lse_err {lerr:.3e} kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms sdpa {lib_ms:.4f} ms "
                  f"({ms / lib_ms:.2f}x sdpa) bound {bound_ms:.4f} ms "
                  f"({by}; {bound_ms / ms:.1%} of it)", flush=True)
            record("flash_attention_fwd", name, [H, L, D], ms, plain_ms,
                   lib_ms, bound_ms, by)
            if L == 1024 and name == "bfloat16":
                main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=by)
    main["max_abs_err"] = worst
    return main


PAGED_SHAPE = dict(B=8, H=32, KVH=8, D=128, bs=16, nbl=64)
# phase 7's decode geometry: 16 sequences, a 4096-position bucket
PAGED_LONG = dict(PAGED_SHAPE, B=16, nbl=256)


def paged_tables(dev, B=PAGED_SHAPE["B"], bs=PAGED_SHAPE["bs"],
                 nbl=PAGED_SHAPE["nbl"]):
    """K5's check inputs, from seed 0: tables of scattered blocks (row 0
    full, row 1 idle on the null block) and positions drawn below
    ``nbl * bs``.  Returns (pos as numpy, tables and pos as int32 on
    ``dev``)."""
    import numpy as np
    import torch
    nb = 1 + B * nbl
    rng = np.random.RandomState(0)
    pos = rng.randint(0, nbl * bs, B).astype(np.int32)
    pos[0], pos[1] = nbl * bs - 1, 0                   # full row, idle row
    tables = np.zeros((B, nbl), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    for i in range(B):
        n = int(pos[i]) // bs + 1 if i != 1 else 0    # idle: null table
        tables[i, :n], perm = perm[:n], perm[n:]
    return (pos, torch.from_numpy(tables).to(dev),
            torch.from_numpy(pos).to(dev))


def check_paged(dev, flush):
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                     paged_decode_plain)
    B, H, KVH, D, bs, nbl = PAGED_SHAPE.values()
    nb = 1 + B * nbl
    pos, tab, ps = paged_tables(dev)
    main = None
    worst = 0.0
    # the query's dtype and the pool's: f32 and bf16 models, and the f32
    # queries of int8 weights against a bf16 pool (phase 23)
    for name, pool in (("float32", "float32"), ("bfloat16", "bfloat16"),
                       ("float32", "bfloat16")):
        dtype = getattr(torch, name)
        g = torch.Generator(device=dev).manual_seed(1)
        q = torch.randn(B, H, D, device=dev, generator=g).to(dtype)
        kp, vp = (torch.randn(nb, bs, KVH, D, device=dev, generator=g)
                  .to(getattr(torch, pool)) for _ in range(2))
        out = paged_decode_attention(q, kp, vp, tab, ps, D ** -0.5)
        ref = paged_decode_plain(q, kp, vp, tab, ps, D ** -0.5)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, PAGED_TOL[name])
        if not ok or not bool(torch.isfinite(out).all()):
            fail(f"paged kernel vs plain {name}, {pool} pool: max abs err "
                 f"{err}")
        worst = max(worst, err) if name == "bfloat16" else worst
        ms = time_ms(lambda: paged_decode_attention(q, kp, vp, tab, ps,
                                                    D ** -0.5), 50, flush)
        dev_ms = device_ms(lambda: paged_decode_attention(
            q, kp, vp, tab, ps, D ** -0.5), 20, flush)
        plain_ms = time_ms(lambda: paged_decode_plain(q, kp, vp, tab, ps,
                                                      D ** -0.5), 5, flush)
        elem = q.element_size()
        rows = int((pos.astype(np.int64) + 1).sum())
        nbytes = (2 * rows * KVH * D * kp.element_size() + 2 * B * H * D *
                  elem + sum(int(p) // bs + 1 for p in pos) * 4 + B * 4)
        bound_ms, by = bound(nbytes, 4.0 * rows * H * D, name)
        label = name if pool == name else f"{name} query, {pool} pool"
        print(f"paged_decode_attention B={B} pos<= {int(pos.max())} "
              f"{label}: max_abs_err {err:.3e} kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms bound {bound_ms:.4f} ms; device "
              f"{by_kernel(dev_ms)}", flush=True)
        record("paged_decode_attention", label,
               [B, H, KVH, D, int(pos.max())], ms, plain_ms, None, bound_ms,
               by, dev_ms)
        if name == pool == "bfloat16":
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                        bound_ms=bound_ms, bound_by=by)
    main["max_abs_err"] = worst
    return main


def check_paged_fp8(dev, flush):
    """K5's fp8 path: pools quantized on the card by ``kv_quantize_fp8``,
    against the plain fp8 version on the same codes and scales; at
    ``check_paged``'s shapes with a bf16 and an f32 query, and at phase
    7's decode geometry (``PAGED_LONG``: B = 16, positions from seed 0 up
    to 4095) with a bf16 query."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                     paged_decode_plain)
    from mxnet_tpu_torch.ops.quant_kv import kv_quantize_fp8
    main = None
    worst = 0.0
    for shape, name in ((PAGED_SHAPE, "bfloat16"), (PAGED_SHAPE, "float32"),
                        (PAGED_LONG, "bfloat16")):
        B, H, KVH, D, bs, nbl = shape.values()
        nb = 1 + B * nbl
        pos, tab, ps = paged_tables(dev, B, bs, nbl)
        g = torch.Generator(device=dev).manual_seed(2)
        (kp, ks), (vp, vs) = (kv_quantize_fp8(
            torch.randn(nb, bs, KVH, D, device=dev, generator=g))
            for _ in range(2))
        q = torch.randn(B, H, D, device=dev, generator=g).to(
            getattr(torch, name))

        def kernel():
            return paged_decode_attention(q, kp, vp, tab, ps, D ** -0.5,
                                          k_scale=ks, v_scale=vs)

        def plain():
            return paged_decode_plain(q, kp, vp, tab, ps, D ** -0.5, ks, vs)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, PAGED_TOL[name])
        if not ok or not bool(torch.isfinite(out).all()):
            fail(f"paged fp8 kernel vs plain, {name} query: max abs err "
                 f"{err}")
        worst = max(worst, err)
        ms = time_ms(kernel, 50, flush)
        dev_ms = device_ms(kernel, 20, flush)
        plain_ms = time_ms(plain, 5, flush)
        rows = int((pos.astype(np.int64) + 1).sum())
        elem = q.element_size()
        nbytes = (2 * rows * KVH * D + 2 * rows * 4 + 2 * B * H * D * elem
                  + sum(int(p) // bs + 1 for p in pos) * 4 + B * 4)
        bound_ms, by = bound(nbytes, 4.0 * rows * H * D, name)
        print(f"paged_decode_attention fp8 pool, {name} query, B={B} pos<= "
              f"{int(pos.max())}: max_abs_err {err:.3e} kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({by}); "
              f"device {by_kernel(dev_ms)}", flush=True)
        record("paged_decode_attention_fp8", name,
               [B, H, KVH, D, int(pos.max())], ms, plain_ms, None, bound_ms,
               by, dev_ms)
        if name == "bfloat16" and shape is PAGED_SHAPE:
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                        bound_ms=bound_ms, bound_by=by)
        del kp, vp, ks, vs
    main["max_abs_err"] = worst
    return main


def check_layernorm(dev, flush):
    """K4 forward and backward against the plain versions at BERT-large's
    post-sublayer shape (8 x 512 tokens = 4096 rows, D = 1024, residual,
    eps 1e-12), f32 and bf16 activations with f32 gamma/beta; library
    (near: the residual add is a separate pass): ``F.layer_norm(x + res)``
    forward, and its backward alone through a retained graph; the
    forward also against ``torch.add(x, res)``, which moves its bytes,
    the three timed in ``LN_PAIRS`` interleaved pairs.  Two runs of each
    kernel must be bitwise equal."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.fused_layernorm import (fused_layer_norm_bwd,
                                                     fused_layer_norm_fwd,
                                                     layer_norm_bwd_plain,
                                                     layer_norm_plain)
    rows, D, eps = 4096, 1024, 1e-12
    res_fwd, res_bwd = {}, {}
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        g = torch.Generator(device=dev).manual_seed(3)
        x, res, dy = (torch.randn(rows, D, device=dev, generator=g)
                      .to(dtype) for _ in range(3))
        gamma, beta = (torch.randn(D, device=dev, generator=g)
                       for _ in range(2))
        y = fused_layer_norm_fwd(x, res, gamma, beta, eps)
        y_again = fused_layer_norm_fwd(x, res, gamma, beta, eps)
        got = fused_layer_norm_bwd(x, res, gamma, dy, eps)
        again = fused_layer_norm_bwd(x, res, gamma, dy, eps)
        want_y = layer_norm_plain(x, res, gamma, beta, eps)
        want = layer_norm_bwd_plain(x, res, gamma, dy, eps)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"fused_layer_norm_bwd {name}: two runs differ")
        if not torch.equal(y, y_again):
            fail(f"fused_layer_norm_fwd {name}: two runs differ")
        err_f, ok = max_err(y, want_y, LN_TOL[name])
        if not ok or not bool(torch.isfinite(y).all()):
            fail(f"fused_layer_norm_fwd vs plain {name}: max abs err {err_f}")
        err_b = 0.0
        for a, b, what, tol in zip(got, want, ("dx", "dgamma", "dbeta"),
                                   (LN_TOL[name], LN_PARAM_TOL,
                                    LN_PARAM_TOL)):
            e, ok = max_err(a, b, tol)
            if not ok or not bool(torch.isfinite(a).all()):
                fail(f"fused_layer_norm_bwd vs plain {name}: max |{what}| "
                     f"err {e}")
            err_b = max(err_b, e)
        elem = x.element_size()
        # the library yardstick, weights in the activations' type: the
        # forward without a graph, the backward alone through a retained
        # graph, with the card kept busy while autograd enqueues it
        lx, lres, lg, lb = (t.detach().to(dtype).requires_grad_()
                            for t in (x, res, gamma, beta))
        lib_out = F.layer_norm(lx + lres, (D,), lg, lb, eps)

        def lib_fwd():
            with torch.no_grad():
                return F.layer_norm(x + res, (D,), lg, lb, eps)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (lx, lres, lg, lb), dy,
                                       retain_graph=True)

        y_add = torch.empty_like(x)

        def add():
            return torch.add(x, res, out=y_add)

        for what, kernel, plain, library, nbytes in (
                ("fwd", lambda: fused_layer_norm_fwd(x, res, gamma, beta,
                                                     eps),
                 lambda: layer_norm_plain(x, res, gamma, beta, eps), lib_fwd,
                 3 * rows * D * elem + 2 * D * 4),
                ("bwd", lambda: fused_layer_norm_bwd(x, res, gamma, dy, eps),
                 lambda: layer_norm_bwd_plain(x, res, gamma, dy, eps),
                 lib_bwd, 4 * rows * D * elem + 3 * D * 4)):
            dev_ms = device_ms(kernel, 20, flush)
            plain_ms = time_ms(plain, 10, flush)
            bound_ms, by = bound(nbytes, 10.0 * rows * D, "float32")
            add_ms, pairs = None, ""
            if what == "fwd":
                # the kernel, its library call and x + res (the forward's
                # bytes: read two rows, write one) in turns
                times = interleaved_ms({"kernel": kernel, "library": library,
                                        "add": add}, LN_PAIRS, flush,
                                       cover=1_000_000)
                ms, lib_ms, add_ms = (statistics.median(times[k])
                                      for k in ("kernel", "library", "add"))
                pairs = "; " + "; ".join(
                    ratio_text(times["kernel"], times[k], k)
                    for k in ("library", "add"))
            else:
                ms = time_ms(kernel, 20, flush, cover=1_000_000)
                lib_ms = time_ms(library, 20, flush, cover=2_000_000)
            print(f"fused_layer_norm_{what} {rows}x{D} {name}, residual: "
                  f"max_abs_err {err_f if what == 'fwd' else err_b:.3e} "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
                  f"(near) {lib_ms:.4f} ms"
                  + ("" if add_ms is None else f" torch.add {add_ms:.4f} ms")
                  + f" bound {bound_ms:.4f} ms ({by}; {bound_ms / ms:.1%} of "
                  f"it); device {by_kernel(dev_ms)}{pairs}", flush=True)
            record(f"fused_layer_norm_{what}", name, [rows, D], ms, plain_ms,
                   lib_ms, bound_ms, by, device_ms=dev_ms, add_ms=add_ms)
            out = res_fwd if what == "fwd" else res_bwd
            out.setdefault("max_abs_err", 0.0)
            out["max_abs_err"] = max(out["max_abs_err"],
                                     err_f if what == "fwd" else err_b)
            if name == "bfloat16":            # the K4 path phase's type
                out.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=by)
        del x, res, dy, y, y_again, got, again, want_y, want, lx, lres, \
            lib_out, y_add
    torch.cuda.empty_cache()
    return {"fused_layer_norm_fwd": res_fwd, "fused_layer_norm_bwd": res_bwd}


def check_flash_bwd(dev, flush):
    """The backward kernel against the plain backward at the training
    phase's shape (B=2 x H=32 heads, L=1024, D=128, causal) and a ragged
    one (L=200, D=64); library: the backward of
    ``scaled_dot_product_attention`` alone, through a retained graph,
    with the card kept busy while autograd enqueues it."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd)
    B, H = 2, 32
    main = None
    worst = 0.0
    for L, D in ((1024, 128), (200, 64)):
        for name in ("float32", "bfloat16"):
            dtype = getattr(torch, name)
            g = torch.Generator(device=dev).manual_seed(L + D)
            q, k, v, do = (torch.randn(B * H, L, D, device=dev, generator=g)
                           .to(dtype) for _ in range(4))
            out, lse = flash_attention_fwd(q, k, v, True)
            got = flash_attention_bwd(q, k, v, out, lse, do, True)
            want = flash_attention_bwd_plain(q, k, v, out, lse, do, True,
                                             D ** -0.5)
            torch.cuda.synchronize()
            err = 0.0
            for a, b, what in zip(got, want, ("dq", "dk", "dv")):
                e, ok = max_err(a, b, FLASH_BWD_TOL[name])
                if not ok or not bool(torch.isfinite(a).all()):
                    fail(f"flash backward kernel vs plain at L={L} D={D} "
                         f"{name}: max |{what}| err {e}")
                err = max(err, e)
            worst = max(worst, err)
            ms = time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do,
                                                     True), 10, flush)
            plain_ms = time_ms(lambda: flash_attention_bwd_plain(
                q, k, v, out, lse, do, True, D ** -0.5), 10, flush)
            qs, ks, vs = (t.view(B, H, L, D).detach().requires_grad_()
                          for t in (q, k, v))
            gs = do.view(B, H, L, D)

            sdpa_out = F.scaled_dot_product_attention(qs, ks, vs,
                                                      is_causal=True)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                sdpa_out, (qs, ks, vs), gs, retain_graph=True), 10, flush,
                cover=2_000_000)
            elem = q.element_size()
            nbytes = 8 * B * H * L * D * elem + 4 * B * H * L  # 5 in, 3 out
            flops = 10.0 * B * H * D * (L * (L + 1) / 2)      # 5 products
            bound_ms, by = bound(nbytes, flops, name)
            print(f"flash_attention_bwd BH={B * H} L={L} D={D} {name}: "
                  f"max_abs_err {err:.3e} kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms sdpa-bwd {lib_ms:.4f} ms "
                  f"({ms / lib_ms:.2f}x sdpa) bound {bound_ms:.4f} ms "
                  f"({by}; {bound_ms / ms:.1%} of it)", flush=True)
            record("flash_attention_bwd", name, [B * H, L, D], ms, plain_ms,
                   lib_ms, bound_ms, by)
            if L == 1024 and name == "float32":   # the training phase's
                main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=by)
            del q, k, v, do, out, lse, got, want, qs, ks, vs, gs, sdpa_out
    main["max_abs_err"] = worst
    return main


BERT_ATTN = dict(B=64, H=12, L=128, D=64)     # phases 12-13's geometry


def check_flash_bert(dev, flush):
    """K3 forward and backward at BERT-base's attention geometry, batch
    64 x 128 tokens: (B*H = 768, L = 128, D = 64), non-causal, scale
    1/8, in float32 and bfloat16, each against its plain version, timed
    beside the plain version and SDPA (forward, and its backward alone
    through a retained graph), with its bound."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain)
    B, H, L, D = (BERT_ATTN[k] for k in "BHLD")
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        g = torch.Generator(device=dev).manual_seed(B * H)
        q, k, v, do = (torch.randn(B * H, L, D, device=dev, generator=g)
                       .to(dtype) for _ in range(4))
        out, lse = flash_attention_fwd(q, k, v, False)
        ref, ref_lse = flash_attention_plain(q, k, v, False, D ** -0.5)
        got = flash_attention_bwd(q, k, v, out, lse, do, False)
        want = flash_attention_bwd_plain(q, k, v, out, lse, do, False,
                                         D ** -0.5)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, FLASH_TOL[name])
        lerr, lok = max_err(lse, ref_lse, (1e-4, 1e-4))
        if not (ok and lok):
            fail(f"flash kernel vs plain at BERT's shape {name}: max |out| "
                 f"err {err}, max |lse| err {lerr}")
        berr = 0.0
        for a, b, what in zip(got, want, ("dq", "dk", "dv")):
            e, ok = max_err(a, b, FLASH_BWD_TOL[name])
            if not ok or not bool(torch.isfinite(a).all()):
                fail(f"flash backward kernel vs plain at BERT's shape "
                     f"{name}: max |{what}| err {e}")
            berr = max(berr, e)
        qs, ks, vs = (t.view(B, H, L, D).detach().requires_grad_()
                      for t in (q, k, v))
        elem = q.element_size()
        for kernel, e, fn, plain, lib, nbytes, flops, cover in (
                ("flash_attention_fwd", err,
                 lambda: flash_attention_fwd(q, k, v, False),
                 lambda: flash_attention_plain(q, k, v, False, D ** -0.5),
                 lambda: F.scaled_dot_product_attention(qs, ks, vs),
                 4 * B * H * L * D * elem + 4 * B * H * L,
                 4.0 * B * H * D * L * L, 200_000),
                ("flash_attention_bwd", berr,
                 lambda: flash_attention_bwd(q, k, v, out, lse, do, False),
                 lambda: flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                   False, D ** -0.5),
                 None, 8 * B * H * L * D * elem + 4 * B * H * L,
                 10.0 * B * H * D * L * L, 2_000_000)):
            if lib is None:              # SDPA's backward alone
                sdpa_out = F.scaled_dot_product_attention(qs, ks, vs)
                gs = do.view(B, H, L, D)
                lib = (lambda o=sdpa_out, gg=gs: torch.autograd.grad(
                    o, (qs, ks, vs), gg, retain_graph=True))
            ms = time_ms(fn, 20, flush)
            plain_ms = time_ms(plain, 5, flush)
            lib_ms = time_ms(lib, 20, flush, cover=cover)
            bound_ms, by = bound(nbytes, flops, name)
            print(f"{kernel} BERT-base BH={B * H} L={L} D={D} non-causal "
                  f"{name}: max_abs_err {e:.3e} kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms sdpa {lib_ms:.4f} ms "
                  f"({ms / lib_ms:.2f}x sdpa) bound {bound_ms:.4f} ms "
                  f"({by}; {bound_ms / ms:.1%} of it)", flush=True)
            record(kernel, name, [B * H, L, D, "non-causal"], ms, plain_ms,
                   lib_ms, bound_ms, by)
        del q, k, v, do, out, lse, got, want, qs, ks, vs
    torch.cuda.empty_cache()


# phase 21's chunk step at its widest table: 8 rows of 32 heads, chunks of
# 256 queries against 64 blocks of 16 positions, starts up to 768
CHUNK_ATTN = dict(R=8, H=32, C=256, Lk=1024, D=128, start_max=768)


def check_flash_offset(dev, flush):
    """K3's offset form (``q_start``) at the chunk step's shape: BH = 8 x
    32, C = 256 queries, Lk = 1024 keys, D = 128, each row's start drawn
    in [0, 768] from seed 0 and repeated over its 32 heads, in float32
    and bfloat16, against its plain version, timed beside the plain
    version and SDPA with a boolean mask ("near": it reads every key);
    the bound counts only the keys a row can see (bytes) and the pairs
    it can see (FLOPs).  Returns the bfloat16 row, the chunk path's."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    R, H, C, Lk, D = (CHUNK_ATTN[k] for k in ("R", "H", "C", "Lk", "D"))
    g = torch.Generator(device=dev).manual_seed(0)
    starts = torch.randint(0, CHUNK_ATTN["start_max"] + 1, (R,), device=dev,
                           generator=g, dtype=torch.int32)
    q_start = starts.repeat_interleave(H)
    # SDPA's mask: query i of row r sees key j when j <= start_r + i
    mask = (torch.arange(Lk, device=dev)[None, None, :] <=
            starts.long()[:, None, None] +
            torch.arange(C, device=dev)[None, :, None])[:, None]
    visible = (starts.long() + C).clamp(max=Lk)          # keys a row reads
    pairs = float(sum(C * int(s) + C * (C + 1) // 2 for s in starts.tolist()))
    main = None
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        q = torch.randn(R * H, C, D, device=dev, generator=g).to(dtype)
        k, v = (torch.randn(R * H, Lk, D, device=dev, generator=g).to(dtype)
                for _ in range(2))
        with torch.no_grad():
            out, lse = flash_attention_fwd(q, k, v, True, q_start=q_start)
            ref, ref_lse = flash_attention_plain(q, k, v, True, D ** -0.5,
                                                 q_start=q_start)
        torch.cuda.synchronize()
        err, ok = max_err(out, ref, FLASH_TOL[name])
        lerr, lok = max_err(lse, ref_lse, (1e-4, 1e-4))
        if not (ok and lok):
            fail(f"flash offset kernel vs plain {name}: max |out| err {err}, "
                 f"max |lse| err {lerr}")
        qs, ks, vs = (t.view(R, H, -1, D) for t in (q, k, v))
        with torch.no_grad():
            ms = time_ms(lambda: flash_attention_fwd(q, k, v, True,
                                                     q_start=q_start),
                         20, flush)
            plain_ms = time_ms(lambda: flash_attention_plain(
                q, k, v, True, D ** -0.5, q_start=q_start), 5, flush)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask), 20, flush)
        elem = q.element_size()
        nbytes = (2 * R * H * C * D + 2 * H * int(visible.sum()) * D) * elem \
            + 4 * R * H * C                                  # + lse
        flops = 4.0 * H * D * pairs
        bound_ms, by = bound(nbytes, flops, name)
        print(f"flash_attention_fwd offset BH={R * H} C={C} Lk={Lk} D={D} "
              f"starts {sorted(starts.tolist())} {name}: max_abs_err "
              f"{err:.3e} lse_err {lerr:.3e} kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms sdpa (boolean mask, near) {lib_ms:.4f} ms "
              f"({ms / lib_ms:.2f}x sdpa) bound {bound_ms:.4f} ms ({by}; "
              f"{bound_ms / ms:.1%} of it)", flush=True)
        record("flash_attention_fwd_offset", name, [R * H, C, Lk, D],
               ms, plain_ms, lib_ms, bound_ms, by)
        if name == "bfloat16":
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=bound_ms, bound_by=by, max_abs_err=err)
        del q, k, v, out, lse, ref, ref_lse, qs, ks, vs
    torch.cuda.empty_cache()
    return main


def _chunks(n):
    return [slice(i, min(i + CHUNK, n)) for i in range(0, n, CHUNK)]


def _library_update(rule, hyper, p, g, s, lr, wd, step):
    """The nearest single PyTorch call on the one flat tensor ("near":
    torch puts eps after the bias-corrected sqrt(v), has no clip, and
    its momentum convention differs)."""
    import torch
    if rule in ("adam", "adamw"):
        fn = torch._fused_adamw_ if rule == "adamw" else torch._fused_adam_
        fn([p], [g], [s["m"]], [s["v"]], [], [step], lr=lr,
           beta1=hyper["beta1"], beta2=hyper["beta2"], weight_decay=wd,
           eps=hyper["epsilon"], amsgrad=False, maximize=False)
    else:
        torch._fused_sgd_([p], [g], [s["mom"]], weight_decay=wd,
                          momentum=hyper["momentum"], lr=lr, dampening=0.0,
                          nesterov=rule == "nag", maximize=False,
                          is_first_step=False)


def ratio_text(kernel_ms, other_ms, other):
    """The median and range of kernel / ``other`` by pair, and in how
    many pairs the kernel was ahead."""
    ratios = [k / o for k, o in zip(kernel_ms, other_ms)]
    return (f"kernel/{other} median {statistics.median(ratios):.4f} (range "
            f"{min(ratios):.4f}-{max(ratios):.4f}, kernel ahead in "
            f"{sum(r < 1 for r in ratios)} of {len(ratios)} pairs)")


def pair_summary(kernel_ms, library_ms, nbytes, bound_ms):
    """(text, kernel median, library median) of interleaved pairs: both
    medians, the median and range of kernel / library by pair, the
    kernel's achieved TB/s and its share of the bound."""
    ratios = [k / l for k, l in zip(kernel_ms, library_ms)]
    ms = statistics.median(kernel_ms)
    lib_ms = statistics.median(library_ms)
    text = (f"{len(ratios)} pairs: kernel median {ms:.4f} ms, library "
            f"{lib_ms:.4f} ms, kernel/library median "
            f"{statistics.median(ratios):.4f} "
            f"(range {min(ratios):.4f}-{max(ratios):.4f}, kernel ahead in "
            f"{sum(r < 1 for r in ratios)}), {nbytes / ms / 1e9:.3f} TB/s, "
            f"{bound_ms / ms:.1%} of the bound")
    return text, ms, lib_ms


def update_case(rule, n, dev):
    """p, the gradient and the rule's state of ``n`` elements from a
    seeded generator."""
    import torch
    g_ = torch.Generator(device=dev).manual_seed(n % 1009)
    p = torch.randn(n, device=dev, generator=g_)
    grad = torch.randn(n, device=dev, generator=g_)
    if rule.startswith("adam"):
        return p, grad, {"m": torch.randn(n, device=dev, generator=g_) * 0.1,
                         "v": torch.rand(n, device=dev, generator=g_) * 0.01,
                         "t": 3}
    return p, grad, {"mom": torch.randn(n, device=dev, generator=g_) * 0.1}


def device_scalars(lr, s, dev):
    """``lr`` and the rule's state ``s`` as the update kernels take them
    on the card: ``lr`` a one-element float32 tensor, Adam's ``t`` (the
    count before the update) a one-element int32 tensor, both read when
    the kernel runs."""
    import torch
    s = dict(s)
    if "t" in s:
        s["t"] = torch.tensor([int(s["t"])], dtype=torch.int32, device=dev)
    return torch.tensor([lr], dtype=torch.float32, device=dev), s


def copy_at(t, offset):
    """A copy of the flat ``t`` that starts ``offset`` elements into its
    own allocation."""
    import torch
    return torch.empty(t.numel() + offset, dtype=t.dtype,
                       device=t.device)[offset:].copy_(t)


def check_updates(dev, flush, n_big):
    """K1 (momentum, NAG) and K2 (Adam, AdamW, with clip) against the
    plain rule on the training phase's bucket of ``n_big`` elements, on
    buckets of 5000 and 5003 (a scalar tail) and on views one element
    into their allocations (a scalar head).  The kernel updates copies of
    p and the state in place; the plain rule, elementwise, runs on chunks
    of the same inputs.  At ``n_big`` the kernel and its library call
    are timed in ``UPDATE_PAIRS`` interleaved pairs."""
    import torch
    from mxnet_tpu_torch.ops.fused_update import fused_bucket_rule
    from mxnet_tpu_torch.optimizer import fused_rule
    lr, wd, rescale, clip = 1e-3, 0.1, 0.5, 1.0
    cases = [("adamw", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
             ("adam", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
             ("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9})]
    results = {}
    for rule, hyper in cases:
        kernel_name = "fused_adam_update" if rule.startswith("adam") \
            else "fused_sgd_update"
        for n, offset in ((n_big, 0), (5000, 0), (5003, 0), (5000, 1),
                          (5003, 1)):
            p, grad, s = update_case(rule, n, dev)
            _, apply = fused_bucket_rule(rule, clip_gradient=clip, **hyper)
            _, plain = fused_rule(rule, clip_gradient=clip, **hyper)
            # the kernel's copies of p and the state, every stream (the
            # gradient too) ``offset`` elements into its allocation
            kp = copy_at(p, offset)
            lr_dev, ks = device_scalars(lr, {
                k: copy_at(v, offset) if torch.is_tensor(v) else v
                for k, v in s.items()}, dev)
            kp, ks = apply(kp, copy_at(grad, offset) if offset else grad, ks,
                           lr_dev, wd, rescale)             # in place
            err = 0.0
            for c in _chunks(n):
                want_p, want_s = plain(
                    p[c], grad[c], {k: v[c] if torch.is_tensor(v) else v
                                    for k, v in s.items()}, lr, wd, rescale)
                pairs = [(kp[c], want_p)] + [
                    (ks[k][c], want_s[k]) for k in ks if k != "t"]
                for got, want in pairs:
                    e, ok = max_err(got, want, UPDATE_TOL)
                    if not ok:
                        fail(f"{kernel_name} ({rule}) vs plain at n={n}, "
                             f"offset {offset}: max abs err {e}")
                    err = max(err, e)
            del want_p, want_s, pairs
            res = results.setdefault(kernel_name, {"max_abs_err": 0.0})
            res["max_abs_err"] = max(res["max_abs_err"], err)
            if offset or n == 5003:
                print(f"{kernel_name} ({rule}, clip) n={n} offset {offset}: "
                      f"max_abs_err {err:.3e}", flush=True)
                continue

            def plain_pass():
                for c in _chunks(n):    # each chunk's result is dropped
                    plain(p[c], grad[c], {
                        k: v[c] if torch.is_tensor(v) else v
                        for k, v in s.items()}, lr, wd, rescale)

            def kernel():
                apply(kp, grad, ks, lr_dev, wd, rescale)

            step = torch.tensor(3.0, device=dev)

            def library():
                _library_update(rule, hyper, kp, grad, ks, lr, wd, step)

            per_elem = 28 if kernel_name == "fused_adam_update" else 20
            flops = (20.0 if kernel_name == "fused_adam_update" else 8.0) * n
            bound_ms, by = bound(per_elem * n, flops, "float32")
            plain_ms = time_ms(plain_pass, 3, flush)
            pairs_text = ""
            if n == n_big:
                times = interleaved_ms({"kernel": kernel,
                                        "library": library}, UPDATE_PAIRS,
                                       flush)
                pairs_text, ms, lib_ms = pair_summary(
                    times["kernel"], times["library"], per_elem * n,
                    bound_ms)
                pairs_text = "; " + pairs_text
            else:
                ms = time_ms(kernel, 10, flush)
                lib_ms = time_ms(library, 10, flush)
            print(f"{kernel_name} ({rule}, clip) n={n}: max_abs_err "
                  f"{err:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                  f"library (near) {lib_ms:.4f} ms bound {bound_ms:.4f} ms "
                  f"({by}){pairs_text}", flush=True)
            record(kernel_name, f"float32 {rule}", [n], ms, plain_ms, lib_ms,
                   bound_ms, by)
            # the training phases' rules at the training bucket
            if n == n_big and rule in ("adamw", "sgd"):
                res.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=by)
            del p, grad, s, kp, ks
            torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------------
# phase 4: the serving path at full width
# ----------------------------------------------------------------------

# The two serving cells, phase 4's and phase 7's, over Llama-3-8B in
# bf16 with block_size 16; tools/port_serving_pairs.py serves the same
# requests through two trees' engines.
SERVING_CELLS = {
    "bf16": dict(kv_dtype=None, max_batch=8, max_context=1024,
                 requests=16, lengths=(16, 901)),
    "fp8": dict(kv_dtype="fp8", max_batch=16, max_context=4096,
                requests=32, lengths=(256, 3801))}
NEW_TOKENS = 32


def serving_engine(serving, net, cell, dev):
    """``serving.InferenceEngine`` over ``net`` in the cell's geometry,
    warmed up (``serving`` is a port's serving package)."""
    eng = serving.InferenceEngine(
        net, kv_dtype=cell["kv_dtype"], max_batch=cell["max_batch"],
        block_size=16, max_context=cell["max_context"], device=dev)
    eng.warmup()
    return eng


def serving_prompts(cell, vocab):
    """The cell's prompts, drawn from seed 0, and the generator after
    them."""
    import numpy as np
    rng = np.random.RandomState(0)
    lengths = rng.randint(*cell["lengths"], cell["requests"])
    return [rng.randint(0, vocab, n) for n in lengths], rng


def _pct(values, p):
    """The ``p`` quantile of ``values`` by nearest rank, as the batcher's
    latency percentiles take it."""
    v = sorted(values)
    return v[min(len(v) - 1, int(round(p * (len(v) - 1))))]


def serve_requests(serving, eng, prompts, label, new_tokens=NEW_TOKENS):
    """Serve ``prompts``, ``new_tokens`` greedy tokens each and all
    submitted at t = 0, through ``serving.ContinuousBatcher`` on
    ``eng``.  Fails unless every request finished with
    ``new_tokens`` tokens and every logit was finite.  Returns the
    finished requests, the tokens generated, the wall seconds and the
    three metrics: the decode step median (host clock around
    ``decode``, which returns after a host read of the sampled tokens),
    tokens per second over the run and TTFT p50 (and p99); each decode
    step's wall, largest position and staged inputs (a host copy of the
    engine's staging buffer), for :func:`replay_device`; the walls of
    the ``verify`` and ``chunk_prefill`` calls, where the engine makes
    them, and each verify call's longest row; and the batcher's
    stats."""
    import torch
    finite, step_s, step_pos, staged = [], [], [], []
    verify_s, verify_rows, chunk_s = [], [], []
    # an older tree's engine (tools/port_serving_pairs.py) may lack the
    # last two
    calls = {name: getattr(eng, name) for name in
             ("prefill", "decode", "verify", "chunk_prefill")
             if hasattr(eng, name)}

    def prefill_checked(slot, tokens):
        out = calls["prefill"](slot, tokens)
        if out is not None:
            finite.append(torch.isfinite(out[1]).all())
        return out

    def decode_checked(entries):
        t = time.perf_counter()
        nxt, logits = calls["decode"](entries)   # returns after a host sync
        step_s.append(time.perf_counter() - t)
        step_pos.append(max(p for _, _, p in entries))
        staged.append(eng._stage_np.copy())
        finite.append(torch.isfinite(logits).all())
        return nxt, logits

    def verify_timed(entries):
        t = time.perf_counter()
        out = calls["verify"](entries)           # returns host tokens
        verify_s.append(time.perf_counter() - t)
        verify_rows.append(max(len(row) for _, row, _ in entries))
        return out

    def chunk_checked(entries):
        t = time.perf_counter()
        out = calls["chunk_prefill"](entries)    # returns host tokens
        if out is not None:
            chunk_s.append(time.perf_counter() - t)
            finite.append(torch.isfinite(torch.as_tensor(
                out[1], device=eng.device)).all())
        return out

    wrapped = {"prefill": prefill_checked, "decode": decode_checked,
               "verify": verify_timed, "chunk_prefill": chunk_checked}
    for name in calls:
        setattr(eng, name, wrapped[name])
    try:
        batcher = serving.ContinuousBatcher(eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            batcher.submit(serving.Request(p, new_tokens, request_id=i))
        stats = batcher.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        # drop the instance attributes: no cycle keeps the engine alive
        for name in calls:
            delattr(eng, name)
    done = batcher.finished
    if len(done) != len(prompts) or any(len(r.generated) != new_tokens
                                        for r in done):
        fail(f"{label}: not every request finished with {new_tokens} "
             "tokens")
    if not bool(torch.stack(finite).all()):
        fail(f"{label}: non-finite logits on the serving path")
    tokens = stats["tokens_generated"]
    ttft = [r.ttft() for r in done]
    return {"finished": done, "tokens": tokens, "wall_s": wall,
            "steps": len(step_s), "step_s": step_s, "step_pos": step_pos,
            "staged": staged, "verify_s": verify_s,
            "verify_rows": verify_rows, "chunk_s": chunk_s,
            "stats": stats,
            "step_ms": statistics.median(step_s) * 1e3 if step_s else None,
            "tokens_per_s": tokens / wall,
            "ttft_p50_ms": statistics.median(ttft) * 1e3,
            "ttft_p99_ms": _pct(ttft, 0.99) * 1e3}


def replay_device(eng, run, label):
    """The decode replays' device time, taken after the timed run so
    that its steps run as they do without measurement: each decode step
    of the run is staged again with its own inputs and its graph
    replayed once, with CUDA events recorded on the stream around
    ``graph.replay()``.  Each step's device time is set beside its wall
    in the run: the host share ``1 - device / wall``.  Call it when the
    engine's KV pool is no longer read (the replays write their K/V rows
    again, into blocks that may since have been freed)."""
    import torch
    from mxnet_tpu_torch.serving.engine import next_bucket
    device_s = []
    for pos, staged in zip(run["step_pos"], run["staged"]):
        nbl = next_bucket(pos + 1, eng.buckets) // eng.block_size
        step = eng._steps[("decode", nbl)]
        if step.graph is None:
            fail(f"{label}: decode step {nbl} has no graph")
        eng._stage_np[:] = staged
        step.flat.copy_(eng._stage[:step.flat.numel()])
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        step.graph.replay()
        end.record()
        end.synchronize()
        device_s.append(start.elapsed_time(end) / 1e3)
    share = [1 - d / w for d, w in zip(device_s, run["step_s"])]
    return (f"{label}: decode replay device time, each of the run's "
            f"{len(share)} steps replayed after it on its own inputs (CUDA "
            f"events around graph.replay()): median "
            f"{statistics.median(device_s) * 1e3:.3f} ms (range "
            f"{min(device_s) * 1e3:.3f}-{max(device_s) * 1e3:.3f}); host "
            f"share 1 - device/wall median {statistics.median(share):.4f} "
            f"(range {min(share):.4f}-{max(share):.4f})")


def serve_llama3_8b(dev, card):
    import torch
    from mxnet_tpu_torch import ops, serving
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama3_8b
    cell = SERVING_CELLS["bf16"]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    net = llama3_8b(device=dev, dtype=torch.bfloat16, seed=0)
    eng = serving_engine(serving, net, cell, dev)
    setup_s = time.perf_counter() - t0
    prompts, rng = serving_prompts(cell, net.cfg.vocab_size)
    ops.reset_launches()
    run = serve_requests(serving, eng, prompts, "serving")
    launches = read_launches("serving", {
        "flash_attention_fwd": net.cfg.num_layers * eng.stats["prefill_calls"],
        "flash_attention_fwd_bf16":
            net.cfg.num_layers * eng.stats["prefill_calls"],
        "paged_decode_attention":
            net.cfg.num_layers * eng.stats["decode_calls"]})
    lengths = [len(p) for p in prompts]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"serving llama3_8b bf16 on {card}: {len(prompts)} requests, "
          f"prompts {min(lengths)}-{max(lengths)} tokens, {run['tokens']} "
          f"tokens in {run['wall_s']:.3f} s = {run['tokens_per_s']:.1f} "
          f"tokens/s; TTFT p50 {run['ttft_p50_ms']:.1f} ms; decode step "
          f"median {run['step_ms']:.2f} ms over {run['steps']} steps; "
          f"peak memory {peak_gb:.2f} GB; set-up {setup_s:.1f} s; "
          f"{graph_text(eng)}; launches {launches}", flush=True)
    print(graph_vs_eager(eng, rng.randint(0, net.cfg.vocab_size,
                                          500).tolist()), flush=True)
    print(replay_device(eng, run, "serving"), flush=True)
    # phase 23's references: the metrics, and the first prompt's greedy
    # tokens and logits over 16 decode steps (outside the counted window)
    fed, logits = _greedy(eng, "int8-ref", prompts[0].tolist(),
                          TEACHER_STEPS)
    ref = {"step_ms": run["step_ms"], "tokens_per_s": run["tokens_per_s"],
           "ttft_p50_ms": run["ttft_p50_ms"], "peak_gb": peak_gb,
           "prompt": prompts[0].tolist(), "fed": fed, "logits": logits}
    del eng, run
    gc.collect()
    torch.cuda.empty_cache()
    return launches, net, ref


# ----------------------------------------------------------------------
# phases 21 and 22: chunked prefill with the prefix cache, and
# speculative decoding, at full width on phase 4's net
# ----------------------------------------------------------------------

# phase 21: phase 4's engine with chunked prefill and the prefix cache;
# 16 requests, each a 500-token system prompt (31 blocks and 4 tokens)
# and 16-400 tokens of its own
PREFIX_CELL = dict(max_batch=8, max_context=1024, prefill_chunk=256,
                   requests=16, system=500, unique=(16, 401))
# phase 22: phase 4's engine with speculative decoding; 8 requests whose
# prompts repeat a 64-token segment 4 times and end with 8 tokens
SPEC_CELL = dict(spec_k=4, requests=8, segment=64, repeats=4, tail=8,
                 new_tokens=64)
TEACHER_STEPS = 16


def prefix_prompts(vocab):
    """Phase 21's system prompt, requests and teacher-forced request,
    from seed 21."""
    import numpy as np
    rng = np.random.RandomState(21)
    system = rng.randint(0, vocab, PREFIX_CELL["system"]).tolist()
    lengths = rng.randint(*PREFIX_CELL["unique"], PREFIX_CELL["requests"])
    prompts = [system + rng.randint(0, vocab, n).tolist() for n in lengths]
    # the teacher-forced request: one the run never served, 300 tokens
    # past the system prompt (two chunks)
    return system, prompts, system + rng.randint(0, vocab, 300).tolist()


def spec_prompts(vocab):
    """Phase 22's requests, from seed 22."""
    import numpy as np
    rng = np.random.RandomState(22)
    c = SPEC_CELL
    return [rng.randint(0, vocab, c["segment"]).tolist() * c["repeats"] +
            rng.randint(0, vocab, c["tail"]).tolist()
            for _ in range(c["requests"])]


def _prefix_path(eng, slot, prompt, n):
    """A request along the prefix path: attach the cached chain, chunk the
    rest, then ``n`` greedy decode steps.  (fed tokens, logits)."""
    import torch
    start = eng.attach_prefix(slot, prompt)
    if start == 0:
        fail("prefix path: the system prompt missed the prefix cache")
    C = eng.prefill_chunk
    while start < len(prompt):
        out = eng.chunk_prefill([(slot, prompt[start:start + C], start)])
        if out is None:
            fail("prefix path: KV pool exhausted")
        start += len(prompt[start:start + C])
    fed = list(prompt) + [int(out[0][0])]
    logits = [torch.as_tensor(out[1][0], device=eng.device).float()]
    for _ in range(n):
        pos = len(fed) - 1
        if not eng.reserve(slot, pos):
            fail("KV pool exhausted")
        nxt, lg = eng.decode([(slot, fed[-1], pos)])
        fed.append(int(nxt[0]))
        logits.append(lg[0].float())
    eng.release(slot)
    return fed, logits


def _serving_line(label, eng, run, computed, submitted, card):
    st = eng.stats
    pc = eng.prefix_cache
    steps = run["step_s"] + run["verify_s"]
    return (f"{label} on {card}: {len(run['finished'])} requests, "
            f"{run['tokens']} tokens in {run['wall_s']:.3f} s = "
            f"{run['tokens_per_s']:.1f} tokens/s; TTFT p50 "
            f"{run['ttft_p50_ms']:.1f} ms p99 {run['ttft_p99_ms']:.1f} ms; "
            f"dispatch median {statistics.median(steps) * 1e3:.2f} ms over "
            f"{len(steps)} ({len(run['verify_s'])} verify); prompt tokens "
            f"computed {computed} of {submitted} submitted; prefill calls {st['prefill_calls']}, chunk calls "
            f"{st['chunk_prefill_calls']} (median "
            f"{statistics.median(run['chunk_s']) * 1e3 if run['chunk_s'] else 0:.2f}"
            f" ms); prefix hit rate "
            f"{None if pc is None else pc.hit_rate()}, forks "
            f"{eng.cache.cow_copies}, evictions "
            f"{0 if pc is None else pc.evictions}; {graph_text(eng)}")


def serve_prefix_and_spec(dev, card, net):
    """Phases 21 and 22 on phase 4's net (Llama-3-8B, bf16, 32 layers).

    21: an engine with ``prefill_chunk=256, prefix_cache=True`` (phase
    4's otherwise), the system prompt pinned at set-up, serves
    PREFIX_CELL's 16 requests (32 new tokens) through the batcher's
    chunked admission; the same requests through a phase-4 engine.  Then
    a request the run did not serve teacher-forced for 16 steps along the
    prefix path and the cold path: logits within ``GRAPH_LOGIT_ATOL``.

    22: an engine with ``spec_decode=True, spec_k=4`` serves SPEC_CELL's
    8 requests (64 new tokens); the phase-4 engine serves them plainly.
    Every stream identical, ``verify_steps`` > 0, and a verify whose
    drafts are the plain stream accepts every draft.  The engine also
    has a prefix cache, which serial admission leaves empty; the same
    requests then run again with each one's prompt and plain stream
    (but its last token) pinned, so the drafts, the cache's
    continuations, land.  Returns the launch counts of the three paths
    (chunked prefix serving, speculative serving, the second
    speculative run), each from zeroed counters, and phase 21's system
    prompt, requests, streams (by request id) and metrics, the
    reference of phases 24 and 25."""
    import torch
    from mxnet_tpu_torch import ops, serving
    from mxnet_tpu_torch.serving.engine import next_bucket
    cfg = net.cfg
    layers = cfg.num_layers
    cell = SERVING_CELLS["bf16"]
    system, prompts, teacher = prefix_prompts(cfg.vocab_size)
    submitted = sum(len(p) for p in prompts)

    # phase 21: chunked prefill and the prefix cache
    t0 = time.perf_counter()
    eng = serving.InferenceEngine(
        net, max_batch=PREFIX_CELL["max_batch"], block_size=16,
        max_context=PREFIX_CELL["max_context"],
        prefill_chunk=PREFIX_CELL["prefill_chunk"], prefix_cache=True,
        device=dev).warmup()
    if not eng.pin_prefix(system):
        fail("chunked prefix serving: the system prompt did not fit")
    setup_s = time.perf_counter() - t0
    pinned = eng.stats["prompt_tokens_computed"]
    ops.reset_launches()
    run = serve_requests(serving, eng, prompts, "chunked prefix serving")
    calls = eng.stats["chunk_prefill_calls"]
    chunked = read_launches("chunked prefix serving", {
        "flash_attention_fwd": layers * calls,
        "flash_attention_fwd_bf16": layers * calls,
        "flash_attention_fwd_offset": layers * calls,
        "paged_decode_attention": layers * eng.stats["decode_calls"]})
    computed = eng.stats["prompt_tokens_computed"] - pinned
    if computed >= submitted:
        fail("chunked prefix serving: computed every prompt token")
    print(_serving_line("chunked prefix serving llama3_8b bf16 "
                        "(prefill_chunk 256)", eng, run, computed, submitted,
                        card)
          + f"; system prompt pinned at set-up ({pinned} tokens); set-up "
          f"{setup_s:.1f} s; launches {chunked}", flush=True)
    prefix_fed, prefix_lg = _prefix_path(eng, "teacher", teacher,
                                         TEACHER_STEPS)
    eng.cache.check_leaks(holders=eng.prefix_cache.held_blocks())
    # phases 24 and 25's references: the streams and metrics
    phase21 = {"system": system, "prompts": prompts,
               "streams": {r.id: r.generated for r in run["finished"]},
               "tokens_per_s": run["tokens_per_s"],
               "ttft_p50_ms": run["ttft_p50_ms"],
               "ttft_p99_ms": run["ttft_p99_ms"]}
    del eng, run
    gc.collect()
    torch.cuda.empty_cache()

    # the phase-4 engine: phase 21's requests, the cold path, phase 22's
    # requests served plainly
    eng = serving_engine(serving, net, cell, dev)
    run = serve_requests(serving, eng, prompts, "cold serving")
    print(_serving_line("the same requests through phase 4's engine", eng,
                        run, eng.stats["prompt_tokens_computed"], submitted,
                        card), flush=True)
    cold_lg = _replay(eng, "teacher", teacher, prefix_fed, TEACHER_STEPS)
    eng.release("teacher")
    worst = max(float((a - b).abs().max())
                for a, b in zip(prefix_lg, cold_lg))
    bitwise = all(torch.equal(a, b) for a, b in zip(prefix_lg, cold_lg))
    print(f"prefix path vs cold path, {len(teacher)}-token prompt, "
          f"prefill and {TEACHER_STEPS} teacher-forced decode steps: max "
          f"|logit| diff {worst:.3e} (limit {GRAPH_LOGIT_ATOL}), bitwise "
          f"{bitwise}", flush=True)
    if not worst <= GRAPH_LOGIT_ATOL:
        fail("the prefix path and the cold path disagree")
    sprompts = spec_prompts(cfg.vocab_size)
    new = SPEC_CELL["new_tokens"]
    plain = serve_requests(serving, eng, sprompts, "plain serving", new)
    streams = {r.id: r.generated for r in plain["finished"]}
    plain_tpd = plain["stats"]["tokens_per_dispatch"]
    plain_step_ms = plain["step_ms"]
    print(f"phase 22's requests through phase 4's engine: "
          f"{plain['tokens']} tokens in {plain['wall_s']:.3f} s = "
          f"{plain['tokens_per_s']:.1f} tokens/s; TTFT p50 "
          f"{plain['ttft_p50_ms']:.1f} ms; decode step median "
          f"{plain['step_ms']:.2f} ms over {plain['steps']} steps, tokens "
          f"per dispatch {plain_tpd}", flush=True)
    del eng, run, plain
    gc.collect()
    torch.cuda.empty_cache()

    # phase 22: speculative decoding; the prefix cache serves only as the
    # draft source of the second run (serial admission never fills it)
    t0 = time.perf_counter()
    eng = serving.InferenceEngine(
        net, max_batch=cell["max_batch"], block_size=16,
        max_context=cell["max_context"], spec_decode=True,
        spec_k=SPEC_CELL["spec_k"], prefix_cache=True, device=dev).warmup()
    setup_s = time.perf_counter() - t0
    n_prompt = sum(len(p) for p in sprompts)

    def speculative_run(label, pins=()):
        """Serve phase 22's requests through ``eng`` from zeroed launch
        counters (after pinning ``pins``); fails unless every stream is
        the plain engine's and a verify step ran.  (run, launches)."""
        ops.reset_launches()
        before = eng.stats["prefill_calls"]
        for p in pins:
            if not eng.pin_prefix(p):
                fail(f"{label}: a pinned prompt did not fit")
        run = serve_requests(serving, eng, sprompts, label, new)
        prefills = eng.stats["prefill_calls"] - before
        decodes = run["steps"]
        widths = [next_bucket(max(w, 2), eng._verify_widths())
                  for w in run["verify_rows"]]
        launches = read_launches(label, {
            "flash_attention_fwd": layers * prefills,
            "flash_attention_fwd_bf16": layers * prefills,
            "paged_decode_attention": layers * (decodes + sum(widths))})
        got = {r.id: r.generated for r in run["finished"]}
        st = run["stats"]
        if got != streams:
            bad = [i for i in streams if got[i] != streams[i]]
            fail(f"{label}: streams {bad} differ from the plain engine's")
        if not st["verify_steps"] > 0:
            fail(f"{label}: no verify step ran")
        verify = (f"{statistics.median(run['verify_s']) * 1e3:.2f} ms"
                  if run["verify_s"] else "none")
        print(_serving_line(f"{label} llama3_8b bf16 (spec_k 4)", eng, run,
                            n_prompt, n_prompt, card)
              + f"; verify steps {st['verify_steps']} of "
              f"{st['decode_steps']} dispatches, widths "
              f"{sorted(set(widths))}, verify median {verify} against the "
              f"plain engine's decode step {plain_step_ms:.2f} ms; accept "
              f"rate {st['spec_accept_rate']}, tokens per dispatch "
              f"{st['tokens_per_dispatch']} (plain {plain_tpd}); streams "
              f"identical to the plain engine's; set-up {setup_s:.1f} s; "
              f"launches {launches}", flush=True)
        return launches

    spec = speculative_run("speculative serving")
    # teacher-forced verify: the plain stream as drafts
    prompt, plain0 = sprompts[0], streams[0]
    k = SPEC_CELL["spec_k"]
    tok, _ = eng.prefill("teacher", prompt)
    if tok != plain0[0]:
        fail("speculative engine's first token differs from the plain one")
    if not eng.reserve("teacher", len(prompt), k + 1):
        fail("KV pool exhausted")
    out = eng.verify([("teacher", plain0[:k + 1], len(prompt))])
    eng.release("teacher")
    if list(out[0, :k + 1]) != plain0[1:k + 2]:
        fail(f"teacher-forced verify: {list(out[0, :k + 1])} against the "
             f"plain stream {plain0[1:k + 2]}")
    print(f"teacher-forced verify of {k} drafts from the plain stream: "
          f"every draft accepted, the bonus token equal", flush=True)
    # drafts that land: each request's prompt and all but the last of its
    # plain tokens pinned, so the prefix cache's continuation proposes
    # the greedy stream itself
    spec_landing = speculative_run(
        "speculative serving, drafts from pinned continuations",
        [p + streams[i][:-1] for i, p in enumerate(sprompts)])
    partial_verify(eng, prompt, plain0, k, cfg.vocab_size)
    eng.cache.check_leaks(holders=eng.prefix_cache.held_blocks())
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return chunked, spec, spec_landing, phase21


def partial_verify(eng, prompt, plain, k, vocab):
    """A teacher-forced ``verify`` that commits part of its window, on
    phase 22's engine.  ``prompt`` and ``m`` plain tokens are fed (the
    plain decode step), so that position ``pos = len(prompt) + m`` sits
    near the end of a block, and registered in the prefix cache, which
    then shares that partial tail block.  The verify's drafts follow the
    ``plain`` stream but the second is wrong: its write-ahead forks the
    shared block and opens the next one.  Fails unless the committed
    tokens (the scheduler's rule) are the matching prefix and the bonus
    token, the trim drops exactly the block that only rejected drafts
    covered, the pool balances with the chain's holds after the trim,
    and one decode step from the trimmed state gives the plain stream's
    next token."""
    slot, bs = "partial", eng.block_size
    L = len(prompt)
    m = next(m for m in range(bs) if bs - k <= (L + m) % bs <= bs - 2)
    tok, _ = eng.prefill(slot, prompt)
    fed = list(prompt) + [tok]
    for _ in range(m):
        pos = len(fed) - 1
        if not eng.reserve(slot, pos):
            fail("KV pool exhausted")
        fed.append(int(eng.decode([(slot, fed[-1], pos)])[0][0]))
    if fed[L:] != plain[:m + 1]:
        fail(f"partial verify: the fed tokens {fed[L:]} are not the plain "
             f"stream {plain[:m + 1]}")
    pos = L + m
    eng.insert_prefix(slot, fed[:pos])
    forks = eng.cache.cow_copies
    if not eng.reserve(slot, pos, k + 1):
        fail("KV pool exhausted")
    if eng.cache.cow_copies != forks + 1:
        fail("partial verify: the write-ahead did not fork the shared "
             "tail block")
    row = plain[m:m + k + 1]
    row[2] = (plain[m + 2] + 1) % vocab
    out = eng.verify([(slot, row, pos)])
    committed, j = [int(out[0, 0])], 1
    while j < len(row) and row[j] == int(out[0, j - 1]):
        committed.append(int(out[0, j]))
        j += 1
    if committed != plain[m + 1:m + 3]:
        fail(f"partial verify: committed {committed} against the plain "
             f"stream's {plain[m + 1:m + 3]}")
    n = pos + len(committed)
    held = len(eng.cache.table(slot))
    eng.cache.trim(slot, n)
    eng.cache.set_len(slot, n)
    dropped = held - len(eng.cache.table(slot))
    if dropped != 1:
        fail(f"partial verify: the trim dropped {dropped} blocks, not the "
             f"one past the committed length")
    eng.cache.check_leaks(holders=eng.prefix_cache.held_blocks())
    if not eng.reserve(slot, n):
        fail("KV pool exhausted")
    nxt = int(eng.decode([(slot, committed[-1], n)])[0][0])
    eng.release(slot)
    if nxt != plain[m + 3]:
        fail(f"partial verify: after the trim decode gives {nxt}, the "
             f"plain stream {plain[m + 3]}")
    print(f"teacher-forced verify at position {pos} (block offset "
          f"{pos % bs} of {bs}), second of {k} drafts wrong: committed "
          f"{committed} (1 draft and the bonus token), the shared tail "
          f"block forked, the trim dropped the block only rejected "
          f"drafts covered, pool balanced, the next decode step the plain "
          f"stream's", flush=True)


# ----------------------------------------------------------------------
# phase 7: fp8 KV serving at full width and a long context
# ----------------------------------------------------------------------

def _greedy(eng, slot, prompt, n):
    """Prefill and ``n`` greedy decode steps: (fed tokens, logits)."""
    tok, last = eng.prefill(slot, prompt)
    fed, logits = list(prompt) + [tok], [last.float()]
    for _ in range(n):
        pos = len(fed) - 1
        if not eng.reserve(slot, pos):
            fail("KV pool exhausted")
        nxt, lg = eng.decode([(slot, fed[-1], pos)])
        fed.append(int(nxt[0]))
        logits.append(lg[0].float())
    return fed, logits


def _replay(eng, slot, prompt, fed, n):
    """Teacher-force ``fed`` through ``eng``: its logits at the same
    positions."""
    _, last = eng.prefill(slot, prompt)
    logits = [last.float()]
    for j in range(n):
        pos = len(prompt) + j
        if not eng.reserve(slot, pos):
            fail("KV pool exhausted")
        _, lg = eng.decode([(slot, fed[pos], pos)])
        logits.append(lg[0].float())
    return logits


# ----------------------------------------------------------------------
# phases 24 and 25: the serving Router and disaggregated serving, at
# full width on phase 4's net, with phase 21's engine and requests
# ----------------------------------------------------------------------

ROUTER_REPLICAS = 2
DISAGG_REPLICAS = 4
ROUTER_DEATH_AT = 5        # replica 1 dies at its fifth boundary
DISAGG_HANDOFF_AT = 3      # replica 0 dies handing off a request id >= 3


def router_factory(serving, net, dev, num_blocks=None):
    """The replicas' engine: phase 21's configuration."""
    def factory(compile_cache, kv_cache=None):
        return serving.InferenceEngine(
            net, max_batch=PREFIX_CELL["max_batch"], block_size=16,
            max_context=PREFIX_CELL["max_context"], num_blocks=num_blocks,
            prefill_chunk=PREFIX_CELL["prefill_chunk"], prefix_cache=True,
            compile_cache=compile_cache, kv_cache=kv_cache, device=dev)
    return factory


def add_counts(total):
    """Add the launch counters since the last ``reset_launches`` into
    ``total`` (one window of a path read from zeroed counters)."""
    from mxnet_tpu_torch import ops
    for name, n in ops.launch_counts().items():
        total[name] = total.get(name, 0) + n
    return total


def chunk_launches(layers, chunk_calls, prefill_calls=0):
    """The launches a bf16 engine's chunk and prefill replays make: one
    K3 a layer each, the chunk's in the offset form."""
    k3 = layers * (chunk_calls + prefill_calls)
    return {"flash_attention_fwd": k3, "flash_attention_fwd_bf16": k3,
            "flash_attention_fwd_offset": layers * chunk_calls}


def router_run(router, prompts, label, streams, fault=None):
    """Submit ``prompts`` (ids 0..n-1) to ``router`` at t0 and drive it
    (with ``fault`` = (site, at) armed); fails unless every request
    finished once with phase 21's stream.  Returns the requests, the
    wall and the TTFTs and latencies from t0 (a replica stamps a request
    when it takes it from its inbox, so the batcher's own TTFT starts
    later on all but the first replica)."""
    import torch
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.testing import faults
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [router.submit(serving.Request(p, NEW_TOKENS, request_id=i))
            for i, p in enumerate(prompts)]
    if fault is None:
        router.drive()
    else:
        with faults.inject(fault[0], at=fault[1]):
            router.drive()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_router_streams(router, reqs, label, streams)
    return {"reqs": reqs, "wall_s": wall,
            "ttft": [r.first_token_t - t0 for r in reqs],
            "latency": [r.finish_t - t0 for r in reqs]}


def check_router_streams(router, reqs, label, streams):
    """Every request finished exactly once (none lost, none twice), each
    with phase 21's stream, and no replica captured under traffic."""
    fin = sorted(r.id for r in router.finished())
    if fin != sorted(r.id for r in reqs):
        fail(f"{label}: finished {fin}: a request was lost or duplicated")
    bad = [r.id for r in reqs if r.generated != streams[r.id]]
    if bad:
        fail(f"{label}: streams {bad} differ from phase 21's engine's")
    caw = [rep.engine.stats["compiles_after_warmup"]
           for rep in router.replicas]
    if any(caw):
        fail(f"{label}: compiles after warmup {caw}: traffic must only "
             "replay")


def check_membership(router, label, epoch, dead=()):
    """The fleet ends with epoch ``epoch``, exactly the replicas ``dead``
    dead and requeues only if one died: the death path catches a
    replica's exception and requeues its requests on the survivors, so
    identical streams alone would hide a replica that raised."""
    died = [rep.rid for rep in router.replicas if not rep.alive]
    if router.epoch != epoch or died != sorted(dead) or \
            (router.requeues > 0) != bool(dead):
        fail(f"{label}: epoch {router.epoch} (expected {epoch}), dead "
             f"replicas {died} (expected {sorted(dead)}), requeues "
             f"{router.requeues}")


def router_line(label, router, run, card):
    """The phase line of one router run."""
    st = router.stats()
    tokens = sum(len(r.generated) for r in run["reqs"])
    per = ", ".join(
        f"r{p['rid']} {p['role']}{'' if p['alive'] else ' (dead)'}: "
        f"{p['requests']} requests, occupancy {p['occupancy']}, "
        f"{rep.engine.graphs_captured()} graphs in "
        f"{rep.engine.capture_seconds:.2f} s, pool "
        f"{rep.engine.graph_pool_bytes()} bytes"
        for p, rep in zip(st["per_replica"], router.replicas))
    return (f"{label} on {card}: {len(run['reqs'])} requests, {tokens} "
            f"tokens in {run['wall_s']:.3f} s = {tokens / run['wall_s']:.1f}"
            f" tokens/s; latency p50 {_pct(run['latency'], 0.5) * 1e3:.1f}"
            f" ms p99 {_pct(run['latency'], 0.99) * 1e3:.1f} ms, TTFT p50 "
            f"{statistics.median(run['ttft']) * 1e3:.1f} ms p99 "
            f"{_pct(run['ttft'], 0.99) * 1e3:.1f} ms (from submission to "
            f"the router); requeues {st['requeues']}, epoch {st['epoch']}, "
            f"handoffs {st['handoffs']}; {per}")


def router_leaks(router):
    """Each live replica's pool holds nothing but its prefix chains."""
    for rep in router.live_replicas():
        rep.engine.cache.check_leaks(
            holders=rep.engine.prefix_cache.held_blocks())


def serve_router(dev, card, net, ref):
    """Phase 24: phase 21's engine as ``Router`` replicas on one card.

    1. ``Router(factory, replicas=2)`` in ``drive()`` mode, the system
       prompt pinned on each replica, phase 21's 16 requests submitted
       at once: every stream identical to phase 21's single engine's,
       ``compiles_after_warmup`` 0 on every replica, each replica's
       pool clean but for its prefix chains, both replicas alive, epoch
       0 and no requeue;
    2. the same through a fresh router with replica 1 killed at its
       fifth boundary (``inject("serving.replica1.step", at=5)``): none
       lost or duplicated, only replica 1 dead, requeues above 0, epoch
       1, the same streams, the survivor's pool clean;
    3. the same in threaded mode (``start()``, ``wait_all_done``), with
       ``add_replica()`` while the two workers run (the router holds
       them while the newcomer captures its graphs), the system prompt
       then pinned on the newcomer and 4 of the requests submitted
       again: the same streams, all three replicas alive, epoch 1 (the
       add only) and no requeue.
    Prints tokens/s, latency p50/p99 and TTFT p50 (from submission),
    per-replica requests, occupancy, captures, capture seconds and graph
    pool bytes, requeues, epoch, peak memory, and run 1's
    ``serving_block`` as one JSON line.  The launch counts are the three
    runs' traffic (and the newcomer's warmup and pin), each window from
    zeroed counters: one K3 offset launch a layer a chunk call and one
    K5 a layer a decode call, summed over the replicas."""
    import torch
    from mxnet_tpu_torch import ops, serving
    layers = net.cfg.num_layers
    streams, prompts = ref["streams"], ref["prompts"]
    factory = router_factory(serving, net, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    total, want = {}, {}

    def pinned(router):
        for rep in router.replicas:
            if not rep.engine.pin_prefix(ref["system"]):
                fail("router: the system prompt did not fit")
        return router

    def traffic(router):
        st = [(rep.engine.stats["chunk_prefill_calls"],
               rep.engine.stats["decode_calls"]) for rep in router.replicas]
        return [sum(c for c, _ in st), sum(d for _, d in st)]

    def expect(chunks, decodes, prefills=0):
        for name, n in dict(chunk_launches(layers, chunks, prefills),
                            paged_decode_attention=layers * decodes).items():
            want[name] = want.get(name, 0) + n

    # 1. drive()
    t0 = time.perf_counter()
    router = pinned(serving.Router(factory, replicas=ROUTER_REPLICAS))
    setup_s = time.perf_counter() - t0
    before = traffic(router)
    ops.reset_launches()
    run = router_run(router, prompts, "router", streams)
    add_counts(total)
    expect(*[a - b for a, b in zip(traffic(router), before)])
    check_membership(router, "router", epoch=0)
    router_leaks(router)
    st = router.stats()
    tokens = sum(len(r.generated) for r in run["reqs"])
    print(router_line(f"router, {ROUTER_REPLICAS} replicas, drive()",
                      router, run, card)
          + f"; phase 21's single engine {ref['tokens_per_s']:.1f} tokens/s,"
          f" TTFT p50 {ref['ttft_p50_ms']:.1f} ms; streams identical to "
          f"phase 21's; set-up {setup_s:.1f} s (warmups and pins)",
          flush=True)
    pcs = [rep.engine.prefix_cache for rep in router.replicas]
    lookups = sum(pc.lookups for pc in pcs)
    occ = [p["occupancy"] for p in st["per_replica"]
           if p["occupancy"] is not None]
    block = serving.serving_block(
        max_batch=PREFIX_CELL["max_batch"], block_size=16,
        buckets=router.replicas[0].engine.buckets, continuous=True,
        requests=st["requests"],
        p50_ms=_pct(run["latency"], 0.5) * 1e3,
        p99_ms=_pct(run["latency"], 0.99) * 1e3,
        ttft_p50_ms=statistics.median(run["ttft"]) * 1e3,
        tokens_s=tokens / run["wall_s"],
        tokens_s_chip=tokens / run["wall_s"],      # one card
        occupancy=sum(occ) / len(occ),
        compiles_after_warmup=st["compiles_after_warmup"],
        chunked_prefill=True, router_replicas=ROUTER_REPLICAS,
        prefix_hit_rate=(sum(pc.hits for pc in pcs) / lookups
                         if lookups else None),
        router_p99_ms=_pct(run["latency"], 0.99) * 1e3, paged_attn=True,
        kv_dtype="bf16")
    print(json.dumps({"serving_router": block}), flush=True)
    del router, run
    gc.collect()
    torch.cuda.empty_cache()

    # 2. replica 1 dies mid-traffic
    router = pinned(serving.Router(factory, replicas=ROUTER_REPLICAS))
    before = traffic(router)
    ops.reset_launches()
    run = router_run(router, prompts, "router, replica 1 killed", streams,
                     ("serving.replica1.step", ROUTER_DEATH_AT))
    add_counts(total)
    expect(*[a - b for a, b in zip(traffic(router), before)])
    check_membership(router, "router, replica 1 killed", epoch=1,
                     dead=[1])
    router_leaks(router)
    print(router_line(f"router, replica 1 killed at boundary "
                      f"{ROUTER_DEATH_AT}", router, run, card)
          + "; none lost or duplicated, streams identical, the "
          "survivor's pool clean", flush=True)
    del router, run
    gc.collect()
    torch.cuda.empty_cache()

    # 3. threaded, a replica added while the workers run
    router = pinned(serving.Router(factory, replicas=ROUTER_REPLICAS))
    before = traffic(router)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    router.start()
    try:
        reqs = [router.submit(serving.Request(p, NEW_TOKENS, request_id=i))
                for i, p in enumerate(prompts)]
        t1 = time.perf_counter()
        new = router.add_replica()
        add_s = time.perf_counter() - t1
        if not new.engine.pin_prefix(ref["system"]):
            fail("router, threaded: the system prompt did not fit")
        again = [router.submit(serving.Request(prompts[i], NEW_TOKENS,
                                               request_id=100 + i))
                 for i in range(4)]
        router.wait_all_done(timeout=600)
    finally:
        router.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    add_counts(total)
    stn = new.engine.stats
    expect(*[a - b for a, b in zip(traffic(router), before)])
    # the newcomer's warmup runs each step's body eagerly and replays its
    # graph once; its pin is one prefill
    kinds = [kind for kind, _ in new.engine._steps]
    expect(2 * kinds.count("chunk"), 2 * kinds.count("decode"),
           2 * kinds.count("prefill") + stn["prefill_calls"])
    threaded = {**streams, **{100 + i: streams[i] for i in range(4)}}
    check_router_streams(router, reqs + again, "router, threaded",
                         threaded)
    # the add is the only membership change
    check_membership(router, "router, threaded", epoch=1)
    if len(router.replicas) != ROUTER_REPLICAS + 1:
        fail(f"router, threaded: {len(router.replicas)} replicas after "
             "add_replica()")
    router_leaks(router)
    st = router.stats()
    print(f"router, threaded (start()/wait_all_done), add_replica() while "
          f"2 workers ran: {len(reqs) + len(again)} requests in "
          f"{wall:.3f} s; add_replica {add_s:.2f} s (workers held), "
          f"{new.engine.graphs_captured()} graphs captured in "
          f"{new.engine.capture_seconds:.2f} s; requests by replica "
          f"{[p['requests'] for p in st['per_replica']]}, epoch "
          f"{st['epoch']}; streams identical to phase 21's", flush=True)
    del router, reqs, again, new
    gc.collect()
    torch.cuda.empty_cache()
    print(f"router: peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f}"
          f" GB (the net, {ROUTER_REPLICAS} replicas' pools and graph "
          "pools)", flush=True)
    return read_launches("serving router", want, total)


def serve_disagg(dev, card, net, ref):
    """Phase 25: disaggregated serving, ``Router(factory, replicas=4,
    disaggregated=True)``: rids 0 and 2 prefill (the system prompt
    pinned on each), rids 1 and 3 decode, over one pool of ``1 + 4 * 9 *
    64 = 2305`` blocks (the loadgen's sizing).

    1. phase 21's requests: every stream identical to phase 21's,
       ``handoffs`` equal to the requests that outlived their prefill
       (all 16: 32 new tokens), ``compiles_after_warmup`` 0, every
       replica alive, epoch 0 and no requeue, and the shared pool clean
       once the prefix pins are dropped;
    2. again on a fresh fleet with replica 0 killed as it hands off a
       request of id 3 or more (``inject("serving.replica0.handoff",
       at=3)``): none lost or duplicated, only replica 0 dead, requeues
       above 0, epoch 1, the same streams, the pool clean.
    Prints the handoff time (host, median and max), the prefill and
    decode pools' occupancy, tokens/s and TTFT p50 beside phase 21's,
    and the pool's bytes.  Launches: one K3 offset a layer a chunk call
    (prefill replicas), one K5 a layer a decode call (decode
    replicas)."""
    import torch
    from mxnet_tpu_torch import ops, serving
    layers = net.cfg.num_layers
    streams, prompts = ref["streams"], ref["prompts"]
    mb, mc = PREFIX_CELL["max_batch"], PREFIX_CELL["max_context"]
    num_blocks = 1 + DISAGG_REPLICAS * (mb + 1) * (mc // 16)
    factory = router_factory(serving, net, dev, num_blocks)
    torch.cuda.reset_peak_memory_stats(dev)
    total, want = {}, {}

    def fleet():
        router = serving.Router(factory, replicas=DISAGG_REPLICAS,
                                disaggregated=True)
        if [r.role for r in router.replicas] != \
                ["prefill", "decode", "prefill", "decode"]:
            fail("disaggregated: roles "
                 f"{[r.role for r in router.replicas]}")
        for rep in router.replicas:
            if rep.role == "prefill" and \
                    not rep.engine.pin_prefix(ref["system"]):
                fail("disaggregated: the system prompt did not fit")
        return router

    def run_fleet(label, fault=None):
        t0 = time.perf_counter()
        router = fleet()
        setup_s = time.perf_counter() - t0
        ops.reset_launches()
        run = router_run(router, prompts, label, streams, fault)
        add_counts(total)
        chunks = sum(r.engine.stats["chunk_prefill_calls"]
                     for r in router.replicas)
        decodes = sum(r.engine.stats["decode_calls"]
                      for r in router.replicas)
        for name, n in dict(chunk_launches(layers, chunks),
                            paged_decode_attention=layers * decodes).items():
            want[name] = want.get(name, 0) + n
        cache = router._shared_cache
        held = sum(r.engine.prefix_cache.held_blocks()
                   for r in router.live_replicas())
        cache.check_leaks(holders=held)
        for rep in router.live_replicas():
            rep.engine.prefix_cache.clear()
        cache.check_leaks(holders=0)
        if cache.blocks_in_use:
            fail(f"{label}: {cache.blocks_in_use} blocks still held")
        ms = router.handoff_ms
        st = router.stats()
        print(router_line(label, router, run, card)
              + f"; handoff (host) median {statistics.median(ms):.3f} ms, "
              f"max {max(ms):.3f} ms over {len(ms)}; prefill pool occupancy "
              f"{st['prefill_pool_occupancy']}, decode pool occupancy "
              f"{st['decode_pool_occupancy']}; phase 21's single engine "
              f"{ref['tokens_per_s']:.1f} tokens/s, TTFT p50 "
              f"{ref['ttft_p50_ms']:.1f} ms; one pool of "
              f"{cache.num_blocks} blocks, "
              f"{cache.num_blocks * cache.block_nbytes} bytes, clean once "
              f"the pins were dropped; set-up {setup_s:.1f} s", flush=True)
        return router, run

    # 1. the plain fleet
    router, run = run_fleet(f"disaggregated, {DISAGG_REPLICAS} replicas")
    outlived = sum(1 for r in run["reqs"] if r.max_new_tokens > 1)
    check_membership(router, "disaggregated", epoch=0)
    if router.handoffs != outlived:
        fail(f"disaggregated: handoffs {router.handoffs} (expected "
             f"{outlived})")
    del router, run
    gc.collect()
    torch.cuda.empty_cache()

    # 2. replica 0 dies mid-handoff
    router, run = run_fleet(
        f"disaggregated, replica 0 killed mid-handoff (request id >= "
        f"{DISAGG_HANDOFF_AT})",
        ("serving.replica0.handoff", DISAGG_HANDOFF_AT))
    check_membership(router, "disaggregated, replica 0 killed", epoch=1,
                     dead=[0])
    del router, run
    gc.collect()
    torch.cuda.empty_cache()
    print(f"disaggregated: peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB (the net, "
          f"one shared pool, {DISAGG_REPLICAS} graph pools)", flush=True)
    return read_launches("serving disaggregated", want, total)


def serve_llama3_8b_fp8(dev, card):
    """Llama-3-8B bf16, 32 layers, ``kv_dtype="fp8"``, max_batch 16,
    max_context 4096 (4097 blocks); a ``ContinuousBatcher`` serves 32
    greedy requests with prompts of 256-3800 tokens and 32 new tokens
    each.  Afterwards, outside the counted window, one request's fp8
    decode logits against a bf16-pool engine on the same net
    (teacher-forced; printed, not a limit)."""
    import torch
    from mxnet_tpu_torch import ops, serving
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama3_8b
    from mxnet_tpu_torch.ops.quant_kv import kv_block_bytes
    cell = SERVING_CELLS["fp8"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    net = llama3_8b(device=dev, dtype=torch.bfloat16, seed=0)
    cfg = net.cfg
    eng = serving_engine(serving, net, cell, dev)
    setup_s = time.perf_counter() - t0
    c = eng.cache
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in (c.k_pool, c.v_pool, c.k_scale, c.v_scale))
    if pool_bytes != c.num_blocks * c.block_nbytes:
        fail(f"fp8 pool holds {pool_bytes} bytes, block_nbytes says "
             f"{c.num_blocks * c.block_nbytes}")
    bf16_bytes = c.num_blocks * kv_block_bytes(
        cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, c.block_size, "bf16")
    prompts, _ = serving_prompts(cell, cfg.vocab_size)
    ops.reset_launches()
    run = serve_requests(serving, eng, prompts, "fp8 serving")
    launches = read_launches("fp8 serving", {
        "flash_attention_fwd": cfg.num_layers * eng.stats["prefill_calls"],
        "flash_attention_fwd_bf16": cfg.num_layers * eng.stats["prefill_calls"],
        "paged_decode_attention_fp8":
            cfg.num_layers * eng.stats["decode_calls"]})
    lengths = [len(p) for p in prompts]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"serving llama3_8b bf16, fp8 KV cache, max_context 4096, on "
          f"{card}: {len(prompts)} requests, prompts {min(lengths)}-"
          f"{max(lengths)} tokens, {run['tokens']} tokens in "
          f"{run['wall_s']:.3f} s = {run['tokens_per_s']:.1f} tokens/s; "
          f"TTFT p50 {run['ttft_p50_ms']:.1f} ms; decode step median "
          f"{run['step_ms']:.2f} ms over {run['steps']} steps; peak "
          f"memory {peak_gb:.2f} GB; pool {c.num_blocks} blocks, {pool_bytes} "
          f"bytes fp8 with scales against {bf16_bytes} bf16; set-up "
          f"{setup_s:.1f} s; {graph_text(eng)}; launches {launches}",
          flush=True)
    print(graph_vs_eager(eng, prompts[1][:2000].tolist()), flush=True)
    # drift of one request's fp8 decode logits against a bf16 pool
    ref = serving.InferenceEngine(net, kv_dtype="bf16", max_batch=2,
                                  block_size=16, max_context=1024,
                                  device=dev)
    prompt = prompts[0][:900].tolist()
    fed, lg8 = _greedy(eng, "drift", prompt, 16)
    lg16 = _replay(ref, "drift", prompt, fed, 16)
    drift = max(float((a - b).abs().max()) for a, b in zip(lg8[1:],
                                                            lg16[1:]))
    top = max(float(a.abs().max()) for a in lg16[1:])
    print(f"fp8 vs bf16 KV pool, {len(prompt)}-token prompt, 16 "
          f"teacher-forced decode steps: max |logit| drift {drift:.4e} "
          f"(largest |logit| {top:.4e}); prefill logits equal: "
          f"{bool(torch.equal(lg8[0], lg16[0]))}", flush=True)
    print(replay_device(eng, run, "fp8 serving"), flush=True)
    del eng, ref, net, run
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phases 5 and 6: card against CPU on the full-width geometry, with
# f32 and with fp8 KV pools
# ----------------------------------------------------------------------

def card_vs_cpu(dev):
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                           LlamaForCausalLM)
    from mxnet_tpu_torch.serving import InferenceEngine
    cfg = LlamaConfig(num_layers=2)
    on_card = LlamaForCausalLM(cfg, device=dev, seed=1)
    on_cpu = copy_weights(on_card, LlamaForCausalLM(cfg, device="cpu"))
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, 40).tolist()
    runs = []
    for net, d in ((on_card, dev), (on_cpu, "cpu")):
        eng = InferenceEngine(net, max_batch=2, block_size=16,
                              max_context=64, device=d)
        tok, last = eng.prefill(0, prompt)
        toks, logits = [tok], [last.float().cpu()]
        for _ in range(8):
            pos = len(prompt) + len(toks) - 1
            if not eng.reserve(0, pos):
                fail("card-vs-cpu: KV pool exhausted")
            nxt, lg = eng.decode([(0, toks[-1], pos)])
            toks.append(int(nxt[0]))
            logits.append(lg[0].float().cpu())
        runs.append((toks, torch.stack(logits)))
    (t_card, l_card), (t_cpu, l_cpu) = runs
    err = float((l_card - l_cpu).abs().max())
    print(f"card vs cpu (2 layers, full width, fp32): max |logit| diff "
          f"{err:.3e} (limit {LOGIT_ATOL}), tokens card {t_card} cpu "
          f"{t_cpu}", flush=True)
    if t_card != t_cpu or not err <= LOGIT_ATOL:
        fail("card and CPU disagree")
    card_vs_cpu_fp8(dev, on_card, on_cpu, prompt)
    out = {"chunk_spec_card_vs_cpu": chunk_spec_card_vs_cpu(
        dev, on_card, on_cpu, None),
        "chunk_spec_card_vs_cpu_fp8": chunk_spec_card_vs_cpu(
        dev, on_card, on_cpu, "fp8")}
    # last: it quantizes both nets in place
    out["int8_card_vs_cpu"] = int8_card_vs_cpu(dev, on_card, on_cpu, prompt)
    return out


# phase 20: the chunk and verify steps and the prefix cache, card against
# CPU, on phase 5's nets
CHUNK_ENGINE = dict(max_batch=4, block_size=16, max_context=256,
                    prefill_chunk=64, prefix_cache=True, spec_decode=True,
                    spec_k=3)
CHUNK_PREFIX, CHUNK_SUFFIXES, CHUNK_DECODE = 100, (30, 90), 8


def _chunk_spec_script(eng, prefix, prompts, n_decode, forced=None,
                       drafts=None):
    """Phase 20's requests on one engine: each prompt continues the
    pinned ``prefix`` (adopted through ``attach_prefix``); their rest
    goes through packed ``chunk_prefill`` calls; then ``n_decode``
    joined greedy decode steps, and, with ``drafts``, one ``verify`` of
    each row's last token and its drafts.  ``forced`` teacher-forces the
    tokens ({slot: tokens}).  Returns (tokens {slot: [...]}, logits
    [first-token rows, then each decode step's rows], verify tokens)."""
    import torch
    C = eng.prefill_chunk
    done = {}
    for slot, p in enumerate(prompts):
        done[slot] = eng.attach_prefix(slot, p)
        if done[slot] != len(prefix):
            fail(f"card vs cpu, chunks: prompt {slot} hit {done[slot]} "
                 f"cached positions, not {len(prefix)}")
    toks, logits = {}, []
    while len(toks) < len(prompts):
        entries = [(slot, prompts[slot][done[slot]:done[slot] + C],
                    done[slot]) for slot in done if slot not in toks]
        out = eng.chunk_prefill(entries)
        if out is None:
            fail("card vs cpu, chunks: KV pool exhausted")
        for i, (slot, chunk, start) in enumerate(entries):
            done[slot] = start + len(chunk)
            if done[slot] == len(prompts[slot]):
                tok = int(out[0][i])
                toks[slot] = [forced[slot][0] if forced else tok]
                logits.append(torch.as_tensor(out[1][i]).float())
    for step in range(n_decode):
        entries = []
        for slot in sorted(toks):
            pos = len(prompts[slot]) + len(toks[slot]) - 1
            if not eng.reserve(slot, pos):
                fail("card vs cpu, chunks: KV pool exhausted")
            entries.append((slot, toks[slot][-1], pos))
        nxt, lg = eng.decode(entries)
        logits.append(lg.float().cpu())
        for (slot, _, _), t in zip(entries, nxt):
            toks[slot].append(forced[slot][step + 1] if forced else int(t))
    out = None
    if drafts is not None:
        entries = []
        for slot in sorted(toks):
            pos = len(prompts[slot]) + len(toks[slot]) - 1
            row = [toks[slot][-1]] + drafts[slot]
            if not eng.reserve(slot, pos, len(row)):
                fail("card vs cpu, chunks: KV pool exhausted")
            entries.append((slot, row, pos))
        out = eng.verify(entries)
    for slot in toks:
        eng.release(slot)
    return toks, logits, out


def chunk_spec_card_vs_cpu(dev, on_card, on_cpu, kv_dtype):
    """Phase 20 on phase 5's nets (2 layers at full width, f32): an
    engine with ``CHUNK_ENGINE`` on each, ``kv_dtype`` pools.  Pin a
    100-token prefix (6 blocks and a 4-token partial one); two prompts
    that continue it (30 and 90 tokens more, the second longer than a
    chunk) through ``chunk_prefill``; 8 joined greedy decode steps; one
    ``verify`` whose drafts are the card's own next 3 greedy tokens (from
    a first pass of the same requests on the card).  The CPU is
    teacher-forced with the card's tokens.  Limits: logits within
    ``LOGIT_ATOL`` (f32 pools; ``FP8_LOGIT_ATOL`` with fp8), every draft
    accepted on the card, the CPU's greedy picks and verify tokens
    equal to the card's (fp8 pools too); a chunk replay one K3 launch a
    layer, a verify replay W x layers K5 launches.  Returns the card's
    launch counts."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.serving import InferenceEngine
    label = f"card vs cpu, chunks, prefix and verify ({kv_dtype or 'f32'} " \
        "pools)"
    cfg = on_card.cfg
    rng = np.random.RandomState(20)
    prefix = rng.randint(0, cfg.vocab_size, CHUNK_PREFIX).tolist()
    prompts = [prefix + rng.randint(0, cfg.vocab_size, n).tolist()
               for n in CHUNK_SUFFIXES]
    k = CHUNK_ENGINE["spec_k"]
    e_card = InferenceEngine(on_card, kv_dtype=kv_dtype, device=dev,
                             **CHUNK_ENGINE).warmup()
    ops.reset_launches()
    if not e_card.pin_prefix(prefix):
        fail(f"{label}: the prefix did not fit")
    probe, _, _ = _chunk_spec_script(e_card, prefix, prompts,
                                     CHUNK_DECODE + k + 1)
    drafts = {s: t[CHUNK_DECODE + 1:CHUNK_DECODE + 1 + k]
              for s, t in probe.items()}
    toks, l_card, v_card = _chunk_spec_script(e_card, prefix, prompts,
                                              CHUNK_DECODE, drafts=drafts)
    st = e_card.stats
    W = 4                                  # 4 fed tokens a row
    paged = "paged_decode_attention_fp8" if kv_dtype == "fp8" \
        else "paged_decode_attention"
    launches = read_launches(label, {
        "flash_attention_fwd": cfg.num_layers * (st["prefill_calls"] +
                                                 st["chunk_prefill_calls"]),
        "flash_attention_fwd_offset":
            cfg.num_layers * st["chunk_prefill_calls"],
        paged: cfg.num_layers * (st["decode_calls"] + W * st["verify_calls"])})
    for slot, t in toks.items():
        if t != probe[slot][:CHUNK_DECODE + 1]:
            fail(f"{label}: the card's two passes differ")
        want = probe[slot][CHUNK_DECODE + 1:CHUNK_DECODE + 2 + k]
        if list(v_card[slot]) != want:
            fail(f"{label}: verify {list(v_card[slot])} against the "
                 f"card's greedy continuation {want}: a draft was refused")
    e_card.cache.check_leaks(holders=e_card.prefix_cache.held_blocks())
    e_cpu = InferenceEngine(on_cpu, kv_dtype=kv_dtype, device="cpu",
                            **CHUNK_ENGINE)
    if not e_cpu.pin_prefix(prefix):
        fail(f"{label}: the prefix did not fit on the CPU")
    own, l_cpu, v_cpu = _chunk_spec_script(
        e_cpu, prefix, prompts, CHUNK_DECODE, forced=toks, drafts=drafts)
    e_cpu.cache.check_leaks(holders=e_cpu.prefix_cache.held_blocks())
    err = max(float((a - b).abs().max()) for a, b in zip(l_card, l_cpu))
    # the CPU's own greedy picks at each teacher-forced position
    picks = [int(torch.argmax(r)) for lg in l_cpu
             for r in (lg if lg.dim() == 2 else lg[None])]
    card_picks = [int(torch.argmax(r)) for lg in l_card
                  for r in (lg if lg.dim() == 2 else lg[None])]
    same = picks == card_picks
    # the card's smallest top-2 logit margin: how near a tie came to the
    # picks that are held equal
    margin = min(float(t[0] - t[1]) for lg in l_card
                 for t in torch.topk(lg if lg.dim() == 2 else lg[None],
                                     2, dim=-1).values)
    tol = FP8_LOGIT_ATOL if kv_dtype == "fp8" else LOGIT_ATOL
    print(f"{label} (2 layers, full width, fp32; prefix {CHUNK_PREFIX} "
          f"tokens pinned, suffixes {CHUNK_SUFFIXES} through "
          f"{st['chunk_prefill_calls'] // 2} chunk calls a pass, "
          f"{CHUNK_DECODE} decode steps, one verify of {k} drafts): max "
          f"|logit| diff {err:.3e} (limit {tol}); greedy picks identical "
          f"{same}, smallest top-2 margin on the card {margin:.3e}; "
          f"verify card {v_card.tolist()} cpu {v_cpu.tolist()}; "
          f"drafts accepted on the card; forks {e_card.cache.cow_copies}; "
          f"launches {launches}", flush=True)
    if not (err <= tol and same and np.array_equal(v_card, v_cpu)):
        fail(f"{label}: card and CPU disagree")
    del e_card, e_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def card_vs_cpu_fp8(dev, on_card, on_cpu, prompt):
    """fp8 KV pools on phase 5's nets: prefill the 40-token prompt and
    run 8 decode steps on the card, and teacher-force the card's tokens
    through the CPU engine.  Limits: decode logits within 2e-2, the card's
    fp8-vs-f32-pool drift above 0, and, on the rows whose inputs no pool
    read has touched (layer 0 at every position, later layers at the
    prompt's, which prefill computes from the fresh K/V), codes identical
    in 99.9% of elements and scales within 1e-5 relative.  Later layers'
    decode rows are computed from attention over fp8 rows, so one code
    that rounds the other way upstream moves them further (printed)."""
    import torch
    from mxnet_tpu_torch.serving import InferenceEngine
    kw = dict(max_batch=2, block_size=16, max_context=64)
    e_card = InferenceEngine(on_card, kv_dtype="fp8", device=dev, **kw)
    e_cpu = InferenceEngine(on_cpu, kv_dtype="fp8", device="cpu", **kw)
    fed, l_card = _greedy(e_card, 0, prompt, 8)
    l_cpu = _replay(e_cpu, 0, prompt, fed, 8)
    l_f32 = _replay(InferenceEngine(on_card, device=dev, **kw), 0, prompt,
                    fed, 8)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(l_card,
                                                               l_cpu))
    drift = max(float((a - b).abs().max()) for a, b in zip(l_card, l_f32))
    n = len(prompt) + 8                  # positions written by both
    table = e_card.cache.table(0)
    if table != e_cpu.cache.table(0):
        fail(f"fp8 card vs cpu: block tables {table} vs "
             f"{e_cpu.cache.table(0)}")
    layers = e_card.cache.num_layers
    fresh = torch.zeros(layers, n, dtype=torch.bool)
    fresh[0] = True
    fresh[:, :len(prompt)] = True

    def rows(a):                         # (layers, n, ...) of slot 0
        return a[:, table].flatten(1, 2)[:, :n].cpu()

    same, total, scale_err = [0, 0], [0, 0], [0.0, 0.0]
    for a, b in ((e_card.cache.k_pool, e_cpu.cache.k_pool),
                 (e_card.cache.v_pool, e_cpu.cache.v_pool)):
        eq = rows(a.view(torch.uint8)) == rows(b.view(torch.uint8))
        for i, sel in enumerate((fresh, torch.ones_like(fresh))):
            same[i] += int(eq[sel].sum())
            total[i] += eq[sel].numel()
    for a, b in ((e_card.cache.k_scale, e_cpu.cache.k_scale),
                 (e_card.cache.v_scale, e_cpu.cache.v_scale)):
        rel = (rows(a) - rows(b)).abs() / rows(b)
        for i, sel in enumerate((fresh, torch.ones_like(fresh))):
            scale_err[i] = max(scale_err[i], float(rel[sel].max()))
    frac = [a / b for a, b in zip(same, total)]
    print(f"card vs cpu, fp8 KV (2 layers, full width, fp32, 8 "
          f"teacher-forced decode steps): max |logit| diff {err:.3e} "
          f"(limit {FP8_LOGIT_ATOL}); card fp8-vs-f32 drift {drift:.3e} "
          f"(must be > 0); rows from fresh inputs: codes identical "
          f"{same[0]}/{total[0]} = {frac[0]:.6f} (limit {FP8_CODES_SAME}), "
          f"max scale rel diff {scale_err[0]:.3e} (limit {FP8_SCALE_RTOL}); "
          f"all written rows: codes identical {same[1]}/{total[1]} = "
          f"{frac[1]:.6f}, max scale rel diff {scale_err[1]:.3e}",
          flush=True)
    if not (err <= FP8_LOGIT_ATOL and frac[0] >= FP8_CODES_SAME
            and scale_err[0] <= FP8_SCALE_RTOL and drift > 0):
        fail("fp8 KV on the card and on the CPU disagree")


# card vs CPU under int8 weights: the engines' logits, the CPU fed the
# card's activation codes (the limit set before the first chip run)
INT8_LOGIT_ATOL = 2e-2
# each int8 projection on the same input, card against CPU: the codes
# are one f32 division and a rounding, the product exact, the rescale
# one f32 multiply each side, so only the last bit may differ
INT8_PROJ_RTOL = 1e-6
INT8_CALIB = dict(batches=2, batch=2, tokens=12)
# A reference fed the card's activation codes computes its own x / as at
# each projection: on the rows that carry a request it must lie within
# half a code of the code it is fed (the rounding) plus the two sides'
# float noise, INT8_CODE_SLACK of a code and a share of |x / as| by the
# input's dtype: bf16 two ulps (a bf16 net's layer 0 rounds its normed
# embedding to bf16), f32 1e-4 (the sides' reduction orders and kernels
# differ by about 1e-6)
INT8_CODE_SLACK = 2e-2
INT8_CODE_RTOL = {"torch.bfloat16": 2 ** -6, "torch.float32": 1e-4}


def int8_calibration(vocab, ctx, seed):
    """``INT8_CALIB``'s token batches from ``seed``, as NDArrays on
    ``ctx``."""
    import numpy as np
    from mxnet_tpu_torch import nd
    rng = np.random.RandomState(seed)
    c = INT8_CALIB
    return [nd.array(rng.randint(0, vocab, (c["batch"], c["tokens"])),
                     ctx=ctx) for _ in range(c["batches"])]


def _twins(block, prefix=""):
    """``(structural path, QuantizedDense)`` of every int8 twin."""
    from mxnet_tpu_torch.contrib.quantization import QuantizedDense
    for name, child in block._children.items():
        if isinstance(child, QuantizedDense):
            yield prefix + name, child
        else:
            yield from _twins(child, prefix + name + ".")


@contextlib.contextmanager
def _swapped(obj, name, value):
    """``obj.name`` is ``value`` inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def taped(call):
    """Run ``call()``, one serving call of an engine on the card (its
    step's graph replay), then that step's body eagerly on the same
    static inputs (it writes the same K/V rows again; its launches are
    taken back out of the counts), taping the activation codes each
    int8 projection quantizes to, in call order.  Returns ``(the call's
    result, [codes])``."""
    import torch
    import mxnet_tpu_torch.serving.engine as em
    from mxnet_tpu_torch import ops
    ran, tape = [], []
    run, quantize = em._Step.run, em.quantize_rtn_int8

    def run_noted(step):
        ran.append(step)
        return run(step)

    def quantize_taped(x, scale):
        tape.append(quantize(x, scale))
        return tape[-1]
    with _swapped(em._Step, "run", run_noted):
        out = call()
    before = ops.launch_counts()
    with _swapped(em, "quantize_rtn_int8", quantize_taped), torch.no_grad():
        ran[-1].body(*ran[-1].args)
    after = ops.launch_counts()
    ops.add_launches({k: before[k] - after[k] for k in after})
    return out, tape


class CodeFeed:
    """Stands in for ``quantize_rtn_int8`` in a reference: returns the
    card's codes in call order (``fed``: ``(codes, rows)``, the first
    ``rows`` rows carrying a request) and holds the reference's own
    ``x / as`` on those rows to the code it is fed (``INT8_CODE_*``),
    counting its own codes that differ from the card's."""

    def __init__(self, fed):
        self.fed, self.at = fed, 0
        self.over = float("-inf")   # largest gap less what is allowed
        self.worst = 0.0            # largest |x / as - code|
        self.differ = self.checked = 0

    def __call__(self, x, scale):
        import torch
        from mxnet_tpu_torch.ops.quant_matmul import quantize_rtn_int8
        if self.at == len(self.fed):
            fail("int8 reference: more projections than taped codes")
        codes, rows = self.fed[self.at]
        self.at += 1
        if tuple(codes.shape) != tuple(x.shape):
            fail(f"int8 reference: projection {self.at} takes "
                 f"{tuple(x.shape)}, the card's codes are "
                 f"{tuple(codes.shape)}")
        codes = codes.to(x.device)
        v = torch.clamp(x[:rows].float() / scale, -127, 127)
        gap = (v - codes[:rows].float()).abs()
        allowed = 0.5 + INT8_CODE_SLACK + \
            INT8_CODE_RTOL[str(x.dtype)] * v.abs()
        over = float((gap - allowed).max())
        self.over = max(self.over, over if over == over else float("inf"))
        self.worst = max(self.worst, float(gap.max()))
        self.differ += int((quantize_rtn_int8(x[:rows], scale) !=
                            codes[:rows]).sum())
        self.checked += gap.numel()
        return codes

    def held(self):
        return self.at == len(self.fed) and self.over <= 0

    def text(self):
        return (f"{self.checked} activation codes held: largest |x/as - "
                f"code| {self.worst:.4e} (allowed 0.5 + {INT8_CODE_SLACK} "
                f"+ rtol |x/as|, rtol {INT8_CODE_RTOL}; margin left "
                f"{-self.over:.4e}), {self.differ} of the reference's own "
                f"codes differ from the card's; {self.at} of "
                f"{len(self.fed)} taped projections taken")


def int8_script(eng, prompt, chunk, drafts, call, fed=None):
    """Prefill ``prompt`` into slot 0, ``TEACHER_STEPS`` decode steps
    (greedy, or teacher-forced on ``fed``), a chunk of ``chunk`` into
    slot 1 and a verify of the last token and ``drafts``; each engine
    call runs through ``call(fn, layer_rows, rows)`` (the rows of its
    layers' projections and how many of them carry the request; its
    head's carry one).  Returns ``(fed, logits, chunk token, chunk
    logits, verify tokens)``."""
    import torch
    from mxnet_tpu_torch.serving.engine import next_bucket
    label = "card vs cpu, int8 weights"
    B = eng.max_batch
    tok, last = call(lambda: eng.prefill(0, prompt),
                     next_bucket(len(prompt), eng.buckets), len(prompt))
    own = fed is None
    fed = list(prompt) + [tok] if own else fed
    logits = [last.float()]
    for j in range(TEACHER_STEPS):
        pos = len(prompt) + j
        if not eng.reserve(0, pos):
            fail(f"{label}: KV pool exhausted")
        nxt, lg = call(lambda: eng.decode([(0, fed[pos], pos)]), B, 1)
        if own:
            fed.append(int(nxt[0]))
        logits.append(lg[0].float())
    if not eng.cache.alloc(1, 0):
        fail(f"{label}: KV pool exhausted")
    tok, lg = call(lambda: eng.chunk_prefill([(1, chunk, 0)]),
                   B * eng.prefill_chunk, len(chunk))
    pos = len(prompt) + TEACHER_STEPS
    if not eng.reserve(0, pos, 1 + len(drafts)):
        fail(f"{label}: KV pool exhausted")
    ver = call(lambda: eng.verify([(0, [fed[pos]] + drafts, pos)]), B, 1)
    return fed, logits, int(tok[0]), torch.as_tensor(lg[0]), ver[0].tolist()


def int8_card_vs_cpu(dev, on_card, on_cpu, prompt):
    """int8 weights on phase 5's nets (2 layers, full width, f32):
    ``quantize_net`` calibrates the CPU's net, ``convert`` carries its
    codes and scales to the card's.

    First every one of the 15 ``QuantizedDense`` twins on the same
    input, card against CPU, within ``INT8_PROJ_RTOL`` of the output's
    largest magnitude (codes, the int8 product and the rescale: the
    card's cuBLASLt product with its padded rows against the CPU's
    int32 one); the inputs are each twin's own in the card's forward of
    the prompt, all 40 rows and the last row alone (a decode-sized
    product).

    Then an int8 engine on each (``prefill_chunk=64, spec_decode=True,
    spec_k=3``) runs :func:`int8_script`: prefill, 16 greedy decode
    steps, one chunk of 50 tokens into a second slot and one verify of
    the last token and 3 drafts; the card's codes are taped from each
    step's body (:func:`taped`) and fed to the CPU's engine
    (:class:`CodeFeed`, teacher-forced with the card's tokens), so an
    activation on a rounding boundary cannot take the other code on
    the CPU and move these random-weight logits by about 1e-2 (it did:
    ``PERF.md`` §6, PR 16).  Fails unless the logits agree within
    ``INT8_LOGIT_ATOL``, the greedy picks, the chunk's token and the
    verify's tokens are identical, and the CPU's own activations are
    within ``INT8_CODE_*`` of the card's codes.  Returns the card's
    launch counts."""
    import numpy as np
    import torch
    import mxnet_tpu_torch.serving.engine as em
    from mxnet_tpu_torch import nd, ops
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.convert import load_quantized_state, quantized_state
    from mxnet_tpu_torch.serving import InferenceEngine
    from mxnet_tpu_torch.serving.engine import next_bucket
    label = "card vs cpu, int8 weights"
    cfg = on_card.cfg
    quantize_net(on_cpu, calib_data=int8_calibration(
        cfg.vocab_size, torch.device("cpu"), 5))
    load_quantized_state(on_card, quantized_state(on_cpu))
    card_twins, cpu_twins = dict(_twins(on_card)), dict(_twins(on_cpu))
    inputs = {}
    for path, twin in card_twins.items():
        twin._forward_pre_hooks.append(
            lambda blk, args, path=path: inputs.setdefault(
                path, args[0].data.detach().clone()))
    with torch.no_grad():
        on_card(nd.array(np.asarray([prompt]), ctx=dev))
    for twin in card_twins.values():
        twin._forward_pre_hooks.clear()
    worst, bitwise = 0.0, True
    with torch.no_grad():
        for path, x in inputs.items():
            for rows in (x, x[:, -1:]):
                got = card_twins[path](nd.NDArray(rows.contiguous())).data
                want = cpu_twins[path](nd.NDArray(rows.cpu())).data
                bitwise = bitwise and bool(torch.equal(got.cpu(), want))
                rel = float((got.cpu() - want).abs().max()) / max(
                    float(want.abs().max()), 1e-30)
                worst = max(worst, rel)
    proj_text = (f"{label}: {len(inputs)} QuantizedDense on the same inputs "
                 f"(40 rows and 1): max |diff| / max |out| {worst:.3e} "
                 f"(limit {INT8_PROJ_RTOL}), bitwise {bitwise}")
    print(proj_text, flush=True)
    if len(inputs) != 7 * cfg.num_layers + 1 or not worst <= INT8_PROJ_RTOL:
        fail(proj_text)
    kw = dict(max_batch=2, block_size=16, max_context=128, prefill_chunk=64,
              spec_decode=True, spec_k=3, quantize="int8")
    rng = np.random.RandomState(23)
    chunk = rng.randint(0, cfg.vocab_size, 50).tolist()
    drafts = rng.randint(0, cfg.vocab_size, 3).tolist()
    e_card = InferenceEngine(on_card, device=dev, **kw).warmup()
    codes = []

    def on_card_call(fn, layer_rows, rows):
        out, tape = taped(fn)
        codes.extend((q.cpu(), rows if q.shape[0] == layer_rows else 1)
                     for q in tape)
        return out
    ops.reset_launches()
    card = int8_script(e_card, prompt, chunk, drafts, on_card_call)
    st = e_card.stats
    W = next_bucket(1 + len(drafts), e_card._verify_widths())
    launches = read_launches(label, {
        "flash_attention_fwd": cfg.num_layers * (st["prefill_calls"] +
                                                 st["chunk_prefill_calls"]),
        "flash_attention_fwd_offset":
            cfg.num_layers * st["chunk_prefill_calls"],
        "paged_decode_attention": cfg.num_layers * (st["decode_calls"] +
                                                    W * st["verify_calls"])})
    feed = CodeFeed(codes)
    e_cpu = InferenceEngine(on_cpu, device="cpu", **kw)
    with _swapped(em, "quantize_rtn_int8", feed):
        cpu = int8_script(e_cpu, prompt, chunk, drafts,
                          lambda fn, *_: fn(), fed=card[0])
    err = max(float((a.cpu() - b.cpu()).abs().max())
              for a, b in zip(card[1] + [card[3]], cpu[1] + [cpu[3]]))
    picks = card[0][len(prompt):]
    same = sum(p == int(torch.argmax(lg)) for p, lg in zip(picks, cpu[1]))
    text = (f"{label}, engines (2 layers, full width, fp32; prefill, "
            f"{TEACHER_STEPS} decode steps, a 50-token chunk, a verify of "
            f"3 drafts; the CPU fed the card's activation codes): max "
            f"|logit| diff {err:.3e} (limit {INT8_LOGIT_ATOL}); greedy "
            f"picks equal at {same} of {len(picks)} positions; chunk token "
            f"card {card[2]} cpu {cpu[2]}; verify card {card[4]} cpu "
            f"{cpu[4]}; {feed.text()}; launches {launches}")
    print(text, flush=True)
    if not (err <= INT8_LOGIT_ATOL and same == len(picks) and
            card[2] == cpu[2] and card[4] == cpu[4] and feed.held()):
        fail(f"{label}: card and CPU disagree")
    del e_card, e_cpu, codes
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phase 23: int8 weight serving at full width, on phase 4's net
# ----------------------------------------------------------------------

INT8_DRIFT_FRAC = 0.05      # the reference's serving bound on |drift|
INT8_CLASSES = (("int8 GEMM", ("s8", "i8", "int8", "imma", "igemm")),
                ("paged attention (K5)", ("paged_decode",)),
                ("quantize (div, round, clamp, cast)",
                 ("div", "round", "clamp", "copy")),
                ("GEMM", ("nvjet", "gemm", "gemv", "cutlass", "Kernel2")),
                ("elementwise", ("elementwise", "reduce")))


def _class_of(name, classes):
    low = name.lower()
    for cls, keys in classes:
        if any(k.lower() in low for k in keys):
            return cls
    return "other"


def serve_int8(dev, card, net, bf16_ref):
    """Phase 23: ``quantize_net`` on phase 4's bf16 net (phase 4's
    engine deleted), then an int8 engine in phase 4's geometry serving
    phase 4's requests; the checks and prints are in the module doc.
    Returns the launch counts."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import nd, ops, serving
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.serving.engine import next_bucket
    label = "int8 serving"
    cfg = net.cfg
    cell = SERVING_CELLS["bf16"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    quantize_net(net, calib_data=int8_calibration(cfg.vocab_size, dev, 23),
                 num_calib_batches=INT8_CALIB["batches"])
    twins = [q for _, q in _twins(net)]
    if len(twins) != 7 * cfg.num_layers + 1:
        fail(f"{label}: {len(twins)} QuantizedDense, expected "
             f"{7 * cfg.num_layers + 1}")
    # the bf16 weights the codes replace: 2 bytes an element
    bf16_bytes = sum(2 * q.quantized_weight.numel() for q in twins)
    int8_bytes = sum(q.quantized_weight.numel() +
                     4 * (q.weight_scale.numel() + 1) for q in twins)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)   # the int8 serving's own peak
    eng = serving.InferenceEngine(
        net, quantize="int8", max_batch=cell["max_batch"], block_size=16,
        max_context=cell["max_context"], device=dev).warmup()
    setup_s = time.perf_counter() - t0
    prompts, rng = serving_prompts(cell, cfg.vocab_size)
    ops.reset_launches()
    run = serve_requests(serving, eng, prompts, label)
    launches = read_launches(label, {
        "flash_attention_fwd": cfg.num_layers * eng.stats["prefill_calls"],
        "paged_decode_attention":
            cfg.num_layers * eng.stats["decode_calls"]})
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    lengths = [len(p) for p in prompts]
    print(f"int8 serving llama3_8b (bf16 net, {len(twins)} QuantizedDense) "
          f"on {card}: {len(prompts)} requests, prompts {min(lengths)}-"
          f"{max(lengths)} tokens, {run['tokens']} tokens in "
          f"{run['wall_s']:.3f} s = {run['tokens_per_s']:.1f} tokens/s "
          f"(phase 4 {bf16_ref['tokens_per_s']:.1f}); TTFT p50 "
          f"{run['ttft_p50_ms']:.1f} ms (phase 4 "
          f"{bf16_ref['ttft_p50_ms']:.1f}); decode step median "
          f"{run['step_ms']:.2f} ms over {run['steps']} steps (phase 4 "
          f"{bf16_ref['step_ms']:.2f}); projection weights {int8_bytes} "
          f"bytes int8 with scales against {bf16_bytes} bf16 "
          f"({int8_bytes / bf16_bytes:.4f}); peak memory {peak_gb:.2f} GB "
          f"(phase 4 {bf16_ref['peak_gb']:.2f}); set-up (calibration, "
          f"quantization, captures) {setup_s:.1f} s; {graph_text(eng)}; "
          f"launches {launches}", flush=True)
    print(graph_vs_eager(eng, rng.randint(0, cfg.vocab_size,
                                          500).tolist()), flush=True)
    # the engine's prefill against the quantized net's own forward at the
    # bucket width
    prompt = bf16_ref["prompt"]
    _, last = eng.prefill("forward-check", prompt)
    eng.release("forward-check")
    bucket = next_bucket(len(prompt), eng.buckets)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :len(prompt)] = prompt
    with torch.no_grad():
        full = net(nd.array(padded, ctx=dev)).data[0, len(prompt) - 1]
    fwd_err = float((full.float() - last.float()).abs().max())
    # the first prompt teacher-forced on phase 4's tokens, held against
    # the plain forward; its logits give the drift
    lg8 = int8_plain_check(eng, net, prompt, bf16_ref["fed"], label)
    # drift against phase 4's bf16 logits over the same positions
    drift = max(float((a - b).abs().max())
                for a, b in zip(lg8, bf16_ref["logits"]))
    top = max(float(b.abs().max()) for b in bf16_ref["logits"])
    held = drift <= INT8_DRIFT_FRAC * top
    print(f"{label}: prefill logits of the {len(prompt)}-token prompt "
          f"against the quantized net's forward at bucket {bucket}: max "
          f"|diff| {fwd_err:.3e} (limit {GRAPH_LOGIT_ATOL}), bitwise "
          f"{bool(torch.equal(full, last))}; drift against phase 4's bf16 "
          f"logits over prefill and {TEACHER_STEPS} teacher-forced decode "
          f"steps {drift:.4e}, largest |logit| {top:.4e}: "
          f"{drift / top:.4f} of it, the reference's bound "
          f"{INT8_DRIFT_FRAC} {'held' if held else 'not held'} (printed: "
          "on these random weights the activations' dtype alone moves "
          "the logits past it, tools/port_int8_drift.py; the plain "
          "forward above is the held reference)", flush=True)
    if not fwd_err <= GRAPH_LOGIT_ATOL:
        fail(f"{label}: the engine's prefill and the quantized net's "
             "forward disagree")
    print(replay_device(eng, run, label), flush=True)
    # one decode replay's device time by class, from the run's last step
    pos, staged = run["step_pos"][-1], run["staged"][-1]
    step = eng._steps[("decode", next_bucket(pos + 1, eng.buckets) //
                       eng.block_size)]
    eng._stage_np[:] = staged
    step.flat.copy_(eng._stage[:step.flat.numel()])
    step.graph.replay()
    torch.cuda.synchronize()
    reps = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step.graph.replay()
        torch.cuda.synchronize()
    by_class, kernels = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3 / reps
        cls = _class_of(e.key, INT8_CLASSES)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        kernels[e.key[:70]] = kernels.get(e.key[:70], 0.0) + ms
    top_k = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label}: one decode replay (position {pos}) by class, "
          f"profiler, {reps} replays: "
          f"{ {k: round(v, 4) for k, v in by_class.items()} } ms, busy "
          f"{sum(by_class.values()):.4f} ms; top kernels "
          f"{'; '.join(f'{k} {v:.4f} ms' for k, v in top_k)}", flush=True)
    del eng, run
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def int8_plain_check(eng, net, prompt, fed, label):
    """Teacher-force ``fed`` through the int8 engine ``eng`` (prefill of
    ``prompt`` and ``TEACHER_STEPS`` decode steps), taping each step's
    activation codes (:func:`taped`), and hold its logits to
    :func:`plain_int8_logits` fed those codes: within ``LOGIT_ATOL``,
    the same greedy picks, and the plain forward's own activations
    within ``INT8_CODE_*`` of the codes.  Returns the engine's logits."""
    import torch
    t = len(prompt)
    (_, first), pre = taped(lambda: eng.prefill("plain", prompt))
    served, dec = [first.float()], []
    for j in range(TEACHER_STEPS):
        if not eng.reserve("plain", t + j):
            fail(f"{label}: KV pool exhausted")
        (_, lg), tape = taped(
            lambda: eng.decode([("plain", fed[t + j], t + j)]))
        served.append(lg[0].float())
        dec.append([q[:1] for q in tape])     # the request's row
    eng.release("plain")
    if len(pre) != 7 * net.cfg.num_layers + 1:
        fail(f"{label}: {len(pre)} projections taped")
    # each projection's codes over the prompt's rows and the decode rows
    # after them; the head's over the prompt's last row and those
    codes = [(torch.cat([q[:t]] + [d[i] for d in dec]), t + TEACHER_STEPS)
             for i, q in enumerate(pre[:-1])]
    codes.append((torch.cat([pre[-1]] + [d[-1] for d in dec]),
                  1 + TEACHER_STEPS))
    del pre, dec
    feed = CodeFeed(codes)
    pool = eng.cache.k_pool.dtype
    with torch.no_grad():
        plain = plain_int8_logits(net, fed[:t + TEACHER_STEPS], t, feed,
                                  pool)
    del codes
    got = torch.stack(served)
    err = float((plain - got).abs().max())
    same = int((torch.argmax(plain, -1) == torch.argmax(got, -1)).sum())
    text = (f"{label}: the {t}-token prompt and {TEACHER_STEPS} "
            f"teacher-forced decode steps against a plain PyTorch forward "
            f"fed the engine's activation codes (f64 products of the "
            f"codes, f32 rescale, plain attention over the prompt's f32 "
            f"K/V, then the pool's {str(pool).replace('torch.', '')} K/V): "
            f"max |logit| diff {err:.3e} (limit {LOGIT_ATOL}), bitwise "
            f"{bool(torch.equal(plain, got))}, greedy picks equal at "
            f"{same} of {len(served)}; {feed.text()}")
    print(text, flush=True)
    if not (err <= LOGIT_ATOL and same == len(served) and feed.held()):
        fail(f"{label}: the engine and the plain forward disagree")
    return served


def plain_int8_logits(net, tokens, t, feed, pool):
    """The int8 path in plain PyTorch, written apart from the engine:
    ``tokens`` at positions ``0 .. P-1``, the first ``t`` as a prefill
    computes them (causal attention over their own f32 K/V), each later
    one as a decode step (attention over every K/V up to it, stored in
    ``pool``'s dtype).  Each projection takes its activation codes from
    ``feed`` (a :class:`CodeFeed`), multiplies them with the twin's
    weight codes in f64 (exact: every partial sum of int8 products is an
    integer below 2^53) and rescales in f32 by the activation scale
    times the channel's.  Returns the logits of positions ``t - 1 ..
    P - 1`` (f32, ``(P - t + 1, vocab)``)."""
    import math
    import torch
    import torch.nn.functional as F
    cfg = net.cfg
    h, kvh, d, eps = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.rms_eps)
    m = net.model
    emb = m.embed.weight.data().data
    dev, P = emb.device, len(tokens)

    def rms(x, param):
        x32 = x.float()
        y = x32 / torch.sqrt((x32 * x32).mean(-1, keepdim=True) + eps)
        return y.to(x.dtype) * param.data().data

    def proj(x, twin):
        a = torch.tensor(twin.act_scale, dtype=torch.float32, device=dev)
        codes = feed(x, a)
        acc = codes.double() @ twin.quantized_weight.double().T
        return acc.float() * (a * twin.weight_scale.float().reshape(1, -1))

    freqs = cfg.rope_theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                             device=dev) / d)
    ang = torch.arange(P, dtype=torch.float32, device=dev)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]

    def rope(u):                     # (P, heads, d), interleaved pairs
        u1, u2 = u[..., 0::2], u[..., 1::2]
        return torch.stack([u1 * cos - u2 * sin, u2 * cos + u1 * sin],
                           -1).reshape(u.shape)

    causal = torch.ones(P, P, dtype=torch.bool, device=dev).tril()

    def attend(q, k, v, mask):       # q (n, h, d), k/v (n', h, d)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
        s = s.masked_fill(~mask, float("-inf"))
        return torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)

    rep = h // kvh
    x = emb[torch.as_tensor(tokens, device=dev)]
    for layer in m.layers:
        a, f = layer.attention, layer.mlp
        hh = rms(x, layer.input_norm.weight)
        q = rope(proj(hh, a.q_proj).view(P, h, d))
        k = rope(proj(hh, a.k_proj).view(P, kvh, d)).repeat_interleave(rep, 1)
        v = proj(hh, a.v_proj).view(P, kvh, d).repeat_interleave(rep, 1)
        kc, vc = k.to(pool).float(), v.to(pool).float()
        o = torch.cat([attend(q[:t], k[:t], v[:t], causal[:t, :t]),
                       attend(q[t:], kc, vc, causal[t:])])
        x = x + proj(o.reshape(P, h * d), a.o_proj)
        y = rms(x, layer.post_norm.weight)
        x = x + proj(F.silu(proj(y, f.gate_proj)) * proj(y, f.up_proj),
                     f.down_proj)
    return proj(rms(x, m.norm.weight)[t - 1:], net.lm_head)


# ----------------------------------------------------------------------
# phase 8: training at full width
# ----------------------------------------------------------------------

def train_param_count():
    """Parameters of the training phase's model, counted from the
    shapes of a net whose parameters wait for ``initialize`` (the size
    of the Trainer's flat bucket)."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama3_8b
    net = llama3_8b(num_layers=TRAIN_LAYERS)
    return sum(int(np.prod(p.shape))
               for p in net.collect_params().values())


def train_llama3_8b(dev, card, amp_dtype=None, f32_first_loss=None):
    """Phase 8 (f32) or, with ``amp_dtype="bfloat16"``, phase 11 (the
    same model, batch and AdamW under ``amp.init``, ``amp.init_trainer``
    and ``amp.scale_loss``).  Returns the launches and the first loss."""
    import statistics
    import numpy as np
    import torch
    from mxnet_tpu_torch import amp, autograd, nd, ops
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama3_8b
    phase = "training" if amp_dtype is None else f"{amp_dtype} amp training"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    net = llama3_8b(device=dev, dtype=torch.float32, seed=0,
                    num_layers=TRAIN_LAYERS)
    trainer = Trainer(net.collect_params(), "adamw",
                      {"learning_rate": 1e-3, "wd": 0.1})
    params = [p.data().data for p in net.collect_params().values()]
    loss_fn = SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(0)
    vocab = net.cfg.vocab_size
    tokens, labels = (nd.array(rng.randint(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ)), ctx=dev) for _ in range(2))
    n_params = sum(p.numel() for p in params)
    if amp_dtype is not None:
        amp.init(amp_dtype)
    try:
        if amp_dtype is not None:
            amp.init_trainer(trainer)
        torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        ops.reset_launches()
        losses, step_s, dtypes = [], [], set()
        for _ in range(TRAIN_STEPS):
            t = time.perf_counter()
            with autograd.record():
                logits = net(tokens)
                loss = loss_fn(logits, labels)          # (batch,)
                with amp.scale_loss(loss.sum(), trainer) as scaled:
                    scaled.backward()
            dtypes.add((logits.data.dtype, loss.data.dtype, frozenset(
                p.grad.dtype for p in params)))
            del logits
            trainer.step(TRAIN_BATCH)
            losses.append(loss.data.detach().float().mean())
            torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t)
    finally:
        if amp_dtype is not None:
            amp._deinit_for_tests()
    # every parameter is a view of the Trainer's flat buffer (built at
    # the first update): the update runs K2 on it where it lies, with no
    # gather and no write-back
    buf = trainer._flat_param
    if buf is None or any(
            not buf.data_ptr() <= p.data_ptr() < buf.data_ptr() + 4 *
            buf.numel() for p in params):
        fail(f"{phase}: the parameters are not views of the Trainer's "
             "flat buffer")
    want = {"flash_attention_fwd": TRAIN_LAYERS * TRAIN_STEPS,
            "flash_attention_bwd": TRAIN_LAYERS * TRAIN_STEPS,
            "fused_adam_update": TRAIN_STEPS}
    if amp_dtype == "bfloat16":     # K3 took bf16 q, k, v (and g)
        want.update(flash_attention_fwd_bf16=TRAIN_LAYERS * TRAIN_STEPS,
                    flash_attention_bwd_bf16=TRAIN_LAYERS * TRAIN_STEPS)
    launches = read_launches(phase, want)
    losses = [float(x) for x in losses]
    step_ms = statistics.median(step_s[1:]) * 1e3
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    act = torch.float32 if amp_dtype is None else getattr(torch, amp_dtype)
    want_dtypes = {(act, act, frozenset([torch.float32]))}
    if dtypes != want_dtypes:
        fail(f"{phase}: dtypes of the logits, the loss and the gradients "
             f"{dtypes}, expected {want_dtypes}")
    text = "fp32" if amp_dtype is None else \
        f"{amp_dtype} amp (f32 parameters, gradients and AdamW state)"
    before = "" if amp_dtype is not None else \
        (f" (before the flat parameter buffer: step "
         f"{TRAIN_PREV['step_ms']} ms, peak {TRAIN_PREV['peak_gb']} GB)")
    print(f"training llama3_8b width, {TRAIN_LAYERS} layers, {text}, "
          f"{n_params} params in the Trainer's flat buffer, adamw, batch "
          f"{TRAIN_BATCH}x{TRAIN_SEQ} on {card}: losses {losses}; step "
          f"median {step_ms:.1f} ms over steps 2-{TRAIN_STEPS} (first "
          f"{step_s[0] * 1e3:.1f} ms) = "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.1f} tokens/s; peak "
          f"memory {peak_gb:.2f} GB; set-up {setup_s:.3f} s{before}; "
          f"logits {act}, loss {act}, gradients torch.float32; launches "
          f"{launches}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"{phase}: non-finite training loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{phase}: loss did not fall from step 1 to step "
             f"{TRAIN_STEPS}: {losses}")
    if f32_first_loss is not None:
        err = abs(losses[0] - f32_first_loss) / abs(f32_first_loss)
        print(f"{phase}: first loss {losses[0]} against the f32 phase's "
              f"{f32_first_loss} (same weights and batch): relative "
              f"difference {err:.3e} (limit {AMP_FIRST_LOSS_RTOL})",
              flush=True)
        if not err <= AMP_FIRST_LOSS_RTOL:
            fail(f"{phase}: first loss too far from the f32 phase's")
    del net, trainer, loss, buf, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, losses[0]


# ----------------------------------------------------------------------
# phase 9: training, card against CPU on the full-width geometry
# ----------------------------------------------------------------------

def train_card_vs_cpu(dev):
    import numpy as np
    import torch
    from mxnet_tpu_torch import autograd, nd, ops
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                           LlamaForCausalLM)
    cfg = LlamaConfig(num_layers=1, vocab_size=32000)
    on_card = LlamaForCausalLM(cfg, device=dev, seed=1)
    on_cpu = copy_weights(on_card, LlamaForCausalLM(cfg, device="cpu"))
    rng = np.random.RandomState(2)
    tokens, labels = (rng.randint(0, cfg.vocab_size, (1, 64))
                      for _ in range(2))
    runs, launches = [], None
    for net, d in ((on_card, dev), (on_cpu, torch.device("cpu"))):
        trainer = Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9})
        if d.type == "cuda":
            ops.reset_launches()
        losses = []
        for _ in range(2):
            with autograd.record():
                loss = SoftmaxCrossEntropyLoss()(
                    net(nd.array(tokens, ctx=d)), nd.array(labels, ctx=d))
                total = loss.sum()
            total.backward()
            trainer.step(1)
            losses.append(float(loss.data.detach().mean()))
        if d.type == "cuda":
            torch.cuda.synchronize(dev)
            launches = read_launches("training card vs cpu", {
                "flash_attention_fwd": 2, "flash_attention_bwd": 2,
                "fused_sgd_update": 2})
        runs.append(losses)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*runs))
    want = on_cpu._collect_params_with_prefix()
    param_err = max(float((p.data().data.cpu() - want[k].data().data)
                          .abs().max())
                    for k, p in on_card._collect_params_with_prefix().items())
    print(f"training card vs cpu (1 layer, full width, vocab cut to "
          f"{cfg.vocab_size}, fp32, 2 sgd-momentum steps on 64 tokens): "
          f"losses card {runs[0]} cpu {runs[1]}, max relative loss diff "
          f"{loss_err:.3e} (limit {TRAIN_LOSS_RTOL}), max |param| diff "
          f"{param_err:.3e} (limit {TRAIN_PARAM_ATOL})", flush=True)
    if not (loss_err <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_ATOL):
        fail("training on the card and on the CPU disagree")
    del on_card, on_cpu
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phase 10: the fused LayerNorm op path (K4)
# ----------------------------------------------------------------------

def layernorm_path(dev, card):
    """BERT-large's 24 layers x 2 post-sublayer LayerNorms
    (``bert_24_1024_16``: batch 8 x 512 tokens = 4096 rows, D = 1024),
    each ``fused_layer_norm(x_i, gamma_i, beta_i, residual=h_i, eps=1e-12)``
    on bf16 activations with f32 parameters, then one backward through
    autograd, twice; the second pass is counted and timed: 48 forward and
    48 backward launches, every gradient finite and within phase 3's
    tolerances of the plain backward.  A further pass under
    ``torch.profiler`` gives the device time by kernel, printed beside
    the host clock."""
    import torch
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.ops import fused_layer_norm
    from mxnet_tpu_torch.ops.fused_layernorm import layer_norm_bwd_plain
    n, rows, D, eps = 48, 4096, 1024, 1e-12
    g = torch.Generator(device=dev).manual_seed(10)
    sets = []
    for _ in range(n):
        x, h, dy = (torch.randn(rows, D, device=dev, generator=g)
                    .to(torch.bfloat16) for _ in range(3))
        gamma = 1.0 + 0.1 * torch.randn(D, device=dev, generator=g)
        beta = 0.1 * torch.randn(D, device=dev, generator=g)
        sets.append([t.requires_grad_() for t in (x, h, gamma, beta)] + [dy])

    def run():
        """Forward and backward of the 48 norms: (fwd s, fwd + bwd s)."""
        for t in (t for st in sets for t in st[:4]):
            t.grad = None
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        outs = [fused_layer_norm(x, gamma, beta, residual=h, eps=eps)
                for x, h, gamma, beta, _ in sets]
        torch.cuda.synchronize(dev)
        fwd_s = time.perf_counter() - t0
        torch.autograd.backward(outs, [st[4] for st in sets])
        torch.cuda.synchronize(dev)
        return fwd_s, time.perf_counter() - t0

    run()                       # warm: the allocator's blocks exist after
    ops.reset_launches()
    fwd_s, both_s = run()
    launches = read_launches("layernorm op", {"fused_layer_norm_fwd": n,
                                              "fused_layer_norm_bwd": n})
    worst = {"dx": 0.0, "dgamma": 0.0, "dbeta": 0.0}
    for x, h, gamma, beta, dy in sets:
        want = layer_norm_bwd_plain(x.detach(), h.detach(), gamma.detach(),
                                    dy, eps)
        if not torch.equal(h.grad, x.grad):
            fail("layernorm op: dres differs from dx")
        for got, w, what, tol in zip((x.grad, gamma.grad, beta.grad), want,
                                     worst, (LN_TOL["bfloat16"],
                                             LN_PARAM_TOL, LN_PARAM_TOL)):
            e, ok = max_err(got, w, tol)
            if not ok or not bool(torch.isfinite(got).all()):
                fail(f"layernorm op: {what} vs plain, max abs err {e}")
            worst[what] = max(worst[what], e)
    busy = device_ms(run, 1)
    print(f"layernorm op, bert_24_1024_16 post-sublayer shape, {n} x "
          f"fused_layer_norm({rows}x{D} bf16, f32 gamma/beta, residual) on "
          f"{card}: forward {fwd_s * 1e3:.2f} ms, forward + backward "
          f"{both_s * 1e3:.2f} ms (host clock, second pass); device time "
          f"of a pass by kernel (profiler) {by_kernel(busy)}, "
          f"{sum(busy.values()):.4f} ms in all; max err vs plain {worst}; "
          f"launches {launches}", flush=True)
    del sets
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phases 12 and 13: BERT through the imperative core
# ----------------------------------------------------------------------

BERT_VOCAB, BERT_SEQ = 30522, 128
BERT_BATCH, BERT_WARMUP, BERT_STEPS = 64, 3, 10
# phase 12: each parameter's two-step Adam update, card against CPU, as
# |du_card - du_cpu| / |du_cpu| (two CPU runs at 1 and 8 threads differ
# by up to 1.0e-4, their parameters by up to 7.5e-6 absolute); the key
# biases by two Adam steps of lr 1e-4 on either device
BERT_UPDATE_RTOL = 1e-3
# phase 13's device time by kernel class (first match by name)
BUSY_CLASSES = (("flash (K3)", ("flash_",)),
                ("update (K2)", ("update_kernel",)),
                ("gemm", ("nvjet", "gemm", "cutlass", "Kernel2")),
                ("layernorm", ("RowwiseMoments", "LayerNorm", "GammaBeta",
                               "layer_norm")),
                ("reduce", ("reduce_kernel",)),
                ("cat/copy", ("CatArray", "copy")),
                ("elementwise", ("elementwise",)))
BERT_KEY_BIAS_ATOL = 4e-4


def _bert_step(net, ce, trainer, amp, data, types, label, batch):
    """One MXNet-style step: record, loss on the classifier, backward,
    ``trainer.step``; returns the per-sample losses."""
    from mxnet_tpu_torch import autograd
    with autograd.record():
        loss = ce(net(data, types)[-1], label)
    with amp.scale_loss(loss, trainer) as scaled:
        scaled.backward()
    trainer.step(batch)
    return loss


def bert_card_vs_cpu(dev):
    """Phase 12: ``get_bert_model(num_layers=2)`` at BERT-base width
    (768 units, 12 heads, FFN 3072, vocab 30522, max_length 128), dropout
    0, ``use_flash=True``, no decoder, f32; the same weights (initialized
    on the card from a seed, carried by ``convert``) train two Adam steps
    (lr 1e-4) on batch 2 x 128 through ``autograd.record`` and
    ``Trainer(net.collect_params(), "adam")`` on the card and on the
    host: losses within 1e-4 relative, each parameter's update within
    1e-3 relative (``BERT_UPDATE_RTOL``; the key biases within Adam's
    bound); on the card 2 K3 forward and 2 backward launches a step, all
    f32, and one K2."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, gluon, ops
    from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                         load_block_weights)
    from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model
    kw = dict(num_layers=2, vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
              dropout=0.0, use_flash=True, use_decoder=False)
    rng = np.random.RandomState(12)
    host = {"data": rng.randint(0, BERT_VOCAB, (2, BERT_SEQ)),
            "types": rng.randint(0, 2, (2, BERT_SEQ)),
            "label": rng.randint(0, 2, (2,))}
    weights, runs, launches = None, [], None
    for ctx in (mx.gpu(dev.index or 0), mx.cpu()):
        net = get_bert_model(**kw)
        mx.random.seed(12)
        net.initialize(ctx=ctx)
        with ctx:
            data, types, label = (mx.nd.array(host[k], dtype="int32")
                                  for k in ("data", "types", "label"))
        if weights is None:
            net(data, types)            # the deferred shapes resolve
            weights = block_weights_to_numpy(net)
        load_block_weights(net, weights)
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-4})
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        if ctx.device_type == "gpu":
            torch.cuda.synchronize(dev)
            ops.reset_launches()
        losses = [float(_bert_step(net, ce, trainer, amp, data, types,
                                   label, 2).mean().asscalar())
                  for _ in range(2)]
        if ctx.device_type == "gpu":
            torch.cuda.synchronize(dev)
            launches = read_launches("bert card vs cpu", {
                "flash_attention_fwd": 4, "flash_attention_bwd": 4,
                "fused_adam_update": 2})
        runs.append((losses, block_weights_to_numpy(net)))
        del net, trainer
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(runs[0][0],
                                                      runs[1][0]))
    # Adam maps each gradient element to a step of about lr whatever its
    # size, so an element whose gradient is mostly rounding noise (a sum
    # that cancels) moves by up to lr either way: the parameters are held
    # by each one's update p2 - p0, card against CPU, as |du_card -
    # du_cpu| / |du_cpu| less the f32 rounding of storing each step
    # (update_errs); the key projections' bias, whose gradient is zero in
    # exact arithmetic, by Adam's bound
    w0 = weights
    upd = update_errs(w0, runs[0][1], runs[1][1], 2)
    diff = {k: float(np.abs(runs[0][1][k] - runs[1][1][k]).max())
            for k in w0}
    noise = [k for k in w0 if k.endswith("proj_key.bias")]
    upd_err = max(v for k, v in upd.items() if k not in noise)
    noise_err = max(diff[k] for k in noise)
    worst = sorted(diff.items(), key=lambda kv: -kv[1])[:3]
    print(f"bert card vs cpu (2 layers at BERT-base width, vocab "
          f"{BERT_VOCAB}, f32, flash non-causal D=64, 2 adam steps on 2 x "
          f"{BERT_SEQ} tokens): losses card {runs[0][0]} cpu {runs[1][0]}, "
          f"max relative loss diff {loss_err:.3e} (limit {TRAIN_LOSS_RTOL}),"
          f" worst relative update diff {upd_err:.3e} (limit "
          f"{BERT_UPDATE_RTOL}) over every parameter but the key biases, "
          f"which differ by {noise_err:.3e} (limit {BERT_KEY_BIAS_ATOL}); "
          f"max |param| diffs {worst}; launches {launches}", flush=True)
    if not (loss_err <= TRAIN_LOSS_RTOL and upd_err <= BERT_UPDATE_RTOL
            and noise_err <= BERT_KEY_BIAS_ATOL):
        fail(f"bert training on the card and on the CPU disagree: losses "
             f"{loss_err:.3e}, update {upd_err:.3e}, key biases "
             f"{noise_err:.3e}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def bert_training(dev, card):
    """Phase 13: BERT-base training at the JAX package's own benchmark
    configuration (``bench.py``'s ``_bench_bert``):
    ``get_bert_model(vocab_size=30522, max_length=128, dropout=0.0,
    use_flash=True, use_decoder=False)`` at full depth, ``initialize()``
    on the card, ``hybridize()``, batch 64 x 128 from
    ``RandomState(0)``, ``amp.init("bfloat16")`` and
    ``amp.init_trainer``, Adam lr 1e-4: 3 warm-up steps, then 10 timed
    steps (host clock around each, ending in a synchronize).  Fails
    unless the loss is finite at every step and lower at the last than
    at the first, and each timed step launched exactly 12 K3 forward and
    12 backward (all on bf16 inputs) and one K2.  Then two more steps
    under ``torch.profiler``: the device time by kernel, and the step's
    host share ``1 - busy / wall`` against the untraced median."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, gluon, ops
    from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    amp.init("bfloat16")
    try:
        t0 = time.perf_counter()
        mx.random.seed(0)
        net = get_bert_model(vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
                             dropout=0.0, use_flash=True, use_decoder=False)
        net.initialize()
        net.hybridize()
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-4})
        amp.init_trainer(trainer)
        rng = np.random.RandomState(0)
        data = mx.nd.array(rng.randint(0, BERT_VOCAB,
                                       size=(BERT_BATCH, BERT_SEQ)),
                           dtype="int32")
        types = mx.nd.zeros((BERT_BATCH, BERT_SEQ), dtype="int32")
        label = mx.nd.array(rng.randint(0, 2, size=(BERT_BATCH,)),
                            dtype="int32")

        def step():
            return _bert_step(net, ce, trainer, amp, data, types, label,
                              BERT_BATCH)

        losses = [step().mean() for _ in range(BERT_WARMUP)]
        torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        n_params = sum(p.data().size for p in
                       net.collect_params().values())
        ops.reset_launches()
        step_s = []
        for _ in range(BERT_STEPS):
            t = time.perf_counter()
            losses.append(step().mean())
            torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t)
        want = {"flash_attention_fwd": 12 * BERT_STEPS,
                "flash_attention_bwd": 12 * BERT_STEPS,
                "flash_attention_fwd_bf16": 12 * BERT_STEPS,
                "flash_attention_bwd_bf16": 12 * BERT_STEPS,
                "fused_adam_update": BERT_STEPS}
        launches = read_launches("bert training", want)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(2):
                step()
            torch.cuda.synchronize(dev)
            traced_ms = (time.perf_counter() - t) / 2 * 1e3
    finally:
        amp._deinit_for_tests()
    busy = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy[e.key] = busy.get(e.key, 0.0) + \
                e.self_device_time_total / 1e3 / 2
    busy_ms = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    classes = {}
    for name, ms in busy.items():
        cls = next((c for c, keys in BUSY_CLASSES if any(
            k in name for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    losses = [float(x.asscalar()) for x in losses]
    step_ms = statistics.median(step_s) * 1e3
    host_share = 1 - busy_ms / step_ms
    print(f"bert training, BERT-base (12 x 768, 12 heads, FFN 3072, vocab "
          f"{BERT_VOCAB}), {n_params} params in the Trainer's flat buffer, "
          f"bf16 amp, adam lr 1e-4, batch {BERT_BATCH}x{BERT_SEQ} on "
          f"{card}: losses {losses}; step median {step_ms:.2f} ms over "
          f"{BERT_STEPS} steps after {BERT_WARMUP} warm-up (min "
          f"{min(step_s) * 1e3:.2f}, max {max(step_s) * 1e3:.2f}) = "
          f"{BERT_BATCH / step_ms * 1e3:.1f} samples/s; peak memory "
          f"{peak_gb:.2f} GB; set-up and warm-up {setup_s:.2f} s; device "
          f"busy {busy_ms:.3f} ms a step (profiler, 2 steps; traced wall "
          f"{traced_ms:.2f} ms), host share {host_share:.4f} of the "
          f"untraced step; device ms a step by class "
          f"{ {k: round(v, 3) for k, v in classes.items()} }; top kernels "
          f"{', '.join(f'{k[:60]} {v:.3f} ms' for k, v in top)}; launches "
          f"{launches}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"bert training: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"bert training: the loss did not fall: {losses}")
    del net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phases 14-15: ResNet-50 v1 through the Gluon loop (convolutions,
# pooling, BatchNorm's running statistics; K1 on the flat buffer)
# ----------------------------------------------------------------------

# bench.py's _bench_resnet: batch 128 x 3 x 224 x 224, SGD lr 0.1,
# momentum 0.9 (no weight decay, no clip)
RESNET_BATCH, RESNET_SIZE, RESNET_WARMUP, RESNET_STEPS = 128, 224, 3, 10
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
RESNET_TRAINABLE = 25_575_912        # resnet50_v1()'s bucket (K1's n)
# phase 14: card against CPU, f32, 4 x 3 x 64 x 64, two steps
RESNET_CHECK_BATCH, RESNET_CHECK_SIZE = 4, 64
# each parameter's two-step update, card against CPU, as |du_card -
# du_cpu| / |du_cpu| less the f32 rounding of storing each step
# (update_errs; 2.3e-4 seen); also printed, unreduced, for all of them
# together
RESNET_UPDATE_RTOL = 1e-3
RESNET_STAT_TOL = 1e-4        # x max(1, |value|): running statistics
RESNET_LOGIT_TOL = 1e-4       # x max(1, max |logit|): predict forward
RESNET_S2D_TOL = 1e-4         # x max(1, max |stem output|)
# the body convs' biases feed a BatchNorm: zero gradient in exact
# arithmetic, so their two-step updates are rounding noise, held
# absolutely
RESNET_NOISE_BIAS_ATOL = 1e-3
# phase 15's device time by kernel class (first match by name)
RESNET_CLASSES = (("update (K1)", ("update_kernel",)),
                  ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
                  ("conv backward (data)", ("dgrad",)),
                  ("conv backward (weight)", ("wgrad",)),
                  ("conv forward", ("fprop", "conv", "implicit")),
                  ("batchnorm", ("batch_norm",)),
                  ("pooling", ("pool",)),
                  ("gemm", ("nvjet", "gemm", "cutlass", "Kernel2")),
                  ("gradient gather", ("CatArray",)),
                  ("casts/copies", ("copy",)),
                  ("reduce", ("reduce_kernel",)),
                  ("elementwise", ("elementwise",)))


def check_resnet_update(dev, flush):
    """K1 at ResNet-50 v1's bucket (n = 25,575,912, phase 17's main
    path): momentum 0.9, lr 0.1 read from memory, wd 0, rescale 1/128,
    no clip, against the plain rule on the same inputs, then timed
    against the plain rule and ``torch._fused_sgd_`` (``UPDATE_PAIRS``
    interleaved pairs); the row the kernels line reports for K1."""
    import torch
    from mxnet_tpu_torch.ops.fused_update import fused_bucket_rule
    from mxnet_tpu_torch.optimizer import fused_rule
    n, hyper = RESNET_TRAINABLE, {"momentum": RESNET_MOMENTUM}
    lr, wd, rescale = RESNET_LR, 0.0, 1.0 / RESNET_BATCH
    p, grad, s = update_case("sgd", n, dev)
    _, apply = fused_bucket_rule("sgd", **hyper)
    _, plain = fused_rule("sgd", **hyper)
    lr_dev, ks = device_scalars(lr, {"mom": s["mom"].clone()}, dev)
    kp, ks = apply(p.clone(), grad, ks, lr_dev, wd, rescale)   # in place
    want_p, want_s = plain(p, grad, s, lr, wd, rescale)
    err = 0.0
    for got, want in ((kp, want_p), (ks["mom"], want_s["mom"])):
        e, ok = max_err(got, want, UPDATE_TOL)
        if not ok:
            fail(f"fused_sgd_update at ResNet-50's bucket vs plain: max "
                 f"abs err {e}")
        err = max(err, e)
    step = torch.tensor(1.0, device=dev)
    times = interleaved_ms(
        {"kernel": lambda: apply(kp, grad, ks, lr_dev, wd, rescale),
         "library": lambda: _library_update("sgd", hyper, kp, grad, ks, lr,
                                            wd, step)}, UPDATE_PAIRS, flush)
    plain_ms = time_ms(lambda: plain(p, grad, s, lr, wd, rescale), 10, flush)
    nbytes = 20 * n             # p, mom read and written, the gradient read
    bound_ms, by = bound(nbytes, 8.0 * n, "float32")
    text, ms, lib_ms = pair_summary(times["kernel"], times["library"],
                                    nbytes, bound_ms)
    print(f"fused_sgd_update (sgd, momentum {RESNET_MOMENTUM}, lr "
          f"{RESNET_LR} from memory, wd 0, no clip) n={n} (ResNet-50 v1's "
          f"bucket): max_abs_err {err:.3e} kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms library (near) {lib_ms:.4f} ms bound "
          f"{bound_ms:.4f} ms ({by}); {text}", flush=True)
    record("fused_sgd_update", "float32 sgd resnet50", [n], ms, plain_ms,
           lib_ms, bound_ms, by)
    del p, grad, s, kp, ks, want_p, want_s
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": by}


BERT_TRAINABLE = 109_188_866         # BERT-base's bucket (K2's n)


def check_bert_update(dev, flush):
    """K2 at BERT-base's bucket (n = 109,188,866, phase 18's main path):
    Adam lr 1e-4, wd 0, no clip, lr and t read from memory (t counted up
    by the wrapper), against the plain rule within its tolerance; then
    timed against the plain rule and ``torch._fused_adam_``
    (``UPDATE_PAIRS`` interleaved); the row the kernels line reports for
    K2."""
    import torch
    from mxnet_tpu_torch.ops.fused_update import fused_bucket_rule
    from mxnet_tpu_torch.optimizer import fused_rule
    n, lr, wd = BERT_TRAINABLE, 1e-4, 0.0
    hyper = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    p, grad, s = update_case("adam", n, dev)
    _, apply = fused_bucket_rule("adam", **hyper)
    _, plain = fused_rule("adam", **hyper)
    lr_dev, ks = device_scalars(lr, {"m": s["m"].clone(),
                                     "v": s["v"].clone(), "t": s["t"]}, dev)
    kp, ks = apply(p.clone(), grad, ks, lr_dev, wd)
    if int(ks["t"].item()) != s["t"] + 1:
        fail("fused_adam_update: the wrapper did not count t up in place")
    err = 0.0
    for c in _chunks(n):
        want_p, want_s = plain(p[c], grad[c], {"m": s["m"][c],
                                               "v": s["v"][c],
                                               "t": s["t"]}, lr, wd)
        for got, want in ((kp[c], want_p), (ks["m"][c], want_s["m"]),
                          (ks["v"][c], want_s["v"])):
            e, ok = max_err(got, want, UPDATE_TOL)
            if not ok:
                fail(f"fused_adam_update at BERT-base's bucket vs plain: "
                     f"max abs err {e}")
            err = max(err, e)
    step = torch.tensor(3.0, device=dev)
    times = interleaved_ms(
        {"kernel": lambda: apply(kp, grad, ks, lr_dev, wd),
         "library": lambda: _library_update("adam", hyper, kp, grad, ks, lr,
                                            wd, step)}, UPDATE_PAIRS, flush)

    def plain_pass():
        for c in _chunks(n):
            plain(p[c], grad[c], {"m": s["m"][c], "v": s["v"][c],
                                  "t": s["t"]}, lr, wd)

    plain_ms = time_ms(plain_pass, 3, flush)
    nbytes = 28 * n             # p, m, v read and written, the gradient read
    bound_ms, by = bound(nbytes, 20.0 * n, "float32")
    text, ms, lib_ms = pair_summary(times["kernel"], times["library"],
                                    nbytes, bound_ms)
    print(f"fused_adam_update (adam, lr {lr} and t from memory, wd 0, no "
          f"clip) n={n} (BERT-base's bucket): max_abs_err {err:.3e} kernel "
          f"{ms:.4f} ms plain {plain_ms:.4f} ms library (near) "
          f"{lib_ms:.4f} ms bound {bound_ms:.4f} ms ({by}); {text}",
          flush=True)
    record("fused_adam_update", "float32 adam bert-base", [n], ms, plain_ms,
           lib_ms, bound_ms, by)
    del p, grad, s, kp, ks
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": by}


def _resnet_step(net, ce, trainer, data, label, batch):
    """One step of MXNet's loop; returns (per-sample losses, logits)."""
    from mxnet_tpu_torch import autograd
    with autograd.record():
        out = net(data)
        loss = ce(out, label)
    loss.backward()
    trainer.step(batch)
    return loss, out


def _close(got, want, tol):
    """max |got - want| and whether it is within ``tol * max(1, max
    |want|)``."""
    diff = float(abs(got - want).max())
    return diff, diff <= tol * max(1.0, float(abs(want).max()))


def resnet_check_weights(host_x):
    """Phase 14's weights, made on the host (so any host can make them
    again): ``resnet50_v1()`` initialized by ``Xavier(magnitude=2)``
    after ``mx.random.seed(14)``, its deferred shapes resolved by a
    forward on ``host_x``, each bottleneck's last BatchNorm gamma
    zeroed; numpy arrays by structural name."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import block_weights_to_numpy
    from mxnet_tpu_torch.gluon.model_zoo import vision
    with mx.cpu():
        net = vision.resnet50_v1()
        mx.random.seed(14)
        net.initialize(mx.init.Xavier(magnitude=2))
        net(mx.nd.array(host_x))
    weights = block_weights_to_numpy(net)
    for k in weights:
        if k.endswith("body.7.gamma"):
            weights[k][:] = 0.0
    return weights


def resnet_card_vs_cpu(dev):
    """Phase 14: ``resnet50_v1()`` at full width in f32 (TF32 off), the
    same weights (``Xavier(magnitude=2)`` from a seed on the card, each
    bottleneck's last BatchNorm gamma zeroed, carried by ``convert``) on
    the card and on the host, two SGD-momentum steps
    (lr 0.1, momentum 0.9) on 4 x 3 x 64 x 64 from ``RandomState(0)``
    with labels in [0, 1000), the card on cuDNN's deterministic
    algorithms: losses within 1e-4 relative, each parameter's two-step
    update within 1e-3 relative net of the f32 rounding of storing it
    (the body convs' biases, whose gradient is zero in exact arithmetic,
    within
    ``RESNET_NOISE_BIAS_ATOL`` absolute), the running statistics within
    1e-4, a predict-mode forward after the steps within 1e-4; on the card
    exactly 2 K1 launches.  Then ``SpaceToDepthStem`` on the card from
    the same ``conv0_weight``: its output within 1e-4 of the stock
    stem's.

    The zeroed gammas are the zero-gamma initialization of large-batch
    ResNet training (Goyal et al. 2017; GluonCV's ``last_gamma``): each
    residual block starts as its shortcut.  At a plain random
    initialization the gradient of a BatchNorm ResNet this deep
    amplifies rounding: two CPU runs that differ only in their thread
    count differ by 1% in the median parameter's first gradient, and
    their second losses by 2.4%, so no card could be held to 1e-3 from
    there.  With the zeroed gammas, CPU runs at 1, 2, 4, 16 and 64
    threads agree within 6e-6 on every update, read net of the f32
    rounding of storing it (``update_errs``; unreduced, one element of
    ``features.4.0.body.4.gamma`` stored an ulp apart read 2.9e-3).  At
    8 threads the CPU sums in another order and sits 6.7e-4 from them at
    ``features.4.0.body.4.beta``, a parameter behind a zeroed gamma whose
    step-2 gradient is a sum that cancels; the card agrees with the
    8-thread run within 2e-5.  The card has a third form when cuDNN may
    pick algorithms that sum in any order: two of nineteen such runs
    read 5.2e-3 at ``features.4.0.body.1.beta``
    (``tools/port_resnet_cpu_threads.py``).  So the card runs cuDNN's
    deterministic algorithms here, as phase 16 does, and its result is
    the same in every process."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, ops
    from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                         load_block_weights)
    from mxnet_tpu_torch.gluon.model_zoo import vision
    rng = np.random.RandomState(0)
    host_x = rng.rand(RESNET_CHECK_BATCH, 3, RESNET_CHECK_SIZE,
                      RESNET_CHECK_SIZE).astype(np.float32)
    host_y = rng.randint(0, 1000, (RESNET_CHECK_BATCH,))
    weights = resnet_check_weights(host_x)
    runs, launches = [], None
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for ctx in (mx.gpu(dev.index or 0), mx.cpu()):
        on_card = not runs
        net = vision.resnet50_v1()
        net.initialize(ctx=ctx)
        with ctx:
            data = mx.nd.array(host_x)
            label = mx.nd.array(host_y, dtype="int32")
        load_block_weights(net, weights)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": RESNET_LR,
                                 "momentum": RESNET_MOMENTUM})
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        if on_card:
            torch.cuda.synchronize(dev)
            ops.reset_launches()
        losses = [float(_resnet_step(net, ce, trainer, data, label,
                                     RESNET_CHECK_BATCH)[0].mean()
                        .asscalar()) for _ in range(2)]
        if on_card:
            torch.cuda.synchronize(dev)
            launches = read_launches("resnet card vs cpu",
                                     {"fused_sgd_update": 2})
        logits = net(data).asnumpy()          # predict mode: running stats
        runs.append((losses, block_weights_to_numpy(net), logits))
        if on_card:
            card_net, card_data = net, data
        del net, trainer
    (card_l, card_w, card_o), (cpu_l, cpu_w, cpu_o) = runs
    w0 = weights
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    stats = [k for k in w0 if k.endswith(("running_mean", "running_var"))]
    noise = [k for k in w0 if k.endswith("bias") and ".body." in k]
    held = [k for k in w0 if k not in stats and k not in noise]
    upd = update_errs({k: w0[k] for k in held}, card_w, cpu_w, 2)
    upd_err = max(upd.values())
    whole_err = float(np.sqrt(sum(
        np.sum(np.square(card_w[k] - cpu_w[k])) for k in held) / sum(
        np.sum(np.square(cpu_w[k] - w0[k])) for k in held)))
    noise_err = max(float(np.abs(card_w[k] - cpu_w[k]).max())
                    for k in noise)
    stat_err, stat_ok = 0.0, True
    for k in stats:
        e, ok = _close(card_w[k], cpu_w[k], RESNET_STAT_TOL)
        stat_err, stat_ok = max(stat_err, e), stat_ok and ok
    moved = all(not np.array_equal(card_w[k], w0[k]) for k in stats)
    logit_err, logit_ok = _close(card_o, cpu_o, RESNET_LOGIT_TOL)
    # the space-to-depth stem on the card, from the stepped weights
    s2d = vision.resnet50_v1(s2d_stem=True)
    s2d.initialize(ctx=mx.gpu(dev.index or 0))
    load_block_weights(s2d, card_w)
    stem = card_net.features[0](card_data).asnumpy()
    stem_s2d = s2d.features[0](card_data).asnumpy()
    s2d_err, s2d_ok = _close(stem_s2d, stem, RESNET_S2D_TOL)
    s2d_logits = s2d(card_data).asnumpy()
    torch.backends.cudnn.deterministic = prev
    worst = sorted(upd.items(), key=lambda kv: -kv[1])[:3]
    print(f"resnet card vs cpu (resnet50_v1, {len(w0)} parameters, "
          f"{sum(w0[k].size for k in w0 if k not in stats)} trainable, f32, "
          f"2 sgd-momentum steps on {RESNET_CHECK_BATCH} x 3 x "
          f"{RESNET_CHECK_SIZE} x {RESNET_CHECK_SIZE}): losses card "
          f"{card_l} cpu {cpu_l}, max relative loss diff {loss_err:.3e} "
          f"(limit {TRAIN_LOSS_RTOL}); relative diff of the whole update "
          f"{whole_err:.3e}, worst of one parameter {upd_err:.3e} (limit "
          f"{RESNET_UPDATE_RTOL}; worst {worst}); the "
          f"body convs' biases differ by {noise_err:.3e} (limit "
          f"{RESNET_NOISE_BIAS_ATOL}); running statistics max diff "
          f"{stat_err:.3e} (limit {RESNET_STAT_TOL} x max(1, |x|)), moved "
          f"{moved}; predict-mode logits max diff {logit_err:.3e} (limit "
          f"{RESNET_LOGIT_TOL} x max(1, |logit|), max |logit| "
          f"{float(np.abs(cpu_o).max()):.3e}); space-to-depth stem vs stock "
          f"on the card max diff {s2d_err:.3e} (limit {RESNET_S2D_TOL} x "
          f"max(1, |x|), max |x| {float(np.abs(stem).max()):.3e}), logits "
          f"{float(np.abs(s2d_logits - card_o).max()):.3e}; launches "
          f"{launches}", flush=True)
    failed = [what for what, ok in (
        (f"losses {loss_err:.3e}", loss_err <= TRAIN_LOSS_RTOL),
        (f"update {upd_err:.3e} at {worst[0][0]}",
         upd_err <= RESNET_UPDATE_RTOL),
        (f"body conv biases {noise_err:.3e}",
         noise_err <= RESNET_NOISE_BIAS_ATOL),
        (f"running statistics {stat_err:.3e}", stat_ok),
        ("running statistics did not move", moved),
        (f"predict-mode logits {logit_err:.3e}", logit_ok),
        (f"space-to-depth stem {s2d_err:.3e}", s2d_ok)) if not ok]
    if failed:
        fail("resnet training on the card and on the CPU disagree: "
             + "; ".join(failed))
    del card_net, s2d
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def resnet_training(dev, card):
    """Phase 15: ResNet-50 v1 training at the JAX package's own benchmark
    configuration (``bench.py``'s ``_bench_resnet``):
    ``resnet50_v1()`` (the stock 7x7/2 stem), ``initialize()`` on the
    card, ``hybridize()``, ``amp.init("bfloat16")``, batch 128 x 3 x 224
    x 224 from ``nd.random.uniform`` seeded 0, labels zeros,
    ``SoftmaxCrossEntropyLoss`` and ``Trainer(net.collect_params(),
    "sgd", {"learning_rate": 0.1, "momentum": 0.9})``, through MXNet's
    loop: 3 warm-up steps, then 10 timed (host clock around each, ending
    in a synchronize).  Fails unless the loss is finite at every step
    and lower at the last than at the first, the logits are bf16, the
    running statistics finite and moved, and K1 ran exactly once a step
    (and nothing else).  Then two more steps under ``torch.profiler``:
    the device time by kernel class and the step's host share ``1 -
    busy / wall`` against the untraced median."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, gluon, ops
    from mxnet_tpu_torch.gluon.model_zoo import vision
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    amp.init("bfloat16")
    try:
        t0 = time.perf_counter()
        mx.random.seed(0)
        net = vision.resnet50_v1()
        net.initialize()
        net.hybridize()
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": RESNET_LR,
                                 "momentum": RESNET_MOMENTUM})
        data = mx.nd.random.uniform(shape=(RESNET_BATCH, 3, RESNET_SIZE,
                                           RESNET_SIZE))
        label = mx.nd.zeros((RESNET_BATCH,))

        def step():
            return _resnet_step(net, ce, trainer, data, label, RESNET_BATCH)

        losses = []
        for _ in range(RESNET_WARMUP):
            loss, out = step()
            losses.append(loss.mean())
        torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        params = net.collect_params()
        stats = {k: p for k, p in params.items()
                 if k.endswith(("running_mean", "running_var"))}
        stats0 = {k: p.data().asnumpy() for k, p in stats.items()}
        n_params = sum(p.data().size for p in params.values())
        n_trainable = sum(p.data().size for p in params.values()
                          if p.grad_req != "null")
        ops.reset_launches()
        step_s = []
        for _ in range(RESNET_STEPS):
            t = time.perf_counter()
            loss, out = step()
            losses.append(loss.mean())
            torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t)
        launches = read_launches("resnet training",
                                 {"fused_sgd_update": RESNET_STEPS})
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        logits_dtype = str(out.dtype)
        stats1 = {k: p.data().asnumpy() for k, p in stats.items()}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(2):
                step()
            torch.cuda.synchronize(dev)
            traced_ms = (time.perf_counter() - t) / 2 * 1e3
    finally:
        amp._deinit_for_tests()
    busy = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy[e.key] = busy.get(e.key, 0.0) + \
                e.self_device_time_total / 1e3 / 2
    busy_ms = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:10]
    classes, members = {}, {}
    for name, ms in busy.items():
        cls = next((c for c, keys in RESNET_CLASSES if any(
            k in name for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + ms
        members.setdefault(cls, []).append((ms, name))
    # the kernels behind the classes that name no operation
    unnamed = "; ".join(
        f"{cls}: " + ", ".join(f"{n[:60]} {ms:.3f} ms" for ms, n in
                               sorted(members[cls], reverse=True)[:4])
        for cls in ("gemm", "other") if cls in members)
    losses = [float(x.asscalar()) for x in losses]
    step_ms = statistics.median(step_s) * 1e3
    host_share = 1 - busy_ms / step_ms
    finite = all(np.all(np.isfinite(v)) for v in stats1.values())
    moved = sum(not np.array_equal(stats1[k], stats0[k]) for k in stats)
    print(f"resnet training, ResNet-50 v1 (stock stem), {n_params} params, "
          f"{n_trainable} in the Trainer's flat buffer (K1's bucket), bf16 "
          f"amp, sgd lr {RESNET_LR} momentum {RESNET_MOMENTUM}, batch "
          f"{RESNET_BATCH}x3x{RESNET_SIZE}x{RESNET_SIZE} on {card}: losses "
          f"{losses}; logits {logits_dtype}; running statistics finite "
          f"{finite}, {moved} of {len(stats)} moved over the timed steps; "
          f"step median {step_ms:.2f} ms over {RESNET_STEPS} steps after "
          f"{RESNET_WARMUP} warm-up (min {min(step_s) * 1e3:.2f}, max "
          f"{max(step_s) * 1e3:.2f}) = {RESNET_BATCH / step_ms * 1e3:.1f} "
          f"images/s; peak memory {peak_gb:.2f} GB; set-up and warm-up "
          f"{setup_s:.2f} s; device busy {busy_ms:.3f} ms a step (profiler, "
          f"2 steps; traced wall {traced_ms:.2f} ms), host share "
          f"{host_share:.4f} of the untraced step; device ms a step by "
          f"class { {k: round(v, 3) for k, v in classes.items()} } "
          f"({unnamed}); top kernels "
          f"{', '.join(f'{k[:70]} {v:.3f} ms' for k, v in top)}; "
          f"launches {launches}", flush=True)
    if n_trainable != RESNET_TRAINABLE:
        fail(f"resnet training: {n_trainable} trainable parameters, "
             f"expected {RESNET_TRAINABLE}")
    if not all(np.isfinite(losses)):
        fail(f"resnet training: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"resnet training: the loss did not fall: {losses}")
    if logits_dtype != "bfloat16":
        fail(f"resnet training: logits are {logits_dtype}, not bfloat16")
    if not finite or moved != len(stats):
        fail(f"resnet training: running statistics finite {finite}, "
             f"{moved} of {len(stats)} moved")
    del net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phases 16-19: the reference's training entry point,
# parallel.DataParallelTrainer on a one-device mesh (each step one CUDA
# graph replay after the first of its signature), and checkpointing
# ----------------------------------------------------------------------

DP_STEPS, DP_WARMUP, DP_TIMED = 3, 3, 20
# phase 16: captured replays against the same body run eagerly on the
# card, relative to each loss and each parameter's update (bitwise where
# every kernel is deterministic; printed)
DP_GRAPH_RTOL = 1e-5
DP_CONV_BATCH, DP_BERT_BATCH = 8, 4


def _dp_conv_net(nn):
    """Phase 16's small conv net: two 3x3 convs (no bias: each feeds a
    BatchNorm) with BatchNorm and ReLU, global pooling, a 10-way head."""
    net = nn.HybridSequential(prefix="dpconv_")
    with net.name_scope():
        net.add(nn.Conv2D(16, 3, padding=1, in_channels=3, use_bias=False),
                nn.BatchNorm(in_channels=16), nn.Activation("relu"),
                nn.Conv2D(32, 3, strides=2, padding=1, in_channels=16,
                          use_bias=False),
                nn.BatchNorm(in_channels=32), nn.Activation("relu"),
                nn.GlobalAvgPool2D(), nn.Flatten(),
                nn.Dense(10, in_units=32))
    return net


def _dp_trainer(net, loss_fn, rule, params, dev):
    from mxnet_tpu_torch import parallel
    return parallel.DataParallelTrainer(
        net, loss_fn, rule, dict(params),
        mesh=parallel.make_mesh({"dp": 1}, devices=[dev]))


def dp_card_vs_cpu(dev):
    """Phase 16: ``parallel.DataParallelTrainer`` card against CPU in
    f32, and its captured replays against the same body run eagerly on
    the card.  Two nets from host-made weights: phase 16's small conv net
    with BatchNorm (SGD momentum 0.9, lr 0.1, batch 8 x 3 x 32 x 32) and
    ``get_bert_model(num_layers=2)`` at BERT-base width (dropout 0,
    flash, no decoder; Adam lr 1e-4, batch 4 x 128).  Each takes 3 steps,
    then ``set_learning_rate`` halves the rate and a 4th step follows,
    on the card (captured), on the card with ``_use_graphs = False`` (the
    eager body) and on the CPU.  Losses within 1e-4 relative and each
    parameter's update within 1e-3 relative card against CPU (phase 14's
    limits; BERT's key biases by Adam's bound), captured against eager
    within ``DP_GRAPH_RTOL`` (the largest difference printed); one capture
    a trainer.  Then, on the card: ``step_indexed`` over ``put_epoch`` of
    the conv batches against ``step`` on the same slices, and
    ``step_accum(n_micro=2)`` against ``step`` on BERT's whole batch, each
    within the card-against-CPU limits."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, ops
    from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                         load_block_weights)
    from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rng = np.random.RandomState(16)
    conv_batches = [(rng.rand(DP_CONV_BATCH, 3, 32, 32).astype(np.float32),
                     rng.randint(0, 10, (DP_CONV_BATCH,)).astype(np.float32))
                    for _ in range(DP_STEPS + 1)]
    bert_batches = [(rng.randint(0, BERT_VOCAB, (DP_BERT_BATCH, BERT_SEQ))
                     .astype(np.int32),
                     rng.randint(0, 2, (DP_BERT_BATCH, BERT_SEQ))
                     .astype(np.int32),
                     rng.randint(0, 2, (DP_BERT_BATCH,)).astype(np.int32))
                    for _ in range(DP_STEPS + 1)]
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def bert_loss(out, label):
        return ce(out[-1], label)

    cases = {
        "conv": dict(net=lambda: _dp_conv_net(gluon.nn), rule="sgd",
                     params={"learning_rate": 0.1, "momentum": 0.9},
                     loss=ce, batches=conv_batches, noise=(),
                     init=mx.init.Xavier(magnitude=2)),
        "bert": dict(net=lambda: get_bert_model(
            num_layers=2, vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
            dropout=0.0, use_flash=True, use_decoder=False), rule="adam",
            params={"learning_rate": 1e-4}, loss=bert_loss,
            batches=bert_batches, noise="proj_key.bias", init=None)}
    lines, bad = [], []
    try:
        torch.cuda.synchronize(dev)
        ops.reset_launches()
        for name, c in cases.items():
            with mx.cpu():            # the weights, made on the host
                net = c["net"]()
                mx.random.seed(16)
                net.initialize(c["init"])
                net(*[mx.nd.array(x) for x in c["batches"][0][:-1]])
            w0 = block_weights_to_numpy(net)
            runs = {}
            for how in ("graph", "eager", "cpu", "variant"):
                ctx = mx.cpu() if how == "cpu" else mx.gpu(dev.index or 0)
                net = c["net"]()
                net.initialize(ctx=ctx)
                load_block_weights(net, w0)
                tr = _dp_trainer(net, c["loss"], c["rule"], c["params"],
                                 ctx.torch_device)
                tr._use_graphs = how != "eager"
                handle = None
                if how == "variant" and name == "conv":
                    handle = tr.put_epoch(
                        np.stack([b[0] for b in c["batches"]]),
                        np.stack([b[1] for b in c["batches"]]))
                losses = []
                for i, batch in enumerate(c["batches"]):
                    if i == DP_STEPS:
                        tr.set_learning_rate(tr.learning_rate / 2)
                    if how != "variant":
                        loss = tr.step(*batch)
                    elif handle is not None:
                        loss = tr.step_indexed(handle, i)
                    else:
                        loss = tr.step_accum(*batch, n_micro=2)
                    losses.append(float(loss.asnumpy()))
                want_captures = 1 if how in ("graph", "variant") else 0
                if tr.stats["captures"] != want_captures:
                    bad.append(f"{name} {how}: {tr.stats['captures']} "
                               f"captures, expected {want_captures}")
                runs[how] = (losses, block_weights_to_numpy(net))
                del net, tr
            trainable = [k for k in w0 if "running_" not in k]
            w0 = {k: w0[k] for k in trainable}
            got = {how: (l, {k: w[k] for k in trainable})
                   for how, (l, w) in runs.items()}
            noise = [k for k in trainable if c["noise"] and
                     k.endswith(c["noise"])]

            def compare(a, b, loss_tol, upd_tol):
                la, wa = got[a]
                lb, wb = got[b]
                loss_err = max(abs(x - y) / max(abs(y), 1e-30)
                               for x, y in zip(la, lb))
                errs = update_errs(w0, wa, wb, DP_STEPS + 1, skip=noise)
                worst = max(errs.items(), key=lambda kv: kv[1])
                noise_err = max([float(np.abs(wa[k] - wb[k]).max())
                                 for k in noise] or [0.0])
                same = la == lb and all(np.array_equal(wa[k], wb[k])
                                        for k in wa)
                ok = loss_err <= loss_tol and worst[1] <= upd_tol and \
                    noise_err <= BERT_KEY_BIAS_ATOL
                text = (f"{a} vs {b}: max relative loss diff "
                        f"{loss_err:.3e} (limit {loss_tol}), worst relative "
                        f"update diff {worst[1]:.3e} at {worst[0]} (limit "
                        f"{upd_tol})"
                        + (f", key biases {noise_err:.3e} (limit "
                           f"{BERT_KEY_BIAS_ATOL})" if noise else "")
                        + f", bitwise {same}")
                return ok, text

            checks = [("graph", "cpu", TRAIN_LOSS_RTOL, RESNET_UPDATE_RTOL),
                      ("graph", "eager", DP_GRAPH_RTOL, DP_GRAPH_RTOL),
                      ("variant", "graph", TRAIN_LOSS_RTOL,
                       RESNET_UPDATE_RTOL)]
            texts = []
            for a, b, lt, ut in checks:
                ok, text = compare(a, b, lt, ut)
                texts.append(text)
                if not ok:
                    bad.append(f"{name}: {text}")
            variant = "step_indexed over put_epoch" if name == "conv" \
                else "step_accum(n_micro=2)"
            lines.append(f"{name} ({c['rule']} {c['params']}, {DP_STEPS} "
                         f"steps, then the rate halved and one more; "
                         f"'variant' is {variant}): losses graph "
                         f"{got['graph'][0]} cpu {got['cpu'][0]}; "
                         + "; ".join(texts))
        torch.cuda.synchronize(dev)
        launches = read_launches("dp card vs cpu", {
            "fused_sgd_update": 3 * (DP_STEPS + 1),
            "fused_adam_update": 3 * (DP_STEPS + 1),
            "flash_attention_fwd": 2 * 4 * (DP_STEPS + 1),
            "flash_attention_bwd": 2 * 4 * (DP_STEPS + 1)})
    finally:
        torch.backends.cudnn.deterministic = prev
    print("dp card vs cpu (DataParallelTrainer on a one-device mesh, f32): "
          + " | ".join(lines) + f"; launches {launches}", flush=True)
    if bad:
        fail("dp card vs cpu: " + "; ".join(bad))
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dp_checkpoint(dev):
    """Phase 19: checkpointing on the card.  A Dense/BatchNorm net
    (256 -> 512 -> BatchNorm -> ReLU -> 10, f32) through
    ``DataParallelTrainer`` with Adam (lr 1e-3) on batch 64: 3 steps,
    ``CheckpointManager.save`` (under ``build/`` in the checkout), 2 more
    steps; a fresh net and trainer (other weights) restore the
    checkpoint and take the same 2 steps: every parameter, BatchNorm's
    statistics and Adam's step count bitwise the first run's.  Then a
    checkpoint whose manifest is missing (torn) is skipped by
    ``latest()``."""
    import shutil
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import checkpoint, gluon, ops
    from mxnet_tpu_torch.convert import block_weights_to_numpy
    root = os.path.join(REPO, "build", "smoke_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.RandomState(19)
    batches = [(rng.randn(64, 256).astype(np.float32),
                rng.randint(0, 10, (64,)).astype(np.float32))
               for _ in range(5)]

    def build(seed):
        nn = gluon.nn
        net = nn.HybridSequential(prefix="dpckpt_")
        with net.name_scope():
            net.add(nn.Dense(512, in_units=256, use_bias=False),
                    nn.BatchNorm(in_channels=512), nn.Activation("relu"),
                    nn.Dense(10, in_units=512))
        mx.random.seed(seed)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(dev.index or 0))
        return net, _dp_trainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                "adam", {"learning_rate": 1e-3}, dev)

    torch.cuda.synchronize(dev)
    ops.reset_launches()
    try:
        mgr = checkpoint.CheckpointManager(root, keep=3)
        net, tr = build(19)
        for b in batches[:3]:
            tr.step(*b)
        t0 = time.perf_counter()
        ticket = mgr.save(3, params=net, trainer=tr,
                          iterator={"epoch": 0, "batch": 3})
        save_s = time.perf_counter() - t0
        for b in batches[3:]:
            tr.step(*b)
        ticket.wait()
        want = block_weights_to_numpy(net)
        want_t = int(tr._t.item())
        net2, tr2 = build(7)
        t0 = time.perf_counter()
        manifest = mgr.restore(params=net2, trainer=tr2)
        restore_s = time.perf_counter() - t0
        for b in batches[3:]:
            tr2.step(*b)
        got = block_weights_to_numpy(net2)
        same = {k: bool(np.array_equal(got[k], want[k])) for k in want}
        mgr.save(5, params=net, trainer=tr, sync=True)
        os.remove(os.path.join(root, "ckpt-00000005", "manifest.json"))
        latest = mgr.latest()
        launches = read_launches("dp checkpoint", {"fused_adam_update": 7})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"dp checkpoint (Dense/BatchNorm net, adam, DataParallelTrainer "
          f"on the card): saved at step {manifest['step']} (cursor "
          f"{manifest['iterator']}, {len(manifest['files'])} files, save "
          f"call {save_s * 1e3:.1f} ms, restore {restore_s * 1e3:.1f} ms); "
          f"after 2 more steps the restored run's {len(same)} parameters "
          f"bitwise the first run's: {sum(same.values())} of {len(same)}; "
          f"Adam's step {int(tr2._t.item())} (first run {want_t}); captures "
          f"{tr.stats['captures']} and {tr2.stats['captures']}; with "
          f"step 5 torn latest() = {latest}; launches {launches}",
          flush=True)
    if not all(same.values()) or int(tr2._t.item()) != want_t:
        fail(f"dp checkpoint: the restored run differs: "
             f"{[k for k, v in same.items() if not v]}")
    if latest != 3:
        fail(f"dp checkpoint: latest() gave {latest} with step 5 torn")
    del net, tr, net2, tr2
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dp_training(dev, card, model):
    """Phases 17 (``model="resnet"``) and 18 (``"bert"``): ``bench.py``'s
    ``_bench_resnet`` and ``_bench_bert`` through the entry point they
    use, ``DataParallelTrainer`` on ``make_mesh({"dp": 1})``, bf16 AMP:
    ``resnet50_v1(s2d_stem=True)``, batch 128 x 3 x 224 x 224 from
    ``nd.random.uniform`` seeded 0, labels zeros, SGD lr 0.1 momentum
    0.9; or BERT-base (vocab 30522, max_length 128, dropout 0, flash, no
    decoder), batch 64 x 128 from ``RandomState(0)``, the loss on the
    sentence head, Adam lr 1e-4.  3 warm-up steps (the first eager, the
    second captured), then 20 timed (host clock around each, ending in a
    synchronize).  Fails unless every timed step was one replay of the
    one graph, the loss is finite and lower at the last step than at the
    first, and the kernels ran as the path says (K1 once a step; or K2
    once and 12 bf16 K3 forward and backward).  Prints the step median,
    images or samples per second, peak memory, captures, capture seconds
    and the graph pool's bytes; the replay's device time (CUDA events
    around ``graph.replay()``, 5 replays after the run) and the host share
    ``1 - device / wall``; and from two profiled steps the device time by
    kernel class."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, gluon, ops, parallel
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    amp.init("bfloat16")
    try:
        t0 = time.perf_counter()
        mx.random.seed(0)
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        mesh = parallel.make_mesh({"dp": 1}, devices=[dev])
        if model == "resnet":
            from mxnet_tpu_torch.gluon.model_zoo import vision
            net = vision.resnet50_v1(s2d_stem=True)
            net.initialize()
            trainer = parallel.DataParallelTrainer(
                net, ce, "sgd", {"learning_rate": RESNET_LR,
                                 "momentum": RESNET_MOMENTUM}, mesh=mesh)
            batch = (mx.nd.random.uniform(shape=(RESNET_BATCH, 3,
                                                 RESNET_SIZE, RESNET_SIZE)),
                     mx.nd.zeros((RESNET_BATCH,)))
            n, unit, classes = RESNET_BATCH, "images", RESNET_CLASSES
            want = {"fused_sgd_update": DP_TIMED}
            label = (f"dp resnet, ResNet-50 v1 (s2d stem), bf16 amp, sgd lr "
                     f"{RESNET_LR} momentum {RESNET_MOMENTUM}, batch "
                     f"{RESNET_BATCH}x3x{RESNET_SIZE}x{RESNET_SIZE}")
        else:
            from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model
            net = get_bert_model(vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
                                 dropout=0.0, use_flash=True,
                                 use_decoder=False)
            net.initialize()

            def loss_fn(out, label):
                return ce(out[-1], label)

            trainer = parallel.DataParallelTrainer(
                net, loss_fn, "adam", {"learning_rate": 1e-4}, mesh=mesh)
            rng = np.random.RandomState(0)
            batch = (mx.nd.array(rng.randint(0, BERT_VOCAB,
                                             size=(BERT_BATCH, BERT_SEQ)),
                                 dtype="int32"),
                     mx.nd.zeros((BERT_BATCH, BERT_SEQ), dtype="int32"),
                     mx.nd.array(rng.randint(0, 2, size=(BERT_BATCH,)),
                                 dtype="int32"))
            n, unit, classes = BERT_BATCH, "samples", BUSY_CLASSES
            want = {name: 12 * DP_TIMED for name in (
                "flash_attention_fwd", "flash_attention_bwd",
                "flash_attention_fwd_bf16", "flash_attention_bwd_bf16")}
            want["fused_adam_update"] = DP_TIMED
            label = (f"dp bert, BERT-base (12 x 768, vocab {BERT_VOCAB}), "
                     f"bf16 amp, adam lr 1e-4, batch {BERT_BATCH}x{BERT_SEQ}")
        losses = [trainer.step(*batch) for _ in range(DP_WARMUP)]
        torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        params = net.collect_params()
        n_params = sum(p.data().size for p in params.values())
        n_trainable = sum(p.data().size for p in params.values()
                          if p.grad_req != "null")
        stats = {k: p for k, p in params.items()
                 if k.endswith(("running_mean", "running_var"))}
        stats0 = {k: p.data().asnumpy() for k, p in stats.items()}
        ops.reset_launches()
        step_s = []
        for _ in range(DP_TIMED):
            t = time.perf_counter()
            losses.append(trainer.step(*batch))
            torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t)
        launches = read_launches(label.split(",")[0], want)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        moved = sum(not np.array_equal(p.data().asnumpy(), stats0[k])
                    for k, p in stats.items())
        graph_stats = dict(trainer.stats)
        graphs, pool = trainer.graphs_captured(), trainer.graph_pool_bytes()
        entry = next(iter(trainer._graphs.values()))
        replay_s = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            entry.graph.replay()
            end.record()
            end.synchronize()
            replay_s.append(start.elapsed_time(end) / 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(2):
                trainer.step(*batch)
            torch.cuda.synchronize(dev)
            traced_ms = (time.perf_counter() - t) / 2 * 1e3
    finally:
        amp._deinit_for_tests()
    busy = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy[e.key] = busy.get(e.key, 0.0) + \
                e.self_device_time_total / 1e3 / 2
    busy_ms = sum(busy.values())
    by_class = {}
    for name, ms in busy.items():
        cls = next((c for c, keys in classes if any(
            k in name for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    losses = [float(x.asnumpy()) for x in losses]
    step_ms = statistics.median(step_s) * 1e3
    replay_ms = statistics.median(replay_s) * 1e3
    print(f"{label} through DataParallelTrainer (make_mesh dp=1) on {card}: "
          f"{n_params} params, {n_trainable} in the flat buffer; losses "
          f"{losses}; step median {step_ms:.2f} ms over {DP_TIMED} steps "
          f"after {DP_WARMUP} warm-up (min {min(step_s) * 1e3:.2f}, max "
          f"{max(step_s) * 1e3:.2f}) = {n / step_ms * 1e3:.1f} {unit}/s; "
          f"peak memory {peak_gb:.2f} GB; set-up and warm-up {setup_s:.2f} "
          f"s; {graph_stats['captures']} capture(s) in "
          f"{graph_stats['capture_seconds']:.2f} s, {graphs} graph(s), "
          f"graph pool {pool} bytes reserved, {graph_stats['eager_calls']} "
          f"eager call(s); replay device time median {replay_ms:.3f} ms "
          f"(range {min(replay_s) * 1e3:.3f}-{max(replay_s) * 1e3:.3f}; "
          f"CUDA events around graph.replay(), 5 replays), host share "
          f"{1 - replay_ms / step_ms:.4f} of the untraced step; profiler "
          f"busy {busy_ms:.3f} ms a step (2 steps, traced wall "
          f"{traced_ms:.2f} ms; host share by it "
          f"{1 - busy_ms / step_ms:.4f}); device ms a step by class "
          f"{ {k: round(v, 3) for k, v in by_class.items()} }; top kernels "
          f"{', '.join(f'{k[:60]} {v:.3f} ms' for k, v in top)}; "
          f"running statistics moved {moved} of {len(stats)}; launches "
          f"{launches}", flush=True)
    if graph_stats["captures"] != 1 or graphs != 1 or \
            graph_stats["eager_calls"] != 1:
        fail(f"{label}: expected one eager call and one capture, every "
             f"later step a replay: {graph_stats}")
    if not all(np.isfinite(losses)):
        fail(f"{label}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall: {losses}")
    if model == "resnet" and (n_trainable != RESNET_TRAINABLE or
                              moved != len(stats)):
        fail(f"{label}: {n_trainable} trainable parameters, statistics "
             f"moved {moved} of {len(stats)}")
    if model == "bert" and n_trainable != BERT_TRAINABLE:
        fail(f"{label}: {n_trainable} trainable parameters")
    del net, trainer, entry
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke runs on the card")
    if not os.path.isdir(os.path.join(REPO, "mxnet_tpu_torch")):
        fail("run from the root of a checkout (mxnet_tpu_torch/ missing)")
    sys.path.insert(0, REPO)
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.ops import _build

    # phase 1: device
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"device: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build every kernel of the paths
    t0 = time.perf_counter()
    _build.build(["flash_attention", "flash_attention_bwd",
                  "paged_attention", "fused_update", "fused_layernorm"])
    print(f"build: {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}",
          flush=True)
    flash_kernel_report()
    ptxas_report(["paged_attention", "fused_layernorm", "fused_update"])

    # phase 3: kernels against plain versions
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    checks = {"flash_attention_fwd": check_flash(dev, flush),
              "paged_decode_attention": check_paged(dev, flush),
              "paged_decode_attention_fp8": check_paged_fp8(dev, flush),
              "flash_attention_bwd": check_flash_bwd(dev, flush),
              "flash_attention_fwd_offset": check_flash_offset(dev, flush)}
    check_flash_bert(dev, flush)
    checks.update(check_layernorm(dev, flush))
    checks.update(check_updates(dev, flush, train_param_count()))
    # K1's and K2's rows in the kernels line: ResNet-50's and BERT-base's
    # buckets, lr (and t) read from memory, their full-width paths
    checks["fused_sgd_update"] = check_resnet_update(dev, flush)
    checks["fused_adam_update"] = check_bert_update(dev, flush)
    del flush
    torch.cuda.empty_cache()

    # phases 4-19: each path from zeroed launch counters
    by_path = {}
    by_path["serving"], net, bf16_ref = serve_llama3_8b(dev, card)
    # phases 21 and 22 on phase 4's net
    (by_path["serving_chunked_prefix"], by_path["serving_speculative"],
     by_path["serving_speculative_landing"], phase21) = \
        serve_prefix_and_spec(dev, card, net)
    # phases 24 and 25 on it: the router and disaggregated serving
    by_path["serving_router"] = serve_router(dev, card, net, phase21)
    by_path["serving_disagg"] = serve_disagg(dev, card, net, phase21)
    del phase21
    # phase 23 last on it: it quantizes the net in place
    by_path["serving_int8"] = serve_int8(dev, card, net, bf16_ref)
    del net, bf16_ref
    gc.collect()
    torch.cuda.empty_cache()
    # phases 5, 6 and 20
    by_path.update(card_vs_cpu(dev))
    by_path["serving_fp8"] = serve_llama3_8b_fp8(dev, card)
    by_path["training"], f32_first_loss = train_llama3_8b(dev, card)
    by_path["training_card_vs_cpu"] = train_card_vs_cpu(dev)
    by_path["layernorm_op"] = layernorm_path(dev, card)
    by_path["bert_card_vs_cpu"] = bert_card_vs_cpu(dev)
    by_path["resnet_card_vs_cpu"] = resnet_card_vs_cpu(dev)
    by_path["dp_card_vs_cpu"] = dp_card_vs_cpu(dev)
    by_path["dp_checkpoint"] = dp_checkpoint(dev)
    # phases 11, 13, 15, 17 and 18 last: amp.init() is process-wide
    by_path["training_amp"], _ = train_llama3_8b(
        dev, card, amp_dtype="bfloat16", f32_first_loss=f32_first_loss)
    by_path["bert_training"] = bert_training(dev, card)
    by_path["resnet_training"] = resnet_training(dev, card)
    by_path["dp_resnet"] = dp_training(dev, card, "resnet")
    by_path["dp_bert"] = dp_training(dev, card, "bert")

    kernels = []
    for name, src, tpu in (
            ("flash_attention_fwd", "flash_attention.cu",
             "mxnet_tpu/ops/flash_attention.py:51"),
            ("flash_attention_fwd_offset", "flash_attention.cu",
             "mxnet_tpu/serving/engine.py:844"),
            ("flash_attention_bwd", "flash_attention_bwd.cu",
             "mxnet_tpu/ops/flash_attention.py:174"),
            ("paged_decode_attention", "paged_attention.cu",
             "mxnet_tpu/ops/paged_attention.py:89"),
            ("paged_decode_attention_fp8", "paged_attention.cu",
             "mxnet_tpu/ops/paged_attention.py:89"),
            ("fused_sgd_update", "fused_update.cu",
             "mxnet_tpu/ops/fused_update.py:95"),
            ("fused_adam_update", "fused_update.cu",
             "mxnet_tpu/ops/fused_update.py:118"),
            ("fused_layer_norm_fwd", "fused_layernorm.cu",
             "mxnet_tpu/ops/fused_layernorm.py:79"),
            ("fused_layer_norm_bwd", "fused_layernorm.cu",
             "mxnet_tpu/ops/fused_layernorm.py:97")):
        res = checks[name]
        paths = {path: got[name] for path, got in by_path.items()
                 if got[name]}
        if not paths:
            fail(f"{name} ran on no path")
        entry = {"name": name, "route": "cuda",
                 "source": f"mxnet_tpu_torch/ops/csrc/{src}",
                 "replaces": tpu, "tpu_kernel": tpu,
                 "launches": sum(paths.values()),
                 "launches_by_path": paths}
        if f"{name}_bf16" in ops.SUBCOUNTS:      # K3's bf16 launches apart
            entry["launches_bf16_by_path"] = {
                path: got[f"{name}_bf16"] for path, got in by_path.items()
                if got[f"{name}_bf16"]}
        kernels.append(dict(entry, **{
            "max_abs_err": res["max_abs_err"],
            "max_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"]}))
    print(json.dumps({"kernel_rows": ROWS}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
