#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, in order; any failure exits non-zero and nothing is caught and
continued:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of the serving, training and LayerNorm
   paths from ``mxnet_tpu_torch/ops/csrc`` (one ``nvcc`` per source, in
   parallel), and beside them the native host runtime of ``src/`` (one
   ``g++``); print each flash kernel's registers, spill bytes (ptxas),
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
26b. ``generate`` on phase 4's net (Llama-3-8B bf16, after phase 25,
    before phase 23 quantizes it): batch 4, prefix 32, 32 new tokens,
    greedy: one CUDA graph for the signature, the replayed tokens equal
    the same step body run eagerly on the card; the agreement with phase
    4's engine streams for the same prompts is printed, not held (dense
    caches and the engine's paged K5 round bf16 differently); no kernel
    of the table runs;
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
    step (f32, non-causal, D = 64) and one K2; then the same again with
    both nets ``hybridize()``d, held to the same limits: on the card
    the first step runs eagerly and the second is the CachedOp's one
    capture, replayed (its counts printed);
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
26a. ``generate`` at ``bench.py``'s ``_bench_decode`` configuration,
    nothing cut (vocab 32000, hidden 1024, 8 layers, 16/8 heads,
    intermediate 2816, ``max_seq_len`` 512, f32, seeded weights): batch
    8, prefix 32, 96 new tokens, greedy, one first call then 3 timed
    (host clock ending in a synchronize): exactly one CUDA graph
    captured for the signature; capture time, tokens/s over all 128
    scanned positions, ms a step, host share (``1 - busy / wall``, one
    profiled call) and peak memory printed; a teacher-forced full
    forward over the generated tokens (K3, f32) must pick generate's
    token at every position whose top-2 margin exceeds ``GEN_MARGIN``
    (the smallest margin and the positions below it printed); at
    temperature 1.0 the same seed gives the same tokens twice through
    replays and some seed in {1, 2, 3} other tokens; 8 K3 launches;
27. the blocked cross-entropy at Llama-3-8B's head (d 4096, V 128256,
    N 8192 f32 activations, a bf16 head weight, block 2048, targets
    with 64 at ``ignore_index`` and 64 out of range):
    ``ops.fused_linear_cross_entropy`` against the materialized path
    (f32 logits, ``log_softmax``; 4.2 GB of logits), forward and
    backward: the loss and dx within ``CE_TOL`` of the largest
    magnitude, dW within one bf16 ulp of its largest; both paths' time
    and peak memory above the inputs, the blocked one below the
    materialized logits' bytes; then phase 8's model, batch and AdamW
    from the same seeded weights, 2 steps on ``fused_ce_loss(...).mean()``
    and 2 on ``SoftmaxCrossEntropyLoss`` of the logits: losses within
    1e-4 relative and each parameter's update within 1e-3
    (``update_errs``, as in phases 12, 14 and 16), both peaks printed;
    16 K3 forward and backward launches and 4 K2;
28. the Transformer and the samplers: card against CPU at 2 + 2 layers
    and 64 units (vocab 1000, 4 heads, weights carried by
    ``load_block_weights``): logits within 1e-4, one Adam step's
    updates within 1e-3 (``update_errs``), and ``BeamSearchSampler``
    (beam 4, 4 sources, ``max_length`` 16) samples and lengths
    identical, scores within 1e-4 (the smallest top-k margin printed);
    then ``transformer_en_de_512`` at full width (6 + 6 layers, 512
    units, 2048 hidden, 8 heads, vocab 36794, f32, dropout 0.1) through
    the MXNet loop with Adam: 64 x 64 source and target tokens, varied
    ``src_valid_length``, 3 warm-up and 10 timed steps; step median,
    target tokens/s, peak memory, and from two profiled steps the host
    share and device time by class; one K2 a step, and the CachedOp
    replaying every timed step, as in phase 13; then beam search on
    it (beam 4, 8 sources, ``max_length`` 32, a step that re-decodes the
    prefix): ms a step, and every returned score within 1e-4 of the
    GNMT-penalized sum of the model's own log-probs along its tokens;
30a. (after phase 28) phase 30's f32 check: BERT-base at ``bench.py``'s
    configuration in f32, two nets of the same weights, two steps on one
    batch of 64 x 128: ``DataParallelTrainer`` with LAMB (lr 1e-3, wd
    0.01; its second step captured and replayed, the norms per parameter
    of the flat bucket) against ``gluon.Trainer(..., "lamb")`` in the
    MXNet loop on the batch's mean loss (the rule per parameter): step
    1's gradients of both paths compared first (those apart by more
    than 1e-4 relative are rounding-dominated); losses within 1e-4
    relative, each other parameter's update within 1e-3
    (``update_errs``), each rounding-dominated one's update norm a step
    within 1e-3 (LAMB's step is lr |w| long whatever its direction), the
    key biases within two LAMB steps on noise; 48 K3 f32 forward and
    backward launches;
32. the training surface at small sizes, card against CPU: each
    optimizer (3 updates, 3 parameters, with wd, clip, rescale and an
    ``lr_mult``; weights and states), each loss, optimizer and density
    op (outputs, in-place state writes, the loss ops' gradients under a
    random head) and each Gluon loss (value and gradient, with
    ``weight`` and ``sample_weight``) within 1e-5 relative (CTC 1e-4);
    SGLD, the ``nd.random`` samplers and the ``sample_*`` ops over 10^6
    draws on the card within 5 standard errors of their distributions'
    mean and variance; then every op name of the registry's tail and
    every ``nd.linalg`` function (``_surface_tail_cases``: outputs and
    a held gradient within 1e-5 relative, the transcendental ops and
    the factorizations within 1e-4); no kernel of the port runs;
33. the op library at full width, card against the port's CPU result
    on the same inputs, each line with the card's median time over 5
    calls: ``topk(k=50, ret_typ="both")``, ``sort`` and ``argsort`` on
    (8, 128256) bf16-valued f32 logits (exactly the CPU's, and numpy's
    stable order); BERT-base's ``masked_softmax`` with its gradient at
    (64, 12, 128, 128); ``SequenceMask``/``Last``/``Reverse`` at (128,
    64, 1024) (exact); ResNet-50's stem through ``im2col`` (exact;
    columns times the weight against ``Convolution``, ``col2im`` its
    adjoint); ``GridGenerator`` and ``BilinearSampler`` with gradients
    at (32, 3, 224, 224); FlowNetC's ``Correlation`` at (8, 256, 48,
    64); AlexNet's ``LRN`` at (32, 96, 55, 55): within 1e-5 relative;
    ``linalg`` ``potrf``, ``potri``, ``trsm``, ``syrk``, ``inverse``,
    ``slogdet``, ``gelqf`` and ``syevd`` on (64, 256, 256) f32 within
    1e-4 (factors up to sign, reconstructions on the card); its wall
    time printed; no kernel of the port runs;
34. quantized training (``ops.quant_matmul``, ``Dense(compute_dtype=)``):
    (a) BERT-base's Dense products at ``bench.py``'s batch, (8192, 768) x
    (768, 3072), (8192, 3072) x (3072, 768), the pooler's (64, 768, 768)
    and the classifier's N = 2, int8 and fp8, the forward and both
    gradients against the plain version on the card with the same
    draws: int8 bitwise, fp8 within 1e-3 of the norm; each product's
    time beside ``torch.matmul``'s bf16 one; (c) a narrow BERT in f32
    with every Dense in fp8, two SGD steps on the card against the
    port on the CPU (mean losses within 5e-2, the updates of all
    parameters together within 0.25 of their norm: the card's e4m3 sums
    differ by 1.3e-4 and each layer requantizes its input,
    ``tools/port_fp8_accum_noise.py``); and, last of all (it runs under ``amp.init``), (b)
    BERT-base through ``DataParallelTrainer`` at phase 18's
    configuration with every Dense in fp8, then in int8: 3 warm-up and
    20 timed steps, each one replay, the loss finite and falling, K2
    once and K3's f32 forward and backward 12 times a step (the
    quantized products' f32 results feed the attention); the step
    median, samples/s, peak memory and host share beside phase 18's;
35. row-sparse gradients at full width: Llama-3-8B's embedding (128256
    x 4096 f32) with ``sparse_grad=True`` trained through
    ``gluon.Trainer`` with lazy SGD and lazy Adam on 8 x 1024 ids (with
    repeats): untouched rows bitwise unchanged in the weight and both
    moments, touched rows within 1e-5 of the dense formula on the card;
    step time and the backward's peak memory beside a
    ``sparse_grad=False`` step; ``sparse.dot`` of an 8192 x 128256 CSR
    (32 stored a row) with the same matrix against the dense product of
    the densified CSR, both timed; no kernel of the port runs;
36. the contrib ops at detection widths (SSD 300 ResNet-34's anchors,
    targets at batch 32 with 21 classes, detections and ``box_nms`` at
    ``nms_topk=400``; R-CNN's ``Proposal``/``MultiProposal`` at
    ``rcnn.py``'s defaults on a 600 x 1000 image, ``ROIAlign`` and
    ``ROIPooling`` with 300 RoIs on 1024 channels;
    ``DeformableConvolution`` and ``BilinearResize2D`` at a ResNet-50
    stage), card against the port on the CPU (exact where the op is,
    else within 1e-5), each op's card time, and a CUDA graph capture of
    each: only ``boolean_mask`` and ``edge_id`` refuse, and they must;
    no kernel of the port runs;
37. MXNet's Gluon training loop fed by ``gluon.data``: ResNet-50 v1 at
    full width in f32, hybridized, over an ``ArrayDataset`` of 1024
    seeded uint8 224 x 224 images through ``RandomFlipLeftRight``,
    ``ToTensor`` and ``Normalize``, a ``DataLoader`` (batch 64, 4
    thread workers, ``pin_memory``), ``split_and_load``,
    ``clip_global_norm`` to 1.0, ``Trainer("sgd")`` with momentum,
    ``metric.Accuracy`` and ``callback.Speedometer``: one epoch of 16
    steps (two warm-up, two traced); every loss finite, K1 once a step,
    the clip's norm against a float64 plain norm, K1's update against
    the plain momentum rule on the clipped gradients; before it the
    loader's batches bitwise across workers and contexts and through
    ``prefetch_to_device=True``, the numpy-body
    ``Custom`` softmax against ``nd.softmax`` and
    ``test_utils.check_consistency`` over ``[cpu(0), gpu(0)]``;
    samples/s (CUDA events, beside ``Speedometer``'s), the wait share in
    ``next(loader)``, device busy against wall, peak memory;
40. (after phase 37) the fused RNN layers at AWD-LSTM's WikiText-2
    geometry (T 70, B 80, input 400): a 3-layer LSTM and GRU of hidden
    1150 and a bidirectional 2-layer LSTM of hidden 512, hybridized, the
    third call (a replay of the captured forward and backward) against
    one CPU call: outputs and states within 1e-4, every gradient within
    1e-3 of its norm, ``nd.RNN`` over the packed vector on the card;
    each replayed forward and backward timed beside ``torch.nn.LSTM``/
    ``GRU`` (cuDNN) on the same weights; no kernel of the port;
41. ``awd_lstm_lm_1150`` (vocabulary 33,278) hybridized through the
    Gluon loop at GluonNLP's WikiText-2 recipe (batch 80 x bptt 70, SGD
    lr 30, ``clip_global_norm`` 0.25): the first step's loss and
    gradients on the first 8 sequences in predict mode against the CPU,
    then 10 steps with dropout: step ms, tokens/s, host share, captures,
    K1 once a step;
42. one classifier of each family (``alexnet``, ``vgg16_bn``,
    ``squeezenet1_1``, ``densenet121``, ``inception_v3`` at 299,
    ``mobilenet1_0``, ``mobilenet_v2_1_0``, ``resnext50_32x4d``,
    ``se_resnet50``, ``resnest50``) at full width, predict mode at batch
    2, hybridized, against the CPU; then ``mobilenet_v2_1_0`` trains at
    224, batch 64, f32 through the Gluon loop (its first step against
    the CPU on cuDNN's deterministic algorithms): step ms, images/s,
    host share, peak memory, K1 once a step;
43. ``ssd_300_resnet34_v1`` at batch 8 x 300 x 300, hybridized: its
    class and box predictions against the CPU, ``MultiBoxDetection``
    (``box_nms`` inside) on the card against the CPU's over the same
    inputs with the tie rule at the NMS threshold, end-to-end matched
    detections, the inference call's ms and whether it captured, the
    CUDA launches of one ``box_nms`` call and of its suppression sweep;
    one training step (``MultiBoxTarget``, softmax cross-entropy plus L1
    box loss, SGD, K1) against the CPU;
44. ``yolo3_darknet53`` (80 classes, COCO anchors) at batch 8 x 416 x
    416, hybridized: inference captured, its raw maps against the CPU,
    ``box_nms`` (top 400 of 10,647 boxes) on the card against the CPU's
    over the same inputs with phase 43's tie rule, end-to-end matched
    detections (every unmatched row a tie), the call's ms and
    ``box_nms``'s launches; one training step (a test loss over the
    three raw maps: sigmoid cross-entropy on objectness and classes, L2
    on the box channels, against seeded targets; SGD lr 1e-3, momentum
    0.9, wd 5e-4, K1) against the CPU by phase 43's rule (the loss, all
    gradients together and the whole update, each gradient and update
    within 1e-3 plus twice what one ulp of input moved its own; a
    parameter past that held against float64 at the card's kinks), then
    timed steps: step ms, images/s, host share, peak memory;
45. ``faster_rcnn_resnet50_v1b`` (20 classes) at batch 1 x 600 x 800
    (17,100 anchors, ``pre_nms`` 2000, ``post_nms`` 300), hybridized:
    whether the inference call captures, its ms, the RPN sweep's CUDA
    launches and ROIAlign's device ms; the 300 rois against the CPU's
    under the tie rule, the detections end to end (every unmatched row a
    tie); one training step
    (softmax cross-entropy and L1 on the box head, sigmoid
    cross-entropy and L1 on the RPN, seeded targets; SGD lr 1e-3,
    momentum 0.9, wd 5e-4, K1) against the CPU, then timed steps;
46. segmentation over a dilated ResNet-50 v1b (21 classes, crop 480):
    ``get_fcn``, ``get_psp`` and ``get_deeplab`` in predict mode at batch
    2, hybridized, against the CPU; FCN with ``aux`` at batch 4 (per-pixel
    softmax cross-entropy on both outputs, SGD lr 1e-3, momentum 0.9, wd
    1e-4, K1): one step against the CPU with the heads' Dropouts at rate
    0, then timed steps at their own rates: step ms, images/s, peak
    memory and the device time of layer 4's dilated blocks;
47. ``simple_pose_resnet50_v1b`` (17 joints) at batch 32 x 256 x 192:
    one Adam step (lr 1e-3, ``L2Loss`` on the heatmaps against seeded
    targets, K2) against the CPU, then timed steps: step ms, images/s,
    peak memory; ``heatmap_to_coord`` on the card against the CPU;
11. bf16 AMP training (``amp.init`` is process-wide, so phases 11, 13,
    29, 15, 17 and 18 come last, in that order): phase 8's model, batch and AdamW under
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
    time by kernel and the step's host share; the CachedOp must have
    captured and every timed step must replay (``captures``, capture
    seconds, ``replays``, eager calls and graph pool bytes printed);
29. the Gluon loop captured against the same loop eager: two BERT-base
    nets at phase 13's configuration with the same weights (copied on
    the card), one ``hybridize()``d and one ``hybridize(active=False)``,
    a Trainer each, 8 steps in turns on the same new batches, on torch's
    deterministic algorithms (the embeddings' backward adds with atomics
    otherwise): each step's loss within 1e-4 relative (bitwise printed),
    12 + 12 K3 and
    one K2 a step a net; for both the step median after the first two
    steps, the host share from two profiled steps, the peak memory of a
    step above its start, and the captured net's CachedOp counts and
    graph pool bytes;
16. card vs CPU, ``parallel.DataParallelTrainer`` (the reference's
    training entry point, on ``make_mesh({"dp": 1})``): a small conv net
    with BatchNorm (SGD momentum) and a 2-layer BERT at BERT-base width
    (Adam), f32, 3 steps, then ``set_learning_rate`` and a 4th: losses
    within 1e-4 relative and each parameter's update within 1e-3, card
    (one CUDA graph replay a step after the first) against CPU; the
    replays against the same body run eagerly on the card within 1e-5
    (bitwise printed); ``step_indexed`` over ``put_epoch`` against
    ``step`` on the same slices, ``step_accum(n_micro=2)`` against
    ``step`` on the whole batch; the BERT with LAMB and the conv net
    with LARS and RMSProp (plain and centered) the same way; K1 12, K2
    12, K3 64 and 64 launches;
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
    share; the CachedOp must replay every timed step, as in phase 13;
17. ResNet-50 v1 through ``DataParallelTrainer``, ``bench.py``'s
    ``_bench_resnet`` with nothing cut (``resnet50_v1(s2d_stem=True)``,
    bf16 AMP, batch 128 from ``nd.random.uniform``, zero labels, SGD lr
    0.1 momentum 0.9): 3 warm-up steps (the first eager, the second
    captured), 20 timed, each one graph replay with one K1 launch; step
    median, images/s, peak memory, captures, capture seconds, graph pool
    bytes, the replay's device time (CUDA events) and host share, and
    the device time by class from two profiled steps;
38. (after phase 17) ``bench.py``'s ``.rec``-fed ResNet-50 pipeline: a
    1,024-record ``.rec`` of the fixture's eight 500 x 375 JPEGs written
    through ``recordio``, ``io.ImageRecordIter`` (batch 128, 224 x 224,
    shuffle, ``rand_mirror``, ImageNet's mean and std, one decode thread
    a core) on the native path (``src/``'s C++ pool, built by g++ in
    phase 2), ``io.DevicePrefetcher(depth=2)`` and phase 17's
    ``DataParallelTrainer`` step under bf16 AMP: two epochs, 16 steps,
    K1 once a step; the batches through the prefetcher, without it and
    on the host bitwise; three prefetched steps' losses against the same
    batches fed directly; a ``torch.profiler`` trace of three steps run
    from the backlog (the queue full and one batch more copied) showing
    the next batch's H2D copy on the prefetcher's stream overlapping the
    step's kernels; the fixture's decode digest against the CPU tests'
    host; images/s fed beside phase 17's, the decode rates alone, the
    stages a batch, the wait share, the device's idle share and peak
    memory;
39. (after phase 38) data parallelism over more than one rank: 39a,
    NCCL at one rank in this process (``parallel.distributed_init``
    through a ``file://`` store under the build directory): the bucket
    collectives over ResNet-50's 25,575,912-element bucket captured in
    one CUDA graph, bitwise the eager results, and a ``dist_tpu_sync``
    ``pushpull`` of ResNet-50's gradients in 25 MiB buckets (ms, GB/s);
    39b, two spawned processes sharing the card over gloo (``chip_smoke.py
    --dp-rank``; eager steps), phase 16's conv net on the psum path and
    under ZeRO-1 (one bucket, and a narrower net over three buckets two
    of which are padded), card against the same dp = 2 steps on the CPU
    within phase 16's limits, the ranks bitwise equal; 39c, ``bench.py``'s dp
    configuration at full width (ResNet-50 v1 s2d, 2 ranks x 64 images,
    bf16 AMP, SGD, ZeRO-1) on the two processes: step, images/s of the
    two ranks sharing one card (no scaling figure), ``comm_stats``, K1
    once a step a rank on its shard and its device time against its
    bound, each process's peak memory, beside phase 17's dp = 1 figures.
    A rank that fails, finds no card or times out fails the phase;
18. BERT-base through ``DataParallelTrainer`` at ``bench.py``'s
    ``_bench_bert`` (bf16 AMP, batch 64 x 128 from ``RandomState(0)``,
    Adam lr 1e-4): as phase 17, with one K2 and 12 bf16 K3 forward and
    backward launches a replay;
30. BERT-base with LAMB through ``DataParallelTrainer``: phase 18 with
    ``"lamb", {"learning_rate": 1e-3, "wd": 0.01}`` at the reference's
    other defaults, nothing cut: 12 bf16 K3 forward and backward
    launches a replay and no K1/K2 (the rule is plain PyTorch over the
    flat bucket);
31. ResNet-50 v1 with LARS through ``DataParallelTrainer``: phase 17
    with ``"lars", {"learning_rate": 0.1, "momentum": 0.9, "wd": 5e-5}``
    at the reference's ``eta`` and ``eps``: no kernel of the port.
    Phases 17, 18, 30 and 31 also print the update's device time alone
    (its rule over clones of the flat buffers, one captured graph, 10
    replays) beside its bytes bound.

Phases 4 and 7 also print, from a pass after the timed run (so the
run's steps are measured as they run without it) that replays each
decode step on its own staged inputs, the replays' device time (CUDA
events around ``graph.replay()``) and each step's host share beside
it.  Before
each of phases 4, 7-19 and 20-47 the kernels' launch counters are set to 0
(in each spawned rank of 39b and 39c, whose counts are summed); each phase reads them just after and fails unless its kernels
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
    other kernel not at all (``want`` empty: a path of no kernel)."""
    from mxnet_tpu_torch import ops
    got = ops.launch_counts() if got is None else got
    full = {name: want.get(name, 0) for name in got}
    if got != full or min(want.values(), default=1) < 1:
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
    # phase 26b's: the engine's greedy streams for its prompts
    ref["gen_streams"] = [
        _greedy(eng, f"generate-{i}", p.tolist(), GEN8B["new"] - 1)[0]
        [GEN8B["prefix"]:] for i, p in enumerate(
            gen8b_prompts(net.cfg.vocab_size))]
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


def cached_stats(net, label):
    """The hybridized ``net``'s CachedOp counts (``captures``,
    ``capture_seconds``, ``replays``, ``eager_calls``) and
    ``graph_pool_bytes``; fails when the net made no CachedOp."""
    op = net._cached_op
    if op is None:
        fail(f"{label}: the hybridized net made no CachedOp")
    return dict(op.stats, graph_pool_bytes=op.graph_pool_bytes())


def check_replays(label, before, after, steps):
    """Fails unless the CachedOp captured, and every one of ``steps``
    calls between ``before`` and ``after`` (``cached_stats``) replayed
    and none ran eagerly."""
    if not after["captures"] > 0 or \
            after["replays"] - before["replays"] != steps or \
            after["eager_calls"] != before["eager_calls"]:
        fail(f"{label}: the CachedOp did not replay every timed step: "
             f"before {before}, after {after}")


def bert_card_vs_cpu(dev, hybridize=False):
    """Phase 12: ``get_bert_model(num_layers=2)`` at BERT-base width
    (768 units, 12 heads, FFN 3072, vocab 30522, max_length 128), dropout
    0, ``use_flash=True``, no decoder, f32; the same weights (initialized
    on the card from a seed, carried by ``convert``) train two Adam steps
    (lr 1e-4) on batch 2 x 128 through ``autograd.record`` and
    ``Trainer(net.collect_params(), "adam")`` on the card and on the
    host: losses within 1e-4 relative, each parameter's update within
    1e-3 relative (``BERT_UPDATE_RTOL``; the key biases within Adam's
    bound); on the card 2 K3 forward and 2 backward launches a step, all
    f32, and one K2.  With ``hybridize`` both nets are hybridized: on the
    card the first step runs eagerly and the second is captured (the
    Trainer's first step moved the parameters) and replayed."""
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
        if hybridize:
            net.hybridize()
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
            stats = cached_stats(net, "bert card vs cpu") if hybridize \
                else None
            if hybridize and (stats["captures"], stats["replays"],
                              stats["eager_calls"]) != (1, 1, 1):
                fail(f"bert card vs cpu, hybridized: expected one eager "
                     f"step, then one capture replayed: {stats}")
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
    print(f"bert card vs cpu{', hybridized' if hybridize else ''} (2 "
          f"layers at BERT-base width, vocab "
          f"{BERT_VOCAB}, f32, flash non-causal D=64, 2 adam steps on 2 x "
          f"{BERT_SEQ} tokens): losses card {runs[0][0]} cpu {runs[1][0]}, "
          f"max relative loss diff {loss_err:.3e} (limit {TRAIN_LOSS_RTOL}),"
          f" worst relative update diff {upd_err:.3e} (limit "
          f"{BERT_UPDATE_RTOL}) over every parameter but the key biases, "
          f"which differ by {noise_err:.3e} (limit {BERT_KEY_BIAS_ATOL}); "
          f"max |param| diffs {worst}; launches {launches}"
          + (f"; CachedOp on the card {stats}" if hybridize else ""),
          flush=True)
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
        cached0 = cached_stats(net, "bert training")
        step_s = []
        for _ in range(BERT_STEPS):
            t = time.perf_counter()
            losses.append(step().mean())
            torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t)
        cached = cached_stats(net, "bert training")
        check_replays("bert training", cached0, cached, BERT_STEPS)
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
          f"{launches}; CachedOp {cached}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"bert training: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"bert training: the loss did not fall: {losses}")
    del net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# phase 29: the same loop captured (hybridize()) and eager
# (hybridize(active=False)), in turns on the same batches, on torch's
# deterministic algorithms: the embeddings' backward otherwise adds with
# atomics, in another order each run (5.9e-7 of the token-type table's
# gradient between two nets, tools/port_cached_op_pairs.py --parity),
# and Adam turns that noise on near-zero gradients into steps of ~lr
PAIR_STEPS, PAIR_PROFILED = 8, 2
PAIR_LOSS_RTOL = 1e-4        # per step, captured against eager


def bert_captured_vs_eager(dev, card):
    """Phase 29: two BERT-base nets at phase 13's configuration (bf16
    AMP, Adam lr 1e-4 with ``amp.init_trainer``, batch 64 x 128), the
    second given the first's weights on the card; the first
    ``hybridize()``d, the second ``hybridize(active=False)``; a Trainer
    each.  ``PAIR_STEPS`` steps in turns on the same batches (a new batch
    a step): each step's loss within 1e-4 relative of the other net's
    (bitwise printed), exactly 12 K3 forward and backward launches and
    one K2 a step a net, on torch's deterministic algorithms (warnings
    only: each eager call of an op without a deterministic kernel warns,
    which the replays do not; ``tools/port_cached_op_pairs.py`` times
    both loops without it), one capture and every step from the second
    a replay.  Prints for both: the step median over the
    steps after the first two (host clock, ending in a synchronize), the
    host share from two profiled steps, the peak memory of a step above
    what was allocated before it, the CachedOp's captures, capture
    seconds, replays and graph pool bytes."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, gluon, ops
    from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model
    torch.cuda.empty_cache()
    amp.init("bfloat16")
    import torch.utils.deterministic as det
    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False     # no fill kernels in the steps
    try:
        rng = np.random.RandomState(29)
        batches = [(mx.nd.array(rng.randint(0, BERT_VOCAB,
                                            (BERT_BATCH, BERT_SEQ)),
                                dtype="int32"),
                    mx.nd.array(rng.randint(0, 2, (BERT_BATCH, BERT_SEQ)),
                                dtype="int32"),
                    mx.nd.array(rng.randint(0, 2, (BERT_BATCH,)),
                                dtype="int32"))
                   for _ in range(PAIR_STEPS + PAIR_PROFILED)]
        nets, trainers = [], []
        for active in (True, False):
            mx.random.seed(0)
            net = get_bert_model(vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
                                 dropout=0.0, use_flash=True,
                                 use_decoder=False)
            net.initialize()
            net.hybridize(active=active)
            net(*batches[0][:2])            # the deferred shapes resolve
            nets.append(net)
        copy_weights(nets[0], nets[1])
        for net in nets:
            trainer = gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 1e-4})
            amp.init_trainer(trainer)
            trainers.append(trainer)
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        losses, step_s, peak = [[], []], [[], []], [0, 0]
        torch.cuda.synchronize(dev)
        ops.reset_launches()
        for data, types, label in batches[:PAIR_STEPS]:
            for j in (0, 1):
                torch.cuda.synchronize(dev)
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                t = time.perf_counter()
                loss = _bert_step(nets[j], ce, trainers[j], amp, data,
                                  types, label, BERT_BATCH).mean()
                torch.cuda.synchronize(dev)
                step_s[j].append(time.perf_counter() - t)
                peak[j] = max(peak[j],
                              torch.cuda.max_memory_allocated(dev) - base)
                losses[j].append(float(loss.asscalar()))
        launches = read_launches("bert captured vs eager", {
            "flash_attention_fwd": 24 * PAIR_STEPS,
            "flash_attention_bwd": 24 * PAIR_STEPS,
            "flash_attention_fwd_bf16": 24 * PAIR_STEPS,
            "flash_attention_bwd_bf16": 24 * PAIR_STEPS,
            "fused_adam_update": 2 * PAIR_STEPS})
        stats = cached_stats(nets[0], "bert captured vs eager")
        busy, traced = [], []
        for j in (0, 1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for data, types, label in batches[PAIR_STEPS:]:
                    _bert_step(nets[j], ce, trainers[j], amp, data, types,
                               label, BERT_BATCH)
                torch.cuda.synchronize(dev)
                traced.append((time.perf_counter() - t) / PAIR_PROFILED
                              * 1e3)
            busy.append(busy_by_class(prof, PAIR_PROFILED))
        pool_gb = stats["graph_pool_bytes"] / 1e9
    finally:
        torch.use_deterministic_algorithms(deterministic[0])
        det.fill_uninitialized_memory = deterministic[1]
        amp._deinit_for_tests()
    errs = [abs(a - b) / abs(b) for a, b in zip(*losses)]
    bitwise = losses[0] == losses[1]
    step_ms = [statistics.median(s[2:]) * 1e3 for s in step_s]
    lines = []
    for j, name in enumerate(("captured", "eager")):
        lines.append(
            f"{name}: step median {step_ms[j]:.2f} ms (min "
            f"{min(step_s[j][2:]) * 1e3:.2f}, max "
            f"{max(step_s[j][2:]) * 1e3:.2f}; first two "
            f"{[round(x * 1e3, 1) for x in step_s[j][:2]]}), device busy "
            f"{busy[j][0]:.3f} ms a step (profiler, traced wall "
            f"{traced[j]:.2f} ms), host share "
            f"{1 - busy[j][0] / step_ms[j]:.4f}, peak memory of a step "
            f"{peak[j] / 1e9:.2f} GB above its start, device ms by class "
            f"{busy[j][1]}")
    print(f"bert captured vs eager, BERT-base at phase 13's configuration "
          f"(bf16 amp, adam, batch {BERT_BATCH}x{BERT_SEQ}, deterministic "
          f"algorithms), {PAIR_STEPS} "
          f"steps in turns on {card}: losses captured {losses[0]} eager "
          f"{losses[1]}, max relative diff {max(errs):.3e} (limit "
          f"{PAIR_LOSS_RTOL}), bitwise {bitwise}; "
          + "; ".join(lines) + f"; CachedOp {stats} (graph pool "
          f"{pool_gb:.2f} GB); launches {launches}", flush=True)
    if not max(errs) <= PAIR_LOSS_RTOL:
        fail(f"bert captured vs eager: losses differ by {max(errs):.3e}")
    # the shape probe and step 1 eager, step 2 captured (the Trainer's
    # first step moved the parameters), every step from 2 a replay
    if (stats["captures"], stats["eager_calls"], stats["replays"]) != \
            (1, 2, PAIR_STEPS - 1):
        fail(f"bert captured vs eager: the hybridized net did not replay "
             f"its steps: {stats}")
    del nets, trainers
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
# its Dense layers: 4 attention projections and 2 FFN a layer, the
# pooler and the classifier
BERT_DENSE = 12 * 6 + 2


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
        cached0 = cached_stats(net, "resnet training")
        step_s = []
        for _ in range(RESNET_STEPS):
            t = time.perf_counter()
            loss, out = step()
            losses.append(loss.mean())
            torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t)
        cached = cached_stats(net, "resnet training")
        check_replays("resnet training", cached0, cached, RESNET_STEPS)
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
          f"launches {launches}; CachedOp {cached}", flush=True)
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


def _dp_conv_net(nn, width=16, classes=10):
    """Phase 16's small conv net: two 3x3 convs (no bias: each feeds a
    BatchNorm; the first ``width`` channels wide) with BatchNorm and
    ReLU, global pooling, a ``classes``-way head."""
    net = nn.HybridSequential(prefix="dpconv_")
    with net.name_scope():
        net.add(nn.Conv2D(width, 3, padding=1, in_channels=3,
                          use_bias=False),
                nn.BatchNorm(in_channels=width), nn.Activation("relu"),
                nn.Conv2D(32, 3, strides=2, padding=1, in_channels=width,
                          use_bias=False),
                nn.BatchNorm(in_channels=32), nn.Activation("relu"),
                nn.GlobalAvgPool2D(), nn.Flatten(),
                nn.Dense(classes, in_units=32))
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
    flash, no decoder; Adam lr 1e-4, batch 4 x 128); then the rules
    without a bucket kernel: the BERT with LAMB (lr 1e-4, wd 0.01), the
    conv net with LARS (momentum 0.9, wd 5e-5) and with RMSProp (lr
    1e-3), plain and centered.  Each takes 3 steps,
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
                     init=mx.init.Xavier(magnitude=2), kind="conv"),
        "bert": dict(net=lambda: get_bert_model(
            num_layers=2, vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
            dropout=0.0, use_flash=True, use_decoder=False), rule="adam",
            params={"learning_rate": 1e-4}, loss=bert_loss,
            batches=bert_batches, noise="proj_key.bias", init=None,
            kind="bert")}
    # the rules without a bucket kernel (plain PyTorch in the captured
    # step; LAMB's and LARS's norms per parameter of the flat bucket)
    cases.update({
        "bert lamb": dict(cases["bert"], rule="lamb",
                          params={"learning_rate": 1e-4, "wd": 0.01}),
        "conv lars": dict(cases["conv"], rule="lars",
                          params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 5e-5}),
        "conv rmsprop": dict(cases["conv"], rule="rmsprop",
                             params={"learning_rate": 1e-3}),
        "conv rmsprop centered": dict(cases["conv"], rule="rmsprop",
                                      params={"learning_rate": 1e-3,
                                              "centered": True})})
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
                if how == "variant" and c["kind"] == "conv":
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
            variant = "step_indexed over put_epoch" if c["kind"] == "conv" \
                else "step_accum(n_micro=2)"
            lines.append(f"{name} ({c['rule']} {c['params']}, {DP_STEPS} "
                         f"steps, then the rate halved and one more; "
                         f"'variant' is {variant}): losses graph "
                         f"{got['graph'][0]} cpu {got['cpu'][0]}; "
                         + "; ".join(texts))
        torch.cuda.synchronize(dev)
        # K3: 2 layers, 4 bodies a step (graph, eager, 2 microbatches)
        # in each of the two BERT cases
        launches = read_launches("dp card vs cpu", {
            "fused_sgd_update": 3 * (DP_STEPS + 1),
            "fused_adam_update": 3 * (DP_STEPS + 1),
            "flash_attention_fwd": 2 * 2 * 4 * (DP_STEPS + 1),
            "flash_attention_bwd": 2 * 2 * 4 * (DP_STEPS + 1)})
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


# phases 17, 18, 30 and 31: each model's rule through DataParallelTrainer
DP_RULES = {
    ("resnet", "sgd"): {"learning_rate": RESNET_LR,
                        "momentum": RESNET_MOMENTUM},
    ("bert", "adam"): {"learning_rate": 1e-4},
    ("bert", "lamb"): {"learning_rate": 1e-3, "wd": 0.01},
    ("resnet", "lars"): {"learning_rate": 0.1, "momentum": 0.9,
                         "wd": 5e-5},
}
# the f32 streams each rule must move an element: SGD momentum reads p,
# g, m and writes p, m; Adam also v; LARS first reads p and g for their
# norms, then as SGD; LAMB first reads p, g, m, v and writes m, v (the
# norms need the whole update before any of it applies), then reads p,
# m, v and writes p
UPDATE_STREAMS = {"sgd": 5, "adam": 7, "lars": 7, "lamb": 10}
# (model, rule) -> the update's device time alone in this run, so phases
# 30 and 31 print it beside phases 18 and 17's K2 and K1
UPDATE_MS = {}
# (model, rule, compute_dtype) -> (step median ms, peak GB) in this run,
# so phase 34 prints its quantized steps beside phase 18's bf16 one
STEP_MS = {}


def update_device_ms(trainer, reps=10):
    """Device time of the trainer's update alone (``_update``: K1/K2, or
    the plain rule with its per-parameter norms) over clones of the flat
    buffers it updates (the whole parameter buffer, or under ZeRO-1 the
    rank's shard) and a random gradient, captured as one CUDA graph whose
    replays are timed with CUDA events (median of ``reps``); the
    trainer's own buffers are put back untouched."""
    import torch
    from mxnet_tpu_torch import ops
    keep = (trainer._flat_upd, trainer._flat_state, trainer._t)
    trainer._flat_upd = keep[0].clone()
    trainer._flat_state = {k: v.clone() for k, v in keep[1].items()}
    trainer._t = None if keep[2] is None else keep[2].clone()
    try:
        g = torch.randn_like(trainer._flat_upd) * 1e-3
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            trainer._update(g)              # loads every kernel it runs
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        with torch.cuda.graph(graph):
            trainer._update(g)
        # the capture's wrapper calls are not launches of the path
        ops.add_launches({k: before[k] - v
                          for k, v in ops.launch_counts().items()})
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        del graph
        return statistics.median(times)
    finally:
        trainer._flat_upd, trainer._flat_state, trainer._t = keep


def dp_training(dev, card, model, rule=None, compute_dtype=None):
    """Phases 17 (``model="resnet"``), 18 (``"bert"``), 30 (``"bert"``,
    ``rule="lamb"``), 31 (``"resnet"``, ``rule="lars"``) and 34
    (``"bert"``, ``compute_dtype="fp8"`` or ``"int8"``: every Dense of
    the built net switched by ``net.apply``, its products through
    ``ops.quant_matmul``; their f32 results make the attention after
    them run K3's f32 kernels, as the reference's f32 flash path; the
    step beside phase 18's):
    ``bench.py``'s ``_bench_resnet`` and ``_bench_bert`` through the entry
    point they use, ``DataParallelTrainer`` on ``make_mesh({"dp": 1})``,
    bf16 AMP: ``resnet50_v1(s2d_stem=True)``, batch 128 x 3 x 224 x 224
    from ``nd.random.uniform`` seeded 0, labels zeros, SGD lr 0.1
    momentum 0.9 (phase 31: LARS lr 0.1 momentum 0.9 wd 5e-5 at the
    reference's eta and eps); or BERT-base (vocab 30522, max_length 128,
    dropout 0, flash, no decoder), batch 64 x 128 from
    ``RandomState(0)``, the loss on the sentence head, Adam lr 1e-4
    (phase 30: LAMB lr 1e-3 wd 0.01 at the reference's other defaults).
    3 warm-up steps (the first eager, the second captured), then 20
    timed (host clock around each, ending in a synchronize).  Fails
    unless every timed step was one replay of the one graph, the loss is
    finite and lower at the last step than at the first, and the
    kernels ran as the path says (K1 once a step; or K2 once and 12 bf16
    K3 forward and backward; LAMB: the 12 K3 and no K1/K2; LARS: none of
    the port's kernels).  Prints the step median, images or samples per
    second, peak memory, captures, capture seconds and the graph pool's
    bytes; the replay's device time (CUDA events around
    ``graph.replay()``, 5 replays after the run) and the host share
    ``1 - device / wall``; from two profiled steps the device time by
    kernel class; and the update's device time alone
    (``update_device_ms``) beside its bytes bound."""
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
        rule = rule or ("sgd" if model == "resnet" else "adam")
        hyper = DP_RULES[(model, rule)]
        if model == "resnet":
            from mxnet_tpu_torch.gluon.model_zoo import vision
            net = vision.resnet50_v1(s2d_stem=True)
            net.initialize()
            trainer = parallel.DataParallelTrainer(
                net, ce, rule, dict(hyper), mesh=mesh)
            batch = (mx.nd.random.uniform(shape=(RESNET_BATCH, 3,
                                                 RESNET_SIZE, RESNET_SIZE)),
                     mx.nd.zeros((RESNET_BATCH,)))
            n, unit, classes = RESNET_BATCH, "images", RESNET_CLASSES
            want = {"fused_sgd_update": DP_TIMED} if rule == "sgd" else {}
            label = (f"dp resnet{'' if rule == 'sgd' else ' ' + rule}, "
                     f"ResNet-50 v1 (s2d stem), bf16 amp, {rule} {hyper}, "
                     f"batch {RESNET_BATCH}x3x{RESNET_SIZE}x{RESNET_SIZE}")
        else:
            from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model
            net = get_bert_model(vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
                                 dropout=0.0, use_flash=True,
                                 use_decoder=False)
            net.initialize()
            n_dense = []
            if compute_dtype is not None:
                net.apply(lambda b: n_dense.append(b) or setattr(
                    b, "compute_dtype", compute_dtype)
                    if isinstance(b, gluon.nn.Dense) else None)

            def loss_fn(out, label):
                return ce(out[-1], label)

            trainer = parallel.DataParallelTrainer(
                net, loss_fn, rule, dict(hyper), mesh=mesh)
            rng = np.random.RandomState(0)
            batch = (mx.nd.array(rng.randint(0, BERT_VOCAB,
                                             size=(BERT_BATCH, BERT_SEQ)),
                                 dtype="int32"),
                     mx.nd.zeros((BERT_BATCH, BERT_SEQ), dtype="int32"),
                     mx.nd.array(rng.randint(0, 2, size=(BERT_BATCH,)),
                                 dtype="int32"))
            n, unit, classes = BERT_BATCH, "samples", BUSY_CLASSES
            k3 = ("flash_attention_fwd", "flash_attention_bwd") + (
                () if compute_dtype else ("flash_attention_fwd_bf16",
                                          "flash_attention_bwd_bf16"))
            want = {name: 12 * DP_TIMED for name in k3}
            if rule == "adam":
                want["fused_adam_update"] = DP_TIMED
            tag = "" if rule == "adam" else " " + rule
            if compute_dtype:
                tag += " " + compute_dtype
            label = (f"dp bert{tag}, "
                     f"BERT-base (12 x 768, vocab {BERT_VOCAB}), bf16 amp"
                     + (f", every Dense ({len(n_dense)}) in {compute_dtype}"
                        if compute_dtype else "")
                     + f", {rule} {hyper}, batch {BERT_BATCH}x{BERT_SEQ}")
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
        update_ms = update_device_ms(trainer)
        n_bucket = trainer._flat_p.numel()
        streams = UPDATE_STREAMS[rule]
        update_bound_ms = streams * 4 * n_bucket / H100_BYTES_PER_S * 1e3
        if compute_dtype is None:
            UPDATE_MS[(model, rule)] = update_ms
        others = {r: ms for (m, r), ms in UPDATE_MS.items()
                  if m == model and r != rule}
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
    STEP_MS[(model, rule, compute_dtype)] = (step_ms, peak_gb)
    plain = STEP_MS.get((model, rule, None)) if compute_dtype else None
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
          f"running statistics moved {moved} of {len(stats)}; the update "
          f"alone ({rule} over the {n_bucket}-element bucket, one captured "
          f"graph of it, median of 10 replays) {update_ms:.4f} ms device "
          f"time, its bound {update_bound_ms:.4f} ms ({streams} f32 "
          f"streams at {H100_BYTES_PER_S / 1e12} TB/s)"
          + "".join(f", beside {r}'s {ms:.4f} ms earlier in this run"
                    for r, ms in others.items())
          + (f"; beside phase 18's bf16 step {plain[0]:.2f} ms "
             f"({n / plain[0] * 1e3:.1f} {unit}/s, peak {plain[1]:.2f} GB; "
             f"{step_ms / plain[0]:.3f}x its time) earlier in this run"
             if plain else "")
          + f"; launches {launches}", flush=True)
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
    if compute_dtype and len(n_dense) != BERT_DENSE:
        fail(f"{label}: {len(n_dense)} Dense layers switched, expected "
             f"{BERT_DENSE}")
    del net, trainer, entry
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phases 30-32: the rest of the training surface (LAMB, LARS and RMSProp
# in the captured step, the other optimizers, the losses, the samplers
# and their ops)
# ----------------------------------------------------------------------

# phase 30's f32 check: step 1's gradients of the two paths differ by
# rounding (median 1.5e-6 relative; tools/port_lamb_grad_noise.py); a
# parameter whose two gradients differ by more than this limit has a
# rounding-dominated gradient (the key biases' is zero in exact
# arithmetic; deep layers' query and key projections sum terms that
# cancel), which LAMB's normalized step turns into another direction of
# the same length: such a parameter is held by its update's norm each
# step, lr |w| for LAMB, which the per-parameter norms set
LAMB_GRAD_RTOL = 1e-4


def _rel_dev(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def lamb_dp_vs_gluon(dev):
    """Phase 30's check before its timed run: BERT-base at ``bench.py``'s
    configuration in f32 (no amp), two nets of the same weights on the
    card, two steps on one batch of 64 x 128: ``DataParallelTrainer``
    with ``"lamb"`` at the timed run's hyperparameters (the first step
    eager, the second captured and replayed: the norms per parameter of
    the flat bucket) against ``gluon.Trainer(net.collect_params(),
    "lamb", ...)`` in the MXNet loop on the batch's mean loss (the rule
    per parameter).  First both paths' step-1 gradients are taken
    (the trainer's step body, ``_loss_and_grad``, and the loop's
    ``backward``) and each parameter's difference printed; the
    parameters whose gradients differ by more than ``LAMB_GRAD_RTOL``
    are rounding-dominated.  Losses within 1e-4 relative; each other
    parameter's two-step update within 1e-3 net of storing's rounding
    (phase 16's limits); each rounding-dominated one's update norm each
    step within 1e-3 of the other path's (LAMB's step is lr |w| long);
    the key biases (zero gradient) within two LAMB steps of lr; K3 f32
    12 forward and 12 backward launches a step on each path."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, ops, parallel
    from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model
    hyper = DP_RULES[("bert", "lamb")]
    # LAMB's ratio is 1 at a zero weight, so its first step moves a key
    # bias (zero gradient in exact arithmetic) by up to lr on rounding
    # noise on either path, the second by lr times a ratio near lr
    key_atol = 2 * hyper["learning_rate"]
    ctx = mx.gpu(dev.index or 0)
    rng = np.random.RandomState(30)
    data = mx.nd.array(rng.randint(0, BERT_VOCAB, (BERT_BATCH, BERT_SEQ)),
                       dtype="int32", ctx=ctx)
    types = mx.nd.zeros((BERT_BATCH, BERT_SEQ), dtype="int32", ctx=ctx)
    label = mx.nd.array(rng.randint(0, 2, (BERT_BATCH,)), dtype="int32",
                        ctx=ctx)
    nets = []
    for _ in range(2):
        mx.random.seed(30)
        net = get_bert_model(vocab_size=BERT_VOCAB, max_length=BERT_SEQ,
                             dropout=0.0, use_flash=True, use_decoder=False)
        net.initialize(ctx=ctx)
        net(data, types)                # deferred shapes
        nets.append(net)
    copy_weights(nets[0], nets[1])
    params = [net._collect_params_with_prefix() for net in nets]

    def weights(i):
        return {k: p.data().data.detach().clone()
                for k, p in params[i].items()}

    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    dp = parallel.DataParallelTrainer(
        nets[0], lambda out, y: ce(out[-1], y), "lamb", dict(hyper),
        mesh=parallel.make_mesh({"dp": 1}, devices=[dev]))
    tr = gluon.Trainer(nets[1].collect_params(), "lamb", dict(hyper))
    # step 1's gradients on both paths, before either updates
    dp._prepare(lambda: [data.data, types.data])
    _, flat_g = dp._loss_and_grad([data.data, types.data], label.data)
    name_of = {id(p): k for k, p in params[0].items()}
    g_dp, off = {}, 0
    for i in dp._train:
        var = dp._param_objs[i]._var
        g_dp[name_of[id(dp._param_objs[i])]] = \
            flat_g[off:off + var.numel()].view(var.shape)
        off += var.numel()
    with autograd.record():
        loss = ce(nets[1](data, types)[-1], label).mean()
    loss.backward()
    grad_err = {k: _rel_dev(g, params[1][k].grad().data)
                for k, g in g_dp.items()}
    del flat_g, g_dp
    w = [[weights(0)], [weights(1)]]
    torch.cuda.synchronize(dev)
    ops.reset_launches()
    losses = []
    for _ in range(2):
        a = float(dp.step(data, types, label).asnumpy())
        with autograd.record():
            loss = ce(nets[1](data, types)[-1], label).mean()
        loss.backward()
        tr.step(1)
        losses.append((a, float(loss.asnumpy())))
        w[0].append(weights(0))
        w[1].append(weights(1))
    torch.cuda.synchronize(dev)
    launches = read_launches("phase 30 lamb check", {
        "flash_attention_fwd": 4 * 12, "flash_attention_bwd": 4 * 12})
    keys = [k for k in grad_err if k.endswith("proj_key.bias")]
    noisy = [k for k, e in grad_err.items()
             if e > LAMB_GRAD_RTOL and k not in keys]
    clean = [k for k in grad_err if k not in keys and k not in noisy]
    errs = update_errs_dev({k: w[0][0][k] for k in clean}, w[0][2], w[1][2],
                           2)
    worst = max(errs.items(), key=lambda kv: kv[1])
    norm_errs = {k: max(abs(_rel_dev(w[0][s][k], w[0][s - 1][k])
                            / _rel_dev(w[1][s][k], w[1][s - 1][k]) - 1)
                        for s in (1, 2)) for k in noisy}
    worst_norm = max(norm_errs.values(), default=0.0)
    key_err = max(float((w[0][2][k] - w[1][2][k]).abs().max()) for k in keys)
    loss_err = max(abs(a - b) / abs(b) for a, b in losses)
    top = sorted(grad_err.items(), key=lambda kv: -kv[1])[:4]
    print(f"phase 30 check (BERT-base f32, batch {BERT_BATCH}x{BERT_SEQ}, "
          f"lamb {hyper}, 2 steps): DataParallelTrainer (captured second "
          f"step, {dp.stats['captures']} capture) against gluon.Trainer "
          f"per parameter: step 1's gradients, median relative difference "
          f"{statistics.median(grad_err.values()):.3e} over "
          f"{len(grad_err)} parameters, largest "
          f"{[(k, float(f'{v:.3g}')) for k, v in top]}; losses {losses}, "
          f"max relative loss diff {loss_err:.3e} (limit "
          f"{TRAIN_LOSS_RTOL}); worst relative update diff {worst[1]:.3e} "
          f"at {worst[0]} over {len(clean)} parameters (limit "
          f"{FUSED_UPDATE_RTOL}); {len(noisy)} with gradients apart by "
          f"more than {LAMB_GRAD_RTOL} ({noisy}): update norms a step "
          f"within {worst_norm:.3e} (limit {FUSED_UPDATE_RTOL}); "
          f"{len(keys)} key biases within {key_err:.3e} (limit "
          f"{key_atol}); launches {launches}", flush=True)
    if loss_err > TRAIN_LOSS_RTOL or worst[1] > FUSED_UPDATE_RTOL or \
            worst_norm > FUSED_UPDATE_RTOL or key_err > key_atol or \
            dp.stats["captures"] != 1:
        fail("phase 30: the captured LAMB step differs from gluon.Trainer's")
    del nets, dp, tr, w, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# phase 32: card against CPU at small sizes; samplers by their moments
SURFACE_RTOL = 1e-5
SURFACE_CTC_RTOL = 1e-4
SAMPLER_DRAWS = 10 ** 6
SAMPLER_SE = 5
SURFACE_HP = {"wd": 0.01, "rescale_grad": 0.7, "clip_gradient": 0.9}
SURFACE_OPTIMIZERS = {
    "sgd": {"momentum": 0.9}, "nag": {"momentum": 0.9},
    "adam": {"learning_rate": 1e-2}, "adamw": {"learning_rate": 1e-2},
    "adagrad": {"learning_rate": 0.1}, "adadelta": {"rho": 0.8},
    "rmsprop": {"learning_rate": 1e-2},
    "rmsprop centered": {"learning_rate": 1e-2, "centered": True,
                         "clip_weights": 1.5},
    "ftrl": {"learning_rate": 0.1}, "signum": {"wd_lh": 0.01},
    "lamb": {"learning_rate": 1e-2},
    "lamb bounded": {"learning_rate": 1e-2, "lower_bound": 0.5,
                     "upper_bound": 2.0, "bias_correction": False},
    "lars": {"learning_rate": 0.1, "momentum": 0.9}, "test": {}}


def _rel(got, want):
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-30)


def _surface_optimizers(dev):
    """Each optimizer, 3 updates of 3 parameters on the card and the
    CPU: the worst relative difference of a weight or state array."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import optimizer as opt
    shapes = [(64, 33), (257,), (4, 5, 6)]
    rng = np.random.RandomState(32)
    w0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    worst = {}
    for case, kw in SURFACE_OPTIMIZERS.items():
        runs = []
        for device in (dev, torch.device("cpu")):
            o = opt.create(case.split()[0], **kw, **SURFACE_HP)
            o.set_lr_mult({1: 0.5})
            ws = [torch.tensor(w, device=device) for w in w0]
            states = [o.create_state_multi_precision(i, w)
                      for i, w in enumerate(ws)]
            for step in grads:
                for i, (w, g) in enumerate(zip(ws, step)):
                    o.update_multi_precision(
                        i, w, torch.tensor(g, device=device), states[i])
            leaves = [w.cpu().numpy() for w in ws]
            for s in states:
                ref = o.reference_state(s)
                ref = () if ref is None else \
                    ref if isinstance(ref, tuple) else (ref,)
                leaves += [t.cpu().numpy() for t in ref]
            runs.append(leaves)
        worst[case] = max(_rel(a, b) for a, b in zip(*runs))
    return worst


def _arrays(rng, n, shape=(6, 5), positive=()):
    import numpy as np
    out = [rng.randn(*shape).astype(np.float32) for _ in range(n)]
    for i in positive:
        out[i] = np.abs(out[i]) + 0.1
    return out


def _surface_op_cases(rng):
    """``(name, call(nd, arrays), numpy inputs, index of the input whose
    gradient is held or None, rtol)`` for each of the loss and optimizer
    ops and the densities."""
    import numpy as np
    hp = dict(SURFACE_HP)
    f16 = lambda *a: [x.astype(np.float16) for x in a]   # noqa: E731
    labels = lambda c: rng.randint(0, c, (6,)).astype(np.float32)  # noqa
    r = lambda: (np.abs(rng.randn(1)) + 0.5).astype(np.float32)  # noqa
    cases = []

    def op(name, arrays, grad=None, rtol=SURFACE_RTOL, **kw):
        cases.append((name, lambda nd, a: getattr(nd, name)(*a, **kw),
                      arrays, grad, rtol))

    op("sgd_update", _arrays(rng, 2), lr=0.1, **hp)
    op("sgd_mom_update", _arrays(rng, 3), lr=0.1, momentum=0.9, **hp)
    op("nag_mom_update", _arrays(rng, 3), lr=0.1, momentum=0.9, **hp)
    op("adam_update", _arrays(rng, 4, positive=(3,)), lr=0.01, **hp)
    op("signsgd_update", _arrays(rng, 2), lr=0.1, **hp)
    op("signum_update", _arrays(rng, 3), lr=0.1, momentum=0.9, wd_lh=0.01,
       **hp)
    op("rmsprop_update", _arrays(rng, 3, positive=(2,)), lr=0.01,
       clip_weights=1.2, **hp)
    alex = _arrays(rng, 5, positive=(2,))
    alex[2] += 1.0
    alex[3] *= 0.1
    op("rmspropalex_update", alex, lr=0.01, **hp)
    op("ftrl_update", _arrays(rng, 4, positive=(3,)), lr=0.1, **hp)
    op("adagrad_update", _arrays(rng, 3, positive=(2,)), lr=0.1, **hp)
    op("ftml_update", _arrays(rng, 5, positive=(2, 3)), lr=0.1, t=3,
       wd=0.01, rescale_grad=0.7, clip_grad=0.9)
    op("adamax_update", _arrays(rng, 4, positive=(3,)), lr=0.01, **hp)
    op("nadam_update", _arrays(rng, 4, positive=(3,)), lr=0.01, t=4, **hp)
    lamb1 = dict(t=3, beta1=0.9, beta2=0.99, **hp)
    op("lamb_update_phase1", _arrays(rng, 4, positive=(3,)), **lamb1)
    op("lamb_update_phase2", _arrays(rng, 2) + [r(), r()], lr=0.01,
       lower_bound=0.5, upper_bound=3.0)
    w, g, m, w32 = _arrays(rng, 4)
    op("mp_sgd_update", f16(w, g) + [w], lr=0.1, **hp)
    op("mp_sgd_mom_update", f16(w, g) + [m, w], lr=0.1, momentum=0.9, **hp)
    op("mp_nag_mom_update", f16(w, g) + [m, w], lr=0.1, momentum=0.9, **hp)
    op("mp_lamb_update_phase1", f16(w, g) + [m, np.abs(w32) + 0.1, w],
       **lamb1)
    op("mp_lamb_update_phase2", f16(w) + [g, r(), r(), w], lr=0.01)
    multi = dict(lrs=[0.1, 0.05], wds=[0.01, 0.0], rescale_grad=0.5,
                 clip_gradient=0.9)
    op("multi_sgd_update", _arrays(rng, 4), **multi)
    op("multi_sgd_mom_update", _arrays(rng, 6), momentum=0.8, **multi)
    op("multi_mp_sgd_update", f16(w, g) + [w] + f16(m, g) + [m], **multi)
    op("multi_mp_sgd_mom_update", f16(w, g) + [m, w] + f16(m, g) + [w, m],
       momentum=0.8, **multi)
    op("multi_lamb_update", _arrays(rng, 4, positive=(3,)) +
       _arrays(rng, 4, positive=(3,)), step=3, lower_bound=0.2,
       upper_bound=5.0, **multi)
    pre = [np.array([0.1, 0.05], np.float32), np.array([0.01, 0.0],
                                                       np.float32)]
    pkw = dict(rescale_grad=0.5, clip_gradient=0.9)
    op("preloaded_multi_sgd_update", _arrays(rng, 4) + pre, **pkw)
    op("preloaded_multi_sgd_mom_update", _arrays(rng, 6) + pre,
       momentum=0.8, **pkw)
    op("preloaded_multi_mp_sgd_update",
       f16(w, g) + [w] + f16(m, g) + [m] + pre, **pkw)
    op("preloaded_multi_mp_sgd_mom_update",
       f16(w, g) + [m, w] + f16(m, g) + [w, m] + pre, momentum=0.8, **pkw)
    op("multi_sum_sq", _arrays(rng, 3), num_arrays=3)
    op("multi_lars", [np.array([0.1, 0.2], np.float32),
                      np.array([4.0, 0.0], np.float32),
                      np.array([1.0, 9.0], np.float32),
                      np.array([0.01, 0.02], np.float32)], eta=0.01,
       eps=1e-6, rescale_grad=0.5)
    inf = _arrays(rng, 1)[0]
    inf[1, 1] = np.inf
    op("all_finite", [inf])
    op("multi_all_finite", _arrays(rng, 2) + [inf])
    op("reset_arrays", _arrays(rng, 2), num_arrays=2)
    # the loss ops, with their gradients
    op("SoftmaxOutput", [_arrays(rng, 1)[0], labels(5)], grad=0,
       grad_scale=0.5, use_ignore=True, normalization="valid")
    op("softmax_cross_entropy", [_arrays(rng, 1)[0], labels(5)], grad=0)
    op("smooth_l1", _arrays(rng, 1), grad=0, scalar=1.5)
    op("MakeLoss", _arrays(rng, 1), grad=0, grad_scale=0.3)
    cases.append(("BlockGrad", lambda nd, a: nd.BlockGrad(a[0]) + a[0] * 2,
                  _arrays(rng, 1), 0, SURFACE_RTOL))
    op("LinearRegressionOutput", _arrays(rng, 2), grad=0, grad_scale=0.5)
    op("MAERegressionOutput", _arrays(rng, 2), grad=0)
    op("LogisticRegressionOutput",
       [_arrays(rng, 1)[0], (rng.rand(6, 5) > 0.5).astype(np.float32)],
       grad=0, grad_scale=2.0)
    op("SVMOutput", [_arrays(rng, 1)[0], labels(5)], grad=0, margin=0.5)
    op("IdentityAttachKLSparseReg", [rng.rand(6, 5).astype(np.float32)],
       grad=0, sparseness_target=0.2, penalty=0.01)
    act = rng.randn(12, 4, 6).astype(np.float32)            # (T, B, C)
    lab = np.array([[1, 1, 3, 2], [4, -1, -1, -1], [2, 5, 1, -1],
                    [3, 3, -1, -1]], np.float32)
    op("ctc_loss", [act, lab], grad=0, rtol=SURFACE_CTC_RTOL)
    op("CTCLoss", [act, lab, np.array([12, 10, 9, 11], np.float32),
                   np.array([4, 1, 3, 2], np.float32)], grad=0,
       rtol=SURFACE_CTC_RTOL, use_data_lengths=True, use_label_lengths=True,
       blank_label="first")
    # the densities
    pos = lambda *s: (rng.rand(*s) * 2 + 0.5).astype(np.float32)  # noqa
    counts = rng.poisson(2.0, (2, 5)).astype(np.float32)
    dirichlet = rng.rand(2, 5, 3).astype(np.float32) + 0.1
    for name, sample, params in (
            ("uniform", rng.rand(2, 5).astype(np.float32),
             [np.zeros(2, np.float32), np.ones(2, np.float32) * 1.5]),
            ("normal", rng.randn(2, 5).astype(np.float32),
             [rng.randn(2).astype(np.float32), pos(2)]),
            ("gamma", pos(2, 5), [pos(2), pos(2)]),
            ("exponential", pos(2, 5), [pos(2)]),
            ("poisson", counts, [pos(2)]),
            ("negative_binomial", counts,
             [pos(2), np.array([0.3, 0.7], np.float32)]),
            ("generalized_negative_binomial", counts, [pos(2), pos(2)]),
            ("dirichlet", dirichlet / dirichlet.sum(-1, keepdims=True),
             [pos(2, 3)])):
        op(f"random_pdf_{name}", [sample] + params, is_log=True)
    return cases + _surface_tail_cases(rng)


# phase 32's looser limits: CUDA's transcendental functions (lgamma,
# digamma and erfinv among them) and the CPU's are ulps apart, more
# where a gradient divides by a small value; cuSOLVER's factorizations
# and LAPACK's round in other orders
SURFACE_TRANS_RTOL = 1e-4
SURFACE_LINALG_RTOL = 1e-4


def _surface_tail_cases(rng):
    """Phase 32's cases of the rest of the op registry and of
    ``nd.linalg`` (each op name at least once, at small sizes), in
    ``_surface_op_cases``'s form, labels unique.  Multi-output ops with
    a held gradient hold one output, or a sign-invariant function of
    the factors (``syevd``, ``gelqf``)."""
    import numpy as np
    f32 = np.float32
    cases = []

    def op(label, name, arrays, grad=None, rtol=SURFACE_RTOL, **kw):
        cases.append((label, lambda nd, a: getattr(nd, name)(*a, **kw),
                      arrays, grad, rtol))

    def fn(label, call, arrays, grad=None, rtol=SURFACE_RTOL):
        cases.append((label, call, arrays, grad, rtol))

    T, LA = SURFACE_TRANS_RTOL, SURFACE_LINALG_RTOL
    a, b = _arrays(rng, 2)
    pos = np.abs(a) + 0.5
    unit = (np.tanh(a) * 0.9).astype(f32)
    ints = rng.randint(-20, 20, (6, 5)).astype(np.int32)
    intp = rng.randint(1, 30, (6, 5)).astype(np.int32)
    intq = rng.randint(1, 8, (6, 5)).astype(np.int32)
    ties = rng.randint(0, 4, (6, 8)).astype(f32)
    special = np.array([np.nan, np.inf, -np.inf, 1.5, -2.0, 0.0], f32)
    x3 = rng.randn(2, 3, 4).astype(f32)
    x4 = rng.randn(2, 6, 5, 7).astype(f32)
    vec = rng.randn(6).astype(f32)
    for name, x in (("arcsin", unit), ("arccos", unit), ("arctan", a),
                    ("sinh", a), ("cosh", a), ("arcsinh", a),
                    ("arccosh", pos + 1), ("arctanh", unit), ("cbrt", a),
                    ("rcbrt", pos), ("erfinv", unit), ("digamma", pos),
                    ("gammaln", pos), ("gamma", pos), ("gelu", a),
                    ("mish", a), ("selu", a), ("softrelu", a),
                    ("log_sigmoid", a), ("silu", a), ("swish", a),
                    ("softmin", a), ("SoftmaxActivation", a), ("elu", a)):
        op(name, name, [x], 0, T)
    for name in ("degrees", "radians", "hard_sigmoid"):
        op(name, name, [a], 0)
    fn("relu6", lambda nd, x: nd.relu6(x[0] * 4), [a], 0)
    fn("fix", lambda nd, x: nd.fix(x[0] * 3), [a])
    op("rint", "rint", [np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], f32)])
    for name in ("isnan", "isinf", "isfinite", "isposinf", "isneginf",
                 "nan_to_num"):
        op(name, name, [special])
    for name in ("hypot", "broadcast_hypot", "arctan2"):
        op(name, name, [a, b], 0, T)
    for name in ("logical_xor", "broadcast_logical_xor"):
        fn(name, lambda nd, x, name=name: getattr(nd, name)(
            x[0] > 0, x[1] > 0), [a, b])
    for name in ("fmod", "mod", "true_divide"):
        op(name, name, [a * 3, pos], 0)
    op("floor_divide", "floor_divide", [ints, intq])
    op("divmod", "divmod", [a * 5, pos])
    for name in ("outer", "kron"):
        op(name, name, [a[0], b[1]], 0)
    for name in ("inner", "vdot"):
        op(name, name, [a, b], 0)
    op("matmul", "matmul", [x3, rng.randn(2, 4, 5).astype(f32)], 0)
    op("tensordot", "tensordot", [x3, rng.randn(3, 4, 2).astype(f32)], 0,
       axes=2)
    for name in ("gcd", "lcm", "bitwise_and", "bitwise_or", "bitwise_xor",
                 "left_shift", "right_shift"):
        op(name, name, [ints if name != "lcm" else intq, intq])
    for name in ("bitwise_not", "invert"):
        op(name, name, [ints])
    op("cumsum", "cumsum", [a], 0, axis=1)
    op("cumprod", "cumprod", [pos], 0, axis=0)
    op("nanprod", "nanprod", [np.where(a > 1, np.nan, pos).astype(f32)],
       0, axis=1)
    op("mp_sum", "mp_sum", [a], 0, axis=0)
    fn("moments", lambda nd, x: sum(nd.moments(x[0], axes=(0, 2))), [x3], 0)
    op("ediff1d", "ediff1d", [a], 0, to_begin=[1.0], to_end=2.0)
    xp = np.sort(rng.randn(5)).astype(f32)
    op("interp", "interp", [a, xp, vec[:5]], 0)
    op("polyval", "polyval", [vec[:4], a], 1)
    op("searchsorted", "searchsorted", [xp, a], side="right")
    op("digitize", "digitize", [a, xp])
    fn("histogram", lambda nd, x: nd.histogram(x[0], bins=6), [a])
    op("bincount", "bincount", [intp.reshape(-1), a.reshape(-1)],
       minlength=40)
    op("unique", "unique", [ties])
    for asc in (True, False):
        op(f"sort {asc}", "sort", [ties], 0, is_ascend=asc)
        op(f"argsort {asc}", "argsort", [ties], is_ascend=asc, axis=0)
        op(f"topk {asc}", "topk", [ties], k=3, ret_typ="both",
           is_ascend=asc)
    fn("topk value", lambda nd, x: nd.topk(x[0], k=3, ret_typ="value"),
       [ties], 0)
    op("argmax_channel", "argmax_channel", [x4])
    op("gather_nd", "gather_nd", [x3, np.array([[0, 1, -1], [2, 0, 1]],
                                               f32)], 0)
    op("scatter_nd", "scatter_nd", [vec[:4], np.array(
        [[0, 2, 2, 1], [1, 3, 3, 0]], f32)], 0, shape=(3, 4))
    op("batch_take", "batch_take", [a, rng.randint(0, 5, 6).astype(f32)], 0)
    op("choose_element_0index", "choose_element_0index",
       [a, rng.randint(0, 5, 6).astype(f32)], 0)
    op("fill_element_0index", "fill_element_0index",
       [a, vec, rng.randint(0, 5, 6).astype(f32)], 0)
    for name in ("one_hot_encode", "onehot_encode"):
        op(name, name, [np.array([1, 4, 0], f32), np.zeros((3, 5), f32)])
    op("ravel_multi_index", "ravel_multi_index",
       [np.array([[0, 2, 1], [3, 0, 1]], f32)], shape=(3, 4))
    op("unravel_index", "unravel_index", [np.array([0, 5, 11, 13, -3], f32)],
       shape=(3, 4))
    op("slice_like", "slice_like", [x3, np.zeros((1, 2, 3), f32)], 0)
    op("diag", "diag", [a], 0, k=1)
    op("tril", "tril", [a], 0, k=1)
    op("triu", "triu", [x3], 0, k=-1)
    op("trace", "trace", [a], 0)
    op("reverse", "reverse", [a], 0, axis=1)
    op("SwapAxis", "SwapAxis", [x3], 0, dim1=0, dim2=2)
    op("rot90", "rot90", [x3], 0, k=3, axes=(1, 2))
    for name in ("shape_array", "size_array"):
        op(name, name, [x3])
    op("arange_like", "arange_like", [x3], start=1.0, step=0.5, repeat=2)
    op("full_like", "full_like", [a], fill_value=2.5)
    op("khatri_rao", "khatri_rao", [rng.randn(3, 2).astype(f32),
                                    rng.randn(4, 2).astype(f32)], 0)
    for name in ("hstack", "vstack", "dstack"):
        op(name, name, [a, b], 0)
    op("hsplit", "hsplit", [ties], indices_or_sections=2)
    op("vsplit", "vsplit", [ties], indices_or_sections=[2])
    op("meshgrid", "meshgrid", [vec[:3], vec])
    op("embedding", "embedding", [np.array([[1, 0], [3, 2]], f32), a], 1)
    seq = rng.randn(5, 3, 2).astype(f32)
    lens = np.array([2, 5, 1], f32)
    for name in ("SequenceMask", "sequence_mask", "SequenceLast",
                 "sequence_last", "SequenceReverse", "sequence_reverse"):
        op(name, name, [seq, lens], 0, use_sequence_length=True)
    op("SequenceMask axis 1", "SequenceMask",
       [seq.transpose(1, 0, 2).copy(), lens], 0, use_sequence_length=True,
       axis=1)
    mask = (rng.rand(2, 3, 4) > 0.4).astype(f32)
    mask[0, 1] = 0.0
    op("masked_softmax", "masked_softmax", [x3, mask], 0, T)
    op("L2Normalization", "L2Normalization", [x4], 0, mode="channel")
    op("LRN", "LRN", [x4], 0, nsize=3)
    op("UpSampling", "UpSampling", [x4], 0, scale=2)
    op("UpSampling bilinear", "UpSampling", [x4], 0, scale=2,
       sample_type="bilinear")
    op("Crop", "Crop", [x4], 0, h_w=(2, 3), offset=(1, 1))
    op("Correlation", "Correlation", [x4, rng.randn(2, 6, 5, 7).astype(f32)],
       0, max_displacement=2, stride2=2, pad_size=1)
    theta = np.array([[0.9, 0.1, 0.05, -0.2, 1.1, -0.1],
                      [1.2, -0.3, 0.2, 0.25, 0.8, 0.1]], f32)
    op("GridGenerator", "GridGenerator", [theta], 0, target_shape=(4, 5))
    grid = (np.tanh(rng.randn(2, 2, 4, 5)) * 1.15).astype(f32)
    op("BilinearSampler", "BilinearSampler", [x4, grid], 0)
    op("SpatialTransformer", "SpatialTransformer", [x4, theta], 0,
       target_shape=(4, 5))
    op("im2col", "im2col", [x4], 0, kernel=(3, 3), stride=(2, 1),
       pad=(1, 1))
    op("col2im", "col2im", [rng.randn(2, 54, 21).astype(f32)], 0,
       output_size=(5, 7), kernel=(3, 3), stride=(2, 1), pad=(1, 1))
    op("amp_cast", "amp_cast", [a], 0, dtype="float16")
    op("amp_multicast", "amp_multicast", [a.astype(np.float16), b])
    fn("foreach", lambda nd, x: nd.foreach(
        lambda xt, st: (xt * 2 + st, st + xt), x[0], x[1]), [seq, seq[0]])
    fn("cond", lambda nd, x: nd.cond(x[0].sum() > 0, lambda: x[0] * 2,
                                     lambda: x[0] - 1), [a])
    fn("while_loop", lambda nd, x: nd.while_loop(
        lambda j, s: j < 3, lambda j, s: (s * j, [j + 1, s + j]),
        [x[0], x[1]]), [np.zeros(1, f32), a])
    # nd.linalg: SPD inputs B B^T + n I, n = 8
    bb = rng.randn(2, 8, 8)
    spd = (bb @ bb.transpose(0, 2, 1) + 8 * np.eye(8)).astype(f32)
    low = np.linalg.cholesky(spd).astype(f32)
    m = rng.randn(2, 8, 3).astype(f32)
    op("linalg_gemm", "linalg_gemm", [spd, m, m], 0, alpha=0.5, beta=2.0)
    op("linalg_potrf", "linalg_potrf", [spd], 0, LA)
    op("linalg_potri", "linalg_potri", [low], 0, LA)
    op("linalg_trsm", "linalg_trsm", [low, m], 0, LA)
    op("linalg_trsm right transposed", "linalg_trsm",
       [low, m.transpose(0, 2, 1).copy()], 0, LA, rightside=True,
       transpose=True)
    op("linalg_trmm", "linalg_trmm", [spd, m], 0, lower=False)
    op("linalg_syrk", "linalg_syrk", [m], 0, transpose=True)
    op("linalg_sumlogdiag", "linalg_sumlogdiag", [spd], 0, LA)
    op("linalg_extractdiag", "linalg_extractdiag", [spd], 0, offset=1)
    op("linalg_makediag", "linalg_makediag", [m[:, 0]], 0, offset=-1)
    op("linalg_extracttrian", "linalg_extracttrian", [spd], 0, lower=False)
    op("linalg_maketrian", "linalg_maketrian", [rng.randn(2, 6).astype(f32)],
       0, offset=1)
    op("linalg_inverse", "linalg_inverse", [spd], 0, LA)
    op("linalg_det", "linalg_det", [spd / 8], 0, LA)
    op("linalg_slogdet", "linalg_slogdet", [spd], None, LA)
    fn("linalg_slogdet grad", lambda nd, x: nd.linalg_slogdet(x[0])[1],
       [spd], 0, LA)
    wide = rng.randn(2, 3, 8).astype(f32)
    fn("linalg_gelqf", lambda nd, x: [f ** 2 for f in nd.linalg_gelqf(x[0])]
       + [nd.linalg_gemm2(*nd.linalg_gelqf(x[0]))], [wide], None, LA)
    fn("linalg_gelqf grad", lambda nd, x: sum(
        (f ** 2).sum() for f in nd.linalg_gelqf(x[0])), [wide], 0, LA)
    fn("linalg_syevd", lambda nd, x: [nd.linalg_syevd(x[0])[0] ** 2,
                                      nd.linalg_syevd(x[0])[1]], [spd], None,
       LA)
    fn("linalg_syevd grad", lambda nd, x: nd.linalg_syevd(x[0])[1] + (
        nd.linalg_syevd(x[0])[0] ** 2).sum(axis=2), [spd], 0, LA)
    fn("linalg.gemm2", lambda nd, x: nd.linalg.gemm2(x[0], x[1]), [spd, m], 0)
    return cases


def _outputs(out):
    if out is None:
        return []
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _outputs(x)]
    return [out]


def _surface_ops(dev):
    """Each case of ``_surface_op_cases`` on the card and the CPU: its
    outputs, every input after the call (the in-place state writes) and
    the held gradient; ``{name: worst relative difference}`` and the
    cases whose difference exceeds their limit."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    rng = np.random.RandomState(33)
    worst, bad = {}, []
    for name, call, inputs, grad, rtol in _surface_op_cases(rng):
        runs = []
        head = None
        for ctx in (mx.gpu(dev.index or 0), mx.cpu()):
            arrs = [mx.nd.array(x, ctx=ctx, dtype=str(x.dtype))
                    for x in inputs]
            if grad is None:
                outs = _outputs(call(mx.nd, arrs))
                got = [o.asnumpy() for o in outs]
            else:
                arrs[grad].attach_grad()
                with autograd.record():
                    out = call(mx.nd, arrs)
                if head is None:
                    head = np.asarray(np.random.RandomState(3).randn(
                        *out.shape), np.float32)
                out.backward(mx.nd.array(head, ctx=ctx) if out.ndim
                             else None)
                got = [out.asnumpy(), arrs[grad].grad.asnumpy()]
            runs.append(got + [a.asnumpy() for a in arrs])
        worst[name] = max(_rel(a.astype(np.float32), b.astype(np.float32))
                          for a, b in zip(*runs)
                          if np.isfinite(b).all())
        if worst[name] > rtol:
            bad.append(f"{name} {worst[name]:.3e} > {rtol}")
    return worst, bad


def _surface_losses(dev):
    """Each Gluon loss's value and gradient (with ``weight`` and a
    ``sample_weight``), card against CPU."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    L = gluon.loss
    rng = np.random.RandomState(34)
    f = lambda *s: rng.randn(*s).astype(np.float32)   # noqa: E731
    sign = lambda *s: np.where(rng.rand(*s) > 0.5, 1, -1).astype(  # noqa
        np.float32)
    probs = np.exp(f(2, 6, 5))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    ctc_pred = f(4, 12, 6)
    ctc_lab = np.array([[1, 1, 3, 2], [4, 0, 0, 0], [2, 5, 1, 0],
                        [3, 3, 0, 0]], np.float32)
    cases = {
        "L2Loss": (L.L2Loss(weight=0.7), [f(6, 5), f(6, 5)]),
        "L1Loss": (L.L1Loss(weight=0.5), [f(6, 5), f(6, 5)]),
        "SigmoidBinaryCrossEntropyLoss": (
            L.SigmoidBinaryCrossEntropyLoss(weight=0.6),
            [f(6, 5), (rng.rand(6, 5) > 0.5).astype(np.float32)]),
        "SoftmaxCrossEntropyLoss": (
            L.SoftmaxCrossEntropyLoss(weight=0.8),
            [f(6, 5), rng.randint(0, 5, (6,)).astype(np.float32)]),
        "KLDivLoss": (L.KLDivLoss(weight=0.9), [np.log(probs[0]),
                                                probs[1]]),
        "HuberLoss": (L.HuberLoss(rho=0.5), [f(6, 5), f(6, 5)]),
        "HingeLoss": (L.HingeLoss(), [f(6, 5), sign(6, 5)]),
        "SquaredHingeLoss": (L.SquaredHingeLoss(), [f(6, 5), sign(6, 5)]),
        "LogisticLoss": (L.LogisticLoss(), [f(6, 5), sign(6, 5)]),
        "TripletLoss": (L.TripletLoss(margin=0.5), [f(6, 5), f(6, 5),
                                                    f(6, 5)]),
        "CTCLoss": (L.CTCLoss(weight=0.5), [ctc_pred, ctc_lab]),
        "CosineEmbeddingLoss": (L.CosineEmbeddingLoss(margin=0.2),
                                [f(6, 5), f(6, 5), sign(6)]),
        "PoissonNLLLoss": (L.PoissonNLLLoss(), [
            f(6, 5), rng.poisson(2.0, (6, 5)).astype(np.float32)]),
    }
    worst, bad = {}, []
    for name, (loss, inputs) in cases.items():
        batch = inputs[0].shape[0]
        sw = rng.rand(batch, *([1] * (inputs[0].ndim - 1))).astype(
            np.float32)
        if name in ("TripletLoss", "CosineEmbeddingLoss", "CTCLoss"):
            sw = sw.reshape(batch)
        runs = []
        for ctx in (mx.gpu(dev.index or 0), mx.cpu()):
            arrs = [mx.nd.array(x, ctx=ctx) for x in inputs]
            arrs[0].attach_grad()
            with autograd.record():
                out = loss(*arrs, sample_weight=mx.nd.array(sw, ctx=ctx))
            out.backward()
            runs.append([out.asnumpy(), arrs[0].grad.asnumpy()])
        rtol = SURFACE_CTC_RTOL if name == "CTCLoss" else SURFACE_RTOL
        worst[name] = max(_rel(a, b) for a, b in zip(*runs))
        if worst[name] > rtol:
            bad.append(f"{name} {worst[name]:.3e} > {rtol}")
    return worst, bad


def _moments_ok(x, mean, var):
    """(ok, text): the draws' mean and variance within ``SAMPLER_SE``
    standard errors of the distribution's (the variance's from the
    sample's own fourth moment)."""
    import numpy as np
    x = np.asarray(x, np.float64).reshape(-1)
    n = x.size
    m = x.mean()
    dev2 = (x - m) ** 2
    v = dev2.mean() * n / (n - 1)
    zm = abs(m - mean) / np.sqrt(var / n)
    zv = abs(v - var) / np.sqrt(dev2.var() / n)
    return max(zm, zv) <= SAMPLER_SE, f"{zm:.2f}/{zv:.2f} SE"


def _surface_samplers(dev):
    """Each sampler and ``sample_*`` op, ``SAMPLER_DRAWS`` draws on the
    card from the device generator: ``{name: z-scores}`` and failures."""
    import numpy as np
    import mxnet_tpu_torch as mx
    ctx = mx.gpu(dev.index or 0)
    n = SAMPLER_DRAWS
    nb = lambda k, p: (k * (1 - p) / p, k * (1 - p) / p ** 2)  # noqa
    R = mx.nd.random
    draws = {
        "uniform": (lambda: R.uniform(-1.0, 3.0, shape=(n,), ctx=ctx),
                    1.0, 16 / 12),
        "normal": (lambda: R.normal(0.5, 2.0, shape=(n,), ctx=ctx),
                   0.5, 4.0),
        "gamma": (lambda: R.gamma(2.5, 0.8, shape=(n,), ctx=ctx), 2.0, 1.6),
        "exponential": (lambda: R.exponential(1.5, shape=(n,), ctx=ctx),
                        1.5, 2.25),
        "poisson": (lambda: R.poisson(3.5, shape=(n,), ctx=ctx), 3.5, 3.5),
        "negative_binomial": (
            lambda: R.negative_binomial(3, 0.4, shape=(n,), ctx=ctx),
            *nb(3, 0.4)),
        "generalized_negative_binomial": (
            lambda: R.generalized_negative_binomial(2.0, 0.5, shape=(n,),
                                                    ctx=ctx), 2.0, 4.0),
    }

    def per_element(name, params):
        return getattr(mx.nd, name)(*[mx.nd.array(p, ctx=ctx)
                                      for p in params], shape=n)

    draws.update({
        "sample_uniform": (lambda: per_element(
            "sample_uniform", [[-1.0], [3.0]]), 1.0, 16 / 12),
        "sample_normal": (lambda: per_element(
            "sample_normal", [[0.5], [2.0]]), 0.5, 4.0),
        "sample_gamma": (lambda: per_element(
            "sample_gamma", [[2.5], [0.8]]), 2.0, 1.6),
        "sample_exponential": (lambda: per_element(
            "sample_exponential", [[2.0]]), 0.5, 0.25),
        "sample_poisson": (lambda: per_element(
            "sample_poisson", [[3.5]]), 3.5, 3.5),
        "sample_negative_binomial": (lambda: per_element(
            "sample_negative_binomial", [[3.0], [0.4]]), *nb(3, 0.4)),
        "sample_generalized_negative_binomial": (lambda: per_element(
            "sample_generalized_negative_binomial", [[2.0], [0.5]]),
            2.0, 4.0),
        "random_uniform": (lambda: mx.nd.random_uniform(
            -1.0, 3.0, shape=(n,), ctx=ctx), 1.0, 16 / 12),
        "random_normal": (lambda: mx.nd.random_normal(
            0.5, 2.0, shape=(n,), ctx=ctx), 0.5, 4.0)})
    out, bad = {}, []
    for name, (draw, mean, var) in draws.items():
        x = draw()
        if not x.data.is_cuda:
            bad.append(f"{name} drew on {x.data.device}")
        ok, text = _moments_ok(x.asnumpy(), mean, var)
        out[name] = text
        if not ok:
            bad.append(f"{name} {text}")
    probs = np.array([[0.1, 0.2, 0.7]], np.float32)
    for name, fn in (("multinomial", mx.nd.random.multinomial),
                     ("sample_multinomial", mx.nd.sample_multinomial)):
        d = fn(mx.nd.array(probs, ctx=ctx), shape=n).asnumpy()[0]
        z = max(abs((d == c).mean() - p) / np.sqrt(p * (1 - p) / n)
                for c, p in enumerate(probs[0]))
        out[name] = f"{z:.2f} SE"
        if z > SAMPLER_SE:
            bad.append(f"{name} {z:.2f} SE")
    rows = mx.nd.array(np.arange(n, dtype=np.float32), ctx=ctx)
    shuffled = mx.nd.random.shuffle(rows).asnumpy()
    if np.array_equal(shuffled, rows.asnumpy()) or not np.array_equal(
            np.sort(shuffled), rows.asnumpy()):
        bad.append("shuffle is not a permutation")
    return out, bad


def surface_card_vs_cpu(dev):
    """Phase 32: the training surface at small sizes, card against CPU.
    Each optimizer (3 updates of 3 parameters with wd, clip, rescale and
    an ``lr_mult``; weights and states), each loss, optimizer and density
    op (outputs, in-place state writes and the loss ops' gradients under
    a random head) and each Gluon loss (value and gradient, with
    ``weight`` and ``sample_weight``) within the CPU tests' 1e-5
    relative (CTC 1e-4); SGLD, each ``nd.random`` sampler and each
    ``sample_*`` op over 10^6 draws on the card within 5 standard errors
    of the distribution's mean and variance (the multinomial's
    frequencies within 5 binomial errors; ``shuffle`` a permutation).
    None of them reaches a kernel of the port."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import ops, optimizer as opt
    torch.cuda.synchronize(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    optimizers = _surface_optimizers(dev)
    bad = [f"optimizer {k} {v:.3e} > {SURFACE_RTOL}"
           for k, v in optimizers.items() if v > SURFACE_RTOL]
    op_worst, op_bad = _surface_ops(dev)
    loss_worst, loss_bad = _surface_losses(dev)
    samplers, sampler_bad = _surface_samplers(dev)
    # SGLD: the update less its drift is N(0, lr)
    lr, wd = 0.04, 0.1
    rng = np.random.RandomState(35)
    w0 = rng.randn(SAMPLER_DRAWS).astype(np.float32)
    g = rng.randn(SAMPLER_DRAWS).astype(np.float32)
    sgld = opt.create("sgld", learning_rate=lr, wd=wd)
    w = torch.tensor(w0, device=dev)
    sgld.update(0, w, torch.tensor(g, device=dev), sgld.create_state(0, w))
    noise = w.cpu().numpy().astype(np.float64) - w0 + lr / 2 * (g + wd * w0)
    ok, samplers["sgld"] = _moments_ok(noise, 0.0, lr)
    if not ok:
        sampler_bad.append(f"sgld {samplers['sgld']}")
    torch.cuda.synchronize(dev)
    launches = read_launches("surface card vs cpu", {})
    bad += op_bad + loss_bad + sampler_bad
    print(f"surface card vs cpu ({len(optimizers)} optimizers, "
          f"{len(op_worst)} op cases, {len(loss_worst)} losses, "
          f"{len(samplers)} samplers, {time.perf_counter() - t0:.1f} s): "
          f"worst relative difference card vs CPU: optimizers "
          f"{ {k: float(f'{v:.3g}') for k, v in optimizers.items()} }; ops "
          f"{ {k: float(f'{v:.3g}') for k, v in op_worst.items()} }; losses "
          f"{ {k: float(f'{v:.3g}') for k, v in loss_worst.items()} }; "
          f"sampler moments (mean/variance, in standard errors) "
          f"{samplers}; launches {launches}", flush=True)
    if bad:
        fail("surface card vs cpu: " + "; ".join(bad))
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phase 33: the op library at full width, card against the port's CPU
# ----------------------------------------------------------------------

# f32 arithmetic in another order (sums of a softmax, a convolution's
# 147 products, a channel mean, LRN's window, a bilinear blend and its
# scattered gradient)
OPLIB_RTOL = 1e-5
# cuSOLVER's factorizations against LAPACK's, on well-conditioned SPD
# matrices B B^T + n I
OPLIB_LINALG_RTOL = 1e-4
# Correlation's CPU reference runs on the first samples of the batch
# only (each sample is computed alone; 441 displacements over 8 x 256
# maps take the CPU seconds)
OPLIB_CORR_CPU_SAMPLES = 2
# syevd's eigenvectors are compared where the eigenvalue's gap to both
# neighbours exceeds this (about 1e-3 of the largest eigenvalue of
# B B^T + n I at n = 256)
OPLIB_EIG_GAP = 1.0
# cycles the card sleeps ahead of each timed call (time_ms's cover),
# some 25 ms: longer than the host takes to enqueue Correlation's 882
# launches, so the events time the card and not the Python loop; a call
# whose enqueue outlasts it (or that waits on the card inside, as
# eigh's convergence check does) prints its time as including dispatch
OPLIB_COVER = 50_000_000
# the models' widths: Llama-3-8B's vocabulary, BERT-base's attention
# (batch 64 x 128), ResNet-50's stem and AlexNet's conv1 output (batch
# 32), FlowNetC's correlation, a (64, 256, 256) batch of matrices
OPLIB = dict(logits=(8, 128256), topk=50, attn=(64, 12, 128, 128),
             seq=(128, 64, 1024), img=(32, 3, 224, 224), stem=64,
             corr=(8, 256, 48, 64), corr_kw=dict(max_displacement=20,
                                                 stride2=2, pad_size=20),
             lrn=(32, 96, 55, 55), linalg=(64, 256))


def oplib_full_width(dev, card, shapes=OPLIB):
    """Phase 33: ops of the registry's tail and ``nd.linalg`` at the
    full width of a model that calls them, card against the port's own
    CPU result on the same inputs; each line prints the card's median
    time over 5 calls (``time_ms`` behind ``OPLIB_COVER``, the L2
    flushed), marked where it includes the host's dispatch, and the
    card.

    - top-k sampling at Llama-3-8B's vocabulary: ``topk(k=50,
      ret_typ="both")``, ``sort`` and ``argsort`` on (8, 128256) f32
      logits rounded to bf16 (a bf16 head's logits, so values tie):
      values and indices exactly the CPU's, and the indices numpy's
      stable order (the lower index first among equal values);
    - BERT-base attention: ``masked_softmax`` and its gradient on (64,
      12, 128, 128) scores masked by per-row valid lengths;
    - ``SequenceMask``, ``SequenceLast`` and ``SequenceReverse`` at
      (128, 64, 1024) with per-row lengths, exactly;
    - ResNet-50's stem: ``im2col`` at (32, 3, 224, 224), kernel 7,
      stride 2, pad 3, exactly the CPU's; its columns times the stem's
      weight equal ``Convolution``'s output, and ``col2im`` is its
      adjoint (``<im2col(x), y> = <x, col2im(y)>``);
    - a spatial transformer: ``GridGenerator`` (affine) and
      ``BilinearSampler`` with its gradients at (32, 3, 224, 224), both
      samplers fed the CPU's grid;
    - FlowNetC's ``Correlation`` at (8, 256, 48, 64), max_displacement
      20, stride2 2, pad 20 (the CPU on the first samples);
    - AlexNet's ``LRN(nsize=5)`` at (32, 96, 55, 55);
    - ``linalg`` ``potrf``, ``potri``, ``trsm``, ``syrk``, ``inverse``,
      ``slogdet``, ``gelqf`` and ``syevd`` on (64, 256, 256) f32 (SPD
      B B^T + n I where it takes one): the factors and the eigenvectors
      up to sign, each factorization also by its reconstruction on the
      card.
    Nothing here launches a kernel of the port, and every card output
    lies on the card."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, ops
    nd = mx.nd
    gpu, cpu = mx.gpu(dev.index or 0), mx.cpu()
    torch.cuda.synchronize(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    rng = np.random.RandomState(330)
    bad = []
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(OPLIB_COVER)
    end.record()
    end.synchronize()
    cover_ms = start.elapsed_time(end)

    def card_ms(fn):
        """``fn``'s median card time as text: device time where the
        host enqueues one call within the cover, else marked as time
        that includes the dispatch."""
        ms = time_ms(fn, 5, flush, OPLIB_COVER)
        torch.cuda._sleep(OPLIB_COVER)
        t = time.perf_counter()
        fn()
        host = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize(dev)
        if host < cover_ms:
            return f"{ms:.3f} ms"
        return f"{ms:.3f} ms (includes dispatch: host {host:.3f} ms)"

    def both(x):
        return (nd.array(x, ctx=gpu, dtype=str(x.dtype)),
                nd.array(x, ctx=cpu, dtype=str(x.dtype)))

    def on_card(*arrays):
        for a in arrays:
            if not a.data.is_cuda:
                fail("phase 33: an op returned a CPU array for card inputs")

    def report(label, errs, limit, ms, extra=""):
        shown = {k: float(f"{v:.3g}") for k, v in errs.items()}
        print(f"phase 33 {label}: card {ms}; relative difference card vs "
              f"CPU {shown} (limit {limit}){extra}; {card}", flush=True)
        for k, v in errs.items():
            if not v <= limit:
                bad.append(f"{label} {k} {v:.3e} > {limit}")

    def grad_run(op, data, extra_in, head, **kw):
        data = nd.array(data, ctx=data.context)
        data.attach_grad()
        with autograd.record():
            out = op(data, *extra_in, **kw)
        out.backward(head)
        return out, data.grad

    # top-k sampling at Llama-3-8B's vocabulary
    K = shapes["topk"]
    logits = torch.tensor(rng.randn(*shapes["logits"]).astype(np.float32) *
                          3).bfloat16().float().numpy()
    lg, lc = both(logits)
    exact = {}
    for name, call in (
            ("topk", lambda x: nd.topk(x, k=K, ret_typ="both")),
            ("sort", lambda x: [nd.sort(x, is_ascend=False)]),
            ("argsort", lambda x: [nd.argsort(x, is_ascend=False,
                                              dtype="int32")])):
        got, want = call(lg), call(lc)
        on_card(*got)
        exact[name] = all(np.array_equal(g.asnumpy(), w.asnumpy())
                          for g, w in zip(got, want))
    # the reference's orders: top-k the lower index first among equal
    # values, a descending argsort the stable ascending one reversed
    exact["numpy's orders"] = np.array_equal(
        nd.topk(lg, k=K).asnumpy().astype(np.int64),
        np.argsort(-logits, axis=-1, kind="stable")[:, :K]) and \
        np.array_equal(nd.argsort(lg, is_ascend=False).asnumpy().astype(
            np.int64), np.flip(np.argsort(logits, -1, kind="stable"), -1))
    top = np.sort(logits, -1)[:, ::-1][:, :K + 1]
    ties = int((top[:, 1:] == top[:, :-1]).sum())
    ms = {n: card_ms(c) for n, c in (
        ("topk", lambda: nd.topk(lg, k=K, ret_typ="both")),
        ("sort", lambda: nd.sort(lg)), ("argsort", lambda: nd.argsort(lg)))}
    print(f"phase 33 top-k sampling ({shapes['logits']} f32 logits, bf16 "
          f"values, {ties} tied neighbours in the top {K + 1}): card {ms}; "
          f"exactly the CPU's {exact}; {card}", flush=True)
    if not all(exact.values()):
        bad.append(f"top-k sampling: not exact {exact}")
    del lg, lc

    # BERT-base attention
    bb, hh, ll, _ = shapes["attn"]
    scores = rng.randn(*shapes["attn"]).astype(np.float32)
    lengths = rng.randint(1, ll + 1, bb)
    mask = (np.arange(ll)[None, :] < lengths[:, None]).astype(
        np.float32).reshape(bb, 1, 1, ll)
    head = rng.randn(*shapes["attn"]).astype(np.float32)
    runs = []
    for ctx in (gpu, cpu):
        runs.append(grad_run(nd.masked_softmax, nd.array(scores, ctx=ctx),
                             [nd.array(mask, ctx=ctx)],
                             nd.array(head, ctx=ctx)))
    on_card(*runs[0])
    sg, mg = both(scores)[0], nd.array(mask, ctx=gpu)
    hg = nd.array(head, ctx=gpu)
    fwd = card_ms(lambda: nd.masked_softmax(sg, mg))
    both_ms = card_ms(lambda: grad_run(nd.masked_softmax, sg, [mg], hg))
    report(f"BERT-base masked_softmax {shapes['attn']}",
           {"output": _rel(runs[0][0].asnumpy(), runs[1][0].asnumpy()),
            "gradient": _rel(runs[0][1].asnumpy(), runs[1][1].asnumpy())},
           OPLIB_RTOL, f"{fwd} forward, {both_ms} with the backward")
    del runs, sg, mg, hg

    # sequence ops
    seq = rng.randn(*shapes["seq"]).astype(np.float32)
    slen = rng.randint(1, seq.shape[0] + 1, seq.shape[1]).astype(np.float32)
    qg, qc = both(seq)
    lg_, lc_ = both(slen)
    exact, ms = {}, {}
    for name in ("SequenceMask", "SequenceLast", "SequenceReverse"):
        op = getattr(nd, name)
        got = op(qg, lg_, use_sequence_length=True)
        on_card(got)
        exact[name] = np.array_equal(
            got.asnumpy(), op(qc, lc_, use_sequence_length=True).asnumpy())
        ms[name] = card_ms(lambda: op(qg, lg_, use_sequence_length=True))
    print(f"phase 33 sequence ops ({shapes['seq']}, per-row lengths): card "
          f"{ms}; exactly the CPU's {exact}; {card}", flush=True)
    if not all(exact.values()):
        bad.append(f"sequence ops: not exact {exact}")
    del qg, qc

    # ResNet-50's stem through im2col
    x = rng.randn(*shapes["img"]).astype(np.float32)
    side = x.shape[2]
    w = (rng.randn(shapes["stem"], 3, 7, 7) * 0.1).astype(np.float32)
    xg, xc = both(x)
    stem = dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3))
    cols = nd.im2col(xg, **stem)
    on_card(cols)
    cols_exact = np.array_equal(cols.asnumpy(),
                                nd.im2col(xc, **stem).asnumpy())
    wg = nd.array(w, ctx=gpu)
    conv = nd.Convolution(xg, wg, no_bias=True, num_filter=w.shape[0],
                          **stem)
    via = torch.matmul(wg.data.reshape(w.shape[0], -1), cols.data).reshape(
        conv.shape)
    y = rng.randn(*cols.shape).astype(np.float32)
    yg, yc = both(y)
    back = nd.col2im(yg, output_size=(side, side), **stem)
    on_card(back)
    lhs = float((cols.data.double() * yg.data.double()).sum())
    rhs = float((xg.data.double() * back.data.double()).sum())
    errs = {"columns x weight vs Convolution": _rel(via.cpu().numpy(),
                                                    conv.asnumpy()),
            "adjoint": abs(lhs - rhs) / abs(lhs),
            "col2im": _rel(back.asnumpy(), nd.col2im(
                yc, output_size=(side, side), **stem).asnumpy())}
    ms = {"im2col": card_ms(lambda: nd.im2col(xg, **stem)),
          "col2im": card_ms(lambda: nd.col2im(
              yg, output_size=(side, side), **stem)),
          "Convolution": card_ms(lambda: nd.Convolution(
              xg, wg, no_bias=True, num_filter=w.shape[0], **stem))}
    report(f"ResNet-50 stem im2col ({shapes['img']}, kernel 7, stride 2, "
           "pad 3)", errs, OPLIB_RTOL, ms,
           f"; im2col exactly the CPU's: {cols_exact}")
    if not cols_exact:
        bad.append("im2col: not the CPU's columns")
    del xg, xc, cols, yg, yc, back, conv, via

    # a spatial transformer
    data = rng.randn(*shapes["img"]).astype(np.float32)
    theta = (np.tile([[1.0, 0.0, 0.0, 0.0, 1.0, 0.0]], (data.shape[0], 1)) +
             rng.randn(data.shape[0], 6) * 0.1).astype(np.float32)
    tg, tc = both(theta)
    grid_g = nd.GridGenerator(tg, target_shape=(side, side))
    grid_c = nd.GridGenerator(tc, target_shape=(side, side))
    on_card(grid_g)
    grid = grid_c.asnumpy()
    head = rng.randn(*shapes["img"]).astype(np.float32)
    runs = []
    for ctx in (gpu, cpu):
        d = nd.array(data, ctx=ctx)
        g = nd.array(grid, ctx=ctx)
        d.attach_grad()
        g.attach_grad()
        with autograd.record():
            out = nd.BilinearSampler(d, g)
        out.backward(nd.array(head, ctx=ctx))
        runs.append((out, d.grad, g.grad))
    on_card(*runs[0])
    dg, gg, hg = nd.array(data, ctx=gpu), nd.array(grid, ctx=gpu), \
        nd.array(head, ctx=gpu)

    def sampler_step():
        dd = nd.array(dg, ctx=gpu)
        gr = nd.array(gg, ctx=gpu)
        dd.attach_grad()
        gr.attach_grad()
        with autograd.record():
            out = nd.BilinearSampler(dd, gr)
        out.backward(hg)
    ms = {"GridGenerator": card_ms(lambda: nd.GridGenerator(
        tg, target_shape=(side, side))),
        "BilinearSampler": card_ms(lambda: nd.BilinearSampler(dg, gg)),
        "BilinearSampler with the backward": card_ms(sampler_step)}
    report(f"spatial transformer {shapes['img']}",
           {"grid": _rel(grid_g.asnumpy(), grid),
            "output": _rel(runs[0][0].asnumpy(), runs[1][0].asnumpy()),
            "data gradient": _rel(runs[0][1].asnumpy(), runs[1][1].asnumpy()),
            "grid gradient": _rel(runs[0][2].asnumpy(), runs[1][2].asnumpy())},
           OPLIB_RTOL, ms)
    del runs, dg, gg, hg

    # FlowNetC's correlation
    a = rng.randn(*shapes["corr"]).astype(np.float32)
    b = rng.randn(*shapes["corr"]).astype(np.float32)
    corr = shapes["corr_kw"]
    ag, bg = nd.array(a, ctx=gpu), nd.array(b, ctx=gpu)
    got = nd.Correlation(ag, bg, **corr)
    on_card(got)
    k = OPLIB_CORR_CPU_SAMPLES
    want = nd.Correlation(nd.array(a[:k], ctx=cpu), nd.array(b[:k], ctx=cpu),
                          **corr).asnumpy()
    report(f"FlowNetC Correlation ({shapes['corr']}, {corr}; "
           f"{got.shape[1]} displacements; CPU on samples 0-{k - 1})",
           {"output": _rel(got.asnumpy()[:k], want)},
           OPLIB_RTOL,
           card_ms(lambda: nd.Correlation(ag, bg, **corr)))
    del ag, bg, got

    # AlexNet's LRN
    x = np.abs(rng.randn(*shapes["lrn"])).astype(np.float32)
    xg, xc = both(x)
    got = nd.LRN(xg, nsize=5)
    on_card(got)
    report(f"AlexNet LRN(nsize=5) {shapes['lrn']}",
           {"output": _rel(got.asnumpy(), nd.LRN(xc, nsize=5).asnumpy())},
           OPLIB_RTOL, card_ms(lambda: nd.LRN(xg, nsize=5)))
    del xg, xc, got

    # linalg on (64, 256, 256)
    nb, n = shapes["linalg"]
    bm = rng.randn(nb, n, n)
    spd = (bm @ bm.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)
    gen = rng.randn(nb, n, n).astype(np.float32)
    sg, sc = both(spd)
    mg, mc = both(gen)
    low = nd.linalg_potrf(sc).asnumpy()
    lowg, lowc = both(low)
    errs, ms = {}, {}
    for name, call, args in (
            ("potrf", nd.linalg_potrf, (sg, sc)),
            ("potri", nd.linalg_potri, (lowg, lowc)),
            ("trsm", lambda x, m: nd.linalg_trsm(x, m), ((lowg, mg),
                                                          (lowc, mc))),
            ("syrk", nd.linalg_syrk, (mg, mc)),
            ("inverse", nd.linalg_inverse, (sg, sc))):
        ga, ca = args if isinstance(args[0], tuple) else ((args[0],),
                                                          (args[1],))
        got = call(*ga)
        on_card(got)
        errs[name] = _rel(got.asnumpy(), call(*ca).asnumpy())
        ms[name] = card_ms(lambda: call(*ga))
    sign_g, logdet_g = nd.linalg_slogdet(sg)
    sign_c, logdet_c = nd.linalg_slogdet(sc)
    on_card(sign_g, logdet_g)
    errs["slogdet"] = _rel(logdet_g.asnumpy(), logdet_c.asnumpy()) + float(
        np.abs(sign_g.asnumpy() - sign_c.asnumpy()).max())
    ms["slogdet"] = card_ms(lambda: nd.linalg_slogdet(sg))
    lq_g, lq_c = nd.linalg_gelqf(mg), nd.linalg_gelqf(mc)
    on_card(*lq_g)
    lg64 = [t.asnumpy().astype(np.float64) for t in lq_g]
    errs["gelqf |L|, |Q|"] = max(
        _rel(np.abs(g), np.abs(c.asnumpy())) for g, c in zip(lg64, lq_c))
    errs["gelqf L Q = A"] = _rel(lg64[0] @ lg64[1], gen)
    errs["gelqf Q Q^T = I"] = float(np.abs(
        lg64[1] @ lg64[1].transpose(0, 2, 1) - np.eye(n)).max())
    ms["gelqf"] = card_ms(lambda: nd.linalg_gelqf(mg))
    ev_g, ev_c = nd.linalg_syevd(sg), nd.linalg_syevd(sc)
    on_card(*ev_g)
    u, lam = (t.asnumpy().astype(np.float64) for t in ev_g)
    lam_c = ev_c[1].asnumpy().astype(np.float64)
    errs["syevd eigenvalues"] = _rel(lam, lam_c)
    # an eigenvector is determined up to sign only where its eigenvalue
    # stands apart: the rows whose gap to both neighbours exceeds
    # OPLIB_EIG_GAP (B B^T's spectrum crowds near its lower end)
    gaps = np.diff(lam_c, axis=-1)
    apart = np.minimum(np.pad(gaps, ((0, 0), (1, 0)), constant_values=np.inf),
                       np.pad(gaps, ((0, 0), (0, 1)),
                              constant_values=np.inf)) > OPLIB_EIG_GAP
    dots = np.abs(np.einsum("bij,bij->bi", u, ev_c[0].asnumpy().astype(
        np.float64)))
    errs[f"syevd rows up to sign ({int(apart.sum())} of {apart.size} "
         "apart)"] = float(np.abs(1.0 - dots[apart]).max())
    errs["syevd U^T diag(L) U = A"] = _rel(
        u.transpose(0, 2, 1) @ (lam[..., None] * u), spd)
    ms["syevd"] = card_ms(lambda: nd.linalg_syevd(sg))
    report(f"linalg ({nb} x {n} x {n} f32)", errs, OPLIB_LINALG_RTOL, ms)
    torch.cuda.synchronize(dev)
    launches = read_launches("op library full width", {})
    wall = time.perf_counter() - t0
    print(f"phase 33 op library at full width: {wall:.1f} s of wall time; "
          f"launches {launches}", flush=True)
    if bad:
        fail("op library full width: " + "; ".join(bad))
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phases 26-28: the LLM extras (generate, the blocked cross-entropy, the
# Transformer and the samplers)
# ----------------------------------------------------------------------

# phase 26a: bench.py's _bench_decode configuration, nothing cut
GEN_CFG = dict(vocab_size=32000, hidden_size=1024, num_layers=8,
               num_heads=16, num_kv_heads=8, intermediate_size=2816,
               max_seq_len=512)
GEN_BATCH, GEN_PREFIX, GEN_NEW, GEN_REPS = 8, 32, 96, 3
# the teacher-forced forward (K3, 3xTF32) and generate's cached steps
# (plain f32 attention) give logits about 1e-5 apart at these random
# weights' magnitudes (|logit| ~ 1): a position whose top-2 margin
# exceeds 1e-3 must pick the same token
GEN_MARGIN = 1e-3
# phase 26b: on phase 4's net
GEN8B = dict(batch=4, prefix=32, new=32)
# phase 27: Llama-3-8B's head
CE_SHAPE = dict(N=8192, d=4096, V=128256, block=2048)
CE_IGNORE = -100
# of the largest magnitude: the loss and dx are f32 sums over 128256
# logits in two orders; dW is rounded to bf16 on both paths (one ulp)
CE_TOL = {"loss": 1e-5, "dx": 1e-4, "dw": 2 ** -8}
CE_REPS = 3
# phases 12, 14 and 16's limit on each parameter's update
FUSED_UPDATE_RTOL = 1e-3
# phase 28: the narrow Transformer (card against CPU) and the full one
MT_NARROW = dict(src_vocab_size=1000, num_layers=2, units=64,
                 hidden_size=256, num_heads=4, max_length=64, dropout=0.0,
                 prefix="mt_")
MT_BATCH, MT_LEN, MT_WARMUP, MT_STEPS = 64, 64, 3, 10
MT_BEAM, MT_SOURCES, MT_MAX_LEN, MT_EOS = 4, 8, 32, 2
MT_SCORE_ATOL = 1e-4
MT_LOGIT_TOL = 1e-4
# an Adam step moves a key bias (zero gradient in exact arithmetic) by
# up to lr either way on each device
MT_KEY_BIAS_ATOL = 2e-3


def gen8b_prompts(vocab):
    import numpy as np
    return np.random.RandomState(26).randint(
        0, vocab, (GEN8B["batch"], GEN8B["prefix"]))


def update_errs_dev(w0, got, want, steps):
    """``update_errs`` on device tensors, parameter by parameter (the
    host would hold three copies of a 1.92 G-parameter model)."""
    import torch
    out = {}
    for k in w0:
        du = want[k] - w0[k]
        mag = torch.maximum(torch.maximum(w0[k].abs(), got[k].abs()),
                            want[k].abs())
        ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
        diff = (((got[k] - w0[k]) - du).abs() - steps * ulp).clamp_min(0)
        out[k] = float(diff.norm()) / max(float(du.norm()), 1e-30)
    return out


def busy_by_class(prof, calls, classes=BUSY_CLASSES):
    """(busy ms a call, {class: ms a call}) of a profile over ``calls``
    calls (first match by name, else "other")."""
    import torch
    busy = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy[e.key] = busy.get(e.key, 0.0) + \
                e.self_device_time_total / 1e3 / calls
    by = {}
    for name, ms in busy.items():
        cls = next((c for c, keys in classes if any(
            k in name for k in keys)), "other")
        by[cls] = round(by.get(cls, 0.0) + ms, 3)
    return sum(busy.values()), by


def generate_decode(dev, card):
    """Phase 26a (module doc)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import nd, ops
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import (LlamaConfig,
                                                           LlamaForCausalLM)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = LlamaConfig(**GEN_CFG)
    net = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                            (GEN_BATCH, GEN_PREFIX))
    steps = GEN_PREFIX + GEN_NEW
    ops.reset_launches()
    t0 = time.perf_counter()
    out = net.generate(toks, GEN_NEW)
    torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    wall = []
    for _ in range(GEN_REPS):
        t = time.perf_counter()
        out = net.generate(toks, GEN_NEW)
        torch.cuda.synchronize(dev)
        wall.append(time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        net.generate(toks, GEN_NEW)
        torch.cuda.synchronize(dev)
    busy_ms, by = busy_by_class(prof, 1)
    stats = net.generate_stats()
    if stats["captures"] != 1 or stats["graphs"] != 1:
        fail(f"generate: {stats} for one signature, expected one graph")
    gen = out.asnumpy()
    if gen.shape != (GEN_BATCH, steps) or gen.dtype != np.int32 or not \
            np.array_equal(gen[:, :GEN_PREFIX], toks):
        fail(f"generate returned {gen.dtype} {gen.shape} without its prefix")
    # the reference test's rule at full width: a teacher-forced forward
    # over the generated sequence picks generate's tokens
    logits = net(nd.array(gen, ctx=dev, dtype="int32")).data.float()
    top2 = torch.topk(logits[:, GEN_PREFIX - 1:steps - 1], 2, dim=-1)
    margin = top2.values[..., 0] - top2.values[..., 1]
    differ = top2.indices[..., 0] != torch.from_numpy(
        gen[:, GEN_PREFIX:]).to(dev)
    above = margin > GEN_MARGIN
    wrong = int((differ & above).sum())
    # sampling: one seed twice through replays, and three other seeds
    sampled = [net.generate(toks, GEN_NEW, temperature=1.0, seed=s)
               .asnumpy() for s in (0, 0, 1, 2, 3)]
    torch.cuda.synchronize(dev)
    launches = read_launches("generate", {
        "flash_attention_fwd": cfg.num_layers})
    stats = net.generate_stats()
    step_ms = statistics.median(wall) * 1e3
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"generate at bench.py's decode configuration (vocab "
          f"{cfg.vocab_size}, hidden {cfg.hidden_size}, {cfg.num_layers} "
          f"layers, {cfg.num_heads}/{cfg.num_kv_heads} heads, f32) on "
          f"{card}: batch {GEN_BATCH}, prefix {GEN_PREFIX}, {GEN_NEW} new "
          f"tokens, greedy: first call {first_s:.3f} s (capture "
          f"{stats['capture_seconds']:.3f} s); call median "
          f"{step_ms:.2f} ms over {GEN_REPS} (min {min(wall) * 1e3:.2f}) = "
          f"{GEN_BATCH * steps / step_ms * 1e3:.1f} tokens/s over all "
          f"{steps} scanned positions, {step_ms / steps:.4f} ms a step; "
          f"device busy {busy_ms:.3f} ms a call (profiler), host share "
          f"{1 - busy_ms / step_ms:.4f}; device ms a call by class {by}; "
          f"peak memory {peak_gb:.3f} GB; teacher-forced forward against "
          f"the {GEN_NEW * GEN_BATCH} generated tokens: smallest top-2 "
          f"margin {float(margin.min()):.3e}, "
          f"{int((~above).sum())} positions at or below {GEN_MARGIN} "
          f"({int((differ & ~above).sum())} of them picked otherwise), "
          f"{wrong} above it picked otherwise; captures {stats['captures']}"
          f" (greedy and temperature 1.0); launches {launches}",
          flush=True)
    if wrong:
        fail(f"generate: {wrong} tokens differ from the teacher-forced "
             f"forward's pick above the {GEN_MARGIN} margin")
    if not np.array_equal(sampled[0], sampled[1]) or all(
            np.array_equal(sampled[0], s) for s in sampled[2:]):
        fail("generate at temperature 1.0: seed 0 twice differs, or seeds "
             "1-3 all give seed 0's tokens")
    if stats["captures"] != 2:
        fail(f"generate: {stats['captures']} captures for two signatures")
    del net, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def generate_llama3_8b(dev, card, net, ref):
    """Phase 26b (module doc); ``ref`` holds phase 4's engine streams for
    the same prompts."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import ops
    prompts = gen8b_prompts(net.cfg.vocab_size)
    ops.reset_launches()
    times = {}
    outs = {}
    for label, graphs in (("first", True), ("replay", True),
                          ("eager", False)):
        net._generate_graphs = graphs
        t = time.perf_counter()
        outs[label] = net.generate(prompts, GEN8B["new"]).asnumpy()
        times[label] = time.perf_counter() - t
    net._generate_graphs = True
    launches = ops.launch_counts()
    stats = net.generate_stats()
    del net._generate_cache          # its graph holds the bf16 weights
    gc.collect()
    torch.cuda.empty_cache()
    gen = [o[:, GEN8B["prefix"]:] for o in outs.values()]
    same = [int(np.sum(np.asarray(r) == g)) for r, g in
            zip(ref["gen_streams"], gen[0])]
    first = [next((i for i, (a, b) in enumerate(zip(r, g)) if a != b), None)
             for r, g in zip(ref["gen_streams"], gen[0])]
    print(f"generate on phase 4's net (llama3_8b bf16, 32 layers) on "
          f"{card}: batch {GEN8B['batch']}, prefix {GEN8B['prefix']}, "
          f"{GEN8B['new']} new tokens, greedy: first call (capture "
          f"{stats['capture_seconds']:.3f} s) {times['first']:.3f} s, "
          f"replayed {times['replay']:.3f} s, eager body "
          f"{times['eager']:.3f} s; replayed tokens equal the eager body's:"
          f" {np.array_equal(outs['first'], outs['eager'])}; against phase "
          f"4's engine streams (not held): {same} of {GEN8B['new']} tokens "
          f"equal, first difference at {first}; launches {launches}",
          flush=True)
    if any(launches.values()):
        fail(f"generate on phase 4's net launched {launches}")
    if stats["captures"] != 1:
        fail(f"generate on phase 4's net: {stats['captures']} captures")
    if not (np.array_equal(outs["first"], outs["eager"]) and
            np.array_equal(outs["replay"], outs["eager"])):
        fail("generate on phase 4's net: replays differ from the eager body")
    return launches


def _ce_paths(x, w, t):
    """The blocked path and the materialized one, each a function that
    runs the forward and the backward of the summed losses and returns
    (loss, dx, dW)."""
    import torch
    from mxnet_tpu_torch.ops import fused_linear_cross_entropy
    V = w.shape[1]

    def run(loss_of):
        xr = x.detach().requires_grad_(True)
        wr = w.detach().requires_grad_(True)
        loss = loss_of(xr, wr)
        loss.sum().backward()
        return loss.detach(), xr.grad, wr.grad

    def blocked(xr, wr):
        return fused_linear_cross_entropy(xr, wr, t, CE_SHAPE["block"],
                                          CE_IGNORE)

    def plain(xr, wr):
        lp = torch.log_softmax(xr @ wr.float(), dim=-1)
        valid = (t >= 0) & (t < V) & (t != CE_IGNORE)
        return torch.where(valid, -lp.gather(1, t.clamp(0, V - 1)[:, None])
                           [:, 0], 0.0)

    return {"blocked": lambda: run(blocked), "materialized": lambda: run(plain)}


def blocked_ce_op(dev, card):
    """Phase 27's op part (module doc)."""
    import torch
    N, d, V = CE_SHAPE["N"], CE_SHAPE["d"], CE_SHAPE["V"]
    gen = torch.Generator(device=dev).manual_seed(27)
    x = torch.randn(N, d, generator=gen, device=dev)
    # the head as fused_ce_loss hands it over: a (V, d) bf16 parameter,
    # transposed
    w = (torch.randn(V, d, generator=gen, device=dev) * 0.02) \
        .to(torch.bfloat16).T
    t = torch.randint(0, V, (N,), generator=gen, device=dev)
    t[:64] = CE_IGNORE
    t[64:96] = V
    t[96:128] = -1
    paths = _ce_paths(x, w, t)
    res, peak = {}, {}
    for name, fn in paths.items():
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        res[name] = fn()
        torch.cuda.synchronize(dev)
        peak[name] = torch.cuda.max_memory_allocated(dev) - base
    errs = {}
    for key, got, want in zip(("loss", "dx", "dw"), res["blocked"],
                              res["materialized"]):
        errs[key] = float((got.float() - want.float()).abs().max() /
                          want.float().abs().max().clamp_min(1e-30))
    dead = res["blocked"][0][:128]
    del res
    torch.cuda.empty_cache()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    ms = interleaved_ms(paths, CE_REPS, flush)
    del flush, paths
    logit_bytes = N * V * 4
    print(f"blocked cross-entropy at Llama-3-8B's head (N {N}, d {d}, V "
          f"{V}, f32 activations, bf16 head, block {CE_SHAPE['block']}, "
          f"128 targets ignored or out of range) on {card}: forward and "
          f"backward {statistics.median(ms['blocked']):.2f} ms blocked, "
          f"{statistics.median(ms['materialized']):.2f} ms materialized "
          f"(medians of {CE_REPS}, in turns); peak above the inputs "
          f"{peak['blocked'] / 1e9:.3f} GB blocked, "
          f"{peak['materialized'] / 1e9:.3f} GB materialized, the f32 "
          f"logits {logit_bytes / 1e9:.3f} GB; errors of the largest "
          f"magnitude {errs} (limits {CE_TOL})", flush=True)
    if not all(errs[k] <= CE_TOL[k] for k in CE_TOL):
        fail(f"blocked cross-entropy against the materialized path: {errs}")
    if not peak["blocked"] < logit_bytes:
        fail("blocked cross-entropy: peak memory above the logits' bytes")
    if bool((dead != 0).any()):
        fail("blocked cross-entropy: an ignored target has a loss")


def blocked_ce_training(dev, card):
    """Phase 27's training part (module doc)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import autograd, nd, ops
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import llama3_8b
    rng = np.random.RandomState(0)
    vocab = CE_SHAPE["V"]
    tokens, labels = (nd.array(rng.randint(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ)), ctx=dev) for _ in range(2))
    loss_fn = SoftmaxCrossEntropyLoss()
    ops.reset_launches()
    runs, w0 = {}, None
    for path in ("fused", "logits"):
        gc.collect()
        torch.cuda.empty_cache()
        base, held = torch.cuda.memory_allocated(dev), 0
        torch.cuda.reset_peak_memory_stats(dev)
        net = llama3_8b(device=dev, dtype=torch.float32, seed=0,
                        num_layers=TRAIN_LAYERS)
        if w0 is None:          # the first weights, kept for the updates
            w0 = {k: p.data().data.detach().clone() for k, p in
                  net._collect_params_with_prefix().items()}
            held = sum(v.numel() * 4 for v in w0.values())
        trainer = Trainer(net.collect_params(), "adamw",
                          {"learning_rate": 1e-3, "wd": 0.1})
        losses, step_s = [], []
        for _ in range(2):
            t = time.perf_counter()
            with autograd.record():
                if path == "fused":
                    loss = net.fused_ce_loss(
                        tokens, labels, block=CE_SHAPE["block"]).mean()
                else:
                    loss = loss_fn(net(tokens), labels).mean()
            loss.backward()
            if not losses:      # the activations' peak, before the
                # first update builds the Trainer's flat buffers
                fb_peak = (torch.cuda.max_memory_allocated(dev) - base -
                           held) / 1e9
            trainer.step(1)
            losses.append(float(loss.asscalar()))
            step_s.append(time.perf_counter() - t)
        torch.cuda.synchronize(dev)
        peak = (torch.cuda.max_memory_allocated(dev) - base - held) / 1e9
        runs[path] = (losses, step_s, (fb_peak, peak), {
            k: p.data().data.detach().clone()
            for k, p in net._collect_params_with_prefix().items()})
        del net, trainer, loss
    launches = read_launches("training fused ce", {
        "flash_attention_fwd": 4 * TRAIN_LAYERS,
        "flash_attention_bwd": 4 * TRAIN_LAYERS, "fused_adam_update": 4})
    (lf, sf, pf, wf), (ll, sl, pl, wl) = runs["fused"], runs["logits"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lf, ll))
    upd = update_errs_dev(w0, wf, wl, 2)
    worst = sorted(upd.items(), key=lambda kv: -kv[1])[:3]
    print(f"training fused ce, phase 8's model (llama3_8b width, "
          f"{TRAIN_LAYERS} layers, f32, adamw, batch {TRAIN_BATCH}x"
          f"{TRAIN_SEQ}) on {card}: 2 steps on fused_ce_loss(block "
          f"{CE_SHAPE['block']}).mean() losses {lf}, steps "
          f"{[round(s * 1e3, 1) for s in sf]} ms, peak above the held "
          f"weights through the first backward {pf[0]:.2f} GB, over both "
          f"steps {pf[1]:.2f} GB; 2 steps on SoftmaxCrossEntropyLoss of "
          f"the logits losses {ll}, steps {[round(s * 1e3, 1) for s in sl]}"
          f" ms, peaks {pl[0]:.2f} and {pl[1]:.2f} GB; max relative loss "
          f"diff {loss_err:.3e} "
          f"(limit {TRAIN_LOSS_RTOL}), worst relative update diffs {worst} "
          f"(limit {FUSED_UPDATE_RTOL}); launches {launches}", flush=True)
    if not (loss_err <= TRAIN_LOSS_RTOL and
            worst[0][1] <= FUSED_UPDATE_RTOL):
        fail("training on fused_ce_loss and on the logits path disagree")
    del runs, w0, wf, wl
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def mt_step(net):
    """A beam-search step over ``net`` (a ``TransformerModel``) that
    re-decodes the whole prefix (the model keeps no incremental state):
    states hold the memory, its (n, 1, Ls) mask and the tokens so far;
    returns the last position's log-probs."""
    import torch
    from mxnet_tpu_torch.ndarray import NDArray

    def raw(x):
        return x.data if isinstance(x, NDArray) else x

    def step(step_input, states):
        prefix = torch.cat([raw(states["prefix"]),
                            raw(step_input).to(torch.int32)[:, None]], 1)
        logits = net.decode(NDArray(prefix), NDArray(raw(states["mem"])),
                            None, NDArray(raw(states["mask"])))
        lp = torch.log_softmax(logits.data[:, -1].float(), dim=-1)
        return NDArray(lp), dict(states, prefix=prefix)
    return step


def mt_states(net, src, vl):
    """The beam search's first states: the encoder's memory of ``src``
    (NDArrays) masked by the valid lengths ``vl``."""
    import torch
    from mxnet_tpu_torch.ndarray import NDArray
    lk = src.shape[1]
    keep = (torch.arange(lk, device=src.data.device)[None, None, :] <
            vl.data[:, None, None]).float()
    mem = net.encode(src, NDArray(keep.expand(src.shape[0], lk, lk)))
    return {"mem": mem, "mask": NDArray(keep),
            "prefix": torch.zeros((src.shape[0], 0), dtype=torch.int32,
                                  device=src.data.device)}


def beam_search(net, src, vl, beam, max_length, margins=None):
    """``BeamSearchSampler`` over ``mt_step``; with ``margins`` (a list)
    each selection's smallest gap between the kept k-th and the first
    dropped candidate is appended.  Returns (samples, scores, lengths)
    as tensors and the steps' wall seconds."""
    import torch
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BeamSearchSampler
    from mxnet_tpu_torch.gluon.model_zoo.nlp import sampler as smp
    from mxnet_tpu_torch.ndarray import NDArray
    topk = smp._topk

    def margin_topk(x, k):
        vals, idx = topk(x, k + 1)
        live = vals[..., k - 1] > -1e17
        if bool(live.any()):
            margins.append(float((vals[..., k - 1] - vals[..., k])[live]
                                 .min()))
        return vals[..., :k], idx[..., :k]

    sampler = BeamSearchSampler(beam, mt_step(net), eos_id=MT_EOS,
                                max_length=max_length)
    first = NDArray(torch.full((src.shape[0],), 1, dtype=torch.int32,
                               device=src.data.device))
    with contextlib.ExitStack() as stack:
        if margins is not None:
            stack.enter_context(_swapped(smp, "_topk", margin_topk))
        t = time.perf_counter()
        out = sampler(first, mt_states(net, src, vl))
        res = [o.data for o in out]
        if res[0].is_cuda:
            torch.cuda.synchronize(res[0].device)
    return res, time.perf_counter() - t


def gnmt_scores(net, src, vl, samples, lengths, beam):
    """The GNMT-penalized sum of the model's own log-probs along each
    returned sequence (one teacher-forced decode of all of them): the
    sum of log p(token j | tokens < j) over j < length, over lp(length
    - 1), BeamSearchScorer's default alpha 1 and K 5."""
    import torch
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BeamSearchScorer
    from mxnet_tpu_torch.ndarray import NDArray
    b, k, L = samples.shape
    seq = samples.reshape(b * k, L).to(torch.int32)
    states = mt_states(net, src, vl)
    mem = states["mem"].data.repeat_interleave(beam, dim=0)
    mask = states["mask"].data.repeat_interleave(beam, dim=0)
    logits = net.decode(NDArray(seq[:, :-1]), NDArray(mem), None,
                        NDArray(mask)).data
    lp = torch.log_softmax(logits.float(), dim=-1).gather(
        2, seq[:, 1:, None].long())[..., 0]
    n = lengths.reshape(-1).long() - 1
    keep = torch.arange(L - 1, device=lp.device)[None, :] < n[:, None]
    penalty = BeamSearchScorer()._lp(n.double()).float()
    return ((lp * keep).sum(1) / penalty).reshape(b, k)


def transformer_card_vs_cpu(dev):
    """Phase 28's card-against-CPU part (module doc)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, ops
    from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                         load_block_weights)
    from mxnet_tpu_torch.gluon.model_zoo.nlp import TransformerModel
    vocab = MT_NARROW["src_vocab_size"]
    rng = np.random.RandomState(28)
    host = {"src": rng.randint(0, vocab, (8, 24)),
            "tgt": rng.randint(0, vocab, (8, 20)),
            "label": rng.randint(0, vocab, (8, 20)),
            "vl": rng.randint(4, 25, 8).astype(np.float32)}
    weights, runs, launches = None, [], None
    for ctx in (mx.gpu(dev.index or 0), mx.cpu()):
        net = TransformerModel(**MT_NARROW)
        mx.random.seed(28)
        net.initialize(ctx=ctx)
        with ctx:
            src, tgt, label = (mx.nd.array(host[k], dtype="int32")
                               for k in ("src", "tgt", "label"))
            vl = mx.nd.array(host["vl"])
        if weights is None:
            net(src, tgt, vl)
            weights = block_weights_to_numpy(net)
        load_block_weights(net, weights)
        if ctx.device_type == "gpu":
            torch.cuda.synchronize(dev)
            ops.reset_launches()
        logits = net(src, tgt, vl).asnumpy()
        margins = []
        beam, _ = beam_search(net, src[:4], vl[:4], MT_BEAM, 16, margins)
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                net(src, tgt, vl), label)
        loss.backward()
        trainer.step(8)
        if ctx.device_type == "gpu":
            torch.cuda.synchronize(dev)
            launches = read_launches("transformer card vs cpu",
                                     {"fused_adam_update": 1})
        runs.append((logits, [b.cpu() for b in beam], margins,
                     block_weights_to_numpy(net)))
        del net, trainer
    logit_err = float(np.abs(runs[0][0] - runs[1][0]).max())
    upd = update_errs(weights, runs[0][3], runs[1][3], 1)
    noise = [k for k in weights if k.endswith("proj_key.bias")]
    upd_err = max(v for k, v in upd.items() if k not in noise)
    noise_err = max(float(np.abs(runs[0][3][k] - runs[1][3][k]).max())
                    for k in noise)
    (s0, sc0, l0), (s1, sc1, l1) = runs[0][1], runs[1][1]
    same = bool(torch.equal(s0, s1) and torch.equal(l0, l1))
    score_err = float((sc0 - sc1).abs().max())
    print(f"transformer card vs cpu (2 + 2 layers, {MT_NARROW['units']} "
          f"units, {MT_NARROW['num_heads']} heads, vocab {vocab}, f32, "
          f"8 x 24 sources, valid lengths {host['vl'].astype(int).tolist()})"
          f": max |logit| diff {logit_err:.3e} (limit {MT_LOGIT_TOL}); one "
          f"adam step: worst relative update diff {upd_err:.3e} (limit "
          f"{FUSED_UPDATE_RTOL}) but the key biases, {noise_err:.3e} (limit "
          f"{MT_KEY_BIAS_ATOL}); beam search (beam {MT_BEAM}, 4 sources, "
          f"max_length 16): samples and lengths identical {same}, max score"
          f" diff {score_err:.3e} (limit {MT_SCORE_ATOL}), smallest top-k "
          f"margin card {min(runs[0][2]):.3e} cpu {min(runs[1][2]):.3e}; "
          f"launches {launches}", flush=True)
    if not (logit_err <= MT_LOGIT_TOL and upd_err <= FUSED_UPDATE_RTOL and
            noise_err <= MT_KEY_BIAS_ATOL and same and
            score_err <= MT_SCORE_ATOL):
        fail("the Transformer on the card and on the CPU disagree")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def transformer_training(dev, card):
    """Phase 28's full-width part (module doc)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, ops
    from mxnet_tpu_torch.gluon.model_zoo.nlp import transformer_en_de_512
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    net = transformer_en_de_512(prefix="mt512_")
    vocab = net._tgt_vocab_size
    mx.random.seed(0)
    net.initialize(ctx=mx.gpu(dev.index or 0))
    net.hybridize()
    rng = np.random.RandomState(28)
    with mx.gpu(dev.index or 0):
        src, tgt, label = (mx.nd.array(rng.randint(0, vocab, (MT_BATCH,
                                                             MT_LEN)),
                                       dtype="int32") for _ in range(3))
        vl = mx.nd.array(rng.randint(MT_LEN // 4, MT_LEN + 1, MT_BATCH)
                         .astype(np.float32))
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-4})

    def step():
        with autograd.record():
            loss = ce(net(src, tgt, vl), label)
        loss.backward()
        trainer.step(MT_BATCH)
        return loss.mean()

    losses = [step() for _ in range(MT_WARMUP)]
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    n_params = sum(p.data().size for p in net.collect_params().values()
                   if p.grad_req != "null")
    ops.reset_launches()
    cached0 = cached_stats(net, "transformer training")
    step_s = []
    for _ in range(MT_STEPS):
        t = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t)
    cached = cached_stats(net, "transformer training")
    check_replays("transformer training", cached0, cached, MT_STEPS)
    launches = read_launches("transformer training",
                             {"fused_adam_update": MT_STEPS})
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize(dev)
    busy_ms, by = busy_by_class(prof, 2)
    losses = [float(x.asscalar()) for x in losses]
    step_ms = statistics.median(step_s) * 1e3
    print(f"transformer training, transformer_en_de_512 (6 + 6 layers, 512 "
          f"units, 2048 hidden, 8 heads, vocab {vocab}, shared and tied "
          f"embeddings, dropout 0.1), {n_params} params, f32, adam lr 1e-4,"
          f" {MT_BATCH} x {MT_LEN} source and target tokens, valid lengths "
          f"{MT_LEN // 4}-{MT_LEN}, on {card}: losses {losses}; step median "
          f"{step_ms:.2f} ms over {MT_STEPS} after {MT_WARMUP} warm-up (min "
          f"{min(step_s) * 1e3:.2f}, max {max(step_s) * 1e3:.2f}) = "
          f"{MT_BATCH * MT_LEN / step_ms * 1e3:.1f} target tokens/s; peak "
          f"memory {peak_gb:.2f} GB; set-up and warm-up {setup_s:.2f} s; "
          f"device busy {busy_ms:.3f} ms a step (profiler, 2 steps), host "
          f"share {1 - busy_ms / step_ms:.4f}; device ms a step by class "
          f"{by}; launches {launches}; CachedOp {cached}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"transformer training: non-finite loss {losses}")
    # beam search on the trained net, its scores against the model's own
    # log-probs
    (samples, scores, lengths), wall = beam_search(
        net, src[:MT_SOURCES], vl[:MT_SOURCES], MT_BEAM, MT_MAX_LEN)
    steps = samples.shape[-1] - 1
    want = gnmt_scores(net, src[:MT_SOURCES], vl[:MT_SOURCES], samples,
                       lengths, MT_BEAM)
    err = float((scores - want).abs().max())
    print(f"beam search on it (beam {MT_BEAM}, {MT_SOURCES} sources, "
          f"max_length {MT_MAX_LEN}, each step re-decodes the prefix): "
          f"{steps} steps in {wall:.3f} s = {wall / steps * 1e3:.2f} ms a "
          f"step; lengths {sorted(set(lengths.reshape(-1).tolist()))}; "
          f"scores {float(scores.min()):.4f} to {float(scores.max()):.4f}, "
          f"max diff from the GNMT-penalized sum of the model's log-probs "
          f"{err:.3e} (limit {MT_SCORE_ATOL})", flush=True)
    if not err <= MT_SCORE_ATOL:
        fail("beam search: a score is not its sequence's penalized "
             "log-prob")
    del net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phases 34-36: quantized training, row-sparse gradients and the contrib
# ops at full width
# ----------------------------------------------------------------------

# BERT-base's Dense products at bench.py's batch (64 x 128 tokens):
# (label, M, K, N) of x (M, K) @ W^T (K, N)
QUANT_SHAPES = (("ffn_1", 8192, 768, 3072), ("ffn_2", 8192, 3072, 768),
                ("pooler", 64, 768, 768), ("classifier", 64, 768, 2))
# cuBLASLt's fp8 GEMM (e4m3) accumulates the tensor cores' partial sums
# in reduced precision before it promotes them to f32; the e5m2 route
# (bf16 codes, f32 output) sums exact products in another order than the
# plain f32 product
QUANT_FP8_RTOL = 1e-3
# phase 34c: the narrow BERT in f32, two SGD steps, card against CPU.
# The card's e4m3 products sit 1.3e-4 of the norm from the CPU's exact
# f32 sums (phase 34a), and each layer quantizes its input again to e4m3
# (steps of 1/16 to 1/8 of a value): an activation that close to a
# rounding boundary takes the neighbouring code, so the losses move by
# about 1% and the updates by about 0.1 of their norm; a CPU run with
# that noise put into its products moves as far
# (tools/port_fp8_accum_noise.py).  SGD, whose update is linear in the
# gradient: Adam's sign-like first steps turn the same noise into 0.3
QUANT_NARROW_LOSS_RTOL = 5e-2
QUANT_NARROW_UPDATE_RTOL = 0.25
QUANT_NARROW = dict(num_layers=2, units=256, hidden_size=1024, num_heads=4,
                    vocab_size=2000, max_length=64, dropout=0.0,
                    use_flash=True, use_decoder=False)


def _draws(seed0):
    """A uniform draw of each operand's shape and salt from a generator
    seeded by them on the operand's device: the quantized product and its
    plain version see the same draws."""
    import torch

    def uniform(x, salt):
        g = torch.Generator(device=x.device)
        g.manual_seed(seed0 + salt * 1_000_003 + x.numel())
        return torch.rand(x.shape, generator=g, device=x.device)
    return uniform


def plain_qmm(a, b, mode, uniform, grad_side=False):
    """The plain version of one quantized product on the card: the same
    scales, draws and codes as ``ops.quant_matmul``'s, then the codes
    widened (int8 to float64, exact for these sums; fp8 to f32) for one
    product without TF32, and the same rescale."""
    import torch
    from mxnet_tpu_torch.ops import quant_matmul as qm
    if mode == "int8":
        sa, sb = qm._amax_scale(a, 127.0), qm._amax_scale(b, 127.0)
        qa = qm._sr_cast_int8(a.float() / sa, uniform(a, 0))
        qb = qm._sr_cast_int8(b.float() / sb, uniform(b, 1))
        acc = qa.double() @ qb.double()
        return acc.float() * (sa * sb)
    qmax = qm.FP8_GRAD_MAX if grad_side else qm.FP8_MAX
    fp8 = torch.float8_e5m2 if grad_side else torch.float8_e4m3fn
    sa, sb = qm._amax_scale(a, qmax), qm._amax_scale(b, qmax)
    qa = torch.clamp(a.float() / sa, -qmax, qmax).to(fp8)
    qb = torch.clamp(b.float() / sb, -qmax, qmax).to(fp8)
    return (qa.float() @ qb.float()) * (sa * sb)


def _norm_rel(got, want):
    import torch
    den = float(torch.linalg.norm(want.double()))
    return float(torch.linalg.norm((got - want).double())) / max(den, 1e-30)


def quant_ops(dev, card):
    """Phase 34a: ``ops.quant_matmul`` at BERT-base's Dense shapes at
    ``bench.py``'s batch (``QUANT_SHAPES``: the FFN's (8192, 768) x (768,
    3072) and (8192, 3072) x (3072, 768), the pooler (64, 768, 768), the
    classifier's N = 2), int8 and fp8, the forward and both gradients
    against ``plain_qmm`` on the card with the same draws: int8 bitwise
    (int32 accumulation is exact), fp8 within ``QUANT_FP8_RTOL`` of the
    norm.  Prints each quantized forward's time (quantization included,
    and the library GEMM alone) beside ``torch.matmul``'s bf16 product at
    the same shape.  No kernel of the port runs."""
    import torch
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.ops import quant_matmul as qm
    ops.reset_launches()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(34)
    worst = {"int8": 0.0, "fp8": 0.0}
    for label, M, K, N in QUANT_SHAPES:
        a = torch.randn(M, K, device=dev, generator=g)
        w = torch.randn(N, K, device=dev, generator=g) * K ** -0.5
        dy = torch.randn(M, N, device=dev, generator=g)
        b = w.t()
        for mode in ("int8", "fp8"):
            uniform = _draws(M * 7 + K * 3 + N + (mode == "fp8"))
            ta = a.clone().requires_grad_()
            tb = b.detach().clone().requires_grad_()
            y = qm.quant_matmul(ta, tb, compute_dtype=mode, uniform=uniform)
            y.backward(dy)
            got = (y.detach(), ta.grad, tb.grad)
            want = (plain_qmm(a, b, mode, uniform),
                    plain_qmm(dy, b.t(), mode, uniform, grad_side=True),
                    plain_qmm(a.t(), dy, mode, uniform, grad_side=True))
            errs = [_norm_rel(x, y_) for x, y_ in zip(got, want)]
            if mode == "int8":
                same = [torch.equal(x, y_) for x, y_ in zip(got, want)]
                if not all(same):
                    fail(f"phase 34 int8 {label}: not bitwise the plain "
                         f"version (y, da, db equal: {same}; relative "
                         f"{errs})")
            elif max(errs) > QUANT_FP8_RTOL:
                fail(f"phase 34 fp8 {label}: relative {errs} above "
                     f"{QUANT_FP8_RTOL}")
            worst[mode] = max(worst[mode], max(errs))
            with torch.no_grad():
                sa, sb = (qm._amax_scale(t, 127.0 if mode == "int8"
                                         else qm.FP8_MAX) for t in (a, b))
                if mode == "int8":
                    qa = qm._sr_cast_int8(a / sa, uniform(a, 0))
                    qb = qm._sr_cast_int8(b / sb, uniform(b, 1))
                else:
                    qa = (a / sa).clamp(-448, 448).to(torch.float8_e4m3fn)
                    qb = (b / sb).clamp(-448, 448).to(torch.float8_e4m3fn)
                ab, bb = a.bfloat16(), b.bfloat16()
                times = interleaved_ms({
                    "quant": lambda: qm.quant_matmul(
                        a, b, compute_dtype=mode, uniform=uniform),
                    "gemm": (lambda: qm._int8_product(qa, qb)) if
                    mode == "int8" else
                    (lambda: qm._fp8_product(qa, qb, sa, sb)),
                    "bf16": lambda: torch.matmul(ab, bb)}, 10, flush)
            ms = {k: statistics.median(v) for k, v in times.items()}
            print(f"phase 34 {mode} {label} ({M}, {K}) x ({K}, {N}) on "
                  f"{card}: forward {ms['quant']:.4f} ms with its "
                  f"quantization (library GEMM alone {ms['gemm']:.4f} ms) "
                  f"beside torch.matmul bf16 {ms['bf16']:.4f} ms; y, da, "
                  f"db relative to the plain version {errs}"
                  + (" (bitwise)" if mode == "int8" else ""), flush=True)
    del flush
    torch.cuda.empty_cache()
    print(f"phase 34 quantized products: int8 bitwise at every shape, fp8 "
          f"worst relative {worst['fp8']:.3g} (limit {QUANT_FP8_RTOL})",
          flush=True)
    return read_launches("phase 34 products", {})


def quant_bert_card_vs_cpu(dev):
    """Phase 34c: a narrow BERT (``QUANT_NARROW``: 2 layers of 256 units,
    batch 8 x 64) in f32 with every Dense in fp8 (deterministic on each
    device), two SGD steps (lr 0.1) through ``gluon.Trainer`` from the
    same weights on the card and on the CPU: mean losses within
    ``QUANT_NARROW_LOSS_RTOL``, the updates of all parameters together
    within ``QUANT_NARROW_UPDATE_RTOL`` of the CPU's in the Frobenius norm
    (the key projections' bias, zero in exact arithmetic, left out; each
    parameter's own figure printed).  K1 once a step on the card and K3's
    f32 forward and backward twice a step (its plain version on the
    CPU)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, ops
    from mxnet_tpu_torch.convert import block_weights_to_numpy, \
        load_block_weights
    from mxnet_tpu_torch.gluon.model_zoo.nlp import get_bert_model
    rng = np.random.RandomState(340)
    tokens = rng.randint(0, QUANT_NARROW["vocab_size"], (8, 64))
    types = rng.randint(0, 2, (8, 64))
    labels = rng.randint(0, 2, (8,))
    w0 = None
    runs = []
    ops.reset_launches()
    for ctx in (mx.cpu(), mx.gpu(dev.index or 0)):
        mx.random.seed(34)
        net = get_bert_model(**QUANT_NARROW)
        net.initialize(ctx=ctx)
        with ctx:
            net(mx.nd.array(tokens, dtype="int32"),
                mx.nd.array(types, dtype="int32"))
        if w0 is None:
            w0 = block_weights_to_numpy(net)
        else:
            load_block_weights(net, w0)
        ops.reset_launches()      # the shape probe's forward left out
        net.apply(lambda b: setattr(b, "compute_dtype", "fp8")
                  if isinstance(b, gluon.nn.Dense) else None)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        with ctx:
            args = (mx.nd.array(tokens, dtype="int32"),
                    mx.nd.array(types, dtype="int32"))
            y = mx.nd.array(labels, dtype="int32")
            for _ in range(2):
                with autograd.record():
                    loss = ce(net(*args)[-1], y)
                loss.backward()
                tr.step(8)
                losses.append(loss.asnumpy())
        runs.append((losses, block_weights_to_numpy(net)))
    launches = read_launches("phase 34 narrow check", {
        "fused_sgd_update": 2, "flash_attention_fwd": 4,
        "flash_attention_bwd": 4})
    (cl, cw), (gl, gw) = runs
    loss_err = max(abs(float(g.mean()) / float(c.mean()) - 1)
                   for g, c in zip(gl, cl))
    errs, bias, diff, size = {}, 0.0, 0.0, 0.0
    for k in cw:
        if k.endswith("proj_key.bias"):
            bias = max(bias, float(np.abs(gw[k] - w0[k]).max()))
            continue
        du = cw[k] - w0[k]
        d2 = float(np.sum(((gw[k] - w0[k]) - du).astype(np.float64) ** 2))
        errs[k] = (d2 / max(float(np.sum(du.astype(np.float64) ** 2)),
                            1e-30)) ** 0.5
        diff += d2
        size += float(np.sum(du.astype(np.float64) ** 2))
    total = (diff / size) ** 0.5
    worst = max(errs, key=errs.get)
    print(f"phase 34 narrow BERT fp8 card vs CPU (f32, 2 SGD steps): "
          f"mean losses card {[float(x.mean()) for x in gl]} CPU "
          f"{[float(x.mean()) for x in cl]} (relative {loss_err:.3g}, limit "
          f"{QUANT_NARROW_LOSS_RTOL}); updates over all parameters "
          f"{total:.3g} of their norm (limit {QUANT_NARROW_UPDATE_RTOL}), "
          f"the worst parameter {worst} {errs[worst]:.3g}; key biases "
          f"moved at most {bias:.3g}; launches {launches}", flush=True)
    if loss_err > QUANT_NARROW_LOSS_RTOL or \
            total > QUANT_NARROW_UPDATE_RTOL:
        fail("phase 34: the narrow fp8 BERT on the card left the CPU's")
    return launches


# phase 35: Llama-3-8B's embedding with sparse_grad=True
SPARSE_VOCAB, SPARSE_DIM, SPARSE_IDS = 128256, 4096, (8, 1024)
SPARSE_STEPS = 3
# the touched rows against the dense formula on the card: the gradient's
# duplicate rows summed in another order (the deduplication's against
# index_add_'s atomics), and Adam's bias correction in double on the host
# against f32 on the card
SPARSE_RTOL = 1e-5
SPARSE_RULES = (("sgd", {"learning_rate": 0.5}),
                ("adam", {"learning_rate": 1e-3}))
# dot(csr, dense): 8192 rows of 32 stored columns against the embedding
CSR_ROWS, CSR_NNZ = 8192, 32
CSR_RTOL = 1e-5


def _sparse_ids(rng):
    ids = rng.randint(0, SPARSE_VOCAB, SPARSE_IDS)
    ids[:, ::4] = rng.randint(0, 64, (SPARSE_IDS[0], SPARSE_IDS[1] // 4))
    return ids


def sparse_full_width(dev, card):
    """Phase 35: row-sparse gradients at full width.  Llama-3-8B's
    embedding (128256 x 4096 f32, 2.1 GB) with ``sparse_grad=True``
    trained through ``gluon.Trainer`` with lazy SGD (momentum 0, lr 0.5)
    and with lazy Adam (lr 1e-3), ``SPARSE_STEPS`` steps of 8 x 1024 ids
    from ``RandomState`` (a quarter drawn from 64 ids: repeats) against a
    random head: rows no batch touched bitwise unchanged in the weight
    and in both moments; the touched rows within ``SPARSE_RTOL`` of the
    dense formula applied on the card to the dense gradient (its
    ``index_add_``) and the state before the step.  Prints the step time
    and the backward's peak memory beside a ``sparse_grad=False`` step.
    Then ``sparse.dot`` of an 8192 x 128256 CSR (32 stored a row) with the
    same matrix against the dense product of the densified CSR (f32, no
    TF32), with both times.  No kernel of the port runs."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, ops
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.ndarray import sparse as sp
    gpu = mx.gpu(dev.index or 0)
    ops.reset_launches()
    rng = np.random.RandomState(35)
    g = torch.Generator(device=dev).manual_seed(35)
    heads = [torch.randn(*SPARSE_IDS, SPARSE_DIM, device=dev, generator=g)
             for _ in range(SPARSE_STEPS)]
    batches = [_sparse_ids(rng) for _ in range(SPARSE_STEPS)]
    results = {}
    weight = None
    for rule, args in SPARSE_RULES:
        for sparse_grad in (True, False):
            torch.cuda.empty_cache()
            mx.random.seed(35)
            net = nn.Embedding(SPARSE_VOCAB, SPARSE_DIM,
                               sparse_grad=sparse_grad)
            net.initialize(ctx=gpu)
            tr = gluon.Trainer(net.collect_params(), rule, dict(args))
            w = net.weight._var
            w0 = w.detach().clone() if sparse_grad else None
            touched = torch.zeros(SPARSE_VOCAB, dtype=torch.bool,
                                  device=dev)
            step_ms, bwd_gb, worst = [], [], 0.0
            for step, (ids, head) in enumerate(zip(batches, heads)):
                x = mx.nd.array(ids, ctx=gpu, dtype="int32")
                if sparse_grad:
                    w_before = w.detach().clone()
                    st = tr._states.get(0) if tr._states else None
                    m_before = None if not st or "m" not in st else (
                        st["m"].clone(), st["v"].clone())
                torch.cuda.synchronize(dev)
                t = time.perf_counter()
                with autograd.record():
                    loss = (net(x) * mx.nd.NDArray(head)).sum()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                loss.backward()
                torch.cuda.synchronize(dev)
                bwd_gb.append((torch.cuda.max_memory_allocated(dev) - base)
                              / 1e9)
                tr.step(1)
                torch.cuda.synchronize(dev)
                step_ms.append((time.perf_counter() - t) * 1e3)
                if not sparse_grad:
                    continue
                idx = torch.from_numpy(ids.reshape(-1)).to(dev)
                touched[idx] = True
                rows = torch.unique(idx)
                with torch.no_grad():
                    dense_g = torch.zeros_like(w).index_add_(
                        0, idx, head.reshape(-1, SPARSE_DIM))
                    gr = dense_g[rows]
                    del dense_g
                    if rule == "sgd":
                        want = w_before[rows] - args["learning_rate"] * gr
                    else:
                        t_ = step + 1
                        m = torch.zeros_like(gr) if m_before is None \
                            else m_before[0][rows]
                        v = torch.zeros_like(gr) if m_before is None \
                            else m_before[1][rows]
                        m = 0.9 * m + 0.1 * gr
                        v = 0.999 * v + 0.001 * gr * gr
                        lr_t = torch.tensor(
                            args["learning_rate"], device=dev) * \
                            torch.sqrt(torch.tensor(
                                1 - 0.999 ** t_, device=dev)) / \
                            (1 - 0.9 ** t_)
                        want = w_before[rows] - lr_t * m / (
                            torch.sqrt(v) + 1e-8)
                    err = _norm_rel(w.detach()[rows] - w_before[rows],
                               want - w_before[rows])
                    worst = max(worst, err)
                    keep = ~touched
                    same = torch.equal(w.detach()[keep], w0[keep])
                    if rule == "adam":
                        st = tr._states[0]
                        same = same and not bool(st["m"][keep].any()) and \
                            not bool(st["v"][keep].any())
                if not same:
                    fail(f"phase 35 {rule}: a row no batch touched moved")
                if err > SPARSE_RTOL:
                    fail(f"phase 35 {rule}: touched rows {err:.3g} from the "
                         f"dense formula (limit {SPARSE_RTOL})")
            results[(rule, sparse_grad)] = (step_ms, bwd_gb, worst)
            if rule == "sgd" and not sparse_grad:
                weight = w.detach()
            del net, tr, w, w0
            gc.collect()
    for rule, _ in SPARSE_RULES:
        s_ms, s_gb, worst = results[(rule, True)]
        d_ms, d_gb, _ = results[(rule, False)]
        print(f"phase 35 embedding {SPARSE_VOCAB} x {SPARSE_DIM} f32, ids "
              f"{SPARSE_IDS} (repeats), lazy {rule} on {card}: step "
              f"{statistics.median(s_ms):.2f} ms (steps {[round(x, 2) for x in s_ms]}), "
              f"backward peak {max(s_gb):.3f} GB; sparse_grad=False "
              f"{statistics.median(d_ms):.2f} ms (steps "
              f"{[round(x, 2) for x in d_ms]}), backward peak "
              f"{max(d_gb):.3f} GB; untouched rows bitwise unchanged, "
              f"touched rows {worst:.3g} from the dense formula", flush=True)
    # dot(csr, dense) against the dense product of the densified CSR
    # distinct columns in each row (one in each of 32 bins of 4008): a
    # canonical CSR, whose densified product the gather must equal
    indptr = np.arange(0, CSR_ROWS * CSR_NNZ + 1, CSR_NNZ)
    span = SPARSE_VOCAB // CSR_NNZ
    cols = (np.arange(CSR_NNZ) * span + rng.randint(
        0, span, (CSR_ROWS, CSR_NNZ))).reshape(-1)
    vals = rng.randn(CSR_ROWS * CSR_NNZ).astype(np.float32)
    csr = sp.csr_matrix((vals, cols, indptr), shape=(CSR_ROWS, SPARSE_VOCAB),
                        ctx=gpu)
    rhs = mx.nd.NDArray(weight)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    got = sp.dot(csr, rhs).data
    dense = csr.tostype("default").data
    want = dense @ weight
    err = _norm_rel(got, want)
    times = interleaved_ms({"csr": lambda: sp.dot(csr, rhs),
                            "dense": lambda: dense @ weight}, 5, flush)
    print(f"phase 35 dot(csr {CSR_ROWS} x {SPARSE_VOCAB}, {CSR_NNZ} stored "
          f"a row; dense {SPARSE_VOCAB} x {SPARSE_DIM}) on {card}: gather "
          f"and segment sum {statistics.median(times['csr']):.3f} ms beside "
          f"the densified product {statistics.median(times['dense']):.3f} ms "
          f"(f32, no TF32); relative {err:.3g} (limit {CSR_RTOL})",
          flush=True)
    if err > CSR_RTOL:
        fail(f"phase 35: dot(csr, dense) {err:.3g} from the dense product")
    del csr, rhs, dense, want, got, flush, weight, heads
    gc.collect()
    torch.cuda.empty_cache()
    return read_launches("phase 35 sparse", {})


# phase 36: the contrib ops at detection widths.  SSD 300 (ResNet-34):
# the maps a 300 x 300 input gives its stage 1 (layer3, 19 x 19), stage 2
# (10 x 10) and three extras (5, 3, 2), with ssd.py's sizes and ratios
SSD_MAPS = (19, 10, 5, 3, 2)
SSD_SIZES = ((0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
             (0.71, 0.79))
SSD_RATIOS = (1, 2, 0.5)
SSD_BATCH, SSD_CLASSES, SSD_GT = 32, 21, 8
# R-CNN (rcnn.py's defaults) on a 600 x 1000 image at stride 16, and
# ResNet-50's C4 features (1024 channels) for the RoI ops
RCNN_MAP, RCNN_C, RCNN_ROIS = (38, 63), 1024, 300
RCNN = dict(rpn_pre_nms_top_n=2000, rpn_post_nms_top_n=300, threshold=0.7,
            scales=(8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16)
# the RoI ops' CPU check on the first RoIs (each RoI is computed alone)
RCNN_CPU_ROIS = 24
# a ResNet-50 stage (conv2's 256 channels at 56 x 56), batch 8; the CPU
# check on the first image
STAGE = (8, 256, 56, 56)
# f32 arithmetic in another order (bilinear blends, the deformable
# product's sums, the box targets' logs)
CONTRIB_RTOL = 1e-5
# MultiBoxTarget's hard negatives rank background confidences from a
# softmax an ulp apart on the two devices: neighbours at the cut may swap
CONTRIB_MINING_SAME = 0.9999


def contrib_full_width(dev, card):
    """Phase 36: the contrib ops at detection widths, card against the
    port on the CPU, each with its card time (``time_ms`` behind
    ``OPLIB_COVER``, marked where the host's dispatch outlasts it), then
    a CUDA graph capture of each (replayed and held against its eager
    output).  SSD 300 with ResNet-34 (``SSD_MAPS``): ``MultiBoxPrior``
    over its five maps, ``MultiBoxTarget`` at batch 32 with VOC's 21
    classes, ``MultiBoxDetection`` and ``box_nms`` at ``nms_topk=400``;
    R-CNN at ``rcnn.py``'s defaults on a 600 x 1000 image (38 x 63 map):
    ``Proposal`` and ``MultiProposal`` (batch 2), ``ROIAlign`` and
    ``ROIPooling`` with 300 RoIs at (7, 7) on 1024 channels;
    ``DeformableConvolution`` and ``BilinearResize2D`` at a ResNet-50
    stage (``STAGE``).  Exact where the op is (``box_nms``, the
    detections and proposals from zero deltas, ``ROIPooling``,
    ``MultiBoxTarget``'s masks), else within ``CONTRIB_RTOL``; the
    proposals from random deltas are checked finite and inside the
    image.  Only ``boolean_mask`` and ``edge_id`` may refuse a capture,
    and they must.  No kernel of the port runs."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import MXNetError, ops
    from mxnet_tpu_torch.ndarray import sparse as sp
    nd = mx.nd
    gpu, cpu = mx.gpu(dev.index or 0), mx.cpu()
    ops.reset_launches()
    t0 = time.perf_counter()
    rng = np.random.RandomState(36)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(OPLIB_COVER)
    end.record()
    end.synchronize()
    cover_ms = start.elapsed_time(end)
    lines, refused, bad = [], [], []

    def card_ms(fn):
        ms = time_ms(fn, 3, flush, OPLIB_COVER)
        torch.cuda._sleep(OPLIB_COVER)
        t = time.perf_counter()
        fn()
        host = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize(dev)
        if host < cover_ms:
            return f"{ms:.3f} ms"
        return f"{ms:.3f} ms (includes dispatch: host {host:.3f} ms)"

    def outs(x):
        return [o.data for o in (x if isinstance(x, (list, tuple))
                                 else [x])]

    def compare(label, got, want, exact, same=None):
        errs = []
        for k, (a, b) in enumerate(zip(got, want)):
            a = a.cpu()
            if a.shape != b.shape:
                bad.append(f"{label} output {k}: shape {tuple(a.shape)} "
                           f"against {tuple(b.shape)}")
                continue
            if same is not None and k in same:
                frac = float((a == b).float().mean())
                errs.append(f"same {frac:.6f}")
                if frac < same[k]:
                    bad.append(f"{label} output {k}: {frac} equal")
            elif exact or not a.is_floating_point():
                if not torch.equal(a, b):
                    bad.append(f"{label} output {k}: not exact")
                errs.append("exact")
            else:
                e = _norm_rel(a.float(), b.float())
                errs.append(f"{e:.3g}")
                if e > CONTRIB_RTOL:
                    bad.append(f"{label} output {k}: relative {e:.3g}")
        return errs

    def captured(label, fn, eager, exact):
        """Capture ``fn`` (its card call) and replay: None when it
        refuses, else the replay's outputs held against ``eager``."""
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(stream):
                fn()
            torch.cuda.current_stream(dev).wait_stream(stream)
            with torch.cuda.graph(graph, stream=stream):
                out = outs(fn())
        except MXNetError:
            refused.append(label)
            torch.cuda.synchronize(dev)
            return "refused"
        graph.replay()
        torch.cuda.synchronize(dev)
        for a, b in zip(out, eager):
            if (exact and not torch.equal(a, b)) or (
                    not exact and _norm_rel(a.float(), b.float()) > 1e-6):
                bad.append(f"{label}: the replay differs from eager")
        del graph, out
        return "captured"

    def run(label, call, card_args, cpu_args, exact=False, same=None,
            cpu_slice=None):
        """``call(*args)`` on the card and on the CPU (``cpu_args``, or
        the card's inputs sliced by ``cpu_slice`` for the CPU check)."""
        got = outs(call(*card_args))
        want = outs(call(*cpu_args))
        if cpu_slice is not None:
            got = [cpu_slice(g) for g in got]
        errs = compare(label, got, want, exact, same)
        ms = card_ms(lambda: call(*card_args))
        cap = captured(label, lambda: call(*card_args),
                       outs(call(*card_args)), exact)
        lines.append(f"{label}: card {ms}, {cap}; card vs CPU {errs}")

    def both(x, dtype=None):
        x = np.asarray(x, dtype or x.dtype)
        return nd.array(x, ctx=gpu, dtype=str(x.dtype)), \
            nd.array(x, ctx=cpu, dtype=str(x.dtype))

    # -- SSD --
    maps = [both(np.zeros((1, 4, h, h), np.float32)) for h in SSD_MAPS]

    def priors(*feats):
        return nd.concat(*[nd.contrib.MultiBoxPrior(
            f, sizes=s, ratios=SSD_RATIOS) for f, s in
            zip(feats, SSD_SIZES)], dim=1)
    run("MultiBoxPrior (SSD 300's five maps)", priors,
        [m[0] for m in maps], [m[1] for m in maps])
    anchors = priors(*[m[1] for m in maps]).asnumpy()
    n = anchors.shape[1]
    xy = rng.rand(SSD_BATCH, SSD_GT, 2) * 0.7
    wh = rng.rand(SSD_BATCH, SSD_GT, 2) * 0.3 + 0.02
    label = np.concatenate([rng.randint(0, SSD_CLASSES - 1,
                                        (SSD_BATCH, SSD_GT, 1)), xy, xy + wh],
                           -1).astype(np.float32)
    label[:, SSD_GT - 2:, 0] = -1
    pred = rng.randn(SSD_BATCH, SSD_CLASSES, n).astype(np.float32)
    a2, l2, p2 = both(anchors), both(label), both(pred)
    run(f"MultiBoxTarget (batch {SSD_BATCH}, {n} anchors, {SSD_CLASSES} "
        "classes)", lambda a, l, p: nd.contrib.MultiBoxTarget(a, l, p),
        [a2[0], l2[0], p2[0]], [a2[1], l2[1], p2[1]],
        same={1: 1.0, 2: CONTRIB_MINING_SAME})
    prob = np.exp(pred - pred.max(1, keepdims=True))
    prob = (prob / prob.sum(1, keepdims=True)).astype(np.float32)
    c2, z2 = both(prob), both(np.zeros((SSD_BATCH, n * 4), np.float32))
    run(f"MultiBoxDetection (batch {SSD_BATCH}, nms_topk 400, zero "
        "offsets)", lambda c, l, a: nd.contrib.MultiBoxDetection(
            c, l, a, nms_topk=400), [c2[0], z2[0], a2[0]],
        [c2[1], z2[1], a2[1]], exact=True)
    dets = np.concatenate([rng.randint(0, 20, (SSD_BATCH, n, 1)),
                           rng.rand(SSD_BATCH, n, 1),
                           np.sort(rng.rand(SSD_BATCH, n, 4), -1)],
                          -1).astype(np.float32)
    d2 = both(dets)
    run(f"box_nms ({SSD_BATCH} x {n} boxes, topk 400, per class)",
        lambda d: nd.contrib.box_nms(d, overlap_thresh=0.45, topk=400,
                                     id_index=0), [d2[0]], [d2[1]],
        exact=True)
    # -- R-CNN --
    h, w = RCNN_MAP
    A = len(RCNN["scales"]) * len(RCNN["ratios"])
    cls = rng.rand(2, 2 * A, h, w).astype(np.float32)
    zero = np.zeros((2, 4 * A, h, w), np.float32)
    deltas = (rng.randn(2, 4 * A, h, w) * 0.2).astype(np.float32)
    info = np.array([[600, 1000, 1.0], [580, 990, 1.0]], np.float32)
    cls2, zero2, info2 = both(cls), both(zero), both(info)
    run("Proposal (600 x 1000, stride 16, 2000 -> 300, zero deltas)",
        lambda c, b, i: nd.contrib.Proposal(c, b, i, **RCNN),
        [cls2[0][0:1], zero2[0][0:1], info2[0][0:1]],
        [cls2[1][0:1], zero2[1][0:1], info2[1][0:1]], exact=True)
    run("MultiProposal (batch 2, scores out, zero deltas)",
        lambda c, b, i: nd.contrib.MultiProposal(c, b, i, output_score=True,
                                                 **RCNN),
        [cls2[0], zero2[0], info2[0]], [cls2[1], zero2[1], info2[1]],
        exact=True)
    dl = nd.array(deltas, ctx=gpu)
    rois = nd.contrib.MultiProposal(cls2[0], dl, info2[0], **RCNN).data
    inside = bool(torch.isfinite(rois).all()) and \
        bool((rois[:, 1:] >= 0).all()) and \
        bool((rois[:, [1, 3]] <= 999).all()) and \
        bool((rois[:, [2, 4]] <= 599).all())
    ms = card_ms(lambda: nd.contrib.MultiProposal(cls2[0], dl, info2[0],
                                                  **RCNN))
    lines.append(f"MultiProposal (batch 2, random deltas): card {ms}; "
                 f"finite and inside the image: {inside}")
    if not inside:
        bad.append("MultiProposal: rois outside the image")
    feat = rng.randn(1, RCNN_C, h, w).astype(np.float32)
    xy = rng.rand(RCNN_ROIS, 2) * np.array([900, 500])
    wh = rng.rand(RCNN_ROIS, 2) * np.array([300, 250]) + 8
    roi = np.concatenate([np.zeros((RCNN_ROIS, 1)), xy, xy + wh], -1) \
        .astype(np.float32)
    f2, r2 = both(feat), both(roi)
    rcpu = nd.array(roi[:RCNN_CPU_ROIS], ctx=cpu)
    run(f"ROIAlign ({RCNN_ROIS} RoIs, (7, 7), {RCNN_C} x {h} x {w})",
        lambda f, r: nd.contrib.ROIAlign(f, r, (7, 7), 1 / 16,
                                         sample_ratio=2),
        [f2[0], r2[0]], [f2[1], rcpu],
        cpu_slice=lambda t: t[:RCNN_CPU_ROIS])
    run(f"ROIPooling ({RCNN_ROIS} RoIs, (7, 7), {RCNN_C} x {h} x {w})",
        lambda f, r: nd.contrib.ROIPooling(f, r, (7, 7), 1 / 16),
        [f2[0], r2[0]], [f2[1], rcpu], exact=True,
        cpu_slice=lambda t: t[:RCNN_CPU_ROIS])
    # -- a ResNet-50 stage --
    B, C, H, W = STAGE
    x = rng.randn(*STAGE).astype(np.float32)
    off = rng.randn(B, 18, H, W).astype(np.float32)
    wt = (rng.randn(C, C, 3, 3) * (C * 9) ** -0.5).astype(np.float32)
    bias = rng.randn(C).astype(np.float32)
    x2, o2, w2, b2 = both(x), both(off), both(wt), both(bias)

    def dcn(d, o, k, b):
        return nd.contrib.DeformableConvolution(
            d, o, k, b, kernel=(3, 3), pad=(1, 1), num_filter=C)
    run(f"DeformableConvolution ({STAGE}, 3 x 3, {C} filters)", dcn,
        [x2[0], o2[0], w2[0], b2[0]],
        [x2[1][0:1], o2[1][0:1], w2[1], b2[1]],
        cpu_slice=lambda t: t[:1])
    run(f"BilinearResize2D ({STAGE} -> 112 x 112)",
        lambda d: nd.contrib.BilinearResize2D(d, height=2 * H, width=2 * W),
        [x2[0]], [x2[1][0:1]], cpu_slice=lambda t: t[:1])
    # -- the two that read the host --
    mask = (rng.rand(B * C) > 0.5).astype(np.float32)
    flat, m2 = both(x.reshape(B * C, H * W)), both(mask)
    run("boolean_mask", lambda d, m: nd.contrib.boolean_mask(d, m),
        [flat[0], m2[0]], [flat[1], m2[1]], exact=True)
    adj = np.zeros((2000, 2000), np.float32)
    adj[rng.randint(0, 2000, 20000), rng.randint(0, 2000, 20000)] = 1
    u, v = rng.randint(0, 2000, 500), rng.randint(0, 2000, 500)
    csr_gpu = sp.csr_matrix(adj, ctx=gpu)
    csr_cpu = sp.csr_matrix(adj, ctx=cpu)
    run("edge_id (2000-node CSR, 500 pairs)",
        lambda g, a, b: nd.contrib.edge_id(g, a, b), [csr_gpu, u, v],
        [csr_cpu, u, v], exact=True)
    del flush
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    for line in lines:
        print(f"phase 36 {line}", flush=True)
    print(f"phase 36 contrib ops at detection widths on {card}: {wall:.1f} s "
          f"of wall time; refused a capture: {refused}", flush=True)
    if bad:
        fail(f"phase 36: {bad}")
    if sorted(refused) != ["boolean_mask", "edge_id (2000-node CSR, 500 "
                                           "pairs)"]:
        fail(f"phase 36: the ops that refused a capture were {refused}, "
             "expected boolean_mask and edge_id alone")
    return read_launches("phase 36 contrib", {})



# phase 37: MXNet's Gluon training loop over ResNet-50 v1, fed by
# gluon.data, with gluon.utils, callback and the surface modules
LOOP_IMAGES, LOOP_SIZE, LOOP_CLASSES = 1024, 224, 1000
LOOP_BATCH, LOOP_WORKERS, LOOP_WARMUP, LOOP_TRACED = 64, 4, 2, 2
LOOP_CLIP = 1.0
LOOP_MEAN, LOOP_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
LOOP_CLIP_RTOL = 1e-5         # the returned norm against a plain norm
LOOP_CUSTOM_TOL = 1e-6        # the Custom softmax against nd.softmax
LOOP_PARITY_IMAGES = 256      # the loader's parity runs


def _register_smoke_softmax(mx):
    """MXNet's canonical custom op: softmax with a numpy body, its
    backward ``softmax - onehot(label)`` (it takes no head gradient)."""
    import numpy as np

    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            label = in_data[1].asnumpy().ravel().astype(int)
            y = out_data[0].asnumpy()
            y[np.arange(label.shape[0]), label] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))

    @mx.operator.register("smoke_softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()
    return "smoke_softmax"


def _loop_parity(mx, images, labels):
    """The loader's batches under a fixed numpy seed, without the random
    flip: ``num_workers=4`` on the card, ``num_workers=0`` on the card,
    ``num_workers=4`` under ``with mx.cpu():`` and ``num_workers=4`` on
    the card with ``prefetch_to_device=True``, bitwise; returns the
    text."""
    import numpy as np
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.data.vision import transforms as T
    ds = ArrayDataset(images[:LOOP_PARITY_IMAGES],
                      labels[:LOOP_PARITY_IMAGES]).transform_first(
        T.Compose([T.ToTensor(), T.Normalize(LOOP_MEAN, LOOP_STD)]))
    runs = {}
    for label, workers, ctx, prefetch in (
            ("card, 4 workers", LOOP_WORKERS, mx.gpu(0), False),
            ("card, synchronous", 0, mx.gpu(0), False),
            ("host, 4 workers", LOOP_WORKERS, mx.cpu(), False),
            ("card, 4 workers, prefetch_to_device", LOOP_WORKERS,
             mx.gpu(0), True)):
        np.random.seed(37)
        with ctx:
            batches = []
            for data, label_ in DataLoader(
                    ds, batch_size=LOOP_BATCH, shuffle=True,
                    last_batch="discard", num_workers=workers,
                    pin_memory=True, prefetch_to_device=prefetch):
                if data.context != ctx or label_.context != ctx:
                    fail(f"phase 37: a batch of the {label} loader landed "
                         f"on {data.context}, not {ctx}")
                batches.append((data.asnumpy(), label_.asnumpy()))
        runs[label] = batches
    want = runs["card, 4 workers"]
    for label, got in runs.items():
        same = len(got) == len(want) and all(
            np.array_equal(a, c) and np.array_equal(b, d)
            for (a, b), (c, d) in zip(got, want))
        if not same:
            fail(f"phase 37: the {label} loader's batches differ from the "
                 "card's with 4 workers")
    return (f"{len(want)} batches of {LOOP_BATCH} bitwise equal with 4 "
            "workers on the card, synchronous on the card, 4 workers on "
            "the host and 4 workers on the card through "
            "prefetch_to_device=True")


def _loop_custom(mx, dev, rng):
    """The Custom softmax against ``nd.softmax`` on the card, forward and
    backward; ``check_consistency`` over its default ``[cpu(0), gpu(0)]``
    of ``Dense`` -> Custom softmax -> cross-entropy, the loss and the
    Dense's weight gradient.  Returns the text."""
    import numpy as np
    from mxnet_tpu_torch import autograd, nd, test_utils
    from mxnet_tpu_torch.convert import load_block_weights
    from mxnet_tpu_torch.gluon import nn
    op = _register_smoke_softmax(mx)
    gpu = mx.gpu(dev.index or 0)
    x_np = rng.randn(LOOP_BATCH, LOOP_CLASSES).astype(np.float32) * 3
    y_np = rng.randint(0, LOOP_CLASSES, LOOP_BATCH).astype(np.float32)
    x, y = nd.array(x_np, ctx=gpu), nd.array(y_np, ctx=gpu)
    x.attach_grad()
    with autograd.record():
        out = nd.Custom(x, y, op_type=op)
    out.backward()
    x2 = nd.array(x_np, ctx=gpu)
    x2.attach_grad()
    with autograd.record():
        want = nd.softmax(x2)
        ce = -nd.pick(nd.log_softmax(x2), y).sum()
    ce.backward()
    errs = [float(np.abs(out.asnumpy() - want.asnumpy()).max()),
            float(np.abs(x.grad.asnumpy() - x2.grad.asnumpy()).max())]
    if out.context != gpu or not max(errs) <= LOOP_CUSTOM_TOL:
        fail(f"phase 37: the Custom softmax on {out.context} is "
             f"{errs} from nd.softmax (forward, backward; limit "
             f"{LOOP_CUSTOM_TOL})")
    weights = {"weight": rng.randn(16, 32).astype(np.float32) * 0.1,
               "bias": rng.randn(16).astype(np.float32) * 0.1}

    def loss_and_grad(data, label):
        dense = nn.Dense(16, in_units=32)
        dense.initialize(ctx=data.context)
        load_block_weights(dense, weights)
        with autograd.record():
            p = nd.Custom(dense(data), label, op_type=op)
            loss = -nd.log(nd.pick(p, label))
        loss.backward()
        return nd.concat(loss, dense.weight.grad().reshape((-1,)), dim=0)

    data = nd.array(rng.randn(8, 32).astype(np.float32), ctx=mx.cpu())
    label = nd.array(rng.randint(0, 16, 8).astype(np.float32), ctx=mx.cpu())
    res = test_utils.check_consistency(loss_and_grad, [data, label])
    if [r.context.device_type for r in res] != ["cpu", "gpu"]:
        fail(f"phase 37: check_consistency ran on "
             f"{[str(r.context) for r in res]}")
    diff = float(np.abs(res[0].asnumpy() - res[1].asnumpy()).max())
    return (f"Custom softmax ({LOOP_BATCH} x {LOOP_CLASSES}, numpy body) vs "
            f"nd.softmax on the card: forward {errs[0]:.3e}, backward "
            f"{errs[1]:.3e} (limit {LOOP_CUSTOM_TOL}); check_consistency "
            f"[cpu(0), gpu(0)] of Dense -> Custom -> loss: max diff "
            f"{diff:.3e} (float32 limits)")


def gluon_loop(dev, card):
    """Phase 37: MXNet's Gluon training loop over ResNet-50 v1 at full
    width, fed by ``gluon.data``: an ``ArrayDataset`` of 1024 uint8
    224 x 224 x 3 images and labels from ``RandomState(37)``,
    ``transform_first(Compose([RandomFlipLeftRight(), ToTensor(),
    Normalize(ImageNet's mean, std)]))``, ``DataLoader(batch_size=64,
    shuffle=True, last_batch="discard", num_workers=4, pin_memory=True)``;
    ``resnet50_v1()`` initialized on the card and hybridized (f32),
    ``SoftmaxCrossEntropyLoss``, ``Trainer("sgd", lr 0.1, momentum
    0.9)``; each batch ``split_and_load``, ``record``/``backward``,
    ``clip_global_norm`` of every trainable gradient to 1.0,
    ``trainer.step(64)``, ``metric.Accuracy().update`` and
    ``Speedometer(64, frequent=5)``.  One epoch, 16 steps, the first two
    warm-up (the second captures the CUDA graphs), the last two traced.
    Fails unless every loss is finite, K1 ran once a step, the clip's
    norm (step 1, the last warm-up step: the checks' copies stay out of
    the timed steps) matches ``torch.linalg.vector_norm`` over float64
    copies of the gradients within ``LOOP_CLIP_RTOL`` with the clip
    active, the clipped
    gradients' norm is at most 1.0 x (1 + ``LOOP_CLIP_RTOL``), and K1's
    update equals the plain momentum rule on the clipped gradients
    within ``RESNET_UPDATE_RTOL`` (``update_errs``).  Before the loop:
    the loader's parity and the Custom softmax (``_loop_parity``,
    ``_loop_custom``)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, callback, gluon, metric, model, ops
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.data.vision import transforms as T
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.utils import clip_global_norm, split_and_load
    from mxnet_tpu_torch.optimizer import fused_rule
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.RandomState(37)
    images = rng.randint(0, 256, (LOOP_IMAGES, LOOP_SIZE, LOOP_SIZE, 3),
                         dtype=np.uint8)
    labels = rng.randint(0, LOOP_CLASSES, LOOP_IMAGES).astype(np.int32)
    parity = _loop_parity(mx, images, labels)
    custom = _loop_custom(mx, dev, rng)
    ctx = [mx.gpu(dev.index or 0)]
    dataset = ArrayDataset(images, labels).transform_first(T.Compose([
        T.RandomFlipLeftRight(), T.ToTensor(),
        T.Normalize(LOOP_MEAN, LOOP_STD)]))
    loader = DataLoader(dataset, batch_size=LOOP_BATCH, shuffle=True,
                        last_batch="discard", num_workers=LOOP_WORKERS,
                        pin_memory=True)
    steps = len(loader)
    mx.random.seed(37)
    net = vision.resnet50_v1()
    net.initialize(ctx=ctx[0])
    net.hybridize()
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": RESNET_LR,
                             "momentum": RESNET_MOMENTUM})
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    acc = metric.Accuracy()
    speedo = callback.Speedometer(LOOP_BATCH, frequent=5)
    _, plain_sgd = fused_rule("sgd", momentum=RESNET_MOMENTUM)
    timed = range(LOOP_WARMUP, steps - LOOP_TRACED)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    losses, norms, tops, waits, check, speeds = [], [], [], [], {}, {}
    ops.reset_launches()
    it = iter(loader)
    prof = profile(activities=[ProfilerActivity.CUDA])
    for nbatch in range(steps):
        if nbatch == steps - LOOP_TRACED:
            torch.cuda.synchronize(dev)
            tops.append(time.perf_counter())
            prof.__enter__()
        elif nbatch <= steps - LOOP_TRACED:
            tops.append(time.perf_counter())
        if nbatch == timed.start:
            events[0].record()
        t = time.perf_counter()
        batch, label = next(it)
        waits.append(time.perf_counter() - t)
        data = split_and_load(batch, ctx)[0]
        label = split_and_load(label, ctx)[0]
        with autograd.record():
            out = net(data)
            loss = ce(out, label)
        loss.backward()
        grads = [p.grad() for p in params]
        if nbatch == LOOP_WARMUP - 1:       # float64: no rounding of its own
            check["plain_norm"] = float(torch.linalg.vector_norm(torch.cat(
                [g.data.detach().reshape(-1).double() for g in grads])))
        norms.append(clip_global_norm(grads, LOOP_CLIP))
        if nbatch == LOOP_WARMUP - 1:
            check["clipped_norm"] = float(torch.linalg.vector_norm(
                torch.cat([g.data.reshape(-1).double() for g in grads])))
            live = [i for i, v in enumerate(trainer._params)
                    if v.grad is not None]
            check["before"] = {
                trainer._names[i]: (trainer._params[i].detach().clone(),
                                    trainer._params[i].grad.clone(),
                                    trainer._states[i]["mom"].clone())
                for i in live}
        trainer.step(LOOP_BATCH)
        if nbatch == LOOP_WARMUP - 1:
            w0, got, want = {}, {}, {}
            for i in live:
                p0, g, m0 = check["before"][trainer._names[i]]
                new_p, _ = plain_sgd(p0, g, {"mom": m0}, RESNET_LR, 0.0,
                                     1.0 / LOOP_BATCH)
                name = trainer._names[i]
                w0[name] = p0.cpu().numpy()
                want[name] = new_p.cpu().numpy()
                got[name] = trainer._params[i].detach().cpu().numpy()
            check["update"] = update_errs(w0, got, want, 1)
            del check["before"]
        if nbatch == timed.stop - 1:
            events[1].record()
        acc.update([label], [out])
        speedo(model.BatchEndParam(0, nbatch, acc))
        if nbatch and nbatch % speedo.frequent == 0:
            speeds[nbatch] = speedo.last_speed
        losses.append(loss.mean())
    torch.cuda.synchronize(dev)
    tops.append(time.perf_counter())
    prof.__exit__(None, None, None)
    launches = read_launches("phase 37 gluon loop",
                             {"fused_sgd_update": steps})
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [float(x.asscalar()) for x in losses]
    walls = np.diff(tops)
    step_ms = [float(w) * 1e3 for w in walls[timed.start:timed.stop]]
    wait_share = sum(waits[timed.start:timed.stop]) / sum(
        walls[timed.start:timed.stop])
    event_ms = events[0].elapsed_time(events[1])
    n_timed = len(timed)
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / \
        1e3 / LOOP_TRACED
    cached = dict(net._cached_op.stats)
    upd = check["update"]
    worst = max(upd, key=upd.get)
    rel = abs(norms[LOOP_WARMUP - 1] - check["plain_norm"]) / \
        check["plain_norm"]
    del net, trainer, loader, it
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 37 gluon loop: ResNet-50 v1 (f32, hybridized) on {card}, "
          f"{LOOP_IMAGES} images {LOOP_SIZE}x{LOOP_SIZE}x3 uint8 through "
          f"RandomFlipLeftRight/ToTensor/Normalize, DataLoader batch "
          f"{LOOP_BATCH} {LOOP_WORKERS} thread workers pin_memory, "
          f"split_and_load, clip_global_norm {LOOP_CLIP}, sgd lr "
          f"{RESNET_LR} momentum {RESNET_MOMENTUM}: {steps} steps, losses "
          f"{[round(v, 4) for v in losses]}; norms before the clip "
          f"{[round(v, 3) for v in norms]}; step {LOOP_WARMUP - 1}: norm "
          f"{norms[LOOP_WARMUP - 1]:.6f} vs plain {check['plain_norm']:.6f} "
          f"(rel {rel:.2e}), clipped norm {check['clipped_norm']:.7f}, "
          f"K1's update vs plain momentum on the clipped gradients worst "
          f"{upd[worst]:.3e} ({worst}); timed steps {n_timed}: "
          f"{n_timed * LOOP_BATCH / event_ms * 1e3:.1f} samples/s from "
          f"CUDA events ({event_ms:.2f} ms), Speedometer "
          f"{ {k: round(v, 1) for k, v in speeds.items()} } samples/s "
          f"(by the batch it reported at; batch 15's window holds the "
          f"traced steps); step wall median "
          f"{statistics.median(step_ms):.2f} ms, each "
          f"{[round(v, 1) for v in step_ms]}; share of wall waiting in "
          f"next(loader) {wait_share:.4f}; device busy {busy_ms:.2f} ms a "
          f"step ({LOOP_TRACED} traced steps, torch.profiler), host share "
          f"{1 - busy_ms / statistics.median(step_ms):.4f} of the untraced "
          f"median; peak memory {peak_gb:.2f} GB; CachedOp {cached}; "
          f"launches {launches}; loader parity: {parity}; {custom}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"phase 37: non-finite loss {losses}")
    norm = norms[LOOP_WARMUP - 1]
    if not (rel <= LOOP_CLIP_RTOL and norm > LOOP_CLIP):
        fail(f"phase 37: clip_global_norm returned {norm}, a "
             f"plain norm gives {check['plain_norm']} (limit "
             f"{LOOP_CLIP_RTOL}; the clip must be active)")
    if not check["clipped_norm"] <= LOOP_CLIP * (1 + LOOP_CLIP_RTOL):
        fail(f"phase 37: the clipped gradients' norm is "
             f"{check['clipped_norm']}")
    if not upd[worst] <= RESNET_UPDATE_RTOL:
        fail(f"phase 37: K1's update of {worst} is {upd[worst]} from the "
             f"plain momentum rule on the clipped gradients (limit "
             f"{RESNET_UPDATE_RTOL})")
    return launches


# ----------------------------------------------------------------------
# phase 38: bench.py's .rec-fed ResNet-50 pipeline, ImageRecordIter ->
# DevicePrefetcher -> DataParallelTrainer.step, under bf16 amp
# ----------------------------------------------------------------------

REC_FIXTURE = os.path.join(REPO, "tests", "fixtures", "jpeg8")
REC_RECORDS, REC_BATCH, REC_SIZE, REC_EPOCHS = 1024, 128, 224, 2
REC_WARMUP, REC_TRACED, REC_PARITY, REC_COMPARE = 2, 3, 3, 3
REC_NORM = dict(mean_r=123.68, mean_g=116.78, mean_b=103.94, std_r=58.4,
                std_g=57.12, std_b=57.38)
# the prefetched steps' losses against the direct ones, where the
# captured step does not repeat bitwise (atomics in cuDNN's backward)
REC_LOSS_RTOL = 1e-3
REC_FILL_S = 30.0             # the traced window waits for the backlog
# sha256 of the fixture's eight JPEGs decoded in order (H x W x 3 uint8)
# by libjpeg-turbo 2.1.5 through the port's and the reference's library,
# and by PIL, on the CPU tests' host
JPEG8_DECODE_SHA256 = \
    "c93328612f7b8219bf5d5c725d4ca6f221a9da7d309c2c713177847bc7aab770"


def _rec_file(tmp):
    """``REC_RECORDS`` records through the port's ``recordio``, cycling
    the fixture's eight JPEGs, labels ``i % 1000``; returns the path and
    the eight payloads."""
    from mxnet_tpu_torch import recordio
    src = recordio.MXIndexedRecordIO(REC_FIXTURE + ".idx",
                                     REC_FIXTURE + ".rec", "r")
    jpegs = [recordio.unpack(src.read_idx(k))[1] for k in src.keys]
    src.close()
    path = os.path.join(tmp, "train.rec")
    rec = recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(REC_RECORDS):
        rec.write_idx(i, recordio.pack(
            recordio.IRHeader(0, float(i % 1000), i, 0), jpegs[i % 8]))
    rec.close()
    return path, jpegs


def _union_us(spans):
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _trace_copies(prof, tmp, batch_bytes):
    """From the trace's device events: the stream of most kernel time
    (the step's), each H2D copy of at least ``batch_bytes`` (stream,
    whether it overlaps one of the step stream's kernels), and the union
    of every device event's time in us."""
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    per_stream = {}
    for e in dev:
        if e["cat"] == "kernel":
            s = e["args"].get("stream")
            per_stream[s] = per_stream.get(s, 0.0) + e["dur"]
    if not per_stream:
        fail("phase 38: the trace holds no kernel of the step")
    step = max(per_stream, key=per_stream.get)
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in dev
               if e["cat"] == "kernel" and e["args"].get("stream") == step]
    copies = []
    for e in dev:
        if e["cat"] != "gpu_memcpy" or "HtoD" not in e["name"]:
            continue
        nbytes = e["args"].get("bytes")
        if nbytes is not None and nbytes < batch_bytes:
            continue
        a, b = e["ts"], e["ts"] + e["dur"]
        copies.append({"stream": e["args"].get("stream"), "ms": e["dur"] / 1e3,
                       "bytes": nbytes,
                       "overlaps_step": any(ka < b and a < kb
                                            for ka, kb in kernels)})
    busy = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    return step, copies, busy, len(kernels)


def rec_pipeline(dev, card):
    """Phase 38: ``bench.py``'s ``.rec``-fed ResNet-50 pipeline through
    the port's entry points.  A 1,024-record ``.rec`` (the fixture's
    eight 500 x 375 JPEGs cycled, labels ``i % 1000``) written through
    ``recordio``; ``io.ImageRecordIter(data_shape=(3, 224, 224),
    batch_size=128, shuffle=True, rand_mirror=True, ImageNet's
    mean/std, preprocess_threads=os.cpu_count())`` on the native path;
    ``io.DevicePrefetcher(it, depth=2)``; ``resnet50_v1(s2d_stem=True)``
    through ``DataParallelTrainer`` (SGD lr 0.1 momentum 0.9, dp=1) under
    ``amp.init("bfloat16")``, phase 17's configuration; two epochs, 16
    steps, ``trainer.step(batch.data[0], batch.label[0])``, the first two
    warm-up.  Steps 2-4 are traced with ``torch.profiler`` after the
    prefetcher's queue has filled and its worker holds one more batch,
    copied (the backlog the three steps run from while the next batch
    is decoded and copied); the second epoch is timed whole (from
    its ``reset``, the C++ pool's fill included) and over its steps
    after the first two, with CUDA events on the step's stream.

    Fails unless the native library was built into
    ``build/mxnet_tpu_torch/`` and decodes the fixture to the digest of
    the CPU tests' host, the Python decode path ran for no sample, every
    loss is finite, K1 ran once a step; without shuffle and mirror the
    batches through the prefetcher, without it and under ``with
    mx.cpu():`` are bitwise equal with their labels in order; three
    steps fed through the prefetcher give the losses of the same batches
    fed directly (from the same parameters and momenta: bitwise, or
    within ``REC_LOSS_RTOL``); and in the trace every batch's H2D copy
    runs on another stream than the step's, at least one of them
    overlapping the step's kernels.  Prints the images/s fed (CUDA
    events) beside phase 17's, the decode rates alone, the stages a
    batch, the share of the last epoch's wall waiting in
    ``next(prefetcher)``, the device's idle share (a graph replay's
    device time a step against the events' wall), peak memory and the
    card."""
    import hashlib
    import shutil
    import tempfile
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, gluon, io as mio, ops, parallel
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.utils import native
    t_phase = time.perf_counter()
    lib = native.build()
    if os.path.dirname(lib) != _build.BUILD_DIR or not os.path.exists(lib):
        fail(f"phase 38: the native library is {lib}, not a build of src/ "
             f"in {_build.BUILD_DIR}")
    with open(lib[:-len(".so")] + ".log") as f:
        libjpeg = f.readline().strip()
    digest = hashlib.sha256()
    tmp = tempfile.mkdtemp(prefix="phase38-")
    python_path = [0]
    real_decode = mio.ImageRecordIter._decode_sample

    def counted(self, idx):
        python_path[0] += 1
        return real_decode(self, idx)
    mio.ImageRecordIter._decode_sample = counted
    gpu = mx.gpu(dev.index or 0)
    threads = os.cpu_count()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        path, jpegs = _rec_file(tmp)
        for jpg in jpegs:
            digest.update(native.jpeg_decode(jpg).tobytes())
        if digest.hexdigest() != JPEG8_DECODE_SHA256:
            fail(f"phase 38: this host's libjpeg ({libjpeg}) decodes the "
                 f"fixture to {digest.hexdigest()}, the CPU tests' host to "
                 f"{JPEG8_DECODE_SHA256}")

        def make(shuffle, mirror, ctx):
            with ctx:
                it = mio.ImageRecordIter(
                    path, (3, REC_SIZE, REC_SIZE), REC_BATCH,
                    shuffle=shuffle, rand_mirror=mirror,
                    preprocess_threads=threads, **REC_NORM)
            if not it._use_native:
                fail("phase 38: ImageRecordIter did not take the native path")
            return it

        # the decode rates alone: the C++ pool (uint8) over four epochs'
        # schedule in one (no refill between epochs), then the iterator
        # over one epoch (each worker thread builds a whole batch, so an
        # epoch starts with the pool's fill: timed with and without it)
        pool = native.NativePrefetcher(
            path, np.tile(np.arange(REC_RECORDS), 4), REC_BATCH,
            n_threads=threads, mode="image", edge=REC_SIZE)
        t = time.perf_counter()
        n_pool = sum(len(b) for b, _ in pool)
        pool_rate = n_pool / (time.perf_counter() - t)
        pool.close()
        np.random.seed(38)
        it = make(True, True, gpu)
        for _ in it:                  # the first epoch warms the pool
            pass
        it.reset()
        t = time.perf_counter()
        n_iter, t_first = 0, None
        for b in it:
            n_iter += b.data[0].shape[0]
            if t_first is None:
                torch.cuda.synchronize(dev)
                t_first = time.perf_counter()
        torch.cuda.synchronize(dev)
        t_end = time.perf_counter()
        iter_rate = n_iter / (t_end - t)
        iter_steady = (n_iter - REC_BATCH) / (t_end - t_first)
        fill_ms = (t_first - t) * 1e3
        del it, b

        # parity: through the prefetcher, without it, and on the host
        runs = {}
        for label, ctx, prefetch in (("card", gpu, False),
                                     ("card, prefetched", gpu, True),
                                     ("host", mx.cpu(), False)):
            np.random.seed(38)
            src = make(False, False, ctx)
            src = mio.DevicePrefetcher(src, depth=2) if prefetch else src
            got = []
            for _ in range(REC_PARITY):
                b = next(src)
                if b.data[0].context != ctx or b.label[0].context != ctx:
                    fail(f"phase 38: a {label} batch landed on "
                         f"{b.data[0].context}")
                got.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
            if prefetch:
                src.close()
            runs[label] = got
        want_labels = np.arange(REC_PARITY * REC_BATCH) % 1000
        for label, got in runs.items():
            same = all(np.array_equal(a, c) and np.array_equal(b, d)
                       for (a, b), (c, d) in zip(got, runs["card"]))
            if not same:
                fail(f"phase 38: the {label} batches differ from the card's "
                     "without the prefetcher")
            if not np.array_equal(np.concatenate([b for _, b in got]),
                                  want_labels.astype(np.float32)):
                fail(f"phase 38: the {label} labels are out of order")
        del runs

        # the main path
        amp.init("bfloat16")
        mx.random.seed(0)
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        mesh = parallel.make_mesh({"dp": 1}, devices=[dev])
        net = vision.resnet50_v1(s2d_stem=True)
        net.initialize()
        trainer = parallel.DataParallelTrainer(
            net, ce, "sgd", {"learning_rate": RESNET_LR,
                             "momentum": RESNET_MOMENTUM}, mesh=mesh)
        np.random.seed(38)
        pf = mio.DevicePrefetcher(make(True, True, gpu), depth=2)
        per_epoch = REC_RECORDS // REC_BATCH
        traced = range(REC_WARMUP, REC_WARMUP + REC_TRACED)
        steady = range(per_epoch + REC_WARMUP, REC_EPOCHS * per_epoch)
        events = {k: [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)] for k in ("epoch", "steady")}
        losses, waits = [], []
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        ops.reset_launches()
        step, fill_s, traced_s, epoch_s = 0, None, None, None
        for epoch in range(REC_EPOCHS):
            if epoch:                   # the last epoch, timed whole
                torch.cuda.synchronize(dev)
                events["epoch"][0].record()
                t_epoch = time.perf_counter()
                pf.reset()
            while True:
                if step == traced.start:
                    # the backlog: the queue full and one more batch
                    # copied in the worker's hands, so the window's three
                    # steps run from it while the worker decodes and
                    # copies the next batch (the decode is slower than a
                    # step: from a bare full queue the next copy can
                    # land after two steps end)
                    t = time.perf_counter()
                    while pf.stats.batches < step + pf._depth + 1 and \
                            time.perf_counter() - t < REC_FILL_S:
                        time.sleep(0.01)
                    fill_s = time.perf_counter() - t
                    torch.cuda.synchronize(dev)
                    prof.__enter__()
                    t_traced = time.perf_counter()
                t0 = time.perf_counter()
                try:
                    batch = next(pf)
                except StopIteration:
                    break
                waits.append(time.perf_counter() - t0)
                if step == steady.start:
                    events["steady"][0].record()
                losses.append(trainer.step(batch.data[0], batch.label[0]))
                if step == steady.stop - 1:
                    events["steady"][1].record()
                del batch
                step += 1
                if step == traced.stop:
                    torch.cuda.synchronize(dev)
                    traced_s = time.perf_counter() - t_traced
                    prof.__exit__(None, None, None)
            if epoch:
                events["epoch"][1].record()
                torch.cuda.synchronize(dev)
                epoch_s = time.perf_counter() - t_epoch
        launches = read_launches("phase 38 rec pipeline",
                                 {"fused_sgd_update": step})
        stages = pf.stats.summary()
        pf.close()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        losses = [float(x.asnumpy()) for x in losses]
        epoch_ms = events["epoch"][0].elapsed_time(events["epoch"][1])
        steady_ms = events["steady"][0].elapsed_time(events["steady"][1])
        fed = len(steady) * REC_BATCH / steady_ms * 1e3
        fed_epoch = per_epoch * REC_BATCH / epoch_ms * 1e3
        wait_share = sum(waits[per_epoch:]) / epoch_s
        entry = next(iter(trainer._graphs.values()))
        replay_ms = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            entry.graph.replay()
            end.record()
            end.synchronize()
            replay_ms.append(start.elapsed_time(end))
        replay_ms = statistics.median(replay_ms)
        idle_share = 1 - replay_ms * len(steady) / steady_ms
        idle_epoch = 1 - replay_ms * per_epoch / epoch_ms
        batch_bytes = REC_BATCH * 3 * REC_SIZE * REC_SIZE * 4
        step_stream, copies, busy_us, n_kernels = _trace_copies(
            prof, tmp, batch_bytes)
        traced_idle = 1 - busy_us / (traced_s * 1e6)

        # the same batches fed directly and through the prefetcher, from
        # the same parameters, momenta and running statistics (replays)
        kept = [trainer._flat_p, *trainer._flat_state.values()] + [
            p.data().data for p in net.collect_params().values()
            if p.grad_req == "null"]
        saved = [t.detach().clone() for t in kept]
        compare = {}
        for label, prefetch in (("direct", False), ("prefetched", True)):
            with torch.no_grad():
                for t, s in zip(kept, saved):
                    t.copy_(s)
            np.random.seed(38)
            src = make(False, False, gpu)
            src = mio.DevicePrefetcher(src, depth=2) if prefetch else src
            out = []
            for _ in range(REC_COMPARE):
                b = next(src)
                out.append(trainer.step(b.data[0], b.label[0]))
            compare[label] = [float(x.asnumpy()) for x in out]
            if prefetch:
                src.close()
        graph_stats = dict(trainer.stats)
    finally:
        mio.ImageRecordIter._decode_sample = real_decode
        amp._deinit_for_tests()
        shutil.rmtree(tmp, ignore_errors=True)
    del net, trainer, entry
    gc.collect()
    torch.cuda.empty_cache()
    direct, fed_losses = compare["direct"], compare["prefetched"]
    bitwise = direct == fed_losses
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fed_losses, direct))
    plain = STEP_MS.get(("resnet", "sgd", None))
    side = [c for c in copies if c["stream"] != step_stream]
    overlapping = [c for c in side if c["overlaps_step"]]
    print(f"phase 38 rec pipeline on {card}: {REC_RECORDS} records (the "
          f"fixture's 8 JPEGs 500x375 q90 cycled), native library {lib} "
          f"({libjpeg}; fixture decode digest as the CPU tests'), "
          f"ImageRecordIter batch {REC_BATCH} 3x{REC_SIZE}x{REC_SIZE} "
          f"shuffle rand_mirror, preprocess_threads {threads} "
          f"(os.cpu_count() {os.cpu_count()}), DevicePrefetcher depth 2, "
          f"ResNet-50 v1 (s2d stem) bf16 amp sgd through "
          f"DataParallelTrainer: {step} steps, losses "
          f"{[round(v, 4) for v in losses]}; fed {fed:.1f} images/s over "
          f"steps {steady.start}-{steady.stop - 1} ({steady_ms:.1f} ms, "
          f"CUDA events on the step's stream), {fed_epoch:.1f} images/s "
          f"over the whole last epoch from its reset ({epoch_ms:.1f} ms, "
          f"the pool's fill included)"
          + (f", beside phase 17's synthetic {REC_BATCH / plain[0] * 1e3:.1f}"
             f" images/s (step median {plain[0]:.2f} ms) in this run"
             if plain else "")
          + f"; decode alone: the C++ pool {pool_rate:.1f} images/s "
          f"(uint8, {n_pool} images in one schedule), ImageRecordIter "
          f"{iter_rate:.1f} images/s over an epoch (normalized, on the "
          f"card), its first batch after {fill_ms:.1f} ms, "
          f"{iter_steady:.1f} images/s after it; stages a batch {stages}; "
          f"share of the last epoch's wall waiting in next(prefetcher) "
          f"{wait_share:.4f}; device idle share {idle_share:.4f} over "
          f"steps {steady.start}-{steady.stop - 1}, {idle_epoch:.4f} over "
          f"the last epoch (graph replay {replay_ms:.2f} ms device time a "
          f"step against the events' wall); traced steps "
          f"{traced.start}-{traced.stop - 1} (after {fill_s:.2f} s for the "
          f"queue to fill): {len(side)} of {len(copies)} batch-sized H2D "
          f"copies on stream(s) {sorted({c['stream'] for c in side})} "
          f"apart from the step's stream {step_stream} ({n_kernels} "
          f"kernels), {len(overlapping)} overlapping the step's kernels, "
          f"copies {[round(c['ms'], 3) for c in copies]} ms, device idle "
          f"share of the traced wall {traced_idle:.4f}; three steps fed "
          f"through the prefetcher {fed_losses} vs directly {direct}: "
          + ("bitwise" if bitwise else
             f"max relative difference {loss_rel:.3e} (limit "
             f"{REC_LOSS_RTOL})")
          + f"; Python decode path samples {python_path[0]}; peak memory "
          f"{peak_gb:.2f} GB; trainer {graph_stats}; launches {launches}; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    if python_path[0]:
        fail(f"phase 38: the Python decode path ran for {python_path[0]} "
             "samples")
    if not all(np.isfinite(losses)):
        fail(f"phase 38: non-finite loss {losses}")
    if not bitwise and not loss_rel <= REC_LOSS_RTOL:
        fail(f"phase 38: the prefetched steps' losses {fed_losses} are not "
             f"those of the same batches fed directly {direct}")
    if not copies or len(side) != len(copies) or not overlapping:
        fail(f"phase 38: the traced H2D copies {copies} do not run on a "
             f"stream of their own (the step's is {step_stream}) "
             "overlapping the step's kernels")
    return launches


# ----------------------------------------------------------------------
# phase 39: data parallelism over more than one rank (ROADMAP §1 item
# 10a): NCCL at one rank in this process, then two processes sharing
# the card over gloo
# ----------------------------------------------------------------------

DP2_CHILD_TIMEOUT = 420        # s a spawned rank may take, builds loaded
DP2_RESNET_BATCH = 64          # a rank's part of bench.py's batch of 128
# 39b's many-bucket ZeRO-1 path: a net 15 channels wide with a 7-way head
# in buckets of at most 600 f32: three (the trainer's parameters in name
# order: 15+15+32+32+405, 4320 and 7+224 elements), the first and last
# padded to even lengths
DP2_BUCKETS_NET = dict(width=15, classes=7)
DP2_BUCKET_MB = 600 * 4 / 2 ** 20
DP2_PATHS = ("psum", "zero1", "zero1_buckets")
KV_TIMED = 10                  # phase 39a's timed pushpulls


def dp_nccl_one_rank(dev, card):
    """Phase 39a: ``parallel.distributed_init`` through a ``file://``
    store under the build directory, NCCL at one rank in this process.
    (1) ``zero.all_reduce_mean``, ``reduce_scatter_bucket`` and
    ``all_gather_bucket`` over ResNet-50's 25,575,912-element f32 bucket
    captured in one CUDA graph (the communicator made by an eager call
    first), whose replay must equal the eager results bitwise; (2)
    ``DataParallelTrainer`` on the one-rank NCCL mesh
    (``make_mesh({"dp": 1})`` keeps the group), phase 16's conv net
    from host-made weights, SGD momentum 0.9, 3 steps, the rate halved,
    a 4th: captured (one capture: the gradient's and loss's
    ``all_reduce`` and BatchNorm's two statistics ``all_reduce``s a
    layer, forward and backward, inside the step's graph) against the
    same body run eagerly on the card, losses and parameters within
    ``DP_GRAPH_RTOL`` (bitwise printed), K1 once a step each; (3) the
    counterpart of ``bench.py``'s ``_kvstore_bandwidth``: a
    ``kv.create("dist_tpu_sync")`` ``pushpull`` of ResNet-50's 161
    gradients (random, seeded), coalesced into 25 MiB buckets, one
    ``all_reduce`` each, timed over 10 calls (host clock ending in a
    synchronize): ms a call and GB/s of gradient bytes.  One rank's
    ``all_reduce`` moves nothing between cards: these are the
    collectives' fixed costs on this card, not a bandwidth of a link."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kv, parallel
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.parallel import zero
    store = os.path.join(_build.BUILD_DIR, "phase39a_store")
    if os.path.exists(store):
        os.remove(store)
    if not parallel.distributed_init("file://" + store, 1, 0):
        fail("dp nccl: distributed_init did not join")
    try:
        if torch.distributed.get_backend() != "nccl":
            fail(f"dp nccl: backend {torch.distributed.get_backend()}")
        group = torch.distributed.group.WORLD
        gen = torch.Generator(device=dev).manual_seed(39)
        src = torch.randn(RESNET_TRAINABLE, device=dev, generator=gen)
        buf, full = torch.empty_like(src), torch.empty_like(src)

        def body():
            buf.copy_(src)
            zero.all_reduce_mean(buf, 1, group)
            shard = zero.reduce_scatter_bucket(buf, 1, "fp32", group)
            zero.all_gather_bucket(full, shard * 0.5, group)

        body()
        torch.cuda.synchronize(dev)
        eager = (buf.clone(), full.clone())
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            body()
        end.record()
        end.synchronize()
        eager_ms = start.elapsed_time(end) / 10
        buf.zero_()
        full.zero_()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            body()
        graph.replay()
        torch.cuda.synchronize(dev)
        bitwise = torch.equal(buf, eager[0]) and torch.equal(full, eager[1])
        start.record()
        for _ in range(10):
            graph.replay()
        end.record()
        end.synchronize()
        replay_ms = start.elapsed_time(end) / 10
        del graph, src, buf, full, eager
        if not bitwise:
            fail("dp nccl: the captured collectives differ from eager")
        trainer_text, launches = _nccl_trainer(dev)
        with mx.gpu(dev.index or 0):
            net = vision.resnet50_v1(s2d_stem=True)
            net.initialize()
            net(mx.nd.zeros((1, 3, 64, 64)))
        shapes = [p.shape for _, p in sorted(net.collect_params().items())
                  if p.grad_req != "null"]
        del net
        grads = [mx.nd.NDArray(torch.randn(s, device=dev, generator=gen))
                 for s in shapes]
        nbytes = 4 * sum(g.size for g in grads)
        store_kv = kv.create("dist_tpu_sync")
        keys = list(range(len(grads)))
        store_kv.init(keys, [mx.nd.NDArray(torch.zeros_like(g.data))
                             for g in grads])
        store_kv.pushpull(keys, grads, out=grads)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(KV_TIMED):
            store_kv.pushpull(keys, grads, out=grads)
        torch.cuda.synchronize(dev)
        kv_ms = (time.perf_counter() - t0) / KV_TIMED * 1e3
        n_buckets = len(zero_buckets(grads))
    finally:
        parallel.teardown_distributed()
    print(f"dp nccl one rank (phase 39a, {card}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}): all_reduce, "
          f"reduce_scatter_tensor and all_gather_into_tensor over "
          f"{RESNET_TRAINABLE} f32 captured in one CUDA graph, replay "
          f"bitwise the eager results: True; eager {eager_ms:.4f} ms, "
          f"replay {replay_ms:.4f} ms a round (CUDA events, 10 rounds); "
          f"{trainer_text}; dist_tpu_sync pushpull of ResNet-50's {len(shapes)} gradients "
          f"({nbytes} bytes, {n_buckets} buckets of at most 25 MiB) "
          f"{kv_ms:.3f} ms a call = {nbytes / kv_ms / 1e6:.2f} GB/s "
          f"(host clock, {KV_TIMED} calls; one rank: no bytes cross a "
          f"link); launches {launches}", flush=True)
    if torch.distributed.is_initialized():
        fail("dp nccl: the process group outlived teardown")
    return launches


def _nccl_trainer(dev):
    """Phase 39a (2): the trainer on the one-rank NCCL mesh, captured
    against its eager body.  Returns the text and the launches."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, ops, parallel
    from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                         load_block_weights)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rng = np.random.RandomState(39)
    batches = [(rng.rand(DP_CONV_BATCH, 3, 32, 32).astype(np.float32),
                rng.randint(0, 10, (DP_CONV_BATCH,)).astype(np.float32))
               for _ in range(DP_STEPS + 1)]
    with mx.cpu():
        net = _dp_conv_net(gluon.nn)
        mx.random.seed(39)
        net.initialize(mx.init.Xavier(magnitude=2))
        net(mx.nd.array(batches[0][0]))
    w0 = block_weights_to_numpy(net)
    runs, captures = {}, {}
    try:
        torch.cuda.synchronize(dev)
        ops.reset_launches()
        for how in ("graph", "eager"):
            net = _dp_conv_net(gluon.nn)
            net.initialize(ctx=mx.gpu(dev.index or 0))
            load_block_weights(net, w0)
            mesh = parallel.make_mesh({"dp": 1})
            if mesh.group is None:
                fail("dp nccl: the one-rank mesh has no group")
            tr = parallel.DataParallelTrainer(
                net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                {"learning_rate": 0.1, "momentum": 0.9}, mesh=mesh)
            tr._use_graphs = how == "graph"
            losses = []
            for i, batch in enumerate(batches):
                if i == DP_STEPS:
                    tr.set_learning_rate(tr.learning_rate / 2)
                losses.append(float(tr.step(*batch).asnumpy()))
            runs[how] = (losses, block_weights_to_numpy(net))
            captures[how] = tr.stats["captures"]
            del net, tr
        torch.cuda.synchronize(dev)
        launches = read_launches("dp nccl trainer", {
            "fused_sgd_update": 2 * (DP_STEPS + 1)})
    finally:
        torch.backends.cudnn.deterministic = prev
    (lg, wg), (le, we) = runs["graph"], runs["eager"]
    loss_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lg, le))
    errs = update_errs(w0, wg, we, DP_STEPS + 1)
    worst = max(errs.items(), key=lambda kv: kv[1])
    same = lg == le and all(np.array_equal(wg[k], we[k]) for k in wg)
    if captures != {"graph": 1, "eager": 0}:
        fail(f"dp nccl trainer: captures {captures}")
    if loss_err > DP_GRAPH_RTOL or worst[1] > DP_GRAPH_RTOL:
        fail(f"dp nccl trainer: captured vs eager losses {loss_err:.3e}, "
             f"update {worst}")
    return (f"DataParallelTrainer on the one-rank NCCL mesh (phase 16's "
            f"conv net, its collectives in the captured step): losses "
            f"captured {lg} eager {le}, max relative loss diff "
            f"{loss_err:.3e}, worst relative update diff {worst[1]:.3e} at "
            f"{worst[0]} (limit {DP_GRAPH_RTOL}), bitwise {same}, "
            f"captures {captures}"), launches


def zero_buckets(grads):
    """The dist store's buckets of ``grads`` (its 25 MiB bound)."""
    from mxnet_tpu_torch.kvstore.kvstore import (DEFAULT_BIGARRAY_BOUND,
                                                 _make_buckets)
    return _make_buckets([g.data.reshape(-1) for g in grads],
                         DEFAULT_BIGARRAY_BOUND)


def _dp_child_main(spec_path, rank):
    """A spawned rank of phases 39b and 39c (``chip_smoke.py --dp-rank
    SPEC RANK``): joins the gloo group of ``SPEC`` on ``cuda:0``, runs
    the job, writes its result as JSON beside the spec."""
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(rank)
    if not torch.cuda.is_available():
        fail(f"dp rank {rank}: no CUDA device")
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.ops import _build
    _build.build(["fused_update"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parallel.distributed_init("file://" + spec["store"], 2, rank,
                              backend="gloo")
    try:
        out = {"card_vs_cpu": _dp2_card_vs_cpu_rank,
               "resnet": _dp2_resnet_rank}[spec["job"]](spec, rank, dev)
    finally:
        parallel.teardown_distributed()
    arrays = out.pop("_arrays", None)
    if arrays is not None:
        np.savez(os.path.join(spec["dir"], f"rank{rank}.npz"), **arrays)
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _run_dp_children(job, tmp, extra=None):
    """Start two ranks of ``job`` as processes sharing the card, join
    them with a timeout, print their output, fail on any exit other than
    0.  Returns each rank's JSON result."""
    os.makedirs(tmp, exist_ok=True)
    for name in os.listdir(tmp):
        path = os.path.join(tmp, name)
        if os.path.isfile(path):
            os.remove(path)
    spec = dict(extra or {}, job=job, dir=tmp,
                store=os.path.join(tmp, "store"))
    path = os.path.join(tmp, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--dp-rank", path, str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    outs, bad = [], []
    try:
        for r, p in enumerate(procs):
            try:
                text, _ = p.communicate(timeout=DP2_CHILD_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
                bad.append(f"rank {r} timed out after {DP2_CHILD_TIMEOUT} s")
            text = text.decode(errors="replace").strip()
            if text:
                print(f"[{job} rank {r}] " + text.replace(
                    "\n", f"\n[{job} rank {r}] ")[-6000:], flush=True)
            if p.returncode:
                bad.append(f"rank {r} exited {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if bad:
        fail(f"dp2 {job}: " + "; ".join(bad))
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    return outs


def _sum_counts(outs):
    total = {}
    for o in outs:
        for k, v in o["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def _dp2_card_vs_cpu_rank(spec, rank, dev):
    """Phase 39b, one rank: phase 16's conv net from the host-made
    weights on both paths, on the card (cuDNN deterministic) and on the
    CPU, each through ``DataParallelTrainer`` on ``make_mesh({"dp": 2})``
    of the one gloo group, this rank on its half of each batch."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, ops, parallel
    from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                         load_block_weights)
    torch.backends.cudnn.deterministic = True
    batches = np.load(spec["batches"])
    xs, ys = batches["x"], batches["y"]
    half = xs.shape[1] // 2
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    out, arrays = {"losses": {}, "launches": {}, "buckets": {}}, {}
    ops.reset_launches()
    for path in DP2_PATHS:
        many = path == "zero1_buckets"
        w0 = dict(np.load(spec["weights_buckets" if many else "weights"]))
        for where in ("card", "cpu"):
            ctx = mx.gpu(0) if where == "card" else mx.cpu()
            net = _dp_conv_net(gluon.nn, **(DP2_BUCKETS_NET if many else {}))
            net.initialize(ctx=ctx)
            load_block_weights(net, w0)
            mesh = parallel.make_mesh(
                {"dp": 2}, devices=None if where == "card" else
                [torch.device("cpu")] * 2)
            tr = parallel.DataParallelTrainer(
                net, ce, "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                mesh=mesh, shard_updates=path != "psum",
                bucket_mb=DP2_BUCKET_MB if many else None)
            losses = []
            for i in range(xs.shape[0]):
                if i == DP_STEPS:
                    tr.set_learning_rate(tr.learning_rate / 2)
                sl = slice(rank * half, (rank + 1) * half)
                y = ys[i][sl] % DP2_BUCKETS_NET["classes"] if many \
                    else ys[i][sl]
                losses.append(float(tr.step(xs[i][sl], y).asnumpy()))
            out["losses"][f"{path}/{where}"] = losses
            out[f"{path}/{where}/eager"] = not tr._use_graphs
            if tr._plan is not None:       # ZeRO-1: (padded, filled)
                out["buckets"][f"{path}/{where}"] = [
                    (n, sum(tr._plan.sizes[i] for i in idxs))
                    for n, idxs in zip(tr._plan.lengths, tr._plan.buckets)]
            for k, v in block_weights_to_numpy(net).items():
                arrays[f"{path}/{where}/{k}"] = v
            del net, tr
    torch.cuda.synchronize(dev)
    out["launches"] = ops.launch_counts()
    out["_arrays"] = arrays
    return out


def dp2_card_vs_cpu(dev, card):
    """Phase 39b: two processes share the card over gloo (each rank's
    step runs eagerly: gloo's collectives cannot be captured), phase
    16's conv net (SGD momentum 0.9, lr 0.1, a global batch of 8 x 3 x
    32 x 32, 3 steps, the rate halved, a 4th), on the psum path, under
    ZeRO-1 in one 32 MiB bucket, and under ZeRO-1 over at least three
    buckets at least one of which is padded (``DP2_BUCKETS_NET`` in
    ``DP2_BUCKET_MB``: the shards' offsets, the padding and their
    concatenation across buckets); each rank also runs the same dp = 2
    steps on the CPU in the same gloo group.  Fails unless, on each
    path, the losses are within phase 16's 1e-4 and each parameter's
    update within its 1e-3 (``update_errs``) card against CPU, and the
    two ranks' parameters are bitwise equal on the card and on the
    CPU.  K1 launches once a step on each rank: on the whole buffer
    (psum) or on the rank's shard (ZeRO-1)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.convert import block_weights_to_numpy
    from mxnet_tpu_torch.ops import _build
    tmp = os.path.join(_build.BUILD_DIR, "phase39b")
    os.makedirs(tmp, exist_ok=True)
    rng = np.random.RandomState(39)
    with mx.cpu():
        net = _dp_conv_net(gluon.nn)
        mx.random.seed(39)
        net.initialize(mx.init.Xavier(magnitude=2))
        net(mx.nd.zeros((1, 3, 32, 32)))
        many = _dp_conv_net(gluon.nn, **DP2_BUCKETS_NET)
        many.initialize(mx.init.Xavier(magnitude=2))
        many(mx.nd.zeros((1, 3, 32, 32)))
    w0s = {"psum": block_weights_to_numpy(net),
           "zero1_buckets": block_weights_to_numpy(many)}
    w0s["zero1"] = w0s["psum"]
    np.savez(os.path.join(tmp, "w0.npz"), **w0s["psum"])
    np.savez(os.path.join(tmp, "w0b.npz"), **w0s["zero1_buckets"])
    np.savez(os.path.join(tmp, "batches.npz"),
             x=rng.rand(DP_STEPS + 1, DP_CONV_BATCH, 3, 32, 32)
             .astype(np.float32),
             y=rng.randint(0, 10, (DP_STEPS + 1, DP_CONV_BATCH))
             .astype(np.float32))
    t0 = time.perf_counter()
    outs = _run_dp_children("card_vs_cpu", os.path.join(tmp, "run"), {
        "weights": os.path.join(tmp, "w0.npz"),
        "weights_buckets": os.path.join(tmp, "w0b.npz"),
        "batches": os.path.join(tmp, "batches.npz")})
    wall = time.perf_counter() - t0
    arrays = [dict(np.load(os.path.join(tmp, "run", f"rank{r}.npz")))
              for r in range(2)]
    lines, bad = [], []
    for path in DP2_PATHS:
        w0 = w0s[path]
        trainable = [k for k in w0 if "running_" not in k]
        got = {w: {k: arrays[0][f"{path}/{w}/{k}"] for k in trainable}
               for w in ("card", "cpu")}
        lc, lp = outs[0]["losses"][f"{path}/card"], \
            outs[0]["losses"][f"{path}/cpu"]
        loss_err = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(lc, lp))
        errs = update_errs({k: w0[k] for k in trainable}, got["card"],
                           got["cpu"], DP_STEPS + 1)
        worst = max(errs.items(), key=lambda kv: kv[1])
        same = {w: all(np.array_equal(arrays[0][f"{path}/{w}/{k}"],
                                      arrays[1][f"{path}/{w}/{k}"])
                       for k in w0 if "running_" not in k)
                for w in ("card", "cpu")}
        eager = outs[0][f"{path}/card/eager"]
        if loss_err > TRAIN_LOSS_RTOL or worst[1] > RESNET_UPDATE_RTOL:
            bad.append(f"{path}: losses {loss_err:.3e}, update {worst}")
        if not (same["card"] and same["cpu"]):
            bad.append(f"{path}: ranks differ {same}")
        if not eager:
            bad.append(f"{path}: the gloo trainer did not run eagerly")
        buckets = outs[0]["buckets"].get(f"{path}/card")
        if buckets != outs[0]["buckets"].get(f"{path}/cpu"):
            bad.append(f"{path}: the card's buckets {buckets} are not the "
                       f"CPU's {outs[0]['buckets'].get(path + '/cpu')}")
        if path == "zero1_buckets" and not (
                len(buckets) >= 3 and any(n > f for n, f in buckets)):
            bad.append(f"{path}: buckets (padded, filled) {buckets}: fewer "
                       f"than three or none padded")
        lines.append(f"{path}: losses card {lc} cpu {lp}, max relative "
                     f"loss diff {loss_err:.3e} (limit {TRAIN_LOSS_RTOL}), "
                     f"worst relative update diff {worst[1]:.3e} at "
                     f"{worst[0]} (limit {RESNET_UPDATE_RTOL}); ranks "
                     f"bitwise equal on the card {same['card']} and the "
                     f"CPU {same['cpu']}" + (
                         f"; buckets (padded, filled) {buckets}"
                         if buckets else ""))
    launches = read_launches("dp2 card vs cpu", {
        "fused_sgd_update": 2 * len(DP2_PATHS) * (DP_STEPS + 1)},
        _sum_counts(outs))
    print(f"dp2 card vs cpu (phase 39b, two processes sharing {card} over "
          f"gloo, eager steps; each rank also on the CPU): "
          + " | ".join(lines) + f"; phase wall {wall:.1f} s; launches "
          f"{launches}", flush=True)
    if bad:
        fail("dp2 card vs cpu: " + "; ".join(bad))
    return launches


def _dp2_resnet_rank(spec, rank, dev):
    """Phase 39c, one rank: ``bench.py``'s dp configuration, this rank's
    64 of the 128 images."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, gluon, ops, parallel
    from mxnet_tpu_torch.gluon.model_zoo import vision
    amp.init("bfloat16")
    try:
        mx.random.seed(0)
        net = vision.resnet50_v1(s2d_stem=True)
        net.initialize()
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        tr = parallel.DataParallelTrainer(
            net, ce, "sgd", {"learning_rate": RESNET_LR,
                             "momentum": RESNET_MOMENTUM},
            mesh=parallel.make_mesh({"dp": 2}), shard_updates=True)
        mx.random.seed(1 + rank)
        batch = (mx.nd.random.uniform(shape=(DP2_RESNET_BATCH, 3,
                                             RESNET_SIZE, RESNET_SIZE)),
                 mx.nd.zeros((DP2_RESNET_BATCH,)))
        torch.cuda.reset_peak_memory_stats(dev)
        losses = [tr.step(*batch) for _ in range(DP_WARMUP)]
        torch.cuda.synchronize(dev)
        ops.reset_launches()
        step_s = []
        for _ in range(DP_TIMED):
            t = time.perf_counter()
            losses.append(tr.step(*batch))
            torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t)
        launches = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        step_ms = statistics.median(step_s) * 1e3
        comm = tr.comm_stats(measure=True, iters=5)
        update_ms = update_device_ms(tr)
        shard = tr._flat_upd.numel()
        bucket = tr._flat_p.numel()
        params = [p for p in net.collect_params().values()
                  if p.grad_req != "null"]
        same = float(sum(float(p.data().data.detach().double().sum())
                         for p in params))
    finally:
        amp._deinit_for_tests()
    return {"losses": [float(x.asnumpy()) for x in losses],
            "step_ms": step_ms, "step_min_ms": min(step_s) * 1e3,
            "step_max_ms": max(step_s) * 1e3, "peak_gb": peak_gb,
            "comm": comm, "update_ms": update_ms, "shard": shard,
            "bucket": bucket, "checksum": same, "launches": launches,
            "eager": not tr._use_graphs}


def dp2_resnet(dev, card):
    """Phase 39c: ``bench.py``'s dp configuration (``_bench_resnet`` with
    ``MXTPU_BENCH_DP=2``) at full width: ResNet-50 v1 (s2d stem), a
    global batch of 128 as 2 ranks x 64 (``nd.random.uniform``, seeded a
    rank; labels zeros), bf16 AMP, SGD lr 0.1 momentum 0.9,
    ``shard_updates=True`` (ZeRO-1, fp32 wire, 32 MiB buckets), 3
    warm-up and 20 timed steps, two processes sharing the card over gloo
    (eager steps; gloo stages each collective through the host).  Prints
    each rank's step median and the images/s of the two ranks together,
    marked as two ranks sharing one card (no scaling figure), phase 17's
    dp = 1 figures beside them, ``comm_stats(measure=True)``, K1's
    launches (one a step a rank, on the rank's shard) and its device
    time on the shard (``update_device_ms``) against its bytes bound,
    and each process's peak memory.  Fails unless K1 ran once a timed
    step on each rank, the losses are finite and fall, and the two
    ranks' parameters agree (their sums equal)."""
    from mxnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    outs = _run_dp_children("resnet", os.path.join(_build.BUILD_DIR,
                                                   "phase39c"))
    wall = time.perf_counter() - t0
    launches = read_launches("dp2 resnet", {
        "fused_sgd_update": 2 * DP_TIMED}, _sum_counts(outs))
    bad = []
    for r, o in enumerate(outs):
        if not all(x == x and abs(x) < float("inf") for x in o["losses"]):
            bad.append(f"rank {r}: non-finite loss {o['losses']}")
        if not o["losses"][-1] < o["losses"][0]:
            bad.append(f"rank {r}: the loss did not fall {o['losses']}")
        if not o["eager"]:
            bad.append(f"rank {r}: the gloo trainer did not run eagerly")
    if outs[0]["checksum"] != outs[1]["checksum"]:
        bad.append(f"the ranks' parameters differ: sums "
                   f"{outs[0]['checksum']} {outs[1]['checksum']}")
    step_ms = max(o["step_ms"] for o in outs)
    shard = outs[0]["shard"]
    bound_ms = UPDATE_STREAMS["sgd"] * 4 * shard / H100_BYTES_PER_S * 1e3
    dp1 = STEP_MS.get(("resnet", "sgd", None))
    comm = outs[0]["comm"]
    print(f"dp2 resnet (phase 39c, bench.py's dp configuration: ResNet-50 "
          f"v1 s2d, bf16 amp, sgd lr {RESNET_LR} momentum "
          f"{RESNET_MOMENTUM}, ZeRO-1, 2 ranks x {DP2_RESNET_BATCH} images "
          f"as two processes SHARING ONE {card} over gloo, eager steps; "
          f"not a scaling figure): step median rank 0 "
          f"{outs[0]['step_ms']:.2f} ms (min {outs[0]['step_min_ms']:.2f}, "
          f"max {outs[0]['step_max_ms']:.2f}), rank 1 "
          f"{outs[1]['step_ms']:.2f} ms = "
          f"{2 * DP2_RESNET_BATCH / step_ms * 1e3:.1f} images/s of the two "
          f"ranks together over {DP_TIMED} steps after {DP_WARMUP} "
          f"warm-up; losses rank 0 {outs[0]['losses']}; comm {comm}; K1 "
          f"on the {shard}-element shard of the {outs[0]['bucket']}-element "
          f"padded bucket (one captured graph of the update, 10 replays) "
          f"{outs[0]['update_ms']:.4f} / {outs[1]['update_ms']:.4f} ms "
          f"device time, its bound {bound_ms:.4f} ms (5 f32 streams at "
          f"{H100_BYTES_PER_S / 1e12} TB/s); peak memory "
          f"{outs[0]['peak_gb']:.2f} / {outs[1]['peak_gb']:.2f} GB a "
          f"process"
          + (f"; phase 17 at dp = 1 on this card earlier in this run: "
             f"{dp1[0]:.2f} ms = {RESNET_BATCH / dp1[0] * 1e3:.1f} "
             f"images/s, peak {dp1[1]:.2f} GB" if dp1 else "")
          + f"; phase wall {wall:.1f} s; launches {launches}", flush=True)
    if bad:
        fail("dp2 resnet: " + "; ".join(bad))
    return launches


# ----------------------------------------------------------------------
# phases 40-43: the recurrent layers, the language models, the vision
# classifiers and SSD (ROADMAP §1 item 11a), through the CachedOp and
# the Gluon loop
# ----------------------------------------------------------------------

# phase 40: AWD-LSTM's WikiText-2 geometry (T = 70, B = 80, input 400)
RNN_T, RNN_B, RNN_I = 70, 80, 400
RNN_CASES = (("lstm", 3, 1150, False), ("gru", 3, 1150, False),
             ("lstm", 2, 512, True))
RNN_OUT_ATOL = 1e-4     # outputs and final states, values in (-1, 1)
RNN_GRAD_RTOL = 1e-3    # each gradient's relative difference by norm
RNN_TIMED = 10
# phase 41: awd_lstm_lm_1150 at GluonNLP's WikiText-2 recipe
LM_VOCAB, LM_BATCH, LM_BPTT, LM_CHECK_BATCH = 33278, 80, 70, 8
LM_LR, LM_CLIP, LM_WD = 30.0, 0.25, 1.2e-6
LM_WARMUP, LM_TIMED, LM_TRACED = 2, 6, 2
LM_LOSS_RTOL, LM_GRAD_RTOL = 1e-4, 1e-3
# phase 42: one classifier a family, predict mode at batch 2
CLF_CASES = (("alexnet", 224), ("vgg16_bn", 224), ("squeezenet1_1", 224),
             ("densenet121", 224), ("inception_v3", 299),
             ("mobilenet1_0", 224), ("mobilenet_v2_1_0", 224),
             ("resnext50_32x4d", 224), ("se_resnet50", 224),
             ("resnest50", 224))
CLF_BATCH = 2
# x max |logit| (with ``Xavier(magnitude=2)``'s averaged fans the
# depthwise and squeeze stages shrank random-weight logits to 1e-22-1e-2;
# the phase draws He's initialization, and the limit is relative)
CLF_LOGIT_TOL = 1e-4
# MobileNet v2's gradients on the card against float64 on the CPU, in
# predict and in training mode.  ReLU6 passes a unit's whole gradient or
# none of it, so where f32 rounding puts a unit on the other side of 0 or
# 6 the backward signal moves by about that unit's share of its layer:
# card against CPU the gradients read 7.45e-3 apart by norm on an H100,
# the CPU at f32 against float64 2.3e-3 (predict) and 8.8e-3 (training)
# at batch 4, and 1.6e-6 and 1.1e-5 where float64 takes the f32 run's
# gates (tools/port_mobilenet_kinks.py).  So the float64 reference
# passes each ReLU6's gradient where the card's did (``relu6_gates``),
# and the card is held at phase 16's limits: the loss within
# TRAIN_LOSS_RTOL, each gradient within RESNET_UPDATE_RTOL of its norm
# plus MBV2_GRAD_ATOL.  That floor holds the gradients that invariance
# makes zero or small in training mode, which are rounding noise in
# f32: the bottlenecks' last betas (out.7, whose shift the next
# BatchNorm removes) and the expansions' gammas (out.1: ReLU6 is
# homogeneous below 6, so the next BatchNorm removes their scale but
# for the units clipped at 6); at batch 4 on the CPU they read 1.44e-5
# apart, at this phase's batch 64 on an H100 1.84e-5
# (features.3.out.7.beta)
MBV2_GRAD_ATOL = 5e-5
MBV2_CHECK_STEPS = 3
MBV2_BATCH, MBV2_LR, MBV2_WARMUP, MBV2_TIMED, MBV2_TRACED = 64, 0.1, 2, 8, 2
# phase 43: ssd_300_resnet34_v1 at batch 8
SSD_BATCH, SSD_SIZE, SSD_GT = 8, 300, 3
SSD_RAW_TOL = 1e-4      # x max(1, max |x|): class and box predictions
SSD_BOX_TOL = 1e-3      # boxes of matched detections, in [0, 1]
SSD_TIE_IOU = 1e-4      # suppression within this of the threshold: a tie
SSD_LR, SSD_MOMENTUM = 0.01, 0.9
# each parameter's one-step update, card against CPU.  ReLU's kink at 0
# makes the step sensitive to rounding: one ulp more in half of the
# input's elements moves the CPU's own update by 4.459e-4 all together
# and by 2.220e-3 at the stage-1 betas behind the zeroed gammas (this
# phase prints both, from an H100's host), what the card reads against
# the CPU (4.462e-4, and 2.219e-3 at features.stage1.4.0.body.4.beta).
# So the phase runs that CPU step too, and holds each parameter's
# card-against-CPU update within RESNET_UPDATE_RTOL plus SSD_SPREAD_X
# times what one ulp of input moved it on the CPU (the whole update
# within RESNET_UPDATE_RTOL)
SSD_SPREAD_X = 2.0
SSD_TIMED = 5


def _cuda_launches(fn):
    """The CUDA kernels ``fn()`` launches (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def _busy_ms(prof, steps):
    """Device time a step from a ``torch.profiler`` window."""
    import torch
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / \
        1e3 / steps


def _rnn_run(mx, net, ctx, x, h0, cot):
    """One recorded forward and backward of a fused layer: the output,
    the final states and every gradient, as numpy."""
    from mxnet_tpu_torch import autograd
    with ctx:
        xa = mx.nd.array(x)
        st = [mx.nd.array(h) for h in h0]
        c = mx.nd.array(cot)
    for a in [xa] + st:
        a.attach_grad()
    with autograd.record():
        out, new = net(xa, st)
        loss = (out * c).sum() + sum((s * s).sum() for s in new)
    loss.backward()
    grads = {"x": xa.grad.asnumpy()}
    grads.update({f"state{i}": s.grad.asnumpy() for i, s in enumerate(st)})
    grads.update({k: p.grad().asnumpy() for k, p in
                  net._collect_params_with_prefix().items()})
    return [out.asnumpy()] + [s.asnumpy() for s in new], grads


def rnn_full_width(dev, card):
    """Phase 40: ``gluon.rnn.LSTM`` and ``GRU`` at 3 layers, hidden 1150,
    input 400, T = 70, B = 80 (AWD-LSTM's WikiText-2 geometry), and a
    bidirectional 2-layer LSTM of hidden 512, hybridized on the card:
    weights ``Uniform(1/sqrt(H))`` from ``mx.random.seed(40)`` made on
    the host, inputs, initial states and the output's cotangent from
    ``RandomState(40)``; the third call (a replay of the captured forward
    and backward) against one eager call on the CPU: outputs and final
    states within ``RNN_OUT_ATOL``, every gradient (input, states, each
    weight) within ``RNN_GRAD_RTOL`` of its norm.  Then the replayed
    forward and backward timed by CUDA events over ``RNN_TIMED`` calls
    beside ``torch.nn.LSTM``/``GRU`` (cuDNN) on the same weights, the
    library's time for the same shape; ``nd.RNN`` over the packed vector
    checked against the layer on the card.  No kernel of the port
    runs."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, ops
    from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                         load_block_weights,
                                         rnn_packed_vector)
    t_phase = time.perf_counter()
    ops.reset_launches()
    lines, failed = [], []
    gpu = mx.gpu(dev.index or 0)
    for mode, layers, hidden, bi in RNN_CASES:
        ndir = 2 if bi else 1
        rng = np.random.RandomState(40)
        x = rng.randn(RNN_T, RNN_B, RNN_I).astype(np.float32)
        h0 = [(rng.randn(layers * ndir, RNN_B, hidden) * 0.5)
              .astype(np.float32) for _ in range(2 if mode == "lstm" else 1)]
        cot = rng.randn(RNN_T, RNN_B, hidden * ndir).astype(np.float32)
        cls = mx.gluon.rnn.LSTM if mode == "lstm" else mx.gluon.rnn.GRU

        def make():
            return cls(hidden, layers, bidirectional=bi, input_size=RNN_I,
                       prefix="r_")
        host = make()
        mx.random.seed(40)
        host.initialize(mx.init.Uniform(1 / np.sqrt(hidden)), ctx=mx.cpu())
        weights = block_weights_to_numpy(host)
        want_out, want_g = _rnn_run(mx, host, mx.cpu(), x, h0, cot)
        net = make()
        net.initialize(ctx=gpu)
        load_block_weights(net, weights)
        net.hybridize()
        for _ in range(3):
            got_out, got_g = _rnn_run(mx, net, gpu, x, h0, cot)
        out_err = max(float(np.abs(g - w).max())
                      for g, w in zip(got_out, want_out))
        grad_err = {k: _rel(got_g[k], want_g[k]) for k in want_g}
        worst = max(grad_err, key=grad_err.get)
        # the timed replays: forward and backward of the captured graphs
        with gpu:
            xa = mx.nd.array(x)
            st = [mx.nd.array(h) for h in h0]
            c = mx.nd.array(cot)
        for a in [xa] + st:
            a.attach_grad()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize(dev)
        ev[0].record()
        for _ in range(RNN_TIMED):
            with autograd.record():
                out, new = net(xa, st)
                loss = (out * c).sum() + sum((s * s).sum() for s in new)
            loss.backward()
        ev[1].record()
        torch.cuda.synchronize(dev)
        port_ms = ev[0].elapsed_time(ev[1]) / RNN_TIMED
        stats = dict(net._cached_op.stats)
        # the library's: torch.nn.LSTM / GRU (cuDNN), the same weights
        lib = (torch.nn.LSTM if mode == "lstm" else torch.nn.GRU)(
            RNN_I, hidden, layers, bidirectional=bi).to(dev)
        with torch.no_grad():
            for layer in range(layers):
                for d, tag in enumerate(["l", "r"][:ndir]):
                    sfx = f"_l{layer}" + ("_reverse" if d else "")
                    for a, b in (("weight_ih", "i2h_weight"),
                                 ("weight_hh", "h2h_weight"),
                                 ("bias_ih", "i2h_bias"),
                                 ("bias_hh", "h2h_bias")):
                        getattr(lib, a + sfx).copy_(torch.from_numpy(
                            weights[f"{tag}{layer}_{b}"]))
        tx = torch.from_numpy(x).to(dev).requires_grad_()
        th = [torch.from_numpy(h).to(dev) for h in h0]
        tc = torch.from_numpy(cot).to(dev)

        def lib_step():
            out, hn = lib(tx, tuple(th) if mode == "lstm" else th[0])
            hn = hn if isinstance(hn, tuple) else (hn,)
            loss = (out * tc).sum() + sum((s * s).sum() for s in hn)
            loss.backward()
            return out
        lib_out = lib_step()
        lib_err = float((lib_out.detach().cpu() -
                         torch.from_numpy(want_out[0])).abs().max())
        torch.cuda.synchronize(dev)
        ev[0].record()
        for _ in range(RNN_TIMED):
            lib_step()
        ev[1].record()
        torch.cuda.synchronize(dev)
        lib_ms = ev[0].elapsed_time(ev[1]) / RNN_TIMED
        # nd.RNN over the packed vector, on the card
        vec = mx.nd.array(rnn_packed_vector(host), ctx=gpu)
        with gpu:
            rnn_out = mx.nd.RNN(mx.nd.array(x), vec, mx.nd.array(h0[0]),
                                state_cell=mx.nd.array(h0[1])
                                if mode == "lstm" else None,
                                num_layers=layers, mode=mode,
                                bidirectional=bi)
        op_err = float(np.abs(rnn_out.asnumpy() - want_out[0]).max())
        flops = 2 * 3 * RNN_T * RNN_B * sum(
            (4 if mode == "lstm" else 3) * hidden *
            ((RNN_I if layer == 0 else hidden * ndir) + hidden) * ndir
            for layer in range(layers))
        name = f"{'bi-' if bi else ''}{mode} {layers}x{hidden}"
        lines.append(
            f"{name}: outputs/states max diff {out_err:.3e} (limit "
            f"{RNN_OUT_ATOL}), gradients worst {grad_err[worst]:.3e} at "
            f"{worst} (limit {RNN_GRAD_RTOL}), nd.RNN on the card "
            f"{op_err:.3e}; forward+backward {port_ms:.2f} ms a replayed "
            f"call ({flops / port_ms / 1e9:.1f} TFLOP/s of the products) "
            f"vs torch.nn.{mode.upper()} (cuDNN) {lib_ms:.2f} ms "
            f"({port_ms / lib_ms:.2f}x; cuDNN's output vs the CPU "
            f"{lib_err:.2e}); CachedOp {stats}")
        if not out_err <= RNN_OUT_ATOL:
            failed.append(f"{name} outputs {out_err:.3e}")
        if not grad_err[worst] <= RNN_GRAD_RTOL:
            failed.append(f"{name} gradient {worst} {grad_err[worst]:.3e}")
        if not op_err <= RNN_OUT_ATOL:
            failed.append(f"{name} nd.RNN {op_err:.3e}")
        if stats["captures"] != 1 or stats["replays"] < 1 + RNN_TIMED:
            failed.append(f"{name} did not replay its capture: {stats}")
        del net, lib, host
        torch.cuda.empty_cache()
    launches = read_launches("phase 40 rnn", {})
    print(f"phase 40 fused RNN layers on {card} (f32, T={RNN_T}, "
          f"B={RNN_B}, input {RNN_I}, hybridized: the third call a replay "
          f"against one CPU call): " + "; ".join(lines) +
          f"; launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if failed:
        fail("phase 40: " + "; ".join(failed))
    return launches


def _lm_grads(mx, net, ctx, x, y):
    """One recorded forward and backward of a language model in predict
    mode (dropout off): the mean loss and every gradient, as numpy."""
    from mxnet_tpu_torch import autograd, gluon
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    with ctx:
        xa, ya = mx.nd.array(x), mx.nd.array(y)
    with autograd.record(train_mode=False):
        logits, _ = net(xa)
        loss = ce(logits, ya).mean()
    loss.backward()
    return float(loss.asscalar()), {
        k: p.grad().asnumpy() for k, p in
        net._collect_params_with_prefix().items()}


def lm_training(dev, card):
    """Phase 41: ``awd_lstm_lm_1150`` (vocabulary 33,278, embedding 400,
    hidden 1150, three LSTM layers, tied weights, GluonNLP's dropouts)
    hybridized on the card through the Gluon loop at GluonNLP's
    WikiText-2 recipe: batch 80 x bptt 70 of token ids from
    ``RandomState(41)``, ``SoftmaxCrossEntropyLoss`` mean, backward,
    ``clip_global_norm`` of the gradients to 0.25, ``Trainer("sgd",
    lr 30, wd 1.2e-6)`` (K1 a step).  Weights ``Xavier()`` from
    ``mx.random.seed(41)`` on the host.  The check: the first step's
    loss and every gradient in predict mode (dropout off, whose masks
    come from each device's generator) on the first 8 sequences of the
    batch, card (hybridized) against CPU: loss within ``LM_LOSS_RTOL``,
    gradients within ``LM_GRAD_RTOL`` of their norms.  Then
    ``LM_WARMUP + LM_TIMED + LM_TRACED`` training steps at batch 80 with
    dropout: step ms (CUDA events), tokens/s, host share from the
    traced steps, captures and K1 launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, ops
    from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                         load_block_weights)
    from mxnet_tpu_torch.gluon.model_zoo import nlp
    from mxnet_tpu_torch.gluon.utils import clip_global_norm
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gpu = mx.gpu(dev.index or 0)
    rng = np.random.RandomState(41)
    x = rng.randint(0, LM_VOCAB, (LM_BPTT, LM_BATCH)).astype(np.float32)
    y = rng.randint(0, LM_VOCAB, (LM_BPTT, LM_BATCH)).astype(np.float32)
    host = nlp.awd_lstm_lm_1150(vocab_size=LM_VOCAB)
    mx.random.seed(41)
    host.initialize(mx.init.Xavier(), ctx=mx.cpu())
    xs, ys = x[:, :LM_CHECK_BATCH], y[:, :LM_CHECK_BATCH]
    want_loss, want_g = _lm_grads(mx, host, mx.cpu(), xs, ys)
    weights = block_weights_to_numpy(host)
    del host
    net = nlp.awd_lstm_lm_1150(vocab_size=LM_VOCAB)
    net.initialize(ctx=gpu)
    load_block_weights(net, weights)
    net.hybridize()
    got_loss, got_g = _lm_grads(mx, net, gpu, xs, ys)
    loss_err = abs(got_loss - want_loss) / abs(want_loss)
    grad_err = {k: _rel(got_g[k], want_g[k]) for k in want_g}
    worst = max(grad_err, key=grad_err.get)
    del got_g, want_g
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": LM_LR, "wd": LM_WD})
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    with gpu:
        xa, ya = mx.nd.array(x), mx.nd.array(y)
    steps = LM_WARMUP + LM_TIMED + LM_TRACED
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    prof = profile(activities=[ProfilerActivity.CUDA])
    ops.reset_launches()
    losses, norms, tops = [], [], []
    for step in range(steps):
        if step == LM_WARMUP:
            ev[0].record()
        if step == LM_WARMUP + LM_TIMED:
            ev[1].record()
            torch.cuda.synchronize(dev)
            tops.append(time.perf_counter())
            prof.__enter__()
        with autograd.record():
            logits, _ = net(xa)
            loss = ce(logits, ya).mean()
        loss.backward()
        norms.append(clip_global_norm([p.grad() for p in params], LM_CLIP))
        trainer.step(1)
        losses.append(loss)
    torch.cuda.synchronize(dev)
    tops.append(time.perf_counter())
    prof.__exit__(None, None, None)
    launches = read_launches("phase 41 awd-lstm",
                             {"fused_sgd_update": steps})
    step_ms = ev[0].elapsed_time(ev[1]) / LM_TIMED
    traced_ms = (tops[1] - tops[0]) * 1e3 / LM_TRACED
    busy = _busy_ms(prof, LM_TRACED)
    losses = [float(v.asscalar()) for v in losses]
    stats = dict(net._cached_op.stats)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n_params = sum(p.data().size for p in params)
    print(f"phase 41 awd_lstm_lm_1150 on {card} (f32, hybridized, vocab "
          f"{LM_VOCAB}, {n_params} parameters, batch {LM_BATCH} x bptt "
          f"{LM_BPTT}, sgd lr {LM_LR} wd {LM_WD}, clip_global_norm "
          f"{LM_CLIP}): check on the first {LM_CHECK_BATCH} sequences in "
          f"predict mode, loss card {got_loss:.6f} cpu {want_loss:.6f} (rel "
          f"{loss_err:.2e}, limit {LM_LOSS_RTOL}), gradients worst "
          f"{grad_err[worst]:.3e} at {worst} (limit {LM_GRAD_RTOL}); "
          f"{steps} steps with dropout, losses "
          f"{[round(v, 4) for v in losses]}, norms before the clip "
          f"{[round(v, 3) for v in norms]}; step {step_ms:.2f} ms (CUDA "
          f"events over {LM_TIMED} steps), {LM_BATCH * LM_BPTT / step_ms * 1e3:.0f} "
          f"tokens/s; traced steps {traced_ms:.2f} ms wall, device busy "
          f"{busy:.2f} ms, host share {1 - busy / step_ms:.4f} of the "
          f"untraced step; peak memory {peak_gb:.2f} GB; CachedOp {stats}; "
          f"launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    failed = [what for what, ok in (
        (f"loss {loss_err:.3e}", loss_err <= LM_LOSS_RTOL),
        (f"gradient {worst} {grad_err[worst]:.3e}",
         grad_err[worst] <= LM_GRAD_RTOL),
        (f"losses {losses}", all(np.isfinite(losses))),
        (f"captures {stats}", stats["captures"] >= 1 and
         stats["replays"] >= LM_TIMED + LM_TRACED)) if not ok]
    if failed:
        fail("phase 41: " + "; ".join(failed))
    del net, trainer, xa, ya
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _he_init():
    """He's normal initialization (``Xavier("gaussian", "in", 2)``): it
    keeps a layer's variance, so random-weight activations do not vanish
    through the depthwise stages and no BatchNorm divides by a tiny
    batch deviation."""
    import mxnet_tpu_torch as mx
    return mx.init.Xavier("gaussian", "in", 2)


def _host_net(make, x, seed, init=None):
    """A net made by ``make()`` on the host, ``init`` (default
    ``Xavier(magnitude=2)``) from ``mx.random.seed(seed)``, its deferred
    shapes resolved by a predict-mode forward on ``x``; (net, that
    forward as numpy)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    net = make()
    with mx.cpu():
        mx.random.seed(seed)
        net.initialize(init or mx.init.Xavier(magnitude=2))
        with autograd.predict_mode():
            out = net(mx.nd.array(x))
    if isinstance(out, (list, tuple)):
        return net, [o.asnumpy() for o in out]
    return net, out.asnumpy()


def relu6_gates(net):
    """Hooks on each ReLU6 block of ``net`` (MobileNet's ``_RELU6``) that
    record, at every forward, which of its inputs pass their gradient
    (``torch.clamp``'s rule, 0 <= x <= 6): bool tensors on the host, in
    call order.  Returns the list they append to."""
    from mxnet_tpu_torch.gluon.model_zoo.vision.mobilenet import _RELU6
    gates = []

    def hook(block, inputs):
        t = inputs[0].data
        gates.append(((t >= 0) & (t <= 6)).cpu())

    def walk(block):
        if isinstance(block, _RELU6):
            block.register_forward_pre_hook(hook)
        for child in block._children.values():
            walk(child)
    walk(net)
    return gates


# MobileNet v2's 17 linear bottlenecks' strides (features.3-19)
MBV2_STRIDES = (1, 2, 1, 2, 1, 1, 2) + (1,) * 6 + (2, 1, 1, 1)


def mobilenet_v2_plain(w, x, y, train, gates=None):
    """MobileNet v2 (any width) written out in plain PyTorch in float64 on
    the CPU from its weights ``w`` (structural names, numpy): the loss
    (softmax cross-entropy averaged over the batch) of images ``x``
    against labels ``y``, and its gradients, BatchNorm on the batch's
    statistics if ``train``, else on the running ones.  Given ``gates``
    (``relu6_gates``' record of a run of the same step), each ReLU6
    passes its gradient where that run's did.  Returns (loss, {name:
    gradient as numpy}, the units whose own gate differed from
    ``gates``')."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    dt = torch.float64
    p = {k: torch.tensor(v, dtype=dt, requires_grad=not k.endswith(
        ("running_mean", "running_var"))) for k, v in w.items()}
    flips = [0]
    gate_iter = iter(gates) if gates is not None else None

    def relu6(h):
        if gate_iter is None:
            return h.clamp(0, 6)
        gate = next(gate_iter)
        flips[0] += int((gate != ((h >= 0) & (h <= 6))).sum())
        return torch.where(gate, h, h.detach().clamp(0, 6))

    def conv_bn(h, conv, bn, stride=1, groups=1, act=True):
        k = p[conv + ".weight"]
        h = F.conv2d(h, k, stride=stride, padding=k.shape[-1] // 2,
                     groups=groups)
        h = F.batch_norm(h, None if train else p[bn + ".running_mean"],
                         None if train else p[bn + ".running_var"],
                         p[bn + ".gamma"], p[bn + ".beta"], training=train,
                         eps=1e-5)
        return relu6(h) if act else h
    h = conv_bn(torch.tensor(x, dtype=dt), "features.0", "features.1", 2)
    for i, stride in enumerate(MBV2_STRIDES):
        b = f"features.{i + 3}.out."
        wide = p[b + "0.weight"].shape[0]
        o = conv_bn(h, b + "0", b + "1")
        o = conv_bn(o, b + "3", b + "4", stride, wide)
        o = conv_bn(o, b + "6", b + "7", act=False)
        h = o + h if stride == 1 and o.shape[1] == h.shape[1] else o
    h = conv_bn(h, "features.20", "features.21").mean((2, 3), keepdim=True)
    logits = F.conv2d(h, p["output.0.weight"]).flatten(1)
    loss = F.cross_entropy(logits, torch.from_numpy(
        np.asarray(y, np.int64)))
    loss.backward()
    return float(loss.detach()), {k: t.grad.numpy() for k, t in p.items()
                                  if t.grad is not None}, flips[0]


def classifiers(dev, card):
    """Phase 42: one classifier of each family at full width and its
    published input size, predict mode at batch 2, hybridized on the
    card (the third call a replay) against the CPU from the same weights
    (He's normal initialization, ``_he_init``, from ``mx.random.seed(42)``,
    made on the host):
    logits within ``CLF_LOGIT_TOL`` x max |logit|.  Then
    ``mobilenet_v2_1_0`` trains at 224 x 224, batch 64, f32, through the
    Gluon loop (hybridized, ``SoftmaxCrossEntropyLoss``, ``Trainer
    ("sgd", lr 0.1, momentum 0.9)``, K1 a step), on cuDNN's
    deterministic algorithms: its loss and gradients in predict and in
    training mode, eager on the card, against ``mobilenet_v2_plain`` in
    float64 on the CPU with each ReLU6 passing its gradient where the
    card's did (phase 16's limits: ``TRAIN_LOSS_RTOL``, each gradient
    within ``RESNET_UPDATE_RTOL`` of its norm plus ``MBV2_GRAD_ATOL``),
    its first
    ``MBV2_CHECK_STEPS`` training steps captured against the eager
    block's on the card (phase
    16's ``DP_GRAPH_RTOL``, losses and each update), then on a fresh net
    captured under cuDNN's own algorithm choice: step ms, images/s, host
    share and peak memory."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, ops
    from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                         load_block_weights)
    from mxnet_tpu_torch.gluon.model_zoo import vision
    t_phase = time.perf_counter()
    gpu = mx.gpu(dev.index or 0)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ops.reset_launches()
    lines, failed = [], []
    for name, size in CLF_CASES:
        t0 = time.perf_counter()
        x = np.random.RandomState(42).rand(CLF_BATCH, 3, size, size) \
            .astype(np.float32)
        host, want = _host_net(lambda: vision.get_model(name), x, 42,
                               _he_init())
        weights = block_weights_to_numpy(host)
        del host
        net = vision.get_model(name)
        net.initialize(ctx=gpu)
        load_block_weights(net, weights)
        net.hybridize()
        with gpu, autograd.predict_mode():
            xa = mx.nd.array(x)
            for _ in range(3):
                got = net(xa).asnumpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        ok = err <= CLF_LOGIT_TOL * scale
        stats = dict(net._cached_op.stats)
        lines.append(f"{name} {size}: {err:.2e} (max |logit| "
                     f"{scale:.2e}, replays "
                     f"{stats['replays']}, {time.perf_counter() - t0:.1f} s)")
        if not ok or stats["replays"] < 1:
            failed.append(f"{name} logits {err:.3e}, CachedOp {stats}")
        del net
        torch.cuda.empty_cache()
    read_launches("phase 42 classifiers", {})
    # mobilenet_v2_1_0 through the Gluon loop: its gradients on the card
    # against float64 on the CPU at the card's ReLU6 gates, its captured
    # steps against eager ones, then the timed steps
    rng = np.random.RandomState(42)
    x = rng.rand(MBV2_BATCH, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, MBV2_BATCH).astype(np.int32)
    host, _ = _host_net(vision.mobilenet_v2_1_0, x[:1], 43, _he_init())
    w0 = block_weights_to_numpy(host)
    del host
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def card_net(active):
        net = vision.mobilenet_v2_1_0()
        net.initialize(ctx=gpu)
        load_block_weights(net, w0)
        net.hybridize(active)
        return net

    grad_checks = {}
    for mode in ("predict", "training"):
        train = mode == "training"
        net = card_net(False)
        gates = relu6_gates(net)
        with gpu:
            xa, ya = mx.nd.array(x), mx.nd.array(y, dtype="int32")
        with autograd.record(train_mode=train):
            loss = ce(net(xa), ya).mean()
        loss.backward()
        card_l = float(loss.asscalar())
        card_g = {k: p.grad().asnumpy() for k, p in
                  net._collect_params_with_prefix().items()
                  if p.grad_req != "null"}
        del net, loss
        t0 = time.perf_counter()
        ref_l, ref_g, flips = mobilenet_v2_plain(w0, x, y, train, gates)
        units = sum(g.numel() for g in gates)
        del gates
        diff = {k: float(np.linalg.norm(card_g[k] - g))
                for k, g in ref_g.items()}
        norm = {k: float(np.linalg.norm(g)) for k, g in ref_g.items()}
        share = {k: diff[k] / (RESNET_UPDATE_RTOL * norm[k] +
                               MBV2_GRAD_ATOL) for k in ref_g}
        worst = max(share, key=share.get)
        grad_checks[mode] = {
            "loss": abs(card_l - ref_l) / abs(ref_l),
            "card_loss": card_l,
            "together": float(np.sqrt(sum(d * d for d in diff.values()) /
                                      sum(n * n for n in norm.values()))),
            "worst": (worst, diff[worst], norm[worst], share[worst]),
            "flips": f"{flips} of {units}",
            "cpu_s": round(time.perf_counter() - t0, 1)}
        del card_g, ref_g
        gc.collect()
    # training mode: MBV2_CHECK_STEPS captured steps (eager warm-up,
    # capture, replays) against the same steps of the eager block
    with gpu:
        xa, ya = mx.nd.array(x), mx.nd.array(y, dtype="int32")
    pair = []
    for active in (True, False):
        net = card_net(active)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": MBV2_LR,
                                 "momentum": RESNET_MOMENTUM})
        ls = [float(_resnet_step(net, ce, trainer, xa, ya, MBV2_BATCH)[0]
                    .mean().asscalar()) for _ in range(MBV2_CHECK_STEPS)]
        pair.append((ls, block_weights_to_numpy(net), net, trainer))
    torch.backends.cudnn.deterministic = prev
    (cap_l, cap_w, _, _), (eag_l, eag_w, _, _) = pair
    del pair
    graph_loss = max(abs(a - b) / abs(b) for a, b in zip(cap_l, eag_l))
    stats_k = [k for k in w0 if k.endswith(("running_mean", "running_var"))]
    graph_upd = update_errs({k: w0[k] for k in w0 if k not in stats_k},
                            cap_w, eag_w, MBV2_CHECK_STEPS)
    graph_worst = max(graph_upd, key=graph_upd.get)
    bitwise = all(np.array_equal(cap_w[k], eag_w[k]) for k in cap_w)
    # the timed steps on a net captured under cuDNN's own algorithm
    # choice (the check's ran on its deterministic ones)
    gc.collect()
    torch.cuda.empty_cache()
    net = card_net(True)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": MBV2_LR,
                             "momentum": RESNET_MOMENTUM})
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    steps = MBV2_WARMUP + MBV2_TIMED + MBV2_TRACED
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    prof = profile(activities=[ProfilerActivity.CUDA])
    losses, tops = [], []
    for step in range(steps):
        if step == MBV2_WARMUP:
            ev[0].record()
        if step == MBV2_WARMUP + MBV2_TIMED:
            ev[1].record()
            torch.cuda.synchronize(dev)
            tops.append(time.perf_counter())
            prof.__enter__()
        loss, _ = _resnet_step(net, ce, trainer, xa, ya, MBV2_BATCH)
        losses.append(loss.mean())
    torch.cuda.synchronize(dev)
    tops.append(time.perf_counter())
    prof.__exit__(None, None, None)
    launches = read_launches("phase 42 mobilenet_v2 training",
                             {"fused_sgd_update": steps})
    step_ms = ev[0].elapsed_time(ev[1]) / MBV2_TIMED
    busy = _busy_ms(prof, MBV2_TRACED)
    losses = [float(v.asscalar()) for v in losses]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    stats = dict(net._cached_op.stats)
    print(f"phase 42 classifiers on {card} (f32, predict mode, batch "
          f"{CLF_BATCH}, hybridized, card vs CPU logits, limit "
          f"{CLF_LOGIT_TOL} x max |logit|): " + "; ".join(lines) +
          f"; mobilenet_v2_1_0 training (224, batch {MBV2_BATCH}, sgd lr "
          f"{MBV2_LR} momentum {RESNET_MOMENTUM}): gradients on the card "
          f"against float64 on the CPU at the card's ReLU6 gates (loss "
          f"limit {TRAIN_LOSS_RTOL}, each gradient {RESNET_UPDATE_RTOL} of "
          f"its norm + {MBV2_GRAD_ATOL}): " + "; ".join(
              f"{m} mode loss {c['card_loss']:.6f} (rel {c['loss']:.2e}), "
              f"all gradients together {c['together']:.3e}, the worst "
              f"against its limit {c['worst'][0]} {c['worst'][1]:.3e} of "
              f"norm {c['worst'][2]:.3e} ({c['worst'][3]:.3f} of its "
              f"limit), gates the float64 forward set otherwise "
              f"{c['flips']}, CPU {c['cpu_s']} s"
              for m, c in grad_checks.items()) +
          f"; "
          f"training mode, "
          f"{MBV2_CHECK_STEPS} captured steps against the eager block's: "
          f"losses {cap_l} vs {eag_l} (rel {graph_loss:.2e}), updates "
          f"worst {graph_upd[graph_worst]:.3e} at {graph_worst} (limit "
          f"{DP_GRAPH_RTOL}), bitwise {bitwise}; {steps} steps, losses "
          f"{[round(v, 4) for v in losses]}; step {step_ms:.2f} ms (CUDA "
          f"events over {MBV2_TIMED} steps), "
          f"{MBV2_BATCH / step_ms * 1e3:.1f} images/s, device busy "
          f"{busy:.2f} ms a traced step, host share "
          f"{1 - busy / step_ms:.4f}; peak memory {peak_gb:.2f} GB; "
          f"CachedOp {stats}; launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    for m, c in grad_checks.items():
        if not (c["loss"] <= TRAIN_LOSS_RTOL and c["worst"][3] <= 1.0):
            failed.append(f"mobilenet_v2 {m} mode: loss {c['loss']:.3e}, "
                          f"{c['worst'][0]} {c['worst'][1]:.3e} of norm "
                          f"{c['worst'][2]:.3e}")
    if not (graph_loss <= DP_GRAPH_RTOL and
            graph_upd[graph_worst] <= DP_GRAPH_RTOL):
        failed.append(f"mobilenet_v2 captured vs eager: losses "
                      f"{graph_loss:.3e}, {graph_worst} "
                      f"{graph_upd[graph_worst]:.3e}")
    if not all(np.isfinite(losses)):
        failed.append(f"mobilenet_v2 losses {losses}")
    if failed:
        fail("phase 42: " + "; ".join(failed))
    del net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _ssd_labels(rng):
    """``SSD_GT`` ground-truth rows [class, x0, y0, x1, y1] an image."""
    import numpy as np
    lab = np.zeros((SSD_BATCH, SSD_GT, 5), np.float32)
    for b in range(SSD_BATCH):
        for g in range(SSD_GT):
            x0, y0 = rng.uniform(0, 0.6, 2)
            w, h = rng.uniform(0.15, 0.4, 2)
            lab[b, g] = [rng.randint(0, 20), x0, y0, min(x0 + w, 1.0),
                         min(y0 + h, 1.0)]
    return lab


def _ssd_step(mx, net, trainer, xa, la):
    """One SSD training step: ``MultiBoxTarget``, softmax cross-entropy
    of the classes (ignored anchors out) and an L1 loss of the box
    offsets over the matched anchors, SGD."""
    from mxnet_tpu_torch import autograd, gluon
    with autograd.record():
        cls_pred, box_pred, anchor = net(xa)
        box_t, box_m, cls_t = mx.nd.contrib.MultiBoxTarget(
            anchor, la, mx.nd.transpose(cls_pred, axes=(0, 2, 1)),
            negative_mining_ratio=3.0)
        valid = cls_t >= 0
        ce = gluon.loss.SoftmaxCrossEntropyLoss()(
            cls_pred, mx.nd.maximum(cls_t, 0), valid)
        l1 = gluon.loss.L1Loss()(box_pred.reshape((0, -1)) * box_m, box_t)
        loss = ce + l1
    loss.backward()
    trainer.step(SSD_BATCH)
    return loss, cls_t


def ssd_detection(dev, card):
    """Phase 43: ``ssd_300_resnet34_v1`` (20 classes, ResNet-34 v1
    features and three extra stages, 8,732 anchors) at batch 8 x 3 x 300
    x 300, weights ``Xavier(magnitude=2)`` from ``mx.random.seed(43)``
    made on the host, each basic block's last BatchNorm gamma zeroed (as
    phase 14: the block starts as its shortcut), hybridized on the card
    against the CPU.  Inference: the class and box predictions (training
    mode's outputs, before decoding) within ``SSD_RAW_TOL``; the
    detections: ``MultiBoxDetection`` (``box_nms`` at 0.45 over the top
    400) on the card against the CPU's over the same inputs (the card's
    predictions, softmax taken once on the host): ids and kept rows equal and
    scores and boxes within ``SSD_BOX_TOL``, except where a suppression
    hinges on an IoU within ``SSD_TIE_IOU`` of the threshold (the tie
    rule); end to end, the CPU's kept detections each matched by one of
    the card's of the same image and class whose box is within
    ``SSD_BOX_TOL`` (printed: share matched; the boxes of matched ones
    held to ``SSD_BOX_TOL``).  The inference call's ms (CUDA events over
    ``SSD_TIMED`` replays), whether it captured, and the CUDA launches of
    one ``box_nms`` call (eager, ``torch.profiler``) and of its
    suppression sweep alone.  Training: one step (``MultiBoxTarget`` with
    hard negative mining, softmax cross-entropy plus L1 box loss, SGD lr
    0.01 momentum 0.9, K1) card against CPU: loss within
    ``TRAIN_LOSS_RTOL``, the whole update within ``RESNET_UPDATE_RTOL``
    and each parameter's (``update_errs``) within ``RESNET_UPDATE_RTOL``
    plus ``SSD_SPREAD_X`` times what one ulp more in half of the input's
    elements moves it on the CPU, on cuDNN's deterministic
    algorithms."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, ops
    from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                         load_block_weights)
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ndarray import contrib as ndc
    t_phase = time.perf_counter()
    gpu = mx.gpu(dev.index or 0)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rng = np.random.RandomState(43)
    x = rng.rand(SSD_BATCH, 3, SSD_SIZE, SSD_SIZE).astype(np.float32)
    lab = _ssd_labels(rng)
    host, _ = _host_net(vision.ssd_300_resnet34_v1, x[:1], 43)
    w0 = block_weights_to_numpy(host)
    for k in w0:
        if k.endswith("body.4.gamma"):
            w0[k][:] = 0.0
    load_block_weights(host, w0)
    with mx.cpu(), autograd.predict_mode():
        want_det = [a.asnumpy() for a in host(mx.nd.array(x))]
    with mx.cpu(), autograd.record():
        want_raw = [a.asnumpy() for a in host(mx.nd.array(x))]
    net = vision.ssd_300_resnet34_v1()
    net.initialize(ctx=gpu)
    load_block_weights(net, w0)
    net.hybridize()
    ops.reset_launches()
    with gpu:
        xa = mx.nd.array(x)
    with autograd.predict_mode():
        for _ in range(3):
            got_det = [a.asnumpy() for a in net(xa)]
    with autograd.record():
        got_raw = [a.asnumpy() for a in net(xa)]
    raw_err = [_close(g, w, SSD_RAW_TOL) for g, w in zip(got_raw[:2],
                                                           want_raw[:2])]
    anchor_err = float(np.abs(got_raw[2] - want_raw[2]).max())
    # MultiBoxDetection on the card against the CPU's over the same
    # inputs: the card's predictions, softmax taken once on the host
    cls_prob = torch.softmax(torch.from_numpy(got_raw[0]), -1) \
        .permute(0, 2, 1).contiguous().numpy()
    loc = got_raw[1].reshape(SSD_BATCH, -1)
    det = {}
    for ctx in (mx.cpu(), gpu):
        with ctx:
            det[ctx is gpu] = ndc.MultiBoxDetection(
                mx.nd.array(cls_prob), mx.nd.array(loc),
                mx.nd.array(got_raw[2]), nms_threshold=net.nms_thresh,
                nms_topk=net.nms_topk).asnumpy()
    ref = det[False]
    same, ties = _ssd_rows_agree(det[True], ref, net.nms_thresh)
    matched, box_err = _ssd_match(np.concatenate(want_det, -1),
                                  np.concatenate(got_det, -1))
    # the inference call: captured replays, and box_nms's launches
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with autograd.predict_mode():
        torch.cuda.synchronize(dev)
        ev[0].record()
        for _ in range(SSD_TIMED):
            net(xa)
        ev[1].record()
        torch.cuda.synchronize(dev)
    infer_ms = ev[0].elapsed_time(ev[1]) / SSD_TIMED
    stats = dict(net._cached_op.stats)
    dets = mx.nd.array(ref, ctx=gpu)

    def nms(k):
        return lambda: ndc.box_nms(dets, overlap_thresh=net.nms_thresh,
                                   topk=k, coord_start=2, score_index=1,
                                   id_index=0)
    nms_all = _cuda_launches(nms(net.nms_topk))
    nms_one = _cuda_launches(nms(1))
    sweep = nms_all - nms_one
    read_launches("phase 43 ssd inference", {})
    # one training step, card against CPU, and on the CPU once more from
    # an input one ulp up in half of its elements
    runs = []
    for ctx, model, xs in ((mx.cpu(), host, x), (gpu, net, x),
                           (mx.cpu(), host, _ulp_half(x))):
        load_block_weights(model, w0)
        trainer = gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": SSD_LR,
                                 "momentum": SSD_MOMENTUM})
        with ctx:
            xin, lin = mx.nd.array(xs), mx.nd.array(lab)
        if ctx is gpu:
            ops.reset_launches()
        loss, cls_t = _ssd_step(mx, model, trainer, xin, lin)
        runs.append((float(loss.mean().asscalar()), cls_t.asnumpy(),
                     block_weights_to_numpy(model)))
    launches = read_launches("phase 43 ssd training",
                             {"fused_sgd_update": 1})
    torch.backends.cudnn.deterministic = prev
    (cpu_l, cpu_t, cpu_w), (card_l, card_t, card_w), (_, _, ulp_w) = runs
    stats_k = [k for k in w0 if k.endswith(("running_mean", "running_var"))]
    held = [k for k in w0 if k not in stats_k]
    upd = update_errs({k: w0[k] for k in held}, card_w, cpu_w, 1)
    spread = update_errs({k: w0[k] for k in held}, ulp_w, cpu_w, 1)
    upd_limit = {k: RESNET_UPDATE_RTOL + SSD_SPREAD_X * spread[k]
                 for k in held}
    upd_worst = max(upd, key=lambda k: upd[k] / upd_limit[k])
    spread_worst = max(spread, key=spread.get)

    def whole(got):
        return float(np.sqrt(sum(
            np.sum(np.square(got[k] - cpu_w[k])) for k in held) / sum(
            np.sum(np.square(cpu_w[k] - w0[k])) for k in held)))
    whole_err, whole_spread = whole(card_w), whole(ulp_w)
    loss_err = abs(card_l - cpu_l) / abs(cpu_l)
    targets_differ = int((card_t != cpu_t).sum())
    print(f"phase 43 ssd_300_resnet34_v1 on {card} (f32, batch "
          f"{SSD_BATCH} x 3 x {SSD_SIZE} x {SSD_SIZE}, "
          f"{got_raw[2].shape[1]} anchors, hybridized): class/box "
          f"predictions max diff {[round(e, 7) for e, _ in raw_err]} (limit "
          f"{SSD_RAW_TOL} x max(1, |x|)), anchors {anchor_err:.2e}; "
          f"MultiBoxDetection on the card against the CPU over the same "
          f"inputs: {same} (ties at the NMS threshold, |IoU - "
          f"{net.nms_thresh}| <= {SSD_TIE_IOU}: {ties}); end to end, "
          f"{matched} of the CPU's kept detections matched by the card's, "
          f"matched boxes max diff {box_err:.2e} (limit {SSD_BOX_TOL}); "
          f"inference {infer_ms:.2f} ms a call ({SSD_TIMED} replays, CUDA "
          f"events), CachedOp {stats}; box_nms over the top "
          f"{net.nms_topk}: {nms_all} CUDA launches a call, {sweep} of "
          f"them the suppression sweep ({sweep / (net.nms_topk - 1):.2f} a "
          f"candidate), captured inside the graph; training step: loss "
          f"card {card_l:.6f} cpu {cpu_l:.6f} (rel {loss_err:.2e}, limit "
          f"{TRAIN_LOSS_RTOL}), MultiBoxTarget class targets differing "
          f"{targets_differ}, the whole update {whole_err:.3e} (limit "
          f"{RESNET_UPDATE_RTOL}), the worst parameter against its limit "
          f"{upd[upd_worst]:.3e} at {upd_worst} (limit "
          f"{upd_limit[upd_worst]:.3e}: {RESNET_UPDATE_RTOL} + "
          f"{SSD_SPREAD_X} x {spread[upd_worst]:.3e}, what one ulp of "
          f"input moved it on the CPU), the largest of one parameter "
          f"{max(upd.values()):.3e}; one ulp of input moved the CPU's "
          f"update by {whole_spread:.3e} all together and by "
          f"{spread[spread_worst]:.3e} at {spread_worst}; "
          f"launches {launches}; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    failed = [what for what, ok in (
        (f"predictions {raw_err}", all(ok for _, ok in raw_err)),
        (f"anchors {anchor_err}", anchor_err <= 1e-6),
        (f"detections {same}", same == "equal"),
        (f"matched boxes {box_err}", box_err <= SSD_BOX_TOL),
        (f"captures {stats}", stats["captures"] >= 1 and
         stats["replays"] >= SSD_TIMED),
        (f"loss {loss_err:.3e}", loss_err <= TRAIN_LOSS_RTOL),
        (f"whole update {whole_err:.3e}", whole_err <= RESNET_UPDATE_RTOL),
        (f"update {upd_worst} {upd[upd_worst]:.3e}",
         upd[upd_worst] <= upd_limit[upd_worst])) if not ok]
    if failed:
        fail("phase 43: " + "; ".join(failed))
    del net, host
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _pairwise_iou(a, b):
    import numpy as np
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), -1)
    area = lambda z: np.prod(np.clip(z[:, 2:] - z[:, :2], 0, None), -1)
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter,
                              1e-12)


def _ssd_rows_agree(got, want, thresh):
    """Whether two ``MultiBoxDetection`` outputs over the same inputs
    agree: ``("equal", ties)`` when every row's id, kept state, score and
    box agree (scores and boxes within ``SSD_BOX_TOL``), a row whose
    kept state differs allowed only when its IoU with a higher-ranked
    kept box of its class lies within ``SSD_TIE_IOU`` of ``thresh`` (a
    tie; counted); else a description of the first difference."""
    import numpy as np
    ties = 0
    for b in range(got.shape[0]):
        g, w = got[b], want[b]
        if not np.array_equal(g[:, 0], w[:, 0]):
            return f"image {b}: ids differ", ties
        kept_g, kept_w = g[:, 1] > 0, w[:, 1] > 0
        for i in np.nonzero(kept_g != kept_w)[0]:
            iou = _pairwise_iou(w[i:i + 1, 2:], w[:i, 2:])[0]
            same = (w[:i, 0] == w[i, 0]) & (kept_w[:i] | kept_g[:i])
            if not (same & (np.abs(iou - thresh) <= SSD_TIE_IOU)).any():
                return f"image {b} row {i}: kept {kept_g[i]} vs " \
                       f"{kept_w[i]}", ties
            ties += 1
        both = kept_g & kept_w
        if np.abs(g[both, 1:] - w[both, 1:]).max(initial=0) > SSD_BOX_TOL:
            return f"image {b}: scores or boxes differ", ties
    return "equal", ties


def _ssd_match(want, got, tol=SSD_BOX_TOL):
    """Of ``want``'s kept detections, how many ``got`` has (same image
    and class, box within ``tol``), as "m / n", and the largest box
    difference of the matched ones."""
    import numpy as np
    n = m = 0
    err = 0.0
    for b in range(want.shape[0]):
        wk = want[b][want[b][:, 1] > 0]
        gk = got[b][got[b][:, 1] > 0]
        for row in wk:
            n += 1
            cand = gk[gk[:, 0] == row[0]]
            if not len(cand):
                continue
            d = np.abs(cand[:, 2:] - row[2:]).max(-1)
            j = int(np.argmin(d))
            if d[j] <= tol:
                m += 1
                err = max(err, float(d[j]))
    return f"{m} / {n}", err


def _dets_agree(want, got, tol, thresh, cut):
    """End to end, the card's detections (``got``: rows [id, score, x0,
    y0, x1, y1] a box, as ``box_nms`` leaves them) against the CPU's
    from their own inputs: (the CPU's kept rows the card matched "m /
    n", the card's kept rows the CPU lacks, how many unmatched rows of
    either side a tie explains, unexplained rows, the largest box
    difference of the matched).  A match is the same image and class
    with a box within ``tol``.  An unmatched row is a tie when its score
    lies within twice the largest score difference of the matched rows
    of ``cut`` (the score gate) or of the other side's lowest kept score
    in its image (the top-k cut), when its IoU with a kept row of its
    side and class lies within ``SSD_TIE_IOU`` of ``thresh``, or when it
    overlaps an unmatched row of the other side and its class past
    ``thresh`` (the two swapped which one was kept)."""
    import numpy as np
    lack = {"card": [], "cpu": []}
    low = {}
    n = m = 0
    box_err = score_err = 0.0
    for b in range(want.shape[0]):
        kw = want[b][want[b][:, 1] > 0]
        kg = got[b][got[b][:, 1] > 0]
        for side, rows, other in (("cpu", kw, kg), ("card", kg, kw)):
            low[side, b] = rows[:, 1].min(initial=np.inf)
            for row in rows:
                cand = other[other[:, 0] == row[0]]
                d = np.abs(cand[:, 2:] - row[2:]).max(-1) if len(cand) \
                    else np.array([np.inf])
                j = int(np.argmin(d))
                if d[j] <= tol:
                    box_err = max(box_err, float(d[j]))
                    score_err = max(score_err, abs(float(cand[j, 1] -
                                                         row[1])))
                else:
                    lack[side].append((b, row, rows))
        n += len(kw)
        m += len(kw) - sum(1 for e in lack["cpu"] if e[0] == b)
    band = 2 * score_err
    explained, odd = 0, []
    for side, other in (("cpu", "card"), ("card", "cpu")):
        for b, row, rows in lack[side]:
            mates = rows[(rows[:, 0] == row[0]) &
                         np.any(rows[:, 2:] != row[2:], -1)]
            near = len(mates) and (np.abs(_pairwise_iou(
                row[None, 2:], mates[:, 2:])[0] - thresh) <=
                SSD_TIE_IOU).any()
            swap = [r for bb, r, _ in lack[other] if bb == b and
                    r[0] == row[0]]
            swapped = len(swap) and (_pairwise_iou(
                row[None, 2:], np.stack(swap)[:, 2:])[0] > thresh).any()
            if abs(row[1] - cut) <= band or \
                    abs(row[1] - low[other, b]) <= band or near or swapped:
                explained += 1
            else:
                odd.append(f"{side} image {b} class {int(row[0])} score "
                           f"{row[1]:.6f}")
    return f"{m} / {n}", len(lack["card"]), explained, odd, box_err


# ----------------------------------------------------------------------
# phases 44-47: the rest of the zoo (ROADMAP §1 item 11c): YOLOv3,
# Faster R-CNN, segmentation and simple pose, through the CachedOp and
# the Gluon Trainer
# ----------------------------------------------------------------------

# GluonCV's recipes: SGD lr 1e-3, momentum 0.9, wd 5e-4 (YOLOv3, Faster
# R-CNN) or 1e-4 (segmentation); Adam lr 1e-3 (simple pose)
ZOO_LR, ZOO_MOMENTUM, ZOO_WD, SEG_WD = 1e-3, 0.9, 5e-4, 1e-4
ZOO_WARMUP, ZOO_TIMED, ZOO_TRACED = 2, 5, 2
ZOO_RAW_TOL = 1e-4      # x max(1, max |x|), as SSD_RAW_TOL
# phase 44: yolo3_darknet53 (80 classes) at 416 x 416, batch 8
YOLO_BATCH, YOLO_SIZE, YOLO_CLASSES = 8, 416, 80
# phase 45: faster_rcnn_resnet50_v1b at a 600-pixel short side, the long
# side fixed at 800 so the shapes stay static, batch 1
RCNN_H, RCNN_W = 600, 800
# phase 46: FCN/PSPNet/DeepLabV3 over resnet50_v1b, 21 classes, crop 480
SEG_SIZE, SEG_PREDICT_BATCH, SEG_BATCH, SEG_CLASSES = 480, 2, 4, 21
# phase 47: simple_pose_resnet50_v1b, 17 joints, 256 x 192, batch 32
POSE_H, POSE_W, POSE_BATCH, POSE_JOINTS = 256, 192, 32, 17


def _ulp_half(x):
    """``x`` one ulp up in a fixed half of its elements."""
    import numpy as np
    out = x.copy()
    up = np.random.RandomState(0).rand(*x.shape) < 0.5
    out[up] = np.nextafter(out[up], np.float32(2))
    return out


def _card_net(make, w0, gpu):
    """``make()`` on the card with the weights ``w0``, hybridized."""
    from mxnet_tpu_torch.convert import load_block_weights
    net = make()
    net.initialize(ctx=gpu)
    load_block_weights(net, w0)
    net.hybridize()
    return net


def _dropout_rate(net, rate):
    def set_rate(blk):
        if type(blk).__name__ == "Dropout":
            blk._rate = rate
    net.apply(set_rate)
    return net


class _GradsFirst:
    """A Trainer that keeps the parameters' gradients (host copies) as
    its step finds them: the step rescales them in place.  With no
    ``trainer`` it only keeps them."""

    def __init__(self, trainer, model):
        self.trainer, self.model, self.grads = trainer, model, None

    def step(self, batch):
        self.grads = {k: p.grad().asnumpy() for k, p in
                      self.model._collect_params_with_prefix().items()
                      if p.grad_req != "null"}
        if self.trainer is not None:
            self.trainer.step(batch)


def _kink_mode(gates=None):
    """A torch function mode over ReLU and LeakyReLU.  Without ``gates``
    it records each call's gate (input > 0: where the gradient passes
    whole) on the host, in call order, in ``.gates``; given such a
    record of the same forward, each call passes its gradient where the
    recorded gate did, and ``.flips`` counts the units whose own gate
    differs (of ``.units``)."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode
    relus = (torch.relu, F.relu, torch.Tensor.relu)

    class Kinks(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.gates = [] if gates is None else gates
            self.at = self.flips = self.units = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in relus:
                slope = 0.0
            elif func is F.leaky_relu:
                slope = args[1] if len(args) > 1 else \
                    kwargs.get("negative_slope", 0.01)
            else:
                return func(*args, **kwargs)
            h = args[0]
            if gates is None:
                self.gates.append((h > 0).cpu())
                return func(*args, **kwargs)
            gate = self.gates[self.at].to(h.device)
            self.at += 1
            self.flips += int((gate != (h > 0)).sum())
            self.units += gate.numel()
            return torch.where(gate, h, h * slope)
    return Kinks()


def _kink_witness(make, w0, gpu, x, step, replay=None):
    """Float64 at the card's kinks (phase 42's witness, for any net):
    ``make()`` from ``w0``, eager on the card, takes ``step``'s forward
    and backward (no update) with each ReLU's and LeakyReLU's gate
    recorded; then ``make()`` on the CPU in float64 takes the same with
    each gate replayed (``_kink_mode``).  ``replay(card_net, cpu_net)``,
    where given, has the float64 run take any other choice the card's
    made (Faster R-CNN's proposals).  Returns (the card's gradients,
    float64's, units whose float64 gate differs, units gated, CPU
    seconds)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import load_block_weights
    nets = []
    for ctx in (gpu, mx.cpu()):
        net = make()
        net.initialize(ctx=ctx)
        load_block_weights(net, w0)
        nets.append(net)
    card, host = nets
    # Block.cast narrows 64-bit types to 32 bits, as MXNet's does
    for p in host.collect_params().values():
        p._bind(p.data().data.to(torch.float64))
    if replay is not None:
        replay(card, host)
    card_g = _GradsFirst(None, card)
    with _kink_mode() as rec:
        step(card, card_g, gpu, x)
    t0 = time.perf_counter()
    wit = _GradsFirst(None, host)
    with _kink_mode(rec.gates) as again:
        step(host, wit, mx.cpu(),
             mx.nd.NDArray(torch.from_numpy(x.astype(np.float64))))
    if again.at != len(rec.gates):
        fail(f"float64 witness: {again.at} gated calls, the card's "
             f"{len(rec.gates)}")
    return card_g.grads, wit.grads, again.flips, again.units, \
        time.perf_counter() - t0


def _zoo_step_check(label, w0, host, net, gpu, x, make, rule, step, kernel,
                    replay=None):
    """One training step from ``w0`` on the CPU (``host``), on the card
    (``net``) and on the CPU again from ``x`` one ulp up in half of its
    elements: ``step(model, trainer, ctx, x)`` takes the step with a
    Trainer of ``rule`` (optimizer, its arguments, the batch) and
    returns the loss.  Phase 43's rule: the loss within
    ``TRAIN_LOSS_RTOL`` plus ``SSD_SPREAD_X`` times what the ulp moved
    it; all the gradients together and the whole update (running
    statistics left out) within ``RESNET_UPDATE_RTOL`` of their norms
    plus ``SSD_SPREAD_X`` times what the ulp moved them together; each
    gradient and each parameter's update within ``RESNET_UPDATE_RTOL``
    plus ``SSD_SPREAD_X`` times what the ulp moved its own.  One
    perturbation flips a sample of the units at a ReLU's or LeakyReLU's
    kink, so a parameter past its own limit is held instead against
    ``_kink_witness``, float64 at the card's kinks (built by ``make()``;
    ``replay`` as there): its gradient within ``RESNET_UPDATE_RTOL`` of
    the witness's norm plus ``MBV2_GRAD_ATOL`` (phase 42's limits), and
    with SGD its update within ``RESNET_UPDATE_RTOL`` of the plain
    rule's over the witness's gradient.  Adam's first step moves each
    element by about lr whatever its gradient, so an element whose
    gradient is rounding noise moves by 2 lr on the other device (simple
    pose's ``features.6.1.bn2.gamma``: 0.255 of its update's norm); its
    updates are held instead against the plain rule
    (``Optimizer.update`` on the host, float32) over the card's own
    gradients within ``UPDATE_TOL``.  The card's step launches
    ``kernel`` once.  Returns (text, failures)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, ops
    from mxnet_tpu_torch.convert import (block_weights_to_numpy,
                                         load_block_weights)
    name, args, batch = rule
    runs = []
    for ctx, model, xs in ((mx.cpu(), host, x), (gpu, net, x),
                           (mx.cpu(), host, _ulp_half(x))):
        load_block_weights(model, w0)
        if ctx is gpu:
            ops.reset_launches()
        trainer = _GradsFirst(gluon.Trainer(model.collect_params(), *rule[:2]),
                              model)
        loss = float(step(model, trainer, ctx, xs).mean().asscalar())
        if ctx is gpu:
            read_launches(label, {kernel: 1})
        runs.append((loss, block_weights_to_numpy(model), trainer.grads))
    (cpu_l, cpu_w, cpu_g), (card_l, card_w, card_g), (ulp_l, ulp_w, ulp_g) \
        = runs
    held = sorted(cpu_g)

    def rel(a, b, k):
        d = a[k].astype(np.float64) - b[k]
        return float(np.linalg.norm(d) / max(
            float(np.linalg.norm(b[k].astype(np.float64))), 1e-30))

    def together(a, b):
        return float(np.sqrt(
            sum(np.sum(np.square(a[k].astype(np.float64) - b[k]))
                for k in held) /
            sum(np.sum(np.square(b[k].astype(np.float64))) for k in held)))

    def limit(spread):
        return RESNET_UPDATE_RTOL + SSD_SPREAD_X * spread

    def worst(err, spread):
        k = max(held, key=lambda k: err[k] / limit(spread[k]))
        return (f"{err[k]:.3e} at {k} (limit {limit(spread[k]):.3e}), "
                f"{sum(err[j] > limit(spread[j]) for j in held)} past "
                f"their own")
    g_err = {k: rel(card_g, cpu_g, k) for k in held}
    g_spread = {k: rel(ulp_g, cpu_g, k) for k in held}
    g_whole, g_whole_spread = together(card_g, cpu_g), together(ulp_g, cpu_g)
    past = {k for k in held if g_err[k] > limit(g_spread[k])}
    base = {k: w0[k] for k in held}
    du = {k: cpu_w[k] - w0[k] for k in held}
    whole_err = together({k: card_w[k] - w0[k] for k in held}, du)
    whole_spread = together({k: ulp_w[k] - w0[k] for k in held}, du)
    loss_err = abs(card_l - cpu_l) / abs(cpu_l)
    loss_lim = TRAIN_LOSS_RTOL + SSD_SPREAD_X * abs(ulp_l - cpu_l) / \
        abs(cpu_l)
    text = (f"one step card vs CPU: loss card {card_l:.6f} cpu {cpu_l:.6f} "
            f"(rel {loss_err:.2e}, limit {loss_lim:.2e}: {TRAIN_LOSS_RTOL} + "
            f"{SSD_SPREAD_X} x what one ulp of input moved the CPU's); the "
            f"gradients together {g_whole:.3e} (limit "
            f"{limit(g_whole_spread):.3e}: {RESNET_UPDATE_RTOL} + "
            f"{SSD_SPREAD_X} x {g_whole_spread:.3e}, what one ulp moved the "
            f"CPU's), the worst against its own limit "
            f"{worst(g_err, g_spread)}; the whole update {whole_err:.3e} "
            f"(limit {limit(whole_spread):.3e})")
    failed = [what for what, ok in (
        (f"{label} loss {loss_err:.3e}", loss_err <= loss_lim),
        (f"{label} gradients together {g_whole:.3e}",
         g_whole <= limit(g_whole_spread)),
        (f"{label} whole update {whole_err:.3e}",
         whole_err <= limit(whole_spread))) if not ok]
    opt = mx.optimizer.create(name, **args)
    opt.rescale_grad = 1.0 / batch
    if name != "adam":
        upd = update_errs(base, card_w, cpu_w, 1)
        spread = update_errs(base, ulp_w, cpu_w, 1)
        past |= {k for k in held if upd[k] > limit(spread[k])}
        text += (f", the worst parameter against its own limit "
                 f"{worst(upd, spread)}")
    else:
        rule_err, rule_ok = 0.0, True
        for i, k in enumerate(held):
            w = torch.from_numpy(w0[k].copy())
            opt.update(i, w, torch.from_numpy(card_g[k]),
                       opt.create_state(i, w))
            err, ok = max_err(torch.from_numpy(card_w[k]), w, UPDATE_TOL)
            rule_err, rule_ok = max(rule_err, err), rule_ok and ok
        text += (f"; the card's update against {name}'s plain rule over "
                 f"its own gradients max |diff| {rule_err:.2e} (limit "
                 f"{UPDATE_TOL[0]} + {UPDATE_TOL[1]} x |w|)")
        if not rule_ok:
            failed.append(f"{label} {name} rule {rule_err:.3e}")
    if not past:
        return text + "; no parameter past its own limit", failed
    eager_g, wit_g, flips, units, cpu_s = _kink_witness(make, w0, gpu, x,
                                                         step, replay)
    share = {}
    for i, k in enumerate(held):
        if k not in past:
            continue
        norm = float(np.linalg.norm(wit_g[k]))
        share[k] = float(np.linalg.norm(card_g[k] - wit_g[k])) / (
            RESNET_UPDATE_RTOL * norm + MBV2_GRAD_ATOL)
        if name != "adam":
            w = torch.from_numpy(w0[k].astype(np.float64))
            opt.update(i, w, torch.from_numpy(wit_g[k]),
                       opt.create_state(i, w))
            u = update_errs({k: w0[k]}, card_w, {k: w.numpy()}, 1)[k]
            share[k] = max(share[k], u / RESNET_UPDATE_RTOL)
    k = max(share, key=share.get)
    eager = max(rel(eager_g, card_g, j) for j in past)
    text += (f"; past their own limit, {len(past)} parameter(s) held "
             f"against float64 at the card's kinks on the CPU ({flips} of "
             f"{units} gates the float64 forward set otherwise, {cpu_s:.1f} "
             f"s; gradient within {RESNET_UPDATE_RTOL} of its norm + "
             f"{MBV2_GRAD_ATOL}" + ("" if name == "adam" else
                                    f", update within {RESNET_UPDATE_RTOL}")
             + f"): the worst {share[k]:.3f} of its limit at {k}, the card's "
             f"step against its eager gates' run {eager:.2e}")
    if share[k] > 1.0:
        failed.append(f"{label} {k} against float64 {share[k]:.3f} of its "
                      f"limit")
    return text, failed


def _zoo_timed(dev, step, label, kernel):
    """``step()`` (one training step on the card, returning its loss):
    ``ZOO_WARMUP`` steps, ``ZOO_TIMED`` between CUDA events, then
    ``ZOO_TRACED`` under ``torch.profiler``, from zeroed launch
    counters; ``kernel`` once a step.  Returns (step ms, device busy ms a
    traced step, losses, peak GB, launches)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import ops
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    n = ZOO_WARMUP + ZOO_TIMED + ZOO_TRACED
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    prof = profile(activities=[ProfilerActivity.CUDA])
    losses = []
    for i in range(n):
        if i == ZOO_WARMUP:
            ev[0].record()
        if i == ZOO_WARMUP + ZOO_TIMED:
            ev[1].record()
            torch.cuda.synchronize(dev)
            prof.__enter__()
        losses.append(step().mean())
    torch.cuda.synchronize(dev)
    prof.__exit__(None, None, None)
    launches = read_launches(label, {kernel: n})
    losses = [float(v.asscalar()) for v in losses]
    if not all(np.isfinite(losses)):
        fail(f"{label}: losses {losses}")
    return (ev[0].elapsed_time(ev[1]) / ZOO_TIMED, _busy_ms(prof, ZOO_TRACED),
            losses, torch.cuda.max_memory_allocated(dev) / 1e9, launches)


def _timed_line(batch, timed):
    step_ms, busy, losses, peak, _ = timed
    return (f"{ZOO_WARMUP + ZOO_TIMED + ZOO_TRACED} steps, losses "
            f"{[round(v, 4) for v in losses]}; step {step_ms:.2f} ms (CUDA "
            f"events over {ZOO_TIMED} steps), {batch / step_ms * 1e3:.1f} "
            f"images/s, device busy {busy:.2f} ms a traced step, host "
            f"share {1 - busy / step_ms:.4f}; peak memory {peak:.2f} GB")


def _replay_ms(dev, fn, reps=ZOO_TIMED):
    """Device ms of ``fn()`` a call, CUDA events over ``reps`` calls."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize(dev)
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize(dev)
    return ev[0].elapsed_time(ev[1]) / reps


def _nms_launches(dets, gpu, thresh, topk):
    """CUDA launches of one ``box_nms`` call over ``dets`` on the card,
    and of its suppression sweep alone (the call at ``topk`` less the
    call at 1)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import contrib as ndc
    d = mx.nd.array(dets, ctx=gpu)

    def nms(k):
        return lambda: ndc.box_nms(d, overlap_thresh=thresh, valid_thresh=0.01,
                                   topk=k, coord_start=2, score_index=1,
                                   id_index=0)
    every = _cuda_launches(nms(topk))
    return every, every - _cuda_launches(nms(1))


def _yolo_targets(rng):
    """Seeded targets of the three raw maps (largest stride first), each
    (objectness, classes, boxes) as (B, 3, k, H, W): objectness 1 in one
    cell-anchor of ten, a one-hot class there, boxes N(0, 0.5)."""
    import numpy as np
    out = []
    for stride in (32, 16, 8):
        h = YOLO_SIZE // stride
        obj = (rng.rand(YOLO_BATCH, 3, 1, h, h) < 0.1).astype(np.float32)
        cls = np.zeros((YOLO_BATCH, 3, YOLO_CLASSES, h, h), np.float32)
        idx = rng.randint(0, YOLO_CLASSES, (YOLO_BATCH, 3, 1, h, h))
        np.put_along_axis(cls, idx, 1.0, axis=2)
        out.append((obj, cls * obj,
                    (rng.randn(YOLO_BATCH, 3, 4, h, h) * 0.5)
                    .astype(np.float32)))
    return out


def _yolo_loss(mx, preds, targets):
    """A test loss over YOLOv3's three raw maps (not GluonCV's target
    assignment, which the reference lacks): sigmoid cross-entropy on the
    objectness and class channels, L2 on the box channels."""
    from mxnet_tpu_torch import gluon
    bce = gluon.loss.SigmoidBinaryCrossEntropyLoss()
    l2 = gluon.loss.L2Loss()
    total = None
    for p, (obj, cls, box) in zip(preds, targets):
        b, _, h, w = p.shape
        p = p.reshape((b, 3, 5 + YOLO_CLASSES, h, w))
        part = bce(mx.nd.slice_axis(p, axis=2, begin=4, end=5), obj) + \
            bce(mx.nd.slice_axis(p, axis=2, begin=5, end=None), cls) + \
            l2(mx.nd.slice_axis(p, axis=2, begin=0, end=4), box)
        total = part if total is None else total + part
    return total


def _sgd_rule(batch, wd=ZOO_WD):
    """GluonCV's SGD: the Trainer's (optimizer, arguments, batch)."""
    return "sgd", {"learning_rate": ZOO_LR, "momentum": ZOO_MOMENTUM,
                   "wd": wd}, batch


def yolo_detection(dev, card):
    """Phase 44: ``yolo3_darknet53`` (80 classes, COCO anchors) at batch
    8 x 3 x 416 x 416, ``Xavier(magnitude=2)`` from ``mx.random.seed(44)``
    made on the host (He's initialization grows the raw maps until
    ``exp`` of the box sizes overflows), hybridized on the card
    against the CPU.  Inference: three predict-mode calls (the third a
    replay); the training-mode raw maps within ``ZOO_RAW_TOL``;
    ``box_nms`` (0.45, top 400 of the 10,647 boxes, each box's best
    class) on the card against the CPU over the same inputs (the card's
    decoded boxes and scores) with phase 43's tie rule; end to end, the
    CPU's kept detections matched by the card's and the card's by the
    CPU's (boxes within ``SSD_BOX_TOL`` x 416 pixels), every unmatched
    row a tie (``_dets_agree``); the call's ms and ``box_nms``'s
    launches.  Training: ``_yolo_loss`` against ``_yolo_targets``, SGD
    (``ZOO_LR``, ``ZOO_MOMENTUM``, ``ZOO_WD``), one step against the CPU
    by ``_zoo_step_check`` on cuDNN's deterministic algorithms, then
    timed steps on a fresh net under cuDNN's own choice."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, ops
    from mxnet_tpu_torch.convert import block_weights_to_numpy
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ndarray import contrib as ndc
    t_phase = time.perf_counter()
    gpu = mx.gpu(dev.index or 0)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rng = np.random.RandomState(44)
    x = rng.rand(YOLO_BATCH, 3, YOLO_SIZE, YOLO_SIZE).astype(np.float32)
    targets = _yolo_targets(rng)
    host, _ = _host_net(vision.yolo3_darknet53, x[:1], 44)
    w0 = block_weights_to_numpy(host)
    with mx.cpu(), autograd.predict_mode():
        want_det = [a.asnumpy() for a in host(mx.nd.array(x))]
    with mx.cpu(), autograd.record():
        want_raw = [[a.asnumpy() for a in out]
                    for out in host(mx.nd.array(x))]
    net = _card_net(vision.yolo3_darknet53, w0, gpu)
    ops.reset_launches()
    with gpu:
        xa = mx.nd.array(x)
    with autograd.predict_mode():
        for _ in range(3):
            got_det = [a.asnumpy() for a in net(xa)]
        infer_ms = _replay_ms(dev, lambda: net(xa))
    stats = dict(net._cached_op.stats)
    with autograd.record():
        got_raw = [[a.asnumpy() for a in out] for out in net(xa)]
    read_launches("phase 44 yolo3 inference", {})
    raw_err = [_close(g, w, ZOO_RAW_TOL)
               for g, w in zip(got_raw[0], want_raw[0])]
    # box_nms over the same inputs: the card's decoded boxes and scores
    boxes = np.concatenate(got_raw[1], 1)
    scores = np.concatenate(got_raw[2], 1)
    dets = np.concatenate([scores.argmax(-1)[..., None].astype(np.float32),
                           scores.max(-1)[..., None], boxes], -1)
    nms = {}
    for ctx in (mx.cpu(), gpu):
        with ctx:
            nms[ctx is gpu] = ndc.box_nms(
                mx.nd.array(dets), overlap_thresh=net.nms_thresh,
                valid_thresh=0.01, topk=net.nms_topk, coord_start=2,
                score_index=1, id_index=0).asnumpy()
    same, ties = _ssd_rows_agree(nms[True], nms[False], net.nms_thresh)
    matched, extra, det_ties, det_odd, box_err = _dets_agree(
        np.concatenate(want_det, -1), np.concatenate(got_det, -1),
        SSD_BOX_TOL * YOLO_SIZE, net.nms_thresh, 0.01)
    nms_all, sweep = _nms_launches(dets, gpu, net.nms_thresh, net.nms_topk)
    ce_text, failed = _zoo_step_check(
        "phase 44 yolo3 step", w0, host, net, gpu, x, vision.yolo3_darknet53,
        _sgd_rule(YOLO_BATCH),
        lambda model, tr, ctx, xs: _yolo_step(mx, model, tr, ctx, xs,
                                              targets), "fused_sgd_update")
    torch.backends.cudnn.deterministic = prev
    del net, host
    gc.collect()
    torch.cuda.empty_cache()
    net = _card_net(vision.yolo3_darknet53, w0, gpu)
    trainer = gluon.Trainer(net.collect_params(), *_sgd_rule(YOLO_BATCH)[:2])
    with gpu:
        tg = [[mx.nd.array(a) for a in t] for t in targets]
    timed = _zoo_timed(
        dev, lambda: _yolo_step(mx, net, trainer, gpu, xa, tg),
        "phase 44 yolo3 training", "fused_sgd_update")
    print(f"phase 44 yolo3_darknet53 on {card} (f32, batch {YOLO_BATCH} x 3 "
          f"x {YOLO_SIZE} x {YOLO_SIZE}, {boxes.shape[1]} boxes, "
          f"hybridized): raw maps max diff {[round(e, 7) for e, _ in raw_err]}"
          f" (limit {ZOO_RAW_TOL} x max(1, |x|)); box_nms on the card "
          f"against the CPU over the same inputs: {same} (ties at the NMS "
          f"threshold: {ties}); end to end, {matched} of the CPU's kept "
          f"detections matched by the card's, {extra} of the card's "
          f"unmatched, {det_ties} unmatched rows ties, unexplained "
          f"{det_odd[:4]}, matched boxes max diff "
          f"{box_err:.2e} px (limit {SSD_BOX_TOL * YOLO_SIZE:.3f}); "
          f"inference {infer_ms:.2f} ms a call ({ZOO_TIMED} replays, CUDA "
          f"events), CachedOp {stats}; box_nms over the top "
          f"{net.nms_topk}: {nms_all} CUDA launches a call, {sweep} of them "
          f"the suppression sweep, captured inside the graph; training (sgd "
          f"lr {ZOO_LR} momentum {ZOO_MOMENTUM} wd {ZOO_WD}): {ce_text}; "
          f"{_timed_line(YOLO_BATCH, timed)}; CachedOp "
          f"{dict(net._cached_op.stats)}; launches {timed[4]}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    failed += [what for what, ok in (
        (f"raw maps {raw_err}", all(ok for _, ok in raw_err)),
        ("detections not finite", all(np.isfinite(a).all()
                                      for a in got_det + want_det)),
        (f"box_nms {same}", same == "equal"),
        (f"detections unmatched {det_odd[:4]}", not det_odd),
        (f"matched boxes {box_err}", box_err <= SSD_BOX_TOL * YOLO_SIZE),
        (f"captures {stats}", stats["captures"] >= 1 and
         stats["replays"] >= ZOO_TIMED)) if not ok]
    if failed:
        fail("phase 44: " + "; ".join(failed))
    del net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return timed[4]


def _yolo_step(mx, model, trainer, ctx, xs, targets):
    from mxnet_tpu_torch import autograd
    with ctx:
        xa = xs if isinstance(xs, mx.nd.NDArray) else mx.nd.array(xs)
        tg = [[t if isinstance(t, mx.nd.NDArray) else mx.nd.array(t)
               for t in tri] for tri in targets]
    with autograd.record():
        preds, _, _ = model(xa)
        loss = _yolo_loss(mx, preds, tg)
    loss.backward()
    trainer.step(YOLO_BATCH)
    return loss


def _rcnn_targets(rng, na, h, w):
    """Seeded targets of the RPN's score and offset maps."""
    import numpy as np
    return [(rng.rand(1, na, h, w) < 0.3).astype(np.float32),
            (rng.randn(1, na * 4, h, w) * 0.1).astype(np.float32)]


def _rcnn_step(mx, model, trainer, ctx, xs, targets):
    """A test loss: softmax cross-entropy on the rois' class predictions
    and L1 on their box predictions, against targets made from each
    roi's own box (its centre's column of 21, its corners over the
    image's width), so the loss does not hang on the rois' order, which
    ties decide; sigmoid cross-entropy on the RPN's scores and L1 on its
    offsets against the seeded ``targets``; SGD."""
    from mxnet_tpu_torch import autograd, gluon
    with ctx:
        xa = xs if isinstance(xs, mx.nd.NDArray) else mx.nd.array(xs)
        rpn_t, loc_t = [t if isinstance(t, mx.nd.NDArray) else
                        mx.nd.array(t) for t in targets]
    width = xa.shape[3]
    l1 = gluon.loss.L1Loss()
    with autograd.record():
        cls_pred, box_pred, rois, rpn_score, rpn_loc, _ = model(xa)
        r = rois.detach().reshape((-1, 4))
        cx = (mx.nd.slice_axis(r, axis=1, begin=0, end=1) +
              mx.nd.slice_axis(r, axis=1, begin=2, end=3)) / 2
        cls_t = mx.nd.clip(mx.nd.floor(cx * (21 / width)), 0, 20) \
            .reshape((-1,))
        box_t = mx.nd.tile(r / width, reps=(1, 20))
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(cls_pred, cls_t).mean() \
            + l1(box_pred, box_t).mean() + \
            gluon.loss.SigmoidBinaryCrossEntropyLoss()(
                rpn_score, rpn_t).mean() + l1(rpn_loc, loc_t).mean()
    loss.backward()
    trainer.step(1)
    return loss


def _rois_agree(got, got_s, want, want_s, score_tie, cut_score, tol,
                thresh):
    """The card's rois (n, 4) against the CPU's, both in the RPN's order
    with their scores: (rows equal at the same position, rows of either
    side the other lacks, how many of those a tie explains, unexplained
    rows).  A row the other side lacks (no box within ``tol``) is a tie
    when its score lies within ``score_tie`` of the last returned score
    or of ``cut_score`` (the ``pre_nms``-th), when its IoU with a
    higher-ranked row of its side lies within ``SSD_TIE_IOU`` of
    ``thresh``, or when it overlaps another such row past ``thresh`` (a
    suppression the tie moved)."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo.vision.rcnn import _rpn_iou
    import torch
    same = int((np.abs(got - want).max(-1) <= tol).sum())

    def lacking(a, b):
        d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
        return np.nonzero(d.min(1) > tol)[0]
    miss = {"card": (got, got_s, lacking(got, want)),
            "cpu": (want, want_s, lacking(want, got))}
    odd = []
    explained = 0
    for side, (rows, sc, idx) in miss.items():
        iou = _rpn_iou(torch.from_numpy(rows)[None]).numpy()[0]
        last = sc[sc > -1].min(initial=1.0)
        for i in idx:
            near = np.abs(iou[i, :i] - thresh) <= SSD_TIE_IOU
            moved = (iou[i, idx] > thresh) & (idx != i)
            if abs(sc[i] - last) <= score_tie or \
                    abs(sc[i] - cut_score) <= score_tie or near.any() or \
                    moved.any():
                explained += 1
            else:
                odd.append(f"{side} row {i} score {sc[i]:.7f}")
    return same, sum(len(v[2]) for v in miss.values()), explained, odd


def _replay_proposals(card, host):
    """Has ``host``'s RPN return the proposals that ``card``'s returned
    last (in ``host``'s dtype): which boxes a tie kept is the card's
    choice, as its kinks are (``_kink_witness``)."""
    import torch
    import mxnet_tpu_torch as mx
    kept = {}
    card_fwd, host_fwd = card.rpn.hybrid_forward, host.rpn.hybrid_forward

    def record(F, *args, **kw):
        out = card_fwd(F, *args, **kw)
        kept["rois"] = out[3].asnumpy()
        return out

    def take(F, *args, **kw):
        out = list(host_fwd(F, *args, **kw))
        out[3] = mx.nd.NDArray(torch.from_numpy(kept["rois"]).to(
            out[3].data))
        return tuple(out)
    object.__setattr__(card.rpn, "hybrid_forward", record)
    object.__setattr__(host.rpn, "hybrid_forward", take)


def faster_rcnn(dev, card):
    """Phase 45: ``faster_rcnn_resnet50_v1b`` (20 classes) at batch 1 x 3
    x 600 x 800 (C4 at 38 x 50, 17,100 anchors, ``pre_nms`` 2000,
    ``post_nms`` 300), He's initialization from ``mx.random.seed(45)``
    made on the host, hybridized on the card against the CPU.
    Inference: three predict-mode calls, whether the call captured and
    its ms; the RPN sweep's CUDA launches over 2000 candidates
    (``contrib._sweep`` alone) and ``ROIAlign``'s device ms at 300 rois
    on the 1024 x 38 x 50 map.  In training mode the RPN's raw scores, offsets
    and anchors within ``ZOO_RAW_TOL``; its proposals
    (``rcnn._rpn_proposals``) on the card against the CPU over the same
    inputs (the card's raw outputs), and the card's 300 rois against
    the CPU's, each under ``_rois_agree`` (the score tie band twice the
    largest sigmoid-score difference card vs CPU, boxes within
    ``SSD_BOX_TOL`` x 800 pixels); the detections end to end, every
    unmatched row a tie (``_dets_agree``).
    Training: ``_rcnn_step``, SGD, one step against the CPU by
    ``_zoo_step_check`` (``ROIAlign``'s backward adds with atomics on the
    card, another order of additions, which ``RESNET_UPDATE_RTOL``
    holds; a float64 witness takes the card's proposals,
    ``_replay_proposals``), then timed steps."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, ops
    from mxnet_tpu_torch.convert import block_weights_to_numpy
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.model_zoo.vision.rcnn import _rpn_proposals
    from mxnet_tpu_torch.ndarray import contrib as ndc
    t_phase = time.perf_counter()
    gpu = mx.gpu(dev.index or 0)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rng = np.random.RandomState(45)
    x = rng.rand(1, 3, RCNN_H, RCNN_W).astype(np.float32)
    make = vision.faster_rcnn_resnet50_v1b
    host, _ = _host_net(make, x, 45, _he_init())
    w0 = block_weights_to_numpy(host)
    with mx.cpu(), autograd.predict_mode():
        want_det = [a.asnumpy() for a in host(mx.nd.array(x))]
    with mx.cpu(), autograd.record():
        want_raw = [a.asnumpy() for a in host(mx.nd.array(x))]
    net = _card_net(make, w0, gpu)
    ops.reset_launches()
    with gpu:
        xa = mx.nd.array(x)
    t0 = time.perf_counter()
    with autograd.predict_mode():
        for _ in range(3):
            got_det = [a.asnumpy() for a in net(xa)]
        first_s = time.perf_counter() - t0
        infer_ms = _replay_ms(dev, lambda: net(xa))
    stats = dict(net._cached_op.stats)
    with autograd.record():
        got_raw = [a.asnumpy() for a in net(xa)]
    read_launches("phase 45 faster_rcnn inference", {})
    rpn = net.rpn
    n_roi = got_raw[2].shape[1]
    raw_err = [_close(got_raw[i], want_raw[i], ZOO_RAW_TOL)
               for i in (3, 4, 5)]

    def proposals(raw, device):
        sc, lc, anc = (torch.from_numpy(raw[i]).to(device) for i in (3, 4, 5))
        r, s = _rpn_proposals(sc, lc, anc, rpn._pre_nms, rpn._post_nms,
                              rpn._nms_thresh, RCNN_H, RCNN_W)
        return r[0].cpu().numpy(), s[0].cpu().numpy()
    card_own, cpu_own = proposals(got_raw, dev), proposals(want_raw, "cpu")
    cpu_same = proposals(got_raw, "cpu")
    own_ok = (np.array_equal(card_own[0], got_raw[2][0]) and
              np.array_equal(cpu_own[0], want_raw[2][0]))
    sig = [torch.sigmoid(torch.from_numpy(r[3])).numpy().ravel()
           for r in (got_raw, want_raw)]
    score_diff = float(np.abs(sig[0] - sig[1]).max())
    k = min(rpn._pre_nms, sig[1].size)
    cut = float(np.sort(sig[1])[::-1][k - 1])
    box_tol = SSD_BOX_TOL * RCNN_W
    same_in = _rois_agree(*card_own, *cpu_same, 2 * score_diff, cut,
                          box_tol, rpn._nms_thresh)
    end_to_end = _rois_agree(*card_own, *cpu_own, 2 * score_diff, cut,
                             box_tol, rpn._nms_thresh)
    matched, extra, det_ties, det_odd, box_err = _dets_agree(
        np.concatenate(want_det, -1), np.concatenate(got_det, -1), box_tol,
        net._nms_thresh, net._score_thresh)
    # the RPN sweep alone over pre_nms candidates, and ROIAlign at the
    # detector's shapes
    from mxnet_tpu_torch.ndarray.contrib import _sweep
    kk = rpn._pre_nms
    ones = torch.ones(1, kk, dtype=torch.bool, device=dev)
    sup = torch.ones(kk, kk, dtype=torch.bool, device=dev).triu(1)[None]
    sweep_launches = _cuda_launches(lambda: _sweep(ones, sup, ones))
    fh, fw = got_raw[3].shape[2:]
    g = torch.Generator(device=dev).manual_seed(45)
    feat = mx.nd.NDArray(torch.rand(1, 1024, fh, fw, device=dev,
                                    generator=g))
    rois5 = mx.nd.array(np.concatenate(
        [np.zeros((n_roi, 1), np.float32), got_raw[2][0]], 1), ctx=gpu)

    def roi_align():
        return ndc.ROIAlign(feat, rois5, pooled_size=(7, 7),
                            spatial_scale=1.0 / 16, sample_ratio=2)
    roi_align()
    roi_ms = _replay_ms(dev, roi_align, 20)
    targets = _rcnn_targets(rng, *got_raw[3].shape[1:])
    step_text, failed = _zoo_step_check(
        "phase 45 faster_rcnn step", w0, host, net, gpu, x, make,
        _sgd_rule(1),
        lambda model, tr, ctx, xs: _rcnn_step(mx, model, tr, ctx, xs,
                                              targets), "fused_sgd_update",
        replay=_replay_proposals)
    torch.backends.cudnn.deterministic = prev
    del net, host
    gc.collect()
    torch.cuda.empty_cache()
    net = _card_net(make, w0, gpu)
    trainer = gluon.Trainer(net.collect_params(), *_sgd_rule(1)[:2])
    with gpu:
        tg = [mx.nd.array(t) for t in targets]
    timed = _zoo_timed(
        dev, lambda: _rcnn_step(mx, net, trainer, gpu, xa, tg),
        "phase 45 faster_rcnn training", "fused_sgd_update")

    def rois_text(r):
        return (f"{r[0]} of {n_roi} equal at the same position (within "
                f"{box_tol:.2f} px), {r[1]} rows one side lacks, {r[2]} of "
                f"them ties, unexplained {r[3][:4]}")
    print(f"phase 45 faster_rcnn_resnet50_v1b on {card} (f32, batch 1 x 3 x "
          f"{RCNN_H} x {RCNN_W}, {got_raw[5].shape[1]} anchors, pre_nms "
          f"{kk}, post_nms {n_roi}, hybridized): inference captured "
          f"{stats['captures'] >= 1} (CachedOp {stats}; the first three "
          f"calls {first_s:.1f} s), {infer_ms:.2f} ms a call ({ZOO_TIMED} "
          f"replays, CUDA events); the RPN sweep over {kk} candidates "
          f"{sweep_launches} CUDA launches ({sweep_launches / kk:.2f} a "
          f"candidate), captured inside the graph; ROIAlign {n_roi} rois x "
          f"1024 x {fh} x {fw} -> 7 x 7 {roi_ms:.3f} ms "
          f"(CUDA events over 20 calls); RPN scores/offsets/anchors max "
          f"diff {[round(e, 7) for e, _ in raw_err]} (limit {ZOO_RAW_TOL} x "
          f"max(1, |x|)), sigmoid scores {score_diff:.2e} apart; proposals "
          f"over the same inputs: {rois_text(same_in)}; the card's rois "
          f"against the CPU's: {rois_text(end_to_end)}; end to end, "
          f"{matched} of the CPU's kept detections matched by the card's, "
          f"{extra} of the card's unmatched, {det_ties} unmatched rows "
          f"ties, unexplained {det_odd[:4]}, matched boxes max diff "
          f"{box_err:.2e} px; training (sgd lr "
          f"{ZOO_LR} momentum {ZOO_MOMENTUM} wd {ZOO_WD}): {step_text}; "
          f"{_timed_line(1, timed)}; CachedOp {dict(net._cached_op.stats)}; "
          f"launches {timed[4]}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    failed += [what for what, ok in (
        (f"rpn outputs {raw_err}", all(ok for _, ok in raw_err)),
        ("detections not finite", all(np.isfinite(a).all()
                                      for a in got_det + want_det)),
        ("the net's rois are not _rpn_proposals'", own_ok),
        (f"same-input rois unexplained {same_in[3][:4]}", not same_in[3]),
        (f"rois unexplained {end_to_end[3][:4]}", not end_to_end[3]),
        (f"detections unmatched {det_odd[:4]}", not det_odd),
        (f"matched boxes {box_err}", box_err <= box_tol),
        (f"captures {stats}", stats["captures"] >= 1 and
         stats["replays"] >= ZOO_TIMED)) if not ok]
    if failed:
        fail("phase 45: " + "; ".join(failed))
    del net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return timed[4]


def _seg_step(mx, model, trainer, ctx, xs, y):
    """Per-pixel softmax cross-entropy on FCN's two outputs; SGD."""
    from mxnet_tpu_torch import autograd, gluon
    with ctx:
        xa = xs if isinstance(xs, mx.nd.NDArray) else mx.nd.array(xs)
        ya = y if isinstance(y, mx.nd.NDArray) else \
            mx.nd.array(y, dtype="int32")
    ce = gluon.loss.SoftmaxCrossEntropyLoss(axis=1)
    with autograd.record():
        out, aux = model(xa)
        loss = ce(out, ya) + ce(aux, ya)
    loss.backward()
    trainer.step(SEG_BATCH)
    return loss


def _seg_host(make, x, seed):
    """``make()`` on the host (He's initialization from
    ``mx.random.seed(seed)``), the parts its predict-mode forward does not
    read resolved too (the backbone's classifier and the auxiliary
    head); its weights."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.convert import block_weights_to_numpy
    host, _ = _host_net(make, x[:1], seed, _he_init())
    with mx.cpu(), autograd.predict_mode():
        xa = mx.nd.array(x[:1])
        mx.random.seed(seed)
        host.base(xa)
        host.auxlayer(host.base.extract(xa)[0])
    return host, block_weights_to_numpy(host)


def segmentation(dev, card):
    """Phase 46: ``get_fcn``, ``get_psp`` and ``get_deeplab`` (ResNet-50
    v1b dilated to output stride 8, 21 classes) at crop 480, He's
    initialization from ``mx.random.seed(46)`` made on the host: predict
    mode at batch 2, hybridized (the third call a replay), against the
    CPU within ``ZOO_RAW_TOL`` x max |x|.  FCN with ``aux`` at batch 4:
    ``_seg_step`` (SGD lr 1e-3, momentum 0.9, wd 1e-4, K1), one step
    against the CPU by ``_zoo_step_check`` with the heads' Dropouts at
    rate 0 (their masks are each device's own draws), then timed steps
    on a fresh net with the Dropouts at their rates; the device time of
    layer 4 (three bottlenecks at dilation 2 and 4, 60 x 60 x 2048)
    forward and backward, timed alone at the step's shapes."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, ops
    from mxnet_tpu_torch.gluon.model_zoo import vision
    t_phase = time.perf_counter()
    gpu = mx.gpu(dev.index or 0)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rng = np.random.RandomState(46)
    x = rng.rand(SEG_BATCH, 3, SEG_SIZE, SEG_SIZE).astype(np.float32)
    y = rng.randint(0, SEG_CLASSES, (SEG_BATCH, SEG_SIZE, SEG_SIZE)) \
        .astype(np.int32)
    lines, failed = [], []
    ops.reset_launches()
    with gpu:
        xp = mx.nd.array(x[:SEG_PREDICT_BATCH])
    for name, make in (("fcn", vision.get_fcn), ("psp", vision.get_psp),
                       ("deeplab", vision.get_deeplab)):
        t0 = time.perf_counter()
        host, w0 = _seg_host(make, x, 46)
        with mx.cpu():
            want = host.predict(mx.nd.array(x[:SEG_PREDICT_BATCH])).asnumpy()
        net = _card_net(make, w0, gpu)
        for _ in range(3):
            got = net.predict(xp).asnumpy()
        ms = _replay_ms(dev, lambda: net.predict(xp))
        err, ok = _close(got, want, ZOO_RAW_TOL)
        stats = dict(net._cached_op.stats)
        lines.append(f"{name} {err:.2e} (max |x| "
                     f"{float(np.abs(want).max()):.2e}; {ms:.2f} ms a call; "
                     f"replays {stats['replays']}; "
                     f"{time.perf_counter() - t0:.1f} s)")
        if not ok or stats["replays"] < 1:
            failed.append(f"{name} predict {err:.3e}, CachedOp {stats}")
        if name == "fcn":
            fcn_host, fcn_w0 = host, w0
        del net, host
        gc.collect()
        torch.cuda.empty_cache()
    read_launches("phase 46 segmentation predict", {})
    net = _dropout_rate(_card_net(vision.get_fcn, fcn_w0, gpu), 0.0)
    # hybridized as the card's: the backbone's classifier, which FCN does
    # not read, takes a zero gradient there and steps with the rest
    _dropout_rate(fcn_host, 0.0).hybridize()
    step_text, step_failed = _zoo_step_check(
        "phase 46 fcn step", fcn_w0, fcn_host, net, gpu, x,
        lambda: _dropout_rate(vision.get_fcn(), 0.0),
        _sgd_rule(SEG_BATCH, SEG_WD),
        lambda model, tr, ctx, xs: _seg_step(mx, model, tr, ctx, xs, y),
        "fused_sgd_update")
    failed += step_failed
    torch.backends.cudnn.deterministic = prev
    del net, fcn_host
    gc.collect()
    torch.cuda.empty_cache()
    net = _card_net(vision.get_fcn, fcn_w0, gpu)
    trainer = gluon.Trainer(net.collect_params(),
                            *_sgd_rule(SEG_BATCH, SEG_WD)[:2])
    with gpu:
        xa, ya = mx.nd.array(x), mx.nd.array(y, dtype="int32")
    timed = _zoo_timed(
        dev, lambda: _seg_step(mx, net, trainer, gpu, xa, ya),
        "phase 46 fcn training", "fused_sgd_update")
    # layer 4 alone at the step's shapes, forward and backward
    layer4 = net.base.layer4
    with gpu:
        x4 = mx.nd.array(rng.rand(SEG_BATCH, 1024, SEG_SIZE // 8,
                                  SEG_SIZE // 8).astype(np.float32))
    x4.attach_grad()

    def l4():
        with autograd.record():
            out = layer4(x4)
        out.backward()
    l4()
    l4()
    l4_ms = _replay_ms(dev, l4)
    print(f"phase 46 segmentation on {card} (f32, resnet50_v1b dilated, "
          f"{SEG_CLASSES} classes, crop {SEG_SIZE}): predict mode at batch "
          f"{SEG_PREDICT_BATCH}, hybridized, card vs CPU (limit "
          f"{ZOO_RAW_TOL} x max |x|): " + "; ".join(lines) +
          f"; FCN with aux at batch {SEG_BATCH} (sgd lr {ZOO_LR} momentum "
          f"{ZOO_MOMENTUM} wd {SEG_WD}, heads' Dropouts at rate 0 for the "
          f"check): {step_text}; {_timed_line(SEG_BATCH, timed)}; layer 4 "
          f"(three dilated bottlenecks, {SEG_BATCH} x 2048 x "
          f"{SEG_SIZE // 8} x {SEG_SIZE // 8}) forward and backward alone "
          f"{l4_ms:.2f} ms ({ZOO_TIMED} calls, CUDA events, "
          f"{l4_ms / timed[0]:.3f} of the step); CachedOp "
          f"{dict(net._cached_op.stats)}; launches {timed[4]}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if failed:
        fail("phase 46: " + "; ".join(failed))
    del net, trainer, layer4
    gc.collect()
    torch.cuda.empty_cache()
    return timed[4]


def _pose_step(mx, model, trainer, ctx, xs, target):
    """``L2Loss`` on the heatmaps; Adam."""
    from mxnet_tpu_torch import autograd, gluon
    with ctx:
        xa = xs if isinstance(xs, mx.nd.NDArray) else mx.nd.array(xs)
        ta = target if isinstance(target, mx.nd.NDArray) else \
            mx.nd.array(target)
    with autograd.record():
        loss = gluon.loss.L2Loss()(model(xa), ta)
    loss.backward()
    trainer.step(POSE_BATCH)
    return loss


def simple_pose(dev, card):
    """Phase 47: ``simple_pose_resnet50_v1b`` (17 joints) at batch 32 x 3
    x 256 x 192, He's initialization from ``mx.random.seed(47)`` made on
    the host, hybridized: ``_pose_step`` (Adam lr 1e-3, K2) one step
    against the CPU by ``_zoo_step_check``, then timed steps;
    ``heatmap_to_coord`` on the card against the CPU over the card's
    heatmaps (coordinates and maxima exactly equal: both take the first
    maximum), and over each device's own (coordinates equal except where
    the CPU's heatmap ties its maximum within ``ZOO_RAW_TOL`` x max
    |x|)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.convert import block_weights_to_numpy
    from mxnet_tpu_torch.gluon.model_zoo import vision
    t_phase = time.perf_counter()
    gpu = mx.gpu(dev.index or 0)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rng = np.random.RandomState(47)
    x = rng.rand(POSE_BATCH, 3, POSE_H, POSE_W).astype(np.float32)
    target = rng.rand(POSE_BATCH, POSE_JOINTS, POSE_H // 4,
                      POSE_W // 4).astype(np.float32)
    make = vision.simple_pose_resnet50_v1b
    host, _ = _host_net(make, x[:1], 47, _he_init())
    w0 = block_weights_to_numpy(host)
    with mx.cpu(), autograd.predict_mode():
        want_hm = host(mx.nd.array(x)).asnumpy()
    net = _card_net(make, w0, gpu)
    with gpu, autograd.predict_mode():
        xa = mx.nd.array(x)
        for _ in range(3):
            got_hm = net(xa)
    hm_err, hm_ok = _close(got_hm.asnumpy(), want_hm, ZOO_RAW_TOL)
    card_c, card_s = (a.asnumpy() for a in vision.heatmap_to_coord(got_hm))
    with mx.cpu():
        same_c, same_s = (a.asnumpy() for a in vision.heatmap_to_coord(
            mx.nd.array(got_hm.asnumpy())))
        own_c, _ = (a.asnumpy() for a in vision.heatmap_to_coord(
            mx.nd.array(want_hm)))
    same_ok = np.array_equal(card_c, same_c) and np.array_equal(card_s,
                                                                same_s)
    # over each device's own heatmaps: a differing joint must be a tie
    # of the CPU's maximum
    flat = want_hm.reshape(POSE_BATCH, POSE_JOINTS, -1)
    w = POSE_W // 4
    diff = np.nonzero((card_c != own_c).any(-1))
    at = (card_c[..., 1] * w + card_c[..., 0]).astype(np.int64)
    gap = flat.max(-1) - np.take_along_axis(flat, at[..., None], -1)[..., 0]
    tie_tol = ZOO_RAW_TOL * float(np.abs(want_hm).max())
    own_ok = bool((gap[diff] <= tie_tol).all())
    rule = ("adam", {"learning_rate": ZOO_LR}, POSE_BATCH)
    step_text, failed = _zoo_step_check(
        "phase 47 simple_pose step", w0, host, net, gpu, x, make, rule,
        lambda model, tr, ctx, xs: _pose_step(mx, model, tr, ctx, xs,
                                              target), "fused_adam_update")
    torch.backends.cudnn.deterministic = prev
    del net, host
    gc.collect()
    torch.cuda.empty_cache()
    net = _card_net(make, w0, gpu)
    trainer = gluon.Trainer(net.collect_params(), *rule[:2])
    with gpu:
        ta = mx.nd.array(target)
    timed = _zoo_timed(
        dev, lambda: _pose_step(mx, net, trainer, gpu, xa, ta),
        "phase 47 simple_pose training", "fused_adam_update")
    print(f"phase 47 simple_pose_resnet50_v1b on {card} (f32, batch "
          f"{POSE_BATCH} x 3 x {POSE_H} x {POSE_W}, {POSE_JOINTS} joints, "
          f"hybridized): predict-mode heatmaps card vs CPU {hm_err:.2e} "
          f"(limit {ZOO_RAW_TOL} x max(1, |x|)); heatmap_to_coord on the "
          f"card against the CPU over the card's heatmaps: equal "
          f"{same_ok}; over each device's own: {len(diff[0])} of "
          f"{POSE_BATCH * POSE_JOINTS} joints differ, each a tie of the "
          f"CPU's maximum within {tie_tol:.2e}: {own_ok}; training (adam lr "
          f"{ZOO_LR}): {step_text}; {_timed_line(POSE_BATCH, timed)}; "
          f"CachedOp {dict(net._cached_op.stats)}; launches {timed[4]}; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    failed += [what for what, ok in (
        (f"heatmaps {hm_err}", hm_ok),
        ("heatmap_to_coord over the same heatmaps", same_ok),
        ("heatmap_to_coord over each device's own", own_ok)) if not ok]
    if failed:
        fail("phase 47: " + "; ".join(failed))
    del net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return timed[4]


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

    # phase 2: build every kernel of the paths, and the native host
    # runtime of src/ (g++) beside the nvcc builds
    from concurrent.futures import ThreadPoolExecutor
    from mxnet_tpu_torch.utils import native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host_lib = pool.submit(native.build)
        _build.build(["flash_attention", "flash_attention_bwd",
                      "paged_attention", "fused_update", "fused_layernorm"])
        host_lib = host_lib.result()
    print(f"build: {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR} "
          f"(native host runtime {os.path.basename(host_lib)})", flush=True)
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
    # phase 26b on it, before phase 23 quantizes it
    by_path["generate_llama3_8b"] = generate_llama3_8b(dev, card, net,
                                                       bf16_ref)
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
    by_path["bert_card_vs_cpu_hybridized"] = bert_card_vs_cpu(
        dev, hybridize=True)
    by_path["resnet_card_vs_cpu"] = resnet_card_vs_cpu(dev)
    by_path["dp_card_vs_cpu"] = dp_card_vs_cpu(dev)
    by_path["dp_checkpoint"] = dp_checkpoint(dev)
    # phases 26a, 27 and 28: the LLM extras
    by_path["generate"] = generate_decode(dev, card)
    blocked_ce_op(dev, card)
    by_path["training_fused_ce"] = blocked_ce_training(dev, card)
    by_path["transformer_card_vs_cpu"] = transformer_card_vs_cpu(dev)
    by_path["transformer_training"] = transformer_training(dev, card)
    # phase 30's f32 check and phase 32, before the amp phases
    by_path["dp_bert_lamb_check"] = lamb_dp_vs_gluon(dev)
    by_path["surface_card_vs_cpu"] = surface_card_vs_cpu(dev)
    by_path["oplib_full_width"] = oplib_full_width(dev, card)
    # phases 34a and 34c (no amp), 35 and 36
    by_path["quant_ops"] = quant_ops(dev, card)
    by_path["quant_bert_card_vs_cpu"] = quant_bert_card_vs_cpu(dev)
    by_path["sparse_embedding"] = sparse_full_width(dev, card)
    by_path["contrib_ops"] = contrib_full_width(dev, card)
    # phase 37: the Gluon loop through gluon.data, before amp.init
    by_path["gluon_loop"] = gluon_loop(dev, card)
    # phases 40-43: the recurrent layers, the language model, the
    # classifiers and SSD (f32, before amp.init)
    by_path["rnn_layers"] = rnn_full_width(dev, card)
    by_path["awd_lstm_lm"] = lm_training(dev, card)
    by_path["classifiers"] = classifiers(dev, card)
    by_path["ssd"] = ssd_detection(dev, card)
    # phases 44-47: YOLOv3, Faster R-CNN, segmentation and simple pose
    # (f32, before amp.init)
    by_path["yolo3"] = yolo_detection(dev, card)
    by_path["faster_rcnn"] = faster_rcnn(dev, card)
    by_path["segmentation"] = segmentation(dev, card)
    by_path["simple_pose"] = simple_pose(dev, card)
    # phases 11, 13, 15, 17 and 18 last: amp.init() is process-wide
    by_path["training_amp"], _ = train_llama3_8b(
        dev, card, amp_dtype="bfloat16", f32_first_loss=f32_first_loss)
    by_path["bert_training"] = bert_training(dev, card)
    by_path["bert_captured_vs_eager"] = bert_captured_vs_eager(dev, card)
    by_path["resnet_training"] = resnet_training(dev, card)
    by_path["dp_resnet"] = dp_training(dev, card, "resnet")
    # phase 38: the .rec-fed pipeline at phase 17's configuration
    by_path["rec_pipeline"] = rec_pipeline(dev, card)
    # phase 39: data parallelism over more than one rank (after phase
    # 17, whose dp = 1 figures 39c prints beside its own)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["dp_nccl_one_rank"] = dp_nccl_one_rank(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["dp2_card_vs_cpu"] = dp2_card_vs_cpu(dev, card)
    by_path["dp2_resnet_zero1"] = dp2_resnet(dev, card)
    by_path["dp_bert"] = dp_training(dev, card, "bert")
    # phases 30 and 31: LAMB and LARS in the captured step
    by_path["dp_bert_lamb"] = dp_training(dev, card, "bert", "lamb")
    by_path["dp_resnet_lars"] = dp_training(dev, card, "resnet", "lars")
    # phase 34b: BERT-base with every Dense quantized, beside phase 18
    for mode in ("fp8", "int8"):
        by_path[f"dp_bert_{mode}"] = dp_training(dev, card, "bert",
                                                 compute_dtype=mode)

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
    if sys.argv[1:2] == ["--dp-rank"]:     # a rank of phase 39b or 39c
        _dp_child_main(*sys.argv[2:4])
    else:
        main()
