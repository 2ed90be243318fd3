#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Runs, through ``repro_torch`` alone and with random weights from a seed:

* the recsys scoring path at the paper-scale serving configuration of
  ``benchmarks/bench_tab52_qps.py`` (an embedding table of 1,000,000 x 64
  f32 rows, a 64 -> 64 -> 32 -> 1 tower, a 4096-row hot-ID cache, Zipf(1.2)
  requests of (8, 16) raw ids over a 512-id hot pool, live sync of 2
  coalesced publishes touching 16 rows each every 8 batches);
* the GBA replay trainer as ``examples/quickstart.py`` runs it, at the full
  width of ``CRITEO_DEEPFM`` (100,003 x 16 embeddings, 26 fields, MLP
  416 -> 256 -> 128 -> 64 -> 1; 16 workers at local batch 128, M = 16,
  iota 4, 256 batches a day, Adam at lr 1e-3, 4 days);
* the sparse-module smoke of ``repro_torch.launch.train`` at V = 1,000,000,
  D = 16, batch 4, 5 steps;
* the LM's fused flat-buffer GBA step (``repro_torch.launch.train --arch
  granite-8b --fused``) at the full width of granite-8b (d_model 4096, 32
  heads / 8 KV heads, d_ff 14336, vocab 49,152, bf16 weights), depth cut
  from 36 layers to 2 (at 36 the f32 flat buffer alone would be M * N * 4
  B = 132 GB), batch 4 x 128 tokens, M = 4, iota 4, lr 1e-3, 8
  microsteps: 2 global steps, each one ``gba_apply`` launch;
* the worker-parallel wire step of the same model
  (``repro_torch.launch.train --arch granite-8b --fused --mesh 4x1
  --compress {none,int8,onebit}``): 4 PS workers, each also a shard, in one
  process on the card, one sequence of 128 tokens each, 4 layer groups,
  tile 2048, 2 float32 warmup and 2 compressed global steps per scheme;
  per compressed global step 16 quantize, 16 dequantize and 4
  ``gba_apply`` launches;
* the LM's pytree GBA step, the reference launcher's default
  (``repro_torch.launch.train --arch granite-8b``: ``run_lm_pytree``, Adam
  at lr 1e-3, a float32 accumulator), at the same width and depth, batch
  4 x 128 tokens, M = 4, iota 4, 8 microsteps; then the pytree buffer
  (``init_buffer``, ``buffer_push_and_maybe_apply``) with 4 full-width
  gradient trees, one slot stale, whose apply runs the kernel-backed tree
  ops: one ``gba_aggregate`` and one ``fused_adagrad`` launch a leaf, 12
  leaves; and ``embedding_bag_grad_resident``, the JAX package's oracle of
  the streamed backward, at the oracle test's, the sparse smoke's and the
  replay's shapes;
* tuning-free switching (``repro_torch.launch.train --arch granite-8b
  --mesh 4x1 --autoswitch --plan strained``): the switching harness on the
  same model, depth 2, 4 workers, local batch 4 x 128 tokens a slot, iota
  4, lr 1e-3, 120 local batches, its sync mode the pytree all-reduce step
  with Adagrad (no kernel) and its async mode the worker-parallel step (4
  ``gba_apply`` launches a global step); the reference's 8-step swap
  schedule and its int8 re-entry case at the same width; the demo CLI
  (``repro_torch.launch.switch_driver``) and the paper's Fig. 6 and
  autoswitch benches (``repro_torch.benchmarks``) at the reference's
  defaults;
* the paper's other two tasks, DIEN (``ALIMAMA_DIEN``: 50,021 x 19
  embeddings, 8 fields, a GRU over 16 behaviour ids, target attention,
  MLP 190 -> 128 -> 64 -> 1) and YouTubeDNN (``PRIVATE_YOUTUBEDNN``:
  100,003 x 24, 12 fields, 32 behaviour ids, MLP 336 -> 256 -> 128 -> 64
  -> 1), each from the reference's draw of ``jax.random.PRNGKey(0)``
  reproduced in numpy, on the replay trainer: a GBA day of 16 workers at
  local batch 256, M = 16, iota 4, Adam at lr 1e-3, 256 batches; and the
  paper's remaining benches at the reference's defaults (multitask, decay
  ablation, Fig. 3, Figs. 7/8, Theorems 1/2, Tab. 5.2);
* the sharded PS at the LM slice's size (granite-8b at full width, depth
  2, batch 4 x 128, M = 4, iota 4, Adagrad): the sharded fused step
  (``repro_torch.launch.train --arch granite-8b --fused --mesh 4x1
  --compress none``: the flat buffer and accumulator split into 4
  layer-grouped PS shards, 4 ``gba_apply`` launches a global step), and,
  over ``torch.distributed``'s NCCL backend with one rank holding the 4
  workers and shards (the card cannot hold two NCCL ranks), the wire step
  with int8, the switching harness (``launch.train --autoswitch --ranks``:
  its psum sync step's worker-order sum and the swaps' gathers through
  NCCL) and the sharded fused step (``--compress none --ranks``: the
  gradient reduce-scattered, the params gathered);
* LM serving of the attention-family architectures
  (``repro_torch.launch.serve --arch ...``) at full width, bf16: gemma2-27b
  (46 layers, alternating sliding-window and global attention, softcaps),
  gemma3-12b (48 layers, 5 local : 1 global, window 1,024), starcoder2-3b
  (30 sliding-window layers, layernorm), phi3.5-moe-42b-a6.6b (16 experts
  top-2; 83.7 GB of weights at its 32 layers) and kimi-k2-1t-a32b (head
  dim 112, a dense prefix layer, 384 experts top-8; 17.0 G parameters a
  MoE layer), each at the deepest stack the card's free memory holds
  (phi3.5-moe about 30 layers, kimi-k2 the prefix layer and one MoE
  layer): the fixed-batch loop at batch 4 x 128, 31 decode steps;
  gemma3-12b's rings past their window and its engine;
* LM training of the same five architectures (``repro_torch.launch.train
  --arch ... --fused [--mesh Wx1]``) at full width, bf16, batch 4 x 128,
  iota 4, lr 1e-3: the fused step, 2 global steps at the largest M of (4,
  2, 1) and the deepest stack that the card's free memory holds, on one
  layout while N < 2^31 and over layer-grouped shards above it; kimi-k2
  (19.5 G parameters at its prefix layer and one MoE layer) waits for the
  model axis;
* LM serving and training of the Mamba2 architectures at full width and
  full depth, bf16: mamba2-780m (48 Mamba2/SSD mixer layers, d_model
  1536, state 128, tied embeddings; 780 M parameters) and zamba2-2.7b (54
  layers, d_model 2560, state 64, a shared attention block of 32 heads of
  80 after every sixth mixer; 2.34 G parameters): the fixed-batch loop at
  batch 4 x 128, 31 decode steps, zamba2's two attention routes and its
  engine, and the fused step at the largest M of (4, 2, 1) that fits, on
  one layout while N < 2^31 and over layer-grouped shards past it;
* LM serving of the architectures with cross layers at full width and
  full depth, bf16: llama-3.2-vision-11b (40 layers, a cross layer every
  fifth over 1,601 stub image embeddings; 10.1 G parameters) and
  seamless-m4t-medium (12 causal encoder layers over 1,024 stub frames,
  then 12 cross layers over their output, layernorm, hd 64; 0.98 G
  parameters): the fixed-batch loop at batch 4 x 128, 31 decode steps,
  the kernel and masked routes and the engine;
* LM training of the same two (``repro_torch.launch.train --arch ...
  --fused [--mesh Wx1]``) at full width, bf16, batch 4 x 128, iota 4, lr
  1e-3, each batch with a drawn memory (1,601 image embeddings, or 1,024
  frames that the loss runs through the encoder): the fused step, 2
  global steps at the M and depth that ``train_plan`` gives (llama 5 of
  40 layers over 2 layer-grouped shards, seamless all 24 on one layout);
  the reference's training-memory variants (``repro_torch.launch.
  variants``: query chunks of 1,024, loss chunks of 512, block
  checkpoints, all three) on granite-8b at full width, depth 2, one
  sequence of 4,096 tokens;
* the model axis (``repro_torch.launch.train --arch ... --fused --mesh
  2x2``): the reference's sharding rules split granite-8b (full width,
  depth 2, bf16, batch 4 x 128, M = 4, iota 4) over 2 data x 2 model
  shards in one process (attention heads, ``d_ff`` and the vocabulary
  over the model shards; 4 ``gba_apply`` launches an apply), then over a
  one-rank NCCL world holding all four; phi3.5-moe at full width, depth
  1 (8 experts a model shard); the rules' head_dim fallback over 2 x 16
  (granite-8b depth 2: k and v along head_dim; starcoder2-3b depth 4:
  every projection); mamba2-780m (all 48 layers) and zamba2-2.7b (one
  6-layer repeat) over 2 x 2, the mixer gathered whole; the ten archs at
  ``.reduced()``; and ``--compress int8`` at ``--mesh 4x2`` (the model
  replicated) against ``4x1``.

Phases:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: compile ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a and
   print each kernel's registers, shared memory and spills;
3. each kernel against its plain PyTorch version on the card
   (``embedding_bag_grad`` against its plain version on a CPU copy, bit
   for bit, the sort-free counts kernel at D = 0; ``gba_apply`` bit for bit at
   the LM step's apply, M = 4, N =
   838,881,280, and at four edges of its contract);
4. serving from a static source: cache hits launch nothing, and a
   cache-less engine gives bit-identical scores through the kernel;
5. serving from a live source: bit-identical to a fresh engine at every
   sync;
6. a checkpoint round trip scores bit-identically;
7. the replay trainer: the card against the CPU on the quickstart's first
   4 global steps and on a hand-made stale schedule, then the quickstart's
   4 days, then a profile of its device idle share;
8. the sparse smoke, each step's gradient checked against the plain
   version;
9. the LM's fused step: 8 microsteps, exactly one ``gba_apply`` launch at
   microsteps 4 and 8 and none at the others, params and accumulator
   bit-identical across the others, and at each apply the step's flat
   params and accumulator bit-identical to ``gba_apply_ref`` run on copies
   of the pre-apply tensors; per-microstep seconds; a profile of a third
   global step (the apply's device time, the device idle share); then
   ``granite-8b.reduced()`` in float32 for 2 global steps, card against
   CPU;
10. timing: the per-call floor of a held queue, each kernel, its plain
    version and a PyTorch library call with CUDA events
    (``embedding_bag_grad`` at D = 0 on the raw ids, no sort), and the
    engine's score latency;
11. the wire step for none, int8 and onebit: the launches of every global
    step, params and accumulator after the warmup bit-identical to the
    uncompressed run (residual zero, onebit momentum nonzero), at the first
    compressed global step every quantize (codes, sidebands, residual),
    dequantize and per-shard apply held bit for bit to its plain version on
    clones of its inputs, the path's peak device memory under 70 GB, a
    profile of the last global step; then ``granite-8b.reduced()`` in
    float32, card against CPU, with the codes that differ counted; then
    each wire kernel timed at the path's largest launch;
12. the pytree step: ``gstep`` advances at microsteps 4 and 8 alone, the
    params bit-identical across the others and the accumulator all zero
    after each apply, seconds per microstep, peak memory and a profile of
    one more global step; the tree ops at the buffer's apply, each leaf's
    aggregate and update bit-identical to the plain versions on copies
    of their inputs, the aggregate bit-identical to ``aggregate_dense``
    and the update within rounding of ``optim.adagrad``, 12 launches of
    each kernel; ``granite-8b.reduced()`` in float32 card against CPU;
    the streamed ``embedding_bag_grad`` bit-identical to the resident
    kernel and the resident kernel to its plain version; each of the
    three kernels timed against its plain version, its bound and a
    library call (the resident kernel beside its earlier design's time,
    saying so where the sleep that holds the queue did not outlast the
    host's issuing);
13. LM serving: (a) the fixed-batch loop through ``launch.serve``'s
    functions, exactly 36 x 31 ``flash_decode`` launches, prefill ms,
    decode ms a step, tok/s and peak memory; the same decode with the
    plain version swapped in, both fed the loop's tokens, greedy tokens
    equal and logits within 2**-6 of the largest; a profile of one step;
    (b) decode at 32,768 positions, ms a step and a profile of one step
    (``flash_decode``'s, the head's, the MLP's and the projections'
    device time, the idle share); (c) the engine, every request complete
    and held to the offline greedy decode on the card (the first token
    equal; the bf16 tokens that agree counted); (d)
    ``granite-8b.reduced()`` in float32, card against CPU (logits within
    1e-5 of the largest, tokens equal) and its engine against the offline
    decode, every token; (e) the kernel against its plain version at the
    serve loop's and the decode_32k shapes, a ragged L, G = 1, float32 and
    head dim 64, at the first, a middle and the last position, then timed
    against the plain version, its bound and SDPA, with its launch plan
    (stages, splits) and beside its earlier design's time;
14. tuning-free switching: (a) ``run_autoswitch`` at full width, then
    its forced-sync leg, every simulated-clock field equal to the same
    runs on the CPU at ``granite-8b.reduced()``, a switch and a verified
    swap, 4 ``gba_apply`` launches at every async global step and none at
    a sync one, peak device memory under 70 GB, seconds per global step
    of each mode and per swap, a profile of one step of each mode; (b)
    the 8-step swap schedule with the shared flat state: switched,
    all-async and all-sync replays bit-identical (params, accumulator,
    losses), then with the pytree sync step: 2 swaps verified, its
    deviation from the fused run printed, and held within 1e-5 at
    ``granite-8b.reduced()`` in float32 and on the demo model; (c) int8
    re-entry over 48 batches: 4 warm steps, 16 ``quantize_minmax``, 16
    ``dequantize`` and 4 ``gba_apply`` launches per compressed global
    step, the first compressed step of the second entry held bit for bit
    to the plain versions; (d) the demo CLI on the card, both plans: every
    simulated field equal to the CPU's and the reference's numbers, its
    breaker and scrape-dropout cases card against CPU; (e) the switching
    rows, the Fig. 6 continual protocol with its seconds and a replay
    day's idle share, and the autoswitch bench;
15. the paper's three tasks: (a) for DIEN and YouTubeDNN, the first 4
    GBA global steps card against CPU (``last_update`` and the slot
    counts exact, losses within rtol 1e-4) and the stale schedule under
    SGD (parameters within rtol 1e-5 / atol 1e-7, slots dropped and rows
    rescued), then a counted GBA day (one ``embedding_bag_grad`` launch a
    global step), its seconds split into data and steps, its next-day AUC
    and a profile; (b) the six benches on the card: ``tab52_qps`` and
    ``convergence`` rows equal to the JAX benches', ``multitask``'s AUCs
    within 0.01 of the JAX bench's with both ``tuning_free=PASS``; the
    decay ablation, Fig. 3 and Figs. 7/8 rows printed with their seconds;
16. the sharded PS: (a) 8 microsteps of the sharded fused step over 4
    shards from the params and batches of phase 9's step, whose state
    after each apply is kept on the card: 4 ``gba_apply`` launches at
    microsteps 4 and 8 and none at the others, params and accumulator
    bit-identical to that step's at each apply; seconds per microstep and
    global step, peak memory and a profile of a third global step beside
    phase 9's; (b) the wire step with int8, 2 warm and 1 compressed global
    step, in process (its results kept on the host) and then over a
    one-rank NCCL world: params, accumulator, residual and losses
    bit-identical, 16 quantize, 16 dequantize and 4 ``gba_apply``
    launches in the compressed step; (c) the switching harness over the
    same NCCL world beside the same runs in process: the strained plan
    over 40 batches with the int8 wire after 2 warm async steps, and the
    8-step swap schedule, both with the psum sync step: every simulated
    field, the final flat params and accumulator and every loss
    bit-identical, a swap each way, 4 ``gba_apply`` launches an async
    global step (and 16 quantize and 16 dequantize a compressed one),
    none a sync one, peak under 70 GB, seconds a step of each kind and a
    swap; (d) the sharded fused step of (a) over the NCCL world from the
    same params and batches: params and accumulator bit-identical to
    (a)'s at each apply (host copies), every loss equal, 4 ``gba_apply``
    launches an apply, seconds a global step beside (a)'s; the process
    group destroyed;
17. LM serving of the five attention-family architectures at full width:
    (a) for each, the deepest stack that the card's free memory holds
    (``fit_depth``, its arithmetic printed), init seconds and peak, the
    fixed-batch loop counted (``flash_decode`` launches a step: one a
    global layer without an attention softcap, so gemma3-12b 8, gemma2-27b
    and starcoder2-3b none, phi3.5-moe and kimi-k2 one a layer kept; no
    other kernel),
    prefill ms, decode ms a step, tok/s and peak memory, then one more
    step whose every ``flash_decode`` launch is held to the plain version
    on the inputs the path gave it (hd 256 G 2, hd 128 G 4, hd 112 G 8);
    (b) gemma3-12b's rings at full width: a prefill of 4 x 1,152 tokens
    past its window of 1,024 and 8 decode steps, the kernel route held to
    the masked route fed the same tokens; (c) gemma3-12b's engine, 8
    requests in 4 slots, against the offline greedy decode; (d) each
    architecture's ``.reduced()`` in float32, card against CPU: logits
    within 1e-5 of the largest, greedy tokens and every MoE layer's expert
    choices equal; (e) ``flash_decode`` at (4, 32768, 8, 8, 112) and (4,
    32768, 8, 2, 256) timed against its plain version, its bound and SDPA;
18. LM training of the five attention-family architectures at full
    width, bf16, batch 4 x 128, iota 4: (a) for each, the largest M of
    (4, 2, 1) at which one repeat fits and the deepest stack at that M
    that the card's free memory holds (``train_plan``, its arithmetic
    printed), on one layout while N < 2^31 and over W layer-grouped
    shards when one repeat is past it; 2 global steps of the fused step,
    the second's first slot 6 steps old: ``W`` ``gba_apply`` launches at
    each apply and none between, each apply held bit for bit to the plain
    version at 4,096 sampled elements of every leaf, finite losses, init
    seconds and peak, seconds a microstep and a global step, the path
    peak; an architecture that no M fits (kimi-k2) prints why it waits;
    ``gba_apply`` timed on starcoder2-3b's state at its N; (b) each
    ``.reduced()`` in float32, card against CPU over the same shards:
    losses within rtol 1e-5, flat params and accumulator within rtol 1e-5
    / atol 1e-7, buffer tokens and every MoE route equal;
19. the Mamba2 architectures at full width and full depth: (a) for
    each, the fixed-batch loop of phase 17 (a) (``flash_decode``
    launches a step: none for mamba2-780m, 9 for zamba2-2.7b, one a
    shared-attention layer, each launch shape held to the plain version
    on the path's inputs: hd 80, G 1); (b) zamba2's kernel route held to
    the masked route, a prefill of 4 x 128 and 8 steps fed the same
    tokens, within 2**-6 of the largest; (c) zamba2's engine against the
    offline greedy decode; (d) each ``.reduced()`` in float32, card
    against CPU, logits within 1e-5 and greedy tokens equal; (e)
    ``flash_decode`` at (4, 160, 32, 1, 80) and (4, 32768, 32, 1, 80)
    timed against its plain version, its bound and SDPA; (f) each trained
    through the fused step as phase 18 (a), at full depth: ``train_plan``
    keeps a whole stack that memory holds, over W layer-grouped shards
    when it is past 2^31; (g) each ``.reduced()`` fused step in
    float32, card against CPU, as phase 18 (b) (zamba2's flat state
    within rtol 1e-4: its stack of 6 layers carries float32 rounding
    about ten times further);
20. the cross archs at full width and full depth: (a) for each, its
    memory (``serve.make_memory``; seamless's through ``encode_audio``,
    timed) and the fixed-batch loop of phase 17 (a) over it
    (``flash_decode`` launches a step: 48 for llama-3.2-vision-11b, 40
    self-attention and 8 cross-attention, 24 for seamless-m4t-medium,
    12 and 12; each launch shape held to the plain version on the path's
    inputs: hd 128 G 4 at 160 and 1,601 positions, hd 64 G 1 at 160 and
    1,024); (b) the kernel route held to the masked route (the
    cross-attention's too), a prefill of 4 x 128 and 8 steps fed the same
    tokens, within 2**-6 of the largest; (c) the engine, which serves
    them without a memory as the reference's does, against the offline
    greedy decode; (d) each ``.reduced()`` in float32 from one memory
    draw, card against CPU, seamless's encoder output within 1e-5 of its
    largest, logits within 1e-5 and greedy tokens equal; (e)
    ``flash_decode`` at (4, 1601, 8, 4, 128), (4, 160, 16, 1, 64) and (4,
    1024, 16, 1, 64) at their last position timed against its plain
    version, its bound and SDPA;
21. the cross archs' training and the variants: (a) for each cross
    arch, ``train_plan``'s arithmetic and phase 18 (a)'s fused step at
    full width, each microstep's batch with a drawn memory
    (``memory_entry``, as ``serve.make_memory`` draws its stub): W
    ``gba_apply`` launches an apply, each held bit for bit to the plain
    version at 4,096 sampled elements of every leaf, every cross layer's
    ``xattn`` and ``lnx`` leaf and every ``encoder`` and ``enc_norm`` leaf
    moved by the first apply, seconds and peaks, and ``gba_apply`` timed
    on the run's own state against its bound (one shard's launch over 2
    shards); (b) each ``.reduced()`` in float32, card against CPU over
    the full width's shards, from one host draw of the memory; (c)
    seamless-m4t-medium's ``.reduced()`` int8 wire step in float32, card
    against CPU (2 warm and 2 compressed global steps, each batch's drawn
    frames split over the 4 workers), one ``quantize_minmax`` a worker and
    layer group, one ``dequantize`` a shard and group and 4 ``gba_apply``
    launches a compressed step; (d) one microstep's loss and gradient of
    granite-8b at full width, depth 2, 1 x 4,096 tokens, under
    ``baseline``, ``chunked_attn``, ``remat``, ``chunked_loss`` and
    ``full_opt``, each against ``baseline`` (the loss within 2**-6
    relative, each leaf within 2**-5 of its largest), with its peak and
    seconds; then ``mamba_split`` on mamba2-780m's ``.reduced()`` in
    float32, card against CPU (logits, a prefill and 4 decode steps, every
    gradient leaf, within 1e-5 of the largest); the phase within
    ``PHASE21_BUDGET_S``;
22. the model axis: (a) granite-8b at full width, depth 2, bf16, over
    the (2, 2) mesh in process, 2 global steps with one slot stale: 4
    ``gba_apply`` launches an apply, each model shard's apply held bit
    for bit to the plain version at 4,096 sampled elements of every
    leaf, the leaves the rules leave whole bit-identical across the model
    shards, the first loss within 2**-6 of the unsharded step's on the
    same params and batches and the params put back together after the
    first apply within 2**-5 of each leaf's largest, seconds beside the
    unsharded step's, peak memory, ``gba_apply`` timed on one launch's
    block (4, 209,725,440); (b) the same over a one-rank NCCL world,
    its state bit-identical to (a)'s at each apply; (c) phi3.5-moe at
    full width, depth 1, at ``train_plan``'s M, every route of its first
    global step equal to the unsharded step's, 4 launches an apply; (d)
    the ten archs' ``.reduced()`` float32 2x2 step, card against CPU
    as phase 18 (b) (zamba2's flat state within rtol 1e-4, as phase
    19); (e) mamba2-780m (48 layers) and zamba2-2.7b (one 6-layer
    repeat) at full width, bf16, over the (2, 2) mesh, the filled leaves
    drawn at 0.1 about their fills, one global step against the
    unsharded step's (the same bounds as (a)), 4 launches an apply, the
    whole leaves bit-identical, seconds and peaks beside the unsharded
    step's; (f) the rules' head_dim fallback over (2, 16) the same way:
    granite-8b depth 2 (k and v along head_dim; 32 launches of
    26,224,640 an apply, ``gba_apply`` timed at that block) and
    starcoder2-3b depth 4 (every projection along head_dim); (g)
    ``launch.train`` on ``granite-8b.reduced()`` with ``--compress
    int8`` at ``--mesh 4x2``, its losses and launches bit for bit the
    ``--mesh 4x1`` run's; the rows of (a)-(d) within ``MODEL_BUDGET_S``,
    (e), (f) and (g) each within its own budget;
23. ``launch.steps.build_step`` (the reference's placed steps) at full
    width, bf16: (a) granite-8b, all 36 layers, served over (1, 4) in
    process by ``serve_param_specs`` (every weight whole over ``data``):
    the prefill of 4 x 128 tokens and 31 greedy decode steps, 36 x 4
    ``flash_decode`` launches a step, each on one model shard's 2 KV
    heads, 8 launches of one more step held to the plain version on
    their own inputs, every step's logits within 2**-6 of the largest of
    the unplaced decode fed the same tokens (a greedy token it would not
    pick is printed with its margin); (b) the same over (2, 2) by
    ``param_specs`` (each layer gathered over ``data`` on use), in
    process and over one NCCL rank, bit-identical; (c) the placed pytree
    step (Adam), granite-8b depth 2 over (2, 2), M = 4, one apply,
    against the unplaced pytree step: the first loss within 2**-6, 4,096
    sampled elements of every param leaf within lr either side plus a
    bf16 ulp, then over one NCCL rank bit-identical (losses and every
    held block); (d) ``launch.dryrun.dryrun_step`` at (1, 1) for (a)'s
    decode and (c)'s applying microstep against the same steps at (1, 1)
    on the card: argument bytes within 1 % of the allocation of the held
    state and inputs, argument + temporary bytes printed beside the
    step's peak; the card's memory equal to the dry run's ``CARD_BYTES``;
    within ``STEPS_BUDGET_S``;
24. the long-context decode whose KV sequence the rules split over
    ``data`` (``long_500k``: 524,288 positions, batch 1), bf16 at full
    width through ``launch.steps.build_step``: (a) gemma3-12b, all 48
    layers, over (4, 1) in process, its cache slices drawn on the card
    directly (never the whole cache beside them) up to ``pos = L - 8``,
    ``LONG_STEPS`` greedy steps of 32 ``flash_decode_partial`` launches
    (8 global layers x 4 data shards), ``LONG_SAMPLED`` launches held to
    the plain version (out and lse), the step time, peak memory and
    launches printed; (b) gemma3-12b at depth 12 (two global layers)
    over (2, 2) from ``pos = L/2 - 2``, so that the new rows cross a
    slice boundary, held to the unplaced ``decode_step`` on the whole
    cache drawn from the same seed (each step's logits within 2**-6 of
    the largest, a differing greedy token printed with its margin), then
    over one NCCL rank bit-identical; (c) zamba2-2.7b, all 54 layers,
    over (4, 1) as (a) at head dim 80, and at depth 6 (one shared
    attention) held to the unplaced decode as (b); (d) starcoder2-3b, all
    30 layers (its rings alone), and gemma2-27b at depth 4 (the
    softcapped masked partial), over (2, 2), held as (b); (e)
    ``launch.dryrun.dryrun_step`` for (a)'s decode: 4 x device (0, 0)'s
    argument bytes within 1 % of the allocation of (a)'s held state;
    the partial launch timed at (a)'s and (c)'s slices against its plain
    version, its bound and SDPA; within ``LONG_BUDGET_S``;
25. the static auditor's card side (``repro_torch.analysis``, which runs
    on the CPU and sees the kernels' plain versions only): (a) GBA-FLOW-002
    on the CUDA kernels: ``gba_apply`` at one (data, model) block of
    granite-8b depth 2 over 2 x 2, (4, 209,725,440) float32, the sharded
    apply over W = 4 shards at that size, and ``gba_aggregate`` at (4,
    201,326,592) bfloat16, each with one slot at token = step - iota - 1
    filled once with 1e30 (a large finite bfloat16 for the aggregate) and
    once with zeros: params, accumulator and aggregate bit-identical
    between the two fills, and changed when a fresh slot changes; (b)
    GBA-COLL-001/002: one global step of the layer-grouped fused psum step
    at granite-8b full width, depth 2, W = 4, in process and over one
    NCCL rank, under ``census.RecordingWorld``: the recorded schedule
    equal to the layout's (one gather a layer group, in group order, one
    (4, group_shard) route a group and worker, the scalar losses), the
    two runs bit-identical; (c) GBA-COLL-003 and GBA-DTYPE-002: one
    granite-8b decode step at full width and all 36 layers under
    ``census.CensusMode``: no collective and no float64 operator (the
    kernels are ``ctypes`` calls the mode does not see, so what it sees
    is the port's own code); (d) each kernel's launch meta against the
    launch the card made: the card's limits (``launch_record.
    device_limits``, and ``repro_flash_decode_smem``) equal to
    ``launch_meta.HOPPER``; every meta of ``analysis.audit.kernel_metas()``,
    row (f) at (4, 209,725,440) and a ``gba_apply`` on views one element
    off their allocation (the scalar path) launched through its wrapper
    under ``torch.profiler`` on inputs drawn from a seed, in a child
    process (``chip_smoke.py --launch-row``: by phase 25 this process's
    traces held none of the package's kernels), each recorded
    launch's grid and block equal to the meta's, its shared memory the
    meta's dynamic bytes plus the compiler's static bytes (``-Xptxas -v``),
    registers x threads within an SM's, a cooperative grid within the
    blocks the card holds at once, no ``launch_check`` finding under the
    card's limits, and each output within phase 3's tolerance of its plain
    version; each kernel's registers and spills in the phase's JSON line;
    within ``AUDIT_BUDGET_S``;
26. Tab. 5.2's online-learning serving rows and the trainer leftovers:
    (a) ``benchmarks.tab52_qps.run_serving`` at V = 1,000,000 and 64
    batches on the card and on the CPU, both rows printed beside the
    card's name and power limit, every column but the latencies equal to
    the other device's and to the JAX package's, one ``embedding_bag``
    launch per lookup call (so the all-hit probe, which makes no call,
    launches nothing); (b) DeepFM's replay state (params, Adam state,
    ``last_update``) after 1, 2 and 3 of the quickstart's global steps on
    the card through ``CheckpointManager(keep=2)``: steps 2 and 3 kept and
    restored onto the card bit-identical; (c) 3 ``adam(weight_decay=)``
    updates of DeepFM's params with a ``warmup_cosine`` ``lr_override``
    (its step a tensor on the card) and ``clip_by_global_norm``, card
    against CPU within rtol 1e-5 / atol 1e-7; within ``TAB52_BUDGET_S``;
27. one JSON line of the kernels, then the result line.

Every count of kernel launches is set to 0 just before each path (the
serving phases 4-6, the quickstart's 4 days, the sparse smoke, the LM's 8
microsteps, each scheme of the wire step, the pytree step, its tree ops,
the resident oracle, the serve loop, the 32k decode, the engine, the
autoswitch run, the int8 re-entry run, each model's GBA day of phase 15,
the six benches, the sharded fused step, each wire run of phase 16 and
each of its NCCL switching runs and its NCCL sharded fused step, each
architecture's serve loop, gemma3-12b's ring and its engine, each
architecture's training run, each Mamba2 architecture's serve loop,
zamba2's kernel route and its engine, each Mamba2 architecture's
training run, each cross architecture's serve loop, kernel route and
engine, each cross architecture's training run, and each run of the
model axis, each placed serve loop of phase 23, each decode of
phase 24, each part of phase 25, and phase 26's serving run on the
card)
and read just after it, so
``launches`` counts those paths alone.  Any failure
raises and the script exits non-zero without the result line.  It needs a
CUDA card and the repository's ``src/`` beside it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
WORK = ROOT / "build" / "chip_smoke"

# bench_tab52_qps.py:93-100
V, DIM, MLP = 1_000_000, 64, (64, 32)
HOT, CACHE = 512, 4096
B, F = 8, 16
SYNC_EVERY, PUBS_PER_SYNC, TOUCH = 8, 2, 16
NUM_BATCHES = 64
LATENCY_BATCHES = 1024

# H100 SXM (NVIDIA data sheet): HBM rate and float32 rate outside the
# tensor cores, for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# bf16 outputs: the kernel and the plain version both sum in f32 and round
# once, so where their f32 sums straddle a rounding boundary they differ by
# one bf16 ulp, at most 2**-7 of |x|.  A running sum kept in bf16 misses
# this on about a quarter of the outputs of the bf16 cases.
BF16_RTOL, BF16_ATOL = 2.0**-7, 1e-6

# the training slice: the sparse smoke's table (launch/train.py) and the
# JAX quickstart's per-day AUC, examples/quickstart.py on the CPU
SMOKE_V, SMOKE_D, SMOKE_BATCH, SMOKE_STEPS = 1_000_000, 16, 4, 5
QUICKSTART_DAYS = 4
JAX_QUICKSTART_AUC = (0.5633, 0.6970, 0.7417, 0.7728)
HOLD_STEPS = 4                   # quickstart steps held card against CPU
HOLD_LOSS_RTOL = 1e-4            # Adam: rounding grows to ~lr per step
STALE_PARAM_RTOL, STALE_PARAM_ATOL = 1e-5, 1e-7   # SGD, f32 sum orders

# the paper's three tasks (phase 15): DIEN and YouTubeDNN replayed from the
# reference's draw of PRNGKey(0), a GBA day of 16 workers x 256 (M = 16,
# iota 4, Adam 1e-3, the quickstart's cluster: 25 % stragglers at 5x), 256
# batches a day (16 global steps), its first steps held card against CPU
TASK_LOCAL_BATCH, TASK_BATCHES, TASK_LR = 256, 256, 1e-3
# the JAX package's benches on the CPU (jax 0.9.0, their defaults), "name,
# derived" without us_per_call: benchmarks/bench_convergence.py and
# bench_tab52_qps.py's run are numpy, so the port's rows must equal these
REF_CONVERGENCE_ROWS = (
    "thm.sync_floor.G64,floor=3.249e-03",
    "thm.sync_floor.G128,floor=1.625e-03",
    "thm.sync_floor.G256,floor=8.123e-04",
    "thm.sync_floor.G512,floor=4.061e-04",
    "thm.floor_scales_inverse_G,ratios=0.50|0.50|0.50;expected=0.50;pass=True",
    "thm.gba_floor.stale0,floor=7.988e-04;vs_sync=0.98",
    "thm.gba_floor.stale2,floor=8.948e-04;vs_sync=1.10",
    "thm.gba_floor.stale4,floor=9.859e-04;vs_sync=1.21",
)
REF_TAB52_ROWS = (
    "tab52.qps.vacant.sync,qps=53542;std=1;avg_stale=0.00;max_stale=0;drops=0",
    "tab52.qps.vacant.async,qps=114779;std=115;avg_stale=14.94;max_stale=23;"
    "drops=0",
    "tab52.qps.vacant.hop_bs,qps=114779;std=115;avg_stale=0.00;max_stale=0;"
    "drops=0",
    "tab52.qps.vacant.bsp,qps=114779;std=115;avg_stale=0.93;max_stale=1;"
    "drops=0",
    "tab52.qps.vacant.hop_bw,qps=85602;std=46;avg_stale=0.00;max_stale=0;"
    "drops=480",
    "tab52.qps.vacant.gba,qps=114779;std=115;avg_stale=0.00;max_stale=0;"
    "drops=0",
    "tab52.qps.moderate.sync,qps=23533;std=3661;avg_stale=0.00;max_stale=0;"
    "drops=0",
    "tab52.qps.moderate.async,qps=78299;std=340;avg_stale=14.94;max_stale=69;"
    "drops=0",
    "tab52.qps.moderate.hop_bs,qps=31387;std=7866;avg_stale=0.14;max_stale=2;"
    "drops=0",
    "tab52.qps.moderate.bsp,qps=78299;std=340;avg_stale=0.93;max_stale=4;"
    "drops=0",
    "tab52.qps.moderate.hop_bw,qps=45982;std=686;avg_stale=0.00;max_stale=0;"
    "drops=480",
    "tab52.qps.moderate.gba,qps=78299;std=340;avg_stale=0.14;max_stale=3;"
    "drops=0",
    "tab52.qps.strained.sync,qps=13243;std=2654;avg_stale=0.00;max_stale=0;"
    "drops=0",
    "tab52.qps.strained.async,qps=67714;std=2084;avg_stale=14.94;"
    "max_stale=144;drops=0",
    "tab52.qps.strained.hop_bs,qps=16959;std=4869;avg_stale=0.19;max_stale=2;"
    "drops=0",
    "tab52.qps.strained.bsp,qps=67714;std=2084;avg_stale=0.93;max_stale=9;"
    "drops=0",
    "tab52.qps.strained.hop_bw,qps=38345;std=1614;avg_stale=0.00;max_stale=0;"
    "drops=480",
    "tab52.qps.strained.gba,qps=67714;std=2084;avg_stale=0.17;max_stale=4;"
    "drops=13",
    "tab52.claims,gba_vs_async_qps=1.000;gba_vs_sync_speedup=5.11x;"
    "claim_2.4x=PASS;hopbw_drops=480;gba_drops=13;gba_stale=0.17;"
    "hopbs_stale=0.19",
)
# benchmarks/bench_multitask.py: the port's AUCs within MULTITASK_ATOL
REF_MULTITASK = {
    "alimama-dien": {"base_auc": 0.7587, "sync_first": 0.7553,
                     "gba_first": 0.7554},
    "private-youtubednn": {"base_auc": 0.7259, "sync_first": 0.7367,
                           "gba_first": 0.7361},
}
MULTITASK_ATOL = 0.01

# the LM slice: granite-8b at full width, depth 36 cut to 2; batch, seq, M,
# iota and lr are the launcher's defaults (repro.launch.train)
LM_LAYERS, LM_BATCH, LM_SEQ, LM_M, LM_IOTA, LM_LR = 2, 4, 128, 4, 4, 1e-3
LM_MICROSTEPS = 8
APPLY_N = 838_881_280          # flat params of that model: gba_apply's N
HOLD_LM_RTOL, HOLD_LM_ATOL = 1e-5, 1e-7    # card vs CPU, float32 sum orders

# the wire slice: the same model, W = 4 PS workers and shards in one process
# (repro.launch.train --mesh 4x1 --compress {none,int8,onebit}), 2 float32
# warmup and 2 compressed global steps
WIRE_W, WIRE_STEPS, WIRE_WARMUP = 4, 4, 2
WIRE_PEAK_GB = 70.0            # the path's peak device memory, of 80 GB
# card vs CPU: float32 sum orders, as for the LM step; a code that flips at
# a rounding boundary moves one routed value by one quantization step
WIRE_HOLD_RTOL = 1e-5
# at the first compressed step the two sides' payloads differ by float32
# sum orders only: a code may differ only where the payload lies within
# this many quantization steps of a rounding boundary (minmax: the scaled
# offset (x - zero) / scale near a half, the codes one apart; sign: x /
# scale, the scale being the tile's mean |x|, near 0)
WIRE_FLIP_NEAR = 0.05
F64_OPS_PER_S = 34e12          # H100 SXM float64 outside the tensor cores

# the two kernels' earlier designs (the resident kernel's serial chunk
# scan; flash_decode's CUDA-core split pass and combine pass), as an
# earlier version of this script read them on an H100 80GB HBM3 at 700 W:
# printed beside the new times for orientation only, never in the kernels
# line.  They were timed another way (the resident kernel over 100 held
# calls, flash_decode at 32k over 10 calls with no sleep); the same-method
# comparison of both designs is scripts/kernel_ab.py.
EARLIER_MS = {
    ("embedding_bag_grad_resident", "(64, 26, 500, 16)"): {
        "ms": 0.1955146, "wrapper_ms": 0.2339386, "method": "100 held calls",
        "design": "one thread group a row scanning every chunk entry"},
    ("embedding_bag_grad_resident", "(b)"): {
        "ms": 0.0267350, "wrapper_ms": 0.0528515, "method": "100 held calls",
        "design": "one thread group a row scanning every chunk entry"},
    ("flash_decode", (4, 160, 8, 4, 128)): {
        "ms": 0.0084611, "method": "100 held calls",
        "design": "CUDA-core split pass and combine pass"},
    ("flash_decode", (4, 32_768, 8, 4, 128)): {
        "ms": 0.2140864, "method": "10 calls, not held",
        "design": "CUDA-core split pass and combine pass"},
}

TIMED_SHAPES = ((128, 1), (4096, 16))   # serving miss pool, bulk pool
TIMED_ID_SETS = 16     # cycled so the (4096, 16) pools span 268 MB > L2
TIMED_REPS = 100
# the segment sums' wrapper, plain version and library call launch several
# kernels a call: 20 calls fit the launch queue while a sleep holds the
# device, 100 fill it and the host waits
SEGMENT_REPS = 20


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase(n: int, title: str) -> None:
    print(f"== phase {n}: {title}", flush=True)


def bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def hot_batch(rng: np.random.Generator, hot: np.ndarray) -> np.ndarray:
    """(B, F) raw ids, Zipf-skewed inside the hot pool
    (bench_tab52_qps.py:103-106)."""
    ranks = rng.zipf(1.2, size=(B, F)) - 1
    return hot[np.minimum(ranks, hot.shape[0] - 1)]


def device_phase() -> tuple[str, str]:
    phase(1, "device")
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {name}; count {count}; torch {torch.__version__}; "
          f"cuda {torch.version.cuda}")
    for line in smi.splitlines()[:1]:
        print(line)
    return name, smi.splitlines()[0] if smi else "nvidia-smi: no answer"


def build_phase(runtime) -> None:
    phase(2, "build")
    t0 = time.perf_counter()
    libs = runtime.build()
    for name, lib in libs.items():
        runtime.load_library(name)
        print(f"built {lib.relative_to(ROOT)}")
    print(f"build and load took {time.perf_counter() - t0:.1f} s")
    for line in runtime.build_log().splitlines():
        if "ptxas info" in line or "spill" in line:
            print("  " + line.strip())
    try:                        # cudaErrorInvalidValue is reported by name
        runtime.check(1, "an error code")
    except RuntimeError as e:
        check("invalid argument" in str(e), f"CUDA error text: {e}")
    else:
        check(False, "runtime.check raises on a CUDA error")


def kernel_cases(gen: torch.Generator, big: torch.Tensor, hash_ids) -> list:
    """(name, ids, table) on the card, at the serving path's and the sparse
    smoke's shapes and at the edges of the kernel's contract."""
    dev = big.device

    def ids(b, f, hi):
        return torch.randint(0, hi, (b, f), generator=gen, device=dev,
                             dtype=torch.int32)

    def table(v, d, dtype=torch.float32):
        return (torch.randn((v, d), generator=gen, device=dev)
                * 0.01).to(dtype)

    miss = ids(128, 1, V)
    miss[100:] = V                               # fetch_rows' sentinel pad
    odd = ids(64, 16, V)
    odd[:, ::3] = -1
    odd[:, 1::5] = V
    odd[:, 2::7] = V + 12345
    odd[0] = -7                                  # a bag of no valid id
    dup = ids(64, 16, V)
    dup[:, 8:] = dup[:, :8]                      # each id twice in its bag
    dup[1] = dup[1, 0]                           # one id 16 times
    return [
        ("serving miss (128, 1) + sentinel", miss, big),
        ("bulk pool (4096, 16)", ids(4096, 16, V), big),
        ("F=1 bulk (4096, 1)", ids(4096, 1, V), big),
        ("sparse smoke forward (4, 26) hashed, D=16",
         smoke_ids(hash_ids, torch.Generator().manual_seed(5), SMOKE_BATCH),
         table(SMOKE_V, SMOKE_D)),
        ("negative, >= V and sentinel ids", odd, big),
        ("duplicates inside a bag", dup, big),
        ("D=80 (not a tile multiple)", ids(256, 16, 50_000),
         table(50_000, 80)),
        ("D=13 (scalar loads)", ids(256, 8, 10_000), table(10_000, 13)),
        ("bf16 table (4096, 16)", ids(4096, 16, V), big.to(torch.bfloat16)),
        ("bf16 F=1 (128, 1)", ids(128, 1, V), big.to(torch.bfloat16)),
        ("bf16 D=20 (scalar loads)", ids(256, 16, 10_000),
         table(10_000, 20, torch.bfloat16)),
    ]


def bf16_summed(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The pooled lookup with the running sum rounded to bf16 after every
    add: what a kernel that broke the f32-accumulation contract gives."""
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = table[torch.where(valid, ids, 0).long()]
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    acc = torch.zeros_like(rows[:, 0])
    for f in range(ids.shape[1]):
        acc = acc + rows[:, f]
    return acc


def kernel_phase(embedding_bag, embedding_bag_ref, big, gen,
                 hash_ids) -> float:
    phase(3, "each kernel vs its plain version on the card")
    max_err = 0.0
    for name, ids, table in kernel_cases(gen, big, hash_ids):
        out = embedding_bag(ids, table)
        ref = embedding_bag_ref(ids, table)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == table.dtype,
              f"{name}: shape/dtype")
        err = (out.float() - ref.float()).abs().max().item()
        if ids.shape[1] == 1:
            ok = torch.equal(out.view(torch.int16 if out.dtype ==
                                      torch.bfloat16 else torch.int32),
                             ref.view(torch.int16 if ref.dtype ==
                                      torch.bfloat16 else torch.int32))
            tol = "bit-exact"
        elif table.dtype == torch.bfloat16:
            ok = torch.allclose(out.float(), ref.float(), rtol=BF16_RTOL,
                                atol=BF16_ATOL)
            tol = f"rtol={BF16_RTOL} atol={BF16_ATOL} in f32"
            # the tolerance catches a kernel that sums in bf16
            check(not torch.allclose(bf16_summed(ids, table).float(),
                                     ref.float(), rtol=BF16_RTOL,
                                     atol=BF16_ATOL),
                  f"{name}: a bf16 running sum stays within the tolerance")
        else:
            ok = torch.allclose(out, ref, rtol=1e-5, atol=1e-6)
            tol = "rtol=1e-5 atol=1e-6"
        valid = (ids >= 0) & (ids < table.shape[0])
        empty = ~valid.any(dim=1)
        if empty.any():
            ok = ok and bool((out[empty] == 0).all())
        print(f"  {name}: ids {tuple(ids.shape)} table "
              f"{tuple(table.shape)} {str(table.dtype)[6:]}: max|err| "
              f"{err:.3g} ({tol}) {'ok' if ok else 'FAIL'}")
        check(ok, f"kernel vs plain version: {name}")
        max_err = max(max_err, err)
    return max_err


def presence_ids(stream, sched, k: int) -> torch.Tensor:
    """(1, M * B * F) ids of the quickstart's global step ``k`` of day 0,
    slot i's ids offset by i * capacity: what the trainer's
    ``presence_counts`` hands the grad kernel."""
    cap = stream.cfg.hash_capacity
    fields = np.stack([stream.batch(0, slot.batch_index)["fields"]
                       for slot in sched.steps[k]])
    m = fields.shape[0]
    ids = fields.reshape(m, -1) + (np.arange(m, dtype=np.int32)
                                   * cap)[:, None]
    return torch.from_numpy(ids.reshape(1, -1)).cuda()


def smoke_ids(hash_ids, gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, 26) hashed ids over ``SMOKE_V`` rows, drawn as the sparse smoke
    draws them."""
    raw = torch.randint(0, 1 << 30, (n, 26), generator=gen)
    return hash_ids(raw, SMOKE_V).cuda()


def grad_kernel_cases(T: dict, gen: torch.Generator) -> list:
    """(name, ids, grad_out, capacity) on the card: the training paths'
    shapes (a) and (b) and the edges of the kernel's contract."""
    dev = torch.device("cuda")
    cpu_gen = torch.Generator().manual_seed(7)

    def ids(b, f, hi):
        return torch.randint(0, hi, (b, f), generator=gen, device=dev,
                             dtype=torch.int32)

    def rows(b, d):
        return torch.randn((b, d), generator=gen, device=dev)

    a = T["presence"][0]
    cap_a = T["presence_capacity"]
    odd = ids(64, 16, SMOKE_V)
    odd[:, ::3] = -1
    odd[:, 1::5] = SMOKE_V
    odd[:, 2::7] = SMOKE_V + 12345
    odd[0] = -7                                  # a bag of no valid id
    dup = ids(64, 16, 5000)
    dup[:, 8:] = dup[:, :8]                      # each id twice in its bag
    dup[1] = dup[1, 0]                           # one id 16 times
    edge = ids(64, 26, 24) + 245                 # rows 245 .. 268 and
    edge[:, 13:] += 256                          # 501 .. 524: D = 16 tiles
    edge[::2, :20] = 255                         # hold 256 rows; a run of
    no_rows = torch.zeros((1, 0), device=dev)    # 640 entries at row 255
    return [
        ("(a) presence counts of a quickstart step, D=0 (counts only)", a,
         no_rows, cap_a),
        ("(a) one id 53,248 times, D=0", torch.full_like(a, 1_234_567),
         no_rows, cap_a),
        ("negative, >= V and INT_MAX ids, D=0",
         torch.where(odd == SMOKE_V + 12345, 2**31 - 1, odd).reshape(1, -1),
         no_rows, SMOKE_V),
        ("(a) ids as 64 bags, random rows, D=1", a.reshape(64, -1),
         rows(64, 1), cap_a),
        ("(b) sparse smoke backward (4, 26)", smoke_ids(T["hash_ids"],
                                                        cpu_gen, 4),
         rows(4, SMOKE_D), SMOKE_V),
        ("negative, >= V and sentinel ids", odd, rows(64, 16), SMOKE_V),
        ("repeated ids inside one bag", dup, rows(64, 16), 5000),
        ("D=13 (scalar loads)", ids(256, 8, 10_000), rows(256, 13), 10_000),
        ("runs across D=16 tile edges", edge, rows(64, 16), 600),
        ("empty batch", ids(0, 26, 1000), rows(0, 16), 1000),
    ]


def grad_kernel_check(T: dict, gen: torch.Generator) -> float:
    """``embedding_bag_grad`` on the card against its plain version on a
    CPU copy: counts exact, table gradient bit-identical (both sum each
    row in entry order from 0.0)."""
    max_err = 0.0
    for name, ids, grad, cap in grad_kernel_cases(T, gen):
        gt, cnt = T["embedding_bag_grad"](ids, grad, cap)
        design = T["device_grad_plan"](torch.cuda.current_device(), cap,
                                       grad.shape[1])[0]
        torch.cuda.synchronize()
        ref_gt, ref_cnt = T["embedding_bag_grad_ref"](ids.cpu(), grad.cpu(),
                                                      cap)
        ok = (gt.shape == ref_gt.shape and torch.equal(cnt.cpu(), ref_cnt)
              and torch.equal(gt.cpu().view(torch.int32),
                              ref_gt.view(torch.int32)))
        err = (gt.cpu() - ref_gt).abs().max().item() if gt.numel() else 0.0
        print(f"  embedding_bag_grad {name}: ids {tuple(ids.shape)} over "
              f"V={cap} D={grad.shape[1]}, {design} design: counts "
              f"exact and gtable bit-identical: {'ok' if ok else 'FAIL'} "
              f"(max|err| {err:.3g}, {int(ref_cnt.sum())} valid entries)")
        check(ok, f"embedding_bag_grad vs plain version: {name}")
        max_err = max(max_err, err)
    return max_err


def apply_inputs(m: int, n: int, ages: list[int], param_dtype=torch.float32,
                 buf_dtype=torch.float32, seed: int = 0) -> tuple:
    """(param, accum, buffer, tokens, step) on the card: params at the
    model's init scale, Adagrad accumulators from 0.1 up, gradient-sized
    buffer rows, and slot j's token ``ages[j]`` steps old."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    step = 9
    param = (torch.randn((n,), generator=gen, device="cuda") * 0.02
             ).to(param_dtype)
    accum = 0.1 + torch.rand((n,), generator=gen, device="cuda")
    buffer = (torch.randn((m, n), generator=gen, device="cuda") * 1e-3
              ).to(buf_dtype)
    tokens = torch.tensor([step - a for a in ages], dtype=torch.int32,
                          device="cuda")
    return param, accum, buffer, tokens, step


def apply_cases() -> list:
    """(name, m, n, ages, param dtype, buffer dtype): the LM step's apply
    and the edges of the kernel's contract (iota is ``LM_IOTA``)."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("(i) the LM step's apply, all fresh", LM_M, APPLY_N, [0] * LM_M,
         f32, f32),
        ("(ii) ragged N, a stale slot, bf16 param", 3, 5000, [0, 5, 1], bf16,
         f32),
        ("(iii) every slot stale (odd N, one column a thread)", 4, 4099,
         [5, 6, 7, 9], f32, f32),
        ("(iv) bf16 buffer", 4, 8192, [0, 1, 4, 5], f32, bf16),
        ("(v) bf16 param and buffer, odd N", 8, 10_001, list(range(8)), bf16,
         bf16),
    ]


def apply_kernel_check(T: dict) -> float:
    """``gba_apply`` on the card against its plain version on the same
    tensors: param and accumulator bit for bit.  Returns the largest
    absolute difference (0.0 when every case is bit-identical)."""
    max_err = 0.0
    for name, m, n, ages, p_dt, b_dt in apply_cases():
        param, accum, buffer, tokens, step = apply_inputs(m, n, ages, p_dt,
                                                          b_dt)
        before_p, before_a = param.clone(), accum.clone()
        want_p, want_a = T["gba_apply_ref"](param, accum, buffer, tokens,
                                            step, LM_LR, iota=LM_IOTA)
        T["gba_apply"](param, accum, buffer, tokens, step, LM_LR,
                       iota=LM_IOTA)
        torch.cuda.synchronize()
        bits = torch.int16 if p_dt == torch.bfloat16 else torch.int32
        ok = (torch.equal(param.view(bits), want_p.view(bits))
              and torch.equal(accum.view(torch.int32),
                              want_a.view(torch.int32)))
        stale = all(a > LM_IOTA for a in ages)
        moved = not torch.equal(accum, before_a)
        ok = ok and (torch.equal(param, before_p) and not moved if stale
                     else moved)
        print(f"  gba_apply {name}: M={m} N={n} param {str(p_dt)[6:]} buffer "
              f"{str(b_dt)[6:]} ages {ages}: param and accum bit-identical to "
              f"the plain version{', both unchanged' if stale else ''}: "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"gba_apply vs plain version: {name}")
        max_err = max(max_err, (param.float() - want_p.float()).abs().max()
                      .item(), (accum - want_a).abs().max().item())
        del param, accum, buffer, before_p, before_a, want_p, want_a
        torch.cuda.empty_cache()
    return max_err


def serving_static_phase(S, params, hot, counters) -> dict:
    phase(4, "serving, static source")
    cfg = S.ServingConfig(cache_capacity=CACHE)
    eng = S.RecsysScoringEngine(S.StaticSource(params), config=cfg)
    rng = np.random.default_rng(0)
    eng.score(hot.reshape(1, -1))       # warm: one pool over the hot set
    eng.latencies_us.clear()
    per_call = []
    for _ in range(NUM_BATCHES):
        l0 = counters()["embedding_bag"]
        out = eng.score(hot_batch(rng, hot))
        per_call.append(counters()["embedding_bag"] - l0)
        check(out.shape == (B,) and bool(np.isfinite(out).all()),
              "scores finite, shape (B,)")
    probe = hot_batch(rng, hot)
    eng.score(probe)                            # make the probe resident
    before = counters()
    hit_scores = eng.score(probe)
    check(counters() == before, "an all-hit batch launches no kernel")
    nocache = S.RecsysScoringEngine(S.StaticSource(params),
                                    config=S.ServingConfig(cache_capacity=0))
    miss_scores = nocache.score(probe)
    after = counters()
    check(after["embedding_bag"] == before["embedding_bag"] + 1
          and after["calls"] == before["calls"] + 1,
          "a cache-less engine launches the kernel once per score")
    check(np.array_equal(bits(hit_scores), bits(miss_scores)),
          "cache and no-cache scores bit-identical")
    st = eng.stats()
    print(f"  hit_rate {st['hit_rate']:.4f}; p50 {st['p50_us']:.1f} us, "
          f"p99 {st['p99_us']:.1f} us over {NUM_BATCHES} requests; "
          f"launches per score: {np.bincount(per_call).tolist()} "
          f"(count of requests with 0, 1, ... launches)")
    check(max(per_call) <= 1, "at most one launch per score")
    return {"engine": eng, "probe": probe, "probe_scores": hit_scores,
            "stats": st, "launch_hist": np.bincount(per_call).tolist()}


def serving_live_phase(S, params, hot, hash_ids) -> dict:
    phase(5, "serving, live source")
    cfg = S.ServingConfig(cache_capacity=CACHE)
    chan = S.UpdateChannel()
    live = S.LiveSource(chan, params, sync_interval=cfg.sync_interval,
                        start=False)
    eng = S.RecsysScoringEngine(live, config=cfg)
    rng = np.random.default_rng(1)
    check_rng = np.random.default_rng(2)
    eng.score(hot.reshape(1, -1))
    eng.latencies_us.clear()
    table = params["table"]
    step = max_lag = syncs = 0
    for i in range(NUM_BATCHES):
        eng.score(hot_batch(rng, hot))
        if (i + 1) % SYNC_EVERY:
            continue
        for _ in range(PUBS_PER_SYNC):
            step += 1
            touch = hash_ids(torch.from_numpy(rng.choice(HOT, TOUCH)), V)
            new = table.table.clone()
            new.index_put_((touch.long().to(new.device),),
                           torch.tensor(0.01, device=new.device),
                           accumulate=True)
            table = table._replace(table=new)
            chan.publish({"table": table, "mlp": params["mlp"]}, step,
                         touched_ids=touch.numpy())
        max_lag = max(max_lag, live.freshness_lag_steps())
        snap = live.sync_now()
        syncs += 1
        check(snap.version == syncs + 1, "one version per sync")
        fresh = S.RecsysScoringEngine(S.StaticSource(snap.params),
                                      config=cfg)
        batch = hot_batch(check_rng, hot)
        check(np.array_equal(bits(eng.score(batch)),
                             bits(fresh.score(batch))),
              f"live = fresh at sync {syncs}")
    st = eng.stats()
    check(st["syncs_adopted"] == syncs, "every sync adopted")
    print(f"  {syncs} syncs, live = fresh bit-identical at each; hit_rate "
          f"{st['hit_rate']:.4f}; p50 {st['p50_us']:.1f} us, p99 "
          f"{st['p99_us']:.1f} us over {len(eng.latencies_us)} requests; "
          f"freshness_lag_steps {max_lag}; coalesced {chan.coalesced}; "
          f"invalidations {eng.cache.invalidations}")
    eng.close()
    return {"stats": st, "syncs": syncs, "max_lag": max_lag}


def checkpoint_phase(S, save_pytree, params, static) -> None:
    phase(6, "checkpoint round trip")
    ckpt_dir = WORK / "ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        save_pytree(str(ckpt_dir / "ckpt_00000007.npz"), params)
        src = S.StaticSource.from_checkpoint(str(ckpt_dir))
        check(src.snapshot().step == 7, "newest checkpoint step")
        eng = S.RecsysScoringEngine(src, config=S.ServingConfig(
            cache_capacity=CACHE))
        got = eng.score(static["probe"])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(np.array_equal(bits(got), bits(static["probe_scores"])),
          "checkpoint scores bit-identical")
    print("  restored engine scores bit-identical")


def reference_check(params, probe, hash_ids,
                    embedding_bag_ref) -> np.ndarray:
    """Reference scores of the probe: the plain lookup, then the tower in
    float64 on the host."""
    hashed = hash_ids(torch.from_numpy(probe), V)
    x = embedding_bag_ref(hashed.to(params["table"].table.device),
                          params["table"].table).cpu().double()
    n = len(MLP) + 1
    for i in range(n):
        x = x @ params["mlp"][f"w{i}"].cpu().double() \
            + params["mlp"][f"b{i}"].cpu().double()
        if i < n - 1:
            x = torch.relu(x)
    return torch.sigmoid(x[:, 0]).numpy()


def time_ms(fn, id_sets, table, cycles_per_ms, reps: int = TIMED_REPS
            ) -> tuple[float, float, bool]:
    """(device ms, host-paced ms, held) per call, from CUDA events around
    ``reps`` calls.  Host-paced: the calls are issued as fast as the
    host can, so a call the host issues slower than the device runs it
    reads as the host's time.  Device: a sleep kernel first holds the
    device for twice the host-paced loop, so every call is queued before
    the first one runs and the events see the device's time alone.
    ``held`` says whether the sleep outlasted the host's issuing of the
    held calls (if not, the events saw the host too)."""
    for i in range(10):
        fn(id_sets[i % len(id_sets)], table)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for hold_ms in (0.0, None):
        if hold_ms is None:
            hold_ms = 2 * out[0] * reps + 1.0
            torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        issued = time.perf_counter()
        start.record()
        for i in range(reps):
            fn(id_sets[i % len(id_sets)], table)
        end.record()
        issued = (time.perf_counter() - issued) * 1e3
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out[1], out[0], issued < hold_ms


def sleep_cycles_per_ms() -> float:
    """Clock rate that ``torch.cuda._sleep`` spins at."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def bound_ms(ids: torch.Tensor, table: torch.Tensor) -> tuple[float, str]:
    """Least time for this call: the row of each distinct valid id read
    once, the ids read once, the output written once, against one add per
    valid (bag, id) entry and element."""
    mask = (ids >= 0) & (ids < table.shape[0])
    rows = int(torch.unique(ids[mask]).numel())
    entries = int(mask.sum())
    d, item = table.shape[1], table.element_size()
    nbytes = rows * d * item + ids.numel() * 4 + ids.shape[0] * d * item
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = entries * d / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def device_busy(run, match: str = "") -> dict:
    """Device time of the kernels and copies that ``run()`` issues over its
    wall time, from a ``torch.profiler`` trace; with ``match``, also the
    device time and count of the kernels whose name contains it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return device_times(prof, wall_us, match)


def device_times(prof, wall_us: float, match: str = "", top_n: int = 6,
                 name_len: int = 60) -> dict:
    """Device time by kernel name (cut to ``name_len``) in a finished
    ``torch.profiler`` trace, over ``wall_us``: busy time, idle share, the
    ``top_n`` names, and the times of the kernels whose name contains
    ``match``."""
    from torch.autograd import DeviceType
    by_name: dict[str, float] = {}
    matched = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:name_len]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
            if match and match in e.name:
                matched.append(e.time_range.elapsed_us())
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    out = {"wall_us": wall_us, "device_busy_us": busy,
           "idle_share": (1 - busy / wall_us) if busy else None,
           "top_us": {k: v for k, v in top}}
    if match:
        out[f"{match}_us"] = matched
    return out


def _max_diff(a: dict, b: dict) -> dict:
    """Largest |a - b| of each leaf of two parameter dicts (b on the CPU)."""
    out = {}
    for k, v in a.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in
                        _max_diff(v, b[k]).items()})
        else:
            out[k] = (v.cpu().double() - b[k].double()).abs().max().item()
    return out


def _stats(st) -> dict:
    return {"applied_steps": st.applied_steps, "kept_slots": st.kept_slots,
            "dropped_slots": st.dropped_slots,
            "history_clamps": st.history_clamps,
            "embed_rows_rescued": st.embed_rows_rescued}


def _hold(name, card, host, loss_rtol) -> None:
    """The card's replay against the CPU's: ``last_update`` and the slot
    counts exact, the per-step losses within ``loss_rtol``."""
    (_, _, lu_c, st_c), (_, _, lu_h, st_h) = card, host
    check(torch.equal(lu_c.cpu(), lu_h), f"{name}: last_update equal")
    check(_stats(st_c) == _stats(st_h), f"{name}: ReplayStats equal: "
          f"{_stats(st_c)} vs {_stats(st_h)}")
    check(np.allclose(st_c.losses, st_h.losses, rtol=loss_rtol, atol=0),
          f"{name}: losses within rtol {loss_rtol}: {st_c.losses} vs "
          f"{st_h.losses}")


def replay_phase(T: dict, counters) -> dict:
    phase(7, "replay trainer: the quickstart at CRITEO_DEEPFM's full width")
    Q, cfg = T["quickstart"], T["CRITEO_DEEPFM"]
    host = T["init_recsys"](cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    card = T["tree_to_device"](host, torch.device("cuda"))
    stream = T["make_clickstream"](cfg, seed=0,
                                   batch_size=Q.SETUP.local_batch)
    sched = T["schedule_for_day"](Q.SETUP, Q.SPEC, Q.NUM_BATCHES)

    # the quickstart's first global steps of day 0, card against CPU
    head = T["Schedule"](sched.mode, sched.local_batch,
                         sched.steps[:HOLD_STEPS])
    runs = {}
    for dev, p in (("cuda", card), ("cpu", host)):
        tr = Q.make_trainer(cfg)
        runs[dev] = tr.replay(p, tr.optimizer.init(p), head, stream, 0)
    _hold("quickstart head", runs["cuda"], runs["cpu"], HOLD_LOSS_RTOL)
    head_diff = _max_diff(runs["cuda"][0], runs["cpu"][0])
    print(f"  first {HOLD_STEPS} quickstart steps, card vs CPU (Adam): "
          f"losses {runs['cuda'][3].losses} vs {runs['cpu'][3].losses}; "
          f"stats {_stats(runs['cuda'][3])} equal, last_update equal; "
          f"largest parameter difference {max(head_diff.values())!r} "
          f"({json.dumps(head_diff)})")

    # repro's tests/test_trainer.py:118-120: the GBA mask and the per-ID
    # rescue run (the quickstart drops no slot); SGD, iota 1
    slot = T["Slot"]
    stale = T["Schedule"]("gba", 32, [
        [slot(k * 3 + i, max(0, k - i), k, 1.0 if i < 2 else 0.0)
         for i in range(3)] for k in range(4)])
    stale_stream = T["make_clickstream"](cfg, seed=0, batches_per_day=16,
                                         batch_size=32)
    runs = {}
    for dev, p in (("cuda", card), ("cpu", host)):
        opt = T["get_optimizer"]("sgd", 0.05)
        runs[dev] = T["GBATrainer"](cfg, opt, iota=1).replay(
            p, opt.init(p), stale, stale_stream, 0)
    _hold("stale schedule", runs["cuda"], runs["cpu"], 1e-5)
    check(runs["cuda"][3].embed_rows_rescued > 0
          and runs["cuda"][3].dropped_slots > 0,
          "the stale schedule drops slots and rescues rows")
    stale_diff = _max_diff(runs["cuda"][0], runs["cpu"][0])
    for k, v in runs["cuda"][0].items():
        if not isinstance(v, dict):
            check(torch.allclose(v.cpu(), runs["cpu"][0][k],
                                 rtol=STALE_PARAM_RTOL,
                                 atol=STALE_PARAM_ATOL),
                  f"stale schedule: {k} within rtol {STALE_PARAM_RTOL} "
                  f"atol {STALE_PARAM_ATOL}")
    for k, v in runs["cuda"][0]["mlp"].items():
        check(torch.allclose(v.cpu(), runs["cpu"][0]["mlp"][k],
                             rtol=STALE_PARAM_RTOL, atol=STALE_PARAM_ATOL),
              f"stale schedule: mlp/{k} within tolerance")
    print(f"  stale schedule (4 steps x 3 slots, iota 1, SGD), card vs CPU: "
          f"stats {_stats(runs['cuda'][3])} equal, last_update equal, "
          f"parameters within rtol {STALE_PARAM_RTOL} atol "
          f"{STALE_PARAM_ATOL}; largest difference "
          f"{max(stale_diff.values())!r}")

    # the quickstart's 4 days: the counted path
    counters(reset=True)
    t0 = time.perf_counter()
    res = Q.run(card, cfg, days=QUICKSTART_DAYS,
                log=lambda line: print("  " + line))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counters()
    steps = sum(r.steps for r in res.rows)
    days = [{"day": r.day, "auc": r.auc, "qps": r.qps, "drops": r.drops,
             "steps": r.steps, "seconds": r.seconds,
             "data_s": r.stats.data_s, "step_s": r.stats.step_s,
             "eval_and_other_s": r.seconds - r.stats.data_s - r.stats.step_s,
             "stats": _stats(r.stats),
             "first_loss": r.stats.losses[0], "last_loss": r.stats.losses[-1]}
            for r in res.rows]
    for d in days:
        print(f"  day {d['day']}: {json.dumps(d)}")
    auc = res.rows[-1].auc
    print(f"  quickstart: {steps} global steps in {seconds:.2f} s; "
          f"launches {json.dumps(launches)}; last-day AUC {auc:.4f} "
          f"(JAX quickstart on the CPU: {JAX_QUICKSTART_AUC[-1]})")
    check(steps == 16 * QUICKSTART_DAYS, f"16 global steps a day: {steps}")
    check(launches["embedding_bag_grad"] == steps,
          "one embedding_bag_grad launch per global step")
    check(auc > 0.70, f"last-day AUC above 0.70: {auc}")
    check(abs(auc - JAX_QUICKSTART_AUC[-1]) <= 0.01,
          f"last-day AUC within 0.01 of the JAX quickstart's: {auc}")

    # device idle share over the first 4 global steps of the next day
    tr = Q.make_trainer(cfg)
    nxt = T["Schedule"](sched.mode, sched.local_batch, sched.steps[:4])
    busy = device_busy(lambda: tr.replay(
        res.params, tr.optimizer.init(res.params), nxt, stream,
        QUICKSTART_DAYS))
    print(f"  profile of 4 global steps: {json.dumps(busy)}")
    return {"days": days, "seconds": seconds, "launches": launches,
            "head_max_param_diff": max(head_diff.values()),
            "stale_max_param_diff": max(stale_diff.values()),
            "profile": busy}


def smoke_phase(T: dict, counters) -> dict:
    phase(8, f"sparse-module smoke: V={SMOKE_V} D={SMOKE_D} batch "
             f"{SMOKE_BATCH}, {SMOKE_STEPS} steps")
    seen = []

    def on_step(st):
        seen.append((st, counters()))

    counters(reset=True)
    losses = T["train"].run_embedding_smoke(
        SMOKE_V, steps=SMOKE_STEPS, embed_dim=SMOKE_D, batch=SMOKE_BATCH,
        lr=1e-3, device="cuda", on_step=on_step,
        log=lambda line: print("  " + line))
    torch.cuda.synchronize()
    launches = counters()
    check(all(np.isfinite(losses)), f"finite losses: {losses}")
    for i, (_, c) in enumerate(seen):
        check(c["embedding_bag"] == i + 1 and c["embedding_bag_grad"] == i + 1,
              f"step {i} launched each kernel once: {c}")
    # after the path's counts are read: the comparison launches count not
    grad_kernel = T["embedding_bag_grad"]
    for st, _ in seen:
        ref_gt, ref_cnt = T["embedding_bag_grad_ref"](
            st.ids.cpu(), st.pooled_grad.cpu(), SMOKE_V)
        gt, cnt = grad_kernel(st.ids, st.pooled_grad, SMOKE_V)
        zero = torch.zeros((SMOKE_V, SMOKE_D), device="cuda",
                           requires_grad=True)
        (auto,) = torch.autograd.grad(
            T["embedding_bag_ref"](st.ids, zero), zero, st.pooled_grad)
        torch.cuda.synchronize()
        check(torch.equal(st.table_grad.cpu().view(torch.int32),
                          ref_gt.view(torch.int32)),
              f"step {st.step}: table gradient bit-identical to the plain "
              f"version on a CPU copy")
        check(torch.equal(gt, st.table_grad) and torch.equal(cnt.cpu(),
                                                             ref_cnt),
              f"step {st.step}: counts exact")
        check(torch.allclose(st.table_grad, auto, rtol=1e-6, atol=0),
              f"step {st.step}: within rtol 1e-6 of autograd through "
              f"embedding_bag_ref")
        check(torch.allclose(st.pooled, T["embedding_bag_ref"](st.ids,
                                                               st.table),
                             rtol=1e-5, atol=1e-6),
              f"step {st.step}: pooled lookup within rtol 1e-5 atol 1e-6 "
              f"of embedding_bag_ref")
    print(f"  losses {losses}; launches {json.dumps(launches)}; each "
          f"step's pooled lookup within rtol 1e-5 atol 1e-6 of the plain "
          f"version, its table gradient bit-identical to the plain version, "
          f"counts exact, within rtol 1e-6 of autograd through the plain "
          f"lookup")
    return {"losses": losses, "launches": launches}


def same_params(layout, params: dict, flat: torch.Tensor) -> bool:
    """Whether every leaf of ``params`` is bit for bit ``flat``'s slice cast
    to the leaf's dtype, leaf by leaf (no whole copy of ``flat``)."""
    for leaf, o, n in zip(layout.leaves(params), layout.offsets,
                          layout.sizes):
        want = flat[o:o + n].view(leaf.shape).to(leaf.dtype)
        bits = torch.int16 if leaf.dtype == torch.bfloat16 else torch.int32
        if not torch.equal(leaf.view(bits), want.view(bits)):
            return False
    return True


def lm_batches(T: dict, vocab: int, seq: int, batch: int, n: int,
               device: str) -> list[dict]:
    stream = T["make_lm_stream"](vocab, seq, batch, seed=0)
    return [{k: torch.from_numpy(v).to(device)
             for k, v in stream.batch(i).items()} for i in range(n)]


def lm_phase(T: dict, counters) -> dict:
    phase(9, f"LM fused GBA step: granite-8b at full width, depth "
             f"{LM_LAYERS} (reduced from 36), {LM_MICROSTEPS} microsteps")
    cfg = dataclasses.replace(T["get_config"]("granite-8b"),
                              num_layers=LM_LAYERS)
    gba = T["GBAConfig"](local_batch=LM_BATCH, buffer_size=LM_M,
                         staleness_tolerance=LM_IOTA)
    t0 = time.perf_counter()
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    progs = T["build_programs"](cfg, gba, params=params, lr=LM_LR)
    del params
    layout = progs.layout
    check(layout.total == APPLY_N, f"flat params {layout.total} == "
          f"{APPLY_N}, the N of gba_apply case (i)")
    batches = lm_batches(T, cfg.vocab_size, LM_SEQ, LM_BATCH,
                         LM_MICROSTEPS + LM_M, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"  {cfg.name} depth {LM_LAYERS}: "
          f"{T['param_count'](progs.state['params']):,} params "
          f"(embed, lm_head, {LM_LAYERS} layers, final norm); flat buffer "
          f"({LM_M}, {layout.total}) f32; set-up {setup_s:.2f} s")

    # the counted path: 8 microsteps with the launcher's tokens i // M
    torch.cuda.reset_peak_memory_stats()
    state, rows = progs.state, []
    counters(reset=True)
    for i in range(LM_MICROSTEPS):
        buf = state["buffer"]
        applies = (buf["fill"] + 1) % LM_M == 0
        old_step = buf["step"]
        # what the in-place apply will read, copied before the step
        flat_before = layout.ravel(state["params"])
        accum_before = state["accum"].clone()
        launched = counters()["gba_apply"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        new, loss = progs.step(state, batches[i], i // LM_M)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launched = counters()["gba_apply"] - launched
        if applies:
            check(launched == 1, f"microstep {i + 1}: one gba_apply launch")
            want_p, want_a = T["gba_apply_ref"](
                flat_before, accum_before, new["buffer"]["grads"],
                new["buffer"]["tokens"], old_step, LM_LR, iota=LM_IOTA)
            check(same_params(layout, new["params"], want_p),
                  f"microstep {i + 1}: params bit-identical to gba_apply_ref "
                  f"on copies of the pre-apply tensors")
            check(torch.equal(new["accum"].view(torch.int32),
                              want_a.view(torch.int32)),
                  f"microstep {i + 1}: accumulator bit-identical to "
                  f"gba_apply_ref")
            del want_p, want_a
        else:
            check(launched == 0, f"microstep {i + 1}: no gba_apply launch")
            check(new["params"] is state["params"]
                  and same_params(layout, new["params"], flat_before)
                  and torch.equal(new["accum"].view(torch.int32),
                                  accum_before.view(torch.int32)),
                  f"microstep {i + 1}: params and accumulator bit-identical")
        del flat_before, accum_before
        state = new
        rows.append({"microstep": i + 1, "loss": loss.item(),
                     "seconds": seconds, "gba_apply": launched,
                     "gstep": state["buffer"]["step"]})
        print(f"  {json.dumps(rows[-1])}")
    torch.cuda.synchronize()
    launches = counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in rows]
    check(launches["gba_apply"] == 2 and [r["microstep"] for r in rows
                                          if r["gba_apply"]] == [4, 8],
          f"gba_apply launched at microsteps 4 and 8 alone: {rows}")
    check(all(np.isfinite(losses)), f"finite losses: {losses}")
    check(state["buffer"]["step"] == 2, "2 global steps")
    print(f"  launches {json.dumps(launches)}; peak device memory "
          f"{peak_gb:.2f} GB (with the checks' copies)")

    # a third global step under the profiler: the apply's device time and
    # the idle share of one global step
    def global_step():
        nonlocal state
        for i in range(LM_MICROSTEPS, LM_MICROSTEPS + LM_M):
            state, _ = progs.step(state, batches[i], i // LM_M)
    torch.cuda.reset_peak_memory_stats()
    busy = device_busy(global_step, match="gba_apply")
    path_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  profile of one global step ({LM_M} microsteps): "
          f"{json.dumps(busy)}; peak device memory of that global step "
          f"alone {path_peak_gb:.2f} GB")
    check(len(busy["gba_apply_us"]) == 1, "one gba_apply in the profile")
    del state, progs, batches
    torch.cuda.empty_cache()
    hold = lm_card_vs_cpu(T)
    return {"config": {"arch": cfg.name, "num_layers": LM_LAYERS,
                       "reduced": "num_layers 36 -> 2", "d_model": cfg.d_model,
                       "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                       "batch": LM_BATCH, "seq": LM_SEQ, "M": LM_M,
                       "iota": LM_IOTA, "lr": LM_LR, "N": APPLY_N},
            "setup_s": setup_s, "microsteps": rows, "launches": launches,
            "peak_memory_gb": peak_gb, "path_peak_memory_gb": path_peak_gb,
            "profile": busy,
            "apply_device_ms": busy["gba_apply_us"][0] / 1e3,
            "card_vs_cpu": hold}


def lm_card_vs_cpu(T: dict) -> dict:
    """``granite-8b.reduced()`` in float32, 2 global steps from the same
    initial params on the card and on the CPU, one slot stale."""
    cfg = dataclasses.replace(T["get_config"]("granite-8b").reduced(),
                              dtype="float32")
    gba = T["GBAConfig"](local_batch=2, buffer_size=LM_M,
                         staleness_tolerance=LM_IOTA)
    host = T["init_model"](cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = [i // LM_M for i in range(2 * LM_M)]
    tokens[LM_M + 1] = -5                     # 6 steps old at the 2nd apply
    runs = {}
    for dev in ("cuda", "cpu"):
        progs = T["build_programs"](cfg, gba, params=T["tree_to_device"](
            host, torch.device(dev)), lr=LM_LR)
        state, losses = progs.state, []
        for i, b in enumerate(lm_batches(T, cfg.vocab_size, 32, 2,
                                         len(tokens), dev)):
            state, loss = progs.step(state, b, tokens[i])
            losses.append(loss.item())
        runs[dev] = (losses, progs.layout.ravel(state["params"]).cpu(),
                     state["accum"].cpu(), state["buffer"]["tokens"].cpu())
    (lc, pc, ac, tc), (lh, ph, ah, th) = runs["cuda"], runs["cpu"]
    check(torch.equal(tc, th), "card vs CPU: tokens equal")
    check(np.allclose(lc, lh, rtol=HOLD_LM_RTOL, atol=0),
          f"card vs CPU: losses within rtol {HOLD_LM_RTOL}: {lc} vs {lh}")
    for name, a, b in (("flat params", pc, ph), ("accumulator", ac, ah)):
        check(torch.allclose(a, b, rtol=HOLD_LM_RTOL, atol=HOLD_LM_ATOL),
              f"card vs CPU: {name} within rtol {HOLD_LM_RTOL} atol "
              f"{HOLD_LM_ATOL}")
    out = {"losses_card": lc, "losses_cpu": lh,
           "max_param_diff": (pc - ph).abs().max().item(),
           "max_accum_diff": (ac - ah).abs().max().item()}
    print(f"  {cfg.name} f32, 2 global steps, card vs CPU: {json.dumps(out)}")
    return out


def grad_bound_ms(ids: torch.Tensor, grad: torch.Tensor,
                  cap: int) -> tuple[float, str]:
    """Least time for one ``embedding_bag_grad``: the (V, D) table gradient
    and the (V,) counts written once, the ids and grad_out read once,
    against one add per valid entry and element, and one per count."""
    d = grad.shape[1]
    valid = int(((ids >= 0) & (ids < cap)).sum())
    nbytes = cap * d * 4 + cap * 4 + ids.numel() * 4 + grad.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = valid * (d + 1) / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def launch_floor(cycles_per_ms: float) -> dict:
    """The per-call floor of a held queue: ``TIMED_REPS`` held calls of
    ``torch.cuda._sleep(0)``, which does nothing, under :func:`time_ms`,
    median of 3 runs."""
    runs = [time_ms(lambda _i, _t: torch.cuda._sleep(0), [None], None,
                    cycles_per_ms) for _ in range(3)]
    row = {"ms": float(np.median([r[0] for r in runs])),
           "device_runs_ms": [r[0] for r in runs],
           "held": all(r[2] for r in runs)}
    print(f"  launch floor of a held queue ({TIMED_REPS} held calls of "
          f"torch.cuda._sleep(0)): {row['ms']!r} ms per call; runs "
          f"{json.dumps(row['device_runs_ms'])}, held {row['held']}")
    return row


def grad_timing(T: dict, cycles_per_ms: float) -> list[dict]:
    """``embedding_bag_grad`` at the training paths' shapes: (a) the
    presence counts of a quickstart global step, over the 16 steps of day
    0; (b) the sparse smoke's backward, over 16 draws."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cpu_gen = torch.Generator().manual_seed(11)
    shapes = [("(a)", T["presence"], torch.zeros((1, 0), device="cuda"),
               T["presence_capacity"]),
              ("(b)", [smoke_ids(T["hash_ids"], cpu_gen, SMOKE_BATCH)
                       for _ in range(TIMED_ID_SETS)],
               torch.randn((SMOKE_BATCH, SMOKE_D), generator=gen,
                           device="cuda"), SMOKE_V)]
    return segment_sum_timing(T, "embedding_bag_grad", shapes, cycles_per_ms)


def segment_sum_timing(T: dict, name: str, shapes: list,
                       cycles_per_ms: float,
                       lib_atol: float = 0.0) -> list[dict]:
    """Kernel ``name`` (``embedding_bag_grad`` or
    ``embedding_bag_grad_resident``) at each ``(label, id_sets, grad_out,
    capacity)`` of ``shapes``: the kernel's launch (on sorted ids; for
    ``embedding_bag_grad`` at D = 0 the sort-free counts launch on the raw
    ids), the
    whole call (the wrapper, with its sort where it sorts), the plain
    version and a library call (``torch.bincount`` for D = 0, else
    ``F.embedding_bag``'s backward into a dense weight, held to the kernel
    within rtol 1e-6 and ``lib_atol``), with device-held CUDA events
    around ``SEGMENT_REPS`` calls, in turns, median of 3 runs."""
    F_ = torch.nn.functional
    grad_kernel, ref = T[name], T["embedding_bag_grad_ref"]
    sort_ids, launch = T["sort_ids"], T[f"{name}_sorted"]
    rows = []
    for label, id_sets, grad, cap in shapes:
        f = id_sets[0].shape[1]
        design = None
        if name == "embedding_bag_grad":
            design = T["device_grad_plan"](torch.cuda.current_device(), cap,
                                           grad.shape[1])[0]
        if design == "counts":
            counts = T["embedding_bag_grad_counts"]
            kernel = (lambda i, g, cap=cap: counts(i, cap), id_sets)
        else:
            sorted_sets = [sort_ids(i, cap) for i in id_sets]
            kernel = (lambda s, g, cap=cap, f=f: launch(s[0], s[1], g, cap,
                                                        f), sorted_sets)
        if grad.shape[1] == 0:
            lib_sets = [i.reshape(-1).long() for i in id_sets]

            def library(i, g, cap=cap):
                return torch.bincount(i, minlength=cap)
            want = library(lib_sets[0], grad)
            check(torch.equal(grad_kernel(id_sets[0], grad, cap)[1],
                              want.float()), f"{label}: bincount agrees")
            lib_name = "torch.bincount"
        else:
            weight = torch.zeros((cap, grad.shape[1]), device="cuda",
                                 requires_grad=True)
            lib_sets = [F_.embedding_bag(i, weight, mode="sum")
                        for i in id_sets]

            def library(out, g, weight=weight):
                return torch.autograd.grad(out, weight, g,
                                           retain_graph=True)
            check(torch.allclose(library(lib_sets[0], grad)[0],
                                 grad_kernel(id_sets[0], grad, cap)[0],
                                 rtol=1e-6, atol=lib_atol),
                  f"{label}: F.embedding_bag backward agrees")
            lib_name = "F.embedding_bag backward"
        fns = {
            "kernel": kernel,
            "wrapper": (lambda i, g, cap=cap: grad_kernel(i, g, cap),
                        id_sets),
            "plain": (lambda i, g, cap=cap: ref(i, g, cap), id_sets),
            "library": (library, lib_sets),
        }
        dev = {k: [] for k in fns}
        host = {k: [] for k in fns}
        sleep_held = {k: True for k in fns}
        for _ in range(3):                      # in turns, median of 3
            for k, (fn, sets) in fns.items():
                d, h, ok = time_ms(fn, sets, grad, cycles_per_ms,
                                   SEGMENT_REPS)
                dev[k].append(d)
                host[k].append(h)
                sleep_held[k] = sleep_held[k] and ok
        med = {k: float(np.median(v)) for k, v in dev.items()}
        bnd, by = grad_bound_ms(id_sets[0], grad, cap)
        row = {"shape": [*id_sets[0].shape, cap, grad.shape[1]],
               "ms": med["kernel"], "wrapper_ms": med["wrapper"],
               "plain_ms": med["plain"], "library_ms": med["library"],
               "library": lib_name, "bound_ms": bnd, "bound_by": by,
               "device_runs_ms": dev, "sleep_held": sleep_held,
               "host_paced_ms": {k: float(np.median(v))
                                 for k, v in host.items()}}
        if design:
            row["design"] = design
        rows.append(row)
        kernel_label = ("kernel (counts, raw ids, no sort)"
                        if design == "counts" else "kernel (sorted ids)")
        print(f"  {name} {label} ids {tuple(id_sets[0].shape)} "
              f"over V={cap} D={grad.shape[1]}, device ms per call: "
              f"{kernel_label} {med['kernel']!r}"
              f", whole call {med['wrapper']!r}, plain {med['plain']!r}, "
              f"{lib_name} {med['library']!r}, bound {bnd!r} ({by}); "
              f"host-paced ms per call: {json.dumps(row['host_paced_ms'])}; "
              f"device runs: {json.dumps(dev)}")
        earlier = EARLIER_MS.get((name, label))
        if earlier:
            print(f"    earlier design: {json.dumps(earlier)}")
        for k, ok in sleep_held.items():
            if not ok:
                print(f"    {k}: the sleep did not outlast the host's issuing"
                      f" of the held calls, so its device ms include the "
                      f"host's pace")
    return rows


def apply_bound_ms(m: int, n: int, param_item: int, buf_item: int
                   ) -> tuple[float, str]:
    """Least time for one ``gba_apply``: the M buffer rows, the param and
    the accumulator read once, param and accumulator written once, and the
    tokens read, against 2M + 7 float32 operations a column (the weighted
    sum, g * g and its add, lr * g, the root, + eps, the divide, the
    subtract).  Every slot is read, kept or not: a stale slot's 0 weight
    times its values is part of the function (0 * inf is NaN)."""
    nbytes = m * n * buf_item + 2 * n * param_item + 2 * n * 4 + m * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * (2 * m + 7) / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def time_calls(fn, reps: int, cycles_per_ms: float | None = None
               ) -> tuple[float, bool]:
    """(device ms per call of ``fn()``, held) from CUDA events around
    ``reps`` calls, after 2 warm-up calls.  Each call moves gigabytes, far
    more than the host needs to issue it, so the events see the device's
    time.  With ``cycles_per_ms``, a sleep kernel first holds the device
    for twice the host's time to issue the calls, so that a call the host
    issues nearly as slowly as the device runs it is still timed alone;
    ``held`` says whether a sleep outlasted the issuing (False without
    one)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_ms = 0.0
    if cycles_per_ms is not None:
        t0 = time.perf_counter()
        fn()
        hold_ms = 2 * reps * (time.perf_counter() - t0) * 1e3 + 1.0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
    issued = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    issued = (time.perf_counter() - issued) * 1e3
    end.synchronize()
    return start.elapsed_time(end) / reps, issued < hold_ms


def apply_timing(T: dict) -> dict:
    """``gba_apply`` at the LM step's apply, case (i): M = 4, N =
    838,881,280, float32, all slots fresh, against its plain version, in
    turns, median of 3 runs of 10 calls.  No single PyTorch call computes
    the decayed aggregate and the Adagrad update, so there is no library
    time."""
    param, accum, buffer, tokens, step = apply_inputs(LM_M, APPLY_N,
                                                      [0] * LM_M)
    fns = {
        "kernel": lambda: T["gba_apply"](param, accum, buffer, tokens, step,
                                         LM_LR, iota=LM_IOTA),
        "plain": lambda: T["gba_apply_ref"](param, accum, buffer, tokens,
                                            step, LM_LR, iota=LM_IOTA),
    }
    runs = {k: [] for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            runs[k].append(time_calls(fn, 10)[0])
    med = {k: float(np.median(v)) for k, v in runs.items()}
    bnd, by = apply_bound_ms(LM_M, APPLY_N, 4, 4)
    row = {"shape": [LM_M, APPLY_N], "dtypes": "f32 param/accum/buffer",
           "ms": med["kernel"], "plain_ms": med["plain"], "library_ms": None,
           "library": None, "bound_ms": bnd, "bound_by": by,
           "device_runs_ms": runs}
    print(f"  gba_apply (i) M={LM_M} N={APPLY_N} f32, device ms per call: "
          f"kernel {med['kernel']!r}, plain {med['plain']!r}, library none, "
          f"bound {bnd!r} ({by}); device runs: {json.dumps(runs)}")
    del param, accum, buffer
    torch.cuda.empty_cache()
    return row


def timing_phase(embedding_bag, embedding_bag_ref, big, gen, static, S,
                 params) -> dict:
    phase(10, "timing")
    lib = torch.nn.functional.embedding_bag
    fns = {"kernel": embedding_bag, "plain": embedding_bag_ref,
           "library": lambda i, t: lib(i, t, mode="sum")}
    cycles_per_ms = sleep_cycles_per_ms()
    shapes = []
    for b, f in TIMED_SHAPES:
        id_sets = [torch.randint(0, V, (b, f), generator=gen,
                                 device=big.device, dtype=torch.int32)
                   for _ in range(TIMED_ID_SETS)]
        check(torch.allclose(embedding_bag(id_sets[0], big),
                             fns["library"](id_sets[0], big),
                             rtol=1e-5, atol=1e-6), "library call agrees")
        dev = {k: [] for k in fns}
        host = {k: [] for k in fns}
        for _ in range(3):                      # in turns, median of 3
            for k, fn in fns.items():
                d, h, _ = time_ms(fn, id_sets, big, cycles_per_ms)
                dev[k].append(d)
                host[k].append(h)
        med = {k: float(np.median(v)) for k, v in dev.items()}
        bnd, by = bound_ms(id_sets[0], big)
        row = {"shape": [b, f], "ms": med["kernel"],
               "plain_ms": med["plain"], "library_ms": med["library"],
               "bound_ms": bnd, "bound_by": by, "device_runs_ms": dev,
               "host_paced_ms": {k: float(np.median(v))
                                 for k, v in host.items()}}
        shapes.append(row)
        print(f"  ({b}, {f}) over ({V}, {DIM}) f32, device ms per call: "
              f"kernel {med['kernel']!r}, plain {med['plain']!r}, "
              f"F.embedding_bag {med['library']!r}, bound {bnd!r} ({by}); "
              f"host-paced ms per call: {json.dumps(row['host_paced_ms'])}"
              f"; device runs: {json.dumps(dev)}")

    # score latency at steady state: the static engine of phase 4 (cache
    # warm) and a cache-less engine (every request launches the kernel)
    rng = np.random.default_rng(3)
    hot = np.arange(HOT, dtype=np.int64)
    lat = {}
    nocache = S.RecsysScoringEngine(S.StaticSource(params),
                                    config=S.ServingConfig(cache_capacity=0))
    for name, eng in (("cached", static["engine"]), ("no_cache", nocache)):
        eng.latencies_us.clear()
        eng.stages_us.clear()
        for _ in range(LATENCY_BATCHES):
            eng.score(hot_batch(rng, hot))
        us = np.asarray(eng.latencies_us)
        stages = np.median(np.asarray(eng.stages_us), axis=0)
        batches = [hot_batch(rng, hot) for _ in range(256)]
        lat[name] = {"n": int(us.size),
                     "p50_us": float(np.percentile(us, 50)),
                     "p90_us": float(np.percentile(us, 90)),
                     "p99_us": float(np.percentile(us, 99)),
                     "hit_rate": eng.stats()["hit_rate"],
                     "stages_p50_us": dict(zip(
                         ("hash", "lookup", "tower"), stages.tolist())),
                     "profile": device_busy(
                         lambda: [eng.score(raw) for raw in batches])}
        print(f"  score latency, {name}: {json.dumps(lat[name])}")
    return {"shapes": shapes, "latency": lat}


# ---------------------------------------------------------------------------
# phase 11: the worker-parallel wire step
# ---------------------------------------------------------------------------

def _bits_of(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


class Holds:
    """While ``active``, each ``ops.quantize_wire``, ``ops.dequantize_wire``
    and ``ops.gba_apply_flat`` call of the wire step is held bit for bit
    against its plain version on the card, run on clones of its inputs
    taken before the launch; every layout seen is recorded."""

    def __init__(self, T: dict):
        self.T, self.ops = T, T["ops"]
        self.real = {k: getattr(self.ops, k) for k in
                     ("quantize_wire", "dequantize_wire", "gba_apply_flat")}
        self.active, self.seen, self.max_err = False, [], {}

    def __enter__(self):
        self.ops.quantize_wire = self.quantize
        self.ops.dequantize_wire = self.dequantize
        self.ops.gba_apply_flat = self.apply
        return self

    def __exit__(self, *exc):
        for k, fn in self.real.items():
            setattr(self.ops, k, fn)

    def _held(self, name, shape, pairs):
        err = 0.0
        for what, got, want in pairs:
            ok = got.shape == want.shape and torch.equal(_bits_of(got),
                                                         _bits_of(want))
            check(ok, f"{name} {tuple(shape)}: {what} bit-identical to the "
                      f"plain version")
            err = max(err, _max_abs(got, want))
        self.max_err[name] = max(self.max_err.get(name, 0.0), err)
        self.seen.append((name, tuple(shape)))

    def quantize(self, x, *, tile, mode):
        if not self.active:
            return self.real["quantize_wire"](x, tile=tile, mode=mode)
        before = x.clone()
        out = self.real["quantize_wire"](x, tile=tile, mode=mode)
        ref = self.T["quantize_minmax_ref" if mode == "minmax" else
                     "quantize_sign_ref"](before, tile)
        names = ("codes", "scale", "zero")[:len(out)] + ("residual",)
        self._held(f"quantize_{mode}", x.shape,
                   zip(names, (*out, x), ref))
        return out

    def dequantize(self, q, *sides, tile, mode, out):
        if not self.active:
            return self.real["dequantize_wire"](q, *sides, tile=tile,
                                                mode=mode, out=out)
        q0, sides0 = q.clone(), [s.clone() for s in sides]
        self.real["dequantize_wire"](q, *sides, tile=tile, mode=mode,
                                     out=out)
        zero = sides0[1] if mode == "minmax" else None
        ref = self.T["dequantize_ref"](q0, sides0[0], zero, tile, mode)
        self._held("dequantize", q.shape, [("output", out, ref)])
        return out

    def apply(self, param, accum, buf, tokens, step, lr, *, iota):
        if not self.active:
            return self.real["gba_apply_flat"](param, accum, buf, tokens,
                                               step, lr, iota=iota)
        p0, a0, b0 = param.clone(), accum.clone(), buf.clone()
        self.real["gba_apply_flat"](param, accum, buf, tokens, step, lr,
                                    iota=iota)
        want_p, want_a = self.T["gba_apply_ref"](p0, a0, b0, tokens, step,
                                                 lr, iota=iota)
        self._held("gba_apply", buf.shape, [("param", param, want_p),
                                            ("accum", accum, want_a)])
        return param, accum


class StepProfile:
    """A ``torch.profiler`` trace from ``start()`` to ``stop()``, read as
    ``device_busy`` reads its own."""

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - self.t0) * 1e6
        self.prof.__exit__(None, None, None)
        out = device_times(self.prof, wall_us, top_n=12, name_len=160)
        # the same device time by the PyTorch operator that launched it
        ops = sorted(((e.key, getattr(e, "self_device_time_total", 0.0),
                       e.count) for e in self.prof.key_averages()
                      if e.key.startswith("aten::")), key=lambda t: -t[1])
        out["aten_self_device_us"] = {k: [t, n] for k, t, n in ops[:12]}
        return out


def wire_run(T: dict, cfg, scheme: str, params: dict, device: str,
             counters, holds: Holds | None = None, hold_step: int = 0,
             warm_ref=None, profile: bool = False) -> dict:
    """One ``run_wire_train`` of ``WIRE_STEPS`` global steps; ``on_step``
    reads the launches and seconds of each step, snapshots params and
    accumulator after the warmup, turns ``holds`` on for global step
    ``hold_step`` and profiles the last one.  The peak device memory of
    the path is that of the set-up and step 0 and of the steps after the
    held one, without the holds' copies."""
    quant = T["quantize_minmax" if scheme == "int8" else "quantize_sign"]
    rows, marks = [], {}
    prof = StepProfile() if profile else None
    on_card = device == "cuda"

    def launches() -> tuple:
        return (quant.launches if scheme != "none" else 0,
                T["dequantize"].launches, T["gba_apply"].launches)

    def on_step(i, progs):
        if on_card:
            torch.cuda.synchronize()
        now, n = time.perf_counter(), launches()
        lay = progs.layout
        marks["geometry"] = {"shard_size": lay.shard_size,
                             "groups": list(lay.group_keys),
                             "bounds": [lay.group_shard_bounds(g) for g in
                                        range(lay.num_groups)]}
        rows.append({"step": i, "seconds": now - marks["t"],
                     "quantize": n[0] - marks["n"][0],
                     "dequantize": n[1] - marks["n"][1],
                     "gba_apply": n[2] - marks["n"][2]})
        if i == 0:
            marks["first_peak_gb"] = (torch.cuda.max_memory_allocated()
                                      / 1e9 if on_card else None)
        if i == WIRE_WARMUP - 1:          # after the float32 warmup
            st, wire = progs.state, progs.wire_state or {}
            snap = {k: st[k].to("cpu", copy=True)
                    for k in ("param_flat", "accum")}
            if warm_ref is not None:
                for k, v in snap.items():
                    check(torch.equal(v.view(torch.int32),
                                      warm_ref[k].view(torch.int32)),
                          f"{scheme}: {k} after the warmup bit-identical to "
                          f"the uncompressed run")
            if "residual" in wire:
                check(not wire["residual"].any().item(),
                      f"{scheme}: residual all zero after the warmup")
            if "momentum" in wire:
                check(wire["momentum"].abs().max().item() > 0,
                      f"{scheme}: momentum nonzero after the warmup")
            marks["warm"] = snap
        if holds is not None:
            holds.active = i + 1 == hold_step
        if i == hold_step and on_card:
            torch.cuda.reset_peak_memory_stats()
        if i == WIRE_STEPS - 2 and prof is not None:
            prof.start()
        if i == WIRE_STEPS - 1 and prof is not None:
            marks["profile"] = prof.stop()
        if on_card:
            torch.cuda.synchronize()
        marks["t"], marks["n"] = time.perf_counter(), launches()

    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counters(reset=True)
    marks["t"], marks["n"] = time.perf_counter(), launches()
    losses = T["run_wire_train"](
        cfg, workers=WIRE_W, scheme=scheme, steps=WIRE_STEPS, batch=LM_BATCH,
        seq=LM_SEQ, iota=LM_IOTA, lr=LM_LR, compress_warmup=WIRE_WARMUP,
        device=device, params=params, on_step=on_step)
    if on_card:
        torch.cuda.synchronize()
    counts = counters()
    return {"scheme": scheme, "losses": losses, "steps": rows,
            "launches": counts, "warm": marks["warm"],
            "geometry": marks["geometry"],
            "first_peak_gb": marks.get("first_peak_gb"),
            "last_peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                             if on_card else None),
            "profile": marks.get("profile")}


def wire_phase(T: dict, counters) -> dict:
    phase(11, f"worker-parallel wire step: granite-8b at full width, depth "
              f"{LM_LAYERS}, {WIRE_W} workers, {WIRE_STEPS} global steps "
              f"({WIRE_WARMUP} float32 warmup) per scheme")
    cfg = dataclasses.replace(T["get_config"]("granite-8b"),
                              num_layers=LM_LAYERS)
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    runs, launches, warm_ref = {}, {}, None
    holds = Holds(T)
    with holds:
        for scheme in ("none", "int8", "onebit"):
            # hold an uncompressed step of "none" and the first
            # compressed step of the lossy schemes
            run = wire_run(T, cfg, scheme, params, "cuda", counters,
                           holds=holds, hold_step=(
                               1 if scheme == "none" else WIRE_WARMUP),
                           warm_ref=warm_ref, profile=scheme != "none")
            warm = run.pop("warm")
            if scheme == "none":
                warm_ref = warm
            del warm
            groups = len(run["geometry"]["groups"])
            warm_n = (0, 0, WIRE_W)
            comp_n = ((WIRE_W * groups, WIRE_W * groups, WIRE_W)
                      if scheme != "none" else warm_n)
            got = [(r["quantize"], r["dequantize"], r["gba_apply"])
                   for r in run["steps"]]
            check(got == [warm_n] * WIRE_WARMUP
                  + [comp_n] * (WIRE_STEPS - WIRE_WARMUP),
                  f"{scheme}: launches (quantize, dequantize, gba_apply) per "
                  f"global step {got}")
            check(all(np.isfinite(run["losses"])), f"{scheme}: finite losses")
            run["path_peak_gb"] = max(run["first_peak_gb"],
                                      run["last_peak_gb"])
            check(run["path_peak_gb"] < WIRE_PEAK_GB,
                  f"{scheme}: peak device memory {run['path_peak_gb']:.2f} "
                  f"GB < {WIRE_PEAK_GB} GB")
            launches[scheme] = run["launches"]
            runs[scheme] = run
            print(f"  {scheme}: {json.dumps(run)}")
    del warm_ref
    summary = {k: {"step_s": r["steps"][-1]["seconds"],
                   "warm_step_s": (r["steps"][WIRE_WARMUP - 1]["seconds"]
                                   if k != "none" else None),
                   "path_peak_gb": r["path_peak_gb"],
                   "idle_share": (r["profile"] or {}).get("idle_share")}
               for k, r in runs.items()}
    print(f"  seconds per global step ({WIRE_W} workers' microsteps and the "
          f"shards' applies), the last step of each scheme and a warmup "
          f"step: {json.dumps(summary)}")
    seen = sorted(set(holds.seen))
    print(f"  held bit for bit (an uncompressed step of none, the first "
          f"compressed step of int8 and onebit): "
          f"{json.dumps(seen)}; max abs err {json.dumps(holds.max_err)}")
    for name in ("quantize_minmax", "quantize_sign", "dequantize",
                 "gba_apply"):
        check(any(n == name for n, _ in seen), f"{name} held")
    del params
    torch.cuda.empty_cache()
    hold = wire_card_vs_cpu(T, counters)
    timing = wire_timing(T, runs["int8"]["geometry"])
    return {"config": {"arch": cfg.name, "num_layers": LM_LAYERS,
                       "reduced": "num_layers 36 -> 2", "workers": WIRE_W,
                       "batch": LM_BATCH, "seq": LM_SEQ, "iota": LM_IOTA,
                       "lr": LM_LR, "tile": 2048, "steps": WIRE_STEPS,
                       "warmup": WIRE_WARMUP},
            "runs": runs, "summary": summary, "launches": launches,
            "held": seen,
            "max_abs_err": holds.max_err, "card_vs_cpu": hold,
            "timing": timing}


def _scaled(mode: str, x: torch.Tensor, out: tuple, tile: int
            ) -> torch.Tensor:
    """The payload in quantization steps, per element: minmax ``(x -
    zero) / scale``, whose codes round it; sign ``x / scale``, whose
    boundary is 0."""
    scale = out[1].repeat_interleave(tile, dim=1)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    if mode == "minmax":
        return (x - out[2].repeat_interleave(tile, dim=1)) / scale
    return x / scale


def _flips(card: list, host: list, per_step: int) -> dict:
    """Codes of each quantize launch, card against CPU.  At the first
    compressed step every differing code must sit at a rounding boundary
    (``WIRE_FLIP_NEAR``); later steps carry the first step's differences
    on in their residuals, so their flips are counted only."""
    steps, near, apart = [], 0.0, 0
    for k, (a, b) in enumerate(zip(card, host)):
        if k % per_step == 0:
            steps.append(0)
        diff = (a["out"][0].int() - b["out"][0].int()).abs()
        flip = diff > 0
        steps[-1] += int(flip.sum())
        if k >= per_step or not flip.any():
            continue
        mode, tile = a["mode"], a["tile"]
        ua = _scaled(mode, a["x"], a["out"], tile)[flip]
        ub = _scaled(mode, b["x"], b["out"], tile)[flip]
        if mode == "minmax":
            apart = max(apart, int(diff.max()))
            gap = (ua - ub).abs()
        else:
            gap = torch.maximum(ua.abs(), ub.abs())
        near = max(near, float(gap.max()))
    return {"flips_by_step": steps, "first_step_max_code_diff": apart,
            "first_step_max_steps_from_boundary": near}


def wire_card_vs_cpu(T: dict, counters, arch: str = "granite-8b",
                     schemes: tuple = ("none", "int8", "onebit")) -> dict:
    """``arch``'s ``.reduced()`` in float32, ``WIRE_STEPS`` global steps of
    each scheme from the same params, card against CPU: every code of
    every quantize launch compared (``_flips``), losses within
    ``WIRE_HOLD_RTOL``; each scheme's card run's launches a step kept."""
    cfg = dataclasses.replace(T["get_config"](arch).reduced(),
                              dtype="float32")
    host = T["init_model"](cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    ops, out = T["ops"], {}
    # what the CPU side's float32 sum orders depend on
    cpu = {"capability": torch.backends.cpu.get_cpu_capability(),
           "threads": torch.get_num_threads()}
    for scheme in schemes:
        seen, losses = {}, {}
        for dev in ("cuda", "cpu"):
            rec = seen[dev] = []
            real = ops.quantize_wire

            def tap(x, *, tile, mode, rec=rec, real=real):
                before = x.to("cpu", copy=True)
                got = real(x, tile=tile, mode=mode)
                rec.append({"mode": mode, "tile": tile, "x": before,
                            "out": [t.cpu() for t in got]})
                return got
            ops.quantize_wire = tap
            try:
                run = wire_run(T, cfg, scheme, T["tree_to_device"](
                    host, torch.device(dev)), dev, counters)
            finally:
                ops.quantize_wire = real
            losses[dev] = run["losses"]
            if dev == "cuda":
                steps, groups = run["steps"], run["geometry"]["groups"]
        card, cpu_rec = seen["cuda"], seen["cpu"]
        check(len(card) == len(cpu_rec),
              f"{scheme}: as many quantize launches on the card as on the CPU")
        flips = _flips(card, cpu_rec,
                       len(card) // (WIRE_STEPS - WIRE_WARMUP) or 1)
        check(flips["first_step_max_code_diff"] <= 1,
              f"{scheme}: minmax codes card vs CPU at most one apart at the "
              f"first compressed step")
        check(flips["first_step_max_steps_from_boundary"] <= WIRE_FLIP_NEAR,
              f"{scheme}: every code that differs card vs CPU at the first "
              f"compressed step lies within {WIRE_FLIP_NEAR} quantization "
              f"steps of a rounding boundary: {flips}")
        check(np.allclose(losses["cuda"], losses["cpu"], rtol=WIRE_HOLD_RTOL,
                          atol=0),
              f"{scheme}: losses card vs CPU within rtol {WIRE_HOLD_RTOL}: "
              f"{losses}")
        out[scheme] = {"losses_card": losses["cuda"],
                       "losses_cpu": losses["cpu"],
                       "code_flips": sum(flips["flips_by_step"]), **flips,
                       "codes": sum(r["out"][0].numel() for r in card),
                       "cpu": cpu, "card_steps": steps, "groups": groups}
        del seen, card, cpu_rec
        print(f"  {cfg.name} f32 card vs CPU, {scheme}: "
              f"{json.dumps(out[scheme])}")
    return out


def wire_bound_ms(kind: str, r: int, c: int, tile: int
                  ) -> tuple[float, str]:
    """Least time for one launch on an (r, c) view: the payload read and
    the codes and residual written once (quantize), or the codes read and
    the output written once (dequantize), with the per-tile sidebands;
    against the float operations an element needs (minmax quantize: 2
    compares, subtract, divide, round, 2 clamps, fma, subtract; sign: abs,
    a float64 add, compare, multiply, subtract; dequantize: add and fma, or
    one multiply)."""
    n, nt = r * c, r * (c // tile)
    nbytes, f32_ops, f64_ops = {
        "quantize_minmax": (n * 9 + 2 * nt * 4, 11 * n, 0),
        "quantize_sign": (n * 9 + nt * 4, 4 * n, n),
        "dequantize_minmax": (n * 5 + 2 * nt * 4, 3 * n, 0),
        "dequantize_sign": (n * 5 + nt * 4, n, 0),
    }[kind]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def wire_timing(T: dict, geometry: dict) -> dict:
    """Each wire kernel and its plain version at the path's largest launch:
    group ``blocks.l0``'s (W, group_shard) columns of a worker's residual
    row (quantize) and of a shard's routed codes into its (M, shard_size)
    block (dequantize), with CUDA events, in turns, median of 3 runs.  The
    sign dequantize is one ``torch.mul`` of the codes and the broadcast
    scale (int8 times float32 promotes to float32, exact as the codes are
    +-1), timed as its library call; no single PyTorch call computes the
    quantizers or the minmax dequantize (an FMA after the +128 offset)."""
    ss, bounds = geometry["shard_size"], geometry["bounds"]
    g = max(range(len(bounds)), key=lambda k: bounds[k][1] - bounds[k][0])
    lo, hi = bounds[g]
    tile, r, c = 2048, WIRE_W, hi - lo
    gen = torch.Generator(device="cuda").manual_seed(4)
    res = torch.randn((r, ss), generator=gen, device="cuda") * 1e-3
    view = res[:, lo:hi]
    fresh = view.clone()
    codes = torch.empty((r, ss), dtype=torch.int8, device="cuda")
    sides = torch.empty((2, r, ss // tile), device="cuda")
    block = torch.empty((r, ss), device="cuda")
    rows = {}
    for mode in ("minmax", "sign"):
        kernel, ref = T[f"quantize_{mode}"], T[f"quantize_{mode}_ref"]
        q, *sd = kernel(view.clone(), tile=tile)
        codes[:, lo:hi] = q
        for k, s in enumerate(sd):
            sides[k][:, lo // tile:hi // tile] = s
        sq = [s[:, lo // tile:hi // tile] for s in sides[:len(sd)]]
        zero = sq[1] if mode == "minmax" else None
        out = block[:, lo:hi]
        cases = {
            f"quantize_{mode}": {
                "kernel": lambda kernel=kernel: kernel(view, tile=tile),
                "plain": lambda ref=ref: ref(view, tile)},
            f"dequantize_{mode}": {
                "kernel": lambda zero=zero, sq=sq, mode=mode: T["dequantize"](
                    codes[:, lo:hi], sq[0], zero, tile=tile, mode=mode,
                    out=out),
                "plain": lambda zero=zero, sq=sq, mode=mode:
                    T["dequantize_ref"](codes[:, lo:hi], sq[0], zero, tile,
                                        mode)},
        }
        if mode == "sign":
            by_tile = (r, c // tile, tile)
            lib = cases["dequantize_sign"]["library"] = (
                lambda sq=sq, by_tile=by_tile, out=out:
                torch.mul(codes[:, lo:hi].view(by_tile),
                          sq[0].unsqueeze(-1), out=out.view(by_tile)))
            cases["dequantize_sign"]["kernel"]()
            want = out.clone()
            lib()
            check(torch.equal(_bits_of(out), _bits_of(want)),
                  "dequantize_sign: torch.mul bit-identical to the kernel")
            del want
        for name, fns in cases.items():
            runs = {k: [] for k in fns}
            for _ in range(3):
                for k, fn in fns.items():
                    # the quantizer writes its residual into its payload:
                    # each run starts from the same payload, and 7 calls
                    # keep the residual of residuals far from subnormals,
                    # whose divisions take the slow path
                    view.copy_(fresh)
                    runs[k].append(time_calls(fn, 3 if k == "plain"
                                              else 5)[0])
            med = {k: float(np.median(v)) for k, v in runs.items()}
            lib_name = "torch.mul" if "library" in fns else None
            bnd, by = wire_bound_ms(name, r, c, tile)
            rows[name] = {"shape": [r, c], "group": geometry["groups"][g],
                          "leading_stride": ss, "ms": med["kernel"],
                          "plain_ms": med["plain"],
                          "library_ms": med.get("library"),
                          "library": lib_name, "bound_ms": bnd,
                          "bound_by": by, "device_runs_ms": runs}
            lib_text = (f"{lib_name} {med['library']!r}" if lib_name
                        else "none")
            print(f"  {name} ({r}, {c}) at stride {ss}, device ms per call: "
                  f"kernel {med['kernel']!r}, plain {med['plain']!r}, "
                  f"library {lib_text}, bound {bnd!r} ({by}); device runs: "
                  f"{json.dumps(runs)}")
    del res, fresh, codes, sides, block
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 12: the pytree GBA step and the pytree buffer's kernel-backed tree ops
# ---------------------------------------------------------------------------

PYTREE_LEAVES = 12             # granite-8b at depth 2: the leaves of its tree
PYTREE_STALE = [0, 0, -5, 0]   # buffer tokens; slot 2 is 5 > iota steps old
# card vs CPU, Adam: an element moves by about lr whatever the size of its
# gradient, so where a gradient is near Adam's epsilon the two sides' last
# bits move it by up to lr an apply
PYTREE_HOLD_LOSS_RTOL, PYTREE_HOLD_PARAM_ATOL = 1e-4, 2 * LM_LR
# the kernels' shapes of the pytree path and of the JAX package's kernel
# bench (benchmarks/bench_kernels.py:247,270)
AGG_SHAPES = ((16, 65_536), (LM_M, 201_326_592))
ADAGRAD_SHAPES = ((262_144, torch.float32, torch.float32),
                  (201_326_592, torch.bfloat16, torch.bfloat16))
# the JAX package's oracle test (tests/test_embedding_stream.py:126)
RESIDENT_SHAPES = ((10, 5, 50, 8), (64, 26, 500, 16), (33, 3, 613, 7))


def _tree_bits_equal(a: list, b: list) -> bool:
    return all(x.shape == y.shape and x.dtype == y.dtype
               and torch.equal(_bits_of(x), _bits_of(y))
               for x, y in zip(a, b, strict=True))


def pytree_phase(T: dict, counters) -> dict:
    phase(12, f"pytree GBA step (Adam) and the pytree buffer's tree ops: "
              f"granite-8b at full width, depth {LM_LAYERS} (reduced from "
              f"36), {LM_MICROSTEPS} microsteps")
    cfg = dataclasses.replace(T["get_config"]("granite-8b"),
                              num_layers=LM_LAYERS)
    leaves = T["leaves"]
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    n = sum(x.numel() for x in leaves(params))
    check(len(leaves(params)) == PYTREE_LEAVES and n == APPLY_N,
          f"{len(leaves(params))} leaves, N = {n}")
    batches = lm_batches(T, cfg.vocab_size, LM_SEQ, LM_BATCH,
                         LM_MICROSTEPS + LM_M, "cuda")

    # (a) the counted path: run_lm_pytree, 8 microsteps, tokens i // M
    rows, marks = [], {"prev": [x.clone() for x in leaves(params)],
                       "prev_obj": params, "gstep": 0}

    def on_step(i, progs, seconds):
        st = progs.state
        applies = (i + 1) % LM_M == 0
        p = leaves(st["params"])
        check(st["gstep"] == (i + 1) // LM_M,
              f"microstep {i + 1}: gstep {st['gstep']}")
        acc_zero = not any(bool(a.any()) for a in leaves(st["acc"]))
        if applies:
            check(st["params"] is not marks["prev_obj"] and acc_zero,
                  f"microstep {i + 1}: Adam applied, accumulator all zero")
        else:
            check(st["params"] is marks["prev_obj"]
                  and _tree_bits_equal(p, marks["prev"]) and not acc_zero,
                  f"microstep {i + 1}: params bit-identical, accumulator "
                  f"nonzero")
        # what the next microstep must leave as it is, if it does not apply
        marks["prev"] = ([x.clone() for x in p] if (i + 2) % LM_M else None)
        marks["prev_obj"], marks["progs"] = st["params"], progs
        rows.append({"microstep": i + 1, "loss": None, "seconds": seconds,
                     "gstep": st["gstep"], "applied": applies})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters(reset=True)
    losses = T["run_lm_pytree"](
        cfg, optimizer="adam", steps=LM_MICROSTEPS, batch=LM_BATCH,
        seq=LM_SEQ, buffer=LM_M, iota=LM_IOTA, lr=LM_LR, device="cuda",
        params=params, on_step=on_step)
    torch.cuda.synchronize()
    launches = counters()
    del params
    for r, loss in zip(rows, losses):
        r["loss"] = loss
        print(f"  {json.dumps(r)}")
    check(all(np.isfinite(losses)), f"finite losses: {losses}")
    check([r["microstep"] for r in rows if r["applied"]] == [4, 8],
          "Adam applied at microsteps 4 and 8 alone")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  launches {json.dumps(launches)} (Adam and the accumulator are "
          f"PyTorch operators; the path launches no kernel of the port); "
          f"peak device memory {peak_gb:.2f} GB (with the checks' copies)")

    # one more global step under the profiler: the path's own peak memory,
    # the device idle share and the top operators
    marks["prev"] = None
    progs = marks.pop("progs")
    state = progs.state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = StepProfile()
    prof.start()
    for i in range(LM_MICROSTEPS, LM_MICROSTEPS + LM_M):
        state, _ = progs.step(state, batches[i], i // LM_M)
    profile = prof.stop()
    path_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(state["gstep"] == 3, "a third global step")
    print(f"  profile of one global step ({LM_M} microsteps): "
          f"{json.dumps(profile)}; peak device memory of that global step "
          f"alone {path_peak_gb:.2f} GB")
    params = state["params"]
    del state, progs, marks
    torch.cuda.empty_cache()

    tree_ops = tree_ops_check(T, cfg, params, batches, counters)
    del params
    torch.cuda.empty_cache()
    hold = pytree_card_vs_cpu(T)
    return {"config": {"arch": cfg.name, "num_layers": LM_LAYERS,
                       "reduced": "num_layers 36 -> 2", "optimizer": "adam",
                       "batch": LM_BATCH, "seq": LM_SEQ, "M": LM_M,
                       "iota": LM_IOTA, "lr": LM_LR, "N": APPLY_N,
                       "leaves": PYTREE_LEAVES},
            "microsteps": rows, "launches": launches,
            "peak_memory_gb": peak_gb, "path_peak_memory_gb": path_peak_gb,
            "profile": profile, "tree_ops": tree_ops, "card_vs_cpu": hold}


def tree_ops_check(T: dict, cfg, params: dict, batches: list,
                   counters) -> dict:
    """(c) 4 full-width gradient trees pushed through the pytree buffer,
    slot 2 stale beyond iota; at the apply ``ops.gba_aggregate_tree`` and
    ``ops.adagrad_apply_tree`` (the path, its launches counted), then each
    held to its plain version leaf by leaf, the aggregate to
    ``aggregate_dense`` and the update to ``optim.adagrad``."""
    leaves, tree_map = T["leaves"], T["tree_map"]
    buf = T["init_buffer"](params, LM_M)
    gen = torch.Generator(device="cuda").manual_seed(7)
    got = {}

    def apply_fn(agg_dense):
        # the buffer and inputs as the tree ops found them
        got["buffer"] = [g.clone() for g in leaves(buf["grads"])]
        got["tokens"] = buf["tokens"].clone()
        got["params"] = [p.clone() for p in leaves(params)]
        got["dense"] = agg_dense
        got["agg"] = T["ops"].gba_aggregate_tree(
            buf["grads"], buf["tokens"], buf["step"], iota=LM_IOTA)
        # an accumulator of squared gradients of the aggregate's size, as
        # after some steps of training, kept above 1e-12 (no subnormal
        # squares): a' = fma(g, g, a) then rounds both terms, and each
        # element with a gradient well above 1e-6 moves by about lr / 2
        # (from Adagrad's initial 0.1 nothing would move: g * g is below
        # half an ulp of 0.1 and lr * g below half a bfloat16 ulp of the
        # params)
        got["accum_tree"] = tree_map(
            lambda g: g.float().square() * (0.5 + 1.5 * torch.rand(
                g.shape, generator=gen, device=g.device)) + 1e-12,
            got["agg"])
        got["accum"] = [a.clone() for a in leaves(got["accum_tree"])]
        got["new"] = T["ops"].adagrad_apply_tree(
            params, got["agg"], got["accum_tree"], LM_LR)
        return True

    torch.cuda.synchronize()
    counters(reset=True)
    for j, token in enumerate(PYTREE_STALE):
        out, buf = T["buffer_push_and_maybe_apply"](
            buf, T["loss_and_grads"](cfg, params, batches[j])[1], token,
            LM_IOTA,
            apply_fn, lambda: False)
        check(out == (j == LM_M - 1), f"push {j + 1}: applied {out}")
    torch.cuda.synchronize()
    launches = counters()
    check(launches["gba_aggregate"] == PYTREE_LEAVES
          and launches["fused_adagrad"] == PYTREE_LEAVES,
          f"one launch of each a leaf: {launches}")
    check((buf["fill"], buf["step"]) == (LM_M, 1), "one global step")
    check(torch.equal(got["tokens"].cpu(), torch.tensor(
        PYTREE_STALE, dtype=torch.int32)), "buffer tokens")

    agg, (new_p, new_a) = leaves(got["agg"]), got["new"]
    new_p, new_a = leaves(new_p), leaves(new_a)
    accum = got["accum_tree"]
    opt_p, opt_s = T["get_optimizer"]("adagrad", LM_LR).update(
        params, got["agg"], {"accum": accum})
    opt_p, opt_a = leaves(opt_p), leaves(opt_s["accum"])
    check(_tree_bits_equal(leaves(params), got["params"])
          and _tree_bits_equal(leaves(accum), got["accum"]),
          "adagrad_apply_tree leaves the caller's params and accumulators "
          "as they were")
    dense_diff = p_diff = 0
    p_max_rel = a_max_rel = agg_err = ada_err = 0.0
    f32_excess = -1.0
    for j, (g, dense, buf_j) in enumerate(zip(agg, leaves(got["dense"]),
                                              got["buffer"])):
        want = T["gba_aggregate_ref"](buf_j.reshape(LM_M, -1),
                                      got["tokens"], 0, iota=LM_IOTA)
        check(torch.equal(_bits_of(g.reshape(-1)), _bits_of(want)),
              f"leaf {j}: gba_aggregate bit-identical to its plain version")
        agg_err = max(agg_err, _max_abs(g.reshape(-1), want))
        dense_diff += int((_bits_of(g) != _bits_of(dense)).sum())
        want_p, want_a = T["fused_adagrad_ref"](
            got["params"][j].reshape(-1), g.reshape(-1),
            got["accum"][j].reshape(-1), LM_LR)
        check(torch.equal(_bits_of(new_p[j].reshape(-1)), _bits_of(want_p))
              and torch.equal(_bits_of(new_a[j].reshape(-1)),
                              _bits_of(want_a)),
              f"leaf {j}: fused_adagrad bit-identical to its plain version")
        ada_err = max(ada_err, _max_abs(new_p[j].reshape(-1), want_p),
                      _max_abs(new_a[j].reshape(-1), want_a))
        del want, want_p, want_a
        a_rel = ((new_a[j] - opt_a[j]).abs()
                 / opt_a[j].abs().clamp(min=1e-38)).max().item()
        a_max_rel = max(a_max_rel, a_rel)
        p_abs = (new_p[j].float() - opt_p[j].float()).abs()
        if new_p[j].dtype == torch.bfloat16:
            p_max_rel = max(p_max_rel, (p_abs / opt_p[j].float().abs()
                                        .clamp(min=1e-30)).max().item())
        else:
            # p - upd cancels where the two are close: the float32
            # rounding of the update counts against the update's size
            f32_excess = max(f32_excess, (p_abs - 1e-6 * opt_p[j].abs())
                             .max().item())
        p_diff += int((_bits_of(new_p[j]) != _bits_of(opt_p[j])).sum())
    moved = sum(int((_bits_of(a) != _bits_of(b)).sum())
                for a, b in zip(new_p, got["params"]))
    with_grad = sum(int(g.count_nonzero()) for g in agg)
    out = {"launches": launches,
           "max_abs_err": {"gba_aggregate": agg_err,
                           "fused_adagrad": ada_err},
           "aggregate_dense_differing": dense_diff,
           "params_moved": moved, "elements_with_gradient": with_grad,
           "optim_adagrad_accum_max_rel": a_max_rel,
           "optim_adagrad_bf16_param_max_rel": p_max_rel,
           "optim_adagrad_f32_param_beyond_rtol_1e-6": f32_excess,
           "optim_adagrad_params_differing": p_diff}
    print(f"  tree ops at the apply (4 pushes, slot 2 dropped): "
          f"{json.dumps(out)}")
    check(dense_diff == 0, f"gba_aggregate_tree bit-identical to "
          f"aggregate_dense at M = {LM_M}: {dense_diff} elements differ")
    check(a_max_rel <= 1e-6, f"accumulators within rtol 1e-6 of "
          f"optim.adagrad: {a_max_rel}")
    # a bfloat16 param may round the other way where its float32 value lies
    # at a rounding boundary: one bf16 ulp; float32 params within rtol 1e-6
    # and atol 1e-6 * lr (updates are at most about lr)
    check(p_max_rel <= 2.0**-7, f"bfloat16 params within one bfloat16 ulp "
          f"of optim.adagrad: {p_max_rel}")
    check(f32_excess <= 1e-6 * LM_LR, f"float32 params within rtol 1e-6 and "
          f"atol {1e-6 * LM_LR} of optim.adagrad: {f32_excess}")
    check(moved > with_grad // 2, f"the update moved the params: {moved} "
          f"of the {with_grad} elements with a gradient")
    del got, agg, new_p, new_a, opt_p, opt_a, buf, accum
    torch.cuda.empty_cache()
    return out


def pytree_card_vs_cpu(T: dict) -> dict:
    """(b) ``granite-8b.reduced()`` in float32, 2 global steps of
    ``run_lm_pytree`` (Adam) from the same initial params on the card and
    on the CPU."""
    cfg = dataclasses.replace(T["get_config"]("granite-8b").reduced(),
                              dtype="float32")
    host = T["init_model"](cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        final = {}

        def on_step(i, progs, seconds, final=final):
            final["state"] = progs.state
        losses = T["run_lm_pytree"](
            cfg, optimizer="adam", steps=2 * LM_M, batch=LM_BATCH,
            seq=LM_SEQ, buffer=LM_M, iota=LM_IOTA, lr=LM_LR, device=dev,
            params=T["tree_to_device"](host, torch.device(dev)),
            on_step=on_step)
        st = final["state"]
        check(st["gstep"] == 2, f"{dev}: 2 global steps")
        runs[dev] = (losses, torch.cat([x.reshape(-1).cpu() for x in
                                        T["leaves"](st["params"])]))
    (lc, pc), (lh, ph) = runs["cuda"], runs["cpu"]
    diff = (pc - ph).abs()
    out = {"losses_card": lc, "losses_cpu": lh,
           "max_param_diff": diff.max().item(),
           "params_beyond_rtol_1e-5": int((diff > 1e-5 * ph.abs()).sum()),
           "params": ph.numel()}
    print(f"  {cfg.name} f32, Adam, 2 global steps, card vs CPU: "
          f"{json.dumps(out)}")
    check(np.allclose(lc, lh, rtol=PYTREE_HOLD_LOSS_RTOL, atol=0),
          f"card vs CPU: losses within rtol {PYTREE_HOLD_LOSS_RTOL}")
    check(out["max_param_diff"] <= PYTREE_HOLD_PARAM_ATOL,
          f"card vs CPU: params within atol {PYTREE_HOLD_PARAM_ATOL}")
    return out


def resident_phase(T: dict, counters) -> dict:
    """(d) the resident oracle: the streamed ``embedding_bag_grad`` against
    ``embedding_bag_grad_resident``, and the resident kernel against its
    plain version on a CPU copy, bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = [(f"stream test ({b}, {f}, {v}, {d})",
              torch.randint(0, v, (b, f), generator=gen, device="cuda",
                            dtype=torch.int32),
              torch.randn((b, d), generator=gen, device="cuda"), v)
             for b, f, v, d in RESIDENT_SHAPES]
    cases += [
        ("sparse smoke (4, 26) over 1,000,000 x 16",
         smoke_ids(T["hash_ids"], torch.Generator().manual_seed(9), 4),
         torch.randn((4, SMOKE_D), generator=gen, device="cuda"), SMOKE_V),
        ("replay presence counts (1, 53,248) over 1,600,048, D = 0",
         T["presence"][0], torch.zeros((1, 0), device="cuda"),
         T["presence_capacity"])]
    torch.cuda.synchronize()
    counters(reset=True)
    outs = [(T["embedding_bag_grad"](ids, g, cap),
             T["embedding_bag_grad_resident"](ids, g, cap))
            for _, ids, g, cap in cases]
    torch.cuda.synchronize()
    launches = counters()
    check(launches["embedding_bag_grad_resident"] == len(cases)
          and launches["embedding_bag_grad"] == len(cases),
          f"one launch of each a shape: {launches}")
    max_err = 0.0
    for (name, ids, g, cap), ((s_gt, s_cnt), (r_gt, r_cnt)) in zip(cases,
                                                                   outs):
        want_gt, want_cnt = T["embedding_bag_grad_ref"](ids.cpu(), g.cpu(),
                                                        cap)
        ok = (torch.equal(_bits_of(s_gt), _bits_of(r_gt))
              and torch.equal(s_cnt, r_cnt)
              and torch.equal(_bits_of(r_gt.cpu()), _bits_of(want_gt))
              and torch.equal(r_cnt.cpu(), want_cnt))
        err = (r_gt.cpu() - want_gt).abs().max().item() if r_gt.numel() \
            else 0.0
        max_err = max(max_err, err)
        print(f"  {name}: streamed == resident == plain, bit for bit: "
              f"{'ok' if ok else 'FAIL'} ({int(want_cnt.sum())} valid "
              f"entries)")
        check(ok, f"resident oracle: {name}")
    return {"launches": launches, "shapes": [n for n, *_ in cases],
            "max_abs_err": max_err}


def _timed(fns: dict, small: bool, cycles_per_ms: float,
           plain_reps: int = 2) -> tuple[dict, dict, dict]:
    """(median, runs, held): device ms per call of each of ``fns`` in
    turns, median of 3 runs, with the device held by a sleep kernel until
    the calls are queued: 100 of a launch-bound call (``small``), 10 of a
    large one (``plain_reps`` of the plain version).  ``held`` says, for
    each of ``fns``, whether every sleep outlasted the host's issuing."""
    runs = {k: [] for k in fns}
    held = {k: True for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            if small:
                ms, _, ok = time_ms(lambda _i, _t, fn=fn: fn(), [None],
                                    None, cycles_per_ms)
            else:
                ms, ok = time_calls(fn, plain_reps if k == "plain" else 10,
                                    cycles_per_ms)
            runs[k].append(ms)
            held[k] = held[k] and ok
    return {k: float(np.median(v)) for k, v in runs.items()}, runs, held


def _bound(nbytes: float, f32_ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = f32_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def pytree_timing(T: dict, cycles_per_ms: float) -> dict:
    """(e) ``gba_aggregate``, ``fused_adagrad`` and
    ``embedding_bag_grad_resident`` against their plain versions, their
    bounds and a library call."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    out = {"gba_aggregate": [], "fused_adagrad": []}
    for m, d in AGG_SHAPES:
        grads = torch.randn((m, d), generator=gen, device="cuda",
                            dtype=torch.bfloat16) * 1e-3
        tokens = torch.tensor([9] * (m - 1) + [3], dtype=torch.int32,
                              device="cuda")          # the last slot drops
        w = ((9 - tokens) <= LM_IOTA).float() / m
        lib = torch.matmul(w.to(grads.dtype), grads)
        got = T["gba_aggregate"](grads, tokens, 9, iota=LM_IOTA)
        lib_diff = (lib.float() - got.float()).abs().max().item()
        med, runs, _ = _timed({
            "kernel": lambda: T["gba_aggregate"](grads, tokens, 9,
                                                 iota=LM_IOTA),
            "plain": lambda: T["gba_aggregate_ref"](grads, tokens, 9,
                                                    iota=LM_IOTA),
            "library": lambda: torch.matmul(w.to(grads.dtype), grads)},
            d < 1 << 20, cycles_per_ms)
        bnd, by = _bound((m + 1) * d * 2 + m * 4, 2 * m * d)
        row = {"shape": [m, d], "dtype": "bf16", "ms": med["kernel"],
               "plain_ms": med["plain"], "library_ms": med["library"],
               "library": "torch.matmul(w.to(G.dtype), G)",
               "library_max_abs_diff": lib_diff, "bound_ms": bnd,
               "bound_by": by, "device_runs_ms": runs}
        out["gba_aggregate"].append(row)
        print(f"  gba_aggregate ({m}, {d}) bf16, device ms per call: kernel "
              f"{med['kernel']!r}, plain {med['plain']!r}, torch.matmul "
              f"{med['library']!r} (max |diff| {lib_diff!r}), bound "
              f"{bnd!r} ({by}); device runs: {json.dumps(runs)}")
        del grads, lib, got
        torch.cuda.empty_cache()
    for n, p_dt, g_dt in ADAGRAD_SHAPES:
        param = (torch.randn((n,), generator=gen, device="cuda")
                 * 0.02).to(p_dt)
        grad = (torch.randn((n,), generator=gen, device="cuda")
                * 1e-3).to(g_dt)
        accum = torch.full((n,), 0.1, device="cuda")
        step_t = torch.zeros((), device="cuda")
        fns = {"kernel": lambda: T["fused_adagrad"](param, grad, accum,
                                                    LM_LR),
               "plain": lambda: T["fused_adagrad_ref"](param, grad, accum,
                                                       LM_LR)}
        lib_note = None
        try:                      # PyTorch's fused Adagrad, if it runs here
            torch._fused_adagrad_([param.clone()], [grad], [accum.clone()],
                                  [step_t.clone()], lr=LM_LR, lr_decay=0.0,
                                  weight_decay=0.0, eps=1e-10,
                                  maximize=False)
            torch.cuda.synchronize()
            fns["library"] = lambda: torch._fused_adagrad_(
                [param], [grad], [accum], [step_t], lr=LM_LR, lr_decay=0.0,
                weight_decay=0.0, eps=1e-10, maximize=False)
        except (RuntimeError, NotImplementedError, TypeError,
                AttributeError) as e:
            lib_note = f"torch._fused_adagrad_ does not run here: {e}"[:300]
        med, runs, _ = _timed(fns, n < 1 << 20, cycles_per_ms)
        p_item, g_item = param.element_size(), grad.element_size()
        bnd, by = _bound(n * (2 * p_item + g_item + 2 * 4), 7 * n)
        row = {"shape": [n], "dtypes": f"param {str(p_dt)[6:]}, grad "
               f"{str(g_dt)[6:]}, accum float32", "ms": med["kernel"],
               "plain_ms": med["plain"], "library_ms": med.get("library"),
               "library": ("torch._fused_adagrad_" if "library" in med
                           else None), "library_note": lib_note,
               "bound_ms": bnd, "bound_by": by, "device_runs_ms": runs}
        out["fused_adagrad"].append(row)
        print(f"  fused_adagrad ({n},) {row['dtypes']}, device ms per call: "
              f"kernel {med['kernel']!r}, plain {med['plain']!r}, library "
              f"{med.get('library')!r} ({lib_note or 'torch._fused_adagrad_'}"
              f"), bound {bnd!r} ({by}); device runs: {json.dumps(runs)}")
        del param, grad, accum
        torch.cuda.empty_cache()
    cpu_gen = torch.Generator().manual_seed(12)
    out["embedding_bag_grad_resident"] = segment_sum_timing(
        T, "embedding_bag_grad_resident", [
            ("(64, 26, 500, 16)",
             [torch.randint(0, 500, (64, 26), generator=gen, device="cuda",
                            dtype=torch.int32)
              for _ in range(TIMED_ID_SETS)],
             torch.randn((64, 16), generator=gen, device="cuda"), 500),
            ("(b)", [smoke_ids(T["hash_ids"], cpu_gen, SMOKE_BATCH)
                     for _ in range(TIMED_ID_SETS)],
             torch.randn((SMOKE_BATCH, SMOKE_D), generator=gen,
                         device="cuda"), SMOKE_V)], cycles_per_ms,
        # a row of (64, 26, 500) sums about 3 normal draws, in another
        # order in the library, where a sum that cancels to near 0 differs
        # by more than its rtol
        lib_atol=1e-6)
    return out


def pytree_rows(pytree: dict, resident: dict, times: dict,
                audited: dict) -> list[dict]:
    """The kernels line's rows of the three kernels of phase 12, timed at
    the path's largest launch (``at``), every timed shape under
    ``shapes``; ``gba_aggregate``'s launches also phase 25's."""
    tree_launches = pytree["tree_ops"]["launches"]
    rows = []
    for name, line, source, by_path, err, timed, note in (
            ("gba_aggregate", "src/repro/kernels/gba_aggregate.py:76",
             "gba_aggregate.cu",
             {"pytree_tree_ops": tree_launches["gba_aggregate"],
              "audit_tombstone": audited["a"]["launches"]["gba_aggregate"],
              "audit_launch_meta":
              audited["d"]["launches"]["gba_aggregate"]},
             pytree["tree_ops"]["max_abs_err"]["gba_aggregate"],
             times["gba_aggregate"], "a GEMV of the weights and the "
             "buffer: the same decayed mean, summed in another order"),
            ("fused_adagrad", "src/repro/kernels/fused_adagrad.py:75",
             "fused_adagrad.cu",
             {"pytree_tree_ops": tree_launches["fused_adagrad"],
              "audit_launch_meta":
              audited["d"]["launches"]["fused_adagrad"]},
             pytree["tree_ops"]["max_abs_err"]["fused_adagrad"],
             times["fused_adagrad"], None),
            ("embedding_bag_grad_resident",
             "src/repro/kernels/embedding_bag.py:553",
             "embedding_bag_grad_resident.cu",
             {"resident_oracle":
              resident["launches"]["embedding_bag_grad_resident"],
              "audit_launch_meta":
              audited["d"]["launches"]["embedding_bag_grad_resident"]},
             resident["max_abs_err"], times["embedding_bag_grad_resident"],
             None)):
        at = timed[-1] if name != "embedding_bag_grad_resident" else \
            timed[0]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": line,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": err,
            "ms": at["ms"],
            "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"],
            "library_ms": at["library_ms"],
            "library": at["library"],
            "library_note": note or at.get("library_note"),
            "at": at["shape"],
            "shapes": timed,
            "ok": True,
        })
    return rows


# ---------------------------------------------------------------------------
# phase 13: LM serving, granite-8b at full width and full depth

# the fixed-batch loop (launch.serve): B prompts of P tokens, G generated
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 128, 32
# decode at the decode_32k shape: a random cache of L positions at pos
LONG_L, LONG_POS, LONG_STEPS = 32_768, 32_000, 5
# the engine (launch.serve --engine): requests of 4 to P tokens, 4 slots
ENGINE_REQUESTS, ENGINE_SLOTS = 8, 4
# the kernel route against the plain route, both fed the same tokens:
# bfloat16 attention outputs may round one bf16 ulp apart, which moves the
# logits by a few bf16 ulps of their scale; float32 agrees to its rounding
SERVE_LOGIT_FRAC = {"bfloat16": 2.0**-6, "float32": 1e-5}
# card against CPU at granite-8b.reduced() in float32: logits within this
# fraction of their largest magnitude, tokens equal
SERVE_HOLD_FRAC = 1e-5
# the kernel against its plain version: (label, B, L, KV, G, hd, dtype,
# positions)
FLASH_CHECKS = (
    ("serve loop", 4, 160, 8, 4, 128, torch.bfloat16, (0, 1000, 159)),
    ("decode_32k", 4, 32_768, 8, 4, 128, torch.bfloat16, (0, 1000, 32_767)),
    ("ragged L = 544", 4, 544, 8, 4, 128, torch.bfloat16, (0, 300, 543)),
    ("G = 1", 4, 544, 8, 1, 128, torch.bfloat16, (0, 543)),
    ("f32", 4, 4096, 8, 4, 128, torch.float32, (0, 1000, 4095)),
    ("reduced granite, hd 64, G 1", 4, 25, 4, 1, 64, torch.float32, (0, 24)),
)
# the timed shapes: the serve loop's last step and decode_32k
FLASH_TIMED = ((4, 160, 8, 4, 128, 159), (4, 32_768, 8, 4, 128, LONG_POS))


class plain_flash:
    """Within the block, ``ops.flash_decode`` is the plain version."""

    def __init__(self, T: dict):
        self.ops, self.ref = T["ops"], T["flash_decode_ref"]

    def __enter__(self):
        self.saved = self.ops.flash_decode
        self.ops.flash_decode = self.ref

    def __exit__(self, *exc):
        self.ops.flash_decode = self.saved


def _forced(T: dict, params, cfg, prompts, tokens, cache_len: int,
            memory=None):
    """Prefill (over ``memory``, for cross layers), then decode fed
    ``tokens`` (B, n): the logits (B, n, V) of the prefill and of each of
    the n - 1 steps, and the cache after."""
    Tm = T["transformer"]
    logits, cache = Tm.prefill(params, cfg, prompts, memory,
                               cache_len=cache_len)
    out = [logits[:, None]]
    for i in range(tokens.shape[1] - 1):
        lg, cache = Tm.decode_step(params, cfg, tokens[:, i:i + 1], cache)
        out.append(lg)
    return torch.cat(out, dim=1), cache


def _offline_greedy(T: dict, params, cfg, prompt, n_new: int) -> list:
    """``tests/test_serving.py:_offline_greedy`` on the port: one request,
    a cache of len(prompt) + n_new + 1, decode at a scalar position."""
    Tm = T["transformer"]
    dev = params["embed"].device
    toks = torch.as_tensor(prompt, dtype=torch.int32, device=dev)[None]
    logits, cache = Tm.prefill(params, cfg, toks,
                               cache_len=len(prompt) + n_new + 1)
    out = [int(torch.argmax(logits[0]))]
    for _ in range(n_new - 1):
        lg, cache = Tm.decode_step(
            params, cfg, torch.tensor([[out[-1]]], device=dev), cache)
        out.append(int(torch.argmax(lg[0, 0])))
    return out


def decode_profile(T: dict, params, cfg, token, cache) -> dict:
    """One decode step under ``torch.profiler``: device time by kernel
    name, the idle share, and the device time of ``flash_decode``, of the
    head (operators with the vocabulary in an input shape: the float32
    casts and GEMM), of the MLP (d_ff in a shape), of the attention
    projections (the other matrix products) and of the rest."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T["transformer"].decode_step(params, cfg, token, cache)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = device_times(prof, wall_us, "flash_decode", top_n=10,
                       name_len=120)
    parts = {"flash_decode_us": sum(out["flash_decode_us"]), "head_us": 0.0,
             "mlp_us": 0.0, "attn_proj_us": 0.0}
    by_op = []
    for e in prof.key_averages(group_by_input_shape=True):
        t = getattr(e, "self_device_time_total", 0.0)
        if not t or not e.key.startswith("aten::"):
            continue
        shapes = str(e.input_shapes)
        by_op.append((t, f"{e.key} {shapes[:100]}", e.count))
        if str(cfg.vocab_size) in shapes:
            parts["head_us"] += t
        elif str(cfg.d_ff) in shapes:
            parts["mlp_us"] += t
        elif e.key in ("aten::mm", "aten::bmm", "aten::addmm"):
            parts["attn_proj_us"] += t
    parts["other_us"] = out["device_busy_us"] - sum(parts.values())
    out["flash_decode_launches"] = len(out.pop("flash_decode_us")) // 2
    out["aten_self_device_us"] = {k: [t, n] for t, k, n in
                                  sorted(by_op, reverse=True)[:8]}
    out.update(parts)
    out["shares"] = {k[:-3]: v / out["device_busy_us"]
                     for k, v in parts.items()}
    return out


def serve_fixed_phase(T: dict, cfg, params, counters) -> dict:
    """(a) the fixed-batch loop of ``launch.serve``, counted; then the same
    decode with the plain version swapped in, teacher-forced with the
    kernel run's tokens; a profile of one more step."""
    serve = T["serve"]
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=torch.Generator("cuda").manual_seed(1),
                            device="cuda")
    # a short warm-up run: cuBLAS's handles and the kernels' first loads
    serve.run_fixed_batch(params, cfg, prompts, 2, log=lambda _: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters(reset=True)
    res = serve.run_fixed_batch(params, cfg, prompts, SERVE_GEN)
    torch.cuda.synchronize()
    launches = counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = cfg.num_layers * (SERVE_GEN - 1)
    print(f"  launches: {json.dumps(launches)}")
    check(launches["flash_decode"] == want,
          f"{cfg.num_layers} flash_decode launches a decode step: "
          f"{launches['flash_decode']} != {want}")
    check(sum(v for k, v in launches.items()
              if k not in ("flash_decode", "calls")) == 0,
          "the serve loop launches no other kernel")
    steps = res["decode_steps"]
    step_ms = res["decode_s"] / steps * 1e3
    tok_s = SERVE_BATCH * steps / res["decode_s"]
    tokens = res["tokens"]
    check(tokens.shape == (SERVE_BATCH, SERVE_GEN), "tokens (B, gen)")
    print(f"  fixed batch {SERVE_BATCH}x{SERVE_PROMPT}, gen {SERVE_GEN}: "
          f"prefill {res['prefill_s'] * 1e3!r} ms, decode {step_ms!r} ms a "
          f"step, {tok_s!r} tok/s, peak {peak_gb!r} GB")
    cache_len = SERVE_PROMPT + SERVE_GEN
    kern, cache = _forced(T, params, cfg, prompts, tokens, cache_len)
    with plain_flash(T):
        plain, _ = _forced(T, params, cfg, prompts, tokens, cache_len)
    check(bool(torch.isfinite(kern).all()), "finite logits")
    check(torch.equal(kern.argmax(-1), tokens),
          "the forced kernel run repeats the loop's greedy tokens")
    err = (kern - plain).abs().max().item()
    scale = plain.abs().max().item()
    agree = plain.argmax(-1) == tokens
    print(f"  kernel vs plain flash_decode, teacher-forced: max |logit diff|"
          f" {err!r} of max |logit| {scale!r}; greedy tokens equal at "
          f"{int(agree.sum())} of {agree.numel()}")
    check(err <= SERVE_LOGIT_FRAC[cfg.dtype] * scale,
          f"logits within {SERVE_LOGIT_FRAC[cfg.dtype]} of the largest")
    check(bool(agree.all()), "greedy tokens equal with the plain version")
    token = kern[:, -1].argmax(-1)[:, None].to(torch.int32)
    prof = decode_profile(T, params, cfg, token, cache)
    print(f"  profile of a step at pos {SERVE_PROMPT + SERVE_GEN - 1}: "
          f"{json.dumps(prof)}")
    return {"prefill_ms": res["prefill_s"] * 1e3, "decode_step_ms": step_ms,
            "tokens_per_s": tok_s, "peak_gb": peak_gb,
            "launches": launches, "logit_max_abs_diff": err,
            "logit_max_abs": scale, "profile": prof}


def serve_long_phase(T: dict, cfg, params, counters) -> dict:
    """(b) decode at the decode_32k shape: a cache of 32,768 positions of
    random bf16 k and v, every sequence at pos 32,000."""
    Tm, serve = T["transformer"], T["serve"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(2)
    cache = Tm.init_cache(cfg, SERVE_BATCH, LONG_L, "cuda")
    for leaf in T["leaves"](cache["blocks"]):
        leaf.normal_(generator=gen)
    cache["pos"] = torch.full((), LONG_POS, dtype=torch.int32, device="cuda")
    decode = serve.make_decode_step(cfg)
    token = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, 1), generator=gen,
                          device="cuda", dtype=torch.int32)
    token, _, cache = decode(params, token, cache)             # warm-up
    torch.cuda.synchronize()
    counters(reset=True)
    t0 = time.perf_counter()
    for _ in range(LONG_STEPS):
        token, logits, cache = decode(params, token, cache)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["flash_decode"] == cfg.num_layers * LONG_STEPS,
          f"flash_decode launches at 32k: {launches['flash_decode']}")
    check(bool(torch.isfinite(logits).all()), "finite logits at 32k")
    check(int(cache["pos"]) == LONG_POS + 1 + LONG_STEPS, "pos advanced")
    step_ms = dt / LONG_STEPS * 1e3
    print(f"  decode at {LONG_L} positions (pos {LONG_POS}), B "
          f"{SERVE_BATCH}: {step_ms!r} ms a step, peak {peak_gb!r} GB")
    prof = decode_profile(T, params, cfg, token, cache)
    print(f"  profile of a step: {json.dumps(prof)}")
    del cache
    torch.cuda.empty_cache()
    return {"decode_step_ms": step_ms, "peak_gb": peak_gb,
            "launches": launches, "profile": prof}


def serve_engine_phase(T: dict, cfg, params, counters,
                       prompt_len: int = SERVE_PROMPT,
                       gen: int = SERVE_GEN, require_all: bool = False
                       ) -> dict:
    """(c) the engine of ``launch.serve --engine``: requests of 4 to
    ``prompt_len`` tokens into 4 slots, each held to the offline greedy
    decode on the card (the kernel route).  The first token comes from the
    same prefill on both sides and must agree; the rest agree in full only
    when ``require_all`` (float32)."""
    S = T["S"]
    eng = S.ServingEngine(S.StaticSource(params), cfg,
                          num_slots=ENGINE_SLOTS, max_len=prompt_len + gen)
    rng = np.random.default_rng(0)
    for uid in range(ENGINE_REQUESTS):
        plen = int(rng.integers(4, prompt_len + 1))
        eng.submit(S.Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, plen, dtype=np.int64).astype(np.int32),
            max_new_tokens=gen))
    torch.cuda.synchronize()
    counters(reset=True)
    stats = eng.run()
    torch.cuda.synchronize()
    launches = counters()
    print(f"  engine: {json.dumps(stats)}")
    check(stats["completed"] == ENGINE_REQUESTS, "every request completed")
    check(launches["flash_decode"] == 0,
          "the engine's per-slot positions take the masked route")
    agree = total = identical = 0
    for req in eng.completed:
        off = _offline_greedy(T, params, cfg, req.prompt, gen)
        check(off[0] == req.output[0],
              f"request {req.uid}: the prefill's token agrees")
        same = sum(a == b for a, b in zip(off, req.output))
        agree, total = agree + same, total + len(off)
        identical += off == req.output
    print(f"  engine vs offline greedy on the card ({cfg.dtype}): {agree} of "
          f"{total} tokens agree, {identical} of {ENGINE_REQUESTS} requests "
          f"identical")
    if require_all:
        check(identical == ENGINE_REQUESTS, "engine == offline greedy")
    return {"stats": stats, "launches": launches, "tokens_agree": agree,
            "tokens": total, "requests_identical": identical}


def serve_card_vs_cpu(T: dict, counters) -> dict:
    """(d) ``granite-8b.reduced()`` in float32: prefill and 8 decode steps
    on the card (the kernel) and on the CPU (the plain version) from the
    same weights, teacher-forced with the card's greedy tokens; then the
    engine on the card against the offline greedy decode, all tokens."""
    cfg = dataclasses.replace(T["get_config"]("granite-8b").reduced(),
                              dtype="float32")
    host = T["transformer"].init_model(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = T["tree_to_device"](host, torch.device("cuda"))
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, 16),
                            generator=torch.Generator().manual_seed(1))
    res = T["serve"].run_fixed_batch(card, cfg, prompts.cuda(), 9,
                                     log=lambda _: None)
    tokens = res["tokens"]
    on_card, _ = _forced(T, card, cfg, prompts.cuda(), tokens, 25)
    on_host, _ = _forced(T, host, cfg, prompts, tokens.cpu(), 25)
    err = (on_card.cpu() - on_host).abs().max().item()
    scale = on_host.abs().max().item()
    same = bool(torch.equal(on_host.argmax(-1), tokens.cpu()))
    print(f"  reduced f32 card vs CPU, prefill + 8 steps: max |logit diff| "
          f"{err!r} of {scale!r}; greedy tokens equal: {same}")
    check(err <= SERVE_HOLD_FRAC * scale, "card vs CPU logits")
    check(same, "card vs CPU greedy tokens")
    engine = serve_engine_phase(T, cfg, card, counters, prompt_len=16,
                                gen=8, require_all=True)
    return {"logit_max_abs_diff": err, "logit_max_abs": scale,
            "engine": engine}


def flash_bound_ms(b: int, length: int, kv: int, g: int, hd: int, pos: int,
                   item: int) -> tuple[float, str]:
    """Least time for one call: q read and the output written once, and
    the k and v rows up to ``pos`` read once, against 4 * hd float32
    operations a (query row, position) pair (q . k and p * v)."""
    n = min(pos + 1, length)
    nbytes = 2 * b * n * kv * hd * item + 2 * b * kv * g * hd * item
    return _bound(nbytes, b * kv * g * n * 4 * hd)


def flash_phase(T: dict, cycles_per_ms: float) -> dict:
    """(e) the kernel against its plain version at every listed shape and
    position, then timed against it, its bound and SDPA."""
    fd, ref = T["flash_decode"], T["flash_decode_ref"]
    gen = torch.Generator("cuda").manual_seed(3)
    max_err = 0.0
    for label, b, length, kv, g, hd, dt, positions in FLASH_CHECKS:
        q = torch.randn((b, kv, g, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, length, kv, hd), generator=gen, device="cuda",
                        dtype=dt)
        v = torch.randn((b, length, kv, hd), generator=gen, device="cuda",
                        dtype=dt)
        for pos in positions:
            got = fd(q, k, v, torch.tensor(pos, dtype=torch.int32,
                                           device="cuda"))
            want = ref(q, k, v, pos)
            torch.cuda.synchronize()
            if dt == torch.bfloat16:
                ok = torch.allclose(got.float(), want.float(),
                                    rtol=BF16_RTOL, atol=BF16_ATOL)
            else:
                ok = torch.allclose(got, want, rtol=1e-5, atol=1e-6)
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            print(f"  flash_decode {label} ({b}, {length}, {kv}, {g}, {hd}) "
                  f"{str(dt)[6:]}, pos {pos}: max |err| {err!r} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"flash_decode {label} pos {pos}")
        del q, k, v
    rows = [flash_timed(T, gen, shape, cycles_per_ms)
            for shape in FLASH_TIMED]
    return {"max_abs_err": max_err, "timed": rows}


def flash_timed(T: dict, gen: torch.Generator, shape: tuple,
                cycles_per_ms: float, partial: bool = False) -> dict:
    """``flash_decode`` at ``shape`` = (B, L, KV, G, hd, pos) on random bf16
    inputs, timed in turns with its plain version and SDPA (whose output
    must agree within 2**-6 of the largest), beside its byte bound and its
    launch plan.  With ``partial``, ``flash_decode_partial`` of the slice
    from position 0 and its plain version (SDPA computes the output, not
    the log-sum-exp)."""
    fd, ref = T["flash_decode"], T["flash_decode_ref"]
    if partial:
        def fd(q, k, v, p):
            return T["flash_decode_partial"](q, k, v, p)[0]

        def ref(q, k, v, p):
            return T["flash_decode_partial_ref"](q, k, v, p)[0]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, length, kv, g, hd, pos = shape
    q = torch.randn((b, kv, g, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, length, kv, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn((b, length, kv, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    mask = (torch.arange(length, device="cuda") <= pos)[None, None, None, :]

    def library():
        return sdpa(q.reshape(b, kv * g, 1, hd), k.transpose(1, 2),
                    v.transpose(1, 2), attn_mask=mask, enable_gqa=True)
    got = fd(q, k, v, p)
    lib_diff = (library().reshape(got.shape).float()
                - got.float()).abs().max().item()
    check(lib_diff <= 2.0**-6 * got.float().abs().max().item(),
          f"SDPA agrees with the kernel: {lib_diff}")
    med, runs, held = _timed({
        "kernel": lambda: fd(q, k, v, p),
        "plain": lambda: ref(q, k, v, pos),
        "library": library}, length < 4096, cycles_per_ms)
    bnd, by = flash_bound_ms(b, length, kv, g, hd, pos, 2)
    plan = T["flash_launch_plan"](q, k)
    row = {"shape": [b, length, kv, g, hd], "pos": pos, "dtype": "bf16",
           "partial": partial, "ms": med["kernel"], "plain_ms": med["plain"],
           "library_ms": med["library"],
           "library": "F.scaled_dot_product_attention(enable_gqa=True,"
                      " boolean mask)",
           "library_max_abs_diff": lib_diff, "bound_ms": bnd,
           "bound_by": by, "plan": plan, "sleep_held": held,
           "device_runs_ms": runs}
    earlier = EARLIER_MS.get(("flash_decode", (b, length, kv, g, hd)))
    print(f"  flash_decode{'_partial' if partial else ''} ({b}, {length}, "
          f"{kv}, {g}, {hd}) bf16 pos "
          f"{pos}: {plan['stages']} stages, {plan['nsplit']} splits of "
          f"{plan['chunk']} positions, {plan['blocks_per_sm']} blocks "
          f"an SM; device ms per call: kernel {med['kernel']!r}"
          + (f" (earlier design {earlier['ms']!r}, {earlier['method']})"
             if earlier else "")
          + f", plain {med['plain']!r}, SDPA {med['library']!r} (max |diff| "
          f"{lib_diff!r}), bound {bnd!r} ({by}); device runs: "
          f"{json.dumps(runs)}")
    for name, ok in held.items():
        if not ok:
            print(f"    {name}: the sleep did not outlast the host's "
                  f"issuing, so its device ms include the host's pace")
    del q, k, v
    torch.cuda.empty_cache()
    return row


def serve_phase(T: dict, counters) -> dict:
    phase(13, "LM serving: granite-8b at full width and full depth, bf16")
    Tm = T["transformer"]
    cfg = T["get_config"]("granite-8b")
    check(cfg.num_layers == 36 and cfg.dtype == "bfloat16",
          "granite-8b: 36 layers, bf16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Tm.init_model(cfg,
                           generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    out = {"params": T["param_count"](params),
           "init_s": time.perf_counter() - t0,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"  granite-8b, {cfg.num_layers} layers: {out['params']:,} "
          f"parameters, init {out['init_s']:.1f} s, init peak "
          f"{out['init_peak_gb']!r} GB")
    torch.cuda.empty_cache()
    out["fixed_batch"] = serve_fixed_phase(T, cfg, params, counters)
    out["decode_32k"] = serve_long_phase(T, cfg, params, counters)
    out["engine"] = serve_engine_phase(T, cfg, params, counters)
    del params
    torch.cuda.empty_cache()
    out["reduced_f32"] = serve_card_vs_cpu(T, counters)
    out["flash_decode"] = flash_phase(T, sleep_cycles_per_ms())
    return out


def serve_row(serve: dict, archs: dict, ssm: dict, cross: dict,
              placed: dict, long: dict, audited: dict) -> dict:
    """The kernels line's row of ``flash_decode``, timed at decode_32k;
    its shapes also at the head dims of phase 17's architectures, of
    zamba2's shared attention (phase 19) and of the cross archs (phase
    20), and its partial launches at phase 24's slices; its launches also
    on phase 23's placed decode, phase 24's decodes and phase 25's."""
    by_path = {
        "serve_fixed_batch": serve["fixed_batch"]["launches"]["flash_decode"],
        "serve_decode_32k": serve["decode_32k"]["launches"]["flash_decode"],
        "serve_engine": serve["engine"]["launches"]["flash_decode"]}
    for arch in ARCHS:
        row = archs[arch]
        by_path[f"archs_{arch}"] = row["launches"]["flash_decode"]
        if arch == "gemma3-12b":
            by_path["archs_gemma3-12b_ring"] = \
                row["ring"]["launches"]["flash_decode"]
            by_path["archs_gemma3-12b_engine"] = \
                row["engine"]["launches"]["flash_decode"]
    for arch in SSM_ARCHS:
        by_path[f"ssm_{arch}"] = ssm[arch]["launches"]["flash_decode"]
    by_path["ssm_zamba2-2.7b_routes"] = \
        ssm["zamba2-2.7b"]["routes"]["launches"]["flash_decode"]
    by_path["ssm_zamba2-2.7b_engine"] = \
        ssm["zamba2-2.7b"]["engine"]["launches"]["flash_decode"]
    for arch in CROSS_ARCHS:
        by_path[f"cross_{arch}"] = cross[arch]["launches"]["flash_decode"]
        by_path[f"cross_{arch}_routes"] = \
            cross[arch]["routes"]["launches"]["flash_decode"]
        by_path[f"cross_{arch}_engine"] = \
            cross[arch]["engine"]["launches"]["flash_decode"]
    for key, run in placed["serve"].items():
        by_path[f"build_step_serve_{key}"] = run["launches"]["flash_decode"]
    for key in ("a", "b", "c", "c_held"):
        by_path[f"long_500k_{key}"] = long[key]["launches"]["flash_decode"]
    by_path["long_500k_b_nccl"] = \
        long["b"]["nccl"]["launches"]["flash_decode"]
    by_path["audit_decode"] = audited["c"]["launches"]["flash_decode"]
    by_path["audit_launch_meta"] = audited["d"]["launches"]["flash_decode"]
    timed = (serve["flash_decode"]["timed"] + archs["flash_decode"]
             + ssm["flash_decode"] + cross["flash_decode"] + long["timed"])
    at = serve["flash_decode"]["timed"][-1]
    return {
        "name": "flash_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:116",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max([serve["flash_decode"]["max_abs_err"]] + [
            h["max_abs_err"] for arch in ARCHS
            for h in archs[arch]["flash_held"]] + [
            h["max_abs_err"] for h in ssm["zamba2-2.7b"]["flash_held"]] + [
            h["max_abs_err"] for arch in CROSS_ARCHS
            for h in cross[arch]["flash_held"]] + [
            run["flash_max_abs_err"] for run in placed["serve"].values()] + [
            long[key]["flash_max_abs_err"] for key in ("a", "c")]),
        "ms": at["ms"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": at["library_ms"],
        "library": at["library"],
        "plan": at["plan"],
        "at": at["shape"],
        "shapes": timed,
        "ok": True,
    }


# the switching slice: the LM launcher's --autoswitch (W = 4, the launcher's
# 120 local batches on the strained plan), the reference's 8-step swap
# schedule, its int8 re-entry case over 48 batches, the demo CLI (240
# batches) and the benches
SWITCH_W, SWITCH_BATCHES, SWITCH_CHAOS_BATCHES = 4, 120, 48
SWITCH_PEAK_GB = 70.0
SWITCH_HOLD_ATOL = 1e-5    # psum against fused in float32: sum orders
# the reference's CLI on the CPU (repro.launch.switch_driver --host-devices
# 4 --workers 4 --batches 240 --plan strained --mode auto --compare-sync
# --json, jax 0.9.0)
REF_STRAINED = {"wall_time": 3.0, "num_global_steps": 60, "switch_count": 1,
                "time_to_first_switch_steps": 4,
                "mode_steps": {"sync": 4, "gba": 56}, "crashes": 1,
                "rejoins": 1, "lost_batches": 1, "tombstones": 1,
                "swaps_verified": 1, "sync_timeouts": 1, "sync_rejoins": 1,
                "speedup_vs_sync": 2.5005865516398864}
REF_STRAINED_LOSS = 0.7912495732307434
SIM_FIELDS = ("wall_time", "samples", "num_global_steps", "switch_count",
              "time_to_first_switch_steps", "mode_timeline", "mode_steps",
              "mode_time", "crashes", "rejoins", "timeouts", "lost_batches",
              "dropped_batches", "tombstones", "drained", "stalled_barriers",
              "apply_failures", "breaker_trips", "dropped_scrapes",
              "swaps_verified", "warm_steps", "controller_summary", "qps")


def sim_fields(out) -> str:
    """A result's simulated-clock and fault fields as one string."""
    out = out if isinstance(out, dict) else out.to_json()
    return json.dumps({k: out[k] for k in SIM_FIELDS if k in out},
                      sort_keys=True)


def swap_schedule(T: dict, iota: int) -> list:
    """The reference's 8-step replay (``tests/test_switch_driver.py``):
    step 5 holds one Eq. (1)-decayed slot and one tombstone."""
    steps, b = [], 0
    for k in range(8):
        toks, bats = [k] * 4, list(range(b, b + 4))
        b += 4
        if k == 5:
            toks[1], toks[2], bats[2] = 0, k - iota - 1, -1
        steps.append(T["SD"].GlobalStep(tuple(toks), tuple(bats)))
    return steps


SWITCHED = ["sync"] * 3 + ["gba"] * 3 + ["sync"] * 2


class SwitchProbe:
    """While entered, every global step and every swap of every
    ``SwitchDriver`` runs between two synchronisations: each step's host
    seconds and kernel launches and each swap's seconds are recorded, the
    ``profile`` steps ((mode, index in that mode) pairs) are profiled, and
    ``holds`` is active for global step ``hold_gstep`` alone."""

    def __init__(self, T: dict, counters, profile=(), holds=None,
                 hold_gstep=None):
        self.D, self.counters = T["SD"].SwitchDriver, counters
        self.profile, self.holds, self.hold_gstep = profile, holds, hold_gstep
        self.steps, self.swaps, self.profiles = [], [], {}

    def take(self) -> tuple[list, list]:
        out = self.steps, self.swaps
        self.steps, self.swaps = [], []
        return out

    def _n(self) -> tuple:
        c = self.counters()
        return c["quantize_minmax"], c["dequantize"], c["gba_apply"]

    def __enter__(self):
        probe = self
        self.real = self.D._exec, self.D._swap
        real_exec, real_swap = self.real

        def _exec(drv, st, tokens, slot_batches):
            comp = drv.compress
            warm = (comp is not None and st.mode == "gba"
                    and st.warm_count < comp.warmup_steps)
            kind = st.mode if st.mode == "sync" or comp is None else (
                "gba/warm" if warm else "gba/int8")
            index = sum(1 for s in probe.steps if s["mode"] == st.mode)
            prof = (StepProfile() if (st.mode, index) in probe.profile
                    else None)
            if probe.holds is not None:
                probe.holds.active = st.gstep == probe.hold_gstep
            torch.cuda.synchronize()
            n0, t0 = probe._n(), time.perf_counter()
            if prof is not None:
                prof.start()
            loss = real_exec(drv, st, tokens, slot_batches)
            if prof is not None:
                probe.profiles[f"{st.mode} step {index}"] = prof.stop()
            torch.cuda.synchronize()
            n1 = probe._n()
            probe.steps.append({
                "mode": st.mode, "kind": kind, "gstep": st.gstep,
                "seconds": time.perf_counter() - t0, "loss": loss,
                **dict(zip(("quantize_minmax", "dequantize", "gba_apply"),
                           (b - a for a, b in zip(n0, n1))))})
            if probe.holds is not None:
                probe.holds.active = False
            return loss

        def _swap(drv, st, new_mode, controller=None):
            old = st.mode
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_swap(drv, st, new_mode, controller)
            torch.cuda.synchronize()
            if new_mode != old:
                probe.swaps.append({"swap": f"{old}->{new_mode}",
                                    "gstep": st.gstep,
                                    "seconds": time.perf_counter() - t0})

        self.D._exec, self.D._swap = _exec, _swap
        return self

    def __exit__(self, *exc):
        self.D._exec, self.D._swap = self.real


def _per_mode(steps: list) -> dict:
    out = {}
    for s in steps:
        out.setdefault(s["kind"], []).append(s["seconds"])
    return {k: {"steps": len(v), "median_s": float(np.median(v)),
                "max_s": max(v)} for k, v in out.items()}


def switch_launcher(T: dict, counters, cfg, params) -> dict:
    """(a) ``run_autoswitch`` as ``launch.train --arch granite-8b --mesh
    4x1 --autoswitch --plan strained`` runs it, then its forced-sync leg;
    each against the same runs on the CPU at ``granite-8b.reduced()``."""
    kw = dict(workers=SWITCH_W, plan="strained", batches=SWITCH_BATCHES,
              batch=LM_BATCH, seq=LM_SEQ, iota=LM_IOTA, lr=LM_LR)
    probe = SwitchProbe(T, counters, profile=(("sync", 1), ("gba", 12)))
    with probe:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters(reset=True)
        t0 = time.perf_counter()
        auto = T["train"].run_autoswitch(cfg, device="cuda", params=params,
                                         **kw)
        torch.cuda.synchronize()
        auto_s = time.perf_counter() - t0
        launches = counters()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        auto_steps, auto_swaps = probe.take()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sync = T["train"].run_autoswitch(cfg, device="cuda", params=params,
                                         mode="sync", **kw)
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
        sync_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        sync_steps, _ = probe.take()
    small = T["get_config"]("granite-8b").reduced()
    host = {m: T["train"].run_autoswitch(small, device="cpu", mode=m, **kw)
            for m in ("auto", "sync")}
    for name, card in (("auto", auto), ("sync", sync)):
        check(sim_fields(card) == sim_fields(host[name]),
              f"(a) {name}: every simulated field equal to the CPU run at "
              f"granite-8b.reduced(): {sim_fields(card)} vs "
              f"{sim_fields(host[name])}")
    check(auto.switch_count >= 1 and auto.swaps_verified >= 1,
          f"(a) a switch and a verified swap: {auto.switch_count}, "
          f"{auto.swaps_verified}")
    for s in auto_steps + sync_steps:
        want = SWITCH_W if s["mode"] == "gba" else 0
        check(s["gba_apply"] == want and s["quantize_minmax"] == 0
              and s["dequantize"] == 0,
              f"(a) {want} gba_apply launches at a {s['mode']} step: {s}")
    check(launches["gba_apply"] == SWITCH_W * auto.mode_steps.get("gba", 0),
          f"(a) gba_apply launches {launches['gba_apply']} == W x async "
          f"global steps")
    check(max(peak_gb, sync_peak_gb) < SWITCH_PEAK_GB,
          f"(a) peak device memory {peak_gb:.2f} / {sync_peak_gb:.2f} GB < "
          f"{SWITCH_PEAK_GB} GB")
    idle = {k: v.get("idle_share") for k, v in probe.profiles.items()}
    out = {"auto": auto.to_json(), "sync": sync.to_json(),
           "auto_s": auto_s, "sync_s": sync_s, "launches": launches,
           "peak_gb": peak_gb, "sync_peak_gb": sync_peak_gb,
           "step_s": _per_mode(auto_steps), "sync_leg_step_s":
           _per_mode(sync_steps), "swaps": auto_swaps,
           "profiles": probe.profiles, "idle_share": idle,
           "cpu_reduced": {m: r.to_json() for m, r in host.items()}}
    shown = ("auto_s", "sync_s", "launches", "peak_gb", "sync_peak_gb",
             "step_s", "sync_leg_step_s", "swaps", "idle_share")
    print(f"  (a) {json.dumps({k: out[k] for k in shown})}")
    return out


def _lm_driver(T: dict, cfg, params, impl: str, compress=None, spec=None,
               plan=None, world=None):
    stream = T["make_lm_stream"](cfg.vocab_size, LM_SEQ, LM_BATCH, seed=0)
    SD = T["SD"]
    return SD.SwitchDriver(
        SWITCH_W, T["make_loss_fn"](cfg), params,
        spec=spec or SD.demo_spec(SWITCH_W),
        plan=plan or T["FaultPlan"].quiet(SWITCH_W),
        cfg=SD.SwitchConfig(local_batch=LM_BATCH, iota=LM_IOTA, lr=LM_LR,
                            sync_impl=impl),
        batch_fn=stream.batch,
        group_by=T["param_group_key"], compress=compress,
        world=world or T["inprocess"])


def _flat_bits_equal(a, b) -> bool:
    return all(np.array_equal(x.view(np.int32), y.view(np.int32))
               for x, y in ((a.param_flat, b.param_flat),
                            (a.accum_flat, b.accum_flat)))


def switch_parity(T: dict, counters, cfg, params) -> dict:
    """(b) the reference's 8-step schedule at full width: the fused
    replays bit for bit, the psum replay's swaps verified; then psum
    against fused within ``SWITCH_HOLD_ATOL`` at ``granite-8b.reduced()``
    in float32 and on the demo model, on the card."""
    steps = swap_schedule(T, LM_IOTA)
    probe = SwitchProbe(T, counters)
    seconds = {}
    with probe:
        fused = _lm_driver(T, cfg, params, "fused")
        t0 = time.perf_counter()
        sw = fused.run_schedule(steps, SWITCHED)
        seconds["fused switched"] = time.perf_counter() - t0
        _, swaps = probe.take()
        for name, modes in (("gba", ["gba"] * 8), ("sync", ["sync"] * 8)):
            t0 = time.perf_counter()
            un = fused.run_schedule(steps, modes)
            seconds[f"fused {name}"] = time.perf_counter() - t0
            check(_flat_bits_equal(sw, un) and np.array_equal(
                np.float32(sw.losses).view(np.int32),
                np.float32(un.losses).view(np.int32)),
                  f"(b) switched fused replay bit-identical to the all-{name} "
                  f"replay: params, accumulator, every loss")
            del un
        del fused
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ps = _lm_driver(T, cfg, params, "psum").run_schedule(steps,
                                                            SWITCHED)
        seconds["psum switched"] = time.perf_counter() - t0
        psum_peak = torch.cuda.max_memory_allocated() / 1e9
        _, psum_swaps = probe.take()
    check(sw.switch_count == 2 and sw.dropped_batches == 1
          and sw.tombstones == 1, "(b) 2 swaps, 1 decayed slot, 1 tombstone")
    check(ps.swaps_verified == 2, f"(b) psum swaps verified "
          f"{ps.swaps_verified} == 2")
    dev = {"param": float(np.abs(ps.param_flat - sw.param_flat).max()),
           "accum": float(np.abs(ps.accum_flat - sw.accum_flat).max())}
    del sw, ps
    held = {}
    small = dataclasses.replace(T["get_config"]("granite-8b").reduced(),
                                dtype="float32")
    sp = T["init_model"](small, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    f = _lm_driver(T, small, sp, "fused").run_schedule(steps, SWITCHED)
    p = _lm_driver(T, small, sp, "psum").run_schedule(steps, SWITCHED)
    held["granite-8b.reduced() f32"] = (f, p)
    SD = T["SD"]
    dp, loss_fn, group_by = SD.demo_model(device="cuda")
    demo = {impl: SD.SwitchDriver(
        SWITCH_W, loss_fn, dp, spec=SD.demo_spec(SWITCH_W),
        plan=T["FaultPlan"].quiet(SWITCH_W),
        cfg=SD.SwitchConfig(local_batch=8, iota=4, sync_impl=impl),
        batch_fn=SD.demo_batch_fn(8), group_by=group_by).run_schedule(
            steps, SWITCHED) for impl in ("fused", "psum")}
    held["demo"] = (demo["fused"], demo["psum"])
    small_dev = {}
    for name, (f, p) in held.items():
        d = max(float(np.abs(p.param_flat - f.param_flat).max()),
                float(np.abs(p.accum_flat - f.accum_flat).max()))
        check(p.swaps_verified == 2 and d <= SWITCH_HOLD_ATOL,
              f"(b) {name}: psum within {SWITCH_HOLD_ATOL} of fused "
              f"({d:.3g}), 2 swaps verified")
        small_dev[name] = d
    out = {"seconds": seconds, "fused_swaps": swaps, "psum_swaps": psum_swaps,
           "psum_vs_fused_full_width_bf16": dev, "psum_peak_gb": psum_peak,
           "psum_vs_fused_small": small_dev}
    print(f"  (b) {json.dumps(out)}")
    return out


def switch_reentry(T: dict, counters, cfg, params) -> dict:
    """(c) the reference's chaos case (c) at full width: int8 with 2
    warmup steps, sync for g < 2 and 6 <= g < 8, gba otherwise, over 48
    batches; the first compressed step of the second async entry held bit
    for bit."""
    pol = T["CompressionPolicy"](scheme="int8", warmup_steps=2)
    drv = _lm_driver(T, cfg, params, "fused", compress=pol,
                     spec=T["ClusterSpec"](num_workers=SWITCH_W, jitter=0.05,
                                           seed=0))
    groups = drv.layout.num_groups
    holds = Holds(T)
    probe = SwitchProbe(T, counters, holds=holds, hold_gstep=10)
    with holds, probe:
        torch.cuda.reset_peak_memory_stats()
        counters(reset=True)
        res = drv.run(SWITCH_CHAOS_BATCHES, seed=0, mode_schedule=lambda g:
                      "sync" if g < 2 or 6 <= g < 8 else "gba")
        torch.cuda.synchronize()
        launches = counters()
        steps, swaps = probe.take()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del drv
    check(res.warm_steps == 4 and res.switch_count == 3,
          f"(c) warm steps {res.warm_steps} == 4, swaps {res.switch_count} "
          f"== 3")
    # sync here is the shared flat state's step with fresh tokens
    want = {"sync": (0, 0, SWITCH_W), "gba/warm": (0, 0, SWITCH_W),
            "gba/int8": (SWITCH_W * groups, SWITCH_W * groups, SWITCH_W)}
    for s in steps:
        got = (s["quantize_minmax"], s["dequantize"], s["gba_apply"])
        check(got == want[s["kind"]], f"(c) {s['kind']} step {s['gstep']}: "
              f"(quantize_minmax, dequantize, gba_apply) {got} == "
              f"{want[s['kind']]}")
    check([s["gstep"] for s in steps if s["kind"] == "gba/int8"]
          == [4, 5, 10, 11], f"(c) compressed steps {steps}")
    seen = sorted(set(holds.seen))
    for name in ("quantize_minmax", "dequantize", "gba_apply"):
        check(any(n == name for n, _ in seen),
              f"(c) {name} held bit for bit at gstep 10")
    check(all(np.isfinite(res.losses)), f"(c) finite losses {res.losses}")
    out = {"result": res.to_json(), "launches": launches, "held": seen,
           "max_abs_err": holds.max_err, "step_s": _per_mode(steps),
           "swaps": swaps, "peak_gb_with_holds": peak, "groups": groups}
    print(f"  (c) {json.dumps(out)}")
    return out


def switch_cli(T: dict) -> dict:
    """(d) the demo CLI on the card (both plans, through the Fig. 6
    bench's spawn) against the same CLI on the CPU and the reference's
    numbers; the breaker and scrape-dropout chaos cases card against
    CPU."""
    t0 = time.perf_counter()
    results = T["fig6"].switching_results("cuda")
    cli_s = time.perf_counter() - t0
    card = results["strained"][0]
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.switch_driver",
         "--workers", "4", "--batches", "240", "--plan", "strained",
         "--mode", "auto", "--compare-sync", "--json", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env)
    check(proc.returncode == 0, f"(d) the CPU CLI ran: {proc.stderr[-2000:]}")
    host = json.loads(proc.stdout.strip().splitlines()[-1])
    check(sim_fields(card) == sim_fields(host),
          f"(d) card CLI's simulated fields equal the CPU's")
    for k, v in REF_STRAINED.items():
        check(card[k] == v, f"(d) {k} {card[k]} == the reference's {v}")
    check(abs(card["final_loss"] / REF_STRAINED_LOSS - 1) <= 1e-5,
          f"(d) final loss {card['final_loss']} within 1e-5 of the "
          f"reference's {REF_STRAINED_LOSS}")
    SD, FP = T["SD"], T["FaultPlan"]
    spec = T["ClusterSpec"](num_workers=4, jitter=0.05, seed=0)
    chaos = {}
    for name in ("breaker", "dropout"):
        runs = {}
        for dev in ("cuda", "cpu"):
            dp, loss_fn, group_by = SD.demo_model(device=dev)
            plan = (FP(4, apply_failures=(0, 1, 2)) if name == "breaker" else
                    FP(4, stragglers=(T["StragglerWindow"](0, 4.0),),
                       dropouts=(T["ScrapeDropout"](0.0, float("inf")),)))
            drv = SD.SwitchDriver(4, loss_fn, dp, spec=spec, plan=plan,
                                  cfg=SD.SwitchConfig(local_batch=8,
                                                      sync_impl="fused"),
                                  batch_fn=SD.demo_batch_fn(8),
                                  group_by=group_by)
            runs[dev] = drv.run(48, mode="gba" if name == "breaker" else
                                "auto", seed=0)
        check(sim_fields(runs["cuda"]) == sim_fields(runs["cpu"]),
              f"(d) {name}: card equal to the CPU")
        chaos[name] = runs["cuda"].to_json()
    b, d = chaos["breaker"], chaos["dropout"]
    check(b["breaker_trips"] == 1 and b["apply_failures"] == 3
          and b["mode_steps"] == {"sync": 9} and b["num_global_steps"] == 9
          and b["drained"] == 4, f"(d) breaker as the reference's: {b}")
    check(d["switch_count"] == 0 and d["dropped_scrapes"] > 0,
          f"(d) dropout holds the mode as the reference's: {d}")
    out = {"card": card, "cpu": host, "cli_s": cli_s, "chaos": chaos,
           "results": results}
    print(f"  (d) strained on the card: {json.dumps(card)}; both plans' "
          f"subprocesses {cli_s:.1f} s")
    return out


def switch_benches(T: dict, results: dict) -> dict:
    """(e) the Fig. 6 bench (its continual protocol at the reference's
    defaults, and the switching rows) and the autoswitch bench."""
    rows = T["fig6"].switching_rows(results)
    strained = results["strained"][0]
    check(strained["speedup_vs_sync"] >= 2.0,
          f"(e) strained speedup_vs_sync {strained['speedup_vs_sync']} >= 2")
    t0 = time.perf_counter()
    fig6 = T["fig6"].run(device="cuda")
    torch.cuda.synchronize()
    fig6_s = time.perf_counter() - t0
    # the replay's idle share: one GBA day of the protocol's setup
    cfg = T["CRITEO_DEEPFM"]
    stream = T["make_clickstream"](cfg, seed=0, batches_per_day=48,
                                   batch_size=256, num_days=2)
    base = T["init_recsys"](cfg, generator=torch.Generator().manual_seed(0),
                            device="cuda")
    setups = T["default_setups"](base_global=2048)
    spec = T["ClusterSpec"](num_workers=16, straggler_frac=0.25,
                            straggler_slowdown=5.0, jitter=0.2, seed=0)
    busy = device_busy(lambda: T["run_continual"](
        base, cfg, stream, ["gba"], setups, spec, eval_batches=16))
    t0 = time.perf_counter()
    auto_rows = T["bench_autoswitch"].run()
    auto_s = time.perf_counter() - t0
    for r in rows + fig6 + auto_rows:
        print(f"  {r}")
    print(f"  (e) fig6 continual protocol {fig6_s:.1f} s, one GBA day's "
          f"profile {json.dumps(busy)}; autoswitch bench {auto_s:.1f} s")
    return {"switching_rows": rows, "fig6_rows": fig6, "fig6_s": fig6_s,
            "replay_day_profile": busy, "autoswitch_rows": auto_rows,
            "autoswitch_s": auto_s}


def switch_phase(T: dict, counters) -> dict:
    phase(14, f"tuning-free switching: granite-8b at full width, depth "
              f"{LM_LAYERS}, {SWITCH_W} workers; the swap schedule, the int8 "
              f"re-entry, the demo CLI and the benches")
    cfg = dataclasses.replace(T["get_config"]("granite-8b"),
                              num_layers=LM_LAYERS)
    t_phase = time.perf_counter()
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    out = {"config": {"arch": cfg.name, "num_layers": LM_LAYERS,
                      "reduced": "num_layers 36 -> 2", "workers": SWITCH_W,
                      "batch": LM_BATCH, "seq": LM_SEQ, "iota": LM_IOTA,
                      "lr": LM_LR, "batches": SWITCH_BATCHES,
                      "plan": "strained"}}
    out["launcher"] = switch_launcher(T, counters, cfg, params)
    torch.cuda.empty_cache()
    out["parity"] = switch_parity(T, counters, cfg, params)
    torch.cuda.empty_cache()
    out["reentry"] = switch_reentry(T, counters, cfg, params)
    del params
    torch.cuda.empty_cache()
    out["cli"] = switch_cli(T)
    out["benches"] = switch_benches(T, out["cli"].pop("results"))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 14: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the paper's three tasks
# ---------------------------------------------------------------------------

def _tree_close(card: dict, host: dict, rtol: float, atol: float,
                prefix: str = "") -> list[str]:
    """The leaves of a card parameter tree not within tolerance of the
    CPU tree's."""
    bad = []
    for k, v in card.items():
        if isinstance(v, dict):
            bad += _tree_close(v, host[k], rtol, atol, f"{prefix}{k}/")
        elif not torch.allclose(v.cpu(), host[k], rtol=rtol, atol=atol):
            bad.append(prefix + k)
    return bad


def _strip_us(row: str) -> str:
    name, _, derived = row.split(",", 2)
    return f"{name},{derived}"


def _derived(row: str) -> dict:
    return dict(kv.split("=", 1) for kv in row.split(",", 2)[2].split(";"))


def task_replay(T: dict, counters, cfg) -> dict:
    """(a) one model: the first GBA global steps and the stale schedule
    card against CPU, then a counted GBA day and its profile."""
    host = T["jax_init_recsys"](cfg, 0, device="cpu")
    card = T["tree_to_device"](host, torch.device("cuda"))
    setup = T["ModeSetup"]("gba", 16, TASK_LOCAL_BATCH, buffer_size=16,
                           iota=4)
    stream = T["make_clickstream"](cfg, seed=0, batch_size=TASK_LOCAL_BATCH)
    sched = T["schedule_for_day"](setup, T["quickstart"].SPEC, TASK_BATCHES)

    def trainer():
        return T["GBATrainer"](cfg, T["get_optimizer"]("adam", TASK_LR),
                               iota=setup.iota)

    head = T["Schedule"](sched.mode, sched.local_batch,
                         sched.steps[:HOLD_STEPS])
    runs = {}
    for dev, p in (("cuda", card), ("cpu", host)):
        tr = trainer()
        runs[dev] = tr.replay(p, tr.optimizer.init(p), head, stream, 0)
    _hold(f"{cfg.name} GBA head", runs["cuda"], runs["cpu"], HOLD_LOSS_RTOL)
    head_diff = _max_diff(runs["cuda"][0], runs["cpu"][0])

    slot = T["Slot"]
    stale = T["Schedule"]("gba", 32, [
        [slot(k * 3 + i, max(0, k - i), k, 1.0 if i < 2 else 0.0)
         for i in range(3)] for k in range(4)])
    stale_stream = T["make_clickstream"](cfg, seed=0, batches_per_day=16,
                                         batch_size=32)
    runs = {}
    for dev, p in (("cuda", card), ("cpu", host)):
        opt = T["get_optimizer"]("sgd", 0.05)
        runs[dev] = T["GBATrainer"](cfg, opt, iota=1).replay(
            p, opt.init(p), stale, stale_stream, 0)
    _hold(f"{cfg.name} stale schedule", runs["cuda"], runs["cpu"], 1e-5)
    check(runs["cuda"][3].embed_rows_rescued > 0
          and runs["cuda"][3].dropped_slots > 0,
          f"{cfg.name}: the stale schedule drops slots and rescues rows")
    bad = _tree_close(runs["cuda"][0], runs["cpu"][0], STALE_PARAM_RTOL,
                      STALE_PARAM_ATOL)
    check(not bad, f"{cfg.name} stale schedule: parameters within rtol "
                   f"{STALE_PARAM_RTOL} atol {STALE_PARAM_ATOL}: {bad}")
    stale_diff = _max_diff(runs["cuda"][0], runs["cpu"][0])

    # the counted GBA day
    counters(reset=True)
    tr = trainer()
    t0 = time.perf_counter()
    params, _, _, st = tr.replay(card, tr.optimizer.init(card), sched,
                                 stream, 0)
    torch.cuda.synchronize()
    day_s = time.perf_counter() - t0
    launches = counters()
    steps = len(sched.steps)
    check(st.applied_steps == steps, f"{cfg.name}: {steps} global steps")
    check(launches["embedding_bag_grad"] == steps,
          f"{cfg.name}: one embedding_bag_grad launch per global step: "
          f"{launches['embedding_bag_grad']} for {steps}")
    ids = (setup.buffer_size * TASK_LOCAL_BATCH
           * (cfg.num_fields + cfg.behavior_len + 1))
    auc = T["evaluate"](params, cfg, stream, 1, 12)
    tr = trainer()
    busy = device_busy(lambda: tr.replay(card, tr.optimizer.init(card),
                                         sched, stream, 0))
    out = {"model": cfg.name, "steps": steps, "day_s": day_s,
           "data_s": st.data_s, "step_s": st.step_s,
           "other_s": day_s - st.data_s - st.step_s, "launches": launches,
           "ids_per_launch": ids, "stats": _stats(st),
           "first_loss": st.losses[0], "last_loss": st.losses[-1],
           "next_day_auc": auc, "head_max_param_diff": max(head_diff.values()),
           "stale_max_param_diff": max(stale_diff.values()),
           "profile": busy}
    print(f"  (a) {cfg.name}: first {HOLD_STEPS} GBA steps and the stale "
          f"schedule card vs CPU held (stats, last_update exact; largest "
          f"parameter difference {out['head_max_param_diff']!r} / "
          f"{out['stale_max_param_diff']!r}); a GBA day of {steps} global "
          f"steps {day_s:.3f} s (data {st.data_s:.3f}, steps "
          f"{st.step_s:.3f}), {launches['embedding_bag_grad']} "
          f"embedding_bag_grad launches of {ids} ids, next-day AUC "
          f"{auc:.4f}; profile {json.dumps(busy)}")
    return out


def task_benches(T: dict, counters) -> dict:
    """(b) the six benches at the reference's defaults on the card."""
    benches = T["benches"]
    out, seconds = {}, {}
    counters(reset=True)
    for name in ("tab52_qps", "convergence", "multitask", "decay_ablation",
                 "fig3_grad_distribution", "fig78_batch_ablation"):
        fn = benches[name].run
        t0 = time.perf_counter()
        rows = (fn() if name in ("tab52_qps", "convergence")
                else fn(device="cuda"))
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        out[name] = rows
        for r in rows:
            print(f"  {r}")
        print(f"  (b) {name}: {seconds[name]:.1f} s")
    launches = counters()
    check([_strip_us(r) for r in out["convergence"][:-1]]
          == list(REF_CONVERGENCE_ROWS)
          and out["convergence"][-1].startswith("thm.done,"),
          "(b) convergence rows equal the reference's")
    check([_strip_us(r) for r in out["tab52_qps"]] == list(REF_TAB52_ROWS),
          "(b) tab52_qps rows equal the reference's")
    for row in out["multitask"][:-1]:
        name = row.split(",")[0].split(".", 1)[1]
        got = _derived(row)
        for k, want in REF_MULTITASK[name].items():
            check(abs(float(got[k]) - want) <= MULTITASK_ATOL,
                  f"(b) multitask {name} {k} {got[k]} within "
                  f"{MULTITASK_ATOL} of the JAX bench's {want}")
        check(got["tuning_free"] == "PASS",
              f"(b) multitask {name}: tuning_free={got['tuning_free']}")
    check(launches["embedding_bag_grad"] > 0,
          "(b) the benches' replays launched embedding_bag_grad")
    return {"rows": out, "seconds": seconds, "launches": launches}


def tasks_phase(T: dict, counters) -> dict:
    phase(15, "the paper's three tasks: DIEN and YouTubeDNN replay at full "
              "width from the reference's draw; the six benches")
    t_phase = time.perf_counter()
    out = {"replay": {cfg.name: task_replay(T, counters, cfg)
                      for cfg in T["task_configs"]}}
    out["benches"] = task_benches(T, counters)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 15: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: the sharded PS: the sharded fused step and the NCCL backend
# ---------------------------------------------------------------------------

SHARD_W = 4                    # PS shards of the sharded fused step
NCCL_STEPS, NCCL_WARMUP = 3, 2  # the NCCL wire run: 2 warm, 1 compressed
HOST_CHUNK = 1 << 28           # elements a host comparison moves at a time


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` (either on the card or the host) hold the
    same bits, compared on ``a``'s device a chunk at a time."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = _bits_of(a).reshape(-1), _bits_of(b).reshape(-1)
    return all(torch.equal(x, y.to(x.device))
               for x, y in zip(a.split(HOST_CHUNK), b.split(HOST_CHUNK)))


def _accum_leaves(layout, accum: torch.Tensor) -> list:
    """The accumulator's float32 leaves, as views where the layout keeps
    a leaf in one run (a ``FlatLayout``) and copies where it does not."""
    if hasattr(layout, "num_shards"):
        return layout.leaves(layout.unravel(accum, torch.float32))
    return [accum[o:o + n].view(s) for o, n, s in
            zip(layout.offsets, layout.sizes, layout.shapes)]


def sharded_fused_phase(T: dict, counters, lm: dict, kept: list) -> dict:
    """(a) ``build_programs(mode="fused", workers=4)`` at phase 9's size:
    the single-``FlatLayout`` step's params and accumulator after each
    apply kept on the card, then the sharded step from the same params
    and batches held to them bit for bit, 4 ``gba_apply`` launches at each
    apply and none at the fill microsteps; seconds, peak memory and a
    profile of a third global step.  Host copies of the sharded step's
    params (leaves) and accumulator after each apply go to ``kept``, for
    (d)."""
    cfg = dataclasses.replace(T["get_config"]("granite-8b"),
                              num_layers=LM_LAYERS)
    gba = T["GBAConfig"](local_batch=LM_BATCH, buffer_size=LM_M,
                         staleness_tolerance=LM_IOTA)
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    batches = lm_batches(T, cfg.vocab_size, LM_SEQ, LM_BATCH,
                         LM_MICROSTEPS + LM_M, "cuda")
    # the oracle: phase 9's step, its state after each apply kept
    progs = T["build_programs"](cfg, gba, params=params, lr=LM_LR)
    state, want = progs.state, []
    for i in range(LM_MICROSTEPS):
        state, _ = progs.step(state, batches[i], i // LM_M)
        if (i + 1) % LM_M == 0:
            want.append((state["params"], state["accum"].clone()))
    flat_layout = progs.layout
    del progs, state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    progs = T["build_programs"](cfg, gba, params=params, lr=LM_LR,
                                workers=SHARD_W, place_state=False)
    del params
    layout = progs.layout
    check(layout.num_shards == SHARD_W and layout.num_groups > 1,
          f"{SHARD_W} layer-grouped shards")
    print(f"  sharded fused: flat buffer ({LM_M}, {layout.padded_total}) "
          f"over {SHARD_W} shards of {layout.shard_size} (tile "
          f"{layout.tile}, {layout.num_groups} groups, "
          f"{len(layout.sizes)} leaves); peak_gather "
          f"{layout.peak_gather_bytes / 1e9:.3f} GB vs full_gather "
          f"{layout.full_gather_bytes / 1e9:.3f} GB")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, rows = progs.state, []
    counters(reset=True)
    for i in range(LM_MICROSTEPS):
        launched = counters()["gba_apply"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        new, loss = progs.step(state, batches[i], i // LM_M)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launched = counters()["gba_apply"] - launched
        if (i + 1) % LM_M == 0:
            check(launched == SHARD_W,
                  f"microstep {i + 1}: {SHARD_W} gba_apply launches")
            p_want, a_want = want[(i + 1) // LM_M - 1]
            check(all(_same_bits(a, b) for a, b in zip(
                layout.leaves(new["params"]), flat_layout.leaves(p_want))),
                  f"microstep {i + 1}: params bit-identical to the "
                  f"single-FlatLayout step")
            check(all(_same_bits(a, b) for a, b in zip(
                _accum_leaves(layout, new["accum"]),
                _accum_leaves(flat_layout, a_want))),
                  f"microstep {i + 1}: accumulator bit-identical to the "
                  f"single-FlatLayout step")
            kept.append(([x.to("cpu", copy=True)
                          for x in layout.leaves(new["params"])],
                         new["accum"].to("cpu", copy=True)))
        else:
            check(launched == 0 and new["params"] is state["params"],
                  f"microstep {i + 1}: no gba_apply launch, params kept")
        state = new
        rows.append({"microstep": i + 1, "loss": loss.item(),
                     "seconds": seconds, "gba_apply": launched})
    launches = counters()
    counted_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["gba_apply"] == 2 * SHARD_W,
          f"{2 * SHARD_W} gba_apply launches in 2 global steps")
    check(state["buffer"]["step"] == 2, "2 global steps")
    del want, p_want, a_want
    torch.cuda.empty_cache()

    def global_step():
        nonlocal state
        for i in range(LM_MICROSTEPS, LM_MICROSTEPS + LM_M):
            state, _ = progs.step(state, batches[i], i // LM_M)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    busy = device_busy(global_step, match="gba_apply")
    path_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(busy["gba_apply_us"]) == SHARD_W,
          f"{SHARD_W} gba_apply in the profile")
    apply_ms = sum(busy["gba_apply_us"]) / 1e3
    global_s = [sum(r["seconds"] for r in rows[k:k + LM_M])
                for k in range(0, LM_MICROSTEPS, LM_M)]
    lm_global_s = [sum(r["seconds"] for r in lm["microsteps"][k:k + LM_M])
                   for k in range(0, LM_MICROSTEPS, LM_M)]
    out = {"layout": {"padded_total": layout.padded_total,
                      "shard_size": layout.shard_size,
                      "groups": list(layout.group_keys),
                      "leaves": len(layout.sizes)},
           "microsteps": rows, "launches": launches,
           "global_step_s": global_s, "phase9_global_step_s": lm_global_s,
           "fill_microstep_s": [r["seconds"] for r in rows
                                if not r["gba_apply"]],
           "apply_microstep_s": [r["seconds"] for r in rows
                                 if r["gba_apply"]],
           "counted_peak_gb": counted_peak_gb,
           "path_peak_gb": path_peak_gb,
           "phase9_path_peak_gb": lm["path_peak_memory_gb"],
           "apply_device_ms_4_launches": apply_ms,
           "phase9_apply_device_ms": lm["apply_device_ms"],
           "profile": busy, "idle_share": busy["idle_share"]}
    print(f"  (a) sharded fused step: {json.dumps(out)}")
    del state, progs, batches
    torch.cuda.empty_cache()
    return out


def nccl_phase(T: dict, counters, world, dev) -> dict:
    """(b) the wire step at the same size, int8, 2 warm and 1 compressed
    global step: in process (its results kept on the host), then over the
    one-rank NCCL world ``world`` holding all 4 workers, held bit for bit
    (params, accumulator, residual, losses), with the launches of each
    step."""
    cfg = dataclasses.replace(T["get_config"]("granite-8b"),
                              num_layers=LM_LAYERS)
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")

    def run(device, world) -> dict:
        rows, got = [], {}
        marks = {}

        def launches() -> tuple:
            return (T["quantize_minmax"].launches, T["dequantize"].launches,
                    T["gba_apply"].launches)

        def on_step(i, progs):
            torch.cuda.synchronize()
            now, n = time.perf_counter(), launches()
            rows.append({"step": i, "seconds": now - marks["t"],
                         "quantize": n[0] - marks["n"][0],
                         "dequantize": n[1] - marks["n"][1],
                         "gba_apply": n[2] - marks["n"][2]})
            if i == NCCL_STEPS - 1:
                got.update(param_flat=progs.state["param_flat"],
                           accum=progs.state["accum"],
                           residual=progs.wire_state["residual"])
            torch.cuda.synchronize()
            marks["t"], marks["n"] = time.perf_counter(), launches()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters(reset=True)
        marks["t"], marks["n"] = time.perf_counter(), launches()
        losses = T["run_wire_train"](
            cfg, workers=WIRE_W, scheme="int8", steps=NCCL_STEPS,
            batch=LM_BATCH, seq=LM_SEQ, iota=LM_IOTA, lr=LM_LR,
            compress_warmup=NCCL_WARMUP, device=device, params=params,
            on_step=on_step, world=world)
        torch.cuda.synchronize()
        return {"losses": losses, "steps": rows, "launches": counters(),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "state": got}

    local = run("cuda", T["inprocess"])
    host = {k: v.to("cpu") for k, v in local.pop("state").items()}
    torch.cuda.empty_cache()
    nccl = run(dev, world)
    live = nccl.pop("state")
    for name, v in host.items():
        check(_same_bits(live[name], v),
              f"NCCL: {name} bit-identical to the in-process run")
    check(nccl["losses"] == local["losses"],
          f"NCCL: losses equal the in-process run's: {nccl['losses']} vs "
          f"{local['losses']}")
    per_step = [(r["quantize"], r["dequantize"], r["gba_apply"])
                for r in nccl["steps"]]
    groups = len(T["ShardedFlatLayout"].from_params(
        params, WIRE_W, group_by=T["param_group_key"]).group_keys)
    want = ([(0, 0, WIRE_W)] * NCCL_WARMUP
            + [(WIRE_W * groups, WIRE_W * groups, WIRE_W)]
            * (NCCL_STEPS - NCCL_WARMUP))
    check(per_step == want, f"NCCL: launches (quantize, dequantize, "
                            f"gba_apply) per global step {per_step}")
    check(per_step == [(r["quantize"], r["dequantize"], r["gba_apply"])
                       for r in local["steps"]],
          "NCCL: the in-process run's launches")
    del live, host, params
    torch.cuda.empty_cache()
    out = {"in_process": local, "nccl": nccl,
           "compressed_step_s": {"in_process": local["steps"][-1]["seconds"],
                                 "nccl": nccl["steps"][-1]["seconds"]},
           "warm_step_s": {"in_process": local["steps"][1]["seconds"],
                           "nccl": nccl["steps"][1]["seconds"]}}
    print(f"  (b) NCCL wire step, one rank x {WIRE_W} workers: "
          f"{json.dumps(out)}")
    return out


# (c): the strained plan's local batches: 4 sync global steps, the swap to
# async, then 2 float32 warmup and int8 global steps
NCCL_SWITCH_BATCHES = 40


def _kinds(steps: list) -> list:
    return [(s["kind"], s["quantize_minmax"], s["dequantize"],
             s["gba_apply"]) for s in steps]


def switch_nccl_phase(T: dict, counters, world) -> dict:
    """(c) the switching harness at phase 14's size over the one-rank NCCL
    world ``world``, each run beside the same run in process: the
    strained plan (``run(mode="auto")``, ``NCCL_SWITCH_BATCHES`` batches,
    the int8 wire after 2 warm async steps) and the 8-step swap schedule
    (``run_schedule``), both with the psum sync step; every simulated
    field, the final flat params and accumulator and every loss equal, the
    launches of every step (4 ``gba_apply`` an async global step, 16
    quantize and 16 dequantize a compressed one, none a sync one) as in
    process, a swap each way, peak memory under 70 GB."""
    cfg = dataclasses.replace(T["get_config"]("granite-8b"),
                              num_layers=LM_LAYERS)
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    SD = T["SD"]
    cases = {
        "strained": (dict(plan=SD.demo_plan("strained", SWITCH_W),
                          compress=T["CompressionPolicy"](
                              scheme="int8", warmup_steps=2)),
                     lambda d: d.run(NCCL_SWITCH_BATCHES, mode="auto")),
        "schedule": ({}, lambda d: d.run_schedule(swap_schedule(T, LM_IOTA),
                                                  SWITCHED))}
    out, nccl_launches, directions = {}, {}, set()
    for name, (kw, go) in cases.items():
        runs = {}
        for side, w in (("in_process", T["inprocess"]), ("nccl", world)):
            drv = _lm_driver(T, cfg, params, "psum", world=w, **kw)
            groups = drv.layout.num_groups
            probe = SwitchProbe(T, counters)
            with probe:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                counters(reset=True)
                t0 = time.perf_counter()
                res = go(drv)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = counters()
                steps, swaps = probe.take()
            runs[side] = {"result": res, "seconds": seconds,
                          "launches": launches, "steps": steps,
                          "swaps": swaps, "peak_gb":
                          torch.cuda.max_memory_allocated() / 1e9}
            del drv
            torch.cuda.empty_cache()
        loc, nc = runs["in_process"], runs["nccl"]
        check(sim_fields(nc["result"]) == sim_fields(loc["result"]),
              f"(c) {name}: every simulated field of the NCCL run equal to "
              f"the in-process run's: {sim_fields(nc['result'])}")
        check(_flat_bits_equal(nc["result"], loc["result"]) and np.array_equal(
            np.float32(nc["result"].losses).view(np.int32),
            np.float32(loc["result"].losses).view(np.int32)),
              f"(c) {name}: final flat params, accumulator and every loss "
              f"bit-identical to the in-process run")
        want = {"sync": (0, 0, 0), "gba": (0, 0, SWITCH_W),
                "gba/warm": (0, 0, SWITCH_W),
                "gba/int8": (SWITCH_W * groups, SWITCH_W * groups,
                             SWITCH_W)}
        for kind, *got in _kinds(nc["steps"]):
            check(tuple(got) == want[kind], f"(c) {name}: a {kind} step's "
                  f"(quantize_minmax, dequantize, gba_apply) {tuple(got)} "
                  f"== {want[kind]}")
        check(_kinds(nc["steps"]) == _kinds(loc["steps"]),
              f"(c) {name}: every step's launches as in process")
        check(nc["peak_gb"] < SWITCH_PEAK_GB,
              f"(c) {name}: NCCL peak {nc['peak_gb']:.2f} GB < "
              f"{SWITCH_PEAK_GB} GB")
        res = nc["result"]
        if name == "strained":
            check(res.switch_count >= 1 and any(
                s["kind"] == "gba/int8" for s in nc["steps"]),
                  f"(c) strained: a switch and a compressed step: "
                  f"{res.switch_count} switch(es)")
        else:
            check(res.switch_count == 2 and res.swaps_verified == 2,
                  f"(c) schedule: 2 swaps verified, {res.swaps_verified}")
        directions |= {s["swap"] for s in nc["swaps"]}
        for k, v in nc["launches"].items():
            nccl_launches[k] = nccl_launches.get(k, 0) + v
        out[name] = {side: {
            "seconds": r["seconds"], "step_s": _per_mode(r["steps"]),
            "swaps": r["swaps"], "peak_gb": r["peak_gb"],
            "launches": {k: r["launches"][k] for k in (
                "gba_apply", "quantize_minmax", "dequantize")}}
            for side, r in runs.items()}
        out[name]["result"] = res.to_json()
        del runs, loc, nc, res
    check({"sync->gba", "gba->sync"} <= directions,
          f"(c) a swap each way over NCCL: {sorted(directions)}")
    del params
    torch.cuda.empty_cache()
    out["launches"] = nccl_launches
    print(f"  (c) switching over one NCCL rank: {json.dumps(out)}")
    return out


def sharded_fused_nccl_phase(T: dict, counters, world, dev, kept: list,
                             fused: dict) -> dict:
    """(d) the sharded fused step of (a) over the one-rank NCCL world
    ``world`` (all 4 shards and the whole batch, its gradient
    reduce-scattered and its params gathered through NCCL), from the same
    params and batches: params and accumulator bit-identical to (a)'s at
    each apply (``kept``), every loss equal, 4 ``gba_apply`` launches at
    each apply and none at the fill microsteps; seconds per global step
    beside (a)'s."""
    cfg = dataclasses.replace(T["get_config"]("granite-8b"),
                              num_layers=LM_LAYERS)
    gba = T["GBAConfig"](local_batch=LM_BATCH, buffer_size=LM_M,
                         staleness_tolerance=LM_IOTA)
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    batches = lm_batches(T, cfg.vocab_size, LM_SEQ, LM_BATCH, LM_MICROSTEPS,
                         "cuda")
    progs = T["build_programs"](cfg, gba, params=params, lr=LM_LR,
                                workers=SHARD_W, world=world,
                                place_state=False)
    del params
    layout = progs.layout
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, rows = progs.state, []
    counters(reset=True)
    for i in range(LM_MICROSTEPS):
        launched = counters()["gba_apply"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        new, loss = progs.step(state, batches[i], i // LM_M)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launched = counters()["gba_apply"] - launched
        if (i + 1) % LM_M == 0:
            check(launched == SHARD_W,
                  f"(d) microstep {i + 1}: {SHARD_W} gba_apply launches")
            p_host, a_host = kept[(i + 1) // LM_M - 1]
            check(all(_same_bits(a, b) for a, b in zip(
                layout.leaves(new["params"]), p_host)),
                  f"(d) microstep {i + 1}: params bit-identical to (a)'s")
            check(_same_bits(new["accum"], a_host),
                  f"(d) microstep {i + 1}: accumulator bit-identical to "
                  f"(a)'s")
        else:
            check(launched == 0 and new["params"] is state["params"],
                  f"(d) microstep {i + 1}: no gba_apply launch, params kept")
        state = new
        rows.append({"microstep": i + 1, "loss": loss.item(),
                     "seconds": seconds, "gba_apply": launched})
    launches = counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["gba_apply"] == 2 * SHARD_W,
          f"(d) {2 * SHARD_W} gba_apply launches in 2 global steps")
    check([r["loss"] for r in rows]
          == [r["loss"] for r in fused["microsteps"]],
          "(d) every loss equal to (a)'s")
    global_s = [sum(r["seconds"] for r in rows[k:k + LM_M])
                for k in range(0, LM_MICROSTEPS, LM_M)]
    out = {"microsteps": rows, "launches": launches,
           "global_step_s": global_s,
           "in_process_global_step_s": fused["global_step_s"],
           "peak_gb": peak_gb,
           "in_process_counted_peak_gb": fused["counted_peak_gb"]}
    print(f"  (d) sharded fused step over one NCCL rank: {json.dumps(out)}")
    del state, new, progs, batches
    torch.cuda.empty_cache()
    return out


def sharded_ps_phase(T: dict, counters, lm: dict) -> dict:
    phase(16, f"the sharded PS: granite-8b at full width, depth {LM_LAYERS}: "
              f"(a) the sharded fused step over {SHARD_W} shards, (b) the "
              f"wire step, (c) switching and (d) the sharded fused step "
              f"over one NCCL rank")
    t_phase = time.perf_counter()
    kept = []
    out = {"sharded_fused": sharded_fused_phase(T, counters, lm, kept)}
    pg = T["process_group"]
    with tempfile.TemporaryDirectory() as tmp:
        world, dev = pg.join(0, 1, f"file://{os.path.join(tmp, 'store')}",
                             "cuda", timeout=300.0)
        try:
            check(world.backend == "nccl" and list(world.workers(WIRE_W))
                  == list(range(WIRE_W)), "one NCCL rank holding 4 workers")
            out["nccl"] = nccl_phase(T, counters, world, dev)
            out["switch_nccl"] = switch_nccl_phase(T, counters, world)
            out["sharded_fused_nccl"] = sharded_fused_nccl_phase(
                T, counters, world, dev, kept, out["sharded_fused"])
        finally:
            pg.leave()
    del kept
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 16: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: LM serving, the attention-family architectures at full width

ARCHS = ("gemma2-27b", "gemma3-12b", "starcoder2-3b", "phi3.5-moe-42b-a6.6b",
         "kimi-k2-1t-a32b")
# Room kept above the weights for what the loop allocates besides them:
# init_model's float32 draw of one leaf, or, when that is smaller, this
# much for the serve loop (phi3.5-moe's loop at 24 layers peaked 0.66 GB
# above its weights; H100 80GB HBM3, 700 W), plus the allocator's slack.
SERVE_ROOM_GB, SLACK_GB = 2.0, 0.5
# flash_decode launches a decode step at a depth: one a global layer
# without an attention softcap (gemma3-12b's sixth layer, every layer of
# phi3.5-moe and kimi-k2; zamba2-2.7b's sixth, the shared attention), two
# a cross layer (its self-attention and its cross-attention; every fifth
# of llama-3.2-vision-11b, all of seamless-m4t-medium's)
ARCH_KERNEL_LAYERS = {"gemma2-27b": lambda d: 0,
                      "gemma3-12b": lambda d: d // 6,
                      "starcoder2-3b": lambda d: 0,
                      "phi3.5-moe-42b-a6.6b": lambda d: d,
                      "kimi-k2-1t-a32b": lambda d: d,
                      "mamba2-780m": lambda d: 0,
                      "zamba2-2.7b": lambda d: d // 6,
                      "llama-3.2-vision-11b": lambda d: d + d // 5,
                      "seamless-m4t-medium": lambda d: 2 * d}
# the fixed-batch loop: B prompts of P tokens, G generated (cache 160)
ARCH_BATCH, ARCH_PROMPT, ARCH_GEN = 4, 128, 32
# gemma3-12b's ring at full width: a prompt past its window of 1,024
RING_PROMPT, RING_STEPS = 1152, 8
# the engine on gemma3-12b: 8 requests of 4 to 128 tokens, 4 slots
ARCH_ENGINE_GEN = 16
# the kernel at the path's head dims, timed at decode_32k's length
ARCH_FLASH_TIMED = ((4, 32_768, 8, 8, 112, LONG_POS),
                    (4, 32_768, 8, 2, 256, LONG_POS))


def tree_bytes(tree) -> int:
    """Bytes of the tensors of nested dicts and lists."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def fit_depth(T: dict, full) -> tuple[int, str]:
    """The deepest stack of ``full`` that the card holds now: the prefix
    layers and the most whole repeats whose bf16 weights, with the larger
    of init's float32 draw and ``SERVE_ROOM_GB`` and ``SLACK_GB`` on top,
    fit in the device's free memory; and the arithmetic, in GB of 10^9
    bytes."""
    top, block = T["transformer"].model_spec(full)
    leaves = T["transformer"]._leaves

    def gb(specs, itemsize=None) -> list[float]:
        return [int(np.prod(s.shape)) * (itemsize or s.dtype.itemsize) / 1e9
                for s in leaves(specs)]

    fixed, repeat = sum(gb(top)), sum(gb(block))
    draw = max(n for n, s in zip(gb([top, block], 4), leaves([top, block]))
               if s.scale is not None)
    room = max(draw, SERVE_ROOM_GB) + SLACK_GB
    free = torch.cuda.mem_get_info()[0] / 1e9
    per = len(full.block_pattern)
    reps = min(full.num_repeats, max(0, int((free - fixed - room) // repeat)))
    check(reps >= 1, f"{full.name}: one repeat fits "
                     f"({fixed + repeat + room!r} GB needed, {free!r} free)")
    depth = len(full.prefix_layers) + reps * per
    kept = (f"all {depth} layers" if reps == full.num_repeats else
            f"cut {full.num_layers} -> {depth} layers")
    why = (f"{kept}: {fixed:.2f} GB embed, head and prefix + {reps} x "
           f"{repeat:.3f} GB a repeat of {per} layer(s) + {room:.2f} GB room "
           f"(float32 draw {draw:.2f}, serve {SERVE_ROOM_GB:.2f}, slack "
           f"{SLACK_GB:.2f}) = {fixed + reps * repeat + room:.2f} GB <= "
           f"{free:.2f} GB free")
    if reps < full.num_repeats:
        why += (f"; {depth + per} layers need "
                f"{fixed + (reps + 1) * repeat + room:.2f} GB")
    return depth, why


def kernel_layers(cfg) -> int:
    """``flash_decode`` launches of a decode step at a scalar position, in
    a model without an attention softcap: one a global layer and a
    zamba2 shared-attention layer, two a cross layer (self- and
    cross-attention)."""
    if cfg.attn_softcap:
        return 0
    kinds = (*cfg.prefix_layers, *cfg.block_pattern * cfg.num_repeats)
    return sum(k in ("global", "moe", "mamba_attn") for k in kinds) \
        + 2 * sum(k == "cross" for k in kinds)


class record_flash:
    """Within the block, ``ops.flash_decode`` launches the kernel and keeps
    the inputs and output of the first call at each shape."""

    def __init__(self, T: dict):
        self.ops, self.calls = T["ops"], {}

    def __enter__(self):
        self.saved = self.ops.flash_decode

        def spy(q, k, v, pos):
            out = self.saved(q, k, v, pos)
            key = (*k.shape, q.shape[2])
            if key not in self.calls:
                self.calls[key] = (q.clone(), k.clone(), v.clone(),
                                   pos.clone() if isinstance(
                                       pos, torch.Tensor) else pos,
                                   out.clone())
            return out
        self.ops.flash_decode = spy
        return self

    def __exit__(self, *exc):
        self.ops.flash_decode = self.saved


class masked_cross:
    """Within the block, the cross-attention decode takes the masked
    route (``layers.cross_kernel`` says no)."""

    def __init__(self, T: dict):
        self.layers = T["layers"]

    def __enter__(self):
        self.saved = self.layers.cross_kernel
        self.layers.cross_kernel = lambda cfg: False

    def __exit__(self, *exc):
        self.layers.cross_kernel = self.saved


class record_routes:
    """Within the block, ``layers.moe_route`` keeps every route it
    returns."""

    def __init__(self, T: dict):
        self.layers, self.routes = T["layers"], []

    def __enter__(self):
        self.saved = self.layers.moe_route

        def spy(p, cfg, xt, logits=None):
            r = self.saved(p, cfg, xt, logits)
            self.routes.append(r)
            return r
        self.layers.moe_route = spy
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self.saved


def arch_serve(T: dict, arch: str, counters) -> dict:
    """(a) one architecture at full width: init, the memory of a model
    with cross layers (``serve.make_memory``: image embeddings, or frames
    through the audio encoder, timed), the fixed-batch loop of
    ``launch.serve`` counted, and each ``flash_decode`` shape of one more
    decode step held to the plain version on its own inputs."""
    Tm, serve = T["transformer"], T["serve"]
    full = T["get_config"](arch)
    torch.cuda.empty_cache()
    depth, why = fit_depth(T, full)
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    cfg = dataclasses.replace(full, num_layers=depth)
    check(cfg.dtype == "bfloat16", f"{arch}: bf16")
    print(f"  {arch}: {why}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Tm.init_model(cfg,
                           generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    out = {"layers": depth, "of_layers": full.num_layers, "cut": why,
           "free_gb": free_gb, "params": T["param_count"](params),
           "init_s": time.perf_counter() - t0,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "weights_gb": tree_bytes(params) / 1e9}
    prompts = torch.randint(0, cfg.vocab_size, (ARCH_BATCH, ARCH_PROMPT),
                            generator=torch.Generator("cuda").manual_seed(1),
                            device="cuda")
    t0 = time.perf_counter()
    memory = serve.make_memory(params, cfg, ARCH_BATCH, torch.device("cuda"))
    torch.cuda.synchronize()
    if memory is not None:
        out["memory_ms"] = (time.perf_counter() - t0) * 1e3
        out["memory_shape"] = list(memory.shape)
        check(bool(torch.isfinite(memory).all()), f"{arch}: finite memory")
    serve.run_fixed_batch(params, cfg, prompts, 2, memory=memory,
                          log=lambda _: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters(reset=True)
    res = serve.run_fixed_batch(params, cfg, prompts, ARCH_GEN,
                                memory=memory, log=lambda _: None)
    torch.cuda.synchronize()
    launches = counters()
    steps = res["decode_steps"]
    want = ARCH_KERNEL_LAYERS[arch](depth)
    check(kernel_layers(cfg) == want, f"{arch}: {want} kernel layers")
    check(launches["flash_decode"] == want * steps,
          f"{arch}: {want} flash_decode launches a decode step: "
          f"{launches['flash_decode']} in {steps}")
    check(sum(v for k, v in launches.items()
              if k not in ("flash_decode", "calls")) == 0,
          f"{arch}: the serve loop launches no other kernel")
    tokens = res["tokens"]
    check(tokens.shape == (ARCH_BATCH, ARCH_GEN), "tokens (B, gen)")
    out.update({
        "prefill_ms": res["prefill_s"] * 1e3,
        "decode_step_ms": res["decode_s"] / steps * 1e3,
        "tokens_per_s": ARCH_BATCH * steps / res["decode_s"],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches})
    # one more step from the loop's prompts and tokens: every launch shape
    # held to the plain version on the inputs the path gave it
    _, cache = Tm.prefill(params, cfg, prompts, memory,
                          cache_len=ARCH_PROMPT + ARCH_GEN)
    with record_flash(T) as rec:
        logits, _ = Tm.decode_step(params, cfg, tokens[:, :1], cache)
    check(bool(torch.isfinite(logits).all()), f"{arch}: finite logits")
    held = []
    for (b, length, kv, hd, g), (q, k, v, pos, got) in rec.calls.items():
        want_out = T["flash_decode_ref"](q, k, v, pos)
        err = (got.float() - want_out.float()).abs().max().item()
        ok = torch.allclose(got.float(), want_out.float(), rtol=BF16_RTOL,
                            atol=BF16_ATOL)
        held.append({"shape": [b, length, kv, g, hd], "pos": int(pos),
                     "max_abs_err": err})
        print(f"  {arch}: flash_decode on the path's inputs ({b}, {length},"
              f" {kv}, {g}, {hd}) at pos {int(pos)}: max |err| {err!r} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{arch}: flash_decode held to the plain version")
    shapes = (1 if want else 0) + ("cross" in cfg.block_pattern)
    check(len(rec.calls) == shapes,
          f"{arch}: {shapes} launch shape(s) on the path")
    out["flash_held"] = held
    print(f"  {arch}, {depth} of {full.num_layers} layers, {out['params']:,}"
          f" params ({out['weights_gb']!r} GB), init {out['init_s']:.1f} s, "
          f"init peak {out['init_peak_gb']!r} GB; batch {ARCH_BATCH}x"
          f"{ARCH_PROMPT}, gen {ARCH_GEN}: prefill {out['prefill_ms']!r} ms,"
          f" decode {out['decode_step_ms']!r} ms a step, "
          f"{out['tokens_per_s']!r} tok/s, peak {out['peak_gb']!r} GB; "
          f"launches {json.dumps(launches)}"
          + (f"; memory {out['memory_shape']} in {out['memory_ms']!r} ms"
             if memory is not None else ""))
    return out, cfg, params, memory


def route_check(T: dict, cfg, params, counters, prompt_len: int,
                steps: int, seed: int, on_prefill=None,
                memory=None) -> dict:
    """A prefill of B x ``prompt_len`` tokens (over ``memory``, for cross
    layers), then ``steps`` decode steps at a scalar position (the global,
    shared-attention and cross layers through ``flash_decode``, counted),
    held to the same steps at a (B,) vector of that position (every layer
    through the masked attention, the cross-attention too) fed the same
    tokens: logits within 2**-6 of the largest.  ``on_prefill`` sees the
    prefill's cache."""
    Tm = T["transformer"]
    prompts = torch.randint(0, cfg.vocab_size, (ARCH_BATCH, prompt_len),
                            generator=torch.Generator("cuda").manual_seed(
                                seed), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = Tm.prefill(params, cfg, prompts, memory,
                               cache_len=prompt_len + steps)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if on_prefill is not None:
        on_prefill(cache)
    vec = {**T["tree_map"](lambda x: x.clone(), {
        k: v for k, v in cache.items() if k != "pos"}),
        "pos": cache["pos"].expand(ARCH_BATCH).clone()}
    token = logits.argmax(-1)[:, None].to(torch.int32)
    tokens, seen = [], []
    counters(reset=True)
    t0 = time.perf_counter()
    for _ in range(steps):
        tokens.append(token)
        lg, cache = Tm.decode_step(params, cfg, token, cache)
        seen.append(lg)
        token = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = counters()
    check(launches["flash_decode"] == kernel_layers(cfg) * steps,
          f"{cfg.name} routes: flash_decode launches "
          f"{launches['flash_decode']}")
    masked = []
    with masked_cross(T):
        for tok in tokens:
            lg, vec = Tm.decode_step(params, cfg, tok, vec)
            masked.append(lg)
    kern, masked = torch.cat(seen, 1), torch.cat(masked, 1)
    check(bool(torch.isfinite(kern).all()), f"{cfg.name}: finite logits")
    err = (kern - masked).abs().max().item()
    scale = masked.abs().max().item()
    out = {"prompt": prompt_len, "prefill_ms": prefill_s * 1e3,
           "decode_step_ms": decode_s / steps * 1e3,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "logit_max_abs_diff": err,
           "logit_max_abs": scale}
    print(f"  {cfg.name} routes: prefill {ARCH_BATCH}x{prompt_len} "
          f"{out['prefill_ms']!r} ms, {steps} decode steps at "
          f"{out['decode_step_ms']!r} ms a step, peak {out['peak_gb']!r} GB;"
          f" scalar (kernel) vs vector (masked) position: max |logit diff| "
          f"{err!r} of {scale!r}")
    check(err <= 2.0**-6 * scale, f"{cfg.name}: the two routes agree")
    return out


def ring_phase(T: dict, cfg, params, counters) -> dict:
    """(b) gemma3-12b's ring at full width: a prefill of B x 1,152 tokens
    (its local layers keep the last 1,024), then 8 decode steps at a
    scalar position (the global layers through ``flash_decode``), held to
    the same steps at a (B,) vector of that position (every layer through
    the masked attention) fed the same tokens: logits within 2**-6 of the
    largest."""
    def ring(cache):
        check(cache["blocks"]["l0"]["attn"]["k"].shape[2]
              == cfg.sliding_window < RING_PROMPT,
              f"the local layers' ring of {cfg.sliding_window}")
    out = route_check(T, cfg, params, counters, RING_PROMPT, RING_STEPS, 5,
                      ring)
    return {**out, "window": cfg.sliding_window}


def arch_engine(T: dict, cfg, params, counters) -> dict:
    """(c) the engine on gemma3-12b (and zamba2-2.7b in phase 19, the
    cross archs in phase 20, which it serves without a memory, as the
    reference's engine does): 8 requests in 4 slots, every request
    complete, the per-slot positions through the masked attention, each
    request's first token equal to its offline greedy decode's (the rest
    counted: bf16 routes may round apart)."""
    S = T["S"]
    eng = S.ServingEngine(S.StaticSource(params), cfg,
                          num_slots=ENGINE_SLOTS,
                          max_len=ARCH_PROMPT + ARCH_ENGINE_GEN)
    rng = np.random.default_rng(0)
    for uid in range(ENGINE_REQUESTS):
        plen = int(rng.integers(4, ARCH_PROMPT + 1))
        eng.submit(S.Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, plen, dtype=np.int64).astype(np.int32),
            max_new_tokens=ARCH_ENGINE_GEN))
    torch.cuda.synchronize()
    counters(reset=True)
    stats = eng.run()
    torch.cuda.synchronize()
    launches = counters()
    print(f"  {cfg.name} engine: {json.dumps(stats)}")
    check(stats["completed"] == ENGINE_REQUESTS, "every request completed")
    check(launches["flash_decode"] == 0,
          "the engine's per-slot positions take the masked route")
    agree = total = 0
    for req in eng.completed:
        off = _offline_greedy(T, params, cfg, req.prompt, ARCH_ENGINE_GEN)
        check(off[0] == req.output[0],
              f"request {req.uid}: the prefill's token agrees")
        agree += sum(a == b for a, b in zip(off, req.output))
        total += len(off)
    print(f"  {cfg.name} engine vs offline greedy: {agree} of {total} "
          f"tokens agree")
    return {"stats": stats, "launches": launches, "tokens_agree": agree,
            "tokens": total}


def host_memory(T: dict, cfg, host: dict, card: dict) -> tuple:
    """The cross layers' memory on the CPU and on the card from one host
    draw (image embeddings, or frames that each side's ``encode_audio``
    encodes), or (None, None) for a model without one."""
    if cfg.family not in ("vlm", "audio"):
        return None, None
    rows = cfg.num_image_tokens or cfg.encoder_frames
    x = torch.randn((ARCH_BATCH, rows, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    if cfg.family == "vlm":
        return x, x.cuda()
    enc = T["transformer"].encode_audio
    return enc(host, cfg, x), enc(card, cfg, x.cuda())


def arch_card_vs_cpu(T: dict, arch: str) -> dict:
    """(d) ``.reduced()`` in float32, card against CPU from the same
    weights (and the same memory draw, for cross layers; the audio
    encoder's output held within 1e-5 of its largest): the fixed-batch
    loop on the card, then prefill and 8 steps teacher-forced on both;
    logits within 1e-5 of the largest, greedy tokens equal, and every MoE
    layer's expert choices and kept entries equal."""
    cfg = dataclasses.replace(T["get_config"](arch).reduced(),
                              dtype="float32")
    host = T["transformer"].init_model(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = T["tree_to_device"](host, torch.device("cuda"))
    mem_host, mem_card = host_memory(T, cfg, host, card)
    out = {}
    if cfg.family == "audio":
        err = (mem_card.cpu() - mem_host).abs().max().item()
        scale = mem_host.abs().max().item()
        print(f"  {arch} reduced f32 encode_audio card vs CPU: max |diff| "
              f"{err!r} of {scale!r}")
        check(err <= SERVE_HOLD_FRAC * scale, f"{arch}: card vs CPU memory")
        out["memory_max_abs_diff"] = err
    prompts = torch.randint(0, cfg.vocab_size, (ARCH_BATCH, 80),
                            generator=torch.Generator().manual_seed(1))
    res = T["serve"].run_fixed_batch(card, cfg, prompts.cuda(), 9,
                                     memory=mem_card, log=lambda _: None)
    tokens = res["tokens"]
    with record_routes(T) as on_card_routes:
        on_card, _ = _forced(T, card, cfg, prompts.cuda(), tokens, 90,
                             mem_card)
    with record_routes(T) as on_host_routes:
        on_host, _ = _forced(T, host, cfg, prompts, tokens.cpu(), 90,
                             mem_host)
    err = (on_card.cpu() - on_host).abs().max().item()
    scale = on_host.abs().max().item()
    same = bool(torch.equal(on_host.argmax(-1), tokens.cpu()))
    routes = list(zip(on_card_routes.routes, on_host_routes.routes))
    check(len(on_card_routes.routes) == len(on_host_routes.routes),
          f"{arch}: as many routes on both")
    same_routes = all(
        torch.equal(a["sel"].cpu(), b["sel"])
        and torch.equal(a["keep"].cpu(), b["keep"]) for a, b in routes)
    print(f"  {arch} reduced f32 card vs CPU, prefill + 8 steps: max |logit "
          f"diff| {err!r} of {scale!r}; greedy tokens equal: {same}; "
          f"{len(routes)} MoE routes equal: {same_routes}")
    check(err <= SERVE_HOLD_FRAC * scale, f"{arch}: card vs CPU logits")
    check(same, f"{arch}: card vs CPU greedy tokens")
    check(same_routes, f"{arch}: card vs CPU expert choices")
    return {**out, "logit_max_abs_diff": err, "logit_max_abs": scale,
            "moe_routes": len(routes)}


def archs_phase(T: dict, counters) -> dict:
    phase(17, "LM serving: the attention-family archs at full width, bf16")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"  allocated at the start: "
          f"{torch.cuda.memory_allocated() / 1e9!r} GB")
    out = {}
    for arch in ARCHS:
        row, cfg, params, _ = arch_serve(T, arch, counters)
        if arch == "gemma3-12b":
            row["ring"] = ring_phase(T, cfg, params, counters)
            row["engine"] = arch_engine(T, cfg, params, counters)
        del params
        torch.cuda.empty_cache()
        row["reduced_f32"] = arch_card_vs_cpu(T, arch)
        out[arch] = row
    gen = torch.Generator("cuda").manual_seed(6)
    cycles_per_ms = sleep_cycles_per_ms()
    out["flash_decode"] = [flash_timed(T, gen, shape, cycles_per_ms)
                           for shape in ARCH_FLASH_TIMED]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 17: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 18: LM training, the attention-family architectures at full width

# M is the largest of these at which one repeat of the pattern fits
TRAIN_MS = (4, 2, 1)
# the fused step's device bytes a parameter at M slots: the bf16 params (2
# B), their bf16 gradient (2), its float32 ravel (4), the float32 Adagrad
# accumulator (4) and the M-slot float32 buffer (4 M); at an apply the
# float32 ravel of the params and the new bf16 params take the place of
# the gradient and its ravel.  Phase 9's step at M = 4 peaked at 25.75 GB
# for 838,881,280 parameters on an H100 80GB HBM3 at 700 W, 30.7 B a
# parameter against these 28.
TRAIN_FIXED_B = 12
# beside them: the float32 logits of the batch and the copies the loss and
# its backward make of them (softcap, log-softmax, their gradients), and
# the allocator's slack
TRAIN_LOGIT_COPIES, TRAIN_SLACK_GB = 8, 2.0
# gba_apply takes N < 2^31 on one layout (kernels/gba_apply.py:28); a stack
# whose single repeat is past it runs over W layer-grouped shards
APPLY_MAX_N = 2**31 - 1
# the token of the first microstep of the second global step: 6 steps old
# at that step's apply, which Eq. (1) drops at iota 4
TRAIN_STALE = -5
# the columns of each leaf whose apply is held bit for bit to the plain
# version on copies of the pre-apply values
TRAIN_SAMPLE = 4096
# card against CPU at .reduced() in float32: a parameter seed at which no
# MoE route of the 8 microsteps of phi3.5-moe and kimi-k2 lies within 2.8e-4
# of a tie (the least margin on the CPU), so card and CPU choose alike
TRAIN_HOLD_SEED, TRAIN_HOLD_SEQ = 3, 80


def train_plan(T: dict, full) -> tuple[dict | None, str]:
    """The fused step that the card's free memory holds for ``full``:
    the largest M of ``TRAIN_MS`` at which the prefix layers and one
    repeat fit, at (12 + 4 M) B a parameter beside the logits' copies and
    the slack; then the deepest stack at that M: the whole stack when
    memory holds it, else the deepest on one layout while N < 2^31; over
    the fewest W layer-grouped shards whose shard is below 2^31 when N is
    past it.  Returns (the plan, or None when no M fits, and the
    arithmetic, in GB of 10^9 bytes)."""
    top, block = T["transformer"].model_spec(full)
    leaves = T["transformer"]._leaves
    fixed = sum(int(np.prod(s.shape)) for s in leaves(top))
    repeat = sum(int(np.prod(s.shape)) for s in leaves(block))
    act = (TRAIN_LOGIT_COPIES * LM_BATCH * LM_SEQ * full.vocab_size * 4
           / 1e9)
    free = torch.cuda.mem_get_info()[0] / 1e9
    per = len(full.block_pattern)
    room = free - act - TRAIN_SLACK_GB

    def need(n: int, m: int) -> float:
        return n * (TRAIN_FIXED_B + 4 * m) / 1e9 + act + TRAIN_SLACK_GB

    head = (f"{fixed / 1e9:.3f} G params embed, head and prefix + "
            f"{repeat / 1e9:.3f} G a repeat of {per} layer(s); logits "
            f"{act:.2f} GB, slack {TRAIN_SLACK_GB:.2f} GB, {free:.2f} GB "
            f"free")
    tried = []
    for m in TRAIN_MS:
        bpp = TRAIN_FIXED_B + 4 * m
        reps = min(full.num_repeats, int((room * 1e9 / bpp - fixed)
                                         // repeat))
        if reps < 1:
            tried.append(f"M={m}: one repeat, N {fixed + repeat:,}, needs "
                         f"{need(fixed + repeat, m):.2f} GB at {bpp} B a "
                         f"parameter")
            continue
        workers = 1
        if fixed + repeat <= APPLY_MAX_N and reps < full.num_repeats:
            reps = min(reps, (APPLY_MAX_N - fixed) // repeat)
        else:
            while (fixed + reps * repeat) / workers > APPLY_MAX_N * 0.99:
                workers *= 2
        n = fixed + reps * repeat
        depth = len(full.prefix_layers) + reps * per
        why = (f"{head}; M={m}, {depth} of {full.num_layers} layers, N "
               f"{n:,}: {n / 1e9:.3f} G x {bpp} B = {n * bpp / 1e9:.2f} GB "
               f"+ logits + slack = {need(n, m):.2f} GB <= {free:.2f}")
        if reps < full.num_repeats:
            nxt = n + repeat
            why += (f"; {depth + per} layers need {need(nxt, m):.2f} GB"
                     + (", N past 2^31 on one layout"
                        if workers == 1 and nxt > APPLY_MAX_N else ""))
        why += ("; one layout (N < 2^31)" if workers == 1 else
                f"; N past 2^31: {workers} layer-grouped shards")
        if tried:
            why += "; " + "; ".join(tried)
        return {"depth": depth, "m": m, "workers": workers, "n": n,
                "need_gb": need(n, m)}, why
    return None, (f"{head}; " + "; ".join(tried) + ": waits for the model "
                  f"axis over more than one card (ROADMAP.md queue 1 "
                  f"item 2.5)")


def _leaf_columns(layout, j: int, idx: torch.Tensor) -> tuple:
    """(shard, column) of elements ``idx`` of leaf ``j`` in the flat
    vectors: one layout's (0, offset + idx), or a layer-grouped sharded
    one's, shard-major."""
    if not hasattr(layout, "leaf_group"):
        return torch.zeros_like(idx), layout.offsets[j] + idx
    g = layout.leaf_group[j]
    pos = layout.offsets[j] + idx
    gsn = layout.group_shard_sizes[g]
    return pos // gsn, layout.group_local_offsets[g] + pos % gsn


class apply_sample:
    """Copies, before an apply, of ``TRAIN_SAMPLE`` random elements of
    every leaf of the params and of the accumulator at their columns; then
    :meth:`check` holds the apply's new params and accumulator there to
    ``gba_apply_ref`` on the copies and the buffer's columns, bit for bit
    (the apply is elementwise over the columns)."""

    def __init__(self, T: dict, layout, state: dict, gen: torch.Generator):
        self.T, self.layout = T, layout
        ss = layout.shard_size if hasattr(layout, "leaf_group") else 0
        self.picks, before = [], []
        for j, leaf in enumerate(layout.leaves(state["params"])):
            n = leaf.numel()
            idx = (torch.randint(0, n, (TRAIN_SAMPLE,), generator=gen,
                                 device="cuda") if n > TRAIN_SAMPLE else
                   torch.arange(n, device="cuda"))
            shard, col = _leaf_columns(layout, j, idx)
            self.picks.append((j, idx, shard, col))
            before.append(leaf.reshape(-1)[idx].float())
        self.shard = torch.cat([p[2] for p in self.picks])
        self.col = torch.cat([p[3] for p in self.picks])
        self.param = torch.cat(before)
        self.accum = state["accum"][self.shard * ss + self.col].clone()
        self.ss = ss

    def check(self, new: dict, step: int) -> bool:
        grads = new["buffer"]["grads"]
        rows = grads.unsqueeze(1) if grads.dim() == 2 else grads
        buf = rows[:, self.shard, self.col].contiguous()
        want_p, want_a = self.T["gba_apply_ref"](
            self.param.clone(), self.accum.clone(), buf,
            new["buffer"]["tokens"], step, LM_LR, iota=LM_IOTA)
        got_a = new["accum"][self.shard * self.ss + self.col]
        if not torch.equal(got_a.view(torch.int32), want_a.view(torch.int32)):
            return False
        leaves, at = self.layout.leaves(new["params"]), 0
        for j, idx, _, _ in self.picks:
            got = leaves[j].reshape(-1)[idx]
            want = want_p[at:at + idx.numel()].to(got.dtype)
            at += idx.numel()
            bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
            if not torch.equal(got.view(bits), want.view(bits)):
                return False
        return True


def train_timing(T: dict, layout, state: dict, m: int) -> dict:
    """``gba_apply`` on the run's own flat params, accumulator and buffer
    at its N (over W > 1 shards, one launch's: shard 0's contiguous
    block): :func:`apply_block_timing`."""
    flat, accum = layout.ravel(state["params"]), state["accum"]
    buf = state["buffer"]["grads"]
    if buf.dim() == 3:
        ss = layout.shard_size
        flat, accum, buf = flat[:ss], accum[:ss], buf[:, 0]
    return apply_block_timing(T, flat, accum, buf, state["buffer"], m)


def apply_block_timing(T: dict, flat, accum, buf, buffer: dict, m: int
                       ) -> dict:
    """``gba_apply`` on one launch's block of a run's state: median of 3
    runs of 5 calls (they move the params further; the run is over).  The
    plain version's float64 intermediates of an (M, N) buffer do not fit
    beside the state at this N."""
    tokens, step = buffer["tokens"], buffer["step"]

    def fn():
        T["gba_apply"](flat, accum, buf, tokens, step, LM_LR, iota=LM_IOTA)
    runs = [time_calls(fn, 5)[0] for _ in range(3)]
    n = flat.shape[0]
    bnd, by = apply_bound_ms(m, n, 4, 4)
    row = {"shape": [m, n], "dtypes": "f32 param/accum/buffer",
           "ms": float(np.median(runs)), "device_runs_ms": runs,
           "bound_ms": bnd, "bound_by": by, "plain_ms": None,
           "plain_note": "its float64 intermediates of the (M, N) buffer "
                         "do not fit beside the training state",
           "library_ms": None}
    print(f"  gba_apply M={m} N={n:,} f32 on the run's state, device ms "
          f"per call: {row['ms']!r} (runs {runs}), bound {bnd!r} ({by})")
    return row


def memory_entry(T: dict, cfg, rows: int, seed: int, device: str) -> dict:
    """The cross layers' memory of a training batch of ``rows``: a
    Normal(0, 1) draw of a generator on ``device`` seeded with ``seed``,
    float32 cast to the model dtype, as ``serve.make_memory`` draws its
    stub: ``image_embeds`` for a VLM, or ``frames`` for an audio model,
    which the loss runs through the encoder; ``{}`` for a model without
    cross layers.  Not the launcher's zeros: over zeros the
    cross-attention's weights take no gradient."""
    if cfg.family not in ("vlm", "audio"):
        return {}
    key, length = (("image_embeds", cfg.num_image_tokens)
                   if cfg.family == "vlm" else ("frames", cfg.encoder_frames))
    x = torch.randn((rows, length, cfg.d_model), device=device,
                    generator=torch.Generator(device).manual_seed(seed))
    return {key: x.to(T["layers"].dtype_of(cfg))}


def cross_leaves(T: dict, params: dict) -> dict:
    """The leaves that only a memory trains, by path: each cross layer's
    ``xattn`` and ``lnx``, and the audio ``encoder`` and ``enc_norm``."""
    return {path: t for path, t in T["tree_paths"](params)
            if path[0] in ("encoder", "enc_norm")
            or path[0] == "blocks" and path[2] in ("xattn", "lnx")}


def train_arch(T: dict, arch: str, counters, timed: bool) -> dict:
    """(a) one architecture at full width through the fused step, at the
    depth, M and W of :func:`train_plan`: 2 global steps, one stale slot;
    for a model with cross layers each batch with a drawn memory
    (:func:`memory_entry`), and the leaves only a memory trains
    (:func:`cross_leaves`) held to have moved at the first apply."""
    full = T["get_config"](arch)
    torch.cuda.empty_cache()
    plan, why = train_plan(T, full)
    print(f"  {arch}: {why}")
    if plan is None:
        return {"trained": False, "why": why}
    m, workers = plan["m"], plan["workers"]
    cfg = dataclasses.replace(full, num_layers=plan["depth"])
    check(cfg.dtype == "bfloat16", f"{arch}: bf16")
    gba = T["GBAConfig"](local_batch=LM_BATCH, buffer_size=m,
                         staleness_tolerance=LM_IOTA)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    progs = T["build_programs"](cfg, gba, params=params, mode="fused",
                                lr=LM_LR, workers=workers, place_state=False)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    layout = progs.layout
    n = layout.total
    check(n == plan["n"], f"{arch}: N {n} == the plan's {plan['n']}")
    if workers > 1:
        check(layout.num_shards == workers
              and layout.shard_size <= APPLY_MAX_N,
              f"{arch}: {workers} shards of {layout.shard_size} < 2^31")
    print(f"  {arch}: {plan['depth']} layers, N {n:,}, M={m}, W={workers}; "
          f"init + build {init_s:.2f} s, peak {init_peak:.2f} GB")
    steps = 2 * m
    batches = lm_batches(T, cfg.vocab_size, LM_SEQ, LM_BATCH, steps, "cuda")
    tokens = [i // m for i in range(steps)]
    tokens[m] = TRAIN_STALE
    gen = torch.Generator(device="cuda").manual_seed(7)
    torch.cuda.reset_peak_memory_stats()
    # the programs keep no reference to the first params once stepping
    state, rows, progs.state = progs.state, [], None
    watched = {k: t.clone() for k, t in cross_leaves(T, state["params"])
               .items()}
    moved = None
    counters(reset=True)
    for i in range(steps):
        applies = (i + 1) % m == 0
        old_step = state["buffer"]["step"]
        sample = apply_sample(T, layout, state, gen) if applies else None
        batch = {**batches[i], **memory_entry(T, cfg, LM_BATCH, 2 + i,
                                              "cuda")}
        launched = counters()["gba_apply"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = progs.step(state, batch, tokens[i])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launched = counters()["gba_apply"] - launched
        check(launched == (workers if applies else 0),
              f"{arch} microstep {i + 1}: {launched} gba_apply launches")
        if applies:
            check(sample.check(state, old_step),
                  f"{arch} microstep {i + 1}: the apply bit-identical to "
                  f"gba_apply_ref at {sample.col.numel()} sampled columns")
        if applies and moved is None and watched:
            now = cross_leaves(T, state["params"])
            moved = {"/".join(k): not torch.equal(now[k], v)
                     for k, v in watched.items()}
            still = [k for k, v in moved.items() if not v]
            print(f"  {arch}: {len(moved) - len(still)} of {len(moved)} "
                  f"leaves that only the memory trains moved at the first "
                  f"apply")
            check(not still, f"{arch}: moved at the first apply: {still}")
            del watched, now
        del sample, batch
        rows.append({"microstep": i + 1, "token": tokens[i],
                     "loss": loss.item(), "seconds": seconds,
                     "gba_apply": launched,
                     "gstep": state["buffer"]["step"]})
        print(f"  {json.dumps(rows[-1])}")
    torch.cuda.synchronize()
    launches = counters()
    path_peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in rows]
    check(all(np.isfinite(losses)), f"{arch}: finite losses {losses}")
    check(launches["gba_apply"] == 2 * workers,
          f"{arch}: {2 * workers} gba_apply launches, {workers} an apply")
    check(state["buffer"]["step"] == 2, f"{arch}: 2 global steps")
    check(int(state["buffer"]["tokens"][0]) == TRAIN_STALE,
          f"{arch}: the second global step's first slot is the stale one")
    micro = [r["seconds"] for r in rows]
    globals_s = [sum(micro[k * m:(k + 1) * m]) for k in range(2)]
    print(f"  {arch}: launches {json.dumps(launches)}; microstep s "
          f"{micro}; global step s {globals_s}; path peak {path_peak:.2f} "
          f"GB (planned {plan['need_gb']:.2f})")
    out = {"trained": True, "why": why, "depth": plan["depth"], "M": m,
           "W": workers, "N": n, "init_s": init_s,
           "init_peak_gb": init_peak, "microsteps": rows,
           "global_step_s": globals_s, "path_peak_gb": path_peak,
           "planned_gb": plan["need_gb"], "launches": launches}
    if moved is not None:
        out["cross_leaves_moved"] = sum(moved.values())
    if timed:
        out["gba_apply"] = train_timing(T, layout, state, m)
    del state, progs, batches
    torch.cuda.empty_cache()
    return out


def train_card_vs_cpu(T: dict, arch: str, workers: int,
                      flat_rtol: float = HOLD_LM_RTOL, model: int = 1
                      ) -> dict:
    """(b) ``.reduced()`` in float32, the fused step over ``workers``
    shards (one layout at 1; over ``model`` model shards too where that is
    above 1, each model shard's params raveled in turn) from the same
    params on the card and on the CPU (and the same host draw of a cross
    layers' memory), 2 global steps, one slot stale: losses within rtol
    1e-5, flat params and accumulator within rtol ``flat_rtol`` (1e-5) /
    atol 1e-7, buffer tokens and every MoE route equal."""
    cfg = dataclasses.replace(T["get_config"](arch).reduced(),
                              dtype="float32")
    gba = T["GBAConfig"](local_batch=2, buffer_size=LM_M,
                         staleness_tolerance=LM_IOTA)
    host = T["init_model"](cfg, generator=torch.Generator().manual_seed(
        TRAIN_HOLD_SEED), device="cpu")
    tokens = [i // LM_M for i in range(2 * LM_M)]
    tokens[LM_M] = TRAIN_STALE
    runs = {}
    for dev in ("cuda", "cpu"):
        progs = T["build_programs"](cfg, gba, params=T["tree_to_device"](
            host, torch.device(dev)), lr=LM_LR, workers=workers, model=model,
            place_state=False)
        state, losses = progs.state, []
        with record_routes(T) as seen:
            for i, b in enumerate(lm_batches(T, cfg.vocab_size,
                                             TRAIN_HOLD_SEQ, 2, len(tokens),
                                             dev)):
                # a cross layers' memory drawn on the host, for both sides
                b |= {k: v.to(dev) for k, v in memory_entry(
                    T, cfg, 2, 3 + i, "cpu").items()}
                state, loss = progs.step(state, b, tokens[i])
                losses.append(loss.item())
        params = (state["params"] if model > 1 else [state["params"]])
        runs[dev] = (losses, torch.cat([progs.layout.ravel(p).cpu()
                                        for p in params]),
                     state["accum"].cpu(), state["buffer"]["tokens"].cpu(),
                     seen.routes)
    (lc, pc, ac, tc, rc), (lh, ph, ah, th, rh) = runs["cuda"], runs["cpu"]
    same_routes = len(rc) == len(rh) and all(
        torch.equal(a["sel"].cpu(), b["sel"])
        and torch.equal(a["keep"].cpu(), b["keep"]) for a, b in zip(rc, rh))
    out = {"W": workers, "T": model, "losses_card": lc, "losses_cpu": lh,
           "max_param_diff": (pc - ph).abs().max().item(),
           "max_accum_diff": (ac - ah).abs().max().item(),
           "moe_routes": len(rc)}
    print(f"  {arch} reduced f32, W={workers}, T={model}, card vs CPU: "
          f"{json.dumps(out)}; routes equal: {same_routes}")
    check(torch.equal(tc, th), f"{arch}: card vs CPU buffer tokens")
    check(same_routes, f"{arch}: card vs CPU MoE routes")
    check(np.allclose(lc, lh, rtol=HOLD_LM_RTOL, atol=0),
          f"{arch}: card vs CPU losses within rtol {HOLD_LM_RTOL}")
    for name, a, b in (("flat params", pc, ph), ("accumulator", ac, ah)):
        check(torch.allclose(a, b, rtol=flat_rtol, atol=HOLD_LM_ATOL),
              f"{arch}: card vs CPU {name} within rtol {flat_rtol} atol "
              f"{HOLD_LM_ATOL}")
    return out


def expandable_segments(on: bool) -> None:
    """Expandable segments in the caching allocator.  Phase 18's steps
    allocate and free vectors of up to 14 GB beside 50 GB of state, and
    fixed segments then fragment (on an H100 80GB HBM3, gemma2-27b at M =
    2 found 11.5 GiB reserved but unallocated and no room for its 13 GiB
    ravel)."""
    setter = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (setter or torch.cuda.memory._set_allocator_settings)(
        f"expandable_segments:{on}")


def train_phase(T: dict, counters) -> dict:
    phase(18, "LM training: the attention-family archs at full width")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    expandable_segments(True)
    out = {}
    for arch in ARCHS:
        row = train_arch(T, arch, counters, timed=arch == "starcoder2-3b")
        # the reduced model runs the full width's shards (kimi-k2, which
        # waits, the reference's documented --mesh 4x1)
        row["reduced_f32"] = train_card_vs_cpu(
            T, arch, row["W"] if row["trained"] else 4)
        out[arch] = row
    torch.cuda.empty_cache()
    expandable_segments(False)
    trained = [a for a in ARCHS if out[a]["trained"]]
    check({"starcoder2-3b", "phi3.5-moe-42b-a6.6b"} <= set(trained),
          f"starcoder2-3b and phi3.5-moe train at full width: {trained}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 18: {out['seconds']:.1f} s; trained at full width: "
          f"{trained}")
    return out


# ---------------------------------------------------------------------------
# phase 19: the Mamba2 archs at full width, serving and training

SSM_ARCHS = ("mamba2-780m", "zamba2-2.7b")
# zamba2's shared attention: a prompt of 128, 8 steps a route
SSM_ROUTE_STEPS = 8
# card against CPU at zamba2-2.7b.reduced(): its stack of 6 layers carries
# float32 rounding about ten times further than one mamba2 layer (against
# a float64 evaluation the CPU's float32 gradients lie 1.1e-5 of their
# largest away; tests/test_torch_archs_ssm.py holds its fused flat state
# against the JAX package's within rtol 1e-4)
SSM_TRAIN_FLAT_RTOL = {"mamba2-780m": HOLD_LM_RTOL, "zamba2-2.7b": 1e-4}
# flash_decode at zamba2's shared attention: hd 80, G 1, 32 KV heads; the
# serve loop's last step and decode_32k's length
SSM_FLASH_TIMED = ((4, 160, 32, 1, 80, 159),
                   (4, 32_768, 32, 1, 80, LONG_POS))


def ssm_phase(T: dict, counters) -> dict:
    phase(19, "LM serving and training: mamba2-780m and zamba2-2.7b at full "
              "width")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    for arch in SSM_ARCHS:
        row, cfg, params, _ = arch_serve(T, arch, counters)
        check(row["layers"] == row["of_layers"], f"{arch}: full depth")
        if arch == "zamba2-2.7b":
            row["routes"] = route_check(T, cfg, params, counters,
                                        ARCH_PROMPT, SSM_ROUTE_STEPS, 5)
            row["engine"] = arch_engine(T, cfg, params, counters)
        del params
        torch.cuda.empty_cache()
        row["reduced_f32"] = arch_card_vs_cpu(T, arch)
        out[arch] = row
    gen = torch.Generator("cuda").manual_seed(7)
    out["flash_decode"] = [flash_timed(T, gen, shape, sleep_cycles_per_ms())
                           for shape in SSM_FLASH_TIMED]
    expandable_segments(True)
    for arch in SSM_ARCHS:
        row = train_arch(T, arch, counters, timed=False)
        check(row["trained"], f"{arch} trains at full width")
        row["reduced_f32"] = train_card_vs_cpu(
            T, arch, row["W"], SSM_TRAIN_FLAT_RTOL[arch])
        out[f"train_{arch}"] = row
    torch.cuda.empty_cache()
    expandable_segments(False)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 19: {out['seconds']:.1f} s; trained at depths "
          f"{[out[f'train_{a}']['depth'] for a in SSM_ARCHS]}")
    return out


# ---------------------------------------------------------------------------
# phase 20: LM serving, the archs with cross layers at full width

CROSS_ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-medium")
# the kernel at the cross archs' new shapes: llama's cross-attention over
# its 1,601 image tokens, seamless's self-attention (the serve loop's last
# step) and its cross-attention over 1,024 frames (hd 64, G 1, 16 KV heads)
CROSS_FLASH_TIMED = ((4, 1601, 8, 4, 128, 1600), (4, 160, 16, 1, 64, 159),
                     (4, 1024, 16, 1, 64, 1023))


def cross_phase(T: dict, counters) -> dict:
    """llama-3.2-vision-11b and seamless-m4t-medium at full width and all
    their layers: (a) the fixed-batch loop over the memory (48 and 24
    ``flash_decode`` launches a step), each launch shape held to the plain
    version; (b) the kernel route against the masked route over the same
    memory; (c) the engine, without a memory; (d) each ``.reduced()`` f32
    card vs CPU; then the kernel timed at the new shapes."""
    phase(20, "LM serving: llama-3.2-vision-11b and seamless-m4t-medium at "
              "full width")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    for arch in CROSS_ARCHS:
        row, cfg, params, memory = arch_serve(T, arch, counters)
        check(row["layers"] == row["of_layers"], f"{arch}: full depth")
        row["routes"] = route_check(T, cfg, params, counters, ARCH_PROMPT,
                                    SSM_ROUTE_STEPS, 5, memory=memory)
        row["engine"] = arch_engine(T, cfg, params, counters)
        del params, memory
        torch.cuda.empty_cache()
        row["reduced_f32"] = arch_card_vs_cpu(T, arch)
        out[arch] = row
    gen = torch.Generator("cuda").manual_seed(8)
    out["flash_decode"] = [flash_timed(T, gen, shape, sleep_cycles_per_ms())
                           for shape in CROSS_FLASH_TIMED]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 20: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 21: LM training, the cross archs and the reference's memory variants

# the variants at full width: granite-8b at phase 9's width and depth, one
# sequence long enough that attn_q_chunk 1,024 and loss_seq_chunk 512 engage
VARIANT_ARCH, VARIANT_SEQ = "granite-8b", 4096
VARIANT_NAMES = ("baseline", "chunked_attn", "remat", "chunked_loss",
                 "full_opt")
# bf16 against the baseline: the loss relative, each gradient leaf of its
# largest magnitude (a checkpoint runs the same operators again; the
# chunks round bf16 intermediates in other groupings)
VARIANT_LOSS_RTOL, VARIANT_GRAD_FRAC = 2.0**-6, 2.0**-5
SPLIT_ARCH, SPLIT_DECODE = "mamba2-780m", 4
# phase 21's seconds on an H100 80GB HBM3 at 700 W are expected near 60;
# past this the run fails, so the script stays within its 1200-second
# limit
PHASE21_BUDGET_S = 300.0


class drawn_memory:
    """Within the block, the launcher's batches (``train.lm_batch``) carry
    a drawn memory in place of the reference launcher's zeros: the whole
    batch's, a host Normal(0, 1) draw seeded with the sum of the stream
    batch's tokens, cut to the rows the call takes, so that each worker
    takes its own rows and the card and the CPU see the same values."""

    def __init__(self, T: dict):
        self.train = T["train"]

    def __enter__(self):
        self.saved = self.train.lm_batch

        def draw(cfg, b, device, rows=slice(None)):
            batch = self.saved(cfg, b, device, rows)
            seed = int(b["tokens"].astype(np.int64).sum())
            for key in ("image_embeds", "frames"):
                if key in batch:
                    full = torch.randn(
                        (b["tokens"].shape[0], *batch[key].shape[1:]),
                        generator=torch.Generator().manual_seed(seed))
                    batch[key] = full[rows].to(batch[key])
            return batch
        self.train.lm_batch = draw
        return self

    def __exit__(self, *exc):
        self.train.lm_batch = self.saved


def cross_wire_card_vs_cpu(T: dict, counters) -> dict:
    """(c) seamless-m4t-medium's ``.reduced()`` int8 wire step in float32,
    card against CPU (``--fused --mesh 4x1 --compress int8``): 2 float32
    warmup and 2 compressed global steps, each batch's drawn frames split
    over the 4 workers with its tokens; per compressed step one
    ``quantize_minmax`` a worker and layer group, one ``dequantize`` a
    shard and group and one ``gba_apply`` a shard."""
    arch = CROSS_ARCHS[1]
    with drawn_memory(T):
        out = wire_card_vs_cpu(T, counters, arch, ("int8",))["int8"]
    groups = len(out["groups"])
    want = {"quantize": WIRE_W * groups, "dequantize": WIRE_W * groups,
            "gba_apply": WIRE_W}
    for row in out["card_steps"][WIRE_WARMUP:]:
        check({k: row[k] for k in want} == want,
              f"{arch} int8 wire, compressed step {row['step']}: launches "
              f"{row} == {want}")
    print(f"  {arch} int8 wire: {groups} layer groups, a compressed step "
          f"launches {json.dumps(want)}")
    return {**out, "groups": groups, "launches_per_compressed_step": want}


def variant_run(T: dict, name: str, base_cfg, params: dict, batch: dict
                ) -> dict:
    """One microstep's loss and gradient of ``base_cfg`` under the
    variant ``name``, twice: the loss and the gradient tree of the second
    call, the seconds of each (the first takes the allocator's and the
    checkpoints' first use) and the second's peak device memory."""
    cfg, _ = T["VARIANTS"][name](base_cfg, {})
    seconds = []
    for _ in range(2):
        grads = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss, grads = T["loss_and_grads"](cfg, params, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
    return {"cfg": cfg, "loss": loss.item(), "grads": grads,
            "first_seconds": seconds[0], "seconds": seconds[1],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def variants_full_width(T: dict) -> dict:
    """(d) granite-8b at full width, depth 2, one sequence of 4,096 tokens
    (so ``attn_q_chunk`` 1,024 and ``loss_seq_chunk`` 512 engage): one
    microstep's loss and gradient under each of ``VARIANT_NAMES``, each
    against ``baseline``'s: the loss within 2**-6 relative, each leaf
    within 2**-5 of its largest magnitude; each variant's peak and
    seconds."""
    cfg = dataclasses.replace(T["get_config"](VARIANT_ARCH),
                              num_layers=LM_LAYERS)
    torch.cuda.empty_cache()
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    batch = lm_batches(T, cfg.vocab_size, VARIANT_SEQ, 1, 1, "cuda")[0]
    base = variant_run(T, "baseline", cfg, params, batch)
    want = T["leaves"](base.pop("grads"))
    out = {"baseline": {k: base[k] for k in ("loss", "first_seconds",
                                             "seconds", "peak_gb")}}
    print(f"  {VARIANT_ARCH} depth {LM_LAYERS}, 1 x {VARIANT_SEQ} tokens, "
          f"baseline: {json.dumps(out['baseline'])}")
    for name in VARIANT_NAMES[1:]:
        run = variant_run(T, name, cfg, params, batch)
        got = T["leaves"](run.pop("grads"))
        worst = max((g.float() - w.float()).abs().max().item()
                    / max(w.float().abs().max().item(), 1e-30)
                    for g, w in zip(got, want))
        rel = abs(run["loss"] - base["loss"]) / abs(base["loss"])
        c = run.pop("cfg")
        out[name] = {**run, "fields": {k: getattr(c, k) for k in (
            "attn_q_chunk", "loss_seq_chunk", "remat_blocks")},
            "loss_rel_diff": rel, "worst_leaf_frac": worst}
        print(f"  {name}: {json.dumps(out[name])}")
        check(rel <= VARIANT_LOSS_RTOL,
              f"{name}: loss within {VARIANT_LOSS_RTOL} of the baseline's")
        check(worst <= VARIANT_GRAD_FRAC,
              f"{name}: every gradient leaf within {VARIANT_GRAD_FRAC} of "
              f"its largest magnitude of the baseline's")
        del got
    del params, want, batch
    torch.cuda.empty_cache()
    return out


def split_card_vs_cpu(T: dict) -> dict:
    """(d) ``mamba_split`` on mamba2-780m's ``.reduced()`` in float32,
    card against CPU from the same weights: the logits, a prefill then 4
    decode steps and every gradient leaf, each within 1e-5 of its largest
    magnitude."""
    cfg, _ = T["VARIANTS"]["mamba_split"](dataclasses.replace(
        T["get_config"](SPLIT_ARCH).reduced(), dtype="float32"), {})
    tf = T["transformer"]
    host = tf.init_model(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    card = T["tree_to_device"](host, torch.device("cuda"))
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    out, worst = {}, {}

    def hold(what, got, want):
        err = (got.float().cpu() - want.float()).abs().max().item()
        frac = err / max(want.float().abs().max().item(), 1e-30)
        worst[what] = max(worst.get(what, 0.0), frac)
        check(frac <= SERVE_HOLD_FRAC,
              f"mamba_split {what}: card vs CPU within {SERVE_HOLD_FRAC} of "
              f"the largest ({frac!r})")
    hold("logits", tf.forward(card, cfg, toks.cuda()),
         tf.forward(host, cfg, toks))
    lc, cc = tf.prefill(card, cfg, toks.cuda(), cache_len=48)
    lh, ch = tf.prefill(host, cfg, toks, cache_len=48)
    for _ in range(SPLIT_DECODE):
        hold("decode logits", lc, lh)
        tok = lh.reshape(2, -1).argmax(-1)[:, None].to(torch.int32)
        lc, cc = tf.decode_step(card, cfg, tok.cuda(), cc)
        lh, ch = tf.decode_step(host, cfg, tok, ch)
    hold("decode logits", lc, lh)
    loss_c, gc = T["loss_and_grads"](
        cfg, card, {k: v.cuda() for k, v in batch.items()})
    loss_h, gh = T["loss_and_grads"](cfg, host, batch)
    for g, w in zip(T["leaves"](gc), T["leaves"](gh)):
        hold("gradient leaf", g, w)
    out = {"loss_card": loss_c.item(), "loss_cpu": loss_h.item(),
           "worst_frac": worst,
           "split_leaves": sorted(k for k in card["blocks"]["l0"]["mixer"]
                                  if k.startswith(("w_", "conv_")))}
    print(f"  mamba_split {cfg.name} f32 card vs CPU: {json.dumps(out)}")
    return out


def cross_train_phase(T: dict, counters) -> dict:
    """(a) llama-3.2-vision-11b and seamless-m4t-medium at full width
    through the fused step, each batch with a drawn memory, ``gba_apply``
    timed on each run's state; (b) each ``.reduced()`` f32 card vs CPU;
    (c) seamless's reduced int8 wire step card vs CPU; (d) the variants at
    full width, and the split Mamba projections card vs CPU."""
    phase(21, "LM training: the cross archs and the variants")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    expandable_segments(True)
    out = {}
    for arch in CROSS_ARCHS:
        row = train_arch(T, arch, counters, timed=True)
        check(row["trained"], f"{arch} trains at full width")
        row["reduced_f32"] = train_card_vs_cpu(T, arch, row["W"])
        out[arch] = row
    torch.cuda.empty_cache()
    expandable_segments(False)
    out["wire_int8"] = cross_wire_card_vs_cpu(T, counters)
    out["variants"] = variants_full_width(T)
    out["mamba_split"] = split_card_vs_cpu(T)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 21: {out['seconds']:.1f} s (budget {PHASE21_BUDGET_S:.0f}"
          f" s); trained at depths "
          f"{[out[a]['depth'] for a in CROSS_ARCHS]}")
    check(out["seconds"] <= PHASE21_BUDGET_S,
          f"phase 21 within its budget of {PHASE21_BUDGET_S} s")
    return out


# ---------------------------------------------------------------------------
# phase 22: the model axis, --fused --mesh 2x2

MODEL_MESH = (2, 2)              # (data W, model T)
MODEL_ARCHS = ("granite-8b", *ARCHS, *SSM_ARCHS, *CROSS_ARCHS)
MODEL_MOE = "phi3.5-moe-42b-a6.6b"
# (e) the Mamba2 archs over 2 x 2 at full width: mamba2-780m whole, zamba2
# cut to one repeat of its 6-layer pattern (the shared attention once)
MODEL_SSM_DEPTHS = {"mamba2-780m": 48, "zamba2-2.7b": 6}
# (f) the rules' head_dim fallback over 2 x 16 at full width: granite-8b at
# phase 9's depth (8 KV heads: k and v along head_dim), starcoder2-3b cut
# to 4 of 30 layers (24 heads: every projection along head_dim)
MODEL_WIDE = (2, 16)
MODEL_HEAD_DIM_DEPTH = {"starcoder2-3b": 4}
# (g) a reduced --compress int8 run at 4 x 2 against 4 x 1
MODEL_WIRE_ARGS = ["--arch", "granite-8b", "--reduced", "--fused",
                   "--compress", "int8", "--steps", "4", "--seq", "32",
                   "--device", "cuda"]
# against the unsharded step at full width in bf16: the first loss, and
# each leaf of the params after the first apply against its largest
# magnitude (the shards' float32 partials round once where the unsharded
# products round per GEMM; phase 21 (d)'s bounds)
MODEL_LOSS_FRAC, MODEL_PARAM_FRAC = 2.0**-6, 2.0**-5
# rows (a)-(d) of phase 22 took 28.0 s alone on an H100 80GB HBM3 at 700 W;
# the rows (e), (f) and (g) have budgets of their own
MODEL_BUDGET_S = 90.0
MODEL_SSM_BUDGET_S, MODEL_WIDE_BUDGET_S, MODEL_WIRE_BUDGET_S = 60.0, 75.0, 30.0
# (h)-(j): FSDP of the weights over data (place_state=True) at 2 x 2 in
# process and over one NCCL rank, and at 4 x 1, each against the same
# step with the weights whole over data; a budget of their own
FSDP_MESH = (4, 1)
FSDP_BUDGET_S = 90.0


def _whole_leaves(T: dict, tp, shard: dict) -> list:
    """The leaves of a model shard's tree that the rules leave whole."""
    specs = dict(T["tree_paths"](tp.specs))
    return [x for path, x in T["tree_paths"](shard)
            if not T["model_dims"](specs[path])]


def _block_state(state: dict, i: int, blocks: int) -> dict:
    """Model shard ``i``'s part of a (W, T) fused state, in the form of a
    data-only sharded state: its tree, its accumulator run and its
    ``blocks`` buffer blocks."""
    run = state["accum"].shape[0] // len(state["params"])
    return {"params": state["params"][i],
            "accum": state["accum"][i * run:(i + 1) * run],
            "buffer": {**state["buffer"], "grads": state["buffer"]["grads"][
                :, i * blocks:(i + 1) * blocks]}}


def _snapshot(T: dict, state: dict) -> dict:
    """A device copy of a (W, T) fused state's params and accumulator."""
    return {"params": [[x.clone() for x in T["leaves"](p)]
                       for p in state["params"]],
            "accum": state["accum"].clone()}


def model_axis_run(T: dict, cfg, params: dict, batches: list, tokens: list,
                   m: int, counters, world, label: str, sample: bool,
                   snapshots: list | None = None, keep: list | None = None,
                   mesh: tuple = MODEL_MESH) -> dict:
    """The fused step over the (W, T) ``mesh`` at M = ``m`` from ``params``
    over ``batches`` and ``tokens`` (on ``world``): W x T ``gba_apply``
    launches an apply, each model shard's apply held bit for bit to
    ``gba_apply_ref`` at 4,096 sampled elements of every leaf where
    ``sample``, the whole leaves' copies bit-identical across the model
    shards; each apply's state equal to ``snapshots``' bit for bit where
    they are given, or copied into ``keep``.  Returns the losses, seconds,
    launches and the first apply's params put back together."""
    w, t = mesh
    gba = T["GBAConfig"](local_batch=LM_BATCH, buffer_size=m,
                         staleness_tolerance=LM_IOTA)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    progs = T["build_programs"](cfg, gba, params=params, mode="fused",
                                lr=LM_LR, workers=w, model=t, world=world,
                                place_state=False)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tp, layout = progs.model_axis, progs.layout
    blocks = len(world.workers(w))
    state, progs.state = progs.state, None
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows, first, launched_total, applies = [], None, 0, 0
    for i, (batch, token) in enumerate(zip(batches, tokens)):
        applying = (i + 1) % m == 0
        old_step = state["buffer"]["step"]
        samples = ([apply_sample(T, layout, _block_state(state, j, blocks),
                                 gen) for j in range(len(state["params"]))]
                   if applying and sample else None)
        launched = counters()["gba_apply"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, loss = progs.step(state, batch, token)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        launched = counters()["gba_apply"] - launched
        launched_total += launched
        check(launched == (w * t if applying else 0),
              f"{label} microstep {i + 1}: {launched} gba_apply launches")
        if applying:
            applies += 1
            if samples is not None:
                check(all(smp.check(_block_state(state, j, blocks), old_step)
                          for j, smp in enumerate(samples)),
                      f"{label} microstep {i + 1}: each model shard's apply "
                      f"bit-identical to gba_apply_ref at sampled columns")
            whole = [_whole_leaves(T, tp, s) for s in state["params"]]
            check(all(_same_bits(a, b) for other in whole[1:]
                      for a, b in zip(whole[0], other)),
                  f"{label} microstep {i + 1}: the {len(whole[0])} whole "
                  f"leaves bit-identical across the model shards")
            if snapshots is not None:
                snap = snapshots[applies - 1]
                same = _same_bits(snap["accum"], state["accum"]) and all(
                    _same_bits(a, b) for sp, p in zip(snap["params"],
                                                      state["params"])
                    for a, b in zip(sp, T["leaves"](p)))
                check(same, f"{label} microstep {i + 1}: the state "
                            f"bit-identical to the in-process run's")
            if keep is not None:
                keep.append(_snapshot(T, state))
            if first is None:
                first = tp.gather_shards(state["params"])
        rows.append({"microstep": i + 1, "token": token,
                     "loss": loss.item(), "seconds": seconds,
                     "gba_apply": launched})
    torch.cuda.synchronize()
    out = {"build_s": build_s, "microsteps": rows,
           "losses": [r["loss"] for r in rows],
           "launches": launched_total, "applies": applies,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "N_per_model_shard": layout.total,
           "shard_size": layout.shard_size, "split": sorted(tp.split),
           "attn": list(tp.attn), "mesh": list(mesh),
           "first_apply_params": first, "state": state, "layout": layout}
    check(all(np.isfinite(out["losses"])), f"{label}: finite losses")
    check(launched_total == applies * w * t,
          f"{label}: {w * t} gba_apply launches an apply")
    return out


def _trees(progs, state: dict) -> list:
    """The held model shards' trees of a fused state over a (W, T) mesh,
    whole over ``data`` (under FSDP the blocks gathered over ``data``)."""
    trees = progs.gather_params(state["params"])
    return trees if isinstance(trees, list) else [trees]


def placed_run(T: dict, cfg, params: dict, batches: list, tokens: list,
               counters, world, label: str, mesh: tuple, place_state: bool,
               snapshots: list | None = None, keep: list | None = None,
               sample: bool = False) -> dict:
    """The fused step over the (W, T) ``mesh`` at M = ``LM_M`` from
    ``params`` on ``world``, the weights held over ``data`` where
    ``place_state`` (FSDP: between microsteps each (data, model) block
    holds exactly the rules' share of the bytes): W x T ``gba_apply``
    launches an apply, each model shard's apply held bit for bit to
    ``gba_apply_ref`` at 4,096 sampled elements of every leaf where
    ``sample``; at each apply every param and the accumulator equal to
    ``snapshots``' bit for bit where they are given, or copied into
    ``keep`` (host copies, so that they add nothing to a later run's
    peak).  Returns the losses, the seconds of each microstep, the
    launches, the peak and the peak above the memory in use at the start
    (``peak_run_gb``: what the run itself added)."""
    w, t = mesh
    gba = T["GBAConfig"](local_batch=LM_BATCH, buffer_size=LM_M,
                         staleness_tolerance=LM_IOTA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    progs = T["build_programs"](cfg, gba, params=params, mode="fused",
                                lr=LM_LR, workers=w, model=t, world=world,
                                place_state=place_state)
    layout, pl = progs.layout, progs.placement
    check((pl is not None) == place_state,
          f"{label}: place_state={place_state} as asked")
    blocks = len(world.workers(w))
    state, progs.state = progs.state, None
    share = None
    if place_state:
        held = len(state["params"]) * len(pl.held)
        share = T["sharding"].block_bytes(params, pl.specs, pl.mesh) * held
        check(T["fsdp"].held_bytes(state["params"]) == share,
              f"{label}: {held} blocks hold the rules' share, {share:,} B")
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows, launched_total, applies = [], 0, 0
    for i, (batch, token) in enumerate(zip(batches, tokens)):
        applying = (i + 1) % LM_M == 0
        old_step = state["buffer"]["step"]
        samples = None
        if applying and sample:
            trees = _trees(progs, state)
            samples = [apply_sample(T, layout, {
                **_block_state(state, j, blocks), "params": tr}, gen)
                for j, tr in enumerate(trees)]
            del trees
        launched = counters()["gba_apply"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, loss = progs.step(state, batch, token)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        launched = counters()["gba_apply"] - launched
        launched_total += launched
        check(launched == (w * t if applying else 0),
              f"{label} microstep {i + 1}: {launched} gba_apply launches")
        if share is not None:
            check(T["fsdp"].held_bytes(state["params"]) == share,
                  f"{label} microstep {i + 1}: the blocks hold the rules' "
                  f"share")
        if applying:
            applies += 1
            trees = _trees(progs, state)
            if samples is not None:
                check(all(smp.check({**_block_state(state, j, blocks),
                                     "params": tr}, old_step)
                          for j, (smp, tr) in enumerate(zip(samples,
                                                            trees))),
                      f"{label} microstep {i + 1}: each model shard's "
                      f"apply bit-identical to gba_apply_ref at sampled "
                      f"columns")
            if snapshots is not None:
                snap = snapshots[applies - 1]
                same = _same_bits(snap["accum"], state["accum"]) and all(
                    _same_bits(a, b) for sp, tr in zip(snap["params"],
                                                       trees)
                    for a, b in zip(sp, T["leaves"](tr)))
                check(same, f"{label} microstep {i + 1}: the params and "
                            f"the accumulator bit-identical to the "
                            f"compared run's")
            if keep is not None:
                keep.append({"params": [[x.to("cpu", copy=True)
                                         for x in T["leaves"](tr)]
                                        for tr in trees],
                             "accum": state["accum"].to("cpu", copy=True)})
            del trees
        rows.append({"microstep": i + 1, "loss": loss.item(),
                     "seconds": seconds, "gba_apply": launched})
    torch.cuda.synchronize()
    out = {"microsteps": rows, "losses": [r["loss"] for r in rows],
           "launches": launched_total, "applies": applies,
           "fill_s": [r["seconds"] for r in rows
                      if r["microstep"] % LM_M],
           "apply_s": [r["seconds"] for r in rows
                       if not r["microstep"] % LM_M],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_run_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "mesh": list(mesh), "place_state": place_state}
    if pl is not None:
        name, gathered = T["fsdp"].largest_gather(pl)
        out.update(held_bytes=share, largest_gather=[name, gathered],
                   relayout_bound_bytes=T["fsdp"].transient_bytes(pl),
                   window=T["fsdp"].WINDOW)
    del state, progs
    torch.cuda.empty_cache()
    check(all(np.isfinite(out["losses"])), f"{label}: finite losses")
    check(launched_total == applies * w * t,
          f"{label}: {w * t} gba_apply launches an apply")
    return out


def _fill_apply(run: dict) -> str:
    """A run's median fill microstep after the first, its apply
    microsteps, and its peak above the memory in use at its start."""
    return (f"fill {np.median(run['fill_s'][1:]):.4f} s (first "
            f"{run['fill_s'][0]:.4f}), apply {run['apply_s']} s, peak "
            f"+{run['peak_run_gb']:.2f} GB (of {run['peak_gb']:.2f})")


def _unsharded(T: dict, cfg, params: dict, batches: list, tokens: list
               ) -> dict:
    """The single-layout fused step on the same params and batches over
    one global step: its losses, its seconds, and its params after the
    apply."""
    m = len(tokens)
    gba = T["GBAConfig"](local_batch=LM_BATCH, buffer_size=m,
                         staleness_tolerance=LM_IOTA)
    torch.cuda.reset_peak_memory_stats()
    progs = T["build_programs"](cfg, gba, params=params, mode="fused",
                                lr=LM_LR)
    state, progs.state, seconds, losses = progs.state, None, [], []
    for batch, token in zip(batches, tokens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = progs.step(state, batch, token)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(loss.item())
    return {"losses": losses, "seconds": seconds, "params": state["params"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _leaf_fracs(T: dict, got: dict, want: dict) -> list:
    """Each leaf's largest difference over its largest magnitude."""
    return [((a.float() - b.float()).abs().max()
             / b.float().abs().max().clamp_min(1e-30)).item()
            for (_, a), (_, b) in zip(T["tree_paths"](got),
                                      T["tree_paths"](want))]


def model_axis_granite(T: dict, counters) -> dict:
    """(a) granite-8b at full width, depth 2, bf16 over the 2x2 mesh in
    process, against the unsharded step from the same params; (b) one
    NCCL rank holding the 2x2 shards, bit-identical to (a) at each
    apply; then (f), :func:`model_axis_wide`, from the same params."""
    cfg = dataclasses.replace(T["get_config"]("granite-8b"),
                              num_layers=LM_LAYERS)
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    batches = lm_batches(T, cfg.vocab_size, LM_SEQ, LM_BATCH, 2 * LM_M,
                         "cuda")
    tokens = [i // LM_M for i in range(2 * LM_M)]
    tokens[LM_M] = TRAIN_STALE
    one = _unsharded(T, cfg, params, batches[:LM_M], tokens[:LM_M])
    counters(reset=True)
    kept = []
    run = model_axis_run(T, cfg, params, batches, tokens, LM_M, counters,
                         T["inprocess"], "granite-8b 2x2", sample=True,
                         keep=kept)
    first_loss = abs(run["losses"][0] - one["losses"][0]) / abs(
        one["losses"][0])
    fracs = _leaf_fracs(T, run.pop("first_apply_params"), one["params"])
    timing = apply_block_timing(
        T, run["layout"].ravel(run["state"]["params"][0])[
            :run["shard_size"]], run["state"]["accum"][:run["shard_size"]],
        run["state"]["buffer"]["grads"][:, 0], run["state"]["buffer"], LM_M)
    del run["state"], run["layout"]
    torch.cuda.empty_cache()
    micro = [r["seconds"] for r in run["microsteps"]]
    print(f"  granite-8b 2x2: losses {run['losses']}; first loss "
          f"{run['losses'][0]!r} vs unsharded {one['losses'][0]!r} (rel "
          f"{first_loss:.3g}); params after the first apply within "
          f"{max(fracs):.3g} of each leaf's largest; microstep s {micro} "
          f"(apply at 4 and 8) vs unsharded {one['seconds']}; peak "
          f"{run['peak_gb']:.2f} GB vs unsharded {one['peak_gb']:.2f} GB; "
          f"N per model shard {run['N_per_model_shard']:,}, "
          f"{run['shard_size']:,} a launch")
    check(first_loss <= MODEL_LOSS_FRAC,
          f"granite-8b 2x2: the first loss within {MODEL_LOSS_FRAC} of "
          f"the unsharded step's")
    check(max(fracs) <= MODEL_PARAM_FRAC,
          f"granite-8b 2x2: params after the first apply within "
          f"{MODEL_PARAM_FRAC} of each leaf's largest")
    # (h) FSDP over 2 x 2 in process against (a), bit for bit, timed
    # beside (a)'s step run again without snapshots
    t_fsdp = time.perf_counter()
    counters(reset=True)
    fsdp = {"2x2_unplaced": placed_run(
        T, cfg, params, batches, tokens, counters, T["inprocess"],
        "granite-8b 2x2", MODEL_MESH, False)}
    counters(reset=True)
    kept_h = []
    fsdp["2x2"] = placed_run(T, cfg, params, batches, tokens, counters,
                             T["inprocess"], "granite-8b 2x2 FSDP",
                             MODEL_MESH, True, snapshots=kept,
                             keep=kept_h, sample=True)
    check(fsdp["2x2"]["losses"] == run["losses"],
          "granite-8b 2x2 FSDP: (a)'s losses")
    print(f"  (h) granite-8b 2x2 FSDP: losses, params and accumulator "
          f"bit-identical to (a) at both applies; "
          f"{_fill_apply(fsdp['2x2'])} vs (a) unplaced "
          f"{_fill_apply(fsdp['2x2_unplaced'])}; held "
          f"{fsdp['2x2']['held_bytes']:,} B, largest gather "
          f"{fsdp['2x2']['largest_gather']}, re-layout transient at most "
          f"{fsdp['2x2']['relayout_bound_bytes']:,} B; microstep s "
          f"{[r['seconds'] for r in fsdp['2x2']['microsteps']]}")
    fsdp_s = time.perf_counter() - t_fsdp
    pg = T["process_group"]
    with tempfile.TemporaryDirectory() as tmp:
        world, _ = pg.join(0, 1, f"file://{os.path.join(tmp, 'store')}",
                           "cuda", timeout=300.0)
        try:
            check(world.backend == "nccl" and list(world.model_shards(2))
                  == [0, 1], "one NCCL rank holding the 2 model shards")
            counters(reset=True)
            nccl = model_axis_run(T, cfg, params, batches, tokens, LM_M,
                                  counters, world, "granite-8b 2x2 NCCL",
                                  sample=False, snapshots=kept)
            del kept
            # (i) FSDP over the one NCCL rank against (h)
            t_fsdp = time.perf_counter()
            counters(reset=True)
            fsdp["2x2_nccl"] = placed_run(
                T, cfg, params, batches, tokens, counters, world,
                "granite-8b 2x2 FSDP NCCL", MODEL_MESH, True,
                snapshots=kept_h)
            fsdp_s += time.perf_counter() - t_fsdp
        finally:
            pg.leave()
    del nccl["state"], nccl["layout"], nccl["first_apply_params"], kept_h
    check(nccl["losses"] == run["losses"],
          "granite-8b 2x2 NCCL: the in-process run's losses")
    check(fsdp["2x2_nccl"]["losses"] == run["losses"],
          "granite-8b 2x2 FSDP NCCL: the in-process run's losses")
    print(f"  granite-8b 2x2 over one NCCL rank: losses equal, state "
          f"bit-identical at both applies; microstep s "
          f"{[r['seconds'] for r in nccl['microsteps']]}")
    print(f"  (i) granite-8b 2x2 FSDP over one NCCL rank: state "
          f"bit-identical to (h) at both applies; "
          f"{_fill_apply(fsdp['2x2_nccl'])}")
    torch.cuda.empty_cache()
    # (j) FSDP at 4 x 1 (phase 16's configuration) against the same step
    # with the weights whole over data
    t_fsdp = time.perf_counter()
    kept_j = []
    counters(reset=True)
    fsdp["4x1_unplaced"] = placed_run(
        T, cfg, params, batches, tokens, counters, T["inprocess"],
        "granite-8b 4x1", FSDP_MESH, False, keep=kept_j)
    counters(reset=True)
    fsdp["4x1"] = placed_run(
        T, cfg, params, batches, tokens, counters, T["inprocess"],
        "granite-8b 4x1 FSDP", FSDP_MESH, True, snapshots=kept_j,
        sample=True)
    del kept_j
    torch.cuda.empty_cache()
    check(fsdp["4x1"]["losses"] == fsdp["4x1_unplaced"]["losses"],
          "granite-8b 4x1 FSDP: the unplaced run's losses")
    print(f"  (j) granite-8b 4x1 FSDP: state bit-identical to the "
          f"unplaced 4x1 run at both applies; {_fill_apply(fsdp['4x1'])} "
          f"vs unplaced {_fill_apply(fsdp['4x1_unplaced'])}; held "
          f"{fsdp['4x1']['held_bytes']:,} B, largest gather "
          f"{fsdp['4x1']['largest_gather']}, re-layout transient at most "
          f"{fsdp['4x1']['relayout_bound_bytes']:,} B")
    fsdp_s += time.perf_counter() - t_fsdp
    fsdp["seconds"] = fsdp_s
    t_wide = time.perf_counter()
    del one["params"]
    wide = model_axis_wide(T, counters, cfg, params, batches[:LM_M],
                           tokens[:LM_M])
    wide["seconds"] = time.perf_counter() - t_wide
    del params, batches
    torch.cuda.empty_cache()
    return {"in_process": run, "nccl": nccl, "unsharded": one,
            "first_loss_rel": first_loss, "param_leaf_fracs": fracs,
            "gba_apply": timing, "wide": wide, "fsdp": fsdp}


def model_axis_against(T: dict, label: str, run: dict, one: dict) -> dict:
    """A sharded run's first global step against the unsharded step's on
    the same params and batches: the first loss and each leaf of the
    params after the first apply, under ``MODEL_LOSS_FRAC`` and
    ``MODEL_PARAM_FRAC``; prints both runs' microstep seconds and
    peaks."""
    first_loss = abs(run["losses"][0] - one["losses"][0]) / abs(
        one["losses"][0])
    fracs = _leaf_fracs(T, run.pop("first_apply_params"), one["params"])
    micro = [r["seconds"] for r in run["microsteps"]]
    print(f"  {label}: split {run['split']}, attention {run['attn']}; "
          f"losses {run['losses']} vs unsharded {one['losses']}; first loss "
          f"rel {first_loss:.3g}; params after the first apply within "
          f"{max(fracs):.3g} of each leaf's largest; microstep s {micro} "
          f"(the last applies) vs unsharded {one['seconds']}; peak "
          f"{run['peak_gb']:.2f} GB vs unsharded {one['peak_gb']:.2f} GB; "
          f"N per model shard {run['N_per_model_shard']:,}, "
          f"{run['shard_size']:,} a launch")
    check(first_loss <= MODEL_LOSS_FRAC,
          f"{label}: the first loss within {MODEL_LOSS_FRAC} of the "
          f"unsharded step's")
    check(max(fracs) <= MODEL_PARAM_FRAC,
          f"{label}: params after the first apply within "
          f"{MODEL_PARAM_FRAC} of each leaf's largest")
    return {"first_loss_rel": first_loss, "max_param_leaf_frac": max(fracs),
            "microstep_s": micro, "unsharded_microstep_s": one["seconds"],
            "peak_gb": run["peak_gb"], "unsharded_peak_gb": one["peak_gb"]}


def model_axis_row(T: dict, counters, label: str, cfg, params: dict,
                   batches: list, tokens: list, mesh: tuple) -> dict:
    """One global step of ``cfg`` over ``mesh`` in process against the
    unsharded step's on the same params and batches, one after the
    other, memory freed between (:func:`model_axis_against`)."""
    one = _unsharded(T, cfg, params, batches, tokens)
    torch.cuda.empty_cache()
    counters(reset=True)
    run = model_axis_run(T, cfg, params, batches, tokens, LM_M, counters,
                         T["inprocess"], label, sample=False, mesh=mesh)
    against = model_axis_against(T, label, run, one)
    del one["params"]
    return {**run, **against}


def model_axis_wide(T: dict, counters, cfg, params: dict, batches: list,
                    tokens: list) -> dict:
    """(f) the rules' head_dim fallback over 2 x 16 at full width, the
    filled leaves drawn (:func:`draw_fills`), one global step each
    against its unsharded step: granite-8b (its 8 KV heads along
    head_dim, the q heads by heads) on (a)'s params, 32 ``gba_apply``
    launches of ~26 M elements, timed at that block; then starcoder2-3b
    cut to ``MODEL_HEAD_DIM_DEPTH`` (24 heads: every projection along
    head_dim)."""
    run = model_axis_row(T, counters, "granite-8b 2x16", cfg,
                         draw_fills(T, params, 2), batches, tokens,
                         MODEL_WIDE)
    check(run["attn"] == ["heads", "head_dim"],
          "granite-8b 2x16: k and v along head_dim")
    ss = run["shard_size"]
    state = run.pop("state")
    timing = apply_block_timing(
        T, run.pop("layout").ravel(state["params"][0])[:ss],
        state["accum"][:ss], state["buffer"]["grads"][:, 0],
        state["buffer"], LM_M)
    del state
    torch.cuda.empty_cache()
    out = {"granite": run, "gba_apply": timing}
    arch = "starcoder2-3b"
    scfg = dataclasses.replace(T["get_config"](arch),
                               num_layers=MODEL_HEAD_DIM_DEPTH[arch])
    sparams = draw_fills(T, T["init_model"](
        scfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda"), 3)
    srun = model_axis_row(T, counters, f"{arch} 2x16", scfg, sparams,
                          lm_batches(T, scfg.vocab_size, LM_SEQ, LM_BATCH,
                                     LM_M, "cuda"), tokens, MODEL_WIDE)
    del srun["state"], srun["layout"], sparams
    torch.cuda.empty_cache()
    check(srun["attn"] == ["head_dim", "head_dim"],
          f"{arch} 2x16: every projection along head_dim")
    out["starcoder2"] = {**srun, "depth": scfg.num_layers}
    out["launches"] = {"granite_2x16": run["launches"],
                       "starcoder2_2x16": srun["launches"]}
    return out


def draw_fills(T: dict, params: dict, seed: int) -> dict:
    """Each leaf that ``init_model`` fills with a constant (the norm
    scales, ``A_log``, ``dt_bias``, ``D_skip``) drawn at 0.1 N(0, 1) about
    it, in place, as ``tests/test_torch_archs_ssm.py`` draws them: one
    Adagrad apply moves a leaf of zeros to about +-lr, so its largest
    magnitude would be the step itself, and bf16 noise in a gradient near
    zero would read as a fraction of it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for leaf in T["leaves"](params):
        if leaf.numel() > 1 and bool(leaf.min() == leaf.max()):
            leaf.add_((0.1 * torch.randn(leaf.shape, generator=gen,
                                         device="cuda")).to(leaf.dtype))
    return params


def model_axis_ssm(T: dict, counters) -> dict:
    """(e) the Mamba2 archs at full width, bf16, over the 2 x 2 mesh in
    process, at the depths of ``MODEL_SSM_DEPTHS``, the filled leaves
    drawn (:func:`draw_fills`): one global step against the unsharded
    step's on the same params and batches (the mixer gathered whole on
    each model shard; zamba2's shared attention split by heads), 4
    ``gba_apply`` launches an apply, the whole leaves bit-identical across
    the model shards."""
    out, tokens = {}, [0] * LM_M
    for arch in SSM_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(T["get_config"](arch),
                                  num_layers=MODEL_SSM_DEPTHS[arch])
        params = draw_fills(T, T["init_model"](
            cfg, generator=torch.Generator(device="cuda").manual_seed(0),
            device="cuda"), 1)
        run = model_axis_row(T, counters, f"{arch} 2x2 depth "
                             f"{cfg.num_layers}", cfg, params,
                             lm_batches(T, cfg.vocab_size, LM_SEQ, LM_BATCH,
                                        LM_M, "cuda"), tokens, MODEL_MESH)
        del run["state"], run["layout"], params
        torch.cuda.empty_cache()
        check("mamba" in run["split"], f"{arch} 2x2: the mixer splits")
        out[arch] = {**run, "depth": cfg.num_layers,
                     "of_layers": T["get_config"](arch).num_layers,
                     "seconds": time.perf_counter() - t0}
    return out


def model_axis_wire(T: dict, counters) -> dict:
    """(g) ``launch.train`` on ``granite-8b.reduced()`` with ``--compress
    int8`` at ``--mesh 4x2`` (the wire step over the 4 data workers, the
    model axis replicated) against ``--mesh 4x1`` on the card: the losses
    and the launches of each kernel bit for bit equal."""
    runs = {}
    for mesh in ("4x2", "4x1"):
        counters(reset=True)
        losses = T["train"].main(MODEL_WIRE_ARGS + ["--mesh", mesh])
        torch.cuda.synchronize()
        runs[mesh] = {"losses": losses, "launches": counters()}
    same = np.array_equal(np.asarray(runs["4x2"]["losses"]).view(np.int64),
                          np.asarray(runs["4x1"]["losses"]).view(np.int64))
    print(f"  reduced int8 wire at 4x2 vs 4x1: losses "
          f"{runs['4x2']['losses']} vs {runs['4x1']['losses']}, "
          f"bit-identical {same}; launches {runs['4x2']['launches']}")
    check(same and runs["4x2"]["launches"] == runs["4x1"]["launches"],
          "the int8 wire at --mesh 4x2 bit for bit the --mesh 4x1 run")
    check(runs["4x2"]["launches"]["quantize_minmax"] > 0,
          "the int8 wire at --mesh 4x2 launched quantize_minmax")
    return runs


def model_axis_moe(T: dict, counters) -> dict:
    """(c) phi3.5-moe at full width, depth 1, over the 2x2 mesh (8
    experts a model shard) at the M that ``train_plan`` fits: every route
    of its first global step equal to the unsharded step's on the same
    params and batches, 4 launches an apply, the peak."""
    full = T["get_config"](MODEL_MOE)
    torch.cuda.empty_cache()
    plan, why = train_plan(T, full)
    check(plan is not None, f"{MODEL_MOE}: {why}")
    m = plan["m"]
    cfg = dataclasses.replace(full, num_layers=1)
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    batches = lm_batches(T, cfg.vocab_size, LM_SEQ, LM_BATCH, m, "cuda")
    tokens = [0] * m
    with record_routes(T) as base:
        one = _unsharded(T, cfg, params, batches, tokens)
    del one["params"]
    torch.cuda.empty_cache()
    counters(reset=True)
    with record_routes(T) as seen:
        run = model_axis_run(T, cfg, params, batches, tokens, m, counters,
                             T["inprocess"], f"{MODEL_MOE} 2x2",
                             sample=False)
    del run["state"], run["layout"], run["first_apply_params"], params
    torch.cuda.empty_cache()
    pairs = list(zip(base.routes, seen.routes[:m]))
    differ = [i for i, (a, b) in enumerate(pairs)
              if not (torch.equal(a["sel"], b["sel"])
                      and torch.equal(a["keep"], b["keep"]))]
    print(f"  {MODEL_MOE} 2x2, depth 1, M={m}: {len(pairs)} routes of the "
          f"first global step, {len(differ)} differ from the unsharded "
          f"step's; losses {run['losses']} vs {one['losses']}; peak "
          f"{run['peak_gb']:.2f} GB vs unsharded {one['peak_gb']:.2f} GB")
    check(len(pairs) == m and not differ,
          f"{MODEL_MOE} 2x2: every route equal to the unsharded step's")
    return {"M": m, "routes": len(pairs), "routes_differ": len(differ),
            "run": run, "unsharded": one}


def model_axis_phase(T: dict, counters) -> dict:
    phase(22, "the model axis: --fused --mesh 2x2 (2 data x 2 model "
              "shards): granite-8b and phi3.5-moe at full width, (f) the "
              "head_dim fallback over 2 x 16, (e) the Mamba2 archs, the "
              "ten archs' reduced steps card vs CPU, (g) the int8 wire at "
              "4 x 2, (h)-(j) FSDP of the weights over data at 2 x 2 (in "
              "process, one NCCL rank) and 4 x 1")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    expandable_segments(True)
    out = {"granite": model_axis_granite(T, counters),
           "moe": model_axis_moe(T, counters)}
    wide, fsdp = out["granite"]["wide"], out["granite"]["fsdp"]
    t0 = time.perf_counter()
    out["ssm"] = model_axis_ssm(T, counters)
    ssm_s = time.perf_counter() - t0
    counters(reset=True)
    t0 = time.perf_counter()
    out["reduced_f32"] = {arch: train_card_vs_cpu(
        T, arch, MODEL_MESH[0],
        SSM_TRAIN_FLAT_RTOL.get(arch, HOLD_LM_RTOL), model=MODEL_MESH[1])
        for arch in MODEL_ARCHS}
    out["reduced_launches"] = counters()["gba_apply"]
    reduced_s = time.perf_counter() - t0
    check(out["reduced_launches"] == len(MODEL_ARCHS) * 2 * 4,
          f"the reduced steps on the card: 8 gba_apply launches each")
    expandable_segments(False)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["wire"] = model_axis_wire(T, counters)
    wire_s = time.perf_counter() - t0
    out["launches"] = {
        "granite_2x2": out["granite"]["in_process"]["launches"],
        "granite_2x2_nccl": out["granite"]["nccl"]["launches"],
        "moe_2x2": out["moe"]["run"]["launches"],
        **wide["launches"],
        **{f"{a.split('-')[0]}_2x2": out["ssm"][a]["launches"]
           for a in SSM_ARCHS},
        "reduced_2x2": out["reduced_launches"],
        "int8_wire_4x2": out["wire"]["4x2"]["launches"]["gba_apply"],
        **{f"fsdp_{k}": v["launches"] for k, v in fsdp.items()
           if isinstance(v, dict) and "launches" in v}}
    out["seconds"] = time.perf_counter() - t_phase
    out["row_seconds"] = {"head_dim_2x16": wide["seconds"], "ssm": ssm_s,
                          "reduced": reduced_s, "wire": wire_s,
                          "fsdp": fsdp["seconds"]}
    earlier = (out["seconds"] - ssm_s - wide["seconds"] - wire_s
               - fsdp["seconds"])
    print(f"  phase 22: {out['seconds']:.1f} s; rows "
          f"{json.dumps(out['row_seconds'])}; rows (a)-(d) "
          f"{earlier:.1f} s (budget {MODEL_BUDGET_S:.0f} s); gba_apply "
          f"launches {json.dumps(out['launches'])}")
    for what, secs, budget in (
            ("phase 22's rows (a)-(d)", earlier, MODEL_BUDGET_S),
            ("(e) the Mamba2 archs over 2 x 2", ssm_s, MODEL_SSM_BUDGET_S),
            ("(f) the head_dim fallback over 2 x 16", wide["seconds"],
             MODEL_WIDE_BUDGET_S),
            ("(g) the int8 wire at 4 x 2", wire_s, MODEL_WIRE_BUDGET_S),
            ("(h)-(j) FSDP over data", fsdp["seconds"], FSDP_BUDGET_S)):
        check(secs <= budget, f"{what} within its budget of {budget} s")
    return out


# ---------------------------------------------------------------------------
# phase 23: launch.steps.build_step over a (data, model) mesh

# (a) and (b): the serve loop of phase 13 through the placed steps
STEPS_SERVE_MESHES = {"a": (1, 4), "b": (2, 2)}
# tokens each serve loop of the phase generates: the prefill's and
# STEPS_GEN - 1 greedy decode steps (phase 13 takes SERVE_GEN); the
# loops are host-paced at granite-8b's 36 layers, so their count sets
# most of the phase's time
STEPS_GEN = 8
# (c) the placed pytree step: depth 2, one apply at M = LM_M
STEPS_TRAIN_MESH = (2, 2)
# (d) the dry run's argument bytes against the card's allocation
STEPS_ARG_FRAC = 0.01
# flash_decode launches of one placed decode step sampled against the
# plain version on their own inputs
STEPS_FLASH_SAMPLED = 8
# (c) against the unplaced pytree step in bf16: one bf16 ulp of a param
# (relative), the count of sampled params beyond Adam's step printed
STEPS_TRAIN_ULP = 2.0**-7
# (c) Adam's m after the apply, (1 - b1) times the accumulated gradient,
# against the unplaced step's: each leaf's relative L2 difference (the
# bf16 gradients of two half batches summed in float32 against one whole
# batch's; a gradient of the wrong sign, of half the batch, or without
# the data reduce is 0.5 or more)
STEPS_M_FRAC = 2.0**-5
STEPS_BUDGET_S = 90.0


class recorded_flash:
    """Within the block, each ``ops.flash_decode`` call's inputs are kept
    (clones, the first ``n``) beside its output."""

    def __init__(self, T: dict, n: int):
        self.ops, self.n, self.calls = T["ops"], n, []

    def __enter__(self):
        self.saved = fn = self.ops.flash_decode

        def rec(q, k, v, pos):
            out = fn(q, k, v, pos)
            if len(self.calls) < self.n:
                self.calls.append((q.clone(), k.clone(), v.clone(),
                                   pos.clone() if torch.is_tensor(pos)
                                   else pos, out.clone()))
            return out
        self.ops.flash_decode = rec
        return self

    def __exit__(self, *exc):
        self.ops.flash_decode = self.saved


def placed_serve(T: dict, cfg, params, prompts, mesh: tuple, serve_tp: bool,
                 counters, world, label: str) -> dict:
    """The fixed-batch loop of phase 13 through ``build_step``'s prefill
    and decode over ``mesh`` (weights by ``serve_param_specs`` where
    ``serve_tp``, else ``param_specs``, gathered over ``data`` on use):
    the prefill of the prompts into a cache of ``SERVE_PROMPT +
    STEPS_GEN`` positions, then ``STEPS_GEN - 1`` greedy decode steps,
    counted; then one more step with its ``flash_decode`` launches
    sampled against the plain version on their own inputs."""
    St, Mesh, Shape = T["steps"], T["Mesh"], T["InputShape"]
    m = Mesh(("data", "model"), mesh)
    b, cache_len = prompts.shape[0], SERVE_PROMPT + STEPS_GEN
    pre, _ = St.build_step(cfg, Shape("p", SERVE_PROMPT, b, "prefill"), m,
                           serve_tp=serve_tp, world=world,
                           cache_len=cache_len)
    dec, _ = St.build_step(cfg, Shape("d", cache_len, b, "decode"), m,
                           serve_tp=serve_tp, world=world)
    whole_over_data = not any(
        T["sharding"].data_dims(sp) for _, sp in
        T["tree_paths"](pre.placement.specs))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    held = pre.place_params(params)
    torch.cuda.synchronize()
    held_bytes = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    counters(reset=True)
    t0 = time.perf_counter()
    logits, caches = pre(held, pre.place_batch({"tokens": prompts}))
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    out_logits, tokens = [logits[:, None]], [tok]
    for _ in range(STEPS_GEN - 1):
        tok, lg, caches = dec(held, tok, caches)
        out_logits.append(lg)
        tokens.append(tok)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with recorded_flash(T, STEPS_FLASH_SAMPLED) as rec:
        dec(held, tok, caches)
    errs = []
    for i, (q, k, v, p, o) in enumerate(rec.calls):
        want = T["flash_decode_ref"](q, k, v, p).float()
        errs.append((o.float() - want).abs().max().item())
        ok = torch.allclose(o.float(), want, rtol=BF16_RTOL, atol=BF16_ATOL)
        print(f"  {label}: flash_decode launch {i} of the placed decode, q "
              f"{tuple(q.shape)} against k {tuple(k.shape)} at pos "
              f"{int(p)}: max |err| {errs[-1]!r} {'ok' if ok else 'FAIL'}")
        check(ok, f"{label}: flash_decode launch {i} held to the plain "
                  f"version on its inputs")
    n = min(STEPS_FLASH_SAMPLED, cfg.num_layers * len(dec.tp.held))
    check(len(errs) == n, f"{label}: {n} flash_decode launches sampled")
    shapes = sorted({(tuple(q.shape), tuple(k.shape)) for q, k, *_ in
                     rec.calls})
    return {"label": label, "logits": torch.cat(out_logits, dim=1),
            "tokens": torch.cat(tokens, dim=1), "caches": caches,
            "launches": launches, "seconds": seconds, "peak_gb": peak_gb,
            "held_bytes": held_bytes, "whole_over_data": whole_over_data,
            "flash_sampled": len(errs), "flash_max_abs_err": max(errs),
            "flash_shapes": shapes, "held_model": list(dec.tp.held)}


def _serve_hold(T: dict, cfg, params, prompts, run: dict) -> dict:
    """``run``'s logits against the unplaced decode fed its tokens
    (phase 13's forced run): within ``SERVE_LOGIT_FRAC`` of the largest;
    each greedy token of ``run`` that the unplaced logits would not pick
    printed with its step and the unplaced margin."""
    tokens = run["tokens"]
    want, _ = _forced(T, params, cfg, prompts, tokens,
                      SERVE_PROMPT + STEPS_GEN)
    err = (run["logits"].float() - want).abs().max().item()
    scale = want.abs().max().item()
    picks = want.argmax(-1)
    differ = (picks != tokens).nonzero().tolist()
    for row, step in differ:
        top = torch.topk(want[row, step], 2).values
        print(f"  {run['label']}: greedy token of row {row} at step {step} "
              f"differs from the unplaced decode's; its margin there "
              f"{(top[0] - top[1]).item()!r}")
    check(bool(torch.isfinite(run["logits"]).all()),
          f"{run['label']}: finite logits")
    check(err <= SERVE_LOGIT_FRAC[cfg.dtype] * scale,
          f"{run['label']}: logits within {SERVE_LOGIT_FRAC[cfg.dtype]} of "
          f"the largest of the unplaced decode's: {err} of {scale}")
    return {"logit_max_abs_diff": err, "logit_max_abs": scale,
            "tokens_differing": len(differ)}


def steps_serve(T: dict, counters, cfg, params, prompts) -> dict:
    """(a) 1 x 4 by ``serve_param_specs``, 4 ``flash_decode`` launches a
    layer a step; (b) 2 x 2 by ``param_specs``, in process and over one
    NCCL rank, bit-identical."""
    out = {}
    a = placed_serve(T, cfg, params, prompts, STEPS_SERVE_MESHES["a"], True,
                     counters, T["inprocess"], "(a) 1x4 serve_tp")
    check(a["whole_over_data"], "(a): serve_param_specs within the card's "
          "memory: every weight whole over data")
    want = cfg.num_layers * 4 * (STEPS_GEN - 1)
    check(a["launches"]["flash_decode"] == want,
          f"(a): {cfg.num_layers} layers x 4 model shards flash_decode "
          f"launches a step: {a['launches']['flash_decode']} != {want}")
    check(all(k[0][1] == cfg.num_kv_heads // 4 for k in a["flash_shapes"]),
          f"(a): each launch on one shard's {cfg.num_kv_heads // 4} KV heads")
    out["a"] = {**_serve_hold(T, cfg, params, prompts, a),
                **{k: v for k, v in a.items()
                   if k not in ("logits", "tokens", "caches")}}
    del a
    torch.cuda.empty_cache()
    b = placed_serve(T, cfg, params, prompts, STEPS_SERVE_MESHES["b"], False,
                     counters, T["inprocess"], "(b) 2x2 param_specs")
    check(not b["whole_over_data"], "(b): weights split over data")
    want = cfg.num_layers * 2 * (STEPS_GEN - 1)
    check(b["launches"]["flash_decode"] == want,
          f"(b): {cfg.num_layers} layers x 2 model shards flash_decode "
          f"launches a step in process: {b['launches']['flash_decode']}")
    hold = _serve_hold(T, cfg, params, prompts, b)
    kept = (b["logits"].cpu(), b["tokens"].cpu(),
            [x.cpu() for c in b["caches"] for x in T["leaves"](c)])
    out["b"] = {**hold, **{k: v for k, v in b.items()
                           if k not in ("logits", "tokens", "caches")}}
    del b
    torch.cuda.empty_cache()
    pg = T["process_group"]
    with tempfile.TemporaryDirectory() as tmp:
        world, _ = pg.join(0, 1, f"file://{os.path.join(tmp, 'store')}",
                           "cuda", timeout=300.0)
        try:
            n = placed_serve(T, cfg, params, prompts,
                             STEPS_SERVE_MESHES["b"], False, counters,
                             world, "(b) 2x2 param_specs NCCL")
        finally:
            pg.leave()
    check(_same_bits(n["logits"].cpu(), kept[0])
          and torch.equal(n["tokens"].cpu(), kept[1])
          and all(_same_bits(x.cpu(), y) for x, y in zip(
              [x for c in n["caches"] for x in T["leaves"](c)], kept[2])),
          "(b): logits, tokens and every cache slice bit-identical over "
          "one NCCL rank")
    out["b_nccl"] = {k: v for k, v in n.items()
                     if k not in ("logits", "tokens", "caches")}
    return out


def _sampled(T: dict, tree, n: int, seed: int) -> list:
    """``n`` elements of every leaf of ``tree`` at seeded positions, as
    float32 on the host."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _, x in T["tree_paths"](tree):
        idx = torch.randint(0, x.numel(), (min(n, x.numel()),), generator=g)
        out.append(x.reshape(-1)[idx.to(x.device)].float().cpu())
    return out


def steps_train(T: dict, counters, cfg, params, batches) -> dict:
    """(c) the placed pytree step over 2 x 2, M = ``LM_M``, one apply,
    against the unplaced pytree step from the same params and batches
    (the first loss, and Adam's ``m`` after the apply, which carries the
    accumulated gradient, leaf by leaf), then over one NCCL rank
    bit-identical."""
    gba = T["GBAConfig"](local_batch=LM_BATCH, buffer_size=LM_M,
                         staleness_tolerance=LM_IOTA)
    Mesh, Shape = T["Mesh"], T["InputShape"]
    shape = Shape("t", LM_SEQ, LM_BATCH, "train")
    progs = T["build_programs"](cfg, gba, params=T["tree_map"](
        torch.clone, params), mode="pytree", lr=LM_LR)
    state, want = progs.state, []
    for i, b in enumerate(batches):
        state, loss = progs.step(state, b, i // LM_M)
        want.append(float(loss))
    want_p = _sampled(T, state["params"], 4096, 0)
    want_m = state["opt"]["m"]
    del progs, state
    torch.cuda.empty_cache()

    def run(world, label):
        step, _ = T["steps"].build_step(cfg, shape, Mesh(
            ("data", "model"), STEPS_TRAIN_MESH), gba, world=world)
        st = step.init_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, t0 = [], time.perf_counter()
        for i, b in enumerate(batches):
            st, loss = step(st, step.place_batch(b), i // LM_M)
            losses.append(float(loss))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(st["gstep"] == 1 and st["micro"] == LM_M,
              f"{label}: one apply in {LM_M} microsteps")
        blocks = [x.cpu() for part in ("params", "acc") for x in
                  T["leaves"](st[part])] + [
            x.cpu() for x in T["leaves"](st["opt"])]
        got_p = _sampled(T, step.gather_params(st["params"]), 4096, 0)
        got_m = step.gather_params(st["opt"]["m"])
        m_rel = {"/".join(p): ((a - b).norm() / b.norm()).item()
                 for (p, a), (_, b) in zip(T["tree_paths"](got_m),
                                           T["tree_paths"](want_m))}
        del got_m
        return {"losses": losses, "seconds": secs,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "m_rel_l2": m_rel}, blocks, got_p

    here, blocks, got_p = run(T["inprocess"], "(c) 2x2 in process")
    first = abs(here["losses"][0] - want[0]) / abs(want[0])
    diffs = [(a - b).abs() for a, b in zip(got_p, want_p)]
    worst = max(d.max().item() for d in diffs)
    beyond = sum(int((d > STEPS_TRAIN_ULP * b.abs()).sum())
                 for d, b in zip(diffs, want_p))
    total = sum(d.numel() for d in diffs)
    print(f"  (c) placed pytree step 2x2: losses {here['losses']} vs "
          f"unplaced {want}; first loss rel {first:.3g}; sampled params "
          f"after the apply: largest difference {worst!r}, {beyond} of "
          f"{total} beyond one bf16 ulp; {here['seconds']:.2f} s, peak "
          f"{here['peak_gb']:.2f} GB")
    check(first <= MODEL_LOSS_FRAC,
          f"(c): the first loss within {MODEL_LOSS_FRAC} of the unplaced "
          f"pytree step's")
    m_worst = max(here["m_rel_l2"].values())
    print(f"  (c) Adam's m after the apply against the unplaced step's, "
          f"relative L2 by leaf: {json.dumps(here['m_rel_l2'])}")
    check(m_worst <= STEPS_M_FRAC,
          f"(c): Adam's m after the apply within {STEPS_M_FRAC} (relative "
          f"L2, each leaf) of the unplaced step's: worst {m_worst!r}")
    pg = T["process_group"]
    with tempfile.TemporaryDirectory() as tmp:
        world, _ = pg.join(0, 1, f"file://{os.path.join(tmp, 'store')}",
                           "cuda", timeout=300.0)
        try:
            nccl, nblocks, _ = run(world, "(c) 2x2 NCCL")
        finally:
            pg.leave()
    check(nccl["losses"] == here["losses"]
          and all(_same_bits(x, y) for x, y in zip(nblocks, blocks)),
          "(c): losses and every held block bit-identical over one NCCL "
          "rank")
    del want_m
    return {"in_process": here, "nccl": nccl, "unplaced_losses": want,
            "first_loss_rel": first, "m_rel_l2_worst": m_worst,
            "param_max_abs_diff": worst, "params_beyond_ulp": beyond,
            "params_sampled": total}


def steps_dryrun(T: dict, cfg_serve, params, prompts, cfg_train,
                 train_params, batch) -> dict:
    """(d) the dry run at a 1 x 1 mesh for (a)'s decode and (c)'s
    microstep against the same steps at 1 x 1 on the card: the argument
    bytes against the allocation of the held state and inputs, and the
    argument and temporary bytes against the step's peak."""
    D, Mesh, Shape = T["dryrun"], T["Mesh"], T["InputShape"]
    one = Mesh(("data", "model"), (1, 1))
    cache_len = SERVE_PROMPT + STEPS_GEN
    b = prompts.shape[0]
    out = {}
    gba = T["GBAConfig"](local_batch=LM_BATCH, buffer_size=LM_M,
                         staleness_tolerance=LM_IOTA)
    cases = (("decode", cfg_serve, Shape("d", cache_len, b, "decode"),
              None),
             ("train", cfg_train, Shape("t", LM_SEQ, LM_BATCH, "train"),
              gba))
    for name, cfg, shape, g in cases:
        rec = D.dryrun_step(cfg, shape, one, {"gba": g} if g else {})
        step, _ = T["steps"].build_step(cfg, shape, one, g)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        if name == "decode":
            _, cache = T["transformer"].prefill(params, cfg, prompts,
                                                cache_len=cache_len)
            args = (step.place_params(params),
                    prompts[:, -1:].to(torch.int32).contiguous(),
                    step.place_cache(cache))
            del cache
        else:
            st = step.init_state(train_params)
            st["micro"] = LM_M - 1
            args = (st, step.place_batch(batch), 0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        peak_base = torch.cuda.memory_allocated()
        res = step(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del res, args, step
        arg_b = rec["memory"]["argument_bytes"]
        temp_b = rec["memory"]["temp_bytes"]
        out[name] = {"argument_bytes": arg_b, "allocated_bytes": held,
                     "temp_bytes": temp_b, "peak_bytes": peak,
                     "traced_over_peak": (arg_b + temp_b) / peak,
                     "flops": rec["flops"], "trace_s": rec["trace_s"],
                     "at_start_bytes": peak_base - base}
        print(f"  (d) {name}: dry-run argument bytes {arg_b:,} vs "
              f"allocated {held:,} (rel {abs(arg_b - held) / held:.4f}); "
              f"argument + temp {arg_b + temp_b:,} vs the step's peak "
              f"{peak:,} (ratio {(arg_b + temp_b) / peak:.3f}); traced in "
              f"{rec['trace_s']} s")
        check(abs(arg_b - held) <= STEPS_ARG_FRAC * held,
              f"(d) {name}: the dry run's argument bytes within "
              f"{STEPS_ARG_FRAC} of the card's allocation")
        torch.cuda.empty_cache()
    return out


def _median(xs: list) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else (
        xs[len(xs) // 2 - 1] + xs[len(xs) // 2]) / 2


def steps_one_device(T: dict, cfg, params, prompts, cfg_train,
                     train_params, batches) -> dict:
    """(e) the placed steps at a 1 x 1 mesh against the unplaced ones on
    the card, timed in the order unplaced, placed, placed, unplaced: (a)'s
    serve loop (``transformer.prefill`` and ``decode_step``, phase 13's
    path, against ``build_step``'s prefill and decode), and (c)'s pytree
    step over 2 M microsteps (``build_programs(mode="pytree")``, phase
    12's, against ``build_step``'s train step).  Prints whether the two
    give the same bits; holds the placed serve within the serve
    tolerance of the unplaced one and its losses within the first-loss
    tolerance."""
    St, Tm, Mesh, Shape = T["steps"], T["transformer"], T["Mesh"], \
        T["InputShape"]
    one = Mesh(("data", "model"), (1, 1))
    b, cache_len = prompts.shape[0], SERVE_PROMPT + STEPS_GEN
    pre, _ = St.build_step(cfg, Shape("p", SERVE_PROMPT, b, "prefill"), one,
                           cache_len=cache_len)
    dec, _ = St.build_step(cfg, Shape("d", cache_len, b, "decode"), one)
    held = pre.place_params(params)

    def serve(placed: bool):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            if placed:
                logits, cache = pre(held, {"tokens": prompts})
            else:
                logits, cache = Tm.prefill(params, cfg, prompts,
                                           cache_len=cache_len)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            out = [logits[:, None]]
            for _ in range(STEPS_GEN - 1):
                if placed:
                    tok, lg, cache = dec(held, tok, cache)
                else:
                    lg, cache = Tm.decode_step(params, cfg, tok, cache)
                    tok = lg.argmax(-1).to(torch.int32)
                out.append(lg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return torch.cat(out, dim=1), {
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_a_step": (t2 - t1) * 1e3 / (STEPS_GEN - 1)}

    runs: dict = {"unplaced": [], "placed": []}
    logits = {}
    for placed in (False, True, True, False):
        name = "placed" if placed else "unplaced"
        lg, t = serve(placed)
        runs[name].append(t)
        logits[name] = lg
    same = _same_bits(logits["placed"], logits["unplaced"])
    err = (logits["placed"] - logits["unplaced"]).abs().max().item()
    scale = logits["unplaced"].abs().max().item()
    del held, logits, pre, dec
    torch.cuda.empty_cache()
    check(err <= SERVE_LOGIT_FRAC[cfg.dtype] * scale,
          f"(e): the placed serve at 1x1 within {SERVE_LOGIT_FRAC[cfg.dtype]}"
          f" of the largest of the unplaced serve's logits: {err}")
    serve_out = {name: {k: _median([r[k] for r in rs]) for k in rs[0]}
                 for name, rs in runs.items()}
    serve_out.update(runs=runs, same_bits=same, logit_max_abs_diff=err)

    gba = T["GBAConfig"](local_batch=LM_BATCH, buffer_size=LM_M,
                         staleness_tolerance=LM_IOTA)
    shape = Shape("t", LM_SEQ, LM_BATCH, "train")
    micro = batches + batches

    def train(placed: bool):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        if placed:
            step, _ = St.build_step(cfg_train, shape, one, gba)
            st = step.init_state(train_params)
            feed = step.place_batch
        else:
            progs = T["build_programs"](cfg_train, gba, params=T["tree_map"](
                torch.clone, train_params), mode="pytree", lr=LM_LR)
            step, st, feed = progs.step, progs.state, (lambda x: x)
            del progs
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs, losses = [], []
        for i, bt in enumerate(micro):
            t0 = time.perf_counter()
            st, loss = step(st, feed(bt), i // LM_M)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss))
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        del step, st
        fills = [s for i, s in enumerate(secs) if i and (i + 1) % LM_M]
        applies = [s for i, s in enumerate(secs) if (i + 1) % LM_M == 0]
        return losses, {"fill_s": _median(fills), "apply_s": _median(applies),
                        "first_s": secs[0], "peak_gb": peak}

    truns: dict = {"unplaced": [], "placed": []}
    losses = {}
    for placed in (False, True, True, False):
        name = "placed" if placed else "unplaced"
        ls, t = train(placed)
        truns[name].append(t)
        losses[name] = ls
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["placed"],
                                                   losses["unplaced"]))
    check(rel <= MODEL_LOSS_FRAC,
          f"(e): the placed pytree step's losses at 1x1 within "
          f"{MODEL_LOSS_FRAC} of the unplaced step's: {rel}")
    train_out = {name: {k: _median([r[k] for r in rs]) for k in rs[0]}
                 for name, rs in truns.items()}
    train_out.update(runs=truns, same_losses=losses["placed"]
                     == losses["unplaced"], loss_max_rel=rel)
    for what, o in (("serve", serve_out), ("train", train_out)):
        medians = {k: o[k] for k in ("unplaced", "placed")}
        print(f"  (e) {what} at 1x1, placed against unplaced (medians of "
              f"two runs each): {json.dumps(medians)}; same bits: "
              f"{o.get('same_bits', o.get('same_losses'))}")
    return {"serve": serve_out, "train": train_out}


def steps_phase(T: dict, counters) -> dict:
    phase(23, "launch.steps.build_step: granite-8b served over 1 x 4 "
              "(serve_param_specs) and 2 x 2 (param_specs; in process and "
              "one NCCL rank), the placed pytree step over 2 x 2, the "
              "dry run at 1 x 1 against the card, and the placed steps at "
              "1 x 1 timed against the unplaced ones")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    props = torch.cuda.get_device_properties(0)
    card = props.total_memory
    print(f"  card memory (total_memory) {card:,} B; the dry run's "
          f"serve_tp budget {T['dryrun'].CARD_BYTES:,} B")
    cfg = T["get_config"]("granite-8b")
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=torch.Generator("cuda").manual_seed(1),
                            device="cuda")
    out = {"serve": steps_serve(T, counters, cfg, params, prompts)}
    serve_s = time.perf_counter() - t_phase
    cfg2 = dataclasses.replace(cfg, num_layers=LM_LAYERS)
    small = T["init_model"](cfg2, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    batches = lm_batches(T, cfg2.vocab_size, LM_SEQ, LM_BATCH, LM_M, "cuda")
    t0 = time.perf_counter()
    out["train"] = steps_train(T, counters, cfg2, small, batches)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dryrun"] = steps_dryrun(T, cfg, params, prompts, cfg2, small,
                                 batches[0])
    dry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["one_device"] = steps_one_device(T, cfg, params, prompts, cfg2,
                                         small, batches)
    one_s = time.perf_counter() - t0
    del params, small
    torch.cuda.empty_cache()
    out["card_bytes"] = card
    out["seconds"] = time.perf_counter() - t_phase
    out["row_seconds"] = {"serve": serve_s, "train": train_s,
                          "dryrun": dry_s, "one_device": one_s}
    print(f"  phase 23: {out['seconds']:.1f} s (budget {STEPS_BUDGET_S} s);"
          f" rows {json.dumps(out['row_seconds'])}; {json.dumps(out)}")
    check(out["seconds"] <= STEPS_BUDGET_S,
          f"phase 23 within its budget of {STEPS_BUDGET_S} s")
    check(card == T["dryrun"].CARD_BYTES,
          f"the dry run's serve_tp budget is this card's memory: {card:,}")
    return out



# phase 24: the long-context decode, long_500k (524,288 positions, batch 1),
# whose KV sequence the rules split over data
LONG_LEN = 524_288
LONG_DECODE_STEPS = 4
# flash_decode_partial launches of a step sampled against the plain version
LONG_SAMPLED = 8
LONG_A = ("gemma3-12b", (4, 1))
LONG_B = ("gemma3-12b", 12, (2, 2))        # arch, depth, mesh
LONG_C = ("zamba2-2.7b", (4, 1), 6)        # arch, mesh, held depth
LONG_D = (("starcoder2-3b", 30), ("gemma2-27b", 4))
LONG_D_MESH = (2, 2)
# (b)-(d): the placed logits against the unplaced decode's, within the
# larger of SERVE_LOGIT_FRAC of the largest and LONG_NOISE times the
# deviation of the same decode over (1, T), which (b) and (d) print: at
# full width in bf16 the model axis alone, whose float32 sums run in
# another order, moves the logits of a random-weight stack past 2**-6 of
# the largest (starcoder2-3b's 30 layers, gemma3-12b at depth 12), so the
# split data shards' attention is held tightly at the layer instead,
# LONG_ATTN_SAMPLED calls a route
LONG_NOISE = 2.0
LONG_ATTN_SAMPLED = 3
# a cache's drawn values: k and v N(0, 1), the Mamba2 state and window
# N(0, 0.1^2)
LONG_STATE_SCALE = 0.1
# the timed partial launches: (a)'s and (c)'s slices, every position read
LONG_TIMED = ((1, LONG_LEN // 4, 8, 2, 256), (1, LONG_LEN // 4, 32, 1, 80))
LONG_BUDGET_S = 150.0


def draw_cache(tree, pos: int, seed: int):
    """A cache tree (meta or real tensors, the held slices' lists
    included) drawn on the card from ``seed`` in tree order: ``pos`` an
    int32 scalar, k and v N(0, 1) in their dtype, a Mamba2 state and conv
    window ``LONG_STATE_SCALE`` N(0, 1)."""
    gen = torch.Generator("cuda").manual_seed(seed)

    def draw(name, x):
        if name == "pos":
            return torch.full((), pos, dtype=torch.int32, device="cuda")
        out = torch.randn(x.shape, generator=gen, device="cuda",
                          dtype=x.dtype)
        return out if name in ("k", "v") else out.mul_(LONG_STATE_SCALE)

    def walk(t, name=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, name) for v in t]
        return draw(name, t)

    return walk(tree)


class recorded_partial:
    """Within the block, each ``ops.flash_decode_partial`` call keeps its
    inputs and outputs, the first ``n``: q, pos and the outputs as clones,
    k and v as the slices themselves (a decode step writes a slice's row
    before its launch and never after it, so after the step they are the
    launch's inputs)."""

    def __init__(self, T: dict, n: int):
        self.ops, self.n, self.calls = T["ops"], n, []

    def __enter__(self):
        self.saved = fn = self.ops.flash_decode_partial

        def rec(q, k, v, pos, start=0):
            out, lse = fn(q, k, v, pos, start)
            if len(self.calls) < self.n:
                self.calls.append((q.clone(), k, v, pos.clone(), start,
                                   out.clone(), lse.clone()))
            return out, lse
        self.ops.flash_decode_partial = rec
        return self

    def __exit__(self, *exc):
        self.ops.flash_decode_partial = self.saved


def _hold_partials(T: dict, calls: list, label: str) -> float:
    """Each recorded partial launch against the plain version on its own
    inputs: the float32 out within rtol 1e-5, atol 1e-6 (float32 sums in
    another order), lse within rtol and atol 1e-5 (an empty row: out 0,
    lse -inf on both); the largest |err|."""
    worst = 0.0
    for i, (q, k, v, pos, start, out, lse) in enumerate(calls):
        want, want_lse = T["flash_decode_partial_ref"](q, k, v, pos, start)
        empty = bool((want_lse == -math.inf).all())
        if empty:
            ok = not out.any() and bool((lse == -math.inf).all())
            err = 0.0
        else:
            err = (out - want).abs().max().item()
            ok = (torch.allclose(out, want, rtol=1e-5, atol=1e-6)
                  and torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5))
        worst = max(worst, err)
        print(f"  {label}: flash_decode_partial launch {i}, q "
              f"{tuple(q.shape)} against a k slice {tuple(k.shape)} from "
              f"{start} at pos {int(pos)}{' (empty)' if empty else ''}: max "
              f"|err| {err!r} {'ok' if ok else 'FAIL'}")
        check(ok, f"{label}: partial launch {i} held to the plain version")
    return worst


def long_greedy(T: dict, dec, held, caches, token, steps: int,
                counters=None) -> dict:
    """``steps`` greedy decode steps of ``dec`` from ``token``, each timed
    to a synchronise: tokens, logits (B, steps, V) float32, the first
    step's ms and the median of the others', peak memory, and the
    launches counted over the run where ``counters`` is given."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if counters:
        counters(reset=True)
    toks, logits, ms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        token, lg, caches = dec(held, token, caches)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(token)
        logits.append(lg.float())
    return {"tokens": torch.cat(toks, dim=1), "logits": torch.cat(logits, 1),
            "caches": caches, "first_step_ms": ms[0],
            "step_ms": _median(ms[1:]), "step_ms_each": ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counters() if counters else None}


def long_forced(dec, held, caches, first, tokens) -> torch.Tensor:
    """The logits (B, n, V) float32 of ``dec`` fed ``first`` and then
    ``tokens`` (B, n) but their last."""
    tok, out = first, []
    for i in range(tokens.shape[1]):
        _, lg, caches = dec(held, tok, caches)
        out.append(lg.float())
        tok = tokens[:, i:i + 1]
    return torch.cat(out, dim=1)


def unplaced_logits(T: dict, cfg, params, cache, first, tokens
                    ) -> torch.Tensor:
    """:func:`long_forced` through the unplaced ``decode_step`` on the
    whole ``cache``, which it writes in place."""
    tok, out = first, []
    for i in range(tokens.shape[1]):
        lg, cache = T["transformer"].decode_step(params, cfg, tok, cache)
        out.append(lg.float())
        tok = tokens[:, i:i + 1]
    return torch.cat(out, dim=1)


class recorded_split:
    """Within the block, the first ``n`` calls of each route (kernel,
    masked) of ``layers._split_attend`` keep their inputs, q and pos as
    clones and the slices themselves (written before the call, never
    after it in a step), and their output."""

    def __init__(self, T: dict, n: int):
        self.layers, self.n, self.calls = T["layers"], n, []

    def __enter__(self):
        self.saved = fn = self.layers._split_attend

        def rec(cfg, q, ks, vs, pos, window, tp):
            out, kernel = fn(cfg, q, ks, vs, pos, window, tp)
            if sum(c[-1] == kernel for c in self.calls) < self.n:
                self.calls.append((cfg, q.clone(), ks, vs, pos.clone(),
                                   window, out.clone(), kernel))
            return out, kernel
        self.layers._split_attend = rec
        return self

    def __exit__(self, *exc):
        self.layers._split_attend = self.saved


def hold_split_attention(T: dict, calls: list, label: str) -> float:
    """Each recorded split attention against the attention of the whole
    cache on the same inputs (its slices concatenated): ``flash_decode``
    on the whole for the kernel route, ``layers._sdpa`` under the whole's
    mask for the masked route; within ``BF16_RTOL`` / ``BF16_ATOL`` (one
    bf16 rounding apart).  The largest |err|."""
    worst = 0.0
    for cfg, q, ks, vs, pos, window, out, kernel in calls:
        k, v = torch.cat(ks, dim=1), torch.cat(vs, dim=1)
        B, _, H, hd = q.shape
        KV, L = k.shape[2], k.shape[1]
        if kernel:
            want = T["flash_decode"](q.reshape(B, KV, H // KV, hd)
                                     .contiguous(), k, v, pos)
        else:
            posb = pos.expand(B)[:, None]
            idx = torch.arange(L, device=q.device)[None, :]
            if window:
                abs_pos = posb - torch.remainder(posb - idx, L)
                valid = (abs_pos >= 0) & (abs_pos <= posb)
            else:
                valid = idx <= posb
            want = T["layers"]._sdpa(q.reshape(B, 1, KV, H // KV, hd), k, v,
                                     valid[:, None, :], cfg.attn_softcap)
        want = want.reshape(out.shape).float()
        err = (out.float() - want).abs().max().item()
        ok = torch.allclose(out.float(), want, rtol=BF16_RTOL,
                            atol=BF16_ATOL)
        worst = max(worst, err)
        print(f"  {label}: {'kernel' if kernel else 'masked'} attention "
              f"over {len(ks)} slices {tuple(ks[0].shape)}"
              f"{' of a ring' if window else ''} against the whole cache's:"
              f" max |err| {err!r} {'ok' if ok else 'FAIL'}")
        check(ok, f"{label}: the split attention held to the whole's")
        del k, v
    return worst


def _build(T: dict, cfg, mesh: tuple, world=None):
    Mesh, Shape = T["Mesh"], T["InputShape"]
    return T["steps"].build_step(
        cfg, Shape("long_500k", LONG_LEN, 1, "decode"),
        Mesh(("data", "model"), mesh),
        world=world if world is not None else T["inprocess"])


def long_full(T: dict, counters, arch: str, mesh: tuple, seed: int) -> dict:
    """(a) / (c): ``arch`` at full width and depth over ``mesh`` in
    process, the weights placed and the whole tree let go before the
    cache, whose held slices are drawn on the card (``draw_cache`` of the
    step's meta arguments) up to ``pos = L - 8``; ``LONG_DECODE_STEPS`` greedy
    steps counted, one more with ``LONG_SAMPLED`` partial launches held
    to the plain version; the dry run's argument bytes (e) against the
    allocation of the held state."""
    cfg = T["get_config"](arch)
    label = f"({arch} {mesh[0]}x{mesh[1]})"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dec, args = _build(T, cfg, mesh)
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    held = dec.place_params(params)
    torch.cuda.synchronize()
    held_bytes = torch.cuda.memory_allocated() - base
    del params
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    caches = draw_cache(args[2], LONG_LEN - 8, seed + 1)
    token = torch.randint(0, cfg.vocab_size, (1, 1), dtype=torch.int32,
                          generator=torch.Generator("cuda").manual_seed(
                              seed + 2), device="cuda")
    torch.cuda.synchronize()
    held_bytes += torch.cuda.memory_allocated() - base
    setup_s = time.perf_counter() - t0
    run = long_greedy(T, dec, held, caches, token, LONG_DECODE_STEPS, counters)
    globals_ = sum(T["transformer"]._window(cfg, k) == 0 and k != "mamba"
                   for k in cfg.block_pattern) * cfg.num_repeats
    want = globals_ * mesh[0] * mesh[1] * LONG_DECODE_STEPS
    got = run["launches"]["flash_decode"]
    print(f"  {label}: {cfg.num_layers} layers, L {LONG_LEN}: "
          f"{got} flash_decode_partial launches in {LONG_DECODE_STEPS} steps "
          f"({globals_} attention layers x {mesh[0] * mesh[1]} shards a "
          f"step); {run['step_ms']!r} ms a step after a first of "
          f"{run['first_step_ms']!r}, peak {run['peak_gb']!r} GB, held "
          f"{held_bytes / 1e9!r} GB; set-up {setup_s:.1f} s")
    check(got == want, f"{label}: {want} flash_decode_partial launches: "
                       f"{got}")
    check(T["ops"].kernel_calls["flash_decode"] == want,
          f"{label}: every launch through ops.flash_decode_partial")
    check(bool(torch.isfinite(run["logits"]).all()), f"{label}: finite")
    sampled = min(LONG_SAMPLED, want // LONG_DECODE_STEPS)
    with recorded_partial(T, sampled) as rec:
        dec(held, run["tokens"][:, -1:], run["caches"])
        torch.cuda.synchronize()
    check(len(rec.calls) == sampled,
          f"{label}: {sampled} partial launches sampled")
    worst = _hold_partials(T, rec.calls, label)
    shapes = sorted({(tuple(c[0].shape), tuple(c[1].shape))
                     for c in rec.calls})
    del rec
    rec_d = T["dryrun"].dryrun_step(cfg, T["InputShape"](
        "long_500k", LONG_LEN, 1, "decode"), T["Mesh"](("data", "model"),
                                                     mesh))
    arg_b = rec_d["memory"]["argument_bytes"] * mesh[0] * mesh[1]
    rel = abs(arg_b - held_bytes) / held_bytes
    print(f"  {label} (e): {mesh[0] * mesh[1]} x the dry run's argument "
          f"bytes {arg_b:,} vs allocated {held_bytes:,} (rel {rel:.5f}); "
          f"cache {rec_d['memory']['cache_bytes']:,} B a device")
    check(rel <= STEPS_ARG_FRAC, f"{label}: the dry run's argument bytes "
                                 f"within {STEPS_ARG_FRAC} of the card's")
    out = {"layers": cfg.num_layers, "mesh": list(mesh),
           "step_ms": run["step_ms"], "step_ms_each": run["step_ms_each"],
           "peak_gb": run["peak_gb"],
           "held_gb": held_bytes / 1e9, "launches": run["launches"],
           "launches_per_step": want // LONG_DECODE_STEPS, "setup_s": setup_s,
           "flash_max_abs_err": worst, "flash_shapes": shapes,
           "dryrun": {"argument_bytes": rec_d["memory"]["argument_bytes"],
                      "cache_bytes": rec_d["memory"]["cache_bytes"],
                      "temp_bytes": rec_d["memory"]["temp_bytes"],
                      "collective_bytes": rec_d["collective_bytes"],
                      "allocated_bytes": held_bytes, "rel": rel}}
    del held, caches, run, dec, args
    torch.cuda.empty_cache()
    return out


def long_held(T: dict, counters, arch: str, depth: int, mesh: tuple,
              pos: int, seed: int, nccl: bool = False) -> dict:
    """(b) / (c) / (d): ``arch`` at full width cut to ``depth`` layers
    over ``mesh`` in process from a whole cache drawn at ``pos``,
    ``LONG_DECODE_STEPS`` greedy steps, counted; with ``nccl`` the same placed
    run over one NCCL rank, bit-identical; one more step whose split
    attentions (``LONG_ATTN_SAMPLED`` a route) are held to the whole
    cache's (:func:`hold_split_attention`); then the logits against the
    unplaced decode on that cache fed the same tokens, within the larger
    of ``SERVE_LOGIT_FRAC`` of the largest and ``LONG_NOISE`` times the
    deviation of the same decode over (1, T), the model axis without the
    split; a greedy token that the unplaced logits would not pick printed
    with their margin."""
    full = T["get_config"](arch)
    cfg = dataclasses.replace(full, num_layers=depth)
    label = f"({arch} depth {depth} {mesh[0]}x{mesh[1]})"
    torch.cuda.empty_cache()
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    whole = draw_cache(T["transformer"].cache_shapes(cfg, 1, LONG_LEN), pos,
                       seed + 1)
    first = torch.randint(0, cfg.vocab_size, (1, 1), dtype=torch.int32,
                          generator=torch.Generator("cuda").manual_seed(
                              seed + 2), device="cuda")

    def placed(world=None):
        dec, _ = _build(T, cfg, mesh, world)
        held = dec.place_params(params)
        run = long_greedy(T, dec, held, dec.place_cache(whole), first,
                          LONG_DECODE_STEPS, counters)
        run["dec"], run["held"] = dec, held
        return run

    run = placed()
    kernel = sum(T["transformer"]._window(cfg, k) == 0 and k != "mamba"
                 for k in cfg.block_pattern) * cfg.num_repeats \
        if not cfg.attn_softcap else 0
    want = kernel * mesh[0] * mesh[1] * LONG_DECODE_STEPS
    check(run["launches"]["flash_decode"] == want,
          f"{label}: {want} flash_decode_partial launches: "
          f"{run['launches']['flash_decode']}")
    out = {"layers": depth, "of_layers": full.num_layers, "mesh": list(mesh),
           "pos": pos, "step_ms": run["step_ms"],
           "step_ms_each": run["step_ms_each"], "peak_gb": run["peak_gb"],
           "launches": run["launches"]}
    print(f"  {label}: from pos {pos}, {run['step_ms']!r} ms a step after "
          f"a first of {run['first_step_ms']!r}, peak {run['peak_gb']!r} "
          f"GB, launches {json.dumps(run['launches'])}")
    if nccl:
        pg = T["process_group"]
        with tempfile.TemporaryDirectory() as tmp:
            world, _ = pg.join(0, 1, f"file://{os.path.join(tmp, 'store')}",
                               "cuda", timeout=300.0)
            try:
                n = placed(world)
            finally:
                pg.leave()
        same = (_same_bits(n["logits"], run["logits"])
                and torch.equal(n["tokens"], run["tokens"])
                and all(_same_bits(a, b) for a, b in zip(
                    T["leaves"](n["caches"]), T["leaves"](run["caches"]))))
        check(same, f"{label}: logits, tokens and every cache slice "
                    f"bit-identical over one NCCL rank")
        out["nccl"] = {"step_ms": n["step_ms"],
                       "step_ms_each": n["step_ms_each"],
                       "bit_identical": same, "launches": n["launches"]}
        print(f"  {label}: over one NCCL rank bit-identical; "
              f"{n['step_ms']!r} ms a step")
        del n
    with recorded_split(T, LONG_ATTN_SAMPLED) as rec:
        run["dec"](run["held"], run["tokens"][:, -1:], run["caches"])
        torch.cuda.synchronize()
    check(len(rec.calls) > 0, f"{label}: split attentions recorded")
    out["attention_max_abs_err"] = hold_split_attention(T, rec.calls, label)
    out["attention_held"] = len(rec.calls)
    del rec
    tokens, logits = run["tokens"], run["logits"]
    del run
    torch.cuda.empty_cache()
    noise = 0.0
    if mesh[1] > 1:
        dec, _ = _build(T, cfg, (1, mesh[1]))
        alone = long_forced(dec, dec.place_params(params),
                            dec.place_cache(whole), first, tokens)
        del dec
        torch.cuda.empty_cache()
    want = unplaced_logits(T, cfg, params, whole, first, tokens)
    if mesh[1] > 1:
        noise = (alone - want).abs().max().item()
        del alone
    err = (logits - want).abs().max().item()
    scale = want.abs().max().item()
    bound = max(SERVE_LOGIT_FRAC[cfg.dtype] * scale, LONG_NOISE * noise)
    differ = (want.argmax(-1) != tokens).nonzero().tolist()
    for row, step in differ:
        top = torch.topk(want[row, step], 2).values
        print(f"  {label}: greedy token at step {step} differs from the "
              f"unplaced decode's; its margin there "
              f"{(top[0] - top[1]).item()!r}")
    print(f"  {label}: logits max |diff| {err!r} of {scale!r} against the "
          f"unplaced decode (over 1x{mesh[1]}, the model axis alone: "
          f"{noise!r}); bound {bound!r}; {len(differ)} greedy token(s) "
          f"differ")
    check(bool(torch.isfinite(logits).all()), f"{label}: finite logits")
    check(err <= bound, f"{label}: logits within {bound} of the unplaced "
                        f"decode's: {err}")
    out.update({"logit_max_abs_diff": err, "logit_max_abs": scale,
                "model_axis_alone_diff": noise, "bound": bound,
                "tokens_differing": len(differ)})
    del params, whole
    torch.cuda.empty_cache()
    return out


def long_phase(T: dict, counters, cycles_per_ms: float) -> dict:
    phase(24, "the long-context decode (long_500k: 524,288 positions, "
              "batch 1) whose KV sequence the rules split over data: "
              "gemma3-12b whole over 4 x 1, held runs over 2 x 2 (and one "
              "NCCL rank), zamba2-2.7b whole over 4 x 1, starcoder2-3b and "
              "gemma2-27b over 2 x 2, the dry run, the partial launch "
              "timed")
    t_phase = time.perf_counter()
    out, rows = {}, {}
    arch, mesh = LONG_A
    t0 = time.perf_counter()
    out["a"] = long_full(T, counters, arch, mesh, 0)
    rows["a"] = time.perf_counter() - t0
    arch, depth, mesh = LONG_B
    t0 = time.perf_counter()
    out["b"] = long_held(T, counters, arch, depth, mesh, LONG_LEN // 2 - 2, 10,
                         nccl=True)
    rows["b"] = time.perf_counter() - t0
    arch, mesh, depth = LONG_C
    t0 = time.perf_counter()
    out["c"] = long_full(T, counters, arch, mesh, 20)
    out["c_held"] = long_held(T, counters, arch, depth, mesh,
                              3 * LONG_LEN // 4 - 2, 30)
    rows["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["d"] = {a: long_held(T, counters, a, depth, LONG_D_MESH,
                             LONG_LEN // 2 - 2, 40 + i)
                for i, (a, depth) in enumerate(LONG_D)}
    rows["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(5)
    out["timed"] = [flash_timed(T, gen, (*shape, LONG_LEN), cycles_per_ms,
                                partial=True) for shape in LONG_TIMED]
    rows["timed"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    out["row_seconds"] = rows
    print(f"  phase 24: {out['seconds']:.1f} s (budget {LONG_BUDGET_S} s); "
          f"rows {json.dumps(rows)}; {json.dumps(out, default=str)}")
    check(out["seconds"] <= LONG_BUDGET_S,
          f"phase 24 within its budget of {LONG_BUDGET_S} s")
    return out


# ---------------------------------------------------------------------------
# phase 25: the static auditor's card side

AUDIT_BUDGET_S = 60.0
# one (data, model) block of granite-8b depth 2 over 2 x 2: gba_apply's N
AUDIT_APPLY_N = 209_725_440
AUDIT_AGG_D = 201_326_592          # the bf16 buffer of the pytree path
AUDIT_STEP, AUDIT_IOTA = 9, 4
AUDIT_TOKENS = (9, 4, 9, 9)        # slot 1 at token = step - iota - 1
AUDIT_TOMB, AUDIT_FRESH = 1, 0
AUDIT_TOMB_VALUE = 1.0e30          # the tombstone's fill: huge, finite
AUDIT_SEQ = 32                     # (b)'s sequences: 4 rows of 32 tokens
AUDIT_DECODE = (2, 64, 31)         # (c): batch, cache length, position


def tombstone_fills(run, slot) -> dict:
    """``run()``'s outputs with the tombstone slot ``slot`` (a view of the
    buffer) filled with a huge finite value and with zeros, and after a
    fresh slot changes (``run(fresh=True)``): the two fills must give the
    same bits and the change another."""
    big = torch.tensor(AUDIT_TOMB_VALUE, dtype=torch.float32).to(slot.dtype)
    check(bool(torch.isfinite(big)), f"the tombstone fill {big.item()} is "
                                     f"finite in {slot.dtype}")
    slot.fill_(big)
    huge = run()
    slot.zero_()
    zero = run()
    moved = run(fresh=True)
    same = all(_same_bits(a, b) for a, b in zip(huge, zero))
    changed = all(not _same_bits(a, b) for a, b in zip(zero, moved))
    return {"tombstone_fill": big.item(), "same_bits": same,
            "fresh_changes": changed}



def audit_kernels(T: dict, counters) -> dict:
    """(a) GBA-FLOW-002 on the CUDA kernels."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    tokens = torch.tensor(AUDIT_TOKENS, dtype=torch.int32, device="cuda")
    m, n = len(AUDIT_TOKENS), AUDIT_APPLY_N
    out = {}
    counters(reset=True)
    buf = torch.randn((m, n), generator=gen, device="cuda")
    p0 = torch.randn((n,), generator=gen, device="cuda")
    a0 = torch.rand((n,), generator=gen, device="cuda") + 0.1

    def apply(fresh=False):
        if fresh:
            buf[AUDIT_FRESH].mul_(2.0)
        p, a = p0.clone(), a0.clone()
        T["gba_apply"](p, a, buf, tokens, AUDIT_STEP, LM_LR,
                       iota=AUDIT_IOTA)
        return p, a

    out["gba_apply"] = {"shape": [m, n], **tombstone_fills(
        apply, buf[AUDIT_TOMB])}
    del buf
    layout = T["ShardedFlatLayout"].from_params(
        {"w": torch.empty((n,), device="meta")}, SHARD_W)
    ss = layout.shard_size
    shards = torch.randn((SHARD_W, m, ss), generator=gen, device="cuda")
    p0 = torch.randn((layout.padded_total,), generator=gen, device="cuda")
    a0 = torch.rand((layout.padded_total,), generator=gen,
                    device="cuda") + 0.1
    apply_shards = T["make_sharded_apply"](layout, iota=AUDIT_IOTA)

    def sharded(fresh=False):
        if fresh:
            shards[:, AUDIT_FRESH].mul_(2.0)
        p, a = p0.clone(), a0.clone()
        apply_shards(p, a, shards.unbind(0), tokens, AUDIT_STEP, LM_LR)
        return p, a

    out["sharded_apply"] = {"shape": [SHARD_W, m, ss], **tombstone_fills(
        sharded, shards[:, AUDIT_TOMB])}
    del shards, p0, a0
    grads = torch.randn((m, AUDIT_AGG_D), generator=gen, device="cuda",
                        dtype=torch.bfloat16)

    def aggregate(fresh=False):
        if fresh:
            grads[AUDIT_FRESH].mul_(2.0)
        return (T["gba_aggregate"](grads, tokens, AUDIT_STEP,
                                   iota=AUDIT_IOTA),)

    out["gba_aggregate"] = {"shape": [m, AUDIT_AGG_D], **tombstone_fills(
        aggregate, grads[AUDIT_TOMB])}
    del grads
    torch.cuda.synchronize()
    out["launches"] = counters()
    for name, r in out.items():
        if name != "launches":
            check(r["same_bits"] and r["fresh_changes"],
                  f"(a) {name}: the tombstone slot's fills give the same "
                  f"bits, a fresh slot's change does not")
    check(out["launches"]["gba_apply"] == 3 + 3 * SHARD_W
          and out["launches"]["gba_aggregate"] == 3,
          f"(a) launches {out['launches']}")
    return out


def audit_schedule(T: dict, counters) -> dict:
    """(b) GBA-COLL-001/002 on the card, in process and over one NCCL
    rank."""
    CS = T["census"]
    cfg = dataclasses.replace(T["get_config"]("granite-8b"),
                              num_layers=LM_LAYERS)
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(25), device="cuda")
    layout = T["ShardedFlatLayout"].from_params(
        params, WIRE_W, group_by=T["param_group_key"])
    batch = lm_batches(T, cfg.vocab_size, AUDIT_SEQ, WIRE_W, 1, "cuda")[0]
    tokens = torch.tensor(AUDIT_TOKENS, dtype=torch.int32, device="cuda")
    loss_fn = T["make_loss_fn"](cfg)

    def run(world, site: str) -> dict:
        rec = CS.RecordingWorld(world)
        step = T["make_gba_fused_psum_step"](
            WIRE_W, loss_fn, layout, iota=AUDIT_IOTA, lr=LM_LR, world=rec)
        counters(reset=True)
        pf = layout.ravel(params)
        af = torch.full_like(pf, 0.1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pf, af, loss = step(pf, af, batch, tokens, AUDIT_STEP)
        torch.cuda.synchronize()
        findings = CS.check_fused_psum_schedule(rec.calls, layout, WIRE_W,
                                                site)
        check(findings == [], f"(b) {site}: {[str(f) for f in findings]}")
        return {"calls": [[c.call, list(c.in_shapes[0]) if c.in_shapes
                           else []] for c in rec.calls],
                "counts": CS.census_counts(rec.calls),
                "step_s": time.perf_counter() - t0,
                "launches": counters(), "loss": loss.item(),
                "pf": pf, "af": af}

    local = run(T["inprocess"], "granite-8b/fused_psum (card)")
    pg = T["process_group"]
    with tempfile.TemporaryDirectory() as tmp:
        world, _ = pg.join(0, 1, f"file://{os.path.join(tmp, 'store')}",
                           "cuda", timeout=300.0)
        try:
            nccl = run(world, "granite-8b/fused_psum (card, one NCCL rank)")
        finally:
            pg.leave()
    for name in ("pf", "af"):
        check(_same_bits(local[name], nccl[name]),
              f"(b) NCCL: {name} bit-identical to the in-process run")
        del local[name], nccl[name]
    check(local["loss"] == nccl["loss"] and local["calls"] == nccl["calls"],
          "(b) NCCL: the in-process run's loss and schedule")
    g = layout.num_groups
    check(local["counts"] == {"all_gather": g, "all_to_all": WIRE_W * g,
                              "psum": 1}, f"(b) counts {local['counts']}")
    del params
    torch.cuda.empty_cache()
    return {"num_groups": g, "group_keys": list(layout.group_keys),
            "group_shard_sizes": list(layout.group_shard_sizes),
            "in_process": local, "nccl": nccl}


def audit_decode(T: dict, counters) -> dict:
    """(c) GBA-COLL-003 and GBA-DTYPE-002 on the card."""
    CS = T["census"]
    tr = T["transformer"]
    cfg = T["get_config"]("granite-8b")
    params = T["init_model"](cfg, generator=torch.Generator(
        device="cuda").manual_seed(25), device="cuda")
    b, length, pos = AUDIT_DECODE
    cache = tr.init_cache(cfg, b, length, "cuda")
    cache["pos"] = torch.tensor(pos, dtype=torch.int32, device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (b, 1), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(26), dtype=torch.int32)
    counters(reset=True)
    with CS.CensusMode() as mode:
        logits, _ = tr.decode_step(params, cfg, tok, cache)
    torch.cuda.synchronize()
    out = {"layers": cfg.num_layers, "collectives": len(mode.collectives),
           "f64_ops": len(mode.f64), "launches": counters(),
           "finite": bool(torch.isfinite(logits).all())}
    check(out["collectives"] == 0 and out["f64_ops"] == 0,
          f"(c) decode: collectives {mode.collectives[:4]}, float64 "
          f"{mode.f64[:4]}")
    check(out["finite"] and out["launches"]["flash_decode"] > 0,
          f"(c) decode: finite logits through flash_decode ({out})")
    del params, cache, logits
    torch.cuda.empty_cache()
    return out


# (d): the metas' shapes beyond ``analysis.audit.kernel_metas()``: row (f)
# at the 2 x 2 run's (data, model) block of granite-8b depth 2, and one
# apply on views one element off their allocation (the wire's (M, shard)
# views at an offset), which take the scalar path
LAUNCH_UNALIGNED_N = 1 << 20
LAUNCH_POS = 32_000                # flash_decode's position at decode_32k
LAUNCH_FLOAT_TOL = (1e-5, 1e-6)    # phase 3's float32 rtol, atol


def launch_cases(limits, gen: torch.Generator) -> list:
    """(d)'s cases: ``(label, metas, run, hold)`` for every shape of
    ``analysis.audit.kernel_metas()``, row (f) and the unaligned apply;
    ``run()`` launches through the wrappers, ``hold(out)`` compares the
    output with the plain version on the same inputs as phase 3 does
    (bits, or float tolerances where the kernel sums in another order)
    and returns ``(ok, max |err|)``."""
    from repro_torch.kernels import (embedding_bag as EB, flash_decode as FD,
                                     fused_adagrad as FA, gba_aggregate as GG,
                                     gba_apply as GA, quantize as Q, ref)
    dev = "cuda"
    cases = []

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def ids(b, f, v):
        x = torch.randint(0, v, (b, f), generator=gen, device=dev,
                          dtype=torch.int32)
        x[0, ::5] = v                              # ids the kernels skip
        return x

    def same(pairs):
        pairs = list(pairs)
        return (all(_same_bits(a, b) for a, b in pairs),
                max((_max_abs(a, b.to(a.device)) for a, b in pairs
                     if a.numel()), default=0.0))

    def close(a, b, rtol, atol):
        return (torch.allclose(a.float(), b.float(), rtol=rtol, atol=atol),
                _max_abs(a, b))

    tokens = torch.tensor([9, 9, 4, 9, 8, 9, 3, 9], dtype=torch.int32,
                          device=dev)

    # gba_apply: row (f), then the unaligned views
    for n, aligned in ((AUDIT_APPLY_N, True), (LAUNCH_UNALIGNED_N, False)):
        m = len(AUDIT_TOKENS)
        off = 0 if aligned else 1
        p_all, a_all = randn(n + off) * 0.02, randn(n + off).abs() + 0.1
        p, a = p_all[off:], a_all[off:]
        buf = randn(m, n) * 1e-3
        tok = torch.tensor(AUDIT_TOKENS, dtype=torch.int32, device=dev)

        def run(p=p, a=a, buf=buf, tok=tok):
            return GA.gba_apply(p, a, buf, tok, AUDIT_STEP, LM_LR,
                                iota=AUDIT_IOTA)

        want = GA.gba_apply_ref(p, a, buf, tok, AUDIT_STEP, LM_LR,
                                iota=AUDIT_IOTA)
        cases.append(("gba_apply (f)" if aligned else "gba_apply unaligned",
                      (GA.launch_meta(n, m, aligned=aligned, limits=limits),),
                      run, lambda out, want=want: same(zip(out, want))))
    n = 1 << 16
    p, g, a = randn(n), randn(n), randn(n).abs() + 0.1
    want = ref.fused_adagrad_ref(p, g, a, LM_LR)
    cases.append(("fused_adagrad", (FA.launch_meta(n, limits=limits),),
                  lambda p=p, g=g, a=a: FA.fused_adagrad(p, g, a, LM_LR),
                  lambda out, want=want: same(zip(out, want))))
    grads = randn(8, n)
    want = ref.gba_aggregate_ref(grads, tokens, AUDIT_STEP, iota=AUDIT_IOTA)
    cases.append(("gba_aggregate", (GG.launch_meta(n, 8, limits=limits),),
                  lambda: GG.gba_aggregate(grads, tokens, AUDIT_STEP,
                                           iota=AUDIT_IOTA),
                  lambda out, want=want: same([(out, want)])))
    # embedding_bag and its backward, at the reference's bench shapes
    bag, table = ids(32, 26, 100_000), randn(100_000, 128) * 0.01
    want = ref.embedding_bag_ref(bag, table)
    cases.append(("embedding_bag", (EB.fwd_launch_meta(32, 26, 100_000,
                                                       128),),
                  lambda: EB.embedding_bag(bag, table),
                  lambda out, want=want: close(out, want,
                                               *LAUNCH_FLOAT_TOL)))
    for d, kernel in ((128, EB.embedding_bag_grad),
                      (64, EB.embedding_bag_grad_resident)):
        rows = randn(32, d)
        want = ref.embedding_bag_grad_ref(bag.cpu(), rows.cpu(), 100_000)
        meta = (EB.bwd_launch_meta if d == 128 else
                EB.resident_launch_meta)(32, 26, 100_000, d, limits=limits)
        cases.append((meta.kernel, (meta,),
                      lambda kernel=kernel, rows=rows: kernel(bag, rows,
                                                              100_000),
                      lambda out, want=want: same(zip(out, want))))
    presence = ids(1, 53_248, 1_600_048)
    want = ref.embedding_bag_grad_ref(presence.cpu(), torch.zeros((1, 0)),
                                      1_600_048)[1]
    cases.append(("embedding_bag_grad counts",
                  (EB.bwd_launch_meta(1, 53_248, 1_600_048, 0,
                                      limits=limits),),
                  lambda: EB.embedding_bag_grad(
                      presence, torch.zeros((1, 0), device=dev),
                      1_600_048)[1],
                  lambda out, want=want: same([(out, want)])))
    # the wire's quantizers, at the reference's bench shape
    r, c, tile = 8, 1 << 14, 2048
    x = randn(r, c)
    for mode, fn, plain in (("minmax", Q.quantize_minmax,
                             ref.quantize_minmax_ref),
                            ("sign", Q.quantize_sign, ref.quantize_sign_ref)):
        want = plain(x, tile)

        def run(fn=fn):
            y = x.clone()
            return (*fn(y, tile=tile), y)

        cases.append((f"quantize_{mode}",
                      (Q.quantize_launch_meta(r, c, tile, mode),), run,
                      lambda out, want=want: same(zip(out, want))))
        sides = want[1:-1]
        zero = sides[1] if mode == "minmax" else None
        back = ref.dequantize_ref(want[0], sides[0], zero, tile, mode)
        cases.append((f"dequantize_{mode}",
                      (Q.dequant_launch_meta(r, c, tile, mode),),
                      lambda want=want, zero=zero, mode=mode: Q.dequantize(
                          want[0], want[1], zero, tile=tile, mode=mode,
                          out=torch.empty((r, c), device=dev)),
                      lambda out, back=back: same([(out, back)])))
    # flash_decode at decode_32k, every head dim, both dtypes, and partial
    b, length, kv, g = 4, 32_768, 8, 4
    shapes = [(hd, dt, False) for hd in FD.HEAD_DIMS
              for dt in (torch.float32, torch.bfloat16)]
    shapes += [(128, dt, True) for dt in (torch.float32, torch.bfloat16)]
    for hd, dt, partial in shapes:
        q, k, v = randn(b, kv, g, hd, dtype=dt), randn(
            b, length, kv, hd, dtype=dt), randn(b, length, kv, hd, dtype=dt)
        tol = ((BF16_RTOL, BF16_ATOL) if dt == torch.bfloat16 and not partial
               else LAUNCH_FLOAT_TOL)
        meta = FD.launch_meta(b, length, kv, g, hd, dt, partial,
                              limits=limits)
        if partial:
            want = ref.flash_decode_partial_ref(q, k, v, LAUNCH_POS, 0)

            def run(q=q, k=k, v=v):
                return FD.flash_decode_partial(q, k, v, LAUNCH_POS, 0)

            def hold(out, want=want):
                ok_o, err = close(out[0], want[0], *LAUNCH_FLOAT_TOL)
                return ok_o and close(out[1], want[1], 0.0, 1e-5)[0], err
        else:
            want = ref.flash_decode_ref(q, k, v, LAUNCH_POS)

            def run(q=q, k=k, v=v):
                return FD.flash_decode(q, k, v, LAUNCH_POS)

            def hold(out, want=want, tol=tol):
                return close(out, want, *tol)
        cases.append((f"flash_decode hd {hd} {str(dt)[6:]}"
                      + (" partial" if partial else ""),
                      meta if isinstance(meta, tuple) else (meta,), run,
                      hold))
    return cases


def audit_launches(T: dict, counters) -> dict:
    """(d) each kernel's launch meta against the launch the card made."""
    from repro_torch.analysis import audit as AU
    from repro_torch.kernels import launch_record as LR
    from repro_torch.kernels.flash_decode import _device
    from repro_torch.kernels.launch_meta import HOPPER
    limits = LR.device_limits(0)
    sms, smem = _device(0)
    check(limits == HOPPER, f"(d) the card's limits {limits} are HOPPER's")
    check((limits.sms, (limits.smem_per_block_optin, limits.smem_per_sm,
                        limits.smem_reserved_per_block)) == (sms, smem),
          f"(d) the runtime's limits agree with repro_flash_decode_smem "
          f"{smem} and {sms} SMs")
    compiled = LR.compiled_kernels(T["runtime"].build_log())
    gen = torch.Generator(device="cuda").manual_seed(37)
    cases = launch_cases(limits, gen)
    covered = {m.site for _, metas, _, _ in cases for m in metas}
    missing = {m.site for m in AU.kernel_metas()} - covered
    check(not missing, f"(d) every meta of kernel_metas() launched: "
                       f"{sorted(missing)} missing")
    rows, outputs = [], {}
    counters(reset=True)
    for label, metas, run, hold in cases:
        out, events = LR.record_launches(run, compiled)
        check(len(events) == len(metas),
              f"(d) {label}: {len(events)} launches recorded for "
              f"{len(metas)} metas ({[e['name'][:60] for e in events]})")
        for meta, event in zip(metas, events):
            row, problems = LR.hold(meta, event, compiled, limits)
            check(not problems, f"(d) {label} {meta.site}: {problems}")
            rows.append(row)
        ok, err = hold(out)
        check(ok, f"(d) {label}: the output within phase 3's tolerance of "
                  f"the plain version (max |err| {err!r})")
        outputs[label] = err
        print(f"  (d) {label}: " + "; ".join(
            f"{r['site']} grid {r['grid']} block {r['block']} smem "
            f"{r['smem']} B ({r['dynamic_smem']} dynamic + "
            f"{r['static_smem_compiled']} static), {r['registers']} "
            f"registers, spills {r['spill_stores']}/{r['spill_loads']} B"
            for r in rows[-len(metas):]) + f"; max |err| {err!r}")
    torch.cuda.synchronize()
    del cases
    return {"limits": dataclasses.asdict(limits), "launches": counters(),
            "metas": len(rows), "rows": rows, "max_abs_err": outputs}


def parent_trace_kernels() -> int:
    """Kernel events ``torch.profiler`` records in this process for one
    PyTorch reduction on the card (a probe of the tracer, no wrapper)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones((1 << 20,), device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x.sum()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sum(e.get("cat") == "kernel" for e in events)


def audit_launches_child(T: dict, counters) -> dict:
    """(d) in a child process of its own (``chip_smoke.py --launch-row``):
    in the whole script the profiler's traces of this process held none
    of the package's kernels by phase 25 (PR 37's first final run), while
    a fresh process records them; the child's counts are (d)'s
    launches."""
    traced = parent_trace_kernels()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--launch-row"], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    for line in proc.stdout.splitlines():
        if line.startswith("  (d)"):
            print(line)
    check(proc.returncode == 0, f"(d) the child exited {proc.returncode}: "
                                f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    rows = [x for x in proc.stdout.splitlines() if x.startswith("ROW_D ")]
    out = json.loads(rows[-1][len("ROW_D "):])
    out["parent_trace_kernels"] = traced
    return out


def launch_row_main() -> int:
    """``python3 chip_smoke.py --launch-row``: phase 25 (d) alone in this
    process, its result as one JSON line after ``ROW_D``."""
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import (flash_decode, fused_adagrad,
                                     gba_aggregate, gba_apply, quantize,
                                     runtime)
    wrappers = {
        "embedding_bag": eb.embedding_bag,
        "embedding_bag_grad": eb.embedding_bag_grad,
        "embedding_bag_grad_resident": eb.embedding_bag_grad_resident,
        "gba_apply": gba_apply.gba_apply,
        "gba_aggregate": gba_aggregate.gba_aggregate,
        "fused_adagrad": fused_adagrad.fused_adagrad,
        "quantize_minmax": quantize.quantize_minmax,
        "quantize_sign": quantize.quantize_sign,
        "dequantize": quantize.dequantize,
        "flash_decode": flash_decode.flash_decode}

    def counters(reset: bool = False) -> dict:
        if reset:
            for fn in wrappers.values():
                fn.launches = 0
        return {name: fn.launches for name, fn in wrappers.items()}

    runtime.build()
    out = audit_launches({"runtime": runtime}, counters)
    print("ROW_D " + json.dumps(out))
    return 0


def audit_phase(T: dict, counters) -> dict:
    phase(25, "the static auditor's card side: (a) GBA-FLOW-002 on "
              "gba_apply, the sharded apply and gba_aggregate, (b) "
              "GBA-COLL-001/002 on the fused psum step at granite-8b full "
              "width, depth 2, W = 4, in process and over one NCCL rank, "
              "(c) GBA-COLL-003 and GBA-DTYPE-002 on granite-8b's decode, "
              "(d) each kernel's launch meta against the launch the card "
              "made (GBA-TILE-001, GBA-VMEM-001/002, GBA-GRID-001)")
    t_phase = time.perf_counter()
    out, rows = {}, {}
    for key, fn in (("a", audit_kernels), ("b", audit_schedule),
                    ("c", audit_decode), ("d", audit_launches_child)):
        t0 = time.perf_counter()
        out[key] = fn(T, counters)
        rows[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["row_seconds"] = rows
    print(f"  phase 25: {out['seconds']:.1f} s (budget {AUDIT_BUDGET_S} s); "
          f"rows {json.dumps(rows)}; {json.dumps(out, default=str)}")
    check(out["seconds"] <= AUDIT_BUDGET_S,
          f"phase 25 within its budget of {AUDIT_BUDGET_S} s")
    return out


# ---------------------------------------------------------------------------
# phase 26: Tab. 5.2's online-learning serving rows and the trainer leftovers
# ---------------------------------------------------------------------------

TAB52_BUDGET_S = 60.0
# the reference's run_serving() at its defaults (V = 1,000,000, 64 batches;
# jax 0.9.0, numpy REF_NUMPY, on the CPU): every column but the latencies.
# The port's rows must equal them on the card and on the CPU; the DRAWN
# columns follow numpy's zipf and choice streams, which differ between
# numpy versions, so under another numpy they are held card against CPU
# alone (both draw on the host from the same numpy)
REF_NUMPY = "2.0.2"
TAB52_DRAWN = ("hit_rate", "invalidations")
REF_TAB52_SERVING = {
    "tab52.serving.hot_cache": {
        "hit_rate": "0.8492", "vocab": "1000000", "cache_rows": "512",
        "audit_cache_bytes": "1048576", "audit_hit_skips_kernel": "1",
        "audit_race_findings": "0"},
    "tab52.serving.live_sync": {
        "hit_rate": "0.8079", "freshness_lag_steps": "2", "syncs": "8",
        "coalesced": "8", "invalidations": "221", "versions": "9",
        "audit_race_findings": "0"},
}
CKPT_KEEP, CKPT_SAVES = 2, 3       # (b): three saves, the newest two kept
# (c): Adam with decoupled weight decay, a warmup_cosine lr_override and
# the gradient clipped to CLIP_NORM (far below a N(0, 1) gradient's norm,
# so the clip scales), card against CPU over OPT_STEPS updates
OPT_LR, OPT_WD, OPT_WARMUP, OPT_TOTAL, CLIP_NORM = 1e-3, 0.01, 2, 10, 1.0
OPT_STEPS = 3
OPT_RTOL, OPT_ATOL = 1e-5, 1e-7    # float32 sum orders of the norm


def _columns(rows: list) -> dict:
    """name -> {column: value} of each CSV row."""
    return {name: dict(kv.split("=") for kv in derived.split(";"))
            for name, _, derived in (r.split(",", 2) for r in rows)}


def tab52_serving(T: dict, counters, card_power: str) -> dict:
    """(a) ``tab52_qps.run_serving`` on the card and on the CPU."""
    bench = T["benches"]["tab52_qps"]
    counters(reset=True)
    t0 = time.perf_counter()
    rows = bench.run_serving(device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = counters()
    t0 = time.perf_counter()
    host_rows = bench.run_serving(device="cpu")
    host_s = time.perf_counter() - t0
    for r in rows:
        print(f"  {r}  [{card_power}]")
    print(f"  (a) run_serving: {card_s:.1f} s on the card, {host_s:.1f} s on "
          f"the CPU; embedding_bag launches {launches['embedding_bag']}, "
          f"pooled_lookup calls {launches['calls']}")
    card, host = _columns(rows), _columns(host_rows)
    check(list(card) == list(host) == list(REF_TAB52_SERVING),
          "(a) the two serving rows")
    same_numpy = np.__version__ == REF_NUMPY
    for name, want in REF_TAB52_SERVING.items():
        check(card[name].keys() == host[name].keys(), f"(a) {name} columns")
        for col, value in want.items():
            check(card[name][col] == host[name][col],
                  f"(a) {name} {col}: card {card[name][col]}, CPU "
                  f"{host[name][col]}")
            if same_numpy or col not in TAB52_DRAWN:
                check(card[name][col] == value,
                      f"(a) {name} {col}: {card[name][col]}, the "
                      f"reference's {value}")
    print(f"  (a) numpy {np.__version__}: every column but the latencies "
          f"equal card against CPU, and to the reference's (numpy "
          f"{REF_NUMPY}) " + ("all of them" if same_numpy else
                              f"but the drawn {', '.join(TAB52_DRAWN)}"))
    check(launches["embedding_bag"] > 0,
          "(a) the cache misses launched embedding_bag")
    # every lookup call launched the CUDA kernel, so the all-hit probe's
    # zero calls (audit_hit_skips_kernel=1) are zero launches
    check(launches["embedding_bag"] == launches["calls"],
          "(a) one embedding_bag launch per pooled_lookup call")
    return {"rows": rows, "card_s": card_s, "host_s": host_s,
            "launches": launches}


def tab52_checkpoint(T: dict) -> dict:
    """(b) DeepFM's replay state after 1, 2 and 3 of the quickstart's
    global steps on the card, through ``CheckpointManager(keep=2)``."""
    Q, cfg = T["quickstart"], T["CRITEO_DEEPFM"]
    params = T["init_recsys"](cfg, generator=torch.Generator().manual_seed(0),
                              device="cuda")
    stream = T["make_clickstream"](cfg, seed=0,
                                   batch_size=Q.SETUP.local_batch)
    sched = T["schedule_for_day"](Q.SETUP, Q.SPEC, Q.NUM_BATCHES)
    ckpt_dir = WORK / "ckpt_manager"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    saved = {}
    try:
        mgr = T["CheckpointManager"](str(ckpt_dir), keep=CKPT_KEEP)
        for k in range(1, CKPT_SAVES + 1):
            tr = Q.make_trainer(cfg)
            head = T["Schedule"](sched.mode, sched.local_batch,
                                 sched.steps[:k])
            p, opt, last, _ = tr.replay(params, tr.optimizer.init(params),
                                        head, stream, 0)
            saved[k] = {"params": p, "opt": opt, "last_update": last}
            mgr.save(k, saved[k])
        kept = mgr.steps()
        step, latest = mgr.restore_latest()
        older = mgr.restore(kept[0])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(kept == list(range(CKPT_SAVES - CKPT_KEEP + 1, CKPT_SAVES + 1)),
          f"(b) keep={CKPT_KEEP} over {CKPT_SAVES} saves keeps {kept}")
    n = 0
    for k, got in ((step, latest), (kept[0], older)):
        want = T["leaves"](saved[k])
        have = T["leaves"](got)
        check(len(have) == len(want), f"(b) step {k}: every leaf restored")
        for a, b in zip(have, want):
            check(a.device.type == "cuda" and _same_bits(a, b),
                  f"(b) step {k}: restored onto the card bit-identical")
        n += len(have)
    check(not _same_bits(T["leaves"](latest)[0], T["leaves"](older)[0]),
          "(b) the kept states differ")
    print(f"  (b) CheckpointManager(keep={CKPT_KEEP}) over {CKPT_SAVES} "
          f"saves of DeepFM's replay state kept steps {kept}; both restored "
          f"onto the card bit-identical ({n} leaves)")
    return {"kept": kept, "leaves": n}


def tab52_optimizer(T: dict) -> dict:
    """(c) ``adam(weight_decay=)`` with a ``warmup_cosine`` override and
    ``clip_by_global_norm``, card against CPU."""
    sched = T["schedules"].warmup_cosine(OPT_LR, OPT_WARMUP, OPT_TOTAL)
    clip = T["clip_by_global_norm"]
    host = T["init_recsys"](T["CRITEO_DEEPFM"],
                            generator=torch.Generator().manual_seed(3),
                            device="cpu")
    card = T["tree_to_device"](host, torch.device("cuda"))
    opt = T["get_optimizer"]("adam", OPT_LR, weight_decay=OPT_WD)
    states = {"cuda": (card, opt.init(card)), "cpu": (host, opt.init(host))}
    gen = torch.Generator().manual_seed(4)
    norms = {"cuda": [], "cpu": []}
    for step in range(1, OPT_STEPS + 1):
        grads = T["tree_map"](lambda p: torch.randn(p.shape, generator=gen),
                              host)
        for dev in ("cuda", "cpu"):
            p, st = states[dev]
            g = T["tree_to_device"](grads, torch.device(dev))
            g, norm = clip(g, CLIP_NORM)
            # the card's step stays on the card: the schedule needs no sync
            lr = sched(torch.tensor(step, device=dev) if dev == "cuda"
                       else step)
            check(lr.device.type == dev, f"(c) the schedule on {dev}")
            states[dev] = opt.update(p, g, st, lr_override=lr)
            norms[dev].append(norm.item())
    check(all(n > CLIP_NORM for n in norms["cpu"]), "(c) the clip scaled")
    check(np.allclose(norms["cuda"], norms["cpu"], rtol=OPT_RTOL, atol=0),
          f"(c) norms {norms['cuda']} vs {norms['cpu']}")
    worst = 0.0
    for a, b in zip(T["leaves"](states["cuda"]), T["leaves"](states["cpu"])):
        check(torch.allclose(a.cpu().double(), b.double(), rtol=OPT_RTOL,
                             atol=OPT_ATOL),
              f"(c) params and Adam state within rtol {OPT_RTOL} atol "
              f"{OPT_ATOL}")
        worst = max(worst, (a.cpu().double() - b.double()).abs().max().item())
    print(f"  (c) {OPT_STEPS} adam(weight_decay={OPT_WD}) updates, "
          f"warmup_cosine lr, clip to {CLIP_NORM}: card vs CPU within rtol "
          f"{OPT_RTOL} atol {OPT_ATOL}; largest difference {worst!r}; "
          f"norms {norms['cuda']}")
    return {"max_abs_diff": worst, "norms": norms["cuda"]}


def tab52_phase(T: dict, counters, card_power: str) -> dict:
    phase(26, "Tab. 5.2's online-learning serving rows (run_serving at V = "
              "1,000,000) on the card and the CPU; CheckpointManager over "
              "DeepFM's replay state; adam(weight_decay) with a schedule "
              "and clip_by_global_norm")
    t_phase = time.perf_counter()
    out, rows = {}, {}
    for key, fn in (("a", lambda: tab52_serving(T, counters, card_power)),
                    ("b", lambda: tab52_checkpoint(T)),
                    ("c", lambda: tab52_optimizer(T))):
        t0 = time.perf_counter()
        out[key] = fn()
        rows[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["row_seconds"] = rows
    print(f"  phase 26: {out['seconds']:.1f} s (budget {TAB52_BUDGET_S} s); "
          f"rows {json.dumps(rows)}")
    check(out["seconds"] <= TAB52_BUDGET_S,
          f"phase 26 within its budget of {TAB52_BUDGET_S} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import repro_torch.serving as S
    from repro_torch.checkpoint import save_pytree
    from repro_torch.configs import GBAConfig, get_config
    from repro_torch.configs.recsys import CRITEO_DEEPFM
    from repro_torch.convert import tree_to_device
    from repro_torch.core import GBATrainer, schedule_for_day
    from repro_torch.data import make_clickstream, make_lm_stream
    from repro_torch.embeddings import hash_ids
    from repro_torch.kernels import ops, runtime
    from repro_torch.core.gba import (buffer_push_and_maybe_apply,
                                      init_buffer, tree_paths)
    from repro_torch.kernels.embedding_bag import (
        device_grad_plan, embedding_bag, embedding_bag_grad,
        embedding_bag_grad_counts, embedding_bag_grad_resident,
        embedding_bag_grad_resident_sorted, embedding_bag_grad_sorted,
        sort_ids)
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_partial,
                                                  launch_plan)
    from repro_torch.kernels.fused_adagrad import fused_adagrad
    from repro_torch.kernels.gba_aggregate import gba_aggregate
    from repro_torch.kernels.gba_apply import gba_apply
    from repro_torch.kernels.quantize import (dequantize, quantize_minmax,
                                              quantize_sign)
    from repro_torch.kernels.ref import (dequantize_ref,
                                         embedding_bag_grad_ref,
                                         embedding_bag_ref,
                                         flash_decode_partial_ref,
                                         flash_decode_ref,
                                         fused_adagrad_ref,
                                         gba_aggregate_ref, gba_apply_ref,
                                         quantize_minmax_ref,
                                         quantize_sign_ref)
    from repro_torch.launch import quickstart, serve, train
    from repro_torch.launch.programs import build_programs, loss_and_grads
    from repro_torch.launch.variants import VARIANTS
    from repro_torch.models.recsys import init_recsys
    from repro_torch.models import layers, transformer
    from repro_torch.models.transformer import init_model, param_count
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.optim import clip_by_global_norm, get_optimizer, tree_map
    from repro_torch.optim import schedules
    from repro_torch.sim.cluster import ClusterSpec, Schedule, Slot
    from repro_torch.sim.faults import (FaultPlan, ScrapeDropout,
                                        StragglerWindow)
    from repro_torch.benchmarks import autoswitch as bench_autoswitch
    from repro_torch.benchmarks import (convergence, decay_ablation,
                                        fig3_grad_distribution,
                                        fig6_switching, fig78_batch_ablation,
                                        multitask, tab52_qps)
    from repro_torch.configs.recsys import ALIMAMA_DIEN, PRIVATE_YOUTUBEDNN
    from repro_torch.convert import jax_init_recsys
    from repro_torch.core import ModeSetup, evaluate
    from repro_torch.core import default_setups, run_continual
    from repro_torch.core.compression import CompressionPolicy
    from repro_torch.launch import switch_driver
    from repro_torch.launch.programs import make_loss_fn
    from repro_torch.core.flat_sharded import ShardedFlatLayout
    from repro_torch.distributed import fsdp, inprocess, process_group
    from repro_torch.distributed import sharding as sharding_rules
    from repro_torch.distributed.sharding import model_dims
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as launch_steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.analysis import census
    from repro_torch.core.flat_sharded import make_sharded_apply
    from repro_torch.core.gba_shard_map import make_gba_fused_psum_step

    t_start = time.perf_counter()
    kind, card_power = device_phase()
    build_phase(runtime)

    # the quickstart's stream and day-0 schedule give the presence-count
    # ids of shape (a): one (1, 16 * 128 * 26) set per global step
    qs_stream = make_clickstream(CRITEO_DEEPFM, seed=0,
                                 batch_size=quickstart.SETUP.local_batch)
    qs_sched = schedule_for_day(quickstart.SETUP, quickstart.SPEC,
                                quickstart.NUM_BATCHES)
    T = {"quickstart": quickstart, "train": train,
         "CRITEO_DEEPFM": CRITEO_DEEPFM, "init_recsys": init_recsys,
         "tree_to_device": tree_to_device, "make_clickstream":
         make_clickstream, "schedule_for_day": schedule_for_day,
         "Schedule": Schedule, "Slot": Slot, "GBATrainer": GBATrainer,
         "get_optimizer": get_optimizer, "hash_ids": hash_ids,
         "embedding_bag_grad": embedding_bag_grad,
         "embedding_bag_grad_sorted": embedding_bag_grad_sorted,
         "embedding_bag_grad_counts": embedding_bag_grad_counts,
         "device_grad_plan": device_grad_plan,
         "sort_ids": sort_ids, "embedding_bag_grad_ref":
         embedding_bag_grad_ref, "embedding_bag_ref": embedding_bag_ref,
         "presence": [presence_ids(qs_stream, qs_sched, k)
                      for k in range(len(qs_sched.steps))],
         "presence_capacity": (quickstart.SETUP.buffer_size
                               * CRITEO_DEEPFM.hash_capacity),
         "get_config": get_config, "GBAConfig": GBAConfig,
         "init_model": init_model, "param_count": param_count,
         "build_programs": build_programs, "make_lm_stream": make_lm_stream,
         "gba_apply": gba_apply, "gba_apply_ref": gba_apply_ref,
         "ops": ops, "run_wire_train": train.run_wire_train,
         "quantize_minmax": quantize_minmax, "quantize_sign": quantize_sign,
         "dequantize": dequantize, "quantize_minmax_ref": quantize_minmax_ref,
         "quantize_sign_ref": quantize_sign_ref,
         "dequantize_ref": dequantize_ref,
         "run_lm_pytree": train.run_lm_pytree,
         "loss_and_grads": loss_and_grads,
         "leaves": lambda tree: [x for _, x in tree_paths(tree)],
         "tree_paths": tree_paths, "VARIANTS": VARIANTS,
         "tree_map": tree_map, "init_buffer": init_buffer,
         "buffer_push_and_maybe_apply": buffer_push_and_maybe_apply,
         "gba_aggregate": gba_aggregate,
         "gba_aggregate_ref": gba_aggregate_ref,
         "fused_adagrad": fused_adagrad,
         "fused_adagrad_ref": fused_adagrad_ref,
         "embedding_bag_grad_resident": embedding_bag_grad_resident,
         "embedding_bag_grad_resident_sorted":
         embedding_bag_grad_resident_sorted,
         "transformer": transformer, "layers": layers, "serve": serve,
         "S": S,
         "flash_decode": flash_decode, "flash_decode_ref": flash_decode_ref,
         "flash_decode_partial": flash_decode_partial,
         "flash_decode_partial_ref": flash_decode_partial_ref,
         "flash_launch_plan": launch_plan, "SD": switch_driver,
         "fig6": fig6_switching, "bench_autoswitch": bench_autoswitch,
         "FaultPlan": FaultPlan, "ScrapeDropout": ScrapeDropout,
         "StragglerWindow": StragglerWindow, "ClusterSpec": ClusterSpec,
         "CompressionPolicy": CompressionPolicy,
         "make_loss_fn": make_loss_fn,
         "param_group_key": transformer.param_group_key,
         "default_setups": default_setups, "run_continual": run_continual,
         "task_configs": (ALIMAMA_DIEN, PRIVATE_YOUTUBEDNN),
         "jax_init_recsys": jax_init_recsys, "ModeSetup": ModeSetup,
         "evaluate": evaluate, "ShardedFlatLayout": ShardedFlatLayout,
         "inprocess": inprocess, "process_group": process_group,
         "model_dims": model_dims, "fsdp": fsdp,
         "sharding": sharding_rules, "steps": launch_steps,
         "dryrun": dryrun, "Mesh": Mesh, "InputShape": InputShape,
         "census": census, "make_sharded_apply": make_sharded_apply,
         "runtime": runtime,
         "make_gba_fused_psum_step": make_gba_fused_psum_step,
         "CheckpointManager": CheckpointManager, "schedules": schedules,
         "clip_by_global_norm": clip_by_global_norm,
         "benches": {
             "tab52_qps": tab52_qps, "convergence": convergence,
             "multitask": multitask, "decay_ablation": decay_ablation,
             "fig3_grad_distribution": fig3_grad_distribution,
             "fig78_batch_ablation": fig78_batch_ablation}}

    gen = torch.Generator(device="cuda").manual_seed(1)
    # init_table's scale: pooled sums of F rows then round at the 1e-8
    # level, well inside the stated f32 tolerance
    big = torch.randn((V, DIM), generator=gen, device="cuda") * 0.01
    max_err = kernel_phase(embedding_bag, embedding_bag_ref, big, gen,
                           hash_ids)
    grad_max_err = grad_kernel_check(T, gen)
    apply_max_err = apply_kernel_check(T)

    def counters(reset: bool = False) -> dict:
        if reset:
            ops.kernel_calls.clear()
            embedding_bag.launches = 0
            embedding_bag_grad.launches = 0
            gba_apply.launches = 0
            quantize_minmax.launches = 0
            quantize_sign.launches = 0
            dequantize.launches = 0
            gba_aggregate.launches = 0
            fused_adagrad.launches = 0
            embedding_bag_grad_resident.launches = 0
            flash_decode.launches = 0
        return {"calls": ops.kernel_calls["pooled_lookup"],
                "embedding_bag": embedding_bag.launches,
                "embedding_bag_grad": embedding_bag_grad.launches,
                "gba_apply": gba_apply.launches,
                "quantize_minmax": quantize_minmax.launches,
                "quantize_sign": quantize_sign.launches,
                "dequantize": dequantize.launches,
                "gba_aggregate": gba_aggregate.launches,
                "fused_adagrad": fused_adagrad.launches,
                "embedding_bag_grad_resident":
                embedding_bag_grad_resident.launches,
                "flash_decode": flash_decode.launches}

    params = S.init_scoring_params(
        V, DIM, MLP, generator=torch.Generator().manual_seed(0),
        device="cuda")
    hot = np.arange(HOT, dtype=np.int64)

    # the serving path, phases 4-6: every count starts at 0 here
    counters(reset=True)
    static = serving_static_phase(S, params, hot, counters)
    want = reference_check(params, static["probe"], hash_ids,
                           embedding_bag_ref)
    check(np.allclose(static["probe_scores"], want, rtol=1e-5, atol=1e-6),
          "scores agree with a float64 host reference")
    live = serving_live_phase(S, params, hot, hash_ids)
    checkpoint_phase(S, save_pytree, params, static)
    torch.cuda.synchronize()
    serving = counters()
    print(f"serving path: embedding_bag launches {serving['embedding_bag']}, "
          f"embedding_bag_grad launches {serving['embedding_bag_grad']}, "
          f"pooled_lookup calls {serving['calls']}")
    check(serving["embedding_bag"] > 0,
          "the serving path launched embedding_bag")

    replay = replay_phase(T, counters)
    smoke = smoke_phase(T, counters)
    torch.cuda.empty_cache()
    lm = lm_phase(T, counters)

    timing = timing_phase(embedding_bag, embedding_bag_ref, big, gen,
                          static, S, params)
    cycles_per_ms = sleep_cycles_per_ms()
    floor = launch_floor(cycles_per_ms)
    grad_rows = grad_timing(T, cycles_per_ms)
    apply_row = apply_timing(T)
    torch.cuda.empty_cache()
    wire = wire_phase(T, counters)
    torch.cuda.empty_cache()
    pytree = pytree_phase(T, counters)
    resident = resident_phase(T, counters)
    pytree_times = pytree_timing(T, sleep_cycles_per_ms())
    torch.cuda.empty_cache()
    served = serve_phase(T, counters)
    torch.cuda.empty_cache()
    switching = switch_phase(T, counters)
    torch.cuda.empty_cache()
    tasks = tasks_phase(T, counters)
    torch.cuda.empty_cache()
    sharded = sharded_ps_phase(T, counters, lm)
    torch.cuda.empty_cache()
    archs = archs_phase(T, counters)
    torch.cuda.empty_cache()
    trained = train_phase(T, counters)
    torch.cuda.empty_cache()
    ssm = ssm_phase(T, counters)
    torch.cuda.empty_cache()
    cross = cross_phase(T, counters)
    torch.cuda.empty_cache()
    cross_train = cross_train_phase(T, counters)
    torch.cuda.empty_cache()
    model_axis = model_axis_phase(T, counters)
    torch.cuda.empty_cache()
    placed = steps_phase(T, counters)
    torch.cuda.empty_cache()
    long = long_phase(T, counters, sleep_cycles_per_ms())
    torch.cuda.empty_cache()
    audited = audit_phase(T, counters)
    torch.cuda.empty_cache()
    tab52 = tab52_phase(T, counters, card_power)

    phase(27, "kernels")
    fwd_launches = {"serving": serving["embedding_bag"],
                    "replay": replay["launches"]["embedding_bag"],
                    "sparse_smoke": smoke["launches"]["embedding_bag"],
                    "tab52_serving":
                    tab52["a"]["launches"]["embedding_bag"],
                    "audit_launch_meta":
                    audited["d"]["launches"]["embedding_bag"]}
    bwd_launches = {"serving": serving["embedding_bag_grad"],
                    "replay": replay["launches"]["embedding_bag_grad"],
                    "sparse_smoke": smoke["launches"]["embedding_bag_grad"],
                    "resident_oracle":
                    resident["launches"]["embedding_bag_grad"],
                    **{f"tasks_{name}": r["launches"]["embedding_bag_grad"]
                       for name, r in tasks["replay"].items()},
                    "tasks_benches":
                    tasks["benches"]["launches"]["embedding_bag_grad"],
                    "audit_launch_meta":
                    audited["d"]["launches"]["embedding_bag_grad"]}
    print(json.dumps({
        "serving": {"static": static["stats"], "live": live["stats"],
                    "live_syncs": live["syncs"],
                    "freshness_lag_steps": live["max_lag"],
                    "launches_per_score_hist": static["launch_hist"],
                    "latency": timing["latency"]},
        "replay": replay,
        "sparse_smoke": smoke,
        "lm_fused": lm,
        "wire": wire,
        "pytree": pytree,
        "resident_oracle": resident,
        "pytree_timing": pytree_times,
        "lm_serving": served,
        "switching": switching,
        "tasks": tasks,
        "sharded_ps": sharded,
        "lm_archs": archs,
        "lm_archs_train": trained,
        "lm_ssm": ssm,
        "lm_cross": cross,
        "lm_cross_train": cross_train,
        "lm_model_axis": model_axis,
        "lm_build_step": placed,
        "lm_long_context": long,
        "audit": audited,
        "tab52_serving": tab52,
        "launch_floor": floor,
        "seconds": time.perf_counter() - t_start}))
    main_shape, grad_main = timing["shapes"][0], grad_rows[0]
    apply_launches = {"lm_fused": lm["launches"]["gba_apply"], **{
        f"wire_{k}": v["gba_apply"] for k, v in wire["launches"].items()},
        "switch_autoswitch": switching["launcher"]["launches"]["gba_apply"],
        "switch_int8_reentry":
        switching["reentry"]["launches"]["gba_apply"],
        "sharded_fused": sharded["sharded_fused"]["launches"]["gba_apply"],
        "nccl_int8": sharded["nccl"]["nccl"]["launches"]["gba_apply"],
        "switch_nccl": sharded["switch_nccl"]["launches"]["gba_apply"],
        "sharded_fused_nccl":
        sharded["sharded_fused_nccl"]["launches"]["gba_apply"],
        **{f"train_{a}": trained[a]["launches"]["gba_apply"] for a in ARCHS
           if trained[a]["trained"]},
        **{f"train_{a}": ssm[f"train_{a}"]["launches"]["gba_apply"]
           for a in SSM_ARCHS},
        **{f"train_{a}": cross_train[a]["launches"]["gba_apply"]
           for a in CROSS_ARCHS},
        **{f"model_axis_{k}": v for k, v in model_axis["launches"].items()},
        "audit_tombstone": audited["a"]["launches"]["gba_apply"],
        "audit_schedule": audited["b"]["in_process"]["launches"]["gba_apply"],
        "audit_schedule_nccl":
        audited["b"]["nccl"]["launches"]["gba_apply"],
        "audit_launch_meta": audited["d"]["launches"]["gba_apply"]}
    wire_rows = []
    for name, line, runs in (
            ("quantize_minmax", 173, ("int8",)),
            ("quantize_sign", 201, ("onebit",)),
            ("dequantize", 224, ("int8", "onebit"))):
        row = wire["timing"][{"dequantize": "dequantize_minmax"}.get(
            name, name)]
        by_path = {f"wire_{k}": wire["launches"][k][name] for k in runs}
        by_path["audit_launch_meta"] = audited["d"]["launches"][name]
        if name != "quantize_sign":
            by_path["switch_int8_reentry"] = \
                switching["reentry"]["launches"][name]
            by_path["nccl_int8"] = sharded["nccl"]["nccl"]["launches"][name]
            by_path["switch_nccl_int8"] = \
                sharded["switch_nccl"]["launches"][name]
            by_path["model_axis_int8_wire_4x2"] = \
                model_axis["wire"]["4x2"]["launches"][name]
        # read from the last (compressed) global step of each run
        per_step = {f"wire_{k}": wire["runs"][k]["steps"][-1][
            name.split("_")[0]] for k in runs}
        wire_rows.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantize.cu",
            "replaces": f"src/repro/kernels/quantize.py:{line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_per_compressed_global_step": per_step,
            "max_abs_err": wire["max_abs_err"][name],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": row["library"],
            "library_note": "no single PyTorch call computes it" + (
                " in minmax mode; sign mode's torch.mul is under shapes"
                if name == "dequantize" else ""),
            "at": row["shape"],
            "shapes": [v for k, v in wire["timing"].items()
                       if k.startswith(name.split("_")[0])
                       and (name == "dequantize" or k == name)],
            "ok": True,
        })
    print(json.dumps({"kernels": [{
        "name": "embedding_bag",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:297",
        "launches": sum(fwd_launches.values()),
        "launches_by_path": fwd_launches,
        "max_abs_err": max_err,
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "at": main_shape["shape"],
        "shapes": timing["shapes"],
        "ok": True,
    }, {
        "name": "embedding_bag_grad",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag_grad.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:459",
        "launches": sum(bwd_launches.values()),
        "launches_by_path": bwd_launches,
        "max_abs_err": grad_max_err,
        "ms": grad_main["ms"],
        "plain_ms": grad_main["plain_ms"],
        "bound_ms": grad_main["bound_ms"],
        "bound_by": grad_main["bound_by"],
        "library_ms": grad_main["library_ms"],
        "design": {"counts, D = 0": grad_rows[0]["design"],
                   "D > 0": grad_rows[1]["design"]},
        "at": grad_main["shape"],
        "shapes": grad_rows,
        "ok": True,
    }, {
        "name": "gba_apply",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gba_apply.cu",
        "replaces": "src/repro/kernels/gba_apply.py:95",
        "launches": sum(apply_launches.values()),
        "launches_by_path": apply_launches,
        "max_abs_err": max(apply_max_err, wire["max_abs_err"]["gba_apply"]),
        "ms": apply_row["ms"],
        "plain_ms": apply_row["plain_ms"],
        "bound_ms": apply_row["bound_ms"],
        "bound_by": apply_row["bound_by"],
        "library_ms": None,
        "library": None,
        "library_note": "no single PyTorch call computes the decayed "
                        "aggregate and the Adagrad update",
        "at": apply_row["shape"],
        "shapes": [apply_row, trained["starcoder2-3b"]["gba_apply"],
                   *(cross_train[a]["gba_apply"] for a in CROSS_ARCHS),
                   model_axis["granite"]["gba_apply"],
                   model_axis["granite"]["wide"]["gba_apply"]],
        "ok": True,
    }, *wire_rows, *pytree_rows(pytree, resident, pytree_times, audited),
        serve_row(served, archs, ssm, cross, placed, long, audited)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(launch_row_main() if sys.argv[1:] == ["--launch-row"]
             else main())
