#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases (any mismatch or fault raises and the script exits non-zero):

0. build every CUDA kernel from src/repro_torch/kernels/csrc (one nvcc per
   source, started together);
1. the simulator's kernels against their plain PyTorch versions on the
   card, bitwise: the ranking kernels at N = 1, 100, 1,025, 2^20,
   1,000,003 and 2^22 + 1 (top 1, 8 and 64, three densities, scores tied
   across tiles), the per-row lane scatter at the main path's stacked
   shapes, and ``lane_scatter_batch`` on random batches (the serve's
   [24, N] f32 + [4, N] bool write, a 9-write eviction batch on [2, N]
   bool, masks, set and add, elements written twice, a target and a view
   of it, batches over the parameter block), one launch a block, and the
   point-update journal's kernel against the plain journal on the CPU
   test's random journals (serves, commits and cached-bit sets, chains
   of ops at one point, each journal flushed at three cuts) at L = 1, 2,
   5, 18 and 72 over N = 100 and 2^20 and one lane over the 2^19-slot
   table with first touches (GreedyDual and other lanes, masked lanes,
   lanes not due, inf ``complete_t``, counts 0 and 1), one launch a
   parameter block; then CUDA-event timings at the main path's shapes
   (the ranking kernels at N = 100 and 2^20, the serving flush of 4
   objects into the mirror of 4,096 and 2^18 objects as one batch and as
   two ``index_put_``, a journal's flush of 1, 4, 16 and 256 ops over 1
   and 18 lanes, and on the host clock an appended op and a flush
   call);
2. the paper's result: eq. 17 improvement of the eq.-16 policy over LRU on
   the fig2 synthetic workload (``PAPER_REQUESTS``) through the kernels, held bitwise against
   the same run through the plain versions on the card, plus the card's
   run against the CPU run of a small trace;
3. the state at deployment size: a dense table over 2^20 objects
   (``DEPLOY_REQUESTS`` requests, or ``--requests``), with the kernel path held against the plain path and the ``evict_top=0`` path;
4. the two attention kernels against their plain versions on the card over
   head widths 16/32/64/128 (bf16 takes the tensor-core prefill kernel,
   f32 the CUDA-core one), GQA groups 1/4/12/24 and 7 (DeepSeek-Coder-
   33B's 56 q / 8 KV heads: a decode q tile of 8 with an idle row), ragged
   Sq and Sk
   (Sq 17, 31 and 33 against the 16-row mma tile), windows of 4096 (with
   and without a sink) and 32, softcap 0 and 30, a wrapped ring-buffer
   cache with empty slots, decode caches of 1, 63, 65 and 129 slots
   (against the 64-slot split granularity) and of 4300 slots at batch 3
   (dozens of splits), caches with no visible slot, Hymba-1.5B's shapes
   (25 q and 5 KV heads of 64, window 1024 with a 128-token sink, a
   wrapped 1152-slot ring with empty slots), in f32 (max |diff| <= 1e-5)
   and bf16 (at most one bf16 ulp of each output element, plus 1e-5);
   then their times at StableLM-2-1.6B's and Hymba-1.5B's shapes beside
   their bounds, the plain versions and PyTorch's
   ``scaled_dot_product_attention``;
5. the LM serve path at full width: ``stablelm-1.6b`` (24 layers, d 2048,
   bf16, random weights from a seed) behind a ``ContinuousBatcher``
   (max_batch 4, 8 requests of 512-2048 prompt tokens, ``SERVE_NEW`` = 16
   new tokens each, cut from 32) through the kernels, the same requests through the plain
   versions (both after an untimed warm-up of both on the same
   prompts), and an f32 check of prefill and teacher-forced decode logits
   of the kernel path against the plain path;
6. the ``gla_chunk`` kernel against its plain version on the card over
   (dk, dv) in (16, 128), (512, 512), (64, 64), (16, 32), chunks of 16,
   64 and 256 (one and three of them), normalised or not, zero or given
   initial state, contiguous or strided q and k, f32 (the CUDA-core
   kernel) and bf16 (the tensor-core route), and the main path's two
   shapes (y, S and n within atol 1e-4 + rtol 1e-3, bf16 y within one
   more bf16 ulp), the bf16 route's distance to ``ref.gla_chunk_split``
   logged; then its times at xLSTM-350M's and Hymba-1.5B's prefill shapes
   beside the plain version, its bound, its split-work and scratch floors
   and the blocks of its grids;
7. ``xlstm-350m`` (24 mLSTM blocks, d 1024, bf16) at full width behind
   the ``ContinuousBatcher`` as in phase 5, through the kernel (192
   ``gla_chunk`` launches) and its plain version, and the f32 check;
8. ``hymba-1.5b`` (32 blocks, d 1600, bf16) at full width behind the
   ``ContinuousBatcher`` as in phase 5, its position offset the 128 meta
   tokens (caches of meta + prompt + new + 1 positions, cut to the
   1,152-slot ring; decode at ``pos0 = meta + S + i``), ``HYMBA_NEW`` =
   8 new tokens a request (cut from 32), through
   ``gla_chunk`` and ``flash_attention`` (once a layer a prompt) and
   ``decode_attention`` (once a layer a decoded token) and through their
   plain versions, and the f32 check on two prompts that pack the ring.

9. the sweep grid: (a) fig2 through ``repro_torch.figures.
   fig2_synthetic.run`` at ``FIG2_GRID_REQUESTS`` requests (cut from
   fig2's own 30,000: at 30,000 phases 0-10 alone took 949 s on an
   H100 80GB HBM3 at 700 W, and phases 0-12 over 1300 s; 100
   objects, Poisson and Pareto arrivals, C = 500 MB; the 11-policy roster
   with the recency residual and the rate residual's three policies, each
   with its LRU lane) through the kernels and, side by side in a second
   process, through the plain versions, all four grids bit for bit, the
   eq.-16
   Poisson/recency improvement inside 3-30%, every policy's improvement
   printed; (b) lru / vacdh / stoch_vacdh x omega {0.5, 1, 2} x capacity
   {5%, 10%} of the touched footprint over phase 3's 2^20-object
   universe (18 lanes, 943 MB of state) for ``GRID_REQUESTS`` requests
   (cut for the host-bound replay rate), kernels against plain
   versions bit for bit, three lanes against single-lane ``simulate``
   calls, with lane-requests/s and syncs per lane-request against the
   18 one-lane runs' wall extrapolated from those three;
10. streaming: ``realworld_raw`` (``STREAM_REQUESTS`` requests, cut from
   fig_realworld's 1,000,000 for time; 200,000 keys, epoch times from
   1.7e9 s) compacted as fig_realworld does (top 4096 + a pool of 512,
   capacity 10% of the footprint) and replayed by ``simulate_stream``
   (chunks of 4096, rebased) through the kernels and the plain versions
   bit for bit; ``simulate_chunked`` (4096) against ``simulate`` on
   9(a)'s fig2 Poisson trace (``FIG2_GRID_REQUESTS``), and the chunked
   fig2 Poisson rate grid against 9(a)'s unchunked one;
11. the slot table: phase 10's raw stream with every key its own id
   (``exact_requests``: fig_realworld's exact rows) replayed by
   ``simulate_stream(state_mode="slots")`` over ``slot_table_size(200,000,
   load=0.75)`` = 2^19 slots (chunks of 4096, rebased; the eq.-16 lane
   scored by ``ranking_scores`` over the table, every eviction an argmin
   with the id tie-break) through the kernels and the plain versions,
   and the dense ``evict_top=0`` replay of the same stream, all bit for
   bit; a ``SLOT_PREFIX``-request prefix under hash seeds 0 and 1
   (bit for bit) and through a table of half its keys (reclaim fires),
   kernels against plain versions bit for bit with every request
   counted; one eviction's pick at 2^19 slots, its device kernels
   (``torch.profiler``) and time with the id and the position tie-break;
12. the hierarchy: (a) ``fig6_hierarchy.run`` over its default grid
   (routes hash and random x S 1 and 4, each a grid of 4 hop laws x 3
   policies x L2 0/2000) cut to ``HIER_REQUESTS`` requests (at 5,000
   phase 12 took 199.9 s on an H100 80GB HBM3 at 700 W), with
   the kernel writes and, side by side in a second process, the plain
   writes, every point bit for bit, the eq.-16 improvement over LRU
   printed per route, S, hop law and L2 capacity; (b) 4 hash-routed L1 shards (stoch_vacdh,
   5% of the touched footprint each) over an LRU L2 (20%), exponential
   hops of mean 0.01 s, over phase 3's 2^20-object universe (5 lanes,
   262 MB of state) for the same ``HIER_REQUESTS`` requests, kernel writes against
   plain writes bit for bit, with req/s and syncs per request;
13. serving: the prefix-cache engine on a 600-request flash crowd on the
   card against the CPU (every counter, the latency sum and the sketch);
   (a) ``bench_serving.run(smoke=True)`` (flash_crowd, degraded_replica
   and origin_outage at 3,000 requests, hedged and not, flash_crowd
   through an L1 + L2, SLO bisections) through the kernels and through
   the plain versions, every row field but ``bench_serving.MEASURED``
   equal, with req/s, syncs per request and ranking and lane-scatter
   launches an admission; (b) flash_crowd at ``SERVE_REQUESTS``
   requests over ``N_KEYS`` keys through a ``SERVE_OBJECTS`` = 2^18-object
   prefix table (25% of the footprint, hedged), eq. 16 (through
   ``ranking_victim_order``) and LRU (its epilogue and a sort on the
   card), kernels against plain versions in every (outcome, latency)
   pair and counter, with req/s, syncs per request and the mirror's
   bytes.  A kernel run must launch ``ranking_victim_order`` at least
   once an eq.-16 admission and the lane scatter at least once a rank.
   (a)'s plain run goes in a second process beside the rest of the
   phase (alone it took 64.2 s of the phase's 109.1 s on an H100 80GB
   HBM3 at 700 W);
14. the sweep fabric: (a) ``bench_sweep``'s 24-lane scaling grid
   (stoch_vacdh, 8 omegas x 3 capacities, 100 objects, eq. 16 through
   ``ranking_victim_order``) at ``FABRIC_REQUESTS`` requests, (b)
   the same grid with lru and vacdh lanes beside stoch_vacdh (72 lanes)
   at ``FABRIC_MULTI_REQUESTS``, (c) fig6's hash route at S = 4 with its
   4 hop laws at ``FABRIC_HIER_REQUESTS`` requests: each in process and through ``mesh=make_data_mesh(1)``
   (one worker process on the card), every field bit for bit, the
   worker's launches counted, with both lane-requests/s and the worker's
   start-up seconds; (d) ``devices=2`` must raise on a one-card machine;
15. ``phi3.5-moe-42b-a6.6b`` at full width (d 4096, 32 q / 8 KV heads of
   128, 16 experts of d_ff 6400, top-2, vocab 32064, bf16, random weights
   from a seed) cut to ``MOE_LAYERS`` = 8 of its 32 layers (10.7 B
   parameters, 21.3 GB; the whole model is ~84 GB in bf16, more than the
   card's 80 GB) behind the batcher as in phase 5, through the kernels
   and the plain versions (``flash_attention`` once a layer per prompt,
   ``decode_attention`` once a layer per decoded token), with the device
   idle share of one request (run again, then under ``torch.profiler``) and
   ``torch.cuda.max_memory_allocated``; then an f32 check at
   ``MOE_CHECK_LAYERS`` = 2 layers: every MoE call's top-2 expert choices
   equal between the kernel and the plain path (the smallest router
   margin printed), then phase 5's logits check;
16. training: (a) the ``flash_attention`` and ``gla_chunk`` kernel ops'
   autograd on the card against autograd of their plain versions in f32
   (GQA, windows, a softcap and a sink; chunks 16 and 64), outputs and
   gradients within phase 4's and phase 6's f32 bounds; (b)
   ``make_train_step`` on phi3.5-MoE at full width, 2 layers (2.86 B
   parameters, bf16, remat "full"), 8 sequences of 512 tokens in 2
   microbatches, 4 steps on one batch: every loss finite, the last below
   the first, ``flash_attention`` launched twice a layer per microbatch
   (the forward and the checkpoint's recompute), with step seconds, train
   tokens/s, peak memory and the idle share of one more profiled step;
   (c) one ``value_and_grad`` of the phi3.5-MoE smoke config in f32 on the
   card against the CPU, loss and every gradient within atol 1e-5 + rtol
   1e-4; (d) the ``Trainer`` at smoke size on the card, checkpoints every 2
   steps, SIGTERM after step 3 (its preemption flag), resumed to step 6,
   the restored state bitwise the saved one (checkpoints stay at smoke
   size: a full-width one would be ~40 GB);
17. the sharding layer: (a) started right after the build and run on the
   CPU beside phases 1-16 (two subprocesses at a time, no card visible):
   ``repro_torch.launch.dryrun`` of every cell of ``CELL_PLAN`` on one
   device (1 x 1) at the depth and batch the card runs it
   (``--layers``, ``--global-batch``), and StableLM's three cells on the
   single production mesh too (16 x 16, a fake world of 256 ranks); each
   production record's per-device peak, flops, wire bytes by kind and its
   roofline row printed; (b) the cells of ``CELL_PLAN`` through
   ``launch.cells.input_specs`` on ``make_local_mesh()`` as DTensors over
   a one-rank NCCL ``DeviceMesh``, from a seed at full width:
   StableLM-2-1.6B, xLSTM-350M and Hymba-1.5B at train_4k, prefill_32k
   and decode_32k, and xLSTM's and Hymba's long_500k; MusicGen-large
   (``audio``: ``embeds`` in, four codebook heads out) and
   LLaVA-NeXT-Mistral-7B (``vlm``: ``embeds`` in) at the same three;
   phi3.5-MoE at the three and Grok-1 (8 GeGLU experts, top 2, attention
   softcap 30) at prefill_32k and decode_32k; the ``dense`` configs
   DeepSeek-Coder-33B (56 q / 8 KV heads, SwiGLU), Minitron-8B
   (squared-ReLU MLP, a 256,000-entry vocab) and StarCoder2-15B (plain
   GELU MLP, a 4,096 window with no sink: its 32k decode writes a
   4,096-slot ring) at the three, and DeepSeek's decode_32k again over an
   fp8 e4m3 KV cache (``F8_DECODE``: bit for bit, finite, the cache half
   the bf16 cell's bytes).  A train cell takes 4 x 4,096 tokens (or
   embeddings, ``batch_at`` with the config's frontend; fewer rows where
   ``CELL_PLAN`` cuts them) for ``CELL_TRAIN_STEPS`` steps at a peak
   learning rate of 3e-4 (``CELL_LR`` where a model's loss rose over the
   four steps at 3e-4), each train kernel
   (``flash_attention``, ``gla_chunk``) twice a layer a step; a prefill 32,768 positions, each
   prefill kernel once a layer; a decode shape its rows at the last
   ``CELL_DECODE_STEPS`` positions of meta + 32,768 (decode_32k) or meta
   + 524,288 (long_500k, batch 1) over a cache filled from a seed
   (StableLM's 32,768-slot cache is 51.5 GB at 8 rows, MusicGen's 51.5
   GB at 4, LLaVA's 34.4 GB at 8; Hymba's is a 1,152-slot ring and a GLA
   state, xLSTM's a GLA state), ``decode_attention`` once a layer a step
   where the model has attention; each cell against the same steps on
   plain tensors bit for bit (losses and parameters; logits and every
   cache leaf), and the 32k prefill's kernel route against the plain
   route (q-chunked attention, plain GLA) in f32 at 2 layers (Grok-1 at
   ``F32_LAYERS`` = 1: two of its layers' f32 weights are 45.8 GB, and
   the 32k prefill's f32 expert activations ~32 GB more) (last-token
   logits within 1e-3 of max |logit|);
   measured peak memory, step time and tokens/s printed beside the local
   dry run's prediction and its roofline bound; (c) the custom op's host
   cost a call over the kernel wrapper's at phase 5's decode shape; (d)
   for ``GRAD_ARCHS`` (xLSTM, Hymba, MusicGen through its four-head
   loss), one f32 ``value_and_grad`` at full width, 2 layers,
   ``GRAD_CHECK`` = 2 x 512 tokens, through the kernels' forward against
   the plain route: the loss and every gradient element within atol 1e-5
   + rtol 1e-4.  Depth and batch cuts (``CELL_PLAN``): MusicGen decodes 4
   rows (8 would need 103 GB of cache); LLaVA trains 4 of its 32 layers
   (7.2 B parameters' AdamW state is ~116 GB); phi3.5-MoE serves 8 of 32
   layers (phase 15's cut) and trains 1 (at 16(b)'s 2 the dry run
   predicts a 68.71 GiB peak, and the card's peaks ran 8-13 GiB over it
   where the plain attention backward forms its scores); Grok-1 serves 2
   of 64 layers (4.8 B parameters a layer) and has no train cell (one
   layer's AdamW state is ~78 GB); DeepSeek-Coder-33B serves 24 of 62
   layers (1.06 GB of weights and ~1 GiB of 8-row cache a layer) and
   trains 2 layers at 2 rows, StarCoder2-15B trains 3 layers at 2 rows
   (at 4 rows the plain attention backward's f32 scores pass the card),
   Minitron-8B trains 4 layers at 1 row (its loss's f32 (B, 4,096,
   256,000) copies are 4.2 GB a row); StableLM, xLSTM, Hymba and MusicGen
   train 12 of 24, 12 of 24, 16 of 32 and 24 of 48 layers for the time
   limit (below); every other cell runs at its config's depth;
18. ``fig_realworld``: ``repro_torch.figures.fig_realworld.run`` at
   ``REALWORLD_REQUESTS`` requests (cut from its 1,000,000, which takes
   a 3000 s call of its own: ``figures.run --only realworld``) with every
   section (the 11-policy roster streamed in chunks of 131,072, the
   device and auto-chunk rows, the compaction probe at top_k 1024 / 4096
   / 16,384 and the exact rows through the slot table), every section's
   rows present, its LRU and eq.-16 roster rows again through the plain
   versions bit for bit;
19. the example modules (``repro_torch.examples``), each ``run()`` through
   the kernels and through the plain versions on the card: (a)
   ``quickstart`` at ``EX_QS_REQUESTS`` requests (cut from 30,000) with
   its Monte-Carlo check at n = 200,000, each moment within 4 standard
   errors of Theorem 2, eq. 16 through ``ranking_victim_order`` and the
   Erlang row through the epilogue; (b) ``trace_sim`` on wiki2018 at
   ``EX_TS_REQUESTS`` (cut from 50,000), its 7 policies; (c)
   ``hierarchy_sim`` at ``EX_HIER_REQUESTS`` (cut from 30,000), its
   three hierarchies and its 2 x 4 L2 grid; every counter, latency and
   grid field of (a)-(c) bit for bit; (d) ``serve_engine``: the smoke
   StableLM behind the batcher (``flash_attention`` once a layer a
   prompt, ``decode_attention`` once a layer a decoded token) and the
   prefix-cache A/B at ``EX_AB_REQUESTS`` (cut from 20,000), every
   ``EngineStats`` field equal, then phase 5's f32 logits check on two
   of its prompts; (e) ``train_small`` (lm-100m, bf16) for
   ``EX_TRAIN_STEPS`` steps (``flash_attention`` once a layer a
   microbatch), the same run preempted at step 5 and resumed, and the
   run in f32 through the kernels and the plain versions, losses within
   atol 1e-5 + rtol 1e-4.  The plain runs of (a)-(c) go in a second
   process beside the rest of the phase (alone they took 59.7 s of its
   122.5 s on an H100 80GB HBM3 at 700 W).

Every engine of the replays in this process (phases 2-3, 9-12, 14's
in-process grids and 18) holds its host mirror (the ``cached`` and
``in_flight`` bits and ``complete_t``) against its device state, bit for
bit, as it returns its results (``check_mirrors``); the second
processes of 9(a) and 12(a) and 14's workers are held by their results,
bit for bit against the in-process ones.

Depth cuts for the 1,200 s limit: the replays of phases 2-3 and 9-14
are host-bound, and with phases 15-16 added the script took 1020.5 s on
an H100 80GB HBM3 at 700 W in one run and over 1,200 s in a second run
of the same tree on the same kind of card.  So each of those replays
runs at half its earlier depth: ``PAPER_REQUESTS`` 30,000 -> 10,000,
``DEPLOY_REQUESTS`` 20,000 -> 10,000, ``FIG2_GRID_REQUESTS`` 10,000 ->
5,000, ``GRID_REQUESTS`` 5,000 -> 2,500, ``STREAM_REQUESTS`` 20,000 ->
10,000, ``SLOT_PREFIX`` 5,000 -> 2,500, ``HIER_REQUESTS`` 2,500 ->
1,250, ``SERVE_REQUESTS`` 20,000 -> 10,000, and ``FABRIC_REQUESTS`` /
``FABRIC_MULTI_REQUESTS`` / ``FABRIC_HIER_REQUESTS`` 5,000 / 2,500 /
2,000 -> 2,500 / 1,250 / 1,000.  With phase 17 added the script took
688.6 s in one run and 924.0 s in a second run of the same code (the
host-bound phases 35-45% slower on that machine), so every replay
was halved again: ``PAPER_REQUESTS`` 10,000 -> 5,000,
``DEPLOY_REQUESTS`` 10,000 -> 5,000, ``FIG2_GRID_REQUESTS`` 5,000 ->
2,500, ``GRID_REQUESTS`` 2,500 -> 1,250, ``STREAM_REQUESTS`` 10,000 ->
5,000, ``HIER_REQUESTS`` 1,250 -> 625, ``SERVE_REQUESTS`` 10,000 ->
5,000 and the three fabric depths 2,500 / 1,250 / 1,000 -> 1,250 / 625
/ 500 (``SLOT_PREFIX`` stays 2,500).  The eq.-17 bands of phases 2 and
9(a) hold at the new depths (13.534% and 6.670% on the CPU through the
plain versions).  The shapes (object universes, key spaces, tables,
lanes, models) are unchanged.

Phase 18 is paid for by the point update on the card, which cut the
replays' read-backs to their scoring commits and argmins; every earlier
depth stays as it was.  The replays queue their point updates and
cached-bit writes in the point-update journal and flush it before each
read of the card's state, so a replay launches ``point_update`` about
once a read-back and ``lane_scatter`` never (``drive`` checks the
latter).

Phase 19 took 95.1 s with its plain replays beside it (122.5 s with them
after it) and the script 632.0 s on an H100 80GB HBM3 at 700 W, past
half the limit, so phase 18, the longest host-bound phase (72.0 s),
runs at half its depth: ``REALWORLD_REQUESTS`` 5,000 -> 2,500.

Phase 8 through the batcher and the GLA family's cells and gradient
checks in phase 17 add card work, and the script took 826.9 s in one run
of the parent tree (phase 13 109.1 s, phase 19 113.8 s; 632.0 s in
another run of the same code), so before they were added the two
longest host-bound phases were cut: phase 13(a)'s plain run went into
a second process and ``SERVE_REQUESTS`` 5,000 -> 2,500; phase 19's
replays ``EX_QS_REQUESTS`` 2,500 -> 1,250, ``EX_TS_REQUESTS`` 2,000 ->
1,000, ``EX_HIER_REQUESTS`` 1,000 -> 500 and ``EX_AB_REQUESTS`` 2,000 ->
1,000; phase 8 decodes ``HYMBA_NEW`` = 16 tokens a request (phase 5's
32).  With them the script took 627.0 s and 671.6 s in two runs and
835.5 s in a third (a host ~1.3x slower on every phase), so the other
host-bound replays were halved: ``SLOT_PREFIX`` 2,500 -> 1,250,
``HIER_REQUESTS`` 625 -> 312, the three fabric depths 1,250 / 625 / 500
-> 625 / 312 / 250, ``REALWORLD_REQUESTS`` 2,500 -> 1,250, and
``HYMBA_NEW`` 16 -> 8.  Phases 2 and 9(a), which hold the eq.-17 bands,
and phase 10's stream (two chunks of 4096) keep their depths.

Phase 17's cells of MusicGen-large, LLaVA-NeXT-Mistral-7B, phi3.5-MoE and
Grok-1 and the long_500k cells add card work (the phase took 122-142 s
with three models), so the serve phases decode ``SERVE_NEW`` = 16 tokens a
request (phases 5, 7 and 15, and phase 15's profiled request, cut from
32; phase 15's profile alone took 26.2 s) and ``REALWORLD_REQUESTS``
1,250 -> 625.

Phase 17's ``dense`` cells (DeepSeek-Coder-33B, Minitron-8B and
StarCoder2-15B, and DeepSeek's fp8 decode: 108.6 s of the phase on an
H100 80GB HBM3 at 700 W) were paid for by halving the two longest train
cells: Hymba's train_4k 32 -> 16 layers (its 8 steps, DTensor and plain,
~42 s -> ~21 s) and MusicGen's 48 -> 24 (~47 s -> ~23 s; at 24 layers
its loss falls at the default peak rate of 3e-4, which it now takes).  With
them the script took 996.9 s (phase 17 336.0 s) on a host 1.1-1.9x
slower on the host-bound phases than the run that took 770.5 s, so
StableLM's and xLSTM's train_4k were halved too, 24 -> 12 layers (~12 s
each on that host), and phase 3's ``DEPLOY_REQUESTS`` 5,000 -> 2,500
(~15 s).

The kernel timings of phases 1, 4 and 6 come from
``repro_torch.figures.bench_kernels`` (the ``kernels`` job of
``repro_torch.figures.run``); their checks are here.

Each main-path run starts from zeroed launch counts, prints its req/s,
syncs a request and lane-scatter and point-update launches per request,
and must launch every kernel it
reaches (the LM runs: exactly once a layer per prompt or per
decoded token; a fabric run's worker, counted in the worker); a run
through the plain versions must launch none.

The last line of standard output is ``{"ok": true, "device": {...}}``;
before it come the ``kernels`` JSON line and the card's name and power
limit as nvidia-smi gives them, and each phase's seconds.  With no card
it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOP = 8                       # the simulator's EVICT_TOP
N_DEPLOY = 1 << 20            # the million-key universe of probe_memory
PAPER_REQUESTS = 5_000        # phase 2's fig2 workload, cut from 30,000
DEPLOY_REQUESTS = 2_500       # phase 3's replay, cut from 20,000
GRID_REQUESTS = 1_250         # phase 9b's replay, cut from 5,000
FIG2_GRID_REQUESTS = 2_500    # phases 9a-10's fig2, cut from 10,000
STREAM_REQUESTS = 5_000       # phases 10-11's stream, cut from 20,000
N_KEYS = 200_000              # fig_realworld's key space
SLOT_PREFIX = 1_250           # phase 11's seed and reclaim runs, from 5,000
HIER_REQUESTS = 312           # phase 12's hierarchies, cut from 2,500
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 8                # phase 15: 8 of 32 layers (~84 GB in all)
MOE_CHECK_LAYERS = 2          # phase 15's f32 check, phase 16(b)'s model


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int = 100) -> float:
    """Median device time of one ``fn()`` call over ``reps`` calls
    (``repro_torch.figures.bench_kernels.time_ms``: CUDA events, the calls
    queued behind a sleep kernel)."""
    from repro_torch.figures import bench_kernels
    return bench_kernels.time_ms(fn, reps)


def bitwise_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def ranking_inputs(n: int, density, seed: int):
    """Eq.-16 inputs on the card (``bench_kernels.ranking_inputs``); an
    eighth of the elements repeat other elements' inputs exactly, so
    scores tie across tiles."""
    from repro_torch.figures import bench_kernels
    return bench_kernels.ranking_inputs(n, density, seed)


RANK_NS = (1, 100, 1025, N_DEPLOY, 1_000_003)   # fig2's table is N = 100
# the kernels a replay's kernel run must launch: every engine's point
# updates (the journal), and its scoring (eq. 16's victim order, or its
# argmin); a replay launches no lane scatter (``drive``)
REPLAY_RUN = ("point_update",)
EQ16_RUN = ("ranking_victim_order",) + REPLAY_RUN
ARGMIN_RUN = ("ranking_scores",) + REPLAY_RUN
RANK_TOPS = (1, TOP, 64)


def check_ranking(err: dict) -> int:
    """Both ranking wrappers against their plain versions, bitwise: every
    N of RANK_NS at omega 0/1/2, densities 0.5/sparse/0 and every top of
    RANK_TOPS, plus 2^22 + 1 objects (three merge levels) at omega 1."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ranking_score import (ranking_scores,
                                                   ranking_victim_order)
    grid = [(n, omega, density) for n in RANK_NS for omega in (0.0, 1.0, 2.0)
            for density in (0.5, "sparse", 0.0)]
    grid += [((1 << 22) + 1, 1.0, density) for density in (0.5, "sparse")]
    cases = 0
    for seed, (n, omega, density) in enumerate(grid):
        args = ranking_inputs(n, density, seed=seed)
        for top in RANK_TOPS:
            f, idx, vals = ranking_victim_order(*args, omega=omega, top=top)
            rf, ridx, rvals = ref.ranking_victim_order_ref(
                *args, omega, min(top, n))
            if not (bitwise_equal(f, rf) and bitwise_equal(idx, ridx)
                    and bitwise_equal(vals, rvals)):
                raise AssertionError(
                    f"ranking_victim_order != plain at n={n} omega={omega} "
                    f"density={density} top={top}: idx {idx.tolist()[:16]} "
                    f"vs {ridx.tolist()[:16]}, vals {vals.tolist()[:16]} "
                    f"vs {rvals.tolist()[:16]}")
            err["ranking_victim_order"] = max(
                err["ranking_victim_order"], float((f - rf).abs().max()))
            cases += 1
        f2, i2, v2 = ranking_scores(*args, omega=omega)
        rf2, ri2, rv2 = ref.ranking_scores_ref(*args, omega)
        if not (bitwise_equal(f2, rf2) and int(i2) == int(ri2)
                and bitwise_equal(v2, rv2)):
            raise AssertionError(
                f"ranking_scores != plain at n={n} omega={omega} "
                f"density={density}: ({int(i2)}, {float(v2)}) vs "
                f"({int(ri2)}, {float(rv2)})")
        err["ranking_scores"] = max(err["ranking_scores"],
                                    float((f2 - rf2).abs().max()))
        cases += 1
    return cases


def batch_writes(rng, targets, n_writes, masked, add, repeat):
    """Random writes (host operands) over ``targets``, round robin; with
    ``repeat`` every other write re-hits half the elements of the previous
    write to the same target."""
    import numpy as np
    import torch
    writes, prev = [], {}
    for k in range(n_writes):
        x = targets[k % len(targets)]
        rows, n = x.shape
        idx = rng.integers(0, n, rows).astype(np.int32)
        if repeat and id(x) in prev and k % 2:
            idx[:rows // 2 + 1] = prev[id(x)][:rows // 2 + 1]
        prev[id(x)] = idx
        if x.dtype == torch.bool:
            val = rng.random(rows) < 0.5
        elif x.dtype == torch.int32:
            val = rng.integers(-1000, 1000, rows).astype(np.int32)
        else:
            val = (rng.standard_normal(rows) * 100).astype(np.float32)
        valid = rng.random(rows) < 0.6 if masked else None
        writes.append((x, idx, val, valid,
                       add if add is not None else bool(k % 2)))
    return writes


def check_lane_batch(err: dict) -> int:
    """``lane_scatter_batch`` against ``lane_scatter_batch_ref``, bitwise,
    with its launches counted against the blocks the batch packs into."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import lane_scatter as ls
    g = torch.Generator(device="cuda").manual_seed(5)
    rng = np.random.default_rng(5)
    n = N_DEPLOY

    def state(rows, dtype, width=n):
        if dtype == torch.bool:
            return torch.rand((rows, width), generator=g, device="cuda") < 0.5
        return (torch.randn((rows, width), generator=g, device="cuda")
                * 100).to(dtype)

    cases = 0
    for masked in (False, True):
        for add in (False, True, None):
            for repeat in (False, True):
                vals, flags = state(24, torch.float32), state(4, torch.bool)
                ints, cached = state(8, torch.int32), state(2, torch.bool)
                for what, targets, k in (
                        ("serve [24, N] f32 + [4, N] bool", [vals, flags], 2),
                        ("eviction batch, 9 writes on [2, N] bool",
                         [cached], 9),
                        ("f32 + i32 + bool, 12 writes",
                         [vals, ints, flags], 12),
                        ("[4, N] bool and its first rows as a view",
                         [flags, flags[:2]], 6),
                        ("240 writes on [24, N] f32 (over a block)",
                         [vals], 240)):
                    writes = batch_writes(rng, targets, k, masked, add,
                                          repeat)
                    want = {id(x): x.clone() for x in (vals, flags, ints,
                                                       cached)}
                    ref.lane_scatter_batch_ref(
                        [(want[id(x)] if id(x) in want
                          else want[id(flags)][:2], *w) for x, *w in writes])
                    before = ls.launches["lane_scatter"]
                    ls.lane_scatter_batch(writes)
                    got_n = ls.launches["lane_scatter"] - before
                    blocks = len(ls.pack(ls._prepare(writes)[1]))
                    if got_n != blocks:
                        raise AssertionError(f"{what}: {got_n} launches for "
                                             f"{blocks} blocks")
                    for x in (vals, flags, ints, cached):
                        if not bitwise_equal(x, want[id(x)]):
                            raise AssertionError(
                                f"lane_scatter_batch != plain: {what}, "
                                f"masked={masked} add={add} "
                                f"repeat={repeat}")
                    cases += 1
    # one write of more rows than a block holds: cut by rows
    big = state(5000, torch.float32, 64)
    writes = batch_writes(rng, [big], 3, True, None, True)
    want = big.clone()
    ref.lane_scatter_batch_ref([(want, *w) for _, *w in writes])
    ls.lane_scatter_batch(writes)
    if not bitwise_equal(big, want):
        raise AssertionError("lane_scatter_batch != plain: [5000, 64] rows")
    cases += 1
    return cases


POINT_LANES = (1, 2, 5, 18, 72)   # one-lane replays ... the 72-lane grid
SLOT_TABLE = 1 << 19              # phase 11's table


def check_point_update(err: dict) -> int:
    """The point-update journal's kernel against its plain journal,
    bitwise, on the CPU test's journals (``bench_kernels.journal_ops``):
    L in POINT_LANES over N = 100 and 2^20, one lane over the 2^19-slot
    table with first touches; chains of ops at one point, serves,
    commits and cached-bit sets interleaved, GreedyDual and other lanes,
    masked lanes, lanes not due, estimate_z on and off, random states
    holding inf ``complete_t`` and counts 0 and 1; each journal flushed at
    three cuts.  Launches must equal the plain journal's blocks."""
    import numpy as np
    import torch
    from repro_torch.core.ranking import EPS
    from repro_torch.figures.bench_kernels import (journal_ops, point_lanes,
                                                   point_state, push_ops)
    from repro_torch.kernels import point_update as pu
    shapes = [(n, lanes, False) for n in (100, N_DEPLOY)
              for lanes in POINT_LANES] + [(SLOT_TABLE, 1, True)]
    cases = 0
    for seed, (n, lanes, slot) in enumerate(shapes):
        lane = point_lanes(lanes, seed)
        est = bool(seed % 2)
        runs = []
        for plain in (False, True):
            values, flags = point_state(lanes, n, seed, "cuda")
            table = ((torch.full((n,), -1, dtype=torch.int32,
                                 device="cuda"),
                      torch.zeros(n, device="cuda")) if slot else None)
            runs.append((pu.PointUpdate(values, flags, *lane, EPS, est,
                                        plain=plain, table=table),
                         [values, flags] + list(table or ())))
        ops = journal_ops(np.random.default_rng(17 + seed), lanes, n,
                          120 if lanes > 5 else 60, slot=slot, p_hot=0.5)
        for lo, hi in ((0, 1), (1, len(ops) // 2), (len(ops) // 2,
                                                   len(ops))):
            before = pu.launches["point_update"]
            blocks = [p.n_blocks for p, _ in runs]
            for p, _ in runs:
                push_ops(p, ops[lo:hi])
                p.flush()
            got = pu.launches["point_update"] - before
            want = [p.n_blocks - b for (p, _), b in zip(runs, blocks)]
            if not 1 <= got == want[0] == want[1]:
                raise AssertionError(f"point_update: {got} launches for "
                                     f"{want} blocks (kernel, plain)")
            for a, b in zip(runs[0][1], runs[1][1]):
                if not bitwise_equal(a, b):
                    raise AssertionError(
                        f"point_update != plain at N={n} L={lanes} "
                        f"slot={slot} ops {lo}:{hi}")
            cases += 1
        del runs
        torch.cuda.empty_cache()
    err["point_update"] = 0.0
    return cases


def phase_kernels() -> dict:
    """Every simulator kernel against its plain version; timings at the
    main path's shapes."""
    import torch
    from repro_torch.figures import bench_kernels
    from repro_torch.kernels import ref
    from repro_torch.kernels.lane_scatter import (lane_scatter_add,
                                                  lane_scatter_set)
    err = {"ranking_victim_order": 0.0, "ranking_scores": 0.0,
           "lane_scatter": 0.0, "point_update": 0.0}
    cases = check_ranking(err)
    log(f"phase 1: ranking kernels bitwise equal to plain over {cases} "
        f"cases (n in {', '.join(map(str, RANK_NS))}, 2^22+1; omega "
        f"0/1/2; density 0.5/sparse/0; top {'/'.join(map(str, RANK_TOPS))}"
        f" and the argmin; scores tied across tiles)")

    g = torch.Generator(device="cuda").manual_seed(99)
    lane_cases = 0
    # 12 and 24 rows are the main path's stacked f32 fields (1 and 2
    # lanes), 2 and 4 rows its stacked bool fields
    for lanes in (1, 2, 4, 8, 12, 24):
        for dtype in (torch.float32, torch.int32, torch.bool):
            for add in (False, True):
                for masked in (False, True):
                    n = N_DEPLOY
                    if dtype == torch.bool:
                        x = torch.rand((lanes, n), generator=g,
                                       device="cuda") < 0.5
                        val = torch.rand(lanes, generator=g,
                                         device="cuda") < 0.5
                    else:
                        x = (torch.randn((lanes, n), generator=g,
                                         device="cuda") * 100).to(dtype)
                        val = (torch.randn(lanes, generator=g,
                                           device="cuda") * 100).to(dtype)
                    idx = torch.randint(0, n, (lanes,), generator=g,
                                        device="cuda", dtype=torch.int32)
                    if lanes > 1:
                        idx[1] = idx[0]       # two lanes, one column
                    valid = (torch.rand(lanes, generator=g, device="cuda")
                             < 0.5) if masked else None
                    fn = lane_scatter_add if add else lane_scatter_set
                    rfn = ref.lane_scatter_add_ref if add \
                        else ref.lane_scatter_set_ref
                    got = fn(x.clone(), idx, val, valid)
                    want = rfn(x.clone(), idx, val, valid)
                    if not bitwise_equal(got, want):
                        raise AssertionError(
                            f"lane_scatter != plain: L={lanes} {dtype} "
                            f"add={add} masked={masked}")
                    lane_cases += 1
    log(f"phase 1: lane_scatter bitwise equal to plain over {lane_cases} "
        f"cases (L 1/2/4/8/12/24; f32/i32/bool; set/add; masked or "
        f"not)")
    batch_cases = check_lane_batch(err)
    log(f"phase 1: lane_scatter_batch bitwise equal to plain over "
        f"{batch_cases} batches (serve [24, N] f32 + [4, N] bool; 9 "
        f"eviction writes on [2, N] bool; f32 + i32 + bool; a target and a "
        f"view of it; 240 writes over a parameter block; one write of 5000 "
        f"rows; masked or not; set, add or both; elements written twice "
        f"or not), one launch a block")
    point_cases = check_point_update(err)
    log(f"phase 1: point_update journal (serves, commits, cached-bit sets, "
        f"chains at one point) bitwise equal to the plain journal over "
        f"{point_cases} flushes (L {'/'.join(map(str, POINT_LANES))}"
        f" at N = 100 and 2^20, one lane over {SLOT_TABLE} slots with first "
        f"touches; GreedyDual lanes, masked lanes, lanes not due, "
        f"estimate_z on and off), one launch a parameter block")

    # --- timings at the main path's shapes (bench_kernels) -----------------
    dev = torch.device("cuda")
    rows = (bench_kernels.time_ranking(dev)
            + bench_kernels.time_lane_scatter(dev)
            + bench_kernels.time_point_update(dev))
    for r in rows:
        log(f"phase 1: {r['name']} at {r['shape']}: {r['us']:.2f} us/launch,"
            f" plain {r['plain_us']:.2f} us, bound {r['bound_us']:.4f} us"
            + ("" if r["library_us"] is None else
               f", library {r['library_us']:.2f} us ({r['library']})"))
        if "host_call_us" in r:
            log(f"phase 1: lane_scatter at {r['shape']}: one batch call "
                f"{r['host_call_us']:.2f} us on the host clock (packing + "
                f"launch, 1000 calls)")
        if "append_us" in r:
            log(f"phase 1: point_update journal at {r['shape']}: "
                f"{r['append_us']:.2f} us of host an appended op (the mixed "
                f"journal), {r['serve_append_us']:.2f} us an engine serve, "
                f"{r['flush_host_us']:.2f} us a flush call of 4 ops, on "
                f"the host clock")
    return {r["name"]: kernel_entry(r, err[r["name"]]) for r in rows
            if r.get("main", r["n"] == N_DEPLOY)}


def kernel_entry(row: dict, max_abs_err: float) -> dict:
    """A bench_kernels row as the ``kernels`` line's timing fields (ms)."""
    ms = lambda us: None if us is None else us / 1e3
    return dict(ms=ms(row["us"]), plain_ms=ms(row["plain_us"]),
                bound_ms=ms(row["bound_us"]), bound_by=row["bound_by"],
                library_ms=ms(row["library_us"]), max_abs_err=max_abs_err)


def same_result(a, b) -> bool:
    return all(float(getattr(a, f)) == float(getattr(b, f))
               for f in ("total_latency", "n_hits", "n_delayed", "n_misses",
                         "n_evictions"))


def drive(label, fn, needs=()):
    """One run of a path from zeroed launch counts; ``needs`` names the
    kernels the run must launch (an empty tuple: the run must launch
    none; a replay, which needs ``point_update``, must launch no
    ``lane_scatter``).  Logs its rate, syncs a request, launches and the
    ops its point-update flushes applied (mean, 99th percentile,
    largest).  Returns the path's output, its counters and its launch
    counts."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.profile_replay import flush_sizes, flush_summary
    counts = {}
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with flush_sizes() as sizes:
        out = fn(counts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lc = launch_counts()
    lanes = (f"{counts['lane_requests'] / dt:.1f} lane-requests/s, "
             f"{counts['syncs'] / counts['lane_requests']:.4f} syncs/"
             f"lane-request, " if "lane_requests" in counts else "")
    log(f"{label}: {dt:.2f} s, {counts['requests'] / dt:.1f} req/s, {lanes}"
        f"{counts['syncs'] / counts['requests']:.3f} syncs/request, "
        f"{counts['scoring_commits']} scoring commits, "
        f"{lc['lane_scatter'] / counts['requests']:.3f} lane_scatter and "
        f"{lc['point_update'] / counts['requests']:.3f} point_update "
        f"launches/request, launches {lc}"
        + (f", ops a flush {flush_summary(sizes)}" if sizes else ""))
    for k in needs:
        if lc[k] <= 0:
            raise AssertionError(f"{label} did not launch {k}")
    if "point_update" in needs and lc["lane_scatter"]:
        raise AssertionError(f"{label}: a replay launched lane_scatter "
                             f"({lc['lane_scatter']} times)")
    if not needs and any(lc.values()):
        raise AssertionError(f"{label} launched kernels: {lc}")
    return out, counts, lc


def add_launches(total: dict, lc: dict) -> None:
    for k, v in lc.items():
        total[k] = total.get(k, 0) + v


def phase_paper(launches: dict) -> None:
    """Eq. 17 on the fig2 workload, kernels against plain versions; the
    card against the CPU on a small trace."""
    import torch
    from repro_torch.core import PolicyParams, latency_improvement, simulate
    from repro_torch.data.traces import SyntheticSpec, synthetic_trace

    small = SyntheticSpec(n_objects=60, n_requests=2000, rate=500.0,
                          latency_base=0.01, latency_per_mb=1e-3)
    tr = synthetic_trace(torch.Generator().manual_seed(2), small,
                         device="cpu")
    for policy in ("stoch_vacdh", "lru", "lru_mad"):
        on_card = simulate(tr, 200.0, policy, estimate_z=True)
        on_cpu = simulate(tr, 200.0, policy, estimate_z=True, device="cpu")
        if not same_result(on_card, on_cpu):
            raise AssertionError(f"{policy}: card {on_card} != cpu {on_cpu}")
    log("phase 2: small trace (60 objects, 2000 requests): card == CPU for "
        "stoch_vacdh, lru, lru_mad")

    spec = SyntheticSpec(n_objects=100, n_requests=PAPER_REQUESTS,
                         zipf_alpha=0.9,
                         rate=2000.0, latency_base=0.005,
                         latency_per_mb=2e-4, stochastic=True)
    tr = synthetic_trace(torch.Generator().manual_seed(0), spec)
    params = PolicyParams(omega=1.0, resid="recency")
    runs = {}
    for mode, needs in ((True, EQ16_RUN),
                        ("ref", ())):
        runs[mode] = drive(
            f"phase 2: fig2 latency_improvement(use_kernel={mode!r})",
            lambda c, mode=mode: latency_improvement(
                tr, 500.0, "stoch_vacdh", "lru", params=params,
                estimate_z=True, use_kernel=mode, counters=c),
            needs)
    (impr, counts, lc), (plain, plain_counts, _) = runs[True], runs["ref"]
    add_launches(launches, lc)
    if not (bitwise_equal(impr, plain) and counts == plain_counts):
        raise AssertionError(f"fig2: kernels {float(impr)} {counts} != "
                             f"plain {float(plain)} {plain_counts}")
    impr = float(impr)
    log(f"phase 2: fig2 workload (100 objects, {PAPER_REQUESTS} requests, "
        f"C=500 MB): "
        f"improvement over LRU {impr * 100:.3f}% (paper band 3-30%), "
        f"kernels == plain bitwise")
    if not 0.03 <= impr <= 0.30:
        raise AssertionError(f"improvement {impr} outside the 3-30% band")


def phase_deploy(n_requests: int, launches: dict) -> None:
    """Dense state over 2^20 objects on the card; kernel path vs plain."""
    import torch
    from repro_torch.core import (PolicyParams, latency_improvement,
                                  simulate)
    from repro_torch.core.state import F32_FIELDS
    from repro_torch.data.traces import SyntheticSpec, synthetic_trace

    spec = SyntheticSpec(n_objects=N_DEPLOY, n_requests=n_requests,
                         zipf_alpha=0.9, rate=2000.0, latency_base=0.005,
                         latency_per_mb=2e-4, stochastic=True)
    tr = synthetic_trace(torch.Generator().manual_seed(7), spec)
    touched = torch.unique(tr.objs.long())
    capacity = float(0.1 * tr.sizes[touched].sum())
    state_mb = (len(F32_FIELDS) * 4 + 2) * N_DEPLOY / 1e6
    log(f"phase 3: {N_DEPLOY} objects ({state_mb:.1f} MB of state a lane), "
        f"{n_requests} requests, {touched.numel()} objects touched, "
        f"capacity {capacity:.1f} MB")
    params = PolicyParams(omega=1.0, resid="recency")

    def sim(use_kernel, evict_top=None):
        return lambda c: simulate(tr, capacity, "stoch_vacdh", params,
                                  estimate_z=True, use_kernel=use_kernel,
                                  evict_top=evict_top, counters=c)

    kern, _, lc = drive("phase 3: simulate(kernels)", sim(True),
                        EQ16_RUN)
    add_launches(launches, lc)
    plain, _, _ = drive("phase 3: simulate(plain versions)", sim("ref"))
    if not same_result(kern, plain):
        raise AssertionError(f"kernel path {kern} != plain path {plain}")
    log(f"phase 3: kernel == plain: latency {float(kern.total_latency)}, "
        f"hits {int(kern.n_hits)}, delayed {int(kern.n_delayed)}, misses "
        f"{int(kern.n_misses)}, evictions {int(kern.n_evictions)}")
    top0, _, lc = drive("phase 3: simulate(kernels, evict_top=0)",
                        sim(True, 0), ARGMIN_RUN)
    add_launches(launches, lc)
    if not same_result(kern, top0):
        raise AssertionError(f"evict_top=0 {top0} != evict_top=8 {kern}")
    log("phase 3: evict_top=0 == evict_top=8, every counter and the "
        "latency bit")

    impr, _, lc = drive(
        "phase 3: latency_improvement(kernels)",
        lambda c: latency_improvement(tr, capacity, "stoch_vacdh", "lru",
                                      params, estimate_z=True,
                                      use_kernel=True, counters=c),
        EQ16_RUN)
    add_launches(launches, lc)
    if not torch.isfinite(impr):
        raise AssertionError(f"improvement {impr} is not finite")
    log(f"phase 3: improvement over LRU {float(impr) * 100:.3f}%")


# --- phases 4-5: the LM serve path --------------------------------------------
SERVE_ARCH = "stablelm-1.6b"
HYMBA_NEW = 8                 # phase 8's new tokens a request, cut from 32
SERVE_NEW = 16                # phases 5 and 15's, cut from 32


def bf16_ulp_excess(got, want):
    """Largest ``(|got - want| - 1e-5) / ulp`` over the elements, with
    ``ulp`` one bf16 ulp at the larger of the two magnitudes (<= 1
    passes).  Kernel and plain version round f32 results that differ by
    at most the f32 tolerance (1e-5) once to bf16, so they differ by at
    most one bf16 ulp plus that: near zero, where a bf16 ulp is finer than
    the f32 difference, the 1e-5 term is what remains."""
    import torch
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    _, e = torch.frexp(mag)                 # mag = m * 2^e, m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(mag), e - 8)
    return float((((g - w).abs() - 1e-5) / ulp).max())


def phase_attention() -> dict:
    """Both attention kernels against their plain versions over the sweep;
    timings at StableLM-2-1.6B's and Hymba-1.5B's shapes."""
    import torch
    from repro_torch.figures import bench_kernels
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_splits, q_tile)
    from repro_torch.kernels.flash_attention import flash_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(4)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}

    def rnd(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    def ipos(a):
        return torch.as_tensor(a, dtype=torch.int32, device="cuda")

    worst = {}                    # (kernel, dtype) -> (abs err, ulp excess)

    def check(name, dt, got, want, what):
        err = float((got.float() - want.float()).abs().max())
        ulps = bf16_ulp_excess(got, want) if dt == "bf16" else 0.0
        ok = err <= 1e-5 if dt == "f32" else ulps <= 1.0
        if not (ok and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{name} != plain ({dt}, {what}): max "
                                 f"|diff| {err}, {ulps} bf16 ulp")
        e0, u0 = worst.get((name, dt), (0.0, 0.0))
        worst[(name, dt)] = (max(e0, err), max(u0, ulps))

    cases = 0
    for dt, tdt in dts.items():
        for dh in (16, 32, 64, 128):
            for h, kv in ((4, 4), (8, 2), (12, 1), (24, 1), (56, 8)):
                for b, sq, sk in ((2, 100, 100), (1, 130, 300)):
                    q, k, v = (rnd((b, sq, h, dh), tdt),
                               rnd((b, sk, kv, dh), tdt),
                               rnd((b, sk, kv, dh), tdt))
                    qp, kp = ipos(range(sk - sq, sk)), ipos(range(sk))
                    for w, cap, sink in ((0, 0.0, 0), (32, 0.0, 8),
                                         (32, 30.0, 0), (0, 30.0, 0)):
                        kw = dict(window=w, softcap=cap, sink=sink)
                        check("flash_attention", dt,
                              flash_attention(q, k, v, qp, kp, **kw),
                              ref.flash_attention_ref(q, k, v, qp, kp, **kw),
                              f"dh={dh} H={h} KV={kv} B={b} Sq={sq} "
                              f"Sk={sk} {kw}")
                        cases += 1
                # decode: a wrapped ring buffer (positions out of order,
                # the last 30 slots empty) of 300 slots
                sc = 300
                kpos = [(i * 7) % (sc - 30) + 40 if i < sc - 30 else -1
                        for i in range(sc)]
                q, k, v = (rnd((3, 1, h, dh), tdt), rnd((3, sc, kv, dh), tdt),
                           rnd((3, sc, kv, dh), tdt))
                qp, kp = ipos([sc + 9]), ipos(kpos)
                for w, cap, sink in ((0, 0.0, 0), (64, 0.0, 4),
                                     (64, 30.0, 0), (0, 30.0, 0)):
                    kw = dict(window=w, softcap=cap, sink=sink)
                    check("decode_attention", dt,
                          decode_attention(q, k, v, qp, kp, **kw),
                          ref.decode_attention_ref(q, k, v, qp, kp, **kw),
                          f"dh={dh} H={h} KV={kv} ring {sc} {kw}")
                    cases += 1
        # the 4096 window (StarCoder2's), with and without a sink, past
        # its length: prefill and decode
        for dh in (64, 128):
            b, s, h, kv = 1, 4300, 8, 2
            q, k, v = (rnd((b, s, h, dh), tdt), rnd((b, s, kv, dh), tdt),
                       rnd((b, s, kv, dh), tdt))
            pos = ipos(range(s))
            for sink in (0, 16):
                kw = dict(window=4096, softcap=0.0, sink=sink)
                check("flash_attention", dt,
                      flash_attention(q, k, v, pos, pos, **kw),
                      ref.flash_attention_ref(q, k, v, pos, pos, **kw),
                      f"dh={dh} S={s} {kw}")
                check("decode_attention", dt,
                      decode_attention(q[:, -1:], k, v, pos[-1:], pos, **kw),
                      ref.decode_attention_ref(q[:, -1:], k, v, pos[-1:],
                                               pos, **kw),
                      f"dh={dh} Sc={s} {kw}")
                cases += 2
    # edges of the two designs: Sq ragged against the 16-row mma tile;
    # caches of 1, 63, 65 and 129 slots against the 64-slot split
    # granularity (65: a last split of one slot), 4300 slots at batch 3
    # (dozens of splits), the last splits empty, and no visible slot
    for dt, tdt in dts.items():
        for dh in (16, 32, 64, 128):
            h, kv = 8, 2
            for sq, sk in ((17, 17), (31, 95), (33, 200)):
                q, k, v = (rnd((2, sq, h, dh), tdt), rnd((2, sk, kv, dh), tdt),
                           rnd((2, sk, kv, dh), tdt))
                qp, kp = ipos(range(sk - sq, sk)), ipos(range(sk))
                check("flash_attention", dt,
                      flash_attention(q, k, v, qp, kp, window=16, sink=2),
                      ref.flash_attention_ref(q, k, v, qp, kp, window=16,
                                              sink=2),
                      f"dh={dh} Sq={sq} Sk={sk} window 16, sink 2")
                cases += 1
            for b, sc in ((2, 1), (2, 63), (2, 65), (1, 129), (3, 4300)):
                q, k, v = (rnd((b, 1, h, dh), tdt), rnd((b, sc, kv, dh), tdt),
                           rnd((b, sc, kv, dh), tdt))
                tail = ipos([i if i < sc - sc // 3 else -1 for i in range(sc)])
                for qp, kp, what in ((ipos([sc - 1]), ipos(range(sc)), "full"),
                                     (ipos([sc]), tail, "last third empty"),
                                     (ipos([0]), ipos([i + 1 for i in
                                                       range(sc)]),
                                      "no visible slot")):
                    check("decode_attention", dt,
                          decode_attention(q, k, v, qp, kp),
                          ref.decode_attention_ref(q, k, v, qp, kp),
                          f"dh={dh} B={b} Sc={sc} {what}")
                    cases += 1
    # Hymba-1.5B's shapes (25 q heads and 5 KV heads of 64, window 1024
    # with a 128-token sink): prefill over 128 meta + 2048 prompt tokens,
    # and decode over a wrapped 1152-slot ring (sink slots in place, ring
    # slots holding positions out of order) with empty slots
    h, kv, dh, meta, win = 25, 5, 64, 128, 1024
    s = meta + 2048
    ring = meta + win
    kpos = [i if i < meta else meta + (s - meta - win)
            + ((i - meta) + 300) % win for i in range(ring)]
    for i in range(meta + 7, ring, 97):
        kpos[i] = -1                       # slots not written yet
    for dt, tdt in dts.items():
        q, k, v = (rnd((1, s, h, dh), tdt), rnd((1, s, kv, dh), tdt),
                   rnd((1, s, kv, dh), tdt))
        pos = ipos(range(s))
        kw = dict(window=win, softcap=0.0, sink=meta)
        check("flash_attention", dt, flash_attention(q, k, v, pos, pos, **kw),
              ref.flash_attention_ref(q, k, v, pos, pos, **kw),
              f"Hymba prefill S={s} H={h} KV={kv} {kw}")
        qd, kc, vc = (rnd((1, 1, h, dh), tdt), rnd((1, ring, kv, dh), tdt),
                      rnd((1, ring, kv, dh), tdt))
        qpd, kp = ipos([s]), ipos(kpos)
        check("decode_attention", dt,
              decode_attention(qd, kc, vc, qpd, kp, **kw),
              ref.decode_attention_ref(qd, kc, vc, qpd, kp, **kw),
              f"Hymba decode ring {ring} H={h} KV={kv} {kw}")
        cases += 2
    # the bf16 decode shapes, for the split log below
    hy_dec = (qd, kc)
    # StableLM-2-1.6B's shapes on the main path (bf16, B=1, 32 MHA heads of
    # 64): causal prefill at S=2048, and decode over a full cache of 2048
    # (4 caches, 67 MB, taken in turn when timed below, so each call finds
    # its cache out of the 50 MB L2, as a layer of the model does)
    b, s, h, dh = 1, 2048, 32, 64
    q, k, v = (rnd((b, s, h, dh), torch.bfloat16) for _ in range(3))
    pos = ipos(range(s))
    caches = [(rnd((b, s, h, dh), torch.bfloat16),
               rnd((b, s, h, dh), torch.bfloat16)) for _ in range(4)]
    qd = rnd((b, 1, h, dh), torch.bfloat16)
    qpd = ipos([s - 1])
    check("flash_attention", "bf16", flash_attention(q, k, v, pos, pos),
          ref.flash_attention_ref(q, k, v, pos, pos),
          f"StableLM prefill S={s} H={h} dh={dh}")
    check("decode_attention", "bf16",
          decode_attention(qd, *caches[0], qpd, pos),
          ref.decode_attention_ref(qd, *caches[0], qpd, pos),
          f"StableLM decode Sc={s} H={h} dh={dh}")
    # as the served cache is: sized prompt + max_new + 1, its tail empty
    kpart = torch.where(pos < s - 33, pos, -1)
    check("decode_attention", "bf16",
          decode_attention(qd, *caches[1], qpd - 33, kpart),
          ref.decode_attention_ref(qd, *caches[1], qpd - 33, kpart),
          f"StableLM decode Sc={s} H={h} dh={dh}, last 33 slots empty")
    cases += 3
    torch.cuda.synchronize()
    for (name, dt), (err, ulps) in sorted(worst.items()):
        log(f"phase 4: {name} {dt}: max |diff| {err:.3e}"
            + (f" ({ulps:.2f} bf16 ulp)" if dt == "bf16" else ""))
    log(f"phase 4: attention kernels == plain within tolerance over "
        f"{cases} cases (f32 <= 1e-5; bf16 <= 1 ulp + 1e-5)")

    # --- timings at StableLM-2-1.6B's and Hymba-1.5B's shapes (bench_kernels)
    rows = bench_kernels.time_attention(torch.device("cuda"))
    for r in rows:
        log(f"phase 4: {r['name']} at {r['shape']} (bf16): {r['us']:.2f} "
            f"us, plain {r['plain_us']:.2f} us, bound {r['bound_us']:.2f} us "
            f"({r['bound_by']}: {r['bound_how']}), "
            f"scaled_dot_product_attention {r['library_us']:.2f} us")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for cell, (qq, kk) in (("StableLM", (qd, caches[0][0])),
                           ("Hymba", hy_dec)):
        group = qq.shape[2] // kk.shape[2]
        tiles = kk.shape[2] * -(-group // q_tile(group))
        n_split, split_len = decode_splits(kk.shape[1], tiles, sms)
        log(f"phase 4: decode_attention at {cell}'s shape: {n_split} "
            f"splits of {split_len} slots, {tiles * n_split} blocks on "
            f"{sms} SMs")
    return {r["name"]: kernel_entry(r, max(worst[(r["name"], d)][0]
                                           for d in dts))
            for r in rows if r["shape"].startswith("StableLM:")}


def to_f32(t):
    """A parameter tree (dicts and lists of tensors) in f32."""
    if isinstance(t, dict):
        return {k: to_f32(v) for k, v in t.items()}
    return [to_f32(v) for v in t] if isinstance(t, list) else t.float()


def run_request(cfg, params, prompt, steps: int, feed=None):
    """Prefill ``prompt``, then ``steps`` decode steps at
    ``pos0 = meta + S + j`` (forward's contract), fed greedily or with the
    tokens ``feed``; returns (last logits of every step ``[steps+1, V]``,
    the fed tokens, prefill seconds, decode seconds), each phase ending in a
    device sync."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.training.train_loop import make_serve_steps
    prefill, decode = make_serve_steps(cfg)
    toks = torch.as_tensor(prompt[None, :], device="cuda")
    s = cfg.meta_tokens + toks.shape[1]
    cache = tf.init_cache(cfg, 1, s + steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, {"tokens": toks})
    outs = [logits[0, -1]]
    fed = [int(torch.argmax(logits[0, -1]))] if feed is None else feed
    t1 = time.perf_counter()
    for j in range(steps):
        tok = torch.tensor([[fed[j]]], device="cuda")
        logits, cache = decode(params, cache, tokens=tok, pos0=s + j)
        outs.append(logits[0, -1])
        if feed is None:
            fed.append(int(torch.argmax(logits[0, -1])))
    torch.cuda.synchronize()
    return torch.stack(outs), fed, t1 - t0, time.perf_counter() - t1


def check_f32(phase: int, cfg, params, prompts, steps: int = 16) -> None:
    """f32 at full width: prefill and ``steps`` teacher-forced decode
    logits of the kernel path within 1e-3 of max |logit| of the plain
    path."""
    import dataclasses
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = to_f32(params)
    worst = 0.0
    for i, prompt in enumerate(prompts):
        want, feed, _, _ = run_request(
            dataclasses.replace(cfg32, use_kernel="ref"), p32, prompt, steps)
        got, _, _, _ = run_request(
            dataclasses.replace(cfg32, use_kernel=True), p32, prompt, steps,
            feed)
        rel = float((got - want).abs().max() / want.abs().max())
        worst = max(worst, rel)
        log(f"phase {phase}: f32 prompt {i} ({len(prompt)} tokens): prefill "
            f"+ {steps} teacher-forced decode logits, kernels vs plain: max "
            f"|diff| / max |logit| = {rel:.3e}")
        if not rel <= 1e-3 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"f32 logits of the kernel path differ from "
                                 f"the plain path by {rel} of max |logit|")
    log(f"phase {phase}: f32 full-width check passed (max {worst:.3e} <= "
        f"1e-3 of max |logit|)")


def build_model(phase: int, arch: str, n_layers: int | None = None):
    import torch
    from repro_torch.launch.serve import build
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    cfg, params = build(arch, n_layers=n_layers)
    torch.cuda.synchronize()
    n = tf.n_params(params)
    log(f"phase {phase}: {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"family {cfg.family}, vocab {cfg.vocab}, {n / 1e9:.3f} B parameters "
        f"(cfg.n_params() {cfg.n_params() / 1e9:.3f} B), initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    if n != cfg.n_params():
        raise AssertionError(f"{n} parameters, the config says "
                             f"{cfg.n_params()}")
    return cfg, params


def lm_kernels(cfg, kind: str) -> tuple:
    """The LM kernels a ``kind`` ("train", "prefill" or "decode") forward
    of ``cfg`` launches once a layer: the attention kernels outside the
    ``ssm`` family, ``gla_chunk`` for its chunked prompts (``ssm`` and
    ``hybrid``; a decode step's recurrence is plain PyTorch)."""
    out = []
    if cfg.family != "ssm":
        out.append("decode_attention" if kind == "decode"
                   else "flash_attention")
    if cfg.family in ("ssm", "hybrid") and kind != "decode":
        out.append("gla_chunk")
    return tuple(out)


def check_launches(label: str, lc: dict, want: dict) -> None:
    """Each kernel of ``want`` launched exactly that often, no other."""
    bad = {k: v for k, v in lc.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{label} launched {bad}, not {want}")


def phase_serve(phase: int, arch: str, launches: dict,
                n_layers: int | None = None, f32_check: bool = True,
                max_new: int = 32):
    """``arch`` at full width (cut to ``n_layers`` if given) behind the
    continuous batcher (max_batch 4, 8 requests of 512-2048 prompt tokens,
    ``max_new`` new tokens each), through the kernels and through their
    plain versions; then the f32 logits check unless ``f32_check`` is
    false.
    The kernel run must launch each prefill kernel of the model
    (:func:`lm_kernels`) once a layer per prompt and each decode kernel
    once a layer per decoded token.
    Returns (cfg, params, prompts, the kernel run's ``serve`` result)."""
    import dataclasses
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import random_prompts, serve

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = build_model(phase, arch, n_layers)
    prompts = random_prompts(cfg, 8, 512, 2049)
    log(f"phase {phase}: 8 requests, prompt lengths "
        f"{[len(p) for p in prompts]}, {max_new} new tokens each, "
        f"max_batch 4")
    want = {k: cfg.n_layers * len(prompts)
            for k in lm_kernels(cfg, "prefill")}
    want.update({k: cfg.n_layers * len(prompts) * (max_new - 1)
                 for k in lm_kernels(cfg, "decode")})
    # untimed warm-up of both paths on the same prompts (2 new tokens), so
    # neither timed run pays first-use costs (library heuristics, memory)
    for mode in (True, "ref"):
        serve(dataclasses.replace(cfg, use_kernel=mode), params, prompts, 2)
    runs = {}
    for mode in (True, "ref"):
        c = dataclasses.replace(cfg, use_kernel=mode)
        reset_launch_counts()
        torch.cuda.synchronize()
        r = serve(c, params, prompts, max_new)
        lc = launch_counts()
        runs[mode] = r
        log(f"phase {phase}: serve(use_kernel={mode!r}): {r['done']} "
            f"requests, prefill {r['prefill_tokens']} tokens in "
            f"{r['prefill_s']:.3f} s "
            f"({r['prefill_tokens'] / r['prefill_s']:.1f} tok/s), decode "
            f"{r['decode_tokens']} tokens in {r['decode_s']:.3f} s "
            f"({r['decode_tokens'] / r['decode_s']:.1f} tok/s), wall "
            f"{r['wall_s']:.2f} s; launches "
            f"{ {k: lc[k] for k in want} }")
        if r["done"] != 8 or any(len(q.out) != max_new
                                 for q in r["requests"]):
            raise AssertionError(f"use_kernel={mode!r}: not every request "
                                 f"completed {max_new} tokens")
        if mode is True:
            for k, n in want.items():
                if lc[k] != n:
                    raise AssertionError(f"the serve path launched {k} "
                                         f"{lc[k]} times, not {n}")
            add_launches(launches, lc)
        elif any(lc.values()):
            raise AssertionError(f"the plain serve run launched {lc}")
    same = sum(a == b for qa, qb in zip(runs[True]["requests"],
                                        runs["ref"]["requests"])
               for a, b in zip(qa.out, qb.out))
    log(f"phase {phase}: greedy tokens equal to the plain run's: {same} of "
        f"{8 * max_new} ({same / (8 * max_new):.4f})")
    if f32_check:
        check_f32(phase, cfg, params, prompts[:2])
    return cfg, params, prompts, runs[True]


# --- phase 6: the gla_chunk kernel ---------------------------------------------
def within(got, want, bf16: bool) -> float:
    """Largest ``|got - want| / (atol + rtol |want| [+ 1 bf16 ulp])`` with
    JAX's kernel-vs-chunkwise bound ``atol 1e-4, rtol 1e-3``
    (tests/test_kernels.py); <= 1 passes."""
    import torch
    g, w = got.float(), want.float()
    lim = 1e-4 + 1e-3 * w.abs()
    if bf16:
        mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
        _, e = torch.frexp(mag)
        lim = lim + torch.ldexp(torch.ones_like(mag), e - 8)
    return float(((g - w).abs() / lim).max())


def phase_gla() -> dict:
    """gla_chunk against its plain version on the card over the sweep, and
    its bf16 route's distance to ``ref.gla_chunk_split`` (the emulation of
    its rounding); timings at xLSTM-350M's and Hymba-1.5B's prefill
    shapes."""
    import torch
    from repro_torch.figures import bench_kernels
    from repro_torch.kernels import gla_chunk as gla_mod
    from repro_torch.kernels import ref
    gla_chunk = gla_mod.gla_chunk
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(6)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    worst = {"err": 0.0, "f32": 0.0, "bf16": 0.0, "split": 0.0}

    def check(args, st, chunk, normalize, dt, what):
        y, (S, n) = gla_chunk(*args, chunk=chunk, normalize=normalize,
                              init_state=st)
        ry, (rS, rn) = ref.gla_chunk_plain(*args, chunk=chunk,
                                           normalize=normalize,
                                           init_state=st)
        r = max(within(y, ry, dt == "bf16"), within(S, rS, False),
                within(n, rn, False))
        finite = all(bool(torch.isfinite(t).all()) for t in (y, S, n))
        if not (r <= 1.0 and finite):
            raise AssertionError(f"gla_chunk != plain ({what}): {r} of the "
                                 f"bound, finite {finite}")
        worst[dt] = max(worst[dt], r)
        worst["err"] = max(worst["err"], *(float((a.float() - b).abs().max())
                                          for a, b in ((y, ry.float()),
                                                       (S, rS), (n, rn))))
        if dt == "bf16":
            ey, (eS, en) = ref.gla_chunk_split(*args, chunk=chunk,
                                               normalize=normalize,
                                               init_state=st)
            worst["split"] = max(worst["split"], within(y, ey, True),
                                 within(S, eS, False), within(n, en, False))

    cases = 0
    for dt, tdt in dts.items():
        for dk, dv in ((16, 128), (512, 512), (64, 64), (16, 32)):
            b, h = (1, 2) if dk == 512 else (2, 3)
            for chunk in (16, 64, 256):
                for n_chunks in (1, 3):
                    for normalize in (True, False):
                        for init in (False, True):
                            s = chunk * n_chunks
                            args, st = bench_kernels.gla_inputs(
                                g, b, s, h, dk, dv, tdt, init,
                                strided=cases % 2)
                            check(args, st, chunk, normalize, dt,
                                  f"{dt} dk={dk} dv={dv} B={b} H={h} S={s} "
                                  f"chunk={chunk} normalize={normalize} "
                                  f"init={init}")
                            cases += 1
    # the main path's shapes (xLSTM-350M's and Hymba-1.5B's prefill), bf16
    for name, (b, s, h, dk, dv, normalize) in \
            bench_kernels.GLA_SHAPES.items():
        args, _ = bench_kernels.gla_inputs(g, b, s, h, dk, dv,
                                             torch.bfloat16, False)
        check(args, None, 256, normalize, "bf16", f"{name} prefill shape")
        cases += 1
    torch.cuda.synchronize()
    log(f"phase 6: gla_chunk == plain within tolerance over {cases} cases "
        f"(f32: atol 1e-4 + rtol 1e-3, worst {worst['f32']:.3f} of it; "
        f"bf16 y: + 1 ulp, worst {worst['bf16']:.3f}); max |diff| "
        f"{worst['err']:.3e}; the bf16 route against ref.gla_chunk_split "
        f"(its rounding), worst {worst['split']:.3f} of the same bound")

    out = {}
    for r, name in zip(bench_kernels.time_gla(torch.device("cuda")),
                       bench_kernels.GLA_SHAPES):
        log(f"phase 6: gla_chunk at {r['shape']} (bf16): {r['us']:.2f} us, "
            f"plain {r['plain_us']:.2f} us, bound {r['bound_us']:.2f} us "
            f"({r['bound_by']}: {r['bound_how']})")
        out[name] = kernel_entry(r, worst["err"])
    return out


# --- phases 9-10: the sweep grid and the streaming replay --------------------
def grid_arrays(g) -> dict:
    """A SweepGrid's result fields as host numpy arrays."""
    import dataclasses
    return {f.name: getattr(g.result, f.name).cpu().numpy()
            for f in dataclasses.fields(g.result)}


def same_grid(a, b) -> bool:
    """Every field of two SweepGrids' results (or their ``grid_arrays``),
    bit for bit."""
    import torch
    fa, fb = (x if isinstance(x, dict) else grid_arrays(x) for x in (a, b))
    return fa.keys() == fb.keys() and all(
        bitwise_equal(torch.from_numpy(fa[k]), torch.from_numpy(fb[k]))
        for k in fa)


def fig2_plain(conn) -> None:
    """9(a)'s run through the plain versions, in a process of its own:
    sends back ("ok", its grids' ``grid_arrays``) or ("error", the
    traceback that stopped it)."""
    try:
        from repro_torch.figures import fig2_synthetic
        grids = []
        drive("phase 9a: fig2_synthetic.run(use_kernel='ref')",
              lambda c: fig2_synthetic.run(use_kernel="ref", counters=c,
                                           n_requests=FIG2_GRID_REQUESTS,
                                           grids=grids))
        conn.send(("ok", [grid_arrays(g) for g in grids]))
    except BaseException:
        import traceback
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def phase_grid_fig2(launches: dict, grids_out: dict) -> None:
    """9(a): fig2 at the driver's default size through the figure driver,
    the kernels' grids against the plain versions' bit for bit.  The two
    runs go side by side, the plain one in a second process (both are
    host-bound), so 9(a)'s rates are read with the host shared."""
    import multiprocessing
    from repro_torch.figures import fig2_synthetic
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    child = ctx.Process(target=fig2_plain, args=(send,))
    child.start()
    send.close()
    try:
        kern = []
        rows, _, lc = drive(
            "phase 9a: fig2_synthetic.run(use_kernel=True)",
            lambda c: fig2_synthetic.run(use_kernel=True, counters=c,
                                         n_requests=FIG2_GRID_REQUESTS,
                                         grids=kern),
            EQ16_RUN)
        add_launches(launches, lc)
        status, plain = recv.recv()
    finally:
        child.join(timeout=60)
        if child.is_alive():
            child.terminate()
            child.join()
    if status != "ok":
        raise AssertionError(f"phase 9a's plain run failed:\n{plain}")
    if len(kern) != 4 or len(plain) != 4:
        raise AssertionError(f"fig2 ran {len(kern)} / {len(plain)} grids, "
                             f"not 4")
    for a, b in zip(kern, plain):
        if not same_grid(a, b):
            raise AssertionError(f"fig2 grid {a.policies}: kernels "
                                 f"{grid_arrays(a)} != plain {b}")
    log(f"phase 9a: {len(plain)} grids (2 arrivals x recency roster / "
        f"rate trio), kernels == plain bitwise in every lane")
    for r in rows:
        log(f"phase 9a: {r['arrival']:7s} resid={r['resid']:7s} "
            f"{r['policy']:12s} improvement over LRU "
            f"{r['improvement_vs_lru'] * 100:8.3f}%  hit ratio "
            f"{r['hit_ratio']}")
    ours = [r for r in rows if r["policy"] == "stoch_vacdh"
            and r["arrival"] == "poisson" and r["resid"] == "recency"]
    impr = ours[0]["improvement_vs_lru"]
    if not 0.03 <= impr <= 0.30:
        raise AssertionError(f"fig2 grid improvement {impr} outside 3-30%")
    grids_out["fig2_rate_poisson"] = kern[1]


def phase_grid_deploy(n_requests: int, launches: dict) -> None:
    """9(b): lru / vacdh / stoch_vacdh x omega {0.5, 1, 2} x capacity
    {5%, 10%} over the dense 2^20-object universe: 18 lanes."""
    import torch
    from repro_torch.core import PolicyParams, simulate, sweep_grid
    from repro_torch.core.state import F32_FIELDS
    from repro_torch.data.traces import SyntheticSpec, synthetic_trace

    spec = SyntheticSpec(n_objects=N_DEPLOY, n_requests=n_requests,
                         zipf_alpha=0.9, rate=2000.0, latency_base=0.005,
                         latency_per_mb=2e-4, stochastic=True)
    tr = synthetic_trace(torch.Generator().manual_seed(7), spec)
    touched = torch.unique(tr.objs.long())
    foot = float(tr.sizes[touched].sum())
    caps = [0.05 * foot, 0.10 * foot]
    omegas = (0.5, 1.0, 2.0)
    params = [PolicyParams(omega=o, resid="recency") for o in omegas]
    policies = ["lru", "vacdh", "stoch_vacdh"]
    n_lanes = len(policies) * len(params) * len(caps)
    state_mb = (len(F32_FIELDS) * 4 + 2) * N_DEPLOY * n_lanes / 1e6
    log(f"phase 9b: {n_lanes} lanes ({policies} x omega {omegas} x "
        f"capacity 5%/10% of {foot:.1f} MB) over {N_DEPLOY} objects, "
        f"{state_mb:.1f} MB of state; {n_requests} requests (cut for the "
        f"host-bound replay rate)")

    def grid(mode):
        return lambda c: sweep_grid(tr, caps, policies, params,
                                    estimate_z=True, use_kernel=mode,
                                    counters=c)

    t0 = time.perf_counter()
    kern, kc, lc = drive("phase 9b: sweep_grid(kernels)", grid(True),
                         EQ16_RUN)
    grid_s = time.perf_counter() - t0
    add_launches(launches, lc)
    plain, pc, _ = drive("phase 9b: sweep_grid(plain versions)", grid("ref"))
    if not same_grid(kern, plain):
        raise AssertionError("18-lane grid: kernels != plain versions")
    log("phase 9b: kernel grid == plain grid bitwise in all 18 lanes")
    walls = []
    for pol, pi, ci in (("stoch_vacdh", 1, 1), ("vacdh", 0, 0),
                        ("lru", 2, 1)):
        t0 = time.perf_counter()
        one, _, lc = drive(
            f"phase 9b: simulate({pol}, omega {omegas[pi]}, capacity "
            f"{caps[ci]:.1f})",
            lambda c, pol=pol, pi=pi, ci=ci: simulate(
                tr, caps[ci], pol, params[pi], estimate_z=True,
                use_kernel=True, counters=c),
            REPLAY_RUN)
        add_launches(launches, lc)
        walls.append(time.perf_counter() - t0)
        if not same_result(one, kern.point(0, policies.index(pol), pi, ci,
                                           0)):
            raise AssertionError(f"grid lane {pol} != single-lane simulate")
    one_lane = statistics.mean(walls) * n_lanes
    log(f"phase 9b: grid lanes == single-lane simulate bitwise (stoch_vacdh, "
        f"vacdh, lru); grid {grid_s:.2f} s for {n_lanes} lanes "
        f"({kc['lane_requests'] / grid_s:.1f} lane-requests/s, "
        f"{kc['syncs'] / kc['lane_requests']:.4f} syncs/lane-request, "
        f"{kc['scoring_commits']} scoring commits) against "
        f"{one_lane:.2f} s as {n_lanes} one-lane runs (extrapolated from "
        f"the three single-lane runs' mean, {statistics.mean(walls):.2f} s: "
        f"{n_requests / statistics.mean(walls):.1f} lane-requests/s)")


def phase_stream(launches: dict, grids: dict) -> None:
    """10: the epoch-time stream, rebased, kernels against plain; chunked
    replays against whole ones."""
    import numpy as np
    import torch
    from repro_torch.core import (PolicyParams, simulate, simulate_chunked,
                                  simulate_stream, sweep_grid)
    from repro_torch.data.traces import (RealWorldSpec, SyntheticSpec,
                                         compact_requests, realworld_raw,
                                         synthetic_trace)

    raw = realworld_raw(RealWorldSpec(n_requests=STREAM_REQUESTS,
                                      n_keys=N_KEYS, seed=0))
    stream, stats = compact_requests(raw, top_k=4096, n_recycle=512)
    cap = 0.1 * float(stream.sizes.sum())
    log(f"phase 10: stream of {stream.n_requests} requests (cut from "
        f"fig_realworld's 1,000,000 for time) from t = "
        f"{stream.times[0]:.1f} s, "
        f"{stats.n_unique} keys -> {stats.n_objects} objects (tail mass "
        f"{stats.tail_mass:.3f}), capacity {cap:.1f} MB, chunks of 4096")
    params = PolicyParams(omega=1.0)
    runs = {}
    for mode, needs in ((True, EQ16_RUN),
                        ("ref", ())):
        runs[mode] = drive(
            f"phase 10: simulate_stream(use_kernel={mode!r}, rebase=True)",
            lambda c, mode=mode: simulate_stream(
                stream, cap, "stoch_vacdh", params, estimate_z=True,
                use_kernel=mode, chunk_size=4096, rebase=True, counters=c),
            needs)
        if mode is True:
            add_launches(launches, runs[mode][2])
    if not same_result(runs[True][0], runs["ref"][0]):
        raise AssertionError(f"stream: kernels {runs[True][0]} != plain "
                             f"{runs['ref'][0]}")
    r = runs[True][0]
    if int(r.n_hits + r.n_delayed + r.n_misses) != stream.n_requests or \
            not bool(
            torch.isfinite(r.total_latency)):
        raise AssertionError(f"stream result {r}")
    log(f"phase 10: stream kernels == plain bitwise: latency "
        f"{float(r.total_latency)}, hit ratio {float(r.hit_ratio):.4f}")

    spec = SyntheticSpec(n_objects=100, n_requests=FIG2_GRID_REQUESTS,
                         zipf_alpha=0.9, rate=2000.0, latency_base=0.005,
                         latency_per_mb=2e-4, stochastic=True)
    tr = synthetic_trace(torch.Generator().manual_seed(0), spec)
    p2 = PolicyParams(omega=1.0, resid="recency")
    whole, _, lc = drive("phase 10: fig2 simulate(kernels)", lambda c:
                         simulate(tr, 500.0, "stoch_vacdh", p2,
                                  estimate_z=True, counters=c),
                         EQ16_RUN)
    add_launches(launches, lc)
    chunked, _, lc = drive("phase 10: fig2 simulate_chunked(4096)", lambda c:
                           simulate_chunked(tr, 500.0, "stoch_vacdh", p2,
                                            estimate_z=True, chunk_size=4096,
                                            counters=c),
                           EQ16_RUN)
    add_launches(launches, lc)
    if not same_result(whole, chunked):
        raise AssertionError(f"simulate_chunked {chunked} != {whole}")
    g0 = grids["fig2_rate_poisson"]
    g1, _, lc = drive(
        "phase 10: fig2 rate grid, sweep_grid(chunk_size=4096)",
        lambda c: sweep_grid(tr, 500.0, list(g0.policies), list(g0.params),
                             estimate_z=True, chunk_size=4096, counters=c),
        EQ16_RUN)
    add_launches(launches, lc)
    if not same_grid(g0, g1):
        raise AssertionError("chunked grid != unchunked grid")
    log(f"phase 10: simulate_chunked == simulate and the chunked "
        f"{np.prod(g0.result.total_latency.shape)}-lane grid == the "
        f"unchunked grid, bit for bit")



# --- phases 11-12: the slot table and the hierarchy --------------------------
def eviction_pick_launches(n: int) -> tuple[int, int, float, float]:
    """Device kernels of one eviction of the per-eviction loop at ``n``
    entries, with the slot table's id tie-break and with the dense
    position tie-break (``torch.profiler``), and their CUDA-event times
    in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.simulator import eviction_pick
    g = torch.Generator(device="cuda").manual_seed(11)
    ranks = torch.rand(n, generator=g, device="cuda")
    cached = torch.rand(n, generator=g, device="cuda") < 0.5
    ids = torch.randperm(n, generator=g, device="cuda").to(torch.int32)
    out = []
    for i in (ids, None):
        eviction_pick(cached, ranks, i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eviction_pick(cached, ranks, i)
            torch.cuda.synchronize()
        out.append(sum(1 for e in prof.events()
                       if e.device_type == DeviceType.CUDA))
    return (*out, time_ms(lambda: eviction_pick(cached, ranks, ids)),
            time_ms(lambda: eviction_pick(cached, ranks, None)))


def phase_slots(launches: dict) -> None:
    """11: phase 10's raw stream, every key its own id, replayed through a
    2^19-slot table (kernels against plain versions, slots against dense),
    then a prefix under two hash seeds and through a table of half its
    keys (reclaim)."""
    import numpy as np
    from repro_torch.core import PolicyParams, RequestStream, simulate_stream
    from repro_torch.core.state import slot_table_size
    from repro_torch.data.traces import (RealWorldSpec, exact_requests,
                                         realworld_raw)

    raw = realworld_raw(RealWorldSpec(n_requests=STREAM_REQUESTS,
                                      n_keys=N_KEYS, seed=0))
    stream, stats = exact_requests(raw)
    n_slots = slot_table_size(N_KEYS, load=0.75)
    cap = 0.1 * float(stream.sizes.sum())
    log(f"phase 11: {stream.n_requests} requests, {stats.n_unique} of "
        f"{N_KEYS} keys touched, each its own id; {n_slots} slots "
        f"(slot_table_size({N_KEYS}, load=0.75)), capacity {cap:.1f} MB, "
        f"chunks of 4096, rebased")
    params = PolicyParams(omega=1.0)

    def replay(st, mode, label, needs, **kw):
        out, counts, lc = drive(
            f"phase 11: {label}",
            lambda c: simulate_stream(st, cap, "stoch_vacdh", params,
                                      estimate_z=True, use_kernel=mode,
                                      chunk_size=4096, rebase=True,
                                      counters=c, **kw), needs)
        if mode is True:
            add_launches(launches, lc)
            per_req = lc["ranking_scores"] / counts["requests"]
            log(f"phase 11: {label}: {per_req:.4f} ranking_scores "
                f"launches/request, {counts.get('reclaims', 0)} reclaims")
        return out, counts

    kern, kc = replay(stream, True, "slots, kernels",
                      ARGMIN_RUN,
                      state_mode="slots", n_slots=n_slots)
    plain, _ = replay(stream, "ref", "slots, plain versions", (),
                      state_mode="slots", n_slots=n_slots)
    if not same_result(kern, plain):
        raise AssertionError(f"slots: kernels {kern} != plain {plain}")
    dense, _ = replay(stream, True, "dense, evict_top=0, kernels",
                      ARGMIN_RUN, evict_top=0)
    if not same_result(kern, dense):
        raise AssertionError(f"slots {kern} != dense {dense}")
    n = int(kern.n_hits + kern.n_delayed + kern.n_misses)
    if n != stream.n_requests or kc["reclaims"]:
        raise AssertionError(f"slots: {n} requests, {kc['reclaims']} "
                             f"reclaims")
    log(f"phase 11: slots == plain == dense bitwise: latency "
        f"{float(kern.total_latency)}, hit ratio {float(kern.hit_ratio):.4f}"
        f", evictions {int(kern.n_evictions)}")

    k = SLOT_PREFIX
    pre = RequestStream(stream.times[:k], stream.objs[:k], stream.sizes,
                        stream.z_mean, stream.z_draw[:k])
    n_pre = int(np.unique(pre.objs).size)
    seeds = [replay(pre, True, f"prefix, slot_seed {sd}",
                    ARGMIN_RUN, state_mode="slots",
                    slot_seed=sd)[0] for sd in (0, 1)]
    if not same_result(*seeds):
        raise AssertionError(f"slot seeds differ: {seeds}")
    small = dict(state_mode="slots", n_slots=n_pre // 2)
    rk, rc = replay(pre, True, f"prefix, {n_pre // 2} slots, kernels",
                    ARGMIN_RUN, **small)
    rp, _ = replay(pre, "ref", f"prefix, {n_pre // 2} slots, plain "
                   f"versions", (), **small)
    if not same_result(rk, rp):
        raise AssertionError(f"reclaim: kernels {rk} != plain {rp}")
    if rc["reclaims"] <= 0 or int(rk.n_hits + rk.n_delayed
                                  + rk.n_misses) != k:
        raise AssertionError(f"reclaim run: {rk}, {rc}")
    log(f"phase 11: {k}-request prefix ({n_pre} keys): slot seeds 0 and 1 "
        f"bitwise equal; {n_pre // 2} slots: {rc['reclaims']} reclaims, "
        f"kernels == plain bitwise, every request counted")
    tb, dn, tb_ms, dn_ms = eviction_pick_launches(n_slots)
    log(f"phase 11: one eviction's pick at {n_slots} slots: {tb} device "
        f"kernels with the id tie-break ({tb_ms * 1e3:.2f} us), {dn} with "
        f"the position tie-break ({dn_ms * 1e3:.2f} us)")


def hier_grid_arrays(g) -> dict:
    """A HierSweepGrid's result fields as host numpy arrays."""
    import dataclasses
    return {f"{tier}.{f.name}": getattr(getattr(g.result, tier),
                                        f.name).cpu().numpy()
            for tier in ("per_shard", "l2")
            for f in dataclasses.fields(g.result.l2)}


def fig6_plain(conn) -> None:
    """12(a)'s run through the plain versions, in a process of its own:
    sends back ("ok", its grids' ``hier_grid_arrays``) or ("error", the
    traceback)."""
    try:
        from repro_torch.figures import fig6_hierarchy
        grids = []
        drive("phase 12a: fig6_hierarchy.run(use_kernel='ref')",
              lambda c: fig6_hierarchy.run(use_kernel="ref", counters=c,
                                           n_requests=HIER_REQUESTS,
                                           grids=grids))
        conn.send(("ok", [hier_grid_arrays(g) for g in grids]))
    except BaseException:
        import traceback
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def phase_hier(launches: dict) -> None:
    """12: (a) fig6 over its default grid at ``HIER_REQUESTS``, kernel
    writes against plain writes (a second process, side by side) bit for
    bit; (b) a deployment-size hierarchy over the 2^20-object universe."""
    import multiprocessing
    import torch
    from repro_torch.core import (Exponential, PolicyParams,
                                  make_hier_trace, simulate_hier)
    from repro_torch.core.state import F32_FIELDS
    from repro_torch.data.traces import SyntheticSpec, synthetic_trace
    from repro_torch.figures import fig6_hierarchy

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    child = ctx.Process(target=fig6_plain, args=(send,))
    child.start()
    send.close()
    try:
        kern = []
        rows, _, lc = drive(
            "phase 12a: fig6_hierarchy.run(use_kernel=True)",
            lambda c: fig6_hierarchy.run(use_kernel=True, counters=c,
                                         n_requests=HIER_REQUESTS,
                                         grids=kern), REPLAY_RUN)
        add_launches(launches, lc)
        status, plain = recv.recv()
    finally:
        child.join(timeout=60)
        if child.is_alive():
            child.terminate()
            child.join()
    if status != "ok":
        raise AssertionError(f"phase 12a's plain run failed:\n{plain}")
    if len(kern) != 4 or len(plain) != 4:
        raise AssertionError(f"fig6 ran {len(kern)} / {len(plain)} grids")
    for a, b in zip(kern, plain):
        fa = hier_grid_arrays(a)
        if fa.keys() != b.keys() or not all(
                bitwise_equal(torch.from_numpy(fa[k]),
                              torch.from_numpy(b[k])) for k in fa):
            raise AssertionError(f"fig6 grid (S={a.n_shards}): kernel "
                                 f"writes != plain writes")
    log(f"phase 12a: 4 grids (routes hash/random x S 1/4; 4 hop laws x 3 "
        f"policies x L2 0/2000 each), {HIER_REQUESTS} requests: kernel "
        f"writes == plain writes bitwise in every point")
    for r in rows:
        if r["policy"] == "stoch_vacdh":
            log(f"phase 12a: route={r['route']:6s} S={r['n_shards']} "
                f"hop={r['hop_dist']:8s} (CV {r['hop_cv']}) L2="
                f"{r['l2_capacity']:6.0f}: eq.-16 improvement over LRU "
                f"{r['improvement_vs_lru'] * 100:8.3f}%, L1 hit ratio "
                f"{r['l1_hit_ratio']}, L2 hit ratio {r['l2_hit_ratio']}")
        if not torch.isfinite(torch.tensor(r["total_latency"])):
            raise AssertionError(f"fig6 row {r}")

    spec = SyntheticSpec(n_objects=N_DEPLOY, n_requests=HIER_REQUESTS,
                         zipf_alpha=0.9, rate=2000.0, latency_base=0.005,
                         latency_per_mb=2e-4, stochastic=True)
    tr = synthetic_trace(torch.Generator().manual_seed(7), spec)
    foot = float(tr.sizes[torch.unique(tr.objs.long())].sum())
    ht = make_hier_trace(tr, 4, generator=torch.Generator().manual_seed(7),
                         hop_mean=0.01, hop_dist=Exponential(), route="hash")
    c1, c2 = 0.05 * foot, 0.20 * foot
    state_mb = (len(F32_FIELDS) * 4 + 2) * N_DEPLOY * 5 / 1e6
    log(f"phase 12b: 4 hash-routed L1 shards (stoch_vacdh, {c1:.1f} MB "
        f"each = 5% of the touched {foot:.1f} MB) over an LRU L2 "
        f"({c2:.1f} MB), exponential hops of mean 0.01 s, {N_DEPLOY} "
        f"objects ({state_mb:.1f} MB of state), {HIER_REQUESTS} requests")
    params = PolicyParams(omega=1.0, resid="recency")
    runs = {}
    for mode, needs in ((True, REPLAY_RUN), ("ref", ())):
        runs[mode] = drive(
            f"phase 12b: simulate_hier(use_kernel={mode!r})",
            lambda c, mode=mode: simulate_hier(
                ht, 4, c1, c2, "stoch_vacdh", "lru", params=params,
                use_kernel=mode, counters=c), needs)
    add_launches(launches, runs[True][2])
    a, b = runs[True][0], runs["ref"][0]
    if not (same_result(a.l2, b.l2) and all(
            bitwise_equal(getattr(a.per_shard, f), getattr(b.per_shard, f))
            for f in ("total_latency", "n_hits", "n_delayed", "n_misses",
                      "n_evictions"))):
        raise AssertionError(f"12b: kernel writes {a} != plain {b}")
    l2_arr = int(a.l2.n_hits + a.l2.n_delayed + a.l2.n_misses)
    if int(a.n_requests) != HIER_REQUESTS or l2_arr != int(a.n_misses):
        raise AssertionError(f"12b counts: {a}")
    log(f"phase 12b: kernel writes == plain writes bitwise: latency "
        f"{float(a.total_latency)}, L1 hit ratio {float(a.hit_ratio):.4f}, "
        f"L2 arrivals {l2_arr} = L1 misses, L2 hits {int(a.l2.n_hits)}")


# --- phase 13: the serving engine --------------------------------------------
SERVE_REQUESTS = 2_500        # phase 13(b)'s flash crowd, cut from 20,000
SERVE_OBJECTS = 1 << 18       # phase 13(b)'s prefix table


def serve_cost_check(label: str, admits: int, ranks: int, rank_launches: int,
                     scatter_launches: int, eq16: bool) -> None:
    """The launch rules of a kernel run of the serving engine: at least one
    lane-scatter launch a rank (each rank flushes the mirror first), a
    rank an admission, and for eq.-16 caches at least one
    ``ranking_victim_order`` launch an admission."""
    if scatter_launches < ranks or ranks < admits:
        raise AssertionError(f"{label}: {scatter_launches} lane-scatter "
                             f"launches for {ranks} ranks, {admits} "
                             f"admissions")
    if eq16 and rank_launches < admits:
        raise AssertionError(f"{label}: {rank_launches} ranking launches "
                             f"for {admits} admissions")


def timed_run(fn):
    """(``fn()``, its seconds ending in a sync, its launches from zero)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, launch_counts()


def bench_serving_run(mode):
    """13(a)'s ``bench_serving.run(smoke=True)`` with ``use_kernel=mode``:
    (rows, seconds, launches, its counters)."""
    from repro_torch.figures import bench_serving as bs
    cost = {}
    rows, dt, lc = timed_run(lambda: bs.run(
        smoke=True, use_kernel=mode, counters=cost,
        out=os.path.join(ROOT, "src", "repro_torch", "figures", "results",
                         f"bench_serving_{mode or 'kernel'}.json")))
    return rows, dt, lc, cost


def serving_plain(conn) -> None:
    """13(a) through the plain versions, in a process of its own: sends
    back ("ok", ``bench_serving_run("ref")``) or ("error", the
    traceback)."""
    try:
        conn.send(("ok", bench_serving_run("ref")))
    except BaseException:
        import traceback
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def phase_serving(launches: dict) -> None:
    """13: (a) ``bench_serving.run(smoke=True)`` through the kernels and,
    in a second process beside the rest of the phase, through the plain
    versions, rows equal; (b) a flash crowd over ``N_KEYS`` keys through
    a 2^18-object prefix table, eq. 16 and LRU, kernels against plain
    versions request by request."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    child = ctx.Process(target=serving_plain, args=(send,))
    child.start()
    send.close()
    try:
        serving_engines(launches)
        kern = bench_serving_run(None)
        status, plain = recv.recv()
    finally:
        child.join(timeout=60)
        if child.is_alive():
            child.terminate()
            child.join()
    if status != "ok":
        raise AssertionError(f"phase 13a's plain run failed:\n{plain}")
    serving_bench_report(launches, {None: kern, "ref": plain})


def serving_engines(launches: dict) -> None:
    """13's card-against-CPU check and 13(b)."""
    from repro_torch.data.scenarios import make_scenario
    from repro_torch.figures import bench_serving as bs
    # the card against the CPU on a small workload
    w = make_scenario("flash_crowd", seed=3, n_requests=600, n_keys=80)
    small = []
    for dev in ("cuda", "cpu"):
        eng = bs._make_engine(w, hedging=True, hier=False, device=dev)
        sq, depth, _, n, shed, failed = bs._drive(w, eng)
        small.append((eng.stats.as_dict(), sq.counts.tolist(), sq.sum,
                      depth.tolist(), n, shed, failed))
    if small[0] != small[1]:
        raise AssertionError(f"13: card {small[0]} != cpu {small[1]}")
    log("phase 13: flash crowd, 600 requests: card == CPU (every counter, "
        "the latency sum and the sketch)")

    w = make_scenario("flash_crowd", seed=0, n_requests=SERVE_REQUESTS,
                      n_keys=N_KEYS)
    foot = bs._footprint(w)
    reqs = [(float(t), f"p{k}", int(n))
            for t, k, n in zip(w.times, w.keys, w.n_tokens)]
    log(f"phase 13b: flash crowd, {SERVE_REQUESTS} requests over {N_KEYS} "
        f"keys ({len(set(w.keys.tolist()))} touched), capacity 25% of the "
        f"{foot:.0f}-token footprint, {SERVE_OBJECTS}-object table, hedged")
    for policy in ("stoch_vacdh", "lru"):
        out = {}
        for mode in (None, "ref"):
            eng = bs._make_engine(w, hedging=True, hier=False,
                                  policy=policy, use_kernel=mode,
                                  max_objects=SERVE_OBJECTS)
            got, dt, lc = timed_run(lambda eng=eng: [eng.serve(*q)
                                                     for q in reqs])
            c = eng.cache.counters
            out[mode] = (got, eng.stats.as_dict())
            if mode is None:
                serve_cost_check(f"13b {policy}", c["admits"], c["ranks"],
                                 lc["ranking_victim_order"],
                                 lc["lane_scatter"], policy == "stoch_vacdh")
                add_launches(launches, lc)
            elif any(lc.values()):
                raise AssertionError(f"13b plain run launched: {lc}")
            log(f"phase 13b: {policy} use_kernel={mode!r}: {dt:.2f} s, "
                f"{SERVE_REQUESTS / dt:.1f} req/s, "
                f"{c['syncs'] / SERVE_REQUESTS:.4f} syncs/request, "
                f"{c['admits']} admissions, {c['ranks']} ranks, "
                f"{c['flushed'] / max(c['flushes'], 1):.2f} objects a "
                f"flush, mirror {eng.cache.mirror_bytes} bytes, launches "
                f"{lc}")
        if out[None] != out["ref"]:
            k = next((i for i, (a, b) in enumerate(zip(out[None][0],
                                                       out["ref"][0]))
                      if a != b), None)
            raise AssertionError(f"13b {policy}: kernels != plain (first "
                                 f"request {k}): {out[None][1]} vs "
                                 f"{out['ref'][1]}")
        st = out[None][1]
        log(f"phase 13b: {policy}: kernels == plain in every (outcome, "
            f"latency) and counter: hits {st['hits']}, delayed "
            f"{st['delayed_hits']}, misses {st['misses']}, evictions "
            f"{st['evictions']}, hedges {st['hedges']}, mean latency "
            f"{st['mean_latency']}")


def serving_bench_report(launches: dict, runs: dict) -> None:
    """13(a): the kernel run's costs and launches, the plain run's none,
    every row field but ``bench_serving.MEASURED`` equal."""
    from repro_torch.figures import bench_serving as bs
    res = {}
    for mode in (None, "ref"):
        rows, dt, lc, cost = runs[mode]
        res[mode] = rows
        if mode is None:
            serve_cost_check("13a kernels", cost["admits"], cost["ranks"],
                             cost["rank_launches"], cost["scatter_launches"],
                             True)
            add_launches(launches, lc)
        elif any(lc.values()):
            raise AssertionError(f"13a plain run launched kernels: {lc}")
        a = cost["admits"]
        log(f"phase 13a: bench_serving.run(smoke=True, use_kernel="
            f"{mode!r}): {dt:.2f} s; measured segments "
            f"{cost['requests']} requests in {cost['seconds']:.2f} s = "
            f"{cost['requests'] / cost['seconds']:.1f} req/s, "
            f"{cost['syncs'] / cost['requests']:.4f} syncs/request, "
            f"{a} admissions, {cost['ranks'] / a:.4f} ranks, "
            f"{cost['rank_launches'] / a:.4f} ranking and "
            f"{cost['scatter_launches'] / a:.4f} lane-scatter launches an "
            f"admission; launches over the run {lc}")
    strip = lambda r: {k: v for k, v in r.items() if k not in bs.MEASURED}
    if [strip(r) for r in res[None]] != [strip(r) for r in res["ref"]]:
        bad = [(strip(a), strip(b)) for a, b in zip(res[None], res["ref"])
               if strip(a) != strip(b)]
        raise AssertionError(f"13a: kernel rows != plain rows: {bad[:2]}")
    for r in res[None]:
        if r["mode"] == "slo_search":
            log(f"phase 13a: {r['scenario']:16s} slo_search hedged="
                f"{r['hedging']!s:5s} {r['req_s_at_slo']} req/s at the "
                f"{r['slo_ms']} ms p99 (x{r['rate_mult_at_slo']})")
            continue
        log(f"phase 13a: {r['scenario']:16s} {r['mode']:6s} hedged="
            f"{r['hedging']!s:5s} p50/p99/p99.9 {r['p50_ms']}/"
            f"{r['p99_ms']}/{r['p999_ms']} ms, {r['drive_req_per_s']} "
            f"req/s, {r['syncs_per_req']} syncs, "
            f"{r['rank_launches_per_req']} ranking and "
            f"{r['scatter_launches_per_req']} lane-scatter launches a "
            f"request, shed {r['shed']}, failed {r['failed']}, retries "
            f"{r['retries']}")
    log(f"phase 13a: {len(res[None])} rows, kernels == plain in every "
        f"field but {bs.MEASURED}")


# --- phase 14: the sweep fabric on the card ----------------------------------
FABRIC_REQUESTS = 625         # phase 14(a)'s grid, cut from 5,000
FABRIC_MULTI_REQUESTS = 312   # 14(b)'s, cut from 2,500
FABRIC_HIER_REQUESTS = 250    # phase 14(c)'s fig6 route, cut from 2,000


def fabric_pair(label: str, fn, needs, launches: dict, arrays):
    """One grid in process and through a one-card mesh (one worker), each
    from zeroed launch counts: the grids must be equal bit for bit, the
    in-process run must launch ``needs`` and the worker must launch them
    too (the caller launches nothing in the fabric run).  ``arrays`` maps
    a grid to its fields as host arrays.  Adds both runs' launches to
    ``launches``."""
    import torch
    from repro_torch.launch.mesh import make_data_mesh
    t0 = time.perf_counter()
    inproc, ic, lc = drive(f"phase {label}: in process",
                           lambda c: fn(c, {}), needs)
    in_s = time.perf_counter() - t0
    add_launches(launches, lc)
    mesh = make_data_mesh(1)
    t0 = time.perf_counter()
    fab, fc, _ = drive(f"phase {label}: mesh=make_data_mesh(1)",
                       lambda c: fn(c, {"mesh": mesh}))
    fab_s = time.perf_counter() - t0
    wl = fc["launches"]
    for k in needs:
        if wl.get(k, 0) <= 0:
            raise AssertionError(f"phase {label}: the worker did not launch "
                                 f"{k}: {wl}")
    add_launches(launches, wl)
    fa, fb = arrays(inproc), arrays(fab)
    if fa.keys() != fb.keys() or not all(
            bitwise_equal(torch.from_numpy(fa[k]), torch.from_numpy(fb[k]))
            for k in fa):
        raise AssertionError(f"phase {label}: the fabric grid differs from "
                             f"the in-process grid")
    for k in ("lane_requests", "requests"):
        if fc[k] != ic[k]:
            raise AssertionError(f"phase {label}: {k} {fc[k]} != {ic[k]}")
    start = fc["worker_start_s"] / fc["workers"]
    rate_in, rate_fab = ic["lane_requests"] / in_s, fc["lane_requests"] / fab_s
    log(f"phase {label}: fabric == in process bitwise in every field; "
        f"{ic['lane_requests']} lane-requests: in process {in_s:.2f} s "
        f"({rate_in:.1f} lane-requests/s), through a one-card mesh "
        f"{fab_s:.2f} s ({rate_fab:.1f} lane-requests/s, "
        f"{rate_fab / rate_in:.3f} of in process; "
        f"{fc['lane_requests'] / (fab_s - start):.1f} lane-requests/s "
        f"without the worker's start-up of {start:.2f} s); the worker's "
        f"launches {wl}")


def phase_fabric(launches: dict) -> None:
    """14: the sweep fabric on the card: (a) bench_sweep's 24-lane scaling
    grid (stoch_vacdh, 8 omegas x 3 capacities, 100 objects, eq. 16
    through ``ranking_victim_order``) at ``FABRIC_REQUESTS``, (b) the same
    grid with lru and vacdh beside stoch_vacdh at
    ``FABRIC_MULTI_REQUESTS``, (c) fig6's hash route at
    S = 4 with its 4 hop laws at ``FABRIC_HIER_REQUESTS``: each through a
    one-card mesh (one worker process) against the in-process grid bit
    for bit; (d) ``devices=2`` refused on a one-card machine."""
    import torch
    from repro_torch.core import (PolicyParams, make_hier_trace, sweep_grid,
                                  sweep_hier_grid)
    from repro_torch.data.traces import synthetic_trace
    from repro_torch.figures import bench_sweep, fig6_hierarchy

    trace, caps, plist, _ = bench_sweep.scaling_workload(
        n_requests=FABRIC_REQUESTS)
    for label, pols, n in (
            ("14a", "stoch_vacdh", FABRIC_REQUESTS),
            ("14b", ["lru", "vacdh", "stoch_vacdh"], FABRIC_MULTI_REQUESTS)):
        tr = trace if n == FABRIC_REQUESTS else \
            bench_sweep.scaling_workload(n_requests=n)[0]
        fabric_pair(label, lambda c, kw, pols=pols, tr=tr: sweep_grid(
            tr, caps, pols, plist, counters=c, **kw),
            EQ16_RUN, launches, grid_arrays)

    base = synthetic_trace(torch.Generator().manual_seed(0),
                           fig6_hierarchy._spec(False, FABRIC_HIER_REQUESTS))
    hops = [make_hier_trace(base, 4, generator=torch.Generator()
                            .manual_seed(7), hop_mean=0.01, hop_dist=d,
                            route="hash")
            for _, d in fig6_hierarchy.HOP_DISTS]
    fabric_pair("14c", lambda c, kw: sweep_hier_grid(
        hops, 4, 400.0, (0.0, 2000.0), list(fig6_hierarchy.POLICIES),
        PolicyParams(omega=1.0), estimate_z=True, counters=c, **kw),
        REPLAY_RUN, launches, hier_grid_arrays)

    n = torch.cuda.device_count()
    if n == 1:
        try:
            sweep_grid(trace, caps, "stoch_vacdh", plist, devices=2)
        except ValueError as e:
            log(f"phase 14d: devices=2 on one card raises: {e}")
        else:
            raise AssertionError("devices=2 ran on a one-card machine")
    else:
        log(f"phase 14d: {n} cards visible; the one-card refusal is not "
            f"checked")


# --- phases 15-16: phi3.5-MoE served and trained at full width ---------------
def profiled_busy(fn) -> float:
    """Device-busy seconds of one ``fn()`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.profile_replay import _device_seconds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _device_seconds(prof)


def moe_router_recorder(rec: list):
    """A stand-in for ``models.moe.moe_apply`` that records each call's
    expert ids (T, k) and its smallest router margin (the least gap
    between neighbours among the top k + 1 probabilities) in ``rec``."""
    import torch
    from repro_torch.models import moe
    inner = moe.moe_apply

    def recording(p, x, *, top_k, **kw):
        probs, _, idx = moe.route(p["router"], x.reshape(-1, x.shape[-1]),
                                  top_k)
        srt = torch.sort(probs, dim=-1, descending=True).values
        gap = (srt[:, :top_k] - srt[:, 1:top_k + 1]).min()
        rec.append((idx, float(gap)))
        return inner(p, x, top_k=top_k, **kw)
    return recording


def check_moe_f32(cfg, params, prompts, steps: int = 16) -> None:
    """f32 at 2 layers of full width: each MoE layer's expert choices equal
    between the kernel and the plain path (the smallest router margin
    printed), then prefill and ``steps`` teacher-forced decode logits
    within 1e-3 of max |logit|, as ``check_f32``."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=MOE_CHECK_LAYERS)
    p32 = to_f32({**params, "layers": params["layers"][:MOE_CHECK_LAYERS]})
    inner = tf.moe_apply
    worst, margin, calls = 0.0, float("inf"), 0
    try:
        for i, prompt in enumerate(prompts):
            recs = {}
            for mode in ("ref", True):
                recs[mode] = []
                tf.moe_apply = moe_router_recorder(recs[mode])
                out = run_request(dataclasses.replace(cfg32, use_kernel=mode),
                                  p32, prompt, steps,
                                  None if mode == "ref" else feed)
                if mode == "ref":
                    want, feed = out[0], out[1]
                else:
                    got = out[0]
            if len(recs[True]) != len(recs["ref"]):
                raise AssertionError("the two paths made different numbers "
                                     "of MoE calls")
            for j, ((a, ga), (b, _)) in enumerate(zip(recs[True],
                                                      recs["ref"])):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"prompt {i}, MoE call {j}: the kernel path chose "
                        f"other experts for "
                        f"{int((a != b).any(-1).sum())} tokens (smallest "
                        f"router margin {ga:.3e})")
            margin = min(margin, min(g for _, g in recs["ref"]))
            calls += len(recs[True])
            rel = float((got - want).abs().max() / want.abs().max())
            worst = max(worst, rel)
            log(f"phase 15: f32 prompt {i} ({len(prompt)} tokens, "
                f"{MOE_CHECK_LAYERS} layers): {len(recs[True])} MoE calls "
                f"with equal top-{cfg.top_k} choices; prefill + {steps} "
                f"teacher-forced decode logits, kernels vs plain: max |diff|"
                f" / max |logit| = {rel:.3e}")
            if not rel <= 1e-3 or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"f32 logits of the kernel path differ "
                                     f"from the plain path by {rel} of max "
                                     f"|logit|")
    finally:
        tf.moe_apply = inner
    log(f"phase 15: f32 check passed: expert choices equal in all {calls} "
        f"MoE calls (smallest router margin {margin:.3e}), logits max "
        f"{worst:.3e} <= 1e-3 of max |logit|")


def phase_moe_serve(launches: dict) -> None:
    """phi3.5-MoE at full width, 8 of its 32 layers, behind the batcher as
    in phase 5; its device idle share and peak memory; the f32 check at 2
    layers."""
    import torch
    from repro_torch.launch.serve import serve
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, prompts, run = phase_serve(
        15, MOE_ARCH, launches, n_layers=MOE_LAYERS, f32_check=False,
        max_new=SERVE_NEW)
    t1 = time.perf_counter()
    # the idle share of one request (prefill and 15 decodes): its
    # unprofiled wall against the device time of the same work profiled
    # (the profiler's own cost is ~20 s a request)
    few = prompts[:1]
    torch.cuda.synchronize()
    tw = time.perf_counter()
    serve(cfg, params, few, SERVE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tw
    busy = profiled_busy(lambda: serve(cfg, params, few, SERVE_NEW))
    t2 = time.perf_counter()
    log(f"phase 15: {cfg.name} ({cfg.n_experts} experts of d_ff "
        f"{cfg.d_ff}, top-{cfg.top_k}): prefill "
        f"{run['prefill_tokens'] / run['prefill_s']:.1f} tok/s, decode "
        f"{run['decode_tokens'] / run['decode_s']:.1f} tok/s; one request:"
        f" device busy {busy:.3f} s of {wall:.3f} s, idle share "
        f"{1 - busy / wall:.4f}; torch.cuda.max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check_moe_f32(cfg, params, prompts[:2])
    log(f"phase 15: seconds: serve runs {t1 - t0:.1f}, profile "
        f"{t2 - t1:.1f}, f32 check {time.perf_counter() - t2:.1f}")


def phase_train_grads() -> None:
    """16(a): the attention and GLA kernel ops' autograd on the card (f32)
    against autograd of their plain versions on the same inputs."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref, gla_chunk_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(16)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")

    def grads(fn, ins, ws):
        outs = fn(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum(torch.sum(o * w) for o, w in zip(outs, ws))
        return outs, torch.autograd.grad(
            loss, [t for t in ins if t is not None])

    worst = 0.0
    for h, kv, window, softcap, sink in ((8, 2, 0, 0.0, 0),
                                         (8, 8, 48, 0.0, 0),
                                         (12, 4, 64, 30.0, 8)):
        b, s, dh = 2, 200, 64
        ins = [rnd(b, s, n, dh).requires_grad_() for n in (h, kv, kv)]
        pos = torch.arange(s, dtype=torch.int32, device="cuda")
        ws = [rnd(b, s, h, dh)]
        o1, g1 = grads(lambda *a: ops.flash_attention(
            *a, pos, pos, window, softcap, sink), ins, ws)
        o2, g2 = grads(lambda *a: flash_attention_ref(
            *a, pos, pos, window=window, softcap=softcap, sink=sink),
            ins, ws)
        err = max(float((x - y).detach().abs().max()) for x, y in
                  zip((*o1, *g1), (*o2, *g2)))
        worst = max(worst, err)
        log(f"phase 16(a): flash_attention H {h} / KV {kv}, window {window}, "
            f"softcap {softcap}, sink {sink}: output and dq, dk, dv against "
            f"autograd of the plain version, max |diff| {err:.3e}")
        if not err <= 1e-5:
            raise AssertionError(f"flash_attention's output or gradients "
                                 f"differ by {err} > 1e-5")
    for chunk in (16, 64):
        b, s, h, dk, dv = 2, 128, 2, 64, 64
        ins = [rnd(b, s, h, dk).requires_grad_(),
               rnd(b, s, h, dk).requires_grad_(),
               rnd(b, s, h, dv).requires_grad_(),
               torch.nn.functional.logsigmoid(rnd(b, s, h)).requires_grad_(),
               (rnd(b, s, h) * 0.5).requires_grad_()]
        ws = [rnd(b, s, h, dv), rnd(b, h, dk, dv), rnd(b, h, dk)]
        o1, g1 = grads(lambda *a: ops.gla_chunk(*a, None, None, chunk,
                                                True), ins, ws)

        def plain(*a):
            y, (st, n) = gla_chunk_plain(*a, chunk=chunk)
            return y, st, n
        o2, g2 = grads(plain, ins, ws)
        err = max(within(x.detach(), y.detach(), False)
                  for x, y in zip((*o1, *g1), (*o2, *g2)))
        log(f"phase 16(a): gla_chunk chunk {chunk}: y, S, n and the five "
            f"gradients against autograd of the plain version, max |diff| "
            f"/ (1e-4 + 1e-3 |want|) = {err:.3e}")
        if not err <= 1.0:
            raise AssertionError(f"gla_chunk differs from its plain version "
                                 f"({err} of the bound)")
    log(f"phase 16(a): passed (attention max |diff| {worst:.3e})")


def phase_train_step(launches: dict) -> None:
    """16(b): ``make_train_step`` on phi3.5-MoE at full width, 2 layers,
    bf16, 8 sequences of 512 tokens in 2 microbatches, 4 steps on one
    batch; the loss finite and falling, ``flash_attention`` launched once
    a layer per microbatch forward and once more in the recompute of the
    config's remat ("full")."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import OptConfig, init_opt
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(registry.get(MOE_ARCH),
                              n_layers=MOE_CHECK_LAYERS)
    steps, nm, seq, batch_n = 4, 2, 512, 8
    gen = torch.Generator(device="cuda").manual_seed(16)
    params = tf.init_params(gen, cfg)
    opt = init_opt(params)
    tcfg = TrainConfig(microbatches=nm, opt=OptConfig(
        lr=3e-4, warmup_steps=1, total_steps=steps))
    step_fn = make_train_step(cfg, tcfg)
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                                global_batch=batch_n), 0)
    log(f"phase 16(b): {cfg.name} at {cfg.n_layers} layers, "
        f"{tf.n_params(params) / 1e9:.3f} B parameters, bf16, remat "
        f"{cfg.remat!r}, batch {tuple(batch['tokens'].shape)} in {nm} "
        f"microbatches, {steps} steps on one batch")
    reset_launch_counts()
    losses, secs = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        log(f"phase 16(b): step {i + 1}: {secs[-1]:.3f} s, loss "
            f"{losses[-1]:.4f}, aux {float(m['aux']):.4f}, grad_norm "
            f"{float(m['grad_norm']):.4f}, lr {float(m['lr']):.3e}")
    lc = launch_counts()
    per = 2 if cfg.remat == "full" else 1
    want = cfg.n_layers * nm * steps * per
    if lc["flash_attention"] != want:
        raise AssertionError(f"the train steps launched flash_attention "
                             f"{lc['flash_attention']} times, not {want}")
    if any(v for k, v in lc.items() if k != "flash_attention"):
        raise AssertionError(f"the train steps launched {lc}")
    add_launches(launches, lc)
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the last loss {losses[-1]} is not below the "
                             f"first {losses[0]}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    warm = statistics.mean(secs[1:])
    busy = profiled_busy(lambda: step_fn(params, opt, batch))
    tokens = batch["tokens"].numel()
    log(f"phase 16(b): steps 2-{steps} {warm:.3f} s each "
        f"({tokens / warm:.1f} train tokens/s), first {secs[0]:.3f} s; "
        f"flash_attention launches {lc['flash_attention']} ({per} a layer "
        f"per microbatch); peak memory (torch.cuda.max_memory_allocated) "
        f"{peak:.2f} GB; one more step profiled: device busy {busy:.3f} s, "
        f"idle share {1 - busy / warm:.4f}")
    del params, opt


def phase_train_cpu_parity() -> None:
    """16(c): one ``value_and_grad`` of the phi3.5-MoE smoke config in f32
    on the card (kernels) against the CPU (plain versions)."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train_loop import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.smoke(MOE_ARCH), dtype="float32")
    params = tf.init_params(torch.Generator().manual_seed(3), cfg)
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=65,
                                global_batch=4), 0, device="cpu")
    (l_c, m_c), g_c = value_and_grad(params, cfg, batch)
    on = lambda t: tree_map(lambda x: x.cuda(), t)
    (l_g, m_g), g_g = value_and_grad(on(params), cfg, on(batch))
    worst = 0.0
    pairs = [(l_g, l_c), (m_g["aux"], m_c["aux"])] + list(
        zip(tree_leaves(g_g), tree_leaves(g_c)))
    for a, b in pairs:
        b = b.float()
        worst = max(worst, float(((a.cpu().float() - b).abs()
                                  / (1e-5 + 1e-4 * b.abs())).max()))
    log(f"phase 16(c): {cfg.name} f32 value_and_grad, card vs CPU: loss "
        f"{float(l_g):.6f} vs {float(l_c):.6f}, aux {float(m_g['aux']):.6f};"
        f" {len(pairs) - 2} gradient leaves; max |diff| / (1e-5 + 1e-4 "
        f"|cpu|) = {worst:.3e}")
    if not worst <= 1.0:
        raise AssertionError(f"the card's loss or gradients differ from the "
                             f"CPU's ({worst} of the bound)")


def phase_trainer() -> None:
    """16(d): the ``Trainer`` at smoke size on the card: checkpoints every 2
    steps, SIGTERM after step 3 (its preemption flag), a resumed run to
    step 6; the restored state bitwise the saved one."""
    import dataclasses
    import signal
    import tempfile
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import DataConfig
    from repro_torch.training.optimizer import OptConfig, tree_leaves
    from repro_torch.training.train_loop import TrainConfig
    from repro_torch.training.trainer import RunConfig, Trainer
    cfg = dataclasses.replace(registry.smoke(MOE_ARCH), remat="none")
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=6))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=33, global_batch=8)

    def preempt(msg):
        log(f"phase 16(d): {msg}")
        if msg.startswith("[trainer] step 3:"):
            os.kill(os.getpid(), signal.SIGTERM)

    old = signal.getsignal(signal.SIGTERM)
    with tempfile.TemporaryDirectory() as d:
        rcfg = RunConfig(steps=6, ckpt_every=2, log_every=1, ckpt_dir=d)
        try:
            t1 = Trainer(cfg, tcfg, dcfg, rcfg, log_fn=preempt)
            out1 = t1.run()
        finally:
            signal.signal(signal.SIGTERM, old)
        if not out1["preempted"] or out1["final_step"] != 3:
            raise AssertionError(f"the trainer did not stop at step 3: "
                                 f"{out1['final_step']}")
        t2 = Trainer(cfg, tcfg, dcfg, rcfg, log_fn=preempt)
        if t2.start_step != 3:
            raise AssertionError(f"resumed at {t2.start_step}, not 3")
        for a, b in zip(tree_leaves(t2.state()), tree_leaves(t1.state())):
            if a.dtype != b.dtype or a.device != b.device or \
                    not torch.equal(a, b):
                raise AssertionError("the restored state differs from the "
                                     "saved one")
        out2 = t2.run()
        if out2["final_step"] != 6 or out2["preempted"]:
            raise AssertionError(f"the resumed run ended at "
                                 f"{out2['final_step']}")
        losses = [h["loss"] for h in out1["history"] + out2["history"]]
    log(f"phase 16(d): preempted at step 3, restored bit for bit on "
        f"{t2.device}, resumed to step 6; losses "
        f"{[round(x, 4) for x in losses]}")


def phase_train(launches: dict) -> None:
    phase_train_grads()
    phase_train_step(launches)
    phase_train_cpu_parity()
    phase_trainer()


# --- phase 17: the LM cells through the sharding layer ----------------------
# one device's share of each cell as (layers, batch), None layers being the
# config's depth: train 4 x 4,096 tokens, a 32k prefill of one sequence,
# decode_32k's 128 rows over the 16-wide data axis, long_500k's one row; a
# model's serve cells share its weights, so they share a depth
CELLS_FULL = {"train_4k": (None, 4), "prefill_32k": (None, 1),
              "decode_32k": (None, 8)}
CELL_PLAN = {
    # the train cells of StableLM, xLSTM, Hymba and MusicGen run half their
    # depth for the time limit (the docstring's cuts)
    SERVE_ARCH: dict(CELLS_FULL, train_4k=(12, 4)),
    "xlstm-350m": dict(CELLS_FULL, train_4k=(12, 4), long_500k=(None, 1)),
    "hymba-1.5b": dict(CELLS_FULL, train_4k=(16, 4), long_500k=(None, 1)),
    # 48 layers' caches at 8 rows would be 103 GB: decode 4
    "musicgen-large": dict(CELLS_FULL, train_4k=(24, 4),
                           decode_32k=(None, 4)),
    # 7.2 B parameters' AdamW state is ~116 GB: train 4 of 32 layers
    "llava-next-mistral-7b": dict(CELLS_FULL, train_4k=(4, 4)),
    # 32 layers are ~84 GB of weights: serve phase 15's 8; train 1 (at
    # 16(b)'s 2 the dry run predicts 68.71 GiB, and the card's train peaks
    # ran 8-13 GiB over the prediction where the plain attention backward
    # forms its f32 scores)
    MOE_ARCH: {"train_4k": (1, 4), "prefill_32k": (MOE_LAYERS, 1),
               "decode_32k": (MOE_LAYERS, 8)},
    # 4.8 B parameters a layer: serve 2 of 64 (~23 GB); one layer's AdamW
    # state alone is ~78 GB, so its train cell waits for four cards
    "grok-1-314b": {"prefill_32k": (2, 1), "decode_32k": (2, 8)},
    # 1.06 GB of weights a layer and a 32k cache of ~1 GiB a layer at 8
    # rows: serve 24 of 62 layers; train 2 layers at 2 rows (4 rows put the
    # plain attention backward's f32 scores over the card)
    "deepseek-coder-33b": {"train_4k": (2, 2), "prefill_32k": (24, 1),
                           "decode_32k": (24, 8)},
    # the loss's f32 (B, 4,096, 256,000) copies, 4.2 GB a row, bound the
    # train cell, not its depth: train 4 layers at 1 row
    "minitron-8b": dict(CELLS_FULL, train_4k=(4, 1)),
    # 15 B parameters' AdamW state is over 200 GB: train 3 layers, at 2 rows
    # (at 4 the plain attention backward's f32 scores pass the card)
    "starcoder2-15b": dict(CELLS_FULL, train_4k=(3, 2)),
}
CELL_ARCHS = tuple(CELL_PLAN)
CELL_TRAIN_STEPS = 4          # 17(b): a warm-up step and 3 timed ones
# 17(b)'s peak learning rate (one warm-up step, then cosine), 3e-4 unless
# named here: DeepSeek's 2 layers of d 7168 ended above their first loss
# at 3e-4 (10.894 -> 15.738 -> 13.701 -> 10.909); at 3e-5 the plain steps
# fell at every step (10.894 -> 9.158), at 5e-5-2e-4 they rose at step 2
CELL_LR = {"deepseek-coder-33b": 3e-5}
CELL_DECODE_STEPS = 3
F32_LAYERS = {"grok-1-314b": 1}   # 17(b)'s 32k f32 check, else 2 layers
F8_DECODE = ("deepseek-coder-33b",)   # 17(b): decode_32k with an fp8 cache
GRAD_ARCHS = ("xlstm-350m", "hymba-1.5b", "musicgen-large")   # 17(d)
GRAD_CHECK = (2, 512)         # 17(d): batch x tokens of the f32 check


def cell_cfg(arch: str, shape: str):
    """``arch``'s config at the depth ``CELL_PLAN`` gives ``shape``, and
    the cell's batch."""
    import dataclasses
    from repro_torch.configs import registry
    layers, b = CELL_PLAN[arch][shape]
    cfg = registry.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg, b


class DryRuns:
    """17(a), started right after the build: ``repro_torch.launch.dryrun``
    of every cell of ``CELL_PLAN`` on one device at its depth and batch (a
    1x1 mesh, ``--layers`` and ``--global-batch``), and ``SERVE_ARCH``'s
    three cells on the single production mesh (a fake world of 256 ranks)
    too, one subprocess a cell, two at a time, on the CPU alone (no card
    visible), while phases 1-16 run."""

    def __init__(self):
        import concurrent.futures
        import tempfile
        self.dir = tempfile.mkdtemp(prefix="dryrun_")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   CUDA_VISIBLE_DEVICES="")
        self.jobs = []
        for arch, plan in CELL_PLAN.items():
            for shape, (layers, b) in plan.items():
                for mesh in (("single", "local") if arch == SERVE_ARCH
                             else ("local",)):
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape, "--mesh", mesh,
                           "--out-dir", self.dir]
                    if mesh == "local":
                        cmd += ["--global-batch", str(b)]
                        if layers is not None:
                            cmd += ["--layers", str(layers)]
                    self.jobs.append((arch, shape, mesh, cmd))
        import threading
        self.procs = []
        self.lock, self.stopped = threading.Lock(), False
        self.pool = concurrent.futures.ThreadPoolExecutor(2)
        self.futures = [self.pool.submit(self._run, cmd, env)
                        for *_, cmd in self.jobs]

    def _run(self, cmd, env):
        with self.lock:
            if self.stopped:
                return -1, "stopped"
            p = subprocess.Popen(cmd, env=env, cwd=ROOT,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            self.procs.append(p)
        out, _ = p.communicate(timeout=900)
        return p.returncode, out

    def records(self) -> dict:
        """{(arch, shape, mesh): record}; raises unless every cell is
        ``ok``."""
        recs = {}
        for (arch, shape, mesh, _), fut in zip(self.jobs, self.futures):
            rc, out = fut.result()
            path = os.path.join(self.dir, f"{arch}@{shape}@{mesh}.json")
            rec = json.load(open(path)) if os.path.exists(path) else {}
            if rc or not rec.get("ok"):
                raise AssertionError(f"the dry run of {arch}@{shape}@{mesh} "
                                     f"failed (exit {rc}): {out[-2000:]}")
            recs[(arch, shape, mesh)] = rec
        return recs

    def stop(self):
        import shutil
        with self.lock:
            self.stopped = True
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
        self.pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(self.dir, ignore_errors=True)


def local(x):
    return x.to_local() if hasattr(x, "to_local") else x


def local_leaves(tree) -> list:
    """The tensor leaves of a tree of dicts, lists and tuples (named ones
    too), DTensors as their local shards."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in local_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in local_leaves(v)]
    return [local(tree)]


def same_leaves(a, b) -> bool:
    """Two trees' tensors bit for bit (dtype, shape and values)."""
    import torch
    a, b = local_leaves(a), local_leaves(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(a, b))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def input_key(cfg) -> str:
    """The model's input: token ids, or the frontend's embeddings."""
    return "tokens" if cfg.frontend == "none" else "embeds"


def lm_inputs(cfg, shape: tuple, seed: int, dtype=None):
    """Token ids of ``shape`` on the card from a seed, or for a frontend
    model (LLaVA's vision, MusicGen's audio stub) embeddings of ``shape`` x
    d_model of N(0, 0.02^2) in ``dtype`` (the model's by default)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.frontend == "none":
        return torch.randint(0, cfg.vocab, shape, generator=g,
                             device="cuda", dtype=torch.int32)
    return (torch.randn((*shape, cfg.d_model), generator=g, device="cuda")
            * 0.02).to(dtype or cfg.torch_dtype)


def cell_train(arch: str, dmesh, launches: dict) -> dict:
    """train_4k at ``CELL_PLAN``'s depth and batch: the cell's step on
    DTensors from a seed, then ``make_train_step`` on plain tensors from
    the same seed, losses and final parameters bit for bit; the batch is
    ``batch_at``'s with the config's frontend, as the trainer makes it; the
    DTensor run launches each train kernel twice a layer a step (the
    forward and the checkpoint's recompute under remat "full")."""
    import torch
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.cells import input_specs, materialize
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import OptConfig, init_opt
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    cfg, b = cell_cfg(arch, "train_4k")
    tcfg = TrainConfig(opt=OptConfig(lr=CELL_LR.get(arch, 3e-4),
                                     warmup_steps=1,
                                     total_steps=CELL_TRAIN_STEPS))
    cell = input_specs(cfg, "train_4k", dmesh, tcfg, global_batch=b)
    want = {k: cfg.n_layers * 2 * CELL_TRAIN_STEPS
            for k in lm_kernels(cfg, "train")}

    def values():
        gen = torch.Generator(device="cuda").manual_seed(17)
        params = tf.init_params(gen, cfg)
        batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=4097,
                                    global_batch=b), 0,
                         frontend=cfg.frontend, d_model=cfg.d_model)
        return params, init_opt(params), {
            k: v.to(cfg.torch_dtype if k == "embeds" else torch.int32)
            for k, v in batch.items()}

    def run(step, args):
        losses, secs = [], []
        for _ in range(CELL_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(*args)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(local(m["loss"])))
        return params, losses, secs

    out = {}
    for label in ("dtensor", "plain"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        vals = values()
        if label == "dtensor":
            args, step = materialize(cell, vals), cell.fn
            reset_launch_counts()
        else:
            args, step = vals, make_train_step(cfg, tcfg)
        del vals
        params, losses, secs = run(step, args)
        if label == "dtensor":
            lc = launch_counts()
            check_launches(f"17(b) {cfg.name} train_4k", lc, want)
            add_launches(launches, lc)
            final = [x.cpu() for x in local_leaves(params)]
        else:
            same = all(torch.equal(x.cpu(), y) for x, y in
                       zip(local_leaves(params), final))
        out[label] = dict(losses=losses, secs=secs,
                          peak=torch.cuda.max_memory_allocated())
        del args, params
    d, p = out["dtensor"], out["plain"]
    warm = statistics.mean(d["secs"][1:])
    equal = d["losses"] == p["losses"] and same
    log(f"phase 17(b): {cfg.name} train_4k, {cfg.n_layers} layers, {b} x "
        f"4096 {input_key(cfg)}, {CELL_TRAIN_STEPS} steps: DTensor losses "
        f"{[round(x, 4) for x in d['losses']]}; steps 2-{CELL_TRAIN_STEPS} "
        f"{warm:.3f} s each ({b * 4096 / warm:.1f} train tokens/s; plain "
        f"tensors {statistics.mean(p['secs'][1:]):.3f} s), peak memory "
        f"{d['peak'] / 2**30:.2f} GiB (plain {p['peak'] / 2**30:.2f} GiB); "
        f"launches a step { {k: v // CELL_TRAIN_STEPS for k, v in want.items()} }"
        f"; DTensor == plain (losses and parameters): {equal}")
    if not equal:
        raise AssertionError(f"the DTensor train steps differ from the "
                             f"plain ones: losses {d['losses']} vs "
                             f"{p['losses']}, parameters equal: {same}")
    if not all(x == x for x in d["losses"]) or \
            not d["losses"][-1] < d["losses"][0]:
        raise AssertionError(f"the loss did not fall: {d['losses']}")
    return dict(s=warm, tokens_s=b * 4096 / warm, peak=d["peak"])


def cell_prefill(cfg, dmesh, params, batch: dict, launches: dict) -> dict:
    """prefill_32k at batch 1 on DTensors against the plain prefill on a
    fresh cache: last-token logits and the whole returned cache (ring,
    recurrent state, conv tail) bit for bit."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.cells import input_specs, materialize
    from repro_torch.models import transformer as tf
    from repro_torch.training.train_loop import make_serve_steps
    cell = input_specs(cfg, "prefill_32k", dmesh, global_batch=1)
    s = batch[input_key(cfg)].shape[1]
    cap = cfg.meta_tokens + s + 1
    want = {k: cfg.n_layers for k in lm_kernels(cfg, "prefill")}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = materialize(cell, (params, tf.init_cache(cfg, 1, cap), batch))
    cell.fn(*args)                                      # warm-up
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = cell.fn(*args)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    lc = launch_counts()
    check_launches(f"17(b) {cfg.name} prefill_32k", lc, want)
    add_launches(launches, lc)
    peak = torch.cuda.max_memory_allocated()
    prefill, _ = make_serve_steps(cfg)
    same = same_leaves(got, prefill(params, tf.init_cache(cfg, 1, cap),
                                    batch))
    log(f"phase 17(b): {cfg.name} prefill_32k, {cfg.n_layers} layers, 1 x "
        f"{s} {input_key(cfg)}: {sec:.3f} s ({s / sec:.1f} tok/s), peak "
        f"memory {peak / 2**30:.2f} GiB, launches {want}; logits "
        f"{tuple(local(got[0]).shape)}; DTensor == plain (logits and "
        f"cache): {same}")
    if not same:
        raise AssertionError("the DTensor prefill differs from the plain one")
    return dict(s=sec, tokens_s=s / sec, peak=peak)


def filled_cache(cfg, b: int, capacity: int, first: int, seed: int):
    """A serving cache as it stands before position ``first``, from a
    seed: random K and V in every ring slot, the slots' positions those of
    the sink and of the last ``ring`` positions before ``first``, a random
    recurrent state and conv tail."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import _slot
    cache = tf.init_cache(cfg, b, capacity)
    g = torch.Generator(device="cuda").manual_seed(seed)
    for c in cache:
        if "attn" in c:
            a, sink = c["attn"], cfg.meta_tokens
            ring = a["k"].shape[1] - sink
            pos = torch.cat([torch.arange(min(sink, first)),
                             torch.arange(max(sink, first - ring), first)])
            for t in (a["k"], a["v"]):
                # drawn in the model's dtype: an fp8 cache has no normal_
                t.copy_(torch.empty_like(t, dtype=cfg.torch_dtype).normal_(
                    generator=g))
            a["kpos"][_slot(pos, sink, ring).cuda()] = pos.to(
                torch.int32).cuda()
        for t in c.get("ssm", {}).values():
            t.normal_(generator=g)
    return cache


def cell_decode(cfg, shape: str, b: int, dmesh, params,
                launches: dict) -> dict:
    """A decode shape (decode_32k, long_500k) at ``b`` rows over a cache
    of meta + the shape's positions (a ring of meta + window slots where
    the model has a window) filled from a seed as it stands before its
    last ``CELL_DECODE_STEPS`` positions: those steps on DTensors (a
    warm-up pass, then a timed one), each carrying the returned cache,
    then on plain tensors from the same cache, logits and the final cache
    bit for bit."""
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.cells import input_specs, materialize
    from repro_torch.models.attention import _slot
    from repro_torch.training.train_loop import make_serve_steps
    n, key = CELL_DECODE_STEPS, input_key(cfg)
    cell = input_specs(cfg, shape, dmesh, global_batch=b)
    cap = cfg.meta_tokens + SHAPES[shape].seq_len
    first = cap - n
    want = {k: cfg.n_layers * n for k in lm_kernels(cfg, "decode")}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cache = filled_cache(cfg, b, cap, first, 18)
    toks = lm_inputs(cfg, (n, b, 1), 18)
    pos = [torch.tensor(first + i, dtype=torch.int32, device="cuda")
           for i in range(n)]
    # the ring slots the steps write: kept to put back before each pass,
    # and with the recurrent state what a pass's final cache is held by
    slots = [_slot(torch.arange(first, cap, device="cuda"), cfg.meta_tokens,
                   c["attn"]["k"].shape[1] - cfg.meta_tokens)
             if "attn" in c else None for c in cache]

    def written(cur):
        out = []
        for c, sl in zip(cur, slots):
            d = {k: t.clone() for k, t in c.get("ssm", {}).items()}
            if sl is not None:
                a = c["attn"]
                d.update({k: (a[k][sl] if k == "kpos" else a[k][:, sl])
                          .clone() for k in a})
            out.append(d)
        return out

    kept = written(cache)

    def restore():
        for c, sl, vals in zip(cache, slots, kept):
            if sl is not None:
                a = c["attn"]
                a["kpos"][sl] = vals["kpos"]
                a["k"][:, sl] = vals["k"]
                a["v"][:, sl] = vals["v"]

    def dtensor_pass():
        out, cur = [], cache
        for i in range(n):
            args = materialize(cell, (params, cur, toks[i], pos[i]))
            logits, cur = cell.fn(*args)
            out.append(local(logits))
            cur = [{k: {j: local(t) for j, t in d.items()}
                    for k, d in c.items()} for c in cur]
        return out, written(cur)

    dtensor_pass()
    restore()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, got_state = dtensor_pass()
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / n
    lc = launch_counts()
    check_launches(f"17(b) {cfg.name} {shape}", lc, want)
    add_launches(launches, lc)
    peak = torch.cuda.max_memory_allocated()
    restore()
    _, decode = make_serve_steps(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wanted, cur = [], cache
    for i in range(n):
        logits, cur = decode(params, cur, pos0=pos[i], **{key: toks[i]})
        wanted.append(logits)
    torch.cuda.synchronize()
    plain_sec = (time.perf_counter() - t0) / n
    same = same_leaves(got, wanted) and same_leaves(got_state, written(cur))
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    cache_gb = sum(t.numel() * t.element_size() for t in
                   local_leaves(cache)) / 1e9
    log(f"phase 17(b): {cfg.name} {shape}, {cfg.n_layers} layers, batch {b} "
        f"at positions {first}-{cap - 1} ({cache_gb:.2f} GB of "
        f"{cfg.kv_dtype} cache): "
        f"{sec * 1e3:.2f} ms a step ({b / sec:.1f} tok/s; plain tensors "
        f"{plain_sec * 1e3:.2f} ms), peak memory {peak / 2**30:.2f} GiB, "
        f"launches {want}; DTensor == plain (logits, written slots and "
        f"recurrent state): {same}; finite: {finite}")
    if not same or not finite:
        raise AssertionError(f"the DTensor {shape} differs from the plain "
                             f"one ({same}) or is not finite ({finite})")
    del cache, cur, kept, got_state
    return dict(s=sec, tokens_s=b / sec, peak=peak, cache_gb=cache_gb)


def check_f8_decode(cfg, b: int, dmesh, params, bf16: dict,
                    launches: dict) -> None:
    """decode_32k again over an fp8 e4m3 KV cache (``kv_dtype="f8"``):
    ``cell_decode``'s checks, and the cache about half the bytes of the
    bf16 cell's (``bf16``, its measurement)."""
    import dataclasses
    got = cell_decode(dataclasses.replace(cfg, kv_dtype="f8"), "decode_32k",
                      b, dmesh, params, launches)
    ratio = got["cache_gb"] / bf16["cache_gb"]
    log(f"phase 17(b): {cfg.name} decode_32k fp8 cache: {got['cache_gb']:.2f}"
        f" GB, {ratio:.4f} of the bf16 cache's {bf16['cache_gb']:.2f} GB; "
        f"{got['s'] * 1e3:.2f} ms a step (bf16 {bf16['s'] * 1e3:.2f} ms)")
    if not 0.5 <= ratio < 0.51:
        raise AssertionError(f"the fp8 cache is {ratio} of the bf16 one")


def check_prefill_32k_f32(cfg, batch: dict, layers: int) -> None:
    """The kernel route against the plain route (q-chunked attention,
    plain GLA) at 32k on the card: f32, ``layers`` layers, last-token
    logits within 1e-3 of max |logit|."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    c32 = dataclasses.replace(cfg, n_layers=layers, dtype="float32")
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(19),
                            c32)
    outs = {}
    with torch.no_grad():
        for mode in (True, "ref"):
            logits, _, _ = tf.forward(params, dataclasses.replace(
                c32, use_kernel=mode), mode="prefill", **batch)
            outs[mode] = logits[0, -1]
    del params
    rel = float((outs[True] - outs["ref"]).abs().max()
                / outs["ref"].abs().max())
    log(f"phase 17(b): {cfg.name} prefill_32k f32 at {layers} layers, "
        f"kernel vs plain route: last-token logits max |diff| / max |logit| "
        f"= {rel:.3e}")
    if not rel <= 1e-3 or not bool(torch.isfinite(outs[True]).all()):
        raise AssertionError(f"the 32k kernel route differs from the plain "
                             f"route by {rel} of max |logit|")


def check_grads_f32(cfg) -> None:
    """17(d): one ``value_and_grad`` of ``cfg`` at full width, 2 layers,
    f32, ``GRAD_CHECK`` tokens (or frontend embeddings) from a seed,
    through the kernels' forward (each train kernel twice a layer: the
    forward and the recompute) against the plain route: the loss and every
    gradient element within atol 1e-5 + rtol 1e-4, all finite."""
    import dataclasses
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    c32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(22),
                            c32)
    b, s = GRAD_CHECK
    toks = torch.randint(0, cfg.vocab, (b, s + 1), dtype=torch.int32,
                         device="cuda", generator=torch.Generator(
                             device="cuda").manual_seed(23))
    batch = {"labels": toks[:, 1:]}
    batch[input_key(cfg)] = (toks[:, :-1] if cfg.frontend == "none" else
                             lm_inputs(c32, (b, s), 24))
    out = {}
    for mode in (True, "ref"):
        reset_launch_counts()
        (loss, _), grads = value_and_grad(
            params, dataclasses.replace(c32, use_kernel=mode), batch)
        torch.cuda.synchronize()
        check_launches(f"17(d) {cfg.name} use_kernel={mode!r}",
                       launch_counts(),
                       {k: 2 * c32.n_layers for k in lm_kernels(cfg, "train")}
                       if mode is True else {})
        out[mode] = [loss] + tree_leaves(grads)
    worst, n = 0.0, 0
    for got, want in zip(out[True], out["ref"]):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"17(d) {cfg.name}: a non-finite gradient")
        excess = float(((got - want).abs() / (1e-5 + 1e-4 * want.abs()))
                       .max())
        worst, n = max(worst, excess), n + got.numel()
    log(f"phase 17(d): {cfg.name} f32 value_and_grad at 2 layers, {b} x {s} "
        f"{input_key(cfg)}, kernels vs plain: loss "
        f"{float(out[True][0]):.6f} vs {float(out['ref'][0]):.6f}; "
        f"{len(out[True]) - 1} gradients, {n} elements, max |diff| / (1e-5 "
        f"+ 1e-4 |plain|) = {worst:.3f}")
    if not worst <= 1.0:
        raise AssertionError(f"17(d) {cfg.name}: gradients differ by "
                             f"{worst} times the bound")


def op_dispatch_cost() -> None:
    """The custom op's host cost over the wrapper's on phase 5's decode
    shape (StableLM, one token over 2,048 slots): host time of 2,000 calls
    each, ending in a sync."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention
    g = torch.Generator(device="cuda").manual_seed(20)
    rnd = lambda *sh: torch.randn(sh, generator=g, device="cuda").to(
        torch.bfloat16)
    q, k, v = rnd(1, 1, 32, 64), rnd(1, 2048, 32, 64), rnd(1, 2048, 32, 64)
    qp = torch.tensor([2047], dtype=torch.int32, device="cuda")
    kp = torch.arange(2048, dtype=torch.int32, device="cuda")

    def host_us(fn, n=2000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    res = {}
    for turn in ("wrapper", "op", "op", "wrapper"):
        fn = ((lambda: decode_attention(q, k, v, qp, kp)) if turn ==
              "wrapper" else (lambda: ops.decode_attention(q, k, v, qp, kp,
                                                           0, 0.0, 0)))
        res.setdefault(turn, []).append(host_us(fn))
    w, o = min(res["wrapper"]), min(res["op"])
    log(f"phase 17(c): decode_attention at phase 5's shape, host time a "
        f"call: wrapper {w:.2f} us, custom op {o:.2f} us; the op adds "
        f"{o - w:.2f} us a call, {(o - w) * 24 / 1e3:.3f} ms a token over "
        f"24 layers")


def phase_cells(launches: dict, dry: DryRuns, archs=CELL_ARCHS) -> None:
    """17: for each of ``archs``, (b) its cells of ``CELL_PLAN`` through
    ``input_specs`` on the local mesh as DTensors over a one-rank NCCL
    ``DeviceMesh``, each against the same step on plain tensors, and the
    32k prefill's f32 check; (d) the f32 gradient check of
    ``GRAD_ARCHS``; (c) the custom op's dispatch cost; then (a)'s records
    beside (b)'s measurements."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import device_mesh, make_local_mesh
    from repro_torch.models import transformer as tf
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    meas = {}
    try:
        dmesh = device_mesh(make_local_mesh(), "cuda")
        for arch in archs:
            plan = CELL_PLAN[arch]
            serve = [sh for sh in plan if sh != "train_4k"]
            cfg, _ = cell_cfg(arch, serve[0])
            log(f"phase 17(b): {arch} at full width (d {cfg.d_model}, "
                f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.d_head}, "
                f"family {cfg.family}, input {input_key(cfg)}, vocab "
                f"{cfg.vocab} x {cfg.out_heads} heads, experts "
                f"{cfg.n_experts} top {cfg.top_k}, softcap "
                f"{cfg.logit_softcap}) on {dmesh}; (layers, batch) a cell: "
                f"{plan}")
            t0 = time.perf_counter()
            if "train_4k" in plan:
                meas[(arch, "train_4k")] = cell_train(arch, dmesh, launches)
                torch.cuda.empty_cache()
            params = tf.init_params(torch.Generator(
                device="cuda").manual_seed(17), cfg)
            batch = {input_key(cfg): lm_inputs(cfg, (1, 32768), 21)}
            meas[(arch, "prefill_32k")] = cell_prefill(cfg, dmesh, params,
                                                       batch, launches)
            for shape in serve[1:]:
                meas[(arch, shape)] = cell_decode(
                    cfg, shape, plan[shape][1], dmesh, params, launches)
                torch.cuda.empty_cache()
            if arch in F8_DECODE:
                check_f8_decode(cfg, plan["decode_32k"][1], dmesh, params,
                                meas[(arch, "decode_32k")], launches)
            del params
            torch.cuda.empty_cache()
            check_prefill_32k_f32(cfg, batch, F32_LAYERS.get(arch, 2))
            if arch in GRAD_ARCHS:
                check_grads_f32(cfg)
            torch.cuda.empty_cache()
            log(f"phase 17(b): {arch}'s cells and checks took "
                f"{time.perf_counter() - t0:.1f} s")
        op_dispatch_cost()
    finally:
        dist.destroy_process_group()
    recs = dry.records()
    for (arch, shape, mesh), rec in recs.items():
        if mesh != "single":
            continue
        row = roofline.analyze(rec)
        wire = {k: round(v / 2**20, 1) for k, v in
                rec["collectives"]["wire_bytes"].items()}
        log(f"phase 17(a): dry run {arch}@{shape}@single (256 fake "
            f"ranks, {rec['run_s']} s): per-device peak "
            f"{rec['memory']['peak_bytes'] / 2**30:.2f} GiB, arguments "
            f"{rec['memory']['argument_bytes'] / 2**30:.2f} GiB, flops "
            f"{rec['cost']['flops']:.4e}, bytes {rec['cost']['bytes']:.4e}, "
            f"wire MiB {wire}, collectives {rec['collectives']['counts']}; "
            f"roofline (H100 data sheet, predicted): compute "
            f"{row['t_compute_ms']:.2f} ms, memory {row['t_memory_ms']:.2f} "
            f"ms, collective {row['t_collective_ms']:.2f} ms, "
            f"{row['bottleneck']}-bound, useful {row['useful_ratio']:.3f}, "
            f"roofline {row['roofline_frac']:.1%}")
    for (arch, shape), m in meas.items():
        rec = recs[(arch, shape, "local")]
        bound = max(rec["cost"]["flops"] / roofline.PEAK_FLOPS,
                    rec["cost"]["bytes"] / roofline.HBM_BW)
        log(f"phase 17: {arch} {shape} on one card at {rec['n_layers']} "
            f"layers, batch {CELL_PLAN[arch][shape][1]}: measured "
            f"{m['s'] * 1e3:.2f} ms a step, {m['tokens_s']:.1f} tokens/s, "
            f"peak {m['peak'] / 2**30:.2f} GiB; the dry run's local cell "
            f"({rec['run_s']} s) predicts peak "
            f"{rec['memory']['peak_bytes'] / 2**30:.2f} GiB, "
            f"{rec['cost']['flops']:.4e} flops, "
            f"{rec['cost']['bytes']:.4e} bytes, a roofline bound of "
            f"{bound * 1e3:.2f} ms ({bound / m['s']:.1%} of the measured "
            f"step)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=DEPLOY_REQUESTS,
                    help="requests of the deployment-size replay (phase 3)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"phase 0: built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    dry = DryRuns()
    try:
        return run_phases(args, t0, dry)
    finally:
        dry.stop()


# --- phase 18: fig_realworld ---------------------------------------------------
REALWORLD_REQUESTS = 625      # phase 18's trace, cut from 1,000,000


def phase_realworld(launches: dict) -> None:
    """``fig_realworld.run`` at REALWORLD_REQUESTS requests, every section;
    its LRU and eq.-16 roster rows again through the plain versions, bit
    for bit."""
    from repro_torch.core import PolicyParams, simulate_stream
    from repro_torch.figures import fig_realworld

    res = {}
    rows, _, lc = drive(
        f"phase 18: fig_realworld.run(n_requests={REALWORLD_REQUESTS})",
        lambda c: fig_realworld.run(n_requests=REALWORLD_REQUESTS,
                                    counters=c, results=res),
        EQ16_RUN + ("ranking_scores",))
    add_launches(launches, lc)
    sections = {}
    for r in rows:
        sections[r["section"], r["mode"]] = sections.get(
            (r["section"], r["mode"]), 0) + 1
    want = {("roster", "stream"): len(fig_realworld.POLICY_SET),
            ("overhead", "device"): 1, ("overhead", "stream_auto"): 1,
            ("compaction", "stream"): 2 * len(fig_realworld.PROBE_TOP_K),
            ("compaction", "stream_slots"): 2}
    if sections != want:
        raise AssertionError(f"fig_realworld rows by section {sections} != "
                             f"{want}")
    stream, cap = res["roster_stream"]
    for pol in ("lru", "stoch_vacdh"):
        plain, _, _ = drive(
            f"phase 18: roster {pol} through the plain versions",
            lambda c, pol=pol: simulate_stream(
                stream, cap, pol, PolicyParams(omega=1.0), estimate_z=True,
                chunk_size=fig_realworld.CHUNK_SIZE, use_kernel="ref",
                counters=c))
        if not same_result(plain, res["roster", "stream", None, pol]):
            raise AssertionError(f"fig_realworld roster {pol}: kernels "
                                 f"{res['roster', 'stream', None, pol]} != "
                                 f"plain {plain}")
    for r in rows:
        log(f"phase 18: {r['section']} {r['mode']} {r.get('top_k', '')} "
            f"{r['policy']}: improvement {r.get('improvement_vs_lru')}, "
            f"hit ratio {r.get('hit_ratio')}, {r['req_per_s']} req/s")
    log(f"phase 18: every section's rows present; roster LRU and eq. 16 "
        f"kernels == plain bitwise")


# --- phase 19: the example modules --------------------------------------------
EX_QS_REQUESTS = 1_250        # quickstart's trace, cut from 30,000
EX_MC = 200_000               # quickstart's Monte-Carlo draws, its own n
EX_TS_REQUESTS = 1_000        # trace_sim's surrogate, cut from 50,000
EX_HIER_REQUESTS = 500        # hierarchy_sim's trace, cut from 30,000
EX_AB_REQUESTS = 1_000        # serve_engine's A/B, cut from 20,000
EX_TRAIN_STEPS = 10           # train_small, cut from 200; preempted at 5
EX_SKIP = ("route", "trainer", "where", "wall_s", "tok_s", "first_call_s",
           "later_tok_s", "tokens_s")


def flat_numbers(x, path="") -> dict:
    """Every number of an example's result (nested dicts, lists, result
    dataclasses and named tuples; tensors as raw bytes, so equal means bit
    for bit), by path; host timings, routes and the device's name left
    out."""
    import dataclasses
    import numbers
    import numpy as np
    import torch
    if isinstance(x, dict):
        items = x.items()
    elif isinstance(x, (list, tuple)) and not hasattr(x, "_asdict"):
        items = enumerate(x)
    elif hasattr(x, "_asdict"):
        items = x._asdict().items()
    elif dataclasses.is_dataclass(x):
        items = ((f.name, getattr(x, f.name)) for f in dataclasses.fields(x))
    elif isinstance(x, torch.Tensor):
        return {path: (x.dtype, tuple(x.shape), x.cpu().numpy().tobytes())}
    elif isinstance(x, np.ndarray):
        return {path: (x.dtype, x.shape, x.tobytes())}
    elif isinstance(x, (numbers.Number, str)) or x is None:
        return {path: x}
    else:
        return {path: repr(x)}
    out = {}
    for k, v in items:
        if k not in EX_SKIP:
            out.update(flat_numbers(v, f"{path}/{k}"))
    return out


def example_replays() -> list:
    """19(a)-(c): (label, ``run(use_kernel, counters)``, the kernels the
    kernel run must launch) of each replay example."""
    from repro_torch.examples import hierarchy_sim, quickstart, trace_sim
    return [
        (f"quickstart.run(n_requests={EX_QS_REQUESTS})",
         lambda mode, c: quickstart.run(use_kernel=mode, counters=c,
                                        n_mc=EX_MC,
                                        n_requests=EX_QS_REQUESTS),
         EQ16_RUN),
        (f"trace_sim.run(n_requests={EX_TS_REQUESTS})",
         lambda mode, c: trace_sim.run(use_kernel=mode, counters=c,
                                       n_requests=EX_TS_REQUESTS),
         EQ16_RUN),
        (f"hierarchy_sim.run(n_requests={EX_HIER_REQUESTS})",
         lambda mode, c: hierarchy_sim.run(use_kernel=mode, counters=c,
                                           n_requests=EX_HIER_REQUESTS),
         REPLAY_RUN)]


def examples_plain(conn) -> None:
    """19(a)-(c) through the plain versions, in a process of its own:
    sends back ("ok", each run's ``flat_numbers``) or ("error", the
    traceback)."""
    try:
        outs = []
        for label, fn, _ in example_replays():
            out, _, _ = drive(f"phase 19: {label}(use_kernel='ref')",
                              lambda c, fn=fn: fn("ref", c))
            outs.append(flat_numbers(out))
        conn.send(("ok", outs))
    except BaseException:
        import traceback
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def lm_launches(label: str, fn, want: dict, launches: dict):
    """An LM run from zeroed counts: it must launch each kernel of
    ``want`` exactly that many times (a plain run, ``want`` empty,
    none)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lc = launch_counts()
    log(f"phase 19: {label}: {dt:.2f} s, launches {lc}")
    for k, n in want.items():
        if lc[k] != n:
            raise AssertionError(f"{label} launched {k} {lc[k]} times, "
                                 f"not {n}")
    if not want and any(lc.values()):
        raise AssertionError(f"{label} launched kernels: {lc}")
    add_launches(launches, {k: lc[k] for k in want})
    return out, lc


def close_losses(label: str, got, want) -> float:
    """Loss histories within PERF.md's train bound (atol 1e-5 + rtol
    1e-4); returns the largest |difference|."""
    worst = max(abs(g - w) for g, w in zip(got, want))
    if len(got) != len(want) or not all(
            abs(g - w) <= 1e-5 + 1e-4 * abs(w) for g, w in zip(got, want)):
        raise AssertionError(f"{label}: losses {got} != {want}")
    return worst


def phase_examples_train() -> tuple:
    """19(e): ``train_small`` (lm-100m, bf16, 2 microbatches of 4 x 256)
    for EX_TRAIN_STEPS steps through the kernels; the same run preempted
    at step 5 (SIGTERM, its blocking save) and resumed; then f32 runs
    through the kernels and the plain versions.  Returns (the bf16 run's
    output, its flash_attention launches)."""
    import signal
    import tempfile
    from repro_torch.examples import train_small

    quiet = lambda msg: None
    cfg = train_small.model_config()
    with tempfile.TemporaryDirectory() as d:
        flash = cfg.n_layers * 2 * EX_TRAIN_STEPS   # a layer a microbatch
        full, lc = lm_launches(
            f"train_small.run(steps={EX_TRAIN_STEPS})",
            lambda: train_small.run(steps=EX_TRAIN_STEPS, log_every=1,
                                    ckpt_dir=f"{d}/a", log_fn=quiet),
            {"flash_attention": flash}, {})
        want = [h["loss"] for h in full["history"]]

        def preempt(msg):
            if msg.startswith("[trainer] step 5:"):
                os.kill(os.getpid(), signal.SIGTERM)

        old = signal.getsignal(signal.SIGTERM)
        try:
            first = train_small.run(steps=EX_TRAIN_STEPS, log_every=1,
                                    ckpt_dir=f"{d}/b", log_fn=preempt)
        finally:
            signal.signal(signal.SIGTERM, old)
        rest = train_small.run(steps=EX_TRAIN_STEPS, log_every=1,
                               ckpt_dir=f"{d}/b", log_fn=quiet)
        if not (first["preempted"] and first["final_step"] == 5
                and rest["start_step"] == 5
                and rest["final_step"] == EX_TRAIN_STEPS):
            raise AssertionError(f"preempt and resume: {first['final_step']}"
                                 f" -> {rest['start_step']} -> "
                                 f"{rest['final_step']}")
        got = [h["loss"] for h in first["history"] + rest["history"]]
        worst = close_losses("the resumed run", got, want)
        log(f"phase 19: train_small preempted at step 5 and resumed: losses "
            f"{'bit for bit' if got == want else f'within {worst:.3e}'} of "
            f"the uninterrupted run's {[round(x, 4) for x in want]}; "
            f"{full['tokens_s']:.1f} train tokens/s, {full['n_params']} "
            f"parameters")
        f32 = {}
        for mode in (True, "ref"):
            f32[mode], _ = lm_launches(
                f"train_small.run(f32, use_kernel={mode!r})",
                lambda mode=mode: train_small.run(
                    use_kernel=mode, steps=EX_TRAIN_STEPS, ckpt_dir=f"{d}/"
                    f"f32{mode}", log_every=1, log_fn=quiet,
                    dtype="float32"),
                {"flash_attention": flash} if mode is True else {}, {})
        losses = {m: [h["loss"] for h in r["history"]]
                  for m, r in f32.items()}
        worst = close_losses("f32 kernels vs plain", losses[True],
                             losses["ref"])
        log(f"phase 19: train_small f32 losses, kernels vs plain: max "
            f"|diff| {worst:.3e} (bound 1e-5 + 1e-4 |loss|)")
    return full, lc


def phase_examples(launches: dict) -> None:
    """19: each ``repro_torch.examples`` module's ``run()`` at a cut,
    through the kernels and through the plain versions on the card; the
    plain replays of (a)-(c) in a second process beside the rest."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    child = ctx.Process(target=examples_plain, args=(send,))
    child.start()
    send.close()
    try:
        kern = []
        for label, fn, needs in example_replays():
            out, _, lc = drive(f"phase 19: {label}(use_kernel=True)",
                               lambda c, fn=fn: fn(True, c), needs)
            add_launches(launches, lc)
            kern.append((label, out))
        examples_report(*(out for _, out in kern))
        phase_examples_serve(launches)
        full, lc = phase_examples_train()
        add_launches(launches, {"flash_attention": lc["flash_attention"]})
        status, plain = recv.recv()
    finally:
        child.join(timeout=60)
        if child.is_alive():
            child.terminate()
            child.join()
    if status != "ok":
        raise AssertionError(f"phase 19's plain runs failed:\n{plain}")
    for (label, out), b in zip(kern, plain):
        a = flat_numbers(out)
        bad = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
        if bad:
            raise AssertionError(f"{label}: kernels != plain at {bad[:10]}")
        log(f"phase 19: {label}: kernels == plain, {len(a)} numbers bit "
            f"for bit")
    h = full["history"]
    log(f"phase 19: train_small: loss {h[0]['loss']:.3f} -> "
        f"{h[-1]['loss']:.3f} over {full['final_step']} steps")


def examples_report(qs: dict, ts: dict, hs: dict) -> None:
    """19(a)-(c)'s numbers; the Monte-Carlo moments within 4 standard
    errors of Theorem 2 and the scoring routes checked."""
    import torch
    from repro_torch.core.delay_stats import mc_aggregate_delay
    from repro_torch.examples import quickstart
    t2 = qs["theorem2"]
    log(f"phase 19: quickstart: Theorem 2 E[D] {t2['mean']:.4f} (MC "
        f"{t2['mean_mc']:.4f}), Var {t2['var']:.4f} (MC {t2['var_mc']:.4f}); "
        f"eq. 16 over LRU {qs['improvement'] * 100:.3f}%; routes "
        f"{ {p: r['route'] for p, r in qs['sim'].items()} }, Erlang row "
        f"{qs['erlang']['route']}")
    # the run's own draws again (the same generator and seed): each moment
    # within 4 standard errors of Theorem 2, as the CPU test holds it
    d = mc_aggregate_delay(torch.Generator(device="cuda").manual_seed(0),
                           quickstart.LAM, quickstart.Z, EX_MC).double()
    n, var = d.numel(), float(d.var(correction=0))
    se = {"mean": (var / n) ** 0.5,
          "var": ((float(((d - d.mean()) ** 4).mean()) - var * var) / n)
          ** 0.5}
    for k in ("mean", "var"):
        if abs(t2[f"{k}_mc"] - t2[k]) > 4 * se[k]:
            raise AssertionError(f"Monte-Carlo {k} {t2[f'{k}_mc']} is not "
                                 f"within 4 standard errors ({se[k]}) of "
                                 f"Theorem 2's {t2[k]}")
    log(f"phase 19: Monte-Carlo moments within "
        f"{abs(t2['mean_mc'] - t2['mean']) / se['mean']:.2f} and "
        f"{abs(t2['var_mc'] - t2['var']) / se['var']:.2f} standard errors")
    if qs["erlang"]["route"] != "epilogue" or \
            qs["sim"]["stoch_vacdh"]["route"] != "ranking kernel":
        raise AssertionError(f"routes: {qs['sim']} {qs['erlang']}")
    imp = {p: round(r["improvement"] * 100, 3)
           for p, r in ts["policies"].items()}
    log(f"phase 19: trace_sim ({ts['trace']}, {ts['n_requests']} "
        f"requests): improvement over LRU (%) {imp}")
    imp = [(r["l2_capacity"], round(r["improvement"] * 100, 3))
           for r in hs["grid"]]
    log(f"phase 19: hierarchy_sim: improvement over LRU (%) by L2 "
        f"capacity {imp}")


def phase_examples_serve(launches: dict) -> None:
    """19(d): ``serve_engine.run`` through the kernels and the plain
    versions, the A/B's every ``EngineStats`` field equal; phase 5's f32
    logits check on two of its prompts."""
    from repro_torch.examples import serve_engine
    cfg, params = serve_engine.smoke_model()
    want = {"flash_attention": cfg.n_layers * serve_engine.N_PROMPTS,
            "decode_attention": cfg.n_layers * serve_engine.N_PROMPTS
            * (serve_engine.MAX_NEW - 1)}
    runs = {}
    for mode in (True, "ref"):
        runs[mode], lc = lm_launches(
            f"serve_engine.run(n_requests={EX_AB_REQUESTS}, "
            f"use_kernel={mode!r})",
            lambda mode=mode: serve_engine.run(use_kernel=mode,
                                               n_requests=EX_AB_REQUESTS),
            want if mode is True else {}, launches)
        if mode is True:
            for k in ("ranking_victim_order", "lane_scatter"):
                if lc[k] <= 0:
                    raise AssertionError(f"serve_engine did not launch {k}")
                launches[k] = launches.get(k, 0) + lc[k]
    if runs[True]["ab"] != runs["ref"]["ab"]:
        raise AssertionError(f"serve_engine A/B: kernels {runs[True]['ab']} "
                             f"!= plain {runs['ref']['ab']}")
    rm = runs[True]["real_model"]
    same = sum(a == b for qa, qb in zip(rm["outputs"],
                                        runs["ref"]["real_model"]["outputs"])
               for a, b in zip(qa, qb))
    ab = {p: round(s["total_latency"], 3) for p, s in runs[True]["ab"].items()}
    log(f"phase 19: serve_engine: {rm['tok_s']:.1f} tok/s (first prefill "
        f"call {rm['first_call_s']:.3f} s, the rest {rm['later_tok_s']:.1f} "
        f"tok/s); greedy tokens equal to the plain run's: {same} of "
        f"{rm['tokens']}; A/B kernels == plain in every EngineStats field, "
        f"total latency {ab}")
    check_f32(19, cfg, params, rm["prompts"][:2])


def check_mirrors() -> list:
    """Make every engine hold, as it returns its results, its host mirror
    against its device state: the ``cached`` and ``in_flight`` bits and
    ``complete_t``, bit for bit.  Returns a one-element list counting the
    checks."""
    import numpy as np
    from repro_torch.core import simulator
    done = [0]
    result = simulator._Engine.result

    def checked(self):
        out = result(self)
        bits = self.st.flags.cpu().numpy()
        ct = self.st.values[0].cpu().numpy()
        bad_bits = int((bits != self.m_bits).sum())
        bad_ct = int((ct.view(np.int32) != self.m_ct.view(np.int32)).sum())
        if bad_bits or bad_ct:
            raise AssertionError(f"host mirror != device state: {bad_bits} "
                                 f"bits and {bad_ct} complete_t differ")
        done[0] += 1
        return out

    simulator._Engine.result = checked
    return done


def run_phases(args, t0, dry) -> int:
    import torch
    phase_s = {}

    def timed(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[name] = round(time.perf_counter() - t, 1)
        log(f"phase {name}: {phase_s[name]} s")
        return out

    timings = timed("1", phase_kernels)
    timings.update(timed("4", phase_attention))
    mirrors = check_mirrors()
    launches, grids = {}, {}
    timed("2", phase_paper, launches)
    timed("3", phase_deploy, args.requests, launches)
    timed("5", phase_serve, 5, SERVE_ARCH, launches, max_new=SERVE_NEW)
    gla = timed("6", phase_gla)
    timings["gla_chunk"] = gla["xlstm-350m"]
    timed("7", phase_serve, 7, "xlstm-350m", launches, max_new=SERVE_NEW)
    timed("8", phase_serve, 8, "hymba-1.5b", launches, max_new=HYMBA_NEW)
    timed("9a", phase_grid_fig2, launches, grids)
    timed("9b", phase_grid_deploy, GRID_REQUESTS, launches)
    timed("10", phase_stream, launches, grids)
    timed("11", phase_slots, launches)
    timed("12", phase_hier, launches)
    timed("13", phase_serving, launches)
    timed("14", phase_fabric, launches)
    timed("15", phase_moe_serve, launches)
    timed("16", phase_train, launches)
    timed("17", phase_cells, launches, dry)
    timed("18", phase_realworld, launches)
    timed("19", phase_examples, launches)
    log(f"seconds by phase: {phase_s}")
    log(f"host mirrors equal to the device state at the end of "
        f"{mirrors[0]} replays")
    log(f"launches over the main-path runs of phases 2-3, 5 and 7-19: "
        f"{launches}")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s")

    meta = {
        "ranking_victim_order": ("kernels/csrc/ranking_score.cu",
                                 "src/repro/kernels/ranking_score.py:115"),
        "ranking_scores": ("kernels/csrc/ranking_score.cu",
                           "src/repro/kernels/ranking_score.py:44"),
        "lane_scatter": ("kernels/csrc/lane_scatter.cu",
                         "src/repro/kernels/lane_scatter.py:81"),
        "point_update": ("kernels/csrc/point_update.cu",
                         "src/repro/kernels/lane_scatter.py:95"),
        "flash_attention": ("kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:79"),
        "decode_attention": ("kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:72"),
        "gla_chunk": ("kernels/csrc/gla_chunk.cu",
                      "src/repro/kernels/gla_chunk.py:81"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        tm = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/" + src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": tm["max_abs_err"], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm.get("bound_by", "bytes"),
            "library_ms": tm["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
