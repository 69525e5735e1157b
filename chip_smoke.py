#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device and the
CUDA toolkit.  Phases, in order; any failure exits non-zero:

1. build   — compile every CUDA source of `src/repro_torch/csrc/` with
             nvcc (one process per source, all at once) into
             `build/kernels/`; print the build time and the card's name
             and power limit.
2. kernels — call each kernel's wrapper at the main path's shapes and
             hold it against its plain PyTorch version on the same
             inputs, exactly (integer outputs); time both.
             `nsga2_evolve` (every NSGA-II generation of an explore
             dispatch in one launch) is held against the composite loop
             `nsga2.evolve_composite` on the card, on the same draws:
             final genes, objectives and ranks bit-equal, for the 16 kb
             cell at pop 256 x 80 generations (the request's dispatch,
             where both are timed), the codesign pick's pop 96 x 25, a
             4096 / 16384 / 65536 batch, pop 100 (padded rank words), pop
             512 (rank words in device memory) and pop 1024 (all state in
             device memory); the fronts it peeled are its latency count.
             `route_slots`
             (every net slot of a layout bucket in one launch) is held
             against `route_slots_ref` on the 16 kb request's bucket (86
             grids padded to 1118 x 274, its real nets) at 20 % seeded
             random occupancy cut to its first 8 slots, where both are
             timed, and on a bucket of the 65536 array's 241 x 2178
             (coarse 32: counts and bitsets in device memory) and
             122 x 1090 (coarse 64: counts in device memory) grids with
             4 random slots, and on a bucket past 32,767 masked targets
             a grid (uint32 counts) against `route_slots_ref`; then
             timed alone on the whole bucket
             (`bucket_ms`); the standalone `wavefront` on the same grids
             (with its BFS levels and ms a level) and on 241 x 2178 and
             122 x 1090, `trace_paths` on one slot of them; `nds_rank`
             at (3, 512, 4) and (1, 2048, 4), timed at (1, 512, 4) by
             events and by the profiler's device time.  `acim_matmul` has three routes, each held to the
             plain version at the trainer's FFN shapes, (1024, 768) @
             (768, 3072) and (1024, 3072) @ (3072, 768): the wgmma route
             (tensor cores on an exact bf16 term split, split-K on the
             second shape) with the codesign pick's (N, B) and with N =
             128, B = 5; the mma route (`mma.sync` on the same split, a
             chunk the lanes of a k8 step, the ADC in three
             instructions) at N 8 / B 3, N 4 / B 2 and N 2 / B 1; the
             cuda_core route at all of those and at N 24 / B 3:
             bit-equal on +-1 operands, and on mismatch-folded weights,
             with +-1 and with float activations, equal but for ADC flips
             (a whole number of deltas each) on at most 0.1 % of outputs;
             all timed on the trainer's operands, two routes at one N in
             turns, f32 and bf16 torch.matmul printed beside as a
             scale.  `dominance_matrix` is held to its plain
             version at five shapes and timed by events and by the
             profiler's device time, with the launch floor.
             Flash attention has two routes: bf16 at head dims 64 and
             128 runs `flash_attention_wgmma` (tensor cores), held
             against `flash_attention_tc_ref`: the kernel's own bf16 P
             (dumped by a second launch) one bf16 step at most from the
             plain version's, the plain version fed that P within two
             bf16 ulps of every output element plus 2e-5, and against
             the plain version's own P at most 1e-4 of the outputs
             beyond that, each within one ulp of its row's largest
             (see `_tc_check`; at 32768 the last check only); against
             the float32-P plain versions within rel L2 1e-2; f32, and
             bf16 at head dims 16 and 32, run `flash_attention` (3xTF32
             on tensor cores), held against `flash_attention_ref` and the
             naive one (f32 within atol = rtol = 2e-5, bf16 within one
             output ulp plus 2e-5).  Cases: (4, 4096, 16 heads, 2 KV
             heads, 128) in bf16 and f32, with a prefix, S 4001, head dims
             16-64.  At the prefill's shape, (1, 32768, 16, 2, 128)
             causal, the 3xTF32 kernel in float32 (its own case) and the
             bf16 kernel in bf16, each through its own wrapper, against
             their blockwise plain versions, and the 3xTF32 kernel in
             bf16 at head dim 32; then each with the library yardstick
             `scaled_dot_product_attention` in the same dtype (float32
             forced to the memory-efficient backend, KV repeated) timed
             in one call, in turns.
3. path    — `DesignSession().run(DesignRequest(array_size=16384))` at
             the full default budget (pop 256, 80 generations, coarse
             64, capacity 4): the front must lie inside the golden
             exhaustive front and cover >= 60 % of it, and every layout
             row must equal the golden row of its spec (integers
             exactly, floats to rtol 1e-6); the explore dispatch must be
             exactly one `nsga2_evolve` launch and no `nds_rank`, and its
             front must equal that of the composite loop run on the card
             from the same seed.  Then one `use_pallas_dominance=True,
             layout=False` request drives the dominance-matrix route (the
             composite loop: no `nsga2_evolve`).  Each path runs with the
             launch counts zeroed just before it and read just after;
             every kernel must have launched on its path: the layout
             exactly one `route_slots` and no `wavefront` or
             `trace_paths`.  The BFS levels of the grid with the most (the
             launch's latency count) are printed.  Last,
             `DesignSession().layout([MacroSpec(8, 16384, 1, 1)])`, a
             spec of 49,160 masked targets (uint32 counts), is laid out
             on the card, timed, with its routed / failed nets.
4. train   — the CIM-in-the-loop trainer at full width (d 768, 12
             layers, 12 heads, d_ff 3072, vocab 2048, seq 128, batch 8,
             lr 3e-3): `recommend_macro` at the example's settings, whose
             pick must be a point of the golden exhaustive front meeting
             the 3 dB floor (its energy-delay rank among those points is
             printed), then 20 SGD steps whose losses must be finite and
             end below the first.  Launch counts, zeroed before the pick
             and read after the last step: `acim_matmul` 24 per forward,
             all on the wgmma route, `nsga2_evolve` > 0.  Then step 0's
             loss on the card is held against the plain PyTorch run on
             the CPU of the same weights,
             batch and mismatch draws, at full width and 2 layers (rtol
             1e-2: the bfloat16 backbone rounds differently on the two
             devices, and a rounding can flip a binarized activation).
             Then the mma route's path: 20 steps of the same trainer at
             full width on MacroSpec(128, 8, 16, 3) (N 8, B 3, a point
             of the 1 kb exhaustive front): finite losses (whether the
             last is below the first is printed: a 3-bit ADC over 8
             products is no claim to train as the pick does), exactly
             24 x 20 `acim_matmul_mma` launches and no other
             `acim_matmul` route, the step ms beside the pick's; and the
             step-0 check on that macro, 2 `acim_matmul_mma` launches
             per layer.
5. prefill — `make_prefill_step(qwen2.5-3b, prefill_32k)` at full width
             (36 layers, d 2048, vocab 151,936) with bf16 serving
             weights drawn from seed 0 on the card, on synthetic tokens
             at batch 1 x 32768 (the shape's batch of 32 cut to 1: its
             logits alone are 9.96 GB a sequence): a warm-up prefill and
             a timed one, then batch 4 x 4096.  Logits must be finite and
             each prefill must launch `flash_attention_wgmma` 36 times
             (and no 3xTF32 launch).  Then
             one full-width layer at S 4096: `attention_fwd_blockwise`
             against the dense `attention_fwd` (rel L2 2e-2: the dense
             path rounds scores and probabilities to bf16); and a
             2-layer full-width model at seq 512 with the same weights
             (drawn on the card, copied) on the card and on the CPU: last-position logits
             within rel L2 5e-2 (both backbones are bf16), argmax
             agreement printed.  Last, the 3xTF32 route's path: the
             reduced qwen2.5 (head dim 16) prefill at 2 x 300 on the
             card, one 3xTF32 launch per layer, logits within rel L2
             5e-2 of the CPU run.
6. service — the multi-tenant `DesignService` over `DesignSession` on
             the card: `DesignService(max_coalesce=4, coalesce_window_s=
             0.05, layout_workers=4)` over a session with an artifact
             cache in a temporary directory under `build/` (removed at
             the end) is `serve()`d eight tickets at the default budget
             (`service_requests`: 16384 seeds 0-3, three of them with
             requirements, 4096 seeds 0 and 1, 65536 front only, and a
             poison ticket), so the explore worker's `nsga2_evolve` and
             four pool workers' `route_slots` launch from several
             threads on the one default stream.  Every artifact must
             equal a second session's `run_many(strict=False)`, the
             poison ticket must fail with the requirements message, and
             the 16384 seed-0 artifact must equal golden as in phase 3.
             Launches, zeroed before and read after: `nsga2_evolve` ==
             explore dispatches, `route_slots` == layout attempts, no
             `nds_rank` / `wavefront` / `trace_paths`.  Then a fresh
             service and session over the same cache serve the seven
             good tickets from it with zero launches; a third service
             with `FailureInjector(fail_at={"layout": [0]})` serves two
             16384 tickets with one bucket retry to the same rows (the
             fault fires ahead of the dispatch, so `route_slots`
             launches once a bucket, on its retry); and the traffic
             again under the profiler for the device-to-host copies'
             share of the layout pool's busy time.  Printed with the
             card's name and power limit: requests/s, ticket latency
             p50 / p99, the explore/layout overlap fraction, each
             stage's busy seconds and the launches.
7. layout engines — (a) the 16 kb request's whole-front bucket (86
             specs padded to 1118 x 274, 576 net slots, 13,200 real nets;
             coarse 64, capacity 4) laid out by the concurrent engine
             (`generate_layouts(engine="concurrent")` on the card, its
             schedule recorded): rows equal to golden, occupancy and rows
             equal to the scan engine's on the same bucket, timed beside
             it; launches exactly one `wavefront` per round that had BFS
             lanes and no `route_slots`; its rounds, collisions,
             crossings, BFS lanes and bytes copied back printed.  (b)
             `flow.generate_layout(spec)` on the card for the FLOW_SPECS
             specs of the front with the largest grids: metrics (but the
             clock) equal to the golden row, wires totalling the
             wirelength, exactly one `wavefront` launch per net of two or
             more pins; seconds per spec; then `wavefront` against its
             plain version and timed at that per-net shape (1, 122, 274),
             with its BFS levels and ms a level.
             Launches zeroed before each run and read after it.
8. mesh    — the device-mesh explorer on the one card, a mesh being a
             tuple of device positions: (a) sharded cells, (4096, 0),
             (16384, 0) and (65536, 0) at pop 256 x 80 on ("cuda:0",) and
             ("cuda:0", "cuda:0"): final genes and objectives exactly
             those of `sweep_program`, fronts those of `explore_cells`,
             one `nsga2_evolve` launch a position; (b) islands 8,
             migrate_every 10, pop 96, 60 generations on (16384, 0) on
             1, 2, 4 and 8 positions: the same rows each time, inside the
             golden exhaustive front covering >= 0.8 of it, facts "ring"
             with 5 rounds, 6 `nsga2_evolve` and 5 `nds_rank` launches a
             position; `nds_rank` at the migration shape (8, 96, 4)
             against plain, timed by events and by the profiler's device
             time, with its bound; (c)
             `DesignSession().run(DesignRequest(16384, islands=4))`:
             layout rows equal to golden, provenance "ring", 3 rounds;
             the island dispatch timed against the single-island explore
             of the cell, in turns; (d) `DesignService(mesh=("cuda:0",
             "cuda:0"))` serves two island tickets and one plain one,
             equal to `run_many`, `design_mesh_dispatches_total` >= 1.
             The peer copy of the ring between two cards is not run here.
9. decode  — qwen2.5-3b at full width with phase 5's bf16 weights:
             `ServeEngine` answers 6 requests through 4 slots (prompts of
             16-64 seeded ids, max_new 32, two at temperature 0.8), with
             ms a step and tokens per second; then `decode_step` under
             teacher forcing against the prefill's logits
             (`flash_attention_wgmma`, 36 launches) on one 64-token
             sequence: rel L2 <= 5e-2 at every position and top-1 equal
             at >= 0.9 of them.  The script's wall time is printed
             before phase 8 and after phase 9.
10. train  — the training stack on qwen2.5-3b at full width (3.397 G
             float32 master parameters drawn from seed 0 on the card, the
             serving weights of phases 5 and 9 freed first): (a) `make_train_step(remat=True)`
             with the default AdamW for 5 steps of `SyntheticStream`
             batches at the launcher's defaults (8 x 256), then 2 steps of
             `train_4k` cut to 4 sequences with its 4 microbatches: ms a
             step, tokens/s, peak memory, finite losses and grad norms, no
             launch of a kernel of ours (the reference's train step runs
             no Pallas kernel), and step 0's loss within TRAIN_CE_RTOL of
             the CE of its batch through the prefill path (blockwise
             attention, `flash_attention_wgmma`) on the bf16 cast of the
             same weights; then one step at 8 x 256 without remat (the
             launcher's default): whether it fits, and its peak memory;
             (b) 2 layers at full width, 2 x 64 tokens, one
             step from the same state: the card against the CPU, two
             microbatches against one, remat against none (bit-equal
             expected; else measured and bounded): loss, grad norm and
             every updated parameter within the TRAIN_CHECK_* bounds;
             (c) the reduced config's `train()` preempted through
             `PreemptionGuard` after step 3 of 6 and resumed from its
             checkpoint: losses bitwise equal to an uninterrupted run; a
             checkpoint written and read back by the port: every tensor
             equal.
11. moe    — the MoE family (every earlier phase's weights freed first):
             deepseek-v2-lite-16b at full width and depth (27 layers,
             16.21 G bf16 parameters drawn from seed 0 on the card) and
             arctic-480b at full width cut to one layer.  (a) MLA's
             prefill attention, `flash_attention_wgmma` at q/k head dim
             192 and v 128, held to `flash_attention_tc_ref` by
             `_tc_check` with its dumped P at (1, 4001), (1, 129) causal
             and (2, 777) full, 16 heads, on q / k / v built as
             `mla_fwd_blockwise` builds them from layer 0 and on a q read
             through strides; at (1, 32768, 16, 16) causal against the
             plain version's own P, then timed in turns with SDPA: ms,
             TFLOP/s, the share of its bound and the ratio to SDPA.  (b)
             `make_prefill_step` at prefill_32k cut to batch 1 (a warm-up
             and a timed prefill), then 4 x 4096: finite logits, exactly
             27 launches of the (192, 128) instantiation each and no
             3xTF32 launch.  (c) `ServeEngine` on the same weights,
             phase 9's six requests.  (d) teacher-forced `decode_step`
             against the prefill on 64 tokens: positions whose routes
             differ, whose claims the prefill dropped, or whose router
             choice is a near tie are counted; the rest held to phase 9's
             bounds.  (g) `moe_fwd_a2a` on 1, 2 and 4 positions of the
             card at layer 0's MoE against `moe_fwd_dense_eval` (rel L2
             1e-2), the same bits on every count.  (e) 2 layers at full
             width, seq 512, weights drawn on the CPU, card against CPU:
             claims routed alike, last-position logits (rel L2 5e-2),
             argmax.  (f) arctic's one layer (13.6 G parameters drawn on
             the card): a 1 x 4096 prefill (one Dh-128 tensor-core
             launch) and 8 decode steps, finite logits.
12. vlm    — the VLM prefix family (every earlier phase's weights freed
             first): paligemma-3b at full width and depth (18 layers, d
             2048, 8 heads over 1 KV head at head dim 256, vocab 257,216,
             2.51 G bf16 parameters drawn from seed 0 on the card; the
             SigLIP tower a stub, 256 patch embeddings a sequence).  (a)
             `flash_attention_wgmma` at head dims (256, 256) (64-key
             tiles) held to `flash_attention_tc_ref` by `_tc_check` with
             its dumped P at (1, 4001) and (1, 129) causal with the
             256-patch prefix (at 129 the prefix covers every row) and
             (2, 777) full, 8 heads over 1 KV head, on q / k / v as layer
             0 builds them (q and k through RoPE's strides) and on a q
             read through strides; at (1, 33024, 8, 1) with the prefix
             against the plain version's own P, then timed in turns with
             itself at prefix 0 and SDPA (causal, no prefix, KV repeated
             to 8 heads): ms, TFLOP/s, the share of its bound and the
             ratio to SDPA.  (b) `make_prefill_step` at prefill_32k cut
             to batch 1 (256 patches + 32768 tokens; a warm-up and a
             timed prefill), then 4 x (256 + 4096): finite logits at
             every position, patches included, exactly 18 launches of
             the (256, 256) instantiation each and no 3xTF32 launch.
             (c) `ServeEngine` on the same weights, phase 9's six
             requests.  (d) teacher-forced `decode_step` (no prefix, as
             in the reference) against a prefill of the same 64 tokens
             without patches: phase 9's bounds.  (e) 2 layers at full
             width, 512 tokens after 256 patches, weights drawn on the
             CPU, card against CPU: last-position logits (rel L2 5e-2),
             argmax.  (f) the reduced config (head dim 16, 16 patches)
             at 2 x 300 on the card: one 3xTF32 launch a layer, logits
             within rel L2 5e-2 of the CPU run.
13. hybrid — the hybrid family (every earlier phase's weights freed
             first): zamba2-2.7b at full width and depth (54 Mamba2 layers
             in 9 groups of 6, one weight-shared attention + FFN block at
             the start of each group, 32 heads at head dim 80, 2.42 G
             bf16 parameters drawn from seed 0 on the card).  (a)
             `flash_attention_wgmma` at (80, 80) (exact tiles: a 64-column
             block and a 16-column tail) held to `flash_attention_tc_ref`
             by `_tc_check` with its dumped P at (1, 4001), (1, 129)
             causal, (2, 777) full and (1, 1000) with a 64-position
             prefix, 32 heads over 32 KV heads, q / k / v as the shared
             block builds them (q and k through RoPE's strides), and on a
             q read through strides; at (1, 32768, 32, 32) causal against
             the plain version's own P, then timed in turns with SDPA:
             ms, TFLOP/s, the share of its bound, the ratio to SDPA.  (b)
             `make_prefill_step` at prefill_32k cut to batch 1 (a warm-up
             and a timed prefill), then 4 x 4096: finite logits, exactly 9
             launches of the (80, 80) instantiation each and no 3xTF32
             launch; seconds, tokens/s, peak memory.  (c) `ServeEngine`
             on the same weights, phase 9's six requests.  (d)
             teacher-forced `decode_step` against a prefill of the same
             64 tokens: in float32 (backbone, caches, dense attention)
             within rel L2 1e-3 and every argmax equal; in bf16 within
             rel L2 0.15, top-1 >= 0.75 (the chunked SSD and the
             recurrence round apart, more with depth: see
             HYBRID_DECODE_RTOL).  (e) `make_serve_step` at long_500k
             (batch 1, 524,288 positions, 48.3 GB of shared caches): 8
             steps, finite logits, ms a step against the bytes bound,
             peak memory.  (f) One group (6 Mamba2 layers, one shared
             call) at full width, 512 tokens, the same weights on the
             card and on the CPU: last-position logits (rel L2 5e-2),
             argmax equal.  (g) The reduced config (shared attention at
             head dim 16, chunk 16) at 2 x 320 on the card: one 3xTF32
             launch per shared call, logits within rel L2 5e-2 of the CPU
             run.  The script's wall time is printed after phases 10-15.
14. dense  — the dense family's other configs (every earlier phase's
             weights freed first, each model freed before the next):
             qwen3-8b (36 layers, 32 heads over 8 KV heads, QK norm),
             codeqwen1.5-7b (32 layers, 32 heads over 32, QKV bias) and
             granite-34b (88 layers, 48 heads over 1, learned positions,
             LayerNorm, GELU MLP with biases; 34.17 G parameters, 68.3 GB
             of bf16 weights), each at full width and depth with bf16
             weights drawn from seed 0 on the card.  (a)
             `make_prefill_step` at prefill_32k cut to batch 1 (a warm-up
             and a timed prefill), then 4 x 4096 (granite's learned
             positions reach 4095 in every row): finite logits, exactly
             one `flash_attention_wgmma` (128, 128) launch a layer (36, 32
             and 88) and no 3xTF32 launch; seconds, tokens/s, peak
             memory.  (b) `ServeEngine` on the same weights cut to their
             first DENSE_SERVE_LAYERS layers, phase 9's six requests.
             (c) teacher-forced `decode_step` (granite's reads
             `pos_emb` at each step) against the prefill on 64 tokens:
             phase 9's bounds.  (d) 2 layers at full width, 512 tokens,
             the same weights on the card and on the CPU: last-position
             logits within rel L2 5e-2, argmax equal.
15. family train — the hybrid and VLM families' train steps (every
             earlier phase's weights freed first): zamba2-2.7b, then
             paligemma-3b, at full width and depth with float32 masters
             drawn from seed 0 on the card.  (a)
             `make_train_step(remat=True)` (zamba2: a checkpoint a group
             of 6 Mamba2 layers and its shared call, one a layer inside
             it) with the default AdamW for 5 steps at 8 x 256
             (paligemma's batches carry their 256 patches), then 2 steps
             of `train_4k` with its microbatches, cut to 8 sequences in 8
             for zamba2, to 4 in 4 for paligemma (at 8 its float32 CE
             over 257,216 entries runs out of memory: FAMILY_TRAIN): ms a
             step, tokens/s, peak
             memory, finite losses and grad norms, no launch of a kernel
             of ours, and step 0's loss against the CE of its batch
             through the prefill path (blockwise attention, the (80, 80)
             or (256, 256) instantiation) on the bf16 cast of the same
             weights, within TRAIN_CE_RTOL.  (b) one group of zamba2 (6 Mamba2
             layers, one shared call) and 2 layers of paligemma at full
             width, 2 x 64 tokens, one step each as phase 10 (b): the
             card against the CPU, two microbatches against one, remat
             against none, within the TRAIN_CHECK_* bounds.
16. audio and SSM — the audio and SSM families (every earlier phase's
             weights freed first), bf16 weights drawn from seed 0 on the
             card.  whisper-large-v3 at full width and depth (32 encoder
             and 32 decoder layers, 20 heads over 20 at head dim 64,
             1.58 G parameters; 1500 stub frame embeddings a sequence, as
             the reference's conv frontend is a stub): (a)
             `flash_attention_wgmma` at (64, 64) with a GQA group of 1,
             held to `flash_attention_tc_ref` by `_tc_check` with its
             dumped P at (1, 4001) and (1, 129) causal and (2, 777) full
             on q / k / v as the decoder's self-attention builds them,
             then at (1, 32768, 20, 20) causal against the plain
             version's own P and timed in turns with SDPA
             (`_against_sdpa`).  (b) `make_prefill_step` at prefill_32k
             cut to batch 1 (a warm-up and a timed prefill), then 4 x
             4096: finite logits, exactly 32 launches of the (64, 64)
             instantiation each and no 3xTF32 launch; seconds, tokens/s,
             peak memory.  (d) `precompute_cross`, then
             `whisper_decode_step` under teacher forcing at batch 4 x 64
             against the prefill of the same frames and tokens: rel L2
             <= 5e-2 at every (row, position); ms a step.  (c) 2 encoder
             and 2 decoder layers at full width, 512 tokens, the same
             weights on the card and the CPU: last-position logits within
             rel L2 5e-2, argmax equal.  xlstm-125m at full width and
             depth (6 (mLSTM, sLSTM) pairs): (e) `make_prefill_step` at 1
             x 4096 (also the warm-up), then 1 x 16384 (`prefill_32k`'s
             sequence halved: the sLSTM's loop over time is host-bound;
             the mLSTM chunkwise): seconds, tokens/s, no launch of a
             kernel of ours.  (f) `ServeEngine`, phase 9's
             six requests; `decode_step` under teacher forcing against
             the prefill on 64 tokens: phase 9's bounds.  (g)
             `make_serve_step` at long_500k: the decode state's bytes the
             same at 1 and 524,288 positions, 64 steps, ms a step against
             the bytes bound.  (h) one pair at full width, 512 tokens,
             card against CPU as (c).  (i) A train step of each at full
             width and depth from float32 masters drawn on the card:
             `make_train_step(remat=True)` (xlstm's mLSTM chunkwise), 2
             steps at 8 x 256 (the second's ms is reported): tokens/s,
             peak memory, finite losses and grad norms, no launch of a
             kernel of ours, step 0's loss within 1e-3 of its batch's CE
             through the prefill path.
             The script's wall time is printed after phase 16.
17. mesh train — training over a mesh (every earlier phase's weights
             freed first).  (a) qwen2.5-3b at full width and depth,
             float32 masters drawn on the card from seed 0 and copied to
             the host, under its PERF_TRAIN_OVERRIDES (ZeRO-3: the model
             axis joins the FSDP axis, parameters cast to bf16 before the
             gathers; one microbatch), remat, 8 x 256: two steps on a 1x1
             mesh, the first with every reduced grad copied to the host,
             then two from the same masters on a 2x2 mesh of four cuda:0
             positions, the first with every gathered grad held to the
             1x1 step's: loss within MESH_LOSS_RTOL, grad norm within
             MESH_GNORM_RTOL, each leaf's grad within rel L2
             MESH_GRAD_REL_L2; every piece held by several positions
             bitwise equal on each after each step; no launch of a kernel
             of ours; each position's state bytes equal to the dry-run's
             `position_bytes` for that mesh, to the byte.  The second
             step of each mesh is the timed one; the peak memory is
             printed.  (b) `launch.train.main` on the reduced config with
             `--mesh 2x2 --perf`, 3 steps: exit 0, finite losses (read
             from each step's checkpoint).  (c) `pipeline_apply` over four
             cuda:0 positions (S 4, M 8, B 2, D 2048, tanh(x @ w), TF32
             off) against the sequential model: outputs within 1e-5,
             grads within 1e-4.  (d) `compress_decompress` on the largest
             leaf's 2x2 grad, two rounds with error feedback, and
             `cross_pod_allreduce_compressed` over a 2 x 1 x 1 ("pod",
             "data", "model") mesh (the pods' grads the 2x2 and 1x1
             steps' of that leaf), two rounds: card and CPU bit-equal.
             (e) `dryrun.main(["--all"])` over both production meshes,
             64 ok and 16 skip, and with `--variant perf` (the ZeRO-3
             train cells run `train_collectives`), 59 ok, 16 skip and 5
             errors (the multi-pod ZeRO-3 train batch does not divide 512
             positions); qwen2.5-3b train_4k's GB a position, dominant
             term (of compute and memory only: links between nodes are
             not modeled, `collective_s` null) and collective bytes.
             The phase's and the script's wall times are printed.
18. tp train — tensor parallelism over "model" (every earlier phase's
             weights freed first): qwen3-8b at full width (d 4096, 32
             heads over 8, d_ff 12288, vocab 151936) cut to 8 of 36
             layers, float32 masters drawn on the card from seed 0 and
             kept in pinned host memory; a "tp" step (bf16 backbone,
             remat, 8 x 256) on 1x1, 1x4 (heads, KV heads, FFN and
             vocabulary local) and 2x2 with FSDP of cuda:0 positions, each
             from the same masters, the first with every reduced grad
             read out, a second timed alone: loss within TP_LOSS_RTOL of
             1x1's, every leaf's grad within rel L2 TP_GRAD_REL_L2,
             replicated pieces bitwise equal, each position's state bytes
             the dry-run's, no launch of a kernel of ours; step ms, peaks
             and the dry-run's bytes sent printed.
19. ep train — expert parallelism over "model", as 18: deepseek-v2-lite-16b
             at full width (d 2048, 16 MLA heads, 64 experts top-6 of
             d_ff 1408 and 2 shared, vocab 102400, untied head) cut to
             EP_TRAIN_LAYERS of 27, 8 x 256 (a row is one dispatch
             group), on 1x1, 1x4 (16 experts, 4 heads, a quarter of the
             shared columns and of the vocabulary a position) and 2x2
             with FSDP (two dp groups: the load-balance loss over both):
             18's checks, and `aux_loss` within EP_LOSS_RTOL of 1x1's,
             the router's grad among the leaves held; the positions of a
             model group make the same dispatch decision in the checked
             step, bitwise; the (token, k) claims whose expert differs
             from 1x1's are counted (bf16 near ties) and printed.
             The phase's and the script's wall times are printed.
20. front door — the explorer's public API and the operator CLI on
             cuda:0, through the calls a user makes: `explore(16384)` at
             the default budget from a fresh default session (its
             DeprecationWarning raised, its front inside the exhaustive
             `full_design_space(16384)` front and covering 60 % of it,
             one `nsga2_evolve` launch); `explore_sizes((4096, 16384,
             65536))` in one coalesced dispatch (one launch), its fronts
             equal to three `explore` calls' on a fresh default session;
             `distill_and_layout(16384, min_tops=1.4, min_snr_db=20.0)`:
             the survivors are the filtered front and every layout row
             equals its golden row (phase 3's check), `route_slots`
             launched; `nsga2.run(NSGA2Config(16384), seed=0)`: the
             population feasible (`constraint_violation` 0), its front
             the exhaustive one as above; `tools/repro_torch_ctl.py`'s
             `main(["drain", ...])` in process over phase 6's first
             FRONT_DOOR_TICKETS tickets with an artifact cache under
             `build/`: every ticket lands, each cached artifact equal to
             `DesignSession.run_many`'s, both kernels launched, and
             `gantt --stage-totals`, `metrics` and `cache DIR stats` read
             back the drain's trace (every stage's total positive),
             metrics (a ticket latency for each ticket) and cache (one
             entry for each distinct request).  The phase's wall time is
             printed and must stay within FRONT_DOOR_LIMIT_S.
21. family tp — local tensor parallelism over "model" for the hybrid,
             SSM and audio families, as 18 (every earlier phase's weights
             freed first): zamba2-2.7b (d 2560, 80 SSM heads, the shared
             block's 32 heads and d_ff 10240, vocab 32000) cut to 12 of 54
             layers (two groups: the shared block used twice),
             whisper-large-v3 (d 1280, 20 heads, d_ff 5120, tied vocab
             51866, 1500 stub frames a row) cut to 8 + 8 of 32 + 32
             layers and xlstm-125m (d 768, 4 mLSTM heads, vocab 50304)
             cut to 4 of 12 layers (two (mLSTM, sLSTM) pairs), at full
             width, 8 x 256, on 1x1, 1x4 (Mamba2 heads with their packed
             `in_proj` cut, the shared block, mLSTM heads with the
             sLSTM on the first position, whisper's encoder, self- and
             cross-attention local; whisper's vocabulary whole: 51866
             rows do not divide 4) and 2x2-FSDP (its vocabulary split):
             18's checks, whisper's key-bias grads (0 but for rounding)
             held to FAMILY_TP_ZERO_GRAD of their query biases', each
             position's leaf bytes the dry-run's reckoning, the largest
             position's against 1x1's printed (its layers' and all).
             Then `examples/torch/serve_acim.py` and `train_acim_lm.py`
             with `--smoke` in process: three completions; the pick's
             `nsga2_evolve` and the steps' `acim_matmul` launched, finite
             losses, a checkpoint at the last step, and a run stopped
             after step 1 and resumed ending on the same parameters bit
             for bit.  The phase's and the script's wall times are
             printed.
22. paper  — (a) the paper's result drivers (`repro_torch.paper`) in
             process at their own budgets, held to
             `src/repro_torch/_golden/paper_rows.json` (the reference's
             drivers' outputs): Fig. 8's three 16 kb rows by the
             sequential flow equal golden's but the clock (integers and
             booleans exactly, floats to PAPER_RTOL), one `wavefront`
             launch a net; Fig. 9 at 4 / 16 / 64 kb, pop 192 x 60, in
             one `nsga2_evolve` launch: each front inside golden's
             exhaustive front and covering ISLAND_COVER of it, the eight
             trends golden's and all true; Fig. 10 in one launch: its
             spans inside the exhaustive fronts' pooled spans, its flags
             printed beside golden's and equal to the exhaustive ones
             where its pooled front is the exhaustive one; Table 2's
             times beside the card's name and power limit, its front
             inside golden's 16 kb front; the SNR Monte-Carlo at its
             five POINTS and MacroSpec(1024, 2, 2, 8): the analytic
             column golden's to PAPER_RTOL, the noisy MC within
             PAPER_SNR_BAND dB of it at the reference test's four
             points, the noiseless one through `acim_matmul` (one
             launch a point) bit-equal to `acim_matmul_ref` on the same
             operands, and at B = 8 the noisy at most PAPER_SNR_NOISE dB
             above the clean; the roofline over phase 17 (e)'s records
             (a row for each, ok or not).  Each driver's seconds and
             launches are printed.  (b) phase 18's qwen3-8b step with
             int8 moments (`AdamWConfig(quantized_moments=True)`) on
             1x1, 1x4 "tp" and 2x2-FSDP: loss and grads at phase 18's
             bounds, the updated masters within the TRAIN_CHECK_* bounds
             of 1x1's, each mesh's masters and int8 moments bit-equal to
             one device's AdamW update of the whole leaves on its own
             grads (a split leaf's scales its whole row's), the moments
             against 1x1's within INT8_S_REL_L2 / INT8_Q_SHARE, the
             scale row replicated over each leaf's column pieces, each
             position's state bytes the dry-run's (its scale
             all-reduces counted) and printed against phase 18's with
             float32 moments.
23. report — one JSON line of per-kernel numbers (the `wavefront` row's
             launches are phase 7's, by path; `nsga2_evolve` and
             `nds_rank` carry phase 8's as `mesh_launches`, `nds_rank`
             its migration-shape time; the (128, 128) flash row its
             launches on each prefill path, phases 5 and 14, as
             `launches_by_path`, with whisper-large-v3's (64, 64)
             launches of phase 16; `nsga2_evolve` and `route_slots`
             phase 20's as `front_door_launches`; `nsga2_evolve`,
             `wavefront` and `acim_matmul_wgmma` phase 22's under
             `launches_by_path["paper_drivers"]`), the nvidia-smi line,
             and the contract line
             {"ok": true, "device": {"platform": "gpu", ...}}.

The golden rows come from the JAX reference (`tests/test_torch_golden.py`
regenerates and checks them); this script imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "src" / "repro_torch" / "_golden" / "layout_rows_16384.json"
PAPER_GOLDEN = ROOT / "src" / "repro_torch" / "_golden" / "paper_rows.json"

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the float32 /
# int32 CUDA-core rate, for the roofline bound of each kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# The dense bf16 tensor-core peak (same data sheet): the bf16 flash
# kernels' bound.
PEAK_BF16_TC_FLOPS = 989.4e12
# The dense TF32 tensor-core peak (same data sheet): the float32 flash
# route's bound, three TF32 products for each float32 one (3xTF32).
PEAK_TF32_TC_FLOPS = 494.7e12
FLOAT_RTOL = 1e-6

# The trainer's full-width configuration (the reference example's
# "~125M-class" run) and the checks of phases 2 and 4.
TRAIN = dict(d_model=768, layers=12, seq=128, batch=8, lr=3e-3, steps=20)
ACIM_SHAPES = ((1024, 768, 3072), (1024, 3072, 768))
ACIM_FLIP_SHARE = 1e-3     # mismatch-folded weights: outputs an ADC flip
                           # may move (measured share printed)
# The mma route's macros (h, w, l, b): N 8 / B 3 and N 4 / B 2 on the 1 kb
# exhaustive front, N 2 / B 1 in its space; its row is taken at N 8, B 3.
ACIM_SMALL_N = ((128, 8, 16, 3), (128, 8, 32, 2), (64, 16, 32, 1))
ACIM_SMALL_N_ROW = (8, 3)
ACIM_CUDA_CORE_MACRO = (48, 64, 2, 3)   # N 24: an N only the CUDA cores take
# Instructions a conversion in the ADC bound: a float32 ADC's (rint by
# the magic constant, two clamps, the sum); the mma kernel's own (FFMA
# rint, DPX clamp, integer add) gives a side figure.
ACIM_ADC_INSTR = 5
ACIM_KERNEL_ADC_INSTR = 3
CPU_CHECK_LAYERS = 2       # depth of the step-0 card-vs-CPU check
CPU_CHECK_RTOL = 1e-2

# A point of the 1 kb exhaustive front whose chunk (N 8, B 3) is no whole
# k16 step: the trainer's forward then takes acim_matmul's mma route.
NARROW_MACRO_ARGS = (128, 8, 16, 3)

# The prefill phase: qwen2.5-3b at full width, prefill_32k cut to batch 1.
PREFILL_CONFIG = "qwen2.5-3b"
PREFILL_BATCH = 1
SMALL_PREFILL = (4, 4096)  # batch, seq: B > 1
FLASH_RTOL = 2e-5          # f32 atol = rtol; bf16: one output ulp + this
SMALL_HEAD_DIM = 32        # bf16 on the 3xTF32 route, timed at 1 x 32768
TC_ULPS = 2.0              # tensor-core route vs its plain version fed
                           # the kernel's own P: bf16 ulps of each output
                           # element over FLASH_RTOL, every element
                           # (measured <= 0.995 on an H100)
TC_FLIP_SHARE = 1e-4       # vs the plain version's own P: share of outputs
                           # beyond TC_ULPS (a p rounded the other way;
                           # measured 3.7e-6 to 2.5e-5)
TC_FLIP_ROW_ULPS = 1.0     # ... each within this many ulps of its row's
                           # largest output over FLASH_RTOL (measured
                           # <= 0.427; see _tc_check)
TC_F32P_REL_L2 = 1e-2      # tensor-core route vs the float32-P versions
                           # (measured 2.1e-3 to 2.5e-3 on an H100)
DENSE_CHECK_SEQ = 4096     # blockwise vs dense attention, one layer
DENSE_CHECK_RTOL = 2e-2    # rel L2 (measured 3.8e-3 on the CPU at S 512)
PREFILL_CPU_LAYERS = 2     # card vs CPU, full width
PREFILL_CPU_SEQ = 512
PREFILL_CPU_RTOL = 5e-2    # rel L2 of the last position's logits
SMALL_ROUTE_SEQ = 300      # the reduced config's prefill (3xTF32 route)

# The 16 kb request's layout settings, and the route_slots checks' cuts.
COARSE, CAPACITY = 64, 4
ROUTE_CHECK_SLOTS = 8      # slots of the request's bucket held against the
                           # plain version (it sweeps full fields per slot)
ROUTE_BIG_SLOTS = 4        # slots on the large grids
# Large grids of the 65536 array: 122 x 1090 at coarse 64 (route_slots keeps
# its counts in device memory) and 241 x 2178 at coarse 32 (its bitsets
# too; `wavefront`'s bitsets as well).
BIG_GRIDS = ((241, 2178), (122, 1090))
# A spec past 32,767 masked targets (49,160): route_slots keeps uint32
# counts.  The explorer's space holds such wide specs (for a 1 Mb array,
# MacroSpec(64, 16384, 2, 1): 49,216).
WIDE_SPEC = (8, 16384, 1, 1)

# Phase 7's sequential flow: the specs of the 16 kb front with the
# largest routing grids (all 86 take minutes of host work: `drc_lite`'s
# sweep alone runs ~8 s on each 2048-row spec).
FLOW_SPECS = 8

# Phase 6's service: two coalesced batches of four tickets, a 4-wide
# layout pool, every stage thread on the one default stream.
SERVICE = dict(max_coalesce=4, coalesce_window_s=0.05, layout_workers=4)

# Phase 8: the device mesh.  Sharded cells at the default budget; islands
# at the reference's slow-test parameters (tests/test_distributed_explorer
# .py) on 1, 2, 4 and 8 positions of the one card, whose merged front must
# cover ISLAND_COVER of the golden exhaustive front; the island request
# timed against the single-island explore in ISLAND_TURNS rounds of turns.
SHARDED_CELLS = ((4096, 0), (16384, 0), (65536, 0))
ISLAND_CELL = (16384, 0)
ISLAND_RUN = dict(islands=8, migrate_every=10, pop_size=96, generations=60)
ISLAND_MESHES = (1, 2, 4, 8)
ISLAND_COVER = 0.8
ISLAND_TURNS = 3

# Phase 9: qwen2.5-3b at full width serves six requests through four
# slots; then decode_step under teacher forcing against the prefill.
DECODE = dict(slots=4, max_seq=256, requests=6, prompt=(16, 64), max_new=32,
              sampled=2, temperature=0.8)
DECODE_CHECK_SEQ = 64
DECODE_RTOL = 5e-2         # rel L2 of each position's logits (bf16 both)
DECODE_TOP1 = 0.9          # share of positions whose argmax agrees

# Phase 10: the training stack on qwen2.5-3b at full width (3.397 G float32
# master parameters drawn from seed 0 on the card).  (a) the launcher's defaults (--seq 256
# --batch 8) for 5 steps, then train_4k cut to 4 sequences (one card's
# time; microbatches_for gives 4, one 4096-token sequence each) for 2.
TRAIN_LM_STEPS, TRAIN_LM_SHAPE = 5, (8, 256)        # steps, (batch, seq)
TRAIN_4K_STEPS, TRAIN_4K_BATCH = 2, 4
TRAIN_CE_RTOL = 5e-3       # step 0's loss vs the CE of the same batch
                           # through the prefill path (bf16 weights,
                           # flash_attention_wgmma) on the same weights
# (b) 2 layers at full width, 2 x 64 tokens: the card against the CPU,
# two microbatches against one, remat against none.  AdamW's first step
# moves an element by about lr times its grad's sign, so a grad whose
# sign bf16 rounding flips moves it 2 lr apart.
TRAIN_CHECK_LAYERS, TRAIN_CHECK_SHAPE = 2, (2, 64)
TRAIN_CHECK_LOSS_RTOL = 5e-3
TRAIN_CHECK_GNORM_RTOL = 5e-2
TRAIN_CHECK_LR = 2.2       # max |p - p'| in units of lr
TRAIN_CHECK_NEAR = 0.1     # ... and at most this many lr ...
TRAIN_CHECK_SHARE = 0.97   # ... on at least this share of the elements
# (c) restart exactness on the reduced config: preempted after step 3 of 6
TRAIN_RESTART = dict(steps=6, preempt_after=3, seq=64, batch=8, ckpt_every=4)

# Phase 11: the MoE family.  deepseek-v2-lite-16b at full width and depth
# (27 layers, 16.21 G bf16 parameters, drawn on the card from seed 0:
# the CPU draw would take minutes) and arctic-480b at full width cut to
# one layer (its 35 would be 953 GB); MLA's prefill on the (192, 128)
# tensor-core instantiation.
MOE_CONFIG = "deepseek-v2-lite-16b"
MLA_INST = "flash_attention_wgmma_192_128"   # its launch count
MLA_DIMS = (192, 128)      # q/k (nope 128 + rope 64) and v head dims
MLA_CASES = ((1, 4001, 16, True), (1, 129, 16, True), (2, 777, 16, False))
MOE_SMALL_PREFILL = (4, 4096)
MOE_CPU_LAYERS, MOE_CPU_SEQ = 2, 512   # (e) card vs CPU, CPU-drawn weights
MOE_CPU_RTOL = 5e-2        # rel L2 of the last position's logits
MOE_ROUTE_SAME = 0.95      # share of (token, k) claims routed alike
MOE_NEAR_TIE = 3e-3        # router gap (k-th minus (k+1)-th probability)
                           # under which a bf16 rounding may flip a claim
                           # (measured on the CPU tests: flips up to 2.7e-3)
ARCTIC_CONFIG, ARCTIC_SEQ, ARCTIC_DECODE = "arctic-480b", 4096, 8
A2A_POSITIONS, A2A_TOKENS = (1, 2, 4), 2048
A2A_REL_L2 = 1e-2          # moe_fwd_a2a vs moe_fwd_dense_eval, bf16

# Phase 12: the VLM prefix family.  paligemma-3b at full width and depth
# (18 layers, 2.51 G bf16 parameters drawn on the card from seed 0; the
# SigLIP tower is a stub, as in the reference: 256 patch embeddings a
# sequence), its prefill attention on the (256, 256) tensor-core
# instantiation with the patches as a bidirectional prefix.
VLM_CONFIG = "paligemma-3b"
VLM_INST = "flash_attention_wgmma_256_256"   # its launch count
VLM_DIMS = (256, 256)
VLM_CASES = ((1, 4001, 256, True), (1, 129, 256, True),
             (2, 777, 0, False))             # (B, S, prefix_len, causal)
VLM_SMALL_PREFILL = (4, 4096)                # text tokens; + 256 patches
VLM_CPU_LAYERS, VLM_CPU_SEQ = 2, 512   # (e) card vs CPU, CPU-drawn weights
VLM_CPU_RTOL = 5e-2        # rel L2 of the last position's logits
VLM_SMALL_SEQ = 300        # (f) the reduced config's prefill (3xTF32)

# Phase 13: the hybrid family.  zamba2-2.7b at full width and depth (54
# Mamba2 layers in 9 groups of 6, one shared attention + FFN block at the
# start of each group), its prefill attention on the (80, 80) tensor-core
# instantiation (exact 80-column tiles in shared memory).
HYBRID_CONFIG = "zamba2-2.7b"
HYBRID_INST = "flash_attention_wgmma_80_80"  # its launch count
HYBRID_DIMS = (80, 80)
HYBRID_CASES = ((1, 4001, True, 0), (1, 129, True, 0), (2, 777, False, 0),
                (1, 1000, True, 64))         # (B, S, causal, prefix_len)
HYBRID_SMALL_PREFILL = (4, 4096)
# (d) decode vs prefill.  The chunked SSD in bf16 and the recurrence
# round at other places, and the gap grows with depth: the reference's own
# bf16 decode vs its bf16 prefill on 64 tokens of the reduced config is
# 4.5e-2 at 4 layers and 8.1e-2 at 12 (rel L2 max; measured on the CPU);
# the port's on the card 9.7e-2 at 54 layers, top-1 53 of 64.  So the
# arithmetic is held in float32 (backbone, caches and dense attention;
# the same weights), and the bf16 pair with looser bounds.
HYBRID_F32_DECODE_RTOL = 1e-3
HYBRID_DECODE_RTOL = 0.15
HYBRID_DECODE_TOP1 = 0.75
HYBRID_LONG_STEPS = 8      # (e) long_500k decode steps at 524,288 positions
HYBRID_CPU_SEQ = 512       # (f) one group at full width, card vs CPU
HYBRID_CPU_RTOL = 5e-2     # rel L2 of the last position's logits
HYBRID_SMALL_SEQ = 320     # (g) the reduced config's prefill (chunk 16)

# Phase 14: the dense family's other configs at full width and depth, their
# prefills on the (128, 128) tensor-core instantiation at GQA groups of 4
# (qwen3-8b, 32 heads over 8), 1 (codeqwen1.5-7b, MHA) and 48 (granite-34b,
# MQA, with learned positions); bf16 weights drawn on the card from seed 0.
DENSE_CONFIGS = ("qwen3-8b", "codeqwen1.5-7b", "granite-34b")
DENSE_INST = "flash_attention_wgmma_128_128"
DENSE_SMALL_PREFILL = (4, 4096)
# (b)'s decode engine runs on the first DENSE_SERVE_LAYERS layers of each
# config's full-width weights (since the smoke gained phase 21): at full
# depth the three engines took 67 s of host-bound decode (114.7, 88.8 and
# 162.9 ms a step) for checks a depth cut keeps; phase 9 serves at full
# depth and (c) holds the full-depth decode to the prefill.
DENSE_SERVE_LAYERS = 8

# Phase 15: the hybrid and VLM families' train steps at full width and
# depth (float32 masters drawn on the card from seed 0), as phase 10's:
# (config, its prefill's instantiation, the sequences train_4k is cut to
# (run in its microbatches), layers of the step-variant check: one group
# of zamba2, two layers of paligemma).  paligemma's train_4k runs 4
# sequences, one a microbatch: at two a microbatch the float32 CE over
# its 257,216-entry vocabulary (7.85 GiB a copy, several live in its
# backward) ran out of the card's memory beside the 40 GB train state.
FAMILY_TRAIN = (("zamba2-2.7b", "flash_attention_wgmma_80_80", 8, 6),
                ("paligemma-3b", "flash_attention_wgmma_256_256", 4, 2))

# Phase 16: the audio and SSM families at full width and depth, bf16
# serving weights drawn on the card from seed 0.  whisper-large-v3 (32
# encoder and 32 decoder layers; the conv frontend a stub, as in the
# reference: 1500 frame embeddings a sequence), its decoder's
# self-attention on the (64, 64) instantiation at 20 heads over 20 (MHA,
# a GQA group of 1); xlstm-125m (6 (mLSTM, sLSTM) pairs), which reaches no
# kernel of ours (the reference's xLSTM is jnp under `lax.scan`).
AUDIO_CONFIG = "whisper-large-v3"
AUDIO_INST = "flash_attention_wgmma_64_64"
AUDIO_CASES = ((1, 4001, True), (1, 129, True), (2, 777, False))
AUDIO_SMALL_PREFILL = (4, 4096)
AUDIO_DECODE = (4, 64)     # batch, tokens of the teacher-forced decode
AUDIO_CPU_LAYERS = 2       # encoder and decoder layers of the CPU check
SSM_CONFIG = "xlstm-125m"
# 1 x 4096 first (also the warm-up), then the long prefill cut to 1 x
# 8192: the sLSTM's loop is host-bound, 0.29-0.46 ms a position a pair
# on the H100 80GB HBM3 at 700 W machines measured, so 1 x 32768 takes
# 56-90 s and 1 x 16384 took 24.6-44.9 s, the part of the script's time
# that varies most with the host, beside its 1200 s limit
SSM_PREFILLS = ((1, 4096), (1, 8192))
SSM_LONG_STEPS = 64
SSM_CPU_LAYERS = 2         # one (mLSTM, sLSTM) pair
FAMILY16_TRAIN = ((AUDIO_CONFIG, AUDIO_INST), (SSM_CONFIG, "flash_attention"))
FAMILY16_STEPS = 2         # the first also warms up: its ms is the second's
FAMILY16_CE_RTOL = 1e-3    # step 0's loss vs the prefill path's CE

# Phase 17: training over a mesh.  qwen2.5-3b at full width and depth
# (float32 masters drawn on the card from seed 0) under its
# PERF_TRAIN_OVERRIDES (ZeRO-3, one microbatch), one step on a 1x1 mesh,
# then one from the same masters on a 2x2 mesh of four cuda:0 positions.
MESH_TRAIN_CONFIG = "qwen2.5-3b"
MESH_TRAIN_SHAPE = (8, 256)         # batch, seq
MESH_TRAIN_LAYERS = None            # depth cut (None: full depth)
MESH_LOSS_RTOL = 1e-3               # 2x2 vs 1x1 step: loss
MESH_GNORM_RTOL = 1e-2              # ... grad norm
MESH_GRAD_REL_L2 = 5e-2             # ... every leaf's grad (bf16 step)
MESH_CLI = ["--arch", "qwen2.5-3b", "--reduced", "--mesh", "2x2", "--perf",
            "--steps", "3", "--seq", "64", "--batch", "8", "--ckpt-every",
            "1"]
PIPE = dict(stages=4, microbatches=8, batch=2, dim=2048)
PIPE_OUT_TOL, PIPE_GRAD_TOL = 1e-5, 1e-4

# Phase 18: tensor parallelism over "model".  qwen3-8b at full width (d
# 4096, 32 / 8 heads, d_ff 12288, vocab 151936) cut to TP_TRAIN_LAYERS of
# its 36 layers, float32 masters drawn on the card from seed 0 and kept
# on the host; a "tp" step (bf16 backbone, remat, one microbatch) on
# each mesh of cuda:0 positions: 1x1, 1x4 (heads, KV heads, FFN and
# vocabulary local to each position) and 2x2 with fsdp=True (the policy
# the reference picks for the uncut 8.2 G parameters), each from the
# same masters, the first step with its grads read out, a second timed
# alone.
TP_TRAIN_CONFIG = "qwen3-8b"
TP_TRAIN_LAYERS = 8                 # depth cut (of 36)
TP_TRAIN_SHAPE = (8, 256)           # batch, seq
TP_TRAIN_MESHES = (((1, 1), None), ((1, 4), None), ((2, 2), True))
TP_LOSS_RTOL = 1e-3                 # each mesh vs 1x1: loss
TP_GRAD_REL_L2 = 5e-2               # ... every leaf's grad (bf16 step)

# Phase 19: expert parallelism over "model".  deepseek-v2-lite-16b at full
# width cut to EP_TRAIN_LAYERS of its 27 layers, float32 masters drawn on
# the card from seed 0 and kept on the host; a "tp" step (bf16 backbone,
# remat, one microbatch) on each mesh of phase 18, each from the same
# masters.  The MoE family's step runs both dp groups' forwards before
# the microbatch's one backward, so on 2x2 both groups' float32 gathers
# are alive together: at 4 layers (2.76 G masters) state, grad sums and
# the two gathers reckon 66 GB before activations, at 3 (2.17 G) 52 GB;
# on an H100 80GB HBM3 3 layers peaked at 54.26 GB and 4 at 68.36 GB.
EP_TRAIN_CONFIG = "deepseek-v2-lite-16b"
EP_TRAIN_LAYERS = 4                 # depth cut (of 27)
EP_TRAIN_SHAPE = (8, 256)           # batch, seq: a row is a dispatch group
EP_TRAIN_MESHES = TP_TRAIN_MESHES
EP_LOSS_RTOL = 1e-3                 # each mesh vs 1x1: loss and aux_loss
EP_GRAD_REL_L2 = 5e-2               # ... every leaf's grad, the router's too

# Phase 21: local tensor parallelism over "model" for the hybrid, SSM and
# audio families, as phase 18: (config, depth cut, the encoder's cut).
# zamba2-2.7b keeps two groups (the shared block used twice), whisper 8 +
# 8 layers over its 1500 stub frames a row, xlstm-125m two (mLSTM, sLSTM)
# pairs; all at full width, phase 18's shape, meshes and bf16 bounds.
# whisper's self-attention key biases have no RoPE after them, so the
# softmax drops them: their grads are 0 but for rounding, held to
# FAMILY_TP_ZERO_GRAD of the largest grad element of their layer's
# query bias on each mesh (as the CPU tests hold them absolutely).
FAMILY_TP = (("zamba2-2.7b", 12, None), ("whisper-large-v3", 8, 8),
             ("xlstm-125m", 4, None))
FAMILY_TP_SHAPE = TP_TRAIN_SHAPE
FAMILY_TP_MESHES = TP_TRAIN_MESHES
FAMILY_TP_ZERO_GRAD = 1e-2
# A bf16 step cannot resolve some leaves to phase 18's bound: the Mamba2
# per-head vectors' grads (a_log, dt_bias, d_skip) are sums with heavy
# cancellation, 2.3e-2 - 8.3e-2 rel L2 off the float32 step's at 1x1
# alone (reduced zamba2 on the CPU), so two bf16 orderings differ by as
# much.  Phase 21 also runs a float32 1x1 step: a leaf passes within
# TP_GRAD_REL_L2 of 1x1's bf16 grad, or where the mesh's bf16 grad is
# off the float32 one by at most 1x1's own bf16 error plus TP_GRAD_REL_L2.
# the two LM examples at their smoke budgets: serving's first line, and
# the trainer's checkpoints (under the ignored build/)
LM_EXAMPLE_SERVED = "3 completions, 12 tokens in "
LM_EXAMPLE_CKPT = ROOT / "build" / "train_acim_lm_smoke"

# nsga2_evolve against the composite loop: (cell sizes, pop, generations).
# The first is the 16 kb request's dispatch (timed); then the codesign
# pick's, a batch of cells, a pop whose 2 P is no multiple of 32, pops
# whose rank words (512), then whole state (1024), sit in device memory,
# and the island batches of phase 8 (b) and of its request (c) on one
# position: k islands of one cell, k C populations a launch.
EVOLVE_CASES = (((16384,), 256, 80), ((16384,), 96, 25),
                ((4096, 16384, 65536), 256, 20), ((16384,), 100, 15),
                ((16384, 4096), 512, 6), ((16384,), 1024, 3),
                ((16384,) * 8, 96, 10), ((16384,) * 4, 256, 20))

# Phase 20 (the front door): the sweep of `explore_sizes`, the
# distillation of `distill_and_layout` (quickstart's requirements), the
# drain's tickets (phase 6's first ones) and the phase's time limit.
FRONT_DOOR_SIZES = (4096, 16384, 65536)
FRONT_DOOR_DISTILL = dict(min_tops=1.4, min_snr_db=20.0)
FRONT_DOOR_TICKETS = 4
FRONT_DOOR_LIMIT_S = 30.0


# Phase 22 (a): the paper drivers against golden.  Floats of the
# estimator to PAPER_RTOL (its `log10` / `pow` differ by ulps between
# libraries and between the card and the host); the noisy SNR MC within
# the reference test's band of the analytic column at its four points,
# and at B = 8 at most PAPER_SNR_NOISE dB above the noiseless run.
PAPER_SIZES = (4096, 16384, 65536)
PAPER_RTOL = 1e-6
PAPER_SNR_BAND = 2.0
PAPER_SNR_NOISE = 0.5
PAPER_SNR_EXTRA = (1024, 2, 2, 8)     # the reference test's MacroSpec
# (b): int8 moments split on their last dimension, phase 18's config,
# shape and meshes.  Against 1x1's, the grads differ by bf16 rounding in
# another order (up to TP_GRAD_REL_L2 a leaf): each leaf's block scales
# within INT8_S_REL_L2 of 1x1's (rel L2: a block of near-zero grads can
# move its scale by several times itself) and the moments' q within one
# step on at least INT8_Q_SHARE of the entries (measured on the H100:
# scales 9.84e-3 / 8.41e-3 at 1x4 / 2x2-FSDP, a block's up to 4.6x; q
# within one step on 0.99616 / 0.99700, equal on 0.916 / 0.920).
INT8_MESHES = TP_TRAIN_MESHES
INT8_S_REL_L2 = 2 * TP_GRAD_REL_L2
INT8_Q_SHARE = 0.98


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound(nbytes: float, ops: float,
          peak_ops: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over memory rate or
    operations over `peak_ops` (default the CUDA-core rate), whichever is
    larger."""
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of one call of `fn` over `reps` calls (after one
    warm-up call), from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PROFILER_SESSIONS = 3


def profiler_ms(fn, reps: int, kernel: str) -> float:
    """Mean device time of the kernels named `kernel` per call of `fn`
    over `reps` calls (after one warm-up), from torch.profiler: the
    device's own time, without the host's launch cost.

    The first CUPTI session of a process can come back without the
    device's activity records, so a session that saw no `kernel` is run
    again, up to PROFILER_SESSIONS in all; the check fails only if none
    of them saw it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(1, PROFILER_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and kernel in e.key)
        if us > 0:
            break
        print(f"profiler: session {session} of {PROFILER_SESSIONS} recorded "
              f"no device time for {kernel}", flush=True)
    check(us > 0, f"profiler recorded no device time for {kernel} in "
                  f"{PROFILER_SESSIONS} sessions")
    return us / 1e3 / reps


# ----------------------------------------------------------------------
# Phase 1: build
# ----------------------------------------------------------------------
def build_phase() -> str:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.2f} s for {sorted(logs) or 'nothing (cached)'}",
          flush=True)
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"gpu: {card}", flush=True)
    return card


# ----------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ----------------------------------------------------------------------
def golden_points() -> list[dict]:
    return json.loads(GOLDEN.read_text())["points"]


def _objectives_batch(dev, rng):
    """(3, 512, 4) objectives of random genes (with repeats) of the
    4096 / 16384 / 65536 spaces, 12 +inf pad rows each."""
    import torch

    from repro_torch.core import nsga2

    sizes = (4096, 16384, 65536)
    space = nsga2.stack_spaces([nsga2.space_operands(
        nsga2.NSGA2Config(array_size=s)) for s in sizes]).to(dev)
    lo = space.gene_lo.cpu().numpy()
    hi = space.gene_hi.cpu().numpy()
    genes = rng.integers(lo[:, None, :], hi[:, None, :] + 1, (3, 500, 3))
    genes[:, 400:] = genes[:, :100]                   # exact duplicates
    genes = nsga2.repair_op(torch.tensor(genes, dtype=torch.int32,
                                         device=dev), space)
    f = nsga2.evaluate_op(genes, space)
    pad = torch.full((3, 12, 4), float("inf"), device=dev)
    return torch.cat([f, pad], 1).contiguous()


def wavefront_bucket(dev, rng, gen, specs):
    """The standalone `wavefront`'s input at the 16 kb front's bucket: the
    grids of `specs` at 20 % random occupancy (drawn from `gen`), blocked
    beyond each grid's extent, padded to the batch's; one seed a grid at a
    random cell (from `rng`).  Returns (occ, seed, grids (B, 2) int32 on
    `dev`, grids as numpy int64)."""
    import numpy as np
    import torch

    from repro_torch.eda.placer import geometry, layout_operands
    from repro_torch.eda.router import grid_shape
    from repro_torch.kernels.maze_route import ref as mr_ref

    geom = geometry()
    grids = np.array([grid_shape(o.width, o.height, COARSE) for o in
                      (layout_operands(s, geom) for s in specs)], np.int64)
    bsz, gh, gw = len(grids), int(grids[:, 0].max()), int(grids[:, 1].max())
    grids_t = torch.tensor(grids, dtype=torch.int32, device=dev)
    outside = mr_ref.outside_grids((bsz, gh, gw), grids_t, dev)
    occ = (torch.rand((bsz, gh, gw), generator=gen, device=dev) < 0.2) \
        | outside
    seed = torch.zeros_like(occ)
    hy = torch.tensor(rng.integers(0, grids[:, 0]), device=dev)
    hx = torch.tensor(rng.integers(0, grids[:, 1]), device=dev)
    seed[torch.arange(bsz, device=dev), hy, hx] = True
    return occ, seed, grids_t, grids


def bfs_levels(dist) -> int:
    """BFS levels a `wavefront` launch runs through on `dist`: its largest
    finite value plus one, the most over the batch (0 with no seed)."""
    from repro_torch.kernels.maze_route import ref as mr_ref

    finite = dist[dist < mr_ref.INF]
    return int(finite.max()) + 1 if finite.numel() else 0


def kernel_phase() -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.core import pareto
    from repro_torch.kernels.maze_route import kernel as mr
    from repro_torch.kernels.maze_route import ref as mr_ref
    from repro_torch.kernels.pareto_dom import kernel as pd

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = []

    # -- nds_rank: (3, 512, 4), and the global-memory branch at P = 2048
    f = _objectives_batch(dev, rng)
    got, want = pd.nds_rank(f), pareto.non_dominated_rank(f)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "nds_rank != plain on (3, 512, 4)")
    err = float((got - want).abs().max())
    big = torch.cat([f[:, :500].reshape(1, 1500, 4),
                     torch.full((1, 548, 4), float("inf"), device=dev)], 1)
    check(torch.equal(pd.nds_rank(big.contiguous()),
                      pareto.non_dominated_rank(big)),
          "nds_rank != plain on (1, 2048, 4) (global-memory branch)")
    f1 = f[:1].contiguous()                  # the main path's (1, 512, 4)
    fronts = int(pd.nds_rank(f1).max()) + 1
    c, p, m = f1.shape
    nbytes = c * p * m * 4 + c * p * 4
    ops = c * p * p * m * 2 + fronts * c * p * (p // 32) * 2
    b_ms, b_by = bound(nbytes, ops)
    # the event time includes the wrapper's host time; the profiler's
    # device time is kept beside it
    rows.append(dict(
        name="nds_rank", route="cuda", source="src/repro_torch/csrc/pareto_dom.cu",
        replaces="src/repro/kernels/pareto_dom/kernel.py:112",
        max_abs_err=err, ms=cuda_ms(lambda: pd.nds_rank(f1), 200),
        plain_ms=cuda_ms(lambda: pareto.non_dominated_rank(f1), 20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        device_ms=profiler_ms(lambda: pd.nds_rank(f1), 50, "nds_rank")))
    print(f"kernel nds_rank: equal to plain on (3, 512, 4) and (1, 2048, 4); "
          f"{rows[-1]['ms']:.4f} ms by events (profiler device "
          f"{rows[-1]['device_ms']:.5f} ms) vs plain "
          f"{rows[-1]['plain_ms']:.4f} ms at (1, 512, 4)", flush=True)

    # -- dominance_matrix: (1, 512, 4), the composite loop's pool; its
    # event time includes the wrapper's host time, so the profiler's
    # device time is kept beside it, and the launch floor beside both (the
    # same kernel on one warp's worth of work, (1, 32, 1))
    fd = f[1:2].contiguous()
    got, want = pd.dominance_matrix(fd), pareto.dominance_matrix(fd)
    check(torch.equal(got, want), "dominance_matrix != plain on (1, 512, 4)")
    for shape in ((3, 512, 4), (2, 1000, 3), (1, 1024, 8), (2, 64, 1)):
        fr = torch.tensor(rng.integers(0, 4, shape), dtype=torch.float32,
                          device=dev)
        fr[:, -2:] = float("inf")
        check(torch.equal(pd.dominance_matrix(fr),
                          pareto.dominance_matrix(fr)),
              f"dominance_matrix != plain on {shape}")
    c, p, m = fd.shape
    b_ms, b_by = bound(c * p * m * 4 + c * p * p, c * p * p * m * 2)
    dev_ms = {}
    for shape in ((1, 512, 4), (1, 192, 4), (3, 512, 4), (1, 32, 1)):
        fr = fd if shape == (1, 512, 4) else torch.rand(shape, device=dev)
        dev_ms[shape] = (cuda_ms(lambda: pd.dominance_matrix(fr), 200),
                         profiler_ms(lambda: pd.dominance_matrix(fr), 50,
                                     "dominance_kernel"))
    rows.append(dict(
        name="dominance_matrix", route="cuda",
        source="src/repro_torch/csrc/pareto_dom.cu",
        replaces="src/repro/kernels/pareto_dom/kernel.py:44",
        max_abs_err=float((got.int() - want.int()).abs().max()),
        ms=dev_ms[(1, 512, 4)][0],
        plain_ms=cuda_ms(lambda: pareto.dominance_matrix(fd), 50),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        device_ms=dev_ms[(1, 512, 4)][1], floor_ms=dev_ms[(1, 32, 1)][0],
        floor_device_ms=dev_ms[(1, 32, 1)][1]))
    print(f"kernel dominance_matrix: equal to plain on (1, 512, 4), (3, 512, "
          f"4), (2, 1000, 3), (1, 1024, 8), (2, 64, 1); {rows[-1]['ms']:.4f} "
          f"ms vs plain {rows[-1]['plain_ms']:.4f} ms; (event ms, profiler "
          f"device ms) by shape {dev_ms} ((1, 32, 1): the launch floor)",
          flush=True)

    # -- wavefront: the 86 golden 16 kb grids with random occupancy,
    # padded to the batch's extent (the main path's bucket), and the
    # large grids one at a time (241 x 2178: bitsets in device memory)
    gen = torch.Generator(device=dev).manual_seed(0)
    from repro_torch.core.acim_spec import MacroSpec
    specs = [MacroSpec(p_["row"]["h"], p_["row"]["w"], p_["row"]["l"],
                       p_["row"]["b_adc"]) for p_ in golden_points()]
    occ, seed, grids_t, grids = wavefront_bucket(dev, rng, gen, specs)
    bsz, gh, gw = occ.shape
    dist = mr.wavefront(occ, seed, grids_t)
    want = mr_ref.wavefront_distance_ref(occ, seed, grids_t)
    check(torch.equal(dist, want),
          f"wavefront != plain on ({bsz}, {gh}, {gw})")
    for bh, bw in BIG_GRIDS:
        occ65 = torch.rand((1, bh, bw), generator=gen, device=dev) < 0.2
        seed65 = torch.zeros_like(occ65)
        seed65[0, bh // 2, 17] = True
        check(torch.equal(mr.wavefront(occ65, seed65),
                          mr_ref.wavefront_distance_ref(occ65, seed65)),
              f"wavefront != plain on (1, {bh}, {bw})")
    # The function reads occ and seed of the real cells only (the pad is
    # blocked by definition) and writes the whole int32 plane.
    cells = bsz * gh * gw
    real = int((grids[:, 0] * grids[:, 1]).sum())
    b_ms, b_by = bound(cells * 4 + real * 2 + bsz * 8, real * 4 * 2)
    # the event time includes the wrapper reading `grids` back to size
    # the launch; the profiler's device time is kept beside it, and ms a
    # level is the device's
    levels = bfs_levels(want)
    rows.append(dict(
        name="wavefront", route="cuda", source="src/repro_torch/csrc/maze_route.cu",
        replaces="src/repro/kernels/maze_route/kernel.py:71",
        max_abs_err=float((dist - want).abs().max()),
        ms=cuda_ms(lambda: mr.wavefront(occ, seed, grids_t), 20),
        plain_ms=cuda_ms(lambda: mr_ref.wavefront_distance_ref(
            occ, seed, grids_t), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, levels=levels,
        device_ms=profiler_ms(lambda: mr.wavefront(occ, seed, grids_t), 20,
                              "wavefront")))
    rows[-1]["ms_per_level"] = rows[-1]["device_ms"] / levels
    print(f"kernel wavefront: equal to plain on ({bsz}, {gh}, {gw}), "
          f"(1, 241, 2178) and (1, 122, 1090); {rows[-1]['ms']:.4f} ms by "
          f"events (profiler device {rows[-1]['device_ms']:.4f} ms) vs plain "
          f"{rows[-1]['plain_ms']:.4f} ms; {levels} BFS levels, "
          f"{rows[-1]['ms_per_level'] * 1e3:.4f} us a level", flush=True)

    # -- trace_paths: one slot on the wavefront above; two star targets
    # per grid (occupied ones take the blocked-entry step), a few
    # padded slots
    ty = torch.tensor(rng.integers(0, grids[:, 0, None], (bsz, 2)), device=dev)
    tx = torch.tensor(rng.integers(0, grids[:, 1, None], (bsz, 2)), device=dev)
    tgts = torch.stack([ty, tx], -1).to(torch.int32).contiguous()
    tmask = torch.tensor(rng.random((bsz, 2)) < 0.7, device=dev)
    tmask[:, 0] = True
    nmask = torch.tensor(rng.random(bsz) < 0.9, device=dev)
    occ_cnt = torch.tensor(rng.integers(0, 4, (bsz, gh, gw)),
                           dtype=torch.int32, device=dev)

    def fresh():
        z = lambda: torch.zeros(bsz, dtype=torch.int32, device=dev)  # noqa: E731
        return [occ_cnt.clone(), z(), z(), z()]

    got, want = fresh(), fresh()
    mr.trace_paths(dist, tgts, tmask, nmask, *got)
    mr_ref.trace_paths_ref(dist, tgts, tmask, nmask, *want)
    for g_, w_, what in zip(got, want, ("occupancy", "routed", "failed",
                                        "wirelength")):
        check(torch.equal(g_, w_), f"trace_paths {what} != plain")
    check(int(want[1].sum()) > 0, "trace_paths check routed nothing")
    visits = int((want[0] - occ_cnt).sum())
    b_ms, b_by = bound(visits * (4 * 4 + 8) + bsz * 2 * (8 + 1 + 16),
                       visits * 8)
    bufs = fresh()
    rows.append(dict(
        name="trace_paths", route="cuda", source="src/repro_torch/csrc/maze_route.cu",
        replaces="src/repro/eda/batched_flow.py:251",
        max_abs_err=float(max((g_ - w_).abs().max() for g_, w_
                              in zip(got, want))),
        ms=cuda_ms(lambda: mr.trace_paths(dist, tgts, tmask, nmask, *bufs),
                   50),
        plain_ms=cuda_ms(lambda: mr_ref.trace_paths_ref(
            dist, tgts, tmask, nmask, *bufs), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    print(f"kernel trace_paths: equal to plain on one ({bsz}, {gh}, {gw}) "
          f"slot ({int(want[1].sum())} routed, {int(want[2].sum())} failed); "
          f"{rows[-1]['ms']:.4f} ms vs plain {rows[-1]['plain_ms']:.4f} ms",
          flush=True)

    rows.append(evolve_kernel_check(dev))
    rows.append(route_kernel_check(dev, rng, gen, specs))
    rows.extend(acim_kernel_check(dev, rng))
    rows.extend(flash_kernel_check(dev))
    return rows


def evolve_inputs(dev, sizes, pop: int, gens: int):
    """(space, statics, genes, objs, stacked draws) of an explore dispatch
    of `sizes` (seeds 0, 1, ...), as `run_cell` makes them."""
    from repro_torch.core import nsga2

    space = nsga2.stack_spaces([nsga2.space_operands(
        nsga2.NSGA2Config(array_size=s)) for s in sizes]).to(dev)
    statics = nsga2.EvolveStatics(pop_size=pop)
    draws = nsga2.PhiloxDraws(range(len(sizes)), dev)
    genes = nsga2.init_population_op(draws.init(
        space.gene_lo.cpu().numpy(), space.gene_hi.cpu().numpy(), pop), space)
    objs = nsga2.evaluate_op(genes, space)
    return (space, statics, genes, objs,
            draws.generations(gens, pop, pop, statics))


def _evolve_work(cells: int, pop: int, gens: int, fronts: int):
    """(bytes, operations) an explore dispatch needs.  Bytes: the
    population read and the final genes, objectives and ranks written
    once, and the draws (int32 pairs, a flags byte, three float32 values
    a child).  Operations: per generation the dominance tests of the 2 P
    pool (two compares an objective a pair), the peel (an AND and an OR a
    word, for the fronts this run peeled), the sorts at n log2 n compares
    (crowding's four of the pool and of the survivors, selection's one)
    and the estimator (~40 a child); plus the initial rank."""
    n = 2 * pop
    sort = lambda k: k * max(1, (k - 1).bit_length())  # noqa: E731
    per_gen = (n * n * 4 * 2 + 4 * sort(n) + sort(n) + 4 * sort(pop)
               + 40 * pop)
    ops = cells * (gens * per_gen + pop * pop * 4 * 2 + 4 * sort(pop)
                   + fronts // cells * n * ((n + 31) // 32) * 2)
    nbytes = cells * (pop * (12 + 16) + 84 + gens * pop * (8 + 1 + 12)
                      + pop * (12 + 16 + 4))
    return nbytes, ops


def evolve_kernel_check(dev) -> dict:
    """nsga2_evolve against the composite loop on the card (EVOLVE_CASES),
    both timed on the first: the 16 kb request's dispatch."""
    import torch

    from repro_torch.core import nsga2
    from repro_torch.kernels.pareto_dom import ops as pd_ops

    row = None
    for sizes, pop, gens in EVOLVE_CASES:
        space, statics, genes, objs, draws = evolve_inputs(dev, sizes, pop,
                                                           gens)
        fronts = torch.zeros(len(sizes), dtype=torch.int32, device=dev)
        got = pd_ops.nsga2_evolve(draws, genes, objs, space, statics,
                                  fronts=fronts)

        def composite():
            return nsga2.evolve_composite(nsga2.StackedDraws(draws), genes,
                                          objs, space, statics, gens)

        want = composite()
        torch.cuda.synchronize()
        for g_, w_, what in zip(got, want, ("genes", "objectives", "ranks")):
            check(torch.equal(g_, w_), f"nsga2_evolve {what} != composite "
                                       f"at sizes {sizes}, pop {pop} x {gens}")
        peeled = int(fronts.sum())
        print(f"kernel nsga2_evolve: equal to the composite at sizes {sizes}, "
              f"pop {pop} x {gens} generations (genes, objectives, ranks); "
              f"fronts peeled {fronts.tolist()}", flush=True)
        if row is None:
            err = float(max((g_.double() - w_.double()).abs().max()
                            for g_, w_ in zip(got, want)))
            ms = cuda_ms(lambda: pd_ops.nsga2_evolve(draws, genes, objs,
                                                     space, statics), 20)
            plain_ms = cuda_ms(composite, 3)
            nbytes, ops = _evolve_work(len(sizes), pop, gens, peeled)
            b_ms, b_by = bound(nbytes, ops)
            row = dict(
                name="nsga2_evolve", route="cuda",
                source="src/repro_torch/csrc/pareto_dom.cu",
                replaces="src/repro/kernels/pareto_dom/kernel.py:112",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, fronts=peeled)
            print(f"kernel nsga2_evolve: one 16 kb dispatch (pop {pop} x "
                  f"{gens}): {ms:.4f} ms vs composite {plain_ms:.4f} ms, "
                  f"bound {b_ms:.6f} ms ({b_by}: {nbytes} bytes, {ops:.4g} "
                  f"operations); latency count {peeled} fronts peeled",
                  flush=True)
    return row


def request_bucket(specs, dev):
    """The routing inputs `batched_route` builds for the 16 kb request's
    layout of `specs` (one bucket), by the functions `generate_layouts`
    calls: occ0 (the pad at capacity, 0 on the grids), the nets (B, S,
    ...), the grids and the pad mask."""
    from repro_torch.eda import batched_flow as bf

    st = bf.layout_stages(specs, coarse=COARSE, device=dev)
    _, grids_t, outside, occ0 = bf.route_inputs(
        st.ops.width.cpu().numpy(), st.ops.height.cpu().numpy(),
        coarse=COARSE, capacity=CAPACITY, device=dev)
    return occ0, st.nets, grids_t, outside


def _events_ms(fn):
    """(fn's result, device ms of that one call, from CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _route_bytes(occ0, nets) -> int:
    """Bytes a route_slots call needs: occ0 read and occ written once, the
    nets and grids read once."""
    return (2 * occ0.numel() * 4 + sum(x.numel() * x.element_size()
                                       for x in nets) + occ0.shape[0] * 8)


def route_kernel_check(dev, rng, gen, specs) -> dict:
    """route_slots against its plain version: the 86 golden grids at 20 %
    random occupancy (drawn from `gen`) with the request's real nets, cut
    to the first ROUTE_CHECK_SLOTS slots (the plain version sweeps full
    fields, seconds a slot), where both are timed; and the large grids in
    one bucket with random nets (241 x 2178 keeps its counts and bitsets
    in device memory, 122 x 1090 its counts).  Then the kernel alone on
    the request's whole bucket (its own occupancy, every slot: the main
    path's launch, `bucket_ms`), with its BFS levels."""
    import numpy as np
    import torch

    from repro_torch.kernels.maze_route import kernel as mr
    from repro_torch.kernels.maze_route import ref as mr_ref

    occ0, nets, grids_t, outside = request_bucket(specs, dev)
    bsz, gh, gw = occ0.shape
    slots, targets = nets.tgts.shape[1:3]
    cut = [x[:, :ROUTE_CHECK_SLOTS].contiguous() for x in nets]
    busy = torch.where(torch.rand(occ0.shape, generator=gen, device=dev)
                       < 0.2, CAPACITY, 0)
    occ_r = torch.where(outside, CAPACITY, busy).to(torch.int32)
    got = mr.route_slots(occ_r, *cut, grids_t, CAPACITY)
    want, plain_ms = _events_ms(lambda: mr_ref.route_slots_ref(
        occ_r, *cut, grids_t, CAPACITY))
    for g_, w_, what in zip(got, want, ("occupancy", "routed", "failed",
                                        "wirelength")):
        check(torch.equal(g_, w_), f"route_slots {what} != plain on the "
                                   f"({bsz}, {gh}, {gw}) cut")
    err = float(max((g_ - w_).abs().max() for g_, w_ in zip(got, want)))
    cut_routed = int(want[1].sum())
    ms = cuda_ms(lambda: mr.route_slots(occ_r, *cut, grids_t, CAPACITY), 10)
    b_ms, b_by = bound(_route_bytes(occ_r, cut), 0)

    # the large grids in one bucket: 20 % occupancy, random nets
    n65 = ROUTE_BIG_SLOTS
    bh, bw = (max(g_[i] for g_ in BIG_GRIDS) for i in (0, 1))
    occ65 = torch.where(torch.rand((len(BIG_GRIDS), bh, bw), generator=gen,
                                   device=dev) < 0.2,
                        CAPACITY, 0).to(torch.int32)
    pts = np.stack([np.stack([rng.integers(0, h_, (n65, 1 + targets)),
                              rng.integers(0, w_, (n65, 1 + targets))], -1)
                    for h_, w_ in BIG_GRIDS])
    pts = torch.tensor(pts, dtype=torch.int32, device=dev)
    big_grids = torch.tensor(BIG_GRIDS, dtype=torch.int32, device=dev)
    occ65 = torch.where(mr_ref.outside_grids(occ65.shape, big_grids, dev),
                        CAPACITY, occ65).to(torch.int32)
    big = (pts[:, :, 0].contiguous(), pts[:, :, 1:].contiguous(),
           torch.ones((len(BIG_GRIDS), n65, targets), dtype=torch.bool,
                      device=dev),
           torch.ones((len(BIG_GRIDS), n65), dtype=torch.bool, device=dev),
           big_grids)
    levels65 = torch.zeros(len(BIG_GRIDS), dtype=torch.int32, device=dev)
    got65 = mr.route_slots(occ65, *big, CAPACITY, levels=levels65)
    want65 = mr_ref.route_slots_ref(occ65, *big, CAPACITY)
    for g_, w_, what in zip(got65, want65, ("occupancy", "routed", "failed",
                                            "wirelength")):
        check(torch.equal(g_, w_), f"route_slots {what} != plain on "
                                   f"the large grids {BIG_GRIDS}")
    big_ms = cuda_ms(lambda: mr.route_slots(occ65, *big, CAPACITY), 3)

    # past 32,767 masked targets a grid: uint32 counts, a hub's count past
    # 2^16 (the bucket of the CPU and `cuda` tests)
    sys.path.insert(0, str(ROOT / "tests"))
    from route_slots_model import hub_heavy_bucket

    wide = [torch.from_numpy(x).to(dev) for x in hub_heavy_bucket()]
    got_w = mr.route_slots(*wide, CAPACITY)
    want_w = mr_ref.route_slots_ref(*wide, CAPACITY)
    for g_, w_, what in zip(got_w, want_w, ("occupancy", "routed", "failed",
                                            "wirelength")):
        check(torch.equal(g_, w_), f"route_slots {what} != plain past 32,767 "
                                   f"masked targets")
    visits = int((wide[3] & wide[4][..., None]).sum((1, 2)).max())
    print(f"kernel route_slots: equal to plain on a bucket of "
          f"{tuple(wide[0].shape)} with {visits} masked targets a grid "
          f"(uint32 counts; largest occupancy {int(got_w[0].max())}; routed "
          f"{got_w[1].tolist()}, failed {got_w[2].tolist()})", flush=True)

    # the main path's launch: every slot, the request's own occupancy.
    # Latency binds it (one block barrier per BFS level, a dependent walk
    # per target); its count is printed beside.
    top, top_nets, all_levels = _bfs_levels(specs)
    bucket_ms = cuda_ms(lambda: mr.route_slots(occ0, *nets, grids_t,
                                               CAPACITY), 10)
    bucket_b_ms, _ = bound(_route_bytes(occ0, nets), 0)
    print(f"kernel route_slots: equal to plain on ({bsz}, {gh}, {gw}) at 20 % "
          f"random occupancy with the request's nets cut to the first "
          f"{ROUTE_CHECK_SLOTS} of {slots} slots ({cut_routed} routed, "
          f"{int(want[2].sum())} failed; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by})) and on the "
          f"large grids {BIG_GRIDS} with {n65} random slots each (routed "
          f"{want65[1].tolist()}, BFS levels {levels65.tolist()}, kernel "
          f"{big_ms:.4f} ms); whole request bucket ({slots} slots, "
          f"{int(nets.nmask.sum())} real nets, its own occupancy): "
          f"{bucket_ms:.4f} ms, bound {bucket_b_ms:.4f} ms (bytes); BFS "
          f"levels: longest grid {top} ({top_nets} nets), all grids "
          f"{all_levels}", flush=True)
    return dict(
        name="route_slots", route="cuda",
        source="src/repro_torch/csrc/maze_route.cu",
        replaces="src/repro/kernels/maze_route/kernel.py:71",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, bucket_ms=bucket_ms,
        bucket_bound_ms=bucket_b_ms)


def _adc_flip_share(got, want, delta: float) -> float:
    """Share of outputs where kernel and plain version differ; fails
    unless every difference is a whole number of ADC steps."""
    steps = (got - want).double() / delta
    check(bool(((steps - steps.round()).abs() <= 1e-3).all()),
          "acim_matmul differs from plain by a non-multiple of delta")
    return float((steps != 0).double().mean())


def _term_passes(x, w) -> int:
    """bf16 passes the wgmma route runs on x @ w: x's nonzero terms times
    w's (the three-term split; a term is skipped where its tile is all
    zero, counted here over the whole operand)."""
    import torch

    def terms(v):
        hi = v.to(torch.bfloat16).float()
        mid = (v - hi).to(torch.bfloat16).float()
        return 1 + int(bool(mid.any())) + int(bool((v - hi - mid).any()))

    return terms(x) * terms(w)


def _acim_operands(dev, rng, m, k, c, spec):
    """+-1 x and w, float x in [-1, 1] and mismatch-folded w: the checks'
    operands (the trainer's are x and wm)."""
    import torch

    from repro_torch.core.acim_numerics import NoiseParams
    from repro_torch.kernels.acim_matmul import ops as am

    x = torch.tensor(rng.choice([-1.0, 1.0], (m, k)), dtype=torch.float32,
                     device=dev)
    w = torch.tensor(rng.choice([-1.0, 1.0], (k, c)), dtype=torch.float32,
                     device=dev)
    xf = torch.rand((m, k), device=dev) * 2 - 1
    wm = am.mismatch_weights(w, spec, torch.randn((k, c), device=dev),
                             NoiseParams.from_cal())
    return x, w, xf, wm


def acim_bound(m: int, k: int, c: int, n: int,
               passes: int) -> tuple[float, str, dict]:
    """(ms, by, side) for one acim_matmul at (m, k, c), N, on any route:
    the larger of the bytes, the `passes` bf16 term products at the
    tensor-core peak and the M C K / N conversions at ACIM_ADC_INSTR
    instructions each at the float32 instruction rate (an FFMA counts
    two operations).  `side`: the same with the mma kernel's own
    ACIM_KERNEL_ADC_INSTR (`bound_adc3_ms`), and the floor of a kernel
    that keeps products and conversions on the CUDA cores, one float32
    FFMA pass plus the conversions on one pipe
    (`bound_cuda_core_pipe_ms`)."""
    nbytes = (m * k + k * c + m * c) * 4
    conv = m * c * k / n

    def adc(instr: int) -> float:
        return conv * instr / (PEAK_OPS_PER_S / 2) * 1e3

    tc, tc_by = bound(nbytes, passes * 2 * m * k * c, PEAK_BF16_TC_FLOPS)
    ms, by = ((adc(ACIM_ADC_INSTR), "operations")
              if adc(ACIM_ADC_INSTR) > tc else (tc, tc_by))
    side = dict(bound_adc3_ms=max(tc, adc(ACIM_KERNEL_ADC_INSTR)),
                bound_cuda_core_pipe_ms=bound(nbytes, 2 * m * k * c)[0]
                + adc(ACIM_ADC_INSTR))
    return ms, by, side


def acim_kernel_check(dev, rng) -> list[dict]:
    """The three acim_matmul routes against their plain version at the
    trainer's FFN shapes: the wgmma and the CUDA-core route with the
    codesign pick's (N, B) and with N 128, B 5, the mma route at N 8 / B
    3, N 4 / B 2 and N 2 / B 1 (`ACIM_SMALL_N`) with the CUDA-core route
    at the same N, and the CUDA-core route at N 24 / B 3 (an N it
    serves): bit-equal on +-1 operands; whole ADC steps on at most
    ACIM_FLIP_SHARE of outputs on mismatch-folded weights with +-1 and
    with float activations in [-1, 1].  Timed on the trainer's operands
    (+-1 activations, mismatch-folded weights); at the small N the mma
    and CUDA-core routes in turns (cuda_core, mma, mma, cuda_core).
    One row per route at the first shape and an N it serves: wgmma at
    the pick, mma at N 8 / B 3, cuda_core at N 24 / B 3 (its N 256 and N
    8 times beside).  f32 and bf16 torch.matmul of the same shapes are
    printed as a scale (the product without the ADC)."""
    import torch

    from repro_torch.core.acim_spec import MacroSpec
    from repro_torch.kernels.acim_matmul import kernel as ak
    from repro_torch.kernels.acim_matmul import ref as am_ref
    from repro_torch.train import acim_lm

    torch.backends.cuda.matmul.allow_tf32 = False      # exact f32 products
    cfg = acim_lm.build_cfg(TRAIN["d_model"], TRAIN["layers"])
    pick = acim_lm.pick_macro(cfg).spec
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    run = {"wgmma": ak.acim_matmul_wgmma, "mma": ak.acim_matmul_mma,
           "cuda_core": ak.acim_matmul_cuda_core}
    cases = ([(spec, ("wgmma", "cuda_core"))
              for spec in (pick, MacroSpec(256, 64, 2, 5))]
             + [(MacroSpec(*a), ("cuda_core", "mma")) for a in ACIM_SMALL_N]
             + [(MacroSpec(*ACIM_CUDA_CORE_MACRO), ("cuda_core",))])
    rows, by_n = {}, {}
    for spec, routes in cases:
        n, b = spec.n_caps, spec.b_adc
        delta = 2.0 * n / 2 ** b
        for m, k, c in ACIM_SHAPES:
            x, w, xf, wm = _acim_operands(dev, rng, m, k, c, spec)
            want = am_ref.acim_matmul_ref(x, w, n=n, b_adc=b)
            want_m = am_ref.acim_matmul_ref(x, wm, n=n, b_adc=b)
            want_f = am_ref.acim_matmul_ref(xf, wm, n=n, b_adc=b)
            plain_ms = cuda_ms(lambda: am_ref.acim_matmul_ref(
                x, wm, n=n, b_adc=b), 5)
            if n == pick.n_caps:
                f32_ms = cuda_ms(lambda: torch.matmul(x, wm), 20)
                xb, wb = x.bfloat16(), wm.bfloat16()
                bf16_ms = cuda_ms(lambda: torch.matmul(xb, wb), 20)
                print(f"scale acim_matmul ({m}, {k}, {c}): the product "
                      f"without the ADC, not the same function (never "
                      f"called by the port): f32 torch.matmul {f32_ms:.4f} "
                      f"ms, bf16 torch.matmul {bf16_ms:.4f} ms", flush=True)
            passes = _term_passes(x, wm)
            res = {}
            for route in routes:
                fn = run[route]
                got = fn(x, w, n, b)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"acim_matmul {route} != plain on +-1 ({m}, {k}, {c}), "
                      f"N={n}, B={b}")
                share = _adc_flip_share(fn(x, wm, n, b), want_m, delta)
                share_f = _adc_flip_share(fn(xf, wm, n, b), want_f, delta)
                check(share <= ACIM_FLIP_SHARE and share_f <= ACIM_FLIP_SHARE,
                      f"acim_matmul {route}: {share:.2e} / {share_f:.2e} of "
                      f"outputs flipped on mismatch-folded ({m}, {k}, {c}), "
                      f"N={n}, B={b} (+-1 / float x)")
                res[route] = dict(share=max(share, share_f), turns=[],
                                  err=float((got - want).abs().max()))
            # in turns: first, second, second, first
            for route in (routes + routes[::-1]) * 2:
                res[route]["turns"].append(
                    cuda_ms(lambda: run[route](x, wm, n, b), 20))
            for route in routes:
                t = sorted(res[route]["turns"])[len(res[route]["turns"]) // 2]
                b_ms, b_by, side = acim_bound(m, k, c, n, passes)
                extra = f"; {passes} bf16 passes"
                if route == "wgmma":
                    extra += f"; splits {ak.split_k(m, c, k, n, sms)}"
                elif route == "mma":
                    extra += (f"; ADC at {ACIM_KERNEL_ADC_INSTR} "
                              f"instructions {side['bound_adc3_ms']:.5f} ms;"
                              f" splits {ak.mma_split_k(m, c, k, sms)}")
                else:
                    extra += (f"; products and ADC on one CUDA-core pipe "
                              f"{side['bound_cuda_core_pipe_ms']:.5f} ms")
                print(f"kernel acim_matmul_{route}: equal to plain on +-1 "
                      f"({m}, {k}, {c}), N={n}, B={b}; mismatch-folded: "
                      f"{res[route]['share']:.2e} of outputs (+-1 or float x, "
                      f"the larger) whole ADC steps apart; {t:.5f} ms "
                      f"(turns {[round(v, 5) for v in res[route]['turns']]}) "
                      f"vs plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
                      f"({b_by}){extra}", flush=True)
                by_n.setdefault(route, {})[f"N{n}B{b} {m}x{k}x{c}"] = dict(
                    ms=t, bound_ms=b_ms, **side)
                name = f"acim_matmul_{route}"
                src = "acim_matmul" if route == "cuda_core" else name
                served = {"wgmma": n == pick.n_caps,
                          "mma": (n, b) == ACIM_SMALL_N_ROW,
                          "cuda_core": n % 16 and n not in ak.MMA_N}[route]
                if served and name not in rows:   # the first shape
                    rows[name] = dict(
                        name=name, route="cuda",
                        source=f"src/repro_torch/csrc/{src}.cu",
                        replaces="src/repro/kernels/acim_matmul/kernel.py:60",
                        max_abs_err=res[route]["err"], ms=t,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None, n=n, b=b,
                        bound_f32_ms=bound((m * k + k * c + m * c) * 4,
                                           2 * m * k * c)[0],
                        **side, flip_share=res[route]["share"])
    for name, row in rows.items():
        row["by_n"] = by_n[name.removeprefix("acim_matmul_")]
    return list(rows.values())


def _visible_pairs(s: int, t: int, causal: bool, prefix_len: int) -> int:
    """(query, key) pairs the mask lets through: what the function must
    compute, per batch row and head."""
    import numpy as np

    if not causal:
        return s * t
    r = np.arange(s, dtype=np.int64)
    seen = np.where(r < prefix_len, np.maximum(r + 1, prefix_len), r + 1)
    return int(np.minimum(seen, t).sum())


def _flash_excess(got, want) -> tuple[float, float]:
    """(max |got - want|, the largest excess over the tolerance): float32
    atol = rtol = FLASH_RTOL; bf16 one bf16 ulp of the output plus
    FLASH_RTOL (both sides compute in float32 and round once)."""
    import torch

    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(got.float().abs(), w))
        tol = torch.ldexp(torch.ones_like(w), e - 8) + FLASH_RTOL
    else:
        tol = FLASH_RTOL + FLASH_RTOL * w
    return float(d.max()), float((d - tol).max())


def _ulps(got, want):
    """(|got - want|, the same less FLASH_RTOL in bf16 ulps of each
    element, and in ulps of its row's largest output)."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    big = torch.maximum(g.abs(), w.abs())
    _, ee = torch.frexp(big)
    _, er = torch.frexp(big.amax(-1, keepdim=True))
    over = torch.clamp(d - FLASH_RTOL, min=0)
    return (d, over / torch.ldexp(torch.ones_like(d), ee - 8),
            over / torch.ldexp(torch.ones_like(d[..., :1]), er - 8))


def _tc_check(got, q, k, v, causal: bool, prefix_len: int,
              dump: bool) -> dict:
    """The tensor-core route against `flash_attention_tc_ref`.  Both round
    P to bf16 but reach p in float32 by different summation orders (the
    plain version sums the scores as `wgmma` does, `ref.tc_scores`, which
    leaves few such differences) and exp2s, so a p within float32 ulps of
    a bf16 rounding midpoint may round up on one and down on the other;
    one such flip moves its output row by
    up to ulp(p) |v - o| / l, many ulps of the row's small elements in a
    row with few visible keys.  With `dump`, the kernel's own P (from its
    P-dumping instantiation, whose output must equal `got`) must differ
    from the plain version's by such flips only (adjacent bf16 values), and
    the plain version fed the kernel's P must be within TC_ULPS of every
    output element.  Always: outputs beyond TC_ULPS of the plain version's
    own result at most TC_FLIP_SHARE of all, each within TC_FLIP_ROW_ULPS
    of its row's largest output.  Returns the measurements and `ok`."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fa_ref

    kw = dict(causal=causal, prefix_len=prefix_len)
    want = fa_ref.flash_attention_tc_ref(q, k, v, **kw)
    d, el, row = _ulps(got, want)
    exc = el > TC_ULPS
    r = dict(err=float(d.max()), n_out=got.numel(), n_flip=int(exc.sum()),
             flip_row_ulps=float(row[exc].max()) if bool(exc.any()) else 0.0)
    r["ok"] = (r["n_flip"] <= TC_FLIP_SHARE * r["n_out"]
               and r["flip_row_ulps"] <= TC_FLIP_ROW_ULPS)
    del want, d, el, row, exc
    if dump:
        out_p, p = fk.flash_attention_wgmma_p(q, k, v, **kw)
        r["dump_equal"] = torch.equal(out_p, got)
        step = (p.view(torch.int16)
                - fa_ref.flash_attention_tc_p(q, k, v, **kw).view(torch.int16))
        step = step.abs_()
        r["p_flips"], r["p_max_step"] = int((step != 0).sum()), int(step.max())
        del step
        fed = fa_ref.flash_attention_tc_ref(q, k, v, p_bf16=p, **kw)
        r["fed_ulps"] = float(_ulps(got, fed)[1].max())
        r["ok"] = (r["ok"] and r["dump_equal"] and r["p_max_step"] <= 1
                   and r["fed_ulps"] <= TC_ULPS)
    return r


def _tc_text(r: dict, pairs: int) -> str:
    """One line of `_tc_check`'s measurements."""
    text = ""
    if "p_flips" in r:
        same = "equal" if r["dump_equal"] else "NOT equal"
        text = (f"P: {r['p_flips']} of {pairs} visible entries one bf16 step "
                f"from the plain version's (largest step {r['p_max_step']}); "
                f"P-dump launch's output {same}; "
                f"plain version fed the kernel's P within "
                f"{r['fed_ulps']:.3f} element ulps (bound {TC_ULPS}); ")
    return text + (f"vs the plain version's own P: max err {r['err']:.3e}, "
                   f"{r['n_flip']} of {r['n_out']} outputs "
                   f"({r['n_flip'] / r['n_out']:.2e}, bound {TC_FLIP_SHARE}) "
                   f"beyond {TC_ULPS} element ulps, each within "
                   f"{r['flip_row_ulps']:.3f} row ulps (bound "
                   f"{TC_FLIP_ROW_ULPS})")


def _rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def _heads_first(x, rep: int):
    """(B, S, n, Dh) -> (B * n * rep, S, Dh), each head repeated `rep`
    times: the naive oracle's layout."""
    b, s, n, dh = x.shape
    return x.permute(0, 2, 1, 3).repeat_interleave(rep, 1).reshape(-1, s, dh)


def flash_kernel_check(dev) -> list[dict]:
    """Both flash attention routes against their plain versions: the
    3xTF32 kernel against `flash_attention_ref` (and the naive one),
    the tensor-core kernel against `flash_attention_tc_ref` (and, by rel
    L2, the float32-P versions); at the prefill's shape against the
    blockwise ones (the naive scores would take 68 GB), times of both
    kernels and SDPA in one call, in turns."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    torch.backends.cuda.matmul.allow_tf32 = False      # full f32 products
    g = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32

    def qkv(b, s, h, kv, dh, dtype):
        return [torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh))]

    # (b, s, h, kv, dh, dtype, causal, prefix_len)
    cases = [(4, 4096, 16, 2, 128, bf16, True, 0),
             (4, 4096, 16, 2, 128, f32, True, 0),
             (4, 4096, 16, 2, 128, bf16, True, 1000),
             (2, 4001, 16, 2, 128, f32, True, 0),
             (2, 4001, 16, 2, 128, bf16, True, 0),
             (2, 777, 8, 2, 128, f32, False, 0),
             (2, 777, 8, 2, 64, f32, True, 300),
             (2, 777, 8, 2, 64, bf16, True, 300),
             (2, 777, 8, 2, 32, bf16, True, 0),
             (2, 777, 8, 2, 16, f32, True, 0)]
    for b, s, h, kv, dh, dtype, causal, pre in cases:
        q, k, v = qkv(b, s, h, kv, dh, dtype)
        route = fk.route(dtype, dh)
        got = fa.flash_attention(q, k, v, causal=causal, prefix_len=pre)
        blockwise = fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                               prefix_len=pre)
        naive = fa_ref.attention_ref(
            _heads_first(q, 1), _heads_first(k, h // kv),
            _heads_first(v, h // kv), causal=causal, prefix_len=pre)
        naive = naive.reshape(b, h, s, dh).permute(0, 2, 1, 3)
        what = (f"({b}, {s}, {h}, {kv}, {dh}) {str(dtype)[6:]} "
                f"{'causal' if causal else 'full'} prefix {pre}")
        if route == "wgmma":
            rel, rel_n = _rel_l2(got, blockwise), _rel_l2(got, naive)
            r = _tc_check(got, q, k, v, causal, pre, dump=True)
            text = (f"flash_attention_wgmma {what}: "
                    f"{_tc_text(r, b * h * _visible_pairs(s, s, causal, pre))}"
                    f"; rel L2 {rel:.3e} vs float32-P blockwise, {rel_n:.3e} "
                    f"vs naive")
            check(r["ok"] and rel <= TC_F32P_REL_L2
                  and rel_n <= TC_F32P_REL_L2, text)
            print(f"kernel {text} (within tolerance)", flush=True)
        else:
            torch.cuda.synchronize()
            err, excess = _flash_excess(got, blockwise)
            err_n, excess_n = _flash_excess(got, naive)
            check(excess <= 0 and excess_n <= 0,
                  f"flash_attention {what}: max err {err:.3e} vs blockwise "
                  f"plain, {err_n:.3e} vs naive; beyond tolerance by "
                  f"{max(excess, excess_n):.3e}")
            print(f"kernel flash_attention {what}: max err {err:.3e} vs "
                  f"blockwise plain, {err_n:.3e} vs naive (within "
                  f"tolerance)", flush=True)
        del q, k, v, got, blockwise, naive

    # the prefill's shape: the 3xTF32 kernel on its own case (float32) and
    # the bf16 tensor-core kernel, each through its own wrapper, with SDPA
    # in the same dtype; bf16 at head dim 32 on the 3xTF32 kernel
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, s, h, kv, dh = PREFILL_BATCH, 32768, 16, 2, 128
    q32, k32, v32 = qkv(b, s, h, kv, dh, f32)
    tf = fk.flash_attention_tf32x3(q32, k32, v32)
    want = fa_ref.flash_attention_ref(q32, k32, v32)
    torch.cuda.synchronize()
    tf_err, tf_excess = _flash_excess(tf, want)
    check(tf_excess <= 0, f"flash_attention_tf32x3 ({b}, {s}, {h}, {kv}, "
                          f"{dh}) float32: max err {tf_err:.3e}, beyond "
                          f"atol = rtol = {FLASH_RTOL} by {tf_excess:.3e}")
    del tf, want
    q, k, v = (x.to(bf16) for x in (q32, k32, v32))
    tcg = fk.flash_attention_wgmma(q, k, v)
    want = fa_ref.flash_attention_ref(q, k, v)
    want_tc = fa_ref.flash_attention_tc_ref(q, k, v)
    rel_tc, rel_f32p = _rel_l2(tcg, want_tc), _rel_l2(tcg, want)
    rel_tc_f32p = _rel_l2(want_tc, want)
    del want, want_tc
    # P at this shape would take 34 GB: the share check only
    tc = _tc_check(tcg, q, k, v, True, 0, dump=False)
    tc_err, tc_text = tc["err"], _tc_text(tc, 0)
    check(tc["ok"] and rel_f32p <= TC_F32P_REL_L2,
          f"flash_attention_wgmma ({b}, {s}, {h}, {kv}, {dh}): {tc_text}; "
          f"rel L2 {rel_f32p:.3e} vs the float32-P plain version")
    del tcg
    d32 = SMALL_HEAD_DIM
    q16, k16, v16 = qkv(b, s, h, kv, d32, bf16)
    tf16 = fk.flash_attention_tf32x3(q16, k16, v16)
    want = fa_ref.flash_attention_ref(q16, k16, v16)
    torch.cuda.synchronize()
    tf16_err, tf16_excess = _flash_excess(tf16, want)
    check(tf16_excess <= 0, f"flash_attention_tf32x3 ({b}, {s}, {h}, {kv}, "
                            f"{d32}) bf16: max err {tf16_err:.3e}, beyond one "
                            f"ulp + {FLASH_RTOL} by {tf16_excess:.3e}")
    del tf16, want

    def heads(x, rep=1):     # (B, S, n, Dh) -> (B, n * rep, S, Dh)
        return x.transpose(1, 2).repeat_interleave(rep, 1).contiguous()

    # the memory-efficient backend (CUTLASS, float32 as 3xTF32 on
    # mma.sync) takes float32; forced, so that it raises rather than
    # falling back to the math backend; KV repeated outside the timing
    q32h, k32h, v32h = heads(q32), heads(k32, h // kv), heads(v32, h // kv)
    qh, kh, vh = heads(q), heads(k), heads(v)
    q16h, k16h, v16h = heads(q16), heads(k16), heads(v16)

    def sdpa_f32():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q32h, k32h, v32h,
                                                  is_causal=True)

    fns = {"tf32x3": (lambda: fk.flash_attention_tf32x3(q32, k32, v32), 5),
           "sdpa_f32": (sdpa_f32, 5),
           "wgmma": (lambda: fk.flash_attention_wgmma(q, k, v), 20),
           "sdpa": (lambda: F.scaled_dot_product_attention(
               qh, kh, vh, is_causal=True, enable_gqa=True), 20),
           "tf32x3_bf16_32": (
               lambda: fk.flash_attention_tf32x3(q16, k16, v16), 10),
           "sdpa_bf16_32": (lambda: F.scaled_dot_product_attention(
               q16h, k16h, v16h, is_causal=True, enable_gqa=True), 20)}
    times = {n: [] for n in fns}
    for order in (tuple(fns), tuple(reversed(tuple(fns)))):
        for n in order:
            times[n].append(cuda_ms(*fns[n]))
    ms = {n: sum(t) / len(t) for n, t in times.items()}
    sdpa_err = float((sdpa_f32().transpose(1, 2)
                      - fns["tf32x3"][0]()).abs().max())
    sdpa_tc_err = float((fns["sdpa"][0]().transpose(1, 2).float()
                         - fns["wgmma"][0]().float()).abs().max())
    plain_ms = cuda_ms(lambda: fa_ref.flash_attention_ref(q32, k32, v32), 1)
    tc_plain_ms = cuda_ms(lambda: fa_ref.flash_attention_tc_ref(q, k, v), 1)
    pairs = _visible_pairs(s, s, True, 0)
    flops = 4 * dh * h * b * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_TC_FLOPS)
    # float32: three TF32 products for each, at the TF32 peak; the FFMA
    # bound of a CUDA-core design beside it
    b32_ms, b32_by = bound(2 * nbytes, 3 * flops, PEAK_TF32_TC_FLOPS)
    ffma_ms = bound(2 * nbytes, flops)[0]
    flops32 = 4 * d32 * h * b * pairs
    # bf16 at 32: the function's flops at the bf16 tensor-core peak; the
    # design's (one TF32 product for S, two for P.V) beside it
    bytes16 = (2 * q16.numel() + k16.numel() + v16.numel()) * 2
    b16_ms, b16_by = bound(bytes16, flops32, PEAK_BF16_TC_FLOPS)
    b16_tf32_ms = bound(bytes16, 1.5 * flops32, PEAK_TF32_TC_FLOPS)[0]
    print(f"kernel flash_attention ({b}, {s}, {h}, {kv}, {dh}) causal, one "
          f"call in turns (ms each: {times}); SDPA float32 forced to "
          f"{SDPBackend.EFFICIENT_ATTENTION.name} (KV repeated to {h} "
          f"heads), bf16 SDPA on its default backend with enable_gqa",
          flush=True)
    print(f"  tf32x3 float32: {ms['tf32x3']:.3f} ms, "
          f"{flops / ms['tf32x3'] / 1e9:.1f} TFLOP/s, bound {b32_ms:.4f} ms "
          f"({b32_by}: 3 x {flops:.3e} TF32 flops at "
          f"{PEAK_TF32_TC_FLOPS / 1e12:.1f} T/s; FFMA bound {ffma_ms:.4f} "
          f"ms), {b32_ms / ms['tf32x3']:.3f} of the bound, "
          f"{ms['tf32x3'] / ms['sdpa_f32']:.3f}x SDPA float32 "
          f"({ms['sdpa_f32']:.3f} ms); max err {tf_err:.3e} vs float32 "
          f"blockwise plain (atol = rtol = {FLASH_RTOL}), max |SDPA - "
          f"tf32x3| {sdpa_err:.3e}", flush=True)
    print(f"  wgmma bf16: {ms['wgmma']:.3f} ms, "
          f"{flops / ms['wgmma'] / 1e9:.1f} TFLOP/s, bound {b_ms:.4f} ms "
          f"({b_by}: {flops:.3e} flops, {nbytes / 1e6:.1f} MB), "
          f"{b_ms / ms['wgmma']:.3f} of the bound, "
          f"{ms['wgmma'] / ms['sdpa']:.3f}x SDPA ({ms['sdpa']:.3f} ms); max "
          f"err {tc_err:.3e} vs tc plain ({tc_text}); rel L2 {rel_tc:.3e} vs "
          f"tc plain, {rel_f32p:.3e} vs float32-P blockwise plain; max "
          f"|SDPA - wgmma| {sdpa_tc_err:.3e}", flush=True)
    print(f"  tf32x3 bf16 at head dim {d32}: {ms['tf32x3_bf16_32']:.3f} ms "
          f"(bound {b16_ms:.4f} ms, {b16_by}: {flops32:.3e} flops at "
          f"{PEAK_BF16_TC_FLOPS / 1e12:.1f} T/s; {b16_tf32_ms:.4f} ms for "
          f"the design's one TF32 product for S and two for P.V), "
          f"{ms['tf32x3_bf16_32'] / ms['sdpa_bf16_32']:.3f}x SDPA "
          f"bf16 ({ms['sdpa_bf16_32']:.3f} ms); max err {tf16_err:.3e} vs "
          f"float32-P blockwise plain (within one ulp + {FLASH_RTOL})",
          flush=True)
    print(f"  plain versions: flash_attention_ref (float32) {plain_ms:.3f} "
          f"ms, flash_attention_tc_ref (bf16) {tc_plain_ms:.3f} ms (the "
          f"two rel L2 {rel_tc_f32p:.3e} apart on the bf16 inputs)",
          flush=True)
    common = dict(replaces="src/repro/kernels/flash_attention/kernel.py:59")
    return [dict(name="flash_attention", route="cuda",
                 source="src/repro_torch/csrc/flash_attention.cu",
                 max_abs_err=tf_err, ms=ms["tf32x3"], plain_ms=plain_ms,
                 bound_ms=b32_ms, bound_by=b32_by,
                 library_ms=ms["sdpa_f32"], bound_ffma_ms=ffma_ms,
                 bf16_32_ms=ms["tf32x3_bf16_32"], bf16_32_bound_ms=b16_ms,
                 bf16_32_tf32_bound_ms=b16_tf32_ms,
                 bf16_32_library_ms=ms["sdpa_bf16_32"], **common),
            dict(name="flash_attention_wgmma", route="cuda",
                 source="src/repro_torch/csrc/flash_attention_wgmma.cu",
                 max_abs_err=tc_err, ms=ms["wgmma"], plain_ms=tc_plain_ms,
                 bound_ms=b_ms, bound_by=b_by, library_ms=ms["sdpa"],
                 **common)]


# ----------------------------------------------------------------------
# Phase 3: the main path
# ----------------------------------------------------------------------
def _close(a, b) -> bool:
    if isinstance(b, bool) or isinstance(b, int):
        return type(a) is type(b) and a == b
    return math.isclose(a, b, rel_tol=FLOAT_RTOL, abs_tol=0.0)


def check_golden(art, golden: dict, what: str) -> list:
    """The 16 kb seed-0 artifact against the golden exhaustive front: its
    front inside it, covering >= 60 %, and every layout row equal to the
    golden row of its spec (integers exactly, floats to FLOAT_RTOL).
    Returns the front's (h, l, b_adc) keys."""
    found = [(s.h, s.l, s.b_adc) for s in art.pareto.specs]
    check(set(found) <= set(golden),
          f"{what}: front has points off the golden front: "
          f"{set(found) - set(golden)}")
    check(len(set(found)) >= 0.6 * len(golden),
          f"{what}: front covers {len(set(found))} of {len(golden)} golden "
          f"points")
    check(art.layout_rows is not None and len(art.layout_rows) == len(found),
          f"{what}: missing layout rows")
    for key, row in zip(found, art.layout_rows):
        want = golden[key]
        check(row.keys() == want.keys(), f"{what}: row keys differ for {key}")
        bad = [k for k in want if not _close(row[k], want[k])]
        check(not bad, f"{what}: row {key} differs from golden in {bad}: "
                       f"{[(row[k], want[k]) for k in bad]}")
    return found


def path_phase() -> dict:
    import torch

    from repro_torch.api import DesignRequest, DesignSession
    from repro_torch.kernels import LAUNCHES

    golden = {tuple(p_["key"]): p_["row"] for p_ in golden_points()}
    session = DesignSession()

    LAUNCHES.clear()
    t0 = time.perf_counter()
    art = session.run(DesignRequest(array_size=16384))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    main_launches = dict(LAUNCHES)
    found = check_golden(art, golden, "path")
    prov = art.provenance
    print(f"path run: 16384, pop 256 x 80 gens: front {len(found)} of "
          f"{len(golden)} golden points, {len(found)} layout rows equal to "
          f"golden; explore {prov.explore_s:.2f} s, layout "
          f"{prov.layout_s:.2f} s, total {total:.2f} s; route slots "
          f"{prov.route_rounds}", flush=True)
    print(f"path launches: {main_launches}", flush=True)
    # One explore dispatch: one nsga2_evolve launch runs every generation.
    check(main_launches.get("nsga2_evolve", 0) == 1
          and main_launches.get("nds_rank", 0) == 0,
          f"explore launches on the path: {main_launches}")

    # The composite loop (torch ops, one nds_rank launch a generation) on
    # the card from the same seed finds the same front.
    LAUNCHES.clear()
    t0 = time.perf_counter()
    comp = _composite_front(16384, 0)
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t0
    comp_launches = dict(LAUNCHES)
    check(comp.specs == art.pareto.specs,
          "the composite loop's front differs from the request's")
    check(comp_launches.get("nds_rank", 0) == 81
          and comp_launches.get("nsga2_evolve", 0) == 0,
          f"composite launches: {comp_launches}")
    print(f"path composite explore (torch ops + nds_rank): same front of "
          f"{len(comp.specs)} specs; {comp_s:.2f} s; launches "
          f"{comp_launches}", flush=True)

    LAUNCHES.clear()
    t0 = time.perf_counter()
    art2 = session.run(DesignRequest(array_size=16384,
                                     use_pallas_dominance=True, layout=False))
    torch.cuda.synchronize()
    dom_launches = dict(LAUNCHES)
    found2 = {(s.h, s.l, s.b_adc) for s in art2.pareto.specs}
    check(found2 == set(found), "dominance-route front differs from the "
                                "request's")
    check(dom_launches.get("nsga2_evolve", 0) == 0,
          f"dominance route launched nsga2_evolve: {dom_launches}")
    print(f"path dominance route (layout=False): front {len(found2)} of "
          f"{len(golden)}, the request's; {time.perf_counter() - t0:.2f} s; "
          f"launches {dom_launches}", flush=True)

    launches = {"nsga2_evolve": main_launches.get("nsga2_evolve", 0),
                "route_slots": main_launches.get("route_slots", 0),
                "dominance_matrix": dom_launches.get("dominance_matrix", 0)}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on its path")
    # The whole front is one layout bucket: one route_slots launch, and
    # the standalone wavefront / trace_paths kernels stay off the path, as
    # does nds_rank (the composite loop's rank).
    launches.update(nds_rank=main_launches.get("nds_rank", 0),
                    wavefront=main_launches.get("wavefront", 0),
                    trace_paths=main_launches.get("trace_paths", 0))
    check(launches["route_slots"] == 1 and launches["wavefront"] == 0
          and launches["trace_paths"] == 0,
          f"route launches on the path: {main_launches}")
    levels = _bfs_levels(list(art.pareto.specs))
    print(f"path route: 1 route_slots launch; BFS levels of the longest grid "
          f"{levels[0]} ({levels[1]} nets), all grids {levels[2]} "
          f"(recounted by a second launch on the same bucket)", flush=True)

    # A spec past 32,767 masked targets: uint32 counts.
    from repro_torch.core.acim_spec import MacroSpec

    spec = MacroSpec(*WIDE_SPEC)
    n0 = LAUNCHES["route_slots"]
    t0 = time.perf_counter()
    res = session.layout([spec])
    torch.cuda.synchronize()
    check(LAUNCHES["route_slots"] == n0 + 1, "wide layout: no route_slots")
    routing = res.routing
    print(f"path wide layout: {spec}, grid {routing.grids.tolist()}, "
          f"{routing.rounds} net slots: routed {int(routing.routed[0])}, "
          f"failed {int(routing.failed[0])}, wirelength "
          f"{int(routing.wirelength[0])}; {time.perf_counter() - t0:.2f} s",
          flush=True)
    return launches


def _composite_front(size: int, seed: int):
    """The request's exploration of one (size, seed) cell at the default
    budget, run by the composite loop (`nsga2.evolve_composite`)."""
    from repro_torch.core import nsga2
    from repro_torch.core.batched_explorer import explore_cells

    statics = nsga2.EvolveStatics()

    def composite(seeds, spaces):
        draws = nsga2.PhiloxDraws(seeds, spaces.gene_lo.device)
        genes = nsga2.init_population_op(draws.init(
            spaces.gene_lo.cpu().numpy(), spaces.gene_hi.cpu().numpy(),
            statics.pop_size).to(spaces.gene_lo.device), spaces)
        objs = nsga2.evaluate_op(genes, spaces)
        return nsga2.evolve_composite(draws, genes, objs, spaces, statics,
                                      80)[:2]

    return explore_cells([(size, seed)], program=composite)[(size, seed)]


def _bfs_levels(specs) -> tuple[int, int, int]:
    """(BFS levels of the grid with the most, its real nets, levels of all
    grids) of the route_slots launch that lays out `specs` as one bucket."""
    import torch

    from repro_torch.kernels.maze_route import kernel as mr

    dev = torch.device("cuda")
    occ0, nets, grids_t, _ = request_bucket(specs, dev)
    levels = torch.zeros(len(specs), dtype=torch.int32, device=dev)
    mr.route_slots(occ0, *nets, grids_t, CAPACITY, levels=levels)
    lv = levels.cpu().numpy()
    top = int(lv.argmax())
    return int(lv[top]), int(nets.nmask[top].sum()), int(lv.sum())


# ----------------------------------------------------------------------
# Phase 4: the CIM-in-the-loop trainer
# ----------------------------------------------------------------------
def _edp_rank(cfg, pick, golden: list[dict], floor: float) -> tuple[int, int]:
    """Rank (1 = best) of the pick's workload-weighted energy-delay score
    (`codesign.edp_scores`) among the golden front's points that meet the
    SNR floor."""
    import numpy as np

    from repro_torch.core import codesign
    from repro_torch.core.acim_spec import MacroSpec
    from repro_torch.core.explorer import ParetoResult

    # objectives are (-SNR dB, -TOPS, energy fJ/MAC, area)
    ok = [p_ for p_ in golden if -p_["objectives"][0] >= floor]
    front = ParetoResult(16384, tuple(MacroSpec(*(p_["row"][k] for k in (
        "h", "w", "l", "b_adc"))) for p_ in ok), {
        "tops": np.array([-p_["objectives"][1] for p_ in ok]),
        "energy_fj_per_mac": np.array([p_["objectives"][2] for p_ in ok])})
    edp = [sc[3] for sc in codesign.edp_scores(cfg, front)]
    mine = edp[front.specs.index(pick)]
    return 1 + sum(int(v < mine) for v in edp), len(edp)


def train_phase() -> dict:
    import dataclasses

    import torch

    from repro_torch.data.synthetic import batch_for
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models.lm import init_lm
    from repro_torch.quant.cim_linear import CIMConfig
    from repro_torch.train import acim_lm

    golden = golden_points()
    cfg = acim_lm.build_cfg(TRAIN["d_model"], TRAIN["layers"])
    floor = acim_lm.PICK["min_snr_db"]

    LAUNCHES.clear()
    t0 = time.perf_counter()
    rec = acim_lm.pick_macro(cfg)
    torch.cuda.synchronize()
    pick_s = time.perf_counter() - t0
    pick = rec.spec
    keys = {tuple(p_["key"]) for p_ in golden}
    check((pick.h, pick.l, pick.b_adc) in keys,
          f"codesign pick {pick} is not on the golden 16 kb front")
    check(rec.snr_db >= floor, f"pick SNR {rec.snr_db} dB < {floor} dB")
    rank, n_ok = _edp_rank(cfg, pick, golden, floor)
    print(f"train pick: {pick} (N={pick.n_caps}, B={pick.b_adc}), SNR "
          f"{rec.snr_db:.2f} dB, util {rec.utilization:.3f}; on the golden "
          f"front, energy-delay rank {rank} of {n_ok} points >= {floor} dB; "
          f"explore {pick_s:.2f} s", flush=True)

    cim = CIMConfig(pick)
    model = init_lm(cfg, seed=0)
    log = acim_lm.train(model, cfg, cim, steps=TRAIN["steps"],
                        seq=TRAIN["seq"], batch=TRAIN["batch"],
                        lr=TRAIN["lr"], log=lambda s_: print("  " + s_))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    losses = log.losses
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not decrease: {losses}")
    per_fwd = 2 * cfg.n_layers
    want_n = per_fwd * TRAIN["steps"]
    check(launches.get("acim_matmul", 0) == want_n
          and launches.get("acim_matmul_wgmma", 0) == want_n
          and launches.get("acim_matmul_cuda_core", 0) == 0,
          f"acim_matmul launched {launches.get('acim_matmul', 0)} times "
          f"(wgmma {launches.get('acim_matmul_wgmma', 0)}, cuda_core "
          f"{launches.get('acim_matmul_cuda_core', 0)}), want {per_fwd} x "
          f"{TRAIN['steps']} forwards, all on the wgmma route")
    check(launches.get("nsga2_evolve", 0) > 0,
          "nsga2_evolve not launched by the pick")
    steady = log.step_s[1:]
    step_ms = 1e3 * sum(steady) / len(steady)
    print(f"train run: {TRAIN['steps']} steps at d {cfg.d_model}, "
          f"{cfg.n_layers} layers, seq {TRAIN['seq']}, batch "
          f"{TRAIN['batch']}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"step {1e3 * log.step_s[0]:.1f} ms first, {step_ms:.2f} ms mean "
          f"of steps 1-{TRAIN['steps'] - 1}", flush=True)
    print(f"train losses: {[round(v, 4) for v in losses]}")
    print(f"train launches: {launches}", flush=True)

    # step 0 on the card against the plain run on the CPU
    cut = dataclasses.replace(cfg, n_layers=CPU_CHECK_LAYERS)
    batch = batch_for(cut, TRAIN["seq"], TRAIN["batch"], 0)
    losses0 = []
    for dev in (model.emb.device, torch.device("cpu")):
        t0 = time.perf_counter()
        m_ = init_lm(cut, seed=0, device=dev)
        b_ = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad():
            losses0.append(float(acim_lm.loss_fn(m_, b_, cut, cim)))
        print(f"  step-0 loss on {dev}: {losses0[-1]:.6f} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
    card, host = losses0
    rel = abs(card - host) / abs(host)
    check(rel <= CPU_CHECK_RTOL,
          f"step-0 loss on the card {card} vs CPU {host}: rel {rel:.2e} > "
          f"{CPU_CHECK_RTOL}")
    print(f"train check: step-0 loss at {CPU_CHECK_LAYERS} layers, card vs "
          f"CPU plain, rel diff {rel:.2e} (rtol {CPU_CHECK_RTOL})", flush=True)

    # the mma route's path: the same trainer at full width on a macro of
    # the 1 kb exhaustive front whose chunk is N 8 (NARROW_MACRO_ARGS)
    from repro_torch.core.acim_spec import MacroSpec

    spec_n = MacroSpec(*NARROW_MACRO_ARGS)
    narrow = CIMConfig(spec_n)
    LAUNCHES.clear()
    log_n = acim_lm.train(init_lm(cfg, seed=0), cfg, narrow,
                          steps=TRAIN["steps"], seq=TRAIN["seq"],
                          batch=TRAIN["batch"], lr=TRAIN["lr"],
                          log=lambda s_: print("  " + s_))
    torch.cuda.synchronize()
    narrow_launches = dict(LAUNCHES)
    losses_n = log_n.losses
    check(all(math.isfinite(v) for v in losses_n),
          f"non-finite loss on {spec_n}: {losses_n}")
    n_mma = narrow_launches.get("acim_matmul_mma", 0)
    check(n_mma == want_n and narrow_launches.get("acim_matmul", 0) == want_n
          and narrow_launches.get("acim_matmul_wgmma", 0) == 0
          and narrow_launches.get("acim_matmul_cuda_core", 0) == 0,
          f"N {spec_n.n_caps} run launches: {narrow_launches}, want "
          f"{want_n} acim_matmul_mma and no other acim_matmul route")
    steady_n = log_n.step_s[1:]
    step_ms_n = 1e3 * sum(steady_n) / len(steady_n)
    print(f"train narrow run: {spec_n} (N={spec_n.n_caps}, B="
          f"{spec_n.b_adc}), {TRAIN['steps']} steps at full width: loss "
          f"{losses_n[0]:.4f} -> {losses_n[-1]:.4f} (last below first: "
          f"{losses_n[-1] < losses_n[0]}); step {1e3 * log_n.step_s[0]:.1f} "
          f"ms first, {step_ms_n:.2f} ms mean of steps 1-"
          f"{TRAIN['steps'] - 1} (the pick's {step_ms:.2f}); "
          f"acim_matmul_mma {n_mma} launches", flush=True)
    print(f"train narrow losses: {[round(v, 4) for v in losses_n]}")

    # step 0 on the card against the CPU on that macro
    losses0 = []
    for dev in (model.emb.device, torch.device("cpu")):
        m_ = init_lm(cut, seed=0, device=dev)
        b_ = {k: v.to(dev) for k, v in batch.items()}
        LAUNCHES.clear()
        with torch.no_grad():
            losses0.append(float(acim_lm.loss_fn(m_, b_, cut, narrow)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            check_launches = dict(LAUNCHES)
    card, host = losses0
    rel = abs(card - host) / abs(host)
    check(check_launches.get("acim_matmul_mma", 0) == 2 * cut.n_layers
          and check_launches.get("acim_matmul", 0) == 2 * cut.n_layers,
          f"N {spec_n.n_caps} forward launches: {check_launches}")
    check(math.isfinite(card) and rel <= CPU_CHECK_RTOL,
          f"N {spec_n.n_caps} step-0 loss on the card {card} vs CPU "
          f"{host}: rel {rel:.2e}")
    print(f"train route check: {spec_n} (N={spec_n.n_caps}) at "
          f"{CPU_CHECK_LAYERS} layers: acim_matmul_mma "
          f"{check_launches['acim_matmul_mma']} launches; step-0 loss card "
          f"vs CPU rel diff {rel:.2e} (rtol {CPU_CHECK_RTOL})", flush=True)
    return {"acim_matmul_wgmma": launches["acim_matmul_wgmma"],
            "acim_matmul_mma": n_mma,
            "acim_matmul_cuda_core": launches.get("acim_matmul_cuda_core", 0)
            + narrow_launches.get("acim_matmul_cuda_core", 0),
            "nsga2_evolve": launches["nsga2_evolve"]}


# ----------------------------------------------------------------------
# Phase 5: long-context prefill of qwen2.5-3b at full width
# ----------------------------------------------------------------------
def _attn_calls(cfg) -> int:
    """Flash attention calls of one forward: one a layer (whisper's: one
    a decoder layer), or for the hybrid family one a group of
    `shared_attn_every` Mamba2 layers (its shared block); none for the
    SSM family."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.shared_attn_every
    return cfg.n_layers


def _prefill(step, params, batch, cfg, what: str, tensor_cores: bool = True,
             keep: bool = False,
             inst: str | None = None) -> tuple[float, int, object]:
    """One prefill with the launch counts zeroed just before it and read
    just after: (seconds, flash_attention launches of either route, the
    logits if `keep` else None); the logits must be finite and of the
    batch's shape (the VLM's cover its patches too), and every attention
    call (`_attn_calls`) must launch the route `tensor_cores` names (the
    bf16 `wgmma` kernel, else the 3xTF32 one), and,
    where `inst` names a tensor-core instantiation's count, that
    instantiation."""
    import torch

    from repro_torch.kernels import LAUNCHES

    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = step.fn(params, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n, n_tc = LAUNCHES["flash_attention"], LAUNCHES["flash_attention_wgmma"]
    n_tf = LAUNCHES["flash_attention_tf32x3"]
    b, s = batch["inputs"].shape
    if "patches" in batch:
        s += batch["patches"].shape[1]
    check(tuple(logits.shape) == (b, s, cfg.vocab),
          f"prefill {what}: logits {tuple(logits.shape)}")
    # a sequence's logits are up to 17 GB: checked in slices, so the
    # check's temporaries stay small beside the prefill's peak
    check(all(bool(torch.isfinite(x).all()) for x in logits.split(2048, 1)),
          f"prefill {what}: non-finite logits")
    calls = _attn_calls(cfg)
    check(n == calls and n_tc == (n if tensor_cores else 0)
          and n_tf == n - n_tc,
          f"prefill {what}: flash_attention launched {n} times, "
          f"flash_attention_wgmma {n_tc}, flash_attention_tf32x3 {n_tf}; "
          f"want {calls}, {calls if tensor_cores else 0} and "
          f"{0 if tensor_cores else calls}")
    check(inst is None or LAUNCHES[inst] == calls,
          f"prefill {what}: {inst} launched {LAUNCHES[inst]} times, want "
          f"{calls}")
    check(calls or not any(LAUNCHES.values()),
          f"prefill {what}: launched kernels of ours {dict(LAUNCHES)}")
    return dt, n, logits if keep else None


def _card_vs_cpu_prefill(cut, seq: int) -> tuple[float, tuple, float]:
    """`cut` (a config cut to a few layers at full width) with bf16
    weights drawn from seed 0 on the card and copied to the CPU, run on
    both over one `seq`-token sequence (blockwise attention; the SSM
    family's mLSTM chunkwise; whisper's encoder over the batch's frames):
    (rel L2 of the last position's logits card vs CPU, (card argmax, CPU
    argmax), the draw and copy's seconds)."""
    import torch

    from repro_torch.data.synthetic import batch_for
    from repro_torch.models import whisper
    from repro_torch.models.lm import lm_hidden, lm_logits
    from repro_torch.models.registry import build_model

    t0 = time.perf_counter()
    card = build_model(cut).init(seed=0, dtype=torch.bfloat16,
                                 draw_on="cuda")
    host = copy.deepcopy(card).to("cpu")
    draw_s = time.perf_counter() - t0
    batch = batch_for(cut, seq, 1, 2)
    toks = batch["inputs"]
    last = []
    for model, d in ((card, torch.device("cuda")),
                     (host, torch.device("cpu"))):
        t0 = time.perf_counter()
        with torch.inference_mode():
            if cut.family == "audio":
                enc = whisper.encode(model, batch["frames"].to(d), cut)
                last.append(whisper.decode_fwd(
                    model, toks.to(d), enc, cut,
                    attn_impl="blockwise")[:, -1:].float().cpu())
            else:
                hid, _ = lm_hidden(model, toks.to(d), cut,
                                   attn_impl="blockwise",
                                   mlstm_chunked=cut.family == "ssm")
                last.append(lm_logits(model, hid[:, -1:], cut).float().cpu())
        print(f"  {cut.name} cut to {cut.n_layers} layers, prefill of {seq} "
              f"tokens on {d}: {time.perf_counter() - t0:.2f} s", flush=True)
    on_card, on_cpu = last
    rel = float((on_card - on_cpu).norm() / on_cpu.norm())
    return rel, (int(on_card.argmax()), int(on_cpu.argmax())), draw_s


def prefill_phase(flash_ms: float) -> tuple[dict, object]:
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention as attn
    from repro_torch.models.common import apply_norm, causal_mask
    from repro_torch.models.lm import init_lm

    dev = torch.device("cuda")
    cfg = registry.get(PREFILL_CONFIG)
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16, draw_on="cuda")
    torch.cuda.synchronize()
    n_params = sum(p_.numel() for p_ in params.parameters())
    n_bytes = sum(p_.numel() * p_.element_size() for p_ in params.parameters())
    print(f"prefill init: {cfg.name}, {n_params:,} parameters, "
          f"{n_bytes / 1e9:.2f} GB serving weights, drawn from seed 0 on the "
          f"card in {time.perf_counter() - t0:.2f} s", flush=True)

    shape = dataclasses.replace(SHAPES["prefill_32k"], batch=PREFILL_BATCH)
    step = make_prefill_step(cfg, shape)
    batch = batch_for(cfg, *step.batch_shapes["inputs"][::-1], 0)
    torch.cuda.reset_peak_memory_stats()
    warm_s, _, _ = _prefill(step, params, batch, cfg, "warm-up")
    dt, launches, _ = _prefill(step, params, batch, cfg, "timed")
    tokens = shape.batch * shape.seq
    print(f"prefill run: {shape.batch} x {shape.seq} tokens, {cfg.n_layers} "
          f"layers: {dt:.3f} s ({warm_s:.3f} s warm-up), {tokens / dt:,.0f} "
          f"tokens/s; flash_attention_wgmma {launches} launches; attention share "
          f"~{cfg.n_layers * flash_ms / 1e3 / dt:.3f} of the wall time "
          f"({cfg.n_layers} x the kernel's {flash_ms:.1f} ms); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)

    b4, s4 = SMALL_PREFILL
    step4 = make_prefill_step(cfg, dataclasses.replace(shape, batch=b4,
                                                       seq=s4))
    batch4 = batch_for(cfg, *step4.batch_shapes["inputs"][::-1], 1)
    dt4, n4, _ = _prefill(step4, params, batch4, cfg, f"{b4} x {s4}")
    print(f"prefill run: {b4} x {s4} tokens: {dt4:.3f} s, "
          f"{b4 * s4 / dt4:,.0f} tokens/s; flash_attention_wgmma {n4} "
          f"launches", flush=True)

    # one full-width layer: blockwise (the kernel) against dense attention
    blk = params.blocks[0]
    with torch.inference_mode():
        x = params.emb[batch4["inputs"][:1, :DENSE_CHECK_SEQ].to(dev)].to(
            torch.bfloat16)
        h = apply_norm(blk.ln1, x, cfg.norm)
        pos = torch.arange(DENSE_CHECK_SEQ, device=dev)
        dense = attn.attention_fwd(blk.attn, h, cfg, positions=pos,
                                   mask=causal_mask(DENSE_CHECK_SEQ, dev))
        block = attn.attention_fwd_blockwise(blk.attn, h, cfg, positions=pos)
    rel = float((block.float() - dense.float()).norm() / dense.float().norm())
    check(rel <= DENSE_CHECK_RTOL, f"blockwise vs dense attention at S "
                                   f"{DENSE_CHECK_SEQ}: rel L2 {rel:.3e}")
    print(f"prefill check: layer 0 at S {DENSE_CHECK_SEQ}, blockwise vs "
          f"dense attention rel L2 {rel:.3e} (tolerance {DENSE_CHECK_RTOL}), "
          f"max abs {float((block.float() - dense.float()).abs().max()):.3e}",
          flush=True)
    del blk, x, h, dense, block

    # the same weights on the card and on the CPU
    rel, top, draw_s = _card_vs_cpu_prefill(
        dataclasses.replace(cfg, n_layers=PREFILL_CPU_LAYERS), PREFILL_CPU_SEQ)
    check(math.isfinite(rel) and rel <= PREFILL_CPU_RTOL,
          f"prefill card vs CPU: last-position logits rel L2 {rel:.3e}")
    print(f"prefill check: {PREFILL_CPU_LAYERS} layers, full width, seq "
          f"{PREFILL_CPU_SEQ} (weights drawn and copied in {draw_s:.1f} s): "
          f"last-position logits card vs CPU rel L2 {rel:.3e} (tolerance "
          f"{PREFILL_CPU_RTOL}), argmax "
          f"{'agrees' if top[0] == top[1] else 'differs'} ({top[0]} vs "
          f"{top[1]})", flush=True)

    # the 3xTF32 route: a config whose head dim the bf16 tensor-core kernel
    # does not take (the reduced qwen2.5, head dim 16), card vs CPU
    small = registry.reduced(PREFILL_CONFIG)
    s_shape = dataclasses.replace(shape, batch=2, seq=SMALL_ROUTE_SEQ)
    s_step = make_prefill_step(small, s_shape)
    s_host = init_lm(small, seed=0, device="cpu", dtype=torch.bfloat16)
    s_batch = batch_for(small, SMALL_ROUTE_SEQ, 2, 3)
    _, n_cc, s_logits = _prefill(s_step, copy.deepcopy(s_host).to(dev),
                                 s_batch, small, "3xTF32 route",
                                 tensor_cores=False, keep=True)
    with torch.inference_mode():
        want = make_prefill_step(small, s_shape, device="cpu").fn(
            s_host, s_batch)
    rel = float((s_logits.float().cpu() - want.float()).norm()
                / want.float().norm())
    check(rel <= PREFILL_CPU_RTOL, f"3xTF32 route prefill card vs CPU: "
                                   f"rel L2 {rel:.3e}")
    print(f"prefill route check: {small.name} (head dim "
          f"{small.resolved_head_dim}), 2 x {SMALL_ROUTE_SEQ}: flash_attention "
          f"(3xTF32) {n_cc} launches; logits card vs CPU rel L2 "
          f"{rel:.3e} (tolerance {PREFILL_CPU_RTOL})", flush=True)
    # the full-width serving weights stay for phase 9's decode
    return {"flash_attention_wgmma": launches, "flash_attention": n_cc}, params


# ----------------------------------------------------------------------
# Phase 6: the multi-tenant service
# ----------------------------------------------------------------------
def service_requests() -> list:
    """Phase 6's traffic, eight tickets at the default budget (pop 256, 80
    generations, coarse 64, capacity 4), in submission order: 16384 seed 0
    with no requirements, seeds 1-3 with (min_tops 0.5, min_snr_db 10),
    4096 seeds 0 and 1, 65536 seed 0 front only, and last a poison ticket
    whose requirements remove every point."""
    from repro_torch.api import DesignRequest, Requirements

    req = Requirements(min_tops=0.5, min_snr_db=10)
    return [DesignRequest(array_size=16384, seed=0),
            DesignRequest(array_size=16384, seed=1, requirements=req),
            DesignRequest(array_size=4096, seed=0),
            DesignRequest(array_size=65536, seed=0, layout=False),
            DesignRequest(array_size=16384, seed=2, requirements=req),
            DesignRequest(array_size=16384, seed=3, requirements=req),
            DesignRequest(array_size=4096, seed=1),
            DesignRequest(array_size=16384, seed=4,
                          requirements=Requirements(min_tops=1e9))]


def serve_tickets(svc, reqs) -> tuple[list, float]:
    """Submit every request to `svc` under `serve()`, collect every
    artifact, close.  Returns (artifacts, seconds from the first submit to
    the last artifact collected)."""
    import torch

    with svc.serve():
        t0 = time.perf_counter()
        tickets = [svc.submit(r) for r in reqs]
        arts = [svc.collect(t, timeout=600) for t in tickets]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return arts, wall


def service_phase(card: str) -> dict:
    import shutil
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import DesignSession
    from repro_torch.kernels import LAUNCHES
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.serve.design_service import DesignService

    golden = {tuple(p_["key"]): p_["row"] for p_ in golden_points()}
    reqs = service_requests()
    good, poison = reqs[:-1], reqs[-1]
    root = Path(tempfile.mkdtemp(prefix="service_cache_",
                                 dir=ROOT / "build"))
    try:
        # (a) the traffic through a pipelined service over the cache
        svc = DesignService(DesignSession(artifact_cache=root),
                            **SERVICE)
        LAUNCHES.clear()
        arts, wall = serve_tickets(svc, reqs)
        launches = dict(LAUNCHES)
        stats, metrics = svc.stats(), svc.metrics()
        seq = DesignSession().run_many(reqs, strict=False)
        for r, a in zip(reqs, arts):
            check(a.request == r and a.provenance.pipelined,
                  f"service: ticket of {r.sha()} came back wrong")
            check(a.summary() == seq[r].summary(),
                  f"service: {r.array_size} seed {r.seed} differs from "
                  f"run_many")
            check(a.ok == seq[r].ok and a.error == seq[r].error,
                  f"service: {r.sha()} error {a.error!r}")
        check(all(a.ok for a in arts[:-1]), "service: a good ticket failed")
        check(not arts[-1].ok and arts[-1].error.startswith(
            f"requirements {poison.requirements} removed every Pareto "
            f"point for request {poison.sha()}"),
              f"service: poison ticket: {arts[-1].error!r}")
        found = check_golden(arts[0], golden, "service")
        # (b) launch accounting across the pipelined run
        check(stats["bucket_retries"] == stats["shed_buckets"] == 0,
              f"service: unexpected retries {stats}")
        # every batch's cells share the budget: one explore dispatch each
        check(launches.get("nsga2_evolve", 0) == stats["explorer_dispatches"]
              == stats["service_batches"] > 0,
              f"service: nsga2_evolve {launches} vs "
              f"{stats['explorer_dispatches']} explore dispatches, "
              f"{stats['service_batches']} batches")
        check(launches.get("route_slots", 0) == stats["layout_dispatches"]
              > 0, f"service: route_slots {launches} vs "
                   f"{stats['layout_dispatches']} layout attempts")
        for name in ("nds_rank", "wavefront", "trace_paths"):
            check(launches.get(name, 0) == 0,
                  f"service: {name} launched: {launches}")
        lat = metrics["metrics"]["design_ticket_latency_seconds"][0]
        busy = {k: round(v, 4) for k, v in stats["stage_busy_s"].items()}
        print(f"service ({card}): {len(reqs)} tickets in "
              f"{stats['service_batches']} batches in "
              f"{wall:.3f} s = {len(reqs) / wall:.2f} requests/s; ticket "
              f"latency p50 {lat['summary']['p50']:.3f} s, p99 "
              f"{lat['summary']['p99']:.3f} s; explore/layout overlap "
              f"fraction {stats['pipeline_overlap_fraction']:.3f} "
              f"({stats['pipeline_overlap_s']:.3f} s); stage busy s {busy}; "
              f"{stats['layout_dispatches']} layout buckets; 16384 seed 0: "
              f"{len(found)} rows equal to golden; equal to run_many on a "
              f"second session", flush=True)
        print(f"service launches ({card}): {launches}", flush=True)

        # (c) a fresh service and session over the same cache root
        warm_svc = DesignService(DesignSession(artifact_cache=root),
                                 **SERVICE)
        LAUNCHES.clear()
        warm, warm_wall = serve_tickets(warm_svc, good)
        warm_launches = dict(LAUNCHES)
        for a, b in zip(warm, arts):
            check(a.provenance.served_from == "artifact_cache",
                  f"service warm: served from {a.provenance.served_from}")
            check(a.summary() == b.summary(), "service warm: summary differs")
        check(sum(warm_launches.values()) == 0,
              f"service warm: kernels launched: {warm_launches}")
        print(f"service warm cache ({card}): {len(good)} tickets from the "
              f"artifact cache in {warm_wall:.3f} s, launches "
              f"{warm_launches}", flush=True)

        # (d) one injected layout fault: the first layout unit raises
        # before its dispatch and is retried
        inj = FailureInjector(fail_at={"layout": [0]})
        fault_svc = DesignService(DesignSession(), injector=inj,
                                  telemetry=True, **SERVICE)
        LAUNCHES.clear()
        faulted, _ = serve_tickets(fault_svc, reqs[:2])
        fault_launches = dict(LAUNCHES)
        st = fault_svc.stats()
        buckets = {sp.bucket for sp in fault_svc.trace().spans
                   if sp.cat == "stage" and sp.name == "layout"}
        for a, b in zip(faulted, arts):
            check(a.ok and a.summary() == b.summary(),
                  "service fault: rows differ from the traffic run's")
        check(inj.fired == [("layout", 0, "node")]
              and st["bucket_retries"] == 1 and st["bucket_failures"] == 0,
              f"service fault: {inj.fired}, {st['bucket_retries']} retries")
        check(sum(a.provenance.retried_buckets for a in faulted) >= 1,
              "service fault: no artifact names the retried bucket")
        # the fault fires ahead of the dispatch: the bucket's two
        # attempts launch route_slots once
        check(fault_launches.get("route_slots", 0) == len(buckets)
              == st["layout_dispatches"],
              f"service fault: route_slots {fault_launches} for "
              f"{len(buckets)} buckets")
        print(f"service fault ({card}): layout unit 0 failed and was retried;"
              f" {len(buckets)} buckets, {len(buckets) + 1} layout attempts,"
              f" {fault_launches.get('route_slots', 0)} route_slots launches;"
              f" rows equal", flush=True)

        # the traffic again, under the profiler: the device-to-host copies
        # (the congestion maps dominate) against the pool's layout time
        prof_svc = DesignService(DesignSession(), **SERVICE)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, prof_wall = serve_tickets(prof_svc, reqs)
        dev = [(e.key, e.count, e.self_device_time_total)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
        d2h = [r for r in dev if "DtoH" in r[0]]
        d2h_s = sum(r[2] for r in d2h) / 1e6
        pst = prof_svc.stats()
        pool_s = pst["stage_busy_s"]["layout"]
        worker_s = prof_svc.metrics()["metrics"][
            "design_bucket_layout_seconds"][0]["sum"]
        device_s = sum(r[2] for r in dev) / 1e6
        print(f"service profiled ({card}): wall {prof_wall:.3f} s, device "
              f"{device_s:.3f} s (busy share {device_s / prof_wall:.3f}); "
              f"device-to-host copies {d2h_s * 1e3:.1f} ms over "
              f"{sum(r[1] for r in d2h)} copies = "
              f"{d2h_s / pool_s:.3f} of the layout pool's busy "
              f"{pool_s:.3f} s ({worker_s:.3f} worker-seconds)", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {k: launches.get(k, 0) for k in ("nsga2_evolve", "route_slots")}


# ----------------------------------------------------------------------
# Phase 7: the concurrent routing engine and the sequential layout flow
# ----------------------------------------------------------------------
def _row_diff(row: dict, want: dict) -> list:
    """Keys where `row` differs from the golden `want` (integers exactly,
    floats to FLOAT_RTOL), or ["keys"] when the key sets differ."""
    if row.keys() != want.keys():
        return ["keys"]
    return [k for k in want if not _close(row[k], want[k])]


def concurrent_check(specs, golden_rows) -> dict:
    """(a) The 16 kb request's whole-front bucket laid out by the
    concurrent engine on the card: rows equal to golden, occupancy equal
    to the scan engine's on the same bucket, and one `wavefront` launch
    for each round that had BFS lanes (the engine's only kernel)."""
    import numpy as np
    import torch

    from repro_torch.eda import batched_flow as bf
    from repro_torch.kernels import LAUNCHES

    LAUNCHES.clear()
    t0 = time.perf_counter()
    res = bf.generate_layouts(specs, coarse=COARSE, capacity=CAPACITY,
                              engine="concurrent", device="cuda",
                              record_schedule=True)
    torch.cuda.synchronize()
    conc_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    routing, sched = res.routing, res.routing.schedule
    for i, (row, want) in enumerate(zip(res.metrics_rows(), golden_rows)):
        bad = _row_diff(row, want)
        check(not bad, f"concurrent engine: row {i} ({specs[i]}) differs "
                       f"from golden in {bad}")
    bfs_rounds = sum(1 for n in sched.bfs_lanes if n)
    check(launches.get("wavefront", 0) == bfs_rounds
          and launches.get("route_slots", 0) == 0
          and launches.get("trace_paths", 0) == 0,
          f"concurrent engine launches {launches}, {bfs_rounds} rounds with "
          f"BFS lanes")
    check(bfs_rounds > 0, "concurrent engine ran no BFS lane")
    lanes = int(sum(sched.bfs_lanes))
    _, gh, gw = routing.occ_count.shape
    copied = lanes * gh * gw * 4

    LAUNCHES.clear()
    t0 = time.perf_counter()
    scan = bf.generate_layouts(specs, coarse=COARSE, capacity=CAPACITY,
                               engine="scan", device="cuda")
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    check(LAUNCHES.get("route_slots", 0) == 1,
          f"scan engine launches {dict(LAUNCHES)}")
    check(np.array_equal(routing.occ_count, scan.routing.occ_count),
          "concurrent engine occupancy != the scan engine's")
    check(res.metrics_rows() == scan.metrics_rows(),
          "concurrent engine rows != the scan engine's")
    print(f"layout concurrent: ({len(specs)}, {gh}, {gw}) bucket, "
          f"{int(routing.routed.sum())} routed / {int(routing.failed.sum())} "
          f"failed nets, rows equal to golden and occupancy to the scan "
          f"engine's; {routing.rounds} rounds ({bfs_rounds} with BFS lanes), "
          f"{routing.collisions} collisions, {sched.crossings} crossings, "
          f"{lanes} BFS lanes (at most {max(sched.bfs_lanes)} a round), "
          f"{launches.get('wavefront', 0)} wavefront launches, "
          f"{copied} bytes copied back; {conc_s:.3f} s against the scan "
          f"engine's {scan_s:.3f} s", flush=True)
    return dict(launches=launches.get("wavefront", 0), seconds=conc_s,
                scan_seconds=scan_s, rounds=routing.rounds,
                bfs_rounds=bfs_rounds, lanes=lanes, copied=copied)


def _flow_specs(specs) -> list[int]:
    """Indices of the FLOW_SPECS specs with the largest routing grids
    (cells), in that order."""
    from repro_torch.eda.placer import geometry, layout_operands
    from repro_torch.eda.router import grid_shape

    geom = geometry()
    cells = [math.prod(grid_shape(o.width, o.height, COARSE))
             for o in (layout_operands(s, geom) for s in specs)]
    return sorted(range(len(specs)), key=lambda i: -cells[i])[:FLOW_SPECS]


def _net_wavefront(lr):
    """The per-net `wavefront` input of a laid-out spec: its grid blocked
    where its wires reach capacity, seeded at its longest net's hub."""
    import numpy as np
    import torch

    gh, gw = lr.routing.grid_shape
    count = np.zeros((gh, gw), np.int32)
    for w in lr.routing.wires:
        for y, x in w.points:
            count[y, x] += 1
    seed = np.zeros((1, gh, gw), bool)
    seed[(0,) + lr.routing.wires[0].points[0]] = True
    return (torch.from_numpy(count[None] >= CAPACITY).cuda(),
            torch.from_numpy(seed).cuda())


def flow_check(specs, golden_rows) -> dict:
    """(b) `flow.generate_layout` on the card for the FLOW_SPECS specs
    with the largest grids: metrics (but the clock) equal to golden,
    wires totalling the wirelength, one `wavefront` launch per net of
    two or more pins.  Then `wavefront` timed at the per-net shape."""
    import torch

    from repro_torch.eda import flow
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.maze_route import kernel as mr
    from repro_torch.kernels.maze_route import ref as mr_ref

    total = 0
    times = []
    first = None
    for i in _flow_specs(specs):
        LAUNCHES.clear()
        t0 = time.perf_counter()
        lr = flow.generate_layout(specs[i], device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        n = LAUNCHES.get("wavefront", 0)
        nets = sum(1 for _, pins in flow._top_level_nets(specs[i],
                                                          lr.placement)
                   if len(pins) >= 2)
        check(n == nets and len(LAUNCHES) == 1,
              f"flow {specs[i]}: launches {dict(LAUNCHES)}, {nets} nets")
        m = lr.metrics()
        del m["elapsed_s"]
        bad = _row_diff(m, golden_rows[i])
        check(not bad, f"flow {specs[i]}: metrics differ from golden in {bad}")
        check(sum(len(w.points) for w in lr.routing.wires)
              == m["wirelength"], f"flow {specs[i]}: wires != wirelength")
        total += n
        first = first or lr
    occ, seed = _net_wavefront(first)
    dist = mr.wavefront(occ, seed)
    check(torch.equal(dist, mr_ref.wavefront_distance_ref(occ, seed)),
          f"wavefront != plain at {tuple(occ.shape)}")
    cells = occ.numel()
    net_ms = cuda_ms(lambda: mr.wavefront(occ, seed), 200)
    net_plain_ms = cuda_ms(lambda: mr_ref.wavefront_distance_ref(occ, seed),
                           5)
    net_bound_ms, _ = bound(cells * (4 + 2), 0)
    net_levels = bfs_levels(dist)
    print(f"layout flow: generate_layout on the card for the {len(times)} "
          f"specs with the largest grids ({first.routing.grid_shape} first): "
          f"metrics equal to golden, wires total the wirelength, {total} "
          f"wavefront launches (one a net); s per spec "
          f"{[round(t, 3) for t in times]}; wavefront at "
          f"{tuple(occ.shape)}: {net_ms:.4f} ms, plain {net_plain_ms:.4f} "
          f"ms, bound {net_bound_ms:.6f} ms (bytes); {net_levels} BFS levels, "
          f"{net_ms / net_levels * 1e3:.4f} us a level", flush=True)
    return dict(launches=total, seconds=times, net_ms=net_ms,
                net_plain_ms=net_plain_ms, net_bound_ms=net_bound_ms,
                net_levels=net_levels, net_ms_per_level=net_ms / net_levels)


def layout_engines_phase() -> dict:
    from repro_torch.core.acim_spec import MacroSpec

    points = golden_points()
    specs = [MacroSpec(p_["row"]["h"], p_["row"]["w"], p_["row"]["l"],
                       p_["row"]["b_adc"]) for p_ in points]
    rows = [p_["row"] for p_ in points]
    t0 = time.perf_counter()
    conc = concurrent_check(specs, rows)
    seq = flow_check(specs, rows)
    print(f"layout engines phase: {time.perf_counter() - t0:.2f} s",
          flush=True)
    return dict(concurrent=conc, flow=seq)


# ----------------------------------------------------------------------
# Phase 8: the device-mesh explorer
# ----------------------------------------------------------------------
def _counted(fn):
    """(fn(), the launches it made): the counts zeroed just before the
    call and read just after it."""
    import torch

    from repro_torch.kernels import LAUNCHES

    LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(LAUNCHES)


def _island_round0(dev, islands: int, pop: int, gens: int):
    """(draws, space, statics, genes, objs) of round 0 of an island run of
    ISLAND_CELL on one position: its k = `islands` populations, made as
    `explore_cells_mesh` makes them."""
    from repro_torch.core import nsga2
    from repro_torch.parallel import distributed_explorer as dx

    draws = dx.PhiloxIslands()
    space = nsga2.stack_spaces([nsga2.space_operands(
        nsga2.NSGA2Config(array_size=ISLAND_CELL[0]))] * islands).to(dev)
    statics = nsga2.EvolveStatics(pop_size=pop)
    genes, objs = nsga2.run_cell(draws(range(islands), 0, [ISLAND_CELL], dev),
                                 space, statics=statics, n_gens=gens)
    return draws, space, statics, genes, objs


def _migration_rank_check(dev) -> dict:
    """`nds_rank` at the migration shape of phase 8 (b) on one position:
    the (k C, P, 4) = (8, 96, 4) populations the first migration ranks,
    made as the island run makes them.  Equal to plain; timed, with its
    bound."""
    import torch

    from repro_torch.core import pareto
    from repro_torch.kernels.pareto_dom import kernel as pd

    _, _, _, _, objs = _island_round0(dev, ISLAND_RUN["islands"],
                                      ISLAND_RUN["pop_size"],
                                      ISLAND_RUN["migrate_every"])
    f = objs.contiguous()
    got, want = pd.nds_rank(f), pareto.non_dominated_rank(f)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"nds_rank != plain at the migration "
                                  f"shape {tuple(f.shape)}")
    c, p, m = f.shape
    fronts = int((want.amax(-1) + 1).sum())
    b_ms, b_by = bound(c * p * m * 4 + c * p * 4,
                       c * p * p * m * 2 + fronts * p * (p // 32) * 2)
    out = dict(migration_shape=list(f.shape),
               migration_ms=cuda_ms(lambda: pd.nds_rank(f), 200),
               migration_device_ms=profiler_ms(lambda: pd.nds_rank(f), 50,
                                               "nds_rank"),
               migration_plain_ms=cuda_ms(
                   lambda: pareto.non_dominated_rank(f), 20),
               migration_bound_ms=b_ms, migration_bound_by=b_by)
    print(f"mesh nds_rank at the migration shape {tuple(f.shape)}: equal to "
          f"plain ({fronts} fronts over the {c} populations); "
          f"{out['migration_ms']:.4f} ms by events (profiler device "
          f"{out['migration_device_ms']:.5f} ms) vs plain "
          f"{out['migration_plain_ms']:.4f} ms, bound {b_ms:.7f} ms "
          f"({b_by})", flush=True)
    return out


def _migrated_evolve_check(dev, islands: int, pop: int, gens: int) -> None:
    """`nsga2_evolve` on the block the island path hands it after the
    first migration (one position, k = `islands` populations of
    ISLAND_CELL, round 1's draws), against the composite loop on the same
    block and draws: genes, objectives and ranks equal."""
    import torch

    from repro_torch.core import nsga2
    from repro_torch.kernels.pareto_dom import ops as pd_ops
    from repro_torch.parallel import distributed_explorer as dx

    draws, space, statics, genes, objs = _island_round0(dev, islands, pop,
                                                        gens)
    shape = (islands, 1, pop)
    (mg, mo), = dx.migrate([(genes.reshape(shape + (3,)),
                             objs.reshape(shape + (4,)))], statics=statics,
                           n_elite=dx._elite_count(pop))
    mg, mo = mg.reshape(islands, pop, 3), mo.reshape(islands, pop, 4)
    check(not (torch.equal(mg, genes) and torch.equal(mo, objs)),
          f"mesh migrate left the ({islands}, {pop}) block as it was")
    stacked = draws(range(islands), 1, [ISLAND_CELL], dev).generations(
        gens, pop, pop, statics)
    got = pd_ops.nsga2_evolve(stacked, mg, mo, space, statics)
    want = nsga2.evolve_composite(nsga2.StackedDraws(stacked), mg, mo, space,
                                  statics, gens)
    torch.cuda.synchronize()
    for g_, w_, what in zip(got, want, ("genes", "objectives", "ranks")):
        check(torch.equal(g_, w_), f"nsga2_evolve {what} != composite on "
                                   f"the migrated ({islands}, {pop}) block")
    print(f"kernel nsga2_evolve: equal to the composite on the migrated "
          f"island block ({islands} populations, pop {pop} x {gens}, round "
          f"1's draws; genes, objectives, ranks)", flush=True)


def mesh_phase(card: str) -> dict:
    import collections

    import numpy as np
    import torch

    from repro_torch.api import DesignRequest, DesignSession
    from repro_torch.core import nsga2
    from repro_torch.core.batched_explorer import explore_cells, sweep_program
    from repro_torch.parallel import distributed_explorer as dx
    from repro_torch.serve.design_service import DesignService

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    golden = {tuple(p_["key"]): p_["row"] for p_ in golden_points()}
    total: collections.Counter = collections.Counter()

    # (a) sharded cells: each position's block is one run_cell, final
    # populations and fronts equal to the single-device engine's
    cells = list(SHARDED_CELLS)
    statics = nsga2.EvolveStatics()
    spaces = [nsga2.space_operands(nsga2.NSGA2Config(array_size=s))
              for s, _ in cells]
    want_g, want_o = sweep_program([sd for _, sd in cells],
                                   nsga2.stack_spaces(spaces).to(dev),
                                   statics=statics, n_gens=80)
    want_g, want_o = want_g.cpu().numpy(), want_o.cpu().numpy()
    want = explore_cells(cells)
    for mesh in (("cuda:0",), ("cuda:0", "cuda:0")):
        t0 = time.perf_counter()
        pops, launches = _counted(lambda: dx._sharded(
            cells, spaces, dx.as_mesh(mesh), statics, 80))
        dt = time.perf_counter() - t0
        for i, cell in enumerate(cells):
            check(np.array_equal(pops[cell][0], want_g[i])
                  and np.array_equal(pops[cell][1], want_o[i]),
                  f"mesh sharded {mesh}: population of {cell} differs from "
                  f"explore_cells'")
        check(launches == {"nsga2_evolve": len(mesh)},
              f"mesh sharded {mesh}: launches {launches}")
        total.update(launches)
        (fronts, facts), launches = _counted(
            lambda: dx.explore_cells_mesh(cells, mesh=mesh))
        check(facts == {"mesh_devices": len(mesh), "islands": 1,
                        "migration_topology": "sharded",
                        "migration_rounds": 0}, f"mesh sharded facts {facts}")
        for cell in cells:
            check(fronts[cell].to_rows() == want[cell].to_rows(),
                  f"mesh sharded {mesh}: front of {cell} differs")
        total.update(launches)
        print(f"mesh sharded ({card}): cells {cells} at pop 256 x 80 on "
              f"{len(mesh)} position(s): genes, objectives and fronts equal "
              f"to explore_cells; {dt:.3f} s, launches {launches}",
              flush=True)

    # (b) islands at the reference's slow-test parameters, on 1, 2, 4 and
    # 8 positions of the one card
    truth = set(golden)
    rows0 = None
    for n in ISLAND_MESHES:
        t0 = time.perf_counter()
        (fronts, facts), launches = _counted(lambda: dx.explore_cells_mesh(
            [ISLAND_CELL], mesh=("cuda:0",) * n, **ISLAND_RUN))
        dt = time.perf_counter() - t0
        rounds = len(dx._round_schedule(ISLAND_RUN["generations"],
                                        ISLAND_RUN["migrate_every"]))
        check(facts == {"mesh_devices": n,
                        "islands": ISLAND_RUN["islands"],
                        "migration_topology": "ring",
                        "migration_rounds": rounds - 1},
              f"mesh islands on {n}: facts {facts}")
        check(launches == {"nsga2_evolve": rounds * n,
                           "nds_rank": (rounds - 1) * n},
              f"mesh islands on {n}: launches {launches}, want "
              f"{rounds} nsga2_evolve and {rounds - 1} nds_rank a position")
        total.update(launches)
        rows = fronts[ISLAND_CELL].to_rows()
        check(rows0 is None or rows == rows0,
              f"mesh islands: the front on {n} positions differs from 1's")
        rows0 = rows
        found = {(s.h, s.l, s.b_adc) for s in fronts[ISLAND_CELL].specs}
        check(found <= truth, f"mesh islands: points off the golden front "
                              f"{found - truth}")
        check(len(found) >= ISLAND_COVER * len(truth),
              f"mesh islands: {len(found)} of {len(truth)} golden points")
        print(f"mesh islands ({card}): {ISLAND_RUN} on {n} position(s): "
              f"{facts}; front {len(found)} of {len(truth)} golden points, "
              f"equal to 1 position's; {dt:.3f} s; launches {launches}",
              flush=True)
    migration = _migration_rank_check(dev)
    _migrated_evolve_check(dev, ISLAND_RUN["islands"], ISLAND_RUN["pop_size"],
                           ISLAND_RUN["migrate_every"])

    # (c) an island request through the session, laid out on the card
    session = DesignSession()
    req = DesignRequest(array_size=ISLAND_CELL[0], islands=4)
    _migrated_evolve_check(dev, req.islands, req.pop_size, req.migrate_every)
    t0 = time.perf_counter()
    art, launches = _counted(lambda: session.run(req))
    req_s = time.perf_counter() - t0
    found = check_golden(art, golden, "mesh request")
    prov = art.provenance
    n_dev = dx.devices_for_islands(dx.default_mesh(), 4)
    rounds = len(dx._round_schedule(req.generations, req.migrate_every))
    check((prov.mesh_devices, prov.islands, prov.migration_topology,
           prov.migration_rounds) == (n_dev, 4, "ring", rounds - 1),
          f"mesh request provenance {prov}")
    check(session.stats["mesh_dispatches"] == 1
          and launches.get("nsga2_evolve", 0) == rounds * n_dev
          and launches.get("nds_rank", 0) == (rounds - 1) * n_dev
          and launches.get("route_slots", 0) == 1,
          f"mesh request: launches {launches}")
    total.update({k: launches.get(k, 0) for k in ("nsga2_evolve",
                                                  "nds_rank")})
    print(f"mesh request ({card}): DesignRequest(16384, islands=4): front "
          f"{len(found)} of {len(golden)} golden points, every layout row "
          f"equal to golden; provenance mesh_devices {prov.mesh_devices}, "
          f"islands {prov.islands}, {prov.migration_topology}, "
          f"{prov.migration_rounds} rounds; {req_s:.3f} s (explore "
          f"{prov.explore_s:.3f} s); launches {launches}", flush=True)

    # the island dispatch against the single-island explore of the same
    # cell, in turns
    def island():
        return dx.explore_cells_mesh([ISLAND_CELL], islands=4)

    def single():
        return explore_cells([ISLAND_CELL])

    times: dict = {"single": [], "island": []}
    for _ in range(ISLAND_TURNS):
        for name, fn in (("single", single), ("island", island),
                         ("island", island), ("single", single)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"mesh timing ({card}): 16384 seed 0, pop 256 x 80, in turns: "
          f"4-island dispatch (20-generation rounds) median "
          f"{med['island'] * 1e3:.2f} ms {[round(t * 1e3, 2) for t in times['island']]}; "
          f"single-island explore median {med['single'] * 1e3:.2f} ms "
          f"{[round(t * 1e3, 2) for t in times['single']]}", flush=True)

    # (d) the service over a two-position ring on the one card
    svc = DesignService(mesh=("cuda:0", "cuda:0"), **SERVICE)
    reqs = [DesignRequest(array_size=16384, seed=1, islands=2),
            DesignRequest(array_size=4096, seed=0, islands=2, layout=False),
            DesignRequest(array_size=4096, seed=1)]
    (arts, wall), launches = _counted(lambda: serve_tickets(svc, reqs))
    seq = DesignSession(mesh=("cuda:0", "cuda:0")).run_many(reqs)
    for r, a in zip(reqs, arts):
        check(a.ok and a.summary() == seq[r].summary(),
              f"mesh service: {r.array_size} seed {r.seed} islands "
              f"{r.islands} differs from run_many")
    facts = [(a.provenance.mesh_devices, a.provenance.migration_topology)
             for a in arts]
    check(facts == [(2, "ring"), (2, "ring"), (2, "sharded")],
          f"mesh service provenance {facts}")
    mesh_total = svc.metrics()["metrics"]["design_mesh_dispatches_total"][0][
        "value"]
    check(mesh_total >= 1, "mesh service: design_mesh_dispatches_total 0")
    total.update({k: launches.get(k, 0) for k in ("nsga2_evolve",
                                                  "nds_rank")})
    print(f"mesh service ({card}): {len(reqs)} tickets (two island, one "
          f"plain) over ('cuda:0', 'cuda:0') in {wall:.3f} s, equal to "
          f"run_many; design_mesh_dispatches_total {mesh_total}; provenance "
          f"{facts}; launches {launches}", flush=True)
    print(f"mesh phase: {time.perf_counter() - t_phase:.2f} s; launches "
          f"{dict(total)}", flush=True)
    return dict(launches={k: total.get(k, 0) for k in ("nsga2_evolve",
                                                       "nds_rank")},
                **migration)


# ----------------------------------------------------------------------
# Phase 9: single-token decode and the serving engine
# ----------------------------------------------------------------------
def _first_layers(cfg, params, n: int):
    """(`cfg` cut to n layers, a view of the LM `params` with its first
    n blocks): the same tensors, nothing copied."""
    import torch

    view = copy.copy(params)
    view._modules = dict(params._modules)
    view._modules["blocks"] = torch.nn.ModuleList(list(params.blocks)[:n])
    return dataclasses.replace(cfg, n_layers=n), view


def _serve(card: str, cfg, params, rng) -> dict:
    """`ServeEngine` answers DECODE's requests (seeded prompts from `rng`)
    on `params`: every completion checked, ms a step and tokens/s
    printed."""
    import torch

    from repro_torch.serve.engine import Request, ServeEngine

    lo, hi = DECODE["prompt"]
    reqs = [Request(uid, [int(x) for x in rng.integers(
                0, cfg.vocab, int(rng.integers(lo, hi + 1)))],
                    max_new=DECODE["max_new"],
                    temperature=(DECODE["temperature"]
                                 if uid >= DECODE["requests"] - DECODE["sampled"]
                                 else 0.0))
            for uid in range(DECODE["requests"])]
    eng = ServeEngine(cfg, params, slots=DECODE["slots"],
                      max_seq=DECODE["max_seq"], seed=0)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, launches = _counted(lambda: eng.run())
    dt = time.perf_counter() - t0
    steps = eng.state["pos"]
    check(sorted(c.uid for c in done) == list(range(len(reqs))),
          f"decode engine answered {[c.uid for c in done]}")
    for c in done:
        check(len(c.tokens) == DECODE["max_new"]
              and all(0 <= t < cfg.vocab for t in c.tokens),
              f"decode engine: completion {c.uid} is {c.tokens}")
    new = sum(len(c.tokens) for c in done)
    fed = sum(len(r.prompt) for r in reqs)
    print(f"decode engine ({card}): {cfg.name} full width, "
          f"{cfg.n_layers} layers, {len(reqs)} "
          f"requests through {DECODE['slots']} slots (prompts "
          f"{[len(r.prompt) for r in reqs]}, max_new {DECODE['max_new']}, "
          f"{DECODE['sampled']} at temperature {DECODE['temperature']}): "
          f"{steps} decode steps in {dt:.3f} s = {dt / steps * 1e3:.3f} ms a "
          f"step; {new} new tokens = {new / dt:.1f} new tokens/s "
          f"({(new + fed) / dt:.1f} tokens/s with the {fed} prompt tokens); "
          f"launches of the port's kernels {launches}", flush=True)
    return dict(steps=steps, seconds=dt, new_tokens=new)


def decode_phase(card: str, params) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import make_prefill_step

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cfg = registry.get(PREFILL_CONFIG)
    rng = np.random.default_rng(0)
    served = _serve(card, cfg, params, rng)

    # teacher forcing: decode_step's logits at each position against the
    # prefill's (flash_attention_wgmma) over the same sequence
    s = DECODE_CHECK_SEQ
    toks = torch.tensor(rng.integers(0, cfg.vocab, (1, s)), device=dev)
    step = make_prefill_step(cfg, ShapeSpec("decode_check", "prefill", s, 1))
    _teacher_forced(card, cfg, params, toks,
                    lambda: step.fn(params, {"inputs": toks}),
                    "flash_attention_wgmma")
    print(f"decode phase: {time.perf_counter() - t_phase:.2f} s", flush=True)
    return served


def _teacher_forced(card: str, cfg, params, toks, prefill, inst: str,
                    rtol: float = DECODE_RTOL,
                    top1: float = DECODE_TOP1) -> None:
    """`decode_step` under teacher forcing on the one sequence `toks` (1,
    S) against `prefill()`'s logits (1, S, V), which must launch `inst`
    once an attention call (`_attn_calls`): rel L2 <= `rtol` at every
    position, top-1 equal at >= `top1` of them."""
    import torch

    from repro_torch.models.lm import decode_step, init_decode_state

    s = toks.shape[1]
    want, launches = _counted(prefill)
    check(launches.get(inst, 0) == _attn_calls(cfg)
          and not (cfg.family == "ssm" and launches),
          f"decode check prefill launches {launches}")
    want = want[0].float()
    state = init_decode_state(cfg, 1, s)
    rels, agree = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(s):
        got, state = decode_step(params, state, toks[:, t], cfg)
        got = got[0]
        rels.append(float((got - want[t]).norm() / want[t].norm()))
        agree += int(got.argmax() == want[t].argmax())
    tf_s = time.perf_counter() - t0
    check(all(math.isfinite(r) and r <= rtol for r in rels),
          f"decode vs prefill: rel L2 by position {rels}")
    check(agree >= top1 * s,
          f"decode vs prefill: top-1 agrees at {agree} of {s} positions")
    print(f"decode check ({card}): {cfg.name}, decode_step under teacher "
          f"forcing vs the prefill ({inst}, {_attn_calls(cfg)} launches) on "
          f"{s} tokens, bf16 both: rel L2 max {max(rels):.3e}, median "
          f"{sorted(rels)[s // 2]:.3e} (tolerance {rtol}); top-1 "
          f"equal at {agree} of {s} positions (tolerance "
          f"{top1}); batch-1 decode {tf_s / s * 1e3:.3f} ms a step",
          flush=True)


# ----------------------------------------------------------------------
# Phase 10: the training stack
# ----------------------------------------------------------------------
def _sync_ms(fn) -> tuple[object, float]:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _update_gap(a, b, lr: float) -> tuple[float, float]:
    """Over every parameter of two `LM`s after one step: the largest
    |a - b| in units of lr, and the share of elements within
    TRAIN_CHECK_NEAR lr."""
    import torch

    worst, near, total = 0.0, 0, 0
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        d = (x.detach().float().cpu() - y.detach().float().cpu()).abs()
        worst = max(worst, float(d.max()) / lr)
        near += int((d <= TRAIN_CHECK_NEAR * lr).sum())
        total += d.numel()
    return worst, near / total


def _check_pair(what: str, ma: dict, a, mb: dict, b, loss_rtol: float,
                gnorm_rtol: float) -> str:
    """Hold two one-step results of the same state and batch to the
    phase's bounds; returns the measured line."""
    la, lb = float(ma["loss"]), float(mb["loss"])
    ga, gb = float(ma["grad_norm"]), float(mb["grad_norm"])
    lr = float(ma["lr"])
    worst, share = _update_gap(a, b, lr)
    check(abs(la - lb) <= loss_rtol * abs(lb),
          f"train check {what}: loss {la} vs {lb}")
    check(abs(ga - gb) <= gnorm_rtol * abs(gb),
          f"train check {what}: grad norm {ga} vs {gb}")
    check(worst <= TRAIN_CHECK_LR and share >= TRAIN_CHECK_SHARE,
          f"train check {what}: parameters {worst:.4f} lr apart at most, "
          f"{share:.5f} within {TRAIN_CHECK_NEAR} lr")
    return (f"{what}: loss {la:.6f} vs {lb:.6f} (rel {abs(la - lb) / lb:.3e}"
            f", tolerance {loss_rtol}), grad norm {ga:.5f} vs {gb:.5f} (rel "
            f"{abs(ga - gb) / gb:.3e}, tolerance {gnorm_rtol}), parameters at "
            f"most {worst:.4f} lr apart (tolerance {TRAIN_CHECK_LR}), "
            f"{share:.5f} of elements within {TRAIN_CHECK_NEAR} lr "
            f"(tolerance {TRAIN_CHECK_SHARE})")


def _try_step(fn) -> tuple[float | None, float | None]:
    """(ms, loss) of one train step, or (None, None) when the card runs
    out of memory (its grads are dropped; the state is not used after)."""
    import torch

    try:
        (_, met), dt = _sync_ms(fn)
        return dt, float(met["loss"])
    except torch.cuda.OutOfMemoryError:
        pass
    torch.cuda.empty_cache()
    return None, None


def _one_step(cfg, state, batch, **kw):
    from repro_torch.launch.steps import make_train_step

    step = make_train_step(cfg, device=state["step"].device, **kw)
    state, met = step.fn(state, batch)
    return state, {k: v.detach().cpu() for k, v in met.items()}


def _copy_state(state, device):
    """A train state's copy on `device` (fresh default AdamW moments: the
    copies are of step-0 states)."""
    from repro_torch.optim import adamw

    params = copy.deepcopy(state["params"]).to(device)
    return {"params": params,
            "opt": adamw.init(dict(params.named_parameters()),
                              adamw.AdamWConfig()),
            "step": state["step"].to(device)}


def _card_train_state(cfg) -> dict:
    """A train state on the card: float32 masters drawn from seed 0 by the
    card's generator (seconds; the CPU's takes ~10 s a G), zero AdamW
    moments (the config's policy), step 0."""
    import torch

    from repro_torch.launch.steps import default_opt_cfg
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw

    params = build_model(cfg).init(seed=0, draw_on="cuda")
    return {"params": params,
            "opt": adamw.init(dict(params.named_parameters()),
                              default_opt_cfg(cfg)),
            "step": torch.zeros((), dtype=torch.int32, device="cuda")}


def _train_run(step, state, batches) -> tuple[dict, dict]:
    """`step.fn` over `batches` with the launch counts zeroed just before
    and read just after: (state, {losses, gnorms, ms, launches, peak_gb}),
    the peak since the call."""
    import torch

    from repro_torch.kernels import LAUNCHES

    torch.cuda.reset_peak_memory_stats()
    out = dict(losses=[], gnorms=[], ms=[])
    LAUNCHES.clear()
    for batch in batches:
        (state, met), dt = _sync_ms(lambda: step.fn(state, batch))
        out["losses"].append(float(met["loss"]))
        out["gnorms"].append(float(met["grad_norm"]))
        out["ms"].append(dt)
    out["launches"] = {k: v for k, v in LAUNCHES.items() if v}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return state, out


def _prefill_ce(cfg, state, batch) -> tuple[float, dict]:
    """The loss (CE with the z-loss) of `batch` through the prefill path
    (blockwise attention, the config's flash attention instantiation) on
    the bf16 serving cast of `state`'s float32 masters, over the text
    positions (the VLM's logits cover its patches too): (loss, the
    prefill's launches)."""
    import torch

    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.common import softmax_cross_entropy
    from repro_torch.models.registry import meta_model

    serve = meta_model(cfg, torch.bfloat16).to_empty(device="cuda")
    serve.load_state_dict(state["params"].state_dict())
    b, s = batch["inputs"].shape
    prefill = make_prefill_step(cfg, ShapeSpec("train_ce", "prefill", s, b))
    logits, launches = _counted(lambda: prefill.fn(serve, batch))
    with torch.inference_mode():
        ce = float(softmax_cross_entropy(logits[:, -s:],
                                         batch["targets"])[0])
    del serve, logits
    torch.cuda.empty_cache()
    return ce, launches


def _step_variants(card: str, small) -> None:
    """One step each of `small` (a config cut to a few layers at full
    width) from the same step-0 state (float32 masters drawn on the card,
    copied to the CPU) and TRAIN_CHECK_SHAPE batch: the card against the CPU, two
    microbatches against one, remat against none, held to the
    TRAIN_CHECK_* bounds (remat against none bit-equal expected; else
    measured and bounded)."""
    import torch

    from repro_torch.data.synthetic import batch_for

    dev = torch.device("cuda")
    base = _card_train_state(small)
    host = _copy_state(base, "cpu")
    b, s = TRAIN_CHECK_SHAPE
    batch = batch_for(small, s, b, 0, seed=0)
    on_card, m_card = _one_step(small, _copy_state(base, dev), batch,
                                remat=True)
    t0 = time.perf_counter()
    on_cpu, m_cpu = _one_step(small, host, batch, remat=True)
    cpu_s = time.perf_counter() - t0
    lines = [_check_pair("card vs CPU", m_card, on_card["params"], m_cpu,
                         on_cpu["params"], TRAIN_CHECK_LOSS_RTOL,
                         TRAIN_CHECK_GNORM_RTOL)]
    del host, on_cpu
    two, m_two = _one_step(small, _copy_state(base, dev), batch, remat=True,
                           microbatches=2)
    lines.append(_check_pair("2 microbatches vs 1", m_two, two["params"],
                             m_card, on_card["params"], TRAIN_CHECK_LOSS_RTOL,
                             TRAIN_CHECK_GNORM_RTOL))
    del two
    plain, m_plain = _one_step(small, _copy_state(base, dev), batch,
                               remat=False)
    same = all(torch.equal(m_plain[k], m_card[k]) for k in m_card) and all(
        torch.equal(x, y) for x, y in zip(plain["params"].parameters(),
                                          on_card["params"].parameters()))
    if same:
        lines.append("remat vs none: bit-equal (loss, metrics, every "
                     "parameter)")
    else:
        lines.append("remat vs none NOT bit-equal: " + _check_pair(
            "remat vs none", m_card, on_card["params"], m_plain,
            plain["params"], TRAIN_CHECK_LOSS_RTOL, TRAIN_CHECK_GNORM_RTOL))
    del plain, on_card, base
    torch.cuda.empty_cache()
    print(f"train check ({card}): {small.name} cut to {small.n_layers} "
          f"layers at full width, {b} x {s} tokens, one step each (the "
          f"CPU's {cpu_s:.1f} s):\n  " + "\n  ".join(lines), flush=True)


def lm_train_phase(card: str) -> dict:
    """(a) full-width steps, (b) card-vs-CPU and the step's variants at 2
    layers, (c) restart exactness on the reduced config."""
    import shutil

    import torch

    from repro_torch import convert
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import SHAPES, microbatches_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.runtime.fault_tolerance import (RESTART_EXIT_CODE,
                                                     PreemptionGuard)
    from repro_torch.train.trainer import TrainerConfig, init_state, train

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cfg = registry.get(PREFILL_CONFIG)
    torch.cuda.empty_cache()
    # -- (a) full width: 3.397 G float32 masters, AdamW moments
    (state, draw_ms) = _sync_ms(lambda: _card_train_state(cfg))
    n_params = sum(p.numel() for p in state["params"].parameters())
    check(n_params == cfg.n_params(), f"train: {n_params} parameters")
    b, s = TRAIN_LM_SHAPE
    batches = [batch_for(cfg, s, b, i, seed=0, device=dev)
               for i in range(TRAIN_LM_STEPS)]
    # step 0's loss against the CE of its batch through the prefill path
    # (blockwise attention, flash_attention_wgmma) on the bf16 serving cast
    # of the same weights
    ce, ce_launches = _prefill_ce(cfg, state, batches[0])
    check(ce_launches.get("flash_attention_wgmma", 0) == cfg.n_layers,
          f"train CE check: prefill launches {ce_launches}")
    state, run = _train_run(make_train_step(cfg, remat=True), state,
                            batches)
    losses, gnorms, ms = run["losses"], run["gnorms"], run["ms"]
    step_launches, peak = run["launches"], run["peak_gb"]
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"train: losses {losses}, grad norms {gnorms}")
    check(abs(losses[0] - ce) <= TRAIN_CE_RTOL * abs(ce),
          f"train: step-0 loss {losses[0]} vs the prefill path's CE {ce}")
    check(not step_launches,
          f"train: the train step launched kernels of ours {step_launches}")
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    print(f"train ({card}): {cfg.name} full width, {n_params} float32 "
          f"master parameters drawn on the card in {draw_ms / 1e3:.2f} s; "
          f"make_train_step(remat=True), default AdamW, {b} x {s}: "
          f"{TRAIN_LM_STEPS} steps {[round(x, 2) for x in ms]} ms (median "
          f"after the first {steady:.2f} ms a step = {b * s / steady * 1e3:.0f}"
          f" tokens/s); losses {[round(x, 5) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in gnorms]}; peak memory {peak:.2f} GB; "
          f"step-0 loss {losses[0]:.6f} vs the prefill path's CE {ce:.6f} "
          f"(rel {abs(losses[0] - ce) / ce:.3e}, tolerance {TRAIN_CE_RTOL}; "
          f"{ce_launches.get('flash_attention_wgmma', 0)} "
          f"flash_attention_wgmma launches); launches of the port's kernels "
          f"in the steps: {step_launches}", flush=True)
    shape4k = SHAPES["train_4k"]
    mb = microbatches_for(cfg, shape4k)
    check(mb == 4, f"train_4k microbatches {mb}")
    state, run4k = _train_run(
        make_train_step(cfg, remat=True, microbatches=mb), state,
        [batch_for(cfg, shape4k.seq, TRAIN_4K_BATCH, TRAIN_LM_STEPS + i,
                   seed=0, device=dev) for i in range(TRAIN_4K_STEPS)])
    l4k, g4k, ms4k = run4k["losses"], run4k["gnorms"], run4k["ms"]
    peak4k = run4k["peak_gb"]
    check(all(math.isfinite(x) for x in l4k + g4k),
          f"train_4k: losses {l4k}, grad norms {g4k}")
    tok4k = TRAIN_4K_BATCH * shape4k.seq
    print(f"train_4k ({card}): cut to {TRAIN_4K_BATCH} x {shape4k.seq}, "
          f"{mb} microbatches, remat: {[round(x, 2) for x in ms4k]} ms a "
          f"step (last {tok4k / ms4k[-1] * 1e3:.0f} tokens/s); losses "
          f"{[round(x, 5) for x in l4k]}, grad norms "
          f"{[round(x, 4) for x in g4k]}; peak memory {peak4k:.2f} GB",
          flush=True)
    # the launcher's TrainerConfig keeps remat off: does the full width
    # fit without it?  One step at the launcher's shape, measured either
    # way (the state is not used after it)
    no_remat = make_train_step(cfg, remat=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fits, loss_nr = _try_step(lambda: no_remat.fn(state, batches[0]))
    peak_nr = torch.cuda.max_memory_allocated() / 1e9
    print(f"train without remat ({card}): {b} x {s}: "
          + (f"fits, {fits:.2f} ms, loss {loss_nr:.5f}" if fits else
             "does not fit (CUDA out of memory)")
          + f"; peak memory {peak_nr:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}",
          flush=True)
    del state, no_remat, batches
    torch.cuda.empty_cache()

    # -- (b) 2 layers at full width: the card against the CPU, two
    # microbatches against one, remat against none
    _step_variants(card, dataclasses.replace(cfg,
                                             n_layers=TRAIN_CHECK_LAYERS))

    # -- (c) restart exactness on the card: preempted and resumed against
    # uninterrupted, and a checkpoint written and read back by the port
    red = registry.reduced(PREFILL_CONFIG)
    r = TRAIN_RESTART
    ckpts = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpts, ignore_errors=True)

    def tcfg(d):
        return TrainerConfig(seq=r["seq"], global_batch=r["batch"],
                             total_steps=r["steps"],
                             ckpt_every=r["ckpt_every"], ckpt_dir=str(d),
                             log_every=0)

    ref = train(red, tcfg(ckpts / "ref"), device=dev)
    guard = PreemptionGuard()

    def on_step(i, metrics):
        if i == r["preempt_after"] - 1:
            guard.request()

    r1 = train(red, tcfg(ckpts / "int"), guard=guard, on_step=on_step,
               device=dev)
    r2 = train(red, tcfg(ckpts / "int"), device=dev)
    check(ref.exit_code == 0 and r1.exit_code == RESTART_EXIT_CODE
          and r2.exit_code == 0 and r1.steps_run == r["preempt_after"],
          f"train restart: exit codes {ref.exit_code}, {r1.exit_code}, "
          f"{r2.exit_code}; {r1.steps_run} steps before the preemption")
    check(r1.losses + r2.losses == ref.losses,
          f"train restart: resumed {r1.losses + r2.losses} vs uninterrupted "
          f"{ref.losses}")
    st = init_state(red, TrainerConfig(seed=1), device=dev)
    st, _ = make_train_step(red, device=dev).fn(
        st, batch_for(red, r["seq"], r["batch"], 0, seed=1, device=dev))
    ckpt.save(ckpts / "rt", 1, convert.train_state_tree(st, lazy=True))
    back = init_state(red, TrainerConfig(seed=2), device=dev)
    convert.load_train_state(ckpt.restore(
        ckpts / "rt", 1, convert.train_state_tree(back, spec=True)), back)
    a, b_ = convert.train_state_tree(st), convert.train_state_tree(back)

    def leaves(t, pre=""):
        for k, v in t.items():
            yield from (leaves(v, pre + k + ".") if isinstance(v, dict)
                        else [(pre + k, v)])

    bad = [k for (k, x), (_, y) in zip(leaves(a), leaves(b_))
           if not torch.equal(x, y)]
    check(not bad, f"train checkpoint round trip: {bad} differ")
    shutil.rmtree(ckpts, ignore_errors=True)
    print(f"train restart ({card}): {red.name}, {r['batch']} x {r['seq']}, "
          f"{r['steps']} steps: preempted after {r1.steps_run} and resumed "
          f"from its checkpoint, losses bitwise equal to the uninterrupted "
          f"run {ref.losses}; a checkpoint written and read back by the "
          f"port: {sum(1 for _ in leaves(a))} leaves equal", flush=True)
    print(f"train phase: {time.perf_counter() - t_phase:.2f} s", flush=True)
    return dict(step_ms=steady, losses=losses, peak_gb=peak,
                train_4k_ms=ms4k, train_4k_peak_gb=peak4k,
                no_remat_ms=fits, no_remat_peak_gb=peak_nr)


# ----------------------------------------------------------------------
# Phase 11: the MoE family (deepseek-v2-lite-16b, arctic-480b)
# ----------------------------------------------------------------------
@contextlib.contextmanager
def _routes(forced=None):
    """Record each MoE layer's routing while a forward runs: a dict of
    lists, one entry a layer call, on the host: `top_i`, `slot` and
    `keep` (tokens, k) and the router `gap` (tokens,), the k-th minus the
    (k+1)-th probability.  With `forced`, a function of the call's index
    and its (G, gs, k) shape giving (top_i, slot, keep), the layer takes
    those claims in place of its own, its gates the renormalized
    probabilities of the forced experts: a forward teacher-forced to
    another forward's routes (the router's float32 arithmetic still
    runs)."""
    import torch

    from repro_torch.models import mlp

    rec = {"top_i": [], "slot": [], "keep": [], "gap": []}
    route = mlp.moe_route

    def recorded(p, xg, m):
        logits, probs, top_p, top_i, slot, keep = route(p, xg, m)
        top = torch.topk(probs, m.top_k + 1, dim=-1).values
        rec["gap"].append((top[..., -2] - top[..., -1]).reshape(-1).cpu())
        if forced is not None:
            top_i, slot, keep = (t.to(xg.device).reshape(top_i.shape)
                                 for t in forced(len(rec["top_i"]),
                                                 top_i.shape))
            top_p = torch.gather(probs, -1, top_i)
            top_p = top_p / top_p.sum(-1, keepdim=True)
        for k, t in (("top_i", top_i), ("slot", slot), ("keep", keep)):
            rec[k].append(t.reshape(-1, m.top_k).cpu())
        return logits, probs, top_p, top_i, slot, keep

    mlp.moe_route = recorded
    try:
        yield rec
    finally:
        mlp.moe_route = route


def _same_routes(a, b):
    """(tokens,) bool: each token chose the same experts at every layer
    (as sets) in the recorded forwards `a` and `b` (lists of (tokens, k)
    per layer)."""
    import torch

    sa = torch.stack(a).sort(-1).values
    sb = torch.stack(b).sort(-1).values
    return (sa == sb).all(-1).all(0)


def _held_tc(inst: str, what: str, q, k, v, causal: bool,
             prefix_len: int) -> float:
    """A tensor-core instantiation through `ops.flash_attention` held to
    its plain version by `_tc_check` with its dumped P, and within
    TC_F32P_REL_L2 of the float32-P blockwise version; returns the max
    error."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    got = fa.flash_attention(q, k, v, causal=causal, prefix_len=prefix_len)
    check(tuple(got.shape) == q.shape[:3] + v.shape[3:],
          f"{what}: shape {tuple(got.shape)}")
    r = _tc_check(got, q, k, v, causal, prefix_len, dump=True)
    rel = _rel_l2(got, fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                                  prefix_len=prefix_len))
    pairs = q.shape[0] * q.shape[2] * _visible_pairs(
        q.shape[1], k.shape[1], causal, prefix_len)
    text = (f"{inst} {what}: {_tc_text(r, pairs)}; rel L2 {rel:.3e} vs "
            f"float32-P blockwise")
    check(r["ok"] and rel <= TC_F32P_REL_L2, text)
    print(f"kernel {text} (within tolerance)", flush=True)
    return r["err"]


def mla_flash_check(dev, mla, cfg) -> dict:
    """(a) The (192, 128) instantiation against its plain version:
    `_tc_check` with the kernel's dumped P on MLA_CASES, q/k/v as
    `mla_fwd_blockwise` builds them from layer 0 of the deepseek weights
    `mla`, and a q read through strides; then at the prefill's shape,
    timed in turns with SDPA."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import attention as attn
    from repro_torch.models.common import apply_norm

    dh, dv = MLA_DIMS
    g = torch.Generator(device=dev).manual_seed(11)

    def qkv(b, s, h):
        return [torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
                for d in (dh, dh, dv)]

    def held(what, q, k, v, causal):
        return _held_tc(MLA_INST, what, q, k, v, causal, 0)

    err = 0.0
    for b, s, h, causal in MLA_CASES:
        err = max(err, held(f"({b}, {s}, {h}, {h}, {dh}/{dv}) "
                            f"{'causal' if causal else 'full'}",
                            *qkv(b, s, h), causal))
    with torch.inference_mode():       # as mla_fwd_blockwise builds them
        blk = mla.blocks[0]
        x = torch.randn((1, 2048, cfg.d_model), generator=g,
                        device=dev).bfloat16()
        pos = torch.arange(2048, device=dev)
        h_ = apply_norm(blk.ln1, x, cfg.norm)
        q_nope, q_rope = attn._mla_q(blk.attn, h_, cfg, pos)
        k_nope, v, k_rope = attn._mla_kv(blk.attn, h_, cfg, pos)
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(
            -1, -1, cfg.n_heads, -1)], -1)
    err = max(err, held(f"(1, 2048, {cfg.n_heads}, {cfg.n_heads}) from "
                        f"layer 0's MLA", q, k, v, True))
    wide = torch.randn((1, 1000, 16, 256), generator=g, device=dev).bfloat16()
    q, k, v = wide[..., :dh], *qkv(1, 1000, 16)[1:]
    check(fk.kernel_layout_ok(q) and not q.is_contiguous(), "strided q")
    err = max(err, held("(1, 1000, 16, 16) q read through strides", q, k, v,
                        True))
    del q, k, v, wide

    # the prefill's shape: 1 x 32768, 16 heads, causal; SDPA in turns
    b, s, h = PREFILL_BATCH, 32768, cfg.n_heads
    q, k, v = qkv(b, s, h)
    got = fk.flash_attention_wgmma(q, k, v)
    tc = _tc_check(got, q, k, v, True, 0, dump=False)
    rel_f32p = _rel_l2(got, fa_ref.flash_attention_ref(q, k, v))
    check(tc["ok"] and rel_f32p <= TC_F32P_REL_L2,
          f"{MLA_INST} ({b}, {s}, {h}, {h}, {dh}/{dv}): {_tc_text(tc, 0)}; "
          f"rel L2 {rel_f32p:.3e} vs the float32-P plain version")
    qh, kh, vh = (x_.transpose(1, 2).contiguous() for x_ in (q, k, v))
    # the fused backends only: the math one would hold 34 GB of scores
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def sdpa_v(vv):
        with sdpa_kernel(fused):
            return F.scaled_dot_product_attention(qh, kh, vv, is_causal=True)

    sdpa_form = "v at 128"
    try:
        sdpa_out = sdpa_v(vh)
        sdpa = lambda: sdpa_v(vh)  # noqa: E731
    except RuntimeError as e:           # no fused backend takes Dv != Dh
        sdpa_form = f"v padded to {dh}: {str(e).splitlines()[0][:100]}"
        vp = F.pad(vh, (0, dh - dv))
        sdpa = lambda: sdpa_v(vp)[..., :dv]  # noqa: E731
        sdpa_out = sdpa()
    sdpa_err = float((sdpa_out.transpose(1, 2).float() - got.float()).abs()
                     .max())
    del sdpa_out
    fns = {"wgmma": lambda: fk.flash_attention_wgmma(q, k, v), "sdpa": sdpa}
    times = {n: [] for n in fns}
    for order in (("wgmma", "sdpa"), ("sdpa", "wgmma"), ("wgmma", "sdpa")):
        for n in order:
            times[n].append(cuda_ms(fns[n], 10))
    ms = {n: sum(t) / len(t) for n, t in times.items()}
    plain_ms = cuda_ms(lambda: fa_ref.flash_attention_tc_ref(q, k, v), 1)
    pairs = _visible_pairs(s, s, True, 0)
    flops = 2 * (dh + dv) * h * b * pairs
    nbytes = (q.numel() + k.numel() + v.numel() + b * s * h * dv) * 2
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_TC_FLOPS)
    print(f"kernel {MLA_INST} ({b}, {s}, {h}, {h}, {dh}/{dv}) bf16 causal, "
          f"one call in turns (ms each: {times}): {ms['wgmma']:.3f} ms, "
          f"{flops / ms['wgmma'] / 1e9:.1f} TFLOP/s, {b_ms / ms['wgmma']:.3f} "
          f"of the {b_ms:.4f} ms bound ({b_by}: {flops:.4e} flops over "
          f"{pairs:,} visible pairs, {nbytes / 1e6:.1f} MB); SDPA ({sdpa_form})"
          f" {ms['sdpa']:.3f} ms, ratio {ms['wgmma'] / ms['sdpa']:.3f}; plain "
          f"flash_attention_tc_ref {plain_ms:.3f} ms; {_tc_text(tc, 0)}; rel "
          f"L2 {rel_f32p:.3e} vs float32-P; max |SDPA - kernel| "
          f"{sdpa_err:.3e}", flush=True)
    return dict(name=MLA_INST, route="cuda",
                source="src/repro_torch/csrc/flash_attention_wgmma.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:59",
                max_abs_err=max(err, tc["err"]), ms=ms["wgmma"],
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=ms["sdpa"])


def _decode_against_prefill(card, cfg, params, toks) -> None:
    """(d) Teacher-forced `decode_step` against the prefill on one
    sequence.  Free, the two part on the routes: with 64 experts a
    token's k-th and (k+1)-th probabilities lie ~1e-3 apart, the
    absorbed MLA decode rounds apart from the expanded prefill, and over
    27 layers a rounding flips some claim of nearly every token; and the
    prefill's group can drop claims at capacity, the decode's one-token
    groups never.  So the decode is run twice: free (its routes, drops
    and divergence printed), then teacher-forced to the prefill's routes
    and drops as well as its tokens, and held to phase 9's bounds at
    every position."""
    import torch

    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.lm import decode_step, init_decode_state

    s = toks.shape[1]
    step = make_prefill_step(cfg, ShapeSpec("decode_check", "prefill", s, 1))
    with _routes() as pre:
        want, launches = _counted(lambda: step.fn(params, {"inputs": toks}))
    check(launches.get(MLA_INST, 0) == cfg.n_layers,
          f"decode check prefill launches {launches}")
    want = want[0].float()
    dropped = (torch.stack(pre["keep"]) < 1).any(-1).any(0)
    near = (torch.stack(pre["gap"]) < MOE_NEAR_TIE).any(0)
    runs = {}
    for mode in ("free", "forced"):
        state = init_decode_state(cfg, 1, s)
        rels, agree, same = [], 0, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(s):
            forced = None if mode == "free" else (
                lambda i, shape, t=t: (pre["top_i"][i][t], torch.zeros(
                    pre["slot"][i][t].shape), pre["keep"][i][t]))
            with _routes(forced) as dec:
                got, state = decode_step(params, state, toks[:, t], cfg)
            got = got[0]
            rels.append(float((got - want[t]).norm() / want[t].norm()))
            agree += int(got.argmax() == want[t].argmax())
            same.append(bool(_same_routes([x[t:t + 1] for x in pre["top_i"]],
                                          dec["top_i"])))
        runs[mode] = dict(rels=rels, agree=agree, same=sum(same),
                          ms=(time.perf_counter() - t0) / s * 1e3)
    free, forced = runs["free"], runs["forced"]
    text = (f"decode check ({card}): {cfg.name}, decode_step under teacher "
            f"forcing vs the prefill ({MLA_INST}, {cfg.n_layers} launches) "
            f"on {s} tokens.  The prefill dropped claims at "
            f"{int(dropped.sum())} positions; router gaps under "
            f"{MOE_NEAR_TIE} at {int(near.sum())}.  Free decode: routes "
            f"equal at {free['same']} of {s} positions, rel L2 max "
            f"{max(free['rels']):.3e}, median "
            f"{sorted(free['rels'])[s // 2]:.3e}, top-1 equal at "
            f"{free['agree']} of {s}; {free['ms']:.3f} ms a step.  Routes "
            f"and drops forced to the prefill's: rel L2 max "
            f"{max(forced['rels']):.3e}, median "
            f"{sorted(forced['rels'])[s // 2]:.3e} (tolerance {DECODE_RTOL}),"
            f" top-1 equal at {forced['agree']} of {s} (tolerance "
            f"{DECODE_TOP1})")
    check(forced["same"] == s and max(forced["rels"]) <= DECODE_RTOL
          and forced["agree"] >= DECODE_TOP1 * s, text)
    print(text, flush=True)


def _a2a_check(card, cfg, params) -> dict:
    """(g) `moe_fwd_a2a` on 1, 2 and 4 positions of the card at one
    full-width MoE layer (layer 0's), capacity A2A_TOKENS (nothing can
    drop), against `moe_fwd_dense_eval`; the same bits on every position
    count."""
    import torch

    from repro_torch.models import mlp
    from repro_torch.parallel.moe_a2a import moe_fwd_a2a

    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((1, A2A_TOKENS, cfg.d_model), generator=g,
                    device="cuda").bfloat16()
    ffn = params.blocks[0].ffn
    with torch.inference_mode():
        want = mlp.moe_fwd_dense_eval(ffn, x, cfg)
        outs, ms = {}, {}
        for n in A2A_POSITIONS:
            mesh = ("cuda:0",) * n
            outs[n] = moe_fwd_a2a(ffn, x, cfg, mesh, capacity=A2A_TOKENS)
            ms[n] = cuda_ms(lambda: moe_fwd_a2a(ffn, x, cfg, mesh,
                                                capacity=A2A_TOKENS), 3)
        dense_ms = cuda_ms(lambda: mlp.moe_fwd_dense_eval(ffn, x, cfg), 3)
    rels = {n: _rel_l2(y, want) for n, y in outs.items()}
    same = all(torch.equal(outs[n], outs[A2A_POSITIONS[0]]) for n in outs)
    text = (f"moe a2a ({card}): {cfg.name} layer 0's MoE, 1 x {A2A_TOKENS} "
            f"tokens, capacity {A2A_TOKENS}, on {A2A_POSITIONS} positions of "
            f"cuda:0: rel L2 vs moe_fwd_dense_eval "
            f"{ {n: f'{r:.3e}' for n, r in rels.items()} } (tolerance "
            f"{A2A_REL_L2}); the same bits on every position count: {same}; "
            f"ms {ms} (dense eval {dense_ms:.3f})")
    check(same and all(r <= A2A_REL_L2 for r in rels.values()), text)
    print(text, flush=True)
    return dict(rel_l2=rels, ms=ms)


def _cpu_check(card, cfg) -> None:
    """(e) 2 layers at full width, seq MOE_CPU_SEQ, weights drawn on the
    CPU, card against CPU: the share of (token, k) claims routed alike,
    then the CPU run teacher-forced to the card's routes and drops (a
    flipped near-tie claim moves its token far): the last position's
    logits and its argmax."""
    import torch

    from repro_torch.data.synthetic import batch_for
    from repro_torch.models.lm import init_lm, lm_hidden, lm_logits

    cut = dataclasses.replace(cfg, n_layers=MOE_CPU_LAYERS)
    t0 = time.perf_counter()
    host = init_lm(cut, seed=0, device="cpu", dtype=torch.bfloat16)
    draw_s = time.perf_counter() - t0
    card_model = copy.deepcopy(host).to("cuda")
    toks = batch_for(cut, MOE_CPU_SEQ, 1, 2)["inputs"]
    runs = {}
    for what, model, d in (("card", card_model, torch.device("cuda")),
                           ("cpu", host, torch.device("cpu")),
                           ("cpu forced", host, torch.device("cpu"))):
        forced = None if what != "cpu forced" else (
            lambda i, shape: (runs["card"][1]["top_i"][i],
                              runs["card"][1]["slot"][i],
                              runs["card"][1]["keep"][i]))
        t0 = time.perf_counter()
        with torch.inference_mode(), _routes(forced) as rec:
            hid, aux = lm_hidden(model, toks.to(d), cut, attn_impl="blockwise")
            last = lm_logits(model, hid[:, -1:], cut).float().cpu()
        runs[what] = (last, rec)
        print(f"  {MOE_CPU_LAYERS}-layer prefill at seq {MOE_CPU_SEQ}, {what}: "
              f"{time.perf_counter() - t0:.2f} s, aux {float(aux):.6f}",
              flush=True)
    on_card, on_cpu = runs["card"][0], runs["cpu forced"][0]
    ta, tb = (torch.stack(runs[w][1]["top_i"]) for w in ("card", "cpu"))
    claims_same = float((ta[..., :, None] == tb[..., None, :]).any(-1)
                        .float().mean())          # experts chosen on both
    tokens_same = float(_same_routes(runs["card"][1]["top_i"],
                                     runs["cpu"][1]["top_i"]).float().mean())
    free = float((runs["cpu"][0] - on_card).norm() / runs["cpu"][0].norm())
    rel = float((on_card - on_cpu).norm() / on_cpu.norm())
    text = (f"moe check: {cut.name} {MOE_CPU_LAYERS} layers at full width, "
            f"seq {MOE_CPU_SEQ} (weights drawn on the CPU in {draw_s:.1f} s): "
            f"(token, k) claims routed alike on card and CPU {claims_same:.5f}"
            f" (tolerance {MOE_ROUTE_SAME}), tokens routed alike at every "
            f"layer {tokens_same:.5f}; last-position logits card vs CPU rel "
            f"L2 {free:.3e} free, {rel:.3e} with the CPU forced to the card's "
            f"routes (tolerance {MOE_CPU_RTOL}), argmax "
            f"{'agrees' if int(on_card.argmax()) == int(on_cpu.argmax()) else 'differs'}"
            f" ({int(on_card.argmax())} vs {int(on_cpu.argmax())})")
    check(claims_same >= MOE_ROUTE_SAME and math.isfinite(rel)
          and rel <= MOE_CPU_RTOL, text)
    print(text, flush=True)


def _arctic_check(card) -> None:
    """(f) arctic-480b at full width cut to one layer (13.6 G parameters,
    drawn on the card): a 1 x ARCTIC_SEQ prefill (one Dh-128
    `flash_attention_wgmma` launch), then ARCTIC_DECODE decode steps."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.lm import decode_step, init_decode_state, init_lm

    cfg = dataclasses.replace(registry.get(ARCTIC_CONFIG), n_layers=1)
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16, draw_on="cuda")
    torch.cuda.synchronize()
    n = sum(p_.numel() for p_ in params.parameters())
    print(f"arctic init: {cfg.name} cut to 1 layer, {n:,} parameters, "
          f"{n * 2 / 1e9:.2f} GB bf16, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    step = make_prefill_step(cfg, ShapeSpec("arctic", "prefill",
                                            ARCTIC_SEQ, 1))
    batch = batch_for(cfg, ARCTIC_SEQ, 1, 0)
    _prefill(step, params, batch, cfg, "arctic warm-up",
             inst="flash_attention_wgmma_128_128")
    dt, n_fa, _ = _prefill(step, params, batch, cfg, "arctic",
                           inst="flash_attention_wgmma_128_128")
    state = init_decode_state(cfg, 1, 64)
    toks = batch["inputs"][:, :ARCTIC_DECODE].cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(ARCTIC_DECODE):
        logits, state = decode_step(params, state, toks[:, t], cfg)
        check(bool(torch.isfinite(logits).all()),
              f"arctic decode step {t}: non-finite logits")
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) / ARCTIC_DECODE * 1e3
    print(f"arctic ({card}): prefill 1 x {ARCTIC_SEQ} in {dt:.3f} s "
          f"({ARCTIC_SEQ / dt:,.0f} tokens/s), flash_attention_wgmma "
          f"{n_fa} launch (Dh 128); {ARCTIC_DECODE} decode steps "
          f"{dec_ms:.3f} ms a step, logits finite", flush=True)


def moe_phase(card: str) -> tuple[dict, dict]:
    """Phase 11; returns the (192, 128) kernel's report row and the
    launches of its main path."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.lm import init_lm

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = registry.get(MOE_CONFIG)
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16, draw_on="cuda")
    torch.cuda.synchronize()
    n_params = sum(p_.numel() for p_ in params.parameters())
    print(f"moe init: {cfg.name}, {n_params:,} parameters "
          f"({cfg.n_layers} layers), {n_params * 2 / 1e9:.2f} GB bf16, drawn "
          f"from seed 0 on the card in {time.perf_counter() - t0:.2f} s",
          flush=True)
    check(n_params == cfg.n_params(), f"{n_params} != {cfg.n_params()}")

    row = mla_flash_check(torch.device("cuda"), params, cfg)     # (a)

    # (b) the full-depth prefill at 1 x 32768, then 4 x 4096
    shape = dataclasses.replace(SHAPES["prefill_32k"], batch=PREFILL_BATCH)
    step = make_prefill_step(cfg, shape)
    batch = batch_for(cfg, shape.seq, shape.batch, 0)
    torch.cuda.reset_peak_memory_stats()
    warm_s, _, _ = _prefill(step, params, batch, cfg, "moe warm-up",
                            inst=MLA_INST)
    dt, launches, _ = _prefill(step, params, batch, cfg, "moe timed",
                               inst=MLA_INST)
    tokens = shape.batch * shape.seq
    print(f"moe prefill ({card}): {cfg.name} {shape.batch} x {shape.seq} "
          f"tokens, {cfg.n_layers} layers: {dt:.3f} s ({warm_s:.3f} s "
          f"warm-up), {tokens / dt:,.0f} tokens/s; {MLA_INST} {launches} "
          f"launches, no 3xTF32 launch; attention share "
          f"~{cfg.n_layers * row['ms'] / 1e3 / dt:.3f} of the wall time; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB", flush=True)
    b4, s4 = MOE_SMALL_PREFILL
    step4 = make_prefill_step(cfg, dataclasses.replace(shape, batch=b4,
                                                       seq=s4))
    dt4, n4, _ = _prefill(step4, params, batch_for(cfg, s4, b4, 1), cfg,
                          f"moe {b4} x {s4}", inst=MLA_INST)
    print(f"moe prefill: {b4} x {s4} tokens: {dt4:.3f} s, "
          f"{b4 * s4 / dt4:,.0f} tokens/s; {MLA_INST} {n4} launches",
          flush=True)

    rng = np.random.default_rng(0)
    _serve(card, cfg, params, rng)                               # (c)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (1, DECODE_CHECK_SEQ)),
                        device="cuda")
    _decode_against_prefill(card, cfg, params, toks)              # (d)
    a2a = _a2a_check(card, cfg, params)                           # (g)
    del params, step, step4
    gc.collect()
    torch.cuda.empty_cache()
    _cpu_check(card, cfg)                                         # (e)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _arctic_check(card)                                           # (f)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"moe phase: {time.perf_counter() - t_phase:.2f} s", flush=True)
    row.update(a2a_rel_l2=a2a["rel_l2"], a2a_ms=a2a["ms"])
    return row, {MLA_INST: launches}


# ----------------------------------------------------------------------
# Phase 12: the VLM prefix family (paligemma-3b)
# ----------------------------------------------------------------------
def vlm_flash_check(dev, params, cfg) -> dict:
    """(a) The (256, 256) instantiation against its plain version:
    `_tc_check` with the kernel's dumped P on VLM_CASES (8 heads over one
    KV head, as paligemma's MQA), on q / k / v as layer 0 of `params`
    builds them (q and k read through RoPE's strides) with the patches'
    prefix, and on a q read through the strides of wider rows; then at the
    prefill's shape (1, 33024, 8, 1) with the 256-patch prefix against the
    plain version's own P, and timed in turns with itself at prefix 0 and
    SDPA (causal, no prefix: a prefix mask would push SDPA off its fused
    backends; KV repeated to the 8 heads)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import attention as attn
    from repro_torch.models.common import apply_norm

    dh, dv = VLM_DIMS
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    prefix = cfg.vlm.n_patches
    g = torch.Generator(device=dev).manual_seed(13)

    def qkv(b, s):
        return [torch.randn((b, s, n, d), generator=g, device=dev).bfloat16()
                for n, d in ((h, dh), (kvh, dh), (kvh, dv))]

    def held(what, q, k, v, causal, prefix_len):
        return _held_tc(VLM_INST, what, q, k, v, causal, prefix_len)

    err = 0.0
    for b, s, prefix_len, causal in VLM_CASES:
        err = max(err, held(
            f"({b}, {s}, {h}, {kvh}, {dh}) "
            f"{'causal' if causal else 'full'}, prefix {prefix_len}",
            *qkv(b, s), causal, prefix_len))
    with torch.inference_mode():       # as layer 0 builds them
        blk = params.blocks[0]
        x = torch.randn((1, 2048, cfg.d_model), generator=g,
                        device=dev).bfloat16()
        pos = torch.arange(2048, device=dev)
        q, k, v = attn._project_qkv(blk.attn, apply_norm(blk.ln1, x, cfg.norm),
                                    cfg, pos)
    check(fk.kernel_layout_ok(q) and not q.is_contiguous(),
          "layer 0's q: RoPE's strides")
    err = max(err, held(f"(1, 2048, {h}, {kvh}) from layer 0, prefix "
                        f"{prefix}", q, k, v, True, prefix))
    wide = torch.randn((1, 1000, h, 320), generator=g, device=dev).bfloat16()
    q, k, v = wide[..., :dh], *qkv(1, 1000)[1:]
    check(fk.kernel_layout_ok(q) and not q.is_contiguous(), "strided q")
    err = max(err, held(f"(1, 1000, {h}, {kvh}) q read through strides, "
                        f"prefix {prefix}", q, k, v, True, prefix))
    del q, k, v, wide, x

    # the prefill's shape: 32768 text tokens after the 256 patches
    b, s = PREFILL_BATCH, 32768 + prefix
    q, k, v = qkv(b, s)
    got = fk.flash_attention_wgmma(q, k, v, prefix_len=prefix)
    tc = _tc_check(got, q, k, v, True, prefix, dump=False)
    rel_f32p = _rel_l2(got, fa_ref.flash_attention_ref(q, k, v,
                                                       prefix_len=prefix))
    check(tc["ok"] and rel_f32p <= TC_F32P_REL_L2,
          f"{VLM_INST} ({b}, {s}, {h}, {kvh}, {dh}) prefix {prefix}: "
          f"{_tc_text(tc, 0)}; rel L2 {rel_f32p:.3e} vs the float32-P plain "
          f"version")
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (x_.transpose(1, 2).repeat_interleave(h // kvh, 1).contiguous()
              for x_ in (k, v))
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def sdpa():
        with sdpa_kernel(fused):
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    no_prefix = fk.flash_attention_wgmma(q, k, v)
    sdpa_err = float((sdpa().transpose(1, 2).float() - no_prefix.float())
                     .abs().max())
    del no_prefix
    fns = {"wgmma": lambda: fk.flash_attention_wgmma(q, k, v,
                                                     prefix_len=prefix),
           "wgmma_p0": lambda: fk.flash_attention_wgmma(q, k, v),
           "sdpa": sdpa}
    times = {n: [] for n in fns}
    for order in (("wgmma", "wgmma_p0", "sdpa"),
                  ("sdpa", "wgmma_p0", "wgmma"),
                  ("wgmma", "wgmma_p0", "sdpa")):
        for n in order:
            times[n].append(cuda_ms(fns[n], 10))
    ms = {n: sum(t) / len(t) for n, t in times.items()}
    plain_ms = cuda_ms(lambda: fa_ref.flash_attention_tc_ref(
        q, k, v, prefix_len=prefix), 1)
    nbytes = (q.numel() + k.numel() + v.numel() + b * s * h * dv) * 2
    pairs = _visible_pairs(s, s, True, prefix)
    flops = 2 * (dh + dv) * h * b * pairs
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_TC_FLOPS)
    flops0 = 2 * (dh + dv) * h * b * _visible_pairs(s, s, True, 0)
    b0_ms, _ = bound(nbytes, flops0, PEAK_BF16_TC_FLOPS)
    print(f"kernel {VLM_INST} ({b}, {s}, {h}, {kvh}, {dh}/{dv}) bf16 causal "
          f"with prefix {prefix}, one call in turns (ms each: {times}): "
          f"{ms['wgmma']:.3f} ms, {flops / ms['wgmma'] / 1e9:.1f} TFLOP/s, "
          f"{b_ms / ms['wgmma']:.3f} of the {b_ms:.4f} ms bound ({b_by}: "
          f"{flops:.4e} flops over {pairs:,} visible pairs, "
          f"{nbytes / 1e6:.1f} MB); at prefix 0 {ms['wgmma_p0']:.3f} ms "
          f"({b0_ms / ms['wgmma_p0']:.3f} of its {b0_ms:.4f} ms bound); SDPA "
          f"(causal, no prefix, KV repeated to {h} heads) {ms['sdpa']:.3f} "
          f"ms, ratio {ms['wgmma'] / ms['sdpa']:.3f} (at prefix 0 "
          f"{ms['wgmma_p0'] / ms['sdpa']:.3f}); plain flash_attention_tc_ref "
          f"{plain_ms:.3f} ms; {_tc_text(tc, 0)}; rel L2 {rel_f32p:.3e} vs "
          f"float32-P; max |SDPA - kernel at prefix 0| {sdpa_err:.3e}",
          flush=True)
    del q, k, v, qh, kh, vh, got
    return dict(name=VLM_INST, route="cuda",
                source="src/repro_torch/csrc/flash_attention_wgmma.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:59",
                max_abs_err=max(err, tc["err"]), ms=ms["wgmma"],
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=ms["sdpa"], prefix0_ms=ms["wgmma_p0"],
                prefix0_bound_ms=b0_ms)


def _vlm_cpu_check(cfg) -> None:
    """(e) 2 layers at full width, VLM_CPU_SEQ text tokens after the 256
    patches, weights drawn on the CPU, card against CPU: the last
    position's logits and its argmax."""
    import torch

    from repro_torch.data.synthetic import batch_for
    from repro_torch.models.lm import init_lm, lm_hidden, lm_logits

    cut = dataclasses.replace(cfg, n_layers=VLM_CPU_LAYERS)
    t0 = time.perf_counter()
    host = init_lm(cut, seed=0, device="cpu", dtype=torch.bfloat16)
    draw_s = time.perf_counter() - t0
    card_model = copy.deepcopy(host).to("cuda")
    batch = batch_for(cut, VLM_CPU_SEQ, 1, 2)
    last = []
    for model, d in ((card_model, torch.device("cuda")),
                     (host, torch.device("cpu"))):
        t0 = time.perf_counter()
        with torch.inference_mode():
            hid, _ = lm_hidden(model, batch["inputs"].to(d), cut,
                               prefix_embeds=batch["patches"].to(d),
                               attn_impl="blockwise")
            last.append(lm_logits(model, hid[:, -1:], cut).float().cpu())
        print(f"  {VLM_CPU_LAYERS}-layer prefill of {VLM_CPU_SEQ} tokens "
              f"after {cut.vlm.n_patches} patches on {d}: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    on_card, on_cpu = last
    rel = float((on_card - on_cpu).norm() / on_cpu.norm())
    same = int(on_card.argmax()) == int(on_cpu.argmax())
    text = (f"vlm check: {cut.name} {VLM_CPU_LAYERS} layers at full width, "
            f"{VLM_CPU_SEQ} tokens after {cut.vlm.n_patches} patches "
            f"(weights drawn on the CPU in {draw_s:.1f} s): last-position "
            f"logits card vs CPU rel L2 {rel:.3e} (tolerance "
            f"{VLM_CPU_RTOL}), argmax {'agrees' if same else 'differs'} "
            f"({int(on_card.argmax())} vs {int(on_cpu.argmax())})")
    check(math.isfinite(rel) and rel <= VLM_CPU_RTOL, text)
    print(text, flush=True)


def _vlm_route_check() -> None:
    """(f) The 3xTF32 route: the reduced paligemma (head dim 16, 16
    patches) prefill at 2 x VLM_SMALL_SEQ on the card, one 3xTF32
    launch a layer, logits within VLM_CPU_RTOL of the CPU run."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.lm import init_lm

    small = registry.reduced(VLM_CONFIG)
    shape = ShapeSpec("vlm_route", "prefill", VLM_SMALL_SEQ, 2)
    host = init_lm(small, seed=0, device="cpu", dtype=torch.bfloat16)
    batch = batch_for(small, VLM_SMALL_SEQ, 2, 3)
    _, n_cc, logits = _prefill(make_prefill_step(small, shape),
                               copy.deepcopy(host).to("cuda"), batch, small,
                               "vlm 3xTF32 route", tensor_cores=False,
                               keep=True)
    with torch.inference_mode():
        want = make_prefill_step(small, shape, device="cpu").fn(host, batch)
    rel = float((logits.float().cpu() - want.float()).norm()
                / want.float().norm())
    text = (f"vlm route check: {small.name} (head dim "
            f"{small.resolved_head_dim}, {small.vlm.n_patches} patches), 2 x "
            f"{VLM_SMALL_SEQ}: flash_attention (3xTF32) {n_cc} launches; "
            f"logits at all positions card vs CPU rel L2 {rel:.3e} "
            f"(tolerance {VLM_CPU_RTOL})")
    check(rel <= VLM_CPU_RTOL, text)
    print(text, flush=True)


def vlm_phase(card: str) -> tuple[dict, dict]:
    """Phase 12; returns the (256, 256) kernel's report row and the
    launches of its main path (the full-width prefill)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.lm import init_lm, lm_hidden, lm_logits

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = registry.get(VLM_CONFIG)
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16, draw_on="cuda")
    torch.cuda.synchronize()
    n_params = sum(p_.numel() for p_ in params.parameters())
    print(f"vlm init: {cfg.name}, {n_params:,} parameters ({cfg.n_layers} "
          f"layers, tied embeddings), {n_params * 2 / 1e9:.2f} GB bf16, drawn "
          f"from seed 0 on the card in {time.perf_counter() - t0:.2f} s",
          flush=True)
    check(n_params == cfg.n_params(), f"{n_params} != {cfg.n_params()}")

    row = vlm_flash_check(torch.device("cuda"), params, cfg)       # (a)

    # (b) the full-depth prefill at 1 x (256 patches + 32768 tokens), then
    # 4 x (256 + 4096)
    shape = dataclasses.replace(SHAPES["prefill_32k"], batch=PREFILL_BATCH)
    step = make_prefill_step(cfg, shape)
    batch = batch_for(cfg, shape.seq, shape.batch, 0)
    check({k: tuple(v.shape) for k, v in batch.items() if k != "targets"}
          == step.batch_shapes, f"vlm batch {step.batch_shapes}")
    torch.cuda.reset_peak_memory_stats()
    warm_s, _, _ = _prefill(step, params, batch, cfg, "vlm warm-up",
                            inst=VLM_INST)
    dt, launches, _ = _prefill(step, params, batch, cfg, "vlm timed",
                               inst=VLM_INST)
    n_pos = shape.batch * (shape.seq + cfg.vlm.n_patches)
    print(f"vlm prefill ({card}): {cfg.name} {shape.batch} x "
          f"({cfg.vlm.n_patches} patches + {shape.seq} tokens), "
          f"{cfg.n_layers} layers: {dt:.3f} s ({warm_s:.3f} s warm-up), "
          f"{n_pos / dt:,.0f} positions/s, "
          f"{shape.batch * shape.seq / dt:,.0f} text tokens/s; {VLM_INST} "
          f"{launches} launches, no 3xTF32 launch; attention share "
          f"~{cfg.n_layers * row['ms'] / 1e3 / dt:.3f} of the wall time; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del batch
    b4, s4 = VLM_SMALL_PREFILL
    step4 = make_prefill_step(cfg, dataclasses.replace(shape, batch=b4,
                                                       seq=s4))
    dt4, n4, _ = _prefill(step4, params, batch_for(cfg, s4, b4, 1), cfg,
                          f"vlm {b4} x {s4}", inst=VLM_INST)
    print(f"vlm prefill: {b4} x ({cfg.vlm.n_patches} + {s4}) positions: "
          f"{dt4:.3f} s, {b4 * (s4 + cfg.vlm.n_patches) / dt4:,.0f} "
          f"positions/s; {VLM_INST} {n4} launches", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    _serve(card, cfg, params, rng)                                 # (c)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (1, DECODE_CHECK_SEQ)),
                        device="cuda")

    def text_prefill():           # the decode has no prefix: no patches
        with torch.inference_mode():
            hid, _ = lm_hidden(params, toks, cfg, attn_impl="blockwise")
            return lm_logits(params, hid, cfg)

    _teacher_forced(card, cfg, params, toks, text_prefill, VLM_INST)  # (d)
    del params, step, step4
    gc.collect()
    torch.cuda.empty_cache()
    _vlm_cpu_check(cfg)                                            # (e)
    _vlm_route_check()                                             # (f)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"vlm phase: {time.perf_counter() - t_phase:.2f} s", flush=True)
    return row, {VLM_INST: launches}


# ----------------------------------------------------------------------
# Phase 13: the hybrid family (zamba2-2.7b)
# ----------------------------------------------------------------------
def hybrid_flash_check(dev, params, cfg) -> dict:
    """(a) The (80, 80) instantiation against its plain version:
    `_tc_check` with the kernel's dumped P on HYBRID_CASES (32 heads over
    32 KV heads; the last with a 64-position prefix, which no zamba2 path
    uses), q / k / v built as the shared block builds them from random
    inputs (q and k read through RoPE's strides), and on a q read through
    the strides of wider rows; then at the prefill's shape (1, 32768, 32,
    32) causal against the plain version's own P, timed in turns with
    SDPA on the same inputs (`_against_sdpa`)."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import attention as attn
    from repro_torch.models.common import apply_norm
    from repro_torch.models.lm import _zamba_attn_cfg

    dh, dv = HYBRID_DIMS
    acfg = _zamba_attn_cfg(cfg)
    h = acfg.n_heads
    g = torch.Generator(device=dev).manual_seed(17)

    def qkv(b, s):                     # as the shared block builds them
        with torch.inference_mode():
            x = torch.randn((b, s, cfg.d_model), generator=g,
                            device=dev).bfloat16()
            sh = params.shared
            return attn._project_qkv(sh.attn, apply_norm(sh.ln1, x, cfg.norm),
                                     acfg, torch.arange(s, device=dev))

    err = 0.0
    for b, s, causal, prefix_len in HYBRID_CASES:
        q, k, v = qkv(b, s)
        check(fk.kernel_layout_ok(q) and not q.is_contiguous(),
              "the shared block's q: RoPE's strides")
        err = max(err, _held_tc(
            HYBRID_INST, f"({b}, {s}, {h}, {h}, {dh}) "
            f"{'causal' if causal else 'full'}, prefix {prefix_len}, from "
            f"the shared block", q, k, v, causal, prefix_len))
    wide = torch.randn((1, 1000, h, 96), generator=g, device=dev).bfloat16()
    q, (_, k, v) = wide[..., :dh], qkv(1, 1000)
    check(fk.kernel_layout_ok(q) and not q.is_contiguous(), "strided q")
    err = max(err, _held_tc(HYBRID_INST, f"(1, 1000, {h}, {h}) q read "
                            f"through strides", q, k, v, True, 0))
    del q, k, v, wide

    # the prefill's shape: 1 x 32768, 32 heads, causal; SDPA in turns
    row = _against_sdpa(HYBRID_INST, *qkv(PREFILL_BATCH, 32768))
    row["max_abs_err"] = max(err, row["max_abs_err"])
    return row


def _against_sdpa(inst: str, q, k, v) -> dict:
    """A tensor-core instantiation at an MHA prefill's shape, causal: held
    against the plain version's own P (`_tc_check`) and within
    TC_F32P_REL_L2 of the float32-P plain version, then timed in turns
    with SDPA (a fused backend) on the same inputs, with the plain
    version's time and the bound; returns the kernel's report row (its
    `max_abs_err` that of this shape)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fa_ref

    b, s, h, dh = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    check(kvh == h, f"{inst}: SDPA is timed at MHA shapes, not {h} heads "
                    f"over {kvh}")
    got = fk.flash_attention_wgmma(q, k, v)
    tc = _tc_check(got, q, k, v, True, 0, dump=False)
    rel_f32p = _rel_l2(got, fa_ref.flash_attention_ref(q, k, v))
    what = f"{inst} ({b}, {s}, {h}, {kvh}, {dh}/{dv})"
    check(tc["ok"] and rel_f32p <= TC_F32P_REL_L2,
          f"{what}: {_tc_text(tc, 0)}; rel L2 {rel_f32p:.3e} vs the "
          f"float32-P plain version")
    qh, kh, vh = (x_.transpose(1, 2).contiguous() for x_ in (q, k, v))
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def sdpa():
        with sdpa_kernel(fused):
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    sdpa_err = float((sdpa().transpose(1, 2).float() - got.float())
                     .abs().max())
    fns = {"wgmma": lambda: fk.flash_attention_wgmma(q, k, v), "sdpa": sdpa}
    times = {n: [] for n in fns}
    for order in (("wgmma", "sdpa"), ("sdpa", "wgmma"), ("wgmma", "sdpa")):
        for n in order:
            times[n].append(cuda_ms(fns[n], 10))
    ms = {n: sum(t) / len(t) for n, t in times.items()}
    plain_ms = cuda_ms(lambda: fa_ref.flash_attention_tc_ref(q, k, v), 1)
    nbytes = (q.numel() + k.numel() + v.numel() + b * s * h * dv) * 2
    pairs = _visible_pairs(s, s, True, 0)
    flops = 2 * (dh + dv) * h * b * pairs
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_TC_FLOPS)
    print(f"kernel {what} bf16 causal, one call in turns (ms each: "
          f"{times}): {ms['wgmma']:.3f} ms, "
          f"{flops / ms['wgmma'] / 1e9:.1f} TFLOP/s, "
          f"{b_ms / ms['wgmma']:.3f} of the {b_ms:.4f} ms bound ({b_by}: "
          f"{flops:.4e} flops over {pairs:,} visible pairs, "
          f"{nbytes / 1e6:.1f} MB); SDPA (causal) {ms['sdpa']:.3f} ms, "
          f"ratio {ms['wgmma'] / ms['sdpa']:.3f}; plain "
          f"flash_attention_tc_ref {plain_ms:.3f} ms; {_tc_text(tc, 0)}; "
          f"rel L2 {rel_f32p:.3e} vs float32-P; max |SDPA - kernel| "
          f"{sdpa_err:.3e}", flush=True)
    return dict(name=inst, route="cuda",
                source="src/repro_torch/csrc/flash_attention_wgmma.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:59",
                max_abs_err=tc["err"], ms=ms["wgmma"],
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=ms["sdpa"])


def _hybrid_f32_decode(card: str, cfg, params, toks, bf16_step) -> None:
    """(d), float32: `decode_step` with a float32 backbone and float32
    shared caches under teacher forcing against the float32 prefill of
    the same tokens with dense attention (the same bf16 weights, each
    cast to float32 where it is used): rel L2 <= HYBRID_F32_DECODE_RTOL at
    every position and every argmax equal.  Printed beside: the bf16
    prefill (`bf16_step`, the (80, 80) kernel) against the float32 one."""
    import torch

    from repro_torch.models import lm

    s = toks.shape[1]
    with torch.inference_mode():
        bf16 = bf16_step.fn(params, {"inputs": toks})[0].float()
    saved = lm.BACKBONE
    lm.BACKBONE = torch.float32
    try:
        with torch.inference_mode():
            hid, _ = lm.lm_hidden(params, toks, cfg, attn_impl="dense")
            want = lm.lm_logits(params, hid, cfg)[0]
        check(want.dtype == torch.float32, f"float32 prefill in {want.dtype}")
        state = lm.init_decode_state(cfg, 1, s, dtype=torch.float32)
        rels, agree = [], 0
        for t in range(s):
            got, state = lm.decode_step(params, state, toks[:, t], cfg)
            rels.append(float((got[0] - want[t]).norm() / want[t].norm()))
            agree += int(got[0].argmax() == want[t].argmax())
    finally:
        lm.BACKBONE = saved
    bf16_rel = [float((bf16[t] - want[t]).norm() / want[t].norm())
                for t in range(s)]
    text = (f"decode check ({card}): {cfg.name}, float32 backbone and "
            f"caches, decode_step under teacher forcing vs the float32 "
            f"dense prefill on {s} tokens: rel L2 max {max(rels):.3e} "
            f"(tolerance {HYBRID_F32_DECODE_RTOL}), top-1 equal at {agree} "
            f"of {s}; the bf16 prefill ({HYBRID_INST}) vs the float32 one: "
            f"rel L2 max {max(bf16_rel):.3e}, median "
            f"{sorted(bf16_rel)[s // 2]:.3e}")
    check(all(math.isfinite(r) and r <= HYBRID_F32_DECODE_RTOL for r in rels)
          and agree == s, text)
    print(text, flush=True)


def _nbytes(tree) -> int:
    """Bytes of a dict of tensors (or of such dicts)."""
    return sum(_nbytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


def _long_500k(card: str, cfg, params, steps: int) -> dict:
    """`make_serve_step` at long_500k (batch 1, 524,288 positions, which
    only a sub-quadratic config is admitted to): `steps` decode steps,
    finite logits; ms a step against the bytes bound of reading the
    weights and the whole state once a step.  Returns the state's bytes
    and the ms a step after the first."""
    import numpy as np
    import torch

    from repro_torch.launch.shapes import SHAPES, applicable
    from repro_torch.launch.steps import make_serve_step

    shape = SHAPES["long_500k"]
    ok, why = applicable(cfg, shape)
    check(ok, f"long_500k refused for {cfg.name}: {why}")
    torch.cuda.reset_peak_memory_stats()
    step = make_serve_step(cfg, shape)
    state = step.init_state()
    parts = {k: _nbytes(v) for k, v in state.items() if k != "pos"}
    w_bytes = sum(p_.numel() * p_.element_size() for p_ in params.parameters())
    toks = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (steps, shape.batch)), device="cuda")
    ms = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = step.fn(params, state, toks[i])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(tuple(logits.shape) == (shape.batch, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"long_500k step {i}: logits {tuple(logits.shape)} not finite")
    check(state["pos"] == steps, f"long_500k pos {state['pos']}")
    nbytes = w_bytes + sum(parts.values())
    b_ms, _ = bound(nbytes, 0)
    steady = sum(ms[1:]) / (len(ms) - 1)
    print(f"long_500k decode ({card}): {cfg.name} batch {shape.batch}, "
          f"{shape.seq:,} positions: decode state "
          f"{', '.join(f'{k} {v / 1e6:.3f} MB' for k, v in parts.items())}, "
          f"weights {w_bytes / 1e9:.2f} GB; {steps} steps, ms each "
          f"{[round(m, 3) for m in ms]}: {steady:.3f} ms a step after the "
          f"first, against the {b_ms:.3f} ms bytes bound "
          f"({nbytes / 1e9:.3f} GB read once at 3.35 TB/s; "
          f"{b_ms / steady:.3f} of it); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return dict(state_bytes=sum(parts.values()), ms=steady)


def _hybrid_cpu_check(cfg) -> None:
    """(f) One group (6 Mamba2 layers and one shared call) at full width,
    HYBRID_CPU_SEQ tokens, the same weights on the card and the CPU:
    the last position's logits within HYBRID_CPU_RTOL, argmax equal."""
    cut = dataclasses.replace(cfg, n_layers=cfg.hybrid.shared_attn_every)
    rel, top, draw_s = _card_vs_cpu_prefill(cut, HYBRID_CPU_SEQ)
    same = top[0] == top[1]
    text = (f"hybrid check: {cut.name} one group ({cut.n_layers} Mamba2 "
            f"layers, one shared call) at full width, {HYBRID_CPU_SEQ} tokens "
            f"(weights drawn and copied in {draw_s:.1f} s): last-position "
            f"logits card vs CPU rel L2 {rel:.3e} (tolerance "
            f"{HYBRID_CPU_RTOL}), argmax {'agrees' if same else 'differs'} "
            f"({top[0]} vs {top[1]})")
    check(math.isfinite(rel) and rel <= HYBRID_CPU_RTOL and same, text)
    print(text, flush=True)


def _hybrid_route_check() -> None:
    """(g) The 3xTF32 route: the reduced zamba2 (shared attention at
    head dim 16, chunk 16) prefill at 2 x HYBRID_SMALL_SEQ on the card,
    one 3xTF32 launch per shared call, logits within HYBRID_CPU_RTOL
    of the CPU run."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.lm import init_lm

    small = registry.reduced(HYBRID_CONFIG)
    shape = ShapeSpec("hybrid_route", "prefill", HYBRID_SMALL_SEQ, 2)
    host = init_lm(small, seed=0, device="cpu", dtype=torch.bfloat16)
    batch = batch_for(small, HYBRID_SMALL_SEQ, 2, 3)
    _, n_cc, logits = _prefill(make_prefill_step(small, shape),
                               copy.deepcopy(host).to("cuda"), batch, small,
                               "hybrid 3xTF32 route", tensor_cores=False,
                               keep=True)
    with torch.inference_mode():
        want = make_prefill_step(small, shape, device="cpu").fn(host, batch)
    rel = float((logits.float().cpu() - want.float()).norm()
                / want.float().norm())
    text = (f"hybrid route check: {small.name} (shared attention head dim "
            f"16, chunk {small.ssm.chunk}), 2 x {HYBRID_SMALL_SEQ}: "
            f"flash_attention (3xTF32) {n_cc} launches; logits at all "
            f"positions card vs CPU rel L2 {rel:.3e} (tolerance "
            f"{HYBRID_CPU_RTOL})")
    check(rel <= HYBRID_CPU_RTOL, text)
    print(text, flush=True)


def hybrid_phase(card: str) -> tuple[dict, dict]:
    """Phase 13; returns the (80, 80) kernel's report row and the launches
    of its main path (the full-width prefill)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import SHAPES, ShapeSpec
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.lm import init_lm

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = registry.get(HYBRID_CONFIG)
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16, draw_on="cuda")
    torch.cuda.synchronize()
    n_params = sum(p_.numel() for p_ in params.parameters())
    print(f"hybrid init: {cfg.name}, {n_params:,} parameters ({cfg.n_layers} "
          f"Mamba2 layers in {_attn_calls(cfg)} groups, one shared block), "
          f"{n_params * 2 / 1e9:.2f} GB bf16, drawn from seed 0 on the card "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    check(n_params == cfg.n_params(), f"{n_params} != {cfg.n_params()}")

    row = hybrid_flash_check(torch.device("cuda"), params, cfg)    # (a)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the full-depth prefill at 1 x 32768, then 4 x 4096
    shape = dataclasses.replace(SHAPES["prefill_32k"], batch=PREFILL_BATCH)
    step = make_prefill_step(cfg, shape)
    batch = batch_for(cfg, shape.seq, shape.batch, 0)
    torch.cuda.reset_peak_memory_stats()
    warm_s, _, _ = _prefill(step, params, batch, cfg, "hybrid warm-up",
                            inst=HYBRID_INST)
    dt, launches, _ = _prefill(step, params, batch, cfg, "hybrid timed",
                               inst=HYBRID_INST)
    tokens = shape.batch * shape.seq
    print(f"hybrid prefill ({card}): {cfg.name} {shape.batch} x {shape.seq} "
          f"tokens, {cfg.n_layers} Mamba2 layers and {_attn_calls(cfg)} "
          f"shared calls: {dt:.3f} s ({warm_s:.3f} s warm-up), "
          f"{tokens / dt:,.0f} tokens/s; {HYBRID_INST} {launches} launches, "
          f"no 3xTF32 launch; attention share "
          f"~{_attn_calls(cfg) * row['ms'] / 1e3 / dt:.3f} of the wall time; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB", flush=True)
    del batch
    b4, s4 = HYBRID_SMALL_PREFILL
    step4 = make_prefill_step(cfg, dataclasses.replace(shape, batch=b4,
                                                       seq=s4))
    dt4, n4, _ = _prefill(step4, params, batch_for(cfg, s4, b4, 1), cfg,
                          f"hybrid {b4} x {s4}", inst=HYBRID_INST)
    print(f"hybrid prefill: {b4} x {s4} tokens: {dt4:.3f} s, "
          f"{b4 * s4 / dt4:,.0f} tokens/s; {HYBRID_INST} {n4} launches",
          flush=True)
    del step, step4
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    _serve(card, cfg, params, rng)                                 # (c)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (1, DECODE_CHECK_SEQ)),
                        device="cuda")
    check_step = make_prefill_step(cfg, ShapeSpec(
        "decode_check", "prefill", DECODE_CHECK_SEQ, 1))
    _hybrid_f32_decode(card, cfg, params, toks, check_step)        # (d)
    _teacher_forced(card, cfg, params, toks,
                    lambda: check_step.fn(params, {"inputs": toks}),
                    HYBRID_INST, HYBRID_DECODE_RTOL, HYBRID_DECODE_TOP1)
    gc.collect()
    torch.cuda.empty_cache()
    _long_500k(card, cfg, params, HYBRID_LONG_STEPS)               # (e)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _hybrid_cpu_check(cfg)                                         # (f)
    _hybrid_route_check()                                          # (g)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"hybrid phase: {time.perf_counter() - t_phase:.2f} s", flush=True)
    return row, {HYBRID_INST: launches}


# ----------------------------------------------------------------------
# Phase 14: the dense family's other configs (qwen3-8b, codeqwen1.5-7b,
# granite-34b)
# ----------------------------------------------------------------------
def dense_configs_phase(card: str) -> dict:
    """Phase 14; returns each config's 1 x 32768 prefill's launches of
    the (128, 128) instantiation."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import SHAPES, ShapeSpec
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.lm import init_lm

    launches = {}
    for name in DENSE_CONFIGS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_cfg = time.perf_counter()
        cfg = registry.get(name)
        params = init_lm(cfg, seed=0, dtype=torch.bfloat16, draw_on="cuda")
        torch.cuda.synchronize()
        n_params = sum(p_.numel() for p_ in params.parameters())
        check(n_params == cfg.n_params(), f"{n_params} != {cfg.n_params()}")
        print(f"dense init: {cfg.name}, {n_params:,} parameters "
              f"({cfg.n_layers} layers, {cfg.n_heads} heads over "
              f"{cfg.n_kv_heads} KV heads, positions {cfg.pos}), "
              f"{n_params * 2 / 1e9:.2f} GB bf16, drawn from seed 0 on the "
              f"card in {time.perf_counter() - t_cfg:.2f} s", flush=True)

        # (a) the full-depth prefill at 1 x 32768, then 4 x 4096
        shape = dataclasses.replace(SHAPES["prefill_32k"],
                                    batch=PREFILL_BATCH)
        step = make_prefill_step(cfg, shape)
        batch = batch_for(cfg, shape.seq, shape.batch, 0)
        torch.cuda.reset_peak_memory_stats()
        warm_s, _, _ = _prefill(step, params, batch, cfg,
                                f"{name} warm-up", inst=DENSE_INST)
        dt, n, _ = _prefill(step, params, batch, cfg, f"{name} timed",
                            inst=DENSE_INST)
        launches[name] = n
        print(f"dense prefill ({card}): {cfg.name} {shape.batch} x "
              f"{shape.seq} tokens, {cfg.n_layers} layers: {dt:.3f} s "
              f"({warm_s:.3f} s warm-up), {shape.seq / dt:,.0f} tokens/s; "
              f"{DENSE_INST} {n} launches, no 3xTF32 launch; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)
        del batch
        b4, s4 = DENSE_SMALL_PREFILL
        step4 = make_prefill_step(cfg, dataclasses.replace(shape, batch=b4,
                                                           seq=s4))
        torch.cuda.reset_peak_memory_stats()
        dt4, n4, _ = _prefill(step4, params, batch_for(cfg, s4, b4, 1), cfg,
                              f"{name} {b4} x {s4}", inst=DENSE_INST)
        print(f"dense prefill: {cfg.name} {b4} x {s4} tokens: {dt4:.3f} s, "
              f"{b4 * s4 / dt4:,.0f} tokens/s; {DENSE_INST} {n4} launches; "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        del step, step4
        gc.collect()
        torch.cuda.empty_cache()

        rng = np.random.default_rng(0)
        _serve(card, *_first_layers(cfg, params, DENSE_SERVE_LAYERS),  # (b)
               rng)
        toks = torch.tensor(rng.integers(0, cfg.vocab,
                                         (1, DECODE_CHECK_SEQ)),
                            device="cuda")
        check_step = make_prefill_step(cfg, ShapeSpec(
            "decode_check", "prefill", DECODE_CHECK_SEQ, 1))
        _teacher_forced(card, cfg, params, toks,                   # (c)
                        lambda: check_step.fn(params, {"inputs": toks}),
                        DENSE_INST)
        del params, check_step
        gc.collect()
        torch.cuda.empty_cache()

        # (d) 2 layers at full width, card against CPU
        rel, top, draw_s = _card_vs_cpu_prefill(
            dataclasses.replace(cfg, n_layers=PREFILL_CPU_LAYERS),
            PREFILL_CPU_SEQ)
        text = (f"dense check: {cfg.name} cut to {PREFILL_CPU_LAYERS} layers "
                f"at full width, {PREFILL_CPU_SEQ} tokens (weights drawn and "
                f"copied in {draw_s:.1f} s): last-position logits card vs "
                f"CPU rel L2 {rel:.3e} (tolerance {PREFILL_CPU_RTOL}), argmax "
                f"{'agrees' if top[0] == top[1] else 'differs'} ({top[0]} vs "
                f"{top[1]})")
        check(math.isfinite(rel) and rel <= PREFILL_CPU_RTOL
              and top[0] == top[1], text)
        print(text, flush=True)
        print(f"dense configs: {cfg.name} {time.perf_counter() - t_cfg:.2f} s",
              flush=True)
    return launches


# ----------------------------------------------------------------------
# Phase 15: the hybrid and VLM families' train steps
# ----------------------------------------------------------------------
def _train_vs_ce(card: str, cfg, inst: str, state, n_params: int,
                 draw_ms: float, steps: int,
                 rtol: float) -> tuple[dict, dict, float, float]:
    """`steps` steps of `make_train_step(remat=True)` with the default
    AdamW at TRAIN_LM_SHAPE from `state` (float32 masters), step 0's
    loss against the CE of its batch through the prefill path
    (`_prefill_ce`, which must launch `inst` once an attention call, and
    for the SSM family nothing of ours) within `rtol`: finite losses
    and grad norms, no launch of a kernel of ours in the steps.
    Returns (state, `_train_run`'s numbers, the CE gap, the median ms a
    step after the first)."""
    import torch

    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.steps import make_train_step

    b, s = TRAIN_LM_SHAPE
    batches = [batch_for(cfg, s, b, i, seed=0, device=torch.device("cuda"))
               for i in range(steps)]
    ce, ce_launches = _prefill_ce(cfg, state, batches[0])
    check(ce_launches.get(inst, 0) == _attn_calls(cfg)
          and not (cfg.family == "ssm" and ce_launches),
          f"train {cfg.name} CE check: prefill launches {ce_launches}")
    state, run = _train_run(make_train_step(cfg, remat=True), state,
                            batches)
    losses, ms = run["losses"], run["ms"]
    gap = abs(losses[0] - ce) / abs(ce)
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    positions = s + (cfg.vlm.n_patches if cfg.family == "vlm" else 0)
    print(f"train ({card}): {cfg.name} full width and depth, {n_params} "
          f"float32 master parameters drawn on the card in "
          f"{draw_ms / 1e3:.2f} s; make_train_step(remat=True), default "
          f"AdamW, {b} x {s} tokens ({positions} positions a sequence): "
          f"{steps} steps {[round(x, 2) for x in ms]} ms "
          f"(median after the first {steady:.2f} ms a step = "
          f"{b * s / steady * 1e3:.0f} tokens/s, "
          f"{b * positions / steady * 1e3:.0f} positions/s); losses "
          f"{[round(x, 5) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in run['gnorms']]}; peak memory "
          f"{run['peak_gb']:.2f} GB; step-0 loss {losses[0]:.6f} vs the "
          f"prefill path's CE {ce:.6f} (rel {gap:.3e}, tolerance {rtol}; "
          f"{ce_launches.get(inst, 0)} {inst} launches); launches of the "
          f"port's kernels in the steps: {run['launches']}", flush=True)
    check(all(math.isfinite(x) for x in losses + run["gnorms"]),
          f"train {cfg.name}: losses {losses}, grad norms {run['gnorms']}")
    check(gap <= rtol, f"train {cfg.name}: step-0 loss {losses[0]} vs the "
                       f"prefill path's CE {ce}")
    check(not run["launches"], f"train {cfg.name}: the train step launched "
                               f"kernels of ours {run['launches']}")
    return state, run, gap, steady


def family_train_phase(card: str) -> dict:
    """Phase 15; returns each config's step ms, peak memory and train_4k
    ms and peak."""
    import gc

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import SHAPES, microbatches_for
    from repro_torch.launch.steps import make_train_step

    dev = torch.device("cuda")
    rows = {}
    for name, inst, batch4k, check_layers in FAMILY_TRAIN:
        gc.collect()
        torch.cuda.empty_cache()
        t_cfg = time.perf_counter()
        cfg = registry.get(name)
        state, draw_ms = _sync_ms(lambda: _card_train_state(cfg))
        n_params = sum(p.numel() for p in state["params"].parameters())
        check(n_params == cfg.n_params(), f"train {name}: {n_params} "
                                          f"parameters")
        # -- (a) TRAIN_LM_STEPS steps at the launcher's defaults, step 0's
        # loss against the CE of its batch through the prefill path
        state, run, gap, steady = _train_vs_ce(
            card, cfg, inst, state, n_params, draw_ms, TRAIN_LM_STEPS,
            TRAIN_CE_RTOL)
        # train_4k cut to batch4k sequences, its microbatches
        shape4k = SHAPES["train_4k"]
        mb = microbatches_for(cfg, shape4k)
        batches = [batch_for(cfg, shape4k.seq, batch4k,
                             TRAIN_LM_STEPS + i, seed=0, device=dev)
                   for i in range(TRAIN_4K_STEPS)]
        state, run4k = _train_run(make_train_step(cfg, remat=True,
                                                  microbatches=mb),
                                  state, batches)
        tok4k = batch4k * shape4k.seq
        print(f"train_4k ({card}): {cfg.name} cut to "
              f"{batch4k} x {shape4k.seq}, {mb} microbatches, "
              f"remat: {[round(x, 2) for x in run4k['ms']]} ms a step (last "
              f"{tok4k / run4k['ms'][-1] * 1e3:.0f} tokens/s); losses "
              f"{[round(x, 5) for x in run4k['losses']]}, grad norms "
              f"{[round(x, 4) for x in run4k['gnorms']]}; peak memory "
              f"{run4k['peak_gb']:.2f} GB; launches of the port's kernels "
              f"{run4k['launches']}", flush=True)
        check(all(math.isfinite(x) for x in run4k["losses"] + run4k["gnorms"]),
              f"train_4k {name}: losses {run4k['losses']}")
        check(not run4k["launches"], f"train_4k {name}: launches "
                                     f"{run4k['launches']}")
        del state, batches
        gc.collect()
        torch.cuda.empty_cache()
        # -- (b) a cut at full width: card vs CPU, microbatches, remat
        _step_variants(card, dataclasses.replace(cfg, n_layers=check_layers))
        rows[name] = dict(step_ms=steady, peak_gb=run["peak_gb"],
                          ce_gap=gap, train_4k_ms=run4k["ms"],
                          train_4k_peak_gb=run4k["peak_gb"])
        print(f"family train: {cfg.name} {time.perf_counter() - t_cfg:.2f} s",
              flush=True)
    return rows


# ----------------------------------------------------------------------
# Phase 16: the audio and SSM families (whisper-large-v3, xlstm-125m)
# ----------------------------------------------------------------------
def audio_flash_check(dev, params, cfg) -> dict:
    """(a) The (64, 64) instantiation at whisper's MHA (20 heads over 20
    KV heads, a GQA group of 1), q / k / v built as the first decoder
    layer's self-attention builds them from random inputs: held to its
    plain version by `_held_tc` with its dumped P on AUDIO_CASES, then at
    the prefill's shape (1, 32768, 20, 20) causal by `_against_sdpa`."""
    import torch

    from repro_torch.models import attention as attn
    from repro_torch.models.common import apply_norm

    blk = params.dec_blocks[0]
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(23)

    def qkv(b, s):                     # as the decoder's self-attention
        with torch.inference_mode():
            x = torch.randn((b, s, cfg.d_model), generator=g,
                            device=dev).bfloat16()
            return attn._project_qkv(blk.attn, apply_norm(blk.ln1, x,
                                                          cfg.norm),
                                     cfg, torch.arange(s, device=dev))

    err = 0.0
    for b, s, causal in AUDIO_CASES:
        err = max(err, _held_tc(
            AUDIO_INST, f"({b}, {s}, {h}, {h}, {dh}) "
            f"{'causal' if causal else 'full'}, from the decoder",
            *qkv(b, s), causal, 0))
    row = _against_sdpa(AUDIO_INST, *qkv(PREFILL_BATCH, 32768))
    row["max_abs_err"] = max(err, row["max_abs_err"])
    return row


def _audio_decode_check(card: str, cfg, params) -> None:
    """(d) `precompute_cross` over a batch's frames, then
    `whisper_decode_step` under teacher forcing at AUDIO_DECODE against
    the prefill of the same frames and tokens (its self-attention on
    AUDIO_INST, one launch a decoder layer): rel L2 <= DECODE_RTOL at
    every (row, position); top-1 agreement and ms a step printed."""
    import torch

    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import whisper

    b, s = AUDIO_DECODE
    batch = batch_for(cfg, s, b, 5, device=torch.device("cuda"))
    step = make_prefill_step(cfg, ShapeSpec("decode_check", "prefill", s, b))
    want, launches = _counted(lambda: step.fn(params, batch))
    check(launches.get(AUDIO_INST, 0) == _attn_calls(cfg),
          f"audio decode check prefill launches {launches}")
    want = want.float()
    state = whisper.init_whisper_decode_state(cfg, b, s)
    (state["cross_k"], state["cross_v"]), cross_ms = _sync_ms(
        lambda: whisper.precompute_cross(params, batch["frames"], cfg))
    rels, agree = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(s):
        got, state = whisper.whisper_decode_step(params, state,
                                                 batch["inputs"][:, t], cfg)
        rels += [float((got[r] - want[r, t]).norm() / want[r, t].norm())
                 for r in range(b)]
        agree += int((got.argmax(-1) == want[:, t].argmax(-1)).sum())
    dt = time.perf_counter() - t0
    text = (f"audio decode check ({card}): {cfg.name}, precompute_cross "
            f"({b} x {cfg.encdec.enc_frames} frames, {cross_ms:.2f} ms), "
            f"then whisper_decode_step under teacher forcing vs the prefill "
            f"({AUDIO_INST}, {launches.get(AUDIO_INST, 0)} launches) on {b} "
            f"x {s} tokens, bf16 both: rel L2 max {max(rels):.3e}, median "
            f"{sorted(rels)[len(rels) // 2]:.3e} (tolerance {DECODE_RTOL}); "
            f"top-1 equal at {agree} of {b * s}; batch-{b} decode "
            f"{dt / s * 1e3:.3f} ms a step")
    check(all(math.isfinite(r) and r <= DECODE_RTOL for r in rels), text)
    print(text, flush=True)


def _audio_part(card: str) -> tuple[dict, int]:
    """(a)-(d) on whisper-large-v3: returns the (64, 64) kernel's report
    row and its launches on the 1 x 32768 prefill."""
    import gc

    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.base import EncDecConfig
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.whisper import init_whisper

    cfg = registry.get(AUDIO_CONFIG)
    t0 = time.perf_counter()
    params = init_whisper(cfg, seed=0, dtype=torch.bfloat16, draw_on="cuda")
    torch.cuda.synchronize()
    n_params = sum(p_.numel() for p_ in params.parameters())
    print(f"audio init: {cfg.name}, {n_params:,} parameters "
          f"({cfg.encdec.n_enc_layers} encoder and {cfg.n_layers} decoder "
          f"layers, {cfg.n_heads} heads over {cfg.n_kv_heads}, head dim "
          f"{cfg.resolved_head_dim}), {n_params * 2 / 1e9:.2f} GB bf16, "
          f"drawn from seed 0 on the card in {time.perf_counter() - t0:.2f} "
          f"s", flush=True)
    check(n_params == cfg.n_params(), f"{n_params} != {cfg.n_params()}")
    row = audio_flash_check(torch.device("cuda"), params, cfg)     # (a)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the full-depth prefill at 1 x 32768 (a warm-up and a timed
    # one), then 4 x 4096; each sequence carries its 1500 stub frames
    shape = dataclasses.replace(SHAPES["prefill_32k"], batch=PREFILL_BATCH)
    step = make_prefill_step(cfg, shape)
    batch = batch_for(cfg, shape.seq, shape.batch, 0)
    torch.cuda.reset_peak_memory_stats()
    warm_s, _, _ = _prefill(step, params, batch, cfg, "audio warm-up",
                            inst=AUDIO_INST)
    dt, launches, _ = _prefill(step, params, batch, cfg, "audio timed",
                               inst=AUDIO_INST)
    print(f"audio prefill ({card}): {cfg.name} {shape.batch} x {shape.seq} "
          f"tokens over {cfg.encdec.enc_frames} frames, "
          f"{cfg.encdec.n_enc_layers} + {cfg.n_layers} layers: {dt:.3f} s "
          f"({warm_s:.3f} s warm-up), {shape.seq / dt:,.0f} tokens/s; "
          f"{AUDIO_INST} {launches} launches, no 3xTF32 launch; "
          f"self-attention share ~{launches * row['ms'] / 1e3 / dt:.3f} of "
          f"the wall time; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del batch
    b4, s4 = AUDIO_SMALL_PREFILL
    step4 = make_prefill_step(cfg, dataclasses.replace(shape, batch=b4,
                                                       seq=s4))
    torch.cuda.reset_peak_memory_stats()
    dt4, n4, _ = _prefill(step4, params, batch_for(cfg, s4, b4, 1), cfg,
                          f"audio {b4} x {s4}", inst=AUDIO_INST)
    print(f"audio prefill: {cfg.name} {b4} x {s4} tokens: {dt4:.3f} s, "
          f"{b4 * s4 / dt4:,.0f} tokens/s; {AUDIO_INST} {n4} launches; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    del step, step4
    gc.collect()
    torch.cuda.empty_cache()
    _audio_decode_check(card, cfg, params)                         # (d)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) AUDIO_CPU_LAYERS encoder and decoder layers at full width: the
    # card against the CPU on the same weights
    cut = dataclasses.replace(
        cfg, n_layers=AUDIO_CPU_LAYERS,
        encdec=EncDecConfig(AUDIO_CPU_LAYERS, cfg.encdec.enc_frames))
    rel, top, draw_s = _card_vs_cpu_prefill(cut, PREFILL_CPU_SEQ)
    text = (f"audio check: {cfg.name} cut to {AUDIO_CPU_LAYERS} encoder and "
            f"{AUDIO_CPU_LAYERS} decoder layers at full width, "
            f"{PREFILL_CPU_SEQ} tokens over {cfg.encdec.enc_frames} frames "
            f"(weights drawn and copied in {draw_s:.1f} s): last-position "
            f"logits card vs CPU rel L2 {rel:.3e} (tolerance "
            f"{PREFILL_CPU_RTOL}), argmax "
            f"{'agrees' if top[0] == top[1] else 'differs'} ({top[0]} vs "
            f"{top[1]})")
    check(math.isfinite(rel) and rel <= PREFILL_CPU_RTOL and top[0] == top[1],
          text)
    print(text, flush=True)
    return row, launches


def _ssm_part(card: str) -> None:
    """(e)-(h) on xlstm-125m: no kernel of ours anywhere."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.lm import init_decode_state, init_lm

    cfg = registry.get(SSM_CONFIG)
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16, draw_on="cuda")
    torch.cuda.synchronize()
    n_params = sum(p_.numel() for p_ in params.parameters())
    print(f"ssm init: {cfg.name}, {n_params:,} parameters "
          f"({cfg.n_layers // 2} (mLSTM, sLSTM) pairs), "
          f"{n_params * 2 / 1e9:.3f} GB bf16, drawn from seed 0 on the card "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    check(n_params == cfg.n_params(), f"{n_params} != {cfg.n_params()}")

    # (e) prefills (mLSTM chunkwise, sLSTM a loop over time), the first
    # also the warm-up; no launch of ours
    for i, (b, s) in enumerate(SSM_PREFILLS):
        step = make_prefill_step(cfg, ShapeSpec("ssm", "prefill", s, b))
        torch.cuda.reset_peak_memory_stats()
        dt, _, _ = _prefill(step, params, batch_for(cfg, s, b, i), cfg,
                            f"ssm {b} x {s}")
        print(f"ssm prefill ({card}): {cfg.name} {b} x {s} tokens: "
              f"{dt:.3f} s, {b * s / dt:,.0f} tokens/s, "
              f"{dt / s * 1e6 / (cfg.n_layers // 2):.1f} us a position a "
              f"pair; no launch of a kernel of ours; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        del step
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    _serve(card, cfg, params, rng)                                 # (f)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (1, DECODE_CHECK_SEQ)),
                        device="cuda")
    check_step = make_prefill_step(cfg, ShapeSpec(
        "decode_check", "prefill", DECODE_CHECK_SEQ, 1))
    _teacher_forced(card, cfg, params, toks,
                    lambda: check_step.fn(params, {"inputs": toks}),
                    "flash_attention")
    # (g) long_500k: a state of the same bytes at any length
    sizes = {n: _nbytes(init_decode_state(cfg, 1, n)["caches"])
             for n in (1, 524288)}
    check(len(set(sizes.values())) == 1, f"ssm decode state bytes {sizes}")
    long = _long_500k(card, cfg, params, SSM_LONG_STEPS)
    check(long["state_bytes"] == sizes[1],
          f"long_500k state {long['state_bytes']} bytes, not {sizes[1]}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (h) one pair at full width: the card against the CPU
    cut = dataclasses.replace(cfg, n_layers=SSM_CPU_LAYERS)
    rel, top, draw_s = _card_vs_cpu_prefill(cut, PREFILL_CPU_SEQ)
    text = (f"ssm check: {cfg.name} cut to one (mLSTM, sLSTM) pair at full "
            f"width, {PREFILL_CPU_SEQ} tokens (weights drawn and copied in "
            f"{draw_s:.1f} s): last-position logits card vs CPU rel L2 "
            f"{rel:.3e} (tolerance {PREFILL_CPU_RTOL}), argmax "
            f"{'agrees' if top[0] == top[1] else 'differs'} ({top[0]} vs "
            f"{top[1]})")
    check(math.isfinite(rel) and rel <= PREFILL_CPU_RTOL and top[0] == top[1],
          text)
    print(text, flush=True)


def audio_ssm_phase(card: str) -> tuple[dict, dict]:
    """Phase 16; returns the (64, 64) kernel's report row and its
    launches on whisper-large-v3's 1 x 32768 prefill."""
    import gc

    import torch

    from repro_torch.configs import registry

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    row, launches = _audio_part(card)
    print(f"audio part: {time.perf_counter() - t_phase:.2f} s", flush=True)
    t_ssm = time.perf_counter()
    _ssm_part(card)
    print(f"ssm part: {time.perf_counter() - t_ssm:.2f} s", flush=True)
    # (i) a train step of each at full width and depth
    for name, inst in FAMILY16_TRAIN:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = registry.get(name)
        state, draw_ms = _sync_ms(lambda: _card_train_state(cfg))
        n_params = sum(p.numel() for p in state["params"].parameters())
        check(n_params == cfg.n_params(), f"train {name}: {n_params} "
                                          f"parameters")
        _train_vs_ce(card, cfg, inst, state, n_params, draw_ms,
                     FAMILY16_STEPS, FAMILY16_CE_RTOL)
        del state
    gc.collect()
    torch.cuda.empty_cache()
    print(f"audio and ssm phase: {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return row, {AUDIO_INST: launches}


# ----------------------------------------------------------------------
# Phase 17: training over a mesh (the sharded step, the CLI, GPipe, int8
# compression, the dry-run)
# ----------------------------------------------------------------------
def _mesh_step(cfg, shape, named, on_grad):
    """Two PERF_TRAIN_OVERRIDES steps of `cfg` on a ("data", "model") mesh
    of `shape` cuda:0 positions from the masters `named` (on the host;
    each position's shards are copied to the card): the first calls
    `on_grad` with each reduced grad (the checks, host copies included in
    its time), the second runs without it and is the step's time.
    Returns (the state after both, the first's metrics, its ms, the
    second's ms, the peak GB over both, their launches, the dry-run's
    state bytes a position, the replicated pieces found bitwise equal
    after the first)."""
    import torch

    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import (PERF_TRAIN_OVERRIDES,
                                          make_train_step, shard_params)

    perf = PERF_TRAIN_OVERRIDES[MESH_TRAIN_CONFIG]
    mesh = make_mesh(shape, ("data", "model"),
                     ["cuda:0"] * (shape[0] * shape[1]))
    checked = make_train_step(cfg, mesh, remat=True, on_grad=on_grad, **perf)
    plain = make_train_step(cfg, mesh, remat=True, **perf)
    state = shard_params(named, checked.policy, checked.opt_cfg)
    b, s = MESH_TRAIN_SHAPE
    batches = [batch_for(cfg, s, b, i, seed=0, device="cuda")
               for i in range(2)]
    torch.cuda.reset_peak_memory_stats()
    ((state, met), ms_checked), l1 = _counted(
        lambda: _sync_ms(lambda: checked.fn(state, batches[0])))
    met = {k: float(v) for k, v in met.items()}
    pieces = _replicas_equal(state)
    ((state, _), ms), l2 = _counted(
        lambda: _sync_ms(lambda: plain.fn(state, batches[1])))
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = dryrun.position_bytes(
        cfg, ShapeSpec("mesh_smoke", "train", s, b), mesh,
        model_strategy=perf["model_strategy"])["state_bytes"]
    launches = {k: l1.get(k, 0) + l2.get(k, 0) for k in {**l1, **l2}}
    return state, met, ms_checked, ms, peak, launches, want, pieces


def _replicas_equal(state) -> int:
    """Check that every piece held by several positions has the same bits
    on each (parameters and moments); returns how many such pieces."""
    import torch

    from repro_torch.parallel.sharding import holders

    n = 0
    for name, spec in state.specs.items():
        for owners in holders(state.mesh, spec).values():
            if len(owners) < 2:
                continue
            n += 1
            first = state.shards[owners[0]]
            for f in owners[1:]:
                other = state.shards[f]
                pairs = [(first["params"][name], other["params"][name])]
                for k in ("m", "v"):
                    a, b = first["opt"][k][name], other["opt"][k][name]
                    pairs += ([(a[sub], b[sub]) for sub in ("q", "s")]
                              if isinstance(a, dict) else [(a, b)])
                for a, b in pairs:
                    check(torch.equal(a, b),
                          f"mesh train: replicas of {name} differ")
    return n


def mesh_train_phase(card: str) -> dict:
    """Phase 17: (a) the sharded step 1x1 vs 2x2, (b) the CLI on a 2x2
    mesh, (c) GPipe, (d) int8 compression card vs CPU, (e) the dry-run."""
    import gc
    import shutil

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply
    from repro_torch.runtime.compression import (
        compress_decompress, cross_pod_allreduce_compressed)

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    # -- (a) one step on 1x1, then from the same masters on 2x2
    cfg = registry.get(MESH_TRAIN_CONFIG)
    if MESH_TRAIN_LAYERS is not None:
        cfg = dataclasses.replace(cfg, n_layers=MESH_TRAIN_LAYERS)
    card_named = dict(build_model(cfg).init(seed=0, draw_on="cuda")
                      .named_parameters())
    host = _pinned_buffers(card_named)
    for n, p in card_named.items():
        host[n].copy_(p.detach())
    n_params = sum(p.numel() for p in host.values())
    grads1: dict = {}
    pinned = _pinned_buffers(host)

    def keep(name, g):
        grads1[name] = pinned[name].copy_(g)

    del card_named
    torch.cuda.empty_cache()
    st1, m1, ck1, ms1, peak1, l1, want1, _ = _mesh_step(cfg, (1, 1), host,
                                                        keep)
    bytes1 = st1.position_bytes(0)
    del st1
    gc.collect()
    torch.cuda.empty_cache()
    worst = {"rel_l2": 0.0, "name": None}
    largest = max(host, key=lambda n: host[n].numel())
    kept = {}

    def compare(name, g):
        h1 = grads1.pop(name)
        h = h1.to(g.device)
        rel = float(torch.linalg.vector_norm((g - h).float())
                    / torch.linalg.vector_norm(h.float()).clamp_min(1e-30))
        if rel >= worst["rel_l2"]:
            worst.update(rel_l2=rel, name=name)
        if name == largest:
            kept.update(grad=g.cpu(), grad1=h1)

    st2, m2, ck2, ms2, peak2, l2, want2, pieces = _mesh_step(
        cfg, (2, 2), host, compare)
    del host
    bytes2 = [st2.position_bytes(f) for f in range(st2.mesh.size)]
    check(_replicas_equal(st2) == pieces, "mesh train: replicated pieces")
    del st2
    gc.collect()
    torch.cuda.empty_cache()
    la, lb = m2["loss"], m1["loss"]
    ga, gb = m2["grad_norm"], m1["grad_norm"]
    check(not l1 and not l2,
          f"mesh train: the steps launched kernels of ours {l1} {l2}")
    check(abs(la - lb) <= MESH_LOSS_RTOL * abs(lb),
          f"mesh train: 2x2 loss {la} vs 1x1 {lb}")
    check(abs(ga - gb) <= MESH_GNORM_RTOL * abs(gb),
          f"mesh train: 2x2 grad norm {ga} vs 1x1 {gb}")
    check(not grads1 and worst["rel_l2"] <= MESH_GRAD_REL_L2,
          f"mesh train: grad {worst['name']} rel L2 {worst['rel_l2']} "
          f"(leaves not compared: {len(grads1)})")
    check(bytes1 == want1 and all(b == want2 for b in bytes2),
          f"mesh train: state bytes a position 1x1 {bytes1} (dry-run "
          f"{want1}), 2x2 {bytes2} (dry-run {want2})")
    b, s = MESH_TRAIN_SHAPE
    print(f"mesh train ({card}): {cfg.name} at {cfg.n_layers} layers, "
          f"{n_params} float32 masters from seed 0, ZeRO-3 (bf16 gathers), "
          f"{b} x {s}, remat; two steps on each mesh, the first with the "
          f"grads read out (1x1: to the host; 2x2: held to them), the "
          f"second timed alone: 1x1 {ms1:.2f} ms ({ck1:.2f} with the "
          f"read-out; peak {peak1:.2f} GB, state {bytes1} bytes, dry-run "
          f"{want1}); 2x2 of four cuda:0 positions {ms2:.2f} ms ({ck2:.2f}; "
          f"peak {peak2:.2f} GB, state a position {bytes2[0]} bytes = "
          f"{bytes2[0] / 1e9:.4f} GB, dry-run {want2}); first step loss "
          f"{la:.6f} vs {lb:.6f} (rel {abs(la - lb) / lb:.3e}, tolerance "
          f"{MESH_LOSS_RTOL}), grad norm {ga:.5f} vs {gb:.5f} (rel "
          f"{abs(ga - gb) / gb:.3e}, tolerance {MESH_GNORM_RTOL}); worst "
          f"leaf grad rel L2 {worst['rel_l2']:.3e} ({worst['name']}, "
          f"tolerance {MESH_GRAD_REL_L2}); {pieces} replicated pieces "
          f"bitwise equal on their positions after each step; no launch of "
          f"a kernel of ours", flush=True)

    # -- (b) the CLI on a 2x2 mesh of the card
    ck = ROOT / "build" / "mesh_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    t0 = time.perf_counter()
    rc = train_main(MESH_CLI + ["--ckpt-dir", str(ck)])
    cli_s = time.perf_counter() - t0
    losses = [json.loads((ck / f"step_{i:08d}" / "manifest.json")
                         .read_text())["extra"]["loss"] for i in (1, 2, 3)]
    shutil.rmtree(ck, ignore_errors=True)
    check(rc == 0 and all(math.isfinite(x) for x in losses),
          f"mesh train CLI: exit {rc}, losses {losses}")
    print(f"mesh train CLI ({card}): {' '.join(MESH_CLI)}: exit {rc} in "
          f"{cli_s:.2f} s, losses {losses}", flush=True)

    # -- (c) GPipe over four cuda:0 positions against the sequential model
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        st, m_, bb, d = (PIPE[k] for k in ("stages", "microbatches",
                                           "batch", "dim"))
        g = torch.Generator(device="cuda").manual_seed(0)
        w = torch.randn((st, d, d), generator=g, device="cuda") / d ** 0.5
        xs = torch.randn((m_, bb, d), generator=g, device="cuda")
        mesh = make_mesh((st,), ("stage",), ["cuda:0"] * st)

        def stage_fn(wi, x):
            return torch.tanh(x @ wi)

        wp = w.clone().requires_grad_(True)
        (out, pipe_ms), _ = _counted(lambda: _sync_ms(
            lambda: pipeline_apply(mesh, "stage", stage_fn, wp, xs)))
        (out ** 2).sum().backward()
        ws = w.clone().requires_grad_(True)
        ref = xs
        for i in range(st):
            ref = torch.tanh(ref @ ws[i])
        (ref ** 2).sum().backward()
        out_err = float((out - ref).detach().abs().max())
        grad_err = float((wp.grad - ws.grad).abs().max())
        check(out_err <= PIPE_OUT_TOL and grad_err <= PIPE_GRAD_TOL,
              f"pipeline: outputs {out_err}, grads {grad_err} apart")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"pipeline ({card}): S {st}, M {m_}, B {bb}, D {d} on four cuda:0 "
          f"positions, TF32 off: outputs within {out_err:.3e} (tolerance "
          f"{PIPE_OUT_TOL}), grads within {grad_err:.3e} ({PIPE_GRAD_TOL}) "
          f"of the sequential model; {pipe_ms:.2f} ms forward; bubble "
          f"fraction {bubble_fraction(st, m_):.4f}", flush=True)

    # -- (d) int8 error-feedback compression: card vs CPU on the largest
    # leaf's grad (2x2 step), twice (the second with the first's feedback)
    gl = kept.pop("grad")
    ef_c, ef_g = torch.zeros_like(gl), torch.zeros_like(gl, device="cuda")
    for _ in range(2):
        dc, ef_c = compress_decompress(gl, ef_c)
        dg, ef_g = compress_decompress(gl.cuda(), ef_g)
        check(torch.equal(dc, dg.cpu()) and torch.equal(ef_c, ef_g.cpu()),
              f"compression: {largest} card vs CPU differ")
    del ef_c, ef_g, dc, dg
    # the cross-pod mean over a ("pod", "data", "model") mesh of 2 x 1 x 1
    # positions, the pods' grads the 2x2 and the 1x1 step's: card (two
    # cuda:0 positions) vs CPU (two cpu positions), two rounds
    t0 = time.perf_counter()
    pods = [gl, kept.pop("grad1")]
    meshes = {d: make_mesh((2, 1, 1), ("pod", "data", "model"), [d] * 2)
              for d in ("cpu", "cuda:0")}
    ef = {d: [torch.zeros_like(g, device=d) for g in pods] for d in meshes}
    for _ in range(2):
        out = {}
        for d, m in meshes.items():
            out[d], ef[d] = cross_pod_allreduce_compressed(
                [g.to(d) for g in pods], ef[d], m)
        check(all(torch.equal(a, b.cpu()) for a, b in
                  zip(out["cpu"] + ef["cpu"], out["cuda:0"] + ef["cuda:0"])),
              f"compression: the cross-pod mean of {largest} card vs CPU "
              f"differ")
    pod_s = time.perf_counter() - t0
    print(f"compression ({card}): compress_decompress on {largest}'s grad "
          f"{tuple(gl.shape)}, two rounds with error feedback: card and CPU "
          f"bit-equal (dequantized and feedback); "
          f"cross_pod_allreduce_compressed over 2 pods (the 2x2 and 1x1 "
          f"steps' grads of it), two rounds, card (cuda:0 positions) and CPU "
          f"bit-equal (each pod's mean and feedback), {pod_s:.2f} s",
          flush=True)
    del gl, pods, ef, out

    # -- (e) the dry-run over both production meshes, as the reference's
    # cells ("tp": the dense and VLM train cells count their model
    # groups' all-reduces) and under PERF_TRAIN_OVERRIDES (its ZeRO-3
    # train cells; on 2 x 16 x 16 their batch of 256 does not divide the
    # 512 dp positions: five errors, as the reference's)
    for variant, want in (("", dict(ok=64, skip=16, error=0)),
                          ("perf", dict(ok=59, skip=16, error=5))):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(None):
            rows = dryrun.main(["--all", "--variant", variant])
        dry_s = time.perf_counter() - t0
        count = {k: sum(r["status"] == k for r in rows) for k in want}
        check(count == want, f"dry-run --variant '{variant}': {count}, "
                             f"expected {want}")
        q = next(r for r in rows if r["arch"] == MESH_TRAIN_CONFIG
                 and r["shape"] == "train_4k" and r["mesh"] == "pod16x16")
        roof, sent = q["roofline"], q["collectives"]
        check(roof["collective_s"] is None
              and roof["dominant_over"] == ["compute_s", "memory_s"]
              and sent is not None and (sent["bytes"][
                  "activation all-reduce"] > 0) == (variant == ""),
              f"dry-run --variant '{variant}': {MESH_TRAIN_CONFIG} "
              f"train_4k's collectives {sent}, roofline {roof}")
        sent_txt = (f"{sent['total_bytes'] / 1e9:.3f} GB a position a step, "
                    f"{sent['bytes']['activation all-reduce'] / 1e9:.3f} GB "
                    f"of it the model groups' all-reduces (links between "
                    f"nodes not modeled: collective_s null)")
        print(f"dry-run: --all --variant '{variant}' over both production "
              f"meshes in {dry_s:.2f} s: {count['ok']} ok, {count['skip']} "
              f"skip, {count['error']} error; {MESH_TRAIN_CONFIG} train_4k "
              f"on 16 x 16: {q['memory']['total_bytes'] / 1e9:.3f} GB a "
              f"position, dominant {roof['dominant']} of compute and memory "
              f"only, collectives {sent_txt}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"mesh train phase: {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return dict(ms_1x1=ms1, ms_2x2=ms2, peak_gb=max(peak1, peak2))


# ----------------------------------------------------------------------
# Phase 18: tensor parallelism over "model" (qwen3-8b at full width)
# ----------------------------------------------------------------------
def _pinned_buffers(like: dict) -> dict:
    """An empty host tensor shaped as each of `like`'s (one dtype), all
    cut from one page-locked buffer, which the card reads and writes at
    the link's rate (one allocation: the pinned cache rounds each up to
    a power of two, and the next phase's buffer reuses it)."""
    import torch

    (dtype,) = {t.dtype for t in like.values()}
    flat = torch.empty(sum(t.numel() for t in like.values()), dtype=dtype,
                       pin_memory=True)
    out, at = {}, 0
    for n, t in like.items():
        out[n] = flat[at:at + t.numel()].view(t.shape)
        at += t.numel()
    return out


def _tp_step(cfg, shape, fsdp, named, on_grad, batch_shape,
             around=contextlib.nullcontext, opt_cfg=None, after=None):
    """Two "tp" steps of `cfg` on a ("data", "model") mesh of `shape`
    cuda:0 positions from the masters `named` (on the host) at
    `batch_shape` (batch, seq): the first calls `on_grad` with each
    reduced grad and runs inside `around()`, the second runs without
    either and is the step's time.  Returns (the first's metrics, its
    ms, the second's ms, (the second's peak GB, the first's with the
    state's upload), their launches, each position's state bytes, the
    dry-run's, the dry-run's bytes a position sends, the replicated
    pieces found bitwise equal after the first, the state's upload
    s, each position's {leaf: bytes} its loss read in the first).
    `opt_cfg` is the steps' AdamW (the config's default when None);
    `after(state, metrics, mesh)` runs after the first step."""
    import torch

    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.launch.steps import make_train_step, shard_params

    mesh = make_mesh(shape, ("data", "model"),
                     ["cuda:0"] * (shape[0] * shape[1]))
    kw = dict(remat=True, model_strategy="tp", fsdp=fsdp, opt_cfg=opt_cfg)
    checked = make_train_step(cfg, mesh, on_grad=on_grad, **kw)
    plain = make_train_step(cfg, mesh, **kw)
    torch.cuda.reset_peak_memory_stats()
    state, upload_ms = _sync_ms(
        lambda: shard_params(named, checked.policy, checked.opt_cfg))
    b, s = batch_shape
    batches = [batch_for(cfg, s, b, i, seed=0, device="cuda")
               for i in range(2)]
    with around():
        ((state, met), ms_checked), l1 = _counted(
            lambda: _sync_ms(lambda: checked.fn(state, batches[0])))
    if after is not None:
        after(state, met, mesh)
    held = dict(checked.held)
    met = {k: float(v) for k, v in met.items()}
    pieces = _replicas_equal(state)
    peak_checked = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ((state, _), ms), l2 = _counted(
        lambda: _sync_ms(lambda: plain.fn(state, batches[1])))
    peak = (torch.cuda.max_memory_allocated() / 1e9, peak_checked)
    nbytes = [state.position_bytes(f) for f in range(mesh.size)]
    del state
    cell = ShapeSpec("mesh_smoke", "train", s, b)
    want = dryrun.position_bytes(cfg, cell, mesh, fsdp=fsdp,
                                 opt_cfg=opt_cfg)["state_bytes"]
    sent = dryrun.train_collectives(cfg, mesh, microbatches=1, shape=cell,
                                    fsdp=fsdp, opt_cfg=opt_cfg)
    launches = {k: l1.get(k, 0) + l2.get(k, 0) for k in {**l1, **l2}}
    return (met, ms_checked, ms, peak, launches, nbytes, want, sent, pieces,
            upload_ms / 1e3, held)


def tp_train_phase(card: str) -> dict:
    """Phase 18: the "tp" step of qwen3-8b (full width, depth cut) on 1x1,
    1x4 and 2x2 (FSDP) meshes of the card, each against 1x1."""
    from repro_torch.configs import registry

    def describe(cfg):
        return (f"d {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads, "
                f"d_ff {cfg.d_ff}, vocab {cfg.vocab}")

    return _model_group_phase(
        card, "tp train", registry.get(TP_TRAIN_CONFIG), TP_TRAIN_LAYERS,
        TP_TRAIN_SHAPE, TP_TRAIN_MESHES, TP_LOSS_RTOL, TP_GRAD_REL_L2,
        describe)


def ep_train_phase(card: str) -> dict:
    """Phase 19: the "tp" step of deepseek-v2-lite-16b (full width, depth
    cut; experts and MLA heads over "model") on 1x1, 1x4 and 2x2 (FSDP)
    meshes of the card, each against 1x1, the aux loss and routes too."""
    from repro_torch.configs import registry

    def describe(cfg):
        mo, ml = cfg.moe, cfg.mla
        return (f"d {cfg.d_model}, {cfg.n_heads} MLA heads (kv_lora "
                f"{ml.kv_lora}, rope {ml.rope_dim}, nope {ml.nope_dim}, v "
                f"{ml.v_dim}), {mo.n_experts} experts top-{mo.top_k} of d_ff "
                f"{mo.d_ff_expert} and {mo.n_shared} shared, vocab "
                f"{cfg.vocab}, untied head")

    return _model_group_phase(
        card, "ep train", registry.get(EP_TRAIN_CONFIG), EP_TRAIN_LAYERS,
        EP_TRAIN_SHAPE, EP_TRAIN_MESHES, EP_LOSS_RTOL, EP_GRAD_REL_L2,
        describe)


def family_tp_phase(card: str) -> dict:
    """Phase 21: the "tp" step of zamba2-2.7b, whisper-large-v3 and
    xlstm-125m (full width, depth cut; Mamba2 heads, whisper's encoder,
    self- and cross-attention, mLSTM heads over "model") on 1x1, 1x4
    and 2x2 (FSDP) meshes of the card, each against 1x1; then the two
    LM examples at their smoke budgets."""
    from repro_torch.configs import registry

    def describe(cfg):
        if cfg.family == "hybrid":
            s, hy = cfg.ssm, cfg.hybrid
            return (f"d {cfg.d_model}, {s.expand * cfg.d_model // s.head_dim}"
                    f" SSM heads of {s.head_dim}, state {s.state}, shared "
                    f"block {hy.attn_heads} heads and d_ff {hy.shared_ff} "
                    f"every {hy.shared_attn_every} layers, vocab {cfg.vocab}")
        if cfg.family == "audio":
            return (f"d {cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, "
                    f"{cfg.encdec.enc_frames} stub frames a row, tied vocab "
                    f"{cfg.vocab}")
        return (f"d {cfg.d_model}, {cfg.n_heads} mLSTM heads, inner "
                f"{int(cfg.xlstm.proj_factor * cfg.d_model)}, vocab "
                f"{cfg.vocab}")

    t_phase = time.perf_counter()
    out = {}
    for name, layers, enc in FAMILY_TP:
        out[name] = _model_group_phase(
            card, "family tp", registry.get(name), layers, FAMILY_TP_SHAPE,
            FAMILY_TP_MESHES, TP_LOSS_RTOL, TP_GRAD_REL_L2, describe,
            enc_layers=enc, f32_floor=True)
    out["examples"] = lm_examples_check(card)
    print(f"family tp phase: {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return out


def _example(name: str, argv: list) -> tuple[str, dict]:
    """`examples/torch/<name>.py`'s `main(argv)` in process: (its stdout,
    the launches it made)."""
    import importlib.util
    import io

    path = ROOT / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, launches = _counted(lambda: mod.main(argv))
    return buf.getvalue(), launches


def lm_examples_check(card: str) -> dict:
    """`examples/torch/serve_acim.py` and `train_acim_lm.py` with
    `--smoke` on the card (their default device): the serving example's
    three completions of four tokens; the trainer's codesign pick
    (`nsga2_evolve`), its steps on the macro (`acim_matmul`) with finite
    losses and a checkpoint at its last step, and a run stopped after
    step 1 and resumed that ends on the same parameters, bit for bit."""
    import math
    import shutil

    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.models.lm import init_lm
    from repro_torch.train.acim_lm import build_cfg

    t0 = time.perf_counter()
    served, l_serve = _example("serve_acim", ["--smoke"])
    lines = served.splitlines()
    check(lines[0].startswith(LM_EXAMPLE_SERVED) and len(lines) == 4,
          f"serve_acim --smoke: {served!r}")
    serve_s = time.perf_counter() - t0
    shutil.rmtree(LM_EXAMPLE_CKPT, ignore_errors=True)
    whole, part = LM_EXAMPLE_CKPT / "whole", LM_EXAMPLE_CKPT / "part"
    t1 = time.perf_counter()
    trained, l_train = _example("train_acim_lm", ["--smoke", "--ckpt-dir",
                                                  str(whole)])
    train_s = time.perf_counter() - t1
    losses = [float(ln.split()[3]) for ln in trained.splitlines()
              if ln.startswith("step ")]
    check("codesign pick: MacroSpec(" in trained and len(losses) == 2
          and all(math.isfinite(x) for x in losses)
          and ckpt.latest_step(whole) == 3
          and l_train.get("acim_matmul", 0) > 0
          and l_train.get("nsga2_evolve", 0) > 0,
          f"train_acim_lm --smoke: {trained!r}, launches {l_train}")
    _example("train_acim_lm", ["--smoke", "--steps", "2", "--ckpt-dir",
                               str(part)])
    resumed, _ = _example("train_acim_lm", ["--smoke", "--ckpt-dir",
                                            str(part)])
    check(f"resumed from step 1 in {part}" in resumed,
          f"train_acim_lm resume: {resumed!r}")
    like = {"params": dict(init_lm(build_cfg(64, 1), seed=0, device="cpu")
                           .named_parameters())}
    a = ckpt.restore(whole, 3, like)["params"]
    b = ckpt.restore(part, ckpt.latest_step(part), like)["params"]
    check(all(torch.equal(a[n], b[n]) for n in a),
          "train_acim_lm: the resumed run's parameters differ from the "
          "whole run's")
    shutil.rmtree(LM_EXAMPLE_CKPT, ignore_errors=True)
    print(f"lm examples ({card}): serve_acim --smoke {serve_s:.2f} s "
          f"({lines[0]}; launches {l_serve}); train_acim_lm --smoke "
          f"{train_s:.2f} s (losses {losses}, launches {l_train}), stopped "
          f"after step 1 and resumed: the same parameters bit for bit; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return {"serve_s": serve_s, "train_s": train_s,
            "launches": {**l_serve, **l_train}}


@contextlib.contextmanager
def _mesh_routes(dp: int, m: int, layers: int, forced=None):
    """Record each forward call of `mlp.moe_route` in a mesh step's order
    (dp group after group, each its layers, each layer its m positions):
    its input and its own (top_i, slot, keep), on the host.  With
    `forced` (1x1's (top_i, slot, keep) of each layer over the
    microbatch), every call, remat's recompute in the backward too (a
    call is known by its position's router leaf), takes its dp group's
    slice of those, its gates the renormalized probabilities of the
    forced experts: the step teacher-forced to 1x1's routes, as phase
    11's `_routes` forces a decode."""
    import torch

    from repro_torch.models import mlp

    calls, where = [], {}
    route = mlp.moe_route

    def recorded(p, xg, mo):
        logits, probs, top_p, top_i, slot, keep = route(p, xg, mo)
        if id(p.router) not in where:          # the forward's call
            n = len(calls)
            where[id(p.router)] = (n // (layers * m), n // m % layers)
            calls.append((xg.detach().cpu(),)
                         + tuple(t.cpu() for t in (top_i, slot, keep)))
        if forced is not None:
            k, i = where[id(p.router)]
            g = top_i.shape[0]
            top_i, slot, keep = (t[k * g:(k + 1) * g].to(xg.device)
                                 for t in forced[i])
            top_p = torch.gather(probs, -1, top_i)
            top_p = top_p / top_p.sum(-1, keepdim=True)
        return logits, probs, top_p, top_i, slot, keep

    mlp.moe_route = recorded
    try:
        yield calls
    finally:
        mlp.moe_route = route


def _group_routes(what: str, calls: list, dp: int, m: int,
                  layers: int) -> list:
    """Each layer's own (top_i, slot, keep) over the microbatch (the dp
    groups' in turn) from one step's recorded calls (`_mesh_routes`),
    checking that a model group's positions routed the same input to the
    same slots, bitwise."""
    import torch

    check(len(calls) == dp * layers * m,
          f"{what}: {len(calls)} router calls, not {dp} x {layers} x {m}")
    at = [[calls[(k * layers + i) * m:(k * layers + i + 1) * m]
           for i in range(layers)] for k in range(dp)]
    for k in range(dp):
        for i in range(layers):
            check(all(torch.equal(a, b) for c in at[k][i][1:]
                      for a, b in zip(c, at[k][i][0])),
                  f"{what}: the positions of group {k} routed layer {i} "
                  f"apart")
    return [tuple(torch.cat([at[k][i][0][t] for k in range(dp)])
                  for t in (1, 2, 3)) for i in range(layers)]


def _layer_bytes(held: dict, cfg) -> int:
    """The bytes of the layers' leaves in `held` ({name: bytes}): the
    Mamba2 mixers, the mLSTMs, whisper's encoder and decoder blocks, or
    every `blocks.` leaf."""
    sub = {"hybrid": ".mamba.", "ssm": ".mlstm."}.get(cfg.family)
    blocks = ("enc_blocks.", "dec_blocks.") if cfg.family == "audio" \
        else ("blocks.",)
    return sum(b for n, b in held.items()
               if (sub in n if sub else n.startswith(blocks)))


def _zero_grad_leaf(cfg, name: str) -> str | None:
    """The query-bias leaf beside a key bias whose grad is 0 but for
    rounding (a self-attention's `bk` with no RoPE: the softmax drops
    it), else None."""
    if cfg.attn_bias and cfg.pos != "rope" and name.endswith(".attn.bk"):
        return name[:-len("bk")] + "bq"
    return None


def _model_group_phase(card: str, what: str, full, layers: int, shape,
                       meshes, loss_rtol: float, grad_rel_l2: float,
                       describe, enc_layers: int | None = None,
                       f32_floor: bool = False, opt_cfg=None,
                       after=None) -> dict:
    """One "tp" step of `full` at full width cut to `layers` (and an
    encoder-decoder's encoder to `enc_layers`) on each of `meshes` of
    cuda:0 positions ((shape, fsdp), 1x1 first), each from the same
    masters (drawn on the card, kept in pinned host memory), the first
    step of each with every reduced grad held to 1x1's (a key bias whose
    grad is 0 but for rounding, `_zero_grad_leaf`, to FAMILY_TP_ZERO_GRAD
    of its query bias's largest) and a second timed alone.  Each
    position's leaf bytes are the dry-run's reckoning (`held_bytes`),
    the largest against 1x1's printed.  With `f32_floor`, a float32 1x1
    step runs first, and a leaf past `grad_rel_l2` of 1x1's bf16 grad
    passes where its rel L2 to the float32 grad is at most 1x1's own
    plus `grad_rel_l2` (the bf16 step's error on it).  The MoE family's
    aux loss is held to 1x1's too, and its routes recorded in the
    checked step: a model group's positions alike, the claims that
    differ from 1x1's counted.  `opt_cfg` is the steps' AdamW;
    `after(mesh name, state, metrics, mesh, grads, masters)` runs after
    each mesh's first step with its reduced grads (on the card) and the
    masters (pinned host memory)."""
    import gc

    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(full, n_layers=layers)
    if enc_layers is not None:
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, n_enc_layers=enc_layers))
    moe = cfg.moe is not None
    card_named = dict(build_model(cfg).init(seed=0, draw_on="cuda")
                      .named_parameters())
    host = _pinned_buffers(card_named)
    for n, p in card_named.items():
        host[n].copy_(p.detach())
    del card_named
    torch.cuda.empty_cache()
    n_params = sum(p.numel() for p in host.values())
    b, s = shape
    # reckoned before the first run: masters and two float32 moments (12
    # B a parameter), the float32 grad sums (4 B) and, on 2x2 with FSDP,
    # the float32 gathers of its local pieces (4 B a dp group alive: one
    # at a time, the MoE family's two together)
    reckoned = (16 + 4 * (2 if moe else 1)) * n_params / 1e9
    cut = (f"{enc_layers} + {cfg.n_layers} of {full.encdec.n_enc_layers} "
           f"+ {full.n_layers}" if enc_layers is not None
           else f"{cfg.n_layers} of {full.n_layers}")
    print(f"{what} ({card}): {cfg.name} at full width ({describe(cfg)}), "
          f"cut to {cut} layers: {n_params} "
          f"float32 masters from seed 0; 2x2 FSDP peak reckoned "
          f"{reckoned:.1f} GB before activations; drawn and copied to "
          f"pinned host memory in {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    def rel_l2(g, h):
        return float(torch.linalg.vector_norm((g - h).float())
                     / torch.linalg.vector_norm(h.float()).clamp_min(1e-30))

    grads1: dict = {}
    pinned = _pinned_buffers(host)
    rows, first, routes1, held1 = [], None, None, None
    zero = {n: _zero_grad_leaf(cfg, n) for n in host}
    grads32, floor = ({}, {}) if f32_floor else (None, None)
    if f32_floor:
        import repro_torch.launch.steps as steps_mod
        from repro_torch.models import lm as lm_mod
        from repro_torch.models import whisper as whisper_mod

        pinned32 = _pinned_buffers(host)
        keep = (lm_mod.BACKBONE, whisper_mod.BACKBONE, steps_mod.COMPUTE_DTYPE)
        lm_mod.BACKBONE = whisper_mod.BACKBONE = torch.float32
        steps_mod.COMPUTE_DTYPE = torch.float32
        try:
            met32, _, ms32, peak32, *_ = _tp_step(
                cfg, (1, 1), None, host,
                lambda n, g: grads32.update({n: pinned32[n].copy_(g)}), shape)
        finally:
            lm_mod.BACKBONE, whisper_mod.BACKBONE, steps_mod.COMPUTE_DTYPE = \
                keep
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{what} 1x1 float32 ({card}): backbone and products in "
              f"float32, step {ms32:.2f} ms, peak {peak32[0]:.2f} GB, loss "
              f"{float(met32['loss']):.6f}: the reference for the bf16 "
              f"steps' own error", flush=True)
    for mesh_shape, fsdp in meshes:
        worst = {"rel_l2": 0.0, "name": None, "n": 0, "zero": 0.0,
                 "floored": {}}
        tops: dict = {}

        def on_grad(name, g):
            tops[name] = float(g.abs().max())
            if after is not None:
                kept[name] = g
            if first is None:
                grads1[name] = pinned[name].copy_(g)
                if f32_floor and zero[name] is None:
                    floor[name] = rel_l2(g, grads32[name].to(g.device))
                return
            h = grads1[name].to(g.device)
            if zero[name] is not None:
                # checked once every leaf has landed
                worst["n"] += 1
                return
            rel = rel_l2(g, h)
            if f32_floor and rel > grad_rel_l2:
                # past phase 18's bound: held to the float32 grad, at the
                # bf16 1x1 step's own error on it plus the bound
                to32 = rel_l2(g, grads32[name].to(g.device))
                check(to32 <= floor[name] + grad_rel_l2,
                      f"{what} {mesh_shape}: grad {name} rel L2 {rel} to "
                      f"1x1's bf16, "
                      f"{to32} to the float32 step's (1x1's bf16 "
                      f"{floor[name]}, tolerance + {grad_rel_l2})")
                worst["floored"][name] = (rel, to32, floor[name])
                worst["n"] += 1
                return
            worst["n"] += 1
            if rel >= worst["rel_l2"]:
                worst.update(rel_l2=rel, name=name)

        name = f"{mesh_shape[0]}x{mesh_shape[1]}" + ("-fsdp" if fsdp else "")
        calls = []

        @contextlib.contextmanager
        def around():
            if not moe:
                yield
                return
            with _mesh_routes(*mesh_shape, cfg.n_layers, routes1) as rec:
                yield
            calls.extend(rec)

        t_mesh = time.perf_counter()
        kept: dict = {}
        hook = None if after is None else (
            lambda st, mt, ms_, name=name: after(name, st, mt, ms_, kept, host))
        met, ck, ms, peak, launches, nbytes, want, sent, pieces, up, held = \
            _tp_step(cfg, mesh_shape, fsdp, host, on_grad, shape, around,
                     opt_cfg=opt_cfg, after=hook)
        kept.clear()
        gc.collect()
        torch.cuda.empty_cache()
        for n, q in zero.items():
            if q is not None:
                worst["zero"] = max(worst["zero"], tops[n] / tops[q])
        check(worst["zero"] <= FAMILY_TP_ZERO_GRAD,
              f"{what} {name}: a key bias's grad reached {worst['zero']} of "
              f"its query bias's (tolerance {FAMILY_TP_ZERO_GRAD})")
        mesh = make_mesh(mesh_shape, ("data", "model"),
                         ["cuda:0"] * (mesh_shape[0] * mesh_shape[1]))
        for f in range(mesh.size):
            check(held[f] == dryrun.held_bytes(cfg, mesh, position=f,
                                               fsdp=fsdp),
                  f"{what} {name}: position {f}'s leaf bytes are not the "
                  f"dry-run's")
        held1 = held1 or held[0]
        big = max(range(mesh.size), key=lambda f: sum(held[f].values()))
        check(not launches,
              f"{what} {name}: the steps launched kernels of ours "
              f"{launches}")
        check(all(n == want for n in nbytes),
              f"{what} {name}: state bytes a position {nbytes}, dry-run "
              f"{want}")
        check(mesh_shape == (1, 1) or pieces > 0,
              f"{what} {name}: no replicated piece to compare")
        line = (f"{what} {name} ({card}): {b} x {s}, step {ms:.2f} ms "
                f"({ck:.2f} with the grads read out), peak {peak[0]:.2f} "
                f"GB ({peak[1]:.2f} with the read-out), "
                f"state a position {nbytes[0]} bytes = {nbytes[0] / 1e9:.4f} "
                f"GB (dry-run {want}), leaves its loss reads: position "
                f"{big}'s {sum(held[big].values())} bytes, "
                f"{sum(held[big].values()) / sum(held1.values()):.4f} of "
                f"1x1's, its layers' {_layer_bytes(held[big], cfg)} "
                f"({_layer_bytes(held[big], cfg) / _layer_bytes(held1, cfg):.4f}"
                f" of 1x1's), each position's the dry-run's; dry-run sends "
                f"{sent['total_bytes'] / 1e9:.4f} GB a position a step "
                f"({sent['bytes']['activation all-reduce'] / 1e9:.4f} GB "
                f"activations' all-reduces")
        other = {k: v for k, v in sent["bytes"].items()
                 if k.startswith("activation ") and v
                 and k != "activation all-reduce"}
        if other:
            line += ", " + ", ".join(f"{v / 1e9:.4f} GB {k[11:]}"
                                     for k, v in other.items())
        if moe:
            routes = _group_routes(f"{what} {name}", calls, *mesh_shape,
                                   cfg.n_layers)
            line += (f", {sent['bytes']['router all-reduce']:.0f} bytes of "
                     f"router statistics")
        line += (f"); loss {met['loss']:.6f}, grad norm "
                 f"{met['grad_norm']:.5f}")
        if moe:
            line += f", aux_loss {met['aux_loss']:.6f}"
        if first is None:
            first, routes1 = met, routes if moe else None
        else:
            la, lb = met["loss"], first["loss"]
            check(abs(la - lb) <= loss_rtol * abs(lb),
                  f"{what} {name}: loss {la} vs 1x1 {lb}")
            check(worst["n"] == len(grads1)
                  and worst["rel_l2"] <= grad_rel_l2,
                  f"{what} {name}: grad {worst['name']} rel L2 "
                  f"{worst['rel_l2']} ({worst['n']} of {len(grads1)} leaves "
                  f"compared)")
            line += (f" vs 1x1 {lb:.6f} (rel {abs(la - lb) / lb:.3e}, "
                     f"tolerance {loss_rtol}), grad norm rel "
                     f"{abs(met['grad_norm'] - first['grad_norm']) / first['grad_norm']:.3e}; "
                     f"worst leaf grad rel L2 {worst['rel_l2']:.3e} "
                     f"({worst['name']}, tolerance {grad_rel_l2}); "
                     f"{pieces} replicated pieces bitwise equal")
            if worst["floored"]:
                n_f, (rel, to32, fl) = max(worst["floored"].items(),
                                           key=lambda kv: kv[1][1] - kv[1][2])
                line += (f"; {len(worst['floored'])} leaves past it held to "
                         f"the float32 step at 1x1's bf16 error + "
                         f"{grad_rel_l2} "
                         f"({sorted(worst['floored'])}; closest {n_f}: rel "
                         f"L2 {rel:.3e} to 1x1, {to32:.3e} to float32, 1x1's "
                         f"{fl:.3e})")
            if moe:
                xa, xb = met["aux_loss"], first["aux_loss"]
                check(abs(xa - xb) <= loss_rtol * abs(xb),
                      f"{what} {name}: aux_loss {xa} vs 1x1 {xb}")
                flips = sum(int((a[0] != c[0]).sum())
                            for a, c in zip(routes, routes1))
                claims = sum(a[0].numel() for a in routes)
                line += (f"; aux_loss rel {abs(xa - xb) / xb:.3e} "
                         f"(tolerance {loss_rtol}); {flips} of {claims} "
                         f"(token, k) claims of its own on another expert "
                         f"than 1x1's, the checked step teacher-forced to "
                         f"1x1's; a model group's positions routed alike")
        if any(zero.values()):
            line += (f"; key biases' largest grad at most "
                     f"{worst['zero']:.3e} of their query biases' "
                     f"(tolerance {FAMILY_TP_ZERO_GRAD})")
        print(line + f"; no launch of a kernel of ours; this mesh "
              f"{time.perf_counter() - t_mesh:.2f} s, the state's upload "
              f"{up:.2f} s", flush=True)
        rows.append(dict(mesh=name, ms=ms, peak_gb=peak[0],
                         state=nbytes[0], held=sum(held[big].values()),
                         layers_held=_layer_bytes(held[big], cfg)))
    del host, grads1
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{what} phase: {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return {r["mesh"]: r for r in rows}


# ----------------------------------------------------------------------
# Phase 20: the front door (the explorer's public API and the operator
# CLI)
# ----------------------------------------------------------------------
def _shim(fn, *args, **kw):
    """Call a deprecated explorer shim; it must warn exactly once with
    `repro_torch` in the text."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    want = f"repro_torch.core.explorer.{fn.__name__} is deprecated"
    hits = [w for w in caught if issubclass(w.category, DeprecationWarning)
            and str(w.message).startswith(want)]
    check(len(hits) == 1, f"front door: {fn.__name__} warned "
                          f"{[str(w.message) for w in caught]}")
    return out


def _exhaustive_front(size: int) -> set:
    """(h, l, b_adc) of the exhaustive `full_design_space` front."""
    from repro_torch.core import explorer, pareto

    genes, objs = explorer.full_design_space(size)
    g = genes[pareto.non_dominated_mask(objs)].tolist()
    return {(1 << h, 1 << l, b) for h, l, b in g}


def _front_keys(res) -> set:
    return {(s.h, s.l, s.b_adc) for s in res.specs}


def _holds_front(keys: set, size: int, what: str) -> None:
    """As `TestNSGA2.test_recovers_true_front_16kb`: inside the exhaustive
    front and covering at least 60 % of it."""
    true = _exhaustive_front(size)
    check(keys <= true, f"front door: {what} has points off the exhaustive "
                        f"front: {keys - true}")
    check(len(keys) >= 0.6 * len(true), f"front door: {what} covers "
                                        f"{len(keys)} of {len(true)}")


def _ctl_run(ctl, argv) -> str:
    """`repro_torch_ctl.main(argv)` in process: exit 0, its stdout."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ctl.main(argv)
    check(rc == 0, f"front door: repro_torch_ctl {argv[0]} exited {rc}:\n"
                   f"{buf.getvalue()}")
    return buf.getvalue()


def front_door_phase(card: str) -> dict:
    """The explorer's deprecated shims, `nsga2.run` and the operator CLI's
    `drain` / `gantt` / `metrics` / `cache stats` on the card, through the
    calls a user makes.  Returns the phase's launches of nsga2_evolve and
    route_slots."""
    import importlib.util
    import shutil
    import tempfile

    import torch

    from repro_torch import api
    from repro_torch.api import ArtifactCache, DesignSession
    from repro_torch.core import explorer, nsga2
    from repro_torch.kernels import LAUNCHES

    def launched(name: str, what: str, n: int | None = None) -> None:
        got = LAUNCHES.get(name, 0)
        check(got == n if n is not None else got > 0,
              f"front door: {what}: {name} launched {got} times "
              f"({dict(LAUNCHES)})")

    t_phase = time.perf_counter()
    golden = {tuple(p_["key"]): p_["row"] for p_ in golden_points()}
    total = {"nsga2_evolve": 0, "route_slots": 0}

    def tally():
        for k in total:
            total[k] += LAUNCHES.get(k, 0)

    # (a) explore(16384) at the default budget from a fresh default session
    api._DEFAULT_SESSION = None
    LAUNCHES.clear()
    t0 = time.perf_counter()
    front = _shim(explorer.explore, 16384)
    torch.cuda.synchronize()
    explore_s = time.perf_counter() - t0
    _holds_front(_front_keys(front), 16384, "explore(16384)")
    launched("nsga2_evolve", "explore", 1)
    tally()
    print(f"front door explore(16384): {len(front)} points, the exhaustive "
          f"front's {len(_exhaustive_front(16384))}; {explore_s:.3f} s; "
          f"launches {dict(LAUNCHES)}", flush=True)

    # (b) explore_sizes: one coalesced dispatch, the fronts of three
    # explore calls (each its own dispatch on a fresh default session)
    api._DEFAULT_SESSION = None
    LAUNCHES.clear()
    t0 = time.perf_counter()
    swept = _shim(explorer.explore_sizes, FRONT_DOOR_SIZES)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    stats = api.default_session().stats
    check(stats["explorer_dispatches"] == 1,
          f"front door: explore_sizes took {stats['explorer_dispatches']} "
          f"dispatches")
    launched("nsga2_evolve", "explore_sizes", 1)
    tally()
    api._DEFAULT_SESSION = None
    LAUNCHES.clear()
    for size in FRONT_DOOR_SIZES:
        one = _shim(explorer.explore, size)
        check(one.specs == swept[size].specs,
              f"front door: explore_sizes' {size} front differs from "
              f"explore's")
        _holds_front(_front_keys(one), size, f"explore({size})")
    check(swept[16384].specs == front.specs,
          "front door: the 16384 front differs between sessions")
    launched("nsga2_evolve", "three explore calls", len(FRONT_DOOR_SIZES))
    tally()
    sizes = [len(swept[s]) for s in FRONT_DOOR_SIZES]
    print(f"front door explore_sizes{FRONT_DOOR_SIZES}: one dispatch in "
          f"{sweep_s:.3f} s; fronts of {sizes} points, equal to three "
          f"explore calls'", flush=True)

    # (c) distill_and_layout: the survivors' layout rows are golden rows
    LAUNCHES.clear()
    t0 = time.perf_counter()
    distilled, layouts = _shim(explorer.distill_and_layout, 16384,
                               **FRONT_DOOR_DISTILL)
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    check(len(distilled) > 0 and distilled.specs
          == front.filter(**FRONT_DOOR_DISTILL).specs,
          "front door: distill_and_layout's survivors differ from the "
          "filtered front")
    rows = layouts.metrics_rows()
    check(len(rows) == len(distilled), "front door: missing layout rows")
    for spec, row in zip(distilled.specs, rows):
        key = (spec.h, spec.l, spec.b_adc)
        want = golden[key]
        check(row.keys() == want.keys(), f"front door: row keys of {key}")
        bad = [k for k in want if not _close(row[k], want[k])]
        check(not bad, f"front door: row {key} differs from golden in {bad}")
    launched("route_slots", "distill_and_layout")
    tally()
    print(f"front door distill_and_layout(16384, {FRONT_DOOR_DISTILL}): "
          f"{len(distilled)} survivors, rows equal to golden; "
          f"{distill_s:.3f} s; launches {dict(LAUNCHES)}", flush=True)

    # (d) nsga2.run: a feasible population holding the exhaustive front
    LAUNCHES.clear()
    t0 = time.perf_counter()
    cfg = nsga2.NSGA2Config(16384)
    pop = nsga2.run(cfg, seed=0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check(tuple(pop.genes.shape) == (cfg.pop_size, 3)
          and float(nsga2.constraint_violation(pop.genes, cfg).max()) == 0,
          "front door: nsga2.run's population is infeasible")
    res = explorer.pareto_result_from_population(
        16384, pop.genes.cpu().numpy(), pop.objs.cpu().numpy())
    _holds_front(_front_keys(res), 16384, "nsga2.run")
    launched("nsga2_evolve", "nsga2.run", 1)
    tally()
    print(f"front door nsga2.run(NSGA2Config(16384), seed=0): feasible, "
          f"front of {len(res)} points; {run_s:.3f} s", flush=True)

    # (e) the operator CLI: drain phase 6's first tickets, then read back
    # the trace, the metrics and the cache it wrote
    path = ROOT / "tools" / "repro_torch_ctl.py"
    spec = importlib.util.spec_from_file_location("repro_torch_ctl", path)
    ctl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ctl)
    reqs = service_requests()[:FRONT_DOOR_TICKETS]
    root = Path(tempfile.mkdtemp(prefix="front_door_", dir=ROOT / "build"))
    try:
        req_file, tel, cache = root / "requests.json", root / "tel", \
            root / "cache"
        req_file.write_text(json.dumps(
            {"requests": [r.to_dict() for r in reqs]}))
        LAUNCHES.clear()
        t0 = time.perf_counter()
        drained = _ctl_run(ctl, ["drain", str(req_file), "--out-dir",
                                 str(tel), "--cache-dir", str(cache),
                                 "--max-coalesce", str(len(reqs))])
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        check(drained.startswith(f"drained {len(reqs)}/{len(reqs)} ok"),
              f"front door: drain: {drained!r}")
        launched("nsga2_evolve", "drain")
        launched("route_slots", "drain")
        tally()
        seq = DesignSession().run_many(reqs)
        landed = ArtifactCache(cache)
        for r in reqs:
            art = landed.get(r)
            check(art is not None and art.ok
                  and art.summary() == seq[r].summary(),
                  f"front door: drained {r.array_size} seed {r.seed} "
                  f"differs from run_many")
        totals = _ctl_run(ctl, ["gantt", "--stage-totals",
                                str(tel / "service_trace.json")])
        stages = {ln.split()[0]: float(ln.split()[1].rstrip("s"))
                  for ln in totals.splitlines()}
        check(all(stages.get(k, 0.0) > 0 for k in
                  ("explore", "distill", "layout", "finalize")),
              f"front door: stage totals {stages}")
        metrics = _ctl_run(ctl, ["metrics", str(tel / "service_metrics.json")])
        check(f"histogram design_ticket_latency_seconds: count={len(reqs)} "
              in metrics, f"front door: metrics:\n{metrics}")
        entries = _ctl_run(ctl, ["cache", str(cache), "stats"])
        distinct = len({r.sha() for r in reqs})
        check(entries.startswith(f"{cache}: {distinct} entries"),
              f"front door: cache stats {entries!r}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"front door drain ({card}): {drained.strip()}; {drain_s:.3f} s; "
          f"equal to run_many; stage totals s "
          f"{ {k: round(v, 4) for k, v in stages.items()} }; "
          f"{entries.strip()}", flush=True)

    wall = time.perf_counter() - t_phase
    print(f"front door phase wall ({card}): {wall:.2f} s; launches "
          f"{total}", flush=True)
    check(wall <= FRONT_DOOR_LIMIT_S,
          f"front door: phase took {wall:.2f} s, past {FRONT_DOOR_LIMIT_S} s")
    return total


# ----------------------------------------------------------------------
# Phase 22: the paper's result drivers, and int8 moments split on their
# last dimension
# ----------------------------------------------------------------------
def _paper_row_diff(got: dict, want: dict) -> list:
    """Keys where a driver's row differs from golden's: integers and
    booleans exactly, floats beyond PAPER_RTOL."""
    bad = [k for k in set(got) ^ set(want)]
    for k in set(got) & set(want):
        a, b = got[k], want[k]
        if isinstance(b, float):
            if not abs(a - b) <= PAPER_RTOL * abs(b):
                bad.append(k)
        elif a != b or type(a) is not type(b):
            bad.append(k)
    return sorted(bad)


def _golden_front(golden: dict, size: int) -> set:
    return {(r["h"], r["l"], r["b_adc"]) for r in golden["fronts"][str(size)]}


def _nets(specs) -> int:
    """The nets of two or more pins the sequential flow routes for
    `specs`: one `wavefront` launch each."""
    from repro_torch.eda import flow
    from repro_torch.eda.placer import place

    return sum(1 for s in specs
               for _, pins in flow._top_level_nets(s, place(s))
               if len(pins) >= 2)


def paper_drivers_check(card: str) -> dict:
    """(a) Each paper driver's `run()` on the card at its own budget,
    held to the golden file; returns {kernel: launches on the drivers'
    path}."""
    import torch

    from repro_torch.api import DesignSession
    from repro_torch.core import acim_numerics as an
    from repro_torch.core import estimator
    from repro_torch.core.acim_spec import MacroSpec
    from repro_torch.kernels.acim_matmul.ops import acim_matmul
    from repro_torch.launch import dryrun
    from repro_torch.paper import (fig8_layouts, fig9_design_space,
                                   fig10_sota, roofline, snr_mc, table2_flow)

    golden = json.loads(PAPER_GOLDEN.read_text())
    total: dict = {}
    seconds: dict = {}

    def drive(what, fn):
        t0 = time.perf_counter()
        out, n = _counted(fn)
        seconds[what] = time.perf_counter() - t0
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        return out, n

    # Fig. 8: the sequential flow of three 16 kb specs
    rows, n8 = drive("fig8", fig8_layouts.run)
    specs = [spec for spec, _, _ in fig8_layouts.PAPER.values()]
    nets = _nets(specs)
    check(n8 == {"wavefront": nets},
          f"paper fig8: launches {n8}, {nets} nets")
    for r, want in zip(rows, golden["fig8"]):
        got = {k: v for k, v in r.items() if k != "layout_seconds"}
        bad = _paper_row_diff(got, want)
        check(not bad, f"paper fig8 ({r['point']}): {bad} differ from golden")
    check(len(rows) == len(golden["fig8"]) == 3, "paper fig8: rows")
    print(f"paper fig8 ({card}): {len(rows)} rows equal to golden but the "
          f"clock; layout s {[round(r['layout_seconds'], 3) for r in rows]}; "
          f"{nets} wavefront launches (one a net); tops "
          f"{[round(r['tops'], 4) for r in rows]} vs paper "
          f"{[r['paper_tops'] for r in rows]}, estimator area "
          f"{[round(r['est_area'], 1) for r in rows]} vs paper "
          f"{[r['paper_area'] for r in rows]}", flush=True)

    # Fig. 9 and Fig. 10: one dispatch each, on one session whose front
    # cache then gives the fronts back
    session = DesignSession()
    out9, n9 = drive("fig9", lambda: fig9_design_space.run(session=session))
    trends, _ = drive("fig9_trends", fig9_design_space.trend_checks)
    check(n9 == {"nsga2_evolve": 1}, f"paper fig9: launches {n9}")
    fronts = session.fronts_for(fig9_design_space.requests(PAPER_SIZES, 192,
                                                           60))
    cover = {}
    for req, res in fronts.items():
        keys = {(s.h, s.l, s.b_adc) for s in res.specs}
        true = _golden_front(golden, req.array_size)
        check(keys <= true, f"paper fig9 {req.array_size}: points off the "
                            f"exhaustive front {sorted(keys - true)}")
        check(len(keys) >= ISLAND_COVER * len(true),
              f"paper fig9 {req.array_size}: covers {len(keys)} of "
              f"{len(true)}")
        cover[req.array_size] = f"{len(keys)}/{len(true)}"
    check(trends == golden["fig9_trends"] and len(trends) == 8
          and all(trends.values()), f"paper fig9 trends {trends}")
    print(f"paper fig9 ({card}): fronts of {list(PAPER_SIZES)} at pop 192 x "
          f"60 in one nsga2_evolve launch, inside the exhaustive fronts, "
          f"covering {cover}; rows {out9}; the eight trends golden's, all "
          f"true", flush=True)

    out10, n10 = drive("fig10", lambda: fig10_sota.run(session=session))
    check(n10 == {"nsga2_evolve": 1}, f"paper fig10: launches {n10}")
    exh, ref = golden["fig10"]["exhaustive"], golden["fig10"]["reference_run"]
    for k in ("ee", "area"):
        lo, hi = out10[f"{k}_min"], out10[f"{k}_max"]
        check(lo >= exh[f"{k}_min"] * (1 - PAPER_RTOL)
              and hi <= exh[f"{k}_max"] * (1 + PAPER_RTOL),
              f"paper fig10: {k} span [{lo}, {hi}] outside the exhaustive "
              f"[{exh[f'{k}_min']}, {exh[f'{k}_max']}]")
    pooled = {(req.array_size, s.h, s.l, s.b_adc)
              for req, res in session.fronts_for(
                  fig10_sota.requests(PAPER_SIZES)).items()
              for s in res.specs}
    whole = {(size, *key) for size in PAPER_SIZES
             for key in _golden_front(golden, size)}
    flags = ("ee_span_covers_paper", "area_span_covers_paper",
             "sota_matched")
    if pooled == whole:
        check(all(out10[f] == exh[f] for f in flags),
              f"paper fig10: flags {[out10[f] for f in flags]} on the "
              f"exhaustive fronts, golden's {[exh[f] for f in flags]}")
    print(f"paper fig10 ({card}): one nsga2_evolve launch; {out10}; golden "
          f"(reference run) {[ref[f] for f in flags]}, golden (exhaustive) "
          f"{[exh[f] for f in flags]}; the pooled fronts "
          f"{'are' if pooled == whole else 'are not'} the exhaustive ones "
          f"({len(pooled)} of {len(whole)} points)", flush=True)

    # Table 2: its exploration, then two specs' sequential flow
    out2, n2 = drive("table2", lambda: table2_flow.run(session=session))
    front = session.run(table2_flow.REQUEST).pareto
    sel = front.filter(min_tops=0.5).specs[:2] or front.specs[:2]
    nets2 = _nets(sel)
    check(n2 == {"nsga2_evolve": 1, "wavefront": nets2},
          f"paper table2: launches {n2}, {nets2} nets")
    keys = {(s.h, s.l, s.b_adc) for s in front.specs}
    check(keys <= _golden_front(golden, 16384)
          and out2["pareto_points"] == len(front),
          f"paper table2: front off golden's 16 kb front "
          f"{sorted(keys - _golden_front(golden, 16384))}")
    print(f"paper table2 ({card}): explore_seconds "
          f"{out2['explore_seconds']}, layout_seconds_per_solution "
          f"{out2['layout_seconds_per_solution']} ({len(sel)} specs, "
          f"{nets2} wavefront launches), {out2['pareto_points']} Pareto "
          f"points inside golden's 16 kb front", flush=True)

    # the SNR Monte-Carlo: its five points and the B = 8 spec
    analytic = {(h, l, b): a for h, l, b, a in golden["snr_analytic"]}
    t0 = time.perf_counter()
    lines = []
    for spec in ([MacroSpec(h, 64, l, b) for h, l, b in snr_mc.POINTS]
                 + [MacroSpec(*PAPER_SNR_EXTRA)]):
        h, l, b = spec.h, spec.l, spec.b_adc
        ana = float(estimator.snr_total_db(h, l, b))
        noisy, nn = drive("snr_mc", lambda: snr_mc.mc_snr_db(spec))
        clean, nc = drive("snr_mc", lambda: snr_mc.mc_snr_db(spec,
                                                             noisy=False))
        check(not nn and nc == {"acim_matmul": 1, "acim_matmul_wgmma": 1},
              f"paper snr {spec}: launches {nn} noisy, {nc} noiseless")
        x, w = snr_mc.operands(spec, device="cuda")
        got, want = acim_matmul(x, w, spec), an.acim_matmul_ref(x, w, spec)
        check(torch.equal(got, want), f"paper snr {spec}: acim_matmul != "
                                      f"acim_matmul_ref on its operands")
        check(clean == snr_mc.snr_db(x @ w, want),
              f"paper snr {spec}: the noiseless SNR is not the plain "
              f"version's")
        if spec.w == 64:
            want_a = analytic[(h, l, b)]
            check(abs(ana - want_a) <= PAPER_RTOL * abs(want_a),
                  f"paper snr {spec}: analytic {ana} vs golden {want_a}")
            if (h, l, b) in snr_mc.POINTS[:4]:
                check(abs(noisy - ana) < PAPER_SNR_BAND,
                      f"paper snr {spec}: MC {noisy} vs analytic {ana}")
        else:
            check(noisy <= clean + PAPER_SNR_NOISE,
                  f"paper snr {spec}: noisy {noisy} above clean {clean}")
        lines.append(f"{h},{l},{b}: analytic {ana:.4f}, MC {noisy:.4f} "
                     f"(delta {noisy - ana:+.4f}), noiseless {clean:.4f}")
    seconds["snr_mc"] = time.perf_counter() - t0
    print(f"paper snr_mc ({card}): " + "; ".join(lines) + "; noiseless runs "
          f"one acim_matmul_wgmma launch a point, bit-equal to "
          f"acim_matmul_ref", flush=True)

    # the roofline over phase 17 (e)'s records
    records = [json.loads(f.read_text())
               for f in sorted(dryrun.RUNS.glob("*.json"))]
    t0 = time.perf_counter()
    table = [ln.split(",") for mesh in ("pod16x16", "pod2x16x16")
             for variant in ("", "perf")
             for ln in roofline.table(mesh, variant).splitlines()[1:]]
    with contextlib.redirect_stdout(None):
        roofline.main([])
    seconds["roofline"] = time.perf_counter() - t0
    want_rows = sorted((r["arch"], r["shape"], r["status"]) for r in records)
    check(records and sorted((t[0], t[1], t[2]) for t in table) == want_rows,
          f"paper roofline: {len(table)} rows for {len(records)} records")
    ok = sum(t[2] == "ok" for t in table)
    print(f"paper roofline ({card}): {len(table)} rows for the "
          f"{len(records)} dry-run records ({ok} ok)", flush=True)
    print(f"paper drivers ({card}): seconds "
          f"{ {k: round(v, 3) for k, v in seconds.items()} }, launches "
          f"{total}", flush=True)
    return total


def int8_moments_check(card: str, f32_rows: dict) -> dict:
    """(b) Phase 18's step with int8 moments on its meshes: each mesh's
    update bit-equal to one device's on its own grads, the moments held
    to 1x1's, the state bytes the dry-run's and printed against phase
    18's (`f32_rows`, float32 moments)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch.steps import _moment_spec, split_last
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import gather_shards

    quant = adamw.AdamWConfig(quantized_moments=True)
    ones: dict = {}
    found: dict = {}

    def gathered(state, name, k=None, sub=None):
        spec = state.specs[name]
        if k is None:
            return gather_shards([s["params"][name] for s in state.shards],
                                 state.mesh, spec, "cuda")
        return gather_shards([s["opt"][k][name][sub] for s in state.shards],
                             state.mesh, _moment_spec(spec, sub), "cuda")

    def after(what, state, met, mesh, grads, masters):
        split = split_last(mesh, state.specs, quant)
        scales_replicated = 0
        for name, groups in split.items():
            for group in groups:
                for k in ("m", "v"):
                    s0 = state.shards[group[0]]["opt"][k][name]["s"]
                    for f in group[1:]:
                        check(torch.equal(
                            s0, state.shards[f]["opt"][k][name]["s"]),
                            f"int8 {what}: {name}'s {k} scales differ "
                            f"across its column pieces")
                        scales_replicated += 1
        lr = float(met["lr"])
        q_off = q_far = q_total = 0
        s_rel = s_l2 = worst = 0.0
        s_at = None
        near = total = 0
        for name in state.specs:
            p = masters[name].to("cuda", copy=True)
            opt = adamw.init({name: p}, quant)
            adamw.update({name: grads[name]}, opt, {name: p}, quant,
                         norm=met["grad_norm"])
            got = gathered(state, name)
            check(torch.equal(got, p), f"int8 {what}: {name}'s master is not "
                                       f"one device's update on its grads")
            for k in ("m", "v"):
                for sub in ("q", "s"):
                    check(torch.equal(gathered(state, name, k, sub),
                                      opt[k][name][sub]),
                          f"int8 {what}: {name}'s {k} {sub} is not one "
                          f"device's update on its grads")
            if what == "1x1":
                # this update's own tensors (the state's are stepped
                # again), the masters in host memory
                ones[name] = (p.cpu(), {(k, sub): opt[k][name][sub]
                                    for k in ("m", "v")
                                    for sub in ("q", "s")})
                continue
            one, mom = ones[name]
            d = (got.float() - one.to("cuda").float()).abs()
            worst = max(worst, float(d.max()) / lr)
            near += int((d <= TRAIN_CHECK_NEAR * lr).sum())
            total += d.numel()
            for k in ("m", "v"):
                s, s1 = opt[k][name]["s"], mom[(k, "s")]
                s_rel = max(s_rel, float(((s - s1).abs() / s1.abs().clamp_min(
                    1e-30)).max()))
                rel = float(torch.linalg.vector_norm(s - s1)
                            / torch.linalg.vector_norm(s1).clamp_min(1e-30))
                if rel >= s_l2:
                    s_l2, s_at = rel, f"{name} {k}"
                dq = (opt[k][name]["q"].int() - mom[(k, "q")].int()).abs()
                q_off += int((dq > 0).sum())
                q_far += int((dq > 1).sum())
                q_total += dq.numel()
        grads.clear()          # the step's grads: not kept past this check
        line = (f"int8 moments {what} ({card}): {len(split)} leaves split on "
                f"their last dimension, each scale row equal on its column "
                f"pieces ({scales_replicated} compared); masters and int8 "
                f"moments bit-equal to one device's update of the whole "
                f"leaves on the mesh's own grads")
        if what != "1x1":
            share = 1 - q_far / q_total
            check(worst <= TRAIN_CHECK_LR
                  and near / total >= TRAIN_CHECK_SHARE,
                  f"int8 {what}: masters {worst:.4f} lr from 1x1's at most, "
                  f"{near / total:.5f} within {TRAIN_CHECK_NEAR} lr")
            check(s_l2 <= INT8_S_REL_L2 and share >= INT8_Q_SHARE,
                  f"int8 {what}: scales rel L2 {s_l2:.3e} from 1x1's "
                  f"({s_at}), q within one step on {share:.5f} of the "
                  f"entries")
            line += (f"; against 1x1: masters at most {worst:.4f} lr apart "
                     f"(tolerance {TRAIN_CHECK_LR}), {near / total:.5f} "
                     f"within {TRAIN_CHECK_NEAR} lr; scales rel L2 at most "
                     f"{s_l2:.3e} ({s_at}; tolerance {INT8_S_REL_L2}), a "
                     f"block's at most {s_rel:.3e} relative; q equal on "
                     f"{1 - q_off / q_total:.5f}, within one step on "
                     f"{share:.5f} (tolerance {INT8_Q_SHARE})")
            found[what] = dict(s_rel_l2=s_l2, s_rel=s_rel,
                               q_equal=1 - q_off / q_total,
                               q_within_1=share, lr_apart=worst)
        print(line, flush=True)

    def describe(cfg):
        return (f"d {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads, "
                f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, int8 moments")

    rows = _model_group_phase(
        card, "int8 moments", registry.get(TP_TRAIN_CONFIG),
        TP_TRAIN_LAYERS, TP_TRAIN_SHAPE, INT8_MESHES, TP_LOSS_RTOL,
        TP_GRAD_REL_L2, describe, opt_cfg=quant, after=after)
    ones.clear()
    for mesh, r in rows.items():
        f32 = f32_rows[mesh]["state"]
        print(f"int8 moments {mesh} ({card}): state a position "
              f"{r['state']} bytes = {r['state'] / 1e9:.4f} GB, "
              f"{r['state'] / f32:.4f} of phase 18's {f32} with float32 "
              f"moments", flush=True)
    return found


def paper_phase(card: str, f32_rows: dict) -> dict:
    """Phase 22: (a) the paper drivers, (b) int8 moments split on their
    last dimension; returns the drivers' launches."""
    t0 = time.perf_counter()
    launches = paper_drivers_check(card)
    t_a = time.perf_counter() - t0
    int8_moments_check(card, f32_rows)
    print(f"paper phase: {time.perf_counter() - t0:.2f} s ((a) {t_a:.2f} s)",
          flush=True)
    return launches


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.exists():
        fail("run chip_smoke.py from the root of a repository checkout")
    sys.path.insert(0, str(ROOT / "src"))

    card = build_phase()
    rows = kernel_phase()
    launches = path_phase()
    train = train_phase()
    launches.update({k: train[k] for k in ("acim_matmul_wgmma",
                                           "acim_matmul_mma",
                                           "acim_matmul_cuda_core")})
    flash_ms = next(r["ms"] for r in rows
                    if r["name"] == "flash_attention_wgmma")
    prefill_launches, params = prefill_phase(flash_ms)
    launches.update(prefill_launches)
    service = service_phase(card)
    engines = layout_engines_phase()
    print(f"chip_smoke wall before phases 8-9: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    mesh = mesh_phase(card)
    decode_phase(card, params)
    del params
    print(f"chip_smoke wall after phases 8-9: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    lm_train_phase(card)
    print(f"chip_smoke wall after phase 10: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    mla_row, moe_launches = moe_phase(card)
    rows.append(mla_row)
    launches.update(moe_launches)
    print(f"chip_smoke wall after phase 11: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    vlm_row, vlm_launches = vlm_phase(card)
    rows.append(vlm_row)
    launches.update(vlm_launches)
    print(f"chip_smoke wall after phase 12: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    hybrid_row, hybrid_launches = hybrid_phase(card)
    rows.append(hybrid_row)
    launches.update(hybrid_launches)
    print(f"chip_smoke wall after phase 13: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    dense_launches = dense_configs_phase(card)
    print(f"chip_smoke wall after phase 14: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    family_train_phase(card)
    print(f"chip_smoke wall after phase 15: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    audio_row, audio_launches = audio_ssm_phase(card)
    rows.append(audio_row)
    launches.update(audio_launches)
    print(f"chip_smoke wall after phase 16: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    mesh_train_phase(card)
    print(f"chip_smoke wall after phase 17: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    tp_rows = tp_train_phase(card)
    print(f"chip_smoke wall after phase 18: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    ep_train_phase(card)
    print(f"chip_smoke wall after phase 19: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    front_door = front_door_phase(card)
    print(f"chip_smoke wall after phase 20: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    family_tp_phase(card)
    print(f"chip_smoke wall after phase 21: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    paper = paper_phase(card, tp_rows)
    print(f"chip_smoke wall after phase 22: "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    conc, seq = engines["concurrent"], engines["flow"]
    # The wavefront kernel's paths: the concurrent engine (a launch a
    # round with BFS lanes) and the sequential flow (a launch a net).
    launches["wavefront"] = conc["launches"] + seq["launches"]
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["name"] in service:
            r["service_launches"] = service[r["name"]]
        if r["name"] in front_door:
            r["front_door_launches"] = front_door[r["name"]]
        if r["name"] in mesh["launches"]:
            r["mesh_launches"] = mesh["launches"][r["name"]]
        if r["name"] in paper:
            r.setdefault("launches_by_path", {})["paper_drivers"] = \
                paper[r["name"]]
        if r["name"] == "nds_rank":
            r.update({k: v for k, v in mesh.items() if k != "launches"})
        if r["name"] == "flash_attention_wgmma":
            # the (128, 128) instantiation's paths: each prefill at 1 x
            # 32768; the (64, 64) one's: whisper-large-v3's
            r["launches_by_path"] = {PREFILL_CONFIG: r["launches"],
                                     **dense_launches,
                                     AUDIO_CONFIG: audio_launches[AUDIO_INST]}
        if r["name"] == "wavefront":
            r.update(concurrent_launches=conc["launches"],
                     flow_launches=seq["launches"],
                     **{k: seq[k] for k in ("net_ms", "net_plain_ms",
                                            "net_bound_ms", "net_levels",
                                            "net_ms_per_level")})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # route_slots' whole-bucket time and bound (its row's own are on the
    # cut its plain version runs); nsga2_evolve's fronts peeled;
    # dominance_matrix's profiler device time and the launch floor;
    # acim_matmul's one-pass f32 bound, its bound with the mma kernel's
    # own ADC and that of one CUDA-core pipe, and its ADC-flip share; the
    # service phase's launches of nsga2_evolve and route_slots; the
    # (128, 128) flash instantiation's launches on each prefill path;
    # wavefront's BFS levels and ms a level, its launches by path and its
    # time and levels at the per-net shape; nds_rank's profiler device
    # time; the mesh phase's launches of nsga2_evolve and nds_rank, and
    # nds_rank at the migration shape; the MoE phase's all-to-all check
    # beside the
    # (192, 128) instantiation; the (256, 256) instantiation at prefix 0;
    # the 3xTF32 flash kernel's FFMA bound and its bf16 head-dim-32 case
    extra = ("n", "b", "by_n", "bucket_ms", "bucket_bound_ms", "fronts",
             "device_ms",
             "floor_ms", "floor_device_ms", "bound_f32_ms", "bound_adc3_ms",
             "bound_cuda_core_pipe_ms", "flip_share",
             "service_launches", "front_door_launches",
             "concurrent_launches", "flow_launches",
             "launches_by_path",
             "levels", "ms_per_level", "net_ms", "net_plain_ms",
             "net_bound_ms", "net_levels", "net_ms_per_level",
             "mesh_launches", "migration_shape", "migration_ms",
             "migration_device_ms", "migration_plain_ms",
             "migration_bound_ms", "migration_bound_by", "a2a_rel_l2",
             "a2a_ms", "prefix0_ms", "prefix0_bound_ms", "bound_ffma_ms",
             "bf16_32_ms", "bf16_32_bound_ms", "bf16_32_tf32_bound_ms",
             "bf16_32_library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys + extra if k in r}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
