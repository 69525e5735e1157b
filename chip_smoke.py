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
             and on 241 x 2178 and 122 x 1090, `trace_paths` on one slot
             of them.  `acim_matmul` has two routes, each held to the
             plain version at the trainer's FFN shapes, (1024, 768) @
             (768, 3072) and (1024, 3072) @ (3072, 768), with the codesign
             pick's (N, B) and with N = 128, B = 5: the wgmma route
             (tensor cores on an exact bf16 term split, split-K on the
             second shape) and the cuda_core route: bit-equal on +-1
             operands, and on mismatch-folded weights, with +-1 and with
             float activations, equal but for ADC flips (a whole number
             of deltas each) on at most 0.1 % of outputs; both timed on
             the trainer's operands, f32 and bf16 torch.matmul printed
             beside as a scale.  `dominance_matrix` is held to its plain
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
             the float32-P plain versions within rel L2 1e-2; f32 and bf16
             at head dims 16 and 32 run `flash_attention` (CUDA cores),
             held against `flash_attention_ref` and the naive one (f32
             within atol = rtol = 2e-5, bf16 within one output ulp plus
             2e-5).  Cases: (4, 4096, 16 heads, 2 KV heads, 128) in bf16
             and f32, with a prefix, S 4001, head dims 16-64.  At the
             prefill's shape, (1, 32768, 16, 2, 128) causal bf16, both
             kernels (each through its own wrapper) against their
             blockwise plain versions, then both and the library
             yardstick `scaled_dot_product_attention` timed in one
             call, in turns.
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
             Then the CUDA-core route's path: the same check with a
             macro of N 8 (MacroSpec(16, 64, 2, 3)), whose forward runs
             only `acim_matmul_cuda_core` launches, 2 per layer.
5. prefill — `make_prefill_step(qwen2.5-3b, prefill_32k)` at full width
             (36 layers, d 2048, vocab 151,936) with bf16 serving
             weights drawn from seed 0 (CPU generator), on synthetic tokens
             at batch 1 x 32768 (the shape's batch of 32 cut to 1: its
             logits alone are 9.96 GB a sequence): a warm-up prefill and
             a timed one, then batch 4 x 4096.  Logits must be finite and
             each prefill must launch `flash_attention_wgmma` 36 times
             (and no CUDA-core launch).  Then
             one full-width layer at S 4096: `attention_fwd_blockwise`
             against the dense `attention_fwd` (rel L2 2e-2: the dense
             path rounds scores and probabilities to bf16); and a
             2-layer full-width model at seq 512 with the same CPU-drawn
             weights on the card and on the CPU: last-position logits
             within rel L2 5e-2 (both backbones are bf16), argmax
             agreement printed.  Last, the CUDA-core route's path: the
             reduced qwen2.5 (head dim 16) prefill at 2 x 300 on the
             card, one CUDA-core launch per layer, logits within rel L2
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
             plain version and timed at that per-net shape (1, 122, 274).
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
             against plain, timed, with its bound; (c)
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
             float32 master parameters from seed 0, the serving weights of
             phases 5 and 9 freed first): (a) `make_train_step(remat=True)`
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
             CUDA-core launch.  (c) `ServeEngine` on the same weights,
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
12. report — one JSON line of per-kernel numbers (the `wavefront` row's
             launches are phase 7's, by path; `nsga2_evolve` and
             `nds_rank` carry phase 8's as `mesh_launches`, `nds_rank`
             its migration-shape time), the nvidia-smi line,
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

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the float32 /
# int32 CUDA-core rate, for the roofline bound of each kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# The dense bf16 tensor-core peak (same data sheet).  Attention's two
# products fit on tensor cores, so `flash_attention`'s bound uses this
# rate: a CUDA-core kernel must not read as near its bound.
PEAK_BF16_TC_FLOPS = 989.4e12
FLOAT_RTOL = 1e-6

# The trainer's full-width configuration (the reference example's
# "~125M-class" run) and the checks of phases 2 and 4.
TRAIN = dict(d_model=768, layers=12, seq=128, batch=8, lr=3e-3, steps=20)
ACIM_SHAPES = ((1024, 768, 3072), (1024, 3072, 768))
ACIM_FLIP_SHARE = 1e-3     # mismatch-folded weights: outputs an ADC flip
                           # may move (measured share printed)
CPU_CHECK_LAYERS = 2       # depth of the step-0 card-vs-CPU check
CPU_CHECK_RTOL = 1e-2

# A macro of the explorer's space whose chunk (N 8) is no whole k16 step:
# the trainer's forward then takes acim_matmul's CUDA-core route.
NARROW_MACRO_ARGS = (16, 64, 2, 3)

# The prefill phase: qwen2.5-3b at full width, prefill_32k cut to batch 1.
PREFILL_CONFIG = "qwen2.5-3b"
PREFILL_BATCH = 1
SMALL_PREFILL = (4, 4096)  # batch, seq: B > 1
FLASH_RTOL = 2e-5          # f32 atol = rtol; bf16: one output ulp + this
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
SMALL_ROUTE_SEQ = 300      # the reduced config's prefill (CUDA-core route)

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
# master parameters from seed 0).  (a) the launcher's defaults (--seq 256
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


def profiler_ms(fn, reps: int, kernel: str) -> float:
    """Mean device time of the kernels named `kernel` per call of `fn`
    over `reps` calls (after one warm-up), from torch.profiler: the
    device's own time, without the host's launch cost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    check(us > 0, f"profiler recorded no device time for {kernel}")
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


def kernel_phase() -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.core import pareto
    from repro_torch.eda.placer import geometry, layout_operands
    from repro_torch.eda.router import grid_shape
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
    rows.append(dict(
        name="nds_rank", route="cuda", source="src/repro_torch/csrc/pareto_dom.cu",
        replaces="src/repro/kernels/pareto_dom/kernel.py:112",
        max_abs_err=err, ms=cuda_ms(lambda: pd.nds_rank(f1), 200),
        plain_ms=cuda_ms(lambda: pareto.non_dominated_rank(f1), 20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    print(f"kernel nds_rank: equal to plain on (3, 512, 4) and (1, 2048, 4); "
          f"{rows[-1]['ms']:.4f} ms vs plain {rows[-1]['plain_ms']:.4f} ms "
          f"at (1, 512, 4)", flush=True)

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
    geom = geometry()
    from repro_torch.core.acim_spec import MacroSpec
    specs = [MacroSpec(p_["row"]["h"], p_["row"]["w"], p_["row"]["l"],
                       p_["row"]["b_adc"]) for p_ in golden_points()]
    grids = np.array([grid_shape(o.width, o.height, 64) for o in
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
    rows.append(dict(
        name="wavefront", route="cuda", source="src/repro_torch/csrc/maze_route.cu",
        replaces="src/repro/kernels/maze_route/kernel.py:71",
        max_abs_err=float((dist - want).abs().max()),
        ms=cuda_ms(lambda: mr.wavefront(occ, seed, grids_t), 20),
        plain_ms=cuda_ms(lambda: mr_ref.wavefront_distance_ref(
            occ, seed, grids_t), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    print(f"kernel wavefront: equal to plain on ({bsz}, {gh}, {gw}), "
          f"(1, 241, 2178) and (1, 122, 1090); {rows[-1]['ms']:.4f} ms vs plain "
          f"{rows[-1]['plain_ms']:.4f} ms", flush=True)

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


def acim_kernel_check(dev, rng) -> list[dict]:
    """Both acim_matmul routes against their plain version at the
    trainer's FFN shapes, with the codesign pick's (N, B) and with N 128,
    B 5: bit-equal on +-1 operands; whole ADC steps on at most
    ACIM_FLIP_SHARE of outputs on mismatch-folded weights with +-1 and
    with float activations in [-1, 1].  Timed on the trainer's operands
    (+-1 activations, mismatch-folded weights).  One row per route at the
    first shape and the pick; f32 and bf16 torch.matmul of the same
    shapes are printed as a scale (the product without the ADC)."""
    import torch

    from repro_torch.core.acim_numerics import NoiseParams
    from repro_torch.core.acim_spec import MacroSpec
    from repro_torch.kernels.acim_matmul import kernel as ak
    from repro_torch.kernels.acim_matmul import ops as am
    from repro_torch.kernels.acim_matmul import ref as am_ref
    from repro_torch.train import acim_lm

    torch.backends.cuda.matmul.allow_tf32 = False      # exact f32 products
    cfg = acim_lm.build_cfg(TRAIN["d_model"], TRAIN["layers"])
    pick = acim_lm.pick_macro(cfg).spec
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    run = {"wgmma": ak.acim_matmul_wgmma,
           "cuda_core": ak.acim_matmul_cuda_core}
    rows = {}
    for spec in (pick, MacroSpec(256, 64, 2, 5)):
        n, b = spec.n_caps, spec.b_adc
        delta = 2.0 * n / 2 ** b
        for m, k, c in ACIM_SHAPES:
            x = torch.tensor(rng.choice([-1.0, 1.0], (m, k)),
                             dtype=torch.float32, device=dev)
            w = torch.tensor(rng.choice([-1.0, 1.0], (k, c)),
                             dtype=torch.float32, device=dev)
            xf = torch.rand((m, k), device=dev) * 2 - 1
            wm = am.mismatch_weights(w, spec, torch.randn((k, c), device=dev),
                                     NoiseParams.from_cal())
            want = am_ref.acim_matmul_ref(x, w, n=n, b_adc=b)
            want_m = am_ref.acim_matmul_ref(x, wm, n=n, b_adc=b)
            want_f = am_ref.acim_matmul_ref(xf, wm, n=n, b_adc=b)
            plain_ms = cuda_ms(lambda: am_ref.acim_matmul_ref(
                x, wm, n=n, b_adc=b), 5)
            f32_ms = cuda_ms(lambda: torch.matmul(x, wm), 20)
            xb, wb = x.bfloat16(), wm.bfloat16()
            bf16_ms = cuda_ms(lambda: torch.matmul(xb, wb), 20)
            print(f"scale acim_matmul ({m}, {k}, {c}): the product without "
                  f"the ADC, not the same function (never called by the "
                  f"port): f32 torch.matmul {f32_ms:.4f} ms, bf16 "
                  f"torch.matmul {bf16_ms:.4f} ms", flush=True)
            nbytes = (m * k + k * c + m * c) * 4
            for route, fn in run.items():
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
                ms = cuda_ms(lambda: fn(x, wm, n, b), 20)
                b_f32, _ = bound(nbytes, 2 * m * k * c)
                if route == "wgmma":
                    passes = _term_passes(x, wm)
                    b_ms, b_by = bound(nbytes, passes * 2 * m * k * c,
                                       PEAK_BF16_TC_FLOPS)
                    extra = (f"bound {b_ms:.4f} ms ({b_by}: {passes} bf16 "
                             f"passes at the tensor-core peak; one f32 FFMA "
                             f"pass {b_f32:.4f} ms); splits "
                             f"{ak.split_k(m, c, k, n, sms)}")
                else:
                    b_ms, b_by = bound(nbytes, 2 * m * k * c)
                    extra = f"bound {b_ms:.4f} ms ({b_by}: f32 FFMA)"
                print(f"kernel acim_matmul_{route}: equal to plain on +-1 "
                      f"({m}, {k}, {c}), N={n}, B={b}; mismatch-folded: "
                      f"{share:.2e} (+-1 x) and {share_f:.2e} (float x) of "
                      f"outputs whole ADC steps apart; {ms:.4f} ms vs plain "
                      f"{plain_ms:.4f} ms, {extra}", flush=True)
                name = f"acim_matmul_{route}"
                if name not in rows:   # the main path's first shape and pick
                    rows[name] = dict(
                        name=name, route="cuda",
                        source=("src/repro_torch/csrc/acim_matmul_wgmma.cu"
                                if route == "wgmma" else
                                "src/repro_torch/csrc/acim_matmul.cu"),
                        replaces="src/repro/kernels/acim_matmul/kernel.py:60",
                        max_abs_err=float((got - want).abs().max()), ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None, bound_f32_ms=b_f32,
                        flip_share=max(share, share_f))
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
    P to bf16 but reach p in float32 by different summation orders and
    exp2s, so a p within float32 ulps of a bf16 rounding midpoint may round
    up on one and down on the other; one such flip moves its output row by
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
    CUDA-core kernel against `flash_attention_ref` (and the naive one),
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

    # the prefill's shape: both routes, called through their own wrappers
    b, s, h, kv, dh = PREFILL_BATCH, 32768, 16, 2, 128
    q, k, v = qkv(b, s, h, kv, dh, bf16)
    cc = fk.flash_attention_cuda_core(q, k, v)
    tcg = fk.flash_attention_wgmma(q, k, v)
    want = fa_ref.flash_attention_ref(q, k, v)
    want_tc = fa_ref.flash_attention_tc_ref(q, k, v)
    torch.cuda.synchronize()
    cc_err, cc_excess = _flash_excess(cc, want)
    check(cc_excess <= 0, f"flash_attention ({b}, {s}, {h}, {kv}, {dh}) bf16 "
                          f"(CUDA cores): max err {cc_err:.3e}, beyond one "
                          f"ulp + {FLASH_RTOL} by {cc_excess:.3e}")
    rel_tc, rel_f32p = _rel_l2(tcg, want_tc), _rel_l2(tcg, want)
    rel_cc, rel_tc_cc = _rel_l2(tcg, cc), _rel_l2(want_tc, want)
    del cc, want, want_tc
    # P at this shape would take 34 GB: the share check only
    tc = _tc_check(tcg, q, k, v, True, 0, dump=False)
    tc_err, tc_text = tc["err"], _tc_text(tc, 0)
    check(tc["ok"] and rel_f32p <= TC_F32P_REL_L2,
          f"flash_attention_wgmma ({b}, {s}, {h}, {kv}, {dh}): {tc_text}; "
          f"rel L2 {rel_f32p:.3e} vs the float32-P plain version")
    del tcg
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fns = {"cuda_core": (lambda: fk.flash_attention_cuda_core(q, k, v), 3),
           "wgmma": (lambda: fk.flash_attention_wgmma(q, k, v), 20),
           "sdpa": (lambda: F.scaled_dot_product_attention(
               qh, kh, vh, is_causal=True, enable_gqa=True), 20)}
    times = {n: [] for n in fns}
    for order in (("cuda_core", "wgmma", "sdpa"), ("sdpa", "wgmma",
                                                   "cuda_core")):
        for n in order:
            times[n].append(cuda_ms(*fns[n]))
    ms = {n: sum(t) / len(t) for n, t in times.items()}
    sdpa_out = fns["sdpa"][0]().transpose(1, 2)
    sdpa_err = float((sdpa_out.float() - fns["wgmma"][0]().float()).abs().max())
    del sdpa_out
    plain_ms = cuda_ms(lambda: fa_ref.flash_attention_ref(q, k, v), 1)
    tc_plain_ms = cuda_ms(lambda: fa_ref.flash_attention_tc_ref(q, k, v), 1)
    flops = 4 * dh * h * b * _visible_pairs(s, s, True, 0)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_TC_FLOPS)
    print(f"kernel flash_attention ({b}, {s}, {h}, {kv}, {dh}) bf16 causal, "
          f"one call in turns (ms each: {times}): bound {b_ms:.4f} ms "
          f"({b_by}: {flops:.3e} flops, {nbytes / 1e6:.1f} MB); SDPA "
          f"(library) {ms['sdpa']:.3f} ms", flush=True)
    for n, err, rels in (("cuda_core", cc_err, f"vs float32-P blockwise "
                          f"plain (within one ulp + {FLASH_RTOL})"),
                         ("wgmma", tc_err, f"vs tc plain ({tc_text}); rel L2 "
                          f"{rel_tc:.3e} vs tc plain, {rel_f32p:.3e} vs "
                          f"float32-P blockwise plain, {rel_cc:.3e} vs the "
                          f"CUDA-core kernel")):
        print(f"  {n}: {ms[n]:.3f} ms, {flops / ms[n] / 1e9:.1f} TFLOP/s, "
              f"{b_ms / ms[n]:.3f} of the bound, {ms[n] / ms['sdpa']:.2f}x "
              f"SDPA; max err {err:.3e} {rels}", flush=True)
    print(f"  plain versions: flash_attention_ref {plain_ms:.3f} ms, "
          f"flash_attention_tc_ref {tc_plain_ms:.3f} ms (rel L2 "
          f"{rel_tc_cc:.3e} apart); max |SDPA - wgmma| {sdpa_err:.3e}",
          flush=True)
    common = dict(replaces="src/repro/kernels/flash_attention/kernel.py:59",
                  bound_ms=b_ms, bound_by=b_by, library_ms=ms["sdpa"])
    return [dict(name="flash_attention", route="cuda",
                 source="src/repro_torch/csrc/flash_attention.cu",
                 max_abs_err=cc_err, ms=ms["cuda_core"], plain_ms=plain_ms,
                 **common),
            dict(name="flash_attention_wgmma", route="cuda",
                 source="src/repro_torch/csrc/flash_attention_wgmma.cu",
                 max_abs_err=tc_err, ms=ms["wgmma"], plain_ms=tc_plain_ms,
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

    # the CUDA-core route's path: a macro whose chunk is no whole k16 step
    # (N 8, the explorer's narrow macros), the same step-0 check
    from repro_torch.core.acim_spec import MacroSpec

    spec_n = MacroSpec(*NARROW_MACRO_ARGS)
    narrow = CIMConfig(spec_n)
    losses0 = []
    for dev in (model.emb.device, torch.device("cpu")):
        m_ = init_lm(cut, seed=0, device=dev)
        b_ = {k: v.to(dev) for k, v in batch.items()}
        LAUNCHES.clear()
        with torch.no_grad():
            losses0.append(float(acim_lm.loss_fn(m_, b_, cut, narrow)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            narrow_launches = dict(LAUNCHES)
    card, host = losses0
    rel = abs(card - host) / abs(host)
    n_cc = narrow_launches.get("acim_matmul_cuda_core", 0)
    check(n_cc == 2 * cut.n_layers
          and narrow_launches.get("acim_matmul_wgmma", 0) == 0,
          f"N {spec_n.n_caps} forward launches: {narrow_launches}")
    check(math.isfinite(card) and rel <= CPU_CHECK_RTOL,
          f"N {spec_n.n_caps} step-0 loss on the card {card} vs CPU "
          f"{host}: rel {rel:.2e}")
    print(f"train route check: {spec_n} (N={spec_n.n_caps}) at "
          f"{CPU_CHECK_LAYERS} layers: acim_matmul_cuda_core {n_cc} "
          f"launches; step-0 loss card vs CPU rel diff {rel:.2e} (rtol "
          f"{CPU_CHECK_RTOL})", flush=True)
    return {"acim_matmul_wgmma": launches["acim_matmul_wgmma"],
            "acim_matmul_cuda_core": n_cc,
            "nsga2_evolve": launches["nsga2_evolve"]}


# ----------------------------------------------------------------------
# Phase 5: long-context prefill of qwen2.5-3b at full width
# ----------------------------------------------------------------------
def _prefill(step, params, batch, cfg, what: str, tensor_cores: bool = True,
             keep: bool = False,
             inst: str | None = None) -> tuple[float, int, object]:
    """One prefill with the launch counts zeroed just before it and read
    just after: (seconds, flash_attention launches of either route, the
    logits if `keep` else None); the logits must be finite and of the
    batch's shape, and every layer must launch the route `tensor_cores`
    names, and, where `inst` names a tensor-core instantiation's count,
    that instantiation."""
    import torch

    from repro_torch.kernels import LAUNCHES

    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = step.fn(params, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n, n_tc = LAUNCHES["flash_attention"], LAUNCHES["flash_attention_wgmma"]
    b, s = batch["inputs"].shape
    check(tuple(logits.shape) == (b, s, cfg.vocab),
          f"prefill {what}: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()),
          f"prefill {what}: non-finite logits")
    check(n == cfg.n_layers and n_tc == (n if tensor_cores else 0),
          f"prefill {what}: flash_attention launched {n} times, "
          f"flash_attention_wgmma {n_tc}; want {cfg.n_layers} and "
          f"{cfg.n_layers if tensor_cores else 0}")
    check(inst is None or LAUNCHES[inst] == cfg.n_layers,
          f"prefill {what}: {inst} launched {LAUNCHES[inst]} times, want "
          f"{cfg.n_layers}")
    return dt, n, logits if keep else None


def prefill_phase(flash_ms: float) -> tuple[dict, object]:
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention as attn
    from repro_torch.models.common import apply_norm, causal_mask
    from repro_torch.models.lm import init_lm, lm_hidden, lm_logits

    dev = torch.device("cuda")
    cfg = registry.get(PREFILL_CONFIG)
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p_.numel() for p_ in params.parameters())
    n_bytes = sum(p_.numel() * p_.element_size() for p_ in params.parameters())
    print(f"prefill init: {cfg.name}, {n_params:,} parameters, "
          f"{n_bytes / 1e9:.2f} GB serving weights, drawn from seed 0 on the "
          f"CPU and moved layer by layer in {time.perf_counter() - t0:.2f} s",
          flush=True)

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

    # the same CPU-drawn weights on the card and on the CPU
    cut = dataclasses.replace(cfg, n_layers=PREFILL_CPU_LAYERS)
    t0 = time.perf_counter()
    host = init_lm(cut, seed=0, device="cpu", dtype=torch.bfloat16)
    draw_s = time.perf_counter() - t0
    card = copy.deepcopy(host).to(dev)
    toks = batch_for(cut, PREFILL_CPU_SEQ, 1, 2)["inputs"]
    last = []
    for model, d in ((card, dev), (host, torch.device("cpu"))):
        t0 = time.perf_counter()
        with torch.inference_mode():
            hid, _ = lm_hidden(model, toks.to(d), cut, attn_impl="blockwise")
            last.append(lm_logits(model, hid[:, -1:], cut).float().cpu())
        print(f"  {PREFILL_CPU_LAYERS}-layer prefill at seq {PREFILL_CPU_SEQ} "
              f"on {d}: {time.perf_counter() - t0:.2f} s", flush=True)
    on_card, on_cpu = last
    rel = float((on_card - on_cpu).norm() / on_cpu.norm())
    check(math.isfinite(rel) and rel <= PREFILL_CPU_RTOL,
          f"prefill card vs CPU: last-position logits rel L2 {rel:.3e}")
    print(f"prefill check: {PREFILL_CPU_LAYERS} layers, full width, seq "
          f"{PREFILL_CPU_SEQ} (weights drawn on the CPU in {draw_s:.1f} s): "
          f"last-position logits card vs CPU rel L2 {rel:.3e} (tolerance "
          f"{PREFILL_CPU_RTOL}), argmax "
          f"{'agrees' if int(on_card.argmax()) == int(on_cpu.argmax()) else 'differs'}"
          f" ({int(on_card.argmax())} vs {int(on_cpu.argmax())})", flush=True)

    # the CUDA-core route: a config whose head dim the tensor-core kernel
    # does not take (the reduced qwen2.5, head dim 16), card vs CPU
    small = registry.reduced(PREFILL_CONFIG)
    s_shape = dataclasses.replace(shape, batch=2, seq=SMALL_ROUTE_SEQ)
    s_step = make_prefill_step(small, s_shape)
    s_host = init_lm(small, seed=0, device="cpu", dtype=torch.bfloat16)
    s_batch = batch_for(small, SMALL_ROUTE_SEQ, 2, 3)
    _, n_cc, s_logits = _prefill(s_step, copy.deepcopy(s_host).to(dev),
                                 s_batch, small, "CUDA-core route",
                                 tensor_cores=False, keep=True)
    with torch.inference_mode():
        want = make_prefill_step(small, s_shape, device="cpu").fn(
            s_host, s_batch)
    rel = float((s_logits.float().cpu() - want.float()).norm()
                / want.float().norm())
    check(rel <= PREFILL_CPU_RTOL, f"CUDA-core route prefill card vs CPU: "
                                   f"rel L2 {rel:.3e}")
    print(f"prefill route check: {small.name} (head dim "
          f"{small.resolved_head_dim}), 2 x {SMALL_ROUTE_SEQ}: flash_attention "
          f"(CUDA cores) {n_cc} launches; logits card vs CPU rel L2 "
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
    print(f"layout flow: generate_layout on the card for the {len(times)} "
          f"specs with the largest grids ({first.routing.grid_shape} first): "
          f"metrics equal to golden, wires total the wirelength, {total} "
          f"wavefront launches (one a net); s per spec "
          f"{[round(t, 3) for t in times]}; wavefront at "
          f"{tuple(occ.shape)}: {net_ms:.4f} ms, plain {net_plain_ms:.4f} "
          f"ms, bound {net_bound_ms:.6f} ms (bytes)", flush=True)
    return dict(launches=total, seconds=times, net_ms=net_ms,
                net_plain_ms=net_plain_ms, net_bound_ms=net_bound_ms)


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
               migration_plain_ms=cuda_ms(
                   lambda: pareto.non_dominated_rank(f), 20),
               migration_bound_ms=b_ms, migration_bound_by=b_by)
    print(f"mesh nds_rank at the migration shape {tuple(f.shape)}: equal to "
          f"plain ({fronts} fronts over the {c} populations); "
          f"{out['migration_ms']:.4f} ms vs plain "
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
    print(f"decode engine ({card}): {cfg.name} full width, {len(reqs)} "
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
    from repro_torch.models.lm import decode_step, init_decode_state

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
    want, launches = _counted(lambda: step.fn(params, {"inputs": toks}))
    check(launches.get("flash_attention_wgmma", 0) == cfg.n_layers,
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
    check(all(math.isfinite(r) and r <= DECODE_RTOL for r in rels),
          f"decode vs prefill: rel L2 by position {rels}")
    check(agree >= DECODE_TOP1 * s,
          f"decode vs prefill: top-1 agrees at {agree} of {s} positions")
    print(f"decode check ({card}): decode_step under teacher forcing vs "
          f"the prefill (flash_attention_wgmma, {cfg.n_layers} launches) on "
          f"{s} tokens, bf16 both: rel L2 max {max(rels):.3e}, median "
          f"{sorted(rels)[s // 2]:.3e} (tolerance {DECODE_RTOL}); top-1 "
          f"equal at {agree} of {s} positions (tolerance "
          f"{DECODE_TOP1}); batch-1 decode {tf_s / s * 1e3:.3f} ms a step",
          flush=True)
    print(f"decode phase: {time.perf_counter() - t_phase:.2f} s", flush=True)
    return served


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
    """A train state's copy on `device` (fresh moments: the copies are of
    step-0 states)."""
    from repro_torch.optim import adamw

    params = copy.deepcopy(state["params"]).to(device)
    return {"params": params,
            "opt": adamw.init(dict(params.named_parameters()),
                              adamw.AdamWConfig()),
            "step": state["step"].to(device)}


def lm_train_phase(card: str) -> dict:
    """(a) full-width steps, (b) card-vs-CPU and the step's variants at 2
    layers, (c) restart exactness on the reduced config."""
    import shutil

    import torch

    from repro_torch import convert
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import batch_for
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.shapes import SHAPES, ShapeSpec, microbatches_for
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import lm
    from repro_torch.models.common import softmax_cross_entropy
    from repro_torch.runtime.fault_tolerance import (RESTART_EXIT_CODE,
                                                     PreemptionGuard)
    from repro_torch.train.trainer import TrainerConfig, init_state, train

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cfg = registry.get(PREFILL_CONFIG)
    torch.cuda.empty_cache()
    # -- (a) full width: 3.397 G float32 masters, AdamW moments
    (state, draw_ms) = _sync_ms(lambda: init_state(
        cfg, TrainerConfig(seed=0), device=dev))
    n_params = sum(p.numel() for p in state["params"].parameters())
    check(n_params == cfg.n_params(), f"train: {n_params} parameters")
    b, s = TRAIN_LM_SHAPE
    batches = [batch_for(cfg, s, b, i, seed=0, device=dev)
               for i in range(TRAIN_LM_STEPS)]
    # step 0's loss against the CE of its batch through the prefill path
    # (blockwise attention, flash_attention_wgmma) on the bf16 serving cast
    # of the same weights
    with torch.device("meta"):
        serve = lm.LM(cfg, torch.Generator(), device="meta",
                      dtype=torch.bfloat16)
    serve = serve.to_empty(device=dev)
    serve.load_state_dict(state["params"].state_dict())
    prefill = make_prefill_step(cfg, ShapeSpec("train_ce", "prefill", s, b))
    logits, ce_launches = _counted(lambda: prefill.fn(serve, batches[0]))
    check(ce_launches.get("flash_attention_wgmma", 0) == cfg.n_layers,
          f"train CE check: prefill launches {ce_launches}")
    with torch.inference_mode():
        ce = float(softmax_cross_entropy(logits, batches[0]["targets"])[0])
    del serve, logits
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, remat=True)
    losses, gnorms, ms = [], [], []
    LAUNCHES.clear()
    for batch in batches:
        (state, met), dt = _sync_ms(lambda: step.fn(state, batch))
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        ms.append(dt)
    step_launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"train: losses {losses}, grad norms {gnorms}")
    check(abs(losses[0] - ce) <= TRAIN_CE_RTOL * abs(ce),
          f"train: step-0 loss {losses[0]} vs the prefill path's CE {ce}")
    check(not any(step_launches.values()),
          f"train: the train step launched kernels of ours {step_launches}")
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    print(f"train ({card}): {cfg.name} full width, {n_params} float32 "
          f"master parameters drawn in {draw_ms / 1e3:.1f} s; "
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
    step4k = make_train_step(cfg, remat=True, microbatches=mb)
    torch.cuda.reset_peak_memory_stats()
    l4k, g4k, ms4k = [], [], []
    for i in range(TRAIN_4K_STEPS):
        batch = batch_for(cfg, shape4k.seq, TRAIN_4K_BATCH,
                          TRAIN_LM_STEPS + i, seed=0, device=dev)
        (state, met), dt = _sync_ms(lambda: step4k.fn(state, batch))
        l4k.append(float(met["loss"]))
        g4k.append(float(met["grad_norm"]))
        ms4k.append(dt)
    peak4k = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in l4k + g4k),
          f"train_4k: losses {l4k}, grad norms {g4k}")
    tok4k = TRAIN_4K_BATCH * shape4k.seq
    print(f"train_4k ({card}): cut to {TRAIN_4K_BATCH} x {shape4k.seq}, "
          f"{mb} microbatches, remat: {[round(x, 2) for x in ms4k]} ms a "
          f"step (last {tok4k / ms4k[-1] * 1e3:.0f} tokens/s); losses "
          f"{[round(x, 5) for x in l4k]}, grad norms "
          f"{[round(x, 4) for x in g4k]}; peak memory {peak4k:.2f} GB",
          flush=True)
    del step, step4k
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
    # microbatches against one, remat against none (each from the same
    # step-0 state and batch)
    small = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS)
    host = init_state(small, TrainerConfig(seed=0), device="cpu")
    b, s = TRAIN_CHECK_SHAPE
    batch = batch_for(small, s, b, 0, seed=0)
    base = _copy_state(host, dev)
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
    print(f"train check ({card}): {small.n_layers} layers at full width, "
          f"{b} x {s} tokens, one step each (the CPU's {cpu_s:.1f} s):\n  "
          + "\n  ".join(lines), flush=True)

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
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import attention as attn
    from repro_torch.models.common import apply_norm

    dh, dv = MLA_DIMS
    g = torch.Generator(device=dev).manual_seed(11)

    def qkv(b, s, h):
        return [torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
                for d in (dh, dh, dv)]

    def held(what, q, k, v, causal):
        got = fa.flash_attention(q, k, v, causal=causal)
        check(tuple(got.shape) == q.shape[:3] + (dv,), f"{what}: shape "
                                                       f"{tuple(got.shape)}")
        r = _tc_check(got, q, k, v, causal, 0, dump=True)
        f32p = fa_ref.flash_attention_ref(q, k, v, causal=causal)
        rel = _rel_l2(got, f32p)
        pairs = q.shape[0] * q.shape[2] * _visible_pairs(
            q.shape[1], k.shape[1], causal, 0)
        text = (f"{MLA_INST} {what}: {_tc_text(r, pairs)}; rel L2 {rel:.3e} "
                f"vs float32-P blockwise")
        check(r["ok"] and rel <= TC_F32P_REL_L2, text)
        print(f"kernel {text} (within tolerance)", flush=True)
        return r["err"]

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
          f"launches, no CUDA-core launch; attention share "
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
    launches.update(acim_matmul_wgmma=train["acim_matmul_wgmma"],
                    acim_matmul_cuda_core=train["acim_matmul_cuda_core"])
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
    conc, seq = engines["concurrent"], engines["flow"]
    # The wavefront kernel's paths: the concurrent engine (a launch a
    # round with BFS lanes) and the sequential flow (a launch a net).
    launches["wavefront"] = conc["launches"] + seq["launches"]
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["name"] in service:
            r["service_launches"] = service[r["name"]]
        if r["name"] in mesh["launches"]:
            r["mesh_launches"] = mesh["launches"][r["name"]]
        if r["name"] == "nds_rank":
            r.update({k: v for k, v in mesh.items() if k != "launches"})
        if r["name"] == "wavefront":
            r.update(concurrent_launches=conc["launches"],
                     flow_launches=seq["launches"], net_ms=seq["net_ms"],
                     net_plain_ms=seq["net_plain_ms"],
                     net_bound_ms=seq["net_bound_ms"])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # route_slots' whole-bucket time and bound (its row's own are on the
    # cut its plain version runs); nsga2_evolve's fronts peeled;
    # dominance_matrix's profiler device time and the launch floor;
    # acim_matmul's one-pass f32 bound and its ADC-flip share; the
    # service phase's launches of nsga2_evolve and route_slots;
    # wavefront's launches by path and its time at the per-net shape; the
    # mesh phase's launches of nsga2_evolve and nds_rank, and nds_rank at
    # the migration shape; the MoE phase's all-to-all check beside the
    # (192, 128) instantiation
    extra = ("bucket_ms", "bucket_bound_ms", "fronts", "device_ms",
             "floor_ms", "floor_device_ms", "bound_f32_ms", "flip_share",
             "service_launches", "concurrent_launches", "flow_launches",
             "net_ms", "net_plain_ms", "net_bound_ms", "mesh_launches",
             "migration_shape", "migration_ms", "migration_plain_ms",
             "migration_bound_ms", "migration_bound_by", "a2a_rel_l2",
             "a2a_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys + extra if k in r}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
