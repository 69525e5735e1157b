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
             inputs, exactly (integer outputs); time both.  `acim_matmul`
             runs at the trainer's FFN shapes, (1024, 768) @ (768, 3072)
             and (1024, 3072) @ (3072, 768), with the codesign pick's
             (N, B) and with N = 128, B = 5: bit-equal on +-1 operands,
             and on mismatch-folded weights equal but for ADC flips (a
             whole number of deltas each) on at most 0.1 % of outputs.
             `flash_attention` runs at the prefill's shape, (1, 32768,
             16 heads, 2 KV heads, 128) causal bf16, against the
             blockwise plain version, and at (4, 4096, ...) in bf16 and
             f32, with a prefix, at S 4001 and at head dims 16-64 also
             against the naive one: f32 within atol = rtol = 2e-5, bf16
             within one output ulp plus 2e-5 (both compute in f32 and
             round once).  Its library yardstick is
             `scaled_dot_product_attention` on the same bf16 tensors.
3. path    — `DesignSession().run(DesignRequest(array_size=16384))` at
             the full default budget (pop 256, 80 generations, coarse
             64, capacity 4): the front must lie inside the golden
             exhaustive front and cover >= 60 % of it, and every layout
             row must equal the golden row of its spec (integers
             exactly, floats to rtol 1e-6).  Then one
             `use_pallas_dominance=True, layout=False` request drives the
             dominance-matrix route.  Each path runs with the launch
             counts zeroed just before it and read just after; every
             kernel must have launched on its path.
4. train   — the CIM-in-the-loop trainer at full width (d 768, 12
             layers, 12 heads, d_ff 3072, vocab 2048, seq 128, batch 8,
             lr 3e-3): `recommend_macro` at the example's settings, whose
             pick must be a point of the golden exhaustive front meeting
             the 3 dB floor (its energy-delay rank among those points is
             printed), then 20 SGD steps whose losses must be finite and
             end below the first.  Launch counts, zeroed before the pick
             and read after the last step: `acim_matmul` 24 per forward,
             `nds_rank` > 0.  Then step 0's loss on the card is held
             against the plain PyTorch run on the CPU of the same weights,
             batch and mismatch draws, at full width and 2 layers (rtol
             1e-2: the bfloat16 backbone rounds differently on the two
             devices, and a rounding can flip a binarized activation).
5. prefill — `make_prefill_step(qwen2.5-3b, prefill_32k)` at full width
             (36 layers, d 2048, vocab 151,936) with bf16 serving
             weights drawn from seed 0 (CPU generator), on synthetic tokens
             at batch 1 x 32768 (the shape's batch of 32 cut to 1: its
             logits alone are 9.96 GB a sequence): a warm-up prefill and
             a timed one, then batch 4 x 4096.  Logits must be finite and
             each prefill must launch `flash_attention` 36 times.  Then
             one full-width layer at S 4096: `attention_fwd_blockwise`
             against the dense `attention_fwd` (rel L2 2e-2: the dense
             path rounds scores and probabilities to bf16); and a
             2-layer full-width model at seq 512 with the same CPU-drawn
             weights on the card and on the CPU: last-position logits
             within rel L2 5e-2 (both backbones are bf16), argmax
             agreement printed.
6. report  — one JSON line of per-kernel numbers, the nvidia-smi line,
             and the contract line
             {"ok": true, "device": {"platform": "gpu", ...}}.

The golden rows come from the JAX reference (`tests/test_torch_golden.py`
regenerates and checks them); this script imports nothing of JAX.
"""
from __future__ import annotations

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

# The prefill phase: qwen2.5-3b at full width, prefill_32k cut to batch 1.
PREFILL_CONFIG = "qwen2.5-3b"
PREFILL_BATCH = 1
SMALL_PREFILL = (4, 4096)  # batch, seq: B > 1
FLASH_RTOL = 2e-5          # f32 atol = rtol; bf16: one output ulp + this
DENSE_CHECK_SEQ = 4096     # blockwise vs dense attention, one layer
DENSE_CHECK_RTOL = 2e-2    # rel L2 (measured 3.8e-3 on the CPU at S 512)
PREFILL_CPU_LAYERS = 2     # card vs CPU, full width
PREFILL_CPU_SEQ = 512
PREFILL_CPU_RTOL = 5e-2    # rel L2 of the last position's logits


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

    # -- dominance_matrix: (1, 512, 4)
    fd = f[1:2].contiguous()
    got, want = pd.dominance_matrix(fd), pareto.dominance_matrix(fd)
    check(torch.equal(got, want), "dominance_matrix != plain on (1, 512, 4)")
    c, p, m = fd.shape
    b_ms, b_by = bound(c * p * m * 4 + c * p * p, c * p * p * m * 2)
    rows.append(dict(
        name="dominance_matrix", route="cuda",
        source="src/repro_torch/csrc/pareto_dom.cu",
        replaces="src/repro/kernels/pareto_dom/kernel.py:44",
        max_abs_err=float((got.int() - want.int()).abs().max()),
        ms=cuda_ms(lambda: pd.dominance_matrix(fd), 200),
        plain_ms=cuda_ms(lambda: pareto.dominance_matrix(fd), 50),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    print(f"kernel dominance_matrix: equal to plain on (1, 512, 4); "
          f"{rows[-1]['ms']:.4f} ms vs plain {rows[-1]['plain_ms']:.4f} ms",
          flush=True)

    # -- wavefront: the 86 golden 16 kb grids with random occupancy,
    # padded to the batch's extent (the main path's bucket), and one
    # 122 x 1090 grid of the 65536 array (global-memory branch)
    geom = geometry()
    from repro_torch.core.acim_spec import MacroSpec
    specs = [MacroSpec(p_["row"]["h"], p_["row"]["w"], p_["row"]["l"],
                       p_["row"]["b_adc"]) for p_ in golden_points()]
    grids = np.array([grid_shape(o.width, o.height, 64) for o in
                      (layout_operands(s, geom) for s in specs)], np.int64)
    bsz, gh, gw = len(grids), int(grids[:, 0].max()), int(grids[:, 1].max())
    grids_t = torch.tensor(grids, dtype=torch.int32, device=dev)
    outside = mr_ref.outside_grids((bsz, gh, gw), grids_t, dev)
    occ = (torch.rand((bsz, gh, gw), device=dev) < 0.2) | outside
    seed = torch.zeros_like(occ)
    hy = torch.tensor(rng.integers(0, grids[:, 0]), device=dev)
    hx = torch.tensor(rng.integers(0, grids[:, 1]), device=dev)
    seed[torch.arange(bsz, device=dev), hy, hx] = True
    max_cells = int((grids[:, 0] * grids[:, 1]).max())
    dist = mr.wavefront(occ, seed, grids_t, max_cells)
    want = mr_ref.wavefront_distance_ref(occ, seed, grids_t)
    check(torch.equal(dist, want),
          f"wavefront != plain on ({bsz}, {gh}, {gw})")
    occ65 = torch.rand((1, 122, 1090), device=dev) < 0.2
    seed65 = torch.zeros_like(occ65)
    seed65[0, 61, 17] = True
    check(torch.equal(mr.wavefront(occ65, seed65),
                      mr_ref.wavefront_distance_ref(occ65, seed65)),
          "wavefront != plain on (1, 122, 1090) (global-memory branch)")
    # The function reads occ and seed of the real cells only (the pad is
    # blocked by definition) and writes the whole int32 plane.
    cells = bsz * gh * gw
    real = int((grids[:, 0] * grids[:, 1]).sum())
    b_ms, b_by = bound(cells * 4 + real * 2 + bsz * 8, real * 4 * 2)
    rows.append(dict(
        name="wavefront", route="cuda", source="src/repro_torch/csrc/maze_route.cu",
        replaces="src/repro/kernels/maze_route/kernel.py:71",
        max_abs_err=float((dist - want).abs().max()),
        ms=cuda_ms(lambda: mr.wavefront(occ, seed, grids_t, max_cells), 20),
        plain_ms=cuda_ms(lambda: mr_ref.wavefront_distance_ref(
            occ, seed, grids_t), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    print(f"kernel wavefront: equal to plain on ({bsz}, {gh}, {gw}) and "
          f"(1, 122, 1090); {rows[-1]['ms']:.4f} ms vs plain "
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

    rows.append(acim_kernel_check(dev, rng))
    rows.append(flash_kernel_check(dev))
    return rows


def _adc_flip_share(got, want, delta: float) -> float:
    """Share of outputs where kernel and plain version differ; fails
    unless every difference is a whole number of ADC steps."""
    steps = (got - want).double() / delta
    check(bool(((steps - steps.round()).abs() <= 1e-3).all()),
          "acim_matmul differs from plain by a non-multiple of delta")
    return float((steps != 0).double().mean())


def acim_kernel_check(dev, rng) -> dict:
    """acim_matmul against its plain version at the trainer's FFN shapes,
    with the codesign pick's (N, B) and with N = 128, B = 5."""
    import torch

    from repro_torch.core.acim_numerics import NoiseParams
    from repro_torch.core.acim_spec import MacroSpec
    from repro_torch.kernels.acim_matmul import ops as am
    from repro_torch.kernels.acim_matmul import ref as am_ref
    from repro_torch.train import acim_lm

    torch.backends.cuda.matmul.allow_tf32 = False      # exact f32 products
    cfg = acim_lm.build_cfg(TRAIN["d_model"], TRAIN["layers"])
    pick = acim_lm.pick_macro(cfg).spec
    row = None
    for spec in (pick, MacroSpec(256, 64, 2, 5)):
        n, b = spec.n_caps, spec.b_adc
        delta = 2.0 * n / 2 ** b
        for m, k, c in ACIM_SHAPES:
            x = torch.tensor(rng.choice([-1.0, 1.0], (m, k)),
                             dtype=torch.float32, device=dev)
            w = torch.tensor(rng.choice([-1.0, 1.0], (k, c)),
                             dtype=torch.float32, device=dev)
            got = am.acim_matmul(x, w, spec)
            want = am_ref.acim_matmul_ref(x, w, n=n, b_adc=b)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"acim_matmul != plain on +-1 ({m}, {k}, {c}), N={n}, B={b}")
            eps = torch.randn((k, c), device=dev)
            wm = am.mismatch_weights(w, spec, eps, NoiseParams.from_cal())
            share = _adc_flip_share(
                am.acim_matmul(x, wm, spec),
                am_ref.acim_matmul_ref(x, wm, n=n, b_adc=b), delta)
            check(share <= ACIM_FLIP_SHARE,
                  f"acim_matmul: {share:.2e} of outputs flipped on "
                  f"mismatch-folded ({m}, {k}, {c}), N={n}, B={b}")
            ms = cuda_ms(lambda: am.acim_matmul(x, w, spec), 20)
            plain_ms = cuda_ms(lambda: am_ref.acim_matmul_ref(
                x, w, n=n, b_adc=b), 5)
            dense_ms = cuda_ms(lambda: torch.matmul(x, w), 20)
            b_ms, b_by = bound((m * k + k * c + m * c) * 4, 2 * m * k * c)
            print(f"kernel acim_matmul: equal to plain on +-1 ({m}, {k}, "
                  f"{c}), N={n}, B={b}; mismatch-folded: {share:.2e} of "
                  f"outputs one or more ADC steps apart; {ms:.4f} ms vs "
                  f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
                  f"dense f32 torch.matmul (reference only) {dense_ms:.4f} "
                  f"ms", flush=True)
            if row is None:          # the main path's first shape and pick
                row = dict(
                    name="acim_matmul", route="cuda",
                    source="src/repro_torch/csrc/acim_matmul.cu",
                    replaces="src/repro/kernels/acim_matmul/kernel.py:60",
                    max_abs_err=float((got - want).abs().max()), ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=None)
    return row


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


def _heads_first(x, rep: int):
    """(B, S, n, Dh) -> (B * n * rep, S, Dh), each head repeated `rep`
    times: the naive oracle's layout."""
    b, s, n, dh = x.shape
    return x.permute(0, 2, 1, 3).repeat_interleave(rep, 1).reshape(-1, s, dh)


def flash_kernel_check(dev) -> dict:
    """flash_attention against its plain versions: the prefill's shape
    against the blockwise one (the naive scores would take 68 GB), the
    smaller shapes against both; times at the prefill's shape."""
    import torch
    import torch.nn.functional as F

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
             (2, 777, 8, 2, 32, bf16, True, 0),
             (2, 777, 8, 2, 16, f32, True, 0)]
    for b, s, h, kv, dh, dtype, causal, pre in cases:
        q, k, v = qkv(b, s, h, kv, dh, dtype)
        got = fa.flash_attention(q, k, v, causal=causal, prefix_len=pre)
        want = fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                          prefix_len=pre)
        naive = fa_ref.attention_ref(
            _heads_first(q, 1), _heads_first(k, h // kv),
            _heads_first(v, h // kv), causal=causal, prefix_len=pre)
        naive = naive.reshape(b, h, s, dh).permute(0, 2, 1, 3)
        torch.cuda.synchronize()
        err, excess = _flash_excess(got, want)
        err_n, excess_n = _flash_excess(got, naive)
        what = (f"({b}, {s}, {h}, {kv}, {dh}) {str(dtype)[6:]} "
                f"{'causal' if causal else 'full'} prefix {pre}")
        check(excess <= 0 and excess_n <= 0,
              f"flash_attention {what}: max err {err:.3e} vs blockwise plain, "
              f"{err_n:.3e} vs naive; beyond tolerance by "
              f"{max(excess, excess_n):.3e}")
        print(f"kernel flash_attention {what}: max err {err:.3e} vs "
              f"blockwise plain, {err_n:.3e} vs naive (within tolerance)",
              flush=True)
        del q, k, v, got, want, naive

    # the prefill's shape: the main path's row
    b, s, h, kv, dh = PREFILL_BATCH, 32768, 16, 2, 128
    q, k, v = qkv(b, s, h, kv, dh, bf16)
    got = fa.flash_attention(q, k, v)
    want = fa_ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    err, excess = _flash_excess(got, want)
    check(excess <= 0, f"flash_attention ({b}, {s}, {h}, {kv}, {dh}) bf16: "
                       f"max err {err:.3e}, beyond one ulp + {FLASH_RTOL} "
                       f"by {excess:.3e}")
    del want
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 3)
    plain_ms = cuda_ms(lambda: fa_ref.flash_attention_ref(q, k, v), 1)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, is_causal=True, enable_gqa=True)
    library_ms = cuda_ms(sdpa, 5)
    sdpa_err = float((sdpa().transpose(1, 2).float() - got.float()).abs().max())
    flops = 4 * dh * h * b * _visible_pairs(s, s, True, 0)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_TC_FLOPS)
    print(f"kernel flash_attention ({b}, {s}, {h}, {kv}, {dh}) bf16 causal: "
          f"max err {err:.3e} vs blockwise plain (within one ulp + "
          f"{FLASH_RTOL}); {ms:.3f} ms vs plain {plain_ms:.3f} ms; SDPA "
          f"(library) {library_ms:.3f} ms, max |SDPA - kernel| "
          f"{sdpa_err:.3e}; bound {b_ms:.4f} ms ({b_by}: {flops:.3e} flops, "
          f"{nbytes / 1e6:.1f} MB); {flops / ms / 1e9:.2f} TFLOP/s", flush=True)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:59",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


# ----------------------------------------------------------------------
# Phase 3: the main path
# ----------------------------------------------------------------------
def _close(a, b) -> bool:
    if isinstance(b, bool) or isinstance(b, int):
        return type(a) is type(b) and a == b
    return math.isclose(a, b, rel_tol=FLOAT_RTOL, abs_tol=0.0)


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
    found = [(s.h, s.l, s.b_adc) for s in art.pareto.specs]
    check(set(found) <= set(golden),
          f"front has points off the golden front: {set(found) - set(golden)}")
    check(len(set(found)) >= 0.6 * len(golden),
          f"front covers {len(set(found))} of {len(golden)} golden points")
    check(art.layout_rows is not None and len(art.layout_rows) == len(found),
          "missing layout rows")
    for key, row in zip(found, art.layout_rows):
        want = golden[key]
        check(row.keys() == want.keys(), f"row keys differ for {key}")
        bad = [k for k in want if not _close(row[k], want[k])]
        check(not bad, f"row {key} differs from golden in {bad}: "
                       f"{[(row[k], want[k]) for k in bad]}")
    prov = art.provenance
    print(f"path run: 16384, pop 256 x 80 gens: front {len(found)} of "
          f"{len(golden)} golden points, {len(found)} layout rows equal to "
          f"golden; explore {prov.explore_s:.2f} s, layout "
          f"{prov.layout_s:.2f} s, total {total:.2f} s; route slots "
          f"{prov.route_rounds}", flush=True)
    print(f"path launches: {main_launches}", flush=True)

    LAUNCHES.clear()
    t0 = time.perf_counter()
    art2 = session.run(DesignRequest(array_size=16384,
                                     use_pallas_dominance=True, layout=False))
    torch.cuda.synchronize()
    dom_launches = dict(LAUNCHES)
    found2 = {(s.h, s.l, s.b_adc) for s in art2.pareto.specs}
    check(found2 <= set(golden), "dominance-route front off the golden front")
    check(len(found2) >= 0.6 * len(golden),
          f"dominance-route front covers {len(found2)} of {len(golden)}")
    print(f"path dominance route (layout=False): front {len(found2)} of "
          f"{len(golden)}, {time.perf_counter() - t0:.2f} s; launches "
          f"{dom_launches}", flush=True)

    launches = {"nds_rank": main_launches.get("nds_rank", 0),
                "wavefront": main_launches.get("wavefront", 0),
                "trace_paths": main_launches.get("trace_paths", 0),
                "dominance_matrix": dom_launches.get("dominance_matrix", 0)}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on its path")
    return launches


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
    check(launches.get("acim_matmul", 0) == per_fwd * TRAIN["steps"],
          f"acim_matmul launched {launches.get('acim_matmul', 0)} times, "
          f"want {per_fwd} x {TRAIN['steps']} forwards")
    check(launches.get("nds_rank", 0) > 0, "nds_rank not launched by the pick")
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
    return {"acim_matmul": launches["acim_matmul"],
            "nds_rank": launches["nds_rank"]}


# ----------------------------------------------------------------------
# Phase 5: long-context prefill of qwen2.5-3b at full width
# ----------------------------------------------------------------------
def _prefill(step, params, batch, cfg, what: str) -> tuple[float, int]:
    """One prefill with the launch counts zeroed just before it and read
    just after: (seconds, flash_attention launches); the logits must be
    finite and of the batch's shape."""
    import torch

    from repro_torch.kernels import LAUNCHES

    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = step.fn(params, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = LAUNCHES["flash_attention"]
    b, s = batch["inputs"].shape
    check(tuple(logits.shape) == (b, s, cfg.vocab),
          f"prefill {what}: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()),
          f"prefill {what}: non-finite logits")
    check(n == cfg.n_layers, f"prefill {what}: flash_attention launched "
                             f"{n} times, want {cfg.n_layers}")
    return dt, n


def prefill_phase(flash_ms: float) -> dict:
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
    warm_s, _ = _prefill(step, params, batch, cfg, "warm-up")
    dt, launches = _prefill(step, params, batch, cfg, "timed")
    tokens = shape.batch * shape.seq
    print(f"prefill run: {shape.batch} x {shape.seq} tokens, {cfg.n_layers} "
          f"layers: {dt:.3f} s ({warm_s:.3f} s warm-up), {tokens / dt:,.0f} "
          f"tokens/s; flash_attention {launches} launches; attention share "
          f"~{cfg.n_layers * flash_ms / 1e3 / dt:.3f} of the wall time "
          f"({cfg.n_layers} x the kernel's {flash_ms:.1f} ms); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)

    b4, s4 = SMALL_PREFILL
    step4 = make_prefill_step(cfg, dataclasses.replace(shape, batch=b4,
                                                       seq=s4))
    batch4 = batch_for(cfg, *step4.batch_shapes["inputs"][::-1], 1)
    dt4, n4 = _prefill(step4, params, batch4, cfg, f"{b4} x {s4}")
    print(f"prefill run: {b4} x {s4} tokens: {dt4:.3f} s, "
          f"{b4 * s4 / dt4:,.0f} tokens/s; flash_attention {n4} launches",
          flush=True)

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
    del params, blk, x, h, dense, block

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
            hid = lm_hidden(model, toks.to(d), cut, attn_impl="blockwise")
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
    return {"flash_attention": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.exists():
        fail("run chip_smoke.py from the root of a repository checkout")
    sys.path.insert(0, str(ROOT / "src"))

    card = build_phase()
    rows = kernel_phase()
    launches = path_phase()
    launches["acim_matmul"] = train_phase()["acim_matmul"]
    flash_ms = next(r["ms"] for r in rows if r["name"] == "flash_attention")
    launches["flash_attention"] = prefill_phase(flash_ms)["flash_attention"]
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
