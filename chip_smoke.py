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
4. report  — one JSON line of per-kernel numbers, the nvidia-smi line,
             and the contract line
             {"ok": true, "device": {"platform": "gpu", ...}}.

The golden rows come from the JAX reference (`tests/test_torch_golden.py`
regenerates and checks them); this script imports nothing of JAX.
"""
from __future__ import annotations

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
FLOAT_RTOL = 1e-6


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over memory rate or
    operations over the CUDA-core rate, whichever is larger."""
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
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
    return rows


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
