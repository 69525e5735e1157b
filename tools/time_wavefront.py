"""Time the standalone `wavefront` and `nds_rank` kernels of one or more
checkouts on the card, in turns, in one process:

    python3 tools/time_wavefront.py TREE [TREE ...] [--rank] [--route]
                                    [--steps] [--probes] [--turns N]

Each TREE's `src/repro_torch/csrc/maze_route.cu` and `pareto_dom.cu` are
built with `_build.NVCC_FLAGS` into build/time_wavefront/, all at once,
and its wrappers (`kernels/maze_route/kernel.py`,
`kernels/pareto_dom/kernel.py`) are loaded beside this checkout's package,
each bound to its own tree's libraries.  So every TREE runs on the same
inputs in the same process; each turn takes every tree in another order
(every tree in every place, then reversed).  The first TREE is the one
the others are counted against ("turns won": turns whose mean is below
the first TREE's).  To compare a change with its parent, pass the parent
first: `python3 tools/time_wavefront.py build/parent . --rank --route`.

`wavefront` at (86, 1118, 274) (the 16 kb front's 86 grids at 20 %
random occupancy, padded to the batch's extent, as `chip_smoke.py` phase
2), at (1, 122, 274) (the sequential flow's per-net input of its largest
spec, as phase 7) and at (1, 241, 2178) (the 65536 array at coarse 32):
each tree's field checked equal to the plain version, the BFS levels (the
field's largest finite value plus one, the most over the batch), then
the profiler's device ms of the kernel a launch (the wrapper reads
`grids` back to the host, which would put its time between queued
launches): each turn's mean over REPS launches, the median and least
turn, us a level, turns won.

`--rank`: `nds_rank` at (8, 96, 4) (phase 8's first migration), (1, 512,
4) and (1, 2048, 4), equal to plain, timed four ways: the mean of 200
back-to-back wrapper calls from CUDA events (`chip_smoke.cuda_ms`, the
host's wrapper time included), the profiler's device ms
(`chip_smoke.profiler_ms`), the host's ms a wrapper call (500 calls a
turn) and device ms a launch from CUDA events between launches queued
behind `torch.cuda._sleep` (so the host's time a call is not in them;
each launch's gap on the card is).

`--route`: `route_slots` on the 16 kb request's whole bucket (the
dynamic shared-memory attribute is set on its host path too).

`--steps`: this checkout's `maze_route.cu` built again with each step of
the `wavefront` redesign changed by text substitution (`STEPS`): a level
sweeping only the rows next to the last level's new cells (the row
window, which lost); each level's cells stored to the field (over an
INF fill) instead of kept in shared memory; occ and seed read a byte a
load; the last two together ("registers only": what is left is the
registers, the 1024 threads and the grid's own words), timed as
further trees.

`--probes`: the same source with the earlier shared-memory kernel on
every plane, with and without its per-level stores of the field, the
new kernel without its level stores, and at 512 threads (timing only:
the fields of the probes that drop stores are wrong by design and none
is checked).

The card's name and power limit are printed first.
"""
import ctypes
import importlib.util
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.core import pareto  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.maze_route import ref as mr_ref  # noqa: E402

CSRC = "src/repro_torch/csrc"
KERNELS = "src/repro_torch/kernels"
OUT = ROOT / "build" / "time_wavefront"
# Steps of the wavefront redesign, each undone by text substitutions of
# this checkout's maze_route.cu: (old, new) pairs.
FIELD_STORES = [  # each level's cells to the field, over an INF fill
    ("""  // Nothing reached yet: every level 0xffff.
  for (int i = tid; i < 16 * stride; i += kWaveThreads)
    reinterpret_cast<uint32_t*>(lv)[i] = 0xffffffffu;""",
     """  for (int i = tid; i < H * W; i += kWaveThreads) db[i] = kInf;"""),
    ("""    for (uint32_t q = m; q; q &= q - 1)
      lv[level_at(__ffs(q) - 1, k, stride)] = (uint16_t)level;""",
     """    const int r = row_of(k, inv), x0 = (k - r * wpr) << 5;
    for (uint32_t q = m; q; q &= q - 1) db[r * W + x0 + __ffs(q) - 1] = level;"""),
    ("""  // The field, 16 bytes a store:""", """  return;
  // The field, 16 bytes a store:""")]
BYTE_SETUP = [  # occ and seed a byte a load
    ("""    const uint32_t blocked = load_bits(occ, c0, n);
    const uint32_t sd = load_bits(seed, c0, n);""",
     """    uint32_t blocked = 0, sd = 0;
    for (int j = 0; j < n; ++j) {
      blocked |= (uint32_t)(occ[c0 + j] != 0) << j;
      sd |= (uint32_t)(seed[c0 + j] != 0) << j;
    }""")]
ROW_WINDOW = [  # a level sweeps only the rows next to the last one's cells
    ("""// Index of the level of bit `bit` of word k""",
     """__device__ __forceinline__ void block_rows(int (*slots)[2], int& lo,
                                           int& hi) {
  const int lane = threadIdx.x & 31;
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    slots[threadIdx.x >> 5][0] = lo;
    slots[threadIdx.x >> 5][1] = hi;
  }
  __syncthreads();
  lo = __reduce_min_sync(0xffffffffu, slots[lane][0]);
  hi = __reduce_max_sync(0xffffffffu, slots[lane][1]);
}

// Index of the level of bit `bit` of word k"""),
    ("""  bool found = false;
#pragma unroll
  for (int i = 0; i < WPT; ++i) {
    open[i] = 0;""", """  bool found = false;
  int lo = INT_MAX, hi = -1;
  __shared__ int slots[2][32][2];
#pragma unroll
  for (int i = 0; i < WPT; ++i) {
    open[i] = 0;"""),
    ("""      put(sd, k, 0);
      found = true;""", """      put(sd, k, 0);
      found = true;
      lo = min(lo, r);
      hi = max(hi, r);"""),
    ("""  for (int level = 1; __syncthreads_or(found); ++level) {
    found = false;""",
     """  for (int level = 1;
       block_rows(slots[(level - 1) & 1], lo, hi), lo <= hi; ++level) {
    found = false;
    const int a = max(0, lo - 1) * wpr, e = (min(gh - 1, hi + 1) + 1) * wpr;
    lo = INT_MAX;
    hi = -1;"""),
    ("""      if (k >= words) continue;
      const uint32_t c = cur[k];""", """      if (k < a || k >= e) continue;
      const uint32_t c = cur[k];"""),
    ("""        put(m, k, level);
        found = true;""", """        put(m, k, level);
        found = true;
        const int r = row_of(k, inv);
        lo = min(lo, r);
        hi = max(hi, r);""")]
STEPS = {"with row window": ROW_WINDOW,
         "levels to the field each level": FIELD_STORES,
         "byte setup": BYTE_SETUP,
         "registers only": FIELD_STORES + BYTE_SETUP}
# Probes of where a level's time goes (--probes); the fields of those
# that drop stores are wrong by design.
EARLIER = ("  if (max_cells <= kLevelCells &&",
           "  if (false && max_cells <= kLevelCells &&")
EARLIER_NO_STORES = ("            db[a.r * W + (a.w << 5) + __ffs(q) - 1] = "
                     "level;", "            (void)q;")
NO_STORES = ("      lv[level_at(__ffs(q) - 1, k, stride)] = (uint16_t)level;",
             "      (void)q;")
THREADS = "constexpr int kWaveThreads = 1024;"
PROBES = {"probe: earlier kernel": [EARLIER],
          "probe: earlier kernel, no level stores": [EARLIER,
                                                     EARLIER_NO_STORES],
          "probe: no level stores": [NO_STORES],
          "probe: 512 threads": [(THREADS, THREADS.replace("1024", "512"))]}
REPS = 20


def _arg(name: str, default: int) -> int:
    return (int(sys.argv[sys.argv.index(name) + 1]) if name in sys.argv
            else default)


def _trees() -> list[str]:
    out, skip = [], False
    for a in sys.argv[1:]:
        if skip:
            skip = False
        elif a == "--turns":
            skip = True
        elif not a.startswith("--"):
            out.append(a)
    return out


def sources(trees: list[str]) -> dict[str, dict[str, str]]:
    """{label: {"maze_route": text, "pareto_dom": text}}: each tree's, then
    with --steps this checkout's maze_route with each step undone."""
    out = {}
    for t in trees:
        out[t] = {n: (Path(t) / CSRC / f"{n}.cu").read_text()
                  for n in ("maze_route", "pareto_dom")}
    base = (ROOT / CSRC / "maze_route.cu").read_text()
    variants = {}
    if "--steps" in sys.argv:
        variants.update(STEPS)
    if "--probes" in sys.argv:
        variants.update(PROBES)
    for label, subs in variants.items():
        text = base
        for old, new in subs:
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        out[label] = {"maze_route": text}
    return out


def build(texts: dict[str, dict[str, str]]) -> dict[str, dict[str, Path]]:
    """Every source with one nvcc each, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs, libs = [], {}
    for i, (label, srcs) in enumerate(texts.items()):
        libs[label] = {}
        for name, text in srcs.items():
            cu = OUT / f"{name}_{i}.cu"
            cu.write_text(text)
            so = OUT / f"lib{name}_{i}.so"
            libs[label][name] = so
            procs.append((label, name, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for label, name, proc in procs:
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{label} {name}:\n{log}"
        report_ptxas(label, log)
    return libs


def report_ptxas(label: str, log: str) -> None:
    """The ptxas lines (registers, spills) of the wavefront and nds_rank
    kernels."""
    kern = ""
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            kern = hit.group(1)
        elif ("wavefront" in kern or "nds_rank" in kern) and (
                "Used" in line or "spill" in line):
            print(f"WF {label}: ptxas {kern}: {line.strip()}", flush=True)


def wrappers(tree: str, libs: dict[str, Path]) -> dict[str, object]:
    """TREE's wrapper modules, each loading its own library of `libs`."""
    mods = {}
    for name in ("maze_route", "pareto_dom"):
        path = Path(tree) / KERNELS / name / "kernel.py"
        spec = importlib.util.spec_from_file_location(
            f"tw_{libs[name].stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        so = str(libs[name])
        mod._build = types.SimpleNamespace(
            load=lambda _n, so=so: ctypes.CDLL(so), launch=_build.launch)
        mod._LIB = None
        mods[name] = mod
    return mods


def queued_ms(fn, reps: int) -> list[float]:
    """Device ms of each of `reps` launches of `fn`, enqueued behind a
    sleep kernel so that the card runs them back to back whatever the
    host's time a call."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(int(2e8))
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(reps)]


def in_turns(runs: dict, turns: int, reps: int, kernel: str = "") -> dict:
    """{label: (per-turn means, every launch)}, every label in every place
    of the order by turns.  With `kernel`, each turn's mean is the
    profiler's device time of the kernels so named (`every launch` is then
    the turns' means)."""
    names = list(runs)
    means = {n: [] for n in names}
    each = {n: [] for n in names}
    for turn in range(turns):
        order = names[turn % len(names):] + names[:turn % len(names)]
        for n in (order if turn % 2 == 0 else order[::-1]):
            if kernel:
                ms = [c.profiler_ms(runs[n], reps, kernel)]
            else:
                ms = queued_ms(runs[n], reps)
            each[n] += ms
            means[n].append(sum(ms) / len(ms))
    return {n: (means[n], each[n]) for n in names}


def report(what: str, got: dict, first: str, levels: int = 0) -> None:
    for n, (means, each) in got.items():
        med = statistics.median(each if len(each) > len(means) else means)
        won = sum(a < b for a, b in zip(means, got[first][0]))
        lv = (f", {med / levels * 1e3:.4f} us a level ({levels} levels)"
              if levels else "")
        print(f"WF {what}: {n}: median {med:.5f} ms, least {min(each):.5f}, "
              f"turn means {[round(m, 5) for m in means]}{lv}; turns won "
              f"against {first}: {won} of {len(means)}", flush=True)


def levels_of(dist: torch.Tensor) -> int:
    finite = dist[dist < mr_ref.INF]
    return int(finite.max()) + 1 if finite.numel() else 0


def wavefront_cases(dev) -> list:
    from repro_torch.core.acim_spec import MacroSpec
    from repro_torch.eda import flow

    specs = [MacroSpec(p["row"]["h"], p["row"]["w"], p["row"]["l"],
                       p["row"]["b_adc"]) for p in c.golden_points()]
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    occ, seed, grids_t, _ = c.wavefront_bucket(dev, rng, gen, specs)
    lr = flow.generate_layout(specs[c._flow_specs(specs)[0]], device="cuda")
    n_occ, n_seed = c._net_wavefront(lr)
    big = torch.rand((1, 241, 2178), generator=gen, device=dev) < 0.2
    big_seed = torch.zeros_like(big)
    big_seed[0, 120, 17] = True
    return [("bucket", occ, seed, grids_t), ("net", n_occ, n_seed, None),
            ("65536 coarse 32", big, big_seed, None)]


def rank_cases(dev) -> list:
    rng = np.random.default_rng(0)
    f = c._objectives_batch(dev, rng)
    big = torch.cat([f[:, :500].reshape(1, 1500, 4),
                     torch.full((1, 548, 4), float("inf"), device=dev)], 1)
    run = c.ISLAND_RUN
    mig = c._island_round0(dev, run["islands"], run["pop_size"],
                           run["migrate_every"])[-1].contiguous()
    return [("migration", mig), ("composite", f[:1].contiguous()),
            ("2048", big.contiguous())]


def main() -> None:
    trees = _trees()
    turns = _arg("--turns", 8)
    texts = sources(trees)
    libs = build(texts)
    # a step variant runs this checkout's wrappers, nds_rank of the first
    # tree
    mods = {label: wrappers(label if label in trees else str(ROOT),
                            {**libs[trees[0]], **libs[label]})
            for label in texts}
    first = trees[0]
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"WF card: {smi.stdout.strip()}", flush=True)

    for what, occ, seed, grids in wavefront_cases(dev):
        want = mr_ref.wavefront_distance_ref(occ, seed, grids)
        for label, m in mods.items():
            got = m["maze_route"].wavefront(occ, seed, grids)
            torch.cuda.synchronize()
            if not label.startswith("probe"):
                print(f"WF wavefront {what} {tuple(occ.shape)}: {label} "
                      f"{'equal' if torch.equal(got, want) else 'NOT equal'}"
                      f" to plain", flush=True)
        runs = {label: (lambda m=m: m["maze_route"].wavefront(occ, seed,
                                                               grids))
                for label, m in mods.items()}
        report(f"wavefront {what} {tuple(occ.shape)} device",
               in_turns(runs, turns, REPS, "wavefront"), first,
               levels_of(want))

    if "--rank" in sys.argv:
        for what, f in rank_cases(dev):
            want = pareto.non_dominated_rank(f)
            fronts = int((want.amax(-1) + 1).sum())
            for label in trees:
                got = mods[label]["pareto_dom"].nds_rank(f)
                torch.cuda.synchronize()
                print(f"WF nds_rank {what} {tuple(f.shape)}: {label} "
                      f"{'equal' if torch.equal(got, want) else 'NOT equal'}"
                      f" to plain ({fronts} fronts over the cells)",
                      flush=True)
            calls = {label: (lambda m=mods[label]: m["pareto_dom"].nds_rank(f))
                     for label in trees}
            for turn in range(2):
                for label in (trees if turn == 0 else trees[::-1]):
                    ev = c.cuda_ms(calls[label], 200)
                    pr = c.profiler_ms(calls[label], 50, "nds_rank")
                    print(f"WF nds_rank {what} {tuple(f.shape)}: {label} "
                          f"turn {turn}: event ms {ev:.5f} (200 wrapper calls"
                          f" back to back), profiler device ms {pr:.5f}",
                          flush=True)
            host = {label: [] for label in trees}
            for turn in range(turns):
                for label in (trees if turn % 2 == 0 else trees[::-1]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(500):
                        calls[label]()
                    host[label].append((time.perf_counter() - t0) / 500 * 1e3)
                    torch.cuda.synchronize()
            for label in trees:
                print(f"WF nds_rank {what} {tuple(f.shape)}: {label} host ms "
                      f"a wrapper call (500 calls, median of {turns} turns) "
                      f"{statistics.median(host[label]):.5f}, turns "
                      f"{[round(x, 5) for x in host[label]]}", flush=True)
            report(f"nds_rank {what} {tuple(f.shape)} queued",
                   in_turns(calls, turns, 50), first)

    if "--route" in sys.argv:
        from repro_torch.core.acim_spec import MacroSpec

        specs = [MacroSpec(p["row"]["h"], p["row"]["w"], p["row"]["l"],
                           p["row"]["b_adc"]) for p in c.golden_points()]
        occ0, nets, grids_t, _ = c.request_bucket(specs, dev)
        outs = {}
        for label in trees:
            outs[label] = mods[label]["maze_route"].route_slots(
                occ0, *nets, grids_t, c.CAPACITY)
        same = all(torch.equal(a, b) for label in trees
                   for a, b in zip(outs[label], outs[first]))
        print(f"WF route_slots whole bucket {tuple(occ0.shape)}: outputs "
              f"{'equal' if same else 'NOT equal'} across trees", flush=True)
        runs = {label: (lambda m=mods[label]: m["maze_route"].route_slots(
            occ0, *nets, grids_t, c.CAPACITY)) for label in trees}
        report(f"route_slots whole bucket {tuple(occ0.shape)}",
               in_turns(runs, max(2, turns // 2), 5), first)


if __name__ == "__main__":
    main()
