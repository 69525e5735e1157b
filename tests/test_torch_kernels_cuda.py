"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Every test here needs a CUDA device (the kernels have no CPU
mode) and skips without one; this file imports nothing of JAX, so it
also runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import DesignRequest, DesignSession, Requirements
from repro_torch.configs import registry
from repro_torch.core import nsga2, pareto
from repro_torch.core.acim_numerics import NoiseParams
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.data.synthetic import batch_for
from repro_torch.eda import batched_flow as bf
from repro_torch.eda import flow, placer, router
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.acim_matmul import kernel as am_kernel
from repro_torch.kernels.acim_matmul import ops as am_ops
from repro_torch.kernels.acim_matmul import ref as am_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.maze_route import kernel as mr
from repro_torch.kernels.maze_route import ops as mr_ops
from repro_torch.kernels.maze_route import ref as mr_ref
from repro_torch.kernels.pareto_dom import ops as pd_ops
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import lm
from repro_torch.models.lm import init_lm
from repro_torch.models.registry import build_model
from repro_torch.parallel import distributed_explorer as dx
from repro_torch.quant.cim_linear import CIMConfig
from repro_torch.serve.design_service import DesignService
from repro_torch.train import acim_lm
from route_slots_model import (hub_heavy_bucket, random_bucket,
                               route_slots_model)
from wavefront_model import corridor_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _objectives(p, seed, dev, cells=2, m=4):
    """Even cells on an integer lattice, odd ones continuous with copied
    rows; the last 3 rows of each +inf."""
    rng = np.random.default_rng(seed)
    f = np.empty((cells, p, m), np.float32)
    for c in range(cells):
        if c % 2 == 0:
            f[c] = rng.integers(0, 5, (p, m))
        else:
            f[c] = rng.normal(size=(p, m))
            f[c, p // 2:p // 2 + 5] = f[c, :5]
    f[:, -3:] = np.inf
    return torch.from_numpy(f).to(dev)


# (P, cells, M): the register kernel at one warp (32), three (96, the
# migration's 8 cells), sixteen (512); the shared-memory one at 1024 and
# the device-memory one at 2048; M 1 and 8 beside 4.
@pytest.mark.parametrize("p,cells,m", [
    pytest.param(37, 2, 4, id="37"), pytest.param(512, 2, 4, id="512"),
    pytest.param(2048, 2, 4, id="2048"), pytest.param(32, 3, 4, id="32"),
    pytest.param(96, 8, 4, id="96x8"), pytest.param(1024, 2, 4, id="1024"),
    pytest.param(96, 8, 1, id="96x8-m1"), pytest.param(512, 2, 8, id="512-m8"),
    pytest.param(1024, 2, 8, id="1024-m8"),
    pytest.param(1024, 2, 1, id="1024-m1")])
def test_pareto_kernels_match_plain(p, cells, m, dev):
    f = _objectives(p, p, dev, cells, m)
    n0 = LAUNCHES["nds_rank"], LAUNCHES["dominance_matrix"]
    assert torch.equal(pd_ops.non_dominated_rank(f),
                       pareto.non_dominated_rank(f))
    assert torch.equal(pd_ops.dominance_matrix(f), pareto.dominance_matrix(f))
    assert (LAUNCHES["nds_rank"], LAUNCHES["dominance_matrix"]) == \
        (n0[0] + 1, n0[1] + 1)


def _wavefront_cases():
    """(name, occ, seed, grids) numpy inputs of the standalone wavefront:
    one-row and one-column planes, widths around a word, the sequential
    flow's per-net shape, several / occupied / no seeds, the corridors
    whose frontier leaves the rows where it began, grids smaller than
    the plane."""
    rng = np.random.default_rng(3)
    out = []
    for h, w in ((1, 274), (122, 1), (1, 1), (40, 31), (40, 32), (40, 33),
                 (40, 274), (122, 274)):
        occ = rng.random((3, h, w)) < 0.25
        seed = np.zeros_like(occ)
        for b, n in enumerate((1, 4, 0)):
            seed[b, rng.integers(0, h, n), rng.integers(0, w, n)] = True
        seed[0, 0, 0] = occ[0, 0, 0] = True           # an occupied seed
        out.append((f"{h}x{w}", occ, seed, None))
    occ = rng.random((1, 122, 274)) < 0.2             # one net of the flow
    seed = np.zeros_like(occ)
    seed[0, 61, 137] = True
    out.append(("net 122x274", occ, seed, None))
    out += [(name, occ, seed, None) for name, occ, seed in corridor_cases()]
    occ = rng.random((4, 60, 300)) < 0.2
    seed = rng.random((4, 60, 300)) < 0.002
    grids = np.array([[60, 300], [30, 33], [1, 200], [59, 1]], np.int32)
    out.append(("grids", occ, seed, grids))
    return out


def test_route_kernels_match_plain(dev):
    for name, occ, seed, grids in _wavefront_cases():
        o, s = torch.from_numpy(occ).to(dev), torch.from_numpy(seed).to(dev)
        gr = None if grids is None else torch.from_numpy(grids).to(dev)
        assert torch.equal(mr.wavefront(o, s, gr),
                           mr_ref.wavefront_distance_ref(o, s, gr)), name
    g = torch.Generator(device=dev).manual_seed(0)
    o = torch.rand((4, 122, 274), generator=g, device=dev) < 0.2
    s = torch.zeros_like(o)
    s[torch.arange(4, device=dev), torch.tensor([0, 60, 121, 7], device=dev),
      torch.tensor([0, 100, 273, 9], device=dev)] = True
    n0 = LAUNCHES["wavefront"]
    dist = mr.wavefront(o, s)
    assert LAUNCHES["wavefront"] == n0 + 1
    assert torch.equal(dist, mr_ref.wavefront_distance_ref(o, s))
    grids = torch.tensor([[100, 200], [122, 274], [50, 60], [30, 20]],
                         dtype=torch.int32, device=dev)
    assert torch.equal(mr.wavefront(o, s, grids),
                       mr_ref.wavefront_distance_ref(o, s, grids))
    big_o = torch.rand((1, 122, 1090), generator=g, device=dev) < 0.2
    big_s = torch.zeros_like(big_o)
    big_s[0, 60, 500] = True
    assert torch.equal(mr.wavefront(big_o, big_s),
                       mr_ref.wavefront_distance_ref(big_o, big_s))
    # 241 x 2178 (the 65536 array at coarse 32): bitsets in device memory
    big_o = torch.rand((2, 241, 2178), generator=g, device=dev) < 0.2
    big_s = torch.zeros_like(big_o)
    big_s[0, 120, 1000] = big_s[1, 0, 0] = big_s[1, 3, 7] = True
    big_grids = torch.tensor([[241, 2178], [100, 1500]], dtype=torch.int32,
                             device=dev)
    for gr in (None, big_grids):
        assert torch.equal(mr.wavefront(big_o, big_s, gr),
                           mr_ref.wavefront_distance_ref(big_o, big_s, gr))
    rng = np.random.default_rng(0)
    tgts = torch.tensor(np.stack([rng.integers(0, 122, (4, 2)),
                                  rng.integers(0, 274, (4, 2))], -1),
                        dtype=torch.int32, device=dev)
    tmask = torch.tensor([[True, True], [True, False]] * 2, device=dev)
    nmask = torch.tensor([True, True, True, False], device=dev)
    bufs = [[torch.zeros((4, 122, 274), dtype=torch.int32, device=dev)]
            + [torch.zeros(4, dtype=torch.int32, device=dev)
               for _ in range(3)] for _ in range(2)]
    mr.trace_paths(dist, tgts, tmask, nmask, *bufs[0])
    mr_ref.trace_paths_ref(dist, tgts, tmask, nmask, *bufs[1])
    for a, b in zip(*bufs):
        assert torch.equal(a, b)


def _bucket_on(dev, *args, shift=False, **kw):
    """`route_slots_model.random_bucket` as tensors on `dev`; with
    `shift`, counts moved by -3..3 (below 0 and above capacity)."""
    occ0, *rest = random_bucket(*args, **kw)
    if shift:
        occ0 = occ0 + np.random.default_rng(1).integers(-3, 4, occ0.shape,
                                                        dtype=np.int32)
    return [torch.from_numpy(x).to(dev) for x in (occ0, *rest)]


@pytest.mark.parametrize("seed,cap,shift", [(0, 4, False), (1, 1, False),
                                            (2, 2, True)])
def test_route_slots_matches_plain(seed, cap, shift, dev):
    """Small mixed buckets: equal to the plain version, one launch, and
    the BFS levels of the numpy model of the kernel's algorithm."""
    bucket = _bucket_on(dev, seed, [(14, 40), (20, 23), (7, 9), (16, 70)],
                        12, cap, p_full=0.25, shift=shift)
    levels = torch.zeros(4, dtype=torch.int32, device=dev)
    n0 = LAUNCHES["route_slots"]
    got = mr.route_slots(*bucket, cap, levels=levels)
    assert LAUNCHES["route_slots"] == n0 + 1
    want = mr_ref.route_slots_ref(*bucket, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    model = route_slots_model(*(x.cpu().numpy() for x in bucket), cap)
    np.testing.assert_array_equal(levels.cpu().numpy(), model[4])


@pytest.mark.parametrize("seed,grids", [
    (3, [(122, 1090), (30, 50)]),
    (5, [(241, 2178), (122, 1090), (30, 50)])])
def test_route_slots_device_memory_branch(seed, grids, dev):
    """Grids of the 65536 array beside a small one in the same bucket:
    122 x 1090 (coarse 64) keeps its counts in device memory, 241 x 2178
    (coarse 32) its bitsets too."""
    bucket = _bucket_on(dev, seed, grids, 5, 4)
    levels = torch.zeros(len(grids), dtype=torch.int32, device=dev)
    got = mr.route_slots(*bucket, 4, levels=levels)
    want = mr_ref.route_slots_ref(*bucket, 4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[1][0]) > 0
    model = route_slots_model(*(x.cpu().numpy() for x in bucket), 4)
    np.testing.assert_array_equal(levels.cpu().numpy(), model[4])


# A fresh process whose first `route_slots` launches come from eight
# threads at once, each on a bucket of another grid size (so another
# dynamic shared-memory size), as the service's layout pool's first
# buckets do; prints the errors and whether each thread's results equal
# its bucket's single-thread ones.
_FIRST_LAUNCH_SCRIPT = """
import json, threading, numpy as np, torch
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.maze_route import kernel as mr
from repro_torch.kernels.maze_route import ops as mr_ops
from route_slots_model import random_bucket
sizes = [[(8, 9)], [(120, 270)], [(14, 40), (20, 23)], [(100, 200)]] * 2
buckets = [[torch.from_numpy(x).cuda() for x in random_bucket(10 + i, g, 4, 4)]
           for i, g in enumerate(sizes)]
torch.cuda.synchronize()
errors, got, start = [], {}, threading.Barrier(len(sizes))
def worker(i):
    try:
        start.wait()
        got[i] = [mr.route_slots(*buckets[i], 4) for _ in range(20)]
    except Exception as e:
        errors.append(repr(e))
threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
for t in threads: t.start()
for t in threads: t.join(timeout=300)
want = [mr.route_slots(*b, 4) for b in buckets]
equal = all(torch.equal(a, b) for i, rs in got.items() for r in rs
            for a, b in zip(r, want[i]))
print(json.dumps({"errors": errors, "equal": equal, "threads": len(got),
                  "launches": LAUNCHES["route_slots"]}))
"""


def test_route_slots_first_launches_from_threads(dev):
    """Three fresh processes each make their first `route_slots` launches
    from eight threads at once: no launch fails, every result equals its
    bucket's single-thread one, the count is exact.  (With the kernel's
    shared-memory limit set per launch to the launch's own size, the
    first launches, convoyed behind the module's lazy load, let one
    thread's smaller size land between another's setting and its launch,
    which then failed with cudaErrorInvalidValue.)"""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    here = pathlib.Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(here.parent / "src"), str(here)])}
    for _ in range(3):
        out = subprocess.run([sys.executable, "-c", _FIRST_LAUNCH_SCRIPT],
                             capture_output=True, text=True, timeout=300,
                             env=env)
        assert out.returncode == 0, out.stderr[-2000:]
        report = json.loads(out.stdout.strip().splitlines()[-1])
        assert report["errors"] == [] and report["threads"] == 8
        assert report["equal"]
        assert report["launches"] == 8 * 20 + 8


def test_route_slots_past_16k_slots(dev):
    """16,400 slots of two targets (T S = 32,800; 23,540 masked): the
    counts stay exact in 16 bits.  The same bucket's model equals the
    plain version on the CPU (`test_torch_route_slots.py`)."""
    bucket = _bucket_on(dev, 6, [(9, 40)], 16_400, 4, p_full=0.1)
    levels = torch.zeros(1, dtype=torch.int32, device=dev)
    got = mr.route_slots(*bucket, 4, levels=levels)
    model = route_slots_model(*(x.cpu().numpy() for x in bucket), 4)
    for g, w in zip((*got, levels), model):
        np.testing.assert_array_equal(g.cpu().numpy(), w)
    assert int(got[1][0]) > 0


def test_route_slots_past_32k_targets(dev):
    """51,000 masked targets a grid (2 A + 1 > 2^16 - 1): uint32 counts in
    device memory, a hub's count past 2^16.  Routed, failed, wirelength,
    occupancy and BFS levels equal the numpy model and the plain version
    (the model equals the plain version on the CPU too,
    `test_torch_route_slots.py`)."""
    bucket = [torch.from_numpy(x).to(dev) for x in hub_heavy_bucket()]
    levels = torch.zeros(2, dtype=torch.int32, device=dev)
    n0 = LAUNCHES["route_slots"]
    got = mr.route_slots(*bucket, 4, levels=levels)
    assert LAUNCHES["route_slots"] == n0 + 1
    model = route_slots_model(*(x.cpu().numpy() for x in bucket), 4)
    for g, w in zip((*got, levels), model):
        np.testing.assert_array_equal(g.cpu().numpy(), w)
    for g, w in zip(got, mr_ref.route_slots_ref(*bucket, 4)):
        assert torch.equal(g, w)
    assert int(got[1].min()) > 0 and int(got[2].min()) > 0


def test_maze_route_refuses_grids_past_the_word_limit(dev):
    """2^22 bitset words in one grid (4096 x 32768) is past what the
    kernels' index arithmetic takes: both wrappers raise."""
    occ = torch.zeros((1, 4096, 32768), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="bitset words"):
        mr.wavefront(occ, occ)
    del occ
    i32 = dict(dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bitset words"):
        mr.route_slots(torch.zeros((1, 4096, 32768), **i32),
                       torch.zeros((1, 1, 2), **i32),
                       torch.zeros((1, 1, 2, 2), **i32),
                       torch.ones((1, 1, 2), dtype=torch.bool, device=dev),
                       torch.ones((1, 1), dtype=torch.bool, device=dev),
                       torch.tensor([[4096, 32768]], **i32), 4)


def test_route_slots_refuses_bad_inputs(dev):
    occ0, hubs, tgts, tmask, nmask, grids = _bucket_on(
        dev, 4, [(14, 40), (7, 9)], 6, 4)
    args = [occ0, hubs, tgts, tmask, nmask, grids]
    bad = {0: occ0.float(), 1: hubs.cpu(), 2: tgts[:, :, :1].contiguous()
           .expand(-1, -1, 2, -1), 4: nmask.int(), 5: grids.cpu()}
    for i, x in bad.items():
        with pytest.raises(ValueError):
            mr.route_slots(*(x if j == i else a for j, a in enumerate(args)),
                           4)
    wide = tgts[:, :, :1].expand(-1, -1, 33, -1).contiguous()
    with pytest.raises(ValueError):
        mr.route_slots(occ0, hubs, wide, tmask[:, :, :1].expand(-1, -1, 33)
                       .contiguous(), nmask, grids, 4)
    with pytest.raises(ValueError, match="outside"):
        mr.route_slots(occ0, hubs + 40, tgts, tmask, nmask, grids, 4)


def test_session_on_cuda_equals_cpu_rows(dev):
    """Same specs, same rows: the kernels route exactly like the plain
    versions (the fronts may differ: CUDA and CPU Philox streams do)."""
    req = DesignRequest(array_size=4096, pop_size=64, generations=10,
                        requirements=Requirements(min_snr_db=17.0,
                                                  min_tops=0.4))
    LAUNCHES.clear()
    art = DesignSession().run(req)
    # one explore dispatch: one nsga2_evolve launch runs every generation
    assert LAUNCHES["nsga2_evolve"] == 1 and LAUNCHES["nds_rank"] == 0
    assert LAUNCHES["route_slots"] == 1
    assert LAUNCHES["wavefront"] == LAUNCHES["trace_paths"] == 0
    cpu = DesignSession(device="cpu").layout(art.pareto.specs)
    assert list(art.layout_rows) == cpu.metrics_rows()


# The reference's flow-equivalence specs (every BatchDims axis padded);
# their bucket takes BFS lanes and crossings in the concurrent engine.
LAYOUT_SPECS = ((64, 16, 2, 3), (128, 32, 4, 3), (256, 16, 8, 3),
                (128, 8, 4, 2), (64, 8, 2, 5))


def test_concurrent_engine_on_cuda_equals_scan_and_cpu(dev):
    """The concurrent engine on the card: full fields by one `wavefront`
    launch a round with BFS lanes, giving the scan engine's rows and
    occupancy and the CPU engine's (early-exit) schedule; also at
    capacity 1, where collisions force retries."""
    specs = [MacroSpec(*s) for s in LAYOUT_SPECS]
    for capacity in (4, 1):
        LAUNCHES.clear()
        got = bf.generate_layouts(specs, capacity=capacity,
                                  engine="concurrent", record_schedule=True)
        sched = got.routing.schedule
        assert LAUNCHES["wavefront"] == sum(1 for n in sched.bfs_lanes if n)
        assert LAUNCHES["wavefront"] > 0 and LAUNCHES["route_slots"] == 0
        scan = bf.generate_layouts(specs, capacity=capacity)
        assert scan.routing.engine == "scan"
        assert got.metrics_rows() == scan.metrics_rows()
        np.testing.assert_array_equal(got.routing.occ_count,
                                      scan.routing.occ_count)
        cpu = bf.generate_layouts(specs, capacity=capacity,
                                  engine="concurrent", device="cpu",
                                  record_schedule=True)
        want = cpu.routing.schedule
        assert sched.dispatches == want.dispatches
        assert sched.bfs_lanes == want.bfs_lanes
        assert (sched.rounds, sched.collisions, sched.crossings) == \
            (want.rounds, want.collisions, want.crossings)
        assert got.metrics_rows() == cpu.metrics_rows()


def test_router_on_cuda_equals_cpu(dev):
    """`router.route` on the card: one `wavefront` launch per net of two
    or more pins, the CPU route's wires, failures and wirelength; a host
    impl given a CUDA tensor raises instead of copying it."""
    spec = MacroSpec(128, 32, 4, 3)
    p = placer.place(spec)
    nets = flow._top_level_nets(spec, p)
    for capacity in (4, 1):
        LAUNCHES.clear()
        got = router.route(p, nets, capacity=capacity)
        assert LAUNCHES["wavefront"] == \
            sum(1 for _, pins in nets if len(pins) >= 2)
        want = router.route(p, nets, capacity=capacity, device="cpu")
        assert got.wires == want.wires and got.failed == want.failed
        assert got.total_wirelength == want.total_wirelength
    LAUNCHES.clear()
    lr = flow.generate_layout(spec)
    assert LAUNCHES["wavefront"] == len(nets)
    cpu = flow.generate_layout(spec, device="cpu")
    m, w = lr.metrics(), cpu.metrics()
    del m["elapsed_s"], w["elapsed_s"]
    assert m == w and lr.routing.wires == cpu.routing.wires
    occ = torch.zeros((1, 8, 8), dtype=torch.bool, device=dev)
    for impl in ("frontier", "bfs"):
        with pytest.raises(ValueError, match="host engine"):
            mr_ops.wavefront_distance(occ, occ, impl=impl)


def _evolve_inputs(dev, sizes, pop, gens):
    space = nsga2.stack_spaces([nsga2.space_operands(
        nsga2.NSGA2Config(array_size=s)) for s in sizes]).to(dev)
    statics = nsga2.EvolveStatics(pop_size=pop)
    draws = nsga2.PhiloxDraws(range(len(sizes)), dev)
    genes = nsga2.init_population_op(draws.init(
        space.gene_lo.cpu().numpy(), space.gene_hi.cpu().numpy(), pop), space)
    objs = nsga2.evaluate_op(genes, space)
    return space, statics, genes, objs, draws.generations(gens, pop, pop,
                                                          statics)


@pytest.mark.parametrize("sizes,pop,gens", [
    ((16384,), 256, 80),                  # the 16 kb request's dispatch
    ((16384,), 96, 25),                   # the codesign pick's
    ((4096, 16384, 65536), 256, 20),      # a batch of cells
    ((16384,), 100, 15),                  # 2 P = 200: words padded
    ((16384, 4096), 512, 6),              # dominance words in device memory
    ((16384,), 1024, 3),                  # all state in device memory
    ((16384,) * 8, 96, 10),               # an island block (8 islands)
    ((16384,) * 4, 256, 20)])             # the island request's block
def test_nsga2_evolve_matches_composite(sizes, pop, gens, dev):
    """Every generation in one launch: final genes, objectives and ranks
    bit-equal to the composite loop (torch ops and one nds_rank launch a
    generation) on the same draws."""
    space, statics, genes, objs, draws = _evolve_inputs(dev, sizes, pop,
                                                        gens)
    fronts = torch.zeros(len(sizes), dtype=torch.int32, device=dev)
    n0 = LAUNCHES["nsga2_evolve"]
    got = pd_ops.nsga2_evolve(draws, genes, objs, space, statics,
                              fronts=fronts)
    assert LAUNCHES["nsga2_evolve"] == n0 + 1
    want = nsga2.evolve_composite(nsga2.StackedDraws(draws), genes, objs,
                                  space, statics, gens)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[2], pareto.non_dominated_rank(got[1]))
    assert int(fronts.min()) > gens


def test_dominance_route_keeps_the_composite(dev):
    """`use_pallas_dominance` without `use_pallas_rank` runs the composite
    loop with the dominance_matrix kernel, not nsga2_evolve."""
    req = DesignRequest(array_size=4096, pop_size=64, generations=5,
                        use_pallas_dominance=True, layout=False)
    LAUNCHES.clear()
    DesignSession().run(req)
    assert LAUNCHES["dominance_matrix"] == 6 and LAUNCHES["nsga2_evolve"] == 0


def test_design_service_pool_launch_counts(dev):
    """`DesignService(layout_workers=4)` serves four small requests on the
    card from its stage threads and a 4-wide layout pool: summaries equal
    a second session's `run_many(strict=False)`, and the launch counts
    are exact: one `nsga2_evolve` per explore dispatch, one `route_slots`
    per layout attempt, no `nds_rank` / `wavefront` / `trace_paths`."""
    small = dict(pop_size=64, generations=10)
    reqs = [DesignRequest(array_size=4096, seed=s, **small,
                          requirements=Requirements(min_snr_db=17.0,
                                                    min_tops=0.4))
            for s in (0, 1)]
    reqs += [DesignRequest(array_size=16384, seed=0, **small,
                           requirements=Requirements(min_snr_db=25.0,
                                                     min_tops=1.0)),
             DesignRequest(array_size=4096, seed=3, **small,
                           requirements=Requirements(min_tops=1e9))]
    seq = DesignSession().run_many(reqs, strict=False)
    svc = DesignService(max_coalesce=2, coalesce_window_s=0.2,
                        layout_workers=4)
    names = ("nsga2_evolve", "route_slots", "nds_rank", "wavefront",
             "trace_paths")
    n0 = {k: LAUNCHES[k] for k in names}
    with svc.serve():
        tickets = [svc.submit(r) for r in reqs]
        arts = [svc.collect(t, timeout=600) for t in tickets]
    torch.cuda.synchronize()
    got = {k: LAUNCHES[k] - n0[k] for k in names}
    for r, a in zip(reqs, arts):
        assert a.summary() == seq[r].summary()
        assert a.ok == seq[r].ok and a.provenance.pipelined
    assert not arts[3].ok and "removed every Pareto point" in arts[3].error
    stats = svc.stats()
    assert stats["service_batches"] == 2
    assert got["nsga2_evolve"] == stats["explorer_dispatches"] == 2
    # no faults: every layout attempt is a dispatch of its own
    assert stats["bucket_retries"] == stats["shed_buckets"] == 0
    assert got["route_slots"] == stats["layout_dispatches"] >= 3
    assert got["nds_rank"] == got["wavefront"] == got["trace_paths"] == 0


def _acim_route(route, x, w, spec):
    """`ops.acim_matmul`'s padding, then the wrapper of `route`."""
    n, b = spec.n_caps, spec.b_adc
    k, c = w.shape
    wp = torch.nn.functional.pad(w, (0, (-c) % 4, 0, (-k) % n))
    xp = torch.nn.functional.pad(x, (0, (-k) % n)).contiguous()
    if route == "mma":       # K to a multiple of 4 too, as ops pads it
        kp = (-k) % max(n, 4)
        wp = torch.nn.functional.pad(w, (0, (-c) % 4, 0, kp))
        xp = torch.nn.functional.pad(x, (0, kp)).contiguous()
    fn = {"wgmma": am_kernel.acim_matmul_wgmma,
          "mma": am_kernel.acim_matmul_mma,
          "cuda_core": am_kernel.acim_matmul_cuda_core}[route]
    return fn(xp, wp.contiguous(), n, b)[:, :c]


# (route, spec): the wgmma route takes N % 16 == 0: N 16 (a chunk of one
# k16 step), 48 (not a power of two: no split-K), 128, 256 (the pick),
# 2048 (a chunk longer than the k-tile); the mma route N 8, 4 and 2 (a
# k8 step one chunk, two or four, the 1 kb front's N 8 / B 3 and N 4 /
# B 2, and its N 8 / B 1, where every +-1 chunk sum of -4 lies on an ADC
# decision boundary before the mismatch and the kernel joins the hi
# product apart); the CUDA-core route any N.
ACIM_ROUTE_SPECS = [
    ("wgmma", (256, 64, 2, 5)), ("wgmma", (512, 32, 2, 4)),
    ("wgmma", (32, 64, 2, 3)), ("wgmma", (96, 64, 2, 4)),
    ("wgmma", (4096, 64, 2, 6)),
    ("mma", (128, 8, 16, 3)), ("mma", (128, 8, 32, 2)),
    ("mma", (64, 16, 32, 1)), ("mma", (128, 8, 16, 1)),
    ("cuda_core", (256, 64, 2, 5)), ("cuda_core", (512, 32, 2, 4)),
    ("cuda_core", (8, 64, 2, 2)), ("cuda_core", (48, 64, 2, 3))]


# Macros whose mismatch-folded outputs are also held within 1e-3 of the
# plain version's.  At N 16, B 3 every +-1 chunk sum = 2 mod 4 lies on an
# ADC boundary before the mismatch, so the plain version's own float32
# sums flip 1.2e-3 of the (1024, 3072, 768) outputs against the exact
# ones (H100 run); there, and everywhere, the bound is held against the
# exact (float64) macro.
ACIM_PLAIN_BOUND_SPECS = [MacroSpec(256, 64, 2, 5), MacroSpec(512, 32, 2, 4),
                          MacroSpec(8, 64, 2, 2), MacroSpec(128, 8, 16, 3),
                          MacroSpec(128, 8, 32, 2), MacroSpec(64, 16, 32, 1),
                          MacroSpec(128, 8, 16, 1)]


@pytest.mark.parametrize("m,k,c", [(1024, 768, 3072), (1024, 3072, 768),
                                   (37, 100, 70), (5, 64, 130)])
@pytest.mark.parametrize("route,spec", ACIM_ROUTE_SPECS, ids=str)
def test_acim_matmul_matches_plain(m, k, c, route, spec, dev):
    """+-1 operands: bit-equal.  Mismatch-folded weights, with +-1 and
    with float activations in [-1, 1]: the chunk sums differ in summation
    order only, so outputs differ by whole ADC steps where a sum lies
    within rounding of a decision boundary: on <= 0.1 % of outputs
    against the exact macro (and against the plain version, for
    `ACIM_PLAIN_BOUND_SPECS`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = MacroSpec(*spec)
    n, b = spec.n_caps, spec.b_adc
    g = torch.Generator(device=dev).manual_seed(m + k + c)
    x = torch.where(torch.rand((m, k), generator=g, device=dev) < 0.5,
                    1.0, -1.0)
    w = torch.where(torch.rand((k, c), generator=g, device=dev) < 0.5,
                    1.0, -1.0)
    n0 = (LAUNCHES["acim_matmul"], LAUNCHES[f"acim_matmul_{route}"])
    got = _acim_route(route, x, w, spec)
    assert (LAUNCHES["acim_matmul"], LAUNCHES[f"acim_matmul_{route}"]) == \
        (n0[0] + 1, n0[1] + 1)
    assert torch.equal(got, am_ref.acim_matmul_ref(x, w, n=n, b_adc=b))
    assert torch.equal(am_ops.acim_matmul(x, w, spec), got)   # ops' route
    eps = torch.randn((k, c), generator=g, device=dev)
    wm = am_ops.mismatch_weights(w, spec, eps, NoiseParams.from_cal())
    xf = torch.rand((m, k), generator=g, device=dev) * 2 - 1
    delta = 2 * n / 2 ** b
    for xx in (x, xf):
        got_m = _acim_route(route, xx, wm, spec)
        steps = (got_m - am_ref.acim_matmul_ref(xx, wm, n=n, b_adc=b)) / delta
        assert torch.allclose(steps, steps.round(), atol=1e-3)
        if spec in ACIM_PLAIN_BOUND_SPECS:
            assert float((steps != 0).float().mean()) <= 1e-3
        off = (got_m.double() - _acim_exact(xx, wm, n, b)).abs() > delta / 2
        assert float(off.double().mean()) <= 1e-3


def _acim_exact(x, w, n, b):
    """The macro's output with every chunk sum exact (float64)."""
    pad = (-x.shape[1]) % n
    x = torch.nn.functional.pad(x.double(), (0, pad))
    w = torch.nn.functional.pad(w.double(), (0, 0, 0, pad))
    kc = x.shape[1] // n
    s = torch.einsum("mck,ckj->mcj", x.reshape(x.shape[0], kc, n),
                     w.reshape(kc, n, w.shape[1]))
    delta = 2.0 * n / 2 ** b
    code = torch.round(s / delta).clamp(-(2.0 ** (b - 1)), 2.0 ** (b - 1) - 1)
    return (code * delta).sum(1)


def test_acim_matmul_wgmma_splits_k(dev):
    """The FFN's down projection takes split-K on the card; every split
    factor gives the same bits on +-1 operands (N a power of two)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert am_kernel.split_k(1024, 768, 3072, 256, sms) > 1
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.where(torch.rand((1024, 3072), generator=g, device=dev) < 0.5,
                    1.0, -1.0)
    w = torch.where(torch.rand((3072, 768), generator=g, device=dev) < 0.5,
                    1.0, -1.0)
    want = am_ref.acim_matmul_ref(x, w, n=256, b_adc=4)
    for splits in (1, 2, 5, 12):
        assert torch.equal(am_kernel.acim_matmul_wgmma(x, w, 256, 4, splits),
                           want)


def test_acim_matmul_mma_splits_k(dev):
    """The FFN's down projection takes split-K on the mma route; every
    split factor gives the same bits on +-1 operands, and a ragged K / C
    (zero k-tiles past K, columns past C) too."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert am_kernel.mma_split_k(1024, 768, 3072, sms) > 1
    g = torch.Generator(device=dev).manual_seed(2)
    for m, k, c in ((1024, 3072, 768), (200, 1000, 100)):
        x = torch.where(torch.rand((m, k), generator=g, device=dev) < 0.5,
                        1.0, -1.0)
        w = torch.where(torch.rand((k, c), generator=g, device=dev) < 0.5,
                        1.0, -1.0)
        for n, b in ((8, 3), (4, 2), (2, 1), (8, 1), (4, 1)):
            want = am_ref.acim_matmul_ref(x, w, n=n, b_adc=b)
            for splits in (1, 2, 3, 7):
                assert torch.equal(
                    am_kernel.acim_matmul_mma(x, w, n, b, splits), want)


def test_trainer_forward_runs_the_mma_route(dev):
    """A CIM trainer forward on MacroSpec(128, 8, 16, 3) (N 8, B 3, a
    point of the 1 kb exhaustive front): every acim_matmul launch is on
    the mma route, two per layer, and the loss equals the CPU's within
    the step-0 check's rtol."""
    cfg = acim_lm.build_cfg(64, 2)
    cim = CIMConfig(MacroSpec(128, 8, 16, 3))
    batch = batch_for(cfg, 32, 2, 0)
    losses = []
    for d in (dev, torch.device("cpu")):
        model = init_lm(cfg, seed=0, device=d)
        LAUNCHES.clear()
        with torch.no_grad():
            losses.append(float(acim_lm.loss_fn(
                model, {k: v.to(d) for k, v in batch.items()}, cfg, cim)))
        if d.type == "cuda":
            assert LAUNCHES["acim_matmul"] == LAUNCHES["acim_matmul_mma"] \
                == 2 * cfg.n_layers
            assert LAUNCHES["acim_matmul_wgmma"] == 0
            assert LAUNCHES["acim_matmul_cuda_core"] == 0
    assert np.isfinite(losses[0])
    assert abs(losses[0] - losses[1]) <= 1e-2 * abs(losses[1])


def test_trainer_forward_runs_the_wgmma_route(dev):
    """A CIM trainer forward at the pick's N 256: every acim_matmul
    launch is on the wgmma route, two per layer."""
    cfg = acim_lm.build_cfg(64, 2)
    cim = CIMConfig(MacroSpec(512, 32, 2, 4))
    model = init_lm(cfg, seed=0, device=dev)
    batch = batch_for(cfg, 32, 2, 0, device=dev)
    LAUNCHES.clear()
    with torch.no_grad():
        loss = float(acim_lm.loss_fn(model, batch, cfg, cim))
    assert np.isfinite(loss)
    assert LAUNCHES["acim_matmul"] == LAUNCHES["acim_matmul_wgmma"] \
        == 2 * cfg.n_layers
    assert LAUNCHES["acim_matmul_cuda_core"] == 0


@pytest.mark.parametrize("p", [64, 100, 512, 1024])
@pytest.mark.parametrize("m", [1, 2, 4, 5, 8])
def test_dominance_matrix_matches_plain(p, m, dev):
    """Bit-equal at P 64-1024, M 1-8, three cells (ties, repeats, +inf
    pad rows; P 100 takes the byte stores)."""
    rng = np.random.default_rng(p * 10 + m)
    f = rng.integers(0, 4, (3, p, m)).astype(np.float32)
    f[1] = rng.normal(size=(p, m))
    f[2, p // 2:p // 2 + 5] = f[2, :5]
    f[:, -3:] = np.inf
    f = torch.from_numpy(f).to(dev)
    n0 = LAUNCHES["dominance_matrix"]
    assert torch.equal(pd_ops.dominance_matrix(f), pareto.dominance_matrix(f))
    assert LAUNCHES["dominance_matrix"] == n0 + 1


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bfloat16 numbers (8 significant bits) at |x|."""
    _, e = torch.frexp(x.abs())
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


TC_FLIP_SHARE = 1e-4    # as chip_smoke.py


def _ulps(got, want):
    """|got - want| less 2e-5 in bf16 ulps of each element and of its
    row's largest output."""
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs())
    over = torch.clamp((got - want).abs() - 2e-5, min=0)
    _, ee = torch.frexp(big)
    _, er = torch.frexp(big.amax(-1, keepdim=True))
    return (over / torch.ldexp(torch.ones_like(over), ee - 8),
            over / torch.ldexp(torch.ones_like(over[..., :1]), er - 8))


def _assert_tc_close(got, q, k, v, **kw):
    """The tensor-core route against `flash_attention_tc_ref`, as
    chip_smoke.py's `_tc_check`.  Both round P to bf16, but reach p in
    float32 by different summation orders and exp2s, so a p near a bf16
    rounding midpoint may round the other way, which moves a row with few
    visible keys by many ulps of its small elements.  So: the kernel's own
    P (its P-dumping launch, same output) is at most one bf16 step from
    the plain version's; the plain version fed that P is within two bf16
    ulps of every output element plus 2e-5; against the plain version's
    own P at most `TC_FLIP_SHARE` of the outputs lie beyond that, each
    within one ulp of its row's largest output plus 2e-5.  Measured on
    the H100 by chip_smoke.py, with the plain version summing the scores
    as the tensor cores do (`ref.tc_scores`): P one step apart on 2.0e-6
    to 8.4e-6 of the visible entries at head dims 64 and 128 and 1.5e-5
    to 2.1e-5 at 256 (3.6e-5 to 1.4e-4 with float32 sums); fed the
    kernel's P, <= 0.995 element ulps; outputs beyond two ulps 0 to
    2.6e-5, each <= 0.23 row ulps."""
    out_p, p = fa_kernel.flash_attention_wgmma_p(q, k, v, **kw)
    assert torch.equal(out_p, got)
    step = (p.view(torch.int16)
            - fa_ref.flash_attention_tc_p(q, k, v, **kw).view(torch.int16))
    assert int(step.abs().max()) <= 1
    el, _ = _ulps(got, fa_ref.flash_attention_tc_ref(q, k, v, p_bf16=p, **kw))
    assert float(el.max()) <= 2, float(el.max())
    el, row = _ulps(got, fa_ref.flash_attention_tc_ref(q, k, v, **kw))
    exc = el > 2
    assert int(exc.sum()) <= TC_FLIP_SHARE * got.numel(), int(exc.sum())
    assert not bool(exc.any()) or float(row[exc].max()) <= 1


@pytest.mark.parametrize("b,s,h,kv,dh,causal,prefix_len", [
    (1, 1024, 16, 2, 128, True, 0), (2, 4001, 4, 1, 64, True, 0),
    (2, 333, 8, 8, 32, False, 0), (3, 200, 4, 2, 16, True, 70),
    (1, 129, 2, 1, 128, True, 129)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_matches_plain(b, s, h, kv, dh, causal, prefix_len,
                                       dtype, dev):
    """Each route against its own plain version.  float32 (3xTF32 tensor
    cores): atol = rtol = 2e-5.  bf16 at head dims 16 and 32 (3xTF32):
    both compute in float32 and round once, so one bf16 ulp of the output
    plus 2e-5.  bf16 at head dims 64 and 128 (bf16 tensor cores): against
    `flash_attention_tc_ref` as `_assert_tc_close` holds it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(s + dh)
    q = torch.randn((b, s, h, dh), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, s, kv, dh), generator=g, device=dev).to(dtype)
            for _ in range(2))
    tc = fa_kernel.route(dtype, dh) == "wgmma"
    n0 = dict(LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, causal=causal, prefix_len=prefix_len)
    for key, n in (("flash_attention", 1), ("flash_attention_wgmma", tc),
                   ("flash_attention_tf32x3", 1 - tc)):
        assert LAUNCHES[key] == n0.get(key, 0) + n, key
    plain = fa_ref.flash_attention_tc_ref if tc else fa_ref.flash_attention_ref
    want = plain(q, k, v, causal=causal, prefix_len=prefix_len)
    if prefix_len == 0:    # strides the kernel cannot read: ops copies
        wide = torch.randn((b, s, h, dh + 4), generator=g, device=dev)
        qs = wide.to(dtype)[..., :dh]
        assert not fa_kernel.kernel_layout_ok(qs)
        assert torch.equal(
            fa_ops.flash_attention(qs, k, v, causal=causal),
            fa_ops.flash_attention(qs.contiguous(), k, v, causal=causal))
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    elif tc:
        _assert_tc_close(got, q, k, v, causal=causal, prefix_len=prefix_len)
    else:
        bound = _bf16_ulp(torch.maximum(got.abs(), want.abs())) + 2e-5
        assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("b,s,h,kv,dh,causal,prefix_len", [
    (1, 512, 16, 2, 128, True, 0),      # GQA 8, the prefill's ratio
    (2, 4001, 8, 2, 64, True, 0),       # GQA 4, ragged S
    (1, 129, 4, 4, 128, True, 0),       # GQA 1, one row past a tile
    (2, 300, 4, 1, 64, True, 300),      # prefix = S
    (2, 777, 8, 2, 128, True, 200),     # prefix inside the sequence
    (2, 333, 8, 2, 64, False, 0),       # no mask
    (1, 100, 2, 1, 128, False, 0),      # fewer keys than one tile
    (2, 300, 4, 2, 128, True, 150),     # 1-3 key tiles, a prefix inside one
    (1, 384, 4, 1, 64, False, 0)], ids=str)   # three key tiles, unmasked
def test_flash_attention_wgmma_matches_tc_plain(b, s, h, kv, dh, causal,
                                               prefix_len, dev):
    """The tensor-core kernel against `flash_attention_tc_ref`, also on
    q and k as RoPE leaves them (heads-major memory read through
    strides), and its launch counter; rel L2 against the float32-P
    `flash_attention_ref` at most 1e-2."""
    g = torch.Generator(device=dev).manual_seed(s + dh + prefix_len)
    q = torch.randn((b, h, s, dh), generator=g, device=dev).bfloat16()
    k = torch.randn((b, kv, s, dh), generator=g, device=dev).bfloat16()
    v = torch.randn((b, s, kv, dh), generator=g, device=dev).bfloat16()
    q, k = q.transpose(1, 2), k.transpose(1, 2)        # RoPE's layout
    assert fa_kernel.kernel_layout_ok(q) and not q.is_contiguous()
    n0 = LAUNCHES["flash_attention_wgmma"]
    got = fa_kernel.flash_attention_wgmma(q, k, v, causal=causal,
                                          prefix_len=prefix_len)
    assert LAUNCHES["flash_attention_wgmma"] == n0 + 1
    _assert_tc_close(got, q, k, v, causal=causal, prefix_len=prefix_len)
    assert torch.equal(got, fa_kernel.flash_attention_wgmma(
        q.contiguous(), k.contiguous(), v, causal=causal,
        prefix_len=prefix_len))
    f32p = fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                      prefix_len=prefix_len).float()
    assert float((got.float() - f32p).norm() / f32p.norm()) <= 1e-2


def _qkv_t(dev, seed, b, s, t, h, kv, dh, dv, dtype):
    """q (B, S, H, Dh), k (B, T, KV, Dh), v (B, T, KV, Dv) normals."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, s, h, dh), (b, t, kv, dh), (b, t, kv, dv))]


T_NOT_S = [(1000, 333, True), (333, 1000, True), (777, 1201, False),
           (1200, 77, False), (130, 4001, True)]     # ragged T: no whole tile
# the tensor-core kernel's pipeline edges (its prologue issues S of the
# first key tile alone, its epilogue P.V of the last alone): fewer keys
# than one tile, two key tiles, three (an odd count), and causal query
# tiles of one, two and three key tiles (at 256 / 256's 64-key tiles:
# two, three, five, and two to five)
TILE_EDGES = [(300, 100, False), (300, 192, False), (100, 300, False),
              (257, 300, True)]


@pytest.mark.parametrize("s,t,causal", T_NOT_S, ids=str)
@pytest.mark.parametrize("dtype,dh", [(torch.float32, 128),
                                      (torch.float32, 64),
                                      (torch.float32, 16),
                                      (torch.bfloat16, 32)], ids=str)
def test_flash_attention_tf32x3_at_t_other_than_s(s, t, causal, dtype, dh,
                                                  dev):
    """The 3xTF32 kernel with k / v longer or shorter than q (causal keeps
    key c for query r when c <= r, as the TPU kernel's oracle): against
    `flash_attention_ref` and the naive `attention_ref`, float32 at atol =
    rtol = 2e-5, bf16 within one bf16 ulp + 2e-5, and its launch count."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, kv = 2, 4, 2
    q, k, v = _qkv_t(dev, s + t + dh, b, s, t, h, kv, dh, dh, dtype)
    n0 = dict(LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    for key in ("flash_attention", "flash_attention_tf32x3"):
        assert LAUNCHES[key] == n0.get(key, 0) + 1, key
    assert LAUNCHES.get("flash_attention_wgmma", 0) == n0.get(
        "flash_attention_wgmma", 0)
    naive = fa_ref.attention_ref(
        *(x.permute(0, 2, 1, 3).repeat_interleave(rep, 1).reshape(
            b * h, -1, dh) for x, rep in ((q, 1), (k, h // kv), (v, h // kv))),
        causal=causal).reshape(b, h, s, dh).permute(0, 2, 1, 3)
    for want in (fa_ref.flash_attention_ref(q, k, v, causal=causal), naive):
        g32, w32 = got.float(), want.float()
        if dtype == torch.float32:
            torch.testing.assert_close(g32, w32, atol=2e-5, rtol=2e-5)
        else:
            bound = _bf16_ulp(torch.maximum(g32.abs(), w32.abs())) + 2e-5
            assert bool(((g32 - w32).abs() <= bound).all())


@pytest.mark.parametrize("q_scale", [1.0, 4.0])
@pytest.mark.parametrize("b,s,dh", [(4, 4096, 128), (4, 4096, 64),
                                    (1, 32768, 128)], ids=str)
def test_flash_attention_tf32x3_at_long_rows(b, s, dh, q_scale, dev):
    """The 3xTF32 kernel where its sums are longest (4096 and 32768 keys,
    causal, H 16, KV 2) and with q scaled by 4 (scores of magnitude ~30,
    a peaked softmax): against `flash_attention_ref` at atol = rtol =
    2e-5.  The tensor cores round each `wgmma`'s sum toward zero, so O
    kept in their accumulator across all the key tiles drifted past this
    bound (1.45x at 4096 keys, 5.9x at 32768, with q scaled by 4); the
    kernel moves O into float32 every tile at head dim 64 and every 512
    keys at 128 (`csrc/flash_attention.cu`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(s + dh)
    q = torch.randn((b, s, 16, dh), generator=g, device=dev) * q_scale
    k, v = (torch.randn((b, s, 2, dh), generator=g, device=dev)
            for _ in range(2))
    n0 = LAUNCHES["flash_attention_tf32x3"]
    got = fa_ops.flash_attention(q, k, v, causal=True)
    assert LAUNCHES["flash_attention_tf32x3"] == n0 + 1
    torch.testing.assert_close(got, fa_ref.flash_attention_ref(q, k, v),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,t,causal", T_NOT_S + TILE_EDGES, ids=str)
@pytest.mark.parametrize("dh,dv", fa_kernel.TC_DIM_PAIRS, ids=str)
def test_flash_attention_wgmma_at_t_other_than_s(s, t, causal, dh, dv, dev):
    """Every bf16 tensor-core instantiation with k / v longer or shorter
    than q, and at the edges of its pipeline (`TILE_EDGES`): against
    `flash_attention_tc_ref` as `_assert_tc_close` holds it, rel L2
    against the float32-P `flash_attention_ref` at most 1e-2, and its
    launch counts."""
    q, k, v = _qkv_t(dev, s + t + dh + dv, 1, s, t, 4, 2, dh, dv,
                     torch.bfloat16)
    n0 = dict(LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    for key in ("flash_attention", "flash_attention_wgmma",
                f"flash_attention_wgmma_{dh}_{dv}"):
        assert LAUNCHES[key] == n0.get(key, 0) + 1, key
    assert tuple(got.shape) == (1, s, 4, dv)
    _assert_tc_close(got, q, k, v, causal=causal, prefix_len=0)
    f32p = fa_ref.flash_attention_ref(q, k, v, causal=causal).float()
    assert float((got.float() - f32p).norm() / f32p.norm()) <= 1e-2


def test_flash_attention_reads_expanded_kv(dev):
    """GQA heads made by `expand` (stride 0, which a tensor map cannot
    take): ops copies them, on both routes."""
    g = torch.Generator(device=dev).manual_seed(5)
    for dtype, dh in ((torch.bfloat16, 128), (torch.float32, 64)):
        q = torch.randn((2, 300, 4, dh), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((2, 300, 1, dh), generator=g, device=dev)
                .to(dtype).expand(2, 300, 2, dh) for _ in range(2))
        assert not fa_kernel.kernel_layout_ok(k)
        assert torch.equal(fa_ops.flash_attention(q, k, v),
                           fa_ops.flash_attention(q, k.contiguous(),
                                                  v.contiguous()))


def test_flash_attention_wgmma_refuses_what_it_does_not_take(dev):
    z = torch.zeros((1, 8, 2, 64), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        fa_kernel.flash_attention_wgmma(z, z, z)
    z = torch.zeros((1, 8, 2, 32), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        fa_kernel.flash_attention_wgmma(z, z, z)


def test_prefill_step_on_cuda_matches_cpu(dev):
    """The reduced qwen2.5 prefill on the card: one kernel launch per
    layer, logits within the bf16 backbone's rounding of the CPU run
    (rel L2 3e-2, as tests/test_torch_prefill.py holds the CPU run to
    the reference)."""
    cfg = registry.reduced("qwen2.5-3b")
    cpu = init_lm(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    card = init_lm(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (2, 300),
                         generator=torch.Generator().manual_seed(0))
    shape = ShapeSpec("t", "prefill", 300, 2)
    n0 = LAUNCHES["flash_attention"]
    got = make_prefill_step(cfg, shape).fn(card, {"inputs": toks})
    assert LAUNCHES["flash_attention"] == n0 + cfg.n_layers
    want = make_prefill_step(cfg, shape, device="cpu").fn(cpu, {"inputs": toks})
    got, want = got.float().cpu(), want.float()
    assert float((got - want).norm() / want.norm()) <= 3e-2


def test_prefill_tensor_core_route_on_cuda_matches_cpu(dev):
    """The reduced qwen2.5 widened to head dim 128 (2 layers): every layer
    launches the tensor-core kernel on the card; logits within the bf16
    backbone's rounding of the CPU run (rel L2 3e-2, as above)."""
    cfg = dataclasses.replace(registry.reduced("qwen2.5-3b"), head_dim=128)
    cpu = init_lm(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    card = init_lm(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (2, 300),
                         generator=torch.Generator().manual_seed(0))
    shape = ShapeSpec("t", "prefill", 300, 2)
    n0 = LAUNCHES["flash_attention_wgmma"]
    got = make_prefill_step(cfg, shape).fn(card, {"inputs": toks})
    assert LAUNCHES["flash_attention_wgmma"] == n0 + cfg.n_layers
    want = make_prefill_step(cfg, shape, device="cpu").fn(cpu, {"inputs": toks})
    got, want = got.float().cpu(), want.float()
    assert float((got - want).norm() / want.norm()) <= 3e-2


def test_island_ring_on_one_card_equals_one_position(dev):
    """A two-position ring on one card (migration through the block
    boundary) gives the one-position run's fronts; each position launches
    nsga2_evolve once a round and nds_rank once a migration."""
    cells = [(4096, 0), (16384, 1)]
    kw = dict(islands=4, migrate_every=5, pop_size=48, generations=15)
    n0 = LAUNCHES["nsga2_evolve"], LAUNCHES["nds_rank"]
    one, f1 = dx.explore_cells_mesh(cells, mesh=("cuda:0",), **kw)
    two, f2 = dx.explore_cells_mesh(cells, mesh=("cuda:0", "cuda:0"), **kw)
    assert (f1["mesh_devices"], f2["mesh_devices"]) == (1, 2)
    assert f1["migration_rounds"] == f2["migration_rounds"] == 2
    for cell in cells:
        assert one[cell].to_rows() == two[cell].to_rows(), cell
    assert (LAUNCHES["nsga2_evolve"] - n0[0],
            LAUNCHES["nds_rank"] - n0[1]) == (3 + 6, 2 + 4)


@pytest.mark.parametrize("k,cells,pop,gens", [(8, (16384,), 96, 10),
                                              (2, (4096, 16384), 48, 5)])
def test_nsga2_evolve_on_a_migrated_block(k, cells, pop, gens, dev):
    """nsga2_evolve on the (k C) block the island path hands it after the
    first migration, with round 1's draws, bit-equal to the composite loop
    on the same block and draws."""
    c = len(cells)
    draws = dx.PhiloxIslands()
    space = nsga2.stack_spaces([nsga2.space_operands(
        nsga2.NSGA2Config(array_size=s)) for s in cells] * k).to(dev)
    statics = nsga2.EvolveStatics(pop_size=pop)
    cell_list = [(s, 0) for s in cells]
    genes, objs = nsga2.run_cell(draws(range(k), 0, cell_list, dev), space,
                                 statics=statics, n_gens=gens)
    (mg, mo), = dx.migrate([(genes.reshape(k, c, pop, 3),
                             objs.reshape(k, c, pop, 4))], statics=statics,
                           n_elite=dx._elite_count(pop))
    mg, mo = mg.reshape(k * c, pop, 3), mo.reshape(k * c, pop, 4)
    stacked = draws(range(k), 1, cell_list, dev).generations(gens, pop, pop,
                                                             statics)
    n0 = LAUNCHES["nsga2_evolve"]
    got = pd_ops.nsga2_evolve(stacked, mg, mo, space, statics)
    assert LAUNCHES["nsga2_evolve"] == n0 + 1
    want = nsga2.evolve_composite(nsga2.StackedDraws(stacked), mg, mo, space,
                                  statics, gens)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k,cells", [(8, (16384,)), (4, (4096, 16384)),
                                     (16, (4096, 16384, 65536))])
def test_nds_rank_and_migrate_at_migration_shapes(k, cells, dev):
    """nds_rank on the (k C, 96, 4) block a migration ranks, against its
    plain version; `migrate` on the card equal to `migrate` on the CPU
    over the same populations, split over two positions."""
    pop, n_elite = 96, dx._elite_count(96)
    space = nsga2.stack_spaces([nsga2.space_operands(
        nsga2.NSGA2Config(array_size=s)) for s in cells] * k).to(dev)
    draws = nsga2.PhiloxDraws(range(k * len(cells)), dev)
    genes = nsga2.init_population_op(draws.init(
        space.gene_lo.cpu().numpy(), space.gene_hi.cpu().numpy(), pop), space)
    objs = nsga2.evaluate_op(genes, space)
    n0 = LAUNCHES["nds_rank"]
    assert torch.equal(pd_ops.non_dominated_rank(objs),
                       pareto.non_dominated_rank(objs))
    assert LAUNCHES["nds_rank"] == n0 + 1
    shape = (k, len(cells), pop)
    statics = nsga2.EvolveStatics(pop_size=pop)
    blocks = [(g.reshape(shape + (3,)).chunk(2)[d],
               o.reshape(shape + (4,)).chunk(2)[d])
              for d in range(2) for g, o in [(genes, objs)]]
    got = dx.migrate(blocks, statics=statics, n_elite=n_elite)
    assert LAUNCHES["nds_rank"] == n0 + 3      # one a position
    want = dx.migrate([(g.cpu(), o.cpu()) for g, o in blocks],
                      statics=statics, n_elite=n_elite)
    for (g, o), (wg, wo) in zip(got, want):
        assert torch.equal(g.cpu(), wg) and torch.equal(o.cpu(), wo)


def test_decode_step_on_cuda_matches_prefill(dev):
    """The reduced qwen2.5 decode on the card under teacher forcing
    against the card's prefill over the same 24 tokens (bf16 both): rel
    L2 <= 3e-2 at each position and argmax equal at >= 90 % of them, as
    tests/test_torch_decode.py holds the CPU run; and within rel L2 3e-2
    of the same decode on the CPU."""
    cfg = registry.reduced("qwen2.5-3b")
    cpu = init_lm(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    card = init_lm(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(0))
    want = make_prefill_step(cfg, ShapeSpec("t", "prefill", 24, 2)).fn(
        card, {"inputs": toks}).float()
    state = lm.init_decode_state(cfg, 2, 32)
    host = lm.init_decode_state(cfg, 2, 32, device="cpu")
    agree = 0
    for t in range(24):
        got, state = lm.decode_step(card, state, toks[:, t].to(dev), cfg)
        ref, host = lm.decode_step(cpu, host, toks[:, t], cfg)
        assert float((got - want[:, t]).norm() / want[:, t].norm()) <= 3e-2
        assert float((got.cpu() - ref).norm() / ref.norm()) <= 3e-2
        agree += int((got.argmax(-1) == want[:, t].argmax(-1)).sum())
    assert agree >= 0.9 * 2 * 24


def _step_once(cfg, device, batch, **kw):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.trainer import TrainerConfig, init_state

    state = init_state(cfg, TrainerConfig(seed=0), device=device)
    state, met = make_train_step(cfg, device=device, **kw).fn(state, batch)
    return state, {k: v.cpu() for k, v in met.items()}


def test_train_step_on_cuda_matches_cpu(dev):
    """One reduced qwen2.5 train step on the card against the CPU from the
    same seed and batch: loss rtol 5e-3, grad norm rtol 5e-2, every
    parameter within 2.2 lr (AdamW's first step moves an element by about
    lr times its grad's sign); remat on the card bit-equal to none; the
    step launches no kernel of ours."""
    cfg = registry.reduced("qwen2.5-3b")
    batch = batch_for(cfg, 64, 4, 0, seed=0)
    n0 = sum(LAUNCHES.values())
    card, mc = _step_once(cfg, dev, {k: v.to(dev) for k, v in batch.items()},
                          remat=True)
    assert sum(LAUNCHES.values()) == n0
    cpu, mh = _step_once(cfg, "cpu", batch, remat=True)
    plain, mp = _step_once(cfg, dev, {k: v.to(dev)
                                      for k, v in batch.items()},
                           remat=False)
    assert abs(float(mc["loss"]) - float(mh["loss"])) <= \
        5e-3 * float(mh["loss"])
    assert abs(float(mc["grad_norm"]) - float(mh["grad_norm"])) <= \
        5e-2 * float(mh["grad_norm"])
    lr = float(mh["lr"])
    for (n, a), (_, b), (_, c) in zip(card["params"].named_parameters(),
                                      cpu["params"].named_parameters(),
                                      plain["params"].named_parameters()):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= \
            2.2 * lr, n
        assert torch.equal(a, c), n
    assert all(torch.equal(mc[k], mp[k]) for k in mc)


def test_trainer_restart_is_bitwise_on_cuda(dev, tmp_path):
    """The reduced qwen2.5 trainer preempted after step 3 of 6 and
    resumed from its checkpoint gives the uninterrupted run's losses
    bit for bit on the card."""
    from repro_torch.runtime.fault_tolerance import PreemptionGuard
    from repro_torch.train.trainer import TrainerConfig, train

    cfg = registry.reduced("qwen2.5-3b")

    def tcfg(d):
        return TrainerConfig(seq=32, global_batch=4, total_steps=6,
                             ckpt_every=4, ckpt_dir=str(d), log_every=0)

    ref = train(cfg, tcfg(tmp_path / "ref"), device=dev)
    guard = PreemptionGuard()
    r1 = train(cfg, tcfg(tmp_path / "int"), guard=guard, device=dev,
               on_step=lambda i, m: guard.request() if i == 2 else None)
    r2 = train(cfg, tcfg(tmp_path / "int"), device=dev)
    assert r1.steps_run == 3 and r2.steps_run == 3
    assert r1.losses + r2.losses == ref.losses


# ---------------------------------------------------------------------------
# MLA's (192, 128) tensor-core instantiation and the MoE family
# ---------------------------------------------------------------------------
def _mla_cfg():
    """The reduced deepseek-v2-lite with the full config's MLA head dims
    (q/k 192, v 128; kv_lora 32): its blockwise prefill runs the (192,
    128) instantiation."""
    cfg = registry.reduced("deepseek_v2_lite_16b")
    return dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, rope_dim=64, nope_dim=128, v_dim=128))


@pytest.mark.parametrize("b,s,h,kv,causal,prefix_len", [
    (1, 1024, 16, 16, True, 0),      # deepseek's heads, one KV head each
    (2, 129, 4, 4, True, 0),         # one row past a tile
    (2, 777, 4, 2, False, 0),        # GQA, no mask
    (1, 777, 4, 4, True, 200),       # a prefix inside the sequence
    (2, 100, 4, 4, True, 0),         # fewer keys than one tile
    (1, 300, 4, 4, True, 150),       # 1-3 key tiles, a prefix inside one
    (1, 384, 4, 2, False, 0)], ids=str)    # three key tiles, unmasked
def test_flash_attention_192_128_matches_tc_plain(b, s, h, kv, causal,
                                                  prefix_len, dev):
    """The (192, 128) instantiation against `flash_attention_tc_ref` as
    `_assert_tc_close` holds it, with its launch counts; rel L2 against
    the float32-P `flash_attention_ref` at most 1e-2, as at Dh 128."""
    g = torch.Generator(device=dev).manual_seed(s + prefix_len)
    q = torch.randn((b, s, h, 192), generator=g, device=dev).bfloat16()
    k = torch.randn((b, s, kv, 192), generator=g, device=dev).bfloat16()
    v = torch.randn((b, s, kv, 128), generator=g, device=dev).bfloat16()
    n0 = dict(LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, causal=causal,
                                 prefix_len=prefix_len)
    for key in ("flash_attention", "flash_attention_wgmma",
                "flash_attention_wgmma_192_128"):
        assert LAUNCHES[key] == n0.get(key, 0) + 1, key
    assert tuple(got.shape) == (b, s, h, 128)
    _assert_tc_close(got, q, k, v, causal=causal, prefix_len=prefix_len)
    f32p = fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                      prefix_len=prefix_len).float()
    assert float((got.float() - f32p).norm() / f32p.norm()) <= 1e-2


def test_flash_attention_192_128_reads_mla_layouts(dev):
    """q and k as `mla_fwd_blockwise` builds them (concatenated nope and
    rope parts, the rope key broadcast over heads), and q read through
    strides (a 192-wide view of 256-wide rows): the same bits as on
    contiguous copies."""
    from repro_torch.models import attention as attn
    from repro_torch.models.common import apply_norm

    cfg = dataclasses.replace(_mla_cfg(), n_heads=16, d_model=256)
    model = init_lm(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    blk = model.blocks[0]
    g = torch.Generator(device=dev).manual_seed(3)
    with torch.inference_mode():
        x = torch.randn((1, 500, 256), generator=g, device=dev).bfloat16()
        h_ = apply_norm(blk.ln1, x, cfg.norm)
        pos = torch.arange(500, device=dev)
        q_nope, q_rope = attn._mla_q(blk.attn, h_, cfg, pos)
        k_nope, v, k_rope = attn._mla_kv(blk.attn, h_, cfg, pos)
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(-1, -1, 16, -1)], -1)
        got = fa_kernel.flash_attention_wgmma(q, k, v)
        _assert_tc_close(got, q, k, v, causal=True, prefix_len=0)
        wide = torch.randn((1, 500, 16, 256), generator=g,
                           device=dev).bfloat16()
        qs = wide[..., :192]
        assert fa_kernel.kernel_layout_ok(qs) and not qs.is_contiguous()
        assert torch.equal(fa_kernel.flash_attention_wgmma(qs, k, v),
                           fa_kernel.flash_attention_wgmma(qs.contiguous(),
                                                           k, v))


def test_flash_attention_192_128_refuses_what_it_does_not_take(dev):
    """Another dim pair, float32 and a zero stride raise on the card;
    nothing falls back to a plain version (ops copies a zero-stride input
    before the wrapper sees it)."""
    bf16 = torch.bfloat16
    q = torch.zeros((1, 64, 2, 192), device=dev, dtype=bf16)
    with pytest.raises(ValueError, match="head dims"):
        fa_kernel.flash_attention_wgmma(q, q, q)                 # (192, 192)
    with pytest.raises(ValueError, match="head dims"):
        fa_ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="dtype"):
        fa_kernel.flash_attention_wgmma(q.float(), q.float(),
                                        q[..., :128].float())
    with pytest.raises(ValueError, match="head dims"):
        fa_ops.flash_attention(q.float(), q.float(), q[..., :128].float())
    k = torch.zeros((1, 64, 1, 192), device=dev, dtype=bf16).expand(
        1, 64, 2, 192)
    v = torch.zeros((1, 64, 2, 128), device=dev, dtype=bf16)
    with pytest.raises(ValueError, match="stride"):
        fa_kernel.flash_attention_wgmma(q, k, v)
    assert torch.equal(fa_ops.flash_attention(q, k, v),
                       fa_ops.flash_attention(q, k.contiguous(), v))


def test_moe_prefill_on_cuda_matches_cpu(dev):
    """A 2-layer deepseek-v2-lite (reduced, MLA at 192 / 128) prefill on
    the card: one (192, 128) launch a layer; logits against the CPU run
    of the same weights.  A bf16 rounding may flip a near-tie router
    choice, so positions are held in bulk: the median within rel L2 2e-2
    and >= 85 % within 5e-2 (tests/test_torch_moe_lm.py's bounds)."""
    cfg = _mla_cfg()
    cpu = init_lm(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    card = init_lm(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (2, 256),
                         generator=torch.Generator().manual_seed(0))
    shape = ShapeSpec("t", "prefill", 256, 2)
    n0 = LAUNCHES["flash_attention_wgmma_192_128"]
    got = make_prefill_step(cfg, shape).fn(card, {"inputs": toks})
    assert LAUNCHES["flash_attention_wgmma_192_128"] == n0 + cfg.n_layers
    want = make_prefill_step(cfg, shape, device="cpu").fn(cpu, {"inputs": toks})
    got, want = got.float().cpu(), want.float()
    rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(rel.median()) <= 2e-2
    assert float((rel <= 5e-2).float().mean()) >= 0.85


def test_moe_a2a_on_card_positions_matches_dropfree(dev):
    """`moe_fwd_a2a` on 1, 2 and 4 positions of the card against
    `moe_fwd_dense_eval` at a capacity that drops nothing (the reference
    test's atol = rtol = 2e-3, float32), the same bits on every count."""
    from repro_torch.models import mlp
    from repro_torch.parallel.moe_a2a import moe_fwd_a2a

    cfg = registry.reduced("arctic_480b")
    ffn = mlp.init_moe(cfg.d_model, cfg, torch.Generator().manual_seed(0))
    ffn = ffn.to(dev).requires_grad_(False)
    x = 0.5 * torch.randn((4, 16, cfg.d_model), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    want = mlp.moe_fwd_dense_eval(ffn, x, cfg)
    got = {n: moe_fwd_a2a(ffn, x, cfg, (dev,) * n, capacity=512)
           for n in (1, 2, 4)}
    for y in got.values():
        torch.testing.assert_close(y, want, atol=2e-3, rtol=2e-3)
        assert torch.equal(y, got[1])


# ---------------------------------------------------------------------------
# paligemma's (256, 256) tensor-core instantiation and the VLM family
# ---------------------------------------------------------------------------
def _vlm_wide_cfg():
    """The reduced paligemma widened to the full config's head dim (2
    layers, d 256, 8 heads over 1 KV head at 256, 16 patches): its
    blockwise prefill runs the (256, 256) instantiation."""
    return dataclasses.replace(registry.reduced("paligemma_3b"), d_model=256,
                               n_heads=8, n_kv_heads=1, head_dim=256)


@pytest.mark.parametrize("b,s,h,kv,causal,prefix_len,q_scale", [
    (1, 1000, 8, 1, True, 256, 1),   # paligemma's MQA and its patch prefix
    (1, 129, 8, 1, True, 256, 1),    # the prefix covers every row
    (2, 777, 4, 2, False, 0, 1),     # GQA, no mask
    (2, 300, 4, 4, True, 0, 1),      # causal, a ragged last tile
    (1, 200, 2, 1, True, 100, 1),    # a prefix inside a key tile
    (2, 50, 4, 4, True, 0, 1),       # fewer keys than one tile
    (1, 1000, 8, 1, True, 256, 4),   # q x 4: a peaked softmax, m moving
    (2, 777, 4, 2, False, 0, 4)], ids=str)   # late and O's rescale skipped
def test_flash_attention_256_256_matches_tc_plain(b, s, h, kv, causal,
                                                  prefix_len, q_scale, dev):
    """The (256, 256) instantiation (64-key tiles) against
    `flash_attention_tc_ref` at its tile as `_assert_tc_close` holds it,
    with its launch counts; rel L2 against the float32-P
    `flash_attention_ref` at most 1e-2, as at Dh 128.  With q scaled by 4
    the row maxima move on later tiles too, so the kernel's skip of O's
    rescale (where no row of a warp moved) is taken and not taken."""
    g = torch.Generator(device=dev).manual_seed(s + prefix_len + 256)
    q = torch.randn((b, s, h, 256), generator=g, device=dev).bfloat16()
    q = q * q_scale
    k, v = (torch.randn((b, s, kv, 256), generator=g, device=dev).bfloat16()
            for _ in range(2))
    n0 = dict(LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, causal=causal,
                                 prefix_len=prefix_len)
    for key in ("flash_attention", "flash_attention_wgmma",
                "flash_attention_wgmma_256_256"):
        assert LAUNCHES[key] == n0.get(key, 0) + 1, key
    assert tuple(got.shape) == (b, s, h, 256)
    _assert_tc_close(got, q, k, v, causal=causal, prefix_len=prefix_len)
    f32p = fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                      prefix_len=prefix_len).float()
    assert float((got.float() - f32p).norm() / f32p.norm()) <= 1e-2


def test_flash_attention_256_256_reads_strided_q(dev):
    """q and k as RoPE leaves them (heads-major memory read through
    strides) and q as a 256-wide view of wider rows: the same bits as on
    contiguous copies."""
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((1, 8, 500, 256), generator=g, device=dev).bfloat16()
    k = torch.randn((1, 1, 500, 256), generator=g, device=dev).bfloat16()
    v = torch.randn((1, 500, 1, 256), generator=g, device=dev).bfloat16()
    q, k = q.transpose(1, 2), k.transpose(1, 2)
    assert fa_kernel.kernel_layout_ok(q) and not q.is_contiguous()
    got = fa_kernel.flash_attention_wgmma(q, k, v, prefix_len=64)
    _assert_tc_close(got, q, k, v, causal=True, prefix_len=64)
    assert torch.equal(got, fa_kernel.flash_attention_wgmma(
        q.contiguous(), k.contiguous(), v, prefix_len=64))
    wide = torch.randn((1, 500, 8, 320), generator=g, device=dev).bfloat16()
    qs = wide[..., :256]
    assert fa_kernel.kernel_layout_ok(qs) and not qs.is_contiguous()
    assert torch.equal(fa_kernel.flash_attention_wgmma(qs, k, v),
                       fa_kernel.flash_attention_wgmma(qs.contiguous(), k, v))


def test_flash_attention_256_refuses_float32(dev):
    """No route takes float32 at head dim 256: the wrapper and ops raise
    on the card, naming the routes; nothing falls back to a plain
    version."""
    q = torch.zeros((1, 64, 2, 256), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        fa_kernel.flash_attention_wgmma(q, q, q)
    with pytest.raises(ValueError, match="routes"):
        fa_ops.flash_attention(q, q, q)


def test_vlm_prefill_on_cuda_matches_cpu(dev):
    """The widened reduced paligemma's prefill on the card (16 patches as
    a prefix): one (256, 256) launch a layer; logits at every position,
    patches included, within the bf16 backbone's rounding of the CPU run
    (rel L2 3e-2, as the dense family's)."""
    cfg = _vlm_wide_cfg()
    cpu = init_lm(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    card = init_lm(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    batch = batch_for(cfg, 300, 2, 0)
    shape = ShapeSpec("t", "prefill", 300, 2)
    n0 = dict(LAUNCHES)
    got = make_prefill_step(cfg, shape).fn(card, batch)
    assert LAUNCHES["flash_attention_wgmma_256_256"] == \
        n0.get("flash_attention_wgmma_256_256", 0) + cfg.n_layers
    assert LAUNCHES["flash_attention"] == n0.get("flash_attention", 0) + cfg.n_layers
    want = make_prefill_step(cfg, shape, device="cpu").fn(cpu, batch)
    assert tuple(got.shape) == (2, 300 + cfg.vlm.n_patches, cfg.vocab)
    got, want = got.float().cpu(), want.float()
    assert float((got - want).norm() / want.norm()) <= 3e-2


def test_vlm_reduced_prefill_runs_the_cuda_core_route(dev):
    """The reduced paligemma (head dim 16) prefill on the card: one launch
    a layer of the 3xTF32 kernel (the route that replaced the CUDA-core
    one) and no bf16 tensor-core one; logits within rel L2 3e-2 of the
    CPU run."""
    cfg = registry.reduced("paligemma_3b")
    cpu = init_lm(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    card = init_lm(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    batch = batch_for(cfg, 300, 2, 1)
    shape = ShapeSpec("t", "prefill", 300, 2)
    n0 = dict(LAUNCHES)
    got = make_prefill_step(cfg, shape).fn(card, batch)
    assert LAUNCHES["flash_attention"] == n0.get("flash_attention", 0) + cfg.n_layers
    assert LAUNCHES["flash_attention_tf32x3"] == n0.get(
        "flash_attention_tf32x3", 0) + cfg.n_layers
    assert LAUNCHES["flash_attention_wgmma"] == n0.get("flash_attention_wgmma", 0)
    want = make_prefill_step(cfg, shape, device="cpu").fn(cpu, batch)
    got, want = got.float().cpu(), want.float()
    assert float((got - want).norm() / want.norm()) <= 3e-2


# ---------------------------------------------------------------------------
# zamba2's (80, 80) tensor-core instantiation (tiles padded to 128 columns
# in shared memory) and the hybrid family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,kv,causal,prefix_len", [
    (1, 1000, 32, 32, True, 0),      # zamba2's 32 heads over 32 KV heads
    (1, 129, 4, 4, True, 0),         # one row past a tile
    (2, 100, 4, 4, True, 0),         # shorter than a tile
    (2, 777, 4, 2, False, 0),        # GQA, no mask
    (1, 300, 2, 1, True, 64),        # a prefix
    (1, 300, 4, 2, True, 150),       # 1-3 key tiles, a prefix inside one
    (1, 384, 4, 4, False, 0)], ids=str)    # three key tiles, unmasked
def test_flash_attention_80_80_matches_tc_plain(b, s, h, kv, causal,
                                                prefix_len, dev):
    """The (80, 80) instantiation against `flash_attention_tc_ref` as
    `_assert_tc_close` holds it, with its launch counts; rel L2 against
    the float32-P `flash_attention_ref` at most 1e-2, as at Dh 128."""
    g = torch.Generator(device=dev).manual_seed(s + prefix_len + 80)
    q = torch.randn((b, s, h, 80), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((b, s, kv, 80), generator=g, device=dev).bfloat16()
            for _ in range(2))
    n0 = dict(LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, causal=causal,
                                 prefix_len=prefix_len)
    for key in ("flash_attention", "flash_attention_wgmma",
                "flash_attention_wgmma_80_80"):
        assert LAUNCHES[key] == n0.get(key, 0) + 1, key
    assert tuple(got.shape) == (b, s, h, 80) and got.is_contiguous()
    _assert_tc_close(got, q, k, v, causal=causal, prefix_len=prefix_len)
    f32p = fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                      prefix_len=prefix_len).float()
    assert float((got.float() - f32p).norm() / f32p.norm()) <= 1e-2


def test_flash_attention_80_80_reads_strided_q(dev):
    """q and k as RoPE leaves them (heads-major memory read through
    strides) and q as an 80-wide view of 96-wide rows: the same bits as
    on contiguous copies."""
    g = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn((1, 32, 500, 80), generator=g, device=dev).bfloat16()
    k = torch.randn((1, 32, 500, 80), generator=g, device=dev).bfloat16()
    v = torch.randn((1, 500, 32, 80), generator=g, device=dev).bfloat16()
    q, k = q.transpose(1, 2), k.transpose(1, 2)
    assert fa_kernel.kernel_layout_ok(q) and not q.is_contiguous()
    got = fa_kernel.flash_attention_wgmma(q, k, v)
    _assert_tc_close(got, q, k, v, causal=True, prefix_len=0)
    assert torch.equal(got, fa_kernel.flash_attention_wgmma(
        q.contiguous(), k.contiguous(), v))
    wide = torch.randn((1, 500, 32, 96), generator=g, device=dev).bfloat16()
    qs = wide[..., :80]
    assert fa_kernel.kernel_layout_ok(qs) and not qs.is_contiguous()
    assert torch.equal(fa_kernel.flash_attention_wgmma(qs, k, v),
                       fa_kernel.flash_attention_wgmma(qs.contiguous(), k, v))


def test_flash_attention_80_refuses_float32(dev):
    """No route takes float32 at head dim 80: the wrapper and ops raise
    on the card, naming the routes."""
    q = torch.zeros((1, 64, 2, 80), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        fa_kernel.flash_attention_wgmma(q, q, q)
    with pytest.raises(ValueError, match="routes"):
        fa_ops.flash_attention(q, q, q)


def _hybrid_wide_cfg():
    """The reduced zamba2 widened to the full config's shared-attention
    head dim (4 Mamba2 layers in 2 groups, d 320, 4 heads at 80): its
    blockwise prefill runs the (80, 80) instantiation once a group."""
    return dataclasses.replace(registry.reduced("zamba2_2_7b"), d_model=320)


@pytest.mark.parametrize("cfg_fn,inst", [
    (_hybrid_wide_cfg, "flash_attention_wgmma_80_80"),
    (lambda: registry.reduced("zamba2_2_7b"), None)], ids=["dh80", "dh16"])
def test_hybrid_prefill_on_cuda_matches_cpu(cfg_fn, inst, dev):
    """The reduced zamba2's prefill on the card, at head dim 80 (one (80,
    80) launch a group) and at its own 16 (one 3xTF32 launch a group,
    no tensor-core one): logits within the bf16 backbone's rounding of
    the CPU run (rel L2 5e-2, as `tests/test_torch_zamba2.py` holds the
    bf16 port against the reference)."""
    cfg = cfg_fn()
    groups = cfg.n_layers // cfg.hybrid.shared_attn_every
    cpu = init_lm(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    card = init_lm(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    batch = batch_for(cfg, 320, 2, 0)
    shape = ShapeSpec("t", "prefill", 320, 2)
    n0 = dict(LAUNCHES)
    got = make_prefill_step(cfg, shape).fn(card, batch)
    assert LAUNCHES["flash_attention"] == n0.get("flash_attention", 0) + groups
    tc = LAUNCHES.get("flash_attention_wgmma", 0) - n0.get(
        "flash_attention_wgmma", 0)
    assert tc == (groups if inst else 0)
    if inst:
        assert LAUNCHES[inst] == n0.get(inst, 0) + groups
    want = make_prefill_step(cfg, shape, device="cpu").fn(cpu, batch)
    got, want = got.float().cpu(), want.float()
    assert float((got - want).norm() / want.norm()) <= 5e-2


def test_hybrid_decode_on_cuda_matches_cpu(dev):
    """Teacher-forced hybrid `decode_step` on the card against the CPU's
    (float32 Mamba2 states, bf16 shared caches written in place): rel L2
    5e-2 a step."""
    cfg = _hybrid_wide_cfg()
    cpu = init_lm(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    card = init_lm(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (2, 10),
                         generator=torch.Generator().manual_seed(3))
    st_cpu = lm.init_decode_state(cfg, 2, 16, device="cpu")
    st_card = lm.init_decode_state(cfg, 2, 16, device=dev)
    for t in range(10):
        want, st_cpu = lm.decode_step(cpu, st_cpu, toks[:, t], cfg)
        got, st_card = lm.decode_step(card, st_card, toks[:, t].to(dev), cfg)
        assert float((got.cpu() - want).norm() / want.norm()) <= 5e-2, t


def test_flash_attention_64_64_mha_matches_tc_plain(dev):
    """The (64, 64) instantiation at whisper-large-v3's decoder shape,
    20 heads over 20 KV heads (MHA, a GQA group of 1), (1, 4096) causal:
    its launch counts, `flash_attention_tc_ref` as `_assert_tc_close`
    holds it, and rel L2 against the float32-P `flash_attention_ref` at
    most 1e-2, as at Dh 128."""
    g = torch.Generator(device=dev).manual_seed(64)
    q, k, v = (torch.randn((1, 4096, 20, 64), generator=g,
                           device=dev).bfloat16() for _ in range(3))
    n0 = dict(LAUNCHES)
    got = fa_ops.flash_attention(q, k, v, causal=True)
    for key in ("flash_attention", "flash_attention_wgmma",
                "flash_attention_wgmma_64_64"):
        assert LAUNCHES[key] == n0.get(key, 0) + 1, key
    assert tuple(got.shape) == (1, 4096, 20, 64) and got.is_contiguous()
    _assert_tc_close(got, q, k, v, causal=True, prefix_len=0)
    f32p = fa_ref.flash_attention_ref(q, k, v, causal=True).float()
    assert float((got.float() - f32p).norm() / f32p.norm()) <= 1e-2


@pytest.mark.parametrize("name", ["whisper_large_v3", "xlstm_125m"])
def test_audio_and_ssm_prefill_on_cuda_matches_cpu(name, dev):
    """The reduced whisper (head dim 16: one 3xTF32 launch a decoder
    layer) and xlstm (no kernel of ours) prefills on the card against
    the CPU run of the same weights: rel L2 5e-2."""
    cfg = registry.reduced(name)
    api = build_model(cfg)
    cpu = api.init(seed=0, device="cpu", dtype=torch.bfloat16)
    card = api.init(seed=0, device=dev, dtype=torch.bfloat16)
    batch = batch_for(cfg, 256, 2, 0)
    shape = ShapeSpec("t", "prefill", 256, 2)
    n0 = dict(LAUNCHES)
    got = make_prefill_step(cfg, shape).fn(card, batch)
    calls = cfg.n_layers if cfg.family == "audio" else 0
    new = {k: n - n0.get(k, 0) for k, n in LAUNCHES.items()
           if n != n0.get(k, 0)}
    assert new == ({"flash_attention": calls,
                    "flash_attention_tf32x3": calls} if calls else {})
    want = make_prefill_step(cfg, shape, device="cpu").fn(cpu, batch)
    got, want = got.float().cpu(), want.float()
    assert float((got - want).norm() / want.norm()) <= 5e-2
