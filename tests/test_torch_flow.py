"""The port's host frontier engine, `wavefront_distance(impl=...)`, the
sequential router and layout flow, the batched result's unpacking and
the remaining pareto helpers, each against the reference on the same
inputs."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pareto as rpareto
from repro.core.acim_spec import MacroSpec as RSpec
from repro.eda import batched_flow as rbflow
from repro.eda import flow as rflow
from repro.eda import placer as rplacer
from repro.eda import router as rrouter
from repro.kernels.maze_route import frontier as rfrontier
from repro.kernels.maze_route import wavefront_distance_bfs
from repro_torch.core import pareto as tpareto
from repro_torch.core.acim_spec import MacroSpec as TSpec
from repro_torch.eda import batched_flow as tbflow
from repro_torch.eda import flow as tflow
from repro_torch.eda import placer as tplacer
from repro_torch.eda import router as trouter
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.maze_route import INF, wavefront_distance
from repro_torch.kernels.maze_route import frontier as tfrontier
from repro_torch.kernels.maze_route.ops import IMPLS
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

SPECS = ((64, 64, 2, 3), (128, 32, 4, 2), (512, 8, 8, 4))


def _random_case(rng, h, w, density, n_seeds):
    occ = rng.random((h, w)) < density
    seed = np.zeros((h, w), bool)
    flat = rng.choice(h * w, size=min(n_seeds, h * w), replace=False)
    seed[flat // w, flat % w] = True
    return occ, seed


def _cases():
    """The reference property suite's grids: randomized (varied shapes,
    densities, seeds), batched, fully blocked, a seed on an obstacle, an
    empty seed mask, and a wall that disconnects the grid."""
    out = []
    for case in range(12):
        rng = np.random.default_rng(1000 + case)
        h, w = int(rng.integers(2, 20)), int(rng.integers(2, 24))
        out.append(_random_case(rng, h, w, float(rng.uniform(0.0, 0.65)),
                                int(rng.integers(1, 4))))
    rng = np.random.default_rng(7)
    occ = rng.random((3, 9, 13)) < 0.3
    seed = np.zeros((3, 9, 13), bool)
    for b in range(3):
        seed[b, rng.integers(0, 9), rng.integers(0, 13)] = True
    out.append((occ, seed))
    seed = np.zeros((6, 11), bool)
    seed[2, 3] = True
    out.append((np.ones((6, 11), bool), seed))
    occ = np.zeros((3, 7), bool)
    occ[1, 3] = True
    seed = np.zeros((3, 7), bool)
    seed[1, 3] = True
    out.append((occ, seed))
    out.append((np.zeros((5, 9), bool), np.zeros((5, 9), bool)))
    occ = np.zeros((7, 7), bool)
    occ[:, 3] = True
    seed = np.zeros((7, 7), bool)
    seed[3, 0] = True
    out.append((occ, seed))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_frontier_equals_reference_and_oracle(case):
    occ, seed = CASES[case]
    got = tfrontier.wavefront_distance_frontier(occ, seed)
    assert got.dtype == np.int32 and got.shape == occ.shape
    np.testing.assert_array_equal(
        got, rfrontier.wavefront_distance_frontier(occ, seed))
    np.testing.assert_array_equal(got, wavefront_distance_bfs(occ, seed))
    for impl in IMPLS[1:]:                  # every CPU impl of the port
        field = wavefront_distance(torch.from_numpy(occ),
                                   torch.from_numpy(seed), impl=impl)
        np.testing.assert_array_equal(np.asarray(field), got, err_msg=impl)


def _canvas(occ, seed, frontier):
    b, h, w = occ.shape
    stride = w + 2
    free = frontier.canvas_free(occ)
    dist = np.full((b, (h + 2) * stride), INF, np.int32)
    sl, sy, sx = np.nonzero(seed)
    sidx = frontier.canvas_index(sy, sx, stride)
    dist[sl.astype(np.int64), sidx] = 0
    return free, dist, sl.astype(np.int64), sidx, stride


@pytest.mark.parametrize("early", [False, True], ids=["full", "early"])
def test_expand_buckets_levels_equal_reference(early):
    """Level counts and fields of `expand_buckets`, with and without a
    per-lane early exit (a lane stops once its probe cell is reached)."""
    rng = np.random.default_rng(11)
    occ = rng.random((4, 17, 23)) < 0.3
    seed = np.zeros_like(occ)
    for b in range(4):
        seed[b, rng.integers(0, 17), rng.integers(0, 23)] = True
    probe = tfrontier.canvas_index(rng.integers(0, 17, 4),
                                   rng.integers(0, 23, 4), 25)
    runs = []
    for frontier in (tfrontier, rfrontier):
        free, dist, sl, sidx, stride = _canvas(occ, seed, frontier)
        lanes = np.arange(4)
        resolved = (lambda: dist[lanes, probe] < INF) if early else None
        runs.append((frontier.expand_buckets(free, dist, sl, sidx, stride,
                                             resolved), dist))
    assert runs[0][0] == runs[1][0] > 0
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    np.testing.assert_array_equal(tfrontier.strides(25),
                                  rfrontier.strides(25))


def test_wavefront_distance_dispatch():
    occ, seed = CASES[0]
    want = wavefront_distance_bfs(occ, seed)
    t_occ, t_seed = torch.from_numpy(occ), torch.from_numpy(seed)
    out = wavefront_distance(t_occ, t_seed)          # CPU default: plain
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), want)
    for impl in ("frontier", "bfs"):                 # numpy in or out
        for args in ((occ, seed), (t_occ, t_seed)):
            got = wavefront_distance(*args, impl=impl)
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="impl"):
        wavefront_distance(t_occ, t_seed, impl="astar")
    with pytest.raises(ValueError, match="CUDA"):    # CUDA-only impl
        wavefront_distance(t_occ, t_seed, impl="kernel")
    meta = torch.empty(occ.shape, dtype=torch.bool, device="meta")
    for impl in ("frontier", "bfs"):                 # no silent host copy
        with pytest.raises(ValueError, match="host engine"):
            wavefront_distance(meta, meta, impl=impl)


def test_wavefront_distance_grids_on_every_cpu_impl():
    occ, seed = CASES[12]                            # (3, 9, 13)
    grids = np.array([[9, 13], [5, 7], [9, 4]], np.int32)
    occ_g, seed_g = occ.copy(), seed.copy()
    for b, (h, w) in enumerate(grids):
        occ_g[b, h:] = occ_g[b, :, w:] = True
        seed_g[b, h:] = seed_g[b, :, w:] = False
    want = wavefront_distance_bfs(occ_g, seed_g)
    for impl in IMPLS[1:]:
        got = wavefront_distance(torch.from_numpy(occ), torch.from_numpy(seed),
                                 torch.from_numpy(grids), impl=impl)
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=impl)


@pytest.fixture(scope="module")
def layouts():
    """The reference's and the port's sequential layouts of SPECS."""
    ref = [rflow.generate_layout(RSpec(*s)) for s in SPECS]
    n0 = sum(LAUNCHES.values())
    port = [tflow.generate_layout(TSpec(*s), device="cpu") for s in SPECS]
    assert sum(LAUNCHES.values()) == n0              # CPU: no kernel launch
    return ref, port


def _rects(placement):
    return [(r.name, r.cell, r.x, r.y, r.w, r.h) for r in placement.rects]


def _wires(routing):
    return [(w.net, w.points, w.layer_pattern) for w in routing.wires]


def _metrics(lr):
    m = lr.metrics()
    del m["elapsed_s"]
    return m


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_generate_layout_equals_reference(layouts, i):
    ref, port = layouts
    a, b = ref[i], port[i]
    assert (a.placement.width, a.placement.height) == \
        (b.placement.width, b.placement.height)
    assert _rects(a.placement) == _rects(b.placement)
    assert _wires(a.routing) == _wires(b.routing)
    assert a.routing.failed == b.routing.failed
    assert a.routing.total_wirelength == b.routing.total_wirelength
    assert a.routing.grid_shape == b.routing.grid_shape
    assert dataclasses.astuple(a.drc) == dataclasses.astuple(b.drc)
    assert a.netlist_stats == b.netlist_stats
    assert _metrics(a) == _metrics(b)
    assert sum(len(w.points) for w in b.routing.wires) == \
        b.routing.total_wirelength


def test_layout_to_json_equals_reference(layouts, tmp_path):
    ref, port = layouts
    ref[0].to_json(tmp_path / "ref.json")
    port[0].to_json(tmp_path / "port.json")
    a = json.loads((tmp_path / "ref.json").read_text())
    b = json.loads((tmp_path / "port.json").read_text())
    for doc in (a, b):
        del doc["metrics"]["elapsed_s"]
    assert a == b


@pytest.mark.parametrize("impl", ["frontier", "ref", "bfs"])
@pytest.mark.parametrize("capacity", [1, 4])
def test_route_equals_reference(impl, capacity):
    """`router.route` with each CPU impl, at a capacity that makes nets
    fail, against the reference's host default."""
    rp = rplacer.place(RSpec(*SPECS[0]))
    tp = tplacer.place(TSpec(*SPECS[0]))
    rnets = rflow._top_level_nets(rp.spec, rp)
    tnets = tflow._top_level_nets(tp.spec, tp)
    assert rnets == tnets
    want = rrouter.route(rp, rnets, capacity=capacity)
    got = trouter.route(tp, tnets, capacity=capacity, impl=impl,
                        device="cpu")
    assert _wires(got) == _wires(want)
    assert got.failed == want.failed
    assert got.total_wirelength == want.total_wirelength
    assert got.success_rate == want.success_rate
    if capacity == 1:
        assert got.failed


def test_target_distance_and_backtrace_equal_reference():
    rng = np.random.default_rng(4)
    for _ in range(6):
        occ, seed = _random_case(rng, 12, 15, 0.3, 1)
        dist = wavefront_distance_bfs(occ, seed)
        for dst in zip(rng.integers(0, 12, 8), rng.integers(0, 15, 8)):
            dst = (int(dst[0]), int(dst[1]))
            assert trouter.target_distance(dist, dst) == \
                rrouter.target_distance(dist, dst)
            assert trouter.backtrace(dist, dst) == \
                rrouter.backtrace(dist, dst)


def test_drc_lite_equals_reference():
    for s in SPECS:
        rp, tp = rplacer.place(RSpec(*s)), tplacer.place(TSpec(*s))
        assert dataclasses.astuple(tflow.drc_lite(tp)) == \
            dataclasses.astuple(rflow.drc_lite(rp))
    # a shifted rect overlaps its column neighbours and leaves the box
    bad = dataclasses.replace(tp.rects[0], x=tp.rects[0].x + 1,
                              y=tp.height)
    tp.rects.append(bad)
    rp.rects.append(rplacer.Placed(*dataclasses.astuple(bad)))
    rep = tflow.drc_lite(tp)
    assert dataclasses.astuple(rep) == dataclasses.astuple(
        rflow.drc_lite(rp))
    assert rep.out_of_bounds > 0 and not rep.clean


@pytest.fixture(scope="module")
def batched():
    ref = rbflow.generate_layouts([RSpec(*s) for s in SPECS],
                                  engine="concurrent")
    port = tbflow.generate_layouts([TSpec(*s) for s in SPECS], device="cpu")
    return ref, port


def test_placements_equal_reference(batched, layouts):
    ref, port = batched
    got, want = port.placements(), ref.placements()
    assert len(got) == len(want) == len(SPECS)
    for g, w, lr in zip(got, want, layouts[1]):
        assert g.spec.as_tuple() == w.spec.as_tuple()
        assert (g.width, g.height) == (w.width, w.height)
        assert _rects(g) == _rects(w)
        assert sorted(_rects(g)) == sorted(_rects(lr.placement))


def test_drc_reports_and_to_json_equal_reference(batched, layouts,
                                                 tmp_path):
    ref, port = batched
    assert [dataclasses.astuple(r) for r in port.drc_reports()] == \
        [dataclasses.astuple(r) for r in ref.drc_reports()] == \
        [dataclasses.astuple(lr.drc) for lr in layouts[1]]
    port.to_json(tmp_path / "port.json")
    ref.to_json(tmp_path / "ref.json")
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "ref.json").read_text())
    # per spec, the batched rows are the sequential metrics minus the clock
    assert port.metrics_rows() == [_metrics(lr) for lr in layouts[1]]


def _objectives(seed):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 4, (40, 3)).astype(np.float32)
    f[30:] = f[:10]                                   # exact duplicates
    cv = np.where(rng.random(40) < 0.4, rng.integers(1, 4, 40),
                  0).astype(np.float32)
    cv[35:] = cv[:5]
    return f, cv


@pytest.mark.parametrize("seed", range(3))
def test_pareto_helpers_equal_reference(seed):
    f, cv = _objectives(seed)
    tf, tcv = torch.from_numpy(f), torch.from_numpy(cv)
    np.testing.assert_array_equal(
        tpareto.constrained_dominance_matrix(tf, tcv).numpy(),
        np.asarray(rpareto.constrained_dominance_matrix(jnp.asarray(f),
                                                        jnp.asarray(cv))))
    np.testing.assert_array_equal(
        tpareto.pareto_front_indices(tf).numpy(),
        np.asarray(rpareto.pareto_front_indices(jnp.asarray(f))))
    np.testing.assert_array_equal(
        tpareto.dominates(tf[:, None], tf[None]).numpy(),
        np.asarray(rpareto.dominates(jnp.asarray(f)[:, None],
                                     jnp.asarray(f)[None])))
    # a batch of cells ranks each cell as alone
    g, gcv = _objectives(seed + 10)
    both = tpareto.constrained_dominance_matrix(
        torch.from_numpy(np.stack([f, g])), torch.from_numpy(np.stack([cv,
                                                                       gcv])))
    np.testing.assert_array_equal(
        both[1].numpy(), tpareto.constrained_dominance_matrix(
            torch.from_numpy(g), torch.from_numpy(gcv)).numpy())


def test_constrained_dominance_feasible_beats_infeasible():
    f = torch.tensor([[5., 5.], [0., 0.]])
    cv = torch.tensor([0.0, 2.0])
    d = tpareto.constrained_dominance_matrix(f, cv)
    assert bool(d[0, 1]) and not bool(d[1, 0])
