"""The port's concurrent routing engine against the reference's
`_concurrent_route`: occupancy, routed, failed, wirelength, rounds,
collisions and the schedule (dispatches, bounding boxes, crossings) on
the reference's scenarios, with its host BFS fields (frontier engine,
early exit) and with the full fields the card computes (here the plain
sweep, which the `wavefront` kernel is held against)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.acim_spec import MacroSpec as RSpec
from repro.eda import batched_flow as rflow
from repro.eda import router as rrouter
from repro.kernels.maze_route import wavefront_distance_bfs
from repro_torch.api import DesignRequest, DesignSession, Requirements
from repro_torch.core.acim_spec import MacroSpec as TSpec
from repro_torch.eda import batched_flow as tflow
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.maze_route.frontier import canvas_index
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

# The reference's flow-equivalence specs (every BatchDims axis padded).
SPECS = ((64, 16, 2, 3), (128, 32, 4, 3), (256, 16, 8, 3), (128, 8, 4, 2),
         (64, 8, 2, 5))
# The three 4096 specs of tests/test_torch_batched_flow.py.
BUCKET = ((64, 64, 2, 3), (128, 32, 4, 2), (512, 8, 8, 4))
FULL = torch.device("cpu")      # full fields by the plain sweep


def _grid_nets(slots):
    """A single-spec numpy NetBatch from (hub, [targets]) grid-cell slots."""
    n = len(slots)
    hubs = np.zeros((1, n, 2), np.int32)
    tgts = np.zeros((1, n, 2, 2), np.int32)
    tmask = np.zeros((1, n, 2), bool)
    nmask = np.ones((1, n), bool)
    for s, (hub, targets) in enumerate(slots):
        hubs[0, s] = hub
        for j, t in enumerate(targets):
            tgts[0, s, j] = t
            tmask[0, s, j] = True
        for j in range(len(targets), 2):
            tgts[0, s, j] = hub
    return tflow.NetBatch(hubs, tgts, tmask, nmask)


def _random_nets(seed, bsz=3, n=24, gh=14, gw=18):
    """Seeded random nets on B grids of different extents in one padded
    batch: hubs and 1-2 targets a net, a few padded slots."""
    rng = np.random.default_rng(seed)
    grids = np.stack([rng.integers(gh // 2, gh + 1, bsz),
                      rng.integers(gw // 2, gw + 1, bsz)], 1).astype(np.int64)
    grids[0] = (gh, gw)
    lim = grids[:, None, :]
    hubs = (rng.random((bsz, n, 2)) * lim).astype(np.int32)
    tgts = (rng.random((bsz, n, 2, 2)) * lim[:, :, None]).astype(np.int32)
    tmask = np.ones((bsz, n, 2), bool)
    tmask[:, :, 1] = rng.random((bsz, n)) < 0.5
    nmask = rng.random((bsz, n)) < 0.9
    return tflow.NetBatch(hubs, tgts, tmask, nmask), grids


def _occ0(grids, capacity):
    gh, gw = int(grids[:, 0].max()), int(grids[:, 1].max())
    iy = np.arange(gh)[None, :, None]
    ix = np.arange(gw)[None, None, :]
    blocked = (iy >= grids[:, 0, None, None]) | (ix >= grids[:, 1, None, None])
    return np.where(blocked, capacity, 0).astype(np.int32)


def _spec_nets():
    st = tflow.layout_stages([TSpec(*s) for s in SPECS], device="cpu")
    nets = tflow.NetBatch(*(a.numpy() for a in st.nets))
    return nets, st.ops.width.numpy(), st.ops.height.numpy()


def _spec_case():
    nets, w, h = _spec_nets()
    grids = np.array([tflow.grid_shape(int(a), int(b), 64)
                      for a, b in zip(w, h)], np.int64)
    return nets, grids, 4


def _scenario(name):
    """(nets, grids, capacity) of a named scenario."""
    if name == "specs":
        return _spec_case()
    if name.startswith("random"):
        seed, cap = {"random0": (0, 1), "random1": (1, 2),
                     "random2": (2, 1)}[name]
        nets, grids = _random_nets(seed)
        return nets, grids, cap
    one = np.array([[8, 12]], np.int64)
    slots = {
        "serialize": ([((2, 2), [(2, 6)])] * 3, 100),
        "collision": ([((0, 0), [(0, 2)]), ((3, 3), [(3, 9)])], 1),
        "corridor": ([((4, 0), [(4, 8)]), ((3, 0), [(3, 8)]),
                      ((5, 0), [(5, 8)]), ((4, 1), [(4, 7)])], 1),
    }[name]
    return _grid_nets(slots[0]), one, slots[1]


SCENARIOS = ("specs", "random0", "random1", "random2", "serialize",
             "collision", "corridor")


def _assert_same(got, want):
    occ, routed, failed, wl, rounds, coll, sched = got
    r_occ, r_routed, r_failed, r_wl, r_rounds, r_coll, r_sched = want
    np.testing.assert_array_equal(occ, r_occ)
    np.testing.assert_array_equal(routed, r_routed)
    np.testing.assert_array_equal(failed, r_failed)
    np.testing.assert_array_equal(wl, r_wl)
    assert (rounds, coll) == (r_rounds, r_coll)
    assert sched.dispatches == r_sched.dispatches
    np.testing.assert_array_equal(sched.bboxes, r_sched.bboxes)
    assert (sched.rounds, sched.collisions, sched.crossings) == \
        (r_sched.rounds, r_sched.collisions, r_sched.crossings)


@pytest.mark.parametrize("name", SCENARIOS)
def test_concurrent_route_equals_reference(name):
    nets, grids, cap = _scenario(name)
    occ0 = _occ0(grids, cap)
    want = rflow._concurrent_route(rflow.NetBatch(*nets), grids, occ0,
                                   capacity=cap, record=True)
    got = tflow._concurrent_route(nets, grids, occ0, capacity=cap,
                                  record=True)
    _assert_same(got, want)
    sched = got[-1]
    assert len(sched.bfs_lanes) == sched.rounds
    assert all(0 <= n <= len(d) for n, d in zip(sched.bfs_lanes,
                                                sched.dispatches))


@pytest.mark.parametrize("name", SCENARIOS)
def test_full_fields_equal_early_exit(name):
    """The card's field step (full fields, here by the plain sweep) gives
    every output of the host early-exit step, schedule included."""
    nets, grids, cap = _scenario(name)
    occ0 = _occ0(grids, cap)
    early = tflow._concurrent_route(nets, grids, occ0, capacity=cap,
                                    record=True)
    full = tflow._concurrent_route(nets, grids, occ0, capacity=cap,
                                   record=True, device=FULL)
    _assert_same(full, early)
    assert full[-1].bfs_lanes == early[-1].bfs_lanes


def test_scenarios_reach_bfs_lanes_and_collisions():
    """The scenarios drive the BFS field step and the collision retry,
    so the equalities above cover them."""
    bfs = coll = 0
    for name in SCENARIOS:
        nets, grids, cap = _scenario(name)
        *_, sched = tflow._concurrent_route(nets, grids, _occ0(grids, cap),
                                            capacity=cap, record=True)
        bfs += sum(sched.bfs_lanes)
        coll += sched.collisions
    assert bfs > 0 and coll > 0


def test_bfs_fields_full_equal_early_exit_below_resolution():
    """`_bfs_fields`: the full field equals the early-exit field at every
    cell the early exit assigned, and exceeds its resolution level
    elsewhere."""
    nets, grids, cap = _scenario("random0")
    occ = _occ0(grids, cap)
    rng = np.random.default_rng(3)
    occ = np.where(rng.random(occ.shape) < 0.25, cap, occ).astype(np.int32)
    lb = np.array([0, 1, 2, 0])
    ls = np.array([0, 1, 2, 3])
    hubs, tgts, tmask = nets.hubs, nets.tgts, nets.tmask
    args = (occ, lb, hubs[lb, ls, 0], hubs[lb, ls, 1], tgts[lb, ls, :, 0],
            tgts[lb, ls, :, 1], tmask[lb, ls], grids)
    early = tflow._bfs_fields(*args, capacity=cap, device=None)
    full = tflow._bfs_fields(*args, capacity=cap, device=FULL)
    assert early.shape == full.shape
    set_ = early < tflow.INF
    np.testing.assert_array_equal(full[set_], early[set_])
    level = np.where(set_, early, -1).max(1)
    assert (full[~set_] > np.repeat(level, (~set_).sum(1))).all()


def _sequential_reference(nets, gh, gw, capacity):
    """The reference router's occupancy evolution on grid-cell nets, slot
    order, with its own backtrace."""
    hubs, tgts, tmask, nmask = (np.asarray(a) for a in nets)
    occ_count = np.zeros((gh, gw), np.int32)
    routed = failed = wl = 0
    for s in range(nmask.shape[1]):
        if not nmask[0, s]:
            continue
        seed = np.zeros((gh, gw), bool)
        seed[tuple(hubs[0, s])] = True
        dist = wavefront_distance_bfs(occ_count >= capacity, seed)
        pts, ok = [], True
        for j in range(2):
            if not tmask[0, s, j]:
                continue
            path = rrouter.backtrace(dist, tuple(tgts[0, s, j]))
            if path is None:
                ok = False
                break
            pts.extend(path)
        if ok:
            for y, x in pts:
                occ_count[y, x] += 1
            routed += 1
            wl += len(pts)
        else:
            failed += 1
    return routed, failed, wl, occ_count


def _run(name, device=None):
    nets, grids, cap = _scenario(name)
    return tflow._concurrent_route(nets, grids, _occ0(grids, cap),
                                   capacity=cap, record=True, device=device)


@pytest.mark.parametrize("device", [None, FULL], ids=["early", "full"])
def test_identical_bbox_nets_serialize(device):
    occ, routed, failed, wl, rounds, collisions, sched = \
        _run("serialize", device)
    assert [len(d) for d in sched.dispatches] == [1, 1, 1]
    assert rounds == 3 and collisions == 0
    assert (int(routed[0]), int(failed[0]), int(wl[0])) == (3, 0, 15)
    nets, _, _ = _scenario("serialize")
    s_routed, s_failed, s_wl, s_occ = _sequential_reference(nets, 8, 12, 100)
    assert (s_routed, s_failed, s_wl) == (3, 0, 15)
    np.testing.assert_array_equal(occ[0], s_occ)


@pytest.mark.parametrize("device", [None, FULL], ids=["early", "full"])
def test_collision_retry_matches_sequential(device):
    occ, routed, failed, wl, rounds, collisions, sched = \
        _run("collision", device)
    assert len(sched.dispatches[0]) == 2
    assert collisions >= 1 and rounds >= 2
    nets, _, _ = _scenario("collision")
    s = _sequential_reference(nets, 8, 12, 1)
    assert (int(routed[0]), int(failed[0]), int(wl[0])) == s[:3]
    np.testing.assert_array_equal(occ[0], s[3])


@pytest.mark.parametrize("device", [None, FULL], ids=["early", "full"])
def test_blocked_corridor_failures_match_sequential(device):
    occ, routed, failed, wl, *_ = _run("corridor", device)
    nets, _, _ = _scenario("corridor")
    s = _sequential_reference(nets, 8, 12, 1)
    assert (int(routed[0]), int(failed[0]), int(wl[0])) == s[:3]
    assert s[1] > 0
    np.testing.assert_array_equal(occ[0], s[3])


def test_no_round_codispatches_overlapping_nets():
    nets, w, h = _spec_nets()
    tnets = tflow.NetBatch(*(torch.from_numpy(a) for a in nets))
    res = tflow.batched_route(tnets, w, h, engine="concurrent",
                              record_schedule=True)
    sched = res.schedule
    assert sched is not None and sched.rounds == res.rounds
    assert len(sched.dispatches) == sched.rounds
    checked = 0
    for lanes in sched.dispatches:
        per_spec: dict[int, list] = {}
        for b, s in lanes:
            per_spec.setdefault(b, []).append(sched.bboxes[b, s])
        for boxes in per_spec.values():
            for i in range(len(boxes)):
                for j in range(i + 1, len(boxes)):
                    assert not tflow._bbox_overlap(boxes[i], boxes[j])
                    checked += 1
    assert checked > 0


def test_engines_bit_identical_and_unknown_engine():
    nets, w, h = _spec_nets()
    tnets = tflow.NetBatch(*(torch.from_numpy(a) for a in nets))
    n0 = sum(LAUNCHES.values())
    conc = tflow.batched_route(tnets, w, h, engine="concurrent")
    scan = tflow.batched_route(tnets, w, h, engine="scan")
    assert sum(LAUNCHES.values()) == n0           # CPU: no kernel launch
    assert (conc.engine, scan.engine) == ("concurrent", "scan")
    assert conc.schedule is None and scan.schedule is None
    for name in ("routed", "failed", "wirelength", "occ_count", "grids"):
        np.testing.assert_array_equal(getattr(conc, name),
                                      getattr(scan, name), err_msg=name)
    with pytest.raises(ValueError, match="engine"):
        tflow.batched_route(tnets, w, h, engine="astar")


def test_batched_route_equals_reference_on_spec_nets():
    nets, w, h = _spec_nets()
    want = rflow.batched_route(rflow.NetBatch(*nets), w, h,
                               engine="concurrent", record_schedule=True)
    got = tflow.batched_route(
        tflow.NetBatch(*(torch.from_numpy(a) for a in nets)), w, h,
        engine="concurrent", record_schedule=True)
    for name in ("routed", "failed", "wirelength", "occ_count", "grids"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert (got.engine, got.rounds, got.collisions) == \
        (want.engine, want.rounds, want.collisions)
    assert got.schedule.dispatches == want.schedule.dispatches


@pytest.fixture(scope="module")
def bucket():
    rspecs = [RSpec(*s) for s in BUCKET]
    ref = rflow.generate_layouts(rspecs, engine="concurrent")
    tspecs = [TSpec(*s) for s in BUCKET]
    conc = tflow.generate_layouts(tspecs, engine="concurrent", device="cpu",
                                  record_schedule=True)
    scan = tflow.generate_layouts(tspecs, device="cpu")
    return ref, conc, scan


@pytest.mark.parametrize("engine", ["concurrent", "scan"])
def test_both_port_engines_equal_reference_bucket(bucket, engine):
    ref, conc, scan = bucket
    port = conc if engine == "concurrent" else scan
    assert port.routing.engine == engine
    assert port.metrics_rows() == ref.metrics_rows()
    np.testing.assert_array_equal(port.routing.occ_count,
                                  ref.routing.occ_count)
    if engine == "concurrent":
        assert (port.routing.rounds, port.routing.collisions) == \
            (ref.routing.rounds, ref.routing.collisions)
        assert port.routing.schedule.rounds == ref.routing.rounds


def test_session_concurrent_engine_provenance():
    """`DesignSession(route_engine="concurrent")`: the same rows as the
    reference's flow, provenance naming the engine and its rounds; a
    call's own `engine` wins over the session's."""
    session = DesignSession(device="cpu", route_engine="concurrent")
    req = DesignRequest(array_size=4096, pop_size=64, generations=10, seed=2,
                        requirements=Requirements(min_snr_db=17.0,
                                                  min_tops=0.4))
    art = session.run(req)
    specs = [RSpec(*s.as_tuple()) for s in art.pareto.specs]
    want = rflow.generate_layouts(specs, engine="concurrent")
    assert list(art.layout_rows) == want.metrics_rows()
    prov = art.provenance
    assert prov.route_engine == "concurrent"
    assert (prov.route_rounds, prov.route_collisions) == \
        (want.routing.rounds, want.routing.collisions)
    scan = session.layout(list(art.pareto.specs), engine="scan")
    assert scan.routing.engine == "scan"
    assert scan.metrics_rows() == want.metrics_rows()


class TestStillValidBound:
    def test_manhattan_entry(self):
        e = tflow._Buffered(cells=np.zeros(0, np.int64), wl=5, ok=True,
                            d0max=4, dist=None, hub=(0, 0))
        assert tflow._still_valid(e, np.array([3]), np.array([3]), 14)
        assert not tflow._still_valid(e, np.array([1]), np.array([2]), 14)
        assert tflow._still_valid(e, np.array([2]), np.array([2]), 14)

    def test_dist_field_entry(self):
        gh, gw = 6, 10
        stride = gw + 2
        dist = np.full((gh + 2) * stride, 2 ** 29, np.int32)
        dist[canvas_index(1, 1, stride)] = 2
        e = tflow._Buffered(cells=np.zeros(0, np.int64), wl=4, ok=True,
                            d0max=3, dist=dist, hub=None)
        assert not tflow._still_valid(e, np.array([1]), np.array([1]), stride)
        e2 = dataclasses.replace(e, wl=3, d0max=2)
        assert tflow._still_valid(e2, np.array([1]), np.array([1]), stride)
        assert rflow._still_valid(rflow._Buffered(**dataclasses.asdict(e2)),
                                  np.array([1]), np.array([1]), stride)

    def test_failed_and_trivial_entries_always_valid(self):
        failed = tflow._Buffered(cells=np.zeros(0, np.int64), wl=0, ok=False,
                                 d0max=9, dist=None, hub=(0, 0))
        trivial = tflow._Buffered(cells=np.zeros(0, np.int64), wl=0, ok=True,
                                  d0max=-1, dist=None, hub=(0, 0))
        yx = (np.array([0]), np.array([0]))
        assert tflow._still_valid(failed, *yx, stride=14)
        assert tflow._still_valid(trivial, *yx, stride=14)


def test_helpers_equal_reference():
    """The host helpers the scheduler is built of, on seeded inputs."""
    rng = np.random.default_rng(5)
    lengths = rng.integers(0, 6, 12)
    np.testing.assert_array_equal(tflow._ragged_arange(lengths),
                                  rflow._ragged_arange(lengths))
    lane = np.arange(9)
    hy, hx, ty, tx = (rng.integers(0, 20, 9) for _ in range(4))
    for a, b in zip(tflow._manhattan_paths(lane, hy, hx, ty, tx),
                    rflow._manhattan_paths(lane, hy, hx, ty, tx)):
        np.testing.assert_array_equal(a, b)
    lanes = rng.integers(0, 5, 40)
    cells = rng.integers(0, 100, 40)
    for a, b in zip(tflow._group_cells(lanes, cells, 6),
                    rflow._group_cells(lanes, cells, 6)):
        np.testing.assert_array_equal(a, b)
    boxes = rng.integers(0, 10, (30, 4))
    boxes[:, 2:] += boxes[:, :2]
    for a in boxes[:6]:
        for b in boxes[6:]:
            assert tflow._bbox_overlap(a, b) == rflow._bbox_overlap(a, b)
