"""Batched layout generation: a distilled Pareto set through place / DRC /
nets / route / metrics, every stage over the whole spec batch.

Counterpart of `repro.eda.batched_flow`:

  * **place** — `placer.rect_tensors` expands the stacked
    `LayoutOperands` of all specs at once, padded to the batch's index
    extents (`BatchDims`) with validity masks;
  * **DRC** — a pairwise-overlap count on column 0 (every column is an
    x-translate of it) times W, plus bounds checks;
  * **nets** — the inter-template nets derived from the rect tensors,
    ordered longest-first by a stable sort, as the sequential router
    orders them;
  * **route** — every net slot of the bucket in one `route_slots`
    launch (the reference's `_route_program`): one persistent CTA per
    grid runs the grid's slots in order, each a BFS from the net's hub
    that stops at its last target, then the backtrace and the occupancy
    commit, all on chip.  Cells beyond a spec's own routing grid are
    pre-blocked, so padding a small spec up to the batch's largest grid
    cannot open new paths.  That is the scan engine.  The concurrent
    engine (`engine="concurrent"`) routes many nets of a spec per round
    under the reference's conflict-aware host scheduler and commits them
    in slot order; its BFS fields come from the host frontier engine
    with early exit for CPU tensors and from one `wavefront` launch per
    round (full fields) for CUDA tensors.  Both engines give the same
    rows, occupancy and counts.

`engine=None` is the scan engine on every device.  The reference picks
scan on the TPU and concurrent elsewhere, a speed choice of its
backends that changes no result; here `route_slots` lays out a whole
bucket in one launch, and the session's provenance records "scan" for
a default request.

Per-spec results unpack to the sequential flow's types
(`BatchedLayoutResult.placements()` / `.drc_reports()`); the full wire
geometry of one spec comes from `repro_torch.eda.flow.generate_layout`.
"""
from __future__ import annotations

import collections
import dataclasses
import json
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import estimator
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.eda import netlist as nl_mod
from repro_torch.eda.flow import DRCReport
from repro_torch.eda.placer import (CATEGORIES, CATEGORY_CELL, BatchDims,
                                    LayoutOperands, Placed, Placement,
                                    PlacerGeometry, category_names,
                                    dims_for_spec, geometry, layout_operands,
                                    rect_tensors)
from repro_torch.eda.router import grid_shape
from repro_torch.kernels.maze_route import ref as mr_ref
from repro_torch.kernels.maze_route.frontier import (canvas_free,
                                                     canvas_index,
                                                     expand_buckets, strides)
from repro_torch.kernels.maze_route.ops import (INF, route_slots,
                                                wavefront_distance)

I32 = torch.int32

# Pairwise DRC compares at most this many rect pairs per chunk of specs.
_DRC_PAIRS_PER_CHUNK = 1 << 26


def stack_layout_operands(specs, geom: PlacerGeometry,
                          device="cpu") -> LayoutOperands:
    """One operand tuple for the whole spec batch: int32 leaves (B,)."""
    per_spec = [layout_operands(s, geom) for s in specs]
    return LayoutOperands(*(torch.tensor(col, dtype=I32, device=device)
                            for col in zip(*per_spec)))


def _place_program(ops: LayoutOperands, *, dims: BatchDims,
                   geom: PlacerGeometry) -> dict:
    return rect_tensors(ops, dims, geom)


# ----------------------------------------------------------------------
# DRC: pairwise overlaps on column 0, bounds over every rect
# ----------------------------------------------------------------------
def _drc_program(tensors, ops: LayoutOperands, *, dims: BatchDims,
                 geom: PlacerGeometry):
    del dims, geom  # baked into the tensors
    col = torch.cat([
        tensors["sram"][0][:, 0],
        tensors["cap"][0][:, 0],
        tensors["sw"][0][:, 0],
        tensors["comp"][0][:, :1],
        tensors["sar"][0][:, :1],
        tensors["dff"][0][:, 0],
    ], 1)
    cmask = torch.cat([
        tensors["sram"][1][:, 0],
        tensors["cap"][1][:, 0],
        tensors["sw"][1][:, 0],
        tensors["comp"][1][:, :1],
        tensors["sar"][1][:, :1],
        tensors["dff"][1][:, 0],
    ], 1)
    bsz, c = cmask.shape
    upper = torch.triu(torch.ones((c, c), dtype=torch.bool,
                                  device=col.device), diagonal=1)
    chunk = max(1, _DRC_PAIRS_PER_CHUNK // max(c * c, 1))
    counts = []
    for s in range(0, bsz, chunk):
        a = col[s:s + chunk, :, None, :]
        b = col[s:s + chunk, None, :, :]
        ov = ((a[..., 0] < b[..., 0] + b[..., 2])
              & (b[..., 0] < a[..., 0] + a[..., 2])
              & (a[..., 1] < b[..., 1] + b[..., 3])
              & (b[..., 1] < a[..., 1] + a[..., 3]))
        m = cmask[s:s + chunk]
        valid = m[:, :, None] & m[:, None, :] & upper[None]
        counts.append((ov & valid).sum((1, 2)))
    overlaps = torch.cat(counts).to(I32) * ops.w

    oob = torch.zeros_like(ops.w)
    for cat in CATEGORIES:
        rects, mask = tensors[cat]
        rects = rects.reshape(bsz, -1, 4)
        bad = ((rects[..., 1] + rects[..., 3] > ops.height[:, None] + 1)
               | (rects[..., 0] + rects[..., 2] > ops.width[:, None] + 1))
        oob += (bad & mask.reshape(bsz, -1)).sum(1).to(I32)
    return overlaps, oob


# ----------------------------------------------------------------------
# Net derivation: same nets, same longest-first order as the host flow
# ----------------------------------------------------------------------
class NetBatch(NamedTuple):
    """Routing-ready net slots in routing (longest-first) order; grid
    cells are (gy, gx), masks gate targets and padded slots."""

    hubs: torch.Tensor        # (B, N, 2) int32
    tgts: torch.Tensor        # (B, N, 2, 2) int32 — up to two star targets
    tmask: torch.Tensor       # (B, N, 2) bool
    nmask: torch.Tensor       # (B, N) bool


def _centers(t: torch.Tensor):
    return t[..., 0] + t[..., 2] // 2, t[..., 1] + t[..., 3] // 2


def _nets_program(tensors, ops: LayoutOperands, *, dims: BatchDims,
                  geom: PlacerGeometry, coarse: int) -> NetBatch:
    del geom
    bsz = ops.w.shape[0]
    dev = ops.w.device
    comp_x, comp_y = _centers(tensors["comp"][0])        # (B, W)
    sar_x, sar_y = _centers(tensors["sar"][0])           # (B, W)
    cap_x, cap_y = _centers(tensors["cap"][0])           # (B, W, NLA)
    sram_x, sram_y = _centers(tensors["sram"][0])        # (B, W, H)
    rd_x, rd_y = _centers(tensors["rd"][0])              # (B, RD)

    top = (ops.n_la - 1).long()[:, None, None].expand(bsz, dims.w, 1)
    cap0 = torch.stack([cap_x[:, :, 0], cap_y[:, :, 0]], -1)
    capt = torch.stack([cap_x.gather(2, top)[:, :, 0],
                        cap_y.gather(2, top)[:, :, 0]], -1)
    comp = torch.stack([comp_x, comp_y], -1)             # (B, W, 2)
    sar = torch.stack([sar_x, sar_y], -1)
    jvalid = torch.arange(dims.w, device=dev)[None, :] < ops.w[:, None]

    # per-column nets, interleaved (rbl_j, cmp_j) like the host net list
    rbl_t = torch.stack([cap0, capt], 2)                 # (B, W, 2, 2)
    cmp_t = torch.stack([sar, sar], 2)
    col_hubs = torch.stack([comp, comp], 2)              # (B, W, 2net, 2)
    col_tgts = torch.stack([rbl_t, cmp_t], 2)            # (B, W, 2net, 2, 2)
    col_tmask = torch.tensor([[True, True], [True, False]],
                             device=dev).expand(bsz, dims.w, 2, 2)
    col_nmask = jvalid[:, :, None].expand(bsz, dims.w, 2)

    # row-driver nets: driver -> farthest column's cell in that row
    r = torch.arange(dims.rd, dtype=I32, device=dev)[None, :]   # (1, RD)
    flat = ((ops.w[:, None] - 1) * dims.h + r).long()           # sram[w-1, r]
    far_x = sram_x.reshape(bsz, -1).gather(1, flat)
    far_y = sram_y.reshape(bsz, -1).gather(1, flat)
    rd_hubs = torch.stack([rd_x, rd_y], -1)              # (B, RD, 2)
    far = torch.stack([far_x, far_y], -1)
    rd_tgts = torch.stack([far, far], 2)                 # (B, RD, 2, 2)
    rd_tmask = torch.tensor([True, False], device=dev).expand(bsz, dims.rd, 2)
    rd_nmask = r < ops.n_rd[:, None]

    hubs = torch.cat([col_hubs.reshape(bsz, -1, 2), rd_hubs], 1)
    tgts = torch.cat([col_tgts.reshape(bsz, -1, 2, 2), rd_tgts], 1)
    tmask = torch.cat([col_tmask.reshape(bsz, -1, 2), rd_tmask], 1)
    nmask = torch.cat([col_nmask.reshape(bsz, -1), rd_nmask], 1)

    # longest (bounding box) first, in F units, stable
    pins = torch.cat([hubs[:, :, None], tgts], 2)        # (B, N, 3, 2)
    pmask = torch.cat([torch.ones_like(tmask[:, :, :1]), tmask], 2)
    px = torch.where(pmask, pins[..., 0], hubs[:, :, None, 0])
    py = torch.where(pmask, pins[..., 1], hubs[:, :, None, 1])
    span = ((px.amax(2) - px.amin(2)) + (py.amax(2) - py.amin(2)))
    span = torch.where(nmask, span, -1)
    order = torch.argsort(-span, dim=1, stable=True)     # (B, N)

    def take(a):
        idx = order.reshape(order.shape + (1,) * (a.dim() - 2))
        return a.gather(1, idx.expand(order.shape + a.shape[2:]))

    hubs, tgts, tmask, nmask = take(hubs), take(tgts), take(tmask), take(nmask)

    # F-unit pin coords -> clipped per-spec grid cells (gy, gx)
    gh = torch.clamp_min(ops.height // coarse + 3, 2)[:, None]
    gw = torch.clamp_min(ops.width // coarse + 2, 2)[:, None]

    def to_cell(xy, gh, gw):
        gy = torch.minimum(torch.clamp_min(xy[..., 1] // coarse, 0), gh - 1)
        gx = torch.minimum(torch.clamp_min(xy[..., 0] // coarse, 0), gw - 1)
        return torch.stack([gy, gx], -1).to(I32)

    return NetBatch(to_cell(hubs, gh, gw),
                    to_cell(tgts, gh[..., None], gw[..., None]),
                    tmask.contiguous(), nmask.contiguous())


# ----------------------------------------------------------------------
# Concurrent-net routing: conflict-aware scheduling of many nets a round
# ----------------------------------------------------------------------
#
# The scan engine routes one net slot after another.  The concurrent
# engine routes many nets of one spec per round and keeps the result
# bit-identical to the sequential router by separating *when a field is
# computed* from *when its route commits* (the reference's scheduler,
# copied in its order):
#
#   * rounds are colours of the conflict graph: each round greedily picks
#     pending nets, in slot order, whose expanded bounding boxes are
#     pairwise disjoint within a spec (a net that conflicts with an
#     earlier pick waits for a later round);
#   * the picked lanes' distance fields are computed together: closed
#     form while the spec has no blocked cell near the lane (an
#     obstacle-free rectangle's BFS field is Manhattan distance), else a
#     BFS field (`_bfs_fields`);
#   * routes commit strictly in slot order.  A commit that pushes cells
#     across the capacity threshold (newly blocked cells X) is the only
#     event that can perturb later fields, and a buffered field stays
#     exact iff every target distance d0 satisfies d0 <= min over x in X
#     of dist(x).  Fields that fail the test are collisions: dropped and
#     recomputed in a later round against the updated occupancy.
#
# The head of each spec's pending queue is always computed in the round
# and always commits, so every round makes progress.


@dataclasses.dataclass
class RouteSchedule:
    """Trace of the conflict-aware scheduler.

    dispatches[r] = (spec, slot) lanes whose fields were computed in round
    r (closed-form lanes first, then BFS lanes); bfs_lanes[r] = how many
    of them took a BFS field; bboxes is every net's expanded bounding box
    (y0, x0, y1, x1 inclusive, grid cells), so tests can assert no round
    co-dispatched two overlapping nets of one spec."""

    dispatches: list
    bboxes: np.ndarray
    rounds: int = 0
    collisions: int = 0
    crossings: int = 0
    bfs_lanes: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Buffered:
    """A computed-but-not-yet-committed route of one (spec, slot) lane."""

    cells: np.ndarray            # occupancy increments, real-grid flat idx
    wl: int                      # wirelength contribution if committed
    ok: bool                     # every valid target reachable
    d0max: int                   # max finite target distance (-1: none)
    dist: np.ndarray | None      # (C,) canvas field (BFS lanes)
    hub: tuple | None            # (hy, hx): closed-form field (Manhattan)


def _still_valid(e: _Buffered, ys: np.ndarray, xs: np.ndarray,
                 stride: int) -> bool:
    """Does `e`'s route survive cells (ys, xs) becoming blocked?

    Valid iff d0max <= min dist(x) over the newly blocked cells.
    Failed-net entries are always valid: an unreachable target stays
    unreachable under more blocking, and nothing else of theirs is read."""
    if not e.ok or e.d0max < 0:
        return True
    if e.dist is not None:
        dmin = int(e.dist[canvas_index(ys, xs, stride)].min())
    else:
        hy, hx = e.hub
        dmin = int((np.abs(ys - hy) + np.abs(xs - hx)).min())
    return e.d0max <= dmin


def _ragged_arange(lengths: np.ndarray) -> np.ndarray:
    """Concatenated [0..l) ranges: [0,1,..,l0-1, 0,1,..,l1-1, ...]."""
    ends = np.cumsum(lengths)
    return np.arange(int(ends[-1]) if len(ends) else 0) \
        - np.repeat(ends - lengths, lengths)


def _manhattan_paths(lane, hy, hx, ty, tx):
    """Closed-form backtrace on an obstacle-free grid, all walkers at once.

    The field is |dy|+|dx| and the tie-break (first `NEIGHBORS` entry at
    d-1: down, up, right, left) walks vertically to the hub row, then
    horizontally: two ragged runs.  Returns concatenated (lane, y, x)
    path cells, d0+1 of them per walker."""
    sy = np.sign(hy - ty)
    lv = np.abs(hy - ty) + 1            # vertical run, target included
    sx = np.sign(hx - tx)
    lh = np.abs(hx - tx)                # horizontal run, pivot excluded
    ys_v = np.repeat(ty, lv) + np.repeat(sy, lv) * _ragged_arange(lv)
    xs_v = np.repeat(tx, lv)
    ys_h = np.repeat(hy, lh)
    xs_h = np.repeat(tx + sx, lh) + np.repeat(sx, lh) * _ragged_arange(lh)
    return (np.concatenate([np.repeat(lane, lv), np.repeat(lane, lh)]),
            np.concatenate([ys_v, ys_h]), np.concatenate([xs_v, xs_h]))


def _walk_paths(dist: np.ndarray, lanes, start, steps, stride: int):
    """Multi-walker backtrace over canvas distance fields: every active
    walker steps at once to its first `NEIGHBORS` cell at d-1.  Start
    cells are not emitted.  Returns concatenated (lane, canvas idx) of
    stepped-to cells."""
    offs = strides(stride)
    cur, d, who = start.copy(), steps.copy(), np.asarray(lanes).copy()
    out_l: list[np.ndarray] = []
    out_c: list[np.ndarray] = []
    act = d > 0
    cur, d, who = cur[act], d[act], who[act]
    while d.size:
        nbr = dist[who[:, None], cur[:, None] + offs[None, :]]
        sel = np.argmax(nbr == (d - 1)[:, None], axis=1)
        cur = cur + offs[sel]
        out_l.append(who.copy())
        out_c.append(cur.copy())
        d = d - 1
        act = d > 0
        if not act.all():
            cur, d, who = cur[act], d[act], who[act]
    if not out_l:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    return np.concatenate(out_l), np.concatenate(out_c)


def _group_cells(lanes: np.ndarray, cells: np.ndarray, n_lanes: int):
    """Split concatenated (lane, cell) emissions into per-lane arrays."""
    order = np.argsort(lanes, kind="stable")
    lanes, cells = lanes[order], cells[order]
    bounds = np.searchsorted(lanes, np.arange(n_lanes + 1))
    return [cells[bounds[k]:bounds[k + 1]] for k in range(n_lanes)]


def _bbox_overlap(a, b) -> bool:
    return bool(a[0] <= b[2] and b[0] <= a[2]
                and a[1] <= b[3] and b[1] <= a[3])


def _bfs_fields(occ, lb, hy, hx, t_y, t_x, tm, grids, *, capacity: int,
                device):
    """Canvas BFS fields, (L, (Gh+2)*(Gw+2)) int32 with an `INF` border,
    of a round's L BFS lanes: lane k seeds at its hub (hy[k], hx[k]) on
    spec lb[k]'s occupancy (a cell is blocked at `capacity`).

    device None: the host frontier engine with the reference's early
    exit, each lane stopping at the level that resolves its masked
    targets (t_y, t_x, tm).  A torch device: full fields by one
    `wavefront_distance` call there (the `wavefront` kernel on CUDA, one
    launch; the plain sweep on the CPU), each lane on its spec's own
    grid, copied back in one transfer.  Both give what the router reads:
    the early exit stops after a level L with every target resolved, and
    a cell it leaves at `INF` has a true distance of at least L+1, while
    every value the host reads is either at most L (where the fields
    agree) or is compared against d0max <= L+1 (`_still_valid`)."""
    nlan = len(lb)
    gh, gw = occ.shape[1:]
    stride = gw + 2
    if device is not None:
        ub, inv = np.unique(lb, return_inverse=True)
        blk = torch.from_numpy(occ[ub] >= capacity).to(device)
        blk = blk[torch.from_numpy(inv.astype(np.int64)).to(device)]
        seed = torch.zeros_like(blk)
        seed[torch.arange(nlan, device=device),
             torch.from_numpy(hy.astype(np.int64)).to(device),
             torch.from_numpy(hx.astype(np.int64)).to(device)] = True
        lane_grids = torch.from_numpy(grids[lb].astype(np.int32)).to(device)
        field = wavefront_distance(blk, seed, lane_grids)
        host = torch.empty(field.shape, dtype=torch.int32,
                           pin_memory=field.is_cuda)
        host.copy_(field)
        dist = np.full((nlan, gh + 2, stride), INF, np.int32)
        dist[:, 1:-1, 1:-1] = host.numpy()
        return dist.reshape(nlan, -1)

    karr = np.arange(nlan, dtype=np.int64)
    offs = strides(stride)
    occ_l = occ[lb] >= capacity
    free = canvas_free(occ_l)
    dist = np.full((nlan, (gh + 2) * stride), INF, np.int32)
    sidx = canvas_index(hy, hx, stride)
    dist[karr, sidx] = 0
    tciv = canvas_index(t_y, t_x, stride)
    tb = occ_l.reshape(nlan, -1)[karr[:, None], t_y * gw + t_x] & tm

    def resolved():
        res = dist[karr[:, None], tciv] < INF
        if tb.any():
            ndv = dist[karr[:, None, None],
                       tciv[:, :, None] + offs[None, None, :]]
            res = res | (tb & (ndv < INF).any(-1))
        return (res | ~tm).all(1)

    expand_buckets(free, dist, karr, sidx, stride, resolved)
    return dist


def _concurrent_route(nets: NetBatch, grids: np.ndarray, occ0: np.ndarray,
                      *, capacity: int, record: bool = False, device=None):
    """Route every net of every spec, conflict-aware (see section comment).

    nets: numpy `NetBatch`; occ0: (B, Gh, Gw) int32 with out-of-grid
    cells pre-blocked at `capacity`; `device` is where the BFS fields
    are computed (`_bfs_fields`).  Returns (occ, routed, failed,
    wirelength, rounds, collisions, schedule)."""
    hubs, tgts = np.asarray(nets.hubs), np.asarray(nets.tgts)
    tmask, nmask = np.asarray(nets.tmask), np.asarray(nets.nmask)
    bsz = nmask.shape[0]
    gh, gw = occ0.shape[1:]
    stride = gw + 2
    occ = occ0.copy()
    occ_flat = occ.reshape(bsz, -1)
    offs = strides(stride)

    # Expanded bounding boxes: hub + valid targets, one-cell margin for
    # the blocked-destination entry step.
    py = np.concatenate([hubs[:, :, None, 0],
                         np.where(tmask, tgts[..., 0], hubs[:, :, None, 0])],
                        axis=2)
    px = np.concatenate([hubs[:, :, None, 1],
                         np.where(tmask, tgts[..., 1], hubs[:, :, None, 1])],
                        axis=2)
    bbox = np.stack([py.min(2) - 1, px.min(2) - 1,
                     py.max(2) + 1, px.max(2) + 1], axis=-1)

    pend = [collections.deque(np.nonzero(nmask[b])[0].tolist())
            for b in range(bsz)]
    # In-grid blocked cells per spec; Manhattan distance from a lane's
    # hub to this set decides closed-form vs BFS field per lane.
    blk_yx: list[list[np.ndarray]] = []
    for b in range(bsz):
        by, bx = np.nonzero(occ[b, :grids[b, 0], :grids[b, 1]] >= capacity)
        blk_yx.append([by.astype(np.int64), bx.astype(np.int64)])
    crossed = [bool(blk_yx[b][0].size) for b in range(bsz)]
    routed = np.zeros(bsz, np.int32)
    failed = np.zeros(bsz, np.int32)
    wirelen = np.zeros(bsz, np.int32)
    buffer: dict[tuple[int, int], _Buffered] = {}
    schedule = RouteSchedule([], bbox) if record else None
    rounds = collisions = crossings = 0

    while any(pend):
        rounds += 1
        # ---- colour: greedy bbox-disjoint picks over pending, slot order
        man_lanes: list[tuple[int, int]] = []
        bfs_lanes: list[tuple[int, int]] = []
        for b in range(bsz):
            chosen: list[np.ndarray] = []
            picked: list[tuple[int, int]] = []
            for s in pend[b]:
                if (b, s) in buffer:
                    continue
                bb = bbox[b, s]
                if any(_bbox_overlap(bb, c) for c in chosen):
                    # Slots past a conflict cannot commit this round
                    # (commits are in slot order): stop the scan here.
                    break
                chosen.append(bb)
                picked.append((b, s))
            if not picked:
                continue
            if not crossed[b]:
                man_lanes.extend(picked)
                continue
            # Crossed spec: a lane whose farthest target (Manhattan) is no
            # farther than the nearest blocked cell reads no cell the
            # obstacles can shadow, so its field is still closed-form.
            ps = np.array([s for _, s in picked])
            hy, hx = hubs[b, ps, 0], hubs[b, ps, 1]
            d0 = (np.abs(tgts[b, ps, :, 0] - hy[:, None])
                  + np.abs(tgts[b, ps, :, 1] - hx[:, None]))
            d0max = np.where(tmask[b, ps], d0, -1).max(1)
            by, bx = blk_yx[b]
            blkmin = (np.abs(by[None, :] - hy[:, None])
                      + np.abs(bx[None, :] - hx[:, None])).min(1)
            for k, lane in enumerate(picked):
                (man_lanes if d0max[k] <= blkmin[k]
                 else bfs_lanes).append(lane)
        if schedule is not None:
            schedule.dispatches.append(man_lanes + bfs_lanes)
            schedule.bfs_lanes.append(len(bfs_lanes))

        # ---- expand: closed-form fields for lanes clear of obstacles
        if man_lanes:
            lb = np.array([b for b, _ in man_lanes])
            ls = np.array([s for _, s in man_lanes])
            hy, hx = hubs[lb, ls, 0], hubs[lb, ls, 1]
            t_y, t_x = tgts[lb, ls, :, 0], tgts[lb, ls, :, 1]
            tm = tmask[lb, ls]
            d0 = np.abs(t_y - hy[:, None]) + np.abs(t_x - hx[:, None])
            wk, wj = np.nonzero(tm)
            wl_l, wys, wxs = _manhattan_paths(
                wk, hy[wk], hx[wk], t_y[wk, wj], t_x[wk, wj])
            per_lane = _group_cells(wl_l, wys * gw + wxs, len(man_lanes))
            for k, (b, s) in enumerate(man_lanes):
                dk = d0[k][tm[k]]
                buffer[(b, s)] = _Buffered(
                    cells=per_lane[k], wl=int((dk + 1).sum()), ok=True,
                    d0max=int(dk.max()) if dk.size else -1,
                    dist=None, hub=(int(hy[k]), int(hx[k])))

        # ---- expand: BFS fields
        fresh: list[tuple[int, int]] = []
        if bfs_lanes:
            lb = np.array([b for b, _ in bfs_lanes])
            ls = np.array([s for _, s in bfs_lanes])
            nlan = len(bfs_lanes)
            karr = np.arange(nlan, dtype=np.int64)
            hy, hx = hubs[lb, ls, 0], hubs[lb, ls, 1]
            t_y, t_x = tgts[lb, ls, :, 0], tgts[lb, ls, :, 1]
            tm = tmask[lb, ls]
            dist = _bfs_fields(occ, lb, hy, hx, t_y, t_x, tm, grids,
                               capacity=capacity, device=device)
            tciv = canvas_index(t_y, t_x, stride)

            dv = dist[karr[:, None], tciv].astype(np.int64)
            ndv = dist[karr[:, None, None],
                       tciv[:, :, None] + offs[None, None, :]]
            nmin = ndv.min(-1).astype(np.int64)
            d0 = np.where(dv < INF, dv, np.minimum(nmin + 1, INF))
            run = tm & (d0 < INF)
            okl = (run | ~tm).all(1)
            blkt = run & (dv >= INF)
            esel = np.argmax(ndv == (d0 - 1)[:, :, None], axis=2)
            entry = tciv + offs[esel]
            start = np.where(blkt, entry, tciv)
            dstart = np.where(blkt, d0 - 1, d0)
            wk, wj = np.nonzero(run & okl[:, None])
            bw = blkt[wk, wj]
            sl, sc = _walk_paths(dist, wk, start[wk, wj], dstart[wk, wj],
                                 stride)
            lanes_all = np.concatenate([wk, wk[bw], sl])
            cidx_all = np.concatenate([tciv[wk, wj], entry[wk, wj][bw], sc])
            cells_all = ((cidx_all // stride - 1) * gw
                         + (cidx_all % stride - 1))
            per_lane = _group_cells(lanes_all, cells_all, nlan)
            for k, (b, s) in enumerate(bfs_lanes):
                dk = d0[k][run[k]]
                buffer[(b, s)] = _Buffered(
                    cells=per_lane[k],
                    wl=int((dk + 1).sum()) if okl[k] else 0,
                    ok=bool(okl[k]),
                    d0max=int(dk.max()) if (okl[k] and dk.size) else -1,
                    dist=dist[k], hub=None)
                fresh.append((b, s))

        # ---- commit: strictly in slot order, collision-test on crossings
        for b in range(bsz):
            while pend[b] and (b, pend[b][0]) in buffer:
                s = pend[b].popleft()
                e = buffer.pop((b, s))
                if not e.ok:
                    failed[b] += 1
                    continue
                routed[b] += 1
                wirelen[b] += e.wl
                uc, cnt = np.unique(e.cells, return_counts=True)
                pre = occ_flat[b, uc]
                occ_flat[b, uc] = pre + cnt
                newly = uc[(pre < capacity) & (pre + cnt >= capacity)]
                if newly.size:
                    crossings += 1
                    crossed[b] = True
                    ys, xs = newly // gw, newly % gw
                    blk_yx[b][0] = np.concatenate([blk_yx[b][0], ys])
                    blk_yx[b][1] = np.concatenate([blk_yx[b][1], xs])
                    for key in [k for k in buffer if k[0] == b]:
                        if not _still_valid(buffer[key], ys, xs, stride):
                            del buffer[key]
                            collisions += 1

        # Surviving BFS fields are views into this round's batch array;
        # copy them out so the batch can be freed.
        for key in fresh:
            if key in buffer and buffer[key].dist is not None:
                buffer[key].dist = buffer[key].dist.copy()

    if schedule is not None:
        schedule.rounds = rounds
        schedule.collisions = collisions
        schedule.crossings = crossings
    return occ, routed, failed, wirelen, rounds, collisions, schedule


# ----------------------------------------------------------------------
# Routing: the scan engine (one route_slots call) or the concurrent one
# ----------------------------------------------------------------------
class BatchedRouting(NamedTuple):
    routed: np.ndarray          # (B,) int32 — successfully routed nets
    failed: np.ndarray          # (B,) int32
    wirelength: np.ndarray      # (B,) int32 — total path points
    occ_count: np.ndarray       # (B, Gh, Gw) int32 congestion map
    grids: np.ndarray           # (B, 2) per-spec (gh, gw)
    engine: str = "scan"        # "scan" | "concurrent"
    rounds: int = 0             # scan: net slots; concurrent: rounds
    collisions: int = 0         # buffered routes dropped by a crossing
    schedule: RouteSchedule | None = None

    @property
    def success_rate(self) -> np.ndarray:
        n = self.routed + self.failed
        return np.where(n > 0, self.routed / np.maximum(n, 1), 1.0)


def route_inputs(widths: np.ndarray, heights: np.ndarray, *, coarse: int,
                 capacity: int, device):
    """The routing grids of a bucket and its starting occupancy: (grids
    (B, 2) int64 numpy, the same as int32 on `device`, blocked (B, Gh, Gw)
    bool beyond each spec's own grid, occ0 int32 = `capacity` there and 0
    elsewhere)."""
    grids = np.array([grid_shape(int(w), int(h), coarse)
                      for w, h in zip(widths, heights)], np.int64)
    gh_max, gw_max = int(grids[:, 0].max()), int(grids[:, 1].max())
    grids_t = torch.tensor(grids, dtype=I32, device=device)
    blocked = mr_ref.outside_grids((len(grids), gh_max, gw_max), grids_t,
                                   device)
    return grids, grids_t, blocked, torch.where(blocked, capacity, 0).to(I32)


def batched_route(nets: NetBatch, widths: np.ndarray, heights: np.ndarray,
                  *, coarse: int = 64, capacity: int = 4,
                  engine: str | None = None,
                  record_schedule: bool = False) -> BatchedRouting:
    """Route every net slot of every spec.

    engine: "scan" (one `route_slots` call for the bucket; also for
    None) or "concurrent" (the conflict-aware host scheduler, its BFS
    fields on the nets' device, `_bfs_fields`; `record_schedule` keeps
    its `RouteSchedule`).  Both give identical results.

    Cells beyond a spec's own routing grid are pre-blocked, so padding a
    small spec up to the batch-max grid cannot open new paths."""
    if engine not in (None, "scan", "concurrent"):
        raise ValueError(f"engine must be 'scan' or 'concurrent', "
                         f"got {engine!r}")
    dev = nets.hubs.device
    if engine == "concurrent":
        # The scheduler runs on the host; only the BFS fields use `dev`.
        grids, _, blocked, occ0 = route_inputs(
            widths, heights, coarse=coarse, capacity=capacity, device="cpu")
        nets_np = NetBatch(*(a.cpu().numpy() for a in nets))
        occ, routed, failed, wirelen, rounds, collisions, sched = \
            _concurrent_route(nets_np, grids, occ0.numpy(),
                              capacity=capacity, record=record_schedule,
                              device=None if dev.type == "cpu" else dev)
        occ = np.where(blocked.numpy(), 0, occ).astype(np.int32)
        return BatchedRouting(routed, failed, wirelen, occ, grids,
                              "concurrent", rounds, collisions, sched)
    grids, grids_t, blocked, occ0 = route_inputs(
        widths, heights, coarse=coarse, capacity=capacity, device=dev)
    occ, routed, failed, wirelen = route_slots(occ0, *nets, grids_t,
                                               capacity)
    occ = torch.where(blocked, 0, occ).to(I32)
    return BatchedRouting(routed.cpu().numpy(), failed.cpu().numpy(),
                          wirelen.cpu().numpy(), occ.cpu().numpy(), grids,
                          "scan", int(nets.nmask.shape[1]), 0)


# ----------------------------------------------------------------------
# The end-to-end batched flow
# ----------------------------------------------------------------------
@dataclasses.dataclass
class BatchedLayoutResult:
    """Layouts for a whole spec batch, in padded tensor form (rect
    tensors stay on the device; routing stats come back to the host).

    Per spec it mirrors `flow.LayoutResult`: `metrics_rows` carries the
    same keys but the wall clock, `placements()` / `drc_reports()` unpack
    to the sequential flow's types.  Wire point lists are not kept (the
    congestion map `routing.occ_count` is); `flow.generate_layout` gives
    one spec's full wire geometry."""

    specs: tuple[MacroSpec, ...]
    dims: BatchDims
    geom: PlacerGeometry
    ops: LayoutOperands
    tensors: dict
    routing: BatchedRouting
    drc_overlaps: np.ndarray
    drc_oob: np.ndarray
    netlist_stats: list[dict]

    def __len__(self) -> int:
        return len(self.specs)

    @property
    def widths(self) -> np.ndarray:
        return self.ops.width.cpu().numpy()

    @property
    def heights(self) -> np.ndarray:
        return self.ops.height.cpu().numpy()

    @property
    def drc_clean(self) -> np.ndarray:
        return (self.drc_overlaps == 0) & (self.drc_oob == 0)

    def drc_reports(self) -> list[DRCReport]:
        return [DRCReport(int(o), int(b))
                for o, b in zip(self.drc_overlaps, self.drc_oob)]

    def placements(self) -> list[Placement]:
        """Per-spec named `Placement`s, unpacked on the host (the rect
        tensors come over once per call)."""
        host = {c: (r.cpu().numpy(), m.cpu().numpy())
                for c, (r, m) in self.tensors.items()}
        widths, heights = self.widths, self.heights
        out = []
        for i, spec in enumerate(self.specs):
            exact = dims_for_spec(spec)
            rects: list[Placed] = []
            for cat in CATEGORIES:
                vals, mask = host[cat]
                vals = vals[i].reshape(-1, 4)[mask[i].reshape(-1)]
                cell = CATEGORY_CELL[cat]
                rects.extend(
                    Placed(name, cell, *map(int, xywh)) for name, xywh
                    in zip(category_names(cat, exact, spec), vals))
            out.append(Placement(spec, rects, int(widths[i]),
                                 int(heights[i])))
        return out

    def metrics_rows(self) -> list[dict]:
        """Per-spec metrics: the keys of the reference's rows."""
        h = np.array([s.h for s in self.specs], np.float32)
        l = np.array([s.l for s in self.specs], np.float32)
        b = np.array([s.b_adc for s in self.specs], np.float32)
        est = estimator.area_f2_per_bit(h, l, b).numpy()
        area = (self.widths.astype(np.float64) * self.heights
                / np.array([s.array_size for s in self.specs]))
        succ = self.routing.success_rate
        rows = []
        for i, s in enumerate(self.specs):
            rows.append({
                "h": s.h, "w": s.w, "l": s.l, "b_adc": s.b_adc,
                "layout_area_f2_per_bit": float(area[i]),
                "estimator_area_f2_per_bit": float(est[i]),
                "area_model_error": float(area[i] / est[i] - 1.0),
                "routed_nets": int(self.routing.routed[i]),
                "failed_nets": int(self.routing.failed[i]),
                "route_success": float(succ[i]),
                "wirelength": int(self.routing.wirelength[i]),
                "drc_clean": bool(self.drc_clean[i]),
            })
        return rows

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"specs": [s.as_tuple() for s in self.specs],
                       "points": self.metrics_rows()}, f, indent=1)


class LayoutStages(NamedTuple):
    """What the stages before routing leave for a spec batch."""

    geom: PlacerGeometry
    dims: BatchDims
    ops: LayoutOperands
    tensors: dict
    drc_overlaps: torch.Tensor
    drc_oob: torch.Tensor
    nets: NetBatch


def layout_stages(specs, *, coarse: int = 64, device="cuda") -> LayoutStages:
    """Place, DRC and nets of a spec batch: `generate_layouts` up to its
    route stage (`route_inputs` then gives the route call's grids and
    starting occupancy)."""
    geom = geometry()
    dims = BatchDims.for_specs(specs)
    # Each stage is a profiler range (`layout.<stage>`), so a profile of
    # a request splits the layout time by stage; free when not profiling.
    with record_function("layout.place"):
        ops = stack_layout_operands(specs, geom, torch.device(device))
        tensors = _place_program(ops, dims=dims, geom=geom)
    with record_function("layout.drc"):
        overlaps, oob = _drc_program(tensors, ops, dims=dims, geom=geom)
    with record_function("layout.nets"):
        nets = _nets_program(tensors, ops, dims=dims, geom=geom,
                             coarse=coarse)
    return LayoutStages(geom, dims, ops, tensors, overlaps, oob, nets)


def iter_layout_buckets(buckets, *, engine: str | None = None,
                        device="cuda"):
    """Stream `(specs, coarse, capacity)` buckets through the batched
    flow, yielding each bucket's result as soon as it is done."""
    for specs, coarse, capacity in buckets:
        yield generate_layouts(specs, coarse=coarse, capacity=capacity,
                               engine=engine, device=device)


def generate_layouts(specs, *, coarse: int = 64, capacity: int = 4,
                     engine: str | None = None, device="cuda",
                     record_schedule: bool = False) -> BatchedLayoutResult:
    """Lay out a whole (e.g. Pareto-distilled) spec batch at once; per
    spec equal to the reference's `generate_layouts` rows.  `engine` and
    `record_schedule` go to `batched_route`."""
    specs = tuple(specs)
    if not specs:
        raise ValueError("generate_layouts needs at least one MacroSpec")
    st = layout_stages(specs, coarse=coarse, device=device)
    with record_function("layout.route"):
        routing = batched_route(st.nets, st.ops.width.cpu().numpy(),
                                st.ops.height.cpu().numpy(), coarse=coarse,
                                capacity=capacity, engine=engine,
                                record_schedule=record_schedule)
    stats = [nl_mod.stats_for_spec(s) for s in specs]
    return BatchedLayoutResult(
        specs=specs, dims=st.dims, geom=st.geom, ops=st.ops,
        tensors=st.tensors, routing=routing,
        drc_overlaps=st.drc_overlaps.cpu().numpy(),
        drc_oob=st.drc_oob.cpu().numpy(), netlist_stats=stats)
