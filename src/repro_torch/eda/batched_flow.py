"""Batched layout generation: a distilled Pareto set through place / DRC /
nets / route / metrics, every stage over the whole spec batch.

Counterpart of `repro.eda.batched_flow` with its scan routing engine:

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
    cannot open new paths.

The reference's concurrent host engine is not ported yet:
`engine="concurrent"` raises `NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import estimator
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.eda import netlist as nl_mod
from repro_torch.eda.placer import (CATEGORIES, BatchDims, LayoutOperands,
                                    PlacerGeometry, geometry, layout_operands,
                                    rect_tensors)
from repro_torch.eda.router import grid_shape
from repro_torch.kernels.maze_route import ref as mr_ref
from repro_torch.kernels.maze_route.ops import route_slots

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
# Routing: every net slot of the bucket in one route_slots launch
# ----------------------------------------------------------------------
class BatchedRouting(NamedTuple):
    routed: np.ndarray          # (B,) int32 — successfully routed nets
    failed: np.ndarray          # (B,) int32
    wirelength: np.ndarray      # (B,) int32 — total path points
    occ_count: np.ndarray       # (B, Gh, Gw) int32 congestion map
    grids: np.ndarray           # (B, 2) per-spec (gh, gw)
    engine: str = "scan"
    rounds: int = 0             # net slots, routed in order
    collisions: int = 0

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
                  engine: str | None = None) -> BatchedRouting:
    """Route every net slot of every spec (the scan engine).

    Cells beyond a spec's own routing grid are pre-blocked, so padding a
    small spec up to the batch-max grid cannot open new paths."""
    if engine == "concurrent":
        raise NotImplementedError(
            "the concurrent routing engine is not ported yet; use 'scan'")
    if engine not in (None, "scan"):
        raise ValueError(f"engine must be 'scan' or 'concurrent', "
                         f"got {engine!r}")
    grids, grids_t, blocked, occ0 = route_inputs(
        widths, heights, coarse=coarse, capacity=capacity,
        device=nets.hubs.device)
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
    tensors stay on the device; routing stats come back to the host)."""

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
                     engine: str | None = None,
                     device="cuda") -> BatchedLayoutResult:
    """Lay out a whole (e.g. Pareto-distilled) spec batch at once; per
    spec equal to the reference's `generate_layouts` rows."""
    specs = tuple(specs)
    if not specs:
        raise ValueError("generate_layouts needs at least one MacroSpec")
    if engine == "concurrent":
        raise NotImplementedError(
            "the concurrent routing engine is not ported yet; use 'scan'")
    st = layout_stages(specs, coarse=coarse, device=device)
    with record_function("layout.route"):
        routing = batched_route(st.nets, st.ops.width.cpu().numpy(),
                                st.ops.height.cpu().numpy(), coarse=coarse,
                                capacity=capacity, engine=engine)
    stats = [nl_mod.stats_for_spec(s) for s in specs]
    return BatchedLayoutResult(
        specs=specs, dims=st.dims, geom=st.geom, ops=st.ops,
        tensors=st.tensors, routing=routing,
        drc_overlaps=st.drc_overlaps.cpu().numpy(),
        drc_oob=st.drc_oob.cpu().numpy(), netlist_stats=stats)
