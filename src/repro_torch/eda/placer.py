"""Template-based hierarchical placer (paper Sec. 3.3, Fig. 7) as a
data-oriented template expansion on torch tensors.

Counterpart of `repro.eda.placer`.  Everything that varies per design
point is a per-spec integer operand (`LayoutOperands`, one entry per
spec of a batch), everything structural is static (`PlacerGeometry`
from the cell library, `BatchDims` padded index extents), and
`rect_tensors` produces the absolute rectangles of every template
category for the whole batch as index-grid broadcasts.

  L0  local array:  L SRAM cells in a vertical strip + CAPLC alongside
  L1  column:       H/L local arrays stacked; ADC periphery (switches,
                    comparator, SAR logic, DFFs) at the column foot in
                    the HPWL-optimal order
  L2  macro:        W columns abutted; row drivers on the left edge
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple

import torch

from repro_torch.core.acim_spec import MacroSpec
from repro_torch.eda.cells import Cell, library
from repro_torch.eda.netlist import MAX_ROW_DRIVERS

I32 = torch.int32

# Template categories of the expansion, in flat-concatenation order.
CATEGORIES = ("sram", "cap", "sw", "comp", "sar", "dff", "rd")
# Cell kind backing each category (index into the cell library).
CATEGORY_CELL = {"sram": "SRAM8T", "cap": "CAPLC", "sw": "RBLSW",
                 "comp": "COMP", "sar": "SARLOGIC", "dff": "DFF",
                 "rd": "ROWDRV"}


@dataclasses.dataclass(frozen=True)
class Placed:
    name: str
    cell: str
    x: int
    y: int
    w: int
    h: int

    @property
    def cx(self) -> float:
        return self.x + self.w / 2

    @property
    def cy(self) -> float:
        return self.y + self.h / 2


@dataclasses.dataclass
class Placement:
    spec: MacroSpec
    rects: list[Placed]
    width: int
    height: int

    @property
    def area_f2(self) -> int:
        return self.width * self.height

    def area_f2_per_bit(self) -> float:
        return self.area_f2 / self.spec.array_size


class PlacerGeometry(NamedTuple):
    """Hashable, design-point-independent geometry from the cell library."""

    s_w: int            # SRAM8T footprint
    s_h: int
    c_w: int            # CAPLC footprint
    c_h: int
    col_w: int          # column pitch: SRAM strip + cap alongside
    order: tuple[str, ...]          # optimized periphery order (4 kinds)
    pitch: tuple[tuple[str, int], ...]   # kind -> pitch-matched height
    drv_w: int          # ROWDRV footprint
    drv_h: int
    xshift: int         # columns sit right of the driver strip

    def pitch_of(self, kind: str) -> int:
        return dict(self.pitch)[kind]


class LayoutOperands(NamedTuple):
    """Per-design-point integers of the template expansion: Python ints
    for one spec (`layout_operands`), or int32 tensors with one entry per
    spec of a batch (`repro_torch.eda.batched_flow.stack_layout_operands`)."""

    h: torch.Tensor            # array height (cells per column)
    w: torch.Tensor            # columns
    l: torch.Tensor            # local-array size
    b_adc: torch.Tensor        # ADC bits
    n_la: torch.Tensor         # local arrays per column == H/L
    n_sw: torch.Tensor         # RBL isolation switches per column
    la_h: torch.Tensor         # local-array template height
    array_h: torch.Tensor      # cell-array region height
    y_sw: torch.Tensor         # periphery offsets below the array, per kind
    y_comp: torch.Tensor
    y_sar: torch.Tensor
    y_dff: torch.Tensor
    cap_y: torch.Tensor        # cap vertical centering inside the local array
    drv_pitch: torch.Tensor    # row-driver vertical pitch
    n_rd: torch.Tensor         # instantiated row drivers (min(H, 64))
    width: torch.Tensor        # macro bounding box
    height: torch.Tensor


class BatchDims(NamedTuple):
    """Static index extents of the rect tensors: per-spec exact for one
    spec, per-batch maxima for a batch.  SRAM cells are indexed (column,
    row), so the row extent is bounded by max(h)."""

    w: int
    h: int
    n_la: int
    l: int
    n_sw: int
    b: int
    rd: int

    @classmethod
    def for_specs(cls, specs) -> "BatchDims":
        return cls(
            w=max(s.w for s in specs),
            h=max(s.h for s in specs),
            n_la=max(s.n_caps for s in specs),
            l=max(s.l for s in specs),
            n_sw=max(_n_switches(s) for s in specs),
            b=max(s.b_adc for s in specs),
            rd=max(min(s.h, MAX_ROW_DRIVERS) for s in specs),
        )


def _n_switches(spec: MacroSpec) -> int:
    return len(spec.sar_groups()) - 1


def _periph_order(lib: dict[str, Cell]) -> tuple[str, ...]:
    """Order the column periphery to minimize RBL/SAR-bus HPWL over all
    4! orders of the four periphery kinds."""
    kinds = ["RBLSW", "COMP", "SARLOGIC", "DFF"]
    best, best_cost = None, None
    for order in itertools.permutations(kinds):
        y, pos = 0, {}
        for k in order:
            pos[k] = y
            y += lib[k].height
        cost = (pos["RBLSW"] + lib["RBLSW"].height
                + pos["COMP"] + lib["COMP"].height
                + abs(pos["COMP"] - pos["SARLOGIC"])
                + abs(pos["SARLOGIC"] - pos["DFF"]))
        if best_cost is None or cost < best_cost:
            best, best_cost = order, cost
    return tuple(best)


def geometry(lib: dict[str, Cell] | None = None) -> PlacerGeometry:
    """Fold the cell library into the static expansion geometry, with the
    column periphery pitch-matched to the array column width."""
    lib = lib or library()
    s, c, drv = lib["SRAM8T"], lib["CAPLC"], lib["ROWDRV"]
    col_w = s.width + c.width
    pitch = tuple(
        (k, max(1, (lib[k].area + col_w - 1) // col_w))
        for k in ("RBLSW", "COMP", "SARLOGIC", "DFF"))
    return PlacerGeometry(
        s_w=s.width, s_h=s.height, c_w=c.width, c_h=c.height, col_w=col_w,
        order=_periph_order(lib), pitch=pitch,
        drv_w=drv.width, drv_h=drv.height, xshift=drv.width + 2)


def layout_operands(spec: MacroSpec,
                    geom: PlacerGeometry | None = None) -> LayoutOperands:
    """Fold one design point into its expansion integers (Python ints)."""
    geom = geom or geometry()
    n_la = spec.n_caps
    n_sw = _n_switches(spec)
    la_h = max(spec.l * geom.s_h, geom.c_h)
    array_h = n_la * la_h
    counts = {"RBLSW": n_sw, "COMP": 1, "SARLOGIC": 1, "DFF": spec.b_adc}
    y, periph_y = 0, {}
    for k in geom.order:
        periph_y[k] = y
        y += counts[k] * geom.pitch_of(k) + 1
    return LayoutOperands(
        h=spec.h, w=spec.w, l=spec.l, b_adc=spec.b_adc, n_la=n_la, n_sw=n_sw,
        la_h=la_h, array_h=array_h, y_sw=periph_y["RBLSW"],
        y_comp=periph_y["COMP"], y_sar=periph_y["SARLOGIC"],
        y_dff=periph_y["DFF"], cap_y=(la_h - geom.c_h) // 2,
        drv_pitch=max(la_h // max(spec.l, 1), geom.drv_h),
        n_rd=min(spec.h, MAX_ROW_DRIVERS),
        width=spec.w * geom.col_w + geom.drv_w + 2, height=array_h + y)


def _stack_xywh(x, y, w, h):
    """Broadcast four int32 index-grid planes into a (..., 4) rect tensor."""
    ref = next(v for v in (x, y, w, h) if isinstance(v, torch.Tensor))
    planes = [v if isinstance(v, torch.Tensor)
              else torch.tensor(v, dtype=I32, device=ref.device)
              for v in (x, y, w, h)]
    return torch.stack(torch.broadcast_tensors(*planes), -1).to(I32)


def rect_tensors(ops: LayoutOperands, dims: BatchDims,
                 geom: PlacerGeometry) -> dict:
    """Expand a spec batch into per-category rect tensors.

    Returns {category: (rects, mask)}: `rects[b, ...]` is (x, y, w, h)
    int32 on the F grid, indexed [b, j, i] (spec, column, row or local
    array) down to [b, r] (spec, row driver), and `mask` marks the
    entries that exist for that spec (index < its operand extent)."""
    dev = ops.w.device
    ar = lambda n: torch.arange(n, dtype=I32, device=dev)  # noqa: E731
    j, row, i, g, b, r = (ar(dims.w), ar(dims.h), ar(dims.n_la),
                          ar(dims.n_sw), ar(dims.b), ar(dims.rd))
    col_x = geom.xshift + j * geom.col_w                       # (W,)
    e1 = lambda v: v[:, None]          # noqa: E731  (B,) -> (B, 1)
    e2 = lambda v: v[:, None, None]    # noqa: E731  (B,) -> (B, 1, 1)
    jm = j[None, :] < e1(ops.w)                                # (B, W)
    im = i[None, :] < e1(ops.n_la)                             # (B, NLA)

    p_sw, p_comp = geom.pitch_of("RBLSW"), geom.pitch_of("COMP")
    p_sar, p_dff = geom.pitch_of("SARLOGIC"), geom.pitch_of("DFF")

    la_of_row = row[None, :] // e1(ops.l)                      # (B, H)
    k_of_row = row[None, :] % e1(ops.l)
    sram = _stack_xywh(
        col_x[None, :, None],
        (la_of_row * e1(ops.la_h) + k_of_row * geom.s_h)[:, None, :],
        geom.s_w, geom.s_h)
    cap = _stack_xywh(
        col_x[None, :, None] + geom.s_w,
        i[None, None, :] * e2(ops.la_h) + e2(ops.cap_y), geom.c_w, geom.c_h)
    sw = _stack_xywh(
        col_x[None, :, None],
        e2(ops.array_h + ops.y_sw) + g[None, None, :] * p_sw, geom.col_w, p_sw)
    comp = _stack_xywh(col_x[None, :], e1(ops.array_h + ops.y_comp),
                       geom.col_w, p_comp)
    sar = _stack_xywh(col_x[None, :], e1(ops.array_h + ops.y_sar),
                      geom.col_w, p_sar)
    dff = _stack_xywh(
        col_x[None, :, None],
        e2(ops.array_h + ops.y_dff) + b[None, None, :] * p_dff,
        geom.col_w, p_dff)
    rd = _stack_xywh(torch.zeros_like(r)[None, :], r[None, :] * e1(ops.drv_pitch),
                     geom.drv_w, geom.drv_h)

    return {
        "sram": (sram, jm[:, :, None] & (row[None, :] < e1(ops.h))[:, None, :]),
        "cap": (cap, jm[:, :, None] & im[:, None, :]),
        "sw": (sw, jm[:, :, None] & (g[None, :] < e1(ops.n_sw))[:, None, :]),
        "comp": (comp, jm),
        "sar": (sar, jm),
        "dff": (dff, jm[:, :, None] & (b[None, :] < e1(ops.b_adc))[:, None, :]),
        "rd": (rd, r[None, :] < e1(ops.n_rd)),
    }


def category_names(cat: str, dims: BatchDims, spec: MacroSpec):
    """Instance names of a category tensor at the spec's exact extents,
    flattened in index order."""
    if cat == "sram":
        return [f"c{j}_la{r // spec.l}_s{r % spec.l}" for j in range(dims.w)
                for r in range(dims.h)]
    if cat == "cap":
        return [f"c{j}_la{i}_cap" for j in range(dims.w)
                for i in range(dims.n_la)]
    if cat == "sw":
        return [f"c{j}_sw{g}" for j in range(dims.w)
                for g in range(dims.n_sw)]
    if cat == "comp":
        return [f"c{j}_comp" for j in range(dims.w)]
    if cat == "sar":
        return [f"c{j}_sar" for j in range(dims.w)]
    if cat == "dff":
        return [f"c{j}_dff{b}" for j in range(dims.w)
                for b in range(dims.b)]
    if cat == "rd":
        return [f"rd{r}" for r in range(dims.rd)]
    raise KeyError(cat)


def dims_for_spec(spec: MacroSpec) -> BatchDims:
    return BatchDims.for_specs([spec])


def place(spec: MacroSpec) -> Placement:
    """Single-spec placement with named instances (the batched expansion
    at the spec's exact extents, names attached on the host)."""
    geom = geometry()
    ops = LayoutOperands(*(torch.tensor([v], dtype=I32)
                           for v in layout_operands(spec, geom)))
    dims = dims_for_spec(spec)
    tensors = rect_tensors(ops, dims, geom)
    rects: list[Placed] = []
    for cat in CATEGORIES:
        vals = tensors[cat][0][0].reshape(-1, 4).tolist()
        cell = CATEGORY_CELL[cat]
        rects.extend(Placed(name, cell, *xywh) for name, xywh
                     in zip(category_names(cat, dims, spec), vals))
    return Placement(spec, rects, int(ops.width[0]), int(ops.height[0]))
