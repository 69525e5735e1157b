"""End-to-end layout flow of one spec (paper Fig. 4, right half):
netlist generation -> hierarchical template placement -> grid routing ->
DRC-lite -> metrics + GDS-like JSON export.

Counterpart of `repro.eda.flow`.  `generate_layout(spec)` is the
single-spec path with the full named-instance and wire geometry: the
placement is `placer.place` on the host, the routing `router.route`,
whose wavefronts run on `device`.  To lay out a whole distilled Pareto
set use `repro_torch.eda.batched_flow.generate_layouts`, whose per-spec
rows are identical.  `drc_lite` is the host sweep-line check that the
batched flow vectorizes as a pairwise-overlap count.
"""
from __future__ import annotations

import dataclasses
import json
import time

from repro_torch.core import estimator
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.eda import netlist as nl_mod
from repro_torch.eda.placer import Placement, place
from repro_torch.eda.router import RoutingResult, route


@dataclasses.dataclass
class DRCReport:
    overlaps: int
    out_of_bounds: int

    @property
    def clean(self) -> bool:
        return self.overlaps == 0 and self.out_of_bounds == 0


def drc_lite(p: Placement) -> DRCReport:
    """No-overlap + bounds checks on the placed rectangles (grid spacing is
    honoured by construction inside the templates).  Sweep-line over x."""
    rects = sorted(p.rects, key=lambda r: (r.x, r.y))
    overlaps = 0
    oob = 0
    active: list = []
    for r in rects:
        if r.y + r.h > p.height + 1 or r.x + r.w > p.width + 1:
            oob += 1
        active = [a for a in active if a.x + a.w > r.x]
        for a in active:
            if a.name.split("_")[0] != r.name.split("_")[0]:
                continue  # different columns can't overlap by construction
            if r.x < a.x + a.w and a.x < r.x + r.w and \
                    r.y < a.y + a.h and a.y < r.y + r.h:
                overlaps += 1
        active.append(r)
    return DRCReport(overlaps, oob)


@dataclasses.dataclass
class LayoutResult:
    spec: MacroSpec
    placement: Placement
    routing: RoutingResult
    drc: DRCReport
    netlist_stats: dict
    elapsed_s: float

    def metrics(self) -> dict:
        est_area = float(estimator.area_f2_per_bit(
            self.spec.h, self.spec.l, self.spec.b_adc))
        area = self.placement.area_f2_per_bit()
        return {
            "h": self.spec.h, "w": self.spec.w, "l": self.spec.l,
            "b_adc": self.spec.b_adc,
            "layout_area_f2_per_bit": area,
            "estimator_area_f2_per_bit": est_area,
            "area_model_error": area / est_area - 1.0,
            "routed_nets": len(self.routing.wires),
            "failed_nets": len(self.routing.failed),
            "route_success": self.routing.success_rate,
            "wirelength": self.routing.total_wirelength,
            "drc_clean": self.drc.clean,
            "elapsed_s": self.elapsed_s,
        }

    def to_json(self, path: str) -> None:
        doc = {
            "spec": self.spec.as_tuple(),
            "metrics": self.metrics(),
            "cells": [[r.name, r.cell, r.x, r.y, r.w, r.h]
                      for r in self.placement.rects[:20000]],
            "wires": [[w.net, list(map(list, w.points))]
                      for w in self.routing.wires[:5000]],
        }
        with open(path, "w") as f:
            json.dump(doc, f)


def _top_level_nets(spec: MacroSpec, p: Placement):
    """Inter-template nets for the maze router: per-column RBL trunk
    (array foot -> comparator) and the RWL trunks (driver -> row)."""
    by_name = {r.name: r for r in p.rects}
    nets = []
    for j in range(spec.w):
        comp = by_name[f"c{j}_comp"]
        cap0 = by_name[f"c{j}_la0_cap"]
        top = by_name[f"c{j}_la{spec.n_caps - 1}_cap"]
        nets.append((f"c{j}_rbl", [(int(comp.cx), int(comp.cy)),
                                   (int(cap0.cx), int(cap0.cy)),
                                   (int(top.cx), int(top.cy))]))
        sar = by_name[f"c{j}_sar"]
        nets.append((f"c{j}_cmp", [(int(comp.cx), int(comp.cy)),
                                   (int(sar.cx), int(sar.cy))]))
    for r in range(min(spec.h, nl_mod.MAX_ROW_DRIVERS)):
        drv = by_name.get(f"rd{r}")
        if drv is None:
            continue
        la, k = divmod(r, spec.l)
        far = by_name.get(f"c{spec.w - 1}_la{la}_s{k}")
        if far is not None:
            nets.append((f"rwl{r}", [(int(drv.cx), int(drv.cy)),
                                     (int(far.cx), int(far.cy))]))
    return nets


def generate_layout(spec: MacroSpec, *, device="cuda") -> LayoutResult:
    """Lay out one spec with its full wire geometry; the routing
    wavefronts run on `device` (`router.route`)."""
    t0 = time.time()
    nl = nl_mod.generate(spec)
    p = place(spec)
    nets = _top_level_nets(spec, p)
    r = route(p, nets, device=device)
    d = drc_lite(p)
    return LayoutResult(spec, p, r, d, nl.stats(), time.time() - t0)
