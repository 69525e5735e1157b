"""Grid router (paper Sec. 2.3 / 3.3): Lee-style wavefront on a coarse
routing grid, hierarchical per the paper: template internals use
predefined tracks, only inter-template nets are maze-routed.

Counterpart of `repro.eda.router`.  Nets are routed one at a time,
longest first, on an occupancy grid with a per-track capacity.  Each
net's distance field is one `kernels.maze_route.wavefront_distance`
call from the net's hub on the router's device (one `wavefront` launch
on CUDA, the host frontier engine on the CPU); the host backtraces the
paths.  The backtrace is deterministic: at distance d it steps to the
first neighbour at d-1 in `NEIGHBORS` order.  The batched router
(`repro_torch.eda.batched_flow`) uses the same tie-break, which makes
its per-spec results identical to this sequential one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.eda.placer import Placement
from repro_torch.kernels.maze_route.ops import (HOST_IMPLS, INF,
                                                wavefront_distance)

# Backtrace preference order (down, up, right, left).
NEIGHBORS = ((1, 0), (-1, 0), (0, 1), (0, -1))


@dataclasses.dataclass(frozen=True)
class Wire:
    net: str
    points: tuple[tuple[int, int], ...]     # grid path (coarse units)
    layer_pattern: str = "HV"


@dataclasses.dataclass
class RoutingResult:
    wires: list[Wire]
    grid_shape: tuple[int, int]
    coarse: int
    failed: list[str]
    total_wirelength: int

    @property
    def success_rate(self) -> float:
        n = len(self.wires) + len(self.failed)
        return len(self.wires) / n if n else 1.0


def grid_shape(width: int, height: int, coarse: int) -> tuple[int, int]:
    """Coarse routing-grid extent (rows, columns) for a macro bounding box."""
    return (max(2, height // coarse + 3), max(2, width // coarse + 2))


def target_distance(dist: np.ndarray, dst: tuple[int, int]) -> int:
    """Path length (in steps) from the wavefront source to `dst`.

    A destination pin is always enterable even when its cell is at track
    capacity (the Lee-router exception), so a blocked dst costs one step
    more than its best free neighbour.  Returns `INF` when unreachable.
    """
    d = int(dist[dst])
    if d < INF:
        return d
    h, w = dist.shape
    best = INF
    for dy, dx in NEIGHBORS:
        ny, nx = dst[0] + dy, dst[1] + dx
        if 0 <= ny < h and 0 <= nx < w:
            best = min(best, int(dist[ny, nx]))
    return min(INF, best + 1) if best < INF else INF


def backtrace(dist: np.ndarray, dst: tuple[int, int]):
    """Walk the distance field from `dst` down to the source.

    Returns the path src -> dst (inclusive), or None when unreachable.
    Tie-break: first neighbour in `NEIGHBORS` order at distance d-1.
    """
    d = target_distance(dist, dst)
    if d >= INF:
        return None
    h, w = dist.shape
    path = [dst]
    cur = dst
    while d > 0:
        for dy, dx in NEIGHBORS:
            ny, nx = cur[0] + dy, cur[1] + dx
            if 0 <= ny < h and 0 <= nx < w and int(dist[ny, nx]) == d - 1:
                cur = (ny, nx)
                break
        else:  # pragma: no cover - the field always contains the chain
            return None
        path.append(cur)
        d -= 1
    return path[::-1]


def route(placement: Placement, nets: list[tuple[str, list[tuple[int, int]]]],
          *, coarse: int = 64, capacity: int = 4, impl: str | None = None,
          device="cuda") -> RoutingResult:
    """Route multi-pin nets (star topology around the first pin) on a
    coarse grid.  nets: (name, [(x, y) pin coords in F units]).

    Each net of two or more pins takes one `wavefront_distance` call on
    `device`; `impl=None` is the `wavefront` kernel on CUDA and the host
    frontier engine on the CPU (every impl gives the identical field).
    A host impl runs on the host whatever `device` says."""
    dev = torch.device(device)
    if impl is None:
        impl = "kernel" if dev.type == "cuda" else "frontier"
    gh, gw = grid_shape(placement.width, placement.height, coarse)
    occ_count = np.zeros((gh, gw), np.int16)
    wires: list[Wire] = []
    failed: list[str] = []
    total = 0

    def cell(p):
        x, y = p
        return (min(gh - 1, max(0, int(y) // coarse)),
                min(gw - 1, max(0, int(x) // coarse)))

    # longest (bounding box) first, stable
    def span(pins):
        xs = [p[0] for p in pins]
        ys = [p[1] for p in pins]
        return (max(xs) - min(xs)) + (max(ys) - min(ys))

    seed = np.zeros((gh, gw), bool)
    for name, pins in sorted(nets, key=lambda n: -span(n[1])):
        if len(pins) < 2:
            continue
        hub = cell(pins[0])
        occ = occ_count >= capacity
        seed[:] = False
        seed[hub] = True
        if impl in HOST_IMPLS:
            dist = wavefront_distance(occ, seed, impl=impl)
        else:
            dist = wavefront_distance(
                torch.from_numpy(occ).to(dev), torch.from_numpy(seed).to(dev),
                impl=impl).cpu().numpy()
        pts: list[tuple[int, int]] = []
        ok = True
        for p in pins[1:]:
            path = backtrace(dist, cell(p))
            if path is None:
                ok = False
                break
            pts.extend(path)
        if ok:
            for y, x in pts:
                occ_count[y, x] += 1
            total += len(pts)
            wires.append(Wire(name, tuple(pts)))
        else:
            failed.append(name)
    return RoutingResult(wires, (gh, gw), coarse, failed, total)
