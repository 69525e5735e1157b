"""Plain PyTorch versions of the maze_route kernels.

`wavefront_distance_ref` is the plain version of the `wavefront`
kernel: the BFS distance field of the Lee maze router by fast sweeping,
as `repro.kernels.maze_route.ref.wavefront_distance_ref` computes it.
A round runs four directional min-plus propagations (+x, -x, +y, -y),
each a segmented running minimum along free runs of a row or column
that blocked cells cut; rounds repeat until the field stops changing.

  * seeds have distance 0, even on an occupied cell (a hub is always
    enterable);
  * occupied cells are never entered (distance stays `INF`).

`dir_field`, `trace_targets` and `trace_paths_ref` are the plain
version of the `trace_paths` kernel: the reference's `_dir_field` and
`_trace_one` of `repro.eda.batched_flow` (one backtrace per star
target, `NEIGHBORS` first-match tie-break) and the occupancy commit of
its `_route_step`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# Unreachable marker, as in the reference.
INF = 2 ** 29
# Backtrace preference order (down, up, right, left), as in
# `repro_torch.eda.router.NEIGHBORS`.
NEIGHBORS = ((1, 0), (-1, 0), (0, 1), (0, -1))
# Larger than any distance plus any run length: separates sweep segments.
_SEG = 2 ** 32


def outside_grids(shape, grids: torch.Tensor | None,
                  device) -> torch.Tensor | None:
    """(B, H, W) True beyond each grid's own (gh, gw) extent."""
    if grids is None:
        return None
    _, h, w = shape
    iy = torch.arange(h, device=device)[None, :, None]
    ix = torch.arange(w, device=device)[None, None, :]
    g = grids.to(device=device, dtype=torch.int64)
    return (iy >= g[:, 0, None, None]) | (ix >= g[:, 1, None, None])


def _sweep(dist: torch.Tensor, transit: torch.Tensor, dim: int,
           reverse: bool) -> torch.Tensor:
    """Directional propagation along `dim`: for a transit cell x,
    min(dist[x], min over earlier x' of its free run of dist[x'] + x - x')."""
    if reverse:
        dist, transit = dist.flip(dim), transit.flip(dim)
    n = dist.shape[dim]
    shape = [1] * dist.dim()
    shape[dim] = n
    x = torch.arange(n, device=dist.device, dtype=torch.int64).reshape(shape)
    seg = torch.cumsum((~transit).to(torch.int64), dim)
    u = torch.where(transit, dist.to(torch.int64), INF)
    run = torch.cummin(u - x - seg * _SEG, dim).values + seg * _SEG + x
    out = torch.where(transit, torch.minimum(dist.to(torch.int64),
                                             torch.clamp_max(run, INF)),
                      dist.to(torch.int64)).to(torch.int32)
    return out.flip(dim) if reverse else out


def wavefront_distance_ref(occ: torch.Tensor, seed: torch.Tensor,
                           grids: torch.Tensor | None = None) -> torch.Tensor:
    """BFS distance field(s): occ, seed (B, H, W) bool; returns int32.

    With `grids` (B, 2) each grid's cells beyond its own (gh, gw) count
    as blocked and hold no seed, as the kernel treats them."""
    occ = occ.to(torch.bool)
    seed = seed.to(torch.bool)
    out = outside_grids(occ.shape, grids, occ.device)
    if out is not None:
        occ, seed = occ | out, seed & ~out
    transit = ~occ | seed
    dist = torch.where(seed, 0, INF).to(torch.int32)
    nd = dist.dim()
    while True:
        nxt = dist
        for dim, reverse in ((nd - 1, False), (nd - 1, True),
                             (nd - 2, False), (nd - 2, True)):
            nxt = _sweep(nxt, transit, dim, reverse)
        if not bool((nxt < dist).any()):
            return nxt
        dist = nxt


def _neighbour_planes(dist: torch.Tensor):
    """dist[y+dy, x+dx] for each of `NEIGHBORS`, INF beyond the plane."""
    h, w = dist.shape[-2:]
    pad = F.pad(dist, (1, 1, 1, 1), value=INF)
    return [pad[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            for dy, dx in NEIGHBORS]


def dir_field(dist: torch.Tensor) -> torch.Tensor:
    """Backtrace direction of every cell, uint8 in {0..3}: the first
    `NEIGHBORS` entry at distance d-1.  Cells with d == 0 or INF hold an
    arbitrary direction the walk never reads."""
    target = dist - 1
    dirf = torch.zeros(dist.shape, dtype=torch.uint8, device=dist.device)
    for k, nb in reversed(list(enumerate(_neighbour_planes(dist)))):
        dirf = torch.where(nb == target, k, dirf)
    return dirf


def trace_targets(dist: torch.Tensor, tgts: torch.Tensor,
                  active: torch.Tensor):
    """Backtrace every active star target; the reference's `_trace_one`
    over a (B, T) lane batch.

    dist (B, H, W) int32; tgts (B, T, 2) (gy, gx); active (B, T) bool.
    Returns (inc (B, H, W) int32 visit counts summed over targets,
    wl (B, T) int32 path points per target, reach (B, T) bool).  A
    blocked target is entered at +1 from its first `NEIGHBORS`
    neighbour at d-1, then the walk follows `dir_field`."""
    bsz, h, w = dist.shape
    dev = dist.device
    t = tgts.to(torch.int64)
    ty, tx = t[..., 0], t[..., 1]
    bi = torch.arange(bsz, device=dev)[:, None].expand_as(ty)
    pad = F.pad(dist, (1, 1, 1, 1), value=INF)
    dv = dist[bi, ty, tx].to(torch.int64)
    nd0 = torch.stack([pad[bi, ty + 1 + dy, tx + 1 + dx]
                       for dy, dx in NEIGHBORS], -1).to(torch.int64)
    d0 = torch.where(dv < INF, dv, torch.clamp_max(nd0.min(-1).values + 1, INF))
    reach = d0 < INF
    run = active & reach
    blocked = run & (dv >= INF)
    esel = (nd0 == (d0 - 1)[..., None]).to(torch.uint8).argmax(-1)
    dy_tab = torch.tensor([n[0] for n in NEIGHBORS], device=dev)
    dx_tab = torch.tensor([n[1] for n in NEIGHBORS], device=dev)

    vb, vy, vx = [bi[run]], [ty[run]], [tx[run]]
    ey, ex = ty + dy_tab[esel], tx + dx_tab[esel]
    vb.append(bi[blocked])
    vy.append(ey[blocked])
    vx.append(ex[blocked])
    # walkers: start at the target (or its entry cell) with d steps left
    y = torch.where(blocked, ey, ty)[run]
    x = torch.where(blocked, ex, tx)[run]
    d = torch.where(blocked, d0 - 1, d0)[run]
    b = bi[run]
    dirf = dir_field(dist).to(torch.int64)
    while True:
        live = d > 0
        b, y, x, d = b[live], y[live], x[live], d[live]
        if not d.numel():
            break
        sel = dirf[b, y, x]
        y, x, d = y + dy_tab[sel], x + dx_tab[sel], d - 1
        vb.append(b)
        vy.append(y)
        vx.append(x)
    inc = torch.zeros((bsz, h, w), dtype=torch.int32, device=dev)
    inc.index_put_((torch.cat(vb), torch.cat(vy), torch.cat(vx)),
                   torch.ones(sum(v.numel() for v in vb), dtype=torch.int32,
                              device=dev), accumulate=True)
    wl = torch.where(run, d0 + 1, 0).to(torch.int32)
    return inc, wl, reach


def trace_paths_ref(dist, tgts, tmask, nmask, occ, routed, failed, wirelen):
    """Plain version of the `trace_paths` kernel: trace one net slot on
    every grid and commit it, in place.

    dist (B, H, W) int32; tgts (B, T, 2) int32; tmask (B, T) bool;
    nmask (B,) bool.  A spec's route commits only when every masked
    target is reachable (`ok`): its visits are added to `occ`
    (B, H, W) int32, `routed`/`wirelen` grow, else `failed` grows for a
    real net.  Returns `ok`."""
    inc, wl, reach = trace_targets(dist, tgts, tmask & nmask[:, None])
    ok = nmask & (reach | ~tmask).all(1)
    occ += inc * ok[:, None, None].to(torch.int32)
    routed += ok.to(torch.int32)
    failed += (nmask & ~ok).to(torch.int32)
    wirelen += wl.sum(1, dtype=torch.int32) * ok.to(torch.int32)
    return ok
