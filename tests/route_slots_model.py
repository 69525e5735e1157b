"""A numpy model of the `route_slots` kernel's algorithm, and the random
layout buckets the route tests feed it (shared by
`test_torch_route_slots.py` and the `cuda` tests; imports neither JAX
nor the port).

The model does what `csrc/maze_route.cu` does, one grid at a time: the
occupancy as counts offset by `lo = capacity - K` (K = A + 1, A the most
masked targets of real slots a grid has), 16 bits wide while they stay
below 2^16 (2 A + 1 <= 65535) and 32 bits beyond, as the kernel picks,
per slot a level-synchronous BFS from the hub that stops at the first
level at which every masked target is resolved (a target when it is
reached, a blocked one also when a neighbour is) or when the frontier
empties, distances kept only where visited, then the walk of each
target back to the hub (first NEIGHBORS cell at d - 1; a blocked
target entered from its first neighbour at d0 - 1) and the commit.
It counts the BFS levels each grid runs through.  The plain version
computes full fields instead; equality of the two holds the early stop
on the CPU.
"""
import numpy as np

INF = 2 ** 29
NEIGHBORS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _dilate(front: np.ndarray) -> np.ndarray:
    out = np.zeros_like(front)
    out[1:] |= front[:-1]
    out[:-1] |= front[1:]
    out[:, 1:] |= front[:, :-1]
    out[:, :-1] |= front[:, 1:]
    return out


def _resolved(front, free, y, x) -> bool:
    if front[y, x]:
        return True
    if free[y, x]:
        return False
    gh, gw = front.shape
    return any(0 <= y + dy < gh and 0 <= x + dx < gw and front[y + dy, x + dx]
               for dy, dx in NEIGHBORS)


def count_dtype(visits: int):
    """The kernel's count width for A = `visits` masked targets per grid:
    counts reach at most 2 A + 1."""
    return np.uint16 if 2 * visits + 1 <= 2 ** 16 - 1 else np.uint32


def route_slots_model(occ0, hubs, tgts, tmask, nmask, grids, capacity):
    """Returns (occ, routed, failed, wirelen, levels), all int32 numpy."""
    occ0 = np.asarray(occ0, np.int64)
    hubs, tgts = np.asarray(hubs), np.asarray(tgts)
    tmask, nmask = np.asarray(tmask, bool), np.asarray(nmask, bool)
    bsz, h, w = occ0.shape
    s_n, t_n = tgts.shape[1], tgts.shape[2]
    k_cap = int((tmask & nmask[..., None]).sum((1, 2)).max()) + 1
    lo = capacity - k_cap
    occ = occ0.copy()
    routed, failed, wirelen, levels = (np.zeros(bsz, np.int64)
                                       for _ in range(4))
    for b in range(bsz):
        gh, gw = min(int(grids[b][0]), h), min(int(grids[b][1]), w)
        u0 = np.clip(occ0[b, :gh, :gw] - lo, 0, k_cap)
        cnt = u0.astype(count_dtype(k_cap - 1))
        dist = np.zeros((gh, gw), np.uint16)      # valid where visited
        for s in range(s_n):
            if not nmask[b, s]:
                continue
            free = cnt < k_cap
            hy, hx = hubs[b, s]
            vis = np.zeros((gh, gw), bool)
            vis[hy, hx] = True
            dist[hy, hx] = 0
            front = vis.copy()
            act = [t for t in range(t_n) if tmask[b, s, t]]
            unres = [t for t in act
                     if not _resolved(front, free, *tgts[b, s, t])]
            level = 0
            while unres:
                level += 1
                new = _dilate(front) & free & ~vis
                if not new.any():
                    break
                vis |= new
                dist[new] = level
                front = new
                unres = [t for t in unres
                         if not _resolved(front, free, *tgts[b, s, t])]
            levels[b] += level

            def at(y, x):
                ok = 0 <= y < gh and 0 <= x < gw and vis[y, x]
                return int(dist[y, x]) if ok else INF

            walks, wl, ok = [], 0, True
            for t in act:
                ty, tx = (int(v) for v in tgts[b, s, t])
                dv = at(ty, tx)
                nd = [at(ty + dy, tx + dx) for dy, dx in NEIGHBORS]
                d0 = dv if dv < INF else min(INF, min(nd) + 1)
                ok &= d0 < INF
                wl += d0 + 1
                walks.append((ty, tx, dv, nd, d0))
            if not ok:
                failed[b] += 1
                continue
            routed[b] += 1
            wirelen[b] += wl
            for y, x, dv, nd, d0 in walks:
                path, d = [(y, x)], d0
                if dv >= INF:
                    k = next(k for k in range(4) if nd[k] == d0 - 1)
                    y, x = y + NEIGHBORS[k][0], x + NEIGHBORS[k][1]
                    path.append((y, x))
                    d = d0 - 1
                while d > 0:
                    y, x = next((y + dy, x + dx) for dy, dx in NEIGHBORS
                                if at(y + dy, x + dx) == d - 1)
                    path.append((y, x))
                    d -= 1
                for y, x in path:
                    cnt[y, x] += 1
        assert int(cnt.max(initial=0)) <= 2 * k_cap - 1
        occ[b, :gh, :gw] = occ0[b, :gh, :gw] + cnt.astype(np.int64) - u0
    i32 = lambda a: a.astype(np.int32)  # noqa: E731
    return (i32(occ), i32(routed), i32(failed), i32(wirelen), i32(levels))


def random_bucket(seed: int, grids, slots: int, capacity: int,
                  targets: int = 2, p_full: float = 0.2):
    """A seeded layout bucket: grids of mixed sizes padded into one plane
    (the pad at `capacity`, as the batched router leaves it), counts in
    [0, capacity] with a share `p_full` full, hubs (some on full cells,
    one also its own target), star targets (some on full cells), a
    walled-in target that no route reaches, and padded slots (nmask
    False) among the real ones.  Returns numpy (occ0, hubs, tgts, tmask,
    nmask, grids)."""
    rng = np.random.default_rng(seed)
    grids = np.asarray(grids, np.int32)
    bsz = len(grids)
    h, w = (int(v) for v in grids.max(0))
    occ0 = np.full((bsz, h, w), capacity, np.int32)
    hubs = np.zeros((bsz, slots, 2), np.int32)
    tgts = np.zeros((bsz, slots, targets, 2), np.int32)
    for b, (gh, gw) in enumerate(grids):
        cnt = rng.integers(0, capacity, (gh, gw))
        cnt[rng.random((gh, gw)) < p_full] = capacity
        occ0[b, :gh, :gw] = cnt
        hubs[b, :, 0] = rng.integers(0, gh, slots)
        hubs[b, :, 1] = rng.integers(0, gw, slots)
        tgts[b, ..., 0] = rng.integers(0, gh, (slots, targets))
        tgts[b, ..., 1] = rng.integers(0, gw, (slots, targets))
        full = np.argwhere(cnt >= capacity)
        if len(full):
            hubs[b, 0] = full[rng.integers(len(full))]       # occupied hub
            tgts[b, 1, 0] = full[rng.integers(len(full))]    # blocked target
        tgts[b, 2, -1] = hubs[b, 2]                          # target at hub
        if gh >= 5 and gw >= 5:                              # walled in
            y, x = int(rng.integers(1, gh - 1)), int(rng.integers(1, gw - 1))
            for dy, dx in NEIGHBORS:
                occ0[b, y + dy, x + dx] = capacity
            tgts[b, 3, 0] = (y, x)
            if tuple(hubs[b, 3]) == (y, x):
                hubs[b, 3] = (0, 0) if (y, x) != (0, 0) else (gh - 1, gw - 1)
    tmask = rng.random((bsz, slots, targets)) < 0.7
    tmask[..., 0] = True
    nmask = rng.random((bsz, slots)) < 0.85
    nmask[:, :4] = True
    nmask[-1, -1] = False
    return occ0, hubs, tgts, tmask, nmask, grids


def hub_heavy_bucket(seed: int = 7, slots: int = 1_700, targets: int = 30,
                     capacity: int = 4):
    """A bucket past 32,767 masked targets per grid whose counts pass 2^16:
    `random_bucket` on a 40 x 60 and a 12 x 20 grid with every target and
    slot masked in (A = slots x targets = 51,000), every slot's hub on one
    full cell of its grid, and every other slot's targets all on that hub.
    Those slots route at level 0 and commit the hub once per target, so
    its count (offset K = A + 1) passes 65,535; the others route while the
    hub's neighbours have room, then fail."""
    occ0, hubs, tgts, tmask, nmask, grids = random_bucket(
        seed, [(40, 60), (12, 20)], slots, capacity, targets, p_full=0.1)
    tmask[:] = True
    nmask[:] = True
    for b, (gh, gw) in enumerate(grids):
        hub = (gh // 2, gw // 3)
        occ0[b, hub[0], hub[1]] = capacity
        hubs[b] = hub
        tgts[b, ::2] = hub
    return occ0, hubs, tgts, tmask, nmask, grids
