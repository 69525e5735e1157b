"""Frontier-bucketed (Dial-style) wavefront engine for the maze router,
on the host in numpy.

A copy of `repro.kernels.maze_route.frontier`.  The plain sweep and the
`wavefront` kernel compute the full field of a grid; this engine keeps
the active frontier as an explicit bucket of cell indices and expands
exactly those cells, so each BFS level costs O(|frontier|) and a lane
can stop at the level that resolves its targets.  With unit edge
weights Dial's bucket queue is one bucket per BFS level: `level` below
is the bucket index, and the per-level `np.unique` is the bucket dedupe.
The concurrent routing engine (`repro_torch.eda.batched_flow`) runs it
for CPU tensors; the sequential router takes it as its host engine.

Layout of the working arrays (the "frontier-bucket contract"):

  * every lane (= one routing grid) lives on a bordered canvas of
    (H+2)x(W+2) cells flattened to one axis; the 1-cell border is
    permanently blocked, so the four neighbour offsets are the plain
    strides ``(+S, -S, +1, -1)`` with ``S = W + 2`` (`NEIGHBORS` order:
    down, up, right, left) and never need a bounds check;
  * `dist` is int32, `INF` marks unassigned/unreachable; seeds are
    written 0 and form bucket 0 even when their cell is occupied;
  * bucket k+1 = unique free, still-`INF` neighbours of bucket k;
    termination: the next bucket is empty (field exhausted) or, when an
    early-exit predicate is given, every lane reports resolved; levels
    complete atomically, so every assigned distance is final the moment
    it is written.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.maze_route.ref import INF


def strides(stride: int) -> np.ndarray:
    """Canvas index offsets of the four neighbours in `NEIGHBORS` order;
    `stride` is the canvas row stride W + 2."""
    return np.array([stride, -stride, 1, -1], np.int64)


def expand_buckets(free, dist, lane0, idx0, stride, resolved=None) -> int:
    """Run the bucketed wavefront to termination, in place.

    free:  (L, C) bool  — traversable canvas cells (border rows False).
    dist:  (L, C) int32 — `INF`-filled; seeds already written 0.
    lane0, idx0: int64 arrays — bucket 0 (the seeds), as (lane, flat
        canvas index) pairs.
    stride: canvas row stride (W + 2).
    resolved: optional () -> (L,) bool callback, checked after each
        bucket commits; lanes reporting True stop expanding (their
        remaining `INF` cells stay `INF` — callers only rely on
        distances at or below the resolution level, which are final).

    Returns the number of levels (buckets) expanded.
    """
    ncells = free.shape[1]
    offs = strides(stride)
    f_lane, f_idx = lane0, idx0
    level = 0
    while f_idx.size:
        level += 1
        n_lane = np.repeat(f_lane, 4)
        n_idx = (f_idx[:, None] + offs[None, :]).ravel()
        keep = free[n_lane, n_idx] & (dist[n_lane, n_idx] == INF)
        n_lane, n_idx = n_lane[keep], n_idx[keep]
        if not n_idx.size:
            break
        # Dedupe within the bucket (two frontier cells proposing the same
        # neighbour) with one fused key, so np.unique runs once.
        key = np.unique(n_lane * ncells + n_idx)
        n_lane, n_idx = key // ncells, key % ncells
        dist[n_lane, n_idx] = level
        if resolved is not None:
            done = resolved()
            if done.any():
                alive = ~done[n_lane]
                n_lane, n_idx = n_lane[alive], n_idx[alive]
        f_lane, f_idx = n_lane, n_idx
    return level


def canvas_free(occ: np.ndarray) -> np.ndarray:
    """(L, H, W) blocked mask -> (L, (H+2)*(W+2)) flat traversable mask
    with the 1-cell blocked border of the frontier-bucket contract."""
    l, h, w = occ.shape
    free = np.zeros((l, h + 2, w + 2), bool)
    free[:, 1:-1, 1:-1] = ~occ
    return free.reshape(l, (h + 2) * (w + 2))


def canvas_index(y, x, stride: int):
    """Grid (y, x) -> flat bordered-canvas index."""
    return (np.asarray(y, np.int64) + 1) * stride + np.asarray(x) + 1


def wavefront_distance_frontier(occ, seed) -> np.ndarray:
    """Full BFS distance field(s) by the bucketed frontier engine.

    occ, seed: (H, W) or (B, H, W) bool array-likes.  Returns int32
    distances of the same shape, equal to the plain sweep's, the
    `wavefront` kernel's and the BFS oracle's.
    """
    occ = np.asarray(occ, bool)
    seed = np.asarray(seed, bool)
    squeeze = occ.ndim == 2
    if squeeze:
        occ, seed = occ[None], seed[None]
    b, h, w = occ.shape
    stride = w + 2
    free = canvas_free(occ)
    dist = np.full((b, (h + 2) * stride), INF, np.int32)
    sl, sy, sx = np.nonzero(seed)
    sidx = canvas_index(sy, sx, stride)
    sl = sl.astype(np.int64)
    dist[sl, sidx] = 0
    expand_buckets(free, dist, sl, sidx, stride)
    out = dist.reshape(b, h + 2, stride)[:, 1:-1, 1:-1]
    return out[0] if squeeze else out
