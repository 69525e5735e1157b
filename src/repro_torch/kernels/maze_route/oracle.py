"""Pure-Python BFS oracle for the maze_route family.

A copy of `repro.kernels.maze_route.oracle`: a textbook
`collections.deque` breadth-first search, one cell at a time, kept so
the tests can pin the plain sweeping version and the CUDA kernel to
something a reader can verify by reading thirty lines.

  * seeds are distance 0, even when they sit on an occupied cell;
  * occupied cells are never entered (distance stays `INF`).
"""
from __future__ import annotations

import collections

import numpy as np

from repro_torch.kernels.maze_route.ref import INF


def wavefront_distance_bfs(occ, seed) -> np.ndarray:
    """BFS distance field(s), host Python.  occ/seed: (H, W) or (B, H, W)
    array-likes of bool.  Returns int32 distances of the same shape."""
    occ = np.asarray(occ, bool)
    seed = np.asarray(seed, bool)
    if occ.ndim == 3:
        return np.stack([wavefront_distance_bfs(o, s)
                         for o, s in zip(occ, seed)])
    h, w = occ.shape
    dist = np.full((h, w), INF, np.int32)
    queue: collections.deque = collections.deque()
    for y, x in zip(*np.nonzero(seed)):
        dist[y, x] = 0
        queue.append((int(y), int(x)))
    while queue:
        y, x = queue.popleft()
        d = dist[y, x] + 1
        for ny, nx in ((y + 1, x), (y - 1, x), (y, x + 1), (y, x - 1)):
            if 0 <= ny < h and 0 <= nx < w and not occ[ny, nx] \
                    and dist[ny, nx] == INF:
                dist[ny, nx] = d
                queue.append((ny, nx))
    return dist
