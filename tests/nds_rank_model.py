"""A numpy model of the standalone `nds_rank` kernel's algorithm for P <=
512 (`nds_rank_reg_kernel` in `csrc/pareto_dom.cu`), shared by the CPU
tests (imports neither JAX nor the port).

One thread a point: thread j packs P / 32 words, bit t of word w "point
32 w + t dominates j" (all objectives <=, one <); the fronts then peel,
each reading the alive words of its parity (at front 0 every point) and
writing the other parity's, one warp's ballot of its still-unranked
points a word.  A point none of whose alive dominators is left joins the
front.  With P = 32 the warp's own vote is the alive word.
"""
import numpy as np


def dominator_words(f: np.ndarray) -> np.ndarray:
    """(P, P / 32) uint32: row j's word w, bit t = point 32 w + t
    dominates point j.  f (P, M) float32."""
    p = f.shape[0]
    a, b = f[:, None, :], f[None, :, :]
    dom = (a <= b).all(-1) & (a < b).any(-1)       # dom[i, j]: i dominates j
    bits = dom.T.reshape(p, p // 32, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def nds_rank_model(f) -> tuple[np.ndarray, np.ndarray]:
    """f (C, P, M) float32, P % 32 == 0.  Returns (ranks (C, P) int32,
    fronts (C,): the fronts each cell peeled)."""
    f = np.asarray(f, np.float32)
    c_n, p, _ = f.shape
    assert p % 32 == 0
    w_n = p // 32
    ranks = np.full((c_n, p), -1, np.int32)
    fronts = np.zeros(c_n, np.int64)
    for c in range(c_n):
        dom = dominator_words(f[c])
        alive = [np.full(w_n, 0xffffffff, np.uint32), np.zeros(w_n, np.uint32)]
        rank = ranks[c]
        front = 0
        while True:
            cur, nxt = alive[front & 1], alive[(front + 1) & 1]
            live = rank < 0
            hit = (dom & cur[None, :]).any(1)
            rank[live & ~hit] = front
            still = (rank < 0).reshape(w_n, 32).astype(np.uint64)
            nxt[:] = (still << np.arange(32, dtype=np.uint64)).sum(1)
            front += 1
            if not (rank < 0).any():
                break
        fronts[c] = front
    return ranks, fronts
