"""A numpy model of the sort keys of the `nsga2_evolve` kernel
(`csrc/pareto_dom.cu`), shared by `test_torch_nsga2_evolve.py`; imports
neither JAX nor the port.

The kernel sorts unique 64-bit keys (rank << 48 | ord(value) << 16 |
index) where the composite takes `pareto.lexsort2`'s two stable sorts:
ord maps a float32 to a uint32 of the same order, -0.0 first turned into
+0.0 (torch's sorts compare the two equal).  Crowding sorts each
objective's values so, and reads a front's fmin and fmax at its first
and last sorted entry; selection sorts -crowding so.
"""
import numpy as np

PAD_KEY = np.uint64(2 ** 64 - 1)


def ord_key(x) -> np.ndarray:
    """float32 -> uint32 whose unsigned order is the floats' order."""
    b = np.asarray(x, np.float32).view(np.uint32).copy()
    b[(b << np.uint32(1)) == 0] = 0                    # -0.0 -> +0.0
    neg = (b & np.uint32(0x80000000)) != 0
    return np.where(neg, ~b, b | np.uint32(0x80000000)).astype(np.uint32)


def sort_keys(ranks, values) -> np.ndarray:
    """(rank, ord(value), index) keys of a point set, uint64."""
    ranks = np.asarray(ranks, np.int64)
    idx = np.arange(len(ranks), dtype=np.uint64)
    return ((ranks.astype(np.uint64) << np.uint64(48))
            | (ord_key(values).astype(np.uint64) << np.uint64(16)) | idx)


def key_order(ranks, values) -> np.ndarray:
    """The kernel's order: indices by ascending key (a bitonic sort of
    unique keys, padded to a power of two with PAD_KEY, sorts them so)."""
    keys = sort_keys(ranks, values)
    n2 = 1 << max(0, int(len(keys) - 1).bit_length())
    padded = np.concatenate([keys, np.full(n2 - len(keys), PAD_KEY)])
    return (np.sort(padded)[:len(keys)] & np.uint64(0xffff)).astype(np.int64)


def crowding(f, ranks) -> np.ndarray:
    """The kernel's crowding distance of (n, M) float32 objectives f."""
    f = np.asarray(f, np.float32)
    ranks = np.asarray(ranks, np.int64)
    n, m = f.shape
    total = np.zeros(n, np.float32)
    for k in range(m):
        order = key_order(ranks, f[:, k])
        rs, vs = ranks[order], f[order, k]
        start = {}
        end = {}
        for s in range(n):
            start.setdefault(rs[s], s)
            end[rs[s]] = s
        d = np.empty(n, np.float32)
        for s in range(n):
            lo, hi = start[rs[s]], end[rs[s]]
            if s in (lo, hi):
                d[s] = np.float32(1e30)
            else:
                span = max(np.float32(vs[hi] - vs[lo]), np.float32(1e-12))
                d[s] = np.float32(np.float32(vs[s + 1] - vs[s - 1]) / span)
        dist = np.empty(n, np.float32)
        dist[order] = d
        total = np.float32(total + dist) if k else dist
    return total


def selection_order(ranks, crowd) -> np.ndarray:
    """The kernel's survivor order: (rank, -crowding, index)."""
    return key_order(ranks, -np.asarray(crowd, np.float32))
