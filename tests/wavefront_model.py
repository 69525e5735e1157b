"""A numpy model of the standalone `wavefront` kernel's algorithm
(`wavefront_reg_kernel` in `csrc/maze_route.cu`), shared by the CPU tests
(imports neither JAX nor the port).

It does what the kernel does, one grid at a time, a bitset word a step:
occ and seed read into words of 32 cells (bit j of word w of a row is
column 32 w + j), whose `open` bits (free, not a seed) the kernel keeps
in registers; the grid's levels, uint16 with 0xffff for "not reached",
the seeds' set to 0, the seeds the first frontier (buffer A, buffer B
zero); then per level every word (with `window`, only the rows next to
the last level's new cells: the variant `tools/time_wavefront.py --steps`
builds, which lost in turns) becomes `m = dilate(cur) & open` in the
other buffer, each new cell's level written (each cell once: the model
checks it); at the end the field, the levels where reached, INF
elsewhere and beyond the grid.
With the window a level rewrites only its window's frontier words, so a
window that moves away and back reads frontier words of earlier levels:
the model counts these stale reads (with `clear=True` it also clears the
words a buffer held two levels before outside the window, and there are
none).  The field is exact either way: a stale frontier cell was reached
at an earlier level, so every neighbour it dilates into was reached by
now and is not open (the fork corridor of the tests and most random
grids read stale words).

`load_bits` models the kernel's byte-to-bit read of occ and seed: the
aligned 4-byte words that hold bytes [i, i + n) of a buffer whose first
byte sits at address `addr0`, each byte's "not zero" moved to its bit by
the multiply `(v & 0x01010101) * 0x01020408 >> 24`.
"""
import numpy as np

INF = 2 ** 29
MASK = 0xffffffff
UNREACHED = 0xffff


def load_bits(buf: np.ndarray, i: int, n: int, addr0: int = 0) -> int:
    """Bits of bytes buf[i, i + n) != 0 (1 <= n <= 32), as the kernel reads
    them: aligned words from address addr0 + i.  Bytes outside `buf` read
    as a fixed pattern (the kernel drops them)."""
    assert 1 <= n <= 32
    addr = addr0 + i
    off = addr & 3
    bits = 0
    for j in range((off + n + 3) >> 2):
        v = 0
        for byte in range(4):
            at = (addr & ~3) + 4 * j + byte - addr0
            val = int(buf[at]) if 0 <= at < len(buf) else 0xa5
            v |= val << (8 * byte)
        ne = 0
        for byte in range(4):                       # __vcmpne4(v, 0)
            if (v >> (8 * byte)) & 0xff:
                ne |= 0xff << (8 * byte)
        ne &= 0x01010101
        bits |= (((ne * 0x01020408) & MASK) >> 24) << (4 * j)
    return (bits >> off) & ((1 << n) - 1)


def _grid_words(occ: np.ndarray, seed: np.ndarray, gw: int):
    """(blocked, seed, valid) words of a (gh, W) grid's first gw columns."""
    gh = occ.shape[0]
    wpr = (gw + 31) // 32
    blocked = np.zeros((gh, wpr), np.uint32)
    seeds = np.zeros((gh, wpr), np.uint32)
    for w in range(wpr):
        x0 = 32 * w
        n = min(32, gw - x0)
        weight = (np.uint64(1) << np.arange(n, dtype=np.uint64))
        blocked[:, w] = (occ[:, x0:x0 + n].astype(np.uint64) * weight).sum(1)
        seeds[:, w] = (seed[:, x0:x0 + n].astype(np.uint64) * weight).sum(1)
    valid = np.array([MASK if gw - 32 * w >= 32 else (1 << (gw - 32 * w)) - 1
                      for w in range(wpr)], np.uint32)
    return blocked.reshape(-1), seeds.reshape(-1), np.tile(valid, gh)


def wavefront_model(occ, seed, grids=None, window: bool = False,
                    clear: bool = False):
    """occ, seed (B, H, W) bool; grids (B, 2) or None.  Returns (dist
    (B, H, W) int32, levels (B,) int64: the levels each grid ran through,
    the last one finding nothing, stale (B,) int64: stale frontier words
    read)."""
    occ = np.asarray(occ, bool)
    seed = np.asarray(seed, bool)
    bsz, h, w = occ.shape
    dist = np.full((bsz, h, w), INF, np.int32)
    levels = np.zeros(bsz, np.int64)
    stale_reads = np.zeros(bsz, np.int64)
    for b in range(bsz):
        gh = min(int(grids[b][0]), h) if grids is not None else h
        gw = min(int(grids[b][1]), w) if grids is not None else w
        if gh <= 0 or gw <= 0:
            continue
        assert gh * gw < UNREACHED, "levels are uint16"
        wpr = (gw + 31) // 32
        words = gh * wpr
        blocked, sd, valid = _grid_words(occ[b, :gh], seed[b, :gh], gw)
        open_ = valid & ~blocked & ~sd
        lv = np.full((gh, gw), UNREACHED, np.uint16)

        def put(m, ks, level):
            for k, word in zip(ks, m):
                r, w0 = divmod(int(k), wpr)
                for bit in range(32):
                    if (int(word) >> bit) & 1:
                        assert lv[r, 32 * w0 + bit] == UNREACHED, \
                            "a cell's level written twice"
                        lv[r, 32 * w0 + bit] = level

        ks = np.arange(words)
        put(sd, ks, 0)
        bufs = [sd.copy(), np.zeros(words, np.uint32)]
        cur, nxt = 0, 1
        rows = np.nonzero(sd.reshape(gh, wpr).any(1))[0]
        lo, hi = (int(rows[0]), int(rows[-1])) if len(rows) else (1, 0)
        a1, e1 = (lo * wpr, (hi + 1) * wpr) if lo <= hi else (0, 0)
        a2, e2 = 0, 0
        first = ks % wpr == 0
        last = ks % wpr == wpr - 1
        exact = sd.copy()            # the true frontier of the last level
        level = 0
        while lo <= hi:
            level += 1
            r0, r1 = (max(0, lo - 1), min(gh - 1, hi + 1)) if window \
                else (0, gh - 1)
            a, e = r0 * wpr, (r1 + 1) * wpr
            c = bufs[cur]
            k = ks[a:e]
            near = np.unique(np.concatenate([k, k[~first[k]] - 1,
                                             k[~last[k]] + 1,
                                             k[k >= wpr] - wpr,
                                             k[k + wpr < words] + wpr]))
            stale_reads[b] += int((c[near] != exact[near]).sum())
            cw = c[k]
            left = (cw << np.uint32(1)) | np.where(
                first[k], 0, c[np.maximum(k - 1, 0)] >> np.uint32(31)
            ).astype(np.uint32)
            right = (cw >> np.uint32(1)) | np.where(
                last[k], 0, c[np.minimum(k + 1, words - 1)] << np.uint32(31)
            ).astype(np.uint32)
            up = np.where(k >= wpr, c[np.maximum(k - wpr, 0)], 0)
            down = np.where(k + wpr < words, c[np.minimum(k + wpr, words - 1)],
                            0)
            m = ((left | right | up | down).astype(np.uint32)
                 & open_[k]).astype(np.uint32)
            open_[k] &= ~m
            n = bufs[nxt]
            if clear:
                stale = np.arange(a2, e2)
                n[stale[(stale < a) | (stale >= e)]] = 0
            n[k] = m
            exact[:] = 0
            exact[k] = m
            put(m, k, level)
            gained = k[m != 0] // wpr
            lo, hi = ((int(gained.min()), int(gained.max())) if len(gained)
                      else (1, 0))
            a2, e2, a1, e1 = a1, e1, a, e
            cur, nxt = nxt, cur
        levels[b] = level
        dist[b, :gh, :gw] = np.where(lv == UNREACHED, INF,
                                     lv.astype(np.int32))
    return dist, levels, stale_reads


def vertical_snake(h: int, w: int):
    """One seed at the top of column 0 of a corridor that runs down the
    even columns and up the next, through gaps at alternate ends of the
    blocked odd columns: the frontier leaves the rows where it began."""
    occ = np.zeros((1, h, w), bool)
    for c in range(1, w, 2):
        occ[0, :, c] = True
        occ[0, h - 1 if (c // 2) % 2 == 0 else 0, c] = False
    seed = np.zeros_like(occ)
    seed[0, 0, 0] = True
    return occ, seed


def fork():
    """A dead end up column 0 and a long way round that comes back up
    column 30 beside the dead end's rows: the window leaves those rows and
    returns to them, so a level reads frontier words of an earlier one."""
    occ = np.ones((1, 12, 40), bool)
    occ[0, 2:, 0] = False
    occ[0, 11, :31] = False
    occ[0, 3:, 30] = False
    seed = np.zeros_like(occ)
    seed[0, 11, 0] = True
    return occ, seed


def corridor_cases():
    """[(name, occ, seed)] of the two corridors."""
    return [("snake", *vertical_snake(20, 9)), ("fork", *fork())]
