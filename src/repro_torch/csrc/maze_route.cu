// Lee maze-router kernels for Hopper (sm_90a), plain C interface.
//
// route_slots replaces the reference's `_route_program`
// (src/repro/eda/batched_flow.py:342-365): every net slot of a layout
// bucket in order, each slot a BFS from the net's hub (`wavefront_kernel`,
// src/repro/kernels/maze_route/kernel.py:71) and the backtrace and commit
// of its star targets (`_dir_field`, `_trace_one` and the commit of
// `_route_step`, batched_flow.py:313-339), all under one `lax.scan`.  Here
// it is one persistent launch: one CTA per grid of the bucket loops over
// the grid's slots itself (grids depend on nothing outside themselves, so
// no grid-wide barrier is needed) and ends after its own last real net.
//
//   Bound on the H100: bytes are small (occ0 read and occ written once,
//   ~210 MB for the 16 kb bucket of 86 grids padded to 1118 x 274, plus
//   the nets), so what binds is latency: per slot, one block barrier per
//   BFS level and a dependent walk of d0 steps per target.  The CTA of the
//   grid with the most levels over all its slots sets the launch's time.
//
//   Design:
//   * State in shared memory for the whole launch: the occupancy count as
//     uint16 over the grid's own gh x gw cells (offset so it is exact for
//     any int32 occ0; see `count0`; a launch whose grids may reach 2^16
//     keeps uint32 counts in device memory instead), and bitsets of
//     ceil(gw / 32) words per
//     row: free, visited, two frontiers, the cells whose arrival resolves a
//     target, and two planes of each cell's backtrace direction.  No
//     distance is stored.  A grid whose counts do not fit shared memory
//     (the 65536 array's 122 x 1090) keeps them in a device-memory scratch
//     that the wrapper allocates (it stays in L2), its bitsets in shared
//     memory; a grid whose bitsets do not fit either (65536 at coarse 32,
//     241 x 2178) keeps both in the scratch.
//   * Bit-parallel, level-synchronous BFS, the TPU kernel's own plane
//     shifts (`_shift`, kernel.py:34-45) at one bit a cell:
//     next = dilate(frontier) & free & ~visited, the dilation by word shifts
//     with carries across words ORed with the rows above and below.  A
//     level touches only the window of cells within `level` of the hub.
//     The hub is seeded at level 0 even when it is occupied.
//   * The backtrace direction instead of the distance: a cell reached at
//     level d has its d - 1 neighbours in the previous frontier, so the
//     reference's choice (the first NEIGHBORS cell, down, up, right, left,
//     at d - 1) is the first of the four dilation terms that holds its
//     bit: two bitplanes written a word at a time, no per-cell store.
//   * Early stop: a slot's BFS ends at the first level at which every masked
//     target is resolved, or when the frontier empties.  A free target is
//     resolved when it is reached (d0 = that level); a blocked one when any
//     of its four neighbours is (level order makes that neighbour the
//     minimum: d0 = level + 1, entered from the first such neighbour).  The
//     thread that finds such a cell records d0 and clears the target's bit
//     in a shared mask, which the level's barrier publishes.  It is exact:
//     the walk reads only cells at distance below d0, and `ok` and the
//     wirelength use d0 alone.
//   * Backtrace and commit on chip, by warp 0 (`trace_slot`): lane t walks
//     star target t to the hub along the directions into a path buffer,
//     then the warp commits all lanes' cells at once to the shared count,
//     clearing the free bit of a cell whose count reaches capacity, for the
//     next slot.
//   * The count of the real cells is written once into the (B, H, W) int32
//     occ at the end, the pad copied from occ0; the counters into (B,).
//
// wavefront, the standalone counterpart of `wavefront_kernel`, runs the
// same bit-parallel BFS from a seed plane to the full field (no early
// stop), writing each cell's level into the int32 output: dist = 0 on
// seeds (even when occupied), INF = 2^29 where unreachable, blocked or
// beyond the grid's own extent.  One CTA per grid.
//
//   Bound on the H100: latency again.  Its bytes (occ and seed read once,
//   the int32 field written once) are ~0.03 ms for the 16 kb front's 86
//   grids; what binds is one block barrier per BFS level, ~400 levels for
//   a sequential-flow net on 122 x 274, ~1,300 for the front's longest
//   grid.  A level's own work is small: every grid of the paths holds at
//   most ~1,100 bitset words (the padded 1118 x 274 plane is the union of
//   tall narrow and short wide grids).
//
//   Design (`wavefront_reg_kernel`, grids of up to kLevelCells cells whose
//   state fits shared memory, ~3,080 bitset words: every grid of the
//   paths): 1024 threads, thread t
//   owning words t, t + 1024, ... of the grid's row-major words.  Each
//   word's `open` bits (free and not yet reached) stay in the owner's
//   registers for the whole launch; the two frontier buffers and the
//   grid's levels (uint16, bit-major so that a warp's lanes store to
//   different banks) sit in shared memory, and the whole H x W field is
//   written once at the end, 16 bytes a store.  So a level touches no
//   device memory: the earlier kernel's stores of each level's cells to
//   the field took 16-29 % of its time.  occ and seed are read four bytes
//   a load into each word's bits.  A level sweeps every word of the grid:
//   sweeping only the rows next to the last level's new cells cost more
//   in its block-wide row reduction than it saved (tools/time_wavefront.py
//   measures each step).  Larger grids (241 x 2178, 122 x 1090) keep the
//   earlier kernel (`wavefront_kernel`: 512 threads, four bitsets in
//   shared memory, or in a device-memory scratch when they do not fit,
//   each level's cells stored to the field).
//
// trace_paths keeps its entry point, one net slot over a given int32
// field, on the same `trace_slot` walk (one warp per grid, atomics into
// the int32 occupancy).
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <type_traits>
#include <utility>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 512;
constexpr int kMaxTargets = 32;   // one warp lane per star target
constexpr int kPath = 64;         // walk steps a lane takes between commits
constexpr int kNone = 4;          // no direction
// Dynamic shared memory a block may use: 232,448 B less room for the
// kernels' static shared memory (route_slots' `Slot`).
constexpr int kSmemReserve = 10 * 1024;
constexpr int kSmemLimit = 232448 - kSmemReserve;
// wavefront_reg_kernel: threads; the most cells of a grid (its levels are
// uint16 in shared memory, 0xffff for "not reached").
constexpr int kWaveThreads = 1024;
constexpr int kLevelCells = 0xfffe;
constexpr uint16_t kUnreached = 0xffff;

// The bitsets of one grid, row-major, `wpr` words per row; bit j of word w
// is column 32 w + j.  (The two frontier buffers are passed beside it as
// plain pointers: an array of them indexed by level parity would put the
// struct in local memory.)
struct Bits {
  uint32_t* free;   // the cell may be entered
  uint32_t* vis;    // reached by the current BFS
  int gh, gw, wpr;

  __device__ bool test(const uint32_t* s, int y, int x) const {
    return (s[y * wpr + (x >> 5)] >> (x & 31)) & 1u;
  }
};

// One word's new frontier cells `m` (word k = row r, word w) and, for each
// bit, whether its neighbour below / above / right / left was on the
// previous frontier: the dilation's four terms.
struct Arrival {
  int r, w, k;
  uint32_t m, down, up, right, left;
};

// One BFS level over rows [r0, r1) and words [w0, w1): the free, unvisited
// cells next to the frontier `cur` become the frontier `nxt` and visited,
// and `on_new` sees each word that gained cells.  Words of `nxt` outside
// the window are left as they are: the window holds every cell the level
// can reach, and they are zero.  Returns whether this thread found a new
// cell.
template <class OnNew>
__device__ bool bfs_level(const Bits g, const uint32_t* cur, uint32_t* nxt,
                          int r0, int r1, int w0, int w1, OnNew on_new) {
  const int nw = w1 - w0, n = (r1 - r0) * nw, wpr = g.wpr;
  // i / nw through a correctly rounded reciprocal: (i + 1/2) / nw lies at
  // least 1 / (2 nw) from an integer, and the float product errs by less
  // than that while i + 1/2 < 2^22.
  const float inv = __frcp_rn((float)nw);
  bool found = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int dr = __float2int_rz(((float)i + 0.5f) * inv);
    const int r = r0 + dr, w = w0 + i - dr * nw;
    const int k = r * wpr + w;
    const uint32_t c = cur[k];
    const uint32_t left = (c << 1) | (w > 0 ? cur[k - 1] >> 31 : 0u);
    const uint32_t right = (c >> 1) | (w + 1 < wpr ? cur[k + 1] << 31 : 0u);
    const uint32_t up = r > 0 ? cur[k - wpr] : 0u;
    const uint32_t down = r + 1 < g.gh ? cur[k + wpr] : 0u;
    const uint32_t v = g.vis[k];
    const uint32_t m = (left | right | up | down) & g.free[k] & ~v;
    nxt[k] = m;
    if (m) {
      g.vis[k] = v | m;
      found = true;
      on_new(Arrival{r, w, k, m, down, up, right, left});
    }
  }
  return found;
}

// NEIGHBORS (down, up, right, left) as offsets of direction k.
__device__ __forceinline__ int dir_y(int k) { return (k == 0) - (k == 1); }
__device__ __forceinline__ int dir_x(int k) { return (k == 2) - (k == 3); }

// How the new cells m of word w of row r resolve target (ty, tx): kNone if
// the target is one of them (it is reached); for a blocked target, the
// first direction j whose neighbour is one of them (entry from j); -1 when
// neither holds.
__device__ __forceinline__ int resolves(int r, int w, uint32_t m, int ty,
                                        int tx, bool blocked) {
  auto hit = [&](int y, int x) {
    return y == r && x >= 0 && (x >> 5) == w && ((m >> (x & 31)) & 1u);
  };
  if (hit(ty, tx)) return kNone;
  if (blocked)
    for (int j = 0; j < 4; ++j)
      if (hit(ty + dir_y(j), tx + dir_x(j))) return j;
  return -1;
}

// The backtrace and commit of one net slot on one grid, by one warp (the
// reference's `_trace_one` and the commit of `_route_step`): the lane with
// `act` set takes the star target (ty, tx), at distance d0 from the hub
// (kInf if unreachable); `entry` is kNone, or for a blocked target the
// direction of its first neighbour at d0 - 1.  dir(y, x, d) is the
// backtrace direction of a cell at distance d (kNone if there is none),
// commit(y, x) adds one visit.  The slot routes (`ok`) when it is real and
// every active target is reachable; then each active lane walks from its
// target to the hub.  The walk only reads: each lane puts up to kPath cells
// in its row of `path` ((y << 16) | x), then the whole warp commits every
// lane's cells at once, so the commits' atomics run side by side.  Returns
// ok on every lane, and in `wl` the slot's path points (sum of d0 + 1).
template <class Dir, class Commit>
__device__ bool trace_slot(bool act, int ty, int tx, int d0, int entry,
                           bool real, Dir dir, Commit commit,
                           int (*path)[kPath], int& wl) {
  const int lane = threadIdx.x & 31;
  const bool ok = __all_sync(0xffffffffu, !act || d0 < kInf) && real;
  wl = __reduce_add_sync(0xffffffffu, act && ok ? d0 + 1 : 0);
  if (!ok) return ok;
  int* mine = path[lane];
  int y = ty, x = tx, d = d0, n = 0;
  if (act) {
    mine[n++] = (y << 16) | x;
    if (entry != kNone) {
      y += dir_y(entry);
      x += dir_x(entry);
      mine[n++] = (y << 16) | x;
      d = d0 - 1;
    }
  } else {
    d = 0;
  }
  for (;;) {
    while (d > 0 && n < kPath) {
      const int k = dir(y, x, d);
      if (k == kNone) {  // unreachable: BFS fields always hold the chain
        d = 0;
        break;
      }
      y += dir_y(k);
      x += dir_x(k);
      mine[n++] = (y << 16) | x;
      --d;
    }
    __syncwarp();
    for (uint32_t q = __ballot_sync(0xffffffffu, n > 0); q; q &= q - 1) {
      const int t = __ffs(q) - 1, nt = __shfl_sync(0xffffffffu, n, t);
      for (int i = lane; i < nt; i += 32)
        commit(path[t][i] >> 16, path[t][i] & 0xffff);
    }
    __syncwarp();
    if (!__any_sync(0xffffffffu, d > 0)) break;
    n = 0;
  }
  return ok;
}

// The net slots of a bucket, (B, S, ...) row-major.
struct Nets {
  const int* hubs;       // (B, S, 2) (y, x)
  const int* tgts;       // (B, S, T, 2)
  const uint8_t* tmask;  // (B, S, T)
  const uint8_t* nmask;  // (B, S)
  int S, T;
  int K;  // one more than the most masked targets a grid routes
};

// Outputs of route_slots, (B, H, W) and (B,).
struct Routed {
  int *occ, *routed, *failed, *wirelen, *levels;
};

// count0: a cell is blocked when occ0 + visits >= capacity, and a walk
// enters a cell at most once, so a launch adds at most A visits to a cell,
// A the most masked targets of real slots a grid has.  So the kernel keeps
// u = clamp(occ0 - lo, 0, K) + visits with K = A + 1, lo = capacity - K:
// blocked iff u >= K, at most 2 A + 1 (uint16 below 2^16, else uint32; the
// wrapper picks), and occ = occ0 + u - clamp(occ0 - lo, 0, K) at the end.
__device__ __forceinline__ int count0(int o, long long lo, int K) {
  return (int)min((long long)K, max(0LL, (long long)o - lo));
}

// A CTA's per-slot state, in shared memory.
struct Slot {
  int tg[kMaxTargets][2];
  int d0[kMaxTargets];     // distance of each target
  int entry[kMaxTargets];  // a blocked target's entry direction
  int path[kMaxTargets][kPath];
  int hub[2];
  uint32_t act;      // the slot's masked targets, a bit each
  uint32_t blocked;  // ... those on a blocked cell
  // Unresolved targets, by level parity: a level's finders clear bits of
  // its own word, which no thread writes again until two barriers later.
  uint32_t unres[2];
  int real, last;
};
static_assert(sizeof(Slot) + 512 <= kSmemReserve, "Slot outgrew its room");

// One grid's slots.  `bits` holds seven bitsets of max_words words: free,
// visited, the two frontiers, `watch` (the cells whose arrival resolves a
// target: a free target itself, a blocked one's neighbours) and the two
// direction planes (bit 0 and bit 1 of each visited cell's NEIGHBORS index
// towards d - 1).  cnt holds the grid's gh x gw counts; `Cnt` makes them
// uint16 in shared or global memory or uint32 in global memory, so its
// atomics are of the right kind.
template <class Cnt>
__device__ __forceinline__ void route_grid(Slot& st, const Nets& nets,
                           const int* __restrict__ occ0, const Routed& out,
                           uint32_t* bits, int max_words, int gh, int gw,
                           Cnt cnt, int H, int W, int capacity) {
  const Bits g{bits, bits + max_words, gh, gw, (gw + 31) >> 5};
  uint32_t* const fr0 = bits + 2 * max_words;
  uint32_t* const fr1 = bits + 3 * max_words;
  uint32_t* const watch = bits + 4 * max_words;
  uint32_t* const dlo = bits + 5 * max_words;
  uint32_t* const dhi = bits + 6 * max_words;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int S = nets.S, T = nets.T, K = nets.K, wpr = g.wpr;
  const long long lo = (long long)capacity - K;
  const int words = gh * wpr;
  const size_t base = (size_t)b * H * W;

  // Counts and free bits of the grid's own cells, one warp per word.
  for (int i = warp; i < words; i += nwarps) {
    const int r = i / wpr, x = (i - r * wpr) * 32 + lane;
    bool enterable = false;
    if (x < gw) {
      const int u = count0(occ0[base + (size_t)r * W + x], lo, K);
      cnt.set(r * gw + x, u);
      enterable = u < K;
    }
    const uint32_t word = __ballot_sync(0xffffffffu, enterable);
    if (lane == 0) g.free[i] = word;
  }
  if (tid == 0) st.last = -1;
  __syncthreads();
  for (int s = tid; s < S; s += blockDim.x)
    if (nets.nmask[(size_t)b * S + s]) atomicMax(&st.last, s);
  __syncthreads();
  const int last = st.last;

  auto dir_at = [=](int y, int x, int) -> int {
    const int k = y * wpr + (x >> 5), sh = x & 31;
    return ((dlo[k] >> sh) & 1u) | (((dhi[k] >> sh) & 1u) << 1);
  };
  auto commit = [=](int y, int x) {
    if (cnt.inc(y * gw + x) + 1 >= (uint32_t)K)
      atomicAnd(&g.free[y * wpr + (x >> 5)], ~(1u << (x & 31)));
  };

  int routed = 0, failed = 0, wirelen = 0, levels = 0;  // thread 0's
  for (int s = 0; s <= last; ++s) {
    const size_t bs = (size_t)b * S + s;
    if (warp == 0) {
      const bool real = nets.nmask[bs] != 0;
      const bool act = real && lane < T && nets.tmask[bs * T + lane] != 0;
      if (lane < T) {
        st.tg[lane][0] = nets.tgts[(bs * T + lane) * 2];
        st.tg[lane][1] = nets.tgts[(bs * T + lane) * 2 + 1];
      }
      const uint32_t m = __ballot_sync(0xffffffffu, act);
      if (lane == 0) {
        st.real = real;
        st.act = m;
        st.hub[0] = nets.hubs[bs * 2];
        st.hub[1] = nets.hubs[bs * 2 + 1];
      }
    }
    for (int i = tid; i < words; i += blockDim.x)
      g.vis[i] = fr0[i] = fr1[i] = watch[i] = 0;
    __syncthreads();
    const bool real = st.real;
    const uint32_t act = st.act;
    const int hy = st.hub[0], hx = st.hub[1];
    if (real && warp == 0) {
      // Seed the hub (level 0) and mark what resolves each target; a
      // target at the hub, or a blocked one next to it, is resolved now.
      const bool mine = (act >> lane) & 1u;
      const int ty = st.tg[lane][0], tx = st.tg[lane][1];
      const bool blocked = mine && !g.test(g.free, ty, tx);
      int now = -1;
      if (mine) {
        const int ny[5] = {ty, ty + 1, ty - 1, ty, ty};
        const int nx[5] = {tx, tx, tx, tx + 1, tx - 1};
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          if (j > 0 && !blocked) break;
          if (ny[j] >= 0 && ny[j] < gh && nx[j] >= 0 && nx[j] < gw)
            atomicOr(&watch[ny[j] * wpr + (nx[j] >> 5)], 1u << (nx[j] & 31));
        }
        now = resolves(hy, hx >> 5, 1u << (hx & 31), ty, tx, blocked);
        st.d0[lane] = now < 0 ? kInf : now == kNone ? 0 : 1;
        st.entry[lane] = now < 0 ? kNone : now;
      }
      const uint32_t bm = __ballot_sync(0xffffffffu, blocked);
      const uint32_t done = __ballot_sync(0xffffffffu, now >= 0);
      if (lane == 0) {
        const uint32_t bit = 1u << (hx & 31);
        g.vis[hy * wpr + (hx >> 5)] |= bit;
        fr0[hy * wpr + (hx >> 5)] |= bit;
        st.blocked = bm;
        st.unres[0] = st.unres[1] = act & ~done;
      }
    }
    __syncthreads();
    if (real) {
      uint32_t unres = st.unres[0];
      const uint32_t blocked = st.blocked;
      int level = 0;
      uint32_t *cur = fr0, *nxt = fr1;
      while (unres) {
        ++level;
        const int r0 = max(0, hy - level), r1 = min(gh, hy + level + 1);
        const int w0 = max(0, hx - level) >> 5;
        const int w1 = (min(gw - 1, hx + level) >> 5) + 1;
        uint32_t* const sres = &st.unres[level & 1];
        const bool found = bfs_level(
            g, cur, nxt, r0, r1, w0, w1, [=, &st](const Arrival& a) {
              // Direction planes: the first of down, up, right, left that
              // was on the previous frontier.
              const uint32_t du = a.down | a.up;
              const uint32_t p0 = (a.up & ~a.down) | ~(du | a.right);
              dlo[a.k] = (dlo[a.k] & ~a.m) | (a.m & p0);
              dhi[a.k] = (dhi[a.k] & ~a.m) | (a.m & ~du);
              if (!(a.m & watch[a.k])) return;
              for (uint32_t q = unres; q; q &= q - 1) {
                const int t = __ffs(q) - 1;
                const int how = resolves(a.r, a.w, a.m, st.tg[t][0],
                                         st.tg[t][1], (blocked >> t) & 1u);
                if (how < 0) continue;
                st.d0[t] = how == kNone ? level : level + 1;
                if (how != kNone) atomicMin(&st.entry[t], how);
                atomicAnd(sres, ~(1u << t));
              }
            });
        if (!__syncthreads_or(found)) break;
        unres &= *(volatile uint32_t*)sres;
        uint32_t* const t = cur;
        cur = nxt;
        nxt = t;
      }
      levels += level;
      if (warp == 0) {
        const bool mine = (act >> lane) & 1u;
        int wl;
        const bool ok = trace_slot(
            mine, mine ? st.tg[lane][0] : 0, mine ? st.tg[lane][1] : 0,
            mine ? st.d0[lane] : kInf, mine ? st.entry[lane] : kNone, true,
            dir_at, commit, st.path, wl);
        routed += ok;
        failed += !ok;
        wirelen += ok ? wl : 0;
      }
    }
    __syncthreads();
  }

  // occ = occ0 + visits on the grid's own cells, occ0 on the pad.
  for (int r = warp; r < H; r += nwarps) {
    for (int x = lane; x < W; x += 32) {
      const size_t gi = base + (size_t)r * W + x;
      const int o = occ0[gi];
      out.occ[gi] = (r < gh && x < gw)
          ? (int)((long long)o + cnt.get(r * gw + x) - count0(o, lo, K))
          : o;
    }
  }
  if (tid == 0) {
    out.routed[b] = routed;
    out.failed[b] = failed;
    out.wirelen[b] = wirelen;
    if (out.levels) out.levels[b] = levels;
  }
}

// The grid's counts: uint16 in shared or in global memory, or uint32 in
// global memory.  `inc` adds one visit to cell c and returns the count
// before it.  uint16 counts come in pairs in 32-bit words, one atomic adding
// to one half.  The shared kind names its space to the atomic (a generic
// atomic on shared memory is several times slower).
struct SharedCounts {
  uint16_t* p;
  __device__ uint32_t get(int c) const { return p[c]; }
  __device__ void set(int c, int u) const { p[c] = (uint16_t)u; }
  __device__ uint32_t inc(int c) const {
    const int sh = (c & 1) << 4;
    const unsigned a = static_cast<unsigned>(
        __cvta_generic_to_shared(reinterpret_cast<uint32_t*>(p) + (c >> 1)));
    uint32_t old;
    asm volatile("atom.shared.add.u32 %0, [%1], %2;"
                 : "=r"(old) : "r"(a), "r"(1u << sh) : "memory");
    return (old >> sh) & 0xffffu;
  }
};
struct GlobalCounts {
  uint16_t* p;
  __device__ uint32_t get(int c) const { return p[c]; }
  __device__ void set(int c, int u) const { p[c] = (uint16_t)u; }
  __device__ uint32_t inc(int c) const {
    const int sh = (c & 1) << 4;
    const uint32_t old =
        atomicAdd(reinterpret_cast<uint32_t*>(p) + (c >> 1), 1u << sh);
    return (old >> sh) & 0xffffu;
  }
};
struct GlobalCounts32 {
  uint32_t* p;
  __device__ uint32_t get(int c) const { return p[c]; }
  __device__ void set(int c, int u) const { p[c] = (uint32_t)u; }
  __device__ uint32_t inc(int c) const { return atomicAdd(p + c, 1u); }
};

// kWide: uint32 counts, all in the device-memory scratch (smem_cells is 0).
template <bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
route_slots_kernel(Nets nets, const int* __restrict__ occ0,
                   const int* __restrict__ grids, Routed out,
                   void* g_cnt, uint32_t* g_bits, int H, int W,
                   int capacity, int smem_cells, int smem_words,
                   long long scratch_cells, long long scratch_words) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ Slot st;
  const int b = blockIdx.x;
  const int gh = min(grids[2 * b], H), gw = min(grids[2 * b + 1], W);
  using GCounts = typename std::conditional<kWide, GlobalCounts32,
                                            GlobalCounts>::type;
  using GWord = typename std::conditional<kWide, uint32_t, uint16_t>::type;
  const GCounts g_counts{static_cast<GWord*>(g_cnt) + b * scratch_cells};
  // Each branch derives its own pointers, so that the compiler sees which
  // memory space every bitset access goes to.
  if (gh * ((gw + 31) >> 5) <= smem_words) {
    // the bitsets follow smem_cells (even) uint16 counts
    uint32_t* bits = smem + smem_cells / 2;
    if (!kWide && gh * gw <= smem_cells)
      route_grid(st, nets, occ0, out, bits, smem_words, gh, gw,
                 SharedCounts{reinterpret_cast<uint16_t*>(smem)}, H, W,
                 capacity);
    else
      route_grid(st, nets, occ0, out, bits, smem_words, gh, gw, g_counts, H,
                 W, capacity);
  } else {
    route_grid(st, nets, occ0, out, g_bits + b * 7 * scratch_words,
               (int)scratch_words, gh, gw, g_counts, H, W, capacity);
  }
}

// The BFS field of grid blockIdx.x; `bits` holds four bitsets of
// max_words words: free, visited and the two frontiers.
__device__ __forceinline__ void wavefront_grid(
    const uint8_t* __restrict__ occ, const uint8_t* __restrict__ seed,
    const int* __restrict__ grids, int* __restrict__ dist, int H, int W,
    uint32_t* bits, int max_words) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int gh = grids ? min(grids[2 * b], H) : H;
  const int gw = grids ? min(grids[2 * b + 1], W) : W;
  const Bits g{bits, bits + max_words, gh, gw, (gw + 31) >> 5};
  uint32_t* cur = bits + 2 * max_words;
  uint32_t* nxt = bits + 3 * max_words;
  const int words = gh * g.wpr;
  const size_t base = (size_t)b * H * W;
  int* db = dist + base;

  // Free bits; the seeds are visited at level 0 and are the first frontier.
  for (int i = warp; i < words; i += nwarps) {
    const int r = i / g.wpr, x = (i - r * g.wpr) * 32 + lane;
    const bool in = x < gw;
    const size_t k = base + (size_t)r * W + x;
    const bool sd = in && seed[k];
    const uint32_t enterable = __ballot_sync(0xffffffffu, in && !occ[k]);
    const uint32_t seeds = __ballot_sync(0xffffffffu, sd);
    if (sd) db[r * W + x] = 0;
    if (lane == 0) {
      g.free[i] = enterable;
      g.vis[i] = cur[i] = seeds;
      nxt[i] = 0;
    }
  }
  __syncthreads();
  for (int level = 1;; ++level) {
    const bool found =
        bfs_level(g, cur, nxt, 0, gh, 0, g.wpr, [=](const Arrival& a) {
          for (uint32_t q = a.m; q; q &= q - 1)
            db[a.r * W + (a.w << 5) + __ffs(q) - 1] = level;
        });
    if (!__syncthreads_or(found)) break;
    uint32_t* const t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int r = warp; r < H; r += nwarps)
    for (int x = lane; x < W; x += 32)
      if (r >= gh || x >= gw || !g.test(g.vis, r, x)) db[r * W + x] = kInf;
}

__global__ void __launch_bounds__(kThreads, 1)
wavefront_kernel(const uint8_t* __restrict__ occ,
                 const uint8_t* __restrict__ seed,
                 const int* __restrict__ grids, int* __restrict__ dist, int H,
                 int W, uint32_t* g_bits, int max_words) {
  extern __shared__ __align__(16) uint32_t sbits[];
  if (g_bits)
    wavefront_grid(occ, seed, grids, dist, H, W,
                   g_bits + (size_t)blockIdx.x * 4 * max_words, max_words);
  else
    wavefront_grid(occ, seed, grids, dist, H, W, sbits, max_words);
}

// The plane's word k as (row, word of the row), by a correctly rounded
// reciprocal of the words per row (exact while k + 1/2 < 2^22).
__device__ __forceinline__ int row_of(int k, float inv_wpr) {
  return __float2int_rz(((float)k + 0.5f) * inv_wpr);
}

// Bytes p[i, i + n) (1 <= n <= 32) as bits, bit j set where byte i + j is
// not 0, from the aligned 4-byte words that hold them, each read once (an
// aligned load that holds one byte of an allocation stays inside it; the
// bytes outside the range are dropped).
__device__ __forceinline__ uint32_t load_bits(const uint8_t* __restrict__ p,
                                              size_t i, int n) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p + i);
  const uint32_t* q =
      reinterpret_cast<const uint32_t*>(addr & ~(uintptr_t)3);
  const int off = (int)(addr & 3), nw = (off + n + 3) >> 2;
  uint64_t bits = 0;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    if (j < nw) {
      // bytes 0 / 1, then byte j of the word to bit j
      const uint32_t v = __vcmpne4(__ldg(q + j), 0u) & 0x01010101u;
      bits |= (uint64_t)((v * 0x01020408u) >> 24) << (4 * j);
    }
  }
  return (uint32_t)(bits >> off) & (n == 32 ? 0xffffffffu : (1u << n) - 1u);
}

// Index of the level of bit `bit` of word k in a grid of `stride` (its
// words, made odd) words: bit-major, so the lanes of a warp, which hold
// neighbouring words, store their cells' levels to different banks.
__device__ __forceinline__ int level_at(int bit, int k, int stride) {
  return bit * stride + k;
}

// The field of grid blockIdx.x, whose own extent holds at most WPT *
// kWaveThreads bitset words and kLevelCells cells (see the design note at
// the top).  Shared memory: two frontier buffers of max_words words, then
// the grid's levels, 32 (max_words | 1) uint16.
template <int WPT>
__global__ void __launch_bounds__(kWaveThreads, 1)
wavefront_reg_kernel(const uint8_t* __restrict__ occ,
                     const uint8_t* __restrict__ seed,
                     const int* __restrict__ grids, int* __restrict__ dist,
                     int H, int W, int max_words) {
  extern __shared__ __align__(16) uint32_t fr[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int gh = grids ? min(grids[2 * b], H) : H;
  const int gw = grids ? min(grids[2 * b + 1], W) : W;
  const int wpr = (gw + 31) >> 5, words = gh * wpr, stride = words | 1;
  const float inv = __frcp_rn((float)wpr);
  const size_t base = (size_t)b * H * W;
  int* const db = dist + base;
  uint16_t* const lv = reinterpret_cast<uint16_t*>(fr + 2 * max_words);

  // Nothing reached yet: every level 0xffff.
  for (int i = tid; i < 16 * stride; i += kWaveThreads)
    reinterpret_cast<uint32_t*>(lv)[i] = 0xffffffffu;
  __syncthreads();
  // Level `level` into the cells of bits m of word k.
  auto put = [&](uint32_t m, int k, int level) {
    for (uint32_t q = m; q; q &= q - 1)
      lv[level_at(__ffs(q) - 1, k, stride)] = (uint16_t)level;
  };

  // Each owned word's open bits (free, not a seed) and whether it begins
  // or ends its row (bits 2 i, 2 i + 1 of `edge`); the seeds are level 0
  // and the first frontier (buffer cur), the other buffer zero.
  uint32_t* cur = fr;
  uint32_t* nxt = fr + max_words;
  uint32_t open[WPT];
  uint32_t edge = 0;
  bool found = false;
#pragma unroll
  for (int i = 0; i < WPT; ++i) {
    open[i] = 0;
    const int k = tid + i * kWaveThreads;
    if (k >= words) continue;
    const int r = row_of(k, inv), w = k - r * wpr;
    const int n = min(32, gw - (w << 5));
    const size_t c0 = base + (size_t)r * W + (w << 5);
    const uint32_t blocked = load_bits(occ, c0, n);
    const uint32_t sd = load_bits(seed, c0, n);
    const uint32_t valid = n == 32 ? 0xffffffffu : (1u << n) - 1u;
    open[i] = valid & ~blocked & ~sd;
    edge |= (uint32_t)(w == 0) << (2 * i);
    edge |= (uint32_t)(w == wpr - 1) << (2 * i + 1);
    cur[k] = sd;
    nxt[k] = 0;
    if (sd) {
      put(sd, k, 0);
      found = true;
    }
  }

  // One barrier a level: it publishes the last level's frontier and
  // levels, and whether any thread found a cell.
  for (int level = 1; __syncthreads_or(found); ++level) {
    found = false;
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int k = tid + i * kWaveThreads;
      if (k >= words) continue;
      const uint32_t c = cur[k];
      const uint32_t left =
          (c << 1) | ((edge >> (2 * i)) & 1u ? 0u : cur[k - 1] >> 31);
      const uint32_t right =
          (c >> 1) | ((edge >> (2 * i + 1)) & 1u ? 0u : cur[k + 1] << 31);
      const uint32_t up = k >= wpr ? cur[k - wpr] : 0u;
      const uint32_t down = k + wpr < words ? cur[k + wpr] : 0u;
      const uint32_t m = (left | right | up | down) & open[i];
      nxt[k] = m;
      if (m) {
        open[i] &= ~m;
        put(m, k, level);
        found = true;
      }
    }
    uint32_t* const t = cur;
    cur = nxt;
    nxt = t;
  }

  // The field, 16 bytes a store: a grid cell's level (INF where not
  // reached), INF beyond the grid.
  const int cells = H * W;
  const int head = min(cells, (int)(((16u - (reinterpret_cast<uintptr_t>(
                                   db) & 15u)) & 15u) >> 2));
  auto at = [&](int p) {
    const int y = p / W, x = p - y * W;
    if (y >= gh || x >= gw) return kInf;
    const int v = lv[level_at(x & 31, y * wpr + (x >> 5), stride)];
    return v == kUnreached ? kInf : v;
  };
  const int nv = (cells - head) >> 2;
  int4* const v = reinterpret_cast<int4*>(db + head);
  for (int i = tid; i < nv; i += kWaveThreads) {
    const int p = head + 4 * i;
    v[i] = make_int4(at(p), at(p + 1), at(p + 2), at(p + 3));
  }
  if (tid < head) db[tid] = at(tid);
  if (tid < cells - head - 4 * nv)
    db[head + 4 * nv + tid] = at(head + 4 * nv + tid);
}

__global__ void trace_paths_kernel(const int* __restrict__ dist,
                                   const int* __restrict__ tgts,
                                   const uint8_t* __restrict__ tmask,
                                   const uint8_t* __restrict__ nmask,
                                   int* __restrict__ occ,
                                   int* __restrict__ routed,
                                   int* __restrict__ failed,
                                   int* __restrict__ wirelen, int B, int T,
                                   int H, int W) {
  const int b = blockIdx.x, lane = threadIdx.x;  // one warp per grid
  const int* db = dist + (size_t)b * H * W;
  int* ob = occ + (size_t)b * H * W;
  const bool real = nmask[b] != 0;
  const bool act = real && lane < T && tmask[b * T + lane] != 0;
  const int ty = act ? tgts[(b * T + lane) * 2] : 0;
  const int tx = act ? tgts[(b * T + lane) * 2 + 1] : 0;
  auto dist_at = [&](int y, int x) {
    return (y >= 0 && y < H && x >= 0 && x < W) ? db[y * W + x] : kInf;
  };
  // d0: the target's field value, or for a blocked target one more than
  // its best neighbour, entered from the first neighbour at d0 - 1.
  int d0 = kInf, entry = kNone;
  if (act) {
    const int dv = dist_at(ty, tx);
    int nd[4], best = kInf;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      nd[k] = dist_at(ty + dir_y(k), tx + dir_x(k));
      best = min(best, nd[k]);
    }
    d0 = dv < kInf ? dv : min(kInf, best + 1);
    if (dv >= kInf)
      entry = nd[0] == d0 - 1 ? 0 : nd[1] == d0 - 1 ? 1
            : nd[2] == d0 - 1 ? 2 : 3;
  }
  // the first NEIGHBORS cell at d - 1
  auto dir = [&](int y, int x, int d) {
    int k = kNone;
#pragma unroll
    for (int j = 3; j >= 0; --j)
      if (dist_at(y + dir_y(j), x + dir_x(j)) == d - 1) k = j;
    return k;
  };
  auto commit = [&](int y, int x) { atomicAdd(ob + y * W + x, 1); };
  __shared__ int path[32][kPath];
  int wl;
  const bool ok =
      trace_slot(act, ty, tx, d0, entry, real, dir, commit, path, wl);
  if (lane == 0) {
    routed[b] += ok ? 1 : 0;
    failed[b] += (real && !ok) ? 1 : 0;
    wirelen[b] += ok ? wl : 0;
  }
}

// The most dynamic shared memory a launch of `kernel` may ask for is a
// per-function attribute, shared by every host thread.  It is set to the
// limit, the same value every time: set to each launch's own size, it
// raced between threads launching at once (one thread's smaller size
// landed between another's set and launch, which then failed with
// cudaErrorInvalidValue).  It is set once per kernel and device, not on
// every launch; a thread that finds it unset sets the same value.
template <class K>
int allow_smem(K* kernel) {
  static std::mutex lock;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  const int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  const std::pair<const void*, int> key{(const void*)kernel, dev};
  {
    std::lock_guard<std::mutex> hold(lock);
    if (done.count(key)) return 0;
  }
  const int set = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (set == 0) {
    std::lock_guard<std::mutex> hold(lock);
    done.insert(key);
  }
  return set;
}

template <int WPT>
int launch_wavefront_reg(const uint8_t* occ, const uint8_t* seed,
                         const int* grids, int* dist, int B, int H, int W,
                         int max_words, cudaStream_t stream) {
  const int err = allow_smem(wavefront_reg_kernel<WPT>);
  if (err != 0) return err;
  const int smem = max_words * 8 + 64 * (max_words | 1);
  wavefront_reg_kernel<WPT><<<B, kWaveThreads, smem, stream>>>(
      occ, seed, grids, dist, H, W, max_words);
  return (int)cudaGetLastError();
}

// Which kernel a wavefront launch runs, for grids of at most max_words
// bitset words and max_cells cells: 0 wavefront_reg_kernel (at most
// 4 kWaveThreads words: its shared memory holds ~3,080); 1 the earlier
// kernel with the plane's four bitsets in shared memory; 2 the same with
// them in the device-memory scratch.
int wave_plan(int H, int W, int max_words, int max_cells) {
  if (max_cells <= kLevelCells &&
      max_words * 8 + 64 * (max_words | 1) <= kSmemLimit)
    return 0;
  return 16LL * H * ((W + 31) / 32) <= kSmemLimit ? 1 : 2;
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) a launch of these kernels may ask for.
int maze_route_smem_limit(void) { return kSmemLimit; }

// Bytes of the device-memory scratch g_bits that B = 1 grid of a
// `wavefront` launch needs on a plane of H x W whose grids hold at most
// max_words bitset words and max_cells cells: 0 but for plan 2 (see
// wave_plan).
long long wavefront_scratch_bytes(int H, int W, int max_words,
                                  int max_cells) {
  return wave_plan(H, W, max_words, max_cells) == 2
             ? 16LL * H * ((W + 31) / 32) : 0;
}

// The BFS field of B grids.  Plan 0 runs `wavefront_reg_kernel`.  Else the
// four bitsets of the H x W plane, 16 H ceil(W / 32) bytes, sit in shared
// memory (plan 1) or in g_bits, B * 4 * H * ceil(W / 32) words (plan 2);
// g_bits is null but for plan 2.
int wavefront(const uint8_t* occ, const uint8_t* seed, const int* grids,
              int* dist, uint32_t* g_bits, int B, int H, int W,
              int max_words, int max_cells, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int plan = wave_plan(H, W, max_words, max_cells);
  if (plan == 0) {
    const int wpt = (max_words + kWaveThreads - 1) / kWaveThreads;
    if (wpt <= 1)
      return launch_wavefront_reg<1>(occ, seed, grids, dist, B, H, W,
                                     max_words, s);
    if (wpt <= 2)
      return launch_wavefront_reg<2>(occ, seed, grids, dist, B, H, W,
                                     max_words, s);
    return launch_wavefront_reg<4>(occ, seed, grids, dist, B, H, W,
                                   max_words, s);
  }
  if ((plan == 2) != (g_bits != nullptr)) return (int)cudaErrorInvalidValue;
  const int plane_words = H * ((W + 31) / 32);
  const int smem = g_bits ? 0 : plane_words * 16;
  const int err = allow_smem(wavefront_kernel);
  if (err != 0) return err;
  wavefront_kernel<<<B, kThreads, smem, s>>>(occ, seed, grids, dist, H, W,
                                             g_bits, plane_words);
  return (int)cudaGetLastError();
}

int trace_paths(const int* dist, const int* tgts, const uint8_t* tmask,
                const uint8_t* nmask, int* occ, int* routed, int* failed,
                int* wirelen, int B, int T, int H, int W, void* stream) {
  trace_paths_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      dist, tgts, tmask, nmask, occ, routed, failed, wirelen, B, T, H, W);
  return (int)cudaGetLastError();
}

// All S net slots of B grids.  A grid of gh * ceil(gw / 32) <= smem_words
// bitset words keeps its seven bitsets in shared memory, and its counts
// there too when it has at most smem_cells (even) cells; the others keep
// their counts in g_cnt at b * scratch_cells (even) and, beyond
// smem_words, their bitsets in g_bits at b * 7 * scratch_words.
// max_visits is the most masked targets of real slots a grid has; when
// 2 max_visits + 1 >= 2^16, `wide` is set, the counts are uint32, all in
// g_cnt, and smem_cells is 0.  levels may be null.
int route_slots(const int* occ0, const int* hubs, const int* tgts,
                const uint8_t* tmask, const uint8_t* nmask, const int* grids,
                int* occ, int* routed, int* failed, int* wirelen, int* levels,
                void* g_cnt, uint32_t* g_bits, int B, int S, int T, int H,
                int W, int capacity, int max_visits, int wide, int smem_cells,
                int smem_words, long long scratch_cells,
                long long scratch_words, void* stream) {
  const int smem = smem_cells * 2 + smem_words * 28;
  const Nets nets{hubs, tgts, tmask, nmask, S, T, max_visits + 1};
  const Routed out{occ, routed, failed, wirelen, levels};
  auto kernel = wide ? route_slots_kernel<true> : route_slots_kernel<false>;
  const int err = allow_smem(kernel);
  if (err != 0) return err;
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      nets, occ0, grids, out, g_cnt, g_bits, H, W, capacity, smem_cells,
      smem_words, scratch_cells, scratch_words);
  return (int)cudaGetLastError();
}

}  // extern "C"
