// Lee maze-router kernels for Hopper (sm_90a), plain C interface.
//
// wavefront replaces the Pallas kernel `wavefront_kernel` (body `_kernel`,
// `_shift`) of src/repro/kernels/maze_route/kernel.py: for each of B grids
// the BFS distance field from the seed cells, dist = 0 on seeds (even when
// occupied), dist <- min(dist, 1 + min(4 neighbours)) on free cells until
// nothing changes, INF = 2^29 where unreachable or blocked.
//
//   Bound on the H100: bytes of the output plane.  The router pads every
//   grid of a batch to the largest extent on each axis (86 grids of at
//   most 33,428 real cells padded to 1118 x 274 = 306,332 cells for the
//   16 kb front).  The function needs occ and seed of the real cells only
//   (~1.2 M cells, 2 B each) but writes the whole int32 plane, ~105 MB
//   per call: ~108 MB in all, ~32 us at 3.35 TB/s.  The relaxation itself
//   is sequential in the path length: one block-wide barrier per sweep.
//   Design: one CTA per grid.  Given each grid's own (gh, gw) the kernel
//   touches only the real cells for the relaxation; the field lives in
//   shared memory when gh*gw int32 fit (both 4096 and 16384 grids, up to
//   134 KB) and is relaxed in place there (chaotic relaxation: any value
//   read is an upper bound of a path length, so in-place updates reach the
//   same unique fixed point as Jacobi sweeps, in fewer sweeps).  A sweep in
//   which no thread lowered a cell ends the loop (`__syncthreads_or`).  A
//   grid too large for shared memory (the 65536 array, 122 x 1090) runs the
//   same loop on the output plane in global memory.  The pad cells beyond
//   (gh, gw) are written INF once.  Blocked cells hold INF + 1 during the
//   relaxation so one int32 plane carries both the field and the mask.
//
// trace_paths has no Pallas counterpart: it is the jnp `_dir_field`,
// `_trace_one` and the occupancy commit of `_route_step` in
// src/repro/eda/batched_flow.py, which the reference hides under `jit`.
// One thread per (grid, star target) lane walks the field from the target
// back to the hub, stepping to the first NEIGHBORS cell (down, up, right,
// left) at distance d-1; a blocked target is entered at +1 from its first
// neighbour at d-1.  When every masked target of a grid is reachable (ok),
// the walk's cells are added to the int32 occupancy with atomicAdd and the
// routed / wirelength counters grow; otherwise the failed counter does.
//
//   Bound on the H100: latency of the walk, a dependent chain of one load
//   per step (a few hundred steps); the bytes are the visited cells only.
//   Design: the whole slot is one launch, so the per-step work that eager
//   PyTorch would spend ~6 launches on stays on the device.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kBlocked = kInf + 1;
constexpr int kWaveThreads = 1024;
constexpr int kTraceThreads = 128;
// NEIGHBORS order of the backtrace tie-break: down, up, right, left.
__constant__ int kDy[4] = {1, -1, 0, 0};
__constant__ int kDx[4] = {0, 0, 1, -1};

__global__ void __launch_bounds__(kWaveThreads)
wavefront_kernel(const uint8_t* __restrict__ occ,
                 const uint8_t* __restrict__ seed,
                 const int* __restrict__ grids, int* __restrict__ dist,
                 int H, int W, int smem_cells) {
  extern __shared__ int sfield[];
  const int b = blockIdx.x;
  const int gh = grids ? min(grids[2 * b], H) : H;
  const int gw = grids ? min(grids[2 * b + 1], W) : W;
  const int n = gh * gw;
  const size_t base = (size_t)b * H * W;
  const uint8_t* ob = occ + base;
  const uint8_t* sb = seed + base;
  int* db = dist + base;
  const bool in_smem = n <= smem_cells;
  int* d = in_smem ? sfield : db;     // the field being relaxed
  const int ld = in_smem ? gw : W;    // its row stride
  const int tid = threadIdx.x, nthr = blockDim.x;

  // Pad cells beyond the grid's own extent: never relaxed, INF.
  if (gh < H || gw < W) {
    for (int k = tid; k < H * W; k += nthr) {
      const int y = k / W, x = k - y * W;
      if (y >= gh || x >= gw) db[k] = kInf;
    }
  }
  for (int k = tid; k < n; k += nthr) {
    const int y = k / gw, x = k - y * gw;
    const int g = y * W + x;
    d[y * ld + x] = sb[g] ? 0 : (ob[g] ? kBlocked : kInf);
  }
  __syncthreads();

  for (;;) {
    int changed = 0;
    for (int k = tid; k < n; k += nthr) {
      const int y = k / gw, x = k - y * gw;
      int* c = d + y * ld + x;
      const int v = *c;
      if (v >= kBlocked || v == 0) continue;
      int best = kBlocked;
      if (y + 1 < gh) best = min(best, c[ld]);
      if (y > 0) best = min(best, c[-ld]);
      if (x + 1 < gw) best = min(best, c[1]);
      if (x > 0) best = min(best, c[-1]);
      if (best + 1 < v) {
        *c = best + 1;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }

  for (int k = tid; k < n; k += nthr) {
    const int y = k / gw, x = k - y * gw;
    db[y * W + x] = min(d[y * ld + x], kInf);
  }
}

__global__ void trace_paths_kernel(const int* __restrict__ dist,
                                   const int* __restrict__ tgts,
                                   const uint8_t* __restrict__ tmask,
                                   const uint8_t* __restrict__ nmask,
                                   int* __restrict__ occ,
                                   int* __restrict__ routed,
                                   int* __restrict__ failed,
                                   int* __restrict__ wirelen,
                                   int B, int T, int H, int W) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B * T) return;
  const int b = lane / T, t = lane - b * T;
  const int* db = dist + (size_t)b * H * W;
  int* ob = occ + (size_t)b * H * W;
  const bool real = nmask[b] != 0;

  // d0 of every target of this grid: its field value, or for a blocked
  // target one more than its best neighbour.
  bool ok = real;
  int wl = 0, my_d0 = kInf, my_dv = kInf, my_nd[4] = {kInf, kInf, kInf, kInf};
  for (int tt = 0; tt < T; ++tt) {
    if (!tmask[b * T + tt]) continue;
    const int ty = tgts[(b * T + tt) * 2], tx = tgts[(b * T + tt) * 2 + 1];
    const int dv = db[ty * W + tx];
    int nd[4], best = kInf;
    for (int k = 0; k < 4; ++k) {
      const int ny = ty + kDy[k], nx = tx + kDx[k];
      nd[k] = (ny >= 0 && ny < H && nx >= 0 && nx < W) ? db[ny * W + nx]
                                                       : kInf;
      best = min(best, nd[k]);
    }
    const int d0 = dv < kInf ? dv : min(kInf, best + 1);
    ok = ok && d0 < kInf;
    wl += d0 + 1;
    if (tt == t) {
      my_d0 = d0;
      my_dv = dv;
      for (int k = 0; k < 4; ++k) my_nd[k] = nd[k];
    }
  }
  if (t == 0) {
    routed[b] += ok ? 1 : 0;
    failed[b] += (real && !ok) ? 1 : 0;
    wirelen[b] += ok ? wl : 0;
  }
  if (!ok || !tmask[b * T + t]) return;

  int y = tgts[lane * 2], x = tgts[lane * 2 + 1], d = my_d0;
  atomicAdd(ob + y * W + x, 1);
  if (my_dv >= kInf) {  // blocked target: enter from its first d-1 neighbour
    int k = 0;
    while (k < 3 && my_nd[k] != my_d0 - 1) ++k;
    y += kDy[k];
    x += kDx[k];
    atomicAdd(ob + y * W + x, 1);
    d = my_d0 - 1;
  }
  while (d > 0) {
    int k = 0;
    for (; k < 4; ++k) {
      const int ny = y + kDy[k], nx = x + kDx[k];
      if (ny >= 0 && ny < H && nx >= 0 && nx < W && db[ny * W + nx] == d - 1)
        break;
    }
    if (k == 4) break;  // unreachable: BFS fields always hold the chain
    y += kDy[k];
    x += kDx[k];
    atomicAdd(ob + y * W + x, 1);
    --d;
  }
}

}  // namespace

extern "C" {

// Largest grid (cells) whose int32 field fits the shared memory of a block.
int wavefront_smem_cells(void) { return 232448 / 4; }

int wavefront(const uint8_t* occ, const uint8_t* seed, const int* grids,
              int* dist, int B, int H, int W, int smem_cells, void* stream) {
  const size_t smem = (size_t)smem_cells * 4;
  cudaFuncSetAttribute(wavefront_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  wavefront_kernel<<<B, kWaveThreads, smem, (cudaStream_t)stream>>>(
      occ, seed, grids, dist, H, W, smem_cells);
  return (int)cudaGetLastError();
}

int trace_paths(const int* dist, const int* tgts, const uint8_t* tmask,
                const uint8_t* nmask, int* occ, int* routed, int* failed,
                int* wirelen, int B, int T, int H, int W, void* stream) {
  const int lanes = B * T;
  const int blocks = (lanes + kTraceThreads - 1) / kTraceThreads;
  trace_paths_kernel<<<blocks, kTraceThreads, 0, (cudaStream_t)stream>>>(
      dist, tgts, tmask, nmask, occ, routed, failed, wirelen, B, T, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
