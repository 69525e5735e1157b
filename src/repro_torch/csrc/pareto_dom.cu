// NSGA-II kernels for Hopper (sm_90a), plain C interface.
//
// nds_rank replaces the Pallas kernel `nds_rank_kernel` (body `_rank_kernel`)
// of src/repro/kernels/pareto_dom/kernel.py.  It computes, for each cell of
// a batch, the non-dominated-sort front index of every point of a (P, M)
// objective set (minimisation), P a multiple of 32 (pad with +inf rows).
//
//   Bound on the H100: neither bytes nor arithmetic.  A cell reads
//   P*M*4 bytes and writes P*4 (10 KB at P = 512), and the dominance tests
//   are P*P*M*2 = 2.1 M compares; both are microseconds of the card.  What
//   bounds it is one SM's issue of a cell's compares and the serial peel:
//   one block-wide barrier per front.  At the paths' shapes, (8, 96, 4)
//   and (1, 512, 4), the wrapper's host time a call is of the order of
//   the kernel's.
//   Design, P <= kRankRegPoints (`nds_rank_reg_kernel`): one CTA per cell
//   of P threads, thread j for point j.  Thread j packs its P / 32 words
//   "which of points 32w..32w+31 dominate j" into registers (the
//   dominators' loads are broadcasts from shared memory); each front then
//   ORs (word & alive word) over its own registers and the alive words,
//   which are each warp's ballot of its live points, double-buffered in
//   shared memory by front parity, with one `__syncthreads_or` per front
//   (P = 32: the warp's own vote, no barrier).
//   Larger P (`nds_rank_kernel`, `rank_points`, shared with nsga2_evolve):
//   min(P, 1024) threads; thread (w, j) packs word w of point j, the
//   P/32 x P words in shared memory, or above the shared-memory budget in
//   a global scratch buffer the wrapper allocates (same kernel, other
//   branch); fronts peel as above.
//
// nsga2_evolve replaces the rest of the reference's generation loop around
// that kernel (`evolve_from` of src/repro/core/nsga2.py: a `fori_loop` of
// `generation_step_op`, whose rank is `nds_rank_kernel`): every generation
// of an explore dispatch in one launch.  Per cell and generation: binary
// tournament on (rank, crowding), uniform crossover with the mate i - 1,
// random-reset mutation and repair, the estimator objectives of the
// children (Eqs. 2-12), the non-dominated rank of the 2P pool, its crowding
// distance, the first P by (rank asc, crowding desc), and the survivors'
// crowding recomputed.  The random draws of every generation come from
// device memory, made beforehand.
//
//   Bound on the H100: neither bytes nor the card's operation rate.  Per
//   generation a cell does ~2.1 M dominance compares and sorts of at most
//   4 x 512 keys (~1.8e8 operations for 80 generations at P = 256, 2.6 us
//   at the card's rate); its bytes are the draws, 21 P a generation.  But
//   a cell is one CTA on one SM, so that SM's instruction issue and the
//   block barriers set the time: one barrier per front peeled and ~40 more
//   a generation.  Measured at P = 256 (H100 80GB HBM3, 700 W): the
//   pool's dominance tests take half the launch, the sorts a third.
//
//   Design: one persistent CTA of 1024 threads per cell runs all
//   generations, its state in shared memory: two population buffers of 2P
//   points (genes, objectives as float4, ranks, crowding; the survivors of
//   one buffer go to the other), the packed dominance words, 64-bit sort
//   keys and the per-objective distances.  Crowding and selection are
//   stable sorts done as bitonic sorts of unique keys (rank, value as an
//   order-preserving uint32, index): the index in the low bits breaks ties
//   as `lexsort2`'s two stable sorts do, and the four objectives' sorts of
//   crowding run as one.  The stages that pair keys less than 64 apart run
//   in registers, a warp to 64 keys, with shuffles.  A front's fmin and
//   fmax are its first and last sorted entry.  Where they do not fit
//   shared memory, the dominance words (from pop ~480), then the whole
//   state (from pop ~820), live in a device-memory scratch (the same code
//   on generic pointers).
//
//   Exactness: the output must equal the torch composite on the same draws
//   bit for bit, so every float operation of the estimator and of the
//   crowding distance is written as one IEEE operation in torch's order
//   (`__fmul_rn`, `__fadd_rn`, `__fsub_rn`, `__fdiv_rn`: nvcc would contract
//   a*b + c into an FMA); log10 is logf times float32(1/ln 10), powers are
//   double `pow` rounded to float32, as `core/estimator.py` computes them;
//   the order-preserving key maps -0.0 to +0.0, as torch's sorts compare.
//
// dominance_matrix replaces `dominance_matrix_kernel` (body `_kernel`) of the
// same file: D[c, i, j] = all_m(F[i,m] <= F[j,m]) && any_m(F[i,m] < F[j,m]).
//
//   Bound on the H100: bytes.  It writes C*P*P bytes of output against
//   C*P*M*4 bytes read and P*P*M*2 compares (~1 compare per output byte):
//   at the composite loop's (1, 512, 4) 0.08 us, far under a launch, so
//   what it can reach is the launch floor and one round of loads.
//   Design: fill the card and store wide.  A thread owns 16 consecutive
//   columns j, whose M objectives (M a template parameter, 1-8, as
//   nds_rank's) it keeps in registers, and writes 16 output bytes per row
//   as one 16-byte store (bytes where P % 16 != 0 or at the ragged edge); a
//   warp covers 512 columns of a row, and walks as many rows as keep at
//   least two 128-thread CTAs per SM in the grid (one row a warp at P =
//   512: 128 CTAs).  The CTA's column and row objectives are staged in
//   shared memory by coalesced loads: each thread loading its own 16 M
//   floats (lanes 256 bytes apart at M 4) took 5.5 us at (1, 512, 4) on
//   an H100.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

namespace {

constexpr int kRankThreads = 1024;   // nds_rank_kernel: at most
constexpr int kRankRegPoints = 512;  // nds_rank_reg_kernel up to this P
constexpr int kEvolveThreads = 1024;
constexpr int kDomThreads = 128;     // dominance_matrix: 4 warps
constexpr int kDomCols = 32 * 16;    // ... of 32 lanes x 16 columns
constexpr int kDomMaxRows = 32;      // ... each warp walking at most these
constexpr int kMaxM = 8;             // nds_rank's objectives, compile-time
// Dynamic shared memory a block may use: 232,448 B less room for the
// kernels' static shared memory.
constexpr int kSmemLimit = 232448 - 1024;
constexpr int kCalFields = 15;       // see `Cal`
constexpr uint64_t kPadKey = ~0ull;  // sorts after every real key

// Opt a kernel into kSmemLimit bytes of dynamic shared memory once per
// kernel and device, not on every launch (the same value every time, so
// threads that race here set the same thing).  The record is keyed by the
// kernel: the instantiations of one template share a function type.
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

// ---------------------------------------------------------------------------
// Non-dominated sort (shared by nds_rank and nsga2_evolve)
// ---------------------------------------------------------------------------
template <int M>
struct Point {
  float v[M];
};

template <int M>
__device__ __forceinline__ Point<M> load_point(const float* f, int i) {
  Point<M> p;
  if constexpr (M == 4) {
    const float4 q = reinterpret_cast<const float4*>(f)[i];
    p.v[0] = q.x;
    p.v[1] = q.y;
    p.v[2] = q.z;
    p.v[3] = q.w;
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) p.v[m] = f[i * M + m];
  }
  return p;
}

template <int M>
__device__ __forceinline__ bool dominates(const Point<M>& a,
                                          const Point<M>& b) {
  bool le = true, lt = false;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    le &= a.v[m] <= b.v[m];
    lt |= a.v[m] < b.v[m];
  }
  return le && lt;
}

// Front index of points [0, n) of f ((n, M) row-major) into rank[0, n);
// returns the number of fronts.  packed holds ceil(n / 32) rows of
// 32 ceil(n / 32) words, alive 2 ceil(n / 32) words.  The whole block
// calls it, after a barrier that publishes f; it ends with one.
template <int M>
__device__ int rank_points(const float* f, int n, int* rank,
                           uint32_t* packed, uint32_t* alive) {
  const int W = (n + 31) >> 5, nj = W << 5;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31;
  // Build: thread (w, j) packs bit t = "point 32 w + t dominates j".  nj
  // and nthr are multiples of 32, so a warp shares w.
  for (int item = tid; item < W * nj; item += nthr) {
    const int w = item / nj, j = item - w * nj;
    uint32_t word = 0;
    if (j < n) {
      const Point<M> pj = load_point<M>(f, j);
      const int i0 = w << 5, cnt = min(32, n - i0);
#pragma unroll 4
      for (int t = 0; t < cnt; ++t)
        word |= (uint32_t)dominates<M>(load_point<M>(f, i0 + t), pj) << t;
    }
    packed[(size_t)w * nj + j] = word;
  }
  for (int w = tid; w < W; w += nthr) {
    const int left = n - (w << 5);
    alive[w] = left >= 32 ? 0xffffffffu : (1u << left) - 1u;
  }
  for (int j = tid; j < n; j += nthr) rank[j] = -1;
  __syncthreads();
  // Peel: a point none of whose alive dominators is left joins this front.
  // A thread writes only its own points' ranks; front f reads the alive
  // words of parity f and writes those of parity f + 1.
  int front = 0;
  for (;;) {
    const uint32_t* cur = alive + (front & 1) * W;
    uint32_t* nxt = alive + ((front + 1) & 1) * W;
    int left = 0;
    for (int j = tid; j < nj; j += nthr) {
      bool live = j < n && rank[j] < 0;
      if (live) {
        uint32_t hit = 0;
        for (int w = 0; w < W; ++w) hit |= packed[(size_t)w * nj + j] & cur[w];
        if (!hit) {
          rank[j] = front;
          live = false;
        }
      }
      const uint32_t word = __ballot_sync(0xffffffffu, live);
      if (lane == 0) nxt[j >> 5] = word;
      left |= live;
    }
    ++front;
    if (!__syncthreads_or(left)) break;
  }
  return front;
}

// Front index of the P <= KW * 32 points of cell blockIdx.x, one thread a
// point (P threads).  Shared memory: the cell's P x M objectives, then two
// rows of KW alive words.
template <int M, int KW>
__global__ void __launch_bounds__(kRankRegPoints)
nds_rank_reg_kernel(const float* __restrict__ f, int* __restrict__ ranks,
                    int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* fs = reinterpret_cast<float*>(smem);                      // P*M
  uint32_t* alive = reinterpret_cast<uint32_t*>(fs + P * M);       // 2 KW
  const int c = blockIdx.x, j = threadIdx.x, lane = j & 31, W = P >> 5;
  const float* fc = f + (size_t)c * P * M;
  for (int i = j; i < P * M; i += P) fs[i] = fc[i];
  if (j < KW) alive[j] = j < W ? 0xffffffffu : 0u;
  __syncthreads();
  // dom[w] bit t: point 32 w + t dominates j
  const Point<M> pj = load_point<M>(fs, j);
  uint32_t dom[KW];
#pragma unroll
  for (int w = 0; w < KW; ++w) {
    uint32_t word = 0;
    if (w < W) {
#pragma unroll 4
      for (int t = 0; t < 32; ++t)
        word |= (uint32_t)dominates<M>(load_point<M>(fs, (w << 5) + t), pj)
                << t;
    }
    dom[w] = word;
  }
  // Peel: a point none of whose alive dominators is left joins this front.
  int rank = -1;
  if constexpr (KW == 1) {
    uint32_t al = 0xffffffffu;
    for (int front = 0; al; ++front) {
      if (rank < 0 && !(dom[0] & al)) rank = front;
      al = __ballot_sync(0xffffffffu, rank < 0);
    }
  } else {
    for (int front = 0;; ++front) {
      const uint32_t* cur = alive + (front & 1) * KW;
      if (rank < 0) {
        uint32_t hit = 0;
#pragma unroll
        for (int w = 0; w < KW; ++w)
          if (w < W) hit |= dom[w] & cur[w];
        if (!hit) rank = front;
      }
      const uint32_t word = __ballot_sync(0xffffffffu, rank < 0);
      if (lane == 0) alive[((front + 1) & 1) * KW + (j >> 5)] = word;
      if (!__syncthreads_or(rank < 0)) break;
    }
  }
  ranks[(size_t)c * P + j] = rank;
}

template <int M>
__global__ void __launch_bounds__(kRankThreads)
nds_rank_kernel(const float* __restrict__ f, int* __restrict__ ranks,
                uint32_t* __restrict__ gpacked, int P, int packed_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, W = P / 32;
  float* fs = reinterpret_cast<float*>(smem);                   // P*M
  int* rank_s = reinterpret_cast<int*>(fs + P * M);             // P
  uint32_t* alive = reinterpret_cast<uint32_t*>(rank_s + P);    // 2W
  uint32_t* packed = packed_in_smem ? alive + 2 * W
                                    : gpacked + (size_t)c * W * P;
  const float* fc = f + (size_t)c * P * M;
  for (int i = threadIdx.x; i < P * M; i += blockDim.x) fs[i] = fc[i];
  __syncthreads();
  rank_points<M>(fs, P, rank_s, packed, alive);
  for (int j = threadIdx.x; j < P; j += blockDim.x)
    ranks[(size_t)c * P + j] = rank_s[j];
}

// ---------------------------------------------------------------------------
// nsga2_evolve
// ---------------------------------------------------------------------------
// A cell's calibration operands (`estimator.CalOperands`) and its array size.
struct Cal {
  float array_size, inv_pre, adc_off_db, t_com, t_set_per_b, t_conv_bit,
      e_cc_fj, k1_fj, k2_fj, log2_vdd, vdd2, a_sram, a_lc, a_comp, a_dff;
};
static_assert(sizeof(Cal) == kCalFields * sizeof(float), "Cal layout");

// float32(1 / ln 10): estimator._log10 is log(x) times this.
constexpr float kInvLn10 = 0.434294492f;

__device__ __forceinline__ float log10_est(float x) {
  return __fmul_rn(logf(x), kInvLn10);
}

// `estimator.objectives_from_operands` of one design point, in its order of
// operations: (-SNR dB, -TOPS, energy fJ/MAC, area F^2/bit).
__device__ float4 objectives(int gh, int gl, int gb, const Cal& c) {
  const float h = (float)(1 << gh);
  const float w = __fdiv_rn(c.array_size, h);
  const float l = (float)(1 << gl);
  const float b = (float)gb;
  const float n = __fdiv_rn(h, l);
  const float sqnr_y_db = __fsub_rn(__fadd_rn(__fmul_rn(6.0f, b), c.adc_off_db),
                                    __fmul_rn(10.0f, log10_est(n)));
  const float sqnr_y =
      (float)pow(10.0, (double)__fdiv_rn(sqnr_y_db, 10.0f));
  const float q =
      __fdiv_rn(1.0f, __fadd_rn(c.inv_pre, __fdiv_rn(1.0f, sqnr_y)));
  const float snr_db = __fmul_rn(10.0f, log10_est(q));
  const float t_cycle = __fadd_rn(__fadd_rn(c.t_com, __fmul_rn(c.t_set_per_b, b)),
                                  __fmul_rn(c.t_conv_bit, b));
  const float tops =
      __fdiv_rn(__fdiv_rn(__fmul_rn(__fmul_rn(2.0f, n), w), t_cycle), 1e12f);
  const float e_adc =
      __fadd_rn(__fmul_rn(c.k1_fj, __fadd_rn(b, c.log2_vdd)),
                __fmul_rn(__fmul_rn(c.k2_fj, (float)pow(4.0, (double)b)),
                          c.vdd2));
  const float e = __fadd_rn(c.e_cc_fj, __fdiv_rn(e_adc, n));
  const float a = __fadd_rn(
      __fadd_rn(__fadd_rn(c.a_sram, __fdiv_rn(c.a_lc, l)),
                __fdiv_rn(c.a_comp, h)),
      __fdiv_rn(__fmul_rn(b, c.a_dff), h));
  return make_float4(-snr_db, -tops, e, a);
}

// Order-preserving uint32 of a float, -0.0 mapped to +0.0 (torch's sorts
// compare them equal).
__device__ __forceinline__ uint32_t ord_key(float x) {
  uint32_t b = __float_as_uint(x);
  if ((b << 1) == 0) b = 0;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// (rank, value, index): unique keys whose ascending order is lexsort2's.
__device__ __forceinline__ uint64_t sort_key(int rank, uint32_t value,
                                             int index) {
  return ((uint64_t)rank << 48) | ((uint64_t)value << 16) | (uint64_t)index;
}
__device__ __forceinline__ int key_index(uint64_t k) {
  return (int)(k & 0xffffu);
}
__device__ __forceinline__ int key_rank(uint64_t k) { return (int)(k >> 48); }

// One stage (k, j) of a bitonic sort of nk rows of n2 keys in shared
// memory: one compare-exchange per thread.
__device__ __forceinline__ void bitonic_stage(uint64_t* keys, int n2, int nk,
                                              int k, int j) {
  const int half = n2 >> 1, lh = __ffs(half) - 1;
  for (int t = threadIdx.x; t < nk * half; t += blockDim.x) {
    const int row = t >> lh, p = t & (half - 1);
    const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    uint64_t* s = keys + (size_t)row * n2;
    const uint64_t x = s[i], y = s[i + j];
    if ((x > y) == ((i & k) == 0)) {
      s[i] = y;
      s[i + j] = x;
    }
  }
}

// The stages (k, j) of k in [k_lo, k_hi] and j <= 32 in registers: a warp
// holds a run of 64 keys (lane: positions lane and lane + 32), so j = 32
// pairs a thread's two keys and j < 32 a lane with lane ^ j.
__device__ void bitonic_warp_stages(uint64_t* keys, int n2, int nk, int k_lo,
                                    int k_hi) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nk * n2 / 64; r += blockDim.x >> 5) {
    uint64_t* s = keys + (size_t)r * 64;
    const int pa = ((r * 64) & (n2 - 1)) + lane, pb = pa + 32;
    uint64_t a = s[lane], b = s[lane + 32];
    for (int k = k_lo; k <= k_hi; k <<= 1) {
      for (int j = min(k >> 1, 32); j > 0; j >>= 1) {
        if (j == 32) {
          if ((a > b) == ((pa & k) == 0)) {
            const uint64_t t = a;
            a = b;
            b = t;
          }
          continue;
        }
        const uint64_t xa = __shfl_xor_sync(0xffffffffu, a, j);
        const uint64_t xb = __shfl_xor_sync(0xffffffffu, b, j);
        // the lower position of a pair keeps the min when ascending
        const bool mina = ((pa & j) == 0) == ((pa & k) == 0);
        const bool minb = ((pb & j) == 0) == ((pb & k) == 0);
        a = mina ? (xa < a ? xa : a) : (xa > a ? xa : a);
        b = minb ? (xb < b ? xb : b) : (xb > b ? xb : b);
      }
    }
    s[lane] = a;
    s[lane + 32] = b;
  }
}

// Sorts nk rows of n2 keys (n2 a power of two) ascending, in place.  The
// stages with j < 64 run in registers (one barrier per run of them), the
// others one compare-exchange per thread and one barrier per stage: 10
// barriers at n2 = 512 instead of 45.
__device__ void bitonic_sort(uint64_t* keys, int n2, int nk) {
  if (n2 < 64) {
    for (int k = 2; k <= n2; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        bitonic_stage(keys, n2, nk, k, j);
        __syncthreads();
      }
    return;
  }
  bitonic_warp_stages(keys, n2, nk, 2, 64);
  __syncthreads();
  for (int k = 128; k <= n2; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      bitonic_stage(keys, n2, nk, k, j);
      __syncthreads();
    }
    bitonic_warp_stages(keys, n2, nk, k, k);
    __syncthreads();
  }
}

// The state of one cell's CTA: two population buffers of N >= 2P points,
// then the sort keys (4 rows of N2), distances (4 rows of N), front bounds,
// tournament winners and alive words.  Offsets in bytes.
struct Layout {
  int N, N2, NP2;
  size_t buf, keys, dist, fstart, fend, win, alive, total;
};

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__host__ __device__ inline Layout layout(int P) {
  Layout L;
  L.N = (2 * P + 31) / 32 * 32;
  L.N2 = next_pow2(2 * P);
  L.NP2 = next_pow2(P);
  // a buffer: float4 objectives, then genes (3), rank, crowding
  L.buf = (size_t)L.N * (16 + 3 * 4 + 4 + 4);
  L.keys = 2 * L.buf;
  L.dist = L.keys + (size_t)4 * L.N2 * 8;
  L.fstart = L.dist + (size_t)4 * L.N * 4;
  L.fend = L.fstart + (size_t)L.N * 4;
  L.win = L.fend + (size_t)L.N * 4;
  L.alive = L.win + (size_t)L.N * 4;
  L.total = (L.alive + (size_t)2 * (L.N / 32) * 4 + 15) / 16 * 16;
  return L;
}

__host__ __device__ inline size_t packed_bytes(int P) {
  const size_t N = (2 * P + 31) / 32 * 32;
  return (N / 32) * N * 4;
}

struct Pop {
  float4* f;
  int *g0, *g1, *g2, *rank;
  float* crowd;
};

__device__ __forceinline__ Pop pop_at(unsigned char* base, const Layout& L,
                                      int par) {
  unsigned char* b = base + par * L.buf;
  Pop p;
  p.f = reinterpret_cast<float4*>(b);
  p.g0 = reinterpret_cast<int*>(b + (size_t)L.N * 16);
  p.g1 = p.g0 + L.N;
  p.g2 = p.g1 + L.N;
  p.rank = p.g2 + L.N;
  p.crowd = reinterpret_cast<float*>(p.rank + L.N);
  return p;
}

struct EvolveArgs {
  const int* genes0;      // (C, P, 3)
  const float* objs0;     // (C, P, 4)
  const int* pairs;       // (G, C, P, 2) tournament contestants
  const uint8_t* flags;   // (G, C, P): bit k take the mate's gene k, 3 + k mutate it
  const float* u;         // (G, C, P, 3) mutation values
  const float* cal;       // (C, kCalFields), `Cal`
  const int* bounds;      // (C, 6): gene_lo, gene_hi
  int* genes;             // (C, P, 3) out
  float* objs;            // (C, P, 4) out
  int* ranks;             // (C, P) out
  int* fronts;            // (C,) out, or null
  unsigned char* g_state;  // C x layout(P).total bytes, or null
  uint32_t* g_packed;      // C x packed_bytes(P), or null
  int C, P, G, state_in_smem, packed_in_smem;
};

// NSGA-II crowding distance of points [0, n) of pop (`pareto.crowding_
// distance`): per objective, the points in (rank, value, index) order; a
// front's first and last get 1e30, the others (next - prev) / span, span =
// max(fmax - fmin, 1e-12); the four distances summed in objective order.
__device__ void crowding(const Pop& pop, int n, int n2, uint64_t* keys,
                         float* dist, int* fstart, int* fend) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const float* f = reinterpret_cast<const float*>(pop.f);
  const int lg = __ffs(n2) - 1;
  for (int t = tid; t < 4 * n2; t += nthr) {
    const int k = t >> lg, i = t & (n2 - 1);
    keys[t] = i < n ? sort_key(pop.rank[i], ord_key(f[i * 4 + k]), i)
                    : kPadKey;
  }
  __syncthreads();
  bitonic_sort(keys, n2, 4);
  // Fronts are contiguous, at the same places in every objective's order.
  for (int s = tid; s < n; s += nthr) {
    const int r = key_rank(keys[s]);
    if (s == 0 || key_rank(keys[s - 1]) != r) fstart[r] = s;
    if (s == n - 1 || key_rank(keys[s + 1]) != r) fend[r] = s;
  }
  __syncthreads();
  for (int t = tid; t < 4 * n; t += nthr) {
    const int k = t / n, s = t - k * n;
    const uint64_t* row = keys + (size_t)k * n2;
    const int r = key_rank(row[s]), lo = fstart[r], hi = fend[r];
    float d = 1e30f;
    if (s != lo && s != hi) {
      const float fmin = f[key_index(row[lo]) * 4 + k];
      const float fmax = f[key_index(row[hi]) * 4 + k];
      float span = __fsub_rn(fmax, fmin);
      span = span < 1e-12f ? 1e-12f : span;
      const float prev = f[key_index(row[s - 1]) * 4 + k];
      const float next = f[key_index(row[s + 1]) * 4 + k];
      d = __fdiv_rn(__fsub_rn(next, prev), span);
    }
    dist[k * n + key_index(row[s])] = d;
  }
  __syncthreads();
  for (int i = tid; i < n; i += nthr)
    pop.crowd[i] = __fadd_rn(
        __fadd_rn(__fadd_rn(dist[i], dist[n + i]), dist[2 * n + i]),
        dist[3 * n + i]);
  __syncthreads();
}

__global__ void __launch_bounds__(kEvolveThreads, 1)
nsga2_evolve_kernel(EvolveArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Cal cal;
  __shared__ int lo[3], hi[3];
  const int c = blockIdx.x, P = a.P, tid = threadIdx.x, nthr = blockDim.x;
  const Layout L = layout(P);
  unsigned char* base =
      a.state_in_smem ? smem : a.g_state + (size_t)c * L.total;
  uint32_t* packed =
      a.packed_in_smem
          ? reinterpret_cast<uint32_t*>(smem + L.total)
          : a.g_packed + (size_t)c * (packed_bytes(P) / 4);
  uint64_t* keys = reinterpret_cast<uint64_t*>(base + L.keys);
  float* dist = reinterpret_cast<float*>(base + L.dist);
  int* fstart = reinterpret_cast<int*>(base + L.fstart);
  int* fend = reinterpret_cast<int*>(base + L.fend);
  int* win = reinterpret_cast<int*>(base + L.win);
  uint32_t* alive = reinterpret_cast<uint32_t*>(base + L.alive);

  if (tid < kCalFields)
    reinterpret_cast<float*>(&cal)[tid] = a.cal[c * kCalFields + tid];
  if (tid < 3) {
    lo[tid] = a.bounds[c * 6 + tid];
    hi[tid] = a.bounds[c * 6 + 3 + tid];
  }
  // The initial population: its ranks and crowding.
  const Pop init = pop_at(base, L, 0);
  for (int i = tid; i < P; i += nthr) {
    const int* g = a.genes0 + ((size_t)c * P + i) * 3;
    init.g0[i] = g[0];
    init.g1[i] = g[1];
    init.g2[i] = g[2];
    init.f[i] = reinterpret_cast<const float4*>(a.objs0)[(size_t)c * P + i];
  }
  __syncthreads();
  int fronts = rank_points<4>(reinterpret_cast<const float*>(init.f), P,
                              init.rank, packed, alive);
  crowding(init, P, L.NP2, keys, dist, fstart, fend);

  int par = 0;
  for (int gen = 0; gen < a.G; ++gen) {
    const Pop cur = pop_at(base, L, par), nxt = pop_at(base, L, par ^ 1);
    const size_t d0 = ((size_t)gen * a.C + c) * P;
    // Binary tournament on (rank asc, crowding desc).
    for (int i = tid; i < P; i += nthr) {
      const int x = a.pairs[(d0 + i) * 2], y = a.pairs[(d0 + i) * 2 + 1];
      const int rx = cur.rank[x], ry = cur.rank[y];
      const bool x_better =
          rx < ry || (rx == ry && cur.crowd[x] > cur.crowd[y]);
      win[i] = x_better ? x : y;
    }
    __syncthreads();
    // Children into [P, 2P): crossover with the mate (winner i - 1),
    // mutation, repair (Eq. 12), objectives.
    for (int i = tid; i < P; i += nthr) {
      const int pa = win[i], ma = win[i == 0 ? P - 1 : i - 1];
      const uint32_t fl = a.flags[d0 + i];
      const float* u = a.u + (d0 + i) * 3;
      int g[3];
      const int* pg[3] = {cur.g0, cur.g1, cur.g2};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g[k] = pg[k][(fl >> k) & 1u ? ma : pa];
        if ((fl >> (3 + k)) & 1u)
          g[k] = lo[k] + (int)__fmul_rn(u[k], (float)(hi[k] - lo[k] + 1));
      }
      const int h = min(max(g[0], lo[0]), hi[0]);
      const int l = min(max(g[1], lo[1]), min(hi[1], h - lo[2]));
      const int b = min(max(g[2], lo[2]), min(hi[2], h - l));
      cur.g0[P + i] = h;
      cur.g1[P + i] = l;
      cur.g2[P + i] = b;
      cur.f[P + i] = objectives(h, l, b, cal);
    }
    __syncthreads();
    // Environmental selection on the 2P pool.
    fronts += rank_points<4>(reinterpret_cast<const float*>(cur.f), 2 * P,
                             cur.rank, packed, alive);
    crowding(cur, 2 * P, L.N2, keys, dist, fstart, fend);
    for (int t = tid; t < L.N2; t += nthr)
      keys[t] = t < 2 * P
                    ? sort_key(cur.rank[t], ord_key(-cur.crowd[t]), t)
                    : kPadKey;
    __syncthreads();
    bitonic_sort(keys, L.N2, 1);
    for (int s = tid; s < P; s += nthr) {
      const int i = key_index(keys[s]);
      nxt.f[s] = cur.f[i];
      nxt.g0[s] = cur.g0[i];
      nxt.g1[s] = cur.g1[i];
      nxt.g2[s] = cur.g2[i];
      nxt.rank[s] = cur.rank[i];
    }
    __syncthreads();
    // The survivors keep their ranks; their crowding is recomputed (the
    // last generation's is not needed).
    if (gen + 1 < a.G) crowding(nxt, P, L.NP2, keys, dist, fstart, fend);
    par ^= 1;
  }
  const Pop out = pop_at(base, L, par);
  for (int i = tid; i < P; i += nthr) {
    const size_t o = (size_t)c * P + i;
    a.genes[o * 3] = out.g0[i];
    a.genes[o * 3 + 1] = out.g1[i];
    a.genes[o * 3 + 2] = out.g2[i];
    reinterpret_cast<float4*>(a.objs)[o] = out.f[i];
    a.ranks[o] = out.rank[i];
  }
  if (tid == 0 && a.fronts) a.fronts[c] = fronts;
}

// Rows i of one cell against 16 consecutive columns j a thread: the j
// side's objectives sit in registers, a warp spans 512 columns, and each
// warp walks `rows` rows.  The CTA's column and row objectives are staged
// in shared memory by coalesced loads first (a thread's 16 columns are
// 16 M consecutive floats; their rows are padded by one word, so the 32
// lanes read 32 banks).
template <int M>
__global__ void __launch_bounds__(kDomThreads)
dominance_kernel(const float* __restrict__ f, uint8_t* __restrict__ out,
                 int P, int rows) {
  constexpr int kSpan = 16 * M, kStride = kSpan + 1;
  constexpr int kWarps = kDomThreads / 32;
  __shared__ float fs[32 * kStride];             // the CTA's 512 columns
  __shared__ float fr[kWarps * kDomMaxRows * M];  // the CTA's rows
  const int c = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int jc = blockIdx.x * kDomCols, j0 = jc + lane * 16;
  const int ic = blockIdx.y * kWarps * rows;
  const float* fc = f + (size_t)c * P * M;
  for (int e = threadIdx.x; e < 32 * kSpan; e += kDomThreads)
    fs[(e / kSpan) * kStride + e % kSpan] =
        jc * M + e < P * M ? __ldg(fc + (size_t)jc * M + e) : 0.f;
  for (int e = threadIdx.x; e < kWarps * rows * M; e += kDomThreads)
    fr[e] = ic * M + e < P * M ? __ldg(fc + (size_t)ic * M + e) : 0.f;
  __syncthreads();
  float fj[16][M];
#pragma unroll
  for (int q = 0; q < 16; ++q)
#pragma unroll
    for (int m = 0; m < M; ++m) fj[q][m] = fs[lane * kStride + q * M + m];
  const int r0 = warp * rows;
  const int i1 = min(P - ic, r0 + rows);
  const bool vec = P % 16 == 0 && j0 + 16 <= P;   // 16-byte aligned stores
  uint8_t* oc = out + ((size_t)c * P + ic) * P;
  for (int r = r0; r < i1; ++r) {
    uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      bool le = true, lt = false;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float a = fr[r * M + m];
        le &= a <= fj[q][m];
        lt |= a < fj[q][m];
      }
      word[q / 4] |= (uint32_t)(le && lt) << (8 * (q % 4));
    }
    uint8_t* row = oc + (size_t)r * P + j0;
    if (vec) {
      *reinterpret_cast<uint4*>(row) =
          make_uint4(word[0], word[1], word[2], word[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q)
        if (j0 + q < P) row[q] = (uint8_t)((word[q / 4] >> (8 * (q % 4))) & 1u);
    }
  }
}

template <int M>
int launch_dominance(const float* f, uint8_t* out, int C, int P,
                     cudaStream_t stream) {
  // The SM count of the current device (the wrapper makes the tensor's
  // device current), read once per device as allow_smem does.
  static int sms_of[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int sms = dev < 64 ? sms_of[dev] : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
    if (dev < 64) sms_of[dev] = sms;
  }
  // Rows a warp walks: as many as keep >= 2 CTAs an SM in the grid.
  const long long col_tiles = (P + kDomCols - 1) / kDomCols;
  const long long warps = (long long)C * col_tiles * P;
  const long long want = warps / ((kDomThreads / 32) * 2LL * sms) + 1;
  const int rows = want < kDomMaxRows ? (int)want : kDomMaxRows;
  const int row_tiles = (P + rows * (kDomThreads / 32) - 1)
                        / (rows * (kDomThreads / 32));
  const dim3 grid((unsigned)col_tiles, (unsigned)row_tiles, C);
  dominance_kernel<M><<<grid, kDomThreads, 0, stream>>>(f, out, P, rows);
  return (int)cudaGetLastError();
}

template <int M, int KW>
int launch_nds_rank_reg(const float* f, int* ranks, int C, int P,
                        size_t smem, cudaStream_t stream) {
  const int err = allow_smem(nds_rank_reg_kernel<M, KW>);
  if (err != 0) return err;
  nds_rank_reg_kernel<M, KW><<<C, P, smem, stream>>>(f, ranks, P);
  return (int)cudaGetLastError();
}

template <int M>
int launch_nds_rank(const float* f, int* ranks, uint32_t* scratch, int C,
                    int P, int packed_in_smem, size_t smem,
                    cudaStream_t stream) {
  if (P <= kRankRegPoints) {
    const int w = P / 32;
    if (w <= 1) return launch_nds_rank_reg<M, 1>(f, ranks, C, P, smem, stream);
    if (w <= 2) return launch_nds_rank_reg<M, 2>(f, ranks, C, P, smem, stream);
    if (w <= 4) return launch_nds_rank_reg<M, 4>(f, ranks, C, P, smem, stream);
    if (w <= 8) return launch_nds_rank_reg<M, 8>(f, ranks, C, P, smem, stream);
    return launch_nds_rank_reg<M, 16>(f, ranks, C, P, smem, stream);
  }
  const int err = allow_smem(nds_rank_kernel<M>);
  if (err != 0) return err;
  nds_rank_kernel<M><<<C, P < kRankThreads ? P : kRankThreads, smem,
                       stream>>>(f, ranks, scratch, P, packed_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) a launch of these kernels may ask for.
int pareto_dom_smem_limit(void) { return kSmemLimit; }

// Shared-memory bytes nds_rank needs with the packed words in shared
// memory (packed_in_smem = 1) or in global scratch (0).  Up to
// kRankRegPoints points the words are in registers, and both are the
// same.
size_t nds_rank_smem_bytes(int P, int M, int packed_in_smem) {
  const size_t W = P / 32;
  if (P <= kRankRegPoints) return (size_t)P * M * 4 + 2 * 16 * 4;
  size_t b = (size_t)P * M * 4 + (size_t)P * 4 + 2 * W * 4;
  if (packed_in_smem) b += W * (size_t)P * 4;
  return b;
}

// M in [1, kMaxM]; P a multiple of 32 (scratch unused up to
// kRankRegPoints).
int nds_rank(const float* f, int* ranks, uint32_t* scratch, int C, int P,
             int M, int packed_in_smem, void* stream) {
  const size_t smem = nds_rank_smem_bytes(P, M, packed_in_smem);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (M) {
    case 1: return launch_nds_rank<1>(f, ranks, scratch, C, P, packed_in_smem, smem, s);
    case 2: return launch_nds_rank<2>(f, ranks, scratch, C, P, packed_in_smem, smem, s);
    case 3: return launch_nds_rank<3>(f, ranks, scratch, C, P, packed_in_smem, smem, s);
    case 4: return launch_nds_rank<4>(f, ranks, scratch, C, P, packed_in_smem, smem, s);
    case 5: return launch_nds_rank<5>(f, ranks, scratch, C, P, packed_in_smem, smem, s);
    case 6: return launch_nds_rank<6>(f, ranks, scratch, C, P, packed_in_smem, smem, s);
    case 7: return launch_nds_rank<7>(f, ranks, scratch, C, P, packed_in_smem, smem, s);
    case kMaxM: return launch_nds_rank<kMaxM>(f, ranks, scratch, C, P, packed_in_smem, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Bytes of one cell's nsga2_evolve state (part 0) and dominance words
// (part 1) at population P.
size_t nsga2_evolve_bytes(int P, int part) {
  return part == 0 ? layout(P).total : packed_bytes(P);
}

// Every generation of C cells at population P, G generations (see
// `EvolveArgs`).  The state sits in shared memory when state_in_smem, else
// in g_state; the dominance words in shared memory when packed_in_smem
// (which needs state_in_smem), else in g_packed.
int nsga2_evolve(const int* genes0, const float* objs0, const int* pairs,
                 const uint8_t* flags, const float* u, const float* cal,
                 const int* bounds, int* genes, float* objs, int* ranks,
                 int* fronts, void* g_state, uint32_t* g_packed, int C,
                 int P, int G, int state_in_smem, int packed_in_smem,
                 void* stream) {
  const size_t smem = (state_in_smem ? layout(P).total : 0)
                    + (packed_in_smem ? packed_bytes(P) : 0);
  allow_smem(nsga2_evolve_kernel);
  const EvolveArgs a{genes0, objs0, pairs, flags, u, cal, bounds, genes,
                     objs, ranks, fronts,
                     static_cast<unsigned char*>(g_state), g_packed, C, P,
                     G, state_in_smem, packed_in_smem};
  nsga2_evolve_kernel<<<C, kEvolveThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// M in [1, kMaxM].
int dominance_matrix(const float* f, uint8_t* out, int C, int P, int M,
                     void* stream) {
  if (C == 0 || P == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (M) {
    case 1: return launch_dominance<1>(f, out, C, P, s);
    case 2: return launch_dominance<2>(f, out, C, P, s);
    case 3: return launch_dominance<3>(f, out, C, P, s);
    case 4: return launch_dominance<4>(f, out, C, P, s);
    case 5: return launch_dominance<5>(f, out, C, P, s);
    case 6: return launch_dominance<6>(f, out, C, P, s);
    case 7: return launch_dominance<7>(f, out, C, P, s);
    case kMaxM: return launch_dominance<kMaxM>(f, out, C, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
