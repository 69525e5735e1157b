// NSGA-II non-dominated sort kernels for Hopper (sm_90a), plain C interface.
//
// nds_rank replaces the Pallas kernel `nds_rank_kernel` (body `_rank_kernel`)
// of src/repro/kernels/pareto_dom/kernel.py.  It computes, for each cell of
// a batch, the non-dominated-sort front index of every point of a (P, M)
// objective set (minimisation), P a multiple of 32 (pad with +inf rows).
//
//   Bound on the H100: neither bytes nor arithmetic.  A cell reads
//   P*M*4 bytes and writes P*4 (10 KB at P = 512), and the dominance tests
//   are P*P*M*2 = 2.1 M compares; both are microseconds of the card.  What
//   bounds it is the serial peel: one block-wide barrier per front.
//   Design: one CTA per cell, everything in shared memory.  Each warp lane
//   tests one of 32 dominators against one point and `__ballot_sync` packs
//   the 32 answers into the word "which of dominators 32w..32w+31 dominate
//   point j" (P/32 x P words, 32 KB at P = 512).  Fronts then peel with
//   popcount(word & alive word) and a `__syncthreads_or` on "any left", so
//   nothing returns to the host until every point has its rank.  Above the
//   shared-memory budget the packed words live in a global scratch buffer
//   the wrapper allocates (same kernel, other branch).
//
// dominance_matrix replaces `dominance_matrix_kernel` (body `_kernel`) of the
// same file: D[c, i, j] = all_m(F[i,m] <= F[j,m]) && any_m(F[i,m] < F[j,m]).
//
//   Bound on the H100: bytes.  It writes C*P*P bytes of output against
//   C*P*M*4 bytes read and P*P*M*2 compares (~1 compare per output byte).
//   Design: 64x64 output tiles; the M objectives of the tile's 64 rows and
//   64 columns sit in shared memory, and each thread writes bytes of
//   consecutive j so the stores coalesce.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRankThreads = 512;
constexpr int kTile = 64;
constexpr int kDomThreads = 256;

__global__ void nds_rank_kernel(const float* __restrict__ f,
                                int* __restrict__ ranks,
                                uint32_t* __restrict__ gpacked,
                                int P, int M, int packed_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x;
  const int W = P / 32;
  float* fs = reinterpret_cast<float*>(smem);              // P*M
  int* rank_s = reinterpret_cast<int*>(fs + P * M);        // P
  uint32_t* alive = reinterpret_cast<uint32_t*>(rank_s + P);   // W
  uint32_t* packed = packed_in_smem ? alive + W
                                    : gpacked + (size_t)c * W * P;
  const float* fc = f + (size_t)c * P * M;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;

  for (int i = tid; i < P * M; i += nthr) fs[i] = fc[i];
  for (int j = tid; j < P; j += nthr) rank_s[j] = -1;
  for (int w = tid; w < W; w += nthr) alive[w] = 0xffffffffu;
  __syncthreads();

  // Build: the warp takes (word w, point j); lane k tests dominator 32w+k.
  for (int item = warp; item < W * P; item += nwarps) {
    const int w = item / P, j = item - w * P;
    const float* fi = fs + (32 * w + lane) * M;
    const float* fj = fs + j * M;
    bool le = true, lt = false;
    for (int m = 0; m < M; ++m) {
      le &= fi[m] <= fj[m];
      lt |= fi[m] < fj[m];
    }
    const uint32_t word = __ballot_sync(0xffffffffu, le && lt);
    if (lane == 0) packed[(size_t)w * P + j] = word;
  }
  __syncthreads();

  // Peel: a point whose alive dominators number zero joins this front.
  // Only alive[] (unchanged until the barrier) is read across threads, so
  // a thread may write its own points' ranks in place.
  for (int front = 0; front <= P; ++front) {
    int left = 0;
    for (int j = tid; j < P; j += nthr) {
      if (rank_s[j] >= 0) continue;
      left = 1;
      int indeg = 0;
      for (int w = 0; w < W; ++w)
        indeg += __popc(packed[(size_t)w * P + j] & alive[w]);
      if (indeg == 0) rank_s[j] = front;
    }
    if (!__syncthreads_or(left)) break;
    // P and blockDim are multiples of 32: every warp covers whole words.
    for (int j = tid; j < P; j += nthr) {
      const uint32_t word = __ballot_sync(0xffffffffu, rank_s[j] < 0);
      if (lane == 0) alive[j >> 5] = word;
    }
    __syncthreads();
  }
  for (int j = tid; j < P; j += nthr) ranks[(size_t)c * P + j] = rank_s[j];
}

__global__ void dominance_kernel(const float* __restrict__ f,
                                 uint8_t* __restrict__ out, int P, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* fi = reinterpret_cast<float*>(smem);   // kTile*M, rows i
  float* fj = fi + kTile * M;                   // kTile*M, columns j
  const int c = blockIdx.z;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const float* fc = f + (size_t)c * P * M;
  for (int t = threadIdx.x; t < kTile * M; t += blockDim.x) {
    const int r = t / M;
    fi[t] = i0 + r < P ? fc[(size_t)i0 * M + t] : 0.f;
    fj[t] = j0 + r < P ? fc[(size_t)j0 * M + t] : 0.f;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kTile * kTile; t += blockDim.x) {
    const int r = t / kTile, s = t - r * kTile;
    const int i = i0 + r, j = j0 + s;
    if (i >= P || j >= P) continue;
    bool le = true, lt = false;
    for (int m = 0; m < M; ++m) {
      const float a = fi[r * M + m], b = fj[s * M + m];
      le &= a <= b;
      lt |= a < b;
    }
    out[((size_t)c * P + i) * P + j] = (le && lt) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes nds_rank needs with the packed words in shared
// memory (packed_in_smem = 1) or in global scratch (0).
size_t nds_rank_smem_bytes(int P, int M, int packed_in_smem) {
  const size_t W = P / 32;
  size_t b = (size_t)P * M * 4 + (size_t)P * 4 + W * 4;
  if (packed_in_smem) b += W * (size_t)P * 4;
  return b;
}

int nds_rank(const float* f, int* ranks, uint32_t* scratch, int C, int P,
             int M, int packed_in_smem, void* stream) {
  const size_t smem = nds_rank_smem_bytes(P, M, packed_in_smem);
  cudaFuncSetAttribute(nds_rank_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  nds_rank_kernel<<<C, kRankThreads, smem, (cudaStream_t)stream>>>(
      f, ranks, scratch, P, M, packed_in_smem);
  return (int)cudaGetLastError();
}

int dominance_matrix(const float* f, uint8_t* out, int C, int P, int M,
                     void* stream) {
  const dim3 grid((P + kTile - 1) / kTile, (P + kTile - 1) / kTile, C);
  const size_t smem = 2 * (size_t)kTile * M * 4;
  cudaFuncSetAttribute(dominance_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dominance_kernel<<<grid, kDomThreads, smem, (cudaStream_t)stream>>>(
      f, out, P, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
