// Bit-serial QR ACIM matmul with the SAR ADC in the loop, for Hopper
// (sm_90a), plain C interface.
//
// acim_matmul replaces the Pallas kernel `acim_matmul_kernel` (body
// `_kernel`, ADC `_adc`) of src/repro/kernels/acim_matmul/kernel.py.  For
// x (M, K) and w (K, C), K a multiple of the macro's chunk size N (the
// wrapper zero-pads, as `_pad_k` does), it computes
//
//   y[m, c] = sum over chunks j of ADC(s_j),  s_j = sum_{k in chunk j} x[m,k] w[k,c]
//   ADC(s)  = clip(rint(s / delta), -2^(B-1), 2^(B-1) - 1) * delta,  delta = 2N / 2^B
//
// which is what one column of the macro does: each conversion digitizes
// the charge of N products, and conversions accumulate digitally.
//
//   Bound on the H100: operations.  The work is 2*M*K*C float32 operations
//   (one FFMA per product) against (M*K + K*C + M*C)*4 bytes: at the LM
//   trainer's FFN shapes, 1024 x 768 x 3072, that is 4.83 GFLOP, 0.072 ms at
//   67 TFLOP/s, against ~25 MB, 0.0075 ms at 3.35 TB/s.  The ADC adds ~5
//   operations per output per chunk (N >= 64 products per chunk here).
//
//   Exactness: the partial sum s must be exact float32 FFMA.  TF32 tensor
//   cores (`mma` / `wgmma`) would round the operands, and with
//   mismatch-folded weights (not +-1) that moves ADC decisions; so this
//   kernel uses CUDA cores only.  Every ADC output is an integer multiple
//   of delta, so the sum across chunks is exact in any order; only the
//   order inside a chunk can differ from the plain version.  With +-1
//   operands s is a small integer, exact in any order, and the kernel is
//   bit-equal to the plain version.  Rounding is half to even (`rintf`, as
//   `jnp.round` / `torch.round`); ties are common with +-1 operands (at
//   N = 128, B = 5, every s = 4 mod 8 is one).  The division is IEEE (no
//   fast math), as the reference's `s / delta`.
//
//   Design: a classic register-tiled SGEMM on CUDA cores.  One CTA of 256
//   threads per 64 x 64 output tile, a 4 x 4 micro-tile per thread; K
//   streams through shared memory in 16-deep tiles (x staged k-major, so
//   each thread reads its 4 rows and 4 columns as two float4 loads per k).
//   Each thread keeps two 4 x 4 register sets: the running chunk sum s and
//   the digital accumulator acc.  A block-uniform counter of products left
//   in the chunk fires the ADC on s exactly where the running k index
//   crosses a multiple of N, so N may be smaller than the k-tile or many
//   k-tiles long, and need not be a power of two.  Ragged M and C edges
//   are masked on load (zeros) and on store.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBM = 64;             // output rows per CTA
constexpr int kBN = 64;             // output columns per CTA
constexpr int kBK = 16;             // k per shared-memory stage
constexpr int kTM = 4;              // rows per thread
constexpr int kTN = 4;              // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256
constexpr int kPad = 4;             // x-tile row pad: fewer store conflicts,
                                    // rows stay 16-byte aligned

__global__ void __launch_bounds__(kThreads)
acim_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, int M, int K, int C, int N,
                   float delta, float code_lo, float code_hi) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];   // x tile, k-major
  __shared__ __align__(16) float ws[kBK][kBN];          // w tile
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM;
  const int c0 = blockIdx.x * kBN;

  float s[kTM][kTN], acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) s[i][j] = acc[i][j] = 0.f;
  int left = N;   // products still to add before the next conversion

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kBK, kk = idx % kBK;
      const int gm = m0 + r, gk = k0 + kk;
      xs[kk][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int kk = idx / kBN, cc = idx % kBN;
      const int gk = k0 + kk, gc = c0 + cc;
      ws[kk][cc] = (gk < K && gc < C) ? w[(size_t)gk * C + gc] : 0.f;
    }
    __syncthreads();

    const int kmax = min(kBK, K - k0);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      if (kk < kmax) {                        // block-uniform
        const float4 a4 = *reinterpret_cast<const float4*>(&xs[kk][ty * kTM]);
        const float4 b4 = *reinterpret_cast<const float4*>(&ws[kk][tx * kTN]);
        const float a[kTM] = {a4.x, a4.y, a4.z, a4.w};
        const float b[kTN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
        if (--left == 0) {                    // block-uniform: a conversion
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j) {
              float code = rintf(s[i][j] / delta);
              code = fminf(fmaxf(code, code_lo), code_hi);
              acc[i][j] += code * delta;
              s[i][j] = 0.f;
            }
          left = N;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = c0 + tx * kTN + j;
      if (gc < C) y[(size_t)gm * C + gc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x (M, K), w (K, C), y (M, C): float32, row-major, on the device; K a
// multiple of N.  b_adc is the ADC's bits B.
int acim_matmul(const float* x, const float* w, float* y, int M, int K, int C,
                int N, int b_adc, void* stream) {
  const double half_range = (double)(1 << (b_adc - 1));
  const float delta = (float)(2.0 * N / (2.0 * half_range));
  const dim3 grid((C + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  acim_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, w, y, M, K, C, N, delta, (float)(-half_range),
      (float)(half_range - 1.0));
  return (int)cudaGetLastError();
}

}  // extern "C"
