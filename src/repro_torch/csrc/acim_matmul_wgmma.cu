// Bit-serial QR ACIM matmul on Hopper tensor cores (sm_90a), plain C
// interface.
//
// acim_matmul_wgmma replaces, for chunk sizes N that are a multiple of 16,
// the Pallas kernel `acim_matmul_kernel` (body `_kernel`, ADC `_adc`) of
// src/repro/kernels/acim_matmul/kernel.py; other N stay on the CUDA-core
// kernel of acim_matmul.cu.  For x (M, K) and w (K, C) float32, K a
// multiple of N (the wrapper zero-pads), it computes
//
//   y[m, c] = sum over chunks j of ADC(s_j),  s_j = sum_{k in chunk j} x[m,k] w[k,c]
//   ADC(s)  = clip(rint(s / delta), -2^(B-1), 2^(B-1) - 1) * delta,  delta = 2N / 2^B
//
// with rint rounding half to even and an IEEE division, as the plain
// version (`acim_numerics.adc_quantize_sum`) does.
//
//   Exact operands on bf16 tensor cores.  Each float32 operand v is split
//   into three bf16 terms whose sum is v exactly: hi = bf16_rn(v), mid =
//   bf16_rn(v - hi), lo = v - hi - mid (float32 has 24 significant bits,
//   bf16 8; both subtractions are exact).  Every product of two terms is
//   exact in float32, so the sum over the term products is the chunk sum
//   taken in another order, as the plain version's own order differs from
//   the CUDA-core kernel's.  A term whose tile is all zero is skipped,
//   decided per k-tile for the whole CTA: on +-1 activations x's mid and
//   lo vanish and only w's terms run (three passes on mismatch-folded
//   weights, one on +-1 weights).  With +-1 operands every partial sum is
//   an integer <= N, exact in any order, so the result is bit-equal to the
//   plain version.  (Operands under 2^-102 in magnitude would need bf16
//   subnormal terms; the macro's operands lie in [-1, 1] near their grid.)
//
//   Bound on the H100: operations.  Each pass is 2*M*K*C bf16 products:
//   at the trainer's FFN shape 1024 x 768 x 3072 with +-1 x and
//   mismatch-folded w, three passes are 14.5 GFLOP, 0.0147 ms at 989
//   TFLOP/s, against 0.072 ms for one float32 FFMA pass at 67 TFLOP/s (the
//   CUDA-core route's bound) and ~25 MB of operands (0.0075 ms at 3.35
//   TB/s).
//
//   Design.  One CTA of two warpgroups per 128 x 128 output tile (each
//   warpgroup 64 rows), K in 64-deep tiles.  All 256 threads load the next
//   float32 tiles of x and w from device memory into registers (x's and
//   w's loads issued apart, each once its registers are free), split them
//   into the three bf16 terms (a warp whose values are all bf16 values
//   already, as +-1 activations are, only packs their high halves) and
//   store the terms into a double-buffered shared-memory stage in the
//   128-byte swizzled layout `wgmma` reads: x K-major (row m, 64 k per
//   128-byte row), w MN-major (row k, two 64-column blocks), the layouts of
//   flash_attention_wgmma.cu's Q and V tiles.  A warp-reduced OR of "term
//   nonzero" bits, gathered in shared memory, tells every thread which term
//   products to issue.  Per k16 step each warpgroup runs one `wgmma`
//   m64n128k16 per term product, smallest terms first, with both operands
//   in shared memory into its float32 chunk sum s (64 registers a thread).
//   The ADC stays in registers: where the running k crosses a multiple of
//   N (a chunk of one k16 step or of many k-tiles), the warpgroup waits on
//   its `wgmma` group, adds clip(rint(s / delta)) * delta to its digital
//   sum acc (64 more registers; s * 2^-e for delta = 2^e, the same value
//   as the division) and zeroes s.
//
//   Split-K.  The FFN's down projection (1024 x 3072 x 768) has 48 output
//   tiles for 132 SMs, so the wrapper may split K at chunk boundaries
//   across CTAs (grid z).  Each CTA's acc is a sum of integer multiples of
//   delta; with N a power of two delta is one too, so the partial sums and
//   their cross-CTA sum by float32 atomics are exact in any order and the
//   result stays bit-equal.  The wrapper splits only then, and zeroes y
//   first (the atomics add into it).  Measured on an H100 (PERF.md,
//   `tools/time_acim.py`): 2 splits of the down projection (96 CTAs) are
//   fastest, 1.75x one; 3 and more are slower.
//
//   What holds it at ~5x its bound (H100, `clock64` phase stamps in
//   instrumented copies, not kept): the split and stores of the terms and
//   the products do not overlap, and the split takes longer than the
//   products.  Tried and slower or no faster: a producer warpgroup with
//   cp.async staging (the 384-thread launch caps registers at 168, and the
//   consumers spill), cp.async staging into a single term stage, a quarter
//   of the next tile split between each k16 step's products, and each
//   k-tile's products as one branch-free run (spills).
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;            // output rows per CTA: two warpgroups x 64
constexpr int kBN = 128;            // output columns per CTA
constexpr int kBK = 64;             // k per stage
constexpr int kThreads = 256;
constexpr int kTerms = 3;
constexpr uint32_t kTermBytes = kBM * kBK * 2;   // one term tile (x or w)
constexpr uint32_t kWBlock = kBK * 128;          // a 64-column block of w
static_assert(kBM * kBK == kBK * kBN, "x and w term tiles share kTermBytes");

struct __align__(1024) Stage {
  __nv_bfloat16 x[kTerms][kBM * kBK];   // K-major, 128-byte swizzle
  __nv_bfloat16 w[kTerms][kBK * kBN];   // MN-major, two 64-column blocks
};

struct Smem {
  Stage st[2];
  int flags[3];   // per k-tile (mod 3): bit 0 x mid, 1 x lo, 2 w mid, 3 w lo
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1);
// offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x 128 f32) += A (64 x 16, smem, K-major) B (16 x 128, smem,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The three bf16 terms of 8 floats (16 bytes each); `nz` gains bit 0 if
// a mid term is nonzero and bit 1 if a lo term is.
__device__ __forceinline__ void split8(const float4 (&v)[2], uint4& hi,
                                       uint4& mid, uint4& lo, uint32_t& nz) {
  const float f[8] = {v[0].x, v[0].y, v[0].z, v[0].w,
                      v[1].x, v[1].y, v[1].z, v[1].w};
  // Fast path, warp-uniform: every value is a bf16 value already (the
  // low 16 bits clear, as +-1 activations are): hi is the high halves.
  uint32_t u[8], low = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u[i] = __float_as_uint(f[i]);
    low |= u[i];
  }
  if (__all_sync(0xffffffffu, (low & 0xFFFFu) == 0)) {
    hi = make_uint4(__byte_perm(u[0], u[1], 0x7632),
                    __byte_perm(u[2], u[3], 0x7632),
                    __byte_perm(u[4], u[5], 0x7632),
                    __byte_perm(u[6], u[7], 0x7632));
    mid = lo = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  uint32_t h[4], m[4], l[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const __nv_bfloat162 bh = __floats2bfloat162_rn(f[2 * p], f[2 * p + 1]);
    const float2 fh = __bfloat1622float2(bh);
    const float r0 = __fsub_rn(f[2 * p], fh.x);       // exact
    const float r1 = __fsub_rn(f[2 * p + 1], fh.y);
    const __nv_bfloat162 bm = __floats2bfloat162_rn(r0, r1);
    const float2 fm = __bfloat1622float2(bm);
    const __nv_bfloat162 bl =                          // exact
        __floats2bfloat162_rn(__fsub_rn(r0, fm.x), __fsub_rn(r1, fm.y));
    h[p] = bits(bh);
    m[p] = bits(bm);
    l[p] = bits(bl);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  mid = make_uint4(m[0], m[1], m[2], m[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
  nz |= ((m[0] | m[1] | m[2] | m[3]) != 0 ? 1u : 0u) |
        ((l[0] | l[1] | l[2] | l[3]) != 0 ? 2u : 0u);
}

__device__ __forceinline__ float4 ld4(const float* p, bool in) {
  return in ? __ldg(reinterpret_cast<const float4*>(p))
            : make_float4(0.f, 0.f, 0.f, 0.f);
}

struct Tile {
  float4 x[4][2];   // 4 x-tasks: row t / 8, k chunk t % 8 (8 floats)
  float4 w[4][2];   // 4 w-tasks: k row t / 16, column chunk t % 16
};

// The float32 x (kX) or w tile at k0, zeros past M, C and the split's
// end ke.
template <bool kX>
__device__ __forceinline__ void load_tile(Tile& t, const float* x,
                                          const float* w, int M, int K, int C,
                                          int m0, int c0, int k0, int ke) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int task = threadIdx.x + i * kThreads;
    if (kX) {
      const int gm = m0 + task / 8, gk = k0 + (task % 8) * 8;
      const bool in = gm < M && gk < ke;
      const float* p = x + (size_t)gm * K + gk;
      t.x[i][0] = ld4(p, in);
      t.x[i][1] = ld4(p + 4, in);
    } else {
      const int gk = k0 + task / 16, gc = c0 + (task % 16) * 8;
      const float* p = w + (size_t)gk * C + gc;
      t.w[i][0] = ld4(p, gk < ke && gc < C);
      t.w[i][1] = ld4(p + 4, gk < ke && gc + 4 < C);
    }
  }
}

// Split the x (kX) or w tile into its terms in stage `st`; returns this
// thread's nonzero bits (see Smem::flags).
template <bool kX>
__device__ __forceinline__ uint32_t store_terms(Stage& st, const Tile& t) {
  uint32_t nz = 0;
  uint8_t* base = reinterpret_cast<uint8_t*>(kX ? st.x[0] : st.w[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int task = threadIdx.x + i * kThreads;
    uint32_t off;
    if (kX) {
      const int r = task / 8, ch = task % 8;
      off = r * 128 + ((ch ^ (r & 7)) << 4);
    } else {
      const int k = task / 16, ch = task % 16;
      off = (ch / 8) * kWBlock + k * 128 + (((ch % 8) ^ (k & 7)) << 4);
    }
    uint4 h, m, l;
    split8(kX ? t.x[i] : t.w[i], h, m, l, nz);
    *reinterpret_cast<uint4*>(base + off) = h;
    *reinterpret_cast<uint4*>(base + kTermBytes + off) = m;
    *reinterpret_cast<uint4*>(base + 2 * kTermBytes + off) = l;
  }
  return kX ? nz : nz << 2;
}

// One conversion: acc += clip(rint(q)) * delta (exact: a multiple of
// delta), q = s / delta; s = 0.
__device__ __forceinline__ void adc(float& s, float& acc, float q, float delta,
                                   float code_lo, float code_hi) {
  const float code = fminf(fmaxf(rintf(q), code_lo), code_hi);
  acc += code * delta;
  s = 0.f;
}

__global__ void __launch_bounds__(kThreads, 1)
acim_matmul_wgmma_kernel(const float* __restrict__ x,
                         const float* __restrict__ w, float* __restrict__ y,
                         int M, int K, int C, int N, float delta,
                         float inv_delta, float code_lo, float code_hi,
                         int k_split,
                         int atomic) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);
  const int tid = threadIdx.x, cw = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int m0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);
  const int n_kt = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;
  const int chunk_steps = N / 16;

  if (tid < 3) sm.flags[tid] = 0;
  float s[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = acc[i] = 0.f;
  Tile t;
  if (n_kt > 0) {
    load_tile<true>(t, x, w, M, K, C, m0, c0, kb, ke);
    load_tile<false>(t, x, w, M, K, C, m0, c0, kb, ke);
  }
  int left = chunk_steps;   // k16 steps still to add before a conversion

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kb + kt * kBK;
    Stage& st = sm.st[kt & 1];
    wgmma_wait<1>();          // this warpgroup's products of tile kt - 2 done
    __syncthreads();          // ... and every warpgroup's: the stage is free
    if (tid == 0) sm.flags[(kt + 1) % 3] = 0;
    // Each half's loads for tile kt + 1 go out as soon as its registers
    // are free, so the w half's split covers the x loads' latency.
    const bool more = kt + 1 < n_kt;
    uint32_t nz = store_terms<true>(st, t);
    if (more) load_tile<true>(t, x, w, M, K, C, m0, c0, k0 + kBK, ke);
    nz |= store_terms<false>(st, t);
    if (more) load_tile<false>(t, x, w, M, K, C, m0, c0, k0 + kBK, ke);
    nz = __reduce_or_sync(0xffffffffu, nz);
    if (lane == 0 && nz) atomicOr(&sm.flags[kt % 3], (int)nz);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int fl = sm.flags[kt % 3];
    const bool xt[3] = {true, (fl & 1) != 0, (fl & 2) != 0};
    const bool wt[3] = {true, (fl & 4) != 0, (fl & 8) != 0};
    const int steps = min(kBK, ke - k0) / 16;
    const uint32_t xa = smem_u32(st.x) + cw * 64 * 128;
    const uint32_t wa = smem_u32(st.w);

    wgmma_fence();
#pragma unroll 1
    for (int kk = 0; kk < steps; ++kk) {
      // Smallest terms first: each pass adds into s, so the small
      // products gather before the large ones join them.
#pragma unroll
      for (int a = kTerms - 1; a >= 0; --a)
#pragma unroll
        for (int b = kTerms - 1; b >= 0; --b)
          if (xt[a] && wt[b])
            wgmma_m64n128(
                s, sw128_desc(xa + a * kTermBytes + kk * 32, 16, 1024),
                sw128_desc(wa + b * kTermBytes + kk * 2048, kWBlock, 1024));
      if (--left == 0) {    // block-uniform: the chunk is complete
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if (inv_delta != 0.f) {   // delta = 2^e: s * 2^-e is s / delta
#pragma unroll
          for (int i = 0; i < 64; ++i) adc(s[i], acc[i], s[i] * inv_delta,
                                           delta, code_lo, code_hi);
        } else {
#pragma unroll
          for (int i = 0; i < 64; ++i) adc(s[i], acc[i], __fdiv_rn(s[i], delta),
                                           delta, code_lo, code_hi);
        }
        fence_regs(s);
        left = chunk_steps;
        wgmma_fence();
      }
    }
    wgmma_commit();
  }
  wgmma_wait<0>();

  // Accumulator fragment: element 4 j + 2 i + e is (row0 + 8 i, 8 j +
  // col0 + e).
  const int row0 = m0 + cw * 64 + warp * 16 + lane / 4;
  const int col0 = c0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= M) continue;
    float* yr = y + (size_t)r * C;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = col0 + 8 * j;
      if (c >= C) continue;             // C is even: c + 1 < C too
      const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      if (atomic) {
        atomicAdd(yr + c, v0);
        atomicAdd(yr + c + 1, v1);
      } else {
        *reinterpret_cast<float2*>(yr + c) = make_float2(v0, v1);
      }
    }
  }
}

}  // namespace

extern "C" {

// x (M, K), w (K, C), y (M, C): float32, row-major, on the device, 16-byte
// aligned; N % 16 == 0, K % N == 0, C % 4 == 0.  b_adc is the ADC's bits
// B.  K is split into `splits` ranges of whole chunks, one CTA each per
// output tile (1: no split; more only with N a power of two, see above).
int acim_matmul_wgmma(const float* x, const float* w, float* y, int M, int K,
                      int C, int N, int b_adc, int splits, void* stream) {
  if (N < 16 || N % 16 || K % N || C % 4 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int chunks = K / N;
  int per = chunks > 0 ? (chunks + splits - 1) / splits : 0;
  splits = per > 0 ? (chunks + per - 1) / per : 1;
  if (splits > 1) {
    const cudaError_t err = cudaMemsetAsync(y, 0, (size_t)M * C * 4, st);
    if (err != cudaSuccess) return (int)err;
  }
  const double half_range = (double)(1 << (b_adc - 1));
  const float delta = (float)(2.0 * N / (2.0 * half_range));
  const int smem = (int)sizeof(Smem) + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      acim_matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  acim_matmul_wgmma_kernel<<<grid, kThreads, smem, st>>>(
      x, w, y, M, K, C, N, delta, (N & (N - 1)) ? 0.f : 1.f / delta,
      (float)(-half_range),
      (float)(half_range - 1.0), per * N, splits > 1 ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
