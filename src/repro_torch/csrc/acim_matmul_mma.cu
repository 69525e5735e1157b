// Bit-serial QR ACIM matmul at chunk sizes N 2, 4 and 8 on Hopper tensor
// cores (sm_90a, `mma.sync`), plain C interface.
//
// acim_matmul_mma replaces, for N in {2, 4, 8}, the Pallas kernel
// `acim_matmul_kernel` (body `_kernel`, ADC `_adc`) of
// src/repro/kernels/acim_matmul/kernel.py; N a multiple of 16 runs
// acim_matmul_wgmma.cu, any other N acim_matmul.cu.  For x (M, K) and
// w (K, C) float32, K a multiple of N and of 4 and C a multiple of 4 (the
// wrapper zero-pads), it computes
//
//   y[m, c] = sum over chunks j of ADC(s_j),  s_j = sum_{k in chunk j} x[m,k] w[k,c]
//   ADC(s)  = clip(rint(s / delta), -2^(B-1), 2^(B-1) - 1) * delta,  delta = 2N / 2^B
//
// with rint rounding half to even, as the plain version
// (`acim_numerics.adc_quantize_sum`) does.
//
//   Bound on the H100: the ADC.  At N <= 8 a conversion follows every 2-8
//   products, so the M*C*K/N conversions, not the products, set the time:
//   at the trainer's FFN shape 1024 x 768 x 3072 and N 8 that is 302 M
//   conversions.  On CUDA cores (acim_matmul.cu) products and conversions
//   share one pipe; here the products go to the tensor cores and the
//   CUDA cores keep only the conversions.
//
//   Exact operands on bf16 tensor cores.  Each float32 operand v is split
//   into three bf16 terms whose sum is v exactly: hi = bf16_rn(v), mid =
//   bf16_rn(v - hi), lo = v - hi - mid (as in acim_matmul_wgmma.cu).
//   Every product of two terms is exact in float32.  A term whose tile is
//   all zero is skipped, decided per k-tile for the whole CTA: on +-1
//   activations only w's terms run (three passes on mismatch-folded
//   weights, one on +-1 weights).  With +-1 operands every chunk sum is a
//   small integer, exact in any order, so the result is bit-equal to the
//   plain version; otherwise sums differ from it in order only, and an ADC
//   decision can flip where s / delta lies within rounding of a boundary.
//
//   Chunks in the k8 fragment.  In `mma.sync.m16n8k8` lane t = lane % 4
//   holds k = 2t and 2t + 1 of both A and B.  At N 8 one `mma` is one
//   chunk.  At N 4 a k8 step is two chunks, lanes t in {0, 1} and {2, 3}:
//   two `mma`s, each with A's registers zeroed in the other chunk's lanes;
//   at N 2 four, one a lane.  The term products of a chunk chain through
//   C, smallest first, from C = 0, and D is converted at once: no running
//   chunk sum is kept across k steps, only the digital sum.
//
//   The ADC in three instructions.  delta is a power of two for these N,
//   so s / delta * 2^-24 is exact, and one saturating FFMA rounds it
//   half to even: q = sat(s * 2^-24 / delta + 0.75) is 0.75 + rint(s /
//   delta) 2^-24 exactly while |s / delta| < 2^22 (q's ulp is 2^-24 in
//   [0.5, 1)), and saturation holds every other s (and NaN, which goes to
//   0) in [0, 1], where q's bits grow with q.  So the integer is q's bits
//   less 0.75's, and one DPX instruction (`__viaddmin_s32_relu`) takes
//   that difference, adds 2^(B-1) and clamps to [0, 2^B - 1]: the code,
//   clamped, offset to be non-negative, for every float s (q's bits lie
//   in [0, 2^30]: no overflow).  An integer add accumulates it.  The
//   epilogue takes off 2^(B-1) a conversion and multiplies by delta once:
//   the sum of the clamped codes times delta, which is what any order of
//   float32 sums of multiples of delta gives while they stay exact (|sum|
//   < 2^24 delta; the plain version's float sum rounds beyond that).
//   tools/time_acim.py times this against a float32 rint (FFMA, FADD, two
//   clamps, FFMA into a float sum) and the IEEE division and `rintf` of
//   acim_matmul.cu.
//
//   Design.  One CTA of 8 warps per 128 x 64 output tile (a warp 32 x
//   32: 2 x 4 m16n8 tiles, 32 accumulators a thread), K in 32-deep tiles.
//   The float32 tiles of x and w are staged by `cp.async`, double
//   buffered, zero-filled past M, C and the split's end.  Per k-tile every
//   thread splits its share of both tiles into the three bf16 terms (a
//   warp whose values are bf16 values already, as +-1 activations are,
//   only packs their high halves), stores them to shared memory in
//   swizzled layouts `ldmatrix` reads without bank conflicts (x row-major,
//   w row-major read with `.trans`), and ORs "term nonzero" bits into a
//   per-k-tile flag word.  Then each warp runs the k-tile's products and
//   conversions: per k8 step one `ldmatrix.x4` per x term and one
//   `ldmatrix.x4.trans` per w term, then per chunk per m16n8 tile the term
//   `mma`s and four conversions.  Two CTAs fit an SM, so one CTA's split
//   runs under the other's conversions.
//
//   Split-K.  The FFN's down projection (1024 x 3072 x 768) has 96 output
//   tiles for 132 SMs; the wrapper may split K in whole k-tiles across
//   CTAs (grid z; 4 there, `kernel.mma_split_k`).  Each CTA's result is a
//   sum of multiples of the power-of-two delta, so their float32 atomic
//   sum is exact in any order; y is zeroed first.
//
//   Boundary macros.  The tensor cores round a chunk's chained sum toward
//   zero.  Where a +-1 chunk sum s (even: N is) can sit on a decision
//   boundary before the mismatch, s / delta = s 2^B / 2N half an odd
//   integer, which takes 2^(B+1) <= N (N 8 / B 1-2, N 4 / B 1), the last
//   bits of the mismatch decide, and a sum rounded toward zero puts about
//   twice the plain version's share of outputs off the exact macro.  At
//   those macros (`Apart`) the hi x hi product runs from C = 0 apart from
//   the chain of the smaller terms, and one FADD rounded to nearest joins
//   them: the plain version's accuracy, for 9-18 % more time.  The other
//   macros (N 8 / B 3, N 4 / B 2, N 2 / B 1 among them) skip the FADD.
//
//   What holds it at ~4.5x the three-instruction ADC bound at N 8 (H100,
//   tools/time_acim.py --probes): staging and split (0.049 ms of 0.124
//   at 1024 x 768 x 3072, the loads alone 0.029) run apart from the
//   products under the two barriers; the products take the other ~0.075
//   ms, the conversions ~20 % of the total.  Measured and not kept (the
//   tool's --options): the k8 loop unrolled (+5-6 % at N 8, 3 % faster at
//   N 4), three float stages (+1 % at N 8).  Tried while writing it and
//   slower at every N, not kept: one barrier a k-tile on 16-deep tiles
//   with double-buffered terms, w's lo and mid products as one m16n8k16,
//   every other CTA of an SM started part-way into its first k-tile (to
//   put one CTA's split under the other's products).
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;            // output rows per CTA
constexpr int kBN = 64;             // output columns per CTA
constexpr int kBK = 32;             // k per stage
constexpr int kThreads = 256;       // 8 warps: 4 along M x 2 along N
constexpr int kMT = 2;              // m16 tiles a warp
constexpr int kNT = 4;              // n8 tiles a warp
constexpr int kTerms = 3;
constexpr int kXTermBytes = kBM * kBK * 2;
constexpr int kWTermBytes = kBK * kBN * 2;
constexpr int kStages = 2;          // float32 stages (cp.async ring)

constexpr float kQ0 = 0.75f;        // the ADC's offset: ulp 2^-24
constexpr int kQ0Bits = 0x3F400000; // its bits

using Acc = int;                    // the digital sum of offset codes

struct Smem {
  float xf[kStages][kBM * kBK];            // float32 stages, 16-byte pieces
  float wf[kStages][kBK * kBN];            //   swizzled (see load_stage)
  __nv_bfloat16 xt[kTerms][kBM * kBK];     // terms, row m: 64 bytes
  __nv_bfloat16 wt[kTerms][kBK * kBN];     // terms, row k: 128 bytes
  int flags[2];   // per k-tile (mod 2): bit 0 x mid, 1 x lo, 2 w mid, 3 w lo
};

struct Adc {
  float scale;    // 2^-24 / delta
  float delta;
  int bias;       // 2^(B-1) less kQ0's bits
  int top;        // 2^B - 1
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d (16 x 8 f32) += a (16 x 8 bf16, row) b (8 x 8 bf16, col).
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The three bf16 terms of 8 floats (16 bytes each); `nz` gains bit 0 if
// a mid term is nonzero and bit 1 if a lo term is.
__device__ __forceinline__ void split8(const float4 v0, const float4 v1,
                                       uint4& hi, uint4& mid, uint4& lo,
                                       uint32_t& nz) {
  const float f[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
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

// Stage s <- the float32 tiles of x (rows m0.., k0..) and w (k0.., columns
// c0..), zeros past M, C and the split's end ke.  A 16-byte piece p of a
// row lands at p ^ (r & 1) in x's rows (128 bytes) and p ^ ((p >> 3) & 1)
// in w's (256 bytes), so that split_stage's 16-byte reads of 8 threads
// meet 8 different bank quads.
__device__ __forceinline__ void load_stage(Smem& sm, int s, const float* x,
                                           const float* w, int M, int K,
                                           int C, int m0, int c0, int k0,
                                           int ke) {
  const int tid = threadIdx.x;
  const uint32_t xs = smem_u32(sm.xf[s]), ws = smem_u32(sm.wf[s]);
#pragma unroll
  for (int i = 0; i < kBM * kBK / 4 / kThreads; ++i) {
    const int p = tid + i * kThreads, r = p >> 3, pc = p & 7;
    const int gm = m0 + r, gk = k0 + pc * 4;
    const bool in = gm < M && gk < ke;
    cp_async16(xs + (r * kBK + ((pc ^ (r & 1)) << 2)) * 4,
               in ? x + (size_t)gm * K + gk : x, in);
  }
#pragma unroll
  for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
    const int p = tid + i * kThreads, k = p >> 4, pc = p & 15;
    const int gk = k0 + k, gc = c0 + pc * 4;
    const bool in = gk < ke && gc < C;
    cp_async16(ws + (k * kBN + ((pc ^ ((pc >> 3) & 1)) << 2)) * 4,
               in ? w + (size_t)gk * C + gc : w, in);
  }
}

// Split stage s into the term tiles; returns this thread's nonzero bits
// (see Smem::flags).  x's 16-byte chunk c (k 8c..8c+7) of row r lands at
// c ^ ((r >> 1) & 3), w's chunk c (columns 8c..) of row k at c ^ (k & 7):
// the 8 rows an `ldmatrix` 8 x 8 matrix reads then lie in 8 bank quads.
__device__ __forceinline__ uint32_t split_stage(Smem& sm, int s) {
  const int tid = threadIdx.x;
  uint32_t nz = 0, nzw = 0;
  uint8_t* xt = reinterpret_cast<uint8_t*>(sm.xt[0]);
  uint8_t* wt = reinterpret_cast<uint8_t*>(sm.wt[0]);
#pragma unroll
  for (int i = 0; i < kBM * kBK / 8 / kThreads; ++i) {
    const int task = tid + i * kThreads, r = task >> 2, c = task & 3;
    const float4* src = reinterpret_cast<const float4*>(sm.xf[s] + r * kBK);
    uint4 h, m, l;
    split8(src[(2 * c) ^ (r & 1)], src[(2 * c + 1) ^ (r & 1)], h, m, l, nz);
    const int off = r * (kBK * 2) + ((c ^ ((r >> 1) & 3)) << 4);
    *reinterpret_cast<uint4*>(xt + off) = h;
    *reinterpret_cast<uint4*>(xt + kXTermBytes + off) = m;
    *reinterpret_cast<uint4*>(xt + 2 * kXTermBytes + off) = l;
  }
#pragma unroll
  for (int i = 0; i < kBK * kBN / 8 / kThreads; ++i) {
    const int task = tid + i * kThreads, k = task >> 3, c = task & 7;
    const float4* src = reinterpret_cast<const float4*>(sm.wf[s] + k * kBN);
    const int p0 = 2 * c, p1 = 2 * c + 1;
    uint4 h, m, l;
    split8(src[p0 ^ ((p0 >> 3) & 1)], src[p1 ^ ((p1 >> 3) & 1)], h, m, l,
           nzw);
    const int off = k * (kBN * 2) + ((c ^ (k & 7)) << 4);
    *reinterpret_cast<uint4*>(wt + off) = h;
    *reinterpret_cast<uint4*>(wt + kWTermBytes + off) = m;
    *reinterpret_cast<uint4*>(wt + 2 * kWTermBytes + off) = l;
  }
  return nz | (nzw << 2);
}

// One conversion into the digital sum.
__device__ __forceinline__ void adc(float s, Acc& acc, const Adc& p) {
  float q;        // 0.75 + rint(s / delta) 2^-24, saturated to [0, 1]
  asm("fma.rn.sat.f32 %0, %1, %2, %3;\n"
      : "=f"(q) : "f"(s), "f"(p.scale), "f"(kQ0));
  acc += __viaddmin_s32_relu(__float_as_int(q), p.bias, p.top);
}

// The products and conversions of one k-tile for one warp: NX x terms and
// NW w terms (1: hi only; 3: all three); Apart: the hi product joined by
// an FADD (see "Boundary macros").  xa / wa: this lane's ldmatrix
// addresses of term 0 at k8 step 0.
template <int N, bool Apart, int NX, int NW>
__device__ __forceinline__ void tile_products(Acc (&acc)[kMT][kNT][4],
                                              uint32_t xa, int xsw,
                                              uint32_t wa, int t,
                                              const Adc& p) {
#pragma unroll 1
  for (int kk = 0; kk < kBK / 8; ++kk) {
    uint32_t a[NX][4], b[NW][4];
#pragma unroll
    for (int ta = 0; ta < NX; ++ta)
      ldmatrix_x4(a[ta], xa + ta * kXTermBytes + ((kk ^ xsw) << 4));
#pragma unroll
    for (int tb = 0; tb < NW; ++tb)
      ldmatrix_x4_trans(b[tb], wa + tb * kWTermBytes + kk * (8 * kBN * 2));
    // Chunks one after another (unrolled, N 2 spilled): each is the 8
    // tiles' term chains and conversions.
#pragma unroll 1
    for (int q = 0; q < 8 / N; ++q) {
      // this chunk's lanes keep A, the others zero it
      const bool on = N == 8 || t / (N / 2) == q;
      uint32_t am[NX][4];
#pragma unroll
      for (int ta = 0; ta < NX; ++ta)
#pragma unroll
        for (int r = 0; r < 4; ++r) am[ta][r] = on ? a[ta][r] : 0u;
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          float s[4] = {0.f, 0.f, 0.f, 0.f}, h[4] = {0.f, 0.f, 0.f, 0.f};
          constexpr bool apart = Apart && NX * NW > 1;
          // smallest terms first, chained through C
#pragma unroll
          for (int ta = NX - 1; ta >= 0; --ta)
#pragma unroll
            for (int tb = NW - 1; tb >= 0; --tb)
              mma_k8(apart && ta + tb == 0 ? h : s, am[ta][2 * i],
                     am[ta][2 * i + 1], b[tb][j]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
            adc(apart ? __fadd_rn(s[r], h[r]) : s[r], acc[i][j][r], p);
        }
    }
  }
}

template <int N, bool Apart>
__global__ void __launch_bounds__(kThreads, 2)
acim_matmul_mma_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ y,
                       int M, int K, int C, Adc p, int half, int k_split,
                       int atomic) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm0 = (warp & 3) * 32, wn0 = (warp >> 2) * 32;
  const int m0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);
  const int n_kt = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;

  // This lane's ldmatrix rows: x, matrix lane / 8 = (m16 tile, half);
  // w, matrix lane / 8 = n8 tile, row k = lane % 8 of the k8 step.
  const int xr = wm0 + (lane >> 4) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const uint32_t xa = smem_u32(sm.xt[0]) + xr * (kBK * 2);
  const int xsw = (xr >> 1) & 3;
  const int wc = (wn0 >> 3) + (lane >> 3);
  const uint32_t wa = smem_u32(sm.wt[0]) + (lane & 7) * (kBN * 2) +
                      ((wc ^ (lane & 7)) << 4);

  if (tid < 2) sm.flags[tid] = 0;
  Acc acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_kt)
      load_stage(sm, st, x, w, M, K, C, m0, c0, kb + st * kBK, ke);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    // the stage of tile kt - 1, split in the last iteration, takes the
    // tile kStages - 1 ahead
    const int ahead = kt + kStages - 1;
    if (ahead < n_kt)
      load_stage(sm, ahead % kStages, x, w, M, K, C, m0, c0,
                 kb + ahead * kBK, ke);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // stage kt has landed (this thread's)
    __syncthreads();          // ... every thread's; terms of kt - 1 are read
    if (tid == 0) sm.flags[(kt + 1) & 1] = 0;
    uint32_t nz = split_stage(sm, kt % kStages);
    nz = __reduce_or_sync(0xffffffffu, nz);
    if (lane == 0 && nz) atomicOr(&sm.flags[kt & 1], (int)nz);
    __syncthreads();
    const int fl = sm.flags[kt & 1];
    if ((fl & 3) != 0)
      tile_products<N, Apart, 3, 3>(acc, xa, xsw, wa, lane & 3, p);
    else if ((fl & 12) != 0)
      tile_products<N, Apart, 1, 3>(acc, xa, xsw, wa, lane & 3, p);
    else
      tile_products<N, Apart, 1, 1>(acc, xa, xsw, wa, lane & 3, p);
  }

  // Accumulator fragment: element r of tile (i, j) is row g + 8 (r / 2),
  // column 2t + r % 2.  Each conversion added its code plus `half`.
  const int conv = n_kt * (kBK / N);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm0 + i * 16 + g + 8 * h;
      if (r >= M) continue;
      float* yr = y + (size_t)r * C;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = c0 + wn0 + j * 8 + 2 * t;
        if (c >= C) continue;             // C is even: c + 1 < C too
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = (float)(acc[i][j][2 * h + e] - conv * half) * p.delta;
        if (atomic) {
          atomicAdd(yr + c, v[0]);
          atomicAdd(yr + c + 1, v[1]);
        } else {
          *reinterpret_cast<float2*>(yr + c) = make_float2(v[0], v[1]);
        }
      }
    }
}

template <int N, bool Apart>
cudaError_t launch(const float* x, const float* w, float* y, int M, int K,
                   int C, const Adc& p, int half, int k_split, int splits,
                   cudaStream_t st) {
  // Set on every call: the attribute belongs to the current device.
  const int smem = (int)sizeof(Smem);
  const cudaError_t err = cudaFuncSetAttribute(
      acim_matmul_mma_kernel<N, Apart>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  acim_matmul_mma_kernel<N, Apart><<<grid, kThreads, smem, st>>>(
      x, w, y, M, K, C, p, half, k_split, splits > 1 ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K), w (K, C), y (M, C): float32, row-major, on the device, 16-byte
// aligned; N in {2, 4, 8}, K % N == 0, K % 4 == 0, C % 4 == 0.  b_adc is
// the ADC's bits B (1-16).  K is split into `splits` ranges of whole
// 32-deep k-tiles, one CTA each per output tile (1: no split).
int acim_matmul_mma(const float* x, const float* w, float* y, int M, int K,
                    int C, int N, int b_adc, int splits, void* stream) {
  if ((N != 2 && N != 4 && N != 8) || K % N || K % 4 || C % 4 ||
      splits < 1 || b_adc < 1 || b_adc > 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int per = k_tiles > 0 ? (k_tiles + splits - 1) / splits : 0;
  splits = per > 0 ? (k_tiles + per - 1) / per : 1;
  if (splits > 1) {
    const cudaError_t err = cudaMemsetAsync(y, 0, (size_t)M * C * 4, st);
    if (err != cudaSuccess) return (int)err;
  }
  const int half = 1 << (b_adc - 1);
  Adc p;
  p.delta = (float)(2.0 * N / (2.0 * half));        // 2^e: exact
  p.scale = (float)(2.0 * half / (2.0 * N) / 16777216.0);
  p.bias = half - kQ0Bits;
  p.top = 2 * half - 1;
  const int k_split = per * kBK;
  const bool apart = (2 << b_adc) <= N;             // 2^(B+1) <= N
  cudaError_t err;
#define ACIM_LAUNCH(n, a) \
  launch<n, a>(x, w, y, M, K, C, p, half, k_split, splits, st)
  switch (N) {
    case 2: err = ACIM_LAUNCH(2, false); break;
    case 4: err = apart ? ACIM_LAUNCH(4, true) : ACIM_LAUNCH(4, false); break;
    default: err = apart ? ACIM_LAUNCH(8, true) : ACIM_LAUNCH(8, false);
  }
#undef ACIM_LAUNCH
  return (int)err;
}

}  // extern "C"
