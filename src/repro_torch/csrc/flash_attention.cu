// Causal / full flash attention in float32 on Hopper tensor cores
// (sm_90a): both products as 3xTF32 `wgmma`, plain C interface.
//
// flash_attention replaces, for float32 inputs at head dims 16, 32, 64
// and 128 and for bf16 inputs at 16 and 32 (the cases the bf16 kernel of
// flash_attention_wgmma.cu does not take), the Pallas kernel
// `flash_attention_kernel` (body `_kernel`) of src/repro/kernels/
// flash_attention/kernel.py, whose oracle partner is `_blockwise_core` in
// src/repro/models/attention.py.  For q (B, S, H, Dh) and k, v (B, T, KV,
// Dh), query head h reading KV head h / (H / KV), it computes with the
// Pallas kernel's arithmetic
//
//   s[r, c] = (q[r] . k[c]) * scale                        (float32)
//   o[r]    = sum_c exp(s[r, c] - m_r) v[c] / sum_c exp(s[r, c] - m_r)
//
// over the visible keys c, with a running (max m, sum l, acc) in float32
// carried across key tiles, and o = acc / max(l, 1e-30) cast once to the
// input type (bf16 or f32); exact `expf` and IEEE division.  Key c is
// visible to query r when c < T and, if causal, c <= r or (r < prefix_len
// and c < prefix_len).  `ref.flash_attention_ref` is the plain PyTorch
// version (it scales q before the product: the two differ by a float32
// rounding of each score).
//
//   Float32 on TF32 tensor cores (3xTF32).  Each float32 operand x is
//   written x = hi + lo with hi = x & ~0x1fff (the 10-bit mantissa a TF32
//   product reads) and lo = (x - hi) & ~0x1fff (x - hi is exact), and each
//   product takes three TF32 products summed in float32:
//     S = Q_hi K_hi + Q_hi K_lo + Q_lo K_hi,
//     O += P_hi V_hi + P_hi V_lo + P_lo V_hi.
//   The tensor cores add a `wgmma`'s products to its float32 accumulator
//   rounded toward zero (within a few ulps of the exact sum rounded that
//   way), so a sum carried through many `wgmma` loses up to an ulp of its
//   running value at each, always toward zero.  O kept in the accumulator
//   across all key tiles drifted past the 2e-5 tolerance: 1.45x it at
//   (4, 4096, 16, 2, 128) causal with q scaled by 4 (scores ~30) and 5.9x
//   at 32768 keys (H100 80GB HBM3, tools/flash_accuracy.py).  So O is
//   moved out of the accumulator into float32 (O = O corr + acc, one
//   fmaf) after every tile at Dh 64 and below, and every 512 keys at Dh
//   128 (`holds_o`), and each chain issues the small products (hi.lo,
//   lo.hi) of all its k8 steps before the hi.hi ones, while its
//   accumulator is small.  A CPU model of this arithmetic with that
//   rounding is in tests/test_torch_flash_attention.py; the dropped lo.lo
//   term and lo's last bits (~2^-21 of each product) change little.
//   A bf16 value is exact in TF32, so for bf16 inputs the Q, K and V lo
//   terms are zero and are dropped at compile time: S is one product and
//   P.V two.
//
//   Bound on the H100: operations.  2 * (2 Dh) flops per visible (query,
//   key) pair and head; at (B 1, S = T = 32768, H 16, KV 2, Dh 128, causal)
//   4.40e12, and three TF32 products each: 26.7 ms at the 494.7 TFLOP/s
//   TF32 tensor-core peak (65.7 ms at the 67 TFLOP/s float32 FFMA peak the
//   CUDA-core design this replaces was held to), against 604 MB of float32
//   q, k, v and o (0.18 ms at 3.35 TB/s).
//
//   Design.  One CTA of three warpgroups per (128-query tile, head, batch),
//   the grid 1-D with the longest causal tiles first.  A `.tf32` `wgmma`
//   reads only K-major operands from shared memory (its descriptor's
//   transpose bit is for 16-bit types), so V must be transposed, and every
//   operand has to be split: no TMA copy does either, so warpgroup 0, the
//   producer, loads each tile of BK keys with plain vector loads into
//   registers and writes K_hi, K_lo, V_hi^T and V_lo^T into a ring of
//   kStages stages (128-byte swizzle, the layout the descriptors name; keys
//   past T as zeros), then signals a `full` mbarrier after a proxy fence,
//   and only then issues the next tile's loads: the fence waits for every
//   outstanding access of the thread, so loads issued before it would
//   expose their latency once a tile (74.4 against 57.6 ms at the shape
//   above, H100 80GB HBM3 at 700 W).  The consumers' 256 threads arrive on
//   an `empty` mbarrier when their products are done.  Warpgroups 1 and 2
//   are consumers of 64 query rows each.  `setmaxnreg` gives the producer
//   120 registers a thread and the consumers 192: the producer holds a
//   whole prefetched tile, and at 88 / 208 it spilled it and the kernel
//   took 57.6 ms against 49.3-49.8 (`producer_regs`).  Each consumer keeps
//   Q_hi in registers as the A fragments of its `wgmma` m64nBKk8 steps and
//   writes Q_lo into shared memory once (at Dh 128, Q_hi and Q_lo for 128
//   rows would take 128 KB of shared memory): the two products that read
//   Q_hi take it from registers, and only Q_lo K_hi reads A from shared
//   memory.  Per key tile a consumer runs S as Dh/8 k8 steps of three
//   `wgmma`, scales, masks, and runs the online softmax on the f32
//   accumulator fragment (a row's BK scores lie in the 4 lanes of a quad:
//   max by two xor shuffles; the row sum is kept per thread and reduced
//   once at the end), splits P in registers and runs P V as BK/8 k8 steps
//   of three register-A `wgmma` m64nDhk8: at Dh 64 and below into a fresh
//   accumulator added to O, at Dh 128 into the accumulator that holds O
//   (rescaled first), flushed every 512 keys into the float32 output as O
//   = O_out cs + acc, cs the product of the rescales since the last flush
//   (its lines prefetched into L2 a tile before).  At Dh 128, Q_hi, O and
//   a fresh accumulator would take 192 registers a thread before P (Q_hi
//   read again for each tile instead took 81.0-82.2 ms at the shape above
//   against 49.5-50.4: its L2 reads, tools/time_flash.py).  P never leaves
//   the registers: the accumulator fragment holds keys 2t and 2t + 1 of
//   each 8-key group (t = lane % 4) where a `.tf32` A fragment reads keys t
//   and t + 4, so the producer writes V^T's keys in the order 0 2 4 6 1 3 5
//   7 within each group, and the accumulator's registers are the A
//   fragment as they stand (the sum
//   over keys does not see the order).  A -inf mask is applied only on
//   tiles that need one; a row that has seen no visible key keeps m = -inf
//   and p = 0.  A CTA stops at the last key tile a row of its can see (with
//   a prefix, at least up to the prefix).  Offsets are int64.
//
//   Shared memory (checked at compile time for every instantiation):
//   Q_lo for 128 rows plus kStages stages of K_hi, K_lo, V_hi^T and
//   V_lo^T, in blocks of 32 columns (128 bytes; Dh 16 takes half of one).
//   At Dh 128 the key tile is 32: 64 KB + 2 x 64 KB = 192 KB, one CTA per
//   SM; at Dh 64 and below BK = 64 (160 KB at 64).  The S product is then
//   m64n32k8, a narrow tile; a 64-key tile would need 256 KB.
//
//   Measured on the H100 80GB HBM3 at 700 W: with the producer's loads
//   and stores left out, the consumers took 35.0 ms at the shape above
//   against the whole kernel's 74.6 (before the loads moved past the
//   fence), so the producer, not the tensor cores, bounds this design.
//   Left for later: K through TMA into a raw ring split in place; the
//   softmax of one tile overlapped with the next S.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;            // query rows per CTA: two consumers x 64
constexpr int kStages = 2;          // depth of the K / V ring
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may have
constexpr uint32_t kTf32 = 0xffffe000u;   // the bits a TF32 product reads

// Columns of a tile: whole 32-float (128-byte) swizzle rows.
__host__ __device__ constexpr int tile_cols(int d) { return (d + 31) / 32 * 32; }

// Keys per K / V tile: 32 at Dh 128 (shared memory), else 64.
__host__ __device__ constexpr int key_tile(int dh) { return dh > 64 ? 32 : 64; }

// Where O is summed.  At Dh 128 the tensor cores' accumulator holds it and
// is flushed to the float32 output every kFlushKeys keys: Q_hi, O and a
// tile's own P.V accumulator (64 floats a thread each) do not fit a
// consumer's registers.  At Dh 64 and below each tile's P.V has a fresh
// accumulator, added to O in registers.  A flush reads and writes the
// CTA's 64 KB of O, mostly from HBM: at (1, 32768, 16, 2, 128) causal,
// every 256 keys took 53.2-53.9 ms, every 512 50.7-53.9 and none 49.6-50.4
// (H100 80GB HBM3, 700 W, tools/flash_variants.py), where every 1024 keys
// reads 0.79 of the tolerance with q scaled by 4 against 0.73.
__host__ __device__ constexpr bool holds_o(int dh) { return dh > 64; }
constexpr int kFlushKeys = 512;

// Registers a thread keeps after `setmaxnreg` (all the launch allocates):
// the producer holds a whole prefetched tile (64 floats a thread) and its
// addresses, and spilled some at 104 and 112 (56.1-59.0 and 53.8-56.8 ms
// in tools/flash_variants.py, 120: 50.7-53.9); the consumer holds Q_hi and
// O (64 floats each at Dh 128), or at Dh 64 Q_hi, O, a tile's P.V and its
// P (32, 32, 32 and 64).
__host__ __device__ constexpr int producer_regs(int) { return 120; }
__host__ __device__ constexpr int consumer_regs(int) { return 192; }

// One stage's lo buffers are dropped for bf16 inputs (a 1 KB stub keeps
// the layout's alignment).
template <int DH, int BK, bool kSplit>
struct Smem {
  static constexpr int kDT = tile_cols(DH);
  alignas(1024) float q[kSplit ? kBQ * kDT : 256];           // Q_lo
  alignas(1024) float k[kStages][BK * kDT];                  // K_hi
  alignas(1024) float klo[kStages][kSplit ? BK * kDT : 256]; // K_lo
  alignas(1024) float v[kStages][DH * BK];                   // V_hi^T
  alignas(1024) float vlo[kStages][kSplit ? DH * BK : 256];  // V_lo^T
  alignas(8) uint64_t full[kStages];
  uint64_t empty[kStages];
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qsb, qss, qsh;          // strides in elements: batch, seq, head
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  int B, S, T, H, KV;
  int causal, prefix_len;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// Makes this thread's shared-memory writes visible to `wgmma`'s reads
// (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` over the `n` threads of one or more warpgroups.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
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

// The descriptor of k8 step kk of a K-major tile of `rows` rows at
// `addr`: 32 bytes into the swizzle row of 32-column block kk / 4.
__device__ __forceinline__ uint64_t step_desc(uint32_t addr, int rows,
                                              int kk) {
  return sw128_desc(addr + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}

// Float offset of (row, col) in a K-major tile of `rows` rows stored as
// 128-byte-swizzled blocks of 32 columns: 16-byte chunk c of row r sits at
// chunk c ^ (r % 8), the layout of `wgmma`'s swizzle mode 1.
__device__ __forceinline__ int sw_off(int row, int col, int rows) {
  return (col >> 5) * rows * 32 + row * 32 +
         ((((col >> 2) & 7) ^ (row & 7)) << 2) + (col & 3);
}

__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & kTf32);
}

__device__ __forceinline__ float tf32_lo(float x, float hi) {
  return tf32_hi(x - hi);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous `wgmma` that owns it; after the wait, keeps a register
// operand's registers from other values until the `wgmma` has read it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(d[i]);
}

// Four consecutive elements (8- or 16-byte aligned) as float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float4 hi4(float4 x) {
  return make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
}

__device__ __forceinline__ float4 lo4(float4 x, float4 h) {
  return make_float4(tf32_lo(x.x, h.x), tf32_lo(x.y, h.y), tf32_lo(x.z, h.z),
                     tf32_lo(x.w, h.w));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// `wgmma` m64nNk8 with TF32 operands and an f32 accumulator (N / 2 floats
// a thread): `rs` with A in registers, at every N the two products take
// (the S tile's BK, P.V's Dh); `ss` with A and B in shared memory, at the
// S tile's (32, 64).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // D (64 x 16 f32) += A (64 x 8, registers) B (16 x 8, smem,
  // K-major)^T; D = A B^T when scale_d == 0.
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  // D (64 x 32 f32) += A (64 x 8, smem, K-major) B (32 x 8, smem,
  // K-major)^T; D = A B^T when scale_d == 0.
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
  }
  // D (64 x 32 f32) += A (64 x 8, registers) B (32 x 8, smem,
  // K-major)^T; D = A B^T when scale_d == 0.
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  // D (64 x 64 f32) += A (64 x 8, smem, K-major) B (64 x 8, smem,
  // K-major)^T; D = A B^T when scale_d == 0.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
  }
  // D (64 x 64 f32) += A (64 x 8, registers) B (64 x 8, smem,
  // K-major)^T; D = A B^T when scale_d == 0.
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // D (64 x 128 f32) += A (64 x 8, registers) B (128 x 8, smem,
  // K-major)^T; D = A B^T when scale_d == 0.
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};


// The producer's share of one K / V tile: its loads into registers, and
// its stores of the split values into the ring.  K is stored K-major (a
// key's Dh columns) as K_hi and K_lo, V as V_hi^T and V_lo^T (K-major over
// keys: row d holds the tile's keys in the A fragment's order, 0 2 4 6 1
// 3 5 7 within each group of 8); keys past T are zeros.
template <int DH, int BK>
struct TileLoad {
  static constexpr int kKItems = BK * DH / 4;   // (key, 4-column chunk)
  static constexpr int kVItems = DH * BK / 8;   // (column, 8-key group)
  static_assert(kKItems % 128 == 0 && kVItems % 128 == 0,
                "whole passes of the producer's 128 threads");
  static constexpr int kKN = kKItems / 128, kVN = kVItems / 128;

  template <typename T>
  static __device__ __forceinline__ void load_k(float4 (&kx)[kKN],
                                                const T* kg,
                                                const Params& p, int k0) {
#pragma unroll
    for (int i = 0; i < kKN; ++i) {
      const int it = threadIdx.x + 128 * i;
      const int key = k0 + it / (DH / 4);
      kx[i] = key < p.T ? load4(kg + key * p.kss + 4 * (it % (DH / 4)))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  template <typename T>
  static __device__ __forceinline__ void load_v(float (&vx)[kVN][8],
                                                const T* vg,
                                                const Params& p, int k0) {
#pragma unroll
    for (int i = 0; i < kVN; ++i) {
      const int it = threadIdx.x + 128 * i;
      const int d = it % DH, key0 = k0 + 8 * (it / DH);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        vx[i][e] = key0 + e < p.T ? load1(vg + (key0 + e) * p.vss + d) : 0.f;
    }
  }

  template <bool kSplit>
  static __device__ __forceinline__ void store_k(const float4 (&kx)[kKN],
                                                 float* k, float* klo) {
#pragma unroll
    for (int i = 0; i < kKN; ++i) {
      const int it = threadIdx.x + 128 * i;
      const int off = sw_off(it / (DH / 4), 4 * (it % (DH / 4)), BK);
      const float4 h = hi4(kx[i]);
      *reinterpret_cast<float4*>(k + off) = h;
      if (kSplit) *reinterpret_cast<float4*>(klo + off) = lo4(kx[i], h);
    }
  }

  template <bool kSplit>
  static __device__ __forceinline__ void store_v(const float (&vx)[kVN][8],
                                                 float* v, float* vlo) {
#pragma unroll
    for (int i = 0; i < kVN; ++i) {
      const int it = threadIdx.x + 128 * i;
      const int d = it % DH, col = 8 * (it / DH);
      const float4 a = make_float4(vx[i][0], vx[i][2], vx[i][4], vx[i][6]);
      const float4 b = make_float4(vx[i][1], vx[i][3], vx[i][5], vx[i][7]);
      const int oa = sw_off(d, col, DH), ob = sw_off(d, col + 4, DH);
      const float4 ha = hi4(a), hb = hi4(b);
      *reinterpret_cast<float4*>(v + oa) = ha;
      *reinterpret_cast<float4*>(v + ob) = hb;
      if (kSplit) {
        *reinterpret_cast<float4*>(vlo + oa) = lo4(a, ha);
        *reinterpret_cast<float4*>(vlo + ob) = lo4(b, hb);
      }
    }
  }
};

// The producer warpgroup: every key tile of the CTA into the ring.  The
// next tile's K and V loads are issued right after this tile's stores are
// signalled, so their latency overlaps the wait for a free stage (issued
// before the proxy fence, they would hold it: the fence waits for every
// outstanding memory access of the thread).
template <int DH, int BK, bool kSplit, typename T>
__device__ __forceinline__ void produce(Smem<DH, BK, kSplit>& sm,
                                        const Params& p, const T* kg,
                                        const T* vg, int n_kt) {
  using L = TileLoad<DH, BK>;
  float4 kx[L::kKN];
  float vx[L::kVN][8];
  L::load_k(kx, kg, p, 0);
  L::load_v(vx, vg, p, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    mbar_wait(&sm.empty[st], ((kt / kStages) & 1) ^ 1);
    L::template store_k<kSplit>(kx, sm.k[st], sm.klo[st]);
    L::template store_v<kSplit>(vx, sm.v[st], sm.vlo[st]);
    fence_async_smem();
    mbar_arrive(&sm.full[st]);
    if (kt + 1 < n_kt) {
      L::load_k(kx, kg, p, (kt + 1) * BK);
      L::load_v(vx, vg, p, (kt + 1) * BK);
    }
  }
}

// d (+)= P V over one key tile: P's hi words in `phi` and lo values in
// `plo` (the S accumulator fragment), V^T's hi and lo in shared memory;
// the small products (P_hi V_lo, P_lo V_hi) of every k8 step first, then
// the P_hi V_hi ones.  first_scale 0: d = P V, 1: d += P V.
template <int DH, int BK, bool kSplit>
__device__ __forceinline__ void pv_chain(float (&d)[DH / 2],
                                         uint32_t (&phi)[BK / 2],
                                         float (&plo)[BK / 2],
                                         uint32_t v_addr, uint32_t vlo_addr,
                                         int first_scale) {
  fence_regs(phi);
  fence_regs(plo);
  fence_regs(d);
  wgmma_fence();
  // accumulator (row, 8 kk + 2t + e) -> A (row, t + 4 e): registers
  // 4 kk + {0, 2, 1, 3}
  uint32_t ahi[BK / 8][4], alo[BK / 8][4];
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * kk + (e % 2) * 2 + e / 2;
      ahi[kk][e] = phi[i];
      alo[kk][e] = __float_as_uint(plo[i]);
    }
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    if (kSplit)
      Wgmma<DH>::rs(d, ahi[kk], step_desc(vlo_addr, DH, kk),
                    kk ? 1 : first_scale);
    Wgmma<DH>::rs(d, alo[kk], step_desc(v_addr, DH, kk),
                  kSplit || kk ? 1 : first_scale);
  }
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    Wgmma<DH>::rs(d, ahi[kk], step_desc(v_addr, DH, kk));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
  fence_regs(ahi);      // live, so unwritten, until the reads are done
  fence_regs(alo);
}

// O's flush at Dh 128: og (float32) = og cs + acc, or acc the first time
// (`prior` false), for the thread's fragment of rows row0 and row0 + 8;
// then acc starts afresh (its next `wgmma` at scale 0) and cs = 1.
template <int N, typename T>
__device__ __forceinline__ void flush_o(const float (&acc)[N], float (&cs)[2],
                                        T* const (&orow)[2], bool prior,
                                        int row0, int S) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row0 + 8 * i < S) {
      // a row's reads all issued before its writes: interleaved, the
      // kernel took 55.5-56.8 ms at the shape of `holds_o` against
      // 50.7-52.5 (tools/time_flash.py, the first design at 49.5-52.7 in
      // both calls)
      float2 y[N / 4];
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
        y[j] = prior ? load2(orow[i] + 8 * j) : make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
        store2(orow[i] + 8 * j, fmaf(y[j].x, cs[i], acc[4 * j + 2 * i]),
               fmaf(y[j].y, cs[i], acc[4 * j + 2 * i + 1]));
    }
    cs[i] = 1.f;
  }
}

// L2 prefetch of the rows' flushed O: a quad's four lanes take the four
// 128-byte lines of each of its two rows (Dh 128 float32).
template <typename T>
__device__ __forceinline__ void prefetch_o(T* const (&orow)[2], int row0,
                                           int S, int col0) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (row0 + 8 * i < S)
      asm volatile("prefetch.global.L2 [%0];\n"
                   :: "l"(orow[i] - col0 + 16 * col0));
}

// One consumer warpgroup: 64 query rows of the CTA's tile, all its key
// tiles, and the rows' output.
template <int DH, int BK, bool kSplit, typename T>
__device__ __forceinline__ void consume(Smem<DH, BK, kSplit>& sm,
                                        const Params& p, const T* qg, T* og,
                                        int cw, int q0, int n_kt, int b,
                                        int h) {
  constexpr int kO = DH / 2;          // O floats per thread: DH / 8 chunks x 4
  constexpr int kS = BK / 2;          // S floats per thread: BK / 8 chunks x 4
  constexpr bool kHold = holds_o(DH);
  constexpr int kFlushTiles = kFlushKeys / BK;
  static_assert(!kHold || sizeof(T) == 4, "O is flushed to a float32 output");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = q0 + cw * 64;      // this consumer's first row
  const int row0 = r_lo + warp * 16 + lane / 4;   // rows row0 and row0 + 8
  const int col0 = 2 * (lane % 4);    // columns 8 j + col0 + {0, 1}

  // Q_hi as the A fragments of the S product's k8 steps (register e of
  // step kk is (row0 + 8 (e % 2), 8 kk + lane % 4 + 4 (e / 2))); Q_lo of the
  // consumer's 64 rows into shared memory.
  uint32_t qhi[DH / 8][4];
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + 8 * (e % 2);
      const float x =
          r < p.S ? load1(qg + r * p.qss + 8 * kk + lane % 4 + 4 * (e / 2))
                  : 0.f;
      qhi[kk][e] = __float_as_uint(tf32_hi(x));
    }
  if (kSplit) {
    for (int it = tid; it < 64 * DH / 4; it += 128) {
      const int row = it / (DH / 4), col = 4 * (it % (DH / 4));
      const int r = r_lo + row;
      const float4 x = r < p.S ? load4(qg + r * p.qss + col)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&sm.q[sw_off(cw * 64 + row, col, kBQ)]) =
          lo4(x, hi4(x));
    }
    fence_async_smem();
    named_sync(1 + cw, 128);
  }

  const uint32_t q_addr = smem_u32(sm.q) + cw * 64 * 128;
  // kHold: the tensor cores' accumulator since the last flush, else O
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};          // per thread; the quad's sum at the end
  float cs[2] = {1.f, 1.f};         // kHold: the corrections since the flush
  bool flushed = false;             // kHold: O's flushed part is in og
  T* orow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    orow[i] = og + (((long long)b * p.S + row0 + 8 * i) * p.H + h) * DH + col0;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    const int k0 = kt * BK;
    // Q_hi is read by every tile's `wgmma`: an opaque write each tile keeps
    // the compiler from handing its registers to other values inside the
    // loop (ptxas did so at Dh 64, where the second tile read P there)
    fence_regs(qhi);
    mbar_wait(&sm.full[st], (kt / kStages) & 1);

    // S, the small products of every k8 step first, then the hi.hi ones
    float s[kS];
    const uint32_t k_addr = smem_u32(sm.k[st]), klo_addr = smem_u32(sm.klo[st]);
    wgmma_fence();
    if (kSplit) {
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        Wgmma<BK>::rs(s, qhi[kk], step_desc(klo_addr, BK, kk), kk);
        Wgmma<BK>::ss(s, step_desc(q_addr, kBQ, kk),
                      step_desc(k_addr, BK, kk), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk)
      Wgmma<BK>::rs(s, qhi[kk], step_desc(k_addr, BK, kk), kSplit || kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
#pragma unroll
    for (int i = 0; i < kS; ++i) s[i] *= p.scale;
    // every key of the tile is visible to every row of the consumer when
    // the tile ends inside T and either lies at or below the first row or
    // inside a prefix that holds all 64 rows
    const bool need_mask =
        k0 + BK > p.T ||
        (p.causal && k0 + BK - 1 > r_lo &&
         !(r_lo + 63 < p.prefix_len && k0 + BK <= p.prefix_len));
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + 8 * (e / 2);
          const int c = k0 + 8 * j + col0 + (e % 2);
          const bool vis = c < p.T && (!p.causal || c <= r ||
                                       (r < p.prefix_len && c < p.prefix_len));
          if (!vis) s[4 * j + e] = -INFINITY;
        }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
    float corr[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;
      corr[i] = expf(m[i] - mu[i]);
      m[i] = m_new;
    }

    // p in place of s, then split: phi the hi words, s the lo values
    uint32_t phi[kS];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[4 * j + e] - mu[e / 2]);
        sum[e / 2] += pe;
        const float hi = tf32_hi(pe);
        phi[4 * j + e] = __float_as_uint(hi);
        s[4 * j + e] = tf32_lo(pe, hi);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];

    const uint32_t v_addr = smem_u32(sm.v[st]), vlo_addr = smem_u32(sm.vlo[st]);
    if constexpr (kHold) {
      // O rescaled in the accumulator (ignored after a flush), P.V added
      // there, and every kFlushTiles tiles O = O_flushed cs + acc into og
#pragma unroll
      for (int i = 0; i < 2; ++i) cs[i] *= corr[i];
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e / 2];
      pv_chain<DH, BK, kSplit>(o, phi, s, v_addr, vlo_addr,
                               kt % kFlushTiles != 0);
      mbar_arrive(&sm.empty[st]);
      if ((kt + 1) % kFlushTiles == 0 && kt + 1 < n_kt) {
        flush_o(o, cs, orow, flushed, row0, p.S);
        flushed = true;
      } else if ((kt + 2) % kFlushTiles == 0 && flushed) {
        // the flushed O's lines back into L2 a tile ahead of their reads
        prefetch_o(orow, row0, p.S, col0);
      }
    } else {
      // this tile's P.V in a fresh accumulator, O = O corr + P.V
      float pv[kO];
      pv_chain<DH, BK, kSplit>(pv, phi, s, v_addr, vlo_addr, 0);
      mbar_arrive(&sm.empty[st]);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[4 * j + e] = fmaf(o[4 * j + e], corr[e / 2], pv[4 * j + e]);
    }
  }
  if constexpr (kHold) {
    if (flushed) flush_o(o, cs, orow, true, row0, p.S);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row0 + 8 * i >= p.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      float2 x = make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
      if constexpr (kHold) {
        if (flushed) x = load2(orow[i] + 8 * j);
      }
      store2(orow[i] + 8 * j, x.x / den, x.y / den);
    }
  }
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const Params p) {
  constexpr int BK = key_tile(DH);
  constexpr bool kSplit = sizeof(T) == 4;
  static_assert(DH % 16 == 0 && DH <= 128, "head dims 16 to 128");
  static_assert(128 * producer_regs(DH) + 256 * consumer_regs(DH) <=
                    kThreads * 168,
                "the warpgroups' registers fit what the launch allocates");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem<DH, BK, kSplit>& sm =
      *reinterpret_cast<Smem<DH, BK, kSplit>*>(smem_raw + pad);

  const int bh_count = p.B * p.H;
  const int n_qt = (p.S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / bh_count);
  const int bh = (int)(blockIdx.x % bh_count);
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * kBQ;
  // keys [0, kend) can be visible to some row of this tile
  int kend = p.T;
  if (p.causal) {
    kend = min(q0 + kBQ, p.S);
    if (q0 < p.prefix_len) kend = max(kend, p.prefix_len);
    kend = min(kend, p.T);
  }
  const int n_kt = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 128);    // every producer thread arrives
      mbar_init(&sm.empty[st], 256);   // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {            // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(producer_regs(DH)));
    produce<DH, BK, kSplit>(
        sm, p, static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh,
        static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh, n_kt);
  } else {                            // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(consumer_regs(DH)));
    consume<DH, BK, kSplit>(
        sm, p, static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh,
        static_cast<T*>(p.o), threadIdx.x / 128 - 1, q0, n_kt, b, h);
  }
}

template <int DH, typename T>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int BK = key_tile(DH);
  using Sm = Smem<DH, BK, sizeof(T) == 4>;
  static_assert(sizeof(Sm) + 1024 <= kSmemLimit,
                "Q_hi and the K / V stages must fit a block's shared memory");
  const long long blocks = (long long)((p.S + kBQ - 1) / kBQ) * p.B * p.H;
  if (blocks == 0) return 0;
  if (p.T == 0) {                     // no key: o = 0 / max(0, 1e-30)
    cudaMemsetAsync(p.o, 0, (size_t)p.B * p.S * p.H * DH * sizeof(T), stream);
    return (int)cudaGetLastError();
  }
  const int smem = (int)sizeof(Sm) + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DH, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_kernel<DH, T><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch(const Params& p, int dh, bool bf16, cudaStream_t stream) {
  if (bf16) {
    switch (dh) {
      case 16: return launch<16, __nv_bfloat16>(p, stream);
      case 32: return launch<32, __nv_bfloat16>(p, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (dh) {
    case 16: return launch<16, float>(p, stream);
    case 32: return launch<32, float>(p, stream);
    case 64: return launch<64, float>(p, stream);
    case 128: return launch<128, float>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, S, H, Dh), k / v (B, T, KV, Dh) on the device with unit stride on
// Dh and the other strides (elements) in `strides`: q's batch, seq, head,
// then k's, then v's, each a multiple of 8, pointers 16-byte aligned.
// o (B, S, H, Dh) contiguous.  bf16 != 0: bfloat16 tensors (Dh 16 or 32),
// else float32 (Dh 16, 32, 64 or 128).  scale = 1 / sqrt(Dh) in float32.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    const long long* strides, int B, int S, int T, int H,
                    int KV, int dh, int bf16, int causal, int prefix_len,
                    float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.qsb = strides[0]; p.qss = strides[1]; p.qsh = strides[2];
  p.ksb = strides[3]; p.kss = strides[4]; p.ksh = strides[5];
  p.vsb = strides[6]; p.vss = strides[7]; p.vsh = strides[8];
  p.B = B; p.S = S; p.T = T; p.H = H; p.KV = KV;
  p.causal = causal; p.prefix_len = prefix_len; p.scale = scale;
  return dispatch(p, dh, bf16 != 0, (cudaStream_t)stream);
}

}  // extern "C"
