// Causal / full flash attention on Hopper tensor cores (sm_90a), bf16, at
// q/k and v head dims (Dh, Dv) of 64 / 64, 128 / 128 and 192 / 128 (MLA's
// prefill: nope 128 + rope 64 for q and k, v 128), plain C interface.
//
// flash_attention_wgmma replaces, for bf16 inputs at those head dims, the
// Pallas kernel `flash_attention_kernel` (body `_kernel`) of
// src/repro/kernels/flash_attention/kernel.py, and at 192 / 128 the jnp
// blockwise core that MLA's prefill runs on v padded to 192
// (`mla_fwd_blockwise`, src/repro/models/attention.py); float32 and the
// other head dims stay on the CUDA-core kernel of flash_attention.cu.  For
// q (B, S, H, Dh), k (B, T, KV, Dh) and v (B, T, KV, Dv), query head h
// reading KV head h / (H / KV), it computes
//
//   s[r, c] = q[r] . k[c]                      (bf16 products, f32 sums)
//   p[r, c] = exp2(s[r, c] * c2 - m_r * c2),   c2 = log2(e) / sqrt(Dh)
//   o[r]    = sum_c bf16(p[r, c]) v[c] / sum_c p[r, c]
//
// over the visible keys c, with a running (max m, sum l, acc) in float32
// carried across 128-key tiles and o = acc / max(l, 1e-30) rounded once to
// bf16.  P is rounded to bf16 before P.V, as the reference's own oracle
// partner `_blockwise_core` (src/repro/models/attention.py) does; the scores
// stay float32 and are scaled after the product (1/sqrt(Dh) is not a power
// of two, so scaling q in bf16 would add a rounding).  Key c is visible to
// query r when c < T and, if causal, c <= r or (r < prefix_len and c <
// prefix_len).  `ref.flash_attention_tc_ref` is the plain PyTorch version of
// this arithmetic.
//
//   Bound on the H100: operations.  2 * (Dh + Dv) flops per visible
//   (query, key) pair and head; at the qwen2.5-3b prefill's shape (B 1, S =
//   T = 32768, H 16, KV 2, Dh = Dv = 128, causal) 4.40e12 flops, 4.45 ms at
//   the 989 TFLOP/s bf16 tensor-core peak, against 302 MB of q, k, v and o
//   (0.09 ms at 3.35 TB/s); at deepseek-v2-lite's (H = KV = 16, Dh 192, Dv
//   128) 5.50e12 flops, 5.56 ms, against 0.6 GB.  Both products run on the tensor cores (`wgmma`), the only way
//   to that rate; the K / V tiles come by TMA, so no thread spends
//   instructions on loads, and P never leaves the registers.
//
//   Design.  One CTA of three warpgroups per (128-query tile, head,
//   batch), the grid 1-D with the longest causal tiles first.  Warpgroup 0
//   is the producer: it gives up registers (`setmaxnreg` 40) and one
//   thread issues the TMA loads, the Q tile once and then K and V tiles of
//   128 keys into a ring of kStages stages, each with a `full` mbarrier for
//   K, one for V and an `empty` one that the consumers' 256 threads arrive
//   on.  Warpgroups 1 and 2 are consumers of 64 query rows each (`setmaxnreg`
//   232).  Per key tile a consumer runs S = Q K^T as Dh/16 `wgmma`
//   m64n128k16 (Dh 192: 12) with both operands in shared memory (K-major),
//   the online
//   softmax on the f32 accumulator fragment (a row's 128 scores lie in the
//   4 lanes of a quad: max and sum by two xor shuffles; the row sum is kept
//   per thread and reduced once at the end), converts P to bf16 pairs in
//   place (the m64n128 accumulator fragment is the register A operand of
//   m64nDVk16, four registers per 16 keys), rescales O in registers and runs
//   O += P V as 8 register-A `wgmma` m64nDVk16 with V from shared memory as
//   an MN-major B operand (the descriptor's transpose bit).  Every tile is
//   stored by TMA with 128-byte swizzle in column blocks of 64 (Dh 128: two
//   blocks; Q and K at Dh 192 three, V at Dv 128 two), each block of a
//   128-row tile 16 KB, the layout the `wgmma` descriptors name (swizzle
//   mode 1,
//   8-row groups 1024 B apart; K-major steps advance 32 B inside the
//   swizzle atom, MN-major ones 2048 B).  TMA zero-fills rows past S or T,
//   so nothing is padded; keys past T are masked.  A -inf mask is applied
//   only on tiles that need one (the diagonal, the prefix boundary, the
//   ragged tail); a row that has seen no visible key keeps m = -inf and p =
//   0.  A CTA stops at the last key tile a row of its can see (with a
//   prefix, at least up to the prefix).  Shared memory: 32 KB of Q and
//   kStages x 64 KB of K and V at Dh 128, one CTA per SM; at 192 / 128, 48 KB
//   of Q and kStages x 80 KB of K and V, 208 KB of the 227 KB a block may
//   have (v padded to 192 would need 240 KB: hence a separate Dv).  The
//   per-thread S and O fragments are those of Dh 128.  Tensor maps are
//   built per call on the host (cuTensorMapEncodeTiled through the
//   runtime's driver entry point) over q, k and v with their own strides.
//
//   Left for later: the softmax of one tile overlapped with the next
//   Q K^T (FA3's ping-pong between the two consumers, or two S buffers in
//   one); persistent CTAs with a causal tile scheduler; several GQA query
//   heads per CTA sharing one K / V stream; the output through shared
//   memory and a TMA store; fp8.
//
// A second instantiation (kDump, chosen by a non-null p_dump) also stores
// the bf16 P each consumer feeds to P.V, so that a check can hold the
// plain version, fed the same P, to the output element by element: the
// two reach p in float32 by different summation orders and exp2s, so a p
// within a few float32 ulps of a bf16 rounding midpoint can round up on
// one and down on the other.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;            // query rows per CTA: two consumers x 64
constexpr int kBK = 128;            // keys per K / V tile
constexpr int kStages = 2;          // depth of the K / V ring
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kBlockCols = 64;      // bf16 columns of one 128-byte swizzle row
constexpr uint32_t kBlockBytes = kBK * 128;   // one 64-column block of a tile

template <int DH, int DV>
struct Smem {
  alignas(1024) __nv_bfloat16 q[kBQ * DH];
  alignas(1024) __nv_bfloat16 k[kStages][kBK * DH];
  alignas(1024) __nv_bfloat16 v[kStages][kBK * DV];
  alignas(8) uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];
};

// Positions (1..3) of the row, head and batch coordinates in a tensor
// map's dimensions (dimension 0 is Dh); the host orders them by stride.
struct MapOrder {
  int row, head, batch;
};

struct Params {
  void* o;
  __nv_bfloat16* p_dump;            // (B, H, S, T) or null: see kDump
  int B, S, T, H, KV;
  int causal, prefix_len;
  float scale_log2;                 // log2(e) / sqrt(Dh)
  MapOrder oq, ok, ov;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
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

__device__ __forceinline__ int map_coord(const MapOrder& m, int pos, int row,
                                         int head, int batch) {
  return m.row == pos ? row : (m.head == pos ? head : batch);
}

// One 64-column x `rows` box of a (Dh, rows, heads, batch) tensor map into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, const MapOrder& m,
                                         int col, int row, int head,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col),
         "r"(map_coord(m, 1, row, head, batch)),
         "r"(map_coord(m, 2, row, head, batch)),
         "r"(map_coord(m, 3, row, head, batch))
      : "memory");
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

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous `wgmma` that owns it.
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// S (64 x 128 f32) = A (64 x 16, smem, K-major) B (128 x 16, smem,
// K-major)^T, plus S when scale_d != 0.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x N f32) += P (64 x 16, registers) V (16 x N, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&o)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_m64n128(o, a, db);
}

__device__ __forceinline__ void wgmma_pv(float (&o)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_m64n64(o, a, db);
}

// One consumer warpgroup: 64 query rows of the CTA's tile, all its key
// tiles, and the rows' output.  With kDump it also stores the bf16 P it
// feeds to P.V at p_dump[b, h, row, key] (rows < S, keys < T), for
// checking; the arithmetic is the same.
template <int DH, int DV, bool kDump>
__device__ __forceinline__ void consume(Smem<DH, DV>& sm, const Params& p,
                                        int cw, int q0, int n_kt, int b,
                                        int h) {
  constexpr int kO = DV / 2;          // O floats per thread: DV / 8 chunks x 4
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = q0 + cw * 64;      // this consumer's first row
  const int row0 = r_lo + warp * 16 + lane / 4;   // rows row0 and row0 + 8
  const int col0 = 2 * (lane % 4);    // columns 8 j + col0 + {0, 1}
  const float c2 = p.scale_log2;
  // the consumer's 64 rows of each 64-column block: 64 rows x 128 bytes in
  const uint32_t q_addr = smem_u32(sm.q) + cw * 64 * 128;

  // Accumulator fragment: element 4 j + 2 i + e is (row0 + 8 i, 8 j + col0
  // + e); P's register pair 2 j + i packs elements 4 j + 2 i and + 1.
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};          // per thread; the quad's sum at the end

  mbar_wait(&sm.q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    const uint32_t ph = (kt / kStages) & 1;
    const int k0 = kt * kBK;

    float s[64];
    mbar_wait(&sm.k_full[st], ph);
    const uint32_t k_addr = smem_u32(sm.k[st]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBlockBytes + (kk % 4) * 32;
      wgmma_ss_m64n128(s, sw128_desc(q_addr + off, 16, 1024),
                       sw128_desc(k_addr + off, 16, 1024), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const bool need_mask =
        k0 + kBK > p.T ||
        (p.causal && k0 + kBK - 1 > r_lo &&
         !(r_lo + 63 < p.prefix_len && k0 + kBK <= p.prefix_len));
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
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
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
    float corr[2], mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      corr[i] = exp2f((m[i] - m_use) * c2);
      mc[i] = m_use * c2;
      m[i] = m_new;
    }

    uint32_t pk[32];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = exp2f(fmaf(s[4 * j + 2 * i], c2, -mc[i]));
        const float p1 = exp2f(fmaf(s[4 * j + 2 * i + 1], c2, -mc[i]));
        sum[i] += p0 + p1;
        pk[2 * j + i] = pack_bf16(p0, p1);
        if (kDump) {
          const int r = row0 + 8 * i, c = k0 + 8 * j + col0;
          if (r < p.S) {
            __nv_bfloat16* prow =
                p.p_dump + (((long long)b * p.H + h) * p.S + r) * p.T;
            if (c < p.T) prow[c] = __float2bfloat16_rn(p0);
            if (c + 1 < p.T) prow[c + 1] = __float2bfloat16_rn(p1);
          }
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }

    mbar_wait(&sm.v_full[st], ph);
    const uint32_t v_addr = smem_u32(sm.v[st]);
    fence_regs(pk);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                             pk[4 * kk + 3]};
      wgmma_pv(o, a, sw128_desc(v_addr + kk * 2048, kBlockBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&sm.empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= p.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = og + (((long long)b * p.S + r) * p.H + h) * DV + col0;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * i] / den, o[4 * j + 2 * i + 1] / den);
  }
}

template <int DH, int DV, bool kDump>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const Params p) {
  static_assert(kBQ == kBK, "Q and K / V tiles share kBlockBytes");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem<DH, DV>& sm = *reinterpret_cast<Smem<DH, DV>*>(smem_raw + pad);

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
  const int n_kt = (kend + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.empty[st], 256);   // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {            // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      constexpr uint32_t kTileBytes = kBK * DH * 2, kVTileBytes = kBK * DV * 2;
      mbar_expect_tx(&sm.q_full, kBQ * DH * 2);
#pragma unroll
      for (int c = 0; c < DH / kBlockCols; ++c)
        tma_load(sm.q + c * kBQ * kBlockCols, &tq, &sm.q_full, p.oq,
                 c * kBlockCols, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        mbar_wait(&sm.empty[st], ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.k_full[st], kTileBytes);
#pragma unroll
        for (int c = 0; c < DH / kBlockCols; ++c)
          tma_load(sm.k[st] + c * kBK * kBlockCols, &tk, &sm.k_full[st], p.ok,
                   c * kBlockCols, kt * kBK, kvh, b);
        mbar_expect_tx(&sm.v_full[st], kVTileBytes);
#pragma unroll
        for (int c = 0; c < DV / kBlockCols; ++c)
          tma_load(sm.v[st] + c * kBK * kBlockCols, &tv, &sm.v_full[st], p.ov,
                   c * kBlockCols, kt * kBK, kvh, b);
      }
    }
  } else {                            // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<DH, DV, kDump>(sm, p, threadIdx.x / 128 - 1, q0, n_kt, b, h);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 4-D map over a bf16 tensor with unit stride on Dh and element strides
// `st` = (row, head, batch): dimension 0 is Dh, the others are ordered by
// stride (an extent-1 dimension is never stepped and sorts last), and the
// box is 64 columns x 128 rows, 128-byte swizzled.  Returns a CUresult.
int make_map(CUtensorMap* map, MapOrder* order, const void* ptr, int dh,
             int rows, int heads, int batch, const long long* st) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const long long ext[3] = {rows, heads, batch};
  long long str[3] = {st[0], st[1], st[2]};
  long long big = 0;
  for (int i = 0; i < 3; ++i)
    if (ext[i] > 1 && str[i] > big) big = str[i];
  for (int i = 0; i < 3; ++i)
    if (ext[i] == 1) str[i] = big > 0 ? big + dh : dh;
  int idx[3] = {0, 1, 2};             // dimension i + 1 of the map is idx[i]
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && str[idx[j]] < str[idx[j - 1]]; --j) {
      const int t = idx[j];
      idx[j] = idx[j - 1];
      idx[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)dh, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {kBlockCols, 1, 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)ext[idx[i]];
    strides[i] = (cuuint64_t)(str[idx[i]] * 2);
    pos[idx[i]] = i + 1;
    if (idx[i] == 0) box[i + 1] = kBQ;
  }
  order->row = pos[0];
  order->head = pos[1];
  order->batch = pos[2];
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                     const_cast<void*>(ptr), dims, strides, box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DH, int DV, bool kDump>
int launch(const void* q, const void* k, const void* v,
           const long long* strides, Params& p, cudaStream_t stream) {
  const long long blocks = (long long)((p.S + kBQ - 1) / kBQ) * p.B * p.H;
  if (blocks == 0) return 0;
  if (p.T == 0) {                     // no key: o = 0 / max(0, 1e-30)
    cudaMemsetAsync(p.o, 0, (size_t)p.B * p.S * p.H * DV * 2, stream);
    return (int)cudaGetLastError();
  }
  CUtensorMap tq, tk, tv;
  const long long sq[3] = {strides[1], strides[2], strides[0]};
  const long long sk[3] = {strides[4], strides[5], strides[3]};
  const long long sv[3] = {strides[7], strides[8], strides[6]};
  int rc = make_map(&tq, &p.oq, q, DH, p.S, p.H, p.B, sq);
  if (rc == 0) rc = make_map(&tk, &p.ok, k, DH, p.T, p.KV, p.B, sk);
  if (rc == 0) rc = make_map(&tv, &p.ov, v, DV, p.T, p.KV, p.B, sv);
  if (rc != 0) return rc;
  const int smem = (int)sizeof(Smem<DH, DV>) + 1024;
  static_assert(sizeof(Smem<192, 128>) + 1024 <= 232448,
                "the 192 / 128 tiles must fit a block's shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DH, DV, kDump>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_wgmma_kernel<DH, DV, kDump>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, dh), k (B, T, KV, dh), v (B, T, KV, dv) bf16 on the device
// with unit stride on the head dim and the other strides (elements) in
// `strides`: q's batch, seq, head, then k's, then v's, each a multiple of
// 8, pointers 16-byte aligned.  o (B, S, H, dv) contiguous bf16.  (dh, dv)
// is (64, 64), (128, 128) or (192, 128).  scale_log2 = log2(e) / sqrt(dh)
// in float32.  p_dump: null, or a
// zeroed (B, H, S, T) contiguous bf16 buffer that receives the P fed to
// P.V (a separate instantiation; for checks only).  Returns a
// cudaError_t, or the driver's CUresult when a tensor map cannot be built.
int flash_attention_wgmma(const void* q, const void* k, const void* v,
                          void* o, const long long* strides, int B, int S,
                          int T, int H, int KV, int dh, int dv, int causal,
                          int prefix_len, float scale_log2, void* p_dump,
                          void* stream) {
  Params p;
  p.o = o;
  p.p_dump = static_cast<__nv_bfloat16*>(p_dump);
  p.B = B; p.S = S; p.T = T; p.H = H; p.KV = KV;
  p.causal = causal; p.prefix_len = prefix_len; p.scale_log2 = scale_log2;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool dump = p_dump != nullptr;
  if (dh == 64 && dv == 64)
    return dump ? launch<64, 64, true>(q, k, v, strides, p, st)
                : launch<64, 64, false>(q, k, v, strides, p, st);
  if (dh == 128 && dv == 128)
    return dump ? launch<128, 128, true>(q, k, v, strides, p, st)
                : launch<128, 128, false>(q, k, v, strides, p, st);
  if (dh == 192 && dv == 128)
    return dump ? launch<192, 128, true>(q, k, v, strides, p, st)
                : launch<192, 128, false>(q, k, v, strides, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
